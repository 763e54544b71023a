"""Seeded float32 chains for the ``accept_scan`` tests on the CPU and the
card (this module imports no JAX)."""

import numpy as np

# the chains besides the random one, each named for what it exercises
SPECIAL = ("all_accept", "all_reject", "inf_ref", "nan", "ties", "stuck",
           "rising")


def chain(case, n, seed=20261018):
    """``(lrand, logqp, ref)``, float32, of the named chain."""
    rng = np.random.default_rng(seed + n)
    logqp = (rng.standard_normal(n) * 1.5).astype(np.float32)
    lrand = np.log(rng.random(n)).astype(np.float32)
    ref = np.float32(0.3)
    if case == "random":  # the smoke's: log u = -inf every 11th
        lrand[::11] = -np.inf
    elif case == "all_accept":
        lrand[:] = -np.inf
    elif case == "all_reject":
        ref = np.float32(-np.inf)
    elif case == "inf_ref":
        ref = np.float32(np.inf)
    elif case == "nan":
        logqp[rng.random(n) < 0.05] = np.nan
        lrand[rng.random(n) < 0.02] = np.nan
        logqp[min(7, n - 1)] = np.nan
    elif case == "ties":  # dyadic values: ref - logqp == lrand exactly
        logqp = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], n).astype(np.float32)
        lrand = rng.choice([-1.5, -1.0, -0.5, 0.0], n).astype(np.float32)
        ref = np.float32(0.0)
    elif case == "stuck":  # one very heavy state early: nothing after it
        logqp[min(5, n - 1)] = -1e4
    elif case == "rising":  # ref - logqp <= -40 from every state: each one
        # tests every candidate to the end and accepts none
        logqp = np.arange(n, dtype=np.float32) * 40
        ref = np.float32(-40.0)
    else:
        raise ValueError(case)
    return lrand, logqp, ref
