"""The algorithm of ``accept_scan``'s CUDA kernel, modelled in numpy.

The kernel (``normflow__tpu_torch/csrc/accept_scan.cu``) runs only on the
card, so its plan is held here on the CPU: a numpy model of what it does
(chunks of ``kChunk`` proposals; each state's next acceptance, first by
its own lane over ``kLaneTries`` candidates, then by its warp 32
candidates a step; pointer doubling with marking interleaved until the
path's head leaves the chunk; a max-scan of the marks by warps; the last
accepted state carried into the next chunk), with the constants read from
the source.  The model must give the bits of the sequential chain, the
port's ``accept_scan_plain`` and JAX's ``_accept_scan_core`` (float32, the
same numpy inputs from a seed) at lengths on both sides of one and two
chunks and at 10,000, and on chains that accept everything, reject
everything, start from a ``+inf`` reference, hold NaNs, tie exactly,
stick on one heavy state, or rise so steeply that every state searches to
the chunk's end.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflow__tpu.mcmc import metropolis as jmcmc
from normflow__tpu_torch.ops.kernels.accept_scan import (accept_scan,
                                                         accept_scan_plain)
from _accept_scan_chains import SPECIAL, chain

SOURCE = (Path(__file__).resolve().parents[1] / "normflow__tpu_torch" /
          "csrc" / "accept_scan.cu")


def _constants():
    """The kernel's ``constexpr int`` constants, by name."""
    text = SOURCE.read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    if re.search(r"constexpr int kChunk = kThreads;", text):
        consts["kChunk"] = consts["kThreads"]
    return consts


CONSTS = _constants()
CHUNK, TRIES = CONSTS["kChunk"], CONSTS["kLaneTries"]


def _next(lr, lq, L, s, tries):
    """State ``s``'s next acceptance in a chunk of ``m`` proposals, as the
    kernel finds it: alone over ``tries`` candidates, then 32 at a time;
    ``m + 1`` if none.  The comparison is the chain's, in float32."""
    m = len(lr)
    i = s
    for _ in range(tries):
        if i >= m:
            return m + 1
        if lr[i] < L[s] - lq[i]:
            return i + 1
        i += 1
    for c in range(i, m, 32):
        hits = lr[c:c + 32] < L[s] - lq[c:c + 32]
        if hits.any():
            return c + int(np.argmax(hits)) + 1
    return m + 1


def model_scan(lrand, logqp, ref, chunk=CHUNK, tries=TRIES):
    """``(accept, indices, rounds)`` as the kernel computes them;
    ``rounds`` lists the doubling rounds each chunk took."""
    lrand = np.asarray(lrand, np.float32)
    logqp = np.asarray(logqp, np.float32)
    ref, index = np.float32(ref), 0
    n = len(logqp)
    accept = np.zeros(n, bool)
    indices = np.zeros(n, np.int64)
    rounds = []
    with np.errstate(invalid="ignore"):
        for start in range(0, n, chunk):
            lr, lq = lrand[start:start + chunk], logqp[start:start + chunk]
            m = len(lq)
            exit_ = m + 1
            L = np.concatenate([[ref], lq]).astype(np.float32)
            jump = np.full(m + 2, exit_, np.int64)
            jump[:m] = [_next(lr, lq, L, s, tries) for s in range(m)]
            mark = np.zeros(m + 2, bool)
            mark[0] = True
            k = 0
            while jump[0] != exit_:
                marked = np.flatnonzero(mark[:m])
                mark[jump[marked]] = True
                jump[:m] = jump[jump[:m]]
                k += 1
            rounds.append(k)
            acc = mark[1:m + 1]
            # the max-scan: the last marked lane at or below each lane, else
            # the last marked state of the warps before
            state = np.where(acc, np.arange(1, m + 1), 0)
            pad = np.zeros(-m % 32, np.int64)
            warps = np.concatenate([state, pad]).reshape(-1, 32)
            w_last = warps.max(axis=1)
            before = np.concatenate([[0], np.maximum.accumulate(w_last)[:-1]])
            last = np.maximum(np.maximum.accumulate(warps, axis=1),
                              before[:, None]).reshape(-1)[:m]
            accept[start:start + m] = acc
            indices[start:start + m] = np.where(last > 0, start + last, index)
            if w_last.max():
                end = int(w_last.max())
                ref, index = lq[end - 1], start + end
    return accept, indices, rounds


def _serial(lrand, logqp, ref):
    """The sequential chain in numpy float32."""
    accept = np.zeros(len(logqp), bool)
    indices = np.zeros(len(logqp), np.int64)
    ref, index = np.float32(ref), 0
    with np.errstate(invalid="ignore"):
        for i, (lr, lq) in enumerate(zip(lrand, logqp)):
            if lr < ref - lq:
                ref, index = lq, i + 1
                accept[i] = True
            indices[i] = index
    return accept, indices


CASES = ([("random", n) for n in (1, 2, 1000, CHUNK - 1, CHUNK, CHUNK + 1,
                                   2 * CHUNK - 1, 2 * CHUNK + 1, 10000)]
         + [(c, n) for c in SPECIAL for n in (CHUNK, 10000)])
IDS = [f"{c}-{n}" for c, n in CASES]


@pytest.mark.parametrize("case,n", CASES, ids=IDS)
def test_model_matches_the_plain_chain(case, n):
    lrand, logqp, ref = chain(case, n)
    got = model_scan(lrand, logqp, ref)
    want = accept_scan_plain(torch.from_numpy(lrand), torch.from_numpy(logqp),
                             torch.tensor(ref))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    serial = _serial(lrand, logqp, ref)
    np.testing.assert_array_equal(got[0], serial[0])
    np.testing.assert_array_equal(got[1], serial[1])
    # the doubling stops within ceil(log2(len + 1)) rounds of each chunk
    lens = [min(CHUNK, n - s) for s in range(0, n, CHUNK)]
    assert all(k <= math.ceil(math.log2(m + 1))
               for k, m in zip(got[2], lens))


@pytest.mark.parametrize("case,n", CASES, ids=IDS)
def test_model_matches_jax(case, n):
    lrand, logqp, ref = chain(case, n)
    got = model_scan(lrand, logqp, ref)
    want = jmcmc._accept_scan_core(jnp.asarray(lrand), jnp.asarray(logqp),
                                   jnp.asarray(ref))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("case,check", [
    ("all_accept", lambda a, i, n: a.all() and (i == np.arange(1, n + 1))
     .all()),
    ("all_reject", lambda a, i, n: not a.any() and not i.any()),
    ("inf_ref", lambda a, i, n: a[0]),
    ("stuck", lambda a, i, n: not a[6:].any() and a[5]),
    ("rising", lambda a, i, n: not a.any() and not i.any()),
    ("ties", lambda a, i, n: True),
])
def test_special_chains_do_what_they_say(case, check):
    """Each special chain exercises what it is named for; the ties chain
    holds exact ties that the strict comparison rejects."""
    n = 2 * CHUNK + 1
    lrand, logqp, ref = chain(case, n)
    acc, idx, _ = model_scan(lrand, logqp, ref)
    assert check(acc, idx, n)
    if case == "ties":
        # one of the exact ties on the path: the chain's state rejected it
        refs = np.concatenate([[ref], logqp])[idx]
        before = np.concatenate([[ref], refs[:-1]])
        assert ((before - logqp == lrand) & ~acc).any()


def test_rounds_follow_the_path_length():
    """The doubling takes floor(log2(m)) + 1 rounds for a path of m
    accepted states in a chunk, none when nothing is accepted."""
    for m in (0, 1, 2, 3, 700, CHUNK):
        lrand = np.full(CHUNK, np.inf, np.float32)
        lrand[:m] = -np.inf
        _, _, rounds = model_scan(lrand, np.zeros(CHUNK, np.float32), 0.0)
        assert rounds == [0 if m == 0 else int(math.log2(m)) + 1]


def test_constants_match_the_kernel():
    """The model reads the kernel's constants: one state a thread in a
    chunk of a block's threads."""
    assert CONSTS["kThreads"] == CHUNK == 1024
    assert 1 <= TRIES <= 32


@pytest.mark.parametrize("n", [1, 2, 49, CHUNK, 10000])
def test_cpu_tensors_take_the_plain_chain(n):
    """On the CPU the wrapper runs the plain version, whatever the length."""
    lrand, logqp, ref = (torch.from_numpy(np.asarray(a))
                         for a in chain("random", n))
    got = accept_scan(lrand, logqp, ref)
    want = accept_scan_plain(lrand, logqp, ref)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
