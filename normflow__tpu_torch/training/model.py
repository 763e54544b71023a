"""The central ``Model`` class: prior + invertible net + action.

Counterpart of ``normflow__tpu/training/model.py:22-183``: ``Model`` owns
the net, the prior, the action and a ``torch.Generator`` on the model's
device (the JAX package's stateful key), and wires up the ``posterior``,
``mcmc`` and ``fit`` services.  Sampling runs without autograd; training
(``fit``, a ``training.fitter.Fitter``) draws from the same generator.
"""

from __future__ import annotations

import torch

from .fitter import Fitter

__all__ = ["Model", "Posterior", "backward_sanitychecker"]


class Model:
    """``Model(prior=..., net_=..., action=..., seed=0)``; the device is the
    prior's."""

    def __init__(self, *, prior, net_, action, name: str | None = None,
                 seed: int = 0):
        from ..mcmc.metropolis import MCMCSampler

        self.name = name
        self.net_ = net_
        self.prior = prior
        self.action = action
        self.device = prior.loc.device
        self.generator = torch.Generator(device=self.device)
        self.seed(seed)
        self.posterior = Posterior(self)
        self.mcmc = MCMCSampler(self)
        self.fit = Fitter(self)

    def seed(self, seed: int):
        self.generator.manual_seed(seed)


class Posterior:
    """Uncorrected samples from the flow."""

    def __init__(self, model: Model):
        self._model = model

    @torch.no_grad()
    def sample_(self, batch_size: int = 1, generator=None):
        """``(y, logq)``."""
        m = self._model
        gen = m.generator if generator is None else generator
        x, logr = m.prior.sample_(batch_size, gen)
        y, logj = m.net_.forward(x)
        return y, logr - logj

    @torch.no_grad()
    def sample__(self, batch_size: int = 1, generator=None):
        """``(y, logq, logp)``; ``logp`` is ``log(p z) = -S(y)``."""
        y, logq = self.sample_(batch_size, generator)
        return y, logq, -self._model.action(y)

    @torch.no_grad()
    def log_prob(self, y):
        """``log q(y)`` through the inverse flow."""
        m = self._model
        x, minus_logj = m.net_.backward(y)
        return m.prior.log_prob(x) + minus_logj

    @torch.no_grad()
    def logqp_stream(self, n_batches: int, batch_size: int, generator=None):
        """``logq - logp`` of ``n_batches`` fresh batches, flattened to
        ``(n_batches * batch_size,)``, for ESS and acceptance estimates."""
        m = self._model
        gen = m.generator if generator is None else generator
        out = torch.empty((n_batches, batch_size), dtype=m.prior.loc.dtype,
                          device=m.device)
        for i in range(n_batches):
            x, logr = m.prior.sample_(batch_size, gen)
            y, logj = m.net_.forward(x)
            out[i] = (logr - logj) + m.action(y)
        return out.reshape(-1)


@torch.no_grad()
def backward_sanitychecker(model: Model, n_samples: int = 5, net_=None,
                           return_details: bool = False,
                           verbose: bool = True):
    """Round trip: ``net.backward(net(x), log0=logJ)`` must give back ``x``
    and a zero ``log0``.  Returns the sums ``(x_err, logj_err)``."""
    net_ = model.net_ if net_ is None else net_
    x = model.prior.sample(n_samples, model.generator)
    y, logj = net_.forward(x)
    x_hat, log0_hat = net_.backward(y, log0=logj)

    x_err = float(torch.sum(torch.abs(x - x_hat)))
    logj_err = float(torch.sum(torch.abs(log0_hat)))
    if verbose:
        print("Sanity check is OK if following numbers are zero up to "
              "round off:")
        print(f"{x_err:g} {logj_err:g}")
    if return_details:
        return (x, y, x_hat), (logj, log0_hat)
    return x_err, logj_err
