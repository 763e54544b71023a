"""The central ``Model`` class: prior + invertible net + action.

Counterpart of ``normflow__tpu/training/model.py:22-183``: ``Model`` owns
the net, the prior, the action and a ``torch.Generator`` on the model's
device (the JAX package's stateful key), and wires up the ``posterior``
(alias ``raw_dist``), ``mcmc``, ``blocked_mcmc`` and ``fit`` services.
Sampling runs without autograd; training
(``fit``, a ``training.fitter.Fitter``) draws from the same generator.
On a CUDA model ``Posterior.logqp_stream`` replays one captured batch
(``utils.graphs``), the counterpart of the JAX package's scanned
``_logqp_scan``.

``model.device_handler`` (``parallel.mesh.ModelDeviceHandler``) shards the
model over a process group once one is attached: the posterior's entry
points then draw this rank's share of the global batch from this rank's
generator and return it (``logqp_stream`` captures one batch of that
share per rank).  Under a space axis (``parallel/space.py``) each rank
draws its slab of that share and runs the flow on it with its slab
current; ``logq`` and ``logp`` are the totals over the space ranks and
``y`` the whole lattices, the same on every space rank of a data rank;
``log_prob`` takes whole lattices.
"""

from __future__ import annotations

import torch

from ..models.nets import ConvNet
from ..parallel import space
from ..parallel.mesh import ModelDeviceHandler, fold_seed
from ..utils.graphs import GraphCache, capture
from .fitter import Fitter

__all__ = ["Model", "Posterior", "backward_sanitychecker"]


class Model:
    """``Model(prior=..., net_=..., action=..., seed=0)``; the device is the
    prior's."""

    def __init__(self, *, prior, net_, action, name: str | None = None,
                 seed: int = 0):
        from ..mcmc.metropolis import BlockedMCMCSampler, MCMCSampler

        self.name = name
        self.net_ = net_
        self.prior = prior
        self.action = action
        self.device = prior.device
        self.generator = torch.Generator(device=self.device)
        self.device_handler = ModelDeviceHandler(self)
        self.seed(seed)
        self.posterior = Posterior(self)
        self.raw_dist = self.posterior  # alias, as in the JAX package
        self.mcmc = MCMCSampler(self)
        self.blocked_mcmc = BlockedMCMCSampler(self)
        self.fit = Fitter(self)

    def seed(self, seed: int):
        """Seed the generator: with ``seed`` itself on stream rank 0 or with
        no group attached, else with ``parallel.mesh.fold_seed`` of the
        rank's ``device_handler.stream_rank`` (replicas draw alike)."""
        self.base_seed = seed
        dh = self.device_handler
        self.generator.manual_seed(
            fold_seed(seed, dh.stream_rank) if dh.group is not None
            else seed)
        dh.seed_uniforms(seed)

    def transform(self, x):
        """The flow's output for ``x`` (no log-Jacobian)."""
        return self.net_(x)[0]

    def graph_stamp(self) -> tuple:
        """What a captured graph of this model holds to without seeing it
        at replay (``utils.graphs.GraphCache``): the net, the prior, the
        action, the addresses of the weights and of the net's and the
        prior's buffers (a ``CntrCoupling``'s control among them), and
        each ``ConvNet``'s compute dtype and ``fuse_out_cast``, which a
        caller may set on the same module."""
        return (self.net_, self.prior, self.action,
                *(t.data_ptr() for t in (*self.net_.parameters(),
                                         *self.net_.buffers(),
                                         *self.prior.buffers())),
                *((m.compute_dtype, m.fuse_out_cast)
                  for m in self.net_.modules() if isinstance(m, ConvNet)))


class Posterior:
    """Uncorrected samples from the flow."""

    def __init__(self, model: Model):
        self._model = model
        self._graphs = GraphCache()

    def sample(self, batch_size: int = 1, generator=None, **kwargs):
        """``y``."""
        return self.sample_(batch_size, generator, **kwargs)[0]

    @torch.no_grad()
    def sample_(self, batch_size: int = 1, generator=None,
                preprocess_func=None):
        """``(y, logq)``; ``preprocess_func(x, logr) -> (x, logr)`` acts on
        the prior's draw before the flow."""
        return self._sample(batch_size, generator, preprocess_func, False)

    @torch.no_grad()
    def sample__(self, batch_size: int = 1, generator=None,
                 preprocess_func=None):
        """``(y, logq, logp)``; ``logp`` is ``log(p z) = -S(y)``."""
        return self._sample(batch_size, generator, preprocess_func, True)

    def _sample(self, batch_size, generator, preprocess_func, with_logp):
        """This rank's share (and slab) drawn and pushed through the flow:
        ``(y, logq)``, and ``logp`` where asked, the totals over the space
        axis and ``y`` the whole lattices (module docstring)."""
        m = self._model
        dh = m.device_handler
        gen = m.generator if generator is None else generator
        with dh.sharded():
            x, logr = m.prior.sample_(dh.batch_sharder()(batch_size), gen)
            if preprocess_func is not None:
                x, logr = preprocess_func(x, logr)
            y, logj = m.net_.forward(x)
            out = [logr - logj] + ([-m.action(y)] if with_logp else [])
            out = space.totals(dh.slab, *out)
        return (dh.whole_rows(y), *out)

    @torch.no_grad()
    def log_prob(self, y):
        """``log q(y)`` through the inverse flow (``y`` whole lattices)."""
        m = self._model
        dh = m.device_handler
        with dh.sharded():
            x, minus_logj = m.net_.backward(dh.local_rows(y))
            (logq,) = space.totals(dh.slab, m.prior.log_prob(x) + minus_logj)
        return logq

    @torch.no_grad()
    def logqp_stream(self, n_batches: int, batch_size: int, generator=None):
        """``logq - logp`` of ``n_batches`` fresh batches, flattened to
        ``(n_batches * batch_size,)``, for ESS and acceptance estimates.

        On a CUDA model each batch is a replay of one captured batch
        (:meth:`batch_graph`); on the CPU, and under a space axis over gloo
        (``ModelDeviceHandler.captures``), the same body runs eagerly.  The
        draws are those of the eager body from the same generator state.
        With a process group attached each batch is this rank's share of
        ``batch_size``."""
        m = self._model
        gen = m.generator if generator is None else generator
        batch_size = m.device_handler.batch_sharder()(batch_size)
        out = torch.empty((n_batches, batch_size), dtype=m.prior.dtype,
                          device=m.device)
        if not m.device_handler.captures():
            for row in out:
                row.copy_(self.logqp_batch(batch_size, gen))
            return out.reshape(-1)
        graph, (logqp,) = self.batch_graph(batch_size, gen)
        for row in out:
            graph.replay()
            row.copy_(logqp)
        return out.reshape(-1)

    @torch.no_grad()
    def logqp_batch(self, batch_size: int, generator):
        """The body of one batch of :meth:`logqp_stream`: a prior draw,
        the flow, ``logr - logj + S(y)`` (its total over the space axis)."""
        m = self._model
        dh = m.device_handler
        with dh.sharded():
            x, logr = m.prior.sample_(batch_size, generator)
            y, logj = m.net_.forward(x)
            (logqp,) = space.totals(dh.slab, (logr - logj) + m.action(y))
        return logqp

    @torch.no_grad()
    def batch_graph(self, batch_size: int, generator=None):
        """The captured batch of :meth:`logqp_stream` on a CUDA model, a
        ``utils.graphs.Captured`` whose one output is the batch's
        ``(batch_size,)`` stream.  Captured at first use for each batch
        size, dtype and generator; a swapped net, prior or action, or
        weights given new storage, capture anew."""
        m = self._model
        gen = m.generator if generator is None else generator
        return self._graphs.get(
            (batch_size, m.prior.dtype, gen), m.graph_stamp(),
            lambda: capture(lambda: (self.logqp_batch(batch_size, gen),),
                            generators=(gen,)))


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
