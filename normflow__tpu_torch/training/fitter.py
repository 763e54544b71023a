"""Training loop: prior draw -> flow -> loss -> gradients -> guarded update.

Counterpart of ``Fitter`` (``normflow__tpu/training/fitter.py:37-542``).
One training step is a body that a CUDA graph can hold
(:meth:`Fitter.train_body`): it draws from the prior with the model's
generator, builds the loss (:meth:`Fitter.loss_of`, ``'rep'`` or
``'path'`` gradient estimator), takes the gradients through the kernels'
backward kernels with ``torch.autograd.grad``, runs the optimizer
(``training.optim``, which writes nothing in place) and commits on the
device: the NaN guard ``ok`` (a finite loss and every update finite, as
``fitter.py:285-290`` does in JAX) selects with ``torch.where`` between
the new and the old value of every parameter and every optimizer-state
tensor, written into the live tensors in place.  Nothing in the body reads
the device from the host.  The parameters and the optimizer state stay the
same tensors for the whole fit (a rewind, a restore and a snapshot load
copy into them), so on a CUDA model :meth:`Fitter.step` replays one
captured step (``utils.graphs``; the counterpart of the scanned
``multi_step``), captured once per batch size and dtype in each
``model.fit`` call, and a segment of ``steps_per_call`` replays reads its
losses from the device once.  On the CPU the same body runs eagerly.

``steps_per_call`` keeps its meaning as the length of a segment: the
spike guard (``rewind_on_spike``) compares segment medians, and segments
are cut at print and save epochs so that metrics and snapshots land on the
same epochs whatever the segment length.  A rewind restores the net and
optimizer state of the last healthy segment and reseeds the model's
generator deterministically: ``initial_seed() + 7919 + n``, ``n`` the
number of earlier rewinds; its learning-rate backoff is a device scalar
written between replays.  All of this runs on the host between segments.

A keyed action (one with ``with_key``, e.g. ``SchwingerAngleAction`` over
a ``StochasticStaggeredLogDet``) trains as the JAX step does
(``fitter.py:233-247``): the training body calls ``action.with_key`` with
the model's generator, which the captured step registers, so every step
and every replay draws fresh probes; evaluation and the samplers keep the
keyless (exact) ``model.action``.  The keyed action is built once per
``model.action``, and anew in each ``model.fit`` call.

Data parallelism (``normflow__tpu/training/fitter.py:229, 319, 400-470``):
with a process group attached to ``model.device_handler`` every rank
draws ``batch_size / nranks`` samples from its own generator, gathers the
per-sample ``logq`` and ``logp`` of every data rank
(``ModelDeviceHandler.gather_rows``, whose backward keeps this rank's
rows of the cotangent) and computes the loss of the global batch, as the
JAX step computes any loss on the sharded global batch
(``normflow__tpu/training/losses.py:1-8``).  After ``torch.autograd.grad``
each rank holds its samples' part of the global loss's gradient, and one
all-reduce sums the parts in one flat bucket (the psum XLA puts into the
JAX step), before the clip, the optimizer and the NaN guard.  Every loss
of ``training/losses.py`` takes this one route.  The module is not
wrapped in ``DistributedDataParallel``, whose reducer never sees gradients
taken with ``torch.autograd.grad``.  Every rank so takes the same update
and computes the same loss, and the host's decisions (a spike rewind, the
guard) come out the same on every rank; the gather and the all-reduce sit
inside the captured step.  Rank 0 alone prints, saves snapshots and keeps
the history, the metric batch gathered from every rank first.

A net with controlled couplings (``models.couplings.CntrCoupling`` with a
control generator; ``has_controls`` is read once per ``fit``) trains as the
JAX step does (``fitter.py:137-142, 231-240``): ``fit`` draws every control
before the optimizer state and the capture, at this rank's share of the
batch, and the training body draws fresh ones from the model's generator
before its prior draw, into the same buffers, so every replay of the
captured step trains on new controls.  The metrics' evaluation draws its
own at the print batch and puts the training controls back after it;
sampling uses the stored controls and never draws.

Under a space axis (``parallel/space.py``) the training body draws this
rank's slab and runs the loss with the slab current: ``logq`` and ``logp``
are the space ranks' partial sums turned into totals by one all-reduce
whose backward is the identity (every space rank computes the same loss
from the same totals, so its cotangent is the whole one), gathered over
the data axis after that, and the bucket sums the gradients over the
whole group (``ModelDeviceHandler.reduce_step``).  The step is captured
only where the group is NCCL (``ModelDeviceHandler.captures``); over gloo
it runs eagerly.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from ..models.couplings import _cntr_couplings, has_controls, \
    refresh_controls
from ..ops.stats import estimate_logz, fmt_val_err
from ..parallel import space
from ..utils.graphs import GraphCache, capture
from . import losses, optim
from .checkpoint import load_snapshot, save_snapshot, snapshot_path_for_epoch

__all__ = ["Fitter"]


class Fitter:
    """Trains a ``Model`` (callable, as ``model.fit(...)``)."""

    def __init__(self, model):
        self._model = model
        self.train_batch_size = 1
        self.train_history = dict(
            loss=[], logqp=[], logz=[], ess=[], rho=[], accept_rate=[])
        self.hyperparam = dict(lr=0.001, weight_decay=0.01)
        self.checkpoint_dict = dict(
            print_stride=100,
            print_batch_size=1024,
            print_extra_func=None,
            snapshot_path=None,
            epochs_run=0,
        )
        self.loss_fn = losses.calc_kl_mean
        self.grad_estimator = "rep"
        self.optimizer = None
        self.opt_state = None
        self.params = None
        self.rewind_on_spike = None
        self.max_rewinds = 10
        self.rewind_lr_backoff = None
        # the backoff's factor on the updates, read by the step on the device
        self._lr_scale_t = torch.ones((), dtype=torch.float64,
                                      device=model.device)
        self._graphs = GraphCache()
        self._keyed = None  # (model.action, its keyed training action)
        self._has_controls = False

    # ------------------------------------------------------------------ #
    def __call__(self, n_epochs=1000, save_every=None, batch_size=64,
                 optimizer_class="adamw", scheduler=None, loss_fn=None,
                 hyperparam=None, checkpoint_dict=None, param_groups=None,
                 steps_per_call=None, grad_estimator="rep",
                 clip_grad_norm=None, rewind_on_spike=None,
                 rewind_lr_backoff=None):
        """Fit the model; the arguments are those of the JAX ``Fitter``.

        ``optimizer_class``: ``'adamw' | 'adam' | 'sgd'`` or a factory
        ``(learning_rate=..., weight_decay=...) -> optim.Transform``.
        ``scheduler``: ``step -> factor`` on the base learning rate.
        ``param_groups``: ``[{'ind': [...], 'hyper': {...}}]``,
        hyperparameter overrides per top-level flow.  ``grad_estimator``:
        ``'rep'`` (reparametrization) or ``'path'`` (path gradient: ``log
        q`` re-evaluated through the inverse flow with stopped parameters,
        so the score term drops out).  ``clip_grad_norm``: clip the global
        gradient norm before the optimizer.  ``rewind_on_spike``: rewind to
        the last healthy segment when a segment's median loss exceeds the
        best median so far by this much (or is not finite), at most
        ``max_rewinds`` times; ``rewind_lr_backoff`` multiplies the
        effective learning rate by this factor at every rewind.
        """
        self.hyperparam.update(hyperparam or {})
        self.checkpoint_dict.update(checkpoint_dict or {})
        if loss_fn is not None:
            self.loss_fn = loss_fn
        if save_every is None:
            save_every = n_epochs
        if grad_estimator not in ("rep", "path"):
            raise ValueError(f"unknown grad_estimator {grad_estimator!r}")
        self.grad_estimator = grad_estimator
        self.rewind_on_spike = rewind_on_spike
        self.rewind_lr_backoff = rewind_lr_backoff
        self._lr_scale_t.fill_(1.0)
        if grad_estimator == "path" and self.loss_fn is not losses.calc_kl_mean:
            # dropping the score term is unbiased only for E_q[log q - log p]
            warnings.warn(
                "grad_estimator='path' is unbiased only for the reverse-KL "
                "loss family; got loss_fn="
                f"{getattr(self.loss_fn, '__name__', self.loss_fn)!r}. "
                "The gradient may be biased -- use grad_estimator='rep'.",
                stacklevel=2)
        self._keyed = None  # the training action, keyed anew in this call
        dh = self._model.device_handler

        # the controls exist, at this rank's batch, before the optimizer
        # state is built and the step captured
        self._has_controls = has_controls(self._model.net_)
        if self._has_controls:
            refresh_controls(self._model.net_, self._model.generator,
                             dh.batch_sharder()(batch_size))
        # the trainable mask is requires_grad
        self.params = [p for p in self._model.net_.parameters()
                       if p.requires_grad]
        self.optimizer = self._build_optimizer(optimizer_class, scheduler,
                                               param_groups)
        if clip_grad_norm is not None:
            self.optimizer = optim.chain(
                optim.clip_by_global_norm(clip_grad_norm), self.optimizer)
        self.opt_state = self.optimizer.init(self.params)
        self._graphs.clear()  # the new optimizer state needs a new capture

        snapshot_path = self.checkpoint_dict["snapshot_path"]
        say = print if dh.rank == 0 else _silent
        if snapshot_path is None:
            say("Not saving model snapshots")
        elif os.path.exists(snapshot_path):
            say(f"Trying to load snapshot from {snapshot_path}")
            self._load_snapshot(snapshot_path)
        else:
            say("Starting training from scratch")
        return self.train(n_epochs, batch_size, save_every,
                          steps_per_call=steps_per_call)

    # ------------------------------------------------------------------ #
    def _build_optimizer(self, optimizer_class, scheduler, param_groups):
        def make_tx(hyper):
            lr = hyper.get("lr", 0.001)
            if scheduler is not None:
                base = lr
                lr = lambda step: base * scheduler(step)  # noqa: E731
            wd = hyper.get("weight_decay", 0.0)
            if callable(optimizer_class):
                return optimizer_class(learning_rate=lr, weight_decay=wd)
            name = (optimizer_class or "adamw").lower()
            if name == "adamw":
                return optim.adamw(lr, weight_decay=wd)
            if name == "adam":
                return optim.adam(lr, weight_decay=wd)
            if name == "sgd":
                return optim.sgd(lr, weight_decay=wd)
            raise ValueError(f"unknown optimizer {optimizer_class!r}")

        if not param_groups:
            return make_tx(self.hyperparam)
        # per-group hyperparameters over the top-level flows of the net
        group_of = {}
        for g, spec in enumerate(param_groups):
            for i in spec["ind"]:
                group_of[i] = g + 1
        labels = []
        for i, flow in enumerate(self._model.net_.flows):
            labels += [f"g{group_of.get(i, 0)}" for p in flow.parameters()
                       if p.requires_grad]
        txs = {"g0": make_tx(self.hyperparam)}
        for g, spec in enumerate(param_groups):
            hyper = dict(self.hyperparam)
            hyper.update(spec.get("hyper", {}))
            txs[f"g{g + 1}"] = make_tx(hyper)
        return optim.multi_transform(txs, labels)

    # ------------------------------------------------------------------ #
    def loss_of(self, x, logr):
        """``(loss, logq, logp)`` of the prior draw ``x`` with
        ``logr = log r(x)``, differentiable in the net's parameters:
        ``logq`` and ``logp`` of the global batch (every data rank's,
        ``ModelDeviceHandler.gather_rows``) and their loss.  With
        ``grad_estimator='path'``, ``log q(y)`` is recomputed through the
        inverse flow with the parameters stopped: the gradient flows only
        along the sample path ``y = f(x)`` (through ``y`` into the inverse
        couplings' conditioners too)."""
        model = self._model
        net = model.net_
        dh = model.device_handler
        with dh.sharded():
            y, logj = net.forward(x)
            if self.grad_estimator == "path":
                live = [p for p in net.parameters() if p.requires_grad]
                try:
                    for p in live:
                        p.requires_grad_(False)
                    x_inv, mlogj = net.backward(y)
                finally:
                    for p in live:
                        p.requires_grad_(True)
                logq = model.prior.log_prob(x_inv) + mlogj
            else:
                logq = logr - logj
            logp = -self._training_action()(y)
            logq, logp = space.totals(dh.slab, logq, logp)
        logq, logp = dh.gather_rows(logq, logp)
        return self.loss_fn(logq, logp), logq, logp

    def _training_action(self):
        """``model.action``, keyed with the model's generator where it has
        ``with_key`` (a stochastic log-det's probes), built once per
        action."""
        action = self._model.action
        if not hasattr(action, "with_key"):
            return action
        if self._keyed is None or self._keyed[0] is not action:
            self._keyed = (action, action.with_key(self._model.generator))
        return self._keyed[1]

    def _step(self, x, logr):
        """One guarded update from the draw ``x``, committed on the device:
        the parameters and every optimizer-state tensor take their new
        values only where the loss and every update are finite, else keep
        their old ones, bit for bit.  Returns the loss and ``logq - logp``
        of the global batch (detached)."""
        loss, logq, logp = self.loss_of(x, logr)
        grads = torch.autograd.grad(loss, self.params)
        loss = loss.detach()
        dh = self._model.device_handler
        if dh.group is not None:  # the gradients of the group
            grads = dh.reduce_step(grads)
        updates, new_state = self.optimizer.update(list(grads),
                                                   self.opt_state,
                                                   self.params)
        scale = self._lr_scale_t.to(loss.dtype)
        updates = torch._foreach_mul(updates, scale)
        # NaN guard: a finite loss can come with non-finite gradients, so
        # every update must be finite too; else keep params AND state
        ok = torch.isfinite(torch.cat(
            [loss.reshape(1)] + [u.reshape(-1) for u in updates])).all()
        with torch.no_grad():
            new = list(torch._foreach_add(self.params, updates))
            for old, value in zip(
                    self.params + optim.state_leaves(self.opt_state),
                    new + optim.state_leaves(new_state)):
                torch.where(ok, value, old, out=old)
        return loss, (logq - logp).detach()

    def _draw(self, batch_size, generator):
        """A training step's draw from the prior, ``(x, log r(x))``."""
        return self._model.prior.sample_(batch_size, generator)

    def train_body(self):
        """One training step on a fresh draw from the prior (this rank's
        share of the batch), run eagerly: the body that :meth:`step`
        replays on a CUDA model."""
        model = self._model
        dh = model.device_handler
        local = dh.batch_sharder()(self.train_batch_size)
        if self._has_controls:
            refresh_controls(model.net_, model.generator, local)
        with dh.sharded():
            x, logr = self._draw(local, model.generator)
            return self._step(x, logr)

    def step_graph(self):
        """The captured training step of a CUDA model at the current batch
        size (``None`` on the CPU and under a space axis over gloo,
        ``ModelDeviceHandler.captures``): a ``utils.graphs.Captured`` whose
        outputs are the step's loss and ``logq - logp``.  Captured at first
        use in each ``model.fit`` call; the warm-up leaves the parameters,
        the optimizer state and the generator as it found them."""
        model = self._model
        if not model.device_handler.captures():
            return None
        stamp = (*model.graph_stamp(), model.generator, self.optimizer,
                 self.loss_fn, self.grad_estimator,
                 *(p.data_ptr() for p in self.params))
        return self._graphs.get(
            (self.train_batch_size, model.prior.dtype), stamp,
            lambda: capture(self.train_body, generators=(model.generator,),
                            keep=self.params
                            + optim.state_leaves(self.opt_state)))

    def step(self):
        """One training step on a fresh draw from the prior: a replay of
        the captured step on a CUDA model, the body run eagerly on the
        CPU.  Returns the loss and ``logq - logp`` as new tensors."""
        captured = self.step_graph()
        if captured is None:
            return self.train_body()
        captured.graph.replay()
        return tuple(t.clone() for t in captured.outputs)

    # ------------------------------------------------------------------ #
    def train(self, n_epochs, batch_size=None, save_every=None,
              steps_per_call=None):
        """Run the epoch loop in segments of ``steps_per_call`` steps."""
        if batch_size is not None:
            self.train_batch_size = batch_size
        if save_every is None:
            save_every = n_epochs
        model = self._model
        rank = model.device_handler.rank
        say = print if rank == 0 else _silent
        model.device_handler.batch_sharder()(self.train_batch_size)  # raises
        print_stride = self.checkpoint_dict["print_stride"]
        evals_on = print_stride is not None
        stride = max(int(print_stride), 1) if evals_on else n_epochs + 1
        spc = steps_per_call or 1

        def next_stop(epoch):
            stops = [n_epochs, epoch + spc]
            if evals_on:
                for mark in (1, 10):
                    if epoch < mark:
                        stops.append(mark)
                stops.append((epoch // stride + 1) * stride)
            if save_every > 0:
                stops.append((epoch // save_every + 1) * save_every)
            return min(s for s in stops if s > epoch)

        guard = self.rewind_on_spike
        if guard is not None:
            last_good = self._state_copy()
            best_seg = np.inf
            rewinds = self.train_history.setdefault("rewinds", [])

        t1 = time.time()
        epoch = 0
        while epoch < n_epochs:
            seg = next_stop(epoch) - epoch
            losses_np = self._segment(seg)
            epoch += seg
            if guard is not None:
                seg_med = (float(np.median(losses_np))
                           if np.isfinite(losses_np).all() else np.inf)
                if seg_med > best_seg + guard:
                    if len(rewinds) < self.max_rewinds:
                        self._restore(last_good)
                        gen = model.generator
                        gen.manual_seed(gen.initial_seed() + 7919
                                        + len(rewinds))
                        rewinds.append(epoch)
                        if self.rewind_lr_backoff is not None:
                            self._lr_scale_t.mul_(
                                float(self.rewind_lr_backoff))
                        back = (f", lr scale -> {float(self._lr_scale_t):g}"
                                if self.rewind_lr_backoff else "")
                        say(f"Epoch {epoch} | loss spike {seg_med:g} > "
                            f"best {best_seg:g} + {guard:g}: rewound to "
                            f"last healthy snapshot ({len(rewinds)}/"
                            f"{self.max_rewinds}){back}")
                        continue
                else:
                    best_seg = min(best_seg, seg_med)
                    last_good = self._state_copy()
            if rank == 0:
                self.train_history["loss"].extend(losses_np.tolist())
            self.checkpoint(epoch, losses_np[-1], save_every)
        t2 = time.time()
        if n_epochs > 0:
            say(f"({model.device.type}) Time = {t2 - t1:.3g} sec.")
        return self.train_history

    def _segment(self, n_steps):
        """``n_steps`` guarded steps (replays of the captured step on a CUDA
        model); their losses as a numpy array, read from the device once
        for the segment."""
        return torch.stack([self.step()[0]
                            for _ in range(n_steps)]).cpu().numpy()

    def _state_copy(self):
        return ([p.detach().clone() for p in self.params],
                _clone(self.opt_state))

    def _restore(self, state):
        """Copy a ``_state_copy`` into the live parameters and optimizer
        state, in place."""
        params, opt_state = state
        with torch.no_grad():
            for p, q in zip(self.params, params):
                p.copy_(q)
        optim.assign_(self.opt_state, opt_state)

    # ------------------------------------------------------------------ #
    def checkpoint(self, epoch, loss, save_every):
        """Snapshot every ``save_every`` epochs; metrics at epochs 1, 10 and
        every ``print_stride``, of a batch of ``print_batch_size`` shared
        among the ranks and gathered; rank 0 alone saves and prints."""
        model = self._model
        dh = model.device_handler
        cd = self.checkpoint_dict
        if (dh.rank == 0 and cd["snapshot_path"] is not None and save_every
                and epoch % save_every == 0):
            self._save_snapshot(epoch)
        if not cd["print_stride"]:  # None or 0: evals disabled
            return
        if epoch == 1 or epoch == 10 or epoch % cd["print_stride"] == 0:
            local = dh.batch_sharder()(cd["print_batch_size"])
            # controls of the print batch, the training ones put back after
            saved = [(c, c.control) for c in _cntr_couplings(model.net_)] \
                if self._has_controls else []
            try:
                with torch.no_grad(), dh.sharded():
                    if saved:
                        refresh_controls(model.net_, model.generator, local)
                    x, logr = model.prior.sample_(local, model.generator)
                    y, logj = model.net_.forward(x)
                    logq, logp = dh.gather_rows(*space.totals(
                        dh.slab, logr - logj, -model.action(y)))
            finally:
                for c, control in saved:
                    c.control = control
            if dh.rank == 0:
                self._append_to_train_history(logq, logp)
                self.print_fit_status(epoch,
                                      loss=float(self.loss_fn(logq, logp)))

    def _append_to_train_history(self, logq, logp):
        from ..mcmc.metropolis import estimate_accept_rate

        logqp = logq - logp
        logqp_np = logqp.cpu().numpy()
        h = self.train_history
        h["logqp"].append((float(np.mean(logqp_np)),
                           float(np.std(logqp_np))))
        h["logz"].append(estimate_logz(logqp_np, method="jackknife"))
        h["ess"].append(float(losses.calc_ess(logqp, 0.0)))
        h["rho"].append(float(losses.calc_corrcoef(logq, logp)))
        h["accept_rate"].append(estimate_accept_rate(logqp_np))

    def print_fit_status(self, epoch, loss=None):
        h = self.train_history
        if loss is None:
            loss = h["loss"][-1]
        logqp_mean, logqp_std = h["logqp"][-1]
        logz_mean, logz_std = h["logz"][-1]
        ar_mean, ar_std = h["accept_rate"][-1]
        ess, rho = h["ess"][-1], h["rho"][-1]
        if epoch == 1:
            print(f"\n>>> Training progress ({self._model.device.type}) "
                  "<<<\n")
            print("Note: log(q/p) is estimated with normalized p; "
                  "mean & error are obtained from samples in a batch\n")
        epoch += self.checkpoint_dict["epochs_run"]
        str_ = f"Epoch: {epoch} | loss: {loss:g} | ess: {ess:g} | rho: {rho:g}"
        str_ += " | log(z): {0} | log(q/p): {1} | accept_rate: {2}".format(
            fmt_val_err(logz_mean, logz_std, err_digits=2),
            fmt_val_err(logqp_mean + logz_mean, logqp_std, err_digits=2),
            fmt_val_err(ar_mean, ar_std, err_digits=1),
        )
        if self.checkpoint_dict["print_extra_func"] is not None:
            str_ += self.checkpoint_dict["print_extra_func"](epoch)
        print(str_)

    # ------------------------------------------------------------------ #
    def _save_snapshot(self, epoch):
        cd = self.checkpoint_dict
        epochs_run = epoch + cd["epochs_run"]
        path = snapshot_path_for_epoch(cd["snapshot_path"], epochs_run)
        model = self._model
        save_snapshot(path, net=model.net_, opt_state=self.opt_state,
                      epoch=epochs_run, generator=model.generator)
        print(f"Epoch {epochs_run} | Model Snapshot saved at {path}")

    def _load_snapshot(self, path):
        model = self._model
        opt_state, epoch = load_snapshot(path, net=model.net_,
                                         generator=model.generator,
                                         device=model.device)
        if opt_state is not None:  # into the live tensors, in place
            optim.assign_(self.opt_state, opt_state)
        self.checkpoint_dict["epochs_run"] = epoch
        print(f"Snapshot found: {path}\nResuming training via Saved Snapshot "
              f"at Epoch {epoch}")

    # loss zoo as static methods, as in the JAX Fitter ----------------- #
    calc_kl_mean = staticmethod(losses.calc_kl_mean)
    calc_kl_var = staticmethod(losses.calc_kl_var)
    calc_corrcoef = staticmethod(losses.calc_corrcoef)
    calc_direct_kl_mean = staticmethod(losses.calc_direct_kl_mean)
    calc_kl_mean_includelogz = staticmethod(losses.calc_kl_mean_includelogz)
    calc_least_squares = staticmethod(losses.calc_least_squares)
    calc_minus_logz = staticmethod(losses.calc_minus_logz)
    calc_ess = staticmethod(losses.calc_ess)
    calc_minus_ess = staticmethod(losses.calc_minus_ess)


def _silent(*args, **kwargs):
    """``print`` on ranks other than 0."""


def _clone(state):
    """Deep copy of an optimizer state (tensors cloned)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_clone(v) for v in state)
    return state
