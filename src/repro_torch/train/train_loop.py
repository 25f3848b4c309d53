"""Training loop of the port (of :mod:`repro.train.train_loop`): the
microbatched train step and the production loop around it
(checkpoints, preemption, straggler watchdog, deterministic data).

The step is eager: one ``torch.autograd.grad`` over the parameter leaves a
microbatch, float32 gradient accumulators, then :func:`adamw_update` in
place on the parameters and the optimizer state (the reference's donated
buffers).  The reference traces its step once under ``jit`` (and its
microbatch scan body once), so every step and every microbatch draws its
DAC noise under the same salts; the step here restores the runtime's salt
to its value at :func:`make_train_step` before each loss evaluation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..distributed import (PREEMPTED, CheckpointManager, Watchdog,
                           install_preemption_handler)
from ..models.common import Runtime
from ..models.params import tree_map, tree_paths
from .optimizer import OptState, adamw_init, adamw_update

__all__ = ["make_train_step", "Trainer", "loss_and_grads",
           "check_grad_shardings"]


def _from_leaves(tree, leaves: List[torch.Tensor]):
    """``tree`` with its leaves (in sorted walk order) replaced."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def loss_and_grads(mod, params, batch, cfg: ModelConfig,
                   rt: Optional[Runtime]) -> Tuple[torch.Tensor, list]:
    """``(loss, gradients)`` of ``mod.loss`` over every leaf of ``params``,
    the gradients in the tree's sorted walk order (None for a leaf the loss
    does not reach).  Autograd differentiates aliases of the leaves'
    storage, so the caller's tensors keep their flags."""
    live = [p.detach().requires_grad_() for _, p in tree_paths(params)]
    with torch.enable_grad():
        loss = mod.loss(_from_leaves(params, live), batch, cfg, rt)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), list(grads)


def check_grad_shardings(grad_shardings, params) -> None:
    """``grad_shardings`` (a tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding`) has the
    parameters' leaves, and each sharding fits its leaf's shape on its
    mesh; raises ``ValueError`` where not."""
    from ..distributed.sharding import check_sharding
    got = tree_paths(grad_shardings)
    want = tree_paths(params)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError("grad_shardings do not have the parameters' leaves")
    for (path, sh), (_, leaf) in zip(got, want):
        try:
            check_sharding(leaf.shape, sh)
        except ValueError as e:
            raise ValueError(f"grad_shardings{path}: {e}") from None


def make_train_step(mod, cfg: ModelConfig, tcfg: TrainConfig,
                    rt: Optional[Runtime] = None,
                    grad_shardings=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates the parameter and moment tensors in place
    and returns them; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``
    as 0-d tensors.  ``batch`` holds tensors or numpy arrays (moved to the
    parameters' device).

    With ``tcfg.microbatch`` below the batch, the batch is cut into ``B /
    microbatch`` slices whose float32 gradients are summed; the loss and
    the gradients are the means over the slices.  The remat policy is
    threaded through ``rt.remat``.  With ``rt.mesh`` set, the MoE layers
    run tensor-parallel on it, and their partial gradients meet in the
    mesh's reductions.  ``grad_shardings`` (a tree of ``NamedSharding``
    matching the parameters) is, in the reference, a layout hint that
    pins each microbatch's gradients to the ZeRO layout; every rank of
    the port's mesh shares one device, so here it is checked against the
    parameters at the first step (:func:`check_grad_shardings`) and
    places nothing."""
    rt = rt or Runtime()
    rt.remat = tcfg.remat if tcfg.remat != "none" else rt.remat
    salt0 = rt._salt
    f32 = torch.float32

    def grads_of(params, batch) -> Tuple[torch.Tensor, list]:
        rt._salt = salt0
        loss, grads = loss_and_grads(mod, params, batch, cfg, rt)
        return loss, [torch.zeros_like(p) if g is None else g
                      for (_, p), g in zip(tree_paths(params), grads)]

    checked = []

    def train_step(params, opt_state: OptState, batch):
        if grad_shardings is not None and not checked:
            check_grad_shardings(grad_shardings, params)
            checked.append(True)
        # A batch of numpy arrays (``data.batches``) goes to the params'.
        dev = tree_paths(params)[0][1].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        bsz = batch["tokens"].shape[0]
        mb = tcfg.microbatch
        if mb and mb < bsz:
            if bsz % mb:
                raise ValueError(f"batch {bsz} is not a multiple of the "
                                 f"microbatch {mb}")
            n_acc = bsz // mb
            acc = [torch.zeros(p.shape, dtype=f32, device=p.device)
                   for _, p in tree_paths(params)]
            loss_sum = None
            for i in range(n_acc):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, grads = grads_of(params, part)
                for a, g in zip(acc, grads):
                    a.add_(g.to(f32))
                del grads
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / n_acc
            for a in acc:
                a.div_(n_acc)
            grads = acc
        else:
            loss, grads = grads_of(params, batch)
        params, opt_state, metrics = adamw_update(
            _from_leaves(params, grads), opt_state, params, tcfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


@dataclasses.dataclass
class Trainer:
    """Production loop: deterministic data, asynchronous checkpoints,
    preemption handling and a straggler watchdog around the train step.
    ``donate`` (the reference's buffer donation) updates the parameters
    and the optimizer state in place; without it each step works on
    copies."""

    mod: Any
    cfg: ModelConfig
    tcfg: TrainConfig
    params: Any
    opt_state: Optional[OptState] = None
    rt: Optional[Runtime] = None
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 100
    step: int = 0
    watchdog: Watchdog = dataclasses.field(default_factory=Watchdog)
    donate: bool = True

    def __post_init__(self):
        if self.opt_state is None:
            self.opt_state = adamw_init(self.params)
        self.rt = self.rt or Runtime()
        install_preemption_handler()
        self._step_fn = make_train_step(self.mod, self.cfg, self.tcfg,
                                        self.rt)

    # ------------------------------------------------------------------ API
    def state(self):
        return {"params": self.params, "opt": self.opt_state._asdict()}

    def save(self, blocking: bool = False):
        if self.ckpt:
            self.ckpt.save(self.step, self.state(), blocking=blocking,
                           extra={"step": self.step})

    def restore(self, step: Optional[int] = None, shardings=None):
        tree = self.ckpt.restore(self.state(), step=step,
                                 shardings=shardings)
        self.params = tree["params"]
        self.opt_state = OptState(**tree["opt"])
        self.step = int(self.opt_state.count)

    def run(self, data_iter, n_steps: int) -> Dict[str, list]:
        history = {"loss": [], "grad_norm": [], "step_time": []}
        for _ in range(n_steps):
            batch = next(data_iter)
            t0 = time.perf_counter()
            params, opt = self.params, self.opt_state
            if not self.donate:
                params = _clone(params)
                opt = OptState(_clone(opt.m), _clone(opt.v), opt.count)
            self.params, self.opt_state, metrics = self._step_fn(
                params, opt, batch)
            loss = float(metrics["loss"])         # waits for the step
            dt = time.perf_counter() - t0
            self.step += 1
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["step_time"].append(dt)
            self.watchdog.record(self.step, dt)
            if self.ckpt and self.step % self.ckpt_every == 0:
                self.save()
            if PREEMPTED.is_set():
                self.save(blocking=True)
                break
        if self.ckpt:
            self.ckpt.wait()
        return history
