"""AdamW with global-norm clipping and a warmup + cosine schedule (port of
:mod:`repro.train.optimizer`).

The state is ``OptState(m, v, count)``: ``m`` / ``v`` trees of float32
tensors whatever the parameter dtype (mixed-precision master statistics),
``count`` an int32 scalar tensor.  :func:`adamw_update` works in place on
the parameter, ``m`` and ``v`` leaves under ``torch.no_grad()``, so a step
allocates no second copy of the parameters; the schedule, the bias
corrections and the clip scale are float32 tensors, as the reference
computes them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import TrainConfig
from ..models.params import tree_map, tree_paths

__all__ = ["OptState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm"]


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> OptState:
    """Zero moments (float32, on each leaf's device) and a zero count on
    the host."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32))


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to a tenth of it;
    float32 on ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaf
    sums added in tree order."""
    sums = [x.to(torch.float32).square().sum() for _, x in tree_paths(tree)]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: TrainConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: clip ``grads`` by their global norm, update ``m``,
    ``v`` and the parameters in place (the step in float32, cast back to
    each parameter's dtype).  Returns ``(params, OptState(m, v, count + 1),
    {"grad_norm", "lr"})``; ``params`` and the moments are the trees passed
    in."""
    f32 = torch.float32
    count = state.count + 1
    lr = lr_schedule(cfg, count)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(f32)
    mhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b1, dtype=f32), c))
    vhat_scale = 1.0 / (1 - torch.pow(torch.tensor(b2, dtype=f32), c))

    flat = zip(tree_paths(grads), tree_paths(state.m), tree_paths(state.v),
               tree_paths(params))
    # Each product is rounded where the reference rounds it; the in-place
    # forms only reuse the temporaries (the largest leaf's few at a time).
    for (_, g), (_, m), (_, v), (_, p) in flat:
        g = g.to(f32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        step = m * mhat_scale
        step.div_((v * vhat_scale).sqrt_().add_(1e-8))
        step.add_(p.to(f32) * cfg.weight_decay).mul_(lr)
        if p.dtype == f32:
            p.sub_(step)
        else:
            p.copy_(p.to(f32) - step)
    return params, OptState(state.m, state.v, count), \
        {"grad_norm": gnorm, "lr": lr}
