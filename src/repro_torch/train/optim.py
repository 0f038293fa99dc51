"""AdamW + gradient clipping + the LR schedule (the port's copy of
repro.train.optim).

The update runs in place, leaf by leaf: the parameters, both moments and
the step are overwritten, so the update holds one leaf's temporaries on top
of the state and its gradients (a functional update, as JAX writes it,
would hold a second copy of params and moments).  The arithmetic and its
order are the reference's.  Every scalar of the update (the step,
the learning rate, the clip factor, the bias corrections) stays a tensor
on the parameters' device, so a step makes no host round trip.  The
reference's ZeRO-1 specs (`zero1_pspec`, `opt_state_pspecs`) are mesh
sharding rules and join with the multi-device slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.train import tree

_F = torch.float32


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an f32 scalar on `like`'s device (rounded once to
    f32, as JAX's weakly typed scalars are)."""
    return torch.full((), x, dtype=_F, device=like.device)


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, at an int step tensor."""
    s = step.to(_F)
    warm = torch.clamp(s / _c(max(cfg.warmup_steps, 1), s), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / _c(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params) -> dict:
    """f32 first and second moments (zeros) and the step (int32 0)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_F, device=p.device)  # noqa: E731
    dev = tree.leaves(params)[0].device
    return {"m": tree.tree_map(zeros, params),
            "v": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, the leaves' sums added
    in leaf order."""
    total = 0
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(_F)))
    return torch.sqrt(total)


def adamw_update(params, grads, opt_state: dict, cfg: TrainConfig
                 ) -> Tuple[dict, dict, dict]:
    """(params, opt_state, metrics {grad_norm, lr}), the first two being
    the caller's own trees, updated in place.  `grads` is a tree like
    `params` or its leaf list.  Clip by the global norm, f32 moments, bias
    correction, decoupled weight decay on tensors with ndim >= 2 only, in
    the reference's order."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    flat_g = grads if isinstance(grads, list) else tree.leaves(grads)
    gnorm = global_norm(flat_g)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    sf = step.to(_F)
    bc1 = 1 - torch.pow(_c(b1, sf), sf)
    bc2 = 1 - torch.pow(_c(b2, sf), sf)
    with torch.no_grad():
        for p, g, m, v in zip(tree.leaves(params), flat_g,
                              tree.leaves(opt_state["m"]),
                              tree.leaves(opt_state["v"])):
            g = g.to(_F) * clip
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if p.ndim >= 2 and wd > 0:        # decay matrices only
                delta = delta + wd * p.to(_F)
            p.copy_(p.to(_F) - lr * delta)
        opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
