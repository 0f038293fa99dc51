"""Train-step builder: loss, gradient accumulation, remat, optimizer update
(the port's copy of repro.train.train_step).

make_train_step() returns
    train_step(state, batch) -> (state, metrics)
with `state` = {"params", "opt": {"m", "v", "step"}} (tensors on one
device, updated in place: the returned state holds the caller's tensors)
and `batch` = {"tokens", "labels"} (numpy arrays or tensors).  The
step is eager PyTorch: the forward runs `T.forward`, whose float
projections launch the float Conv PE GEMM on backend="cuda" (forward and
backward, through conv_pe.MatmulF), and the gradient is
torch.autograd.grad of the loss with respect to every parameter leaf.

Not ported yet, and refused here: the audio (whisper) and vlm families,
and mamba and recurrent layers (no backward yet).  The reference's
chunked-vocab CE, scanned layers, triangle skip and bf16 parameters have
no TrainConfig field in the port until their slices land.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.config import ArchConfig, EngineConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.train import loss as loss_lib
from repro_torch.train import optim, tree


def _check(arch: ArchConfig) -> None:
    if arch.family == "audio":
        raise NotImplementedError(f"{arch.name}: the encoder-decoder (whisper)"
                                  " forward joins with the whisper slice")
    if arch.family == "vlm":
        raise NotImplementedError(f"{arch.name}: the embeds frontend and "
                                  "M-RoPE join with the qwen2-vl slice")
    kinds = {arch.layer_kind(i) for i in range(arch.n_layers)}
    if kinds - {"global", "local"}:
        raise NotImplementedError(
            f"{arch.name}: training {sorted(kinds - {'global', 'local'})} "
            "layers is not ported (the mamba / RG-LRU backward is a later "
            "slice: the dwc1d kernel and the scan carry no gradient)")


def make_loss_fn(arch: ArchConfig, eng: EngineConfig,
                 tcfg: TrainConfig) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics): cross-entropy with the
    z-loss on T.forward's logits, plus 0.01 x the aux loss."""
    _check(arch)

    def loss_fn(params, batch):
        logits, aux = T.forward(params, batch, arch, eng, remat=tcfg.remat)
        loss, metrics = loss_lib.cross_entropy(logits, batch["labels"],
                                               z_loss=tcfg.z_loss)
        loss = loss + 0.01 * aux
        metrics["aux_loss"] = aux.detach()
        return loss, metrics

    return loss_fn


def _microbatch(batch: dict, n: int, i: int) -> dict:
    """Rows [i * B/n, (i + 1) * B/n) of every batch entry."""
    def slice_one(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: slice_one(v) for k, v in batch.items()}


def _to_device(batch: dict, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def _value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads as a leaf list) of loss_fn at params."""
    flat = tree.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    loss, metrics = loss_fn(tree.unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), metrics), grads


def make_train_step(arch: ArchConfig, eng: EngineConfig,
                    tcfg: TrainConfig) -> Callable:
    loss_fn = make_loss_fn(arch, eng, tcfg)

    def train_step(state, batch):
        params = state["params"]
        batch = _to_device(batch, tree.leaves(params)[0].device)
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            gsum, lsum, ms = None, 0.0, []
            for i in range(n):
                (l, m), g = _value_and_grad(loss_fn, params,
                                            _microbatch(batch, n, i))
                g = [x.to(torch.float32) for x in g]
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + l
                ms.append(m)
            grads = [g / n for g in gsum]
            loss = lsum / n
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        else:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
        params, opt, opt_metrics = optim.adamw_update(
            params, grads, state["opt"], tcfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(params) -> dict:
    return {"params": params, "opt": optim.init_opt_state(params)}
