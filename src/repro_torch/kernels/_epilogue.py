"""The fused-epilogue chain: the math every PE tail shares (the port's copy
of repro.kernels._epilogue).

`passes.fuse_epilogues` folds {residual add, avg/global/max pool tail,
activation, requant} chains into the producing Conv/DWC launch.  This module
is the single definition of that chain's VALUE semantics, applied to the
PE's post-activation output.  The ref backend calls it on the full array;
the CUDA kernels apply the same operations in the same order in registers
(csrc/conv_pe.cu) and are held against it.

Static programs (mid_scale given) quantize-dequantize at exactly the
interior edge scales the unfused program materialized tensors at, so fused
int8 execution is bit-identical to running the ops separately.  Dynamic
programs (mid_scale None) run the chain in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import div, mul, qdq_codes
from repro_torch.kernels.ref import act_fn, maxpool2d, window_sum


def fused_chain(x: torch.Tensor, *,
                mid_scale: Optional[float] = None,
                residual: Optional[torch.Tensor] = None,
                res_scale: float = 1.0,
                add_act: str = "none",
                add_scale: Optional[float] = None,
                pool: str = "none",
                pool_kernel: int = 0,
                pool_stride: int = 0,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """Apply a fused Epilogue chain to the PE output.

    x: f32 [N, H, W, C], the conv/dwc result AFTER its own bias +
    activation, BEFORE any requant.  residual: raw operand values (int8 or
    f32), same shape.  Scales are compile-time Python floats (static chain)
    or None (dynamic f32 chain).  Returns int8 for a static chain ending in
    a requant (or the scale-preserving max tail), f32 otherwise.
    """
    static = mid_scale is not None
    if static:
        x = qdq_codes(x, mid_scale)            # the absorbed conv edge
    cur = mid_scale
    if residual is not None:
        r = mul(residual.to(torch.float32), res_scale)
        x = (mul(x, mid_scale) + r) if static else (x + r)
        x = act_fn(add_act)(x)
        if static:
            cur = add_scale if pool != "none" else out_scale
            if cur is not None:
                x = qdq_codes(x, cur)          # the absorbed add edge
    if pool == "none":
        if static and cur is not None:
            return x.to(torch.int8)
        return x
    if pool == "max":
        # Order-preserving on the quantized values: the scale passes through.
        y = maxpool2d(x, pool_kernel, pool_stride)
        return y.to(torch.int8) if static else y
    if pool == "global":
        if static:
            # int32 sum like every engine accumulator, then one scale
            # (cur / px in double, rounded once to f32) + requant.
            px = x.shape[-3] * x.shape[-2]
            acc = x.to(torch.int32).sum(dim=(-3, -2), dtype=torch.int32)
            y = mul(acc.to(torch.float32), cur / px)
        else:
            y = x.mean(dim=(-3, -2))
    else:                                       # avg
        if static:
            acc = window_sum(x.to(torch.int32), pool_kernel, pool_stride)
            y = mul(acc.to(torch.float32), cur / pool_kernel ** 2)
        else:
            y = div(window_sum(x, pool_kernel, pool_stride),
                    float(pool_kernel ** 2))
    if static and out_scale is not None:
        return qdq_codes(y, out_scale).to(torch.int8)
    return y


def chain_out_dtype(mid_scale, pool: str, out_scale, out_dtype):
    """The dtype `fused_chain` emits."""
    if mid_scale is not None and (out_scale is not None or pool == "max"):
        return torch.int8
    return out_dtype


def pooled_hw(ho: int, wo: int, pool: str, k: int, stride: int):
    """Output spatial dims after the chain's pool stage."""
    if pool == "none":
        return ho, wo
    if pool == "global":
        return 1, 1
    return (ho - k) // stride + 1, (wo - k) // stride + 1
