"""Low-Channel Conv Unit: the first-layer conv, on the H100.

`low_channel_conv` wraps the CUDA kernels in csrc/low_channel.cu and
replaces src/repro/kernels/low_channel.py::low_channel_conv, kernel body
`_kernel` (:33): the plain stem, and the stem with its fused max-pool tail
(ResNet's 7x7/2 conv -> 3x3/2 max pool).  Bound on the H100 and the
design's answer: see the note at the top of csrc/low_channel.cu (a
27..147-deep reduction, bytes- and latency-bound; filter bank in shared
memory, the im2col window read in place; the max tail pools from a conv
tile in shared memory, so the pre-pool map is never written).

The plain version is ref.low_channel_conv (+ the _epilogue chain for a
pool tail), with ref.py's scale order (acc * a_scale * w_scale); the
Pallas kernel multiplies a_scale * w_scale first, which can move one int8
code.  The kernel follows ref.py.  The avg and global tails have no kernel
(no zoo model reaches them) and raise on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, _epilogue, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MAX_SMEM = 48 * 1024                # default dynamic shared memory
_TILE, _OC_BLOCK = 8, 32             # max tail: pooled tile, channel block


def _bind(lib: ctypes.CDLL) -> None:
    lib.low_channel_conv.argtypes = [_V, _V, _V, _V, _F, _V] + [_I] * 11 + [
        _F, _V]
    lib.low_channel_conv.restype = _I
    lib.low_channel_conv_max.argtypes = ([_V, _V, _V, _V, _F, _V]
                                         + [_I] * 9 + [_F] + [_I] * 7 + [_V])
    lib.low_channel_conv_max.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.library("low_channel", _bind)


def low_channel_conv_plain(x, w, bias, stride: int, act: str = "none",
                           a_scale=None, w_scale=None, out_scale=None,
                           out_dtype=torch.float32, *, pool: str = "none",
                           pool_kernel: int = 0, pool_stride: int = 0,
                           mid_scale: Optional[float] = None) -> torch.Tensor:
    """ref.low_channel_conv, and with a pool tail the f32 stem output
    through the _epilogue chain (qdq at mid_scale for a static chain)."""
    if pool == "none":
        return ref.low_channel_conv(x, w, bias, stride, act, a_scale=a_scale,
                                    w_scale=w_scale, out_scale=out_scale,
                                    out_dtype=out_dtype)
    y = ref.low_channel_conv(x, w, bias, stride, act, a_scale=a_scale,
                             w_scale=w_scale, out_dtype=torch.float32)
    return _epilogue.fused_chain(y, mid_scale=mid_scale, pool=pool,
                                 pool_kernel=pool_kernel,
                                 pool_stride=pool_stride, out_scale=out_scale)


def low_channel_conv(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int, act: str,
                     a_scale: float, w_scale: torch.Tensor,
                     out_scale: Optional[float] = None,
                     out_dtype=torch.float32, *, pool: str = "none",
                     pool_kernel: int = 0, pool_stride: int = 0,
                     mid_scale: Optional[float] = None) -> torch.Tensor:
    """Quantized small-IC conv on a pre-padded input (VALID).
    x int8 [N, Hp, Wp, IC]; w int8 [k, k, IC, OC]; bias f32 [OC] or None;
    a_scale the per-tensor activation scale; w_scale f32 [OC]; out_scale
    None (f32 out) or the int8 requant scale.  Returns [N, Ho, Wo, OC].

    pool="max" fuses a VALID pool_kernel x pool_kernel / pool_stride max
    tail: with mid_scale (a static chain) the stem output is requantized at
    mid_scale and the pooled int8 codes keep that scale (out_scale is not
    applied, as in the reference's chain); without it the max is over f32.
    Returns [N, PHo, PWo, OC] then."""
    if not x.is_cuda:
        return low_channel_conv_plain(
            x, w, bias, stride, act, a_scale=a_scale, w_scale=w_scale,
            out_scale=out_scale, out_dtype=out_dtype, pool=pool,
            pool_kernel=pool_kernel, pool_stride=pool_stride,
            mid_scale=mid_scale)
    if pool == "max":
        return _conv_max(x, w, bias, stride, act, float(a_scale), w_scale,
                         pool_kernel, pool_stride, mid_scale)
    if pool != "none":
        raise NotImplementedError(
            f"the Low-Channel {pool!r} pool tail has no CUDA kernel "
            "(no zoo model reaches it); run backend='ref'")
    n, hp, wp, ic = x.shape
    k, oc = w.shape[0], w.shape[3]
    wsc = _check_operands(x, w, bias, w_scale)
    if w.numel() > _MAX_SMEM:
        raise ValueError(f"low-channel filter bank of {w.numel()} bytes "
                         f"exceeds {_MAX_SMEM} of shared memory")
    if out_scale is None and out_dtype != torch.float32:
        raise ValueError(f"low-channel kernel writes f32 or int8, "
                         f"not {out_dtype}")
    ho = (hp - k) // stride + 1
    wo = (wp - k) // stride + 1
    out = torch.empty((n, ho, wo, oc), device=x.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    err = _lib().low_channel_conv(
        x.data_ptr(), w.data_ptr(), ptr(bias), wsc.data_ptr(),
        float(a_scale), out.data_ptr(), n, hp, wp, ic, oc, k, stride, ho, wo,
        _build.act_code(act), int(out_scale is not None),
        float(out_scale) if out_scale is not None else 1.0,
        _build.stream_ptr(x))
    _build.check(err, "low_channel")
    _build.count("low_channel")
    return out


def _check_operands(x, w, bias, w_scale) -> torch.Tensor:
    """The checks both kernels share; returns w_scale as f32 [OC]."""
    ic = x.shape[-1]
    k, oc = w.shape[0], w.shape[-1]
    require(x, "x", torch.int8)
    require(w, "w", torch.int8, (k, k, ic, oc))
    if bias is not None:
        require(bias, "bias", torch.float32, (oc,))
    return require(w_scale.reshape(oc), "w_scale", torch.float32)


def _conv_max(x, w, bias, stride: int, act: str, a_scale: float, w_scale,
              pk: int, ps: int, mid_scale: Optional[float]) -> torch.Tensor:
    """The stem with its max-pool tail: one launch of the tiled kernel."""
    n, hp, wp, ic = x.shape
    k, oc = w.shape[0], w.shape[3]
    wsc = _check_operands(x, w, bias, w_scale)
    ho = (hp - k) // stride + 1
    wo = (wp - k) // stride + 1
    if pk < 1 or ps < 1 or pk > min(ho, wo):
        raise ValueError(f"max tail {pk}/{ps} does not fit a {ho}x{wo} map")
    pho, pwo = (ho - pk) // ps + 1, (wo - pk) // ps + 1
    tp, ocb = _TILE, min(_OC_BLOCK, oc)

    def smem(tp):   # conv tile (f32) + the block's filter slice (int8)
        return ((tp - 1) * ps + pk) ** 2 * ocb * 4 + k * k * ic * ocb

    while tp > 1 and smem(tp) > _MAX_SMEM:
        tp //= 2
    if smem(tp) > _MAX_SMEM:
        raise ValueError(f"max tail {pk}/{ps} with a {k}x{k}x{ic} filter "
                         f"needs {smem(tp)} bytes of shared memory")
    out = torch.empty((n, pho, pwo, oc), device=x.device,
                      dtype=torch.int8 if mid_scale is not None
                      else torch.float32)
    err = _lib().low_channel_conv_max(
        x.data_ptr(), w.data_ptr(), ptr(bias), wsc.data_ptr(), a_scale,
        out.data_ptr(), n, hp, wp, ic, oc, k, stride, _build.act_code(act),
        int(mid_scale is not None),
        float(mid_scale) if mid_scale is not None else 1.0, pk, ps, pho, pwo,
        tp, ocb, smem(tp), _build.stream_ptr(x))
    _build.check(err, "low_channel_max")
    _build.count("low_channel_max")
    return out
