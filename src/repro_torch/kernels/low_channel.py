"""Low-Channel Conv Unit: the first-layer conv, on the H100.

`low_channel_conv` wraps the CUDA kernel in csrc/low_channel.cu and
replaces src/repro/kernels/low_channel.py::low_channel_conv, kernel body
`_kernel` (:33).  Bound on the H100 and the design's answer: see the note
at the top of csrc/low_channel.cu (a 27-deep reduction, bytes- and
latency-bound; filter bank in shared memory, the im2col window read in
place).

The plain version is ref.low_channel_conv, with ref.py's scale order
(acc * a_scale * w_scale); the Pallas kernel multiplies a_scale * w_scale
first, which can move one int8 code.  The kernel follows ref.py.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MAX_FILTER_BYTES = 48 * 1024        # default dynamic shared memory


def _bind(lib: ctypes.CDLL) -> None:
    lib.low_channel_conv.argtypes = [_V, _V, _V, _V, _F, _V] + [_I] * 11 + [
        _F, _V]
    lib.low_channel_conv.restype = _I


low_channel_conv_plain = ref.low_channel_conv


def low_channel_conv(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int, act: str,
                     a_scale: float, w_scale: torch.Tensor,
                     out_scale: Optional[float] = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Quantized small-IC conv on a pre-padded input (VALID).
    x int8 [N, Hp, Wp, IC]; w int8 [k, k, IC, OC]; bias f32 [OC] or None;
    a_scale the per-tensor activation scale; w_scale f32 [OC]; out_scale
    None (f32 out) or the int8 requant scale.  Returns [N, Ho, Wo, OC]."""
    if not x.is_cuda:
        return low_channel_conv_plain(x, w, bias, stride, act,
                                      a_scale=a_scale, w_scale=w_scale,
                                      out_scale=out_scale,
                                      out_dtype=out_dtype)
    n, hp, wp, ic = x.shape
    k, oc = w.shape[0], w.shape[3]
    require(x, "x", torch.int8)
    require(w, "w", torch.int8, (k, k, ic, oc))
    if w.numel() > _MAX_FILTER_BYTES:
        raise ValueError(f"low-channel filter bank of {w.numel()} bytes "
                         f"exceeds {_MAX_FILTER_BYTES} of shared memory")
    wsc = require(w_scale.reshape(oc), "w_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (oc,))
    if out_scale is None and out_dtype != torch.float32:
        raise ValueError(f"low-channel kernel writes f32 or int8, "
                         f"not {out_dtype}")
    ho = (hp - k) // stride + 1
    wo = (wp - k) // stride + 1
    out = torch.empty((n, ho, wo, oc), device=x.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    lib = _build.library("low_channel", _bind)
    err = lib.low_channel_conv(
        x.data_ptr(), w.data_ptr(), ptr(bias), wsc.data_ptr(),
        float(a_scale), out.data_ptr(), n, hp, wp, ic, oc, k, stride, ho, wo,
        _build.act_code(act), int(out_scale is not None),
        float(out_scale) if out_scale is not None else 1.0,
        _build.stream_ptr(x))
    _build.check(err, "low_channel")
    _build.count("low_channel")
    return out
