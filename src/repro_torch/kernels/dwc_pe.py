"""DWC PE: the depthwise-convolution engine, on the H100.

`dwc2d` wraps the CUDA kernel in csrc/dwc_pe.cu and replaces
src/repro/kernels/dwc_pe.py::dwc2d, kernel body `_dwc2d_kernel` (:40).
Bound on the H100 and the design's answer: see the note at the top of
csrc/dwc_pe.cu (no channel reduction, so bytes-bound; one thread per
output with channels innermost, accumulator and epilogue in registers).

The plain version is ref.dwc2d.  It multiplies the scales in ref.py's order
(acc * a_scale * w_scale); the Pallas kernel folds a_scale into w_scale
first, which can move one int8 code.  The kernel follows ref.py.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.dwc_pe_dwc2d.argtypes = [_V, _V, _V, _V, _F, _V] + [_I] * 10 + [
        _F, _V]
    lib.dwc_pe_dwc2d.restype = _I


dwc2d_plain = ref.dwc2d


def dwc2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          stride: int, act: str, a_scale: float, w_scale: torch.Tensor,
          out_scale: Optional[float] = None,
          out_dtype=torch.float32) -> torch.Tensor:
    """Quantized depthwise conv on a pre-padded input (VALID).
    x int8 [N, Hp, Wp, C]; w int8 [k, k, C]; bias f32 [C] or None; a_scale
    the per-tensor activation scale; w_scale f32 [C]; out_scale None (f32
    out) or the int8 requant scale.  Returns [N, Ho, Wo, C]."""
    if not x.is_cuda:
        return dwc2d_plain(x, w, bias, stride, act, a_scale=a_scale,
                           w_scale=w_scale, out_scale=out_scale,
                           out_dtype=out_dtype)
    n, hp, wp, c = x.shape
    k = w.shape[0]
    require(x, "x", torch.int8)
    require(w, "w", torch.int8, (k, k, c))
    wsc = require(w_scale.reshape(c), "w_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (c,))
    if out_scale is None and out_dtype != torch.float32:
        raise ValueError(f"dwc kernel writes f32 or int8, not {out_dtype}")
    ho = (hp - k) // stride + 1
    wo = (wp - k) // stride + 1
    out = torch.empty((n, ho, wo, c), device=x.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    lib = _build.library("dwc_pe", _bind)
    err = lib.dwc_pe_dwc2d(
        x.data_ptr(), w.data_ptr(), ptr(bias), wsc.data_ptr(), float(a_scale),
        out.data_ptr(), n, hp, wp, c, k, stride, ho, wo,
        _build.act_code(act), int(out_scale is not None),
        float(out_scale) if out_scale is not None else 1.0,
        _build.stream_ptr(x))
    _build.check(err, "dwc")
    _build.count("dwc")
    return out
