"""DWC PE: the depthwise-convolution engine, on the H100.

Wrappers of the CUDA kernels in csrc/dwc_pe.cu:

  * `dwc2d` replaces src/repro/kernels/dwc_pe.py::dwc2d, kernel body
    `_dwc2d_kernel` (:40): the CNNs' k x k depthwise convs, int8.
  * `dwc1d_causal` replaces src/repro/kernels/dwc_pe.py::dwc1d_causal,
    kernel body `_dwc1d_kernel` (:157): the mamba mixer's causal temporal
    conv, f32 in and out, act none or silu.  It reads x in place from a
    view whose channels are contiguous (the mixer hands it the x half of
    in_proj's output), and `plan_dwc1d` picks its route.

Bound on the H100 and the design's answer: see the note at the top of
csrc/dwc_pe.cu (no channel reduction, so bytes-bound; channels innermost,
accumulator and epilogue in registers; the 1-D conv's taps slide through
registers over four channels and two steps a thread).

The plain versions are ref.dwc2d and ref.dwc1d_causal.  ref.dwc2d
multiplies the scales in ref.py's order (acc * a_scale * w_scale); the
Pallas kernel folds a_scale into w_scale first, which can move one int8
code.  The kernel follows ref.py.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.dwc_pe_dwc2d.argtypes = [_V, _V, _V, _V, _F, _V] + [_I] * 10 + [
        _F, _V]
    lib.dwc_pe_dwc2d.restype = _I
    lib.dwc_pe_dwc1d.argtypes = ([_V, _V, _V, _V] + [_I] * 4
                                 + [ctypes.c_longlong] * 2 + [_I] * 2 + [_V])
    lib.dwc_pe_dwc1d.restype = _I


dwc2d_plain = ref.dwc2d
dwc1d_causal_plain = ref.dwc1d_causal

# the dwc1d kernel's activations (the mamba mixer's silu, RG-LRU's none)
_DWC1D_ACTS = {"none": 0, "silu": 1}

DWC1D_THREADS = 256        # threads a block, both routes (csrc THREADS)
DWC1D_VEC_K = 4            # the float4 route's taps, the mamba mixers' (VK)
DWC1D_VEC_STEPS = 2        # steps a thread on the float4 route (csrc VT)
DWC1D_SCALAR_STEPS = 8     # steps a thread on the scalar route (csrc TCH)


class PlanDwc1d(NamedTuple):
    route: str             # "vec4": four channels a thread; "scalar": one
    steps: int             # consecutive time steps a thread
    blocks: int            # blocks of DWC1D_THREADS in the grid


@functools.lru_cache(maxsize=1024)
def plan_dwc1d(b: int, l: int, c: int, k: int,
               aligned: bool = True) -> PlanDwc1d:
    """The launch of dwc1d at x [B, L, C], k taps.  `aligned`: x's first
    element and both of its strides keep every float4 on 16 bytes.  The
    float4 route takes C % 4 == 0, k == DWC1D_VEC_K and an aligned x; any
    other shape takes the scalar route."""
    if c % 4 == 0 and k == DWC1D_VEC_K and aligned:
        t, lanes, route = DWC1D_VEC_STEPS, 4, "vec4"
    else:
        t, lanes, route = DWC1D_SCALAR_STEPS, 1, "scalar"
    return PlanDwc1d(route, t, -(-b * -(-l // t) * (c // lanes)
                                 // DWC1D_THREADS))


def _aligned_rows(x: torch.Tensor) -> bool:
    """x [B, L, C] f32 keeps every group of four channels on 16 bytes."""
    return (x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0
            and x.stride(1) % 4 == 0)


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


def dwc1d_causal(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, act: str = "none",
                 out_dtype=torch.float32) -> torch.Tensor:
    """Causal depthwise temporal conv.  x f32 [B, L, C], any strides with
    the channels contiguous (a column slice of a wider row reads in
    place); w f32 [k, C]; bias f32 [C] or None; act "none" or "silu".
    Returns a contiguous f32 [B, L, C]."""
    if not x.is_cuda:
        return dwc1d_causal_plain(x, w, bias, act, out_dtype=out_dtype)
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"x: expected a float32 [B, L, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, l, c = x.shape
    k = w.shape[0]
    if c > 1 and x.stride(2) != 1:
        raise ValueError(f"x: the channels must be contiguous, got strides "
                         f"{x.stride()}")
    require(w, "w", torch.float32, (k, c))
    if bias is not None:
        require(bias, "bias", torch.float32, (c,))
    if out_dtype != torch.float32:
        raise ValueError(f"dwc1d kernel writes f32, not {out_dtype}")
    if act not in _DWC1D_ACTS:
        raise ValueError(f"dwc1d kernel: activation {act!r} not in "
                         f"{sorted(_DWC1D_ACTS)}")
    p = plan_dwc1d(b, l, c, k, _aligned_rows(x))
    out = torch.empty((b, l, c), dtype=torch.float32, device=x.device)
    lib = _build.library("dwc_pe", _bind)
    err = lib.dwc_pe_dwc1d(x.data_ptr(), w.data_ptr(), ptr(bias),
                           out.data_ptr(), b, l, c, k, x.stride(0),
                           x.stride(1), int(p.route == "vec4"),
                           _DWC1D_ACTS[act], _build.stream_ptr(x))
    _build.check(err, "dwc1d")
    _build.count("dwc1d")
    return out
