"""DWC PE: the depthwise-convolution engine, on the H100.

Wrappers of the CUDA kernels in csrc/dwc_pe.cu:

  * `dwc2d` replaces src/repro/kernels/dwc_pe.py::dwc2d, kernel body
    `_dwc2d_kernel` (:40): the CNNs' k x k depthwise convs, int8.  With
    `pad` it reads the unpadded map and its SAME halo in place (the CNN
    path hands it the map as the producer wrote it), and `plan_dwc2d`
    picks its route (channels a thread) and run (outputs a thread).
  * `dwc1d_causal` replaces src/repro/kernels/dwc_pe.py::dwc1d_causal,
    kernel body `_dwc1d_kernel` (:157): the mamba mixer's causal temporal
    conv, f32 in and out, act none or silu.  It reads x in place from a
    view whose channels are contiguous (the mixer hands it the x half of
    in_proj's output), and `plan_dwc1d` picks its route.

Bound on the H100 and the design's answer: see the note at the top of
csrc/dwc_pe.cu (no channel reduction, so bytes-bound; channels innermost,
accumulator and epilogue in registers; both convs slide their taps through
registers over a run of outputs).

The plain versions are `dwc2d_plain` (F.pad, then ref.dwc2d on the padded
map) and ref.dwc1d_causal.  ref.dwc2d multiplies the scales in ref.py's
order (acc * a_scale * w_scale); the
Pallas kernel folds a_scale into w_scale first, which can move one int8
code.  The kernel follows ref.py.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ptr, require
from repro_torch.kernels.conv_pe import byte_align

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.dwc_pe_dwc2d.argtypes = [_V, _V, _V, _V, _F, _V] + [_I] * 14 + [
        _F, _V]
    lib.dwc_pe_dwc2d.restype = _I
    lib.dwc_pe_dwc1d.argtypes = ([_V, _V, _V, _V] + [_I] * 4
                                 + [ctypes.c_longlong] * 2 + [_I] * 2 + [_V])
    lib.dwc_pe_dwc1d.restype = _I


dwc1d_causal_plain = ref.dwc1d_causal

Pad = Tuple[int, int, int, int]          # (top, bottom, left, right)

DWC2D_THREADS = 128        # threads a block, both routes (csrc DW_THREADS)
# outputs a thread the vector route takes, by k (the zoo's k): the runs
# scripts/cnn_probe.py timed at MobileNetV2's k = 3 layers; k = 5 (only
# efficientnet's) keeps run 1 until a probe times a longer one there
DWC2D_RUNS = {3: (1, 2, 4), 5: (1,)}
DWC2D_VEC_K = tuple(DWC2D_RUNS)
DWC2D_MIN_THREADS = 49152  # the longest run whose grid keeps this many


class PlanDwc2d(NamedTuple):
    route: str             # "vec4": four channels a thread; "scalar": one
    run: int               # consecutive outputs along W a thread
    blocks: int            # blocks of DWC2D_THREADS along the grid's x


_LANES = {"vec4": 4, "scalar": 1}


@functools.lru_cache(maxsize=1024)
def plan_dwc2d(n: int, h: int, w: int, c: int, k: int, stride: int,
               aligned: int) -> PlanDwc2d:
    """The launch of dwc2d at outputs [n, h, w, c] (h and w the OUTPUT
    rows and columns), k x k taps at `stride`; `aligned`: the byte
    alignment (up to 16) of x's and w's first elements.  The vector route
    takes C % 4 == 0, k in DWC2D_VEC_K, stride 1 or 2 and both on 4
    bytes, at the longest run of DWC2D_RUNS[k] whose grid still has
    DWC2D_MIN_THREADS threads (the most reuse of a loaded column while the
    card stays full; the shortest run where none has); every other shape
    takes the scalar route, one output a thread."""
    if (c % 4 or k not in DWC2D_VEC_K or stride not in (1, 2)
            or aligned < 4):
        return dwc2d_launch("scalar", 1, w, c)
    run = max((r for r in DWC2D_RUNS[k]
               if n * h * (c // 4) * -(-w // r) >= DWC2D_MIN_THREADS),
              default=DWC2D_RUNS[k][0])
    return dwc2d_launch("vec4", run, w, c)


def dwc2d_launch(route: str, run: int, w: int, c: int) -> PlanDwc2d:
    """The plan of `route` at `run` outputs a thread, for output rows of w
    columns of c channels (what a probe or a test forces)."""
    threads = c // _LANES[route] * -(-w // run)
    return PlanDwc2d(route, run, -(-threads // DWC2D_THREADS))


def dwc2d_plain(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, act: str,
                a_scale=None, w_scale=None, out_scale=None,
                out_dtype=torch.float32,
                pad: Optional[Pad] = None) -> torch.Tensor:
    """The plain version: the map zero-padded by `pad` (F.pad), then
    ref.dwc2d on the padded map."""
    if pad is not None:
        top, bottom, left, right = pad
        x = F.pad(x, (0, 0, left, right, top, bottom))
    return ref.dwc2d(x, w, bias, stride, act, a_scale=a_scale,
                     w_scale=w_scale, out_scale=out_scale,
                     out_dtype=out_dtype)


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
          out_scale: Optional[float] = None, out_dtype=torch.float32,
          pad: Optional[Pad] = None) -> torch.Tensor:
    """Quantized depthwise conv.  x int8 [N, H, W, C]; w int8 [k, k, C];
    bias f32 [C] or None; a_scale the per-tensor activation scale; w_scale
    f32 [C]; out_scale None (f32 out) or the int8 requant scale.  pad None:
    x is pre-padded (VALID, the JAX signature's meaning); else (top,
    bottom, left, right) zeros around x, read in place on the card.
    Returns [N, Ho, Wo, C]."""
    if not x.is_cuda:
        return dwc2d_plain(x, w, bias, stride, act, a_scale=a_scale,
                           w_scale=w_scale, out_scale=out_scale,
                           out_dtype=out_dtype, pad=pad)
    n, h, wd, c = x.shape
    k = w.shape[0]
    require(x, "x", torch.int8)
    require(w, "w", torch.int8, (k, k, c))
    wsc = require(w_scale.reshape(c), "w_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (c,))
    if out_scale is None and out_dtype != torch.float32:
        raise ValueError(f"dwc kernel writes f32 or int8, not {out_dtype}")
    top, bottom, left, right = pad or (0, 0, 0, 0)
    if min(top, bottom, left, right) < 0 or max(top, bottom,
                                                left, right) >= k:
        raise ValueError(f"dwc kernel: pads {pad} outside [0, {k})")
    ho = (h + top + bottom - k) // stride + 1
    wo = (wd + left + right - k) // stride + 1
    p = plan_dwc2d(n, ho, wo, c, k, stride,
                   min(byte_align(x), byte_align(w)))
    out = torch.empty((n, ho, wo, c), device=x.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    lib = _build.library("dwc_pe", _bind)
    err = lib.dwc_pe_dwc2d(
        x.data_ptr(), w.data_ptr(), ptr(bias), wsc.data_ptr(), float(a_scale),
        out.data_ptr(), n, h, wd, c, k, stride, ho, wo, top, left,
        _LANES[p.route], p.run, _build.act_code(act),
        int(out_scale is not None),
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
