"""MISC core: the standalone residual add and average pool, on the H100.

Wrappers of the CUDA kernels in csrc/misc_pe.cu, each beside its plain
PyTorch version:

  * `misc_add` -- replaces src/repro/kernels/misc_pe.py::misc_add, kernel
    body `_add_kernel` (:22): `a * sa + b * sb`, act, optional int8
    requant.  Every residual add of an unfused program runs here (16 per
    ResNet50 run); a fused program folds them into the Conv PE epilogue.
  * `avgpool2d` -- replaces `avgpool2d`, kernel body `_avgpool_kernel`
    (:62): a VALID k x k / s average with f32 out.  Unlike the reference,
    which takes its Pallas kernel only when C % 128 == 0, the kernel takes
    any channel count.

Bound on the H100 and the design's answer: see the note at the top of
csrc/misc_pe.cu (one bytes-bound pass; one thread per element, nothing
padded).  On a CUDA tensor each wrapper checks its operands and launches
its kernel or raises; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.misc_add.argtypes = [_V, _V, _V, ctypes.c_longlong, _I, _I, _F, _F,
                             _I, _I, _F, _V]
    lib.misc_add.restype = _I
    lib.misc_avgpool2d.argtypes = [_V, _V] + [_I] * 9 + [_V]
    lib.misc_avgpool2d.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.library("misc_pe", _bind)


def _scalar(s, name: str) -> float:
    if isinstance(s, torch.Tensor) and s.numel() != 1:
        raise ValueError(f"{name}: the MISC kernels take per-tensor scales")
    return float(s)


# ---------------------------------------------------------------------------
# misc_add (_add_kernel)
# ---------------------------------------------------------------------------

def misc_add_plain(a, b, sa=1.0, sb=1.0, act: str = "none", out_scale=None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: ref.misc_add (a * sa + b * sb, act, requant)."""
    return ref.misc_add(a, b, sa, sb, act, out_scale=out_scale,
                        out_dtype=out_dtype)


def misc_add(a: torch.Tensor, b: torch.Tensor, sa=1.0, sb=1.0,
             act: str = "none", out_scale: Optional[float] = None,
             out_dtype=torch.float32) -> torch.Tensor:
    """Fused scaled add: act(a * sa + b * sb), requantized to int8 at
    out_scale when it is given, else f32.  a and b: the same shape, each
    int8 codes (a static program's edge, its scale sa / sb) or f32 (a
    dynamic program, or the f32 residual stream of a static LM program)."""
    if not a.is_cuda:
        return misc_add_plain(a, b, sa, sb, act, out_scale, out_dtype)
    for t, name in ((a, "a"), (b, "b")):
        if t.dtype not in (torch.int8, torch.float32):
            raise ValueError(f"{name}: expected int8 or float32, got "
                             f"{t.dtype}")
    require(a, "a", a.dtype)
    require(b, "b", b.dtype, a.shape)
    if out_scale is None and out_dtype != torch.float32:
        raise ValueError(f"misc_add kernel writes f32 or int8, "
                         f"not {out_dtype}")
    out = torch.empty(a.shape, device=a.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    err = _lib().misc_add(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
        int(a.dtype == torch.float32), int(b.dtype == torch.float32),
        _scalar(sa, "sa"), _scalar(sb, "sb"),
        _build.act_code(act), int(out_scale is not None),
        _scalar(out_scale, "out_scale") if out_scale is not None else 1.0,
        _build.stream_ptr(a))
    _build.check(err, "misc_add")
    _build.count("misc_add")
    return out


# ---------------------------------------------------------------------------
# avgpool2d (_avgpool_kernel)
# ---------------------------------------------------------------------------

def avgpool2d_plain(x, window: int, stride: int,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: ref.avgpool2d (tap-order f32 sum / k*k)."""
    return ref.avgpool2d(x, window, stride, out_dtype=out_dtype)


def avgpool2d(x: torch.Tensor, window: int, stride: int,
              out_dtype=torch.float32) -> torch.Tensor:
    """[N, H, W, C] VALID average pool, f32 out.  x int8 or f32."""
    if not x.is_cuda:
        return avgpool2d_plain(x, window, stride, out_dtype)
    if x.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"x: expected int8 or float32, got {x.dtype}")
    require(x, "x", x.dtype)
    if x.ndim != 4:
        raise ValueError(f"x: expected [N, H, W, C], got {tuple(x.shape)}")
    if out_dtype != torch.float32:
        raise ValueError(f"avgpool2d kernel writes f32, not {out_dtype}")
    n, h, w, c = x.shape
    if window < 1 or stride < 1 or window > min(h, w):
        raise ValueError(f"window {window}/{stride} does not fit {h}x{w}")
    ho = (h - window) // stride + 1
    wo = (w - window) // stride + 1
    out = torch.empty((n, ho, wo, c), device=x.device, dtype=torch.float32)
    err = _lib().misc_avgpool2d(
        x.data_ptr(), out.data_ptr(), n, h, w, c, window, stride, ho, wo,
        int(x.dtype == torch.float32), _build.stream_ptr(x))
    _build.check(err, "avgpool2d")
    _build.count("avgpool2d")
    return out
