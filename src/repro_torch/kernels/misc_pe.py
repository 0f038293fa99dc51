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
csrc/misc_pe.cu (one bytes-bound pass: 16-byte words of each operand, the
pool's window taps loaded before their adds).  `plan_add` and
`plan_avgpool` (pure Python) pick each launch: the add's route (16-byte
words where a, b and out start on 16 bytes, else one element a thread),
the pool's channels a thread, window instantiation and block size.  On a
CUDA tensor each wrapper checks its operands and launches its kernel or
raises; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import require
from repro_torch.kernels.conv_pe import byte_align

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.misc_add.argtypes = [_V, _V, _V, ctypes.c_longlong, _I, _I, _F, _F,
                             _I, _I, _F, _I, _I, _V]
    lib.misc_add.restype = _I
    lib.misc_avgpool2d.argtypes = [_V, _V] + [_I] * 13 + [_V]
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

SMS = 132                  # the H100's SMs
ADD_THREADS = 256          # threads a block, both routes (csrc THREADS)
# the vector grid fills the card once: 1024 threads an SM
# (scripts/cnn_probe.py --misc times caps of 1 to 8 and none; 4 was within
# 5% of the best at every set of adds)
ADD_BLOCKS_A_SM = 4
SCALAR_MAX_BLOCKS = SMS * 16   # the scalar route's grid-stride cap
# the output scales the vector route requantizes at (csrc/epilogue.cuh
# qdq_biased_exact: bitwise the IEEE division in this range)
VEC_SCALES = (2.0 ** -100, 2.0 ** 100)


class PlanAdd(NamedTuple):
    route: str             # "vec": whole 16-byte words; "scalar": bytes
    vec: int               # elements a group (a word of the widest operand)
    blocks: int            # blocks of ADD_THREADS
    steps: int             # grid-stride steps that cover n


@functools.lru_cache(maxsize=1024)
def plan_add(n: int, a_f32: bool, b_f32: bool, out_scale: Optional[float],
             aligned: int) -> PlanAdd:
    """The launch of misc_add over n elements (out_scale None: an f32 out);
    `aligned`: the byte alignment (up to 16) of a's, b's and out's first
    elements, the least of the three.  The vector route takes all three on
    16 bytes and an out_scale in VEC_SCALES (or none): groups of 16
    elements when both operands are int8 codes, else 4 (a float4 of f32, a
    32-bit word of codes), one group a thread a grid step, a grid that
    covers the groups once and fills the card at most once
    (ADD_BLOCKS_A_SM blocks an SM; a grid-stride loop takes the rest).
    Any other alignment or scale takes the scalar route, one element a
    thread."""
    lo, hi = VEC_SCALES
    if aligned >= 16 and (out_scale is None or lo <= out_scale <= hi):
        return add_launch(n, 4 if a_f32 or b_f32 else 16, ADD_BLOCKS_A_SM)
    return add_launch(n, 1)


def add_launch(n: int, vec: int, blocks_a_sm: int = 0) -> PlanAdd:
    """The plan at `vec` elements a group (1: the scalar route) over n
    elements, the vector grid capped at `blocks_a_sm` blocks an SM (0: no
    cap): what a probe or a test forces."""
    groups = n // vec
    blocks = max(1, -(-groups // ADD_THREADS))
    if vec == 1:
        blocks = min(blocks, SCALAR_MAX_BLOCKS)
    elif blocks_a_sm:
        blocks = min(blocks, SMS * blocks_a_sm)
    steps = -(-groups // (blocks * ADD_THREADS))
    return PlanAdd("scalar" if vec == 1 else "vec", vec, blocks, steps)


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
    a_f32, b_f32 = a.dtype == torch.float32, b.dtype == torch.float32
    os = _scalar(out_scale, "out_scale") if out_scale is not None else None
    p = plan_add(a.numel(), a_f32, b_f32, os,
                 min(byte_align(a), byte_align(b), byte_align(out)))
    err = _lib().misc_add(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
        int(a_f32), int(b_f32), _scalar(sa, "sa"), _scalar(sb, "sb"),
        _build.act_code(act), int(os is not None), 1.0 if os is None else os,
        p.vec, p.blocks, _build.stream_ptr(a))
    _build.check(err, "misc_add")
    _build.count("misc_add")
    return out


# ---------------------------------------------------------------------------
# avgpool2d (_avgpool_kernel)
# ---------------------------------------------------------------------------

POOL_KS = (2, 3, 5, 7)        # windows with their own instantiation
POOL_BLOCKS = (256, 128, 64)  # block sizes, largest first
POOL_MIN_BLOCKS = SMS         # a block an SM, where a block size allows


class PlanAvgpool(NamedTuple):
    lanes: int             # channels a thread: 4 (one float4 / one 32-bit
                           # word of codes) or 1
    kt: int                # the window's instantiation: k, or 0 (run time)
    block: int             # threads a block
    blocks: int            # blocks in the grid


@functools.lru_cache(maxsize=1024)
def plan_avgpool(n: int, h: int, w: int, c: int, k: int, stride: int,
                 aligned: int, in_f32: bool) -> PlanAvgpool:
    """The launch of avgpool2d over x [n, h, w, c], k x k / stride;
    `aligned`: the byte alignment (up to 16) of x's first element.  Four
    channels a thread where C % 4 == 0, x starts on 16 bytes (f32) or 4
    (int8 codes) and the four-channel grid still has a block of the
    smallest size an SM; else one.  The window's own instantiation for k
    in POOL_KS, the run-time one otherwise; the largest block of
    POOL_BLOCKS whose grid has POOL_MIN_BLOCKS blocks, else the
    smallest."""
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    outputs = n * ho * wo * c
    lanes = 1
    if (c % 4 == 0 and aligned >= (16 if in_f32 else 4)
            and outputs // 4 >= POOL_MIN_BLOCKS * POOL_BLOCKS[-1]):
        lanes = 4
    return pool_launch(outputs, lanes, k)


def pool_launch(outputs: int, lanes: int, k: int,
                block: Optional[int] = None) -> PlanAvgpool:
    """The plan at `lanes` channels a thread (and `block` threads a block,
    else the planned size) over `outputs` output elements: what a probe or
    a test forces."""
    threads = outputs // lanes
    if block is None:
        block = next((b for b in POOL_BLOCKS
                      if -(-threads // b) >= POOL_MIN_BLOCKS),
                     POOL_BLOCKS[-1])
    return PlanAvgpool(lanes, k if k in POOL_KS else 0, block,
                       max(1, -(-threads // block)))


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
    if n * ho * wo * c >= 2 ** 31:
        raise ValueError(f"avgpool2d kernel: {n * ho * wo * c} outputs, "
                         f"past its 2^31 - 1")
    in_f32 = x.dtype == torch.float32
    p = plan_avgpool(n, h, w, c, window, stride, byte_align(x), in_f32)
    out = torch.empty((n, ho, wo, c), device=x.device, dtype=torch.float32)
    err = _lib().misc_avgpool2d(
        x.data_ptr(), out.data_ptr(), n, h, w, c, window, stride, ho, wo,
        int(in_f32), p.lanes, p.kt, p.block, p.blocks, _build.stream_ptr(x))
    _build.check(err, "avgpool2d")
    _build.count("avgpool2d")
    return out
