"""Conv PE: int8 GEMM with a fused NL epilogue, on the H100.

Wrappers of the CUDA kernels in csrc/conv_pe.cu, each beside its plain
PyTorch version:

  * `matmul_int8_fused` -- replaces src/repro/kernels/conv_pe.py::
    matmul_int8_fused, kernel bodies `_kernel` (:37) and `_kernel_res`
    (:69): the 1x1 convolutions and the classifier head, the residual
    variant carrying every fused conv -> add.
  * `matmul_int8_pool` -- replaces `_kernel_pool` (:311): the GEMM whose
    static global-pool tail is reduced in the kernel, with or without the
    bottleneck's residual operand (`has_res`: ResNet's last block).
  * `matmul_int4_fused` -- replaces `matmul_int4_fused`, kernel bodies
    `_kernel_w4` (:189) and `_kernel_w4_res` (:208): int8 activations times
    packed int4 weights with per-group scale and zero (the w4a8 LM
    projections; the residual variant carries the O / down projection's
    residual add), bit for bit equal to its plain version, whose f32 fold
    runs the groups in order.  Kernels in csrc/conv_pe_w4.cu.
    `plan_w4(M, N, K, gs, ...)` picks per product the route -- weight
    streaming (4-row blocks of 16 or 32 columns over all of K, the groups
    of each chunk split among the block's threads and folded in order in
    shared memory) at M <= W4_STREAM_MAX_M or where the groups are not
    multiples of 32 K rows, int8 tensor-core tiles of 64 x 64 (each group
    folded in registers) otherwise -- with the strip and the chunk (the K
    split inside a block) read off scripts/conv_pe_probe.py --w4.  No plan
    splits K across blocks, so no f32 partial sum is ever handed on, and
    the epilogue runs in the kernel.
  * `matmul_f_fused` -- replaces `matmul_f_fused`, kernel body `_kernel_f`
    (:429): the float GEMM with f32 accumulation, bias and act, which
    runs every float projection of the training path (ops.linear_f on
    backend="cuda"), forward and backward, through the autograd Function
    `MatmulF`.  Kernels in csrc/conv_pe_f.cu: bf16 wgmma tiles fed by TMA,
    and an FFMA kernel for f32 operands.  `plan_f(M, N, K, ...)` picks per
    product the route (the tensor cores for bf16 operands TMA can describe,
    FFMA otherwise), the K split of the 128 x 128 tiles (`tc_splits`: as
    many slices as the SMs the tiles leave idle, read off
    scripts/conv_pe_probe.py --float) and whether a reduction pass runs
    the epilogue (`pass_`).  Each
    operand is taken contiguous or as the transposed view of a contiguous
    matrix (`transposed`), so the backward's b^T and a^T are never copied
    on the tensor-core route.  A split K, and the acts with a division or a
    libm call (silu, gelu, hardswish), leave f32 sums per slice in the
    stream's scratch, and a reduction adds them in slice order and runs the
    epilogue: no atomics, the same bits every run.

Bound on the H100 and the design's answer: see the notes at the top of
csrc/conv_pe.cu and csrc/conv_pe_f.cu.  `plan(M, N, K)` picks, per
product, the kernel of `matmul_int8_fused`: split-K weight streaming at M
<= 4 with >= 16 MiB of weights (bound by reading them once), int8
tensor-core tiles otherwise (128 x 128 / 64 / 32, split along K where the
tiles do not fill the SMs), with copy widths that never read past a row,
and the epilogue fused or as a pass of its own.  The TPU kernels' block
sizes and 128-padding are not carried over.

On a CUDA tensor each wrapper checks its operands and launches its kernel
or raises; on CPU tensors it runs the plain version (the CPU tests).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.quant import Scale, mul, qdq_codes
from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind_w4(lib: ctypes.CDLL) -> None:
    lib.conv_pe_w4.argtypes = [_V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _V, _F, _V, _I, _I, _V, _F,
                               _V, _I, _F, _I, _F, _I, _V]
    lib.conv_pe_w4.restype = _I


def _bind_f(lib: ctypes.CDLL) -> None:
    lib.conv_pe_f_gemm.argtypes = [_V, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                                   _V]
    lib.conv_pe_f_gemm.restype = _I
    lib.conv_pe_f_tc.argtypes = [_V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _V]
    lib.conv_pe_f_tc.restype = _I


def _bind(lib: ctypes.CDLL) -> None:
    lib.conv_pe_gemm.argtypes = [_V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _V, _V, _F, _V, _V, _I, _I, _V,
                                 _F, _V, _I, _F, _I, _F, _I, _V]
    lib.conv_pe_gemm.restype = _I
    lib.conv_pe_pool.argtypes = [_V, _V, _V, _I, _I, _I, _I, _F, _V, _V, _I,
                                 _F, _V, _F, _I, _F, _F, _I, _F, _V]
    lib.conv_pe_pool.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.library("conv_pe", _bind)


def _is_scalar(s) -> bool:
    return not isinstance(s, torch.Tensor) or s.numel() == 1


# ---------------------------------------------------------------------------
# matmul_int8_fused (_kernel / _kernel_res)
# ---------------------------------------------------------------------------

SMS = 132                 # the H100 SXM's streaming multiprocessors
STREAM_MAX_M = 4          # M up to this streams the weights (split K) ...
STREAM_MIN_KN = 16 << 20  # ... when they hold this many bytes
STREAM_BN = 128           # columns a stream block
STREAM_KG = 128           # K rows one pass of a stream block covers
STREAM_KS_MAX = 2048      # a stream block stages 4 x ks bytes of A
MMA_BM, MMA_BK = 128, 64  # tensor-core tile rows, K bytes a stage
MMA_KS_MIN = 256          # the shortest K slice a split tile walks


class Plan(NamedTuple):
    """One product's launch: `path` "stream" or "mma"; output tiles of bm x
    bn; `splits` K slices of `ks` rows (the last one may be short, none is
    empty); wa / wb the copy widths of A's and B's rows in bytes; `fused`:
    the kernel runs the epilogue itself, else its int32 sums go to a scratch
    and a second kernel runs it (always when K is split)."""
    path: str
    bm: int
    bn: int
    splits: int
    ks: int
    wa: int
    wb: int
    fused: bool


def _width(extent: int, align: int) -> int:
    """The widest copy (16 / 8 / 4 / 2 / 1 bytes) that divides a row of
    `extent` bytes and the base pointer's alignment."""
    for w in (16, 8, 4, 2, 1):
        if extent % w == 0 and align % w == 0:
            return w
    return 1


def _slices(k: int, want: int, granule: int):
    """(splits, ks): about `want` K slices of a multiple of `granule` rows,
    none empty."""
    splits = max(1, min(want, math.ceil(k / granule)))
    ks = math.ceil(math.ceil(k / splits) / granule) * granule
    return math.ceil(k / ks), ks


def stream_plan(m: int, n: int, k: int, wa: int, wb: int) -> Plan:
    """Split-K weight streaming: 4 rows x 128 columns a block, K split so
    that the grid covers the SMs about once, in slices of a multiple of 128
    rows up to 2048."""
    want = max(math.ceil(SMS / math.ceil(n / STREAM_BN)),
               math.ceil(k / STREAM_KS_MAX))
    splits, ks = _slices(k, want, STREAM_KG)
    return Plan("stream", STREAM_MAX_M, STREAM_BN, splits, ks, wa, wb,
                splits == 1)


def mma_plan(m: int, n: int, k: int, wa: int, wb: int) -> Plan:
    """Tensor-core tiles of 128 rows x 128 columns (64 for N <= 64, 32 for
    N <= 32), K steps of 64; K split (slices of at least MMA_KS_MIN,
    multiples of 64) only where the tiles fall under the SM count.  The
    epilogue runs in the kernel (fused) only on unsplit tiles narrower than
    128; the wide tiles' epilogue ran faster as a kernel of its own on
    every shape measured."""
    bn = 128 if n > 64 else 64 if n > 32 else 32
    tiles = math.ceil(m / MMA_BM) * math.ceil(n / bn)
    want = SMS // tiles if tiles < SMS else 1
    splits, ks = _slices(k, max(1, min(want, k // MMA_KS_MIN)), MMA_BK)
    return Plan("mma", MMA_BM, bn, splits, ks, wa, wb,
                splits == 1 and bn < 128)


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, a_align: int, b_align: int) -> Plan:
    """The launch of one M x K x N int8 product, given the operands' byte
    alignment (a pure function, cached: the served paths call it for every
    product and are bound by the host): `stream_plan` at M <=
    STREAM_MAX_M with K x N >= STREAM_MIN_KN bytes of weights, `mma_plan`
    otherwise, with the widest copies that divide the rows and the
    alignment.  (Measured on the H100 with scripts/conv_pe_probe.py: at
    M = 8 and 16 the tensor-core tiles won every LM projection shape; at
    M = 4 streaming won from 27.5 MB of weights up, the tiles at 13.8 MB
    and below.)"""
    if min(m, n, k) < 1:
        raise ValueError(f"conv_pe: empty product M={m} N={n} K={k}")
    wa, wb = _width(k, a_align), _width(n, b_align)
    if m <= STREAM_MAX_M and k * n >= STREAM_MIN_KN:
        return stream_plan(m, n, k, wa, wb)
    return mma_plan(m, n, k, wa, wb)


_SCRATCH: dict = {}       # (device, stream) -> scratch of 4-byte values


def _scratch(t: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """An int32 scratch of at least n values for a product on `stream` (the
    int8 GEMM's int32 sums, the float GEMM's f32 K-slice partials): one
    buffer per device and stream, grown and never shrunk (launches on one
    stream run in order, so a product's scratch is free once the next one
    starts; the largest on the served paths is ~19 MB).  It saves the
    host-bound paths an allocation a call."""
    key = (t.get_device(), stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.int32,
                                          device=t.device)
    return buf


def _vec(t: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """An f32 operand of n values ([n], [1, n] or [n, 1]) as the kernel reads
    it: checked in place when contiguous (no view is made on this
    host-bound path), else a contiguous copy."""
    if not (t.is_cuda and t.dtype == torch.float32 and t.numel() == n):
        raise ValueError(f"{name}: expected {n} float32 values on the card, "
                         f"got {t.dtype}{tuple(t.shape)} on {t.device}")
    return t if t.is_contiguous() else t.reshape(n)


def byte_align(t: torch.Tensor) -> int:
    """The alignment of t's first byte, up to 16 (what plan() takes)."""
    ptr_ = t.data_ptr()
    return 16 if ptr_ % 16 == 0 else ptr_ & -ptr_


def _residual_tail(x, out_scale, out_dtype, residual, res_scale, mid_scale,
                   add_act):
    """The residual epilogue after the GEMM's act: qdq at mid_scale, +
    residual * res_scale, add_act, requant."""
    if mid_scale is not None:
        x = mul(qdq_codes(x, mid_scale), mid_scale)
    x = x + mul(residual.to(torch.float32), res_scale)
    x = ref.act_fn(add_act)(x)
    if out_scale is not None:
        return qdq_codes(x, out_scale).to(torch.int8)
    return x.to(out_dtype)


def matmul_int8_fused_plain(a_q, b_q, a_scale: Scale, w_scale, bias=None,
                            act: str = "none", out_scale=None,
                            out_dtype=torch.float32, *, residual=None,
                            res_scale: float = 1.0,
                            mid_scale: Optional[float] = None,
                            add_act: str = "none") -> torch.Tensor:
    """The plain version: ref.matmul_int8_fused, and for the residual
    variant the same tail the kernel runs (qdq at mid_scale, + residual *
    res_scale, add_act, requant)."""
    if residual is None:
        return ref.matmul_int8_fused(a_q, b_q, a_scale, w_scale, bias, act,
                                     out_scale=out_scale, out_dtype=out_dtype)
    x = ref.matmul_int8_fused(a_q, b_q, a_scale, w_scale, bias, act)
    return _residual_tail(x, out_scale, out_dtype, residual, res_scale,
                          mid_scale, add_act)


def matmul_int8_fused(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: Scale,
                      w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: str = "none", out_scale=None,
                      out_dtype=torch.float32, *,
                      residual: Optional[torch.Tensor] = None,
                      res_scale: float = 1.0,
                      mid_scale: Optional[float] = None,
                      add_act: str = "none") -> torch.Tensor:
    """Fused int8 GEMM.  a_q int8 [M, K]; b_q int8 [K, N]; a_scale a
    Python float (static per-tensor) or f32 [M, 1]; w_scale f32 [1, N] /
    [N]; bias f32 [N] or None; act and add_act none / relu / relu6 /
    gelu (tanh: bit for bit torch's CUDA F.gelu(approximate="tanh"), the
    GeGLU gates and recurrentgemma's in_gate; it runs in the epilogue
    pass, so a plan that would fuse the epilogue runs the pass instead);
    out_scale None (f32 out), a Python float, or
    an [N]-sized vector (int8 out).  residual [M, N] (int8 with res_scale,
    or f32) selects the residual variant: qdq at mid_scale (static chains),
    + residual * res_scale, add_act, requant.  Runs `plan(M, N, K)`: one
    kernel when the plan is fused, else the product into the stream's int32
    scratch (zeroed first by a memset when K is split) and the epilogue
    pass; counted once either way, as one product."""
    if not a_q.is_cuda:
        return matmul_int8_fused_plain(
            a_q, b_q, a_scale, w_scale, bias, act, out_scale, out_dtype,
            residual=residual, res_scale=res_scale, mid_scale=mid_scale,
            add_act=add_act)
    m, k = a_q.shape
    n = b_q.shape[1]
    require(a_q, "a_q", torch.int8)
    require(b_q, "b_q", torch.int8, (k, n))
    asc = (_vec(a_scale, "a_scale", m) if isinstance(a_scale, torch.Tensor)
           else None)
    wsc = _vec(w_scale, "w_scale", n)
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    os_vec, os_val = None, 1.0
    if out_scale is not None:
        if _is_scalar(out_scale):
            os_val = float(out_scale)
        else:
            os_vec = _vec(out_scale, "out_scale", n)
    elif out_dtype != torch.float32:
        raise ValueError(f"conv_pe kernel writes f32 or int8, not {out_dtype}")
    if residual is not None:
        if residual.dtype not in (torch.int8, torch.float32):
            raise ValueError("residual must be int8 or f32")
        require(residual, "residual", residual.dtype, (m, n))
    out = torch.empty((m, n), device=a_q.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    p = plan(m, n, k, byte_align(a_q), byte_align(b_q))
    if "gelu" in (act, add_act):
        p = p._replace(fused=False)       # gelu runs in the epilogue pass
    stream = _build.stream_ptr(a_q)
    part = None if p.fused else _scratch(a_q, m * n, stream)
    err = _lib().conv_pe_gemm(
        a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), m, n, k,
        int(p.path == "mma"), p.bm, p.bn, p.splits, p.ks, p.wa, p.wb,
        int(p.fused), ptr(part), ptr(asc),
        float(a_scale) if asc is None else 0.0, wsc.data_ptr(), ptr(bias),
        _build.act_code(act, _build.GEMM_ACTS), int(out_scale is not None),
        ptr(os_vec), os_val, ptr(residual),
        int(residual is not None and residual.dtype == torch.float32),
        float(res_scale), int(mid_scale is not None),
        float(mid_scale) if mid_scale is not None else 1.0,
        _build.act_code(add_act, _build.GEMM_ACTS), stream)
    name = "conv_pe" if residual is None else "conv_pe_res"
    _build.check(err, name)
    _build.count(name)
    return out


# ---------------------------------------------------------------------------
# matmul_int8_pool (_kernel_pool): static global-pool tail
# ---------------------------------------------------------------------------

def gap_scale(pre_scale: float, rows: int) -> float:
    """The GAP tail's scale: the pre-pool edge scale / rows in double,
    rounded once to f32 where it is used (the reference's `cur / px`)."""
    return pre_scale / rows


def matmul_int8_pool_plain(a_q, b_q, a_scale: float, w_scale, bias,
                           act: str, *, mid_scale: float,
                           out_scale: Optional[float] = None,
                           residual: Optional[torch.Tensor] = None,
                           res_scale: float = 1.0, add_act: str = "none",
                           add_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: per-image GEMM rows -> epilogue -> codes at mid_scale
    [-> * mid_scale + residual * res_scale -> add_act -> codes at
    add_scale] -> int32 sum over the rows -> * (pre-pool scale / rows) ->
    requant."""
    g, rows, k = a_q.shape
    x = ref.matmul_int8_fused(a_q.reshape(g * rows, k), b_q, a_scale,
                              w_scale, bias, act)
    codes, pre = qdq_codes(x, mid_scale), mid_scale
    if residual is not None:
        r = mul(residual.reshape(g * rows, -1).to(torch.float32), res_scale)
        y = ref.act_fn(add_act)(mul(codes, mid_scale) + r)
        codes, pre = qdq_codes(y, add_scale), add_scale
    codes = codes.to(torch.int32).reshape(g, rows, -1)
    y = mul(codes.sum(dim=1, dtype=torch.int32).to(torch.float32),
            gap_scale(pre, rows))
    if out_scale is not None:
        return qdq_codes(y, out_scale).to(torch.int8)
    return y


def matmul_int8_pool(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: float,
                     w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                     act: str, *, mid_scale: float,
                     out_scale: Optional[float] = None,
                     residual: Optional[torch.Tensor] = None,
                     res_scale: float = 1.0, add_act: str = "none",
                     add_scale: Optional[float] = None) -> torch.Tensor:
    """Fused GEMM + static global-pool tail, one launch.

    a_q int8 [G, rows, K]: each image's ho*wo im2col rows; b_q int8 [K, N];
    a_scale the static per-tensor activation scale; mid_scale the absorbed
    conv edge's scale.  residual int8 [G, rows, N] (the shortcut, at
    res_scale) selects the residual variant, whose absorbed add edge is at
    add_scale.  Returns [G, N], int8 when out_scale is given.  The pre-pool
    [G, rows, N] map is never written."""
    if not a_q.is_cuda:
        return matmul_int8_pool_plain(
            a_q, b_q, a_scale, w_scale, bias, act, mid_scale=mid_scale,
            out_scale=out_scale, residual=residual, res_scale=res_scale,
            add_act=add_act, add_scale=add_scale)
    g, rows, k = a_q.shape
    n = b_q.shape[1]
    require(a_q, "a_q", torch.int8)
    require(b_q, "b_q", torch.int8, (k, n))
    wsc = require(w_scale.reshape(n), "w_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    pre = mid_scale
    if residual is not None:
        require(residual, "residual", torch.int8, (g, rows, n))
        if add_scale is None:
            raise ValueError("the residual pooled tail needs add_scale")
        pre = add_scale
    out = torch.empty((g, n), device=a_q.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    err = _lib().conv_pe_pool(
        a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), g, rows, n, k,
        float(a_scale), wsc.data_ptr(), ptr(bias), _build.act_code(act),
        float(mid_scale), ptr(residual), float(res_scale),
        _build.act_code(add_act), float(pre), gap_scale(pre, rows),
        int(out_scale is not None),
        float(out_scale) if out_scale is not None else 1.0,
        _build.stream_ptr(a_q))
    name = "conv_pe_pool" if residual is None else "conv_pe_pool_res"
    _build.check(err, name)
    _build.count(name)
    return out


# ---------------------------------------------------------------------------
# matmul_int4_fused (_kernel_w4 / _kernel_w4_res)
# ---------------------------------------------------------------------------

def matmul_int4_fused_plain(a_q, b_packed, a_scale: Scale, w_scale, w_zero,
                            bias=None, act: str = "none", out_scale=None,
                            out_dtype=torch.float32, *, residual=None,
                            res_scale: float = 1.0,
                            mid_scale: Optional[float] = None,
                            add_act: str = "none") -> torch.Tensor:
    """The plain version: ref.matmul_int4_fused (group-ordered f32
    combine), and for the residual variant the int8 GEMM's tail."""
    if residual is None:
        return ref.matmul_int4_fused(a_q, b_packed, a_scale, w_scale, w_zero,
                                     bias, act, out_scale=out_scale,
                                     out_dtype=out_dtype)
    x = ref.matmul_int4_fused(a_q, b_packed, a_scale, w_scale, w_zero, bias,
                              act)
    return _residual_tail(x, out_scale, out_dtype, residual, res_scale,
                          mid_scale, add_act)


W4_MAX_GROUP = 1024      # the kernels take group sizes up to 1024 K rows
# the planner's rules, read off scripts/conv_pe_probe.py --w4 on the H100
W4_STREAM_MAX_M = 16     # M up to this streams the weights; tiles above
W4_BNS = (32, 16)        # stream strips: columns a block
W4_GC = 64               # a stream chunk: groups at most ...
W4_CHUNK = 26 << 10      # ... and bytes of packed weights
W4_TILE = (64, 64)       # the tensor-core tile, rows x columns (masked)


class PlanW4(NamedTuple):
    """One int4 product's launch: `route` "stream" (4-row blocks of `bn`
    columns over all of K, in chunks of `gc` groups, each chunk's groups
    split among the block's threads in sub-tasks of two quads of 4 k: the
    K split) or "mma" (bm x bn tensor-core tiles, each group folded in
    registers; gc = 0); wa / wb the copy widths of A's and the packed B's
    rows in bytes.  K is never split across blocks, and the epilogue always
    runs in the kernel that folds the groups (csrc/conv_pe_w4.cu)."""
    route: str
    bm: int
    bn: int
    gc: int
    wa: int
    wb: int


def stream_plan_w4(m: int, n: int, k: int, gs: int, wa: int, wb: int,
                   bn: Optional[int] = None) -> PlanW4:
    """Weight streaming: 4 rows a block; `bn` columns (by default 32 where
    that puts SMS blocks on the card, else 16: the narrow strips fill the
    SMs at N = 1536 / 2304); chunks of up to W4_GC groups and W4_CHUNK
    bytes of packed weights (each group's gs / 2 rows of bn bytes and its
    padding, csrc/conv_pe_w4.cu w_group), evened out over the chunks K
    takes."""
    if bn is None:
        bn = 32 if math.ceil(n / 32) * math.ceil(m / 4) >= SMS else 16
    ct = bn // 16                               # column threads a block
    g = k // gs
    gc = max(1, min(g, W4_GC, W4_CHUNK // (gs // 2 * bn + 16 * ct)))
    gc = math.ceil(g / math.ceil(g / gc))       # chunks of even size
    return PlanW4("stream", 4, bn, gc, wa, wb)


def mma_plan_w4(m: int, n: int, k: int, gs: int, wa: int,
                wb: int) -> PlanW4:
    """Tensor-core tiles of W4_TILE (gs a multiple of 32)."""
    return PlanW4("mma", *W4_TILE, 0, wa, wb)


@functools.lru_cache(maxsize=4096)
def plan_w4(m: int, n: int, k: int, gs: int, a_align: int,
            b_align: int) -> PlanW4:
    """The launch of one M x K x N int4 product of group size gs, given the
    operands' byte alignment (pure and cached, as `plan`): `stream_plan_w4`
    at M <= W4_STREAM_MAX_M or where the tensor cores cannot take the groups
    (gs not a multiple of 32), `mma_plan_w4` otherwise."""
    if min(m, n, k) < 1 or k % gs:
        raise ValueError(f"conv_pe_w4: M={m} N={n} K={k} in groups of {gs}")
    wa, wb = _width(k, a_align), _width(n, b_align)
    if m <= W4_STREAM_MAX_M or gs % 32:
        return stream_plan_w4(m, n, k, gs, wa, wb)
    return mma_plan_w4(m, n, k, gs, wa, wb)


def matmul_int4_fused(a_q: torch.Tensor, b_packed: torch.Tensor,
                      a_scale: Scale, w_scale: torch.Tensor,
                      w_zero: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: str = "none", out_scale=None,
                      out_dtype=torch.float32, *,
                      residual: Optional[torch.Tensor] = None,
                      res_scale: float = 1.0,
                      mid_scale: Optional[float] = None,
                      add_act: str = "none") -> torch.Tensor:
    """Fused int4 weight-only GEMM.  a_q int8 [M, K]; b_packed uint8
    [K//2, N]; w_scale / w_zero f16 [G, N] (K = G * gs, gs a multiple of 4
    up to 1024); a_scale a Python float (static) or f32 [M, 1]; bias f32
    [N] or None; out_scale None (f32 out), a Python float or an [N]-sized
    vector (int8 out).  residual [M, N] (int8 with res_scale, or f32)
    selects the residual variant.  M and N are any size (masked).  Runs
    `plan_w4(M, N, K, gs)`: one launch, counted once."""
    if not a_q.is_cuda:
        return matmul_int4_fused_plain(
            a_q, b_packed, a_scale, w_scale, w_zero, bias, act, out_scale,
            out_dtype, residual=residual, res_scale=res_scale,
            mid_scale=mid_scale, add_act=add_act)
    m, k = a_q.shape
    k2, n = b_packed.shape
    g = w_scale.shape[0]
    if k != 2 * k2 or k % g or (k // g) % 4 or k // g > W4_MAX_GROUP:
        raise ValueError(f"conv_pe_w4: K={k}, packed rows {k2}, {g} groups: "
                         f"want K = 2 * rows and a group size that is a "
                         f"multiple of 4 up to {W4_MAX_GROUP}")
    require(a_q, "a_q", torch.int8)
    if a_q.data_ptr() % 4:
        raise ValueError("a_q: expected a 4-byte aligned tensor")
    require(b_packed, "b_packed", torch.uint8)
    require(w_scale, "w_scale", torch.float16, (g, n))
    require(w_zero, "w_zero", torch.float16, (g, n))
    asc = None
    if isinstance(a_scale, torch.Tensor):
        asc = require(a_scale.reshape(m), "a_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    os_vec, os_val = None, 1.0
    if out_scale is not None:
        if _is_scalar(out_scale):
            os_val = float(out_scale)
        else:
            os_vec = require(out_scale.reshape(n), "out_scale", torch.float32)
    elif out_dtype != torch.float32:
        raise ValueError(f"conv_pe_w4 writes f32 or int8, not {out_dtype}")
    if residual is not None:
        if residual.dtype not in (torch.int8, torch.float32):
            raise ValueError("residual must be int8 or f32")
        require(residual, "residual", residual.dtype, (m, n))
    out = torch.empty((m, n), device=a_q.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    gs = k // g
    p = plan_w4(m, n, k, gs, byte_align(a_q), byte_align(b_packed))
    err = _build.library("conv_pe_w4", _bind_w4).conv_pe_w4(
        a_q.data_ptr(), b_packed.data_ptr(), w_scale.data_ptr(),
        w_zero.data_ptr(), out.data_ptr(), m, n, k, gs,
        int(p.route == "mma"), p.bm, p.bn, p.gc, p.wa, p.wb,
        ptr(asc), float(a_scale) if asc is None else 0.0, ptr(bias),
        _build.act_code(act), int(out_scale is not None), ptr(os_vec),
        os_val, ptr(residual),
        int(residual is not None and residual.dtype == torch.float32),
        float(res_scale), int(mid_scale is not None),
        float(mid_scale) if mid_scale is not None else 1.0,
        _build.act_code(add_act), _build.stream_ptr(a_q))
    name = "conv_pe_w4" if residual is None else "conv_pe_w4_res"
    _build.check(err, name)
    _build.count(name)
    return out


# ---------------------------------------------------------------------------
# matmul_f_fused (_kernel_f): the float GEMM of the training path
# ---------------------------------------------------------------------------

F_DTYPES = (torch.float32, torch.bfloat16)
TC_BM, TC_BN, TC_BK = 128, 128, 64   # tensor-core tile, K a stage (bf16)
# the split rule, read off scripts/conv_pe_probe.py --float on the H100:
# K is split only where the tiles leave SMs idle, into as many slices as
# the idle SMs take, each slice at least TC_MIN_STEPS 64-deep steps
TC_MIN_STEPS = 4
TC_MAX_SPLITS = 32
# the acts the tiles apply in their own epilogue (conv_pe_f.cu act_in_tc:
# no division, no libm call); the others run in the reduction pass
TC_TILE_ACTS = ("none", "relu", "relu6", "relu2")
# the float products of a full-width qwen2-1.5b training step at batch 8 x
# seq 128, the shapes the split rule is read from: (group, M, N, K, A read
# M-major (a^T), B read N-major (not b^T), bias, act, bf16 output, calls a
# step).  scripts/conv_pe_probe.py --float times them; chip_smoke.py
# captures the same products from the step itself.
STEP_F_GROUPS = (
    ("fwd K/V", 1024, 256, 1536, False, True, True, "none", True, 56),
    ("fwd Q", 1024, 1536, 1536, False, True, True, "none", True, 28),
    ("fwd O", 1024, 1536, 1536, False, True, False, "none", True, 28),
    ("fwd up", 1024, 8960, 1536, False, True, False, "none", True, 28),
    ("fwd gate", 1024, 8960, 1536, False, True, False, "silu", True, 28),
    ("fwd down", 1024, 1536, 8960, False, True, False, "none", True, 28),
    ("gate recompute", 1024, 8960, 1536, False, True, False, "none", False,
     28),
    ("da K/V", 1024, 1536, 256, False, False, False, "none", True, 56),
    ("da Q/O", 1024, 1536, 1536, False, False, False, "none", True, 56),
    ("da gate/up", 1024, 1536, 8960, False, False, False, "none", True, 56),
    ("da down", 1024, 8960, 1536, False, False, False, "none", True, 28),
    ("db K/V", 1536, 256, 1024, True, True, False, "none", True, 56),
    ("db Q/O", 1536, 1536, 1024, True, True, False, "none", True, 56),
    ("db gate/up", 1536, 8960, 1024, True, True, False, "none", True, 56),
    ("db down", 8960, 1536, 1024, True, True, False, "none", True, 28),
)


class PlanF(NamedTuple):
    """One float product's launch: `route` "wgmma" (bf16 tensor-core tiles
    of 128 x 128 fed by TMA) or "ffma" (the CUDA-core kernel); K in
    `splits` slices of `kps` 64-deep steps (the last may be short, none is
    empty); `a_mn` / `b_mn`: the operand is read M- / N-major; `pass_`: the
    tiles leave f32 sums per slice in the scratch and a reduction pass adds
    them and runs bias, act and cast (a split K, or an act not in
    TC_TILE_ACTS), else the tiles run the epilogue themselves."""
    route: str
    splits: int
    kps: int
    a_mn: bool
    b_mn: bool
    pass_: bool


def tc_splits(m: int, n: int, nk: int) -> int:
    """The split rule: as many K slices as the idle SMs take (tiles x
    splits up to SMS), each at least TC_MIN_STEPS steps; 1 where the tiles
    fill more than half the SMs."""
    tiles = math.ceil(m / TC_BM) * math.ceil(n / TC_BN)
    return max(1, min(SMS // tiles, nk // TC_MIN_STEPS, TC_MAX_SPLITS))


@functools.lru_cache(maxsize=4096)
def plan_f(m: int, n: int, k: int, bf16: bool, a_mn: bool, b_mn: bool,
           aligned: bool, act: str = "none") -> PlanF:
    """The launch of one M x K x N float product (pure, cached: the training
    step plans 616 products).  bf16 operands go to the tensor cores when TMA
    can describe them: both bases 16-byte aligned (`aligned`) and each
    operand's row stride (A: K, or M when read M-major; B: N, or K when read
    K-major) a multiple of 16 bytes; and N a multiple of 8, for the
    epilogue's 8- and 16-byte stores.  K is split by `tc_splits`.  f32
    operands, and bf16 ones the tiles cannot take, go to the FFMA kernel,
    which reads contiguous row-major operands (the wrapper copies a
    transposed view first)."""
    if min(m, n, k) < 1:
        raise ValueError(f"conv_pe_f: empty product M={m} N={n} K={k}")
    rows = ((m if a_mn else k), (n if b_mn else k), n)
    if not (bf16 and aligned and all(r % 8 == 0 for r in rows)):
        return PlanF("ffma", 1, 0, False, True, False)
    nk = math.ceil(k / TC_BK)
    kps = math.ceil(nk / tc_splits(m, n, nk))
    splits = math.ceil(nk / kps)            # no empty slice
    return PlanF("wgmma", splits, kps, a_mn, b_mn,
                 splits > 1 or act not in TC_TILE_ACTS)


def plan_of(a: torch.Tensor, b: torch.Tensor, act: str = "none") -> PlanF:
    """plan_f of the product act(a @ b) as the wrapper launches it: from
    the operands' type, layouts (`transposed`) and base alignment."""
    m, k = a.shape
    return plan_f(m, b.shape[1], k, a.dtype == torch.bfloat16,
                  transposed(a, "a"), not transposed(b, "b"),
                  byte_align(a) == 16 and byte_align(b) == 16, act)


def transposed(t: torch.Tensor, name: str) -> bool:
    """A float GEMM operand's layout: False for a contiguous (row-major)
    matrix, True for the transposed view of one (t.t() contiguous; a
    matrix that is both, with a dimension of 1, counts as row-major);
    ValueError for any other strides."""
    if t.is_contiguous():
        return False
    if t.t().is_contiguous():
        return True
    raise ValueError(f"{name}: expected a contiguous matrix or the "
                     f"transposed view of one, got strides {t.stride()}")


def matmul_f_fused_plain(a: torch.Tensor, b: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         act: str = "none",
                         out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: ref.matmul_f_fused (f32 product, + bias, act in
    f32, cast)."""
    return ref.matmul_f_fused(a, b, bias, act, out_dtype)


def _gemm_f(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            act: str, out_dtype) -> torch.Tensor:
    """One product: the kernel `plan_of` picks on CUDA tensors (counted once
    as conv_pe_f, whatever it launches), the plain version on CPU tensors.
    a [M, K] and b [K, N] are each contiguous or the transposed view of a
    contiguous matrix (`transposed`)."""
    if not a.is_cuda:
        return matmul_f_fused_plain(a, b, bias, act, out_dtype)
    if a.dtype not in F_DTYPES or out_dtype not in F_DTYPES:
        raise ValueError(f"conv_pe_f takes f32 / bf16 operands and output, "
                         f"got {a.dtype} -> {out_dtype}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"conv_pe_f: expected 2-D a / b, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"conv_pe_f: empty product {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if not b.is_cuda or b.dtype != a.dtype or b.shape[0] != k:
        raise ValueError(f"b: expected {a.dtype} ({k}, {n}) on the card, "
                         f"got {b.dtype}{tuple(b.shape)} on {b.device}")
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    p = plan_of(a, b, act)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.library("conv_pe_f", _bind_f)
    stream = _build.stream_ptr(a)
    if p.route == "ffma":
        # the copies of transposed views stay referenced until the launch
        # is enqueued: a freed copy's block could go to the other's copy
        a_c, b_c = a.contiguous(), b.contiguous()
        err = lib.conv_pe_f_gemm(
            a_c.data_ptr(), b_c.data_ptr(), ptr(bias), out.data_ptr(), m, n,
            k, _build.f_act_code(act), int(a.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    else:
        # f32 sums per K slice for the reduction pass, if the plan has one
        part = _scratch(a, p.splits * m * n, stream) if p.pass_ else None
        err = lib.conv_pe_f_tc(
            a.data_ptr(), b.data_ptr(), ptr(bias), out.data_ptr(), ptr(part),
            m, n, k, int(p.a_mn), int(p.b_mn), p.splits, p.kps,
            _build.f_act_code(act),
            int(out_dtype == torch.bfloat16), stream)
    _build.check(err, "conv_pe_f")
    _build.count("conv_pe_f")
    return out


class MatmulF(torch.autograd.Function):
    """act(a @ b + bias) with its gradient, every product on `_gemm_f`.

    The reference trains through `jnp.dot` (its Pallas `_kernel_f` has no
    backward), so the gradient is the same three products:
      * act != "none": the pre-activation z = a @ b + bias is recomputed
        in f32 (one more launch; the saved tensors stay the forward's
        operands), and dz = dy * act'(z) by torch's own derivative of
        ref.act_fn, in f32, cast to a's dtype;
      * da = dz @ b^T and db = a^T @ dz, each one launch on b.t() and
        a.t() as views (the tensor-core route reads them in place; the
        FFMA route copies them), in a's / b's dtype;
      * dbias = the f32 column sum of dz.
    """

    @staticmethod
    def forward(ctx, a, b, bias, act, out_dtype):
        ctx.save_for_backward(a, b, bias)
        ctx.act = act
        return _gemm_f(a, b, bias, act, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        a, b, bias = ctx.saved_tensors
        if ctx.act == "none":
            dz32 = dy.to(torch.float32)
        else:
            z = _gemm_f(a, b, bias, "none", torch.float32)
            with torch.enable_grad():
                z.requires_grad_(True)
                y = ref.act_fn(ctx.act)(z)
                (dz32,) = torch.autograd.grad(y, z, dy.to(torch.float32))
        dz = dz32.to(a.dtype).contiguous()
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = _gemm_f(dz, b.t(), None, "none", a.dtype)
        if ctx.needs_input_grad[1]:
            db = _gemm_f(a.t(), dz, None, "none", b.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = dz32.sum(dim=0).to(bias.dtype)
        return da, db, dbias, None, None


def matmul_f_fused(a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, act: str = "none",
                   out_dtype=torch.float32) -> torch.Tensor:
    """Fused float GEMM.  a [M, K] and b [K, N] both f32 or both bf16, each
    contiguous or the transposed view of a contiguous matrix; bias f32 [N]
    or None; act any of ref.act_fn's; out_dtype
    f32 or bf16.  Returns act(a @ b + bias) in out_dtype, differentiable
    (MatmulF).  On CUDA tensors every product launches the kernel (one
    forward; a recompute when act != "none" and two products in the
    backward); on CPU tensors the plain version runs in their place."""
    if a.dtype != b.dtype:
        raise ValueError(f"conv_pe_f: a is {a.dtype}, b is {b.dtype}")
    return MatmulF.apply(a, b, bias, act, out_dtype)
