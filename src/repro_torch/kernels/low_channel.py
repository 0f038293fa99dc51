"""Low-Channel Conv Unit: the first-layer conv, on the H100.

`low_channel_conv` wraps the CUDA kernel in csrc/low_channel.cu and
replaces src/repro/kernels/low_channel.py::low_channel_conv, kernel body
`_kernel` (:33): the plain stem, and the stem with its fused max-pool tail
(ResNet's 7x7/2 conv -> 3x3/2 max pool).  One templated kernel serves
both: an implicit GEMM on the int8 tensor cores (M = conv positions, N =
output channels, K = k*k*IC padded to a multiple of 32), the im2col tile
built in shared memory from a staged input window, and with the max tail
the conv tile under each pooled tile kept in shared memory (int8 codes in
a static chain), so the pre-pool map is never written.  Bound on the H100
and the design's answer: see the note at the top of csrc/low_channel.cu.

`plan` picks the block's work (positions or pooled tile, channels); the
kernel's launcher lays out and counts its shared memory (`layout_of`).

The plain version is ref.low_channel_conv (+ the _epilogue chain for a
pool tail), with ref.py's scale order (acc * a_scale * w_scale); the
Pallas kernel multiplies a_scale * w_scale first, which can move one int8
code.  The kernel follows ref.py.  The avg and global tails have no kernel
(no zoo model reaches them) and raise on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, _epilogue, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SMS = 132                        # the H100 SXM's SMs
MAX_K = 256                      # K = k*k*IC (the kernel's limit)
MAX_OCB = 64                     # output channels a block
POSITIONS = (256, 128)           # no tail: positions a block, largest first
MAX_TILE_POS = 256               # max tail: conv positions under a tile,
                                 # two m16 tiles for each of the 8 warps


class StemPlan(NamedTuple):
    ocb: int          # output channels a block (a multiple of 8)
    tile_h: int       # max tail: pooled rows a block (1 without a tail)
    tile_w: int       # max tail: pooled columns; else positions a block


def _max_tile(pho: int, pwo: int, pk: int, ps: int):
    """The pooled tile whose conv tile (halo included) fills at most
    MAX_TILE_POS positions -- two m16 tiles a warp -- with the fewest conv
    positions per pooled output (ties: the wider tile)."""
    best = None
    for th in range(1, pho + 1):
        for tw in range(1, pwo + 1):
            npos = ((th - 1) * ps + pk) * ((tw - 1) * ps + pk)
            if npos > MAX_TILE_POS:
                break
            key = (npos / (th * tw), -tw)
            if best is None or key < best[0]:
                best = (key, th, tw)
    return (1, 1) if best is None else best[1:]


@functools.lru_cache(maxsize=None)
def plan(n: int, hp: int, wp: int, ic: int, oc: int, k: int, stride: int,
         pool_kernel: int = 0, pool_stride: int = 0) -> StemPlan:
    """The launch plan of one stem call: channels a block, and the block's
    positions (no tail: the largest of POSITIONS that still gives SMS
    blocks) or pooled tile (`_max_tile`).  Raises ValueError for a shape
    the kernel does not take."""
    if k * k * ic > MAX_K:
        raise ValueError(f"low-channel K = {k}x{k}x{ic} exceeds the "
                         f"kernel's {MAX_K}")
    if k * ic < 3:
        raise ValueError(f"low-channel kernel needs k * IC >= 3, got {k}x{ic}")
    if k > min(hp, wp):
        raise ValueError(f"{k}x{k} filter on a {hp}x{wp} input")
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    ocb = min(MAX_OCB, -(-oc // 8) * 8)
    oc_blocks = -(-oc // ocb)
    if pool_kernel > 0:
        if pool_stride < 1 or pool_kernel > min(ho, wo):
            raise ValueError(f"max tail {pool_kernel}/{pool_stride} does "
                             f"not fit a {ho}x{wo} map")
        pho = (ho - pool_kernel) // pool_stride + 1
        pwo = (wo - pool_kernel) // pool_stride + 1
        th, tw = _max_tile(pho, pwo, pool_kernel, pool_stride)
    else:
        th = 1
        tw = next((bp for bp in POSITIONS
                   if n * oc_blocks * -(-ho * wo // bp) >= SMS),
                  POSITIONS[-1])
    return StemPlan(ocb, th, tw)


def _bind(lib: ctypes.CDLL) -> None:
    lib.low_channel_conv.argtypes = ([_V, _V, _V, _V, _F, _V] + [_I] * 9
                                     + [_F] + [_I] * 5 + [_V])
    lib.low_channel_conv.restype = _I


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
    if pool not in ("none", "max"):
        raise NotImplementedError(
            f"the Low-Channel {pool!r} pool tail has no CUDA kernel "
            "(no zoo model reaches it); run backend='ref'")
    n, hp, wp, ic = x.shape
    k, oc = w.shape[0], w.shape[3]
    require(x, "x", torch.int8)
    require(w, "w", torch.int8, (k, k, ic, oc))
    if bias is not None:
        require(bias, "bias", torch.float32, (oc,))
    wsc = require(w_scale.reshape(oc), "w_scale", torch.float32)
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    if pool == "max":
        if pool_kernel < 1 or pool_stride < 1:
            raise ValueError(f"max tail {pool_kernel}/{pool_stride}")
        pk, ps, scale, name = pool_kernel, pool_stride, mid_scale, \
            "low_channel_max"
    else:
        if out_scale is None and out_dtype != torch.float32:
            raise ValueError(f"low-channel kernel writes f32 or int8, "
                             f"not {out_dtype}")
        pk, ps, scale, name = 0, 0, out_scale, "low_channel"
    p = plan(n, hp, wp, ic, oc, k, stride, pk, ps)
    if pk:
        ho, wo = (ho - pk) // ps + 1, (wo - pk) // ps + 1
    out = torch.empty((n, ho, wo, oc), device=x.device,
                      dtype=torch.int8 if scale is not None
                      else torch.float32)
    err = _lib().low_channel_conv(
        x.data_ptr(), w.data_ptr(), ptr(bias), wsc.data_ptr(),
        float(a_scale), out.data_ptr(), n, hp, wp, ic, oc, k, stride,
        _build.act_code(act), int(scale is not None),
        float(scale) if scale is not None else 1.0, pk, ps, p.tile_h,
        p.tile_w, p.ocb, _build.stream_ptr(x))
    _build.check(err, name)
    _build.count(name)
    return out
