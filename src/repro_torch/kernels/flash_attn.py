"""Flash attention and the paged KV gather on the H100.

Wrappers of the CUDA kernels in csrc/flash_attn.cu and csrc/paged_gather.cu,
each beside its plain PyTorch version:

  * `flash_attention` -- replaces src/repro/kernels/flash_attn.py::
    flash_attention, kernel body `_kernel` (:29): online-softmax attention
    over q [B, Hq, L, D] and k / v [B, Hkv, S, D] with the end-aligned
    causal mask and the optional logit softcap.  The compiled prefill
    runs it on every global-layer AttnOp on the CUDA backend.  GQA is by
    head index inside the kernel (no repeated k / v); L and S are any
    lengths (ragged tiles are masked, nothing is padded).
  * `paged_gather` / `paged_gather_kv` -- replace src/repro/kernels/
    flash_attn.py::paged_gather, kernel body `_gather_kernel` (:110): the
    block-table gather through which paged decode reads its KV pool, a
    pure copy of pool pages [N, P, ...] into the slot-ordered view [B,
    M*P, ...].  `paged_gather_kv` gathers a layer's k and v pools in one
    launch (what decode calls); `paged_gather` one pool, on the same
    kernel.

Bounds on the H100 and the designs' answers: see the notes at the top of
the two CUDA sources.  `plan(b, hq, hkv, l, s, d)` picks the attention
kernel's block: the query rows it holds (of one KV group's heads) and its
threads, and computes its shared memory.  The attention kernel agrees
with its plain version here (`ref.attention`, one softmax over all keys)
to f32 rounding, and it keeps the op order of the plain chunked prefill
attention that the ref backend runs (models/layers.py::flash_attention),
so that the int8 edge after it, and the served ids, do not move between
the backends.

On a CUDA tensor a wrapper checks its operands and launches its kernel or
raises; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import require

HEAD_DIMS = (32, 128, 256)
# most keys per softmax chunk, for this kernel and for the plain chunked
# prefill attention (models/layers.py::flash_attention) alike
KV_CHUNK = 1024


def kv_chunk(s: int) -> int:
    """Keys per softmax chunk at S keys: min(1024, S rounded up to 128).
    The one rule for both backends' prefill attention, which keep one op
    order on the same chunks."""
    return min(KV_CHUNK, -(-s // 128) * 128)


SMS = 132                  # the H100 SXM's streaming multiprocessors
SMEM_MAX = 232448          # a block's shared memory on the H100
# the kernel's blocks (rows a block, threads), most rows first; a block's
# rows are flat rows pos * G + g of one KV group's G query heads
FLASH_BLOCKS = ((32, 256), (16, 128), (8, 64))
FLASH_STAGES = 3           # slots of the K / V ring (csrc STAGES)
# a grid of at least this many blocks counts as filling the SMs: at
# gemma2's prefill 16 rows a block (128 blocks, 4 SMs idle) beat 8 rows
# (256 blocks), and at qwen2's 32 rows (96 blocks) lost to 16 (192)
# (scripts/attn_probe.py)
FLASH_MIN_BLOCKS = SMS * 7 // 8


class PlanFlash(NamedTuple):
    rows: int              # flat query rows a block
    threads: int
    chunk: int             # keys a softmax chunk (kv_chunk(S))
    blocks: int            # the grid: B x Hkv x row tiles
    smem: int              # bytes of dynamic shared memory


def _key_lanes(threads: int) -> int:
    """Threads across a score tile's keys (csrc txs_of); 4 keys each."""
    return 32 if threads >= 256 else 16


def _block_ok(d: int, rows: int, threads: int) -> bool:
    """The kernel's thread layouts divide `rows` (csrc tile_ok): the scores
    threads / key lanes rows a pass, p @ v threads / min(key lanes, D / 4)."""
    lanes = _key_lanes(threads)
    return (threads % 64 == 0 and rows % (threads // lanes) == 0
            and rows % (threads // min(lanes, d // 4)) == 0)


def flash_smem(d: int, rows: int, threads: int, chunk: int) -> int:
    """Bytes of the kernel's dynamic shared memory (csrc smem_floats): a
    ring of FLASH_STAGES slots, each an f32 K slab [BK][DK + 4] (a score
    tile of BK = 4 x key lanes keys, DK = min(D, 4096 / BK) dims) or V slab
    [4096 / D (64 at D <= 64)][D + 4], the Q tile [rows][D + 4], the chunk's
    scores [rows][chunk + 8] and three f32 a row."""
    bk = 4 * _key_lanes(threads)
    dk = min(d, 4096 // bk)
    bv = 64 if d <= 64 else 4096 // d
    slot = max(bk * (dk + 4), bv * (d + 4))
    return 4 * (FLASH_STAGES * slot + rows * (d + 4) + rows * (chunk + 8)
                + 3 * rows)


@functools.lru_cache(maxsize=1024)
def plan(b: int, hq: int, hkv: int, l: int, s: int, d: int) -> PlanFlash:
    """The attention kernel's block at q [B, Hq, L, D], k / v [B, Hkv, S,
    D]: of the blocks the head dim takes that fit in shared memory, the one
    with the most rows (a staged K / V slab serves them all, and a thread's
    micro-tiles are largest) whose grid still has FLASH_MIN_BLOCKS blocks;
    where none does, the one with the fewest rows (the most blocks)."""
    chunk = kv_chunk(s)
    fits = [(r, t) for r, t in FLASH_BLOCKS
            if _block_ok(d, r, t) and flash_smem(d, r, t, chunk) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"no flash-attention block fits head_dim {d} at "
                         f"chunk {chunk}")
    g_rows = (hq // hkv) * l
    for rows, threads in fits:
        blocks = b * hkv * -(-g_rows // rows)
        if blocks >= FLASH_MIN_BLOCKS:
            break
    return PlanFlash(rows, threads, chunk, blocks,
                     flash_smem(d, rows, threads, chunk))


def _bind_attention(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
        + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int


def _bind_gather(lib: ctypes.CDLL) -> None:
    lib.paged_gather.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                                 + [ctypes.c_longlong, ctypes.c_void_p])
    lib.paged_gather.restype = ctypes.c_int


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          softcap: float = 0.0) -> torch.Tensor:
    """The plain version: ref.attention on the operands widened to f32 (the
    kernel widens on load), f32 out."""
    f = torch.float32
    return ref.attention(q.to(f), k.to(f), v.to(f), causal=causal,
                         logit_softcap=softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0) -> torch.Tensor:
    """q [B, Hq, L, D], k / v [B, Hkv, S, D] (f32 or bf16, one dtype,
    Hq a multiple of Hkv, D in HEAD_DIMS) -> [B, Hq, L, D] f32, logits
    scaled by D ** -0.5.  causal masks key positions past each query's
    end-aligned position (i + S - L), so it needs L <= S: every query row
    sees a key."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, softcap=softcap)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected 4-D q / k / v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, l, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    require(q, "q", q.dtype)
    require(k, "k", q.dtype, (b, hkv, s, d))
    require(v, "v", q.dtype, (b, hkv, s, d))
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} has no kernel (have {HEAD_DIMS})")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if min(b, hq, l, s) < 1:
        raise ValueError(f"empty attention {tuple(q.shape)} x "
                         f"{tuple(k.shape)}")
    if causal and l > s:
        raise ValueError(f"causal attention with L={l} > S={s} leaves "
                         "query rows without a key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    p = plan(b, hq, hkv, l, s, d)
    inv = float(np.float32(1.0) / np.float32(softcap)) if softcap > 0 else 0.0
    out = torch.empty((b, hq, l, d), dtype=torch.float32, device=q.device)
    err = _build.library("flash_attn", _bind_attention).flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        l, s, d, p.chunk, p.rows, p.threads, p.smem,
        int(q.dtype == torch.bfloat16), d ** -0.5, float(softcap), inv,
        int(causal), _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    _build.count("flash_attention")
    return out


def paged_gather_plain(pool: torch.Tensor,
                       tables: torch.Tensor) -> torch.Tensor:
    """The plain version: ref.paged_gather."""
    return ref.paged_gather(pool, tables)


def paged_gather_kv_plain(k_pool: torch.Tensor, v_pool: torch.Tensor,
                          tables: torch.Tensor):
    """The plain version of the pair: ref.paged_gather on each pool."""
    return ref.paged_gather(k_pool, tables), ref.paged_gather(v_pool, tables)


def _gather(pools, tables: torch.Tensor):
    """One launch of the gather kernel over one or two pools of one page
    shape; returns their gathered views."""
    b, m = tables.shape
    require(tables, "tables", torch.int32)
    for i, pool in enumerate(pools):
        require(pool, f"pool {i}", pools[0].dtype, pools[0].shape)
    n, p = pools[0].shape[0], pools[0].shape[1]
    outs = [torch.empty((b, m * p) + tuple(pool.shape[2:]), dtype=pool.dtype,
                        device=pool.device) for pool in pools]
    page_bytes = pools[0][0].numel() * pools[0].element_size()
    two = len(pools) == 2
    err = _build.library("paged_gather", _bind_gather).paged_gather(
        pools[0].data_ptr(), pools[1].data_ptr() if two else None,
        tables.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr() if two else None, n, b, m, page_bytes,
        _build.stream_ptr(pools[0]))
    _build.check(err, "paged_gather")
    _build.count("paged_gather")
    return outs


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool [N, P, ...] (any element type) + block table [B, M] int32 ->
    [B, M*P, ...], bitwise the pool's pages; entries outside [0, N-1] read
    the nearest block (the kernel clamps)."""
    if not pool.is_cuda:
        return paged_gather_plain(pool, tables)
    return _gather([pool], tables)[0]


def paged_gather_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    tables: torch.Tensor):
    """paged_gather of a layer's k and v pools (one dtype and shape)
    through one table, in one launch: (k view, v view)."""
    if not k_pool.is_cuda:
        return paged_gather_kv_plain(k_pool, v_pool, tables)
    return tuple(_gather([k_pool, v_pool], tables))
