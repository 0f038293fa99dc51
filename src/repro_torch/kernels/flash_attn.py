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
the two CUDA sources.  The attention kernel agrees with its plain version
here (`ref.attention`, one softmax over all keys) to f32 rounding, and it
keeps the op order of the plain chunked prefill attention that the ref
backend runs (models/layers.py::flash_attention), so that the int8 edge
after it, and the served ids, do not move between the backends.

On a CUDA tensor a wrapper checks its operands and launches its kernel or
raises; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes

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


def _bind_attention(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
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
    inv = float(np.float32(1.0) / np.float32(softcap)) if softcap > 0 else 0.0
    out = torch.empty((b, hq, l, d), dtype=torch.float32, device=q.device)
    err = _build.library("flash_attn", _bind_attention).flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        l, s, d, kv_chunk(s), int(q.dtype == torch.bfloat16), d ** -0.5,
        float(softcap), inv, int(causal), _build.stream_ptr(q))
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
