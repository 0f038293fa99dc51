"""Paged KV gather on the H100.

Wrapper of the CUDA kernel in csrc/paged_gather.cu, beside its plain
PyTorch version:

  * `paged_gather` -- replaces src/repro/kernels/flash_attn.py::
    paged_gather, kernel body `_gather_kernel` (:110): the block-table
    gather through which paged decode reads its KV pool, a pure copy of
    pool pages [N, P, ...] into the slot-ordered view [B, M*P, ...].

Bound on the H100 and the design's answer: see the note at the top of
csrc/paged_gather.cu (a byte copy that, at decode, is bound by its
launch; one block per page, 16-byte vector moves).  The reference's
other kernel in this file, `flash_attention` (online-softmax attention,
reached only from its tests), is not ported yet.

On a CUDA tensor the wrapper checks its operands and launches its kernel
or raises; on CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import require


def _bind(lib: ctypes.CDLL) -> None:
    lib.paged_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_void_p]
    lib.paged_gather.restype = ctypes.c_int


def paged_gather_plain(pool: torch.Tensor,
                       tables: torch.Tensor) -> torch.Tensor:
    """The plain version: ref.paged_gather."""
    return ref.paged_gather(pool, tables)


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool [N, P, ...] (any element type) + block table [B, M] int32,
    entries in [0, N-1] -> [B, M*P, ...], bitwise the pool's pages."""
    if not pool.is_cuda:
        return paged_gather_plain(pool, tables)
    n, p = pool.shape[0], pool.shape[1]
    b, m = tables.shape
    require(pool, "pool", pool.dtype)
    require(tables, "tables", torch.int32)
    if pool.data_ptr() % 16:
        raise ValueError("pool: expected a 16-byte aligned tensor")
    out = torch.empty((b, m * p) + tuple(pool.shape[2:]), dtype=pool.dtype,
                      device=pool.device)
    page_bytes = pool[0].numel() * pool.element_size()
    err = _build.library("paged_gather", _bind).paged_gather(
        pool.data_ptr(), tables.data_ptr(), out.data_ptr(), n, b, m,
        page_bytes, _build.stream_ptr(pool))
    _build.check(err, "paged_gather")
    _build.count("paged_gather")
    return out
