"""Conv PE: int8 GEMM with a fused NL epilogue, on the H100.

Wrappers of the CUDA kernels in csrc/conv_pe.cu, each beside its plain
PyTorch version:

  * `matmul_int8_fused` -- replaces src/repro/kernels/conv_pe.py::
    matmul_int8_fused, kernel bodies `_kernel` (:37) and `_kernel_res`
    (:69): the 1x1 convolutions and the classifier head, the residual
    variant carrying every fused conv -> add.
  * `matmul_int8_pool` -- replaces `_kernel_pool` (:311): the GEMM whose
    static global-pool tail is reduced in the kernel.

Bound on the H100 and the design's answer: see the note at the top of
csrc/conv_pe.cu (bytes-bound 1x1 GEMMs; K loop inside the block, epilogue
in registers, int8 codes out; the pooled variant never writes its
pre-pool map).  The TPU kernels' block sizes and 128-padding are not
carried over: the CUDA kernel picks its 64x64 tiles and masks ragged edges.

On a CUDA tensor each wrapper checks its operands and launches its kernel
or raises; on CPU tensors it runs the plain version (the CPU tests).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.quant import Scale, mul, qdq_codes
from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import ptr, require

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    lib.conv_pe_gemm.argtypes = [_V, _V, _V, _I, _I, _I, _V, _F, _V, _V, _I,
                                 _I, _V, _F, _V, _I, _F, _I, _F, _I, _V]
    lib.conv_pe_gemm.restype = _I
    lib.conv_pe_pool.argtypes = [_V, _V, _V, _I, _I, _I, _I, _F, _V, _V, _I,
                                 _F, _F, _I, _F, _V]
    lib.conv_pe_pool.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.library("conv_pe", _bind)


def _is_scalar(s) -> bool:
    return not isinstance(s, torch.Tensor) or s.numel() == 1


# ---------------------------------------------------------------------------
# matmul_int8_fused (_kernel / _kernel_res)
# ---------------------------------------------------------------------------

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
    if mid_scale is not None:
        x = mul(qdq_codes(x, mid_scale), mid_scale)
    x = x + mul(residual.to(torch.float32), res_scale)
    x = ref.act_fn(add_act)(x)
    if out_scale is not None:
        return qdq_codes(x, out_scale).to(torch.int8)
    return x.to(out_dtype)


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
    [N]; bias f32 [N] or None; out_scale None (f32 out), a Python float, or
    an [N]-sized vector (int8 out).  residual [M, N] (int8 with res_scale,
    or f32) selects the residual variant: qdq at mid_scale (static chains),
    + residual * res_scale, add_act, requant."""
    if not a_q.is_cuda:
        return matmul_int8_fused_plain(
            a_q, b_q, a_scale, w_scale, bias, act, out_scale, out_dtype,
            residual=residual, res_scale=res_scale, mid_scale=mid_scale,
            add_act=add_act)
    m, k = a_q.shape
    n = b_q.shape[1]
    require(a_q, "a_q", torch.int8)
    require(b_q, "b_q", torch.int8, (k, n))
    asc = None
    if isinstance(a_scale, torch.Tensor):
        asc = require(a_scale.reshape(m), "a_scale", torch.float32)
    wsc = require(w_scale.reshape(n), "w_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    os_vec, os_val = None, 1.0
    if out_scale is not None:
        if _is_scalar(out_scale):
            os_val = float(out_scale)
        else:
            os_vec = require(out_scale.reshape(n), "out_scale", torch.float32)
    elif out_dtype != torch.float32:
        raise ValueError(f"conv_pe kernel writes f32 or int8, not {out_dtype}")
    if residual is not None:
        if residual.dtype not in (torch.int8, torch.float32):
            raise ValueError("residual must be int8 or f32")
        require(residual, "residual", residual.dtype, (m, n))
    out = torch.empty((m, n), device=a_q.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    err = _lib().conv_pe_gemm(
        a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), m, n, k, ptr(asc),
        float(a_scale) if asc is None else 0.0, wsc.data_ptr(), ptr(bias),
        _build.act_code(act), int(out_scale is not None), ptr(os_vec), os_val,
        ptr(residual),
        int(residual is not None and residual.dtype == torch.float32),
        float(res_scale), int(mid_scale is not None),
        float(mid_scale) if mid_scale is not None else 1.0,
        _build.act_code(add_act), _build.stream_ptr(a_q))
    name = "conv_pe" if residual is None else "conv_pe_res"
    _build.check(err, name)
    _build.count(name)
    return out


# ---------------------------------------------------------------------------
# matmul_int8_pool (_kernel_pool): static global-pool tail
# ---------------------------------------------------------------------------

def gap_scale(mid_scale: float, rows: int) -> float:
    """The GAP tail's scale: mid_scale / rows in double, rounded once to f32
    where it is used (the reference's `cur / px`)."""
    return mid_scale / rows


def matmul_int8_pool_plain(a_q, b_q, a_scale: float, w_scale, bias,
                           act: str, *, mid_scale: float,
                           out_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: per-image GEMM rows -> epilogue -> codes at mid_scale
    -> int32 sum over the rows -> * (mid_scale / rows) -> requant."""
    g, rows, k = a_q.shape
    x = ref.matmul_int8_fused(a_q.reshape(g * rows, k), b_q, a_scale,
                              w_scale, bias, act)
    codes = qdq_codes(x, mid_scale).to(torch.int32).reshape(g, rows, -1)
    y = mul(codes.sum(dim=1, dtype=torch.int32).to(torch.float32),
            gap_scale(mid_scale, rows))
    if out_scale is not None:
        return qdq_codes(y, out_scale).to(torch.int8)
    return y


def matmul_int8_pool(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: float,
                     w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                     act: str, *, mid_scale: float,
                     out_scale: Optional[float] = None) -> torch.Tensor:
    """Fused GEMM + static global-pool tail, one launch.

    a_q int8 [G, rows, K]: each image's ho*wo im2col rows; b_q int8 [K, N];
    a_scale the static per-tensor activation scale; mid_scale the absorbed
    conv edge's scale.  Returns [G, N], int8 when out_scale is given.  The
    pre-pool [G, rows, N] map is never written."""
    if not a_q.is_cuda:
        return matmul_int8_pool_plain(a_q, b_q, a_scale, w_scale, bias, act,
                                      mid_scale=mid_scale,
                                      out_scale=out_scale)
    g, rows, k = a_q.shape
    n = b_q.shape[1]
    require(a_q, "a_q", torch.int8)
    require(b_q, "b_q", torch.int8, (k, n))
    wsc = require(w_scale.reshape(n), "w_scale", torch.float32)
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    out = torch.empty((g, n), device=a_q.device,
                      dtype=torch.int8 if out_scale is not None
                      else torch.float32)
    err = _lib().conv_pe_pool(
        a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), g, rows, n, k,
        float(a_scale), wsc.data_ptr(), ptr(bias), _build.act_code(act),
        float(mid_scale), gap_scale(mid_scale, rows),
        int(out_scale is not None),
        float(out_scale) if out_scale is not None else 1.0,
        _build.stream_ptr(a_q))
    _build.check(err, "conv_pe_pool")
    _build.count("conv_pe_pool")
    return out
