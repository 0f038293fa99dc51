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
    residual add).  Kernel in csrc/conv_pe_w4.cu.
  * `matmul_f_fused` -- replaces `matmul_f_fused`, kernel body `_kernel_f`
    (:429): the float GEMM with f32 accumulation, bias and act, which
    runs every float projection of the training path (ops.linear_f on
    backend="cuda"), forward and backward, through the autograd Function
    `MatmulF`.  Kernel in csrc/conv_pe_f.cu.

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


def _bind_w4(lib: ctypes.CDLL) -> None:
    lib.conv_pe_w4.argtypes = [_V, _V, _V, _V, _V, _I, _I, _I, _I, _V, _F,
                               _V, _I, _I, _V, _F, _V, _I, _F, _I, _F, _I,
                               _V]
    lib.conv_pe_w4.restype = _I


def _bind_f(lib: ctypes.CDLL) -> None:
    lib.conv_pe_f_gemm.argtypes = [_V, _V, _V, _V, _I, _I, _I, _I, _I, _I,
                                   _V]
    lib.conv_pe_f_gemm.restype = _I


def _bind(lib: ctypes.CDLL) -> None:
    lib.conv_pe_gemm.argtypes = [_V, _V, _V, _I, _I, _I, _V, _F, _V, _V, _I,
                                 _I, _V, _F, _V, _I, _F, _I, _F, _I, _V]
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


W4_MAX_GROUP = 1024      # the kernel stages whole groups of <= 1024 K rows


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
    selects the residual variant.  M and N are any size (masked)."""
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
    err = _build.library("conv_pe_w4", _bind_w4).conv_pe_w4(
        a_q.data_ptr(), b_packed.data_ptr(), w_scale.data_ptr(),
        w_zero.data_ptr(), out.data_ptr(), m, n, k, k // g, ptr(asc),
        float(a_scale) if asc is None else 0.0, ptr(bias),
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


def matmul_f_fused_plain(a: torch.Tensor, b: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         act: str = "none",
                         out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: ref.matmul_f_fused (f32 product, + bias, act in
    f32, cast)."""
    return ref.matmul_f_fused(a, b, bias, act, out_dtype)


def _gemm_f(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            act: str, out_dtype) -> torch.Tensor:
    """One product: the kernel on CUDA tensors (counted as conv_pe_f), the
    plain version on CPU tensors."""
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
    require(a, "a", a.dtype)
    require(b, "b", a.dtype, (k, n))
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.library("conv_pe_f", _bind_f).conv_pe_f_gemm(
        a.data_ptr(), b.data_ptr(), ptr(bias), out.data_ptr(), m, n, k,
        _build.f_act_code(act), int(a.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(a))
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
      * da = dz @ b^T and db = a^T @ dz, each one launch on contiguous
        transposed copies, in a's / b's dtype;
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
            da = _gemm_f(dz, b.t().contiguous(), None, "none", a.dtype)
        if ctx.needs_input_grad[1]:
            db = _gemm_f(a.t().contiguous(), dz, None, "none", b.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = dz32.sum(dim=0).to(bias.dtype)
        return da, db, dbias, None, None


def matmul_f_fused(a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, act: str = "none",
                   out_dtype=torch.float32) -> torch.Tensor:
    """Fused float GEMM.  a [M, K] and b [K, N] both f32 or both bf16,
    contiguous; bias f32 [N] or None; act any of ref.act_fn's; out_dtype
    f32 or bf16.  Returns act(a @ b + bias) in out_dtype, differentiable
    (MatmulF).  On CUDA tensors every product launches the kernel (one
    forward; a recompute when act != "none" and two products in the
    backward); on CPU tensors the plain version runs in their place."""
    if a.dtype != b.dtype:
        raise ValueError(f"conv_pe_f: a is {a.dtype}, b is {b.dtype}")
    return MatmulF.apply(a, b, bias, act, out_dtype)
