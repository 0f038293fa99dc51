"""Public kernel wrappers: backend dispatch, im2col, padding.

Two backends (EngineConfig.backend):
  * "ref"  -- plain PyTorch (kernels/ref.py + the _epilogue chain): the
              calibration path and the bit-exact reference;
  * "cuda" -- the hand-written Hopper kernels (conv_pe with its float GEMM,
              conv_pe_w4, dwc_pe with its 1-D causal conv, low_channel,
              misc_pe, flash_attn's attention and paged gather), whose
              wrappers launch on CUDA tensors and run their plain versions
              on CPU tensors.

The LM projections dispatch on the weight container: a QTensor runs the
int8 Conv PE, a Q4Tensor (quant="w4a8") the int4 one, a float weight the
float GEMM (`linear_f`).  `linear_group`
runs a fused projection group (Q/K/V, gate/up) as ONE launch over the
members' weights concatenated along N on the CUDA backend.

The reference's TPU block picker (`pick_blocks`, sized from a model of
VMEM) and its M/N/K and 128-lane padding have no counterpart: the CUDA
kernels choose their own tiles and mask ragged edges.  SAME padding and the
im2col (K ordered (kh, kw, ic), matching `w.reshape(k*k*IC, OC)`) stay here,
in NHWC.  Fused epilogues that no zoo model reaches have no CUDA kernel
yet and raise NotImplementedError on that backend: DWC tails, the
Low-Channel avg / global tails, avg / max pooled GEMM tails and dynamic
(f32) pooled GEMM chains.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.config import EngineConfig
from repro_torch.core.quant import (Q4Tensor, QTensor, f32,
                                    quantize_act_dynamic)
from repro_torch.kernels import (_epilogue, conv_pe, dwc_pe, flash_attn,
                                low_channel, misc_pe, ref)

# Quant modes with int8 activations on the Conv PE (w4a8 packs the LM
# projection WEIGHTS to int4; everything else runs exactly like w8a8).
_INT8_ACTS = ("w8a8", "w4a8")


def _chain_kwargs(ep, static: bool, out_scale):
    """Epilogue spec -> _epilogue.fused_chain kwargs.  Static programs carry
    the interior requant points; dynamic chains run f32."""
    return dict(
        mid_scale=ep.mid_scale if static and ep.mid_scale else None,
        add_act=ep.add_act,
        add_scale=ep.add_scale if static and ep.add_scale else None,
        pool=ep.pool, pool_kernel=ep.pool_kernel, pool_stride=ep.pool_stride,
        out_scale=out_scale if static else None)


def _kernels(cfg: EngineConfig) -> bool:
    return cfg.backend == "cuda"


def _no_kernel(what: str):
    return NotImplementedError(
        f"{what} has no CUDA kernel (no zoo model reaches it); run "
        "backend='ref'")


# ---------------------------------------------------------------------------
# Conv PE: quantized linear (1x1 convs, im2col GEMMs, the classifier head)
# ---------------------------------------------------------------------------

def _gemm_operands(x, kdim_w: int):
    """(leading dims, a_q [M, K], a_scale) of a GEMM input: a QTensor with
    a static per-tensor scale, or float [..., K] quantized per token
    (a_scale [M, 1])."""
    static = isinstance(x, QTensor)
    xv = x.q if static else x
    lead = xv.shape[:-1]
    kdim = xv.shape[-1]
    if kdim != kdim_w:
        raise ValueError(f"GEMM input K={kdim}, weight K={kdim_w}")
    # contiguous rows: a reshape of a permuted or sliced input (an einsum
    # output, a column slice) can be a strided view, and quantizing
    # keeps the input's layout
    x2 = xv.reshape(math.prod(lead), kdim).contiguous()
    if static:
        return lead, x2, float(x.scale)
    xq = quantize_act_dynamic(x2, per_token=True)
    return lead, xq.q, xq.scale


def linear_int8(x, w: QTensor, bias: Optional[torch.Tensor], act: str,
                cfg: EngineConfig, out_dtype=torch.float32, out_scale=None,
                residual: Optional[torch.Tensor] = None,
                res_scale: float = 1.0, mid_scale: Optional[float] = None,
                add_act: str = "none") -> torch.Tensor:
    """x: float [..., K] (dynamic per-token act quant) or a QTensor with a
    static per-tensor scale; w: QTensor(q=[K, N] int8, scale=[1, N]).
    out_scale: static requant scale -> int8 out (a float, or a per-channel
    sequence); None -> float out.  residual [..., N] streams the fused
    residual epilogue into the CUDA kernel (the ref backend composes the
    chain in its callers instead)."""
    n = w.q.shape[-1]
    lead, a_q, a_scale = _gemm_operands(x, w.q.shape[0])
    m = a_q.shape[0]
    if out_scale is not None and not isinstance(out_scale, (int, float)):
        out_scale = f32(out_scale, a_q.device).reshape(1, n)
    w_scale = w.scale.reshape(1, n)
    if _kernels(cfg):
        out = conv_pe.matmul_int8_fused(
            a_q, w.q, a_scale, w_scale, bias, act, out_scale, out_dtype,
            residual=None if residual is None else residual.reshape(m, n),
            res_scale=res_scale, mid_scale=mid_scale, add_act=add_act)
    else:
        if residual is not None:
            raise ValueError("the ref backend composes fused residuals in "
                             "the callers")
        out = ref.matmul_int8_fused(a_q, w.q, a_scale, w_scale, bias, act,
                                    out_scale=out_scale, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def linear_w4(x, w: Q4Tensor, bias: Optional[torch.Tensor], act: str,
              cfg: EngineConfig, out_dtype=torch.float32, out_scale=None,
              residual: Optional[torch.Tensor] = None,
              res_scale: float = 1.0, mid_scale: Optional[float] = None,
              add_act: str = "none") -> torch.Tensor:
    """Int4 weight-only GEMM over int8 activations (quant='w4a8').  x as in
    linear_int8; w: Q4Tensor (packed [K//2, N] + per-group f16 scale /
    zero).  The CUDA kernel unpacks the nibbles in registers; nothing is
    padded.  Epilogue contract as linear_int8."""
    n = w.packed.shape[-1]
    lead, a_q, a_scale = _gemm_operands(x, 2 * w.packed.shape[0])
    m = a_q.shape[0]
    if out_scale is not None and not isinstance(out_scale, (int, float)):
        out_scale = f32(out_scale, a_q.device).reshape(1, n)
    if _kernels(cfg):
        out = conv_pe.matmul_int4_fused(
            a_q, w.packed, a_scale, w.scale, w.zero, bias, act, out_scale,
            out_dtype,
            residual=None if residual is None else residual.reshape(m, n),
            res_scale=res_scale, mid_scale=mid_scale, add_act=add_act)
    else:
        if residual is not None:
            raise ValueError("the ref backend composes fused residuals in "
                             "the callers")
        out = ref.matmul_int4_fused(a_q, w.packed, a_scale, w.scale, w.zero,
                                    bias, act, out_scale=out_scale,
                                    out_dtype=out_dtype)
    return out.reshape(*lead, n)


def linear_f(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
             act: str, cfg: EngineConfig, out_dtype=None) -> torch.Tensor:
    """Float path (training; calibration on backend="ref").

    backend="cuda": the float Conv PE GEMM (conv_pe.matmul_f_fused, the
    reference's Pallas `_kernel_f`) on x's rows and w cast to x's dtype:
    the product accumulates in f32, the f32 bias and the act apply to the
    f32 sum, and only the result is cast to out_dtype.  backend="ref": the
    reference's `ops.linear_f`, whose product is rounded to x's dtype
    before the bias add and the act, which then run in that dtype.  At
    bf16 compute the two backends therefore differ by bf16 rounding (the
    CUDA one follows the Pallas kernel, the ref one follows
    `ops.linear_f`); at f32 compute by f32 rounding only."""
    out_dtype = out_dtype or x.dtype
    if _kernels(cfg):
        lead, kdim, n = x.shape[:-1], x.shape[-1], w.shape[-1]
        out = conv_pe.matmul_f_fused(
            x.reshape(-1, kdim).contiguous(), w.to(x.dtype).contiguous(),
            None if bias is None else bias.to(torch.float32), act, out_dtype)
        return out.reshape(*lead, n)
    out = x @ w.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return ref.act_fn(act)(out).to(out_dtype)


def linear(x, w, bias, act: str, cfg: EngineConfig, out_dtype=None,
           out_scale=None, residual: Optional[torch.Tensor] = None,
           res_scale: float = 1.0, mid_scale: Optional[float] = None,
           add_act: str = "none") -> torch.Tensor:
    """Dispatch on quant mode and weight container type: Q4Tensor weights
    (quant='w4a8') -> the int4 Conv PE, QTensor weights under w8a8 / w4a8
    -> the int8 Conv PE, float weights -> linear_f."""
    kw = dict(out_dtype=out_dtype or torch.float32, out_scale=out_scale,
              residual=residual, res_scale=res_scale, mid_scale=mid_scale,
              add_act=add_act)
    if isinstance(w, Q4Tensor):
        if cfg.quant != "w4a8":
            raise ValueError(f"Q4Tensor weights require quant='w4a8' "
                             f"(got {cfg.quant!r})")
        return linear_w4(x, w, bias, act, cfg, **kw)
    if isinstance(w, QTensor) and cfg.quant in _INT8_ACTS:
        return linear_int8(x, w, bias, act, cfg, **kw)
    if isinstance(w, QTensor):
        raise ValueError("quantized weights need quant='w8a8' or 'w4a8' "
                         "(weight-only int8 is not ported)")
    if residual is not None:
        raise ValueError("fused residual epilogues require an int8-"
                         "activation quant mode with quantized weights")
    if isinstance(x, QTensor) or out_scale is not None:
        raise ValueError("static int8 activations / out_scale require "
                         f"quant='w8a8' / 'w4a8' with quantized weights "
                         f"(got quant={cfg.quant!r})")
    return linear_f(x, w, bias, act, cfg, out_dtype=out_dtype)


# Fused projection groups' concatenated weights, built once per set of
# member tensors (the reference concatenates on every call, under jit):
# key = the members' tensor ids, checked against weak references so a
# freed member can never alias a stale entry.
_GROUP_WEIGHTS: Dict[tuple, tuple] = {}


def _fused_weight(ws: Sequence):
    leaves = [t for w in ws for t in w]
    key = tuple(id(t) for t in leaves)
    hit = _GROUP_WEIGHTS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], leaves)):
        return hit[1]
    for k in [k for k, (refs, _) in _GROUP_WEIGHTS.items()
              if any(r() is None for r in refs)]:
        del _GROUP_WEIGHTS[k]
    if isinstance(ws[0], Q4Tensor):
        # members share K and the snapped group size, so the per-group
        # scale / zero tables concatenate along N too
        fused = Q4Tensor(*(torch.cat([getattr(w, f) for w in ws], dim=1)
                           for f in ("packed", "scale", "zero")))
    else:
        fused = QTensor(torch.cat([w.q for w in ws], dim=1),
                        torch.cat([w.scale.reshape(1, -1) for w in ws],
                                  dim=1))
    _GROUP_WEIGHTS[key] = ([weakref.ref(t) for t in leaves], fused)
    return fused


def linear_group(x, ws, bs, acts, cfg: EngineConfig, out_dtype=None):
    """A fused multi-output projection group (Q/K/V, gate/up): one shared
    input, the members' outputs returned as a tuple.

    On the CUDA backend with quantized members the weights concatenate
    along N into ONE kernel launch: the activation row is quantized and
    read once.  Columns never mix members' reductions, so each member's
    slice equals its own launch bit for bit; each member's act runs on its
    slice afterwards.  The ref and float paths compose member-wise."""
    kinds = {type(w) for w in ws}
    fused = _kernels(cfg) and (
        (kinds == {QTensor} and cfg.quant in _INT8_ACTS)
        or (kinds == {Q4Tensor} and cfg.quant == "w4a8"))
    if not fused:
        return tuple(linear(x, w, b, a, cfg, out_dtype=out_dtype)
                     for w, b, a in zip(ws, bs, acts))
    ns = [w.shape[-1] for w in ws]
    bias = None
    if any(b is not None for b in bs):
        xdev = (x.q if isinstance(x, QTensor) else x).device
        bias = torch.cat([b.to(torch.float32) if b is not None
                          else torch.zeros(nn, dtype=torch.float32,
                                           device=xdev)
                          for b, nn in zip(bs, ns)])
    out = linear(x, _fused_weight(ws), bias, "none", cfg,
                 out_dtype=torch.float32)
    outs, off = [], 0
    for nn, a in zip(ns, acts):
        y = out[..., off:off + nn].contiguous()
        if a != "none":
            y = ref.act_fn(a)(y)
        outs.append(y.to(out_dtype) if out_dtype is not None else y)
        off += nn
    return tuple(outs)


def linear_ep(x, w, bias, act: str, ep, residual, cfg: EngineConfig, *,
              res_scale: float = 1.0, out_scale=None,
              out_dtype=torch.float32) -> torch.Tensor:
    """A LinearOp with a fused epilogue: the residual add after an O / down
    projection.  On the CUDA backend with quantized weights the residual
    streams into the kernel's epilogue (ep.mid_scale re-quantizes the GEMM
    output at its pre-fusion edge scale in a static program); the ref and
    float paths compose the same chain on the GEMM output
    (_epilogue.fused_chain)."""
    static = isinstance(x, QTensor)
    quanted = ((isinstance(w, QTensor) and cfg.quant in _INT8_ACTS)
               or (isinstance(w, Q4Tensor) and cfg.quant == "w4a8"))
    if _kernels(cfg) and quanted and ep.pool == "none":
        return linear(x, w, bias, act, cfg, out_dtype=out_dtype,
                      out_scale=out_scale, residual=residual,
                      res_scale=res_scale,
                      mid_scale=(ep.mid_scale if static and ep.mid_scale
                                 else None),
                      add_act=ep.add_act)
    y = linear(x, w, bias, act, cfg, out_dtype=torch.float32)
    return _epilogue.fused_chain(
        y, residual=residual, res_scale=res_scale,
        **_chain_kwargs(ep, static and quanted, out_scale))


# ---------------------------------------------------------------------------
# Conv2D via Conv PE (im2col -> GEMM), the CNN standard-conv path
# ---------------------------------------------------------------------------

def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return (pad // 2, pad - pad // 2)


def pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """SAME zero padding of an NHWC map (exact for int8: zero point 0)."""
    ph = _same_pad(x.shape[1], k, stride)
    pw = _same_pad(x.shape[2], k, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Padded NHWC [N, Hp, Wp, C] -> [N*Ho*Wo, k*k*C], K in (kh, kw, c)
    order (a 1x1 stride-1 conv is a reshape)."""
    n, hp, wp, c = x.shape
    ho = (hp - k) // stride + 1
    wo = (wp - k) // stride + 1
    if k == 1 and stride == 1:
        return x.reshape(n * ho * wo, c)
    cols = [xs for _, _, xs in ref.taps(x, k, stride, ho, wo)]
    return torch.cat(cols, dim=-1).reshape(n * ho * wo, k * k * c)


def conv2d_pe(x, w, bias: Optional[torch.Tensor], stride: int, padding: str,
              act: str, cfg: EngineConfig, out_dtype=torch.float32,
              out_scale=None, epilogue=None,
              residual: Optional[torch.Tensor] = None,
              res_scale: float = 1.0) -> torch.Tensor:
    """Standard conv: x [N,H,W,IC] float or QTensor (static int8 with a
    per-tensor scale); w [k,k,IC,OC] float or QTensor, or the compile-time
    folded GEMM layout [k*k*IC, OC] (passes.fold_weight_layouts).  The conv
    lowers to the Conv PE GEMM with K = k*k*IC; out_scale requants to int8
    in the fused NL epilogue.  `epilogue` (a graph.Epilogue) runs the
    absorbed tail -- residual add, activation, pool, requant -- in the same
    launch on the CUDA backend, or as the composed chain on ref."""
    static = isinstance(x, QTensor)
    if static and not isinstance(w, QTensor):
        x = x.dequant()                       # float weights: float math
        static = False
    xv = x.q if static else x
    wq = w.q if isinstance(w, QTensor) else w
    ic = xv.shape[-1]
    if wq.ndim == 2:
        oc = wq.shape[1]
        k = math.isqrt(wq.shape[0] // ic)
        if k * k * ic != wq.shape[0]:
            raise ValueError(f"folded conv weight K={wq.shape[0]} does not "
                             f"factor as k*k*IC for IC={ic}")
        wmat = wq
    else:
        k, oc = wq.shape[0], wq.shape[3]
        wmat = wq.reshape(k * k * ic, oc)
    if padding == "SAME":
        xv = pad_same(xv, k, stride)
    n, hp, wp, _ = xv.shape
    ho = (hp - k) // stride + 1
    wo = (wp - k) // stride + 1
    col = im2col(xv, k, stride)
    if isinstance(w, QTensor):
        wt = QTensor(wmat, w.scale.reshape(1, oc))
        col_in = QTensor(col, x.scale) if static else col
        if epilogue is not None:
            return _conv_epilogue(col_in, wt, bias, act, epilogue, residual,
                                  res_scale, out_scale, cfg, out_dtype,
                                  n, ho, wo, oc)
        out = linear(col_in, wt, bias, act, cfg, out_dtype=out_dtype,
                     out_scale=out_scale)
    else:
        if out_scale is not None:
            raise ValueError("out_scale requires QTensor weights")
        out = linear_f(col, wmat, bias, act, cfg, out_dtype=out_dtype)
        if epilogue is not None:
            return _epilogue.fused_chain(
                out.reshape(n, ho, wo, oc), residual=residual,
                res_scale=res_scale, **_chain_kwargs(epilogue, False, None))
    return out.reshape(n, ho, wo, oc)


def _conv_epilogue(col_in, wt: QTensor, bias, act: str, ep, residual,
                   res_scale: float, out_scale, cfg: EngineConfig,
                   out_dtype, n: int, ho: int, wo: int,
                   oc: int) -> torch.Tensor:
    """Fused Conv PE epilogue dispatch (quantized GEMM path)."""
    static = isinstance(col_in, QTensor)
    mid = ep.mid_scale if static and ep.mid_scale else None
    if _kernels(cfg) and ep.pool == "none":
        # the residual operand streams into the GEMM kernel's epilogue
        out = linear(col_in, wt, bias, act, cfg, out_dtype=out_dtype,
                     out_scale=out_scale,
                     residual=residual.reshape(n * ho * wo, oc),
                     res_scale=res_scale, mid_scale=mid, add_act=ep.add_act)
        return out.reshape(n, ho, wo, oc)
    if _kernels(cfg):
        if (ep.pool != "global" or mid is None
                or not isinstance(out_scale, (int, float, type(None)))):
            raise _no_kernel(f"the pooled epilogue {ep.stages!r} "
                             f"({'static' if static else 'dynamic'})")
        kdim = col_in.q.shape[-1]
        return conv_pe.matmul_int8_pool(
            col_in.q.reshape(n, ho * wo, kdim), wt.q, float(col_in.scale),
            wt.scale, bias, act, mid_scale=mid, out_scale=out_scale,
            residual=(None if residual is None
                      else residual.reshape(n, ho * wo, oc)),
            res_scale=res_scale, add_act=ep.add_act,
            add_scale=ep.add_scale)
    # ref: the GEMM part (f32, pre-requant) + the shared chain math
    y = linear(col_in, wt, bias, act, cfg, out_dtype=torch.float32)
    return _epilogue.fused_chain(y.reshape(n, ho, wo, oc),
                                 residual=residual, res_scale=res_scale,
                                 **_chain_kwargs(ep, static, out_scale))


# ---------------------------------------------------------------------------
# DWC PE and the Low-Channel unit
# ---------------------------------------------------------------------------

def _int8_operands(x, w, cfg: EngineConfig):
    """(static, quant, x operand, a_scale, w operand, w_scale) for the
    depthwise and first-layer engines.  Static x carries its calibrated
    per-tensor scale; float x under w8a8 quantizes per tensor."""
    static = isinstance(x, QTensor)
    is_q = isinstance(w, QTensor)
    if static and not is_q:
        x, static = x.dequant(), False        # float weights: float math
    quant = (is_q and cfg.quant == "w8a8") or static
    if not quant:
        if _kernels(cfg):
            raise ValueError("the CUDA engines take quantized weights")
        return static, False, x, None, (w.dequant(x.dtype) if is_q else w), \
            None
    if static:
        xin, a_scale = x.q, float(x.scale)
    else:
        xq = quantize_act_dynamic(x, per_token=False)
        xin, a_scale = xq.q, xq.scale
    return static, True, xin, a_scale, w.q, w.scale.reshape(-1)


def dwc2d(x, w, bias: Optional[torch.Tensor], stride: int, padding: str,
          act: str, cfg: EngineConfig, out_dtype=torch.float32,
          out_scale=None, epilogue=None,
          residual: Optional[torch.Tensor] = None,
          res_scale: float = 1.0) -> torch.Tensor:
    """Depthwise conv.  x [N,H,W,C] float or QTensor (static int8, per-tensor
    scale); w [k,k,C] float or QTensor.  out_scale requants to int8 in the
    RACNL epilogue; `epilogue` fuses an absorbed MISC tail (ref backend)."""
    static, quant, xin, a_scale, w_in, w_scale = _int8_operands(x, w, cfg)
    k = w_in.shape[0]
    if padding == "SAME":
        xin = pad_same(xin, k, stride)
    if epilogue is not None:
        if _kernels(cfg):
            raise _no_kernel(f"the DWC epilogue {epilogue.stages!r}")
        y = ref.dwc2d(xin, w_in, bias, stride, act, a_scale=a_scale,
                      w_scale=w_scale, out_dtype=torch.float32)
        return _epilogue.fused_chain(y, residual=residual,
                                     res_scale=res_scale,
                                     **_chain_kwargs(epilogue, static,
                                                     out_scale))
    if _kernels(cfg):
        return dwc_pe.dwc2d(xin.contiguous(), w_in, bias, stride, act,
                            a_scale=float(a_scale), w_scale=w_scale,
                            out_scale=out_scale, out_dtype=out_dtype)
    return ref.dwc2d(xin, w_in, bias, stride, act, a_scale=a_scale,
                     w_scale=w_scale, out_scale=out_scale,
                     out_dtype=out_dtype)


def dwc1d_causal(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor], act: str,
                 cfg: EngineConfig) -> torch.Tensor:
    """Causal temporal depthwise conv: x [B, L, C] float, w [k, C], out in
    x's dtype.  The reference pads C to its 128-lane width for the Pallas
    kernel; the CUDA kernel takes any C."""
    if _kernels(cfg):
        return dwc_pe.dwc1d_causal(x.contiguous(), w, bias, act,
                                   out_dtype=x.dtype)
    return ref.dwc1d_causal(x, w, bias, act, out_dtype=x.dtype)


def first_layer_conv(x, w, bias: Optional[torch.Tensor], stride: int,
                     padding: str, act: str, cfg: EngineConfig,
                     out_dtype=torch.float32, out_scale=None, epilogue=None,
                     residual: Optional[torch.Tensor] = None,
                     res_scale: float = 1.0) -> torch.Tensor:
    """Stage-0 conv on the Low-Channel unit.  x may be a QTensor (the
    compiled program quantizes the image with its static scale); out_scale
    requants the stem output to int8.  `epilogue` fuses an absorbed pool
    tail (on the CUDA backend the max tail; avg / global raise); residual
    adds never fuse into the stem."""
    if epilogue is not None and epilogue.add:
        raise ValueError("the Low-Channel unit fuses pool tails only")
    static, quant, xin, a_scale, w_in, w_scale = _int8_operands(x, w, cfg)
    k = w_in.shape[0]
    if padding == "SAME":
        xin = pad_same(xin, k, stride)
    if epilogue is not None:
        kw = _chain_kwargs(epilogue, static, out_scale)
        if _kernels(cfg):
            return low_channel.low_channel_conv(
                xin.contiguous(), w_in, bias, stride, act,
                a_scale=float(a_scale), w_scale=w_scale, pool=kw["pool"],
                pool_kernel=kw["pool_kernel"], pool_stride=kw["pool_stride"],
                mid_scale=kw["mid_scale"])
        y = ref.low_channel_conv(xin, w_in, bias, stride, act,
                                 a_scale=a_scale, w_scale=w_scale,
                                 out_dtype=torch.float32)
        return _epilogue.fused_chain(y, **kw)
    if _kernels(cfg):
        return low_channel.low_channel_conv(
            xin.contiguous(), w_in, bias, stride, act, a_scale=float(a_scale),
            w_scale=w_scale, out_scale=out_scale, out_dtype=out_dtype)
    return ref.low_channel_conv(xin, w_in, bias, stride, act,
                                a_scale=a_scale, w_scale=w_scale,
                                out_scale=out_scale, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# MISC core
# ---------------------------------------------------------------------------

def misc_add(a: torch.Tensor, b: torch.Tensor, act: str, cfg: EngineConfig,
             sa: float = 1.0, sb: float = 1.0, out_dtype=torch.float32,
             out_scale=None) -> torch.Tensor:
    """Residual add; in a static program a/b are int8 at scales sa/sb and
    out_scale requants the sum."""
    if _kernels(cfg):
        return misc_pe.misc_add(a, b, sa, sb, act, out_scale=out_scale,
                                out_dtype=out_dtype)
    return ref.misc_add(a, b, sa, sb, act, out_scale=out_scale,
                        out_dtype=out_dtype)


def avgpool2d(x: torch.Tensor, window: int, stride: int, cfg: EngineConfig,
              out_dtype=torch.float32) -> torch.Tensor:
    """[N, H, W, C] VALID average pool, f32 out."""
    if _kernels(cfg):
        return misc_pe.avgpool2d(x, window, stride, out_dtype=out_dtype)
    return ref.avgpool2d(x, window, stride, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Paged KV cache gather (LM serving)
# ---------------------------------------------------------------------------

def paged_gather(pool: torch.Tensor, tables: torch.Tensor,
                 cfg: EngineConfig) -> torch.Tensor:
    """Gather a block-paged KV pool [N, P, ...] into the slot-ordered dense
    view [B, M*P, ...] through block table [B, M].  Table entries are
    clipped into [0, N-1] here, once, for both backends: unallocated pages
    carry the sentinel N, and whatever a clipped sentinel reads sits past
    the slot's length, where the decode mask discards it."""
    tables = torch.clamp(tables, 0, pool.shape[0] - 1).to(torch.int32)
    if _kernels(cfg):
        return flash_attn.paged_gather(pool, tables.contiguous())
    return ref.paged_gather(pool, tables)


# ---------------------------------------------------------------------------
# Flash attention (the compiled prefill's global layers)
# ---------------------------------------------------------------------------

def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: EngineConfig, *, causal: bool = True,
              softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, L, D]; k, v [B, Hkv, S, D] with H a multiple of Hkv (GQA:
    query head h reads KV head h // (H / Hkv)).  Causal masking is
    end-aligned (query i at position i + S - L); keys past S are never
    seen, so no padding is needed.  f32 out.  backend="cuda" launches the
    flash-attention kernel (or raises on an operand it does not take);
    backend="ref" runs its plain version."""
    if _kernels(cfg):
        return flash_attn.flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal=causal,
                                          softcap=softcap)
    return flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            softcap=softcap)
