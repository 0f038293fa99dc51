"""Public kernel wrappers, CNN half: backend dispatch, im2col, padding.

Two backends (EngineConfig.backend):
  * "ref"  -- plain PyTorch (kernels/ref.py + the _epilogue chain): the
              calibration path and the bit-exact reference;
  * "cuda" -- the hand-written Hopper kernels (conv_pe, dwc_pe,
              low_channel), whose wrappers launch on CUDA tensors and run
              their plain versions on CPU tensors.

The reference's TPU block picker (`pick_blocks`, sized from a model of
VMEM) and its M/N/K and 128-lane padding have no counterpart: the CUDA
kernels choose their own tiles and mask ragged edges.  SAME padding and the
im2col (K ordered (kh, kw, ic), matching `w.reshape(k*k*IC, OC)`) stay here,
in NHWC.  Fused epilogues the CUDA backend does not carry yet (DWC and
Low-Channel tails, residual / avg / max pooled tails, MISC adds and avg
pools) raise NotImplementedError on that backend; they arrive with the
slices that need them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.config import EngineConfig
from repro_torch.core.quant import QTensor, f32, quantize_act_dynamic
from repro_torch.kernels import _epilogue, conv_pe, dwc_pe, low_channel, ref


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


def _slice_1b(what: str):
    return NotImplementedError(
        f"{what} has no CUDA kernel in this slice; run backend='ref'")


# ---------------------------------------------------------------------------
# Conv PE: quantized linear (1x1 convs, im2col GEMMs, the classifier head)
# ---------------------------------------------------------------------------

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
    chain in conv2d_pe instead)."""
    static = isinstance(x, QTensor)
    xv = x.q if static else x
    lead = xv.shape[:-1]
    kdim = xv.shape[-1]
    n = w.q.shape[-1]
    if out_scale is not None and not isinstance(out_scale, (int, float)):
        out_scale = f32(out_scale, xv.device).reshape(1, n)
    m = math.prod(lead)
    x2 = xv.reshape(m, kdim)
    if static:
        a_q, a_scale = x2.contiguous(), float(x.scale)
    else:
        xq = quantize_act_dynamic(x2, per_token=True)       # a_scale [M, 1]
        a_q, a_scale = xq.q, xq.scale
    w_scale = w.scale.reshape(1, n)
    if _kernels(cfg):
        out = conv_pe.matmul_int8_fused(
            a_q, w.q, a_scale, w_scale, bias, act, out_scale, out_dtype,
            residual=None if residual is None else residual.reshape(m, n),
            res_scale=res_scale, mid_scale=mid_scale, add_act=add_act)
    else:
        if residual is not None:
            raise ValueError("the ref backend composes fused residuals in "
                             "the conv wrapper")
        out = ref.matmul_int8_fused(a_q, w.q, a_scale, w_scale, bias, act,
                                    out_scale=out_scale, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def linear_f(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
             act: str, cfg: EngineConfig, out_dtype=None) -> torch.Tensor:
    """Float path (calibration).  The product goes to torch.matmul, as the
    reference leaves it to XLA."""
    out_dtype = out_dtype or x.dtype
    out = x @ w.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return ref.act_fn(act)(out).to(out_dtype)


def linear(x, w, bias, act: str, cfg: EngineConfig, out_dtype=None,
           out_scale=None, residual: Optional[torch.Tensor] = None,
           res_scale: float = 1.0, mid_scale: Optional[float] = None,
           add_act: str = "none") -> torch.Tensor:
    """Dispatch on quant mode and weight container type (QTensor weights
    under w8a8 -> the int8 Conv PE path; float weights -> linear_f)."""
    if isinstance(w, QTensor) and cfg.quant == "w8a8":
        return linear_int8(x, w, bias, act, cfg,
                           out_dtype=out_dtype or torch.float32,
                           out_scale=out_scale, residual=residual,
                           res_scale=res_scale, mid_scale=mid_scale,
                           add_act=add_act)
    if isinstance(w, QTensor):
        raise ValueError("quantized weights need quant='w8a8' "
                         "(weight-only int8 is not ported)")
    if residual is not None:
        raise ValueError("fused residual epilogues require quant='w8a8' "
                         "with quantized weights")
    if isinstance(x, QTensor) or out_scale is not None:
        raise ValueError("static int8 activations / out_scale require "
                         f"quant='w8a8' with quantized weights "
                         f"(got quant={cfg.quant!r})")
    return linear_f(x, w, bias, act, cfg, out_dtype=out_dtype)


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
        if (ep.pool != "global" or residual is not None or mid is None
                or not isinstance(out_scale, (int, float, type(None)))):
            raise _slice_1b(f"the pooled epilogue {ep.stages!r} "
                            f"({'static' if static else 'dynamic'})")
        kdim = col_in.q.shape[-1]
        return conv_pe.matmul_int8_pool(
            col_in.q.reshape(n, ho * wo, kdim), wt.q, float(col_in.scale),
            wt.scale, bias, act, mid_scale=mid, out_scale=out_scale)
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
            raise _slice_1b(f"the DWC epilogue {epilogue.stages!r}")
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


def first_layer_conv(x, w, bias: Optional[torch.Tensor], stride: int,
                     padding: str, act: str, cfg: EngineConfig,
                     out_dtype=torch.float32, out_scale=None, epilogue=None,
                     residual: Optional[torch.Tensor] = None,
                     res_scale: float = 1.0) -> torch.Tensor:
    """Stage-0 conv on the Low-Channel unit.  x may be a QTensor (the
    compiled program quantizes the image with its static scale); out_scale
    requants the stem output to int8.  `epilogue` fuses an absorbed pool
    tail (ref backend); residual adds never fuse into the stem."""
    if epilogue is not None and epilogue.add:
        raise ValueError("the Low-Channel unit fuses pool tails only")
    static, quant, xin, a_scale, w_in, w_scale = _int8_operands(x, w, cfg)
    k = w_in.shape[0]
    if padding == "SAME":
        xin = pad_same(xin, k, stride)
    if epilogue is not None:
        if _kernels(cfg):
            raise _slice_1b(f"the Low-Channel pool tail {epilogue.stages!r}")
        y = ref.low_channel_conv(xin, w_in, bias, stride, act,
                                 a_scale=a_scale, w_scale=w_scale,
                                 out_dtype=torch.float32)
        return _epilogue.fused_chain(y, **_chain_kwargs(epilogue, static,
                                                        out_scale))
    if _kernels(cfg):
        return low_channel.low_channel_conv(
            xin.contiguous(), w_in, bias, stride, act, a_scale=float(a_scale),
            w_scale=w_scale, out_scale=out_scale, out_dtype=out_dtype)
    return ref.low_channel_conv(xin, w_in, bias, stride, act,
                                a_scale=a_scale, w_scale=w_scale,
                                out_scale=out_scale, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# MISC core (plain ops; their kernels come with slice 1b)
# ---------------------------------------------------------------------------

def misc_add(a: torch.Tensor, b: torch.Tensor, act: str, cfg: EngineConfig,
             sa: float = 1.0, sb: float = 1.0, out_dtype=torch.float32,
             out_scale=None) -> torch.Tensor:
    """Residual add; in a static program a/b are int8 at scales sa/sb and
    out_scale requants the sum."""
    if _kernels(cfg):
        raise _slice_1b("misc_add")
    return ref.misc_add(a, b, sa, sb, act, out_scale=out_scale,
                        out_dtype=out_dtype)


def avgpool2d(x: torch.Tensor, window: int, stride: int, cfg: EngineConfig,
              out_dtype=torch.float32) -> torch.Tensor:
    if _kernels(cfg):
        raise _slice_1b("avgpool2d")
    return ref.avgpool2d(x, window, stride, out_dtype=out_dtype)
