"""Plain PyTorch reference ops (the port's copy of repro.kernels.ref).

These define the semantics the CUDA kernels must match bit for bit, and
they are the "ref" backend.  Operation order is the reference's exactly:
`acc.f32 * a_scale * w_scale + bias`, act, then `clip(round(x / s))`.
Every divisor is a float32 tensor on the operand's device (core.quant.div),
and integer products accumulate exactly (float64 is exact here: |acc| <=
K * 127^2 < 2^53).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import Scale, div, mul, qdq_codes, unpack_int4


# ---------------------------------------------------------------------------
# Activations (the NL core's menu, Section IV-B2)
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACTS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "relu2": lambda x: torch.square(torch.relu(x)),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "hardswish": F.hardswish,
}


def act_fn(name: str):
    return ACTS[name]


def _requant(x: torch.Tensor, out_scale: Optional[Scale], out_dtype):
    if out_scale is not None:
        return qdq_codes(x, out_scale).to(torch.int8)
    return x.to(out_dtype)


def taps(x: torch.Tensor, k: int, stride: int, ho: int, wo: int):
    """(kh, kw, strided [N, Ho, Wo, C] window slice) over a padded NHWC x."""
    for kh in range(k):
        for kw in range(k):
            yield kh, kw, x[:, kh:kh + (ho - 1) * stride + 1:stride,
                            kw:kw + (wo - 1) * stride + 1:stride, :]


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product on any device."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


# ---------------------------------------------------------------------------
# C2: Conv PE -- int8 GEMM + fused NL epilogue
# ---------------------------------------------------------------------------

def matmul_int8_fused(a_q: torch.Tensor, b_q: torch.Tensor,
                      a_scale: Scale, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: str = "none",
                      out_scale: Optional[Scale] = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """out = requant(act(dequant(a_q @ b_q) + bias)).

    a_q int8 [M, K]; a_scale f32 [M, 1] (per-token) or a scalar;
    b_q int8 [K, N]; w_scale f32 [1, N]; bias f32 [N] or None;
    out_scale None (float out), a scalar, or a [1, N] vector (int8 out).
    """
    acc = int_matmul(a_q, b_q)
    x = mul(mul(acc.to(torch.float32), a_scale), w_scale)
    if bias is not None:
        x = x + bias
    return _requant(act_fn(act)(x), out_scale, out_dtype)


def int4_group_dot(a_q: torch.Tensor, codes: torch.Tensor,
                   w_scale: torch.Tensor, w_zero: torch.Tensor
                   ) -> torch.Tensor:
    """The int4 weight-only MAC the Conv PE runs in registers.

    a_q int8 [M, K]; codes [K, N] in [0, 15]; w_scale / w_zero [G, N]
    (K = G * gs).  Per-group int32 partial sums are exact; the f32 combine
    runs in a FIXED order, group by group:

        acc_s = (((p_0 * s_0) + p_1 * s_1) + ...)     p_g = a_g . codes_g
        acc_z = (((r_0 * z_0) + r_1 * z_1) + ...)     r_g = sum(a_g)
        out   = acc_s + acc_z

    every product and sum rounded to f32 -- the order the CUDA kernel
    (csrc/conv_pe_w4.cu) keeps with explicitly rounded intrinsics, so the
    two agree bit for bit.  The reference's jnp version sums the groups in
    an order XLA picks (`ref.int4_group_dot`); this one lies within an
    ulp-level tolerance of it."""
    m, k = a_q.shape
    g, n = w_scale.shape
    gs = k // g
    ag = a_q.reshape(m, g, gs)
    part = torch.bmm(ag.to(torch.float64).permute(1, 0, 2),
                     codes.reshape(g, gs, n).to(torch.float64)
                     ).to(torch.int32)                        # [G, M, N]
    asum = ag.to(torch.int32).sum(dim=-1, dtype=torch.int32)  # [M, G]
    # every group's two products (each rounded once), then the two sums
    # advanced side by side, one group at a time
    prods = torch.stack([
        part.to(torch.float32) * w_scale.to(torch.float32)[:, None, :],
        asum.t().to(torch.float32)[:, :, None]
        * w_zero.to(torch.float32)[:, None, :]], dim=1)       # [G, 2, M, N]
    acc = torch.zeros((2, m, n), dtype=torch.float32, device=a_q.device)
    for gi in range(g):
        acc = acc + prods[gi]
    return acc[0] + acc[1]


def matmul_int4_fused(a_q: torch.Tensor, b_packed: torch.Tensor,
                      a_scale: Scale, w_scale: torch.Tensor,
                      w_zero: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: str = "none", out_scale: Optional[Scale] = None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Int4 weight-only GEMM: unpack -> group dot -> * a_scale -> + bias ->
    act -> requant.  a_q int8 [M, K], a_scale [M, 1] or a scalar;
    b_packed uint8 [K//2, N] with w_scale / w_zero [G, N]."""
    x = mul(int4_group_dot(a_q, unpack_int4(b_packed), w_scale, w_zero),
            a_scale)
    if bias is not None:
        x = x + bias
    return _requant(act_fn(act)(x), out_scale, out_dtype)


def matmul_f_fused(a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, act: str = "none",
                   out_dtype=torch.float32) -> torch.Tensor:
    """The float Conv PE GEMM (the reference's `_kernel_f`): A and B widened
    to f32, the f32 product, + the f32 bias, the act in f32, then the cast
    to out_dtype -- the Pallas kernel's epilogue order."""
    x = a.to(torch.float32) @ b.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    return act_fn(act)(x).to(out_dtype)


# ---------------------------------------------------------------------------
# C4: DWC PE -- depthwise convolution, NHWC
# ---------------------------------------------------------------------------

def dwc2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          stride: int = 1, act: str = "none",
          a_scale: Optional[Scale] = None,
          w_scale: Optional[torch.Tensor] = None,
          out_scale: Optional[Scale] = None,
          out_dtype=torch.float32) -> torch.Tensor:
    """Depthwise conv on a pre-padded input (VALID semantics).

    x [N, H, W, C] (int8 or float), w [k, k, C], bias [C].  Quantized mode
    when a_scale/w_scale are given (int8 x int8 -> int32)."""
    k = w.shape[0]
    n, h, wd, c = x.shape
    ho = (h - k) // stride + 1
    wo = (wd - k) // stride + 1
    quant = a_scale is not None
    acc_dtype = torch.int32 if quant else torch.float32
    acc = torch.zeros((n, ho, wo, c), dtype=acc_dtype, device=x.device)
    for kh, kw, xs in taps(x, k, stride, ho, wo):
        acc = acc + xs.to(acc_dtype) * w[kh, kw, :].to(acc_dtype)
    xf = mul(mul(acc.to(torch.float32), a_scale), w_scale) if quant else acc
    if bias is not None:
        xf = xf + bias
    return _requant(act_fn(act)(xf), out_scale, out_dtype)


def dwc1d_causal(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, act: str = "none",
                 out_dtype=torch.float32) -> torch.Tensor:
    """Causal depthwise temporal conv (the mamba / RG-LRU frontend).

    x [B, L, C] float, w [k, C], bias [C].  The taps add in order,
    `acc + x * w` in f32 over a zero causal pad, then the bias, then the
    act."""
    k = w.shape[0]
    l = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        acc = acc + xp[:, i:i + l, :].to(torch.float32) * w[i].to(
            torch.float32)
    if bias is not None:
        acc = acc + bias
    return act_fn(act)(acc).to(out_dtype)


# ---------------------------------------------------------------------------
# C5: Low-Channel Conv Unit -- first-layer conv (small IC)
# ---------------------------------------------------------------------------

def low_channel_conv(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int,
                     act: str = "none",
                     a_scale: Optional[Scale] = None,
                     w_scale: Optional[torch.Tensor] = None,
                     out_scale: Optional[Scale] = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Standard conv on pre-padded input (VALID), small IC.

    x [N, H, W, IC], w [k, k, IC, OC], bias [OC].  Each tap is a
    [pixels, IC] x [IC, OC] product accumulated in tap order."""
    k = w.shape[0]
    n, h, wd, ic = x.shape
    oc = w.shape[-1]
    ho = (h - k) // stride + 1
    wo = (wd - k) // stride + 1
    quant = a_scale is not None
    acc_dtype = torch.int32 if quant else torch.float32
    acc = torch.zeros((n, ho, wo, oc), dtype=acc_dtype, device=x.device)
    for kh, kw, xs in taps(x, k, stride, ho, wo):
        if quant:
            tap = int_matmul(xs.reshape(-1, ic), w[kh, kw])
        else:
            tap = xs.reshape(-1, ic).to(torch.float32) @ w[kh, kw].to(
                torch.float32)
        acc = acc + tap.reshape(n, ho, wo, oc)
    xf = acc.to(torch.float32)
    if quant:
        xf = mul(mul(xf, a_scale), w_scale)
    if bias is not None:
        xf = xf + bias
    return _requant(act_fn(act)(xf), out_scale, out_dtype)


# ---------------------------------------------------------------------------
# C6: MISC core -- elementwise / pooling
# ---------------------------------------------------------------------------

def misc_add(a: torch.Tensor, b: torch.Tensor, sa: Scale = 1.0,
             sb: Scale = 1.0, act: str = "none",
             out_scale: Optional[Scale] = None,
             out_dtype=torch.float32) -> torch.Tensor:
    x = mul(a.to(torch.float32), sa) + mul(b.to(torch.float32), sb)
    return _requant(act_fn(act)(x), out_scale, out_dtype)


def window_sum(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID k x k window sum over NHWC in x's dtype, in tap order."""
    ho = (x.shape[1] - window) // stride + 1
    wo = (x.shape[2] - window) // stride + 1
    acc = None
    for _, _, xs in taps(x, window, stride, ho, wo):
        acc = xs if acc is None else acc + xs
    return acc


def avgpool2d(x: torch.Tensor, window: int, stride: int,
              out_dtype=torch.float32) -> torch.Tensor:
    """[N, H, W, C] average pool, VALID."""
    s = window_sum(x.to(torch.float32), window, stride)
    return div(s, float(window * window)).to(out_dtype)


def maxpool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID max pool; on int8 values the comparator works on the codes."""
    ho = (x.shape[1] - window) // stride + 1
    wo = (x.shape[2] - window) // stride + 1
    out = None
    for _, _, xs in taps(x, window, stride, ho, wo):
        out = xs if out is None else torch.maximum(out, xs)
    return out


def global_avgpool(x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    return x.to(torch.float32).mean(dim=(1, 2)).to(out_dtype)



# ---------------------------------------------------------------------------
# Attention oracle (the flash-attention kernel's plain version)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              logit_softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Lq, D], k/v: [B, Hkv, Lk, D] (GQA by head repetition).
    The causal mask is end-aligned (query i sits at position i + Lk - Lq);
    masked logits are -1e30."""
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if logit_softcap > 0:
        logits = softcap(logits, logit_softcap)
    lk = k.shape[2]
    dev = q.device
    qpos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
    kpos = torch.arange(lk, device=dev)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Paged KV cache gather (LM serving)
# ---------------------------------------------------------------------------

def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool [N, P, ...] + block table [B, M] -> the slot-ordered dense view
    [B, M*P, ...]: a pure copy.  Table entries are clipped into [0, N-1]
    (sentinel entries read SOME block, whose positions the decode mask
    discards)."""
    n, p = pool.shape[0], pool.shape[1]
    b, m = tables.shape
    blk = torch.clamp(tables.to(torch.int64), 0, n - 1)
    flat = (blk[..., None] * p + torch.arange(p, device=pool.device)
            [None, None, :]).reshape(b, m * p)
    return pool.reshape((n * p,) + tuple(pool.shape[2:]))[flat]
