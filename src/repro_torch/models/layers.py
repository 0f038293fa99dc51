"""Transformer building blocks (the port's copy of the pieces of
repro.models.layers that the compiled LM programs, the eager serving path
and the float training forward call).

RMS norm, RoPE, the chunked online-softmax ("flash") attention the prefill
AttnOps, the eager prefill and the training forward run, the single-token
decode attention, and the attention / MLP parameter schemas and layers
(`attention_apply`, `attention_kv`, `attention_decode`, `mlp_apply`),
whose projections go through ops.linear (on float weights the float Conv
PE GEMM on backend="cuda").  As in the reference these are plain tensor
code (the reference's `layers.flash_attention` is pure JAX, not its
Pallas kernel), in f32, with the reference's block structure and
operation order.  GQA is
computed in grouped form: q [B, L, Hkv, G, D] against k/v [B, S, Hkv, D].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ArchConfig, EngineConfig
from repro_torch.kernels import flash_attn, ops
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)
            * (1.0 + scale.to(torch.float32))).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, L] -> cos, sin [B, L, head_dim] (f32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                          device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * inv_freq[None, None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, L, ..., head_dim]; cos/sin: [B, L, head_dim]."""
    while cos.ndim < x.ndim:
        cos = cos[:, :, None]
        sin = sin[:, :, None]
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = 512) -> torch.Tensor:
    """Online-softmax attention over q [B, L, Hkv, G, D] and k, v
    [B, S, Hkv, D], block by block like the reference (queries in blocks
    of `block_q`, keys in chunks of `flash_attn.kv_chunk(S)`, padded keys
    masked).  The CUDA flash-attention kernel takes the same key chunks,
    so the two backends' prefill attention keeps one op order."""
    b, l, hkv, g, d = q.shape
    s = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    bq = min(block_q, _round_up(l, 128))
    bkv = flash_attn.kv_chunk(s)
    lp, sp = _round_up(l, bq), _round_up(s, bkv)
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, lp - l))
    kp = F.pad(k, (0, 0, 0, 0, 0, sp - s))
    vp = F.pad(v, (0, 0, 0, 0, 0, sp - s))
    nq, nkv = lp // bq, sp // bkv
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qp[:, qi * bq:(qi + 1) * bq].to(torch.float32)
        qpos = qi * bq + torch.arange(bq, device=dev) + q_offset
        if window > 0:
            wsize = min(sp, _round_up(window + bq, bkv))
            start = min(max(qi * bq + q_offset - (window - 1), 0),
                        sp - wsize)
            kw, vw = kp[:, start:start + wsize], vp[:, start:start + wsize]
            kpos0, nb = start, wsize // bkv
        else:
            kw, vw, kpos0, nb = kp, vp, 0, nkv
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32,
                          device=dev)
        for ki in range(nb):
            kb = kw[:, ki * bkv:(ki + 1) * bkv].to(torch.float32)
            vb = vw[:, ki * bkv:(ki + 1) * bkv].to(torch.float32)
            st = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            if logit_softcap > 0:
                st = logit_softcap * torch.tanh(st / logit_softcap)
            kpos = kpos0 + ki * bkv + torch.arange(bkv, device=dev)
            mask = kpos[None, :] < s
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            st = torch.where(mask[None, None, None], st, NEG_INF)
            m2 = torch.maximum(m, st.amax(dim=-1))
            p = torch.exp(st - m2[..., None])
            alpha = torch.exp(m - m2)
            lsum = lsum * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bhgqk,bkhd->bhgqd", p, vb))
            m = m2
        lsafe = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
        out = acc / lsafe[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B, bq, Hkv, G, D]
    out = torch.cat(outs, dim=1)
    return out[:, :l].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *, window: int = 0,
                     logit_softcap: float = 0.0,
                     scale: Optional[float] = None,
                     ring: bool = False) -> torch.Tensor:
    """Single-token attention against a cache.  q [B, 1, Hkv, G, D];
    k_cache / v_cache [B, S, Hkv, D]; length: valid entries (this token
    included), a scalar or [B] per slot; ring: the cache is a ring buffer
    of its size (local layers)."""
    b = q.shape[0]
    d = q.shape[-1]
    s = k_cache.shape[1]
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    st = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                      k_cache.to(torch.float32)) * scale
    if logit_softcap > 0:
        st = logit_softcap * torch.tanh(st / logit_softcap)
    kpos = torch.arange(s, device=dev)
    lb = torch.as_tensor(length, device=dev)
    lb = lb.reshape(1) if lb.ndim == 0 else lb                # [1] or [B]
    if ring:
        valid = kpos[None, :] < torch.clamp(lb, max=s)[:, None]
    else:
        valid = kpos[None, :] < lb[:, None]
        if window > 0:
            valid = valid & (kpos[None, :] > (lb - 1 - window)[:, None])
    st = torch.where(valid[:, None, None, None, :], st, NEG_INF)
    m = st.amax(dim=-1, keepdim=True)
    p = torch.exp(st - m)
    lsum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / lsum,
                       v_cache.to(torch.float32))
    return out.to(q.dtype)


def attention_schema(arch: ArchConfig) -> dict:
    d, hd = arch.d_model, arch.head_dim
    nh, nkv = arch.n_heads, arch.n_kv_heads
    s = {
        "wq": ParamSpec((d, nh * hd)),
        "wk": ParamSpec((d, nkv * hd)),
        "wv": ParamSpec((d, nkv * hd)),
        "wo": ParamSpec((nh * hd, d)),
    }
    if arch.qkv_bias:
        s["bq"] = ParamSpec((nh * hd,), "zeros")
        s["bk"] = ParamSpec((nkv * hd,), "zeros")
        s["bv"] = ParamSpec((nkv * hd,), "zeros")
    return s


def attention_apply(p: dict, x: torch.Tensor, arch: ArchConfig,
                    eng: EngineConfig, *, layer_kind: str, cos: torch.Tensor,
                    sin: torch.Tensor, q_offset: int = 0,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (the training forward and the eager
    prefill): separate q / k / v projections with their biases, RoPE, the
    chunked `flash_attention` (plain torch, differentiable; local layers
    pass their window, and the arch's logit softcap rides along), the O
    projection.  `kv_override`: k / v already projected and rotated
    (`attention_kv`, which the eager prefill also stores in the cache).
    Returns [B, L, d]."""
    b, l, _ = x.shape
    nh, nkv, hd = arch.n_heads, arch.n_kv_heads, arch.head_dim
    g = nh // nkv
    q = ops.linear(x, p["wq"], p.get("bq"), "none", eng)
    q = q.reshape(b, l, nkv, g, hd)
    if kv_override is None:
        k, v = attention_kv(p, x, arch, eng, cos, sin)
    else:
        k, v = kv_override
    if cos is not None:
        q = apply_rope(q, cos, sin)
    window = arch.local_window if layer_kind == "local" else 0
    out = flash_attention(q, k, v, causal=causal, window=window,
                          logit_softcap=arch.attn_softcap, q_offset=q_offset)
    return ops.linear(out.reshape(b, l, nh * hd), p["wo"], None, "none", eng)


def attention_kv(p: dict, x: torch.Tensor, arch: ArchConfig,
                 eng: EngineConfig, cos, sin
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k / v [B, L, Hkv, D] projected, k rotated (the cache fill)."""
    b, l, _ = x.shape
    nkv, hd = arch.n_kv_heads, arch.head_dim
    k = ops.linear(x, p["wk"], p.get("bk"), "none", eng).reshape(b, l, nkv,
                                                                 hd)
    v = ops.linear(x, p["wv"], p.get("bv"), "none", eng).reshape(b, l, nkv,
                                                                 hd)
    if cos is not None:
        k = apply_rope(k, cos, sin)
    return k, v


def attention_decode(p: dict, x: torch.Tensor, arch: ArchConfig,
                     eng: EngineConfig, *, layer_kind: str,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, length,
                     cos, sin, ring: bool = False) -> torch.Tensor:
    """One token's attention on the eager path: the q projection and
    RoPE, `decode_attention` against the cache (holding this token's k /
    v already; `ring` for a local layer's ring buffer), the O projection.
    x: [B, 1, d]; returns [B, 1, d]."""
    b = x.shape[0]
    nh, nkv, hd = arch.n_heads, arch.n_kv_heads, arch.head_dim
    g = nh // nkv
    q = ops.linear(x, p["wq"], p.get("bq"), "none", eng).reshape(
        b, 1, nkv, g, hd)
    if cos is not None:
        q = apply_rope(q, cos, sin)
    window = arch.local_window if layer_kind == "local" else 0
    out = decode_attention(q, k_cache, v_cache, length, window=window,
                           logit_softcap=arch.attn_softcap, ring=ring)
    return ops.linear(out.reshape(b, 1, nh * hd), p["wo"], None, "none",
                      eng)


def mlp_schema(arch: ArchConfig) -> dict:
    d, ff = arch.d_model, arch.d_ff
    s = {"wu": ParamSpec((d, ff)), "wd": ParamSpec((ff, d))}
    if arch.mlp_gated:
        s["wg"] = ParamSpec((d, ff))
    return s


def mlp_apply(p: dict, x: torch.Tensor, arch: ArchConfig,
              eng: EngineConfig) -> torch.Tensor:
    """SwiGLU / GeGLU (or a plain up / act / down): the act rides the
    gate (or up) projection's fused epilogue, as on the Conv PE."""
    if arch.mlp_gated:
        gate = ops.linear(x, p["wg"], None, arch.mlp_act, eng)
        up = ops.linear(x, p["wu"], None, "none", eng)
        h = (gate * up).to(x.dtype)
    else:
        h = ops.linear(x, p["wu"], None, arch.mlp_act, eng).to(x.dtype)
    return ops.linear(h, p["wd"], None, "none", eng)
