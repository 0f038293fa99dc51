"""State-space mixers: the mamba1 block of falcon-mamba and the RG-LRU
block of recurrentgemma (the port's copy of repro.models.ssm).

  * Both recurrences h_t = a_t * h_{t-1} + b_t are CHUNKED as in the
    reference: a sequential loop over chunks carries the state (mamba's
    h [B, di, ds], the RG-LRU's [B, w]), and inside a chunk the prefix of
    the recurrence is formed with the reference's combine `_assoc_op`,
    then applied to the carried state (h_all = acum * h + bcum).  torch
    has no `associative_scan`: the in-chunk prefix here is a left-to-right
    fold of `_assoc_op` over time (acum_t = a_t * acum_{t-1}, bcum_t =
    a_t * bcum_{t-1} + b_t, each product and sum rounded in f32).  The
    reference combines the same terms in a tree, so the two agree to f32
    rounding, not bit for bit.  The scans stay plain torch: the
    reference's are XLA's associative_scan, not Pallas kernels.
  * The temporal depthwise conv dispatches to the DWC PE
    (ops.dwc1d_causal: the CUDA kernel on backend="cuda"; silu for mamba,
    none for the RG-LRU).
  * Decode is the O(1) recurrence step on a carried state, its rolling
    conv computed inline (no DWC launch), as in the reference.
  * The RG-LRU's in_gate projection asks the int8 Conv PE for its fused
    tanh-gelu epilogue; its gates are block-diagonal f32 einsums over
    n_heads blocks of the recurrent width.

Dtypes follow the reference's JAX promotion: under w8a8 the projections
come out f32; the decode window concatenates the cached conv state (bf16
after the serving engine's merge) with the f32 new column, so the state a
decode step returns is f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig, EngineConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import act_fn
from repro_torch.models.params import ParamSpec

_silu = act_fn("silu")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _assoc_op(left, right):
    al, bl = left
    ar, br = right
    return ar * al, ar * bl + br


def _prefix(a: torch.Tensor, b: torch.Tensor):
    """In-chunk prefix of `_assoc_op` over dim 0 (time), folded left to
    right: (acum_t, bcum_t) composes steps 0..t."""
    acum, bcum = torch.empty_like(a), torch.empty_like(b)
    acum[0], bcum[0] = a[0], b[0]
    for t in range(1, a.shape[0]):
        acum[t], bcum[t] = _assoc_op((acum[t - 1], bcum[t - 1]),
                                     (a[t], b[t]))
    return acum, bcum


def mamba_dt_rank(arch: ArchConfig) -> int:
    return -(-arch.d_model // 16)


def mamba_schema(arch: ArchConfig) -> dict:
    d, di, ds = arch.d_model, arch.d_inner, arch.ssm_state
    dtr, k = mamba_dt_rank(arch), arch.conv_kernel
    return {
        "in_proj": ParamSpec((d, 2 * di)),
        "conv_w": ParamSpec((k, di), "small"),
        "conv_b": ParamSpec((di,), "zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * ds)),
        "dt_proj": ParamSpec((dtr, di)),
        "dt_bias": ParamSpec((di,), "zeros"),
        "a_log": ParamSpec((di, ds), "small"),
        "d_skip": ParamSpec((di,), "ones"),
        "out_proj": ParamSpec((di, d)),
    }


def _mamba_scan(x, dt, bmat, cmat, a_mat, d_skip, h0, chunk: int = 256):
    """x, dt: [B, L, di]; bmat, cmat: [B, L, ds]; a_mat: [di, ds];
    h0: [B, di, ds].  Returns (y [B, L, di] in x's dtype, h_last f32)."""
    bsz, l, di = x.shape
    chunk = min(chunk, l)
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk

    def tm(t):  # -> [nc, chunk, B, ...] time-major chunks
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).permute(
            1, 2, 0, *range(3, t.ndim + 1))

    xs, dts, bs, cs = tm(x), tm(dt), tm(bmat), tm(cmat)
    h = h0.to(torch.float32)
    ys = []
    for c in range(nc):
        xf = xs[c].to(torch.float32)
        dtf = dts[c].to(torch.float32)
        a = torch.exp(dtf[..., None] * a_mat[None, None])      # [Q,B,di,ds]
        bb = (dtf * xf)[..., None] * bs[c].to(torch.float32)[:, :, None, :]
        acum, bcum = _prefix(a, bb)
        h_all = acum * h[None] + bcum
        y = torch.einsum("qbds,qbs->qbd", h_all, cs[c].to(torch.float32))
        ys.append(y + d_skip[None, None] * xf)
        h = h_all[-1]
    y = torch.stack(ys).permute(2, 0, 1, 3).reshape(bsz, l, di)
    return y.to(x.dtype), h


def mamba_apply(p: dict, x: torch.Tensor, arch: ArchConfig,
                eng: EngineConfig, state: Optional[dict] = None,
                chunk: int = 256) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence mamba mixer.  x: [B, L, d].  With `state`, also
    returns the updated {conv, ssm} state for decode continuation."""
    b, l, _ = x.shape
    di, ds = arch.d_inner, arch.ssm_state
    dtr = mamba_dt_rank(arch)
    xz = ops.linear(x, p["in_proj"], None, "none", eng)
    xs, z = xz[..., :di], xz[..., di:]
    # Temporal depthwise conv -> DWC PE (paper C4).
    xs = ops.dwc1d_causal(xs, p["conv_w"], p["conv_b"], "silu", eng)
    proj = ops.linear(xs, p["x_proj"], None, "none", eng,
                      out_dtype=torch.float32)
    dt_raw, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                          proj[..., dtr + ds:])
    dt = _softplus(ops.linear(dt_raw, p["dt_proj"], None, "none", eng,
                              out_dtype=torch.float32) + p["dt_bias"])
    a_mat = -torch.exp(p["a_log"].to(torch.float32))
    h0 = (state["ssm"] if state is not None
          else torch.zeros((b, di, ds), dtype=torch.float32,
                           device=x.device))
    y, h_last = _mamba_scan(xs, dt, bmat, cmat, a_mat,
                            p["d_skip"].to(torch.float32), h0, chunk)
    y = y * _silu(z.to(torch.float32)).to(y.dtype)
    out = ops.linear(y, p["out_proj"], None, "none", eng)
    if state is None:
        return out, None
    k = arch.conv_kernel
    conv = xz[:, -(k - 1):, :di] if l >= k - 1 else state["conv"]
    return out, {"ssm": h_last, "conv": conv}


def mamba_decode(p: dict, x: torch.Tensor, arch: ArchConfig,
                 eng: EngineConfig, state: dict) -> Tuple[torch.Tensor, dict]:
    """Single-token step.  x: [B, 1, d]; state: {conv [B, k-1, di],
    ssm [B, di, ds]}."""
    di, ds = arch.d_inner, arch.ssm_state
    dtr = mamba_dt_rank(arch)
    xz = ops.linear(x, p["in_proj"], None, "none", eng)      # [B, 1, 2di]
    xs, z = xz[..., :di], xz[..., di:]
    # Rolling conv state (JAX's concatenate promotes bf16 state + f32 xs).
    wdt = torch.promote_types(state["conv"].dtype, xs.dtype)
    win = torch.cat([state["conv"].to(wdt), xs.to(wdt)], dim=1)   # [B,k,di]
    conv_out = torch.einsum("bkd,kd->bd", win.to(torch.float32),
                            p["conv_w"].to(torch.float32)) + p["conv_b"]
    xs1 = _silu(conv_out)[:, None, :].to(x.dtype)             # [B, 1, di]
    proj = ops.linear(xs1, p["x_proj"], None, "none", eng,
                      out_dtype=torch.float32)
    dt_raw, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                          proj[..., dtr + ds:])
    dt = _softplus(ops.linear(dt_raw, p["dt_proj"], None, "none", eng,
                              out_dtype=torch.float32) + p["dt_bias"])
    a_mat = -torch.exp(p["a_log"].to(torch.float32))
    a = torch.exp(dt[:, 0, :, None] * a_mat[None])
    x1 = xs1.to(torch.float32)[:, 0]
    bb = dt[:, 0, :, None] * x1[:, :, None] * bmat[:, 0, None, :]
    h = a * state["ssm"] + bb                                 # [B, di, ds]
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0]) + \
        p["d_skip"].to(torch.float32) * x1
    y = y[:, None, :] * _silu(z.to(torch.float32))
    out = ops.linear(y.to(x.dtype), p["out_proj"], None, "none", eng)
    return out, {"conv": win[:, 1:], "ssm": h}


def mamba_init_state(arch: ArchConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    return {
        "conv": torch.zeros((batch, arch.conv_kernel - 1, arch.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, arch.d_inner, arch.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_state_schema(arch: ArchConfig, batch: int,
                       dtype=torch.float32) -> dict:
    return {
        "conv": ParamSpec((batch, arch.conv_kernel - 1, arch.d_inner),
                          "zeros", dtype),
        "ssm": ParamSpec((batch, arch.d_inner, arch.ssm_state), "zeros",
                         torch.float32),
    }


# ---------------------------------------------------------------------------
# Chunked diagonal linear recurrence:  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def linear_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, L, D]; h0: [B, D].  Returns (h_all [B, L, D] in a's
    dtype, h_last f32 [B, D]): the state carried across chunks, the
    in-chunk prefix by `_prefix`."""
    bsz, l, d = a.shape
    chunk = min(chunk, l)
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk
    at = a.to(torch.float32).reshape(bsz, nc, chunk, d).permute(1, 2, 0, 3)
    bt = b.to(torch.float32).reshape(bsz, nc, chunk, d).permute(1, 2, 0, 3)
    h = h0.to(torch.float32)
    ys = []
    for c in range(nc):
        acum, bcum = _prefix(at[c], bt[c])                    # [Q, B, D]
        h_all = acum * h[None] + bcum
        ys.append(h_all)
        h = h_all[-1]
    ys = torch.stack(ys).permute(2, 0, 1, 3).reshape(bsz, l, d)
    return ys.to(a.dtype), h


# ---------------------------------------------------------------------------
# RG-LRU block (recurrentgemma / Griffin)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


def rglru_schema(arch: ArchConfig) -> dict:
    d, w, k = arch.d_model, arch.lru_width, arch.conv_kernel
    nb = arch.n_heads
    bs = w // nb
    return {
        "in_x": ParamSpec((d, w)),
        "in_gate": ParamSpec((d, w)),
        "conv_w": ParamSpec((k, w), "small"),
        "conv_b": ParamSpec((w,), "zeros"),
        "gate_in_w": ParamSpec((nb, bs, bs), "small"),
        "gate_in_b": ParamSpec((w,), "zeros"),
        "gate_rec_w": ParamSpec((nb, bs, bs), "small"),
        "gate_rec_b": ParamSpec((w,), "zeros"),
        "lam": ParamSpec((w,), "small"),
        "out_proj": ParamSpec((w, d)),
    }


def _rglru_gates(p: dict, xs: torch.Tensor, nb: int):
    """The input and recurrence gates of xs [B, L, w]: block-diagonal f32
    products over nb blocks, then sigmoid(. + bias)."""
    b, l, w = xs.shape
    xb = xs.reshape(b, l, nb, w // nb).to(torch.float32)
    gi = torch.einsum("blnh,nhk->blnk", xb,
                      p["gate_in_w"].to(torch.float32))
    gr = torch.einsum("blnh,nhk->blnk", xb,
                      p["gate_rec_w"].to(torch.float32))
    i_t = torch.sigmoid(gi.reshape(b, l, w) + p["gate_in_b"])
    r_t = torch.sigmoid(gr.reshape(b, l, w) + p["gate_rec_b"])
    return i_t, r_t


def _rglru_log_a(p: dict, r_t: torch.Tensor) -> torch.Tensor:
    return -RGLRU_C * _softplus(p["lam"].to(torch.float32)) * r_t


def rglru_apply(p: dict, x: torch.Tensor, arch: ArchConfig,
                eng: EngineConfig, state: Optional[dict] = None,
                chunk: int = 256) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence RG-LRU mixer.  x: [B, L, d].  With `state`, also
    returns the updated {rec, conv} state for decode continuation (conv:
    the in_x output's last k-1 rows, before the causal conv)."""
    b, _, _ = x.shape
    w, nb = arch.lru_width, arch.n_heads
    xs_pre = ops.linear(x, p["in_x"], None, "none", eng)
    gate = ops.linear(x, p["in_gate"], None, "gelu", eng)
    xs = ops.dwc1d_causal(xs_pre, p["conv_w"], p["conv_b"], "none", eng)
    i_t, r_t = _rglru_gates(p, xs, nb)
    a = torch.exp(_rglru_log_a(p, r_t))
    gated_x = i_t * xs.to(torch.float32)
    b_t = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated_x
    h0 = (state["rec"] if state is not None
          else torch.zeros((b, w), dtype=torch.float32, device=x.device))
    h_all, h_last = linear_scan_chunked(a, b_t, h0, chunk)
    y = (h_all.to(torch.float32) * gate.to(torch.float32)).to(x.dtype)
    out = ops.linear(y, p["out_proj"], None, "none", eng)
    if state is None:
        return out, None
    k = arch.conv_kernel
    return out, {"rec": h_last, "conv": xs_pre[:, -(k - 1):]}


def rglru_decode(p: dict, x: torch.Tensor, arch: ArchConfig,
                 eng: EngineConfig, state: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """Single-token step.  x: [B, 1, d]; state: {conv [B, k-1, w],
    rec [B, w]}."""
    nb = arch.n_heads
    xs = ops.linear(x, p["in_x"], None, "none", eng)          # [B, 1, w]
    gate = ops.linear(x, p["in_gate"], None, "gelu", eng)
    # Rolling conv state (JAX's concatenate promotes bf16 state + f32 xs).
    wdt = torch.promote_types(state["conv"].dtype, xs.dtype)
    win = torch.cat([state["conv"].to(wdt), xs.to(wdt)], dim=1)   # [B,k,w]
    conv = torch.einsum("bkw,kw->bw", win.to(torch.float32),
                        p["conv_w"].to(torch.float32)) + p["conv_b"]
    i_t, r_t = _rglru_gates(p, conv[:, None, :], nb)
    i_t, r_t = i_t[:, 0], r_t[:, 0]
    a = torch.exp(_rglru_log_a(p, r_t))
    gx = i_t * conv
    h = a * state["rec"] + torch.sqrt(torch.clamp_min(1 - a * a,
                                                      1e-12)) * gx
    y = (h[:, None, :] * gate.to(torch.float32)).to(x.dtype)
    out = ops.linear(y, p["out_proj"], None, "none", eng)
    return out, {"rec": h, "conv": win[:, 1:]}


def rglru_init_state(arch: ArchConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    return {
        "conv": torch.zeros((batch, arch.conv_kernel - 1, arch.lru_width),
                            dtype=dtype, device=device),
        "rec": torch.zeros((batch, arch.lru_width), dtype=torch.float32,
                           device=device),
    }


def rglru_state_schema(arch: ArchConfig, batch: int,
                       dtype=torch.float32) -> dict:
    return {
        "conv": ParamSpec((batch, arch.conv_kernel - 1, arch.lru_width),
                          "zeros", dtype),
        "rec": ParamSpec((batch, arch.lru_width), "zeros", torch.float32),
    }
