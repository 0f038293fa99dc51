"""State-space mixer: the mamba1 block of falcon-mamba (the port's copy of
the mamba half of repro.models.ssm; RG-LRU joins with recurrentgemma).

  * The selective scan is CHUNKED as in the reference: a sequential loop
    over chunks carries the state h [B, di, ds], and inside a chunk the
    prefix of the recurrence h_t = a_t * h_{t-1} + b_t is formed with the
    reference's combine `_assoc_op`, then applied to the carried state
    (h_all = acum * h + bcum).  torch has no `associative_scan`: the
    in-chunk prefix here is a left-to-right fold of `_assoc_op` over time
    (acum_t = a_t * acum_{t-1}, bcum_t = a_t * bcum_{t-1} + b_t, each
    product and sum rounded in f32).  The reference combines the same
    terms in a tree, so the two agree to f32 rounding, not bit for bit.
  * The temporal depthwise conv dispatches to the DWC PE
    (ops.dwc1d_causal: the CUDA kernel on backend="cuda").
  * Decode is the O(1) recurrence step on a carried state, its rolling
    conv computed inline (no DWC launch), as in the reference.

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
