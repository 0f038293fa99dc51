"""Decoder-only LM: parameter and serving-cache schemas, the KV-cache
helpers, the eager mamba path and the full-sequence training forward (the
port's copy of the parts of repro.models.transformer that the LM
programs, ServeEngine and the trainer call).

Attention archs ("global" / "local" layers with a dense MLP) serve as
compiled engine programs (compiler.lower_transformer -> executor) and
train through the full-sequence `forward`, which runs every ported layer
kind.  Archs the IR does not lower serve on the reference's eager
`prefill` / `decode`; of those, mamba layers (falcon-mamba) are ported.
Recurrent (RG-LRU) layers, MoE and eager-serving attention layers raise
NotImplementedError naming the slice that brings them.

The reference writes the cache with functional JAX scatters whose
out-of-range indices are dropped (`mode="drop"`, positive sentinels).  A
torch index out of range raises on the CPU and is a device-side assert on
the card, so every store here masks its writes explicitly (`_drop_store`)
and updates the cache tensors IN PLACE (the reference returns new arrays;
the serving engine threads one cache through, so nothing keeps the old
values).  The eager mamba path is functional, like the reference: prefill
and decode return new state tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.config import ArchConfig, EngineConfig
from repro_torch.core.quant import QTensor
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamSpec, is_spec


def _ported_kind(arch: ArchConfig, i: int) -> str:
    kind = arch.layer_kind(i)
    if kind not in ("global", "local", "mamba"):
        raise NotImplementedError(
            f"{arch.name}: layer kind {kind!r} is not ported yet (the RG-LRU "
            "mixer joins with the recurrentgemma slice)")
    return kind


def _eager_kind(arch: ArchConfig, i: int) -> str:
    """The layer kind on the eager path, where only mamba is ported."""
    kind = _ported_kind(arch, i)
    if kind != "mamba":
        raise NotImplementedError(
            f"{arch.name}: eager {kind!r} attention layers are not ported "
            "yet (the recurrentgemma slice brings local ring attention to "
            "the eager path; attention archs serve through the compiled "
            "programs)")
    return kind


def check_eager(arch: ArchConfig) -> None:
    """Raise NotImplementedError unless every layer of `arch` runs on the
    ported eager path."""
    if arch.is_moe:
        raise NotImplementedError(f"{arch.name}: MoE layers are not ported")
    if arch.encoder_layers or arch.frontend or arch.mrope:
        raise NotImplementedError(f"{arch.name}: encoder-decoder and "
                                  "modality frontends are not ported")
    for i in range(arch.n_layers):
        _eager_kind(arch, i)


def block_schema(arch: ArchConfig, i: int) -> dict:
    kind = _ported_kind(arch, i)
    if arch.is_moe:
        raise NotImplementedError(f"{arch.name}: MoE layers are not ported")
    d = arch.d_model
    s: Dict[str, Any] = {"norm": ParamSpec((d,), "zeros")}
    if kind == "mamba":
        s["mixer"] = S.mamba_schema(arch)
        return s
    s["attn"] = L.attention_schema(arch)
    if arch.post_norms:
        s["post_attn_norm"] = ParamSpec((d,), "zeros")
    if arch.d_ff > 0:
        s["mlp_norm"] = ParamSpec((d,), "zeros")
        s["mlp"] = L.mlp_schema(arch)
        if arch.post_norms:
            s["post_mlp_norm"] = ParamSpec((d,), "zeros")
    return s


def lm_schema(arch: ArchConfig) -> dict:
    d, v = arch.d_model, arch.vocab_size
    s = {
        "embed": ParamSpec((v, d), "embed"),
        "blocks": [block_schema(arch, i) for i in range(arch.n_layers)],
        "final_norm": ParamSpec((d,), "zeros"),
    }
    if not arch.tie_embeddings:
        s["head"] = ParamSpec((d, v))
    return s


# ---------------------------------------------------------------------------
# Serving cache
# ---------------------------------------------------------------------------

def _kv_dtype(eng: EngineConfig) -> torch.dtype:
    if eng.kv_cache_dtype != "bf16":
        raise NotImplementedError("only the bf16 KV cache is ported")
    return torch.bfloat16


def cache_schema(arch: ArchConfig, batch: int, max_seq: int,
                 eng: EngineConfig) -> dict:
    """Dense cache schema: per layer k / v [B, S, Hkv, D] (S = the local
    window for ring layers) or a mamba layer's state (conv bf16
    [B, k-1, di], ssm f32 [B, di, ds]), plus the position."""
    kv_dt = _kv_dtype(eng)
    nkv, hd = arch.n_kv_heads, arch.head_dim
    per_layer = []
    for i in range(arch.n_layers):
        kind = _ported_kind(arch, i)
        if kind == "mamba":
            per_layer.append(S.mamba_state_schema(arch, batch,
                                                  torch.bfloat16))
            continue
        s = min(arch.local_window, max_seq) if kind == "local" else max_seq
        per_layer.append({
            "k": ParamSpec((batch, s, nkv, hd), "zeros", kv_dt),
            "v": ParamSpec((batch, s, nkv, hd), "zeros", kv_dt)})
    return {"layers": per_layer, "pos": ParamSpec((), "zeros", torch.int32)}


def num_pages(max_seq: int, page_size: int) -> int:
    """Table width: pages per slot at worst-case length."""
    return -(-max_seq // page_size)


def paged_cache_schema(arch: ArchConfig, batch: int, max_seq: int,
                       eng: EngineConfig, page_size: int,
                       num_blocks: Optional[int] = None) -> dict:
    """Block-paged cache schema: global layers keep k / v in a shared pool
    [num_blocks, page_size, Hkv, D] behind ONE block table
    cache["tables"] [B, max_pages] (block b of every layer's pool belongs
    to the same slot); local ring layers stay dense per slot.  max_seq must
    be a page multiple, so the gathered view has the dense cache's shape."""
    if max_seq % page_size:
        raise ValueError(f"max_seq={max_seq} must be a multiple of "
                         f"page_size={page_size} (round it up)")
    pages = num_pages(max_seq, page_size)
    if num_blocks is None:
        num_blocks = batch * pages
    kv_dt = _kv_dtype(eng)
    nkv, hd = arch.n_kv_heads, arch.head_dim
    per_layer = []
    for i in range(arch.n_layers):
        kind = _ported_kind(arch, i)
        if kind == "mamba":
            raise ValueError(f"{arch.name}: a paged cache holds attention "
                             "KV; mamba state stays dense")
        if kind == "local":
            s = min(arch.local_window, max_seq)
            shape = (batch, s, nkv, hd)
        else:
            shape = (num_blocks, page_size, nkv, hd)
        per_layer.append({"k": ParamSpec(shape, "zeros", kv_dt),
                          "v": ParamSpec(shape, "zeros", kv_dt)})
    return {"layers": per_layer,
            "tables": ParamSpec((batch, pages), "zeros", torch.int32),
            "pos": ParamSpec((), "zeros", torch.int32)}


def zeros_from_schema(schema, device):
    """Materialize a cache schema as zero tensors on `device`."""
    if is_spec(schema):
        return torch.zeros(schema.shape, dtype=schema.dtype, device=device)
    if isinstance(schema, dict):
        return {k: zeros_from_schema(v, device) for k, v in schema.items()}
    if isinstance(schema, (list, tuple)):
        return type(schema)(zeros_from_schema(v, device) for v in schema)
    return schema


def _drop_store(buf: torch.Tensor, index: torch.Tensor, valid: torch.Tensor,
                vals: torch.Tensor) -> None:
    """buf[index[i]] = vals[i] where valid[i]; other writes are dropped.

    `index` [n] into buf's first dim, `vals` [n, *buf.shape[1:]].  The
    dropped rows are redirected onto the first valid row's target with
    that row's value (or, with no valid row, onto entry 0 with its own
    value), so every duplicate target receives one value and the in-place
    scatter is deterministic -- with no host sync to select the rows."""
    n = buf.shape[0]
    idx = torch.clamp(index, 0, n - 1)
    vals = vals.to(buf.dtype)
    # the first valid row (row 0 if none), selected on the device: indexing
    # with a 0-d tensor would read it back to the host
    j = torch.argmax(valid.to(torch.int32)).reshape(1)
    anyv = valid.any()
    fb_idx = torch.where(anyv, idx.index_select(0, j), 0)
    fb_val = torch.where(anyv, vals.index_select(0, j), buf[:1])
    shape = (-1,) + (1,) * (vals.ndim - 1)
    tgt = torch.where(valid, idx, fb_idx)
    src = torch.where(valid.reshape(shape), vals, fb_val)
    buf[tgt] = src


def _kv_store(entry: dict, k, v, idx, eng: EngineConfig) -> dict:
    """Write k / v [B, L, Hkv, D] into a dense cache entry at position idx:
    a Python int (the prefill span, L tokens) or a [B] tensor of per-slot
    positions (one decode token per slot; positions past the cache end
    are dropped, like the reference's out-of-range scatter)."""
    entry = dict(entry)
    if isinstance(idx, torch.Tensor) and idx.ndim == 1:
        b, s = k.shape[0], entry["k"].shape[1]
        valid = idx < s
        for name, val in (("k", k), ("v", v)):
            buf = entry[name]
            rows = buf.view(b * s, *buf.shape[2:])
            flat = torch.arange(b, device=idx.device) * s + torch.clamp(
                idx.to(torch.int64), 0, s - 1)
            _drop_store(rows, flat, valid, val[:, 0])
        return entry
    idx = int(idx)
    l = k.shape[1]
    if idx < 0 or idx + l > entry["k"].shape[1]:
        raise ValueError(f"cache span [{idx}, {idx + l}) outside "
                         f"[0, {entry['k'].shape[1]})")
    for name, val in (("k", k), ("v", v)):
        entry[name][:, idx:idx + l] = val.to(entry[name].dtype)
    return entry


def _kv_read(entry: dict, eng: EngineConfig):
    _kv_dtype(eng)
    return entry["k"], entry["v"]


def _paged_flat_idx(tables: torch.Tensor, idx: torch.Tensor, page: int):
    """(flat pool index, in-table) of per-slot positions idx [B]: the
    slot's block id (from its table row) times the page size plus the
    in-page offset.  Unallocated entries hold the sentinel `num_blocks`,
    so their flat index lies past the pool and the store drops it."""
    pages = tables.shape[1]
    pidx = torch.div(idx, page, rounding_mode="floor")
    in_table = pidx < pages
    blk = torch.gather(tables, 1, torch.clamp(pidx, 0, pages - 1)[:, None]
                       .to(torch.int64))[:, 0]
    return blk.to(torch.int64) * page + idx % page, in_table


def _paged_kv_store(entry: dict, k, v, tables: torch.Tensor, idx,
                    eng: EngineConfig, page: int) -> dict:
    """Write ONE new token's k / v [B, 1, Hkv, D] into the block pool at
    per-slot positions idx ([B] or scalar), through the block table."""
    _kv_dtype(eng)
    entry = dict(entry)
    b = k.shape[0]
    idx = torch.broadcast_to(torch.as_tensor(idx, dtype=torch.int32,
                                             device=k.device), (b,))
    flat, in_table = _paged_flat_idx(tables, idx, page)
    for name, val in (("k", k), ("v", v)):
        pool = entry[name]
        fp = pool.view(-1, *pool.shape[2:])
        valid = in_table & (flat < fp.shape[0])
        _drop_store(fp, flat, valid, val[:, 0])
    return entry


def _paged_kv_read(entry: dict, tables: torch.Tensor, eng: EngineConfig):
    """Gather the slot-ordered dense view [B, pages*page, Hkv, D] of a
    block pool through the table: a pure copy, so attention over it is
    bitwise the dense cache's (positions past a slot's length hold other
    blocks' data, which the decode mask sends to exactly zero weight)."""
    from repro_torch.kernels import ops
    _kv_dtype(eng)
    return (ops.paged_gather(entry["k"], tables, eng),
            ops.paged_gather(entry["v"], tables, eng))


def _paged_prefill_store(entry: dict, k, v, tables: torch.Tensor,
                         mask: torch.Tensor, eng: EngineConfig,
                         page: int) -> dict:
    """Scatter a prefill's whole k / v span [B, L, Hkv, D] into the block
    pool through the table, rows gated by `mask` [B] (the refilled slots;
    the other rows' writes drop)."""
    _kv_dtype(eng)
    entry = dict(entry)
    b, l = k.shape[0], k.shape[1]
    pidx = torch.arange(l, device=k.device)
    blk = torch.gather(tables, 1, torch.broadcast_to(
        torch.div(pidx, page, rounding_mode="floor")[None, :], (b, l))
        .to(torch.int64)).to(torch.int64)
    flat = blk * page + (pidx % page)[None, :]                # [B, L]
    for name, val in (("k", k), ("v", v)):
        pool = entry[name]
        fp = pool.view(-1, *pool.shape[2:])
        valid = mask[:, None] & (flat < fp.shape[0])
        _drop_store(fp, flat.reshape(-1), valid.reshape(-1),
                    val.reshape(b * l, *val.shape[2:]))
    return entry


# ---------------------------------------------------------------------------
# The eager path (archs the engine IR does not lower): mamba layers
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, tokens: torch.Tensor, arch: ArchConfig,
                 dtype=torch.bfloat16) -> torch.Tensor:
    emb = params["embed"]
    idx = tokens.to(torch.int64)
    if isinstance(emb, QTensor):
        x = (emb.q[idx].to(torch.float32) * emb.scale[idx]).to(dtype)
    else:
        x = emb[idx].to(dtype)
    if arch.emb_scale:
        x = x * torch.full((), arch.d_model ** 0.5, dtype=dtype,
                           device=x.device)
    return x


def lm_logits(params: dict, x: torch.Tensor,
              arch: ArchConfig) -> torch.Tensor:
    """Logits in f32: the int8 table cast to f32 on every call, then * its
    per-column (head) or per-row (tied embedding) scale, as the reference
    does."""
    xf = x.to(torch.float32)
    if arch.tie_embeddings:
        emb = params["embed"]
        if isinstance(emb, QTensor):
            logits = xf @ emb.q.to(torch.float32).t()
            logits = logits * emb.scale.reshape(1, 1, -1)
        else:
            logits = xf @ emb.to(torch.float32).t()
    else:
        head = params["head"]
        if isinstance(head, QTensor):
            logits = xf @ head.q.to(torch.float32)
            logits = logits * head.scale.reshape(1, 1, -1)
        else:
            logits = xf @ head.to(torch.float32)
    if arch.final_softcap > 0:
        logits = torch.tanh(logits / arch.final_softcap) * arch.final_softcap
    return logits


def _mlp_half(p: dict, x: torch.Tensor, arch: ArchConfig,
              eng: EngineConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP half of an attention block: pre-norm, MLP, post-norm, the
    residual add.  Returns (x, aux) (aux 0: MoE is not ported)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" not in p:
        return x, aux
    h = L.mlp_apply(p["mlp"], L.rms_norm(x, p["mlp_norm"], arch.norm_eps),
                    arch, eng)
    if arch.post_norms:
        h = L.rms_norm(h, p["post_mlp_norm"], arch.norm_eps)
    return x + h, aux


def block_apply(p: dict, x: torch.Tensor, kind: str, arch: ArchConfig,
                eng: EngineConfig, *, cos=None, sin=None,
                state: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Tuple[Optional[dict], torch.Tensor]]:
    """One residual block, full-sequence: a mamba block (with `state`, as
    prefill runs it), or a "global" / "local" attention block with its
    post-norms and MLP half.  Returns (x, (new_state, aux))."""
    if kind == "mamba":
        h, new_state = S.mamba_apply(
            p["mixer"], L.rms_norm(x, p["norm"], arch.norm_eps), arch, eng,
            state=state)
        return x + h, (new_state, torch.zeros((), dtype=torch.float32,
                                              device=x.device))
    h = L.attention_apply(p["attn"], L.rms_norm(x, p["norm"], arch.norm_eps),
                          arch, eng, layer_kind=kind, cos=cos, sin=sin)
    if arch.post_norms:
        h = L.rms_norm(h, p["post_attn_norm"], arch.norm_eps)
    x, aux = _mlp_half(p, x + h, arch, eng)
    return x, (None, aux)


def _positions(batch: dict, b: int, l: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.broadcast_to(torch.arange(l, device=device)[None], (b, l))


def forward(params: dict, batch: dict, arch: ArchConfig, eng: EngineConfig,
            *, remat: str = "none", return_hidden: bool = False,
            compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Full-sequence logits [B, L, V] f32 and the aux loss (0 without MoE);
    with return_hidden, the final-norm hidden states instead of logits.
    Runs every ported layer kind: mamba, and the global / local attention
    blocks of the training path.

    remat "block" and "full" both wrap each block in
    torch.utils.checkpoint.checkpoint(use_reentrant=False): the backward
    recomputes the block from its input.  The math is the same as
    "none"; only what is saved differs from the reference's JAX policies
    ("block" there keeps the weight products' outputs,
    `dots_with_no_batch_dims_saveable`)."""
    if remat not in ("none", "block", "full"):
        raise ValueError(f"remat {remat!r} not in ('none', 'block', 'full')")
    if "embeds" in batch or arch.mrope:
        raise NotImplementedError(
            f"{arch.name}: the embeds frontend and M-RoPE are not ported "
            "(the qwen2-vl slice)")
    tokens = batch["tokens"]
    b, l = tokens.shape
    x = embed_tokens(params, tokens, arch, compute_dtype)
    cos, sin = L.rope_angles(_positions(batch, b, l, tokens.device),
                             arch.head_dim, arch.rope_theta)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_block(x, p, kind):
        x, (_, aux) = block_apply(p, x, kind, arch, eng, cos=cos, sin=sin)
        return x, aux

    for i, p in enumerate(params["blocks"]):
        kind = _ported_kind(arch, i)
        if remat == "none":
            x, aux = run_block(x, p, kind)
        else:
            x, aux = torch.utils.checkpoint.checkpoint(
                run_block, x, p, kind, use_reentrant=False)
        aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"], arch.norm_eps)
    if return_hidden:
        return x, aux_total
    return lm_logits(params, x, arch), aux_total


def prefill(params: dict, cache: dict, batch: dict, arch: ArchConfig,
            eng: EngineConfig, compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, fill the cache.  Returns (last-token logits
    [B, 1, V], the new cache)."""
    tokens = batch["tokens"]
    x = embed_tokens(params, tokens, arch, compute_dtype)
    new_layers = []
    for i, p in enumerate(params["blocks"]):
        x, (st, _) = block_apply(p, x, _eager_kind(arch, i), arch, eng,
                                 state=cache["layers"][i])
        new_layers.append(st)
    x = L.rms_norm(x, params["final_norm"], arch.norm_eps)
    logits = lm_logits(params, x[:, -1:], arch)
    pos = torch.full((), tokens.shape[1], dtype=torch.int32,
                     device=tokens.device)
    return logits, {"layers": new_layers, "pos": pos}


def decode(params: dict, cache: dict, tokens: torch.Tensor, arch: ArchConfig,
           eng: EngineConfig, compute_dtype=torch.bfloat16
           ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens: [B, 1].  Returns (logits [B, 1, V], the
    new cache); cache["pos"] is a scalar or a [B] vector of per-slot
    positions."""
    x = embed_tokens(params, tokens, arch, compute_dtype)
    new_layers = []
    for i, p in enumerate(params["blocks"]):
        _eager_kind(arch, i)
        hin = L.rms_norm(x, p["norm"], arch.norm_eps)
        h, st = S.mamba_decode(p["mixer"], hin, arch, eng,
                               cache["layers"][i])
        new_layers.append(st)
        x = x + h
    x = L.rms_norm(x, params["final_norm"], arch.norm_eps)
    return lm_logits(params, x, arch), {"layers": new_layers,
                                        "pos": cache["pos"] + 1}
