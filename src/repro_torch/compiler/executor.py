"""Engine-program executor (the port's copy of repro.compiler.executor):
CNN graphs (build_graph) and LM graphs (lower_transformer) run here; the
op evaluators dispatch on node kind, not on model family.

Two execution modes, selected by whether the program carries a QuantPlan:

  * dynamic (plan=None) -- every op dispatches through kernels/ops.py with
    the engine config's quant mode; with quant="none" this is the float
    path calibration observes.
  * static (plan from passes.fold_requant) -- the paper's dataflow: for a
    CNN the input image is quantized once with its calibrated scale and
    every engine consumes and emits int8 through its fused requant
    epilogue; for an LM every Conv PE GEMM consumes int8 at a static scale
    (the producing MISC op's requant epilogue), while the float-domain
    MISC work (attention, residual stream, gate product) stays f32.

LM programs come in two kinds: "forward" (prefill; `collect` receives
each AttnOp's post-RoPE (k, v) for the serving-cache fill) and "decode"
(the DecodeStep cache recurrence, run by `execute_decode`, dense or
block-paged).  The reference's verify, commit and chunk programs
(speculative decode, prefix sharing) are later slices.

Either mode consumes the program's Schedule (compiler/schedule.py) when one
is attached: ops are dispatched level by level, and every op of a level is
evaluated against the previous levels' values only, so a same-level data
dependence fails loudly.  Without a schedule the raw topological order is
used (bit-identical results either way).

Backend selection (ref / cuda) stays inside kernels/ops.py: the same
compiled program runs on either EngineConfig.  Execution runs on the device
of the input tensor; the parameter tree must live there too.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Iterable, Optional, Tuple

import torch

from repro_torch.compiler import passes as passes_lib
from repro_torch.compiler.graph import (AddOp, AttnOp, ConcatOp, ConvOp,
                                        DwcOp, EmbedOp, Graph, HeadOp,
                                        InputOp, LinearGroupOp, LinearOp,
                                        MulOp, NormOp, OpNode, PoolOp,
                                        ViewOp, build_graph, get_param,
                                        lower_transformer)
from repro_torch.compiler.passes import QuantPlan, fold_requant
from repro_torch.compiler.schedule import Schedule, level_schedule
from repro_torch.core.config import ArchConfig, CNNConfig, EngineConfig
from repro_torch.core.quant import Q4Tensor, QTensor, mul, quantize_static
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Program:
    """A compiled engine program: op graph + optional static-int8 plan and
    concurrent-dispatch schedule.  `cfg` is the frontend config the graph
    was lowered from (CNNConfig or ArchConfig).  kind="forward" runs with
    `execute`; kind="decode" (a DecodeStep program) with
    `execute_decode`."""
    graph: Graph
    cfg: Hashable
    plan: Optional[QuantPlan] = None
    schedule: Optional[Schedule] = None
    kind: str = "forward"

    @property
    def static(self) -> bool:
        return self.plan is not None


def compile_cnn(cfg: CNNConfig, scales: Optional[Dict[int, float]] = None,
                scheduled: bool = True, fuse: bool = True) -> Program:
    """Lower a CNNConfig to an engine program.

    `fuse` (default on) runs passes.fuse_epilogues, which collapses
    Conv/DWC -> {residual add, pool} chains into single launches;
    fuse=False keeps the one-op-per-launch graph (residual adds on the
    MISC core), the fused-vs-unfused parity baseline.  Without `scales` the
    program executes dynamically; with calibrated per-edge scales (keyed by
    the UNFUSED graph's node ids, which is what calibration observes, and
    remapped onto the fused graph) the requant-folding pass produces the
    static int8 plan.  The program carries the ASAP level schedule;
    `scheduled=False` dispatches in raw topological order (the same
    values)."""
    g = build_graph(cfg)
    if fuse:
        g, scales = passes_lib.fuse_epilogues(g, scales)
    plan = fold_requant(g, scales) if scales is not None else None
    sched = level_schedule(g) if scheduled else None
    return Program(g, cfg, plan, sched)


def compile_lm(arch: ArchConfig, scales: Optional[Dict[int, float]] = None,
               scheduled: bool = True, mode: str = "full", fuse: bool = True,
               page_size: int = 0) -> Program:
    """Lower a transformer ArchConfig to an engine program.

    mode "full" computes full-sequence logits; "prefill" only the last
    position's (the serving variant whose AttnOps feed the KV-cache fill
    through `collect`); "decode" is the DecodeStep program (run with
    `execute_decode`; page_size > 0 compiles the block-paged variant).
    `fuse` (default on)
    runs fuse_projections (QKV 3 -> 1, gate/up 2 -> 1 launches) and then
    fuse_epilogues (the residual adds into the O / down GEMMs); scales,
    keyed by the UNFUSED graph that calibration observes, are remapped
    through both.  With scales the program is static int8."""
    if mode not in ("full", "prefill", "decode"):
        raise ValueError(f"unknown LM program mode {mode!r}")
    if page_size and mode != "decode":
        raise ValueError("page_size applies to decode programs only")
    if mode == "decode":
        g = lower_transformer(arch, mode="decode", page_size=page_size)
    else:
        g = lower_transformer(arch, last_only=(mode == "prefill"))
    if fuse:
        g, scales = passes_lib.fuse_projections(g, scales)
        g, scales = passes_lib.fuse_epilogues(g, scales)
    plan = fold_requant(g, scales) if scales is not None else None
    sched = level_schedule(g) if scheduled else None
    return Program(g, arch, plan, sched,
                   "decode" if mode == "decode" else "forward")


def execute(program: Program, params, inputs: torch.Tensor,
            eng: EngineConfig,
            observer: Optional[Callable[[OpNode, torch.Tensor], None]] = None,
            collect: Optional[dict] = None) -> torch.Tensor:
    """Run a stateless (kind="forward") program.  `inputs` is what the
    graph's InputOp consumes: [N, H, W, C] float images (CNN) or [B, L]
    token ids (LM).  Returns f32 logits.  `collect`, when given, receives
    each AttnOp's (k, v) pair keyed by layer index (the cache fill)."""
    if program.kind == "decode":
        raise ValueError("decode programs carry cache state; run them "
                         "through execute_decode(program, params, cache, "
                         "tokens, eng)")
    with torch.inference_mode():
        return _execute(program, params, inputs, eng, observer, collect)


def _execute(program, params, inputs, eng, observer=None, collect=None,
             decode=None):
    if program.static:
        out = _run_scheduled(program, _static_eval(
            program, params, inputs, eng, collect, decode))
        return out.dequant() if isinstance(out, QTensor) else out
    return _run_scheduled(program, _dynamic_eval(
        params, inputs, eng, collect, decode), observer)


class _DecodeCtx:
    """Cache state threaded through a DecodeStep program's AttnOp updates.
    `tables` is the block table [B, max_pages] of a paged cache (None for
    dense)."""

    def __init__(self, cache: dict):
        self.cache = cache
        self.pos = cache["pos"]          # [B] per-slot positions
        self.tables = cache.get("tables")
        self.new_layers: Dict[int, dict] = {}

    def entry(self, layer: int) -> dict:
        return self.cache["layers"][layer]

    def finish(self) -> dict:
        layers = [self.new_layers.get(i, e)
                  for i, e in enumerate(self.cache["layers"])]
        out = {"layers": layers, "pos": self.pos + 1}
        if self.tables is not None:
            out["tables"] = self.tables
        return out


def execute_decode(program: Program, params, cache: dict,
                   tokens: torch.Tensor, eng: EngineConfig
                   ) -> Tuple[torch.Tensor, dict]:
    """Run a DecodeStep program: one token per slot against the KV cache.
    tokens [B, 1] int; cache: the serving cache (T.cache_schema or
    T.paged_cache_schema layout, "pos" a [B] tensor).  Returns (logits
    [B, 1, V], cache).  The cache tensors are updated in place."""
    if program.kind != "decode":
        raise ValueError(f"execute_decode needs a decode program, got "
                         f"kind={program.kind!r}")
    ctx = _DecodeCtx(cache)
    with torch.inference_mode():
        logits = _execute(program, params, tokens, eng, decode=ctx)
    return logits, ctx.finish()


# ---------------------------------------------------------------------------
# Scheduled dispatch (shared by both modes)
# ---------------------------------------------------------------------------

def _refcounts(g: Graph) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for n in g.nodes:
        for i in n.inputs:
            counts[i] = counts.get(i, 0) + 1
    return counts


def _release(vals: Dict, counts: Dict[int, int], n: OpNode, g: Graph) -> None:
    """Drop activations after their last consumer so execution keeps
    O(live edges) tensors alive, not O(all nodes)."""
    for i in n.inputs:
        counts[i] -= 1
        if counts[i] == 0 and i != g.output:
            del vals[i]


def _dispatch_waves(program: Program) -> Iterable[Tuple[OpNode, ...]]:
    """Schedule levels when present, else one op per wave in raw order."""
    g = program.graph
    if program.schedule is None:
        for n in g.nodes:
            yield (n,)
    else:
        for level in program.schedule.levels:
            yield tuple(g.nodes[i] for i in level)


def _run_scheduled(program: Program, eval_node, observer=None):
    """Evaluate the program wave by wave.  Each wave's ops read only values
    produced by earlier waves (`vals` is merged after the whole wave), so a
    schedule that co-levels dependent ops raises KeyError."""
    g = program.graph
    counts = _refcounts(g)
    vals: Dict[int, object] = {}
    for wave in _dispatch_waves(program):
        produced = [(n, eval_node(n, vals)) for n in wave]
        for n, v in produced:
            vals[n.id] = v
        for n, v in produced:
            if observer is not None:
                observer(n, v)
            _release(vals, counts, n, g)
    return vals[g.output]


# ---------------------------------------------------------------------------
# LM op evaluators (shared by both modes; the float-domain MISC work)
# ---------------------------------------------------------------------------

# Bounded cos / sin table store: repeated executes with one geometry reuse
# one table (keyed by device too).
_ROPE_TABLE_CAPACITY = 32
_rope_tables: "OrderedDict[Tuple, Tuple[torch.Tensor, torch.Tensor]]" = \
    OrderedDict()


def _rope_table(b: int, l: int, hd: int, theta: float, device):
    key = (b, l, hd, theta, str(device))
    hit = _rope_tables.get(key)
    if hit is not None:
        _rope_tables.move_to_end(key)
        return hit
    pos = torch.broadcast_to(torch.arange(l, device=device)[None], (b, l))
    val = L.rope_angles(pos, hd, theta)
    _rope_tables[key] = val
    while len(_rope_tables) > _ROPE_TABLE_CAPACITY:
        _rope_tables.popitem(last=False)
    return val


def _rope_decode_memo(pos: torch.Tensor):
    """Decode-step RoPE: angles at the slots' positions [B], one table per
    (B, head_dim, theta) per execute_decode call."""
    memo: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(b: int, hd: int, theta: float):
        key = (b, hd, theta)
        if key not in memo:
            memo[key] = L.rope_angles(pos.reshape(b, 1), hd, theta)
        return memo[key]

    return rope


def _embed_eval(n: EmbedOp, tokens: torch.Tensor, params) -> torch.Tensor:
    emb = get_param(params, n.w)
    idx = tokens.to(torch.int64)
    if isinstance(emb, QTensor):
        x = emb.q[idx].to(torch.float32) * emb.scale[idx]
    else:
        x = emb[idx].to(torch.float32)
    if n.emb_scale:
        x = mul(x, n.emb_scale)
    return x


def _split_heads(n: AttnOp, q, k, v):
    b, l = q.shape[0], q.shape[1]
    g = n.n_heads // n.n_kv_heads
    return (q.reshape(b, l, n.n_kv_heads, g, n.head_dim),
            k.reshape(b, l, n.n_kv_heads, n.head_dim),
            v.reshape(b, l, n.n_kv_heads, n.head_dim))


def _attn_eval(n: AttnOp, q, k, v, collect: Optional[dict],
               eng: EngineConfig) -> torch.Tensor:
    """AttnOp in `full` mode: RoPE, causal attention; `collect` receives
    the post-RoPE (k, v) of the layer.  On the CUDA backend a global layer
    (no window) runs the flash-attention kernel through ops.flash_mha;
    local (windowed) layers, and every layer on the ref backend, run the
    plain chunked attention of models/layers.py, as the reference does."""
    b, l = q.shape[0], q.shape[1]
    q, k, v = _split_heads(n, q, k, v)
    cos, sin = _rope_table(b, l, n.head_dim, n.rope_theta, q.device)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if collect is not None:
        collect[n.layer] = (k, v)
    if eng.backend == "cuda" and n.window == 0:
        # [B, L, Hkv, G, D] -> [B, H, L, D] (head h = kv * G + g) and back
        out = ops.flash_mha(q.permute(0, 2, 3, 1, 4).reshape(
            b, n.n_heads, l, n.head_dim), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3), eng, causal=True, softcap=n.softcap)
        return out.permute(0, 2, 1, 3).reshape(b, l, n.n_heads * n.head_dim)
    out = L.flash_attention(q, k, v, causal=True, window=n.window,
                            logit_softcap=n.softcap)
    return out.reshape(b, l, n.n_heads * n.head_dim)


def _attn_update_eval(n: AttnOp, q, k, v, rope_d, ctx: _DecodeCtx,
                      eng: EngineConfig) -> torch.Tensor:
    """AttnOp in `update` mode: write this token's (k, v) into the cache at
    each slot's position -- through the block table when n.page_size > 0
    (the read then gathers the slot-ordered view, so the attention math is
    the dense cache's) -- then attend against the cache."""
    b = q.shape[0]
    q, k, v = _split_heads(n, q, k, v)
    cos, sin = rope_d(b, n.head_dim, n.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    entry = ctx.entry(n.layer)
    ring = n.layer_kind == "local"
    if n.page_size:
        entry = T._paged_kv_store(entry, k, v, ctx.tables, ctx.pos, eng,
                                  n.page_size)
        ctx.new_layers[n.layer] = entry
        kc, vc = T._paged_kv_read(entry, ctx.tables, eng)
    else:
        idx = ctx.pos % entry["k"].shape[1] if ring else ctx.pos
        entry = T._kv_store(entry, k, v, idx, eng)
        ctx.new_layers[n.layer] = entry
        kc, vc = T._kv_read(entry, eng)
    out = L.decode_attention(q, kc, vc, ctx.pos + 1, window=n.window,
                             logit_softcap=n.softcap, ring=ring)
    return out.reshape(b, 1, n.n_heads * n.head_dim).to(torch.float32)


def _head_eval(n: HeadOp, x: torch.Tensor, params) -> torch.Tensor:
    """The logits GEMM in f32 (the int8 table cast to f32 on every call,
    as the reference does), then * the per-row scale."""
    w = get_param(params, n.w)
    xf = x.to(torch.float32)
    if n.last_only:
        xf = xf[:, -1:]
    sig = "bld,vd->blv" if n.tied else "bld,dv->blv"
    if isinstance(w, QTensor):
        logits = torch.einsum(sig, xf, w.q.to(torch.float32))
        logits = logits * w.scale.reshape(1, 1, -1)
    else:
        logits = torch.einsum(sig, xf, w.to(torch.float32))
    if n.softcap > 0:
        logits = torch.tanh(logits / n.softcap) * n.softcap
    return logits


def _attn_dispatch(n: AttnOp, q, k, v, collect, decode, rope_d, eng):
    if n.mode == "update":
        if decode is None:
            raise ValueError("update-mode AttnOps run inside execute_decode")
        return _attn_update_eval(n, q, k, v, rope_d, decode, eng)
    return _attn_eval(n, q, k, v, collect, eng)


# ---------------------------------------------------------------------------
# Dynamic mode (the float calibration path)
# ---------------------------------------------------------------------------

def _dynamic_eval(params, images, eng: EngineConfig,
                  collect: Optional[dict] = None,
                  decode: Optional[_DecodeCtx] = None):
    rope_d = _rope_decode_memo(decode.pos) if decode is not None else None

    def eval_node(n: OpNode, vals: Dict[int, torch.Tensor]) -> torch.Tensor:
        if isinstance(n, InputOp):
            return images
        if isinstance(n, (ConvOp, DwcOp)):
            w, b = get_param(params, n.w), get_param(params, n.b)
            ep = n.epilogue
            res = vals[n.inputs[-1]] if ep is not None and ep.add else None
            if isinstance(n, DwcOp):
                return ops.dwc2d(vals[n.inputs[0]], w, b, n.stride,
                                 n.padding, n.act, eng, epilogue=ep,
                                 residual=res)
            if n.first_layer:
                return ops.first_layer_conv(
                    vals[n.inputs[0]], w, b, n.stride, n.padding, n.act, eng,
                    epilogue=ep, residual=res).to(torch.float32)
            return ops.conv2d_pe(vals[n.inputs[0]], w, b, n.stride, n.padding,
                                 n.act, eng, epilogue=ep, residual=res)
        if isinstance(n, AddOp):
            return ops.misc_add(vals[n.inputs[0]], vals[n.inputs[1]], n.act,
                                eng)
        if isinstance(n, PoolOp):
            x = vals[n.inputs[0]]
            if n.pool == "global":
                return ref.global_avgpool(x)
            if n.pool == "avg":
                return ops.avgpool2d(x, n.kernel, n.stride, eng)
            return ref.maxpool2d(x, n.kernel, n.stride)
        if isinstance(n, ConcatOp):
            return torch.cat([vals[i] for i in n.inputs], dim=-1)
        if isinstance(n, LinearOp):
            w, b = get_param(params, n.w), get_param(params, n.b)
            ep = n.epilogue
            if ep is not None and ep.add:
                return ops.linear_ep(vals[n.inputs[0]], w, b, n.act, ep,
                                     vals[n.inputs[-1]], eng,
                                     out_dtype=torch.float32)
            return ops.linear(vals[n.inputs[0]], w, b, n.act, eng,
                              out_dtype=torch.float32)
        if isinstance(n, LinearGroupOp):
            return ops.linear_group(
                vals[n.inputs[0]], [get_param(params, w) for w in n.ws],
                [get_param(params, b) for b in n.bs], n.acts, eng,
                out_dtype=torch.float32)
        if isinstance(n, ViewOp):
            return vals[n.inputs[0]][n.index]
        if isinstance(n, EmbedOp):
            return _embed_eval(n, vals[n.inputs[0]], params)
        if isinstance(n, NormOp):
            return L.rms_norm(vals[n.inputs[0]], get_param(params, n.w),
                              n.eps)
        if isinstance(n, MulOp):
            return (vals[n.inputs[0]] * vals[n.inputs[1]]).to(torch.float32)
        if isinstance(n, AttnOp):
            return _attn_dispatch(n, *(vals[i] for i in n.inputs[:3]),
                                  collect, decode, rope_d, eng)
        if isinstance(n, HeadOp):
            return _head_eval(n, vals[n.inputs[0]], params)
        raise TypeError(f"unknown op {type(n).__name__}")

    return eval_node


# ---------------------------------------------------------------------------
# Static mode (calibrated end-to-end int8 dataflow)
# ---------------------------------------------------------------------------

def _require_qtensor(w, n: OpNode, path=None):
    if not isinstance(w, (QTensor, Q4Tensor)):
        raise ValueError(
            f"static program: {type(n).__name__} #{n.id} expects quantized "
            f"(QTensor / Q4Tensor) weights at "
            f"{path if path is not None else getattr(n, 'w', None)}; "
            "quantize params with core.engine.quantize_params first")
    return w


def _raw(v):
    return v.dequant() if isinstance(v, QTensor) else v


def _scaled(v):
    return (v.q, float(v.scale)) if isinstance(v, QTensor) else (v, 1.0)


def _static_eval(program: Program, params, images, eng: EngineConfig,
                 collect: Optional[dict] = None,
                 decode: Optional[_DecodeCtx] = None):
    plan = program.plan
    rope_d = _rope_decode_memo(decode.pos) if decode is not None else None

    def q_or_raw(r, os):
        """A float-domain op's requant epilogue: int8 when the plan carries
        the edge int8 (all consumers are GEMM engines), f32 otherwise."""
        return r if os is None else QTensor(quantize_static(r, os), os)

    def eval_node(n: OpNode, vals: Dict[int, object]):
        os = plan.out_scale[n.id] if plan.emit_int8[n.id] else None
        if isinstance(n, InputOp):
            # One static quantization at the boundary (token ids pass raw).
            return q_or_raw(images, os)
        if isinstance(n, (ConvOp, DwcOp)):
            w = _require_qtensor(get_param(params, n.w), n)
            b = get_param(params, n.b)
            ep = n.epilogue
            res, res_s = None, 1.0
            if ep is not None and ep.add:
                res, res_s = _scaled(vals[n.inputs[-1]])
            if isinstance(n, DwcOp):
                fn = ops.dwc2d
            else:
                fn = ops.first_layer_conv if n.first_layer else ops.conv2d_pe
            out = fn(vals[n.inputs[0]], w, b, n.stride, n.padding, n.act, eng,
                     out_scale=os, epilogue=ep, residual=res, res_scale=res_s)
            return QTensor(out, os)
        if isinstance(n, AddOp):
            # CNN adds see two int8 edges; an unfused LM add sees the f32
            # stream and the block's GEMM output.
            a, sa = _scaled(vals[n.inputs[0]])
            b, sb = _scaled(vals[n.inputs[1]])
            out = ops.misc_add(a, b, n.act, eng, sa=sa, sb=sb, out_scale=os)
            return QTensor(out, os) if os is not None else out
        if isinstance(n, PoolOp):
            x = vals[n.inputs[0]]
            if n.pool == "max":
                # Order-preserving on int8: values and scale pass through.
                return QTensor(ref.maxpool2d(x.q, n.kernel, n.stride), os)
            if n.pool == "global":
                # Sum in int32 like every engine accumulator, then one fused
                # scale + requant -- no f32 map materialized.
                acc = x.q.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)
                px = x.q.shape[1] * x.q.shape[2]
            else:
                acc = ref.window_sum(x.q.to(torch.int32), n.kernel, n.stride)
                px = n.kernel ** 2
            r = mul(acc.to(torch.float32), float(x.scale) / px)
            return QTensor(quantize_static(r, os), os) if os is not None else r
        if isinstance(n, ConcatOp):
            parts = []
            for i in n.inputs:
                xi = vals[i]
                if xi.scale == os:            # requant folded into producer
                    parts.append(xi.q)
                else:                         # MISC-side int8->int8 rescale
                    parts.append(_rescale_int8(xi.q, float(xi.scale), os))
            return QTensor(torch.cat(parts, dim=-1), os)
        if isinstance(n, LinearOp):
            w = _require_qtensor(get_param(params, n.w), n)
            b = get_param(params, n.b)
            x = vals[n.inputs[0]]
            ep = n.epilogue
            if ep is not None and ep.add:
                res, res_s = _scaled(vals[n.inputs[-1]])
                out = ops.linear_ep(x, w, b, n.act, ep, res, eng,
                                    res_scale=res_s, out_scale=os,
                                    out_dtype=torch.float32)
            else:
                out = ops.linear(x, w, b, n.act, eng,
                                 out_dtype=torch.float32, out_scale=os)
            return QTensor(out, os) if os is not None else out
        if isinstance(n, LinearGroupOp):
            # One launch, a tuple value; the member edges stay f32 (their
            # consumers are float-domain MISC ops).
            ws = [_require_qtensor(get_param(params, p), n, p) for p in n.ws]
            return ops.linear_group(vals[n.inputs[0]], ws,
                                    [get_param(params, b) for b in n.bs],
                                    n.acts, eng, out_dtype=torch.float32)
        if isinstance(n, ViewOp):
            return vals[n.inputs[0]][n.index]
        if isinstance(n, EmbedOp):
            return q_or_raw(_embed_eval(n, _raw(vals[n.inputs[0]]), params),
                            os)
        if isinstance(n, NormOp):
            # f32 norm math; the requant epilogue hands the consumer GEMMs
            # their static-int8 activations.
            return q_or_raw(L.rms_norm(_raw(vals[n.inputs[0]]),
                                       get_param(params, n.w), n.eps), os)
        if isinstance(n, MulOp):
            return q_or_raw((_raw(vals[n.inputs[0]])
                             * _raw(vals[n.inputs[1]])).to(torch.float32),
                            os)
        if isinstance(n, AttnOp):
            return q_or_raw(_attn_dispatch(
                n, *(_raw(vals[i]) for i in n.inputs[:3]), collect, decode,
                rope_d, eng), os)
        if isinstance(n, HeadOp):
            return _head_eval(n, _raw(vals[n.inputs[0]]), params)
        raise TypeError(f"unknown op {type(n).__name__}")

    return eval_node


def _rescale_int8(q: torch.Tensor, s_in: float, s_out: float) -> torch.Tensor:
    """int8 -> int8 rescale without an f32 tensor between engines."""
    r = torch.round(mul(q.to(torch.float32), s_in / s_out))
    return torch.clamp(r, -127, 127).to(torch.int8)
