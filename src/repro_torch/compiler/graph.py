"""Typed op-graph IR (the port's copy of repro.compiler.graph).

A flat, topologically ordered tuple of typed op nodes, each naming its
input edges (producer node ids) and the parameter-tree paths it reads.
Two frontends lower into it: `build_graph(CNNConfig)` for the paper's CNN
zoo and `lower_transformer(ArchConfig)` for LM prefill and decode.

Node kinds and the engine that executes them:

  ConvOp    -> Conv PE (im2col GEMM; `first_layer=True` routes the stem to
               the Low-Channel Conv Unit; may carry a fused `Epilogue`)
  DwcOp     -> DWC PE (same optional fused `Epilogue`)
  AddOp     -> MISC core (residual add + NL epilogue)
  PoolOp    -> MISC core ("max" | "avg" | "global")
  ConcatOp  -> bank interleave (channel concat; free at the memory level)
  LinearOp  -> Conv PE (classifier head / LM projection GEMM; may carry a
               fused residual-add `Epilogue`)
  LinearGroupOp -> Conv PE (one launch, several outputs: the fused Q/K/V
               and gate/up groups of passes.fuse_projections)
  ViewOp    -> memory level (one member of a LinearGroupOp's tuple)
  MulOp     -> MISC core (elementwise gate, SwiGLU)
  NormOp    -> MISC core (RMS norm + requant epilogue)
  AttnOp    -> MISC core (RoPE + attention between the GEMMs)
  EmbedOp   -> memory level (token-row gather)
  HeadOp    -> Conv PE (the LM logits GEMM, tied or untied)
  InputOp   -> the program input placeholder (edge 0: image or token ids)

A node's id doubles as the id of its output edge, so per-edge metadata
(calibrated activation scales) is keyed by node id.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.config import ArchConfig, CNNConfig

# A path into the params tree, e.g. ("stages", 2, 0, "w1").
ParamPath = Tuple


@dataclass(frozen=True)
class OpNode:
    id: int
    inputs: Tuple[int, ...]


@dataclass(frozen=True)
class Epilogue:
    """An in-kernel tail fused into a Conv PE / DWC PE launch.

    `passes.fuse_epilogues` collapses Conv/DWC -> {residual Add, pool tail}
    chains into one fused node carrying this spec, so the whole chain is a
    single engine launch.  add=True appends the residual operand as the
    node's LAST input edge; `add_act` is the absorbed AddOp's act.  `pool`
    is an absorbed tail pool ("avg" | "global" | "max").

    `mid_scale` / `add_scale` are the static-plan interior requant points:
    the scales the absorbed conv / add output edges carried in the unfused
    graph.  The fused kernel quantize-dequantizes at exactly those points,
    so fused static execution is bit-identical to the unfused program.
    0.0 = dynamic program (no static plan; the chain stays f32).
    """
    add: bool = False
    add_act: str = "none"
    pool: str = "none"               # none | avg | global | max
    pool_kernel: int = 0
    pool_stride: int = 0
    mid_scale: float = 0.0           # absorbed conv/dwc output edge scale
    add_scale: float = 0.0           # absorbed add output edge scale
                                     # (set only when a pool follows the add)

    @property
    def stages(self) -> str:
        """Human-readable chain, e.g. "add+relu|global"."""
        parts = []
        if self.add:
            parts.append("add" if self.add_act == "none"
                         else f"add+{self.add_act}")
        if self.pool != "none":
            parts.append(self.pool)
        return "|".join(parts)


@dataclass(frozen=True)
class InputOp(OpNode):
    pass


@dataclass(frozen=True)
class ConvOp(OpNode):
    w: ParamPath = ()
    b: Optional[ParamPath] = None
    stride: int = 1
    padding: str = "SAME"
    act: str = "none"
    first_layer: bool = False        # route through the Low-Channel unit
    epilogue: Optional[Epilogue] = None   # fused MISC tail (fuse_epilogues)


@dataclass(frozen=True)
class DwcOp(OpNode):
    w: ParamPath = ()
    b: Optional[ParamPath] = None
    stride: int = 1
    padding: str = "SAME"
    act: str = "none"
    epilogue: Optional[Epilogue] = None   # fused MISC tail (fuse_epilogues)


@dataclass(frozen=True)
class AddOp(OpNode):
    act: str = "none"


@dataclass(frozen=True)
class PoolOp(OpNode):
    pool: str = "max"                # max | avg | global
    kernel: int = 2
    stride: int = 2


@dataclass(frozen=True)
class ConcatOp(OpNode):
    pass                             # channel (last-axis) concat


@dataclass(frozen=True)
class LinearOp(OpNode):
    """Classifier / LM projection GEMM on the Conv PE.  After
    passes.fuse_epilogues it may absorb a residual-add tail (the add after
    an O / down projection rides the GEMM launch)."""
    w: ParamPath = ()
    b: Optional[ParamPath] = None
    act: str = "none"
    epilogue: Optional[Epilogue] = None


@dataclass(frozen=True)
class LinearGroupOp(OpNode):
    """Several LinearOps sharing one input (Q/K/V, gate/up), collapsed by
    passes.fuse_projections into ONE Conv PE launch.  Its value is a TUPLE
    of member outputs ordered like `ws`, read through ViewOps."""
    ws: Tuple[ParamPath, ...] = ()
    bs: Tuple[Optional[ParamPath], ...] = ()
    acts: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ViewOp(OpNode):
    """Member `index` of a LinearGroupOp's output tuple (a memory-level
    alias: no launch, excluded from launch counts)."""
    index: int = 0


@dataclass(frozen=True)
class EmbedOp(OpNode):
    """Token embedding gather.  emb_scale is the resolved multiplier
    (sqrt(d_model) for gemma-style archs, 0.0 = off)."""
    w: ParamPath = ()
    emb_scale: float = 0.0


@dataclass(frozen=True)
class NormOp(OpNode):
    """RMS norm on the MISC core; its requant epilogue hands the Conv PE
    GEMMs their static-int8 inputs in a calibrated program."""
    w: ParamPath = ()
    eps: float = 1e-6


@dataclass(frozen=True)
class MulOp(OpNode):
    """Elementwise product (the SwiGLU / GeGLU gate) on the MISC core."""
    pass


@dataclass(frozen=True)
class AttnOp(OpNode):
    """RoPE + attention between the QKV and output GEMMs.  inputs = (q, k,
    v) projection edges, each [B, L, heads*head_dim]; `layer` keys the
    collected (k, v) pair of the serving-cache fill.

    mode="full":   full-sequence causal attention (prefill).
    mode="update": the cache recurrence of a DecodeStep program -- the new
      (k, v) is written into the serving KV cache at the slot's position,
      then the query attends against the whole cache.

    page_size > 0 (update mode, global layers): the cache is BLOCK-PAGED,
    a shared [num_blocks, page, Hkv, D] pool indexed through the slot's
    row of cache["tables"]."""
    layer: int = 0
    layer_kind: str = "global"
    n_heads: int = 1
    n_kv_heads: int = 1
    head_dim: int = 1
    rope_theta: float = 10000.0
    softcap: float = 0.0
    window: int = 0                  # >0: local attention window
    mode: str = "full"               # full | update (cache step)
    page_size: int = 0               # >0: block-paged cache (update mode)


@dataclass(frozen=True)
class HeadOp(OpNode):
    """LM logits GEMM.  tied=True reads the embedding table ([V, d], used
    transposed); otherwise a [d, V] head matrix.  last_only=True emits only
    the final position's logits (the serving-prefill program)."""
    w: ParamPath = ()
    tied: bool = True
    softcap: float = 0.0
    last_only: bool = False


@dataclass(frozen=True)
class Graph:
    """Topologically ordered op list; nodes[i].id == i."""
    nodes: Tuple[OpNode, ...]
    output: int
    name: str = ""

    def consumers(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                out[i].append(n.id)
        return out

    def count(self, cls) -> int:
        return sum(isinstance(n, cls) for n in self.nodes)


def get_param(params, path: Optional[ParamPath]):
    """Resolve a ParamPath against the (possibly quantized) params tree.
    None (an op with no bias) resolves to None."""
    if path is None:
        return None
    v = params
    for k in path:
        v = v[k]
    return v


class _Builder:
    def __init__(self):
        self.nodes: List[OpNode] = []

    def add(self, cls, inputs, **attrs) -> int:
        nid = len(self.nodes)
        self.nodes.append(cls(id=nid, inputs=tuple(inputs), **attrs))
        return nid


def build_graph(cfg: CNNConfig) -> Graph:
    """Lower a CNNConfig to the engine op-graph.  Channel bookkeeping here
    must match models.cnn.cnn_schema, which owns the parameter shapes."""
    b = _Builder()
    x = b.add(InputOp, [])
    x = b.add(ConvOp, [x], w=("stem_w",), b=("stem_b",),
              stride=cfg.stem_stride, act="relu", first_layer=True)
    ch = cfg.stem_ch
    for si, st in enumerate(cfg.stages):
        for r in range(st.repeat):
            stride = st.stride if r == 0 else 1
            p: ParamPath = ("stages", si, r)
            if st.kind == "conv":
                x = b.add(ConvOp, [x], w=p + ("w",), b=p + ("b",),
                          stride=stride, act="relu")
                ch = st.out_ch
            elif st.kind == "bottleneck":
                h = b.add(ConvOp, [x], w=p + ("w1",), b=p + ("b1",),
                          act="relu")
                h = b.add(ConvOp, [h], w=p + ("w2",), b=p + ("b2",),
                          stride=stride, act="relu")
                h = b.add(ConvOp, [h], w=p + ("w3",), b=p + ("b3",))
                skip = x
                if ch != st.out_ch or stride != 1:
                    skip = b.add(ConvOp, [x], w=p + ("wskip",),
                                 b=p + ("bskip",), stride=stride)
                x = b.add(AddOp, [h, skip], act="relu")
                ch = st.out_ch
            elif st.kind == "inverted":
                h = b.add(ConvOp, [x], w=p + ("we",), b=p + ("be",),
                          act="relu6")
                h = b.add(DwcOp, [h], w=p + ("wd",), b=p + ("bd",),
                          stride=stride, act="relu6")
                h = b.add(ConvOp, [h], w=p + ("wp",), b=p + ("bp",))
                if stride == 1 and ch == st.out_ch:
                    x = b.add(AddOp, [h, x])
                else:
                    x = h
                ch = st.out_ch
            elif st.kind == "dwsep":
                h = b.add(DwcOp, [x], w=p + ("wd",), b=p + ("bd",),
                          stride=stride, act="relu")
                x = b.add(ConvOp, [h], w=p + ("wp",), b=p + ("bp",),
                          act="relu")
                ch = st.out_ch
            elif st.kind == "fire":
                sq = b.add(ConvOp, [x], w=p + ("ws",), b=p + ("bs",),
                           stride=stride, act="relu")
                e1 = b.add(ConvOp, [sq], w=p + ("w1",), b=p + ("b1",),
                           act="relu")
                e3 = b.add(ConvOp, [sq], w=p + ("w3",), b=p + ("b3",),
                           act="relu")
                x = b.add(ConcatOp, [e1, e3])
                ch = st.out_ch
            elif st.kind == "pool":
                x = b.add(PoolOp, [x], pool="max", kernel=st.kernel,
                          stride=st.stride)
            else:
                raise ValueError(f"unknown stage kind {st.kind!r}")
    x = b.add(PoolOp, [x], pool="global")
    x = b.add(LinearOp, [x], w=("head_w",), b=("head_b",))
    return Graph(tuple(b.nodes), output=x, name=cfg.name)


# ---------------------------------------------------------------------------
# Transformer lowering
# ---------------------------------------------------------------------------

def lowering_blockers(arch: ArchConfig) -> List[str]:
    """Why `lower_transformer` would refuse this arch (empty = lowerable)."""
    reasons = []
    kinds = {arch.layer_kind(i) for i in range(arch.n_layers)}
    if kinds - {"global", "local"}:
        reasons.append(
            f"non-attention mixers {sorted(kinds - {'global', 'local'})}")
    if arch.is_moe:
        reasons.append("MoE routing")
    if arch.family == "audio" or arch.encoder_layers > 0:
        reasons.append("encoder-decoder")
    if arch.mrope or arch.frontend:
        reasons.append("modality frontend / M-RoPE")
    if arch.d_ff <= 0:
        reasons.append("no MLP half")
    return reasons


def can_lower(arch: ArchConfig) -> bool:
    return not lowering_blockers(arch)


def lower_transformer(arch: ArchConfig, last_only: bool = False,
                      mode: str = "full", page_size: int = 0) -> Graph:
    """Lower a transformer to the engine op-graph.

    mode="full": the program input is the token ids [B, L]; the output is
    the logits ([B, L, V], or [B, 1, V] with `last_only` -- the serving
    prefill).  mode="decode": the DecodeStep program -- the same node
    sequence over a [B, 1] token input with every AttnOp in `update` mode,
    so calibration scales recorded on the full graph transfer by node id.
    page_size > 0 (decode only) marks the global-layer AttnOps paged.

    The reference's chunk mode (prefix-sharing partial prefill) is a later
    slice of the port.  Every projection is a LinearOp on the Conv PE;
    norms, residual adds, the gate and attention run on the MISC core."""
    if mode == "chunk":
        raise NotImplementedError(
            "chunk lowering (prefix-sharing partial prefill) is not ported "
            "yet: it joins with the prefix-sharing slice")
    if mode not in ("full", "decode"):
        raise ValueError(f"unknown lowering mode {mode!r} "
                         "(want 'full' or 'decode')")
    if page_size and mode == "full":
        raise ValueError("page_size applies to decode programs only "
                         "(prefill fills the cache through `collect`)")
    if page_size < 0:
        raise ValueError(f"page_size must be >= 0, got {page_size}")
    blockers = lowering_blockers(arch)
    if blockers:
        raise NotImplementedError(
            f"{arch.name}: cannot lower to the engine IR "
            f"({'; '.join(blockers)})")
    attn_mode = {"full": "full", "decode": "update"}[mode]
    b = _Builder()
    tokens = b.add(InputOp, [])
    x = b.add(EmbedOp, [tokens], w=("embed",),
              emb_scale=arch.d_model ** 0.5 if arch.emb_scale else 0.0)
    for i in range(arch.n_layers):
        kind = arch.layer_kind(i)
        p: ParamPath = ("blocks", i)
        ap = p + ("attn",)
        hn = b.add(NormOp, [x], w=p + ("norm",), eps=arch.norm_eps)
        q = b.add(LinearOp, [hn], w=ap + ("wq",),
                  b=ap + ("bq",) if arch.qkv_bias else None)
        k = b.add(LinearOp, [hn], w=ap + ("wk",),
                  b=ap + ("bk",) if arch.qkv_bias else None)
        v = b.add(LinearOp, [hn], w=ap + ("wv",),
                  b=ap + ("bv",) if arch.qkv_bias else None)
        a = b.add(AttnOp, [q, k, v], layer=i, layer_kind=kind,
                  n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads,
                  head_dim=arch.head_dim, rope_theta=arch.rope_theta,
                  softcap=arch.attn_softcap,
                  window=arch.local_window if kind == "local" else 0,
                  mode=attn_mode,
                  page_size=page_size if kind == "global" else 0)
        h = b.add(LinearOp, [a], w=ap + ("wo",))
        if arch.post_norms:
            h = b.add(NormOp, [h], w=p + ("post_attn_norm",),
                      eps=arch.norm_eps)
        x = b.add(AddOp, [x, h])
        mn = b.add(NormOp, [x], w=p + ("mlp_norm",), eps=arch.norm_eps)
        mp = p + ("mlp",)
        if arch.mlp_gated:
            g = b.add(LinearOp, [mn], w=mp + ("wg",), act=arch.mlp_act)
            u = b.add(LinearOp, [mn], w=mp + ("wu",))
            h = b.add(MulOp, [g, u])
        else:
            h = b.add(LinearOp, [mn], w=mp + ("wu",), act=arch.mlp_act)
        h = b.add(LinearOp, [h], w=mp + ("wd",))
        if arch.post_norms:
            h = b.add(NormOp, [h], w=p + ("post_mlp_norm",),
                      eps=arch.norm_eps)
        x = b.add(AddOp, [x, h])
    x = b.add(NormOp, [x], w=("final_norm",), eps=arch.norm_eps)
    x = b.add(HeadOp, [x],
              w=("embed",) if arch.tie_embeddings else ("head",),
              tied=arch.tie_embeddings, softcap=arch.final_softcap,
              last_only=last_only and mode == "full")
    name = arch.name if mode == "full" else (
        f"{arch.name}:{mode}" + (f":p{page_size}" if page_size else ""))
    return Graph(tuple(b.nodes), output=x, name=name)
