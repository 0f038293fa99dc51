"""Compiler passes, CNN half (the port's copy of repro.compiler.passes):
requant folding, epilogue fusion, compile-time weight layouts, launch
accounting.

`fuse_epilogues` rewrites Conv/DWC -> {residual Add, pool tail} chains into
single fused nodes (Epilogue spec), so the chain executes as ONE engine
launch; `fold_requant` then plans the static-int8 dataflow: for every edge
the int8 scale it is carried at, and whether its producer requantizes to it
in its own epilogue.  With static scales activations stay int8 from engine
to engine; the only f32 tensor the program materializes is the logits.

Folding rules:
  * max-pool is scale-preserving: it reuses its producer's scale verbatim;
  * concat unifies its branch scales: each single-consumer producer
    requants directly to the concat's scale inside its own epilogue;
  * everything else requants in its producing engine's epilogue to its own
    calibrated scale.

Per-channel scales (a tuple per edge) and the LM rewrites
(fuse_projections, LinearOp residual tails) come with their slices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.graph import (AddOp, ConcatOp, ConvOp, DwcOp,
                                        Epilogue, Graph, InputOp, LinearOp,
                                        PoolOp, get_param)
from repro_torch.core.quant import QTensor

_MIN_SCALE = 1e-8

# Op kinds that can emit int8 from their engine epilogue / consume it.
_INT8_EMIT = (InputOp, ConvOp, DwcOp, AddOp, PoolOp, ConcatOp, LinearOp)
_INT8_CONSUME = (ConvOp, DwcOp, LinearOp, AddOp, PoolOp, ConcatOp)


@dataclass(frozen=True)
class QuantPlan:
    """Static-int8 execution plan for one graph."""
    # node id -> per-tensor scale its OUTPUT edge is carried at
    # (int8 value * scale = f32)
    out_scale: Dict[int, float]
    # node id -> does the node emit int8 (False only for the logits)
    emit_int8: Dict[int, bool]
    # edges whose requant was folded into the producer epilogue for a
    # *different* consumer scale (concat unification): (producer, consumer)
    folded: Tuple[Tuple[int, int], ...]
    stats: Dict[str, int] = field(default_factory=dict)


def fold_requant(graph: Graph, scales: Dict[int, float]) -> QuantPlan:
    """Assign every edge a static per-tensor int8 scale and fold requants
    into the producing engines' epilogues."""
    missing = [n.id for n in graph.nodes if n.id not in scales]
    if missing:
        raise ValueError(
            f"calibration scales missing for nodes {missing}; "
            "run compiler.calibrate over representative batches first")
    if any(isinstance(v, tuple) for v in scales.values()):
        raise ValueError("per-channel scales are not ported yet")
    out_scale = {i: max(float(s), _MIN_SCALE) for i, s in scales.items()}
    consumers = graph.consumers()
    emit_int8 = {
        n.id: (n.id != graph.output
               and isinstance(n, _INT8_EMIT)
               and bool(consumers[n.id])
               and all(isinstance(graph.nodes[c], _INT8_CONSUME)
                       for c in consumers[n.id]))
        for n in graph.nodes
    }
    folded: List[Tuple[int, int]] = []
    for n in graph.nodes:
        if isinstance(n, PoolOp) and n.pool == "max":
            # Scale-preserving: int8 values flow through the comparator
            # untouched, so the output edge inherits the input's scale.
            out_scale[n.id] = out_scale[n.inputs[0]]
        elif isinstance(n, ConcatOp):
            # Unify branch scales: each branch engine requants to the concat
            # scale in its own epilogue when the concat is its sole consumer
            # (else the executor rescales int8->int8 at the concat).  A
            # fused node ending in a POOL keeps its scale: its final requant
            # is pinned to the pool stage's math.
            s = out_scale[n.id]
            for p in n.inputs:
                pn = graph.nodes[p]
                ep = getattr(pn, "epilogue", None)
                if ep is not None and ep.pool != "none":
                    continue
                if len(consumers[p]) == 1 and isinstance(
                        pn, (ConvOp, DwcOp, AddOp)):
                    out_scale[p] = s
                    folded.append((p, n.id))
    stats = dict(fusion_stats(graph))
    stats["folded_requants"] = len(folded)
    return QuantPlan(out_scale=out_scale, emit_int8=emit_int8,
                     folded=tuple(folded), stats=stats)


# ---------------------------------------------------------------------------
# Epilogue fusion: rewrite Conv/DWC -> {Add, pool} chains into fused launches
# ---------------------------------------------------------------------------

_FUSABLE_POOLS = ("avg", "global", "max")


def fuse_epilogues(graph: Graph, scales: Optional[Dict[int, float]] = None):
    """Rewrite Conv/DWC -> {residual Add, avg/global/max pool} chains into
    single fused nodes carrying an Epilogue spec.  A chain fuses when every
    interior edge has exactly one consumer:

      Conv/Dwc -> Add                 (the add's other operand becomes the
                                       fused node's LAST input edge)
      Conv/Dwc -> Pool(avg|global|max)
      Conv/Dwc -> Add -> Pool(...)

    The fused node sits at the position of the chain's LAST op (so a
    residual operand lowered after the conv stays topologically earlier),
    and node ids are renumbered compactly.  `scales` (keyed by the UNFUSED
    graph's ids) are remapped to the fused ids; the absorbed interior
    edges' scales are baked into the Epilogue (mid_scale / add_scale).  A
    max tail is scale-preserving, so the fused node inherits the pre-pool
    scale.  Returns (fused_graph, remapped_scales or None).
    """
    consumers = graph.consumers()

    def sole_consumer(nid: int):
        cs = consumers[nid]
        return graph.nodes[cs[0]] if len(cs) == 1 else None

    # chain end id -> (root node, add id | None, pool id | None, residual id)
    chains: Dict[int, Tuple] = {}
    absorbed: Dict[int, int] = {}        # interior old id -> chain end id
    for n in graph.nodes:
        if not isinstance(n, (ConvOp, DwcOp)) or n.epilogue is not None:
            continue
        if n.id == graph.output or n.id in absorbed:
            continue
        c = sole_consumer(n.id)
        if c is None or c.id in absorbed or c.id in chains:
            continue
        add_id = pool_id = res_id = None
        if (isinstance(c, AddOp) and len(c.inputs) == 2
                and c.inputs.count(n.id) == 1
                and not (isinstance(n, ConvOp) and n.first_layer)):
            add_id, end = c.id, c
            res_id = c.inputs[1] if c.inputs[0] == n.id else c.inputs[0]
            p = sole_consumer(c.id)
            if (isinstance(p, PoolOp) and p.pool in _FUSABLE_POOLS
                    and p.id not in chains):
                pool_id, end = p.id, p
        elif isinstance(c, PoolOp) and c.pool in _FUSABLE_POOLS:
            pool_id, end = c.id, c
        else:
            continue
        chains[end.id] = (n, add_id, pool_id, res_id)
        absorbed[n.id] = end.id
        if add_id is not None and pool_id is not None:
            absorbed[add_id] = end.id

    if not chains:
        return graph, scales

    new_nodes: List = []
    new_id: Dict[int, int] = {}
    new_scales: Optional[Dict[int, float]] = {} if scales is not None else None
    for n in graph.nodes:
        if n.id in absorbed:
            continue                    # interior: re-emitted at the end op
        nid = len(new_nodes)
        if n.id in chains:
            root, add_id, pool_id, res_id = chains[n.id]
            inputs = tuple(new_id[i] for i in root.inputs)
            if res_id is not None:
                inputs = inputs + (new_id[res_id],)
            pool = graph.nodes[pool_id] if pool_id is not None else None
            mid = add_sc = 0.0
            if scales is not None:
                mid = max(float(scales[root.id]), _MIN_SCALE)
                if add_id is not None and pool is not None:
                    add_sc = max(float(scales[add_id]), _MIN_SCALE)
            ep = Epilogue(
                add=res_id is not None,
                add_act=graph.nodes[add_id].act if add_id is not None
                else "none",
                pool=pool.pool if pool is not None else "none",
                pool_kernel=pool.kernel if pool is not None else 0,
                pool_stride=pool.stride if pool is not None else 0,
                mid_scale=mid, add_scale=add_sc)
            new_nodes.append(dataclasses.replace(
                root, id=nid, inputs=inputs, epilogue=ep))
            if new_scales is not None:
                if ep.pool == "max":
                    # scale-preserving tail: inherit the pre-pool edge scale
                    new_scales[nid] = add_sc if ep.add else mid
                else:
                    new_scales[nid] = scales[n.id]
        else:
            new_nodes.append(dataclasses.replace(
                n, id=nid, inputs=tuple(new_id[i] for i in n.inputs)))
            if new_scales is not None:
                new_scales[nid] = scales[n.id]
        new_id[n.id] = nid
    fused = Graph(tuple(new_nodes), output=new_id[graph.output],
                  name=graph.name)
    return fused, new_scales


def launch_count(graph: Graph) -> int:
    """Engine kernel dispatches one execution of the graph issues (input
    DMA and the bank-interleave concat ride the load path)."""
    return sum(1 for n in graph.nodes
               if not isinstance(n, (InputOp, ConcatOp)))


def residual_chains(graph: Graph) -> List[Tuple[int, int]]:
    """(conv_id, add_id) pairs where a Conv/DWC output feeds a MISC add."""
    chains = []
    for n in graph.nodes:
        if isinstance(n, AddOp):
            for p in n.inputs:
                if isinstance(graph.nodes[p], (ConvOp, DwcOp)):
                    chains.append((p, n.id))
    return chains


def fusion_stats(graph: Graph) -> Dict[str, int]:
    """Chain / launch accounting.  On a pre-pass graph `residual_chains`
    counts the fusable conv->add chains; on a post-pass graph `fused_*`
    count the chains rewritten into single launches, and `launches` is the
    kernel-dispatch count one execution issues."""
    fused = [n.epilogue for n in graph.nodes
             if getattr(n, "epilogue", None) is not None]
    consumers = graph.consumers()
    return {
        "residual_chains": len(residual_chains(graph)),
        "misc_adds": graph.count(AddOp),
        "convs": graph.count(ConvOp),
        "dwcs": graph.count(DwcOp),
        "fused_ops": len(fused),
        "fused_adds": sum(1 for e in fused if e.add),
        "fused_pools": sum(1 for e in fused if e.pool != "none"),
        "launches": launch_count(graph),
        # intermediate tensors one execution writes to memory
        "materialized_edges": sum(1 for n in graph.nodes if consumers[n.id]),
    }


# ---------------------------------------------------------------------------
# Compile-time weight layouts (im2col reshape)
# ---------------------------------------------------------------------------

def set_param(params, path, value):
    """Copy-on-write update of a params tree at a ParamPath."""
    if not path:
        return value
    k = path[0]
    if isinstance(params, dict):
        out = dict(params)
        out[k] = set_param(params[k], path[1:], value)
        return out
    if isinstance(params, (list, tuple)):
        out = list(params)
        out[k] = set_param(out[k], path[1:], value)
        return tuple(out) if isinstance(params, tuple) else out
    raise TypeError(f"cannot descend into {type(params).__name__} at {k!r}")


def fold_weight_layouts(graph: Graph, params):
    """Apply the Conv PE's weight layout once, at compile time: every
    non-stem ConvOp weight [k, k, IC, OC] becomes the im2col GEMM layout
    [k*k*IC, OC] (QTensor scales [1, OC]); ops.conv2d_pe recognizes the
    folded form.  Returns a new tree (untouched leaves shared).

    The reference also pads DWC weights to 128 lanes here; that is a TPU
    layout, and the CUDA DWC kernel reads the true channel count, so the
    port folds nothing for DwcOps."""
    out = params
    for n in graph.nodes:
        if not isinstance(n, ConvOp) or n.first_layer:
            continue
        w = get_param(out, n.w)
        q = w.q if isinstance(w, QTensor) else w
        if q.ndim != 4:
            continue                       # already folded
        k, _, ic, oc = q.shape
        mat = q.reshape(k * k * ic, oc)
        if isinstance(w, QTensor):
            out = set_param(out, n.w, QTensor(mat, w.scale.reshape(1, oc)))
        else:
            out = set_param(out, n.w, mat)
    return out
