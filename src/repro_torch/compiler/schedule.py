"""Graph-level scheduler pass: topological leveling for concurrent PEs (the
port's copy of the asap / alap half of repro.compiler.schedule).

The paper's fabric runs its engines concurrently (the Low-Channel unit next
to the Conv PEs, the DWC PE as its own datapath, MISC on its own core).
level(n) = 1 + max(level(inputs)); two ops in one level never depend on
each other, so a level is a dispatch wave.  The executor consumes the
schedule level by level, evaluating every op of a level against the
previous levels' values only.  `policy="alap"` slides ops with slack toward
their consumers within the same critical-path length.  The cost-driven
policies (slack / cost) and the two-program merge wait for the co-tenancy
slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.compiler.graph import (AddOp, AttnOp, ConcatOp, ConvOp,
                                        DwcOp, EmbedOp, Graph, HeadOp,
                                        InputOp, LinearGroupOp, LinearOp,
                                        MulOp, NormOp, OpNode, PoolOp, ViewOp)

CONV_PE = "conv_pe"
DWC_PE = "dwc_pe"
MISC = "misc"
LOW_CHANNEL = "low_channel"
MEM = "mem"

_COMPUTE_UNITS = (CONV_PE, DWC_PE, MISC, LOW_CHANNEL)


def engine_unit(node: OpNode) -> str:
    """Which engine executes a node."""
    if isinstance(node, ConvOp):
        return LOW_CHANNEL if node.first_layer else CONV_PE
    if isinstance(node, (LinearOp, LinearGroupOp, HeadOp)):
        return CONV_PE                     # classifier-head / LM GEMMs
    if isinstance(node, DwcOp):
        return DWC_PE
    if isinstance(node, (AddOp, PoolOp, NormOp, MulOp, AttnOp)):
        return MISC                        # non-conv operators
    if isinstance(node, (InputOp, ConcatOp, EmbedOp, ViewOp)):
        return MEM                         # load / interleave / row gather
    raise TypeError(f"unknown op {type(node).__name__}")


@dataclass(frozen=True)
class Schedule:
    """A topological leveling of one graph: levels[k] holds the ids of the
    ops dispatched in wave k, ascending; every input of a level-k op lives
    in a level < k."""
    levels: Tuple[Tuple[int, ...], ...]
    stats: Dict[str, int] = field(default_factory=dict)


def level_schedule(graph: Graph, policy: str = "asap") -> Schedule:
    """Level the graph into concurrent dispatch waves ("asap" or "alap")."""
    asap: Dict[int, int] = {}
    for n in graph.nodes:
        asap[n.id] = (1 + max(asap[i] for i in n.inputs)) if n.inputs else 0
    n_levels = 1 + max(asap.values())
    if policy == "asap":
        level = asap
    elif policy == "alap":
        level = _alap_levels(graph, n_levels)
    else:
        raise ValueError(f"unknown leveling policy {policy!r} "
                         "(want 'asap' or 'alap')")
    levels = [[] for _ in range(n_levels)]
    for n in graph.nodes:                  # nodes are id-ordered already
        levels[level[n.id]].append(n.id)
    lvls = tuple(tuple(lv) for lv in levels if lv)
    return Schedule(lvls, stats=_levels_stats(graph, lvls))


def _alap_levels(graph: Graph, n_levels: int) -> Dict[int, int]:
    consumers = graph.consumers()
    level: Dict[int, int] = {}
    for n in reversed(graph.nodes):        # ids are topological
        cs = consumers[n.id]
        level[n.id] = (min(level[c] for c in cs) - 1) if cs \
            else n_levels - 1
    return level


def _levels_stats(graph: Graph, levels) -> Dict[str, int]:
    wide = cross = conv_dwc = 0
    max_unit = 0
    for lv in levels:
        per_unit: Dict[str, int] = {}
        for i in lv:
            u = engine_unit(graph.nodes[i])
            per_unit[u] = per_unit.get(u, 0) + 1
        units = set(per_unit)
        compute = units & set(_COMPUTE_UNITS)
        max_unit = max([max_unit] + [per_unit[u] for u in compute])
        if len(lv) > 1:
            wide += 1
        if len(compute) > 1:
            cross += 1
        if CONV_PE in units and DWC_PE in units:
            conv_dwc += 1
    return {
        "levels": len(levels),
        "ops": len(graph.nodes),
        "max_width": max(len(lv) for lv in levels),
        "wide_levels": wide,
        "cross_engine_levels": cross,
        "conv_dwc_levels": conv_dwc,
        "max_unit_width": max_unit,
    }


def validate_schedule(graph: Graph, sched: Schedule) -> None:
    """Raise if the schedule is not a valid topological leveling that covers
    every node exactly once."""
    seen: Dict[int, int] = {}
    for k, lv in enumerate(sched.levels):
        for i in lv:
            if i in seen:
                raise ValueError(f"node {i} scheduled twice "
                                 f"(levels {seen[i]} and {k})")
            seen[i] = k
    ids = {n.id for n in graph.nodes}
    if set(seen) != ids:
        missing = sorted(ids - set(seen))
        extra = sorted(set(seen) - ids)
        raise ValueError(f"schedule coverage mismatch: missing={missing} "
                         f"extra={extra}")
    for n in graph.nodes:
        for i in n.inputs:
            if seen[i] >= seen[n.id]:
                raise ValueError(
                    f"edge {i}->{n.id} violates leveling: producer in level "
                    f"{seen[i]}, consumer in level {seen[n.id]}")
