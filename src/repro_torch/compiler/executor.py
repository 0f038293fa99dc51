"""Engine-program executor, CNN half (the port's copy of
repro.compiler.executor).

Two execution modes, selected by whether the program carries a QuantPlan:

  * dynamic (plan=None) -- every op dispatches through kernels/ops.py with
    the engine config's quant mode; with quant="none" this is the float
    path calibration observes.
  * static (plan from passes.fold_requant) -- the paper's dataflow: the
    input image is quantized once with its calibrated scale and every
    engine consumes and emits int8 through its fused requant epilogue; the
    only f32 tensor the program materializes is the logits.

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

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Iterable, Optional, Tuple

import torch

from repro_torch.compiler import passes as passes_lib
from repro_torch.compiler.graph import (AddOp, ConcatOp, ConvOp, DwcOp,
                                        Graph, InputOp, LinearOp, OpNode,
                                        PoolOp, build_graph, get_param)
from repro_torch.compiler.passes import QuantPlan, fold_requant
from repro_torch.compiler.schedule import Schedule, level_schedule
from repro_torch.core.config import CNNConfig, EngineConfig
from repro_torch.core.quant import QTensor, mul, quantize_static
from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class Program:
    """A compiled engine program: op graph + optional static-int8 plan and
    concurrent-dispatch schedule.  `cfg` is the CNNConfig the graph was
    lowered from."""
    graph: Graph
    cfg: Hashable
    plan: Optional[QuantPlan] = None
    schedule: Optional[Schedule] = None

    @property
    def static(self) -> bool:
        return self.plan is not None


def compile_cnn(cfg: CNNConfig, scales: Optional[Dict[int, float]] = None,
                scheduled: bool = True) -> Program:
    """Lower a CNNConfig to an epilogue-fused engine program.

    passes.fuse_epilogues collapses Conv/DWC -> {residual add, pool} chains
    into single launches.  Without `scales` the program executes
    dynamically; with calibrated per-edge scales (keyed by the UNFUSED
    graph's node ids, which is what calibration observes, and remapped onto
    the fused graph) the requant-folding pass produces the static int8
    plan.  The program carries the ASAP level schedule; `scheduled=False`
    dispatches in raw topological order (the same values)."""
    g, scales = passes_lib.fuse_epilogues(build_graph(cfg), scales)
    plan = fold_requant(g, scales) if scales is not None else None
    sched = level_schedule(g) if scheduled else None
    return Program(g, cfg, plan, sched)


def execute(program: Program, params, inputs: torch.Tensor,
            eng: EngineConfig,
            observer: Optional[Callable[[OpNode, torch.Tensor], None]] = None
            ) -> torch.Tensor:
    """Run a program on [N, H, W, C] float images; returns f32 logits."""
    with torch.inference_mode():
        if program.static:
            out = _run_scheduled(program,
                                 _static_eval(program, params, inputs, eng))
            return out.dequant() if isinstance(out, QTensor) else out
        return _run_scheduled(program,
                              _dynamic_eval(params, inputs, eng), observer)


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
# Dynamic mode (the float calibration path)
# ---------------------------------------------------------------------------

def _dynamic_eval(params, images, eng: EngineConfig):
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
            return ops.linear(vals[n.inputs[0]], get_param(params, n.w),
                              get_param(params, n.b), n.act, eng,
                              out_dtype=torch.float32)
        raise TypeError(f"unknown op {type(n).__name__}")

    return eval_node


# ---------------------------------------------------------------------------
# Static mode (calibrated end-to-end int8 dataflow)
# ---------------------------------------------------------------------------

def _require_qtensor(w, n: OpNode):
    if not isinstance(w, QTensor):
        raise ValueError(
            f"static program: {type(n).__name__} #{n.id} expects quantized "
            f"(QTensor) weights at {n.w}; quantize params with "
            "core.engine.quantize_params first")
    return w


def _static_eval(program: Program, params, images, eng: EngineConfig):
    plan = program.plan

    def eval_node(n: OpNode, vals: Dict[int, QTensor]):
        os = plan.out_scale[n.id] if plan.emit_int8[n.id] else None
        if isinstance(n, InputOp):
            # One static quantization at the boundary; int8 from here on.
            return QTensor(quantize_static(images, os), os)
        if isinstance(n, (ConvOp, DwcOp)):
            w = _require_qtensor(get_param(params, n.w), n)
            b = get_param(params, n.b)
            ep = n.epilogue
            res, res_s = None, 1.0
            if ep is not None and ep.add:
                r = vals[n.inputs[-1]]
                res, res_s = r.q, float(r.scale)
            if isinstance(n, DwcOp):
                fn = ops.dwc2d
            else:
                fn = ops.first_layer_conv if n.first_layer else ops.conv2d_pe
            out = fn(vals[n.inputs[0]], w, b, n.stride, n.padding, n.act, eng,
                     out_scale=os, epilogue=ep, residual=res, res_scale=res_s)
            return QTensor(out, os)
        if isinstance(n, AddOp):
            a, b = vals[n.inputs[0]], vals[n.inputs[1]]
            out = ops.misc_add(a.q, b.q, n.act, eng, sa=float(a.scale),
                               sb=float(b.scale), out_scale=os)
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
            out = ops.linear(vals[n.inputs[0]], w, get_param(params, n.b),
                             n.act, eng, out_dtype=torch.float32,
                             out_scale=os)
            return QTensor(out, os) if os is not None else out
        raise TypeError(f"unknown op {type(n).__name__}")

    return eval_node


def _rescale_int8(q: torch.Tensor, s_in: float, s_out: float) -> torch.Tensor:
    """int8 -> int8 rescale without an f32 tensor between engines."""
    r = torch.round(mul(q.to(torch.float32), s_in / s_out))
    return torch.clamp(r, -127, 127).to(torch.int8)
