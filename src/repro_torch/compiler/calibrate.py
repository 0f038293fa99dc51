"""Calibration pass: record per-edge activation scales from real batches
(the port's copy of the absmax half of repro.compiler.calibrate).

The Vitis-AI step of the paper's flow (Section III-A): run representative
inputs through the float model and derive a static symmetric int8 scale for
every activation edge.  Every graph edge is observed by executing the
program in dynamic float mode (quant="none", backend="ref": plain torch
ops, no kernels) with an observer hook, so the recorded ranges are exactly
the tensors the engines will carry.

LM graphs calibrate the same way (token batches, the unfused graph).
Scales are plain Python floats keyed by node id: they become compile-time
constants of the static program (arguments the kernels receive by value).
Percentile and per-channel calibrators join with a later slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from repro_torch.compiler import executor as ex
from repro_torch.compiler.graph import Graph
from repro_torch.core.config import EngineConfig
from repro_torch.core.quant import Calibrator


def calibrate(graph: Graph, params, batches: Iterable[torch.Tensor], cfg,
              eng: Optional[EngineConfig] = None) -> Dict[int, float]:
    """Run `batches` (what the graph's InputOp consumes: [N, H, W, C] float
    images, or [B, L] token ids for an LM graph) through the float ref path
    and return {node_id: running-absmax activation scale}.  `params` is the
    FLOAT tree: calibration measures the ranges quantized inference must
    reproduce."""
    eng = eng or EngineConfig(quant="none", backend="ref")
    if eng.quant != "none" or eng.backend != "ref":
        raise ValueError("calibration runs on the float ref path "
                         "(quant='none', backend='ref')")
    cal = Calibrator()
    prog = ex.Program(graph, cfg, None)

    def observe(node, value):
        cal.observe(str(node.id), value)

    ran = False
    with torch.inference_mode():
        for batch in batches:
            ran = True
            ex.execute(prog, params, batch, eng, observer=observe)
    if not ran:
        raise ValueError("calibration needs at least one batch")
    return {int(k): float(v) for k, v in cal.scales().items()}
