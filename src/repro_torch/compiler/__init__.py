"""Model -> engine-program compiler, CNN half (the port's copy of
repro.compiler).

    graph.build_graph(cfg)                  # CNN -> typed op-graph IR
    calibrate.calibrate(g, params, batches) # per-edge activation scales
    passes.fuse_epilogues + fold_requant    # fused launches, static int8 plan
    passes.fold_weight_layouts(g, params)   # compile-time weight layouts
    schedule.level_schedule(g, policy)      # concurrent-PE dispatch waves
    executor.execute(program, ...)          # run on the ref / cuda backend

`compile_cnn(cfg)` yields a dynamic program; `compile_calibrated(...)` the
static int8 program the serving engine runs.
"""
from repro_torch.compiler.calibrate import calibrate
from repro_torch.compiler.executor import Program, compile_cnn, execute
from repro_torch.compiler.graph import (AddOp, ConcatOp, ConvOp, DwcOp,
                                        Epilogue, Graph, InputOp, LinearOp,
                                        PoolOp, build_graph, get_param)
from repro_torch.compiler.passes import (QuantPlan, fold_requant,
                                         fold_weight_layouts, fuse_epilogues,
                                         fusion_stats, launch_count)
from repro_torch.compiler.schedule import (Schedule, level_schedule,
                                           validate_schedule)


def compile_calibrated(cfg, params, batches, eng=None,
                       scheduled: bool = True) -> Program:
    """Float params + representative batches -> static int8 engine program.

    Calibration observes the UNFUSED graph (its edges are what the scales
    describe); compile_cnn then rewrites epilogue chains into fused
    launches, remapping the scales onto the fused graph and baking the
    absorbed interior edges' scales into the Epilogue specs."""
    scales = calibrate(build_graph(cfg), params, batches, cfg, eng=eng)
    return compile_cnn(cfg, scales=scales, scheduled=scheduled)


__all__ = [
    "AddOp", "ConcatOp", "ConvOp", "DwcOp", "Epilogue", "Graph", "InputOp",
    "LinearOp", "PoolOp", "Program", "QuantPlan", "Schedule", "build_graph",
    "calibrate", "compile_calibrated", "compile_cnn", "execute",
    "fold_requant", "fold_weight_layouts", "fuse_epilogues", "fusion_stats",
    "get_param", "launch_count", "level_schedule", "validate_schedule",
]
