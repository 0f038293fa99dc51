"""Model -> engine-program compiler (the port's copy of repro.compiler).

    graph.build_graph(cfg)                  # CNN -> typed op-graph IR
    graph.lower_transformer(arch, mode)     # LM prefill / decode -> same IR
    calibrate.calibrate(g, params, batches) # per-edge activation scales
    passes.fuse_projections / fuse_epilogues + fold_requant
                                            # fused launches, static int8 plan
    passes.fold_weight_layouts(g, params)   # compile-time weight layouts
    schedule.level_schedule(g, policy)      # concurrent-PE dispatch waves
    executor.execute / execute_decode       # run on the ref / cuda backend

`compile_cnn(cfg)` / `compile_lm(arch)` yield dynamic programs;
`compile_calibrated(...)` / `compile_lm_calibrated(...)` the static int8
programs the serving engines run.
"""
from repro_torch.compiler.calibrate import calibrate
from repro_torch.compiler.executor import (Program, compile_cnn, compile_lm,
                                           execute, execute_decode)
from repro_torch.compiler.graph import (AddOp, AttnOp, ConcatOp, ConvOp,
                                        DwcOp, EmbedOp, Epilogue, Graph,
                                        HeadOp, InputOp, LinearGroupOp,
                                        LinearOp, MulOp, NormOp, PoolOp,
                                        ViewOp, build_graph, can_lower,
                                        get_param, lower_transformer,
                                        lowering_blockers)
from repro_torch.compiler.passes import (QuantPlan, f32_roundtrip_edges,
                                         fold_requant, fold_weight_layouts,
                                         fuse_epilogues, fuse_projections,
                                         fusion_stats, launch_count)
from repro_torch.compiler.schedule import (Schedule, level_schedule,
                                           validate_schedule)


def compile_calibrated(cfg, params, batches, eng=None,
                       scheduled: bool = True, fuse: bool = True) -> Program:
    """Float params + representative batches -> static int8 engine program.

    Calibration observes the UNFUSED graph (its edges are what the scales
    describe); `fuse` (default on) then rewrites epilogue chains into fused
    launches, remapping the scales onto the fused graph and baking the
    absorbed interior edges' scales into the Epilogue specs.  fuse=False
    maps the same scales onto the one-op-per-launch graph."""
    scales = calibrate(build_graph(cfg), params, batches, cfg, eng=eng)
    return compile_cnn(cfg, scales=scales, scheduled=scheduled, fuse=fuse)


def calibrate_lm(arch, params, batches, eng=None):
    """One LM calibration run -> per-edge scales shared by every program
    variant of the arch: it executes the FULL unfused graph, and the
    prefill and decode graphs share its node sequence, so one {node id:
    scale} dict quantizes all of them."""
    return calibrate(lower_transformer(arch), params, batches, arch, eng=eng)


def compile_lm_calibrated(arch, params, batches, eng=None,
                          scheduled: bool = True, mode: str = "full",
                          scales=None, page_size: int = 0) -> Program:
    """Float params + representative token batches -> static int8 LM
    program (mode "full" / "prefill" / "decode"; pass `scales` to reuse
    one calibration run across modes)."""
    if scales is None:
        scales = calibrate_lm(arch, params, batches, eng=eng)
    return compile_lm(arch, scales=scales, scheduled=scheduled, mode=mode,
                      page_size=page_size)


__all__ = [
    "AddOp", "AttnOp", "ConcatOp", "ConvOp", "DwcOp", "EmbedOp", "Epilogue",
    "Graph", "HeadOp", "InputOp", "LinearGroupOp", "LinearOp", "MulOp",
    "NormOp", "PoolOp", "Program", "QuantPlan", "Schedule", "ViewOp",
    "build_graph", "calibrate", "calibrate_lm", "can_lower",
    "compile_calibrated", "compile_cnn", "compile_lm",
    "compile_lm_calibrated", "execute", "execute_decode",
    "f32_roundtrip_edges", "fold_requant", "fold_weight_layouts",
    "fuse_epilogues", "fuse_projections", "fusion_stats", "get_param",
    "launch_count", "level_schedule", "lower_transformer",
    "lowering_blockers", "validate_schedule",
]
