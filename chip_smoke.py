#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

  1. the card (nvidia-smi name and power limit) and the build of every
     CUDA kernel from src/repro_torch/csrc (one nvcc per source, started
     together, into the git-ignored build/);
  2. one program run of full-width 224 px MobileNetV2 with every kernel
     wrapper's arguments recorded, then a phase per kernel body at exactly
     those shapes: each call's kernel output must equal its plain PyTorch
     version bit for bit (int8 codes and f32 logits; the kernels are built
     with --fmad=false and round like torch), and the kernel, its plain
     version and a library yardstick are timed;
  3. the slice end to end: seeded weights, one calibration batch of 4,
     CNNServeEngine(paper_engine(backend="cuda"), wave_size=4) answering 8
     requests through pump() + flush(), with every launch counter zeroed
     just before and read just after; the logits must equal a
     backend="ref" run of the same program on the card, bit for bit; then
     the trace served 10 times more for steady images/s and latency, and
     one wave profiled (wall, host enqueue, device time per kernel);
  4. one JSON line with every kernel's launches, error and times, then the
     device line.

It needs one card and no network, and imports only torch, numpy, the
standard library and repro_torch.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8 ops/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
REPS = 20
TRIALS = 10          # repeats of the 8-request trace for steady numbers

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "low_channel": ("src/repro_torch/csrc/low_channel.cu",
                    "src/repro/kernels/low_channel.py:33"),
    "conv_pe": ("src/repro_torch/csrc/conv_pe.cu",
                "src/repro/kernels/conv_pe.py:37"),
    "conv_pe_res": ("src/repro_torch/csrc/conv_pe.cu",
                    "src/repro/kernels/conv_pe.py:69"),
    "dwc": ("src/repro_torch/csrc/dwc_pe.cu",
            "src/repro/kernels/dwc_pe.py:40"),
    "conv_pe_pool": ("src/repro_torch/csrc/conv_pe.cu",
                     "src/repro/kernels/conv_pe.py:311"),
}
PER_RUN = {"low_channel": 1, "conv_pe": 25, "conv_pe_res": 10, "dwc": 17,
           "conv_pe_pool": 1}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def device_us(prof) -> dict:
    """Device time (us) per kernel name in a torch.profiler trace; host ops
    are skipped, since the kernels they launch are counted themselves."""
    per = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            per[e.key] = per.get(e.key, 0.0) + us
    return per


def cuda_ms(torch, fn, reps: int = REPS):
    """(device ms, wall ms) per call of `fn`, after two warm-up calls.
    Device ms is the summed duration of the kernels `fn` launches, from
    torch.profiler over `reps` calls; wall ms is CUDA events around `reps`
    back-to-back calls, which also counts the gaps where the device waits
    for the host to launch the next kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    wall = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(device_us(prof).values()) / 1e3 / reps
    if dev <= 0:
        fail("torch.profiler reported no device time")
    return dev, wall


def _tensors(args, kwargs):
    import torch
    return [t for t in list(args) + list(kwargs.values())
            if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def call_ops(name: str, args, kwargs, out) -> float:
    """Multiply-adds x 2 of one call, from its operand shapes."""
    a, w = args[0], args[1]
    if name in ("conv_pe", "conv_pe_res"):
        m, k = a.shape
        return 2.0 * m * k * w.shape[1]
    if name == "conv_pe_pool":
        g, rows, k = a.shape
        return 2.0 * g * rows * k * w.shape[1]
    if name == "dwc":
        return 2.0 * out.numel() * w.shape[0] * w.shape[1]
    k, _, ic, _ = w.shape                     # low_channel
    return 2.0 * out.numel() * k * k * ic


# ---------------------------------------------------------------------------
# Library yardsticks (timed only; the port never calls them)
# ---------------------------------------------------------------------------

def library_fn(torch, name: str, kern, args, kwargs):
    """One library product call (cuBLAS int8 GEMM through torch._int_mm, or
    cuDNN's convolution on exact float32 copies of the int8 operands) plus
    the same epilogue in torch ops, on inputs prepared outside the timing.
    """
    import torch.nn.functional as F
    from repro_torch.core.quant import qdq_codes
    from repro_torch.kernels import _epilogue
    from repro_torch.kernels.ref import act_fn

    p = inspect.signature(kern).bind(*args, **kwargs)
    p.apply_defaults()
    p = p.arguments

    def epilogue(acc, a_scale, w_scale, bias, act, out_scale):
        x = acc.to(torch.float32) * a_scale * w_scale
        if bias is not None:
            x = x + bias
        x = act_fn(act)(x)
        return x if out_scale is None else qdq_codes(x, out_scale).to(
            torch.int8)

    if name.startswith("conv_pe"):
        a, b = p["a_q"], p["b_q"]
        rows = a.shape[:-1]
        a = a.reshape(-1, a.shape[-1])
        m, k = a.shape
        mp = max(32, -(-m // 8) * 8)           # _int_mm wants M > 16
        ap = torch.zeros((mp, k), dtype=torch.int8, device=a.device)
        ap[:m] = a
        b = b.t().contiguous().t()             # cuBLASLt int8 wants "TN"
        w_scale = p["w_scale"].reshape(1, -1)
        args = (p["a_scale"], w_scale, p["bias"], p["act"])

        def run():
            acc = torch._int_mm(ap, b)[:m]
            if name == "conv_pe":
                return epilogue(acc, *args, p["out_scale"])
            x = epilogue(acc, *args, None)
            if name == "conv_pe_res":
                return _epilogue.fused_chain(
                    x, mid_scale=p["mid_scale"], residual=p["residual"],
                    res_scale=p["res_scale"], add_act=p["add_act"],
                    out_scale=p["out_scale"])
            return _epilogue.fused_chain(
                x.reshape(rows[0], rows[1], 1, -1), mid_scale=p["mid_scale"],
                pool="global", out_scale=p["out_scale"])
        return run

    x, w = p["x"], p["w"]
    xf = x.permute(0, 3, 1, 2).to(torch.float32).contiguous(
        memory_format=torch.channels_last)
    if name == "dwc":
        wf = w.permute(2, 0, 1).unsqueeze(1)          # [C, 1, k, k]
        groups = w.shape[2]
    else:
        wf = w.permute(3, 2, 0, 1)                    # [OC, IC, k, k]
        groups = 1
    wf = wf.to(torch.float32).contiguous(memory_format=torch.channels_last)

    def run():
        # |acc| <= k*k*IC*127^2 < 2^24: the float32 sums are exact integers
        acc = F.conv2d(xf, wf, stride=p["stride"], groups=groups)
        return epilogue(acc.permute(0, 2, 3, 1), p["a_scale"], p["w_scale"],
                        p["bias"], p["act"], p["out_scale"])
    return run


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def capture_calls(torch, engine, name, images):
    """Run one wave through the engine with every kernel wrapper recording
    its arguments (the shapes the main path gives each kernel)."""
    from repro_torch.kernels import conv_pe, dwc_pe, low_channel
    calls = {k: [] for k in KERNELS}
    patched = [(conv_pe, "matmul_int8_fused"), (conv_pe, "matmul_int8_pool"),
               (dwc_pe, "dwc2d"), (low_channel, "low_channel_conv")]
    saved = {(m, f): getattr(m, f) for m, f in patched}

    def recorder(mod, fn):
        orig = saved[(mod, fn)]

        def rec(*args, **kwargs):
            if fn == "matmul_int8_fused":
                key = ("conv_pe_res" if kwargs.get("residual") is not None
                       else "conv_pe")
            else:
                key = {"matmul_int8_pool": "conv_pe_pool", "dwc2d": "dwc",
                       "low_channel_conv": "low_channel"}[fn]
            calls[key].append((args, kwargs))
            return orig(*args, **kwargs)
        return rec

    try:
        for mod, fn in patched:
            setattr(mod, fn, recorder(mod, fn))
        engine.infer(name, images)
    finally:
        for (mod, fn), orig in saved.items():
            setattr(mod, fn, orig)
    torch.cuda.synchronize()
    return calls


def kernel_phase(torch, name, calls):
    """Each recorded call: kernel vs its plain version (bitwise), then the
    per-program-run times of the kernel, the plain version and the library
    yardstick, and the bound from the calls' bytes and operations."""
    from repro_torch.kernels import conv_pe, dwc_pe, low_channel
    kern = {"conv_pe": conv_pe.matmul_int8_fused,
            "conv_pe_res": conv_pe.matmul_int8_fused,
            "conv_pe_pool": conv_pe.matmul_int8_pool,
            "dwc": dwc_pe.dwc2d,
            "low_channel": low_channel.low_channel_conv}[name]
    plain = {"conv_pe": conv_pe.matmul_int8_fused_plain,
             "conv_pe_res": conv_pe.matmul_int8_fused_plain,
             "conv_pe_pool": conv_pe.matmul_int8_pool_plain,
             "dwc": dwc_pe.dwc2d_plain,
             "low_channel": low_channel.low_channel_conv_plain}[name]
    if not calls:
        fail(f"{name}: the main path gave this kernel no call")
    max_err, bytes_s, ops_s, bound = 0.0, 0.0, 0.0, 0.0
    for args, kwargs in calls:
        got = kern(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{name}: kernel {got.dtype}{tuple(got.shape)} vs plain "
                 f"{want.dtype}{tuple(want.shape)}")
        err = float((got.to(torch.float64) - want.to(torch.float64)).abs()
                    .max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err}) at shapes "
                 f"{[tuple(t.shape) for t in _tensors(args, kwargs)]}")
        t_bytes = (sum(_nbytes(t) for t in _tensors(args, kwargs))
                   + _nbytes(got)) / PEAK_BYTES
        t_ops = call_ops(name, args, kwargs, got) / PEAK_INT8
        bytes_s += t_bytes
        ops_s += t_ops
        bound += max(t_bytes, t_ops)

    def run_all(fn):
        return lambda: [fn(*a, **k) for a, k in calls]

    ms, wall_ms = cuda_ms(torch, run_all(kern))
    plain_ms, _ = cuda_ms(torch, run_all(plain))
    libs = [library_fn(torch, name, kern, a, k) for a, k in calls]
    library_ms, _ = cuda_ms(torch, lambda: [f() for f in libs])
    return {"max_abs_err": max_err, "ms": ms, "wall_ms": wall_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms, "calls_per_run": len(calls)}


def steady_serving(torch, engine, name, images):
    """The 8-request trace served TRIALS more times (not counted): median
    images/s over the trials, latency percentiles over every request."""
    import numpy as np
    from repro_torch.serve.base import LatencyTracker
    engine.latency = LatencyTracker()
    rates = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for img in images:
            engine.submit(name, img)
            engine.pump()
        engine.flush()
        rates.append(len(images) / (time.perf_counter() - t0))
    return float(np.median(rates)), engine.latency.percentiles()


def profile_wave(torch, engine, name, images):
    """Where one served wave's time goes: its wall time (median of five
    unprofiled waves), the host time to enqueue one program run (median of
    five, the device left to finish afterwards), and the device time per
    kernel name over one wave (torch.profiler)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    walls, enqueue = [], []
    run, qparams = engine._executor_for(name)
    buf = torch.from_numpy(images).cuda()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.infer(name, images)
        walls.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(qparams, buf)
        enqueue.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.infer(name, images)
        torch.cuda.synchronize()
    return (float(np.median(walls)), float(np.median(enqueue)),
            device_us(prof))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core import engine as eng_lib
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_schema
    from repro_torch.models.params import init_params
    from repro_torch.serve.base import LatencyTracker
    from repro_torch.serve.cnn_engine import CNNServeEngine
    from repro_torch import compiler

    # -- 1. the card and the build -------------------------------------------
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in libs.values())})")

    # -- model, weights, calibration -----------------------------------------
    cfg = CNN_ZOO["mobilenetv2"]
    params = init_params(cnn_schema(cfg), torch.Generator().manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    hw = cfg.input_hw
    calib = (rng.normal(size=(4, hw, hw, 3)) * 0.5).astype(np.float32)
    images = (rng.normal(size=(8, hw, hw, 3)) * 0.5).astype(np.float32)
    eng = eng_lib.paper_engine(backend="cuda")
    engine = CNNServeEngine(eng, wave_size=4)
    engine.register(cfg, params, calib_batches=[calib])
    t0 = time.perf_counter()
    program = engine.program_for(cfg.name)
    torch.cuda.synchronize()
    stats = compiler.fusion_stats(program.graph)
    log(f"compile_calibrated: {time.perf_counter() - t0:.2f} s, "
        f"launches/program {stats['launches']}, fused adds "
        f"{stats['fused_adds']}, fused pools {stats['fused_pools']}")

    # -- 2. kernel phases at the main path's shapes --------------------------
    calls = capture_calls(torch, engine, cfg.name, images[:4])
    results = {}
    for name in KERNELS:
        with torch.inference_mode():
            r = kernel_phase(torch, name, calls[name])
        results[name] = r
        log(f"kernel {name}: {r['calls_per_run']} calls/run, bitwise equal "
            f"to plain (max_abs_err {r['max_abs_err']}), per program run: "
            f"kernel_ms {r['ms']:.4f} (device; {r['wall_ms']:.4f} wall) "
            f"plain_ms {r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")

    # -- 3. the slice end to end ---------------------------------------------
    engine.latency = LatencyTracker()
    execs0 = engine.wave_stats.program_execs
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    served = {}
    tickets = []
    for img in images:
        tickets.append(engine.submit(cfg.name, img))
        served.update(engine.pump())
    rest = engine.flush()
    wall = time.perf_counter() - t0
    counts = dict(_build.COUNTS)
    runs = engine.wave_stats.program_execs - execs0
    if len(served) != len(images) or rest:
        fail(f"served {len(served)} of {len(images)} through pump(), "
             f"{len(rest)} left for flush()")
    logits = np.stack([served[t] for t in tickets])
    for name, want in PER_RUN.items():
        got = counts.get(name, 0)
        if got == 0 or got != want * runs:
            fail(f"{name}: {got} launches over {runs} program runs, "
                 f"want {want} per run")
    lat = engine.latency.percentiles()
    log(f"serve: {len(images)} requests in {wall:.4f} s = "
        f"{len(images) / wall:.2f} images/s, p50 {lat['p50_ms']:.3f} ms, "
        f"p99 {lat['p99_ms']:.3f} ms, {runs} program runs, launches "
        f"{json.dumps(counts, sort_keys=True)}")

    run, qparams = engine._executor_for(cfg.name)
    ref_eng = EngineConfig(quant="w8a8", backend="ref")
    ref_logits = compiler.execute(
        program, qparams, torch.from_numpy(images).cuda(), ref_eng
    ).cpu().numpy()
    if logits.shape != (len(images), cfg.num_classes):
        fail(f"logits shape {logits.shape}")
    if not np.isfinite(logits).all():
        fail("non-finite logits")
    if not np.array_equal(logits, ref_logits):
        fail(f"cuda logits differ from the ref backend: max abs "
             f"{np.abs(logits - ref_logits).max()}")
    log(f"logits: {logits.shape}, finite, bitwise equal to backend='ref' "
        f"on the card (max |logit| {np.abs(logits).max():.4f})")

    rate, lat = steady_serving(torch, engine, cfg.name, images)
    log(f"serve steady: {TRIALS} x {len(images)} requests, median "
        f"{rate:.2f} images/s, p50 {lat['p50_ms']:.3f} ms, p99 "
        f"{lat['p99_ms']:.3f} ms over {lat['n']} requests")
    wall_us, enq_us, per = profile_wave(torch, engine, cfg.name, images[:4])
    busy = sum(per.values())
    if busy <= 0:
        fail("torch.profiler reported no device time for a served wave")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile: one wave {wall_us:.1f} us wall (unprofiled median), "
        f"host enqueue of its program run {enq_us:.1f} us, device busy "
        f"{busy:.1f} us ({100 * busy / wall_us:.1f}%), idle "
        f"{100 * (1 - busy / wall_us):.1f}%; top device time: "
        + "; ".join(f"{k[:60]} {v:.1f} us" for k, v in top))

    # -- 4. the result lines -------------------------------------------------
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
