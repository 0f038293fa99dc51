#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

  1. the card (nvidia-smi name and power limit) and the build of every
     CUDA kernel from src/repro_torch/csrc (one nvcc per source, started
     together, into the git-ignored build/);
  2. MobileNetV2, full width, 224 px: one program run with every kernel
     wrapper's arguments recorded, the int8 Conv PE's launch plan logged
     per shape (kernels/conv_pe.plan: weight streaming at M <= 4, tensor-
     core tiles above), then a phase per kernel body at exactly
     those shapes: each call's kernel output must equal its plain PyTorch
     version bit for bit (int8 codes and f32 logits; the kernels are built
     with --fmad=false and round like torch), and the kernel, its plain
     version and a library yardstick are timed;
  3. MobileNetV2 served: seeded weights, one calibration batch of 4,
     CNNServeEngine(paper_engine(backend="cuda"), wave_size=4) answering 8
     requests through pump() + flush(), with every launch counter zeroed
     just before and read just after; the logits must equal a
     backend="ref" run of the same program on the card, bit for bit; then
     the trace served 10 times more for steady images/s and latency, and
     one wave profiled (wall, host enqueue, device time per kernel);
  4. ResNet50, full width, 224 px, on the same engine: the kernel phases of
     its Low-Channel max-pool tail, int8 Conv PE (plain and residual) and
     residual pooled GEMM, each held bitwise and timed; then served
     like MobileNetV2 (counters 1/37/15/1 per program run), steady trace
     and wave profile;
  5. ResNet50 unfused (compile_calibrated(fuse=False), same weights and
     calibration batch), run through compiler.execute on the card with the
     counters zeroed around it (1/53/16 per run): its logits must equal the
     fused program's served logits and the backend="ref" run bit for bit;
     the misc_add kernel phase at its shapes;
  6. avgpool2d, which no model path reaches: ops.avgpool2d on the CUDA
     backend at [4,56,56,256] 3/2 and [4,7,7,2048] 7/1, counted, then its
     kernel phase;
  7. a zoo sweep: every CNN_ZOO model at 64 px, batch 2, fused and
     unfused on one calibration, on the CUDA backend against
     backend="ref" on the card and unfused against fused, bit for bit,
     and each program's Low-Channel stem call against its plain version;
  8. qwen2-1.5b at full width (28 layers, d 1536, 12 / 2 heads of 128,
     d_ff 8960, vocab 151936), seeded weights, calibrated on one [2, 64]
     token batch, served by ServeEngine(quant="w4a8", backend="cuda",
     kv_layout="paged", page_size=16, batch_size=4, max_seq=128,
     prefill_len=64, decode_burst=4): the kernel phases of the int4 Conv PE
     (plain and residual; plans logged, kernels/conv_pe.plan_w4: weight
     streaming at a decode step, tensor-core tiles at a prefill), the paged
     gather and the flash attention at the shapes of one prefill and one
     decode step (timed per decode step, and per prefill; the int4 GEMMs
     with the L2 flushed before every repeat, as the int8 ones), then 8
     requests of 16-64 prompt tokens and 32 new tokens
     each with the counters zeroed around them (56 / 56 / 28 launches per
     decode step, the paged gather one a layer for k and v; 56 / 56 / 0
     and 28 flash_attention per prefill), the same trace 10 times more
     for steady tokens/s and latency, and one profiled
     prefill and decode step; the served ids must equal the backend="ref"
     engine's and the dense-KV engine's; then the same trace under
     quant="w8a8" (int8 Conv PE), with its int8 GEMMs, their plans logged,
     timed at the LM's shapes with the L2 flushed before every repeat (a
     served step reads each layer's weights cold), 3 steady traces and one
     profiled prefill and decode step, its ids equal to its ref run;
  9. gemma2-2b at full width (26 layers alternating local (window 4096)
     and global, d 2304, 8 / 4 heads of 256, d_ff 9216 gated tanh-gelu,
     vocab 256000, attention softcap 50, final softcap 30, post-norms,
     scaled embeddings), seeded weights, on the qwen2 cell's engine and
     trace: the flash attention held within ATTN_TOL of max|plain| against
     its plain version and timed at one gemma2 prefill and at a 2048-token
     shape; the int4 Conv PE (plans logged; timed cold per decode step and
     per prefill), the MISC add and the paged gather held bitwise at
     gemma2's shapes; the trace with the counters zeroed around
     it (4 int4 GEMMs and 2 misc_add on every layer, paged_gather (k and v
     in one launch) and flash_attention on the 13 global layers only), 3
     steady traces, one profiled prefill and decode step; ids
     equal to the backend="ref" engine's and the dense-KV engine's, with
     the int8 codes of the attention-output edge of one prefill compared
     between the backends; then the reduced gemma2 (window 64) served
     across a ring wrap on both backends, ids equal;
 10. falcon-mamba-7b at full width (64 mamba layers, d 4096, d_inner 8192,
     ssm_state 16, conv_kernel 4, dt_rank 256, vocab 65024, untied head),
     seeded weights, served on the eager SSM path by
     ServeEngine(quant="w8a8", backend="cuda", batch_size=4, max_seq=128,
     prefill_len=64, decode_burst=4) (dense; no calibration): the kernel
     phases of the causal temporal conv (dwc1d, per prefill, against
     F.conv1d + F.silu) and of the int8 Conv PE at the four mamba
     projection shapes (per decode step and per prefill, per-token
     a_scale, plans logged, L2 flushed before every repeat), then the
     8-request trace with the counters zeroed around it
     (256 conv_pe per decode step; 256 conv_pe + 64 dwc1d per prefill),
     its ids equal to the backend="ref" engine's, the trace 3 times more
     for steady tokens/s and latency, and one profiled prefill and decode
     step;
 11. qwen2-1.5b trained at full width on the float path (f32 params and
     Adam moments, bf16 compute, TrainConfig(lr=3e-4, total_steps=8,
     warmup_steps=1, remat="none"), SyntheticTokens at batch 8 x seq 128):
     every float GEMM (conv_pe_f) product of one step -- 196 forward, 28
     gate recomputes, 392 backward -- planned on the tensor cores (a
     product on the FFMA route fails), held against its plain version
     within F_TOL x max|plain| (one bf16 ulp more at bf16 output; the
     worst ratio to that bar and the plan logged per shape group) and
     timed per shape with cuBLAS beside it, and the wrapper's host us a
     call; 8 steps through make_train_step with the counters zeroed
     around them (616 conv_pe_f a step, nothing else), step 0's loss and
     grad_norm bit-identical to the captured first run of that step from
     the same state, finite losses, the last below the first; step ms,
     tokens/s, mfu, clocked and profiled steps, peak memory; the ref
     backend's first 2 steps from the same (re-made) state, its step-1
     loss and grad_norm within TRAIN_LOSS_TOL / TRAIN_GNORM_TOL of the
     CUDA backend's; then launch.train.main on the reduced model on the
     card with a checkpoint and --resume;
 12. one JSON line with every kernel's launches, error and times, then the
     device line.

It needs one card and no network, and imports only torch, numpy, the
standard library and repro_torch.
"""
from __future__ import annotations

import gc
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
PEAK_F32 = 67e12     # float32 outside the tensor cores
PEAK_BF16 = 989e12   # dense bf16 on the tensor cores
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
    "low_channel_max": ("src/repro_torch/csrc/low_channel.cu",
                        "src/repro/kernels/low_channel.py:33"),
    "conv_pe_pool_res": ("src/repro_torch/csrc/conv_pe.cu",
                         "src/repro/kernels/conv_pe.py:311"),
    "misc_add": ("src/repro_torch/csrc/misc_pe.cu",
                 "src/repro/kernels/misc_pe.py:22"),
    "avgpool2d": ("src/repro_torch/csrc/misc_pe.cu",
                  "src/repro/kernels/misc_pe.py:62"),
    "conv_pe_w4": ("src/repro_torch/csrc/conv_pe_w4.cu",
                   "src/repro/kernels/conv_pe.py:189"),
    "conv_pe_w4_res": ("src/repro_torch/csrc/conv_pe_w4.cu",
                       "src/repro/kernels/conv_pe.py:208"),
    "paged_gather": ("src/repro_torch/csrc/paged_gather.cu",
                     "src/repro/kernels/flash_attn.py:110"),
    "dwc1d": ("src/repro_torch/csrc/dwc_pe.cu",
              "src/repro/kernels/dwc_pe.py:157"),
    "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:29"),
    "conv_pe_f": ("src/repro_torch/csrc/conv_pe_f.cu",
                  "src/repro/kernels/conv_pe.py:429"),
}
# launches per program run of each path
PER_RUN = {
    "mobilenetv2": {"low_channel": 1, "conv_pe": 25, "conv_pe_res": 10,
                    "dwc": 17, "conv_pe_pool": 1},
    "resnet50": {"low_channel_max": 1, "conv_pe": 37, "conv_pe_res": 15,
                 "conv_pe_pool_res": 1},
    "resnet50_unfused": {"low_channel": 1, "conv_pe": 53, "misc_add": 16},
}
# the kernels each path's phase times, at that path's shapes
TIMED = {"mobilenetv2": ("low_channel", "conv_pe", "conv_pe_res", "dwc",
                         "conv_pe_pool"),
         "resnet50": ("low_channel_max", "conv_pe", "conv_pe_res",
                      "conv_pe_pool_res"),
         "resnet50_unfused": ("misc_add",)}
# the LM phase: launches per layer of one decode step and of one prefill
LM = dict(arch="qwen2-1.5b", batch=4, max_seq=128, prefill_len=64,
          burst=4, page=16, requests=8, new_tokens=32, calib=(2, 64),
          prompt_lens=(16, 64), w8a8_trials=3)
LM_PER_LAYER = {
    "w4a8": {"decode": {"conv_pe_w4": 2, "conv_pe_w4_res": 2,
                        "paged_gather": 1},
             "prefill": {"conv_pe_w4": 2, "conv_pe_w4_res": 2,
                         "flash_attention": 1}},
    "w8a8": {"decode": {"conv_pe": 2, "conv_pe_res": 2, "paged_gather": 1},
             "prefill": {"conv_pe": 2, "conv_pe_res": 2,
                         "flash_attention": 1}},
}
# kernels that launch on global attention layers only (local ring layers
# keep a dense cache and a windowed attention)
GLOBAL_ONLY = ("paged_gather", "flash_attention")
# the gemma2 phase: the qwen2 cell's engine and trace on gemma2-2b.  Its
# post-norms sit between the O / down GEMMs and the residual adds, so the
# adds stay MISC ops (misc_add) and no GEMM takes a residual epilogue.
GEMMA = dict(LM, arch="gemma2-2b", trials=3)
GEMMA_PER_LAYER = {
    "decode": {"conv_pe_w4": 4, "misc_add": 2, "paged_gather": 1},
    "prefill": {"conv_pe_w4": 4, "misc_add": 2, "flash_attention": 1}}
# the ring wrap: the reduced gemma2 (window 64); prompts + new tokens cross it
RING = dict(batch=2, max_seq=128, prefill_len=48, burst=4, page=16,
            requests=4, new_tokens=32, calib=(2, 48), prompt_lens=(40, 48))
# the longer attention shape (B, Hq, Hkv, L = S, D, softcap)
ATTN_LONG = (1, 8, 4, 2048, 256, 50.0)
# the flash attention against its plain version: |err| <= ATTN_TOL x
# max|plain| (f32 sums in another order; one softmax against chunks)
ATTN_TOL = 1e-5
# the SSM phase: falcon-mamba-7b on the eager path, w8a8, dense
SSM = dict(arch="falcon-mamba-7b", batch=4, max_seq=128, prefill_len=64,
           burst=4, requests=8, new_tokens=32, prompt_lens=(16, 64),
           trials=3)
SSM_PER_LAYER = {"decode": {"conv_pe": 4},
                 "prefill": {"conv_pe": 4, "dwc1d": 1}}
# the training phase: full-width qwen2-1.5b, AdamW steps on the float path
TRAIN = dict(arch="qwen2-1.5b", batch=8, seq=128, steps=8, ref_steps=2,
             launcher_steps=4, launcher_ckpt_every=2)
# conv_pe_f launches a step at remat "none": 7 projections x 28 layers
# forward, 28 gate recomputes (the one activated projection), 2 products
# x 196 backward
TRAIN_PER_STEP = 7 * 28 + 28 + 2 * 7 * 28
# the float GEMM against its plain version: |err| <= F_TOL x max|plain|
# (f32 K-sums in another order), and at bf16 output one bf16 ulp more
F_TOL = 1e-5
# the ref backend's step-1 loss and grad_norm against the CUDA backend's:
# the two round each projection at other points (ref: the bf16 product,
# then bias and act in bf16; cuda: bias and act on the f32 sum, one
# rounding), so bf16-sized differences compound over 28 layers and the
# backward.  Measured on an H100 at full width: 5.6e-5 and 1.2e-4 (the
# reduced model on the CPU: 2.4e-5 and 7e-4).  The bars sit about 10x
# above those, tight enough that a fault in a part of the gradient (a
# dropped dbias) does not pass.
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 5e-4, 2e-3
# standalone avgpool2d shapes: (x shape, window, stride)
AVGPOOL = (((4, 56, 56, 256), 3, 2), ((4, 7, 7, 2048), 7, 1))
SWEEP_HW, SWEEP_BATCH = 64, 2


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def _self_us(e) -> float:
    """A profiler event's own device time (us); 0 for host ops, since the
    kernels they launch are counted themselves."""
    if "CUDA" not in str(getattr(e, "device_type", "")):
        return 0.0
    us = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if us is None else us


def device_us(prof) -> dict:
    """Device time (us) per kernel name in a torch.profiler trace."""
    per = {}
    for e in prof.key_averages():
        us = _self_us(e)
        if us > 0:
            per[e.key] = per.get(e.key, 0.0) + us
    return per


_FLUSH = {}


def l2_flush(torch):
    """(flush, its kernel names): a read of 128 MB, more than the H100's
    50 MB L2, so the next call finds its operands in HBM (a read leaves no
    dirty lines to write back during that call).  Made once; the names are
    read off a trace of the flush alone, taken again (up to four traces)
    while the profiler loses its events: with no names, cuda_ms would
    count the flush as the call's device time."""
    from torch.profiler import ProfilerActivity, profile
    if not _FLUSH:
        buf = torch.ones(32 * 2**20, dtype=torch.int32, device="cuda")

        def flush():
            buf.sum()
        flush()
        torch.cuda.synchronize()
        keys = set()
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                flush()
                torch.cuda.synchronize()
            keys = {e.key for e in prof.key_averages() if _self_us(e) > 0}
            if keys:
                break
        if not keys:
            fail("torch.profiler saw no kernel of the L2 flush in four "
                 "traces")
        _FLUSH.update(fn=flush, keys=keys)
    return _FLUSH["fn"], _FLUSH["keys"]


def cuda_ms(torch, fn, reps: int = REPS, cold: bool = False):
    """(device ms, wall ms) per call of `fn`, after two warm-up calls.
    Device ms is the summed duration of the kernels `fn` launches, from
    torch.profiler over `reps` calls; wall ms is CUDA events around `reps`
    back-to-back calls, which also counts the gaps where the device waits
    for the host to launch the next kernel.  `cold`: the L2 is flushed
    before every call (l2_flush), the flush's kernels are left out of the
    device time, and wall ms is CUDA events around each call alone.
    torch.profiler loses device events: now and then all of a trace, at
    times a third, and in some phases two events of every trace; a sum over
    such a trace reads short.  Each call launches the same kernels, so a trace is whole when
    every kernel name's event count is a multiple of `reps`; a second
    trace is taken if the first is not, and a trace with no event at all
    is taken again, up to four traces in all.  If none is whole, each
    kernel name's time a call is its mean event time in the trace that
    holds most of its events, times its launches a call: that count over
    `reps`, rounded up (events are lost, never added)."""
    import math
    from torch.profiler import ProfilerActivity, profile
    flush, skip = l2_flush(torch) if cold else (lambda: None, set())
    fn()
    fn()
    torch.cuda.synchronize()
    if cold:
        pairs = []
        for _ in range(reps):
            flush()
            pairs.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            pairs[-1][0].record()
            fn()
            pairs[-1][1].record()
        torch.cuda.synchronize()
        wall = sum(a.elapsed_time(b) for a, b in pairs) / reps
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end) / reps
    fullest = {}                # kernel name -> (us, count), most events
    kept = 0                    # traces with events
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        trace = {e.key: (us, e.count) for e in prof.key_averages()
                 if (us := _self_us(e)) > 0 and e.key not in skip}
        if trace and all(c % reps == 0 for _, c in trace.values()):
            return sum(us for us, _ in trace.values()) / 1e3 / reps, wall
        for name, (us, c) in trace.items():
            if c > fullest.get(name, (0.0, 0))[1]:
                fullest[name] = (us, c)
        log(f"torch.profiler trace lost events (event counts "
            f"{[c for _, c in trace.values()]} for {reps} calls)")
        kept += bool(trace)
        if kept == 2:
            break
    if not fullest:
        fail("torch.profiler reported no device time in four traces")
    log("no whole trace: mean event times of the fullest traces")
    return sum(us / c * math.ceil(c / reps)
               for us, c in fullest.values()) / 1e3, wall


def _tensors(args, kwargs):
    import torch
    return [t for t in list(args) + list(kwargs.values())
            if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def call_bytes(torch, name: str, args, kwargs, outs) -> int:
    """Compulsory bytes of one call: each input read once, each output
    written once; a paged gather reads only the pages its table names
    (each once, entries clamped as the kernel clamps them), and the
    table."""
    ins = _tensors(args, kwargs)
    written = sum(_nbytes(o) for o in outs)
    if name != "paged_gather":
        return sum(_nbytes(t) for t in ins) + written
    *pools, tables = ins
    pages = torch.unique(tables.clamp(0, pools[0].shape[0] - 1)).numel()
    return (sum(pages * _nbytes(pool[0]) for pool in pools)
            + _nbytes(tables) + written)


def call_ops(name: str, args, kwargs, out):
    """(operations, the card's peak rate for their type) of one call, from
    its operand shapes: int8 multiply-adds x 2 for the engines, f32 flops
    for the MISC core."""
    if name == "misc_add":
        return 3.0 * out.numel(), PEAK_F32     # two multiplies and an add
    if name == "avgpool2d":
        return (args[1] ** 2 + 1.0) * out.numel(), PEAK_F32   # adds, divide
    if name == "paged_gather":
        return 0.0, PEAK_INT8                  # a copy: bytes only
    if name == "flash_attention":              # q.k and p.v multiply-adds
        b, hq, l, d = args[0].shape            # of the visible (q, k) pairs
        s = args[1].shape[2]
        pairs = (l * (s - l + 1) + l * (l - 1) // 2
                 if kwargs.get("causal", True) else l * s)
        return 4.0 * b * hq * pairs * d, PEAK_F32
    a, w = args[0], args[1]
    if name == "dwc1d":                        # a multiply and an add a tap
        return 2.0 * w.shape[0] * out.numel(), PEAK_F32
    if name.startswith("conv_pe_w4"):
        m, k = a.shape                         # int4 x int8 multiply-adds
        return 2.0 * m * k * w.shape[1], PEAK_INT8
    if name in ("conv_pe", "conv_pe_res"):
        m, k = a.shape
        return 2.0 * m * k * w.shape[1], PEAK_INT8
    if name.startswith("conv_pe_pool"):
        g, rows, k = a.shape
        return 2.0 * g * rows * k * w.shape[1], PEAK_INT8
    if name == "dwc":
        return 2.0 * out.numel() * w.shape[0] * w.shape[1], PEAK_INT8
    k, _, ic, oc = w.shape                    # low_channel(_max): every
    n, hp, wp, _ = a.shape                    # conv output, pooled or not
    stride = args[3]
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    return 2.0 * n * ho * wo * oc * k * k * ic, PEAK_INT8


# ---------------------------------------------------------------------------
# Library yardsticks (timed only; the port never calls them)
# ---------------------------------------------------------------------------

def library_fn(torch, name: str, kern, args, kwargs):
    """One library product call (cuBLAS int8 GEMM through torch._int_mm, or
    cuDNN's convolution on exact float32 copies of the int8 operands) plus
    the same epilogue in torch ops (F.max_pool2d for the stem's max tail),
    or F.avg_pool2d, or torch.index_select (one a pool for the paged
    gather's pair), on inputs prepared outside the timing; None where no
    PyTorch call computes the function."""
    import torch.nn.functional as F
    from repro_torch.core.quant import qdq_codes
    from repro_torch.kernels import _epilogue
    from repro_torch.kernels.ref import act_fn

    p = inspect.signature(kern).bind(*args, **kwargs)
    p.apply_defaults()
    p = p.arguments
    if name == "misc_add":
        return None       # no one PyTorch call scales, adds and requantizes
    if name.startswith("conv_pe_w4"):
        return None       # no one PyTorch call unpacks int4 groups against
                          # int8 rows with this epilogue
    if name == "flash_attention":
        q, k, v = p["q"], p["k"], p["v"]
        if p["softcap"] > 0 or (p["causal"] and q.shape[2] != k.shape[2]):
            return None   # no one PyTorch call applies a logit softcap
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=p["causal"],
            enable_gqa=q.shape[1] != k.shape[1])
    if name == "paged_gather":
        # one index_select a pool, the table's flat row ids made outside
        pools = (p["k_pool"], p["v_pool"])
        n, pg = pools[0].shape[0], pools[0].shape[1]
        flat = (p["tables"].clamp(0, n - 1).to(torch.int64)[..., None] * pg
                + torch.arange(pg, device=pools[0].device)).reshape(-1)
        pfs = [pool.reshape((n * pg,) + tuple(pool.shape[2:]))
               for pool in pools]
        return lambda: [torch.index_select(pf, 0, flat) for pf in pfs]
    if name == "avgpool2d":
        xf = p["x"].to(torch.float32).permute(0, 3, 1, 2)  # channels_last
        return lambda: F.avg_pool2d(xf, p["window"], p["stride"])
    if name == "dwc1d":
        # cuDNN's grouped conv1d over [B, C, L] (the layout prepared
        # outside), k-1 zeros each side, the first L outputs causal
        w, l = p["w"], p["x"].shape[1]
        xc = p["x"].permute(0, 2, 1).contiguous()
        wc = w.t().contiguous()[:, None, :]
        act = act_fn(p["act"])
        return lambda: act(F.conv1d(xc, wc, p["bias"], padding=w.shape[0] - 1,
                                    groups=w.shape[1])[..., :l])

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
            res = p["residual"]
            return _epilogue.fused_chain(
                x.reshape(rows[0], rows[1], 1, -1), mid_scale=p["mid_scale"],
                residual=None if res is None else res.reshape(
                    rows[0], rows[1], 1, -1),
                res_scale=p["res_scale"], add_act=p["add_act"],
                add_scale=p["add_scale"], pool="global",
                out_scale=p["out_scale"])
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
        if name != "low_channel_max":
            return epilogue(acc.permute(0, 2, 3, 1), p["a_scale"],
                            p["w_scale"], p["bias"], p["act"],
                            p["out_scale"])
        y = epilogue(acc.permute(0, 2, 3, 1), p["a_scale"], p["w_scale"],
                     p["bias"], p["act"], None)
        if p["mid_scale"] is not None:
            y = qdq_codes(y, p["mid_scale"])
        y = F.max_pool2d(y.permute(0, 3, 1, 2), p["pool_kernel"],
                         p["pool_stride"]).permute(0, 2, 3, 1)
        return y if p["mid_scale"] is None else y.to(torch.int8)
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


def _wrappers():
    """{kernel name: (wrapper, plain version)}."""
    from repro_torch.kernels import (conv_pe, dwc_pe, flash_attn,
                                     low_channel, misc_pe)
    return {
        "conv_pe_w4": (conv_pe.matmul_int4_fused,
                       conv_pe.matmul_int4_fused_plain),
        "conv_pe_w4_res": (conv_pe.matmul_int4_fused,
                           conv_pe.matmul_int4_fused_plain),
        "paged_gather": (flash_attn.paged_gather_kv,
                         flash_attn.paged_gather_kv_plain),
        "flash_attention": (flash_attn.flash_attention,
                            flash_attn.flash_attention_plain),
        "conv_pe": (conv_pe.matmul_int8_fused,
                    conv_pe.matmul_int8_fused_plain),
        "conv_pe_res": (conv_pe.matmul_int8_fused,
                        conv_pe.matmul_int8_fused_plain),
        "conv_pe_pool": (conv_pe.matmul_int8_pool,
                         conv_pe.matmul_int8_pool_plain),
        "conv_pe_pool_res": (conv_pe.matmul_int8_pool,
                             conv_pe.matmul_int8_pool_plain),
        "dwc": (dwc_pe.dwc2d, dwc_pe.dwc2d_plain),
        "dwc1d": (dwc_pe.dwc1d_causal, dwc_pe.dwc1d_causal_plain),
        "low_channel": (low_channel.low_channel_conv,
                        low_channel.low_channel_conv_plain),
        "low_channel_max": (low_channel.low_channel_conv,
                            low_channel.low_channel_conv_plain),
        "misc_add": (misc_pe.misc_add, misc_pe.misc_add_plain),
        "avgpool2d": (misc_pe.avgpool2d, misc_pe.avgpool2d_plain),
    }


def capture_calls(torch, run):
    """Call `run()` with every kernel wrapper recording its arguments (the
    shapes the main path gives each kernel), keyed by the counter name the
    wrapper launches under."""
    from repro_torch.kernels import (conv_pe, dwc_pe, flash_attn,
                                     low_channel, misc_pe)
    calls = {k: [] for k in KERNELS}
    patched = [(conv_pe, "matmul_int8_fused"), (conv_pe, "matmul_int8_pool"),
               (conv_pe, "matmul_int4_fused"),
               (flash_attn, "paged_gather_kv"),
               (flash_attn, "flash_attention"),
               (dwc_pe, "dwc2d"), (dwc_pe, "dwc1d_causal"),
               (low_channel, "low_channel_conv"),
               (misc_pe, "misc_add"), (misc_pe, "avgpool2d")]
    saved = {(m, f): getattr(m, f) for m, f in patched}

    def key_of(fn, kwargs):
        if fn == "matmul_int8_fused":
            return ("conv_pe_res" if kwargs.get("residual") is not None
                    else "conv_pe")
        if fn == "matmul_int4_fused":
            return ("conv_pe_w4_res" if kwargs.get("residual") is not None
                    else "conv_pe_w4")
        if fn == "matmul_int8_pool":
            return ("conv_pe_pool_res" if kwargs.get("residual") is not None
                    else "conv_pe_pool")
        if fn == "low_channel_conv":
            return ("low_channel_max" if kwargs.get("pool", "none") == "max"
                    else "low_channel")
        return {"dwc2d": "dwc", "dwc1d_causal": "dwc1d",
                "misc_add": "misc_add", "avgpool2d": "avgpool2d",
                "paged_gather_kv": "paged_gather",
                "flash_attention": "flash_attention"}[fn]

    def recorder(mod, fn):
        orig = saved[(mod, fn)]

        def rec(*args, **kwargs):
            calls[key_of(fn, kwargs)].append((args, kwargs))
            return orig(*args, **kwargs)
        return rec

    try:
        for mod, fn in patched:
            setattr(mod, fn, recorder(mod, fn))
        run()
    finally:
        for (mod, fn), orig in saved.items():
            setattr(mod, fn, orig)
    torch.cuda.synchronize()
    return calls


def kernel_phase(torch, name, calls, timed: bool = True, reps: int = REPS,
                 plain_reps: int = REPS, tol=None, cold: bool = False):
    """Each recorded call: kernel vs its plain version (bitwise, or with
    `tol` within tol x max|plain|); when `timed`, then the per-program-run
    times of the kernel, the plain version and the library yardstick (each
    with the L2 flushed before every repeat when `cold`), and the bound
    from the calls' bytes and operations."""
    kern, plain = _wrappers()[name]
    if not calls:
        fail(f"{name}: the main path gave this kernel no call")
    max_err, max_rel, bytes_s, ops_s, bound = 0.0, 0.0, 0.0, 0.0, 0.0
    for args, kwargs in calls:
        gots = kern(*args, **kwargs)
        wants = plain(*args, **kwargs)
        torch.cuda.synchronize()
        if not isinstance(gots, tuple):       # the gather's pair is a tuple
            gots, wants = (gots,), (wants,)
        for got, want in zip(gots, wants, strict=True):
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"{name}: kernel {got.dtype}{tuple(got.shape)} vs "
                     f"plain {want.dtype}{tuple(want.shape)}")
            err = float((got.to(torch.float64) - want.to(torch.float64))
                        .abs().max())
            max_err = max(max_err, err)
            if tol is not None:
                rel = err / float(want.abs().max())
                max_rel = max(max_rel, rel)
                if not rel <= tol:
                    fail(f"{name}: kernel differs from its plain version by "
                         f"{err} = {rel} x max|plain| (tolerance {tol}) at "
                         f"shapes "
                         f"{[tuple(t.shape) for t in _tensors(args, kwargs)]}")
            elif not torch.equal(got, want):
                fail(f"{name}: kernel differs from its plain version "
                     f"(max abs err {err}) at shapes "
                     f"{[tuple(t.shape) for t in _tensors(args, kwargs)]}")
        t_bytes = call_bytes(torch, name, args, kwargs, gots) / PEAK_BYTES
        ops, peak = call_ops(name, args, kwargs, gots[0])
        t_ops = ops / peak
        bytes_s += t_bytes
        ops_s += t_ops
        bound += max(t_bytes, t_ops)
    result = {"max_abs_err": max_err, "calls_per_run": len(calls),
              "tol": tol, "max_rel_err": max_rel, "cold": cold}
    if not timed:
        return result

    def run_all(fn):
        return lambda: [fn(*a, **k) for a, k in calls]

    ms, wall_ms = cuda_ms(torch, run_all(kern), reps, cold)
    plain_ms, _ = cuda_ms(torch, run_all(plain), plain_reps, cold)
    libs = [library_fn(torch, name, kern, a, k) for a, k in calls]
    library_ms = (None if None in libs else
                  cuda_ms(torch, lambda: [f() for f in libs], reps, cold)[0])
    result.update({"ms": ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
                   "bound_ms": bound * 1e3,
                   "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                   "library_ms": library_ms})
    return result


def log_kernel(name, r, per="program run"):
    lib = ("null" if r["library_ms"] is None
           else f"{r['library_ms']:.4f}")
    held = ("bitwise equal to plain" if r["tol"] is None else
            f"within {r['tol']} x max|plain| of plain (max_rel_err "
            f"{r['max_rel_err']:.3e})")
    cold = ", L2 flushed before each repeat" if r["cold"] else ""
    log(f"kernel {name}: {r['calls_per_run']} calls/run, {held} "
        f"(max_abs_err {r['max_abs_err']}), per {per}{cold}: "
        f"kernel_ms {r['ms']:.4f} (device; {r['wall_ms']:.4f} wall) "
        f"plain_ms {r['plain_ms']:.4f} library_ms {lib} "
        f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")


def log_plans(label, calls):
    """The launch plan of each int8 Conv PE shape among `calls` ({kernel
    name: [(args, kwargs)]}; kernels/conv_pe.plan: path, tile, K splits,
    copy widths, epilogue placement) and of each int4 one (conv_pe.plan_w4:
    route, tile, groups a chunk, copy widths), with its
    call count: a run shows where each route is taken."""
    from repro_torch.kernels import conv_pe
    shapes = {}
    for name in ("conv_pe", "conv_pe_res", "conv_pe_w4", "conv_pe_w4_res"):
        for args, _ in calls.get(name, ()):
            a, b = args[0], args[1]
            k = a.shape[1]
            gs = k // args[3].shape[0] if "w4" in name else 0
            key = (name, a.shape[0], b.shape[1], k, gs,
                   conv_pe.byte_align(a), conv_pe.byte_align(b))
            shapes[key] = shapes.get(key, 0) + 1
    paths = {}
    for (name, m, n, k, gs, aa, ba), count in sorted(shapes.items()):
        if gs:
            p = conv_pe.plan_w4(m, n, k, gs, aa, ba)
            paths[p.route] = paths.get(p.route, 0) + count
            log(f"plan {label} {name} M={m} N={n} K={k} gs={gs} x{count}: "
                f"{p.route} tile {p.bm}x{p.bn}, {p.gc} groups a chunk, "
                f"copies {p.wa}/{p.wb} B")
            continue
        p = conv_pe.plan(m, n, k, aa, ba)
        paths[p.path] = paths.get(p.path, 0) + count
        log(f"plan {label} {name} M={m} N={n} K={k} x{count}: {p.path} "
            f"tile {p.bm}x{p.bn}, {p.splits} K split(s) of {p.ks}, copies "
            f"{p.wa}/{p.wb} B, epilogue "
            f"{'fused' if p.fused else 'pass'}")
    log(f"plan {label}: calls by path {json.dumps(paths, sort_keys=True)}")


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
    for _ in range(3):          # an empty trace is taken again, as above
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.infer(name, images)
            torch.cuda.synchronize()
        per = device_us(prof)
        if sum(per.values()) > 0:
            break
        log("torch.profiler reported no device time; profiling again")
    return float(np.median(walls)), float(np.median(enqueue)), per


def check_counts(label: str, counts: dict, runs: int):
    """Every kernel of the path launched its count per program run, and no
    other kernel launched."""
    want = PER_RUN[label]
    for name, per in want.items():
        got = counts.get(name, 0)
        if got == 0 or got != per * runs:
            fail(f"{label}: {name}: {got} launches over {runs} program "
                 f"runs, want {per} per run")
    extra = sorted(set(counts) - set(want))
    if extra:
        fail(f"{label}: launches of kernels off its path: {extra}")


def check_logits(np, logits, want, shape, what: str):
    if logits.shape != shape:
        fail(f"logits shape {logits.shape}, want {shape}")
    if not np.isfinite(logits).all():
        fail("non-finite logits")
    if not np.array_equal(logits, want):
        fail(f"logits differ from {what}: max abs "
             f"{np.abs(logits - want).max()}")


def serve_trace(torch, engine, cfg, images):
    """The main path: the requests through submit / pump / flush, with the
    launch counters zeroed just before and read just after.  Returns the
    logits in submission order, the counts and the program runs."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve.base import LatencyTracker
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
    check_counts(cfg.name, counts, runs)
    lat = engine.latency.percentiles()
    log(f"serve {cfg.name}: {len(images)} requests in {wall:.4f} s = "
        f"{len(images) / wall:.2f} images/s, p50 {lat['p50_ms']:.3f} ms, "
        f"p99 {lat['p99_ms']:.3f} ms, {runs} program runs, launches "
        f"{json.dumps(counts, sort_keys=True)}")
    return np.stack([served[t] for t in tickets]), counts


def serve_model(torch, engine, cfg, images, ref_eng, results):
    """One model on the main path: its kernel phases at the shapes one
    program run gives them (timed for the kernels TIMED names, checked
    bitwise for the rest), the served trace against backend="ref", then
    the steady trace and one profiled wave.  Returns the served logits and
    the launch counts."""
    import numpy as np
    from repro_torch import compiler
    t0 = time.perf_counter()
    program = engine.program_for(cfg.name)
    torch.cuda.synchronize()
    stats = compiler.fusion_stats(program.graph)
    log(f"{cfg.name}: compile_calibrated {time.perf_counter() - t0:.2f} s, "
        f"launches/program {stats['launches']}, fused adds "
        f"{stats['fused_adds']}, fused pools {stats['fused_pools']}")

    calls = capture_calls(torch, lambda: engine.infer(cfg.name, images[:4]))
    log_plans(cfg.name, calls)
    for name in PER_RUN[cfg.name]:
        timed = name in TIMED[cfg.name]
        with torch.inference_mode():
            r = kernel_phase(torch, name, calls[name], timed)
        if timed:
            results.setdefault(name, r)     # the JSON line: the first model
            log_kernel(f"{name} ({cfg.name})", r)
        else:
            log(f"kernel {name} at {cfg.name} shapes: {r['calls_per_run']} "
                f"calls/run, bitwise equal to plain (max_abs_err "
                f"{r['max_abs_err']})")

    logits, counts = serve_trace(torch, engine, cfg, images)
    run, qparams = engine._executor_for(cfg.name)
    ref_logits = compiler.execute(
        program, qparams, torch.from_numpy(images).cuda(), ref_eng
    ).cpu().numpy()
    check_logits(np, logits, ref_logits, (len(images), cfg.num_classes),
                 "the ref backend")
    log(f"logits {cfg.name}: {logits.shape}, finite, bitwise equal to "
        f"backend='ref' on the card (max |logit| "
        f"{np.abs(logits).max():.4f})")

    rate, lat = steady_serving(torch, engine, cfg.name, images)
    log(f"serve steady {cfg.name}: {TRIALS} x {len(images)} requests, "
        f"median {rate:.2f} images/s, p50 {lat['p50_ms']:.3f} ms, p99 "
        f"{lat['p99_ms']:.3f} ms over {lat['n']} requests")
    wall_us, enq_us, per = profile_wave(torch, engine, cfg.name, images[:4])
    busy = sum(per.values())
    if busy <= 0:
        fail("torch.profiler reported no device time for a served wave")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {cfg.name}: one wave {wall_us:.1f} us wall (unprofiled "
        f"median), host enqueue of its program run {enq_us:.1f} us, device "
        f"busy {busy:.1f} us ({100 * busy / wall_us:.1f}%), idle "
        f"{100 * (1 - busy / wall_us):.1f}%; top device time: "
        + "; ".join(f"{k[:60]} {v:.1f} us" for k, v in top))
    return logits, counts


def unfused_path(torch, cfg, params, calib, images, eng, ref_eng,
                 fused_logits, results):
    """The unfused static program (residual adds on the MISC core) run on
    the card in waves of 4 through compiler.execute, counted; its logits
    must equal the fused program's and its backend="ref" run's."""
    import numpy as np
    from repro_torch import compiler
    from repro_torch.core import engine as eng_lib
    from repro_torch.kernels import _build
    label = cfg.name + "_unfused"
    t0 = time.perf_counter()
    program = compiler.compile_calibrated(
        cfg, params, [torch.from_numpy(calib).cuda()], fuse=False)
    qparams = compiler.fold_weight_layouts(
        program.graph, eng_lib.quantize_params(params, eng))
    torch.cuda.synchronize()
    log(f"{label}: compile_calibrated(fuse=False) "
        f"{time.perf_counter() - t0:.2f} s, launches/program "
        f"{compiler.launch_count(program.graph)}")
    waves = [torch.from_numpy(images[i:i + 4]).cuda()
             for i in range(0, len(images), 4)]
    torch.cuda.synchronize()
    _build.reset_counts()
    outs = [compiler.execute(program, qparams, w, eng) for w in waves]
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    check_counts(label, counts, len(waves))
    logits = torch.cat(outs).cpu().numpy()
    ref_logits = torch.cat([compiler.execute(program, qparams, w, ref_eng)
                            for w in waves]).cpu().numpy()
    shape = (len(images), cfg.num_classes)
    check_logits(np, logits, ref_logits, shape, "the unfused ref backend")
    check_logits(np, logits, fused_logits, shape, "the fused served logits")
    log(f"logits {label}: {logits.shape}, launches "
        f"{json.dumps(counts, sort_keys=True)} over {len(waves)} runs, "
        f"bitwise equal to backend='ref' and to the fused program's served "
        f"logits")
    calls = capture_calls(
        torch, lambda: compiler.execute(program, qparams, waves[0], eng))
    log_plans(label, calls)
    for name in PER_RUN[label]:
        timed = name in TIMED[label]
        with torch.inference_mode():
            r = kernel_phase(torch, name, calls[name], timed)
        if timed:
            results[name] = r
            log_kernel(name, r)
        else:
            log(f"kernel {name} at {label} shapes: {r['calls_per_run']} "
                f"calls/run, bitwise equal to plain")
    return counts


def avgpool_path(torch, eng, results):
    """avgpool2d through its public entry point, ops.avgpool2d on the CUDA
    backend, at the AVGPOOL shapes (f32 maps, as the dynamic executor gives
    it), counted; then its kernel phase."""
    import numpy as np
    from repro_torch.kernels import _build, ops
    rng = np.random.default_rng(2)
    xs = [(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
           .cuda(), k, s) for shape, k, s in AVGPOOL]

    def run():
        return [ops.avgpool2d(x, k, s, eng) for x, k, s in xs]

    torch.cuda.synchronize()
    _build.reset_counts()
    outs = run()
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    if counts != {"avgpool2d": len(AVGPOOL)}:
        fail(f"avgpool2d: launches {counts}, want {len(AVGPOOL)}")
    for o, (shape, k, s) in zip(outs, AVGPOOL):
        n, h, w, c = shape
        want = (n, (h - k) // s + 1, (w - k) // s + 1, c)
        if tuple(o.shape) != want or not torch.isfinite(o).all():
            fail(f"avgpool2d {shape} {k}/{s}: got {tuple(o.shape)}")
    calls = capture_calls(torch, run)
    with torch.inference_mode():
        r = kernel_phase(torch, "avgpool2d", calls["avgpool2d"])
    results["avgpool2d"] = r
    log_kernel("avgpool2d", r)
    return counts


def zoo_sweep(torch, eng, ref_eng):
    """Every zoo model at SWEEP_HW px and batch SWEEP_BATCH, fused and
    unfused on one calibration: the CUDA backend against backend="ref" on
    the card, and the unfused program against the fused, bit for bit; each
    program's Low-Channel stem call held bitwise against its plain
    version."""
    import dataclasses
    import numpy as np
    from repro_torch import compiler
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core import engine as eng_lib
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_schema
    from repro_torch.models.params import init_params
    rng = np.random.default_rng(3)
    for name in sorted(CNN_ZOO):
        cfg = dataclasses.replace(CNN_ZOO[name], input_hw=SWEEP_HW)
        params = init_params(cnn_schema(cfg),
                             torch.Generator().manual_seed(0), device="cuda")
        shape = (SWEEP_BATCH, SWEEP_HW, SWEEP_HW, 3)
        calib = torch.from_numpy(
            (rng.normal(size=shape) * 0.5).astype(np.float32)).cuda()
        x = torch.from_numpy(
            (rng.normal(size=shape) * 0.5).astype(np.float32)).cuda()
        scales = compiler.calibrate(compiler.build_graph(cfg), params,
                                    [calib], cfg)
        qp = eng_lib.quantize_params(params, eng)
        logits, counts, stems = [], [], []
        for fuse in (True, False):
            program = compiler.compile_cnn(cfg, scales=scales, fuse=fuse)
            qparams = compiler.fold_weight_layouts(program.graph, qp)
            out = []
            torch.cuda.synchronize()
            _build.reset_counts()
            calls = capture_calls(torch, lambda: out.append(
                compiler.execute(program, qparams, x, eng)))
            got = out[0]
            counts.append(dict(_build.COUNTS))
            stem = [(kind, c) for kind in ("low_channel", "low_channel_max")
                    for c in calls[kind]]
            if len(stem) != 1:
                fail(f"{name} (fuse={fuse}): {len(stem)} Low-Channel calls "
                     "in one program run, want 1")
            stems += stem
            want = compiler.execute(program, qparams, x, ref_eng)
            logits.append(got.cpu().numpy())
            check_logits(np, logits[-1], want.cpu().numpy(),
                         (SWEEP_BATCH, cfg.num_classes),
                         f"{name}'s ref backend (fuse={fuse})")
        check_logits(np, logits[1], logits[0],
                     (SWEEP_BATCH, cfg.num_classes), f"{name} fused")
        with torch.inference_mode():
            for kind, call in stems:
                kernel_phase(torch, kind, [call], timed=False)
        log(f"sweep {name} @{SWEEP_HW}px: fused and unfused bitwise equal "
            f"to backend='ref' and to each other, stems "
            f"{'/'.join(kind for kind, _ in stems)} bitwise equal to their "
            f"plain versions; launches fused "
            f"{json.dumps(counts[0], sort_keys=True)}, unfused "
            f"{json.dumps(counts[1], sort_keys=True)}")


# ---------------------------------------------------------------------------
# The LM path: qwen2-1.5b served by ServeEngine
# ---------------------------------------------------------------------------

def lm_inputs(arch, cfg=LM):
    """The calibration batch (None without one) and the request trace
    (numpy seed 0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    calib = (rng.integers(0, arch.vocab_size, cfg["calib"]).astype(np.int32)
             if "calib" in cfg else None)
    lo, hi = cfg["prompt_lens"]
    lens = rng.integers(lo, hi + 1, cfg["requests"])
    prompts = [rng.integers(0, arch.vocab_size, n).astype(np.int32)
               for n in lens]
    return calib, prompts


def lm_engine(torch, arch, params, calib, quant, backend, layout, cfg=LM):
    """A ServeEngine of the LM path, its programs compiled (calibration
    included) outside any clock."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    engine = ServeEngine(
        arch, params, EngineConfig(quant=quant, backend=backend),
        batch_size=cfg["batch"], max_seq=cfg["max_seq"],
        calib_batches=[calib], prefill_len=cfg["prefill_len"],
        decode_burst=cfg["burst"], kv_layout=layout, page_size=cfg["page"])
    t1 = time.perf_counter()
    engine.prefill_program()
    engine.decode_program()
    torch.cuda.synchronize()
    log(f"lm engine {arch.name} {quant}/{backend}/{layout}: quantize + "
        f"calibration "
        f"digest {t1 - t0:.2f} s (digest {engine.digest_s:.2f} s), "
        f"calibrate + compile {time.perf_counter() - t1:.2f} s")
    return engine


def n_global(arch) -> int:
    return sum(arch.layer_kind(i) == "global" for i in range(arch.n_layers))


def check_lm_counts(label, counts, per_layer, arch, prefills, steps):
    """Each kernel launched its per-layer count on every layer it serves
    (GLOBAL_ONLY kernels: the global layers) for every prefill and decode
    step of the run, and no other kernel launched."""
    want = {}
    for phase, runs in (("prefill", prefills), ("decode", steps)):
        for name, per in per_layer[phase].items():
            layers = n_global(arch) if name in GLOBAL_ONLY else arch.n_layers
            want[name] = want.get(name, 0) + per * layers * runs
    for name, n in want.items():
        if n == 0 or counts.get(name, 0) != n:
            fail(f"{label}: {name}: {counts.get(name, 0)} launches over "
                 f"{prefills} prefills and {steps} decode steps, want {n}")
    extra = sorted(set(counts) - set(want))
    if extra:
        fail(f"{label}: launches of kernels off its path: {extra}")


def lm_serve(torch, engine, prompts, label, per_layer=None, cfg=LM):
    """The trace through submit / run, with the launch counters zeroed just
    before and read just after.  Returns the ids [requests, new tokens],
    the counts and the tokens/s."""
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.serve.base import LatencyTracker
    engine.latency = LatencyTracker()
    p0 = engine.serve_stats.prefill_calls
    d0 = engine.serve_stats.decode_steps
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    tickets = [engine.submit(p, cfg["new_tokens"]) for p in prompts]
    res = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.COUNTS)
    prefills = engine.serve_stats.prefill_calls - p0
    steps = engine.serve_stats.decode_steps - d0
    if not all(isinstance(t, int) for t in tickets):
        fail(f"{label}: a request was rejected")
    ids = np.stack([res[t] for t in tickets])
    if ids.shape != (len(prompts), cfg["new_tokens"]) or ids.min() < 0 \
            or ids.max() >= engine.arch.vocab_size:
        fail(f"{label}: ids of shape {ids.shape} in "
             f"[{ids.min()}, {ids.max()}]")
    if per_layer is not None:
        check_lm_counts(label, counts, per_layer, engine.arch, prefills,
                        steps)
    elif counts:
        fail(f"{label}: the ref backend launched kernels: {counts}")
    tps = ids.size / wall
    lat = engine.latency.percentiles()
    log(f"serve {label}: {len(prompts)} requests x {cfg['new_tokens']} "
        f"tokens in {wall:.4f} s = {tps:.2f} tokens/s, p50 "
        f"{lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms, {prefills} "
        f"prefills + {steps} decode steps, launches "
        f"{json.dumps(counts, sort_keys=True)}")
    return ids, counts, tps


def lm_kernel_phases(torch, engine, prompts, names, results, label,
                     per_layer, cfg=LM, timed=None, cold=()):
    """Every kernel call of one prefill and one decode step (one request
    per slot, one new token), each held bitwise against its plain version;
    the kernels named in `timed` (all of `names` when None) then timed per
    decode step (into `results` when given) and per prefill, those named in
    `cold` with the L2 flushed before every repeat.  Returns the recorded
    calls."""
    calls = capture_calls(torch, lambda: engine.generate(
        prompts[:cfg["batch"]], max_new_tokens=1))
    log_plans(label, calls)
    for name in names:
        layers = (n_global(engine.arch) if name in GLOBAL_ONLY
                  else engine.arch.n_layers)
        # a decode step's operands carry one row per slot
        is_dec = [name == "paged_gather"
                  or a[0].numel() // a[0].shape[-1] == cfg["batch"]
                  for a, _ in calls[name]]
        dec = [c for c, d in zip(calls[name], is_dec) if d]
        pre = [c for c, d in zip(calls[name], is_dec) if not d]
        want_pre = per_layer["prefill"].get(name, 0) * layers
        want_dec = per_layer["decode"].get(name, 0) * layers
        if len(dec) != want_dec or len(pre) != want_pre:
            fail(f"{label} {name}: {len(pre)} prefill and {len(dec)} decode "
                 f"calls, want {want_pre} and {want_dec}")
        if timed is not None and name not in timed:
            with torch.inference_mode():
                r = kernel_phase(torch, name, dec + pre, timed=False)
            log(f"kernel {name} at {label} shapes: {len(dec)} decode-step "
                f"and {len(pre)} prefill calls, bitwise equal to plain "
                f"(max_abs_err {r['max_abs_err']})")
            continue
        # the plain int4 GEMM runs its groups in sequence (thousands of
        # launches a step), so it is timed over fewer repeats
        with torch.inference_mode():
            r = kernel_phase(torch, name, dec, plain_reps=3,
                             cold=name in cold)
        log_kernel(f"{name} ({label})", r, per="decode step")
        if results is not None:
            results[name] = r
        if pre:
            with torch.inference_mode():
                r = kernel_phase(torch, name, pre, reps=5, plain_reps=2,
                                 cold=name in cold)
            log_kernel(f"{name} ({label})", r, per="prefill")
    return calls


def attention_phase(torch, calls, label, want_calls):
    """flash_attention's calls of one prefill: each held within ATTN_TOL of
    max|plain| against its plain version, timed per prefill, and compared
    bit for bit with the attention the ref backend's prefill runs instead
    (models/layers.py::flash_attention on the same q / k / v)."""
    from repro_torch.models import layers as L
    if len(calls) != want_calls:
        fail(f"flash_attention ({label}): {len(calls)} calls in one prefill, "
             f"want {want_calls}")
    with torch.inference_mode():
        r = kernel_phase(torch, "flash_attention", calls, reps=5,
                         plain_reps=5, tol=ATTN_TOL)
        same = 0
        for args, kwargs in calls:
            q, k, v = args[:3]
            b, hq, l, d = q.shape
            hkv = k.shape[1]
            got = _wrappers()["flash_attention"][0](*args, **kwargs)
            blocked = L.flash_attention(
                q.reshape(b, hkv, hq // hkv, l, d).permute(0, 3, 1, 2, 4),
                k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=True,
                logit_softcap=kwargs["softcap"])
            same += bool(torch.equal(got, blocked.permute(0, 2, 3, 1, 4)
                                     .reshape(b, hq, l, d)))
    log_kernel(f"flash_attention ({label}, {tuple(calls[0][0][0].shape)} "
               f"softcap {calls[0][1]['softcap']})", r, per="prefill")
    log(f"flash_attention ({label}): {same} of {len(calls)} calls bitwise "
        f"equal to the ref backend's prefill attention (models/layers.py)")
    return r


def attention_long(torch):
    """The flash attention at one longer shape (ATTN_LONG, seeded inputs),
    held and timed like a prefill's calls."""
    b, hq, hkv, l, d, cap = ATTN_LONG
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") * sc
               for shape, sc in (((b, hq, l, d), 3.0), ((b, hkv, l, d), 3.0),
                                 ((b, hkv, l, d), 1.0)))
    with torch.inference_mode():
        r = kernel_phase(torch, "flash_attention",
                         [((q, k, v), dict(causal=True, softcap=cap))],
                         reps=5, plain_reps=5, tol=ATTN_TOL)
    log_kernel(f"flash_attention (B {b}, {hq}/{hkv} heads, L = S = {l}, D "
               f"{d}, softcap {cap})", r, per="call")
    return r


def traced(torch, fn):
    """Device time (us) per kernel name over one call of `fn`
    (torch.profiler); an empty trace is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = device_us(prof)
        if sum(per.values()) > 0:
            return per
        log("torch.profiler reported no device time; profiling again")
    fail("torch.profiler reported no device time in three traces")


def clocked(torch, fn, n):
    """(the last result, median wall us, median host enqueue us) over n
    calls of `fn`: host clock from the call to its return (the enqueue),
    and on to a synchronize (the wall)."""
    import numpy as np
    walls, enqueue = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        enqueue.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    return out, float(np.median(walls)), float(np.median(enqueue))


def lm_profile(torch, engine, prompts, cfg=LM):
    """Where a decode step's and a prefill's time goes: each one's wall
    time (median of 5 decode steps, of 3 prefills; host clock around a
    synchronized call), the host time to enqueue it, and the device time
    per kernel (torch.profiler).  The compiled paged path prefills on a
    cache whose table holds every block; the eager path on a fresh dense
    cache, merged as the engine does."""
    import numpy as np
    b, plen, dev = engine.batch, cfg["prefill_len"], engine.device
    toks = np.zeros((b, plen), np.int32)
    for i, p in enumerate(prompts[:b]):
        toks[i, plen - len(p):] = p
    toks = torch.from_numpy(toks).to(dev)
    mask = torch.ones(b, dtype=torch.bool, device=dev)

    def prefill():
        cache = engine._empty_cache()
        if not engine.compiled:
            return engine._prefill_eager(cache, toks, mask)
        cache["tables"] = torch.arange(
            b * engine.kv_pages, dtype=torch.int32, device=dev).reshape(
            b, engine.kv_pages)
        return engine._prefill_paged(engine.prefill_program(), cache, toks,
                                     mask)

    def fresh():
        logits, cache = prefill()
        return cache, torch.argmax(logits[:, -1], -1)[:, None].to(
            torch.int32)

    with torch.inference_mode():
        cache, cur = fresh()
        state = {"cache": cache}

        def step():
            logits, state["cache"] = engine._decode_step(state["cache"], cur)
            return logits
        logits, dwall, denq = clocked(torch, step, 5)
        if not torch.isfinite(logits).all():
            fail("non-finite decode logits")
        dec = traced(torch, step)
        (logits, _), pwall, penq = clocked(torch, prefill, 3)
        if not torch.isfinite(logits).all():
            fail("non-finite prefill logits")
        pre = traced(torch, fresh)
    return {"decode step": (dwall, denq, dec), "prefill": (pwall, penq, pre)}


def log_profile(label, prof):
    for what, (wall, enq, per) in prof.items():
        busy = sum(per.values())
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        log(f"profile {label} {what}: device {busy:.1f} us, wall {wall:.1f} "
            f"us (median), host enqueue {enq:.1f} us, device busy "
            f"{100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%; "
            f"top device time: "
            + "; ".join(f"{k[:60]} {v:.1f} us" for k, v in top))


def lm_path(torch, results, add):
    """qwen2-1.5b at full width on the LM serving path (phase 8)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    t0 = time.perf_counter()
    arch = configs.get_arch(LM["arch"])
    params = init_params(T.lm_schema(arch), torch.Generator().manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaf_tensors(params))
    log(f"lm {arch.name}: {arch.n_layers} layers, d {arch.d_model}, heads "
        f"{arch.n_heads}/{arch.n_kv_heads} x {arch.head_dim}, d_ff "
        f"{arch.d_ff}, vocab {arch.vocab_size}: {n} float params in "
        f"{time.perf_counter() - t0:.2f} s")
    calib, prompts = lm_inputs(arch)

    # -- w4a8, CUDA, paged: the main path ------------------------------------
    engine = lm_engine(torch, arch, params, calib, "w4a8", "cuda", "paged")
    calls = lm_kernel_phases(torch, engine, prompts,
                             ("conv_pe_w4", "conv_pe_w4_res", "paged_gather"),
                             results, "w4a8", LM_PER_LAYER["w4a8"],
                             cold=("conv_pe_w4", "conv_pe_w4_res"))
    attention_phase(torch, calls["flash_attention"], arch.name,
                    n_global(arch))
    del calls
    ids, counts, _ = lm_serve(torch, engine, prompts, "w4a8/cuda/paged",
                              LM_PER_LAYER["w4a8"])
    add(counts)
    steady_lm(torch, engine, prompts, "w4a8/cuda/paged", TRIALS)
    log_profile("lm", lm_profile(torch, engine, prompts))
    del engine
    torch.cuda.empty_cache()

    # -- the same trace on the ref backend and on the dense cache ------------
    for backend, layout, what in (("ref", "paged", "backend='ref'"),
                                  ("cuda", "dense", "the dense KV cache")):
        other = lm_engine(torch, arch, params, calib, "w4a8", backend,
                          layout)
        got, counts, _ = lm_serve(
            torch, other, prompts, f"w4a8/{backend}/{layout}",
            None if backend == "ref" else
            {"prefill": LM_PER_LAYER["w4a8"]["prefill"],
             "decode": {"conv_pe_w4": 2, "conv_pe_w4_res": 2}})
        if not np.array_equal(got, ids):
            fail(f"w4a8 paged CUDA ids differ from {what}: "
                 f"{int((got != ids).sum())} of {ids.size}")
        log(f"ids w4a8: paged CUDA equal to {what} ({ids.size} tokens)")
        del other
        torch.cuda.empty_cache()

    # -- w8a8: the int8 Conv PE at the LM's shapes ---------------------------
    engine = lm_engine(torch, arch, params, calib, "w8a8", "cuda", "paged")
    lm_kernel_phases(torch, engine, prompts, ("conv_pe", "conv_pe_res"),
                     None, "w8a8 LM", LM_PER_LAYER["w8a8"],
                     cold=("conv_pe", "conv_pe_res"))
    ids8, counts, _ = lm_serve(torch, engine, prompts, "w8a8/cuda/paged",
                               LM_PER_LAYER["w8a8"])
    add(counts)
    steady_lm(torch, engine, prompts, "w8a8/cuda/paged", LM["w8a8_trials"])
    log_profile("lm w8a8", lm_profile(torch, engine, prompts))
    del engine
    torch.cuda.empty_cache()
    other = lm_engine(torch, arch, params, calib, "w8a8", "ref", "paged")
    got, _, _ = lm_serve(torch, other, prompts, "w8a8/ref/paged")
    if not np.array_equal(got, ids8):
        fail(f"w8a8 paged CUDA ids differ from backend='ref': "
             f"{int((got != ids8).sum())} of {ids8.size}")
    log(f"ids w8a8: paged CUDA equal to backend='ref' ({ids8.size} tokens); "
        f"w4a8 and w8a8 agree on {int((ids8 == ids).sum())} of {ids.size}")
    del other
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The gemma2 path: local ring layers, softcaps, the flash attention
# ---------------------------------------------------------------------------

def attn_edge_codes(torch, engines, tokens):
    """One prefill of `tokens` on each engine, recording every global
    layer's attention output and quantizing it at its static scale as the
    program does (the int8 edge into the O projection).  Returns the
    number of codes that differ between the two engines, and the total."""
    from repro_torch.compiler import executor as ex
    from repro_torch.core.quant import quantize_static
    codes = []
    orig = ex._attn_dispatch
    for engine in engines:
        program = engine.prefill_program()
        seen = {}

        def spy(n, *args):
            out = orig(n, *args)
            if n.layer_kind == "global" and program.plan.emit_int8[n.id]:
                seen[n.layer] = quantize_static(
                    out, program.plan.out_scale[n.id])
            return out
        ex._attn_dispatch = spy
        try:
            with torch.inference_mode():
                ex.execute(program, engine.params, tokens, engine.eng)
        finally:
            ex._attn_dispatch = orig
        codes.append(seen)
    if not codes[0] or sorted(codes[0]) != sorted(codes[1]):
        fail("the attention-output edge was not recorded on both engines")
    diff = sum(int((codes[0][i] != codes[1][i]).sum()) for i in codes[0])
    return diff, sum(t.numel() for t in codes[0].values())


def first_divergence(torch, np, ref_engine, prompts, ids, got):
    """(request, step, top-2 margin of the ref engine's logits there) of
    the first differing token: the request served alone again on the ref
    engine (its ids depend only on its own padded row), the logits of its
    prefill and decode steps recorded."""
    r = int(np.nonzero((ids != got).any(axis=1))[0][0])
    j = int(np.nonzero(ids[r] != got[r])[0][0])
    seen = []
    fill = "_prefill_paged" if ref_engine.paged else "_prefill_dense"
    for attr in (fill, "_decode_step"):
        orig = getattr(ref_engine, attr)

        def rec(*args, _orig=orig):
            logits, cache = _orig(*args)
            seen.append(logits[0, -1].float())
            return logits, cache
        setattr(ref_engine, attr, rec)
    try:
        ref_engine.generate([prompts[r]], max_new_tokens=j + 1)
    finally:
        for attr in (fill, "_decode_step"):
            delattr(ref_engine, attr)
    top = torch.topk(seen[j], 2)
    return r, j, float(top.values[0] - top.values[1])


def gemma2_path(torch, results, add):
    """gemma2-2b at full width on the compiled LM path (phase 9), then the
    reduced model across a ring wrap."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    long_r = attention_long(torch)
    t0 = time.perf_counter()
    arch = configs.get_arch(GEMMA["arch"])
    params = init_params(T.lm_schema(arch), torch.Generator().manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaf_tensors(params))
    log(f"lm {arch.name}: {arch.n_layers} layers ({n_global(arch)} global, "
        f"local window {arch.local_window}), d {arch.d_model}, heads "
        f"{arch.n_heads}/{arch.n_kv_heads} x {arch.head_dim}, d_ff "
        f"{arch.d_ff} {arch.mlp_act}, vocab {arch.vocab_size}, softcaps "
        f"{arch.attn_softcap}/{arch.final_softcap}: {n} float params in "
        f"{time.perf_counter() - t0:.2f} s")
    calib, prompts = lm_inputs(arch, GEMMA)
    label = "gemma2 w4a8/cuda/paged"
    engine = lm_engine(torch, arch, params, calib, "w4a8", "cuda", "paged",
                       GEMMA)
    calls = lm_kernel_phases(torch, engine, prompts,
                             ("conv_pe_w4", "misc_add", "paged_gather"), None,
                             arch.name, GEMMA_PER_LAYER, GEMMA,
                             timed=("conv_pe_w4",), cold=("conv_pe_w4",))
    r = attention_phase(torch, calls["flash_attention"], arch.name,
                        n_global(arch))
    r["max_abs_err"] = max(r["max_abs_err"], long_r["max_abs_err"])
    results["flash_attention"] = r
    del calls
    ids, counts, _ = lm_serve(torch, engine, prompts, label,
                              GEMMA_PER_LAYER, GEMMA)
    add(counts)
    steady_lm(torch, engine, prompts, label, GEMMA["trials"], GEMMA)
    log_profile("gemma2", lm_profile(torch, engine, prompts, GEMMA))

    # -- the same trace on the ref backend and on the dense cache ------------
    b, plen = GEMMA["batch"], GEMMA["prefill_len"]
    toks = np.zeros((b, plen), np.int32)
    for i, p in enumerate(prompts[:b]):
        toks[i, plen - len(p):] = p
    for backend, layout, what in (("ref", "paged", "backend='ref'"),
                                  ("cuda", "dense", "the dense KV cache")):
        other = lm_engine(torch, arch, params, calib, "w4a8", backend,
                          layout, GEMMA)
        got, _, _ = lm_serve(
            torch, other, prompts, f"gemma2 w4a8/{backend}/{layout}",
            None if backend == "ref" else
            {"prefill": GEMMA_PER_LAYER["prefill"],
             "decode": {"conv_pe_w4": 4, "misc_add": 2}}, GEMMA)
        if backend == "ref":
            diff, total = attn_edge_codes(
                torch, (engine, other), torch.from_numpy(toks).cuda())
            log(f"gemma2 attention-output edge, one prefill: {diff} of "
                f"{total} int8 codes differ between backend='cuda' and "
                f"backend='ref'")
            del engine
            torch.cuda.empty_cache()
        if not np.array_equal(got, ids):
            if backend == "ref":
                r_, j, margin = first_divergence(torch, np, other, prompts,
                                                 ids, got)
                log(f"gemma2 ids: request {r_} first differs at step {j}; "
                    f"the ref logits' top-2 margin there is {margin}")
            fail(f"gemma2 w4a8 paged CUDA ids differ from {what}: "
                 f"{int((got != ids).sum())} of {ids.size}")
        log(f"ids gemma2 w4a8: paged CUDA equal to {what} ({ids.size} "
            f"tokens)")
        del other
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    ring_path(torch)


def ring_path(torch):
    """The reduced gemma2 (window 64, head_dim 32) served on the CUDA and
    ref backends, paged and dense, with prompts + new tokens past the
    window, so the local layers' ring caches wrap; ids equal."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    arch = configs.reduced(configs.get_arch(GEMMA["arch"]))
    if RING["prefill_len"] + RING["new_tokens"] <= arch.local_window:
        fail(f"the ring trace does not cross the {arch.local_window}-token "
             "window")
    params = init_params(T.lm_schema(arch), torch.Generator().manual_seed(0),
                         device="cuda")
    calib, prompts = lm_inputs(arch, RING)
    ids = None
    for backend, layout in (("cuda", "paged"), ("ref", "paged"),
                            ("cuda", "dense")):
        engine = lm_engine(torch, arch, params, calib, "w4a8", backend,
                           layout, RING)
        per = None
        if backend == "cuda":
            per = {"prefill": GEMMA_PER_LAYER["prefill"],
                   "decode": dict(GEMMA_PER_LAYER["decode"])}
            if layout == "dense":
                del per["decode"]["paged_gather"]
        got, _, _ = lm_serve(torch, engine, prompts,
                             f"gemma2 reduced w4a8/{backend}/{layout}", per,
                             RING)
        if ids is None:
            ids = got
        elif not np.array_equal(got, ids):
            fail(f"gemma2 reduced ids across the ring wrap: {backend}/"
                 f"{layout} differs from cuda/paged at "
                 f"{int((got != ids).sum())} of {ids.size}")
    log(f"ids gemma2 reduced (window {arch.local_window}, positions to "
        f"{RING['prefill_len'] + RING['new_tokens']}): cuda paged equal to "
        f"ref paged and cuda dense ({ids.size} tokens)")


# ---------------------------------------------------------------------------
# The SSM path: falcon-mamba-7b served by ServeEngine on the eager path
# ---------------------------------------------------------------------------

def ssm_engine(torch, arch, params, backend):
    """A w8a8 ServeEngine of the SSM path (dense, eager, no calibration);
    its quantized tree is built outside any clock."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    engine = ServeEngine(
        arch, params, EngineConfig(quant="w8a8", backend=backend),
        batch_size=SSM["batch"], max_seq=SSM["max_seq"],
        prefill_len=SSM["prefill_len"], decode_burst=SSM["burst"])
    torch.cuda.synchronize()
    if engine.compiled or engine.calib_id is not None:
        fail(f"{arch.name}: expected the eager path without calibration")
    log(f"ssm engine w8a8/{backend}/dense: quantize "
        f"{time.perf_counter() - t0:.2f} s, lowering blockers "
        f"{engine.stats()['lowering_blockers']}")
    return engine


def ssm_kernel_phases(torch, engine, prompts, results):
    """Every kernel call of one prefill and one decode step (one request
    per slot, one new token), each held bitwise against its plain version:
    the causal conv timed per prefill (into `results`), the int8 Conv PE
    timed per projection shape, per decode step (M = batch) and per
    prefill (M = batch x prefill_len)."""
    calls = capture_calls(torch, lambda: engine.generate(
        prompts[:SSM["batch"]], max_new_tokens=1))
    layers = engine.arch.n_layers
    b, m_pre = SSM["batch"], SSM["batch"] * SSM["prefill_len"]
    conv = calls["dwc1d"]
    if len(conv) != layers or any(
            tuple(a[0].shape) != (b, SSM["prefill_len"],
                                  engine.arch.d_inner) for a, _ in conv):
        fail(f"dwc1d: {len(conv)} calls of shapes "
             f"{sorted({tuple(a[0].shape) for a, _ in conv})}, want "
             f"{layers} of one prefill's")
    with torch.inference_mode():
        r = kernel_phase(torch, "dwc1d", conv)
    results["dwc1d"] = r
    log_kernel("dwc1d (falcon-mamba)", r, per="prefill")
    log_plans("falcon-mamba", calls)
    groups = {}
    for a, k in calls["conv_pe"]:
        groups.setdefault((a[0].shape[0],) + tuple(a[1].shape), []).append(
            (a, k))
    for (m, kk, n), grp in sorted(groups.items()):
        if m not in (b, m_pre) or len(grp) != layers:
            fail(f"conv_pe (falcon-mamba): {len(grp)} calls at M={m} "
                 f"K={kk} N={n}, want {layers} at M={b} or {m_pre}")
        dec = m == b
        with torch.inference_mode():
            r = kernel_phase(torch, "conv_pe", grp,
                             reps=REPS if dec else 5,
                             plain_reps=REPS if dec else 3, cold=True)
        log_kernel(f"conv_pe (falcon-mamba M={m} K={kk} N={n})", r,
                   per="decode step" if dec else "prefill")
    if len(groups) != 8:
        fail(f"conv_pe (falcon-mamba): {len(groups)} shapes, want 4 "
             f"projections x decode and prefill")


def ssm_path(torch, results, add):
    """falcon-mamba-7b at full width on the eager SSM path (phase 10)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    log(f"ssm: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device "
        f"memory held by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arch = configs.get_arch(SSM["arch"])
    params = init_params(T.lm_schema(arch), torch.Generator().manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaf_tensors(params))
    log(f"ssm {arch.name}: {arch.n_layers} mamba layers, d {arch.d_model}, "
        f"d_inner {arch.d_inner}, ssm_state {arch.ssm_state}, conv_kernel "
        f"{arch.conv_kernel}, vocab {arch.vocab_size}: {n} float params in "
        f"{time.perf_counter() - t0:.2f} s")
    _, prompts = lm_inputs(arch, SSM)
    label = "falcon-mamba w8a8/cuda/dense"
    engine = ssm_engine(torch, arch, params, "cuda")
    ssm_kernel_phases(torch, engine, prompts, results)
    ids, counts, _ = lm_serve(torch, engine, prompts, label, SSM_PER_LAYER,
                              SSM)
    add(counts)
    steady_lm(torch, engine, prompts, label, SSM["trials"], SSM)
    log_profile("ssm", lm_profile(torch, engine, prompts, SSM))
    log(f"ssm peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    del engine
    torch.cuda.empty_cache()
    other = ssm_engine(torch, arch, params, "ref")
    got, _, _ = lm_serve(torch, other, prompts,
                         "falcon-mamba w8a8/ref/dense", None, SSM)
    if not np.array_equal(got, ids):
        fail(f"falcon-mamba CUDA ids differ from backend='ref': "
             f"{int((got != ids).sum())} of {ids.size}")
    log(f"ids falcon-mamba w8a8: CUDA equal to backend='ref' on the card "
        f"({ids.size} tokens)")
    del other, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The training path: full-width qwen2-1.5b on the float GEMM kernel
# ---------------------------------------------------------------------------

def f_ratio(torch, got, want):
    """(max abs err, elements apart, worst ratio of error to the bar) of a
    conv_pe_f call against its plain version: the bar is F_TOL x
    max|plain|, plus one bf16 ulp of each element at bf16 output; a
    non-finite output counts as past it."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    err = (g - w).abs()
    lim = torch.full_like(w, F_TOL * float(w.abs().max()))
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w.abs())
        lim = lim + torch.ldexp(torch.ones_like(w), e - 8)
    ratio = (float((err / lim).max()) if bool(torch.isfinite(g).all())
             else float("inf"))
    return float(err.max()), int((g != w).sum()), ratio


def f_check(torch, got, want):
    """f_ratio of a conv_pe_f call; fails past the bar."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"conv_pe_f: kernel {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    err, apart, ratio = f_ratio(torch, got, want)
    if not ratio <= 1.0:
        fail(f"conv_pe_f: kernel differs from its plain version by {err} "
             f"({ratio} x the bar: {F_TOL} x max|plain| + one bf16 ulp at "
             f"bf16 output) at {tuple(got.shape)}")
    return err, apart, ratio


def capture_gemm_f(torch, run):
    """Call `run()` with every conv_pe_f product (forward, recompute and
    backward, all through conv_pe._gemm_f) recording its arguments."""
    from repro_torch.kernels import conv_pe
    calls, orig = [], conv_pe._gemm_f

    def rec(*args):
        calls.append(args)
        return orig(*args)
    conv_pe._gemm_f = rec
    try:
        run()
    finally:
        conv_pe._gemm_f = orig
    torch.cuda.synchronize()
    return calls


def gemm_f_host_us(torch, calls, trials: int = 5) -> float:
    """Host us a call of the wrapper: the step's calls replayed back to back
    (enqueue only, the card synchronized before each replay), the least of
    `trials` replays over the call count."""
    from repro_torch.kernels import conv_pe
    best = None
    with torch.no_grad():
        for _ in range(trials):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for args in calls:
                conv_pe._gemm_f(*args)
            t = time.perf_counter() - t0
            best = t if best is None else min(best, t)
    torch.cuda.synchronize()
    return best / len(calls) * 1e6


def gemm_f_phase(torch, calls, n_forward):
    """Every recorded call held against its plain version and planned on the
    tensor-core route (a product on the FFMA route fails the phase); then
    per shape group (forward or backward, a, b and their layouts, bias,
    act, types) its plan and worst ratio of error to the bar logged and one
    call timed: the kernel, the plain version and cuBLAS (torch.matmul on
    the same types and views, the bias and act in torch ops), times the
    group's calls a step, against the bound (the larger of compulsory bytes
    at PEAK_BYTES and 2 M N K at PEAK_BF16).  The first `n_forward` calls
    are the forward's (autograd runs the whole forward before the
    backward); the rest, the gate recomputes and the backward products, are
    summed apart.  Last, the wrapper's host us a call (gemm_f_host_us)."""
    from repro_torch.kernels import conv_pe
    from repro_torch.kernels.ref import act_fn
    max_err, apart, total = 0.0, 0, 0
    groups, ratios = {}, {}
    with torch.no_grad():
        for i, (a, b, bias, act, out_dtype) in enumerate(calls):
            p = conv_pe.plan_of(a, b, act)
            if p.route != "wgmma":
                fail(f"conv_pe_f: a {a.dtype}{tuple(a.shape)} x "
                     f"{tuple(b.shape)} product of the step takes the "
                     f"{p.route} route")
            got = conv_pe._gemm_f(a, b, bias, act, out_dtype)
            want = conv_pe.matmul_f_fused_plain(a, b, bias, act, out_dtype)
            err, n, ratio = f_check(torch, got, want)
            max_err = max(max_err, err)
            if out_dtype == torch.bfloat16:
                apart += n
                total += got.numel()
            key = ("forward" if i < n_forward else "backward",
                   tuple(a.shape), tuple(b.shape), p.a_mn, p.b_mn,
                   bias is not None, act, str(a.dtype), str(out_dtype))
            groups.setdefault(key, []).append((a, b, bias, act, out_dtype))
            ratios[key] = max(ratios.get(key, 0.0), ratio)
    log(f"kernel conv_pe_f: {len(calls)} calls of one step within {F_TOL} x "
        f"max|plain| (max_abs_err {max_err}; worst error "
        f"{max(ratios.values()):.4f} x the bar); at bf16 output {apart} of "
        f"{total} elements one bf16 ulp apart, the rest equal")
    names = ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms")
    tot = {"forward": dict.fromkeys(names, 0.0),
           "backward": dict.fromkeys(names, 0.0)}
    bytes_s = ops_s = 0.0
    with torch.no_grad():
        for key, grp in sorted(groups.items()):
            a, b, bias, act, out_dtype = grp[0]
            m, k = a.shape
            n = b.shape[1]
            p = conv_pe.plan_of(a, b, act)
            log(f"plan conv_pe_f {key[0]} [{m}, {k}] x [{k}, {n}] "
                f"{'a^T' if p.a_mn else 'a'} x {'b' if p.b_mn else 'b^T'} "
                f"x{len(grp)}: {p.route} tile 128x128, {p.splits} K "
                f"split(s) of {p.kps} steps, epilogue "
                f"{'in a reduction pass' if p.pass_ else 'in the tiles'}; "
                f"worst error {ratios[key]:.4f} x the bar")
            nbytes = (sum(_nbytes(t) for t in (a, b, bias) if t is not None)
                      + m * n * (2 if out_dtype == torch.bfloat16 else 4))
            t_bytes, t_ops = nbytes / PEAK_BYTES, 2.0 * m * n * k / PEAK_BF16
            f = act_fn(act)

            def library():
                y = torch.matmul(a, b)
                if bias is not None:
                    y = y.to(torch.float32) + bias
                return f(y).to(out_dtype)
            ms, wall = cuda_ms(torch, lambda: conv_pe._gemm_f(*grp[0]))
            plain, _ = cuda_ms(
                torch, lambda: conv_pe.matmul_f_fused_plain(*grp[0]))
            lib, _ = cuda_ms(torch, library)
            c = len(grp)
            for name, v in zip(names, (ms, wall, plain, lib,
                                       max(t_bytes, t_ops) * 1e3)):
                tot[key[0]][name] += c * v
            bytes_s += c * t_bytes
            ops_s += c * t_ops
            log(f"kernel conv_pe_f {key[0]} [{m}, {k}] x [{k}, {n}] bias "
                f"{key[5]} act {act} {key[7]} -> {key[8]}: {c} calls/step, "
                f"per call kernel_ms {ms:.4f} (device; {wall:.4f} wall) "
                f"plain_ms {plain:.4f} library_ms {lib:.4f} (cuBLAS) "
                f"bound_ms {max(t_bytes, t_ops) * 1e3:.4f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}), "
                f"{2.0 * m * n * k / ms / 1e9:.2f} TFLOP/s")
    r = {"max_abs_err": max_err, "calls_per_run": len(calls), "tol": F_TOL,
         "bound_by": "bytes" if bytes_s >= ops_s else "operations",
         "host_us": gemm_f_host_us(torch, calls)}
    for name in names:
        r[name] = tot["forward"][name] + tot["backward"][name]
    for what, t in (("forward", tot["forward"]),
                    ("recompute + backward", tot["backward"]),
                    ("step", r)):
        log(f"kernel conv_pe_f per step, {what}: kernel_ms {t['ms']:.4f} "
            f"(device; {t['wall_ms']:.4f} wall) plain_ms "
            f"{t['plain_ms']:.4f} library_ms {t['library_ms']:.4f} "
            f"bound_ms {t['bound_ms']:.4f}")
    log(f"kernel conv_pe_f host: {r['host_us']:.2f} us a call (the step's "
        f"{len(calls)} calls replayed, least of 5), "
        f"{r['host_us'] * len(calls) / 1e3:.3f} ms a step against "
        f"{r['ms']:.3f} ms of kernel time")
    return r


def matmul_params(arch) -> int:
    """Parameters that enter matrix products (every projection, and the
    tied head)."""
    d, hd = arch.d_model, arch.head_dim
    attn = d * hd * (2 * arch.n_heads + 2 * arch.n_kv_heads)
    mlp = (3 if arch.mlp_gated else 2) * d * arch.d_ff
    return arch.n_layers * (attn + mlp) + arch.vocab_size * d


def train_launcher(torch):
    """launch.train.main on the reduced qwen2 on the card: 4 steps with a
    checkpoint every 2, then --resume to 6 steps, which must continue from
    the saved step 4 (in a temporary directory)."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import train as launch_train
    n, every = TRAIN["launcher_steps"], TRAIN["launcher_ckpt_every"]
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--arch", TRAIN["arch"], "--smoke", "--device", "cuda",
                "--ckpt-every", str(every), "--ckpt-dir", tmp]
        outs = []
        for extra in (["--steps", str(n)],
                      ["--steps", str(n + every), "--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = launch_train.main(args + extra)
            outs.append(buf.getvalue())
            if rc != 0:
                fail(f"launch.train.main {extra} returned {rc}:\n{outs[-1]}")
        steps = [[int(line.split()[1]) for line in o.splitlines()
                  if line.startswith("step ")] for o in outs]
        if steps[0] != list(range(n)) or \
                f"resumed from step {n}" not in outs[1] or \
                steps[1] != list(range(n, n + every)):
            fail(f"launcher resume: steps {steps}, output:\n{outs[1]}")
        saved = sorted(os.listdir(tmp))
    log(f"train launcher ({TRAIN['arch']} reduced, cuda): steps "
        f"{steps[0]}, checkpoints {saved}; --resume continued at step {n}: "
        f"steps {steps[1]}")


def train_path(torch, results, add):
    """qwen2-1.5b at full width on the training path (phase 11)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import engine as eng_lib
    from repro_torch.core.config import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.train.train_step import init_train_state, make_train_step
    log(f"train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of device "
        f"memory held by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    arch = configs.get_arch(TRAIN["arch"])
    b, l, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]

    def fresh_state():
        """The seeded starting state (host init, the same every time)."""
        t0 = time.perf_counter()
        params = init_params(T.lm_schema(arch),
                             torch.Generator().manual_seed(0), device="cuda")
        state = init_train_state(params)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaf_tensors(params))
        log(f"train {arch.name}: {n} f32 params (+ f32 Adam moments) in "
            f"{time.perf_counter() - t0:.2f} s; batch {b} x seq {l}")
        return state

    tcfg = TrainConfig(lr=3e-4, total_steps=steps, warmup_steps=1,
                       remat="none")
    pipe = SyntheticTokens(arch, ShapeConfig("train", l, b, "train"))
    cuda_step = make_train_step(arch, eng_lib.train_engine(), tcfg)
    ref_step = make_train_step(arch, eng_lib.train_engine("ref"), tcfg)
    state = fresh_state()

    # -- the kernel at every product of one step -----------------------------
    captured = {}
    calls = capture_gemm_f(torch, lambda: captured.update(
        m=cuda_step(state, pipe.batch_at(0))[1]))
    captured = {k: float(v) for k, v in captured["m"].items()}
    if len(calls) != TRAIN_PER_STEP:
        fail(f"conv_pe_f: {len(calls)} products in one step, want "
             f"{TRAIN_PER_STEP}")
    results["conv_pe_f"] = gemm_f_phase(torch, calls, 7 * arch.n_layers)
    log(f"train: peak device memory over the captured step and the kernel "
        f"checks {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del calls, state       # the captured step updated the state in place
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh_state()

    # -- the main path: `steps` steps on the CUDA backend, counted ------------
    losses, walls = [], []
    torch.cuda.synchronize()
    _build.reset_counts()
    for i in range(steps):
        t1 = time.perf_counter()
        state, m = cuda_step(state, pipe.batch_at(i))
        met = {k: float(v) for k, v in m.items()}   # synchronizes
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(met["loss"])
        if i == 0:
            first = met
        log(f"train step {i}: loss {met['loss']:.6f} nll {met['nll']:.6f} "
            f"grad_norm {met['grad_norm']:.6f} lr {met['lr']:.6g} accuracy "
            f"{met['accuracy']:.6f}, {walls[-1]:.1f} ms")
    torch.cuda.synchronize()
    counts = dict(_build.COUNTS)
    for k in ("loss", "grad_norm"):
        if first[k] != captured[k]:
            fail(f"train: step 0 from the same state gave {k} "
                 f"{captured[k]!r}, then {first[k]!r}: not bit-identical")
    log(f"train step 0 twice from the same seeded state: loss "
        f"{first['loss']!r} and grad_norm {first['grad_norm']!r} "
        f"bit-identical")
    if counts != {"conv_pe_f": TRAIN_PER_STEP * steps}:
        fail(f"train: launches {counts}, want conv_pe_f "
             f"{TRAIN_PER_STEP} x {steps} steps and nothing else")
    add(counts)
    if not all(np.isfinite(losses)):
        fail(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over {steps} steps: {losses}")
    med = float(np.median(walls[1:]))
    tokens = b * l
    mfu = 6.0 * matmul_params(arch) * tokens / (med / 1e3) / PEAK_BF16
    log(f"train {arch.name} cuda: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
        f"over {steps} steps; median step {med:.1f} ms over steps 2-{steps} "
        f"= {tokens / med * 1e3:.1f} tokens/s, mfu {100 * mfu:.3f}% "
        f"({matmul_params(arch)} matrix params, peak {PEAK_BF16:.3g}); "
        f"launches {json.dumps(counts)}")

    # -- more steps, clocked and profiled (not counted) -----------------------
    holder = {"state": state}
    del state

    def one_step():
        holder["state"], m = cuda_step(holder["state"], pipe.batch_at(steps))
        return m
    _, wall, enq = clocked(torch, one_step, 3)
    per = traced(torch, one_step)
    log_profile("train", {"step": (wall, enq, per)})
    log(f"train peak device memory over the steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the state "
        f"updated in place)")
    del holder
    gc.collect()
    torch.cuda.empty_cache()

    # -- the ref backend's first steps from the same (re-made) state ----------
    ref_m, ref_ms, state = [], [], fresh_state()
    for i in range(TRAIN["ref_steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = ref_step(state, pipe.batch_at(i))
        ref_m.append({k: float(v) for k, v in m.items()})
        ref_ms.append((time.perf_counter() - t1) * 1e3)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for k, tol in (("loss", TRAIN_LOSS_TOL), ("grad_norm", TRAIN_GNORM_TOL)):
        rel = abs(first[k] - ref_m[0][k]) / abs(ref_m[0][k])
        log(f"train step 0 {k}: cuda {first[k]:.6f}, ref {ref_m[0][k]:.6f} "
            f"(relative gap {rel:.3e}, tolerance {tol})")
        if not rel <= tol:
            fail(f"train: step-1 {k} of the CUDA backend {first[k]} vs the "
                 f"ref backend's {ref_m[0][k]}: {rel} relative > {tol}")
    log(f"train ref backend (cuBLAS bf16) steps: "
        f"{', '.join(f'{x:.1f}' for x in ref_ms)} ms; losses "
        f"{', '.join(str(m['loss']) for m in ref_m)}")
    train_launcher(torch)


def _steady_once(torch, engine, prompts, cfg=LM):
    """One more pass of the trace, not counted: tokens/s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts:
        engine.submit(p, cfg["new_tokens"])
    engine.run()
    torch.cuda.synchronize()
    return len(prompts) * cfg["new_tokens"] / (time.perf_counter() - t0)


def steady_lm(torch, engine, prompts, label, trials, cfg=LM):
    """The trace served `trials` more times (not counted): median tokens/s,
    latency percentiles over every request."""
    import numpy as np
    rates, lats = [], []
    for _ in range(trials):
        engine.latency.samples_ms = []
        rates.append(_steady_once(torch, engine, prompts, cfg))
        lats.extend(engine.latency.samples_ms)
    lat = np.asarray(lats)
    log(f"serve steady {label}: {trials} x {len(prompts)} requests, median "
        f"{np.median(rates):.2f} tokens/s (min {min(rates):.2f}, max "
        f"{max(rates):.2f}), p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms over {lat.size} requests")


def _leaf_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_tensors(v)
    else:
        yield tree


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core import engine as eng_lib
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_schema
    from repro_torch.models.params import init_params
    from repro_torch.serve.cnn_engine import CNNServeEngine

    # -- 1. the card and the build -------------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in libs.values())})")

    eng = eng_lib.paper_engine(backend="cuda")
    ref_eng = EngineConfig(quant="w8a8", backend="ref")
    engine = CNNServeEngine(eng, wave_size=4)
    results, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- 2-3. MobileNetV2: kernel phases, then served ------------------------
    cfg = CNN_ZOO["mobilenetv2"]
    params = init_params(cnn_schema(cfg), torch.Generator().manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    hw = cfg.input_hw
    calib = (rng.normal(size=(4, hw, hw, 3)) * 0.5).astype(np.float32)
    images = (rng.normal(size=(8, hw, hw, 3)) * 0.5).astype(np.float32)
    engine.register(cfg, params, calib_batches=[calib])
    add(serve_model(torch, engine, cfg, images, ref_eng, results)[1])

    # -- 4. ResNet50 fused, served --------------------------------------------
    rcfg = CNN_ZOO["resnet50"]
    rparams = init_params(cnn_schema(rcfg), torch.Generator().manual_seed(0),
                          device="cuda")
    rng = np.random.default_rng(1)
    hw = rcfg.input_hw
    rcalib = (rng.normal(size=(4, hw, hw, 3)) * 0.5).astype(np.float32)
    rimages = (rng.normal(size=(8, hw, hw, 3)) * 0.5).astype(np.float32)
    engine.register(rcfg, rparams, calib_batches=[rcalib])
    rlogits, counts = serve_model(torch, engine, rcfg, rimages, ref_eng,
                                  results)
    add(counts)

    # -- 5. ResNet50 unfused ----------------------------------------------------
    add(unfused_path(torch, rcfg, rparams, rcalib, rimages, eng, ref_eng,
                     rlogits, results))

    # -- 6. avgpool2d through ops ---------------------------------------------
    add(avgpool_path(torch, eng, results))

    # -- 7. the zoo sweep -------------------------------------------------------
    zoo_sweep(torch, eng, ref_eng)

    # -- 8. qwen2-1.5b served ---------------------------------------------------
    t0 = time.perf_counter()
    lm_path(torch, results, add)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase qwen2-1.5b {time.perf_counter() - t0:.1f} s")

    # -- 9. gemma2-2b served, and the reduced model across a ring wrap --------
    t0 = time.perf_counter()
    gemma2_path(torch, results, add)
    gc.collect()              # engines in reference cycles free their trees
    torch.cuda.empty_cache()
    log(f"phase gemma2-2b {time.perf_counter() - t0:.1f} s")

    # -- 10. falcon-mamba-7b served on the eager SSM path ----------------------
    t0 = time.perf_counter()
    ssm_path(torch, results, add)
    # the last cold phase: the L2 flush's 128 MB and the int8 Conv PE's
    # scratch go before training measures its peak memory
    from repro_torch.kernels import conv_pe
    _FLUSH.clear()
    conv_pe._SCRATCH.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase falcon-mamba-7b {time.perf_counter() - t0:.1f} s")

    # -- 11. qwen2-1.5b trained on the float GEMM kernel -----------------------
    t0 = time.perf_counter()
    train_path(torch, results, add)
    log(f"phase train qwen2-1.5b {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # -- 12. the result lines --------------------------------------------------
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        if not launches.get(name):
            fail(f"{name}: no launch on the main path")
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
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
