#!/usr/bin/env python3
"""The int8 Conv PE's two planned paths, side by side on the card.

    PYTHONPATH=src python scripts/conv_pe_probe.py
    python scripts/conv_pe_probe.py --serve [--src OTHER_TREE/src]
    python scripts/conv_pe_probe.py --float [--host]
    python scripts/conv_pe_probe.py --w4 [--parts]
    python scripts/conv_pe_probe.py --gelu [--parent OTHER_TREE]

Default: for each shape, every candidate plan -- the planner's own, the
other path where both kernels take the shape, other K splits of the
tensor-core tiles, the other epilogue placement -- is launched through
`conv_pe.matmul_int8_fused` with `conv_pe.plan` replaced by that plan for
the call, held bit for bit against the plain version, and timed with
chip_smoke's `cuda_ms(cold=True)` over REPS calls, the 50 MB L2 flushed
before each (as a served decode step finds its weights cold): device ms a
call from torch.profiler (every kernel the call launches -- the split's
zero fill too -- and not the flush; only whole traces, as cuda_ms says),
and the mean CUDA-event ms around each call in brackets.
`torch._int_mm` on the same operands (M padded to 32, the weights laid out
"TN" outside the timing) is timed the same way as the yardstick.  The
planner's thresholds (STREAM_MAX_M, STREAM_MIN_KN, the split and
fused-epilogue rules) are read off these lines.  Last, the wrapper's host
cost a call (back-to-back calls at shapes the device finishes first) and
its parts.

--serve: MobileNetV2 and ResNet50 (224 px, seeded weights) served as
chip_smoke serves them, the variants interleaved trace by trace (the host
is shared and drifts): steady images/s, the host enqueue of a program run,
the host time of a wave's Conv PE calls replayed, and device time a wave
(chip_smoke.profile_wave).  Variants: the planner
as it is; the scratch allocated on every call; the epilogue fused on
every unsplit plan.  With --src the same runs use the `repro_torch` of
another tree (its own variant only), so two commits compare in one
machine: run parent, this tree, this tree, parent.

--float: the float GEMM (conv_pe_f) at the 15 shape groups of a
full-width qwen2-1.5b training step (batch 8 x seq 128), each operand in
the layout the step gives it (the backward's b^T and a^T as views): every
candidate K split of the 128 x 128 tensor-core tiles forced through
`conv_pe.plan_f`, held against the plain version (the worst ratio of error
to chip_smoke's per-call bar, F_TOL x max|plain| plus one bf16 ulp at bf16
output; above 1 fails) and timed with the L2 flushed before every call,
beside cuBLAS bf16 (torch.matmul on the same views, the bias and act in
torch ops) timed the same way; "(planned)" marks the split
conv_pe.tc_splits picks, and its rule is read off these lines.  Then the
wrapper's host us a call and its parts (--host: those alone).  Last, the
fixed costs of the short products (float_fixed, warm L2 as chip_smoke
times them; --fixed: those alone): each kernel of the planned call and of
cuBLAS's, every K split, a ladder of K with its least-squares line (us at
zero K steps and a step), and an empty kernel launched with the tiles'
block and shared memory at the plan's grid.

--w4: the int4 Conv PE (matmul_int4_fused) at the w4a8 projections of
qwen2-1.5b and gemma2-2b (QKV, gate/up, O, down; group size 64) at M = 4
(a decode step), 16 and 256 (a prefill): every candidate plan -- each
stream strip at M <= 16, the 64 x 64 tensor-core tiles at M > 4 --
forced through `conv_pe.plan_w4`, held bit for bit against the
plain version and timed with `cuda_ms(cold=True)`, beside the int8 Conv PE
at the same (M, N, K) (its own plan, cold) as the yardstick and the bound
(the packed weights, f16 scales and zeros, A and the int8 output at 3.35
TB/s, or the MACs at 1,979 TOPS).  W4_STREAM_MAX_M and plan_w4's strip rule
are read off these lines.  --w4 --parts builds variants of
csrc/conv_pe_w4.cu with one part cut out by a textual edit (W4_PARTS: the
stream kernel's weight copies, products, atomics and fold; the tiles'
products, unpack and fold) and times each on the planned plan at qwen2's
gate/up and down at M = 4 and 256, cold: where each kernel's time goes.

--gelu: the int8 Conv PE's tanh-gelu epilogue.  chip_smoke's sweep (a
zero-A GEMM whose bias holds 2^20 values over [-12, 12], +-0, denormals
and +-1e30) on every route against the plain version, torch's CUDA
F.gelu(approximate="tanh"), bit for bit; then the same sweep on the
stream route of variants of csrc/conv_pe.cu whose act4 calls a textual
copy of epilogue.cuh's gelu_tanh with one step changed (GELU_VARIANTS: the
FMA written as a rounded multiply and add, a second FMA in the last
step), so the line that matches torch shows which multiply-adds nvcc
contracted in torch's kernel.  Then the epilogue's
cost: gelu against none at recurrentgemma-2b's gelu projections, cold;
with --parent, the int8 Conv PE of another tree (its csrc/conv_pe.cu
built beside this one's) against this tree's on the planned plans of the
LM decode and prefill shapes (act none, f32 out, cold) and the CNN shapes
(relu6, int8 out, warm), in turns parent, this, this, parent.

Needs one GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

REPS = 30
SERVE_TRIALS = 30
# (N, K): the LM decode projections (falcon-mamba x_proj, out_proj,
# in_proj, dt_proj; qwen2 down, QKV, gate/up, O) at M = 4 and 8; then
# (M, N, K) prefill and CNN shapes
DECODE = [(288, 8192), (4096, 8192), (16384, 4096), (8192, 256),
          (1536, 8960), (2048, 1536), (17920, 1536), (1536, 1536)]
PREFILL = [(256, 288, 8192), (256, 16384, 4096), (256, 8192, 256),
           (256, 4096, 8192), (256, 2048, 1536), (256, 17920, 1536),
           (256, 1536, 1536), (256, 1536, 8960)]
CNN = [(50176, 96, 16), (50176, 16, 32), (12544, 144, 24), (12544, 24, 144),
       (3136, 192, 32), (784, 384, 64), (196, 1280, 320), (12544, 256, 576),
       (3136, 512, 1152), (784, 2048, 4608)]
X_PROJ_SPLITS = (1, 2, 4, 8, 16, 22, 32, 64)
# host cost: shapes whose device time is well under the wrapper's host time
HOST = [(4, 1536, 1536), (784, 64, 192), (784, 384, 64), (4, 17920, 1536)]
# K splits tried at each float shape group (conv_pe.STEP_F_GROUPS); the
# short products' fixed costs: their groups, and the K of the ladder
F_SPLITS = (1, 2, 3, 4, 6, 8, 12)
F_SMALL = ("fwd K/V", "da K/V", "db K/V", "da Q/O")
F_LADDER = (64, 128, 256, 512, 1024)


def log(*a):
    print(*a, flush=True)


def operands(torch, np, m, n, k, rng):
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    wsc = torch.from_numpy(rng.uniform(0.005, 0.05, (1, n)).astype(
        np.float32))
    return a.cuda(), b.cuda(), wsc.cuda()


def run_plan(torch, smoke, conv_pe, p, a, b, wsc):
    """(bitwise, (device ms, wall ms)) of the product on plan p."""
    orig = conv_pe.plan
    conv_pe.plan = lambda *args: p

    def call():
        return conv_pe.matmul_int8_fused(a, b, 0.0173, wsc, None, "relu",
                                         0.0621)
    try:
        want = conv_pe.matmul_int8_fused_plain(a, b, 0.0173, wsc, None,
                                               "relu", 0.0621)
        ok = bool(torch.equal(call(), want))
        ms = smoke.cuda_ms(torch, call, REPS, cold=True)
    finally:
        conv_pe.plan = orig
    return ok, ms


def int_mm_ms(torch, smoke, a, b):
    m, k = a.shape
    ap = torch.zeros((max(32, -(-m // 8) * 8), k), dtype=torch.int8,
                     device="cuda")
    ap[:m] = a
    bt = b.t().contiguous().t()
    return smoke.cuda_ms(torch, lambda: torch._int_mm(ap, bt), REPS,
                         cold=True)


def report(tag, m, n, k, p, ok, ms, lib):
    bound = (m * k + k * n + m * n) / 3.35e12 * 1e3
    log(f"{tag} M={m} N={n} K={k}: {p.path} {p.bm}x{p.bn} splits "
        f"{p.splits} ks {p.ks} wa {p.wa} wb {p.wb} "
        f"{'fused' if p.fused else 'pass'}: {ms[0]:.4f} ms "
        f"({ms[1]:.4f}) {'bitwise' if ok else 'DIFFERS'}; int_mm "
        f"{lib[0]:.4f} ({lib[1]:.4f}) ms; bytes bound {bound:.4f} ms")
    return ok


def host_us(torch, fn, n=300) -> float:
    """Host us a call over n back-to-back calls: the device keeps up, so the
    loop runs at the host's pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def plans(torch, np, smoke, conv_pe) -> bool:
    rng = np.random.default_rng(0)
    good = True

    def planned(a, b):
        m, k = a.shape
        return conv_pe.plan(m, b.shape[1], k, conv_pe.byte_align(a),
                            conv_pe.byte_align(b))

    for m in (4, 8):
        for n, k in DECODE:
            a, b, wsc = operands(torch, np, m, n, k, rng)
            lib = int_mm_ms(torch, smoke, a, b)
            p = planned(a, b)
            cands = [("mma", conv_pe.mma_plan(m, n, k, p.wa, p.wb))]
            if m <= conv_pe.STREAM_MAX_M:
                s = conv_pe.stream_plan(m, n, k, p.wa, p.wb)
                splits, ks = conv_pe._slices(
                    k, 2 * math.ceil(conv_pe.SMS / math.ceil(n / s.bn)),
                    conv_pe.STREAM_KG)
                cands += [("stream", s),
                          ("stream waves 2", s._replace(
                              splits=splits, ks=ks, fused=splits == 1))]
            for tag, q in cands:
                tag += " (planned)" if q == p else ""
                good &= report(f"decode {tag}", m, n, k, q,
                               *run_plan(torch, smoke, conv_pe, q, a, b,
                                         wsc), lib)
    m, n, k = PREFILL[0]
    a, b, wsc = operands(torch, np, m, n, k, rng)
    lib = int_mm_ms(torch, smoke, a, b)
    for s in X_PROJ_SPLITS:
        ks = math.ceil(math.ceil(k / s) / conv_pe.MMA_BK) * conv_pe.MMA_BK
        q = planned(a, b)._replace(splits=math.ceil(k / ks), ks=ks,
                                   fused=s == 1)
        good &= report(f"x_proj split {s}", m, n, k, q,
                       *run_plan(torch, smoke, conv_pe, q, a, b, wsc), lib)
    for m, n, k in PREFILL + CNN:
        a, b, wsc = operands(torch, np, m, n, k, rng)
        p = planned(a, b)
        lib = int_mm_ms(torch, smoke, a, b)
        good &= report("planned", m, n, k, p,
                       *run_plan(torch, smoke, conv_pe, p, a, b, wsc), lib)
        cands = []
        if p.splits == 1:                     # the other epilogue placement
            q = p._replace(fused=not p.fused)
            cands.append(("fused" if q.fused else "epilogue pass", q))
        if p.path == "mma" and p.bn < 128:
            cands.append(("wide tile", p._replace(bn=128, fused=False)))
        for tag, q in cands:
            good &= report(tag, m, n, k, q,
                           *run_plan(torch, smoke, conv_pe, q, a, b, wsc),
                           lib)
    return good


def host(torch, np, conv_pe) -> None:
    from repro_torch.kernels import _build
    rng = np.random.default_rng(1)
    for m, n, k in HOST:
        a, b, wsc = operands(torch, np, m, n, k, rng)
        p = conv_pe.plan(m, n, k, 16, 16)
        ap = torch.zeros((max(32, -(-m // 8) * 8), k), dtype=torch.int8,
                         device="cuda")
        bt = b.t().contiguous().t()
        wrap = host_us(torch, lambda: conv_pe.matmul_int8_fused(
            a, b, 0.0173, wsc, None, "relu", 0.0621))
        lib = host_us(torch, lambda: torch._int_mm(ap, bt))
        plan_us = host_us(torch, lambda: conv_pe.plan(m, n, k, 16, 16))
        log(f"host M={m} N={n} K={k} {p.path} splits {p.splits} "
            f"{'fused' if p.fused else 'pass'}: wrapper {wrap:.1f} us a "
            f"call, torch._int_mm {lib:.1f} us, plan() {plan_us:.2f} us")
    # the wrapper's parts, on the last shape's operands
    lib_ = conv_pe._lib()
    stream = _build.stream_ptr(a)
    args = (a.data_ptr(), b.data_ptr(), 0, m, n, k, 7, 0, 0, 1, k, 1, 1, 1,
            None, None, 1.0, wsc.data_ptr(), None, 0, 1, None, 1.0, None, 0,
            1.0, 0, 1.0, 0, stream)
    parts = {
        "ctypes call (refused plan)": lambda: lib_.conv_pe_gemm(*args),
        "stream_ptr": lambda: _build.stream_ptr(a),
        "torch.empty out": lambda: torch.empty((m, n), device=a.device,
                                               dtype=torch.int8),
        "scratch (reused)": lambda: conv_pe._scratch(a, m * n, stream),
        "torch.empty scratch": lambda: torch.empty(
            m * n, dtype=torch.int32, device=a.device),
        "require a_q": lambda: _build.require(a, "a_q", torch.int8),
        "w_scale check": lambda: conv_pe._vec(wsc, "w_scale", n),
        "byte_align x2": lambda: (conv_pe.byte_align(a),
                                  conv_pe.byte_align(b)),
        "act_code x2": lambda: (_build.act_code("relu"),
                                _build.act_code("none")),
    }
    log("host parts: " + ", ".join(f"{k_} {host_us(torch, f, 2000):.2f} us"
                                   for k_, f in parts.items()))


def variants(torch, conv_pe):
    """{name: (enter, leave)}: the serving variants this tree can run."""
    if not hasattr(conv_pe, "stream_plan"):
        return {"this tree": (lambda: None, lambda: None)}
    orig_plan, orig_scratch = conv_pe.plan, conv_pe._scratch

    def fused_unsplit(*args):
        p = orig_plan(*args)
        return p._replace(fused=True) if p.splits == 1 else p

    def scratch_each_call(t, n, stream):
        return torch.empty(n, dtype=torch.int32, device=t.device)

    def setter(plan_fn, scratch_fn):
        def enter():
            conv_pe.plan, conv_pe._scratch = plan_fn, scratch_fn
        return enter

    def leave():
        conv_pe.plan, conv_pe._scratch = orig_plan, orig_scratch
    return {"planned": (setter(orig_plan, orig_scratch), leave),
            "scratch each call": (setter(orig_plan, scratch_each_call),
                                  leave),
            "fused where unsplit": (setter(fused_unsplit, orig_scratch),
                                    leave)}


def _host_ms(torch, fn) -> float:
    """Host ms of fn() from an idle device (synchronized before and after
    the clock stops)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return t


def serve(torch, np, smoke, conv_pe) -> bool:
    """SERVE_TRIALS rounds; in each, every variant in turn: the host ms of
    replaying the Conv PE calls of one wave (captured from the served
    path), the host enqueue of one program run, and one 8-request trace's
    images/s.  Then per variant one profiled wave (device time) and its
    logits against the ref backend's."""
    from repro_torch import compiler
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core import engine as eng_lib
    from repro_torch.core.config import EngineConfig
    from repro_torch.models.cnn import cnn_schema
    from repro_torch.models.params import init_params
    from repro_torch.serve.cnn_engine import CNNServeEngine
    engine = CNNServeEngine(eng_lib.paper_engine(backend="cuda"),
                            wave_size=4)
    ref_eng = EngineConfig(quant="w8a8", backend="ref")
    models = {}
    for seed, name in enumerate(("mobilenetv2", "resnet50")):
        cfg = CNN_ZOO[name]
        params = init_params(cnn_schema(cfg),
                             torch.Generator().manual_seed(0), device="cuda")
        rng = np.random.default_rng(seed)
        hw = cfg.input_hw
        calib = (rng.normal(size=(4, hw, hw, 3)) * 0.5).astype(np.float32)
        images = (rng.normal(size=(8, hw, hw, 3)) * 0.5).astype(np.float32)
        engine.register(cfg, params, calib_batches=[calib])
        calls = smoke.capture_calls(
            torch, lambda: engine.infer(name, images[:4]))
        gemms = [(args, kw) for k in ("conv_pe", "conv_pe_res")
                 for args, kw in calls[k]]
        models[name] = images, gemms

    def replay(gemms):
        for args, kw in gemms:
            conv_pe.matmul_int8_fused(*args, **kw)

    def one_trace(name, images):
        t0 = time.perf_counter()
        for img in images:
            engine.submit(name, img)
            engine.pump()
        engine.flush()
        return len(images) / (time.perf_counter() - t0)

    vars_ = variants(torch, conv_pe)
    got = {}
    for _ in range(SERVE_TRIALS):
        for var, (enter, leave) in vars_.items():
            enter()
            try:
                for name, (images, gemms) in models.items():
                    run, qparams = engine._executor_for(name)
                    buf = torch.from_numpy(images[:4]).cuda()
                    rec = got.setdefault((var, name), ([], [], []))
                    rec[0].append(_host_ms(torch, lambda: replay(gemms)))
                    rec[1].append(_host_ms(torch,
                                           lambda: run(qparams, buf)))
                    rec[2].append(one_trace(name, images))
            finally:
                leave()
    good = True
    for var, (enter, leave) in vars_.items():
        enter()
        try:
            for name, (images, gemms) in models.items():
                run, qparams = engine._executor_for(name)
                want = compiler.execute(
                    engine.program_for(name), qparams,
                    torch.from_numpy(images[:4]).cuda(), ref_eng)
                ok = bool(np.array_equal(
                    np.asarray(engine.infer(name, images[:4])),
                    want.cpu().numpy()))
                good &= ok
                _, _, per = smoke.profile_wave(torch, engine, name,
                                               images[:4])
                gemm_ms, enq_ms, rate = (np.asarray(x)
                                         for x in got[(var, name)])
                log(f"serve {var} {name}: steady {np.median(rate):.2f} "
                    f"images/s (median of {SERVE_TRIALS} interleaved "
                    f"traces; {rate.min():.2f}-{rate.max():.2f}); host "
                    f"enqueue of a program run {np.median(enq_ms):.3f} ms "
                    f"(min {enq_ms.min():.3f}); its {len(gemms)} Conv PE "
                    f"calls replayed {np.median(gemm_ms):.3f} ms (min "
                    f"{gemm_ms.min():.3f}); device {sum(per.values()):.1f} "
                    f"us a wave; logits "
                    f"{'bitwise equal to' if ok else 'DIFFER from'} the ref "
                    f"backend's")
        finally:
            leave()
    return good


def f_operands(torch, np, m, n, k, a_mn, b_nmaj, bias, rng):
    """bf16 a [M, K] (a view of a stored [K, M] when a_mn), b [K, N] (a
    view of a stored [N, K] unless b_nmaj), f32 bias [N] or None."""
    a = torch.from_numpy(rng.normal(size=(k, m) if a_mn else (m, k)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    b = torch.from_numpy((rng.normal(size=(k, n) if b_nmaj else (n, k)) /
                          np.sqrt(k)).astype(np.float32)).cuda().to(
        torch.bfloat16)
    bv = (torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).cuda()
          if bias else None)
    return (a.t() if a_mn else a), (b if b_nmaj else b.t()), bv


def f_candidates(conv_pe, m, n, k, a_mn, b_nmaj, act):
    """The tensor-core plans of a product at each reachable F_SPLITS K
    split (no empty slice), with the reduction pass where it is needed."""
    nk = math.ceil(k / conv_pe.TC_BK)
    out = []
    for s in F_SPLITS:
        kps = math.ceil(nk / s)
        if math.ceil(nk / kps) == s:
            out.append(conv_pe.PlanF("wgmma", s, kps, a_mn, b_nmaj,
                                     s > 1 or act not in conv_pe.TC_TILE_ACTS))
    return out


def kernel_us(torch, smoke, fn, reps=REPS):
    """{kernel name: device us a call} of fn() from torch.profiler over
    `reps` warm calls; a trace whose event counts are not a multiple of
    `reps` (lost events) is taken again, up to four in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    per = {}
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {e.key: (us, e.count) for e in prof.key_averages()
               if (us := smoke._self_us(e)) > 0}
        if per and all(c % reps == 0 for _, c in per.values()):
            break
    return {k: us / reps for k, (us, _) in per.items()}


EMPTY_SRC = r"""
#include "conv_pe_f.cu"
namespace {
__global__ void __launch_bounds__(TC_THREADS, 1) empty_kernel() {}
}
// an empty kernel launched as conv_pe_f_tc launches gemm_tc_kernel: the
// same block, the same dynamic shared memory, `grid` blocks
extern "C" int empty_tc(int grid, void* stream) {
  static bool sized = false;
  if (!sized) {
    cudaFuncSetAttribute(empty_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TC_SMEM);
    sized = true;
  }
  empty_kernel<<<grid, TC_THREADS, TC_SMEM,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_lib():
    """ctypes library with empty_tc(grid, stream), compiled from EMPTY_SRC
    against csrc/conv_pe_f.cu's constants (nvcc, the port's flags)."""
    import ctypes
    import kernel_variants
    from repro_torch.kernels import _build
    _build.BUILD.mkdir(exist_ok=True)
    src = _build.BUILD / "probe_empty.cu"
    src.write_text(EMPTY_SRC)
    lib = kernel_variants.finish(
        *kernel_variants.start(_build, "probe_empty", src), "the empty kernel")
    lib.empty_tc.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_tc.restype = ctypes.c_int
    return lib


def float_fixed(torch, np, smoke, conv_pe) -> None:
    """Where the short products' time goes (warm L2, as chip_smoke times
    them), at the F_SMALL groups: the planned call's kernels and cuBLAS's;
    every reachable K split; a ladder of K (F_LADDER, unsplit, the same M,
    N and layouts) for the kernel and cuBLAS, with the least-squares line
    through it (us at zero K steps, us a 64-deep step); and an empty kernel
    launched with the tensor-core kernel's block and shared memory at the
    plan's grid and at one block."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(3)
    elib = empty_lib()
    orig = conv_pe.plan_f
    groups = {g[0]: g for g in conv_pe.STEP_F_GROUPS}

    def fmt(per):
        return ", ".join(f"{k.split('(')[0][:40]} {v:.2f}"
                         for k, v in sorted(per.items()))

    for tag in F_SMALL:
        _, m, n, k, a_mn, b_nmaj, bias, act, bf16_out, _ = groups[tag]
        out = torch.bfloat16 if bf16_out else torch.float32
        f = conv_pe.ref.act_fn(act)

        def timed(kk, plan=None):
            a, b, bv = f_operands(torch, np, m, n, kk, a_mn, b_nmaj, bias,
                                  rng)

            def cublas():
                y = torch.matmul(a, b)
                if bv is not None:
                    y = y.to(torch.float32) + bv
                return f(y).to(out)
            if plan is not None:
                conv_pe.plan_f = lambda *args: plan
            try:
                ours = kernel_us(torch, smoke, lambda: conv_pe._gemm_f(
                    a, b, bv, act, out))
            finally:
                conv_pe.plan_f = orig
            return ours, kernel_us(torch, smoke, cublas)

        p = orig(m, n, k, True, a_mn, b_nmaj, True, act)
        ours, lib = timed(k)
        log(f"fixed {tag} M={m} N={n} K={k} planned splits {p.splits}: "
            f"{sum(ours.values()):.2f} us ({fmt(ours)}); cuBLAS "
            f"{sum(lib.values()):.2f} us ({fmt(lib)})")
        for q in f_candidates(conv_pe, m, n, k, a_mn, b_nmaj, act):
            ours, _ = timed(k, q)
            log(f"fixed {tag} splits {q.splits}: {sum(ours.values()):.2f} "
                f"us ({fmt(ours)})")
        xs, ys, ls = [], [], []
        for kk in F_LADDER:
            ours, lib = timed(kk, orig(m, n, kk, True, a_mn, b_nmaj, True,
                                       act)._replace(
                splits=1, kps=math.ceil(kk / conv_pe.TC_BK),
                pass_=act not in conv_pe.TC_TILE_ACTS))
            xs.append(math.ceil(kk / conv_pe.TC_BK))
            ys.append(sum(ours.values()))
            ls.append(sum(lib.values()))
            log(f"fixed {tag} ladder K={kk}: kernel {ys[-1]:.2f} us, "
                f"cuBLAS {ls[-1]:.2f} us")
        for name, v in (("kernel", ys), ("cuBLAS", ls)):
            slope, icpt = np.polyfit(xs, v, 1)
            log(f"fixed {tag} {name} line: {icpt:.2f} us + {slope:.3f} us "
                f"a 64-deep step")
        tiles = math.ceil(m / conv_pe.TC_BM) * math.ceil(n / conv_pe.TC_BN)
        a0 = torch.empty(1, device="cuda")
        stream = _build.stream_ptr(a0)
        for grid in (min(tiles * p.splits, conv_pe.SMS), 1):
            us = kernel_us(torch, smoke, lambda: _build.check(
                elib.empty_tc(grid, stream), "empty_tc"))
            log(f"fixed {tag} empty kernel, {grid} blocks of the tiles' "
                f"size: {sum(us.values()):.2f} us")


def float_plans(torch, np, smoke, conv_pe) -> bool:
    """Every candidate plan of each step shape group, against cuBLAS."""
    rng = np.random.default_rng(2)
    orig = conv_pe.plan_f
    good, tot = True, {"planned": 0.0, "best": 0.0, "cublas": 0.0}
    for tag, m, n, k, a_mn, b_nmaj, bias, act, bf16_out, calls in \
            conv_pe.STEP_F_GROUPS:
        a, b, bv = f_operands(torch, np, m, n, k, a_mn, b_nmaj, bias, rng)
        out = torch.bfloat16 if bf16_out else torch.float32
        want = conv_pe.matmul_f_fused_plain(a, b, bv, act, out)
        f = conv_pe.ref.act_fn(act)

        def cublas():
            y = torch.matmul(a, b)
            if bv is not None:
                y = y.to(torch.float32) + bv
            return f(y).to(out)
        lib = smoke.cuda_ms(torch, cublas, REPS, cold=True)
        lib_ratio = smoke.f_ratio(torch, cublas(), want)[2]
        planned = orig(m, n, k, True, a_mn, b_nmaj, True, act)
        cands = f_candidates(conv_pe, m, n, k, a_mn, b_nmaj, act)
        best = None
        for p in cands:
            conv_pe.plan_f = lambda *args, _p=p: _p
            try:
                got = conv_pe._gemm_f(a, b, bv, act, out)
                ratio = smoke.f_ratio(torch, got, want)[2]
                ms = smoke.cuda_ms(
                    torch, lambda: conv_pe._gemm_f(a, b, bv, act, out), REPS,
                    cold=True)
            finally:
                conv_pe.plan_f = orig
            ok = ratio <= 1.0
            good &= ok or p != planned
            flops = 2.0 * m * n * k
            log(f"float {tag} M={m} N={n} K={k} "
                f"{'aT' if a_mn else 'a'} x {'b' if b_nmaj else 'bT'}: "
                f"splits {p.splits}"
                f"{' (planned)' if p == planned else ''}: {ms[0]:.4f} ms "
                f"({ms[1]:.4f}) {flops / ms[0] / 1e9:.1f} TFLOP/s, error "
                f"{ratio:.3f} x bar{'' if ok else ' FAILS'}; cuBLAS "
                f"{lib[0]:.4f} ({lib[1]:.4f}) ms, error {lib_ratio:.3f} x "
                f"bar")
            if p == planned:
                tot["planned"] += calls * ms[0]
            if ok and (best is None or ms[0] < best[0]):
                best = (ms[0], p)
        tot["cublas"] += calls * lib[0]
        if best is None:
            log(f"float {tag}: no candidate within the bar")
            continue
        tot["best"] += calls * best[0]
        log(f"float {tag}: best splits {best[1].splits} {best[0]:.4f} ms; "
            f"planned splits {planned.splits}")
    log(f"float per step ({sum(g[-1] for g in conv_pe.STEP_F_GROUPS)} "
        f"calls, cold L2): "
        f"planned {tot['planned']:.3f} ms, best candidates "
        f"{tot['best']:.3f} ms, cuBLAS {tot['cublas']:.3f} ms")
    float_host(torch, np, conv_pe, rng)
    return good


def float_host(torch, np, conv_pe, rng) -> None:
    """The float wrapper's host us a call and its parts, at [64, 64] x
    [64, 64] (the device finishes first, so the loops run at the host's
    pace): the wrapper on the tensor-core and the FFMA route, the bare
    ctypes calls (the tensor-core one encodes two tensor maps), and the
    Python parts."""
    from repro_torch.kernels import _build
    a, b, bv = f_operands(torch, np, 64, 64, 64, False, True, True, rng)
    a32, b32 = a.float(), b.float()
    lib = _build.library("conv_pe_f", conv_pe._bind_f)
    out = torch.empty((64, 64), dtype=torch.bfloat16, device="cuda")
    stream = _build.stream_ptr(a)
    parts = {
        "wrapper, tensor cores": lambda: conv_pe._gemm_f(
            a, b, bv, "none", torch.bfloat16),
        "wrapper, FFMA (f32)": lambda: conv_pe._gemm_f(
            a32, b32, bv, "none", torch.float32),
        "ctypes conv_pe_f_tc": lambda: lib.conv_pe_f_tc(
            a.data_ptr(), b.data_ptr(), bv.data_ptr(), out.data_ptr(), None,
            64, 64, 64, 0, 1, 1, 1, 0, 1, stream),
        "ctypes conv_pe_f_gemm": lambda: lib.conv_pe_f_gemm(
            a.data_ptr(), b.data_ptr(), bv.data_ptr(), out.data_ptr(), 64,
            64, 64, 0, 1, 1, stream),
        "plan_of": lambda: conv_pe.plan_of(a, b),
        "torch.empty out": lambda: torch.empty(
            (64, 64), dtype=torch.bfloat16, device=a.device),
        "scratch": lambda: conv_pe._scratch(a, 64 * 64, stream),
        "stream_ptr": lambda: _build.stream_ptr(a),
        "bias check": lambda: _build.require(bv, "bias", torch.float32,
                                             (64,)),
    }
    log("float host us a call: " + ", ".join(
        f"{k} {host_us(torch, f, 2000):.2f}" for k, f in parts.items()))


# --w4: the int4 Conv PE at the w4a8 projections of the served LMs, (N, K)
# of qwen2-1.5b's and gemma2-2b's QKV, gate/up, O and down (group size 64),
# at a decode step (M = 4), between (16) and a prefill (256)
W4_SHAPES = (("qwen2 QKV", 2048, 1536), ("qwen2 gate/up", 17920, 1536),
             ("qwen2 O", 1536, 1536), ("qwen2 down", 1536, 8960),
             ("gemma2 QKV", 4096, 2304), ("gemma2 gate/up", 18432, 2304),
             ("gemma2 O", 2304, 2048), ("gemma2 down", 2304, 9216))
W4_M = (4, 16, 256)
W4_GS = 64


def w4_candidates(conv_pe, m, n, k, wa, wb):
    """The plans conv_pe.plan_w4 can name at (M, N, K): at M <= 16 every
    stream strip, at M > 4 the tensor-core tiles; at M = 256 the planner's
    stream strip too (the route's cost)."""
    out = []
    if m <= 16:
        out += [conv_pe.stream_plan_w4(m, n, k, W4_GS, wa, wb, bn)
                for bn in conv_pe.W4_BNS]
    else:
        out.append(conv_pe.stream_plan_w4(m, n, k, W4_GS, wa, wb))
    if m > 4:
        out.append(conv_pe.mma_plan_w4(m, n, k, W4_GS, wa, wb))
    return out


def w4_plans(torch, np, smoke, conv_pe) -> bool:
    """Every candidate plan of the int4 GEMM forced through plan_w4, held
    bit for bit against the plain version and timed cold, beside the int8
    Conv PE at the same (M, N, K) (its own plan, cold) and the bound."""
    from repro_torch.core.quant import pack_int4
    rng = np.random.default_rng(4)
    good = True
    for m in W4_M:
        for tag, n, k in W4_SHAPES:
            a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(
                np.int8)).cuda()
            q4 = pack_int4(torch.from_numpy(rng.normal(size=(k, n)).astype(
                np.float32)).cuda(), W4_GS)
            args = (a, q4.packed, 0.0173, q4.scale, q4.zero, None, "relu",
                    0.0621)
            want = conv_pe.matmul_int4_fused_plain(*args)
            b8, wsc = operands(torch, np, m, n, k, rng)[1:]
            lib = smoke.cuda_ms(torch, lambda: conv_pe.matmul_int8_fused(
                a, b8, 0.0173, wsc, None, "relu", 0.0621), REPS, cold=True)
            g = k // W4_GS
            bound = max((m * k + k * n // 2 + 4 * g * n + m * n) / 3.35e12,
                        2.0 * m * n * k / 1979e12) * 1e3
            planned = conv_pe.plan_w4(m, n, k, W4_GS, conv_pe.byte_align(a),
                                      conv_pe.byte_align(q4.packed))
            orig = conv_pe.plan_w4
            for p in w4_candidates(conv_pe, m, n, k, planned.wa, planned.wb):
                conv_pe.plan_w4 = lambda *_a, _p=p: _p
                try:
                    ok = bool(torch.equal(conv_pe.matmul_int4_fused(*args),
                                          want))
                    ms = smoke.cuda_ms(
                        torch, lambda: conv_pe.matmul_int4_fused(*args),
                        REPS, cold=True)
                finally:
                    conv_pe.plan_w4 = orig
                good &= ok
                log(f"w4 {tag} M={m} N={n} K={k}: {p.route} {p.bm}x{p.bn} "
                    f"gc {p.gc}"
                    f"{' (planned)' if p == planned else ''}: {ms[0]:.4f} ms "
                    f"({ms[1]:.4f}) {'bitwise' if ok else 'DIFFERS'}; int8 "
                    f"conv_pe {lib[0]:.4f} ({lib[1]:.4f}) ms; bound "
                    f"{bound:.4f} ms")
    return good


# --w4 --parts: variants of csrc/conv_pe_w4.cu, each with one part cut out
# by a textual edit (results no longer bitwise; timing only).  An edit whose
# text is not in the source once fails the probe: keep these in step.
W4_PARTS = (
    ("nothing", ()),
    ("stream: the weight copies",
     (("        cp_async<16>(dst, col < N ? src : P, col < N);",
       "        if (c < 0) cp_async<16>(dst, col < N ? src : P, col < N);"),)),
    ("stream: the products (__dp4a)",
     (("                  __dp4a(av[m], static_cast<int>(cw[i]), "
       "acc[m][4 * j + i]);",
       "                  av[m] ^ static_cast<int>(cw[i]) ^ "
       "acc[m][4 * j + i];"),)),
    ("stream: the sub-tasks' atomics",
     (("        for (int j = 0; j < CW; ++j) atomicAdd(dst + m * BN + j, "
       "acc[m][j]);",
       "        for (int j = 0; j < CW; ++j) dst[m * BN + j] = acc[m][j];"),)),
    ("stream: the fold",
     (("    if (folds && c > 0) fold(c - 1);",
       "    if (folds && c < 0) fold(c - 1);"),
      ("  fold(chunks - 1);\n", ""))),
    ("tiles: the products (mma)",
     (("          mma_s8_from(acc[j], af,",
       "          if (kt < 0) mma_s8_from(acc[j], af,"),
      ("          mma_s8(acc[j], af,",
       "          if (kt < 0) mma_s8(acc[j], af,"))),
    ("tiles: the unpack",
     (("      unpack_stage(reinterpret_cast<const int8_t*>(",
       "      if (kt < 0) unpack_stage(reinterpret_cast<const int8_t*>("),)),
    ("tiles: the fold",
     (("      if (kin < gs) continue;",
       "      if (kin < gs || kt >= 0) {\n        kin = kin < gs ? kin : 0;\n"
       "        continue;\n      }"),)),
)
# (tag, M, N, K): the planned plan of each is timed under every variant
W4_PARTS_AT = (("qwen2 gate/up", 4, 17920, 1536),
               ("qwen2 down", 4, 1536, 8960),
               ("qwen2 gate/up", 256, 17920, 1536),
               ("qwen2 down", 256, 1536, 8960))


def w4_parts(torch, np, smoke, conv_pe) -> None:
    """Each W4_PARTS variant of the int4 GEMM built, bound in place of the
    library and timed cold on the planned plan at W4_PARTS_AT."""
    import kernel_variants
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels import _build
    libs = kernel_variants.edited(_build, "conv_pe_w4.cu", W4_PARTS,
                                  "w4_probe", conv_pe._bind_w4)
    rng = np.random.default_rng(5)
    cases = []
    for tag, m, n, k in W4_PARTS_AT:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(
            np.int8)).cuda()
        q4 = pack_int4(torch.from_numpy(rng.normal(size=(k, n)).astype(
            np.float32)).cuda(), W4_GS)
        cases.append((f"{tag} M={m}", (a, q4.packed, 0.0173, q4.scale,
                                       q4.zero, None, "relu", 0.0621)))
    for what, lib in libs:
        with kernel_variants.bound(_build, "conv_pe_w4", lib):
            times = [smoke.cuda_ms(
                torch, lambda: conv_pe.matmul_int4_fused(*args), REPS,
                cold=True)[0] for _, args in cases]
        log(f"w4 parts, cut {what}: " + ", ".join(
            f"{tag} {t:.4f} ms" for (tag, _), t in zip(cases, times)))


# textual edits of epilogue.cuh's gelu_tanh: (what, old, new)
GELU_VARIANTS = (
    ("no FMA: x + kKappa * x^3 as a rounded multiply and add",
     "__fmaf_rn(kKappa, cube, x)", "__fadd_rn(x, __fmul_rn(kKappa, cube))"),
    ("a second FMA: 0.5x + 0.5x * tanh",
     "return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));",
     "const float hx = __fmul_rn(0.5f, x);\n  "
     "return __fmaf_rn(hx, tanhf(inner), hx);"),
)
# recurrentgemma-2b's gelu projections (M, N, K): in_gate, wg at a decode
# step and a prefill
GELU_AT = ((4, 2560, 2560), (4, 7680, 2560), (256, 2560, 2560),
           (256, 7680, 2560))


def gelu_variant_edits(_build):
    """[(what, edits of conv_pe.cu)]: act4's gelu calls gelu_probe, a copy
    of epilogue.cuh's gelu_tanh with one step changed, defined ahead of
    act4."""
    hdr = (_build.CSRC / "epilogue.cuh").read_text()
    start = hdr.index("__device__ __forceinline__ float gelu_tanh(")
    body = hdr[start:hdr.index("\n}\n", start) + 3]
    out = []
    for what, old, new in GELU_VARIANTS:
        if body.count(old) != 1:
            raise SystemExit(f"{old!r} is not in gelu_tanh once")
        fn = body.replace(old, new).replace("gelu_tanh(", "gelu_probe(")
        out.append((what, [
            ("x[q] = gelu_tanh(x[q]);", "x[q] = gelu_probe(x[q]);"),
            ("template <bool GELU>\n__device__ __forceinline__ void act4(",
             fn + "\ntemplate <bool GELU>\n"
             "__device__ __forceinline__ void act4(")]))
    return out


def gelu(torch, np, smoke, conv_pe, parent) -> bool:
    import kernel_variants
    from repro_torch.kernels import _build
    rows = smoke.gelu_sweep(torch, conv_pe)
    smoke.log_gelu_sweep("this tree", rows)
    good = all(bad == 0 for _, _, bad, _ in rows)
    libs = kernel_variants.edited(_build, "conv_pe.cu",
                                  gelu_variant_edits(_build), "gelu_probe",
                                  conv_pe._bind)
    n = smoke.GELU_SWEEP + len(smoke.GELU_SPECIAL)
    stream = smoke.gelu_routes(conv_pe, n)[:1]
    for what, lib in libs:
        with kernel_variants.bound(_build, "conv_pe", lib):
            smoke.log_gelu_sweep(f"variant [{what}]",
                                 smoke.gelu_sweep(torch, conv_pe, stream))
    rng = np.random.default_rng(6)
    for m, n, k in GELU_AT:
        a, b, wsc = operands(torch, np, m, n, k, rng)
        asc = torch.from_numpy(rng.uniform(0.005, 0.05, (m, 1)).astype(
            np.float32)).cuda()
        p = conv_pe.plan(m, n, k, conv_pe.byte_align(a),
                         conv_pe.byte_align(b))
        times = {}
        for act in ("none", "gelu", "gelu", "none"):
            ms = smoke.cuda_ms(torch, lambda: conv_pe.matmul_int8_fused(
                a, b, asc, wsc, None, act), REPS, cold=True)[0]
            times.setdefault(act, []).append(ms)
        log(f"gelu cost M={m} N={n} K={k} ({p.path} {p.bm}x{p.bn}, "
            f"{p.splits} split(s), {'fused' if p.fused else 'pass'}): none "
            f"{times['none']} ms, gelu {times['gelu']} ms (cold)")
    if parent:
        parent_vs_this(torch, np, smoke, conv_pe, parent)
    return good


def parent_vs_this(torch, np, smoke, conv_pe, parent) -> None:
    """The int8 Conv PE of `parent` (its csrc/conv_pe.cu, built beside this
    tree's) against this tree's, at the planned plans of the LM and CNN
    shapes, in turns parent, this, this, parent."""
    import kernel_variants
    from repro_torch.kernels import _build
    cu = os.path.join(os.path.abspath(parent), "src", "repro_torch", "csrc",
                      "conv_pe.cu")
    lib = kernel_variants.finish(*kernel_variants.start(
        _build, "conv_pe_parent", cu), "the parent's conv_pe.cu")
    conv_pe._bind(lib)
    rng = np.random.default_rng(8)
    shapes = ([(4, n, k, "LM decode") for n, k in DECODE]
              + [(m, n, k, "LM prefill") for m, n, k in PREFILL]
              + [(m, n, k, "CNN") for m, n, k in CNN])
    for m, n, k, what in shapes:
        a, b, wsc = operands(torch, np, m, n, k, rng)
        cnn = what == "CNN"
        asc = (0.0173 if cnn else torch.from_numpy(rng.uniform(
            0.005, 0.05, (m, 1)).astype(np.float32)).cuda())
        args = ((a, b, asc, wsc, None, "relu6", 0.0621) if cnn
                else (a, b, asc, wsc, None, "none"))
        want = conv_pe.matmul_int8_fused_plain(*args)
        times = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            ctx = (kernel_variants.bound(_build, "conv_pe", lib)
                   if who == "parent" else contextlib.nullcontext())
            with ctx:
                if not torch.equal(conv_pe.matmul_int8_fused(*args), want):
                    log(f"parent vs this {what} M={m} N={n} K={k}: {who} "
                        "DIFFERS from the plain version")
                times[who].append(smoke.cuda_ms(
                    torch, lambda: conv_pe.matmul_int8_fused(*args), REPS,
                    cold=not cnn)[0])
        log(f"parent vs this {what} M={m} N={n} K={k} "
            f"({'relu6 int8 out, warm' if cnn else 'none f32 out, cold'}): "
            f"parent {times['parent']} ms, this {times['this']} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve", action="store_true",
                    help="compare served images/s across variants")
    ap.add_argument("--src", help="import repro_torch from this directory")
    ap.add_argument("--float", action="store_true", dest="float_",
                    help="the float GEMM's candidate plans against cuBLAS")
    ap.add_argument("--host", action="store_true",
                    help="with --float: only the wrapper's host cost")
    ap.add_argument("--w4", action="store_true",
                    help="the int4 GEMM's candidate plans at the LM shapes")
    ap.add_argument("--parts", action="store_true",
                    help="with --w4: only the int4 GEMM's parts, each cut "
                    "out in turn")
    ap.add_argument("--gelu", action="store_true",
                    help="the tanh-gelu epilogue: sweeps, variants, cost")
    ap.add_argument("--parent", help="with --gelu: time this tree's int8 "
                    "GEMM against the one of this unpacked tree")
    ap.add_argument("--fixed", action="store_true",
                    help="with --float: only the short products' fixed "
                    "costs")
    args = ap.parse_args()
    # repro_torch is imported before chip_smoke, which puts this tree's
    # src/ first on the path: a --src tree's package is the one that stays
    sys.path.insert(0, os.path.abspath(args.src or os.path.join(ROOT,
                                                                "src")))
    import numpy as np
    import torch
    from repro_torch.kernels import _build, conv_pe
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("conv_pe_probe: needs a CUDA device", file=sys.stderr)
        return 1
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    log(f"repro_torch from {os.path.dirname(conv_pe.__file__)}")
    _build.build_all()
    if args.gelu:
        good = gelu(torch, np, smoke, conv_pe, args.parent)
    elif args.serve:
        good = serve(torch, np, smoke, conv_pe)
    elif args.w4:
        good = True
        if args.parts:
            w4_parts(torch, np, smoke, conv_pe)
        else:
            good = w4_plans(torch, np, smoke, conv_pe)
    elif args.float_:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
        good = True
        if args.host:
            float_host(torch, np, conv_pe, np.random.default_rng(2))
        elif args.fixed:
            float_fixed(torch, np, smoke, conv_pe)
        else:
            good = float_plans(torch, np, smoke, conv_pe)
            float_fixed(torch, np, smoke, conv_pe)
    else:
        good = plans(torch, np, smoke, conv_pe)
        host(torch, np, conv_pe)
    log("all within their bars" if good else "SOME RESULT DIFFERS")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
