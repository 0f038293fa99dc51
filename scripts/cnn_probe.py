#!/usr/bin/env python3
"""The DWC PE's routes and runs and the pooled head's strips, on the card.

    PYTHONPATH=src python scripts/cnn_probe.py [--parent DIR] [--parts]
    PYTHONPATH=src python scripts/cnn_probe.py --misc [--parent DIR] [--parts]

dwc2d: at MobileNetV2's 17 DWC layers (224 px, a wave of 4 images; each
call its own seeded unpadded map, weights and scales, its SAME pads read in
place), every route and run the kernel takes (`dwc_pe.plan_dwc2d`
replaced for the call: 4 channels a thread at each run of `DWC2D_RUNS[3]`,
and the scalar route) is held bit for bit against the plain
version (F.pad, then ref.dwc2d) and timed with chip_smoke's `cuda_ms`
(warm, as chip_smoke times the CNN kernels: device ms from torch.profiler,
CUDA-event ms in brackets), all 17 calls and each layer alone; "*" marks
the planner's pick for a layer.  cuDNN's grouped convolution on
float copies (padded outside the timing) plus the epilogue in torch ops,
chip_smoke's yardstick, is timed beside.

matmul_int8_pool: at MobileNetV2's head ([4, 49, 320] x [320, 1280]) and
ResNet50's residual head ([4, 49, 512] x [512, 2048], the shortcut [4,
49, 2048]), each strip width of POOL_BNS (csrc/conv_pe.cu's PBN; the
others built by a textual edit and bound in place of the library), bit
for bit against the plain version, timed the same way beside torch._int_mm
plus the same epilogue in torch ops.

--parent DIR: an unpacked older tree (`git archive <rev> | tar -x -C
DIR`).  Its csrc/dwc_pe.cu and csrc/conv_pe.cu are built into
build/cnn_probe_parent_*.so and timed on the same inputs.  `conv_pe_pool`
has kept its C interface.  A tree from before the in-place halo had
`dwc_pe_dwc2d(x, w, bias, w_scale, a_scale, out, n, hp, wp, c, k, stride,
ho, wo, act, out_int8, os, stream)` on a pre-padded map: its dwc2d is
timed with the F.pad its caller made inside the timed function; a later
one (its dwc_pe_dwc2d takes the pads `pt, pl`) is bound in place of the
library and timed through this tree's wrapper and plans.

--parts: where the time goes at the planned plans: variants of
csrc/dwc_pe.cu and csrc/conv_pe.cu with one part cut out by a textual edit
(the edited text must be in the source once, or the probe fails), built
into build/cnn_probe_<n>.so, bound in place of the library and timed.  The
dwc2d variants run on the pre-padded maps (pad None), so the one that cuts
the halo predication reads only inside the map.  A cut kernel's output is
wrong; only its time is read.

--misc: the MISC core instead.  misc_add at ResNet50's 16 unfused residual
adds (224 px, a wave of 4: int8 + int8 -> int8, relu) twice -- seeded
random codes, and the adds one run of the real unfused program makes, as
chip_smoke.py records them, whose share of values near a tie of the
requant is logged -- and at gemma2-2b's 52 post-norm adds of a decode
step ([4, 2304]) and of a 64-token prefill of 4 slots ([256, 2304]), f32
stream + int8 edge -> f32, each call its own seeded operands: the planned
plan, the vector route at each grid cap of ADD_CAPS blocks an SM
(`misc_pe.add_launch`, `plan_add` replaced for the call) and the scalar
route, each held bit for bit against the plain version and timed as
above; with --parts, variants of csrc/misc_pe.cu with one part of the
vector add cut out (ADD_PARTS) timed on the same calls.  avgpool2d at
chip_smoke's AVGPOOL shapes (f32 maps) and at a k 2 / 2 pool of the [4,
56, 56, 256] map, which reads each input once (the most that staging the
k 3 / 2 rows in shared memory could save is the difference): the planned
plan and every channels-a-thread and block size (`misc_pe.pool_launch`),
bit for bit, beside F.avg_pool2d.  With --parent, that tree's
csrc/misc_pe.cu is built and timed on the same calls (an older C
interface without the plan arguments is called directly).

Needs one GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REPS = 20
# (label, G, rows, K, N, residual)
HEADS = (("MobileNetV2 head", 4, 49, 320, 1280, False),
         ("ResNet50 head", 4, 49, 512, 2048, True))
POOL_BNS = (32, 64)       # strip widths timed (csrc/conv_pe.cu PBN)
PLANNED_BN = 64
# --parts: (what is cut, [(text of the source, its replacement)])
DWC_PARTS = (
    ("nothing (as built)", []),
    ("the halo predication (rows and columns read unchecked)",
     [("    if (ih < 0 || ih >= p.h) continue;          // a halo row: all "
       "zero\n", ""),
      ("      xv[j] = col >= 0 && col < p.wd\n"
       "                  ? __ldg(", "      xv[j] = true ? __ldg(")]),
    ("the map's loads (the window made from the thread index)",
     [("      xv[j] = col >= 0 && col < p.wd\n"
       "                  ? __ldg(reinterpret_cast<const unsigned*>(row + "
       "col * p.c))\n                  : 0u;",
       "      xv[j] = idx * 0x01010101u + col;")]),
    ("the taps' dp4a (an xor-add a tap)",
     [("            acc[u][e] = __dp4a(static_cast<int>(xv[j]),\n"
       "                               static_cast<int>(wv[kw] & (0xffu << 8 "
       "* e)),\n                               acc[u][e]);",
       "            acc[u][e] += static_cast<int>(xv[j] ^ wv[kw]);")]),
    ("the requant (a multiply by the reciprocal alone, no check)",
     [("        const int code = code_int(qdq_code_rcp(\n"
       "            dwc_value(acc[u][e], p.a_scale, ws[e], has_bias, bv[e], "
       "p.act),\n            p.os, rcp));",
       "        const int code = __float2int_rn(__fmul_rn(\n"
       "            dwc_value(acc[u][e], p.a_scale, ws[e], has_bias, bv[e], "
       "p.act),\n            rcp));")]),
    ("the epilogue (the int32 sum's low byte stored)",
     [("        const int code = code_int(qdq_code_rcp(\n"
       "            dwc_value(acc[u][e], p.a_scale, ws[e], has_bias, bv[e], "
       "p.act),\n            p.os, rcp));",
       "        const int code = acc[u][e];")]),
    ("all of it (an empty kernel)",
     [("  constexpr int COLS = (R - 1) * S + K;\n",
       "  constexpr int COLS = (R - 1) * S + K;\n  if (p.c > 0) return;\n")]),
    ("nothing, 256 threads a block",
     [("constexpr int DW_THREADS = 128;", "constexpr int DW_THREADS = 256;")]),
    ("nothing, 64 threads a block",
     [("constexpr int DW_THREADS = 128;", "constexpr int DW_THREADS = 64;")]),
)
POOL_PARTS = (
    ("nothing (as built)", []),
    ("the staging (no copies; shared memory left as it is)",
     [("      for (int u = tid; u < prn * (kcn / 16); u += THREADS) {",
       "      for (int u = tid; u < 0; u += THREADS) {"),
      ("      for (int u = tid; stage_b && u < kcn * (BN / 16); "
       "u += THREADS) {",
       "      for (int u = tid; u < 0; u += THREADS) {"),
      ("HAS_RES && k0 == 0 && u < real * (BN / 16);", "u < 0;")]),
    ("the B transpose",
     [("      for (int t = tid; stage_b && t < (kcn / 16) * (BN / 4); "
       "t += THREADS) {",
       "      for (int t = tid; t < 0; t += THREADS) {")]),
    ("the tensor-core products",
     [("              mma_s8(acc[j], af, bf[j][2 * s], bf[j][2 * s + 1]);",
       "              acc[j][0] += af[0] ^ bf[j][2 * s];")]),
    ("the epilogue chain (the int32 sums pooled as they are)",
     [("              colsum[j][e] += code_int(\n"
       "                  HAS_RES ? qdq_code_rcp(x, add_scale, rcp_add)\n"
       "                          : qdq_code_rcp(x, mid_scale, rcp_mid));",
       "              colsum[j][e] += acc[j][2 * h + e];")]),
    ("all of it (an empty kernel)",
     [("  constexpr int BN = PBN, THREADS = 4 * BN, NI = 4;",
       "  if (rows > 0) return;\n"
       "  constexpr int BN = PBN, THREADS = 4 * BN, NI = 4;")]),
)


# --misc: the vector add's grid caps timed (blocks an SM; 0: none), and
# with --parts the add's parts cut out (as DWC_PARTS)
ADD_CAPS = (0, 1, 2, 4, 8)
ADD_PARTS = (
    ("nothing (as built)", []),
    ("the arithmetic (a's and b's words xor-ed into out's)",
     [("  return apply_act(\n"
       "      __fadd_rn(__fmul_rn(elem(pa, e), sa), __fmul_rn(elem(pb, e), "
       "sb)),\n      ACT);",
       "  return __uint_as_float(pa.u32(e * sizeof(TA) / 4) ^\n"
       "                         pb.u32(e * sizeof(TB) / 4));"),
      ("          requant_biased(add_value<ACT>(pa, pb, e, sa, sb), rcp, "
       "near));",
       "          add_value<ACT>(pa, pb, e, sa, sb));\n      near = false;")]),
    ("the near-tie redo (the clamped, rounded product alone)",
     [("      ties |= near ? 1u << e : 0u;\n", "")]),
    ("everything (the kernel returns at once)",
     [("  const size_t groups = n / V;\n",
       "  if (n) return;\n  const size_t groups = n / V;\n")]),
)


def log(*a):
    print(*a, flush=True)


def dwc_calls(torch):
    """[(args, kwargs)] of dwc_pe.dwc2d at MobileNetV2's 17 DWC layers, a
    wave of 4 images, each layer its own seeded operands."""
    import numpy as np
    from repro_torch.compiler.graph import dwc_input_shapes
    from repro_torch.configs.cnn_zoo import MOBILENET_V2
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    calls = []
    for h, w, c, k, s in dwc_input_shapes(MOBILENET_V2):
        def dev(a):
            return torch.from_numpy(a).cuda()
        x = dev(rng.integers(-127, 128, (4, h, w, c)).astype(np.int8))
        wt = dev(rng.integers(-127, 128, (k, k, c)).astype(np.int8))
        wsc = dev(rng.uniform(0.002, 0.02, c).astype(np.float32))
        bias = dev(rng.normal(size=c).astype(np.float32))
        pad = ops._same_pad(h, k, s) + ops._same_pad(w, k, s)
        calls.append(((x, wt, bias, s, "relu6"),
                      dict(a_scale=0.031, w_scale=wsc, out_scale=0.057,
                           pad=pad)))
    return calls


def out_hw(args, kwargs):
    x, w, s = args[0], args[1], args[3]
    t, b, l, r = kwargs["pad"] or (0, 0, 0, 0)
    k = w.shape[0]
    return ((x.shape[1] + t + b - k) // s + 1,
            (x.shape[2] + l + r - k) // s + 1)


def forced(dwc_pe, route, run):
    """A plan_dwc2d that plans `route` at `run` outputs a thread."""
    def fn(n, h, w, c, k, stride, aligned):
        return dwc_pe.dwc2d_launch(route, run, w, c)
    return fn


def dwc(torch, smoke, _build, parent):
    import torch.nn.functional as F
    from repro_torch.kernels import dwc_pe
    calls = dwc_calls(torch)
    wants = [dwc_pe.dwc2d_plain(*a, **kw) for a, kw in calls]
    bounds = []
    for (a, kw), want in zip(calls, wants):
        t_bytes = smoke.call_bytes(torch, "dwc", a, kw, [want]) / \
            smoke.PEAK_BYTES
        ops, peak = smoke.call_ops("dwc", a, kw, want)
        bounds.append(max(t_bytes, ops / peak) * 1e3)
    log(f"dwc2d MobileNetV2: {len(calls)} calls, bound {sum(bounds):.4f} ms "
        f"(bytes, on the unpadded maps)")
    planned = []
    for a, kw in calls:
        n, h, w, c = a[0].shape
        ho, wo = out_hw(a, kw)
        p = dwc_pe.plan_dwc2d(n, ho, wo, c, a[1].shape[0], a[3], 16)
        planned.append(p)
        log(f"plan dwc2d [{n}, {h}, {w}, {c}] k {a[1].shape[0]} stride "
            f"{a[3]} pad {kw['pad']} -> [{ho}, {wo}]: {p.route}, "
            f"{p.run} outputs a thread, {p.blocks} x {ho} x {n} blocks")
    # MobileNetV2's layers are all k 3: every run the kernel builds there
    cands = [("vec4", run) for run in dwc_pe.DWC2D_RUNS[3]] + [("scalar", 1)]
    orig = dwc_pe.plan_dwc2d
    for route, run in cands:
        dwc_pe.plan_dwc2d = forced(dwc_pe, route, run)
        try:
            gots = [dwc_pe.dwc2d(*a, **kw) for a, kw in calls]
            same = sum(torch.equal(g, w) for g, w in zip(gots, wants))
            total, wall = smoke.cuda_ms(torch, lambda: [
                dwc_pe.dwc2d(*a, **kw) for a, kw in calls], REPS)
            each = [smoke.cuda_ms(torch, lambda a=a, kw=kw:
                                  dwc_pe.dwc2d(*a, **kw), REPS)[0] * 1e3
                    for a, kw in calls]
        finally:
            dwc_pe.plan_dwc2d = orig
        log(f"dwc2d {route} run {run}: {total:.4f} ms ({wall:.4f}), "
            f"{same} of {len(calls)} bitwise; us a layer (* planned): "
            + " ".join(f"{t:.2f}" + ("*" if (p.route, p.run) == (route, run)
                                     else "")
                       for t, p in zip(each, planned)))
    total, wall = smoke.cuda_ms(torch, lambda: [
        dwc_pe.dwc2d(*a, **kw) for a, kw in calls], REPS)
    log(f"dwc2d as planned: {total:.4f} ms ({wall:.4f})")
    lib = [smoke.library_fn(torch, "dwc", dwc_pe.dwc2d, a, kw)
           for a, kw in calls]
    ms, wall = smoke.cuda_ms(torch, lambda: [f() for f in lib], REPS)
    log(f"dwc2d library (cuDNN grouped conv + torch epilogue): {ms:.4f} ms "
        f"({wall:.4f})")
    if parent is not None and hasattr(parent, "in_place"):
        import kernel_variants
        with kernel_variants.bound(_build, "dwc_pe", parent):
            same = sum(torch.equal(dwc_pe.dwc2d(*a, **kw), w)
                       for (a, kw), w in zip(calls, wants))
            ms, wall = smoke.cuda_ms(torch, lambda: [
                dwc_pe.dwc2d(*a, **kw) for a, kw in calls], REPS)
        log(f"dwc2d parent kernel (in place): {ms:.4f} ms ({wall:.4f}), "
            f"{same} of {len(calls)} bitwise")
    elif parent is not None:
        from repro_torch.kernels import _build as b_

        def old():
            outs = []
            for (x, w, bias, s, act), kw in calls:
                t, bo, l, r = kw["pad"]
                xp = F.pad(x, (0, 0, l, r, t, bo))
                n, hp, wp, c = xp.shape
                k = w.shape[0]
                ho, wo = (hp - k) // s + 1, (wp - k) // s + 1
                out = torch.empty((n, ho, wo, c), dtype=torch.int8,
                                  device="cuda")
                b_.check(parent.dwc_pe_dwc2d(
                    xp.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    kw["w_scale"].data_ptr(), kw["a_scale"], out.data_ptr(),
                    n, hp, wp, c, k, s, ho, wo, b_.act_code(act), 1,
                    kw["out_scale"], b_.stream_ptr(x)), "parent dwc2d")
                outs.append(out)
            return outs
        same = sum(torch.equal(g, w) for g, w in zip(old(), wants))
        ms, wall = smoke.cuda_ms(torch, old, REPS)
        log(f"dwc2d parent kernel after its F.pad: {ms:.4f} ms ({wall:.4f}), "
            f"{same} of {len(calls)} bitwise")
    return calls


def head_calls(torch):
    """(label, args, kwargs) of matmul_int8_pool at the two served heads."""
    import numpy as np
    rng = np.random.default_rng(1)
    out = []
    for label, g, rows, k, n, res in HEADS:
        def dev(a):
            return torch.from_numpy(a).cuda()
        a = dev(rng.integers(-127, 128, (g, rows, k)).astype(np.int8))
        b = dev(rng.integers(-127, 128, (k, n)).astype(np.int8))
        wsc = dev(rng.uniform(0.0005, 0.005, (1, n)).astype(np.float32))
        bias = dev(rng.normal(size=n).astype(np.float32))
        kw = dict(mid_scale=0.0713, out_scale=0.0377)
        if res:
            kw.update(residual=dev(rng.integers(-127, 128, (g, rows, n))
                                   .astype(np.int8)), res_scale=0.049,
                      add_act="relu", add_scale=0.0811)
        out.append((label, (a, b, 0.0191, wsc, bias,
                            "none" if res else "relu"), kw))
    return out


def pool(torch, smoke, _build, parent):
    import kernel_variants
    from repro_torch.kernels import conv_pe
    strips = [(f"strip {bn}", kernel_variants.edited(
        _build, "conv_pe.cu", [(bn, [(f"constexpr int PBN = {PLANNED_BN};",
                                      f"constexpr int PBN = {bn};")])],
        f"cnn_probe_strip{bn}", conv_pe._bind)[0][1])
        for bn in POOL_BNS if bn != PLANNED_BN]
    for label, a, kw in head_calls(torch):
        name = "conv_pe_pool_res" if "residual" in kw else "conv_pe_pool"
        want = conv_pe.matmul_int8_pool_plain(*a, **kw)
        t_bytes = smoke.call_bytes(torch, name, a, kw, [want]) / \
            smoke.PEAK_BYTES
        ops, peak = smoke.call_ops(name, a, kw, want)
        log(f"pool {label}: bound {max(t_bytes, ops / peak) * 1e3:.4f} ms "
            f"({'bytes' if t_bytes >= ops / peak else 'operations'})")
        for what, lib in [(f"strip {PLANNED_BN} (planned)", None)] + strips:
            with (kernel_variants.bound(_build, "conv_pe", lib)
                  if lib is not None else contextlib.nullcontext()):
                same = torch.equal(conv_pe.matmul_int8_pool(*a, **kw), want)
                ms, wall = smoke.cuda_ms(
                    torch, lambda: conv_pe.matmul_int8_pool(*a, **kw), REPS)
            log(f"pool {label}: {what}: {ms:.4f} ms ({wall:.4f}) "
                f"{'bitwise' if same else 'DIFFERS'}")
        lib = smoke.library_fn(torch, name, conv_pe.matmul_int8_pool, a, kw)
        ms, wall = smoke.cuda_ms(torch, lib, REPS)
        log(f"pool {label}: library (torch._int_mm + torch epilogue) "
            f"{ms:.4f} ms ({wall:.4f})")
        if parent is not None:
            from repro_torch.kernels import _build as b_
            x, w, a_scale, wsc, bias, act = a
            g, rows, k = x.shape
            n = w.shape[1]
            res = kw.get("residual")
            pre = kw.get("add_scale", kw["mid_scale"])

            def old():
                out = torch.empty((g, n), dtype=torch.int8, device="cuda")
                b_.check(parent.conv_pe_pool(
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), g, rows, n, k,
                    a_scale, wsc.data_ptr(), bias.data_ptr(),
                    b_.act_code(act), kw["mid_scale"],
                    None if res is None else res.data_ptr(),
                    kw.get("res_scale", 1.0),
                    b_.act_code(kw.get("add_act", "none")), pre,
                    conv_pe.gap_scale(pre, rows), 1, kw["out_scale"],
                    b_.stream_ptr(x)), "parent conv_pe_pool")
                return out
            same = torch.equal(old(), want)
            ms, wall = smoke.cuda_ms(torch, old, REPS)
            log(f"pool {label}: parent kernel {ms:.4f} ms ({wall:.4f}) "
                f"{'bitwise' if same else 'DIFFERS'}")


def add_sets(torch):
    """[(label, [(args, kwargs)])]: ResNet50's unfused adds, gemma2's adds
    at a decode step and at a prefill."""
    import numpy as np
    rng = np.random.default_rng(3)

    def dev(a):
        return torch.from_numpy(a).cuda()

    def q(shape):
        return dev(rng.integers(-127, 128, shape).astype(np.int8))
    resnet = []
    for hw, c, count in ((56, 256, 3), (28, 512, 4), (14, 1024, 6),
                         (7, 2048, 3)):
        for _ in range(count):
            shape = (4, hw, hw, c)
            resnet.append(((q(shape), q(shape), 0.0311, 0.0529, "relu"),
                           dict(out_scale=0.0437)))
    out = [("ResNet50 unfused run", resnet),
           ("ResNet50 unfused program", program_adds(torch))]
    for label, rows in (("gemma2 decode step", 4), ("gemma2 prefill", 256)):
        calls = []
        for _ in range(52):
            x = dev(rng.normal(size=(rows, 2304)).astype(np.float32))
            calls.append(((x, q((rows, 2304)), 1.0, 0.0173, "none"),
                          dict(out_scale=None)))
        out.append((label, calls))
    return out


def program_adds(torch):
    """The 16 misc_add calls of one ResNet50 unfused program run, recorded
    as chip_smoke.py records them: 224 px, seeded weights, calibrated on
    one seeded batch of 4, a wave of 4 seeded images."""
    import numpy as np
    import chip_smoke as smoke
    from repro_torch import compiler
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.core import engine as eng_lib
    from repro_torch.models.cnn import cnn_schema
    from repro_torch.models.params import init_params
    cfg = CNN_ZOO["resnet50"]
    params = init_params(cnn_schema(cfg), torch.Generator().manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(1)
    hw = cfg.input_hw
    calib = (rng.normal(size=(4, hw, hw, 3)) * 0.5).astype(np.float32)
    images = (rng.normal(size=(8, hw, hw, 3)) * 0.5).astype(np.float32)
    eng = eng_lib.paper_engine(backend="cuda")
    program = compiler.compile_calibrated(
        cfg, params, [torch.from_numpy(calib).cuda()], fuse=False)
    qparams = compiler.fold_weight_layouts(
        program.graph, eng_lib.quantize_params(params, eng))
    wave = torch.from_numpy(images[:4]).cuda()
    return smoke.capture_calls(torch, lambda: compiler.execute(
        program, qparams, wave, eng))["misc_add"]


def near_ties(torch, a, b, sa, sb, act, out_scale=None, **_):
    """The share of a requantized add's values within 2^-14 of a
    half-integer of the scale after the multiply by its reciprocal, and of
    16-value groups holding one (the groups the kernel redoes with the
    division), in the kernel's f32 arithmetic."""
    f = torch.float32
    x = a.to(f) * torch.tensor(sa, dtype=f).cuda() + \
        b.to(f) * torch.tensor(sb, dtype=f).cuda()
    if act == "relu":
        x = torch.clamp_min(x, 0)
    os_ = torch.tensor(out_scale, dtype=f).cuda()
    p = x * (torch.ones((), dtype=f).cuda() / os_)
    c = torch.tensor(12582912.0, dtype=f).cuda()
    r = (p.clamp(-127, 127) + c) - c
    d = (p - r).abs()
    near = ~((d < 0.5 - 2 ** -14) | (d > 0.5 + 2 ** -14))
    groups = near.reshape(-1)[:near.numel() // 16 * 16].reshape(-1, 16)
    return float(near.float().mean()), float(groups.any(1).float().mean())


def bound_ms(torch, smoke, name, calls, fn):
    total = 0.0
    for a, kw in calls:
        out = fn(*a, **kw)
        t_bytes = smoke.call_bytes(torch, name, a, kw, [out]) / \
            smoke.PEAK_BYTES
        ops, peak = smoke.call_ops(name, a, kw, out)
        total += max(t_bytes, ops / peak)
    return total * 1e3


@contextlib.contextmanager
def forcing(mod, name, plan_of):
    """mod.<name> (a planner) replaced by plan_of(*its args)."""
    orig = getattr(mod, name)
    setattr(mod, name, plan_of)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def misc(torch, smoke, _build, parent):
    import torch.nn.functional as F
    import kernel_variants
    from repro_torch.kernels import misc_pe
    from repro_torch.kernels import _build as b_

    def timed(what, label, calls, fn, wants):
        same = sum(torch.equal(fn(*a, **kw), w)
                   for (a, kw), w in zip(calls, wants))
        ms, wall = smoke.cuda_ms(torch, lambda: [fn(*a, **kw)
                                                 for a, kw in calls], REPS)
        log(f"misc {label}: {what}: {ms:.4f} ms ({wall:.4f}), {same} of "
            f"{len(calls)} bitwise")

    for label, calls in add_sets(torch):
        wants = [misc_pe.misc_add_plain(*a, **kw) for a, kw in calls]
        a0 = calls[0][0]
        p0 = misc_pe.plan_add(a0[0].numel(), a0[0].is_floating_point(),
                              a0[1].is_floating_point(),
                              calls[0][1].get("out_scale"), 16)
        b = bound_ms(torch, smoke, "misc_add", calls, misc_pe.misc_add_plain)
        log(f"misc {label}: misc_add x{len(calls)}, bound {b:.4f} ms; "
            f"planned {p0}")
        timed("planned", label, calls, misc_pe.misc_add, wants)
        each = [smoke.cuda_ms(torch, lambda a=a, kw=kw:
                              misc_pe.misc_add(*a, **kw), REPS)[0] * 1e3
                for a, kw in calls]
        log(f"misc {label}: us a call as planned: "
            + " ".join(f"{t:.2f}" for t in each))
        if calls[0][1].get("out_scale") is not None:
            ties = [near_ties(torch, *a, **kw) for a, kw in calls]
            log(f"misc {label}: values / groups near a tie: "
                + " ".join(f"{100 * v:.3f}%/{100 * g:.2f}%" for v, g in ties)
                + f"; operands {type(calls[0][0][2]).__name__} scales, "
                f"dtypes {calls[0][0][0].dtype}/{calls[0][0][1].dtype}")
        for vec, cap in [(p0.vec, c) for c in ADD_CAPS] + [(1, 0)]:
            with forcing(misc_pe, "plan_add",
                         lambda n, *_, v=vec, c=cap:
                         misc_pe.add_launch(n, v, c)):
                timed(f"{'scalar' if vec == 1 else 'vec'} {vec}"
                      f"{f', {cap} blocks an SM at most' if cap else ''}",
                      label, calls, misc_pe.misc_add, wants)
        if "--parts" in sys.argv:
            libs = kernel_variants.edited(_build, "misc_pe.cu", ADD_PARTS,
                                          "cnn_probe_misc", misc_pe._bind)
            for what, lib in libs:
                with kernel_variants.bound(_build, "misc_pe", lib):
                    ms, wall = smoke.cuda_ms(torch, lambda: [
                        misc_pe.misc_add(*a, **kw) for a, kw in calls], REPS)
                log(f"misc {label}: parts, cut {what}: {ms:.4f} ms "
                    f"({wall:.4f})")
        if parent is not None and hasattr(parent, "planned"):
            with kernel_variants.bound(_build, "misc_pe", parent):
                timed("parent kernel", label, calls, misc_pe.misc_add, wants)
        elif parent is not None:
            def old(a, b, sa, sb, act, out_scale=None, **_):
                out = torch.empty(a.shape, device="cuda",
                                  dtype=torch.int8 if out_scale is not None
                                  else torch.float32)
                b_.check(parent.misc_add(
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                    int(a.is_floating_point()), int(b.is_floating_point()),
                    sa, sb, b_.act_code(act), int(out_scale is not None),
                    1.0 if out_scale is None else out_scale,
                    b_.stream_ptr(a)), "parent misc_add")
                return out
            timed("parent kernel", label, calls, old, wants)

    rng = __import__("numpy").random.default_rng(2)
    shapes = list(smoke.AVGPOOL) + [((4, 56, 56, 256), 2, 2)]
    for shape, k, s in shapes:
        x = torch.from_numpy(rng.normal(size=shape).astype("float32")).cuda()
        calls = [((x, k, s), {})]
        wants = [misc_pe.avgpool2d_plain(x, k, s)]
        p0 = misc_pe.plan_avgpool(*shape, k, s, 16, True)
        label = f"avgpool2d {list(shape)} {k}/{s}"
        b = bound_ms(torch, smoke, "avgpool2d", calls,
                     misc_pe.avgpool2d_plain)
        log(f"misc {label}: bound {b:.4f} ms; planned {p0}")
        timed("planned", label, calls, misc_pe.avgpool2d, wants)
        outputs = wants[0].numel()
        for lanes in (1, 4):
            for block in misc_pe.POOL_BLOCKS:
                with forcing(misc_pe, "plan_avgpool",
                             lambda *_, l=lanes, bl=block:
                             misc_pe.pool_launch(outputs, l, k, bl)):
                    timed(f"{lanes} lanes, blocks of {block}", label, calls,
                          misc_pe.avgpool2d, wants)
        xf = x.permute(0, 3, 1, 2)
        ms, wall = smoke.cuda_ms(torch, lambda: F.avg_pool2d(xf, k, s), REPS)
        log(f"misc {label}: library F.avg_pool2d (channels_last) {ms:.4f} "
            f"ms ({wall:.4f})")
        if parent is not None and hasattr(parent, "planned"):
            with kernel_variants.bound(_build, "misc_pe", parent):
                timed("parent kernel", label, calls, misc_pe.avgpool2d,
                      wants)
        elif parent is not None:
            def old(x, k, s):
                n, h, w, c = x.shape
                ho, wo = (h - k) // s + 1, (w - k) // s + 1
                out = torch.empty((n, ho, wo, c), device="cuda")
                b_.check(parent.misc_avgpool2d(
                    x.data_ptr(), out.data_ptr(), n, h, w, c, k, s, ho, wo, 1,
                    b_.stream_ptr(x)), "parent avgpool2d")
                return out
            timed("parent kernel", label, calls, old, wants)


def bind_parent(lib):
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if hasattr(lib, "dwc_pe_dwc2d"):
        lib.dwc_pe_dwc2d.argtypes = [v, v, v, v, f, v] + [i] * 10 + [f, v]
        lib.dwc_pe_dwc2d.restype = i
    if hasattr(lib, "conv_pe_pool"):
        lib.conv_pe_pool.argtypes = [v, v, v, i, i, i, i, f, v, v, i, f, v,
                                     f, i, f, f, i, f, v]
        lib.conv_pe_pool.restype = i
    if hasattr(lib, "misc_add"):                # before the MISC planners
        lib.misc_add.argtypes = [v, v, v, ctypes.c_longlong, i, i, f, f, i,
                                 i, f, v]
        lib.misc_add.restype = i
        lib.misc_avgpool2d.argtypes = [v, v] + [i] * 9 + [v]
        lib.misc_avgpool2d.restype = i


def parts(torch, smoke, _build):
    """Each part cut from the planned dwc2d (on the pre-padded maps) and
    the planned pooled heads, bound in place of the library and timed."""
    import torch.nn.functional as F
    import kernel_variants
    from repro_torch.kernels import conv_pe, dwc_pe
    calls = []
    for (x, *rest), kw in dwc_calls(torch):
        t, b, l, r = kw["pad"]
        calls.append(((F.pad(x, (0, 0, l, r, t, b)), *rest),
                      dict(kw, pad=None)))
    libs = kernel_variants.edited(_build, "dwc_pe.cu", DWC_PARTS,
                                  "cnn_probe_dwc", dwc_pe._bind)
    for what, lib in libs:
        with kernel_variants.bound(_build, "dwc_pe", lib):
            ms, wall = smoke.cuda_ms(torch, lambda: [
                dwc_pe.dwc2d(*a, **kw) for a, kw in calls], REPS)
        log(f"dwc2d parts, cut {what}: {ms:.4f} ms ({wall:.4f}) for "
            f"{len(calls)} pre-padded calls")
    heads = head_calls(torch)
    libs = kernel_variants.edited(_build, "conv_pe.cu", POOL_PARTS,
                                  "cnn_probe_pool", conv_pe._bind)
    for what, lib in libs:
        with kernel_variants.bound(_build, "conv_pe", lib):
            times = [f"{label} " + "%.4f" % smoke.cuda_ms(
                torch, lambda a=a, kw=kw: conv_pe.matmul_int8_pool(*a, **kw),
                REPS)[0] for label, a, kw in heads]
        log(f"pool parts, cut {what}: " + "; ".join(times) + " ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cnn_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import kernel_variants
    from repro_torch.kernels import _build
    args = sys.argv[1:]
    log(smoke.card_line())
    _build.build_all()
    parent = {}
    if "--parent" in args:
        from pathlib import Path
        csrc = Path(args[args.index("--parent") + 1]) / "src" / \
            "repro_torch" / "csrc"
        names = ("misc_pe",) if "--misc" in args else ("dwc_pe", "conv_pe")
        jobs = [(name,) + kernel_variants.start(
                    _build, f"cnn_probe_parent_{name}", csrc / f"{name}.cu")
                for name in names]
        for name, out, proc in jobs:
            parent[name] = kernel_variants.finish(out, proc,
                                                  f"the parent's {name}")
            text = (csrc / f"{name}.cu").read_text()
            if name == "dwc_pe" and "int pt, int pl" in text:
                from repro_torch.kernels import dwc_pe
                dwc_pe._bind(parent[name])
                parent[name].in_place = True
            elif name == "misc_pe" and "int vec, int blocks" in text:
                from repro_torch.kernels import misc_pe
                misc_pe._bind(parent[name])
                parent[name].planned = True
            else:
                bind_parent(parent[name])
    with torch.inference_mode():
        if "--misc" in args:
            misc(torch, smoke, _build, parent.get("misc_pe"))
            return 0
        if "--parts" in args:
            parts(torch, smoke, _build)
            return 0
        dwc(torch, smoke, _build, parent.get("dwc_pe"))
        pool(torch, smoke, _build, parent.get("conv_pe"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
