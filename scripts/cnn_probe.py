#!/usr/bin/env python3
"""The DWC PE's routes and runs and the pooled head's strips, on the card.

    PYTHONPATH=src python scripts/cnn_probe.py [--parent DIR] [--parts]

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


def bind_parent(lib):
    v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if hasattr(lib, "dwc_pe_dwc2d"):
        lib.dwc_pe_dwc2d.argtypes = [v, v, v, v, f, v] + [i] * 10 + [f, v]
        lib.dwc_pe_dwc2d.restype = i
    if hasattr(lib, "conv_pe_pool"):
        lib.conv_pe_pool.argtypes = [v, v, v, i, i, i, i, f, v, v, i, f, v,
                                     f, i, f, f, i, f, v]
        lib.conv_pe_pool.restype = i


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
        jobs = [(name,) + kernel_variants.start(
                    _build, f"cnn_probe_parent_{name}", csrc / f"{name}.cu")
                for name in ("dwc_pe", "conv_pe")]
        for name, out, proc in jobs:
            parent[name] = kernel_variants.finish(out, proc,
                                                  f"the parent's {name}")
            if name == "dwc_pe" and "int pt, int pl" in (
                    csrc / "dwc_pe.cu").read_text():
                from repro_torch.kernels import dwc_pe
                dwc_pe._bind(parent[name])
                parent[name].in_place = True
            else:
                bind_parent(parent[name])
    with torch.inference_mode():
        if "--parts" in args:
            parts(torch, smoke, _build)
            return 0
        dwc(torch, smoke, _build, parent.get("dwc_pe"))
        pool(torch, smoke, _build, parent.get("conv_pe"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
