#!/usr/bin/env python3
"""The flash attention's blocks and the causal 1-D conv's routes, on the card.

    PYTHONPATH=src python scripts/attn_probe.py [--parent DIR] [--parts]

Flash attention: at one qwen2-1.5b prefill (28 calls of [4, 12 / 2, 64,
128], softcap 0), one gemma2-2b prefill (13 calls of [4, 8 / 4, 64, 256],
softcap 50), each call on its own seeded inputs as each layer has its own,
and at chip_smoke's two 2048-token shapes (ATTN_LONG), every block the
kernel takes at that head dim (rows x threads) is forced by replacing
`flash_attn.plan` for the call, held within chip_smoke's ATTN_TOL of the
plain version and bit for bit against the ref backend's chunked prefill
attention (models/layers.flash_attention), and timed with chip_smoke's
`cuda_ms` (warm: device ms from torch.profiler, CUDA-event ms in
brackets); "(planned)" marks the block `flash_attn.plan` picks.  SDPA is
timed beside where no softcap applies.

dwc1d: at falcon-mamba-7b's prefill (64 calls, x the [4, 64, 8192] x half
of in_proj's [4, 64, 16384] rows, each call its own), both routes forced
by replacing `dwc_pe.plan_dwc1d`, bit for bit against the plain version,
timed the same way, beside F.conv1d + F.silu.

--parent DIR: an unpacked tree from before the two planners (`git archive
<rev> | tar -x -C DIR`), whose C interfaces took no block or route
arguments: `flash_attention(q, k, v, out, B, Hq, Hkv, L, S, D, chunk, bf16,
scale, softcap, inv_softcap, causal, stream)` and `dwc_pe_dwc1d(x, w, bias,
out, b, l, c, k, silu, stream)` on a contiguous x.  Its csrc/flash_attn.cu
and csrc/dwc_pe.cu are built into build/attn_probe_parent_*.so and timed
on the same inputs (its dwc1d after the `.contiguous()` copy its caller
made), so both trees are compared on one card in one call.

--parts: where the flash attention's time goes at the planned blocks:
variants of csrc/flash_attn.cu with one part cut out by a textual edit
(the edited text must be in the source once, or the probe fails) are
built into build/attn_probe_<n>.so, bound in place of the library and
timed.  A cut kernel's output is wrong; only its time is read.

Needs one GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REPS = 20
# (label, B, Hq, Hkv, L = S, D, softcap, calls)
PREFILLS = (("qwen2-1.5b prefill", 4, 12, 2, 64, 128, 0.0, 28),
            ("gemma2-2b prefill", 4, 8, 4, 64, 256, 50.0, 13))
DWC1D = (4, 64, 8192, 4, 64)            # B, L, C, k, calls (layers)
# --parts: (what is cut, [(text of csrc/flash_attn.cu, its replacement)])
PARTS = (
    ("nothing (as built)", []),
    ("3/4 of the score FMAs (d steps 1-3 of every 4)",
     [("sc[i][j] = __fmaf_rn(comp(qv[i], u), comp(kv[j], u),",
       "if (u == 0) sc[i][j] = __fmaf_rn(comp(qv[i], u), comp(kv[j], u),")]),
    ("3/4 of the p @ v FMAs (keys 1-3 of every 4)",
     [("for (int j = 0; j < GV; ++j) fma4(pv[i][j], comp(pp[i], u), vv[j]);",
       "for (int j = 0; j < GV; ++j) if (u == 0) fma4(pv[i][j], "
       "comp(pp[i], u), vv[j]);")]),
    ("the softmax statistics' passes over the chunk",
     [("for (int i = lane; i < nl; i += 32)",
       "for (int i = lane; i < 0; i += 32)"),
      ("for (int i = 4 * lane; i < nl; i += 128)",
       "for (int i = 4 * lane; i < 0; i += 128)")]),
    ("the K / V copies",
     [("    if (j < jobs) {\n", "    if (j < 0) {\n")]),
    ("the Q tile's load",
     [("    if (r < rows) {\n      const int f = f0 + r, h = hk * G + f % G;",
       "    if (r < 0) {\n      const int f = f0 + r, h = hk * G + f % G;")]),
    ("all of it (an empty kernel)",
     [("  extern __shared__ __align__(16) float smem[];\n  float* qs",
       "  if (Hq > 0) return;\n  extern __shared__ __align__(16) float "
       "smem[];\n  float* qs")]),
)


def log(*a):
    print(*a, flush=True)


def flash_inputs(torch, b, hq, hkv, l, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda") * sc
                 for shape, sc in (((b, hq, l, d), 3.0), ((b, hkv, l, d), 3.0),
                                   ((b, hkv, l, d), 1.0)))


def flash_cases(torch, smoke):
    """(label, [(q, k, v)], softcap) of each probed shape."""
    cases = [(label, [flash_inputs(torch, b, hq, hkv, l, d, i)
                      for i in range(n)], cap)
             for label, b, hq, hkv, l, d, cap, n in PREFILLS]
    for b, hq, hkv, l, d, cap in smoke.ATTN_LONG:
        cases.append((f"[{b}, {hq} / {hkv}, {l}, {d}] softcap {cap}",
                      [flash_inputs(torch, b, hq, hkv, l, d, 0)], cap))
    return cases


def bind_parent_flash(lib):
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int


def bind_parent_dwc(lib):
    lib.dwc_pe_dwc1d.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])
    lib.dwc_pe_dwc1d.restype = ctypes.c_int


def parent_flash(torch, _build, lib, q, k, v, cap):
    import numpy as np
    from repro_torch.kernels import flash_attn
    b, hq, l, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, l, d), dtype=torch.float32, device="cuda")
    inv = float(np.float32(1.0) / np.float32(cap)) if cap > 0 else 0.0
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        l, s, d, flash_attn.kv_chunk(s), 0, d ** -0.5, float(cap), inv, 1,
        _build.stream_ptr(q))
    _build.check(err, "parent flash_attention")
    return out


def flash(torch, smoke, _build, parent):
    from repro_torch.kernels import flash_attn
    for label, calls, cap in flash_cases(torch, smoke):
        b, hq, l, d = calls[0][0].shape
        hkv = calls[0][1].shape[1]
        planned = flash_attn.plan(b, hq, hkv, l, l, d)
        wants = [flash_attn.flash_attention_plain(q, k, v, causal=True,
                                                  softcap=cap)
                 for q, k, v in calls]
        rec = [((q, k, v), dict(causal=True, softcap=cap))
               for q, k, v in calls]
        ops, _ = smoke.call_ops("flash_attention", rec[0][0], rec[0][1],
                                wants[0])
        nbytes = smoke.call_bytes(torch, "flash_attention", rec[0][0],
                                  rec[0][1], wants[:1])
        t_ops, t_bytes = ops / smoke.PEAK_F32, nbytes / smoke.PEAK_BYTES
        bound = len(calls) * max(t_ops, t_bytes) * 1e3
        log(f"flash {label}: {len(calls)} calls, bound {bound:.4f} ms "
            f"({'operations' if t_ops > t_bytes else 'bytes'})")
        orig = flash_attn.plan
        for rows, threads in flash_attn.FLASH_BLOCKS:
            if not flash_attn._block_ok(d, rows, threads):
                continue
            smem = flash_attn.flash_smem(d, rows, threads, planned.chunk)
            if smem > flash_attn.SMEM_MAX:
                continue
            p = planned._replace(rows=rows, threads=threads, smem=smem,
                                 blocks=b * hkv * -(-(hq // hkv) * l // rows))
            flash_attn.plan = lambda *a, p=p: p
            try:
                def run():
                    return [flash_attn.flash_attention(q, k, v, causal=True,
                                                       softcap=cap)
                            for q, k, v in calls]
                gots = run()
                rel = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(gots, wants))
                same = smoke.blocked_same(torch, rec)
                ms, wall = smoke.cuda_ms(torch, run, REPS)
            finally:
                flash_attn.plan = orig
            log(f"flash {label}: {rows} rows x {threads} threads, "
                f"{p.blocks} blocks: {ms:.4f} ms ({wall:.4f}), "
                f"{ms / len(calls) * 1e3:.2f} us a call, "
                f"{100 * bound / ms:.1f}% of bound; max_rel_err {rel:.2e} "
                f"{'within' if rel <= smoke.ATTN_TOL else 'PAST'} ATTN_TOL; "
                f"{same} of {len(calls)} bitwise with the blocked prefill"
                f"{' (planned)' if p == planned else ''}")
        if parent is not None:
            fn = lambda: [parent_flash(torch, _build, parent, q, k, v, cap)
                          for q, k, v in calls]
            gots = fn()
            rel = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(gots, wants))
            ms, wall = smoke.cuda_ms(torch, fn, REPS)
            log(f"flash {label}: parent kernel {ms:.4f} ms ({wall:.4f}), "
                f"max_rel_err {rel:.2e}")
        lib = [smoke.library_fn(torch, "flash_attention",
                                flash_attn.flash_attention, a, kw)
               for a, kw in rec]
        if None not in lib:
            ms, wall = smoke.cuda_ms(torch, lambda: [f() for f in lib], REPS)
            log(f"flash {label}: SDPA {ms:.4f} ms ({wall:.4f})")
        del calls, wants, rec


def dwc1d(torch, smoke, _build, parent):
    import torch.nn.functional as F
    from repro_torch.kernels import dwc_pe
    b, l, c, k, n = DWC1D
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = [torch.randn((b, l, 2 * c), generator=g, device="cuda")
            for _ in range(n)]
    xs = [r[..., :c] for r in rows]
    ws = [torch.randn((k, c), generator=g, device="cuda") for _ in range(n)]
    bs = [torch.randn((c,), generator=g, device="cuda") for _ in range(n)]
    wants = [dwc_pe.dwc1d_causal_plain(x, w, bi, "silu")
             for x, w, bi in zip(xs, ws, bs)]
    bytes_ = n * (2 * b * l * c + k * c + c) * 4
    log(f"dwc1d falcon-mamba prefill: {n} calls of x [{b}, {l}, {c}] (the "
        f"x half of [{b}, {l}, {2 * c}] rows), bound "
        f"{bytes_ / smoke.PEAK_BYTES * 1e3:.4f} ms (bytes)")
    planned = dwc_pe.plan_dwc1d(b, l, c, k)
    orig = dwc_pe.plan_dwc1d
    cands = [planned, dwc_pe.plan_dwc1d(b, l, c, k, False)]
    for p in cands:
        dwc_pe.plan_dwc1d = lambda *a, p=p: p
        try:
            def run():
                return [dwc_pe.dwc1d_causal(x, w, bi, "silu")
                        for x, w, bi in zip(xs, ws, bs)]
            ok = all(torch.equal(g_, w_) for g_, w_ in zip(run(), wants))
            ms, wall = smoke.cuda_ms(torch, run, REPS)
        finally:
            dwc_pe.plan_dwc1d = orig
        log(f"dwc1d: {p.route} {p.steps} steps a thread, {p.blocks} "
            f"blocks: {ms:.4f} ms ({wall:.4f}) "
            f"{'bitwise' if ok else 'DIFFERS'}"
            f"{' (planned)' if p == planned else ''}")
    if parent is not None:
        def old():
            outs = []
            for x, w, bi in zip(xs, ws, bs):
                xc = x.contiguous()
                out = torch.empty_like(xc)
                _build.check(parent.dwc_pe_dwc1d(
                    xc.data_ptr(), w.data_ptr(), bi.data_ptr(),
                    out.data_ptr(), b, l, c, k, 1, _build.stream_ptr(xc)),
                    "parent dwc1d")
                outs.append(out)
            return outs
        ok = all(torch.equal(g_, w_) for g_, w_ in zip(old(), wants))
        ms, wall = smoke.cuda_ms(torch, old, REPS)
        log(f"dwc1d: parent kernel after its .contiguous() copy: {ms:.4f} ms "
            f"({wall:.4f}) {'bitwise' if ok else 'DIFFERS'}")
    xc = [x.permute(0, 2, 1).contiguous() for x in xs]
    wc = [w.t().contiguous()[:, None, :] for w in ws]
    ms, wall = smoke.cuda_ms(torch, lambda: [
        F.silu(F.conv1d(x, w, bi, padding=k - 1, groups=c)[..., :l])
        for x, w, bi in zip(xc, wc, bs)], REPS)
    log(f"dwc1d: library F.conv1d + F.silu {ms:.4f} ms ({wall:.4f})")


def parts(torch, smoke, _build):
    """Each PARTS variant of the flash kernel, bound in place of the
    library and timed at every probed shape's planned block."""
    from repro_torch.kernels import flash_attn
    import kernel_variants
    libs = kernel_variants.edited(_build, "flash_attn.cu", PARTS,
                                  "attn_probe", flash_attn._bind_attention)
    cases = flash_cases(torch, smoke)
    for what, lib in libs:
        with kernel_variants.bound(_build, "flash_attn", lib):
            times = []
            for label, calls, cap in cases:
                def run(calls=calls, cap=cap):
                    return [flash_attn.flash_attention(q, k, v, causal=True,
                                                       softcap=cap)
                            for q, k, v in calls]
                times.append(f"{label} "
                             f"{smoke.cuda_ms(torch, run, REPS)[0]:.4f}")
        log(f"flash parts, cut {what}: " + "; ".join(times) + " ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device", file=sys.stderr)
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
        jobs = [(name, bind) + kernel_variants.start(
                    _build, f"attn_probe_parent_{name}", csrc / f"{name}.cu")
                for name, bind in (("flash_attn", bind_parent_flash),
                                   ("dwc_pe", bind_parent_dwc))]
        for name, bind, out, proc in jobs:
            parent[name] = kernel_variants.finish(out, proc,
                                                  f"the parent's {name}")
            bind(parent[name])
    with torch.inference_mode():
        if "--parts" in args:
            parts(torch, smoke, _build)
            return 0
        flash(torch, smoke, _build, parent.get("flash_attn"))
        dwc1d(torch, smoke, _build, parent.get("dwc_pe"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
