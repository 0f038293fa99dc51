#!/usr/bin/env python3
"""The Low-Channel stem's tile choices and the paged gather, on the card.

    PYTHONPATH=src python scripts/stem_probe.py [--parts]

Stem: at ResNet50's stem (4 x 229 x 229 x 3 int8, 7x7/2 to 64 channels,
3x3/2 max tail, static chain) every candidate pooled tile, and at
MobileNetV2's (4 x 225 x 225 x 3, 3x3/2 to 32 channels, no tail) every
candidate count of positions a block, are launched through
`low_channel.low_channel_conv` with `low_channel.plan` replaced by that
plan for the call, held bit for bit against the plain version and timed
with chip_smoke's `cuda_ms` (warm, as chip_smoke times the CNN kernels:
device ms a call from torch.profiler, CUDA-event ms in brackets);
"(planned)" marks the plan `low_channel.plan` picks, and its rules are
read off these lines.  chip_smoke's library yardstick (cuDNN's conv on
float32 copies, the epilogue in torch ops, F.max_pool2d) is timed beside.

Gather: at the decode-step shapes of qwen2-1.5b (4 slots x 8 pages of
16 x 2 x 128 bf16) and gemma2-2b (16 x 4 x 256), the pair in one launch
(`flash_attn.paged_gather_kv`), the same kernel once a pool
(`flash_attn.paged_gather` twice) and two `torch.index_select`s, each
held bitwise against the plain version and timed the same way.

--parts: where the stem's time goes.  Variants of csrc/low_channel.cu,
each with one part of the kernel cut out by a textual edit (the source
must still hold the edited line, or the probe fails), are built with the
repo's nvcc flags into build/stem_probe_<n>.so, bound in place of the
library, and timed at both stems' planned tiles beside the kernel as
built.  A cut kernel's output is wrong; only its time is read.

Needs one GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REPS = 50
# pooled tiles (rows, columns) at ResNet50's stem; positions a block at
# MobileNetV2's
MAX_TILES = ((7, 8), (8, 8), (6, 9), (5, 11), (4, 8), (4, 16), (10, 11),
             (9, 12), (11, 11))
POSITIONS = (128, 256, 512, 1024)
GATHERS = (("qwen2-1.5b", (2, 128)), ("gemma2-2b", (4, 256)))
# --parts: (what is cut, [(text of csrc/low_channel.cu, its replacement)])
PARTS = (
    ("nothing (as built)", []),
    ("the requant's division (a multiply instead)",
     [("static_cast<int8_t>(qdq_code(v, a.os))",
       "static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(v, a.os)), "
       "-127.f), 127.f))")]),
    ("the epilogue",
     [("if (p < npos && c < ocv) {",
       "if (p < npos && c < ocv && acc[j][r] == 0x7fffffff) {")]),
    ("the im2col gather (zero words stored)",
     [("if (qt.x >= 0) {", "if (qt.x >= 0 && ri.x < 0) {")]),
    ("the products", [("mma_s8(acc[2 * jj], af, bf[0], bf[1]);",
                       "acc[2 * jj][0] += bf[0] ^ af[0];"),
                      ("if (2 * jj + 1 < ntiles) mma_s8(acc[2 * jj + 1], af, "
                       "bf[2], bf[3]);",
                       "if (2 * jj + 1 < ntiles) acc[2 * jj + 1][0] += "
                       "bf[2] ^ af[1];")]),
    ("the max tail's pooling",
     [("for (int i = tid; i < th * tw * ov; i += THREADS) {",
       "for (int i = tid; i < 0; i += THREADS) {"),
      ("for (int i = tid; i < th * tw * ocv; i += THREADS) {",
       "for (int i = tid; i < 0; i += THREADS) {")]),
    ("the window's loads", [("    if (c < g0 + span)\n",
                             "    if (c < g0 + span && j < 0)\n")]),
    ("the filter's staging", [("for (int i = tid; i < nrow * KQ; "
                               "i += THREADS) {",
                               "for (int i = tid; i < 0; i += THREADS) {")]),
)


def log(*a):
    print(*a, flush=True)


def stem_case(torch, np, n, hw, k, oc, stride, pool):
    rng = np.random.default_rng(hw + oc)
    x = torch.from_numpy(rng.integers(-127, 128, (n, hw, hw, 3)).astype(
        np.int8)).cuda()
    w = torch.from_numpy(rng.integers(-127, 128, (k, k, 3, oc)).astype(
        np.int8)).cuda()
    wsc = torch.from_numpy(rng.uniform(0.005, 0.05, oc).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.uniform(-1, 1, oc).astype(np.float32)).cuda()
    kw = dict(a_scale=0.0117, w_scale=wsc)
    if pool:
        kw.update(pool="max", pool_kernel=3, pool_stride=2, mid_scale=0.061)
    else:
        kw.update(out_scale=0.043)
    return (x, w, bias, stride, "relu"), kw


def stem(torch, np, smoke, low_channel):
    for label, n, hw, k, oc, pool, cands in (
            ("resnet50 max tail", 4, 229, 7, 64, True, MAX_TILES),
            ("mobilenetv2", 4, 225, 3, 32, False,
             [(1, bp) for bp in POSITIONS])):
        args, kw = stem_case(torch, np, n, hw, k, oc, 2, pool)
        want = low_channel.low_channel_conv_plain(*args, **kw)
        pk, ps = (3, 2) if pool else (0, 0)
        planned = low_channel.plan(n, hw, hw, 3, oc, k, 2, pk, ps)
        orig = low_channel.plan
        for th, tw in cands:
            p = planned._replace(tile_h=th, tile_w=tw)
            low_channel.plan = lambda *a, p=p: p
            try:
                def call():
                    return low_channel.low_channel_conv(*args, **kw)
                ok = bool(torch.equal(call(), want))
                ms, wall = smoke.cuda_ms(torch, call, REPS)
            finally:
                low_channel.plan = orig
            what = f"tile {th}x{tw}" if pool else f"{tw} positions"
            log(f"stem {label}: {what}: {ms:.4f} ms "
                f"({wall:.4f}) {'bitwise' if ok else 'DIFFERS'}"
                f"{' (planned)' if p == planned else ''}")
        name = "low_channel_max" if pool else "low_channel"
        lib = smoke.library_fn(torch, name, low_channel.low_channel_conv,
                               args, kw)
        ms, wall = smoke.cuda_ms(torch, lib, REPS)
        log(f"stem {label}: library {ms:.4f} ms ({wall:.4f})")


def parts(torch, np, smoke, _build, low_channel):
    """Each PARTS variant of the stem kernel built, bound in place of the
    library, and timed at both stems' planned tiles."""
    import kernel_variants
    libs = kernel_variants.edited(_build, "low_channel.cu", PARTS,
                                  "stem_probe", low_channel._bind)
    cases = [stem_case(torch, np, 4, 229, 7, 64, 2, True),
             stem_case(torch, np, 4, 225, 3, 32, 2, False)]
    for what, lib in libs:
        with kernel_variants.bound(_build, "low_channel", lib):
            times = []
            for args, kw in cases:
                times.append(smoke.cuda_ms(torch, lambda: low_channel
                                           .low_channel_conv(*args, **kw),
                                           REPS)[0])
        log(f"stem parts, cut {what}: resnet50 max tail {times[0]:.4f} "
            f"ms, mobilenetv2 {times[1]:.4f} ms")


def gather(torch, smoke, flash_attn):
    g = torch.Generator(device="cuda").manual_seed(0)
    b, pages, page = 4, 8, 16
    tables = torch.arange(b * pages, dtype=torch.int32,
                          device="cuda").reshape(b, pages)
    for label, trailing in GATHERS:
        k_pool, v_pool = (torch.randn((b * pages, page) + trailing,
                                      generator=g, device="cuda")
                          .to(torch.bfloat16) for _ in range(2))
        want = flash_attn.paged_gather_kv_plain(k_pool, v_pool, tables)
        n, pg = k_pool.shape[0], k_pool.shape[1]
        flat = (tables.to(torch.int64)[..., None] * pg + torch.arange(
            pg, device="cuda")).reshape(-1)
        flats = [pool.reshape((n * pg,) + trailing)
                 for pool in (k_pool, v_pool)]
        for what, fn in (
                ("pair, one launch",
                 lambda: flash_attn.paged_gather_kv(k_pool, v_pool, tables)),
                ("one launch a pool",
                 lambda: (flash_attn.paged_gather(k_pool, tables),
                          flash_attn.paged_gather(v_pool, tables))),
                ("two index_select",
                 lambda: tuple(torch.index_select(f, 0, flat)
                               .reshape(b, pages * pg, *trailing)
                               for f in flats))):
            got = fn()
            ok = all(torch.equal(x, y) for x, y in zip(got, want))
            ms, wall = smoke.cuda_ms(torch, fn, REPS)
            log(f"gather {label} [{b} x {pages} pages of {page} x "
                f"{trailing}] bf16, {what}: {ms:.4f} ms ({wall:.4f}) "
                f"{'bitwise' if ok else 'DIFFERS'}")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stem_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from repro_torch.kernels import _build, flash_attn, low_channel
    log(smoke.card_line())
    _build.build_all()
    with torch.inference_mode():
        if "--parts" in sys.argv[1:]:
            parts(torch, np, smoke, _build, low_channel)
            return 0
        stem(torch, np, smoke, low_channel)
        gather(torch, smoke, flash_attn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
