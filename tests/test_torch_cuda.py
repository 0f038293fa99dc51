"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a GPU every test skips (decided in the fixture, not
at import).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (M/N/K off the tile sizes, odd channel counts,
stride 2, rows off the pooled GEMM's four 16-row tiles, C off 128, DWC
maps unpadded with every SAME pad the zoo produces, odd element
counts, int4 groups off the 1024-row staging chunk, pages off 16 bytes,
stem K off 32 and OC off its 64-channel block, pooled tiles off the plan's);
every output must equal the plain version bit for bit, except the flash
attention's and the float GEMM's (K = 8960 among its shapes, f32 and bf16,
every act, and its gradient), which agree with their plain versions to
f32 rounding (the float GEMM at bf16 output to one bf16 ulp); the flash
attention also equals the ref backend's chunked prefill attention bit for
bit at the served prefills and at two 1024-key chunks, and its shapes
reach every block its planner picks.  The causal 1-D conv reads strided
and misaligned column slices of wider rows on every route its planner
picks.  The float
GEMM's cases reach both routes: the bf16 tensor-core tiles (every operand
layout, split and not, the act in the tiles or in the reduction pass,
ragged M, N and K) and the FFMA kernel (f32, and bf16 rows off 16
bytes).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.quant import pack_int4
from repro_torch.kernels import (_build, conv_pe, dwc_pe, flash_attn,
                                 low_channel, misc_pe)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _q(rng, shape, dev):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)
                            ).to(dev)


def _f(rng, shape, dev, lo=0.005, hi=0.05):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)
                            ).to(dev)


def _check(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


# the int8 Conv PE's shapes reach both planned paths and their edges: M <= 4
# with >= 16 MiB of weights streams them (split K or not), every other shape
# runs tensor-core tiles (M = 1 / 4 / 16 / 256 split along K, N = 24 on
# 32-column tiles with the epilogue fused, 128-column tiles with the
# epilogue pass); K = 16 / 24 / 1000 and N = 24 / 67 / 1000 rows that are
# not 16-byte multiples, K = 8192 / 8960 long slices
@pytest.mark.parametrize("m,k,n", [(50, 16, 24), (130, 320, 67),
                                   (4, 1280, 1000), (1, 16, 24),
                                   (4, 8192, 288), (16, 24, 1000),
                                   (17, 1000, 2048), (256, 8192, 288),
                                   (3136, 24, 24), (1, 8192, 2048),
                                   (4, 8960, 2048), (4, 1536, 17920)])
@pytest.mark.parametrize("out_scale", [None, 0.0621, "vector"])
def test_conv_pe_gemm(dev, m, k, n, out_scale):
    rng = np.random.default_rng(m + k + n)
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    if out_scale == "vector":
        out_scale = _f(rng, (n,), dev, 0.03, 0.09)
    before = _build.COUNTS.get("conv_pe", 0)
    got = conv_pe.matmul_int8_fused(a, b, 0.0173, wsc, bias, "relu6",
                                    out_scale)
    assert _build.COUNTS["conv_pe"] == before + 1
    _check(got, conv_pe.matmul_int8_fused_plain(a, b, 0.0173, wsc, bias,
                                                "relu6", out_scale))


@pytest.mark.parametrize("m,k,n", [(49, 96, 24), (300, 144, 32),
                                   (4, 8960, 1536), (16, 1536, 2048),
                                   (256, 8960, 1536), (4, 8960, 2048)])
@pytest.mark.parametrize("res_dtype,mid", [(torch.int8, True),
                                           (torch.int8, False),
                                           (torch.float32, False)])
def test_conv_pe_residual(dev, m, k, n, res_dtype, mid):
    """int8 residuals (static chains, with and without mid_scale, int8 out)
    and f32 ones (the LM's residual stream, f32 out)."""
    rng = np.random.default_rng(m)
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    if res_dtype == torch.int8:
        kw = dict(out_scale=0.091, residual=_q(rng, (m, n), dev),
                  res_scale=0.047, mid_scale=0.083 if mid else None)
    else:
        kw = dict(residual=torch.from_numpy(rng.normal(
            size=(m, n)).astype(np.float32)).to(dev))
    before = _build.COUNTS.get("conv_pe_res", 0)
    got = conv_pe.matmul_int8_fused(a, b, 0.021, wsc, bias, "none", **kw)
    assert _build.COUNTS["conv_pe_res"] == before + 1
    _check(got, conv_pe.matmul_int8_fused_plain(a, b, 0.021, wsc, bias,
                                                "none", **kw))


@pytest.mark.parametrize("g,rows,k,n", [(4, 49, 320, 1280), (3, 16, 40, 70),
                                        (2, 4, 1024, 1000),
                                        (1, 100, 1024, 1024),
                                        (2, 100, 2000, 136)])
def test_conv_pe_pool(dev, g, rows, k, n):
    """MobileNetV2's head, K off 64 with ragged N, 4 rows an image (the
    64-px sweep's 2 x 2 maps) with N off the strip, and two heads past the
    shared memory: mobilenetv1's at 320 px (passes of rows, K whole) and K
    in two slices (2000: off 64) with ragged N."""
    rng = np.random.default_rng(g * rows)
    a, b = _q(rng, (g, rows, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    kw = dict(mid_scale=0.0713, out_scale=0.0377)
    _check(conv_pe.matmul_int8_pool(a, b, 0.0191, wsc, bias, "relu", **kw),
           conv_pe.matmul_int8_pool_plain(a, b, 0.0191, wsc, bias, "relu",
                                          **kw))


@pytest.mark.parametrize("g,rows,k,n", [(4, 49, 512, 2048), (3, 70, 40, 70),
                                        (2, 4, 1024, 1000),
                                        (1, 400, 512, 2048),
                                        (2, 100, 2000, 136)])
def test_conv_pe_pool_residual(dev, g, rows, k, n):
    """ResNet50's head, rows over four row tiles with K off 64, 4 rows an
    image with N off the strip, and two heads past the shared memory:
    ResNet50's at 640 px (seven passes of rows, the last one tile) and K
    in two slices with ragged N."""
    rng = np.random.default_rng(g * rows + 1)
    a, b = _q(rng, (g, rows, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    kw = dict(mid_scale=0.0713, out_scale=0.0377, residual=_q(
        rng, (g, rows, n), dev), res_scale=0.049, add_act="relu",
        add_scale=0.0811)
    before = _build.COUNTS.get("conv_pe_pool_res", 0)
    got = conv_pe.matmul_int8_pool(a, b, 0.0191, wsc, bias, "none", **kw)
    assert _build.COUNTS["conv_pe_pool_res"] == before + 1
    _check(got, conv_pe.matmul_int8_pool_plain(a, b, 0.0191, wsc, bias,
                                               "none", **kw))


# (N, H, W, C, k, stride, (top, bottom, left, right)): unpadded maps with
# every SAME pad the zoo produces -- (1, 1) at k 3 stride 1 and odd maps
# at stride 2, (0, 1) at k 3 stride 2 on even maps, (2, 2) at k 5 stride
# 1, (1, 2) at k 5 stride 2 on even maps -- at k 3 and 5, strides 1 and 2,
# C on both routes (96, 144 and 20: four channels a thread; 6: one) and W
# off every run; and pad None (x pre-padded, VALID: the JAX signature's
# meaning) at stride 2 with int8 out on both routes
DWC_CASES = [
    (2, 11, 11, 96, 3, 1, (1, 1, 1, 1)),
    (2, 12, 12, 144, 3, 2, (0, 1, 0, 1)),
    (2, 9, 9, 96, 3, 2, (1, 1, 1, 1)),
    (2, 9, 9, 144, 5, 1, (2, 2, 2, 2)),
    (2, 10, 10, 96, 5, 2, (1, 2, 1, 2)),
    (2, 11, 11, 20, 3, 1, (1, 1, 1, 1)),
    (2, 12, 12, 20, 3, 2, (0, 1, 0, 1)),
    (2, 9, 9, 20, 5, 1, (2, 2, 2, 2)),
    (2, 10, 10, 20, 5, 2, (1, 2, 1, 2)),
    (2, 11, 11, 6, 3, 1, (1, 1, 1, 1)),
    (2, 10, 10, 6, 5, 2, (1, 2, 1, 2)),
    (1, 7, 7, 6, 7, 1, (3, 3, 3, 3)),         # the scalar route's any k
    (2, 12, 12, 96, 3, 2, None),
    (2, 11, 11, 6, 5, 2, None),
]


def _dwc_operands(rng, n, h, w, c, k, dev):
    x, wt = _q(rng, (n, h, w, c), dev), _q(rng, (k, k, c), dev)
    return x, wt, _f(rng, (c,), dev), _f(rng, (c,), dev, -1.0, 1.0)


def _forced_dwc(monkeypatch, run):
    """dwc_pe.plan_dwc2d with its run replaced by `run` where the vector
    route takes it at that k (None: as planned)."""
    plan = dwc_pe.plan_dwc2d
    launched = []

    def forced(n, h, w, c, k, stride, aligned):
        p = plan(n, h, w, c, k, stride, aligned)
        if p.route != "scalar" and run in dwc_pe.DWC2D_RUNS[k]:
            p = dwc_pe.dwc2d_launch(p.route, run, w, c)
        launched.append((p.route, p.run))
        return p
    monkeypatch.setattr(dwc_pe, "plan_dwc2d", forced)
    return launched


@pytest.mark.parametrize("run", [None] + sorted(
    {r for runs in dwc_pe.DWC2D_RUNS.values() for r in runs}))
@pytest.mark.parametrize("n,h,w,c,k,stride,pad", DWC_CASES)
def test_dwc(dev, monkeypatch, n, h, w, c, k, stride, pad, run):
    """The unpadded map with its pad read in place (pad None: the map as
    given, VALID), held against the plain version on the F.pad-ded map;
    every run each vector route takes at its k."""
    rng = np.random.default_rng(c + k + stride)
    x, wt, wsc, bias = _dwc_operands(rng, n, h, w, c, k, dev)
    kw = dict(a_scale=0.031, w_scale=wsc, out_scale=0.057, pad=pad)
    launched = _forced_dwc(monkeypatch, run)
    before = _build.COUNTS.get("dwc", 0)
    got = dwc_pe.dwc2d(x, wt, bias, stride, "relu6", **kw)
    assert _build.COUNTS["dwc"] == before + 1
    assert launched[0][0] == ("vec4" if c % 4 == 0 and k in (3, 5)
                              else "scalar")
    _check(got, dwc_pe.dwc2d_plain(x, wt, bias, stride, "relu6", **kw))


@pytest.mark.parametrize("c,shift,route", [(96, 1, "scalar"),
                                           (96, 2, "scalar"),
                                           (96, 4, "vec4")])
def test_dwc_misaligned_view(dev, monkeypatch, c, shift, route):
    """x a view `shift` bytes off its allocation: a view off 4 bytes takes
    the scalar route."""
    rng = np.random.default_rng(shift)
    x, wt, wsc, bias = _dwc_operands(rng, 2, 12, 12, c, 3, dev)
    buf = torch.empty(x.numel() + shift, dtype=torch.int8, device=dev)
    view = buf[shift:].view(x.shape)
    view.copy_(x)
    launched = _forced_dwc(monkeypatch, None)
    kw = dict(a_scale=0.031, w_scale=wsc, out_scale=0.057, pad=(0, 1, 0, 1))
    got = dwc_pe.dwc2d(view, wt, bias, 2, "relu", **kw)
    assert launched[0][0] == route
    _check(got, dwc_pe.dwc2d_plain(x, wt, bias, 2, "relu", **kw))


@pytest.mark.parametrize("c", [144, 6])
def test_dwc_f32_out_and_valid(dev, c):
    """f32 out (out_scale None), no bias, and pad None: x pre-padded, the
    JAX signature's VALID meaning."""
    rng = np.random.default_rng(c)
    x, wt, wsc, _ = _dwc_operands(rng, 2, 10, 10, c, 3, dev)
    for pad in ((1, 1, 1, 1), None):
        kw = dict(a_scale=0.031, w_scale=wsc, pad=pad)
        _check(dwc_pe.dwc2d(x, wt, None, 1, "none", **kw),
               dwc_pe.dwc2d_plain(x, wt, None, 1, "none", **kw))


@pytest.mark.parametrize("bias", [0.0, 2.0 ** -18, -(2.0 ** -18)])
def test_dwc_requant_ties(dev, bias):
    """Unit scales and out_scale 2 put every odd sum on a half-integer (a
    bias of +-2^-18 just off it): the requant's multiply by the reciprocal
    hands these to the division, and the codes stay bitwise."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-1, 2, (2, 9, 9, 96)).astype(np.int8)
                         ).to(dev)
    wt = torch.from_numpy(rng.integers(-1, 2, (3, 3, 96)).astype(np.int8)
                          ).to(dev)
    kw = dict(a_scale=1.0, w_scale=torch.ones(96, device=dev),
              out_scale=2.0, pad=(1, 1, 1, 1))
    b = torch.full((96,), bias, device=dev)
    _check(dwc_pe.dwc2d(x, wt, b, 1, "none", **kw),
           dwc_pe.dwc2d_plain(x, wt, b, 1, "none", **kw))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("bias", [0.0, 2.0 ** -16, -(2.0 ** -16)])
def test_conv_pe_pool_requant_ties(dev, residual, bias):
    """The pooled head's requants at mid_scale and add_scale 2 with unit
    scales: every odd sum on a half-integer (or +-2^-16 off it)."""
    rng = np.random.default_rng(6)
    g, rows, k, n = 2, 49, 64, 128
    a = torch.from_numpy(rng.integers(-1, 2, (g, rows, k)).astype(np.int8)
                         ).to(dev)
    b = torch.from_numpy(rng.integers(-1, 2, (k, n)).astype(np.int8)).to(dev)
    kw = dict(mid_scale=2.0, out_scale=0.5)
    if residual:
        kw.update(residual=_q(rng, (g, rows, n), dev), res_scale=1.0,
                  add_act="none", add_scale=2.0)
    ones, bs = torch.ones((1, n), device=dev), torch.full((n,), bias,
                                                           device=dev)
    _check(conv_pe.matmul_int8_pool(a, b, 1.0, ones, bs, "none", **kw),
           conv_pe.matmul_int8_pool_plain(a, b, 1.0, ones, bs, "none", **kw))


def test_dwc_routes_covered():
    """Every (route, run) plan_dwc2d names at a zoo DWC shape (224 px,
    waves of 4; 64 px, batch 2) is among those test_dwc launches, and
    test_dwc launches the vector route at every k, stride and run the
    kernel instantiates (DWC2D_RUNS[k]; CPU-side: the planner alone)."""
    import dataclasses
    from repro_torch.compiler.graph import dwc_input_shapes
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    from repro_torch.kernels import ops

    def plan_of(n, h, w, c, k, stride, pad, aligned=16):
        top, bottom, left, right = pad or (0, 0, 0, 0)
        ho = (h + top + bottom - k) // stride + 1
        wo = (w + left + right - k) // stride + 1
        return dwc_pe.plan_dwc2d(n, ho, wo, c, k, stride, aligned)

    zoo = set()
    for cfg in CNN_ZOO.values():
        for hw, n in ((224, 4), (64, 2)):
            for h, w, c, k, s in dwc_input_shapes(
                    dataclasses.replace(cfg, input_hw=hw)):
                pad = ops._same_pad(h, k, s) + ops._same_pad(w, k, s)
                p = plan_of(n, h, w, c, k, s, pad)
                zoo.add((p.route, p.run, k))
    forced = {(p.route, r, k, s) for n, h, w, c, k, s, pad in DWC_CASES
              for p in [plan_of(n, h, w, c, k, s, pad)]
              if p.route != "scalar" for r in dwc_pe.DWC2D_RUNS[k]}
    tested = ({(p.route, p.run, case[4]) for case in DWC_CASES
               for p in [plan_of(*case)]}
              | {(route, r, k) for route, r, k, _ in forced})
    assert zoo <= tested
    assert forced == {("vec4", r, k, s)
                      for k, runs in dwc_pe.DWC2D_RUNS.items()
                      for r in runs for s in (1, 2)}


@pytest.mark.parametrize("k,run", [(5, 2), (5, 4), (3, 3)])
def test_dwc_refuses_a_run_not_built(dev, monkeypatch, k, run):
    """The kernel refuses a vector run it has no instantiation for (k 5
    takes run 1 alone), and the wrapper raises."""
    rng = np.random.default_rng(k + run)
    x, wt, wsc, bias = _dwc_operands(rng, 2, 10, 10, 96, k, dev)
    monkeypatch.setattr(dwc_pe, "plan_dwc2d",
                        lambda n, h, w, c, *a: dwc_pe.dwc2d_launch(
                            "vec4", run, w, c))
    with pytest.raises(RuntimeError):
        dwc_pe.dwc2d(x, wt, bias, 1, "relu6", a_scale=0.031, w_scale=wsc,
                     out_scale=0.057, pad=(k // 2,) * 4)


def test_low_channel(dev):
    rng = np.random.default_rng(7)
    x, w = _q(rng, (2, 33, 33, 3), dev), _q(rng, (3, 3, 3, 32), dev)
    wsc, bias = _f(rng, (32,), dev), _f(rng, (32,), dev, -1.0, 1.0)
    kw = dict(a_scale=0.0117, w_scale=wsc, out_scale=0.043)
    _check(low_channel.low_channel_conv(x, w, bias, 2, "relu", **kw),
           low_channel.low_channel_conv_plain(x, w, bias, 2, "relu", **kw))


# the stem core (int8 tensor-core implicit GEMM) without a tail: K = 27 /
# 108 / 100 / 147 (none a multiple of 32), OC below, at and above the
# 64-channel block, position counts off the block's, int8 and f32 out, a
# filter bank above 48 KB (3x3x3 x 2048)
@pytest.mark.parametrize("hw,k,ic,stride,oc,os", [
    (23, 3, 3, 1, 32, 0.043),      # yolov3's stem: k 3, stride 1
    (30, 6, 3, 2, 16, 0.043),      # yolov5n's stem: k 6 (K 108 -> 128)
    (19, 5, 4, 1, 24, None),       # K 100, f32 out
    (33, 7, 3, 2, 72, 0.043),      # OC above the block: 64 + 8
    (27, 3, 3, 2, 100, None),      # OC above the block, f32 out
    (9, 3, 3, 1, 2048, 0.043)])    # 55 KB of filter, 32 channel blocks
def test_low_channel_core(dev, hw, k, ic, stride, oc, os):
    rng = np.random.default_rng(hw + oc)
    x, w = _q(rng, (2, hw, hw + 2, ic), dev), _q(rng, (k, k, ic, oc), dev)
    wsc, bias = _f(rng, (oc,), dev), _f(rng, (oc,), dev, -1.0, 1.0)
    kw = dict(a_scale=0.0117, w_scale=wsc, out_scale=os)
    before = _build.COUNTS.get("low_channel", 0)
    got = low_channel.low_channel_conv(x, w, bias, stride, "relu6", **kw)
    assert _build.COUNTS["low_channel"] == before + 1
    _check(got, low_channel.low_channel_conv_plain(x, w, bias, stride,
                                                   "relu6", **kw))
    _check(low_channel.low_channel_conv(x, w, None, stride, "none", **kw),
           low_channel.low_channel_conv_plain(x, w, None, stride, "none",
                                              **kw))


@pytest.mark.parametrize("hw,k,oc,pk,ps,mid", [
    (229, 7, 64, 3, 2, 0.061),     # ResNet50's stem: 112 -> 55
    (37, 3, 40, 3, 2, 0.061),      # ragged tiles, OC off the block
    (21, 3, 24, 2, 2, None),       # dynamic chain: f32 max
    (45, 7, 100, 3, 2, 0.061),     # OC above the block, static chain
    (45, 7, 72, 3, 2, None),       # OC above the block, dynamic chain
    (29, 3, 16, 3, 2, 0.061)])     # OC below the block, ragged tiles
def test_low_channel_max_tail(dev, hw, k, oc, pk, ps, mid):
    rng = np.random.default_rng(hw + oc)
    x, w = _q(rng, (2, hw, hw, 3), dev), _q(rng, (k, k, 3, oc), dev)
    wsc, bias = _f(rng, (oc,), dev), _f(rng, (oc,), dev, -1.0, 1.0)
    kw = dict(a_scale=0.0117, w_scale=wsc, pool="max", pool_kernel=pk,
              pool_stride=ps, mid_scale=mid)
    before = _build.COUNTS.get("low_channel_max", 0)
    got = low_channel.low_channel_conv(x, w, bias, 2, "relu", **kw)
    assert _build.COUNTS["low_channel_max"] == before + 1
    _check(got, low_channel.low_channel_conv_plain(x, w, bias, 2, "relu",
                                                   **kw))


@pytest.mark.parametrize("shape", [(4, 7, 7, 2048), (3, 5, 7, 11), (1001,)])
@pytest.mark.parametrize("dtype,out_scale", [(torch.int8, 0.0437),
                                             (torch.float32, None),
                                             ("f32+int8", None),
                                             ("int8+f32", 0.0437)])
def test_misc_add(dev, shape, dtype, out_scale):
    """Both operands int8 codes or f32, or one of each (an LM add of the
    f32 residual stream and an int8 edge)."""
    rng = np.random.default_rng(len(shape) + int(out_scale is None))
    if dtype == torch.int8:
        a, b = _q(rng, shape, dev), _q(rng, shape, dev)
    elif dtype == torch.float32:
        a, b = _f(rng, shape, dev, -2.0, 2.0), _f(rng, shape, dev, -2.0, 2.0)
    else:
        a, b = _f(rng, shape, dev, -2.0, 2.0), _q(rng, shape, dev)
        if dtype == "int8+f32":
            a, b = b, a
    kw = dict(sa=0.0311, sb=0.0529, act="relu", out_scale=out_scale)
    before = _build.COUNTS.get("misc_add", 0)
    got = misc_pe.misc_add(a, b, **kw)
    assert _build.COUNTS["misc_add"] == before + 1
    _check(got, misc_pe.misc_add_plain(a, b, **kw))


@pytest.mark.parametrize("shape,window,stride", [
    ((4, 56, 56, 256), 3, 2), ((4, 7, 7, 2048), 7, 1), ((2, 9, 10, 3), 2, 2)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_avgpool2d(dev, shape, window, stride, dtype):
    rng = np.random.default_rng(window * 10 + stride)
    x = (_q(rng, shape, dev) if dtype == torch.int8
         else _f(rng, shape, dev, -3.0, 3.0))
    _check(misc_pe.avgpool2d(x, window, stride),
           misc_pe.avgpool2d_plain(x, window, stride))


@pytest.fixture
def plans(monkeypatch):
    """The plans the MISC wrappers took in the test, in call order."""
    seen = []
    for name in ("plan_add", "plan_avgpool"):
        orig = getattr(misc_pe, name)

        def spy(*args, _orig=orig):
            seen.append(_orig(*args))
            return seen[-1]
        monkeypatch.setattr(misc_pe, name, spy)
    return seen


def _add_operands(rng, kind, shape, dev):
    """(a, b) of an add kind: "int8" both codes, "f32" both floats,
    "f32+int8" / "int8+f32" one of each."""
    if kind == "int8":
        return _q(rng, shape, dev), _q(rng, shape, dev)
    if kind == "f32":
        return (_f(rng, shape, dev, -2.0, 2.0),
                _f(rng, shape, dev, -2.0, 2.0))
    a, b = _f(rng, shape, dev, -2.0, 2.0), _q(rng, shape, dev)
    return (b, a) if kind == "int8+f32" else (a, b)


# the vector route's lengths around its groups (16 codes, 4 elements), every
# operand kind, both outputs; the grid also capped at one block an SM and
# uncapped
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4097])
@pytest.mark.parametrize("kind,out_scale", [("int8", 0.0437),
                                            ("f32+int8", None),
                                            ("int8+f32", 0.0437),
                                            ("f32", None), ("int8", None)])
def test_misc_add_vector_lengths(dev, plans, n, kind, out_scale):
    rng = np.random.default_rng(n)
    a, b = _add_operands(rng, kind, (n,), dev)
    kw = dict(sa=0.0311, sb=0.0529, act="relu", out_scale=out_scale)
    want = misc_pe.misc_add_plain(a, b, **kw)
    _check(misc_pe.misc_add(a, b, **kw), want)
    assert plans[-1].route == "vec"
    assert plans[-1].vec == (16 if kind == "int8" else 4)
    planned = misc_pe.plan_add
    for cap in (1, 0):
        forced = misc_pe.add_launch(n, plans[-1].vec, cap)
        misc_pe.plan_add = lambda *args, _p=forced: _p
        try:
            _check(misc_pe.misc_add(a, b, **kw), want)
        finally:
            misc_pe.plan_add = planned


# the models' adds: gemma2's post-norm adds at a decode step and a prefill
# (f32 stream + int8 edge -> f32), ResNet50's first-stage residual add
@pytest.mark.parametrize("shape,kind,sa,sb,act,out_scale", [
    ((4, 2304), "f32+int8", 1.0, 0.0173, "none", None),
    ((256, 2304), "f32+int8", 1.0, 0.0173, "none", None),
    ((4, 56, 56, 256), "int8", 0.0311, 0.0529, "relu", 0.0437)])
def test_misc_add_model_shapes(dev, plans, shape, kind, sa, sb, act,
                               out_scale):
    rng = np.random.default_rng(shape[0])
    a, b = _add_operands(rng, kind, shape, dev)
    kw = dict(sa=sa, sb=sb, act=act, out_scale=out_scale)
    want = misc_pe.misc_add_plain(a, b, **kw)
    _check(misc_pe.misc_add(a, b, **kw), want)
    assert plans[-1].route == "vec"
    # one block an SM: a thread strides over several groups, each step's
    # words loaded while the last step adds
    forced = misc_pe.add_launch(a.numel(), plans[-1].vec, 1)
    planned = misc_pe.plan_add
    misc_pe.plan_add = lambda *args: forced
    try:
        _check(misc_pe.misc_add(a, b, **kw), want)
    finally:
        misc_pe.plan_add = planned
    assert forced.steps > 1 or a.numel() < 132 * 256 * forced.vec


# views whose first element is off 16 bytes (a storage offset of 1 or 3
# codes, 1 float) on either operand take the scalar route
@pytest.mark.parametrize("kind,which,offset", [
    ("int8", "a", 1), ("int8", "b", 3), ("f32", "a", 1), ("f32+int8", "b", 1),
    ("f32+int8", "a", 1)])
def test_misc_add_offset_views(dev, plans, kind, which, offset):
    rng = np.random.default_rng(offset)
    n = 4097
    a, b = _add_operands(rng, kind, (n + offset,), dev)
    a, b = (a[offset:], b[:n]) if which == "a" else (a[:n], b[offset:])
    kw = dict(sa=0.0311, sb=0.0529, act="relu6", out_scale=0.0437)
    _check(misc_pe.misc_add(a, b, **kw), misc_pe.misc_add_plain(a, b, **kw))
    assert plans[-1].route == "scalar"


@pytest.mark.parametrize("out_scale", [0.25, 0.3])
def test_misc_add_requant_ties(dev, plans, out_scale):
    """Sums on half-integers of the output scale: with sa = sb = os / 2 an
    odd a + b lands on (a + b) / 2 of os, exactly at os = 0.25 and within
    ulps at 0.3, so the requant's reciprocal falls back to the division
    at every odd sum; f32 operands put at (k + 0.5) x os likewise."""
    rng = np.random.default_rng(7)
    half = float(np.float32(out_scale) / np.float32(2))
    a, b = _q(rng, (4096 + 5,), dev), _q(rng, (4096 + 5,), dev)
    kw = dict(sa=half, sb=half, act="none", out_scale=out_scale)
    _check(misc_pe.misc_add(a, b, **kw), misc_pe.misc_add_plain(a, b, **kw))
    ks = rng.integers(-130, 130, 4096 + 3).astype(np.float32)
    af = torch.from_numpy((ks + np.float32(0.5)) * np.float32(out_scale)
                          ).to(dev)
    bf = torch.zeros_like(af)
    kw = dict(sa=1.0, sb=1.0, act="none", out_scale=out_scale)
    _check(misc_pe.misc_add(af, bf, **kw),
           misc_pe.misc_add_plain(af, bf, **kw))
    assert [p.route for p in plans] == ["vec", "vec"]


@pytest.mark.parametrize("out_scale,route", [(3e38, "scalar"),
                                             (1e-39, "scalar"),
                                             (2.0 ** 100, "vec"),
                                             (2.0 ** -100, "vec")])
def test_misc_add_scale_without_normal_reciprocal(dev, plans, out_scale,
                                                  route):
    """An output scale whose reciprocal is not a normal float (3e38: a
    subnormal one; 1e-39, itself subnormal: inf) takes the scalar route and
    its division; the vector route's exact requant holds to the ends of
    its range, 2^-100 and 2^100 (f32 operands spanning the scale's
    codes)."""
    rng = np.random.default_rng(11)
    if route == "scalar":
        a = _f(rng, (4099,), dev, -3e38, 3e38)
        kw = dict(sa=1.0, sb=1e30, act="none", out_scale=out_scale)
    else:
        a = _f(rng, (4099,), dev, -130.0, 130.0)
        kw = dict(sa=out_scale, sb=out_scale / 2, act="none",
                  out_scale=out_scale)
    b = _q(rng, (4099,), dev)
    _check(misc_pe.misc_add(a, b, **kw), misc_pe.misc_add_plain(a, b, **kw))
    assert plans[-1].route == route


def test_misc_add_refuses_a_plan_it_has_not_built(dev):
    """The kernel refuses a plan it has no instantiation for (16-element
    groups with an f32 operand, 8-element ones) rather than launch it."""
    a, b = torch.zeros(64, device=dev), torch.zeros(64, device=dev)
    planned = misc_pe.plan_add
    for bad in (misc_pe.PlanAdd("vec", 16, 1, 1),
                misc_pe.PlanAdd("vec", 8, 1, 1)):
        misc_pe.plan_add = lambda *args, _p=bad: _p
        try:
            with pytest.raises(RuntimeError):
                misc_pe.misc_add(a, b)
        finally:
            misc_pe.plan_add = planned


# every window instantiation (k 2 / 3 / 5 / 7) and the run-time one (k 4,
# 6), strides 1 / 2 / 3, C 3 / 11 / 256 / 2048, odd H and W, windows equal
# to the map
@pytest.mark.parametrize("shape,window,stride", [
    ((2, 9, 11, 3), 2, 1), ((2, 11, 13, 11), 3, 3), ((2, 13, 9, 256), 5, 2),
    ((3, 7, 7, 256), 7, 1), ((1, 9, 9, 2048), 4, 1), ((2, 6, 6, 12), 6, 1),
    ((2, 15, 17, 2048), 3, 2), ((1, 5, 5, 11), 5, 1), ((4, 8, 8, 256), 2, 2)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_avgpool2d_windows(dev, plans, shape, window, stride, dtype):
    rng = np.random.default_rng(window * 100 + shape[-1])
    x = (_q(rng, shape, dev) if dtype == torch.int8
         else _f(rng, shape, dev, -3.0, 3.0))
    _check(misc_pe.avgpool2d(x, window, stride),
           misc_pe.avgpool2d_plain(x, window, stride))
    p = plans[-1]
    assert p.kt == (window if window in misc_pe.POOL_KS else 0)
    assert p.lanes == 1 or shape[-1] % 4 == 0
    assert p == misc_pe.plan_avgpool(*shape, window, stride, 16,
                                     dtype == torch.float32)
    planned = misc_pe.plan_avgpool
    outputs = misc_pe.avgpool2d_plain(x, window, stride).numel()
    for lanes in ((1, 4) if shape[-1] % 4 == 0 else (1,)):
        for block in misc_pe.POOL_BLOCKS:
            forced = misc_pe.pool_launch(outputs, lanes, window, block)
            misc_pe.plan_avgpool = lambda *args, _p=forced: _p
            try:
                _check(misc_pe.avgpool2d(x, window, stride),
                       misc_pe.avgpool2d_plain(x, window, stride))
            finally:
                misc_pe.plan_avgpool = planned


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1),
                                          (torch.int8, 2)])
def test_avgpool2d_offset_view(dev, plans, dtype, offset):
    """A map whose first element is off 16 bytes (f32) or 4 (int8): one
    channel a thread."""
    rng = np.random.default_rng(offset)
    shape = (2, 9, 9, 256)
    flat = (_q(rng, (offset + 2 * 9 * 9 * 256,), dev) if dtype == torch.int8
            else _f(rng, (offset + 2 * 9 * 9 * 256,), dev, -3.0, 3.0))
    x = flat[offset:].view(shape)
    _check(misc_pe.avgpool2d(x, 3, 2), misc_pe.avgpool2d_plain(x, 3, 2))
    assert plans[-1].lanes == 1 and plans[-1].kt == 3


def _w4(rng, dev, m, k, n, gs):
    a = _q(rng, (m, k), dev)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    return a, pack_int4(w, gs)


def _w4_plans(m, n, k, gs, a, b):
    """Every plan conv_pe.plan_w4 can name for the product: each stream
    strip, and the tensor-core tiles where the groups are multiples of
    32."""
    wa = conv_pe._width(k, conv_pe.byte_align(a))
    wb = conv_pe._width(n, conv_pe.byte_align(b))
    plans = [conv_pe.stream_plan_w4(m, n, k, gs, wa, wb, bn)
             for bn in conv_pe.W4_BNS]
    if gs % 32 == 0:
        plans.append(conv_pe.mma_plan_w4(m, n, k, gs, wa, wb))
    return plans


def _w4_each_plan(monkeypatch, kernel, m, n, k, gs, args, kwargs):
    """Run the int4 GEMM on every plan (forced through plan_w4), each one
    launch counted under `kernel`, and hold each bit for bit against the
    plain version -- so the routes and strips agree with each other too."""
    want = conv_pe.matmul_int4_fused_plain(*args, **kwargs)
    planned = conv_pe.plan_w4(m, n, k, gs, conv_pe.byte_align(args[0]),
                              conv_pe.byte_align(args[1]))
    plans = _w4_plans(m, n, k, gs, args[0], args[1])
    assert planned in plans
    got = {}
    for p in plans:
        monkeypatch.setattr(conv_pe, "plan_w4", lambda *a, _p=p: _p)
        before = _build.COUNTS.get(kernel, 0)
        got[p] = conv_pe.matmul_int4_fused(*args, **kwargs)
        assert _build.COUNTS[kernel] == before + 1
        _check(got[p], want)
    routes = {p.route for p in plans}
    assert routes == ({"stream", "mma"} if gs % 32 == 0 else {"stream"})


# (M, K, N, gs): every M the served paths give (1 and 4 slots decoding, 5,
# 9 and 37 off the 4-row stream blocks and the 64-row tiles, 256 = a 4 x 64
# prefill); group sizes 4, 32, 64, 128 and 1024; N off 16 (40: 8-byte
# rows, 70: 2-byte, 33: bytes); qwen2's QKV and down and gemma2's down
# projection at decode and prefill (K = 8960 / 9216: 140 / 144 groups in
# three chunks; with N = 33, the three chunks take the scales and zeros
# by halfs and the packed rows by bytes)
W4_SHAPES = [(1, 96, 40, 4), (4, 1536, 2048, 64), (4, 8960, 1536, 64),
             (4, 9216, 2304, 64), (5, 2048, 70, 32), (5, 96, 40, 32),
             (9, 8960, 33, 64), (37, 192, 70, 64), (37, 1024, 33, 128),
             (37, 2048, 96, 1024), (256, 8960, 1536, 64),
             (256, 9216, 2304, 64), (256, 192, 40, 32)]


@pytest.mark.parametrize("m,k,n,gs", W4_SHAPES)
@pytest.mark.parametrize("out_kind", ["f32", "scalar", "vector"])
def test_conv_pe_w4(dev, monkeypatch, m, k, n, gs, out_kind):
    """Plain int4 GEMM with bias and relu on every plan: per-row a_scale,
    f32 or int8 out at a scalar or a per-column scale."""
    rng = np.random.default_rng(m + k + n)
    a, q4 = _w4(rng, dev, m, k, n, gs)
    asc, bias = _f(rng, (m, 1), dev), _f(rng, (n,), dev, -1.0, 1.0)
    os = {"f32": None, "scalar": 0.0621,
          "vector": _f(rng, (1, n), dev, 0.02, 0.09)}[out_kind]
    _w4_each_plan(monkeypatch, "conv_pe_w4", m, n, k, gs,
                  (a, q4.packed, asc, q4.scale, q4.zero, bias, "relu", os),
                  {})


@pytest.mark.parametrize("m,k,n,gs", [(4, 8960, 1536, 64),
                                      (12, 1536, 1536, 64),
                                      (256, 2048, 2304, 64),
                                      (37, 128, 70, 32)])
@pytest.mark.parametrize("res_dtype,mid,os", [
    (torch.float32, None, None), (torch.float32, 0.0377, None),
    (torch.int8, 0.0377, 0.0519), (torch.int8, None, "vector")])
def test_conv_pe_w4_residual(dev, monkeypatch, m, k, n, gs, res_dtype, mid,
                             os):
    """The residual variant on every plan: the LM's f32 residual stream
    (dynamic chain or static mid_scale qdq) and an int8 operand requantized
    at a scalar or per-column scale (qwen2's down projection, its O
    projection off the 4-row blocks, gemma2's O at prefill, ragged N)."""
    rng = np.random.default_rng(7 + m)
    a, q4 = _w4(rng, dev, m, k, n, gs)
    r = (_q(rng, (m, n), dev) if res_dtype == torch.int8 else
         torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dev))
    if os == "vector":
        os = _f(rng, (n,), dev, 0.03, 0.09)
    kw = dict(residual=r, res_scale=1.0 if mid is None else 0.031,
              mid_scale=mid, add_act="none" if mid is None else "relu")
    _w4_each_plan(monkeypatch, "conv_pe_w4_res", m, n, k, gs,
                  (a, q4.packed, 0.0173, q4.scale, q4.zero, None, "none", os),
                  kw)


def test_conv_pe_w4_refuses_plans_it_does_not_take(dev, monkeypatch):
    """The kernel launches what the plan names or refuses it: tensor-core
    tiles are 64 x 64 and need groups of a multiple of 32 K rows, stream
    strips are 16 or 32 columns, and a chunk holds at most the K's groups."""
    rng = np.random.default_rng(3)
    a, q4 = _w4(rng, dev, 8, 96, 64, 4)
    base = conv_pe.plan_w4(8, 64, 96, 4, 16, 16)
    for bad in (base._replace(route="mma", bm=64, bn=64),
                base._replace(bn=64), base._replace(bn=24),
                base._replace(gc=25)):
        monkeypatch.setattr(conv_pe, "plan_w4", lambda *args, _p=bad: _p)
        with pytest.raises(RuntimeError):
            conv_pe.matmul_int4_fused(a, q4.packed, 1.0, q4.scale, q4.zero)
    a, q4 = _w4(rng, dev, 8, 96, 64, 32)
    tile = [p for p in _w4_plans(8, 64, 96, 32, a, q4.packed)
            if p.route == "mma"][0]
    for bad in (tile._replace(bm=32), tile._replace(bn=32)):
        monkeypatch.setattr(conv_pe, "plan_w4", lambda *args, _p=bad: _p)
        with pytest.raises(RuntimeError):
            conv_pe.matmul_int4_fused(a, q4.packed, 1.0, q4.scale, q4.zero)


@pytest.mark.parametrize("dtype,p,trailing", [
    (torch.bfloat16, 16, (2, 128)),       # qwen2's pages: 8 KB
    (torch.bfloat16, 3, (1, 5)),          # 30-byte pages
    (torch.float32, 3, (3, 5)),           # 180-byte pages
    (torch.float32, 16, (4, 256))])       # gemma2's page shape in f32
def test_paged_gather_kv(dev, dtype, p, trailing):
    """k and v in one launch, through a table with sentinel entries (N, one
    past the pool) and a whole sentinel row, which the kernel clamps."""
    n = 9
    g = torch.Generator(device=dev).manual_seed(p)
    k_pool, v_pool = (torch.randn((n, p) + trailing, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
    tables = torch.tensor([[3, 0, 9, 9], [9, 9, 9, 9], [5, 2, 7, 8]],
                          dtype=torch.int32, device=dev)
    before = _build.COUNTS.get("paged_gather", 0)
    got = flash_attn.paged_gather_kv(k_pool, v_pool, tables)
    assert _build.COUNTS["paged_gather"] == before + 1
    want = flash_attn.paged_gather_kv_plain(k_pool, v_pool, tables)
    for a, b in zip(got, want, strict=True):
        _check(a, b)


@pytest.mark.parametrize("dtype,trailing", [(torch.bfloat16, (2, 128)),
                                            (torch.float32, (3, 5))])
def test_paged_gather(dev, dtype, trailing):
    """Gather through a table with a clipped sentinel row (the ops wrapper
    clips; here the entries are already in range), bf16 pages of 16-byte
    multiples and f32 pages that are not."""
    n, p = 9, 16 if dtype == torch.bfloat16 else 3
    pool = torch.randn((n, p) + trailing, device=dev).to(dtype)
    tables = torch.tensor([[3, 0, 8], [8, 8, 8], [5, 2, 7]],
                          dtype=torch.int32, device=dev)
    before = _build.COUNTS.get("paged_gather", 0)
    got = flash_attn.paged_gather(pool, tables)
    assert _build.COUNTS["paged_gather"] == before + 1
    _check(got, flash_attn.paged_gather_plain(pool, tables))


def test_wrapper_rejects_bad_operands(dev):
    rng = np.random.default_rng(0)
    a = _q(rng, (8, 16), dev)
    with pytest.raises(ValueError):
        conv_pe.matmul_int8_fused(a, _q(rng, (16, 8), dev).t(), 1.0,
                                  torch.ones(8, device=dev))
    with pytest.raises(ValueError):
        conv_pe.matmul_int8_fused(a.float(), _q(rng, (16, 8), dev), 1.0,
                                  torch.ones(8, device=dev))
    # the new wrappers: wrong dtype, non-contiguous operand
    x = _q(rng, (2, 8, 8, 6), dev)
    with pytest.raises(ValueError):
        misc_pe.misc_add(x, x.to(torch.int16), 1.0, 1.0)
    with pytest.raises(ValueError):
        misc_pe.misc_add(x.to(torch.int32), x.to(torch.int32), 1.0, 1.0)
    with pytest.raises(ValueError):
        misc_pe.misc_add(x.transpose(1, 2), x, 1.0, 1.0)
    with pytest.raises(ValueError):
        misc_pe.avgpool2d(x.transpose(1, 2), 2, 2)
    with pytest.raises(ValueError):
        misc_pe.avgpool2d(x.to(torch.int16), 2, 2)
    w = _q(rng, (3, 3, 3, 8), dev)
    xs = _q(rng, (1, 9, 9, 3), dev)
    with pytest.raises(ValueError):
        low_channel.low_channel_conv(xs.float(), w, None, 2, "relu", 1.0,
                                     torch.ones(8, device=dev), pool="max",
                                     pool_kernel=3, pool_stride=2,
                                     mid_scale=0.1)
    with pytest.raises(ValueError):
        low_channel.low_channel_conv(xs.transpose(1, 2), w, None, 2, "relu",
                                     1.0, torch.ones(8, device=dev),
                                     pool="max", pool_kernel=3,
                                     pool_stride=2, mid_scale=0.1)
    a3 = _q(rng, (2, 9, 16), dev)
    with pytest.raises(ValueError):
        conv_pe.matmul_int8_pool(a3, _q(rng, (16, 8), dev), 1.0,
                                 torch.ones(8, device=dev), None, "none",
                                 mid_scale=0.1, residual=_q(
                                     rng, (2, 9, 8), dev).float(),
                                 add_scale=0.1)
    with pytest.raises(ValueError):
        conv_pe.matmul_int8_pool(a3, _q(rng, (16, 8), dev), 1.0,
                                 torch.ones(8, device=dev), None, "none",
                                 mid_scale=0.1, residual=_q(
                                     rng, (2, 8, 9), dev).transpose(1, 2),
                                 add_scale=0.1)
    a, q4 = _w4(rng, dev, 4, 64, 16, 64)
    with pytest.raises(ValueError):
        conv_pe.matmul_int4_fused(a, q4.packed, 1.0, q4.scale.float(),
                                  q4.zero)
    with pytest.raises(ValueError):             # group size 2: not a x4
        conv_pe.matmul_int4_fused(a, q4.packed, 1.0,
                                  q4.scale.repeat(32, 1), q4.zero.repeat(
                                      32, 1))
    with pytest.raises(ValueError):
        flash_attn.paged_gather(torch.zeros(4, 2, 8, device=dev),
                                torch.zeros(2, 2, dtype=torch.int64,
                                            device=dev))


@pytest.mark.parametrize("b,l,c,k", [(2, 12, 40, 4), (1, 2, 33, 4),
                                     (3, 17, 8192, 4), (2, 9, 96, 2)])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("bias", [True, False])
def test_dwc1d_causal(dev, b, l, c, k, act, bias):
    """The causal temporal conv: C off 32, L shorter than k, no bias; the
    silu is torch's CUDA F.silu's formula, so the kernel equals the plain
    version bit for bit."""
    rng = np.random.default_rng(b * l + c + k)
    x = torch.from_numpy(rng.normal(size=(b, l, c)).astype(np.float32)).to(
        dev)
    w = torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)).to(dev)
    bs = _f(rng, (c,), dev, -1.0, 1.0) if bias else None
    before = _build.COUNTS.get("dwc1d", 0)
    got = dwc_pe.dwc1d_causal(x, w, bs, act)
    assert _build.COUNTS["dwc1d"] == before + 1
    _check(got, dwc_pe.dwc1d_causal_plain(x, w, bs, act))
    with pytest.raises(ValueError):
        dwc_pe.dwc1d_causal(x, w, bs, "relu")


# (B, L, C, k, offset): x the columns [offset, offset + C) of in_proj-style
# rows [B, L, 2C]; offset 0 with k = 4 is the mamba mixer's view (float4
# route); k 2 / 3 / 5, offset 1 (misaligned) and C = 33 (off four channels)
# take the scalar route
DWC1D_VIEWS = [(4, 64, 8192, 4, 0), (3, 17, 96, 4, 0), (2, 9, 96, 2, 0),
               (2, 9, 96, 3, 0), (2, 9, 96, 5, 0), (4, 64, 8192, 4, 1),
               (2, 12, 33, 4, 0), (2, 12, 40, 3, 1)]


@pytest.mark.parametrize("b,l,c,k,offset", DWC1D_VIEWS)
def test_dwc1d_causal_strided_view(dev, b, l, c, k, offset):
    """The causal conv reads a column slice of wider rows in place (no
    copy: the wrapper takes the view's strides) on the route its planner
    picks, bit for bit with the plain version on the same view."""
    rng = np.random.default_rng(b + l + c + offset)
    rows = torch.from_numpy(rng.normal(size=(b, l, 2 * c)).astype(
        np.float32)).to(dev)
    x = rows[..., offset:offset + c]
    assert not x.is_contiguous()
    w = torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)).to(dev)
    bs = _f(rng, (c,), dev, -1.0, 1.0)
    p = dwc_pe.plan_dwc1d(b, l, c, k, dwc_pe._aligned_rows(x))
    assert p.route == ("vec4" if offset == 0 and c % 4 == 0 and k == 4
                       else "scalar")
    before = _build.COUNTS.get("dwc1d", 0)
    got = dwc_pe.dwc1d_causal(x, w, bs, "silu")
    assert _build.COUNTS["dwc1d"] == before + 1
    assert got.is_contiguous()
    _check(got, dwc_pe.dwc1d_causal_plain(x, w, bs, "silu"))


def test_dwc1d_routes_covered():
    """DWC1D_VIEWS launch both routes, and the scalar route at k below and
    above the float4 route's 4, on aligned and misaligned views
    (CPU-side: the planner alone)."""
    seen = {(dwc_pe.plan_dwc1d(b, l, c, k, offset == 0).route, k, offset == 0)
            for b, l, c, k, offset in DWC1D_VIEWS}
    assert ("vec4", 4, True) in seen
    assert {r for r, _, _ in seen} == {"vec4", "scalar"}
    assert {k for r, k, _ in seen if r == "scalar"} >= {2, 3, 4, 5}
    assert {a for r, _, a in seen if r == "scalar"} == {True, False}
    assert all(k == dwc_pe.DWC1D_VEC_K for r, k, _ in seen if r == "vec4")


@pytest.mark.parametrize("m,k,n", [(4, 8192, 288), (37, 256, 288),
                                   (1, 1000, 24), (256, 8192, 288),
                                   (4, 4096, 16384)])
@pytest.mark.parametrize("shift", [0, 1])
def test_conv_pe_gemm_per_token_scale(dev, m, k, n, shift):
    """The mamba x_proj shape (N = 288, K = 8192 at full width) with a
    per-token a_scale [M, 1], f32 out: the eager SSM path's GEMM.  `shift`
    moves both operands one byte off their allocation, so the planned
    copies fall back to single bytes."""
    rng = np.random.default_rng(m + n)

    def shifted(t):
        buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=dev)
        view = buf[shift:].view(t.shape)
        view.copy_(t)
        return view

    a, b = shifted(_q(rng, (m, k), dev)), shifted(_q(rng, (k, n), dev))
    asc, wsc = _f(rng, (m, 1), dev), _f(rng, (1, n), dev)
    _check(conv_pe.matmul_int8_fused(a, b, asc, wsc),
           conv_pe.matmul_int8_fused_plain(a, b, asc, wsc))


# the int8 Conv PE's tanh-gelu epilogue on every route conv_pe.plan can
# name, forced: weight streaming over one K slice and split, tensor-core
# tiles of 32, 64 and 128 columns, and split; gelu runs in the epilogue
# pass on each (the wrapper unfuses the plans that would fuse it);
# (route, M, K, N, plan fields)
GELU_PLANS = [("stream", 4, 256, 1000, ("stream", 4, 128, 1, 256)),
              ("stream split", 3, 512, 1000, ("stream", 4, 128, 2, 256)),
              ("tiles 32", 50, 320, 67, ("mma", 128, 32, 1, 320)),
              ("tiles 64", 130, 320, 67, ("mma", 128, 64, 1, 320)),
              ("tiles 128", 256, 320, 300, ("mma", 128, 128, 1, 320)),
              ("tiles split", 4, 2560, 2560, ("mma", 128, 128, 6, 448))]
# recurrentgemma-2b's gelu projections, planned: in_gate (K 2560, N 2560)
# and the GeGLU gate wg (N 7680) at a decode step (M = 4) and a prefill
GELU_SERVED = [(4, 2560, 2560), (4, 2560, 7680), (256, 2560, 2560),
               (256, 2560, 7680)]


def _gelu_plan(a, b, fields, fused):
    m, k = a.shape
    n = b.shape[1]
    wa = conv_pe._width(k, conv_pe.byte_align(a))
    wb = conv_pe._width(n, conv_pe.byte_align(b))
    return conv_pe.Plan(*fields, wa, wb, fused)


@pytest.mark.parametrize("case", GELU_PLANS, ids=[c[0] for c in GELU_PLANS])
@pytest.mark.parametrize("out_scale", [None, 0.0621])
def test_conv_pe_gelu_routes(dev, monkeypatch, case, out_scale):
    """gelu on each route, per-token a_scale and a bias, f32 and int8 out:
    bit for bit torch's CUDA F.gelu(approximate="tanh") in the plain
    version, with the epilogue fused where the plan says so."""
    _, m, k, n, fields = case
    rng = np.random.default_rng(m + k + n)
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    asc, wsc = _f(rng, (m, 1), dev), _f(rng, (1, n), dev, 0.0005, 0.002)
    bias = _f(rng, (n,), dev, -3.0, 3.0)
    p = _gelu_plan(a, b, fields, fields[3] == 1 and (
        fields[0] == "stream" or fields[2] < 128))
    monkeypatch.setattr(conv_pe, "plan", lambda *args, _p=p: _p)
    got = conv_pe.matmul_int8_fused(a, b, asc, wsc, bias, "gelu", out_scale)
    _check(got, conv_pe.matmul_int8_fused_plain(a, b, asc, wsc, bias,
                                                "gelu", out_scale))
    # the same plan with relu6: the epilogue fused where the plan says so
    got = conv_pe.matmul_int8_fused(a, b, asc, wsc, bias, "relu6", out_scale)
    _check(got, conv_pe.matmul_int8_fused_plain(a, b, asc, wsc, bias,
                                                "relu6", out_scale))


@pytest.mark.parametrize("m,k,n", GELU_SERVED)
def test_conv_pe_gelu_served_shapes(dev, m, k, n):
    """recurrentgemma's gelu projections on their planned routes, f32 out
    (the eager path's), bit for bit the plain version."""
    rng = np.random.default_rng(m * n)
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    asc, wsc = _f(rng, (m, 1), dev), _f(rng, (1, n), dev, 0.0005, 0.002)
    _check(conv_pe.matmul_int8_fused(a, b, asc, wsc, None, "gelu"),
           conv_pe.matmul_int8_fused_plain(a, b, asc, wsc, None, "gelu"))


def test_conv_pe_gelu_residual_add_act(dev):
    """gelu as the residual tail's add_act (the same act4), int8 residual
    with mid_scale, int8 out."""
    rng = np.random.default_rng(9)
    m, k, n = 49, 96, 24
    a, b = _q(rng, (m, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    kw = dict(out_scale=0.091, residual=_q(rng, (m, n), dev),
              res_scale=0.047, mid_scale=0.083, add_act="gelu")
    _check(conv_pe.matmul_int8_fused(a, b, 0.021, wsc, bias, "gelu", **kw),
           conv_pe.matmul_int8_fused_plain(a, b, 0.021, wsc, bias, "gelu",
                                           **kw))


def test_conv_pe_gelu_sweep(dev, monkeypatch):
    """A zero-A GEMM whose bias holds 2^16 values over [-12, 12], +-0,
    denormals, the least normal and +-1e30: the epilogue computes
    gelu(bias) after each route's product, bit for bit (the int32
    patterns, so a -0 against a +0 would count) with the plain version."""
    vals = torch.cat([torch.linspace(-12.0, 12.0, 1 << 16, device=dev),
                      torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40,
                                    1.1754944e-38, -1.1754944e-38, 1e-20,
                                    -1e-20, 1e30, -1e30], device=dev)])
    n, k = vals.numel(), 256
    b = torch.zeros((k, n), dtype=torch.int8, device=dev)
    wsc = torch.full((1, n), 0.01, device=dev)
    for fields, m in ((("stream", 4, 128, 1, 256), 4),
                      (("stream", 4, 128, 2, 128), 4),
                      (("mma", 128, 32, 1, 256), 8),
                      (("mma", 128, 128, 1, 256), 8),
                      (("mma", 128, 128, 2, 128), 8)):
        a = torch.zeros((m, k), dtype=torch.int8, device=dev)
        asc = torch.full((m, 1), 0.02, device=dev)
        p = _gelu_plan(a, b, fields, fields[3] == 1 and (
            fields[0] == "stream" or fields[2] < 128))
        monkeypatch.setattr(conv_pe, "plan", lambda *args, _p=p: _p)
        got = conv_pe.matmul_int8_fused(a, b, asc, wsc, vals, "gelu")
        want = conv_pe.matmul_int8_fused_plain(a, b, asc, wsc, vals, "gelu")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            fields


def test_conv_pe_gelu_refuses_a_fused_plan(dev):
    """The kernel applies gelu in the epilogue pass alone and refuses a
    plan that fuses the epilogue with gelu as act or add_act."""
    rng = np.random.default_rng(4)
    a, b = _q(rng, (4, 256), dev), _q(rng, (256, 64), dev)
    wsc = _f(rng, (1, 64), dev)
    out = torch.empty((4, 64), device=dev)
    for act, add_act in ((3, 0), (0, 3)):
        err = conv_pe._lib().conv_pe_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), 4, 64, 256, 1, 128,
            64, 1, 256, 16, 16, 1, None, None, 0.02, wsc.data_ptr(), None,
            act, 0, None, 1.0, None, 0, 1.0, 0, 1.0, add_act,
            _build.stream_ptr(a))
        assert err != 0


def test_gelu_refused_off_the_int8_gemm(dev):
    """Only the int8 Conv PE's GEMM takes gelu; the pooled head, the int4
    GEMM and the other epilogues refuse it."""
    rng = np.random.default_rng(2)
    a, b = _q(rng, (4, 64), dev), _q(rng, (64, 32), dev)
    wsc = _f(rng, (1, 32), dev)
    with pytest.raises(ValueError, match="gelu"):
        conv_pe.matmul_int8_pool(a.reshape(1, 4, 64), b, 0.02, wsc, None,
                                 "gelu", mid_scale=0.05, out_scale=0.1)
    q4 = pack_int4(torch.from_numpy(rng.normal(size=(64, 32)).astype(
        np.float32)).to(dev), 32)
    with pytest.raises(ValueError, match="gelu"):
        conv_pe.matmul_int4_fused(a, q4.packed, 0.02, q4.scale, q4.zero,
                                  None, "gelu")


# (B, Hq, Hkv, L, S, D, softcap, causal, dtype): L and S off the 64-key
# tiles and the 128-key chunk, one chunk and several, GQA and not; every
# block the planner picks (32, 16 and 8 rows) at every head dim in f32 and
# bf16; the served prefills of qwen2 and gemma2 and both 2048-token shapes
FLASH_SHAPES = [
    (2, 4, 2, 37, 100, 32, 0.0, True, torch.float32),
    (1, 8, 4, 130, 130, 256, 50.0, True, torch.float32),
    (1, 6, 2, 17, 1500, 128, 20.0, False, torch.bfloat16),
    (3, 2, 1, 1, 1, 128, 0.0, True, torch.float32),
    (1, 2, 2, 1100, 1100, 128, 50.0, True, torch.bfloat16),
    (2, 4, 2, 48, 48, 32, 30.0, True, torch.bfloat16),
    (4, 12, 2, 64, 64, 128, 0.0, True, torch.float32),
    (4, 8, 4, 64, 64, 256, 50.0, True, torch.float32),
    (4, 8, 4, 64, 64, 256, 50.0, True, torch.bfloat16),
    (1, 8, 4, 100, 100, 256, 50.0, True, torch.bfloat16),
    (2, 12, 2, 96, 96, 128, 0.0, True, torch.bfloat16),
    (1, 8, 4, 2048, 2048, 256, 50.0, True, torch.float32),
    (1, 12, 2, 2048, 2048, 128, 0.0, True, torch.bfloat16),
    (1, 8, 4, 300, 300, 256, 0.0, False, torch.bfloat16),
    (2, 8, 4, 150, 150, 256, 50.0, True, torch.float32),
    (1, 12, 2, 400, 400, 128, 0.0, True, torch.float32),
    (1, 8, 4, 1100, 1100, 256, 50.0, True, torch.bfloat16),
    (1, 4, 2, 560, 560, 32, 0.0, True, torch.float32),
    (1, 4, 2, 560, 700, 32, 30.0, True, torch.bfloat16),
    (2, 4, 2, 600, 600, 32, 30.0, True, torch.float32),
    (2, 4, 2, 600, 900, 32, 0.0, False, torch.bfloat16),
]


def _flash_inputs(dev, b, hq, hkv, l, s, d, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(l + s + d)
    q, k, v = (torch.randn(shape, generator=g, device=dev) * sc
               for shape, sc in (((b, hq, l, d), 3.0), ((b, hkv, s, d), 3.0),
                                 ((b, hkv, s, d), 1.0)))
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("b,hq,hkv,l,s,d,cap,causal,dtype", FLASH_SHAPES)
def test_flash_attention(dev, b, hq, hkv, l, s, d, cap, causal, dtype):
    """The kernel against its plain version (one softmax over all keys)
    within 1e-5 of max|plain|: f32 sums in another order."""
    q, k, v = _flash_inputs(dev, b, hq, hkv, l, s, d, dtype)
    before = _build.COUNTS.get("flash_attention", 0)
    got = flash_attn.flash_attention(q, k, v, causal=causal, softcap=cap)
    assert _build.COUNTS["flash_attention"] == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_flash_shapes_reach_every_block():
    """FLASH_SHAPES launch every block the planner can pick, at every head
    dim that takes it, in both dtypes (CPU-side: the planner alone)."""
    seen = {(flash_attn.plan(b, hq, hkv, l, s, d)[:2], d, dt)
            for b, hq, hkv, l, s, d, _, _, dt in FLASH_SHAPES}
    for rows, threads in flash_attn.FLASH_BLOCKS:
        for d in flash_attn.HEAD_DIMS:
            if flash_attn._block_ok(d, rows, threads):
                for dt in (torch.float32, torch.bfloat16):
                    assert ((rows, threads), d, dt) in seen, (rows, d, dt)


@pytest.mark.parametrize("b,hq,hkv,l,d,cap", [
    (4, 12, 2, 64, 128, 0.0),                   # qwen2's served prefill
    (4, 8, 4, 64, 256, 50.0),                   # gemma2's
    (1, 8, 4, 2048, 256, 50.0)])                # two chunks of 1024 keys
def test_flash_attention_bitwise_with_blocked_prefill(dev, b, hq, hkv, l, d,
                                                      cap):
    """The kernel keeps the op order of the ref backend's chunked prefill
    attention (models/layers.flash_attention), fed as chip_smoke feeds it:
    the same bits."""
    from repro_torch.models import layers as L
    q, k, v = _flash_inputs(dev, b, hq, hkv, l, l, d)
    got = flash_attn.flash_attention(q, k, v, causal=True, softcap=cap)
    blocked = L.flash_attention(
        q.reshape(b, hkv, hq // hkv, l, d).permute(0, 3, 1, 2, 4),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=True,
        logit_softcap=cap)
    _check(got, blocked.permute(0, 2, 3, 1, 4).reshape(b, hq, l, d))


def test_flash_mha_rejects_unsupported(dev):
    """ops.flash_mha on the CUDA backend launches the kernel or raises: no
    fallback to the plain version for an operand the kernel does not
    take."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import ops
    eng = EngineConfig(quant="w4a8", backend="cuda")

    def qkv(hq=4, hkv=2, l=8, s=8, d=32, dtype=torch.float32, kdtype=None):
        return (torch.zeros(1, hq, l, d, dtype=dtype, device=dev),
                torch.zeros(1, hkv, s, d, dtype=kdtype or dtype, device=dev),
                torch.zeros(1, hkv, s, d, dtype=kdtype or dtype, device=dev))
    before = dict(_build.COUNTS)
    for kw in (dict(d=48), dict(d=64), dict(dtype=torch.float16), dict(hq=3),
               dict(l=9, s=8), dict(kdtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            ops.flash_mha(*qkv(**kw), causal=True, cfg=eng)
    assert _build.COUNTS == before
    out = ops.flash_mha(*qkv(l=9, s=8), causal=False, cfg=eng)
    assert out.shape == (1, 4, 9, 32) and bool(torch.isfinite(out).all())


def _f_close(got, want):
    """The float GEMM against its plain version: within 1e-5 of max|plain|
    (f32 sums in another order), and at bf16 output also within one bf16
    ulp of each element (the same f32 sum may round the other way)."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.double(), want.double()
    tol = 1e-5 * w.abs().max()
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(w.abs())
        tol = tol + torch.ldexp(torch.ones_like(w), e - 8)
    assert bool(((g - w).abs() <= tol).all()), (g - w).abs().max()


@pytest.mark.parametrize("act", sorted(_build.F_ACT_CODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (130, 8960, 67)])
def test_conv_pe_f(dev, m, k, n, dtype, act):
    """The FFMA route: f32 operands, and bf16 rows off 16 bytes."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        dev, dtype)
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) /
                         np.sqrt(k)).to(dev, dtype)
    bias = _f(rng, (n,), dev, -1.0, 1.0)
    assert conv_pe.plan_f(m, n, k, dtype == torch.bfloat16, False, True,
                          True).route == "ffma"
    before = _build.COUNTS.get("conv_pe_f", 0)
    got = conv_pe.matmul_f_fused(a, b, bias, act, dtype)
    assert _build.COUNTS["conv_pe_f"] == before + 1
    _f_close(got, conv_pe.matmul_f_fused_plain(a, b, bias, act, dtype))
    _f_close(conv_pe.matmul_f_fused(a, b, None, act, torch.float32),
             conv_pe.matmul_f_fused_plain(a, b, None, act, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_conv_pe_f_grads(dev, dtype, act):
    """MatmulF's gradients on the card against autograd through the plain
    version, and its launches: one forward, a recompute when act !=
    "none", and two products in the backward."""
    rng = np.random.default_rng(5)
    m, k, n = 70, 200, 90
    a, b, dy = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dev, dtype) for s in ((m, k), (k, n), (m, n)))
    bias = _f(rng, (n,), dev, -1.0, 1.0)
    out, launches = [], []
    for fn in (conv_pe.matmul_f_fused, conv_pe.matmul_f_fused_plain):
        ts = [t.clone().requires_grad_(True) for t in (a, b, bias)]
        before = _build.COUNTS.get("conv_pe_f", 0)
        y = fn(*ts, act, dtype)
        y.backward(dy)
        out.append((y, *(t.grad for t in ts)))
        launches.append(_build.COUNTS.get("conv_pe_f", 0) - before)
    assert launches == [3 if act == "none" else 4, 0]
    _f_close(out[0][0], out[1][0])
    # the Function rounds dz to the operands' type before its products
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for g, w in zip(out[0][1:], out[1][1:]):
        assert g.dtype == w.dtype
        assert (g.double() - w.double()).abs().max() <= tol * w.double(
        ).abs().max()


def test_conv_pe_f_rejects_unsupported(dev):
    before = dict(_build.COUNTS)
    a = torch.ones(4, 8, device=dev)
    for bad in (dict(a=a.half(), b=torch.ones(8, 4, device=dev).half()),
                dict(a=a, b=torch.ones(8, 8, device=dev)[:, ::2]),
                dict(a=a.bfloat16(),
                     b=torch.ones(8, 8, device=dev).bfloat16()[:, ::2]),
                dict(a=a, b=torch.ones(8, 4, device=dev), act="tanh")):
        with pytest.raises(ValueError):
            conv_pe.matmul_f_fused(**bad)
    assert _build.COUNTS == before


def _bf16_operands(rng, dev, m, k, n, a_t, b_t):
    """bf16 a [M, K] (the transposed view of a stored [K, M] when a_t) and
    b [K, N] (the transposed view of a stored [N, K] when b_t)."""
    a = torch.from_numpy(rng.normal(size=(k, m) if a_t else (m, k)).astype(
        np.float32)).to(dev, torch.bfloat16)
    b = torch.from_numpy((rng.normal(size=(n, k) if b_t else (k, n)) /
                          np.sqrt(k)).astype(np.float32)).to(dev,
                                                            torch.bfloat16)
    return (a.t() if a_t else a), (b.t() if b_t else b)


# forced K splits of the tensor-core tiles, and the act: relu2 runs in the
# tiles' epilogue, gelu in the reduction pass; K = 328 is six 64-deep
# steps, the last short
TC_PLANS = [(1, "relu2"), (1, "gelu"), (2, "relu2"), (3, "gelu")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits,act", TC_PLANS)
@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True),
                                     (True, False), (True, True)])
def test_conv_pe_f_tc_layouts(dev, monkeypatch, a_t, b_t, splits, act,
                              dtype):
    """The tensor-core route at every operand layout (the forward's a x b,
    the backward's dz x b^T and a^T x dz, and a^T x b^T), split and not,
    the act in the tiles or in the pass, at ragged M / N / K (M = 456: 4
    row tiles, the last ragged, so both consumer warpgroups take two units
    in turn; N = 264: three column tiles, the last ragged), with bias: one
    launch a product, within the float bar of the plain version."""
    m, k, n = 456, 328, 264
    rng = np.random.default_rng(splits + 2 * a_t + b_t)
    a, b = _bf16_operands(rng, dev, m, k, n, a_t, b_t)
    assert a.is_contiguous() != a_t and b.is_contiguous() != b_t
    bias = _f(rng, (n,), dev, -1.0, 1.0)
    kps = -(-6 // splits)
    plan = conv_pe.PlanF("wgmma", splits, kps, a_t, not b_t,
                         splits > 1 or act not in conv_pe.TC_TILE_ACTS)
    assert plan.route == conv_pe.plan_f(m, n, k, True, a_t, not b_t,
                                        True).route
    monkeypatch.setattr(conv_pe, "plan_f", lambda *args: plan)
    before = _build.COUNTS.get("conv_pe_f", 0)
    got = conv_pe.matmul_f_fused(a, b, bias, act, dtype)
    assert _build.COUNTS["conv_pe_f"] == before + 1
    _f_close(got, conv_pe.matmul_f_fused_plain(a, b, bias, act, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_pe_f_views(dev, dtype):
    """The FFMA route on two transposed views (a^T x b^T; f32, and bf16
    whose rows TMA cannot describe): both are copied row-major, and each
    copy is still held when the kernel reads it (a copy freed first could
    hand its block to the other's)."""
    m, k, n = 37, 53, 29
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(k, m)).astype(np.float32)).to(
        dev, dtype).t()
    b = torch.from_numpy((rng.normal(size=(n, k)) / np.sqrt(k)).astype(
        np.float32)).to(dev, dtype).t()
    bias = _f(rng, (n,), dev, -1.0, 1.0)
    assert conv_pe.plan_of(a, b).route == "ffma"
    for act in ("none", "silu"):
        got = conv_pe.matmul_f_fused(a, b, bias, act, dtype)
        _f_close(got, conv_pe.matmul_f_fused_plain(a, b, bias, act, dtype))


# a process whose autograd device thread first meets CUDA in MatmulF's
# tensor-core recompute
FRESH_BACKWARD = """
import torch
from repro_torch.kernels import conv_pe
g = torch.Generator(device="cuda").manual_seed(0)
a, b = (torch.randn(s, device="cuda", generator=g).bfloat16()
        .requires_grad_(True) for s in ((128, 256), (256, 128)))
y = conv_pe.matmul_f_fused(a, b, None, "silu", torch.bfloat16)
y.backward(torch.ones_like(y))
assert bool(torch.isfinite(a.grad).all() & torch.isfinite(b.grad).all())
"""


def test_conv_pe_f_tc_backward_on_a_fresh_autograd_thread(dev):
    """autograd runs a backward on a thread of its own, where no CUDA call
    may have bound the device's context yet: the tensor-core products there
    encode their tensor maps all the same (in a fresh process, so that
    thread's first CUDA work is the recompute)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", FRESH_BACKWARD], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


def test_conv_pe_f_tc_refuses_plan_without_pass(dev, monkeypatch):
    """A tensor-core plan whose split K or act needs the reduction pass but
    that has none, or whose N is off 8, is refused at launch, not run."""
    rng = np.random.default_rng(12)
    a, b = _bf16_operands(rng, dev, 128, 256, 128, False, False)
    before = dict(_build.COUNTS)
    for plan, act in ((conv_pe.PlanF("wgmma", 2, 2, False, True, False),
                       "none"),
                      (conv_pe.PlanF("wgmma", 1, 4, False, True, False),
                       "silu"),
                      (conv_pe.PlanF("wgmma", 1, 4, False, False, True),
                       "none")):
        monkeypatch.setattr(conv_pe, "plan_f", lambda *args, _p=plan: _p)
        # the last: b^T of a stored [124, 256], rows TMA can read, N off 8
        with pytest.raises(RuntimeError):
            conv_pe.matmul_f_fused(a, b if plan.b_mn
                                   else b.t()[:124].contiguous().t(),
                                   None, act, torch.bfloat16)
    assert _build.COUNTS == before


@pytest.mark.parametrize("act", sorted(_build.F_ACT_CODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(130, 8960, 72), (1000, 512, 1496)])
def test_conv_pe_f_tc_acts(dev, m, k, n, dtype, act):
    """The planned tensor-core route (the first shape split along K, the
    second unsplit) with every act, with and without bias, at both output
    types; K = 8960 is the step's long K."""
    p = conv_pe.plan_f(m, n, k, True, False, True, True, act)
    assert p.route == "wgmma" and (p.splits > 1) == (k == 8960)
    assert p.pass_ == (p.splits > 1 or act not in conv_pe.TC_TILE_ACTS)
    rng = np.random.default_rng(m + k + n)
    a, b = _bf16_operands(rng, dev, m, k, n, False, False)
    bias = _f(rng, (n,), dev, -1.0, 1.0)
    for bv in (bias, None):
        got = conv_pe.matmul_f_fused(a, b, bv, act, dtype)
        _f_close(got, conv_pe.matmul_f_fused_plain(a, b, bv, act, dtype))


def test_conv_pe_f_tc_split_deterministic(dev):
    """A split product (f32 partials per K slice, added in slice order by
    the reduction) gives the same bits on every call."""
    m, k, n = 1024, 8960, 256
    assert conv_pe.plan_f(m, n, k, True, False, True, True).splits > 1
    rng = np.random.default_rng(9)
    a, b = _bf16_operands(rng, dev, m, k, n, False, False)
    first = conv_pe.matmul_f_fused(a, b, None, "none", torch.float32)
    for _ in range(3):
        assert torch.equal(conv_pe.matmul_f_fused(a, b, None, "none",
                                                  torch.float32), first)


def test_conv_pe_f_tc_grads_views(dev, monkeypatch):
    """MatmulF on aligned bf16 operands: every product takes the tensor-core
    route, the backward hands the wrapper b^T and a^T as views of the saved
    operands (no transposed copy), and the gradients agree with autograd
    through the plain version as test_conv_pe_f_grads bounds them."""
    rng = np.random.default_rng(6)
    m, k, n = 72, 200, 88
    a, b, dy = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dev, torch.bfloat16) for s in ((m, k), (k, n), (m, n)))
    bias = _f(rng, (n,), dev, -1.0, 1.0)
    seen, orig = [], conv_pe._gemm_f

    def rec(x, y, *rest):
        seen.append((x, y))
        return orig(x, y, *rest)
    monkeypatch.setattr(conv_pe, "_gemm_f", rec)
    ts = [t.clone().requires_grad_(True) for t in (a, b, bias)]
    before = _build.COUNTS.get("conv_pe_f", 0)
    y = conv_pe.matmul_f_fused(*ts, "silu", torch.bfloat16)
    y.backward(dy)
    assert _build.COUNTS["conv_pe_f"] - before == 4
    (fa, fb), _, (da_x, da_w), (db_a, db_dz) = seen
    assert da_w.data_ptr() == fb.data_ptr() and not da_w.is_contiguous()
    assert db_a.data_ptr() == fa.data_ptr() and not db_a.is_contiguous()
    for x, w in seen:
        assert conv_pe.plan_of(x, w).route == "wgmma"
    want = [t.clone().requires_grad_(True) for t in (a, b, bias)]
    conv_pe.matmul_f_fused_plain(*want, "silu", torch.bfloat16).backward(dy)
    for g, w in zip((t.grad for t in ts), (t.grad for t in want)):
        assert (g.double() - w.double()).abs().max() <= 2 ** -7 * w.double(
        ).abs().max()
