"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a GPU every test skips (decided in the fixture, not
at import).  On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are small and ragged (M/N/K off the tile sizes, odd channel counts,
stride 2, rows off the pooled GEMM's 64-row pass, C off 128, odd element
counts, int4 groups off the 1024-row staging chunk, pages off 16 bytes,
stem K off 32 and OC off its 64-channel block, pooled tiles off the plan's);
every output must equal the plain version bit for bit, except the flash
attention's and the float GEMM's (K = 8960 among its shapes, f32 and bf16,
every act, and its gradient), which agree with their plain versions to
f32 rounding (the float GEMM at bf16 output to one bf16 ulp).  The float
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


@pytest.mark.parametrize("g,rows,k,n", [(4, 49, 320, 1280), (3, 16, 40, 70)])
def test_conv_pe_pool(dev, g, rows, k, n):
    rng = np.random.default_rng(g * rows)
    a, b = _q(rng, (g, rows, k), dev), _q(rng, (k, n), dev)
    wsc, bias = _f(rng, (1, n), dev), _f(rng, (n,), dev, -1.0, 1.0)
    kw = dict(mid_scale=0.0713, out_scale=0.0377)
    _check(conv_pe.matmul_int8_pool(a, b, 0.0191, wsc, bias, "relu", **kw),
           conv_pe.matmul_int8_pool_plain(a, b, 0.0191, wsc, bias, "relu",
                                          **kw))


@pytest.mark.parametrize("g,rows,k,n", [(4, 49, 512, 2048), (3, 70, 40, 70)])
def test_conv_pe_pool_residual(dev, g, rows, k, n):
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


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [40, 96])
def test_dwc(dev, stride, c):
    rng = np.random.default_rng(c + stride)
    x, w = _q(rng, (2, 11, 11, c), dev), _q(rng, (3, 3, c), dev)
    wsc, bias = _f(rng, (c,), dev), _f(rng, (c,), dev, -1.0, 1.0)
    kw = dict(a_scale=0.031, w_scale=wsc, out_scale=0.057)
    _check(dwc_pe.dwc2d(x, w, bias, stride, "relu6", **kw),
           dwc_pe.dwc2d_plain(x, w, bias, stride, "relu6", **kw))


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


# (B, Hq, Hkv, L, S, D, softcap, causal, dtype): L and S off the 16-row and
# 32-key tiles and the 128-key chunk, one chunk and several, GQA and not
FLASH_SHAPES = [
    (2, 4, 2, 37, 100, 32, 0.0, True, torch.float32),
    (1, 8, 4, 130, 130, 256, 50.0, True, torch.float32),
    (1, 6, 2, 17, 1500, 128, 20.0, False, torch.bfloat16),
    (3, 2, 1, 1, 1, 128, 0.0, True, torch.float32),
    (1, 2, 2, 1100, 1100, 128, 50.0, True, torch.bfloat16),
]


@pytest.mark.parametrize("b,hq,hkv,l,s,d,cap,causal,dtype", FLASH_SHAPES)
def test_flash_attention(dev, b, hq, hkv, l, s, d, cap, causal, dtype):
    """The kernel against its plain version (one softmax over all keys)
    within 1e-5 of max|plain|: f32 sums in another order."""
    g = torch.Generator(device=dev).manual_seed(l + s + d)
    q, k, v = (torch.randn(shape, generator=g, device=dev) * sc
               for shape, sc in (((b, hq, l, d), 3.0), ((b, hkv, s, d), 3.0),
                                 ((b, hkv, s, d), 1.0)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = _build.COUNTS.get("flash_attention", 0)
    got = flash_attn.flash_attention(q, k, v, causal=causal, softcap=cap)
    assert _build.COUNTS["flash_attention"] == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


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
