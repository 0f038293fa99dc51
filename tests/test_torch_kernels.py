"""The port's kernel modules against the JAX reference, on the CPU.

For the Conv PE, DWC PE, Low-Channel and pooled-GEMM modules the same
seeded numpy inputs go through:

  * the JAX `kernels/ref.py` oracle, and the port's plain version: int8
    outputs, int32 sums and f32 epilogues equal bit for bit;
  * the JAX Pallas kernel in interpret mode (as tests/test_kernels.py runs
    it): bitwise for the Conv PE; at most one int8 code for dwc2d and
    low_channel_conv, whose Pallas kernels fold a_scale into w_scale before
    the multiply while ref.py (and the port) multiply in sequence;
  * the port's `ops` with backend="cuda" on CPU tensors, where each kernel
    wrapper runs its plain version: this drives the CUDA backend's
    dispatch (im2col, reshapes, argument plumbing) without a card.

Flash attention (`ops.flash_mha`, whose plain version is `ref.attention`)
is held within 1e-5 of max|out| to the reference's Pallas kernel in
interpret mode, its `ref.attention` and its `models/layers.flash_attention`
(the compiled prefill's attention), and to the port's own
`models/layers.flash_attention`: every path sums in f32, in another order.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.compiler.graph import Epilogue as JEpilogue
from repro.core.config import EngineConfig as JEng
from repro.core.quant import QTensor as JQ
import jax

from repro.kernels import _epilogue as j_epi
from repro.kernels import flash_attn as j_flash
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import layers as JL

from repro_torch.compiler.graph import Epilogue as TEpilogue
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.core.quant import QTensor as TQ
from repro_torch.kernels import _build, conv_pe, dwc_pe, flash_attn
from repro_torch.kernels import low_channel
from repro_torch.kernels import ops as t_ops
from repro_torch.models import layers as TL

J_REF = JEng(quant="w8a8", backend="ref")
J_PALLAS = JEng(quant="w8a8", backend="pallas", interpret=True)
T_REF = TEng(quant="w8a8", backend="ref")
T_CUDA = TEng(quant="w8a8", backend="cuda")     # plain versions on CPU


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _sc(rng, shape, lo=0.005, hi=0.05):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _assert_within_one_code(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()


# ---------------------------------------------------------------------------
# Conv PE: matmul_int8_fused (_kernel / _kernel_res)
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(50, 16, 24), (64, 96, 40), (37, 144, 72), (130, 320, 67)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("os_kind", ["none", "scalar", "vector"])
@pytest.mark.parametrize("a_kind", ["static", "per_row"])
def test_matmul_fused_plain_matches_ref(m, k, n, os_kind, a_kind):
    rng = np.random.default_rng(m * 7 + k + n)
    aq, bq = _q(rng, (m, k)), _q(rng, (k, n))
    a_sc = 0.0173 if a_kind == "static" else _sc(rng, (m, 1))
    wsc, bias = _sc(rng, (1, n)), rng.normal(size=n).astype(np.float32)
    os = {"none": None, "scalar": 0.0621, "vector": _sc(rng, (1, n), 0.02,
                                                         0.2)}[os_kind]
    act = "relu6" if os_kind == "vector" else "relu"
    j_asc = (jnp.full((m, 1), a_sc, jnp.float32) if a_kind == "static"
             else jnp.asarray(a_sc))
    want = j_ref.matmul_int8_fused(
        jnp.asarray(aq), jnp.asarray(bq), j_asc, jnp.asarray(wsc),
        jnp.asarray(bias), act,
        out_scale=None if os is None else jnp.asarray(os))
    t_asc = a_sc if a_kind == "static" else _t(a_sc)
    t_os = os if not isinstance(os, np.ndarray) else _t(os)
    got = conv_pe.matmul_int8_fused_plain(_t(aq), _t(bq), t_asc, _t(wsc),
                                          _t(bias), act, out_scale=t_os)
    _assert_equal(got, want)
    # the wrapper on CPU tensors is the plain version
    _assert_equal(conv_pe.matmul_int8_fused(_t(aq), _t(bq), t_asc, _t(wsc),
                                            _t(bias), act, out_scale=t_os),
                  want)


def test_matmul_int32_accumulation_exact():
    rng = np.random.default_rng(1)
    aq, bq = _q(rng, (70, 960)), _q(rng, (960, 33))
    got = conv_pe.matmul_int8_fused_plain(_t(aq), _t(bq), 1.0,
                                          torch.ones(1, 33))
    want = aq.astype(np.int64) @ bq.astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def _residual_case(seed, m, k, n, res_f32):
    rng = np.random.default_rng(seed)
    x = _q(rng, (m, k))
    w = _q(rng, (k, n))
    wsc, bias = _sc(rng, (1, n)), rng.normal(size=n).astype(np.float32)
    r = (rng.normal(size=(m, n)).astype(np.float32) if res_f32
         else _q(rng, (m, n)))
    return x, w, wsc, bias, r


@pytest.mark.parametrize("m,k,n", [(49, 96, 24), (100, 144, 32)])
@pytest.mark.parametrize("add_act", ["none", "relu"])
def test_residual_variant_matches_ref_and_pallas(m, k, n, add_act):
    """The fused conv -> add: qdq at mid_scale, + r * res_scale, add_act,
    requant -- against the reference chain and _kernel_res."""
    x, w, wsc, bias, r = _residual_case(m + n, m, k, n, False)
    a_sc, mid, res_s, os = 0.021, 0.083, 0.047, 0.091
    j_y = j_ref.matmul_int8_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.full((m, 1), a_sc, jnp.float32),
        jnp.asarray(wsc), jnp.asarray(bias), "none")
    want = j_epi.fused_chain(j_y, mid_scale=mid, residual=jnp.asarray(r),
                             res_scale=res_s, add_act=add_act, out_scale=os)
    got = conv_pe.matmul_int8_fused_plain(
        _t(x), _t(w), a_sc, _t(wsc), _t(bias), "none", out_scale=os,
        residual=_t(r), res_scale=res_s, mid_scale=mid, add_act=add_act)
    _assert_equal(got, want)
    pallas = j_ops.linear(JQ(jnp.asarray(x), a_sc),
                          JQ(jnp.asarray(w), jnp.asarray(wsc)),
                          jnp.asarray(bias), "none", J_PALLAS, out_scale=os,
                          residual=jnp.asarray(r), res_scale=res_s,
                          mid_scale=mid, add_act=add_act)
    _assert_equal(got, pallas)


def test_residual_variant_f32_operand_dynamic_chain():
    """An f32 residual with no mid_scale (the dynamic chain) and f32 out."""
    m, k, n = 40, 48, 24
    x, w, wsc, bias, r = _residual_case(5, m, k, n, True)
    j_y = j_ref.matmul_int8_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.full((m, 1), 0.03, jnp.float32),
        jnp.asarray(wsc), jnp.asarray(bias), "relu")
    want = j_epi.fused_chain(j_y, residual=jnp.asarray(r), add_act="relu")
    got = conv_pe.matmul_int8_fused_plain(
        _t(x), _t(w), 0.03, _t(wsc), _t(bias), "relu", residual=_t(r),
        add_act="relu")
    _assert_equal(got, want)


# ---------------------------------------------------------------------------
# Conv PE: the pooled GEMM (_kernel_pool), static global-pool tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,hw,k,n", [(2, 7, 32, 40), (3, 4, 96, 130)])
@pytest.mark.parametrize("out_int8", [True, False])
def test_pooled_gemm_matches_ref_and_pallas(g, hw, k, n, out_int8):
    rng = np.random.default_rng(g * hw + n)
    x = _q(rng, (g, hw, hw, k))
    w = _q(rng, (1, 1, k, n))
    wsc, bias = _sc(rng, (1, 1, 1, n)), rng.normal(size=n).astype(np.float32)
    a_sc, mid = 0.0191, 0.0713
    os = 0.0377 if out_int8 else None
    # the reference's GEMM + fused_chain, and the port's plain pooled GEMM
    j_y = j_ref.matmul_int8_fused(
        jnp.asarray(x.reshape(-1, k)), jnp.asarray(w.reshape(k, n)),
        jnp.full((g * hw * hw, 1), a_sc, jnp.float32),
        jnp.asarray(wsc.reshape(1, n)), jnp.asarray(bias), "relu6")
    want = j_epi.fused_chain(j_y.reshape(g, hw, hw, n), mid_scale=mid,
                             pool="global", out_scale=os)
    got = conv_pe.matmul_int8_pool_plain(
        _t(x.reshape(g, hw * hw, k)), _t(w.reshape(k, n)), a_sc,
        _t(wsc), _t(bias), "relu6", mid_scale=mid, out_scale=os)
    _assert_equal(got, want)
    # through ops.conv2d_pe: reference ref / Pallas vs port ref / cuda
    ep_j = JEpilogue(pool="global", mid_scale=mid)
    ep_t = TEpilogue(pool="global", mid_scale=mid)
    args_j = (JQ(jnp.asarray(x), a_sc), JQ(jnp.asarray(w), jnp.asarray(wsc)),
              jnp.asarray(bias), 1, "SAME", "relu6")
    args_t = (TQ(_t(x), a_sc), TQ(_t(w), _t(wsc)), _t(bias), 1, "SAME",
              "relu6")
    j_ref_out = j_ops.conv2d_pe(*args_j, J_REF, out_scale=os, epilogue=ep_j)
    j_pallas = j_ops.conv2d_pe(*args_j, J_PALLAS, out_scale=os,
                               epilogue=ep_j)
    _assert_equal(j_ref_out, want)
    _assert_equal(j_pallas, want)
    for cfg in (T_REF, T_CUDA):
        _assert_equal(t_ops.conv2d_pe(*args_t, cfg, out_scale=os,
                                      epilogue=ep_t), want)


# ---------------------------------------------------------------------------
# Conv PE through ops.conv2d_pe: im2col order, SAME padding, stride
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,hw", [(1, 1, 9), (3, 1, 8), (3, 2, 9)])
def test_conv2d_pe_im2col_matches_ref(k, stride, hw):
    rng = np.random.default_rng(k * 10 + stride + hw)
    ic, oc = 12, 20
    x = _q(rng, (2, hw, hw, ic))
    w = _q(rng, (k, k, ic, oc))
    wsc, bias = _sc(rng, (1, 1, 1, oc)), rng.normal(size=oc).astype(np.float32)
    want = j_ops.conv2d_pe(JQ(jnp.asarray(x), 0.023),
                           JQ(jnp.asarray(w), jnp.asarray(wsc)),
                           jnp.asarray(bias), stride, "SAME", "relu6", J_REF,
                           out_scale=0.05)
    for cfg in (T_REF, T_CUDA):
        got = t_ops.conv2d_pe(TQ(_t(x), 0.023), TQ(_t(w), _t(wsc)),
                              _t(bias), stride, "SAME", "relu6", cfg,
                              out_scale=0.05)
        _assert_equal(got, want)
    # the folded GEMM layout [k*k*IC, OC] gives the same codes
    folded = TQ(_t(w.reshape(k * k * ic, oc)), _t(wsc.reshape(1, oc)))
    _assert_equal(t_ops.conv2d_pe(TQ(_t(x), 0.023), folded, _t(bias), stride,
                                  "SAME", "relu6", T_CUDA, out_scale=0.05),
                  want)


def test_same_pad_matches_reference():
    for size in range(1, 20):
        for k in (1, 3, 5, 7):
            for s in (1, 2):
                assert t_ops._same_pad(size, k, s) == j_ops._same_pad(
                    size, k, s)


# ---------------------------------------------------------------------------
# DWC PE
# ---------------------------------------------------------------------------

def _dwc_case(seed, n, hw, c, k):
    rng = np.random.default_rng(seed)
    x = _q(rng, (n, hw, hw, c))
    w = _q(rng, (k, k, c))
    wsc = _sc(rng, (c,), 0.002, 0.02)
    bias = rng.normal(size=c).astype(np.float32)
    return x, w, wsc, bias


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("os", [0.057, None])
def test_dwc2d_plain_matches_ref(stride, os):
    c, hw = 40, 9
    x, w, wsc, bias = _dwc_case(c + hw + stride, 2, hw, c, 3)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = j_ref.dwc2d(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(bias),
                       stride, "relu6", a_scale=0.031,
                       w_scale=jnp.asarray(wsc), out_scale=os)
    got = dwc_pe.dwc2d(_t(xp), _t(w), _t(bias), stride, "relu6",
                       a_scale=0.031, w_scale=_t(wsc), out_scale=os)
    _assert_equal(got, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_dwc2d_ops_matches_ref_and_pallas(stride):
    """ops.dwc2d with SAME padding, static int8 input: port ref / cuda
    backends bitwise to the reference's ref; the Pallas kernel (a_scale
    folded into w_scale first) within one int8 code."""
    c, hw = 40, 10
    x, w, wsc, bias = _dwc_case(11 + stride, 2, hw, c, 3)
    wq_j = JQ(jnp.asarray(w), jnp.asarray(wsc.reshape(1, 1, c)))
    args = (jnp.asarray(bias), stride, "SAME", "relu6")
    want = j_ops.dwc2d(JQ(jnp.asarray(x), 0.029), wq_j, *args, J_REF,
                       out_scale=0.061)
    pallas = j_ops.dwc2d(JQ(jnp.asarray(x), 0.029), wq_j, *args, J_PALLAS,
                         out_scale=0.061)
    wq_t = TQ(_t(w), _t(wsc.reshape(1, 1, c)))
    for cfg in (T_REF, T_CUDA):
        got = t_ops.dwc2d(TQ(_t(x), 0.029), wq_t, _t(bias), stride, "SAME",
                          "relu6", cfg, out_scale=0.061)
        _assert_equal(got, want)
        _assert_within_one_code(got, pallas)


# ---------------------------------------------------------------------------
# Low-Channel Conv Unit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,hw", [(3, 2, 16), (3, 1, 9)])
@pytest.mark.parametrize("os", [0.043, None])
def test_low_channel_plain_matches_ref(k, stride, hw, os):
    rng = np.random.default_rng(k + stride + hw)
    ic, oc = 3, 24
    x = _q(rng, (2, hw, hw, ic))
    w = _q(rng, (k, k, ic, oc))
    wsc, bias = _sc(rng, (oc,)), rng.normal(size=oc).astype(np.float32)
    want = j_ref.low_channel_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(bias), stride, "relu",
                                  a_scale=0.0117, w_scale=jnp.asarray(wsc),
                                  out_scale=os)
    got = low_channel.low_channel_conv(_t(x), _t(w), _t(bias), stride, "relu",
                                       a_scale=0.0117, w_scale=_t(wsc),
                                       out_scale=os)
    _assert_equal(got, want)


def test_first_layer_conv_matches_ref_and_pallas():
    """The stem through ops.first_layer_conv: float image quantized at its
    static scale, SAME padding, 3x3 stride 2, 3 -> 32."""
    rng = np.random.default_rng(3)
    img = (rng.normal(size=(2, 16, 16, 3)) * 0.5).astype(np.float32)
    w = _q(rng, (3, 3, 3, 32))
    wsc = _sc(rng, (1, 1, 1, 32))
    bias = rng.normal(size=32).astype(np.float32)
    x_j = JQ(jnp.clip(jnp.round(jnp.asarray(img) / 0.013), -127, 127
                      ).astype(jnp.int8), 0.013)
    wq_j = JQ(jnp.asarray(w), jnp.asarray(wsc))
    want = j_ops.first_layer_conv(x_j, wq_j, jnp.asarray(bias), 2, "SAME",
                                  "relu", J_REF, out_scale=0.071)
    pallas = j_ops.first_layer_conv(x_j, wq_j, jnp.asarray(bias), 2, "SAME",
                                    "relu", J_PALLAS, out_scale=0.071)
    x_t = TQ(_t(np.asarray(x_j.q)), 0.013)
    for cfg in (T_REF, T_CUDA):
        got = t_ops.first_layer_conv(x_t, TQ(_t(w), _t(wsc)), _t(bias), 2,
                                     "SAME", "relu", cfg, out_scale=0.071)
        _assert_equal(got, want)
        _assert_within_one_code(got, pallas)


@pytest.mark.parametrize("name", ["resnet50", "resnet152", "mobilenetv1",
                                  "mobilenetv2", "efficientnet",
                                  "squeezenet", "yolov3", "yolov5n"])
def test_low_channel_plan_fits_every_zoo_stem(name):
    """The stem kernel's plan (pure Python) at each zoo model's stem at its
    published input size: channel blocks of at most 64, blocks enough for
    the 132 SMs; ResNet50's max tail on 7 x 8 pooled tiles (255 conv
    positions, two m16 tiles a warp) and MobileNetV2's stem on 256
    positions a block."""
    from repro_torch.configs.cnn_zoo import CNN_ZOO
    cfg = CNN_ZOO[name]
    k, s, hw = cfg.stem_kernel, cfg.stem_stride, cfg.input_hw
    hp = hw + sum(t_ops._same_pad(hw, k, s))
    pool = cfg.stages[0].kind == "pool"
    pk, ps = (cfg.stages[0].kernel, cfg.stages[0].stride) if pool else (0, 0)
    p = low_channel.plan(4, hp, hp, 3, cfg.stem_ch, k, s, pk, ps)
    assert p.ocb == min(64, cfg.stem_ch)
    ho = (hp - k) // s + 1
    if pool:
        pho = (ho - pk) // ps + 1
        blocks = -(-pho // p.tile_h) * -(-pho // p.tile_w) * 4
        assert ((p.tile_h - 1) * ps + pk) * ((p.tile_w - 1) * ps + pk) \
            <= low_channel.MAX_TILE_POS
    else:
        blocks = -(-ho * ho // p.tile_w) * 4
    assert blocks >= low_channel.SMS
    if name == "resnet50":
        assert (p.tile_h, p.tile_w) == (7, 8)
    if name == "mobilenetv2":
        assert p.tile_w == 256


def test_low_channel_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):          # K = 9 x 9 x 4 > 256
        low_channel.plan(1, 32, 32, 4, 16, 9, 1)
    with pytest.raises(ValueError):          # k * IC < 3
        low_channel.plan(1, 32, 32, 1, 16, 2, 1)
    with pytest.raises(ValueError):          # a pool window past the map
        low_channel.plan(1, 9, 9, 3, 16, 3, 2, 5, 2)


# ---------------------------------------------------------------------------
# The int8 Conv PE's launch planner (pure Python; the kernels need the card)
# ---------------------------------------------------------------------------

def _cover(extent, step, count):
    """How often each of [0, extent) is covered by `count` blocks of
    `step` (the last clipped at `extent`); every block must be non-empty."""
    hits = np.zeros(extent, np.int64)
    for i in range(count):
        lo, hi = i * step, min((i + 1) * step, extent)
        assert lo < hi, f"block {i} of {count} x {step} is empty in {extent}"
        hits[lo:hi] += 1
    return hits


@pytest.mark.parametrize("m,n,k,a_align,b_align", [
    (1, 24, 16, 16, 16), (4, 288, 8192, 16, 16), (4, 16384, 4096, 16, 16),
    (4, 17920, 1536, 16, 16), (3, 4096, 8192, 4, 8), (1, 16384, 4097, 1, 1),
    (4, 1000, 1280, 16, 16), (2, 1536, 8960, 16, 16), (8, 67, 333, 1, 1),
    (16, 24, 1000, 16, 16), (17, 2048, 8960, 16, 16),
    (256, 288, 8192, 16, 16), (256, 16384, 4096, 16, 16),
    (256, 1536, 1536, 16, 16), (3136, 24, 24, 16, 16),
    (50176, 96, 16, 16, 16), (130, 67, 320, 4, 1), (256, 8192, 288, 1, 16)])
def test_conv_pe_plan_covers_product_once(m, n, k, a_align, b_align):
    """plan(M, N, K): its output tiles and K slices cover [0, M) x [0, N) x
    [0, K) exactly once, the path follows M and the weights' size, the copy
    widths divide the rows and the pointers' alignment, and each path's
    slices fit its kernel (csrc/conv_pe.cu rejects any other plan)."""
    p = conv_pe.plan(m, n, k, a_align, b_align)
    stream = m <= conv_pe.STREAM_MAX_M and k * n >= conv_pe.STREAM_MIN_KN
    assert p.path == ("stream" if stream else "mma")
    for extent, step, count in ((m, p.bm, -(-m // p.bm)),
                                (n, p.bn, -(-n // p.bn)),
                                (k, p.ks, p.splits)):
        assert (_cover(extent, step, count) == 1).all()
    tiles = -(-m // p.bm) * -(-n // p.bn)
    for w, extent, align in ((p.wa, k, a_align), (p.wb, n, b_align)):
        assert w in (1, 2, 4, 8, 16) and extent % w == 0 and align % w == 0
    if stream:
        assert m <= p.bm and (p.bm, p.bn) == (4, conv_pe.STREAM_BN)
        assert p.ks % conv_pe.STREAM_KG == 0
        assert p.ks <= conv_pe.STREAM_KS_MAX
        # K is split where the column tiles alone leave SMs idle
        assert (p.splits > 1) == (tiles < conv_pe.SMS
                                  and k > conv_pe.STREAM_KG)
    else:
        assert p.bm == conv_pe.MMA_BM and p.bn in (128, 64, 32)
        assert p.ks % conv_pe.MMA_BK == 0
        assert p.bn == 128 or n <= p.bn            # narrow N, narrow tiles
        if p.splits > 1:                           # split only to fill SMs
            assert tiles * p.splits <= conv_pe.SMS
    assert not (p.fused and p.splits > 1)          # a split needs the pass
    if (m, n, k) == (256, 288, 8192):              # x_proj at prefill
        assert tiles == 6 and p.splits > 1


def test_conv_pe_scratch_grows_per_stream():
    """The unfused plans' int32 scratch: one buffer per device and stream,
    reused while it is large enough, replaced by a larger one when not."""
    t = torch.zeros(1, dtype=torch.int8)
    conv_pe._SCRATCH.clear()
    try:
        a = conv_pe._scratch(t, 100, 7)
        assert a.dtype == torch.int32 and a.numel() == 100
        assert conv_pe._scratch(t, 60, 7) is a
        b = conv_pe._scratch(t, 300, 7)
        assert b.numel() == 300 and conv_pe._scratch(t, 100, 7) is b
        assert conv_pe._scratch(t, 100, 8) is not b
        assert len(conv_pe._SCRATCH) == 2
    finally:
        conv_pe._SCRATCH.clear()


# ---------------------------------------------------------------------------
# The int4 Conv PE's launch planner (pure Python)
# ---------------------------------------------------------------------------

# (M, N, K) of the w4a8 projections the served paths run: qwen2-1.5b's and
# gemma2-2b's QKV, gate/up, O and down, at a decode step (4 slots) and a
# prefill (4 x 64 tokens), group size 64
W4_LM = [(2048, 1536), (17920, 1536), (1536, 1536), (1536, 8960),
         (4096, 2304), (18432, 2304), (2304, 2048), (2304, 9216)]


@pytest.mark.parametrize("m", [4, 256])
@pytest.mark.parametrize("n,k", W4_LM)
def test_conv_pe_plan_w4_lm_shapes(m, n, k):
    """plan_w4 at the LM's shapes: a decode step streams the weights, a
    prefill runs 64 x 64 tensor-core tiles; the stream strips keep at least
    half the SMs busy (16 columns at N = 1536: 96 blocks of 256 threads; the
    8-column strips that cover every SM ran slower, scripts/conv_pe_probe.py
    --w4), chunks of whole groups cover K, none empty and at most W4_CHUNK
    bytes of packed weights, and a sub-task's quads divide the group's."""
    gs = 64
    p = conv_pe.plan_w4(m, n, k, gs, 16, 16)
    assert (p.wa, p.wb) == (16, 16)
    if m == 256:
        assert p.route == "mma" and (p.bm, p.bn) == (64, 64)
        assert p.gc == 0
        return
    assert p.route == "stream" and p.bm == 4 and p.bn in conv_pe.W4_BNS
    assert -(-n // p.bn) >= conv_pe.SMS // 2
    assert p.bn == 32 or -(-n // 32) < conv_pe.SMS   # the widest that fills
    g = k // gs
    assert (_cover(g, p.gc, -(-g // p.gc)) == 1).all()
    # each group's gs / 2 rows of bn bytes and 16 bytes a column thread of
    # padding
    assert p.gc * (gs // 2 * p.bn + 16 * (p.bn // 16)) <= conv_pe.W4_CHUNK
    assert p.gc <= conv_pe.W4_GC


@pytest.mark.parametrize("gs", [4, 8, 20, 48, 64, 96, 1024])
@pytest.mark.parametrize("m", [1, 37, 256])
def test_conv_pe_plan_w4_group_sizes(gs, m):
    """Every group size the wrapper takes has a plan: tensor-core tiles only
    above W4_STREAM_MAX_M rows and where the groups are multiples of 32 K
    rows (the k32 steps of a group end on its boundary), streaming
    otherwise; a sub-task's quads divide the group's."""
    k = gs * 40
    p = conv_pe.plan_w4(m, 2048, k, gs, 16, 16)
    mma = m > conv_pe.W4_STREAM_MAX_M and gs % 32 == 0
    assert p.route == ("mma" if mma else "stream")
    if not mma:
        assert 1 <= p.gc <= min(40, conv_pe.W4_GC)


def test_conv_pe_plan_w4_widths_and_refusals():
    """Copy widths follow the rows and the pointers' alignment (ragged N
    streams bytes); an empty product or a K off the groups is refused."""
    p = conv_pe.plan_w4(4, 70, 96, 32, 4, 16)
    assert (p.route, p.wa, p.wb) == ("stream", 4, 2)
    p = conv_pe.plan_w4(256, 40, 1024, 1024, 16, 8)
    assert (p.route, p.wa, p.wb) == ("mma", 16, 8)
    for args in ((0, 64, 64, 32), (4, 64, 96, 64)):
        with pytest.raises(ValueError):
            conv_pe.plan_w4(*args, 16, 16)


# ---------------------------------------------------------------------------
# The float GEMM's planner and layout classifier (pure Python)
# ---------------------------------------------------------------------------

# the K splits the card run takes at the 15 float GEMM shape groups of one
# full-width qwen2-1.5b training step (conv_pe.STEP_F_GROUPS)
F_STEP_SPLITS = {"fwd K/V": 6, "db K/V": 4}
F_GROUPS = {g[0]: g[1:] for g in conv_pe.STEP_F_GROUPS}


@pytest.mark.parametrize("group", sorted(F_GROUPS))
def test_conv_pe_plan_f_step_shapes(group):
    """plan_f at the training step's shapes: the tensor-core route, each
    operand in the layout the step hands it, the K split the card run
    takes (as many slices as the idle SMs take, none shorter than
    TC_MIN_STEPS), the K slices covering the 64-deep steps exactly once,
    and the reduction pass exactly where a split or the act needs it."""
    m, n, k, a_mn, b_mn, _, act, _, _ = F_GROUPS[group]
    p = conv_pe.plan_f(m, n, k, True, a_mn, b_mn, True, act)
    assert p.route == "wgmma" and (p.a_mn, p.b_mn) == (a_mn, b_mn)
    assert p.splits == F_STEP_SPLITS.get(group, 1)
    nk = -(-k // conv_pe.TC_BK)
    assert (_cover(nk, p.kps, p.splits) == 1).all()
    tiles = -(-m // conv_pe.TC_BM) * -(-n // conv_pe.TC_BN)
    assert tiles * p.splits <= max(tiles, conv_pe.SMS)
    assert p.splits == 1 or p.kps >= conv_pe.TC_MIN_STEPS
    assert p.pass_ == (p.splits > 1 or act == "silu")


@pytest.mark.parametrize("m,n,k,bf16,a_mn,b_mn,aligned", [
    (1024, 1536, 1536, False, False, True, True),   # f32 operands
    (37, 29, 53, True, False, True, True),          # K, N rows off 16 B
    (130, 67, 8960, True, False, True, True),       # N rows off 16 B
    (70, 88, 200, True, True, True, True),          # a^T rows (M) off 16 B
    (72, 88, 201, True, False, False, True),        # b^T rows (K) off 16 B
    (72, 84, 200, True, False, False, True),        # N off 8 (the stores)
    (1024, 1536, 1536, True, False, True, False)])  # a base off 16 B
def test_conv_pe_plan_f_ffma_route(m, n, k, bf16, a_mn, b_mn, aligned):
    """f32 products, and bf16 ones the tensor-core tiles cannot take (rows
    TMA cannot describe, N off 8), take the FFMA kernel (row-major
    operands); the same shapes aligned in bf16 take the tensor cores."""
    p = conv_pe.plan_f(m, n, k, bf16, a_mn, b_mn, aligned)
    assert p.route == "ffma" and p.splits == 1 and not p.pass_
    assert (p.a_mn, p.b_mn) == (False, True)
    if bf16 and aligned and m % 8 == 0:
        q = conv_pe.plan_f(m, -(-n // 8) * 8, -(-k // 8) * 8, True, a_mn,
                           b_mn, True)
        assert q.route == "wgmma"


def test_conv_pe_f_layout_classifier():
    """transposed(): a contiguous matrix is row-major, the transposed view
    of one is read transposed (a matrix that is both, with a dimension of
    1, counts as row-major); any other strides raise."""
    x = torch.zeros(6, 4)
    assert conv_pe.transposed(x, "x") is False
    assert conv_pe.transposed(x.t(), "x") is True
    assert conv_pe.transposed(torch.zeros(1, 5), "x") is False
    assert conv_pe.transposed(torch.zeros(5, 1).t(), "x") is False
    assert conv_pe.transposed(torch.zeros(5, 1), "x") is False
    for bad in (x[:, ::2], x[::2], x.t()[:, ::2], x.t()[::2],
                torch.zeros(4, 6, 2)[:, :, 0], torch.zeros(8, 8)[:6, :4]):
        with pytest.raises(ValueError, match="transposed view"):
            conv_pe.transposed(bad, "x")


# ---------------------------------------------------------------------------
# Launch counts: a wrapper counts only where it launches its kernel
# ---------------------------------------------------------------------------

def test_plain_versions_launch_nothing():
    _build.reset_counts()
    rng = np.random.default_rng(0)
    conv_pe.matmul_int8_fused(_t(_q(rng, (8, 8))), _t(_q(rng, (8, 8))), 1.0,
                              torch.ones(8))
    dwc_pe.dwc2d(_t(_q(rng, (1, 5, 5, 8))), _t(_q(rng, (3, 3, 8))), None, 1,
                 "none", a_scale=1.0, w_scale=torch.ones(8))
    assert _build.COUNTS == {}


def test_engine_config_backends():
    """The CUDA backend runs the int8 / int4 engines and, since the float
    GEMM kernel, the float path (quant="none"); only the backends "ref"
    and "cuda" exist.  The float path on the card is still no calibration
    engine (tests/test_torch_train_slice.py holds that)."""
    assert TEng(quant="none", backend="cuda").backend == "cuda"
    with pytest.raises(ValueError):
        TEng(quant="w8a8", backend="pallas")
    with pytest.raises(ValueError):
        TEng(quant="w4", backend="cuda")


# ---------------------------------------------------------------------------
# The dynamic int8 path (uncalibrated programs): activations quantized per
# call -- per token for the Conv PE, per tensor for the DWC PE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["conv2d_pe", "dwc2d"])
def test_dynamic_quant_path_matches_ref(op):
    rng = np.random.default_rng(17)
    x = (rng.normal(size=(2, 8, 8, 16)) * 0.7).astype(np.float32)
    if op == "conv2d_pe":
        w = _q(rng, (3, 3, 16, 24))
        wsc = _sc(rng, (1, 1, 1, 24))
        bias = rng.normal(size=24).astype(np.float32)
    else:
        w = _q(rng, (3, 3, 16))
        wsc = _sc(rng, (1, 1, 16))
        bias = rng.normal(size=16).astype(np.float32)
    want = getattr(j_ops, op)(jnp.asarray(x), JQ(jnp.asarray(w),
                                                 jnp.asarray(wsc)),
                              jnp.asarray(bias), 2, "SAME", "relu", J_REF)
    got = getattr(t_ops, op)(_t(x), TQ(_t(w), _t(wsc)), _t(bias), 2, "SAME",
                             "relu", T_REF)
    _assert_equal(got, want)


# ---------------------------------------------------------------------------
# Flash attention: ops.flash_mha (plain version ref.attention)
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, L, S, causal, softcap, Pallas bq, bkv); D = 32 throughout
FLASH_CASES = [
    (2, 4, 2, 64, 64, True, 0.0, 32, 32),      # GQA, L = S
    (1, 4, 2, 40, 96, True, 50.0, 8, 32),      # GQA, L != S, softcap
    (1, 2, 2, 24, 72, False, 50.0, 8, 24),     # non-causal, softcap
    (2, 4, 1, 32, 48, False, 0.0, 16, 16),     # non-causal, one KV head
]


@pytest.mark.parametrize("b,hq,hkv,l,s,causal,cap,bq,bkv", FLASH_CASES)
def test_flash_mha_matches_pallas_ref_and_layers(b, hq, hkv, l, s, causal,
                                                 cap, bq, bkv):
    """Seeded q / k / v scaled so that the logits reach the softcap; the
    Pallas kernel gets the repeated KV heads and block sizes that divide L
    and S (its wrapper would pad to 128, which moves the end-aligned causal
    mask); layers.flash_attention gets q_offset = S - L.  Measured here:
    at most 2.0e-6 of max|out|."""
    d = 32
    rng = np.random.default_rng(l * 7 + s)
    q = (rng.normal(size=(b, hq, l, d)) * 3).astype(np.float32)
    k = (rng.normal(size=(b, hkv, s, d)) * 3).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    got = _np(t_ops.flash_mha(_t(q), _t(k), _t(v), causal=causal,
                              softcap=cap, cfg=T_REF))
    assert got.shape == (b, hq, l, d) and got.dtype == np.float32
    np.testing.assert_array_equal(
        _np(t_ops.flash_mha(_t(q), _t(k), _t(v), causal=causal, softcap=cap,
                            cfg=T_CUDA)), got)       # CPU: the plain version
    g = hq // hkv
    rep = lambda a: jnp.asarray(np.repeat(a, g, 1).reshape(b * hq, s, d))
    pallas = np.asarray(j_flash.flash_attention(
        jnp.asarray(q.reshape(b * hq, l, d)), rep(k), rep(v), causal=causal,
        softcap=cap, bq=bq, bkv=bkv, interpret=True)).reshape(b, hq, l, d)
    oracle = np.asarray(jax.jit(
        lambda *a: j_ref.attention(*a, causal=causal, logit_softcap=cap))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    # layers.flash_attention takes q [B, L, Hkv, G, D], k / v [B, S, Hkv, D]
    qg = q.reshape(b, hkv, g, l, d).transpose(0, 3, 1, 2, 4)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    off = s - l if causal else 0
    blocked = np.asarray(jax.jit(lambda *a: JL.flash_attention(
        *a, causal=causal, logit_softcap=cap, q_offset=off))(
        jnp.asarray(qg), jnp.asarray(kt), jnp.asarray(vt)))
    ours = _np(TL.flash_attention(_t(qg), _t(kt), _t(vt), causal=causal,
                                  logit_softcap=cap, q_offset=off))
    scale = np.abs(oracle).max()
    for other in (pallas, oracle,
                  *(x.transpose(0, 2, 3, 1, 4).reshape(b, hq, l, d)
                    for x in (blocked, ours))):
        assert np.abs(got - other).max() <= 1e-5 * scale


def test_flash_mha_plain_widens_bf16():
    """bf16 operands go through the plain version widened to f32 (the
    kernel widens on load): the result is f32 and equals the f32 run."""
    _build.reset_counts()
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               .to(torch.bfloat16) for sh in ((1, 2, 5, 32), (1, 1, 9, 32),
                                              (1, 1, 9, 32)))
    got = flash_attn.flash_attention(q, k, v, causal=True, softcap=50.0)
    want = flash_attn.flash_attention_plain(q.float(), k.float(), v.float(),
                                            causal=True, softcap=50.0)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert _build.COUNTS == {}
