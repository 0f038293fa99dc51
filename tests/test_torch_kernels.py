"""The port's kernel modules against the JAX reference, on the CPU.

For each of the four kernel modules (conv_pe, dwc_pe, low_channel and the
pooled GEMM) the same seeded numpy inputs go through:

  * the JAX `kernels/ref.py` oracle, and the port's plain version: int8
    outputs, int32 sums and f32 epilogues equal bit for bit;
  * the JAX Pallas kernel in interpret mode (as tests/test_kernels.py runs
    it): bitwise for the Conv PE; at most one int8 code for dwc2d and
    low_channel_conv, whose Pallas kernels fold a_scale into w_scale before
    the multiply while ref.py (and the port) multiply in sequence;
  * the port's `ops` with backend="cuda" on CPU tensors, where each kernel
    wrapper runs its plain version: this drives the CUDA backend's
    dispatch (im2col, reshapes, argument plumbing) without a card.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.compiler.graph import Epilogue as JEpilogue
from repro.core.config import EngineConfig as JEng
from repro.core.quant import QTensor as JQ
from repro.kernels import _epilogue as j_epi
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.compiler.graph import Epilogue as TEpilogue
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.core.quant import QTensor as TQ
from repro_torch.kernels import _build, conv_pe, dwc_pe, low_channel
from repro_torch.kernels import ops as t_ops

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


def test_cuda_backend_needs_int8_engine():
    with pytest.raises(ValueError):
        TEng(quant="none", backend="cuda")
    with pytest.raises(ValueError):
        TEng(quant="w8a8", backend="pallas")


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
