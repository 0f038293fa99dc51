"""The ResNet50 slice of the port against the JAX reference, on the CPU.

The model is a reduced ResNet50: 32 px, the 7x7/2 stem with its 3x3/2 max
pool, one bottleneck at 64 channels (stride 1, projection shortcut) and one
at 128 (stride 2).  It keeps every op kind of the full program: the
Low-Channel stem with its fused max tail, plain and residual-fused Conv PE
GEMMs, the residual GAP-pooled GEMM (`add+relu|global`) and the head; the
unfused program runs its residual adds on the MISC core (`misc_add`).

The JAX side runs once per module (calibration, then both static programs
EAGERLY, observing every edge; under jit XLA contracts the head epilogue
into an FMA).  Then:

  * every int8 edge and the logits of the fused and the fuse=False programs
    equal the reference's bit for bit, on backend="ref" and on the CUDA
    backend's dispatch with CPU tensors (each wrapper's plain version);
  * the plain versions of this slice's kernels -- misc_add, avgpool2d, the
    Low-Channel max tail and the residual pooled GEMM -- equal the
    reference's `ref.py` / `_epilogue` bit for bit, and its Pallas kernels
    in interpret mode bit for bit, with two stated exceptions.  The
    Low-Channel stem is within one int8 code: the Pallas kernel folds
    a_scale into w_scale before the multiply while ref.py (and the port)
    multiply in sequence.  The f32 MISC outputs differ from the Pallas
    kernels exactly by the rewrites XLA makes under jit (an FMA in the add,
    a reciprocal multiply in the average), which each test spells out.

The reference runs on the port's calibration scales and int8 weights, so
both sides see the same program constants (the MobileNetV2 slice's tests
hold calibration to rtol 1e-6 and quantization bitwise); this keeps the
file's JAX side to the two eager program runs.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro import compiler as jc
from repro.compiler import executor as jex
from repro.compiler.graph import Epilogue as JEpilogue
from repro.configs.cnn_zoo import CNN_ZOO as J_ZOO
from repro.core.config import ConvSpec as JSpec
from repro.core.config import EngineConfig as JEng
from repro.core.quant import QTensor as JQ
from repro.kernels import misc_pe as j_misc
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import cnn as j_cnn

from repro_torch import bridge
from repro_torch import compiler as tc
from repro_torch.compiler import executor as tex
from repro_torch.compiler.graph import Epilogue as TEpilogue
from repro_torch.configs.cnn_zoo import CNN_ZOO as T_ZOO
from repro_torch.core.config import ConvSpec as TSpec
from repro_torch.core import engine as t_eng
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.core.quant import QTensor as TQ
from repro_torch.kernels import conv_pe, low_channel, misc_pe
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import ops as t_ops

from test_torch_cnn_slice import _edges, _nodes, _numpy_params

J_REF = JEng(quant="w8a8", backend="ref")
J_PALLAS = JEng(quant="w8a8", backend="pallas", interpret=True)
T_REF = TEng(quant="w8a8", backend="ref")
T_CUDA = TEng(quant="w8a8", backend="cuda")     # plain versions on CPU


def _reduced(zoo, spec):
    return dataclasses.replace(
        zoo["resnet50"], input_hw=32,
        stages=(spec("pool", kernel=3, stride=2),
                spec("bottleneck", out_ch=64, kernel=3, stride=1, repeat=1),
                spec("bottleneck", out_ch=128, kernel=3, stride=2,
                     repeat=1)))


J_CFG, T_CFG = _reduced(J_ZOO, JSpec), _reduced(T_ZOO, TSpec)


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _sc(rng, shape, lo=0.005, hi=0.05):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _to_jax(tree):
    """A port parameter tree as the reference's (QTensor leaves kept)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, TQ):
        return JQ(jnp.asarray(tree.q.numpy()), jnp.asarray(tree.scale.numpy()))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def ref():
    """Weights (carried in with bridge.params_from_numpy, the projection
    shortcuts included), a batch, the port's calibration scales and int8
    weights (tests/test_torch_cnn_slice.py holds both to the reference's),
    and for fuse in (True, False) the reference's program run eagerly on
    exactly those, every edge observed."""
    rng = np.random.default_rng(0)
    params = bridge.params_from_numpy(
        _numpy_params(j_cnn.cnn_schema(J_CFG), rng), "cpu")
    x = (rng.normal(size=(2, 32, 32, 3)) * 0.5).astype(np.float32)
    scales = tc.calibrate(tc.build_graph(T_CFG), params,
                          [torch.from_numpy(x)], T_CFG)
    qp = t_eng.quantize_params(params, t_eng.paper_engine(backend="ref"))
    jqp = _to_jax(qp)
    out = dict(qparams=qp, x=x, scales=scales)
    for fuse in (True, False):
        prog = jc.compile_cnn(J_CFG, scales=scales, fuse=fuse)
        edges, logits = _edges(
            jex._run_scheduled, prog,
            jex._static_eval(prog, jqp, jnp.asarray(x), J_REF))
        out[fuse] = dict(prog=prog, edges=edges, logits=logits)
    return out


# ---------------------------------------------------------------------------
# The fused and unfused static programs, bit for bit
# ---------------------------------------------------------------------------

def test_programs_match_and_keep_every_op_kind(ref):
    """The port's fused and fuse=False programs equal the reference's node
    for node, plan for plan.  Fused: the stem's max tail, add+relu and
    add+relu|global in 9 launches; unfused: 13 launches, 2 of them MISC
    adds."""
    progs = {fuse: tc.compile_cnn(T_CFG, scales=ref["scales"], fuse=fuse)
             for fuse in (True, False)}
    for fuse, prog in progs.items():
        jprog = ref[fuse]["prog"]
        assert _nodes(prog.graph) == _nodes(jprog.graph)
        assert prog.plan.out_scale == jprog.plan.out_scale
        assert prog.plan.emit_int8 == jprog.plan.emit_int8
    fg, ug = progs[True].graph, progs[False].graph
    assert {n.epilogue.stages for n in fg.nodes
            if getattr(n, "epilogue", None) is not None} == {
        "max", "add+relu", "add+relu|global"}
    assert sum(isinstance(n, tc.AddOp) for n in ug.nodes) == 2
    assert (tc.launch_count(fg), tc.launch_count(ug)) == (9, 13)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_static_edges_and_logits_bitwise(ref, fuse, backend):
    """Every int8 edge and the f32 logits equal the reference's eager run.
    backend="cuda" runs each kernel wrapper's plain version through the
    CUDA backend's dispatch, with the im2col weight layout folded as the
    serving engine binds it."""
    prog = tc.compile_cnn(T_CFG, scales=ref["scales"], fuse=fuse)
    qp = ref["qparams"]
    if backend == "cuda":
        qp = tc.fold_weight_layouts(prog.graph, qp)
    eng = TEng(quant="w8a8", backend=backend)
    edges, logits = _edges(tex._run_scheduled, prog,
                           tex._static_eval(prog, qp,
                                            torch.from_numpy(ref["x"]), eng))
    want = ref[fuse]
    assert set(edges) == set(want["edges"])
    for nid, w in want["edges"].items():
        assert edges[nid].dtype == w.dtype, nid
        np.testing.assert_array_equal(edges[nid], w, err_msg=f"edge {nid}")
    np.testing.assert_array_equal(logits, want["logits"])
    # the reference's own fused-vs-unfused identity
    np.testing.assert_array_equal(logits, ref[True]["logits"])


# ---------------------------------------------------------------------------
# Plain versions of this slice's kernels against ref.py / _epilogue / Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static", [True, False], ids=["int8", "f32"])
def test_misc_add_plain_matches_ref_and_pallas(static):
    """Bitwise: static int8 operands with requant (the fixture's first
    residual add, whose compiled ops the eager reference reuses), and the
    dynamic f32 add."""
    rng = np.random.default_rng(5)
    shape = (2, 7, 7, 64)
    if static:
        a, b, os = _q(rng, shape), _q(rng, shape), 0.0437
    else:
        a = rng.normal(size=shape).astype(np.float32)
        b = rng.normal(size=shape).astype(np.float32)
        os = None
    sa, sb = 0.0311, 0.0529
    want = j_ref.misc_add(jnp.asarray(a), jnp.asarray(b), sa, sb, "relu",
                          out_scale=os)
    pallas = j_misc.misc_add(jnp.asarray(a), jnp.asarray(b), sa, sb, "relu",
                             out_scale=os, interpret=True)
    got = misc_pe.misc_add_plain(_t(a), _t(b), sa, sb, "relu", out_scale=os)
    _assert_equal(got, want)
    if static:
        _assert_equal(got, pallas)
    else:
        # Pallas interpret runs the kernel under jit, where XLA contracts
        # a*sa + b*sb into fma(a, sa, b*sb): exactly that, and no other
        # difference (a*sa is exact in float64)
        fma = (a.astype(np.float64) * np.float32(sa)
               + (b * np.float32(sb)).astype(np.float64)).astype(np.float32)
        _assert_equal(np.maximum(fma, np.float32(0)), pallas)
    for cfg in (T_REF, T_CUDA):
        _assert_equal(t_ops.misc_add(_t(a), _t(b), "relu", cfg, sa=sa, sb=sb,
                                     out_scale=os), want)


@pytest.mark.parametrize("hw,window,stride", [(9, 3, 2), (7, 7, 1)])
def test_avgpool2d_plain_matches_ref_and_pallas(hw, window, stride):
    """Bitwise; C = 128, the one channel count the reference's Pallas
    kernel takes (the CUDA kernel takes any)."""
    rng = np.random.default_rng(hw)
    x = rng.normal(size=(2, hw, hw, 128)).astype(np.float32)
    want = j_ref.avgpool2d(jnp.asarray(x), window, stride)
    pallas = j_misc.avgpool2d(jnp.asarray(x), window, stride, interpret=True)
    got = misc_pe.avgpool2d_plain(_t(x), window, stride)
    _assert_equal(got, want)
    # Pallas interpret runs the kernel under jit, where XLA turns the
    # divide by k*k into a multiply by its float32 reciprocal: exactly
    # that, over the same tap-order sum
    recip = np.float32(1) / np.float32(window * window)
    _assert_equal(t_ref.window_sum(_t(x), window, stride) * recip, pallas)
    for cfg in (T_REF, T_CUDA):
        _assert_equal(t_ops.avgpool2d(_t(x), window, stride, cfg), want)


def test_low_channel_max_tail_matches_ref_and_pallas():
    """ResNet's stem at the fixture's shapes (the eager reference reuses
    its compiled ops): SAME 7x7/2, 3 -> 64, then the 3x3/2 max tail,
    static chain.  Bitwise to the reference's ref backend (ref.py +
    _epilogue), within one int8 code of its Pallas kernel (scale folding,
    see the module note)."""
    rng = np.random.default_rng(7)
    xq = _q(rng, (2, 32, 32, 3))
    w = _q(rng, (7, 7, 3, 64))
    wsc = _sc(rng, (1, 1, 1, 64), 0.0005, 0.002)
    bias = rng.normal(size=64).astype(np.float32)
    mid = 0.071
    args_j = (JQ(jnp.asarray(xq), 0.013), JQ(jnp.asarray(w), jnp.asarray(wsc)),
              jnp.asarray(bias), 2, "SAME", "relu")
    ep_j = JEpilogue(pool="max", pool_kernel=3, pool_stride=2, mid_scale=mid)
    want = j_ops.first_layer_conv(*args_j, J_REF, out_scale=mid,
                                  epilogue=ep_j)
    pallas = j_ops.first_layer_conv(*args_j, J_PALLAS, out_scale=mid,
                                    epilogue=ep_j)
    xp = np.pad(xq, ((0, 0), (2, 3), (2, 3), (0, 0)))     # SAME: 32 -> 16
    got = low_channel.low_channel_conv_plain(
        _t(xp), _t(w), _t(bias), 2, "relu", a_scale=0.013,
        w_scale=_t(wsc.reshape(64)), pool="max", pool_kernel=3,
        pool_stride=2, mid_scale=mid)
    _assert_equal(got, want)
    diff = np.abs(np.asarray(pallas, np.int32) - got.numpy().astype(np.int32))
    assert diff.max() <= 1, diff.max()
    ep_t = TEpilogue(pool="max", pool_kernel=3, pool_stride=2, mid_scale=mid)
    for cfg in (T_REF, T_CUDA):
        _assert_equal(t_ops.first_layer_conv(
            TQ(_t(xq), 0.013), TQ(_t(w), _t(wsc)), _t(bias), 2, "SAME",
            "relu", cfg, out_scale=mid, epilogue=ep_t), want)


def test_residual_pooled_gemm_matches_ref_and_pallas():
    """The last bottleneck's 1x1 expand conv with add+relu|global, static,
    at the fixture's shapes (the eager reference reuses its compiled ops):
    the port's plain pooled GEMM and ops.conv2d_pe on both backends
    bitwise to the reference's ref backend (its GEMM + _epilogue chain)
    and to its Pallas pooled GEMM (has_res)."""
    rng = np.random.default_rng(11)
    g, hw, k, n = 2, 4, 32, 128
    x, w = _q(rng, (g, hw, hw, k)), _q(rng, (1, 1, k, n))
    r = _q(rng, (g, hw, hw, n))
    wsc = _sc(rng, (1, 1, 1, n))
    bias = rng.normal(size=n).astype(np.float32)
    a_sc, mid, r_sc, add_sc, os = 0.0191, 0.0713, 0.049, 0.0811, 0.0377
    ep_j = JEpilogue(add=True, add_act="relu", pool="global", mid_scale=mid,
                     add_scale=add_sc)
    args_j = (JQ(jnp.asarray(x), a_sc), JQ(jnp.asarray(w), jnp.asarray(wsc)),
              jnp.asarray(bias), 1, "SAME", "none")
    want, pallas = (j_ops.conv2d_pe(*args_j, cfg, out_scale=os,
                                    epilogue=ep_j, residual=jnp.asarray(r),
                                    res_scale=r_sc)
                    for cfg in (J_REF, J_PALLAS))
    _assert_equal(pallas, want)
    got = conv_pe.matmul_int8_pool_plain(
        _t(x.reshape(g, hw * hw, k)), _t(w.reshape(k, n)), a_sc, _t(wsc),
        _t(bias), "none", mid_scale=mid, out_scale=os,
        residual=_t(r.reshape(g, hw * hw, n)), res_scale=r_sc,
        add_act="relu", add_scale=add_sc)
    _assert_equal(got, want)
    ep_t = TEpilogue(add=True, add_act="relu", pool="global", mid_scale=mid,
                     add_scale=add_sc)
    for cfg in (T_REF, T_CUDA):
        _assert_equal(t_ops.conv2d_pe(
            TQ(_t(x), a_sc), TQ(_t(w), _t(wsc)), _t(bias), 1, "SAME", "none",
            cfg, out_scale=os, epilogue=ep_t, residual=_t(r),
            res_scale=r_sc), want)
