"""The LM serving slice of the port against the JAX reference, on the CPU.

The model is the reduced qwen2-1.5b (`configs.reduced`: 2 layers, d=128,
4 query heads and 1 KV head of 32, d_ff 256, vocab 512) with QKV bias,
SwiGLU and tied embeddings, on seeded numpy weights handed to both sides.
Served under quant="w4a8": the Q/K/V/O and MLP projections pack to int4
(Q4Tensor) and run the int4 Conv PE; the paged KV cache reads through the
paged gather.

  * int4 packing is bitwise the reference's, a K whose group snaps
    included;
  * the plain int4 GEMM (`conv_pe.matmul_int4_fused_plain`) sums its
    groups in a fixed order, so it is held to the reference's `ref.py` and
    Pallas kernel (interpret mode) within rtol 1e-6 / atol 1e-4 for f32
    out and one int8 code, with and without the residual tail;
  * the plain paged gather is bitwise the reference's, sentinel rows
    included;
  * the lowered graphs are node for node the reference's (full, prefill,
    decode, paged decode), and so are the fused launch counts;
  * calibration scales agree within 1e-5 relative;
  * the static w4a8 programs' logits (prefill, then three decode steps,
    dense and paged) are within 2% of max|logit| of the reference's EAGER
    programs, and the greedy ids of the port's ServeEngine equal the
    reference ServeEngine's.

The JAX side (calibration, the eager programs, the jitted ServeEngine)
runs once per module.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import compiler as jc
from repro import configs as j_configs
from repro.compiler import executor as jex
from repro.core import quant as j_quant
from repro.core.config import EngineConfig as JEng
from repro.kernels import _epilogue as j_epi
from repro.kernels import conv_pe as j_conv_pe
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServe

from repro_torch import bridge
from repro_torch import compiler as tc
from repro_torch import configs as t_configs
from repro_torch.compiler import executor as tex
from repro_torch.core import engine as t_eng
from repro_torch.core import quant as t_quant
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.kernels import _build, conv_pe, flash_attn
from repro_torch.kernels import ops as t_ops
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ServeEngine as TServe

from test_torch_cnn_slice import _nodes, _numpy_params

J_W4 = JEng(quant="w4a8", backend="ref")
T_W4 = TEng(quant="w4a8", backend="ref")
T_W4_CUDA = TEng(quant="w4a8", backend="cuda")   # plain versions on CPU
B, PLEN, PAGE, MAX_SEQ, STEPS = 2, 16, 8, 32, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def lm():
    """Both archs, seeded numpy weights on both sides, one calibration
    batch, the reference's calibration and its eager static programs."""
    arch_t = t_configs.reduced(t_configs.get_arch("qwen2-1.5b"))
    arch_j = j_configs.reduced(j_configs.get_arch("qwen2-1.5b"))
    rng = np.random.default_rng(0)
    params = _numpy_params(TT.lm_schema(arch_t), rng)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = bridge.params_from_numpy(params, device="cpu")
    calib = rng.integers(0, arch_t.vocab_size, (B, PLEN)).astype(np.int32)
    toks = rng.integers(0, arch_t.vocab_size, (B, PLEN)).astype(np.int32)
    sj = jc.calibrate_lm(arch_j, pj, [jnp.asarray(calib)])
    st = tc.calibrate_lm(arch_t, pt, [_t(calib).long()])
    qt = t_eng.quantize_params(pt, T_W4)
    return dict(arch_t=arch_t, arch_j=arch_j, params=params, pj=pj, pt=pt,
                calib=calib, toks=toks, sj=sj, st=st, qt=qt,
                qj=_to_jax_quantized(qt))


def _to_jax_quantized(tree):
    """The port's quantized tree as the reference's containers (the
    packing is held bitwise to the reference's by its own test; reusing
    it keeps the reference's eager packing out of this file's time)."""
    if isinstance(tree, t_quant.Q4Tensor):
        return j_quant.Q4Tensor(*(jnp.asarray(_np(x)) for x in tree))
    if isinstance(tree, t_quant.QTensor):
        return j_quant.QTensor(jnp.asarray(_np(tree.q)),
                               jnp.asarray(_np(tree.scale)))
    if isinstance(tree, dict):
        return {k: _to_jax_quantized(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax_quantized(v) for v in tree]
    return jnp.asarray(_np(tree))


# ---------------------------------------------------------------------------
# int4 packing and the int4 GEMM's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,gs", [(128, 64, 32), (96, 64, 64)])
def test_pack_unpack_int4_bitwise(k, n, gs):
    """Codes, f16 scales and zeros equal the reference's; K=96 snaps the
    group to 32 (snap_group_size).  (128, 64, 32) is the GEMM tests'
    shape, so the reference's eager packing compiles once for both.)"""
    for kk in (20, 30, 8960):
        assert t_quant.snap_group_size(kk, gs) == \
            j_quant.snap_group_size(kk, gs)
    w = np.random.default_rng(k).normal(size=(k, n)).astype(np.float32)
    assert t_quant.snap_group_size(k, gs) == j_quant.snap_group_size(k, gs)
    qj = j_quant.pack_int4(jnp.asarray(w), gs)
    qt = t_quant.pack_int4(_t(w), gs)
    for f in ("packed", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(qt, f)),
                                      np.asarray(getattr(qj, f)))
        assert _np(getattr(qt, f)).dtype == np.asarray(getattr(qj, f)).dtype
    np.testing.assert_array_equal(
        _np(t_quant.unpack_int4(qt.packed)),
        np.asarray(j_quant.unpack_int4(qj.packed)))
    np.testing.assert_array_equal(_np(qt.dequant()), np.asarray(qj.dequant()))
    assert qt.group_size == qj.group_size and qt.shape == qj.shape


def _w4_case(seed, m=8, k=128, n=64, gs=32):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    a_scale = rng.uniform(0.005, 0.05, (m, 1)).astype(np.float32)
    q4 = j_quant.pack_int4(jnp.asarray(rng.normal(size=(k, n))
                                       .astype(np.float32)), gs)
    bias = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    r = rng.normal(size=(m, n)).astype(np.float32)
    return a, a_scale, q4, bias, r


def _w4_plain(a, a_scale, q4, bias, **kw):
    return _np(conv_pe.matmul_int4_fused_plain(
        _t(a), _t(q4.packed), _t(a_scale), _t(q4.scale), _t(q4.zero),
        _t(bias), **kw))


def _w4_pallas(a, a_scale, q4, bias, **kw):
    return np.asarray(j_conv_pe.matmul_int4_fused(
        jnp.asarray(a), q4.packed, jnp.asarray(a_scale), q4.scale, q4.zero,
        jnp.asarray(bias), bm=8, bn=64, interpret=True, **kw))


@pytest.mark.parametrize("act", ["none", "relu"])
def test_int4_gemm_plain_f32_matches_ref_and_pallas(act):
    a, a_scale, q4, bias, _ = _w4_case(1)
    got = _w4_plain(a, a_scale, q4, bias, act=act)
    want = np.asarray(j_ref.matmul_int4_fused(
        jnp.asarray(a), q4.packed, jnp.asarray(a_scale), q4.scale, q4.zero,
        jnp.asarray(bias), act))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, _w4_pallas(a, a_scale, q4, bias,
                                               act=act),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("out_kind", ["scalar", "vector"])
def test_int4_gemm_plain_int8_out_within_one_code(out_kind):
    a, a_scale, q4, bias, _ = _w4_case(2)
    n = bias.shape[0]
    os = (0.05 if out_kind == "scalar" else
          np.random.default_rng(3).uniform(0.02, 0.08, (1, n))
          .astype(np.float32))
    got = _w4_plain(a, a_scale, q4, bias, act="relu",
                    out_scale=os if out_kind == "scalar" else _t(os))
    want = np.asarray(j_ref.matmul_int4_fused(
        jnp.asarray(a), q4.packed, jnp.asarray(a_scale), q4.scale, q4.zero,
        jnp.asarray(bias), "relu",
        out_scale=os if out_kind == "scalar" else jnp.asarray(os)))
    assert got.dtype == np.int8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    pal = _w4_pallas(a, a_scale, q4, bias, act="relu",
                     out_scale=os if out_kind == "scalar"
                     else jnp.asarray(os))
    assert np.abs(got.astype(np.int32) - pal.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("static", [False, True])
def test_int4_gemm_residual_matches_ref_chain_and_pallas(static):
    """The residual tail (qdq at mid_scale in a static chain, + r, requant
    or f32) against the reference's ref.py + _epilogue chain and its
    Pallas residual kernel."""
    a, a_scale, q4, bias, r = _w4_case(4)
    kw = dict(mid_scale=0.04, out_scale=0.06) if static else {}
    got = _w4_plain(a, a_scale, q4, bias, residual=_t(r), res_scale=1.0,
                    **kw)
    base = j_ref.matmul_int4_fused(jnp.asarray(a), q4.packed,
                                   jnp.asarray(a_scale), q4.scale, q4.zero,
                                   jnp.asarray(bias), "none")
    want = np.asarray(j_epi.fused_chain(base, residual=jnp.asarray(r), **kw))
    pal = _w4_pallas(a, a_scale, q4, bias, residual=jnp.asarray(r),
                     res_scale=1.0, **kw)
    if static:
        assert got.dtype == np.int8
        for other in (want, pal):
            assert np.abs(got.astype(np.int32)
                          - other.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got, pal, rtol=1e-6, atol=1e-4)


def test_int4_gemm_group_order_is_fixed():
    """The plain group combine is the sequential one the kernel runs:
    acc_s over groups, then acc_z, then their sum, each step f32."""
    a, a_scale, q4, _, _ = _w4_case(5, gs=16)
    codes = t_quant.unpack_int4(_t(q4.packed)).to(torch.int64)
    at = _t(a).to(torch.int64)
    sc, zr = _t(q4.scale).float(), _t(q4.zero).float()
    g = sc.shape[0]
    gs = a.shape[1] // g
    acc_s = torch.zeros(a.shape[0], codes.shape[1])
    acc_z = torch.zeros_like(acc_s)
    for gi in range(g):
        sl = slice(gi * gs, (gi + 1) * gs)
        part = (at[:, sl] @ codes[sl]).float()
        acc_s = acc_s + part * sc[gi]
        acc_z = acc_z + at[:, sl].sum(1, keepdim=True).float() * zr[gi]
    from repro_torch.kernels import ref as t_ref
    got = t_ref.int4_group_dot(_t(a), t_quant.unpack_int4(_t(q4.packed)),
                               _t(q4.scale), _t(q4.zero))
    assert torch.equal(got, acc_s + acc_z)


# ---------------------------------------------------------------------------
# Paged gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_paged_gather_bitwise_with_sentinels(dtype):
    """Block tables with sentinel entries (N, one past the pool) and a
    whole sentinel row: the ops wrapper clips, the copy is bitwise the
    reference's ref and Pallas (interpret) gather."""
    rng = np.random.default_rng(6)
    n, p, hkv, d = 6, 4, 2, 8
    pool = (rng.normal(size=(n, p, hkv, d)) * 50).astype(dtype)
    tables = np.array([[3, 0, 6, 6], [5, 1, 2, 4], [6, 6, 6, 6]], np.int32)
    want = np.asarray(j_ops.paged_gather(jnp.asarray(pool),
                                         jnp.asarray(tables), J_W4))
    pal = np.asarray(j_ops.paged_gather(
        jnp.asarray(pool), jnp.asarray(tables),
        JEng(quant="w4a8", backend="pallas", interpret=True)))
    np.testing.assert_array_equal(want, pal)
    for eng in (T_W4, T_W4_CUDA):
        got = _np(t_ops.paged_gather(_t(pool), _t(tables), eng))
        np.testing.assert_array_equal(got, want)
    clipped = np.clip(tables, 0, n - 1)
    np.testing.assert_array_equal(
        _np(flash_attn.paged_gather_plain(_t(pool), _t(clipped))), want)


def test_paged_gather_bf16_is_a_copy():
    pool = torch.randn(5, 4, 2, 8, generator=torch.Generator().manual_seed(0)
                       ).to(torch.bfloat16)
    tables = torch.tensor([[4, 0], [2, 2]], dtype=torch.int32)
    got = flash_attn.paged_gather(pool, tables)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 2, 8)
    assert torch.equal(got[1, 4:], pool[2]) and torch.equal(got[0, :4],
                                                            pool[4])


# ---------------------------------------------------------------------------
# Lowering, fusion and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,page", [("full", 0), ("prefill", 0),
                                       ("decode", 0), ("decode", PAGE)])
def test_lowered_graphs_match_reference(lm, mode, page):
    kw = (dict(last_only=True) if mode == "prefill" else
          dict(mode=mode, page_size=page) if mode == "decode" else {})
    gj = jc.lower_transformer(lm["arch_j"], **kw)
    gt = tc.lower_transformer(lm["arch_t"], **kw)
    assert _nodes(gt) == _nodes(gj)
    assert gt.output == gj.output and gt.name == gj.name.replace(
        lm["arch_j"].name, lm["arch_t"].name)
    fj, _ = jc.fuse_epilogues(*jc.fuse_projections(gj))
    ft, _ = tc.fuse_epilogues(*tc.fuse_projections(gt))
    assert _nodes(ft) == _nodes(fj)
    assert tc.launch_count(ft) == jc.launch_count(fj)
    # per layer: QKV group, attention, O(+add), norm x2, gate/up group,
    # gate product, down(+add); then the final norm and the head
    n = lm["arch_t"].n_layers
    assert tc.launch_count(ft) == 8 * n + 2
    assert tc.fusion_stats(ft)["fused_projections"] == 2 * n


def test_calibration_scales_match_reference(lm):
    sj, st = lm["sj"], lm["st"]
    assert sorted(sj) == sorted(st)
    for k in sj:
        assert st[k] == pytest.approx(sj[k], rel=1e-5), k


def test_static_plan_matches_reference(lm):
    """Same int8 edges and scales in the fused static decode program, and
    no f32 edge into any GEMM."""
    pj = jex.compile_lm(lm["arch_j"], scales=lm["sj"], mode="decode")
    pt = tex.compile_lm(lm["arch_t"], scales=lm["sj"], mode="decode")
    assert pt.plan.emit_int8 == pj.plan.emit_int8
    assert pt.plan.out_scale == pj.plan.out_scale
    assert tc.f32_roundtrip_edges(pt.graph, pt.plan) == []
    own = tc.compile_lm_calibrated(lm["arch_t"], lm["pt"],
                                   [_t(lm["calib"]).long()], mode="decode",
                                   page_size=PAGE)
    assert own.kind == "decode" and own.graph.name.endswith(f":p{PAGE}")
    assert own.plan.out_scale == tex.compile_lm(
        lm["arch_t"], scales=lm["st"], mode="decode").plan.out_scale


# ---------------------------------------------------------------------------
# Static w4a8 logits against the reference's eager programs
# ---------------------------------------------------------------------------

def _tables(arch_t):
    pages = MAX_SEQ // PAGE
    return np.arange(B * pages, dtype=np.int32).reshape(B, pages)


def _jax_run(lm, paged: bool):
    """The reference's eager static prefill + STEPS decode steps; the
    tokens fed back are the reference's greedy ids."""
    arch = lm["arch_j"]
    prog = jex.compile_lm(arch, scales=lm["sj"], mode="prefill")
    dec = jex.compile_lm(arch, scales=lm["sj"], mode="decode",
                         page_size=PAGE if paged else 0)
    kvs = {}
    toks = jnp.asarray(lm["toks"])
    logits = jex.execute(prog, lm["qj"], toks, J_W4, collect=kvs)
    if paged:
        cs = JT.paged_cache_schema(arch, B, MAX_SEQ, J_W4, PAGE)
    else:
        cs = JT.cache_schema(arch, B, MAX_SEQ, J_W4)
    cache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   cs, is_leaf=lambda x: hasattr(x, "axes"))
    tables = jnp.asarray(_tables(arch))
    layers = []
    for i, e in enumerate(cache["layers"]):
        k, v = kvs[i]
        if paged:
            layers.append(JT._paged_prefill_store(
                e, k, v, tables, jnp.ones(B, bool), J_W4, PAGE))
        else:
            layers.append(JT._kv_store(e, k, v, 0, J_W4))
    cache = {"layers": layers, "pos": jnp.full((B,), PLEN, jnp.int32)}
    if paged:
        cache["tables"] = tables
    out = [np.asarray(logits[:, -1])]
    cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ids = [np.asarray(cur[:, 0])]
    for _ in range(STEPS):
        logits, cache = jex.execute_decode(dec, lm["qj"], cache, cur, J_W4)
        out.append(np.asarray(logits[:, -1]))
        cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ids.append(np.asarray(cur[:, 0]))
    return out, ids


def _port_run(lm, paged: bool, eng, ids):
    arch = lm["arch_t"]
    prog = tex.compile_lm(arch, scales=lm["st"], mode="prefill")
    dec = tex.compile_lm(arch, scales=lm["st"], mode="decode",
                         page_size=PAGE if paged else 0)
    kvs = {}
    qt = lm["qt"]
    logits = tex.execute(prog, qt, _t(lm["toks"]), eng, collect=kvs)
    if paged:
        cs = TT.paged_cache_schema(arch, B, MAX_SEQ, eng, PAGE)
    else:
        cs = TT.cache_schema(arch, B, MAX_SEQ, eng)
    cache = TT.zeros_from_schema(cs, "cpu")
    tables = _t(_tables(arch))
    layers = []
    for i, e in enumerate(cache["layers"]):
        k, v = kvs[i]
        if paged:
            layers.append(TT._paged_prefill_store(
                e, k, v, tables, torch.ones(B, dtype=torch.bool), eng, PAGE))
        else:
            layers.append(TT._kv_store(e, k, v, 0, eng))
    cache = {"layers": layers, "pos": torch.full((B,), PLEN,
                                                 dtype=torch.int32)}
    if paged:
        cache["tables"] = tables
    out = [_np(logits[:, -1])]
    for step in range(STEPS):
        cur = _t(ids[step][:, None].astype(np.int32))
        logits, cache = tex.execute_decode(dec, qt, cache, cur, eng)
        out.append(_np(logits[:, -1]))
    return out


@pytest.fixture(scope="module")
def jax_logits(lm):
    """The reference's eager paged run (its paged and dense programs are
    bitwise equal -- its own contract -- so one run serves both)."""
    return _jax_run(lm, paged=True)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_static_w4a8_logits_match_reference(lm, jax_logits, paged, backend):
    """Prefill logits and three decode steps of the static w4a8 programs
    (the reference's greedy ids fed to both), dense and paged, against the
    reference's eager run.  Measured here: the largest gap is 5.1e-7 of
    max|logit| (max|logit| about 1.6), on every step, dense and paged,
    both backends -- f32 sums in another order and ulp-level
    transcendentals, none of which moved an int8 code at this size.  The
    bound is 2% (a moved code would shift a logit by a scale step).  The
    port's own dense and paged logits are bitwise equal."""
    want, ids = jax_logits
    eng = T_W4 if backend == "ref" else T_W4_CUDA
    got = _port_run(lm, paged, eng, ids)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        gap = np.abs(g - w).max()
        assert gap <= 0.02 * np.abs(w).max(), (gap, np.abs(w).max())
    if paged:
        dense = _port_run(lm, False, eng, ids)
        for g, d in zip(got, dense):
            np.testing.assert_array_equal(g, d)


# ---------------------------------------------------------------------------
# ServeEngine: greedy ids against the reference engine
# ---------------------------------------------------------------------------

def _prompts(arch):
    rng = np.random.default_rng(7)
    return [rng.integers(0, arch.vocab_size, size=n).astype(np.int32)
            for n in (5, 16, 9, 3)]


def _engine_kw(layout):
    return dict(batch_size=B, max_seq=MAX_SEQ, prefill_len=PLEN,
                kv_layout=layout, page_size=PAGE, decode_burst=2)


@pytest.fixture(scope="module")
def jax_ids(lm):
    """The reference engine on the already-quantized tree (its
    quantize_params passes Q4Tensor / QTensor leaves through) with its
    calibration memo set to the reference's own scales for this batch, so
    neither its eager packing nor a second calibration run is timed."""
    e = JServe(lm["arch_j"], lm["qj"], J_W4, calib_batches=[lm["calib"]],
               **_engine_kw("paged"))
    e._scales = lm["sj"]
    return e.generate(_prompts(lm["arch_j"]), max_new_tokens=4)


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_serve_engine_ids_match_reference(lm, jax_ids, layout, backend):
    """4 requests x 4 greedy tokens through 2 slots (so slots refill and
    paged blocks are freed and reused): the port's ids equal the reference
    paged engine's, for paged and dense, on backend="ref" and on the CUDA
    backend's dispatch with CPU tensors."""
    e = TServe(lm["arch_t"], lm["pt"], T_W4 if backend == "ref"
               else T_W4_CUDA, calib_batches=[lm["calib"]], device="cpu",
               **_engine_kw(layout))
    got = e.generate(_prompts(lm["arch_t"]), max_new_tokens=4)
    for g, w in zip(got, jax_ids):
        np.testing.assert_array_equal(g, np.asarray(w))
    st = e.stats()
    assert st["requests"] == 4 and st["slot_refills"] == 2
    if layout == "paged":
        assert st["kv_blocks"]["in_use"] == 0
        assert st["kv_blocks"]["peak_in_use"] == B * -(-(PLEN + 4) // PAGE)


def test_serve_engine_keys_and_unported_paths(lm):
    """Prefill and decode, w4 and w8, dense and paged hold distinct cache
    lines; the reference's later paths raise with their slice named."""
    arch, pt, calib = lm["arch_t"], lm["pt"], lm["calib"]
    keys = set()
    for quant in ("w4a8", "w8a8"):
        for layout in ("dense", "paged"):
            e = TServe(arch, pt, TEng(quant=quant), calib_batches=[calib],
                       device="cpu", **_engine_kw(layout))
            keys |= {e._prefill_key(), e._decode_key()}
            if quant == "w4a8":
                assert e.calib_id.endswith(":w4g64")
    assert len(keys) == 6        # prefill keys are shared across layouts
    for kw in (dict(draft_len=2), dict(prefix_sharing=True),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="slice"):
            TServe(arch, pt, T_W4, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="slice"):
        TEng(quant="w4a8", kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="slice"):
        tc.lower_transformer(arch, mode="chunk", page_size=PAGE)
    rej = TServe(arch, pt, T_W4, device="cpu", **_engine_kw("paged")).submit(
        np.zeros(30, np.int32), max_new_tokens=8)
    assert not rej and rej.reason == "over_length"


def test_plain_versions_launch_nothing(lm):
    """On CPU tensors the CUDA backend runs the plain versions: no kernel
    launch is counted on the whole LM path."""
    _build.reset_counts()
    e = TServe(lm["arch_t"], lm["pt"], T_W4_CUDA, device="cpu",
               **_engine_kw("paged"))
    e.generate(_prompts(lm["arch_t"])[:2], max_new_tokens=2)
    assert _build.COUNTS == {}


def test_arch_config_matches_reference(lm):
    """The port's qwen2-1.5b (full and reduced) carries the reference's
    values in every field both configs have."""
    for t, j in ((t_configs.get_arch("qwen2-1.5b"),
                  j_configs.get_arch("qwen2-1.5b")),
                 (lm["arch_t"], lm["arch_j"])):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]
        assert tc.lowering_blockers(t) == jc.lowering_blockers(j) == []


def test_quantize_schema_matches_quantized_tree(lm):
    """quantize_schema describes exactly the containers quantize_params
    builds: Q4Tensor specs for the w4a8 projections, QTensor for the
    embedding, float leaves unchanged."""
    schema = t_eng.quantize_schema(TT.lm_schema(lm["arch_t"]), T_W4)

    def walk(spec, val, path=()):
        if isinstance(spec, dict):
            assert spec.keys() == val.keys(), path
            for k in spec:
                walk(spec[k], val[k], path + (k,))
        elif isinstance(spec, list):
            for i, (s, v) in enumerate(zip(spec, val)):
                walk(s, v, path + (i,))
        elif isinstance(spec, tuple):
            assert type(spec) is type(val), path
            for s, v in zip(spec, val):
                walk(s, v, path)
        else:
            assert tuple(spec.shape) == tuple(val.shape), path
            assert spec.dtype == val.dtype, path

    walk(schema, lm["qt"])
