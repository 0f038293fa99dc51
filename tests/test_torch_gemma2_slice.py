"""gemma2-2b on the compiled LM path of the port against the JAX reference,
on the CPU.

The model is the reduced gemma2-2b (`configs.reduced`: 2 layers, one local
with a 64-token window and one global, d=128, 4 query and 2 KV heads of 32,
gated tanh-gelu d_ff 256, vocab 512, attention softcap 50, final softcap
30, post-norms, scaled embeddings, tied embeddings) on seeded numpy weights
handed to both sides, served under quant="w4a8" with prompts padded to 48
tokens and 24 new tokens, so every request's positions cross the local
layer's 64-token ring.

  * the params bridge carries the gemma tree (post-norm leaves included)
    and the reference's quantized containers bitwise;
  * the lowered graphs, fused launch counts and paged cache layout (local
    rings dense beside the global pool) are the reference's;
  * calibration scales agree within 1e-5 relative;
  * the static prefill's logits and 24 decode steps across the ring wrap
    are within 1e-4 of max|logit| of the reference engine's jitted
    executables on shared calibration scales (measured: 4.3e-7), on the
    ref backend and on the CUDA backend's dispatch (its prefill attention
    runs the flash kernel's plain version on CPU tensors), the port's
    dense and paged runs bitwise equal;
  * the greedy ids of the port's ServeEngine equal the reference engine's,
    dense and paged, on both backends' dispatch.

The JAX side (its calibration, its jitted engine) runs once per module.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import compiler as jc
from repro import configs as j_configs
from repro.core.config import EngineConfig as JEng
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServe

from repro_torch import bridge
from repro_torch import compiler as tc
from repro_torch import configs as t_configs
from repro_torch.core import engine as t_eng
from repro_torch.core import quant as t_quant
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.kernels import _build
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import ServeEngine as TServe

from test_torch_cnn_slice import _nodes, _numpy_params
from test_torch_lm_slice import _to_jax_quantized

J_W4 = JEng(quant="w4a8", backend="ref")
T_W4 = TEng(quant="w4a8", backend="ref")
T_W4_CUDA = TEng(quant="w4a8", backend="cuda")   # plain versions on CPU
B, PLEN, PAGE, MAX_SEQ, NEW = 2, 48, 16, 128, 24
PROMPT_LENS = (48, 20, 33, 7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _engine_kw(layout):
    return dict(batch_size=B, max_seq=MAX_SEQ, prefill_len=PLEN,
                kv_layout=layout, page_size=PAGE, decode_burst=4)


def _tables():
    pages = MAX_SEQ // PAGE
    return np.arange(B * pages, dtype=np.int32).reshape(B, pages)


@pytest.fixture(scope="module")
def g2():
    """Both archs, seeded numpy weights on both sides, one calibration
    batch, both calibrations, the port's packed tree, and the reference's
    paged engine with its greedy ids for the trace."""
    arch_t = t_configs.reduced(t_configs.get_arch("gemma2-2b"))
    arch_j = j_configs.reduced(j_configs.get_arch("gemma2-2b"))
    rng = np.random.default_rng(0)
    params = _numpy_params(TT.lm_schema(arch_t), rng)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = bridge.params_from_numpy(params, device="cpu")
    calib = rng.integers(0, arch_t.vocab_size, (B, PLEN)).astype(np.int32)
    prompts = [rng.integers(0, arch_t.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    sj = jc.calibrate_lm(arch_j, pj, [jnp.asarray(calib)])
    st = tc.calibrate_lm(arch_t, pt, [_t(calib).long()])
    qt = t_eng.quantize_params(pt, T_W4)
    qj = _to_jax_quantized(qt)
    je = JServe(arch_j, qj, J_W4, calib_batches=[calib],
                **_engine_kw("paged"))
    je._scales = sj
    ids = je.generate(prompts, max_new_tokens=NEW)
    return dict(arch_t=arch_t, arch_j=arch_j, params=params, pt=pt,
                calib=calib, prompts=prompts, sj=sj, st=st, qt=qt, qj=qj,
                je=je, ids=[np.asarray(i) for i in ids])


def test_arch_config_matches_reference(g2):
    """The port's gemma2-2b (full and reduced) carries the reference's
    values in every field both configs have."""
    for t, j in ((t_configs.get_arch("gemma2-2b"),
                  j_configs.get_arch("gemma2-2b")),
                 (g2["arch_t"], g2["arch_j"])):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]
        assert tc.lowering_blockers(t) == jc.lowering_blockers(j) == []
    assert "gemma2-2b" in t_configs.list_archs()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, tuple):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, path + (f,))
    else:
        yield path, tree


def test_params_bridge(g2):
    """The port's schema has the reference's leaves and shapes (the gemma
    post-norms included); the float tree and the reference's quantized
    containers (Q4Tensor projections, QTensor embedding) come across
    bitwise."""
    ref = {p: tuple(s.shape) for p, s in _leaves(JT.lm_schema(g2["arch_j"]))}
    ours = {p: tuple(v.shape) for p, v in _leaves(g2["params"])}
    assert ours == ref
    assert ("blocks", 0, "post_attn_norm") in ours
    assert ("blocks", 1, "post_mlp_norm") in ours
    for (p, a), (_, b) in zip(_leaves(g2["params"]), _leaves(g2["pt"])):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(p))
    back = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, g2["qj"]), device="cpu")
    got, want = list(_leaves(back)), list(_leaves(g2["qt"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert isinstance(back["blocks"][0]["attn"]["wq"], t_quant.Q4Tensor)
    assert isinstance(back["embed"], t_quant.QTensor)
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), p


@pytest.mark.parametrize("mode,page", [("full", 0), ("prefill", 0),
                                       ("decode", 0), ("decode", PAGE)])
def test_lowered_graphs_match_reference(g2, mode, page):
    """Node for node, fused launch counts included: the post-norms keep the
    residual adds off the O / down GEMMs in both."""
    kw = (dict(last_only=True) if mode == "prefill" else
          dict(mode=mode, page_size=page) if mode == "decode" else {})
    gj = jc.lower_transformer(g2["arch_j"], **kw)
    gt = tc.lower_transformer(g2["arch_t"], **kw)
    assert _nodes(gt) == _nodes(gj)
    fj, _ = jc.fuse_epilogues(*jc.fuse_projections(gj))
    ft, _ = tc.fuse_epilogues(*tc.fuse_projections(gt))
    assert _nodes(ft) == _nodes(fj)
    assert tc.launch_count(ft) == jc.launch_count(fj)
    assert tc.fusion_stats(ft)["fused_adds"] == 0


def test_paged_cache_layout_matches_reference(g2):
    """Local ring layers stay dense [B, window, Hkv, D] beside the global
    layers' block pool, as in the reference."""
    ct = TT.paged_cache_schema(g2["arch_t"], B, MAX_SEQ, T_W4, PAGE)
    cj = JT.paged_cache_schema(g2["arch_j"], B, MAX_SEQ, J_W4, PAGE)
    for et, ej in zip(ct["layers"], cj["layers"]):
        assert tuple(et["k"].shape) == tuple(ej["k"].shape)
    assert tuple(ct["layers"][0]["k"].shape) == (B, 64, 2, 32)
    assert tuple(ct["tables"].shape) == tuple(cj["tables"].shape)


def test_calibration_scales_match_reference(g2):
    sj, st = g2["sj"], g2["st"]
    assert sorted(sj) == sorted(st)
    for k in sj:
        assert st[k] == pytest.approx(sj[k], rel=1e-5), k


def _toks(g2):
    toks = np.zeros((B, PLEN), np.int32)
    for i, p in enumerate(g2["prompts"][:B]):
        toks[i, PLEN - len(p):] = p          # left-padded, as served
    return toks


@pytest.fixture(scope="module")
def jax_logits(g2):
    """The reference engine's jitted paged prefill and NEW decode steps
    (the executables its generate() compiled) on the first B prompts, its
    greedy ids fed back: logits per step and the ids fed."""
    je = g2["je"]
    cache = je._empty_cache()
    cache["tables"] = jnp.asarray(_tables())
    cache["pos"] = jnp.zeros((B,), jnp.int32)
    logits, cache = je._paged_prefill_exec()(
        je.params, cache, {"tokens": jnp.asarray(_toks(g2))},
        jnp.ones(B, bool))
    out, ids = [np.asarray(logits[:, -1])], []
    dec = je._decode_exec()
    for _ in range(NEW):
        ids.append(np.asarray(jnp.argmax(logits[:, -1], -1)[:, None]
                              .astype(jnp.int32)))
        logits, cache = dec(je.params, cache, jnp.asarray(ids[-1]))
        out.append(np.asarray(logits[:, -1]))
    return out, ids


def _port_logits(g2, eng, layout, ids):
    """The port engine's static prefill (paged: scattered through the block
    table; dense: merged row by row) and decode steps on the reference's
    calibration scales."""
    e = TServe(g2["arch_t"], g2["pt"], eng, calib_batches=[g2["calib"]],
               device="cpu", **_engine_kw(layout))
    e._scales = g2["sj"]
    cache = e._empty_cache()
    fill = e._prefill_paged if layout == "paged" else e._prefill_dense
    if layout == "paged":
        cache["tables"] = _t(_tables())
    logits, cache = fill(e.prefill_program(), cache, _t(_toks(g2)),
                         torch.ones(B, dtype=torch.bool))
    out = [logits[:, -1].numpy()]
    for cur in ids:
        logits, cache = e._decode_step(cache, _t(cur))
        out.append(logits[:, -1].numpy())
    return out


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_static_logits_match_reference_across_the_ring(g2, jax_logits,
                                                       backend):
    """The static w4a8 prefill's logits and NEW decode steps (positions
    48-71: the local layer's ring wraps at 64) against the reference
    engine's, both on the reference's calibration scales and fed the
    reference's ids.  The bound is 1e-4 of max|logit|: on shared scales
    no int8 code may move (one moved code gives a gap near 1.2e-2) and
    no step may run in a lower precision; measured here: at most 4.3e-7
    of max|logit| on every step, both backends -- f32 sums in another
    order and ulp-level transcendentals, none of which moved a code.
    (With each side's own calibration, whose scales agree within 7.8e-7
    relative, a code does move: the gap is then 1.2e-2.)  On the CUDA backend's
    dispatch the global layer's prefill attention runs the flash kernel's
    plain version (ref.attention).  The port's dense and paged runs are
    bitwise equal."""
    want, ids = jax_logits
    eng = T_W4 if backend == "ref" else T_W4_CUDA
    got = _port_logits(g2, eng, "paged", ids)
    assert len(got) == NEW + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        gap = np.abs(g - w).max()
        assert gap <= 1e-4 * np.abs(w).max(), (gap, np.abs(w).max())
    for g, d in zip(got, _port_logits(g2, eng, "dense", ids)):
        np.testing.assert_array_equal(g, d)


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_serve_engine_ids_match_reference(g2, layout, backend):
    """4 requests x 24 greedy tokens through 2 slots (slots refill, paged
    blocks are freed and reused, every request's positions cross the ring):
    the port's ids equal the reference paged engine's, for paged and dense,
    on backend="ref" and on the CUDA backend's dispatch with CPU tensors,
    where no kernel launches."""
    _build.reset_counts()
    e = TServe(g2["arch_t"], g2["pt"], T_W4 if backend == "ref"
               else T_W4_CUDA, calib_batches=[g2["calib"]], device="cpu",
               **_engine_kw(layout))
    got = e.generate(g2["prompts"], max_new_tokens=NEW)
    for g, w in zip(got, g2["ids"]):
        np.testing.assert_array_equal(g, w)
    assert _build.COUNTS == {}
    st = e.stats()
    assert st["requests"] == 4 and st["slot_refills"] == 2
    if layout == "paged":
        assert st["kv_blocks"]["in_use"] == 0
