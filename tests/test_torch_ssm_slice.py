"""The eager SSM serving slice of the port against the JAX reference, on
the CPU.

The model is the reduced falcon-mamba-7b (`configs.reduced`: 2 mamba
layers, d 128, d_inner 256, ssm_state 16, conv_kernel 4, dt_rank 8, vocab
512, untied head, no MLP half) on seeded numpy weights handed to both
sides (`bridge.params_from_numpy`), served under quant="w8a8": the four
mamba projections run the int8 Conv PE with per-token activation scales,
the temporal conv the DWC PE's causal 1-D conv (`ops.dwc1d_causal`).

  * the plain causal conv and `ops.dwc1d_causal` on both backends against
    the reference's `ref.dwc1d_causal` (act none bitwise, silu within 2e-6
    relative) and its Pallas kernel in interpret mode (within 2e-6);
  * `mamba_apply` (with state) and `mamba_decode` under quant none and
    w8a8 on identical inputs; under w8a8 the conv state (the in_proj tail)
    is bitwise the reference's;
  * eager `T.prefill` + 4 `T.decode` steps through the serving merge,
    against the reference engine's jitted prefill / merge / decode: logits
    within 2% of max|logit|, greedy ids identical;
  * the port's ServeEngine ids equal the reference ServeEngine's (dense,
    2 slots, 4 requests, so slots refill and the merge runs on a decoded
    cache), on both backends;
  * the engine's eager-path contract: paged KV refused, the reference's
    lowering blockers, no calibration digest, no launch on CPU tensors;
  * falcon-mamba-7b's ArchConfig, full and reduced, is the reference's.

The JAX side runs once per module, jitted where the reference's engine
jits (its eager op-by-op dispatch compiles every op and would cost tens of
seconds here); the bitwise conv-state check runs the reference's in_proj
eagerly.  Nothing here changes process state.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import compiler as jc
from repro import configs as j_configs
from repro.core import engine as j_eng
from repro.core import quant as j_quant
from repro.core.config import EngineConfig as JEng
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JServe

from repro_torch import bridge
from repro_torch import compiler as tc
from repro_torch import configs as t_configs
from repro_torch.core import engine as t_eng
from repro_torch.core import quant as t_quant
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.kernels import _build, dwc_pe
from repro_torch.kernels import ops as t_ops
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as t_serve
from repro_torch.serve.engine import ServeEngine as TServe

from test_torch_cnn_slice import _numpy_params

ARCH = "falcon-mamba-7b"
B, PLEN, MAX_SEQ, STEPS, NEW = 2, 16, 32, 4, 4
J_W8 = JEng(quant="w8a8", backend="ref")
ENGS = {"ref": TEng(quant="w8a8", backend="ref"),
        "cuda": TEng(quant="w8a8", backend="cuda")}   # plain versions on CPU


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _jax_tree(tree):
    """The port's (quantized) tree as the reference's containers."""
    if isinstance(tree, t_quant.QTensor):
        return j_quant.QTensor(jnp.asarray(_np(tree.q)),
                               jnp.asarray(_np(tree.scale)))
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return jnp.asarray(_np(tree))


def _prompts(arch):
    rng = np.random.default_rng(7)
    return [rng.integers(0, arch.vocab_size, size=n).astype(np.int32)
            for n in (5, 16, 9, 3)]


def _engine_kw():
    return dict(batch_size=B, max_seq=MAX_SEQ, prefill_len=PLEN,
                decode_burst=2)


@pytest.fixture(scope="module")
def ssm():
    """Both archs, seeded numpy weights on both sides, the port's w8a8
    tree (held bitwise to the reference's quantize_params below, and
    handed to the reference engine, which passes QTensor leaves through)
    and one token batch."""
    arch_t = t_configs.reduced(t_configs.get_arch(ARCH))
    arch_j = j_configs.reduced(j_configs.get_arch(ARCH))
    rng = np.random.default_rng(0)
    params = _numpy_params(TT.lm_schema(arch_t), rng)
    pt = bridge.params_from_numpy(params, device="cpu")
    qt = t_eng.quantize_params(pt, ENGS["ref"])
    toks = rng.integers(0, arch_t.vocab_size, (B, PLEN)).astype(np.int32)
    return dict(arch_t=arch_t, arch_j=arch_j, params=params, pt=pt, qt=qt,
                pj=jax.tree_util.tree_map(jnp.asarray, params),
                qj=_jax_tree(qt), toks=toks)


# ---------------------------------------------------------------------------
# The causal temporal conv
# ---------------------------------------------------------------------------

DWC_CASES = [(k, act, c, bias) for k in (2, 4) for act in ("none", "silu")
             for c in (96, 256) for bias in (True, False)]
DWC_IDS = [f"k{k}-{act}-c{c}-{'bias' if b else 'nobias'}"
           for k, act, c, b in DWC_CASES]


def _dwc_inputs(k, c, bias):
    rng = np.random.default_rng(k * 1000 + c)
    x = rng.normal(size=(2, 12, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32) if bias else None
    return x, w, b


@pytest.fixture(scope="module")
def dwc_jax():
    """The reference's ref.dwc1d_causal and its Pallas kernel (interpret
    mode, through ops.dwc1d_causal, which pads C to 128 lanes) on every
    case's inputs."""
    pallas = JEng(backend="pallas", interpret=True)
    out = {}
    for k, act, c, bias in DWC_CASES:
        x, w, b = (None if a is None else jnp.asarray(a)
                   for a in _dwc_inputs(k, c, bias))
        out[(k, act, c, bias)] = (
            np.asarray(j_ref.dwc1d_causal(x, w, b, act)),
            np.asarray(j_ops.dwc1d_causal(x, w, b, act, pallas)))
    return out


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", DWC_CASES, ids=DWC_IDS)
def test_dwc1d_plain_and_ops_match_ref(dwc_jax, case):
    """The plain version, and ops.dwc1d_causal on both backends (CPU
    tensors), against the reference's ref.dwc1d_causal: bitwise for act
    none (the same f32 mul / add per tap, in order), within 2e-6 of
    max|out| for silu (torch's F.silu and JAX's x * sigmoid(x) round
    differently; measured at most 1.9e-7)."""
    k, act, c, bias = case
    x, w, b = (None if a is None else torch.from_numpy(a)
               for a in _dwc_inputs(k, c, bias))
    want = dwc_jax[case][0]
    outs = [dwc_pe.dwc1d_causal_plain(x, w, b, act)]
    outs += [t_ops.dwc1d_causal(x, w, b, act, eng) for eng in ENGS.values()]
    for got in outs:
        assert got.dtype == torch.float32 and got.shape == x.shape
        if act == "none":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert _rel_err(got.numpy(), want) <= 2e-6
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


@pytest.mark.parametrize("case", DWC_CASES, ids=DWC_IDS)
def test_dwc1d_matches_pallas_interpret(dwc_jax, case):
    """The plain version against the reference's Pallas kernel in
    interpret mode (C padded to 128 lanes by its wrapper), within 2e-6 of
    max|out| (measured at most 1.9e-7)."""
    k, act, c, bias = case
    x, w, b = (None if a is None else torch.from_numpy(a)
               for a in _dwc_inputs(k, c, bias))
    got = dwc_pe.dwc1d_causal_plain(x, w, b, act).numpy()
    want = dwc_jax[case][1]
    assert want.shape == got.shape
    assert _rel_err(got, want) <= 2e-6


# ---------------------------------------------------------------------------
# The mamba mixer
# ---------------------------------------------------------------------------

def _mixer_inputs(arch):
    """x [B, L, d] and x1 [B, 1, d] (bf16 values, as f32 arrays) and a
    nonzero ssm state h0."""
    rng = np.random.default_rng(11)
    x, x1 = (torch.from_numpy(rng.normal(size=(B, n, arch.d_model))
                              .astype(np.float32)).to(torch.bfloat16)
             .float().numpy() for n in (PLEN, 1))
    h0 = (rng.normal(size=(B, arch.d_inner, arch.ssm_state)) * 0.5
          ).astype(np.float32)
    return x, x1, h0


@pytest.fixture(scope="module")
def mixer_jax(ssm):
    """The reference's mamba_apply (with state) and mamba_decode on layer
    0's mixer, jitted, under quant none and w8a8; the decode step starts
    from the apply's state with the conv state rounded to bf16 (what the
    serving merge stores).  Under w8a8 also the reference's in_proj run
    eagerly: mamba_apply's conv state is its last k-1 rows."""
    arch = ssm["arch_j"]
    x, x1, h0 = _mixer_inputs(arch)
    x, x1 = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, x1))
    out = {}
    for quant in ("none", "w8a8"):
        eng = JEng(quant=quant, backend="ref")
        p = (ssm["qj"] if quant == "w8a8" else ssm["pj"])["blocks"][0][
            "mixer"]
        st0 = {"conv": jnp.zeros((B, arch.conv_kernel - 1, arch.d_inner),
                                 jnp.bfloat16),
               "ssm": jnp.asarray(h0)}
        apply = jax.jit(lambda p, x, st: JS.mamba_apply(p, x, arch, eng,
                                                        state=st))
        decode = jax.jit(lambda p, x, st: JS.mamba_decode(p, x, arch, eng,
                                                          st))
        y, st = apply(p, x, st0)
        st_dec = {"conv": st["conv"].astype(jnp.bfloat16), "ssm": st["ssm"]}
        y1, st1 = decode(p, x1, st_dec)
        res = dict(y=np.asarray(y), conv=np.asarray(st["conv"]),
                   ssm=np.asarray(st["ssm"]), y1=np.asarray(y1),
                   conv1=_np(st1["conv"]), ssm1=np.asarray(st1["ssm"]),
                   dec_in={k: _np(v) for k, v in st_dec.items()})
        if quant == "w8a8":
            xz = j_ops.linear(x, p["in_proj"], None, "none", eng)
            xz1 = j_ops.linear(x1, p["in_proj"], None, "none", eng)
            res["eager_conv"] = np.asarray(
                xz[:, -(arch.conv_kernel - 1):, :arch.d_inner])
            res["eager_col"] = np.asarray(xz1[:, :, :arch.d_inner])
        out[quant] = res
    return out


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _close(got, want, tol):
    got = _np(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    gap = np.abs(got - want).max()
    assert gap <= tol * np.abs(want).max(), (gap, np.abs(want).max())


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_mamba_mixer_matches_reference(ssm, mixer_jax, quant):
    """mamba_apply with a nonzero ssm state and the decode step after it,
    on identical inputs, against the reference jitted.  The in-chunk
    prefix folds `_assoc_op` left to right where the reference combines in
    a tree, F.silu and JAX's silu round differently, and XLA's fusions
    round in their own places; under w8a8 such an ulp can flip one int8
    code of a dynamically quantized projection input, which moves an
    output by one code step.  States are held within 1e-3 and outputs
    within 2e-3 of their max|value|.  Measured: under none the bf16
    outputs are equal and the states within 8.5e-8; under w8a8 the states
    within 1.1e-7, the prefill output within 5.7e-7 and the decode output
    within 6.8e-4 (the size of one flipped code).  Under w8a8 the conv
    state -- the
    in_proj tail after apply, the window's last k-1 rows after decode --
    is bitwise the reference's eager in_proj, since dynamic quantization
    and the int8 GEMM are exact."""
    arch, want = ssm["arch_t"], mixer_jax[quant]
    eng = TEng(quant=quant, backend="ref")
    p = (ssm["qt"] if quant == "w8a8" else ssm["pt"])["blocks"][0]["mixer"]
    x, x1, h0 = _mixer_inputs(arch)
    st0 = {"conv": torch.zeros((B, arch.conv_kernel - 1, arch.d_inner),
                               dtype=torch.bfloat16), "ssm": _t(h0)}
    y, st = TS.mamba_apply(p, _t(x, torch.bfloat16), arch, eng, state=st0)
    dec_in = {"conv": _t(want["dec_in"]["conv"], torch.bfloat16),
              "ssm": _t(want["dec_in"]["ssm"])}
    y1, st1 = TS.mamba_decode(p, _t(x1, torch.bfloat16), arch, eng, dec_in)
    for got, key in ((y, "y"), (st["conv"], "conv"), (st["ssm"], "ssm"),
                     (y1, "y1"), (st1["conv"], "conv1"),
                     (st1["ssm"], "ssm1")):
        _close(got, want[key], 2e-3 if key.startswith("y") else 1e-3)
    assert st["conv"].dtype == torch.float32 if quant == "w8a8" else \
        st["conv"].dtype == torch.bfloat16
    if quant == "w8a8":
        np.testing.assert_array_equal(_np(st["conv"]), want["eager_conv"])
        np.testing.assert_array_equal(_np(st1["conv"][:, -1:]),
                                      want["eager_col"])
        np.testing.assert_array_equal(_np(st1["conv"][:, :-1]),
                                      want["dec_in"]["conv"][:, 1:])


def test_chunked_scan_carries_state_across_chunks():
    """Two chunks of 8 equal one chunk of 16 (the state carried between
    chunks), within 1e-5 of max|value| (the fold regroups the products;
    measured at most 9.6e-8)."""
    rng = np.random.default_rng(3)
    x, dt = (torch.from_numpy(rng.uniform(0.1, 1.0, (2, 16, 6))
                              .astype(np.float32)) for _ in range(2))
    bm, cm = (torch.from_numpy(rng.normal(size=(2, 16, 4))
                               .astype(np.float32)) for _ in range(2))
    a_mat = -torch.from_numpy(rng.uniform(0.5, 2.0, (6, 4))
                              .astype(np.float32))
    d = torch.ones(6)
    h0 = torch.from_numpy(rng.normal(size=(2, 6, 4)).astype(np.float32))
    y16, h16 = TS._mamba_scan(x, dt, bm, cm, a_mat, d, h0, chunk=16)
    y8, h8 = TS._mamba_scan(x, dt, bm, cm, a_mat, d, h0, chunk=8)
    _close(y8, y16.numpy(), 1e-5)
    _close(h8, h16.numpy(), 1e-5)
    with pytest.raises(AssertionError):
        TS._mamba_scan(x[:, :12], dt[:, :12], bm[:, :12], cm[:, :12],
                       a_mat, d, h0, chunk=8)


# ---------------------------------------------------------------------------
# Eager prefill / decode and ServeEngine against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serve(ssm):
    """The reference ServeEngine on the w8a8 tree: the greedy ids of 4
    requests through 2 slots, then (reusing its jitted executables) one
    prefill of the token batch, the merge into a run cache and STEPS
    decode steps fed their own greedy ids."""
    e = JServe(ssm["arch_j"], ssm["qj"], J_W8, **_engine_kw())
    ids = e.generate(_prompts(ssm["arch_j"]), max_new_tokens=NEW)
    logits, fresh = e.jprefill(e.params, e._empty_cache(),
                               {"tokens": jnp.asarray(ssm["toks"])})
    cache = e.jmerge(e._run_cache(B), fresh, jnp.ones(B, bool))
    out = [np.asarray(logits[:, -1])]
    cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    for _ in range(STEPS):
        logits, cache = e.jdecode(e.params, cache, cur)
        out.append(np.asarray(logits[:, -1]))
        cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    return dict(ids=ids, logits=out, stats=e.stats())


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_prefill_decode_logits_match_reference(ssm, jax_serve, backend):
    """T.prefill on a fresh cache, the serving merge (conv state rounded
    to the live cache's bf16) and STEPS T.decode steps, each fed the
    reference's greedy ids: logits within 2% of max|logit| on every step
    (measured: at most 6.1e-7 of max|logit|, max|logit| 3.0-3.7) and the
    greedy ids identical."""
    arch, eng = ssm["arch_t"], ENGS[backend]
    cache = TT.zeros_from_schema(TT.cache_schema(arch, B, MAX_SEQ, eng),
                                 "cpu")
    run = TT.zeros_from_schema(TT.cache_schema(arch, B, MAX_SEQ, eng), "cpu")
    run["pos"] = torch.zeros(B, dtype=torch.int32)
    with torch.inference_mode():
        logits, fresh = TT.prefill(ssm["qt"], cache,
                                   {"tokens": torch.from_numpy(ssm["toks"])},
                                   arch, eng)
        cache = t_serve._merge(run, fresh, torch.ones(B, dtype=torch.bool))
        assert cache["layers"][0]["conv"].dtype == torch.bfloat16
        got = [logits[:, -1].numpy()]
        for step in range(STEPS):
            cur = torch.from_numpy(np.argmax(jax_serve["logits"][step], -1)
                                   [:, None].astype(np.int32))
            logits, cache = TT.decode(ssm["qt"], cache, cur, arch, eng)
            got.append(logits[:, -1].numpy())
        assert cache["layers"][0]["conv"].dtype == torch.float32
        assert cache["pos"].tolist() == [PLEN + STEPS] * B
    for g, w in zip(got, jax_serve["logits"]):
        assert g.shape == w.shape and np.isfinite(g).all()
        gap = np.abs(g - w).max()
        assert gap <= 0.02 * np.abs(w).max(), (gap, np.abs(w).max())
        np.testing.assert_array_equal(np.argmax(g, -1), np.argmax(w, -1))


def test_forward_equals_prefill_last_logits(ssm):
    """T.forward's last-token logits equal T.prefill's within 1e-5 of
    max|logit| (measured 3.5e-7): the mixer runs the same arithmetic with
    and without state, but the head's f32 GEMM over L rows and over the
    last row alone blocks its sums differently."""
    arch, eng = ssm["arch_t"], ENGS["ref"]
    toks = torch.from_numpy(ssm["toks"])
    cache = TT.zeros_from_schema(TT.cache_schema(arch, B, MAX_SEQ, eng),
                                 "cpu")
    with torch.inference_mode():
        full, aux = TT.forward(ssm["qt"], {"tokens": toks}, arch, eng)
        last, _ = TT.prefill(ssm["qt"], cache, {"tokens": toks}, arch, eng)
    assert full.shape == (B, PLEN, arch.vocab_size) and float(aux) == 0.0
    _close(full[:, -1:], last.numpy(), 1e-5)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_serve_engine_ids_match_reference(ssm, jax_serve, backend):
    """4 requests x 4 greedy tokens through 2 slots on the dense eager
    path (the second wave's merge lands on a decoded, f32 conv state): the
    port's ids equal the reference engine's, on backend="ref" and on the
    CUDA backend's dispatch with CPU tensors."""
    e = TServe(ssm["arch_t"], ssm["pt"], ENGS[backend], device="cpu",
               **_engine_kw())
    got = e.generate(_prompts(ssm["arch_t"]), max_new_tokens=NEW)
    for g, w in zip(got, jax_serve["ids"]):
        np.testing.assert_array_equal(g, np.asarray(w))
    st = e.stats()
    assert st["requests"] == 4 and st["slot_refills"] == 2
    assert st["compiled_prefill"] is False and st["compiled_decode"] is False


# ---------------------------------------------------------------------------
# The engine's eager-path contract
# ---------------------------------------------------------------------------

def test_paged_kv_refused_on_eager_arch(ssm):
    """As in the reference, paged KV needs the compiled programs."""
    with pytest.raises(ValueError, match="compiled"):
        TServe(ssm["arch_t"], ssm["pt"], ENGS["ref"], device="cpu",
               kv_layout="paged", **_engine_kw())
    with pytest.raises(ValueError, match="paged"):
        JServe(ssm["arch_j"], ssm["qj"], J_W8, kv_layout="paged",
               **_engine_kw())


def test_stats_lowering_blockers_match_reference(ssm, jax_serve):
    e = TServe(ssm["arch_t"], ssm["pt"], ENGS["ref"], device="cpu",
               **_engine_kw())
    assert e.stats()["lowering_blockers"] == \
        jax_serve["stats"]["lowering_blockers"] == \
        ["non-attention mixers ['mamba']", "no MLP half"]
    assert e.stats()["kv_bytes"] == jax_serve["stats"]["kv_bytes"] == 0.0


def test_no_calibration_digest_when_eager(ssm):
    """Calibration batches feed only the compiled static programs: with
    both paths eager no digest of the float tree is taken."""
    e = TServe(ssm["arch_t"], ssm["pt"], ENGS["ref"], device="cpu",
               calib_batches=[ssm["toks"]], **_engine_kw())
    assert e.calib_id is None and e.calib_batches is None
    assert e.digest_s == 0.0


def test_cuda_backend_on_cpu_launches_nothing(ssm):
    """On CPU tensors the CUDA backend runs the plain versions: no kernel
    launch is counted on the eager path."""
    _build.reset_counts()
    e = TServe(ssm["arch_t"], ssm["pt"], ENGS["cuda"], device="cpu",
               **_engine_kw())
    e.generate(_prompts(ssm["arch_t"])[:2], max_new_tokens=2)
    assert _build.COUNTS == {}


def test_unported_eager_paths_raise(ssm):
    """Recurrent layers, MoE and eager attention layers name their later
    slice; the compiled attention archs are untouched."""
    arch = ssm["arch_t"]
    for kw in (dict(block_pattern=("mamba", "recurrent")),
               dict(block_pattern=("mamba", "global")),
               dict(n_experts=4)):
        bad = dataclasses.replace(arch, **kw)
        with pytest.raises(NotImplementedError, match="not ported"):
            TT.check_eager(bad)
    with pytest.raises(NotImplementedError, match="recurrentgemma"):
        TT.cache_schema(dataclasses.replace(
            arch, block_pattern=("recurrent",)), B, MAX_SEQ, ENGS["ref"])


# ---------------------------------------------------------------------------
# Config, schemas and quantization
# ---------------------------------------------------------------------------

def test_falcon_mamba_arch_config_matches_reference(ssm):
    """The port's falcon-mamba-7b (full and reduced) carries the
    reference's values in every field both configs have, d_inner
    included, with the same layer kinds and lowering blockers."""
    for t, j in ((t_configs.get_arch(ARCH), j_configs.get_arch(ARCH)),
                 (ssm["arch_t"], ssm["arch_j"])):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.d_inner == j.d_inner
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]
        assert tc.lowering_blockers(t) == jc.lowering_blockers(j) != []
    assert TS.mamba_dt_rank(t_configs.get_arch(ARCH)) == 256


def test_schemas_match_reference(ssm):
    """Parameter and cache schemas: the reference's tree, shapes and
    dtypes (conv state bf16, ssm state f32)."""
    arch_t, arch_j = ssm["arch_t"], ssm["arch_j"]

    def shapes(tree, is_leaf, name):
        return jax.tree_util.tree_map(
            lambda s: (tuple(s.shape), name(s.dtype)), tree, is_leaf=is_leaf)

    def port(tree):
        return shapes(tree, lambda s: hasattr(s, "shape"),
                      lambda d: str(d).replace("torch.", ""))

    def ref(tree):
        return shapes(tree, lambda s: hasattr(s, "axes"),
                      lambda d: jnp.dtype(d).name)

    ts, js = port(TT.lm_schema(arch_t)), ref(JT.lm_schema(arch_j))
    assert ts == js
    tcs = port(TT.cache_schema(arch_t, B, MAX_SEQ, ENGS["ref"]))
    jcs = ref(JT.cache_schema(arch_j, B, MAX_SEQ, J_W8))
    assert tcs == jcs
    assert tcs["layers"][0] == {"conv": ((B, 3, 256), "bfloat16"),
                                "ssm": ((B, 256, 16), "float32")}


def test_quantized_tree_matches_reference(ssm):
    """quantize_params turns exactly the leaves the reference's
    quantize_schema marks into QTensors, on its axes (in_proj, x_proj,
    dt_proj, out_proj and the head per output column, the embedding per
    row); conv_w, a_log, dt_bias, d_skip and the norms stay float, and the
    port's quantize_schema describes the same tree.  x_proj's codes and
    scales are bitwise the reference's eager quantize (the CNN slice holds
    quantize_params bitwise on every CNN weight)."""
    jschema = j_eng.quantize_schema(JT.lm_schema(ssm["arch_j"]), J_W8)
    tschema = t_eng.quantize_schema(TT.lm_schema(ssm["arch_t"]), ENGS["ref"])
    is_q = (t_quant.QTensor, j_quant.QTensor)

    def layout(tree):
        return jax.tree_util.tree_map(
            lambda x: (("q", tuple(x.scale.shape)) if isinstance(x, is_q)
                       else ("f", tuple(x.shape))),
            tree, is_leaf=lambda x: isinstance(x, is_q))

    want = layout(jschema)
    assert layout(ssm["qt"]) == layout(tschema) == want
    mixer = want["blocks"][0]["mixer"]
    assert {k for k, v in mixer.items() if v[0] == "q"} == {
        "in_proj", "x_proj", "dt_proj", "out_proj"}
    assert want["head"] == ("q", (1, 512)) and \
        want["embed"] == ("q", (512, 1))
    qj = j_quant.quantize(ssm["pj"]["blocks"][0]["mixer"]["x_proj"], axis=1)
    qt = ssm["qt"]["blocks"][0]["mixer"]["x_proj"]
    np.testing.assert_array_equal(_np(qt.q), np.asarray(qj.q))
    np.testing.assert_array_equal(_np(qt.scale), np.asarray(qj.scale))
