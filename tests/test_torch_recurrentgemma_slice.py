"""The eager recurrentgemma serving slice of the port against the JAX
reference, on the CPU.

The model is the reduced recurrentgemma-2b (`configs.reduced`: 3 layers
in the pattern recurrent, recurrent, local; d 128, lru_width 128, 4 / 1
heads of 32, window 64, d_ff 256 GeGLU, vocab 512, tied and scaled
embeddings) on seeded numpy weights handed to both sides
(`bridge.params_from_numpy`), served under quant="w8a8": every projection
runs the int8 Conv PE with per-token activation scales (in_gate and the
GeGLU gate with the fused tanh-gelu), the RG-LRU's temporal conv the DWC
PE's causal 1-D conv with act none.

  * `linear_scan_chunked` with h0 over several chunks against the
    reference's (f32 rounding: a left fold against a tree);
  * the gelu projection (`ops.linear(..., "gelu")`) on both backends
    against the reference's `ref.matmul_int8_fused` and its Pallas kernel
    in interpret mode;
  * `rglru_apply` (with state) and `rglru_decode` under quant none and
    w8a8 on identical inputs; under w8a8 the conv state (the in_x tail)
    is bitwise the reference's;
  * eager `T.prefill` + 4 `T.decode` steps through the serving merge,
    against the reference engine's jitted prefill / merge / decode:
    logits within 2% of max|logit|, greedy ids identical;
  * the port's ServeEngine ids equal the reference ServeEngine's (dense,
    2 slots, 4 requests of 40-48 prompt tokens and NEW new ones, so the
    64-slot ring of the local layer wraps and slots refill), on both
    backends;
  * `T.forward` runs the recurrent blocks; schemas, the quantized tree and
    recurrentgemma-2b's ArchConfig, full and reduced, are the reference's.

The JAX side runs once per module, jitted where the reference's engine
jits; the bitwise conv-state check runs the reference's in_x projection
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
from repro_torch.kernels import _build, conv_pe
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as t_serve
from repro_torch.serve.engine import ServeEngine as TServe

from test_torch_cnn_slice import _numpy_params
from test_torch_ssm_slice import _close, _jax_tree, _np, _t

ARCH = "recurrentgemma-2b"
B, PLEN, MAX_SEQ, STEPS, NEW = 2, 48, 128, 4, 24
EAGER_STEPS = 2          # decode steps the reference also runs eagerly
J_W8 = JEng(quant="w8a8", backend="ref")
ENGS = {"ref": TEng(quant="w8a8", backend="ref"),
        "cuda": TEng(quant="w8a8", backend="cuda")}   # plain versions on CPU


def _prompts(arch):
    rng = np.random.default_rng(7)
    return [rng.integers(0, arch.vocab_size, size=n).astype(np.int32)
            for n in (40, 48, 44, 41)]


def _engine_kw():
    return dict(batch_size=B, max_seq=MAX_SEQ, prefill_len=PLEN,
                decode_burst=4)


@pytest.fixture(scope="module")
def rg():
    """Both archs, seeded numpy weights on both sides, the port's w8a8
    tree (handed to the reference engine, which passes QTensor leaves
    through) and one token batch."""
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
# The chunked scan and the gelu projection
# ---------------------------------------------------------------------------

def test_linear_scan_chunked_matches_reference():
    """h_t = a_t h_{t-1} + b_t from a nonzero h0 over three chunks of 16
    (the state carried between chunks) against the reference's jitted
    scan: within 1e-5 of max|h| (the fold and the reference's tree
    associate the products differently; measured 1.2e-7), and the three
    chunks within 1e-5 of one chunk of 48."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, (2, 48, 24)).astype(np.float32)
    b = rng.normal(size=(2, 48, 24)).astype(np.float32)
    h0 = rng.normal(size=(2, 24)).astype(np.float32)
    scan = jax.jit(lambda a, b, h: JS.linear_scan_chunked(a, b, h, 16))
    want_all, want_last = (np.asarray(t) for t in scan(a, b, h0))
    got_all, got_last = TS.linear_scan_chunked(_t(a), _t(b), _t(h0), 16)
    assert got_all.dtype == torch.float32 and got_last.shape == (2, 24)
    _close(got_all, want_all, 1e-5)
    _close(got_last, want_last, 1e-5)
    one_all, one_last = TS.linear_scan_chunked(_t(a), _t(b), _t(h0), 48)
    _close(got_all, one_all.numpy(), 1e-5)
    _close(got_last, one_last.numpy(), 1e-5)
    with pytest.raises(AssertionError):
        TS.linear_scan_chunked(_t(a[:, :40]), _t(b[:, :40]), _t(h0), 16)


@pytest.fixture(scope="module")
def gelu_jax(rg):
    """Layer 0's in_gate projection with its fused gelu, on the reference:
    `ref.matmul_int8_fused` on the port's per-token codes and the Pallas
    kernel in interpret mode through ops.linear (which quantizes the same
    rows and pads them to the kernel's blocks)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 8, rg["arch_t"].d_model)).astype(np.float32)
    w = rg["qj"]["blocks"][0]["mixer"]["in_gate"]
    xq = t_quant.quantize_act_dynamic(_t(x).reshape(-1, x.shape[-1]),
                                      per_token=True)
    codes = dict(a=_np(xq.q), a_scale=_np(xq.scale))
    plain = j_ref.matmul_int8_fused(
        jnp.asarray(codes["a"]), w.q, jnp.asarray(codes["a_scale"]),
        w.scale, None, "gelu")
    pallas = j_ops.linear(jnp.asarray(x), w, None, "gelu",
                          JEng(quant="w8a8", backend="pallas",
                               interpret=True))
    return dict(x=x, codes=codes, plain=np.asarray(plain),
                pallas=np.asarray(pallas))


def test_gelu_projection_matches_reference(rg, gelu_jax):
    """ops.linear(..., "gelu") on the ref and CUDA backends (CPU tensors:
    the plain version, torch's F.gelu(approximate="tanh")) against the
    reference's ref.matmul_int8_fused with gelu on the same codes and its
    Pallas kernel in interpret mode: within 2e-6 of max|out| (torch's and
    JAX's tanh-gelu differ at the ulp: JAX forms x * 0.5 * (1 + tanh(.))
    with its own tanh; measured at most 2.4e-7).  The port's plain int8
    GEMM with gelu equals ops.linear bit for bit, and the int8 Conv PE
    wrapper takes gelu where the other epilogues refuse it."""
    w = rg["qt"]["blocks"][0]["mixer"]["in_gate"]
    x = _t(gelu_jax["x"])
    n = w.q.shape[-1]
    outs = [t_ops.linear(x, w, None, "gelu", eng) for eng in ENGS.values()]
    direct = t_ref.matmul_int8_fused(
        _t(gelu_jax["codes"]["a"], torch.int8), w.q,
        _t(gelu_jax["codes"]["a_scale"]), w.scale.reshape(1, n), None,
        "gelu")
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())
    np.testing.assert_array_equal(outs[0].reshape(-1, n).numpy(),
                                  direct.numpy())
    for want in (gelu_jax["plain"].reshape(outs[0].shape),
                 gelu_jax["pallas"]):
        assert want.shape == outs[0].shape
        _close(outs[0], want, 2e-6)
    assert _build.act_code("gelu", _build.GEMM_ACTS) == 3
    with pytest.raises(ValueError, match="gelu"):
        _build.act_code("gelu")
    assert conv_pe.matmul_int8_fused(
        _t(gelu_jax["codes"]["a"], torch.int8), w.q,
        _t(gelu_jax["codes"]["a_scale"]), w.scale, None, "gelu").equal(
            direct)


# ---------------------------------------------------------------------------
# The RG-LRU mixer
# ---------------------------------------------------------------------------

def _mixer_inputs(arch):
    """x [B, L, d] and x1 [B, 1, d] (bf16 values, as f32 arrays) and a
    nonzero recurrent state h0."""
    rng = np.random.default_rng(11)
    x, x1 = (torch.from_numpy(rng.normal(size=(B, n, arch.d_model))
                              .astype(np.float32)).to(torch.bfloat16)
             .float().numpy() for n in (PLEN, 1))
    h0 = (rng.normal(size=(B, arch.lru_width)) * 0.5).astype(np.float32)
    return x, x1, h0


@pytest.fixture(scope="module")
def mixer_jax(rg):
    """The reference's rglru_apply (with state) and rglru_decode on layer
    0's mixer, jitted, under quant none and w8a8; the decode step starts
    from the apply's state with the conv state rounded to bf16 (what the
    serving merge stores).  Under w8a8 also the reference's in_x run
    eagerly: rglru_apply's conv state is its last k-1 rows."""
    arch = rg["arch_j"]
    x, x1, h0 = _mixer_inputs(arch)
    x, x1 = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, x1))
    k = arch.conv_kernel
    out = {}
    for quant in ("none", "w8a8"):
        eng = JEng(quant=quant, backend="ref")
        p = (rg["qj"] if quant == "w8a8" else rg["pj"])["blocks"][0][
            "mixer"]
        st0 = {"conv": jnp.zeros((B, k - 1, arch.lru_width), jnp.bfloat16),
               "rec": jnp.asarray(h0)}
        apply = jax.jit(lambda p, x, st: JS.rglru_apply(p, x, arch, eng,
                                                        state=st))
        decode = jax.jit(lambda p, x, st: JS.rglru_decode(p, x, arch, eng,
                                                          st))
        y, st = apply(p, x, st0)
        st_dec = {"conv": st["conv"].astype(jnp.bfloat16), "rec": st["rec"]}
        y1, st1 = decode(p, x1, st_dec)
        res = dict(y=_np(y), conv=_np(st["conv"]), rec=np.asarray(st["rec"]),
                   y1=_np(y1), conv1=_np(st1["conv"]),
                   rec1=np.asarray(st1["rec"]),
                   dec_in={k_: _np(v) for k_, v in st_dec.items()})
        if quant == "w8a8":
            res["eager_conv"] = np.asarray(j_ops.linear(
                x, p["in_x"], None, "none", eng)[:, -(k - 1):])
            res["eager_col"] = np.asarray(j_ops.linear(
                x1, p["in_x"], None, "none", eng))
        out[quant] = res
    return out


@pytest.mark.parametrize("quant", ["none", "w8a8"])
def test_rglru_mixer_matches_reference(rg, mixer_jax, quant):
    """rglru_apply with a nonzero recurrent state and the decode step after
    it, on identical inputs, against the reference jitted.  The scan folds
    left to right where the reference combines in a tree, torch's sigmoid
    / softplus / tanh-gelu round apart from XLA's, and under w8a8 such an
    ulp can flip one int8 code of a dynamically quantized projection
    input, which moves an output by one code step.  Under none every
    projection, the gelu and the gated output round to bf16 (an ulp is
    2^-8 relative), so the outputs are held within 2e-2 of their
    max|value| there and within 2e-3 under w8a8; the states within 1e-3.
    Measured: under none the outputs within 6.8e-3 / 3.4e-3 (prefill /
    decode: one or two bf16 ulps) and the states within 1.1e-7; under w8a8
    the outputs within 5.2e-8 and the states within 2.1e-7.  Under w8a8
    the conv state -- the in_x tail after apply, the
    window's last k-1 rows after decode -- is bitwise the reference's
    eager in_x, since dynamic quantization and the int8 GEMM are exact."""
    arch, want = rg["arch_t"], mixer_jax[quant]
    eng = TEng(quant=quant, backend="ref")
    p = (rg["qt"] if quant == "w8a8" else rg["pt"])["blocks"][0]["mixer"]
    x, x1, h0 = _mixer_inputs(arch)
    st0 = {"conv": torch.zeros((B, arch.conv_kernel - 1, arch.lru_width),
                               dtype=torch.bfloat16), "rec": _t(h0)}
    y, st = TS.rglru_apply(p, _t(x, torch.bfloat16), arch, eng, state=st0)
    dec_in = {"conv": _t(want["dec_in"]["conv"], torch.bfloat16),
              "rec": _t(want["dec_in"]["rec"])}
    y1, st1 = TS.rglru_decode(p, _t(x1, torch.bfloat16), arch, eng, dec_in)
    for got, key in ((y, "y"), (st["conv"], "conv"), (st["rec"], "rec"),
                     (y1, "y1"), (st1["conv"], "conv1"), (st1["rec"], "rec1")):
        out_tol = 2e-2 if quant == "none" else 2e-3
        _close(got, want[key], out_tol if key.startswith("y") else 1e-3)
    if quant == "w8a8":
        assert st["conv"].dtype == torch.float32
        np.testing.assert_array_equal(_np(st["conv"]), want["eager_conv"])
        np.testing.assert_array_equal(_np(st1["conv"][:, -1:]),
                                      want["eager_col"])
        np.testing.assert_array_equal(_np(st1["conv"][:, :-1]),
                                      want["dec_in"]["conv"][:, 1:])
    else:
        assert st["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Eager prefill / decode and ServeEngine against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serve(rg):
    """The reference ServeEngine on the w8a8 tree: the greedy ids of 4
    requests through 2 slots, then (reusing its jitted executables) one
    prefill of the token batch, the merge into a run cache and STEPS
    decode steps fed their own greedy ids; and the same prefill, merge and
    EAGER_STEPS decode steps run eagerly (`T.prefill` / `T.decode`, the
    programs the engine jits)."""
    e = JServe(rg["arch_j"], rg["qj"], J_W8, **_engine_kw())
    ids = e.generate(_prompts(rg["arch_j"]), max_new_tokens=NEW)
    batch = {"tokens": jnp.asarray(rg["toks"])}
    logits, fresh = e.jprefill(e.params, e._empty_cache(), batch)
    cache = e.jmerge(e._run_cache(B), fresh, jnp.ones(B, bool))
    out = [np.asarray(logits[:, -1])]
    cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    for _ in range(STEPS):
        logits, cache = e.jdecode(e.params, cache, cur)
        out.append(np.asarray(logits[:, -1]))
        cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    logits, fresh = JT.prefill(e.params, e._empty_cache(), batch,
                               rg["arch_j"], J_W8)
    cache = e.jmerge(e._run_cache(B), fresh, jnp.ones(B, bool))
    eager = [np.asarray(logits[:, -1])]
    for step in range(EAGER_STEPS):
        cur = jnp.asarray(np.argmax(out[step], -1)[:, None].astype(np.int32))
        logits, cache = JT.decode(e.params, cache, cur, rg["arch_j"], J_W8)
        eager.append(np.asarray(logits[:, -1]))
    return dict(ids=ids, logits=out, eager=eager, stats=e.stats())


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_prefill_decode_logits_match_reference(rg, jax_serve, backend):
    """T.prefill on a fresh cache, the serving merge (the RG-LRU conv
    state and the ring's k / v rounded to the live cache's bf16) and STEPS
    T.decode steps, each fed the reference's greedy ids, against the
    reference run eagerly (the prefill and EAGER_STEPS steps) and jitted
    (every step): greedy ids identical to both; logits within 2% of
    max|logit| of the eager run (measured: at most 3.7e-7) and
    within 3% of the jitted one (measured: at most 2.34%).  The reference's
    own jitted and eager runs are as far apart as the port is from the
    jitted one: under jit XLA keeps the first block's bf16 dynamic-quant
    scales (amax / 127 of bf16 rows) in f32 and multiplies by reciprocals
    where the eager run divides, which moves int8 codes of the first
    projections."""
    arch, eng = rg["arch_t"], ENGS[backend]
    schema = TT.cache_schema(arch, B, MAX_SEQ, eng)
    cache = TT.zeros_from_schema(schema, "cpu")
    run = TT.zeros_from_schema(schema, "cpu")
    run["pos"] = torch.zeros(B, dtype=torch.int32)
    with torch.inference_mode():
        logits, fresh = TT.prefill(rg["qt"], cache,
                                   {"tokens": torch.from_numpy(rg["toks"])},
                                   arch, eng)
        cache = t_serve._merge(run, fresh, torch.ones(B, dtype=torch.bool))
        assert cache["layers"][0]["conv"].dtype == torch.bfloat16
        assert cache["layers"][2]["k"].shape == (B, arch.local_window, 1, 32)
        got = [logits[:, -1].numpy()]
        for step in range(STEPS):
            cur = torch.from_numpy(np.argmax(jax_serve["logits"][step], -1)
                                   [:, None].astype(np.int32))
            logits, cache = TT.decode(rg["qt"], cache, cur, arch, eng)
            got.append(logits[:, -1].numpy())
        assert cache["layers"][0]["conv"].dtype == torch.float32
        assert cache["pos"].tolist() == [PLEN + STEPS] * B
    for wants, tol in ((jax_serve["eager"], 0.02), (jax_serve["logits"],
                                                    0.03)):
        for g, w in zip(got, wants):
            assert g.shape == w.shape and np.isfinite(g).all()
            gap = np.abs(g - w).max()
            assert gap <= tol * np.abs(w).max(), (gap, np.abs(w).max())
            np.testing.assert_array_equal(np.argmax(g, -1),
                                          np.argmax(w, -1))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_serve_engine_ids_match_reference(rg, jax_serve, backend):
    """4 requests of 40-48 prompt tokens x NEW greedy tokens through 2
    slots on the dense eager path: positions reach 72, past the local
    layer's 64-slot ring, and the second wave's merge lands on decoded
    state.  The port's ids equal the reference engine's, on backend="ref"
    and on the CUDA backend's dispatch with CPU tensors, which launches no
    kernel."""
    arch = rg["arch_t"]
    assert PLEN + NEW > arch.local_window
    _build.reset_counts()
    e = TServe(arch, rg["pt"], ENGS[backend], device="cpu", **_engine_kw())
    got = e.generate(_prompts(arch), max_new_tokens=NEW)
    assert _build.COUNTS == {}
    for g, w in zip(got, jax_serve["ids"]):
        np.testing.assert_array_equal(g, np.asarray(w))
    st = e.stats()
    assert st["requests"] == 4 and st["slot_refills"] == 2
    assert st["compiled_prefill"] is False and st["compiled_decode"] is False
    assert st["lowering_blockers"] == \
        jax_serve["stats"]["lowering_blockers"] == \
        ["non-attention mixers ['recurrent']"]


def test_forward_equals_prefill_last_logits(rg):
    """T.forward runs the recurrent blocks (stateless) and the local
    layer's windowed attention: its last-token logits equal T.prefill's
    within 1e-5 of max|logit| (the head's f32 GEMM over L rows and over
    the last row alone blocks its sums differently)."""
    arch, eng = rg["arch_t"], ENGS["ref"]
    toks = torch.from_numpy(rg["toks"])
    cache = TT.zeros_from_schema(TT.cache_schema(arch, B, MAX_SEQ, eng),
                                 "cpu")
    with torch.inference_mode():
        full, aux = TT.forward(rg["qt"], {"tokens": toks}, arch, eng)
        last, _ = TT.prefill(rg["qt"], cache, {"tokens": toks}, arch, eng)
    assert full.shape == (B, PLEN, arch.vocab_size) and float(aux) == 0.0
    _close(full[:, -1:], last.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# Config, schemas and quantization
# ---------------------------------------------------------------------------

def test_recurrentgemma_arch_config_matches_reference(rg):
    """The port's recurrentgemma-2b (full and reduced) carries the
    reference's values in every field both configs have, lru_width
    included (0 becomes d_model in the hybrid family), with the same layer
    kinds and lowering blockers."""
    for t, j in ((t_configs.get_arch(ARCH), j_configs.get_arch(ARCH)),
                 (rg["arch_t"], rg["arch_j"])):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert [t.layer_kind(i) for i in range(t.n_layers)] == \
            [j.layer_kind(i) for i in range(j.n_layers)]
        assert tc.lowering_blockers(t) == jc.lowering_blockers(j) != []
    assert rg["arch_t"].lru_width == 128
    assert t_configs.get_arch(ARCH).lru_width == 2560
    hybrid = dataclasses.replace(t_configs.get_arch(ARCH), lru_width=0)
    assert hybrid.lru_width == hybrid.d_model


def test_schemas_match_reference(rg):
    """Parameter and cache schemas: the reference's tree, shapes and
    dtypes (the RG-LRU's conv state bf16 and rec f32; the local layer's
    ring of the window)."""
    arch_t, arch_j = rg["arch_t"], rg["arch_j"]

    def shapes(tree, is_leaf, name):
        return jax.tree_util.tree_map(
            lambda s: (tuple(s.shape), name(s.dtype)), tree, is_leaf=is_leaf)

    def port(tree):
        return shapes(tree, lambda s: hasattr(s, "shape"),
                      lambda d: str(d).replace("torch.", ""))

    def ref(tree):
        return shapes(tree, lambda s: hasattr(s, "axes"),
                      lambda d: jnp.dtype(d).name)

    assert port(TT.lm_schema(arch_t)) == ref(JT.lm_schema(arch_j))
    tcs = port(TT.cache_schema(arch_t, B, MAX_SEQ, ENGS["ref"]))
    assert tcs == ref(JT.cache_schema(arch_j, B, MAX_SEQ, J_W8))
    assert tcs["layers"][0] == {"conv": ((B, 3, 128), "bfloat16"),
                                "rec": ((B, 128), "float32")}
    assert tcs["layers"][2]["k"] == ((B, 64, 1, 32), "bfloat16")


def test_quantized_tree_matches_reference(rg):
    """quantize_params turns exactly the leaves the reference's
    quantize_schema marks into QTensors: the RG-LRU's in_x, in_gate and
    out_proj, the attention and MLP projections and the tied embedding;
    the block-diagonal gate weights, lam and the conv stay float (bridged
    unchanged, as the reference keeps them)."""
    jschema = j_eng.quantize_schema(JT.lm_schema(rg["arch_j"]), J_W8)
    tschema = t_eng.quantize_schema(TT.lm_schema(rg["arch_t"]), ENGS["ref"])
    is_q = (t_quant.QTensor, j_quant.QTensor)

    def layout(tree):
        return jax.tree_util.tree_map(
            lambda x: (("q", tuple(x.scale.shape)) if isinstance(x, is_q)
                       else ("f", tuple(x.shape))),
            tree, is_leaf=lambda x: isinstance(x, is_q))

    want = layout(jschema)
    assert layout(rg["qt"]) == layout(tschema) == want
    mixer = want["blocks"][0]["mixer"]
    assert {k for k, v in mixer.items() if v[0] == "q"} == {
        "in_x", "in_gate", "out_proj"}
    assert mixer["gate_in_w"] == ("f", (4, 32, 32))
    for key in ("gate_in_w", "gate_rec_w", "lam", "conv_w"):
        np.testing.assert_array_equal(
            _np(rg["qt"]["blocks"][1]["mixer"][key]),
            rg["params"]["blocks"][1]["mixer"][key])
    assert want["embed"] == ("q", (512, 1)) and "head" not in want
