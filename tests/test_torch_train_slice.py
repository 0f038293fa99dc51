"""The training slice of the port against the JAX reference, on the CPU.

The model is the reduced qwen2-1.5b (`configs.reduced`: 2 global layers, d
128, 4 / 1 heads of 32, QKV bias, SwiGLU d_ff 256, vocab 512, tied
embeddings) on seeded numpy weights handed to both sides
(`bridge.params_from_numpy` / `bridge.train_state_from_numpy`).

  * the plain float GEMM (`ref.matmul_f_fused`) against the reference's
    Pallas `matmul_f_fused` in interpret mode (f32 and bf16 operands, with
    and without bias, acts none / silu / gelu);
  * the autograd Function `conv_pe.MatmulF` (the kernel's gradient; its
    plain versions on CPU tensors) against autograd through the plain
    version, for every act;
  * `T.forward` at f32 compute on both backends against the reference's,
    remat none and block;
  * one and two train steps at bf16 compute against the reference's
    jitted step (metrics and the updated parameters), the port's
    microbatches 1 and 2;
  * `SyntheticTokens` bit for bit the reference's;
  * `launch.train.main` with checkpoints and --resume (a leftover `.tmp`
    directory ignored), and a checkpoint round trip;
  * `EngineConfig(quant="none", backend="cuda")` constructs and calibration
    still refuses it.

The JAX side runs once per module and is jitted (its train step compiles
in ~2.4 s); nothing here launches a kernel or changes process state.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as j_configs
from repro.core import engine as j_eng
from repro.core.config import ShapeConfig as JShape
from repro.core.config import TrainConfig as JTrain
from repro.data import pipeline as j_pipe
from repro.kernels import conv_pe as j_conv_pe
from repro.models import transformer as JT
from repro.train import train_step as j_ts

from repro_torch import bridge
from repro_torch import compiler as tc
from repro_torch import configs as t_configs
from repro_torch.core import engine as t_eng
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.core.config import ShapeConfig as TShape
from repro_torch.core.config import TrainConfig as TTrain
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import _build, conv_pe, ref
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import train_step as t_ts
from repro_torch.train import tree

from test_torch_cnn_slice import _numpy_params

ARCH = "qwen2-1.5b"
B, L = 4, 32
TCFG = dict(lr=3e-4, total_steps=8, warmup_steps=1, remat="none")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    """max |got - want| / max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def lm():
    """Both archs, seeded numpy weights, the reference's initial train
    state as numpy (m, v zeros, step 0) and two batches of its pipeline."""
    arch_t = t_configs.reduced(t_configs.get_arch(ARCH))
    arch_j = j_configs.reduced(j_configs.get_arch(ARCH))
    params = _numpy_params(TT.lm_schema(arch_t), np.random.default_rng(0))
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    state_np = jax.tree_util.tree_map(np.asarray, j_ts.init_train_state(pj))
    pipe = j_pipe.SyntheticTokens(arch_j, JShape("t", L, B, "train"))
    return dict(arch_t=arch_t, arch_j=arch_j, params=params, pj=pj,
                state_np=state_np, batches=[pipe.batch_at(s) for s in (0, 1)])


@pytest.fixture(scope="module")
def jax_steps(lm):
    """The reference's jitted train step (microbatches 1), two steps from
    the initial state: [(metrics, params) after each step]."""
    step = jax.jit(j_ts.make_train_step(lm["arch_j"], j_eng.train_engine(),
                                        JTrain(**TCFG)))
    state = jax.tree_util.tree_map(jnp.asarray, lm["state_np"])
    seq = []
    for batch in lm["batches"]:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        seq.append(({k: float(v) for k, v in m.items()},
                    jax.tree_util.tree_map(np.asarray, state["params"])))
    return seq


# ---------------------------------------------------------------------------
# The float GEMM: plain version vs the Pallas kernel, and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,bias,act", [
    ("float32", True, "none"), ("float32", False, "silu"),
    ("float32", True, "gelu"), ("bfloat16", False, "none"),
    ("bfloat16", True, "silu"), ("bfloat16", False, "gelu")])
def test_plain_matches_pallas_kernel(dtype, bias, act):
    """ref.matmul_f_fused against the reference's `_kernel_f` in interpret
    mode at 128^3 (bk 128, as tests/test_kernels.py runs it): both widen
    to f32 and accumulate in f32 (bf16 products are exact), so they differ
    by the K-sum's order only: within 1e-5 of max|out|."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(128, 128)).astype(np.float32)
    b = rng.normal(size=(128, 128)).astype(np.float32)
    bv = rng.normal(size=128).astype(np.float32) if bias else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_conv_pe.matmul_f_fused(
        jnp.asarray(a).astype(jd), jnp.asarray(b).astype(jd),
        None if bv is None else jnp.asarray(bv), act, bm=128, bn=128,
        bk=128, interpret=True)
    got = ref.matmul_f_fused(
        torch.from_numpy(a).to(td), torch.from_numpy(b).to(td),
        None if bv is None else torch.from_numpy(bv), act)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


def test_plain_on_transposed_views_matches_pallas_kernel():
    """The backward's operands as MatmulF hands them to the kernel: a^T as
    the transposed view of a stored [K, M] and b^T as the view of a stored
    [N, K], bf16, through ref.matmul_f_fused, against the reference's
    Pallas `_kernel_f` on the materialised transposes in interpret mode at
    128^3: within 1e-5 of max|out|."""
    rng = np.random.default_rng(4)
    a_st = rng.normal(size=(128, 128)).astype(np.float32)   # [K, M]
    b_st = rng.normal(size=(128, 128)).astype(np.float32)   # [N, K]
    want = j_conv_pe.matmul_f_fused(
        jnp.asarray(a_st.T).astype(jnp.bfloat16),
        jnp.asarray(b_st.T).astype(jnp.bfloat16), None, "none", bm=128,
        bn=128, bk=128, interpret=True)
    a = torch.from_numpy(a_st).to(torch.bfloat16).t()
    b = torch.from_numpy(b_st).to(torch.bfloat16).t()
    assert not a.is_contiguous() and not b.is_contiguous()
    got = ref.matmul_f_fused(a, b, None, "none")
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


def _grads(fn, a, b, bias, act, out_dtype, dy):
    a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    bias = bias.clone().requires_grad_(True)
    y = fn(a, b, bias, act, out_dtype)
    y.backward(dy)
    return y, a.grad, b.grad, bias.grad


@pytest.mark.parametrize("act", sorted(_build.F_ACT_CODES))
def test_matmul_f_grads_match_autograd(act):
    """The Function's forward and gradients (a recompute of z, dz = dy *
    act'(z), dz @ b^T, a^T @ dz, the column sum) against autograd through
    matmul_f_fused_plain, at ragged f32 shapes: within 1e-6 of max|grad|
    (the same f32 products, the transposes copied); no kernel launches on
    CPU tensors."""
    rng = np.random.default_rng(11)
    m, k, n = 37, 53, 29
    a, b, bias, dy = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                      for s in ((m, k), (k, n), (n,), (m, n)))
    before = dict(_build.COUNTS)
    got = _grads(conv_pe.matmul_f_fused, a, b, bias, act, torch.float32, dy)
    want = _grads(conv_pe.matmul_f_fused_plain, a, b, bias, act,
                  torch.float32, dy)
    assert _build.COUNTS == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _rel(g, w) <= 1e-6


@pytest.mark.parametrize("act", ["none", "silu"])
def test_matmul_f_grads_through_views(act):
    """a and b handed in as transposed views (a^T of a stored [K, M], b^T of
    a stored [N, K], as the backward passes them on), f32, ragged: the
    Function's forward and gradients against autograd through the plain
    version on contiguous copies, within 1e-6 of max|grad|."""
    rng = np.random.default_rng(13)
    m, k, n = 37, 53, 29
    a = torch.from_numpy(rng.normal(size=(k, m)).astype(np.float32)).t()
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).t()
    bias, dy = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for s in ((n,), (m, n)))
    got = _grads(conv_pe.matmul_f_fused, a, b, bias, act, torch.float32, dy)
    want = _grads(conv_pe.matmul_f_fused_plain, a.contiguous(),
                  b.contiguous(), bias, act, torch.float32, dy)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= 1e-6


def test_matmul_f_grads_bf16():
    """bf16 operands and output, act silu: the Function rounds dz to bf16
    before its two products (the kernel's operands), autograd through the
    plain version does not, so da / db agree to bf16 rounding (within
    2^-7 of max|grad|, measured below 2^-8); dbias is the f32 sum of the
    same dz (1e-6)."""
    rng = np.random.default_rng(12)
    m, k, n = 40, 72, 24
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(torch.bfloat16) for s in ((m, k), (k, n)))
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(
        torch.bfloat16)
    got = _grads(conv_pe.matmul_f_fused, a, b, bias, "silu", torch.bfloat16,
                 dy)
    want = _grads(conv_pe.matmul_f_fused_plain, a, b, bias, "silu",
                  torch.bfloat16, dy)
    assert torch.equal(got[0], want[0])
    assert got[1].dtype == got[2].dtype == torch.bfloat16
    assert _rel(got[1], want[1]) <= 2 ** -7
    assert _rel(got[2], want[2]) <= 2 ** -7
    assert _rel(got[3], want[3]) <= 1e-6


def test_matmul_f_rejects_mixed_operands():
    with pytest.raises(ValueError, match="bfloat16"):
        conv_pe.matmul_f_fused(torch.ones(2, 3), torch.ones(
            3, 4, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# The forward and the train step against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f32_logits(lm):
    fwd = jax.jit(lambda p, t: JT.forward(
        p, {"tokens": t}, lm["arch_j"], j_eng.train_engine(),
        compute_dtype=jnp.float32)[0])
    return np.asarray(fwd(lm["pj"], jnp.asarray(lm["batches"][0]["tokens"])))


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_forward_f32_matches_reference(lm, jax_f32_logits, backend, remat):
    """The reduced qwen2 forward at f32 compute (every projection through
    ops.linear_f: torch.matmul on "ref", the float GEMM's plain version on
    "cuda" with CPU tensors) within 1e-5 of max|logit| of the reference's
    jitted forward."""
    pt = bridge.params_from_numpy(lm["params"], device="cpu")
    toks = torch.from_numpy(lm["batches"][0]["tokens"])
    with torch.no_grad():
        logits, aux = TT.forward(pt, {"tokens": toks}, lm["arch_t"],
                                 t_eng.train_engine(backend), remat=remat,
                                 compute_dtype=torch.float32)
    assert logits.shape == (B, L, lm["arch_t"].vocab_size)
    assert float(aux) == 0.0
    assert _rel(logits, jax_f32_logits) <= 1e-5


def test_remat_block_gives_the_same_gradients(lm):
    """remat="block" (torch.utils.checkpoint around each block) recomputes
    the same arithmetic: loss and every gradient bitwise remat="none"'s;
    return_hidden gives the final-norm states the head consumes."""
    pt = bridge.params_from_numpy(lm["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in lm["batches"][0].items()}
    eng = t_eng.train_engine("cuda")
    out = []
    for remat in ("none", "block"):
        fn = t_ts.make_loss_fn(lm["arch_t"], eng,
                               TTrain(**dict(TCFG, remat=remat)))
        out.append(t_ts._value_and_grad(fn, pt, batch))
    (l0, _), g0 = out[0]
    (l1, _), g1 = out[1]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    with torch.no_grad():
        hidden, _ = TT.forward(pt, batch, lm["arch_t"], eng,
                               return_hidden=True)
    assert hidden.shape == (B, L, lm["arch_t"].d_model)
    assert hidden.dtype == torch.bfloat16


# |got - want| / |want| bars of the metrics (measured on both backends and
# microbatch counts: loss 9.5e-5, z_loss 2.3e-5, grad_norm 9.6e-4)
LOSS_TOL, ZLOSS_TOL, GNORM_TOL = 2e-4, 1e-4, 2e-3
# share of parameter elements more than 1e-4 apart after a step (measured
# at most 0.50%)
MOVED_TOL = 0.01


@pytest.mark.parametrize("backend,mb", [("ref", 1), ("cuda", 1),
                                        ("ref", 2)])
def test_train_steps_match_reference(lm, jax_steps, backend, mb):
    """Two AdamW steps at bf16 compute (lr 3e-4, warmup 1, 8 total, clip 1,
    z-loss 1e-4) from one bridged state on the reference pipeline's
    batches 0 and 1; with microbatches=2 the port accumulates two halves'
    gradients and averages their metrics, which equals the reference's
    one-batch step up to rounding (equal halves), so it is held to that
    step at the same bars.  The two frameworks round the bf16 products and the
    elementwise ops at different points (and the CUDA backend's float GEMM
    rounds only its f32 result, as the Pallas kernel does), so the bars
    are bf16-sized: loss and nll within LOSS_TOL relative, z_loss within
    ZLOSS_TOL, grad_norm within GNORM_TOL; accuracy and lr match.  Adam's
    first steps move a weight by about +-lr whatever the gradient's size,
    so where a gradient is near zero its sign can flip between the
    frameworks: every parameter stays within 2 x the summed lr of the
    reference's (a flipped step), and at most MOVED_TOL of the elements
    are more than 1e-4 apart."""
    state = bridge.train_state_from_numpy(lm["state_np"], device="cpu")
    step = t_ts.make_train_step(lm["arch_t"], t_eng.train_engine(backend),
                                TTrain(microbatches=mb, **TCFG))
    held = [t.data_ptr() for t in tree.leaves(state)]
    lr_sum = 0.0
    for batch, (want, want_p) in zip(lm["batches"], jax_steps):
        state, got = step(state, batch)
        # the update runs in place: the state keeps its tensors
        assert [t.data_ptr() for t in tree.leaves(state)] == held
        assert set(got) == set(want)
        for k, tol in (("loss", LOSS_TOL), ("nll", LOSS_TOL),
                       ("z_loss", ZLOSS_TOL), ("grad_norm", GNORM_TOL)):
            assert abs(float(got[k]) - want[k]) <= tol * abs(want[k]), k
        assert float(got["lr"]) == pytest.approx(want["lr"], rel=1e-6)
        assert float(got["accuracy"]) == pytest.approx(want["accuracy"],
                                                       abs=1.0 / (B * L))
        assert float(got["aux_loss"]) == want["aux_loss"] == 0.0
        lr_sum += want["lr"]
        flat_w = jax.tree_util.tree_leaves(want_p)
        flat_g = tree.leaves(state["params"])
        assert len(flat_w) == len(flat_g)
        moved = total = 0
        for g, w in zip(flat_g, flat_w):
            assert g.dtype == torch.float32 and g.shape == w.shape
            d = np.abs(_np(g) - w)
            assert d.max() <= 2 * lr_sum * 1.01
            moved += int((d > 1e-4).sum())
            total += d.size
        assert moved <= MOVED_TOL * total, (moved, total)
    assert int(state["opt"]["step"]) == 2


# ---------------------------------------------------------------------------
# Pipeline, checkpoints, launcher, engine config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,host", [(0, 0), (7, 1)])
def test_synthetic_tokens_bitwise(lm, seed, host):
    shape_j, shape_t = JShape("t", 48, 6, "train"), TShape("t", 48, 6,
                                                           "train")
    cj = j_pipe.PipelineConfig(seed=seed, host_index=host, host_count=2)
    ct = t_pipe.PipelineConfig(seed=seed, host_index=host, host_count=2)
    pj = j_pipe.SyntheticTokens(lm["arch_j"], shape_j, cj)
    pt = t_pipe.SyntheticTokens(lm["arch_t"], shape_t, ct)
    for s in (0, 1, 5):
        want, got = pj.batch_at(s), pt.batch_at(s)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_round_trip(tmp_path):
    """A saved tree comes back bit for bit, in the target's dtypes (a bf16
    leaf included), also when the caller updates its tensors in place
    right after the save; a leftover .tmp directory is not a checkpoint;
    keep holds the newest."""
    st = {"params": {"w": torch.randn(3, 4), "h": torch.randn(
        5, dtype=torch.float64).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    mgr = t_ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, st)
    saved = tree.tree_map(torch.clone, st)
    st["params"]["w"].add_(1.0)
    mgr.wait()
    st = saved
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    back = mgr.restore(tree.tree_map(torch.zeros_like, st))
    for a, b in zip(tree.leaves(back), tree.leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _losses(text):
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ")]


def test_launcher_checkpoint_and_resume(tmp_path, capsys):
    """launch.train.main on the reduced qwen2 on the CPU: 3 steps with a
    checkpoint every 2 (steps 2 and the final 3 saved).  Then the step-3
    checkpoint is lost, a corrupt step_00000003.tmp left behind, and
    --resume continues from step 2: step 2's loss equals the first run's
    bit for bit (the batch of step k depends only on (seed, k))."""
    ck = str(tmp_path / "ck")
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--steps", "3", "--ckpt-every", "2",
            "--ckpt-dir", ck]
    assert t_launch.main(args) == 0
    first = _losses(capsys.readouterr().out)
    assert len(first) == 3 and all(np.isfinite(first))
    mgr = t_ckpt.CheckpointManager(ck)
    assert mgr.all_steps() == [2, 3]
    os.rename(os.path.join(ck, "step_00000003"),
              os.path.join(ck, "step_00000003.tmp"))
    os.remove(os.path.join(ck, "step_00000003.tmp", "manifest.json"))
    assert t_launch.main(args + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert _losses(out) == first[2:]
    assert mgr.all_steps() == [2, 3]
    with pytest.raises(NotImplementedError):
        t_launch.main(args + ["--coordinator", "localhost:1"])


def test_float_engine_on_cuda_but_not_calibration(lm):
    """The float path on the card is a valid engine (train_engine's
    default); calibration still refuses it: its absmax scales feed every
    int8 edge, so they stay on the float ref path."""
    eng = TEng(quant="none", backend="cuda")
    assert t_eng.train_engine() == eng
    assert t_eng.train_engine("ref") == TEng(quant="none", backend="ref")
    pt = bridge.params_from_numpy(lm["params"], device="cpu")
    toks = torch.from_numpy(lm["batches"][0]["tokens"])
    with pytest.raises(ValueError, match="float ref path"):
        tc.calibrate_lm(lm["arch_t"], pt, [toks], eng=eng)


def test_train_config_matches_reference():
    """TrainConfig's fields and defaults are the reference's, except the
    checkpoint directory (under the temp dir) and the fields of paths not
    ported yet: the mesh fields zero1 and seq_shard_activations (the
    multi-device slice), loss_chunk_vocab, scan_layers, triangle_skip and
    param_dtype."""
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(JTrain)}
    tf = {f.name: f.default for f in dataclasses.fields(TTrain)}
    assert set(jf) - set(tf) == {"zero1", "seq_shard_activations",
                                 "loss_chunk_vocab", "scan_layers",
                                 "triangle_skip", "param_dtype"}
    assert set(tf) <= set(jf)
    for k in tf:
        if k != "ckpt_dir":
            assert tf[k] == jf[k], k


@pytest.mark.parametrize("change", [
    dict(family="audio"), dict(family="vlm"), dict(block_pattern=("mamba",)),
    dict(block_pattern=("recurrent", "local"))])
def test_unported_training_refused(lm, change):
    """Families and layer kinds without a ported training path raise (the
    mamba mixer's dwc1d kernel has no gradient yet)."""
    import dataclasses
    arch = dataclasses.replace(lm["arch_t"], **change)
    with pytest.raises(NotImplementedError):
        t_ts.make_train_step(arch, t_eng.train_engine(), TTrain())
