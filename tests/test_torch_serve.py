"""The port's CNNServeEngine on the CPU, and the port's import hygiene.

The engine serves a small MobileNetV2-shaped model (every op kind of the
54-launch program) with seeded torch weights, `backend="ref"` and
`device="cpu"`.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import compiler
from repro_torch.configs.cnn_zoo import CNN_ZOO
from repro_torch.core import engine as eng_lib
from repro_torch.core.config import ConvSpec
from repro_torch.models.cnn import cnn_schema
from repro_torch.models.params import init_params
from repro_torch.serve.base import SlotScheduler, calibration_digest
from repro_torch.serve.cnn_engine import CNNServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENG = eng_lib.paper_engine(backend="ref")


def _cfg(name="mnv2_tiny", hw=16):
    c = CNN_ZOO["mobilenetv2"]
    return dataclasses.replace(
        c, name=name, input_hw=hw, num_classes=10,
        stages=c.stages[:2] + (ConvSpec("conv", out_ch=48, kernel=1),))


def _setup(cfg, seed=0):
    params = init_params(cnn_schema(cfg), torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    calib = (rng.normal(size=(4, cfg.input_hw, cfg.input_hw, 3)) * 0.5
             ).astype(np.float32)
    images = (rng.normal(size=(8, cfg.input_hw, cfg.input_hw, 3)) * 0.5
              ).astype(np.float32)
    return params, calib, images


@pytest.fixture(scope="module")
def served():
    cfg = _cfg()
    params, calib, images = _setup(cfg)
    eng = CNNServeEngine(ENG, wave_size=4, device="cpu")
    eng.register(cfg, params, calib_batches=[calib])
    return eng, cfg, params, calib, images


def _isolated(eng, cfg, images):
    run, qp = eng._executor_for(cfg.name)
    return run(qp, torch.from_numpy(images)).numpy()


def test_wave_outputs_equal_isolated_execute(served):
    eng, cfg, _, _, images = served
    got = np.stack([eng.infer(cfg.name, images[i:i + 1])[0]
                    for i in range(len(images))])
    for i, img in enumerate(images):
        want = _isolated(eng, cfg, img[None])[0]
        np.testing.assert_array_equal(got[i], want)
    batch = eng.infer(cfg.name, images)
    np.testing.assert_array_equal(batch, got)
    assert np.isfinite(batch).all() and batch.shape == (8, cfg.num_classes)


def test_engine_program_equals_compile_calibrated(served):
    """The engine's cached program is what compile_calibrated builds from
    the same weights and batch; execute() on it gives the served logits."""
    eng, cfg, params, calib, images = served
    prog = compiler.compile_calibrated(cfg, params, [torch.from_numpy(calib)])
    assert prog.plan.out_scale == eng.program_for(cfg.name).plan.out_scale
    qp = eng_lib.quantize_params(params, ENG)
    want = compiler.execute(prog, qp, torch.from_numpy(images), ENG).numpy()
    np.testing.assert_array_equal(eng.infer(cfg.name, images), want)


def _sibling(served):
    """A fresh engine on the same program cache, with the model registered
    from the same weights and batch (a cache hit, no recompile)."""
    eng0, cfg, params, calib, images = served
    eng = CNNServeEngine(ENG, wave_size=4, device="cpu", cache=eng0.cache)
    eng.register(cfg, params, calib_batches=[calib])
    return eng, cfg, images


def test_arrival_order_does_not_change_logits(served):
    eng0, cfg, _, _, images = served
    fwd = eng0.infer(cfg.name, images)
    eng, _, _ = _sibling(served)
    order = [5, 2, 7, 0, 3, 6, 1, 4]
    got, ticket_of = {}, {}
    for i in order:
        ticket_of[eng.submit(cfg.name, images[i])] = i
        got.update(eng.pump())
    assert len(got) == 8 and eng.pending() == 0
    for t, logits in got.items():
        np.testing.assert_array_equal(logits, fwd[ticket_of[t]])


@pytest.mark.parametrize("continuous,want", [(True, 1.0), (False, 0.25)])
def test_fill_rate(served, continuous, want):
    """8 arrivals at wave size 4: continuous pump() fills every slot; a
    flush after every arrival pads 3 of 4 (BENCH_serve.json fill_rate)."""
    eng, cfg, images = _sibling(served)
    misses = eng.cache.stats.misses
    for img in images:
        eng.submit(cfg.name, img)
        eng.pump() if continuous else eng.flush()
    eng.flush()
    s = eng.stats()
    assert s["wave_fill_rate"] == want
    assert s["requests"] == 8 and s["queued"] == 0
    assert eng.cache.stats.misses == misses


def test_program_cache_hits_and_stats(served):
    eng, cfg, _, _, images = served
    before = eng.cache.stats.misses
    eng.infer(cfg.name, images[:2])
    assert eng.cache.stats.misses == before
    s = eng.stats()
    assert s["fused_programs"][cfg.name]["launches"] == compiler.launch_count(
        eng.program_for(cfg.name).graph)
    assert s["latency_ms"]["n"] > 0 and s["device"] == "cpu"


def test_submit_validates(served):
    eng, cfg, _, _, _ = served
    with pytest.raises(ValueError):
        eng.submit(cfg.name, np.zeros((3, 3, 3), np.float32))
    with pytest.raises(KeyError):
        eng.submit("nope", np.zeros((16, 16, 3), np.float32))


def test_calibration_digest_tracks_inputs():
    cfg = _cfg()
    params, calib, _ = _setup(cfg)
    other, _, _ = _setup(cfg, seed=1)
    d = calibration_digest([calib], params)
    assert d == calibration_digest([calib.copy()], params)
    assert d != calibration_digest([calib * 2], params)
    assert d != calibration_digest([calib], other)


def test_slot_scheduler_refill_accounting():
    s = SlotScheduler(2)
    s.submit("g", 0)
    assert s.take_wave("g") is None
    s.next_epoch()
    s.submit("g", 1)
    assert [p for _, p in s.take_wave("g")] == [0, 1]
    assert s.stats.refilled_waves == 1
    s.submit("g", 2)
    assert len(s.take_wave("g", force=True)) == 1
    assert s.stats.padded_slots == 1 and s.stats.fill_rate == 0.75


def test_init_params_seeded_and_shaped():
    cfg = _cfg()
    a = init_params(cnn_schema(cfg), torch.Generator().manual_seed(3),
                    device="cpu")
    b = init_params(cnn_schema(cfg), torch.Generator().manual_seed(3),
                    device="cpu")
    assert a["stem_w"].shape == (3, 3, 3, 32)
    torch.testing.assert_close(a["head_w"], b["head_w"], rtol=0, atol=0)
    assert float(a["stem_b"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# Import hygiene: the port and chip_smoke.py never reach JAX or `repro`
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _bad_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(name)
    return bad


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    assert path.exists(), path
    assert _bad_imports(path) == []
