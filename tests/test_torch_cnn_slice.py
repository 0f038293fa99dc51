"""The static-int8 CNN slice of the port against the JAX reference, on the
CPU.

The model is a reduced MobileNetV2: 32 px, the first two stages and the
1x1 head conv.  It still has every op kind of the full program's 54
launches: the Low-Channel stem, plain and residual-fused 1x1 Conv PE
GEMMs, DWC PE convs, the GAP-fused pooled GEMM and the classifier head.
The reference's weights are carried across with `bridge.params_from_numpy`.

The JAX side runs once per module: calibration, then the static program
EAGERLY (`_run_scheduled` over `_static_eval`, which is what
`compiler.execute` runs without jit), observing every edge.  The port is
held against the eager run: under jit, XLA contracts the head epilogue's
`acc*a*w + b` into an FMA and moves low bits of the logits.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import compiler as jc
from repro.compiler import executor as jex
from repro.configs.cnn_zoo import CNN_ZOO as J_ZOO
from repro.core import engine as j_eng
from repro.core.config import ConvSpec as JSpec
from repro.core.config import EngineConfig as JEng
from repro.models import cnn as j_cnn

from repro_torch import bridge
from repro_torch import compiler as tc
from repro_torch.compiler import executor as tex
from repro_torch.configs.cnn_zoo import CNN_ZOO as T_ZOO
from repro_torch.core import engine as t_eng
from repro_torch.core.config import ConvSpec as TSpec
from repro_torch.core.config import EngineConfig as TEng
from repro_torch.core.quant import QTensor as TQ
from repro_torch.models.cnn import cnn_schema
from repro_torch.models.params import init_params

ZOO = sorted(J_ZOO)


def _reduced(zoo, spec):
    c = zoo["mobilenetv2"]
    return dataclasses.replace(
        c, input_hw=32,
        stages=c.stages[:2] + (spec("conv", out_ch=64, kernel=1, stride=1,
                                    repeat=1),))


J_CFG, T_CFG = _reduced(J_ZOO, JSpec), _reduced(T_ZOO, TSpec)


def _nodes(graph):
    return [(type(n).__name__, dataclasses.asdict(n)) for n in graph.nodes]


def _numpy_params(schema, rng):
    """Seeded numpy weights for a schema: He-normal kernels (the
    reference's init) and small nonzero biases, so the bias add is live."""
    if isinstance(schema, dict):
        return {k: _numpy_params(v, rng) for k, v in schema.items()}
    if isinstance(schema, list):
        return [_numpy_params(v, rng) for v in schema]
    shape = schema.shape
    if len(shape) == 1:
        return (rng.normal(size=shape) * 0.1).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(2.0 / fan_in) if schema.init == "he" else fan_in ** -0.5
    return (rng.normal(size=shape) * std).astype(np.float32)


def _edges(run, program, eval_node):
    seen = {}

    def observe(n, v):
        q = v.q if hasattr(v, "q") else v
        seen[n.id] = np.array(q)

    out = run(program, eval_node, observe)
    return seen, np.array(out)


@pytest.fixture(scope="module")
def ref():
    """The reference's weights, batch, scales, program and eager edges."""
    rng = np.random.default_rng(0)
    np_params = _numpy_params(j_cnn.cnn_schema(J_CFG), rng)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    x = (rng.normal(size=(2, 32, 32, 3)) * 0.5).astype(np.float32)
    scales = jc.calibrate(jc.build_graph(J_CFG), params, [jnp.asarray(x)],
                          J_CFG)
    prog = jc.compile_cnn(J_CFG, scales=scales)
    qp = j_eng.quantize_params(params, j_eng.paper_engine())
    eng = JEng(quant="w8a8", backend="ref")
    edges, logits = _edges(jex._run_scheduled, prog,
                           jex._static_eval(prog, qp, jnp.asarray(x), eng))
    np_qp = jax.tree_util.tree_map(np.asarray, qp)
    return dict(params=np_params, qparams=np_qp, x=x, scales=scales,
                prog=prog, edges=edges, logits=logits)


# ---------------------------------------------------------------------------
# Compile-time structure (no execution): every zoo model at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_build_graph_node_for_node(name):
    assert _nodes(tc.build_graph(T_ZOO[name])) == _nodes(
        jc.build_graph(J_ZOO[name]))


@pytest.mark.parametrize("name", ZOO)
def test_fused_graph_and_launches(name):
    jg, _ = jc.fuse_epilogues(jc.build_graph(J_ZOO[name]))
    tg, _ = tc.fuse_epilogues(tc.build_graph(T_ZOO[name]))
    assert _nodes(tg) == _nodes(jg)
    js, ts = jc.fusion_stats(jg), tc.fusion_stats(tg)
    assert {k: js[k] for k in ts} == ts
    assert tc.launch_count(tg) == jc.launch_count(jg)


def test_mobilenetv2_launch_table():
    """54 fused / 65 unfused launches at full size (BENCH_serve.json), and
    the per-kernel split the CUDA backend's counters check."""
    g = tc.build_graph(T_ZOO["mobilenetv2"])
    fg, _ = tc.fuse_epilogues(g)
    assert (tc.launch_count(fg), tc.launch_count(g)) == (54, 65)
    s = tc.fusion_stats(fg)
    assert (s["fused_adds"], s["fused_pools"], s["misc_adds"]) == (10, 1, 0)
    kinds = {"low_channel": 0, "conv_pe": 0, "conv_pe_res": 0, "dwc": 0,
             "conv_pe_pool": 0}
    for n in fg.nodes:
        ep = getattr(n, "epilogue", None)
        if isinstance(n, tc.DwcOp):
            kinds["dwc"] += 1
        elif isinstance(n, tc.ConvOp) and n.first_layer:
            kinds["low_channel"] += 1
        elif isinstance(n, (tc.ConvOp, tc.LinearOp)):
            key = ("conv_pe" if ep is None else
                   "conv_pe_res" if ep.add else "conv_pe_pool")
            kinds[key] += 1
    assert kinds == {"low_channel": 1, "conv_pe": 25, "conv_pe_res": 10,
                     "dwc": 17, "conv_pe_pool": 1}


@pytest.mark.parametrize("policy", ["asap", "alap"])
@pytest.mark.parametrize("name", ZOO)
def test_level_schedule_matches(name, policy):
    jg, _ = jc.fuse_epilogues(jc.build_graph(J_ZOO[name]))
    tg, _ = tc.fuse_epilogues(tc.build_graph(T_ZOO[name]))
    ts = tc.level_schedule(tg, policy)
    tc.validate_schedule(tg, ts)
    assert ts.levels == jc.level_schedule(jg, policy).levels


@pytest.mark.parametrize("name", ZOO)
def test_zoo_static_programs_run_on_cuda_dispatch(name):
    """Every zoo model at 32 px, port only: the fused and the fuse=False
    static programs run through the CUDA backend's dispatch (each kernel
    wrapper's plain version on CPU tensors, so no tail the zoo reaches is
    left without a kernel) and equal the ref backend and each other bit
    for bit."""
    cfg = dataclasses.replace(T_ZOO[name], input_hw=32)
    params = init_params(cnn_schema(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    x = torch.from_numpy(
        (np.random.default_rng(1).normal(size=(1, 32, 32, 3)) * 0.5
         ).astype(np.float32))
    scales = tc.calibrate(tc.build_graph(cfg), params, [x], cfg)
    qp = t_eng.quantize_params(params, t_eng.paper_engine(backend="ref"))
    outs = []
    for fuse in (True, False):
        prog = tc.compile_cnn(cfg, scales=scales, fuse=fuse)
        folded = tc.fold_weight_layouts(prog.graph, qp)
        for backend in ("ref", "cuda"):
            outs.append(tc.execute(prog, folded, x,
                                   TEng(quant="w8a8", backend=backend)))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


# ---------------------------------------------------------------------------
# Calibration, plan, weights
# ---------------------------------------------------------------------------

def test_calibration_scales_match(ref):
    tp = bridge.params_from_numpy(ref["params"], "cpu")
    got = tc.calibrate(tc.build_graph(T_CFG), tp, [torch.from_numpy(ref["x"])],
                       T_CFG)
    assert set(got) == set(ref["scales"])
    for k, v in ref["scales"].items():
        # float sums run in another order (torch vs XLA dot / conv taps)
        np.testing.assert_allclose(got[k], v, rtol=1e-6)


def test_quant_plan_matches(ref):
    prog = tc.compile_cnn(T_CFG, scales=ref["scales"])
    jplan = ref["prog"].plan
    assert prog.plan.out_scale == jplan.out_scale
    assert prog.plan.emit_int8 == jplan.emit_int8
    assert prog.plan.folded == jplan.folded
    assert _nodes(prog.graph) == _nodes(ref["prog"].graph)


def test_quantize_params_bitwise(ref):
    tp = bridge.params_from_numpy(ref["params"], "cpu")
    tq = t_eng.quantize_params(tp, t_eng.paper_engine(backend="ref"))
    jq = ref["qparams"]

    def walk(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k])
        elif isinstance(b, (list, tuple)) and not hasattr(b, "_fields"):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                walk(u, v)
        elif hasattr(b, "_fields"):
            assert isinstance(a, TQ)
            np.testing.assert_array_equal(a.q.numpy(), b.q)
            np.testing.assert_array_equal(a.scale.numpy(), b.scale)
        else:
            np.testing.assert_array_equal(a.numpy(), b)

    walk(tq, jq)


# ---------------------------------------------------------------------------
# The static program, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,fold", [("ref", False), ("cuda", False),
                                          ("cuda", True)])
def test_static_edges_and_logits_bitwise(ref, backend, fold):
    """Every int8 edge and the f32 logits equal the reference's eager run.
    backend="cuda" on CPU tensors runs each kernel wrapper's plain version
    through the CUDA backend's dispatch; `fold` binds the im2col weight
    layout as the serving engine does."""
    prog = tc.compile_cnn(T_CFG, scales=ref["scales"])
    qp = bridge.params_from_numpy(ref["qparams"], "cpu")
    if fold:
        qp = tc.fold_weight_layouts(prog.graph, qp)
    eng = TEng(quant="w8a8", backend=backend)
    edges, logits = _edges(tex._run_scheduled, prog,
                           tex._static_eval(prog, qp,
                                            torch.from_numpy(ref["x"]), eng))
    assert set(edges) == set(ref["edges"])
    for nid, want in ref["edges"].items():
        assert edges[nid].dtype == want.dtype, nid
        np.testing.assert_array_equal(edges[nid], want, err_msg=f"edge {nid}")
    assert logits.dtype == np.float32
    np.testing.assert_array_equal(logits, ref["logits"])


def test_execute_entry_point_matches(ref):
    """The public execute() on an unscheduled (raw-order) program, with
    weights quantized by the port: the logits equal the reference's."""
    tp = bridge.params_from_numpy(ref["params"], "cpu")
    prog = tc.compile_cnn(T_CFG, scales=ref["scales"], scheduled=False)
    qp = t_eng.quantize_params(tp, t_eng.paper_engine(backend="ref"))
    out = tc.execute(prog, qp, torch.from_numpy(ref["x"]),
                     TEng(quant="w8a8", backend="ref"))
    np.testing.assert_array_equal(out.numpy(), ref["logits"])
