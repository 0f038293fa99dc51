"""DPUV4E engine facade: the paper preset + param-tree quantization.

The paper's deployment flow is: train/convert -> Vitis-AI INT8 quantize ->
run on the DPU engines.  Here: float params -> quantize_params() -> serve
through the Conv PE / DWC PE / Low-Channel kernels (kernels/ops.py).
"""
from __future__ import annotations

import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.quant import QTensor, quantize

# Param-dict keys that route through the Conv PE / DWC PE and therefore
# quantize (the reference's set; the LM keys are kept so one tree walker
# serves every slice).
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "wg", "wu", "wd", "wi",
    "in_proj", "out_proj", "x_proj", "dt_proj", "in_x", "in_gate",
    "head", "router", "embed",
    # CNN zoo (models/cnn.py schema): stem / stage convs / depthwise taps /
    # squeeze-expand / classifier head -- the engine-program weights.
    "stem_w", "w", "w1", "w2", "w3", "wskip", "we", "wp", "ws", "head_w",
})


def paper_engine(backend: str = "cuda", **kw) -> EngineConfig:
    """The DPUV4E configuration: W8A8 on the hand-written kernels."""
    return EngineConfig(quant="w8a8", backend=backend, **kw)


def _quant_axis(key: str, ndim: int) -> int:
    return 0 if key == "embed" else ndim - 1


def _walk(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return fn(key, tree)            # quantized container: one leaf
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, key) for v in tree)
    return fn(key, tree)


def quantize_params(params, eng: EngineConfig):
    """Value tree -> quantized tree: every rank>=2 float leaf under a
    QUANT_KEYS key becomes a per-output-channel QTensor."""
    if eng.quant == "none":
        return params

    def fn(key, leaf):
        if (key in QUANT_KEYS and isinstance(leaf, torch.Tensor)
                and leaf.ndim >= 2 and leaf.is_floating_point()):
            return quantize(leaf, axis=_quant_axis(key, leaf.ndim))
        return leaf

    return _walk(params, fn)
