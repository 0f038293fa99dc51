"""DPUV4E engine facade: the presets + param-tree quantization.

The paper's deployment flow is: train/convert -> Vitis-AI INT8 quantize ->
run on the DPU engines.  Here: train in bf16 / f32 (train_engine) -> float
params -> quantize_params() -> serve through the Conv PE / DWC PE /
Low-Channel kernels (kernels/ops.py).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.quant import (Q4Tensor, QTensor, pack_int4, quantize,
                                    snap_group_size)
from repro_torch.models.params import ParamSpec, is_spec

# Param-dict keys that route through the Conv PE / DWC PE and therefore
# quantize (the reference's set).
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "wg", "wu", "wd", "wi",
    "in_proj", "out_proj", "x_proj", "dt_proj", "in_x", "in_gate",
    "head", "router", "embed",
    # CNN zoo (models/cnn.py schema): stem / stage convs / depthwise taps /
    # squeeze-expand / classifier head -- the engine-program weights.
    "stem_w", "w", "w1", "w2", "w3", "wskip", "we", "wp", "ws", "head_w",
})

# LM projection weights: the weight-bandwidth-bound decode GEMMs that pack
# to int4 under quant="w4a8" (embed/head and everything else stay int8).
W4_KEYS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd"})


def weight_mode(eng: EngineConfig) -> str:
    """Digest tag for the weight container layout ("" for int8 / float).
    Folded into the calibration id (serve/base.calibration_digest), so w4
    and w8 programs of one model never share a ProgramCache line."""
    if eng.quant == "w4a8":
        return f"w4g{eng.w4_group_size}"
    return ""


def train_engine(backend: str = "cuda") -> EngineConfig:
    """The float training path: every projection on the float GEMM kernel
    (conv_pe.matmul_f_fused) on the card, or plain torch on "ref"."""
    return EngineConfig(quant="none", backend=backend)


def paper_engine(backend: str = "cuda", **kw) -> EngineConfig:
    """The DPUV4E configuration: W8A8 on the hand-written kernels."""
    return EngineConfig(quant="w8a8", backend=backend, **kw)


def w4_engine(backend: str = "cuda", **kw) -> EngineConfig:
    """Int4 weight-only LM projections over the w8a8 fabric: packed weights
    are unpacked in registers by the int4 Conv PE kernel."""
    return EngineConfig(quant="w4a8", backend=backend, **kw)


def _quant_axis(key: str, ndim: int) -> int:
    return 0 if key == "embed" else ndim - 1


def _walk(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (QTensor, Q4Tensor)):
        return fn(key, tree)            # quantized container: one leaf
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, key) for v in tree)
    return fn(key, tree)


def _packs_int4(eng: EngineConfig, key: str, ndim: int) -> bool:
    return eng.quant == "w4a8" and key in W4_KEYS and ndim == 2


def quantize_schema(schema, eng: EngineConfig):
    """ParamSpec tree -> the tree quantize_params produces, as specs:
    quantized leaves become QTensor nodes (Q4Tensor nodes for the w4a8 LM
    projections)."""
    if eng.quant == "none":
        return schema

    def fn(key, leaf):
        if is_spec(leaf) and key in QUANT_KEYS and len(leaf.shape) >= 2:
            if _packs_int4(eng, key, len(leaf.shape)):
                k, n = leaf.shape
                g = k // snap_group_size(k, eng.w4_group_size)
                return Q4Tensor(
                    packed=ParamSpec((k // 2, n), "ones", torch.uint8),
                    scale=ParamSpec((g, n), "ones", torch.float16),
                    zero=ParamSpec((g, n), "ones", torch.float16))
            ax = _quant_axis(key, len(leaf.shape))
            sshape = tuple(d if i == ax else 1
                           for i, d in enumerate(leaf.shape))
            return QTensor(
                q=dataclasses.replace(leaf, init="small", dtype=torch.int8),
                scale=ParamSpec(sshape, "ones", torch.float32))
        return leaf

    return _walk(schema, fn)


def quantize_params(params, eng: EngineConfig):
    """Value tree -> quantized tree: every rank>=2 float leaf under a
    QUANT_KEYS key becomes a per-output-channel QTensor, or, under w4a8, a
    Q4Tensor for the LM projections (W4_KEYS)."""
    if eng.quant == "none":
        return params

    def fn(key, leaf):
        if (key in QUANT_KEYS and isinstance(leaf, torch.Tensor)
                and leaf.ndim >= 2 and leaf.is_floating_point()):
            if _packs_int4(eng, key, leaf.ndim):
                return pack_int4(leaf, eng.w4_group_size)
            return quantize(leaf, axis=_quant_axis(key, leaf.ndim))
        return leaf

    return _walk(params, fn)
