"""Configuration dataclasses (the port's copy of repro.core.config).

  * CNNConfig / ConvSpec -- a CNN from the paper's own evaluation zoo.
  * EngineConfig         -- the DPUV4E engine feature set.

This slice serves static-int8 CNNs, so EngineConfig keeps the two knobs
that path reads: the quant mode and the kernel backend.  The reference's
other fields (XVDPU baseline, int4 packing, KV-cache dtype, MoE dispatch,
Pallas interpret mode) join with the slices that run them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

QUANT_MODES = ("none", "w8a8")
BACKENDS = ("ref", "cuda")


@dataclass(frozen=True)
class ConvSpec:
    kind: str                        # conv | dwc | pool | add_branch
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    repeat: int = 1
    expand: int = 0                  # inverted-residual expansion factor


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_ch: int
    stem_kernel: int
    stem_stride: int
    stem_ch: int
    stages: Tuple[ConvSpec, ...]
    num_classes: int = 1000
    gops: float = 0.0                # paper-reported GOPs per inference


@dataclass(frozen=True)
class EngineConfig:
    # none -> f32 math (the calibration path); w8a8 -> int8 x int8 -> int32
    # (the paper's mode).
    quant: str = "none"
    # "ref" = plain PyTorch (kernels/ref.py), "cuda" = the hand-written
    # Hopper kernels (the reference's "pallas" slot).
    backend: str = "ref"

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant {self.quant!r} not in {QUANT_MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.backend == "cuda" and self.quant == "none":
            raise ValueError("the CUDA kernels run the int8 engines "
                             "(quant='w8a8'); the float path is backend='ref'")
