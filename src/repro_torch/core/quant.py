"""INT8 symmetric quantization (the port's copy of repro.core.quant).

  * per-output-channel symmetric weight quantization (scale = absmax/127),
  * per-tensor static (calibrated) or per-token dynamic activation
    quantization,
  * a running-absmax Calibrator.

Every division goes through `div`, which divides by a float32 tensor on the
operand's device: PyTorch's CUDA `div` multiplies by the reciprocal when the
divisor is a host scalar, which is not the IEEE quotient the reference
(and the kernels) compute.  Rounding is `torch.round`, half to even like
`jnp.round`.  Int4 packing (Q4Tensor) waits for the LM slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

INT8_MAX = 127.0
_MIN_SCALE = 1e-8

Scale = Union[float, torch.Tensor]


class QTensor(NamedTuple):
    """A quantized tensor: int8 values + float32 scale (broadcastable).

    Weights carry a tensor scale; activation edges of a static program
    carry a compile-time Python float."""
    q: torch.Tensor       # int8
    scale: Scale

    @property
    def shape(self):
        return self.q.shape

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return mul(self.q.to(torch.float32), self.scale).to(dtype)


def f32(s: Scale, device) -> torch.Tensor:
    """A scale as a float32 tensor on `device` (a Python float rounds once
    to float32, as JAX's weakly typed scalars do)."""
    if isinstance(s, torch.Tensor):
        return s.to(device=device, dtype=torch.float32)
    return torch.tensor(s, dtype=torch.float32, device=device)


def div(x: torch.Tensor, s: Scale) -> torch.Tensor:
    """IEEE float32 x / s on any device (see the module docstring)."""
    return x / f32(s, x.device)


def mul(x: torch.Tensor, s: Scale) -> torch.Tensor:
    return x * f32(s, x.device)


def qdq_codes(x: torch.Tensor, s: Scale) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as integer-valued float32."""
    return torch.clamp(torch.round(div(x, s)), -INT8_MAX, INT8_MAX)


def _absmax(x: torch.Tensor, dims, keepdim=True) -> torch.Tensor:
    a = x.to(torch.float32).abs()
    if dims is None:
        return a.amax()
    return a.amax(dim=dims, keepdim=keepdim)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(div(amax, INT8_MAX), _MIN_SCALE)


def quantize(x: torch.Tensor, axis: Optional[int] = None) -> QTensor:
    """Symmetric int8 quantization.

    axis=None -> per-tensor scale; axis=k -> one scale per index of dim k
    (weights: axis=out_dim), reduced over every other dim."""
    if axis is None:
        scale = _scale_of(_absmax(x, None))
    else:
        axis = axis % x.ndim
        red = tuple(i for i in range(x.ndim) if i != axis)
        scale = _scale_of(_absmax(x, red))
    q = qdq_codes(x.to(torch.float32), scale)
    return QTensor(q.to(torch.int8), scale)


def quantize_act_dynamic(x: torch.Tensor, per_token: bool = True) -> QTensor:
    """Dynamic activation quantization: scale per leading-dims row (token),
    or one per tensor."""
    amax = _absmax(x, (-1,)) if per_token else _absmax(x, None)
    scale = _scale_of(amax)
    q = qdq_codes(x.to(torch.float32), scale)
    return QTensor(q.to(torch.int8), scale)


def quantize_static(x: torch.Tensor, scale: Scale) -> torch.Tensor:
    """Quantize with a pre-calibrated scale; returns int8 values only."""
    return qdq_codes(x.to(torch.float32), scale).to(torch.int8)


class Calibrator:
    """Running absmax calibration over representative batches (per-tensor)."""

    def __init__(self):
        self.amax = {}

    def observe(self, name: str, x: torch.Tensor) -> None:
        v = float(x.abs().max())
        self.amax[name] = max(self.amax.get(name, 0.0), v)

    def scales(self) -> dict:
        return {k: max(v / INT8_MAX, _MIN_SCALE) for k, v in self.amax.items()}
