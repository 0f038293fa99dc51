"""INT8 symmetric quantization (the port's copy of repro.core.quant).

  * per-output-channel symmetric weight quantization (scale = absmax/127),
  * per-tensor static (calibrated) or per-token dynamic activation
    quantization,
  * a running-absmax Calibrator,
  * per-group asymmetric int4 weight packing (`Q4Tensor`) for the LM
    projections under quant="w4a8": two nibbles per byte along K, one f16
    (scale, zero) pair per group of K rows per output column.

Every division goes through `div`, which divides by a float32 tensor on the
operand's device: PyTorch's CUDA `div` multiplies by the reciprocal when the
divisor is a host scalar, which is not the IEEE quotient the reference
(and the kernels) compute.  Rounding is `torch.round`, half to even like
`jnp.round`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

INT8_MAX = 127.0
INT4_LEVELS = 15.0                  # asymmetric codes in [0, 15]
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


class Q4Tensor(NamedTuple):
    """An int4 weight-only packed GEMM weight [K, N]:

        w[k, n] = code[k, n] * scale[k // gs, n] + zero[k // gs, n]

    with row 2i's code in the low nibble of byte-row i and row 2i+1's in
    the high nibble.  The group size is derived from the shapes."""
    packed: torch.Tensor  # uint8 [K // 2, N], two codes per byte
    scale: torch.Tensor   # f16 [K // gs, N]
    zero: torch.Tensor    # f16 [K // gs, N]

    @property
    def shape(self):
        return (2 * self.packed.shape[0],) + tuple(self.packed.shape[1:])

    @property
    def group_size(self) -> int:
        return (2 * self.packed.shape[0]) // self.scale.shape[0]

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        k, n = self.shape
        g = self.scale.shape[0]
        codes = unpack_int4(self.packed).reshape(g, k // g, n)
        w = (codes.to(torch.float32) * self.scale.to(torch.float32)[:, None]
             + self.zero.to(torch.float32)[:, None])
        return w.reshape(k, n).to(dtype)


def snap_group_size(k: int, group_size: int) -> int:
    """Largest divisor of K that is <= group_size and even (nibble pairs
    never straddle a group boundary).  K must be even."""
    if k % 2:
        raise ValueError(f"int4 packing needs an even reduction dim, got {k}")
    gs = math.gcd(int(group_size), k)
    if gs % 2:
        gs = math.gcd(2 * gs, k)    # K even => this lands on an even divisor
    return gs


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[K//2, N] packed bytes -> [K, N] int32 codes in [0, 15]."""
    low = (packed & 0xF).to(torch.int32)
    high = (packed >> 4).to(torch.int32)
    k2, n = packed.shape
    return torch.stack([low, high], dim=1).reshape(2 * k2, n)


def pack_int4(w: torch.Tensor, group_size: int = 64) -> Q4Tensor:
    """Per-group asymmetric int4 packing of a [K, N] GEMM weight:
    scale = (max - min) / 15 and zero = min per (group, column), both
    rounded to their stored f16 values BEFORE coding (the reference's
    order), codes clip(round((w - zero) / scale), 0, 15)."""
    if w.ndim != 2:
        raise ValueError(f"pack_int4 expects a 2-D GEMM weight, got "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    gs = snap_group_size(k, group_size)
    g = k // gs
    wg = w.to(torch.float32).reshape(g, gs, n)
    lo = wg.amin(dim=1)
    hi = wg.amax(dim=1)
    floor16 = torch.full((), 1e-6, dtype=torch.float16, device=w.device)
    scale = torch.maximum(div(hi - lo, INT4_LEVELS).to(torch.float16),
                          floor16)
    zero = lo.to(torch.float16)
    s32 = scale.to(torch.float32)[:, None]
    z32 = zero.to(torch.float32)[:, None]
    codes = torch.clamp(torch.round((wg - z32) / s32), 0, 15)
    codes = codes.reshape(k, n).to(torch.uint8)
    packed = codes[0::2] | (codes[1::2] << 4)
    return Q4Tensor(packed.contiguous(), scale, zero)


def f32(s: Scale, device) -> torch.Tensor:
    """A scale as a float32 tensor on `device` (a Python float rounds once
    to float32, as JAX's weakly typed scalars do).  A Python float is
    filled on the device, not copied from the host: a blocking host copy
    would synchronize the stream on every call."""
    if isinstance(s, torch.Tensor):
        return s.to(device=device, dtype=torch.float32)
    return torch.full((), s, dtype=torch.float32, device=device)


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
