"""Declarative parameter schemas (the port's copy of repro.models.params).

A model declares a nested dict/list of `ParamSpec`s; `init_params`
materializes it from an explicit `torch.Generator`.  The distributions are
the reference's (He / fan-in normal, zeros, ones); the numbers are not,
because torch and JAX draw different streams from the same seed -- tests
carry the reference's weights across with `bridge.params_from_numpy`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | embed | small | he
    dtype: torch.dtype = torch.float32


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _init_leaf(s: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype)
    # fan-in = everything but the output dim (conv [k,k,ic,oc] -> k*k*ic).
    fan_in = (math.prod(s.shape[:-1]) if len(s.shape) >= 2
              else max(s.shape[-1], 1))
    if s.init in ("embed", "small"):
        std = 0.02
    elif s.init == "he":               # relu networks (CNN zoo)
        std = math.sqrt(2.0 / fan_in)
    else:
        std = 1.0 / math.sqrt(fan_in)
    return (torch.randn(s.shape, generator=gen, dtype=torch.float32)
            * std).to(s.dtype)


def _map(schema, fn):
    if is_spec(schema):
        return fn(schema)
    if isinstance(schema, dict):
        return {k: _map(v, fn) for k, v in schema.items()}
    if isinstance(schema, (list, tuple)):
        return type(schema)(_map(v, fn) for v in schema)
    return schema


def init_params(schema, generator: torch.Generator, device="cuda"):
    """Materialize a schema.  Leaves are drawn on the host from `generator`
    (a CPU generator) in schema order, then moved to `device`, so one seed
    gives the same weights on every device."""
    return _map(schema, lambda s: _init_leaf(s, generator).to(device))
