"""Weights and train states carried across from the JAX reference.

torch cannot reproduce JAX's PRNG init, so tests that hold the port against
the reference build the reference's parameter tree, convert its leaves with
`np.asarray`, and hand the tree here.  This module never imports the
reference package: quantized containers are recognised by duck typing (a
NamedTuple with `q` and `scale` fields is a QTensor, one with `packed`,
`scale` and `zero` fields a Q4Tensor).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import Q4Tensor, QTensor


def _is_qtensor_like(x) -> bool:
    return (isinstance(x, tuple) and hasattr(x, "_fields")
            and hasattr(x, "q") and hasattr(x, "scale"))


def _is_q4tensor_like(x) -> bool:
    return (isinstance(x, tuple) and hasattr(x, "_fields")
            and all(hasattr(x, f) for f in ("packed", "scale", "zero")))


def params_from_numpy(tree, device="cuda"):
    """Nested dict / list / tuple of numpy arrays (QTensor- and
    Q4Tensor-like NamedTuples included) -> the same tree of torch tensors
    on `device`."""
    if _is_qtensor_like(tree):
        return QTensor(params_from_numpy(tree.q, device),
                       params_from_numpy(tree.scale, device))
    if _is_q4tensor_like(tree):
        return Q4Tensor(*(params_from_numpy(getattr(tree, f), device)
                          for f in ("packed", "scale", "zero")))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()).to(device)   # C order, 0-d ok
    return tree


def train_state_from_numpy(state, device="cuda") -> dict:
    """The reference's train state {"params", "opt": {"m", "v", "step"}}
    with numpy leaves -> the port's, on `device`: the same tree of tensors,
    the step a 0-d int32 tensor.  Both trainers then start from one
    state (the port's init_params cannot reproduce JAX's PRNG)."""
    opt = state["opt"]
    return {"params": params_from_numpy(state["params"], device),
            "opt": {"m": params_from_numpy(opt["m"], device),
                    "v": params_from_numpy(opt["v"], device),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}
