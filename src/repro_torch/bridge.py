"""Weights carried across from the JAX reference.

torch cannot reproduce JAX's PRNG init, so tests that hold the port against
the reference build the reference's parameter tree, convert its leaves with
`np.asarray`, and hand the tree here.  This module never imports the
reference package: quantized containers are recognised by duck typing (a
NamedTuple with `q` and `scale` fields).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QTensor


def _is_qtensor_like(x) -> bool:
    return (isinstance(x, tuple) and hasattr(x, "_fields")
            and hasattr(x, "q") and hasattr(x, "scale"))


def params_from_numpy(tree, device="cuda"):
    """Nested dict / list / tuple of numpy arrays (QTensor-like NamedTuples
    included) -> the same tree of torch tensors on `device`."""
    if _is_qtensor_like(tree):
        return QTensor(params_from_numpy(tree.q, device),
                       params_from_numpy(tree.scale, device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()).to(device)   # C order, 0-d ok
    return tree
