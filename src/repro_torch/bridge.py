"""Carry a parameter tree across from the JAX package.

``jax.random`` init cannot be reproduced with a ``torch.Generator``, so a
test that holds the port to the JAX package builds the params there,
converts every leaf to numpy (``jax.tree.map(np.asarray, params)``) and
hands the tree to ``params_from_numpy``. Dicts, lists and tuples keep their
structure, so the stacked superblock axis of ``backbone.blocks`` leaves
stays where ``run_layers`` slices it.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bfloat16: by bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=device, dtype=dtype if t.is_floating_point() else None)


def params_from_numpy(tree, device, dtype=None):
    """Numpy leaves -> torch tensors on ``device``. ``dtype`` recasts the
    floating leaves (None keeps each leaf's own dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    if tree is None:
        return None
    return _to_tensor(tree, device, dtype)
