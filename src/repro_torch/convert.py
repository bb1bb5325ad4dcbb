"""numpy trees → the port's tensors, under the same key paths.

Feeds the port with the reference's parameters and caches: pass it the
JAX tree after ``jax.tree.map(np.asarray, tree)``.  A JAX bf16 array
becomes an ``ml_dtypes`` bfloat16 numpy array, which ``torch.from_numpy``
rejects, so bf16 goes through its 16-bit pattern.  Every leaf is copied:
JAX's buffers are read-only.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Tree = Any


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree: Tree, device="cpu") -> Tree:
    """Nested dicts (and tuples) of numpy arrays → the same of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


cache_from_numpy = params_from_numpy


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 widens to f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()
