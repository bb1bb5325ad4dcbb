"""Shared model machinery of the port: devices, parameter declarations and
initialisation, norms, activations, RoPE.

Counterpart of the numerics of ``repro.models.common``.  Parameters are
declared as :class:`P` leaves (shape + init) and initialised from a seeded
``torch.Generator`` on the target device: fan-in scaled normals on the
second-to-last dim, ``embed`` normals with their own std, zero norms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Tree = Any
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one.  With no card and no explicit device it raises; it never falls back
    to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain versions on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter."""

    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | embed
    scale: float = 1.0            # stddev multiplier
    dtype: Optional[str] = None   # override the model param dtype


def init_leaf(p: P, gen: torch.Generator, default_dtype: str,
              device: torch.device, stack: int = 0) -> torch.Tensor:
    """One parameter (``stack`` adds a leading block dim).  Stacked normals
    are drawn one block at a time in f32, so the f32 draw never holds more
    than one block of the parameter."""
    shape = (stack, *p.shape) if stack else p.shape
    dt = DTYPES[p.dtype or default_dtype]
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if p.init == "embed":
        std = p.scale
    else:   # fan-in scaled init on the second-to-last dim
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dt, device=device)
    for block in (out if stack else (out,)):
        block.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32,
                                device=device) * std)
    return out


def init_params(tree: Tree, gen: torch.Generator, default_dtype: str,
                device: torch.device, stack: int = 0) -> Tree:
    """Initialise a nested dict of :class:`P` (in sorted key order)."""
    if isinstance(tree, P):
        return init_leaf(tree, gen, default_dtype, device, stack)
    return {k: init_params(tree[k], gen, default_dtype, device, stack)
            for k in sorted(tree)}


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    gelu = lambda v: F.gelu(v, approximate="tanh")   # noqa: E731 jax default
    return {"swiglu": F.silu, "geglu": gelu, "gelu": gelu}[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, computed in f64 and rounded once to f32: XLA's
    f32 ``pow`` is correctly rounded in all but at most one entry of a
    head, torch's f32 ``pow`` is not, and a frequency one ulp off moves the
    angle at position p by p ulps."""
    return (1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                          device=device) / head_dim))
            ).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (absolute token positions)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [d/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, d/2]
    angles = angles[..., None, :]                            # [..., S, 1, d/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_bytes(tree: Tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


Params = Dict[str, torch.Tensor]
