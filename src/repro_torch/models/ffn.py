"""Dense feed-forward blocks: SwiGLU / GeGLU / GELU-MLP.

Counterpart of ``repro.models.ffn``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import P, activation_fn


def ffn_spec(d_model: int, d_ff: int, activation: str) -> Dict[str, P]:
    spec = {"w_up": P((d_model, d_ff), axes=("embed", "ffn")),
            "w_down": P((d_ff, d_model), axes=("ffn", "embed"))}
    if activation in ("swiglu", "geglu"):
        spec["w_gate"] = P((d_model, d_ff), axes=("embed", "ffn"))
    return spec


def ffn_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    act = activation_fn(cfg.activation)
    h = torch.matmul(x, p["w_up"].to(x.dtype))
    if "w_gate" in p:
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        h = act(g.to(torch.float32)).to(x.dtype) * h
    else:
        h = act(h.to(torch.float32)).to(x.dtype)
    return torch.matmul(h, p["w_down"].to(x.dtype))


def tp_ffn_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, tp, d_ff: int) -> torch.Tensor:
    """:func:`ffn_forward` in the tensor-parallel layout
    (``models.layout``): ``x`` the residual's layout; ``w_gate``/``w_up``
    column-parallel over ``ffn`` and ``w_down`` row-parallel where ``d_ff``
    divides over ``model`` (the whole sequence in, the partial sums
    reduced back), else every weight whole and the rank's own rows."""
    if not tp.divides(d_ff):
        return ffn_forward(p, x, cfg)
    return tp.reduce_out(ffn_forward(p, tp.gather_seq(x), cfg))
