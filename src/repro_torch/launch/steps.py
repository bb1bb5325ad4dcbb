"""Step functions of the port: train, prefill and decode.

Counterpart of the step builders of ``repro.launch.steps``
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``,
``build_step``).  The reference's abstract stand-ins (``batch_specs``,
``input_specs``, ``lower_cell``), which lower a cell without allocating,
have no counterpart yet (ROADMAP Queue A item 12).

The reference's steps are pure.  The train step here writes the new
parameters and optimizer moments into the tensors it is given (see
``optim.adamw``), and where the loss is not finite it writes nothing, so a
caller that drops the step's result keeps the state it had, as with the
reference's.

Under a mesh (``models.common.use_mesh``) the same steps run on every
rank: the train step takes the FSDP layout's parameters and the global
batch, sums the replicated leaves' gradients over ``data``
(``optim.grad_utils.data_parallel_grads``) and updates each rank's leaves,
the ranks agreeing on whether to write; its loss and metrics are the
global ones, the same on every rank.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ReaLBConfig, TrainConfig
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import data_parallel_grads, value_and_grad


def make_train_step(cfg: ModelConfig, rcfg: ReaLBConfig, tcfg: TrainConfig):
    """``train_step(params, opt_state, m_state, batch) -> (params,
    opt_state, m_state, metrics)``: the loss and its gradient
    (``transformer.train_loss``), then one AdamW update.  ``batch`` holds
    tensors on the parameters' device; metrics are 0-dim tensors there
    (``loss``, ``ce``, the MoE scalars, ``lr``, ``grad_norm``)."""
    def train_step(params, opt_state, m_state, batch):
        (loss, (m_new, metrics)), grads = value_and_grad(
            tf.train_loss, params, cfg, rcfg, batch, m_state)
        grads = data_parallel_grads(grads)
        params, opt_state, opt_metrics = adamw.adamw_update(
            params, grads, opt_state, tcfg, apply=torch.isfinite(loss))
        return params, opt_state, m_new, {**metrics, **opt_metrics,
                                          "loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, rcfg: ReaLBConfig,
                      cache_len: int = 0):
    def prefill_step(params, m_state, batch):
        res = tf.prefill_forward(params, cfg, rcfg, batch, m_state,
                                 cache_len=cache_len)
        return res.logits, res.cache, res.m_state

    return prefill_step


def make_serve_step(cfg: ModelConfig, rcfg: ReaLBConfig):
    def serve_step(params, cache, m_state, batch):
        res = tf.decode_forward(params, cfg, rcfg, batch, cache, m_state)
        return res.logits, res.cache, res.m_state

    return serve_step


def build_step(cfg: ModelConfig, shape: Any, rcfg: ReaLBConfig,
               tcfg: Optional[TrainConfig] = None):
    """(step_fn, arg_names) for a cell; the argument order is fixed.
    ``shape`` is a cell's shape (the reference's ``ShapeConfig``): its
    ``kind`` ("train", "prefill" or "decode") and ``seq_len`` are read."""
    tcfg = tcfg or TrainConfig()
    if shape.kind == "train":
        return make_train_step(cfg, rcfg, tcfg), ("params", "opt_state",
                                                  "m_state", "batch")
    if shape.kind == "prefill":
        return make_prefill_step(cfg, rcfg, cache_len=shape.seq_len), (
            "params", "m_state", "batch")
    return make_serve_step(cfg, rcfg), ("params", "cache", "m_state",
                                        "batch")
