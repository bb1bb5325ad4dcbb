"""Step functions of the port (train, prefill and decode), their abstract
inputs, and one cell built on ``meta``.

Counterpart of ``repro.launch.steps``: the step builders
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``,
``build_step``) and the abstract stand-ins (``batch_specs``,
``m_state_spec``, ``input_specs``, ``lower_cell``).  Where the reference
lowers a cell against ``ShapeDtypeStruct`` stand-ins, the port runs the
step once on ``meta`` tensors (shapes, dtypes, strides and no storage)
under the op-level analyzer (``launch.op_analysis``), under an abstract
production mesh when the cell has one (``launch.mesh.mesh_for(kind,
abstract=True)``): nothing is allocated and no collective moves, and the
record holds the step's memory, costs and collective census.
:func:`analyze_step` runs any step so, on any device (the card's phase 18
holds its counts on ``meta`` against those of the same step on the card).

The reference's steps are pure.  The train step here writes the new
parameters and optimizer moments into the tensors it is given (see
``optim.adamw``), and where the loss is not finite it writes nothing, so a
caller that drops the step's result keeps the state it had, as with the
reference's.

Under a mesh (``models.common.use_mesh``) the same steps run on every
rank, in the tensor-parallel layout of the default rules
(``models.layout``; the EP-only rules keep the FSDP layout of the expert
stacks alone): the train step takes the rank's parameters and the global
batch, sums each leaf's gradient over the batch axes its cut does not use
(``optim.grad_utils.data_parallel_grads``) and updates each rank's leaves,
the ranks agreeing on whether to write; its loss and metrics are the
global ones, the same on every rank.  Prefill and decode take the global
batch on every rank and the rank's slice of the cache, and give the whole
logits.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (ModelConfig, ReaLBConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import ep_moe
from repro_torch.launch.op_analysis import OpAnalyzer, storage_bytes
from repro_torch.models import transformer as tf
from repro_torch.models.common import DTYPES, use_mesh
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import data_parallel_grads, value_and_grad


def make_train_step(cfg: ModelConfig, rcfg: ReaLBConfig, tcfg: TrainConfig):
    """``train_step(params, opt_state, m_state, batch) -> (params,
    opt_state, m_state, metrics)``: the loss and its gradient
    (``transformer.train_loss``), then one AdamW update.  ``batch`` holds
    tensors on the parameters' device; metrics are 0-dim tensors there
    (``loss``, ``ce``, the MoE scalars, ``lr``, ``grad_norm``)."""
    spec = tf.model_spec(cfg)

    def train_step(params, opt_state, m_state, batch):
        (loss, (m_new, metrics)), grads = value_and_grad(
            tf.train_loss, params, cfg, rcfg, batch, m_state)
        grads = data_parallel_grads(grads, spec)
        params, opt_state, opt_metrics = adamw.adamw_update(
            params, grads, opt_state, tcfg, apply=torch.isfinite(loss),
            spec=spec)
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


def build_step(cfg: ModelConfig, shape: ShapeConfig, rcfg: ReaLBConfig,
               tcfg: Optional[TrainConfig] = None):
    """(step_fn, arg_names) for a cell; the argument order is fixed.  Of
    ``shape`` its ``kind`` ("train", "prefill" or "decode") and
    ``seq_len`` (a prefill's cache rows) are read."""
    tcfg = tcfg or TrainConfig()
    if shape.kind == "train":
        return make_train_step(cfg, rcfg, tcfg), ("params", "opt_state",
                                                  "m_state", "batch")
    if shape.kind == "prefill":
        return make_prefill_step(cfg, rcfg, cache_len=shape.seq_len), (
            "params", "m_state", "batch")
    return make_serve_step(cfg, rcfg), ("params", "cache", "m_state",
                                        "batch")


# --------------------------------------------------------------------------
# abstract inputs and one cell on meta
# --------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh=None) -> Dict[str, torch.Tensor]:
    """The cell's global input batch as ``meta`` tensors (every rank of the
    port's layout takes the global batch and keeps its rows)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32),
                "pos": _meta((b,), torch.int32),
                "modality": _meta((b, 1), torch.bool)}
    out = {"tokens": _meta((b, s), torch.int32),
           "modality": _meta((b, s), torch.bool)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
    dt = DTYPES[cfg.param_dtype]
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((b, cfg.n_vision_tokens, cfg.d_model),
                                     dt)
    if cfg.is_encdec:
        out["enc_embeds"] = _meta((b, cfg.enc_seq_len, cfg.d_model), dt)
    return out


def m_state_spec(cfg: ModelConfig, shape: ShapeConfig,
                 mesh=None) -> torch.Tensor:
    """The AIMD state of the cell (``ep_moe.moe_state_shape``), f32."""
    return _meta(ep_moe.moe_state_shape(mesh, shape.global_batch),
                 torch.float32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Every input of the cell's step as ``meta`` tensors: under ``mesh``,
    rank 0's parameters, moments and cache by the rules in force (the
    tensor-parallel layout of the default rules; under the EP-only rules
    the FSDP layout for a train cell and the whole cache)."""
    params = tf.abstract_model(cfg, mesh=mesh,
                               fsdp=shape.kind == "train"
                               and mesh is not None)
    specs: Dict[str, Any] = {"params": params,
                             "m_state": m_state_spec(cfg, shape, mesh),
                             "batch": batch_specs(cfg, shape, mesh)}
    if shape.kind == "decode":
        specs["cache"] = tf.abstract_cache(cfg, shape.global_batch,
                                           shape.seq_len, mesh=mesh)
    if shape.kind == "train":
        specs["opt_state"] = adamw.abstract_opt_state(params,
                                                      tcfg or TrainConfig())
    return specs


def analyze_step(step, args: Sequence[Any], mesh=None
                 ) -> Tuple[Any, OpAnalyzer, Dict[str, int]]:
    """``step(*args)`` once under an :class:`OpAnalyzer` (and ``mesh``, if
    given), the arguments counted live from the start.  Returns the
    step's result, the analyzer and the memory record: ``argument_bytes``
    (the arguments' storages), ``output_bytes`` (the result's storages
    that are not the arguments'), ``alias_bytes`` (those that are: the
    state a step writes in place), ``peak_bytes`` and ``temp_bytes`` (the
    peak less the arguments)."""
    an = OpAnalyzer(mesh)
    with use_mesh(mesh), an:
        an.track(args)
        out = step(*args)
    memory = {"argument_bytes": int(an.argument_bytes),
              "output_bytes": storage_bytes(out, exclude=args),
              "temp_bytes": int(an.peak - an.argument_bytes),
              "alias_bytes": storage_bytes(out) - storage_bytes(
                  out, exclude=args),
              "peak_bytes": int(an.peak)}
    return out, an, memory


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
               rcfg: Optional[ReaLBConfig] = None,
               tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Build one (arch × shape × mesh) cell on ``meta`` (under the abstract
    ``mesh``, if given), run its step once under the analyzer and return
    its record: ``memory`` (:func:`analyze_step`), the per-device flops,
    traffic and collective bytes, the census by kind, the kernels' work,
    the top traffic and collectives, the op count and ``build_s``."""
    t0 = time.perf_counter()
    step, names = build_step(cfg, shape, rcfg or ReaLBConfig(), tcfg)
    with use_mesh(mesh):
        specs = input_specs(cfg, shape, mesh, tcfg)
    _, an, memory = analyze_step(step, [specs[n] for n in names], mesh)
    return {"memory": memory,
            "flops_per_device": an.flops,
            "bytes_per_device": int(an.traffic),
            "collective_bytes_per_device": an.collective_bytes(),
            "collective_by_kind": {k: v["bytes"]
                                   for k, v in sorted(an.census.items())},
            "census": {k: dict(v) for k, v in sorted(an.census.items())},
            "kernels": {k: dict(v) for k, v in sorted(an.kernels.items())},
            "top_collectives": an.top_collectives(8),
            "top_traffic": an.top_traffic(10),
            "n_ops": an.n_ops,
            "build_s": time.perf_counter() - t0}
