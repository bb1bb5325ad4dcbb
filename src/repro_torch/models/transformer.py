"""Decoder stack of the port with the ReaLB MoE layers.

Counterpart of the decoder part of ``repro.models.transformer``: leading
dense "prefix" layers, then ``n_blocks`` identical blocks whose parameters
(and caches) are stacked along a leading ``[n_blocks]`` dim.  A block's
layers are attention or Mamba (``models.ssm``) token mixers by the
config's ``layer_pattern`` ("attn"; "ssm", falcon-mamba; "jamba", one
attention and seven Mamba layers a block of 8), each followed by a dense,
MoE or no FFN.  Attention is GQA, or MLA where the config has one
(minicpm3).  An attention layer's cache is ``k``/``v`` (MLA: the latent
``latent`` and the roped key part ``k_rope``), a Mamba layer's its conv
window ``conv`` and SSM state ``ssm``.  The reference scans over
the blocks; the port loops over block indices and updates the stacked
cache in place.  The AIMD ``m_state`` threads through the loop (each MoE
layer applies one control update).

Entry points: ``init_model``, ``init_cache`` (and their ``meta`` trees,
``abstract_model`` and ``abstract_cache``, for the dry run),
``prefill_forward`` (one-shot
prefill of whole prompts, returning a cache padded to ``cache_len``),
``chunk_forward`` (chunked prefill against the cache) and ``decode_forward``
(one token per row); ``chunk_forward`` runs all-GQA stacks only.
They run on ``cuda`` unless the caller passes ``device="cpu"``, and none
of them reads the device on the host.
Training: ``train_forward`` (logits of whole sequences, no cache, with the
reference's ``remat`` policies), ``cross_entropy`` and ``train_loss``, on
one device or under a mesh, for every ported stack (a Mamba layer trains
through the scan's recursion under autograd).

Under a mesh (``models.common.use_mesh``) the same entry points run on
every rank, and every rank passes the whole batch.  The reference
declares a logical axis on every parameter and cache entry and lets
GSPMD place the collectives; the port fixes its layout with explicit,
counted collectives (``core.ep_moe.Comm``, each with its transpose) and
the function stays the same.  Under the default rules
(``models.common.DEFAULT_RULES``) it is the reference's layout, the
tensor-parallel one (``models.layout``): a rank holds the slice of every
parameter that ``resolve_spec`` gives it (heads, KV heads, FFN, vocabulary
and the Mamba layer's channels over ``model``, every weight's D dim over
``data``, the expert stacks' slots over ``model``), the slice of the
cache (:data:`CACHE_AXES`: rows over the batch axes, the sequence over
the ``kv_seq`` axes the batch leaves), its ``B/rows`` rows of the batch
and, between layers, its ``S/model`` slice of the sequence (a decode
step's sequence of one stays whole on every rank of ``model``).  The
embedding and the logits are vocabulary-parallel; serving's logits come
back whole on every rank, training's as :func:`logits_layout` says, and
:func:`cross_entropy` reduces the loss over ``model`` and the batch axes.
Decode and chunk attention run every head's queries against the rank's
rows of the cache and combine the partial softmaxes over the ``kv_seq``
axes; a row is written only by the rank that holds it.  The MoE layer
(``ep_moe_forward``) takes the rank's rows and sequence slice as they
are, its expert stacks' D dim gathered over ``data``.  A chunk, a
training sequence or a MoE stack's prompt must divide over ``model``.

Under the EP-only rules (``models.common.EP_ONLY_RULES``, the port's
first mesh layout, a rules override) only the expert stacks are cut: the
non-expert part and the cache are replicated on every rank, each MoE
layer takes the rank's rows and its ``S/ep`` slice of the sequence and
all-gathers its output back over ``model``, bit for bit the one-device
forward's.  Training there takes the FSDP layout (``init_model(fsdp=
True)``: each expert stack's D dim over ``data``) and each data row
trains on its ``B/data`` rows; ``optim.grad_utils.data_parallel_grads``
sums a replicated leaf's gradient over ``data``.  In both layouts every
collective has its transpose, so each rank's gradient is the global
loss's with respect to what it holds.  Under ``remat`` a checkpointed
block's recompute re-issues its collectives inside the backward, the
whole block on every rank in the same order (early stop off), under the
mesh and rules of the forward, and the census counts them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig, ReaLBConfig, SSMConfig
from repro_torch.core import ep_moe
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import layout
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (DTYPES, ROWS, P, abstract_params,
                                       current_mesh, current_rules,
                                       init_params, leaf_cuts, local_slice,
                                       resolve_device, resolve_spec,
                                       rms_norm, tensor_parallel, use_mesh)

Tree = Any
AUX_KEYS = ep_moe.AUX_SCALARS
# the expert stacks' logical axes: slots over model, D (``embed``) over
# data in the FSDP layout
EXPERT_AXES = {"w_gate": ("expert", "embed", None),
               "w_up": ("expert", "embed", None),
               "w_down": ("expert", None, "embed")}
F32 = torch.float32
EMBED = ("embed",)


# --------------------------------------------------------------------------
# block layout and parameters
# --------------------------------------------------------------------------
def block_structure(cfg: ModelConfig) -> Tuple[Tuple[Tuple[str, str], ...],
                                               int, int]:
    """(block_layout, n_blocks, n_prefix). Layout entries: (mix, ffn); an
    encoder-decoder's decoder layers are all "dec" (self-attention, then
    cross-attention to the encoder's output)."""
    mixes = ["dec"] * cfg.n_layers if cfg.is_encdec else cfg.layer_kinds()
    kinds = [(m, "none" if (f == "dense" and cfg.d_ff == 0) else f)
             for m, f in zip(mixes, cfg.ffn_kinds())]
    n_prefix = cfg.n_dense_layers
    rest = kinds[n_prefix:]
    period = cfg.scan_period
    layout = tuple(rest[:period])
    for i in range(0, len(rest), period):
        if tuple(rest[i:i + period]) != layout:
            raise ValueError("non-periodic layer stack")
    return layout, len(rest) // period, n_prefix


def moe_spec(cfg: ModelConfig, n_slots: Optional[int] = None
             ) -> Dict[str, P]:
    """The MoE layer's declarations; ``n_slots``: the expert stacks'
    physical slot count (a replica engine's ``S``; default the expert
    count)."""
    e, d = cfg.moe, cfg.d_model
    s = e.num_experts if n_slots is None else int(n_slots)
    return {
        "router": P((d, e.num_experts), dtype="float32", axes=(None, None)),
        "w_gate": P((s, d, e.d_ff), axes=EXPERT_AXES["w_gate"], fsdp=True),
        "w_up": P((s, d, e.d_ff), axes=EXPERT_AXES["w_up"], fsdp=True),
        "w_down": P((s, e.d_ff, d), axes=EXPERT_AXES["w_down"], fsdp=True),
    }


def layer_spec(cfg: ModelConfig, mix: str, ffn: str,
               n_slots: Optional[int] = None) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": P((d,), init="zeros", axes=EMBED)}
    if mix in ("attn", "dec"):
        spec["attn"] = attn.attn_spec(cfg)
    elif mix == "ssm":
        spec["ssm"] = ssm_mod.ssm_spec(cfg)
    elif mix == "cross":            # cross-attention alone, after norm1
        spec["cross"] = attn.gqa_spec(cfg)
    else:
        raise ValueError(f"token mixer {mix!r}")
    if mix == "dec":
        spec["norm_cross"] = P((d,), init="zeros", axes=EMBED)
        spec["cross"] = attn.gqa_spec(cfg)
    if ffn != "none":
        spec["norm2"] = P((d,), init="zeros", axes=EMBED)
    if ffn == "dense":
        spec["ffn"] = ffn_mod.ffn_spec(d, cfg.d_ff or cfg.moe.d_ff,
                                       cfg.activation)
    elif ffn == "moe":
        spec["moe"] = moe_spec(cfg, n_slots)
        if cfg.moe.n_shared_experts:
            spec["shared"] = ffn_mod.ffn_spec(
                d, cfg.moe.d_ff * cfg.moe.n_shared_experts, cfg.activation)
    return spec


def model_spec(cfg: ModelConfig, n_slots: Optional[int] = None
               ) -> Dict[str, Any]:
    """The model's declarations (``n_slots``: the expert stacks' physical
    slot count, :func:`moe_spec`)."""
    layout, _, n_prefix = block_structure(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    spec: Dict[str, Any] = {
        "embed": P((v, d), init="embed", scale=0.02,
                   axes=("vocab", "embed")),
        "final_norm": P((d,), init="zeros", axes=EMBED),
        "blocks": {f"layer{i}": layer_spec(cfg, m, f, n_slots)
                   for i, (m, f) in enumerate(layout)},
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = P((d, v), axes=("embed", "vocab"))
    if n_prefix:
        spec["prefix"] = {str(i): layer_spec(cfg, cfg.layer_kinds()[i],
                                             "dense")
                          for i in range(n_prefix)}
    if cfg.is_encdec:
        spec["enc_blocks"] = {"layer0": layer_spec(cfg, "attn", "dense")}
        spec["enc_norm"] = P((d,), init="zeros", axes=EMBED)
    return spec


def init_model(cfg: ModelConfig, seed: int = 0, device=None,
               mesh=None, fsdp: bool = False) -> Tree:
    """Random parameters from a seeded ``torch.Generator`` on the device,
    under the reference's key paths and layouts.  Under ``mesh`` (default:
    the current one) this rank's slice of each leaf by the rules in force,
    equal to the matching slice of the whole model's: under the default
    rules every leaf the reference's layout cuts; under
    ``EP_ONLY_RULES`` only the ``S/ep`` expert slots, and with ``fsdp``
    (the layout training under a mesh takes there) their ``D/data``
    slice."""
    mesh = current_mesh() if mesh is None else mesh
    device = resolve_device(mesh.device if device is None and mesh
                            is not None else device)
    spec = model_spec(cfg)
    _, n_blocks, _ = block_structure(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stacks = {"blocks": n_blocks, "enc_blocks": cfg.n_enc_layers}
    params = {k: init_params(v, gen, cfg.param_dtype, device, mesh=mesh,
                             fsdp=fsdp)
              for k, v in spec.items() if k not in stacks}
    for k, n in stacks.items():
        if k in spec:
            params[k] = init_params(spec[k], gen, cfg.param_dtype, device,
                                    stack=n, mesh=mesh, fsdp=fsdp)
    return params


def abstract_model(cfg: ModelConfig, mesh=None, fsdp: bool = False) -> Tree:
    """:func:`init_model`'s tree as ``meta`` tensors (the reference's
    ``abstract_model``): the same key paths, shapes and dtypes, under
    ``mesh`` (default: the current one) rank 0's slices; no generator
    draws and nothing is allocated."""
    mesh = current_mesh() if mesh is None else mesh
    spec = model_spec(cfg)
    _, n_blocks, _ = block_structure(cfg)
    stacks = {"blocks": n_blocks, "enc_blocks": cfg.n_enc_layers}
    return {k: abstract_params(v, cfg.param_dtype, stacks.get(k, 0), mesh,
                               fsdp)
            for k, v in spec.items()}


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   mem_len: Optional[int] = None, mesh=None) -> Tree:
    """:func:`init_cache`'s tree as ``meta`` tensors (the reference's
    ``abstract_cache``), under ``mesh`` (default: the current one) rank
    0's slices."""
    return init_cache(cfg, batch, cache_len, device="meta", mem_len=mem_len,
                      mesh=mesh)


def kv_layout(mesh, batch: int, cache_len: int) -> Tuple[Tuple[str, ...],
                                                         int, int]:
    """``(axes, first row, rows)`` of this rank's slice of a cache of
    ``batch`` rows and ``cache_len`` positions along its ``kv_seq`` dim
    (:func:`models.common.resolve_spec`)."""
    cut = resolve_spec((batch, cache_len), ("batch", "kv_seq"), mesh)[1]
    n = cache_len // mesh.size(cut) if cut else cache_len
    return cut, layout.kv_rows(cut, mesh, n), n


def cache_kv_layout(cfg: ModelConfig, cache: Tree, batch: int, mesh):
    """:func:`kv_layout` of a cache of this rank's slices (None without an
    attention layer): the whole length is the longest prefix of the
    ``kv_seq`` axes left by the batch whose cut gives the slice."""
    for group in ("prefix", "blocks"):
        for entries in cache.get(group, {}).values():
            for name in ("k", "latent"):
                if name in entries:
                    n = entries[name].shape[-3 if name == "k" else -2]
                    used = set(resolve_spec((batch,), ("batch",), mesh)[0])
                    cand = [a for a in current_rules()["kv_seq"]
                            if a in mesh.shape and a not in used]
                    for j in range(len(cand), -1, -1):
                        total = n * mesh.size(tuple(cand[:j]))
                        cut = kv_layout(mesh, batch, total)
                        if cut[0] == tuple(cand[:j]):
                            return cut
    return None


def memory_len(cfg: ModelConfig) -> int:
    """Rows of the memory a cross-attention layer attends to: the
    encoder's frames, a VLM's vision tokens (0 without one)."""
    return cfg.enc_seq_len if cfg.is_encdec else cfg.n_vision_tokens


def _entry_shapes(cfg: ModelConfig, mix: str, batch: int, cache_len: int,
                  mem_len: Optional[int] = None
                  ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each cache entry of a layer (the reference's
    ``_entry_spec``): attention ``k``/``v [B, L, K, Dh]``, MLA ``latent
    [B, L, kv_lora_rank]`` and ``k_rope [B, L, qk_rope_head_dim]``, all in
    the parameter dtype; Mamba ``conv [B, d_conv-1, d_in]`` in the
    parameter dtype and ``ssm [B, d_in, N]`` in f32; a cross-attention's
    memory K/V ``xk``/``xv [B, mem_len, K, Dh]`` (default
    :func:`memory_len`) in the parameter dtype, beside a "dec" layer's
    self-attention ``k``/``v``."""
    dt = DTYPES[cfg.param_dtype]
    out = {}
    if mix in ("attn", "dec") and cfg.mla is not None:
        out = {"latent": ((batch, cache_len, cfg.mla.kv_lora_rank), dt),
               "k_rope": ((batch, cache_len, cfg.mla.qk_rope_head_dim), dt)}
    elif mix in ("attn", "dec"):
        kv = ((batch, cache_len, cfg.n_kv_heads, cfg.head_dim), dt)
        out = {"k": kv, "v": kv}
    elif mix == "ssm":
        s = cfg.ssm or SSMConfig()
        d_in = s.expand * cfg.d_model
        out = {"conv": ((batch, s.d_conv - 1, d_in), dt),
               "ssm": ((batch, d_in, s.d_state), F32)}
    if mix in ("cross", "dec"):
        mem_len = memory_len(cfg) if mem_len is None else mem_len
        xkv = ((batch, mem_len, cfg.n_kv_heads, cfg.head_dim), dt)
        out.update(xk=xkv, xv=xkv)
    return out


# each cache entry's logical axes (the reference's ``_entry_spec``)
CACHE_AXES = {"k": ("batch", "kv_seq", "kv_heads", None),
              "v": ("batch", "kv_seq", "kv_heads", None),
              "latent": ("batch", "kv_seq", "rank"),
              "k_rope": ("batch", "kv_seq", None),
              "conv": ("batch", None, "d_inner"),
              "ssm": ("batch", "d_inner", None),
              "xk": ("batch", None, "kv_heads", None),
              "xv": ("batch", None, "kv_heads", None)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None, mem_len: Optional[int] = None,
               mesh=None) -> Tree:
    """Zero cache: each prefix layer's entries (:func:`_entry_shapes`;
    ``mem_len`` rows of memory K/V, default :func:`memory_len`), each
    block layer's stacked ``[n_blocks, ...]``.  Under ``mesh`` (default:
    the current one) in the tensor-parallel layout, this rank's slice of
    each entry by the rules (:data:`CACHE_AXES`: rows over the batch axes,
    the sequence over the ``kv_seq`` axes, the Mamba channels over
    ``model``); under the EP-only rules the whole cache."""
    mesh = current_mesh() if mesh is None else mesh
    device = resolve_device(device)
    blocks, n_blocks, n_prefix = block_structure(cfg)
    cut = tensor_parallel(mesh)

    def entries(mix, lead=()):
        out = {}
        for n, (shape, dt) in _entry_shapes(cfg, mix, batch, cache_len,
                                            mem_len).items():
            if cut:
                shape = tuple(c.stop - c.start for c in leaf_cuts(
                    shape, CACHE_AXES[n], mesh))
            out[n] = torch.zeros(lead + shape, dtype=dt, device=device)
        return out

    out = {"blocks": {f"layer{i}": entries(m, (n_blocks,))
                      for i, (m, _) in enumerate(blocks)}}
    if n_prefix:
        kinds = cfg.layer_kinds()
        out["prefix"] = {str(i): entries(kinds[i]) for i in range(n_prefix)}
    return out


# --------------------------------------------------------------------------
# single layer
# --------------------------------------------------------------------------
def _pad_kv(arr: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Pad a prefill KV [B,S,...] out to [B,cache_len,...] with zeros."""
    s = arr.shape[1]
    if s == cache_len:
        return arr
    pad = [0, 0] * (arr.dim() - 2) + [0, cache_len - s]
    return torch.nn.functional.pad(arr, pad)


def n_physical_slots(cfg: ModelConfig, placement=None) -> int:
    """Physical expert-slot count S of the MoE weight arrays: the logical
    expert count for bijective tables, the replica-slot count (>= E) when
    a replication table (3 or 4 entries; ``slot_owner`` is entry 2) is
    passed.  Per-layer tables share S across blocks, so the trailing axis
    is authoritative either way."""
    n_e = cfg.moe.num_experts if cfg.moe is not None else 1
    if placement is not None and len(tuple(placement)) >= 3:
        return int(tuple(placement)[2].shape[-1])
    return n_e


def split_placement(placement, n_blocks: int):
    """(shared, stacked) view of a placement/replication argument.

    A *shared* table — ``(e2r [E], local_slot [E])`` or ``(rep_pos
    [E, R], n_rep [E], slot_owner [S][, split_sched [E, Q]])`` — serves
    every block.  A *per-layer* table carries a leading ``[n_blocks]``
    axis on every entry, and block ``b`` takes its own slice.  Exactly one
    of the returned values is non-None (both None when ``placement`` is
    None)."""
    if placement is None:
        return None, None
    entries = tuple(placement)
    base_ndim = 1 if len(entries) == 2 else 2   # e2r [E] / rep_pos [E, R]
    if entries[0].dim() == base_ndim:
        return entries, None
    assert entries[0].dim() == base_ndim + 1, \
        f"placement entry ndim {entries[0].dim()}, want {base_ndim} " \
        f"(shared) or {base_ndim + 1} (per-layer)"
    for a in entries:
        assert int(a.shape[0]) == n_blocks, (tuple(a.shape), n_blocks)
    return None, entries


def _own_kv_rows(t: torch.Tensor, kv) -> torch.Tensor:
    """This rank's ``kv = (axes, first row, rows)`` rows of a whole
    prompt's cache entry ``t`` [B, S, ...], zero past the prompt."""
    _, lo, n = kv
    part = t[:, lo:lo + n]
    return _pad_kv(part, n) if part.shape[1] < n else part


def _mixer(lp: Tree, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
           positions, pos, cache_in, chunk_len=None, cache_len=0, tp=None,
           kv=None):
    """The layer's self token-mixer output ``o`` and its cache entries
    (None in "train" and "encode"): attention's KV (MLA's latent and
    k_rope), or a Mamba layer's final states (prefill; decode writes them
    into ``cache_in`` in place, as attention writes its KV row).  "encode"
    is an encoder layer's non-causal attention, with no cache.  ``tp``
    (``models.layout.TP``): the tensor-parallel layout, ``x`` the
    residual's layout and ``kv`` the cache's rows this rank holds
    (:func:`kv_layout`)."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if mode not in ("prefill", "chunk", "decode", "train", "encode"):
        raise ValueError(f"mode {mode!r}: the port runs 'prefill', "
                         "'chunk', 'decode', 'train' and 'encode'")
    if "ssm" in lp:
        if mode == "decode":
            o, st = ssm_mod.ssm_decode(lp["ssm"], h, cache_in, cfg, tp)
            for n, t in st.items():
                cache_in[n].copy_(t)
            return o, cache_in
        o, st = ssm_mod.ssm_forward(lp["ssm"], h, cfg, tp)
        return o, (None if mode == "train" else st)
    mla = cfg.mla is not None
    if tp is not None:
        return _tp_mixer(lp["attn"], h, cfg, tp, mode=mode,
                         positions=positions, pos=pos, cache_in=cache_in,
                         chunk_len=chunk_len, kv=kv)
    if mode == "chunk":
        return attn.gqa_chunk(lp["attn"], h, cache_in, cfg,
                              positions=positions, chunk_len=chunk_len)
    if mode == "decode":
        decode = attn.mla_decode if mla else attn.gqa_decode
        return decode(lp["attn"], h, cache_in, cfg, pos=pos)
    if mode == "encode":
        return attn.gqa_forward(lp["attn"], h, cfg, positions=positions,
                                causal=False)[0], None
    forward = attn.mla_forward if mla else attn.gqa_forward
    o, kv = forward(lp["attn"], h, cfg, positions=positions)
    if mode == "train":
        return o, None
    return o, {k: _pad_kv(v, cache_len) for k, v in kv.items()}


def _tp_mixer(p, h, cfg: ModelConfig, tp, *, mode, positions, pos, cache_in,
              chunk_len, kv):
    """An attention mixer in the tensor-parallel layout (``models.layout``,
    ``attention.tp_*``)."""
    mla = cfg.mla is not None
    if mode == "chunk":
        return attn.tp_gqa_chunk(p, h, cache_in, cfg, tp, positions=positions,
                                 chunk_len=chunk_len, cut=kv[0],
                                 kv_off=kv[1])
    if mode == "decode":
        decode = attn.tp_mla_decode if mla else attn.tp_gqa_decode
        return decode(p, h, cache_in, cfg, tp, pos=pos, cut=kv[0],
                      kv_off=kv[1])
    need = mode == "prefill"
    if mla:
        o, new = attn.tp_mla_forward(p, h, cfg, tp, positions=positions,
                                     need_kv=need)
    else:
        o, new = attn.tp_gqa_forward(p, h, cfg, tp, positions=positions,
                                     causal=mode != "encode", need_kv=need)
    if not need:
        return o, None
    return o, {k: _own_kv_rows(v, kv) for k, v in new.items()}


def _cross_part(lp: Tree, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                memory, cache_in, tp=None):
    """A cross-attention layer's residual step (a "cross" layer's, after
    ``norm1``; a "dec" layer's after ``norm_cross``, following its
    self-attention): (x, the memory's K/V as ``xk``/``xv``).  Prefill and
    "train" project ``memory``; decode reads the K/V the prefill cached in
    ``cache_in`` and writes nothing.  A layer without one returns x and
    None.  ``tp``: the tensor-parallel layout (``memory`` whole on every
    rank of ``model``)."""
    if "cross" not in lp:
        return x, None
    hn = rms_norm(x, lp.get("norm_cross", lp["norm1"]), cfg.norm_eps)
    if mode == "decode":
        decode = attn.cross_decode if tp is None else (
            lambda p, h, c, cfg: attn.tp_cross_decode(p, h, c, cfg, tp))
        o, kv = decode(lp["cross"], hn, {"k": cache_in["xk"],
                                         "v": cache_in["xv"]}, cfg)
    elif mode in ("prefill", "train") and tp is not None:
        o, kv = attn.tp_gqa_forward(lp["cross"], hn, cfg, tp, positions=None,
                                    memory=memory, need_kv=mode == "prefill")
        kv = kv or {"k": None, "v": None}
    elif mode in ("prefill", "train"):
        o, kv = attn.cross_forward(lp["cross"], hn, memory, cfg)
    else:
        raise ValueError(f"mode {mode!r}: a cross-attention layer runs "
                         "'prefill', 'decode' and 'train'")
    return x + o, {"xk": kv["k"], "xv": kv["v"]}


def _dense_ffn(p, h, cfg: ModelConfig, d_ff: int, tp):
    if tp is None:
        return ffn_mod.ffn_forward(p, h, cfg)
    return ffn_mod.tp_ffn_forward(p, h, cfg, tp, d_ff)


def _ffn_part(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
              rcfg: ReaLBConfig, ffn: str, *, mode: str, m_state, modality,
              valid=None, placement=None, fsdp=False, tp=None):
    """The layer's dense or MoE FFN on the residual ``x``: (x, m_state,
    aux_scalars, stats, estats, sstats).  ``tp``: the tensor-parallel
    layout (``modality`` and ``valid`` the residual's rows)."""
    n_e = cfg.moe.num_experts if cfg.moe is not None else 1
    n_slot = n_physical_slots(cfg, placement)
    dev = x.device
    aux = {k: torch.zeros((), dtype=F32, device=dev) for k in AUX_KEYS}
    stats = torch.zeros((2,) + tuple(m_state.shape), dtype=F32, device=dev)
    estats = torch.zeros((2, n_e), dtype=F32, device=dev)
    sstats = torch.zeros((2, n_slot), dtype=F32, device=dev)
    if ffn == "dense" and "ffn" in lp:
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + _dense_ffn(lp["ffn"], h2, cfg,
                           cfg.d_ff or cfg.moe.d_ff, tp)
    elif ffn == "moe":
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        y, m_state, moe_aux = ep_moe.ep_moe_forward(
            lp["moe"], h2, cfg, rcfg, m_state, modality,
            mode="broadcast" if mode == "decode" else "dispatch",
            valid=valid, placement=placement, train=mode == "train",
            fsdp=fsdp)
        if "shared" in lp:
            y = y + _dense_ffn(lp["shared"], h2, cfg,
                               cfg.moe.d_ff * cfg.moe.n_shared_experts, tp)
        x = x + y
        aux = {k: moe_aux[k].to(F32) for k in AUX_KEYS}
        stats = torch.stack([
            moe_aux["load_d"].reshape(-1).expand(m_state.numel())
            .reshape(m_state.shape),
            moe_aux["vis_d"].reshape(-1).expand(m_state.numel())
            .reshape(m_state.shape)])
        estats = torch.stack([moe_aux["expert_load"].reshape(-1, n_e).sum(0),
                              moe_aux["expert_vis"].reshape(-1, n_e).sum(0)])
        sstats = torch.stack([moe_aux["slot_load"].reshape(-1, n_slot).sum(0),
                              moe_aux["slot_vis"].reshape(-1, n_slot).sum(0)])
    return x, m_state, aux, stats, estats, sstats


def apply_layer(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                rcfg: ReaLBConfig, ffn: str, *, mode: str, positions, pos,
                cache_in, m_state, modality, chunk_len=None, valid=None,
                cache_len=0, placement=None, fsdp=False, memory=None,
                tp=None, kv=None, spec=None):
    """One attention or Mamba layer, a cross-attention layer, or the two
    attentions of a "dec" layer, then its dense or MoE FFN.  ``mode``:
    "prefill" (whole prompts; the KV comes back padded to ``cache_len``, a
    Mamba layer's final states as they are, the memory's K/V at its own
    length), "chunk" or "decode" (the new rows, or a Mamba layer's new
    states, written into ``cache_in`` in place, whose tensors come back as
    ``cache_out``; the memory's K/V are read), "train" (whole sequences,
    no cache, ``cache_out`` None; the MoE layer in its training form) or
    "encode" (an encoder layer: non-causal, no cache).  ``tp`` (with the
    layer's ``spec``): the tensor-parallel layout (``models.layout``): the
    layer's weights are gathered and marked first (``layout.prepare``;
    without ``spec`` the caller did it);
    in prefill the KV comes back as this rank's rows ``kv`` of the cache.
    Returns (x, cache_out, m_state, aux_scalars, stats, estats, sstats)."""
    if spec is not None:
        lp = layout.prepare(lp, spec, tp)
    new = None
    if "attn" in lp or "ssm" in lp:
        o, new = _mixer(lp, x, cfg, mode=mode, positions=positions, pos=pos,
                        cache_in=cache_in, chunk_len=chunk_len,
                        cache_len=cache_len, tp=tp, kv=kv)
        x = x + o
    x, xkv = _cross_part(lp, x, cfg, mode=mode, memory=memory,
                         cache_in=cache_in, tp=tp)
    if xkv is not None and mode != "train":
        new = {**(new or {}), **xkv}
    x, m_state, aux, stats, estats, sstats = _ffn_part(
        lp, x, cfg, rcfg, ffn, mode=mode, m_state=m_state,
        modality=modality, valid=valid, placement=placement, fsdp=fsdp,
        tp=tp)
    return x, new, m_state, aux, stats, estats, sstats


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------
class ForwardResult(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Tree]
    m_state: torch.Tensor
    aux: Dict[str, torch.Tensor]


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           vision_embeds: Optional[torch.Tensor] = None,
           mode: str = "decode", tp=None) -> torch.Tensor:
    """Token embeddings.  In a VLM (``family="vlm"``) ``vision_embeds``
    [B, N, D] overwrite the leading N rows of every sequence, after the
    sqrt(d) scale, except in decode (the reference's
    ``dynamic_update_slice``); a MoE backbone such as moonshot ignores
    them, as the reference does.  ``tp``: the tensor-parallel layout,
    ``tokens`` the rank's rows' whole sequence, the result the residual's
    layout: a vocabulary cut over ``model`` is looked up masked to the
    rank's ids and summed over ``model`` (one id a rank: exact), the sum
    reduce-scattered over the sequence (decode: all-reduced)."""
    dt = DTYPES[cfg.param_dtype]
    if tp is None:
        x = params["embed"][tokens.long()].to(dt)
    else:
        table = layout.prepare(params["embed"], model_spec(cfg)["embed"], tp)
        t = tokens.long()
        if tp.divides(cfg.vocab_size):
            v0, v1 = tp.cut(cfg.vocab_size)
            mine = ((t >= v0) & (t < v1))[..., None].to(dt)
            x = tp.reduce_out(table[(t - v0).clamp(0, v1 - v0 - 1)].to(dt)
                              * mine)
        else:
            x = table[tp.own_rows(t)].to(dt)
    if cfg.embed_scale_sqrt_d:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    if cfg.family == "vlm" and vision_embeds is not None \
            and mode != "decode":
        n = vision_embeds.shape[1]
        if n > tokens.shape[1]:
            raise ValueError(f"{n} rows of vision embeds over a sequence "
                             f"of {tokens.shape[1]}")
        if tp is None:
            return torch.cat([vision_embeds.to(dt), x[:, n:]], dim=1)
        vis = _pad_kv(vision_embeds.to(dt), tokens.shape[1])
        at = tp.seq_offset + torch.arange(x.shape[1], device=x.device)
        x = torch.where((at < n)[None, :, None], tp.own_rows(vis), x)
    return x


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits_of(x, params["embed"].t() if cfg.tie_embeddings
                      else params["unembed"], cfg)


def _tp_head(params, cfg: ModelConfig, tp) -> Dict[str, torch.Tensor]:
    """``final_norm`` and the output projection, prepared for the layout
    (``unembed`` [D, V/model], or the tied table's transpose)."""
    spec = model_spec(cfg)
    names = ("final_norm", "embed" if cfg.tie_embeddings else "unembed")
    out = layout.prepare({k: params[k] for k in names},
                         {k: spec[k] for k in names}, tp)
    return {"final_norm": out["final_norm"],
            "unembed": out["embed"].t() if cfg.tie_embeddings
            else out["unembed"]}


def _tp_logits(params, cfg: ModelConfig, x: torch.Tensor, tp,
               rows_cut: bool) -> torch.Tensor:
    """Serving's logits of ``x`` [B/rows, n, D] (whole on every rank of
    ``model``) in the layout: the rank's vocabulary slice, then every
    rank's gathered over ``model`` and the rows over the batch axes, so
    every rank samples from the whole batch's whole logits."""
    head = _tp_head(params, cfg, tp)
    logits = _logits_of(rms_norm(x, head["final_norm"], cfg.norm_eps),
                        head["unembed"], cfg)
    comm = tp.comm
    if tp.divides(cfg.vocab_size):
        logits = comm._whole(logits, -1, "model", "logits_all_gather")
    if rows_cut:
        logits = comm._whole(logits, 0, ROWS, "logits_all_gather")
    return logits


def _tp_train_logits(params, cfg: ModelConfig, x: torch.Tensor, tp
                     ) -> torch.Tensor:
    """Training's logits in the layout (:func:`logits_layout`): a
    vocabulary cut over ``model`` gives the rank's slice ``[B/rows, S,
    V/model]`` of the whole sequence (gathered), else the rank's rows
    ``[B/rows, S/model, V]``."""
    head = _tp_head(params, cfg, tp)
    x = rms_norm(x, head["final_norm"], cfg.norm_eps)
    if tp.divides(cfg.vocab_size):
        x = tp.comm.gather_cat(x, 1)
    return _logits_of(x, head["unembed"], cfg)


def _logits_of(x, w, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits of ``x`` through the output projection ``w`` [D, V]
    (soft-capped where the config says)."""
    logits = torch.matmul(x, w.to(x.dtype)).to(F32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def logits_layout(cfg: ModelConfig) -> Optional[str]:
    """How ``train_forward``'s logits lie under the current mesh: None
    (whole vocabulary, this data row's rows; no mesh, or the EP-only
    rules), ``"vocab"`` (the tensor-parallel layout with a vocabulary that
    divides over ``model``: the rank's vocabulary slice of the whole
    sequence) or ``"seq"`` (one that does not: the rank's rows of the
    sequence, every id)."""
    mesh = current_mesh()
    if not tensor_parallel(mesh):
        return None
    return "vocab" if cfg.vocab_size % mesh.size("model") == 0 else "seq"


def _last_rows(x: torch.Tensor, tp, last: torch.Tensor) -> torch.Tensor:
    """Row ``last[b]`` of each batch row's sequence of the residual ``x``
    (sequence-parallel: taken by the rank that holds it and gathered over
    ``model``, no arithmetic), ``[B, 1, D]``."""
    ar = torch.arange(x.shape[0], device=x.device)
    if not tp.sp:
        return x[ar, last][:, None, :]
    owner = torch.div(last, tp.s_local, rounding_mode="floor")
    mine = x[ar, (last - owner * tp.s_local).clamp(0, tp.s_local - 1)]
    every = tp.comm._gather(mine.contiguous(), "model", "last_row_all_gather")
    return every[owner, ar][:, None, :]


def _in_mesh(fn):
    """``fn`` run under the mesh and rules in force where it was made (a
    checkpointed recompute runs on autograd's thread, where the mesh
    context, thread-local, is not set)."""
    mesh, rules = current_mesh(), current_rules()

    def run(*args):
        with use_mesh(mesh, rules=rules):
            return fn(*args)
    return run


def _run_stack(params, cfg, rcfg, x, *, mode, positions, pos, cache,
               m_state, modality, chunk_len=None, valid=None, cache_len=0,
               placement=None, fsdp=False, memory=None, tp=None, kv=None,
               b_global=None):
    """Prefix layers, then a loop over the stacked blocks; the cache is
    updated in place and returned: a chunk or decode writes only its new
    rows (``attention.write_rows_``), a prefill fills a new zero cache of
    ``cache_len`` rows with each layer's padded KV (and the memory's K/V,
    at the memory's own length), "train" has none.  A
    shared placement table serves every block; a per-layer one gives block
    ``b`` its slice ``b`` (views, no copy).  In "train" ``cfg.remat``
    picks what the backward recomputes (:func:`_train_block`).  ``tp``,
    ``kv``, ``b_global``: the tensor-parallel layout, the cache's rows
    this rank holds and the whole batch (a prefill's new cache is this
    rank's slice of it)."""
    blocks, n_blocks, n_prefix = block_structure(cfg)
    place_shared, place_stacked = split_placement(placement, n_blocks)
    if mode == "prefill":
        cache = init_cache(cfg, x.shape[0] if b_global is None else b_global,
                           cache_len, x.device, mem_len=(
                               None if memory is None else memory.shape[1]))
    aux_acc = {k: torch.zeros((), dtype=F32, device=x.device)
               for k in AUX_KEYS}
    kw = dict(mode=mode, positions=positions, pos=pos, modality=modality,
              chunk_len=chunk_len, valid=valid, cache_len=cache_len,
              fsdp=fsdp, memory=memory, tp=tp, kv=kv)
    kinds = cfg.layer_kinds()
    for i in range(n_prefix):
        c = None if cache is None else cache["prefix"][str(i)]
        x, co, m_state, aux, _, _, _ = apply_layer(
            params["prefix"][str(i)], x, cfg, rcfg, "dense",
            cache_in=c, m_state=m_state,
            spec=layer_spec(cfg, kinds[i], "dense") if tp else None, **kw)
        if mode == "prefill":
            for n, t in co.items():
                c[n].copy_(t)
        aux_acc = {k: aux_acc[k] + aux[k] for k in AUX_KEYS}

    specs = [layer_spec(cfg, m, f) if tp else None for m, f in blocks]
    stats_b, estats_b, sstats_b = [], [], []
    for b in range(n_blocks):
        place_b = place_shared if place_stacked is None \
            else tuple(a[b] for a in place_stacked)
        if mode == "train":
            x, m_state, aux_b, st, es, ss = _train_block(
                params, cfg, rcfg, blocks, b, x, m_state, place_b,
                specs=specs, **kw)
            aux_acc = {k: aux_acc[k] + aux_b[k] for k in AUX_KEYS}
            stats_b.append(st)
            estats_b.append(es)
            sstats_b.append(ss)
            continue
        st = torch.zeros((2,) + tuple(m_state.shape), dtype=F32,
                         device=x.device)
        es = ss = 0
        for i, (_, f) in enumerate(blocks):
            lp = _index(params["blocks"][f"layer{i}"], b)
            c = cache["blocks"][f"layer{i}"]
            x, co, m_state, aux, stats, estats, sstats = apply_layer(
                lp, x, cfg, rcfg, f, cache_in={n: t[b] for n, t in c.items()},
                m_state=m_state, placement=place_b, spec=specs[i], **kw)
            if mode == "prefill":
                for n, t in co.items():
                    c[n][b].copy_(t)
            aux_acc = {k: aux_acc[k] + aux[k] for k in AUX_KEYS}
            st, es, ss = st + stats, es + estats, ss + sstats
        stats_b.append(st)
        estats_b.append(es)
        sstats_b.append(ss)
    aux_acc["moe_stats"] = torch.stack(stats_b)      # [n_blocks, 2, 1, ep]
    aux_acc["expert_stats"] = torch.stack(estats_b)  # [n_blocks, 2, E]
    aux_acc["slot_stats"] = torch.stack(sstats_b)    # [n_blocks, 2, S]
    return x, cache, m_state, aux_acc


def _train_block(params, cfg, rcfg, blocks, b, x, m_state, placement,
                 specs=None, **kw):
    """Block ``b`` in "train": (x, m_state, aux, stats, estats, sstats).

    ``cfg.remat`` (the reference's policies, with
    ``torch.utils.checkpoint``, non-reentrant): "none" keeps every
    activation; "full" checkpoints the block, so the backward reruns it
    from its input; "attn_out" checkpoints each layer's self-attention (or
    Mamba mixer) and the rest of the layer apart, so each such output is a
    saved boundary and the rest, a cross-attention included (the
    reference names only the self-attention's output), is recomputed.  A
    recompute gives the same values; what the block returns (``m_state``,
    the statistics) is the first pass's. Kernel launch counters count the
    recompute too. Under a mesh the recompute runs whole (checkpoint's early
    stop off), so every rank re-issues every collective of the checkpointed
    part, in order, and under the mesh and rules of the forward: on a card
    it runs on autograd's thread, where the mesh context (thread-local) is
    not set.  In the tensor-parallel layout each layer's weights are
    gathered (``layout.prepare``) inside what is checkpointed, so a
    recompute gathers them again."""
    mesh = current_mesh()
    tp = kw["tp"]

    def layer(i, f, x, m):
        lp = _index(params["blocks"][f"layer{i}"], b)
        if tp is not None:
            lp = layout.prepare(lp, specs[i], tp)
        if cfg.remat != "attn_out":
            x, _, m, aux, st, es, ss = apply_layer(
                lp, x, cfg, rcfg, f, cache_in=None, m_state=m,
                placement=placement, **kw)
            return x, m, aux, st, es, ss

        def rest(x, m):
            x, _ = _cross_part(lp, x, cfg, mode=kw["mode"],
                               memory=kw["memory"], cache_in=None, tp=tp)
            return _ffn_part(lp, x, cfg, rcfg, f, m_state=m,
                             placement=placement, **{
                                 k: kw[k] for k in ("mode", "modality",
                                                    "valid", "fsdp", "tp")})
        if "attn" not in lp and "ssm" not in lp:
            return checkpoint(_in_mesh(rest), x, m, use_reentrant=False)
        o = checkpoint(_in_mesh(lambda x: _mixer(lp, x, cfg, cache_in=None,
                                                 tp=tp, kv=None, **{
            k: kw[k] for k in ("mode", "positions", "pos")})[0]), x,
            use_reentrant=False)
        return checkpoint(_in_mesh(lambda x, o, m: rest(x + o, m)), x, o, m,
                          use_reentrant=False)

    def block(x, m):
        aux_b = {k: torch.zeros((), dtype=F32, device=x.device)
                 for k in AUX_KEYS}
        st = torch.zeros((2,) + tuple(m.shape), dtype=F32, device=x.device)
        es = ss = 0
        for i, (_, f) in enumerate(blocks):
            x, m, aux, stats, estats, sstats = layer(i, f, x, m)
            aux_b = {k: aux_b[k] + aux[k] for k in AUX_KEYS}
            st, es, ss = st + stats, es + estats, ss + sstats
        return x, m, aux_b, st, es, ss

    if cfg.remat not in ("none", "full", "attn_out"):
        raise ValueError(f"remat {cfg.remat!r}: 'none', 'full' or "
                         "'attn_out'")
    whole = set_checkpoint_early_stop(False) if mesh is not None \
        else contextlib.nullcontext()
    with whole:
        if cfg.remat == "full":
            return checkpoint(_in_mesh(block), x, m_state,
                              use_reentrant=False)
        return block(x, m_state)


def _index(tree: Tree, b: int) -> Tree:
    """Block ``b`` of stacked ``[n_blocks, ...]`` parameters (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    return tree[b]


def _prepare_inputs(cfg: ModelConfig, batch, mode: str):
    """(tokens, modality): modality defaults to all text, or, in a VLM
    outside decode, to vision at the first ``n_vision_tokens``
    positions."""
    tokens = batch["tokens"]
    modality = batch.get("modality")
    if modality is None:
        b, s = tokens.shape
        if cfg.family == "vlm" and mode != "decode":
            modality = (torch.arange(s, device=tokens.device)[None, :]
                        < cfg.n_vision_tokens).expand(b, s)
        else:
            modality = torch.zeros(tokens.shape, dtype=torch.bool,
                                   device=tokens.device)
    return tokens, modality


def _encode(params, cfg: ModelConfig, rcfg: ReaLBConfig, enc_embeds,
            m_state, train: bool = False) -> torch.Tensor:
    """The encoder of an encoder-decoder: ``n_enc_layers`` non-causal
    attention + dense FFN layers over ``enc_embeds`` [B, T, D] (cast to
    the parameter dtype), then ``enc_norm``.  In training under
    ``remat="full"`` each layer is checkpointed, as the reference's
    ``jax.checkpoint`` of its scan body.  In the tensor-parallel layout
    the encoder's residual is sequence-parallel where ``T`` divides over
    ``model`` (its output gathered whole, the gather's transpose summing
    the cross layers' partial cotangents), else whole on every rank (its
    output entered: the same sum)."""
    x = enc_embeds.to(DTYPES[cfg.param_dtype])
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    mesh = current_mesh()
    tp = None
    if tensor_parallel(mesh):
        tp = layout.TP(mesh, t % mesh.size("model") == 0, train, t)
        x = tp.own_rows(x)
    spec = layer_spec(cfg, "attn", "dense") if tp else None

    def layer(lp, h):
        return apply_layer(lp, h, cfg, rcfg, "dense", mode="encode",
                           positions=positions, pos=None, cache_in=None,
                           m_state=m_state, modality=None, tp=tp,
                           spec=spec)[0]
    # under a mesh a recompute re-issues every collective (no early stop)
    with set_checkpoint_early_stop(False) if mesh is not None \
            else contextlib.nullcontext():
        for i in range(cfg.n_enc_layers):
            lp = _index(params["enc_blocks"]["layer0"], i)
            if train and cfg.remat == "full":
                x = checkpoint(_in_mesh(layer), lp, x, use_reentrant=False)
            else:
                x = layer(lp, x)
    if tp is None:
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)
    norm = layout.prepare(params["enc_norm"], model_spec(cfg)["enc_norm"], tp)
    x = rms_norm(x, norm, cfg.norm_eps)
    return tp.comm.gather_cat(x, 1) if tp.sp else tp.enter(x)


def _memory(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch, m_state,
            rows: slice = slice(None), train: bool = False):
    """What the cross-attention layers attend to (None without them): an
    encoder-decoder's encoded ``enc_embeds``, a VLM's ``vision_embeds``;
    ``rows`` of the batch."""
    name = "enc_embeds" if cfg.is_encdec else (
        "vision_embeds" if cfg.family == "vlm" else None)
    if name is None:
        return None
    if batch.get(name) is None:
        raise ValueError(f"{cfg.name}: the batch has no {name!r} (its "
                         "cross-attention layers' memory)")
    if cfg.is_encdec:
        return _encode(params, cfg, rcfg, batch[name][rows], m_state, train)
    return batch[name][rows]


def _tp_begin(cfg: ModelConfig, mesh, b: int, s: int, mode: str,
              train: bool = False):
    """The layout of a forward of ``b`` rows of ``s`` tokens: (TP, the
    rank's rows).  A chunk, a training step or a MoE stack's prefill
    needs a sequence that divides over ``model``."""
    m = mesh.size("model")
    sp = mode != "decode" and s % m == 0
    if mode != "decode" and not sp and (mode in ("chunk", "train")
                                        or cfg.moe is not None):
        raise ValueError(f"a seq dim of {s} does not divide over the {m} "
                         "ranks of the mesh's 'model' axis")
    rows = local_slice(b, "batch", mesh)
    if train and rows.stop - rows.start == b and mesh.size(ROWS) > 1:
        raise ValueError(f"a training batch of {b} rows does not divide "
                         f"over the {mesh.size(ROWS)} data rows")
    return layout.TP(mesh, sp, train, s), rows


def prefill_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                    m_state, cache_len: int = 0,
                    placement=None) -> ForwardResult:
    """One-shot prefill of whole prompts.  batch: tokens [B,S], modality
    [B,S] (optional), vision_embeds [B,S_v,D] (a VLM's memory, required
    there; ignored by a MoE backbone), enc_embeds [B,T,D] (an
    encoder-decoder's encoder input, required there).  Every token is
    real.  Returns the logits at the last position and a cache of
    ``cache_len`` rows (default S) holding the prompt's KV at rows [0, S)
    and zeros after, and the memory's K/V at its own length.  In the
    tensor-parallel layout every rank passes the whole batch and gets the
    whole logits; the cache is its slice (:func:`init_cache`)."""
    tokens, modality = _prepare_inputs(cfg, batch, "prefill")
    b, s = tokens.shape
    cache_len = cache_len or s
    mesh = current_mesh()
    tp = rows = kv = None
    if tensor_parallel(mesh):
        tp, rows = _tp_begin(cfg, mesh, b, s, "prefill")
        tokens, modality = tokens[rows], modality[rows]
        kv = kv_layout(mesh, b, cache_len)
    bl = tokens.shape[0]
    positions = torch.arange(s, device=tokens.device)[None, :].expand(bl, s)
    memory = _memory(params, cfg, rcfg, batch, m_state,
                     slice(None) if rows is None else rows)
    vision = batch.get("vision_embeds")
    if vision is not None and rows is not None:
        vision = vision[rows]
    x = _embed(params, cfg, tokens, vision, "prefill", tp=tp)
    x, cache, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="prefill", positions=positions, pos=None,
        cache=None, m_state=m_state,
        modality=modality if tp is None else tp.own_rows(modality),
        cache_len=cache_len, placement=placement, memory=memory, tp=tp,
        kv=kv, b_global=b)
    if tp is None:
        logits = _unembed(params, cfg, x[:, -1:, :])
    else:
        last = torch.full((bl,), s - 1, dtype=torch.long, device=x.device)
        logits = _tp_logits(params, cfg, _last_rows(x, tp, last), tp,
                            bl < b)
    return ForwardResult(logits[:, 0], cache, m_state, aux)


def chunk_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                  cache, m_state, placement=None) -> ForwardResult:
    """Chunked-prefill continuation step against a partially-filled cache.

    batch: tokens [B,S] (one prompt chunk per row), start [B] (absolute
    position of each row's first chunk token), chunk_len [B] (valid tokens
    per row; 0 = idle row), modality [B,S].  Each row writes its chunk's KV
    at [start, start+chunk_len) and attends causally to its own prefix.
    Returns logits at every row's last valid chunk position.  Only
    all-GQA stacks continue a chunk (no SSM state threading, no MLA
    latent cache continued mid-prompt, no memory of cross-attention
    layers), as in the reference.  In the tensor-parallel layout the
    cache is the rank's slice and S must divide over ``model``.
    """
    if cfg.layer_pattern != "attn" or cfg.ssm is not None \
            or cfg.mla is not None or cfg.is_encdec:
        raise ValueError("chunked prefill supports plain-attention "
                         "(GQA/MQA) stacks only")
    tokens, modality = _prepare_inputs(cfg, batch, "chunk")
    start, chunk_len = batch["start"], batch["chunk_len"]
    b, s = tokens.shape
    mesh = current_mesh()
    tp = kv = None
    if tensor_parallel(mesh):
        tp, rows = _tp_begin(cfg, mesh, b, s, "chunk")
        tokens, modality = tokens[rows], modality[rows]
        start, chunk_len = start[rows], chunk_len[rows]
        kv = cache_kv_layout(cfg, cache, b, mesh)
    bl = tokens.shape[0]
    dev = tokens.device
    ar = torch.arange(s, device=dev)
    positions = start[:, None] + ar[None, :]
    valid = ar[None, :] < chunk_len[:, None]
    x = _embed(params, cfg, tokens, tp=tp)
    if tp is not None:
        modality, valid = tp.own_rows(modality), tp.own_rows(valid)
    x, cache, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="chunk", positions=positions, pos=start,
        cache=cache, m_state=m_state, modality=modality,
        chunk_len=chunk_len, valid=valid, placement=placement, tp=tp, kv=kv)
    last = torch.clamp(chunk_len - 1, 0, s - 1).long()
    if tp is None:
        logits = _unembed(params, cfg, x[torch.arange(b, device=dev),
                                         last][:, None, :])
    else:
        logits = _tp_logits(params, cfg, _last_rows(x, tp, last), tp,
                            bl < b)
    return ForwardResult(logits[:, 0], cache, m_state, aux)


def decode_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                   cache, m_state, placement=None) -> ForwardResult:
    """batch: tokens [B,1], pos [B], modality [B,1] (vision flag of the new
    token), valid [B,1] (False = dummy slot excluded from routing stats).
    In the tensor-parallel layout the cache is the rank's slice; the
    step's sequence of one is whole on every rank of ``model``."""
    tokens, modality = _prepare_inputs(cfg, batch, "decode")
    pos, valid = batch["pos"], batch.get("valid")
    mesh = current_mesh()
    tp = kv = None
    b = tokens.shape[0]
    if tensor_parallel(mesh):
        tp, rows = _tp_begin(cfg, mesh, b, 1, "decode")
        tokens, modality, pos = tokens[rows], modality[rows], pos[rows]
        valid = None if valid is None else valid[rows]
        kv = cache_kv_layout(cfg, cache, b, mesh)
    x = _embed(params, cfg, tokens, tp=tp)
    x, cache, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="decode", positions=None, pos=pos,
        cache=cache, m_state=m_state, modality=modality,
        valid=valid, placement=placement, tp=tp, kv=kv)
    logits = _unembed(params, cfg, x) if tp is None else \
        _tp_logits(params, cfg, x, tp, tokens.shape[0] < b)
    return ForwardResult(logits[:, 0], cache, m_state, aux)


def _train_rows(b: int, m_state) -> slice:
    """The rows of the global batch this rank trains on: under a mesh with
    one ``m_state`` group a data row (or in the tensor-parallel layout),
    its data row's ``B/data``; else all."""
    mesh = current_mesh()
    if tensor_parallel(mesh):
        return local_slice(b, "batch", mesh)
    if mesh is None or m_state.dim() != 2 or m_state.shape[0] == 1:
        return slice(0, b)
    return local_slice(b, "batch", mesh)


def train_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                  m_state, placement=None) -> ForwardResult:
    """Logits ``[B, S, V]`` (f32) of whole sequences and the MoE statistics,
    with no cache: batch tokens [B,S], modality [B,S] (optional), and the
    memory where the stack has cross-attention layers (``vision_embeds``
    [B,N,D], ``enc_embeds`` [B,T,D], as in prefill).  The MoE
    layers run their training form (FP4 off, the BF16 expert FFN with its
    gradient kernel; the policy and its AIMD update still run), and
    ``cfg.remat`` sets what the backward recomputes.  Under a mesh (see
    the module docstring) every rank passes the global batch; the logits
    are those of its data row's rows (its memory rows too), as
    :func:`logits_layout` says, ``m_state`` and the statistics the global
    ones.  A Mamba layer runs its whole-sequence form from zero state, as
    in prefill."""
    tokens, modality = _prepare_inputs(cfg, batch, "train")
    mesh = current_mesh()
    tp = None
    if tensor_parallel(mesh):
        tp, rows = _tp_begin(cfg, mesh, *tokens.shape, "train", train=True)
    else:
        rows = _train_rows(tokens.shape[0], m_state)
    tokens, modality = tokens[rows], modality[rows]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    memory = _memory(params, cfg, rcfg, batch, m_state, rows, train=True)
    vision = batch.get("vision_embeds")
    x = _embed(params, cfg, tokens, None if vision is None else vision[rows],
               "train", tp=tp)
    x, _, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="train", positions=positions, pos=None,
        cache=None, m_state=m_state,
        modality=modality if tp is None else tp.own_rows(modality),
        placement=placement, fsdp=mesh is not None, memory=memory, tp=tp)
    logits = _unembed(params, cfg, x) if tp is None else \
        _tp_train_logits(params, cfg, x, tp)
    return ForwardResult(logits, None, m_state, aux)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  layout: Optional[str] = None) -> torch.Tensor:
    """Mean token CE. logits [B,S,V] f32, labels [B,S] int (-1 = pad).
    Under a mesh with data rows, ``logits`` and ``labels`` are this data
    row's rows and the mean is the global one: the numerator and the
    denominator summed over the batch axes (not the mean of the rows'
    means).  ``layout`` (:func:`logits_layout`): ``"vocab"``, ``logits``
    the rank's vocabulary slice (the max, the sum of exponentials and the
    label's logit reduced over ``model``); ``"seq"``, the rank's rows of
    the sequence (``labels`` too; the sums over ``model`` as well)."""
    mask = (labels >= 0).to(F32)
    mesh = current_mesh()
    if layout == "vocab":
        comm = ep_moe._dist_comm(mesh)
        n = logits.shape[-1]
        v0 = mesh.index("model") * n
        top = comm.all_max(logits.detach().amax(dim=-1))
        se = comm.ordered_sum(torch.exp(logits - top[..., None]).sum(-1))
        lse = torch.log(se) + top
        idx = (labels.long() - v0)
        mine = ((idx >= 0) & (idx < n)).to(F32)
        ll = comm.ordered_sum(torch.gather(
            logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0] * mine)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    num, den = nll.sum(), mask.sum()
    axes = ROWS + ("model",) if layout == "seq" else ROWS
    if mesh is not None and mesh.size(axes) > 1:
        num, den = ep_moe._dist_comm(mesh).psum(
            [num.reshape(1), den.reshape(1)], axis=axes)
        num, den = num.reshape(()), den.reshape(())
    return num / torch.clamp(den, min=1.0)


def train_loss(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
               m_state) -> Tuple[torch.Tensor, Tuple[torch.Tensor, Dict]]:
    """(loss, (m_state, metrics)): the CE plus the MoE load-balance and
    router-z losses at the config's coefficients; metrics ``ce`` and the
    MoE scalars, detached.  Under a mesh the loss is the global one, the
    same on every rank."""
    res = train_forward(params, cfg, rcfg, batch, m_state)
    labels = batch["labels"]
    labels = labels[_train_rows(labels.shape[0], m_state)]
    lay = logits_layout(cfg)
    if lay == "seq":
        m = current_mesh().size("model")
        n = labels.shape[1] // m
        labels = labels.narrow(1, current_mesh().index("model") * n, n)
    ce = cross_entropy(res.logits, labels, lay)
    loss = ce
    if cfg.moe is not None:
        loss = (loss + cfg.moe.aux_loss_coef * res.aux["lb_loss"]
                + cfg.moe.router_z_coef * res.aux["z_loss"])
    metrics = {"ce": ce.detach(),
               **{k: res.aux[k].detach() for k in AUX_KEYS}}
    return loss, (res.m_state, metrics)
