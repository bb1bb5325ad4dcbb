"""Decoder stack of the port (moonshot layout) with the ReaLB MoE layers.

Counterpart of the attention-stack part of ``repro.models.transformer``:
leading dense "prefix" layers, then ``n_blocks`` identical blocks whose
parameters (and KV caches) are stacked along a leading ``[n_blocks]`` dim.
The reference scans over that dim; the port loops over block indices and
updates the stacked KV cache in place.  The AIMD ``m_state`` threads
through the loop (each MoE layer applies one control update).

Entry points: ``init_model``, ``init_cache``, ``prefill_forward`` (one-shot
prefill of whole prompts, returning a cache padded to ``cache_len``),
``chunk_forward`` (chunked prefill against the cache) and ``decode_forward``
(one token per row).  They run on ``cuda`` unless the caller passes
``device="cpu"``, and none of them reads the device on the host.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ReaLBConfig
from repro_torch.core import ep_moe
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (DTYPES, P, init_params, resolve_device,
                                       rms_norm)

Tree = Any
AUX_KEYS = ep_moe.AUX_SCALARS
F32 = torch.float32


# --------------------------------------------------------------------------
# block layout and parameters
# --------------------------------------------------------------------------
def block_structure(cfg: ModelConfig) -> Tuple[Tuple[Tuple[str, str], ...],
                                               int, int]:
    """(block_layout, n_blocks, n_prefix). Layout entries: (mix, ffn)."""
    kinds = [(m, "none" if (f == "dense" and cfg.d_ff == 0) else f)
             for m, f in zip(cfg.layer_kinds(), cfg.ffn_kinds())]
    n_prefix = cfg.n_dense_layers
    rest = kinds[n_prefix:]
    period = cfg.scan_period
    layout = tuple(rest[:period])
    for i in range(0, len(rest), period):
        if tuple(rest[i:i + period]) != layout:
            raise ValueError("non-periodic layer stack")
    return layout, len(rest) // period, n_prefix


def moe_spec(cfg: ModelConfig) -> Dict[str, P]:
    e, d = cfg.moe, cfg.d_model
    return {
        "router": P((d, e.num_experts), dtype="float32"),
        "w_gate": P((e.num_experts, d, e.d_ff)),
        "w_up": P((e.num_experts, d, e.d_ff)),
        "w_down": P((e.num_experts, e.d_ff, d)),
    }


def layer_spec(cfg: ModelConfig, ffn: str) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"norm1": P((d,), init="zeros"),
                            "attn": attn.gqa_spec(cfg)}
    if ffn != "none":
        spec["norm2"] = P((d,), init="zeros")
    if ffn == "dense":
        spec["ffn"] = ffn_mod.ffn_spec(d, cfg.d_ff or cfg.moe.d_ff,
                                       cfg.activation)
    elif ffn == "moe":
        spec["moe"] = moe_spec(cfg)
        if cfg.moe.n_shared_experts:
            spec["shared"] = ffn_mod.ffn_spec(
                d, cfg.moe.d_ff * cfg.moe.n_shared_experts, cfg.activation)
    return spec


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    layout, _, n_prefix = block_structure(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    spec: Dict[str, Any] = {
        "embed": P((v, d), init="embed", scale=0.02),
        "final_norm": P((d,), init="zeros"),
        "blocks": {f"layer{i}": layer_spec(cfg, f)
                   for i, (_, f) in enumerate(layout)},
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = P((d, v))
    if n_prefix:
        spec["prefix"] = {str(i): layer_spec(cfg, "dense")
                          for i in range(n_prefix)}
    return spec


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Tree:
    """Random parameters from a seeded ``torch.Generator`` on the device,
    under the reference's key paths and layouts."""
    device = resolve_device(device)
    spec = model_spec(cfg)
    _, n_blocks, _ = block_structure(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {k: init_params(v, gen, cfg.param_dtype, device)
              for k, v in spec.items() if k != "blocks"}
    params["blocks"] = init_params(spec["blocks"], gen, cfg.param_dtype,
                                   device, stack=n_blocks)
    return params


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> Tree:
    """Zero KV cache: prefix ``k``/``v [B, L, K, Dh]``, blocks
    ``[n_blocks, B, L, K, Dh]``."""
    device = resolve_device(device)
    layout, n_blocks, n_prefix = block_structure(cfg)
    dt = DTYPES[cfg.param_dtype]
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)

    def kv(lead=()):
        return {n: torch.zeros(lead + shape, dtype=dt, device=device)
                for n in ("k", "v")}

    out = {"blocks": {f"layer{i}": kv((n_blocks,))
                      for i in range(len(layout))}}
    if n_prefix:
        out["prefix"] = {str(i): kv() for i in range(n_prefix)}
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


def apply_layer(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                rcfg: ReaLBConfig, ffn: str, *, mode: str, positions, pos,
                cache_in, m_state, modality, chunk_len=None, valid=None,
                cache_len=0, placement=None):
    """One attention layer plus its dense or MoE FFN.  ``mode``: "prefill"
    (whole prompts; the KV comes back padded to ``cache_len``), "chunk" or
    "decode".  Returns (x, cache_out, m_state, aux_scalars, stats, estats,
    sstats)."""
    n_e = cfg.moe.num_experts if cfg.moe is not None else 1
    n_slot = n_physical_slots(cfg, placement)
    dev = x.device
    aux = {k: torch.zeros((), dtype=F32, device=dev) for k in AUX_KEYS}
    stats = torch.zeros((2,) + tuple(m_state.shape), dtype=F32, device=dev)
    estats = torch.zeros((2, n_e), dtype=F32, device=dev)
    sstats = torch.zeros((2, n_slot), dtype=F32, device=dev)

    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if mode == "chunk":
        o, kv = attn.gqa_chunk(lp["attn"], h, cache_in, cfg,
                               positions=positions, chunk_len=chunk_len)
    elif mode == "decode":
        o, kv = attn.gqa_decode(lp["attn"], h, cache_in, cfg, pos=pos)
    elif mode == "prefill":
        o, kv = attn.gqa_forward(lp["attn"], h, cfg, positions=positions)
        kv = {k: _pad_kv(v, cache_len) for k, v in kv.items()}
    else:
        raise ValueError(f"mode {mode!r}: the port runs 'prefill', 'chunk' "
                         "and 'decode'")
    x = x + o

    if ffn == "dense" and "ffn" in lp:
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_forward(lp["ffn"], h2, cfg)
    elif ffn == "moe":
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        y, m_state, moe_aux = ep_moe.ep_moe_forward(
            lp["moe"], h2, cfg, rcfg, m_state, modality,
            mode="broadcast" if mode == "decode" else "dispatch",
            valid=valid, placement=placement)
        if "shared" in lp:
            y = y + ffn_mod.ffn_forward(lp["shared"], h2, cfg)
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
    return x, kv, m_state, aux, stats, estats, sstats


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
           mode: str = "decode") -> torch.Tensor:
    """Token embeddings.  ``vision_embeds`` replace the leading rows only in
    a VLM (``family="vlm"``, not ported); a MoE backbone such as moonshot
    ignores them, as the reference does."""
    dt = DTYPES[cfg.param_dtype]
    x = params["embed"][tokens.long()].to(dt)
    if cfg.embed_scale_sqrt_d:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    if cfg.family == "vlm" and vision_embeds is not None \
            and mode != "decode":
        raise NotImplementedError("vision embeds of a VLM: no VLM config is "
                                  "ported")
    return x


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = torch.matmul(x, params["unembed"].to(x.dtype))
    logits = logits.to(F32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _run_stack(params, cfg, rcfg, x, *, mode, positions, pos, cache,
               m_state, modality, chunk_len=None, valid=None, cache_len=0,
               placement=None):
    """Prefix layers, then a loop over the stacked blocks; the cache is
    updated in place and returned (prefill: a new zero cache of
    ``cache_len`` rows, filled with each layer's padded KV).  A shared
    placement table serves every block; a per-layer one gives block ``b``
    its slice ``b`` (views, no copy)."""
    layout, n_blocks, n_prefix = block_structure(cfg)
    place_shared, place_stacked = split_placement(placement, n_blocks)
    if mode == "prefill":
        cache = init_cache(cfg, x.shape[0], cache_len, x.device)
    aux_acc = {k: torch.zeros((), dtype=F32, device=x.device)
               for k in AUX_KEYS}
    kw = dict(mode=mode, positions=positions, pos=pos, modality=modality,
              chunk_len=chunk_len, valid=valid, cache_len=cache_len)
    for i in range(n_prefix):
        c = cache["prefix"][str(i)]
        x, co, m_state, aux, _, _, _ = apply_layer(
            params["prefix"][str(i)], x, cfg, rcfg, "dense",
            cache_in=c, m_state=m_state, **kw)
        for n in ("k", "v"):
            c[n].copy_(co[n])
        aux_acc = {k: aux_acc[k] + aux[k] for k in AUX_KEYS}

    stats_b, estats_b, sstats_b = [], [], []
    for b in range(n_blocks):
        place_b = place_shared if place_stacked is None \
            else tuple(a[b] for a in place_stacked)
        st = torch.zeros((2,) + tuple(m_state.shape), dtype=F32,
                         device=x.device)
        es = ss = 0
        for i, (_, f) in enumerate(layout):
            lp = _index(params["blocks"][f"layer{i}"], b)
            c = cache["blocks"][f"layer{i}"]
            x, co, m_state, aux, stats, estats, sstats = apply_layer(
                lp, x, cfg, rcfg, f, cache_in={n: c[n][b] for n in ("k", "v")},
                m_state=m_state, placement=place_b, **kw)
            for n in ("k", "v"):
                c[n][b].copy_(co[n])
            aux_acc = {k: aux_acc[k] + aux[k] for k in AUX_KEYS}
            st, es, ss = st + stats, es + estats, ss + sstats
        stats_b.append(st)
        estats_b.append(es)
        sstats_b.append(ss)
    aux_acc["moe_stats"] = torch.stack(stats_b)      # [n_blocks, 2, 1, ep]
    aux_acc["expert_stats"] = torch.stack(estats_b)  # [n_blocks, 2, E]
    aux_acc["slot_stats"] = torch.stack(sstats_b)    # [n_blocks, 2, S]
    return x, cache, m_state, aux_acc


def _index(tree: Tree, b: int) -> Tree:
    """Block ``b`` of stacked ``[n_blocks, ...]`` parameters (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    return tree[b]


def _prepare_inputs(cfg: ModelConfig, batch):
    """(tokens, modality): modality defaults to all text."""
    tokens = batch["tokens"]
    modality = batch.get("modality")
    if modality is None:
        modality = torch.zeros(tokens.shape, dtype=torch.bool,
                               device=tokens.device)
    return tokens, modality


def prefill_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                    m_state, cache_len: int = 0,
                    placement=None) -> ForwardResult:
    """One-shot prefill of whole prompts.  batch: tokens [B,S], modality
    [B,S] (optional), vision_embeds [B,S_v,D] (optional; ignored by a MoE
    backbone).  Every token is real.  Returns the logits at the last
    position and a cache of ``cache_len`` rows (default S) holding the
    prompt's KV at rows [0, S) and zeros after."""
    if cfg.family == "vlm":
        raise NotImplementedError("one-shot prefill of a VLM: no VLM config "
                                  "is ported")
    tokens, modality = _prepare_inputs(cfg, batch)
    b, s = tokens.shape
    cache_len = cache_len or s
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _embed(params, cfg, tokens, batch.get("vision_embeds"), "prefill")
    x, cache, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="prefill", positions=positions, pos=None,
        cache=None, m_state=m_state, modality=modality,
        cache_len=cache_len, placement=placement)
    logits = _unembed(params, cfg, x[:, -1:, :])
    return ForwardResult(logits[:, 0], cache, m_state, aux)


def chunk_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                  cache, m_state, placement=None) -> ForwardResult:
    """Chunked-prefill continuation step against a partially-filled cache.

    batch: tokens [B,S] (one prompt chunk per row), start [B] (absolute
    position of each row's first chunk token), chunk_len [B] (valid tokens
    per row; 0 = idle row), modality [B,S].  Each row writes its chunk's KV
    at [start, start+chunk_len) and attends causally to its own prefix.
    Returns logits at every row's last valid chunk position.
    """
    tokens, modality = _prepare_inputs(cfg, batch)
    start, chunk_len = batch["start"], batch["chunk_len"]
    b, s = tokens.shape
    dev = tokens.device
    ar = torch.arange(s, device=dev)
    positions = start[:, None] + ar[None, :]
    valid = ar[None, :] < chunk_len[:, None]
    x = _embed(params, cfg, tokens)
    x, cache, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="chunk", positions=positions, pos=start,
        cache=cache, m_state=m_state, modality=modality,
        chunk_len=chunk_len, valid=valid, placement=placement)
    last = torch.clamp(chunk_len - 1, 0, s - 1).long()
    x_last = x[torch.arange(b, device=dev), last][:, None, :]
    logits = _unembed(params, cfg, x_last)
    return ForwardResult(logits[:, 0], cache, m_state, aux)


def decode_forward(params, cfg: ModelConfig, rcfg: ReaLBConfig, batch,
                   cache, m_state, placement=None) -> ForwardResult:
    """batch: tokens [B,1], pos [B], modality [B,1] (vision flag of the new
    token), valid [B,1] (False = dummy slot excluded from routing stats)."""
    tokens, modality = _prepare_inputs(cfg, batch)
    pos = batch["pos"]
    x = _embed(params, cfg, tokens)
    x, cache, m_state, aux = _run_stack(
        params, cfg, rcfg, x, mode="decode", positions=None, pos=pos,
        cache=cache, m_state=m_state, modality=modality,
        valid=batch.get("valid"), placement=placement)
    logits = _unembed(params, cfg, x)
    return ForwardResult(logits[:, 0], cache, m_state, aux)
