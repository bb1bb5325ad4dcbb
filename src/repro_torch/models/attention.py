"""GQA/MQA and MLA self-attention with a KV cache: one-shot prefill,
chunked prefill (GQA) and decode, at any KV length; and cross-attention
to a fixed memory (a VLM's vision embeddings, an encoder's output).

Counterpart of ``repro.models.attention``,
written as plain tensor ops (the reference's attention is XLA einsums, not
Pallas).  MLA (multi-head latent attention, minicpm3) caches the
normalised latent ``[B, L, kv_lora_rank]`` and the roped key part
``k_rope [B, L, qk_rope_head_dim]``; its prefill expands K/V from them,
its decode takes the reference's absorbed path (the query mapped into the
latent space, attention against the compressed cache).
``scaled_attention`` takes the reference's three branches: dense attention
up to ``_DENSE_MAX_KV`` keys; above it, decode queries (at most 8) through
``_decode_flash`` and longer queries through the online-softmax
``_chunked_attention`` over ``_KV_CHUNK``-key chunks, with the reference's
q-block truncation of long causal prefills.  Chunked prefill
(``_chunk_attention``) is dense at any cache length, as in the reference.
The reference's ``REPRO_ATTN_BASELINE`` variants (a TPU speed A/B of the
same function) are not ported.

Cache writes: JAX drops out-of-bounds scatter writes (a decode slot that is
not ready passes ``pos = max_len``; chunk padding passes ``L``), torch
raises.  :func:`write_rows_` writes only the target rows, in place, so
the cache stays at one address (what a CUDA graph of a forward needs);
:func:`_write_rows` returns a new cache with the same bytes (the
reference the tests hold it against).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import P, apply_rope, rms_norm

Params = Dict[str, torch.Tensor]
_DENSE_MAX_KV = 2048      # kv length above which the chunked path is used
_KV_CHUNK = 1024
_Q_BLOCK = 4096
F32 = torch.float32


def gqa_spec(cfg: ModelConfig) -> Dict[str, P]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": P((d, h, hd), axes=("embed", "heads", None)),
        "wk": P((d, k, hd), axes=("embed", "kv_heads", None)),
        "wv": P((d, k, hd), axes=("embed", "kv_heads", None)),
        "wo": P((h, hd, d), scale=1.0 / (2 * max(cfg.n_layers, 1)) ** 0.5,
                axes=("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((h, hd), init="zeros", axes=("heads", None))
        spec["bk"] = P((k, hd), init="zeros", axes=("kv_heads", None))
        spec["bv"] = P((k, hd), init="zeros", axes=("kv_heads", None))
    return spec


def mla_spec(cfg: ModelConfig) -> Dict[str, P]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": P((d, m.q_lora_rank), axes=("embed", "rank")),
        "q_norm": P((m.q_lora_rank,), init="zeros", axes=("rank",)),
        "wq_b": P((m.q_lora_rank, h, qk), axes=("rank", "heads", None)),
        "wkv_a": P((d, m.kv_lora_rank + m.qk_rope_head_dim),
                   axes=("embed", "rank")),
        "kv_norm": P((m.kv_lora_rank,), init="zeros", axes=("rank",)),
        "wk_b": P((m.kv_lora_rank, h, m.qk_nope_head_dim),
                  axes=("rank", "heads", None)),
        "wv_b": P((m.kv_lora_rank, h, m.v_head_dim),
                  axes=("rank", "heads", None)),
        "wo": P((h, m.v_head_dim, d),
                scale=1.0 / (2 * max(cfg.n_layers, 1)) ** 0.5,
                axes=("heads", None, "embed")),
    }


def attn_spec(cfg: ModelConfig) -> Dict[str, P]:
    """A self-attention layer's parameters: MLA's when the config has
    one, else GQA's."""
    return mla_spec(cfg) if cfg.mla is not None else gqa_spec(cfg)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe")."""
    b, s, d = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 xkv: Optional[torch.Tensor] = None):
    """q from ``x``, k and v from ``xkv`` (the memory of a
    cross-attention; default ``x``, self-attention)."""
    xkv = x if xkv is None else xkv
    q, k, v = _proj(x, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd")."""
    b, s = o.shape[:2]
    return torch.matmul(o.reshape(b, s, -1),
                        wo.to(o.dtype).reshape(-1, wo.shape[-1]))


def _repeat_kv(k, v, h):
    """K/V heads repeated up to ``h`` (``jnp.repeat`` along the head axis)."""
    kh = k.shape[2]
    if h > kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    return k, v


def _attend(q, k, v, scale, mask):
    """Softmax attention with bf16-in/f32-accumulate products, as the
    reference's preferred_element_type=f32 dots.  q [B,S,H,D]; k/v
    [B,T,K,D] (heads repeated up to H); mask broadcastable to [B,H,S,T]
    (None: no mask)."""
    k, v = _repeat_kv(k, v, q.shape[2])
    qh = q.transpose(1, 2).to(F32)                                # [B,H,S,D]
    scores = torch.matmul(qh, k.permute(0, 2, 3, 1).to(F32)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full(
            (), -1e30, dtype=F32, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(F32), v.transpose(1, 2).to(F32))
    return out.transpose(1, 2).to(q.dtype)                        # [B,S,H,D]


def _dense_attention(q, k, v, scale, *, causal, q_offset, kv_valid):
    """Short-KV attention: causal from query offset ``q_offset`` and/or keys
    at or past ``kv_valid`` [B] masked."""
    s, t = q.shape[1], k.shape[1]
    ar_t = torch.arange(t, device=q.device)
    mask = None
    if causal:
        q_pos = torch.arange(s, device=q.device)[:, None] + q_offset
        mask = (ar_t[None, :] <= q_pos)[None, None]               # [1,1,S,T]
    if kv_valid is not None:
        vm = (ar_t[None, :] < kv_valid[:, None])[:, None, None, :]
        mask = vm if mask is None else (mask & vm)
    return _attend(q, k, v, scale, mask)


def _decode_flash(q, k, v, scale, *, kv_valid):
    """Decode queries (at most 8) against a long cache, in the grouped
    ``[K, G]`` layout (no repeated K/V)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.reshape(b, s, kh, g, d).permute(0, 2, 3, 1, 4).to(F32)  # [B,K,G,S,D]
    scores = torch.matmul(qf, k.permute(0, 2, 3, 1).to(F32)[:, :, None]) \
        * scale                                                   # [B,K,G,S,T]
    if kv_valid is not None:
        vm = torch.arange(t, device=q.device)[None, :] < kv_valid[:, None]
        scores = torch.where(vm[:, None, None, None, :], scores, torch.full(
            (), -1e30, dtype=F32, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(F32),
                       v.permute(0, 2, 1, 3).to(F32)[:, :, None])  # [B,K,G,S,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, v.shape[-1]) \
        .to(q.dtype)


def _chunked_attention(q, k, v, scale, *, causal, q_offset, kv_valid,
                       chunk=_KV_CHUNK):
    """Online-softmax attention over ``chunk``-key chunks.

    Chunks entirely below the causal diagonal (causal, no ``kv_valid``, no
    padding) take a mask-free step; the rest are masked.  The scale is
    folded into q once, in f32 and rounded back to q's dtype; masked lanes
    sit at -1e30, so their exp underflows to 0 once a real key has set the
    running max; ``p`` is cast to v's dtype before PV."""
    b, s, h, d = q.shape
    t = k.shape[1]
    odt = q.dtype
    k, v = _repeat_kv(k, v, h)
    n_chunks = -(-t // chunk)
    t_pad = n_chunks * chunk
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
    kc = k.reshape(b, n_chunks, chunk, h, -1).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n_chunks, chunk, h, -1).permute(1, 0, 3, 2, 4)
    qh = (q.transpose(1, 2).to(F32) * scale).to(odt).to(F32)     # [B,H,S,D]
    dev = q.device
    q_pos = torch.arange(s, device=dev)[:, None] + q_offset       # [S,1]
    neg = torch.full((), -1e30, dtype=F32, device=dev)

    m = torch.full((b, h, s), -math.inf, dtype=F32, device=dev)
    l = torch.zeros((b, h, s), dtype=F32, device=dev)  # noqa: E741
    acc = torch.zeros((b, h, s, v.shape[-1]), dtype=F32, device=dev)
    n_free = 0
    if causal and kv_valid is None and t_pad == t:
        n_free = min(int(q_offset) // chunk, n_chunks)
    for ci in range(n_chunks):
        scores = torch.matmul(qh, kc[ci].to(F32).transpose(-1, -2))  # [B,H,S,C]
        if ci >= n_free:
            kv_pos = ci * chunk + torch.arange(chunk, device=dev)     # [C]
            mask = kv_pos[None, :] < t                                # [1,C]
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos)              # [S,C]
            mask = mask[None, None]
            if kv_valid is not None:
                vm = kv_pos[None, :] < kv_valid[:, None]              # [B,C]
                mask = mask & vm[:, None, None, :]
            scores = torch.where(mask, scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        pv = torch.matmul(p.to(vc.dtype).to(F32), vc[ci].to(F32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(odt)                            # [B,S,H,D]


def scaled_attention(q, k, v, scale, *, causal=True, q_offset=0,
                     kv_valid=None):
    """The reference's dispatch: decode queries (at most 8) against more
    than ``_DENSE_MAX_KV`` keys → ``_decode_flash``; short KV → dense; long
    causal self-attention → q blocks (``_Q_BLOCK``, or half the sequence),
    each attending only its own KV prefix; otherwise chunked."""
    if q.shape[1] <= 8 and k.shape[1] > _DENSE_MAX_KV:
        return _decode_flash(q, k, v, scale, kv_valid=kv_valid)
    if k.shape[1] <= _DENSE_MAX_KV:
        return _dense_attention(q, k, v, scale, causal=causal,
                                q_offset=q_offset, kv_valid=kv_valid)
    s = q.shape[1]
    qb = _Q_BLOCK if s % _Q_BLOCK == 0 else (
        s // 2 if s % 2 == 0 and s > _DENSE_MAX_KV else 0)
    if causal and s == k.shape[1] and q_offset == 0 and qb and s > qb:
        outs = []
        for j in range(s // qb):
            q_j = q[:, j * qb:(j + 1) * qb]
            kv_end = (j + 1) * qb
            branch = _dense_attention if kv_end <= _DENSE_MAX_KV \
                else _chunked_attention
            outs.append(branch(q_j, k[:, :kv_end], v[:, :kv_end], scale,
                               causal=True, q_offset=j * qb,
                               kv_valid=kv_valid))
        return torch.cat(outs, dim=1)
    return _chunked_attention(q, k, v, scale, causal=causal,
                              q_offset=q_offset, kv_valid=kv_valid)


def gqa_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, causal: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full (prefill) self-attention. Returns (out, kv)."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = scaled_attention(q, k, v, cfg.head_dim ** -0.5, causal=causal)
    return _out_proj(out, p["wo"]), {"k": k, "v": v}


def _write_rows(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """cache [B,L,...] with row ``idx[b, j]`` set to ``new[b, j]`` for every
    valid column j whose index lies inside the cache; other rows unchanged
    (JAX's scatter with out-of-bounds writes dropped)."""
    b, l = cache.shape[:2]
    rows = torch.arange(l, device=cache.device)
    match = valid[:, :, None] & (idx[:, :, None] == rows[None, None, :])
    hit = match.any(dim=1)                                         # [B,L]
    src = match.to(torch.int32).argmax(dim=1)                      # [B,L]
    tail = (1,) * (cache.dim() - 2)
    gathered = torch.gather(new.to(cache.dtype), 1,
                            src.reshape(b, l, *tail).expand(cache.shape))
    return torch.where(hit.reshape(b, l, *tail), gathered, cache)


def write_rows_(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """:func:`_write_rows` in place: only the target rows of ``cache``
    [B,L,...] are written, and ``cache`` is returned with the bytes
    ``_write_rows`` would give (the valid indices of one batch row are
    distinct, as positions are).

    ``index_put_`` with repeated indices writes in no defined order, so a
    dropped write (an invalid column, or an index outside [0, L)) is never
    clamped onto a row: it goes to the row of its batch row's last landing
    write, carrying that write's own value, or, in a batch row where no
    write lands, to row 0 carrying row 0's value.  Every index then
    repeats only with equal values.  Nothing is read on the host."""
    b, l = cache.shape[:2]
    s = idx.shape[1]
    dev = cache.device
    land = valid & (idx >= 0) & (idx < l)                          # [B,S]
    last = torch.where(land, torch.arange(s, device=dev), -1).amax(dim=1)
    has = last >= 0                                                # [B]
    last = last.clamp(min=0)
    ar = torch.arange(b, device=dev)
    rows = torch.where(land, idx, torch.where(has, idx[ar, last], 0)[:, None])
    val = new.to(cache.dtype)
    tail = (1,) * (cache.dim() - 2)
    anchor = torch.where(has.reshape(b, *tail), val[ar, last], cache[ar, 0])
    vals = torch.where(land.reshape(b, s, *tail), val, anchor[:, None])
    cache.index_put_((ar[:, None].expand(b, s), rows.long()), vals)
    return cache


def gqa_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x:[B,1,D]; cache k/v:[B,L,K,D], the new row
    written in place (the returned cache is ``cache``'s tensors); pos:[B]."""
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k_cache = _scatter_kv(cache["k"], k_new, pos)
    v_cache = _scatter_kv(cache["v"], v_new, pos)
    out = scaled_attention(q, k_cache, v_cache, cfg.head_dim ** -0.5,
                           causal=False, kv_valid=pos + 1)
    return _out_proj(out, p["wo"]), {"k": k_cache, "v": v_cache}


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Write new:[B,1,K,D] into cache:[B,L,K,D] at per-example pos:[B], in
    place; ``pos >= L`` writes nothing."""
    return write_rows_(cache, new, pos[:, None],
                       torch.ones_like(pos, dtype=torch.bool)[:, None])


def _chunk_attention(q, k, v, scale, q_pos):
    """Queries [B,S,H,D] at absolute positions ``q_pos`` [B,S] against the
    whole cache k/v [B,L,K,D], causal per row (``kv_pos <= q_pos``); dense
    at any cache length, as the reference's."""
    t = k.shape[1]
    mask = (torch.arange(t, device=q.device)[None, None, None, :]
            <= q_pos[:, None, :, None])
    return _attend(q, k.to(q.dtype), v.to(q.dtype), scale, mask)


def gqa_chunk(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
              cfg: ModelConfig, *, positions: torch.Tensor,
              chunk_len: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cached multi-token prefill continuation (chunked prefill).

    x: [B,S,D] one prompt chunk per row; cache k/v: [B,L,K,D];
    positions: [B,S] absolute position of every chunk column;
    chunk_len: [B] valid tokens per row (0 = idle row: nothing is written
    and the row's output is garbage the caller discards).  The chunk's
    rows are written into ``cache`` in place, as in :func:`gqa_decode`.
    """
    s = x.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    valid = torch.arange(s, device=x.device)[None, :] < chunk_len[:, None]
    k_cache = write_rows_(cache["k"], k_new, positions, valid)
    v_cache = write_rows_(cache["v"], v_new, positions, valid)
    out = _chunk_attention(q, k_cache, v_cache, cfg.head_dim ** -0.5,
                           positions)
    return _out_proj(out, p["wo"]), {"k": k_cache, "v": v_cache}


# --------------------------------------------------------------------------
# cross-attention (VLM / enc-dec): K/V from a fixed memory
# --------------------------------------------------------------------------
def cross_forward(p: Params, x: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Queries of x [B,S,D] against K/V projected from ``memory``
    [B,T,D] (cast to x's dtype first): no RoPE, no mask.  Returns (out,
    {"k", "v"} [B,T,K,Dh]), the memory's K/V a decode reads."""
    q, k, v = _project_qkv(p, x, cfg, memory.to(x.dtype))
    out = scaled_attention(q, k, v, cfg.head_dim ** -0.5, causal=False)
    return _out_proj(out, p["wo"]), {"k": k, "v": v}


def cross_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode-time cross-attention of x [B,1,D] against the memory's K/V
    cached at prefill (cast to x's dtype); the cache is read, not
    written, and returned as it is."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    out = scaled_attention(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                           cfg.head_dim ** -0.5, causal=False)
    return _out_proj(out, p["wo"]), cache


# --------------------------------------------------------------------------
# MLA (multi-head latent attention)
# --------------------------------------------------------------------------
def _latent_kv(p: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor):
    """(normalised latent [B,S,r], roped k_rope [B,S,dr]) of x [B,S,D]."""
    m = cfg.mla
    kv = torch.matmul(x, p["wkv_a"].to(x.dtype))
    latent, k_rope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim],
                                 dim=-1)
    latent = rms_norm(latent, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return latent, k_rope


def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
           q_positions: torch.Tensor):
    """(q_nope [B,S,H,dn], roped q_rope [B,S,H,dr]) of x [B,S,D]."""
    m = cfg.mla
    qa = rms_norm(torch.matmul(x, p["wq_a"].to(x.dtype)), p["q_norm"],
                  cfg.norm_eps)
    q = _proj(qa, p["wq_b"])
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    return q_nope, apply_rope(q_rope, q_positions, cfg.rope_theta)


def _mla_qkv(p: Params, x: torch.Tensor, latent: torch.Tensor,
             k_rope: torch.Tensor, cfg: ModelConfig,
             q_positions: torch.Tensor):
    """q from x; k and v expanded from (latent, k_rope): q/k [B,S,H,dn+dr],
    v [B,T,H,dv]."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(p, x, cfg, q_positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k_nope = _proj(latent, p["wk_b"])
    v = _proj(latent, p["wv_b"])
    kr = k_rope[:, :, None, :].to(k_nope.dtype).expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)
    return q, torch.cat([k_nope, kr], dim=-1), v


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full (prefill) MLA self-attention. Returns (out, {"latent",
    "k_rope"})."""
    latent, k_rope = _latent_kv(p, x, cfg, positions)
    q, k, v = _mla_qkv(p, x, latent, k_rope, cfg, positions)
    out = scaled_attention(q, k, v, _mla_scale(cfg), causal=True)
    return _out_proj(out, p["wo"]), {"latent": latent, "k_rope": k_rope}


def mla_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token MLA decode by the reference's absorbed path.  x [B,1,D];
    cache latent [B,L,r], k_rope [B,L,dr], the new rows written in place
    (``pos >= L`` writes nothing); pos [B].  The query's no-rope part is
    mapped into the latent space (``q · W_kbᵀ``), the scores are f32 sums
    of bf16 products against the latent and k_rope rows, and the context,
    rounded to x's dtype, goes through ``W_vb`` and ``wo``."""
    dt = x.dtype
    lat_new, kr_new = _latent_kv(p, x, cfg, pos[:, None])
    latent = _scatter_kv(cache["latent"], lat_new, pos)
    k_rope = _scatter_kv(cache["k_rope"], kr_new, pos)
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope,
                         p["wk_b"].to(dt))                       # [B,1,H,r]
    latf = latent.to(dt)
    scores = (torch.einsum("bshr,btr->bhst", q_abs.to(F32), latf.to(F32))
              + torch.einsum("bshe,bte->bhst", q_rope.to(F32),
                             k_rope.to(dt).to(F32))) * _mla_scale(cfg)
    valid = (torch.arange(latent.shape[1], device=x.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full((), -1e30, dtype=F32,
                                                   device=x.device))
    probs = torch.softmax(scores, dim=-1)                       # [B,H,1,L]
    ctx = torch.einsum("bhst,btr->bshr", probs.to(dt).to(F32),
                       latf.to(F32)).to(dt)
    vh = torch.einsum("bshr,rhe->bshe", ctx, p["wv_b"].to(dt))
    return _out_proj(vh, p["wo"]), {"latent": latent, "k_rope": k_rope}


# --------------------------------------------------------------------------
# the tensor-parallel layout (models.layout): heads over ``model``, the
# cache's rows over its ``kv_seq`` axes
# --------------------------------------------------------------------------
def _bias(t: torch.Tensor, p: Params, name: str, cfg: ModelConfig,
          lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
    if not cfg.qkv_bias:
        return t
    b = p[name] if hi is None else p[name][lo:hi]
    return t + b.to(t.dtype)


def _kv_heads(p: Params, src: torch.Tensor, cfg: ModelConfig, tp,
              positions: Optional[torch.Tensor]):
    """K/V of ``src`` in the layout: ``(k_all, v_all)``, every KV head
    (None where the rank holds only its own: cut KV heads, gathered by
    the caller that needs them), and ``(k, v)``, the heads this rank's
    query heads attend (its own cut KV heads; a replicated KV stack's
    heads its query heads map to, one per query head; all, with the
    query heads replicated).  RoPE at ``positions`` (None: none)."""
    h, kh = cfg.n_heads, cfg.n_kv_heads
    rope = (lambda t: t) if positions is None else \
        (lambda t: apply_rope(t, positions, cfg.rope_theta))
    if tp.divides(kh) and tp.divides(h):
        k = rope(_bias(_proj(src, p["wk"]), p, "bk", cfg))
        v = _bias(_proj(src, p["wv"]), p, "bv", cfg)
        return None, (k, v)
    k_all = rope(_bias(_proj(src, p["wk"]), p, "bk", cfg))
    v_all = _bias(_proj(src, p["wv"]), p, "bv", cfg)
    if not tp.divides(h):
        return (k_all, v_all), (k_all, v_all)
    h0, h1 = tp.cut(h)
    sel = torch.arange(h0, h1, device=src.device) // (h // kh)
    return (k_all, v_all), (k_all[:, :, sel], v_all[:, :, sel])


def tp_gqa_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, tp, *,
                   positions: torch.Tensor, causal: bool = True,
                   memory: Optional[torch.Tensor] = None,
                   need_kv: bool = False):
    """Self-attention over whole sequences (prefill, train, encode) or,
    with ``memory``, cross-attention to it, in the tensor-parallel layout.
    ``x`` is the residual's layout (``tp.sp``: this rank's rows);
    ``positions`` [B, S] the whole sequence's.  Heads that divide over
    ``model`` are column-parallel (the whole sequence gathered, ``wo``
    row-parallel, reduced back); replicated heads attend with the rank's
    own query rows.  Returns ``(out, kv)``: ``kv`` (``need_kv``) the whole
    sequence's K/V of every KV head (self-attention, for the cache) or the
    memory's as the cache holds them (its KV heads cut where they
    divide)."""
    h = cfg.n_heads
    cut_q = tp.divides(h)
    own = not cut_q and tp.sp
    # the whole sequence: the queries of cut heads, the keys of
    # self-attention
    gathered = tp.gather_seq(x) if cut_q or (own and memory is None) else x
    q = _bias(_proj(x if own else gathered, p["wq"]), p, "bq", cfg)
    if memory is not None:
        # the memory is whole on every rank of ``model``; its producer
        # (``transformer._encode``) sums the cross layers' partial
        # cotangents
        kv_all, (k, v) = _kv_heads(p, memory.to(x.dtype), cfg, tp, None)
        out = scaled_attention(q, k, v, cfg.head_dim ** -0.5, causal=False)
        kv = None
        if need_kv:
            kv = {"k": k, "v": v} if kv_all is None else \
                {"k": kv_all[0], "v": kv_all[1]}
    else:
        q_pos = positions.narrow(1, tp.seq_offset, tp.s_local) if own \
            else positions
        q = apply_rope(q, q_pos, cfg.rope_theta)
        kv_all, (k, v) = _kv_heads(p, gathered, cfg, tp, positions)
        out = _core(tp, q, k, v, cfg.head_dim ** -0.5, causal=causal,
                    q_offset=tp.seq_offset if own else 0)
        kv = None
        if need_kv:
            kv = {"k": tp.gather_heads(k), "v": tp.gather_heads(v)} \
                if kv_all is None else {"k": kv_all[0], "v": kv_all[1]}
    y = _out_proj(out, p["wo"])
    return (tp.reduce_out(y) if cut_q else y), kv


def _core(tp, q, k, v, scale, *, causal, q_offset):
    """:func:`scaled_attention`; in training checkpointed on its own, so a
    layer's recompute (or forward) keeps its q, k, v and output and not
    every key chunk's scores (the same values: the backward recomputes
    them)."""
    if not (tp.train and torch.is_grad_enabled()):
        return scaled_attention(q, k, v, scale, causal=causal,
                                q_offset=q_offset)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(lambda q, k, v: scaled_attention(
        q, k, v, scale, causal=causal, q_offset=q_offset), q, k, v,
        use_reentrant=False)


def _partial_attention(scores: torch.Tensor, mask: torch.Tensor, vals):
    """A softmax over a rank's slice of the keys, unnormalized: ``(m, l,
    acc)`` with ``m`` the slice's max score (``-1e30`` where every key is
    masked), ``l`` the sum of ``exp(score - m)`` over the unmasked keys,
    ``acc`` their products with the values (``vals(p)``: ``p`` rounded to
    the values' dtype and multiplied in f32, as the reference's PV)."""
    neg = torch.full((), -1e30, dtype=F32, device=scores.device)
    scores = torch.where(mask, scores, neg)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None]) * mask
    return m, p.sum(dim=-1), vals(p)


def _combine(tp, cut, m, l, acc):  # noqa: E741
    """The softmax over every key from each rank's partial ``(m, l, acc)``
    (:func:`_partial_attention`) over the axes ``cut`` of the cache's
    rows: the partials all-gathered (one packed gather) and merged in rank
    order, the same bits on every rank; ``acc / l`` in f32."""
    if cut:
        d = acc.shape[-1]
        flat = torch.cat([m.reshape(-1), l.reshape(-1), acc.reshape(-1)])
        parts = tp.comm._gather(flat, cut, "kv_combine_all_gather")
        ms, ls, accs = torch.split(parts, [m.numel(), l.numel(),
                                           acc.numel()], dim=1)
        top = ms.amax(dim=0)
        tot, out = 0, 0
        for i in range(parts.shape[0]):
            w = torch.exp(ms[i] - top)
            tot = tot + ls[i] * w
            out = out + accs[i].reshape(-1, d) * w[:, None]
        l, acc = tot.reshape(m.shape), out.reshape(acc.shape)  # noqa: E741
    return acc / torch.clamp(l[..., None], min=1e-30)


def _cached_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, tp,
               positions: torch.Tensor):
    """Every query head's q (rank's heads gathered over ``model`` where
    they are cut) and every KV head's new K/V rows of ``x`` (the
    cache holds them all on the rank that owns the rows), RoPE'd."""
    h = cfg.n_heads
    q = apply_rope(_bias(_proj(x, p["wq"]), p, "bq", cfg), positions,
                   cfg.rope_theta)
    if tp.divides(h):
        q = tp.gather_heads(q)
    kv_all, (k, v) = _kv_heads(p, x, cfg, tp, positions)
    if kv_all is None:
        kv_all = (tp.gather_heads(k), tp.gather_heads(v))
    return q, kv_all[0], kv_all[1]


def _attend_rows(tp, cut, q, k, v, scale, mask):
    """Every head's queries ``q`` [B,S,H,D] against this rank's cache rows
    ``k``/``v`` [B,T,K,D] under ``mask`` [B,1|H,S,T], the partials
    combined over ``cut``: [B,S,H,D] in q's dtype."""
    k, v = _repeat_kv(k.to(q.dtype), v.to(q.dtype), q.shape[2])
    scores = torch.matmul(q.transpose(1, 2).to(F32),
                          k.permute(0, 2, 3, 1).to(F32)) * scale
    m, l, acc = _partial_attention(  # noqa: E741
        scores, mask, lambda pr: torch.matmul(
            pr.to(v.dtype).to(F32), v.transpose(1, 2).to(F32)))
    return _combine(tp, cut, m, l, acc).transpose(1, 2).to(q.dtype)


def _heads_out(p: Params, out: torch.Tensor, cfg: ModelConfig, tp, *,
               seq: bool) -> torch.Tensor:
    """Every head's attention output [B,S,H,Dv] through ``wo``: cut heads
    take the rank's own and reduce (``seq``: over the sequence, else an
    ordered all-reduce); replicated heads the rank's own rows (``seq``)."""
    h = cfg.n_heads
    if tp.divides(h):
        h0, h1 = tp.cut(h)
        y = _out_proj(out[:, :, h0:h1], p["wo"])
        return tp.reduce_out(y) if seq else tp.psum(y)
    if seq:
        out = out.narrow(1, tp.seq_offset, tp.s_local)
    return _out_proj(out, p["wo"])


def tp_gqa_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig, tp, *, pos: torch.Tensor, cut, kv_off):
    """:func:`gqa_decode` in the layout: ``x`` [B,1,D] whole on every rank
    of ``model``, the cache this rank's rows ``[kv_off, kv_off + T)`` of
    every KV head (``cut``: the axes they are cut over).  The new row is
    written by the rank that holds it; every head's query attends the
    rank's rows and the partials are combined over ``cut``."""
    q, k_new, v_new = _cached_kv(p, x, cfg, tp, pos[:, None])
    rows = (pos - kv_off)[:, None]
    ok = torch.ones_like(rows, dtype=torch.bool)
    k_cache = write_rows_(cache["k"], k_new, rows, ok)
    v_cache = write_rows_(cache["v"], v_new, rows, ok)
    t = k_cache.shape[1]
    kv_pos = kv_off + torch.arange(t, device=x.device)
    mask = (kv_pos[None, :] < (pos + 1)[:, None])[:, None, None, :]
    out = _attend_rows(tp, cut, q, k_cache, v_cache, cfg.head_dim ** -0.5,
                       mask)
    return _heads_out(p, out, cfg, tp, seq=False), {"k": k_cache,
                                                     "v": v_cache}


def tp_gqa_chunk(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, tp, *, positions: torch.Tensor,
                 chunk_len: torch.Tensor, cut, kv_off):
    """:func:`gqa_chunk` in the layout: ``x`` this rank's rows of the
    chunk (sequence-parallel), ``positions`` [B,S] the whole chunk's; the
    rows of the chunk each rank holds written there, every query attends
    the rank's rows causally, the partials combined over ``cut``."""
    xs = tp.gather_seq(x)
    s = xs.shape[1]
    q, k_new, v_new = _cached_kv(p, xs, cfg, tp, positions)
    valid = torch.arange(s, device=x.device)[None, :] < chunk_len[:, None]
    k_cache = write_rows_(cache["k"], k_new, positions - kv_off, valid)
    v_cache = write_rows_(cache["v"], v_new, positions - kv_off, valid)
    t = k_cache.shape[1]
    kv_pos = kv_off + torch.arange(t, device=x.device)
    mask = (kv_pos[None, None, :] <= positions[:, :, None])[:, None]
    out = _attend_rows(tp, cut, q, k_cache, v_cache, cfg.head_dim ** -0.5,
                       mask)
    return _heads_out(p, out, cfg, tp, seq=tp.sp), {"k": k_cache,
                                                    "v": v_cache}


def tp_cross_decode(p: Params, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], cfg: ModelConfig, tp):
    """:func:`cross_decode` in the layout: the rank's query heads against
    the memory's K/V as the cache holds them (its own KV heads where they
    divide, else every one, the heads its queries map to taken)."""
    h, kh = cfg.n_heads, cfg.n_kv_heads
    q = _bias(_proj(x, p["wq"]), p, "bq", cfg)
    k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    if tp.divides(h) and not tp.divides(kh):
        h0, h1 = tp.cut(h)
        sel = torch.arange(h0, h1, device=x.device) // (h // kh)
        k, v = k[:, :, sel], v[:, :, sel]
    out = scaled_attention(q, k, v, cfg.head_dim ** -0.5, causal=False)
    y = _out_proj(out, p["wo"])
    return (tp.psum(y) if tp.divides(h) else y), cache


def tp_mla_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, tp, *,
                   positions: torch.Tensor, need_kv: bool = False):
    """:func:`mla_forward` in the layout: the latent (``rank`` replicated)
    of the whole sequence on every rank, the heads column-parallel where
    they divide (else the rank's own query rows)."""
    cut_q = tp.divides(cfg.n_heads)
    gathered = tp.gather_seq(x) if (tp.sp or cut_q) else x
    own = not cut_q and tp.sp
    latent, k_rope = _latent_kv(p, gathered, cfg, positions)
    q_src, q_pos = (x, positions.narrow(1, tp.seq_offset, tp.s_local)) \
        if own else (gathered, positions)
    q_nope, q_rope = _mla_q(p, q_src, cfg, q_pos)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k_nope = _proj(latent, p["wk_b"])
    v = _proj(latent, p["wv_b"])
    kr = k_rope[:, :, None, :].to(k_nope.dtype).expand(
        *k_nope.shape[:3], cfg.mla.qk_rope_head_dim)
    out = _core(tp, q, torch.cat([k_nope, kr], dim=-1), v, _mla_scale(cfg),
                causal=True, q_offset=tp.seq_offset if own else 0)
    y = _out_proj(out, p["wo"])
    kv = {"latent": latent, "k_rope": k_rope} if need_kv else None
    return (tp.reduce_out(y) if cut_q else y), kv


def tp_mla_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig, tp, *, pos: torch.Tensor, cut, kv_off):
    """:func:`mla_decode` in the layout: the latent rows written by the
    rank that holds them, every head's absorbed query (cut heads gathered)
    against the rank's rows, the partial contexts combined over ``cut``,
    then the rank's heads through ``W_vb`` and ``wo``."""
    dt = x.dtype
    h = cfg.n_heads
    lat_new, kr_new = _latent_kv(p, x, cfg, pos[:, None])
    rows = (pos - kv_off)[:, None]
    ok = torch.ones_like(rows, dtype=torch.bool)
    latent = write_rows_(cache["latent"], lat_new, rows, ok)
    k_rope = write_rows_(cache["k_rope"], kr_new, rows, ok)
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, p["wk_b"].to(dt))
    if tp.divides(h):
        q_abs, q_rope = tp.gather_heads(q_abs), tp.gather_heads(q_rope)
    latf = latent.to(dt)
    scores = (torch.einsum("bshr,btr->bhst", q_abs.to(F32), latf.to(F32))
              + torch.einsum("bshe,bte->bhst", q_rope.to(F32),
                             k_rope.to(dt).to(F32))) * _mla_scale(cfg)
    kv_pos = kv_off + torch.arange(latent.shape[1], device=x.device)
    mask = (kv_pos[None, :] <= pos[:, None])[:, None, None, :]
    m, l, acc = _partial_attention(  # noqa: E741
        scores, mask, lambda pr: torch.einsum(
            "bhst,btr->bhsr", pr.to(dt).to(F32), latf.to(F32)))
    ctx = _combine(tp, cut, m, l, acc).transpose(1, 2).to(dt)  # [B,1,H,r]
    if tp.divides(h):
        h0, h1 = tp.cut(h)
        ctx = ctx[:, :, h0:h1]
    vh = torch.einsum("bshr,rhe->bshe", ctx, p["wv_b"].to(dt))
    y = _out_proj(vh, p["wo"])
    return (tp.psum(y) if tp.divides(h) else y), {"latent": latent,
                                                  "k_rope": k_rope}
