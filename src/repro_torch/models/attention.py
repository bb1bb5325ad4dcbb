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
        "wq": P((d, h, hd)),
        "wk": P((d, k, hd)),
        "wv": P((d, k, hd)),
        "wo": P((h, hd, d), scale=1.0 / (2 * max(cfg.n_layers, 1)) ** 0.5),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((h, hd), init="zeros")
        spec["bk"] = P((k, hd), init="zeros")
        spec["bv"] = P((k, hd), init="zeros")
    return spec


def mla_spec(cfg: ModelConfig) -> Dict[str, P]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": P((d, m.q_lora_rank)),
        "q_norm": P((m.q_lora_rank,), init="zeros"),
        "wq_b": P((m.q_lora_rank, h, qk)),
        "wkv_a": P((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": P((m.kv_lora_rank,), init="zeros"),
        "wk_b": P((m.kv_lora_rank, h, m.qk_nope_head_dim)),
        "wv_b": P((m.kv_lora_rank, h, m.v_head_dim)),
        "wo": P((h, m.v_head_dim, d),
                scale=1.0 / (2 * max(cfg.n_layers, 1)) ** 0.5),
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
