"""GQA/MQA self-attention with a KV cache: chunked prefill and decode.

Counterpart of the GQA subset of ``repro.models.attention``, written as
plain tensor ops (the reference has no Pallas attention).  Only the dense
form is ported: the reference switches to an online-softmax (flash) path
for caches longer than ``_DENSE_MAX_KV``, which is the same math, and this
port refuses such caches until that path is ported.

Cache writes: JAX drops out-of-bounds scatter writes (a decode slot that is
not ready passes ``pos = max_len``; chunk padding passes ``L``), torch
raises.  :func:`_write_rows` therefore selects, for every cache row, the
chunk column that writes it (if any) and leaves every other row untouched.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import P, apply_rope

Params = Dict[str, torch.Tensor]
_DENSE_MAX_KV = 2048      # the reference's dense-attention limit
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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe")."""
    b, s, d = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, -1)).reshape(
        b, s, *w.shape[1:])


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
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


def _attend(q, k, v, scale, mask):
    """Softmax attention with bf16-in/f32-accumulate products, as the
    reference's preferred_element_type=f32 dots.  q [B,S,H,D]; k/v
    [B,T,K,D] (heads repeated up to H); mask broadcastable to [B,H,S,T]."""
    h, kh = q.shape[2], k.shape[2]
    if h > kh:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    qh = q.transpose(1, 2).to(F32)                                # [B,H,S,D]
    scores = torch.matmul(qh, k.permute(0, 2, 3, 1).to(F32)) * scale
    scores = torch.where(mask, scores, torch.full((), -1e30, dtype=F32,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(F32), v.transpose(1, 2).to(F32))
    return out.transpose(1, 2).to(q.dtype)                        # [B,S,H,D]


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


def _check_dense(t: int) -> None:
    if t > _DENSE_MAX_KV:
        raise NotImplementedError(
            f"KV length {t} > {_DENSE_MAX_KV}: the reference's flash path "
            "is not ported yet")


def gqa_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x:[B,1,D]; cache k/v:[B,L,K,D]; pos:[B]."""
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k_cache = _scatter_kv(cache["k"], k_new, pos)
    v_cache = _scatter_kv(cache["v"], v_new, pos)
    out = dense_attention(q, k_cache, v_cache, cfg.head_dim ** -0.5,
                          kv_valid=pos + 1)
    return _out_proj(out, p["wo"]), {"k": k_cache, "v": v_cache}


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Write new:[B,1,K,D] into cache:[B,L,K,D] at per-example pos:[B];
    ``pos >= L`` writes nothing."""
    return _write_rows(cache, new, pos[:, None],
                       torch.ones_like(pos, dtype=torch.bool)[:, None])


def _chunk_attention(q, k, v, scale, q_pos):
    """Queries [B,S,H,D] at absolute positions ``q_pos`` [B,S] against the
    whole cache k/v [B,L,K,D], causal per row (``kv_pos <= q_pos``)."""
    t = k.shape[1]
    _check_dense(t)
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
    and the row's output is garbage the caller discards).
    """
    s = x.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    valid = torch.arange(s, device=x.device)[None, :] < chunk_len[:, None]
    k_cache = _write_rows(cache["k"], k_new, positions, valid)
    v_cache = _write_rows(cache["v"], v_new, positions, valid)
    out = _chunk_attention(q, k_cache, v_cache, cfg.head_dim ** -0.5,
                           positions)
    return _out_proj(out, p["wo"]), {"k": k_cache, "v": v_cache}


def dense_attention(q, k, v, scale, *, kv_valid: torch.Tensor):
    """Non-causal short-KV attention of decode queries against the cache,
    keys at or past ``kv_valid`` [B] masked (the reference's
    ``_dense_attention`` with ``causal=False``)."""
    t = k.shape[1]
    _check_dense(t)
    mask = (torch.arange(t, device=q.device)[None, :]
            < kv_valid[:, None])[:, None, None, :]
    return _attend(q, k, v, scale, mask)
