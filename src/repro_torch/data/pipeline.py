"""Synthetic multimodal data pipeline of the port.

A copy of ``repro.data.pipeline`` (numpy only; the port imports nothing
from ``repro``): the same batches, bit for bit, from the same seed.
Batches stay numpy; a train step puts them on its device.

Deterministic, host-sharded, restart-safe: batch content is a pure
function of ``(seed, step, host)`` so a restarted job resumes byte-exact
(no data-offset files needed) and hosts never synchronize — at 1000+ nodes
there is no global-shuffle barrier.

Under a mesh every rank draws the same global batch (``host`` 0, as the
reference's ``DataLoader`` yields the global batch that ``jit`` shards),
and the train step takes its data row's rows of it
(``models.transformer.train_forward``): the ranks never exchange data.

Two generators:

* ``lm_batch`` — learnable LM stream: tokens from a per-position Markov
  chain over a Zipf vocabulary; labels are next-token.  A model that
  learns bigram statistics drives the loss visibly down within ~100 steps,
  which the e2e training test asserts.
* ``multimodal_batch`` — vision/text mixed sequences with the paper's skew
  characteristics: a random-length vision prefix (token ids from a
  disjoint "vision vocab" range, flagged in the modality mask) followed by
  text.  Vision fraction varies strongly per sequence (Fig 2's
  device-level modality skew emerges after sharding).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    vision_frac_mean: float = 0.6      # mean vision-token fraction (paper:
    vision_frac_std: float = 0.3       # vision dominates prefill batches)
    n_hosts: int = 1


def _rng(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def _zipf_tokens(rng, shape, vocab: int) -> np.ndarray:
    # bounded zipf over the vocab (realistic token frequency profile)
    ranks = rng.zipf(1.3, size=shape)
    return ((ranks - 1) % vocab).astype(np.int32)


def lm_batch(cfg: DataConfig, step: int, host: int = 0) -> Dict[str, np.ndarray]:
    """Markov LM batch: tokens [b,S], labels [b,S] (next-token)."""
    rng = _rng(cfg, step, host)
    b = cfg.global_batch // cfg.n_hosts
    v = cfg.vocab_size
    # fixed per-seed bigram transition "model": next = (a*cur + b) % v + noise
    a = 31
    c = 7
    first = _zipf_tokens(rng, (b, 1), v)
    toks = [first[:, 0]]
    noise = rng.random((b, cfg.seq_len)) < 0.15
    rand = _zipf_tokens(rng, (b, cfg.seq_len), v)
    for t in range(1, cfg.seq_len):
        nxt = (a * toks[-1] + c) % v
        toks.append(np.where(noise[:, t], rand[:, t], nxt).astype(np.int32))
    tokens = np.stack(toks, axis=1)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    return {"tokens": tokens, "labels": labels,
            "modality": np.zeros((b, cfg.seq_len), bool)}


def multimodal_batch(cfg: DataConfig, step: int, host: int = 0,
                     d_model: int = 0) -> Dict[str, np.ndarray]:
    """Mixed vision/text batch with strong per-sequence modality skew."""
    base = lm_batch(cfg, step, host)
    rng = _rng(cfg, step + 1_000_003, host)
    b = cfg.global_batch // cfg.n_hosts
    frac = np.clip(rng.normal(cfg.vision_frac_mean, cfg.vision_frac_std,
                              size=(b,)), 0.0, 0.95)
    n_vis = (frac * cfg.seq_len).astype(np.int32)
    pos = np.arange(cfg.seq_len)[None, :]
    modality = pos < n_vis[:, None]
    # vision tokens live in the top half of the vocab (routing separates
    # modalities the way real MMoE gating does)
    vis_tok = (cfg.vocab_size // 2
               + (base["tokens"] % (cfg.vocab_size // 2))).astype(np.int32)
    tokens = np.where(modality, vis_tok, base["tokens"])
    labels = np.where(modality[:, :], -1, base["labels"]).astype(np.int32)
    out = {"tokens": tokens, "labels": labels, "modality": modality}
    if d_model:
        emb_rng = _rng(cfg, step + 2_000_003, host)
        nv = int(n_vis.max()) if b else 0
        out["vision_embeds"] = emb_rng.normal(
            0, 0.02, size=(b, nv, d_model)).astype(np.float32)
    return out


class DataLoader:
    """Stateless iterator facade; `state` is just the step counter."""

    def __init__(self, cfg: DataConfig, host: int = 0,
                 multimodal: bool = False, d_model: int = 0,
                 start_step: int = 0):
        self.cfg, self.host = cfg, host
        self.multimodal, self.d_model = multimodal, d_model
        self.step = start_step

    def __next__(self) -> Dict[str, np.ndarray]:
        fn = multimodal_batch if self.multimodal else lm_batch
        kw = {"d_model": self.d_model} if self.multimodal else {}
        batch = fn(self.cfg, self.step, self.host, **kw)
        self.step += 1
        return batch

    def __iter__(self):
        return self
