"""Per-request multimodal prompt synthesis (a copy of
``repro.workloads.multimodal``).

Turns a named workload profile (MMMU, TextVQA, … — see
:mod:`repro_torch.workloads.profiles`) into concrete serving requests: prompt
length, vision-token count and placement, modality masks, decode-side
modality, and optional stub vision embeddings.

Vision tokens are drawn from the upper half of the vocabulary (the stub
frontend's codebook) and placed either as a contiguous prefix block (the
common VLM image-then-question layout) or interleaved through the prompt
(document/figure-heavy layouts) — placement matters because ReaLB's
modality metadata is positional.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.scheduler import Request
from repro_torch.workloads.profiles import WORKLOADS


@dataclasses.dataclass(frozen=True)
class PromptProfile:
    """Request-level synthesis parameters for one named workload."""
    name: str
    vision_frac_mean: float = 0.6
    vision_frac_std: float = 0.15
    prompt_len_mean: int = 160
    prompt_len_std: int = 64
    prompt_len_min: int = 16
    prompt_len_max: int = 384
    interleave_prob: float = 0.15    # scatter vision tokens vs prefix block
    decode_vision_prob: float = 0.05  # image-gen style: decoded tokens are vision
    max_new_mean: int = 12
    max_new_min: int = 2
    max_new_max: int = 32


def profile(name: str, **overrides) -> PromptProfile:
    """Build a :class:`PromptProfile` from the shared WORKLOADS calibration
    (modality-mix fields); routing-skew fields stay with the trace layer."""
    cal = WORKLOADS[name]
    kw = dict(vision_frac_mean=cal["vision_frac_mean"],
              vision_frac_std=cal["vision_frac_std"])
    kw.update(overrides)
    return PromptProfile(name=name, **kw)


@dataclasses.dataclass
class RequestSpec:
    """One synthesized request: everything needed to reconstruct the exact
    serving input, JSONL-serializable for record/replay."""
    uid: int
    arrival: float
    tokens: np.ndarray               # [S] int32
    modality: np.ndarray             # [S] bool
    max_new_tokens: int
    decode_modality: bool = False
    embed_seed: Optional[int] = None  # stub vision embeds, regenerated

    def to_request(self, d_model: int = 0) -> Request:
        embeds = None
        if self.embed_seed is not None and d_model > 0:
            n_vis = int(self.modality.sum())
            embeds = np.random.default_rng(self.embed_seed).normal(
                0, 0.02, (n_vis, d_model)).astype(np.float32)
        return Request(uid=self.uid,
                       tokens=self.tokens.astype(np.int32),
                       modality=self.modality.astype(bool),
                       max_new_tokens=self.max_new_tokens,
                       vision_embeds=embeds,
                       decode_modality=self.decode_modality,
                       arrival_time=float(self.arrival))


def synth_request(prof: PromptProfile, uid: int, arrival: float, rng,
                  vocab_size: int, max_prompt: Optional[int] = None,
                  with_embeds: bool = False) -> RequestSpec:
    p_max = min(prof.prompt_len_max, max_prompt or prof.prompt_len_max)
    p_len = int(np.clip(round(rng.normal(prof.prompt_len_mean,
                                         prof.prompt_len_std)),
                        prof.prompt_len_min, p_max))
    vf = float(np.clip(rng.normal(prof.vision_frac_mean,
                                  prof.vision_frac_std), 0.0, 0.95))
    n_vis = int(round(p_len * vf))
    toks = rng.integers(0, vocab_size // 2, p_len).astype(np.int32)
    modality = np.zeros(p_len, bool)
    if n_vis:
        if rng.random() < prof.interleave_prob:
            vis_pos = rng.choice(p_len, n_vis, replace=False)
        else:
            vis_pos = np.arange(n_vis)
        modality[vis_pos] = True
        # vision tokens live in the stub frontend's codebook (upper vocab)
        toks[modality] = vocab_size // 2 + toks[modality]
    max_new = int(np.clip(round(rng.normal(prof.max_new_mean,
                                           prof.max_new_mean / 3)),
                          prof.max_new_min, prof.max_new_max))
    return RequestSpec(
        uid=uid, arrival=float(arrival), tokens=toks, modality=modality,
        max_new_tokens=max_new,
        decode_modality=bool(rng.random() < prof.decode_vision_prob),
        embed_seed=(int(rng.integers(0, 2 ** 31)) if with_embeds and n_vis
                    else None))


def make_stream(prof: PromptProfile, arrivals: np.ndarray, vocab_size: int,
                seed: int = 0, max_prompt: Optional[int] = None,
                with_embeds: bool = False) -> List[RequestSpec]:
    """Synthesize one request per arrival time; fully determined by
    (profile, arrivals, seed, vocab_size)."""
    rng = np.random.default_rng(seed)
    return [synth_request(prof, uid, t, rng, vocab_size,
                          max_prompt=max_prompt, with_embeds=with_embeds)
            for uid, t in enumerate(np.sort(np.asarray(arrivals)))]


def stream_stats(specs: List[RequestSpec]) -> Dict[str, float]:
    """Quick composition summary of a request stream."""
    if not specs:
        return {}
    vis_fracs = [float(s.modality.mean()) for s in specs]
    return {
        "n_requests": len(specs),
        "prompt_tokens": int(sum(len(s.tokens) for s in specs)),
        "mean_prompt_len": float(np.mean([len(s.tokens) for s in specs])),
        "mean_vision_frac": float(np.mean(vis_fracs)),
        "vision_heavy_frac": float(np.mean([f > 0.5 for f in vis_fracs])),
        "span": float(specs[-1].arrival - specs[0].arrival),
    }
