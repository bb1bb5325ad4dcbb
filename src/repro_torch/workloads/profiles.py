"""Per-benchmark workload calibration (modality mix & routing dynamics).

A copy of ``repro.workloads.profiles`` (the port imports nothing of
``repro``): the same named workloads, so the port's request streams equal
the reference's for the same seed.
"""
from __future__ import annotations

from typing import Dict

WORKLOADS: Dict[str, Dict] = {
    "MMMU":      dict(vision_frac_mean=0.72, vision_frac_std=0.15,
                      zipf_a=1.18, jump_every=220),
    "MathVista": dict(vision_frac_mean=0.55, vision_frac_std=0.18,
                      zipf_a=1.12, jump_every=300),
    "DynaMath":  dict(vision_frac_mean=0.62, vision_frac_std=0.25,
                      zipf_a=1.2, jump_every=160),
    "AI2D":      dict(vision_frac_mean=0.5, vision_frac_std=0.12,
                      zipf_a=1.1, jump_every=350),
    "InfoVQA":   dict(vision_frac_mean=0.66, vision_frac_std=0.14,
                      zipf_a=1.15, jump_every=280),
    "TextVQA":   dict(vision_frac_mean=0.45, vision_frac_std=0.12,
                      zipf_a=1.08, jump_every=320),
    "MMBench":   dict(vision_frac_mean=0.55, vision_frac_std=0.15,
                      zipf_a=1.12, jump_every=260),
}
