"""Roofline terms and model FLOPs of a step, priced at a card's record.

Counterpart of ``repro.launch.roofline``, which prices at the TPU v5e's
constants; here every rate comes from a ``repro_torch.configs.hw``
record (default the H100 SXM).  Terms are seconds a step from per-device
quantities:

    compute    = flops_per_device / hardware.peak_bf16
    memory     = bytes_per_device / hardware.hbm_bw
    collective = collective_bytes_per_device / MIGRATION_BW_DEFAULT

Links are priced at ``MIGRATION_BW_DEFAULT``, as the reference prices its
ICI.  The serving profiler (``obs.profiler``) reads the same function.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs import hw
from repro_torch.configs.base import MIGRATION_BW_DEFAULT


def roofline_terms(flops: float, hbm_bytes: float, link_bytes: float,
                   hardware: hw.Hardware = hw.H100_SXM) -> Dict[str, Any]:
    """Seconds of compute at the bf16 peak, of HBM traffic, and of link
    bytes at ``MIGRATION_BW_DEFAULT``; the dominant term, the bound (their
    maximum) and the roofline fraction (compute over the bound)."""
    comp = flops / hardware.peak_bf16
    mem = hbm_bytes / hardware.hbm_bw
    coll = link_bytes / MIGRATION_BW_DEFAULT
    dominant = max(("compute", comp), ("memory", mem),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    total = max(comp, mem, coll)
    return {"compute_s": comp, "memory_s": mem, "collective_s": coll,
            "dominant": dominant, "bound_s": total,
            "roofline_fraction": (comp / total) if total > 0 else 0.0}


def model_flops(cfg, shape) -> float:
    """2·N_active·tokens (×3 for a train step: forward and twice that
    backward), global: the reference's yardstick of useful work."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        tokens = shape.global_batch          # one token a sequence
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    return 2.0 * n * tokens * mult
