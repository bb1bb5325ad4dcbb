"""ReaLB control policy (paper §4.2): hotspot detection + modality
threshold + AIMD adaptation + LB gate.

Counterpart of ``repro.core.policy``: plain tensor math on per-EP-rank
vectors, run on the device inside the MoE layer.  Decisions and the AIMD
state are bitwise equal to the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ReaLBConfig


class PolicyDecision(NamedTuple):
    use_fp4: torch.Tensor     # bool [R] — rank executes its experts in FP4
    hotspots: torch.Tensor    # bool [R]
    ib_d: torch.Tensor        # f32 [R] per-rank imbalance Load_d / Ideal
    ib_global: torch.Tensor   # f32 scalar max_d IB_d
    r_v: torch.Tensor         # f32 [R] vision token ratio per rank
    gate_open: torch.Tensor   # bool scalar — LB gate (Γ)
    m_new: torch.Tensor       # f32 [R] updated AIMD thresholds


def lb_gate(total_tokens: torch.Tensor, cfg: ReaLBConfig) -> torch.Tensor:
    """Γ gate: activate only in the GEMM-dominated (large-batch) regime."""
    return total_tokens > cfg.gate_gamma


def realb_policy(load_d: torch.Tensor, vis_d: torch.Tensor,
                 m_d: torch.Tensor, cfg: ReaLBConfig) -> PolicyDecision:
    """One synchronous control step for an EP group.

    load_d: f32 [R] tokens routed to each rank's experts this layer.
    vis_d:  f32 [R] vision tokens among them.
    m_d:    f32 [R] current AIMD modality thresholds.
    """
    load_d = load_d.to(torch.float32)
    total = load_d.sum()
    # XLA compiles the reference's division by the constant rank count into
    # a multiplication by its f32 reciprocal
    ideal = total * float(np.float32(1.0) / np.float32(load_d.shape[0]))
    ib_d = load_d / torch.clamp(ideal, min=1.0)
    ib_global = ib_d.max()
    hot = ib_d > cfg.capacity_c
    r_v = vis_d.to(torch.float32) / torch.clamp(load_d, min=1.0)
    gate = lb_gate(total, cfg)

    compress = hot & (r_v > m_d) & gate & cfg.enabled

    if cfg.adaptive:
        m_up = torch.clamp(m_d + cfg.md_add, max=1.0)
        m_down = torch.clamp(m_d * cfg.md_mult, min=cfg.md_min)
        m_new = torch.where(ib_global > cfg.tau, m_down, m_up)
        # only adapt while the balancer is live (gate open); else hold.
        m_new = torch.where(gate, m_new, m_d)
    else:
        m_new = m_d

    return PolicyDecision(compress, hot, ib_d, ib_global, r_v, gate, m_new)


def init_m_state(n_groups: int, ep: int, cfg: ReaLBConfig,
                 device=None) -> torch.Tensor:
    """AIMD state M_d: one threshold per (EP group row, EP rank)."""
    return torch.full((n_groups, ep), cfg.md_init, dtype=torch.float32,
                      device=device)
