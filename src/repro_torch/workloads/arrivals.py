"""Open-loop arrival processes with a seeded, deterministic event clock
(a copy of ``repro.workloads.arrivals``).

Four request-arrival regimes cover the serving evaluations of ReaLB and
the open-loop harnesses of related systems (HarMoEny, MoE-GPS):

* ``poisson`` — homogeneous Poisson at ``rate`` req/s: the steady-state
  baseline.
* ``bursty``  — 2-state Markov-modulated Poisson process (MMPP-2): dwell
  in a calm phase (``rate * calm_mult``) and a burst phase
  (``rate * burst_mult``) with exponential holding times.  This is the
  "highly dynamic, vision-skewed traffic" regime where ReaLB's headline
  speedups live.
* ``diurnal`` — inhomogeneous Poisson with a sinusoidal rate ramp
  (period/depth), generated by thinning: the slow load swing of a
  production deployment compressed onto benchmark timescales.
* ``closed``  — a fixed population of ``concurrency`` users, each
  submit → wait → think(exp) → submit; feedback arrivals are produced at
  run time via :class:`ClosedLoop` rather than precomputed.

All open-loop kinds precompute the full arrival-time vector from one
``numpy`` generator seeded by ``seed``, so a (config, seed) pair is an
exactly reproducible experiment; pair with :class:`VirtualClock` to make
the *service* side deterministic too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

KINDS = ("poisson", "bursty", "diurnal", "closed")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    kind: str = "poisson"
    rate: float = 8.0              # mean requests per time unit
    n_requests: int = 64
    seed: int = 0
    # bursty (MMPP-2)
    burst_mult: float = 6.0        # burst-phase rate multiplier
    calm_mult: float = 0.4         # calm-phase rate multiplier
    mean_burst: float = 1.5        # mean dwell in burst phase (time units)
    mean_calm: float = 6.0         # mean dwell in calm phase
    # diurnal ramp
    period: float = 60.0
    depth: float = 0.8             # fractional rate swing, 0..1
    # closed loop
    concurrency: int = 8
    think_time: float = 0.5        # mean think time between a user's reqs

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert self.rate > 0 and self.n_requests > 0


def _poisson(cfg: ArrivalConfig, rng) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / cfg.rate, cfg.n_requests))


def _bursty(cfg: ArrivalConfig, rng) -> np.ndarray:
    """MMPP-2: alternate calm/burst phases, exponential dwell times."""
    out: List[float] = []
    t = 0.0
    burst = False                       # start calm
    phase_end = rng.exponential(cfg.mean_calm)
    while len(out) < cfg.n_requests:
        lam = cfg.rate * (cfg.burst_mult if burst else cfg.calm_mult)
        gap = rng.exponential(1.0 / lam)
        if t + gap >= phase_end:
            # no arrival before the phase switch: jump to it and flip
            t = phase_end
            burst = not burst
            phase_end = t + rng.exponential(
                cfg.mean_burst if burst else cfg.mean_calm)
            continue
        t += gap
        out.append(t)
    return np.asarray(out)


def _diurnal(cfg: ArrivalConfig, rng) -> np.ndarray:
    """Inhomogeneous Poisson via thinning of a max-rate stream."""
    lam_max = cfg.rate * (1.0 + cfg.depth)
    out: List[float] = []
    t = 0.0
    while len(out) < cfg.n_requests:
        t += rng.exponential(1.0 / lam_max)
        lam_t = cfg.rate * (1.0 + cfg.depth
                            * np.sin(2.0 * np.pi * t / cfg.period))
        if rng.random() * lam_max < lam_t:
            out.append(t)
    return np.asarray(out)


def arrival_times(cfg: ArrivalConfig) -> np.ndarray:
    """Sorted arrival times [n_requests] for the open-loop kinds; the
    ``closed`` kind has feedback arrivals — use :class:`ClosedLoop`."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.kind == "poisson":
        return _poisson(cfg, rng)
    if cfg.kind == "bursty":
        return _bursty(cfg, rng)
    if cfg.kind == "diurnal":
        return _diurnal(cfg, rng)
    if cfg.kind == "closed":
        # first wave: every user submits at t=0; the rest is feedback
        return np.zeros(min(cfg.concurrency, cfg.n_requests))
    raise ValueError(cfg.kind)


class ClosedLoop:
    """Feedback arrivals for the closed-loop kind: each completion re-arms
    the finishing user's next submission after an exponential think time.
    Deterministic given (cfg.seed, the completion order)."""

    def __init__(self, cfg: ArrivalConfig):
        assert cfg.kind == "closed"
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed + 1)
        self.issued = min(cfg.concurrency, cfg.n_requests)

    def next_arrival(self, finish_time: float) -> Optional[float]:
        """Called on each request completion; returns the next submission
        time, or None once n_requests have been issued."""
        if self.issued >= self.cfg.n_requests:
            return None
        self.issued += 1
        return finish_time + self.rng.exponential(self.cfg.think_time)


class VirtualClock:
    """Deterministic event clock: the driver advances it by a modeled
    per-iteration cost instead of reading wall time, so latency metrics of
    a seeded run are bit-reproducible across hosts.  Pass the instance as
    the engine's ``clock``."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, dt
        self.t += float(dt)
        return self.t


@dataclasses.dataclass(frozen=True)
class IterationCostModel:
    """Virtual-time cost of one engine iteration: a fixed launch overhead
    plus a per-token term (the GEMM-dominated regime is linear in batch
    tokens).  The defaults are the reference's virtual-time constants, not
    a measurement of any device; only *relative* latencies matter.
    """
    fixed: float = 2e-3          # per-forward launch/dispatch overhead (s)
    per_token: float = 2e-5      # per batch token (s)

    def cost(self, batch_tokens: int) -> float:
        return self.fixed + self.per_token * max(batch_tokens, 0)
