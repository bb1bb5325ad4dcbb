"""Per-layer EWMA expert-load predictor with a separate decode window.

Fed from the engine's per-iteration routing statistics
(``aux["expert_stats"]``: per-MoE-layer routed-assignment counts per
logical expert, plus the vision sub-counts), it keeps one exponentially
weighted moving average per (layer, expert).  This is the
prediction-driven half of placement systems (MoE-GPS-style): the planner
consumes the *predicted* next-window loads, not the instantaneous ones,
so a one-iteration burst does not trigger a migration — that burst is
ReaLB's job.

Loads are normalized per observation (each layer's counts divided by the
iteration's total) before averaging, so prefill iterations with 10³
tokens and decode iterations with 10¹ tokens contribute comparable
routing *distributions* rather than letting prefill dominate by volume.

Decode window
-------------
Normalization equalizes *per-observation* weight, but a serving stream
is still prefill-dominated by count, so decode-regime routing drifts are
drowned in the shared EWMA.  With ``decode_halflife > 0`` decode
observations feed a *separate* EWMA whose smoothing is derived from the
half-life (``alpha = 1 - 0.5**(1/halflife)`` in decode iterations);
``predict(regime="decode")`` then exposes the decode-only distribution
for decode-cadence replanning (ROADMAP "Decode-regime placement").

Per-layer prediction
--------------------
The state is already per-(layer, expert); ``predict()`` sums the layer
axis for a shared table, while ``predict_layers()`` keeps it — the
observation stream of per-layer placement/replication planning
(MoE-GPS: prediction granularity decides duplication gains).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class EWMAPredictor:
    def __init__(self, num_experts: int, alpha: float = 0.25,
                 decode_halflife: float = 0.0):
        assert 0.0 < alpha <= 1.0, alpha
        self.num_experts = int(num_experts)
        self.alpha = float(alpha)
        self.decode_halflife = float(decode_halflife)
        self.load: Optional[np.ndarray] = None   # [L, E] EWMA load share
        self.vis: Optional[np.ndarray] = None    # [L, E] EWMA vision share
        self.load_dec: Optional[np.ndarray] = None  # [L, E] decode window
        self.vis_dec: Optional[np.ndarray] = None
        self.n_obs = 0
        self.n_obs_decode = 0

    @property
    def decode_alpha(self) -> float:
        """EWMA smoothing of the decode window, from its half-life."""
        if self.decode_halflife <= 0:
            return 0.0
        return 1.0 - 0.5 ** (1.0 / self.decode_halflife)

    def observe(self, layer_load: np.ndarray,
                layer_vis: Optional[np.ndarray] = None,
                decode: bool = False) -> None:
        """layer_load/[layer_vis]: [L, E] routed counts for one iteration.

        ``decode`` marks a decode-regime iteration: with a decode window
        configured it updates that window instead of the main one.
        Iterations that routed nothing (pure-padding forwards) are
        ignored instead of decaying the average toward zero.
        """
        load = np.atleast_2d(np.asarray(layer_load, np.float64))
        assert load.shape[-1] == self.num_experts, load.shape
        total = load.sum()
        if total <= 0:
            return
        vis = np.zeros_like(load) if layer_vis is None \
            else np.atleast_2d(np.asarray(layer_vis, np.float64))
        norm = load / total
        vnorm = vis / total
        if decode and self.decode_alpha > 0.0:
            a = self.decode_alpha
            if self.load_dec is None or self.load_dec.shape != load.shape:
                self.load_dec, self.vis_dec = norm, vnorm
            else:
                self.load_dec = a * norm + (1.0 - a) * self.load_dec
                self.vis_dec = a * vnorm + (1.0 - a) * self.vis_dec
        else:
            if self.load is None or self.load.shape != load.shape:
                self.load, self.vis = norm, vnorm
            else:
                a = self.alpha
                self.load = a * norm + (1.0 - a) * self.load
                self.vis = a * vnorm + (1.0 - a) * self.vis
        if decode:
            # counted even without a decode window, so a decode replan
            # cadence still fires (planning from the shared window via
            # predict's fallback) instead of silently never triggering
            self.n_obs_decode += 1
        self.n_obs += 1

    def _window(self, regime: str
                ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        if regime == "decode" and self.load_dec is not None:
            return self.load_dec, self.vis_dec
        return self.load, self.vis

    def predict(self, regime: str = "mixed"
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Aggregated (load, vis) share per logical expert, [E] each.

        Layers are summed: a shared placement table serves every MoE
        layer, so its planner balances the stack-total per-expert load.
        ``regime="decode"`` reads the decode window when one exists
        (falling back to the main window otherwise).
        """
        load, vis = self._window(regime)
        if load is None:
            z = np.zeros(self.num_experts)
            return z, z.copy()
        return load.sum(0), vis.sum(0)

    def predict_layers(self, regime: str = "mixed"
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """[L, E] per-layer (load, vis) EWMA shares — the per-layer
        planners' observation stream.  None before the first observation.
        """
        load, vis = self._window(regime)
        if load is None:
            return None
        return load.copy(), vis.copy()

    # -- checkpointing ----------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {"alpha": np.float64(self.alpha),
               "n_obs": np.int64(self.n_obs),
               "n_obs_decode": np.int64(self.n_obs_decode),
               "num_experts": np.int64(self.num_experts)}
        if self.load is not None:
            out["load"] = self.load
            out["vis"] = self.vis
        if self.load_dec is not None:
            out["load_dec"] = self.load_dec
            out["vis_dec"] = self.vis_dec
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        assert int(state["num_experts"]) == self.num_experts, \
            (int(state["num_experts"]), self.num_experts)
        self.alpha = float(state["alpha"])
        self.n_obs = int(state["n_obs"])
        self.n_obs_decode = int(state.get("n_obs_decode", 0))
        self.load = np.asarray(state["load"], np.float64) \
            if "load" in state else None
        self.vis = np.asarray(state["vis"], np.float64) \
            if "vis" in state else None
        self.load_dec = np.asarray(state["load_dec"], np.float64) \
            if "load_dec" in state else None
        self.vis_dec = np.asarray(state["vis_dec"], np.float64) \
            if "vis_dec" in state else None
        # decode_halflife is CONFIGURATION, not state — a restore must
        # neither disable a configured decode window nor resurrect one
        # the live run did not ask for.  With the window off, restored
        # decode-window arrays would go stale forever (nothing updates
        # them, regime="decode" would keep reading them): drop them so
        # decode traffic falls back into the main planning window.
        if self.decode_alpha <= 0.0:
            self.load_dec = self.vis_dec = None
            self.n_obs_decode = 0
