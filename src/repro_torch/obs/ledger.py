"""FLOP/byte ledger — exact per-iteration accounting of the MoE hot loop.

Counterpart of ``repro.obs.ledger``.  The formulas are the reference's, term
for term: the ledger turns the *realized* routing statistics of each
forward (``aux["moe_stats"]``: per-layer per-rank routed assignment
counts, plus the ``fp4_ranks`` policy scalar) into

- **flops** per phase: router GEMM (``route``), grouped expert GEMM
  (``expert_gemm``, split by the rate each rank ran at: BF16, or FP4 at
  ``peak_fp4_gemm``), and the dense remainder (``other``: attention,
  dense FFN, shared experts, embeddings, norms);
- **HBM bytes** per phase: expert weight streaming (4.25-bit FP4 packs vs
  2-byte BF16), activation traffic, the BF16→FP4 transformation's read
  and write on compressed ranks, dense weight streaming;
- **ICI bytes**: the dispatch and combine all-to-alls over the (virtual)
  EP group, priced at ``MIGRATION_BW_DEFAULT`` as the reference prices
  them;
- **predicted seconds** per phase, roofline-priced.

Only the hardware record differs: the constants come in as one
:class:`~repro_torch.configs.hw.Hardware` (default: the card's,
``hw.current()``), so the same formulas price the H100 on the card and,
given the reference's TPU figures, give the reference's numbers.  On
Hopper the FP4 expert GEMM decodes into bf16 ``wgmma``, so its rate is
the bf16 peak rather than the TPU's int8 MXU rate.

Where the port's path is not what these formulas price (the profiler's
per-phase drift ratios are where it shows):

- the quantizer and the global scale run as three launches each per FP4
  layer (one per weight), and one card has no all-to-all to hide the
  quantizer behind, so ``fused=True``'s "only the excess over dispatch is
  visible" does not hold there;
- the virtual EP group's dispatch is a gather on one card, not a
  transfer over a link.

Approximation (the reference's): the policy's aux says how *many* ranks
ran FP4 per layer, not which — FP4 is attributed to the most-loaded
ranks of each layer, as ReaLB compresses the hot ranks.

``model_flops`` (the MFU numerator) is ``2 · active_param_count ·
routed_tokens``: padding the hardware computed earns no utilization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.configs import hw as hw_lib
from repro_torch.configs.base import MIGRATION_BW_DEFAULT

# the reference's benchmarks/costmodel.py constants
FIXED_US = 12.0               # dispatch/kernel fixed overhead per stage
BYTES_BF16 = 2.0
BYTES_FP4 = 0.53125           # 4 bits + e4m3 scale per 16-group = 4.25 b

#: phase vocabulary — the ``stop_stage`` names of ``core/ep_moe.py`` plus
#: the non-MoE remainder of the forward.
PHASES = ("route", "weight_gather", "quantize_fp4", "dispatch",
          "expert_gemm", "combine", "other")


def _zero_phases() -> Dict[str, float]:
    return {ph: 0.0 for ph in PHASES}


@dataclasses.dataclass
class IterLedger:
    """One iteration's accounting: flops / bytes / predicted seconds."""
    tokens: float                       # routed (non-pad) tokens
    batch_tokens: float                 # padded batch size the step ran at
    flops: Dict[str, float]             # per phase
    flops_by_rate: Dict[str, float]     # {"bf16": ..., "int8": ...} GEMM
    #                                     split ("int8": FP4 ranks, the
    #                                     reference's name for that rate)
    hbm_bytes: Dict[str, float]         # per phase
    ici_bytes: Dict[str, float]         # per phase (dispatch/combine only)
    pred_s: Dict[str, float]            # analytic per-phase seconds
    model_flops: float                  # MFU numerator

    @property
    def flops_total(self) -> float:
        return sum(self.flops.values())

    @property
    def hbm_total(self) -> float:
        return sum(self.hbm_bytes.values())

    @property
    def ici_total(self) -> float:
        return sum(self.ici_bytes.values())

    @property
    def pred_total(self) -> float:
        return sum(self.pred_s.values())


class FlopByteLedger:
    """Per-iteration FLOP/byte accounting for one model config.

    ``ep`` is the *policy* EP width (the virtual group dispatch packs
    for).  ``fused`` is the reference's switch between its fused Pallas
    kernels (FP4 weights stream packed; the transformation hides in the
    dispatch window) and its jnp fallback (a dequantized BF16 slab
    round-trips HBM).  ``hardware`` prices the work (default: the card's
    record)."""

    def __init__(self, cfg, ep: int, fused: bool = False,
                 hardware: Optional[hw_lib.Hardware] = None):
        if cfg.moe is None:
            raise ValueError("FlopByteLedger needs an MoE config")
        self.cfg = cfg
        self.ep = int(ep)
        self.fused = bool(fused)
        self.hw = hw_lib.current() if hardware is None else hardware
        self.d = int(cfg.d_model)
        self.d_ff = int(cfg.moe.d_ff)
        self.n_experts = int(cfg.moe.num_experts)
        self.top_k = int(cfg.moe.top_k)
        self.e_loc = max(self.n_experts // self.ep, 1)
        self.mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
        self.n_moe = sum(1 for k in cfg.ffn_kinds() if k == "moe")
        self.active_params = float(cfg.active_param_count())
        # params outside the routed-expert GEMMs and the router: the
        # "other" phase streams these
        moe_routed = self.n_moe * self.top_k * self.mult * self.d * self.d_ff
        router = self.n_moe * self.d * self.n_experts
        self.other_params = max(self.active_params - moe_routed - router, 0.0)

    # -- the reference's costmodel formulas ------------------------------
    def _expert_gemm_s(self, tokens_r: float, fp4: bool) -> float:
        flops = tokens_r * 2.0 * self.mult * self.d * self.d_ff
        w_raw = self.e_loc * self.mult * self.d * self.d_ff
        w_bytes = w_raw * (BYTES_FP4 if fp4 else BYTES_BF16)
        if fp4 and not self.fused:
            w_bytes += w_raw * 2.0 * BYTES_BF16  # dequant round-trip
        act_bytes = tokens_r * self.d * BYTES_BF16 * 4.0
        rate = self.hw.peak_fp4_gemm if fp4 else self.hw.peak_bf16
        return max(flops / rate, (w_bytes + act_bytes) / self.hw.hbm_bw)

    def _quantize_s(self) -> float:
        w = self.e_loc * self.mult * self.d * self.d_ff
        return (w * BYTES_BF16 + w * BYTES_FP4) / self.hw.hbm_bw

    def _quantize_visible_s(self, dispatch_s: float) -> float:
        # fused: the transformation hides inside the dispatch window (only
        # the excess shows); unfused: a standalone stage with its launch
        # overhead
        q = self._quantize_s()
        if self.fused:
            return max(0.0, q - dispatch_s)
        return q + FIXED_US * 1e-6

    def _dispatch_s(self, tokens_total: float, ici_bw: float) -> float:
        per_rank = (tokens_total / self.ep * (self.ep - 1) / self.ep
                    * self.d * BYTES_BF16)
        return per_rank / ici_bw + FIXED_US * 1e-6

    def _nongemm_s(self, tokens_r: float) -> float:
        return (tokens_r * self.d * 6.0) / self.hw.hbm_bw + 3 * FIXED_US * 1e-6

    # --------------------------------------------------------------------
    def predict_graph_census(self, t_local: int, layers: int,
                             itemsize: int = 2,
                             n_slots: Optional[int] = None,
                             rows: int = 1) -> Dict[str, Dict[str, int]]:
        """Predicted collective census of ``layers`` dispatch-mode MoE
        layers on an EP mesh: what one rank issues, with the bytes of its
        input (the reference's terms).  The all-to-alls carry the whole
        capacity buffer ``[ep, cap, d]`` however many of its rows are
        real.  Per layer, as in the reference: 3 all-to-alls (x out, the
        expert ids, the combine back) and 9 psums (the one-hot ``m_vec``,
        counts and vision counts, slot loads and vision loads, the split
        and dropped scalars, the router sums of ``p_mean`` and ``z``).

        The port packs the psums: ``all_reduce`` counts what it issues,
        one all-reduce of the 8 psums the policy and the losses need and
        one of ``dropped``, with the same bytes.  ``layout_all_gather`` is
        the port's layout, which the reference's census classes out as
        partitioner-inserted: the MoE output gathered over ``model`` each
        layer, and with ``rows`` > 1 groups the outputs, AIMD rows and
        statistics gathered over ``data``.

        ``t_local``: tokens a rank dispatches (its rows and sequence
        slice); ``itemsize``: activation bytes (2 = bf16); ``n_slots``:
        physical slots (default: the expert count)."""
        ep = self.ep
        cap_raw = math.ceil(t_local * self.top_k / ep
                            * float(self.cfg.moe.capacity_factor))
        cap = max(8, -(-cap_raw // 8) * 8)   # ep_moe's capacity
        s = int(n_slots) if n_slots is not None else self.n_experts
        a2a_bytes = (2 * ep * cap * self.d * itemsize   # x out + combine
                     + ep * cap * 4)                    # expert ids (int32)
        psum_elems = (ep                    # m_vec one-hot [ep]
                      + 3 * self.n_experts  # counts, vis, p_mean [E]
                      + 2 * s               # slot_load, slot_vis [S]
                      + 3)                  # split, dropped, z scalars
        gather = t_local * self.d * itemsize
        n_gather = 1
        if rows > 1:
            n_aux = 7                        # ep_moe.AUX_SCALARS
            gather += (t_local * ep * self.d * itemsize
                       + 4 * (ep + n_aux + 2 * ep + 2 * self.n_experts
                              + 2 * s))
            n_gather = 3
        return {
            "all_to_all": {"count": 3 * layers,
                           "bytes": a2a_bytes * layers},
            "psum": {"count": 9 * layers,
                     "bytes": 4 * psum_elems * layers},
            "all_reduce": {"count": 2 * layers,
                           "bytes": 4 * psum_elems * layers},
            "layout_all_gather": {"count": n_gather * layers,
                                  "bytes": gather * layers},
        }

    def predict_train_census(self, t_local: int, layers: int, rows: int,
                             itemsize: int, param_itemsize: int,
                             replicated_shapes, remat: str = "none"
                             ) -> Dict[str, Dict[str, int]]:
        """Predicted collective census of one train step under a ``(rows,
        ep)`` mesh (``ep`` > 1; ``launch.steps.make_train_step``, the FSDP
        layout): what one rank issues, by the port's kinds.

        Forward, per MoE layer: :meth:`predict_graph_census`'s all-to-alls,
        psums and packed all-reduces, the output gathered over ``model``,
        with ``rows`` > 1 the statistics gathered over ``data`` (the rows'
        activations are not) and the three FSDP gathers of the slab
        shards (``fsdp_all_gather``).  ``remat`` "full" or "attn_out"
        re-runs all of that in the backward.  Backward, per MoE layer: the
        combine's and the dispatch's transposes (``all_to_all_grad``, the
        expert ids have none), the sequence slice's and the router
        logits' (``layout_all_gather_grad``), the three reduce-scatters of
        the whole slabs' gradients.  Then the loss's numerator and
        denominator summed over ``data``, the replicated leaves' gradient
        (``replicated_shapes``: their shapes in tree order) in the f32
        buckets of ``optim.grad_utils.data_parallel_grads``
        (``grad_all_reduce``), the global norm's all-gather and the
        agreement on the update."""
        import torch

        from repro_torch.models.common import row_chunks
        from repro_torch.optim.grad_utils import BUCKET_ELEMS, buckets
        ep, d = self.ep, self.d
        s = self.n_experts
        fwd = self.predict_graph_census(t_local, layers, itemsize)
        if rows > 1:
            g = fwd["layout_all_gather"]
            g["count"] += layers
            g["bytes"] += 4 * (ep + 7 + 2 * ep + 2 * self.n_experts
                               + 2 * s) * layers
            shard = (s // ep) * (d // rows) * self.d_ff * param_itemsize
            fwd["fsdp_all_gather"] = {"count": 3 * layers,
                                      "bytes": 3 * shard * layers}
        passes = 2 if remat in ("full", "attn_out") else 1
        out = {k: {"count": v["count"] * passes, "bytes": v["bytes"] * passes}
               for k, v in fwd.items()}
        cap_raw = math.ceil(t_local * self.top_k / ep
                            * float(self.cfg.moe.capacity_factor))
        cap = max(8, -(-cap_raw // 8) * 8)   # ep_moe's capacity
        out["all_to_all_grad"] = {
            "count": 2 * layers, "bytes": 2 * ep * cap * d * itemsize * layers}
        out["layout_all_gather_grad"] = {
            "count": 2 * layers,
            "bytes": t_local * (d * itemsize + 4 * self.n_experts) * layers}
        if rows > 1:
            out["fsdp_reduce_scatter"] = {
                "count": 3 * layers,
                "bytes": 3 * (s // ep) * d * self.d_ff * param_itemsize
                * layers}
            out["psum_data"] = {"count": 2, "bytes": 8}
            out["all_reduce_data"] = {"count": 1, "bytes": 8}
            sizes = [c.numel() for shape in replicated_shapes
                     for c in row_chunks(torch.empty(shape, device="meta"),
                                         BUCKET_ELEMS)]
            out["grad_all_reduce"] = {"count": len(buckets(sizes)),
                                      "bytes": 4 * sum(sizes)}
        out["norm_all_gather"] = {"count": 1, "bytes": 4}
        out["agree_all_reduce"] = {"count": 1, "bytes": 4}
        return out

    def rank_loads(self, moe_stats) -> np.ndarray:
        """``[L, ep]`` realized per-layer per-rank assignment counts from
        ``aux["moe_stats"]`` (``[L, 2, groups, ep]`` or ``[L, 2, ep]``);
        the groups axis is averaged."""
        ms = np.asarray(moe_stats, dtype=np.float64)
        load = ms[:, 0] if ms.ndim >= 3 else ms[None, 0]
        if load.ndim == 3:                      # [L, groups, ep]
            load = load.mean(axis=1)
        return load.reshape(load.shape[0], -1)[:, -self.ep:]

    def account(self, moe_stats, fp4_layers: float, tokens: float,
                batch_tokens: float, ici_bw: Optional[float] = None
                ) -> IterLedger:
        """Account one iteration.

        ``moe_stats``: the forward's ``aux["moe_stats"]``; ``fp4_layers``:
        mean FP4 rank count per layer (the engine's ``stat.fp4_ranks``);
        ``tokens``/``batch_tokens``: routed vs padded token counts;
        ``ici_bw``: optional link bytes/s (default
        ``MIGRATION_BW_DEFAULT``, the reference's)."""
        bw = float(ici_bw) if ici_bw else MIGRATION_BW_DEFAULT
        peak_bf16, hbm_bw = self.hw.peak_bf16, self.hw.hbm_bw
        load = self.rank_loads(moe_stats)            # [L, ep]
        n_rows, ep = load.shape
        tokens = float(tokens)
        batch_tokens = float(batch_tokens)
        k_fp4 = int(np.clip(round(float(fp4_layers)), 0, ep))

        flops = _zero_phases()
        by_rate = {"bf16": 0.0, "int8": 0.0}
        hbm = _zero_phases()
        ici = _zero_phases()
        pred = _zero_phases()

        gemm_per_tok = 2.0 * self.mult * self.d * self.d_ff
        w_slab = self.e_loc * self.mult * self.d * self.d_ff
        for l in range(n_rows):
            row = load[l]
            # FP4 on the k hottest ranks of this layer
            fp4_mask = np.zeros(ep, dtype=bool)
            if k_fp4 > 0:
                fp4_mask[np.argsort(row)[-k_fp4:]] = True

            # route: router GEMM over the layer's tokens + the sort/softmax
            # non-GEMM traffic
            flops["route"] += tokens * self.d * self.n_experts * 2.0
            hbm["route"] += row.sum() * self.d * 6.0
            pred["route"] += self._nongemm_s(row.max(initial=0.0))

            # weight_gather: nothing on one device

            # quantize_fp4: read BF16, write packed, on FP4 ranks only
            q_bytes = fp4_mask.sum() * w_slab * (BYTES_BF16 + BYTES_FP4)
            hbm["quantize_fp4"] += q_bytes
            if k_fp4 > 0:
                pred["quantize_fp4"] += self._quantize_visible_s(
                    self._dispatch_s(tokens * self.top_k, bw))

            # dispatch / combine: a2a of routed activations both ways
            a2a_rank = (tokens * self.top_k / ep * (ep - 1) / ep
                        * self.d * BYTES_BF16)
            ici["dispatch"] += a2a_rank * ep
            ici["combine"] += a2a_rank * ep
            pred["dispatch"] += self._dispatch_s(tokens * self.top_k, bw)
            pred["combine"] += self._dispatch_s(tokens * self.top_k, bw)

            # expert_gemm: per-rank grouped GEMM; wall time is the
            # straggler rank, flops/bytes sum over ranks
            for r in range(ep):
                f = row[r] * gemm_per_tok
                by_rate["int8" if fp4_mask[r] else "bf16"] += f
                flops["expert_gemm"] += f
                wb = w_slab * (BYTES_FP4 if fp4_mask[r] else BYTES_BF16)
                if fp4_mask[r] and not self.fused:
                    wb += w_slab * 2.0 * BYTES_BF16  # dequant round-trip
                hbm["expert_gemm"] += (
                    wb + row[r] * self.d * BYTES_BF16 * 4.0)
            pred["expert_gemm"] += max(
                self._expert_gemm_s(row[r], bool(fp4_mask[r]))
                for r in range(ep))

        # other: the dense remainder, roofline-priced
        flops["other"] = 2.0 * self.other_params * tokens
        hbm["other"] = (self.other_params * BYTES_BF16
                        + tokens * self.d * BYTES_BF16 * 8.0)
        pred["other"] = max(flops["other"] / peak_bf16,
                            hbm["other"] / hbm_bw)

        as_f = lambda d: {k: float(v) for k, v in d.items()}  # noqa: E731
        return IterLedger(
            tokens=tokens, batch_tokens=batch_tokens,
            flops=as_f(flops), flops_by_rate=as_f(by_rate),
            hbm_bytes=as_f(hbm), ici_bytes=as_f(ici), pred_s=as_f(pred),
            model_flops=2.0 * self.active_params * tokens)
