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
                             rows: int = 1, layout: Optional[dict] = None
                             ) -> Dict[str, Dict[str, int]]:
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
        physical slots (default: the expert count).

        ``layout`` (``mesh``, ``mode``, ``batch``, ``seq`` and optionally
        ``cache_len``): the tensor-parallel layout of the default rules,
        where every collective of the forward is the layout's as well
        (:func:`predict_layout_census`, which takes these MoE terms for
        each layer)."""
        if layout is not None:
            return predict_layout_census(self.cfg, n_slots=n_slots,
                                         **layout)
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

    def predict_layout_moe_census(self, mesh, t_local: int, layers: int = 1,
                                  itemsize: int = 2, groups: int = 1,
                                  n_slots: Optional[int] = None,
                                  decode: bool = False
                                  ) -> Dict[str, Dict[str, int]]:
        """The forward collectives of ``layers`` MoE layers in the
        tensor-parallel layout of the default rules on ``mesh`` (a
        ``models.common.Mesh``), what one rank issues: the three expert
        stacks' ``D`` dim gathered over ``data`` where it divides
        (``fsdp_all_gather`` of the rank's ``S/ep`` slots); over ``model``
        the dispatch's collectives of ``t_local`` tokens a rank
        (:meth:`predict_graph_census`, no output gather: the layer gives
        the rank's own rows) or, with ``decode``, the broadcast combine's
        (the one-hot and ordered sum of ``t_local`` rows); with
        ``groups`` > 1 ``m_state`` groups the statistics gathered over
        the rows.  ``itemsize``: the weights' and activations' bytes;
        ``n_slots``: physical slots (default: the expert count)."""
        m, data = mesh.size("model"), mesh.size("data")
        d = self.d
        s_all = self.n_experts if n_slots is None else int(n_slots)
        out = _Tally()
        if data > 1 and d % data == 0:
            out.add("fsdp_all_gather",
                    3 * (s_all // m) * (d // data) * self.d_ff * itemsize, 3)
        if m > 1:
            if decode:
                out.add("psum", 4 * m)
                out.add("all_reduce", 4 * m)
                out.add("psum", t_local * d * 4)
                out.add("all_gather", t_local * d * 4)
            else:
                c = self.predict_graph_census(t_local, 1, itemsize,
                                              n_slots=s_all)
                c.pop("layout_all_gather")
                out.merge(c)
        if groups > 1:
            out.add("layout_all_gather",
                    4 * (m + 7 + 2 * m + 2 * self.n_experts + 2 * s_all))
        tot = _Tally()
        tot.merge(out.kinds, layers)
        return tot.kinds

    def predict_train_census(self, t_local: int, layers: int, rows: int,
                             itemsize: int, param_itemsize: int,
                             replicated_shapes, remat: str = "none",
                             layout: Optional[dict] = None
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
        agreement on the update.  ``layout`` (``mesh``, ``batch``,
        ``seq``): the tensor-parallel layout of the default rules
        (:func:`predict_layout_census` of a train step)."""
        import torch
        if layout is not None:
            return predict_layout_census(self.cfg, mode="train", **layout)

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


# --------------------------------------------------------------------------
# a live migration's exchange (placement.migrate.gather_across)
# --------------------------------------------------------------------------
def slot_row_bytes(d_model: int, d_ff: int, itemsize: int, mesh=None) -> int:
    """Bytes of one expert slot's three slabs as a rank holds them, the
    unit ``Comm.exchange_rows`` moves: whole, or in the tensor-parallel
    layout of the default rules its data row's ``D/data`` slice (``embed``
    over ``data``, where it divides)."""
    from repro_torch.models.common import local_slice, tensor_parallel
    d = d_model
    if mesh is not None and tensor_parallel(mesh):
        cut = local_slice(d_model, "embed", mesh)
        d = cut.stop - cut.start
    return 3 * d * d_ff * itemsize


def predict_migration_census(gather_idx, ep: int, row_bytes: int,
                             blocks: int = 1) -> list:
    """Each EP rank's ``migrate_all_to_all`` census of a live migration's
    gather ``gather_idx`` (``[S]`` global slots, applied to ``blocks``
    stacked blocks alike, or ``[L, S]``, one row a block): one exchange a
    block whose rows cross ranks, on every rank of the group, carrying the
    rows it sends another rank (``placement.migrate.crossrank_sends``)
    times ``row_bytes`` (:func:`slot_row_bytes`).  In the tensor-parallel
    layout every data row's EP group makes the same exchange of its own
    ``D/data`` slices."""
    from repro_torch.placement.migrate import crossrank_sends
    idx = np.asarray(gather_idx, np.int64)
    rows = idx.reshape(-1, idx.shape[-1])
    times = blocks if idx.ndim == 1 else 1
    sends = crossrank_sends(rows, ep)                       # [L, ep]
    crossing = int((sends.sum(1) > 0).sum()) * times
    return [{"migrate_all_to_all": {
        "count": crossing,
        "bytes": int(sends[:, r].sum()) * times * int(row_bytes)}}
        if crossing else {} for r in range(ep)]


# --------------------------------------------------------------------------
# the tensor-parallel layout's census (models.layout)
# --------------------------------------------------------------------------
class _Tally:
    """Collectives by kind, ``{"count", "bytes"}`` (``Comm``'s census)."""

    def __init__(self):
        self.kinds: Dict[str, Dict[str, int]] = {}

    def add(self, kind: str, nbytes: float, count: int = 1) -> None:
        if count <= 0:
            return
        k = self.kinds.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += int(count)
        k["bytes"] += int(nbytes)

    def merge(self, other: Dict[str, Dict[str, int]], times: int = 1):
        for kind, v in other.items():
            self.add(kind, v["bytes"] * times, v["count"] * times)


def predict_layout_census(cfg, mesh, mode: str, batch: int, seq: int,
                          n_slots: Optional[int] = None,
                          cache_len: Optional[int] = None
                          ) -> Dict[str, Dict[str, int]]:
    """Predicted collective census of one forward (``mode`` "prefill",
    "chunk" or "decode", ``batch`` rows of ``seq`` tokens; a decode's
    ``seq`` is 1) or one train step (``"train"``:
    ``launch.steps.make_train_step``) in the tensor-parallel layout of the
    default rules (``models.layout``) on ``mesh`` (a ``models.common.Mesh``
    or its shape dict): what one rank issues, with the bytes of its input,
    by the port's kinds.  Every term follows the code that issues it:

    * each layer's weights gathered over ``data`` along their ``embed``
      dim (``fsdp_all_gather``), the expert stacks' in the MoE layer;
    * the residual's sequence gathered into each column-parallel layer
      (``tp_all_gather``) and the row-parallel partial sums reduced back
      (``tp_reduce_scatter``; in decode, or a sequence that does not
      divide, ``tp_all_reduce``), the Mamba layer's ``w_in`` gathered over
      ``model`` and its ``w_x`` product summed; the vocabulary-parallel
      embedding's sum;
    * serving: the heads gathered for the cache's rows and for decode and
      chunk attention (``head_all_gather``), the attention partials
      combined over the cache's ``kv_seq`` axes
      (``kv_combine_all_gather``), the last rows and the logits gathered
      (``last_row_all_gather``, ``logits_all_gather``);
    * each MoE layer's EP collectives (:meth:`FlopByteLedger.
      predict_graph_census` for dispatch, the decode combine's psum of the
      one-hot and ordered sum for broadcast), with one ``m_state`` group a
      data row its statistics gathered over the rows;
    * training: the forward's collectives twice under ``remat="full"``
      (the recompute), each one's transpose, the marked replicated
      weights' and entered values' gradient sums (``tp_all_reduce_grad``),
      the vocabulary-parallel loss (``tp_max_all_reduce``,
      ``tp_all_reduce``), the global loss's sums over the batch axes, the
      data-parallel gradient buckets (``grad_all_reduce``), the global
      norm and the agreement on the update."""
    import torch

    from repro_torch.configs.base import SSMConfig
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import (DTYPES, ROWS, Mesh, row_chunks,
                                           resolve_spec)
    from repro_torch.optim.grad_utils import BUCKET_ELEMS, buckets
    if isinstance(mesh, dict):
        mesh = Mesh(tuple(mesh.values()), "abstract", "meta")
    train = mode == "train"
    if train and cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat {cfg.remat!r}: the prediction "
                                  "covers 'none' and 'full'")
    m, data = mesh.size("model"), mesh.size("data")
    it = DTYPES[cfg.param_dtype].itemsize
    d, v = cfg.d_model, cfg.vocab_size
    b_cut = resolve_spec((batch,), ("batch",), mesh)[0]
    rows = mesh.size(b_cut) if b_cut else 1
    bl = batch // rows
    s = seq
    sp = mode != "decode" and s % m == 0
    sl = s // m if sp else s
    spec = tf.model_spec(cfg)
    fwd, bwd = _Tally(), _Tally()      # one forward; the transposes

    def cut(p):
        return resolve_spec(p.shape, p.axes or (None,) * len(p.shape), mesh)

    def weights(tree, sp_here, skip_experts=True):
        """``layout.prepare`` of a layer (or top-level leaves)."""
        for k, p in sorted(tree.items()):
            if isinstance(p, dict):
                if k == "moe":
                    p = {"router": p["router"]}
                weights(p, sp_here)
                continue
            c = cut(p)
            local = [n // (mesh.size(a) if a else 1)
                     for n, a in zip(p.shape, c)]
            held = math.prod(local)
            for dim, (a, name) in enumerate(zip(c, p.axes or ())):
                if name == "embed" and a and mesh.size(a) > 1:
                    fwd.add("fsdp_all_gather", held * it)
                    bwd.add("fsdp_reduce_scatter", held * mesh.size(a) * it)
                    held *= mesh.size(a)
            if train and sp_here and not any("model" in x for x in c):
                bwd.add("tp_all_reduce_grad", held * 4)

    def gather_seq(t_sp, n_tok, sp_here):
        """``TP.gather_seq`` of [bl, n_tok (whole), width]."""
        if m == 1:
            return
        if sp_here:
            fwd.add("tp_all_gather", bl * (n_tok // m) * t_sp * it)
            bwd.add("tp_reduce_scatter_grad", bl * n_tok * t_sp * it)
        elif train:
            bwd.add("tp_all_reduce_grad", bl * n_tok * t_sp * 4)

    def reduce_out(n_tok, sp_here, width=d):
        if m == 1:
            return
        if sp_here:
            fwd.add("tp_reduce_scatter", bl * n_tok * width * it)
            bwd.add("tp_all_gather_grad", bl * (n_tok // m) * width * it)
        else:
            fwd.add("tp_all_reduce", bl * n_tok * width * it)

    def heads(n, n_tok, width):
        if m > 1:
            fwd.add("head_all_gather", bl * n_tok * (n // m) * width * it)

    def combine(kv_cut, n_q, width):
        if kv_cut and mesh.size(kv_cut) > 1:
            h = cfg.n_heads
            fwd.add("kv_combine_all_gather",
                    4 * (2 * bl * h * n_q + bl * h * n_q * width))

    def dense_ffn(d_ff, n_tok, sp_here):
        if d_ff % m == 0:
            gather_seq(d, n_tok, sp_here)
            reduce_out(n_tok, sp_here)

    kv_cut = ()
    if mode in ("chunk", "decode"):
        kv_cut = tf.kv_layout(mesh, batch, cache_len or 2 ** 20)[0]

    def attention(mix, layer_mode, n_tok, sp_here, mem_len):
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        cut_q = h % m == 0
        mla = cfg.mla is not None and mix in ("attn", "dec")
        if mix in ("attn", "dec"):
            if layer_mode in ("prefill", "train", "encode"):
                own = not cut_q and sp_here
                if mla:
                    gather_seq(d, n_tok, sp_here) if (sp_here or cut_q) \
                        else None
                else:
                    if cut_q or own:
                        gather_seq(d, n_tok, sp_here)
                    if layer_mode == "prefill" and cut_q and kh % m == 0:
                        heads(kh, n_tok, hd)
                        heads(kh, n_tok, hd)
                if cut_q:
                    reduce_out(n_tok, sp_here)
            elif layer_mode == "chunk":
                gather_seq(d, n_tok, sp_here)
                if cut_q:
                    heads(h, n_tok, hd)
                    if kh % m == 0:
                        heads(kh, n_tok, hd)
                        heads(kh, n_tok, hd)
                combine(kv_cut, n_tok, hd)
                if cut_q:
                    reduce_out(n_tok, sp_here)
            else:                                       # decode
                if mla:
                    ml = cfg.mla
                    if cut_q:
                        heads(h, 1, ml.kv_lora_rank)
                        heads(h, 1, ml.qk_rope_head_dim)
                    combine(kv_cut, 1, ml.kv_lora_rank)
                else:
                    if cut_q:
                        heads(h, 1, hd)
                        if kh % m == 0:
                            heads(kh, 1, hd)
                            heads(kh, 1, hd)
                    combine(kv_cut, 1, hd)
                if cut_q:
                    reduce_out(1, False)
        if mix in ("cross", "dec"):
            if layer_mode == "decode":
                if cut_q:
                    reduce_out(1, False)
            else:
                if cut_q:
                    gather_seq(d, n_tok, sp_here)
                    reduce_out(n_tok, sp_here)

    def ssm(layer_mode, n_tok, sp_here):
        s_cfg = cfg.ssm or SSMConfig()
        d_in = s_cfg.expand * d
        width = s_cfg.resolved_dt_rank(d) + 2 * s_cfg.d_state
        if d_in % m:
            if sp_here and m > 1:
                fwd.add("tp_all_gather", bl * (n_tok // m) * d * it)
                bwd.add("tp_reduce_scatter_grad", bl * n_tok * d * it)
            return
        if m > 1:
            w_local = d * (2 * d_in // m) * it
            fwd.add("tp_weight_all_gather", w_local)
            bwd.add("tp_weight_reduce_scatter", w_local * m)
        if layer_mode != "decode":
            gather_seq(d, n_tok, sp_here)
        if m > 1:
            fwd.add("tp_all_reduce", bl * n_tok * width * it)
            if train:
                bwd.add("tp_all_reduce_grad", bl * n_tok * width * 4)
        reduce_out(n_tok, sp_here and layer_mode != "decode")

    moe_ledger = FlopByteLedger(cfg, ep=m) if cfg.moe is not None else None
    groups = rows if batch % mesh.size(ROWS) == 0 else 1

    def moe(layer_mode, n_tok, sp_here):
        e = cfg.moe
        s_all = e.num_experts if n_slots is None else int(n_slots)
        decode = layer_mode == "decode"
        fwd.merge(moe_ledger.predict_layout_moe_census(
            mesh, bl if decode else bl * (n_tok // m), itemsize=it,
            groups=groups, n_slots=s_all, decode=decode))
        if train and data > 1 and d % data == 0:
            bwd.add("fsdp_reduce_scatter",
                    3 * (s_all // m) * d * e.d_ff * it, 3)
        if train and m > 1:
            cap_raw = math.ceil(bl * (n_tok // m) * e.top_k / m
                                * float(e.capacity_factor))
            cap = max(8, -(-cap_raw // 8) * 8)
            bwd.add("all_to_all_grad", 2 * m * cap * d * it, 2)
        if e.n_shared_experts:
            dense_ffn(e.d_ff * e.n_shared_experts, n_tok, sp_here)

    def layer(mix, ffn, layer_mode, n_tok, sp_here, mem_len):
        weights(tf.layer_spec(cfg, mix, ffn), sp_here)
        if mix == "ssm":
            ssm(layer_mode, n_tok, sp_here)
        else:
            attention(mix, layer_mode, n_tok, sp_here, mem_len)
        if ffn == "dense" and (cfg.d_ff or (cfg.moe and cfg.moe.d_ff)):
            dense_ffn(cfg.d_ff or cfg.moe.d_ff, n_tok, sp_here)
        elif ffn == "moe":
            moe(layer_mode, n_tok, sp_here)

    passes = 2 if train and cfg.remat == "full" else 1
    layer_mode = "train" if train else mode
    # the encoder
    if cfg.is_encdec and mode in ("prefill", "train"):
        t = cfg.enc_seq_len
        sp_e = t % m == 0
        enc = _Tally()
        saved = fwd
        fwd = enc
        for _ in range(cfg.n_enc_layers):
            layer("attn", "dense", "encode", t, sp_e, 0)
        fwd = saved
        fwd.merge(enc.kinds, passes)
        weights({"enc_norm": spec["enc_norm"]}, sp_e)
        if m > 1:
            if sp_e:
                fwd.add("tp_all_gather", bl * (t // m) * d * it)
                bwd.add("tp_reduce_scatter_grad", bl * t * d * it)
            elif train:
                bwd.add("tp_all_reduce_grad", bl * t * d * 4)
    # the embedding
    weights({"embed": spec["embed"]}, sp)
    if v % m == 0:
        reduce_out(s, sp)
    # the layers
    blocks, n_blocks, n_prefix = tf.block_structure(cfg)
    kinds = cfg.layer_kinds()
    mem = tf.memory_len(cfg)
    for i in range(n_prefix):
        layer(kinds[i], "dense", layer_mode, s, sp, mem)
    block, block_bwd = _Tally(), _Tally()
    saved = (fwd, bwd)
    fwd, bwd = block, block_bwd
    for mix, ffn in blocks:
        layer(mix, ffn, layer_mode, s, sp, mem)
    fwd, bwd = saved
    fwd.merge(block.kinds, n_blocks * passes)
    bwd.merge(block_bwd.kinds, n_blocks)
    # the head
    names = ("final_norm", "embed" if cfg.tie_embeddings else "unembed")
    weights({k: spec[k] for k in names}, sp)
    if not train:
        if sp and mode != "decode" and m > 1:
            fwd.add("last_row_all_gather", bl * d * it)
        if v % m == 0 and m > 1:
            fwd.add("logits_all_gather", bl * (v // m) * 4)
        if rows > 1:
            fwd.add("logits_all_gather", bl * v * 4)
        return dict(sorted(fwd.kinds.items()))
    if v % m == 0:
        gather_seq(d, s, sp)
        if m > 1:
            fwd.add("tp_max_all_reduce", bl * s * 4)
            fwd.add("tp_all_reduce", 2 * bl * s * 4, 2)
        axes = ROWS
    else:
        axes = ROWS + ("model",)
    if mesh.size(axes) > 1:
        tag = "_".join(mesh._axes(axes))
        fwd.add(f"psum_{tag}", 8, 2)
        fwd.add(f"all_reduce_{tag}", 8)
    # the data-parallel gradient buckets, by the batch axes a leaf's cut
    # leaves (models.layout / optim.grad_utils)
    groups_of: Dict[tuple, list] = {}

    def grads(tree, lead=()):
        for k, p in sorted(tree.items()):
            if isinstance(p, dict):
                grads(p, lead + ((n_blocks,) if k == "blocks" else
                                 (cfg.n_enc_layers,) if k == "enc_blocks"
                                 else ()))
                continue
            c = cut(p)
            used = {a for x in c for a in x}
            ax = tuple(a for a in ROWS if mesh.size(a) > 1
                       and a not in used)
            if not ax:
                continue
            local = tuple(n // (mesh.size(a) if a else 1)
                          for n, a in zip(p.shape, c))
            groups_of.setdefault(ax, []).extend(
                x.numel() for x in row_chunks(torch.empty(
                    lead + local, device="meta"), BUCKET_ELEMS))
    grads(spec)
    for ax, sizes in groups_of.items():
        fwd.add("grad_all_reduce", 4 * sum(sizes), len(buckets(sizes)))
    if mesh.size(None) > 1:
        fwd.add("norm_all_gather", 4)
        fwd.add("agree_all_reduce", 4)
    fwd.merge(bwd.kinds, 1)
    return dict(sorted(fwd.kinds.items()))
