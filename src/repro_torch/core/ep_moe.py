"""Expert-parallel MoE layer with ReaLB load balancing: the local path.

Counterpart of ``repro.core.ep_moe`` on one physical rank.  The ReaLB
policy statistics run over a *virtual* EP topology (``m_state [1, vep]``):
per-virtual-rank placed loads drive the policy and its AIMD state, and one
hot virtual rank quantizes every local expert (``use_fp4 = any(dec.use_fp4)``).

Two paths, as in the reference:

* ``dispatch`` (prefill): route, policy, conditional BF16→NVFP4 weight
  quantization (``kernels.ops.quantize_experts_fp4``), capacity-packed
  dispatch (under ReaLB-seq, ``overlap=False``, the quantization runs after
  the dispatch, with the reference's data dependency on it), grouped expert FFN (``kernels.ops.grouped_ffn`` with the BF16
  weights, or the fused W4A4 ``kernels.ops.grouped_fp4_ffn``),
  gate-weighted combine.
* ``broadcast`` (decode): every expert on every token (dense per-expert
  products in BF16, the grouped W4A4 kernel in FP4), combine by one-hot
  gates.

The BF16-or-FP4 decision stays on the device, as the reference's in-graph
``lax.cond`` keeps it: ``_use_fp4`` gives a 0-dim tensor ``f``, the
quantizer runs under ``f`` as a device predicate, the FP4 expert FFN runs
with slot counts ``gs·f`` and the BF16 one with ``gs·(1-f)`` (a kernel with
all-zero counts exits at once), and ``torch.where(f, ·, ·)`` returns the
chosen branch bit for bit.  Neither path reads a tensor on the host.  On
the CPU the same code runs the plain versions: the quantizer branches on
``f`` (a CPU tensor, free to read there) and the FFN with zero counts
computes nothing.

Differences forced by eager PyTorch:

* JAX drops out-of-bounds scatter writes and fills out-of-bounds gathers;
  torch raises.  Every such index (the ``big`` capacity-dropped slot) is
  written into a few spare rows past the buffer instead.
* ``jax.lax.top_k`` breaks ties toward the lower index; so does a stable
  descending sort, which replaces it.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig, ReaLBConfig
from repro_torch.core import quant
from repro_torch.core.policy import realb_policy
from repro_torch.kernels import ops as kops

F32 = torch.float32
AUX_SCALARS = ("lb_loss", "z_loss", "drop_frac", "ib_global", "fp4_ranks",
               "gate_open", "split_frac")


# --------------------------------------------------------------------------
# expert placement / replication tables
# --------------------------------------------------------------------------
class Placement(NamedTuple):
    """Logical-expert → (rank, slot) bijection: ``e2r [E]``, ``local_slot [E]``."""
    e2r: torch.Tensor
    local_slot: torch.Tensor


class Replication(NamedTuple):
    """Logical-expert → replica slots: ``rep_pos [E, R]`` (entries past
    ``n_rep[e]`` repeat the primary), ``n_rep [E]``, ``slot_owner [S]``
    (``-1`` = empty spare slot)."""
    rep_pos: torch.Tensor
    n_rep: torch.Tensor
    slot_owner: torch.Tensor


class WeightedReplication(NamedTuple):
    """:class:`Replication` plus a weighted-split schedule:
    ``split_sched [E, Q]`` sends the ``occ``-th routed token of expert
    ``e`` to replica ``split_sched[e, occ % Q]`` (host-built deficit
    round-robin over residual-capacity weights; the plain 3-field
    ``Replication`` keeps the equal-share ``occ % n_rep`` split)."""
    rep_pos: torch.Tensor
    n_rep: torch.Tensor
    slot_owner: torch.Tensor
    split_sched: torch.Tensor


def identity_placement(num_experts: int, n_ranks: int,
                       device=None) -> Placement:
    """The contiguous mapping (expert ``e`` on rank ``e // e_loc``)."""
    ar = torch.arange(num_experts, dtype=torch.int32, device=device)
    e_loc = num_experts // n_ranks
    return Placement(ar // e_loc, ar % e_loc)


def identity_replication(num_experts: int, n_ranks: int,
                         device=None) -> Replication:
    """One replica per expert, no spare slots ≡ the identity placement."""
    ar = torch.arange(num_experts, dtype=torch.int32, device=device)
    return Replication(ar[:, None], torch.ones_like(ar), ar)


def _as_replication(placement, num_experts: int, pol_ep: int,
                    device) -> Replication:
    """None (identity), a ``Placement``/2-tuple, or a ``Replication``/3- or
    4-tuple (the 4th entry is the weighted-split schedule)."""
    if placement is None:
        return identity_replication(num_experts, pol_ep, device)
    if isinstance(placement, (Replication, WeightedReplication)):
        return placement
    entries = tuple(placement)
    if len(entries) == 4:
        return WeightedReplication(*entries)
    if len(entries) == 3:
        return Replication(*entries)
    if len(entries) != 2:
        raise ValueError(f"placement with {len(entries)} entries")
    place = Placement(*entries)
    e_loc = num_experts // pol_ep
    pos_e = place.e2r.to(torch.int32) * e_loc + place.local_slot.to(torch.int32)
    inv = torch.zeros((num_experts,), dtype=torch.int32, device=pos_e.device)
    inv[pos_e.long()] = torch.arange(num_experts, dtype=torch.int32,
                                     device=pos_e.device)
    return Replication(pos_e[:, None],
                       torch.ones((num_experts,), dtype=torch.int32,
                                  device=pos_e.device), inv)


def _bincount(idx: torch.Tensor, weights: Optional[torch.Tensor],
              length: int) -> torch.Tensor:
    """``jnp.bincount(idx, weights, length)`` for indices in [0, length);
    weights are 0/1 counts, so the f32 sums are exact in any order."""
    w = torch.ones(idx.shape, dtype=F32, device=idx.device) \
        if weights is None else weights.to(F32)
    return torch.zeros((length,), dtype=F32, device=idx.device) \
        .index_add_(0, idx.long(), w)


def _occurrence_index(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[n] per-assignment rank among same-expert assignments (original
    order).  Entries equal to ``num_experts`` count only among themselves."""
    n = flat_e.shape[0]
    ord_e = torch.sort(flat_e, stable=True).indices
    counts = _bincount(flat_e, None, num_experts + 1).to(torch.int32)
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    occ_sorted = torch.arange(n, dtype=torch.int32, device=flat_e.device) \
        - offs[flat_e[ord_e].long()]
    occ = torch.zeros((n,), dtype=torch.int32, device=flat_e.device)
    occ[ord_e] = occ_sorted
    return occ


def _split_assignments(rep: Replication, flat_e: torch.Tensor,
                       valid_flat: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat_pos [n], is_secondary [n]): the physical slot of each routed
    assignment, round-robin over the expert's replicas, or by the
    weighted-split schedule when there is one (valid assignments only;
    padding pins to the primary)."""
    fe = flat_e.long()
    if rep.rep_pos.shape[1] == 1:      # bijective: skip the counter
        return rep.rep_pos[:, 0][fe], torch.zeros(flat_e.shape,
                                                  dtype=torch.bool,
                                                  device=flat_e.device)
    e = rep.rep_pos.shape[0]
    occ = _occurrence_index(torch.where(valid_flat, flat_e,
                                        torch.full_like(flat_e, e)), e)
    sched = getattr(rep, "split_sched", None)
    if sched is not None:
        q = sched.shape[1]
        ridx = torch.where(valid_flat, sched[fe, (occ % q).long()], 0)
    else:
        ridx = torch.where(valid_flat, occ % rep.n_rep[fe], 0)
    return rep.rep_pos[fe, ridx.long()], ridx > 0


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, x_t: torch.Tensor, e_cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """returns (gates [t,K] f32, eidx [t,K] i32, probs [t,E] f32)."""
    logits = x_t.to(F32) @ router_w.to(F32)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(probs, e_cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx.to(torch.int32), probs


def _aux_losses(probs: torch.Tensor, counts_global: torch.Tensor,
                group_tokens: torch.Tensor, e_cfg: MoEConfig
                ) -> Dict[str, torch.Tensor]:
    """GShard-style load-balance + router z losses."""
    e = e_cfg.num_experts
    f = counts_global / torch.clamp(group_tokens * e_cfg.top_k, min=1.0)
    p_mean = probs.sum(0) / torch.clamp(group_tokens, min=1.0)
    lb = e * torch.sum(f * p_mean)
    lse = torch.logsumexp(torch.log(torch.clamp(probs, min=1e-20)), dim=-1)
    z = torch.sum(lse ** 2) / torch.clamp(group_tokens, min=1.0)
    return {"lb_loss": lb, "z_loss": z}


# --------------------------------------------------------------------------
# grouped expert compute (bf16 / fp4 branches)
# --------------------------------------------------------------------------
def _quantize_experts(w: Dict[str, torch.Tensor], rcfg: ReaLBConfig,
                      fi: torch.Tensor,
                      overlap_token: Optional[torch.Tensor] = None
                      ) -> Dict[str, quant.QTensor]:
    """③ on-the-fly BF16→FP4 transformation of the resident expert weights,
    under the device predicate ``fi`` (int32; nothing is computed when it
    is 0).  ``overlap_token`` (ReaLB-seq) is the reference's data
    dependency on the dispatch output, added to every ``[G,N,K]`` view
    before its global scale and quantizer: +0.0 turns a -0.0 weight into
    +0.0 (a packed code's sign bit), NaN when the dispatched tokens hold an
    inf.  The add is one more pass over the weights, made whatever ``fi``."""
    out = {}
    for name, wt in w.items():
        wt_t = wt.transpose(-1, -2)
        if overlap_token is not None:
            wt_t = wt_t + overlap_token.to(wt_t.dtype)
        out[name] = kops.quantize_experts_fp4(wt_t, group=rcfg.group_size,
                                              pred=fi)
    return out


def _use_fp4(dec_use_fp4: torch.Tensor, ep: int, pol_ep: int
             ) -> torch.Tensor:
    """The FP4 decision as a 0-dim bool tensor on the device: on one
    physical rank with a virtual policy topology, any FP4 rank switches
    every local expert."""
    return dec_use_fp4[0] if ep == pol_ep else dec_use_fp4.any()


def _expert_ffns(xs, gs, w, wq, f, fi, rcfg):
    """Both expert-FFN branches over slot-sorted rows ``xs`` with counts
    ``gs``, each with its counts masked by the decision ``f`` (``fi`` as
    int32), and the chosen one's output (the reference's ``lax.cond``)."""
    y_fp4 = kops.grouped_fp4_ffn(xs, gs * fi, wq, group=rcfg.group_size)
    y_bf16 = kops.grouped_ffn(xs, gs * (1 - fi), w)
    return torch.where(f, y_fp4, y_bf16)


def _per_assignment(v: torch.Tensor, k: int) -> torch.Tensor:
    """[t] → [t·k], each entry repeated k times (``repeat_interleave``
    without its host read of the output size)."""
    return v[:, None].expand(v.shape[0], k).reshape(-1)


def _route_stats(p, x_t, mod_t, val_t, m_vec, cfg, rcfg, rep, pol_ep):
    """Routing, post-split loads and the policy decision (shared by both
    paths)."""
    e_cfg = cfg.moe
    e = e_cfg.num_experts
    n_slots = rep.slot_owner.shape[0]
    s_pol = n_slots // pol_ep
    t = x_t.shape[0]
    k = e_cfg.top_k
    gates, eidx, probs = _route(p["router"], x_t, e_cfg)
    flat_e = eidx.reshape(t * k)
    val_flat = _per_assignment(val_t.to(torch.bool), k)
    flat_p, secondary = _split_assignments(rep, flat_e, val_flat)
    w_val = _per_assignment(val_t.to(F32), k)
    w_vis = _per_assignment(
        (mod_t.to(torch.bool) & val_t.to(torch.bool)).to(F32), k)
    counts = _bincount(flat_e, w_val, e)
    vis = _bincount(flat_e, w_vis, e)
    slot_load = _bincount(flat_p, w_val, n_slots)
    slot_vis = _bincount(flat_p, w_vis, n_slots)
    load_d = slot_load.reshape(pol_ep, s_pol).sum(-1)
    vis_d = slot_vis.reshape(pol_ep, s_pol).sum(-1)
    split = torch.sum(secondary.to(F32) * w_val)
    dec = realb_policy(load_d, vis_d, m_vec, rcfg)
    return dict(gates=gates, probs=probs, flat_p=flat_p, val_flat=val_flat,
                w_val=w_val, counts=counts, vis=vis, slot_load=slot_load,
                slot_vis=slot_vis, load_d=load_d, vis_d=vis_d, split=split,
                dec=dec)


def _aux(r, drop_frac, k, e_cfg):
    dec = r["dec"]
    total = r["load_d"].sum()
    # the reference's total / k, as XLA compiles it (f32 reciprocal)
    group_tokens = total * float(np.float32(1.0) / np.float32(max(k, 1)))
    aux = _aux_losses(r["probs"], r["counts"], group_tokens, e_cfg)
    aux.update(drop_frac=drop_frac, ib_global=dec.ib_global,
               fp4_ranks=dec.use_fp4.to(F32).sum(),
               load_d=r["load_d"], vis_d=r["vis_d"],
               expert_load=r["counts"], expert_vis=r["vis"],
               slot_load=r["slot_load"], slot_vis=r["slot_vis"],
               split_frac=r["split"] / torch.clamp(total, min=1.0),
               gate_open=dec.gate_open.to(F32))
    return aux


# --------------------------------------------------------------------------
# dispatch path (prefill)
# --------------------------------------------------------------------------
def _moe_dispatch(x_t, mod_t, val_t, p, m_vec, cfg, rcfg, rep, pol_ep):
    """x_t [t,D] tokens; mod_t [t] vision flags; val_t [t] real-token flags;
    m_vec [pol_ep] AIMD state; rep maps logical experts onto slots."""
    e_cfg = cfg.moe
    ep = 1
    n_slots = rep.slot_owner.shape[0]
    s_loc = n_slots // ep
    t, d = x_t.shape
    k = e_cfg.top_k
    dev = x_t.device

    # ① routing + metadata, ② policy
    r = _route_stats(p, x_t, mod_t, val_t, m_vec, cfg, rcfg, rep, pol_ep)
    f = _use_fp4(r["dec"].use_fp4, ep, pol_ep)
    fi = f.to(torch.int32)
    w = {n: p[n] for n in ("w_gate", "w_up", "w_down")}

    # ③ conditional on-the-fly quantization, before dispatch (ReaLB); under
    # ReaLB-seq (overlap=False) after it, below
    wq = _quantize_experts(w, rcfg, fi) if rcfg.overlap else None

    # dispatch: valid assignments first, capacity-packed; padding and
    # over-capacity assignments get the out-of-range slot `big`
    flat_p, val_flat = r["flat_p"], r["val_flat"]
    dest = torch.div(flat_p, s_loc, rounding_mode="floor")
    order = torch.sort(torch.where(val_flat, dest, torch.full_like(dest, ep)),
                       stable=True).indices
    dest_s = dest[order]
    valid_s = val_flat[order]
    send_counts = r["slot_load"].reshape(ep, s_loc).sum(-1).to(torch.int32)
    offsets = torch.cumsum(send_counts, 0, dtype=torch.int32) - send_counts
    pos_in_rank = torch.arange(t * k, dtype=torch.int32, device=dev) \
        - offsets[dest_s.long()]
    cap = max(8, -(-math.ceil(t * k / ep * e_cfg.capacity_factor) // 8) * 8)
    big = ep * cap + 7                   # out of range -> dropped
    slot_s = torch.where(valid_s & (pos_in_rank < cap),
                         dest_s * cap + pos_in_rank,
                         torch.full_like(pos_in_rank, big)).long()
    tok_idx_s = torch.div(order, k, rounding_mode="floor")
    leid_s = (flat_p % s_loc)[order].to(torch.int32)
    # rows past ep*cap are spare: dropped writes land there
    send = torch.zeros((ep * cap + 8, d), dtype=x_t.dtype, device=dev)
    send[slot_s] = x_t[tok_idx_s]
    eid_send = torch.full((ep * cap + 8,), s_loc, dtype=torch.int32,
                          device=dev)
    eid_send[slot_s] = leid_s
    recv, eid_recv = send[:ep * cap], eid_send[:ep * cap]
    slot_flat = torch.empty((t * k,), dtype=torch.long, device=dev)
    slot_flat[order] = slot_s
    if wq is None:      # ReaLB-seq: serialise ③ after dispatch
        token = (recv.sum() * 0.0).to(F32)
        wq = _quantize_experts(w, rcfg, fi, token)

    # ④ local expert compute; slot s_loc is the pad slot of unfilled
    # capacity rows (zeros), which has no weights: its rows give 0, as the
    # reference's zero rows through slot 0's weights do
    order2 = torch.sort(eid_recv, stable=True).indices
    xs = recv[order2]
    gs = _bincount(eid_recv, None, s_loc + 1).to(torch.int32)
    ys = _expert_ffns(xs, gs, w, wq, f, fi, rcfg)
    y_buf = torch.zeros((ep * cap + 8, d), dtype=ys.dtype, device=dev)
    y_buf[order2] = ys

    # combine: `big` reads a spare zero row
    y_flat = y_buf[slot_flat]
    y_flat = torch.where((slot_flat < big)[:, None], y_flat,
                         torch.zeros((), dtype=y_flat.dtype, device=dev))
    out = torch.sum(y_flat.reshape(t, k, d)
                    * r["gates"][..., None].to(y_flat.dtype), dim=1)

    total = r["load_d"].sum()
    dropped = torch.sum((slot_flat >= big).to(F32) * r["w_val"])
    aux = _aux(r, dropped / torch.clamp(total, min=1.0), k, e_cfg)
    return out.to(x_t.dtype), r["dec"].m_new, aux


# --------------------------------------------------------------------------
# broadcast path (decode)
# --------------------------------------------------------------------------
def _moe_broadcast(x_t, mod_t, val_t, p, m_vec, cfg, rcfg, rep, pol_ep):
    """Decode-regime MoE: every local expert on every token, then combine."""
    e_cfg = cfg.moe
    ep = 1
    n_slots = rep.slot_owner.shape[0]
    s_loc = n_slots // ep
    t = x_t.shape[0]
    k = e_cfg.top_k
    dt = x_t.dtype

    r = _route_stats(p, x_t, mod_t, val_t, m_vec, cfg, rcfg, rep, pol_ep)
    f = _use_fp4(r["dec"].use_fp4, ep, pol_ep)
    fi = f.to(torch.int32)
    w = {n: p[n] for n in ("w_gate", "w_up", "w_down")}

    # BF16: dense per-expert products
    g = torch.matmul(x_t, w["w_gate"].to(dt))                 # [E,t,F]
    u = torch.matmul(x_t, w["w_up"].to(dt))
    h = F.silu(g.to(F32)).to(dt) * u
    y_bf16 = torch.matmul(h, w["w_down"].to(dt))             # [E,t,D]
    # FP4: the grouped W4A4 kernel over x_t once per local slot (the
    # reference's decode FP4 recipe is the grouped kernel's), its counts
    # masked by the decision
    wq = _quantize_experts(w, rcfg, fi)
    xs = x_t.repeat(s_loc, 1)                                 # [E·t,D]
    gs = torch.full((s_loc,), t, dtype=torch.int32, device=x_t.device) * fi
    y_fp4 = kops.grouped_fp4_ffn(xs, gs, wq, group=rcfg.group_size)
    y_e = torch.where(f, y_fp4.reshape(s_loc, t, -1), y_bf16)

    pidx = r["flat_p"].reshape(t, k)                          # [t,K] placed
    leid = pidx % s_loc
    local_gate = r["gates"]                 # one physical rank: all local
    onehot = (leid[..., None] == torch.arange(
        s_loc, device=leid.device)).to(dt)                    # [t,K,s_loc]
    weight_e = torch.einsum("tk,tke->te", local_gate.to(dt), onehot)
    out = torch.einsum("te,etd->td", weight_e, y_e)

    aux = _aux(r, torch.zeros((), dtype=F32, device=x_t.device), k, e_cfg)
    return out.to(dt), r["dec"].m_new, aux


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------
def ep_moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, rcfg: ReaLBConfig,
                   m_state: torch.Tensor,
                   modality: Optional[torch.Tensor] = None,
                   mode: str = "dispatch",
                   valid: Optional[torch.Tensor] = None,
                   placement=None):
    """MoE layer with ReaLB on one physical rank.  x [B,S,D]; m_state
    [1, vep] (the policy's virtual EP topology); valid [B,S] marks real
    tokens (None = all).  ``placement``: None (identity), a
    :class:`Placement`, or a :class:`Replication` with weights ``p`` stored
    in the matching slot order.  Returns (y, new_m_state, aux_dict)."""
    if modality is None:
        modality = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    if valid is None:
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    pol_ep = int(m_state.shape[-1]) if m_state.dim() else 1
    if cfg.moe.num_experts % pol_ep:
        raise ValueError(f"{cfg.moe.num_experts} experts over {pol_ep} ranks")
    rep = _as_replication(placement, cfg.moe.num_experts, pol_ep, x.device)
    if rep.slot_owner.shape[0] % pol_ep:
        raise ValueError(f"{rep.slot_owner.shape[0]} slots over {pol_ep} ranks")
    b, s, d = x.shape
    if cfg.activation != "swiglu":
        raise NotImplementedError("the expert FFN kernels are SwiGLU only")
    args = (x.reshape(b * s, d), modality.reshape(b * s),
            valid.reshape(b * s), p, m_state.reshape(-1), cfg, rcfg, rep,
            pol_ep)
    if mode == "broadcast":
        y, m_new, aux = _moe_broadcast(*args)
    else:
        y, m_new, aux = _moe_dispatch(*args)
    return y.reshape(b, s, d), m_new.reshape(m_state.shape), aux


def moe_state_shape(virtual_ep: Optional[int] = None) -> Tuple[int, int]:
    """AIMD M-state shape [1, vep] on one device with a virtual EP topology."""
    return (1, int(virtual_ep) if virtual_ep else 1)
