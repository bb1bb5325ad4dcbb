"""Batched serving engine of the port: chunked token-budgeted prefill,
one-shot prefill and batched decode with ReaLB active.

Counterpart of ``repro.serving.engine.Engine`` on one device, without the
placement/replication managers, migration, elastic serving, tracer,
profiler and sentinel (their ``None`` defaults bypass them in the
reference too).  The engine holds one device-resident KV cache of
``max_slots`` sequences.  Each iteration packs up to ``prefill_budget``
prompt tokens across every slot with pending prefill work into one
``[max_slots, bucket]`` chunk forward, then runs one batched decode step
over the decode-ready slots.  A request that carries ``vision_embeds``, or
every request when ``prefill_budget=0``, is prefilled whole in a batch-1
``prefill_forward`` at admission and its cache copied into its slot.  The
AIMD ``m_state`` of ReaLB persists across iterations; per-iteration routing
stats are kept in ``self.stats`` and fed, with every finished request, to
an optional :class:`~repro_torch.serving.telemetry.Telemetry`.
``virtual_ep`` sizes the policy's virtual EP topology.  ``temperature > 0``
samples from ``softmax(logits / temperature)`` on the device with a
``torch.Generator`` seeded by ``seed`` (JAX's PRNG draws are not
reproduced); 0 is greedy.  ``save_checkpoint``/``load_checkpoint`` write
and read the reference's format.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, ReaLBConfig
from repro_torch.core import ep_moe
from repro_torch.core.policy import init_m_state
from repro_torch.models import transformer as tf
from repro_torch.models.common import DTYPES, resolve_device
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.telemetry import Telemetry


@dataclasses.dataclass
class IterStats:
    """Per-iteration routing/balance diagnostics (benchmark input)."""
    n_active: int
    tokens: int                  # real (non-padding) tokens this iteration
    ib_global: float
    fp4_ranks: float
    gate_open: float
    phase: str = "decode"        # "prefill" | "decode"
    t_wall: float = 0.0          # engine clock at record time
    batch_tokens: int = 0        # tokens the MoE actually saw (incl. pad)
    vis_frac: float = 0.0        # vision fraction of routed assignments
    drop_frac: float = 0.0       # capacity-dropped fraction of routed tokens
    migration_bytes: int = 0     # expert weight bytes moved before this
    #                              iter (0: migration is not ported)
    migration_s: float = 0.0     # migration seconds that stalled serving
    migration_hidden_s: float = 0.0  # transfer seconds hidden under the
    #                              iteration's forward
    split_frac: float = 0.0      # routed fraction served by a non-primary
    #                              replica (0 under a bijective table)
    n_unroutable: int = 0        # logical experts with no live replica
    #                              (0: elastic serving is not ported)
    lost_tokens: float = 0.0     # tokens routed to an unroutable expert


def _bucket(n: int, lo: int = 8) -> int:
    """Round a chunk length up to a power of two (the reference's jit
    buckets: the same padded shapes, so the same routing statistics)."""
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(self, cfg: ModelConfig, params, rcfg: ReaLBConfig,
                 max_slots: int = 8, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_budget: int = 256, text_reserve: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry: Optional[Telemetry] = None,
                 cost_model=None, virtual_ep: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.params, self.rcfg = cfg, params, rcfg
        self.max_slots, self.max_len = max_slots, max_len
        self.temperature = temperature
        self.prefill_budget = prefill_budget
        # chunk continuation needs a plain GQA/MQA decoder stack
        self.chunked = (prefill_budget > 0 and cfg.layer_pattern == "attn"
                        and cfg.family != "vlm")
        self.scheduler = Scheduler(max_slots, text_reserve=text_reserve)
        self.clock = clock
        self.telemetry = telemetry
        # virtual-time mode: an object with .cost(batch_tokens) -> seconds,
        # paired with a clock exposing .advance(dt), advanced right after
        # each forward, before first-token/finish timestamps are stamped
        self.cost_model = cost_model
        self._it = 0
        self.cache = tf.init_cache(cfg, max_slots, max_len, self.device)
        self.m_state = init_m_state(*ep_moe.moe_state_shape(virtual_ep),
                                    rcfg, device=self.device)
        self.pos = np.zeros(max_slots, np.int32)      # next write position
        self.last_tok = np.zeros(max_slots, np.int32)
        self.active_mask = np.zeros(max_slots, bool)
        self.decode_ready = np.zeros(max_slots, bool)
        self.mod_state = np.zeros(max_slots, bool)    # decode-token modality
        self._prefill_fifo: List[int] = []            # slots mid-prefill
        # aux scalars come back summed over the layers; normalize to
        # per-MoE-layer means so duty cycles / IB read as true fractions
        self._n_moe = max(sum(1 for f in cfg.ffn_kinds() if f == "moe"), 1)
        self.stats: List[IterStats] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request):
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(f"request needs {req.prompt_len} + "
                             f"{req.max_new_tokens} > max_len {self.max_len}")
        if req.arrival_time is None:
            req.arrival_time = self.clock()
        self.scheduler.submit(req)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """The next token of every row, drawn on the device; pulling it is
        the one host read that serving requires."""
        return sample_tokens(logits, self.temperature, self._gen) \
            .to(torch.int32).cpu().numpy()

    def _tick(self, batch_tokens: int):
        """Advance a virtual clock by the modeled cost of one forward."""
        if self.cost_model is not None and hasattr(self.clock, "advance"):
            self.clock.advance(self.cost_model.cost(batch_tokens))

    def _record(self, *, phase: str, n_active: int, tokens: int,
                batch_tokens: int, aux: Dict[str, Any]):
        ms = aux["moe_stats"].to(torch.float64).cpu().numpy()
        scal = torch.stack([aux[k].to(torch.float32) for k in
                            ("ib_global", "fp4_ranks", "gate_open",
                             "drop_frac", "split_frac")]).cpu().tolist()
        load_sum, vis_sum = float(ms[:, 0].sum()), float(ms[:, 1].sum())
        self.stats.append(IterStats(
            n_active=n_active, tokens=tokens,
            ib_global=scal[0] / self._n_moe,
            fp4_ranks=scal[1] / self._n_moe,
            gate_open=scal[2] / self._n_moe,
            phase=phase, t_wall=self.clock(), batch_tokens=batch_tokens,
            vis_frac=vis_sum / max(load_sum, 1.0),
            drop_frac=scal[3] / self._n_moe,
            split_frac=scal[4] / self._n_moe))
        if self.telemetry is not None:
            self.telemetry.record_iter(self.stats[-1])

    def _finish(self, req: Request):
        req.finish_time = self.clock()
        if self.telemetry is not None:
            self.telemetry.record_request(req)

    def _first_token(self, req: Request, tok: int):
        req.generated.append(tok)
        req.first_token_time = self.clock()
        self.pos[req.slot] = req.prompt_len
        self.last_tok[req.slot] = tok
        self.decode_ready[req.slot] = True
        if req.done:
            self._finish(req)

    # -- prefill ---------------------------------------------------------------
    def _insert_cache(self, slot: int, new_cache):
        """Copy a batch-1 prefill cache into slot ``slot`` of the engine
        cache, in place.  Stacked block entries are [n_blocks, B, ...]
        (batch axis 1); prefix entries are [B, ...] (axis 0)."""
        for group, axis in (("blocks", 1), ("prefix", 0)):
            for name, kv in self.cache.get(group, {}).items():
                for n in ("k", "v"):
                    kv[n].narrow(axis, slot, 1).copy_(new_cache[group][name][n])

    def _prefill_oneshot(self, req: Request):
        """The whole prompt in one batch-1 forward, its cache copied into
        the request's slot (with its vision embeds, if any)."""
        batch = {"tokens": self._tensor(req.tokens, torch.int32)[None],
                 "modality": self._tensor(req.modality, torch.bool)[None]}
        if req.vision_embeds is not None:
            batch["vision_embeds"] = self._tensor(
                req.vision_embeds, DTYPES[self.cfg.param_dtype])[None]
        res = tf.prefill_forward(self.params, self.cfg, self.rcfg, batch,
                                 self.m_state, cache_len=self.max_len)
        self.m_state = res.m_state
        self._tick(req.prompt_len)
        self._insert_cache(req.slot, res.cache)
        req.prefill_pos = req.prompt_len
        self._first_token(req, int(self._sample(res.logits)[0]))
        self._record(phase="prefill", n_active=1, tokens=req.prompt_len,
                     batch_tokens=req.prompt_len, aux=res.aux)

    def _plan_chunks(self) -> List:
        """Allocate the token budget over slots with pending prefill work,
        oldest admission first; at most one partial chunk per iteration."""
        budget = self.prefill_budget
        plan = []
        for slot in self._prefill_fifo:
            if budget <= 0:
                break
            req = self.scheduler.active[slot]
            take = min(req.prompt_len - req.prefill_pos, budget)
            plan.append((slot, take))
            budget -= take
        return plan

    def _chunk_prefill_step(self) -> int:
        plan = self._plan_chunks()
        if not plan:
            return 0
        s_bucket = _bucket(max(take for _, take in plan))
        b = self.max_slots
        tokens = np.zeros((b, s_bucket), np.int32)
        modality = np.zeros((b, s_bucket), bool)
        start = np.zeros(b, np.int32)
        chunk_len = np.zeros(b, np.int32)
        for slot, take in plan:
            req = self.scheduler.active[slot]
            p0 = req.prefill_pos
            tokens[slot, :take] = req.tokens[p0:p0 + take]
            modality[slot, :take] = req.modality[p0:p0 + take]
            start[slot] = p0
            chunk_len[slot] = take
        batch = {"tokens": self._tensor(tokens), "start": self._tensor(start),
                 "chunk_len": self._tensor(chunk_len),
                 "modality": self._tensor(modality)}
        res = tf.chunk_forward(self.params, self.cfg, self.rcfg, batch,
                               self.cache, self.m_state)
        self.cache, self.m_state = res.cache, res.m_state
        self._tick(b * s_bucket)
        completing = [slot for slot, take in plan
                      if self.scheduler.active[slot].prefill_pos + take
                      >= self.scheduler.active[slot].prompt_len]
        toks = self._sample(res.logits) if completing else None
        n_tok = 0
        for slot, take in plan:
            req = self.scheduler.active[slot]
            req.prefill_pos += take
            n_tok += take
            if req.prefill_pos >= req.prompt_len:
                self._prefill_fifo.remove(slot)
                self._first_token(req, int(toks[slot]))
        self._record(phase="prefill", n_active=len(plan), tokens=n_tok,
                     batch_tokens=b * s_bucket, aux=res.aux)
        return n_tok

    # -- the iteration --------------------------------------------------------
    def step(self) -> int:
        """One continuous-batching iteration. Returns #active sequences."""
        self._it += 1
        # 0) purge slots freed by a mid-prefill retirement
        if self._prefill_fifo:
            self._prefill_fifo = [s for s in self._prefill_fifo
                                  if s in self.scheduler.active]
        # 1) admit new requests; route each to the chunked or one-shot path
        for req in self.scheduler.admit():
            self.active_mask[req.slot] = True
            self.decode_ready[req.slot] = False
            self.mod_state[req.slot] = req.decode_modality
            if self.chunked and req.vision_embeds is None:
                req.prefill_pos = 0
                self._prefill_fifo.append(req.slot)
            else:
                self._prefill_oneshot(req)

        # 2) one batched chunk of prefill work across all pending slots
        if self._prefill_fifo:
            self._chunk_prefill_step()

        self.scheduler.retire()
        for s in range(self.max_slots):
            self.active_mask[s] = s in self.scheduler.active
            if not self.active_mask[s]:
                self.decode_ready[s] = False
        if not self.scheduler.active:
            return 0

        # 3) batched decode over decode-ready slots (others run dummies whose
        # cache writes land out of range and are dropped)
        ready = self.decode_ready & self.active_mask
        n_active = 0
        if ready.any():
            batch = {
                "tokens": self._tensor(self.last_tok[:, None], torch.int32),
                "pos": self._tensor(np.where(ready, self.pos, self.max_len),
                                    torch.int32),
                "modality": self._tensor(
                    np.where(ready, self.mod_state, False)[:, None]),
                "valid": self._tensor(ready[:, None])}
            res = tf.decode_forward(self.params, self.cfg, self.rcfg, batch,
                                    self.cache, self.m_state)
            self.cache, self.m_state = res.cache, res.m_state
            self._tick(self.max_slots)
            toks = self._sample(res.logits)
            for slot, req in list(self.scheduler.active.items()):
                if ready[slot] and not req.done:
                    req.generated.append(int(toks[slot]))
                    self.last_tok[slot] = int(toks[slot])
                    self.pos[slot] += 1
                    n_active += 1
                    if req.done:
                        self._finish(req)
            self._record(phase="decode", n_active=n_active, tokens=n_active,
                         batch_tokens=self.max_slots, aux=res.aux)
        self.scheduler.retire()
        return max(n_active, len(self._prefill_fifo))

    def run(self, max_iters: int = 10_000) -> List[Request]:
        it = 0
        while not self.scheduler.idle and it < max_iters:
            self.step()
            it += 1
        return self.scheduler.finished

    # -- checkpointing --------------------------------------------------------
    def save_checkpoint(self, ckpt_dir: str, step: int, keep: int = 3) -> str:
        """Persist params and the AIMD state (group ``serving``), in the
        reference's format."""
        state = {"serving": {"params": self.params, "m_state": self.m_state}}
        return ckpt.save(ckpt_dir, step, state, keep=keep)

    def load_checkpoint(self, ckpt_dir: str,
                        step: Optional[int] = None) -> int:
        """Restore params and the AIMD state onto this engine's device.  A
        checkpoint written by an engine with a placement or replica manager
        holds its weights in that manager's physical order: refused, as the
        reference's manager-free engine refuses it."""
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        for name, kind in (("placement", "a placement engine"),
                           ("replication", "a replication engine")):
            if step is not None and ckpt.has_group(ckpt_dir, name, step):
                raise ValueError(
                    f"checkpoint {ckpt_dir} step {step} was written by "
                    f"{kind} (weights are in its placed physical order); "
                    "the port's engine has no placement or replica manager "
                    "to restore it")
        templates = {"serving": {"params": self.params,
                                 "m_state": self.m_state}}
        step, out = ckpt.restore(ckpt_dir, templates, step)
        self.params = out["serving"]["params"]
        self.m_state = out["serving"]["m_state"]
        return step


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One token per row of ``logits [B, V]``: the first maximum (as
    ``jnp.argmax``) when ``temperature <= 0``, else a draw from
    ``softmax(logits / temperature)`` by the Gumbel-max trick, as
    ``jax.random.categorical`` draws, with noise from ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                        dim=-1)
