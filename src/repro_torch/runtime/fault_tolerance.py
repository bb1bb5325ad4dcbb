"""Fault tolerance: the training loop's checkpoints, NaN guard and
preemption handling, and the scripted rank faults of elastic serving.

Counterpart of ``repro.runtime.fault_tolerance``.  :class:`TrainLoop`:

* periodic **async** checkpoints (a host snapshot now, the write on a
  thread),
* a **NaN/Inf guard**: a non-finite loss drops the step's update, and
  after ``nan_tolerance`` bad steps in a row the loop rolls back to the
  newest checkpoint,
* a **SIGTERM/SIGINT-safe** final save,
* a byte-exact **restart**: the data pipeline is a pure function of the
  step, so restoring step ``s`` resumes the same stream; ReaLB's AIMD state
  is part of the checkpoint.

The port's train step (``launch.steps.make_train_step``) updates its state
in place and writes nothing when the loss is not finite, so dropping its
returned state leaves the loop's state as it was before the step, as the
reference's pure step does.

On a mesh (``mesh=``; every rank runs the loop with its shard of the
state, in the FSDP layout training takes) the checkpoints are
written collectively and synchronously (``checkpoint.ckpt.save(mesh=)``:
the global layout, rank 0 writes), a preemption caught on any rank stops
every rank after the same step (the ranks agree on it after each step),
and :meth:`TrainLoop.restore_or_init` resumes every rank from the same
step (it raises if the ranks see different newest checkpoints).  The
loss a step reports is the global one, so the NaN guard decides alike on
every rank.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict

import numpy as np

from repro_torch.checkpoint import ckpt as ckpt_lib

Tree = Any


class FaultEvent:
    """One scripted rank fault: ``kind`` is 'fail' or 'rejoin'."""

    __slots__ = ("it", "kind", "rank")

    def __init__(self, it: int, kind: str, rank: int):
        assert kind in ("fail", "rejoin"), kind
        self.it, self.kind, self.rank = int(it), kind, int(rank)

    def __repr__(self):
        return f"FaultEvent(it={self.it}, kind={self.kind!r}, " \
               f"rank={self.rank})"


class FaultInjector:
    """Deterministic scripted rank-fault schedule for serving.

    The engine polls :meth:`due` once per iteration and dispatches the
    returned events to its elastic coordinator (``fail_rank`` /
    ``rejoin_rank``).  Events are (iteration, kind, rank) triples, e.g.
    ``FaultInjector([(40, "fail", 2), (90, "rejoin", 2)])``.
    """

    def __init__(self, events):
        evs = [e if isinstance(e, FaultEvent) else FaultEvent(*e)
               for e in events]
        self.events = sorted(evs, key=lambda e: e.it)
        self._i = 0

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self.events)

    def due(self, it: int):
        """Events scheduled at or before ``it`` that have not fired yet
        (each event fires exactly once, in schedule order)."""
        out = []
        while self._i < len(self.events) and self.events[self._i].it <= it:
            out.append(self.events[self._i])
            self._i += 1
        return out


class TrainLoop:
    def __init__(self, step_fn: Callable, *, ckpt_dir: str,
                 checkpoint_every: int = 100, keep: int = 3,
                 nan_tolerance: int = 3, log_every: int = 10,
                 logger: Callable[[str], None] = print, mesh=None,
                 spec=None):
        self.step_fn = step_fn
        # the model's declarations: in the tensor-parallel layout the
        # checkpoint gathers and cuts every leaf by them
        self.spec = spec
        self.mesh = mesh if mesh is not None and mesh.size(None) > 1 \
            else None
        self.keep = keep
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = checkpoint_every
        self.nan_tolerance = nan_tolerance
        self.log_every = log_every
        self.log = logger
        self.checkpointer = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep)
        self._stop = False

    def _install_signals(self):
        def handler(signum, frame):
            self.log(f"[ft] signal {signum}: finishing step then saving")
            self._stop = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (tests)

    def _comm(self):
        from repro_torch.core.ep_moe import _dist_comm
        return _dist_comm(self.mesh)

    def _restore(self, state):
        return ckpt_lib.restore(self.ckpt_dir, state, mesh=self.mesh,
                                fsdp=True, spec=self.spec)

    def _save(self, step: int, state) -> None:
        if self.mesh is None:
            self.checkpointer.save(step, state)
        else:
            ckpt_lib.save(self.ckpt_dir, step, state, keep=self.keep,
                          mesh=self.mesh, fsdp=True, spec=self.spec)

    def restore_or_init(self, state: Dict[str, Tree]
                        ) -> tuple[int, Dict[str, Tree]]:
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if self.mesh is not None:
            mine = -1 if step is None else step
            hi, neg_lo = self._comm().agree_max([mine, -mine])
            if hi != -neg_lo:
                raise RuntimeError(f"the ranks see newest checkpoints from "
                                   f"step {int(-neg_lo)} to {int(hi)} under "
                                   f"{self.ckpt_dir}")
        if step is None:
            return 0, state
        step, restored = self._restore(state)
        self.log(f"[ft] restored checkpoint at step {step}")
        return step, restored

    def _stopping(self) -> bool:
        """Whether a signal stops the loop: on a mesh, caught on any
        rank."""
        if self.mesh is None:
            return self._stop
        return self._comm().agree_max([float(self._stop)])[0] > 0

    def run(self, state: Dict[str, Tree], data_iter, total_steps: int,
            start_step: int = 0) -> Dict[str, Tree]:
        self._install_signals()
        bad_streak = 0
        step = start_step
        t0 = time.perf_counter()
        while step < total_steps and not self._stopping():
            batch = next(data_iter)
            new_state, metrics = self.step_fn(state, batch)
            loss = float(metrics.get("loss", np.nan))
            if not np.isfinite(loss):
                bad_streak += 1
                self.log(f"[ft] step {step}: non-finite loss "
                         f"({bad_streak}/{self.nan_tolerance}) — "
                         "update skipped")
                if bad_streak >= self.nan_tolerance:
                    self.checkpointer.wait()
                    last = ckpt_lib.latest_step(self.ckpt_dir)
                    if last is not None:
                        _, state = self._restore(state)
                        self.log(f"[ft] rolled back to step {last}")
                        step = last
                    bad_streak = 0
                # drop new_state (the poisoned update)
            else:
                bad_streak = 0
                state = new_state
                step += 1
                if step % self.log_every == 0:
                    dt = (time.perf_counter() - t0) / max(self.log_every, 1)
                    t0 = time.perf_counter()
                    self.log(f"[ft] step {step}: loss={loss:.4f} "
                             f"({dt*1e3:.0f} ms/step)")
                if step % self.checkpoint_every == 0:
                    self._save(step, state)
        self.checkpointer.wait()
        ckpt_lib.save(self.ckpt_dir, step, state, keep=self.keep,
                      mesh=self.mesh, fsdp=True, spec=self.spec)
        self.log(f"[ft] final checkpoint at step {step}")
        return state
