"""The compiled serving step: CUDA graphs of the chunk and decode forwards
over static buffers.

Counterpart of the reference's ``Engine._build``, which jits its forwards
once per input shape.  The port's forwards read nothing on the host (the
FP4 decision, the kernels' counts and predicates stay on the device), so
one captured graph serves every value of its inputs, FP4 on or off.

:class:`StepGraphs` keeps, per key (the forward's input shapes, the
shapes of the placement tables; a chunk has one key per bucket, decode
one), static input buffers that each call writes in place, from pinned
memory, asynchronously.  The first call of a key runs the step eagerly
(its result is the step's; it also makes every buffer a kernel makes at
its first launch) on the capture stream, and the key is captured right
after it; later calls replay the graph.  A capture executes nothing, so
the cache (KV rows, and a Mamba layer's conv and SSM states, all written
in place) and the AIMD state are written once per step; a cross-attention
layer's memory K/V (``xk``/``xv``, filled by the one-shot prefill) are
read, like every other cache entry, at the address they were captured
over.  All graphs of
one object share one memory pool: they never run at once.

A graph holds raw pointers.  Every call compares the addresses, shapes
and strides of the tensors the step reads (weights, cache, state, tables)
with those the graphs were captured over; when one moved (a checkpoint
load, a rank's params rebound), every graph is dropped, the drop declared
to the sentinel, and each key recaptured at its next call.  Values
written in place (a migration's gathers, a table's ``copy_``, a zeroed
rank) are read by the next replay with no recapture.

The outputs of a replay (logits, the statistics) are the graph's static
buffers, and another graph's replay may reuse their memory: read them
before the next forward and keep no reference across steps, as the
engine's sanctioned pulls do.

Uncaptured (``capture=False``: an engine's ``graphs=False``, under a
mesh, on the CPU) the same code runs every call eagerly over the static
buffers.  A capture or replay that fails raises; nothing falls back to
the eager step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.sentinel import NULL_SENTINEL
from repro_torch.kernels import ops as kops

ENTRIES = ("chunk", "decode")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def fingerprint(tree) -> Tuple:
    """Address, shape, strides and dtype of every tensor of ``tree``: what
    a captured kernel node holds of its operands."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in _leaves(tree))


class _Graph:
    """One captured key: its replay (which returns the static outputs) and
    the kernel launches, by kernel, its capture recorded."""
    __slots__ = ("replay", "launches")

    def __init__(self, replay, launches):
        self.replay, self.launches = replay, launches


class StepGraphs:
    """Static buffers and CUDA graphs of an engine's chunk and decode
    steps (see the module docstring).  ``capture`` defaults to whether
    ``device`` is a card."""

    def __init__(self, device, sentinel=None, capture: Optional[bool] = None):
        self.device = torch.device(device)
        self.capture = (self.device.type == "cuda") if capture is None \
            else capture
        self.sentinel = NULL_SENTINEL if sentinel is None else sentinel
        self._inputs: Dict[Hashable, Dict[str, torch.Tensor]] = {}
        self._graphs: Dict[Hashable, _Graph] = {}
        self._state: Optional[Tuple] = None    # what the graphs were made over
        self._made: set = set()                # keys ever captured
        self.captures = dict.fromkeys(ENTRIES, 0)    # new keys
        self.recaptures = dict.fromkeys(ENTRIES, 0)  # keys captured again
        self.replays = dict.fromkeys(ENTRIES, 0)
        self.dropped: List[str] = []           # why the graphs were dropped
        self.pool = None                       # shared pool, on first capture
        self._stream: Optional[torch.cuda.Stream] = None

    # -- static inputs ---------------------------------------------------
    def inputs(self, key: Hashable, arrays: Dict[str, Any]
               ) -> Dict[str, torch.Tensor]:
        """The static input buffers of ``key``, written from ``arrays``
        (numpy arrays or tensors): host data through pinned memory,
        asynchronously, on the current stream."""
        bufs = self._inputs.get(key)
        srcs = {n: a if isinstance(a, torch.Tensor)
                else torch.as_tensor(np.asarray(a)) for n, a in arrays.items()}
        if bufs is None:
            bufs = {n: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                    for n, t in srcs.items()}
            self._inputs[key] = bufs
        for n, t in srcs.items():
            if t.device.type == "cpu" and self.device.type == "cuda":
                t = t.pin_memory()
            bufs[n].copy_(t, non_blocking=True)
        return bufs

    # -- the step --------------------------------------------------------
    def run(self, entry: str, key: Hashable, body: Callable[..., Any],
            state: Tuple, rebuild: Hashable = ()) -> Any:
        """``body(*state)`` for ``key``: replayed when captured, else run
        eagerly and, on a card, captured after.  ``state``: the trees of
        tensors the step reads besides the key's inputs (a graph reads
        them at the addresses they had at its capture); ``rebuild``: the
        static configuration a declared rebuild changes (a capacity
        factor), part of the graph's key."""
        if not self.capture:
            return body(*state)
        fp = fingerprint(state)
        if fp != self._state:
            if self._graphs:
                moved = sum(a != b for a, b in zip(fp, self._state)) \
                    + abs(len(fp) - len(self._state))
                self.drop(f"{moved} of the {len(fp)} tensors the graphs "
                          "read moved")
            self._state = fp
        full = (key, rebuild)
        g = self._graphs.get(full)
        if g is not None:
            out = g.replay()
            kops.add_launch_counts(g.launches)
            self.replays[entry] += 1
            return out
        out = self._eager(body, state)
        self._capture(entry, full, body, state)
        return out

    def drop(self, reason: str) -> None:
        """Drop every graph (their keys recapture at their next call) and
        declare it to the sentinel."""
        self._graphs.clear()
        self.dropped.append(reason)
        self.sentinel.note_rebuild(f"CUDA graphs dropped: {reason}")

    def _side(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _eager(self, body, state):
        """``body(*state)`` now: on a card on the capture stream (what the
        capture will find made there, such as a library's workspace, is
        made by this call)."""
        if self.device.type != "cuda":
            return body(*state)
        cur = torch.cuda.current_stream(self.device)
        side = self._side()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body(*state)
        cur.wait_stream(side)
        return out

    def _capture(self, entry: str, full: Hashable, body, state) -> None:
        kops.prepare_capture(self.device)
        again = full in self._made
        before = kops.launch_counts()
        with self.sentinel.sanctioned("capture"):
            replay = self._record(body, state)
        after = kops.launch_counts()
        launches = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        # a capture launches nothing: take back what the wrappers counted
        kops.add_launch_counts({n: -v for n, v in launches.items()})
        self._graphs[full] = _Graph(replay, launches)
        self._made.add(full)
        (self.recaptures if again else self.captures)[entry] += 1
        self.sentinel.note_capture(entry, full, recapture=again)

    def _record(self, body, state):
        """Capture ``body(*state)`` on the capture stream into the shared
        pool; returns the replay, which returns the static outputs.
        ``thread_local``: an API call of another thread (a checkpoint
        writer's) cannot break the capture."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self._side(),
                              capture_error_mode="thread_local"):
            out = body(*state)

        def replay():
            graph.replay()
            return out
        return replay

    # -- accounting ------------------------------------------------------
    def pool_bytes(self) -> Optional[int]:
        """Bytes the shared pool holds on the card (its segments in the
        allocator's snapshot); None before a capture."""
        if self.pool is None:
            return None
        pid = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pid)

    def summary(self) -> Dict[str, Any]:
        return {"captures": dict(self.captures),
                "recaptures": dict(self.recaptures),
                "replays": dict(self.replays), "graphs": len(self._graphs),
                "dropped": list(self.dropped)}
