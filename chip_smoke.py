#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi), builds the CUDA kernels from
   ``src/repro_torch/csrc`` with nvcc and prints each kernel's registers,
   static shared memory and spills (``-Xptxas -v``);
2. holds the NVFP4 quantize kernel and the global-scale kernel bitwise
   against their plain PyTorch versions, on full-width expert stacks (the
   serving views, N contiguous, and the same stacks K contiguous) and on
   a power-of-two edge sweep, and the quantizer's device predicate (0:
   nothing written); times both, also under a 0 predicate (on the host and
   the profiler's device time), and the global scale's yardsticks
   ``torch.linalg.vector_norm(view, ord=inf)`` and ``view.abs().amax()``
   (never called by the port);
3. holds the grouped FFN kernels against their plain versions: W4A4 and
   plain weights, f32 at rtol 1e-5 / atol 1e-4 over ragged, empty,
   one-slot, cap-dropped and pad-slot patterns, bf16 at full width;
4. drives the ``fp4_linear`` path (the on-the-fly quantize plus the W4(A4)
   GEMM) on one full-width moonshot expert projection, a4 off and on, with
   the launch counters zeroed just before and read just after, and holds
   the GEMM kernel against its plain version (bf16 and f32 x, f32 output
   at rtol 1e-5 / atol 1e-4, bf16 output within one bf16 ulp); times the
   bf16-x, a4 and f32-x entries beside their bounds (bf16 tensor ops,
   three passes for f32 x, bytes, the promotion's FFMAs) and two
   yardsticks, ``torch.matmul(x.float(), w_deq.T)`` and cuBLAS bf16;
5. on full-width, 48-layer moonshot-v1-16b-a3b (random weights from a
   seed): one ``chunk_forward`` with FP4 firing, one with FP4 off and one
   ``decode_forward``, all under ``torch.cuda.set_sync_debug_mode("error")``
   (any device-to-host sync raises), keeping the inputs of the first
   launch of the taken branch's FFN kernel; times each forward (and a
   decode forward with FP4 off) warm, on the host (its enqueue, and the
   functions that take it, from ``cProfile``) and on the device (busy time
   and kernels, from a ``torch.profiler`` trace); holds the FFN kernels
   against their plain versions on those inputs and times both there;
   then serves a seeded 16-request MMMU stream through ``Engine`` with
   every forward under the same mode and the launch counters zeroed just
   before and read just after.  Every launch of the serve run is noted
   without a host read, so that the launches that did work (predicate 1,
   or a nonzero count in a slot with weights) are counted apart from those
   that exited at once, and the FFN kernels are held against their plain
   versions and timed on the inputs of their first working launch at each
   row count;
7. on the same weights, the rest of the serving engine: (a) one
   ``prefill_forward`` of B = 1, S = 6144 (70 % vision) into an 8192-row
   cache with FP4 forced on and off, sync-checked, the counters zeroed just
   before and read just after, the FFN kernels held against their plain
   versions on their first launch's inputs, the FP4 forward again under
   ReaLB-seq (``overlap=False``: the same logits) with its token's cost
   timed, each forward timed warm; (b) a
   long-context serve, four MMMU requests of 2600-6000 prompt tokens (two
   with vision embeds, prefilled in one shot) through ``Engine(max_slots=2,
   max_len=8192, temperature=0.7, telemetry=Telemetry())``, every forward
   sync-checked and counted, decode over 8192-row caches through the flash
   path, the telemetry summary held against the request timestamps, and
   the long-KV decode step timed with its cache rewrite's share; (c) phase
   5's stream with ``prefill_budget=0`` (every request one-shot, all
   finish); (d) a checkpoint round trip on reduced moonshot (same weights,
   same greedy tokens);
8. on the same weights and phase 5's stream, ``virtual_ep=4``, every
   forward sync-checked and the counters zeroed just before and read just
   after each arm: (a) a shared-table ``PlacementManager`` (least loaded,
   replan every 8 iterations) migrating synchronously, in place; (c)
   per-layer tables (at most 8 changed layers a replan) drained
   asynchronously at about one block's moved slabs an iteration; (b) the
   weights expanded in place to 68 slots, the quantizer and the global
   scale held bitwise against their plain versions there, and a
   ``ReplicaManager`` (weighted split, ``capacity_margin=1.25``) whose FFN
   kernels are held against their plain versions at G = 68 on the serve
   run's inputs.  Each arm prints replans attempted and committed, bytes
   moved, each migration's measured seconds and GB/s, the bandwidth EWMA,
   tok/s, TTFT/TPOT p50 and peak memory (8c: layers landed per draining
   iteration and iterations per plan; 8b: split duty, replicas per expert,
   capacity factors, the expansion's peak), and checks the landed and
   expanded weights on the card bit for bit against host copies of the
   original slabs gathered by the committed tables;
6. checks the outputs (finite full-width logits; reduced model on the card
   against the CPU) and prints one ``{"kernels": [...]}`` line with each
   kernel's launches (on its path, on the one-shot and long-KV paths of
   phase 7 and on phase 8's three arms) and working launches, error, time
   (and at G = 68 slots, phase 8b)
   (the FFNs': over the serve run's working launches; the W4A4 FFN's also
   at the decode forward's launch and the forced full-budget chunk), time
   of a launch that exits at once (host-set) and its kernels' device time,
   bound, plain-version time and library yardstick;
7. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once without a CUDA device.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # the card's checks

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
SERVE_KERNELS = ("quantize_fp4", "global_scale_fp4", "grouped_fp4_ffn",
                 "grouped_ffn")


def log(*a):
    print(*a, flush=True)


def ptxas_summary(logs):
    """``[(kernel, registers, smem bytes, spill bytes)]`` from the
    ``-Xptxas -v`` output of the build, by source."""
    import re
    rows = []
    for stem, text in sorted(logs.items()):
        name = None
        spill = 0
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line) \
                or re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = int(m.group(2)) if m.lastindex == 2 else 0
                short = re.sub(r"^_Z\w*?\d+(?=[a-z_]+kernel)", "", name)[:48]
                rows.append((f"{stem}:{short}", int(m.group(1)), smem, spill))
                name = None
    return rows


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_call(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``, from a ``torch.profiler`` trace of
    ``calls`` calls: the summed duration of the port's own kernels (not
    PyTorch's, such as a wrapper's zero fill of its output) over ``calls``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "device_ms_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    us = sum(e["dur"] for e in events if e.get("cat") == "kernel"
             and "at::" not in e["name"])
    return us / 1e3 / calls


def check_quantize(dev):
    """Phase 2: the quantize and global-scale kernels bitwise against their
    plain versions; returns their records at the gate/up shape of the
    serving path."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import quantize_fp4 as qk

    gen = torch.Generator(device=dev).manual_seed(1)
    rec, srec = {}, {"name": "global_scale_fp4"}
    off = torch.zeros((), dtype=torch.int32, device=dev)
    # the views the MoE layer quantizes: w_gate/w_up [E, D, F] transposed to
    # [64, 1408, 2048], w_down [E, F, D] transposed to [64, 2048, 1408]
    for name, shape in (("gate_up", (64, 2048, 1408)),
                        ("down", (64, 1408, 2048))):
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        view = w.transpose(-1, -2)
        gs = quant.global_scale_for(view)
        gs_k = qk.global_scale_cuda(view)
        torch.cuda.synchronize()
        if not torch.equal(gs_k.view(torch.int32), gs.view(torch.int32)):
            raise AssertionError(f"global_scale_fp4 {name}: {float(gs_k)} != "
                                 f"{float(gs)}")
        pk, sc = qk.quantize_fp4_cuda(view, gs)
        pk_p, sc_p = qk.quantize_fp4_plain(view, gs)
        torch.cuda.synchronize()
        n_bad = int((pk != pk_p).sum()) + int(
            (sc.view(torch.int32) != sc_p.view(torch.int32)).sum())
        err = float((sc - sc_p).abs().max())
        log(f"quantize_fp4 {name} {tuple(view.shape)} bf16: "
            f"{n_bad} mismatching bytes/scales, max |scale err| {err}")
        if n_bad:
            raise AssertionError(f"quantize_fp4 {name}: not bitwise")
        ms = time_ms(lambda: qk.quantize_fp4_cuda(view, gs), iters=10)
        idle_ms = time_ms(lambda: qk.quantize_fp4_cuda(view, gs, off),
                          iters=10)
        idle_dev = device_ms_per_call(
            lambda: qk.quantize_fp4_cuda(view, gs, off))
        plain_ms = time_ms(lambda: qk.quantize_fp4_plain(view, gs), iters=2)
        # the same stack with K contiguous (fp4_linear's [N, K] weights)
        rows = view.contiguous()
        pk_r, sc_r = qk.quantize_fp4_cuda(rows, gs)
        if not (torch.equal(pk_r, pk_p) and torch.equal(
                sc_r.view(torch.int32), sc_p.view(torch.int32))):
            raise AssertionError(f"quantize_fp4 {name}, K contiguous: not "
                                 "bitwise")
        rows_ms = time_ms(lambda: qk.quantize_fp4_cuda(rows, gs), iters=10)
        del rows, pk_r, sc_r
        n = view.numel()
        nbytes = n * 2 + n // 2 + (n // 16) * 4
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # ~12 f32 operations per weight (abs, max, divide, 7 compares,
        # select, shift/or) off the tensor cores
        bound_ops = n * 12 / F32_FLOP_PER_S * 1e3
        log(f"quantize_fp4 {name}: {ms:.4f} ms (predicate 0: "
            f"{idle_ms:.4f} ms, device {idle_dev:.4f} ms; plain "
            f"{plain_ms:.4f} ms; K contiguous, bitwise: {rows_ms:.4f} ms), "
            f"bound {max(bound_bytes, bound_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.1f} GB/s")
        rec.setdefault("name", "quantize_fp4")
        s_ms = time_ms(lambda: qk.global_scale_cuda(view), iters=10)
        s_idle_ms = time_ms(lambda: qk.global_scale_cuda(view, off),
                            iters=10)
        s_idle_dev = device_ms_per_call(
            lambda: qk.global_scale_cuda(view, off))
        s_plain_ms = time_ms(lambda: quant.global_scale_for(view), iters=10)
        # yardsticks of its max only, never called by the port
        s_lib_ms = time_ms(lambda: torch.linalg.vector_norm(
            view, ord=float("inf")), iters=10)
        s_amax_ms = time_ms(lambda: view.abs().amax(), iters=10)
        # it reads the stack once; ~2 operations (abs, max) per weight
        s_bytes = n * view.element_size() / HBM_BYTES_PER_S * 1e3
        s_ops = n * 2 / F32_FLOP_PER_S * 1e3
        log(f"global_scale_fp4 {name}: bitwise equal; {s_ms:.4f} ms "
            f"(predicate 0: {s_idle_ms:.4f} ms, device {s_idle_dev:.4f} ms; "
            f"plain {s_plain_ms:.4f} ms; torch.linalg.vector_norm(inf) "
            f"{s_lib_ms:.4f} ms, view.abs().amax() {s_amax_ms:.4f} ms), bound {max(s_bytes, s_ops):.4f} ms "
            f"({n * view.element_size() / 1e6:.1f} MB), "
            f"{n * view.element_size() / s_ms / 1e6:.1f} GB/s")
        if name == "gate_up":
            rec.update(max_abs_err=err, ms=ms, idle_ms=idle_ms,
                       idle_device_ms=idle_dev, plain_ms=plain_ms,
                       k_contiguous_ms=rows_ms,
                       bound_ms=max(bound_bytes, bound_ops),
                       bound_by="bytes" if bound_bytes >= bound_ops
                       else "operations")
            srec.update(max_abs_err=0.0, ms=s_ms, idle_ms=s_idle_ms,
                        idle_device_ms=s_idle_dev, plain_ms=s_plain_ms,
                        library_ms=s_lib_ms, abs_amax_ms=s_amax_ms,
                        bound_ms=max(s_bytes, s_ops),
                        bound_by="bytes" if s_bytes >= s_ops
                        else "operations")
        del w, view, pk, sc, pk_p, sc_p

    # power-of-two edge sweep: group amax = 6 x each edge, global scale 1
    from test_torch_cuda import _pow2_edge_weights
    w = _pow2_edge_weights(dev)
    one = torch.ones((), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        pk, sc = qk.quantize_fp4_cuda(w.to(dtype), one)
        pk_p, sc_p = qk.quantize_fp4_plain(w.to(dtype), one)
        if not (torch.equal(pk, pk_p)
                and torch.equal(sc.view(torch.int32),
                                sc_p.view(torch.int32))):
            raise AssertionError(f"quantize_fp4 edge sweep {dtype}")
    log(f"quantize_fp4 power-of-two edge sweep ({w.numel() // 16} scales, "
        "f32 and bf16): bitwise equal")
    from test_torch_cuda import test_quantize_cuda_predicate
    test_quantize_cuda_predicate(dev)
    log("quantize_fp4 device predicate: 0 writes nothing, 1 gives the "
        "unpredicated result bitwise (global scale included)")
    return rec, srec


def ffn_bound(args, fp4=True):
    """Least time of one FFN launch on these inputs, ``(ms, bound_by)``.
    Bytes: x and y once each, and the weights (FP4: packed codes and
    scales, 4.25 bits a weight; plain: 16 or 32 bits) of the slots that
    hold a nonzero row.  Operations: 6·D·F per nonzero row at the bf16 MMA
    rate (H100 has no FP4 MMA).  All-zero rows (the pad slot's unfilled
    capacity), rows of slots without weights and rows of slots with a zero
    count need no work: their output is 0."""
    import torch
    xs, gs = args[0], args[1]
    m, d = xs.shape
    n_w = args[2].shape[0]
    f = args[2].shape[1] if fp4 else args[2].shape[2]
    ends = torch.cumsum(gs.long(), 0)
    slot = torch.searchsorted(ends, torch.arange(m, device=xs.device),
                              right=True)
    work = (xs != 0).any(-1) & (slot < min(gs.numel(), n_w))
    rows = int(work.sum())
    n_live = int(torch.unique(slot[work]).numel())
    w_bytes = 0.5 + 4 / 16 if fp4 else args[2].element_size()
    nbytes = (n_live * 3 * f * d * w_bytes
              + 2 * m * d * xs.element_size() + gs.numel() * 4
              + (12 if fp4 else 0))
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = 6.0 * rows * d * f / BF16_FLOP_PER_S * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


@contextlib.contextmanager
def keeping_first_inputs(kept, key, wrapper):
    """While open, the first call of the grouped FFN kernel wrapper named
    ``wrapper`` keeps its inputs in ``kept[key]``.  The wrapper itself
    launches and counts."""
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    launch = getattr(ffn, wrapper)

    def run(*args):
        kept.setdefault(key, args)
        return launch(*args)

    setattr(ffn, wrapper, run)
    try:
        yield kept
    finally:
        setattr(ffn, wrapper, launch)


@contextlib.contextmanager
def sync_checked_forwards(counter):
    """While open, every ``prefill_forward``, ``chunk_forward`` and
    ``decode_forward`` (as the engine calls them) runs under
    ``set_sync_debug_mode("error")``, so a device-to-host sync inside a
    forward raises; ``counter`` counts them."""
    import torch
    from repro_torch.models import transformer as tf
    saved = {"prefill": tf.prefill_forward, "chunk": tf.chunk_forward,
             "decode": tf.decode_forward}

    def checked(name, fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counter[name] = counter.get(name, 0) + 1
            return out
        return run

    for name, fn in saved.items():
        setattr(tf, f"{name}_forward", checked(name, fn))
    try:
        yield counter
    finally:
        for name, fn in saved.items():
            setattr(tf, f"{name}_forward", fn)


def check_ffn_at_main_shapes(kept):
    """Phases 5b and 7a: the grouped FFN kernels against their plain
    versions on the inputs full-width forwards gave their first launch,
    consuming ``kept`` (keys ``<forward>_fp4``: the FP4 kernel with FP4
    firing; ``<forward>_bf16``: the plain kernel with FP4 off); returns the
    kernel's ms at each forward's launch, by key."""
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    from test_torch_cuda import check_ffn, check_plain_ffn

    times = {}
    for key in list(kept):
        fp4 = key.endswith("_fp4")
        wrapper, name, plain, check = (
            ("grouped_fp4_ffn_cuda", "grouped_fp4_ffn",
             ffn.grouped_fp4_ffn_plain, check_ffn) if fp4 else
            ("grouped_ffn_cuda", "grouped_ffn", ffn.grouped_ffn_plain,
             check_plain_ffn))
        args = kept.pop(key)
        launch = getattr(ffn, wrapper)
        err = check(launch(*args), plain(*args))
        ms = time_ms(lambda: launch(*args), iters=5)
        plain_ms = time_ms(lambda: plain(*args), iters=2)
        bound, by = ffn_bound(args, fp4)
        m = args[0].shape[0]
        routed = int(args[1][:args[2].shape[0]].sum())
        log(f"{name} at the {key} forward's first launch: M={m} "
            f"({routed} rows in slots with weights, G={args[1].numel()}) "
            f"{args[0].dtype}: max abs err {err:.4g}; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms), bound {bound:.4f} ms ({by})")
        times[key] = ms
        del args
    return times


class ServeLaunches:
    """Notes every launch of the serving path's kernel wrappers while
    ``noting()`` is open, with no device operation and no host read inside
    a forward.  A quantizer or global-scale launch works when its predicate
    is 1, an FFN launch when a slot with weights has a nonzero count; the
    others exit at once.  ``end_step`` (after the engine's own host read at
    the end of a step) keeps the inputs of each FFN kernel's first working
    launch at each row count M, and ``working`` counts the working launches
    with one host read after the run.  An FP4 launch keeps its x, its counts
    and the three BF16 weight views its quantizer launches were given; its
    packed weights are made again from those (the quantizer is bitwise
    deterministic), so no layer's packed weights are held."""

    FFN = ("grouped_fp4_ffn", "grouped_ffn")

    def __init__(self, keep_inputs: bool = True):
        self.keep_inputs = keep_inputs           # False: count only
        self.preds = {"quantize_fp4": [], "global_scale_fp4": []}
        self.ffn = {n: [] for n in self.FFN}     # (counts, n_w, M) a launch
        self.step = {n: [] for n in self.FFN}    # this step's kept inputs
        self.first = {n: {} for n in self.FFN}   # M -> inputs
        self.views = []
        self.held_bytes = 0                      # most x held in one step

    @contextlib.contextmanager
    def noting(self):
        from repro_torch.kernels import grouped_fp4_ffn as ffn
        from repro_torch.kernels import quantize_fp4 as qk
        quantize, gscale = qk.quantize_fp4_cuda, qk.global_scale_cuda
        fp4, plain = ffn.grouped_fp4_ffn_cuda, ffn.grouped_ffn_cuda

        def quantize_noted(w, gs, pred):
            self.preds["quantize_fp4"].append(pred)
            self.views = (self.views + [w])[-3:]
            return quantize(w, gs, pred)

        def gscale_noted(w, pred):
            self.preds["global_scale_fp4"].append(pred)
            return gscale(w, pred)

        def noted(name, launch, inputs):
            def run(*args):
                m, n_w = args[0].shape[0], args[2].shape[0]
                self.ffn[name].append((args[1], n_w, m))
                if self.keep_inputs and m not in self.first[name]:
                    self.step[name].append((m, args[1], n_w, inputs(args)))
                return launch(*args)
            return run

        qk.quantize_fp4_cuda, qk.global_scale_cuda = (quantize_noted,
                                                      gscale_noted)
        ffn.grouped_fp4_ffn_cuda = noted(
            "grouped_fp4_ffn", fp4, lambda a: (a[0], a[1], tuple(self.views)))
        ffn.grouped_ffn_cuda = noted("grouped_ffn", plain, lambda a: a)
        try:
            yield self
        finally:
            qk.quantize_fp4_cuda, qk.global_scale_cuda = quantize, gscale
            ffn.grouped_fp4_ffn_cuda, ffn.grouped_ffn_cuda = fp4, plain

    @staticmethod
    def _works(launches):
        """Host list: did each (counts, n_w, ...) launch do work."""
        import torch
        return torch.stack([g[:n_w].max() > 0
                            for g, n_w, *_ in launches]).tolist()

    def end_step(self):
        held = {}
        for name, entries in self.step.items():
            if not entries:
                continue
            held.update((e[3][0].data_ptr(), e[3][0].nbytes) for e in entries)
            works = self._works([(g, n_w) for _, g, n_w, _ in entries])
            for (m, _, _, inputs), w in zip(entries, works):
                if w and m not in self.first[name]:
                    self.first[name][m] = inputs
            entries.clear()
        self.held_bytes = max(self.held_bytes, sum(held.values()))

    def launches_by_m(self, name):
        """``{M: launches}`` of an FFN kernel."""
        out = {}
        for *_, m in self.ffn[name]:
            out[m] = out.get(m, 0) + 1
        return out

    def working(self):
        """Working launches: a count per quantizer kernel, ``{M: count}``
        per FFN kernel."""
        import torch
        out = {n: int(torch.stack([p.to(torch.int32).reshape(())
                                   for p in preds]).sum()) if preds else 0
               for n, preds in self.preds.items()}
        for name, launches in self.ffn.items():
            out[name] = {}
            for (_, _, m), w in zip(launches, self._works(launches)
                                    if launches else []):
                out[name][m] = out[name].get(m, 0) + int(w)
        return out


def check_ffn_at_serve_launches(note, working):
    """Phase 5c: each FFN kernel against its plain version on the inputs of
    its first working launch of the serve run at each row count M, timed
    there; and, at each M, the time of a launch with all-zero counts (it
    exits at once), as the serve run's other launches were.  Returns
    records averaged over the serve run's working launches (``ms``,
    ``plain_ms``, ``bound_ms``) and over its other launches (``idle_ms``)."""
    import torch
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    from repro_torch.kernels import ops
    from test_torch_cuda import check_ffn, check_plain_ffn

    def fp4_args(xs, gs, views):
        wq = [ops.quantize_experts_fp4(v) for v in views]
        return (xs, gs, *(t for q in wq for t in (q.packed, q.scales)),
                torch.stack([q.global_scale.reshape(()) for q in wq]))

    recs = {}
    for name, launch, plain, check, fp4 in (
            ("grouped_fp4_ffn", ffn.grouped_fp4_ffn_cuda,
             ffn.grouped_fp4_ffn_plain, check_ffn, True),
            ("grouped_ffn", ffn.grouped_ffn_cuda, ffn.grouped_ffn_plain,
             check_plain_ffn, False)):
        if not note.first[name]:
            raise AssertionError(f"{name}: no working launch in the serve run")
        rows = []
        for m, inputs in sorted(note.first[name].items()):
            args = fp4_args(*inputs) if fp4 else inputs
            err = check(launch(*args), plain(*args))
            ms = time_ms(lambda: launch(*args), iters=5)
            plain_ms = time_ms(lambda: plain(*args), iters=2)
            bound, by = ffn_bound(args, fp4)
            n = working[name][m]
            routed = int(args[1][:args[2].shape[0]].sum())
            log(f"{name} at the serve run's first working launch with M={m} "
                f"({routed} rows in slots with weights; {n} working launches "
                f"at this M) {args[0].dtype}: max abs err {err:.4g}; "
                f"{ms:.4f} ms (plain {plain_ms:.4f} ms), bound {bound:.4f} "
                f"ms ({by})")
            rows.append((n, err, ms, plain_ms, bound, by))
        idle_rows = []
        for m, n in sorted(note.launches_by_m(name).items()):
            n_idle = n - working[name].get(m, 0)
            if not n_idle:
                continue
            idle = (torch.zeros((m, args[0].shape[1]), dtype=args[0].dtype,
                                device=args[0].device),
                    torch.zeros_like(args[1])) + tuple(args[2:])
            idle_ms = time_ms(lambda: launch(*idle), iters=5)
            idle_dev = device_ms_per_call(lambda: launch(*idle))
            log(f"{name}: {n_idle} launches of the serve run at M={m} did no "
                f"work; such a launch (all-zero counts) takes {idle_ms:.4f} "
                f"ms, {idle_dev:.4f} ms of it in its kernels on the device")
            idle_rows.append((n_idle, idle_ms, idle_dev))
        del args
        total = sum(r[0] for r in rows)
        mean = lambda i: sum(r[0] * r[i] for r in rows) / total  # noqa: E731
        n_idle = sum(r[0] for r in idle_rows)
        recs[name] = {"name": name, "max_abs_err": max(r[1] for r in rows),
                      "ms": mean(2), "plain_ms": mean(3), "bound_ms": mean(4),
                      "bound_by": max(rows, key=lambda r: r[0])[5],
                      "idle_ms": sum(r[0] * r[1] for r in idle_rows) / n_idle
                      if n_idle else None,
                      "idle_device_ms": sum(r[0] * r[2] for r in idle_rows)
                      / n_idle if n_idle else None}
    note.first = {n: {} for n in note.FFN}
    return recs


def check_grouped_ffn(dev):
    """Phase 3: both grouped FFN kernels against their plain versions over
    the reference's patterns (f32 and bf16, the plain kernel's last slot a
    pad slot without weights), all-zero counts, and at full width on a
    1024-token chunk; returns each kernel's ms there, by name."""
    import torch
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    from repro_torch.kernels import ops

    from test_torch_cuda import (GROUPED_CASES, _ffn_args, _plain_ffn_args,
                                 check_ffn, check_plain_ffn,
                                 test_grouped_ffns_cuda_zero_counts,
                                 test_grouped_fp4_ffn_cuda_pad_slot)

    for m, d, f, gs in GROUPED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ffn_args(dev, m, d, f, gs, dtype, m + d + f)
            err = check_ffn(ffn.grouped_fp4_ffn_cuda(*args),
                            ffn.grouped_fp4_ffn_plain(*args))
            args = _plain_ffn_args(dev, m, d, f, gs, len(gs) - 1, dtype,
                                   m + d)
            err_p = check_plain_ffn(ffn.grouped_ffn_cuda(*args),
                                    ffn.grouped_ffn_plain(*args))
            log(f"grouped FFN m={m} d={d} f={f} gs={gs} {dtype}: max abs "
                f"err FP4 {err:.3g}, plain weights {err_p:.3g}")
    for dtype in (torch.float32, torch.bfloat16):
        test_grouped_ffns_cuda_zero_counts(dev, dtype)
        test_grouped_fp4_ffn_cuda_pad_slot(dev, dtype)
    log("grouped FFNs: all-zero counts give exactly 0; the FP4 kernel's pad "
        "slot without weights gives 0")

    # full width: a 1024-token prefill chunk, top-6 of 64 experts, capacity
    # factor 1.25 -> cap = 7680 rows; 6144 routed rows over 64 slots (skewed)
    # plus the pad slot of 1536 unfilled zero rows, which has no weights
    gen = torch.Generator(device=dev).manual_seed(2)
    d, f, e, t, k = 2048, 1408, 64, 1024, 6
    cap = -(-int(t * k * 1.25) // 8) * 8
    probs = torch.arange(1, e + 1, device=dev, dtype=torch.float32) ** -0.8
    slot = torch.multinomial(probs, t * k, replacement=True, generator=gen)
    gs = torch.cat([torch.bincount(slot, minlength=e),
                    torch.tensor([cap - t * k], device=dev)]).to(torch.int32)
    xs = torch.zeros((cap, d), dtype=torch.bfloat16, device=dev)
    xs[:t * k] = torch.randn((t * k, d), generator=gen, device=dev).to(
        torch.bfloat16)
    w, wq = {}, {}
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        w[name] = (torch.randn(shape, generator=gen, device=dev)
                   / shape[1] ** 0.5).to(torch.bfloat16)
        wq[name] = ops.quantize_experts_fp4(w[name].transpose(-1, -2))
    gsc = torch.stack([wq[n].global_scale for n in ("w_gate", "w_up",
                                                    "w_down")])
    fp4_args = (xs, gs, wq["w_gate"].packed, wq["w_gate"].scales,
                wq["w_up"].packed, wq["w_up"].scales, wq["w_down"].packed,
                wq["w_down"].scales, gsc)
    plain_args = (xs, gs, w["w_gate"], w["w_up"], w["w_down"])
    times = {}
    for name, args, launch, plain, check, fp4 in (
            ("grouped_fp4_ffn", fp4_args, ffn.grouped_fp4_ffn_cuda,
             ffn.grouped_fp4_ffn_plain, check_ffn, True),
            ("grouped_ffn", plain_args, ffn.grouped_ffn_cuda,
             ffn.grouped_ffn_plain, check_plain_ffn, False)):
        err = check(launch(*args), plain(*args))
        ms = time_ms(lambda: launch(*args), iters=5)
        plain_ms = time_ms(lambda: plain(*args), iters=2)
        bound, by = ffn_bound(args, fp4)
        log(f"{name} full width M={cap} ({t * k} routed rows) D={d} F={f} "
            f"G={e + 1} (pad slot without weights) bf16: max abs err "
            f"{err:.4g}; {ms:.4f} ms (plain {plain_ms:.4f} ms), bound "
            f"{bound:.4f} ms ({by}), "
            f"{6.0 * t * k * d * f / ms / 1e9:.1f} TFLOP/s")
        times[name] = ms
    return times


def check_fp4_linear(dev):
    """Phase 4: the ``fp4_linear`` path on one full-width moonshot expert
    projection, x [4096, 2048] bf16 against w [2048, 1408] bf16, a4 off and
    on, with the counters zeroed just before and read just after; then the
    GEMM kernel against its plain version.  Returns (record, counts)."""
    import torch
    from repro_torch.kernels import fp4_matmul as mm
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(3)
    m, k, n = 4096, 2048, 1408
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(
        torch.bfloat16)
    ops.reset_launch_counts()
    ys = {a4: ops.fp4_linear(x, w, a4=a4) for a4 in (False, True)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"fp4_linear x {tuple(x.shape)} bf16 . w {tuple(w.shape)} bf16, a4 "
        f"off and on: kernel launches {counts}")
    for name in ("quantize_fp4", "global_scale_fp4", "fp4_matmul"):
        if counts[name] == 0:
            raise AssertionError(f"fp4_linear did not launch {name}")

    packed, scales, gs = ops.quantize_fp4(w.transpose(0, 1))
    rec = {"name": "fp4_matmul", "max_abs_err": 0.0}
    for a4 in (False, True):
        ref = mm.fp4_matmul_plain(x, packed, scales, gs, a4=a4)
        if not (ys[a4].shape == (m, n) and torch.isfinite(ys[a4]).all()):
            raise AssertionError("fp4_linear: output not finite")
        torch.testing.assert_close(ys[a4], ref, rtol=1e-5, atol=1e-4)
        err = float((ys[a4] - ref).abs().max())
        # x in f32: the same product, f32 in
        y32 = mm.fp4_matmul_cuda(x.float(), packed, scales, gs, a4=a4)
        torch.testing.assert_close(y32, ref, rtol=1e-5, atol=1e-4)
        # bf16 out: the f32 result rounded once, within one bf16 ulp
        y16 = mm.fp4_matmul_cuda(x, packed, scales, gs, a4=a4,
                                 out_dtype=torch.bfloat16)
        torch.testing.assert_close(y16.float(), ref, rtol=2.0 ** -8,
                                   atol=1e-4)
        err16 = float((y16.float() - ref).abs().max())
        log(f"fp4_matmul a4={a4}: f32 out max abs err {err:.4g} (rtol 1e-5 "
            f"/ atol 1e-4, bf16 and f32 x), bf16 out max abs err "
            f"{err16:.4g} (within one bf16 ulp)")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    xf = x.float()
    entries = {"bf16 x": (x, False), "a4": (x, True), "f32 x": (xf, False)}
    times = {key: time_ms(lambda a=a, q=q: mm.fp4_matmul_cuda(
        a, packed, scales, gs, a4=q), iters=50, warmup=3)
        for key, (a, q) in entries.items()}
    plain_ms = time_ms(lambda: mm.fp4_matmul_plain(x, packed, scales, gs),
                       iters=5)
    # yardsticks, never called by the port: the f32 product alone (TF32
    # off) on a W dequantized ahead of time, and cuBLAS bf16 on a W rounded
    # to bf16 (a rounded function: what a tensor-core GEMM reaches here)
    w_deq = mm.dequantize_kernel_order(packed, scales, gs)
    w16 = w_deq.bfloat16()
    f32_lib_ms = time_ms(lambda: torch.matmul(xf, w_deq.t()), iters=50,
                         warmup=3)
    bf16_lib_ms = time_ms(lambda: torch.matmul(x, w16.t()), iters=50,
                          warmup=3)
    flops = 2.0 * m * n * k
    nbytes = m * k * 2 + n * k // 2 + n * k // 16 * 4 + m * n * 4
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_tc = flops / BF16_FLOP_PER_S * 1e3
    # promotion: one FFMA per output and group (a4: an FMUL too)
    bound_promo = 2.0 * m * n * (k // 16) / F32_FLOP_PER_S * 1e3
    log(f"fp4_matmul [{m}, {k}] . [{n}, {k}]^T -> f32: bf16 x "
        f"{times['bf16 x']:.4f} ms ({flops / times['bf16 x'] / 1e9:.1f} "
        f"TFLOP/s), a4 {times['a4']:.4f} ms, f32 x {times['f32 x']:.4f} ms; "
        f"plain {plain_ms:.4f} ms; bounds: bf16 tensor ops "
        f"{bound_tc:.4f} ms ({flops / 1e9:.1f} GFLOP at 989 TFLOP/s), f32 x "
        f"three passes {3 * bound_tc:.4f} ms, bytes {bound_bytes:.4f} ms "
        f"({nbytes / 1e6:.1f} MB), promotion FFMA {bound_promo:.4f} ms "
        f"(a4 {2 * bound_promo:.4f}) on the f32 pipes beside the tensor "
        f"cores; yardsticks: torch.matmul(x.float(), w_deq.T) "
        f"{f32_lib_ms:.4f} ms (f32, TF32 off), torch.matmul(x, "
        f"w_deq.bfloat16().T) {bf16_lib_ms:.4f} ms (cuBLAS bf16, rounded)")
    rec.update(ms=times["bf16 x"], a4_ms=times["a4"],
               f32_x_ms=times["f32 x"], plain_ms=plain_ms,
               bound_ms=max(bound_bytes, bound_tc),
               bound_by="bytes" if bound_bytes >= bound_tc else "operations",
               library_ms=f32_lib_ms, bf16_library_ms=bf16_lib_ms)
    return rec, counts


def sync_free_forwards(dev, params, cfg):
    """Phase 5a: one full-width chunk_forward with FP4 firing, one with FP4
    off and one decode_forward (FP4 firing), each under
    ``set_sync_debug_mode("error")``, keeping the inputs of the first launch
    of the FFN kernel of the taken branch; returns those inputs."""
    import torch
    from repro_torch.configs import ReaLBConfig
    from repro_torch.models import transformer as tf

    # every virtual rank is hot (C = 0) and the gate always open: FP4 fires
    # wherever a rank holds a vision token
    fp4 = ReaLBConfig(gate_gamma=0, capacity_c=0.0, md_init=0.0,
                      adaptive=False)
    bf16 = ReaLBConfig(gate_gamma=10 ** 9)
    b, s, l = 8, 256, 512
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=dev, dtype=torch.int32),
             "start": torch.zeros(b, dtype=torch.int32, device=dev),
             "chunk_len": torch.full((b,), 128, dtype=torch.int32,
                                     device=dev),
             "modality": torch.rand((b, s), generator=gen, device=dev) < 0.6}
    dec = {"tokens": batch["tokens"][:, :1],
           "pos": torch.full((b,), 128, dtype=torch.int32, device=dev),
           "modality": torch.ones((b, 1), dtype=torch.bool, device=dev)}
    m0 = torch.zeros((1, 4), device=dev)
    fired, kept = {}, {}
    torch.cuda.synchronize()
    for key, rcfg, wrapper in (
            ("chunk_fp4", fp4, "grouped_fp4_ffn_cuda"),
            ("chunk_bf16", bf16, "grouped_ffn_cuda"),
            ("decode_fp4", fp4, "grouped_fp4_ffn_cuda")):
        cache = tf.init_cache(cfg, b, l, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with keeping_first_inputs(kept, key, wrapper):
            torch.cuda.set_sync_debug_mode("error")
            try:
                if key.startswith("chunk"):
                    res = tf.chunk_forward(params, cfg, rcfg, batch, cache, m0)
                else:
                    res = tf.decode_forward(params, cfg, rcfg, dec, cache, m0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fired[key] = float(res.aux["fp4_ranks"])
        if not torch.isfinite(res.logits).all():
            raise AssertionError(f"{key}: logits not finite")
        log(f"{key}: full-width {'chunk' if 'chunk' in key else 'decode'}"
            f"_forward under set_sync_debug_mode('error'): no sync; FP4 "
            f"virtual ranks summed over the MoE layers {fired[key]:.0f}; "
            f"{secs * 1e3:.1f} ms")
    if not (fired["chunk_fp4"] > 0 and fired["decode_fp4"] > 0
            and fired["chunk_bf16"] == 0):
        raise AssertionError(f"FP4 did not fire as configured: {fired}")
    del res

    # phase 5d: host against device time of each forward, warm
    for key, rcfg in (("chunk_fp4", fp4), ("chunk_bf16", bf16),
                      ("decode_fp4", fp4), ("decode_bf16", bf16)):
        if key.startswith("chunk"):
            args = (params, cfg, rcfg, batch, cache, m0)
            fwd = lambda: tf.chunk_forward(*args)  # noqa: E731
        else:
            args = (params, cfg, rcfg, dec, cache, m0)
            fwd = lambda: tf.decode_forward(*args)  # noqa: E731
        host, wall, device, top, top_host = host_and_device_ms(fwd)
        busy = "not measured (no device event in the trace)" \
            if device is None else (f"{device:.1f} ms busy (idle "
                                    f"{1 - device / wall:.1%} of the wall)")
        log(f"{key} forward, warm: host enqueue {host:.1f} ms, wall "
            f"{wall:.1f} ms, device {busy}; most device time: " + "; ".join(
                f"{name} {ms:.2f} ms" for name, ms in top)
            + "; most host time (cProfile, own): " + "; ".join(
                f"{name} x{n} {ms:.2f} ms" for name, n, ms in top_host))
    del cache
    return kept


def host_and_device_ms(fn):
    """Phase 5d: one warm call of ``fn``: ``(host ms, wall ms, device ms,
    top, top_host)``.  Host: from call to return; wall: until its work is
    done; device: the union of the intervals in which a kernel, copy or
    memset of a third call ran, from a ``torch.profiler`` trace (None when
    the trace holds no device event); top: the six kernels with the most
    device time, ``[(name, ms)]``; top_host: the eight functions with the
    most host time of their own in a fourth call under ``cProfile``,
    ``[(name, calls, ms)]``."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "phase5d_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("cat") in ("kernel", "gpu_memcpy",
                                         "gpu_memset")),
                    key=lambda e: e["ts"])
    path.unlink()
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in events:
        busy += max(0.0, e["ts"] + e["dur"] - max(e["ts"], end))
        end = max(end, e["ts"] + e["dur"])
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    prof_host = cProfile.Profile()
    prof_host.enable()
    fn()
    prof_host.disable()
    torch.cuda.synchronize()
    own = sorted(pstats.Stats(prof_host).stats.items(),
                 key=lambda kv: -kv[1][2])[:8]
    top_host = [(f"{Path(f).name}:{line} {func}"[:70], calls, secs * 1e3)
                for (f, line, func), (_, calls, secs, *_) in own]
    return (host * 1e3, wall * 1e3, busy / 1e3 if events else None,
            [(name[:70], us / 1e3) for name, us in top], top_host)


def serve_wall_clock(eng, requests, clock, note=None):
    """Submit each request at its arrival time on ``clock`` and step the
    engine until all have finished; returns the host seconds of each
    ``eng.step()`` by phase (a step ends in the engine's host reads of
    tokens and stats, so it is synchronous)."""
    pending = sorted(requests, key=lambda r: r.arrival_time)
    n_req = len(requests) + len(eng.scheduler.finished)
    step_s = {"prefill": [], "decode": []}
    while len(eng.scheduler.finished) < n_req:
        now = clock()
        while pending and pending[0].arrival_time <= now:
            eng.submit(pending.pop(0))
        if eng.scheduler.idle and pending:
            time.sleep(max(pending[0].arrival_time - now, 0.0))
            continue
        n_before, t0 = len(eng.stats), time.perf_counter()
        eng.step()
        phases = {s.phase for s in eng.stats[n_before:]}
        step_s["prefill" if "prefill" in phases else "decode"].append(
            time.perf_counter() - t0)
        if note is not None:
            note.end_step()
    return step_s


def serve(dev):
    """Phase 5: the main path, full width: the sync-free forwards, the FFN
    kernels on the inputs they gave them, then the serve run and the FFN
    kernels on its inputs; returns the FFN kernels' records, the serve
    run's launch counts and working launches, and the weights and config
    (phase 7 serves them again)."""
    import numpy as np
    import torch
    from repro_torch.configs import ReaLBConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_bytes
    from repro_torch.serving.engine import Engine
    from repro_torch.workloads.arrivals import ArrivalConfig, arrival_times
    from repro_torch.workloads.multimodal import make_stream, profile

    cfg = get_config("moonshot-v1-16b-a3b")
    t0 = time.perf_counter()
    params = tf.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
        f"{tree_bytes(params) / 1e9:.2f} GB of weights in "
        f"{time.perf_counter() - t0:.1f} s")
    main_ms = check_ffn_at_main_shapes(sync_free_forwards(dev, params, cfg))
    torch.cuda.empty_cache()

    rcfg = ReaLBConfig(gate_gamma=512, md_init=0.0, adaptive=False)
    max_len, n_req = 512, 16
    prof = profile("MMMU")
    specs = make_stream(prof, arrival_times(ArrivalConfig(
        kind="poisson", rate=8.0, n_requests=n_req, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=max_len - prof.max_new_max - 1)
    log(f"stream: {n_req} MMMU requests, prompt tokens "
        f"{sum(len(s.tokens) for s in specs)}, vision share "
        f"{np.mean([s.modality.mean() for s in specs]):.3f}")
    t_start = time.monotonic()
    clock = lambda: time.monotonic() - t_start  # noqa: E731
    eng = Engine(cfg, params, rcfg, max_slots=8, max_len=max_len,
                 prefill_budget=1024, virtual_ep=4, clock=clock, device=dev)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    checked, note = {}, ServeLaunches()
    t_run = time.perf_counter()
    with sync_checked_forwards(checked), note.noting():
        step_s = serve_wall_clock(eng, [s.to_request() for s in specs],
                                  clock, note)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    working_by_m = note.working()
    working = {k: v if isinstance(v, int) else sum(v.values())
               for k, v in working_by_m.items()}

    done = eng.scheduler.finished
    toks = sum(len(r.generated) for r in done)
    pre = [s for s in eng.stats if s.phase == "prefill"]
    dec = [s for s in eng.stats if s.phase == "decode"]
    fp4_iters = sum(1 for s in pre if s.fp4_ranks > 0)
    ttft = [r.ttft for r in done]
    tpot = [r.tpot for r in done if r.tpot is not None]
    log(f"served: {len(done)}/{n_req} requests finished, {toks} tokens "
        f"generated, {len(pre)} prefill + {len(dec)} decode iterations")
    log(f"prefill gate duty {np.mean([s.gate_open for s in pre]):.4f}, "
        f"FP4 fired in {fp4_iters}/{len(pre)} prefill iterations "
        f"(mean FP4 virtual ranks per layer "
        f"{np.mean([s.fp4_ranks for s in pre]):.4f})")
    log(f"sync-free: all {checked.get('chunk', 0)} chunk_forward and "
        f"{checked.get('decode', 0)} decode_forward calls of the serve run "
        "ran under set_sync_debug_mode('error') without a device-to-host "
        "sync")
    log(f"wall {wall:.3f} s, {toks / wall:.2f} tok/s, TTFT p50 "
        f"{np.median(ttft) * 1e3:.1f} ms, TPOT p50 "
        f"{np.median(tpot) * 1e3:.2f} ms, max memory allocated "
        f"{peak / 2 ** 30:.2f} GiB (including up to "
        f"{note.held_bytes / 2 ** 30:.2f} GiB of FFN inputs held in a step)")
    log("engine steps: " + ", ".join(
        f"{k} {len(v)} x {np.mean(v) * 1e3:.1f} ms (min {min(v) * 1e3:.1f})"
        for k, v in step_s.items() if v))
    log(f"kernel launches on the main path: {counts}; of those, launches "
        f"that did work (FFNs: by row count M): {working_by_m}")
    if len(done) != n_req:
        raise AssertionError("not every request finished")
    if fp4_iters == 0:
        raise AssertionError("FP4 never fired in prefill")
    if min(counts[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    if min(working[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"a kernel of the path never did work: "
                             f"{working}")
    ffn_recs = check_ffn_at_serve_launches(note, working_by_m)
    ffn_recs["grouped_fp4_ffn"]["decode_ms"] = main_ms["decode_fp4"]
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.uid}: token out of range")

    # full-width outputs are finite: one chunk forward on a fresh cache
    b, s = 2, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                     dtype=torch.int32),
             "start": torch.zeros(b, dtype=torch.int32, device=dev),
             "chunk_len": torch.tensor([s, s // 2], dtype=torch.int32,
                                       device=dev)}
    res = tf.chunk_forward(params, cfg, rcfg, batch,
                           tf.init_cache(cfg, b, 64, device=dev),
                           torch.zeros((1, 4), device=dev))
    if res.logits.shape != (b, cfg.vocab_size) \
            or not bool(torch.isfinite(res.logits).all()):
        raise AssertionError("full-width logits not finite / wrong shape")
    log(f"full-width chunk logits {tuple(res.logits.shape)} finite")
    del eng, res
    torch.cuda.empty_cache()
    return ffn_recs, counts, working, params, cfg


def path_counts(note):
    """``(launches, working launches)`` of the serving kernels noted by
    ``note`` since the launch counters were zeroed."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    working = {k: v if isinstance(v, int) else sum(v.values())
               for k, v in note.working().items()}
    return counts, working


def oneshot_prefill(dev, params, cfg):
    """Phase 7a: one full-width ``prefill_forward`` of B = 1, S = 6144
    (70 % vision) into an 8192-row cache, FP4 forced on and off, each under
    ``set_sync_debug_mode("error")`` with the counters zeroed just before
    and read just after; the FFN kernels against their plain versions on
    their first launch's inputs; the FP4 forward again under ReaLB-seq
    (the same logits) and the cost of its token; each forward timed warm.
    Returns the counts, working launches and the FFN kernels' ms at these
    launches."""
    import dataclasses

    import torch
    from repro_torch.configs import ReaLBConfig
    from repro_torch.core import ep_moe
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    fp4 = ReaLBConfig(gate_gamma=0, capacity_c=0.0, md_init=0.0,
                      adaptive=False)
    bf16 = ReaLBConfig(gate_gamma=10 ** 9)
    s, cache_len = 6144, 8192
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                                     device=dev, dtype=torch.int32),
             "modality": torch.rand((1, s), generator=gen, device=dev) < 0.7}
    m0 = torch.zeros((1, 4), device=dev)
    kept, fired, logits = {}, {}, {}
    note = ServeLaunches(keep_inputs=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with note.noting():
        for key, rcfg, wrapper in (("oneshot_fp4", fp4, "grouped_fp4_ffn_cuda"),
                                   ("oneshot_bf16", bf16, "grouped_ffn_cuda")):
            t0 = time.perf_counter()
            with keeping_first_inputs(kept, key, wrapper):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    res = tf.prefill_forward(params, cfg, rcfg, batch, m0,
                                             cache_len=cache_len)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            fired[key] = float(res.aux["fp4_ranks"])
            logits[key] = res.logits
            kv = res.cache["blocks"]["layer0"]["k"]
            if res.logits.shape != (1, cfg.vocab_size) or not bool(
                    torch.isfinite(res.logits).all()) or tuple(kv.shape[2:4]) \
                    != (cache_len, cfg.n_kv_heads) or bool(kv[:, :, s:].any()):
                raise AssertionError(f"{key}: bad logits or cache")
            log(f"{key}: full-width prefill_forward B=1 S={s} (cache_len "
                f"{cache_len}) under set_sync_debug_mode('error'): no sync; "
                f"FP4 virtual ranks summed over the MoE layers "
                f"{fired[key]:.0f}; logits finite, cache zero past row {s}; "
                f"{secs * 1e3:.1f} ms")
            del res, kv
    counts, working = path_counts(note)
    peak = torch.cuda.max_memory_allocated()
    log(f"7a one-shot path: kernel launches {counts}; working launches "
        f"{working}; max memory allocated {peak / 2 ** 30:.2f} GiB")
    if not (fired["oneshot_fp4"] > 0 and fired["oneshot_bf16"] == 0):
        raise AssertionError(f"FP4 did not fire as forced: {fired}")
    if min(working[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"a kernel did no work in one-shot prefill: "
                             f"{working}")
    ms = check_ffn_at_main_shapes(kept)

    # ReaLB-seq: the quantizer after the dispatch, with the token added to
    # every weight view; on finite weights the same logits bit for bit
    seq = dataclasses.replace(fp4, overlap=False)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tf.prefill_forward(params, cfg, seq, batch, m0,
                                 cache_len=cache_len)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = torch.equal(res.logits, logits["oneshot_fp4"])
    del res
    moe = {n: params["blocks"]["layer0"]["moe"][n][0]
           for n in ("w_gate", "w_up", "w_down")}
    one = torch.ones((), dtype=torch.int32, device=dev)
    token = torch.zeros((), device=dev)
    q_ms = time_ms(lambda: ep_moe._quantize_experts(moe, fp4, one), iters=10)
    q_seq_ms = time_ms(lambda: ep_moe._quantize_experts(moe, seq, one, token),
                       iters=10)
    n_moe = sum(1 for f in cfg.ffn_kinds() if f == "moe")
    log(f"oneshot_fp4 under ReaLB-seq (overlap=False): sync-free, logits "
        f"equal to ReaLB's bit for bit: {same}; one MoE layer's weight "
        f"quantization {q_ms:.4f} ms, with the ReaLB-seq token added to its "
        f"three views {q_seq_ms:.4f} ms (+{q_seq_ms - q_ms:.4f} ms a layer, "
        f"{(q_seq_ms - q_ms) * n_moe:.1f} ms over {n_moe} MoE layers)")
    if not same:
        raise AssertionError("ReaLB-seq changed the one-shot logits")
    for key, rcfg in (("oneshot_fp4", fp4), ("oneshot_bf16", bf16)):
        fwd = lambda r=rcfg: tf.prefill_forward(  # noqa: E731
            params, cfg, r, batch, m0, cache_len=cache_len)
        host, wall, device, top, top_host = host_and_device_ms(fwd)
        busy = "not measured (no device event in the trace)" \
            if device is None else (f"{device:.1f} ms busy (idle "
                                    f"{1 - device / wall:.1%} of the wall)")
        log(f"{key} forward (S={s}), warm: host enqueue {host:.1f} ms, wall "
            f"{wall:.1f} ms, device {busy}; most device time: " + "; ".join(
                f"{name} {t:.2f} ms" for name, t in top)
            + "; most host time (cProfile, own): " + "; ".join(
                f"{name} x{n} {t:.2f} ms" for name, n, t in top_host))
    torch.cuda.empty_cache()
    return counts, working, ms


def long_context_serve(dev, params, cfg):
    """Phase 7b: four seeded MMMU requests of 2600-6000 prompt tokens and
    8-16 new tokens through ``Engine(max_slots=2, max_len=8192,
    prefill_budget=1024, temperature=0.7, telemetry=Telemetry())``; two
    carry vision embeds (one-shot prefill), the others are chunked; decode
    attends over 8192-row caches through ``_decode_flash``.  Every forward
    runs under the sync check, the counters zeroed just before and read
    just after.  Then the telemetry summary against the timestamps, and the
    long-KV decode step timed with the cache rewrite's share."""
    import numpy as np
    import torch
    from repro_torch.configs import ReaLBConfig
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.obs import summarize
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.telemetry import Telemetry
    from repro_torch.workloads.multimodal import make_stream, profile

    rcfg = ReaLBConfig(gate_gamma=512, md_init=0.0, adaptive=False)
    prof = profile("MMMU", prompt_len_mean=4300, prompt_len_std=1100,
                   prompt_len_min=2600, prompt_len_max=6000, max_new_mean=12,
                   max_new_min=8, max_new_max=16)
    specs = make_stream(prof, np.zeros(4), cfg.vocab_size, seed=2,
                        with_embeds=True)
    reqs = [sp.to_request(cfg.d_model if sp.uid % 2 else 0) for sp in specs]
    n_emb = sum(r.vision_embeds is not None for r in reqs)
    log(f"7b stream: 4 MMMU requests, prompts {[r.prompt_len for r in reqs]}"
        f" tokens, new tokens {[r.max_new_tokens for r in reqs]}, vision "
        f"share {np.mean([r.modality.mean() for r in reqs]):.3f}, {n_emb} "
        "with vision embeds")
    if n_emb != 2:
        raise AssertionError("7b: two requests must carry vision embeds")
    tel = Telemetry()
    t_start = time.monotonic()
    clock = lambda: time.monotonic() - t_start  # noqa: E731
    for r in reqs:
        r.arrival_time = 0.0
    eng = Engine(cfg, params, rcfg, max_slots=2, max_len=8192,
                 prefill_budget=1024, virtual_ep=4, temperature=0.7, seed=0,
                 telemetry=tel, clock=clock, device=dev)
    flash = {"calls": 0}
    decode_flash = attn._decode_flash

    def counted_flash(*a, **kw):
        flash["calls"] += 1
        return decode_flash(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    checked, note = {}, ServeLaunches(keep_inputs=False)
    attn._decode_flash = counted_flash
    t_run = time.perf_counter()
    try:
        with sync_checked_forwards(checked), note.noting():
            step_s = serve_wall_clock(eng, reqs, clock)
    finally:
        attn._decode_flash = decode_flash
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts, working = path_counts(note)
    peak = torch.cuda.max_memory_allocated()
    done = eng.scheduler.finished
    pre = [s for s in eng.stats if s.phase == "prefill"]
    oneshot = [s for s in pre if s.n_active == 1 and s.batch_tokens == s.tokens]
    toks = sum(len(r.generated) for r in done)
    log(f"7b served: {len(done)}/4 requests finished, {toks} tokens "
        f"generated (temperature 0.7), {len(pre)} prefill iterations "
        f"({len(oneshot)} one-shot) + "
        f"{sum(1 for s in eng.stats if s.phase == 'decode')} decode; "
        f"FP4 fired in {sum(1 for s in pre if s.fp4_ranks > 0)}/{len(pre)} "
        f"prefill iterations; _decode_flash calls {flash['calls']}; forwards "
        f"under set_sync_debug_mode('error'): {checked}; wall {wall:.3f} s; "
        f"max memory allocated {peak / 2 ** 30:.2f} GiB")
    log("7b engine steps: " + ", ".join(
        f"{k} {len(v)} x {np.mean(v) * 1e3:.1f} ms (min {min(v) * 1e3:.1f})"
        for k, v in step_s.items() if v))
    log(f"7b long-KV path: kernel launches {counts}; working launches "
        f"{working}")
    if len(done) != 4 or len(oneshot) < 2 or flash["calls"] == 0:
        raise AssertionError("7b: not every request finished, or no one-shot"
                             " prefill or decode flash")
    if min(counts[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"7b: a kernel of the path never launched: "
                             f"{counts}")
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.uid}: token out of range")
    summ = tel.summary()
    ttft = summarize([r.ttft for r in done])
    tpot = summarize([r.tpot for r in done if r.tpot is not None])
    log(f"7b telemetry: TTFT {summ['ttft']}, TPOT {summ['tpot']}; from the "
        f"Request timestamps: TTFT {ttft}, TPOT {tpot}; n_iters "
        f"{summ['n_iters']}, fp4_duty_prefill {summ['fp4_duty_prefill']}")
    if summ["ttft"] != ttft or summ["tpot"] != tpot \
            or summ["n_requests"] != 4 or summ["n_iters"] != len(eng.stats):
        raise AssertionError("7b: telemetry disagrees with the timestamps")

    # the long-KV decode step, warm, and the share of its cache rewrite
    dec = {"tokens": torch.zeros((2, 1), dtype=torch.int32, device=dev),
           "pos": torch.tensor([6000, 7000], dtype=torch.int32, device=dev),
           "modality": torch.zeros((2, 1), dtype=torch.bool, device=dev),
           "valid": torch.ones((2, 1), dtype=torch.bool, device=dev)}
    host, wall_ms, device, top, _ = host_and_device_ms(
        lambda: tf.decode_forward(params, cfg, rcfg, dec, eng.cache,
                                  eng.m_state))
    k = eng.cache["blocks"]["layer0"]["k"][0]
    new = torch.randn((2, 1) + tuple(k.shape[2:]), device=dev).to(k.dtype)
    write_ms = time_ms(lambda: attn._scatter_kv(k, new, dec["pos"]), iters=20)
    out = attn._scatter_kv(k, new, dec["pos"])
    copy_ms = time_ms(lambda: k.copy_(out), iters=20)
    n_tensors = 2 * cfg.n_layers
    rewrite = n_tensors * (write_ms + copy_ms)
    share = "not measured" if device is None else f"{rewrite / device:.1%}"
    log(f"7b long-KV decode step (B=2, L=8192, pos 6000/7000), warm: host "
        f"enqueue {host:.1f} ms, wall {wall_ms:.1f} ms, device "
        f"{'not measured' if device is None else f'{device:.1f} ms'}; most "
        "device time: " + "; ".join(f"{n} {t:.2f} ms" for n, t in top)
        + f"; cache rewrite: _write_rows {write_ms:.4f} ms + copy back "
        f"{copy_ms:.4f} ms per [2, 8192, {k.shape[2]}, {k.shape[3]}] tensor, "
        f"x{n_tensors} = {rewrite:.2f} ms a step ({share} of the device "
        "time)")
    del eng, out, new, k
    torch.cuda.empty_cache()
    return counts, working


def oneshot_stream(dev, params, cfg):
    """Phase 7c: phase 5's 16-request stream with ``prefill_budget=0``:
    every request prefilled whole, every forward under the sync check; all
    must finish."""
    import numpy as np
    import torch
    from repro_torch.configs import ReaLBConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.workloads.arrivals import ArrivalConfig, arrival_times
    from repro_torch.workloads.multimodal import make_stream, profile

    rcfg = ReaLBConfig(gate_gamma=512, md_init=0.0, adaptive=False)
    max_len, n_req = 512, 16
    prof = profile("MMMU")
    specs = make_stream(prof, arrival_times(ArrivalConfig(
        kind="poisson", rate=8.0, n_requests=n_req, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=max_len - prof.max_new_max - 1)
    t_start = time.monotonic()
    clock = lambda: time.monotonic() - t_start  # noqa: E731
    eng = Engine(cfg, params, rcfg, max_slots=8, max_len=max_len,
                 prefill_budget=0, virtual_ep=4, clock=clock, device=dev)
    checked = {}
    t_run = time.perf_counter()
    with sync_checked_forwards(checked):
        step_s = serve_wall_clock(eng, [s.to_request() for s in specs], clock)
    wall = time.perf_counter() - t_run
    done = eng.scheduler.finished
    pre = [s for s in eng.stats if s.phase == "prefill"]
    log(f"7c prefill_budget=0: {len(done)}/{n_req} requests finished, "
        f"{len(pre)} one-shot prefills, FP4 fired in "
        f"{sum(1 for s in pre if s.fp4_ranks > 0)}; forwards under "
        f"set_sync_debug_mode('error'): {checked}; wall {wall:.3f} s; TTFT "
        f"p50 {np.median([r.ttft for r in done]) * 1e3:.1f} ms; steps: "
        + ", ".join(f"{k} {len(v)} x {np.mean(v) * 1e3:.1f} ms"
                    for k, v in step_s.items() if v))
    if len(done) != n_req or len(pre) != n_req or checked.get("chunk"):
        raise AssertionError("7c: not every request took the one-shot path "
                             "and finished")
    del eng
    torch.cuda.empty_cache()


def checkpoint_round_trip(dev):
    """Phase 7d: reduced moonshot on the card: save, load into an engine
    built on other weights, and serve one request greedily: the same
    tokens, and the weights bit for bit."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import ReaLBConfig, get_config, reduced
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    mod = rng.random(40) < 0.6
    kw = dict(max_slots=2, max_len=64, prefill_budget=16, virtual_ep=4,
              device=dev)
    path = ROOT / "build" / "phase7_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    src = Engine(cfg, tf.init_model(cfg, seed=1, device=dev),
                 ReaLBConfig(gate_gamma=8), **kw)
    src.save_checkpoint(str(path), 1)
    dst = Engine(cfg, tf.init_model(cfg, seed=2, device=dev),
                 ReaLBConfig(gate_gamma=8), **kw)
    dst.load_checkpoint(str(path))
    out = []
    for eng in (src, dst):
        eng.submit(Request(uid=0, tokens=tokens, modality=mod,
                           max_new_tokens=8))
        out.append(eng.run()[0].generated)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        ckpt._leaves(src.params), ckpt._leaves(dst.params)))
    shutil.rmtree(path, ignore_errors=True)
    log(f"7d checkpoint round trip (reduced moonshot on the card): weights "
        f"equal {same}; greedy tokens {out[0]} / {out[1]}")
    if out[0] != out[1] or not same:
        raise AssertionError("7d: restored engine differs")


def long_context(dev, params, cfg):
    """Phase 7: one-shot prefill, the long-context serve, the one-shot
    stream and the checkpoint round trip; returns each kernel's launches
    and working launches on the one-shot and long-KV paths, and the FFN
    kernels' ms at the one-shot launches."""
    counts_a, working_a, oneshot_ms = oneshot_prefill(dev, params, cfg)
    counts_b, working_b = long_context_serve(dev, params, cfg)
    oneshot_stream(dev, params, cfg)
    checkpoint_round_trip(dev)
    return {"oneshot": (counts_a, working_a), "long_kv": (counts_b,
                                                          working_b),
            "oneshot_ms": oneshot_ms}


MOE_KEYS = ("w_gate", "w_up", "w_down")


def mmmu_stream(cfg, n_req: int = 16, max_len: int = 512):
    """Phase 5's seeded 16-request MMMU stream."""
    from repro_torch.workloads.arrivals import ArrivalConfig, arrival_times
    from repro_torch.workloads.multimodal import make_stream, profile
    prof = profile("MMMU")
    return make_stream(prof, arrival_times(ArrivalConfig(
        kind="poisson", rate=8.0, n_requests=n_req, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=max_len - prof.max_new_max - 1)


def host_block(params, b: int):
    """Block ``b``'s routed-expert slabs, copied to the host."""
    moe = params["blocks"]["layer0"]["moe"]
    return {k: moe[k][b].to("cpu", copy=True) for k in MOE_KEYS}


def check_block(params, b: int, logical, owner, what: str) -> None:
    """Block ``b`` on the card holds, in every routable slot ``p``, the
    original weights of expert ``owner[p]`` bit for bit (``logical``: the
    block's slabs in logical expert order, on the host)."""
    import torch
    moe = params["blocks"]["layer0"]["moe"]
    own = torch.as_tensor(owner, dtype=torch.long)
    live = own >= 0
    for k in MOE_KEYS:
        got = moe[k][b].cpu()[live]
        if not torch.equal(got, logical[k][own[live]]):
            raise AssertionError(f"{what}: block {b} {k} is not the "
                                 "original slabs gathered by the table")
    log(f"{what}: block {b}, all three expert weights ({int(live.sum())} "
        "routable slots), equal bit for bit to the original slabs gathered "
        "on the host by the committed table")


def managed_serve(dev, params, cfg, arm: str, mgr, note, **engine_kw):
    """Phase 5's stream through ``Engine`` with ``mgr``, on the wall clock,
    every forward under ``set_sync_debug_mode("error")``, the launch
    counters zeroed just before and read just after; prints what the
    manager did.  Returns (engine, counts, tracer)."""
    import numpy as np
    import torch
    from repro_torch.configs import ReaLBConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer
    from repro_torch.placement import migrate as pmigrate
    from repro_torch.serving.engine import Engine

    rcfg = ReaLBConfig(gate_gamma=512, md_init=0.0, adaptive=False)
    specs = mmmu_stream(cfg)
    t_start = time.monotonic()
    clock = lambda: time.monotonic() - t_start  # noqa: E731
    tracer = Tracer(clock=clock)
    eng = Engine(cfg, params, rcfg, max_slots=8, max_len=512,
                 prefill_budget=1024, virtual_ep=4, clock=clock, device=dev,
                 placement=mgr, tracer=tracer, **engine_kw)
    factors = [eng.cfg.moe.capacity_factor]
    resize = eng._maybe_resize_capacity

    def noted_resize():
        resize()
        if eng.cfg.moe.capacity_factor != factors[-1]:
            factors.append(eng.cfg.moe.capacity_factor)

    eng._maybe_resize_capacity = noted_resize
    # the bytes the in-place gathers really copy (every row whose source
    # changed, in every weight of every block), set beside the managers'
    # count (experts that changed rank) at each timed apply
    gather, observe = pmigrate._gather_rows, mgr.bandwidth.observe
    copied, timed = [0], []

    def counted_gather(slabs, row):
        n = int((row != np.arange(row.shape[0])).sum())
        copied[0] += n * sum(w[0].numel() * w.element_size() for w in slabs)
        return gather(slabs, row)

    def noted_observe(nbytes, seconds):
        timed.append((int(nbytes), copied[0], seconds))
        copied[0] = 0
        observe(nbytes, seconds)

    mgr.bandwidth.observe = noted_observe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    checked = {}
    t_run = time.perf_counter()
    pmigrate._gather_rows = counted_gather
    try:
        with sync_checked_forwards(checked), note.noting():
            serve_wall_clock(eng, [s.to_request() for s in specs], clock,
                             note)
        eng.drain_migrations()
    finally:
        pmigrate._gather_rows = gather
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    done = eng.scheduler.finished
    toks = sum(len(r.generated) for r in done)
    ttft = [r.ttft for r in done]
    tpot = [r.tpot for r in done if r.tpot is not None]
    events = tracer._events
    attempts = [e for e in events if e[1].startswith("replan.")]
    verdicts = {}
    for e in attempts:
        v = (e[5] or {}).get("verdict")
        verdicts[v] = verdicts.get(v, 0) + 1
    drains = [e[5] for e in events if e[1] == "migration.drain"]
    log(f"8{arm}: {len(done)}/16 requests finished, {toks} tokens, "
        f"{len(eng.stats)} iterations; wall {wall:.3f} s, "
        f"{toks / wall:.2f} tok/s, TTFT p50 {np.median(ttft) * 1e3:.1f} ms, "
        f"TPOT p50 {np.median(tpot) * 1e3:.2f} ms; max memory allocated "
        f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB); forwards under "
        f"set_sync_debug_mode('error'): {checked}")
    log(f"8{arm}: replans attempted {len(attempts)} (verdicts {verdicts}), "
        f"plans committed {mgr.n_migrations}; bytes moved "
        f"{eng.migration_bytes_moved} ({eng.migration_bytes_moved / 1e9:.3f} "
        f"GB); measured bandwidth EWMA {mgr.bandwidth.bytes_per_s / 1e9:.1f} "
        f"GB/s over {mgr.bandwidth.n_obs} timed gathers; stall "
        f"{eng.migration_stall_s:.4f} s; capacity factors {factors}")
    if len(timed) != len(drains):
        raise AssertionError(f"8{arm}: {len(timed)} timed applies for "
                             f"{len(drains)} migration.drain spans")
    for d, (counted, got, secs) in zip(drains, timed):
        log(f"8{arm}: migration.drain {d['mode']}: {d['bytes']} bytes "
            f"counted, {got} copied by the gathers ({got / counted:.3f}x); "
            f"apply {secs * 1e3:.3f} ms ({counted / secs / 1e9:.1f} GB/s "
            f"counted, {got / secs / 1e9:.1f} GB/s copied), stall "
            f"{d['stall_s'] * 1e3:.3f} ms, {d['layers']} layer(s)"
            + (f", plan landed {d['done']}" if "done" in d else ""))
    if timed:
        counted, got, secs = (sum(t[i] for t in timed) for i in range(3))
        log(f"8{arm}: all timed applies: {counted} bytes counted, {got} "
            f"copied ({got / counted:.3f}x) in {secs * 1e3:.3f} ms: "
            f"{counted / secs / 1e9:.1f} GB/s counted, "
            f"{got / secs / 1e9:.1f} GB/s copied")
    working = {k: v if isinstance(v, int) else sum(v.values())
               for k, v in note.working().items()}
    log(f"8{arm}: kernel launches {counts}; of those, launches that did "
        f"work {working}")
    if len(done) != 16:
        raise AssertionError(f"8{arm}: not every request finished")
    if min(counts[k] for k in SERVE_KERNELS) == 0 \
            or min(working[k] for k in SERVE_KERNELS) == 0:
        raise AssertionError(f"8{arm}: a kernel of the path never launched "
                             f"or never did work: {counts} {working}")
    if mgr.n_migrations < 1:
        raise AssertionError(f"8{arm}: no plan committed")
    if mgr.in_flight is not None or eng.migration_draining:
        raise AssertionError(f"8{arm}: a plan is still in flight")
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"8{arm}: token out of range")
    return eng, (counts, working), tracer


def check_kernels_at_68(dev, params, b: int):
    """Phase 8b: the quantizer and the global scale against their plain
    versions (bitwise) on block ``b``'s three expert stacks at G = 68 slots,
    one of them the zeroed empty spare, timed; returns their records."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import quantize_fp4 as qk
    moe = params["blocks"]["layer0"]["moe"]
    recs = {"quantize_fp4": {}, "global_scale_fp4": {}}
    for k in MOE_KEYS:
        view = moe[k][b].transpose(-1, -2)
        gs = quant.global_scale_for(view)
        gs_k = qk.global_scale_cuda(view)
        pk, sc = qk.quantize_fp4_cuda(view, gs)
        pk_p, sc_p = qk.quantize_fp4_plain(view, gs)
        torch.cuda.synchronize()
        if not torch.equal(gs_k.view(torch.int32), gs.view(torch.int32)):
            raise AssertionError(f"8b global_scale_fp4 at G=68 {k}")
        if not (torch.equal(pk, pk_p) and torch.equal(
                sc.view(torch.int32), sc_p.view(torch.int32))):
            raise AssertionError(f"8b quantize_fp4 at G=68 {k}: not bitwise")
        ms = time_ms(lambda: qk.quantize_fp4_cuda(view, gs), iters=10)
        plain_ms = time_ms(lambda: qk.quantize_fp4_plain(view, gs), iters=2)
        s_ms = time_ms(lambda: qk.global_scale_cuda(view), iters=10)
        s_plain = time_ms(lambda: quant.global_scale_for(view), iters=10)
        log(f"8b {k} {tuple(view.shape)} (G={view.shape[0]}, empty spares "
            "zeroed): "
            f"quantize_fp4 bitwise, {ms:.4f} ms (plain {plain_ms:.4f}); "
            f"global_scale_fp4 bitwise, {s_ms:.4f} ms (plain {s_plain:.4f})")
        if k == "w_gate":
            recs["quantize_fp4"] = dict(g68_ms=ms, g68_plain_ms=plain_ms,
                                        g68_max_abs_err=0.0)
            recs["global_scale_fp4"] = dict(g68_ms=s_ms, g68_plain_ms=s_plain,
                                            g68_max_abs_err=0.0)
        del pk, sc, pk_p, sc_p
    return recs


def placement_and_replication(dev, params, cfg):
    """Phase 8: phase 5's weights and stream, ``virtual_ep=4``, every
    forward under ``set_sync_debug_mode("error")``: (a) a shared-table
    ``PlacementManager`` with synchronous migration; (c) per-layer tables
    with asynchronous, byte-budgeted migration; (b) the weights expanded in
    place to 68 slots and a ``ReplicaManager`` with weighted split and a
    capacity margin.  The landed and expanded weights are checked on the
    card against host copies of the original slabs.  Returns each arm's
    launch counts and working launches, and the kernels' records at
    G = 68."""
    import numpy as np
    import torch
    from repro_torch.configs import PlacementConfig, ReplicationConfig
    from repro_torch.placement import PlacementManager, PlacementTable
    from repro_torch.placement import migrate as pmigrate
    from repro_torch.replication import ReplicaManager, expand_moe_params

    out = {}
    b0 = 0
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"8: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated "
        "at the start")
    logical = host_block(params, b0)           # the original block, logical

    # 8a: placement, shared table, synchronous
    mgr = PlacementManager(cfg, PlacementConfig(
        planner="least_loaded", replan_every=8, warmup_iters=2,
        min_gain=0.0), ep=4)
    note = ServeLaunches(keep_inputs=False)
    eng, out["a"], _ = managed_serve(dev, params, cfg, "a", mgr, note)
    check_block(params, b0, logical, mgr.table.owner, "8a")
    ident = PlacementTable.identity(cfg.moe.num_experts, 4)
    pmigrate.apply_to_params(params, pmigrate.diff(mgr.table, ident))
    check_block(params, b0, logical, ident.owner, "8a back to identity")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # 8c: placement, per-layer tables, asynchronous
    mgr = PlacementManager(cfg, PlacementConfig(
        planner="least_loaded", replan_every=8, warmup_iters=2,
        min_gain=0.0, per_layer=True, max_changed_layers=8), ep=4)
    captured = {}
    replan = mgr.maybe_replan

    def capturing_replan(it):
        plan = replan(it)
        if plan is not None and not captured:
            b = int(plan.changed_layers[0])     # still identity-ordered
            captured[b] = host_block(params, b)
        return plan

    mgr.maybe_replan = capturing_replan
    budget = int(0.75 * cfg.moe.num_experts) * mgr.bytes_per_expert
    log(f"8c: migrate_bytes_per_iter {budget} ({budget / 1e6:.1f} MB, "
        f"{int(0.75 * cfg.moe.num_experts)} experts of one block)")
    note = ServeLaunches(keep_inputs=False)
    eng, out["c"], tracer = managed_serve(
        dev, params, cfg, "c", mgr, note, migrate_async=True,
        migrate_bytes_per_iter=budget)
    per_iter, lands, n = [], [], 0
    for e in tracer._events:
        if e[1] == "migration.drain":
            per_iter.append(e[5]["layers"])
            n += 1
            if e[5]["done"]:
                lands.append(n)
                n = 0
    log(f"8c: layers committed per draining iteration {per_iter}; "
        f"draining iterations a plan took to land {lands}; stall "
        f"{eng.migration_stall_s:.4f} s over {len(per_iter)} drains")
    (bc, host), = captured.items()
    check_block(params, bc, host, mgr.tables[bc].owner, "8c")
    back = pmigrate.diff_layers(mgr.tables, [PlacementTable.identity(
        cfg.moe.num_experts, 4)] * mgr.n_tables)
    pmigrate.apply_to_params(params, back)
    check_block(params, bc, host, np.arange(cfg.moe.num_experts),
                "8c back to identity")
    check_block(params, b0, logical, np.arange(cfg.moe.num_experts),
                "8c back to identity")
    # every reference to the 64-slot tensors goes before they are replaced
    del eng, captured, host, note, tracer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"8b: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated "
        "before the expansion")

    # 8b: replication, 68 slots, weighted split, capacity margin
    mgr = ReplicaManager(cfg, ReplicationConfig(
        spare_per_rank=1, max_replicas=2, replan_every=8, warmup_iters=2,
        min_gain=0.0, weighted_split=True), 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    expand_moe_params(params, mgr.rset)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    from repro_torch.models.common import tree_bytes
    log(f"8b: expand_moe_params to {mgr.n_slots} slots in place in "
        f"{time.perf_counter() - t0:.2f} s; weights now "
        f"{tree_bytes(params) / 1e9:.2f} GB; peak "
        f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB)")
    check_block(params, b0, logical, mgr.rset.slot_owner, "8b expanded")
    empty = np.flatnonzero(mgr.rset.slot_owner < 0)
    zeros = all(bool((params["blocks"]["layer0"]["moe"][k][:, empty] == 0)
                     .all()) for k in MOE_KEYS)
    log(f"8b: empty spare slots {empty.tolist()} all zero in every block: "
        f"{zeros}")
    if not zeros:
        raise AssertionError("8b: an empty spare slot is not zero")
    g68 = check_kernels_at_68(dev, params, b0)
    note = ServeLaunches(keep_inputs=True)
    eng, out["b"], _ = managed_serve(dev, params, cfg, "b", mgr, note,
                                     capacity_margin=1.25)
    working_by_m = note.working()
    split = [s.split_frac for s in eng.stats]
    log(f"8b: split duty {np.mean([f > 0 for f in split]):.4f} of "
        f"iterations, mean split_frac {np.mean(split):.4f}; replicas per "
        f"expert {np.bincount(mgr.rset.n_rep).tolist()} (index = count); "
        f"capacity factor now {eng.cfg.moe.capacity_factor:.4f}")
    check_block(params, b0, logical, mgr.rset.slot_owner, "8b")
    ffn = check_ffn_at_serve_launches(note, working_by_m)
    for name, r in ffn.items():
        g68[name] = dict(g68_ms=r["ms"], g68_plain_ms=r["plain_ms"],
                         g68_max_abs_err=r["max_abs_err"],
                         g68_bound_ms=r["bound_ms"])
    del eng, logical, note
    gc.collect()
    torch.cuda.empty_cache()
    log(f"8: phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return out, g68


def check_small_against_cpu(dev):
    """Phase 6: reduced moonshot through the kernels on the card against
    the plain versions on the CPU (the same check as the card's tests)."""
    from test_torch_cuda import test_reduced_model_through_kernels_matches_cpu
    test_reduced_model_through_kernels_matches_cpu(dev)
    log("reduced moonshot f32, card vs CPU: logits within rtol 1e-4 / atol "
        "1e-4, routing stats and m_state equal")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.load(verbose=True)
    log(f"kernels built and loaded in {_build.build_seconds:.1f} s")
    for name, regs, smem, spill in ptxas_summary(_build.build_log):
        log(f"ptxas {name}: {regs} registers, {smem} B static smem, "
            f"{spill} B spilled")
    if not _build.build_log:
        log("ptxas: the libraries came from the build cache (no compiler "
            "output)")

    q_rec, s_rec = check_quantize(dev)
    forced_ms = check_grouped_ffn(dev)
    torch.cuda.empty_cache()
    mm_rec, linear_counts = check_fp4_linear(dev)
    torch.cuda.empty_cache()
    ffn_recs, counts, working, params, cfg = serve(dev)
    phase7 = long_context(dev, params, cfg)
    torch.cuda.empty_cache()
    phase8, g68 = placement_and_replication(dev, params, cfg)
    del params
    torch.cuda.empty_cache()
    check_small_against_cpu(dev)
    for name, ms in forced_ms.items():
        ffn_recs[name]["forced_ms"] = ms

    # (record, launches and working launches on its path, source, what it
    # replaces); fp4_matmul has no predicate: every launch works
    rows = [
        (q_rec, counts, working, "src/repro_torch/csrc/quantize_fp4.cu",
         "src/repro/kernels/quantize_fp4.py:48"),
        (s_rec, counts, working, "src/repro_torch/csrc/quantize_fp4.cu",
         "jnp.max(jnp.abs(w)) in global_scale_for (XLA), "
         "src/repro/core/quant.py:68"),
        (ffn_recs["grouped_fp4_ffn"], counts, working,
         "src/repro_torch/csrc/grouped_fp4_ffn_sm90.cuh",
         "src/repro/kernels/grouped_fp4_ffn.py:122"),
        (ffn_recs["grouped_ffn"], counts, working,
         "src/repro_torch/csrc/grouped_ffn_sm90.cuh",
         "jax.lax.ragged_dot (XLA), src/repro/core/ep_moe.py:325"),
        (dict(mm_rec, idle_ms=None, idle_device_ms=None), linear_counts,
         linear_counts,
         "src/repro_torch/csrc/fp4_matmul.cu",
         "src/repro/kernels/fp4_matmul.py:68"),
    ]
    kernels = []
    for r, path_counts, path_working, src, rep in rows:
        kernels.append({"name": r["name"], "route": "cuda", "source": src,
                        "replaces": rep, "launches": path_counts[r["name"]],
                        "working_launches": path_working[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "idle_ms": r["idle_ms"],
                        "idle_device_ms": r["idle_device_ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
        kernels[-1].update((k, r[k]) for k in (
            "k_contiguous_ms", "decode_ms", "forced_ms", "abs_amax_ms",
            "a4_ms", "f32_x_ms", "bf16_library_ms") if k in r)
        for path in ("oneshot", "long_kv"):
            c, w = phase7[path]
            kernels[-1][f"{path}_launches"] = c.get(r["name"], 0)
            kernels[-1][f"{path}_working_launches"] = w.get(r["name"], 0)
        for arm, path in (("a", "placement"), ("b", "replicate"),
                          ("c", "placement_l_async")):
            c, w = phase8[arm]
            kernels[-1][f"{path}_launches"] = c.get(r["name"], 0)
            kernels[-1][f"{path}_working_launches"] = w.get(r["name"], 0)
        kernels[-1].update(g68.get(r["name"], {}))
    kernels[2]["oneshot_ms"] = phase7["oneshot_ms"]["oneshot_fp4"]
    kernels[3]["oneshot_ms"] = phase7["oneshot_ms"]["oneshot_bf16"]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
