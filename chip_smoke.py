#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi) and builds the CUDA kernels from
   ``src/repro_torch/csrc`` with nvcc;
2. holds the NVFP4 quantize kernel bitwise against its plain PyTorch
   version, on full-width expert stacks and on a power-of-two edge sweep;
3. holds the grouped W4A4 FFN kernel against its plain version: f32 at
   rtol 1e-5 / atol 1e-4 over ragged, empty, one-slot, cap-dropped and
   pad-slot patterns, bf16 at full width (rel-L2 < 3e-2, peak < 0.1);
4. serves a seeded 16-request MMMU stream on full-width, 48-layer
   moonshot-v1-16b-a3b (random weights from a seed) through ``Engine``,
   with the launch counters zeroed just before and read just after, and
   keeps the FFN kernel's inputs of the first launch at each row count;
5. holds the FFN kernel against its plain version on those inputs and
   times both there; checks the outputs (finite full-width logits; reduced
   model on the card against the CPU) and prints one ``{"kernels": [...]}``
   line with each kernel's launches, error, time, bound and plain-version
   time (the FFN's averaged over the serve run's launches);
6. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once without a CUDA device.
"""
from __future__ import annotations

import contextlib
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


def log(*a):
    print(*a, flush=True)


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


def check_quantize(dev):
    """Phase 2: kernel 1 bitwise against its plain version; returns its
    record at the gate/up shape of the serving path."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import quantize_fp4 as qk

    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    # the views the MoE layer quantizes: w_gate/w_up [E, D, F] transposed to
    # [64, 1408, 2048], w_down [E, F, D] transposed to [64, 2048, 1408]
    for name, shape in (("gate_up", (64, 2048, 1408)),
                        ("down", (64, 1408, 2048))):
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        view = w.transpose(-1, -2)
        gs = quant.global_scale_for(view)
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
        plain_ms = time_ms(lambda: qk.quantize_fp4_plain(view, gs), iters=2)
        n = view.numel()
        nbytes = n * 2 + n // 2 + (n // 16) * 4
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # ~12 f32 operations per weight (abs, max, divide, 7 compares,
        # select, shift/or) off the tensor cores
        bound_ops = n * 12 / F32_FLOP_PER_S * 1e3
        log(f"quantize_fp4 {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
            f"bound {max(bound_bytes, bound_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.1f} GB/s")
        rec.setdefault("name", "quantize_fp4")
        if name == "gate_up":
            rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(bound_bytes, bound_ops),
                       bound_by="bytes" if bound_bytes >= bound_ops
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
    return rec


def ffn_bound(args):
    """Least time of one FFN launch on these inputs, ``(ms, bound_by)``.
    Bytes: x and y once each, and the packed weights and scales of the
    slots that hold a nonzero row.  Operations: 6·D·F per nonzero row at
    the bf16 MMA rate (H100 has no FP4 MMA).  All-zero rows (the pad slot's
    unfilled capacity) need no work: their output is 0."""
    import torch
    xs, gs = args[0], args[1]
    m, d = xs.shape
    f = args[2].shape[1]
    ends = torch.cumsum(gs.long(), 0)
    slot = torch.searchsorted(ends, torch.arange(m, device=xs.device),
                              right=True)
    work = (xs != 0).any(-1) & (slot < gs.numel())
    rows = int(work.sum())
    n_live = int(torch.unique(slot[work]).numel())
    nbytes = (n_live * 3 * f * d * (0.5 + 4 / 16)
              + 2 * m * d * xs.element_size() + gs.numel() * 4 + 12)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = 6.0 * rows * d * f / BF16_FLOP_PER_S * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


@contextlib.contextmanager
def recording_ffn_inputs(seen):
    """While open, every call of the FFN kernel's wrapper records its row
    count M in ``seen[M][0]``, and ``seen[M][1]`` keeps the inputs of the
    first call at that M.  The wrapper itself launches and counts."""
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    launch = ffn.grouped_fp4_ffn_cuda

    def record(*args):
        seen.setdefault(args[0].shape[0], [0, args])[0] += 1
        return launch(*args)

    ffn.grouped_fp4_ffn_cuda = record
    try:
        yield seen
    finally:
        ffn.grouped_fp4_ffn_cuda = launch


def check_ffn_at_serve_shapes(seen):
    """Kernel 2 against its plain version on the inputs the serve run gave
    it, one first launch per distinct M; returns its record with times and
    bound averaged over the serve run's launches."""
    import torch
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    from test_torch_cuda import check_ffn

    n_all = sum(n for n, _ in seen.values())
    rec = {"name": "grouped_fp4_ffn", "max_abs_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}}
    for m, (n, args) in sorted(seen.items()):
        err = check_ffn(ffn.grouped_fp4_ffn_cuda(*args),
                        ffn.grouped_fp4_ffn_plain(*args))
        ms = time_ms(lambda: ffn.grouped_fp4_ffn_cuda(*args), iters=5)
        plain_ms = time_ms(lambda: ffn.grouped_fp4_ffn_plain(*args), iters=2)
        bound, by = ffn_bound(args)
        pad = int(args[1][-1])
        log(f"grouped_fp4_ffn serve shape M={m} ({m - pad} routed + {pad} "
            f"pad rows) bf16, {n}/{n_all} launches: max abs err {err:.4g}; "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms), bound {bound:.4f} ms "
            f"({by})")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            rec[key] += v * n / n_all
        rec["bound_by"][by] = rec["bound_by"].get(by, 0) + n
    rec["bound_by"] = max(rec["bound_by"], key=rec["bound_by"].get)
    log(f"grouped_fp4_ffn per serve-run launch (launch-weighted mean over "
        f"{len(seen)} shapes): {rec['ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.4f} ms), bound {rec['bound_ms']:.4f} ms")
    return rec


def check_grouped_ffn(dev):
    """Phase 3: kernel 2 against its plain version over the reference's
    patterns (f32 and bf16) and at full width on a 1024-token chunk."""
    import torch
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    from repro_torch.kernels import ops

    from test_torch_cuda import GROUPED_CASES, _ffn_args, check_ffn

    for m, d, f, gs in GROUPED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ffn_args(dev, m, d, f, gs, dtype, m + d + f)
            err = check_ffn(ffn.grouped_fp4_ffn_cuda(*args),
                            ffn.grouped_fp4_ffn_plain(*args))
            log(f"grouped_fp4_ffn m={m} d={d} f={f} gs={gs} {dtype}: "
                f"max abs err {err:.3g}")

    # full width: a 1024-token prefill chunk, top-6 of 64 experts, capacity
    # factor 1.25 -> cap = 7680 rows; 6144 routed rows over 64 slots (skewed)
    # plus the pad slot of 1536 unfilled zero rows, run with slot 0's weights
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
    wq = {}
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        w = (torch.randn(shape, generator=gen, device=dev)
             / shape[1] ** 0.5).to(torch.bfloat16)
        q = ops.quantize_experts_fp4(w.transpose(-1, -2))
        wq[name] = q._replace(packed=torch.cat([q.packed, q.packed[:1]]),
                              scales=torch.cat([q.scales, q.scales[:1]]))
        del w
    gsc = torch.stack([wq[n].global_scale for n in ("w_gate", "w_up",
                                                    "w_down")])
    args = (xs, gs, wq["w_gate"].packed, wq["w_gate"].scales,
            wq["w_up"].packed, wq["w_up"].scales, wq["w_down"].packed,
            wq["w_down"].scales, gsc)
    y = ffn.grouped_fp4_ffn_cuda(*args)
    ref = ffn.grouped_fp4_ffn_plain(*args)
    err = check_ffn(y, ref)
    ms = time_ms(lambda: ffn.grouped_fp4_ffn_cuda(*args), iters=5)
    plain_ms = time_ms(lambda: ffn.grouped_fp4_ffn_plain(*args), iters=2)
    bound, by = ffn_bound(args)
    log(f"grouped_fp4_ffn full width M={cap} ({t * k} routed rows) D={d} "
        f"F={f} G={e + 1} bf16: max abs err {err:.4g}; {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms), bound {bound:.4f} ms ({by}), "
        f"{6.0 * t * k * d * f / ms / 1e9:.1f} TFLOP/s")


def serve(dev, seen):
    """Phase 4: the main path, full width, recording the FFN kernel's inputs
    into ``seen``; returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ReaLBConfig, get_config
    from repro_torch.core import ep_moe
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
    ep_moe.host_syncs = 0
    pending = sorted(specs, key=lambda s: s.arrival)
    step_s = {"prefill": [], "decode": []}   # host seconds per eng.step()
    t_run = time.perf_counter()
    with recording_ffn_inputs(seen):
        while len(eng.scheduler.finished) < n_req:
            now = clock()
            while pending and pending[0].arrival <= now:
                eng.submit(pending.pop(0).to_request())
            if eng.scheduler.idle and pending:
                time.sleep(max(pending[0].arrival - now, 0.0))
                continue
            n_before, t0 = len(eng.stats), time.perf_counter()
            eng.step()   # ends in host reads of tokens and stats: synchronous
            phases = {s.phase for s in eng.stats[n_before:]}
            step_s["prefill" if "prefill" in phases else "decode"].append(
                time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = ops.launch_counts()
    syncs = ep_moe.host_syncs

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
        f"{np.mean([s.fp4_ranks for s in pre]):.4f}); host reads of the "
        f"FP4 flag {syncs}")
    kept = sum(a.numel() * a.element_size() for _, args in seen.values()
               for a in args)
    log(f"wall {wall:.3f} s, {toks / wall:.2f} tok/s, TTFT p50 "
        f"{np.median(ttft) * 1e3:.1f} ms, TPOT p50 "
        f"{np.median(tpot) * 1e3:.2f} ms, max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (including "
        f"up to {kept / 2 ** 30:.2f} GiB of kept FFN inputs)")
    log("engine steps: " + ", ".join(
        f"{k} {len(v)} x {np.mean(v) * 1e3:.1f} ms (min {min(v) * 1e3:.1f})"
        for k, v in step_s.items() if v))
    log(f"kernel launches on the main path: {counts}")
    if len(done) != n_req:
        raise AssertionError("not every request finished")
    if fp4_iters == 0:
        raise AssertionError("FP4 never fired in prefill")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
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
    del params, eng, res
    torch.cuda.empty_cache()
    return counts


def check_small_against_cpu(dev):
    """Phase 5a: reduced moonshot through the kernels on the card against
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

    recs = [check_quantize(dev)]
    check_grouped_ffn(dev)
    torch.cuda.empty_cache()
    seen = {}
    counts = serve(dev, seen)
    recs.append(check_ffn_at_serve_shapes(seen))
    del seen
    torch.cuda.empty_cache()
    check_small_against_cpu(dev)

    sources = {"quantize_fp4": ("src/repro_torch/csrc/quantize_fp4.cu",
                                "src/repro/kernels/quantize_fp4.py:48"),
               "grouped_fp4_ffn": ("src/repro_torch/csrc/grouped_fp4_ffn.cu",
                                   "src/repro/kernels/grouped_fp4_ffn.py:122")}
    kernels = []
    for r in recs:
        src, rep = sources[r["name"]]
        kernels.append({"name": r["name"], "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
