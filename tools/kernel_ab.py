#!/usr/bin/env python3
"""Time the quantizer, global-scale, grouped-FFN and ``fp4_matmul`` kernels
of two or more source trees in one process, on one card, in turns (A, B,
B, A for two trees).

    python3 tools/kernel_ab.py PARENT_DIR .

Each tree's ``src/repro_torch/csrc/{quantize_fp4,grouped_fp4_ffn,
fp4_matmul}.cu`` is
built with nvcc into ``build/kernel_ab/<n>/`` and loaded with ctypes; the
trees' C entries take the same arguments, so every library runs on the
same inputs.  Inputs are the serving path's, from a seed: the quantizer on
the ``[64, 1408, 2048]`` view of ``w_gate`` (N contiguous), the same stack
K contiguous, and under a 0 predicate; the global scale on both serving
views (``[64, 1408, 2048]`` of ``w_gate``, ``[64, 2048, 1408]`` of
``w_down``) and under a 0 predicate; the bf16 W4A4 FFN at M = 15360 with
1092 routed rows over 64 slots plus the pad slot, and at the decode shape
(8 rows in each of 64 slots); the BF16-weight FFN at the serve run's
working shapes (M = 960, 1920, 7680 with 54, 186, 420 routed rows), at a
forced full-budget chunk (M = 7680, 6144 routed rows) and with all-zero
counts at M = 15360; ``fp4_matmul`` at x [4096, 2048] bf16 . W [1408,
2048]^T, f32 out, a4 off and on.  Counts over the 64 experts fall off as
rank^-0.8, the pad slot holds the rest of M.  Prints one JSON object: ms
per launch (CUDA events, mean of 20 back-to-back launches) per tree and
case, the FFNs' and the global scale's device time per call by kernel
(torch.profiler), and the card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def build(tree: Path, out: Path) -> dict:
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    csrc = tree / "src" / "repro_torch" / "csrc"
    procs = {}
    for stem in ("quantize_fp4", "grouped_fp4_ffn", "fp4_matmul"):
        lib = out / f"lib{stem}.so"
        procs[stem] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / f"{stem}.cu")]))
    libs = {}
    for stem, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {tree}: {stem}")
        libs[stem] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 1
    from repro_torch.core import quant
    from repro_torch.kernels import grouped_fp4_ffn as ffn
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize_fp4 as qk

    trees = [Path(p).resolve() for p in sys.argv[1:]]
    libs = [build(t, ROOT / "build" / "kernel_ab" / str(i))
            for i, t in enumerate(trees)]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    d, f, e = 2048, 1408, 64

    def randw(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    w = randw(e, d, f, scale=0.02)
    view = w.transpose(-1, -2)
    rows = view.contiguous()
    gs = quant.global_scale_for(view).reshape(1)
    pk = torch.empty((e, f, d // 2), dtype=torch.uint8, device=dev)
    sc = torch.empty((e, f, d // 16), dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    off = torch.zeros(1, dtype=torch.int32, device=dev)

    wd_view = randw(e, f, d, scale=0.02).transpose(-1, -2)
    scratch = [torch.zeros(2, dtype=torch.int32, device=dev) for _ in libs]
    gscale = torch.empty(1, dtype=torch.float32, device=dev)

    def global_scale(lib, x, pred):
        fn = lib["quantize_fp4"].global_scale_fp4_bf16
        fn.argtypes = qk._SCALE_ARGTYPES
        sc_ = scratch[libs.index(lib)]
        return lambda: fn(x.data_ptr(), pred.data_ptr(), sc_.data_ptr(),
                          gscale.data_ptr(), *x.shape, *x.stride(), stream)

    def quantize(lib, x, pred):
        fn = lib["quantize_fp4"].quantize_fp4_bf16
        fn.argtypes = qk._ARGTYPES
        return lambda: fn(x.data_ptr(), gs.data_ptr(), pk.data_ptr(),
                          sc.data_ptr(), e, f, d, *x.stride(),
                          pred.data_ptr(), stream)

    wq = {n: ops.quantize_experts_fp4(randw(e, *s, scale=s[0] ** -0.5)
                                      .transpose(-1, -2))
          for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                       ("w_down", (f, d)))}
    gsc = torch.stack([wq[n].global_scale.reshape(())
                       for n in ("w_gate", "w_up", "w_down")])

    def fp4_inputs(m, counts):
        xs = torch.zeros((m, d), dtype=torch.bfloat16, device=dev)
        n = int(sum(counts))
        xs[:n] = torch.randn((n, d), generator=gen, device=dev).to(xs.dtype)
        return (xs, torch.tensor(counts, dtype=torch.int32, device=dev),
                torch.empty((m, d), dtype=xs.dtype, device=dev),
                torch.empty((m,), dtype=torch.int32, device=dev),
                torch.empty((m, f), dtype=xs.dtype, device=dev),
                torch.zeros((m, d), dtype=xs.dtype, device=dev))

    def fp4_ffn(lib, inputs):
        fn = lib["grouped_fp4_ffn"].grouped_fp4_ffn_bf16
        fn.argtypes = ffn._ARGTYPES
        xs, g32, xq, nz, hq, out = inputs
        ptrs = [getattr(wq[n], a).data_ptr()
                for n in ("w_gate", "w_up", "w_down")
                for a in ("packed", "scales")]
        return lambda: fn(xs.data_ptr(), g32.data_ptr(), g32.shape[0], e,
                          *ptrs, gsc.data_ptr(), xq.data_ptr(),
                          nz.data_ptr(), hq.data_ptr(), out.data_ptr(),
                          xs.shape[0], d, f, stream)

    wb = {n: randw(e, *s, scale=s[0] ** -0.5)
          for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                       ("w_down", (f, d)))}

    def bf16_ffn(lib, inputs):
        fn = lib["grouped_fp4_ffn"].grouped_ffn_bf16
        fn.argtypes = ffn._PLAIN_ARGTYPES
        xs, g32, _, nz, hq, out = inputs
        return lambda: fn(xs.data_ptr(), g32.data_ptr(), g32.shape[0], e,
                          wb["w_gate"].data_ptr(), wb["w_up"].data_ptr(),
                          wb["w_down"].data_ptr(), nz.data_ptr(),
                          hq.data_ptr(), out.data_ptr(), xs.shape[0], d, f,
                          stream)

    def skewed(total, m):
        p = torch.arange(1, e + 1, dtype=torch.float64) ** -0.8
        c = torch.floor(p / p.sum() * total).long()
        c[0] += total - int(c.sum())
        return c.tolist() + [m - total]

    from repro_torch.kernels import fp4_matmul as mm
    mx = torch.randn((4096, d), generator=gen, device=dev).to(torch.bfloat16)
    mp, msc, mgs = ops.quantize_fp4(randw(d, f, scale=d ** -0.5).t())
    my = torch.empty((4096, f), dtype=torch.float32, device=dev)

    def matmul(lib, a4):
        fn = lib["fp4_matmul"].fp4_matmul_bf16_f32
        fn.argtypes = mm._ARGTYPES
        g1 = mgs.reshape(1)
        return lambda: fn(mx.data_ptr(), mp.data_ptr(), msc.data_ptr(),
                          g1.data_ptr(), my.data_ptr(), 4096, f, d, a4,
                          stream)

    serve = fp4_inputs(15360, skewed(1092, 15360))
    decode = fp4_inputs(512, [8] * e)
    plain = {f"bf16_ffn_{n}_rows_m{m}": fp4_inputs(m, skewed(n, m))
             for m, n in ((960, 54), (1920, 186), (7680, 420), (7680, 6144))}
    plain["bf16_ffn_zero_counts_m15360"] = fp4_inputs(15360, [0] * (e + 1))
    cases = {
        "quantize_n_contiguous": lambda lib: quantize(lib, view, one),
        "quantize_k_contiguous": lambda lib: quantize(lib, rows, one),
        "quantize_predicate_0": lambda lib: quantize(lib, view, off),
        "global_scale_gate_up_view": lambda lib: global_scale(lib, view, one),
        "global_scale_down_view": lambda lib: global_scale(lib, wd_view,
                                                           one),
        "global_scale_predicate_0": lambda lib: global_scale(lib, view, off),
        "fp4_ffn_serve_1092_rows": lambda lib: fp4_ffn(lib, serve),
        "fp4_ffn_decode_8x64": lambda lib: fp4_ffn(lib, decode),
        **{name: (lambda lib, a=a: bf16_ffn(lib, a))
           for name, a in plain.items()},
        "fp4_matmul": lambda lib: matmul(lib, 0),
        "fp4_matmul_a4": lambda lib: matmul(lib, 1),
    }

    def time_ms(fn, iters=20):
        for _ in range(3):
            err = fn()
            if err != 0:
                return f"CUDA error {err}"
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def breakdown(fn, calls=10):
        """Device ms per call by kernel, from a torch.profiler trace."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        path = ROOT / "build" / "kernel_ab_trace.json"
        prof.export_chrome_trace(str(path))
        out = {}
        for e in json.loads(path.read_text())["traceEvents"]:
            if e.get("cat") == "kernel":
                name = e["name"].replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split(" ")[-1][-40:]
                out[name] = out.get(name, 0.0) + e["dur"] / 1e3 / calls
        path.unlink()
        return out

    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    res = {str(t): {c: [] for c in cases} for t in trees}
    for i in order:
        for name, make in cases.items():
            res[str(trees[i])][name].append(time_ms(make(libs[i])))
    kernels = {str(t): {c: breakdown(make(lib)) for c, make in cases.items()
                        if c.startswith(("fp4_ffn", "bf16_ffn",
                                         "global_scale"))}
               for t, lib in zip(trees, libs)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "ms": res, "device_ms_by_kernel": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
