#!/usr/bin/env python3
"""Time the quantizer, global-scale, grouped-FFN, grouped-FFN backward and
``fp4_matmul`` kernels of two or more source trees in one process, on one
card, in turns (A, B, B, A for two trees).

    python3 tools/kernel_ab.py PARENT_DIR .
    python3 tools/kernel_ab.py --phases TREE


Each tree's ``src/repro_torch/csrc/{quantize_fp4,grouped_fp4_ffn,
fp4_matmul,grouped_ffn_bwd}.cu`` is built with nvcc into
``build/kernel_ab/<n>/`` and loaded with ctypes (a tree without the
backward's source skips its case); the trees' C entries take the same
arguments, so every library runs on the same inputs.  Inputs are the
serving path's, from a seed: the quantizer on the ``[64, 1408, 2048]`` view
of ``w_gate`` (N contiguous), the same stack K contiguous, and under a 0
predicate; the global scale on both serving views (``[64, 1408, 2048]`` of
``w_gate``, ``[64, 2048, 1408]`` of ``w_down``) and under a 0 predicate;
the bf16 W4A4 FFN at M = 15360 with 1092 routed rows over 64 slots plus the
pad slot, and at the decode shape (8 rows in each of 64 slots); the
BF16-weight FFN at the serve run's working shapes (M = 960, 1920, 7680 with
54, 186, 420 routed rows), at a forced full-budget chunk (M = 7680, 6144
routed rows) and with all-zero counts at M = 15360; ``fp4_matmul`` at x
[4096, 2048] . W [1408, 2048]^T, f32 out: x bf16 with a4 off and on, and x
f32 (the same values); the bf16 backward of the BF16-weight FFN at a
full-width train step's shapes (M = 30720, 24576 routed rows, G = 65, Gw = 64;
f32-sized scratch and zeroed outputs, which every tree's entry takes).
Counts over the 64 experts fall off as rank^-0.8, the pad slot holds the
rest of M.  Prints one JSON object: ms per launch (CUDA events, mean of 20
back-to-back launches) per tree and case, the FFNs' and the global scale's
device time per call by kernel (torch.profiler), and the card.

``--phases TREE`` builds a copy of the tree's ``fp4_matmul.cu`` with
``clock64()`` marks (``PHASES``) into ``build/kernel_ab/phases/`` and
prints the cycles a 64-deep stage spends in each phase, per producer and
consumer warpgroup, at the ``fp4_matmul`` shape (bf16 x, a4, f32 x).
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
    for stem in ("quantize_fp4", "grouped_fp4_ffn", "fp4_matmul",
                 "grouped_ffn_bwd"):
        if not (csrc / f"{stem}.cu").exists():
            continue
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


# clock64() marks for ``--phases``: (anchor in fp4_matmul.cu, phase); each
# anchored statement is timed by one thread a warpgroup, summed per phase
# in shared memory and added to the device's totals once a warpgroup
PHASES = [
    ("    mbar_wait(smem_u32(sm + C::FULL) + (s % C::OS) * 8, "
     "(s / C::OS) & 1);", "consumer: wait for a stage"),
    ("      mbar_wait(smem_u32(sm + C::RAW_FULL) + (s % C::RS) * 8,\n"
     "                (s / C::RS) & 1);", "consumer: wait for a stage"),
    ("wgmma_wait<0>();", "consumer: wait for a wgmma"),
    ("promote<A4>(acc, tmp, c0, c1, sx + g * BM, l);\n"
     "      promote<A4>(acc + 32, tmp + 32, c0, c1, sx + g * BM + 64, l);",
     "consumer: promote"),
    ("      mbar_wait(empty + oslot * 8, (s / C::OS - 1) & 1);",
     "producer: wait for a free slot"),
    ("      decode(next[h], sm + oslot * C::OPB, t, h, gs);\n"
     "      next[h] = load_codes(packed, scales, row, row_ok, s + 1, n_stages, "
     "h,\n                           K);", "producer: decode W"),
    ("      mbar_wait(raw_full + rslot * 8, (s / C::RS) & 1);",
     "producer: wait for x"),
    ("      transform_x<TX, A4>(sm, rslot, oslot, t);", "producer: transform x"),
    ("    producer_sync();", "producer: barrier"),
    ("    produce<TX, A4>(sm, maps, packed, scales, *gscale, n_stages, m0, "
     "n0, N,\n                    K);", "producer: all"),
    ("    consume<TX, A4, TY>(sm, n_stages, y, M, N, m0, n0);",
     "consumer: all"),
]


def phases(tree: Path) -> int:
    """Cycles a stage by phase in an instrumented copy of the tree's
    fp4_matmul.cu, at the A/B shape (bf16 x, a4, f32 x)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import fp4_matmul as mm
    from repro_torch.kernels import ops
    csrc = tree / "src" / "repro_torch" / "csrc"
    src = (csrc / "fp4_matmul.cu").read_text()
    names = list(dict.fromkeys(name for _, name in PHASES))
    for anchor, name in PHASES:
        if anchor not in src:
            raise RuntimeError(f"--phases: anchor not found: {anchor!r}")
        # a predicated red, not a branch: ptxas serializes wgmma in flight
        # across a path it cannot prove uniform
        i = names.index(name)
        flush = ("for (int i_ = 0; i_ < 16; ++i_) if (threadIdx.x % 128 == 0)"
                 " atomicAdd(&g_prof[i_], s_prof[threadIdx.x / 128][i_]);"
                 if name.endswith(": all") else "")
        src = src.replace(anchor, (
            "{ const long long t_ = clock64(); " + anchor.strip() +
            ' asm volatile("{ .reg .pred p; setp.eq.u32 p, %0, 0; '
            '@p red.shared.add.u64 [%1], %2; }" :: "r"(threadIdx.x % 128), '
            '"r"(static_cast<unsigned>(__cvta_generic_to_shared('
            f'&s_prof[threadIdx.x / 128][{i}]))), '
            '"l"(clock64() - t_) : "memory"); ' + flush + "}"))
    src = src.replace("namespace {\nnamespace mm {",
                      "__device__ unsigned long long g_prof[16];\n"
                      "__shared__ unsigned long long s_prof[3][16];\n"
                      "namespace {\nnamespace mm {", 1)
    zero = "  __syncthreads();\n  // the warpgroup's role"
    if zero not in src:
        raise RuntimeError("--phases: anchor not found: the role split")
    src = src.replace(zero, "  if (threadIdx.x < 48) s_prof[threadIdx.x / 16]"
                      "[threadIdx.x % 16] = 0;\n" + zero, 1)
    src += ('extern "C" int fp4mm_prof(unsigned long long* out) {\n'
            "  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
            "  unsigned long long z[16] = {0};\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, "
            "sizeof(z)));\n}\n")
    out = ROOT / "build" / "kernel_ab" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fp4_matmul.cu").write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out / "libphases.so"),
                    str(out / "fp4_matmul.cu")], check=True)
    lib = ctypes.CDLL(str(out / "libphases.so"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    m, n, k = 4096, 1408, 2048
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=dev) * k ** -0.5)
    pk, sc, gs = ops.quantize_fp4(w.to(torch.bfloat16))
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = (ctypes.c_ulonglong * 16)()
    blocks = ((n + 127) // 128) * ((m + 127) // 128)
    res = {}
    for case, xx, a4 in (("bf16 x", x, 0), ("a4", x, 1),
                         ("f32 x", x.float(), 0)):
        fn = getattr(lib, f"fp4_matmul_{mm._TYPES[xx.dtype]}_f32")
        fn.argtypes = mm._ARGTYPES
        call = lambda: fn(xx.data_ptr(), pk.data_ptr(), sc.data_ptr(),
                          gs.reshape(1).data_ptr(), y.data_ptr(), m, n, k,
                          a4, stream)
        call()
        torch.cuda.synchronize()
        lib.fp4mm_prof(buf)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        lib.fp4mm_prof(buf)
        stages = blocks * (k // 64)
        res[case] = {"ms (instrumented)": a.elapsed_time(b), **{
            name + " (cycles a stage)": buf[i] / stages /
            (2 if name.startswith("consumer") else 1)
            for i, name in enumerate(names)}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "phases": res}, indent=1))
    return 0


def main() -> int:
    import torch
    if torch.cuda.is_available() and len(sys.argv) == 3 \
            and sys.argv[1] == "--phases":
        return phases(Path(sys.argv[2]).resolve())
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

    mxf = mx.float()

    def matmul(lib, a4, x=mx):
        fn = getattr(lib["fp4_matmul"],
                     f"fp4_matmul_{mm._TYPES[x.dtype]}_f32")
        fn.argtypes = mm._ARGTYPES
        g1 = mgs.reshape(1)
        return lambda: fn(x.data_ptr(), mp.data_ptr(), msc.data_ptr(),
                          g1.data_ptr(), my.data_ptr(), 4096, f, d, a4,
                          stream)

    bm, brows = 30720, 24576
    bx, bdy = (torch.zeros((bm, d), dtype=torch.bfloat16, device=dev)
               for _ in range(2))
    for t in (bx, bdy):
        t[:brows] = torch.randn((brows, d), generator=gen, device=dev).to(
            t.dtype)
    bgs = torch.tensor(skewed(brows, bm), dtype=torch.int32, device=dev)
    bscratch = [torch.empty((bm, f), dtype=torch.float32, device=dev)
                for _ in range(3)]
    bout = [torch.zeros((bm, d), dtype=torch.bfloat16, device=dev)] + [
        torch.zeros(w.shape, dtype=torch.bfloat16, device=dev)
        for w in (wb["w_gate"], wb["w_up"], wb["w_down"])]

    def bwd(lib):
        fn = lib["grouped_ffn_bwd"].grouped_ffn_bwd_bf16
        fn.argtypes = ffn._BWD_ARGTYPES
        return lambda: fn(bx.data_ptr(), bgs.data_ptr(), bgs.shape[0], e,
                          wb["w_gate"].data_ptr(), wb["w_up"].data_ptr(),
                          wb["w_down"].data_ptr(), bdy.data_ptr(),
                          *(t.data_ptr() for t in bscratch),
                          *(t.data_ptr() for t in bout), bm, d, f, stream)

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
        "fp4_matmul_f32x": lambda lib: matmul(lib, 0, mxf),
        "bf16_ffn_bwd_13d": bwd,
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
    def has(lib, name):
        return name != "bf16_ffn_bwd_13d" or "grouped_ffn_bwd" in lib

    res = {str(t): {c: [] for c in cases} for t in trees}
    for i in order:
        for name, make in cases.items():
            if has(libs[i], name):
                res[str(trees[i])][name].append(time_ms(make(libs[i])))
    kernels = {str(t): {c: breakdown(make(lib)) for c, make in cases.items()
                        if c.startswith(("fp4_ffn", "bf16_ffn",
                                         "global_scale")) and has(lib, c)}
               for t, lib in zip(trees, libs)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "ms": res, "device_ms_by_kernel": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
