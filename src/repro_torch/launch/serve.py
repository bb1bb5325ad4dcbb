"""Serving driver of the port: workload-generated multimodal requests
through the chunked-prefill engine.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --preset tiny --requests 12 --max-new 8

Counterpart of ``repro.launch.serve``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
It synthesizes a request stream from a named workload profile, serves it
with ReaLB live on random weights from a seed, and reports throughput,
TTFT/TPOT percentiles and per-iteration balance stats.  ``--mesh`` accepts
only ``none``: multi-rank expert parallelism is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ReaLBConfig, get_config, reduced
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import Engine
from repro_torch.serving.telemetry import Telemetry
from repro_torch.workloads import make_stream, profile
from repro_torch.workloads.profiles import WORKLOADS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--workload", default="MMMU", choices=sorted(WORKLOADS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=40)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill-budget", type=int, default=256,
                    help="tokens of batched prefill per iteration "
                         "(0 = one-shot per-request prefill)")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single_pod", "multi_pod"])
    ap.add_argument("--gate-gamma", type=int, default=8,
                    help="LB gate Γ (small default so tiny runs exercise it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu: the plain versions)")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port serves on one device; multi-rank "
            "expert parallelism is not ported yet (ROADMAP Queue A item 7)")

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = reduced(cfg)
    rcfg = ReaLBConfig(gate_gamma=args.gate_gamma)

    prof = profile(args.workload,
                   prompt_len_mean=max(args.max_prompt * 2 // 3, 8),
                   prompt_len_std=args.max_prompt // 4,
                   prompt_len_min=8, prompt_len_max=args.max_prompt,
                   max_new_mean=args.max_new, max_new_min=args.max_new,
                   max_new_max=args.max_new)
    specs = make_stream(prof, np.zeros(args.requests), cfg.vocab_size,
                        seed=args.seed)

    params = tf.init_model(cfg, seed=0, device=args.device)
    max_len = args.max_prompt + args.max_new + 8
    telemetry = Telemetry()
    eng = Engine(cfg, params, rcfg, max_slots=args.slots, max_len=max_len,
                 prefill_budget=args.prefill_budget, telemetry=telemetry,
                 device=args.device)
    for spec in specs:
        req = spec.to_request()
        req.arrival_time = None    # stamp with the wall clock at submit
        eng.submit(req)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0

    out_toks = sum(len(r.generated) for r in done)
    in_toks = sum(r.prompt_len for r in done)
    print(f"served {len(done)} requests, {in_toks} prompt + {out_toks} "
          f"generated tokens in {dt:.2f}s "
          f"({(in_toks + out_toks) / dt:.1f} tok/s)")
    if eng.stats:
        s = telemetry.summary()
        gates = [st.gate_open for st in eng.stats]
        print(f"iterations: {len(eng.stats)} "
              f"(prefill chunked={eng.chunked}), "
              f"mean IB_global="
              f"{np.mean([st.ib_global for st in eng.stats]):.2f}, "
              f"gate-open frac={np.mean(gates):.2f}, "
              f"gate duty prefill={s['gate_duty_prefill']:.2f}, "
              f"mean fp4 ranks="
              f"{np.mean([st.fp4_ranks for st in eng.stats]):.2f}")
        if s["ttft"]:
            print(f"TTFT p50/p99: {s['ttft']['p50']:.3f}/"
                  f"{s['ttft']['p99']:.3f}s  "
                  f"TPOT p50: {s['tpot'].get('p50', float('nan')):.4f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
