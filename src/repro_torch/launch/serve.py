"""Serving driver of the port: workload-generated multimodal requests
through the chunked-prefill engine.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch moonshot-v1-16b-a3b --preset tiny --requests 12 --max-new 8

Counterpart of ``repro.launch.serve``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
It synthesizes a request stream from a named workload profile, serves it
with ReaLB live on random weights from a seed, and reports throughput,
TTFT/TPOT percentiles and per-iteration balance stats.

``--mesh host`` serves with expert parallelism over every rank the
launcher starts, one EP group (``(1, world)``): NCCL with one card a rank,
or gloo with ``--device cpu``::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh host
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh host \
        --device cpu

Every rank serves the same stream and emits the same tokens; rank 0
prints the report and a line saying the ranks agree.  ``single_pod`` and
``multi_pod`` (TPU pod slices) are refused.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ReaLBConfig, get_config, reduced
from repro_torch.launch.mesh import init_distributed, mesh_for
from repro_torch.models import transformer as tf
from repro_torch.models.common import use_mesh
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
    mesh = None
    if args.mesh != "none":
        if args.mesh == "host":
            init_distributed(args.device)
        mesh = mesh_for(args.mesh, device=None if args.device == "cuda"
                        else args.device)

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

    device = args.device if mesh is None else mesh.device
    with use_mesh(mesh):
        params = tf.init_model(cfg, seed=0, device=device)
        max_len = args.max_prompt + args.max_new + 8
        telemetry = Telemetry()
        eng = Engine(cfg, params, rcfg, max_slots=args.slots,
                     max_len=max_len, prefill_budget=args.prefill_budget,
                     telemetry=telemetry, device=device)
        for spec in specs:
            req = spec.to_request()
            req.arrival_time = None    # stamp with the wall clock at submit
            eng.submit(req)
        t0 = time.perf_counter()
        done = eng.run()
        dt = time.perf_counter() - t0
    agree = True if mesh is None else _ranks_agree(done, mesh)
    if mesh is not None and mesh.device_mesh.get_rank() != 0:
        return 0 if agree else 1

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
    if mesh is not None:
        print(f"mesh {mesh.size('data')}x{mesh.size('model')} "
              f"({mesh.backend}): every rank generated the same tokens: "
              f"{agree}")
    return 0 if agree else 1


def _ranks_agree(done, mesh) -> bool:
    """Whether every rank generated the same tokens (a digest of them
    gathered over the default group)."""
    import hashlib

    import torch
    import torch.distributed as dist
    toks = [(r.uid, tuple(r.generated)) for r in sorted(done,
                                                      key=lambda r: r.uid)]
    digest = hashlib.sha256(repr(toks).encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(digest, "little", signed=True)],
                        dtype=torch.int64,
                        device=mesh.device if mesh.backend == "nccl"
                        else "cpu")
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(bool((e == mine).all()) for e in every)


if __name__ == "__main__":
    raise SystemExit(main())
