#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 12 alone: the compiled step (CUDA graphs
of the chunk and decode forwards) on phase 5's full-width weights.

    python3 tools/graph_phase.py

Builds the kernels, makes moonshot-v1-16b-a3b's weights from seed 0 as
phase 5 does, then runs ``chip_smoke.compiled_step``: the graphed forwards
held bitwise against the eager ones, FP4 on and off through one graph;
host enqueue, device busy and idle of each, eager and replayed; phase 5's
stream eager and graphed (virtual time: the same tokens; wall clock:
tok/s, TTFT, TPOT); phase 8a's placement arm graphed.  Exits non-zero
when a check fails.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("graph_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config, hw
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf
    card = hw.current()
    cs.HBM_BYTES_PER_S, cs.BF16_FLOP_PER_S, cs.F32_FLOP_PER_S = (
        card.hbm_bw, card.peak_bf16, card.peak_f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    cs.log(smi)
    _build.load()
    dev = torch.device("cuda")
    cfg = get_config("moonshot-v1-16b-a3b")
    params = tf.init_model(cfg, seed=0, device=dev)
    t0 = time.time()
    out = cs.compiled_step(dev, params, cfg, smi)
    cs.log(f"phase 12 passed in {time.time() - t0:.1f} s; graphed serve "
           f"launches {out['counts']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
