#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s multi-rank phases alone: phase 10 (expert
parallelism) and phase 11 (migration and elastic serving under it).

    python3 tools/ep_phases.py

On one card four rank processes go through the ``staged`` backend; with
two cards or more, NCCL with one rank a card (``chip_smoke.ep_serving``
decides, and prints which).  The kernels are built first.  The work stays
under the ``__main__`` check: the spawned ranks import this module again.
Exits non-zero when a check of either phase fails.
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
        print("ep_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import hw
    from repro_torch.kernels import _build
    card = hw.current()
    cs.HBM_BYTES_PER_S, cs.BF16_FLOP_PER_S, cs.F32_FLOP_PER_S = (
        card.hbm_bw, card.peak_bf16, card.peak_f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    cs.log(smi)
    _build.load()
    t0 = time.time()
    *_, p11 = cs.ep_serving(torch.device("cuda"), smi)
    cs.log(f"phases 10 and 11 passed in {time.time() - t0:.1f} s; phase 11 "
           f"launches by arm and rank {p11['counts']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
