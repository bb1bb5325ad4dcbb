#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 14 alone: training under a mesh.

    python3 tools/train_mesh_phase.py

Builds the kernels, then runs ``chip_smoke.mesh_training``: on one card
four rank processes on a ``(2, 2)`` mesh through the ``staged`` backend
(full-width moonshot at depth 2, 4 x 256 tokens a step); with four cards
or more NCCL, one rank a card, at 13d's depth 4 and 4 x 1024 tokens
(``chip_smoke.PHASE14_NCCL``).  (a) step 1 against the one-card step,
three AdamW steps, the census against its prediction, rank 0's FFN
kernels against their plain versions; (b) reduced olmoe-1b-7b: the loss
falls, a preempted ``TrainLoop`` restarts byte-exact.  The work stays
under the ``__main__`` check: the spawned ranks import this module
again.  Exits non-zero when a check fails.
"""
import json
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
        print("train_mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import hw
    from repro_torch.kernels import _build
    card = hw.current()
    cs.HBM_BYTES_PER_S, cs.BF16_FLOP_PER_S, cs.F32_FLOP_PER_S = (
        card.hbm_bw, card.peak_bf16, card.peak_f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    cs.log(smi)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"{torch.cuda.device_count()} cards")
    _build.load()
    t0 = time.perf_counter()
    counts, kernels = cs.mesh_training(torch.device("cuda"), smi)
    cs.log(json.dumps({"mesh_train_launches": counts, "kernels": kernels}))
    cs.log(f"phase 14 passed in {time.perf_counter() - t0:.1f} s")
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
