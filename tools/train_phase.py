#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 13 alone: training on the card.

    python3 tools/train_phase.py

Builds the kernels, then runs ``chip_smoke.training``: (a) the grouped
FFN's backward kernel against its plain version; (b) reduced olmoe-1b-7b
trained 100 steps (the loss falls; step 1 against the CPU); (c)
``benchmarks/acc_proxy.py``'s recipe through ``launch.train.build`` and
``TrainLoop`` with a preemption and a byte-exact restart; (d) five AdamW
steps of moonshot-v1-16b-a3b at full width and depth 4, timed and
profiled, then (a) at those shapes.  Prints the backward kernel's JSON
record; exits non-zero when a check fails.
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
        print("train_phase: no CUDA device", file=sys.stderr)
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
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.load(verbose=True)
    for name, regs, smem, spill in cs.ptxas_summary(_build.build_log):
        if name.startswith("grouped_ffn_bwd"):
            cs.log(f"ptxas {name}: {regs} registers, {smem} B static smem, "
                   f"{spill} B spilled")
    cs.log(f"sass grouped_ffn_bwd: HGMMA instructions by kernel "
           f"{cs.sass_hgmma('grouped_ffn_bwd')}")
    t0 = time.time()
    bwd, counts, rec = cs.training(torch.device("cuda"))
    cs.log(json.dumps({**bwd, "launches": counts[bwd["name"]]}))
    cs.log(f"phase 13 passed in {time.time() - t0:.1f} s; 13d "
           f"{json.dumps(rec)}")
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
