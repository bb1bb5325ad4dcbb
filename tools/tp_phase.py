#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 19 alone: the tensor-parallel layout of
the dense part and the cache under a ``(2, 2)`` mesh.

    python3 tools/tp_phase.py

Builds the kernels, then runs ``chip_smoke.tp_layout``: the one-device
forwards and the one-card train step 1 of the same weights, the steps on
``meta`` under the abstract ``(2, 2)`` mesh and the census predictions,
then four rank processes on the card through the ``staged`` backend
under the default rules: (a) moonshot-v1-16b-a3b at its published widths
cut to ``chip_smoke.PHASE19_LAYERS`` layers, a ``[2, 1024]`` chunk and
four decode steps under the op-level analyzer, a skewed FP4 chunk; (b) a
train step at phase 13d's cut.  The work stays under the ``__main__``
check: the spawned ranks import this module again.  Exits non-zero when
a check fails.
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
        print("tp_phase: no CUDA device", file=sys.stderr)
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
    _build.load()
    t0 = time.perf_counter()
    serve, train, _ = cs.tp_layout(torch.device("cuda"), smi)
    cs.log(json.dumps({"tp_launches": serve, "tp_train_launches": train}))
    cs.log(f"phase 19 passed in {time.perf_counter() - t0:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
