#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 15 alone: Mamba layers and the hybrid MoE
on the card.

    python3 tools/hybrid_phase.py

Builds the kernels, then runs ``chip_smoke.hybrid_serving``: (a) the
quantizer, the global scale and both grouped FFNs at jamba's expert
shapes (D = 8192, F = 24576) against their plain versions; (b)
falcon-mamba-7b whole: prefill/decode consistency, graphed decode bitwise
against eager, a prefill and a decode step profiled, an 8-request stream
through the graphed engine; (c) jamba-1.5-large-398b at its published
widths (one block of 8 layers, 8 experts): the FFN kernels on the FP4
prefill's own inputs, graphed decode bitwise against eager with FP4 on
and off, phase 5's stream with FP4 firing in prefill.  Prints the
phase's records as JSON; exits non-zero when a check fails.
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
        print("hybrid_phase: no CUDA device", file=sys.stderr)
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
    t0 = time.time()
    out = cs.hybrid_serving(torch.device("cuda"), smi)
    run = out["jamba"]["run"]
    cs.log(json.dumps({"kernels_15a": out["recs"],
                       "falcon_run": out["falcon"]["run"],
                       "jamba_run": run}, default=str))
    cs.log(f"phase 15 passed in {time.time() - t0:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
