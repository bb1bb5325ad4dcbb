#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 16 alone: SSM training, the dense
configs and MLA on the card.

    python3 tools/dense_phase.py

Builds the kernels, then runs ``chip_smoke.dense_and_mla``: (a) reduced
jamba-1.5-large-398b trained 50 steps (the loss falls, a restart from step
25 byte-exact, the BF16 grouped FFN and its backward kernel launched in
its MoE layers) and falcon-mamba-7b at its published widths cut to 4
layers (three steps of 4 x 256 tokens, step 1 against an f32 copy, the
scans' share of a step); (b) qwen1.5-0.5b and gemma-7b whole and
command-r-35b cut to 8 layers: the f32 copy's decode/prefill gap,
graphed chunk and decode steps bitwise against eager, phase 5's stream
(chunked prefill); (c) minicpm3-4b whole: the f32 gap, graphed absorbed
decode bitwise against eager, the latent cache's bytes, a 1024-token
prefill profiled, phase 5's stream (one-shot prefill).  Prints the
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
        print("dense_phase: no CUDA device", file=sys.stderr)
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
    out = cs.dense_and_mla(torch.device("cuda"), smi)
    cs.log(json.dumps({"ssm_train_launches": out["counts"],
                       "falcon_train": out["falcon"],
                       "dense_runs": out["dense"], "mla": out["mla"]},
                      default=str))
    cs.log(f"phase 16 passed in {time.perf_counter() - t0:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
