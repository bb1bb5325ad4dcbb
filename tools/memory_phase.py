#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 17 alone: the memory stream on the card.

    python3 tools/memory_phase.py

Builds the kernels, then runs ``chip_smoke.memory_stream``: (a)
llama-3.2-vision-90b at its published widths cut to 10 layers (8
self-attention, 2 cross-attention): the f32 decode/prefill gap with 1601
vision rows on its first block, one cross layer alone in f32, graphed
decode bitwise against eager, the cross cache's bytes a slot, a one-shot
prefill of 1601 + 256 tokens profiled with the cross layers' share, and 8
requests through a graphed engine; (b) whisper-large-v3 whole: the f32 gap
on 2 encoder and 2 decoder layers, one cross layer alone in f32, graphed
decode bitwise against eager, the cross cache's bytes a slot, an ``[8,
1500]`` encode timed, and 8 requests with frame embeds plus one on a zero
memory through a graphed engine.  Both streams run under a strict
sentinel and launch no kernel.  Prints the phase's records as JSON; exits
non-zero when a check fails.
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
        print("memory_phase: no CUDA device", file=sys.stderr)
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
    out = cs.memory_stream(torch.device("cuda"), smi)
    cs.log(json.dumps(out, default=str))
    cs.log(f"phase 17 passed in {time.perf_counter() - t0:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
