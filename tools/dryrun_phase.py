#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 18 alone: the dry run and the invariant
checks against the card.

    python3 tools/dryrun_phase.py

Builds the kernels and moonshot-v1-16b-a3b whole (48 layers, random
weights from a seed), then runs ``chip_smoke.dryrun_serving`` (18a, 18c:
a prefill and a decode cell of 4096-token prompts and caches at the
largest batch whose dry-run peak is at most 70 GiB, predicted on ``meta``
and run on the card under the op-level analyzer, the counts exactly equal,
the peaks within tolerance, the roofline, MFU and useful-FLOP ratio of
each step, and the dispatch audit: clean, and an injected ``.item()``
flagged), frees the weights, and runs ``chip_smoke.dryrun_training``
(18b: a train step at phase 13d's cut, predicted and measured; 18d: the
lint).  Prints the records as JSON; exits non-zero when a check fails.
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
        print("dryrun_phase: no CUDA device", file=sys.stderr)
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
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.load()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = get_config("moonshot-v1-16b-a3b")
    params = tf.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    cs.log(f"weights built in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    serving = cs.dryrun_serving(dev, params, cfg, smi)
    del params
    torch.cuda.empty_cache()
    train = cs.dryrun_training(dev, smi)
    cs.log(json.dumps({"serving": serving, "train": train}, default=str))
    cs.log(f"phase 18 passed in {time.perf_counter() - t1:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
