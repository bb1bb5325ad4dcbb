#!/usr/bin/env python3
"""Runs ``chip_smoke.py``'s phase 20 without the rest of the smoke:
placement, replication, live migration and elastic serving under the
default rules (the reference's layout) on a ``(2, 2)`` mesh.

    python3 tools/layout_ep_phase.py

Builds the kernels, then runs what the smoke runs: phase 19
(``chip_smoke.tp_layout(..., phase20=True)``), whose four rank processes
on the card (the ``staged`` backend, the default rules) go on to phase
20's work, and ``chip_smoke.layout_ep_serving``'s checks across them:
moonshot-v1-16b-a3b at its published widths cut to
``chip_smoke.PHASE20_LAYERS`` layers (each expert slot's D cut over
``data``), each arm on phase 5's first ``chip_smoke.PHASE20_REQUESTS``
requests cut to ``chip_smoke.PHASE20_MAX_NEW`` new tokens: (a) a shared
placement table migrating synchronously, then gathered back to the
identity; (b) per-layer tables drained asynchronously; (c) a per-layer
replica manager with ``chip_smoke.PHASE20_C_SPARES`` spares a rank, the
engine's checkpoint, model rank 1 killed and rejoined.  The work stays
under the ``__main__`` check: the spawned ranks import this module
again.  Exits non-zero when a check of either phase fails.
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
        print("layout_ep_phase: no CUDA device", file=sys.stderr)
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
    dev = torch.device("cuda")
    *_, ranks = cs.tp_layout(dev, smi, phase20=True)
    p20 = cs.layout_ep_serving(dev, smi, ranks)
    cs.log(json.dumps({"layout_ep_launches": p20["counts"],
                       "layout_ep_working_launches": p20["working"]}))
    cs.log(f"phases 19 and 20 passed in {time.perf_counter() - t0:.1f} s; "
           f"{smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
