#!/usr/bin/env python3
"""How fast a random stack at its published widths turns chaotic in f32.

    PYTHONPATH=src python3 tools/f32_depth_spread.py --arch qwen1.5-0.5b \
        --layers 1,2,4,8,24 [--vocab 8192] [--device cpu]

For each depth, an f32 copy of ``--arch`` cut to that many layers (random
weights from seed 0; the vocabulary cut to ``--vocab`` to keep it small)
runs ``chip_smoke.consistency_f32``'s check on B = 2, s = 48: decode(token
s | cache of s) against prefill(s + 1), and the model's own change in
prefill(s + 1) when its embedding moves by two f32 ulps.  Both are printed
as shares of the reference's bound ``2e-3 + 2e-3 x |logit|`` at the worst
logit: where the change nears 1, no fixed bound can tell a fault from
rounding.  Runs on the card unless ``--device cpu``.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", default="1,2,4,8")
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from repro_torch.configs import ReaLBConfig, get_config
    from repro_torch.models import transformer as tf

    dev = torch.device(args.device)
    rcfg = ReaLBConfig(gate_gamma=512, md_init=0.0, adaptive=False)
    b, s = 2, 48
    for n in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(get_config(args.arch), n_layers=n,
                                  vocab_size=args.vocab,
                                  param_dtype="float32")
        p = tf.init_model(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        toks = torch.randint(0, args.vocab, (b, s + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        m0 = torch.zeros((1, 4), device=dev)
        with torch.no_grad():
            def prefill(k):
                return tf.prefill_forward(p, cfg, rcfg,
                                          {"tokens": toks[:, :k]}, m0,
                                          cache_len=s + 1)
            ref = prefill(s + 1).logits
            pre = prefill(s)
            dec = tf.decode_forward(p, cfg, rcfg, {
                "tokens": toks[:, s:],
                "pos": torch.full((b,), s, dtype=torch.int32, device=dev)},
                pre.cache, pre.m_state).logits
            bound = 2e-3 + 2e-3 * ref.abs()
            embed, spread = p["embed"], 0.0
            for f in (1 + 2.0 ** -22, 1 - 2.0 ** -22):
                p["embed"] = embed * f
                spread = max(spread, float(
                    ((prefill(s + 1).logits - ref).abs() / bound).max()))
            p["embed"] = embed
        gap = float(((dec - ref).abs() / bound).max())
        print(f"{args.arch} {n} layers: max |logit| "
              f"{float(ref.abs().max()):.4g}; shares of the bound: "
              f"decode/prefill gap {gap:.4g}, change under two ulps of the "
              f"embedding {spread:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
