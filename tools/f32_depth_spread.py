#!/usr/bin/env python3
"""How fast a random stack at its published widths turns chaotic in f32.

    PYTHONPATH=src python3 tools/f32_depth_spread.py --arch qwen1.5-0.5b \
        --layers 1,2,4,8,24 [--vocab 8192] [--device cpu]
    python3 tools/f32_depth_spread.py --arch llama-3.2-vision-90b \
        --layers 5,10
    python3 tools/f32_depth_spread.py --arch whisper-large-v3 \
        --layers 2,32 --enc-layers 2,32 --vocab 0

For each depth, an f32 copy of ``--arch`` cut to that many layers (random
weights from seed 0; the vocabulary cut to ``--vocab`` to keep it small, 0
keeps the model's) runs ``chip_smoke.consistency_f32``'s check on B = 2,
s = 48: decode(token s | cache of s) against prefill(s + 1), and the
model's own change in prefill(s + 1) when its embedding moves by two f32
ulps.  A stack with cross-attention layers gets its memory too, moved by
the same two ulps: a VLM's ``n_vision_tokens`` rows of vision embeds
(normal, sigma 0.02) in front of the s + 1 tokens, an encoder-decoder's
``enc_seq_len`` frames (normal, sigma 1) through ``--enc-layers`` encoder
layers (one a depth, paired with ``--layers``).  Both are printed as
shares of the reference's bound ``2e-3 + 2e-3 x |logit|`` at the worst
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
    ap.add_argument("--enc-layers", default="",
                    help="encoder layers, one a depth of --layers")
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from repro_torch.configs import ReaLBConfig, get_config
    from repro_torch.models import transformer as tf

    dev = torch.device(args.device)
    rcfg = ReaLBConfig(gate_gamma=512, md_init=0.0, adaptive=False)
    b, s = 2, 48
    depths = [int(x) for x in args.layers.split(",")]
    encs = [int(x) for x in args.enc_layers.split(",")] if args.enc_layers \
        else [0] * len(depths)
    for n, n_enc in zip(depths, encs):
        cut = dict(n_layers=n, param_dtype="float32")
        if args.vocab:
            cut["vocab_size"] = args.vocab
        if get_config(args.arch).is_encdec:
            cut["n_enc_layers"] = n_enc
        cfg = dataclasses.replace(get_config(args.arch), **cut)
        p = tf.init_model(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        nv = cfg.n_vision_tokens if cfg.family == "vlm" else 0
        toks = torch.randint(0, cfg.vocab_size, (b, nv + s + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        mem = {}
        if nv:
            mem["vision_embeds"] = torch.randn(
                (b, nv, cfg.d_model), generator=gen, device=dev) * 0.02
        if cfg.is_encdec:
            mem["enc_embeds"] = torch.randn(
                (b, cfg.enc_seq_len, cfg.d_model), generator=gen, device=dev)
        m0 = torch.zeros((1, 4), device=dev)
        last = nv + s
        with torch.no_grad():
            def prefill(k, f=1.0):
                return tf.prefill_forward(
                    p, cfg, rcfg, {"tokens": toks[:, :k],
                                   **{n: v * f for n, v in mem.items()}},
                    m0, cache_len=last + 1)
            ref = prefill(last + 1).logits
            pre = prefill(last)
            dec = tf.decode_forward(p, cfg, rcfg, {
                "tokens": toks[:, last:],
                "pos": torch.full((b,), last, dtype=torch.int32,
                                  device=dev)},
                pre.cache, pre.m_state).logits
            del pre
            bound = 2e-3 + 2e-3 * ref.abs()
            embed, spread = p["embed"], 0.0
            for f in (1 + 2.0 ** -22, 1 - 2.0 ** -22):
                p["embed"] = embed * f
                spread = max(spread, float(
                    ((prefill(last + 1, f).logits - ref).abs() / bound)
                    .max()))
            p["embed"] = embed
        gap = float(((dec - ref).abs() / bound).max())
        depth = f"{n} layers" + (f" ({n_enc} encoder)" if cfg.is_encdec
                                 else "")
        print(f"{args.arch} {depth}: max |logit| "
              f"{float(ref.abs().max()):.4g}; shares of the bound: "
              f"decode/prefill gap {gap:.4g}, change under two ulps of the "
              f"embedding {spread:.4g}", flush=True)
        del p, embed, mem
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
