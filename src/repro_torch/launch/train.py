"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --preset tiny --steps 200 --ckpt-dir build/train_ckpt

Counterpart of ``repro.launch.train``, with the same flags and
``--device`` (default: the card; ``cpu`` runs the kernels' plain
versions; without a card and without ``--device cpu`` it raises).  Wires
together config → model init → AdamW → the deterministic data pipeline →
the fault-tolerant loop (async checkpoints, NaN guard, restart), with
torch's deterministic algorithms on, so that a restart from a checkpoint
continues byte-exact.
``--preset tiny`` trains the reduced same-family config; ``--preset full``
the published widths.

``--mesh host`` trains over every rank the launcher starts, the
reference's host mesh ``(1, world)`` (one EP group; the expert slots over
its ranks): NCCL with one card a rank, or gloo with ``--device cpu``::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh host
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh host \
        --device cpu

Every rank draws the same global batches and trains its shard (the FSDP
layout, ``models.transformer``), prints the same losses, and checkpoints
collectively; rank 0 prints the summary.  ``single_pod`` and
``multi_pod`` (TPU pod slices) are refused.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ReaLBConfig, TrainConfig, get_config, reduced
from repro_torch.core import ep_moe
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.launch.mesh import init_distributed, mesh_for
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.models.common import (DTYPES, is_expert_path,
                                       resolve_device, tree_items, use_mesh)
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import TrainLoop

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_train_ckpt"


def build(arch: str, preset: str, batch: int, seq: int, tcfg: TrainConfig,
          rcfg: ReaLBConfig, mesh=None, device=None, cfg=None):
    """(cfg, state, step_fn): ``state`` holds ``params``, ``opt`` (an
    ``OptState``) and ``m`` (the AIMD state); ``step_fn(state, np_batch)
    -> (state, metrics)`` puts a numpy batch on the device, takes one train
    step and returns its metrics as floats.  ``cfg`` replaces the
    registry's config of ``arch``/``preset`` when given.  ``mesh`` (a
    ``models.common.Mesh``; every rank calls this): the state is the
    rank's shard in the FSDP layout, on its device, and ``step_fn`` takes
    the global batch and runs under the mesh."""
    if cfg is None:
        cfg = get_config(arch)
        if preset == "tiny":
            cfg = reduced(cfg)
    device = resolve_device(mesh.device if device is None and mesh
                            is not None else device)
    params = tf.init_model(cfg, seed=tcfg.seed, device=device, mesh=mesh,
                           fsdp=mesh is not None)
    opt = adamw.init_opt_state(params, tcfg)
    groups, ep = ep_moe.moe_state_shape(mesh, batch)
    m_state = torch.full((groups, ep), rcfg.md_init, dtype=torch.float32,
                         device=device)
    step = make_train_step(cfg, rcfg, tcfg)

    def step_fn(state, np_batch):
        b = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in np_batch.items()}
        # the cross-attention layers' memory: zeros where the batch has none
        mem = {"vision_embeds": (cfg.family == "vlm", cfg.n_vision_tokens),
               "enc_embeds": (cfg.is_encdec, cfg.enc_seq_len)}
        for k, (wanted, rows) in mem.items():
            if wanted and k not in b:
                b[k] = torch.zeros((batch, rows, cfg.d_model),
                                   dtype=DTYPES[cfg.param_dtype],
                                   device=device)
        with use_mesh(mesh):
            params, opt, m2, metrics = step(state["params"], state["opt"],
                                            state["m"], b)
        metrics = {k: float(v) for k, v in metrics.items()}
        return {"params": params, "opt": opt, "m": m2}, metrics

    state = {"params": params, "opt": opt, "m": m_state}
    return cfg, state, step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "single_pod", "multi_pod"])
    ap.add_argument("--multimodal", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; cpu: "
                         "the plain versions)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh != "none":
        if args.mesh == "host":
            init_distributed(args.device or "cuda")
        mesh = mesh_for(args.mesh, device=None if args.device in (None, "cuda")
                        else args.device)
    # a restart resumes byte-exact only if every step is deterministic: the
    # backward of a gather accumulates repeated indices (the embedding, the
    # MoE dispatch), which threads (CPU) or atomics may add in any order
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)

    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                       total_steps=args.steps,
                       checkpoint_every=args.checkpoint_every)
    rcfg = ReaLBConfig()
    cfg, state, step_fn = build(args.arch, args.preset, args.batch,
                                args.seq, tcfg, rcfg, mesh=mesh,
                                device=args.device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=tcfg.seed)
    loop = TrainLoop(step_fn, ckpt_dir=args.ckpt_dir,
                     checkpoint_every=args.checkpoint_every, mesh=mesh,
                     spec=tf.model_spec(cfg))
    start, state = loop.restore_or_init(state)
    data = DataLoader(dc, multimodal=args.multimodal,
                      d_model=cfg.d_model if args.multimodal else 0,
                      start_step=start)
    t0 = time.perf_counter()
    state = loop.run(state, data, args.steps, start_step=start)
    dt = time.perf_counter() - t0
    # the global count: each expert shard stands for every rank's
    n_ranks = 1 if mesh is None else mesh.size("data") * mesh.size("model")
    n_params = sum(p.numel() * (n_ranks if is_expert_path(path) else 1)
                   for path, p in tree_items(state["params"]))
    if mesh is not None and mesh.device_mesh.get_rank() != 0:
        return 0
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({n_params / 1e6:.1f}M params)")
    if mesh is not None:
        print(f"mesh {mesh.size('data')}x{mesh.size('model')} "
              f"({mesh.backend}), {n_ranks} ranks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
