"""Dry run of the port's production cells: every (architecture × input
shape × mesh) cell built on ``meta`` under an abstract production mesh.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 256 or 512 placeholder devices.  Here a cell's step runs once on
``meta`` tensors at the published widths, under the abstract 16×16 or
2×16×16 mesh (rank 0's coordinates; see ``launch.mesh``), in the
tensor-parallel layout of the default rules (``models.layout``), through the
op-level analyzer (``launch.op_analysis``): nothing is allocated, no
collective moves, no card is needed.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch olmoe-1b-7b --shape train_4k --mesh single_pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]

Each cell writes a JSON record under ``experiments/dryrun_torch/`` (not
the reference's ``experiments/dryrun/``).  ``--all`` runs one subprocess a
cell, skips cells whose record exists (the sweep resumes) and writes the
unsupported cells' records itself.

A record keeps the reference's fields where they mean the same:
``memory`` (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
``alias_bytes``, and ``peak_bytes``), ``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``,
``collective_by_kind``, ``top_collectives``, ``top_traffic``,
``roofline`` (at the H100 SXM record, links at ``MIGRATION_BW_DEFAULT``),
``model_flops_global`` and ``useful_flop_ratio`` (model FLOPs over the
analyzer's FLOPs times the devices); ``build_s`` replaces ``lower_s`` and
``compile_s``.  ``status`` is ``ok``; ``skipped`` (with the reason) for a
cell the reference does not run; ``does_not_fit`` when the per-device
peak exceeds the card's memory (``per_device_bytes`` beside
``hbm_bytes``); ``error`` when the build raised, which the sweep must not
produce.  The figures are predictions priced at a card's data sheet, not
measurements.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

OUTDIR = "experiments/dryrun_torch"
MESHES = ("single_pod", "multi_pod")


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    """Build one cell on ``meta`` and return its record."""
    from repro_torch.configs import (get_config, get_shape, hw,
                                     shape_supported)
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.launch.steps import lower_cell

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = mesh_for(mesh_kind, abstract=True)
    n_dev = mesh.size(None)
    cell = lower_cell(cfg, shape, mesh)
    card = hw.H100_SXM
    flops_global = cell["flops_per_device"] * n_dev
    mf = roofline.model_flops(cfg, shape)
    peak = cell["memory"]["peak_bytes"]
    rec.update(
        status="ok" if peak <= card.hbm_bytes else "does_not_fit",
        n_devices=n_dev, mesh_shape=list(mesh.shape.values()),
        **cell,
        roofline=roofline.roofline_terms(
            cell["flops_per_device"], cell["bytes_per_device"],
            cell["collective_bytes_per_device"], card),
        hardware=card.name, hbm_bytes=card.hbm_bytes,
        per_device_bytes=peak,
        model_flops_global=mf,
        flops_global=flops_global,
        useful_flop_ratio=(mf / flops_global) if flops_global else 0.0)
    return rec


def out_path(outdir: pathlib.Path, arch: str, shape: str, mesh: str
             ) -> pathlib.Path:
    return outdir / f"{arch}__{shape}__{mesh}.json"


def sweep(outdir: pathlib.Path, jobs: int, force: bool) -> int:
    """Every cell × both meshes, one subprocess a cell, ``jobs`` at once;
    cells with a record are skipped unless ``force``."""
    from repro_torch.configs import all_cells
    cmds = []
    for arch, shape, ok, why in all_cells():
        for mesh in MESHES:
            path = out_path(outdir, arch, shape, mesh)
            if path.exists() and not force:
                continue
            if not ok:
                path.write_text(json.dumps(
                    {"arch": arch, "shape": shape, "mesh": mesh,
                     "status": "skipped", "reason": why}, indent=1))
                continue
            cmds.append([sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--arch", arch, "--shape", shape, "--mesh", mesh,
                         "--outdir", str(outdir)])

    def one(cmd):
        r = subprocess.run(cmd, capture_output=True, text=True)
        print(f"=== {' × '.join(cmd[4:9:2])}: rc {r.returncode}", flush=True)
        if r.returncode:
            print(r.stderr[-2000:], flush=True)
        return r.returncode

    with ThreadPoolExecutor(max(1, jobs)) as pool:
        rcs = list(pool.map(one, cmds))
    return 1 if any(rcs) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single_pod", choices=MESHES)
    ap.add_argument("--all", action="store_true",
                    help="sweep every cell x both meshes, one subprocess each")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells built at once")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        return sweep(outdir, args.jobs, args.force)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    try:
        rec = run_cell(args.arch, args.shape, args.mesh)
    except Exception as e:      # recorded for the sweep's summary
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(rec["error"], file=sys.stderr)
    out_path(outdir, args.arch, args.shape, args.mesh).write_text(
        json.dumps(rec, indent=1))
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("traceback", "top_traffic",
                                   "top_collectives", "census", "kernels")},
                     indent=1))
    return 0 if rec["status"] in ("ok", "skipped", "does_not_fit") else 1


if __name__ == "__main__":
    sys.exit(main())
