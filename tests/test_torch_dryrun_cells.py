"""``python -m repro_torch.launch.dryrun`` at the published widths: a
record of the stated schema, a pinned ``does_not_fit`` cell, and the
sweep's skipped records and resumption."""
import json

import pytest

from repro_torch.configs import all_cells, hw
from repro_torch.launch import dryrun

RECORD_KEYS = {
    "arch", "shape", "mesh", "params", "active_params", "status",
    "n_devices", "mesh_shape", "memory", "flops_per_device",
    "bytes_per_device", "collective_bytes_per_device", "collective_by_kind",
    "census", "kernels", "top_collectives", "top_traffic", "n_ops",
    "build_s", "roofline", "hardware", "hbm_bytes", "per_device_bytes",
    "model_flops_global", "flops_global", "useful_flop_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes"}


def _cell(tmp_path, arch, shape, mesh):
    assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                        "--outdir", str(tmp_path)]) == 0
    return json.loads(dryrun.out_path(tmp_path, arch, shape, mesh)
                      .read_text())


def test_decode_cell_record(tmp_path):
    """falcon-mamba-7b × long_500k × single_pod (a batch of 1 over 16 data
    rows, which used to raise): a decode cell that fits, its record of the
    stated schema."""
    rec = _cell(tmp_path, "falcon-mamba-7b", "long_500k", "single_pod")
    assert set(rec) == RECORD_KEYS, set(rec) ^ RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 256 and rec["mesh_shape"] == [16, 16]
    assert rec["per_device_bytes"] == rec["memory"]["peak_bytes"] \
        <= rec["hbm_bytes"] == hw.H100_SXM.hbm_bytes
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "dominant", "bound_s",
                                    "roofline_fraction"}
    assert rec["useful_flop_ratio"] == pytest.approx(
        rec["model_flops_global"] / rec["flops_global"])
    # no MoE layer, so nothing crosses the mesh in the port's layout
    assert rec["census"] == {} and rec["collective_bytes_per_device"] == 0
    assert rec["kernels"] == {}


def test_vlm_train_cell_does_not_fit(tmp_path):
    """llama-3.2-vision-90b × train_4k × single_pod: the port replicates
    the dense part of the model on every device, so its ~90 B dense
    parameters and their moments alone exceed one card.  Pinned until a
    layout that shards the dense part flips it."""
    rec = _cell(tmp_path, "llama-3.2-vision-90b", "train_4k", "single_pod")
    assert rec["status"] == "does_not_fit"
    assert rec["per_device_bytes"] > rec["hbm_bytes"]
    assert rec["memory"]["argument_bytes"] > rec["hbm_bytes"]


def test_sweep_writes_skipped_records_and_resumes(tmp_path, monkeypatch):
    """``--all``: the unsupported cells' records written by the sweep
    itself, every cell with a record left alone (nothing to run)."""
    for arch, shape, ok, _ in all_cells():
        if ok:
            for mesh in dryrun.MESHES:
                dryrun.out_path(tmp_path, arch, shape, mesh).write_text("{}")
    ran = []
    monkeypatch.setattr(dryrun.subprocess, "run",
                        lambda *a, **k: ran.append(a))
    assert dryrun.main(["--all", "--outdir", str(tmp_path)]) == 0
    assert ran == []
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 80
    skipped = [r for r in recs if r.get("status") == "skipped"]
    assert len(skipped) == 16
    assert {r["shape"] for r in skipped} == {"long_500k"}
    assert all("full-attention" in r["reason"] for r in skipped)
