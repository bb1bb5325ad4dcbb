"""``python -m repro_torch.launch.dryrun`` at the published widths: a
record of the stated schema, the cell the tensor-parallel layout flipped
to ``ok``, and the sweep's skipped records and resumption."""
import json

import pytest

from repro_torch.configs import all_cells, get_config, get_shape, hw
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_for
from repro_torch.obs.ledger import predict_layout_census

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
    # no MoE layer; the tensor-parallel layout's collectives (the Mamba
    # layers' channels over model, the weights' D over data, the
    # vocabulary-parallel embedding and logits), as predicted
    assert rec["census"] == predict_layout_census(
        get_config("falcon-mamba-7b"), mesh_for("single_pod", abstract=True),
        "decode", 1, 1, cache_len=get_shape("long_500k").seq_len)
    assert rec["collective_bytes_per_device"] > 0
    assert rec["kernels"] == {}


def test_vlm_train_cell_fits(tmp_path):
    """llama-3.2-vision-90b × train_4k × single_pod: the cell the
    replicated dense part kept off the card (its ~90 B dense parameters
    and their moments alone exceeded one) fits in the reference's layout:
    a device holds 1/256 of the bf16 parameters and the f32 moments (the
    weights' D dims over data, heads, FFN and vocabulary over model), its
    16 rows' activations sequence-parallel; its census the predicted
    one."""
    rec = _cell(tmp_path, "llama-3.2-vision-90b", "train_4k", "single_pod")
    assert rec["status"] == "ok"
    assert rec["per_device_bytes"] <= rec["hbm_bytes"]
    cfg = get_config("llama-3.2-vision-90b")
    # the arguments: the global batch (every rank takes it and keeps its
    # rows; its vision embeds alone are 6.7 GB) and this device's
    # parameters and f32 moments, 10 bytes a parameter over 256 devices
    # (a dim that does not divide stays whole: the KV heads over model)
    batch = 256 * 4096 * (4 + 4 + 1) + 256 * cfg.n_vision_tokens \
        * cfg.d_model * 2
    state = rec["memory"]["argument_bytes"] - batch
    assert 10 * cfg.param_count() / 256 < state \
        < 1.5 * 10 * cfg.param_count() / 256
    assert rec["census"] == predict_layout_census(
        cfg, mesh_for("single_pod", abstract=True), "train", 256, 4096)


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
