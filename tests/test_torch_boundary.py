"""The port's package boundary: ``repro_torch``, ``chip_smoke.py`` and the
card's scripts under ``tools/`` import neither ``jax`` nor anything of the
JAX package, and the port's entry points never fall back to the CPU on
their own."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_leaves_jax_and_repro_out():
    """In a fresh interpreter (this one already holds jax), importing every
    module of the port loads neither jax nor the reference package."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
        " or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_scan_covers_the_host_side_copies():
    """The copies of jax-free reference modules (whose reference packages
    import jax on import) are in both scans, with the engine using them."""
    mods = _port_modules()
    for m in ("repro_torch.obs", "repro_torch.obs.metrics",
              "repro_torch.obs.trace",
              "repro_torch.serving.telemetry", "repro_torch.workloads.replay",
              "repro_torch.checkpoint.ckpt", "repro_torch.serving.engine",
              "repro_torch.serving.async_migrate",
              "repro_torch.placement", "repro_torch.placement.table",
              "repro_torch.placement.predictor",
              "repro_torch.placement.planner",
              "repro_torch.placement.migrate",
              "repro_torch.placement.manager", "repro_torch.replication",
              "repro_torch.replication.replica_set",
              "repro_torch.replication.planner",
              "repro_torch.replication.migrate",
              "repro_torch.replication.manager",
              "repro_torch.configs.hw", "repro_torch.obs.audit",
              "repro_torch.obs.ledger", "repro_torch.obs.profiler",
              "repro_torch.analysis", "repro_torch.analysis.sentinel",
              "repro_torch.runtime", "repro_torch.runtime.fault_tolerance",
              "repro_torch.runtime.elastic",
              "repro_torch.serving.elastic", "repro_torch.launch",
              "repro_torch.launch.serve", "repro_torch.launch.mesh",
              "repro_torch.models.common",
              "repro_torch.configs.olmoe_1b_7b",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.grad_utils", "repro_torch.launch.train",
              "repro_torch.launch.steps", "repro_torch.launch.roofline",
              "repro_torch.launch.op_analysis", "repro_torch.launch.dryrun",
              "repro_torch.kernels.cost", "repro_torch.analysis.lint",
              "repro_torch.analysis.dispatch_audit"):
        assert m in mods, m
    paths = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    assert "src/repro_torch/checkpoint/ckpt.py" in paths
    assert "src/repro_torch/launch/mesh.py" in paths


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no card and no device named, the entry points raise."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as tf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_cache(cfg, 2, 16)
    from repro_torch.configs import ReaLBConfig, TrainConfig
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build("moonshot-v1-16b-a3b", "tiny", 2, 8, TrainConfig(),
                    ReaLBConfig())


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; a CPU tensor is refused."""
    from repro_torch.kernels import fp4_matmul, grouped_fp4_ffn, quantize_fp4
    w = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_fp4.quantize_fp4_cuda(w, torch.ones(()))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_fp4.global_scale_cuda(w)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_fp4_ffn.grouped_fp4_ffn_cuda(
            torch.zeros(4, 32), torch.tensor([4, 0]),
            *([torch.zeros(1)] * 7))
    with pytest.raises(ValueError, match="CUDA"):
        grouped_fp4_ffn.grouped_ffn_cuda(
            torch.zeros(4, 32), torch.tensor([4, 0]),
            *([torch.zeros(2, 32, 32)] * 3))
    with pytest.raises(ValueError, match="CUDA"):
        grouped_fp4_ffn.grouped_ffn_bwd_cuda(
            torch.zeros(4, 32), torch.tensor([4, 0]),
            *([torch.zeros(2, 32, 32)] * 3), torch.zeros(4, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fp4_matmul.fp4_matmul_cuda(
            torch.zeros(4, 32), torch.zeros(8, 16, dtype=torch.uint8),
            torch.zeros(8, 2), torch.ones(()))


def test_mesh_modules_import_without_a_process_group():
    """The mesh helpers import nothing distributed at module level: in a
    fresh interpreter, importing them leaves ``torch.distributed`` without
    a process group and builds no mesh."""
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import mesh\n"
        "from repro_torch.models import common\n"
        "assert common.current_mesh() is None\n"
        "assert not dist.is_initialized()\n"
        "try:\n"
        "    mesh.mesh_for('host')\n"
        "except RuntimeError as err:\n"
        "    assert 'torchrun' in str(err)\n"
        "else:\n"
        "    raise SystemExit('a host mesh without ranks')\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
