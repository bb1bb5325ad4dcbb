"""The port's package boundary: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package, and the port's entry points
never fall back to the CPU on their own."""
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
              "repro_torch.replication.manager"):
        assert m in mods, m
    paths = {p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")}
    assert "src/repro_torch/checkpoint/ckpt.py" in paths


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
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
        fp4_matmul.fp4_matmul_cuda(
            torch.zeros(4, 32), torch.zeros(8, 16, dtype=torch.uint8),
            torch.zeros(8, 2), torch.ones(()))
