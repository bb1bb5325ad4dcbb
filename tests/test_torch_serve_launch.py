"""The port's serving driver, ``python -m repro_torch.launch.serve``: it
serves the tiny preset on the CPU and prints its summary (the lines the
reference prints), for the Mamba and hybrid architectures too (one-shot
prefill), and refuses a mesh it cannot build: the host mesh without
ranks to span (it serves under ``torchrun``, ``tests/test_torch_ep_model.py``)
and the TPU pod slices."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_serve_tiny_on_the_cpu_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--preset",
         "tiny", "--device", "cpu", "--requests", "6", "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert re.match(r"served 6 requests, \d+ prompt \+ 24 generated tokens",
                    lines[0]), lines
    assert lines[1].startswith("iterations: ") and "gate duty" in lines[1]
    assert lines[2].startswith("TTFT p50/p99: ")
    assert "jax" not in out.stderr


@pytest.mark.parametrize("arch", ["falcon-mamba-7b",
                                  "jamba-1.5-large-398b"])
def test_serve_tiny_mamba_and_hybrid_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--preset", "tiny", "--device",
                       "cpu", "--requests", "4", "--max-new", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"served 4 requests, \d+ prompt \+ 16 generated tokens",
                    lines[0]), lines
    assert "(prefill chunked=False)" in lines[1], lines


@pytest.mark.parametrize("arch,chunked", [("gemma-7b", True),
                                          ("qwen1.5-0.5b", True),
                                          ("command-r-35b", True),
                                          ("minicpm3-4b", False),
                                          ("whisper-large-v3", False)])
def test_serve_tiny_dense_and_mla_on_the_cpu(arch, chunked, capsys):
    """The dense configs prefill chunked; MLA one-shot (its latent cache is
    not continued mid-prompt), and whisper one-shot (its encoder runs on
    the zero memory of a request without frame embeds)."""
    assert serve.main(["--arch", arch, "--preset", "tiny", "--device",
                       "cpu", "--requests", "4", "--max-new", "4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"served 4 requests, \d+ prompt \+ 16 generated tokens",
                    lines[0]), lines
    assert f"(prefill chunked={chunked})" in lines[1], lines


@pytest.mark.parametrize("mesh", ["host", "single_pod", "multi_pod"])
def test_serve_refuses_a_mesh(mesh, monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    err, match = (RuntimeError, "torchrun") if mesh == "host" \
        else (NotImplementedError, "TPU pod slice")
    with pytest.raises(err, match=match):
        serve.main(["--preset", "tiny", "--device", "cpu", "--mesh", mesh])
