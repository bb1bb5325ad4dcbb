"""The port's fault-tolerant training loop and training driver: the
counterparts of ``tests/test_runtime.py``'s loop tests (checkpoint cadence,
the NaN guard, restart), a byte-exact restart of real training, the
driver run twice to a checkpoint as ``examples/train_tiny_mmoe.py`` runs
the reference's, the driver's refusals, and an optimizer state's
checkpoint read by either package."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import TrainConfig as JTrain
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ReaLBConfig, TrainConfig
from repro_torch.convert import opt_state_from_numpy
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.launch import train
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import TrainLoop

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk_step(poison_at=None):
    def step_fn(state, batch):
        s = state["x"]
        loss = float(torch.sum(s)) * 0 + float(batch["v"])
        if poison_at is not None and batch["step"] in poison_at:
            loss = float("nan")
        return {"x": s + 1}, {"loss": loss}
    return step_fn


def _data(n):
    for i in range(n):
        yield {"v": 1.0 + 0.01 * i, "step": i}


def _loop(d, step_fn, **kw):
    kw = {"checkpoint_every": 5, "log_every": 1000, **kw}
    return TrainLoop(step_fn, ckpt_dir=str(d), logger=lambda *_: None, **kw)


def test_loop_checkpoints_and_finishes(tmp_path):
    state = _loop(tmp_path, _mk_step()).run({"x": torch.zeros(3)},
                                            iter(_data(100)), 12)
    assert float(state["x"][0]) == 12
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005", "step_00000010", "step_00000012"]


def test_nan_guard_skips_poisoned_update(tmp_path):
    loop = _loop(tmp_path, _mk_step(poison_at={4}), checkpoint_every=100,
                 nan_tolerance=10)
    state = loop.run({"x": torch.zeros(1)}, iter(_data(100)), 8)
    assert float(state["x"][0]) == 8     # 8 good updates; the poisoned one
    #                                      was dropped


def test_nan_guard_rolls_back_after_tolerance(tmp_path):
    """Three poisoned batches in a row (at tolerance 3) roll the state back
    to the last checkpoint (step 5) and training resumes from there."""
    logs = []
    loop = TrainLoop(_mk_step(poison_at={7, 8, 9}), ckpt_dir=str(tmp_path),
                     checkpoint_every=5, nan_tolerance=3, log_every=1000,
                     logger=logs.append)
    state = loop.run({"x": torch.zeros(1)}, iter(_data(100)), 10)
    # steps 0-6 good (x = 7), 7-9 poisoned -> back to the step-5 state
    # (x = 5), then 5 more good batches to step 10
    assert float(state["x"][0]) == 10
    assert any("rolled back to step 5" in line for line in logs)


def test_restart_resumes_from_checkpoint(tmp_path):
    _loop(tmp_path, _mk_step()).run({"x": torch.zeros(1)},
                                    iter(_data(100)), 10)
    loop2 = _loop(tmp_path, _mk_step())
    start, state = loop2.restore_or_init({"x": torch.zeros(1)})
    assert start == 10
    state = loop2.run(state, iter(_data(100)), 15, start_step=start)
    assert float(state["x"][0]) == 15


def _train(ckpt_dir, steps, total, start_from_ckpt):
    """acc_proxy-like training of tiny moonshot through ``launch.train``'s
    build and the loop; returns the state and the losses logged."""
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=total)
    cfg, state, step_fn = train.build("moonshot-v1-16b-a3b", "tiny", 4, 16,
                                      tcfg, ReaLBConfig(enabled=False),
                                      device="cpu")
    losses = []

    def logged(state, batch):
        new, met = step_fn(state, batch)
        losses.append(met["loss"])
        return new, met

    loop = TrainLoop(logged, ckpt_dir=str(ckpt_dir), checkpoint_every=3,
                     log_every=1000, logger=lambda *_: None)
    start = 0
    if start_from_ckpt:
        start, state = loop.restore_or_init(state)
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                 global_batch=4), multimodal=True,
                      d_model=cfg.d_model, start_step=start)
    return loop.run(state, data, steps, start_step=start), losses


def test_restart_of_training_is_byte_exact(tmp_path):
    """Training preempted at step 3 and restarted from its checkpoint ends
    with the state of an uninterrupted run, bit for bit, with the same
    losses at the steps after the restart."""
    full, loss_full = _train(tmp_path / "a", 6, 6, False)
    _train(tmp_path / "b", 3, 6, False)
    resumed, loss_resumed = _train(tmp_path / "b", 6, 6, True)
    assert loss_resumed == loss_full[3:]
    for a, b in zip(tree_leaves(full["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(full["opt"].mu),
                    tree_leaves(resumed["opt"].mu)):
        assert torch.equal(a, b)
    assert int(resumed["opt"].step) == 6
    assert torch.equal(full["m"], resumed["m"])


def test_driver_tiny_twice_to_a_checkpoint(tmp_path):
    """``python -m repro_torch.launch.train --preset tiny --device cpu``
    to step 6, then again to step 12 from the checkpoint (a simulated
    preemption, as ``examples/train_tiny_mmoe.py`` does)."""
    # one thread: the suite runs a worker per core beside this process
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["--preset", "tiny", "--device", "cpu", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--checkpoint-every", "3",
            "--multimodal"]
    for steps, expect in (("6", "done: 6 steps"), ("12", "done: 6 steps")):
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                              "--steps", steps, *args], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert expect in out.stdout, out.stdout
        assert "jax" not in out.stderr
    assert "[ft] restored checkpoint at step 6" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 12


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "gemma-7b", "qwen1.5-0.5b",
                                  "command-r-35b", "minicpm3-4b",
                                  "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_driver_tiny_trains_every_arch(tmp_path, arch, capsys):
    """``launch.train --arch ... --preset tiny --device cpu`` trains the
    Mamba, hybrid, dense, MLA, cross-attention and encoder-decoder stacks
    (the last two on zero memory, as the reference's launcher fills it):
    finite logged losses (the loop logs every 10 steps), a checkpoint at
    the last step."""
    assert train.main(["--arch", arch, "--preset", "tiny", "--device", "cpu",
                       "--steps", "10", "--batch", "2", "--seq", "16",
                       "--checkpoint-every", "10", "--ckpt-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert losses and all(np.isfinite(losses)), out
    assert "done: 10 steps" in out, out
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_driver_without_a_card_raises(tmp_path, monkeypatch):
    """Without ``--device`` the driver trains on the card; with none it
    raises and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "tiny", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    assert ckpt.latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("mesh", ["host", "single_pod", "multi_pod"])
def test_driver_refuses_a_mesh(tmp_path, mesh):
    """``--mesh host`` needs the ranks a launcher starts (it trains under
    ``torchrun``: ``test_torch_train_mesh.py``); the TPU pod slices are
    refused by name."""
    err, match = ((RuntimeError, "torchrun") if mesh == "host"
                  else (NotImplementedError, "TPU pod slice"))
    with pytest.raises(err, match=match):
        train.main(["--preset", "tiny", "--device", "cpu", "--mesh", mesh,
                    "--ckpt-dir", str(tmp_path)])


def test_opt_state_checkpoint_loads_in_either_package(tmp_path):
    """An ``OptState`` saved by the port loads into the reference's
    template, and one saved by the reference into the port's (the
    NamedTuple's fields keyed ``.step``, ``.mu``, ``.nu``)."""
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
         "n": {"b": rng.normal(0, 1, (4,)).astype(np.float32)}}
    sj = jadamw.init_opt_state(jax.tree.map(jnp.asarray, p), JTrain())
    sj = sj._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda a: a + 1.5, sj.mu))
    st = opt_state_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
    ckpt.save(str(tmp_path / "t"), 1, {"opt": st})
    _, back = jckpt.restore(str(tmp_path / "t"), {"opt": sj})
    for a, b in zip(jax.tree.leaves(back["opt"]), jax.tree.leaves(sj)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jckpt.save(str(tmp_path / "j"), 1, {"opt": sj})
    _, mine = ckpt.restore(str(tmp_path / "j"), {"opt": st})
    opt = mine["opt"]
    assert isinstance(opt, adamw.OptState)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 7
    for tree_t, tree_j in ((opt.mu, sj.mu), (opt.nu, sj.nu)):
        for a, b in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            assert np.array_equal(a.numpy(), np.asarray(b))
