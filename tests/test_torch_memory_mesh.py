"""The memory of the cross-attention stacks under a ``(data, model)``
mesh: reduced llama-3.2-vision-90b (its vision embeddings) and reduced
whisper-large-v3 (its frame embeddings, through the encoder) trained on a
``(2, 1)`` mesh of spawned gloo ranks, each data rank on its two rows of
a 4-row batch, against the port's one-device ``train_loss`` on the whole
batch: the same loss (the global masked mean) and, after the
data-parallel reduction, the same gradient within the spread tolerance of
``_torch_arch.py``.  A rank that attended to another row's memory would
not match, so this shows the memory rows are cut with the token rows.
One module fixture spawns the ranks once for both archs
(``_torch_ep_workers.memory_train_mesh_cases``).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_arch as ta
from _torch_dist import run_ranks
from _torch_ep_workers import memory_train_mesh_cases
from repro_torch.configs import ReaLBConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.optim.grad_utils import value_and_grad

ARCHS = ("llama-3.2-vision-90b", "whisper-large-v3")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(model, rng):
    tokens = rng.integers(0, model.cfg_t.vocab_size, (4, 16)).astype(np.int32)
    labels = tokens.copy()
    labels[rng.random((4, 16)) < 0.25] = -1
    return {"tokens": tokens, "labels": labels,
            **ta.memory_batch(model.cfg_t, rng, 4)}


def _one_device(model, batch):
    """The port's one-device loss and gradient on ``batch``, and its
    gradients when the embedding and the memory move by two f32 ulps."""
    def run(params, b):
        (loss, _), g = value_and_grad(
            ttf.train_loss, params, model.cfg_t, ReaLBConfig(),
            ta.torch_batch(b), torch.full((1, 1), 0.9))
        return float(loss), ta.flat(g)
    loss, grads = run(model.tparams, batch)
    moved = [run(params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), b)[1]
             for p, b in zip(model.perturbed(), ta.perturbed_batches(batch))]
    return loss, grads, moved


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    models = {a: ta.Model(a) for a in ARCHS}
    batches = {a: _batch(m, np.random.default_rng(11))
               for a, m in models.items()}
    outs = run_ranks(memory_train_mesh_cases, (2, 1), {
        a: {"params": models[a].npp, "batch": batches[a]} for a in ARCHS},
        tmp_path_factory.mktemp("memory_mesh"))
    return models, batches, outs


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_rows_follow_the_token_rows_under_a_mesh(mesh_runs, arch):
    models, batches, outs = mesh_runs
    loss, grads, moved = _one_device(models[arch], batches[arch])
    for rank, out in enumerate(outs):
        r = out[arch]
        assert "error" not in r, r.get("error")
        assert r["m_rows"] == 2, rank
        np.testing.assert_allclose(r["loss"], loss, rtol=ta.RTOL)
        assert set(ta.flat(r["grads"])) == set(grads)
        got = ta.flat(r["grads"])
        for name, g in grads.items():
            ta.within_spread(g, got[name], [mv[name] for mv in moved],
                             f"rank {rank} grad {name}", tol=ta.ATOL_REL)
