"""The port's training under a ``(data, model)`` mesh of spawned gloo
ranks against the reference's one-device ``jax.value_and_grad`` and the
port's own one-device step.

The recipe is the reference's ``tests/_dist_worker.py::
check_model_train_step_under_mesh`` (which cannot run on this jax: its
``shard_map(check_rep=)`` is refused): reduced olmoe-1b-7b at 2 layers
(d 128, 8 experts top-2, f32), the aux-loss coefficients 0 (the
load-balance loss is defined per EP group) and capacity factor 8 (no
drops), the gate closed, a batch of 4 x 16 tokens labelled by themselves,
the weights the reference's, passed through numpy.  On ``(2, 2)`` (FSDP:
each slot's D over the data rows) and ``(1, 4)``, one spawn a mesh
(``_torch_ep_workers.train_mesh_cases``) runs every rank-side check:

* the loss within 5e-3 of the reference's and every gradient leaf within
  5e-3 (the reference's own criterion), the expert shards assembled over
  the ranks;
* the same step against the port's one-device step: the loss at the model
  tolerance, each gradient leaf within ``test_torch_train.py``'s bound
  (the larger of ``ATOL_REL`` x its max and 4x the reference's own change
  when its embedding moves by two f32 ulps: training's conditioning);
* the FSDP layout's init against the one-device init's slices, the FSDP
  gather against the whole slab and its reduce-scatter against the rows'
  summed cotangents, bit for bit; ``global_norm`` under the mesh
  against one device; the step's collective census against the ledger's
  prediction;
* three AdamW steps (labels a quarter masked: the loss is the global
  masked mean, step 1's against the one-device step's): the replicated
  leaves bitwise equal on every rank; then a step whose loss is not
  finite on one rank writes nothing on any rank;
* on ``(2, 2)``'s two data ranks, ``compressed_grad_psum`` equals the sum
  of each rank's int8-dequantized leaf and ``g_hat + err == g``.

``compressed_all_reduce`` on a 1-rank mesh is held bit for bit against the
reference's on the inputs of ``tests/test_substrate.py``'s contract test,
and ``python -m repro_torch.launch.train --mesh host --device cpu`` runs on
two ranks.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_ep_workers import (compressed_one_rank, train_case, train_cfg,
                               train_mesh_cases)
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro_torch.configs import ReaLBConfig, TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as ttf
from repro_torch.models.common import tree_map
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import value_and_grad

MESHES = [(2, 2), (1, 4)]
CASE = dict(layers=2, moe=dict(aux_loss_coef=0.0, router_z_coef=0.0,
                               capacity_factor=8.0),
            rcfg=dict(gate_gamma=10 ** 9))
TOL = 5e-3                           # the reference's check
RTOL, ATOL_REL = 1e-4, 3e-5          # test_torch_train.py's, and why
SPREAD = 4.0
PERTURB = (1 + 2.0 ** -22, 1 - 2.0 ** -22)
MOE_KEYS = ("w_gate", "w_up", "w_down")
FSDP_DIM = {"w_gate": -2, "w_up": -2, "w_down": -1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    """The recipe's batch, then three with a quarter of the labels
    masked (rows unevenly)."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 16)).astype(np.int32)
    out = []
    for i in range(3):
        r = np.random.default_rng(10 + i)
        t = r.integers(0, 512, (4, 16)).astype(np.int32)
        lab = r.integers(0, 512, (4, 16)).astype(np.int32)
        lab[r.random((4, 16)) < 0.25 * (1 + np.arange(4))[:, None] / 2] = -1
        out.append({"tokens": t, "labels": lab})
    return {"tokens": tokens, "labels": tokens}, out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def reference():
    cfg_j = jreduced(jget("olmoe-1b-7b"), n_layers=2)
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
        cfg_j.moe, **CASE["moe"]))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    batch, batches = _batches()
    fn = jax.jit(jax.value_and_grad(partial(
        jtf.train_loss, cfg=cfg_j, rcfg=JCfg(**CASE["rcfg"]),
        batch=jax.tree.map(jnp.asarray, batch)), has_aux=True))
    m0 = jnp.full((1, 1), 0.9)
    (loss, _), grads = fn(params, m_state=m0)
    perturbed = [_flat(jax.tree.map(np.asarray, fn(
        {**params, "embed": params["embed"] * f}, m_state=m0)[1]))
        for f in PERTURB]
    npp = jax.tree.map(np.asarray, params)
    # the port on one device, same weights
    cfg_t = train_cfg(CASE)
    rcfg = ReaLBConfig(**CASE["rcfg"])
    tp = params_from_numpy(npp, "cpu")
    as_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa
    (l1, _), g1 = value_and_grad(ttf.train_loss, tp, cfg_t, rcfg,
                                 as_t(batch), torch.full((1, 1), 0.9))
    step = make_train_step(cfg_t, rcfg, TrainConfig(lr=1e-3,
                                                    warmup_steps=1))
    p1 = params_from_numpy(npp, "cpu")
    _, _, _, met = step(p1, adamw.init_opt_state(p1, TrainConfig()),
                        torch.full((1, 1), 0.9), as_t(batches[0]))
    return {"loss": float(loss), "grads": _flat(jax.tree.map(np.asarray,
                                                            grads)),
            "perturbed": perturbed, "params": npp,
            "port_loss": float(l1),
            "port_grads": _flat(tree_map(lambda t: t.numpy(), g1)),
            "port_gnorm": float(adamw.global_norm(g1)),
            "port_step_loss": float(met["loss"]),
            "batch": batch, "batches": batches}


_RANKS = {}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    def get(shape):
        if shape not in _RANKS:
            c = dict(CASE, params=reference["params"],
                     batch=reference["batch"], batches=reference["batches"])
            out = run_ranks(train_mesh_cases, shape, c,
                            tmp_path_factory.mktemp("train_mesh"))
            errors = [r["error"] for r in out if "error" in r]
            assert not errors, errors[0]
            _RANKS[shape] = out
        return _RANKS[shape]
    return get


def _assemble(outs, shape):
    """The global gradient tree from every rank's (the expert shards put
    back at their slots and D slices; the replicated leaves rank 0's)."""
    rows, ep = shape
    whole = dict(outs[0]["grads_flat"])
    for name in whole:
        if name.split("/")[-1] not in MOE_KEYS:
            continue
        by_row = []
        for g in range(rows):
            slots = [outs[g * ep + m]["grads_flat"][name] for m in range(ep)]
            by_row.append(np.concatenate(slots, axis=1))
        whole[name] = np.concatenate(by_row,
                                     axis=FSDP_DIM[name.split("/")[-1]])
    return whole


def _flat_outs(outs):
    for r in outs:
        r.setdefault("grads_flat", _flat(r["grads"]))
    return outs


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_matches_reference_one_device(ranks, reference, shape):
    """The reference's criterion: loss within 5e-3 of one device's, every
    gradient leaf within 5e-3."""
    outs = _flat_outs(ranks(shape))
    for r in outs:
        assert abs(r["loss"] - reference["loss"]) < TOL, r["coords"]
    got = _assemble(outs, shape)
    assert set(got) == set(reference["grads"])
    worst = max(float(np.abs(got[n] - reference["grads"][n]).max())
                for n in got)
    assert worst < TOL, worst


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_matches_port_one_device(ranks, reference, shape):
    """Against the port's one-device step on the same weights: the loss at
    the model tolerance, every gradient leaf within the larger of
    ``ATOL_REL`` x its max and ``SPREAD`` x the reference's own change
    under two f32 ulps of the embedding."""
    outs = _flat_outs(ranks(shape))
    for r in outs:
        np.testing.assert_allclose(r["loss"], reference["port_loss"],
                                   rtol=RTOL)
    got = _assemble(outs, shape)
    for name, want in reference["port_grads"].items():
        ref = reference["grads"][name]
        spread = max(float(np.abs(p[name] - ref).max())
                     for p in reference["perturbed"])
        tol = max(ATOL_REL * float(np.abs(ref).max()), SPREAD * spread)
        gap = float(np.abs(got[name] - want).max())
        assert gap <= tol, (name, gap, tol, spread)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_ranks_agree_and_m_state_has_no_grad(ranks, shape):
    """Every rank reports the same loss and AIMD state, holds the same
    bits of every replicated gradient leaf (the data-parallel reduction
    is exact and the same everywhere), and its ``m_state`` carries no
    gradient."""
    outs = _flat_outs(ranks(shape))
    first = outs[0]
    for r in outs[1:]:
        assert r["loss"] == first["loss"]
        assert np.array_equal(r["m"], first["m"])
        for name, g in first["grads_flat"].items():
            if name.split("/")[-1] not in MOE_KEYS:
                assert np.array_equal(r["grads_flat"][name], g), name
    assert not any(r["m_grad"] for r in outs)
    assert first["m"].shape == (shape[0], shape[1])


@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_gather_and_reduce_scatter(ranks, shape):
    """The FSDP gather gives the rank's slots of the whole slab, and its
    transpose the sum over the data rows of their cotangents' slices, bit
    for bit (``w_gate`` cut on its dim 1, ``w_down`` on its dim 2)."""
    for r in ranks(shape):
        for key in ("w_gate", "w_down"):
            assert r[f"gather_{key}"], (r["coords"], key)
            assert r[f"reduce_scatter_{key}"], (r["coords"], key)


@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_init_is_the_one_device_slice(ranks, shape):
    """``init_model(fsdp=True)`` under the mesh gives each rank exactly its
    slots and D slice of the one-device init's expert stacks, and every
    other leaf whole, bit for bit."""
    assert all(r["init_slice"] for r in ranks(shape))


@pytest.mark.parametrize("shape", MESHES)
def test_global_norm_under_mesh(ranks, reference, shape):
    """``global_norm`` of the ranks' gradients counts every element of the
    global tree once: the one-device norm of the assembled tree, and the
    same bits on every rank."""
    outs = _flat_outs(ranks(shape))
    got = _assemble(outs, shape)
    want = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                             for g in got.values())))
    assert len({r["gnorm"] for r in outs}) == 1
    np.testing.assert_allclose(outs[0]["gnorm"], want, rtol=1e-6)
    np.testing.assert_allclose(outs[0]["gnorm"], reference["port_gnorm"],
                               rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_three_adamw_steps_keep_replicated_leaves_bitwise(ranks, reference,
                                                          shape):
    """Three AdamW steps of ``make_train_step``: the same losses on every
    rank, step 1's equal to the one-device step's (the global masked
    mean), and every replicated leaf the same bits on every rank."""
    outs = ranks(shape)
    for r in outs:
        assert r["step"] == 3
        assert r["losses"] == outs[0]["losses"]
        assert r["digests"] == outs[0]["digests"]
    np.testing.assert_allclose(outs[0]["losses"][0],
                               reference["port_step_loss"], rtol=RTOL)
    assert all(np.isfinite(outs[0]["losses"]))


@pytest.mark.parametrize("shape", MESHES)
def test_nonfinite_loss_writes_nothing_on_any_rank(ranks, shape):
    """Rank 0 poisons a replicated leaf (its final norm): the loss is not
    finite on rank 0, and no rank writes its parameters, moments or step,
    also where its own loss is finite (on ``(2, 2)`` the other data
    group's ranks never see the poisoned value: the ranks' agreement stops
    them); the agreement ands the ranks' flags."""
    outs = ranks(shape)
    assert not np.isfinite(outs[0]["nan_loss"])
    if shape == (2, 2):
        assert np.isfinite(outs[1]["nan_loss"])
    for r in outs:
        assert r["nan_untouched"], r["coords"]
        assert r["agree"] is False


@pytest.mark.parametrize("shape", MESHES)
def test_train_step_census_matches_prediction(ranks, shape):
    """Each rank's collective census of one train step equals
    ``FlopByteLedger.predict_train_census``, kind by kind."""
    for r in ranks(shape):
        assert r["census"] == r["census_pred"], r["coords"]


def test_compressed_grad_psum_on_two_data_ranks(ranks):
    """On ``(2, 2)``'s two data ranks: the reduction equals the sum of
    each rank's int8-dequantized leaf, the residual plus the rank's own
    dequantized leaf is its leaf, bit for bit, and
    ``compressed_all_reduce`` carries the reduction in every row."""
    for r in ranks((2, 2)):
        for k in ("w", "b"):
            assert r[f"sum_{k}"] and r[f"residual_{k}"], (r["coords"], k)
        assert r["stacked"], r["coords"]


def test_compressed_all_reduce_one_rank_matches_reference(tmp_path):
    """``tests/test_substrate.py::test_compressed_all_reduce_contract``'s
    inputs on a 1-rank mesh: the port's reduction and residual equal the
    reference's bit for bit, and the contract holds."""
    from jax.sharding import Mesh
    from repro.optim.grad_utils import compressed_all_reduce
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    rng = np.random.default_rng(0)
    grads = {"w": jnp.asarray(rng.normal(0, 0.1, (1, 4, 8)), jnp.float32),
             "b": jnp.asarray(rng.normal(0, 1.0, (1, 8)), jnp.float32)}
    err = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), grads)
    red_j, err_j = compressed_all_reduce(grads, err, mesh, "data")
    [(red_t, err_t)] = run_ranks(compressed_one_rank, (1, 1),
                                 jax.tree.map(np.asarray, grads), tmp_path)
    for k in grads:
        assert np.array_equal(red_t[k], np.asarray(red_j[k])), k
        assert np.array_equal(err_t[k], np.asarray(err_j[k])), k
        np.testing.assert_allclose(red_t[k] + err_t[k],
                                   np.asarray(grads[k]), atol=1e-7)
        amax = float(jnp.abs(grads[k]).max())
        assert float(np.abs(red_t[k] - np.asarray(grads[k])).max()) \
            <= amax / 127.0 + 1e-9


def test_train_mesh_host_on_two_cpu_ranks(tmp_path):
    """``python -m repro_torch.launch.train --mesh host --device cpu``
    under two spawned gloo ranks: both train, print the same losses and
    checkpoint collectively; rank 0 prints the summary."""
    argv = ["--preset", "tiny", "--device", "cpu", "--mesh", "host",
            "--steps", "10", "--batch", "4", "--seq", "16",
            "--checkpoint-every", "5", "--ckpt-dir", str(tmp_path / "ckpt")]
    (rc0, text0), (rc1, text1) = run_ranks(train_case, (1, 2), argv,
                                           tmp_path)
    assert rc0 == 0 and rc1 == 0

    def losses(text):
        return [line.split("loss=")[1].split()[0]
                for line in text.splitlines() if "loss=" in line]

    assert losses(text0) and losses(text0) == losses(text1), (text0, text1)
    assert "[ft] final checkpoint at step 10" in text1
    lines = text0.splitlines()
    assert lines[-2].startswith("done: 10 steps in "), lines
    assert lines[-1] == "mesh 1x2 (gloo), 2 ranks", lines
    assert "done:" not in text1
    assert (tmp_path / "ckpt" / "step_00000010" / "meta.json").exists()
