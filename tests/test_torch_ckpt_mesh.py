"""Checkpoints and the fault-tolerant loop of training under a
``(data, model)`` mesh, in one spawn of ``(2, 2)`` gloo ranks
(``_torch_ep_workers.ckpt_mesh_cases``).

* A state in the FSDP layout (each expert slot's D over the data rows):
  reduced olmoe-1b-7b's parameters from the reference's init, AdamW
  moments drawn from a seed (so that every leaf differs), an AIMD state,
  saved collectively on ``(2, 2)`` (rank 0 writes the global layout) and
  restored onto ``(2, 2)``, onto a ``(1, 2)`` mesh of the first two ranks
  and onto one device: every leaf, the moments and the step included,
  byte for byte against the numpy trees it was cut from.  The files are
  the global arrays: the reference's ``restore`` reads them back equal to
  those trees.
* ``launch.train.build`` and ``TrainLoop`` on the mesh: a signal caught on
  one rank after step 3 stops every rank there (each saves
  collectively), the restart resumes every rank at step 3, and steps 4-6
  and the final parameters equal an uninterrupted run's bit for bit.
"""
import jax
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_ep_workers import ckpt_mesh_cases
from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf


@pytest.fixture(scope="module")
def state():
    cfg = jreduced(jget("olmoe-1b-7b"), n_layers=2)
    params = jax.tree.map(np.asarray, jtf.init_model(
        cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    moment = lambda p: rng.normal(0, 1, p.shape).astype(np.float32)  # noqa
    opt = (np.asarray(5, np.int32), jax.tree.map(moment, params),
           jax.tree.map(lambda p: np.abs(moment(p)), params))
    return {"params": params, "opt": opt,
            "m": np.array([[0.5, 0.25], [0.125, 0.75]], np.float32)}


@pytest.fixture(scope="module")
def ranks(state, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_mesh")
    c = {"ckpt": dict(state, dir=str(root / "state")),
         "trainloop": {"dir": str(root / "loop"), "steps": 6, "stop": 3}}
    out = run_ranks(ckpt_mesh_cases, (2, 2), c, root)
    for r in out:
        for name, res in r.items():
            assert "error" not in res, res["error"]
    return out, root


def test_fsdp_checkpoint_restores_onto_any_mesh(ranks):
    """Saved on ``(2, 2)`` with FSDP, restored byte for byte onto
    ``(2, 2)``, onto ``(1, 2)`` (the first two ranks) and onto one device
    (rank 0), moments included."""
    out, _ = ranks
    assert all(r["ckpt"]["same_mesh"] for r in out)
    assert [r["ckpt"].get("sub_mesh") for r in out] == [True, True, None,
                                                         None]
    assert out[0]["ckpt"]["one_device"] and out[0]["ckpt"]["types"]
    assert len({r["ckpt"]["path"] for r in out}) == 1


def test_fsdp_checkpoint_files_are_global(ranks, state):
    """The files hold the global arrays: the reference's ``restore`` reads
    the parameters and both moments back equal to the trees they were cut
    from."""
    out, root = ranks
    tmpl = {"params": state["params"],
            "opt": {"mu": state["opt"][1], "nu": state["opt"][2]}}
    step = jckpt.latest_step(str(root / "state"))
    assert step == 7
    for group in ("params", "opt"):
        flat = jckpt.restore_group(str(root / "state"), group)
        want = {"|".join(k): v for k, v in _items(tmpl[group] if group
                                                  == "params" else
                                                  {".mu": tmpl["opt"]["mu"],
                                                   ".nu": tmpl["opt"]["nu"]})}
        for key, arr in want.items():
            assert np.array_equal(np.asarray(flat[key]), arr), key


def _items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    else:
        yield path, tree


def test_trainloop_preempted_on_one_rank_restarts_bit_for_bit(ranks):
    """A signal on the last rank after step 3: every rank stops at step 3;
    the restart resumes every rank there, and its losses (steps 4-6) and
    final parameters equal the uninterrupted run's bit for bit, the same
    on every rank."""
    out, _ = ranks
    for r in out:
        loop = r["trainloop"]
        assert len(loop["first"]) == 3 and loop["start"] == 3
        assert loop["after"] == loop["straight"][3:]
        assert loop["first"] == loop["straight"][:3]
        assert loop["same_final"]
        assert loop["straight"] == out[0]["trainloop"]["straight"]
