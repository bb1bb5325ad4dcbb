"""Checkpoints of engines with a placement or replica manager, shared or
per-layer: the port's engine migrates as the reference's does, its
checkpoint loads into the reference's engine and the other way round
(weights in the writer's physical layout, the manager's tables and
predictor under its own group), both then serve the same tokens, and a
checkpoint of the wrong manager kind or table layout is refused."""
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.replication import expand_moe_params as jexpand
from repro.serving.scheduler import Request as JReq
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.replication import expand_moe_params as texpand
from repro_torch.serving.scheduler import Request as TReq

CASES = [(k, pl) for k in ("placement", "replication") for pl in (False,
                                                                   True)]


def _engines(kind, per_layer, migrate=True, seed=0):
    """A reference and a port engine with the same manager, after one
    committed migration from the same seeded stats."""
    cfg_j, cfg_t, params, pnum = tm.model()
    mkw = dict(replan_every=1, warmup_iters=1, min_gain=0.0,
               per_layer=per_layer)
    mj, mt = tm.managers(cfg_j, cfg_t, kind, **mkw)
    pt = params_from_numpy(pnum, "cpu")
    if kind == "replication":
        params = jexpand(params, mj.rsets if per_layer else mj.rset)
        pt = texpand(pt, mt.rsets if per_layer else mt.rset)
    ej = tm.JEngine(cfg_j, params, tm.JCfg(**tm.POLICY), placement=mj,
                    **tm.ENGINE)
    et = tm.TEngine(cfg_t, pt, TCfg(**tm.POLICY), placement=mt,
                    device="cpu", **tm.ENGINE)
    if migrate:
        n_blocks = cfg_t.moe_block_structure()[0]
        for es, _, dec in tm.stats_stream(3, n_blocks, 8, seed=seed):
            mj.observe(es, decode=dec)
            mt.observe(es, decode=dec)
        for eng in (ej, et):
            eng._it = 1
            eng._maybe_migrate()
        assert mj.n_migrations == mt.n_migrations == 1
    return ej, et


def _params_equal(ej, et):
    for g, lp in et.params.items():
        if not isinstance(lp, dict):
            continue
        for name, sub in lp.items():
            for k, v in _leaves(sub):
                ref = np.asarray(_get(ej.params[g][name], k))
                got = v.to(torch.float32).numpy() if v.dtype == \
                    torch.bfloat16 else v.numpy()
                assert ref.shape == got.shape and np.array_equal(
                    ref.astype(got.dtype), got), (g, name, k)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _serve_same(ej, et, cfg):
    rng = np.random.default_rng(9)
    for uid in range(3):
        tok = rng.integers(0, cfg.vocab_size, 10).astype(np.int32)
        mod = rng.random(10) < 0.5
        ej.submit(JReq(uid=uid, tokens=tok, modality=mod, max_new_tokens=5,
                       arrival_time=0.0))
        et.submit(TReq(uid=uid, tokens=tok, modality=mod, max_new_tokens=5,
                       arrival_time=0.0))
    dj = {r.uid: r.generated for r in ej.run()}
    dt = {r.uid: r.generated for r in et.run()}
    assert dj == dt and len(dt) == 3


def test_engine_migration_lands_the_reference_weights():
    for kind, per_layer in CASES:
        ej, et = _engines(kind, per_layer)
        _params_equal(ej, et)
        tm.tables_equal(ej._placement, et._placement)


@pytest.mark.parametrize("kind,per_layer", CASES)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manager_checkpoint_roundtrip_both_ways(tmp_path, kind, per_layer,
                                                writer):
    ej, et = _engines(kind, per_layer)
    src = et if writer == "port" else ej
    src.save_checkpoint(str(tmp_path), 7)
    rj, rt = _engines(kind, per_layer, migrate=False)
    assert rj.load_checkpoint(str(tmp_path)) == 7
    assert rt.load_checkpoint(str(tmp_path)) == 7
    _params_equal(ej, rt)
    _params_equal(rj, rt)
    tm.state_equal(rj._placement, rt._placement)
    tm.tables_equal(ej._placement, rt._placement)
    assert np.array_equal(np.asarray(rj.m_state), rt.m_state.numpy())
    _serve_same(rj, rt, rt.cfg)


def test_wrong_manager_kind_and_layout_refused(tmp_path):
    _, et = _engines("placement", False)
    et.save_checkpoint(str(tmp_path / "p"), 1)
    _, rt = _engines("replication", False, migrate=False)
    with pytest.raises(ValueError, match="placement engine"):
        rt.load_checkpoint(str(tmp_path / "p"))
    _, lt = _engines("placement", True, migrate=False)
    with pytest.raises(ValueError, match="not interchangeable"):
        lt.load_checkpoint(str(tmp_path / "p"))
    cfg_j, cfg_t, _, pnum = tm.model()
    bare = tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"), TCfg(),
                      device="cpu", **tm.ENGINE)
    with pytest.raises(ValueError, match="placement engine"):
        bare.load_checkpoint(str(tmp_path / "p"))


def test_manager_free_checkpoint_resets_and_expands(tmp_path):
    """A replica engine reading a manager-free checkpoint resets to its
    identity set and lays the logical rows out into its slots, as the
    reference does."""
    cfg_j, cfg_t, params, pnum = tm.model()
    bare = tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"), TCfg(),
                      device="cpu", **tm.ENGINE)
    bare.save_checkpoint(str(tmp_path), 3)
    ej, et = _engines("replication", False)
    ej.load_checkpoint(str(tmp_path))
    et.load_checkpoint(str(tmp_path))
    assert et._placement.n_migrations == 0
    _params_equal(ej, et)
    tm.state_equal(ej._placement, et._placement)
