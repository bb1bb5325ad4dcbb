"""The port's checkpoints against the reference's format: a checkpoint
saved by either engine loads into the other bit for bit (bf16 leaves
through their 16-bit pattern), ``keep`` garbage collection and the atomic
rename hold, the async writer surfaces its errors, and a checkpoint that
carries a placement group is refused as the reference refuses it."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JEngine
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.scheduler import Request

ARCH = "moonshot-v1-16b-a3b"
ENGINE = dict(max_slots=2, max_len=48, prefill_budget=16, virtual_ep=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(a, b, path=""):
    """Every leaf of the reference tree ``a`` equals the port's ``b`` bit
    for bit (bf16 compared as 16-bit patterns)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _walk(a[k], b[k], f"{path}/{k}")
        return
    ref = np.asarray(a)
    got = b.detach().cpu()
    assert tuple(got.shape) == ref.shape, path
    if ref.dtype == ml_dtypes.bfloat16:
        assert got.dtype == torch.bfloat16, path
        assert np.array_equal(ref.view(np.uint16),
                              got.view(torch.int16).numpy().view(np.uint16)), \
            path
    else:
        got = got.numpy()
        assert got.dtype == ref.dtype, path
        assert np.array_equal(np.ascontiguousarray(ref).view(np.uint8),
                              np.ascontiguousarray(got).view(np.uint8)), path


@pytest.fixture(scope="module")
def engines():
    cfg_j, cfg_t = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    eng_j = JEngine(cfg_j, params, JCfg(), **ENGINE)
    eng_j.m_state = jnp.asarray([[0.3, 0.7, 0.1, 0.9]], jnp.float32)
    other = ttf.init_model(cfg_t, seed=5, device="cpu")
    eng_t = TEngine(cfg_t, other, TCfg(), device="cpu", **ENGINE)
    return eng_j, eng_t


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_engine_checkpoint_loads_in_the_other(tmp_path, engines, writer):
    eng_j, eng_t = engines
    cfg_j, cfg_t = eng_j.cfg, eng_t.cfg
    if writer == "reference":
        eng_j.save_checkpoint(str(tmp_path), step=3)
        fresh = TEngine(cfg_t, ttf.init_model(cfg_t, seed=9, device="cpu"),
                        TCfg(), device="cpu", **ENGINE)
        assert fresh.load_checkpoint(str(tmp_path)) == 3
        _walk(eng_j.params, fresh.params)
        _walk(eng_j.m_state, fresh.m_state)
    else:
        eng_t.m_state = torch.tensor([[0.2, 0.4, 0.6, 0.8]])
        eng_t.save_checkpoint(str(tmp_path), step=4)
        fresh = JEngine(cfg_j, jtf.init_model(cfg_j, jax.random.PRNGKey(9)),
                        JCfg(), **ENGINE)
        assert fresh.load_checkpoint(str(tmp_path)) == 4
        _walk(fresh.params, eng_t.params)
        _walk(fresh.m_state, eng_t.m_state)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_and_int_leaves_cross_load(tmp_path, writer):
    """bf16 (with its -0.0, inf and NaN patterns), f32 and int32 leaves
    under nested key paths, in both directions."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    w[0, :3] = [-0.0, np.inf, np.nan]
    tree_j = {"a": {"w": jnp.asarray(w, jnp.bfloat16),
                    "n": jnp.arange(6, dtype=jnp.int32)},
              "b": jnp.asarray(w)}
    tree_t = {"a": {"w": tensor_from_numpy(np.asarray(tree_j["a"]["w"]),
                                           "cpu"),
                    "n": torch.arange(6, dtype=torch.int32)},
              "b": torch.from_numpy(w.copy())}
    if writer == "reference":
        jckpt.save(str(tmp_path), 1, {"g": tree_j})
    else:
        tckpt.save(str(tmp_path), 1, {"g": tree_t})
    _, out_j = jckpt.restore(str(tmp_path), {"g": tree_j})
    _, out_t = tckpt.restore(str(tmp_path), {"g": tree_t})
    _walk(tree_j, out_t["g"])
    _walk(out_j["g"], tree_t)
    flat = tckpt.restore_group(str(tmp_path), "g")
    assert flat["a|w"].dtype == torch.bfloat16
    assert np.array_equal(flat["a|n"], np.arange(6))


def test_keep_and_atomic_rename(tmp_path):
    """``keep`` retains the newest steps; a leftover temp directory (a save
    cut mid-write) or a step without ``meta.json`` is never the latest;
    saving that step again replaces the leftover."""
    root = tmp_path / "ck"
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    for step in range(1, 6):
        tckpt.save(str(root), step, {"g": tree}, keep=2)
    assert sorted(p.name for p in root.iterdir()) == \
        ["step_00000004", "step_00000005"]
    assert tckpt.latest_step(str(root)) == jckpt.latest_step(str(root)) == 5
    (root / ".tmp_step_00000006").mkdir()
    (root / ".tmp_step_00000006" / "g.npz").write_bytes(b"partial")
    (root / "step_00000007").mkdir()                  # no meta.json
    assert tckpt.latest_step(str(root)) == 5
    tckpt.save(str(root), 6, {"g": {"x": tree["x"] + 1}}, keep=0)
    assert not (root / ".tmp_step_00000006").exists()
    step, out = tckpt.restore(str(root), {"g": tree}, step=6)
    assert step == 6 and torch.equal(out["g"]["x"], tree["x"] + 1)
    assert tckpt.has_group(str(root), "g", 6)
    assert not tckpt.has_group(str(root), "placement", 6)


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    """The snapshot is taken at ``save``: a later in-place change of the
    tensor does not reach the file; a failed write raises on ``wait``."""
    t = torch.arange(5, dtype=torch.float32)
    ac = tckpt.AsyncCheckpointer(str(tmp_path / "a"), keep=2)
    ac.save(1, {"g": {"t": t}})
    t.add_(10)
    ac.wait()
    _, out = jckpt.restore(str(tmp_path / "a"), {"g": {"t": jnp.zeros(5)}})
    assert np.array_equal(np.asarray(out["g"]["t"]), np.arange(5))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = tckpt.AsyncCheckpointer(str(blocker / "sub"))
    bad.save(1, {"g": {"t": t}})
    with pytest.raises(OSError):
        bad.wait()


def test_placement_checkpoint_is_refused(tmp_path, engines):
    """A checkpoint written with a placement group holds weights in the
    manager's physical order: the port's engine refuses it, as the
    reference's manager-free engine does."""
    eng_j, eng_t = engines
    state = {"serving": {"params": eng_j.params, "m_state": eng_j.m_state},
             "placement": {"n_tables": np.array(1)}}
    jckpt.save(str(tmp_path), 2, state)
    with pytest.raises(ValueError, match="placement"):
        eng_j.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="placement"):
        eng_t.load_checkpoint(str(tmp_path))


def test_restored_engine_serves_the_same_tokens(tmp_path):
    """Save, load into an engine built on other weights, and serve one
    request greedily: the same tokens as the engine that saved."""
    cfg = reduced(get_config(ARCH))
    rng = np.random.default_rng(4)
    req = lambda: Request(uid=0, tokens=rng_tokens, modality=rng_mod,  # noqa
                          max_new_tokens=6)
    rng_tokens = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    rng_mod = rng.random(20) < 0.5
    src = TEngine(cfg, ttf.init_model(cfg, seed=1, device="cpu"), TCfg(),
                  device="cpu", **ENGINE)
    src.save_checkpoint(str(tmp_path), 1)
    src.submit(req())
    want = src.run()[0].generated
    dst = TEngine(cfg, ttf.init_model(cfg, seed=2, device="cpu"), TCfg(),
                  device="cpu", **ENGINE)
    dst.load_checkpoint(str(tmp_path))
    dst.submit(req())
    assert dst.run()[0].generated == want
