"""Rank-side halves of the port's multi-rank tests (``test_torch_ep*.py``,
``test_torch_train_mesh.py``, ``test_torch_ckpt_mesh.py``,
``test_torch_ssm_train.py``, ``test_torch_memory_mesh.py``,
``test_torch_tp.py``, ``test_torch_layout_ep.py``).

Each function runs in a spawned gloo rank (``_torch_dist.run_ranks``) under
the mesh, imports only torch and the port, takes numpy inputs and returns
numpy results; the test process holds them against the reference.  A case
that raises returns ``{"error": traceback}`` so the other cases still
report.  The EP layer, migration and elastic cases run under the rules in
force: the EP-only layout (``run_ranks``' default) or the tensor-parallel
layout of the default rules (``test_torch_layout_ep.py``), where a rank
holds every leaf as the rules cut it (``_shard``) and passes the MoE layer
its rows and sequence slice (``_layer_in``)."""
import contextlib
import dataclasses
import traceback

import numpy as np
import torch


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return tree


def _cfg(arch):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch))


@contextlib.contextmanager
def _kernel_record(rec):
    """Notes each quantizer predicate and each FP4 FFN launch's routed
    count (the plain versions read their CPU inputs anyway)."""
    from repro_torch.kernels import ops
    quant, ffn = ops.quantize_experts_fp4, ops.grouped_fp4_ffn

    def quant_noted(wt, *, group, pred=None):
        rec["pred"].append(None if pred is None else int(pred))
        return quant(wt, group=group, pred=pred)

    def ffn_noted(xs, gs, wq, *, group):
        rec["fp4_rows"].append(int(gs.sum()))
        return ffn(xs, gs, wq, group=group)

    ops.quantize_experts_fp4, ops.grouped_fp4_ffn = quant_noted, ffn_noted
    try:
        yield rec
    finally:
        ops.quantize_experts_fp4, ops.grouped_fp4_ffn = quant, ffn


def _placement(entries):
    from repro_torch.core import ep_moe
    if entries is None:
        return None
    t = tuple(torch.from_numpy(np.asarray(a)) for a in entries)
    return {2: ep_moe.Placement, 3: ep_moe.Replication,
            4: ep_moe.WeightedReplication}[len(t)](*t)


def _layer_in(mesh, grouped, dispatch, *ts):
    """What a rank passes the MoE layer of the global ``[B, S, ..]`` inputs
    ``ts`` (None passes): the whole under ``EP_ONLY_RULES``; in the
    tensor-parallel layout its rows (``grouped``: one ``m_state`` group a
    data row) and, in dispatch, its sequence slice."""
    from repro_torch.models.common import local_slice, tensor_parallel
    if not tensor_parallel(mesh):
        return ts
    b, s = ts[0].shape[:2]
    mine = (local_slice(b, "batch", mesh) if grouped else slice(0, b),
            local_slice(s, "seq", mesh) if dispatch else slice(0, s))
    return tuple(None if t is None else t[mine] for t in ts)


def _layer_out(mesh, grouped, dispatch, y):
    """The global output of the MoE layer from a rank's (``_layer_in``'s
    inverse; gathered outside the census)."""
    from repro_torch.core import ep_moe
    from repro_torch.models.common import tensor_parallel
    if not tensor_parallel(mesh):
        return y
    comm = ep_moe._dist_comm(mesh)
    if dispatch:
        y = torch.cat(list(comm._gather(y.contiguous(), "model")), 1)
    if grouped:
        y = torch.cat(list(comm._gather(y.contiguous(), "data")), 0)
    return y


def _layer_case(mesh, c):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.core import ep_moe
    cfg = _cfg(c.get("arch", "olmoe-1b-7b"))
    p = _shard({"moe": c["p"]}, mesh, c.get("placement"))["moe"]
    rcfg = ReaLBConfig(**c["rcfg"])
    m = torch.from_numpy(np.asarray(c["m"], np.float32))
    x = torch.from_numpy(c["x"])
    mod = torch.from_numpy(c["mod"])
    valid = None if c.get("valid") is None else torch.from_numpy(c["valid"])
    grouped, dispatch = m.shape[0] > 1, c["mode"] != "broadcast"
    x, mod, valid = _layer_in(mesh, grouped, dispatch, x, mod, valid)
    comm = ep_moe._dist_comm(mesh)
    comm.census.reset()
    rec = {"pred": [], "fp4_rows": []}
    with _kernel_record(rec):
        for _ in range(c.get("calls", 1)):   # chained: y feeds the next
            x, m, aux = ep_moe.ep_moe_forward(
                p, x, cfg, rcfg, m, mod, mode=c["mode"], valid=valid,
                placement=_placement(c.get("placement")))
    census = comm.census.snapshot()
    x = _layer_out(mesh, grouped, dispatch, x)
    out = {"y": _np(x), "m": _np(m), "aux": _np(aux), "census": census,
           "d_held": int(p["w_gate"].shape[1]), **rec}
    if c.get("stop_stage"):
        try:
            ep_moe.ep_moe_forward(p, x, cfg, rcfg, m, mod, mode=c["mode"],
                                  stop_stage="route")
            out["stop_stage"] = "ran"
        except NotImplementedError as err:
            out["stop_stage"] = str(err)
    return out


def layer_cases(mesh, cases):
    """``{name: case}`` → ``{name: results}`` for ``ep_moe_forward``."""
    out = {}
    for name, c in cases.items():
        try:
            out[name] = _layer_case(mesh, c)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def _forwards(mesh, c, params, cfg, rcfg):
    """``chunk_forward`` then ``decode_forward`` on the rank's shard."""
    from repro_torch.convert import cache_from_numpy
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    comm = ep_moe._dist_comm(mesh)
    m = torch.from_numpy(np.asarray(c["m"], np.float32))
    comm.census.reset()
    res = tf.chunk_forward(params, cfg, rcfg,
                           {k: torch.from_numpy(v)
                            for k, v in c["chunk"].items()},
                           cache_from_numpy(c["cache"], "cpu"), m)
    out = {"chunk": {"logits": _np(res.logits), "m": _np(res.m_state),
                     "aux": _np(res.aux), "cache": _np(res.cache),
                     "census": comm.census.snapshot()}}
    res = tf.decode_forward(params, cfg, rcfg,
                            {k: torch.from_numpy(v)
                             for k, v in c["decode"].items()},
                            res.cache, res.m_state)
    out["decode"] = {"logits": _np(res.logits), "m": _np(res.m_state),
                     "aux": _np(res.aux), "cache": _np(res.cache)}
    return out


def _engine(c, params, cfg):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    from repro_torch.workloads.arrivals import IterationCostModel, VirtualClock
    clock = VirtualClock()
    eng = Engine(cfg, params, ReaLBConfig(**c["engine_rcfg"]), clock=clock,
                 cost_model=IterationCostModel(), device="cpu",
                 **c["engine"])
    for uid, (toks, mod, new) in enumerate(c["requests"]):
        eng.submit(Request(uid=uid, tokens=np.asarray(toks, np.int32),
                           modality=np.asarray(mod, bool),
                           max_new_tokens=new, arrival_time=0.0))
    done = eng.run()
    return {"tokens": {r.uid: list(r.generated) for r in done},
            "times": {r.uid: (r.first_token_time, r.finish_time)
                      for r in done},
            "stats": [dataclasses.asdict(s) for s in eng.stats],
            "m": _np(eng.m_state)}


def _model_case(mesh, c):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.convert import rank_shard
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh
    cfg = _cfg(c["arch"])
    ep, rank = mesh.size("model"), mesh.index("model")
    params = rank_shard(c["params"], ep, rank, device="cpu")
    out = {name: _forwards(mesh, c, params, cfg, ReaLBConfig(**kw))
           for name, kw in c["policies"].items()}
    # a shard of the port's own init equals the slice of the whole init
    with use_mesh(None):
        whole = tf.init_model(cfg, seed=3, device="cpu")
    mine = tf.init_model(cfg, seed=3)
    n = whole["blocks"]["layer0"]["moe"]["w_gate"].shape[1] // ep
    out["init_slots"] = int(mine["blocks"]["layer0"]["moe"]["w_gate"]
                            .shape[1])
    out["init_shard"] = all(
        torch.equal(mine["blocks"]["layer0"]["moe"][k],
                    whole["blocks"]["layer0"]["moe"][k][:, rank * n:
                                                        (rank + 1) * n])
        for k in ("w_gate", "w_up", "w_down")) and all(
        torch.equal(mine[k], whole[k]) for k in ("embed", "unembed"))
    del whole, mine
    # a chunk that does not divide over the EP group is refused
    bad = dict(c["chunk"], tokens=c["chunk"]["tokens"][:, :c["odd_len"]],
               modality=c["chunk"]["modality"][:, :c["odd_len"]])
    try:
        tf.chunk_forward(params, cfg, ReaLBConfig(),
                         {k: torch.from_numpy(v) for k, v in bad.items()},
                         tf.init_cache(cfg, bad["tokens"].shape[0], 64),
                         torch.zeros((1, ep)))
        out["odd_chunk"] = "ran"
    except ValueError as err:
        out["odd_chunk"] = str(err)
    out["engine"] = _engine(c, params, cfg)
    if c.get("hybrid") is not None:
        out["hybrid"] = _hybrid_case(mesh, c["hybrid"])
    return out


def _hybrid_case(mesh, c):
    """Reduced jamba (attention, Mamba and MoE layers) on the rank's shard:
    ``prefill_forward`` then ``decode_forward``; the SSM weights and states
    stay whole on every rank."""
    from repro_torch.configs import ReaLBConfig
    from repro_torch.convert import rank_shard
    from repro_torch.models import transformer as tf
    cfg = _cfg(c["arch"])
    ep, rank = mesh.size("model"), mesh.index("model")
    params = rank_shard(c["params"], ep, rank, device="cpu")
    ssm = params["blocks"]["layer1"]["ssm"]["w_in"]
    rcfg = ReaLBConfig(**c["rcfg"])
    m = torch.full((1, ep), rcfg.md_init)
    res = tf.prefill_forward(params, cfg, rcfg,
                             {k: torch.from_numpy(v)
                              for k, v in c["prefill"].items()},
                             m, cache_len=c["cache_len"])
    out = {"prefill": {"logits": _np(res.logits), "m": _np(res.m_state),
                       "aux": _np(res.aux), "cache": _np(res.cache)},
           "ssm_whole": tuple(ssm.shape) == c["ssm_w_in_shape"]}
    res = tf.decode_forward(params, cfg, rcfg,
                            {k: torch.from_numpy(v)
                             for k, v in c["decode"].items()},
                            res.cache, res.m_state)
    out["decode"] = {"logits": _np(res.logits), "m": _np(res.m_state),
                     "aux": _np(res.aux), "cache": _np(res.cache)}
    return out


def model_cases(mesh, c):
    try:
        return _model_case(mesh, c)
    except Exception:
        return {"error": traceback.format_exc()}


def serve_case(mesh, argv):
    """``python -m repro_torch.launch.serve`` on every rank."""
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    return rc, buf.getvalue()


# --------------------------------------------------------------------------
# migration under a mesh (test_torch_ep_migrate.py)
# --------------------------------------------------------------------------
MOE = ("w_gate", "w_up", "w_down")


def _tensors(tree):
    from repro_torch.convert import params_from_numpy
    return params_from_numpy(tree, "cpu")


def _spec_of(tree):
    """Declarations of a test tree: each expert stack's trailing three dims
    under the model's axes (``EXPERT_AXES``), every other leaf whole."""
    from repro_torch.models.common import P
    from repro_torch.models.transformer import EXPERT_AXES

    def walk(node, key, in_moe):
        if isinstance(node, dict):
            return {k: walk(v, k, key == "moe") for k, v in node.items()}
        shape = np.shape(node)
        if in_moe and key in MOE:
            return P(shape[-3:], axes=EXPERT_AXES[key])
        return P(shape)
    return walk(tree, None, False)


def _shard(tree, mesh, placement=None, cfg=None):
    """This rank's slots of a numpy tree (identity cut of a physical one)
    by the rules in force: under ``EP_ONLY_RULES`` its ``S/ep`` expert
    slots; in the tensor-parallel layout every leaf as the rules cut it
    (the model's declarations with ``cfg``, else :func:`_spec_of`), the
    expert slots' D dim over ``data`` among them."""
    from repro_torch.convert import layout_shard, rank_shard
    from repro_torch.models.common import tensor_parallel
    if tensor_parallel(mesh):
        from repro_torch.models.transformer import model_spec
        spec = model_spec(cfg) if cfg is not None else _spec_of(tree)
        return layout_shard(tree, spec, mesh, "cpu", placement)
    return rank_shard(tree, mesh.size("model"), mesh.index("model"),
                      placement, device="cpu")


def _moe_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _moe_leaves(v, path + (k,))
        elif k in MOE:
            yield path + (k,), v


def _same_bytes(a, b):
    """Two tensors hold the same bytes (-0.0 and NaN payloads count)."""
    a, b = a.detach().contiguous(), b.detach().contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and bytes(
        a.view(torch.uint8).numpy()) == bytes(b.view(torch.uint8).numpy())


def _mine_of(w, key, mesh):
    """This rank's part of a whole expert stack ``w``: its slots and, in
    the tensor-parallel layout, their D slice (``embed`` over ``data``)."""
    from repro_torch.models.common import (FSDP_DIM, local_slice,
                                           tensor_parallel)
    ep, my = mesh.size("model"), mesh.index("model")
    n = w.shape[-3] // ep
    w = w.narrow(w.dim() - 3, my * n, n)
    if tensor_parallel(mesh):
        dim = w.dim() + FSDP_DIM[key]
        cut = local_slice(w.shape[dim], "embed", mesh)
        w = w.narrow(dim, cut.start, cut.stop - cut.start)
    return w


def _shard_equal(mine, whole, mesh):
    """Every expert leaf of ``mine`` holds this rank's part of ``whole``."""
    got = dict(_moe_leaves(mine))
    return all(_same_bytes(got[path], _mine_of(w, path[-1], mesh))
               for path, w in _moe_leaves(whole))


def _plan(rows):
    from repro_torch.placement.migrate import _LayerSubsetPlan
    rows = np.asarray(rows, np.int64)
    return _LayerSubsetPlan(gather_idx=rows, is_noop=False)


def _sent(comm):
    return comm.census.snapshot().get("migrate_all_to_all",
                                      {"bytes": 0})["bytes"]


def _case_gather(mesh, c):
    """In-place gathers by global rows on the rank's slots against the
    one-device gather of the whole tree; the bytes sent; the inverse
    gather back."""
    from repro_torch.core import ep_moe
    from repro_torch.models.common import use_mesh
    from repro_torch.placement import migrate as pm
    comm = ep_moe._dist_comm(mesh)
    out = {}
    for name, (tree, rows, inv) in c["plans"].items():
        mine, orig = _shard(tree, mesh), _shard(tree, mesh)
        whole = _tensors(tree)
        comm.census.reset()
        landed = []
        pm.apply_to_params(mine, _plan(rows), landed)
        sent = _sent(comm)
        with use_mesh(None):
            ref_landed = []
            pm.apply_to_params(whole, _plan(rows), ref_landed)
        equal = _shard_equal(mine, whole, mesh)
        pm.undo_blocks(mine, _plan(inv), landed)
        out[name] = dict(equal=equal, landed=landed, ref_landed=ref_landed,
                         sent=sent, back=_shard_equal(mine, _tensors(tree),
                                                      mesh) and all(
            _same_bytes(a, b) for (_, a), (_, b) in zip(
                _moe_leaves(mine), _moe_leaves(orig))))
    return out


def _case_failure(mesh, c):
    """A read that fails on one rank at the second changed block: every rank
    stops there (the same blocks landed), every rank rolls them back; a
    recovery patch that fails on one rank aborts the executor's batch on
    every rank."""
    from repro_torch.configs import PlacementConfig
    from repro_torch.placement import PlacementManager
    from repro_torch.placement import migrate as pm
    from repro_torch.serving.async_migrate import MigrationExecutor
    tree, rows, inv = c["plan"]
    ep, my = mesh.size("model"), mesh.index("model")
    failing = mesh.index("model") == c["fail_rank"] \
        and mesh.index("data") == 0
    mine, orig = _shard(tree, mesh), _shard(tree, mesh)
    real = pm._read_rows
    calls = [0]

    def flaky(srcs, ix):
        calls[0] += 1
        if calls[0] == 2:
            raise OSError("injected read failure")
        return real(srcs, ix)

    out = {}
    landed, aborted = [], []
    pm._read_rows = flaky if failing else real
    try:
        pm.apply_to_params(mine, _plan(rows), landed)
        out["apply"] = "ran"
    except pm.PeerMigrationError as err:
        out["apply"], e = "peer", err
    except OSError as err:
        out["apply"], e = "own", err
    finally:
        pm._read_rows = real
    out["landed"] = list(landed)
    if out["apply"] != "ran":
        pm.roll_back(e, mine, _plan(inv), landed, lambda: aborted.append(1))
    out["aborted"] = len(aborted)
    out["rolled_back"] = all(_same_bytes(a, b) for (_, a), (_, b) in zip(
        _moe_leaves(mine), _moe_leaves(orig)))

    # the executor: the gather lands on every rank, one rank's patch fails
    e, n_layers = c["experts"], c["layers"]
    mgr = PlacementManager.from_geometry(
        e, PlacementConfig(replan_every=1, warmup_iters=1, min_gain=0.0,
                           per_layer=True), ep, bytes_per_expert=8,
        n_layers=n_layers)
    mgr.observe(np.asarray(c["stats"], np.float64))
    plan = mgr.maybe_replan(1)
    before = [t.e2r.copy() for t in mgr.tables]
    params = _shard(c["params"], mesh)
    orig = _shard(c["params"], mesh)

    def patch(p, plan, layers):
        if failing:
            raise OSError("injected patch failure")
        return p

    ex = MigrationExecutor(mgr, plan, bytes_per_iter=1 << 30,
                           patch_fn=patch,
                           undo=pm.diff_layers(plan.new_tables, mgr.tables))
    try:
        ex.drain(params)
        out["drain"] = "ran"
    except pm.PeerMigrationError:
        out["drain"] = "peer"
    except OSError:
        out["drain"] = "own"
    out["drain_in_flight"] = mgr.in_flight is not None
    out["drain_tables_kept"] = all(np.array_equal(a, t.e2r)
                                   for a, t in zip(before, mgr.tables))
    out["drain_rolled_back"] = all(
        _same_bytes(a, b) for (_, a), (_, b) in zip(_moe_leaves(params),
                                                    _moe_leaves(orig)))
    return out


def _case_agree(mesh, c):
    """Ranks whose clocks give different iteration seconds drain a plan's
    chunks alike: the executor agrees on the seconds before packing."""
    import torch.distributed as dist
    from repro_torch.configs import PlacementConfig
    from repro_torch.placement import PlacementManager
    from repro_torch.placement import migrate as pm
    from repro_torch.serving.async_migrate import MigrationExecutor
    ep = mesh.size("model")
    mgr = PlacementManager.from_geometry(
        c["experts"], PlacementConfig(replan_every=1, warmup_iters=1,
                                      min_gain=0.0, per_layer=True,
                                      migration_bw=c["bw"]), ep,
        bytes_per_expert=c["bpe"], n_layers=c["layers"])
    mgr.bandwidth.observe = lambda nbytes, s: None    # keep the prior
    mgr.observe(np.asarray(c["stats"], np.float64))
    plan = mgr.maybe_replan(1)
    iter_s = c["iter_s"] * (dist.get_rank() + 1)     # this rank's clock
    ex = MigrationExecutor(mgr, plan)
    params = _shard(c["params"], mesh)
    out = {"local_budget": ex.budget_bytes(iter_s), "chunks": [],
           "budgets": [],
           "wall": pm.agree_seconds(0.01 * (dist.get_rank() + 1))}
    while ex.draining:
        params, rep = ex.drain(params, iter_s)
        out["chunks"].append(list(rep.layers))
        out["budgets"].append(rep.budget_bytes)
    return out


def _case_expand(mesh, c):
    """``expand_moe_params`` of a rank's logical rows onto its share of the
    slots equals its slice of the one-device expansion, byte for byte."""
    from repro_torch.models.common import use_mesh
    from repro_torch.replication import ReplicaSet, expand_moe_params
    ep = mesh.size("model")
    out = {}
    for name, sets in c["sets"].items():
        rs = [ReplicaSet(np.asarray(rp), np.asarray(nr), ep, spr)
              for rp, nr, spr in sets[ep]]
        arg = rs if len(rs) > 1 else rs[0]
        mine = expand_moe_params(_shard(c["logical"], mesh), arg)
        with use_mesh(None):
            whole = expand_moe_params(_tensors(c["logical"]), arg)
        out[name] = _shard_equal(mine, whole, mesh)
    return out


def _case_ckpt(mesh, c):
    """The parent's save (every rank ``ckpt.save`` of its own shard into
    one directory), then the global save under the mesh against the
    one-device save of the whole tree, and the restore onto this mesh and
    onto one of another EP size."""
    import pathlib

    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.models.common import Mesh, use_mesh
    root = pathlib.Path(c["dir"])
    tree = c["tree"]
    out = {}

    def bf16(t):          # one bf16 stack: the raw-pattern leaves
        t["blocks"]["layer0"]["moe"]["w_down"] = \
            t["blocks"]["layer0"]["moe"]["w_down"].to(torch.bfloat16)
        return t

    mine = bf16(_shard(tree, mesh))
    spec = {"params": _spec_of(tree)}
    # the parent's Engine.save_checkpoint under a mesh: each rank's save
    if not c.get("layout"):
        try:
            ckpt.save(str(root / "per_rank"), 0,
                      {"serving": {"params": mine}})
            out["per_rank"] = "saved"
        except Exception as err:         # noqa: BLE001 - the fault shown
            out["per_rank"] = repr(err)
        dist.barrier()
    state = {"serving": {"params": mine,
                         "m_state": torch.full((1, mesh.size("model")), .5)},
             "placement": {"e2r": np.arange(4, dtype=np.int32)}}
    path = ckpt.save(str(root / "global"), 3, state, mesh=mesh, spec=spec)
    out["path"] = path
    if dist.get_rank() == 0:
        with use_mesh(None):
            whole = dict(state, serving=dict(state["serving"],
                                             params=bf16(_tensors(tree))))
            ckpt.save(str(root / "one_device"), 3, whole)
    dist.barrier()
    templates = {"serving": {"params": bf16(_shard(tree, mesh)),
                             "m_state": torch.zeros(1, mesh.size("model"))}}
    _, got = ckpt.restore(str(root / "global"), templates, mesh=mesh,
                          spec=spec)
    out["restored"] = _shard_equal(got["serving"]["params"],
                                   bf16(_tensors(tree)), mesh)
    # onto another EP size, over the same ranks
    world = dist.get_world_size()
    if mesh.size("model") != world:
        shape = (1, world)
    else:
        shape = (world // 2, 2) if world > 2 else (world, 1)
    other = Mesh(shape, "gloo", "cpu")
    with use_mesh(other):
        tmpl = {"serving": {"params": bf16(_shard(tree, other))}}
        _, got = ckpt.restore(str(root / "global"), tmpl, mesh=other,
                              spec=spec)
        out["restored_other_ep"] = (other.size("model"), _shard_equal(
            got["serving"]["params"], bf16(_tensors(tree)), other))
    return out


def _case_layers(mesh, c):
    """The reference's ``check_perlayer_identity_bitwise_under_ep`` and
    ``check_perlayer_tables_matches_local_under_ep`` on the rank: stacked
    identity tables, the shared identity table and none give the same bits
    (prefill and decode); depth-varying permutation tables over weights
    permuted by them give the logits the test holds against the
    reference's table-free local forward."""
    from repro_torch.configs import ReaLBConfig, get_config, reduced
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    cfg = reduced(get_config("olmoe-1b-7b"), n_layers=2)
    rcfg = ReaLBConfig(gate_gamma=10 ** 9)
    ep = mesh.size("model")
    params = _shard(c["params"], mesh, cfg=cfg)
    tokens = torch.from_numpy(c["tokens"])
    b = tokens.shape[0]
    _, n_blocks, _ = tf.block_structure(cfg)
    ident = ep_moe.identity_replication(cfg.moe.num_experts, ep)
    stacked = tuple(a.expand((n_blocks,) + a.shape).contiguous()
                    for a in ident)
    m0 = torch.full(ep_moe.moe_state_shape(mesh, b), 0.9)
    outs = {}
    for name, pl in (("none", None), ("shared", ident),
                     ("stacked", stacked)):
        res = tf.prefill_forward(params, cfg, rcfg, {"tokens": tokens}, m0,
                                 cache_len=20, placement=pl)
        db = {"tokens": tokens[:, :1],
              "pos": torch.full((b,), 16, dtype=torch.int32)}
        dec = tf.decode_forward(params, cfg, rcfg, db, res.cache,
                                res.m_state, placement=pl)
        outs[name] = (res.logits, res.m_state, dec.logits)
    out = {"identity_bitwise": all(
        torch.equal(a, b_) for name in ("none", "shared")
        for a, b_ in zip(outs[name], outs["stacked"]))}
    e2r, slot = (np.asarray(a) for a in c["perm_tables"])
    perm = _shard(c["params"], mesh, placement=(e2r, slot), cfg=cfg)
    place = (torch.from_numpy(e2r).to(torch.int32),
             torch.from_numpy(slot).to(torch.int32))
    res = tf.prefill_forward(perm, cfg, rcfg, {"tokens": tokens}, m0,
                             cache_len=20, placement=place)
    out["perm_logits"] = _np(res.logits)
    return out


def _case_async(mesh, c):
    """The reference's ``check_async_migrate_chunks_match_sync_under_ep``:
    a staged per-layer plan drained a chunk at a time on the rank's slots
    equals the synchronous apply, bit for bit, and the model gives the
    same logits through either copy under the committed tables."""
    from repro_torch.configs import (PlacementConfig, ReaLBConfig,
                                     get_config, reduced)
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    from repro_torch.placement import PlacementManager, apply_to_params
    from repro_torch.serving.async_migrate import MigrationExecutor
    cfg = reduced(get_config("olmoe-1b-7b"), n_layers=2)
    rcfg = ReaLBConfig(gate_gamma=10 ** 9)
    ep = mesh.size("model")

    def mk():
        mgr = PlacementManager(cfg, PlacementConfig(
            replan_every=2, warmup_iters=1, min_gain=0.0, per_layer=True),
            ep)
        mgr.observe(np.asarray(c["stats"], np.float64))
        return mgr, mgr.maybe_replan(2)

    m_sync, p_sync = mk()
    m_async, p_async = mk()
    ref = apply_to_params(_shard(c["params"], mesh, cfg=cfg), p_sync)
    m_sync.commit(p_sync)
    ex = MigrationExecutor(m_async, p_async, bytes_per_iter=1)
    got = _shard(c["params"], mesh, cfg=cfg)
    while ex.draining:
        got, _ = ex.drain(got)
    out = {"layers": len(m_sync.plan_layers(p_sync)),
           "n_drains": ex.n_drains,
           "same_gather": bool(np.array_equal(p_sync.gather_idx,
                                              p_async.gather_idx)),
           "bitwise": all(_same_bytes(a, b) for (_, a), (_, b) in zip(
               _moe_leaves(ref), _moe_leaves(got))),
           "tables": all(np.array_equal(a.e2r, b.e2r) for a, b in
                         zip(m_sync.tables, m_async.tables)),
           "calibrated": m_async.bandwidth.calibrated}
    tokens = torch.from_numpy(c["tokens"])
    m0 = torch.full(ep_moe.moe_state_shape(mesh, tokens.shape[0]), 0.9)
    place = tuple(torch.from_numpy(np.asarray(t))
                  for t in m_async.device_tables())
    r1 = tf.prefill_forward(ref, cfg, rcfg, {"tokens": tokens}, m0,
                            cache_len=20, placement=place)
    r2 = tf.prefill_forward(got, cfg, rcfg, {"tokens": tokens}, m0,
                            cache_len=20, placement=place)
    out["logits_equal"] = bool(torch.equal(r1.logits, r2.logits))
    return out


def _case_capacity(mesh, c):
    """The reference's ``check_replica_capacity_reduced_cap``: at the
    reduced capacity factor derived from the post-split peak, the
    replicated layout routes the skewed batch with no drop, the bijective
    one overflows."""
    from repro_torch.configs import ReaLBConfig
    from repro_torch.core import ep_moe
    from repro_torch.models.common import use_mesh
    from repro_torch.replication import ReplicaSet, expand_moe_params
    cfg = _cfg("olmoe-1b-7b")
    e = cfg.moe.num_experts
    ep = mesh.size("model")
    e_loc = e // ep
    spr = e_loc + 1
    rcfg = ReaLBConfig(gate_gamma=10 ** 9)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in c["p"].items()}
    x, mod = torch.from_numpy(c["x"]), torch.from_numpy(c["mod"])
    rep_pos = np.zeros((e, 2), np.int32)
    for ex in range(e):
        rep_pos[ex] = (ex // e_loc) * spr + ex % e_loc
    rep_pos[0, 1] = (ep - 1) * spr + e_loc   # on the last rank's spare
    n_rep = np.ones(e, np.int32)
    n_rep[0] = 2
    rs = ReplicaSet(rep_pos, n_rep, ep, spr)
    with use_mesh(None):
        _, _, aux = ep_moe.ep_moe_forward(p, x, cfg, rcfg,
                                          torch.full((1, 1), 0.9), mod,
                                          mode="dispatch")
    el = aux["expert_load"].numpy().astype(np.float64)
    f_red = rs.capacity_factor(el, margin=1.2)
    ident = ReplicaSet.identity(e, ep, slots_per_rank=spr, max_replicas=2)
    cfg_red = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=f_red))
    out = {"hot": float(el[0] / el.sum()),
           "bij_overflows": bool(ident.rank_loads(el).max()
                                 > el.sum() / ep * f_red)}
    logical = {"moe": {k: c["p"][k] for k in MOE}}
    for name, s in (("rep", rs), ("bij", ident)):
        mine = expand_moe_params(_shard({"blocks": {"l0": logical}}, mesh),
                                 s)["blocks"]["l0"]["moe"]
        mine["router"] = p["router"]
        place = tuple(torch.from_numpy(np.asarray(a)) for a in s.as_arrays())
        m = torch.full(ep_moe.moe_state_shape(mesh, x.shape[0]), 0.9)
        xl, ml = _layer_in(mesh, m.shape[0] > 1, True, x, mod)
        _, _, a = ep_moe.ep_moe_forward(mine, xl, cfg_red, rcfg, m, ml,
                                        mode="dispatch", placement=place)
        out[f"drop_{name}"] = float(a["drop_frac"])
    return out


MIGRATE_CASES = {"gather": _case_gather, "failure": _case_failure,
                 "agree": _case_agree, "expand": _case_expand,
                 "ckpt": _case_ckpt, "layers": _case_layers,
                 "async": _case_async, "capacity": _case_capacity}


def migrate_cases(mesh, cases):
    """``{name: payload}`` → ``{name: results}`` for the cases above (and
    the engine arms, ``arms``), each a ``{"error": traceback}`` if it
    raised."""
    out = {}
    for name, c in cases.items():
        fn = MIGRATE_CASES.get(name) or ENGINE_CASES[name]
        try:
            out[name] = fn(mesh, c)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def _serve_arm(mesh, c, after_step=None):
    """One seeded MMMU stream through the EP engine with a placement or
    replica manager (the port's counterpart of ``_torch_managers.run_arm``
    on one side): the bandwidth EWMA logs each gather's bytes and keeps
    its prior, requests arrive on a virtual clock, the routable tables are
    kept after every step."""
    from repro_torch.configs import (PlacementConfig, ReaLBConfig,
                                     ReplicationConfig)
    from repro_torch.core import ep_moe
    from repro_torch.placement import PlacementManager
    from repro_torch.replication import ReplicaManager, expand_moe_params
    from repro_torch.runtime.fault_tolerance import FaultInjector
    from repro_torch.serving.elastic import ElasticCoordinator
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.telemetry import Telemetry
    from repro_torch.workloads import arrivals, multimodal
    cfg = _cfg(c["arch"])
    ep = mesh.size("model")
    kind, mcfg, ekw = c["arm"]
    if kind == "placement":
        mgr = PlacementManager(cfg, PlacementConfig(**mcfg), ep)
    else:
        mgr = ReplicaManager(cfg, ReplicationConfig(**mcfg), ep)
    observed = []
    mgr.bandwidth.observe = lambda nbytes, s: observed.append(int(nbytes))
    params = _shard(c["params"], mesh, cfg=cfg)
    if kind == "replication":
        params = expand_moe_params(
            params, mgr.rsets if mgr.per_layer else mgr.rset)
    ekw = dict(ekw)
    if ekw.get("migrate_async"):
        ekw["migrate_bytes_per_iter"] = 2 * mgr.bytes_per_expert
    clock, tel = arrivals.VirtualClock(), Telemetry()
    extra = {}
    co = None
    if c.get("faults"):
        co = ElasticCoordinator(mgr, ckpt_dir=c["ckpt_dir"], clock=clock,
                                telemetry=tel)
        extra = {"elastic": co,
                 "fault_injector": FaultInjector(
                     [tuple(f) for f in c["faults"]])}
    eng = Engine(cfg, params, ReaLBConfig(**c["policy"]), clock=clock,
                 cost_model=arrivals.IterationCostModel(), placement=mgr,
                 telemetry=tel, device="cpu", **ekw, **c["engine"], **extra)
    if co is not None:
        eng.save_checkpoint(c["ckpt_dir"], 0)
    acfg = dict(kind="poisson", rate=40.0, n_requests=c["n_req"], seed=0)
    specs = multimodal.make_stream(
        multimodal.profile("MMMU"),
        arrivals.arrival_times(arrivals.ArrivalConfig(**acfg)),
        cfg.vocab_size, seed=1, max_prompt=c["max_prompt"])
    comm = ep_moe._dist_comm(mesh)
    comm.census.reset()
    pending = sorted(specs, key=lambda s: s.arrival)
    tables, refused = [], None
    while len(eng.scheduler.finished) < len(specs):
        now = clock()
        while pending and pending[0].arrival <= now:
            eng.submit(pending.pop(0).to_request())
        if eng.scheduler.idle and pending:
            clock.advance(pending[0].arrival - now)
            continue
        eng.step()
        tables.append([np.asarray(a).copy() for a in mgr.device_tables()])
        if co is not None and co.recovering and refused is None:
            try:
                eng.save_checkpoint(c["ckpt_dir"], 1)
                refused = "saved"
            except RuntimeError as err:
                refused = (eng._it, str(err))
    done = {r.uid: r for r in eng.scheduler.finished}
    out = {"tokens": {u: list(r.generated) for u, r in done.items()},
           "finish": {u: r.finish_time for u, r in done.items()},
           "stats": [dataclasses.asdict(st) for st in eng.stats],
           "tables": tables, "m": _np(eng.m_state),
           "moved": eng.migration_bytes_moved, "observed": observed,
           "cap": eng.cfg.moe.capacity_factor,
           "commits": tel.n_plans_committed,
           "sent": _sent(comm), "census": comm.census.snapshot()}
    if co is not None:
        out["events"] = [dict(e) for e in co.events]
        out["refused"] = refused
        out["summary"] = {k: v for k, v in tel.summary().items()
                          if k in ("availability", "degraded_iters",
                                   "n_recoveries", "recovery_s",
                                   "lost_tokens_total")}
    if c.get("save_to"):
        from repro_torch.models.common import tree_items
        eng.drain_migrations()
        out["saved"] = eng.save_checkpoint(c["save_to"], 5)
        held = [t.clone() for _, t in tree_items(eng.params)]
        eng.load_checkpoint(c["save_to"])
        out["reloaded"] = all(_same_bytes(a, b) for a, (_, b) in zip(
            held, tree_items(eng.params)))
    return out


def _case_arms(mesh, arms):
    return {name: _serve_arm(mesh, c) for name, c in arms.items()}


ENGINE_CASES = {"arms": _case_arms}


# --------------------------------------------------------------------------
# elastic serving under a mesh (test_torch_ep_elastic.py)
# --------------------------------------------------------------------------
def _case_kill(mesh, c):
    """The reference's ``check_elastic_kill_rejoin_under_ep`` on the rank:
    EP rank 2 killed (its process zeroes its own slots), the degraded
    layer, the recovery plan drained through the executor with checkpoint
    rows patched in (the checkpoint is the global one the mesh saved), the
    rejoin's warm-up plan, and the effective mesh."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import ReaLBConfig, ReplicationConfig
    from repro_torch.core import ep_moe
    from repro_torch.replication import (ReplicaManager, ReplicaSet,
                                         expand_moe_params)
    from repro_torch.serving.async_migrate import MigrationExecutor
    from repro_torch.serving.elastic import ElasticCoordinator
    cfg = _cfg("olmoe-1b-7b")
    e, ep, my = cfg.moe.num_experts, mesh.size("model"), mesh.index("model")
    rcfg = ReaLBConfig(gate_gamma=10 ** 9)
    router = torch.from_numpy(c["p"]["router"])
    x, mod = torch.from_numpy(c["x"]), torch.from_numpy(c["mod"])
    mgr = ReplicaManager.from_geometry(e, ReplicationConfig(
        enabled=True, spare_per_rank=1, max_replicas=2, replan_every=1,
        warmup_iters=0, min_gain=0.0), ep, bytes_per_expert=256)
    spr = mgr.slots_per_rank
    e_loc = e // ep
    rep_pos = np.zeros((e, 2), np.int32)
    for ex in range(e):
        rep_pos[ex] = (ex // e_loc) * spr + ex % e_loc
    rep_pos[0, 1] = 2 * spr + 2               # expert 0 on rank 2's spare
    n_rep = np.ones(e, np.int32)
    n_rep[0] = 2
    mgr.rsets[0] = ReplicaSet(rep_pos, n_rep, ep, spr)
    wrapped = {"blocks": {"l0": {"moe": {k: c["p"][k] for k in MOE}}}}

    def expanded():
        p = expand_moe_params(_shard(wrapped, mesh), mgr.rset)
        p["blocks"]["l0"]["moe"]["router"] = router
        return p

    params = expanded()
    ckpt.save(c["dir"], 0, {"serving": {"params": params,
                                        "m_state": np.zeros((1, ep))},
                            mgr.ckpt_group: mgr.state_dict()}, mesh=mesh,
              spec={"params": _spec_of(wrapped)})
    co = ElasticCoordinator(mgr, ckpt_dir=c["dir"])

    def run(params):
        place = tuple(torch.from_numpy(np.asarray(a))
                      for a in mgr.device_tables())
        m = torch.full(ep_moe.moe_state_shape(mesh, x.shape[0]), 0.9)
        grouped = m.shape[0] > 1
        xl, ml = _layer_in(mesh, grouped, True, x, mod)
        y, _, aux = ep_moe.ep_moe_forward(params["blocks"]["l0"]["moe"], xl,
                                          cfg, rcfg, m, ml, mode="dispatch",
                                          placement=place)
        return _np(_layer_out(mesh, grouped, True, y)), _np(aux)

    out = {}
    before = [params["blocks"]["l0"]["moe"][k].clone() for k in MOE]
    params = co.fail_rank(2, params)
    moe = params["blocks"]["l0"]["moe"]
    out["zeroed"] = all(bool((moe[k] == 0).all()) for k in MOE)
    out["kept"] = all(torch.equal(moe[k], b) for k, b in zip(MOE, before))
    out["lost"] = sorted(co.lost_experts.tolist())
    out["state_degraded"] = co.state
    out["live_off_dead"] = all(
        2 not in (mgr.rset.rep_pos[ex, :mgr.rset.n_rep[ex]] // spr).tolist()
        for ex in range(e) if ex not in (4, 5))
    out["replica_masked"] = (int(mgr.rset.n_rep[0]),
                             int(mgr.rset.rep_pos[0, 0]))
    out["y_deg"], aux = run(params)
    el, sl = aux["expert_load"], aux["slot_load"]
    out["el_deg"], out["sl_deg"] = el, sl
    out["live_slots"] = {ex: np.unique(mgr.rset.rep_pos[ex, :mgr.rset.n_rep[
        ex]]).tolist() for ex in range(e)}
    es = np.stack([el, np.zeros(e)])[None]
    out["lost_tokens"] = co.lost_token_count(es)
    eff = co.effective_mesh(mesh, lost_axis="model")
    out["effective"] = (eff.size("data"), eff.size("model"),
                        eff.ranks.tolist(), eff.member)

    mgr.observe(es)
    plan = mgr.maybe_replan(1)
    comm = ep_moe._dist_comm(mesh)
    comm.census.reset()
    ex_mig = MigrationExecutor(mgr, plan, bytes_per_iter=1 << 30,
                               priority_layers=co.recovery_layers(plan),
                               patch_fn=co.patch_params)
    while ex_mig.draining:
        params, rep = ex_mig.drain(params)
        co.on_layers_landed(plan, rep.layers)
    out["recovery_sent"] = _sent(comm)
    out["recovery_plan_rows"] = int(plan.crossrank_slots.shape[0])
    out["recovered"] = (co.recovering, co.last_recovery_s is not None,
                        mgr.rset.hosts_rank(2))
    out["patched_bytes"] = co.patched_bytes
    y_rec, aux = run(params)
    y_h, _ = run(expanded())
    out["rec_bitwise"] = bool(np.array_equal(y_rec, y_h))
    out["y_rec"], out["sl_rec"] = y_rec, aux["slot_load"]
    out["rec_slots"] = {ex: np.unique(mgr.rset.rep_pos[ex, :mgr.rset.n_rep[
        ex]]).tolist() for ex in range(e)}

    co.rejoin_rank(2)
    out["state_warming"] = co.state
    out["hosts_before"] = mgr.hosts_rank(2)
    mgr.observe(es)
    plan2 = mgr.maybe_replan(2)
    out["staged_hosts"] = mgr.hosts_rank(2)
    ex2 = MigrationExecutor(mgr, plan2, bytes_per_iter=1 << 30,
                            priority_layers=co.recovery_layers(plan2),
                            patch_fn=co.patch_params)
    while ex2.draining:
        params, rep = ex2.drain(params)
        co.on_layers_landed(plan2, rep.layers)
    out["state_final"], out["hosts_after"] = co.state, mgr.hosts_rank(2)
    out["y_fin"], _ = run(params)
    return out


def _case_reshard(mesh, c):
    """The reference's ``check_elastic_reshard`` with the model's prefill:
    the host tree placed on this mesh, on the mesh that lost data row 1
    (``shrink_mesh``), on the mesh that lost EP rank 0, and on a mesh of
    another EP size over the same ranks."""
    from repro_torch.configs import ReaLBConfig
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Mesh, use_mesh
    from repro_torch.runtime.elastic import reshard, shrink_mesh
    from repro_torch.convert import slot_owner
    cfg = _cfg(c["arch"])
    rcfg = ReaLBConfig(**c["rcfg"])
    tokens = torch.from_numpy(c["tokens"])
    host, place, n_slots = c["params"], None, None
    if c.get("replicas") is not None:
        # a managed, expanded tree: the experts in a replica set's S slots
        place = tuple(np.asarray(a) for a in c["replicas"])
        owner = slot_owner(place, cfg.moe.num_experts)
        n_slots = owner.shape[-1]

        def expand(node, key=None, in_moe=False):
            if isinstance(node, dict):
                return {k: expand(v, k, key == "moe")
                        for k, v in node.items()}
            if in_moe and key in MOE:
                out = np.take(np.asarray(node), np.maximum(owner, 0), -3)
                out[..., owner < 0, :, :] = 0
                return out
            return node
        host = expand(host)
        place = tuple(torch.from_numpy(a) for a in place)

    def logits(m):
        with use_mesh(m):
            p = reshard(host, m, spec=tf.model_spec(cfg, n_slots))
            if p is None:
                return None
            m0 = torch.full(ep_moe.moe_state_shape(m, tokens.shape[0]), 0.9)
            return _np(tf.prefill_forward(p, cfg, rcfg, {"tokens": tokens},
                                          m0, cache_len=20,
                                          placement=place).logits)

    meshes = {"here": mesh, "lost_data_row": shrink_mesh(mesh, "data", 1),
              "lost_ep_rank": shrink_mesh(mesh, "model", 0),
              "other_ep": Mesh((1, 4), "gloo", "cpu")}
    return {name: {"logits": logits(m), "shape": (m.size("data"),
                                                  m.size("model")),
                   "ranks": m.ranks.tolist(), "member": m.member}
            for name, m in meshes.items()}


def _case_elastic_arm(mesh, c):
    return _serve_arm(mesh, c)


ELASTIC_CASES = {"kill": _case_kill, "reshard": _case_reshard,
                 "arm": _case_elastic_arm}


def elastic_cases(mesh, cases):
    out = {}
    for name, c in cases.items():
        try:
            out[name] = ELASTIC_CASES[name](mesh, c)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


# --------------------------------------------------------------------------
# training under a mesh (test_torch_train_mesh.py, test_torch_ckpt_mesh.py)
# --------------------------------------------------------------------------
def train_cfg(c):
    """Reduced olmoe-1b-7b at ``c["layers"]`` layers with the MoE fields
    of ``c["moe"]`` (the reference's recipe: aux coefficients 0, capacity
    factor 8)."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("olmoe-1b-7b"), n_layers=c["layers"])
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **c["moe"]), remat=c.get("remat", "none"))


def _digest(t):
    import hashlib
    t = t.detach().contiguous().reshape(-1)
    return hashlib.sha256(bytes(t.view(torch.uint8).numpy())).hexdigest()


def _replicated_digests(tree):
    from repro_torch.models.common import is_expert_path, tree_items
    return {"/".join(p): _digest(t) for p, t in tree_items(tree)
            if not is_expert_path(p)}


def _state_bytes(params, opt):
    from repro_torch.models.common import tree_leaves
    return [bytes(t.detach().contiguous().reshape(-1).view(torch.uint8)
                  .numpy())
            for t in [*tree_leaves(params), *tree_leaves(opt.mu),
                      *tree_leaves(opt.nu), opt.step]]


def _fsdp_checks(mesh, c, params):
    """The FSDP gather of block 0's ``w_gate``/``w_down`` shards against
    the rank's slots of the whole slab, and its transpose against the sum
    over the data rows of seeded per-row cotangents, bit for bit."""
    from repro_torch.core import ep_moe
    from repro_torch.models.common import FSDP_DIM
    comm = ep_moe._dist_comm(mesh)
    rows, ep = mesh.size("data"), mesh.size("model")
    g, my = mesh.index("data"), mesh.index("model")
    out = {}
    for key in ("w_gate", "w_down"):
        shard = params["blocks"]["layer0"]["moe"][key][0]
        whole = c["params"]["blocks"]["layer0"]["moe"][key][0]
        n = whole.shape[0] // ep
        want = torch.from_numpy(np.array(whole[my * n:(my + 1) * n]))
        full = comm.fsdp_gather(shard, FSDP_DIM[key])
        out[f"gather_{key}"] = _same_bytes(full, want)
        w = shard.clone().requires_grad_()
        cot = [torch.randn(want.shape, generator=torch.Generator()
                           .manual_seed(100 + r)) for r in range(rows)]
        with torch.enable_grad():
            (comm.fsdp_gather(w, FSDP_DIM[key]) * cot[g]).sum().backward()
        total = cot[0]
        for part in cot[1:]:
            total = total + part
        dim = FSDP_DIM[key] % total.dim()
        out[f"reduce_scatter_{key}"] = _same_bytes(
            w.grad, torch.chunk(total, rows, dim=dim)[g])
    return out


def _fsdp_init_is_slice(mesh, cfg):
    """``init_model(fsdp=True)`` under the mesh holds exactly the rank's
    slots and D slice of the one-device init's expert stacks, and every
    other leaf whole."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import (FSDP_DIM, is_expert_path,
                                           tree_items, use_mesh)
    rows, ep = mesh.size("data"), mesh.size("model")
    g, my = mesh.index("data"), mesh.index("model")
    with use_mesh(None):
        whole = dict(tree_items(tf.init_model(cfg, seed=3, device="cpu")))
    for path, t in tree_items(tf.init_model(cfg, seed=3, fsdp=True)):
        w = whole[path]
        if is_expert_path(path):
            n = w.shape[-3] // ep
            w = w.narrow(w.dim() - 3, my * n, n)
            dim = w.dim() + FSDP_DIM[path[-1]]
            w = w.narrow(dim, g * w.shape[dim] // rows, w.shape[dim] // rows)
        if not _same_bytes(t, w):
            return False
    return True


def _compressed_checks(mesh):
    """On the mesh's ``data`` axis: ``compressed_grad_psum`` of seeded
    per-row leaves equals the sum of every row's int8-dequantized leaf,
    its residual plus the rank's own dequantized leaf is the leaf, and
    ``compressed_all_reduce`` carries that sum in every row."""
    from repro_torch.optim import grad_utils as gu
    rows, g = mesh.size("data"), mesh.index("data")

    def leaf(r):
        gen = torch.Generator().manual_seed(200 + r)
        return {"w": torch.randn((4, 8), generator=gen) * 0.1,
                "b": torch.randn((8,), generator=gen)}

    mine = leaf(g)
    err = gu.init_error_feedback(mine)
    red, new_err = gu.compressed_grad_psum(mine, err, "data")
    out = {}
    for k in mine:
        deq = []
        for r in range(rows):
            q, scale = gu._quantize_int8(leaf(r)[k])
            deq.append(q.to(torch.float32) * scale)
        total = deq[0]
        for part in deq[1:]:
            total = total + part
        out[f"sum_{k}"] = _same_bytes(red[k], total)
        out[f"residual_{k}"] = _same_bytes(deq[g] + new_err[k], mine[k])
    stacked = {k: torch.stack([leaf(r)[k] for r in range(rows)])
               for k in mine}
    red_s, err_s = gu.compressed_all_reduce(
        stacked, gu.init_error_feedback(stacked), mesh, "data")
    out["stacked"] = all(_same_bytes(red_s[k][r], red[k])
                         for k in mine for r in range(rows)) and all(
        _same_bytes(err_s[k][g], new_err[k]) for k in mine)
    return out


def _train_steps(mesh, c, cfg, rcfg):
    """Three AdamW steps of ``launch.steps.make_train_step`` on seeded
    batches: the losses, the census of step 1, the replicated leaves'
    digests after step 3; then a step whose loss is not finite on every
    rank (rank 0 poisons a replicated leaf) writes nothing anywhere."""
    from repro_torch.configs import TrainConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ep_moe
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1)
    params = params_from_numpy(c["params"], mesh=mesh, fsdp=True)
    opt = adamw.init_opt_state(params, tcfg)
    m = torch.full(ep_moe.moe_state_shape(mesh, 4), 0.9)
    step = make_train_step(cfg, rcfg, tcfg)
    comm = ep_moe._dist_comm(mesh)
    out = {"losses": []}
    for i, b in enumerate(c["batches"]):
        comm.census.reset()
        params, opt, m, met = step(params, opt, m, _batch(b))
        if i == 0:
            out["census"] = comm.census.snapshot()
        out["losses"].append(float(met["loss"]))
    out["digests"] = _replicated_digests(params)
    out["step"] = int(opt.step)
    if mesh.index("data") == 0 and mesh.index("model") == 0:
        params["final_norm"][0] = float("nan")
    before = _state_bytes(params, opt)
    params, opt, m, met = step(params, opt, m, _batch(c["batches"][0]))
    out["nan_loss"] = float(met["loss"])
    out["nan_untouched"] = before == _state_bytes(params, opt)
    flag = torch.tensor(mesh.index("data") + mesh.index("model") > 0)
    out["agree"] = bool(comm.all_true(flag))
    return out


def _batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _train_mesh_case(mesh, c):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import is_expert_path, tree_items
    from repro_torch.obs.ledger import FlopByteLedger
    from repro_torch.optim import adamw
    from repro_torch.optim.grad_utils import data_parallel_grads, value_and_grad
    cfg, rcfg = train_cfg(c), ReaLBConfig(**c["rcfg"])
    rows, ep = mesh.size("data"), mesh.size("model")
    params = params_from_numpy(c["params"], mesh=mesh, fsdp=True)
    m = torch.full(ep_moe.moe_state_shape(mesh, 4), 0.9)
    (loss, (m_new, met)), grads = value_and_grad(
        tf.train_loss, params, cfg, rcfg, _batch(c["batch"]), m)
    grads = data_parallel_grads(grads)
    out = {"loss": float(loss), "grads": _np(grads), "m": _np(m_new),
           "m_grad": bool(m_new.requires_grad),
           "gnorm": float(adamw.global_norm(grads)),
           "coords": (mesh.index("data"), mesh.index("model"))}
    out.update(_fsdp_checks(mesh, c, params))
    out["init_slice"] = _fsdp_init_is_slice(mesh, cfg)
    if rows > 1:
        out.update(_compressed_checks(mesh))
    out.update(_train_steps(mesh, c, cfg, rcfg))
    shapes = [tuple(t.shape) for p, t in tree_items(params)
              if not is_expert_path(p)]
    out["census_pred"] = FlopByteLedger(cfg, ep=ep).predict_train_census(
        4 // rows * 16 // ep, cfg.n_layers, rows, 4, 4, shapes,
        remat=cfg.remat)
    return out


def _ssm_train_mesh_case(mesh, c):
    """Reduced jamba (``c["arch"]``, MoE fields ``c["moe"]``) on the mesh
    in the FSDP layout: ``train_loss``'s gradient after the data-parallel
    reduction, the replicated leaves' digests, whether each Mamba weight is
    whole on the rank, and the replicated leaves' digests after one AdamW
    step."""
    from repro_torch.configs import ReaLBConfig, TrainConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ep_moe
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_items
    from repro_torch.optim import adamw
    from repro_torch.optim.grad_utils import data_parallel_grads, value_and_grad
    from repro_torch.models import transformer as tf
    cfg = _cfg(c["arch"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **c["moe"]))
    rcfg = ReaLBConfig(**c["rcfg"])
    params = params_from_numpy(c["params"], mesh=mesh, fsdp=True)
    whole = {"/".join(p): tuple(np.shape(v)) for p, v in _flat_np(
        c["params"])}
    ssm_whole = all(tuple(t.shape) == whole["/".join(p)]
                    for p, t in tree_items(params) if "ssm" in p)
    m = torch.full(ep_moe.moe_state_shape(mesh, 4), 0.9)
    (loss, (m_new, _)), grads = value_and_grad(
        tf.train_loss, params, cfg, rcfg, _batch(c["batch"]), m)
    grads = data_parallel_grads(grads)
    out = {"loss": float(loss), "grads": _np(grads), "m": _np(m_new),
           "ssm_whole": ssm_whole, "grad_digests": _replicated_digests(grads),
           "coords": (mesh.index("data"), mesh.index("model"))}
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1)
    step = make_train_step(cfg, rcfg, tcfg)
    params, opt, m, met = step(params, adamw.init_opt_state(params, tcfg), m,
                               _batch(c["batch"]))
    out["step_loss"] = float(met["loss"])
    out["digests"] = _replicated_digests(params)
    return out


def _flat_np(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_np(tree[k], path + (k,))
    else:
        yield path, tree


def ssm_train_mesh_cases(mesh, c):
    try:
        return _ssm_train_mesh_case(mesh, c)
    except Exception:
        return {"error": traceback.format_exc()}


def memory_train_mesh_cases(mesh, c):
    """For each arch of ``c`` (reduced, the reference's weights and a
    batch with its memory): ``train_loss`` on the mesh in the FSDP layout
    (one ``m_state`` group a data row) and its gradient after the
    data-parallel reduction."""
    from repro_torch.configs import ReaLBConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    from repro_torch.optim.grad_utils import data_parallel_grads, value_and_grad
    out = {}
    for arch, case in c.items():
        try:
            params = params_from_numpy(case["params"], mesh=mesh, fsdp=True)
            m = torch.full(ep_moe.moe_state_shape(mesh, 4), 0.9)
            (loss, _), grads = value_and_grad(
                tf.train_loss, params, _cfg(arch), ReaLBConfig(),
                _batch(case["batch"]), m)
            out[arch] = {"loss": float(loss),
                         "grads": _np(data_parallel_grads(grads)),
                         "m_rows": int(m.shape[0])}
        except Exception:
            out[arch] = {"error": traceback.format_exc()}
    return out


def train_mesh_cases(mesh, c):
    try:
        return _train_mesh_case(mesh, c)
    except Exception:
        return {"error": traceback.format_exc()}


def compressed_one_rank(mesh, c):
    """``compressed_all_reduce`` on a 1-rank ``data`` mesh of the
    reference's contract test's inputs."""
    from repro_torch.optim import grad_utils as gu
    grads = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    red, err = gu.compressed_all_reduce(grads, gu.init_error_feedback(grads),
                                        mesh, "data")
    return _np(red), _np(err)


def train_case(mesh, argv):
    """``python -m repro_torch.launch.train`` on every rank."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    return rc, buf.getvalue()


def _ckpt_mesh_case(mesh, c):
    """An FSDP state (parameters, AdamW moments, AIMD state) saved on the
    mesh and restored onto it, onto a ``(1, 2)`` mesh of the first two
    ranks and onto one device, each against the numpy trees it came
    from, byte for byte."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import opt_state_from_numpy, params_from_numpy
    from repro_torch.models.common import Mesh, tree_leaves
    from repro_torch.optim.adamw import OptState

    def state_on(m, fsdp):
        return {"params": params_from_numpy(c["params"], mesh=m, fsdp=fsdp),
                "opt": opt_state_from_numpy(c["opt"], mesh=m, fsdp=fsdp),
                "m": torch.from_numpy(np.array(c["m"]))}

    def same(a, b):
        return all(_same_bytes(x.reshape(-1), y.reshape(-1)) for x, y in zip(
            [*tree_leaves(a["params"]), *_opt_leaves(a["opt"]), a["m"]],
            [*tree_leaves(b["params"]), *_opt_leaves(b["opt"]), b["m"]]))

    mine = state_on(mesh, True)
    path = ckpt.save(c["dir"], 7, mine, mesh=mesh, fsdp=True)
    out = {"path": path}
    step, back = ckpt.restore(c["dir"], mine, mesh=mesh, fsdp=True)
    out["same_mesh"] = step == 7 and same(back, mine)
    sub = Mesh((1, 2), "gloo", "cpu", ranks=[[0, 1]])
    if sub.member:
        want = state_on(sub, True)
        _, back = ckpt.restore(c["dir"], want, mesh=sub, fsdp=True)
        out["sub_mesh"] = same(back, want)
    if mesh.device_mesh.get_rank() == 0:
        want = state_on(None, False)
        _, back = ckpt.restore(c["dir"], want)
        out["one_device"] = same(back, want)
        out["types"] = isinstance(back["opt"], OptState)
    return out


def _opt_leaves(opt):
    from repro_torch.models.common import tree_leaves
    return [*tree_leaves(opt.mu), *tree_leaves(opt.nu), opt.step]


def _trainloop_case(mesh, c):
    """``launch.train.build`` and ``TrainLoop`` on the mesh: preempted on
    one rank after step ``c["stop"]`` (every rank stops there and saves),
    restarted to ``c["steps"]``, against an uninterrupted run: the losses
    after the restart and the final state, bit for bit."""
    from repro_torch.configs import ReaLBConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime.fault_tolerance import TrainLoop
    tcfg = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=c["steps"])
    rcfg = ReaLBConfig(enabled=False)
    last = mesh.device_mesh.get_rank() == mesh.size("data") \
        * mesh.size("model") - 1

    def run(ckpt_dir, until, stop_after=None):
        cfg, state, step_fn = train.build("olmoe-1b-7b", "tiny", 4, 16, tcfg,
                                          rcfg, mesh=mesh, device="cpu")
        losses = []
        holder = {}

        def logged(state, batch):
            new, met = step_fn(state, batch)
            losses.append(met["loss"])
            if stop_after is not None and last \
                    and len(losses) == stop_after:
                holder["loop"]._stop = True       # a signal on one rank
            return new, met

        loop = TrainLoop(logged, ckpt_dir=ckpt_dir, checkpoint_every=2,
                         log_every=1000, logger=lambda *_: None, mesh=mesh)
        holder["loop"] = loop
        start, state = loop.restore_or_init(state)
        data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=4), start_step=start)
        state = loop.run(state, data, until, start_step=start)
        return losses, start, [_digest(t) for t in
                               tree_leaves(state["params"])]

    first, _, _ = run(c["dir"] + "/pre", c["steps"], c["stop"])
    after, start, final = run(c["dir"] + "/pre", c["steps"])
    straight, _, final_straight = run(c["dir"] + "/straight", c["steps"])
    return {"first": first, "after": after, "start": start,
            "straight": straight, "same_final": final == final_straight}


def ckpt_mesh_cases(mesh, c):
    out = {}
    for name, fn in (("ckpt", _ckpt_mesh_case),
                     ("trainloop", _trainloop_case)):
        try:
            out[name] = fn(mesh, c[name])
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


# --------------------------------------------------------------------------
# on the card (test_torch_cuda.py): two ranks on one card, staged backend
# --------------------------------------------------------------------------
def _rows_for(src, dst, n, width):
    """The ``n`` rows rank ``src`` sends rank ``dst`` in the card test."""
    base = torch.arange(n * width, dtype=torch.float32).reshape(n, width)
    return (base + 1000 * src + 100 * dst).to(torch.bfloat16)


def card_gather(mesh, c):
    """``Comm.exchange_rows`` and the in-place cross-rank gather of a
    per-layer plan on the card, through the staged backend: the rows each
    rank receives, and its slots against its slice of the one-device gather
    of the whole stack on the same card, bit for bit."""
    from repro_torch.convert import params_from_numpy, rank_shard
    from repro_torch.core import ep_moe
    from repro_torch.models.common import Mesh, use_mesh
    from repro_torch.placement import migrate as pm
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ep, my = mesh.size("model"), mesh.index("model")
    staged = Mesh((1, ep), "staged", dev)
    width = c["width"]
    count = lambda s, d: 0 if s == d else 3 + s + 2 * d    # noqa: E731
    out = {}
    with use_mesh(staged):
        comm = ep_moe._dist_comm(staged)
        comm.census.reset()
        send = torch.cat([_rows_for(my, j, count(my, j), width)
                          for j in range(ep)]).to(dev)
        recv = comm.exchange_rows(send, [count(my, j) for j in range(ep)],
                                  [count(j, my) for j in range(ep)])
        want = torch.cat([_rows_for(j, my, count(j, my), width)
                          for j in range(ep)])
        out["exchange"] = bool(torch.equal(recv.cpu(), want))
        out["exchange_bytes"] = comm.census.snapshot()[
            "migrate_all_to_all"]["bytes"] == sum(
            count(my, j) for j in range(ep)) * width * 2

        def bf16(tree):
            moe = tree["blocks"]["layer0"]["moe"]
            for k in MOE:
                moe[k] = moe[k].to(torch.bfloat16)
            return tree

        mine = bf16(rank_shard(c["tree"], ep, my, device=dev))
        whole = bf16(params_from_numpy(c["tree"], dev))
        comm.census.reset()
        landed = []
        pm.apply_to_params(mine, _plan(c["rows"]), landed)
        with use_mesh(None):
            pm.apply_to_params(whole, _plan(c["rows"]))
        torch.cuda.synchronize()
        out["landed"] = landed
        out["sent"] = _sent(comm)
        out["gather"] = all(
            _same_bytes(m.cpu(), w.narrow(1, my * (w.shape[1] // ep),
                                          w.shape[1] // ep).cpu())
            for (_, m), (_, w) in zip(_moe_leaves(mine), _moe_leaves(whole)))
    return out


def abstract_mesh_cases(mesh, archs):
    """``{"<arch> <shape> <fsdp>": {key path: (shape, dtype)}}``: this
    rank's ``init_model(mesh=)`` on the ``(2, 2)`` mesh and on a ``(1, 2)``
    mesh of ranks 0 and 1 (every rank builds both, the construction being
    collective), for ``test_torch_dryrun.py``'s abstract meshes."""
    try:
        from repro_torch.models import transformer as tf
        from repro_torch.models.common import Mesh

        def layout(tree, prefix=""):
            if isinstance(tree, dict):
                out = {}
                for k, v in tree.items():
                    out.update(layout(v, f"{prefix}/{k}"))
                return out
            return {prefix: (tuple(tree.shape),
                             str(tree.dtype).split(".")[-1])}

        pair = Mesh((1, 2), "gloo", "cpu", ranks=[[0, 1]])
        out = {}
        for shape, m in (((2, 2), mesh), ((1, 2), pair)):
            if not m.member:
                continue
            for arch in archs:
                for fsdp in (False, True):
                    out[f"{arch} {shape} {fsdp}"] = layout(tf.init_model(
                        _cfg(arch), seed=0, mesh=m, fsdp=fsdp))
        return out
    except Exception:
        return {"error": traceback.format_exc()}


# --------------------------------------------------------------------------
# the tensor-parallel layout (test_torch_tp.py)
# --------------------------------------------------------------------------
TP_POLICY = dict(gate_gamma=10 ** 9, md_init=0.5)     # the gate closed


def _tp_cfg(arch, over=None):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch), **(over or {}))
    if cfg.moe is not None:          # no drops, no per-group losses
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0,
            router_z_coef=0.0))
    return cfg


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _tp_steps(cfg, params, batches, m_state):
    """Prefill, then each later batch as a chunk (``"start"`` in it) or a
    decode step: the logits, ``m_state`` and routing statistics of each."""
    from repro_torch.configs import ReaLBConfig
    from repro_torch.models import transformer as tf
    rcfg = ReaLBConfig(**TP_POLICY)
    pre = batches[0]
    res = tf.prefill_forward(params, cfg, rcfg, _t(pre["batch"]), m_state,
                             cache_len=pre["cache_len"])
    outs = [res]
    for step in batches[1:]:
        fwd = tf.chunk_forward if "start" in step["batch"] \
            else tf.decode_forward
        res = fwd(params, cfg, rcfg, _t(step["batch"]), res.cache,
                  res.m_state)
        outs.append(res)
    return [{"logits": _np(r.logits), "m": _np(r.m_state),
             "experts": _np(r.aux["expert_stats"]),
             "slots": _np(r.aux["slot_stats"])} for r in outs]


def _tp_forward_case(mesh, c):
    """One arch's forwards in the layout and on one device, the latter a
    data row's rows at a time (each data row is its own EP group)."""
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import ROWS, use_mesh
    cfg = _tp_cfg(c["arch"], c.get("over"))
    params = tf.init_model(cfg, seed=0)
    b = c["steps"][0]["batch"]["tokens"].shape[0]
    got = _tp_steps(cfg, params, c["steps"],
                    torch.full(ep_moe.moe_state_shape(mesh, b),
                               TP_POLICY["md_init"]))
    rows = mesh.size(ROWS) if b % mesh.size(ROWS) == 0 else 1
    ref, moved = [], []
    with use_mesh(None):
        whole = tf.init_model(cfg, seed=0, device="cpu")
        for g in range(rows):
            part = [{**s, "batch": {k: v[g * b // rows:(g + 1) * b // rows]
                                    for k, v in s["batch"].items()}}
                    for s in c["steps"]]
            m = torch.full((1, mesh.size("model")), TP_POLICY["md_init"])
            ref.append(_tp_steps(cfg, whole, part, m))
            # the one-device forwards' own change when the embedding
            # moves by two f32 ulps (a random stack's conditioning)
            moved.append([[x["logits"] for x in _tp_steps(
                cfg, dict(whole, embed=whole["embed"] * f), part, m)]
                for f in (1 + 2.0 ** -22, 1 - 2.0 ** -22)])
    return {"got": got, "ref": ref, "moved": moved}


def _tp_engine_case(mesh, c):
    """The engine's stream in the layout and on one device (virtual EP of
    the mesh's ``model`` size)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh
    cfg = _tp_cfg(c["arch"])
    c = dict(c, engine_rcfg=TP_POLICY)
    got = _engine(c, tf.init_model(cfg, seed=0), cfg)
    with use_mesh(None):
        ref = _engine(dict(c, engine=dict(c["engine"],
                                          virtual_ep=mesh.size("model"))),
                      tf.init_model(cfg, seed=0, device="cpu"), cfg)
    return {"got": got, "ref": ref}


def _tp_grads(cfg, params, batch, m_state, perturb=1.0):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.models import layout
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import (current_mesh, cut_of, decl_at,
                                           tree_items)
    from repro_torch.optim.grad_utils import (data_parallel_grads,
                                              value_and_grad)
    if perturb != 1.0:
        params = dict(params, embed=params["embed"] * perturb)
    spec = tf.model_spec(cfg)
    (loss, _), grads = value_and_grad(tf.train_loss, params, cfg,
                                      ReaLBConfig(**TP_POLICY), _t(batch),
                                      m_state)
    mesh = current_mesh()
    if mesh is None:
        return float(loss), {"/".join(p): _np(g)
                             for p, g in tree_items(grads)}
    grads = data_parallel_grads(grads, spec)
    return float(loss), {"/".join(p): _np(layout.whole_leaf(
        g, cut_of(decl_at(spec, p), mesh), mesh))
        for p, g in tree_items(grads)}


def _tp_train_case(mesh, c):
    """A train step's loss and every gradient leaf (whole) in the layout,
    and on one device with the embedding as it is and moved by two f32
    ulps either way (the spread bound of test_torch_train_mesh.py)."""
    from repro_torch.core import ep_moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh
    cfg = _tp_cfg(c["arch"])
    b = c["batch"]["tokens"].shape[0]
    loss, grads = _tp_grads(cfg, tf.init_model(cfg, seed=0), c["batch"],
                            torch.full(ep_moe.moe_state_shape(mesh, b),
                                       0.5))
    out = {"loss": loss, "grads": grads}
    with use_mesh(None):
        whole = tf.init_model(cfg, seed=0, device="cpu")
        m = torch.full((1, mesh.size("model")), 0.5)
        out["ref"] = [_tp_grads(cfg, whole, c["batch"], m, f)
                      for f in (1.0, 1 + 2.0 ** -22, 1 - 2.0 ** -22)]
    return out


def _tp_ckpt_case(mesh, c):
    """The layout's parameters saved under the mesh (every leaf gathered
    whole, rank 0 writing) and restored on one device: equal, leaf for
    leaf, to the one-device init of the same seed."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_items, use_mesh
    cfg = _tp_cfg(c["arch"])
    params = tf.init_model(cfg, seed=5)
    ckpt.save(c["dir"], 1, {"params": params}, mesh=mesh,
              spec=tf.model_spec(cfg))
    with use_mesh(None):
        whole = tf.init_model(cfg, seed=5, device="cpu")
        _, got = ckpt.restore(c["dir"], {"params": whole})
    mine = ckpt.restore(c["dir"], {"params": params}, mesh=mesh,
                        spec=tf.model_spec(cfg))[1]["params"]
    saved = dict(tree_items(got["params"]))
    recut = dict(tree_items(mine))
    return {"restored": all(torch.equal(a, saved[p])
                            for p, a in tree_items(whole)),
            "recut": all(torch.equal(a, recut[p])
                         for p, a in tree_items(params))}


def _tp_census_case(mesh, c):
    """Reduced moonshot's chunk and decode steps under the op-level
    analyzer on the ranks: each step's census and, on rank 0, its counts
    (flops, traffic, memory record, census, aten ops), for the test's
    prediction and the same steps on ``meta`` under the abstract mesh."""
    from repro_torch.configs import ReaLBConfig
    from repro_torch.core import ep_moe
    from repro_torch.launch.steps import analyze_step
    from repro_torch.models import transformer as tf
    cfg = _tp_cfg(c["arch"])
    rcfg = ReaLBConfig(**TP_POLICY)
    params = tf.init_model(cfg, seed=0)
    b = c["chunk"]["tokens"].shape[0]
    cache = tf.init_cache(cfg, b, c["cache_len"])
    m = torch.full(ep_moe.moe_state_shape(mesh, b), 0.5)
    out = {}
    for name, fwd in (("chunk", tf.chunk_forward),
                      ("decode", tf.decode_forward)):
        def step(p, ca, mm, bt, fwd=fwd):
            return fwd(p, cfg, rcfg, bt, ca, mm)
        res, an, mem = analyze_step(step, [params, cache, m, _t(c[name])],
                                    mesh)
        m.copy_(res.m_state)
        out[name] = {"census": an.census, "flops": an.flops,
                     "traffic": int(an.traffic), "memory": mem,
                     "ops": an.n_ops}
    return out


def tp_cases(mesh, c):
    """Every case of test_torch_tp.py: on the ``(2, 2)`` mesh and on a
    ``(1, 2)`` mesh of ranks 0 and 1 (every rank builds both: the
    construction is collective), under the default rules."""
    from repro_torch.models.common import Mesh, use_mesh
    try:
        pair = Mesh((1, 2), "gloo", "cpu", ranks=[[0, 1]])
        out = {}
        for shape, m in (("2x2", mesh), ("1x2", pair)):
            if not m.member:
                continue
            with use_mesh(m, rules={}):
                res = {name: _tp_forward_case(m, f)
                       for name, f in c["forwards"].items()}
                res["engine"] = _tp_engine_case(m, c["engine"])
                res["oneshot"] = _tp_engine_case(m, c["oneshot"])
                res["train"] = _tp_train_case(m, c["train"])
                if shape == "2x2":
                    res["ckpt"] = _tp_ckpt_case(m, c["ckpt"])
                    res["census"] = _tp_census_case(m, c["census"])
            out[shape] = res
        return out
    except Exception:
        return {"error": traceback.format_exc()}


# --------------------------------------------------------------------------
# the EP managers under the default rules (test_torch_layout_ep.py)
# --------------------------------------------------------------------------
def layout_ep_cases(mesh, c):
    """The EP layer, migration, serving-arm and elastic cases of ``c``
    (``{"layer": .., "migrate": .., "elastic": ..}``, each as
    :func:`layer_cases`, :func:`migrate_cases` and :func:`elastic_cases`
    take them) on this mesh under the rules in force; ``c["wide"]``'s on a
    ``(1, world)`` mesh of the same ranks (four EP ranks, the reference's
    scenarios); and with ``c["pair"]`` a one-shot-prefill engine stream
    (reduced jamba) on a ``(1, 2)`` mesh of ranks 0 and 1 under the
    default rules and under ``EP_ONLY_RULES``, each against the one-device
    engine.  Every rank builds every mesh, in the same order (the
    construction is collective)."""
    import torch.distributed as dist
    from repro_torch.models.common import EP_ONLY_RULES, Mesh, use_mesh

    def run(m, cases):
        out = {}
        for name, fn in (("layer", layer_cases), ("migrate", migrate_cases),
                         ("elastic", elastic_cases)):
            if name in cases:
                out[name] = fn(m, cases[name])
        return out
    try:
        wide = Mesh((1, dist.get_world_size()), "gloo", "cpu") \
            if c.get("wide") else None
        pair = Mesh((1, 2), "gloo", "cpu", ranks=[[0, 1]]) \
            if c.get("pair") else None
    except Exception:
        return {"error": traceback.format_exc()}
    out = run(mesh, c)
    if wide is not None:
        with use_mesh(wide):
            out["wide"] = run(wide, c["wide"])
    if pair is not None and pair.member:
        for name, rules in (("layout", {}), ("ep_only", EP_ONLY_RULES)):
            try:
                with use_mesh(pair, rules=rules):
                    out[f"pair_{name}"] = _tp_engine_case(pair, c["pair"])
            except Exception:
                out[f"pair_{name}"] = {"error": traceback.format_exc()}
    return out
