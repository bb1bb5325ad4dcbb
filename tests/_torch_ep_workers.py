"""Rank-side halves of the port's multi-rank tests (``test_torch_ep*.py``).

Each function runs in a spawned gloo rank (``_torch_dist.run_ranks``) under
the mesh, imports only torch and the port, takes numpy inputs and returns
numpy results; the test process holds them against the reference.  A case
that raises returns ``{"error": traceback}`` so the other cases still
report."""
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


def _layer_case(mesh, c):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.convert import rank_shard
    from repro_torch.core import ep_moe
    cfg = _cfg(c.get("arch", "olmoe-1b-7b"))
    ep, rank = mesh.size("model"), mesh.index("model")
    p = rank_shard({"moe": c["p"]}, ep, rank, c.get("placement"),
                   device="cpu")["moe"]
    rcfg = ReaLBConfig(**c["rcfg"])
    m = torch.from_numpy(np.asarray(c["m"], np.float32))
    x = torch.from_numpy(c["x"])
    mod = torch.from_numpy(c["mod"])
    valid = None if c.get("valid") is None else torch.from_numpy(c["valid"])
    comm = ep_moe._dist_comm(mesh)
    comm.census.reset()
    rec = {"pred": [], "fp4_rows": []}
    with _kernel_record(rec):
        for _ in range(c.get("calls", 1)):   # chained: y feeds the next
            x, m, aux = ep_moe.ep_moe_forward(
                p, x, cfg, rcfg, m, mod, mode=c["mode"], valid=valid,
                placement=_placement(c.get("placement")))
    out = {"y": _np(x), "m": _np(m), "aux": _np(aux),
           "census": comm.census.snapshot(), **rec}
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


def _engine(c, params, cfg, placement=None):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    from repro_torch.workloads.arrivals import IterationCostModel, VirtualClock
    clock = VirtualClock()
    eng = Engine(cfg, params, ReaLBConfig(**c["engine_rcfg"]), clock=clock,
                 cost_model=IterationCostModel(), device="cpu",
                 placement=placement, **c["engine"])
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
    from repro_torch.configs import PlacementConfig, ReaLBConfig
    from repro_torch.convert import rank_shard
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh
    from repro_torch.placement import PlacementManager
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
    # a manager's tables serve as they stand; its first migration raises
    mgr = PlacementManager(cfg, PlacementConfig(replan_every=2,
                                                warmup_iters=1,
                                                min_gain=0.0), ep)
    try:
        _engine(c, params, cfg, placement=mgr)
        out["migration"] = "ran"
    except NotImplementedError as err:
        out["migration"] = str(err)
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
