"""Spawned gloo ranks for the port's multi-rank tests.

``run_ranks(fn, shape, payload, tmp_path)`` starts one process a rank with
the ``spawn`` method, rendezvouses them through a ``FileStore`` under
``tmp_path`` (so concurrent test workers never share a port), builds the
``(data, model)`` mesh of ``shape`` with the gloo backend on the CPU,
runs ``fn(mesh, payload)`` under it in every rank and returns the ranks'
results in rank order. ``rules`` overrides the logical-axis rules
(``models.common.use_mesh``): None, the default, runs under the EP-only layout
(``EP_ONLY_RULES``, which the EP, migration, elastic, FSDP training and
checkpoint tests pin bit for bit); ``{}`` under the tensor-parallel layout of
the default rules. Every spawn is joined within ``deadline`` seconds: past it
the processes are killed and the test fails, so a hung collective cannot run
out the suite's clock. ``fn`` must be importable by name in a fresh
interpreter (a module-level function of a module on ``sys.path``), and
``payload`` and the results picklable.  The payload goes to the ranks
through a pickle file beside the store, not the spawn pipe: a process's
start writes its arguments into a pipe the new interpreter reads only once
it has imported what unpickling them needs, so a payload larger than the
pipe's buffer would start the ranks one after another.
"""
import os
import pickle
import queue as _queue
import time
import traceback

import torch.multiprocessing as mp

DEADLINE_S = 120.0


def _rank_main(fn, rank, world, shape, store_path, payload_path, out,
               rules):
    import torch
    import torch.distributed as dist

    from repro_torch.models.common import EP_ONLY_RULES, Mesh, use_mesh
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            mesh = Mesh(shape, "gloo", "cpu")
            with use_mesh(mesh, rules=EP_ONLY_RULES if rules is None
                          else rules):
                res = fn(mesh, payload)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, shape, payload, tmp_path, deadline: float = DEADLINE_S,
              rules=None):
    world = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{time.time_ns()}")
    with open(store + ".payload", "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, tuple(shape), store,
                               store + ".payload", out, rules),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    end = time.monotonic() + deadline
    try:
        while len(results) + len(errors) < world:
            left = end - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, res = out.get(timeout=min(left, 1.0))
            except _queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) \
                        and out.empty():
                    time.sleep(0.5)
                    if out.empty():
                        break
                continue
            (results.__setitem__(rank, res) if ok
             else errors.append(f"rank {rank}:\n{res}"))
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 0.1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    if alive or len(results) < world:
        raise AssertionError(
            f"{fn.__name__} on a {shape} mesh: {len(results)} of {world} "
            f"ranks finished within {deadline:.0f} s; exit codes "
            f"{[p.exitcode for p in procs]}")
    return [results[r] for r in range(world)]
