"""The tensor-parallel layout's storage against the reference's: every leaf
of ``transformer.abstract_model``, ``abstract_cache`` (each supported
cell's cache) and ``adamw.abstract_opt_state`` of the ten architectures
at their published widths, under the abstract production meshes and
three small ones, has the local shape the reference's ``resolve_spec``
gives its declaration on a stand-in mesh (an object with ``axis_names``
and ``devices.shape``; the multi-pod mesh keeps ``pod``), a stacked
leaf's ``layers`` dim whole.  And the per-device bytes of the state the
five cells of the slice's motivation store.  And the two rule sets the
layers compute by are the only ones ``use_mesh`` takes, and the state's
collective helpers refuse the layout without the model's declarations."""
import types

import numpy as np
import pytest

from repro.configs import get_config as r_get_config
from repro.models import common as rcommon
from repro.models import transformer as rtf
from repro_torch.configs import (ALL_SHAPES, TrainConfig, all_cells,
                                 get_config, get_shape)
from repro_torch.launch.mesh import mesh_for
from repro_torch.models import transformer as tf
from repro_torch.checkpoint import ckpt
from repro_torch.models.common import (DEFAULT_RULES, EP_ONLY_RULES, Mesh,
                                       layout_spec, tree_items, use_mesh)
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import data_parallel_grads
from repro_torch.runtime.elastic import reshard

ARCHS = sorted({a for a, *_ in all_cells()})
MESHES = {"single_pod": None, "multi_pod": None, "1x2": (1, 2),
          "2x2": (2, 2), "2x4": (2, 4)}
GIB = 2 ** 30


def _mesh(name):
    shape = MESHES[name]
    return mesh_for(name, abstract=True) if shape is None \
        else Mesh(shape, "abstract", "meta")


class _StandIn:
    """What the reference's ``resolve_spec`` reads of a mesh."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.shape)
        self.devices = types.SimpleNamespace(shape=tuple(mesh.shape.values()))


def _shard(shape, axes, stand):
    spec = rcommon.resolve_spec(shape, axes, stand)
    sizes = dict(zip(stand.axis_names, stand.devices.shape))
    out = []
    for n, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        parts = 1 if part is None else int(np.prod(
            [sizes[a] for a in ((part,) if isinstance(part, str) else part)]))
        out.append(n // parts)
    return tuple(out)


def _ref_layout(spec, stand, stacks=None, path=()):
    """``{key path: local shape}`` of a reference declaration tree (a
    stacked group's leaves behind their whole ``[n]`` dim)."""
    out = {}
    for k, v in spec.items():
        lead = (stacks or {}).get(k, ())
        if isinstance(v, rcommon.P):
            out[path + (k,)] = lead + _shard(v.shape, v.axes, stand)
        else:
            out.update({p: lead + s for p, s in _ref_layout(
                v, stand, None, path + (k,)).items()})
    return out


def _port_layout(tree):
    return {p: tuple(t.shape) for p, t in tree_items(tree)}


def _bytes(tree):
    return sum(t.numel() * t.element_size() for _, t in tree_items(tree))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_follow_resolve_spec(arch, mesh):
    """Parameters, AdamW moments and each cell's cache: every leaf's
    local shape is the reference's shard shape."""
    m = _mesh(mesh)
    stand = _StandIn(m)
    cfg, rcfg = get_config(arch), r_get_config(arch)
    _, n_blocks, _ = tf.block_structure(cfg)
    stacks = {"blocks": (n_blocks,), "enc_blocks": (cfg.n_enc_layers,)}
    want = _ref_layout(rtf.model_spec(rcfg), stand, stacks)
    params = tf.abstract_model(cfg, mesh=m)
    assert _port_layout(params) == want
    opt = adamw.abstract_opt_state(params, TrainConfig())
    assert _port_layout(opt.mu) == want == _port_layout(opt.nu)
    for arch_, shape, ok, _ in all_cells():
        if arch_ != arch or not ok or get_shape(shape).kind != "decode":
            continue
        sc = get_shape(shape)
        cache = tf.abstract_cache(cfg, sc.global_batch, sc.seq_len, mesh=m)
        ref = _ref_layout(rtf.cache_spec(rcfg, sc.global_batch, sc.seq_len),
                          stand, {"blocks": (n_blocks,)})
        assert _port_layout(cache) == ref, shape


def test_rules_are_the_reference_rules():
    assert DEFAULT_RULES == rcommon.DEFAULT_RULES


# per-device GiB of each cell's stored state: single pod, multi pod
STORED = {("moonshot-v1-16b-a3b", "decode_32k"): (6.23, 3.23),
          ("jamba-1.5-large-398b", "train_4k"): (15.24, 15.24),
          ("llama-3.2-vision-90b", "train_4k"): (4.11, None),
          ("jamba-1.5-large-398b", "prefill_32k"): (3.06, None),
          ("gemma-7b", "decode_32k"): (7.06, None)}


@pytest.mark.parametrize("cell", list(STORED), ids="/".join)
def test_stored_bytes_per_device(cell):
    """The parameters (and a train cell's f32 moments, a decode cell's
    cache) a device stores: the reference's layout's bytes, to the
    hundredth of a GiB."""
    arch, shape = cell
    cfg, sc = get_config(arch), get_shape(shape)
    for kind, gib in zip(("single_pod", "multi_pod"), STORED[cell]):
        if gib is None:
            continue
        m = mesh_for(kind, abstract=True)
        params = tf.abstract_model(cfg, mesh=m)
        total = _bytes(params)
        if sc.kind == "train":
            opt = adamw.abstract_opt_state(params, TrainConfig())
            total += _bytes(opt.mu) + _bytes(opt.nu)
        if sc.kind == "decode":
            total += _bytes(tf.abstract_cache(cfg, sc.global_batch,
                                              sc.seq_len, mesh=m))
        assert round(total / GIB, 2) == gib, (kind, total / GIB)
    assert sc in ALL_SHAPES


@pytest.mark.parametrize("rules", [
    {}, EP_ONLY_RULES, {"ffn": ("model",)}, {"heads": ("model",)},
    dict(EP_ONLY_RULES, batch=("pod", "data"))],
    ids=["default", "ep_only", "ffn_default", "heads_default",
         "ep_only_spelled"])
def test_use_mesh_takes_the_two_layouts(rules):
    m = Mesh((2, 2), "abstract", "meta")
    with use_mesh(m, rules=rules):
        assert layout_spec({"x": 1}, m) == (
            None if rules.get("heads") == () else {"x": 1})


@pytest.mark.parametrize("rules", [
    {"ffn": ()}, {"heads": ()}, {"kv_heads": ()}, {"vocab": ()},
    {"d_inner": ()}, {"seq": ()}, {"kv_seq": ("model",)},
    {"embed": ("model",)}, dict(EP_ONLY_RULES, ffn=("model",)),
    {"unknown": ("model",)}],
    ids=["ffn", "heads", "kv_heads", "vocab", "d_inner", "seq", "kv_seq",
         "embed", "ep_only_but_ffn", "unknown"])
def test_use_mesh_refuses_other_rules(rules):
    """A rule set that cuts a layer otherwise than both layouts would
    store its weights one way and compute them another: refused."""
    with pytest.raises(ValueError, match="EP_ONLY_RULES"):
        use_mesh(Mesh((2, 2), "abstract", "meta"), rules=rules)


@pytest.mark.parametrize("call", ["data_parallel_grads", "global_norm",
                                  "adamw_update", "ckpt_save",
                                  "ckpt_restore", "reshard"])
def test_layout_state_needs_the_declarations(call, tmp_path):
    """Under the default rules on a mesh, each helper that cuts the state
    by the declarations refuses to run without them (under the EP-only
    rules it needs none)."""
    import torch
    tree = {"w": torch.ones(4, 4)}
    ckpt.save(str(tmp_path), 1, {"params": tree})
    m = Mesh((2, 2), "abstract", "meta")
    calls = {
        "data_parallel_grads": lambda: data_parallel_grads(tree),
        "global_norm": lambda: adamw.global_norm(tree),
        "adamw_update": lambda: adamw.adamw_update(
            tree, tree, adamw.init_opt_state(tree, TrainConfig()),
            TrainConfig()),
        "ckpt_save": lambda: ckpt.save(str(tmp_path), 2, {"params": tree},
                                       mesh=m),
        "ckpt_restore": lambda: ckpt.restore(str(tmp_path),
                                             {"params": tree}, mesh=m),
        "reshard": lambda: reshard({"w": np.ones((4, 4))}, m)}
    with use_mesh(m):
        with pytest.raises(ValueError, match="declarations"):
            calls[call]()
    assert layout_spec(None) is None           # no mesh in force
    with use_mesh(m, rules=EP_ONLY_RULES):
        assert layout_spec(None, m) is None
