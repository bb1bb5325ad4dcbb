"""The dry run's cells, yardsticks, abstract trees and meshes against the
reference: ``configs`` (``ALL_SHAPES``, ``all_cells``), ``launch.roofline``
(``model_flops``, ``roofline_terms``), ``transformer.abstract_model`` /
``abstract_cache`` and ``adamw.abstract_opt_state``, the abstract mesh
and the ``local_slice`` rule of a dim that does not divide over its mesh
axis."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RTrainConfig
from repro.configs import all_cells as r_all_cells
from repro.configs import base as rbase
from repro.configs import get_config as r_get_config
from repro.configs import get_shape as r_get_shape
from repro.configs import hw as rhw
from repro.launch import roofline as rroofline
from repro.models import common as rcommon
from repro.models import transformer as rtf
from repro.optim import adamw as radamw
from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, MULTI_POD_MESH,
                                 SINGLE_POD_MESH, TrainConfig, all_cells,
                                 get_config, get_shape, hw, reduced)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import mesh_for
from repro_torch.models import transformer as tf
from repro_torch.models.common import Mesh, local_slice
from repro_torch.optim import adamw

from _torch_arch import layout
from _torch_dist import run_ranks
import _torch_ep_workers as workers


def test_shapes_and_meshes_equal_reference():
    assert [dataclasses.astuple(s) for s in ALL_SHAPES] == [
        dataclasses.astuple(s) for s in rbase.ALL_SHAPES]
    for port, ref in ((SINGLE_POD_MESH, rbase.SINGLE_POD_MESH),
                      (MULTI_POD_MESH, rbase.MULTI_POD_MESH)):
        assert (port.shape, port.axis_names, port.n_devices,
                port.model_axis_size, port.data_axis_size) == (
            ref.shape, ref.axis_names, ref.n_devices, ref.model_axis_size,
            ref.data_axis_size)
    assert SINGLE_POD_MESH.port_shape == (16, 16)
    assert MULTI_POD_MESH.port_shape == (32, 16)


def test_all_cells_equal_reference():
    """40 cells with the reference's supported flags and reasons."""
    cells = all_cells()
    assert len(cells) == 40
    assert cells == r_all_cells()
    assert sum(ok for *_, ok, _ in cells) == 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for shape in ALL_SHAPES:
        assert roofline.model_flops(get_config(arch), get_shape(shape.name)) \
            == rroofline.model_flops(r_get_config(arch),
                                     r_get_shape(shape.name))


@pytest.mark.parametrize("terms", [(1e15, 1e9, 1e6), (1e9, 1e13, 1e6),
                                   (1e9, 1e9, 1e13), (0.0, 0.0, 0.0)],
                         ids=["compute", "memory", "collective", "zero"])
def test_roofline_terms_are_the_reference_formula(terms):
    """Given the reference's constants (TPU v5e rates, links at
    ``MIGRATION_BW_DEFAULT``), the port's terms are the reference's."""
    v5e = hw.Hardware("TPU v5e (reference)", peak_bf16=rhw.PEAK_FLOPS,
                      peak_fp4_gemm=rhw.PEAK_INT8, peak_f32=0.0,
                      hbm_bw=rhw.HBM_BW)
    assert roofline.roofline_terms(*terms, v5e) \
        == rroofline.roofline_terms(*terms)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_equal_reference_at_published_widths(arch):
    """Key paths, shapes and dtypes of the parameters, a cache and the
    AdamW state, at the published widths."""
    cfg, rcfg = get_config(arch), r_get_config(arch)
    params = tf.abstract_model(cfg)
    rparams = rtf.abstract_model(rcfg)
    assert layout(params) == layout(rparams)
    assert all(t.device.type == "meta" for t in layout_leaves(params))
    assert layout(tf.abstract_cache(cfg, 2, 64)) \
        == layout(rtf.abstract_cache(rcfg, 2, 64))
    opt = adamw.abstract_opt_state(params, TrainConfig())
    ropt = radamw.abstract_opt_state(rparams, RTrainConfig())
    assert layout(opt.mu) == layout(ropt.mu)
    assert layout(opt.nu) == layout(ropt.nu)
    assert (tuple(opt.step.shape), str(opt.step.dtype).split(".")[-1]) \
        == (tuple(ropt.step.shape), str(ropt.step.dtype))


def layout_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from layout_leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_equal_init_at_reduced_width(arch):
    """Leaf for leaf the shapes and dtypes ``init_model``, ``init_cache``
    and ``init_opt_state`` allocate."""
    cfg = reduced(get_config(arch))
    params = tf.init_model(cfg, seed=0, device="cpu")
    assert layout(tf.abstract_model(cfg)) == layout(params)
    assert layout(tf.abstract_cache(cfg, 2, 24)) \
        == layout(tf.init_cache(cfg, 2, 24, device="cpu"))
    opt = adamw.init_opt_state(params, TrainConfig())
    aopt = adamw.abstract_opt_state(tf.abstract_model(cfg), TrainConfig())
    assert layout(aopt.mu) == layout(opt.mu)
    assert layout(aopt.nu) == layout(opt.nu)
    assert (aopt.step.shape, aopt.step.dtype) == (opt.step.shape,
                                                  opt.step.dtype)


MESH_ARCHS = ("moonshot-v1-16b-a3b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def gloo_layouts(tmp_path_factory):
    """Rank 0's ``init_model(mesh=)`` layouts on a gloo ``(2, 2)`` mesh and
    a ``(1, 2)`` mesh of two of its ranks, one spawn of four ranks."""
    out = run_ranks(workers.abstract_mesh_cases, (2, 2), list(MESH_ARCHS),
                    tmp_path_factory.mktemp("abstract_mesh"))
    for r in out:
        assert "error" not in r, r.get("error")
    return out[0]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("fsdp", [False, True])
def test_abstract_mesh_leaves_equal_gloo_rank0(gloo_layouts, shape, fsdp):
    """Under an abstract mesh each leaf has the shape and dtype
    ``init_model(mesh=)`` gives rank 0 on the gloo mesh of that shape."""
    for arch in MESH_ARCHS:
        cfg = reduced(get_config(arch))
        mesh = Mesh(shape, "abstract", "meta")
        got = layout(tf.abstract_model(cfg, mesh=mesh, fsdp=fsdp))
        assert got == gloo_layouts[f"{arch} {shape} {fsdp}"]


class _RefMesh:
    """What the reference's ``resolve_spec`` reads of a mesh: its axis names
    and the shape of its device grid (no devices needed)."""

    def __init__(self, rows, ep):
        self.axis_names = ("data", "model")
        self.devices = types.SimpleNamespace(shape=(rows, ep))


# the port's logical axes and what the rule needs of them
_AXES = {"batch": {}, "seq": {}, "expert": {}, "embed": {"fsdp": True}}


@pytest.mark.parametrize("mesh_shape", [(16, 16), (32, 16), (2, 4), (4, 2),
                                        (3, 5), (1, 8)])
def test_local_slice_follows_resolve_spec(mesh_shape):
    """Each logical axis the port maps, over a table of dims: the slice of
    rank 0 of the abstract mesh is the reference's partition of the dim
    (``resolve_spec``'s longest dividing prefix of candidate axes, else
    replicated).  Before, a dim that did not divide raised (the batch of 1
    of the long_500k cells over ``data`` = 16) where the reference
    replicates it."""
    rows, ep = mesh_shape
    mesh = Mesh(mesh_shape, "abstract", "meta")
    sizes = {"data": rows, "model": ep}
    for axis, kw in _AXES.items():
        for n in (1, 2, 3, 4, 6, 8, 15, 16, 32, 48, 64, 256, 4096, 5000):
            spec = rcommon.resolve_spec((n,), (axis,), _RefMesh(rows, ep))
            part = spec[0]
            parts = 1 if part is None else int(np.prod(
                [sizes[a] for a in ((part,) if isinstance(part, str)
                                    else part)]))
            cut = local_slice(n, axis, mesh, **kw)
            assert (cut.start, cut.stop) == (0, n // parts), (axis, n, spec)


def test_long_500k_batch_is_replicated():
    """The cells that used to raise: a batch of 1 over 16 or 32 data
    rows."""
    for kind in ("single_pod", "multi_pod"):
        mesh = mesh_for(kind, abstract=True)
        assert local_slice(1, "batch", mesh) == slice(0, 1)


def test_production_meshes_are_abstract_only():
    single = mesh_for("single_pod", abstract=True)
    multi = mesh_for("multi_pod", abstract=True)
    assert (single.size("data"), single.size("model")) == (16, 16)
    assert (multi.size("data"), multi.size("model")) == (32, 16)
    for m in (single, multi):
        assert m.backend == "abstract" and m.device.type == "meta"
        assert m.index("data") == m.index("model") == 0 and m.member
    assert not torch.distributed.is_initialized()
    for kind in ("single_pod", "multi_pod"):
        with pytest.raises(NotImplementedError, match="abstract=True"):
            mesh_for(kind)
