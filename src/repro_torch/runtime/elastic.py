"""Elastic scaling: move weights between meshes of different shape.

Counterpart of ``repro.runtime.elastic``.  When a data row or an EP rank
is lost, serving (or, later, training) resumes on a smaller mesh: the
expert stacks keep their logical slot axis, so resharding is cutting each
rank's ``S/ep`` slots of the host copy anew on the new mesh
(:func:`repro_torch.convert.rank_shard`); an EP size other than the writer's
re-buckets the slots. In the tensor-parallel layout every leaf is cut by the
rules on the new mesh (``reshard(spec=)``,
:func:`repro_torch.convert.layout_shard`). The reverse (scale-up) works
identically. :func:`repro_torch.checkpoint.ckpt.restore` with ``mesh=`` does
the same from a checkpoint on disk.

:func:`shrink_mesh` builds a :class:`~repro_torch.models.common.Mesh`
over the surviving ranks.  A mesh's process groups are made by
``torch.distributed.new_group``, which is collective over the default
group: every rank of the world, the lost one included, calls
:func:`shrink_mesh` with the same arguments, in the same order.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.convert import layout_shard, rank_shard
from repro_torch.models.common import Mesh, layout_spec, use_mesh

Tree = Any


def reshard(host_tree: Tree, new_mesh: Mesh,
            spec: Optional[Tree] = None) -> Optional[Tree]:
    """This rank's parameters on ``new_mesh``, on its device: the host
    tree (the reference's numpy layout, expert stacks ``[.., S, a, b]`` in
    slot order) cut to the rank's ``S/ep`` slots, every other leaf whole;
    in the tensor-parallel layout (``spec``: the model's declarations,
    required there: ``models.common.layout_spec``) every leaf cut by the
    rules, as the reference's ``reshard`` puts each leaf under its
    ``NamedSharding``.  None on a rank that is not in
    ``new_mesh``."""
    if not new_mesh.member:
        return None
    with use_mesh(new_mesh):
        spec = layout_spec(spec, new_mesh)
        if spec is not None:
            return layout_shard(host_tree, spec, new_mesh, new_mesh.device)
    return rank_shard(host_tree, new_mesh.size("model"),
                      new_mesh.index("model"), device=new_mesh.device)


def shrink_mesh(mesh: Mesh, lost_axis: str = "model",
                lost_index: Optional[int] = None) -> Mesh:
    """``mesh`` minus one slice of ``lost_axis`` (node-failure simulation).

    ``lost_index`` selects which slice is lost (default: the last): the
    serving-side elastic coordinator shrinks the EP rank that failed, not
    necessarily the last one.  Collective over the default group (see the
    module docstring)."""
    axes = list(mesh.axis_names)
    if lost_axis not in axes:
        raise ValueError(f"no axis {lost_axis!r} in {axes}")
    i = axes.index(lost_axis)
    n = mesh.size(lost_axis)
    if n <= 1:
        raise ValueError(f"cannot shrink axis {lost_axis} below 1")
    lost = n - 1 if lost_index is None else int(lost_index)
    if not 0 <= lost < n:
        raise ValueError(f"lost_index {lost} out of [0, {n})")
    keep = [j for j in range(n) if j != lost]
    ranks = mesh.ranks.index_select(i, mesh.ranks.new_tensor(keep))
    return Mesh(tuple(ranks.shape), mesh.backend, mesh.device, ranks=ranks)
