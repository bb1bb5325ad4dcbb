"""Mesh construction over the initialised ``torch.distributed`` group.

Counterpart of ``repro.launch.mesh``.  ``mesh_for("host")`` is the
``(1, world)`` mesh of every rank of the default process group (one EP
group over the ``model`` axis); ``make_mesh`` builds any ``(data, model)``
grid of it.  The reference's production meshes (``single_pod`` 16×16,
``multi_pod`` 2×16×16) exist here only as abstract meshes, for the dry
run (``mesh_for(kind, abstract=True)``, ``make_production_mesh``): no
process group, rank 0's coordinates, computation on ``meta``, the
multi-pod mesh's ``pod`` axis kept.  Without ``abstract=True`` they are
refused.

The backend of the collectives follows the process group and the device:
an NCCL group gives ``"nccl"``; a gloo group gives ``"gloo"`` on the CPU
and ``"staged"`` on a card (copies to the host around each collective).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                     MeshConfig)
from repro_torch.models.common import Mesh


def rank_device(backend: str) -> torch.device:
    """Where this rank computes: its own card under NCCL (``LOCAL_RANK``,
    else the rank modulo the cards), the current card when staged, else
    the CPU."""
    import torch.distributed as dist
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() % torch.cuda.device_count()))
        return torch.device("cuda", local)
    if backend == "staged":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(device: str) -> None:
    """Initialise the default process group from the launcher's environment
    (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``): NCCL for ``cuda``, gloo for ``cpu``.  A group that is
    already initialised is kept."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--mesh host needs ranks: launch under torchrun "
                           "(RANK and WORLD_SIZE are not set) or initialise "
                           "torch.distributed first")
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://",
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", init_method="env://")


def make_mesh(shape: Tuple[int, int], backend: Optional[str] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """A ``(data, model)`` mesh over the default group.  ``backend`` None
    follows the group and ``device``; ``device`` None is the rank's
    device for that backend."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise torch.distributed "
                           "(or launch under torchrun) before building a mesh")
    if backend is None:
        if dist.get_backend() == "nccl":
            backend = "nccl"
        else:
            on_card = device is not None and torch.device(device).type == "cuda"
            backend = "staged" if on_card else "gloo"
    return Mesh(shape, backend, rank_device(backend) if device is None
                else device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as an abstract mesh: 16×16 (256
    devices) or 2×16×16 (512), ``pod`` kept as an axis: the rules cut a
    batch over ``pod`` × ``data`` (32) and a weight's D dim over ``data``
    alone (16), as the reference's ``resolve_spec`` does."""
    return Mesh(mesh_config_for("multi_pod" if multi_pod else "single_pod")
                .shape, "abstract", "meta")


def mesh_config_for(kind: str) -> MeshConfig:
    return MULTI_POD_MESH if kind in ("multi", "multi_pod") \
        else SINGLE_POD_MESH


def mesh_for(kind: str, backend: Optional[str] = None,
             device: Union[str, torch.device, None] = None,
             abstract: bool = False) -> Mesh:
    if kind in ("single", "single_pod", "multi", "multi_pod"):
        if abstract:
            return make_production_mesh(multi_pod=kind.startswith("multi"))
        raise NotImplementedError(
            f"mesh {kind!r} is a TPU pod slice (16x16 or 2x16x16 chips); the "
            "port builds the host mesh over the ranks torchrun starts (the "
            "dry run builds it abstract: abstract=True)")
    if kind == "host":
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("--mesh host needs an initialised process "
                               "group (launch under torchrun)")
        return make_mesh((1, dist.get_world_size()), backend, device)
    raise ValueError(f"unknown mesh kind {kind!r}")
