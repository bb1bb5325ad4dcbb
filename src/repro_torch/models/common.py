"""Shared model machinery of the port: devices, the device mesh, parameter
declarations and initialisation, norms, activations, RoPE.

Counterpart of the numerics and the mesh context of
``repro.models.common``.  Parameters are declared as :class:`P` leaves
(shape + init, and the logical axis of each dim) and initialised from a
seeded ``torch.Generator`` on the target device: fan-in scaled normals on
the second-to-last dim, ``embed`` normals with their own std, zero norms;
``abstract_params`` gives the same tree as ``meta`` tensors (the dry
run's), with no draw and no allocation.

Under a :class:`Mesh` (``use_mesh``) a rank holds the slice of each
parameter whose logical axes the rules map onto mesh axes; only the
expert stacks have such axes: ``expert`` over ``model`` and, in the FSDP
layout of training (``fsdp=True``), ``embed`` (their D dim) over
``data``.  The rank draws each block whole and keeps its slice, so its
values equal the matching slice of the whole model's and it never holds
the whole stack.  A dim that does not divide over its mesh axis is
replicated, as the reference's ``resolve_spec`` does.  The dry run's
abstract mesh (backend ``"abstract"``) needs no process group and stands
for rank 0.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F

Tree = Any
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one (under a mesh: the rank's device).  With no card and no explicit
    device it raises; it never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if _CTX.mesh is not None:
        return _CTX.mesh.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain versions on the CPU")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the device mesh
# --------------------------------------------------------------------------
AXES = ("data", "model")
# logical name -> mesh axis, as far as the EP path needs them (the
# reference's DEFAULT_RULES): rows over data, the dispatch sequence and the
# expert stacks over model, the experts' D dim over data (FSDP)
RULES: Dict[str, str] = {"batch": "data", "seq": "model", "expert": "model",
                         "embed": "data"}
# axes cut only in the FSDP layout (the reference's ``fsdp=True``)
FSDP_AXES = ("embed",)


class Mesh:
    """A ``("data", "model")`` grid of the ranks of the initialised default
    process group, over ``torch.distributed.device_mesh.DeviceMesh``.

    ``backend`` names how the collectives move: ``"nccl"`` (CUDA tensors,
    one card a rank), ``"gloo"`` (CPU tensors) or ``"staged"`` (CUDA
    tensors copied to the host around gloo collectives: several ranks on
    one card, where NCCL refuses two ranks of one communicator on one
    device and gloo has no CUDA all-to-all; for correctness only).
    ``device`` is where this rank computes.  ``"abstract"`` (the dry
    run's) needs no process group: see :meth:`_abstract`.

    ``ranks`` (a ``rows x ep`` grid of global ranks) builds a mesh over a
    subset of the world, as :func:`repro_torch.runtime.elastic.shrink_mesh`
    does; a rank outside it holds the object but is no ``member``.  The
    construction makes process groups, which is collective over the
    default group: every rank of the world builds every mesh, in the same
    order."""

    axis_names = AXES

    def __init__(self, shape: Tuple[int, int], backend: str,
                 device: Union[str, torch.device], ranks=None):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if backend not in ("nccl", "gloo", "staged", "abstract"):
            raise ValueError(f"mesh backend {backend!r}")
        if backend == "abstract":
            self._abstract(shape)
            return
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised default process "
                               "group (torch.distributed.init_process_group)")
        rows, ep = (int(n) for n in shape)
        world = dist.get_world_size()
        if ranks is None:
            if rows * ep != world:
                raise ValueError(f"mesh {rows}x{ep} over {world} ranks")
            ranks = torch.arange(rows * ep).reshape(rows, ep)
        ranks = torch.as_tensor(ranks, dtype=torch.long).reshape(rows, ep)
        if len(set(ranks.reshape(-1).tolist())) != rows * ep \
                or int(ranks.min()) < 0 or int(ranks.max()) >= world:
            raise ValueError(f"mesh ranks {ranks.tolist()} in a world of "
                             f"{world}")
        self.shape = {"data": rows, "model": ep}
        self.backend = backend
        self.device = torch.device(device)
        self.ranks = ranks
        self.device_mesh = DeviceMesh(
            "cuda" if backend == "nccl" else "cpu", ranks,
            mesh_dim_names=AXES)
        # the group of all the mesh's ranks (None: the default group)
        self._all = None if rows * ep == world else dist.new_group(
            sorted(ranks.reshape(-1).tolist()))
        self.comm = None          # built by core.ep_moe on first use

    def _abstract(self, shape: Tuple[int, int]) -> None:
        """The ``"abstract"`` backend: no process group and no collective;
        this process stands for rank 0 (coordinate 0 on every axis) and
        computes on ``meta``.  ``core.ep_moe.Comm`` gives each collective
        its output's shape and counts it; the dry run
        (``launch.steps.lower_cell``) builds cells under it."""
        rows, ep = (int(n) for n in shape)
        self.shape = {"data": rows, "model": ep}
        self.backend = "abstract"
        self.device = torch.device("meta")
        self.ranks = torch.arange(rows * ep).reshape(rows, ep)
        self.device_mesh = None
        self._all = None
        self.comm = None

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        if self.device_mesh is None:
            return True
        return self.device_mesh.get_coordinate() is not None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: Optional[str] = None):
        """The process group of the ranks that share every other axis
        (``None``: every rank of the mesh; an abstract mesh has none)."""
        if axis is None or self.device_mesh is None:
            return self._all
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, backend={self.backend!r}, "
                f"device={self.device})")


class _MeshCtx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None


_CTX = _MeshCtx()


class use_mesh:
    """Context manager activating a mesh (``None``: no mesh)."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self._saved: Optional[Mesh] = None

    def __enter__(self):
        self._saved, _CTX.mesh = _CTX.mesh, self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _CTX.mesh = self._saved
        return False


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def ep_size(mesh: Optional[Mesh]) -> int:
    """The EP group size: the mesh's ``model`` axis, 1 without a mesh."""
    return 1 if mesh is None else mesh.size("model")


def local_slice(n: int, axis: Optional[str], mesh: Optional[Mesh],
                fsdp: bool = False) -> slice:
    """The slice of a dim of size ``n`` with logical axis ``axis`` that this
    rank holds: the whole dim unless the rules map ``axis`` onto a mesh
    axis of size > 1 that divides ``n`` (an ``FSDP_AXES`` axis only with
    ``fsdp``).  A dim that does not divide is replicated, as the
    reference's ``resolve_spec`` keeps the longest prefix of candidate
    axes whose product divides it (the port's rules name one axis each)."""
    if axis in FSDP_AXES and not fsdp:
        return slice(0, n)
    mesh_axis = RULES.get(axis) if axis is not None else None
    if mesh is None or mesh_axis is None or mesh.size(mesh_axis) == 1:
        return slice(0, n)
    parts = mesh.size(mesh_axis)
    if n % parts:
        return slice(0, n)
    i = mesh.index(mesh_axis)
    return slice(i * n // parts, (i + 1) * n // parts)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter; ``axes`` names the logical axis of each
    dim (None: every dim replicated)."""

    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # stddev multiplier
    dtype: Optional[str] = None   # override the model param dtype
    axes: Optional[Tuple[Optional[str], ...]] = None


def init_leaf(p: P, gen: torch.Generator, default_dtype: str,
              device: torch.device, stack: int = 0,
              mesh: Optional[Mesh] = None, fsdp: bool = False
              ) -> torch.Tensor:
    """One parameter (``stack`` adds a leading block dim).  Stacked normals
    are drawn one block at a time in f32, so the f32 draw never holds more
    than one block of the parameter.  Under ``mesh`` the result is this
    rank's slice (with ``fsdp``, the FSDP layout's), cut from each block's
    whole draw."""
    cut = tuple(local_slice(n, a, mesh, fsdp)
                for n, a in zip(p.shape, p.axes or (None,) * len(p.shape)))
    local = tuple(c.stop - c.start for c in cut)
    shape = (stack, *local) if stack else local
    dt = DTYPES[p.dtype or default_dtype]
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if p.init == "embed":
        std = p.scale
    else:   # fan-in scaled init on the second-to-last dim
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dt, device=device)
    for block in (out if stack else (out,)):
        block.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32,
                                device=device)[cut] * std)
    return out


def abstract_leaf(p: P, default_dtype: str, stack: int = 0,
                  mesh: Optional[Mesh] = None, fsdp: bool = False
                  ) -> torch.Tensor:
    """:func:`init_leaf`'s shape and dtype as a ``meta`` tensor: no
    generator, no allocation.  Under ``mesh``, this rank's slice (the
    abstract mesh's rank 0)."""
    local = tuple(c.stop - c.start for c in (
        local_slice(n, a, mesh, fsdp)
        for n, a in zip(p.shape, p.axes or (None,) * len(p.shape))))
    shape = (stack, *local) if stack else local
    return torch.empty(shape, dtype=DTYPES[p.dtype or default_dtype],
                       device="meta")


def abstract_params(tree: Tree, default_dtype: str, stack: int = 0,
                    mesh: Optional[Mesh] = None, fsdp: bool = False) -> Tree:
    """:func:`init_params`' tree as ``meta`` tensors (the reference's
    ``abstract_params``, with the port's layout under ``mesh``)."""
    if isinstance(tree, P):
        return abstract_leaf(tree, default_dtype, stack, mesh, fsdp)
    return {k: abstract_params(tree[k], default_dtype, stack, mesh, fsdp)
            for k in sorted(tree)}


def init_params(tree: Tree, gen: torch.Generator, default_dtype: str,
                device: torch.device, stack: int = 0,
                mesh: Optional[Mesh] = None, fsdp: bool = False) -> Tree:
    """Initialise a nested dict of :class:`P` (in sorted key order)."""
    if isinstance(tree, P):
        return init_leaf(tree, gen, default_dtype, device, stack, mesh, fsdp)
    return {k: init_params(tree[k], gen, default_dtype, device, stack, mesh,
                           fsdp)
            for k in sorted(tree)}


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    gelu = lambda v: F.gelu(v, approximate="tanh")   # noqa: E731 jax default
    return {"swiglu": F.silu, "geglu": gelu, "gelu": gelu}[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, computed in f64 and rounded once to f32: XLA's
    f32 ``pow`` is correctly rounded in all but at most one entry of a
    head, torch's f32 ``pow`` is not, and a frequency one ulp off moves the
    angle at position p by p ulps."""
    return (1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                          device=device) / head_dim))
            ).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (absolute token positions)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [d/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, d/2]
    angles = angles[..., None, :]                            # [..., S, 1, d/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to every tensor leaf of a nested dict (with the
    matching leaves of ``rest``, dicts of the same keys, as more
    arguments)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> Iterator[torch.Tensor]:
    """The tensor leaves of a nested dict in sorted key order (the order of
    ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_items(tree: Tree, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``(key path, leaf)`` of a nested dict, in :func:`tree_leaves`'
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield path, tree


EXPERT_KEYS = ("w_gate", "w_up", "w_down")
# the dim of each expert stack that the FSDP layout cuts over ``data``
# (``embed``: D)
FSDP_DIM = {"w_gate": -2, "w_up": -2, "w_down": -1}


def is_expert_path(path: Tuple[str, ...]) -> bool:
    """Whether a key path names an expert stack (``.../moe/w_*``), the
    leaves a mesh cuts over its ranks."""
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in EXPERT_KEYS


def row_chunks(t: torch.Tensor, max_elems: int) -> list:
    """Views of ``t`` along its first dim of at most ``max_elems`` elements
    each (a larger row alone): ``[t]`` when it fits or has no dim.  An
    elementwise pass over the chunks in turn holds one chunk's
    temporaries, not the whole tensor's."""
    if t.dim() == 0 or t.numel() <= max_elems:
        return [t]
    row = max(t.numel() // max(t.shape[0], 1), 1)
    return list(torch.split(t, max(1, max_elems // row), dim=0))


def tree_bytes(tree: Tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


Params = Dict[str, torch.Tensor]
