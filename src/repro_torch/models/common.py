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
parameter that the logical-axis rules give it: the reference's
``DEFAULT_RULES`` and ``resolve_spec`` (for each dim, left to right, the
longest prefix of its candidate mesh axes whose product divides it, no
axis twice in one array; a dim that does not divide is replicated), with
``use_mesh(mesh, rules=...)``'s override merged over them.  Under the
defaults that is the tensor-parallel layout of ``models.layout``; under
:data:`EP_ONLY_RULES` only the expert stacks are cut (their D dim over
``data`` only in the FSDP layout, ``fsdp=True``); no other rule set is
accepted (:data:`LAYOUTS`).  The rank draws each
block whole and keeps its slice, so its values equal the matching slice
of the whole model's.  The dry run's abstract mesh (backend
``"abstract"``; the multi-pod mesh keeps its ``pod`` axis) needs no
process group and stands for rank 0.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import (Any, Callable, Dict, Iterator, Optional, Sequence,
                    Tuple, Union)

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
# the device mesh and the logical-axis rules
# --------------------------------------------------------------------------
AXES = ("data", "model")
# the axes a batch is cut over (an abstract multi-pod mesh keeps ``pod``)
ROWS = ("pod", "data")
# logical name -> mesh axes to try, in order (the reference's
# DEFAULT_RULES): the longest prefix whose product divides the dim is
# used, never an axis twice in one array (left to right)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),            # sequence parallelism of activations
    "kv_seq": ("data", "model"),  # the cache's sequence dim
    "vocab": ("model",),
    "embed": ("data",),           # FSDP on the D dim of every weight
    "ffn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "d_inner": ("model",),        # the Mamba layer's inner dim
    "layers": (),                 # stacked block dim: never cut
    "rank": (),                   # MLA's low-rank dims: replicated
}
# the EP-only layout, a rules override (``use_mesh(mesh,
# rules=EP_ONLY_RULES)``): only the expert stacks (``expert``), the rows
# (``batch``) and the MoE layer's dispatch sequence are cut; the dense
# part, the activations between layers and the cache are replicated over
# ``model``, and the expert stacks' D dim is cut over ``data`` only in the
# FSDP layout (``fsdp=True``, :attr:`P.fsdp` leaves)
EP_ONLY_RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": (), "embed": (), "ffn": (), "heads": (), "kv_heads": (),
    "d_inner": (), "kv_seq": ()}
# the FSDP layout's cut of the expert stacks' D dim (``embed``) under a
# rules set that leaves ``embed`` whole
FSDP_EMBED = ("data",)


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
    order.

    An axis argument (``size``, ``index``, ``group``) is a name, a tuple
    of names (their product, row-major in the mesh's order; an axis the
    mesh lacks counts 1) or None (every axis)."""

    axis_names = AXES

    def __init__(self, shape: Tuple[int, ...], backend: str,
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

    def _abstract(self, shape: Tuple[int, ...]) -> None:
        """The ``"abstract"`` backend: no process group and no collective;
        this process stands for rank 0 (coordinate 0 on every axis) and
        computes on ``meta``.  ``core.ep_moe.Comm`` gives each collective
        its output's shape and counts it; the dry run
        (``launch.steps.lower_cell``) builds cells under it.  A 3-tuple
        ``shape`` is ``(pod, data, model)``: the reference's multi-pod
        mesh, whose ``pod`` axis only the ``batch`` rule names."""
        shape = tuple(int(n) for n in shape)
        self.axis_names = ("pod",) + AXES if len(shape) == 3 else AXES
        self.shape = dict(zip(self.axis_names, shape))
        self.backend = "abstract"
        self.device = torch.device("meta")
        self.ranks = torch.arange(math.prod(shape)).reshape(-1, shape[-1])
        self.device_mesh = None
        self._all = None
        self.comm = None

    def _axes(self, axes) -> Tuple[str, ...]:
        """The mesh's own axes among ``axes``, in the mesh's order."""
        if axes is None:
            return tuple(self.axis_names)
        named = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in named)

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        if self.device_mesh is None:
            return True
        return self.device_mesh.get_coordinate() is not None

    def size(self, axes="data") -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes="data") -> int:
        """This rank's coordinate along ``axes`` (row-major over a
        tuple)."""
        out = 0
        for a in self._axes(axes):
            i = 0 if self.device_mesh is None \
                else self.device_mesh.get_local_rank(a)
            out = out * self.shape[a] + i
        return out

    def group(self, axes=None):
        """The process group of the ranks that share every other axis
        (``None`` or every axis: every rank of the mesh; an abstract mesh
        has none)."""
        named = self._axes(axes)
        if self.device_mesh is None or len(named) != 1:
            return self._all
        return self.device_mesh.get_group(named[0])

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, backend={self.backend!r}, device={self.device})"


class _MeshCtx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)


_CTX = _MeshCtx()


def _merged(rules: Dict) -> Dict[str, Tuple[str, ...]]:
    return {k: tuple(v) for k, v in {**DEFAULT_RULES, **rules}.items()}


# the rule sets the port's layers compute by: ``models.layout`` takes a
# layer's column- or row-parallel form from whether its dim divides over
# ``model``, which holds where the rules cut every such dim over
# ``model`` (the defaults) or none (the EP-only rules)
LAYOUTS = (_merged({}), _merged(EP_ONLY_RULES))


class use_mesh:
    """Context manager activating a mesh (``None``: no mesh) and, with
    ``rules``, an override of the logical-axis rules merged over
    :data:`DEFAULT_RULES` (the reference's ``use_mesh``); without it the
    rules in force stay.  The merged rules must be one of
    :data:`LAYOUTS` (the defaults or :data:`EP_ONLY_RULES`): under any
    other set the weights would be stored by the rules and computed by
    the tensor-parallel layout's choice, so it is refused."""

    def __init__(self, mesh: Optional[Mesh], rules: Optional[Dict] = None):
        if rules is not None and _merged(rules) not in LAYOUTS:
            raise ValueError(
                f"rules {rules!r}: the port computes under the default "
                "rules or EP_ONLY_RULES only (an override merged over "
                "DEFAULT_RULES must give one of them)")
        self.mesh, self.rules = mesh, rules
        self._saved: Tuple = ()

    def __enter__(self):
        self._saved = (_CTX.mesh, _CTX.rules)
        _CTX.mesh = self.mesh
        if self.rules is not None:
            _CTX.rules = _merged(self.rules)
        return self.mesh

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._saved
        return False


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def current_rules() -> Dict[str, Tuple[str, ...]]:
    return _CTX.rules


def tensor_parallel(mesh: Optional[Mesh] = None) -> bool:
    """Whether the rules in force are the tensor-parallel layout (the
    default: heads, FFN, vocab and the Mamba layer's channels over
    ``model``, every weight's D dim over ``data``, the residual
    sequence-parallel between layers) on a mesh of more than one rank.
    False under :data:`EP_ONLY_RULES`."""
    mesh = current_mesh() if mesh is None else mesh
    return mesh is not None and mesh.size(None) > 1 \
        and "model" in current_rules()["heads"]


def layout_spec(spec: Optional[Tree], mesh: Optional[Mesh] = None
                ) -> Optional[Tree]:
    """The model's declarations (``transformer.model_spec``) where the
    tensor-parallel layout is in force on ``mesh`` (default: the current
    one), None where it is not (no mesh of more than one rank, or the
    EP-only rules).  The optimizer, the data-parallel sums, the
    checkpoint and ``reshard`` cut by them; in the layout a caller that
    leaves them out is refused, since a cut leaf would pass for a whole
    one."""
    if not tensor_parallel(mesh):
        return None
    if spec is None:
        raise ValueError("the tensor-parallel layout needs the model's "
                         "declarations: pass spec=transformer.model_spec("
                         "cfg)")
    return spec


def ep_size(mesh: Optional[Mesh]) -> int:
    """The EP group size: the mesh's ``model`` axis, 1 without a mesh."""
    return 1 if mesh is None else mesh.size("model")


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh: Mesh, rules: Optional[Dict] = None,
                 fsdp: bool = False) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes that cut each dim (``()``: replicated), the
    reference's ``resolve_spec``: for each dim, left to right, the
    longest prefix of its logical axis's candidate mesh axes (those the
    mesh has and no earlier dim used) whose product divides the dim.
    ``fsdp`` (an FSDP leaf, :attr:`P.fsdp`) cuts ``embed`` over
    :data:`FSDP_EMBED` when the rules leave it whole."""
    rules = current_rules() if rules is None else rules
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        cand_all = rules.get(name, ()) if name is not None else ()
        if fsdp and name == "embed" and not cand_all:
            cand_all = FSDP_EMBED
        cand = [a for a in cand_all if a in mesh.shape and a not in used]
        chosen: Tuple[str, ...] = ()
        prod = 1
        for a in cand:
            if dim % (prod * mesh.shape[a]) == 0:
                prod *= mesh.shape[a]
                chosen += (a,)
            else:
                break
        used.update(chosen)
        out.append(chosen)
    return tuple(out)


def leaf_cuts(shape: Sequence[int], axes: Optional[Sequence[Optional[str]]],
              mesh: Optional[Mesh], fsdp: bool = False) -> Tuple[slice, ...]:
    """This rank's slice of each dim of an array of logical ``axes``
    (None: every dim replicated), as :func:`resolve_spec` cuts it."""
    if mesh is None or axes is None:
        return tuple(slice(0, n) for n in shape)
    out = []
    for n, cut in zip(shape, resolve_spec(shape, axes, mesh, fsdp=fsdp)):
        parts = mesh.size(cut) if cut else 1
        i = mesh.index(cut) if cut else 0
        out.append(slice(i * n // parts, (i + 1) * n // parts))
    return tuple(out)


def local_slice(n: int, axis: Optional[str], mesh: Optional[Mesh],
                fsdp: bool = False) -> slice:
    """The slice of a dim of size ``n`` with logical axis ``axis`` that this
    rank holds (:func:`leaf_cuts` of a one-dim array): the whole dim
    unless the rules map ``axis`` onto mesh axes whose product divides
    ``n`` (a dim that does not divide is replicated, as the reference's
    ``resolve_spec`` keeps the longest dividing prefix)."""
    return leaf_cuts((n,), (axis,), mesh, fsdp)[0]




# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter; ``axes`` names the logical axis of each
    dim (None: every dim replicated).  ``fsdp`` marks the leaves whose
    ``embed`` dim the FSDP layout cuts (the expert stacks) under rules
    that leave ``embed`` whole."""

    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # stddev multiplier
    dtype: Optional[str] = None   # override the model param dtype
    axes: Optional[Tuple[Optional[str], ...]] = None
    fsdp: bool = False


def init_leaf(p: P, gen: torch.Generator, default_dtype: str,
              device: torch.device, stack: int = 0,
              mesh: Optional[Mesh] = None, fsdp: bool = False
              ) -> torch.Tensor:
    """One parameter (``stack`` adds a leading block dim, never cut).
    Stacked normals are drawn one block at a time in f32, so the f32 draw
    never holds more than one block of the parameter.  Under ``mesh`` the
    result is this rank's slice by the rules in force (with ``fsdp``, the
    FSDP layout's), cut from each block's whole draw."""
    cut = leaf_cuts(p.shape, p.axes, mesh, fsdp and p.fsdp)
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


def decl_at(spec: Tree, path) -> Optional[P]:
    """The declaration at key ``path`` of a tree of :class:`P` (None where
    the path leads elsewhere)."""
    p = spec
    for k in path:
        if not isinstance(p, dict) or k not in p:
            return None
        p = p[k]
    return p if isinstance(p, P) else None


def cut_of(p: P, mesh: Mesh) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes that cut each dim of a declaration
    (:func:`resolve_spec`)."""
    return resolve_spec(p.shape, p.axes or (None,) * len(p.shape), mesh)


def abstract_leaf(p: P, default_dtype: str, stack: int = 0,
                  mesh: Optional[Mesh] = None, fsdp: bool = False
                  ) -> torch.Tensor:
    """:func:`init_leaf`'s shape and dtype as a ``meta`` tensor: no
    generator, no allocation.  Under ``mesh``, this rank's slice (the
    abstract mesh's rank 0)."""
    local = tuple(c.stop - c.start for c in
                  leaf_cuts(p.shape, p.axes, mesh, fsdp and p.fsdp))
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
