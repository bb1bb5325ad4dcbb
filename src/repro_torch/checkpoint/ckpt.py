"""Atomic, async checkpoints in the reference's on-disk format.

Counterpart of ``repro.checkpoint.ckpt``.  Format: one ``.npz`` per
top-level state group holding flattened ``path -> array`` entries (keys
joined by ``|``), plus a ``meta.json`` with the step and the groups.  A
save writes into a temp directory and renames it, so a crash mid-save
never corrupts the latest checkpoint; ``keep`` old steps are retained.

Trees are nested dicts, lists, tuples and NamedTuples (an optimizer's
``OptState``) whose leaves are tensors, numpy arrays or scalars.  numpy's ``savez`` has no bfloat16 or float8, so such
a leaf is stored as its raw 16- or 8-bit pattern with a ``<key>::dt``
entry naming the dtype, as the reference stores them; the port reads and
writes those patterns through torch (no ``ml_dtypes``).  A checkpoint
written by either package therefore loads in the other.

A synchronous save streams: each leaf is copied to the host and written
before the next is read, so the host holds one leaf at a time, not the
whole state.  :func:`open_arrays` maps named leaves of a saved group
without reading them, so a caller that needs a few rows of a large stack
(the elastic coordinator's re-materialization) reads only those.

Under a :class:`~repro_torch.models.common.Mesh` (``mesh=``) a checkpoint
holds the *global* layout, as the reference's does (its arrays are
global): every rank calls :func:`save` with its shard, rank 0 alone
writes, and each expert stack is gathered to it one block at a time over
the ``model`` group, so the arrays equal those a one-device engine with
the same tables writes.  :func:`restore` onto a mesh reads each rank's
slots of a saved stack through memory maps, for any EP size that divides
the saved slots.  In the FSDP layout of training (``fsdp=True``) the data
rows hold different D slices of each slot: a save gathers each block over
``data`` first (every rank takes part), for the parameters and the AdamW
moments alike, and a restore cuts the D slice again, for any
``(data, model)`` shape or onto one device.  In the tensor-parallel
layout of the default rules (``models.layout``) every leaf may be cut:
``save(spec=)`` gathers each whole and ``restore(spec=)`` cuts each by
the rules, so a checkpoint saved on one mesh restores on any other, or on
one device.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zipfile
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import (FSDP_DIM, cut_of, decl_at,
                                       layout_spec)

Tree = Any
_SEP = "|"
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")    # [.., S, a, b] stacks
_DT_SUFFIX = "::dt"
# dtypes numpy's savez cannot represent natively -> stored as raw uint views
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_EXT_NAMES = {v[0]: k for k, v in _EXT_DTYPES.items()}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree: Tree, path=()):
    """``(path, leaf)`` in the reference's order (dict keys sorted); a
    NamedTuple's fields are keyed ``.<name>``, as ``jax.tree_util`` names
    them (an ``OptState``'s ``.step``, ``.mu``, ``.nu``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, path + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _flat_items(tree: Tree) -> Iterable[Tuple[str, np.ndarray]]:
    """``(key, host array)`` of every leaf, each copied to the host only
    when reached."""
    for path, leaf in _leaves(tree):
        key = _SEP.join(path)
        if torch.is_tensor(leaf):
            arr, name = _host_array(leaf.detach().to("cpu", copy=True))
            yield key, arr                           # a snapshot
            if name is not None:
                yield key + _DT_SUFFIX, np.array(name)
        else:
            yield key, np.asarray(leaf)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return dict(_flat_items(tree))


def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A CPU tensor as numpy, a bfloat16/float8 one as its raw pattern
    with the dtype's name."""
    name = _EXT_NAMES.get(t.dtype)
    if name is None:
        return t.numpy(), None
    _, bits, raw = _EXT_DTYPES[name]
    return t.contiguous().view(bits).numpy().view(raw), name


class _Streamed:
    """A leaf written block by block: ``shape`` and ``dtype`` of the whole
    array, ``blocks`` yields its C-order pieces."""

    def __init__(self, shape, dtype, blocks):
        self.shape, self.dtype, self.blocks = tuple(shape), dtype, blocks


def _savez(path: pathlib.Path, items: Iterable[Tuple[str, Any]]):
    """``np.savez(path, **dict(items))``, one array at a time: the same
    uncompressed archive of ``<key>.npy`` members.  A :class:`_Streamed`
    item is written one block at a time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if not isinstance(arr, _Streamed):
                    np.lib.format.write_array(fid, np.asanyarray(arr),
                                              allow_pickle=False)
                    continue
                header = {"descr": np.lib.format.dtype_to_descr(arr.dtype),
                          "fortran_order": False, "shape": arr.shape}
                try:
                    np.lib.format.write_array_header_1_0(fid, header)
                except ValueError:
                    np.lib.format.write_array_header_2_0(fid, header)
                for block in arr.blocks:
                    fid.write(np.ascontiguousarray(block).tobytes())


def _decode_flat(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """numpy arrays; a bfloat16/float8 leaf becomes a CPU tensor."""
    out = {}
    for key, arr in flat.items():
        if key.endswith(_DT_SUFFIX):
            continue
        meta = flat.get(key + _DT_SUFFIX)
        if meta is not None:
            ext, bits, _ = _EXT_DTYPES[str(meta)]
            arr = torch.from_numpy(np.array(arr, copy=True)).view(bits) \
                .view(ext)
        out[key] = arr
    return out


def _unflatten_into(template: Tree, flat: Dict[str, Any], path=()) -> Tree:
    """The template's structure with each leaf read from ``flat``, as a
    tensor on the template leaf's device (the CPU for a non-tensor)."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, path + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten_into(v, flat, path + ("." + name,))
            for name, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, path + (str(i),))
                              for i, v in enumerate(template))
    key = _SEP.join(path)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    t = arr if torch.is_tensor(arr) else torch.from_numpy(
        np.array(arr, copy=True))
    device = template.device if torch.is_tensor(template) else "cpu"
    return t.to(device)


def _write(root: pathlib.Path, step: int, flats: Dict[str, Any],
           keep: int) -> pathlib.Path:
    """``flats``: per group, a dict of host arrays or an iterable of
    ``(key, array)`` pairs."""
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    for group, flat in flats.items():
        _savez(tmp / f"{group}.npz",
               flat.items() if isinstance(flat, dict) else flat)
    (tmp / "meta.json").write_text(
        json.dumps({"step": step, "groups": sorted(flats)}))
    final = root / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(root, keep)
    return final


def save(ckpt_dir: str, step: int, state: Dict[str, Tree],
         keep: int = 3, mesh=None, fsdp: bool = False,
         spec: Optional[Tree] = None) -> str:
    """Synchronous atomic save. state: {"params": tree, "opt": tree, ...}.
    Each leaf goes to the host when it is written.  Under ``mesh`` every
    rank of it calls this with its own shard (see the module docstring;
    ``fsdp``: the expert stacks in the FSDP layout); every rank returns
    once the checkpoint is complete, and if the write fails every rank
    raises.  In the tensor-parallel layout (``spec``: the model's
    declarations, ``transformer.model_spec``, required there:
    ``models.common.layout_spec``; the AdamW moments follow their
    parameters) every leaf the rules cut is gathered whole first
    (:func:`models.layout.whole_leaf`, every rank taking part) and rank 0
    writes the global arrays."""
    if mesh is None or mesh.size(None) == 1:
        flats = {g: _flat_items(t) for g, t in state.items()}
        return str(_write(pathlib.Path(ckpt_dir), step, flats, keep))
    spec = layout_spec(spec, mesh)
    if spec is not None:
        return _save_layout(pathlib.Path(ckpt_dir), step, state, keep, mesh,
                            spec)
    return _save_global(pathlib.Path(ckpt_dir), step, state, keep, mesh,
                        fsdp and mesh.size("data") > 1)


def _leaf_cut(spec: Tree, path, mesh):
    """The cut axes of a state leaf at ``path``: its declaration's, or
    the parameter's its AdamW moment follows (``.mu``, ``.nu``); None for
    any other leaf (it is whole on every rank)."""
    p = decl_at(spec, [k for k in path if k not in (".mu", ".nu")])
    return None if p is None else cut_of(p, mesh)


def _save_layout(root: pathlib.Path, step: int, state: Dict[str, Tree],
                 keep: int, mesh, spec: Tree) -> str:
    import torch.distributed as dist
    from repro_torch.core.ep_moe import _dist_comm
    from repro_torch.models.layout import whole_leaf
    writer = dist.get_rank() == int(mesh.ranks[0, 0])

    def items(tree):
        for path, leaf in _leaves(tree):
            cut = _leaf_cut(spec, path, mesh) if torch.is_tensor(leaf) \
                else None
            if cut is not None:
                leaf = whole_leaf(leaf, cut, mesh)
            if writer:
                yield from _flat_items({_SEP.join(path): leaf})

    err = None
    flats = {g: items(t) for g, t in state.items()}
    if writer:
        try:
            _write(root, step, flats, keep)
        except Exception as e:       # noqa: BLE001 - agreed on below
            err = e
    for items_left in flats.values():   # every gather left takes place
        for _ in items_left:
            pass
    if _dist_comm(mesh).agree_max([0.0 if err is None else 1.0])[0]:
        raise err if err is not None else RuntimeError(
            f"rank 0 failed to write the checkpoint under {root}")
    return str(root / f"step_{step:08d}")


def _is_expert(path) -> bool:
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in _EXPERT_KEYS


def _mesh_items(tree: Tree, comm, writer: bool, row0: bool, fsdp: bool):
    """The writer's ``(key, array)`` items of one group: an expert stack of
    ``[.., S/ep, a, b]`` slots a rank as the global ``[.., S, a, b]``,
    gathered block by block (under ``fsdp`` each block first gathered over
    ``data`` along its D dim); every other leaf from the writer's copy.
    On the other ranks it only takes part in the gathers (the first data
    row's in those over ``model``) and yields nothing."""
    for path, leaf in _leaves(tree):
        key = _SEP.join(path)
        if not (torch.is_tensor(leaf) and leaf.dim() >= 3
                and _is_expert(path)):
            if writer:
                yield from _flat_items({key: leaf})
            continue
        blocks = [leaf] if leaf.dim() == 3 else \
            [leaf[b] for b in range(leaf.shape[0])]
        dim = FSDP_DIM[path[-1]]

        def gathered(blocks=blocks, dim=dim):
            for blk in blocks:
                if fsdp:
                    blk = torch.cat(list(comm._gather(
                        blk.detach().contiguous(), "data",
                        "checkpoint_gather")), dim=dim)
                if not row0:
                    continue
                whole = comm.gather_first(blk)
                if whole is not None:
                    yield _host_array(whole.reshape((-1,) + blk.shape[1:]))[0]

        shape = list(leaf.shape)
        shape[-3] *= comm.ep
        if fsdp:
            shape[dim] *= comm.mesh.size("data")
        if not writer:
            for _ in gathered():
                pass
            continue
        name = _EXT_NAMES.get(leaf.dtype)
        dtype = np.dtype(_EXT_DTYPES[name][2]) if name else \
            torch.empty((), dtype=leaf.dtype).numpy().dtype
        blocks_out = gathered()
        yield key, _Streamed(shape, dtype, blocks_out)
        for _ in blocks_out:     # a writer that stopped part-way still
            pass                 # takes part in this leaf's gathers
        if name is not None:
            yield key + _DT_SUFFIX, np.array(name)


def _save_global(root: pathlib.Path, step: int, state: Dict[str, Tree],
                 keep: int, mesh, fsdp: bool) -> str:
    import torch.distributed as dist
    from repro_torch.core.ep_moe import _dist_comm
    comm = _dist_comm(mesh)
    writer = dist.get_rank() == int(mesh.ranks[0, 0])
    row0 = mesh.index("data") == 0
    err = None
    if row0 or fsdp:
        flats = {g: _mesh_items(t, comm, writer, row0, fsdp)
                 for g, t in state.items()}
        if writer:
            try:
                _write(root, step, flats, keep)
            except Exception as e:       # noqa: BLE001 - agreed on below
                err = e
        # the other ranks (and a writer that failed part-way) take part in
        # every gather left, so no rank waits on one that stopped
        for items in flats.values():
            for _ in items:
                pass
    if comm.agree_max([0.0 if err is None else 1.0])[0]:
        raise err if err is not None else RuntimeError(
            f"rank 0 failed to write the checkpoint under {root}")
    return str(root / f"step_{step:08d}")


def _gc(root: pathlib.Path, keep: int):
    steps = sorted(p for p in root.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = sorted(p for p in root.iterdir()
                   if p.name.startswith("step_") and (p / "meta.json").exists())
    if not steps:
        return None
    return int(json.loads((steps[-1] / "meta.json").read_text())["step"])


def has_group(ckpt_dir: str, group: str,
              step: Optional[int] = None) -> bool:
    """Whether a saved step carries the named state group (the engine's
    probe for a checkpoint written with a placement or replica manager)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return False
    return (pathlib.Path(ckpt_dir) / f"step_{step:08d}"
            / f"{group}.npz").exists()


def restore_group(ckpt_dir: str, group: str,
                  step: Optional[int] = None) -> Dict[str, Any]:
    """Template-free restore of one flat group (``path -> array``)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / f"{group}.npz"
    if not path.exists():
        raise FileNotFoundError(f"checkpoint group missing: {path}")
    with np.load(path) as z:
        return _decode_flat({k: z[k] for k in z.files})


def open_arrays(ckpt_dir: str, group: str, keys: Sequence[str],
                step: Optional[int] = None) -> Dict[str, Any]:
    """Read-only memory maps of the leaves ``keys`` of one saved group:
    nothing is read from disk until the map is indexed.  A bfloat16 or
    float8 leaf maps as its raw unsigned pattern; ``decode_rows`` turns
    indexed rows back into a tensor.  Returns ``{key: (map, dtype name or
    None)}``; a missing key is absent from the result."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / f"{group}.npz"
    if not path.exists():
        raise FileNotFoundError(f"checkpoint group missing: {path}")
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        names = set(zf.namelist())
        for key in keys:
            if key + ".npy" not in names:
                continue
            info = zf.getinfo(key + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {key} is compressed")
            with zf.open(info) as f:
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read(f)
                in_member = f.tell()
            # the member's data follow its local header (30 bytes, the
            # name and the extra field)
            raw.seek(info.header_offset + 26)
            n_name, n_extra = np.frombuffer(raw.read(4), "<u2")
            start = info.header_offset + 30 + int(n_name) + int(n_extra)
            mm = np.memmap(path, dtype=dtype, mode="r",
                           offset=start + in_member, shape=shape,
                           order="F" if fortran else "C")
            ext = None
            if key + _DT_SUFFIX + ".npy" in names:
                with zf.open(key + _DT_SUFFIX + ".npy") as f:
                    ext = str(np.lib.format.read_array(f))
            out[key] = (mm, ext)
    return out


def decode_rows(rows: np.ndarray, ext: Optional[str]) -> torch.Tensor:
    """Rows indexed from an :func:`open_arrays` map, as a CPU tensor of the
    saved dtype."""
    t = torch.from_numpy(np.array(rows, copy=True))
    if ext is None:
        return t
    ext_dtype, bits, _ = _EXT_DTYPES[ext]
    return t.view(bits).view(ext_dtype)


def restore(ckpt_dir: str, templates: Dict[str, Tree],
            step: Optional[int] = None, mesh=None, fsdp: bool = False,
            spec: Optional[Tree] = None) -> Tuple[int, Dict[str, Tree]]:
    """Restore onto ``templates``' structure: each leaf a tensor with the
    saved dtype, on the device of the template's leaf.  Under ``mesh``
    (the counterpart of the reference's ``shardings=``) each expert stack
    ``[.., S, a, b]`` comes back as this rank's ``S/ep`` slots (with
    ``fsdp``, their ``D/data`` slice), read through a memory map (``ep``
    the mesh's ``model`` size, which need not be the writer's); every
    other leaf whole.  In the tensor-parallel layout (``spec``, as
    :func:`save` takes it) every leaf comes back as the slice the rules
    cut for this rank, on any mesh."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    spec = None if mesh is None else layout_spec(spec, mesh)
    if spec is not None:
        return step, {g: _restore_layout(ckpt_dir, g, t, step, mesh, spec)
                      for g, t in templates.items()}
    ep = 1 if mesh is None else mesh.size("model")
    rows = mesh.size("data") if mesh is not None and fsdp else 1
    out = {}
    for group, tmpl in templates.items():
        with np.load(d / f"{group}.npz") as z:
            cut = [k for k in z.files if (ep > 1 or rows > 1)
                   and _is_expert(k.split(_SEP))]
            flat = {k: z[k] for k in z.files if k not in cut}
        for key, (mm, _) in open_arrays(ckpt_dir, group, cut, step).items():
            idx = [slice(None)] * mm.ndim
            n = mm.shape[-3]
            if n % ep:
                raise ValueError(f"{key}: {n} saved slots over {ep} ranks")
            i = mesh.index("model")
            idx[-3] = slice(i * n // ep, (i + 1) * n // ep)
            if rows > 1:
                dim = mm.ndim + FSDP_DIM[key.split(_SEP)[-1]]
                n_d, j = mm.shape[dim], mesh.index("data")
                if n_d % rows:
                    raise ValueError(f"{key}: D {n_d} over {rows} data rows")
                idx[dim] = slice(j * n_d // rows, (j + 1) * n_d // rows)
            flat[key] = mm[tuple(idx)]
        out[group] = _unflatten_into(tmpl, _decode_flat(flat))
    return step, out


def _restore_layout(ckpt_dir: str, group: str, tmpl: Tree, step: int, mesh,
                    spec: Tree) -> Tree:
    """One group's leaves, each this rank's slice by the rules, read
    through memory maps."""
    paths = {_SEP.join(path): path for path, _ in _leaves(tmpl)}
    flat = {}
    maps = open_arrays(ckpt_dir, group, list(paths), step)
    for key, (mm, ext) in maps.items():
        cut = _leaf_cut(spec, paths[key], mesh)
        idx = [slice(None)] * mm.ndim
        for i, axes in enumerate(cut or ()):
            dim = mm.ndim - len(cut) + i
            if axes:
                n = mm.shape[dim] // mesh.size(axes)
                j = mesh.index(axes)
                idx[dim] = slice(j * n, (j + 1) * n)
        flat[key] = decode_rows(mm[tuple(idx)], ext) if ext \
            else np.array(mm[tuple(idx)], copy=True)
    return _unflatten_into(tmpl, flat)


class AsyncCheckpointer:
    """Snapshot-now, write-later. One in-flight save at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir, self.keep = ckpt_dir, keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, state: Dict[str, Tree]):
        self.wait()
        snapshot = {g: _flatten(t) for g, t in state.items()}  # host copy

        def _write_snapshot():
            try:
                _write(pathlib.Path(self.ckpt_dir), step, snapshot,
                       self.keep)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write_snapshot, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
