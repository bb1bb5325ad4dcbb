"""Atomic, async checkpoints in the reference's on-disk format.

Counterpart of ``repro.checkpoint.ckpt``.  Format: one ``.npz`` per
top-level state group holding flattened ``path -> array`` entries (keys
joined by ``|``), plus a ``meta.json`` with the step and the groups.  A
save writes into a temp directory and renames it, so a crash mid-save
never corrupts the latest checkpoint; ``keep`` old steps are retained.

Trees are nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars.  numpy's ``savez`` has no bfloat16 or float8, so such
a leaf is stored as its raw 16- or 8-bit pattern with a ``<key>::dt``
entry naming the dtype, as the reference stores them; the port reads and
writes those patterns through torch (no ``ml_dtypes``).  A checkpoint
written by either package therefore loads in the other.

A synchronous save streams: each leaf is copied to the host and written
before the next is read, so the host holds one leaf at a time, not the
whole state.  :func:`open_arrays` maps named leaves of a saved group
without reading them, so a caller that needs a few rows of a large stack
(the elastic coordinator's re-materialization) reads only those.
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

Tree = Any
_SEP = "|"
_DT_SUFFIX = "::dt"
# dtypes numpy's savez cannot represent natively -> stored as raw uint views
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_EXT_NAMES = {v[0]: k for k, v in _EXT_DTYPES.items()}


def _leaves(tree: Tree, path=()):
    """``(path, leaf)`` in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
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
            t = leaf.detach().to("cpu", copy=True)   # a snapshot
            name = _EXT_NAMES.get(t.dtype)
            if name is not None:
                _, bits, raw = _EXT_DTYPES[name]
                yield key, t.contiguous().view(bits).numpy().view(raw)
                yield key + _DT_SUFFIX, np.array(name)
                continue
            yield key, t.numpy()
        else:
            yield key, np.asarray(leaf)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return dict(_flat_items(tree))


def _savez(path: pathlib.Path, items: Iterable[Tuple[str, np.ndarray]]):
    """``np.savez(path, **dict(items))``, one array at a time: the same
    uncompressed archive of ``<key>.npy`` members."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, np.asanyarray(arr),
                                          allow_pickle=False)


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
         keep: int = 3) -> str:
    """Synchronous atomic save. state: {"params": tree, "opt": tree, ...}.
    Each leaf goes to the host when it is written."""
    flats = {g: _flat_items(t) for g, t in state.items()}
    return str(_write(pathlib.Path(ckpt_dir), step, flats, keep))


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
            step: Optional[int] = None) -> Tuple[int, Dict[str, Tree]]:
    """Restore onto ``templates``' structure: each leaf a tensor with the
    saved dtype, on the device of the template's leaf."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    out = {}
    for group, tmpl in templates.items():
        with np.load(d / f"{group}.npz") as z:
            flat = _decode_flat({k: z[k] for k in z.files})
        out[group] = _unflatten_into(tmpl, flat)
    return step, out


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
