"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``src/repro_torch/csrc/*.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first use.  All sources build at the
same time (one ``nvcc`` process each).  Libraries land in
``build/repro_torch_kernels/`` at the repository root, named by a hash of
every source and header under ``csrc/`` and of the flags, so an edited
source rebuilds and an unchanged one loads at once.

No ``--use_fast_math``: it approximates ``/`` and flushes denormals, and the
quantizer must match its plain version bitwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None   # wall seconds of the last load()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def load(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns them by
    source stem (``"quantize_fp4"``, ``"grouped_fp4_ffn"``).  ``verbose``
    adds ``-Xptxas -v`` to a build that happens and prints its compiler
    output; a cached library loads as it is."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        digest = _source_hash()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
        procs = {}
        for src in sorted(CSRC.glob("*.cu")):
            out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            procs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {stem}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for src in sorted(CSRC.glob("*.cu")):
            _libs[src.stem] = ctypes.CDLL(
                str(BUILD_DIR / f"lib{src.stem}_{digest}.so"))
        build_seconds = time.perf_counter() - t0
        return _libs


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
