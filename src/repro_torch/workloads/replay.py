"""Record/replay of request streams to JSONL.

A recorded stream pins the *exact* serving input — every token id,
modality bit, arrival timestamp and generation length — so policy A/B
runs (ReaLB vs. ReaLB-seq vs. off) see identical traffic, the same way
the iteration-level trace generator feeds identical randomness to every
strategy simulator.

Format: line 1 is a header object ``{"format": "repro.workloads", ...}``
with version + free-form metadata; each following line is one
:class:`~repro_torch.workloads.multimodal.RequestSpec`.  Round-trips exactly
(integers and bools verbatim; arrival times via repr-float).

The port writes and reads the reference's format (its ``format`` tag
included), so a stream recorded by either package replays in the other.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.workloads.multimodal import RequestSpec

FORMAT = "repro.workloads"
VERSION = 1


def _spec_to_obj(s: RequestSpec) -> Dict:
    return {
        "uid": int(s.uid),
        "arrival": float(s.arrival),
        "tokens": [int(t) for t in s.tokens],
        "modality": [int(b) for b in s.modality],
        "max_new_tokens": int(s.max_new_tokens),
        "decode_modality": bool(s.decode_modality),
        "embed_seed": (None if s.embed_seed is None else int(s.embed_seed)),
    }


def _obj_to_spec(o: Dict) -> RequestSpec:
    return RequestSpec(
        uid=int(o["uid"]),
        arrival=float(o["arrival"]),
        tokens=np.asarray(o["tokens"], np.int32),
        modality=np.asarray(o["modality"], bool),
        max_new_tokens=int(o["max_new_tokens"]),
        decode_modality=bool(o.get("decode_modality", False)),
        embed_seed=o.get("embed_seed"))


def save_stream(path, specs: List[RequestSpec],
                meta: Optional[Dict] = None) -> None:
    path = Path(path)
    header = {"format": FORMAT, "version": VERSION, "n": len(specs),
              "meta": meta or {}}
    with path.open("w") as f:
        f.write(json.dumps(header) + "\n")
        for s in specs:
            f.write(json.dumps(_spec_to_obj(s)) + "\n")


def load_stream(path) -> Tuple[Dict, List[RequestSpec]]:
    """Returns (header meta dict, specs)."""
    path = Path(path)
    with path.open() as f:
        header = json.loads(f.readline())
        if header.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} stream")
        if header.get("version", 0) > VERSION:
            raise ValueError(f"{path}: stream version {header['version']} "
                             f"newer than supported {VERSION}")
        specs = [_obj_to_spec(json.loads(line)) for line in f if line.strip()]
    if header.get("n") is not None and header["n"] != len(specs):
        raise ValueError(f"{path}: truncated stream "
                         f"({len(specs)}/{header['n']} records)")
    return header.get("meta", {}), specs
