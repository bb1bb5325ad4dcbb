"""Working launches of the serving path's kernels, counted on the device.

A launch works when its predicate is 1 (the quantizer, the global scale;
no predicate: always) or when a slot with weights has rows (the two
grouped FFNs); otherwise the kernel exits at once.  The host never reads
either, so the launches a CUDA graph's replay makes cannot be sorted on
the host.  While :func:`track` is on, each CUDA wrapper adds its launch's
working flag to an int64 counter on the device right after the launch:
an operation on the stream, which a capture records, so every replay
counts again.  Capture a graph while tracking to have its replays
counted.  :func:`counts` reads the counter (one host read, after a run).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

NAMES = ("quantize_fp4", "global_scale_fp4", "grouped_fp4_ffn",
         "grouped_ffn")

_counter: Optional[torch.Tensor] = None     # int64 [len(NAMES)] on a card


def track(device: Optional[torch.device]) -> None:
    """Count working launches on ``device`` from now on, from 0 (the
    counter is zeroed in place, so the graphs captured over it keep
    counting into it); ``None`` stops counting."""
    global _counter
    if device is None:
        _counter = None
        return
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _counter is not None and _counter.device == device:
        _counter.zero_()
    else:
        _counter = torch.zeros(len(NAMES), dtype=torch.int64, device=device)


def note(name: str, works: Callable[[], Union[torch.Tensor, int]]
         ) -> None:
    """A launch of kernel ``name``: while tracking, ``works()`` (its device
    flag, a 0-dim or one-element tensor, or 1) is added to the counter;
    otherwise nothing runs."""
    if _counter is not None:
        w = works()
        c = _counter[NAMES.index(name)]
        c.add_(w.reshape(()) if isinstance(w, torch.Tensor) else w)


def counts() -> Dict[str, int]:
    """Working launches by kernel since :func:`track` (a host read); empty
    when not tracking."""
    if _counter is None:
        return {}
    return dict(zip(NAMES, _counter.tolist()))
