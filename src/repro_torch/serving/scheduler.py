"""Continuous-batching request scheduler (vLLM-style, PD-colocated); a copy
of ``repro.serving.scheduler``.

Fixed-slot design: the engine owns ``max_slots`` cache slots; the scheduler
admits queued requests into free slots (prefill) and steps every active
slot each iteration (decode) — one "iteration" = one forward batch, the
paper's unit of routing dynamics.  Requests carry modality masks so ReaLB
sees the true vision/text composition.

Admission is modality-aware: under a vision burst, vision-heavy requests
can occupy at most ``max_slots - text_reserve`` slots while text requests
are waiting, so text TTFT is bounded instead of queueing behind every
long vision prompt (admission stays work-conserving — a vision request is
still admitted when no text request is queued).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray               # [S] int32 prompt (incl. vision slots)
    modality: np.ndarray             # [S] bool, True = vision token
    max_new_tokens: int = 16
    vision_embeds: Optional[np.ndarray] = None   # [Nv, D] stub frontend out
    decode_modality: bool = False    # modality flag of generated tokens
    arrival_time: Optional[float] = None  # engine-clock submission time;
    # None = stamp with the engine clock at submit()

    # runtime state
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    prefill_pos: int = 0             # prompt tokens already prefilled
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def is_vision(self) -> bool:
        """Vision-heavy request: majority of prompt tokens are vision."""
        return bool(self.modality.mean() > 0.5)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.finish_time is None or self.first_token_time is None \
                or len(self.generated) < 2:
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.generated) - 1))


class Scheduler:
    def __init__(self, max_slots: int, text_reserve: int = 1):
        self.max_slots = max_slots
        # slots a vision burst may occupy while text requests wait
        self.text_reserve = min(text_reserve, max(max_slots - 1, 0))
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}     # slot -> request
        self.finished: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if s not in self.active]

    def _next_request(self) -> Optional[Request]:
        """FIFO pop with modality-aware override: when the vision slot cap
        is reached and a text request is waiting, the oldest text request
        jumps the queue."""
        if not self.queue:
            return None
        head = self.queue[0]
        if self.text_reserve and head.is_vision:
            n_vis = sum(r.is_vision for r in self.active.values())
            if n_vis >= self.max_slots - self.text_reserve:
                for i, r in enumerate(self.queue):
                    if not r.is_vision:
                        del self.queue[i]
                        return r
        return self.queue.popleft()

    def admit(self) -> List[Request]:
        """Move queued requests into free slots; returns newly admitted."""
        admitted = []
        for slot in self.free_slots():
            req = self._next_request()
            if req is None:
                break
            req.slot = slot
            self.active[slot] = req
            admitted.append(req)
        return admitted

    def retire(self) -> List[Request]:
        """Remove finished requests; returns them."""
        done = [r for r in self.active.values() if r.done]
        for r in done:
            del self.active[r.slot]
            self.finished.append(r)
        return done

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active
