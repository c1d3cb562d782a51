"""Slot bookkeeping for the continuous-batching engine.

A copy of :mod:`maggy_tpu.serve.slots`.

A *slot* is one row of the engine's fixed-``B`` decode cache. The
:class:`SlotManager` is pure host-side accounting — which rows are free,
which request owns which row, and the per-slot decode state the jitted step
consumes (last token, next position, sampling params). Device-side cache
rows are written by :class:`maggy_tpu_torch.serve.engine.Engine`; the invariants
here (admit only into a free slot, evict only an occupied one, one slot per
request) are what the churn tests hammer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from maggy_tpu_torch.exceptions import BadArgumentsError
from maggy_tpu_torch.serve.request import Request


@dataclasses.dataclass
class SlotState:
    """Host mirror of one cache row while a request occupies it."""

    request: Request
    # next cache/sequence position the slot will write (== tokens so far)
    next_pos: int
    # the token fed to the next decode step (last sampled token)
    last_token: int
    # tokens generated so far (== index of the NEXT token to be produced)
    generated: int


class SlotOccupiedError(BadArgumentsError):
    pass


class SlotManager:
    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise BadArgumentsError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self._slots: List[Optional[SlotState]] = [None] * num_slots
        self._by_request: Dict[str, int] = {}

    # ------------------------------------------------------------------ admit

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def admit(
        self,
        request: Request,
        first_token: int,
        next_pos: Optional[int] = None,
        generated: int = 1,
    ) -> int:
        """Claim a free slot for ``request`` whose prompt was just prefilled
        and whose first token was sampled from the prefill logits.

        ``next_pos``/``generated`` override the fresh-request defaults for
        PREEMPTED requests being re-admitted (docs/serving.md "Preemption"):
        their prefill covered prompt + already-generated tokens, so the
        write position and the PRNG fold-in index resume mid-stream."""
        free = self.free_slots()
        if not free:
            raise SlotOccupiedError("no free slot")
        if request.id in self._by_request:
            raise SlotOccupiedError(f"request {request.id} already in a slot")
        slot = free[0]
        self._slots[slot] = SlotState(
            request=request,
            next_pos=len(request.prompt) if next_pos is None else int(next_pos),
            last_token=int(first_token),
            generated=int(generated),
        )
        self._by_request[request.id] = slot
        return slot

    # ------------------------------------------------------------------ evict

    def evict(self, slot: int) -> Request:
        state = self._slots[slot]
        if state is None:
            raise SlotOccupiedError(f"slot {slot} is already free")
        self._slots[slot] = None
        del self._by_request[state.request.id]
        return state.request

    # ------------------------------------------------------------------ query

    def get(self, slot: int) -> Optional[SlotState]:
        return self._slots[slot]

    def slot_of(self, request_id: str) -> Optional[int]:
        return self._by_request.get(request_id)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    @property
    def active_count(self) -> int:
        return len(self._by_request)

    def advance(self, slot: int, token: int) -> SlotState:
        """Record one decoded token: it becomes the next step's input and the
        slot's write position moves forward one cache row."""
        state = self._slots[slot]
        if state is None:
            raise SlotOccupiedError(f"slot {slot} is free; cannot advance")
        state.last_token = int(token)
        state.next_pos += 1
        state.generated += 1
        return state

    def check_invariants(self) -> None:
        """Cross-checks for the churn tests: the request index and the slot
        array must mirror each other exactly."""
        for rid, slot in self._by_request.items():
            state = self._slots[slot]
            assert state is not None and state.request.id == rid, (rid, slot)
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        assert len(occupied) == len(self._by_request)
