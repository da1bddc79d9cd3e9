"""Continuous-batching scheduler: admission queue + retire/admit policy
(copied from ``repro/serve/scheduler.py``; host-side, numpy only).

Sits between the host request stream and the device decode. The engine
decodes in micro-chunks of K steps (K replays of the slot decode graph on
the card, then one device-to-host transfer of tokens and flags); BETWEEN
chunks the scheduler:

  * retires slots whose request hit its own ``max_new_tokens`` or emitted
    its ``eos_id`` (``absorb_chunk``);
  * admits queued requests into the freed slots (``ready_admissions``:
    FIFO among requests whose arrival time has passed);
  * trims the NEXT chunk's length to the longest remaining budget among
    live slots (``chunk_len``), so the tail of a workload never decodes
    dead air.

All of this is host-side bookkeeping over ``slots.SlotTable``; the device
never sees the queue. Occupancy accounting (busy slot-steps over total
slot-steps) rides along because it falls out of the same loop.

Reliability: the queue is optionally BOUNDED (``max_queue``: the engine
sheds, typed, instead of queueing without limit), queued and active
requests are reaped between chunks when their deadline passes or their
cancel token fires (``reap_queue``/``reap_active``), and
``absorb_chunk`` takes per-step health flags so a slot whose logits went
non-finite is quarantined at the exact poisoned step: its batch-mates'
tokens are untouched (rows are independent through every batched op).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.serve.slots import SlotState, SlotTable


@dataclasses.dataclass
class _Queued:
    order: int
    request: Any
    arrival: float


def _expired(request: Any, now: float) -> bool:
    deadline = getattr(request, "deadline", None)
    return deadline is not None and now > deadline


def _cancelled(request: Any) -> bool:
    return bool(getattr(request, "cancelled", False))


class Scheduler:
    """FIFO admission over a ``SlotTable`` plus per-chunk retire logic."""

    def __init__(self, batch_size: int, chunk_steps: int,
                 max_queue: Optional[int] = None):
        if chunk_steps < 1:
            raise ValueError("chunk_steps must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.table = SlotTable(batch_size)
        self.chunk_steps = chunk_steps
        self.max_queue = max_queue
        self._queue: Deque[_Queued] = deque()
        # occupancy accounting (slot-steps)
        self.busy_slot_steps = 0
        self.total_slot_steps = 0
        self.chunks = 0

    # ---- queue -------------------------------------------------------------

    def submit(self, order: int, request: Any, arrival: float = 0.0) -> bool:
        """Enqueue; returns False (typed load-shed) when the bounded queue
        is full: the caller records a ``shed`` result instead of letting
        the backlog grow without limit."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            return False
        self._queue.append(_Queued(order, request, arrival))
        return True

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def done(self) -> bool:
        return not self._queue and not self.table.active

    def next_arrival(self) -> Optional[float]:
        return self._queue[0].arrival if self._queue else None

    # ---- admission ---------------------------------------------------------

    def ready_admissions(self, now: float) -> Iterator[SlotState]:
        """Pop arrived requests into free slots, FIFO, until either runs
        out. The caller runs the slot prefill for each yielded state."""
        while self.table.num_free and self._queue \
                and self._queue[0].arrival <= now:
            q = self._queue.popleft()
            yield self.table.admit(q.order, q.request, now)

    # ---- reaping (deadlines + cancellation) --------------------------------

    def reap_queue(self, now: float) -> List[Tuple[int, Any, str]]:
        """Drop queued requests that are already dead: cancelled, or past
        their deadline before ever reaching a slot. Returns
        ``(order, request, status)`` triples for the engine to convert
        into typed Results. Run BEFORE admissions so a dead request never
        wastes a prefill."""
        reaped, keep = [], deque()
        for q in self._queue:
            if _cancelled(q.request):
                reaped.append((q.order, q.request, "cancelled"))
            elif _expired(q.request, now):
                reaped.append((q.order, q.request, "timeout"))
            else:
                keep.append(q)
        self._queue = keep
        return reaped

    def reap_active(self, now: float) -> List[SlotState]:
        """Retire live slots whose request was cancelled or whose deadline
        passed mid-generation. Partial output stays on the state (the
        caller decides whether to surface it); the slot itself is healthy
        and goes back on the free list."""
        reaped = []
        for slot in list(self.table.active):
            st = self.table.active[slot]
            if _cancelled(st.request):
                st.status = "cancelled"
            elif _expired(st.request, now):
                st.status = "timeout"
            else:
                continue
            reaped.append(self.table.retire(slot))
        return reaped

    def fail_pending(self, status: str = "failed") -> List[Tuple[int, Any, str]]:
        """Drain the whole queue with a terminal status : the engine's
        last resort when no slot can ever admit again (e.g. every lane
        quarantined). Prevents the serve loop from spinning forever on
        requests that cannot be placed."""
        reaped = [(q.order, q.request, status) for q in self._queue]
        self._queue.clear()
        return reaped

    # ---- micro-chunk -------------------------------------------------------

    def chunk_len(self) -> int:
        """Steps of the next micro-chunk: the fixed ``chunk_steps``
        trimmed to the longest remaining token budget among live slots,
        rounded UP to a power of two, so the tail never decodes more than
        2x dead air (the reference compiles one program per length; the
        port replays its one-step graph K times, and keeps the rule so
        both engines decode the same chunks).
        """
        need = max(1, min(self.chunk_steps, self.table.max_remaining()))
        k = 1
        while k < need:
            k *= 2
        return min(k, self.chunk_steps)

    def absorb_chunk(self, toks: np.ndarray, steps: int,
                     ok: Optional[np.ndarray] = None) -> List[SlotState]:
        """Feed a decoded ``(B, steps)`` token block to the live slots;
        retire and return the states that finished (any order).

        ``ok``: optional ``(B, steps)`` bool health flags from
        ``decode_many(with_flags=True)`` or the slot decode graph: a slot
        whose row goes False is QUARANTINED (status ``failed``) keeping
        only the tokens sampled from finite logits; the poisoned lane
        never returns to the free list (its KV now carries NaN), and
        every other slot absorbs its row exactly as if the flags were
        absent, bit-identical to solo serving.
        """
        finished = []
        for slot in list(self.table.active):
            st = self.table.active[slot]
            before = len(st.emitted)
            row_ok = None if ok is None else ok[slot, :steps]
            if row_ok is not None and not bool(np.all(row_ok)):
                bad = int(np.argmax(~np.asarray(row_ok, bool)))
                st.push(toks[slot, :bad])
                self.busy_slot_steps += len(st.emitted) - before
                st.status = "failed"
                finished.append(self.table.quarantine(slot))
                continue
            done = st.push(toks[slot, :steps])
            self.busy_slot_steps += len(st.emitted) - before
            if done:
                finished.append(self.table.retire(slot))
        self.total_slot_steps += self.table.batch_size * steps
        self.chunks += 1
        return finished

    def occupancy(self) -> float:
        """Mean fraction of decode slot-steps spent on live requests."""
        if not self.total_slot_steps:
            return 0.0
        return self.busy_slot_steps / self.total_slot_steps
