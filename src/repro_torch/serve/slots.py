"""Host-side slot management for the continuous-batching engine (copied
from ``repro/serve/slots.py``; numpy only, so it stays on the host).

The DEVICE side of a slot lives in the model's decode cache and is already
per-slot: ``cache["pos"]`` is ``(B,)`` (each batch row decodes at its own
position: its rope tables and causal horizon follow it independently),
``cache["slot_pos"]`` is ``(B, C)`` (each row's per-cache-slot valid
positions, ``-1`` = empty, masked by ``decode_attention``), and
``LM.prefill_into_slot`` resets exactly one row of each, in place. This
module is the HOST side: which slots are free, which request occupies
which slot, how many tokens each has emitted, and when a slot retires
(its request hit ``max_new_tokens`` or emitted its ``eos_id``).

The engine's contract with this table:

  * ``admit`` binds a request to a free slot (the engine then runs the
    slot prefill and pushes the first sampled token through ``push``);
  * after every decode micro-chunk the engine calls ``push`` per active
    slot with that slot's row of the token block; ``push`` stops at the
    request's own ``max_new_tokens``/``eos_id``: tokens decoded past a
    stop inside the chunk are DISCARDED here, never emitted;
  * ``retire`` frees the slot for the next admission. Nothing on the
    device is cleared: the next ``prefill_into_slot`` resets the row's
    ``slot_pos`` to the new prompt, which masks the stale KV out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


def trim_at_eos(tokens: List[int], eos_id: Optional[int]) -> List[int]:
    """Emitted-token contract for BOTH engines: generation stops after the
    eos token, which is itself emitted (the caller sees why it stopped)."""
    if eos_id is None:
        return tokens
    for i, t in enumerate(tokens):
        if t == eos_id:
            return tokens[: i + 1]
    return tokens


@dataclasses.dataclass
class SlotState:
    """One live request bound to one batch slot."""

    slot: int
    order: int                        # index in the submitted request list
    request: Any                      # serve.engine.Request
    emitted: List[int] = dataclasses.field(default_factory=list)
    admitted_at: float = 0.0
    # terminal disposition, stamped at retire time by the engine:
    # "ok" | "timeout" | "cancelled" | "failed" (see serve.engine.Result)
    status: str = "ok"

    @property
    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.emitted)

    @property
    def done(self) -> bool:
        if self.remaining <= 0:
            return True
        eos = self.request.eos_id
        return eos is not None and len(self.emitted) > 0 \
            and self.emitted[-1] == eos

    def push(self, tokens) -> bool:
        """Absorb this slot's row of a decoded chunk; returns ``done``.

        Appends up to ``remaining`` tokens, stopping early at ``eos_id``:
        tokens decoded past the stop are chunk overflow and are dropped,
        so the emitted list is exactly what solo serving of this request
        would emit.
        """
        eos = self.request.eos_id
        for t in tokens:
            if self.remaining <= 0:
                break
            self.emitted.append(int(t))
            if eos is not None and int(t) == eos:
                break
        return self.done


class SlotTable:
    """Free-list + active map over the engine's ``batch_size`` slots."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._free: List[int] = list(range(batch_size - 1, -1, -1))
        self.active: Dict[int, SlotState] = {}
        self.quarantined: List[int] = []

    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def admit(self, order: int, request: Any, now: float = 0.0) -> SlotState:
        if not self._free:
            raise RuntimeError("no free slot: caller must check num_free")
        slot = self._free.pop()
        state = SlotState(slot=slot, order=order, request=request,
                          admitted_at=now)
        self.active[slot] = state
        return state

    def retire(self, slot: int) -> SlotState:
        state = self.active.pop(slot)
        self._free.append(slot)
        return state

    def quarantine(self, slot: int) -> SlotState:
        """Retire a poisoned slot WITHOUT returning it to the free list.

        A slot whose KV rows carry NaN/Inf must never be re-admitted into:
        masked attention zeroes the WEIGHT of stale positions, but
        ``0 * NaN`` in the value sum is still NaN, so the poison would
        leak into whatever request lands there next. Quarantining costs
        one batch lane of capacity for the rest of the engine run: the
        correct trade against silently corrupting a future request.
        """
        state = self.active.pop(slot)
        self.quarantined.append(slot)
        return state

    # ---- per-chunk device-facing views (B,) --------------------------------

    def active_mask(self) -> np.ndarray:
        """(B,) int32: 1 for occupied slots; the engine's decode sampler
        pins free slots' tokens to 0 with it."""
        mask = np.zeros((self.batch_size,), np.int32)
        for slot in self.active:
            mask[slot] = 1
        return mask

    def temperatures(self) -> np.ndarray:
        """(B,) float32 per-slot temperature (0 = greedy; free slots 0)."""
        temps = np.zeros((self.batch_size,), np.float32)
        for slot, st in self.active.items():
            t = st.request.temperature
            temps[slot] = 0.0 if t is None else float(t)
        return temps

    def max_remaining(self) -> int:
        return max((st.remaining for st in self.active.values()), default=0)
