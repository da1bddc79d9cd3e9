"""Serving: the chunked (``ServeEngine``), continuous
(``ContinuousEngine``) and speculative (``SpeculativeEngine``, see
``serve/speculative.py``) engines over the same decode step and CUDA
graphs.

Per-slot geometry contract (the continuous engine's correctness rests on
it; the pieces live in the model, not the engine):

  * ``cache["pos"]`` is ``(B,)``: each batch slot decodes at ITS OWN
    position. Rope tables, the causal horizon and the cache write pointer
    all follow ``pos[slot]`` independently per row (``LM.decode_step``
    builds per-row rope from ``pos[:, None]``).
  * ``cache["slot_pos"]`` is ``(B, C)``: each row's per-cache-slot valid
    positions; ``-1`` marks an empty slot and ``decode_attention`` masks
    it, so a slot's visible context is exactly its own written history.
  * ``LM.prefill_into_slot(params, cache, prompt (1, S), slot)`` admits a
    prompt into ONE row of a live cache: a solo forward (positions
    0 .. S - 1, no batch-mates, no padding), the row's k/v written, the
    row's ``slot_pos`` RESET (fresh positions where written, -1
    elsewhere: the retired occupant's stale KV is masked out, never
    cleared), the row's ``pos`` set to S. All other rows stay untouched,
    and every write lands IN PLACE in the same tensors, since the decode
    graph captured them. One prefill graph per prompt length; the slot
    index is a device tensor the graph reads.
  * The decode graph keys each row by its own token index (a (B,) device
    buffer the host sets at every chunk edge), so a slot's random stream
    follows its request, not the engine's step count.

Consequence: batch rows are independent through every batched op, so
continuous-batching tokens equal serving each request alone, for any
admission order, chunk-mates or retirement pattern, at the same batch
size (on the card a GEMM's route and K split follow its row count M, so
bit-identity holds between runs at one batch size). The chunked engine's
mixed-length prefill padding (zero tokens the model attends to) is the
one distortion this geometry removes.

Host-side slot bookkeeping is ``serve/slots.py`` (free list, per-request
emission, retire conditions); admission policy and micro-chunk sizing
``serve/scheduler.py``; samplers ``serve/sampler.py``.

Reliability contract: every submitted request to the continuous engine
ends in exactly one ``Result.status``: ``ok``; ``shed`` (bounded queue
full, or oversized with ``strict=False``; no tokens); ``timeout`` or
``cancelled`` (deadline passed or ``cancel()`` fired: reaped between
chunks, with the tokens emitted so far, none if still queued); ``failed``
(non-finite logits in its slot: the tokens up to the last healthy step,
and the slot QUARANTINED for the rest of the run, its KV holding NaN).
State is checked only between micro-chunks, so a dispatched chunk always
completes. Quarantine isolates exactly the poisoned slot: the flags that
detect it observe the logits without touching token math. With a
``Telemetry`` the engine records one terminal ``retire`` event per
request carrying the same status, on the engine clock, so TTFT, TPOT,
queue wait and occupancy are recomputable from the trace alone
(``runtime/trace_analysis.py``).
"""

from repro_torch.serve.engine import (
    CancelToken,
    ContinuousEngine,
    Request,
    Result,
    ServeEngine,
)
from repro_torch.serve.sampler import greedy_sample, temperature_sample
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.slots import SlotState, SlotTable, trim_at_eos
from repro_torch.serve.speculative import SpeculativeEngine, shallow_drafter

__all__ = ["CancelToken", "ContinuousEngine", "Request", "Result",
           "Scheduler", "ServeEngine", "SlotState", "SlotTable",
           "SpeculativeEngine", "greedy_sample", "shallow_drafter",
           "temperature_sample", "trim_at_eos"]
