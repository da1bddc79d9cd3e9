"""CUDA graphs of the serving hot path (the port's counterpart of the
reference's ``jax.jit`` programs: the decode ``lax.scan`` and the
weight-baked prefills of ``repro/serve/engine.py``).

``DecodeGraph`` captures ONE decode step of an engine over static
buffers: the KV cache, each row's current token and token index, the
engine's row keys, a (B, W) block of tokens and, for an engine that
reads them, one of finite-logits flags. A replay runs the step, samples
each row's next token with the engine's ``sample`` (keyed by
``fold_in(row key, row's token index)``), writes it (and the row's flag)
into the blocks' current column and advances the indices, all on the
device: the host only calls ``replay()`` per step.
The index is per row, so the continuous engine keys each slot by its
own emitted count; the chunked engine sets every row alike.

``SpeculativeRoundGraph`` captures one greedy speculative round of an
engine over its two caches (both snapshots, K drafter steps, the target's
verify chunk, acceptance and both rollbacks), writing the round's tokens
into column r of static (B, R, K) blocks: R rounds are R replays.

``PrefillGraph`` captures one prefill for one prompt shape into the
engine's cache (``LM.prefill`` of a (B, S) chunk, or ``LM.prefill_into_slot``
of a (1, S) prompt into the slot a static device tensor names), reading
its prompts from a static buffer and writing the last-token logits into a
static buffer; its weights are the ones bound at capture (baked).

Every buffer a graph reads or writes after its replay lies outside the
graph's memory pool, so what a capture allocates is dead once a replay
ends: the graphs of one engine share ONE pool and one capture stream
(``GraphPool``; the allocator reuses a block only on the stream it was
allocated on), replayed one at a time on one stream, in any order.

Each graph captures once, after a warm-up run on the capture stream,
under torch's default capture error mode; a capture that fails raises.
The kernel wrappers count ``LAUNCHES`` in Python, which a replay would
not touch: ``CountedGraph`` records each kernel module's counts over the
capture, takes them back (a capture launches nothing), and adds them on
every replay, so the counts stay launches on the device. It does the same
with ``models.attention.PREFILL_FALLBACKS``, the prefills that asked for
flash and ran blockwise attention.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import column_gemm, flash_attention, pattern_conv
from repro_torch.kernels import pattern_gemm
from repro_torch.models import attention
from repro_torch.models.transformer import finite_rows
from repro_torch.serve.sampler import fold_in

KERNEL_MODULES = (pattern_gemm, flash_attention, column_gemm, pattern_conv)


def _counts() -> Tuple[List[Tuple[int, Dict[str, int]]], int]:
    return ([(m.LAUNCHES, dict(getattr(m, "ROUTE_LAUNCHES", {})))
             for m in KERNEL_MODULES], attention.PREFILL_FALLBACKS)


def _restore(counts) -> None:
    launches, attention.PREFILL_FALLBACKS = counts
    for m, (n, routes) in zip(KERNEL_MODULES, launches):
        m.LAUNCHES = n
        if routes:
            m.ROUTE_LAUNCHES.update(routes)


class GraphPool:
    """The memory pool and capture stream an engine's graphs share;
    ``reserved``: the bytes their captures have reserved so far."""

    def __init__(self, device: torch.device):
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.reserved = 0


class CountedGraph:
    """A captured ``fn()`` whose replays count the kernel launches it
    holds. ``fn`` writes its results into tensors allocated before the
    capture. ``warmup`` (default ``fn``) runs once on the capture stream
    first, so lazy set-up (kernel builds, library handles) happens outside
    the capture. ``pool_bytes``: the device memory the capture added to
    ``pool``'s."""

    def __init__(self, fn: Callable[[], Any], pool: GraphPool,
                 warmup: Optional[Callable[[], Any]] = None):
        self.graph = torch.cuda.CUDAGraph()
        stream = pool.stream
        device = stream.device
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            (warmup or fn)()                       # builds kernels, handles
        stream.synchronize()
        torch.cuda.empty_cache()       # as the capture does on entry
        reserved = torch.cuda.memory_reserved(device)
        before = _counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool.handle,
                                  stream=stream):
                fn()
        finally:
            after = _counts()
            _restore(before)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        pool.reserved += self.pool_bytes
        self.launches = [
            (a - b, {r: ra[r] - rb.get(r, 0) for r in ra})
            for (b, rb), (a, ra) in zip(before[0], after[0])]
        self.fallbacks = after[1] - before[1]

    def replay(self) -> None:
        self.graph.replay()
        for m, (n, routes) in zip(KERNEL_MODULES, self.launches):
            m.LAUNCHES += n
            for r, k in routes.items():
                m.ROUTE_LAUNCHES[r] += k
        attention.PREFILL_FALLBACKS += self.fallbacks


class DecodeGraph:
    """One decode step of ``model`` on ``params`` over the engine's static
    buffers, captured once: the KV cache, and in ``rows`` the current
    token of each row ``token`` (B, 1), each row's token index ``index``
    (B,) and its row key ``keys`` (B,). ``sample(logits, keys)`` is the
    engine's sampler (it reads the engine's mask and temperatures).

    A replay samples row b's next token under ``fold_in(keys[b],
    index[b])``, writes it into ``token`` and into column ``col`` of the
    (B, W) token block, with ``flags`` writes the row's finite-logits
    flag into the same column of the flag block, and advances ``index``
    and ``col``, all on the device. The host sets ``token`` and ``index``
    between runs: the chunked engine all rows alike, the continuous engine
    per slot. Only the continuous engine reads the flags (its NaN
    quarantine); the chunked engine's graph computes none."""

    def __init__(self, model, params, cache: Dict[str, Any], width: int,
                 sample: Callable, rows: Dict[str, torch.Tensor],
                 pool: GraphPool, flags: bool):
        dev = cache["pos"].device
        B = cache["pos"].shape[0]
        self.col = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((B, width), dtype=torch.int64, device=dev)
        self.ok = (torch.zeros((B, width), dtype=torch.bool, device=dev)
                   if flags else None)
        keys = rows["keys"]

        def step(cache, token, index, col, out, ok):
            _, logits = model.decode_step(params, cache, token)
            nxt = sample(logits, fold_in(keys, index))
            token.copy_(nxt)
            out.index_copy_(1, col.view(1), nxt)
            if ok is not None:
                ok.index_copy_(1, col.view(1),
                               finite_rows(logits)[:, None])
            index.add_(1)
            col.add_(1)

        live = (rows["token"], rows["index"], self.col, self.out, self.ok)
        # the warm-up step runs on a scratch cache and buffers: the live
        # cache may hold prefilled rows
        scratch = model.init_cache(B, cache["slot_pos"].shape[1])
        self.graph = CountedGraph(
            lambda: step(cache, *live), pool,
            warmup=lambda: step(scratch, *(None if t is None else t.clone()
                                           for t in live)))

    def run(self, num_steps: int
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``num_steps`` replays from the rows' current token and index ->
        (tokens, flags), each (B, num_steps): views of the output blocks,
        overwritten by the next ``run`` (flags None without ``flags``)."""
        if num_steps > self.out.shape[1]:
            raise ValueError(f"{num_steps} steps exceed the decode graph's "
                             f"output block of {self.out.shape[1]}")
        self.col.zero_()
        for _ in range(num_steps):
            self.graph.replay()
        ok = None if self.ok is None else self.ok[:, :num_steps]
        return self.out[:, :num_steps], ok


class PrefillGraph:
    """``prefill(prompts) -> last-token logits`` of prompts of one shape,
    writing the engine's cache, captured with the weights bound at
    capture: ``LM.prefill`` of a (B, S) chunk for the chunked engine,
    ``LM.prefill_into_slot`` of a (1, S) prompt for the continuous one
    (its slot read from a static device tensor, so one graph per S serves
    every slot; the warm-up writes the row of the slot being admitted,
    which the replay then rewrites)."""

    def __init__(self, prefill: Callable[[torch.Tensor], torch.Tensor],
                 shape: Tuple[int, int], device: torch.device,
                 pool: GraphPool):
        self.prompts = torch.zeros(shape, dtype=torch.int64, device=device)
        self.logits: Optional[torch.Tensor] = None

        def run():
            logits = prefill(self.prompts)
            if self.logits is None:        # the warm-up, before the capture
                self.logits = torch.empty_like(logits)
            self.logits.copy_(logits)

        self.graph = CountedGraph(run, pool)

    def run(self, prompts: torch.Tensor) -> torch.Tensor:
        """Last-token logits (B, 1, V): a static buffer, overwritten by the
        next ``run``."""
        self.prompts.copy_(prompts)
        self.graph.replay()
        return self.logits


class SpeculativeRoundGraph:
    """``round_fn(tcache, dcache, bufs)``, one greedy round of the
    speculative engine over its caches and static buffers, captured once
    per (B, K). ``bufs`` holds the pending token, the slot mask, the
    (B, W, K) / (B, W) output blocks and the column index ``col`` the
    round writes and advances. The warm-up runs on scratch caches and
    buffers (the live ones hold prefilled rows)."""

    def __init__(self, round_fn: Callable, models: Tuple[Any, Any],
                 caches: Tuple[Dict[str, Any], Dict[str, Any]],
                 bufs: Dict[str, torch.Tensor], pool: GraphPool):
        self.bufs = bufs
        B, C = caches[0]["slot_pos"].shape
        scratch = ([m.init_cache(B, C) for m in models]
                   + [{k: t.clone() for k, t in bufs.items()}])
        self.graph = CountedGraph(lambda: round_fn(*caches, bufs), pool,
                                  warmup=lambda: round_fn(*scratch))

    def run(self, num_rounds: int) -> None:
        """``num_rounds`` replays into columns 0 .. num_rounds - 1."""
        self.bufs["col"].zero_()
        for _ in range(num_rounds):
            self.graph.replay()

