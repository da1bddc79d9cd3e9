"""CUDA graphs of the serving hot path (the port's counterpart of the
reference's ``jax.jit`` programs: the decode ``lax.scan`` and the
weight-baked prefill of ``repro/serve/engine.py``).

``DecodeGraph`` captures ONE decode step of the engine over static
buffers: the KV cache, the current token, a device step index, the
engine's row keys, and a (B, W) output block. A replay runs the step,
samples the next token with the engine's ``sample`` (keyed by
``fold_in(row key, step index)``), writes it into the output block's
column ``step`` and advances the index, all on the device: the host only
calls ``replay()`` per token.

``PrefillGraph`` captures ``LM.prefill`` for one padded prompt length S
into the engine's cache, reading its prompts from a static (B, S) buffer
and writing the last-token logits into a static buffer; its weights are
the ones bound at capture (baked).

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
    """One decode step of ``model`` on ``params`` and the engine's static
    buffers (see the module docstring), captured once. ``sample(logits,
    keys)`` is the engine's sampler, ``row_keys`` its (B,) row keys."""

    def __init__(self, model, params, cache: Dict[str, Any], width: int,
                 sample: Callable, row_keys: torch.Tensor, pool: GraphPool):
        dev = cache["pos"].device
        B = cache["pos"].shape[0]
        self.token = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((B, width), dtype=torch.int64, device=dev)

        def step(cache, token, index, out):
            _, logits = model.decode_step(params, cache, token)
            nxt = sample(logits, fold_in(row_keys, index))
            token.copy_(nxt)
            out.index_copy_(1, index.view(1), nxt)
            index.add_(1)

        # the warm-up step runs on a scratch cache and buffers: the live
        # cache may hold a prefilled chunk
        scratch = model.init_cache(B, cache["slot_pos"].shape[1])
        self.graph = CountedGraph(
            lambda: step(cache, self.token, self.step, self.out), pool,
            warmup=lambda: step(scratch, self.token.clone(),
                                self.step.clone(), self.out.clone()))

    def run(self, tok0: torch.Tensor, num_steps: int) -> torch.Tensor:
        """Tokens (B, 1 + num_steps): ``tok0`` (token 0, sampled from the
        prefill logits), then ``num_steps`` replays. A view of the output
        block, overwritten by the next ``run``."""
        if 1 + num_steps > self.out.shape[1]:
            raise ValueError(f"{1 + num_steps} tokens exceed the decode "
                             f"graph's output block of {self.out.shape[1]}")
        self.token.copy_(tok0)
        self.out[:, :1].copy_(tok0)
        self.step.fill_(1)
        for _ in range(num_steps):
            self.graph.replay()
        return self.out[:, :1 + num_steps]


class PrefillGraph:
    """``LM.prefill`` of (B, S) prompts into the engine's cache, captured
    for one S with the weights bound at capture."""

    def __init__(self, model, params, cache: Dict[str, Any], S: int,
                 max_seq_len: int, pool: GraphPool):
        dev = cache["pos"].device
        B = cache["pos"].shape[0]
        self.prompts = torch.zeros((B, S), dtype=torch.int64, device=dev)
        self.logits: Optional[torch.Tensor] = None

        def prefill():
            logits = model.prefill(params, self.prompts, max_seq_len,
                                   cache=cache)[1]
            if self.logits is None:        # the warm-up, before the capture
                self.logits = torch.empty_like(logits)
            self.logits.copy_(logits)

        self.graph = CountedGraph(prefill, pool)

    def run(self, prompts: torch.Tensor) -> torch.Tensor:
        """Last-token logits (B, 1, V): a static buffer, overwritten by the
        next ``run``."""
        self.prompts.copy_(prompts)
        self.graph.replay()
        return self.logits
