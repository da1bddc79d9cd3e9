"""Serving engines (mirrors ``repro/serve/engine.py``): chunked batches
(``ServeEngine``) and continuous batching (``ContinuousEngine``).

``ServeEngine.generate`` buckets requests by prompt length (stable sort),
serves them in chunks of ``batch_size``: one prefill of the chunk's
left-padded prompts (the zero pad tokens ARE attended, as in the
reference), then one decode loop as long as the chunk's longest
``max_new_tokens``. Empty slots of a short chunk sample token 0. Each
request's tokens are trimmed to its own ``max_new_tokens`` and at its
``eos_id``. Results come back in request order, with one device-to-host
transfer per chunk.

``ContinuousEngine`` manages slots: each batch row owns its KV rows (its
own write position, valid-length mask and rope offsets; see
``serve/__init__.py``), decode runs in micro-chunks of at most
``chunk_steps`` steps, and BETWEEN chunks the host-side ``Scheduler``
retires slots that hit their own stop and admits queued requests into the
freed slots through ``LM.prefill_into_slot``: a solo (1, S) prefill
written into one row of the live cache. So admitted prompts are never
distorted by chunk-mates' padding, and live slots never notice an
admission: every request's tokens are those it gets served alone.

Sampling: every row draws with ``temperature_sample`` at its own
temperature (rows without one, or at <= 0, take the greedy sampler
exactly), token i of a request keyed by ``fold_in(row key, i)``:
``request_key(Request.seed)`` for a seeded request, else a draw of the
engine's generator (seeded by ``seed``; the chunked engine draws none for
a chunk in which no request sets ``temperature``, the continuous one none
for a greedy admission, as in the reference).

Each engine keeps ONE KV cache of (``batch_size``, ``max_seq_len``) that
its prefills write in place. On the card each decode step is one replay
of a captured CUDA graph (``serve/graphs.py``), and each prompt length S
prefills through its own graph, captured at first use, its weights baked
in (the reference's ``bake_weights``): such an engine refuses other
params. The graphs share one memory pool, and an engine keeps at most
``MAX_PREFILL_GRAPHS`` prefill graphs, dropping the least recently used.
On the CPU the same steps run eagerly. There is no eager fallback on the
card: a capture that fails raises.

With ``packed=True`` and a ``PrunedArtifact`` every pruned GEMM runs its
scheme's packed kernel (``pattern_gemm`` for tile_pattern, ``column_gemm``
for column); ``packed=False`` serves the dense pruned weights.

``ServeEngine(speculative=draft)`` routes ``generate`` through a
``serve.speculative.SpeculativeEngine`` over this engine's params, cache
and graphs: ``draft`` proposes ``draft_k`` tokens a round and the params
verify them in one chunked pass. Both engines bucket and pad a request
list alike (``_bucketed_generate``, ``pad_prompts``), so greedy tokens
are this engine's own.

Telemetry (``runtime/telemetry.py``) is recorded on the host at the
engines' existing syncs, never inside a graph, so tokens are the same
with it on or off. So is the kernel profiler (``runtime/profiler.py``,
inert unless a ``profiler_scope`` is open): ``ServeEngine`` walls each
chunk's prefill and decode (the graph replays on the card, the eager
calls on the CPU) as ``prefill`` / ``decode_many`` under scheme
``engine:chunked``, with CUDA event pairs read lazily;
``ContinuousEngine`` records each decode chunk's time, measured at the
transfer it already syncs on, under ``engine:continuous``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.models.attention import cache_capacity
from repro_torch.models.transformer import LM, finite_rows
from repro_torch.runtime.profiler import get_profiler
from repro_torch.runtime.telemetry import MetricsRegistry, Telemetry
from repro_torch.serve.graphs import DecodeGraph, GraphPool, PrefillGraph
from repro_torch.serve.sampler import (
    fold_in,
    fold_key_grid,
    greedy_sample,
    request_key,
    temperature_sample,
)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.slots import trim_at_eos
from repro_torch.sparse.artifact import PrunedArtifact
from repro_torch.sparse.packed import tree_packed_bytes
from repro_torch.sparse.tune import m_bucket

__all__ = ["CancelToken", "ContinuousEngine", "MAX_PREFILL_GRAPHS",
           "Request", "Result", "ServeEngine", "trim_at_eos"]


class CancelToken:
    """Host-side cancel handle: the submitter flips it, the engine reads
    it between micro-chunks (a dispatched chunk always finishes, so
    cancellation costs at most one chunk of extra decode)."""

    __slots__ = ("_cancelled",)

    def __init__(self) -> None:
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                      # (S,) token ids: tensor, array or list
    max_new_tokens: int = 16
    eos_id: Optional[int] = None     # stop after emitting this token
    temperature: Optional[float] = None   # None or <= 0: greedy
    seed: Optional[int] = None       # token i draws under fold_in(
    # request_key(seed), i) on any engine, batch or engine seed
    deadline: Optional[float] = None  # absolute seconds on the ENGINE clock
    # (the clock ``arrivals`` use); past it the continuous engine reaps the
    # request between chunks with status "timeout": queued ones before any
    # prefill, live ones keeping the tokens emitted so far
    cancel_token: CancelToken = dataclasses.field(default_factory=CancelToken)

    def cancel(self) -> None:
        """Request-scoped cancellation; honored at the next chunk edge."""
        self.cancel_token.cancel()

    @property
    def cancelled(self) -> bool:
        return self.cancel_token.cancelled


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]
    # terminal disposition:
    #   ok        ran to its own stop (max_new_tokens / eos)
    #   shed      never queued: bounded queue (or capacity check) rejected it
    #   timeout   deadline passed (tokens = partial output, possibly [])
    #   cancelled cancel() fired   (tokens = partial output, possibly [])
    #   failed    slot poisoned (non-finite logits) or engine gave up on it
    status: str = "ok"


def _resolve_params(model: LM, params: Any, packed: bool):
    """A raw params tree or a ``PrunedArtifact`` -> (bound params,
    bind_report); the report names packed leaves ``bind`` served dense
    (None for a raw tree)."""
    if isinstance(params, PrunedArtifact):
        return params.bind(model, packed=packed), params.bind_report
    if packed:
        raise TypeError("packed=True needs a PrunedArtifact; got a raw "
                        "params tree")
    return params, None


def require_token_input(model: LM, engine: str) -> None:
    """An engine decodes by feeding each sampled token id back into the
    model; a model fed embeddings by a stub front end has no table to
    embed them with. Refuse it at construction (the reference's engines
    fail on it inside the decode loop): such a model is served at the LM
    level, ``prefill`` / ``decode_step`` on front-end embeddings, or
    ``hidden_states`` then ``lm_logits`` for an encoder."""
    cfg = model.config
    if cfg.input_kind != "tokens":
        raise ValueError(
            f"{engine} cannot serve {cfg.name}: it takes {cfg.input_kind} "
            "from a stub front end, and decoding feeds sampled token ids "
            "back into the model, which has no embedding table; serve it "
            "at the LM level (LM.prefill / LM.decode_step on embeddings"
            + (", or LM.hidden_states then LM.lm_logits for an encoder"
               if cfg.encoder_only else "") + ")")


def _bucketed_generate(requests: Sequence[Request], batch_size: int,
                       generate_batch: Callable[[List[Request]],
                                                List[Result]]
                       ) -> List[Result]:
    """The chunking loop of the chunked and speculative engines: bucket
    by prompt length (stable sort: equal lengths keep their order), serve
    chunks of ``batch_size``, return results in request order."""
    order = sorted(range(len(requests)),
                   key=lambda i: len(requests[i].prompt))
    results: List[Optional[Result]] = [None] * len(requests)
    for i in range(0, len(order), batch_size):
        idxs = order[i: i + batch_size]
        out = generate_batch([requests[j] for j in idxs])
        for j, res in zip(idxs, out):
            results[j] = res
    return results  # type: ignore[return-value]


def _stochastic_rows(requests: Sequence[Request], batch_size: int,
                     gen: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot temperatures and per-request row keys of a chunk, on the
    host: (temps (B,) fp32, keys (B,) int64); empty slots 0 and 0."""
    n = len(requests)
    temps = [r.temperature if r.temperature is not None else 0.0
             for r in requests] + [0.0] * (batch_size - n)
    keys = [request_key(r.seed, gen) for r in requests] + [0] * (
        batch_size - n)
    return (torch.tensor(temps, dtype=torch.float32),
            torch.tensor(keys, dtype=torch.int64))


MAX_PREFILL_GRAPHS = 8      # prefill graphs an engine keeps on the card


class _Engine:
    """What both engines hold: the bound params, ONE KV cache written in
    place, the static row buffers their sampler and decode graph read
    (``temps``, ``keys``, ``mask``, each row's current ``token`` and token
    ``index``), and on the card the CUDA graphs over them in one pool."""

    _reads_flags = False        # does the decode graph write logits flags

    def __init__(self, model: LM, params: Any, *, batch_size: int,
                 max_seq_len: int, packed: bool, seed: int,
                 sampler: Callable, decode_width: int, device: DeviceLike,
                 graph_pool: Optional[GraphPool] = None):
        require_token_input(model, type(self).__name__)
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params, self.bind_report = _resolve_params(model, params, packed)
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.sampler = sampler
        self._gen = torch.Generator().manual_seed(seed)
        self.graphs = self.device.type == "cuda"
        self.cache = model.init_cache(batch_size, max_seq_len)
        B, dev = batch_size, self.device
        self.rows = {
            "temps": torch.zeros((B,), dtype=torch.float32, device=dev),
            **{k: torch.zeros((B,), dtype=torch.int64, device=dev)
               for k in ("keys", "mask", "index")},
            "token": torch.zeros((B, 1), dtype=torch.int64, device=dev)}
        self._decode_width = decode_width
        self.decode_graph = None         # captured at the first decode
        self.prefill_graphs: Dict[int, Any] = {}   # by S, least recent first
        # an engine holding two caches (the speculative one) gives both
        # buffer sets one pool
        self.graph_pool = graph_pool or (GraphPool(dev) if self.graphs
                                         else None)
        self._graph_params = self.params

    def _check_params(self) -> None:
        if self.graphs and self.params is not self._graph_params:
            raise ValueError(
                "the params are baked into this engine's CUDA graphs and "
                "cannot be swapped; construct a new engine to serve "
                "different weights")

    def _prefill_graph(self, S: int, prefill: Callable,
                       shape: Tuple[int, int]) -> PrefillGraph:
        """The prefill graph of prompt length S, captured at first use;
        the least recently used one dropped past ``MAX_PREFILL_GRAPHS``."""
        self._check_params()
        graph = self.prefill_graphs.pop(S, None)
        if graph is None:
            if len(self.prefill_graphs) == MAX_PREFILL_GRAPHS:
                del self.prefill_graphs[next(iter(self.prefill_graphs))]
            graph = PrefillGraph(prefill, shape, self.device,
                                 self.graph_pool)
        self.prefill_graphs[S] = graph          # now the most recent
        return graph

    def _decode_replays(self, num_steps: int):
        """``num_steps`` decode-graph replays from the rows' ``token`` and
        ``index`` -> (tokens, flags) (B, num_steps); the graph captured at
        the first call."""
        self._check_params()
        if self.decode_graph is None:
            self.decode_graph = DecodeGraph(
                self.model, self.params, self.cache, self._decode_width,
                self.sample, self.rows, self.graph_pool,
                flags=self._reads_flags)
        return self.decode_graph.run(num_steps)

    def sample(self, logits: torch.Tensor, keys: torch.Tensor):
        """The engine's one sampler: logits (B, 1, V) and (B,) step keys ->
        (B, 1) tokens at each row's temperature, empty slots 0."""
        rows = self.rows
        return temperature_sample(logits, keys, rows["temps"],
                                  greedy=self.sampler) * rows["mask"][:, None]


class ServeEngine(_Engine):
    def __init__(self, model: LM, params: Any, *, batch_size: int,
                 max_seq_len: int, sampler: Callable = greedy_sample,
                 packed: bool = False, seed: int = 0,
                 telemetry: Optional[Telemetry] = None,
                 straggler: Optional[Any] = None,
                 speculative: Optional[Any] = None, draft_k: int = 4,
                 draft_model: Optional[LM] = None,
                 graph_pool: Optional[GraphPool] = None,
                 device: DeviceLike = None):
        """``params``: a ``PrunedArtifact`` or, with ``packed=False``, a raw
        params tree. ``sampler`` maps logits (B, 1, V) to tokens (B, 1) on
        the device (inside the decode graph on the card); rows at
        temperature None or <= 0 take it. ``seed`` seeds the row keys of
        requests without their own.

        ``telemetry``: an optional ``runtime.telemetry.Telemetry``; each
        chunk records a ``decode_chunk`` span and one ``retire`` event per
        request into its tracer, and chunk seconds, TTFT, TPOT and status
        counters (labelled ``engine="chunked"``) into its registry. The
        chunk's one host sync is its only timestamp, so TTFT is measured
        from the chunk's start to that sync. ``straggler``: an optional
        ``runtime.StragglerMonitor`` fed each chunk's wall time; a flagged
        chunk becomes a ``straggler`` trace event.

        ``speculative``: a drafter (a ``PrunedArtifact``, bound packed, or
        a raw params tree of ``draft_model``, default ``model``): then
        ``generate`` runs a ``SpeculativeEngine`` that drafts ``draft_k``
        tokens a round and verifies them against this engine's params,
        cache and graphs (telemetry and straggler go to it); its
        ``stats`` are ``self.speculative.stats``. ``graph_pool``: the pool
        to capture into (default a new one on the card)."""
        super().__init__(model, params, batch_size=batch_size,
                         max_seq_len=max_seq_len, packed=packed, seed=seed,
                         sampler=sampler, decode_width=max_seq_len,
                         device=device, graph_pool=graph_pool)
        self.telemetry = telemetry
        self.straggler = straggler
        self._batches = 0
        self._nbytes: Dict[str, int] = {}   # profiler bytes: params, cache
        self.speculative = None
        if speculative is not None:
            from repro_torch.serve.speculative import SpeculativeEngine

            self.speculative = SpeculativeEngine(
                model, self.params, speculative, batch_size=batch_size,
                max_seq_len=max_seq_len, draft_k=draft_k,
                draft_model=draft_model, seed=seed, telemetry=telemetry,
                straggler=straggler, target_engine=self)

    # ----------------------------------------------------------- chunk set-up

    def pad_prompts(self, requests: Sequence[Request]):
        """Left-pad a chunk's prompts with token 0 to its longest and fill
        empty slots with zero prompts -> ((B, S) ids, (B,) slot mask),
        built on the host and copied to the device once each (the prefill
        geometry of the speculative engine too)."""
        B, n = self.batch_size, len(requests)
        S = max(len(r.prompt) for r in requests)
        prompts = torch.zeros((B, S), dtype=torch.int64)
        for row, r in enumerate(requests):
            p = torch.as_tensor(r.prompt, dtype=torch.int64).cpu()
            prompts[row, S - p.shape[0]:] = p
        slot_mask = torch.tensor([1] * n + [0] * (B - n), dtype=torch.int64)
        return prompts.to(self.device), slot_mask.to(self.device)

    def set_rows(self, requests: Sequence[Request],
                 slot_mask: torch.Tensor) -> None:
        """Load a chunk's slot mask, temperatures and row keys into the
        engine's static row buffers (a chunk without temperatures draws no
        row keys, as in the reference)."""
        self.rows["mask"].copy_(slot_mask)
        if any(r.temperature is not None for r in requests):
            temps, keys = _stochastic_rows(requests, self.batch_size,
                                           self._gen)
            self.rows["temps"].copy_(temps)
            self.rows["keys"].copy_(keys)
        else:
            self.rows["temps"].zero_()
            self.rows["keys"].zero_()

    # ------------------------------------------------------------ hot path

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor):
        """(B, S) token ids -> (cache, last-token logits), written into the
        engine's cache: through the prefill graph of S on the card (the
        logits a static buffer, overwritten by the next prefill), eagerly
        on the CPU."""
        model, cache, seq = self.model, self.cache, self.max_seq_len
        if not self.graphs:
            return model.prefill(self.params, prompts, seq, cache=cache)
        params = self.params
        graph = self._prefill_graph(
            prompts.shape[1],
            lambda p: model.prefill(params, p, seq, cache=cache)[1],
            tuple(prompts.shape))
        return cache, graph.run(prompts)

    @torch.no_grad()
    def decode(self, tok0: torch.Tensor, num_steps: int,
               index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode ``num_steps`` tokens after ``tok0`` from the engine's
        cache -> (B, 1 + num_steps) tokens, ``tok0`` first: one
        decode-graph replay per step on the card (captured at the first
        call), ``LM.decode_many`` on the CPU. ``index`` (B,): each row's
        token index of the first new token, which keys its draw (default
        1: ``tok0`` is token 0)."""
        if num_steps == 0:
            return tok0
        rows = self.rows
        if index is None:
            rows["index"].fill_(1)
        else:
            rows["index"].copy_(index)
        if not self.graphs:
            keys = fold_key_grid(rows["keys"], rows["index"], num_steps)
            _, rest = self.model.decode_many(self.params, self.cache, tok0,
                                             num_steps, sampler=self.sample,
                                             keys=keys)
        else:
            rows["token"].copy_(tok0)
            rest, _ = self._decode_replays(num_steps)
        return torch.cat([tok0, rest], dim=1)

    # ------------------------------------------------------------ requests

    def generate(self, requests: Sequence[Request]) -> List[Result]:
        """Serve requests in length-bucketed chunks; request order kept
        (through the speculative engine when the engine has one)."""
        if self.speculative is not None:
            return self.speculative.generate(requests)
        return _bucketed_generate(requests, self.batch_size,
                                  self._generate_batch)

    @torch.no_grad()
    def _generate_batch(self, requests: Sequence[Request]) -> List[Result]:
        tel, straggler = self.telemetry, self.straggler
        clock = tel.metrics.clock if tel is not None else time.perf_counter
        t_b0 = clock() if tel is not None or straggler is not None else 0.0
        # the loop runs to THIS chunk's longest request, not a global max
        max_new = max(r.max_new_tokens for r in requests)
        prompts, slot_mask = self.pad_prompts(requests)
        self.set_rows(requests, slot_mask)
        prof = get_profiler()
        if prof.active:
            # engine-level walls around the graph replays (eager calls on
            # the CPU), keyed by their GEMM row counts; values untouched
            B, S = prompts.shape
            if not self._nbytes:            # shape-fixed per engine
                self._nbytes = {"params": tree_packed_bytes(self.params),
                                "cache": tree_packed_bytes(self.cache)}
            _, logits = prof.wall("prefill", self.prefill, (prompts,),
                                  scheme="engine:chunked",
                                  bucket=m_bucket(B * S),
                                  nbytes=self._nbytes["params"])
        else:
            _, logits = self.prefill(prompts)
        tok0 = self.sample(logits, fold_in(self.rows["keys"], 0))
        if prof.active and max_new > 1:
            # KV bytes touched per chunk: every step reads the cache
            toks = prof.wall("decode_many", self.decode, (tok0, max_new - 1),
                             scheme="engine:chunked",
                             bucket=m_bucket(self.batch_size),
                             nbytes=self._nbytes["cache"] * (max_new - 1))
        else:
            toks = self.decode(tok0, max_new - 1)
        rows = toks.cpu().tolist()          # one device -> host transfer
        results = [Result(uid=r.uid,
                          tokens=trim_at_eos(rows[j][: r.max_new_tokens],
                                             r.eos_id))
                   for j, r in enumerate(requests)]
        if straggler is not None:
            self._batches += 1
            ev = straggler.record(self._batches, max(clock() - t_b0, 0.0))
            if ev is not None and tel is not None and tel.tracer is not None:
                tel.tracer.event(
                    "straggler", ts=clock(), engine="chunked", step=ev.step,
                    seconds=ev.seconds, median=ev.median,
                    deviation=ev.deviation)
        if tel is not None:
            self._record_chunk(tel, t_b0, clock(), results, max_new)
        return results

    def _record_chunk(self, tel: Telemetry, t_b0: float, t_sync: float,
                      results: List[Result], max_new: int) -> None:
        """A chunk's telemetry at its one sync: first-token time is the
        chunk's end for every request in it."""
        dur = max(t_sync - t_b0, 0.0)
        reg = tel.metrics
        reg.histogram("serve.chunk_seconds", engine="chunked").observe(dur)
        reg.counter("serve.chunks_total", engine="chunked").inc()
        h_ttft = reg.histogram("serve.ttft_seconds", engine="chunked")
        h_tpot = reg.histogram("serve.tpot_seconds", engine="chunked")
        c_ok = reg.counter("serve.requests_total", engine="chunked",
                           status="ok")
        for _ in results:
            h_ttft.observe(dur)
            h_tpot.observe(dur / max_new)
            c_ok.inc()
        if tel.tracer is not None:
            tel.tracer.span_record(
                "decode_chunk", ts=t_b0, dur=dur, engine="chunked",
                steps=max_new, active=len(results), batch=self.batch_size)
            for res in results:
                tel.tracer.event("retire", ts=t_sync, engine="chunked",
                                 uid=res.uid, status=res.status,
                                 tokens=len(res.tokens))


STATUSES = ("ok", "shed", "timeout", "cancelled", "failed")


class ContinuousEngine(_Engine):
    """Continuous-batching engine: slot-managed KV cache, in-flight
    admission, streaming results (the reference's ``ContinuousEngine``).

    Between micro-chunks the host-side ``Scheduler`` reaps dead requests,
    admits arrived ones into free slots (``LM.prefill_into_slot``: through
    the slot prefill graph of the prompt's length on the card, with one
    host sync for the first token and its finite-logits check), and after
    each chunk retires finished slots. A chunk of K = ``chunk_len()``
    steps is K replays of the slot decode graph (eagerly
    ``LM.decode_many(with_flags=True)`` on the CPU), step s of slot b
    keyed by ``fold_in(row key b, e_b + s)`` with e_b the slot's own
    emitted count, then ONE device-to-host transfer of tokens and flags.
    Per-slot geometry makes every row independent, so a request's tokens
    are those it gets served alone, for any admission order and any
    chunk-mates.

    The cache is cleared at the start of every run (the reference builds
    a fresh one per run), so a lane quarantined in one run serves again
    in the next.
    """

    _reads_flags = True

    def __init__(self, model: LM, params: Any, *, batch_size: int,
                 max_seq_len: int, chunk_steps: int = 8,
                 packed: bool = False, seed: int = 0,
                 max_queue: Optional[int] = None, strict: bool = True,
                 straggler: Optional[Any] = None,
                 fault_hook: Optional[Callable[..., Any]] = None,
                 telemetry: Optional[Telemetry] = None,
                 device: DeviceLike = None):
        """Reliability knobs (see ``serve/__init__.py``):

        ``max_queue``: bounded admission queue; submissions beyond this
        depth come back ``status="shed"``. None = unbounded.

        ``strict``: oversized requests (prompt + budget past the cache):
        True raises ``ValueError`` up front; False sheds them typed and
        serves the rest.

        ``straggler``: an optional ``runtime.StragglerMonitor``; every
        micro-chunk's wall time is recorded against it, and flagged
        chunks land in ``stats["straggler_events"]`` (and the trace).

        ``fault_hook``: ``(cache, scheduler) -> None``, called at every
        chunk edge before the chunk: the chaos-injection seam
        (``repro_torch.testing.chaos``). It mutates the live cache in
        place (the captured graphs read those tensors); a hook that
        returns anything else than None raises ``TypeError``.

        ``telemetry``: an optional ``runtime.telemetry.Telemetry``; the
        run loop records the request lifecycle into its tracer (enqueue,
        admit, first_token, decode_chunk, one terminal ``retire`` per
        request carrying its status) and TTFT / TPOT / queue-wait /
        chunk-time histograms and status counters (labelled
        ``engine="continuous"``) into its registry, all on the engine
        clock (the tracer's clock is rebound for the run). None: metrics
        land in a private per-run registry (they still back ``stats``)."""
        if chunk_steps < 1:
            raise ValueError("chunk_steps must be >= 1")
        super().__init__(model, params, batch_size=batch_size,
                         max_seq_len=max_seq_len, packed=packed, seed=seed,
                         sampler=greedy_sample, decode_width=chunk_steps,
                         device=device)
        self.chunk_steps = chunk_steps
        self.max_queue = max_queue
        self.strict = strict
        self.straggler = straggler
        self.fault_hook = fault_hook
        self.telemetry = telemetry
        self.slot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self.stats: Dict[str, Any] = {}

    # ---- public API --------------------------------------------------------

    def generate(self, requests: Sequence[Request], *,
                 arrivals: Optional[Sequence[float]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 ) -> List[Result]:
        """Serve to completion; results in the ORIGINAL request order."""
        results: List[Optional[Result]] = [None] * len(requests)
        for order, res in self._run(requests, arrivals, clock):
            results[order] = res
        return results  # type: ignore[return-value]

    def stream(self, requests: Sequence[Request], *,
               arrivals: Optional[Sequence[float]] = None,
               clock: Optional[Callable[[], float]] = None,
               ) -> Iterator[Result]:
        """Yield each request's ``Result`` the moment it finishes
        (completion order). ``arrivals``: optional per-request arrival
        offsets (seconds); a request is admitted once the clock passes
        its arrival. ``clock``: elapsed-seconds callable (default: wall
        clock anchored at the run's start); an injected clock must
        advance on its own."""
        for _, res in self._run(requests, arrivals, clock):
            yield res

    # ---- device steps ------------------------------------------------------

    def _reset_cache(self) -> None:
        """A fresh cache in the same tensors (the graphs read them)."""
        for t in self.cache["k"] + self.cache["v"]:
            t.zero_()
        self.cache["slot_pos"].fill_(-1)
        self.cache["pos"].zero_()
        self.rows["token"].zero_()

    @torch.no_grad()
    def _admit(self, slot: int, prompt: torch.Tensor, temp: float,
               row_key: int) -> Tuple[int, bool]:
        """Prefill ``prompt`` (1, S) into row ``slot``, sample its first
        token (key ``fold_in(row_key, 0)``) into the row's ``token`` ->
        (first token, logits finite), with one host sync."""
        model, params, cache = self.model, self.params, self.cache
        if self.graphs:
            self.slot.fill_(slot)
            graph = self._prefill_graph(
                prompt.shape[1],
                lambda p: model.prefill_into_slot(params, cache, p,
                                                  self.slot)[1],
                tuple(prompt.shape))
            logits = graph.run(prompt)
        else:
            logits = model.prefill_into_slot(params, cache, prompt, slot)[1]
        key = torch.full((1,), row_key, dtype=torch.int64, device=self.device)
        first = temperature_sample(logits, fold_in(key, 0), temp)
        self.rows["token"][slot] = first[0]
        got = torch.cat([first.view(1), finite_rows(logits).long()]).tolist()
        return got[0], bool(got[1])

    @torch.no_grad()
    def _decode_chunk(self, K: int, table) -> Tuple[np.ndarray, np.ndarray]:
        """One micro-chunk of K steps for the table's live slots -> host
        (tokens (B, K), flags (B, K)), with one device-to-host transfer."""
        rows = self.rows
        offsets = np.zeros((self.batch_size,), np.int64)
        for slot, st in table.active.items():
            offsets[slot] = len(st.emitted)
        rows["mask"].copy_(torch.from_numpy(table.active_mask()))
        rows["temps"].copy_(torch.from_numpy(table.temperatures()))
        rows["keys"].copy_(torch.from_numpy(self._slot_keys))
        rows["index"].copy_(torch.from_numpy(offsets))
        if self.graphs:
            toks, ok = self._decode_replays(K)
        else:
            keys = fold_key_grid(rows["keys"], rows["index"], K)
            _, toks, ok = self.model.decode_many(
                self.params, self.cache, rows["token"], K,
                sampler=self.sample, keys=keys, with_flags=True)
            rows["token"].copy_(toks[:, -1:])
        both = torch.cat([toks, ok.long()], dim=1).cpu().numpy()
        return both[:, :K], both[:, K:].astype(bool)

    # ---- the serve loop ----------------------------------------------------

    def _run(self, requests: Sequence[Request],
             arrivals: Optional[Sequence[float]],
             clock: Optional[Callable[[], float]],
             ) -> Iterator[Tuple[int, Result]]:
        n = len(requests)
        arr = [0.0] * n if arrivals is None else [float(a) for a in arrivals]
        if len(arr) != n:
            raise ValueError("arrivals must match requests")

        ENG = "continuous"
        tel = self.telemetry
        tracer = tel.tracer if tel is not None else None
        # metrics always flow through a registry (a private per-run one
        # without telemetry), so ``stats`` is a view over it: per-run
        # deltas from the run-start values
        reg = tel.metrics if tel is not None else MetricsRegistry()
        c_status = {s: reg.counter("serve.requests_total", engine=ENG,
                                   status=s) for s in STATUSES}
        c_chunks = reg.counter("serve.chunks_total", engine=ENG)
        c_busy = reg.counter("serve.busy_slot_steps_total", engine=ENG)
        c_total = reg.counter("serve.total_slot_steps_total", engine=ENG)
        c_quar = reg.counter("serve.quarantined_slots_total", engine=ENG)
        h_ttft = reg.histogram("serve.ttft_seconds", engine=ENG)
        h_tpot = reg.histogram("serve.tpot_seconds", engine=ENG)
        h_qwait = reg.histogram("serve.queue_wait_seconds", engine=ENG)
        h_chunk = reg.histogram("serve.chunk_seconds", engine=ENG)
        base = {"chunks": c_chunks.value, "busy": c_busy.value,
                "total": c_total.value,
                **{s: c_status[s].value for s in STATUSES}}
        t_firsts: Dict[int, float] = {}   # order -> first-token time

        def finish(order: int, uid: int, tokens: List[int], status: str,
                   t: Optional[float] = None):
            c_status[status].inc()
            t_first = t_firsts.get(order)
            if t is not None and t_first is not None and len(tokens) > 1:
                h_tpot.observe((t - t_first) / (len(tokens) - 1))
            if tracer is not None:
                # the ONE terminal event per request
                tracer.event("retire", engine=ENG, uid=uid, order=order,
                             status=status, tokens=len(tokens),
                             ts=t if t is not None else arr[order],
                             t_first=t_first, arrival=arr[order])
            return order, Result(uid=uid, tokens=tokens, status=status)

        # a ring cache (window < max_seq_len) serves any length: it keeps
        # the last ``window`` positions
        spec = cache_capacity(self.max_seq_len,
                              self.model.config.sliding_window)
        capacity = spec.capacity
        oversized = set()
        for i, r in enumerate(requests):
            S = len(r.prompt)
            if not spec.ring and S + r.max_new_tokens - 1 > capacity:
                if self.strict:
                    raise ValueError(
                        f"request uid={r.uid}: prompt {S} + max_new_tokens "
                        f"{r.max_new_tokens} exceeds cache capacity "
                        f"{capacity}: raise max_seq_len")
                oversized.add(i)

        sched = Scheduler(self.batch_size, self.chunk_steps,
                          max_queue=self.max_queue)
        for i in sorted(range(n), key=lambda i: arr[i]):   # FIFO by arrival
            if i in oversized or not sched.submit(i, requests[i], arr[i]):
                yield finish(i, requests[i].uid, [], "shed")
            elif tracer is not None:
                tracer.event("enqueue", engine=ENG, uid=requests[i].uid,
                             order=i, ts=arr[i])

        self._reset_cache()
        self._slot_keys = np.zeros((self.batch_size,), np.int64)
        t0 = time.perf_counter()
        now = clock if clock is not None \
            else (lambda: time.perf_counter() - t0)
        if tracer is not None:
            tracer.clock = now
        if tel is None:
            reg.clock = now

        while not sched.done:
            t = now()
            for order, r, status in sched.reap_queue(t):
                yield finish(order, r.uid, [], status, t=t)
            for st in sched.ready_admissions(t):
                r = st.request
                t_adm = now()
                temp = 0.0
                if r.temperature is not None and r.temperature > 0:
                    temp = float(r.temperature)
                    self._slot_keys[st.slot] = request_key(r.seed, self._gen)
                prompt = torch.as_tensor(r.prompt, dtype=torch.int64).view(
                    1, -1).to(self.device)
                first, ok = self._admit(st.slot, prompt, temp,
                                        int(self._slot_keys[st.slot]))
                if not ok:
                    # poisoned from the first logits: quarantine the lane
                    sched.table.quarantine(st.slot)
                    yield finish(st.order, r.uid, [], "failed", t=now())
                    continue
                t_first = now()
                t_firsts[st.order] = t_first
                h_qwait.observe(t_adm - arr[st.order])
                h_ttft.observe(t_first - arr[st.order])
                if tracer is not None:
                    tracer.span_record(
                        "admit", ts=t_adm, dur=t_first - t_adm, engine=ENG,
                        uid=r.uid, order=st.order, slot=st.slot,
                        arrival=arr[st.order])
                    tracer.event("first_token", engine=ENG, uid=r.uid,
                                 order=st.order, ts=t_first,
                                 arrival=arr[st.order])
                if st.push([first]):
                    sched.table.retire(st.slot)
                    yield finish(st.order, r.uid, st.emitted, "ok",
                                 t=t_first)
            t_reap = now()
            for st in sched.reap_active(t_reap):
                yield finish(st.order, st.request.uid, st.emitted, st.status,
                             t=t_reap)

            if not sched.table.active:
                if sched.table.num_free == 0 and sched.pending:
                    # every lane is quarantined: fail the backlog typed
                    t_fail = now()
                    for order, r, status in sched.fail_pending():
                        yield finish(order, r.uid, [], status, t=t_fail)
                    break
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                wait = nxt - now()
                if wait > 0:
                    time.sleep(min(wait, 0.05) if clock is None else 1e-4)
                continue

            if self.fault_hook is not None:
                if self.fault_hook(self.cache, sched) is not None:
                    raise TypeError("a fault_hook mutates the live cache in "
                                    "place and returns None")

            t_chunk = now()
            K = sched.chunk_len()
            n_active = len(sched.table.active)
            toks, flags = self._decode_chunk(K, sched.table)
            t_end = now()
            dt_chunk = max(t_end - t_chunk, 0.0)
            if self.straggler is not None:
                ev = self.straggler.record(sched.chunks, dt_chunk)
                if ev is not None and tracer is not None:
                    tracer.event(
                        "straggler", ts=t_end, engine=ENG, step=ev.step,
                        seconds=ev.seconds, median=ev.median,
                        deviation=ev.deviation)
            chunk_idx = sched.chunks
            busy0 = sched.busy_slot_steps
            finished = sched.absorb_chunk(toks, K, ok=flags)
            busy_d = sched.busy_slot_steps - busy0
            c_chunks.inc()
            c_busy.inc(busy_d)
            c_total.inc(self.batch_size * K)
            h_chunk.observe(dt_chunk)
            prof = get_profiler()
            if prof.active:
                # the transfer already synced this chunk: record its wall
                # passively (no extra sync, no launch)
                if not hasattr(self, "_cache_nbytes"):   # shape-fixed
                    self._cache_nbytes = tree_packed_bytes(self.cache)
                prof.observe("decode_many", dt_chunk,
                             scheme="engine:continuous",
                             bucket=m_bucket(self.batch_size),
                             nbytes=self._cache_nbytes * K)
            if tracer is not None:
                tracer.span_record(
                    "decode_chunk", ts=t_chunk, dur=dt_chunk, engine=ENG,
                    chunk=chunk_idx, steps=K, active=n_active,
                    busy=busy_d, batch=self.batch_size)
            for st in finished:
                yield finish(st.order, st.request.uid, st.emitted, st.status,
                             t=t_end)

        c_quar.inc(len(sched.table.quarantined))
        busy = c_busy.value - base["busy"]
        total = c_total.value - base["total"]
        # the legacy ``stats`` surface, a view over the registry
        self.stats = {
            "chunks": int(c_chunks.value - base["chunks"]),
            "occupancy": (busy / total) if total else 0.0,
            "busy_slot_steps": int(busy),
            "total_slot_steps": int(total),
            "statuses": {s: int(c_status[s].value - base[s])
                         for s in STATUSES},
            "quarantined_slots": list(sched.table.quarantined),
            "straggler_events": (len(self.straggler.events)
                                 if self.straggler is not None else 0),
            "bind_fallbacks": (dict(self.bind_report["fallbacks"])
                               if self.bind_report else {}),
        }
        if tracer is not None:
            tracer.flush()
