"""Chunked-batch serving engine (mirrors ``repro/serve/engine.py``'s
``ServeEngine``).

``generate`` buckets requests by prompt length (stable sort), serves them
in chunks of ``batch_size``: one prefill of the chunk's left-padded
prompts (the zero pad tokens ARE attended, as in the reference), then one
decode loop as long as the chunk's longest ``max_new_tokens``. Empty
slots of a short chunk sample token 0. Each request's tokens are trimmed
to its own ``max_new_tokens`` and at its ``eos_id``. Results come back in
request order, with one device-to-host transfer per chunk.

Sampling: every row draws with ``temperature_sample`` at its own
temperature (rows without one, or at <= 0, take the engine's ``sampler``
exactly), token i of a row keyed by ``fold_in(row key, i)``:
``request_key(Request.seed)`` for a seeded request, else a draw of the
engine's generator (seeded by ``seed``; a chunk in which no request sets
``temperature`` draws none, as in the reference).

The engine keeps ONE KV cache of (``batch_size``, ``max_seq_len``) that
every chunk's prefill rewrites in place. On the card each decode step is
one replay of a captured CUDA graph (``serve/graphs.py``), and each padded
prompt length S prefills through its own graph, captured at first use,
its weights baked in (the reference's ``bake_weights``): such an engine
refuses other params. The graphs share one memory pool, and the engine
keeps at most ``MAX_PREFILL_GRAPHS`` prefill graphs, dropping the least
recently used; prompts are not padded past the chunk's longest, since pad
tokens are attended and would change the tokens. On the CPU the same
steps run eagerly. There is no eager fallback on the card: a capture
that fails raises.

With ``packed=True`` and a ``PrunedArtifact`` every pruned GEMM runs its
scheme's packed kernel (``pattern_gemm`` for tile_pattern, ``column_gemm``
for column); ``packed=False`` serves the dense pruned weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.models.transformer import LM
from repro_torch.serve.graphs import DecodeGraph, GraphPool, PrefillGraph
from repro_torch.serve.sampler import (
    fold_in,
    fold_key_grid,
    greedy_sample,
    request_key,
    temperature_sample,
)
from repro_torch.sparse.artifact import PrunedArtifact


def trim_at_eos(tokens: List[int], eos_id: Optional[int]) -> List[int]:
    """Generation stops after the eos token, which is itself emitted."""
    if eos_id is None:
        return tokens
    for i, t in enumerate(tokens):
        if t == eos_id:
            return tokens[: i + 1]
    return tokens


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                      # (S,) token ids: tensor, array or list
    max_new_tokens: int = 16
    eos_id: Optional[int] = None     # stop after emitting this token
    temperature: Optional[float] = None   # None or <= 0: greedy
    seed: Optional[int] = None       # token i draws under fold_in(
    # request_key(seed), i) on any engine, batch or engine seed


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]


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


class ServeEngine:
    def __init__(self, model: LM, params: Any, *, batch_size: int,
                 max_seq_len: int, sampler: Callable = greedy_sample,
                 packed: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        """``params``: a ``PrunedArtifact`` or, with ``packed=False``, a raw
        params tree. ``sampler`` maps logits (B, 1, V) to tokens (B, 1) on
        the device (inside the decode graph on the card); rows at
        temperature None or <= 0 take it. ``seed`` seeds the row keys of
        requests without their own."""
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
        dev = self.device
        self.rows = {"temps": torch.zeros((batch_size,), dtype=torch.float32,
                                          device=dev),
                     "keys": torch.zeros((batch_size,), dtype=torch.int64,
                                         device=dev),
                     "mask": torch.zeros((batch_size,), dtype=torch.int64,
                                         device=dev)}
        self.decode_graph = None         # captured at the first decode
        self.prefill_graphs: Dict[int, Any] = {}   # by S, least recent first
        self.graph_pool = GraphPool(dev) if self.graphs else None
        self._graph_params = self.params

    # ----------------------------------------------------------- chunk set-up

    def pad_prompts(self, requests: Sequence[Request]):
        """Left-pad a chunk's prompts with token 0 to its longest and fill
        empty slots with zero prompts -> ((B, S) ids, (B,) slot mask),
        built on the host and copied to the device once each."""
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

    def _check_params(self) -> None:
        if self.graphs and self.params is not self._graph_params:
            raise ValueError(
                "the params are baked into this engine's CUDA graphs and "
                "cannot be swapped; construct a new ServeEngine to serve "
                "different weights")

    # ------------------------------------------------------------ hot path

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor):
        """(B, S) token ids -> (cache, last-token logits), written into the
        engine's cache: through the prefill graph of S on the card (the
        logits a static buffer, overwritten by the next prefill), eagerly
        on the CPU."""
        if not self.graphs:
            return self.model.prefill(self.params, prompts, self.max_seq_len,
                                      cache=self.cache)
        self._check_params()
        S = prompts.shape[1]
        graph = self.prefill_graphs.pop(S, None)
        if graph is None:
            if len(self.prefill_graphs) == MAX_PREFILL_GRAPHS:
                del self.prefill_graphs[next(iter(self.prefill_graphs))]
            graph = PrefillGraph(self.model, self.params, self.cache, S,
                                 self.max_seq_len, self.graph_pool)
        self.prefill_graphs[S] = graph          # now the most recent
        return self.cache, graph.run(prompts)

    def sample(self, logits: torch.Tensor, keys: torch.Tensor):
        """The engine's one sampler: logits (B, 1, V) and (B,) step keys ->
        (B, 1) tokens at each row's temperature, empty slots 0."""
        rows = self.rows
        return temperature_sample(logits, keys, rows["temps"],
                                  greedy=self.sampler) * rows["mask"][:, None]

    @torch.no_grad()
    def decode(self, tok0: torch.Tensor, num_steps: int) -> torch.Tensor:
        """Decode ``num_steps`` tokens after ``tok0`` (token 0) from the
        engine's cache -> (B, 1 + num_steps) tokens, ``tok0`` first: one
        decode-graph replay per step on the card (captured at the first
        call), ``LM.decode_many`` on the CPU."""
        if not self.graphs:
            if num_steps == 0:
                return tok0
            keys = fold_key_grid(self.rows["keys"],
                                 torch.ones_like(self.rows["keys"]),
                                 num_steps)
            _, rest = self.model.decode_many(self.params, self.cache, tok0,
                                             num_steps, sampler=self.sample,
                                             keys=keys)
            return torch.cat([tok0, rest], dim=1)
        self._check_params()
        if self.decode_graph is None:
            self.decode_graph = DecodeGraph(
                self.model, self.params, self.cache, self.max_seq_len,
                self.sample, self.rows["keys"], self.graph_pool)
        return self.decode_graph.run(tok0, num_steps)

    # ------------------------------------------------------------ requests

    def generate(self, requests: Sequence[Request]) -> List[Result]:
        """Serve requests in length-bucketed chunks; request order kept."""
        order = sorted(range(len(requests)),
                       key=lambda i: len(requests[i].prompt))
        results: List[Optional[Result]] = [None] * len(requests)
        for i in range(0, len(order), self.batch_size):
            idxs = order[i: i + self.batch_size]
            out = self._generate_batch([requests[j] for j in idxs])
            for j, res in zip(idxs, out):
                results[j] = res
        return results  # type: ignore[return-value]

    @torch.no_grad()
    def _generate_batch(self, requests: Sequence[Request]) -> List[Result]:
        # the loop runs to THIS chunk's longest request, not a global max
        max_new = max(r.max_new_tokens for r in requests)
        prompts, slot_mask = self.pad_prompts(requests)
        self.set_rows(requests, slot_mask)
        _, logits = self.prefill(prompts)
        tok0 = self.sample(logits, fold_in(self.rows["keys"], 0))
        toks = self.decode(tok0, max_new - 1)
        rows = toks.cpu().tolist()          # one device -> host transfer
        return [Result(uid=r.uid,
                       tokens=trim_at_eos(rows[j][: r.max_new_tokens],
                                          r.eos_id))
                for j, r in enumerate(requests)]
