"""Self-speculative serving: the pruned packed model drafts, the target
verifies (mirrors ``repro/serve/speculative.py``).

The pruned artifact, bound packed, proposes ``draft_k`` tokens a round;
the target scores all of them in one chunked pass (``LM.verify_chunk``,
its GEMMs at M = B * K) and the engine commits the longest agreeing
prefix, plus the target's correction on a miss. Greedy output is then the
target's own, whatever the drafter proposes.

A round, every batch row at its own ``pos``:

  1. SNAPSHOT both caches' next K rows (``LM.cache_snapshot``);
  2. DRAFT: K drafter ``decode_step``s from the pending token, sampling
     ``d_1 .. d_K`` and inserting ``pending, d_1 .. d_{K-1}``, the rows
     the verify chunk writes on the target side;
  3. VERIFY: ``LM.verify_chunk`` over ``[pending, d_1 .. d_{K-1}]``:
     position j's logits judge ``d_{j+1}``;
  4. ACCEPT: a greedy row takes the longest exact-match prefix ``a`` and
     the target's argmax at position ``a``; a sampled row accepts ``d_i``
     with probability ``min(1, q_i(d_i) / p_i(d_i))`` and draws its first
     rejection from ``norm(max(q - p, 0))``, so its tokens follow the
     target's distribution; on full acceptance ``d_K`` is the pending
     token;
  5. ROLLBACK both caches to ``snapshot pos + min(a + 1, K)``
     (``LM.cache_rollback``, in place), so both hold only committed rows.

Lockstep: after every round ``draft pos == target pos == prompt +
emitted - 1`` per row (the pending token sampled, not yet inserted, as in
``ServeEngine``). On the card a greedy round is one replay of a CUDA graph
(``serve.graphs.SpeculativeRoundGraph``) writing its tokens into column r
of static (B, R, K) blocks: R rounds are R replays and one host transfer,
the counterpart of the reference's on-device scan of R rounds. A sampled
round runs eagerly, one dispatch and one sync. A demoted engine goes on
with the target's own ``ServeEngine.decode`` (its decode graph) from the
same cache.

Sampling keys are the port's splitmix64 streams (``serve/sampler.py``),
not JAX's, so sampled tokens differ from the reference's: row b's draft
steps, its K acceptance uniforms and its residual draw derive from
``fold_in(row key, tokens emitted)``, so a request reproduces across
batch-mates and engines.

Wire-up: ``ServeEngine(model, params, speculative=draft, draft_k=4)``, or
``SpeculativeEngine`` directly. ``shallow_drafter`` builds a truncated
drafter over the same weights.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import ArtifactError
from repro_torch.models.attention import cache_capacity
from repro_torch.models.transformer import LM
from repro_torch.runtime.telemetry import MetricsRegistry, Telemetry
from repro_torch.serve.engine import (
    Request,
    Result,
    ServeEngine,
    _bucketed_generate,
    require_token_input,
)
from repro_torch.serve.graphs import SpeculativeRoundGraph
from repro_torch.serve.sampler import (
    fold_in,
    fold_key_grid,
    greedy_sample,
    temperature_sample,
    uniform_bits,
)
from repro_torch.serve.slots import trim_at_eos
from repro_torch.sparse.artifact import PrunedArtifact

ENG = "speculative"


def shallow_drafter(model: LM, params: Any, num_layers: int
                    ) -> Tuple[LM, Any]:
    """A drafter of the first ``num_layers`` blocks over the SAME weights:
    the block list sliced, embedding, final norm and head shared by
    reference (no copies). An xLSTM's groups do not truncate per layer:
    ``NotImplementedError``, as in the reference."""
    cfg = model.config
    if cfg.family == "ssm":
        raise NotImplementedError("xLSTM groups do not truncate per-layer")
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(f"num_layers must be in [1, {cfg.num_layers}]")
    draft_model = LM(dataclasses.replace(cfg, num_layers=num_layers),
                     device=model.device)
    return draft_model, {**params, "blocks": params["blocks"][:num_layers]}


def _resolve_draft(model: LM, draft: Any) -> Tuple[Any, Optional[str]]:
    """Drafter params -> (params, demote reason). A ``PrunedArtifact`` (or
    ``PruneResult``) binds PACKED; a raw tree serves as it is. A packed
    leaf ``bind`` served dense, or an ``ArtifactError``, is a drafter that
    lost its compression advantage: the reason demotes the engine."""
    from repro_torch.core.pruner import PruneResult

    if isinstance(draft, PruneResult):
        draft = draft.to_artifact()
    if isinstance(draft, PrunedArtifact):
        try:
            bound = draft.bind(model, packed=True)
        except ArtifactError as e:
            return None, f"drafter artifact failed verification: {e}"
        bad = (draft.bind_report or {}).get("fallbacks") or {}
        if bad:
            leaf, why = next(iter(bad.items()))
            return bound, (f"drafter artifact failed verification: "
                           f"{len(bad)} corrupt packed leaf/leaves "
                           f"(e.g. {leaf}: {why})")
        return bound, None
    return draft, None


def accepted_prefix(accept: torch.Tensor) -> torch.Tensor:
    """(B, K) bool -> (B,) length of each row's leading run of True."""
    return torch.cumprod(accept.long(), dim=1).sum(dim=1)


class SpeculativeEngine:
    """Draft/verify serving engine (see the module docstring).

    ``params`` is the TARGET, what the output is certified against: a raw
    tree or a ``PrunedArtifact`` (``packed`` binds its compressed form, as
    ``ServeEngine``). ``draft``: a ``PrunedArtifact`` (bound packed) or a
    raw tree of ``draft_model`` (default ``model``; a ``shallow_drafter``
    pair for a truncated drafter). Greedy requests come out as
    ``ServeEngine`` serving ``params`` alone gives them; ``stats`` holds
    rounds, drafted / accepted counts and ``acceptance_rate`` after each
    ``generate``.

    Degradation: once ``demote_after`` tokens were drafted, an acceptance
    rate below ``demote_below`` DEMOTES the engine, and the rest decodes
    plainly against the target (a disagreeing drafter costs more than
    plain decoding). A drafter artifact that fails verification demotes
    at construction. Demotion never changes output; each is recorded in
    ``stats["demotions"]``. ``straggler``: a ``runtime.StragglerMonitor``
    fed each dispatch's wall time. ``telemetry``: ``spec_dispatch`` spans
    and ``retire`` events into its tracer, the ``spec.*`` counters and
    ``serve.ttft_seconds`` / ``serve.tpot_seconds{engine="speculative"}``
    into its registry; ``stats`` is a view over the counters. Recording
    happens at host syncs only, so tokens are the same with it on or off.
    ``target_engine``: a ``ServeEngine`` of ``model`` whose params, cache,
    row buffers and graphs serve the target (``ServeEngine(speculative=
    ...)`` passes itself); by default one is built.
    """

    def __init__(self, model: LM, params: Any, draft: Any, *,
                 batch_size: int, max_seq_len: int, draft_k: int = 4,
                 draft_model: Optional[LM] = None, packed: bool = False,
                 seed: int = 0, demote_after: int = 64,
                 demote_below: float = 0.15,
                 straggler: Optional[Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 target_engine: Optional[ServeEngine] = None,
                 device=None):
        if draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        self.model = model
        self.draft_model = draft_model if draft_model is not None else model
        for m, who in ((model, "target"), (self.draft_model, "drafter")):
            require_token_input(m, f"SpeculativeEngine ({who})")
            m._require_kv_family(f"speculative serving ({who})")
        if self.draft_model.config.vocab_size != model.config.vocab_size:
            raise ValueError("drafter and target must share a vocabulary")
        # each cache as its prefill builds it; a ring must hold a round's
        # K-token verify chunk
        self._specs = [(cache_capacity(max_seq_len, m.config.sliding_window),
                        who)
                       for m, who in ((model, "target"),
                                      (self.draft_model, "draft"))]
        for spec, who in self._specs:
            if spec.ring and draft_k > spec.capacity:
                raise ValueError(
                    f"draft_k={draft_k} needs a {draft_k}-token verify "
                    f"chunk, larger than the {who} ring cache's window "
                    f"{spec.capacity}")
        self.target = target_engine or ServeEngine(
            model, params, batch_size=batch_size, max_seq_len=max_seq_len,
            packed=packed, seed=seed, device=device)
        self.params, self.bind_report = (self.target.params,
                                         self.target.bind_report)
        self.draft_params, demote_reason = _resolve_draft(self.draft_model,
                                                          draft)
        self.demote_after = demote_after
        self.demote_below = demote_below
        self.straggler = straggler
        self.telemetry = telemetry
        self.demoted = demote_reason is not None
        self._demotions: List[Dict[str, Any]] = []
        if demote_reason is not None:
            self._demotions.append({"at": "init", "reason": demote_reason})
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.draft_k = draft_k
        self.device = self.target.device
        self.graphs = self.target.graphs
        self.stats: Dict[str, Any] = {}
        # engine clock for deadlines; ``generate`` re-anchors it
        self._now = lambda: 0.0
        # the drafter's cache, prefill graphs and row buffers: a second
        # buffer set in the target's graph pool; never built for a
        # drafter demoted at construction (it never drafts)
        self.drafter = None
        if not self.demoted:
            self.drafter = ServeEngine(
                self.draft_model, self.draft_params, batch_size=batch_size,
                max_seq_len=max_seq_len, seed=seed,
                graph_pool=self.target.graph_pool, device=self.device)
        # a round's static buffers: the pending token and slot mask are
        # the target's rows; column r of the blocks holds round r
        B, dev = batch_size, self.device
        width = 1 << (max(1, math.ceil(max_seq_len / draft_k)) - 1
                      ).bit_length()
        rows = self.target.rows
        self.bufs = {
            "token": rows["token"], "mask": rows["mask"],
            "out": torch.zeros((B, width, draft_k), dtype=torch.int64,
                               device=dev),
            "keep": torch.zeros((B, width), dtype=torch.int64, device=dev),
            "acc": torch.zeros((B, width), dtype=torch.int64, device=dev),
            "col": torch.zeros((), dtype=torch.int64, device=dev)}
        self.round_graph: Optional[SpeculativeRoundGraph] = None

    # ---- one round (device ops only: a CUDA graph captures it) -------------

    def _draft_and_verify(self, tcache, dcache, tok, step_keys=None,
                          temps=None):
        """Snapshot both caches, draft K, verify K -> (t_snap, d_snap,
        drafts (B, K), draft logits (B, K, V) or None, target logits
        (B, K, V)). Greedy drafts without ``step_keys``."""
        K = self.draft_k
        d_snap = self.draft_model.cache_snapshot(dcache, K)
        t_snap = self.model.cache_snapshot(tcache, K)
        dp = self.drafter.params
        dlogits = None
        if step_keys is None:
            _, drafts = self.draft_model.decode_many(dp, dcache, tok, K)
        else:
            toks, logits = [], []
            t = tok
            for j in range(K):
                _, lg = self.draft_model.decode_step(dp, dcache, t)
                t = temperature_sample(lg, step_keys[j], temps)
                toks.append(t)
                logits.append(lg[:, 0])
            drafts, dlogits = torch.cat(toks, dim=1), torch.stack(logits, 1)
        chunk = torch.cat([tok, drafts[:, :-1]], dim=1)
        _, tlogits = self.model.verify_chunk(self.params, tcache, chunk)
        return t_snap, d_snap, drafts, dlogits, tlogits

    def _commit(self, tcache, dcache, t_snap, d_snap, a, drafts, corr,
                bufs) -> None:
        """Accepted prefix ``a`` (B,) -> roll both caches back, write the
        round's (B, K) tokens, ``keep`` and ``a`` into column ``col`` of
        the blocks and the next pending token into ``token``. A fully
        accepting row commits all K drafts and ``d_K`` is pending."""
        K = self.draft_k
        keep = torch.clamp(a + 1, max=K)
        self.draft_model.cache_rollback(dcache, d_snap, keep)
        self.model.cache_rollback(tcache, t_snap, keep)
        mask = bufs["mask"]
        idx = torch.arange(K, device=a.device)[None, :]
        out = torch.where(idx < a[:, None], drafts,
                          torch.where(idx == a[:, None], corr[:, None],
                                      torch.zeros_like(drafts)))
        new_tok = torch.where(a[:, None] == K, drafts[:, -1:], corr[:, None])
        col = bufs["col"].view(1)
        bufs["token"].copy_(new_tok * mask[:, None])
        bufs["out"].index_copy_(1, col, (out * mask[:, None])[:, None])
        bufs["keep"].index_copy_(1, col, (keep * mask)[:, None])
        bufs["acc"].index_copy_(1, col, (a * mask)[:, None])
        bufs["col"].add_(1)

    def _greedy_round(self, tcache, dcache, bufs) -> None:
        """One greedy round from ``bufs["token"]``, written into column
        ``bufs["col"]``."""
        K = self.draft_k
        t_snap, d_snap, drafts, _, tlogits = self._draft_and_verify(
            tcache, dcache, bufs["token"])
        tgt = greedy_sample(tlogits)                      # (B, K) argmax
        a = accepted_prefix(drafts == tgt)
        corr = tgt.gather(1, a.clamp(max=K - 1)[:, None])[:, 0]
        self._commit(tcache, dcache, t_snap, d_snap, a, drafts, corr, bufs)

    def _stoch_round(self, ctrs: torch.Tensor) -> None:
        """One sampled round (eager) into column 0 of the blocks: per-token
        rejection sampling against softmax(target / T); greedy rows
        (T <= 0) take the exact-match rule in the same pass. Row b's keys
        derive from ``fold_in(row key, ctrs[b])``, its tokens emitted."""
        K = self.draft_k
        rows, bufs = self.target.rows, self.bufs
        temps = rows["temps"]
        rk = fold_in(rows["keys"], ctrs)
        k_draft, k_u, k_res = (fold_in(rk, i) for i in range(3))
        step_keys = fold_key_grid(k_draft, torch.zeros_like(ctrs), K)
        t_snap, d_snap, drafts, dlogits, tlogits = self._draft_and_verify(
            self.target.cache, self.drafter.cache, bufs["token"], step_keys,
            temps)
        stoch = temps > 0.0
        tsafe = temps.clamp(min=1e-6)[:, None, None]
        p = torch.softmax(dlogits.to(torch.float32) / tsafe, dim=-1)
        q = torch.softmax(tlogits.to(torch.float32) / tsafe, dim=-1)
        pd = p.gather(-1, drafts[..., None])[..., 0]
        qd = q.gather(-1, drafts[..., None])[..., 0]
        u = uniform_bits(k_u, K)                          # (B, K)
        tgt = greedy_sample(tlogits)
        # u < min(1, q / p)  <=>  u * p < q (p > 0 wherever d was drawn)
        accept = torch.where(stoch[:, None], u * pd < qd, drafts == tgt)
        a = accepted_prefix(accept)
        a_c = a.clamp(max=K - 1)[:, None]
        V = q.shape[-1]
        at = a_c[..., None].expand(-1, 1, V)
        # the residual at the first rejection (computed, unused, for a
        # fully accepting row, whose pending token is d_K)
        resid = torch.clamp(q.gather(1, at)[:, 0] - p.gather(1, at)[:, 0],
                            min=0.0)
        resid = resid / resid.sum(-1, keepdim=True).clamp(min=1e-30)
        stoch_tok = temperature_sample(torch.log(resid + 1e-38)[:, None],
                                       k_res, 1.0)[:, 0]
        corr = torch.where(stoch, stoch_tok, tgt.gather(1, a_c)[:, 0])
        bufs["col"].zero_()
        self._commit(self.target.cache, self.drafter.cache, t_snap, d_snap,
                     a, drafts, corr, bufs)

    @torch.no_grad()
    def greedy_rounds(self, R: int):
        """R greedy rounds -> views (out (B, R, K), keep (B, R), a (B, R))
        of the blocks: R replays of the round graph on the card (captured
        at the first call), R eager rounds on the CPU."""
        if R > self.bufs["keep"].shape[1]:
            raise ValueError(f"{R} rounds exceed the round blocks' "
                             f"{self.bufs['keep'].shape[1]} columns")
        tcache, dcache = self.target.cache, self.drafter.cache
        if self.graphs:
            if self.round_graph is None:
                self.target._check_params()
                self.round_graph = SpeculativeRoundGraph(
                    self._greedy_round, (self.model, self.draft_model),
                    (tcache, dcache), self.bufs, self.target.graph_pool)
            self.round_graph.run(R)
        else:
            self.bufs["col"].zero_()
            for _ in range(R):
                self._greedy_round(tcache, dcache, self.bufs)
        b = self.bufs
        return b["out"][:, :R], b["keep"][:, :R], b["acc"][:, :R]

    # ---- host loop ---------------------------------------------------------

    def generate(self, requests: List[Request], *,
                 clock: Optional[Any] = None) -> List[Result]:
        """Serve requests in prompt-length-bucketed chunks, exactly as
        ``ServeEngine.generate`` (the same chunking and left-pad prefill,
        so greedy output matches it); results in request order.

        ``clock``: elapsed-seconds callable for ``Request.deadline``
        (default: the wall clock anchored here). Deadlines and cancels
        are honored between dispatches: such a row stops drafting and
        comes back with its partial tokens and a typed status."""
        t0 = time.perf_counter()
        self._now = clock if clock is not None \
            else (lambda: time.perf_counter() - t0)
        tel = self.telemetry
        if tel is not None and tel.tracer is not None:
            tel.tracer.clock = self._now
        reg = tel.metrics if tel is not None else MetricsRegistry()
        ctrs = {k: reg.counter(f"spec.{k}_total", engine=ENG)
                for k in ("rounds", "dispatches", "drafted", "accepted")}
        base = {k: c.value for k, c in ctrs.items()}
        demo0 = len(self._demotions)
        self.stats = {"rounds": 0, "dispatches": 0, "drafted": 0,
                      "accepted": 0, "demoted": self.demoted,
                      "demotions": list(self._demotions)}
        with torch.no_grad():
            results = _bucketed_generate(requests, self.batch_size,
                                         self._generate_batch)
        # the run's tallies go into the registry and ``stats`` is read
        # back out of it: per-run deltas of the counters
        for k, c in ctrs.items():
            c.inc(self.stats[k])
        reg.counter("spec.demotions_total", engine=ENG).inc(
            len(self._demotions) - demo0)
        for res in results:
            reg.counter("serve.requests_total", engine=ENG,
                        status=res.status).inc()
        for k, c in ctrs.items():
            self.stats[k] = int(c.value - base[k])
        drafted = self.stats["drafted"]
        self.stats["acceptance_rate"] = (
            self.stats["accepted"] / drafted if drafted else 0.0)
        reg.gauge("spec.acceptance_rate", engine=ENG).set(
            self.stats["acceptance_rate"])
        self.stats["demoted"] = self.demoted
        self.stats["demotions"] = list(self._demotions)
        if self.straggler is not None:
            self.stats["straggler_events"] = len(self.straggler.events)
        if tel is not None and tel.tracer is not None:
            for res in results:
                tel.tracer.event("retire", engine=ENG, uid=res.uid,
                                 status=res.status, tokens=len(res.tokens))
            tel.tracer.flush()
        return results

    def _validate(self, requests: List[Request]) -> None:
        """Per-chunk capacity of each full cache: prefill left-pads the
        chunk to its longest prompt and every row decodes from there, and
        the last round a row needs writes K rows from at most ``S_pad +
        max_new - 2``. Rounds past a row's budget may overflow (dropped
        writes, discarded tokens). A ring cache takes any length."""
        K = self.draft_k
        s_pad = max(len(r.prompt) for r in requests)
        for r in requests:
            need = s_pad + r.max_new_tokens + K
            for spec, who in self._specs:
                if not spec.ring and need > spec.capacity:
                    raise ValueError(
                        f"request uid={r.uid}: padded prompt {s_pad} + "
                        f"max_new_tokens {r.max_new_tokens} + draft_k {K} "
                        f"exceeds {who} cache capacity {spec.capacity}: "
                        f"raise max_seq_len")

    def _record_dispatch(self, t_disp: float, **fields) -> None:
        """A dispatch's wall into the straggler monitor and the trace."""
        tel = self.telemetry
        tracer = tel.tracer if tel is not None else None
        self.stats["dispatches"] += 1
        dt = max(self._now() - t_disp, 0.0)
        if self.straggler is not None:
            ev = self.straggler.record(self.stats["dispatches"], dt)
            if ev is not None and tracer is not None:
                tracer.event("straggler", ts=self._now(), engine=ENG,
                             step=ev.step, seconds=ev.seconds,
                             median=ev.median, deviation=ev.deviation)
        if tracer is not None:
            tracer.span_record("spec_dispatch", ts=t_disp, dur=dt,
                               engine=ENG, **fields)

    @torch.no_grad()
    def prefill_chunk(self, requests: List[Request]) -> None:
        """Prefill a chunk into both caches (the drafter's unless demoted)
        and sample each row's first token into the pending-token row."""
        tgt = self.target
        prompts, slot_mask = tgt.pad_prompts(requests)
        tgt.set_rows(requests, slot_mask)
        _, tlogits = tgt.prefill(prompts)
        # a drafter demoted at construction never costs a prefill
        if not self.demoted:
            self.drafter.prefill(prompts)
        rows = tgt.rows
        rows["token"].copy_(tgt.sample(tlogits, fold_in(rows["keys"], 0)))

    def _generate_batch(self, requests: List[Request]) -> List[Result]:
        self._validate(requests)
        tel = self.telemetry
        tracer = tel.tracer if tel is not None else None
        t_b0 = self._now()
        B, K, n = self.batch_size, self.draft_k, len(requests)
        tgt = self.target
        rows = tgt.rows
        self.prefill_chunk(requests)
        use_temp = any(r.temperature is not None and r.temperature > 0
                       for r in requests)
        budgets = [r.max_new_tokens for r in requests]
        statuses = ["ok"] * n
        emitted: List[List[int]] = [[t] for t in
                                    rows["token"][:n, 0].tolist()]
        # the batch's first host sync: every row's first token is here
        t_first = self._now()
        if tel is not None:
            h_ttft = tel.metrics.histogram("serve.ttft_seconds", engine=ENG)
            for _ in range(n):
                h_ttft.observe(t_first - t_b0)
            if tracer is not None:
                tracer.span_record("prefill", ts=t_b0, dur=t_first - t_b0,
                                   engine=ENG, active=n, batch=B)
        while True:
            # an expired or cancelled row stops now (its budget clamps to
            # what it has); batch-mates go on: rows are independent
            tnow = self._now()
            for b, r in enumerate(requests):
                if statuses[b] != "ok" or len(emitted[b]) >= budgets[b]:
                    continue
                if getattr(r, "cancelled", False):
                    statuses[b] = "cancelled"
                    budgets[b] = len(emitted[b])
                elif r.deadline is not None and tnow > r.deadline:
                    statuses[b] = "timeout"
                    budgets[b] = len(emitted[b])
            rem = max((budgets[b] - len(emitted[b]) for b in range(n)),
                      default=0)
            if rem <= 0:
                break
            offs = torch.tensor([len(e) for e in emitted] + [1] * (B - n),
                                dtype=torch.int64)
            t_disp = self._now()
            if self.demoted:
                # the target's own decode from the same cache, pending
                # token and key streams: as if it never speculated
                toks = tgt.decode(rows["token"].clone(), rem,
                                  index=offs.to(self.device))[:, 1:]
                rows["token"].copy_(toks[:, -1:])
                toks_np = toks.cpu().numpy()
                self._record_dispatch(t_disp, demoted=True, steps=int(rem))
                for b in range(n):
                    short = budgets[b] - len(emitted[b])
                    if short > 0:
                        emitted[b].extend(int(t) for t in toks_np[b, :short])
                continue
            if use_temp:
                self._stoch_round(offs.to(self.device))
                R = 1
                out, keep, acc = (self.bufs["out"][:, :1],
                                  self.bufs["keep"][:, :1],
                                  self.bufs["acc"][:, :1])
            else:
                # R bucketed to a power of two, as the reference's scan
                # (overshoot rounds: capacity covers every committed
                # token, and a finished row's overflow is dropped below)
                R = 1 << max(0, math.ceil(rem / K) - 1).bit_length()
                out, keep, acc = self.greedy_rounds(R)
            host = torch.cat([out.reshape(B, R * K), keep, acc],
                             dim=1).cpu().numpy()      # one transfer
            outs = host[:, :R * K].reshape(B, R, K)
            keeps, accs = host[:, R * K:R * K + R], host[:, R * K + R:]
            self._record_dispatch(t_disp, demoted=False, rounds=R)
            for r in range(R):
                self.stats["rounds"] += 1
                for b in range(n):
                    short = budgets[b] - len(emitted[b])
                    if short <= 0:
                        continue          # an overflow round: dropped
                    self.stats["drafted"] += K
                    self.stats["accepted"] += int(accs[b, r])
                    take = min(short, int(keeps[b, r]))
                    emitted[b].extend(int(t) for t in outs[b, r, :take])
            # acceptance collapse: every round would cost drafter + verify
            # for about one token, worse than plain decoding; the demoted
            # branch finishes this chunk and all later ones
            drafted = self.stats["drafted"]
            if not self.demoted and drafted >= self.demote_after:
                rate = self.stats["accepted"] / drafted
                if rate < self.demote_below:
                    self.demoted = True
                    self._demotions.append({
                        "at": "acceptance", "drafted": drafted,
                        "acceptance_rate": rate,
                        "threshold": self.demote_below})

        results = [Result(uid=r.uid,
                          tokens=trim_at_eos(emitted[b][: r.max_new_tokens],
                                             r.eos_id),
                          status=statuses[b])
                   for b, r in enumerate(requests)]
        if tel is not None:
            t_done = self._now()
            h_tpot = tel.metrics.histogram("serve.tpot_seconds", engine=ENG)
            for res in results:
                if len(res.tokens) > 1:
                    h_tpot.observe((t_done - t_first)
                                   / (len(res.tokens) - 1))
        return results
