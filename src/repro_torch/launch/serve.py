"""Serving launcher: batched generation with a (pruned) LM, on the card
(mirrors ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --requests 8 --max-new 16 [--ckpt /tmp/pruned/pruned]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --artifact /tmp/qwen2_artifact --packed [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --reduced --speculative /tmp/qwen2_artifact --draft-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b --reduced --artifact /tmp/danube_artifact \
        --packed --prompt-len 40     # a ring of 32: the prompt wraps it

Loads a raw checkpoint (``--ckpt``: params in the reference's stacked
layout, as ``repro.launch.prune`` writes them) or a saved
``PrunedArtifact`` (``--artifact``, saved by either package) and serves
random-prompt requests through the chunked ``ServeEngine``: on the card
each decode step replays a CUDA graph and each prompt length prefills
through its own graph. ``--packed`` (artifact only) serves the compressed
weights through the packed kernels. ``--temperature`` samples every
request at that temperature, row keys drawn from ``--seed``. Without
``--ckpt`` or ``--artifact`` the weights are random, from seed 0.

``--metrics-out PATH`` writes a metrics snapshot of the process-wide
registry after the run (Prometheus text for ``.prom`` / ``.txt``, JSON
otherwise): the serve series beside the packed-kernel dispatch counts
(``sparse.dispatch_total``, ``sparse.plan_build_total``) and the plan
searches' timings (``tune.search_seconds``, ``tune.candidates_total``:
first-dispatch searches under ``REPRO_AUTOTUNE=1``); ``--trace-out PATH`` appends the engine's trace events (JSONL:
one ``decode_chunk`` span per chunk, one ``retire`` event per request),
which ``runtime.trace_analysis`` reads.

``--speculative DIR`` serves speculatively: the artifact saved in DIR,
bound packed, drafts ``--draft-k`` tokens a round and the served weights
(``--ckpt``/``--artifact``, else random) verify them in one chunked pass
(``serve/speculative.py``); greedy tokens are those of serving without
it, and the acceptance numbers print after the run.

``main(argv)`` returns the results, so it can be driven in process.
The continuous engine has no launcher flag (nor has the reference's):
its entry points are ``ContinuousEngine.generate`` and ``stream``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models import LM, attention
from repro_torch.runtime import telemetry_export
from repro_torch.runtime.telemetry import Telemetry, get_registry
from repro_torch.serve.engine import Request, Result, ServeEngine
from repro_torch.sparse.artifact import PrunedArtifact


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="raw params checkpoint (reference stacked layout)")
    ap.add_argument("--artifact", default=None,
                    help="saved PrunedArtifact directory")
    ap.add_argument("--packed", action="store_true",
                    help="serve the packed representation (needs --artifact)")
    ap.add_argument("--speculative", default=None, metavar="DRAFT_ARTIFACT",
                    help="saved PrunedArtifact directory to draft with "
                         "(bound packed); the served weights verify")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=None,
                    help="sample every request at this temperature "
                         "(default: greedy)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engine's seed for the requests' row keys")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics snapshot after the run: "
                         "Prometheus text if PATH ends in .prom/.txt, JSON "
                         "otherwise. Includes kernel dispatch counts and "
                         "autotune timings (the process-wide registry), "
                         "not just serve latency")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="append the engine's trace events (JSONL spans "
                         "and per-request retire events) to PATH")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def load_params(cfg: ModelConfig, model: LM, *,
                artifact: Optional[str] = None, ckpt: Optional[str] = None,
                device: DeviceLike = None) -> Any:
    """What the engine serves: a loaded ``PrunedArtifact``, a restored
    checkpoint, or random weights from seed 0."""
    dev = resolve_device(device)
    if artifact and ckpt:
        raise SystemExit("--artifact and --ckpt are mutually exclusive: the "
                         "artifact already carries its weights")
    if artifact:
        return PrunedArtifact.load(artifact, cfg=cfg, device=dev)
    if ckpt:
        return params_from_jax(load_pytree(ckpt, device="cpu"), cfg, dev)
    return model.init(torch.Generator(dev).manual_seed(0))


def make_engine(model: LM, params: Any, *, batch: int, max_seq: int,
                packed: bool, seed: int = 0,
                telemetry: Optional[Telemetry] = None,
                speculative: Optional[Any] = None, draft_k: int = 4,
                device: DeviceLike = None) -> ServeEngine:
    """The launcher's engine: CUDA graphs for decode and prefill (and the
    speculative round with a drafter) on the card, eager on the CPU."""
    return ServeEngine(model, params, batch_size=batch, max_seq_len=max_seq,
                       packed=packed, seed=seed, telemetry=telemetry,
                       speculative=speculative, draft_k=draft_k,
                       device=device)


def make_requests(n: int, prompt_len: int, max_new: int, vocab: int,
                  temperature: Optional[float] = None) -> List[Request]:
    """``n`` requests of random prompts (token ids from a CPU generator
    seeded 7)."""
    g = torch.Generator().manual_seed(7)
    return [Request(uid=i, prompt=torch.randint(0, vocab, (prompt_len,),
                                                generator=g),
                    max_new_tokens=max_new, temperature=temperature)
            for i in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> List[Result]:
    args = parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only; no decode serving")
    if cfg.input_kind != "tokens":
        raise SystemExit(
            f"{args.arch} takes {cfg.input_kind} from a stub front end; "
            "decode serving feeds sampled token ids back, so it is served "
            "at the LM level (LM.prefill / LM.decode_step on embeddings)")
    if args.packed and not args.artifact:
        raise SystemExit("--packed requires --artifact")
    dev = resolve_device(args.device)
    model = LM(cfg, device=dev)
    params = load_params(cfg, model, artifact=args.artifact, ckpt=args.ckpt,
                         device=dev)
    if isinstance(params, PrunedArtifact):
        print(f"loaded artifact {args.artifact}: {params.summary()}")
    draft = None
    if args.speculative:
        draft = PrunedArtifact.load(args.speculative, cfg=cfg, device=dev)
        print(f"loaded draft artifact {args.speculative}: {draft.summary()}")
    telemetry = None
    if args.metrics_out or args.trace_out:
        # the process-wide registry: the snapshot holds whatever else the
        # process recorded beside the serve series
        telemetry = Telemetry(metrics=get_registry(),
                              trace_path=args.trace_out)
    engine = make_engine(model, params, batch=args.batch,
                         max_seq=args.max_seq, packed=args.packed,
                         seed=args.seed, telemetry=telemetry,
                         speculative=draft, draft_k=args.draft_k, device=dev)
    reqs = make_requests(args.requests, args.prompt_len, args.max_new,
                         cfg.vocab_size, args.temperature)
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in results)
    mode = "packed" if args.packed else "dense"
    if args.speculative:
        mode += f"+speculative(k={args.draft_k})"
    print(f"{len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s, batch={args.batch}, {mode}, {dev})")
    if args.speculative:
        st = engine.speculative.stats
        print(f"  speculative: {st['rounds']} rounds, {st['drafted']} "
              f"drafted, {st['accepted']} accepted, acceptance "
              f"{st['acceptance_rate']:.3f}, demotions "
              f"{len(st['demotions'])}")
    # flash launches by route; blockwise: prefills of a shape the kernel
    # does not take
    print("prefill attention " + json.dumps(
        {"flash": flash_attention.ROUTE_LAUNCHES,
         "blockwise_fallbacks": attention.PREFILL_FALLBACKS}))
    for r in results[:4]:
        print(f"  uid={r.uid}: {r.tokens[:12]}"
              f"{'...' if len(r.tokens) > 12 else ''}")
    if telemetry is not None:
        telemetry.close()
        if args.metrics_out:
            if args.metrics_out.endswith((".prom", ".txt")):
                telemetry_export.write_prometheus(args.metrics_out,
                                                  telemetry.metrics)
            else:
                telemetry_export.write_json(args.metrics_out,
                                            telemetry.metrics,
                                            arch=args.arch, mode=mode)
            print(f"metrics snapshot -> {args.metrics_out}")
        if args.trace_out:
            print(f"trace -> {args.trace_out}")
    return results


if __name__ == "__main__":
    main()
