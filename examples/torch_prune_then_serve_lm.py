"""End to end on the card: prune an assigned-architecture LM, then
SERVE it PACKED (the PyTorch port's counterpart of
``examples/prune_then_serve_lm.py``).

    PYTHONPATH=src python examples/torch_prune_then_serve_lm.py \
        --arch qwen2-1.5b --scheme tile_pattern --rate 2 --requests 8 \
        [--device cpu]

The paper's deployment story on an LM, through the unified artifact API:
the client pre-trains a (reduced) qwen2-style model on her confidential
corpus; the system designer prunes the block GEMMs with ADMM on uniform
random tokens (never seeing the corpus); the client masked-retrains; the
sparse model is packaged as a ``PrunedArtifact``, PACKED through the
scheme→kernel registry (compressed weight storage + index tables), and
served with batched requests — dense and packed serving produce identical
tokens while the packed weights are ~half the bytes at tile-pattern 4-of-8.
On the card the packed GEMMs run the ``pattern_gemm`` (``column_gemm``)
CUDA kernel and the engine decodes through CUDA graphs.

    result   = PrivacyPreservingPruner(adapter, config).run(key, params)
    artifact = result.to_artifact().with_params(retrained).pack()
    engine   = ServeEngine(model, artifact, packed=True, ...)
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import reduced_config
from repro_torch.core import (
    DEFAULT_EXCLUDE,
    LMAdapter,
    PruneConfig,
    PrivacyPreservingPruner,
    as_key,
    compression_rate,
    make_retrain_step,
)
from repro_torch.core.masks import apply_mask
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import Request, ServeEngine


def lm_step(model, opt, masks=None):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    grads (masked) -> AdamW -> (p + u) in p's dtype (-> mask)."""
    step = make_retrain_step(lambda p, batch: model.train_loss(p, batch),
                             lambda loss, _: loss, opt, masks)
    return lambda p, s, batch: step(p, s, (batch, None))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--scheme", default="tile_pattern",
                    choices=["irregular", "filter", "column", "tile_pattern"])
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--prune-iters", type=int, default=12)
    ap.add_argument("--retrain-steps", type=int, default=40)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--artifact-dir", default=None,
                    help="also save the packed artifact here "
                         "(servable via launch/serve.py --artifact)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced_config(args.arch, num_layers=2, d_model=128, d_ff=256,
                         vocab_size=512)
    model = build_model(cfg, device=dev)
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model} "
          f"V={cfg.vocab_size}), scheme={args.scheme} @ {args.rate}x")

    # ---- CLIENT: pre-train on the confidential corpus ----------------------
    pipe = TokenPipeline(DataConfig(seq_len=64, global_batch=16,
                                    vocab_size=cfg.vocab_size, seed=5),
                         device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = adamw(3e-3)
    opt_state = opt.init(params)
    train_step = lm_step(model, opt)
    for step in range(args.train_steps):
        params, opt_state, loss = train_step(params, opt_state,
                                             pipe.batch_at(step))
    print(f"[client] pre-trained: loss={float(loss):.3f}")

    # ---- SYSTEM DESIGNER: prune with uniform random tokens -----------------
    config = PruneConfig(
        scheme=args.scheme, alpha=1.0 / args.rate,
        exclude=tuple(DEFAULT_EXCLUDE),
        iterations=args.prune_iters, batch_size=8, lr=1e-3,
        rho_init=1e-3, rho_every_iters=max(args.prune_iters // 3, 1),
        overrides={".*": {"tile_block_p": 32, "tile_group_q": 8,
                          "tile_keep": max(1, int(8 / args.rate))}}
        if args.scheme == "tile_pattern" else {},
    )
    adapter = LMAdapter(model, seq_len=32)
    t0 = time.perf_counter()
    result = PrivacyPreservingPruner(adapter, config).run(as_key(1), params)
    print(f"[designer] pruned {compression_rate(result.masks):.2f}x in "
          f"{time.perf_counter()-t0:.1f}s — corpus never accessed")

    # ---- CLIENT: masked retraining -----------------------------------------
    params_r = apply_mask(result.params, result.masks)
    opt_state = opt.init(params_r)
    retrain_step = lm_step(model, opt, result.masks)
    for step in range(args.retrain_steps):
        params_r, opt_state, loss = retrain_step(
            params_r, opt_state, pipe.batch_at(1000 + step))
    print(f"[client] retrained: loss={float(loss):.3f}")

    # ---- deploy: pack once, dispatch everywhere ----------------------------
    artifact = (result.to_artifact(arch=args.arch, scheme=args.scheme,
                                   rate=args.rate)
                .with_params(params_r)
                .pack(device=dev))
    s = artifact.summary()
    print(f"[pack] {s['packed_leaves']}/{s['total_leaves']} leaves packed, "
          f"{s['dense_bytes']/1e6:.2f}MB -> {s['packed_bytes']/1e6:.2f}MB "
          f"({s['bytes_ratio']:.2f}x weight bytes)")
    if args.artifact_dir:
        artifact.save(args.artifact_dir)
        print(f"[pack] artifact saved to {args.artifact_dir}")

    gen = torch.Generator().manual_seed(9)
    requests = [
        Request(uid=i,
                prompt=torch.randint(0, cfg.vocab_size, (8 + i,),
                                     generator=gen),
                max_new_tokens=12)
        for i in range(args.requests)
    ]
    results = {}
    for mode, packed in (("dense", False), ("packed", True)):
        engine = ServeEngine(model, artifact, batch_size=args.requests,
                             max_seq_len=128, packed=packed, device=dev)
        t0 = time.perf_counter()
        out = engine.generate(requests)
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.tokens) for r in out)
        print(f"[serve/{mode}] {len(out)} requests, {n_tok} tokens in "
              f"{dt:.2f}s ({n_tok/dt:.1f} tok/s, batch={args.requests})")
        results[mode] = [r.tokens for r in out]
    same = results["dense"] == results["packed"]
    print(f"[serve] packed tokens identical to dense: {same}")
    for uid, toks in enumerate(results["packed"][:3]):
        print(f"  uid={uid} tokens={toks}")


if __name__ == "__main__":
    main()
