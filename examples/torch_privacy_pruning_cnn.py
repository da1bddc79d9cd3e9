"""End to end on the card: the paper's complete workflow, all four
schemes (the PyTorch port's counterpart of
``examples/privacy_pruning_cnn.py``).

    PYTHONPATH=src python examples/torch_privacy_pruning_cnn.py \
        --network resnet18 --scheme pattern --rate 8 --iters 120 \
        [--device cpu]

Compares three pruning paths at the chosen (scheme, rate):
    privacy-preserving ADMM  (the paper: synthetic data only)
    traditional ADMM†        (baseline: needs the real dataset)
    greedy one-shot          (baseline: "Uniform" in Table V)
then masked-retrains each on the client's confidential data and prints a
Table-I-style comparison row for each method — including the measured
membership-inference AUC (``repro_torch.privacy``): how well an attacker
thresholding the true-class posterior can tell the retraining batches
from fresh draws. 0.5 is chance; higher means more leakage.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    DEFAULT_EXCLUDE,
    PruneConfig,
    PrivacyPreservingPruner,
    admm_task_prune,
    as_key,
    compression_rate,
    cross_entropy,
    greedy_prune,
    make_retrain_step,
)
from repro_torch.core.retrain import retrain
from repro_torch.data import ClassificationPipeline, DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.cnn import resnet18, vgg16
from repro_torch.optim import adamw
from repro_torch.privacy import confidence_attack, posterior_features


def build(network: str, device):
    if network == "vgg16":
        return vgg16(10, width_mult=0.125, image_hwc=(16, 16, 3),
                     device=device)
    if network == "resnet18":
        return resnet18(10, width_mult=0.125, image_hwc=(16, 16, 3),
                        device=device)
    raise SystemExit(f"unknown network {network}")


@torch.no_grad()
def accuracy(model, params, pipe, batches=4):
    hits = total = 0
    for i in range(batches):
        x, y = pipe.batch_at(90_000 + i)
        hits += int((model.apply(params, x).argmax(-1) == y).sum())
        total += int(y.shape[0])
    return hits / total


@torch.no_grad()
def mia_auc(model, params, pipe, member_steps, batches=4):
    """Confidence-threshold MIA AUC: member (training) batches vs fresh
    draws from the same distribution at far-away step indices."""

    def feats(steps):
        fs = [posterior_features(model.apply(params, pipe.batch_at(s)[0]),
                                 pipe.batch_at(s)[1]) for s in steps]
        return np.concatenate(fs, axis=0)

    member = feats(list(member_steps)[:batches])
    nonmember = feats([50_000_000 + i for i in range(batches)])
    return confidence_attack(member, nonmember, n_boot=50).auc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="resnet18",
                    choices=["resnet18", "vgg16"])
    ap.add_argument("--scheme", default="pattern",
                    choices=["irregular", "filter", "column", "pattern"])
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--teacher-steps", type=int, default=400)
    ap.add_argument("--retrain-steps", type=int, default=500)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    model = build(args.network, dev)
    pipe = ClassificationPipeline(
        DataConfig(num_classes=10, global_batch=64, image_hwc=(16, 16, 3),
                   seed=11), device=dev)

    # ---- client trains the teacher -----------------------------------------
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = adamw(3e-3)
    opt_state = opt.init(params)
    # the unmasked step: grads -> AdamW -> (p + u) in p's dtype
    train_step = make_retrain_step(model.apply, cross_entropy, opt, None)

    it = iter(pipe)
    for _ in range(args.teacher_steps):
        params, opt_state, _ = train_step(params, opt_state, next(it))
    base = accuracy(model, params, pipe)
    print(f"pre-trained {args.network}: accuracy {base:.3f}")

    config = PruneConfig(
        scheme=args.scheme, alpha=1.0 / args.rate,
        exclude=tuple(DEFAULT_EXCLUDE) + (r".*head.*",),
        iterations=args.iters, batch_size=32, lr=1e-3,
        rho_every_iters=max(args.iters // 3, 1),
    )

    # ---- three pruning paths ------------------------------------------------
    jobs = {}
    t0 = time.perf_counter()
    jobs["privacy_preserving"] = PrivacyPreservingPruner(model, config).run(
        as_key(1), params)
    print(f"privacy-preserving ADMM pruning: {time.perf_counter()-t0:.1f}s "
          f"(synthetic data only — the client's dataset was never touched)")

    t0 = time.perf_counter()
    jobs["admm_traditional"] = admm_task_prune(
        as_key(1), params, model.apply, iter(pipe), config)
    print(f"traditional ADMM† pruning:       {time.perf_counter()-t0:.1f}s "
          f"(required the real dataset)")

    jobs["greedy_uniform"] = greedy_prune(params, config, device=dev)
    print("greedy one-shot pruning:         0.0s (magnitude only)")

    # ---- client retrains each with its mask --------------------------------
    # MIA members: the early-step batches the teacher + retraining consumed
    member_steps = range(4)
    hdr = (f"{'method':>20s} | {'rate':>6s} | {'base':>6s} | "
           f"{'pruned':>6s} | {'loss':>6s} | {'mia_auc':>7s}")
    print("\n" + hdr + "\n" + "-" * len(hdr))
    dense_mia = mia_auc(model, params, pipe, member_steps)
    print(f"{'dense_teacher':>20s} | {1.0:>5.1f}x | {base:>6.3f} | "
          f"{base:>6.3f} | {0.0:>+6.3f} | {dense_mia:>7.3f}")
    for name, result in jobs.items():
        retrained, _ = retrain(
            result.params, result.masks, model.apply, cross_entropy,
            adamw(2e-3), iter(pipe), steps=args.retrain_steps,
        )
        acc = accuracy(model, retrained, pipe)
        m = mia_auc(model, retrained, pipe, member_steps)
        print(f"{name:>20s} | {compression_rate(result.masks):>5.1f}x | "
              f"{base:>6.3f} | {acc:>6.3f} | {base-acc:>+6.3f} | "
              f"{m:>7.3f}")


if __name__ == "__main__":
    main()
