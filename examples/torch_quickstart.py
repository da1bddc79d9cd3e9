"""Quickstart on the card: the paper's privacy-preserving pruning loop in
the PyTorch port (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Roles (paper Fig. 2b):
  CLIENT         owns a confidential dataset + a pre-trained model.
  SYSTEM DESIGNER prunes the model WITHOUT the dataset — only randomly
                 generated synthetic inputs — and hands back a
                 ``PrunedArtifact`` (pruned model + mask function).
  CLIENT         retrains with the mask; the discovered sparse architecture
                 is preserved exactly.
  DEPLOYMENT     ``artifact.pack()`` compresses the retrained weights
                 through the scheme→kernel registry (compressed weight
                 storage; 4-of-9 taps → ~2.25x fewer conv weight bytes)
                 and the packed model predicts identically, its convs on
                 the ``pattern_conv`` CUDA kernel.

Scheme note: ``pattern_shared`` is the deployment composition of the
paper's pattern pruning — channel-shared 4-of-9 library patterns (+
connectivity), the structure the pattern-conv kernel packs losslessly.
"""

import argparse

import torch

from repro_torch.core import (
    PruneConfig,
    PrivacyPreservingPruner,
    as_key,
    compression_rate,
    cross_entropy,
    make_retrain_step,
)
from repro_torch.core.retrain import retrain
from repro_torch.data import ClassificationPipeline, DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.cnn import vgg16
from repro_torch.optim import adamw

TEACHER_STEPS = 300       # the client's pre-training
PRUNE_ITERS = 60          # the designer's ADMM iterations
RETRAIN_STEPS = 400       # the client's masked retraining


@torch.no_grad()
def accuracy(model, params, pipe, batches=3):
    hits = total = 0
    for i in range(batches):
        x, y = pipe.batch_at(50_000 + i)
        hits += int((model.apply(params, x).argmax(-1) == y).sum())
        total += int(y.shape[0])
    return hits / total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # fp32 stays fp32 on the card (cuDNN would run the dense convs in TF32),
    # so the dense and the packed model compute the same function
    torch.backends.cudnn.allow_tf32 = False

    # ---- CLIENT: confidential data + pre-trained model --------------------
    model = vgg16(num_classes=10, width_mult=0.125, image_hwc=(16, 16, 3),
                  device=dev)
    confidential = ClassificationPipeline(
        DataConfig(num_classes=10, global_batch=64, image_hwc=(16, 16, 3),
                   seed=7), device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = adamw(3e-3)
    opt_state = opt.init(params)
    # the unmasked step: grads -> AdamW -> (p + u) in p's dtype
    train_step = make_retrain_step(model.apply, cross_entropy, opt, None)

    it = iter(confidential)
    for step in range(TEACHER_STEPS):
        params, opt_state, loss = train_step(params, opt_state, next(it))
    print(f"[client] pre-trained model accuracy: "
          f"{accuracy(model, params, confidential):.3f}")

    # ---- SYSTEM DESIGNER: prune with synthetic data ONLY -------------------
    config = PruneConfig(
        scheme="pattern_shared",      # channel-shared 4-of-9 + connectivity
        alpha=1 / 4,                  # 4x on the width-0.125 demo net
        exclude=tuple(PruneConfig().exclude) + (r".*head.*",),
        iterations=PRUNE_ITERS, batch_size=32, lr=1e-3, rho_init=1e-4,
        rho_every_iters=20,
    )
    pruner = PrivacyPreservingPruner(model, config)
    result = pruner.run(as_key(1), params)               # no dataset in sight
    print(f"[designer] pruned at {compression_rate(result.masks):.1f}x "
          f"compression (scheme={config.scheme}); accuracy before retrain: "
          f"{accuracy(model, result.params, confidential):.3f}")

    # ---- CLIENT: masked retraining on the confidential data ----------------
    retrained, _ = retrain(
        result.params, result.masks, model.apply, cross_entropy,
        adamw(3e-3), iter(confidential), steps=RETRAIN_STEPS,
    )
    print(f"[client] retrained pruned model accuracy: "
          f"{accuracy(model, retrained, confidential):.3f}")

    # ---- DEPLOYMENT: pack the retrained weights for serving ----------------
    artifact = (result.to_artifact(arch="vgg16").with_params(retrained)
                .pack(device=dev))
    s = artifact.summary()
    packed_params = artifact.bind(model, packed=True)
    print(f"[deploy] packed {s['packed_leaves']}/{s['total_leaves']} leaves: "
          f"{s['dense_bytes']/1e6:.2f}MB -> {s['packed_bytes']/1e6:.2f}MB "
          f"({s['bytes_ratio']:.2f}x); packed accuracy: "
          f"{accuracy(model, packed_params, confidential):.3f}")


if __name__ == "__main__":
    main()
