"""Data pipelines (mirrors ``repro/data/pipeline.py``).

Two roles in the paper's workflow: the system designer only ever sees the
``core.synthetic`` generators; the client owns a real dataset, modelled
here as deterministic seeded "confidential" corpora with the interface a
real loader has: step-indexed, resumable, on one device.

A batch is a pure function of (seed, step): it is drawn from a
``torch.Generator`` seeded by splitmix64 of the two (``fold_in``), so a
restart at step K regenerates the stream from K with no loader state.
The values follow the reference's distributions, not its bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.sampler import fold_in


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32_000
    d_model: int = 0                 # EmbeddingPipeline
    num_classes: int = 10            # ClassificationPipeline
    image_hwc: Tuple[int, int, int] = (32, 32, 3)
    seed: int = 1234


def _generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    key = fold_in(torch.tensor(seed, dtype=torch.int64), step)
    return torch.Generator(device).manual_seed(int(key) % (1 << 64))


class TokenPipeline:
    """LM token stream: ``batch_at(step)`` is pure in (seed, step).

    The corpus has learnable structure, a Markov-like stream ``next =
    (cur * 31 + noise + 7) % V``, so retraining on it is a real task.
    """

    def __init__(self, config: DataConfig, *, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.config
        g = _generator(cfg.seed, step, self.device)
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        cur = torch.randint(0, V, (B,), generator=g, device=self.device)
        noise = torch.randint(0, max(V // 64, 2), (B, S), generator=g,
                              device=self.device)
        toks = [cur]
        for s in range(S):
            cur = (cur * 31 + noise[:, s] + 7) % V
            toks.append(cur)
        tokens = torch.stack(toks, dim=1)                 # (B, S + 1)
        return {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class EmbeddingPipeline:
    """(embeddings, labels) stream for a model whose front end is a stub:
    ``batch_at(step)`` is pure in (seed, step), ``inputs`` (B, S, D) fp32
    N(0, 1), ``labels`` (B, S) int32 uniform over the vocabulary (the
    reference's dtypes)."""

    def __init__(self, config: DataConfig, *, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.config
        g = _generator(cfg.seed, step, self.device)
        B, S = cfg.global_batch, cfg.seq_len
        emb = torch.randn((B, S, cfg.d_model), generator=g,
                          device=self.device)
        labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                               device=self.device, dtype=torch.int32)
        return {"inputs": emb, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ClassificationPipeline:
    """Labelled image stream, the client's "confidential" set: each class
    has a fixed prototype image and a sample is its prototype plus noise,
    clipped to [0, 1] (separable, so retraining measurably recovers
    accuracy, while staying synthetic)."""

    def __init__(self, config: DataConfig, noise: float = 0.35, *,
                 device: DeviceLike = None):
        self.config = config
        self.noise = noise
        self.device = resolve_device(device)
        g = _generator(config.seed, -1, self.device)
        self.prototypes = torch.rand(
            (config.num_classes, *config.image_hwc), generator=g,
            device=self.device)

    def batch_at(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        g = _generator(cfg.seed + 1, step, self.device)
        y = torch.randint(0, cfg.num_classes, (cfg.global_batch,),
                          generator=g, device=self.device)
        x = self.prototypes[y] + self.noise * torch.randn(
            (cfg.global_batch, *cfg.image_hwc), generator=g,
            device=self.device)
        return torch.clamp(x, 0.0, 1.0), y

    def eval_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.batch_at(10_000_019)            # a held-out step

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline_for(kind: str, config: DataConfig, *,
                      device: DeviceLike = None):
    """The pipeline of an input kind: 'lm' | 'embeddings' |
    'classification'."""
    if kind == "lm":
        return TokenPipeline(config, device=device)
    if kind == "embeddings":
        return EmbeddingPipeline(config, device=device)
    if kind == "classification":
        return ClassificationPipeline(config, device=device)
    raise ValueError(f"unknown pipeline kind '{kind}'")
