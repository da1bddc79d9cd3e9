"""Data-free synthetic inputs (mirrors ``repro/core/synthetic.py``).

The paper's generator: every pixel drawn from the discrete Uniform[0, 255]
distribution, independent of any client data; for an LM the same
no-prior-knowledge principle gives uniform token ids over the vocabulary,
and N(0, 1) embeddings for a model whose modality front end is a stub
(the vlm and audio families). Drawn from a ``torch.Generator``, so the
values match the reference's distribution, not its bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


def synthetic_images(gen: torch.Generator, batch: int,
                     hwc: Tuple[int, int, int] = (32, 32, 3),
                     normalize: bool = True, *,
                     device: DeviceLike = None) -> torch.Tensor:
    """(batch, H, W, C) fp32 Uniform[0, 255] pixels, scaled to [0, 1] when
    ``normalize``. ``gen`` must live on ``device``."""
    dev = resolve_device(device)
    pix = torch.randint(0, 256, (batch, *hwc), generator=gen, device=dev,
                        dtype=torch.int32)
    x = pix.to(torch.float32)
    return x / 255.0 if normalize else x


def synthetic_tokens(gen: torch.Generator, batch: int, seq_len: int,
                     vocab_size: int, *,
                     device: DeviceLike = None) -> torch.Tensor:
    """(batch, seq_len) int64 token ids, uniform over the vocabulary (the
    LM analogue of uniform pixels). ``gen`` must live on ``device``."""
    return torch.randint(0, vocab_size, (batch, seq_len), generator=gen,
                         device=resolve_device(device), dtype=torch.int64)


def synthetic_embeddings(gen: torch.Generator, batch: int, seq_len: int,
                         dim: int, dtype: torch.dtype = torch.float32, *,
                         device: DeviceLike = None) -> torch.Tensor:
    """(batch, seq_len, dim) N(0, 1) embeddings, what a stubbed modality
    front end (audio, vlm) would hand the model. ``gen`` must live on
    ``device``."""
    return torch.randn((batch, seq_len, dim), generator=gen,
                       device=resolve_device(device), dtype=dtype)


def synthetic_batch_for(kind: str, gen: torch.Generator, **kw
                        ) -> torch.Tensor:
    """Dispatch by input kind: 'image' | 'tokens' | 'embeddings'."""
    if kind == "image":
        return synthetic_images(gen, **kw)
    if kind == "tokens":
        return synthetic_tokens(gen, **kw)
    if kind == "embeddings":
        return synthetic_embeddings(gen, **kw)
    raise ValueError(f"unknown synthetic input kind '{kind}'")
