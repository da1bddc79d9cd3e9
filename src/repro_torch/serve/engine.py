"""Chunked-batch serving engine (mirrors ``repro/serve/engine.py``'s
``ServeEngine``).

``generate`` buckets requests by prompt length (stable sort), serves them
in chunks of ``batch_size``: one prefill of the chunk's left-padded
prompts (the zero pad tokens ARE attended, as in the reference), then one
greedy decode loop as long as the chunk's longest ``max_new_tokens``.
Empty slots of a short chunk sample token 0. Each request's tokens are
trimmed to its own ``max_new_tokens`` and at its ``eos_id``. Results come
back in request order.

With ``packed=True`` and a ``PrunedArtifact`` every pruned GEMM runs its
scheme's packed kernel (``pattern_gemm`` for tile_pattern, ``column_gemm``
for column); ``packed=False`` serves the dense pruned weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.models.transformer import LM
from repro_torch.serve.sampler import greedy_sample
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
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]


class ServeEngine:
    def __init__(self, model: LM, params: Any, *, batch_size: int,
                 max_seq_len: int, sampler: Callable = greedy_sample,
                 packed: bool = False, device: DeviceLike = None):
        """``params``: a ``PrunedArtifact`` or, with ``packed=False``, a raw
        params tree. ``sampler`` maps logits (B, 1, V) to tokens (B, 1) on
        the device."""
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        if isinstance(params, PrunedArtifact):
            params = params.bind(model, packed=packed)
        elif packed:
            raise TypeError("packed=True needs a PrunedArtifact; got a raw "
                            "params tree")
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.sampler = sampler

    def prefill(self, prompts: torch.Tensor):
        """(B, S) token ids -> (cache, last-token logits)."""
        return self.model.prefill(self.params, prompts, self.max_seq_len)

    def decode(self, cache, tokens: torch.Tensor, slot_mask: torch.Tensor,
               num_steps: int):
        """Greedy decode loop; empty slots (mask 0) sample token 0."""
        samp = lambda logits: self.sampler(logits) * slot_mask[:, None]
        return self.model.decode_many(self.params, cache, tokens, num_steps,
                                      sampler=samp)

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

    def pad_prompts(self, requests: Sequence[Request]):
        """Left-pad a chunk's prompts with token 0 to its longest and fill
        empty slots with zero prompts -> ((B, S) ids, (B,) slot mask)."""
        B, n = self.batch_size, len(requests)
        S = max(len(r.prompt) for r in requests)
        prompts = torch.zeros((B, S), dtype=torch.int64, device=self.device)
        for row, r in enumerate(requests):
            p = torch.as_tensor(r.prompt, dtype=torch.int64)
            prompts[row, S - p.shape[0]:] = p.to(self.device)
        slot_mask = torch.tensor([1] * n + [0] * (B - n), dtype=torch.int64,
                                 device=self.device)
        return prompts, slot_mask

    @torch.no_grad()
    def _generate_batch(self, requests: Sequence[Request]) -> List[Result]:
        prompts, slot_mask = self.pad_prompts(requests)
        cache, logits = self.prefill(prompts)
        # the loop runs to THIS chunk's longest request, not a global max
        max_new = max(r.max_new_tokens for r in requests)
        tok0 = self.sampler(logits) * slot_mask[:, None]
        if max_new > 1:
            _, rest = self.decode(cache, tok0, slot_mask, max_new - 1)
            toks = torch.cat([tok0, rest], dim=1)
        else:
            toks = tok0
        rows = toks.cpu().tolist()          # one device -> host transfer
        return [Result(uid=r.uid,
                       tokens=trim_at_eos(rows[j][: r.max_new_tokens],
                                          r.eos_id))
                for j, r in enumerate(requests)]
