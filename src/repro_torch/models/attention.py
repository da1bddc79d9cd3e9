"""Attention (mirrors ``repro/models/attention.py``).

``prefill_attention`` is the full-sequence attention of the LM: on the
card a serving call (``use_flash``) of a shape ``flash_prefill_supported``
admits runs the ``flash_attention`` kernel; every other call, a training
forward included, runs ``blockwise_attention``, the plain q-chunked
online-softmax version (differentiable by autograd). Decode attends one
new position against the KV cache, and a speculative verify chunk K
positions (``chunk_attention``), with plain tensor ops (XLA ops in the
reference, not Pallas kernels). A sliding-window model keeps a RING
cache of ``window`` slots with explicit per-slot positions (position p
in slot p % C), so its cache is O(window) whatever the sequence length.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as flash

NEG_INF = -1e30


# prefill calls that asked for the flash kernel (``use_flash`` on the
# card) and ran ``blockwise_attention`` because the kernel does not take
# their shape; they launch no kernel
PREFILL_FALLBACKS = 0


def flash_prefill_supported(seq_len: int, num_heads: int, num_kv_heads: int,
                            head_dim: int) -> bool:
    """Can the ``flash_attention`` kernel serve this prefill shape?

    The kernel's own limits: a head dim in ``HEAD_DIMS`` (32, 64, 80 or
    128) and an exact GQA ratio. It takes every S (TMA zero-fills the
    ragged edge), so unlike the reference's Pallas kernel it needs no S
    divisible by its block. A shape that fails takes
    ``blockwise_attention``, so serving never crashes on a shape the
    kernel does not take.
    """
    if seq_len <= 0 or num_kv_heads <= 0:
        return False
    return num_heads % num_kv_heads == 0 and head_dim in flash.HEAD_DIMS


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      use_flash: bool = False) -> torch.Tensor:
    """Full-sequence attention of q (B, S, H, hd), k/v (B, S, KV, hd),
    a query seeing only keys less than ``window`` positions back.

    ``use_flash`` is the serving request: on CUDA tensors of a supported
    shape it launches the flash kernel; an unsupported shape takes
    ``blockwise_attention`` and counts one ``PREFILL_FALLBACKS``. A kernel
    that fails still raises.
    """
    global PREFILL_FALLBACKS
    B, S, H, hd = q.shape
    if use_flash and q.device.type == "cuda":
        if flash_prefill_supported(S, H, k.shape[2], hd):
            return flash.flash_attention(q, k, v, causal=causal,
                                         window=window)
        PREFILL_FALLBACKS += 1
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               chunk=min(512, S))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        chunk: int = 512,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Q-chunk online-softmax attention, the reference's ``_qchunk_fwd``:
    q pre-scaled in its dtype, fp32 scores and (m, l, acc), every kv chunk
    of the sequence visited (masked ones add exp(NEG_INF - m) = 0)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    n = S // chunk
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qs = (q.to(torch.float32) * scale).to(q.dtype)
    qg = qs.reshape(B, S, KV, G, hd).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    pos = torch.arange(chunk, device=q.device)
    out = torch.empty((B, S, KV, G, hd), dtype=torch.float32, device=q.device)
    for qi in range(n):
        qc = qg[:, qi * chunk:(qi + 1) * chunk]             # (B, c, KV, G, hd)
        q_pos = qi * chunk + pos
        m = torch.full((B, chunk, KV, G), NEG_INF, device=q.device)
        l = torch.zeros((B, chunk, KV, G), device=q.device)
        acc = torch.zeros((B, chunk, KV, G, hd), device=q.device)
        for kj in range(n):
            kc = kf[:, kj * chunk:(kj + 1) * chunk]
            vc = vf[:, kj * chunk:(kj + 1) * chunk]
            s = torch.einsum("bqkgd,bpkd->bqpkg", qc, kc)
            k_pos = kj * chunk + pos
            ok = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
            if causal:
                ok &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                ok &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(ok[None, :, :, None, None], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=2))
            p = torch.exp(s - m_new[:, :, None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2)
            pv = torch.einsum("bqpkg,bpkd->bqkgd",
                              p.to(v.dtype).to(torch.float32), vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, qi * chunk:(qi + 1) * chunk] = (
            acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, S, H, hd).to(q.dtype)


@dataclasses.dataclass
class CacheSpec:
    capacity: int            # S_max for full caches; window for ring caches
    ring: bool


def cache_capacity(seq_len: int, window: Optional[int]) -> CacheSpec:
    if window is not None and window < seq_len:
        return CacheSpec(capacity=window, ring=True)
    return CacheSpec(capacity=seq_len, ring=False)


def slot_prompt_rows(capacity: int, prompt_len: int, ring: bool,
                     device=None):
    """Cache geometry for writing a fresh ``prompt_len``-token prompt into
    one slot -> ``(rows, keep, slot_pos_row)``: the cache slot indices
    ``(keep,)`` the prompt's LAST ``keep`` positions land in (a ring cache
    keeps only the trailing ``min(C, S)``, position p in slot p % C), and
    the full ``(capacity,)`` int32 slot_pos row for the slot: fresh
    positions where written, ``-1`` (empty, masked by
    ``decode_attention``) elsewhere. Resetting a slot's row to this is
    what hides a retired occupant's stale KV when a batch slot is reused
    mid-decode: the bytes stay, the mask hides them.
    """
    S, C = prompt_len, capacity
    if not ring and S > C:
        raise ValueError(f"prompt_len={S} exceeds cache capacity={C}")
    keep = min(C, S)
    pos = torch.arange(S - keep, S, dtype=torch.int32, device=device)
    rows = pos % C if ring else pos
    slot_pos_row = torch.full((C,), -1, dtype=torch.int32, device=device)
    slot_pos_row[rows.long()] = pos
    return rows, keep, slot_pos_row


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, slot_pos: torch.Tensor,
                    q_pos: torch.Tensor, *, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """K new positions per row against the cache: masked softmax in fp32.

    q (B, K, H, hd); caches (B, C, KV, hd), the chunk's own k/v already
    inserted (``cache_insert_chunk``); slot_pos (B, C), -1 = empty; q_pos
    (B, K). Query i sees slot p iff 0 <= slot_pos[p] <= q_pos[i], so the
    chunk's causality falls out of the cache mask. ``decode_attention``
    is this function at K = 1: a chunk and K single steps share their
    per-query arithmetic.
    """
    B, C, KV, hd = k_cache.shape
    K, H = q.shape[1], q.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, KV, G, hd).to(torch.float32)
    s = torch.einsum("bqkgd,bpkd->bqkgp", qg,
                     k_cache.to(torch.float32)) * scale
    sp = slot_pos[:, None, :]
    ok = (sp >= 0) & (sp <= q_pos[:, :, None])
    if window is not None:
        ok &= q_pos[:, :, None] - sp < window
    s = torch.where(ok[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgp,bpkd->bqkgd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, K, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     q_pos: torch.Tensor, *, window: Optional[int] = None,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """One new position per row against the cache: q (B, 1, H, hd), q_pos
    (B,); ``chunk_attention`` with K = 1."""
    return chunk_attention(q, k_cache, v_cache, slot_pos, q_pos[:, None],
                           window=window, softmax_scale=softmax_scale)


def insert_slots(pos: torch.Tensor, capacity: int, ring: bool):
    """Cache slot of each row's new position -> (rows, slot, keep).

    Ring caches write slot pos % C. A full cache drops a write past its
    capacity, as the reference's scatter does: the slot is clamped and
    ``keep`` is False there, so ``cache_insert`` writes the old values
    back (no host sync to filter rows).
    """
    rows = torch.arange(pos.shape[0], device=pos.device)
    if ring:
        return rows, (pos % capacity).long(), torch.ones_like(
            pos, dtype=torch.bool)
    return rows, pos.clamp(max=capacity - 1).long(), pos < capacity


def cache_insert(cache: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
                 slot: torch.Tensor, keep: torch.Tensor) -> None:
    """Write one position per row, new (B, 1, ...), into cache (B, C, ...)
    IN PLACE at ``slot`` where ``keep`` (see ``insert_slots``).

    The reference returns updated arrays; the port mutates the cache
    tensors instead of copying the cache every step.
    """
    old = cache[rows, slot]
    val = new[:, 0].to(cache.dtype)
    cache[rows, slot] = torch.where(keep.view((-1,) + (1,) * (val.ndim - 1)),
                                    val, old)


def chunk_rows(pos: torch.Tensor, K: int, capacity: int, ring: bool):
    """Each row's next K positions -> ``(idx, rows)``, each (B, K): the
    absolute positions ``pos[b] .. pos[b] + K - 1`` and the cache slots
    they land in, ``idx % C`` on a ring, else ``idx`` unclamped (the rows
    past a full cache's capacity are the overflow ``chunk_slots``
    drops)."""
    idx = pos[:, None] + torch.arange(K, dtype=pos.dtype, device=pos.device)
    return idx, (idx % capacity if ring else idx)


def chunk_slots(pos: torch.Tensor, K: int, capacity: int, ring: bool):
    """Cache slots of each row's next K positions -> ``(idx, slot, src,
    write)``, each (B, K): positions ``idx``, cache slots ``slot`` (long),
    and for each write the chunk column ``src`` whose value it carries
    and whether it writes at all.

    On a ring (K <= C, so a row's K slots are distinct) column j writes
    slot ``idx % C`` with its own value. In a full cache a position past
    the capacity is dropped, as the reference's scatter drops it, with no
    host sync: its slot is clamped to C - 1, and it writes what slot
    C - 1 ends with, the chunk's own position C - 1 (``src``) when the
    chunk reaches it, else nothing (``write`` False, the old value
    written back). So every write to one slot carries the same value, and
    the in-place scatter is deterministic.
    """
    idx, rows = chunk_rows(pos, K, capacity, ring)
    cols = torch.arange(K, device=pos.device)
    if ring:
        return (idx, rows.long(), cols[None, :].expand(idx.shape),
                torch.ones_like(idx, dtype=torch.bool))
    last = (capacity - 1 - pos).clamp(0, K - 1).long()
    inside = idx < capacity
    src = torch.where(inside, cols[None, :], last[:, None])
    write = inside | (pos < capacity)[:, None]
    return idx, idx.clamp(max=capacity - 1).long(), src, write


def cache_insert_chunk(cache: torch.Tensor, new: torch.Tensor,
                       slot: torch.Tensor, src: torch.Tensor,
                       write: torch.Tensor) -> None:
    """Write K positions per row, new (B, K, ...), into cache (B, C, ...)
    IN PLACE at the slots ``chunk_slots`` gives."""
    b = torch.arange(cache.shape[0], device=cache.device)[:, None]
    val = new[b, src].to(cache.dtype)
    write = write.view(write.shape + (1,) * (val.ndim - 2))
    cache[b, slot] = torch.where(write, val, cache[b, slot])

