"""Attention (mirrors ``repro/models/attention.py``).

``prefill_attention`` is the full-sequence attention of the LM: on the
card a serving call (``use_flash``) of a shape ``flash_prefill_supported``
admits runs the ``flash_attention`` kernel; every other call, a training
forward included, runs ``blockwise_attention``, the q-chunked
online-softmax version with the reference's recompute backward (a causal
window visits only its band of kv chunks). Decode attends one
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
    """Q-chunk online-softmax attention with a recompute backward, the
    reference's ``blockwise_attention`` (its ``_flash_vjp``): the forward
    keeps only each q chunk's softmax stats (m, l) beside the output, and
    the backward recomputes the score tiles from them in two passes (dq
    over the kv band, then dk / dv over the q band) instead of autograd
    keeping every tile. A causal window visits only its band of kv
    chunks, so it costs O(S * window), not O(S^2)."""
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    return _BlockwiseAttention.apply(q, k, v, causal, window,
                                     min(chunk, q.shape[1]), float(scale))


def _blockwise_qchunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      chunk: int = 512,
                      softmax_scale: Optional[float] = None,
                      banded: bool = True) -> torch.Tensor:
    """The plain q-chunk loop, differentiated by autograd (the test oracle
    of ``blockwise_attention``, as the reference's ``_blockwise_qchunk``
    is of its custom VJP). ``banded=False`` visits every kv chunk."""
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    return _qchunk_fwd(q, k, v, causal=causal, window=window,
                       chunk=min(chunk, q.shape[1]), scale=float(scale),
                       banded=banded)[0]


def kv_band(n: int, chunk: int, causal: bool, window: Optional[int]) -> int:
    """kv chunks a q chunk visits: the causal window's band, else all n. A
    non-causal window bounds only the past, so it takes no band."""
    if window is not None and causal:
        return min(n, (window - 1) // chunk + 2)
    return n


def _band_start(qi: int, band: int, n: int) -> int:
    return max(qi - (band - 1), 0) if band < n else 0


def _chunk_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def _scores(qc, kc, q_pos, k_pos, causal: bool, window: Optional[int]):
    """One masked fp32 score tile (B, c, c, KV, G) of a q chunk (B, c, KV,
    G, hd) against a kv chunk (B, c, KV, hd), q pre-scaled."""
    s = torch.einsum("bqkgd,bpkd->bqpkg", qc, kc)
    ok = _chunk_mask(q_pos, k_pos, causal, window)
    return torch.where(ok[None, :, :, None, None], s,
                       torch.full_like(s, NEG_INF))


def _qchunk_fwd(q, k, v, *, causal: bool, window: Optional[int], chunk: int,
                scale: float, banded: bool = True):
    """The reference's ``_qchunk_fwd``: q pre-scaled in its dtype, fp32
    scores and (m, l, acc), each q chunk's kv band visited (masked entries
    add exp(NEG_INF - m) = 0) -> (out (B, S, H, hd), m, l), the stats
    (n, B, c, KV, G) for the backward."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    n = S // chunk
    band = kv_band(n, chunk, causal, window) if banded else n
    qs = (q.to(torch.float32) * scale).to(q.dtype)
    qg = qs.reshape(B, S, KV, G, hd).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    pos = torch.arange(chunk, device=q.device)
    outs, ms, ls = [], [], []
    for qi in range(n):
        qc = qg[:, qi * chunk:(qi + 1) * chunk]             # (B, c, KV, G, hd)
        q_pos = qi * chunk + pos
        m = torch.full((B, chunk, KV, G), NEG_INF, device=q.device)
        l = torch.zeros((B, chunk, KV, G), device=q.device)
        acc = torch.zeros((B, chunk, KV, G, hd), device=q.device)
        j0 = _band_start(qi, band, n)
        for kj in range(j0, j0 + band):
            vc = vf[:, kj * chunk:(kj + 1) * chunk]
            s = _scores(qc, kf[:, kj * chunk:(kj + 1) * chunk], q_pos,
                        kj * chunk + pos, causal, window)
            m_new = torch.maximum(m, s.amax(dim=2))
            p = torch.exp(s - m_new[:, :, None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2)
            pv = torch.einsum("bqpkg,bpkd->bqkgd",
                              p.to(v.dtype).to(torch.float32), vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, dim=1).reshape(B, S, H, hd).to(q.dtype)
    return out, torch.stack(ms), torch.stack(ls)


def _qchunk_bwd(q, k, v, out, m_all, l_all, dout, *, causal: bool,
                window: Optional[int], chunk: int, scale: float):
    """The reference's ``_qchunk_bwd_impl``: score tiles recomputed from
    the forward's (m, l), so p = exp(s - m) / l exactly. Pass A: dq, each
    q chunk over its kv band; pass B: dk / dv, each kv chunk over the q
    chunks that see it (under causality the band after it)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    n = S // chunk
    band = kv_band(n, chunk, causal, window)
    f32 = torch.float32
    pos = torch.arange(chunk, device=q.device)
    qg = (q.to(f32) * scale).to(q.dtype).reshape(B, S, KV, G, hd).to(f32)
    do = dout.reshape(B, S, KV, G, hd)
    D = (do.to(f32) * out.reshape(B, S, KV, G, hd).to(f32)).sum(dim=-1)
    do = do.to(f32)
    kf, vf = k.to(f32), v.to(f32)
    linv = 1.0 / l_all.clamp_min(1e-30)

    def rows(t, i):
        return t[:, i * chunk:(i + 1) * chunk]

    def p_tile(qi, kj):
        s = _scores(rows(qg, qi), rows(kf, kj), qi * chunk + pos,
                    kj * chunk + pos, causal, window)
        return torch.exp(s - m_all[qi][:, :, None]) * linv[qi][:, :, None]

    def ds_tile(p, qi, kj):
        dP = torch.einsum("bqkgd,bpkd->bqpkg", rows(do, qi), rows(vf, kj))
        return p * (dP - rows(D, qi)[:, :, None])

    dq = []
    for qi in range(n):                                 # pass A: dq
        dqc = torch.zeros((B, chunk, KV, G, hd), dtype=f32, device=q.device)
        j0 = _band_start(qi, band, n)
        for kj in range(j0, j0 + band):
            ds = ds_tile(p_tile(qi, kj), qi, kj)
            dqc = dqc + torch.einsum("bqpkg,bpkd->bqkgd",
                                     ds.to(k.dtype).to(f32), rows(kf, kj))
        dq.append((dqc * scale).to(q.dtype))
    qband = band if causal else n
    dk, dv = [], []
    for kj in range(n):                                 # pass B: dk, dv
        dkc = torch.zeros((B, chunk, KV, hd), dtype=f32, device=q.device)
        dvc = torch.zeros_like(dkc)
        j0 = kj if causal else 0
        for qi in range(j0, min(j0 + qband, n)):
            p = p_tile(qi, kj)
            dvc = dvc + torch.einsum("bqpkg,bqkgd->bpkd",
                                     p.to(dout.dtype).to(f32), rows(do, qi))
            ds = ds_tile(p, qi, kj)
            dkc = dkc + torch.einsum("bqpkg,bqkgd->bpkd",
                                     ds.to(q.dtype).to(f32), rows(qg, qi))
        dk.append(dkc.to(k.dtype))
        dv.append(dvc.to(v.dtype))
    return (torch.cat(dq, dim=1).reshape(B, S, H, hd), torch.cat(dk, dim=1),
            torch.cat(dv, dim=1))


class _BlockwiseAttention(torch.autograd.Function):
    """``_qchunk_fwd`` with ``_qchunk_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale):
        out, m, l = _qchunk_fwd(q, k, v, causal=causal, window=window,
                                chunk=chunk, scale=scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.static = (causal, window, chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, chunk, scale = ctx.static
        dq, dk, dv = _qchunk_bwd(*ctx.saved_tensors, dout.contiguous(),
                                 causal=causal, window=window, chunk=chunk,
                                 scale=scale)
        return dq, dk, dv, None, None, None, None


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

