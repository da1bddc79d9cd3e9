"""Token samplers (mirrors ``repro/serve/sampler.py``).

Samplers map logits (B, 1, V) to tokens (B, 1) on the device, with no
host sync, so they run inside the decode loop and inside a captured CUDA
graph. ``temperature_sample`` takes a per-row temperature: rows at
``temperature <= 0`` take the greedy argmax exactly; the others draw from
softmax(logits / T).

JAX's PRNG cannot be matched bit for bit, so the random stream is the
port's own, counter-based and stateless: the uniform of vocab entry v in
a row is a hash of (row key, v) (splitmix64's mixer in int64 torch ops),
and a row key for token i of a request is ``fold_in(request key, i)``.
Nothing advances per draw, so a graph replay draws fresh numbers from a
device step index alone. A request with a ``seed`` has the request key
``request_key(seed)``, a pure function of the seed: its tokens do not
depend on its batch-mates, its row, or the engine's seed. Sampling is the
Gumbel-max argmax of ``logits / T - log(-log u)``.

The integer ops give the same bits on the CPU and the card: int64
arithmetic wraps, and every right shift is masked to a logical one
(``>>`` on int64 is arithmetic).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

# splitmix64 constants, as signed int64
_GAMMA = 0x9E3779B97F4A7C15 - (1 << 64)
_MUL1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MUL2 = 0x94D049BB133111EB - (1 << 64)
_SEED_SALT = 0x2545F4914F6CDD1D      # request_key(seed) = mix(seed + salt)
_U_BITS = 23                         # (2k + 1) / 2^24 is exact in fp32


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's output mixer on int64 tensors (a bijection)."""
    x = (x ^ _shr(x, 30)) * _MUL1
    x = (x ^ _shr(x, 27)) * _MUL2
    return x ^ _shr(x, 31)


def fold_in(keys: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """A new key per (key, data): ``mix(key ^ mix((data + 1) * gamma))``."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), data, dtype=torch.int64, device=keys.device)
    return mix64(keys ^ mix64((data.to(torch.int64) + 1) * _GAMMA))


def uniform_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) int64 row keys -> (B, n) fp32 uniforms in (0, 1): the splitmix
    stream ``mix(key + (v + 1) * gamma)`` for v < n, top 23 bits, as
    (2k + 1) / 2^24."""
    v = torch.arange(1, n + 1, dtype=torch.int64, device=keys.device)
    h = mix64(keys[:, None] + v[None, :] * _GAMMA)
    k = _shr(h, 64 - _U_BITS)
    return (2 * k + 1).to(torch.float32) * (2.0 ** -(_U_BITS + 1))


def greedy_sample(logits: torch.Tensor, key=None) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int64; ties go to the first index, as
    ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1)


def temperature_sample(logits: torch.Tensor, key: torch.Tensor,
                       temperature: Union[float, torch.Tensor] = 1.0,
                       greedy: Callable = greedy_sample) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int64.

    ``key``: (B,) int64 row keys, each row its own stream.
    ``temperature``: a float or per-row (B,) tensor; rows at ``<= 0`` take
    ``greedy(logits)`` exactly, the rest the Gumbel-max sample of
    softmax(logits / T).
    """
    B, V = logits.shape[0], logits.shape[-1]
    dev = logits.device
    if isinstance(temperature, torch.Tensor):
        t = temperature.to(torch.float32)
    else:                       # filled on the device: no host copy
        t = torch.full((), temperature, dtype=torch.float32, device=dev)
    t = t.expand(B) if t.ndim == 0 else t
    flat = logits.reshape(B, V).to(torch.float32)
    gumbel = -torch.log(-torch.log(uniform_bits(key, V)))
    scores = flat / torch.clamp(t, min=1e-6)[:, None] + gumbel
    sampled = torch.argmax(scores, dim=-1, keepdim=True)
    return torch.where(t[:, None] <= 0.0, greedy(logits), sampled)


def request_key(seed: Optional[int], gen: torch.Generator) -> int:
    """One request's base key: a pure function of ``Request.seed`` when it
    sets one, else the next draw of the engine's generator ``gen``."""
    if seed is not None:
        x = (int(seed) + _SEED_SALT + (1 << 63)) % (1 << 64) - (1 << 63)
        return int(mix64(torch.tensor(x, dtype=torch.int64)))
    return int(torch.randint(-(1 << 63), (1 << 63) - 1, (), generator=gen,
                             dtype=torch.int64))


def fold_key_grid(row_keys: torch.Tensor, offsets: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """(B,) row keys x per-row token offsets -> (steps, B) step keys:
    step s of row b is ``fold_in(row_keys[b], offsets[b] + s)``, keyed by
    the row's own token index."""
    s = torch.arange(steps, dtype=torch.int64, device=row_keys.device)
    return fold_in(row_keys[None, :], offsets.to(torch.int64)[None, :]
                   + s[:, None])
