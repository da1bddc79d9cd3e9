"""Optimizers as plain functions over parameter trees (mirrors
``repro/optim/optimizers.py``).

The reference's small optax-style API: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, the updates ADDED
to the params. Not ``torch.optim``: the state is a NamedTuple of trees
congruent with the params (moments in fp32) and an int32 step, so it
saves with ``checkpoint.save_pytree`` in the reference's format. The step
lives on the CPU (a 0-d tensor mixes with tensors on any device), so
reading the learning rate never waits on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, NamedTuple, Tuple, Union

import torch

from repro_torch.utils.tree import tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def clip_scale(grads: Iterable[torch.Tensor], max_norm: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global-norm clip: (the fp32 norm of all ``grads`` together, the
    factor ``min(1, max_norm / norm)`` that scales them to it)."""
    sq = [g.to(torch.float32).square().sum() for g in grads]
    norm = torch.sqrt(sum(sq[1:], sq[0]))
    return norm, torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


class SGDState(NamedTuple):
    step: torch.Tensor


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        del params
        return SGDState(step=_step0())

    def update(grads, state, params=None):
        del params
        lrt = _lr_at(lr, state.step)
        updates = tree_map(lambda g: -lrt * g.to(torch.float32), grads)
        return updates, SGDState(step=state.step + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: Any


def momentum(lr: Schedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(step=_step0(),
                             velocity=tree_map(_zeros32, params))

    def update(grads, state, params=None):
        del params
        lrt = _lr_at(lr, state.step)
        vel = tree_map(lambda v, g: beta * v + g.to(torch.float32),
                       state.velocity, grads)
        if nesterov:
            upd = tree_map(
                lambda v, g: -lrt * (beta * v + g.to(torch.float32)),
                vel, grads)
        else:
            upd = tree_map(lambda v: -lrt * v, vel)
        return upd, MomentumState(step=state.step + 1, velocity=vel)

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with fp32 moments (bf16-safe)."""

    def init(params):
        return AdamWState(step=_step0(), mu=tree_map(_zeros32, params),
                          nu=tree_map(_zeros32, params))

    def update(grads, state, params=None):
        step = state.step + 1
        lrt = _lr_at(lr, state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * g.to(torch.float32).square(),
            state.nu, grads)
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(m, v, p):
            u = -lrt * (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay and p is not None:
                u = u - lrt * weight_decay * p.to(torch.float32)
            return u

        if params is None:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)
