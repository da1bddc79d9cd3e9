"""Masked optimizer, the client-side half of the paper's contract
(mirrors ``repro/optim/masked.py``).

Wraps any ``Optimizer`` so that incoming gradients and outgoing updates
are masked: pruned positions stay exactly zero whatever the moments or
the weight decay would do.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.masks import apply_mask, mask_gradients
from repro_torch.optim.optimizers import Optimizer


def masked(inner: Optimizer, masks: Any) -> Optimizer:
    def init(params):
        return inner.init(apply_mask(params, masks))

    def update(grads, state, params=None):
        grads = mask_gradients(grads, masks)
        updates, state = inner.update(grads, state, params)
        return apply_mask(updates, masks), state

    return Optimizer(init, update)
