"""Client-side masked retraining (paper section III-B; mirrors
``repro/core/retrain.py``).

The client retrains the pruned model on her confidential data with the
mask function: gradients of pruned weights are zeroed and the weights
masked after every update, so the pruned architecture survives exactly.
Any optimizer of ``optim`` composes with it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.masks import apply_mask, mask_gradients
from repro_torch.utils.tree import tree_items, tree_map


def make_retrain_step(apply_fn: Callable[[Any, Any], torch.Tensor],
                      loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor],
                      optimizer, masks: Any):
    """A masked train step ``step(params, opt_state, (x, y)) -> (params,
    opt_state, loss)``: grads -> mask -> optimizer -> mask."""

    def step(params, opt_state, batch):
        x, y = batch
        with torch.enable_grad():
            p = tree_map(lambda w: w.detach().requires_grad_(True), params)
            loss = loss_fn(apply_fn(p, x), y)
            leaves = [w for _, w in tree_items(p)]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(w) if g is None else g
                   for w, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), p)
        with torch.no_grad():
            grads = mask_gradients(grads, masks)       # the mask function
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = tree_map(lambda w, u: (w + u).to(w.dtype), params,
                              updates)
            params = apply_mask(params, masks)         # pruned stay 0
        return params, opt_state, loss.detach()

    return step


def retrain(params: Any, masks: Any,
            apply_fn: Callable[[Any, Any], torch.Tensor],
            loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            optimizer, data_iter: Iterator, steps: int,
            eval_fn: Optional[Callable[[Any], float]] = None,
            eval_every: int = 0) -> Tuple[Any, Dict[str, List[float]]]:
    """``steps`` masked retraining steps -> (params, history). (The
    reference's first argument, an unused key, is dropped.)"""
    params = apply_mask(params, masks)
    opt_state = optimizer.init(params)
    step = make_retrain_step(apply_fn, loss_fn, optimizer, masks)
    history: Dict[str, List[float]] = {"loss": [], "eval": []}
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, next(data_iter))
        history["loss"].append(float(loss))
        if eval_fn is not None and eval_every and (i + 1) % eval_every == 0:
            history["eval"].append(float(eval_fn(params)))
    return params, history
