"""The training step of the client's recipe (mirrors the part of
``repro/launch/train.py`` the privacy report and the pipeline run).

``make_train_step`` is the reference's step: grads -> the mask function
-> global-norm clip -> fp32 grads -> optimizer -> ``(p.float() +
u).to(p.dtype)`` -> mask. Masked retraining is the same step with the
masks plumbed in. Updates land in the params' own dtype: no fp32 master
copy is kept, as the reference keeps none.

Not ported here: the training CLI, the mesh and sharded init, and int8
gradient compression.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.masks import apply_mask, mask_gradients
from repro_torch.models.transformer import LM
from repro_torch.optim import clip_scale
from repro_torch.utils.tree import tree_items, tree_leaves, tree_map


def make_train_step(model: LM, optimizer, *, masks: Any = None,
                    grad_clip: float = 1.0):
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``, the state
    ``{"params", "opt": optimizer.init(params), "step": 0}``, the batches
    ``{"inputs", "labels"}``. With ``masks`` the gradients of
    pruned weights are zeroed and the weights masked after the update, so
    the pruned architecture survives any optimizer."""

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        with torch.enable_grad():
            p = tree_map(lambda w: w.detach().requires_grad_(True),
                         state["params"])
            loss = model.train_loss(p, batch)
            leaves = [w for _, w in tree_items(p)]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(w) if g is None else g
                   for w, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), p)
        with torch.no_grad():
            if masks is not None:
                grads = mask_gradients(grads, masks)
            gnorm, scale = clip_scale(tree_leaves(grads), grad_clip)
            grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
            updates, opt = optimizer.update(grads, state["opt"],
                                            state["params"])
            params = tree_map(
                lambda w, u: (w.to(torch.float32) + u).to(w.dtype),
                state["params"], updates)
            if masks is not None:
                params = apply_mask(params, masks)
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
