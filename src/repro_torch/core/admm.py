"""The ADMM engine (paper section IV-C, Algorithm 1; mirrors
``repro/core/admm.py``).

Generic over the loss (layer-wise distillation, whole-model distillation,
or a task loss for the ADMM-dagger baseline) and over the projection (any
scheme of ``core.projections``). Iteration k (Eqn. 7):

  Primal    W^k := argmin_W loss(W) + rho/2 ||W - Z^{k-1} + U^{k-1}||^2,
            one (or ``primal_steps``) SGD step
  Proximal  Z^k := Pi_S(W^k + U^{k-1}), the exact projection
  Dual      U^k := U^{k-1} + W^k - Z^k

Each step is a plain function over parameter trees. The arithmetic is
fp32, rounded back to each leaf's dtype, as the reference's is; the primal
step takes its gradient with autograd. Trees are never mutated: every
step returns new ones.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.optim import clip_scale
from repro_torch.utils.tree import tree_items, tree_leaves, tree_map


class ADMMVars(NamedTuple):
    """Auxiliary (Z) and dual (U) variables, congruent with the params."""

    z: Any
    u: Any


def admm_init(prunable: Any) -> ADMMVars:
    """Z^0 <- W^0, U^0 <- 0 (Algorithm 1)."""
    return ADMMVars(z=tree_map(lambda w: w.detach().clone(), prunable),
                    u=tree_map(torch.zeros_like, prunable))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    return _f32(x).square().sum()


def _total(terms) -> torch.Tensor:
    terms = list(terms)
    if not terms:
        return torch.zeros((), dtype=torch.float32)
    return sum(terms[1:], terms[0])


def augmented_penalty(prunable: Any, av: ADMMVars, rho,
                      specs: Any = None) -> torch.Tensor:
    """rho/2 * sum ||W - Z + U||_F^2, the differentiable ADMM regulariser.

    With ``specs`` (a tree of LayerSpec | None) only constrained leaves
    contribute: biases are optimised (Eqn. 8) but not constrained.
    """
    if specs is None:
        specs = tree_map(lambda _: True, prunable)
    terms = tree_leaves(tree_map(
        lambda spec, w, z, u: None if spec is None else _sum_sq(
            _f32(w) - _f32(z) + _f32(u)),
        specs, prunable, av.z, av.u))
    return 0.5 * rho * _total(terms)


GRAD_CLIP = 5.0     # global-norm clip for the primal SGD step


def primal_step(loss_fn: Callable[[Any, Any], torch.Tensor], prunable: Any,
                av: ADMMVars, batch: Any, *, lr, rho, specs: Any = None,
                grad_clip: float = GRAD_CLIP) -> Tuple[Any, torch.Tensor]:
    """One SGD step on problem (8), the loss plus the augmented penalty,
    its gradient clipped to global norm ``grad_clip`` (inert for a
    well-conditioned step; it keeps the un-normalised CNN activations'
    gradients from blowing up a fixed-lr step).

    Returns (new params, the scalar loss before the step).
    """
    with torch.enable_grad():
        w = tree_map(lambda x: x.detach().requires_grad_(True), prunable)
        loss = loss_fn(w, batch) + augmented_penalty(w, av, rho, specs)
        leaves = [x for _, x in tree_items(w)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    _, scale = clip_scale(grads, grad_clip)
    step = iter([(_f32(x.detach()) - lr * scale * _f32(g)).to(x.dtype)
                 for x, g in zip(leaves, grads)])
    return tree_map(lambda _: next(step), w), loss.detach()


def proximal_step(project_fn: Callable[[Any], Any], prunable: Any,
                  av: ADMMVars) -> ADMMVars:
    """Z^k := Pi_S(W^k + U^{k-1}), the exact Euclidean projection
    (Eqn. 11)."""
    wu = tree_map(lambda w, u: w + u.to(w.dtype), prunable, av.u)
    return ADMMVars(z=project_fn(wu), u=av.u)


def dual_step(prunable: Any, av: ADMMVars) -> ADMMVars:
    """U^k := U^{k-1} + W^k - Z^k."""
    u = tree_map(lambda u, w, z: (_f32(u) + _f32(w) - _f32(z)).to(u.dtype),
                 av.u, prunable, av.z)
    return ADMMVars(z=av.z, u=u)


def admm_iteration(loss_fn: Callable[[Any, Any], torch.Tensor],
                   project_fn: Callable[[Any], Any], prunable: Any,
                   av: ADMMVars, batch: Any, *, lr, rho,
                   primal_steps: int = 1, specs: Any = None
                   ) -> Tuple[Any, ADMMVars, torch.Tensor]:
    """One full ADMM iteration: primal x ``primal_steps``, proximal,
    dual."""
    loss = torch.zeros((), dtype=torch.float32)
    for _ in range(primal_steps):
        prunable, loss = primal_step(loss_fn, prunable, av, batch, lr=lr,
                                     rho=rho, specs=specs)
    av = proximal_step(project_fn, prunable, av)
    av = dual_step(prunable, av)
    return prunable, av, loss


def _ratio(num, den) -> torch.Tensor:
    return torch.sqrt(num / torch.clamp(den, min=1e-12))


def dual_residual(z_new: Any, z_old: Any, rho) -> torch.Tensor:
    """rho * ||Z^k - Z^{k-1}||_F / ||Z^k||_F, the normalised
    dual-feasibility residual (Boyd section 3.3)."""
    num = _total(tree_leaves(tree_map(
        lambda n, o: _sum_sq(_f32(n) - _f32(o)), z_new, z_old)))
    den = _total(_sum_sq(n) for n in tree_leaves(z_new))
    return rho * _ratio(num, den)


def primal_residual(prunable: Any, av: ADMMVars) -> torch.Tensor:
    """||W - Z||_F / ||W||_F, the standard ADMM convergence diagnostic."""
    num = _total(tree_leaves(tree_map(
        lambda w, z: _sum_sq(_f32(w) - _f32(z)), prunable, av.z)))
    den = _total(_sum_sq(w) for w in tree_leaves(prunable))
    return _ratio(num, den)
