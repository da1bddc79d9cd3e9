"""Mixture-of-Experts layer: shared experts + routed top-k experts (mirrors
``repro/models/moe.py``).

  * qwen2-moe-a2.7b   — 4 shared + 60 routed, top-4
  * deepseek-moe-16b  — 2 shared + 64 routed, top-6

Capacity-based einsum dispatch over token groups: tokens are split into
groups of ``group_size`` and each expert takes at most C tokens of a
group, so dispatch and combine are (G, tg, E, C). An assignment past C is
dropped; slots are handed out token-major, then by k, so where a token
sits in its group decides whether it keeps its slot.

The routed experts are dense (E, D, F) / (E, F, D) leaves run by plain
einsums, as the reference runs them: no pruning scheme packs a 3-D leaf.
The shared SwiGLU goes through ``ffn_apply``, so its GEMMs run packed
when its leaves are. Every op has a fixed shape and none syncs with the
host, so a decode step with MoE layers captures into a CUDA graph.

Under axis rules the groups are split over the batch axes and each
rank routes its own groups on its local shards; the dispatch, expert
and combine einsums run there too, on each rank's slice of every
expert's width (experts replicated, ``expert_mlp`` on the model axis, as
the reference shards them), so their output is a partial sum over the
model axis. The auxiliary loss reduces its two means across the ranks
before their product.

Returns a Switch-style load-balancing auxiliary loss beside the output.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, ffn_apply, ffn_init
from repro_torch.parallel.sharding import local_call, replicate
from repro_torch.roofline.step_costs import replayable


def moe_init(gen: torch.Generator, d_model: int, num_experts: int,
             num_shared: int, expert_d_ff: int, dtype, device) -> dict:
    """Router (fp32 whatever ``dtype``), stacked experts, and the shared
    SwiGLU of width ``num_shared * expert_d_ff`` when ``num_shared``."""

    def stack_init(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype, device)
                            for _ in range(num_experts)])

    params = {
        "router": dense_init(gen, d_model, num_experts, torch.float32,
                             device),
        "experts": {"w_gate": stack_init(d_model, expert_d_ff),
                    "w_up": stack_init(d_model, expert_d_ff),
                    "w_down": stack_init(expert_d_ff, d_model)},
    }
    if num_shared:
        params["shared"] = ffn_init(gen, d_model, num_shared * expert_d_ff,
                                    "swiglu", dtype, device)
    return params


def _group_capacity(group_size: int, num_experts: int, top_k: int,
                    factor: float) -> int:
    cap = int(factor * group_size * top_k / num_experts)
    return max(8, ((cap + 7) // 8) * 8)


def sorted_top_k(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, in descending order, a tie going
    to the lower index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none, and the order decides the slot positions)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router: torch.Tensor, xt: torch.Tensor, k: int,
           capacity_factor: float):
    """Router, top-k and slot positions of a batch of groups ->
    (combine, dispatch (G, tg, E, C) in the activation dtype, fp32 probs
    (G, tg, E), the int32 one-hot choices (G, tg, k, E)).

    Under axis rules each rank routes its own groups (``route_local`` on
    its local shards): a group is a chunk of one batch row whose sequence
    is whole on the rank, so its slots are the unsharded run's."""
    G, tg, _ = xt.shape
    E = router.shape[1]
    C = _group_capacity(tg, E, k, capacity_factor)
    rows = ("batch", None, None, None)
    return local_call(
        lambda r, x: replayable("routing", route_local, r, x, k,
                                capacity_factor),
        [(router, (None, None)), (xt, ("batch", None, None))],
        [(rows, (G, tg, E, C)), (rows, (G, tg, E, C)),
         (("batch", None, None), (G, tg, E)), (rows, (G, tg, k, E))])


def route_local(router: torch.Tensor, xt: torch.Tensor, k: int,
                capacity_factor: float):
    """``_route`` on plain tensors."""
    G, tg, _ = xt.shape
    E = router.shape[1]
    logits = torch.einsum("gtd,de->gte", xt.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = sorted_top_k(probs, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    C = _group_capacity(tg, E, k, capacity_factor)
    # each (token, k) assignment's place in its expert's buffer, counted
    # over the group token-major, then by k
    sel = F.one_hot(gate_idx, num_classes=E).to(torch.int32)  # (G,tg,k,E)
    flat = sel.reshape(G, tg * k, E)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).reshape(
        G, tg, k, E)
    pos = (pos * sel).sum(dim=-1, dtype=torch.int32)          # (G, tg, k)
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    dt = xt.dtype
    combine = torch.zeros((G, tg, E, C), dtype=dt, device=xt.device)
    for j in range(k):
        oe = F.one_hot(gate_idx[..., j], num_classes=E).to(dt)
        oc = F.one_hot(torch.where(keep[..., j], pos[..., j], C).long(),
                       num_classes=C + 1).to(dt)[..., :-1]
        contrib = torch.einsum("gte,gtc->gtec", oe, oc)
        combine = combine + contrib * gate_vals[..., j, None, None].to(dt)
    dispatch = (combine != 0).to(dt)
    return combine, dispatch, probs, sel


def _dispatch(dispatch: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Tokens into the expert buffers -> (G, E, C, D)."""
    return torch.einsum("gtec,gtd->gecd", dispatch, xt)


def _experts(w: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its buffer, all experts batched."""
    gate = torch.einsum("gecd,edf->gecf", xe, w["w_gate"])
    up = torch.einsum("gecd,edf->gecf", xe, w["w_up"])
    h = F.silu(gate.to(torch.float32)).to(xe.dtype) * up
    return torch.einsum("gecf,efd->gecd", h, w["w_down"])


def _combine(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """Expert outputs back to the tokens, gate-weighted -> (G, tg, D)."""
    return torch.einsum("gtec,gecd->gtd", combine, ye)


def _moe_groups(params: dict, xt: torch.Tensor, *, top_k: int,
                capacity_factor: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped capacity dispatch of groups xt (G, tg, D) -> (y, aux)."""
    E = params["router"].shape[1]
    combine, dispatch, probs, sel = _route(params["router"], xt, top_k,
                                           capacity_factor)
    w = params["experts"]
    rows = ("batch", None, None, None)
    y = local_call(
        lambda c, d, x, wg, wu, wd: _combine(c, _experts(
            {"w_gate": wg, "w_up": wu, "w_down": wd}, _dispatch(d, x))),
        [(combine, rows), (dispatch, rows), (xt, ("batch", None, None)),
         (w["w_gate"], (None, None, "expert_mlp")),
         (w["w_up"], (None, None, "expert_mlp")),
         (w["w_down"], (None, "expert_mlp", None))],
        [(("batch", None, None), tuple(xt.shape), "expert_mlp")])
    if "shared" in params:
        y = y + ffn_apply(params["shared"], xt, "swiglu")
    # Switch-style auxiliary load-balancing loss: under axis rules each
    # mean is reduced across the ranks the groups are split over before
    # the product (a mean of per-rank products is another number)
    me = probs.mean(dim=(0, 1))
    fe = sel.to(torch.float32).sum(dim=2).mean(dim=(0, 1))
    return y, E * (me * fe).sum()


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 512,
              scan_tokens: int = 8192
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balancing loss, fp32).

    Groups are a batch row's chunks of ``min(group_size, S)`` positions.
    Past ``scan_tokens`` tokens a step the chunks run a step at a time
    (the reference's scan, which bounds the dispatch tensors); aux is
    then the mean of the steps'.
    """
    B, S, D = x.shape
    tg = min(group_size, S)
    if S % tg != 0:
        raise ValueError(f"S={S} not divisible by group_size {tg}")
    n_steps = S // tg
    chunks_per_step = max(1, scan_tokens // max(B * tg, 1))
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    if n_steps <= chunks_per_step:
        y, aux = _moe_groups(params, x.reshape(B * n_steps, tg, D), **kw)
        return y.reshape(B, S, D), aux
    if n_steps % chunks_per_step != 0:
        chunks_per_step = 1
    n_outer = n_steps // chunks_per_step
    xs = x.reshape(B, n_outer, chunks_per_step, tg, D)
    aux = replicate(torch.zeros((), dtype=torch.float32, device=x.device),
                    like=x)
    ys = []
    for i in range(n_outer):
        y, a = _moe_groups(params, xs[:, i].reshape(
            B * chunks_per_step, tg, D), **kw)
        aux = aux + a
        ys.append(y.reshape(B, chunks_per_step, tg, D))
    return torch.stack(ys, dim=1).reshape(B, S, D), aux / n_outer
