"""Common layers as plain functions on tensors (mirrors
``repro/models/layers.py``); initialisers draw from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.sparse.packed import PackedTensor
from repro_torch.sparse.registry import dispatch_matmul

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _dense_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                    activation: Optional[str]) -> torch.Tensor:
    """act(y + bias) for a product taken with raw (unpacked) weights: the
    epilogue runs in fp32 on the product already rounded to its dtype, and
    is rounded back, as the reference's ``_dense_epilogue`` does."""
    if bias is None and activation is None:
        return y
    if _local_ok(y, ()):
        return _local_epilogue(y, bias, activation)
    return apply_epilogue(y.to(torch.float32), bias, activation).to(y.dtype)


def _local_ok(x, whole: tuple) -> bool:
    """Is ``x`` a DTensor (no pending sums) whose dims ``whole`` each
    rank holds whole? Then a row-wise op can run on its local shard
    through ``local_map`` (one op for DTensor to place, not one per
    elementwise step; on a one-card mesh the same ops as on a plain
    tensor)."""
    from repro_torch.parallel.sharding import is_dtensor, sharded_dims

    if not is_dtensor(x) or any(p.is_partial() for p in x.placements):
        return False
    return not any(d % x.ndim in sharded_dims(x) for d in whole)


def _local_epilogue(y, bias, activation):
    """``_dense_epilogue`` on y's local shard; the bias split as y's
    feature dim is, its gradient summed over the axes y's rows are split
    on."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    last = y.ndim - 1
    y_pl = list(y.placements)
    b_pl = [Shard(0) if p.is_shard(last) else Replicate() for p in y_pl]
    b_grad = [Shard(0) if p.is_shard(last) else Partial() if p.is_shard()
              else Replicate() for p in y_pl]

    def fn(t, b=None):
        return apply_epilogue(t.to(torch.float32), b, activation).to(t.dtype)

    args, ins, grads = (y,), (y_pl,), (y_pl,)
    if bias is not None:
        args, ins, grads = (y, bias), (y_pl, b_pl), (y_pl, b_grad)
    return local_map(fn, out_placements=y_pl, in_placements=ins,
                     in_grad_placements=grads, device_mesh=y.device_mesh,
                     redistribute_inputs=True)(*args)


def dense_apply(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w + bias) for a dense tensor OR a ``PackedTensor``.

    Packed weights run the packed kernel, whose epilogue adds the bias to
    the fp32 accumulator. Dense weights follow the reference exactly:
    the product is taken and rounded in the parameter dtype, and only then
    is the epilogue applied in fp32 and rounded again.
    """
    if isinstance(w, PackedTensor):
        lead = x.shape[:-1]
        y = dispatch_matmul(x.reshape(-1, x.shape[-1]), w, bias=bias,
                            activation=activation)
        return y.reshape(lead + (y.shape[-1],))
    return _dense_epilogue(torch.matmul(x, w), bias, activation)


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, stored in ``dtype``."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm, rotary embeddings, FFN
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if _local_ok(x, (-1,)):
        return _local_rmsnorm(params["scale"], x, eps)
    return _rmsnorm(params["scale"], x, eps)


def _rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float
             ) -> torch.Tensor:
    # a view of x (free) even in fp32, where ``to`` returns x itself: the
    # gradients of xf's two uses are summed before they meet x's other
    # uses (the residual), as they are when this runs on a DTensor's
    # local shard; so a one-card mesh rounds exactly as no mesh does
    xf = x.to(torch.float32).view_as(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def _local_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """``_rmsnorm`` of a DTensor whose feature dim is whole on each rank:
    run on its local shard (one op for DTensor to place, not eight); the
    replicated scale's gradient is a partial sum over the axes x is
    split on."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    x_pl = tuple(x.placements)
    repl = [Replicate()] * len(x_pl)
    grad = [Partial() if p.is_shard() else Replicate() for p in x_pl]
    return local_map(lambda s, t: _rmsnorm(s, t, eps),
                     out_placements=list(x_pl), in_placements=(repl, x_pl),
                     in_grad_placements=(grad, x_pl),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(scale, x)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies (head_dim // 2,) fp32 (built on the device, with
    no host-to-device copy, so a CUDA graph can capture it)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exponents)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape (..., S, 1, hd/2) for ``apply_rope_tables``."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs
    angles = angles[..., None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rope_tables(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
                      ) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim), split-half convention."""
    if _local_ok(x, (-1, -3)) and sin.ndim < x.ndim:   # tables of S rows
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        x_pl = list(x.placements)
        repl = [Replicate()] * len(x_pl)
        return local_map(_rope, out_placements=x_pl,
                         in_placements=(x_pl, repl, repl),
                         in_grad_placements=(x_pl, repl, repl),
                         device_mesh=x.device_mesh,
                         redistribute_inputs=True)(x, sin, cos)
    return _rope(x, sin, cos)


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
          ) -> torch.Tensor:
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, ffn_type: str,
             dtype, device) -> dict:
    if ffn_type == "swiglu":
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
                "w_up": dense_init(gen, d_model, d_ff, dtype, device),
                "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def ffn_apply(params: dict, x: torch.Tensor, ffn_type: str) -> torch.Tensor:
    """FFN with the activation fused into the producing GEMM's epilogue."""
    if ffn_type == "swiglu":
        gate = dense_apply(x, params["w_gate"], activation="silu")
        h = gate * dense_apply(x, params["w_up"])
    else:
        h = dense_apply(x, params["w_up"], activation="gelu")
    return dense_apply(h, params["w_down"])
