"""Recurrent sequence-mixing cells: mLSTM and sLSTM (xLSTM) and Mamba
(hymba) (mirrors ``repro/models/ssm.py``).

Each cell has a full-sequence form (training, prefill; with
``return_state`` the final recurrent state too) and a single-step decode
form over an explicit state. The reference scans time with ``lax.scan``;
here the scans are plain loops: mLSTM over chunks of ``chunk`` positions
(the chunkwise-parallel form with the paper's max-state stabilizers),
sLSTM and Mamba over time steps, grouped in chunks of ``chunk`` steps.
Each chunk is one call of ``scan_chunk``: with autograd on, its backward
recomputes it (the reference's ``jax.checkpoint`` of a chunk body), so
the backward pass keeps one state per chunk. The recurrent states are
fp32 in every dtype; the conv state is kept in fp32 and cast to the
activation dtype where it is used, as in the reference.

Under axis rules (``parallel/sharding.py``) the GEMMs around each cell
are DTensor ops and everything between them runs on each rank's local
shards (``local_call``): the convs and Mamba's scan split over the batch
and the channels (their recurrences are per channel), the mLSTM over the
batch and its heads where the heads divide the model axis (else heads
whole and the batch over every axis), the sLSTM over the batch on every
axis (its recurrent gates mix a head's channels across the four
gates). A decode step's state is placed as its cache is: an xLSTM's
whole on every rank, Mamba's split over the batch, as the reference's
cache specs place them.

Sequence lengths: a full-sequence call runs S positions in chunks of
``min(chunk, S)``, so S past ``chunk`` must be a multiple of it; each cell
raises ``ValueError`` on any other length, as the reference's fail.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.parallel.sharding import (
    constrain,
    current_rules,
    local_call,
    merge_dims,
    mesh_axis_sizes,
    split_dim,
)
from repro_torch.roofline.step_costs import replayable

F32 = torch.float32
CHUNK = 256

# logical axes of the cells' activations (B, S, channels)
ROWS = ("batch", None, "mlp")


def _row_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), a cell's input or output GEMM. Under axis
    rules K is split over the model axis (x's features, w's rows) and
    each rank takes its share of the contraction on its local shards:
    the product is a partial sum over the model axis (Megatron's
    row-parallel GEMM; left to DTensor, these GEMMs' backward took
    minutes to plan on a 3-D mesh)."""
    lead = ("batch",) + (None,) * (x.ndim - 2)
    return local_call(torch.matmul, [(x, lead + ("mlp",)), (w, ("mlp", None))],
                      [(lead + (None,), tuple(x.shape[:-1]) + (w.shape[1],),
                        "mlp")])


def _silu_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu in fp32, rounded to ``dtype``."""
    return F.silu(x.to(F32)).to(dtype)


def check_length(S: int, chunk: int = CHUNK) -> int:
    """The chunk length of an S-position sequence, ``min(chunk, S)``;
    ``ValueError`` when it does not divide S (the reference's mLSTM raises
    there, its sLSTM and Mamba fail in a reshape)."""
    c = min(chunk, S)
    if S % c != 0:
        raise ValueError(f"S={S} % chunk={c} != 0")
    return c


def chunk_backward(fn, consts: tuple, tensors, need, grads) -> tuple:
    """The gradients of one chunk's inputs (None where ``need`` is
    false) from its outputs' ``grads`` (None where none flows), the
    chunk recomputed with autograd on."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
        outs = fn(*xs, *consts)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x in xs if x.requires_grad]
        got = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True)
               if pairs and wrt else [None] * len(wrt))
    it = iter(got)
    return tuple(next(it) if n else None for n in need)


class _Chunk(torch.autograd.Function):
    """One chunk that keeps only its inputs for the backward pass, which
    recomputes it (``chunk_backward``)."""

    @staticmethod
    def forward(ctx, fn, consts, *tensors):
        ctx.fn, ctx.consts = fn, consts
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        return replayable("scan", fn, *[t.detach() for t in tensors],
                          *consts)

    @staticmethod
    def backward(ctx, *grads):
        tensors = [t.detach() for t in ctx.saved_tensors]
        return (None, None) + replayable(
            "scan", chunk_backward, ctx.fn, ctx.consts, tensors,
            ctx.needs_input_grad[2:], grads)


def scan_chunk(fn, consts: tuple, *tensors):
    """``fn(*tensors, *consts)`` -> its outputs; through ``_Chunk`` when
    autograd is on and an input needs a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Chunk.apply(fn, consts, *tensors)
    return replayable("scan", fn, *tensors, *consts)


def _chunks(fn, carry: tuple, seqs: tuple, c: int, fixed: tuple = (),
            consts: tuple = ()):
    """Run ``fn(*carry, *chunk of each of seqs, *fixed, *consts) ->
    (*carry, out)`` over every chunk of ``c`` positions of the (B, S,
    ...) tensors ``seqs`` -> (carry, [out per chunk])."""
    outs = []
    for i in range(seqs[0].shape[1] // c):
        sl = slice(i * c, (i + 1) * c)
        *carry, out = scan_chunk(fn, consts, *carry,
                                 *[x[:, sl] for x in seqs], *fixed)
        outs.append(out)
    return tuple(carry), outs


# ---------------------------------------------------------------------------
# causal depthwise conv (mLSTM and Mamba)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D), w (K, D): depthwise causal conv along S, ``w[K - 1]``
    multiplying the current step (``causal_conv1d_step``'s window layout
    [oldest, ..., current])."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k][None, None, :]
    return out


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t (B, D), conv_state (B, K - 1, D) -> (out (B,
    D), the new window's last K - 1 steps)."""
    K = w.shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, D)
    out = torch.einsum("bkd,kd->bd", window, w)
    return out, (window[:, -(K - 1):, :] if K > 1 else conv_state)


def _conv_silu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """silu(causal_conv1d(x, w)) rounded to x's dtype; under axis rules
    on each rank's rows and channels."""
    return local_call(lambda t, k: _silu_as(causal_conv1d(t, k), t.dtype),
                      [(x, ROWS), (w, (None, "mlp"))], [(ROWS, x.shape)])


def _conv_silu_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                    w: torch.Tensor, rows: tuple):
    """One decode step of ``_conv_silu`` -> (silu(out) in x_t's dtype,
    the new conv window, fp32); the state placed by ``rows`` (its
    leading dims) under axis rules."""
    def step(t, s, k):
        out, window = causal_conv1d_step(t, s.to(t.dtype), k)
        return _silu_as(out, t.dtype), window.to(F32)

    st_ax = (rows[0], None, rows[1])
    return local_call(step, [(x_t, rows), (conv_state, st_ax),
                             (w, (None, None))],
                      [(rows, x_t.shape), (st_ax, conv_state.shape)])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, d_model: int, num_heads: int,
               head_dim: int, conv_kernel: int, dtype, device) -> dict:
    """mLSTM block: up-projection (x | z), conv, q/k/v, the input and
    forget gate logits, down-projection, output norm scale."""
    d_inner = num_heads * head_dim
    conv = torch.randn((conv_kernel, d_inner), generator=gen, dtype=F32,
                       device=device) * 0.1
    return {
        "w_up": dense_init(gen, d_model, 2 * d_inner, dtype, device),
        "conv_w": conv.to(dtype),
        "wq": dense_init(gen, d_inner, d_inner, dtype, device),
        "wk": dense_init(gen, d_inner, d_inner, dtype, device),
        "wv": dense_init(gen, d_inner, d_inner, dtype, device),
        "w_if": dense_init(gen, d_inner, 2 * num_heads, dtype, device),
        "b_if": torch.cat([torch.zeros((num_heads,), dtype=F32,
                                       device=device),
                           torch.linspace(3.0, 6.0, num_heads, dtype=F32,
                                          device=device)]).to(dtype),
        "w_down": dense_init(gen, d_inner, d_model, dtype, device),
        "out_norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def _in_halves(x: torch.Tensor, w: torch.Tensor):
    """The halves (x | z) of a cell's input projection x @ w, each split
    over the model axis on its channels under axis rules (the residual's
    features are split there: a row-parallel GEMM, then its halves
    reduce-scattered)."""
    up = _row_gemm(x, w)
    d_inner = up.shape[-1] // 2
    rows = ("batch",) + (None,) * (x.ndim - 2) + ("mlp",)
    return (constrain(up[..., :d_inner], rows),
            constrain(up[..., d_inner:], rows))


def _mlstm_up(params: dict, x: torch.Tensor):
    return _in_halves(x, params["w_up"])


def _mlstm_chunk(C, n, m, qi, ki, vi, ai, fi, scale: float):
    """One chunk of the chunkwise-parallel mLSTM: the state (C, n, m) at
    its start and the chunk's q, k, v (B, c, H, hd) and log gates a, f
    (B, c, H) -> (C, n, m at its end, h (B, c, H, hd) fp32)."""
    c = qi.shape[1]
    b = torch.cumsum(fi, dim=1)                                # (B, c, H)
    btot = b[:, -1, :]
    m_inter = b + m[:, None, :]
    m_intra = b + torch.cummax(ai - b, dim=1).values
    m_t = torch.maximum(m_inter, m_intra)
    dmat = (b[:, :, None, :] - b[:, None, :, :] + ai[:, None, :, :]
            - m_t[:, :, None, :])                              # (B, t, s, H)
    tri = torch.ones((c, c), dtype=torch.bool, device=qi.device).tril()
    # exp of the masked exponents, not a mask of their exp: above the
    # diagonal dmat grows with the chunk's forget sums (past 88 once a
    # head forgets at f = log 0.5 over 128 steps), exp overflows there,
    # and where(tri, exp(dmat), 0) differentiates to 0 * inf = NaN (the
    # reference's form does). The values are the same: exp(-inf) = 0.
    wmat = torch.exp(torch.where(tri[None, :, :, None], dmat, -math.inf))
    scores = torch.einsum("bthd,bshd->btsh", qi.to(F32), ki.to(F32)) * scale
    pw = scores * wmat
    h_intra = torch.einsum("btsh,bshd->bthd", pw.to(vi.dtype).to(F32),
                           vi.to(F32))
    n_intra = pw.sum(dim=2)                                    # (B, t, H)
    inter_scale = torch.exp(b + m[:, None, :] - m_t)
    qs = qi.to(F32) * scale
    h_inter = torch.einsum("bthd,bhde->bthe", qs, C) * inter_scale[..., None]
    n_inter = torch.einsum("bthd,bhd->bth", qs, n) * inter_scale
    denom = torch.maximum(torch.abs(n_intra + n_inter), torch.exp(-m_t))
    h = (h_intra + h_inter) / denom[..., None]
    m_next = torch.maximum(m + btot, torch.max(
        ai + btot[:, None, :] - b, dim=1).values)
    decay = torch.exp(m + btot - m_next)
    kw = torch.exp(ai + btot[:, None, :] - b - m_next[:, None, :])
    kf = ki.to(F32) * kw[..., None]
    C_next = C * decay[..., None, None] + torch.einsum(
        "bchd,bche->bhde", kf, vi.to(F32))
    n_next = n * decay[..., None] + kf.sum(dim=1)
    return C_next, n_next, m_next, h


def _mlstm_core(q, k, v, gates, c: int, scale: float):
    """The chunkwise recurrence of q, k, v (B, S, H, hd) and the gate
    logits (B, S, 2, H) (input | forget) from a zero state -> (C, n, m,
    h (B, S, H, hd) fp32)."""
    B, S, H, hd = q.shape
    a = gates[:, :, 0]                                     # log input gate
    f = F.logsigmoid(gates[:, :, 1])                       # log forget gate
    state0 = (torch.zeros((B, H, hd, hd), dtype=F32, device=q.device),
              torch.zeros((B, H, hd), dtype=F32, device=q.device),
              torch.zeros((B, H), dtype=F32, device=q.device))
    (Cf, nf, mf), hs = _chunks(_mlstm_chunk, state0, (q, k, v, a, f), c,
                               consts=(scale,))
    return Cf, nf, mf, torch.cat(hs, dim=1)


def _mlstm_qkv(params: dict, xc: torch.Tensor, xm: torch.Tensor, H: int):
    """q, k, v (..., H, hd) and the gate logits (..., 2, H) fp32 of the
    conv output ``xc`` and the up-projection ``xm``."""
    hd = xm.shape[-1] // H
    last = xm.ndim - 1
    q = split_dim(torch.matmul(xc, params["wq"]), last, (H, hd))
    k = split_dim(torch.matmul(xc, params["wk"]), last, (H, hd))
    v = split_dim(torch.matmul(xm, params["wv"]), last, (H, hd))
    if_log = (torch.matmul(xc, params["w_if"]) + params["b_if"]).to(F32)
    return q, k, v, split_dim(if_log, last, (2, H))


def _mlstm_split(H: int) -> Tuple[str, Optional[str]]:
    """(batch axis, heads axis) of the mLSTM core under the active rules:
    heads on the model axis where they divide it, else whole, the batch
    split over every axis (each rank its own rows' heads, as attention
    runs such heads)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return "batch", "heads"
    tp = mesh_axis_sizes(rules.mesh).get(rules.lookup("heads"), 1)
    return ("batch", "heads") if H % tp == 0 else ("attn_batch", None)


def mlstm_apply(params: dict, x: torch.Tensor, *, num_heads: int,
                chunk: int = CHUNK, return_state: bool = False):
    """Chunkwise-parallel mLSTM over x (B, S, D) -> (B, S, D); with
    ``return_state`` also its final state {C, n, m, conv} (prefill)."""
    B, S, _ = x.shape
    c = check_length(S, chunk)
    xm, z = _mlstm_up(params, x)
    H, hd = num_heads, xm.shape[-1] // num_heads
    xc = _conv_silu(xm, params["conv_w"].to(F32).to(xm.dtype))
    q, k, v, gates = _mlstm_qkv(params, xc, xm, H)
    scale = 1.0 / math.sqrt(hd)
    b, hx = _mlstm_split(H)
    Cf, nf, mf, h = local_call(
        lambda *t: _mlstm_core(*t, c, scale),
        [(q, (b, None, hx, None)), (k, (b, None, hx, None)),
         (v, (b, None, hx, None)), (gates, (b, None, None, hx))],
        [((b, hx, None, None), (B, H, hd, hd)), ((b, hx, None), (B, H, hd)),
         ((b, hx), (B, H)), ((b, None, hx, None), (B, S, H, hd))])
    h = merge_dims(h, 2).to(x.dtype)
    hn = h * params["out_norm_scale"][None, None, :].to(h.dtype)
    out = _row_gemm(hn * _silu_as(z, h.dtype), params["w_down"])
    if not return_state:
        return out
    K = params["conv_w"].shape[0]
    return out, {"C": Cf, "n": nf, "m": mf,
                 "conv": xm[:, -(K - 1):, :].to(F32)}


def _mlstm_step_core(q, k, v, gates, C, n, m):
    """One step of the recurrence from state (C, n, m) -> (h (B, H, hd)
    fp32, C, n, m)."""
    a = gates[:, 0]
    f = F.logsigmoid(gates[:, 1])
    m_next = torch.maximum(f + m, a)                            # (B, H)
    decay = torch.exp(f + m - m_next)
    iw = torch.exp(a - m_next)
    kf = k.to(F32)
    C = C * decay[..., None, None] + iw[..., None, None] * (
        kf[..., :, None] * v.to(F32)[..., None, :])
    n = n * decay[..., None] + iw[..., None] * kf
    qs = q.to(F32) * (1.0 / math.sqrt(q.shape[-1]))
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n)),
                        torch.exp(-m_next))
    return num / den[..., None], C, n, m_next


def mlstm_step(params: dict, x_t: torch.Tensor, state: Dict[str, torch.Tensor],
               *, num_heads: int) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_t (B, D) -> (out (B, D), the new state). Under
    axis rules the state is whole on every rank, as its cache is."""
    xm, z = _mlstm_up(params, x_t)
    H = num_heads
    whole = (None, None)
    xc, conv_state = _conv_silu_step(xm, state["conv"], params["conv_w"],
                                     whole)
    q, k, v, gates = _mlstm_qkv(params, xc, xm, H)
    h, C, n, m = local_call(
        _mlstm_step_core,
        [(q, (None,) * 3), (k, (None,) * 3), (v, (None,) * 3),
         (gates, (None,) * 3), (state["C"], (None,) * 4),
         (state["n"], (None,) * 3), (state["m"], whole)],
        [((None,) * 3, tuple(q.shape)), ((None,) * 4, state["C"].shape),
         ((None,) * 3, state["n"].shape), (whole, state["m"].shape)])
    h = merge_dims(h, 1).to(x_t.dtype)
    hn = h * params["out_norm_scale"][None, :].to(h.dtype)
    out = torch.matmul(hn * _silu_as(z, h.dtype), params["w_down"])
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, d_model: int, num_heads: int, dtype,
               device) -> dict:
    """sLSTM block: input gates (i, f, z, o), block-diagonal recurrent
    gates per head (H, hd, 4 hd), gate biases (forget bias 3), output."""
    hd = d_model // num_heads
    r = torch.randn((num_heads, hd, 4 * hd), generator=gen, dtype=F32,
                    device=device) / math.sqrt(hd)
    z = lambda n: torch.zeros((n,), dtype=F32, device=device)
    return {
        "w_gates": dense_init(gen, d_model, 4 * d_model, dtype, device),
        "r_gates": r.to(dtype),
        "b_gates": torch.cat([z(d_model), torch.full((d_model,), 3.0,
                                                     dtype=F32, device=device),
                              z(2 * d_model)]).to(dtype),
        "w_out": dense_init(gen, d_model, d_model, dtype, device),
    }


def slstm_state_init(batch: int, d_model: int, device) -> dict:
    z = lambda: torch.zeros((batch, d_model), dtype=F32, device=device)
    return {"c": z(), "h": z(), "n": z(),
            "m": torch.full((batch, d_model), -1e30, dtype=F32,
                            device=device)}


def _slstm_cell_pre(r_gates: torch.Tensor, wx_t: torch.Tensor, st: dict,
                    num_heads: int):
    """One sLSTM step given its input term ``wx_t = x_t @ W + b`` (B, 4D)
    fp32, hoisted out of the time loop: only h_{t-1} . R stays inside.
    ``r_gates``: the recurrent gates in fp32."""
    B, D = wx_t.shape[0], wx_t.shape[1] // 4
    hprev = st["h"].reshape(B, num_heads, D // num_heads)
    rec = torch.einsum("bhd,hde->bhe", hprev, r_gates).reshape(B, 4 * D)
    i_log, f_log, z_in, o_in = torch.split(wx_t + rec, D, dim=-1)
    f_log = F.logsigmoid(f_log)
    m_new = torch.maximum(f_log + st["m"], i_log)
    i_g = torch.exp(i_log - m_new)
    f_g = torch.exp(f_log + st["m"] - m_new)
    c = f_g * st["c"] + i_g * torch.tanh(z_in)
    n = f_g * st["n"] + i_g
    h = torch.sigmoid(o_in) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "h": h, "n": n, "m": m_new}, h


def _slstm_chunk(c_, h_, n_, m_, wx_c, r, num_heads: int):
    """The sLSTM steps of one chunk's input terms wx_c (B, c, 4D) from
    state (c, h, n, m) -> (c, h, n, m, h per step (B, c, D))."""
    st = {"c": c_, "h": h_, "n": n_, "m": m_}
    hs = []
    for t in range(wx_c.shape[1]):
        st, h = _slstm_cell_pre(r, wx_c[:, t], st, num_heads)
        hs.append(h)
    return st["c"], st["h"], st["n"], st["m"], torch.stack(hs, dim=1)


def _slstm_core(wx: torch.Tensor, r: torch.Tensor, num_heads: int, c: int):
    """The recurrence over wx (B, S, 4D) from the initial state -> (h (B,
    S, D), c, h, n, m)."""
    B, D = wx.shape[0], wx.shape[2] // 4
    st = slstm_state_init(B, D, wx.device)
    carry, hs = _chunks(_slstm_chunk, tuple(st[k] for k in "chnm"), (wx,),
                        c, fixed=(r,), consts=(num_heads,))
    return (torch.cat(hs, dim=1),) + carry


def slstm_apply(params: dict, x: torch.Tensor, *, num_heads: int,
                chunk: int = CHUNK, return_state: bool = False):
    """Sequential sLSTM over x (B, S, D) -> (B, S, D) (with
    ``return_state`` also its final state {c, h, n, m}): the input GEMM
    runs once over S, the recurrence steps through chunks of ``chunk``."""
    B, S, D = x.shape
    c = check_length(S, chunk)
    wx = (torch.einsum("bsd,df->bsf", x.to(F32), params["w_gates"].to(F32))
          + params["b_gates"].to(F32))                         # (B, S, 4D)
    r = params["r_gates"].to(F32)
    # the batch over every mesh axis: the gates mix a head's channels
    row = ("attn_batch", None)
    h, *st = local_call(
        lambda w, g: _slstm_core(w, g, num_heads, c),
        [(wx, row + (None,)), (r, (None, None, None))],
        [(row + (None,), (B, S, D))] + [(row, (B, D))] * 4)
    out = _row_gemm(h.to(x.dtype), params["w_out"])
    return (out, dict(zip("chnm", st))) if return_state else out


def slstm_step(params: dict, x_t: torch.Tensor, state: dict, *,
               num_heads: int) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_t (B, D) -> (out (B, D), the new state); under
    axis rules the state is whole on every rank, as its cache is."""
    wx = (torch.matmul(x_t.to(F32), params["w_gates"].to(F32))
          + params["b_gates"].to(F32))
    whole = (None, None)

    def step(w, r, *s):
        st, _ = _slstm_cell_pre(r, w, dict(zip("chnm", s)), num_heads)
        return tuple(st[k] for k in "chnm")

    st = local_call(step, [(wx, whole), (params["r_gates"].to(F32),
                                         (None,) * 3)]
                    + [(state[k], whole) for k in "chnm"],
                    [(whole, state[k].shape) for k in "chnm"])
    st = dict(zip("chnm", st))
    return torch.matmul(st["h"].to(x_t.dtype), params["w_out"]), st


# ---------------------------------------------------------------------------
# Mamba (selective SSM): hymba's parallel SSM heads
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, d_model: int, d_inner: int,
               ssm_state: int, conv_kernel: int, dtype, device) -> dict:
    """Mamba heads: in-projection (x | z), conv, the B / C / dt
    projection, fp32 decay logs, skip and dt bias, out-projection."""
    N = ssm_state
    conv = torch.randn((conv_kernel, d_inner), generator=gen, dtype=F32,
                       device=device) * 0.1
    a = torch.arange(1, N + 1, dtype=F32, device=device)[None, :]
    return {
        "w_in": dense_init(gen, d_model, 2 * d_inner, dtype, device),
        "conv_w": conv.to(dtype),
        "w_bcdt": dense_init(gen, d_inner, 2 * N + 1, dtype, device),
        "a_log": torch.log(a.repeat(d_inner, 1)),               # (d_inner, N)
        "d_skip": torch.ones((d_inner,), dtype=F32, device=device),
        "dt_bias": torch.full((1,), -4.0, dtype=F32, device=device),
        "w_out": dense_init(gen, d_inner, d_model, dtype, device),
    }


def _mamba_scan_inputs(bcdt: torch.Tensor, N: int,
                       dt_bias: torch.Tensor):
    """The B / C / dt projection's output (..., 2N + 1) -> B_t, C_t (...,
    N) and dt (..., 1), fp32 (dt through softplus after ``dt_bias``)."""
    bcdt = bcdt.to(F32)
    dt = F.softplus(bcdt[..., -1:] + dt_bias)
    return bcdt[..., :N], bcdt[..., N:2 * N], dt


def _mamba_bcdt(params: dict, xc: torch.Tensor) -> torch.Tensor:
    """xc @ w_bcdt, its contraction over the channels summed whole (under
    axis rules each rank holds its rows' whole projection)."""
    return constrain(_row_gemm(xc, params["w_bcdt"]),
                     ("batch",) + (None,) * (xc.ndim - 1))


def _mamba_in(params: dict, x: torch.Tensor):
    return _in_halves(x, params["w_in"])


def _mamba_out(params: dict, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor, dtype) -> torch.Tensor:
    y = y + xc.to(F32) * params["d_skip"]
    return _row_gemm(y.to(dtype) * _silu_as(z, dtype), params["w_out"])


def _mamba_chunk(h, dt_c, xf_c, B_c, C_c, A):
    """One chunk of the selective scan from state h (B, d, N): its decay
    and input terms formed at once, then stepped -> (h, y (B, c, d))."""
    dA = torch.exp(dt_c[:, :, :, None] * A)                  # (B, c, d, N)
    dBx = (dt_c * xf_c)[..., None] * B_c[:, :, None, :]
    ys = []
    for t in range(dt_c.shape[1]):
        h = h * dA[:, t] + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C_c[:, t]))
    return h, torch.stack(ys, dim=1)


def _mamba_core(bcdt, xc, a_log, dt_bias, c: int):
    """The scan over xc (B, S, d) with the B / C / dt projection bcdt (B,
    S, 2N + 1) from a zero state -> (y (B, S, d) fp32, the final h)."""
    B, _, d = xc.shape
    N = a_log.shape[1]
    B_t, C_t, dt = _mamba_scan_inputs(bcdt, N, dt_bias)  # (B, S, N), (B, S, 1)
    A = -torch.exp(a_log)                                    # (d_inner, N)
    h0 = torch.zeros((B, d, N), dtype=F32, device=xc.device)
    (hf,), ys = _chunks(_mamba_chunk, (h0,), (dt, xc.to(F32), B_t, C_t), c,
                        fixed=(A,))
    return torch.cat(ys, dim=1), hf


def mamba_apply(params: dict, x: torch.Tensor, *, chunk: int = CHUNK,
                return_state: bool = False):
    """Selective SSM over x (B, S, D) -> (B, S, D) (with ``return_state``
    also its final state {h, conv}). Projections and conv run over S at
    once; the recurrence h = h * exp(dt A) + dt x B steps through chunks
    of ``chunk``, each chunk's decay and input terms formed at once."""
    B, S, _ = x.shape
    c = check_length(S, chunk)
    xin, z = _mamba_in(params, x)
    d_inner, N = xin.shape[-1], params["a_log"].shape[1]
    xc = _conv_silu(xin, params["conv_w"])
    y, hf = local_call(
        lambda *t: _mamba_core(*t, c),
        [(_mamba_bcdt(params, xc), ("batch", None, None)), (xc, ROWS),
         (params["a_log"], ("mlp", None)), (params["dt_bias"], (None,))],
        [(ROWS, (B, S, d_inner)), (("batch", "mlp", None), (B, d_inner, N))])
    out = _mamba_out(params, y, xc, z, x.dtype)
    if not return_state:
        return out
    K = params["conv_w"].shape[0]
    return out, {"h": hf, "conv": xin[:, -(K - 1):, :].to(F32)}


def _mamba_step_core(bcdt, xc, h, a_log, dt_bias):
    """One step of the scan from state h (B, d, N) -> (y (B, d), h)."""
    B_t, C_t, dt = _mamba_scan_inputs(bcdt, a_log.shape[1], dt_bias)
    A = -torch.exp(a_log)
    dA = torch.exp(dt[..., None] * A[None])                  # (B, d, N)
    dBx = (dt * xc.to(F32))[..., None] * B_t[:, None, :]
    h = h * dA + dBx
    return torch.einsum("bdn,bn->bd", h, C_t), h


def mamba_step(params: dict, x_t: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_t (B, D) -> (out (B, D), the new state). Under
    axis rules the state is split over the batch, as its cache is."""
    xin, z = _mamba_in(params, x_t)
    rows = ("batch", None)
    xc, conv_state = _conv_silu_step(xin, state["conv"], params["conv_w"],
                                     rows)
    st_ax = ("batch", None, None)
    y, h = local_call(
        _mamba_step_core,
        [(_mamba_bcdt(params, xc), rows), (xc, rows), (state["h"], st_ax),
         (params["a_log"], (None, None)), (params["dt_bias"], (None,))],
        [(rows, tuple(xc.shape)), (st_ax, state["h"].shape)])
    return (_mamba_out(params, y, xc, z, x_t.dtype),
            {"h": h, "conv": conv_state})
