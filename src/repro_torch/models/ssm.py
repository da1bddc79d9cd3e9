"""Recurrent sequence-mixing cells: mLSTM and sLSTM (xLSTM) and Mamba
(hymba) (mirrors ``repro/models/ssm.py``).

Each cell has a full-sequence form (training, prefill; with
``return_state`` the final recurrent state too) and a single-step decode
form over an explicit state. The reference scans time with ``lax.scan``;
here the scans are plain loops: mLSTM over chunks of ``chunk`` positions
(the chunkwise-parallel form with the paper's max-state stabilizers),
sLSTM and Mamba over time steps, grouped in chunks of ``chunk`` steps.
With autograd on, each chunk runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of a chunk body), so the backward pass
keeps one state per chunk. The recurrent states are fp32 in every
dtype; the conv state is kept in fp32 and cast to the activation dtype
where it is used, as in the reference.

Sequence lengths: a full-sequence call runs S positions in chunks of
``min(chunk, S)``, so S past ``chunk`` must be a multiple of it; each cell
raises ``ValueError`` on any other length, as the reference's fail.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init

F32 = torch.float32
CHUNK = 256


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


def _chunks(fn, carry, S: int, c: int):
    """Run ``fn(carry, i) -> (carry, out)`` for every chunk i of an
    S-position sequence -> (carry, [out per chunk]); each chunk under
    ``checkpoint`` when autograd is on."""
    outs = []
    for i in range(S // c):
        if torch.is_grad_enabled():
            carry, out = checkpoint(fn, carry, i, use_reentrant=False)
        else:
            carry, out = fn(carry, i)
        outs.append(out)
    return carry, outs


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


def _mlstm_up(params: dict, x: torch.Tensor):
    up = torch.matmul(x, params["w_up"])
    d_inner = up.shape[-1] // 2
    return up[..., :d_inner], up[..., d_inner:]


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
    wmat = torch.where(tri[None, :, :, None], torch.exp(dmat),
                       torch.zeros((), dtype=F32, device=qi.device))
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


def mlstm_apply(params: dict, x: torch.Tensor, *, num_heads: int,
                chunk: int = CHUNK, return_state: bool = False):
    """Chunkwise-parallel mLSTM over x (B, S, D) -> (B, S, D); with
    ``return_state`` also its final state {C, n, m, conv} (prefill)."""
    B, S, _ = x.shape
    c = check_length(S, chunk)
    xm, z = _mlstm_up(params, x)
    d_inner = xm.shape[-1]
    H, hd = num_heads, d_inner // num_heads
    xc = causal_conv1d(xm, params["conv_w"].to(F32).to(xm.dtype))
    xc = _silu_as(xc, xm.dtype)
    q = torch.matmul(xc, params["wq"]).reshape(B, S, H, hd)
    k = torch.matmul(xc, params["wk"]).reshape(B, S, H, hd)
    v = torch.matmul(xm, params["wv"]).reshape(B, S, H, hd)
    if_log = (torch.matmul(xc, params["w_if"])
              + params["b_if"][None, None, :]).to(F32)
    a = if_log[..., :H]                                        # log input gate
    f = F.logsigmoid(if_log[..., H:])                          # log forget gate
    scale = 1.0 / math.sqrt(hd)

    def body(state, i):
        sl = slice(i * c, (i + 1) * c)
        C, n, m, h = _mlstm_chunk(*state, q[:, sl], k[:, sl], v[:, sl],
                                  a[:, sl], f[:, sl], scale)
        return (C, n, m), h

    state0 = (torch.zeros((B, H, hd, hd), dtype=F32, device=x.device),
              torch.zeros((B, H, hd), dtype=F32, device=x.device),
              torch.zeros((B, H), dtype=F32, device=x.device))
    (Cf, nf, mf), hs = _chunks(body, state0, S, c)
    h = torch.cat(hs, dim=1).reshape(B, S, d_inner).to(x.dtype)
    hn = h * params["out_norm_scale"][None, None, :].to(h.dtype)
    out = torch.matmul(hn * _silu_as(z, h.dtype), params["w_down"])
    if not return_state:
        return out
    K = params["conv_w"].shape[0]
    return out, {"C": Cf, "n": nf, "m": mf,
                 "conv": xm[:, -(K - 1):, :].to(F32)}


def mlstm_step(params: dict, x_t: torch.Tensor, state: Dict[str, torch.Tensor],
               *, num_heads: int) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_t (B, D) -> (out (B, D), the new state)."""
    B = x_t.shape[0]
    xm, z = _mlstm_up(params, x_t)
    d_inner = xm.shape[-1]
    H, hd = num_heads, d_inner // num_heads
    conv_out, conv_state = causal_conv1d_step(
        xm, state["conv"].to(xm.dtype), params["conv_w"])
    xc = _silu_as(conv_out, xm.dtype)
    q = torch.matmul(xc, params["wq"]).reshape(B, H, hd)
    k = torch.matmul(xc, params["wk"]).reshape(B, H, hd)
    v = torch.matmul(xm, params["wv"]).reshape(B, H, hd)
    if_log = (torch.matmul(xc, params["w_if"])
              + params["b_if"][None, :]).to(F32)
    a = if_log[:, :H]
    f = F.logsigmoid(if_log[:, H:])

    C, n, m = state["C"], state["n"], state["m"]
    m_next = torch.maximum(f + m, a)                            # (B, H)
    decay = torch.exp(f + m - m_next)
    iw = torch.exp(a - m_next)
    kf = k.to(F32)
    C = C * decay[..., None, None] + iw[..., None, None] * (
        kf[..., :, None] * v.to(F32)[..., None, :])
    n = n * decay[..., None] + iw[..., None] * kf
    qs = q.to(F32) * (1.0 / math.sqrt(hd))
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n)),
                        torch.exp(-m_next))
    h = (num / den[..., None]).reshape(B, d_inner).to(x_t.dtype)
    hn = h * params["out_norm_scale"][None, :].to(h.dtype)
    out = torch.matmul(hn * _silu_as(z, h.dtype), params["w_down"])
    return out, {"C": C, "n": n, "m": m_next, "conv": conv_state.to(F32)}


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

    def body(st, i):
        hs = []
        for t in range(i * c, (i + 1) * c):
            st, h = _slstm_cell_pre(r, wx[:, t], st, num_heads)
            hs.append(h)
        return st, torch.stack(hs, dim=1)

    stf, hs = _chunks(body, slstm_state_init(B, D, x.device), S, c)
    h = torch.cat(hs, dim=1).to(x.dtype)
    out = torch.matmul(h, params["w_out"])
    return (out, stf) if return_state else out


def slstm_step(params: dict, x_t: torch.Tensor, state: dict, *,
               num_heads: int) -> Tuple[torch.Tensor, dict]:
    wx = (torch.matmul(x_t.to(F32), params["w_gates"].to(F32))
          + params["b_gates"].to(F32))
    st, h = _slstm_cell_pre(params["r_gates"].to(F32), wx, state, num_heads)
    return torch.matmul(h.to(x_t.dtype), params["w_out"]), st


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


def _mamba_scan_inputs(params: dict, xi: torch.Tensor):
    """xi (..., d_inner), post-conv -> B_t, C_t (..., N) and dt (..., 1),
    fp32 (dt through softplus after ``dt_bias``)."""
    bcdt = torch.matmul(xi, params["w_bcdt"]).to(F32)
    N = params["a_log"].shape[1]
    dt = F.softplus(bcdt[..., -1:] + params["dt_bias"])
    return bcdt[..., :N], bcdt[..., N:2 * N], dt


def _mamba_in(params: dict, x: torch.Tensor):
    up = torch.matmul(x, params["w_in"])
    d_inner = up.shape[-1] // 2
    return up[..., :d_inner], up[..., d_inner:]


def _mamba_out(params: dict, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor, dtype) -> torch.Tensor:
    y = y + xc.to(F32) * params["d_skip"]
    return torch.matmul(y.to(dtype) * _silu_as(z, dtype), params["w_out"])


def mamba_apply(params: dict, x: torch.Tensor, *, chunk: int = CHUNK,
                return_state: bool = False):
    """Selective SSM over x (B, S, D) -> (B, S, D) (with ``return_state``
    also its final state {h, conv}). Projections and conv run over S at
    once; the recurrence h = h * exp(dt A) + dt x B steps through chunks
    of ``chunk``, each chunk's decay and input terms formed at once."""
    B, S, _ = x.shape
    c = check_length(S, chunk)
    xin, z = _mamba_in(params, x)
    d_inner = xin.shape[-1]
    xc = _silu_as(causal_conv1d(xin, params["conv_w"]), x.dtype)
    B_t, C_t, dt = _mamba_scan_inputs(params, xc)           # (B, S, N), (B, S, 1)
    A = -torch.exp(params["a_log"])                          # (d_inner, N)
    xf = xc.to(F32)

    def body(h, i):
        sl = slice(i * c, (i + 1) * c)
        dA = torch.exp(dt[:, sl, :, None] * A)               # (B, c, d, N)
        dBx = (dt[:, sl] * xf[:, sl])[..., None] * B_t[:, sl, None, :]
        ys = []
        for t in range(c):
            h = h * dA[:, t] + dBx[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, C_t[:, i * c + t]))
        return h, torch.stack(ys, dim=1)

    h0 = torch.zeros((B, d_inner, params["a_log"].shape[1]), dtype=F32,
                     device=x.device)
    hf, ys = _chunks(body, h0, S, c)
    out = _mamba_out(params, torch.cat(ys, dim=1), xc, z, x.dtype)
    if not return_state:
        return out
    K = params["conv_w"].shape[0]
    return out, {"h": hf, "conv": xin[:, -(K - 1):, :].to(F32)}


def mamba_step(params: dict, x_t: torch.Tensor, state: dict
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step. x_t (B, D) -> (out (B, D), the new state)."""
    xin, z = _mamba_in(params, x_t)
    conv_out, conv_state = causal_conv1d_step(
        xin, state["conv"].to(xin.dtype), params["conv_w"])
    xc = _silu_as(conv_out, x_t.dtype)
    B_t, C_t, dt = _mamba_scan_inputs(params, xc)
    A = -torch.exp(params["a_log"])
    dA = torch.exp(dt[..., None] * A[None])                  # (B, d, N)
    dBx = (dt * xc.to(F32))[..., None] * B_t[:, None, :]
    h = state["h"] * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, C_t)
    return (_mamba_out(params, y, xc, z, x_t.dtype),
            {"h": h, "conv": conv_state.to(F32)})

