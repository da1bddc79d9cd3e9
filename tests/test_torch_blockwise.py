"""The port's ``blockwise_attention`` against the reference's.

The reference's training and fallback attention is a q-chunk online
softmax whose causal window visits only its band of kv chunks, with a
custom VJP that recomputes the score tiles from the forward's (m, l)
stats (``_flash_vjp``); its plain, AD-differentiated loop
(``_blockwise_qchunk``) is the oracle. The same numpy q / k / v and the
same output cotangent go through both packages on the CPU, fp32 at 2e-5:
outputs and dq / dk / dv, causal, causal windowed at S > window and
non-causal (with and without a window), GQA and MHA. The port's band is
counted: a windowed causal forward scores ``band`` kv chunks per q chunk,
not n, and its backward the same band in each pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro_torch.models import attention as att

TOL = 2e-5
B, S, HD, CHUNK = 2, 96, 16, 16          # n = 6 q chunks
WINDOW = 24                              # band = min(6, 23 // 16 + 2) = 3
CASES = {"causal": (True, None), "causal_window": (True, WINDOW),
         "bidirectional": (False, None),
         "bidirectional_window": (False, WINDOW)}
HEADS = {"gqa": (4, 2), "mha": (2, 2)}


def _inputs(H, KV, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    g = rng.standard_normal((B, S, H, HD), dtype=np.float32)
    return q, k, v, g


def _reference(fn, q, k, v, g, causal, window):
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal=causal,
                                          window=window, chunk=CHUNK,
                                          softmax_scale=None),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in (out, *vjp(jnp.asarray(g)))]


def _port(fn, q, k, v, g, causal, window, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts, causal=causal, window=window, chunk=CHUNK, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return [t.detach().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_and_gradients_match_reference(case, heads):
    causal, window = CASES[case]
    q, k, v, g = _inputs(*HEADS[heads])
    want = _reference(jatt.blockwise_attention, q, k, v, g, causal, window)
    got = _port(att.blockwise_attention, q, k, v, g, causal, window)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recompute_backward_matches_the_plain_loop(case):
    """The custom backward against autograd through the plain loop, in
    both packages' plain loops (``_blockwise_qchunk``); the port's plain
    loop visiting every kv chunk gives the banded output bit for bit."""
    causal, window = CASES[case]
    q, k, v, g = _inputs(4, 2, seed=1)
    oracle = _reference(jatt._blockwise_qchunk, q, k, v, g, causal, window)
    plain = _port(att._blockwise_qchunk, q, k, v, g, causal, window,
                  banded=False)
    got = _port(att.blockwise_attention, q, k, v, g, causal, window)
    for name, a, b, c in zip(("out", "dq", "dk", "dv"), got, plain, oracle):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
        np.testing.assert_allclose(a, c, rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[0], plain[0])


def test_bf16_output_matches_reference():
    causal, window = CASES["causal_window"]
    q, k, v, _ = _inputs(4, 2, seed=2)
    want = jatt.blockwise_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        window=window, chunk=CHUNK)
    got = att.blockwise_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal, window=window, chunk=CHUNK)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("case,forward,backward", [
    # n = 6, band 3: the forward and pass A score 6 x 3 tiles; pass B the
    # q chunks at and after each kv chunk, up to 3: 3+3+3+3+2+1
    ("causal_window", 18, 18 + 15),
    # every kv chunk; pass B under causality only the chunks after it
    ("causal", 36, 36 + 21),
    ("bidirectional_window", 36, 36 + 36),
])
def test_a_causal_window_visits_its_band(monkeypatch, case, forward,
                                         backward):
    causal, window = CASES[case]
    n = S // CHUNK
    band = att.kv_band(n, CHUNK, causal, window)
    assert band == (3 if case == "causal_window" else n)
    assert band == (min(n, (window - 1) // CHUNK + 2)
                    if window is not None and causal else n)
    calls = []
    real = att._scores
    monkeypatch.setattr(att, "_scores",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v, g = _inputs(4, 2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = att.blockwise_attention(*ts, causal=causal, window=window,
                                  chunk=CHUNK)
    assert len(calls) == forward
    torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert len(calls) == forward + backward


def test_training_forward_keeps_no_tile_residuals():
    """The backward recomputes: the graph saves q, k, v, out and the
    (m, l) stats, not one tensor per score tile."""
    q, k, v, _ = _inputs(4, 2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.shape) or t, lambda t: t):
        att.blockwise_attention(*ts, causal=True, window=WINDOW,
                                chunk=CHUNK)
    n = S // CHUNK
    assert sorted(map(tuple, saved)) == sorted(
        [(B, S, 4, HD), (B, S, 2, HD), (B, S, 2, HD), (B, S, 4, HD),
         (n, B, CHUNK, 2, 2), (n, B, CHUNK, 2, 2)])
