"""The port's recurrent cells (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``).

The reference's init (numpy leaves, carried across with
``convert.tensor_from_numpy``) and the same seeded numpy inputs go through
both packages on the CPU at the tiny sizes of ``tests/test_models.py``
(d_model 64, 4 heads of 16, conv kernel 4; mamba 4 x 16 with state 8):

- ``causal_conv1d`` and its decode step;
- ``mlstm_apply`` with and without ``return_state`` at S <= 256 (one
  chunk) and S = 512 (two chunks), ``mlstm_step``; ``slstm_apply`` /
  ``slstm_step``; ``mamba_apply`` / ``mamba_step``, in one chunk and in
  four of 8: fp32 within 2e-5, bf16 within 2e-2;
- each full-sequence form against S of the port's own steps, in three
  chunks of 8 (the chunk loop of the sLSTM and mamba forms);
- the lengths the reference refuses (S past 256, no multiple of it)
  raise ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import ssm

D, H, HD, K = 64, 4, 16, 4
MAMBA_INNER, N = 64, 8
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, atol):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _port(tree):
    return {k: tensor_from_numpy(np.asarray(v), torch.device("cpu"))
            for k, v in tree.items()}


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _cell(kind, dtype, seed=1):
    key = jax.random.PRNGKey(seed)
    if kind == "mlstm":
        p = jssm.mlstm_init(key, D, H, HD, K, JDT[dtype])
    elif kind == "slstm":
        p = jssm.slstm_init(key, D, H, JDT[dtype])
    else:
        p = jssm.mamba_init(key, D, MAMBA_INNER, N, K, JDT[dtype])
    return p, _port(jax.tree.map(np.asarray, p))


# ------------------------------------------------------------- causal conv

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_and_step(dtype):
    jx, x = _x((2, 9, D), dtype)
    jw, w = _x((K, D), dtype, seed=2)
    _close(ssm.causal_conv1d(x, w), jssm.causal_conv1d(jx, jw), TOL[dtype])
    jst, st = _x((2, K - 1, D), dtype, seed=3)
    got = ssm.causal_conv1d_step(x[:, 0], st, w)
    want = jssm.causal_conv1d_step(jx[:, 0], jst, jw)
    for g, t in zip(got, want):
        _close(g, t, TOL[dtype])


# ------------------------------------------------------------------ mLSTM

@pytest.mark.parametrize("S,dtype", [(32, "float32"), (512, "float32"),
                                     (32, "bfloat16")])
def test_mlstm_apply(S, dtype):
    jp, p = _cell("mlstm", dtype)
    jx, x = _x((2, S, D), dtype)
    with torch.no_grad():
        out = ssm.mlstm_apply(p, x, num_heads=H)
        out_s, st = ssm.mlstm_apply(p, x, num_heads=H, return_state=True)
    want_s, jst = jssm.mlstm_apply(jp, jx, num_heads=H, return_state=True)
    _close(out, jssm.mlstm_apply(jp, jx, num_heads=H), TOL[dtype])
    _close(out_s, want_s, TOL[dtype])
    _close(st, jst, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_step(dtype):
    jp, p = _cell("mlstm", dtype)
    jx, x = _x((2, 17, D), dtype)
    _, jst = jssm.mlstm_apply(jp, jx[:, :16], num_heads=H, return_state=True)
    st = {k: tensor_from_numpy(np.asarray(v), torch.device("cpu"))
          for k, v in jst.items()}
    with torch.no_grad():
        out, new = ssm.mlstm_step(p, x[:, 16], st, num_heads=H)
    want, jnew = jssm.mlstm_step(jp, jx[:, 16], jst, num_heads=H)
    _close(out, want, TOL[dtype])
    _close(new, jnew, TOL[dtype])


def test_mlstm_chunkwise_equals_sequential_steps():
    """The chunkwise form from the zero state (m = 0, the reference's
    initial stabilizer) against S steps of the recurrence."""
    _, p = _cell("mlstm", "float32")
    _, x = _x((2, 24, D), "float32")
    with torch.no_grad():
        full, fst = ssm.mlstm_apply(p, x, num_heads=H, chunk=8,
                                    return_state=True)
        st = {"C": torch.zeros(2, H, HD, HD), "n": torch.zeros(2, H, HD),
              "m": torch.zeros(2, H), "conv": torch.zeros(2, K - 1, H * HD)}
        outs = []
        for t in range(x.shape[1]):
            o, st = ssm.mlstm_step(p, x[:, t], st, num_heads=H)
            outs.append(o)
    _close(torch.stack(outs, 1), full, 2e-5)
    _close(st, fst, 2e-5)


# ------------------------------------------------------------------ sLSTM

@pytest.mark.parametrize("S,dtype", [(32, "float32"), (32, "bfloat16")])
def test_slstm_apply_and_step(S, dtype):
    jp, p = _cell("slstm", dtype)
    jx, x = _x((2, S + 1, D), dtype)
    with torch.no_grad():
        out, st = ssm.slstm_apply(p, x[:, :S], num_heads=H,
                                  return_state=True)
        step_out, new = ssm.slstm_step(p, x[:, S], st, num_heads=H)
    want, jst = jssm.slstm_apply(jp, jx[:, :S], num_heads=H,
                                 return_state=True)
    _close(out, want, TOL[dtype])
    _close(st, jst, TOL[dtype])
    jout, jnew = jssm.slstm_step(jp, jx[:, S], jst, num_heads=H)
    _close(step_out, jout, TOL[dtype])
    _close(new, jnew, TOL[dtype])
    with torch.no_grad():
        _close(ssm.slstm_apply(p, x[:, :S], num_heads=H),
               jssm.slstm_apply(jp, jx[:, :S], num_heads=H), TOL[dtype])
        # four chunks of 8: the chunk loop against the reference's
        _close(ssm.slstm_apply(p, x[:, :S], num_heads=H, chunk=8),
               jssm.slstm_apply(jp, jx[:, :S], num_heads=H, chunk=8),
               TOL[dtype])


def test_slstm_apply_equals_sequential_steps():
    _, p = _cell("slstm", "float32")
    _, x = _x((2, 24, D), "float32")
    with torch.no_grad():
        full, fst = ssm.slstm_apply(p, x, num_heads=H, chunk=8,
                                    return_state=True)
        st = ssm.slstm_state_init(2, D, torch.device("cpu"))
        outs = []
        for t in range(x.shape[1]):
            o, st = ssm.slstm_step(p, x[:, t], st, num_heads=H)
            outs.append(o)
    _close(torch.stack(outs, 1), full, 2e-5)
    _close(st, fst, 2e-5)


# ------------------------------------------------------------------ Mamba

@pytest.mark.parametrize("S,dtype", [(32, "float32"), (32, "bfloat16")])
def test_mamba_apply_and_step(S, dtype):
    jp, p = _cell("mamba", dtype)
    jx, x = _x((2, S + 1, D), dtype)
    with torch.no_grad():
        out, st = ssm.mamba_apply(p, x[:, :S], return_state=True)
        step_out, new = ssm.mamba_step(p, x[:, S], st)
    want, jst = jssm.mamba_apply(jp, jx[:, :S], return_state=True)
    _close(out, want, TOL[dtype])
    _close(st, jst, TOL[dtype])
    jout, jnew = jssm.mamba_step(jp, jx[:, S], jst)
    _close(step_out, jout, TOL[dtype])
    _close(new, jnew, TOL[dtype])
    with torch.no_grad():
        _close(ssm.mamba_apply(p, x[:, :S]), jssm.mamba_apply(jp, jx[:, :S]),
               TOL[dtype])
        _close(ssm.mamba_apply(p, x[:, :S], chunk=8),
               jssm.mamba_apply(jp, jx[:, :S], chunk=8), TOL[dtype])


def test_mamba_apply_equals_sequential_steps():
    _, p = _cell("mamba", "float32")
    _, x = _x((2, 24, D), "float32")
    with torch.no_grad():
        full, fst = ssm.mamba_apply(p, x, chunk=8, return_state=True)
        st = {"h": torch.zeros(2, MAMBA_INNER, N),
              "conv": torch.zeros(2, K - 1, MAMBA_INNER)}
        outs = []
        for t in range(x.shape[1]):
            o, st = ssm.mamba_step(p, x[:, t], st)
            outs.append(o)
    _close(torch.stack(outs, 1), full, 2e-5)
    _close(st, fst, 2e-5)


# ------------------------------------------------------- gradients, lengths

@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_gradients_match_reference(kind):
    """d(sum of outputs * r)/d(params, x) through the checkpointed
    chunks against ``jax.grad`` (two chunks of 8)."""
    jp, p = _cell(kind, "float32")
    jx, x = _x((2, 16, D), "float32")
    r = np.random.default_rng(4).standard_normal((2, 16, D)).astype(
        np.float32)
    kw = {} if kind == "mamba" else {"num_heads": H}
    jfn = {"mlstm": jssm.mlstm_apply, "slstm": jssm.slstm_apply,
           "mamba": jssm.mamba_apply}[kind]
    fn = getattr(ssm, f"{kind}_apply")
    jg = jax.grad(lambda pp, xx: jnp.sum(jfn(pp, xx, chunk=8, **kw) * r),
                  argnums=(0, 1))(jp, jx)
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    (fn(p, x, chunk=8, **kw) * torch.from_numpy(r)).sum().backward()
    _close(x.grad, jg[1], 1e-4)
    for k in p:
        _close(p[k].grad, jg[0][k], 1e-4)


def test_mlstm_gradients_where_a_chunk_forgets_fast():
    """Forget gates near 0.5 (the forget bias 0) over one chunk of 256:
    the chunk's masked exponents reach ≈ 177 above the diagonal, past
    fp32's exp. The reference's ``where(tri, exp(dmat), 0)`` then gives
    non-finite gradients (its fault, ROADMAP §3); the port's are finite
    and match the reference's own at chunk 32, whose exponents stay
    small (the chunkwise form is exact at any chunk length)."""
    jp, p = _cell("mlstm", "float32")
    bias = np.asarray(jp["b_if"]).copy()
    bias[H:] = 0.0
    jp = dict(jp, b_if=jnp.asarray(bias))
    p = dict(p, b_if=torch.from_numpy(bias))
    jx, x = _x((1, 256, D), "float32")
    r = np.random.default_rng(4).standard_normal((1, 256, D)).astype(
        np.float32)

    def jgrad(chunk):
        return jax.grad(lambda pp, xx: jnp.sum(jssm.mlstm_apply(
            pp, xx, num_heads=H, chunk=chunk) * r), argnums=(0, 1))(jp, jx)

    bad = jgrad(256)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(bad))
    want = jgrad(32)
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    (ssm.mlstm_apply(p, x, num_heads=H) * torch.from_numpy(r)).sum(
        ).backward()
    _close(x.grad, want[1], 1e-4)
    for k in p:
        assert torch.isfinite(p[k].grad).all(), k
        _close(p[k].grad, want[0][k], 1e-4)


@pytest.mark.parametrize("S", [300, 257, 600])
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_refused_lengths(kind, S):
    jp, p = _cell(kind, "float32")
    jx, x = _x((1, S, D), "float32")
    kw = {} if kind == "mamba" else {"num_heads": H}
    jfn = {"mlstm": jssm.mlstm_apply, "slstm": jssm.slstm_apply,
           "mamba": jssm.mamba_apply}[kind]
    with pytest.raises((ValueError, TypeError)):
        jfn(jp, jx, **kw)
    with pytest.raises(ValueError, match="chunk"):
        with torch.no_grad():
            getattr(ssm, f"{kind}_apply")(p, x, **kw)
