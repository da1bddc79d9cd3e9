"""The port's kernels against the JAX reference, on shared numpy inputs.

CPU tensors run each kernel's plain PyTorch version; it is held to the
reference's Pallas kernel (interpret mode) and its oracles. Tolerances are
the reference's own (``tests/test_kernels.py::_tol``): fp32 2e-5, bf16
2e-2. Packing is integer/selection work and must be bit-equal. The CUDA
kernels themselves are held to the plain versions in
``tests/test_torch_cuda.py``, which needs a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.projections import project_tile_pattern as j_project
from repro.kernels import epilogue as j_epi
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.pattern_gemm import pack_tile_pattern as j_pack
from repro.kernels.pattern_gemm import pack_tile_pattern_blocked as j_pack_blocked
from repro.models.attention import blockwise_attention as j_blockwise
from repro_torch.core.projections import project_tile_pattern as t_project
from repro_torch.kernels import epilogue as t_epi
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import pattern_gemm as t_pg
from repro_torch.sparse.registry import _tile_pack, _tile_to_dense
from repro_torch.core.schemes import LayerSpec

ACTS = (None, "relu", "silu", "gelu")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _pair(a: np.ndarray, name: str):
    """The same values in both frameworks (bf16 rounds identically)."""
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pruned(rng, Q, P, bp, name):
    """A tile-pattern-pruned (Q, P) weight, pruned by the reference."""
    w = rng.standard_normal((Q, P)).astype(np.float32) / np.sqrt(Q)
    jw, _ = _pair(w, name)
    return j_project(jw.T, block_p=bp).T


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("bp", [32, 64, 128])
def test_project_and_pack_bit_equal(bp, name):
    rng = np.random.default_rng(bp)
    w = rng.standard_normal((64, 2 * bp)).astype(np.float32)
    jw, tw = _pair(w, name)
    jp = j_project(jw.T, block_p=bp).T
    tp = t_project(tw.T, block_p=bp).T.contiguous()
    np.testing.assert_array_equal(_np(jp), _np(tp))
    for j_fn, t_fn in ((j_pack, t_pg.pack_tile_pattern),
                       (j_pack_blocked, t_pg.pack_tile_pattern_blocked)):
        jwp, jli = j_fn(jp, block_p=bp)
        twp, tli = t_fn(tp, block_p=bp)
        assert twp.dtype == DTYPES[name][1] and tli.dtype == torch.int32
        np.testing.assert_array_equal(_np(jwp), _np(twp))
        np.testing.assert_array_equal(np.asarray(jli), tli.numpy())
    pt = _tile_pack(tp, LayerSpec(scheme="tile_pattern", tile_block_p=bp))
    assert torch.equal(_tile_to_dense(pt), tp)


def test_projection_ties_keep_exactly_the_packed_lanes():
    """On an exact energy tie the port keeps ``keep`` lanes (the lower
    ones), so packing reproduces the pruned weight exactly; the reference
    keeps every tied lane, which its packer cannot store."""
    w = np.ones((64, 256), np.float32)           # (Q, P), every lane tied
    w[0::8] = 2.0                                # one clear winner per group
    tp = t_project(torch.from_numpy(w).T, block_p=128).T.contiguous()
    kept = (tp != 0).reshape(8, 8, 256).any(dim=2)       # (groups, lanes)
    assert kept.sum(dim=1).tolist() == [4] * 8
    assert kept[:, :4].all()
    pt = _tile_pack(tp, LayerSpec(scheme="tile_pattern", tile_block_p=128))
    assert torch.equal(_tile_to_dense(pt), tp)
    ref_kept = np.asarray(j_project(jnp.asarray(w.T), block_p=128)).T != 0
    assert ref_kept.reshape(8, 8, 256).any(axis=2).sum() == 64


@pytest.mark.parametrize("M", [1, 4, 33, 256])
@pytest.mark.parametrize("bp", [32, 64, 128])
def test_pattern_gemm_plain_matches_reference_fp32(bp, M):
    rng = np.random.default_rng(bp * 1000 + M)
    jw = _pruned(rng, 64, 2 * bp, bp, "float32")
    jwpb, jli = j_pack_blocked(jw, block_p=bp)
    twpb, tli = torch.from_numpy(np.array(jwpb)), torch.from_numpy(
        np.array(jli))
    jx, tx = _pair(rng.standard_normal((M, 64)).astype(np.float32), "float32")
    jb, tb = _pair(rng.standard_normal(2 * bp).astype(np.float32), "float32")
    for act in ACTS:
        want = j_ops.tile_pattern_matmul(jx, jwpb, jli, bias=jb,
                                         interpret=True, block_m=min(M, 128),
                                         activation=act)
        got = t_pg.pattern_gemm(tx, twpb, tli, tb, activation=act)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    oracle = j_ref.ref_pattern_gemm(jx, jw)
    np.testing.assert_allclose(_np(t_pg.pattern_gemm(tx, twpb, tli)),
                               _np(oracle), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("M", [4, 33])
@pytest.mark.parametrize("bp", [32, 64, 128])
def test_pattern_gemm_plain_matches_reference_bf16(bp, M):
    rng = np.random.default_rng(bp * 7 + M)
    jw = _pruned(rng, 64, 2 * bp, bp, "bfloat16")
    jwpb, jli = j_pack_blocked(jw, block_p=bp)
    twpb = torch.from_numpy(np.asarray(jwpb, np.float32)).to(torch.bfloat16)
    tli = torch.from_numpy(np.array(jli))
    jx, tx = _pair(rng.standard_normal((M, 64)).astype(np.float32),
                   "bfloat16")
    jb, tb = _pair(rng.standard_normal(2 * bp).astype(np.float32), "bfloat16")
    for act in ACTS:
        want = j_ops.tile_pattern_matmul(jx, jwpb, jli, bias=jb,
                                         interpret=True, block_m=M,
                                         activation=act)
        got = t_pg.pattern_gemm(tx, twpb, tli, tb, activation=act)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(t_pg.pattern_gemm(tx, twpb, tli)),
                               _np(j_ref.ref_pattern_gemm(jx, jw)),
                               rtol=2e-2, atol=2e-2)


def test_legacy_flat_layout_dispatches_like_blocked():
    """Artifacts packed before the blocked layout carry (Kp, P) panels."""
    from repro_torch.sparse.packed import PackedTensor
    from repro_torch.sparse.registry import dispatch_matmul

    rng = np.random.default_rng(3)
    jw = _pruned(rng, 64, 256, 128, "float32")
    jwp, jli = j_pack(jw, block_p=128)
    flat = PackedTensor("tile_pattern", (64, 256), ("w_packed", "lane_idx"),
                        (torch.from_numpy(np.array(jwp)),
                         torch.from_numpy(np.array(jli))))
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    np.testing.assert_array_equal(_tile_to_dense(flat).numpy(),
                                  np.asarray(jw))
    np.testing.assert_allclose(
        dispatch_matmul(x, flat, activation="silu").numpy(),
        _np(j_ops.tile_pattern_matmul(jnp.asarray(x.numpy()), jwp, jli,
                                      interpret=True, block_m=5,
                                      activation="silu")),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("act", ACTS)
def test_epilogue_matches_reference(act):
    """gelu is the tanh approximation on both sides."""
    rng = np.random.default_rng(0)
    acc = rng.standard_normal((8, 32)).astype(np.float32) * 4
    b = rng.standard_normal(32).astype(np.float32)
    want = j_epi.apply_epilogue(jnp.asarray(acc), jnp.asarray(b), act)
    got = t_epi.apply_epilogue(torch.from_numpy(acc), torch.from_numpy(b), act)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)


FLASH_CASES = [
    # B, S, H, KV, hd, causal, window, dtype
    (2, 64, 4, 2, 16, True, None, "float32"),
    (1, 128, 6, 3, 32, True, None, "float32"),
    (2, 96, 4, 1, 16, False, None, "float32"),
    (1, 128, 4, 2, 16, True, 40, "float32"),
    (2, 64, 4, 2, 32, True, None, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,name", FLASH_CASES)
def test_flash_attention_plain_matches_reference(B, S, H, KV, hd, causal,
                                                 window, name):
    """Held to ``ref_attention`` and ``blockwise_attention``, not to the
    interpret-mode Pallas flash output (its bf16 case fails on the
    reference's own tree)."""
    rng = np.random.default_rng(S + H)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, name) for a in arrs)
    got = t_fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[name][1] and got.shape == tq.shape
    tol = _tol(name)
    want = j_ref.ref_attention(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    want_bw = j_blockwise(jq, jk, jv, causal=causal, window=window, chunk=32)
    np.testing.assert_allclose(_np(got), _np(want_bw), rtol=tol, atol=tol)


def test_wrappers_validate_shapes():
    x = torch.zeros(4, 64)
    wpb, li = torch.zeros(2, 32, 32), torch.zeros(2, 32, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_pg.pattern_gemm(x, wpb, li[:1])
    with pytest.raises(ValueError):
        t_pg.pattern_gemm(x, wpb, li, torch.zeros(7))
    with pytest.raises(ValueError):
        t_epi.check_activation("tanh")
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, k, k)
