"""The port's projections and pattern-conv pieces against the JAX reference.

Inputs are made with numpy from a seed and go through both packages.
Projections, packers and the tap gather are selection work and must be
bit-equal, ties included: the projections keep every score tied with the
k-th (``>= kth``) in both packages. ``pattern_conv_ref`` (what the port's
``pattern_conv`` runs on a CPU tensor) is held to the reference's Pallas
``pattern_conv`` in interpret mode at the reference's tolerances
(``tests/test_kernels.py::_tol``): fp32 2e-5, bf16 2e-2.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projections as jp
from repro.core.schemes import LayerSpec as JLayerSpec
from repro.kernels import ref as jref
from repro.sparse.registry import _pattern_pack as j_pattern_pack
from repro.sparse.registry import _pattern_to_dense as j_pattern_to_dense
from repro_torch.core import projections as tp
from repro_torch.core.schemes import LayerSpec
from repro_torch.kernels import pattern_conv as tpc
from repro_torch.kernels import ref as tref
from repro_torch.sparse.registry import _pattern_pack, _pattern_to_dense

# the module: ``repro.kernels`` re-exports a function of the same name
jpc = importlib.import_module("repro.kernels.pattern_conv")

ACTS = (None, "relu", "silu", "gelu")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, name: str = "float32"):
    """The same values in both frameworks (bf16 rounds identically)."""
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(
        np.ascontiguousarray(a)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(j, name: str = "float32") -> torch.Tensor:
    """A reference array as a torch tensor of the same values."""
    return torch.from_numpy(np.array(_np(j))).to(DTYPES[name][1])


def _equal(j, t):
    np.testing.assert_array_equal(_np(t), _np(j))


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- projections

@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_gemm_projections_bit_equal(name):
    jw, tw = _pair(_w((48, 40)), name)
    for alpha in (0.1, 0.25, 0.5):
        _equal(jp.project_irregular(jw, alpha=alpha),
               tp.project_irregular(tw, alpha=alpha))
        _equal(jp.project_filter(jw, alpha=alpha),
               tp.project_filter(tw, alpha=alpha))
        for group in (1, 4, 8):
            _equal(jp.project_column(jw, alpha=alpha, group=group),
                   tp.project_column(tw, alpha=alpha, group=group))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_kernel_projections_bit_equal(name):
    jw, tw = _pair(_w((12, 10, 3, 3), 1), name)
    _equal(jp.project_kernel_pattern(jw), tp.project_kernel_pattern(tw))
    _equal(jp.project_channel_pattern(jw), tp.project_channel_pattern(tw))
    jl, jid = jp.project_kernel_pattern_library(jw)
    tl, tid = tp.project_kernel_pattern_library(tw)
    _equal(jl, tl)
    np.testing.assert_array_equal(np.asarray(jid), tid.numpy())
    np.testing.assert_array_equal(jp.canonical_patterns_3x3(12),
                                  tp.canonical_patterns_3x3(12).numpy())
    for alpha in (0.1, 0.25):
        _equal(jp.project_connectivity(jw, alpha=alpha),
               tp.project_connectivity(tw, alpha=alpha))
        for scheme in ("pattern", "pattern_shared", "kernel_pattern",
                       "connectivity"):
            _equal(jp.project(jw, scheme, alpha=alpha, keep=4),
                   tp.project(tw, scheme, alpha=alpha, keep=4))


def test_one_by_one_convs_take_connectivity_alone():
    jw, tw = _pair(_w((16, 12, 1, 1), 2))
    for scheme in ("pattern", "pattern_shared"):
        got = tp.project(tw, scheme, alpha=0.25, keep=4)
        _equal(jp.project(jw, scheme, alpha=0.25, keep=4), got)
        assert int((got != 0).sum()) == 48           # floor(0.25 * 192)


def test_ties_keep_extra_entries_as_the_reference():
    # connectivity: 6 of 16 kernels share the norm at the threshold
    w4 = np.zeros((4, 4, 3, 3), np.float32)
    norms = [5, 4, 3, 3, 3, 3, 3, 3, 2, 1, 1, 1, 1, 1, 1, 1]
    for i, n in enumerate(norms):
        w4[i // 4, i % 4, 1, 1] = n
    jw, tw = _pair(w4)
    got = tp.project_connectivity(tw, alpha=0.25 * 4 / 9)   # k = 4
    _equal(jp.project_connectivity(jw, alpha=0.25 * 4 / 9), got)
    assert int((got.reshape(16, 9) != 0).any(dim=1).sum()) == 8
    # column: 3 columns tie at the 2nd largest norm
    w = np.ones((4, 6), np.float32) * np.array([3, 2, 2, 2, 1, 1], np.float32)
    jw, tw = _pair(w)
    got = tp.project_column(tw, alpha=2 / 6)
    _equal(jp.project_column(jw, alpha=2 / 6), got)
    assert int((got != 0).any(dim=0).sum()) == 4


def test_layer_spec_projects_like_the_reference():
    jw4, tw4 = _pair(_w((8, 6, 3, 3), 3))
    jw2, tw2 = _pair(_w((32, 24), 4))
    for scheme in ("irregular", "filter", "column", "pattern_shared"):
        spec = dict(scheme=scheme, alpha=0.3)
        conv = dict(spec, conv_shape=(8, 6, 3, 3)) if "pattern" in scheme \
            else spec
        _equal(JLayerSpec(**conv).project(jw4), LayerSpec(**conv).project(tw4))
        if "pattern" not in scheme:
            _equal(JLayerSpec(**spec).project(jw2),
                   LayerSpec(**spec).project(tw2))


# ------------------------------------------------------- packers and gather

def _shared_pruned(A, C, seed, name="float32", alpha=0.25):
    """A pattern_shared-pruned (A, C, 3, 3) weight, pruned by the reference."""
    jw, _ = _pair(_w((A, C, 3, 3), seed), name)
    return jp.project(jw, "pattern_shared", alpha=alpha, keep=4)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_assign_and_pack_pattern_conv_bit_equal(name):
    jw, tw = _pair(_w((16, 9, 3, 3), 5), name)
    ids = tpc.assign_channel_patterns(tw)
    np.testing.assert_array_equal(jpc.assign_channel_patterns(jw),
                                  ids.numpy())
    j_wp, j_taps = jpc.pack_pattern_conv(jw, np.asarray(ids))
    t_wp, t_taps = tpc.pack_pattern_conv(tw, ids)
    assert t_wp.dtype == DTYPES[name][1] and t_taps.dtype == torch.int32
    _equal(j_wp, t_wp)
    np.testing.assert_array_equal(j_taps, t_taps.numpy())
    pats = jp.canonical_patterns_3x3()
    _equal(jref.mask_channel_patterns(jw, np.asarray(ids), pats),
           tref.mask_channel_patterns(tw, ids, torch.from_numpy(pats)))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_pattern_pack_and_to_dense_bit_equal(name):
    jw = _shared_pruned(16, 12, 6, name)
    tw = _torch(jw, name)
    spec = LayerSpec(scheme="pattern_shared", conv_shape=(16, 12, 3, 3))
    jpt = j_pattern_pack(jw, JLayerSpec(scheme="pattern_shared",
                                        conv_shape=(16, 12, 3, 3)))
    tpt = _pattern_pack(tw, spec)
    assert (tpt.scheme, tpt.names, tpt.shape) == (jpt.scheme, jpt.names,
                                                  jpt.shape)
    assert dict(tpt.meta) == dict(jpt.meta)
    for a, b in zip(jpt.buffers, tpt.buffers):
        _equal(a, b)
    assert tpt.buf("taps").dtype == torch.int32
    # connectivity removed whole kernels: some channels pad with tap 0
    assert bool((tpt.buf("taps") == 0).any())
    assert torch.equal(_pattern_to_dense(tpt), tw)
    _equal(j_pattern_to_dense(jpt), _pattern_to_dense(tpt))


def test_pattern_pack_refuses_unshared_taps():
    jw, tw = _pair(_w((8, 4, 3, 3), 7))
    j4, t4 = jp.project_kernel_pattern(jw), tp.project_kernel_pattern(tw)
    spec = dict(scheme="pattern", conv_shape=(8, 4, 3, 3))
    assert j_pattern_pack(j4, JLayerSpec(**spec)) is None
    assert _pattern_pack(t4, LayerSpec(**spec)) is None
    # 1x1 and non-3x3 leaves never pack
    assert _pattern_pack(torch.zeros(8, 4, 1, 1), LayerSpec(**spec)) is None


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 4, 4, 16)])
def test_gather_taps_bit_equal(shape):
    jx, tx = _pair(_w(shape, 8))
    C = shape[-1]
    taps = np.random.default_rng(9).integers(0, 9, (C, 4)).astype(np.int32)
    _equal(jpc.gather_taps(jx, taps),
           tpc.gather_taps(tx, torch.from_numpy(taps)))


# ------------------------------------------------- plain version vs Pallas

@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_pattern_conv_ref_matches_reference_kernel(name, act):
    tol = TOL[name]
    jw = _shared_pruned(24, 8, 10, name, alpha=0.5)
    jpt = j_pattern_pack(jw, JLayerSpec(scheme="pattern_shared",
                                        conv_shape=(24, 8, 3, 3)))
    j_wp, j_taps = jpt.buffers
    jx, tx = _pair(_w((2, 6, 5, 8), 11), name)
    jb, tb = _pair(_w((24,), 12) * 0.1, name)
    want = jpc.pattern_conv(jx, j_wp, np.asarray(j_taps), jb,
                            interpret=True, activation=act)
    t_wp = _torch(j_wp, name)
    got = tpc.pattern_conv(tx, t_wp, torch.from_numpy(np.array(j_taps)),
                           tb, activation=act)
    assert got.dtype == DTYPES[name][1] and tuple(got.shape) == (2, 6, 5, 24)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    if act is None:
        # and both packages' dense conv oracles on the pruned weight
        tw = _torch(jw, name)
        oracle = tref.ref_conv3x3(tx, tw)
        no_bias = tpc.pattern_conv(tx, t_wp,
                                   torch.from_numpy(np.array(j_taps)))
        np.testing.assert_allclose(_np(no_bias), _np(oracle), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(_np(oracle), _np(jref.ref_conv3x3(jx, jw)),
                                   rtol=tol, atol=tol)
