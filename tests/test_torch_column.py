"""The port's column scheme against the JAX reference: packer, registry
handler, plain GEMM and column-pruned serving.

Inputs are made with numpy from a seed and go through both packages.
Packing and the dense reconstruction must be bit-equal. ``column_gemm_ref``
(what the port's ``column_gemm`` runs on a CPU tensor) is held to the
reference's Pallas ``column_gemm`` in interpret mode at the reference's
tolerances, fp32 2e-5 and bf16 2e-2. The reference's bf16 column
dispatch fails on this CPU (its gather plan's bf16 x bf16 -> fp32 dot is
refused by XLA's CPU backend), so the port's bf16 result is also held to
the fp32 dense oracle at bf16's 2e-2.
Served greedy tokens must be identical to the reference ``ServeEngine``'s
on the packed-serve bench config pruned by column at alpha 0.5, in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.core.projections import project_column as j_project_column
from repro.core.schemes import LayerSpec as JLayerSpec
from repro.kernels import ref as jref
from repro.kernels.column_gemm import column_gemm as j_column_gemm
from repro.kernels.column_gemm import pack_columns as j_pack_columns
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.sparse.registry import _column_pack as j_column_pack
from repro.sparse.registry import _column_to_dense as j_column_to_dense
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, LayerSpec, PruneConfig, greedy_prune
from repro_torch.kernels import column_gemm as tcg
from repro_torch.kernels import ref as tref
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.models import LM
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse import is_packed
from repro_torch.sparse.registry import _column_pack, _column_to_dense, dispatch_matmul
from repro_torch.utils.tree import tree_items

ACTS = (None, "relu", "silu", "gelu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a))).to(dtype)


def _pruned(Q, P, alpha, seed, group=1):
    """A column-pruned (Q, P) weight, pruned by the reference (in, out)."""
    w = np.random.default_rng(seed).standard_normal((Q, P)).astype(
        np.float32) / np.sqrt(Q)
    return j_project_column(jnp.asarray(w).T, alpha=alpha, group=group).T


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 4])
def test_pack_and_to_dense_bit_equal(dtype, group):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jw = _pruned(64, 48, 0.4, 0, group).astype(jd)
    tw = _torch(jw, td)
    j_wp, j_kept = j_pack_columns(jw, group=group)
    t_wp, t_kept = tcg.pack_columns(tw, group=group)
    assert t_wp.dtype == td and t_kept.dtype == torch.int32
    np.testing.assert_array_equal(_np(t_wp), _np(j_wp))
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(j_kept))
    jpt = j_column_pack(jw, JLayerSpec(scheme="column", column_group=group))
    tpt = _column_pack(tw, LayerSpec(scheme="column", column_group=group))
    assert (tpt.scheme, tpt.names, tpt.shape) == (jpt.scheme, jpt.names,
                                                  jpt.shape)
    assert set(tpt.meta) <= set(jpt.meta)
    for a, b in zip(jpt.buffers, tpt.buffers):
        np.testing.assert_array_equal(_np(b), _np(a))
    assert torch.equal(_column_to_dense(tpt), tw)
    np.testing.assert_array_equal(_np(_column_to_dense(tpt)),
                                  _np(j_column_to_dense(jpt)))


def test_unpruned_leaf_stays_dense():
    w = torch.randn(16, 8)
    assert _column_pack(w, LayerSpec(scheme="column")) is None


def test_to_dense_with_padded_rows_stays_exact():
    # a stacked reference artifact pads short layers with index-0 rows of
    # zero weight; the reconstruction must ignore them
    tw = _torch(_pruned(32, 16, 0.25, 1))
    pt = _column_pack(tw, LayerSpec(scheme="column"))
    wp, kept = pt.buffers
    pad = dataclasses.replace(pt, buffers=(
        torch.cat([wp, torch.zeros(3, 16)]),
        torch.cat([kept, torch.zeros(3, dtype=torch.int32)])))
    assert torch.equal(_column_to_dense(pad), tw)
    x = torch.randn(5, 32)
    torch.testing.assert_close(dispatch_matmul(x, pad), x @ tw, rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("act", ACTS)
def test_column_gemm_ref_matches_reference_kernel_fp32(act):
    jw = _pruned(96, 64, 0.5, 2)
    j_wp, j_kept = j_pack_columns(jw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = j_column_gemm(jnp.asarray(x), j_wp, j_kept, jnp.asarray(b),
                         block_m=16, block_p=64, interpret=True,
                         activation=act)
    got = tcg.column_gemm(torch.from_numpy(x), _torch(j_wp),
                          torch.from_numpy(np.array(j_kept)),
                          torch.from_numpy(b), activation=act)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    if act is None:
        plain = tcg.column_gemm(torch.from_numpy(x), _torch(j_wp),
                                torch.from_numpy(np.array(j_kept)))
        np.testing.assert_allclose(
            _np(plain), _np(jref.ref_column_gemm(jnp.asarray(x), jw)),
            rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            _np(plain), _np(tref.ref_column_gemm(torch.from_numpy(x),
                                                 _torch(jw))),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("act", ACTS)
def test_column_gemm_ref_bf16_matches_reference_and_oracle(act):
    jw = _pruned(128, 96, 0.5, 4).astype(jnp.bfloat16)
    j_wp, j_kept = j_pack_columns(jw)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((8, 128))).astype(jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(96) * 0.1).astype(jnp.bfloat16)
    tx, tb = _torch(x, torch.bfloat16), _torch(b, torch.bfloat16)
    got = tcg.column_gemm(tx, _torch(j_wp, torch.bfloat16),
                          torch.from_numpy(np.array(j_kept)), tb,
                          activation=act)
    assert got.dtype == torch.bfloat16
    want = j_column_gemm(x, j_wp, j_kept, b, block_m=8, block_p=96,
                         interpret=True, activation=act)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    oracle = apply_epilogue(tx.float() @ _torch(jw), tb, act)
    torch.testing.assert_close(got.float(), oracle, rtol=2e-2, atol=2e-2)


# --------------------------------------------------- column-pruned serving

JCFG = JModelConfig(name="bench", family="dense", num_layers=2, d_model=128,
                    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                    vocab_size=512, param_dtype="float32")
PROMPT_LENS = (5, 9, 9, 3, 12)
MAX_NEW = (4, 6, 3, 5, 2)
BATCH, MAX_SEQ = 2, 32


@pytest.fixture(scope="module")
def both():
    jmodel = build_model(JCFG)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jart = j_greedy_prune(
        jax.tree.map(jnp.asarray, np_params),
        JPruneConfig(scheme="column", alpha=0.5, exclude=tuple(J_EXCLUDE))
    ).to_artifact().pack()
    jengine = JServeEngine(jmodel, jart, batch_size=BATCH,
                           max_seq_len=MAX_SEQ, packed=True)
    tcfg = ModelConfig(**dataclasses.asdict(JCFG))
    tmodel = LM(tcfg, device="cpu")
    tart = greedy_prune(params_from_jax(np_params, tcfg, "cpu"),
                        PruneConfig(scheme="column", alpha=0.5,
                                    exclude=DEFAULT_EXCLUDE),
                        device="cpu").pack(verify=True, device="cpu")
    return jart, jengine, tart, tmodel, tcfg


def test_column_pruned_and_packed_buffers_bit_equal(both):
    jart, _, tart, _, tcfg = both
    want = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jart.params), tcfg, "cpu")))
    for path, leaf in tree_items(tart.params):
        assert torch.equal(leaf, want[path]), path
    want = dict(tree_items(packed_from_jax(
        jax.tree.map(np.asarray, jart.packed), tcfg, "cpu")))
    n_packed = 0
    for path, leaf in tree_items(tart.packed):
        ref = want[path]
        assert is_packed(leaf) == is_packed(ref), path
        if not is_packed(leaf):
            continue
        n_packed += 1
        assert leaf.scheme == ref.scheme == "column", path
        for a, b in zip(leaf.buffers, ref.buffers):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    assert n_packed == 15            # 7 GEMMs x 2 layers + lm_head
    assert tart.summary()["bytes_ratio"] > 1.5


def test_column_served_tokens_identical_to_reference(both):
    _, jengine, tart, tmodel, _ = both
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    want = [r.tokens for r in jengine.generate(
        [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
         for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])]
    reqs = [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    for packed in (True, False):
        engine = ServeEngine(tmodel, tart, batch_size=BATCH,
                             max_seq_len=MAX_SEQ, packed=packed, device="cpu")
        assert [r.tokens for r in engine.generate(reqs)] == want, packed
