"""The port's dense-family LM against the JAX reference's ``LM``.

Both packages get the same weights (the reference's init, handed over as
numpy through ``repro_torch.convert``), the same prompt and the same
decode tokens. Logits of ``prefill`` and of two ``decode_step``s must
agree within 1e-4 absolute in fp32 (the per-op tolerance is 2e-5; a
two-layer forward sums a few of those), for dense weights and for the
reference's packed artifact. Configs: ``reduced_config("qwen2-1.5b")``
pruned at block_p 32, and the reference's packed-serve bench config
(block_p 128, wk/wv at 64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import build_model
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import packed_from_jax, params_from_jax, tensor_from_numpy
from repro_torch.models import LM
from repro_torch.sparse import is_packed

LOGIT_ATOL = 1e-4

BENCH = JModelConfig(name="bench", family="dense", num_layers=2, d_model=128,
                     num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                     vocab_size=512, param_dtype="float32")

CASES = {
    "qwen2_reduced": (j_reduced_config("qwen2-1.5b"),
                      {".*": {"tile_block_p": 32}}),
    "packed_serve_bench": (BENCH, {".*": {"tile_block_p": 128},
                                   r".*/(wk|wv)": {"tile_block_p": 64}}),
}


def _port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np_params(model, seed=0):
    """Reference init as numpy, with nonzero QKV biases (init zeros them)."""
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (rng.standard_normal(attn[name].shape) * 0.1).astype(
                attn[name].dtype)
    return params


def _run_jax(model, params, tokens, steps):
    cache, logits = model.prefill(params, jnp.asarray(tokens),
                                  tokens.shape[1] + len(steps), flash=False)
    out = [np.asarray(logits)]
    for tok in steps:
        cache, logits = model.decode_step(params, cache, jnp.asarray(tok))
        out.append(np.asarray(logits))
    return out


def _run_port(model, params, tokens, steps):
    cache, logits = model.prefill(params, torch.from_numpy(tokens).long(),
                                  tokens.shape[1] + len(steps))
    out = [logits.numpy()]
    for tok in steps:
        cache, logits = model.decode_step(params, cache,
                                          torch.from_numpy(tok).long())
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_logits_match_reference(case):
    jcfg, overrides = CASES[case]
    jmodel = build_model(jcfg)
    tcfg = _port_config(jcfg)
    tmodel = LM(tcfg, device="cpu")
    np_params = _np_params(jmodel)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    steps = [rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(2)]

    # dense weights
    want = _run_jax(jmodel, jax.tree.map(jnp.asarray, np_params), tokens,
                    steps)
    got = _run_port(tmodel, params_from_jax(np_params, tcfg, "cpu"), tokens,
                    steps)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (2, 1, jcfg.vocab_size)
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)

    # the reference's packed artifact, served packed by both
    pcfg = JPruneConfig(scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
                        overrides=overrides)
    art = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                         pcfg).to_artifact().pack()
    j_packed = art.bind(jmodel, packed=True)
    t_packed = packed_from_jax(jax.tree.map(np.asarray, j_packed), tcfg,
                               "cpu")
    assert is_packed(t_packed["blocks"][0]["attn"]["wk"])
    assert is_packed(t_packed["lm_head"])
    want = _run_jax(jmodel, j_packed, tokens, steps)
    got = _run_port(tmodel, t_packed, tokens, steps)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)


def test_bf16_arrays_convert_bit_exact():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.14159, 1e-3], jnp.bfloat16))
    t = tensor_from_numpy(a, torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_reduced_configs_agree():
    assert dataclasses.asdict(t_reduced_config("qwen2-1.5b")) == \
        dataclasses.asdict(j_reduced_config("qwen2-1.5b"))


def test_param_shapes_match_reference_init():
    jcfg = j_reduced_config("qwen2-1.5b")
    params = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    tcfg = _port_config(jcfg)
    ported = params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), params), tcfg, "cpu")
    from repro_torch.utils.tree import tree_items

    shapes = {p: tuple(x.shape) for p, x in tree_items(ported)}
    assert shapes == LM(tcfg, device="cpu").param_shapes()
    init = LM(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert {p: tuple(x.shape) for p, x in tree_items(init)} == shapes


def test_unported_families_raise():
    """Every family of the reference is ported: none raises
    ``NotImplementedError`` any more (the ssm and hybrid configs build);
    a family the reference does not know raises ``ValueError``."""
    for name in ("xlstm-1.3b", "hymba-1.5b"):
        cfg = t_reduced_config(name)
        assert LM(cfg, device="cpu").config.family == cfg.family
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(t_reduced_config("qwen2-1.5b"),
                               family="rnn"), device="cpu")


def test_flash_prefill_gate_agrees_with_reference():
    """The port's gate is its kernel's limits: every shape the reference
    sends to its kernel, the port does too on the head dims its kernel
    takes; it also takes a ragged S (513, 600, 1000), which the
    reference's Pallas tiling refuses; head dim 80 (h2o-danube-1.8b) is
    taken, head dim 16 and an inexact GQA ratio are refused."""
    from repro.models.attention import flash_prefill_supported as j_gate
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.models.attention import flash_prefill_supported

    heads = ((12, 2), (4, 4), (6, 4), (4, 0))
    for s in (0, 1, 16, 200, 512, 513, 600, 1000, 1024, 1536):
        for h, kv in heads:
            exact = kv > 0 and h % kv == 0
            assert 80 in HEAD_DIMS
            for hd in HEAD_DIMS:
                ok = flash_prefill_supported(s, h, kv, hd)
                assert ok == (s > 0 and exact)
                if j_gate(s, h, kv):
                    assert ok
            assert not flash_prefill_supported(s, h, kv, 16)
    for s in (513, 600, 1000):
        assert not j_gate(s, 12, 2)
        assert all(flash_prefill_supported(s, 12, 2, hd) for hd in HEAD_DIMS)


def test_training_forward_runs_blockwise_with_autograd():
    """``hidden_states`` (training) and a flash request on CPU tensors take
    ``blockwise_attention``, count no fallback, and carry gradients."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    calls = []
    real = attention.blockwise_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    tcfg = t_reduced_config("qwen2-1.5b")
    model = LM(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, tcfg.vocab_size, (2, 8))
    before = (dict(fa.ROUTE_LAUNCHES), attention.PREFILL_FALLBACKS)
    attention.blockwise_attention = spy
    try:
        w = params["blocks"][0]["attn"]["wq"].requires_grad_(True)
        h, _ = model.hidden_states(params, tokens)
        (g,) = torch.autograd.grad(h.square().sum(), [w])
        model.prefill(params, tokens, 12)
    finally:
        attention.blockwise_attention = real
    assert len(calls) == 2 * tcfg.num_layers and bool(g.abs().sum() > 0)
    assert (dict(fa.ROUTE_LAUNCHES), attention.PREFILL_FALLBACKS) == before
