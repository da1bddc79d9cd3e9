"""The whole slice against the reference: prune -> pack -> serve.

The reference runs ``greedy_prune -> to_artifact -> ServeEngine(packed=True)
.generate``; the port gets the same DENSE weights through
``convert.params_from_jax``, prunes and packs them itself, and serves.
Pruned weights and packed buffers must be bit-equal, and greedy tokens
identical. The requests mix prompt lengths and budgets, so length
bucketing, left-padding with attended zero tokens, empty slots and eos
trimming are all exercised. The config is the reference's packed-serve
bench config (block_p 128, wk/wv at 64), fp32.
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
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, PruneConfig, greedy_prune
from repro_torch.models import LM
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse import is_packed
from repro_torch.utils.tree import tree_items

JCFG = JModelConfig(name="bench", family="dense", num_layers=2, d_model=128,
                    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                    vocab_size=512, param_dtype="float32")
OVERRIDES = {".*": {"tile_block_p": 128, "tile_group_q": 8, "tile_keep": 4},
             r".*/(wk|wv)": {"tile_block_p": 64}}
PROMPT_LENS = (5, 9, 9, 3, 12)
MAX_NEW = (4, 6, 3, 5, 2)
BATCH, MAX_SEQ = 2, 32


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def both():
    """(reference artifact, reference engine, port artifact, port model)."""
    jmodel = build_model(JCFG)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jpcfg = JPruneConfig(scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
                         overrides=OVERRIDES)
    jart = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                          jpcfg).to_artifact().pack()
    jengine = JServeEngine(jmodel, jart, batch_size=BATCH,
                           max_seq_len=MAX_SEQ, packed=True)

    tcfg = ModelConfig(**dataclasses.asdict(JCFG))
    tmodel = LM(tcfg, device="cpu")
    tpcfg = PruneConfig(scheme="tile_pattern", exclude=DEFAULT_EXCLUDE,
                        overrides=OVERRIDES)
    tart = greedy_prune(params_from_jax(np_params, tcfg, "cpu"), tpcfg,
                        device="cpu").pack(device="cpu")
    return jart, jengine, tart, tmodel, tcfg


def test_pruned_and_packed_buffers_bit_equal(both):
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
            assert torch.equal(leaf, ref), path
            continue
        n_packed += 1
        assert leaf.names == ref.names and leaf.shape == ref.shape, path
        for a, b in zip(leaf.buffers, ref.buffers):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        assert set(leaf.meta) <= set(ref.meta), path
    # 7 GEMMs per layer x 2 layers + lm_head
    assert n_packed == 15
    assert tart.packed_bytes() < tart.dense_bytes()


def test_greedy_tokens_identical_to_reference(both):
    _, jengine, tart, tmodel, _ = both
    prompts = _prompts()
    jreqs = [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    want = [r.tokens for r in jengine.generate(jreqs)]
    assert [len(t) for t in want] == list(MAX_NEW)
    # stop request 1 at its own third token: eos trimming on both sides
    eos = want[1][2]
    jreqs[1] = dataclasses.replace(jreqs[1], eos_id=eos)
    want_eos = [r.tokens for r in jengine.generate(jreqs)]

    reqs = [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    for packed in (True, False):
        engine = ServeEngine(tmodel, tart, batch_size=BATCH,
                             max_seq_len=MAX_SEQ, packed=packed, device="cpu")
        res = engine.generate(reqs)
        assert [r.uid for r in res] == list(range(len(reqs)))
        assert [r.tokens for r in res] == want, f"packed={packed}"
    reqs[1] = dataclasses.replace(reqs[1], eos_id=eos)
    engine = ServeEngine(tmodel, tart, batch_size=BATCH, max_seq_len=MAX_SEQ,
                         packed=True, device="cpu")
    got = [r.tokens for r in engine.generate(reqs)]
    assert got == want_eos and got[1][-1] == eos


def test_bind_serves_corrupt_leaf_dense(both):
    _, _, tart, tmodel, _ = both
    packed = dict(tree_items(tart.packed))
    pt = packed["blocks/0/attn/wq"]
    bad = dataclasses.replace(pt, buffers=(pt.buffers[0],
                                           pt.buffers[1] + 10_000))
    tart2 = dataclasses.replace(tart, packed={
        **tart.packed, "blocks": [{**tart.packed["blocks"][0],
                                   "attn": {**tart.packed["blocks"][0]["attn"],
                                            "wq": bad}}]
        + tart.packed["blocks"][1:]})
    tree = tart2.bind(tmodel, packed=True)
    assert torch.equal(tree["blocks"][0]["attn"]["wq"],
                       tart.params["blocks"][0]["attn"]["wq"])
    assert "blocks/0/attn/wq" in tart2.bind_report["fallbacks"]


def test_packed_needs_an_artifact(both):
    _, _, tart, tmodel, _ = both
    with pytest.raises(TypeError):
        ServeEngine(tmodel, tart.params, batch_size=BATCH,
                    max_seq_len=MAX_SEQ, packed=True, device="cpu")


def test_greedy_rows_of_a_temperature_chunk_match_reference(both):
    """Rows at temperature None or 0 of a chunk that also samples (seeded
    and unseeded rows) are the reference engine's greedy tokens."""
    _, jengine, tart, tmodel, _ = both
    prompts = _prompts()
    want = [r.tokens for r in jengine.generate(
        [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
         for i, (p, m) in enumerate(zip(prompts, MAX_NEW))])]
    temps = (None, 0.8, 0.0, 1.5, None)
    seeds = (None, 7, None, None, None)
    reqs = [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=m,
                    temperature=t, seed=s)
            for i, (p, m, t, s) in enumerate(zip(prompts, MAX_NEW, temps,
                                                 seeds))]
    engine = ServeEngine(tmodel, tart, batch_size=BATCH, max_seq_len=MAX_SEQ,
                         packed=True, device="cpu")
    got = [r.tokens for r in engine.generate(reqs)]
    for i, t in enumerate(temps):
        if t is None or t <= 0:
            assert got[i] == want[i], i
    assert [len(t) for t in got] == list(MAX_NEW)


# ------------------------------------------------------------- the launcher

LAUNCH = ["--arch", "qwen2-1.5b", "--reduced", "--requests", "5", "--batch",
          "2", "--prompt-len", "6", "--max-new", "5", "--device", "cpu"]


@pytest.fixture(scope="module")
def saved_by_reference(tmp_path_factory):
    """A tile-pattern packed reduced qwen2-1.5b artifact and its raw params,
    both saved by the reference."""
    from repro.checkpoint import save_pytree as j_save_pytree
    from repro.configs import reduced_config as j_reduced_config

    jcfg = j_reduced_config("qwen2-1.5b")
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    jart = j_greedy_prune(params, JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
        overrides={".*": {"tile_block_p": 32}})).to_artifact().pack()
    root = tmp_path_factory.mktemp("launch")
    jart.save(str(root / "artifact"))
    j_save_pytree(str(root / "ckpt"), params)
    return jmodel, params, str(root)


def _reference_launcher_tokens(jmodel, params, packed, reqs):
    """The reference launcher's engine (its defaults: max_seq 256) on the
    port launcher's prompts."""
    engine = JServeEngine(jmodel, params, batch_size=2, max_seq_len=256,
                          packed=packed)
    return [r.tokens for r in engine.generate(
        [JRequest(uid=r.uid, prompt=jnp.asarray(r.prompt.numpy()),
                  max_new_tokens=r.max_new_tokens) for r in reqs])]


def test_launcher_serves_a_reference_artifact(saved_by_reference):
    from repro.sparse import PrunedArtifact as JPrunedArtifact
    from repro_torch.launch import serve

    jmodel, _, root = saved_by_reference
    got = serve.main(LAUNCH + ["--artifact", f"{root}/artifact", "--packed"])
    reqs = serve.make_requests(5, 6, 5, jmodel.config.vocab_size)
    want = _reference_launcher_tokens(
        jmodel, JPrunedArtifact.load(f"{root}/artifact"), True, reqs)
    assert [r.tokens for r in got] == want
    assert [len(t) for t in want] == [5] * 5


def test_launcher_restores_a_reference_checkpoint(saved_by_reference):
    from repro_torch.launch import serve

    jmodel, params, root = saved_by_reference
    got = serve.main(LAUNCH + ["--ckpt", f"{root}/ckpt"])
    reqs = serve.make_requests(5, 6, 5, jmodel.config.vocab_size)
    assert [r.tokens for r in got] == _reference_launcher_tokens(
        jmodel, params, False, reqs)


def test_launcher_temperature_follows_its_seed(saved_by_reference):
    from repro_torch.launch import serve

    _, _, root = saved_by_reference
    args = LAUNCH + ["--artifact", f"{root}/artifact", "--packed",
                     "--temperature", "1.0"]
    a = [r.tokens for r in serve.main(args + ["--seed", "3"])]
    assert a == [r.tokens for r in serve.main(args + ["--seed", "3"])]
    assert a != [r.tokens for r in serve.main(args + ["--seed", "4"])]
    with pytest.raises(SystemExit):
        serve.main(LAUNCH + ["--packed"])
