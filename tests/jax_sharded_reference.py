"""The reference's sharded programs on forced host devices, held beside
the port's in ``tests/test_torch_scaleout_dense.py`` and
``tests/test_torch_dryrun.py``.

    python tests/jax_sharded_reference.py train OUT_DIR ARCH [ARCH ...]
    python tests/jax_sharded_reference.py dryrun OUT_DIR [ARCH:]SHAPE ...

``train``: for each ARCH (a key of ``torch_scaleout_worker.DENSE`` or
``FAMILIES``),
runs ``repro.launch.train.make_train_step`` jitted under
``default_rules`` of a 2×2 ("data", "model") mesh of 4 host devices,
with the state placed by the reference's ``train_state_specs``, from
what the port's ``run_training`` starts from for the same config: the
port's init for the config's seed and its masks, converted to the
reference's stacked layout, the port's batches at each step, AdamW on
warmup-cosine and int8 compression with error feedback. Writes
``OUT_DIR/ref_<ARCH>.json`` (loss and grad norm at each step) and
``OUT_DIR/ref_<ARCH>.npz`` (the final params, the reference's layout,
``/``-joined paths).

``dryrun``: for each SHAPE, the reference's ``launch.dryrun.lower_cell``
of the dry-run tests' reduced config on a 4×4 mesh of 16 host devices;
writes ``OUT_DIR/ref_<SHAPE>.json``. A name ``ARCH:SHAPE`` lowers that
arch's reduced config instead, into ``OUT_DIR/ref_<ARCH>_<SHAPE>.json``.
"""

from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + (
    "16" if sys.argv[1] == "dryrun" else "4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.launch.train import make_train_step, train_state_specs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import adamw, error_feedback_init, warmup_cosine  # noqa: E402
from repro.parallel.sharding import axis_rules, default_rules  # noqa: E402
from repro_torch.convert import tree_to_jax  # noqa: E402
from repro_torch.data import DataConfig, make_pipeline_for  # noqa: E402
from repro_torch.launch.train import init_state  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _worker():
    spec = importlib.util.spec_from_file_location(
        "torch_scaleout_worker",
        os.path.join(HERE, "torch_scaleout_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    """numpy leaves (a bf16 {0, 1} mask as fp32: the same values)."""
    return jax.tree.map(lambda x: None if x is None else (
        x.float() if x.dtype == torch.bfloat16 else x).numpy(), tree,
        is_leaf=lambda x: x is None)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _mesh(shape):
    """A ("data", "model") mesh of GSPMD's propagation, as the reference's
    production mesh asks for."""
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def train(arch: str, out: str) -> None:
    W = _worker()
    cfg = W.config(arch)
    tcfg = W.train_config("unused")
    masks = W.masks_for(cfg)
    # the port's starting point: its init for the seed, masked
    start = init_state(build_model(cfg, device="cpu"), t_adamw(1e-3),
                       torch.Generator().manual_seed(tcfg.seed), masks=masks)
    params = _np(tree_to_jax(start["params"]))
    jmasks = _np(tree_to_jax(masks))
    data = make_pipeline_for("lm", DataConfig(
        seq_len=W.SEQ, global_batch=W.BATCH, vocab_size=cfg.vocab_size,
        d_model=cfg.d_model, seed=tcfg.seed), device="cpu")

    model = j_build_model(JModelConfig(**dataclasses.asdict(cfg)))
    optimizer = adamw(
        warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps, tcfg.steps),
        weight_decay=tcfg.weight_decay)
    mesh = _mesh((2, 2))
    rules = default_rules(mesh)
    with axis_rules(rules):
        _, shardings = train_state_specs(model, optimizer, rules,
                                         grad_compression=True)
        jp = jax.tree.map(jnp.asarray, params)
        state = {"params": jp, "opt": optimizer.init(jp),
                 "step": jnp.zeros((), jnp.int32),
                 "ef": error_feedback_init(jp)}
        state = jax.tree.map(jax.device_put, state, shardings)
        sharded_masks = jax.tree.map(
            lambda m, s: None if m is None else jax.device_put(m, s),
            jmasks, shardings["params"], is_leaf=lambda x: x is None)
        step = jax.jit(make_train_step(
            model, optimizer, masks=sharded_masks, grad_clip=tcfg.grad_clip,
            grad_compression=True))
        metrics = []
        for i in range(tcfg.steps):
            batch = {k: jnp.asarray(v.numpy().astype(np.int32))
                     for k, v in data.batch_at(i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    with open(os.path.join(out, f"ref_{arch}.json"), "w") as f:
        json.dump(metrics, f)
    np.savez(os.path.join(out, f"ref_{arch}.npz"),
             **dict(_flat(jax.device_get(state["params"]))))


def dryrun(shape: str, out: str) -> None:
    from repro.configs import reduced_config
    from repro.configs.base import SHAPES
    from repro.launch.dryrun import lower_cell

    W = _worker()
    arch, _, name = shape.rpartition(":")
    rec = lower_cell(reduced_config(arch or W.DRY_ARCH), SHAPES[name],
                     _mesh((4, 4)))
    tag = f"{arch}_{name}" if arch else name
    with open(os.path.join(out, f"ref_{tag}.json"), "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    mode, out, names = sys.argv[1], sys.argv[2], sys.argv[3:]
    assert jax.device_count() == (16 if mode == "dryrun" else 4)
    torch.set_num_threads(1)
    for name in names:
        {"train": train, "dryrun": dryrun}[mode](name, out)
