"""The dry-run of the MoE, hybrid and ssm families on a fake 16-rank 4×4
group (``launch/dryrun.py``), against the reference's own dry-run.

In subprocesses (``tests/torch_scaleout_worker.py fake_families``): every
shape of the reduced qwen2-moe-a2.7b, deepseek-moe-16b, hymba-1.5b and
xlstm-1.3b is OK, or SKIP with the reference's reason (long_500k of the
MoE configs); per device, train_4k, prefill_32k and decode_32k pass the
reference's ``launch.dryrun.lower_cell`` argument bytes on 16 host
devices (``tests/jax_sharded_reference.py dryrun``); train_4k's FLOPs
are the reference's but for the ops one side computes and the other
does not (``test_train_flops_against_the_reference_dry_run``); and a
small cell of each traced with its regions replayed (attention tiles,
the recurrent cells' chunks forward and backward, the MoE's routing)
records what tracing every one records.
"""

import importlib.util
import json
import math
import os

import pytest

from repro_torch.configs import reduced_config
from repro_torch.configs.base import SHAPES
from repro_torch.configs.shapes import skip_reason
from repro_torch.models.attention import kv_band
from repro_torch.models.moe import _group_capacity
from repro_torch.models.transformer import xlstm_groups

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_scaleout_worker.py")


def _load_worker():
    spec = importlib.util.spec_from_file_location("torch_scaleout_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()
ARCHS = list(W.FAMILIES)
REF_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
# the fake-group traces, one process per group of names (``:small``: the
# arch's cells traced with and without replay)
GROUPS = (("qwen2-moe-a2.7b", "deepseek-moe-16b", "qwen2-moe-a2.7b:small"),
          ("hymba-1.5b",), ("hymba-1.5b:small",), ("xlstm-1.3b",),
          ("xlstm-1.3b:prefill",), ("xlstm-1.3b:train",))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake-group traces and the reference's dry-run of each arch's
    cells, all started at once -> (the port's directory, the
    reference's)."""
    fake, ref = (str(tmp_path_factory.mktemp(k)) for k in ("fake", "ref"))
    procs = [W.start([WORKER, "fake_families", fake, "4x4", *group])
             for group in GROUPS]
    procs += [W.start([os.path.join(HERE, "jax_sharded_reference.py"),
                       "dryrun", ref] + [f"{a}:{s}" for s in REF_SHAPES])
              for a in ARCHS]
    for p in procs:
        W.wait(p)
    return fake, ref


@pytest.fixture(scope="module")
def cells(runs):
    """(arch, shape, tag) -> the port's record."""
    out = runs[0]
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        tag = name[:-len(".json")].split("__")[2][len("4x4"):]
        recs[(rec["arch"], rec["shape"], tag)] = rec
    return recs


def _ref(runs, arch, shape):
    with open(os.path.join(runs[1], f"ref_{arch}_{shape}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_shape_is_ok_or_skipped_with_the_reference_reason(cells,
                                                                arch):
    cfg = reduced_config(arch)
    for name, shape in SHAPES.items():
        rec = cells[(arch, name, "")]
        reason = skip_reason(cfg, shape)
        if reason is not None:
            assert (rec["status"], rec["reason"]) == ("skipped", reason)
            continue
        assert rec["status"] == "ok", rec
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        if name != "long_500k":      # one sequence: nothing to split
            assert rec["collectives"]["total"] > 0, name


@pytest.mark.parametrize("shape", REF_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_dry_run(runs, cells, arch,
                                                    shape):
    """Rank 0's shard bytes of every input (params, optimizer state,
    batch; the recurrent states and KV rows of a decode cache) are what
    the reference's compiled step takes on 16 host devices."""
    assert cells[(arch, shape, "")]["memory"]["argument_bytes"] == _ref(
        runs, arch, shape)["memory"]["argument_bytes"]


def _band_tiles(cfg, tp, b, S):
    """FLOPs of the tiles the reference's dk/dv pass computes past the
    last q chunk and zeroes (``tests/test_torch_dryrun.py``)."""
    c = min(512, S)
    band = kv_band(S // c, c, cfg.causal, cfg.sliding_window)
    tile = 2 * b * c * c * math.ceil(cfg.num_heads / tp) * cfg.head_dim
    return cfg.num_layers * band * (band - 1) // 2 * 4 * tile


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_against_the_reference_dry_run(runs, cells, arch):
    """train_4k's traced FLOPs on rank 0 of the 4×4 mesh against those
    the reference's HLO parser counts (dots at 2·K·prod(out), loop bodies
    times their trip counts). Per local batch b, local sequence S, mesh
    model axis tp, the reference computes more, by:

    * every config with attention: the tiles its dk/dv scan computes
      past the last q chunk and zeroes (``_band_tiles``);
    * the MoE configs: its scanned MoE body is rematerialized
      (``jax.checkpoint``), so each scan step's forward dots that the
      backward needs run again: the router (2·t·D·E for the step's t
      tokens), the dispatch (2·t·E·C·D), the experts' three (2·g·E·C·D·F
      / tp each, g groups) and the shared FFN's gate and up (2·t·D·Fs /
      tp each); and it splits the router weight's gradient over the model
      axis, which the port takes whole on each model rank (the routing is
      each rank's own, replicated over the model axis): it computes
      (1 − 1/tp)·2·t·D·E less there.

    and the port computes more:

    * hymba: the mamba chunk's recomputation runs each step's
      ``einsum("bdn,bn->bd", h, C)`` again, which the reference's remat
      drops (its value is not needed), and takes h's gradient through it
      as a batched matmul where XLA multiplies: 2 · 2·b·(d/tp)·N a step;
    * xlstm: the mLSTM chunk's recomputation runs both inter-chunk
      products (``h_inter`` and ``C_next``, 2·b·c·h·hd² each, h local
      heads) and the normalizer's (2·b·c·h·hd) again, where the
      reference's remat keeps one of the first two; but the port takes
      no gradient where none flows, as XLA does: none for the first
      chunk's zero state (one product and the normalizer's) nor through
      the last chunk's final state (``C_next``'s two), nor for the
      sLSTM's zero h at its first step (2·b'·H·hd'·4hd', b' its rows on
      every axis, hd' = D / H).
    """
    cfg = reduced_config(arch)
    shape = SHAPES["train_4k"]
    (data, tp), _ = W.FAKE_MESHES["4x4"]
    B, S, L, D = shape.global_batch, shape.seq_len, cfg.num_layers, \
        cfg.d_model
    b = B // data
    gap = _band_tiles(cfg, tp, b, S) if cfg.family != "ssm" else 0
    if cfg.num_experts:
        E, F, tg = cfg.num_experts, cfg.expert_d_ff, min(512, S)
        C = _group_capacity(tg, E, cfg.moe_top_k, cfg.capacity_factor)
        cps = max(1, 8192 // (B * tg))      # moe_apply's scan, global B
        n_outer = (S // tg) // cps
        g = b * cps
        t = g * tg
        Fs = cfg.num_shared_experts * F
        remat = (2 * t * D * E + 2 * t * E * C * D + 3 * 2 * g * E * C * D
                 * F // tp + 2 * 2 * t * D * Fs // tp)
        split = (tp - 1) * 2 * t * D * E // tp
        gap += L * n_outer * (remat - split)
    elif cfg.family == "hybrid":
        d = cfg.mamba_heads * cfg.mamba_head_dim
        gap -= L * S * 2 * 2 * b * (d // tp) * cfg.ssm_state
    else:
        G, per = xlstm_groups(cfg)
        c, hd, H = min(256, S), cfg.head_dim, cfg.num_heads
        h = H // tp if H % tp == 0 else H
        big, small = 2 * b * c * h * hd * hd, 2 * b * c * h * hd
        per_block = (S // c) * (big + small) - (big + small) - 2 * big
        hs = D // H
        gap -= G * (per - 1) * per_block - G * 2 * (B // (data * tp)) \
            * H * hs * 4 * hs
    got = cells[(arch, "train_4k", "")]["flops"]
    assert got == _ref(runs, arch, "train_4k")["flops"] - gap


SMALL = [(arch, kind) for arch, kinds in W.SMALL_CELLS.items()
         for kind in kinds]


@pytest.mark.parametrize("arch,kind", SMALL)
def test_replayed_trace_equals_the_full_trace(cells, arch, kind):
    """A cell whose attention tiles, recurrent chunks (forward and
    recomputed backward) and MoE routing were traced once per shape and
    replayed records what tracing every one records."""
    shape = kind + "_small"
    got, full = cells[(arch, shape, "_replay")], cells[(arch, shape,
                                                        "_full")]
    for key in ("flops", "bytes_accessed", "collectives", "memory"):
        assert got[key] == full[key], key
    rows = lambda r: sorted((o["op"], o["kind"], o["where"], o["count"],
                             o["flops"], o["bytes"]) for o in r["ops"])
    assert rows(got) == rows(full)
    replayed = "routing" if reduced_config(arch).num_experts else "scan"
    assert replayed in {o["where"] for o in got["ops"]}
