"""Seeded chaos: deterministic fault injectors for the reliability layer
(mirrors ``repro/testing/chaos.py`` on torch tensors).

Every injector is a pure function of its ``seed`` (NumPy ``default_rng``):
the same seed corrupts the same byte, poisons the same leaf, fires at the
same chunk, so a chaos test that fails replays exactly. The seams they
drive are the ones a deployment exposes:

  on disk    ``corrupt_buffer`` / ``corrupt_manifest``: bit-flips and
             truncation in a saved checkpoint directory; caught by the
             CRC32 manifest layer in ``repro_torch.checkpoint`` as
             ``ArtifactError`` (the on-disk format is the reference's, so
             a seed damages the same byte of the same file in both
             packages).
  in weights ``nan_poison_leaf``: a non-finite value in a params leaf;
             caught by the engines' logit guards as ``status="failed"``
             (and by ``sparse.packed.validate_packed`` for packed leaves,
             served dense at bind).
  in packed  ``corrupt_packed_index``: an out-of-range index-table entry
             (the silent-garbage fault); caught at bind, served dense.
  in flight  ``kv_poison_hook``: NaN into ONE slot's KV rows of the live
             cache, in place, between micro-chunks (token prompts are
             integers, so poison cannot arrive through inputs);
             quarantines exactly that slot.
  in time    ``ScriptedClock``: a deterministic engine clock driving
             deadline expiry and straggler detection without wall-clock
             flakiness; ``chunk_action_hook``: host actions (e.g.
             ``request.cancel()``) at exact chunk edges.
  in pruning ``kill_at_iteration``: process death at an exact ADMM
             iteration (soft ``ChaosKill`` for in-process tests, a real
             SIGKILL for ``launch/prune.py --chaos-kill-at``);
             ``corrupt_admm_checkpoint``: bit-flip the latest committed
             prune-state checkpoint (resume must fall back or raise
             ``ArtifactError``); ``nan_grad_poison``: one-shot NaN into
             the iterates before an exact iteration (the health monitor
             must surface it and recover).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# time


class ScriptedClock:
    """An engine clock that returns a scripted sequence of times.

    Each call pops the next entry of ``times``; once exhausted, the clock
    keeps advancing by ``tail_step`` per call (it must keep moving: the
    engine's wait loop polls it, and a frozen injected clock would spin
    forever waiting for an arrival). Feed it to
    ``ContinuousEngine.generate(clock=...)`` to make deadline expiry and
    slow-chunk (straggler) scenarios exactly reproducible.
    """

    def __init__(self, times: Sequence[float], tail_step: float = 1.0):
        self._times = [float(t) for t in times]
        self._i = 0
        self._last = self._times[-1] if self._times else 0.0
        self._tail = float(tail_step)

    def __call__(self) -> float:
        if self._i < len(self._times):
            t = self._times[self._i]
            self._i += 1
            self._last = t
            return t
        self._last += self._tail
        return self._last


# ---------------------------------------------------------------------------
# on disk


def _checkpoint_files(directory: str) -> list:
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npy"))
    if not files:
        raise ValueError(f"no buffer files under {directory}")
    return files


def corrupt_buffer(directory: str, *, seed: int) -> Dict[str, Any]:
    """Flip ONE bit of one saved ``.npy`` buffer in a checkpoint
    directory (file, offset, and bit all drawn from ``seed``). Returns
    ``{"file", "offset", "bit"}`` describing the damage. The CRC32 in
    the manifest guarantees the next load raises ``ArtifactError`` no
    matter which bit was hit, header bytes included."""
    rng = np.random.default_rng(seed)
    files = _checkpoint_files(directory)
    fname = files[int(rng.integers(len(files)))]
    path = os.path.join(directory, fname)
    data = bytearray(open(path, "rb").read())
    off = int(rng.integers(len(data)))
    bit = int(rng.integers(8))
    data[off] ^= 1 << bit
    with open(path, "wb") as f:
        f.write(bytes(data))
    return {"file": fname, "offset": off, "bit": bit}


def corrupt_manifest(directory: str, *, seed: int,
                     mode: Optional[str] = None) -> Dict[str, Any]:
    """Damage ``manifest.json`` itself: truncate it mid-byte, drop a
    required field from a random leaf entry, or bump ``schema_version``
    past what this build supports. ``mode`` forces one of
    ``{"truncate", "drop_field", "future_version"}``; default draws from
    ``seed``. Every mode must surface as ``ArtifactError`` on load."""
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, "manifest.json")
    modes = ("truncate", "drop_field", "future_version")
    mode = mode or modes[int(rng.integers(len(modes)))]
    if mode == "truncate":
        raw = open(path, "rb").read()
        keep = int(rng.integers(1, max(2, len(raw) // 2)))
        with open(path, "wb") as f:
            f.write(raw[:keep])
    elif mode == "drop_field":
        doc = json.load(open(path))
        leaves = doc.get("leaves") or []
        if not leaves:
            raise ValueError(f"manifest at {path} has no leaves to damage")
        entry = leaves[int(rng.integers(len(leaves)))]
        # NOT crc32: a missing crc means a v1 (pre-checksum) manifest and
        # loads legitimately; drop a field every load requires instead
        if "packed" in entry and rng.integers(2):
            bufs = entry["packed"]["buffers"]
            bufs[int(rng.integers(len(bufs)))].pop("file", None)
        else:
            entry.pop("path" if "file" not in entry or rng.integers(2)
                      else "file", None)
        with open(path, "w") as f:
            json.dump(doc, f)
    else:  # future_version
        doc = json.load(open(path))
        doc["schema_version"] = 10_000 + int(rng.integers(1000))
        with open(path, "w") as f:
            json.dump(doc, f)
    return {"mode": mode, "path": path}


# ---------------------------------------------------------------------------
# in weights / in packed buffers


def nan_poison_leaf(params: Any, *, seed: int,
                    path_contains: Optional[str] = None) -> Any:
    """Return a params tree with ONE element of one float leaf set NaN
    (leaf and element drawn from ``seed``). ``path_contains`` restricts
    the candidate leaves by '/'-joined tree path substring: poison a leaf
    on the residual stream (e.g. a block's MLP weight) when the test
    needs the NaN to reach every logit. Only the poisoned leaf is
    copied; every other leaf is the same tensor."""
    from repro_torch.utils.tree import tree_items, tree_map_with_path

    items = list(tree_items(params))
    float_idx = [
        i for i, (p, leaf) in enumerate(items)
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
        and (path_contains is None or path_contains in p)
    ]
    if not float_idx:
        raise ValueError(
            f"params tree has no float leaves to poison "
            f"(path_contains={path_contains!r})")
    rng = np.random.default_rng(seed)
    path, leaf = items[float_idx[int(rng.integers(len(float_idx)))]]
    bad = leaf.clone()
    bad.view(-1)[int(rng.integers(bad.numel()))] = float("nan")
    return tree_map_with_path(lambda p, x: bad if p == path else x, params)


def corrupt_packed_index(pt: Any, *, seed: int) -> Any:
    """Return a ``PackedTensor`` whose index table has one out-of-range
    entry: the worst packed fault, which without validation gathers
    garbage rows and serves silently wrong tokens. ``validate_packed``
    must flag it; ``PrunedArtifact.bind`` must serve the leaf dense."""
    from repro_torch.sparse.packed import _INDEX_BOUNDS, PackedTensor

    bound = _INDEX_BOUNDS.get(pt.scheme)
    if bound is None:
        raise ValueError(f"scheme {pt.scheme!r} has no index table")
    name, hi_fn = bound
    rng = np.random.default_rng(seed)
    idx = pt.buf(name).clone()
    flat = idx.view(-1)
    flat[int(rng.integers(flat.numel()))] = int(hi_fn(pt.shape)) + 7
    buffers = tuple(idx if n == name else b
                    for n, b in zip(pt.names, pt.buffers))
    return PackedTensor(pt.scheme, pt.shape, pt.names, buffers, pt.meta)


# ---------------------------------------------------------------------------
# in flight


def kv_poison_hook(slot: int, at_chunk: int = 0
                   ) -> Callable[[Any, Any], None]:
    """A ``ContinuousEngine`` ``fault_hook`` that writes NaN into one
    slot's KV rows (every layer, every position) of the LIVE cache, in
    place, at the ``at_chunk``-th chunk edge (counting edges where the
    slot is live). It models a transient device-memory fault: the
    poisoned slot's next logits go non-finite (masked attention zeroes
    stale WEIGHTS, but ``0 * NaN`` in the value sum is still NaN), the
    engine quarantines it, and batch-mates are untouched: their rows
    never mix with row ``slot`` through any batched op. Returns None, so
    the captured decode graph keeps reading the same tensors."""
    state = {"edge": -1}

    def hook(cache: Dict[str, Any], sched: Any) -> None:
        if slot not in sched.table.active:
            return None
        state["edge"] += 1
        if state["edge"] != at_chunk:
            return None
        for t in cache["k"] + cache["v"]:
            t[slot].fill_(float("nan"))
        return None

    return hook


# ---------------------------------------------------------------------------
# in pruning


class ChaosKill(RuntimeError):
    """Injected process death for in-process tests. Deliberately NOT a
    ``PruneDivergence``: the recovery path must not catch it; it models
    SIGKILL, which nothing catches. The resumable run's contract is
    that a run killed here resumes bit-exactly from its last committed
    checkpoint."""


def kill_at_iteration(at_iteration: int, *, hard: bool = False
                      ) -> Callable[[int, Dict[str, float]], None]:
    """A pruner ``callback`` that dies once iteration ``at_iteration``
    has COMMITTED (the pruner checkpoints before invoking callbacks, so
    the kill timing is the worst honest case: state is durable, process
    is gone). ``hard=True`` sends a real ``SIGKILL`` (what
    ``launch/prune.py --chaos-kill-at`` drives); the default raises
    ``ChaosKill`` so in-process tests keep their stack."""

    def cb(it: int, metrics: Dict[str, float]) -> None:
        if it == at_iteration:
            if hard:
                import signal

                os.kill(os.getpid(), signal.SIGKILL)
            raise ChaosKill(f"injected kill at prune iteration {it}")

    return cb


def corrupt_admm_checkpoint(ckpt_root: str, *, seed: int,
                            step: Optional[int] = None) -> Dict[str, Any]:
    """Flip one bit of one buffer in the LATEST (or given) committed
    prune-state checkpoint under ``ckpt_root``. The CRC32 manifest layer
    guarantees the resume path sees ``ArtifactError`` for that step and
    falls back to an older checkpoint (or raises typed if none is left).
    Returns ``{"step", "file", "offset", "bit"}``."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_root)
    steps = mgr.steps()
    if not steps:
        raise ValueError(f"no committed checkpoints under {ckpt_root}")
    target = steps[-1] if step is None else step
    info = corrupt_buffer(mgr._dir(target), seed=seed)
    return {"step": target, **info}


def nan_grad_poison(at_iteration: int, *, seed: int = 0,
                    path_contains: Optional[str] = None
                    ) -> Callable[[int, Any, Any], Any]:
    """A pruner ``fault_hook``: poison ONE element of one params leaf
    right before iteration ``at_iteration`` runs, so the primal gradient
    step propagates NaN into the iterates and the health monitor must
    surface ``PruneDivergence``. One-shot: it fires the FIRST time the
    iteration index is reached, so a rolled-back retry proceeds clean
    (the recovery-success scenario); pin ``HealthPolicy(max_recoveries=0)``
    to exercise the typed-failure path instead."""
    state = {"fired": False}

    def hook(it: int, params: Any, av: Any):
        if state["fired"] or it != at_iteration:
            return None
        state["fired"] = True
        return nan_poison_leaf(params, seed=seed,
                               path_contains=path_contains), av

    return hook


def chunk_action_hook(actions: Dict[int, Callable[[], None]]
                      ) -> Callable[[Any, Any], None]:
    """A ``fault_hook`` that runs host-side actions at exact chunk edges
    (edge 0 = before the first chunk): ``{2: request.cancel}`` cancels a
    request mid-stream deterministically, regardless of wall-clock
    timing. Returns None (the cache is never touched)."""
    state = {"edge": -1}

    def hook(cache: Any, sched: Any) -> None:
        state["edge"] += 1
        fn = actions.get(state["edge"])
        if fn is not None:
            fn()
        return None

    return hook
