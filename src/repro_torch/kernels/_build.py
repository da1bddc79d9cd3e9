"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
becomes ``build/repro_torch/<name>-<hash>.so`` at the repository root,
keyed on a hash of the source, every shared header ``csrc/*.cuh`` and the
compiler flags, so an edited source or header rebuilds and an unchanged
one loads at once. Every pointer and the stream cross the boundary as
``c_void_p``; every C entry point returns the ``cudaError_t`` of
``cudaGetLastError()`` after its launch.

Builds run only when a kernel is first launched (or ``build_all`` is
called), never at import: the CPU-only test box has no nvcc. Sources are
compiled in parallel, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
# C entry point of each source: (symbol, argtypes)
SIGNATURES: Dict[str, Tuple[str, List]] = {
    # x, w_packed, lane_idx, bias, out, ws, M, Q, nb, Kp, bp, ksplit,
    # variant, block_m, grid_order, is_bf16, act, stream
    "pattern_gemm": ("pattern_gemm_launch", [_P] * 6 + [_I] * 11 + [_P]),
    # q, k, v, out, B, S, H, KV, hd, scale, causal, window, is_bf16,
    # variant, block_q, stream
    "flash_attention": ("flash_attention_launch",
                        [_P] * 4 + [_I] * 5 + [_F] + [_I] * 5 + [_P]),
    # x, w_packed, kept_idx, bias, out, ws, xg, M, Q, K, P, ksplit, variant,
    # block_m, grid_order, is_bf16, act, stream
    "column_gemm": ("column_gemm_launch", [_P] * 7 + [_I] * 10 + [_P]),
    # x, w_packed, taps, bias, out, B, H, W, C, A, is_bf16, act, variant,
    # TH, TW, NIMG, BN, grid_order, stream
    "pattern_conv": ("pattern_conv_launch", [_P] * 5 + [_I] * 13 + [_P]),
}

_FNS: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of its source,
    every header in ``csrc/`` and the flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library.

    Returns {name: seconds} for the sources compiled by this call; nvcc's
    resource report (``-Xptxas -v``) lands in ``<name>.log`` beside the
    library. Raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    procs = []
    t0 = time.perf_counter()
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    seconds: Dict[str, float] = {}
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)       # atomic: a concurrent loader never sees
    if failures:                   # a half-written library
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def entry_point(name: str):
    """The C entry point of ``csrc/<name>.cu``, building it if needed."""
    fn = _FNS.get(name)
    if fn is None:
        path = _target(name)
        if not path.exists():
            build_all([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call ``name``'s C entry point; raise on a non-zero cudaError_t."""
    err = entry_point(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
