"""Sharded training, prefill and decode of the reduced
qwen2-moe-a2.7b (4 experts of capacity 8 at top-2: tokens dropped)
on a 2×2 gloo mesh against one process, the reference's sharded step and
a 1×1 mesh, and its checkpoint restored across meshes: the fixtures and
tests of ``tests/torch_scaleout_families.py``, one file per arch.
"""

import importlib.util
import os

ARCH = "qwen2-moe-a2.7b"


def _load():
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_scaleout_families",
        os.path.join(here, "torch_scaleout_families.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_F = _load()
globals().update({name: getattr(_F, name) for name in _F.__all__})
