"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``kernels/``, ``sparse/``, ``core/``, ``models/``,
``serve/``, ``checkpoint/``, ``launch/``, ``configs/``, ``privacy/``,
``runtime/``) and never imports ``jax`` or ``repro``.

Covered so far — the paper's privacy-preserving pruning service end to
end (``launch/pipeline.py``: a client checkpoint, ADMM on synthetic data
with ``core.PrivacyPreservingPruner``, masked retraining, a packed
artifact whose manifest carries the membership-inference report of
``privacy/``, on the staged, resumable runner and metrics registry of
``runtime/``), and pack, save, load and serve a dense LM (tile pattern
or column) and pattern-pruned CNNs:

    model    = LM(get_config("qwen2-1.5b"))                  # on cuda
    params   = model.init(torch.Generator("cuda").manual_seed(0))
    artifact = greedy_prune(params, PruneConfig(scheme="tile_pattern"))
    artifact.pack().save("/tmp/art")             # the reference's format
    artifact = PrunedArtifact.load("/tmp/art", cfg=model.config)
    engine   = ServeEngine(model, artifact, packed=True,
                           batch_size=4, max_seq_len=544)  # CUDA graphs
    results  = engine.generate([Request(uid=0, prompt=[1, 2, 3])])

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the tests do); with no card and no explicit CPU request
it raises instead of dropping to the CPU.
"""
from repro_torch.serve.engine import Request, Result, ServeEngine
from repro_torch.serve.sampler import greedy_sample, temperature_sample
from repro_torch.sparse.artifact import PrunedArtifact

__all__ = ["PrunedArtifact", "Request", "Result", "ServeEngine",
           "greedy_sample", "temperature_sample"]
