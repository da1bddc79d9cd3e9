"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``kernels/``, ``sparse/``, ``core/``, ``models/``,
``serve/``, ``configs/``) and never imports ``jax`` or ``repro``.

Slice covered so far — packed serving of a tile-pattern-pruned dense LM:

    model    = LM(get_config("qwen2-1.5b"))                  # on cuda
    params   = model.init(torch.Generator("cuda").manual_seed(0))
    artifact = greedy_prune(params, PruneConfig(scheme="tile_pattern"))
    engine   = ServeEngine(model, artifact.pack(), packed=True,
                           batch_size=4, max_seq_len=544)
    results  = engine.generate([Request(uid=0, prompt=[1, 2, 3])])

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the tests do); with no card and no explicit CPU request
it raises instead of dropping to the CPU.
"""
