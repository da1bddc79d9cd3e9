"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``pattern_gemm``, ``flash_attention``, ``column_gemm`` and
``pattern_conv`` replace the four Pallas kernels of ``repro/kernels``; on
a CPU tensor each wrapper runs its plain version, on a CUDA tensor it
launches the kernel (built from ``csrc/`` on first use by ``_build``) or
raises.
"""
