"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips without an NVIDIA card (the CUDA kernels have no CPU mode). Imports
no jax, so it also runs on the card's machine, which has none:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are the reference's (``tests/test_kernels.py::_tol``): fp32
2e-5, bf16 2e-2. Shapes cover every kernel variant: the decode variant
with and without its K split (M <= 16), the ragged M edge of the tiled
variants, block_p 32/64/128, every epilogue, ragged S, GQA, windows.
"""

import pytest
import torch

from repro_torch.core.projections import project_tile_pattern
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pattern_gemm as pg
from repro_torch.kernels.ref import ref_gemm

ACTS = (None, "relu", "silu", "gelu")
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pattern_gemm_kernel_matches_plain(cuda, dtype):
    tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    for Q, P, bp in ((1536, 256, 128), (768, 512, 64), (64, 96, 32)):
        w = (torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5).to(dtype)
        w = project_tile_pattern(w.T, block_p=bp).T.contiguous()
        wpb, li = pg.pack_tile_pattern_blocked(w, block_p=bp)
        b = torch.randn(P, generator=g, device=cuda).to(dtype)
        for M in (1, 4, 16, 17, 100, 129):
            x = torch.randn(M, Q, generator=g, device=cuda).to(dtype)
            for act in ACTS:
                got = pg.pattern_gemm(x, wpb, li, b, activation=act)
                want = pg.pattern_gemm_ref(x, wpb, li, b, activation=act)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
            assert torch.allclose(pg.pattern_gemm(x, wpb, li).float(),
                                  ref_gemm(x, w).float(), rtol=tol, atol=tol)


def test_pattern_gemm_rejects_bad_operands(cuda):
    x = torch.zeros(4, 64, device=cuda)
    wpb = torch.zeros(1, 32, 128, device=cuda)
    li = torch.zeros(1, 32, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        pg.pattern_gemm(x, wpb, li)
    with pytest.raises(TypeError):
        pg.pattern_gemm(x.bfloat16(), wpb, li.int())
    with pytest.raises(ValueError):
        pg.pattern_gemm(x, torch.zeros(1, 32, 16, device=cuda), li.int())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, dtype):
    tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, S, H, KV, hd, causal, window in ((2, 70, 4, 2, 64, True, None),
                                            (1, 130, 6, 3, 128, False, 50),
                                            (2, 64, 4, 4, 32, True, 16),
                                            (4, 200, 12, 2, 128, True, None)):
        q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_launch_counters_count_kernel_launches_only(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = project_tile_pattern(torch.randn(128, 64, device=cuda),
                             block_p=128).T.contiguous()
    wpb, li = pg.pack_tile_pattern_blocked(w)
    before = pg.LAUNCHES
    pg.pattern_gemm(x, wpb, li)
    pg.pattern_gemm_ref(x, wpb, li)
    assert pg.LAUNCHES == before + 1
