"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips without an NVIDIA card (the CUDA kernels have no CPU mode). Imports
no jax, so it also runs on the card's machine, which has none:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances are the reference's (``tests/test_kernels.py::_tol``): fp32
2e-5, bf16 2e-2. Shapes cover every kernel variant: the decode variant
with and without its K split (M <= 16), the ragged M edge of the tiled
variants, the wgmma variant at 64- and 128-row tiles with and without its
K split, block_p 32/64/128, ragged K and P, a lane table that is not
banded, every epilogue, ragged S, GQA, windows; flash attention's wgmma
route at 64- and 128-row blocks and its simt route; the conv's wgmma
route over small and large images, narrow and wide channel tiles, and its
wmma route at C = 3.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.projections import project, project_column, project_tile_pattern
from repro_torch.kernels import column_gemm as cg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pattern_conv as pc
from repro_torch.kernels import pattern_gemm as pg
from repro_torch.kernels.ref import ref_conv3x3, ref_gemm

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
                                            (4, 200, 12, 2, 128, True, None),
                                            (8, 15, 4, 2, 16, True, None),
                                            (2, 40, 4, 2, 16, True, 32)):
        q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=g, device=cuda).to(dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _packed_conv(g, A, C, dtype, cuda):
    w4 = torch.randn(A, C, 3, 3, generator=g, device=cuda) * (2 / (9 * C)) ** 0.5
    w4 = project(w4, "pattern_shared", alpha=0.5).to(dtype)
    wp, taps = pc.pack_pattern_conv(w4, pc.assign_channel_patterns(w4))
    return w4, wp, taps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pattern_conv_kernel_matches_plain(cuda, dtype):
    tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    for B, H, W, C, A in ((2, 9, 20, 3, 64), (3, 7, 7, 16, 40),
                          (9, 4, 4, 32, 128), (3, 1, 1, 8, 64),
                          (1, 17, 33, 12, 136), (2, 14, 14, 64, 256)):
        w4, wp, taps = _packed_conv(g, A, C, dtype, cuda)
        x = torch.randn(B, H, W, C, generator=g, device=cuda).to(dtype)
        b = (torch.randn(A, generator=g, device=cuda) * 0.1).to(dtype)
        for act in ACTS:
            got = pc.pattern_conv(x, wp, taps, b, activation=act)
            want = pc.pattern_conv_ref(x, wp, taps, b, activation=act)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            oracle = ref_conv3x3(x, w4)          # fp32 conv, no TF32
        torch.testing.assert_close(pc.pattern_conv(x, wp, taps).float(),
                                   oracle.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_gemm_kernel_matches_plain(cuda, dtype):
    tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    for Q, P, alpha in ((300, 256, 0.37), (1536, 200, 0.5), (64, 1000, 0.5),
                        (2048, 1536, 0.5)):
        w = torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5
        w = project_column(w.T, alpha=alpha).T.contiguous().to(dtype)
        wp, kept = cg.pack_columns(w)
        b = (torch.randn(P, generator=g, device=cuda) * 0.1).to(dtype)
        for M in (1, 4, 9, 16, 17, 130):
            x = torch.randn(M, Q, generator=g, device=cuda).to(dtype)
            for act in ACTS:
                got = cg.column_gemm(x, wp, kept, b, activation=act)
                want = cg.column_gemm_ref(x, wp, kept, b, activation=act)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
            assert torch.allclose(cg.column_gemm(x, wp, kept).float(),
                                  ref_gemm(x, w).float(), rtol=tol, atol=tol)


def test_conv_and_column_reject_bad_operands(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    _, wp, taps = _packed_conv(g, 64, 8, torch.float32, cuda)
    x = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        pc.pattern_conv(x, wp, taps.long())
    with pytest.raises(TypeError):
        pc.pattern_conv(x.bfloat16(), wp, taps)
    with pytest.raises(ValueError):
        pc.pattern_conv(x, wp, taps[:4])
    with pytest.raises(ValueError):
        pc.pattern_conv(x.permute(0, 2, 1, 3), wp, taps)
    w = torch.zeros(16, 8, device=cuda)
    w[::2] = 1.0
    wp, kept = cg.pack_columns(w)
    xm = torch.zeros(4, 16, device=cuda)
    with pytest.raises(TypeError):
        cg.column_gemm(xm, wp, kept.long())
    with pytest.raises(TypeError):
        cg.column_gemm(xm.bfloat16(), wp, kept)
    with pytest.raises(ValueError):
        cg.column_gemm(xm, wp, kept[:3])


def test_launch_counters_count_kernel_launches_only(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = project_tile_pattern(torch.randn(128, 64, device=cuda),
                             block_p=128).T.contiguous()
    wpb, li = pg.pack_tile_pattern_blocked(w)
    before = pg.LAUNCHES
    pg.pattern_gemm(x, wpb, li)
    pg.pattern_gemm_ref(x, wpb, li)
    assert pg.LAUNCHES == before + 1
    wp, kept = cg.pack_columns(project_column(w.T, alpha=0.5).T)
    before = cg.LAUNCHES
    cg.column_gemm(x, wp.contiguous(), kept)
    cg.column_gemm_ref(x, wp, kept)
    assert cg.LAUNCHES == before + 1
    g = torch.Generator(device=cuda).manual_seed(0)
    _, wp, taps = _packed_conv(g, 64, 8, torch.float32, cuda)
    xc = torch.randn(2, 5, 5, 8, device=cuda)
    before = pc.LAUNCHES
    pc.pattern_conv(xc, wp, taps)
    pc.pattern_conv_ref(xc, wp, taps)
    assert pc.LAUNCHES == before + 1


WGMMA_MS = (17, 64, 100, 129, 2048)


def _tile_packed(g, Q, P, bp, cuda):
    w = (torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5).bfloat16()
    w = project_tile_pattern(w.T, block_p=bp).T.contiguous()
    return w, *pg.pack_tile_pattern_blocked(w, block_p=bp)


def _check_pattern(x, wpb, li, b, act):
    got = pg.pattern_gemm(x, wpb, li, b, activation=act)
    want = pg.pattern_gemm_ref(x, wpb, li, b, activation=act)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("bp", [32, 64, 128])
def test_pattern_gemm_wgmma_matches_plain(cuda, bp):
    g = torch.Generator(device=cuda).manual_seed(1)
    Q, P = 768, 512                   # Kp = 384: six 64-deep K stages
    _, wpb, li = _tile_packed(g, Q, P, bp, cuda)
    b = (torch.randn(P, generator=g, device=cuda) * 0.1).bfloat16()
    for M in WGMMA_MS:
        assert pg.tiled_variant(M, Q, li.shape[1], torch.bfloat16) == "wgmma"
        x = torch.randn(M, Q, generator=g, device=cuda).bfloat16()
        for act in ACTS:
            for bias in (b, None):
                _check_pattern(x, wpb, li, bias, act)


def test_pattern_gemm_wgmma_lane_table_not_banded(cuda):
    """Sorted random lanes over all of x: most fall outside the staged
    band and are read from device memory."""
    rng = np.random.default_rng(0)
    g = torch.Generator(device=cuda).manual_seed(2)
    Q, Kp, bp, nb = 1024, 320, 128, 3          # Kp % 64 != 0: ragged too
    li = np.stack([np.sort(rng.choice(Q, Kp, replace=False))
                   for _ in range(nb)]).astype(np.int32)
    li = torch.from_numpy(li).to(cuda)
    wpb = (torch.randn(nb, Kp, bp, generator=g, device=cuda) / Kp ** 0.5
           ).bfloat16()
    b = (torch.randn(nb * bp, generator=g, device=cuda) * 0.1).bfloat16()
    for M in (17, 129, 2048):
        x = torch.randn(M, Q, generator=g, device=cuda).bfloat16()
        _check_pattern(x, wpb, li, b, "silu")
        _check_pattern(x, wpb, li, None, None)


def _check_column(x, wp, kept, b, act):
    got = cg.column_gemm(x, wp, kept, b, activation=act)
    want = cg.column_gemm_ref(x, wp, kept, b, activation=act)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("Q,P,alpha", [(1536, 256, 0.5),   # K = 768
                                       (300, 520, 0.37),   # K = 111
                                       (200, 136, 0.5)])   # K = 100
def test_column_gemm_wgmma_matches_plain(cuda, Q, P, alpha):
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5
    w = project_column(w.T, alpha=alpha).T.contiguous().bfloat16()
    wp, kept = cg.pack_columns(w)
    b = (torch.randn(P, generator=g, device=cuda) * 0.1).bfloat16()
    for M in WGMMA_MS:
        assert cg.tiled_variant(M, *wp.shape, torch.bfloat16) == "wgmma"
        x = torch.randn(M, Q, generator=g, device=cuda).bfloat16()
        for act in ACTS:
            for bias in (b, None):
                _check_column(x, wp, kept, bias, act)


def test_column_gemm_ragged_p_routes_to_wmma(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    Q, P = 512, 1002                           # P % 8 != 0: no TMA map
    w = torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5
    w = project_column(w.T, alpha=0.5).T.contiguous().bfloat16()
    wp, kept = cg.pack_columns(w)
    b = (torch.randn(P, generator=g, device=cuda) * 0.1).bfloat16()
    for M in (17, 129, 300):
        assert cg.tiled_variant(M, *wp.shape, torch.bfloat16) == "wmma"
        x = torch.randn(M, Q, generator=g, device=cuda).bfloat16()
        for act in ACTS:
            _check_column(x, wp, kept, b, act)


def test_wmma_tile_matches_plain_where_wgmma_would_run(cuda):
    """The WMMA tile (the route for shapes TMA cannot describe) held to the
    plain versions at shapes the wgmma variant takes; a variant that does
    not take the call raises."""
    g = torch.Generator(device=cuda).manual_seed(6)
    _, wpb, li = _tile_packed(g, 768, 512, 128, cuda)
    w = torch.randn(768, 512, generator=g, device=cuda) / 768 ** 0.5
    wp, kept = cg.pack_columns(
        project_column(w.T, alpha=0.5).T.contiguous().bfloat16())
    b = (torch.randn(512, generator=g, device=cuda) * 0.1).bfloat16()
    for M in (17, 129, 2048):
        x = torch.randn(M, 768, generator=g, device=cuda).bfloat16()
        for act in ACTS:
            torch.testing.assert_close(
                pg._launch(x, wpb, li, b, act, "wmma").float(),
                pg.pattern_gemm_ref(x, wpb, li, b, activation=act).float(),
                rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(
                cg._launch(x, wp, kept, b, act, "wmma").float(),
                cg.column_gemm_ref(x, wp, kept, b, activation=act).float(),
                rtol=2e-2, atol=2e-2)
    with pytest.raises(RuntimeError):
        pg._launch(x, wpb, li, None, None, "skinny")        # M = 2048
    with pytest.raises(RuntimeError):
        cg._launch(x, wp, kept, None, None, "simt")          # bf16 input


def test_tiled_kernels_repeat_bit_equal(cuda):
    """Two calls on the same inputs give the same bits, K split or not."""
    g = torch.Generator(device=cuda).manual_seed(5)
    _, wpb, li = _tile_packed(g, 1536, 256, 128, cuda)
    w = torch.randn(1536, 1536, generator=g, device=cuda) / 1536 ** 0.5
    wp, kept = cg.pack_columns(
        project_column(w.T, alpha=0.5).T.contiguous().bfloat16())
    for M in (17, 2048):       # pattern_gemm splits K at both (two panels)
        x = torch.randn(M, 1536, generator=g, device=cuda).bfloat16()
        assert torch.equal(pg.pattern_gemm(x, wpb, li),
                           pg.pattern_gemm(x, wpb, li))
        assert torch.equal(cg.column_gemm(x, wp, kept, activation="gelu"),
                           cg.column_gemm(x, wp, kept, activation="gelu"))


# (B, S, H, KV, hd, causal, window): the served shape, ragged S, GQA
# ratios 1, 2 and 6 at hd 64, windows, not causal
FLASH_WGMMA_CASES = (
    (4, 512, 12, 2, 128, True, None),
    (4, 70, 12, 2, 128, True, None),
    (4, 200, 12, 2, 128, True, None),
    (2, 130, 4, 4, 64, True, None),
    (2, 130, 4, 2, 64, True, None),
    (1, 300, 12, 2, 64, True, None),
    (2, 200, 6, 3, 128, True, 50),
    (1, 260, 4, 2, 64, True, 100),
    (2, 200, 6, 2, 64, False, None),
    (1, 130, 4, 2, 128, False, 40),
    # hd 80 (h2o-danube-1.8b's 32 / 8 heads): the HD = 128 instance on
    # 80-column maps, ragged S, windows, not causal
    (2, 300, 32, 8, 80, True, None),
    (1, 260, 32, 8, 80, True, 100),
    (1, 70, 4, 1, 80, True, 64),
    (2, 200, 8, 2, 80, False, None),
)


def _qkv(g, B, S, H, KV, hd, cuda, dtype=torch.bfloat16):
    return (torch.randn(B, S, n, hd, generator=g, device=cuda).to(dtype)
            for n in (H, KV, KV))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_WGMMA_CASES)
def test_flash_wgmma_matches_plain(cuda, B, S, H, KV, hd, causal, window):
    """The wgmma route (64- or 128-row blocks, as flash_plan picks) and the
    simt route forced at the same shape, both against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = _qkv(g, B, S, H, KV, hd, cuda)
    assert fa.flash_variant(S, hd, q.dtype, window, causal) == "wgmma"
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    simt = fa._launch(q, k, v, causal, window, None, "simt")
    torch.testing.assert_close(simt.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("window", [None, 100])
def test_flash_hd80_fp32_simt_matches_plain(cuda, window):
    """fp32 at hd 80 runs the simt kernel within the fp32 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(80)
    q, k, v = _qkv(g, 2, 260, 32, 8, 80, cuda, torch.float32)
    assert fa.flash_variant(260, 80, q.dtype, window, True) == "simt"
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_wgmma_refuses_what_it_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = _qkv(g, 1, 64, 2, 1, 128, cuda, torch.float32)
    with pytest.raises(RuntimeError):
        fa._launch(q, k, v, True, None, None, "wgmma")          # fp32
    q, k, v = _qkv(g, 1, 64, 2, 1, 32, cuda)
    with pytest.raises(RuntimeError):
        fa._launch(q, k, v, True, None, None, "wgmma")          # hd 32


CONV_WGMMA_IMAGES = ((3, 1, 1), (9, 4, 4), (5, 7, 7), (2, 14, 14),
                     (1, 224, 224))


@pytest.mark.parametrize("C,A", [(16, 40), (64, 64), (512, 512)])
def test_pattern_conv_wgmma_matches_plain(cuda, C, A):
    """Against the plain version (every epilogue) and the fp32 oracle, at
    1 x 1 to 224 x 224 images, an A below the 64-wide channel tile, one
    channel tile and a split over two or more."""
    g = torch.Generator(device=cuda).manual_seed(C + A)
    w4, wp, taps = _packed_conv(g, A, C, torch.bfloat16, cuda)
    b = (torch.randn(A, generator=g, device=cuda) * 0.1).bfloat16()
    assert pc.conv_variant(C, A, torch.bfloat16) == "wgmma"
    for B, H, W in CONV_WGMMA_IMAGES:
        x = torch.randn(B, H, W, C, generator=g, device=cuda).bfloat16()
        for act in ACTS:
            got = pc.pattern_conv(x, wp, taps, b, activation=act)
            want = pc.pattern_conv_ref(x, wp, taps, b, activation=act)
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            oracle = ref_conv3x3(x, w4)          # fp32 conv, no TF32
        torch.testing.assert_close(pc.pattern_conv(x, wp, taps).float(),
                                   oracle.float(), rtol=2e-2, atol=2e-2)


def test_pattern_conv_wmma_route(cuda):
    """C = 3 (VGG-16's first conv, the ResNet-18 stem) stays on the WMMA
    tile; the WMMA tile also holds at a shape the wgmma route takes; the
    wgmma route refuses C = 3."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for C, A, (B, H, W) in ((3, 64, (2, 32, 32)), (3, 64, (1, 224, 224)),
                            (64, 128, (2, 14, 14))):
        _, wp, taps = _packed_conv(g, A, C, torch.bfloat16, cuda)
        b = (torch.randn(A, generator=g, device=cuda) * 0.1).bfloat16()
        x = torch.randn(B, H, W, C, generator=g, device=cuda).bfloat16()
        want = pc.pattern_conv_ref(x, wp, taps, b, activation="relu")
        if C == 3:
            assert pc.conv_variant(C, A, torch.bfloat16) == "wmma"
            got = pc.pattern_conv(x, wp, taps, b, activation="relu")
            with pytest.raises(RuntimeError):
                pc._launch(x, wp, taps, b, "relu", "wgmma")
        else:
            got = pc._launch(x, wp, taps, b, "relu", "wmma")
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_flash_and_conv_wgmma_repeat_bit_equal(cuda):
    """Two calls on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    for S in (128, 512):
        q, k, v = _qkv(g, 4, S, 12, 2, 128, cuda)
        assert torch.equal(fa.flash_attention(q, k, v),
                           fa.flash_attention(q, k, v))
    for C, A, H in ((64, 64, 56), (512, 512, 14)):
        _, wp, taps = _packed_conv(g, A, C, torch.bfloat16, cuda)
        x = torch.randn(8, H, H, C, generator=g, device=cuda).bfloat16()
        assert torch.equal(pc.pattern_conv(x, wp, taps, activation="relu"),
                           pc.pattern_conv(x, wp, taps, activation="relu"))


# ------------------------------------------------- CUDA graphs of serving

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import PruneConfig, greedy_prune  # noqa: E402
from repro_torch.models import LM, attention  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.sampler import (  # noqa: E402
    fold_key_grid,
    mix64,
    uniform_bits,
)

# head_dim 64 and bf16: prefill attention on flash's wgmma route
GRAPH_CFG = ModelConfig(name="graph", family="dense", num_layers=2,
                        d_model=256, num_heads=4, num_kv_heads=2,
                        head_dim=64, d_ff=512, vocab_size=1024,
                        qkv_bias=True, param_dtype="bfloat16")
GRAPH_PCFG = PruneConfig(scheme="tile_pattern", overrides={
    ".*": {"tile_block_p": 128, "tile_group_q": 8, "tile_keep": 4}})


@pytest.fixture(scope="module")
def lm_art():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs run only there")
    model = LM(GRAPH_CFG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    return model, greedy_prune(params, GRAPH_PCFG).pack()


def _requests(n, S, *, temperature=None, seed=None, first=0):
    g = torch.Generator().manual_seed(first)
    return [Request(uid=first + i, prompt=torch.randint(
        0, GRAPH_CFG.vocab_size, (S,), generator=g), max_new_tokens=12,
        temperature=temperature, seed=None if seed is None else seed + i)
        for i in range(n)]


@pytest.mark.parametrize("temperature", [None, 0.8])
def test_graphs_match_eager_prefill_and_decode_many(lm_art, temperature):
    """Prefill-graph logits and decode-graph tokens (greedy, and seeded
    temperature) bit-identical to eager ``LM.prefill`` and
    ``LM.decode_many`` on the same chunk; one empty slot."""
    model, art = lm_art
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=64)
    reqs = _requests(3, 16, temperature=temperature, seed=5)
    prompts, mask = eng.pad_prompts(reqs)
    eng.set_rows(reqs, mask)
    _, logits = eng.prefill(prompts)
    cache, want_logits = model.prefill(eng.params, prompts, 64)
    assert torch.equal(logits, want_logits)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), 12)
    tok0 = eng.sample(logits, keys[0])
    got = eng.decode(tok0, 11).clone()
    _, rest = model.decode_many(eng.params, cache, tok0, 11,
                                sampler=eng.sample, keys=keys[1:])
    assert torch.equal(got, torch.cat([tok0, rest], dim=1))
    assert int(got[3].abs().sum()) == 0               # the empty slot


def test_replay_after_a_new_prefill_of_another_chunk(lm_art):
    model, art = lm_art
    a, b = _requests(4, 24), _requests(3, 9, temperature=1.0, seed=7,
                                       first=10)
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=64)
    eng.generate(a)
    got = [r.tokens for r in eng.generate(b)]
    fresh = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=64)
    assert got == [r.tokens for r in fresh.generate(b)]
    assert sorted(eng.prefill_graphs) == [9, 24]


def test_bake_weights_refuses_swapped_params(lm_art):
    """The weights are baked into the engine's graphs (the reference's
    ``bake_weights``): serving other params raises."""
    model, art = lm_art
    reqs = _requests(2, 8)
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=64)
    eng.generate(reqs)
    eng.params = art.bind(model, packed=False)
    with pytest.raises(ValueError, match="baked"):
        eng.generate(reqs)


def test_prefill_graphs_share_one_pool_and_are_capped(lm_art):
    """Eleven prompt lengths, longest first: the engine keeps the
    ``MAX_PREFILL_GRAPHS`` most recent prefill graphs, the shared pool does
    not grow past what the first chunk's captures reserved, and a length
    whose graph was dropped is captured again to the same tokens."""
    from repro_torch.serve.engine import MAX_PREFILL_GRAPHS

    model, art = lm_art
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=64)
    lengths = list(range(40, 7, -3))
    first = [r.tokens for r in eng.generate(_requests(3, lengths[0]))]
    pool = eng.graph_pool.reserved
    assert pool > 0
    for S in lengths[1:]:
        eng.generate(_requests(2, S, first=S))
    assert list(eng.prefill_graphs) == lengths[-MAX_PREFILL_GRAPHS:]
    assert eng.graph_pool.reserved == pool
    assert [r.tokens for r in eng.generate(_requests(3, lengths[0]))] == first
    assert list(eng.prefill_graphs) == (lengths[1 - MAX_PREFILL_GRAPHS:]
                                        + lengths[:1])


def test_seeded_request_reproduces_across_engine_seeds(lm_art):
    """A seeded temperature request gives the same tokens on engines of
    seed 0 and 1; its unseeded batch-mates draw from the engine's seed."""
    model, art = lm_art
    reqs = ([_requests(1, 16, temperature=0.9, seed=11)[0]]
            + _requests(2, 16, temperature=1.0, first=20))
    got = [[r.tokens for r in ServeEngine(
        model, art, packed=True, batch_size=4, max_seq_len=64,
        seed=seed).generate(reqs)] for seed in (0, 1)]
    assert got[0][0] == got[1][0]
    assert got[0][1:] != got[1][1:]


def _zero_counts():
    for m in (pg, fa, cg, pc):
        m.LAUNCHES = 0
    fa.ROUTE_LAUNCHES.update(dict.fromkeys(fa.ROUTE_LAUNCHES, 0))
    attention.PREFILL_FALLBACKS = 0


def test_graph_counted_launches_equal_eager_launches(lm_art):
    model, art = lm_art
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=64)
    reqs = _requests(4, 32)
    prompts, mask = eng.pad_prompts(reqs)
    eng.set_rows(reqs, mask)
    eng.prefill(prompts)                       # captures; counts warm-up
    eng.decode(torch.zeros((4, 1), dtype=torch.int64, device="cuda"), 1)
    _zero_counts()
    cache, logits = model.prefill(eng.params, prompts, 64)
    tok = logits.argmax(-1)
    model.decode_step(eng.params, cache, tok)
    eager = (pg.LAUNCHES, fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES))
    _zero_counts()
    eng.prefill(prompts)
    eng.decode(tok, 1)
    torch.cuda.synchronize()
    assert (pg.LAUNCHES, fa.LAUNCHES, dict(fa.ROUTE_LAUNCHES)) == eager
    assert eager[1] == GRAPH_CFG.num_layers == eager[2]["wgmma"]
    # per decode step: 7 GEMMs a layer and the head
    before = pg.LAUNCHES
    eng.decode_graph.graph.replay()
    assert pg.LAUNCHES - before == 7 * GRAPH_CFG.num_layers + 1


def test_sampler_integer_stream_is_the_same_on_cpu_and_card(cuda):
    keys = torch.tensor([0, 1, -1, 1 << 62, -(1 << 63)], dtype=torch.int64)
    assert torch.equal(mix64(keys.to(cuda)).cpu(), mix64(keys))
    assert torch.equal(uniform_bits(keys.to(cuda), 4096).cpu(),
                       uniform_bits(keys, 4096))
    grid = fold_key_grid(keys, torch.arange(5), 7)
    assert torch.equal(fold_key_grid(keys.to(cuda), torch.arange(5).to(cuda),
                                     7).cpu(), grid)


# ------------------------- prefill fallback, prune launcher, kill and resume

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import LMAdapter, PrivacyPreservingPruner  # noqa: E402
from repro_torch.core import as_key  # noqa: E402
from repro_torch.launch.prune import prune_config_for  # noqa: E402
from repro_torch.models.attention import prefill_attention  # noqa: E402
from repro_torch.utils.tree import tree_items  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")


def test_serve_launcher_reduced_prefills_through_the_fallback(cuda):
    """``launch.serve --reduced`` (head_dim 16) serves on the card: every
    prefill launches the flash kernel on its SIMT route (head_dim 16 has
    no wgmma instance) and none falls back to blockwise attention."""
    from repro_torch.launch import serve

    _zero_counts()
    results = serve.main(["--arch", "qwen2-1.5b", "--reduced", "--requests",
                          "3", "--max-new", "5"])
    assert [len(r.tokens) for r in results] == [5, 5, 5]
    assert fa.LAUNCHES > 0 and fa.ROUTE_LAUNCHES["simt"] == fa.LAUNCHES
    assert attention.PREFILL_FALLBACKS == 0


def test_supported_shape_takes_flash_and_counts_no_fallback(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for hd, route in ((64, "wgmma"), (16, "simt"), (24, None)):
        cfg = reduced_config("qwen2-1.5b", head_dim=hd,
                             param_dtype="bfloat16")
        model = LM(cfg, device=cuda)
        params = model.init(g)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                               device=cuda)
        _zero_counts()
        model.prefill(params, tokens, 32)
        torch.cuda.synchronize()
        L = cfg.num_layers
        if route:
            assert (fa.LAUNCHES, fa.ROUTE_LAUNCHES[route],
                    attention.PREFILL_FALLBACKS) == (L, L, 0)
        else:
            assert (fa.LAUNCHES, attention.PREFILL_FALLBACKS) == (0, L)
        _zero_counts()                   # training forwards never ask
        model.hidden_states(params, tokens)
        assert fa.LAUNCHES == 0 and attention.PREFILL_FALLBACKS == 0
    q = torch.randn(2, 128, 8, 64, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, 128, 2, 64, generator=g, device=cuda).bfloat16()
    v = torch.randn(2, 128, 2, 64, generator=g, device=cuda).bfloat16()
    torch.testing.assert_close(
        prefill_attention(q, k, v, use_flash=True).float(),
        prefill_attention(q, k, v, use_flash=False).float(),
        rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])


def test_ragged_prefill_at_full_width_takes_flash(cuda):
    """qwen2-1.5b's full width (hd 128, 12 of 2 heads) at 2 layers: a
    600-token prefill, which the reference's Pallas tiling would refuse,
    runs every attention call on the wgmma flash kernel with no blockwise
    fallback, eagerly and through the engine's graphs (prompts of 600 and
    37 tokens, padded to 600)."""
    import dataclasses

    from repro_torch.launch.serve import make_engine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=2)
    model = LM(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 600), generator=g)
    _zero_counts()
    _, logits = model.prefill(params, tokens.to(cuda), 640)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits.float()).all())
    assert (fa.LAUNCHES, fa.ROUTE_LAUNCHES["wgmma"],
            attention.PREFILL_FALLBACKS) == (2, 2, 0)
    eng = make_engine(model, params, batch=2, max_seq=608, packed=False)
    reqs = [Request(uid=0, prompt=tokens[0], max_new_tokens=4),
            Request(uid=1, prompt=tokens[0, :37], max_new_tokens=4)]
    eng.generate(reqs)                         # captures the graphs
    _zero_counts()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    assert [len(r.tokens) for r in results] == [4, 4]
    assert (fa.LAUNCHES, fa.ROUTE_LAUNCHES["wgmma"],
            attention.PREFILL_FALLBACKS) == (2, 2, 0)


def _launcher(module, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_prune_then_serve_launchers_on_the_card(cuda, tmp_path):
    art = str(tmp_path / "artifact")
    _launcher("repro_torch.launch.prune", "--arch", "qwen2-1.5b",
              "--reduced", "--scheme", "tile_pattern", "--rate", "2",
              "--iters", "2", "--tile-block", "32", "--out",
              str(tmp_path / "out"), "--artifact-out", art)
    with open(os.path.join(art, "artifact.json")) as f:
        assert json.load(f)["meta"]["privacy"]["data"] == "synthetic"
    out = _launcher("repro_torch.launch.serve", "--arch", "qwen2-1.5b",
                    "--reduced", "--artifact", art, "--packed",
                    "--requests", "2", "--max-new", "6")
    assert "packed, cuda" in out


def test_prune_then_serve_danube_launchers_on_the_card(cuda, tmp_path):
    """``--arch h2o-danube-1.8b --reduced`` (window 32, head_dim 16: flash's
    SIMT route with the window) pruned and served packed on the
    card, prompts of 40 tokens past the ring of 32."""
    art = str(tmp_path / "artifact")
    _launcher("repro_torch.launch.prune", "--arch", "h2o-danube-1.8b",
              "--reduced", "--scheme", "tile_pattern", "--rate", "2",
              "--iters", "2", "--seq", "40", "--tile-block", "32", "--out",
              str(tmp_path / "out"), "--artifact-out", art)
    out = _launcher("repro_torch.launch.serve", "--arch", "h2o-danube-1.8b",
                    "--reduced", "--artifact", art, "--packed",
                    "--requests", "2", "--prompt-len", "40", "--max-new",
                    "6")
    assert "packed, cuda" in out


class _Killed(Exception):
    pass


def test_killed_and_resumed_prune_is_bit_identical_on_the_card(cuda,
                                                                tmp_path):
    """4 layers, 4 iterations, a checkpoint every 2: a run stopped by its
    callback after iteration 2 and resumed ends bit-identical (params, Z,
    U, key and history) to an uninterrupted one. fp32 params, so the
    primal steps move the weights (bf16 rounds them back): the pruned
    result differs from the greedy projection of the teacher."""
    cfg = reduced_config("qwen2-1.5b", num_layers=4, param_dtype="float32")
    model = LM(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    pcfg = prune_config_for(scheme="tile_pattern", rate=2, iters=4, batch=4,
                            tile_block=32)

    def run(d, **kw):
        return PrivacyPreservingPruner(LMAdapter(model, seq_len=16), pcfg).run(
            as_key(1), params, checkpoint_dir=str(tmp_path / d),
            save_every=2, **kw)

    def kill(it, metrics):
        if it == 1:
            raise _Killed

    whole = run("a")
    with pytest.raises(_Killed):
        run("b", callback=kill)
    resumed = run("b", resume=True)
    assert resumed.history == whole.history
    final = [dict(tree_items(load_pytree(str(tmp_path / d / "step_000000004"),
                                         device="cpu"))) for d in "ab"]
    assert final[0].keys() == final[1].keys()
    for p in final[0]:
        assert torch.equal(final[0][p], final[1][p]), p
    for p, w in tree_items(whole.params):
        assert torch.equal(w, dict(tree_items(resumed.params))[p]), p
    greedy = dict(tree_items(greedy_prune(params, pcfg, device=cuda).params))
    assert any(not torch.equal(w, greedy[p])
               for p, w in tree_items(whole.params))


from repro_torch.models import vgg16  # noqa: E402
from repro_torch.sparse import PrunedArtifact  # noqa: E402


def _pipeline(out, arch, *extra):
    from repro_torch.launch import pipeline

    return pipeline.main(["--arch", arch, "--reduced", "--quick", "--out",
                          str(out), "--bench-path", str(out / "bench.json"),
                          *extra])


@pytest.mark.parametrize("arch", ["vgg16", "qwen2-1.5b"])
def test_reduced_pipeline_on_the_card(cuda, tmp_path, arch):
    """The service end to end on the card (the default device) at the
    reference's reduced geometry: six stages ok, each stage's peak device
    memory in telemetry.json, the privacy block with its MIA numbers in
    the manifest, and the artifact loads on the card with every packed
    leaf valid."""
    assert _pipeline(tmp_path, arch) == 0
    stages = json.load(open(tmp_path / arch / "progress.json"))["stages"]
    assert [s["status"] for s in stages] == ["ok"] * 6
    gauges = json.load(open(tmp_path / arch / "telemetry.json"))[
        "metrics"]["gauges"]
    peaks = {g["labels"]["stage"]: g["value"] for g in gauges
             if g["name"] == "pipeline.stage_peak_device_bytes"}
    assert sorted(peaks) == sorted(s["name"] for s in stages)
    assert all(v > 0 for v in peaks.values())
    cfg = reduced_config(arch) if arch != "vgg16" else None
    art = PrunedArtifact.load(str(tmp_path / arch / "artifact"), cfg=cfg)
    assert art.privacy["data"] == "synthetic"
    assert art.privacy["retrained_on"] == "client_confidential"
    assert 0.0 <= art.privacy["mia"]["attack_auc"] <= 1.0
    assert art.verify_integrity()["packed_bad"] == {}
    assert art.summary()["packed_leaves"] > 0
    if arch == "vgg16":
        model = vgg16(10, width_mult=0.125, image_hwc=(16, 16, 3))
        tree = art.bind(model, packed=True)
        pc.LAUNCHES = 0
        x = model.synthetic_batch(torch.Generator(device=cuda).manual_seed(0),
                                  4)
        assert bool(torch.isfinite(model.apply(tree, x)).all())
        assert pc.LAUNCHES == 13 and art.bind_report["fallbacks"] == {}


def test_pipeline_killed_at_retrain_resumes_bit_equal_on_the_card(
        cuda, tmp_path, monkeypatch):
    """Retrain fails once with no retries: a ``StageError`` naming it;
    ``--resume`` restores teacher and prune and saves params bit-equal to
    an uninterrupted run's (deterministic conv algorithms on the card)."""
    from repro_torch.privacy import report
    from repro_torch.runtime import StageError

    assert _pipeline(tmp_path / "a", "vgg16", "--no-mia") == 0
    real, fails = report.make_ops, [1]

    def make_ops(*a, **k):
        ops = real(*a, **k)
        inner = ops.retrain

        def retrain(params, masks):
            if fails:
                fails.pop()
                raise RuntimeError("injected fault in retrain")
            return inner(params, masks)

        ops.retrain = retrain
        return ops

    monkeypatch.setattr(report, "make_ops", make_ops)
    with pytest.raises(StageError) as err:
        _pipeline(tmp_path / "b", "vgg16", "--no-mia", "--stage-retries", "0")
    assert err.value.stage == "retrain"
    assert _pipeline(tmp_path / "b", "vgg16", "--no-mia", "--resume") == 0
    stages = json.load(open(tmp_path / "b" / "vgg16" / "progress.json"))[
        "stages"]
    assert [s["attempts"] for s in stages[:3]] == [0, 0, 1]
    a, b = (dict(tree_items(load_pytree(
        str(tmp_path / d / "vgg16" / "artifact" / "params"), device="cpu")))
        for d in "ab")
    assert a.keys() == b.keys()
    for p in a:
        assert torch.equal(a[p], b[p]), p


# ------------------------------------------------ continuous batching

import dataclasses  # noqa: E402
import re  # noqa: E402

from repro_torch.serve import ContinuousEngine  # noqa: E402

# the device functions one pattern_gemm / flash_attention launch runs
TRACED = {"pattern_gemm": r"(^|[ :])(pg_skinny|pg_wmma_bf16|pg_simt_f32|"
                          r"gemm_bf16)[<(]",
          "flash_attention": r"(^|[ :])(flash_fwd|flash_wgmma)[<(]"}


def _mixed_requests(vocab, lens=(40, 17, 64, 9, 33, 17),
                    budgets=(9, 4, 12, 6, 3, 7)):
    g = torch.Generator().manual_seed(3)
    reqs = [Request(uid=i, prompt=torch.randint(0, vocab, (n,), generator=g),
                    max_new_tokens=m) for i, (n, m) in
            enumerate(zip(lens, budgets))]
    reqs[2] = dataclasses.replace(reqs[2], temperature=0.8, seed=9)
    return reqs


def _outcome(results):
    return [(r.uid, r.tokens, r.status) for r in results]


# h2o-danube-1.8b's full width (32 / 8 heads of 80) at 2 layers, its
# window cut to 64 so that short prompts wrap the ring (C = 64 of
# max_seq_len 96)
RING_CFG = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=2,
                               sliding_window=64)


@pytest.mark.parametrize("which", ["reduced", "full_width_2_layers",
                                   "ring_full_width_2_layers"])
def test_continuous_graphs_match_eager_and_solo(cuda, which):
    """The continuous engine through its slot graphs against the same
    schedule run eagerly (``graphs`` off): the same tokens, statuses and
    stats; each request equals its run alone through an engine of the
    same batch size. Reduced: head_dim 16, so prefill takes flash's SIMT
    route; qwen2-1.5b's full width at 2 layers takes flash's wgmma
    route for every admission, and so does the ring of ``RING_CFG`` at
    hd 80 (a prompt of 80 past the ring, budgets across the wrap)."""
    lens = (40, 17, 64, 9, 33, 17)
    if which == "reduced":
        cfg, block = reduced_config("qwen2-1.5b",
                                    param_dtype="bfloat16"), 32
    elif which == "full_width_2_layers":
        cfg, block = dataclasses.replace(get_config("qwen2-1.5b"),
                                         num_layers=2), 128
    else:
        cfg, block, lens = RING_CFG, 128, (80, 17, 64, 9, 33, 17)
    model = LM(cfg, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), PruneConfig(scheme="tile_pattern", overrides={
            ".*": {"tile_block_p": block}})).pack()
    reqs = _mixed_requests(cfg.vocab_size, lens=lens)

    def engine(graphs):
        eng = ContinuousEngine(model, art, packed=True, batch_size=4,
                               max_seq_len=96, chunk_steps=4)
        eng.graphs = graphs
        return eng

    graph, eager = engine(True), engine(False)
    graph.generate(reqs)            # captures (each warm-up launches too)
    _zero_counts()
    got = graph.generate(reqs)
    torch.cuda.synchronize()
    admissions = len(reqs)
    route = "simt" if which == "reduced" else "wgmma"
    assert (fa.LAUNCHES, fa.ROUTE_LAUNCHES[route]) == (
        cfg.num_layers * admissions,) * 2
    assert attention.PREFILL_FALLBACKS == 0
    assert _outcome(got) == _outcome(eager.generate(reqs))
    assert graph.stats == eager.stats
    assert [len(r.tokens) for r in got] == [r.max_new_tokens for r in reqs]
    assert _outcome(got) == [_outcome(graph.generate([r]))[0] for r in reqs]
    assert sorted(graph.prefill_graphs) == sorted({len(r.prompt)
                                                   for r in reqs})


def test_continuous_slot_graph_launches_match_the_trace(lm_art):
    """Counted launches of a continuous run (every admission's slot
    prefill and every decode replay) equal the profiler trace's launches
    of the kernels' device functions."""
    from torch.profiler import ProfilerActivity, profile

    model, art = lm_art
    eng = ContinuousEngine(model, art, packed=True, batch_size=4,
                           max_seq_len=64, chunk_steps=4)
    reqs = _mixed_requests(GRAPH_CFG.vocab_size, lens=(16, 9, 16, 9, 16),
                           budgets=(6, 9, 4, 5, 8))
    eng.generate(reqs)                          # captures every graph
    torch.cuda.synchronize()
    _zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(reqs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = {n: sum(e.count for e in kernels if re.search(rx, e.key))
              for n, rx in TRACED.items()}
    steps = eng.stats["total_slot_steps"] // 4
    L = GRAPH_CFG.num_layers
    assert traced == {"pattern_gemm": pg.LAUNCHES,
                      "flash_attention": fa.LAUNCHES}
    assert fa.LAUNCHES == L * len(reqs)
    # each replay: 7 packed GEMMs a layer and the head; each admission
    # the same at M = S
    assert pg.LAUNCHES == (7 * L + 1) * (steps + len(reqs))


# ------------------------------------------------ speculative serving

from repro_torch.serve.speculative import SpeculativeEngine  # noqa: E402

SPEC_CFG = dataclasses.replace(GRAPH_CFG, param_dtype="float32")


def _spec_state(eng):
    out = []
    for cache in (eng.target.cache, eng.drafter.cache):
        out += [t.clone() for t in cache["k"] + cache["v"]]
        out += [cache["slot_pos"].clone(), cache["pos"].clone()]
    return out + [eng.bufs[k].clone() for k in ("token", "out", "keep",
                                                 "acc")]


def _spec_restore(eng, state):
    live = []
    for cache in (eng.target.cache, eng.drafter.cache):
        live += cache["k"] + cache["v"] + [cache["slot_pos"], cache["pos"]]
    live += [eng.bufs[k] for k in ("token", "out", "keep", "acc")]
    for t, saved in zip(live, state):
        t.copy_(saved)


def test_speculative_round_graph_matches_eager(lm_art):
    """Three round-graph replays from a prefilled chunk against the same
    rounds run eagerly from the same state: both caches, the pending
    tokens and the round blocks bit-identical; and a whole generate of
    the graph engine equals the eager engine's, tokens and stats."""
    model, art = lm_art
    kw = dict(batch_size=4, max_seq_len=64, draft_k=4, demote_below=0.0)
    eng = SpeculativeEngine(model, art, art, **kw)
    reqs = _requests(3, 16)
    eng.generate(reqs)                                # captures
    assert eng.round_graph is not None
    eng.prefill_chunk(reqs)
    start = _spec_state(eng)
    eng.greedy_rounds(3)
    graph = _spec_state(eng)
    _spec_restore(eng, start)
    eng.graphs = False
    eng.greedy_rounds(3)
    assert all(torch.equal(a, b) for a, b in zip(graph, _spec_state(eng)))
    eng.graphs = True
    eager = SpeculativeEngine(model, art, art, **kw)
    eager.graphs = False
    got = [r.tokens for r in eng.generate(reqs)]
    assert got == [r.tokens for r in eager.generate(reqs)]
    assert eng.stats == eager.stats


def test_speculative_ring_round_graph_matches_eager(cuda):
    """``RING_CFG`` (hd 80, ring of 64): the packed artifact drafts for
    its pruned weights bound dense, rounds crossing the wrap; round
    graph replays against eager rounds bit for bit (both caches, pending
    tokens, round blocks), a whole generate equal to the eager engine's
    (tokens and stats), every prefill on flash's wgmma route."""
    model = LM(RING_CFG, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), GRAPH_PCFG).pack()
    g = torch.Generator().manual_seed(4)
    reqs = [Request(uid=i, prompt=torch.randint(
        0, RING_CFG.vocab_size, (n,), generator=g), max_new_tokens=24)
        for i, n in enumerate((50, 70, 50, 60))]
    kw = dict(batch_size=4, max_seq_len=96, draft_k=4, demote_below=0.0)
    eng = SpeculativeEngine(model, art.params, art, **kw)
    eng.generate(reqs)                                # captures
    eng.prefill_chunk(reqs)
    start = _spec_state(eng)
    eng.greedy_rounds(6)
    graph = _spec_state(eng)
    _spec_restore(eng, start)
    eng.graphs = False
    eng.greedy_rounds(6)
    assert all(torch.equal(a, b) for a, b in zip(graph, _spec_state(eng)))
    eng.graphs = True
    eager = SpeculativeEngine(model, art.params, art, **kw)
    eager.graphs = False
    _zero_counts()
    got = [r.tokens for r in eng.generate(reqs)]
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES["wgmma"] == 2 * RING_CFG.num_layers
    assert attention.PREFILL_FALLBACKS == 0
    assert got == [r.tokens for r in eager.generate(reqs)]
    assert eng.stats == eager.stats
    assert [len(t) for t in got] == [24] * 4


def test_speculative_column_packed_drafter(cuda):
    """A column-packed drafter (``column_gemm`` on every drafter GEMM):
    fp32 tokens equal the plain engine's on the dense target, graph equal
    to eager, ``column_gemm`` launched."""
    model = LM(SPEC_CFG, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    col = greedy_prune(params, PruneConfig(scheme="column",
                                           alpha=0.5)).pack()
    reqs = _requests(4, 16)
    kw = dict(batch_size=4, max_seq_len=64, draft_k=3, demote_below=0.0)
    want = [r.tokens for r in ServeEngine(
        model, params, batch_size=4, max_seq_len=64).generate(reqs)]
    eng = SpeculativeEngine(model, params, col, **kw)
    eng.generate(reqs)                                # captures
    cg.LAUNCHES = 0
    got = [r.tokens for r in eng.generate(reqs)]
    torch.cuda.synchronize()
    assert got == want
    assert cg.LAUNCHES > 0 and eng.stats["rounds"] > 0
    eager = SpeculativeEngine(model, params, col, **kw)
    eager.graphs = False
    assert [r.tokens for r in eager.generate(reqs)] == got


def test_speculative_packed_target_verifies_on_pattern_gemm_m16(cuda):
    """A packed fp32 target: its verify chunk at batch 4 x draft_k 4 runs
    every GEMM through ``pattern_gemm``'s skinny route at M = 16, its
    logits within 1e-4 of four M = 4 decode steps (a kernel's K split
    follows M), and speculative tokens equal to plain packed decoding."""
    model = LM(SPEC_CFG, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), GRAPH_PCFG).pack()
    params = art.bind(model, packed=True)
    prompts = torch.stack([torch.arange(12, device=cuda) * (b + 1) % 1024
                           for b in range(4)])
    cache, _ = model.prefill(params, prompts, 64)
    toks = torch.randint(0, 1024, (4, 4), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    seq_cache = {k: ([t.clone() for t in v] if isinstance(v, list)
                     else v.clone()) for k, v in cache.items()}
    seq = torch.cat([model.decode_step(params, seq_cache, toks[:, i:i + 1])[1]
                     for i in range(4)], dim=1)
    _zero_counts()
    pg.ROUTE_LAUNCHES.update(dict.fromkeys(pg.ROUTE_LAUNCHES, 0))
    _, chunk = model.verify_chunk(params, cache, toks)
    torch.cuda.synchronize()
    n_packed = 7 * SPEC_CFG.num_layers + 1
    assert pg.ROUTE_LAUNCHES["skinny"] == pg.LAUNCHES == n_packed
    torch.testing.assert_close(chunk, seq, rtol=1e-4, atol=1e-4)
    assert torch.equal(cache["pos"], seq_cache["pos"])
    assert torch.equal(cache["slot_pos"], seq_cache["slot_pos"])
    reqs = _requests(4, 16)
    want = [r.tokens for r in ServeEngine(
        model, art, packed=True, batch_size=4, max_seq_len=64).generate(reqs)]
    eng = SpeculativeEngine(model, art, art, packed=True, batch_size=4,
                            max_seq_len=64, draft_k=4)
    assert [r.tokens for r in eng.generate(reqs)] == want
    assert eng.stats["demoted"] is False


def test_speculative_sampled_rows_on_the_card(lm_art):
    """Sampled rounds run eagerly on the card: a seeded request gets the
    same tokens on engines of other seeds and with other batch-mates, and
    a greedy row beside a sampled one the tokens it gets through the
    round graph with no sampled mate."""
    model, art = lm_art
    seeded = _requests(1, 16, temperature=0.8, seed=21)[0]
    mates = _requests(2, 16, temperature=1.1, first=30)
    greedy = _requests(1, 16, first=40)[0]

    def run(seed, reqs):
        eng = SpeculativeEngine(model, art, art, batch_size=4,
                                max_seq_len=64, draft_k=4, seed=seed)
        return [r.tokens for r in eng.generate(reqs)]

    alone = run(0, [seeded])[0]
    assert alone == run(1, [seeded] + mates)[0]
    assert len(alone) == seeded.max_new_tokens
    assert run(2, [seeded, greedy])[1] == run(3, [greedy])[0]


def test_speculative_serve_launcher_on_the_card(cuda, tmp_path):
    """``launch.serve --speculative DIR --draft-k 2`` at ``--reduced``,
    on the card by default: the saved artifact drafts packed, the same
    artifact's dense weights verify; it prints the acceptance numbers."""
    cfg = reduced_config("qwen2-1.5b")
    model = LM(cfg, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), PruneConfig(scheme="tile_pattern",
                         overrides={".*": {"tile_block_p": 32}})).pack()
    path = str(tmp_path / "artifact")
    art.save(path)
    out = _launcher("repro_torch.launch.serve", "--arch", "qwen2-1.5b",
                    "--reduced", "--artifact", path, "--speculative", path,
                    "--draft-k", "2", "--requests", "2", "--max-new", "6")
    assert "dense+speculative(k=2), cuda" in out
    assert "speculative:" in out and "acceptance" in out


# --------------------------------------- the embedding-input families (card)

# (B, S, H, KV, hd, causal): pixtral-12b's prefill (32 / 8 of 128, causal)
# and hubert-xlarge's encoder (16 / 16 of 80, bidirectional, S 1 500 no
# multiple of any tile: the kernel masks the keys past S)
FAMILY_FLASH_CASES = ((2, 1024, 32, 8, 128, True),
                      (2, 1500, 16, 16, 80, False),
                      (1, 75, 16, 16, 80, False))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,KV,hd,causal", FAMILY_FLASH_CASES)
def test_flash_at_the_families_shapes_matches_plain(cuda, B, S, H, KV, hd,
                                                    causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q, k, v = _qkv(g, B, S, H, KV, hd, cuda, dtype)
    want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert fa.flash_variant(S, hd, dtype, None, causal) == want_route
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_ref(q, k, v, causal=causal)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [4, 1500])
def test_pattern_gemm_gelu_at_hubert_w_up(cuda, dtype, M):
    """hubert-xlarge's ``w_up`` (1 280 -> 5 120) with the fused GELU."""
    g = torch.Generator(device=cuda).manual_seed(M)
    w = (torch.randn(1280, 5120, generator=g, device=cuda) / 1280 ** 0.5)
    w = project_tile_pattern(w.to(dtype).T, block_p=128).T.contiguous()
    wpb, li = pg.pack_tile_pattern_blocked(w, block_p=128)
    x = torch.randn(M, 1280, generator=g, device=cuda).to(dtype)
    got = pg.pattern_gemm(x, wpb, li, activation="gelu")
    want = pg.pattern_gemm_ref(x, wpb, li, activation="gelu")
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_pixtral_two_layers_decode_packed_against_dense_pruned(cuda):
    """pixtral-12b at full width, 2 layers, fp32: a prefill of 2 x 64
    patch embeddings, then one decode step on embeddings, packed against
    dense-pruned (argmax identical, logits within 2e-5), every GEMM
    through ``pattern_gemm``."""
    cfg = dataclasses.replace(get_config("pixtral-12b"), num_layers=2,
                              param_dtype="float32")
    model = LM(cfg, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), PruneConfig(scheme="tile_pattern")).pack()
    packed = art.bind(model, packed=True)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 64, cfg.d_model, generator=g, device=cuda)
    e = torch.randn(2, 1, cfg.d_model, generator=g, device=cuda)
    cd, _ = model.prefill(art.params, x, 80)
    cp, _ = model.prefill(packed, x, 80)
    want = model.decode_step(art.params, cd, e)[1]
    _zero_counts()
    got = model.decode_step(packed, cp, e)[1]
    torch.cuda.synchronize()
    assert pg.LAUNCHES == 7 * cfg.num_layers + 1
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the MoE family

from repro_torch.core import DEFAULT_EXCLUDE  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

MOE_EXPERTS = (r".*experts.*",)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S", [(4, 1), (2, 64)])
def test_moe_apply_graph_matches_eager(cuda, dtype, B, S):
    """``moe_apply`` (router, stable sort, one-hot slot positions, the
    dispatch / expert / combine einsums, the shared SwiGLU) captured in a
    CUDA graph: a capture fails on any host sync, and the replay is
    bit-identical to the eager call, aux included."""
    g = torch.Generator(device=cuda).manual_seed(0)
    params = moe_mod.moe_init(g, 256, 8, 2, 128, dtype, cuda)
    x = torch.randn(B, S, 256, generator=g, device=cuda).to(dtype)
    want, want_aux = moe_mod.moe_apply(params, x, top_k=2)
    static = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe_mod.moe_apply(params, static, top_k=2)          # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, got_aux = moe_mod.moe_apply(params, static, top_k=2)
    static.copy_(torch.randn_like(x))
    graph.replay()
    static.copy_(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_aux, want_aux)


@pytest.mark.parametrize("which", ["reduced", "full_width_2_layers"])
def test_moe_lm_served_through_graphs_matches_eager(cuda, which):
    """qwen2-moe-a2.7b reduced (head_dim 16: flash's SIMT route) and at
    full width with 2 layers (flash on wgmma), tile packed with the
    experts left dense: the chunked engine's prefill logits and decode
    tokens through its graphs bit-identical to eager ``LM.prefill`` /
    ``decode_many`` on a left-padded chunk; the continuous engine's
    graphs against its eager run and each request's solo run."""
    if which == "reduced":
        cfg, block = reduced_config("qwen2-moe-a2.7b",
                                    param_dtype="bfloat16"), 32
    else:
        cfg, block = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                                         num_layers=2), 128
    model = LM(cfg, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), PruneConfig(scheme="tile_pattern",
                         exclude=DEFAULT_EXCLUDE + MOE_EXPERTS,
                         overrides={".*": {"tile_block_p": block}})).pack()
    reqs = _mixed_requests(cfg.vocab_size)
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=96)
    chunk = reqs[:4]                      # prompts 40, 17, 64, 9: S = 64
    prompts, mask = eng.pad_prompts(chunk)
    eng.set_rows(chunk, mask)
    logits = eng.prefill(prompts)[1].clone()
    cache, want = model.prefill(eng.params, prompts, 96)
    assert torch.equal(logits, want)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), 12)
    tok0 = eng.sample(logits, keys[0])
    got = eng.decode(tok0, 11).clone()
    _, rest = model.decode_many(eng.params, cache, tok0, 11,
                                sampler=eng.sample, keys=keys[1:])
    assert torch.equal(got, torch.cat([tok0, rest], dim=1))

    def engine(graphs):
        e = ContinuousEngine(model, art, packed=True, batch_size=4,
                             max_seq_len=96, chunk_steps=4)
        e.graphs = graphs
        return e

    graph, eager = engine(True), engine(False)
    graph.generate(reqs)                                   # captures
    out = graph.generate(reqs)
    assert _outcome(out) == _outcome(eager.generate(reqs))
    assert _outcome(out) == [_outcome(graph.generate([r]))[0] for r in reqs]
    assert [len(r.tokens) for r in out] == [r.max_new_tokens for r in reqs]


# --------------------------------------------- the plan tuner on the card

from repro_torch.core import LayerSpec  # noqa: E402
from repro_torch.runtime import profiler_scope  # noqa: E402
from repro_torch.serve.graphs import CountedGraph, GraphPool  # noqa: E402
from repro_torch.sparse import is_packed, tune  # noqa: E402
from repro_torch.sparse.packed import PackedTensor  # noqa: E402
from repro_torch.sparse.registry import (  # noqa: E402
    SCHEMES,
    conv_gemm_runner,
    dispatch_matmul,
    dispatch_stats,
    dispatch_stats_scope,
)

EDGE_MS = (4, 16, 17, 24, 32, 33, 512, 2048)


def _tuned_leaves(cuda):
    """bf16 tile and column leaves at qwen2-1.5b's shapes (wq, wk/wv,
    w_down)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    out = []
    for Q, P in ((1536, 1536), (1536, 256), (8960, 1536)):
        w = (torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5)
        spec = LayerSpec(scheme="tile_pattern", tile_block_p=128,
                         tile_group_q=8, tile_keep=4)
        out.append(SCHEMES["tile_pattern"].pack(
            spec.project(w).bfloat16(), spec))
        wc = project_column(w.T, alpha=0.5).T.contiguous().bfloat16()
        out.append(SCHEMES["column"].pack(wc, LayerSpec(scheme="column",
                                                        alpha=0.5)))
    return out


def test_every_gemm_candidate_is_bit_equal_to_the_untuned_call(cuda):
    """Each candidate plan at the bucket-edge Ms (both routes of bucket
    m32, the prefill chunks) gives the untuned call's bits, with the
    epilogue too."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for pt in _tuned_leaves(cuda):
        handler = SCHEMES[pt.scheme]
        bias = torch.randn(pt.shape[1], generator=g, device=cuda).bfloat16()
        for M in EDGE_MS:
            x = torch.randn(M, pt.shape[0], generator=g,
                            device=cuda).bfloat16()
            for act in (None, "silu"):
                want = handler.plan(pt, M, act, None)(x, pt, bias)
                cands = tune.candidate_plans(pt, "matmul", M, cuda=True)
                assert len(cands) == (1 if M <= 16 else 4)
                for c in cands:
                    got = handler.plan(pt, M, act, c)(x, pt, bias)
                    assert torch.equal(got, want), (pt.scheme, M, c)


def test_grid_order_leaves_every_wgmma_kernel_unchanged(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    for pt in _tuned_leaves(cuda)[:2]:
        x = torch.randn(300, pt.shape[0], generator=g, device=cuda).bfloat16()
        fn = pg.pattern_gemm if pt.scheme == "tile_pattern" else cg.column_gemm
        want = fn(x, *pt.buffers)
        for go in ("mp", "pm"):
            for bm in (0, 64, 128):
                assert torch.equal(fn(x, *pt.buffers, block_m=bm,
                                      grid_order=go), want)
    for B, H, C, A in ((2, 56, 64, 128), (4, 28, 256, 512), (3, 14, 128, 40)):
        x, wp, taps = _conv_operands(g, B, H, C, A, cuda)
        want = pc.pattern_conv(x, wp, taps)
        for bn in pc.channel_tiles(A):
            for go in ("mp", "pm"):
                got = pc.pattern_conv(x, wp, taps, block_n=bn, grid_order=go)
                assert torch.equal(got, want), (B, H, C, A, bn, go)


def _conv_operands(g, B, H, C, A, cuda):
    w4 = torch.randn(A, C, 3, 3, generator=g, device=cuda) / (9 * C) ** 0.5
    pats = pc.assign_channel_patterns(w4)
    wp, taps = pc.pack_pattern_conv(w4.bfloat16(), pats)
    x = torch.randn(B, H, H, C, generator=g, device=cuda).bfloat16()
    return x, wp, taps


def test_every_conv_candidate_is_bit_equal_to_the_untuned_call(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    for B, H, C, A in ((2, 56, 64, 64), (2, 28, 128, 256), (4, 14, 512, 512),
                       (2, 32, 3, 64)):
        x, wp, taps = _conv_operands(g, B, H, C, A, cuda)
        leaf = PackedTensor("pattern", (A, C, 3, 3), ("w_packed", "taps"),
                            (wp, taps), (("keep", 4),))
        want = pc.pattern_conv(x, wp, taps, activation="relu")
        for c in tune.candidate_plans(leaf, "conv", B * H * H, cuda=True):
            got = conv_gemm_runner(leaf, c, activation="relu")(x, wp, taps)
            assert torch.equal(got, want), (B, H, C, A, c)


def test_tuned_artifact_serves_identical_tokens_through_the_graphs(lm_art):
    model, art = lm_art
    tuned = art.tune((4, 4 * 24), iters=1)
    plans = tune.describe_plans(tuned.packed)
    assert plans and all(v["plan_torch:matmul:m32"] == "skinny"
                         and v["plan_torch:matmul:m128"].startswith("wgmma")
                         for v in plans.values())
    assert all(pt.meta_dict[tune.MODE_KEY].startswith("cuda:sm_")
               for _, pt in tree_items(tuned.packed) if is_packed(pt))
    reqs = _requests(4, 24)
    want = [r.tokens for r in ServeEngine(
        model, art, packed=True, batch_size=4, max_seq_len=64).generate(reqs)]
    eng = ServeEngine(model, tuned, packed=True, batch_size=4, max_seq_len=64)
    assert eng.graphs
    assert [r.tokens for r in eng.generate(reqs)] == want
    assert [r.tokens for r in eng.generate(reqs)] == want      # replays


def test_hooks_never_wall_or_count_inside_a_capture(lm_art):
    model, art = lm_art
    pt = art.packed["blocks"][0]["attn"]["wq"]
    x = torch.randn(8, pt.shape[0], device="cuda").bfloat16()
    out = torch.empty((8, pt.shape[1]), device="cuda", dtype=torch.bfloat16)
    with dispatch_stats_scope():
        with profiler_scope(sample_rate=1.0, warmup=0) as prof:
            graph = CountedGraph(lambda: out.copy_(dispatch_matmul(x, pt)),
                                 GraphPool(torch.device("cuda")))
            warm = dict(dispatch_stats())
            rows = prof.report()
            graph.replay()
            graph.replay()
            torch.cuda.synchronize()
            assert prof.report() == rows           # replays wall nothing
        assert dict(dispatch_stats()) == warm      # nor count
    # the warm-up ran eagerly: one dispatch, walled; the capture: none
    assert warm["matmul:tile_pattern:m32"] == 1
    assert [(r["kind"], r["events"]) for r in rows] == [("matmul", 1)]
    assert torch.equal(out, dispatch_matmul(x, pt))


# ------------------------------------- the recurrent families on the card

HYMBA_GEMMS = ((1600, 1600), (1600, 320), (1600, 5504), (5504, 1600))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [4, 512, 2048])
@pytest.mark.parametrize("Q,P", HYMBA_GEMMS)
def test_pattern_gemm_at_hymba_block_p_64(cuda, Q, P, M, dtype):
    """hymba-1.5b's packed GEMMs at block_p 64: Kp = Q / 2 (800 for
    d_model 1 600) is no multiple of the 64-wide K tile."""
    g = torch.Generator(device=cuda).manual_seed(Q + P + M)
    w = torch.randn(Q, P, generator=g, device=cuda) / Q ** 0.5
    w = project_tile_pattern(w.to(dtype).T, block_p=64).T.contiguous()
    wpb, li = pg.pack_tile_pattern_blocked(w, block_p=64)
    x = torch.randn(M, Q, generator=g, device=cuda).to(dtype)
    got = pg.pattern_gemm(x, wpb, li, activation="silu")
    want = pg.pattern_gemm_ref(x, wpb, li, activation="silu")
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [4, 512, 2048])
def test_pattern_gemm_at_the_xlstm_head(cuda, M, dtype):
    """xlstm-1.3b's head, 2 048 -> 50 304, at block_p 128."""
    g = torch.Generator(device=cuda).manual_seed(M)
    w = torch.randn(2048, 50304, generator=g, device=cuda) / 2048 ** 0.5
    w = project_tile_pattern(w.to(dtype).T, block_p=128).T.contiguous()
    wpb, li = pg.pack_tile_pattern_blocked(w, block_p=128)
    x = torch.randn(M, 2048, generator=g, device=cuda).to(dtype)
    tol = TOL[dtype]
    torch.testing.assert_close(pg.pattern_gemm(x, wpb, li).float(),
                               pg.pattern_gemm_ref(x, wpb, li).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S", [(4, 512), (4, 128), (1, 2048), (1, 200)])
def test_flash_at_hymba_heads(cuda, B, S, dtype):
    """25 / 5 heads of 64 (a GQA group of 5), window 2 048: bf16 on the
    wgmma route, fp32 on simt."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = _qkv(g, B, S, 25, 5, 64, cuda, dtype)
    want_route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert fa.flash_variant(S, 64, dtype, 2048, True) == want_route
    got = fa.flash_attention(q, k, v, causal=True, window=2048)
    want = fa.flash_attention_ref(q, k, v, causal=True, window=2048)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


RECURRENT = {"hymba-1.5b": ((r".*mamba.*", r"lm_head"), 64),
             "xlstm-1.3b": ((r".*mlstm.*", r".*slstm.*"), 128)}


@pytest.mark.parametrize("name", sorted(RECURRENT))
@pytest.mark.parametrize("which", ["reduced", "full_width"])
def test_recurrent_lm_served_through_graphs_matches_eager(cuda, name,
                                                          which):
    """hymba-1.5b (2 layers) and xlstm-1.3b (one group of 8 blocks),
    reduced (bf16) and at full width, tile packed with the cells left
    dense: the chunked engine's prefill logits and decode tokens through
    its graphs bit-identical to eager ``LM.prefill`` / ``decode_many`` on
    a left-padded chunk, the recurrent state static buffers written in
    place; hymba's continuous engine through its graphs against its eager
    run and each request's solo run."""
    excl, block = RECURRENT[name]
    if which == "reduced":
        cfg, block = reduced_config(name, param_dtype="bfloat16"), 32
    else:
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=full.slstm_every or 2)
    model = LM(cfg, device=cuda)
    art = greedy_prune(model.init(torch.Generator(device=cuda).manual_seed(
        0)), PruneConfig(scheme="tile_pattern", exclude=DEFAULT_EXCLUDE + excl,
                         overrides={".*": {"tile_block_p": block}})).pack()
    reqs = _mixed_requests(cfg.vocab_size)
    eng = ServeEngine(model, art, packed=True, batch_size=4, max_seq_len=96)
    ptrs = {p: t.data_ptr() for p, t in tree_items(eng.cache)}
    chunk = reqs[:4]                      # prompts 40, 17, 64, 9: S = 64
    prompts, mask = eng.pad_prompts(chunk)
    eng.set_rows(chunk, mask)
    logits = eng.prefill(prompts)[1].clone()
    cache, want = model.prefill(eng.params, prompts, 96)
    assert torch.equal(logits, want)
    keys = fold_key_grid(eng.rows["keys"], torch.zeros_like(
        eng.rows["keys"]), 12)
    tok0 = eng.sample(logits, keys[0])
    got = eng.decode(tok0, 11).clone()
    _, rest = model.decode_many(eng.params, cache, tok0, 11,
                                sampler=eng.sample, keys=keys[1:])
    assert torch.equal(got, torch.cat([tok0, rest], dim=1))
    for p, t in tree_items(cache):
        assert torch.equal(dict(tree_items(eng.cache))[p], t), p
    assert {p: t.data_ptr() for p, t in tree_items(eng.cache)} == ptrs
    if cfg.family == "ssm":
        with pytest.raises(NotImplementedError, match="xLSTM"):
            ContinuousEngine(model, art, packed=True, batch_size=4,
                             max_seq_len=96)
        return

    def engine(graphs):
        e = ContinuousEngine(model, art, packed=True, batch_size=4,
                             max_seq_len=96, chunk_steps=4)
        e.graphs = graphs
        return e

    graph, eager = engine(True), engine(False)
    graph.generate(reqs)                                   # captures
    out = graph.generate(reqs)
    assert _outcome(out) == _outcome(eager.generate(reqs))
    assert _outcome(out) == [_outcome(graph.generate([r]))[0] for r in reqs]


def test_run_training_on_a_one_card_mesh_is_bit_equal(cuda, tmp_path):
    """``run_training(mesh=...)`` on a 1 × 1 ("data", "model") mesh of an
    NCCL group of one rank (a ``FileStore``, no port): losses, grad norms
    and final params bit-equal to the unsharded run's over 3 masked,
    int8-compressed steps (a checkpoint saved on the mesh at step 2)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import run_training
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_items, unflatten

    cfg = reduced_config("qwen2-1.5b")
    g = torch.Generator().manual_seed(11)
    masks = unflatten({
        p: ((torch.rand(s, generator=g) < 0.5).to(torch.bfloat16).to(cuda)
            if p.startswith("blocks/") and len(s) == 2 else None)
        for p, s in build_model(cfg, device=cuda).param_shapes().items()})

    def run(name, mesh=None):
        tcfg = TrainConfig(steps=3, learning_rate=1e-3, warmup_steps=1,
                           grad_compression=True, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / name), seed=3)
        return run_training(cfg, tcfg, seq_len=32, global_batch=4,
                            masks=masks, mesh=mesh, device=cuda)

    plain = run("plain")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        sharded = run("mesh", mesh)
        params = {p: x.full_tensor() for p, x in
                  tree_items(sharded["state"]["params"])}
    finally:
        dist.destroy_process_group()
    assert [r.metrics for r in sharded["metrics"]] == [
        r.metrics for r in plain["metrics"]]
    want = dict(tree_items(plain["state"]["params"]))
    assert set(params) == set(want)
    for path, w in want.items():
        assert torch.equal(params[path], w), path


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b",
                                  "xlstm-1.3b"])
def test_families_on_a_one_card_mesh_are_bit_equal(cuda, tmp_path, arch):
    """A reduced MoE, hybrid and xLSTM config (``FAMILIES`` of
    ``tests/torch_scaleout_worker.py``) on a 1 × 1 mesh of an NCCL group
    of one rank: ``run_training``'s metrics and final params over 2
    masked, int8-compressed steps, and a prefill with greedy decode
    steps (logits and tokens), bit-equal to the unsharded runs'."""
    import importlib.util
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.train import run_training
    from repro_torch.parallel.sharding import gather_full
    from repro_torch.utils.tree import tree_items

    spec = importlib.util.spec_from_file_location(
        "torch_scaleout_worker", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "torch_scaleout_worker.py"))
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)
    cfg = W.config(arch)
    masks = W.masks_for(cfg, device=cuda)

    def run(name, mesh=None):
        res = run_training(cfg, W.train_config(str(tmp_path / name)),
                           seq_len=W.SEQ, global_batch=W.BATCH, masks=masks,
                           mesh=mesh, device=cuda)
        return ([r.metrics for r in res["metrics"]],
                {p: gather_full(x) for p, x in
                 tree_items(res["state"]["params"])},
                W.serve(cfg, mesh, device=cuda))

    plain = run("plain")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        sharded = run("mesh", init_device_mesh(
            "cuda", (1, 1), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()
    assert sharded[0] == plain[0]
    assert set(sharded[1]) == set(plain[1])
    for path, w in plain[1].items():
        assert torch.equal(sharded[1][path], w), path
    for got, want in zip(sharded[2], plain[2]):
        assert torch.equal(got, want)
