"""The kernel build and the tiled GEMMs' routing, on the CPU (no nvcc and
no card needed): the library hash covers the shared headers, and each
wrapper's ``tiled_variant`` and ``wgmma_plan`` pick the kernel and grid the
C entry points are handed."""

import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import column_gemm as cg
from repro_torch.kernels import pattern_gemm as pg
from repro_torch.kernels.sm90 import (BLOCK_K, BLOCKS_PER_SM, SKINNY_M,
                                      VARIANTS, wgmma_plan)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "core.cuh"\n')
    (src / "core.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_target_changes_with_a_header(csrc):
    before = _build._target("k")
    (csrc / "core.cuh").write_text("// v1\n")        # same bytes
    assert _build._target("k") == before
    (csrc / "core.cuh").write_text("// v2\n")
    assert _build._target("k") != before
    assert _build._target("k").parent == _build.BUILD_DIR


def test_target_changes_with_a_new_header_or_the_source(csrc):
    before = _build._target("k")
    (csrc / "extra.cuh").write_text("// more\n")
    with_header = _build._target("k")
    assert with_header != before
    (csrc / "k.cu").write_text('#include "core.cuh"\n// edited\n')
    assert _build._target("k") != with_header


def test_signatures_match_the_wrappers_arguments():
    assert len(_build.SIGNATURES["pattern_gemm"][1]) == 17
    assert len(_build.SIGNATURES["column_gemm"][1]) == 17
    assert sorted(VARIANTS.values()) == [0, 1, 2, 3]


def test_routing_constants_match_the_shared_header():
    """The codes, the decode bound and the stage depth that the wrappers
    hand the C entry points are the ones the shared header defines."""
    header = (_build.CSRC / "sm90_gemm.cuh").read_text()
    enum = re.search(r"enum \{ (V_SKINNY[^}]*) \};", header).group(1)
    codes = {k.strip()[2:].lower(): int(v) for k, v in
             (item.split("=") for item in enum.split(","))}
    assert codes == VARIANTS
    assert int(re.search(r"constexpr int SK_MMAX = (\d+);",
                         header).group(1)) == SKINNY_M
    assert int(re.search(r"constexpr int BK = (\d+);",
                         header).group(1)) == BLOCK_K
    for name in ("pattern_gemm", "column_gemm"):       # one definition each
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90_gemm.cuh"' in src
        assert not re.search(r"enum \{ V_|int (SK_MMAX|BK) =", src)


@pytest.mark.parametrize("mod", [pg, cg])
def test_an_unknown_variant_raises_before_any_launch(mod):
    x = torch.zeros((32, 16))
    with pytest.raises(ValueError, match="'bogus'"):
        mod._launch(x, None, None, None, None, "bogus")


@pytest.mark.parametrize("M,Q,Kp,dtype,aligned,want", [
    (4, 1536, 768, torch.bfloat16, True, "skinny"),
    (16, 1536, 768, torch.float32, True, "skinny"),
    (17, 1536, 768, torch.float32, True, "simt"),
    (2048, 1536, 768, torch.bfloat16, True, "wgmma"),
    (2048, 100, 52, torch.bfloat16, True, "wmma"),       # Q % 8 != 0
    (2048, 1536, 766, torch.bfloat16, True, "wmma"),     # Kp % 4 != 0
    (2048, 1536, 768, torch.bfloat16, False, "wmma"),    # unaligned x
])
def test_pattern_tiled_variant_routes(M, Q, Kp, dtype, aligned, want):
    assert pg.tiled_variant(M, Q, Kp, dtype, aligned) == want


@pytest.mark.parametrize("M,K,P,dtype,want", [
    (4, 768, 151936, torch.bfloat16, "skinny"),
    (16, 768, 1002, torch.float32, "skinny"),
    (2048, 768, 1536, torch.float32, "simt"),
    (17, 111, 520, torch.bfloat16, "wgmma"),             # ragged K is fine
    (2048, 768, 1002, torch.bfloat16, "wmma"),           # P % 8 != 0
    (2048, 0, 1536, torch.bfloat16, "wmma"),             # nothing kept
])
def test_column_tiled_variant_routes(M, K, P, dtype, want):
    assert cg.tiled_variant(M, K, P, dtype) == want


@pytest.mark.parametrize("M,n_tiles,k_steps,want", [
    (2048, 12, 12, (128, 1)),      # wq/wo: 192 blocks of 128 rows
    (2048, 70, 12, (128, 1)),      # w_gate/w_up
    (2048, 1187, 12, (128, 1)),    # lm_head
    (2048, 2, 12, (64, 4)),        # wk/wv: 64 blocks, K split in four
    (512, 12, 12, (64, 2)),        # S = 128 chunk: 96 blocks, split in two
    (17, 2, 6, (64, 3)),           # few blocks, short K
    (100, 1, 1, (64, 1)),          # one K step: no split
    (2048, 1, 12, (64, 6)),        # 32 blocks: 6 splits of 2
])
def test_wgmma_plan(M, n_tiles, k_steps, want):
    block_m, ksplit = wgmma_plan(M, n_tiles, k_steps, 132)
    assert (block_m, ksplit) == want
    assert block_m in (64, 128)
    blocks = -(-M // block_m) * n_tiles
    assert ksplit == 1 or 2 * blocks <= BLOCKS_PER_SM * 132
    assert ksplit == 1 or -(-k_steps // ksplit) >= 2       # two steps each
    assert -(-k_steps // ksplit) * (ksplit - 1) < k_steps   # no empty split


def test_wgmma_plan_prefers_128_rows_once_the_grid_fills_the_card():
    assert wgmma_plan(2048, 12, 12, 132)[0] == 128       # 192 blocks
    assert wgmma_plan(1024, 12, 12, 132)[0] == 64        # 96 blocks
