"""The kernel build and every kernel's routing, on the CPU (no nvcc and
no card needed): the library hash covers the shared headers, the ctypes
signatures match the C entry points, and each wrapper's route function
(``tiled_variant``, ``flash_variant``, ``conv_variant``) and grid plan
(``wgmma_plan``, ``flash_plan``, ``conv_plan``) pick the kernel and grid
the C entry points are handed."""

import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import column_gemm as cg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import pattern_conv as pc
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
    assert len(_build.SIGNATURES["pattern_gemm"][1]) == 18
    assert len(_build.SIGNATURES["column_gemm"][1]) == 18
    assert len(_build.SIGNATURES["flash_attention"][1]) == 16
    assert len(_build.SIGNATURES["pattern_conv"][1]) == 19
    assert sorted(VARIANTS.values()) == [0, 1, 2, 3]


_CTYPES = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    """Each ctypes signature is its source's extern "C" entry point,
    parameter by parameter (every pointer and the stream a c_void_p)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    symbol, argtypes = _build.SIGNATURES[name]
    params = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                       src).group(1)
    want = []
    for p in params.split(","):
        ctype = p.split()[:-1]
        ctype = "void*" if "void*" in "".join(ctype) else ctype[-1]
        want.append(_CTYPES[ctype])
    assert [t.__name__ for t in argtypes] == want


def test_routing_constants_match_the_shared_header():
    """The codes, the decode bound and the stage depth that the wrappers
    hand the C entry points are the ones the shared headers define: the
    route codes once in ``sm90.cuh``, which every source includes, the
    GEMM core's constants once in ``sm90_gemm.cuh``."""
    shared = (_build.CSRC / "sm90.cuh").read_text()
    enum = re.search(r"enum \{ (V_SKINNY[^}]*) \};", shared).group(1)
    codes = {k.strip()[2:].lower(): int(v) for k, v in
             (item.split("=") for item in enum.split(","))}
    assert codes == VARIANTS
    header = (_build.CSRC / "sm90_gemm.cuh").read_text()
    assert '#include "sm90.cuh"' in header
    assert int(re.search(r"constexpr int SK_MMAX = (\d+);",
                         header).group(1)) == SKINNY_M
    assert int(re.search(r"constexpr int BK = (\d+);",
                         header).group(1)) == BLOCK_K
    assert not re.search(r"enum \{ V_", header)
    for name in ("pattern_gemm", "column_gemm"):       # one definition each
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90_gemm.cuh"' in src
        assert not re.search(r"enum \{ V_|int (SK_MMAX|BK) =", src)
    for name in ("flash_attention", "pattern_conv"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90.cuh"' in src
        assert not re.search(r"enum \{ V_", src)
    assert set(fa.FLASH_ROUTES) | set(pc.CONV_ROUTES) <= set(VARIANTS)


def test_flash_and_conv_constants_match_their_sources():
    """The wrappers' tile constants are the ones the kernels were built
    with: flash's 64-row warpgroups (block_q 64 or 128) and 64-key tiles;
    conv's 16-channel stages, 128-pixel blocks, halo cap and channel
    tiles."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int BKV = (\d+);", src).group(1)) == 64
    assert "block_q != 64 && block_q != 128" in src
    assert "hd != 64 && hd != 80 && hd != 128" in src
    assert fa.WGMMA_HEAD_DIMS == (64, 80, 128)
    simt = re.findall(r"case (\d+): return launch_simt<T, (\d+)>", src)
    assert [(int(a), int(b)) for a, b in simt] == [
        (n, n) for n in fa.HEAD_DIMS]
    src = (_build.CSRC / "pattern_conv.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (CK|BM|MAX_SLOTS) = (\d+);", src)}
    assert consts == {"CK": pc.STAGE_CHANNELS, "BM": pc.BLOCK_PIXELS,
                      "MAX_SLOTS": pc.HALO_PIXELS}
    cases = re.findall(r"case (\d+): return pc90::launch<(\d+)>", src)
    assert [(int(a), int(b)) for a, b in cases] == [
        (n, n) for n in pc.CHANNEL_TILES]


@pytest.mark.parametrize("mod", [pg, cg, pc])
def test_an_unknown_variant_raises_before_any_launch(mod):
    x = torch.zeros((32, 16))
    with pytest.raises(ValueError, match="'bogus'"):
        mod._launch(x, None, None, None, None, "bogus")


def test_an_unknown_flash_variant_raises_before_any_launch():
    q = torch.zeros((1, 8, 2, 64))
    for bad in ("bogus", "wmma", "skinny"):        # no such flash kernel
        with pytest.raises(ValueError, match=repr(bad)):
            fa._launch(q, q, q, True, None, None, bad)


@pytest.mark.parametrize("S,hd,dtype,window,causal,aligned,want", [
    (512, 128, torch.bfloat16, None, True, True, "wgmma"),   # served path
    (128, 128, torch.bfloat16, None, True, True, "wgmma"),
    (200, 64, torch.bfloat16, None, True, True, "wgmma"),    # ragged S
    (130, 128, torch.bfloat16, 50, False, True, "wgmma"),    # window
    (70, 64, torch.bfloat16, None, False, True, "wgmma"),    # not causal
    (1, 64, torch.bfloat16, 16, True, True, "wgmma"),
    (512, 32, torch.bfloat16, None, True, True, "simt"),     # head dim
    (512, 128, torch.float32, None, True, True, "simt"),     # fp32
    (512, 64, torch.float32, 50, False, True, "simt"),
    (512, 128, torch.bfloat16, None, True, False, "simt"),   # unaligned
    (4160, 80, torch.bfloat16, 4096, True, True, "wgmma"),   # hd 80
    (200, 80, torch.bfloat16, None, True, True, "wgmma"),
    (4160, 80, torch.float32, 4096, True, True, "simt"),
    (200, 80, torch.bfloat16, 4096, True, False, "simt"),
])
def test_flash_variant_routes(S, hd, dtype, window, causal, aligned, want):
    assert fa.flash_variant(S, hd, dtype, window, causal,
                            aligned=aligned) == want


@pytest.mark.parametrize("B,S,H,want", [
    (4, 512, 12, 128),     # 192 blocks of 128 rows
    (4, 128, 12, 64),      # 48 blocks of 128 rows: 96 of 64
    (4, 200, 12, 64),      # 96 of 128
    (2, 70, 4, 64),
    (11, 128, 12, 128),    # 132 blocks: one per SM
])
def test_flash_plan(B, S, H, want):
    assert fa.flash_plan(B, S, H, 132) == want


@pytest.mark.parametrize("C,A,dtype,want", [
    (64, 64, torch.bfloat16, "wgmma"),
    (512, 512, torch.bfloat16, "wgmma"),
    (16, 40, torch.bfloat16, "wgmma"),        # A below the tile width
    (3, 64, torch.bfloat16, "wmma"),          # VGG-16 conv1_1, ResNet stem
    (12, 136, torch.bfloat16, "wmma"),        # C % 16 != 0
    (64, 36, torch.bfloat16, "wmma"),         # A % 8 != 0
    (64, 64, torch.float32, "simt"),
    (3, 64, torch.float32, "simt"),
])
def test_conv_variant_routes(C, A, dtype, want):
    assert pc.conv_variant(C, A, dtype) == want


# every stride-1 3x3 conv of the CNN path: VGG-16 at batch 32 and 224 x 224,
# ResNet-18 at batch 256 and 32 x 32, and test shapes
@pytest.mark.parametrize("B,H,W,A,want", [
    (32, 224, 224, 64, (16, 8, 1, 64)),
    (32, 112, 112, 128, (16, 8, 1, 128)),
    (32, 56, 56, 256, (8, 8, 2, 256)),
    (32, 28, 28, 512, (4, 4, 8, 256)),
    (32, 14, 14, 512, None),
    (256, 32, 32, 64, None),
    (256, 16, 16, 128, None),
    (256, 8, 8, 256, None),
    (256, 4, 4, 512, (4, 4, 8, 64)),          # small grid: narrow tiles
    (1, 1, 1, 64, (1, 1, 1, 64)),
    (9, 1, 1, 64, (1, 1, 9, 64)),
    (3, 7, 7, 40, None),
    (1, 224, 224, 16, None),
])
def test_conv_plan(B, H, W, A, want):
    th, tw, nimg, bn = plan = pc.conv_plan(B, H, W, A, 132)
    assert want is None or plan == want
    assert th * tw * nimg <= pc.BLOCK_PIXELS and th <= H and tw <= W
    assert 1 <= nimg <= B and nimg * (th + 2) * (tw + 2) <= pc.HALO_PIXELS
    assert bn in pc.CHANNEL_TILES
    tiles = -(-W // tw) * -(-H // th) * -(-B // nimg)
    assert bn >= min(A, 256) or tiles * -(-A // (2 * bn)) < 132


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
