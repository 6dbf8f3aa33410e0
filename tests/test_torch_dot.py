"""The S3 launch rule and tables (``kernels/ablation.py``: ``dot_tables``,
``dot_launch_shapes``, ``dot_geometry``), and the SM count the launch rules read
(``kernels/fused.py``: ``sm_count``, ``whole_geometry``, ``lm_geometry``).

CPU only: the kernels themselves are held against their plain versions on
the card by ``tests/test_torch_cuda.py``; the plain versions against the
JAX script's kernels by ``tests/test_torch_stage_a_variants.py``.
"""

import numpy as np
import pytest
import torch

import gpu_fft_tpu_torch.kernels.ablation as A
import gpu_fft_tpu_torch.kernels.fused as K

# Every (B, n1, n2) the tests and harnesses give S3, the CPU tests' widths,
# and the card tests' edges.
SHAPES = [(1, 128, 8192), (1, 32, 256), (2, 64, 512), (1, 256, 8192), (3, 128, 1024), (1, 64, 64),
          (2, 96, 192), (1, 32, 1024), (1, 128, 256), (1, 128, 1024), (1, 32, 512)]


def _tables(n1, seed=0):
    rng = np.random.default_rng(seed)
    fr = torch.from_numpy((rng.standard_normal((n1, n1)) / n1).astype(np.float32))
    fi = torch.from_numpy((rng.standard_normal((n1, n1)) / n1).astype(np.float32))
    return A.dot_tables(fr, fi)


@pytest.mark.parametrize("n1", [32, 64, 96, 128])
def test_stacked_tables_are_the_old_tables_rearranged(n1):
    """``f_t`` is [Fr; Fi] transposed and ``f_img`` the split parts stacked
    row-wise in the kernel's swizzled layout, the depths past n1 zero: bit
    for bit."""
    t = _tables(n1, n1)
    assert t["f_t"].shape == (n1, 2 * n1) and t["f_t"].is_contiguous()
    assert torch.equal(t["f_t"][:, :n1], t["fr"].t()) and torch.equal(t["f_t"][:, n1:], t["fi"].t())
    img = t["f_img"]
    chunks = -(-n1 // 64)
    assert img.dtype == torch.bfloat16 and img.shape == (2 * n1 // 64, 3, chunks, 64, 64)
    assert img.is_contiguous()
    # Undo the swizzle: word j of row r sits at word j ^ (r % 8).
    words = img.view(torch.int16).reshape(2 * n1 // 64, 3, chunks, 64, 8, 8)
    r = torch.arange(64).reshape(64, 1)
    idx = (torch.arange(8).reshape(1, 8) ^ (r % 8)).reshape(1, 1, 1, 64, 8, 1).expand_as(words)
    plain = torch.gather(words, 4, idx)  # (g, p, c, r, j, e) in logical order
    stacked = plain.permute(1, 0, 3, 2, 4, 5).reshape(3, 2 * n1, chunks * 64)
    assert torch.equal(stacked[:, :n1, :n1], t["fr_bf16"].view(torch.int16))
    assert torch.equal(stacked[:, n1:, :n1], t["fi_bf16"].view(torch.int16))
    assert not stacked[:, :, n1:].any()


def test_swizzled_image_places_each_word():
    """Element (p, m, k) of the parts lands at [m // 64, p, k // 64, m % 64,
    8 * (((k % 64) // 8) ^ (m % 8)) + k % 8]; rows and depths past the
    parts are zero."""
    parts = torch.arange(3 * 128 * 96, dtype=torch.float32).reshape(3, 128, 96)
    img = A.swizzled_image(parts)
    for p, m, k in [(0, 0, 0), (1, 70, 95), (2, 127, 33), (0, 9, 17), (2, 63, 64)]:
        g, r, c, j, e = m // 64, m % 64, k // 64, (k % 64) // 8, k % 8
        assert img[g, p, c, r, 8 * (j ^ (r % 8)) + e] == parts[p, m, k]
    odd = A.swizzled_image(torch.ones(1, 32, 16))
    assert odd.shape == (1, 1, 1, 64, 64) and odd.sum() == 32 * 16


@pytest.mark.parametrize("b,n1,n2", SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_f32_geometry_tiles_the_stacked_product(b, n1, n2, sms):
    """One launch shape, no arguments: the kernel's 64 x 64 block tile
    divides the stacked (2 n1, n2) product and its depth slices of 8 divide
    n1, so no load or store is masked."""
    assert A.dot_launch_shapes(b, n1, n2, "f32_highest", sms) == [()]
    assert A.dot_geometry(b, n1, n2, "f32_highest", sms) == ()
    assert (2 * n1) % 64 == 0 and n2 % 64 == 0 and n1 % 8 == 0


def test_f32_geometry_at_the_harness_shape():
    """512 blocks of 64 x 64, ~4 an SM: the fastest tile of the sweep there
    (``scripts/time_dot.py --sweep`` on an H100), and the only one built."""
    assert A.dot_geometry(1, 128, 8192, "f32_highest", 132) == ()


@pytest.mark.parametrize("b,n1,n2", SHAPES)
@pytest.mark.parametrize("variant", ["bf16_x6", "bf16_x1"])
@pytest.mark.parametrize("sms", [132, 114])
def test_bf16_geometry_fits_and_covers(b, n1, n2, variant, sms):
    """64 * wgs stacked rows a block dividing 2 n1, the block within the
    H100's shared memory; the grid is whole row blocks, at most one block
    per column tile and row block, and never more blocks than SMs; the row
    blocks' rows cover the 2 n1 stacked rows and the blocks of a row block
    its column tiles, once each."""
    parts = 3 if variant == "bf16_x6" else 1
    wgs, grid = A.dot_geometry(b, n1, n2, variant, sms)
    rows = 64 * wgs
    assert wgs in (1, 2, 4) and (2 * n1) % rows == 0
    assert A.dot_smem_bytes(parts, wgs, n1) <= A.SMEM_MAX
    row_blocks = 2 * n1 // rows
    tiles = b * n2 // 64
    assert grid % row_blocks == 0 and row_blocks <= grid <= row_blocks * tiles
    assert grid <= max(sms, row_blocks)
    per_rb = grid // row_blocks
    assert per_rb == min(tiles, sms // row_blocks)
    owned = sorted(t for first in range(per_rb) for t in range(first, tiles, per_rb))
    assert owned == list(range(tiles))
    # A larger row block would not fit.
    if wgs < 4 and (2 * n1) % (2 * rows) == 0:
        assert A.dot_smem_bytes(parts, 2 * wgs, n1) > A.SMEM_MAX


@pytest.mark.parametrize(
    "variant,b,n1,n2",
    [(v, *s) for s in SHAPES + [(1, 384, 128)] for v in ("bf16_x6", "bf16_x1")]
    + [("bf16_x1", 1, 640, 128), ("bf16_x1", 1, 1472, 64)],
)
def test_bf16_launch_shapes_are_every_legal_shape(variant, b, n1, n2):
    """The sweep's list: the rule's pick first, then every (wgs, grid) the C
    launcher takes (row blocks dividing the grid, the block within the
    shared memory), largest row block first, one and then two blocks an SM
    per row block, none twice."""
    parts = 3 if variant == "bf16_x6" else 1
    shapes = A.dot_launch_shapes(b, n1, n2, variant, 132)
    assert shapes[0] == A.dot_geometry(b, n1, n2, variant, 132)
    assert len(set(shapes)) == len(shapes)
    legal = [w for w in (4, 2, 1) if (2 * n1) % (64 * w) == 0 and A.dot_smem_bytes(parts, w, n1) <= A.SMEM_MAX]
    assert sorted({w for w, _ in shapes}, reverse=True) == legal
    for wgs, grid in shapes:
        row_blocks = 2 * n1 // (64 * wgs)
        assert grid % row_blocks == 0 and grid // row_blocks <= b * n2 // 64
        assert grid // row_blocks in (min(b * n2 // 64, f * 132 // row_blocks) for f in (1, 2))


def test_bf16_geometry_at_the_harness_shape():
    """x1: all 256 stacked rows a block (x read and split once), one block
    per column tile; x6: half the rows (96 KB of parts), a block per SM."""
    assert A.dot_geometry(1, 128, 8192, "bf16_x1", 132) == (4, 128)
    assert A.dot_geometry(1, 128, 8192, "bf16_x6", 132) == (2, 132)
    assert A.dot_geometry(1, 128, 8192, "bf16_x6", 114) == (2, 114)
    assert A.dot_launch_shapes(1, 128, 8192, "bf16_x6", 132) == [(2, 132), (2, 256), (1, 132), (1, 264)]


@pytest.mark.parametrize("variant,n1,wgs", [("bf16_x6", 352, 1), ("bf16_x6", 384, 1), ("bf16_x1", 640, 2),
                                            ("bf16_x1", 1056, 1), ("bf16_x1", 1472, 1)])
def test_bf16_geometry_takes_the_largest_parts_that_fit(variant, n1, wgs):
    assert A.dot_geometry(1, n1, 1024, variant)[0] == wgs


@pytest.mark.parametrize("variant", A.VARIANTS)
@pytest.mark.parametrize("b,n1,n2", [(1, 16, 256), (1, 48, 256), (1, 128, 96), (1, 128, 32),
                                     (0, 128, 256), (1, 0, 256)])
def test_dot_geometry_rejects_shapes_the_kernels_cannot_take(variant, b, n1, n2):
    with pytest.raises(ValueError, match="multiple of 32"):
        A.dot_geometry(b, n1, n2, variant)


@pytest.mark.parametrize("variant,n1",
                         [("bf16_x6", 416), ("bf16_x6", 512), ("bf16_x1", 1504), ("bf16_x1", 1536)])
def test_dot_geometry_rejects_parts_that_do_not_fit(variant, n1):
    with pytest.raises(ValueError, match="do not fit"):
        A.dot_geometry(1, n1, 1024, variant)


def test_dot_geometry_rejects_a_batch_over_the_f32_grid():
    with pytest.raises(ValueError, match="B <= 65535"):
        A.dot_geometry(65536, 32, 64, "f32_highest")
    assert A.dot_geometry(65536, 32, 64, "bf16_x1")[1] <= 132  # persistent: no grid.z


def test_dot_geometry_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        A.dot_geometry(1, 128, 8192, "tf32")


# ── The SM count of the launch rules ─────────────────────────────────────────


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_sm_count_without_a_card_is_the_default(device):
    assert K.sm_count(device) == K.DEFAULT_SMS == 132


def _cluster_at_132(b, n1, n2, b1_cluster, max_threads):
    """The cluster rule as it stood with the SM count fixed at 132."""
    least = max(1, n1 * n2 // (8 * max_threads))
    cluster = b1_cluster
    while cluster > least and b * cluster > 132:
        cluster //= 2
    return cluster


@pytest.mark.parametrize("n1", sorted(K._B1_CLUSTER))
def test_whole_geometry_at_132_sms_is_unchanged(n1):
    for b in range(1, 80):
        want = _cluster_at_132(b, n1, 128, K._B1_CLUSTER[n1], 1024)
        assert K.whole_geometry(b, n1) == K.whole_geometry(b, n1, 132)
        assert K.whole_geometry(b, n1, 132)[0] == want


@pytest.mark.parametrize("n", sorted(K._LM_B1_CLUSTER))
def test_lm_geometry_at_132_sms_is_unchanged(n):
    n2 = next(c for c in (64, 128, 256) if n // c <= c)
    n1 = n // n2
    for b in range(1, 80):
        want = _cluster_at_132(b, n1, n2, K._LM_B1_CLUSTER[n], 512)
        assert K.lm_geometry(b, n1, n2) == K.lm_geometry(b, n1, n2, 132)
        assert K.lm_geometry(b, n1, n2, 132)[0] == want


def _first_halving(geometry, b1_cluster):
    return next(b for b in range(1, 1000) if geometry(b)[0] < b1_cluster)


@pytest.mark.parametrize("n1", [n1 for n1, c in K._B1_CLUSTER.items() if c > 1])
def test_whole_geometry_halves_sooner_on_114_sms(n1):
    """A 114-SM card holds fewer blocks a wave: the cluster halves at a
    smaller batch than on 132 SMs."""
    c = K._B1_CLUSTER[n1]
    at_114 = _first_halving(lambda b: K.whole_geometry(b, n1, 114), c)
    at_132 = _first_halving(lambda b: K.whole_geometry(b, n1, 132), c)
    assert at_114 < at_132
    assert at_114 == 114 // c + 1 and at_132 == 132 // c + 1


@pytest.mark.parametrize("n1,n2", [(32, 128), (64, 128), (128, 128), (128, 256)])
def test_lm_geometry_halves_sooner_on_114_sms(n1, n2):
    c = K._LM_B1_CLUSTER[n1 * n2]
    at_114 = _first_halving(lambda b: K.lm_geometry(b, n1, n2, 114), c)
    at_132 = _first_halving(lambda b: K.lm_geometry(b, n1, n2, 132), c)
    assert at_114 < at_132
