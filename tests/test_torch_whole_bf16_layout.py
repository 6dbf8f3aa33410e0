"""The launch rule of K1F / K2F (``csrc/whole_bf16.cu``) without a card.

``kernels/fused.py:whole_bf16_geometry`` picks the blocks a row, the block
size and the shared memory; ``_bf16_mode`` and ``whole_bf16_split`` say
how the blocks share stage 1 and split stage 2's rows j and columns k1, as
the kernel derives them from n1 and the blocks a row;
``whole_bf16_slices`` and ``whole_bf16_traffic`` say what each block
computes and reads.  The C entry refuses any geometry its own ``Layout``
does not give, so these pin the Python mirror of it, and the kernel's
promise that no byte of x, F1, F2 or the twiddle leaves L2 twice within a
row (but at n1 <= 16, at most 16 KB of each a block).
"""

import pytest

from gpu_fft_tpu_torch.kernels import fused as K

N1S = (8, 16, 32, 64, 128)
SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory


def _geometries():
    return [(n1, b, c, p) for n1 in N1S for b in (1, 3, 64, 65_535) for c in (False, True) for p in (False, True)]


@pytest.mark.parametrize("n1,b,complex_,packed", _geometries())
def test_geometry_fits_and_splits_evenly(n1, b, complex_, packed):
    cluster, threads, smem = K.whole_bf16_geometry(b, n1, complex_, packed=packed)
    split = K.whole_bf16_split(n1, cluster)
    assert smem == K.whole_bf16_smem_bytes(n1, cluster, complex_, packed) <= SMEM_LIMIT
    assert cluster in (1, 2, 4, 8) and 128 % cluster == 0
    assert threads % 32 == 0 and 128 <= threads <= 512
    assert cluster % split == 0 and n1 % split == 0 and (n1 < 16 or n1 // split >= 16)
    assert split == 1 or K._bf16_mode(n1, cluster) == "exchange"
    rows_j = 128 * split // cluster
    assert rows_j % 16 == 0  # whole 16-row tiles of F2 a block


@pytest.mark.parametrize("n1,b,complex_,packed", _geometries())
def test_slices_cover_every_column_and_output_once(n1, b, complex_, packed):
    cluster = K.whole_bf16_geometry(b, n1, complex_, packed=packed)[0]
    slices = K.whole_bf16_slices(n1, cluster)
    assert len(slices) == cluster
    cols = [c for s in slices for c in s[0]]
    if K._bf16_mode(n1, cluster) == "exchange":
        assert sorted(cols) == list(range(128))  # stage 1's columns, each once
    else:
        assert all(list(s[0]) == list(range(128)) for s in slices)  # every block all of Z
    outputs = sorted(j * n1 + k1 for _, rows, ks in slices for j in rows for k1 in ks)
    assert outputs == list(range(128 * n1))  # each Y[j, k1] written by one block


@pytest.mark.parametrize("n1", N1S)
@pytest.mark.parametrize("complex_", [False, True])
def test_b1_geometry_is_the_swept_one(n1, complex_):
    for packed in (False, True):
        cluster, threads, smem = K.whole_bf16_geometry(1, n1, complex_, packed=packed)
        assert cluster == K._BF16_B1_CLUSTER[n1]
        assert (threads, smem) == K._bf16_fits(n1, cluster, complex_, packed)


@pytest.mark.parametrize("n1", N1S)
@pytest.mark.parametrize("complex_", [False, True])
def test_batches_halve_the_cluster_down_to_the_least_that_fits(n1, complex_):
    least = min(c for c in (1, 2, 4, 8) if K._bf16_fits(n1, c, complex_, False))
    for b in (1, 3, 16, 17, 33, 64, 65_535):
        cluster = K.whole_bf16_geometry(b, n1, complex_)[0]
        assert cluster == least or b * cluster <= K.DEFAULT_SMS
        assert cluster == K._BF16_B1_CLUSTER[n1] or b * 2 * cluster > K.DEFAULT_SMS
    assert K.whole_bf16_geometry(64, n1, complex_, sms=114)[0] <= K.whole_bf16_geometry(64, n1, complex_)[0]


@pytest.mark.parametrize("n1", N1S)
@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_no_byte_leaves_l2_twice_within_a_row(n1, complex_, packed):
    cluster = K.whole_bf16_geometry(1, n1, complex_, packed=packed)[0]
    split = K.whole_bf16_split(n1, cluster)
    mode = K._bf16_mode(n1, cluster)
    blocks = K.whole_bf16_traffic(n1, cluster, complex_, packed)
    slots1, _ = K._BF16_FORMS[K._bf16_forms(complex_, packed)[0]]
    slots2, operands2 = K._BF16_FORMS[K._bf16_forms(complex_, packed)[1]]
    once = {"x": 4 * (2 if complex_ else 1) * n1 * 128, "twiddle": 8 * n1 * 128,
            "f1": 2 * slots1 * max(n1, 16) ** 2, "f2": 2 * slots2 * 128 * 128}
    total = {k: sum(b[k] for b in blocks) for k in once}
    assert total["f2"] == once["f2"]
    if n1 >= 32:
        assert total == once
        # the peers give each block Z's columns of its k1 it did not compute
        peers = 2 * operands2 * (n1 // split) * (128 - 128 // cluster) if mode == "exchange" else 0
        assert all(b["peers"] == peers for b in blocks)
    else:
        for b in blocks:
            assert b["peers"] == 0 and max(b["x"], b["twiddle"], b["f1"]) <= 16 * 1024
            assert (b["x"], b["twiddle"], b["f1"]) == (once["x"], once["twiddle"], once["f1"])


def test_modes_and_splits_by_n1():
    assert [K._bf16_mode(n1, 8) for n1 in N1S] == ["local", "local", "broadcast", "exchange", "exchange"]
    assert [K.whole_bf16_split(n1, 8) for n1 in N1S] == [1, 1, 1, 4, 8]
    assert {K._bf16_mode(n1, 1) for n1 in N1S} == {"local"}
    assert K.whole_bf16_split(128, 4) == 4 and K.whole_bf16_split(64, 2) == 2


@pytest.mark.parametrize("n1,complex_,packed,smem", [
    (8, False, True, 19_712), (8, True, False, 38_784), (32, False, False, 87_552), (32, True, False, 116_736),
    (128, False, False, 195_328), (128, True, False, 228_096),
])
def test_smem_matches_the_source_note(n1, complex_, packed, smem):
    """The shared-memory sizes at 8 blocks a row that ``csrc/whole_bf16.cuh``'s
    note states."""
    assert K.whole_bf16_smem_bytes(n1, 8, complex_, packed) == smem


def test_every_n1_outside_the_band_is_refused():
    for n1 in (4, 12, 256, 512):
        with pytest.raises(ValueError, match="power of two in \\[8, 128\\]"):
            K.whole_bf16_geometry(1, n1, False)
