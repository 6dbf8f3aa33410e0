"""The frozen work counts of the cells' shapes, and of larger shapes of
each op kind, worked by hand."""

from __future__ import annotations

import pytest

from portbench.work import fft, fft2, peaks, welch

WELCH = {"nperseg": 4096, "noverlap": 2048}


def test_peaks_are_the_published_h100_figures():
    assert peaks.FP32_FLOPS == 67e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("b, n, flop", [
    (1, 16384, 2.5 * 16384 * 14),  # 573,440
    (1, 65536, 2.5 * 65536 * 16),  # 2,621,440
    (16, 65536, 16 * 2.5 * 65536 * 16),  # 41,943,040
    (64, 4096, 64 * 2.5 * 4096 * 12),  # 7,864,320
])
def test_gpufft_cells(b, n, flop):
    w = fft.count((b, n), {})
    assert w.flop == flop
    assert w.bytes == 12 * b * n  # 4 bytes in, 8 out, a sample
    assert w.samples == b * n
    assert peaks.bound_s(w.flop, w.bytes) == pytest.approx(12 * b * n / 3.35e12)


def test_welch_n100000_seg1024():
    params = {"nperseg": 1024, "noverlap": 512}
    assert welch.segments(100_000, params) == 194  # (100,000 - 1,024) // 512 + 1
    w = welch.count((1, 100_000), params)
    assert w.flop == 194 * 2.5 * 1024 * 10 == 4_966_400
    assert w.bytes == 4 * 100_000 + 4 * 513 == 402_052
    assert w.samples == 100_000
    assert peaks.bound_s(w.flop, w.bytes) == pytest.approx(402_052 / 3.35e12)


def test_welch_b8_n2e22_seg4096():
    assert welch.segments(1 << 22, WELCH) == 2047
    w = welch.count((8, 1 << 22), WELCH)
    assert w.flop == 8 * 2047 * 2.5 * 4096 * 12 == 2_012_282_880
    assert w.bytes == 8 * 4194304 * 4 + 8 * 2049 * 4 == 134_283_296


def test_fft2_4096sq():
    w = fft2.count((1, 4096, 4096), {})
    assert w.flop == 2.5 * 16777216 * 24 == 1_006_632_960
    assert w.bytes == 201_326_592
    assert w.samples == 16_777_216


def test_stack64_512sq():
    w = fft2.count((64, 512, 512), {})
    assert w.flop == 64 * 2.5 * 262144 * 18 == 754_974_720
    assert w.bytes == 201_326_592
    assert w.samples == 16_777_216
    assert peaks.bound_s(w.flop, w.bytes) == pytest.approx(201_326_592 / 3.35e12)
