"""End-to-end signal-processing demo, the reference workload.

Generates a 15 Hz sine at 200 Hz sample rate for 5 s (1000 samples), runs
the forward FFT (auto-padded to 1024), computes the one-sided PSD, detects
the dominant frequency, inverts the spectrum, and checks the roundtrip
error against the 5*log2(N)*eps limit (expect "Dominant frequency:
15.04 Hz" and [OK]).

Run: python -m gpu_fft_tpu_torch.examples.simple
"""

import time

import numpy as np

import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.utils import (
    calculate_one_sided_frequencies,
    find_dominant_frequencies,
    generate_sine_wave,
)

FREQUENCY = 15.0  # Hz
SAMPLE_RATE = 200.0  # Hz
DURATION = 5.0  # s


def main(device=None) -> int:
    wave = generate_sine_wave(FREQUENCY, SAMPLE_RATE, DURATION)
    print(f"Generated {len(wave)} samples of a {FREQUENCY} Hz sine wave")

    t0 = time.perf_counter()
    re, im = gt.fft(wave, device=device)
    print(f"FFT took {1e3 * (time.perf_counter() - t0):.2f} ms -> {len(re)} bins")

    p = gt.psd(re, im)
    n = len(re)
    bins = n // 2 + 1
    freqs = calculate_one_sided_frequencies(n, SAMPLE_RATE)
    dominant = find_dominant_frequencies(p[:bins], freqs, threshold=100.0)
    for f, power in dominant:
        print(f"Dominant frequency: {f:.2f} Hz (power {power:.2f})")

    t0 = time.perf_counter()
    out = gt.ifft(re, im, device=device)
    print(f"IFFT took {1e3 * (time.perf_counter() - t0):.2f} ms")

    reconstructed = out[: len(wave)]
    max_error = float(np.abs(reconstructed - wave).max())
    limit = 5.0 * np.log2(n) * float(np.finfo(np.float32).eps)
    status = "OK" if max_error <= limit else "FAIL"
    print(f"Roundtrip max error {max_error:.3e} vs limit {limit:.3e} [{status}]")
    return 0 if status == "OK" else 1


if __name__ == "__main__":
    raise SystemExit(main())
