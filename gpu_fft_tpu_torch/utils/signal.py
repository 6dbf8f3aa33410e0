"""Signal utilities (numpy, host-side): a copy of the functions of
``gpu_fft_tpu/utils/signal.py`` that the reference workload uses, so the
port needs no import of the JAX package."""

from __future__ import annotations

import numpy as np

__all__ = [
    "generate_sine_wave",
    "calculate_frequencies",
    "calculate_one_sided_frequencies",
    "find_dominant_frequencies",
    "fftfreq",
    "rfftfreq",
]


def generate_sine_wave(frequency: float, sample_rate: float, duration: float) -> np.ndarray:
    """sin(2π f n / sr) for n in [0, sample_rate * duration) samples
    (reference ``src/utils.rs:26-31``).

    >>> w = generate_sine_wave(1.0, 4.0, 1.0)   # one cycle at 4 samples/s
    >>> [round(float(v), 6) for v in w]
    [0.0, 1.0, -0.0, -1.0]
    """
    num_samples = int(sample_rate * duration)
    n = np.arange(num_samples, dtype=np.float32)
    return np.sin(2.0 * np.pi * frequency * n / sample_rate).astype(np.float32)


def calculate_frequencies(n: int, sample_rate: float) -> np.ndarray:
    """Two-sided bin -> Hz map: bin k is k * sample_rate / n
    (reference ``src/utils.rs:50-52``).

    >>> calculate_frequencies(4, 100.0).tolist()
    [0.0, 25.0, 50.0, 75.0]
    """
    return (np.arange(n, dtype=np.float32) * np.float32(sample_rate) / np.float32(n)).astype(
        np.float32
    )


def calculate_one_sided_frequencies(n_total: int, sample_rate: float) -> np.ndarray:
    """The n_total // 2 + 1 unique non-negative frequencies, 0 Hz ... Nyquist
    (reference ``src/utils.rs:71-75``).

    >>> calculate_one_sided_frequencies(8, 100.0).tolist()
    [0.0, 12.5, 25.0, 37.5, 50.0]
    """
    k = np.arange(n_total // 2 + 1, dtype=np.float32)
    return (k * np.float32(sample_rate) / np.float32(n_total)).astype(np.float32)


def fftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """Signed DFT bin frequencies, ``numpy.fft.fftfreq`` semantics: the
    upper half of the spectrum maps to NEGATIVE frequencies (unlike
    :func:`calculate_frequencies`, which mirrors the reference's unsigned
    0..(n-1)·fs/n map).

    >>> fftfreq(4, d=0.25).tolist()
    [0.0, 1.0, -2.0, -1.0]
    """
    return np.fft.fftfreq(n, d=d).astype(np.float32)


def rfftfreq(n: int, d: float = 1.0) -> np.ndarray:
    """One-sided bin frequencies for ``rfft`` output, ``numpy.fft.rfftfreq``
    semantics (equivalent to :func:`calculate_one_sided_frequencies` with
    ``sample_rate = 1/d``).

    >>> rfftfreq(8, d=0.01).tolist()
    [0.0, 12.5, 25.0, 37.5, 50.0]
    """
    return np.fft.rfftfreq(n, d=d).astype(np.float32)


def find_dominant_frequencies(psd, frequencies, threshold: float) -> list[tuple[float, float]]:
    """Local peaks above threshold; endpoints excluded
    (reference ``src/utils.rs:100-110``).

    A peak strictly exceeds both neighbors and the threshold.  Returns
    (frequency, power) pairs in ascending bin order.

    >>> find_dominant_frequencies([0.0, 9.0, 1.0, 8.0, 0.0], [0.0, 1.0, 2.0, 3.0, 4.0], 5.0)
    [(1.0, 9.0), (3.0, 8.0)]
    >>> find_dominant_frequencies([9.0, 1.0, 0.0], [0.0, 1.0, 2.0], 5.0)  # endpoint excluded
    []
    """
    p = np.asarray(psd, dtype=np.float32)
    f = np.asarray(frequencies, dtype=np.float32)
    if p.shape != f.shape:
        raise ValueError(
            f"psd and frequencies must have the same length, got {p.shape} vs {f.shape}"
        )
    if p.shape[0] < 3:
        return []
    mid = p[1:-1]
    mask = (mid > p[:-2]) & (mid > p[2:]) & (mid > threshold)
    idx = np.nonzero(mask)[0] + 1
    return [(float(f[i]), float(p[i])) for i in idx]
