"""Signal utilities (numpy, host-side), matching the reference's
``src/utils.rs`` semantics.

Port of ``gpu_fft_tpu/utils/signal.py``: a copy of that pure-numpy module
(only this docstring differs), so the port needs no import of the JAX
package — the reference workload's helpers and the waveform generators
(``chirp``, ``square``, ``sawtooth``, ``gausspulse``, ``sweep_poly``,
``unit_impulse``, ``max_len_seq``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "square",
    "sawtooth",
    "gausspulse",
    "sweep_poly",
    "unit_impulse",
    "max_len_seq",

    "generate_sine_wave",
    "calculate_frequencies",
    "calculate_one_sided_frequencies",
    "find_dominant_frequencies",
    "fftfreq",
    "rfftfreq",
    "chirp",
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


def chirp(
    t,
    f0: float,
    t1: float,
    f1: float,
    method: str = "linear",
    phi: float = 0.0,
    vertex_zero: bool = True,
) -> np.ndarray:
    """Frequency-swept cosine, ``scipy.signal.chirp`` semantics: the
    instantaneous frequency sweeps from ``f0`` at t=0 to ``f1`` at ``t1``
    along a linear / quadratic / logarithmic / hyperbolic law; ``phi`` is
    the initial phase in degrees.  Generators sit host-side beside
    :func:`generate_sine_wave` (extension — the reference only has the
    single-tone generator, ``src/utils.rs:26-31``).

    >>> t = np.linspace(0.0, 1.0, 5)
    >>> bool(np.allclose(chirp(t, 2.0, 1.0, 2.0), np.cos(4 * np.pi * t), atol=1e-6))
    True
    """
    t = np.asarray(t, dtype=np.float64)
    f0, t1, f1 = float(f0), float(t1), float(f1)
    if method in ("linear", "lin", "li"):
        beta = (f1 - f0) / t1
        phase = 2.0 * np.pi * (f0 * t + 0.5 * beta * t * t)
    elif method in ("quadratic", "quad", "q"):
        beta = (f1 - f0) / (t1 * t1)
        if vertex_zero:
            phase = 2.0 * np.pi * (f0 * t + beta * t**3 / 3.0)
        else:
            phase = 2.0 * np.pi * (f1 * t + beta * ((t1 - t) ** 3 - t1**3) / 3.0)
    elif method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0.0:
            raise ValueError("logarithmic chirp requires f0 and f1 to be nonzero and same-sign")
        if f0 == f1:
            phase = 2.0 * np.pi * f0 * t
        else:
            beta = t1 / np.log(f1 / f0)
            phase = 2.0 * np.pi * beta * f0 * (np.power(f1 / f0, t / t1) - 1.0)
    elif method in ("hyperbolic", "hyp"):
        if f0 == 0.0 or f1 == 0.0:
            raise ValueError("hyperbolic chirp requires nonzero f0 and f1")
        if f0 == f1:
            phase = 2.0 * np.pi * f0 * t
        else:
            sing = -f1 * t1 / (f0 - f1)
            phase = 2.0 * np.pi * (-sing * f0) * np.log(np.abs(1.0 - t / sing))
    else:
        raise ValueError(
            f"method must be linear, quadratic, logarithmic or hyperbolic, got {method!r}"
        )
    return np.cos(phase + np.deg2rad(phi)).astype(np.float32)


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


def square(t, duty: float = 0.5) -> np.ndarray:
    """Square wave of period 2π (``scipy.signal.square``): +1 while the
    phase's fractional position within a period is < ``duty``, −1 after.
    ``duty`` may be an array broadcast against ``t``."""
    t = np.asarray(t, dtype=np.float64)
    duty = np.asarray(duty, dtype=np.float64)
    frac = np.mod(t, 2.0 * np.pi) / (2.0 * np.pi)
    out = np.where(frac < duty, 1.0, -1.0)
    return np.where((duty < 0) | (duty > 1), np.nan, out)


def sawtooth(t, width: float = 1.0) -> np.ndarray:
    """Sawtooth/triangle wave of period 2π (``scipy.signal.sawtooth``):
    rises −1→+1 over ``width`` of each period, falls +1→−1 over the rest
    (width=1 pure sawtooth, width=0.5 triangle)."""
    t = np.asarray(t, dtype=np.float64)
    width = np.asarray(width, dtype=np.float64)
    frac = np.mod(t, 2.0 * np.pi) / (2.0 * np.pi)
    rising = 2.0 * frac / np.where(width == 0, 1.0, width) - 1.0
    falling = 2.0 * (1.0 - frac) / np.where(width == 1, 1.0, 1.0 - width) - 1.0
    out = np.where(frac < width, rising, falling)
    return np.where((width < 0) | (width > 1), np.nan, out)


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               tpr: float = -60.0, retquad: bool = False, retenv: bool = False):
    """Gaussian-modulated sinusoid (``scipy.signal.gausspulse``).  ``bw`` is
    the fractional bandwidth at level ``bwr`` dB of the spectral magnitude;
    pass the string ``'cutoff'`` as ``t`` to get the time where the envelope
    falls to ``tpr`` dB instead."""
    if fc <= 0:
        raise ValueError("fc must be positive")
    if bw <= 0:
        raise ValueError("bw must be positive")
    if bwr >= 0:
        raise ValueError("bwr must be negative (a dB attenuation)")
    ref = 10.0 ** (bwr / 20.0)
    # envelope exp(-a t^2) whose spectrum drops to `ref` at f = fc*bw/2
    a = -((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref))
    if isinstance(t, str):
        if t != "cutoff":
            raise ValueError("the only string t accepts is 'cutoff'")
        if tpr >= 0:
            raise ValueError("tpr must be negative (a dB attenuation)")
        return float(np.sqrt(-np.log(10.0 ** (tpr / 20.0)) / a))
    t = np.asarray(t, dtype=np.float64)
    env = np.exp(-a * t * t)
    yi = env * np.cos(2.0 * np.pi * fc * t)
    out = (yi,)
    if retquad:
        out += (env * np.sin(2.0 * np.pi * fc * t),)
    if retenv:
        out += (env,)
    return out[0] if len(out) == 1 else out


def sweep_poly(t, poly, phi: float = 0.0) -> np.ndarray:
    """Polynomial-frequency sweep (``scipy.signal.sweep_poly``): cos of
    2π·∫f(t)dt with f given by ``poly`` (np.poly1d or descending coeffs)."""
    t = np.asarray(t, dtype=np.float64)
    p = np.poly1d(poly)
    phase = 2.0 * np.pi * np.polyval(p.integ(), t)
    return np.cos(phase + np.pi * phi / 180.0)


def unit_impulse(shape, idx=None, dtype=float) -> np.ndarray:
    """Discrete delta (``scipy.signal.unit_impulse``): 1 at ``idx`` (default
    index 0; 'mid' = centre), 0 elsewhere."""
    out = np.zeros(shape, dtype=dtype)
    shape_t = out.shape
    if idx is None:
        idx = (0,) * out.ndim
    elif idx == "mid":
        idx = tuple(s // 2 for s in shape_t)
    elif not hasattr(idx, "__iter__"):
        idx = (idx,) * out.ndim
    out[tuple(idx)] = 1
    return out


def max_len_seq(nbits: int, state=None, length: int | None = None, taps=None):
    """Maximum-length LFSR sequence (``scipy.signal.max_len_seq``): the
    2^nbits − 1 period binary m-sequence from the standard primitive taps.
    Returns (seq, final_state)."""
    _MLS_TAPS = {2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6],
                 8: [7, 6, 1], 9: [5], 10: [7], 11: [9], 12: [11, 10, 4],
                 13: [12, 11, 8], 14: [13, 12, 2], 15: [14], 16: [15, 13, 4],
                 17: [14], 18: [11], 19: [18, 17, 14], 20: [17], 21: [19],
                 22: [21], 23: [18], 24: [23, 22, 17], 25: [22], 26: [25, 24, 20],
                 27: [26, 25, 22], 28: [25], 29: [27], 30: [29, 28, 7],
                 31: [28], 32: [31, 30, 10]}
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError(f"nbits must be between 2 and 32 (got {nbits}) "
                             "unless taps are given")
        taps = np.array(_MLS_TAPS[nbits], dtype=np.intp)
    else:
        taps = np.unique(np.asarray(taps, dtype=np.intp))[::-1]
        if np.any(taps < 0) or np.any(taps > nbits) or taps.size < 1:
            raise ValueError("taps must be non-empty with values in [0, nbits]")
    n_max = (1 << nbits) - 1
    length = n_max if length is None else int(length)
    if length < 0:
        raise ValueError("length must be >= 0")
    if state is None:
        state = np.ones(nbits, dtype=np.int8)
    else:
        state = (np.asarray(state, dtype=bool)).astype(np.int8)
        if state.size != nbits:
            raise ValueError("state must have nbits elements")
        if not np.any(state):
            raise ValueError("state must not be all zeros")
    # Fibonacci LFSR over a circular buffer (scipy's layout: cell `idx` is
    # both the output and the write-back target each tick, so the final
    # state is rolled back to a position-independent form before return).
    seq = np.empty(length, dtype=np.int8)
    idx = 0
    for i in range(length):
        fb = state[idx]
        seq[i] = fb
        for t_ in taps:
            fb ^= state[(t_ + idx) % nbits]
        state[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(state, -idx).astype(np.int8)
