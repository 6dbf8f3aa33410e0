"""FFT-domain FIR filtering: overlap-add convolution, design, application.

Port of ``gpu_fft_tpu/ops/filter.py`` (the 1-D part).  The centerpiece is
:func:`oaconvolve_device`, overlap-add block convolution for signals far
longer than one transform: the signal is cut into blocks that all ride ONE
batched transform (``kernels/large.py:transform_any``), are multiplied by
the kernel's spectrum, inverted by the real-output ``inverse_real`` and
re-assembled by one shifted tail addition.  The transform length stays
bounded by the block size however long the signal is.  On top of it:
:func:`fftfilt` (causal FIR, ``scipy.signal.lfilter(h, [1], x)``),
:func:`filtfilt_fir` (zero-phase), :class:`FIRStream` (chunked streaming
with exact state), :func:`savgol_filter`, and the frequency responses
(:func:`freqz`, :func:`freqz_fir`, :func:`sosfreqz`) through the exact
transform.  The designs (:func:`firwin`, :func:`firwin2`,
:func:`minimum_phase`, :func:`savgol_coeffs`, :func:`group_delay`, the
Kaiser formulas) are host float64 numpy, the JAX package's own.

The host API takes numpy and returns numpy and runs on ``device`` (default
``"cuda"``); ``*_device`` functions take and return tensors.  The 2-D
convolutions ride ``ops/fft2d``, which the port does not have yet; they are
not here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from .dsp import _pair_rows, _spectral_product
from .iir import _edge_extend
from .transform import _as_tensor, _upload, next_power_of_two

__all__ = [
    "FIRStream",
    "choose_conv_method",
    "fftfilt",
    "fftfilt_device",
    "filtfilt_fir",
    "firwin",
    "firwin2",
    "firwin_2d",
    "freqz",
    "freqz_fir",
    "freqz_sos",
    "group_delay",
    "kaiser_atten",
    "kaiser_beta",
    "kaiserord",
    "minimum_phase",
    "oaconvolve",
    "oaconvolve_device",
    "savgol_coeffs",
    "savgol_filter",
    "sosfreqz",
]


def _best_block_fft_size(lh: int) -> int:
    """The overlap-add block transform length m (a power of two): the
    tuning row's ``oa_block_min`` floor, grown only to keep the length-(lh-1)
    tail inside one hop (m >= 2*next_pow2(lh)).  The floor is a measured
    rule, not the textbook m*log2(m)/(m-lh+1) cost model: fewer, larger
    blocks win while the block transform is launch-bound
    (``scripts/calibrate_chip.py`` times each block length)."""
    from ..tuning import get_tuning

    return max(get_tuning().oa_block_min, 2 * next_power_of_two(max(lh, 1)))


def oaconvolve_device(x, h, block: int | None = None, device=None):
    """Overlap-add full convolution of batched real rows, on the tensors'
    device.

    ``x``: (n,) or (B, n) real f32 rows; ``h``: (lh,) or (B, lh) real f32
    kernel (one row broadcasts across the batch, its spectrum computed
    once).  Returns the (B, n+lh-1) full linear convolution, 1-D when both
    inputs were.  ``block`` overrides the block transform length (a power
    of two >= 2*lh); by default :func:`_best_block_fft_size` picks it.
    Where one block covers the whole output, :func:`fft_convolve_device`
    runs instead.
    """
    from ..kernels.large import inverse_real, transform_any
    from .dsp import fft_convolve_device

    x = _as_tensor(x, device)
    h = _as_tensor(h, x.device)
    squeeze = x.dim() == 1 and h.dim() == 1
    x, h = _pair_rows(x, h, "oaconvolve_device")
    if x.shape[1] < h.shape[1]:  # convolution commutes; keep the kernel short
        x, h = h, x
    bx, n = x.shape
    lh = h.shape[1]
    lfull = n + lh - 1

    m = _best_block_fft_size(lh) if block is None else int(block)
    if block is not None and (m & (m - 1) or m < 2 * lh):
        raise ValueError(f"block must be a power of two >= 2*len(h), got {block}")
    if m >= next_power_of_two(lfull):
        out = fft_convolve_device(x, h)
        return out[0] if squeeze else out

    hop = m - lh + 1  # fresh input samples per block
    nblocks = -(-n // hop)
    xp = F.pad(x, (0, nblocks * hop - n)).reshape(bx, nblocks, hop)
    xp = F.pad(xp, (0, m - hop))  # (bx, nblocks, m)
    hr, hi = transform_any(F.pad(h, (0, m - lh)), None, m, -1)
    xr, xi = transform_any(xp.reshape(bx * nblocks, m), None, m, -1)
    cr, ci = _spectral_product(xr.reshape(bx, nblocks, m), xi.reshape(bx, nblocks, m),
                               hr[:, None, :], hi[:, None, :])
    b = cr.shape[0]
    yr = inverse_real(cr.reshape(b * nblocks, m), ci.reshape(b * nblocks, m), m, scale=1.0 / m)
    blocks = yr.reshape(b, nblocks, m)

    # Overlap-add: block k spans [k*hop, k*hop + m).  m >= 2*lh keeps the
    # tail (lh - 1 < hop samples) inside the NEXT block's span, so one
    # shifted addition assembles the output.
    t = m - hop  # tail length = lh - 1
    main = blocks[:, :, :hop]
    tails = blocks[:, :, hop:]  # (b, nblocks, t)
    shifted = F.pad(tails, (0, hop - t, 1, 0))[:, :-1]
    out = (main + shifted).reshape(b, nblocks * hop)
    out = torch.cat([out, F.pad(tails[:, -1], (0, hop - t))], dim=1)[:, :lfull]
    return out[0] if squeeze else out


def oaconvolve(x, h, mode: str = "full", block: int | None = None, device=None):
    """Overlap-add linear convolution of real 1-D signals.

    ``scipy.signal.oaconvolve`` semantics for real input, mode shapes
    included: "full" (default, len la+lb-1), "same" (centered, the FIRST
    operand's length) or "valid" (the |la-lb|+1 fully overlapping samples,
    either operand may be the longer one).

    >>> oaconvolve([1.0, 2.0, 3.0], [1.0, 1.0], device="cpu").round(5).tolist()
    [1.0, 3.0, 5.0, 3.0]
    >>> oaconvolve([1.0, 2.0, 3.0, 4.0], [1.0, 1.0], mode="same", device="cpu").round(5).tolist()
    [1.0, 3.0, 5.0, 7.0]
    """
    xv = np.asarray(x, dtype=np.float32)
    hv = np.asarray(h, dtype=np.float32)
    if xv.ndim != 1 or hv.ndim != 1 or xv.size == 0 or hv.size == 0:
        raise ValueError("oaconvolve expects two non-empty 1-D signals")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    la, lb = xv.shape[0], hv.shape[0]
    full = oaconvolve_device(xv, hv, block=block, device=device).cpu().numpy()
    if mode == "full":
        return full
    if mode == "same":
        start = (lb - 1) // 2
        return full[start : start + la].copy()
    lo = min(la, lb)
    return full[lo - 1 : max(la, lb)].copy()


def _symmetric_window(window, numtaps: int) -> np.ndarray:
    """Symmetric (filter-design) window, f64: denominator N-1, not N.  The
    family :func:`~gpu_fft_tpu_torch.window_table` accepts (``("kaiser",
    beta)`` included), in its symmetric (fftbins=False) form."""
    if window is None or window == "rect":
        return np.ones(numtaps)
    from .stft import _symmetric_table

    return _symmetric_table(window, numtaps)


def kaiser_beta(a: float) -> float:
    """Kaiser shape parameter beta for ``a`` dB of stopband attenuation
    (the standard Kaiser empirical formula; ``scipy.signal.kaiser_beta``).

    >>> round(kaiser_beta(60.0), 4)
    5.6533
    """
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) a ``numtaps``-tap Kaiser filter reaches with a
    transition band of ``width`` (normalized to Nyquist) —
    ``scipy.signal.kaiser_atten``.

    >>> round(kaiser_atten(81, 0.1), 4)
    65.3783
    """
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiserord(ripple: float, width: float) -> tuple[int, float]:
    """Kaiser-window design: (numtaps, beta) reaching ``ripple`` dB of
    attenuation with a ``width`` transition band (normalized to Nyquist) —
    ``scipy.signal.kaiserord`` semantics.  Feed the result to
    :func:`firwin` as ``firwin(numtaps, cutoff, window=("kaiser", beta))``.

    >>> kaiserord(60.0, 0.1)
    (74, 5.65326)
    """
    a = abs(ripple)
    if a < 8.0:
        raise ValueError(
            "ripple attenuation is too small for the Kaiser formula (< 8 dB)"
        )
    beta = kaiser_beta(a)
    numtaps = (a - 7.95) / (2.285 * np.pi * width) + 1
    return int(np.ceil(numtaps)), beta


def firwin(
    numtaps: int,
    cutoff,
    *,
    window: str | None = "hamming",
    pass_zero: bool | str = True,
    scale: bool = True,
    fs: float = 2.0,
) -> np.ndarray:
    """Window-method FIR filter design (``scipy.signal.firwin`` semantics).

    ``pass_zero`` also accepts scipy's string forms: "lowpass"/"bandstop"
    (DC passes) and "highpass"/"bandpass" (DC blocked), with the band-edge
    count validated against the named response.

    ``numtaps`` linear-phase taps; ``cutoff`` is a scalar or ascending list
    of band edges in the same units as ``fs`` (default fs=2 means cutoffs
    are normalized to the Nyquist frequency).  ``pass_zero=True`` makes the
    first band a passband (lowpass / bandstop); False starts with a
    stopband (highpass / bandpass).  Each band contributes a windowed ideal
    (sinc) response; ``window`` accepts the same family as
    :func:`~gpu_fft_tpu_torch.window_table` (hamming default, ``("kaiser", beta)``
    included) in symmetric form; ``scale`` normalizes unity gain at the
    center of the first passband.  Returns f64 taps (design is host-side
    math).

    >>> float(firwin(11, 0.4).sum().round(6))  # unity DC gain when scaled
    1.0
    """
    if numtaps < 1:
        raise ValueError(f"numtaps must be >= 1, got {numtaps}")
    edges = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / (fs / 2.0)
    if edges.ndim != 1 or edges.size == 0:
        raise ValueError("cutoff must be a scalar or 1-D sequence")
    if np.any(edges <= 0.0) or np.any(edges >= 1.0):
        raise ValueError("cutoff frequencies must lie strictly inside (0, fs/2)")
    if np.any(np.diff(edges) <= 0.0):
        raise ValueError("cutoff must be strictly increasing")

    if isinstance(pass_zero, str):
        if pass_zero not in ("lowpass", "highpass", "bandpass", "bandstop"):
            raise ValueError(
                "pass_zero must be a bool or lowpass|highpass|bandpass|bandstop, "
                f"got {pass_zero!r}"
            )
        if pass_zero in ("lowpass", "highpass") and edges.size != 1:
            raise ValueError(f"{pass_zero} needs exactly one cutoff, got {edges.size}")
        if pass_zero in ("bandpass", "bandstop") and edges.size < 2:
            raise ValueError(f"{pass_zero} needs at least two cutoffs, got {edges.size}")
        pass_zero = pass_zero in ("lowpass", "bandstop")
    pass_nyquist = bool(edges.size & 1) ^ pass_zero
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError(
            "an even-numtaps filter has zero response at Nyquist; "
            "use odd numtaps for highpass/bandstop designs"
        )
    bands = np.concatenate(
        [[0.0] if pass_zero else [], edges, [1.0] if pass_nyquist else []]
    ).reshape(-1, 2)

    k = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps)
    for left, right in bands:
        h += right * np.sinc(right * k) - left * np.sinc(left * k)
    h *= _symmetric_window(window, numtaps)
    if scale:
        left, right = bands[0]
        fc = 0.0 if left == 0.0 else (1.0 if right == 1.0 else 0.5 * (left + right))
        h /= np.sum(h * np.cos(np.pi * k * fc))
    return h


def firwin2(
    numtaps: int,
    freq,
    gain,
    *,
    nfreqs: int | None = None,
    window: object = "hamming",
    antisymmetric: bool = False,
    fs: float = 2.0,
) -> np.ndarray:
    """Frequency-sampling FIR design (``scipy.signal.firwin2`` semantics).

    ``freq``/``gain`` describe the desired magnitude response as a
    piecewise-linear curve from 0 to fs/2 (``freq`` ascending, first 0,
    last fs/2; a frequency may repeat once to make a step).  The curve is
    interpolated onto a dense grid, given the linear-phase delay, inverted
    to taps (the inverse-transform half of this library's rfft pair, host
    f64), and windowed.  ``antisymmetric`` selects the odd-symmetric
    (type III/IV — differentiator/Hilbert) families with the standard
    zero-gain constraints at DC/Nyquist.

    >>> taps = firwin2(65, [0.0, 0.3, 0.3, 1.0], [1.0, 1.0, 0.0, 0.0])
    >>> round(float(taps.sum()), 2)  # DC gain ~ 1
    1.0
    """
    if numtaps < 3:
        raise ValueError(f"numtaps must be >= 3, got {numtaps}")
    f = np.asarray(freq, dtype=np.float64) / (fs / 2.0)
    g = np.asarray(gain, dtype=np.float64)
    if f.ndim != 1 or f.shape != g.shape or f.size < 2:
        raise ValueError("freq and gain must be equal-length 1-D sequences (>= 2 points)")
    if f[0] != 0.0 or abs(f[-1] - 1.0) > 1e-12:
        raise ValueError("freq must start at 0 and end at fs/2")
    d = np.diff(f)
    if np.any(d < 0.0):
        raise ValueError("freq must be nondecreasing")
    if np.any(d[:-1] + d[1:] == 0.0):  # a value may repeat at most twice
        raise ValueError("a frequency may not occur more than twice")
    if f[1] == 0.0 or f[-2] == 1.0:
        raise ValueError("freq may not repeat at 0 or fs/2")

    # Filter type (I-IV) constraints: odd symmetry forces zeros at the band
    # edges; even-tap symmetric filters force a zero at Nyquist.
    if antisymmetric:
        if g[0] != 0.0:
            raise ValueError("antisymmetric designs need zero gain at DC")
        if numtaps % 2 == 1 and g[-1] != 0.0:
            raise ValueError("odd-tap antisymmetric designs need zero gain at Nyquist")
    elif numtaps % 2 == 0 and g[-1] != 0.0:
        raise ValueError("even-tap symmetric designs need zero gain at Nyquist")

    if nfreqs is None:
        nfreqs = 1 + 2 ** int(np.ceil(np.log2(numtaps)))
    if nfreqs < numtaps:
        raise ValueError(f"nfreqs ({nfreqs}) must be >= numtaps ({numtaps})")

    # Nudge duplicated breakpoints apart so interpolation sees a step.
    eps = np.finfo(np.float64).eps * nfreqs
    fi = f.copy()
    for k in range(1, fi.size):
        if fi[k] <= fi[k - 1]:
            fi[k] = fi[k - 1] + eps
    grid = np.linspace(0.0, 1.0, nfreqs)
    mag = np.interp(grid, fi, g)

    # Linear-phase delay + odd symmetry phase, then inverse transform.
    shift = np.exp(-1j * np.pi * grid * (numtaps - 1) / 2.0)
    if antisymmetric:
        shift = shift * 1j  # odd-symmetry (type III/IV) phase convention
    h = np.fft.irfft(mag * shift, 2 * (nfreqs - 1))[:numtaps]
    h *= _symmetric_window(window, numtaps)
    return h


def fftfilt_device(x, h, device=None):
    """Causal FIR filtering of batched rows, on the tensor's device:
    ``y[k] = sum_j h[j] x[k-j]`` with the input's length
    (``scipy.signal.lfilter(h, [1], x)``), through :func:`oaconvolve_device`."""
    x = _as_tensor(x, device)
    return oaconvolve_device(x, h)[..., : x.shape[-1]]


def fftfilt(x, h, device=None):
    """Host-convenience causal FIR filter; see :func:`fftfilt_device`.

    >>> np.abs(fftfilt([1.0, 0.0, 0.0, 2.0], [1.0, 0.5], device="cpu")).round(5).tolist()
    [1.0, 0.5, 0.0, 2.0]
    """
    return fftfilt_device(np.asarray(x, dtype=np.float32), h, device=device).cpu().numpy()


def filtfilt_fir(x, h, padlen: int | None = None, device=None):
    """Zero-phase FIR filtering: forward pass, reverse, filter again, reverse
    (``scipy.signal.filtfilt(h, [1], x)`` with its default odd-reflection
    extension, ``padlen = 3*len(h)`` unless given).  The extended signal
    stays on the device between the passes."""
    xv = np.asarray(x, dtype=np.float32)
    hv = np.asarray(h, dtype=np.float32)
    if xv.ndim != 1 or hv.ndim != 1 or xv.size == 0 or hv.size == 0:
        raise ValueError("filtfilt_fir expects two non-empty 1-D signals")
    pad = 3 * hv.shape[0] if padlen is None else int(padlen)
    if pad >= xv.shape[0]:
        raise ValueError(f"padlen ({pad}) must be less than len(x) ({xv.shape[0]})")
    ext = _edge_extend(xv, pad)
    dev = resolve_device(device)
    ht = _upload(hv, dev)
    y = fftfilt_device(_upload(ext, dev), ht).flip(-1)
    y = fftfilt_device(y, ht).flip(-1).cpu().numpy()
    return y[pad : pad + xv.shape[0]].copy() if pad > 0 else y


def savgol_coeffs(
    window_length: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
    pos: float | None = None,
    use: str = "conv",
) -> np.ndarray:
    """Savitzky-Golay FIR coefficients (``scipy.signal.savgol_coeffs``).

    The least-squares polynomial-smoothing taps: fitting a degree-
    ``polyorder`` polynomial to each ``window_length`` window and reading
    the ``deriv``-th derivative at ``pos`` is a LINEAR map of the window,
    so it is one FIR filter — computed here from the Vandermonde
    pseudo-inverse in f64.
    """
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError(f"use must be 'conv' or 'dot', got {use!r}")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen if rem else halflen - 0.5
    if not 0 <= pos < window_length:
        raise ValueError("pos must be nonnegative and less than window_length")
    if deriv > polyorder:
        return np.zeros(window_length, dtype=np.float64)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    a = x**order
    y = np.zeros(polyorder + 1, dtype=np.float64)
    import math

    y[deriv] = float(math.factorial(deriv)) / (delta**deriv)
    coeffs, *_ = np.linalg.lstsq(a, y, rcond=None)
    return coeffs


def _savgol_fit_edge(x, start, stop, window_start, window_stop, polyorder, deriv, delta, y):
    """Polynomial edge fit of scipy's 'interp' mode: fit the first/last
    window in f64 and overwrite the affected output samples."""
    t = np.arange(stop - start, dtype=np.float64)
    rows = x[..., start:stop].reshape(-1, stop - start).T
    poly = np.polyfit(t, rows, polyorder)
    i = np.arange(window_start - start, window_stop - start, dtype=np.float64)
    vals = np.stack(
        [np.polyval(np.polyder(np.poly1d(poly[:, c]), deriv), i) for c in range(rows.shape[1])]
    )
    y[..., window_start:window_stop] = (vals / delta**deriv).reshape(
        x.shape[:-1] + (window_stop - window_start,)
    )


def savgol_filter(
    x,
    window_length: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
    axis: int = -1,
    mode: str = "interp",
    cval: float = 0.0,
    device=None,
) -> np.ndarray:
    """Savitzky-Golay smoothing/differentiation (``scipy.signal.savgol_filter``).

    The interior is one batched FIR convolution through
    :func:`oaconvolve_device` (every row in one batched transform);
    ``mode='interp'`` refits the two edge windows with the exact polynomial
    like scipy, the pad modes map to ``np.pad``.  ``window_length`` must be
    odd.
    """
    x = np.asarray(x, dtype=np.float64)
    if window_length % 2 != 1 or window_length < 1:
        raise ValueError("window_length must be a positive odd integer")
    if mode not in ("interp", "mirror", "nearest", "constant", "wrap"):
        raise ValueError(f"mode must be interp|mirror|nearest|constant|wrap, got {mode!r}")
    coeffs = savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    half = window_length // 2
    if mode == "interp":
        if window_length > n:
            raise ValueError("If mode is 'interp', window_length must be <= x.shape[axis]")
        padded = np.concatenate(
            [np.zeros(x.shape[:-1] + (half,)), x, np.zeros(x.shape[:-1] + (half,))], axis=-1
        )
    else:
        np_mode = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap", "constant": "constant"}[mode]
        pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
        kw = {"constant_values": cval} if mode == "constant" else {}
        padded = np.pad(x, pad, mode=np_mode, **kw)
    rows = padded.reshape(-1, padded.shape[-1]).astype(np.float32)
    # savgol_coeffs(use='conv') is built pre-flipped, so a plain convolution
    # applies the smoothing map.
    full = oaconvolve_device(rows, coeffs.astype(np.float32), device=device).cpu().numpy()
    y = full[:, 2 * half : 2 * half + n].reshape(x.shape).astype(np.float64)
    if mode == "interp" and n > window_length:
        _savgol_fit_edge(x, 0, window_length, 0, half, polyorder, deriv, delta, y)
        _savgol_fit_edge(x, n - window_length, n, n - half, n, polyorder, deriv, delta, y)
    elif mode == "interp":
        _savgol_fit_edge(x, 0, n, 0, n, polyorder, deriv, delta, y)
    return np.moveaxis(y, -1, axis)


def freqz(b, a=1.0, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi, device=None):
    """Frequency response of a rational (IIR) filter (``scipy.signal.freqz``
    for integer ``worN``): H(e^{jw}) = B(e^{jw}) / A(e^{jw}) on ``worN``
    points of the upper half circle (``whole=False``) or the full circle.
    Both polynomial evaluations are DFT bins of the exact transform.
    Returns ``(w, Hr, Hi)`` numpy arrays.
    """
    if int(worN) != worN or worN < 1:
        raise ValueError(f"worN must be a positive integer, got {worN!r}")
    n = int(worN)
    m = n if whole else 2 * n
    br, bi = _dtft_bins_device(b, n, m, device)
    av = np.atleast_1d(np.asarray(a, dtype=np.float64))
    w = np.arange(n) * (fs / m)
    if av.size == 1:
        return w, br / av[0], bi / av[0]
    ar, ai = _dtft_bins_device(av, n, m, device)
    den = ar * ar + ai * ai
    return w, (br * ar + bi * ai) / den, (bi * ar - br * ai) / den


def _fold_taps(tv: np.ndarray, m: int) -> np.ndarray:
    """A sequence longer than ``m`` folded mod m: at the m DFT bin
    frequencies e^{-jw(k+m)} = e^{-jwk}, so the wrap-sum samples its DTFT
    exactly."""
    if tv.shape[0] > m:
        pad_to = -(-tv.shape[0] // m) * m
        tv = np.pad(tv, (0, pad_to - tv.shape[0])).reshape(-1, m).sum(axis=0)
    return tv


def _dtft_bins_device(taps, n: int, m: int, device=None):
    """DTFT of a real coefficient sequence at the first ``n`` of the ``m``
    DFT bins, through the exact transform on ``device``."""
    from .exact import fft_exact_device

    tv = np.asarray(taps, dtype=np.float64).ravel()
    if tv.size == 0:
        raise ValueError("expected non-empty coefficient arrays")
    tv = _fold_taps(tv, m)
    padded = np.zeros(m, dtype=np.float32)
    padded[: tv.shape[0]] = tv.astype(np.float32)
    yr, yi = fft_exact_device(padded[None], device=device)
    return yr[0, :n].cpu().double().numpy(), yi[0, :n].cpu().double().numpy()


def group_delay(system, w: int = 512, whole: bool = False, fs: float = 2.0 * np.pi):
    """``scipy.signal.group_delay`` for integer ``w``: -dφ/dω of the
    rational response in samples, by the Shpak identity
    gd = Re[DTFT(k·c_k) / DTFT(c_k)] - (len(a) - 1) with c = b * reverse(a),
    on the same DFT-bin grid as :func:`freqz`.  Host f64 DTFTs, not the
    f32 device path: near a response null the quotient's denominator decays
    like the null's full multiplicity (e.g. (pi-w)^8 for a 4th-order
    Butterworth at Nyquist), far below f32 — design-time analysis is the
    one response surface that NEEDS the extra mantissa.  Bins where the
    response truly vanishes return 0, like scipy (which also warns).
    """
    b, a = map(lambda v: np.atleast_1d(np.asarray(v, dtype=np.float64)), system)
    if int(w) != w or w < 1:
        raise ValueError(f"w must be a positive integer, got {w!r}")
    n = int(w)
    m = n if whole else 2 * n
    c = np.convolve(b, a[::-1])
    cr = c * np.arange(c.size)

    num = np.fft.fft(_fold_taps(cr, m), m)[:n]
    den = np.fft.fft(_fold_taps(c, m), m)[:n]
    den2 = den.real * den.real + den.imag * den.imag
    bad = den2 < np.finfo(np.float64).tiny * 10.0
    quot = (num.real * den.real + num.imag * den.imag) / np.where(bad, 1.0, den2)
    gd = np.where(bad, 0.0, quot - (a.size - 1))
    return np.arange(n) * (fs / m), gd


def sosfreqz(sos, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi, device=None):
    """``scipy.signal.sosfreqz`` (split-complex): the cascade's response, the
    complex product of the sections' :func:`freqz` on one grid.  Returns
    ``(w, Hr, Hi)``."""
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (n_sections, 6), got {sos.shape}")
    h = None
    w = None
    for s in sos:
        w, hr, hi = freqz(s[:3], s[3:], worN=worN, whole=whole, fs=fs, device=device)
        hs = hr + 1j * hi
        h = hs if h is None else h * hs
    return w, h.real.copy(), h.imag.copy()


def minimum_phase(h, n_fft: int | None = None, *, half: bool = True) -> np.ndarray:
    """Minimum-phase FIR from a linear-phase prototype (homomorphic method,
    ``scipy.signal.minimum_phase`` semantics).

    The classic real-cepstrum construction (Oppenheim & Schafer §13):
    take log|H| on a dense grid, keep the causal part of the cepstrum
    (fold negative quefrencies onto positive), exponentiate back.  With
    ``half=True`` (default) the result has (len(h)+1)//2 taps and its
    magnitude approximates sqrt(|H|) — the "filter the signal twice" use;
    ``half=False`` keeps len(h) taps approximating |H| itself.  Design is
    host-side f64 math like :func:`firwin`.
    """
    if np.iscomplexobj(h):
        raise ValueError("minimum_phase expects real taps")
    hv = np.asarray(h, dtype=np.float64)
    if hv.ndim != 1 or hv.size < 2:
        raise ValueError("minimum_phase expects a 1-D filter with >= 2 taps")
    n = hv.size
    if n_fft is None:
        n_fft = 1 << int(np.ceil(np.log2(2 * (n - 1) / 0.01)))
    if n_fft < n:
        raise ValueError(f"n_fft ({n_fft}) must be >= len(h) ({n})")

    mag = np.abs(np.fft.fft(hv, n_fft))
    # Regularize spectral nulls before the log (standard homomorphic trick).
    mag += 1e-7 * mag[mag > 0].min()
    logmag = np.log(mag)
    if half:
        logmag *= 0.5
    cep = np.fft.ifft(logmag).real
    # Fold anti-causal quefrencies onto causal ones: minimum-phase cepstrum.
    win = np.zeros(n_fft)
    win[0] = 1.0
    win[1 : n_fft // 2] = 2.0
    if n_fft % 2:  # odd grid: boundary quefrency counted once (scipy quirk)
        win[n_fft // 2] = 1.0
    h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (n // 2) + (n % 2) if half else n
    return h_min[:n_out]


class FIRStream:
    """Stateful streaming FIR filter: a long or live signal chunk by chunk,
    with exact causal (``lfilter``) semantics across chunk boundaries.

    The kernel's spectrum at the chunk's padded transform length
    m = next_pow2(chunk + taps - 1) is computed once, on ``device``; each
    :meth:`step` pays one forward and one inverse transform of its chunk
    (at B = 1 and 1,024 <= m <= 16,384 both are one launch of the whole
    kernel) and carries the length-(taps - 1) convolution tail into the
    next chunk.  ``step`` is pure, state in and state out::

        stream = FIRStream(h, chunk=4096, batch=B, device="cuda")
        state = stream.init()
        for chunk in chunks:
            state, y = stream.step(state, chunk)

    Concatenated outputs equal ``fftfilt(concat(chunks), h)`` to f32
    rounding; ``batch`` rows stream independently (same taps).
    """

    def __init__(self, h, chunk: int = 4096, batch: int = 1, device=None):
        from ..kernels.large import transform_any

        h = np.asarray(h, dtype=np.float32)
        if h.ndim != 1 or h.size == 0:
            raise ValueError("FIRStream expects non-empty 1-D taps")
        if chunk < 1 or batch < 1:
            raise ValueError(f"chunk and batch must be >= 1, got {chunk}, {batch}")
        self.taps = int(h.size)
        self.chunk = int(chunk)
        self.batch = int(batch)
        self.device = resolve_device(device)
        self._m = max(2, next_power_of_two(self.chunk + self.taps - 1))
        hp = _upload(np.pad(h, (0, self._m - self.taps))[None], self.device)
        self._hr, self._hi = transform_any(hp, None, self._m, -1)

    def init(self):
        """Zero carry state: (batch, taps - 1) of pending convolution tail."""
        return torch.zeros((self.batch, max(self.taps - 1, 1)), dtype=torch.float32, device=self.device)

    def step(self, state, x):
        """One chunk in, one chunk out.  ``x``: (batch, chunk) (or (chunk,)
        when batch == 1).  Returns ``(new_state, y)``, ``y`` shaped like
        ``x``.  Out of place throughout, so autograd sees the step."""
        from ..kernels.large import inverse_real, transform_any

        x = _as_tensor(x, self.device)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        if tuple(x.shape) != (self.batch, self.chunk):
            raise ValueError(f"FIRStream.step expects ({self.batch}, {self.chunk}) chunks, got {tuple(x.shape)}")
        xr, xi = transform_any(F.pad(x, (0, self._m - self.chunk)), None, self._m, -1)
        cr, ci = _spectral_product(xr, xi, self._hr, self._hi)
        full = inverse_real(cr, ci, self._m, scale=1.0 / self._m)[:, : self.chunk + self.taps - 1]
        t = self.taps - 1
        y = full[:, : self.chunk]
        if t > 0:
            # The previous chunks' pending tail overlaps this chunk's head.
            m = min(t, self.chunk)
            y = torch.cat([y[:, :m] + state[:, :m], y[:, m:]], dim=1)
            carry = full[:, self.chunk :]
            if t > self.chunk:
                # Taps longer than the chunk: part of the old tail is still
                # pending beyond this chunk; shift it forward and add.
                carry = carry + F.pad(state[:, self.chunk :], (0, self.chunk))
            state = carry
        return state, (y[0] if squeeze else y)


def freqz_fir(h, n: int = 512, fs: float = 2.0 * np.pi, device=None):
    """Frequency response of an FIR filter at ``n`` points on [0, fs/2)
    (``scipy.signal.freqz(h, worN=n)``): the first n bins of a length-2n
    transform of the taps, folded mod 2n first when longer (time-domain
    aliasing samples the DTFT exactly).  Returns ``(w, Hr, Hi)``.
    """
    from .exact import fft_exact_device

    hv = np.asarray(h, dtype=np.float64)
    if hv.ndim != 1 or hv.size == 0:
        raise ValueError("freqz_fir expects non-empty 1-D taps")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    m = 2 * n
    hv = _fold_taps(hv, m)
    padded = np.zeros(m, dtype=np.float32)
    padded[: hv.shape[0]] = hv.astype(np.float32)
    yr, yi = fft_exact_device(padded[None], device=device)
    w = np.arange(n) * (fs / m)
    return w, yr[0, :n].cpu().numpy(), yi[0, :n].cpu().numpy()


def choose_conv_method(in1, in2, mode: str = "full", measure: bool = False, device=None):
    """Pick 'fft' or 'direct' (``scipy.signal.choose_conv_method``).  Without
    ``measure``, a size heuristic (direct pays off only for tiny operands);
    with ``measure``, both paths are timed on the actual 1-D inputs (the
    2-D transforms are not in the port yet)."""
    x = np.asarray(in1)
    k = np.asarray(in2)
    if measure:
        import timeit

        from .dsp import fft_convolve

        if x.ndim != 1:
            raise NotImplementedError("choose_conv_method(measure=True) times 1-D inputs only: "
                                      "the 2-D transforms (ops/fft2d) are not ported")
        times = {
            "direct": timeit.timeit(lambda: np.convolve(x.ravel(), k.ravel(), mode), number=3),
            "fft": timeit.timeit(lambda: fft_convolve(x, k, mode, device=device), number=3),
        }
        return ("fft" if times["fft"] <= times["direct"] else "direct"), times
    if min(x.size, k.size) <= 16 or x.size * k.size <= 4096:
        return "direct"
    return "fft"


def freqz_sos(sos, worN: int = 512, whole: bool = False, fs: float = 2.0 * np.pi, device=None):
    """:func:`sosfreqz` under scipy's >= 1.12 name, with scipy's complex
    return (``scipy.signal.freqz_sos``)."""
    w, hr, hi = sosfreqz(sos, worN=worN, whole=whole, fs=fs, device=device)
    return w, hr + 1j * hi


def firwin_2d(hsize, window, *, fc=None, fs: float = 2.0, circular: bool = False,
              pass_zero=True, scale: bool = True):
    """2-D window-method FIR (``scipy.signal.firwin_2d``): separable outer
    product of two 1-D firwin designs, or a circularly-symmetric filter by
    radial interpolation of an 8x-oversampled 1-D prototype."""
    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if circular:
        if fc is None:
            raise ValueError("fc must be provided when circular=True")
        n_r = max(hsize[0], hsize[1]) * 8
        win_r = firwin(n_r, fc, window=window, fs=fs)
        f1, f2 = np.meshgrid(np.linspace(-1, 1, hsize[0]), np.linspace(-1, 1, hsize[1]))
        r = np.sqrt(f1 ** 2 + f2 ** 2)
        return np.interp(r, np.linspace(0, 1, n_r), win_r)
    if len(window) != 2:
        raise ValueError("window must be a 2-element tuple or list")
    if fc is None:
        raise ValueError("fc must be provided")
    # scipy 1.17 does NOT forward pass_zero/scale in the separable branch
    # (each 1-D prototype is designed with firwin defaults) — mirrored here.
    del pass_zero, scale
    row = firwin(hsize[0], fc, window=window[0], fs=fs)
    col = firwin(hsize[1], fc, window=window[1], fs=fs)
    return np.outer(row, col)
