"""Peak detection: ``find_peaks`` / ``peak_prominences`` / ``peak_widths``.

Port of ``gpu_fft_tpu/ops/peaks.py``: a copy of that pure-numpy module
(only this docstring differs).  The ``scipy.signal`` family with scipy's
semantics — plateau midpoints, the documented condition order
(plateau_size, height, threshold, distance, prominence, width),
interpolated width crossings — plus ``find_peaks_cwt`` and ``argrel*``.
Peak picking is a sequential, data-dependent scan over small host-side
outputs (a PSD, a spectrogram row), so it stays on the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["find_peaks", "peak_prominences", "peak_widths",
           "argrelextrema", "argrelmax", "argrelmin"]


def _local_maxima(x: np.ndarray):
    """Midpoints/edges of strict local maxima, plateaus allowed
    (scipy's ``_local_maxima_1d``): a maximum is a sample (or plateau of
    equal samples) strictly above both the sample before and after."""
    n = x.shape[0]
    mids, lefts, rights = [], [], []
    i = 1
    i_max = n - 1
    while i < i_max:
        if x[i - 1] < x[i]:
            ahead = i + 1
            while ahead < i_max and x[ahead] == x[i]:
                ahead += 1
            if x[ahead] < x[i]:
                left, right = i, ahead - 1
                mids.append((left + right) // 2)
                lefts.append(left)
                rights.append(right)
                i = ahead
                continue
        i += 1
    return (
        np.asarray(mids, dtype=np.intp),
        np.asarray(lefts, dtype=np.intp),
        np.asarray(rights, dtype=np.intp),
    )


def _unpack_interval(interval, n_peaks: int):
    """scipy's (min, max) condition unpacking: scalar/array min, optional max."""
    if isinstance(interval, (tuple, list)) and len(interval) == 2:
        lo, hi = interval
    else:
        lo, hi = interval, None
    lo = None if lo is None else np.broadcast_to(np.asarray(lo, dtype=np.float64), (n_peaks,))
    hi = None if hi is None else np.broadcast_to(np.asarray(hi, dtype=np.float64), (n_peaks,))
    return lo, hi


def _select_by_distance(peaks: np.ndarray, priority: np.ndarray, distance: float):
    """scipy's highest-priority-first distance suppression."""
    distance = int(np.ceil(distance))
    keep = np.ones(peaks.shape[0], dtype=bool)
    # Highest peaks claim their neighborhood first (ties: later index wins,
    # matching scipy's ascending-argsort traversal from the end).
    for j in np.argsort(priority)[::-1]:
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < distance:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < peaks.shape[0] and peaks[k] - peaks[j] < distance:
            keep[k] = False
            k += 1
    return keep


def peak_prominences(x, peaks, wlen: int | None = None):
    """Prominence of each peak (``scipy.signal.peak_prominences``).

    For each peak, descend left and right until a HIGHER sample or the
    window/signal border; the prominence is the peak height above the
    higher of the two interval minima.  Returns ``(prominences,
    left_bases, right_bases)``.
    """
    x = np.asarray(x, dtype=np.float64)
    peaks = np.asarray(peaks, dtype=np.intp)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    if peaks.size and (peaks.min() < 0 or peaks.max() >= x.shape[0]):
        raise ValueError("peak index out of range")
    if wlen is not None and wlen < 3:
        raise ValueError(f"wlen must be >= 3, got {wlen}")
    m = peaks.shape[0]
    prominences = np.empty(m, dtype=np.float64)
    left_bases = np.empty(m, dtype=np.intp)
    right_bases = np.empty(m, dtype=np.intp)
    for k, p in enumerate(peaks):
        i_min, i_max = 0, x.shape[0] - 1
        if wlen is not None:
            # Window of wlen samples centered on the peak (scipy rounds up).
            half = wlen // 2
            i_min = max(p - half, i_min)
            i_max = min(p + half, i_max)
        i = p
        left_min = x[p]
        left_bases[k] = p
        while i_min < i and x[i - 1] <= x[p]:
            i -= 1
            if x[i] < left_min:
                left_min = x[i]
                left_bases[k] = i
        i = p
        right_min = x[p]
        right_bases[k] = p
        while i < i_max and x[i + 1] <= x[p]:
            i += 1
            if x[i] < right_min:
                right_min = x[i]
                right_bases[k] = i
        prominences[k] = x[p] - max(left_min, right_min)
    return prominences, left_bases, right_bases


def peak_widths(x, peaks, rel_height: float = 0.5, prominence_data=None, wlen=None):
    """Width of each peak at ``rel_height`` of its prominence
    (``scipy.signal.peak_widths``): the horizontal distance between the
    linearly interpolated crossings of ``x[peak] - prominence*rel_height``
    on either side, searched down to the prominence bases.  Returns
    ``(widths, width_heights, left_ips, right_ips)``.
    """
    x = np.asarray(x, dtype=np.float64)
    peaks = np.asarray(peaks, dtype=np.intp)
    if rel_height < 0:
        raise ValueError(f"rel_height must be >= 0, got {rel_height}")
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen=wlen)
    prominences, left_bases, right_bases = prominence_data
    m = peaks.shape[0]
    widths = np.empty(m, dtype=np.float64)
    width_heights = np.empty(m, dtype=np.float64)
    left_ips = np.empty(m, dtype=np.float64)
    right_ips = np.empty(m, dtype=np.float64)
    for k, p in enumerate(peaks):
        height = x[p] - prominences[k] * rel_height
        width_heights[k] = height
        i = p
        while left_bases[k] < i and height < x[i]:
            i -= 1
        lip = float(i)
        if x[i] < height:
            lip += (height - x[i]) / (x[i + 1] - x[i])
        i = p
        while i < right_bases[k] and height < x[i]:
            i += 1
        rip = float(i)
        if x[i] < height:
            rip -= (height - x[i]) / (x[i - 1] - x[i])
        widths[k] = rip - lip
        left_ips[k] = lip
        right_ips[k] = rip
    return widths, width_heights, left_ips, right_ips


def find_peaks(
    x,
    height=None,
    threshold=None,
    distance=None,
    prominence=None,
    width=None,
    wlen=None,
    rel_height: float = 0.5,
    plateau_size=None,
):
    """Local maxima with scipy's condition system (``scipy.signal.find_peaks``).

    Conditions are evaluated in scipy's documented order — plateau_size,
    height, threshold, distance, prominence, width — so cheap filters
    shrink the peak set before the expensive ones, and ``distance``
    suppression sees exactly the peaks scipy's would.  Each condition is a
    scalar/array lower bound or a ``(min, max)`` interval.  Returns
    ``(peaks, properties)`` with scipy's property keys.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    if distance is not None and distance < 1:
        raise ValueError(f"distance must be >= 1, got {distance}")
    peaks, left_edges, right_edges = _local_maxima(x)
    props: dict[str, np.ndarray] = {}

    def filt(keep):
        nonlocal peaks
        peaks = peaks[keep]
        for key in props:
            props[key] = props[key][keep]

    if plateau_size is not None:
        plateau_sizes = right_edges - left_edges + 1
        props["plateau_sizes"] = plateau_sizes
        props["left_edges"] = left_edges
        props["right_edges"] = right_edges
        lo, hi = _unpack_interval(plateau_size, peaks.shape[0])
        keep = np.ones(peaks.shape[0], dtype=bool)
        if lo is not None:
            keep &= lo <= plateau_sizes
        if hi is not None:
            keep &= plateau_sizes <= hi
        filt(keep)
    if height is not None:
        peak_heights = x[peaks]
        props["peak_heights"] = peak_heights
        lo, hi = _unpack_interval(height, peaks.shape[0])
        keep = np.ones(peaks.shape[0], dtype=bool)
        if lo is not None:
            keep &= lo <= peak_heights
        if hi is not None:
            keep &= peak_heights <= hi
        filt(keep)
    if threshold is not None:
        left_t = x[peaks] - x[peaks - 1]
        right_t = x[peaks] - x[peaks + 1]
        props["left_thresholds"] = left_t
        props["right_thresholds"] = right_t
        lo, hi = _unpack_interval(threshold, peaks.shape[0])
        keep = np.ones(peaks.shape[0], dtype=bool)
        if lo is not None:
            keep &= lo <= np.minimum(left_t, right_t)
        if hi is not None:
            keep &= np.maximum(left_t, right_t) <= hi
        filt(keep)
    if distance is not None:
        filt(_select_by_distance(peaks, x[peaks], distance))
    if prominence is not None or width is not None:
        prominences, left_bases, right_bases = peak_prominences(x, peaks, wlen=wlen)
        props["prominences"] = prominences
        props["left_bases"] = left_bases
        props["right_bases"] = right_bases
    if prominence is not None:
        lo, hi = _unpack_interval(prominence, peaks.shape[0])
        keep = np.ones(peaks.shape[0], dtype=bool)
        if lo is not None:
            keep &= lo <= props["prominences"]
        if hi is not None:
            keep &= props["prominences"] <= hi
        filt(keep)
    if width is not None:
        widths, width_heights, left_ips, right_ips = peak_widths(
            x,
            peaks,
            rel_height,
            (props["prominences"], props["left_bases"], props["right_bases"]),
        )
        props["widths"] = widths
        props["width_heights"] = width_heights
        props["left_ips"] = left_ips
        props["right_ips"] = right_ips
        lo, hi = _unpack_interval(width, peaks.shape[0])
        keep = np.ones(peaks.shape[0], dtype=bool)
        if lo is not None:
            keep &= lo <= widths
        if hi is not None:
            keep &= widths <= hi
        filt(keep)
    return peaks, props


def argrelextrema(data, comparator, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Indices of relative extrema by comparator (``scipy.signal.argrelextrema``):
    points beating all neighbors within ``order`` steps on both sides."""
    data = np.asarray(data)
    if int(order) < 1:
        raise ValueError("order must be an int >= 1")
    locs = np.arange(data.shape[axis])
    keep = np.ones(data.shape, dtype=bool)
    main = data.take(locs, axis=axis, mode=mode)
    for shift in range(1, int(order) + 1):
        plus = data.take(locs + shift, axis=axis, mode=mode)
        minus = data.take(locs - shift, axis=axis, mode=mode)
        keep &= comparator(main, plus)
        keep &= comparator(main, minus)
        if ~keep.any():
            break
    return np.nonzero(keep)


def argrelmax(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative maxima indices (``scipy.signal.argrelmax``)."""
    return argrelextrema(data, np.greater, axis=axis, order=order, mode=mode)


def argrelmin(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative minima indices (``scipy.signal.argrelmin``)."""
    return argrelextrema(data, np.less, axis=axis, order=order, mode=mode)


def _ricker(points: int, a: float) -> np.ndarray:
    """Mexican-hat wavelet: (1 - (x/a)^2) exp(-x^2/(2a^2)), normalized."""
    amp = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    x = np.arange(points) - (points - 1.0) / 2.0
    xsq = (x / a) ** 2
    return amp * (1.0 - xsq) * np.exp(-xsq / 2.0)


def _cwt_ricker(vector: np.ndarray, widths, wavelet) -> np.ndarray:
    out = np.empty((len(widths), vector.size))
    for i, w in enumerate(widths):
        npts = int(min(10 * w, vector.size))
        out[i] = np.convolve(vector, wavelet(npts, w)[::-1], mode="same")
    return out


def _boolrelextrema_rows(matr: np.ndarray, order: int = 1) -> np.ndarray:
    locs = np.arange(matr.shape[1])
    keep = np.ones(matr.shape, dtype=bool)
    for shift in range(1, order + 1):
        plus = matr.take(locs + shift, axis=1, mode="clip")
        minus = matr.take(locs - shift, axis=1, mode="clip")
        keep &= matr > plus
        keep &= matr > minus
    return keep


def _identify_ridge_lines(matr, max_distances, gap_thresh):
    """Connect per-row CWT maxima into ridge lines (Du et al. 2006):
    walk from the widest scale down, attaching each new maximum to the
    nearest live line within max_distances of its row; a line dies after
    gap_thresh rows without a continuation."""
    all_max = _boolrelextrema_rows(matr)
    has_max = np.nonzero(all_max.any(axis=1))[0]
    if has_max.size == 0:
        return []
    start = has_max[-1]
    ridge = [[[start], [c], 0] for c in np.nonzero(all_max[start])[0]]
    final = []
    for row in range(start - 1, -1, -1):
        cols = np.nonzero(all_max[row])[0]
        for line in ridge:
            line[2] += 1
        prev = np.array([line[1][-1] for line in ridge])
        for col in cols:
            line = None
            if prev.size:
                d = np.abs(col - prev)
                j = int(np.argmin(d))
                if d[j] <= max_distances[row]:
                    line = ridge[j]
            if line is not None:
                line[0].append(row)
                line[1].append(col)
                line[2] = 0
            else:
                ridge.append([[row], [col], 0])
        prev = np.array([line[1][-1] for line in ridge])
        for line in list(ridge):
            if line[2] > gap_thresh:
                final.append(line)
                ridge.remove(line)
    # order each line by row ascending so [0] indexes the finest scale
    out = []
    for rows, cols, _ in ridge + final:
        order = np.argsort(rows)
        out.append([list(np.asarray(rows)[order]), list(np.asarray(cols)[order])])
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1,
                   noise_perc: float = 10, window_size=None):
    """Wavelet-ridge peak detection (``scipy.signal.find_peaks_cwt``):
    CWT at each width, connect maxima into ridge lines across scales,
    keep lines long enough and with sufficient SNR at the finest scale."""
    vector = np.asarray(vector, dtype=np.float64)
    widths = np.atleast_1d(np.asarray(widths, dtype=np.float64))
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    if wavelet is None:
        wavelet = _ricker
    cwt_mat = _cwt_ricker(vector, widths, wavelet)
    ridge_lines = _identify_ridge_lines(cwt_mat, max_distances, gap_thresh)
    if min_length is None:
        min_length = int(np.ceil(cwt_mat.shape[0] / 4.0))
    if window_size is None:
        window_size = int(np.ceil(cwt_mat.shape[1] / 20.0))
    window_size = int(window_size)
    hf, odd = divmod(window_size, 2)
    row_one = cwt_mat[0]  # raw (signed) values — scipy's noise floor is a
    npts = cwt_mat.shape[1]  # percentile of the windowed raw finest row

    def snr_ok(line):
        rows, cols = line[0], line[1]
        if len(rows) < min_length:
            return False
        col = cols[0]  # smallest-scale end of the ridge
        noise = np.percentile(row_one[max(col - hf, 0):min(col + hf + odd, npts)],
                              noise_perc)
        with np.errstate(divide="ignore", invalid="ignore"):
            snr = abs(cwt_mat[rows[0], col] / noise)
        return not snr < min_snr

    return np.sort(np.array([line[1][0] for line in ridge_lines if snr_ok(line)],
                            dtype=np.intp))
