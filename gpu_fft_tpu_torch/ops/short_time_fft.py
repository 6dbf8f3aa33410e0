"""ShortTimeFFT: scipy.signal's modern sliding-window FFT class on the
port's transforms (``gpu_fft_tpu/ops/short_time_fft.py``).

API parity with ``scipy.signal.ShortTimeFFT`` (the class that supersedes the
legacy ``stft``/``istft`` functions): centred sliding windows with signal
border padding, canonical dual-window synthesis, four fft_modes, magnitude /
psd scaling, integer phase shifts, and the index geometry
(p_min/p_max/k_min/k_max/t/f/extent/borders).

The border padding is numpy's on the host (``np.pad``: zeros, edge, even,
odd); the framing is an unfold view on the device, and every slice rides ONE
batched transform (a power-of-two mfft takes ``transform_any``, any other
the exact mixed-radix / Bluestein path); synthesis takes the one-sided
real-output dispatch for the onesided modes and the overlap-add of
:mod:`.stft`.  Arrays in and out are numpy (complex64 spectra: an fp32
library; scipy returns complex128); the work runs on ``device`` (a
constructor keyword, default ``"cuda"`` or ``GPU_FFT_TPU_TORCH_DEVICE``).

Divergences from scipy (as in the JAX package):
  * f32/complex64 precision throughout.
  * ``dual_win`` must be canonical (computed here); passing an arbitrary
    precomputed dual is not supported.
"""

from __future__ import annotations

from math import ceil, floor

import numpy as np
import torch

from ..config import MAX_N, resolve_device

__all__ = ["ShortTimeFFT"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")


def _canonical_dual(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual window: win / (sliding sum of |win|^2 at stride hop).

    WOLA theory: synthesis with the canonical dual makes
    sum_p dual[k - p*hop] * win[k - p*hop] == 1 at every covered sample, so
    istft(stft(x)) == x exactly.  Raises if the window power coverage has a
    hole (the frame family is not a frame of the signal space).
    """
    w2 = (win * win).astype(np.float64)
    cover = w2.copy()
    off = hop
    while off < win.shape[0]:
        cover[off:] += w2[: -off]
        cover[: -off] += w2[off:]
        off += hop
    # cover[k] is the per-residue power sum_j w2[k + j*hop]; invertibility
    # needs every residue class mod hop covered, which also rules out
    # hop > m_num (inter-slice gaps no window ever touches).
    if hop > win.shape[0] or np.any(cover < 1e-10):
        raise ValueError(
            "short-time Fourier transform not invertible: the hop leaves "
            "window-power holes (sum_p win[k - p*hop]^2 ~ 0 at some sample)"
        )
    return win / cover


class ShortTimeFFT:
    """Drop-in ``scipy.signal.ShortTimeFFT`` over the port's transforms.

    >>> import numpy as np
    >>> from gpu_fft_tpu_torch.ops.short_time_fft import ShortTimeFFT
    >>> sft = ShortTimeFFT.from_window("hann", fs=8.0, nperseg=8, noverlap=4, device="cpu")
    >>> x = np.cos(2 * np.pi * np.arange(32) / 8).astype(np.float32)
    >>> S = sft.stft(x)
    >>> S.shape == (sft.f_pts, sft.p_num(32))
    True
    >>> bool(np.abs(sft.istft(S, k1=32) - x).max() < 1e-5)
    True
    """

    def __init__(
        self,
        win,
        hop: int,
        fs: float,
        *,
        fft_mode: str = "onesided",
        mfft: int | None = None,
        dual_win=None,
        scale_to: str | None = None,
        phase_shift: int | None = 0,
        device=None,
    ):
        self._device = resolve_device(device)
        win = np.asarray(win, dtype=np.float64)
        if win.ndim != 1 or win.shape[0] < 1:
            raise ValueError(f"win must be a non-empty 1-D array, got shape {win.shape}")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must be finite")
        if not (isinstance(hop, (int, np.integer)) and hop >= 1):
            raise ValueError(f"hop must be an integer >= 1, got {hop!r}")
        if not fs > 0:
            raise ValueError(f"fs must be positive, got {fs}")
        self._win = win
        self._hop = int(hop)
        self._fs = float(fs)
        self._mfft = int(mfft) if mfft is not None else win.shape[0]
        if self._mfft < win.shape[0]:
            raise ValueError(f"mfft ({self._mfft}) must be >= len(win) ({win.shape[0]})")
        if dual_win is not None:
            # scipy accepts any dual; this implementation only supports the
            # canonical one it computes itself (documented divergence).
            dual_win = np.asarray(dual_win, dtype=np.float64)
            if not np.allclose(dual_win, _canonical_dual(win, self._hop), atol=1e-9):
                raise ValueError("only the canonical dual window is supported")
        self._dual_win: np.ndarray | None = (
            None if dual_win is None else np.asarray(dual_win, dtype=np.float64)
        )
        self._scaling: str | None = None
        if scale_to is not None:
            self.scale_to(scale_to)  # validates; before fft_mode ('onesided2X'
            # requires a scaling, and scipy accepts both in one constructor)
        self.fft_mode = fft_mode  # property setter validates
        self.phase_shift = phase_shift  # property setter validates

    # ── Alternative constructors ─────────────────────────────────────────────

    @classmethod
    def from_window(
        cls,
        win_param,
        fs: float,
        nperseg: int,
        noverlap: int,
        *,
        symmetric_win: bool = False,
        fft_mode: str = "onesided",
        mfft: int | None = None,
        scale_to: str | None = None,
        phase_shift: int | None = 0,
        device=None,
    ):
        """Instantiate from a scipy window name/tuple (``get_window`` style)."""
        from .stft import _symmetric_table, window_table

        if not 0 <= noverlap < nperseg:
            raise ValueError(f"noverlap must be in [0, nperseg), got {noverlap}")
        if symmetric_win:
            w = _symmetric_table(
                win_param if isinstance(win_param, tuple) else win_param, nperseg
            )
        else:
            w = window_table(win_param, nperseg).astype(np.float64)
        return cls(
            w, hop=nperseg - noverlap, fs=fs, fft_mode=fft_mode, mfft=mfft,
            scale_to=scale_to, phase_shift=phase_shift, device=device,
        )

    @classmethod
    def from_dual(cls, dual_win, hop: int, fs: float, **kwargs):
        """Instantiate with ``dual_win`` as the SYNTHESIS window: the analysis
        window is its canonical dual (duality is an involution for canonical
        pairs)."""
        dual_win = np.asarray(dual_win, dtype=np.float64)
        return cls(_canonical_dual(dual_win, hop), hop, fs, **kwargs)

    @classmethod
    def from_win_equals_dual(cls, desired_win, hop: int, fs: float, **kwargs):
        """Instantiate with analysis == synthesis window: w / sqrt(coverage),
        the unique self-dual window with the shape of ``desired_win``."""
        desired_win = np.asarray(desired_win, dtype=np.float64)
        w2 = desired_win * desired_win
        cover = w2.copy()
        off = hop
        while off < desired_win.shape[0]:
            cover[off:] += w2[:-off]
            cover[:-off] += w2[off:]
            off += hop
        if np.any((cover < 1e-10) & (np.abs(desired_win) > 0)):
            raise ValueError("window-power coverage has holes; not invertible")
        w = np.where(cover > 1e-10, desired_win / np.sqrt(np.where(cover > 1e-10, cover, 1.0)), 0.0)
        return cls(w, hop, fs, **kwargs)

    # ── Basic attributes and geometry ────────────────────────────────────────

    @property
    def win(self) -> np.ndarray:
        return self._win

    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _canonical_dual(self._win, self._hop)
        return self._dual_win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @fs.setter
    def fs(self, v: float):
        if not v > 0:
            raise ValueError(f"fs must be positive, got {v}")
        self._fs = float(v)

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @T.setter
    def T(self, v: float):
        if not v > 0:
            raise ValueError(f"T must be positive, got {v}")
        self._fs = 1.0 / float(v)

    @property
    def m_num(self) -> int:
        return self._win.shape[0]

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def mfft(self) -> int:
        return self._mfft

    @mfft.setter
    def mfft(self, v: int):
        if v < self.m_num:
            raise ValueError(f"mfft ({v}) must be >= len(win) ({self.m_num})")
        self._mfft = int(v)

    @property
    def fft_mode(self) -> str:
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, v: str):
        if v not in _FFT_MODES:
            raise ValueError(f"fft_mode must be one of {_FFT_MODES}, got {v!r}")
        if v == "onesided2X" and getattr(self, "_scaling", None) is None:
            raise ValueError("fft_mode 'onesided2X' requires scale_to('magnitude'|'psd')")
        self._fft_mode = v

    @property
    def onesided_fft(self) -> bool:
        return self._fft_mode in ("onesided", "onesided2X")

    @property
    def phase_shift(self) -> int | None:
        return self._phase_shift

    @phase_shift.setter
    def phase_shift(self, v: int | None):
        if v is not None:
            if not isinstance(v, (int, np.integer)):
                raise ValueError(f"phase_shift must be an integer or None, got {v!r}")
            if not -self._mfft <= v < self._mfft:
                raise ValueError(f"phase_shift must be in [-mfft, mfft), got {v}")
        self._phase_shift = None if v is None else int(v)

    @property
    def scaling(self) -> str | None:
        return self._scaling

    @property
    def fac_magnitude(self) -> float:
        """Factor normalizing the STFT to a magnitude spectrum (1/sum(win))."""
        return 1.0 / abs(np.sum(self._win))

    @property
    def fac_psd(self) -> float:
        """Factor normalizing the STFT to a PSD amplitude (1/sqrt(fs*||win||^2))."""
        return 1.0 / np.sqrt(self._fs * np.sum(self._win * self._win))

    def scale_to(self, scaling: str):
        """Rescale the window (and dual) in place so stft values are
        'magnitude' or 'psd' calibrated — scipy semantics (idempotent)."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError(f"scaling must be 'magnitude' or 'psd', got {scaling!r}")
        if self._scaling == scaling:
            return
        fac = self.fac_magnitude if scaling == "magnitude" else self.fac_psd
        self._win = self._win * fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / fac
        self._scaling = scaling

    # slice geometry: slice p covers samples [p*hop - m_num_mid, ... + m_num)

    @property
    def p_min(self) -> int:
        """Smallest slice index with any sample inside the signal."""
        return floor((self.m_num_mid - self.m_num) / self._hop) + 1

    def p_max(self, n: int) -> int:
        """First slice index whose window starts at or past sample n."""
        return floor((n + self.m_num_mid - 1) / self._hop) + 1

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @property
    def k_min(self) -> int:
        return self.p_min * self._hop - self.m_num_mid

    def k_max(self, n: int) -> int:
        return (self.p_max(n) - 1) * self._hop - self.m_num_mid + self.m_num

    def p_range(self, n: int, p0: int | None = None, p1: int | None = None):
        """Validated (p0, p1) slice range, defaulting to the full range."""
        p_max = self.p_max(n)
        p0 = self.p_min if p0 is None else p0
        p1 = p_max if p1 is None else p1
        if not self.p_min <= p0 < p1 <= p_max:
            raise ValueError(
                f"invalid slice range [{p0}, {p1}): must satisfy "
                f"{self.p_min} <= p0 < p1 <= {p_max} for n={n}"
            )
        return p0, p1

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        """Nearest sample on the slice grid (multiples of hop)."""
        p = k // self._hop if left else -(-k // self._hop)
        return p * self._hop

    @property
    def delta_t(self) -> float:
        return self._hop * self.T

    def t(self, n: int, p0: int | None = None, p1: int | None = None,
          k_offset: int = 0) -> np.ndarray:
        """Slice times: (p*hop + k_offset) / fs for p in [p0, p1)."""
        p0, p1 = self.p_range(n, p0, p1)
        return (np.arange(p0, p1) * self._hop + k_offset) / self._fs

    @property
    def delta_f(self) -> float:
        return 1.0 / (self._mfft * self.T)

    @property
    def f_pts(self) -> int:
        return self._mfft // 2 + 1 if self.onesided_fft else self._mfft

    @property
    def f(self) -> np.ndarray:
        """Frequencies of the spectral rows (mode-dependent ordering)."""
        if self.onesided_fft:
            return np.arange(self._mfft // 2 + 1) * self.delta_f
        freqs = np.fft.fftfreq(self._mfft, d=1.0 / self._fs)
        return np.fft.fftshift(freqs) if self._fft_mode == "centered" else freqs

    @property
    def invertible(self) -> bool:
        try:
            self.dual_win
            return True
        except ValueError:
            return False

    @property
    def lower_border_end(self) -> tuple[int, int]:
        """(sample, slice) where pre-padding effects end: the end of the last
        slice whose nonzero window samples stick out left of the signal."""
        nz = np.flatnonzero(np.abs(self._win) > 0)
        m0 = int(nz[0]) if nz.size else 0
        if m0 - self.m_num_mid > self._hop:  # p=0 already clear of the border
            return (0, max(self.p_min, 0))
        # last p >= 0 whose successor's first nonzero-weight sample
        # ((p+1)*hop - mid + m0) is still inside the signal; effects end at
        # that slice's last covered sample.
        p_last = max(0, ceil((self.m_num_mid - m0) / self._hop) - 1)
        return (p_last * self._hop - self.m_num_mid + m0 + self.m_num, p_last + 1)

    def upper_border_begin(self, n: int) -> tuple[int, int]:
        """(sample, slice) where post-padding effects begin: the start of the
        first slice whose nonzero window samples stick out past sample n."""
        if n < self.m_num - self.m_num_mid:
            raise ValueError(f"n must be >= ceil(m_num/2) = {self.m_num - self.m_num_mid}")
        nz = np.flatnonzero(np.abs(self._win) > 0)
        m1 = (int(nz[-1]) + 1) if nz.size else self.m_num
        # slice p's nonzero samples end at p*hop - mid + m1 > n
        p_ub = floor((n - m1 + self.m_num_mid) / self._hop) + 1
        k_ub = p_ub * self._hop - self.m_num_mid
        return (max(k_ub, 0), max(p_ub, 0))

    def extent(self, n: int, axes_seq: str = "tf", center_bins: bool = False):
        """imshow-style (x0, x1, y0, y1) plot extent for an n-sample stft."""
        if axes_seq not in ("tf", "ft"):
            raise ValueError(f"axes_seq must be 'tf' or 'ft', got {axes_seq!r}")
        if self._fft_mode == "twosided":
            raise ValueError("extent not defined for unshifted 'twosided' spectra")
        if self.onesided_fft:
            q0, q1 = 0, self.f_pts
        else:  # centered
            q0, q1 = -(self._mfft // 2), (self._mfft - 1) // 2 + 1
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t_ext = ((p0 - 0.5) * self.delta_t, (p1 - 0.5) * self.delta_t)
            f_ext = ((q0 - 0.5) * self.delta_f, (q1 - 0.5) * self.delta_f)
        else:
            t_ext = (p0 * self.delta_t, p1 * self.delta_t)
            f_ext = (q0 * self.delta_f, q1 * self.delta_f)
        return t_ext + f_ext if axes_seq == "tf" else f_ext + t_ext

    # ── Transforms ───────────────────────────────────────────────────────────

    def _phase_factor(self):
        """Per-bin factor exp(2j*pi*q*(phase_shift - m_num_mid)/mfft), or None.

        phase_shift p_s rolls each windowed segment by p_s - m_num_mid
        samples before the FFT; as a spectral factor the roll costs one
        O(bins) multiply instead of a relayout.
        """
        if self._phase_shift is None:
            return None
        # scipy rolls the mfft-padded windowed segment LEFT by
        # (phase_shift + m_num_mid) % m_num samples; as a spectral factor
        # that roll is exp(+2j*pi*q*s/mfft) per bin.
        s = (self._phase_shift + self.m_num_mid) % self.m_num
        if s % self._mfft == 0:
            return None
        q = np.arange(self.f_pts if self.onesided_fft else self._mfft)
        ang = 2.0 * np.pi * ((q * s) % self._mfft) / self._mfft
        return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)

    def _frames(self, rows: np.ndarray, p0: int, p1: int, k_offset: int, padding: str):
        """(rows, num_slices, m_num) frames of (rows, n) signals on the
        device: border padding by ``np.pad`` on the host, then an unfold."""
        from .stft import frame_signal

        if padding not in ("zeros", "edge", "even", "odd"):
            raise ValueError(f"padding must be zeros|edge|even|odd, got {padding!r}")
        n = rows.shape[-1]
        num = p1 - p0
        start = p0 * self._hop - self.m_num_mid + k_offset
        left = max(0, -start)
        right = max(0, start + (num - 1) * self._hop + self.m_num - n)
        if left or right:
            pad = ((0, 0), (left, right))
            if padding == "zeros":
                rows = np.pad(rows, pad)
            elif padding == "edge":
                rows = np.pad(rows, pad, mode="edge")
            elif padding == "even":
                rows = np.pad(rows, pad, mode="reflect")
            else:  # odd: point-reflect about the edge values
                rows = np.pad(rows, pad, mode="reflect", reflect_type="odd")
        off = start + left  # >= 0: left-padding absorbs any negative start
        need = (num - 1) * self._hop + self.m_num
        xt = torch.from_numpy(np.ascontiguousarray(rows[:, off : off + need], dtype=np.float32))
        return frame_signal(xt.to(self._device), self.m_num, self._hop, num)

    def _forward(self, fr, fi):
        """Batched length-mfft transform of windowed frames (fi may be None)."""
        from ..kernels.large import transform_any
        from .exact import fft_exact_device

        m = self._mfft
        if m >= 2 and m & (m - 1) == 0 and m <= MAX_N:
            return transform_any(fr, fi, m, -1)
        return fft_exact_device(fr, fi)

    def stft(self, x, p0: int | None = None, p1: int | None = None, *,
             k_offset: int = 0, padding: str = "zeros", axis: int = -1):
        """Complex (..., f_pts, p1 - p0) spectrogram matrix — scipy
        ``ShortTimeFFT.stft`` semantics (centered slices, border padding)."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset,
                                 padding=padding, axis=axis)

    def stft_detrend(self, x, detr, p0: int | None = None, p1: int | None = None,
                     *, k_offset: int = 0, padding: str = "zeros", axis: int = -1):
        """stft with per-slice detrending: 'constant', 'linear', a callable
        applied to the (num, m_num) frame matrix, or None."""
        import torch.nn.functional as F

        from .spectral import _detrend_rows

        x = np.asarray(x)
        complex_input = np.iscomplexobj(x)
        if complex_input and self.onesided_fft:
            raise ValueError(f"complex input requires fft_mode 'twosided' or "
                             f"'centered', not {self._fft_mode!r}")
        if x.ndim < 1 or x.shape[axis] < self.m_num - self.m_num_mid:
            raise ValueError(f"signal too short for one slice along axis {axis}")
        if axis not in (-1, x.ndim - 1):
            x = np.moveaxis(x, axis, -1)
        lead = x.shape[:-1]
        n = x.shape[-1]
        p0, p1 = self.p_range(n, p0, p1)
        rows = x.reshape((-1, n))
        num = p1 - p0

        def frames_of(part):
            # Every row's frames ride ONE batched (rows*num, mfft) transform.
            return self._frames(part.astype(np.float32), p0, p1, k_offset, padding).reshape(
                -1, self.m_num)

        fr = frames_of(rows.real)
        fi = frames_of(rows.imag) if complex_input else None
        if detr is not None:
            if callable(detr):
                def host(f):
                    out = np.asarray(detr(f.cpu().numpy()), dtype=np.float32)
                    return torch.from_numpy(out).to(self._device)

                fr = host(fr)
                fi = None if fi is None else host(fi)
            else:
                fr = _detrend_rows(fr, detr)
                fi = None if fi is None else _detrend_rows(fi, detr)
        w = torch.from_numpy(self._win.astype(np.float32)).to(self._device)
        fr = fr * w
        fi = None if fi is None else fi * w
        if self._mfft > self.m_num:
            pad = (0, self._mfft - self.m_num)
            fr = F.pad(fr, pad)
            fi = None if fi is None else F.pad(fi, pad)
        else:
            fr = fr.contiguous()
            fi = None if fi is None else fi.contiguous()
        yr, yi = self._forward(fr, fi)
        zr = yr.cpu().numpy().reshape(lead + (num, self._mfft))
        zi = yi.cpu().numpy().reshape(lead + (num, self._mfft))
        S = (zr + 1j * zi).astype(np.complex64)
        if self.onesided_fft:
            S = S[..., : self.f_pts]
        fac = self._phase_factor()
        if fac is not None:
            S = S * fac
        if self._fft_mode == "onesided2X":
            mult = np.ones(self.f_pts, np.float32)
            two = np.sqrt(2.0) if self._scaling == "psd" else 2.0
            mult[1:] = two
            if self._mfft % 2 == 0:
                mult[-1] = 1.0
            S = S * mult
        elif self._fft_mode == "centered":
            S = np.fft.fftshift(S, axes=-1)
        return np.swapaxes(S, -1, -2)  # (..., f_pts, slices)

    def spectrogram(self, x, y=None, detr=None, *, p0: int | None = None,
                    p1: int | None = None, k_offset: int = 0,
                    padding: str = "zeros", axis: int = -1):
        """|stft|^2 (or the cross-spectrogram stft(x) * conj(stft(y)))."""
        Sx = self.stft_detrend(x, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        if y is None:
            return (Sx.real * Sx.real + Sx.imag * Sx.imag).astype(np.float32)
        Sy = self.stft_detrend(y, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        return Sx * np.conj(Sy)

    def istft(self, S, k0: int = 0, k1: int | None = None, *,
              f_axis: int = -2, t_axis: int = -1):
        """Inverse STFT over sample range [k0, k1) — dual-window overlap-add.

        ``S``: the direct output of :meth:`stft` (slices assumed to start at
        p_min).  Exact reconstruction (to f32) of the samples every analysis
        window covered, scipy semantics.
        """
        from ..kernels.large import inverse_real_half, transform_any
        from .exact import ifft_exact_device
        from .stft import overlap_add

        S = np.asarray(S)
        if S.ndim < 2:
            raise ValueError(f"S must have >= 2 axes (f, t), got shape {S.shape}")
        S = np.moveaxis(S, (f_axis, t_axis), (-2, -1))
        if S.shape[-2] != self.f_pts:
            raise ValueError(f"S has {S.shape[-2]} frequency rows, expected {self.f_pts}")
        if S.ndim > 2:
            lead = S.shape[:-2]
            rows = [self.istft(s, k0, k1) for s in S.reshape((-1,) + S.shape[-2:])]
            return np.stack(rows).reshape(lead + rows[0].shape)
        num = S.shape[-1]
        q_max = self.p_min + num
        k_max = (q_max - 1) * self._hop + self.m_num - self.m_num_mid
        k1 = k_max if k1 is None else k1
        if not (self.k_min <= k0 < k1 <= k_max):
            raise ValueError(f"invalid sample range [{k0}, {k1}): must satisfy "
                             f"{self.k_min} <= k0 < k1 <= {k_max}")
        Z = np.swapaxes(S, -1, -2).astype(np.complex64)  # (slices, bins)
        if self._fft_mode == "centered":
            Z = np.fft.ifftshift(Z, axes=-1)
        elif self._fft_mode == "onesided2X":
            mult = np.ones(self.f_pts, np.float32)
            two = np.sqrt(2.0) if self._scaling == "psd" else 2.0
            mult[1:] = two
            if self._mfft % 2 == 0:
                mult[-1] = 1.0
            Z = Z / mult
        fac = self._phase_factor()
        if fac is not None:
            Z = Z * np.conj(fac)
        m = self._mfft
        zr = torch.from_numpy(np.ascontiguousarray(Z.real)).to(self._device)
        zi = torch.from_numpy(np.ascontiguousarray(Z.imag)).to(self._device)
        pow2 = m >= 2 and m & (m - 1) == 0 and m <= MAX_N
        if self.onesided_fft:
            frames = (inverse_real_half(zr, zi, m, scale=1.0 / m) if pow2
                      else _exact_irfft(zr, zi, m))
            fi = None
        else:
            if pow2:
                fr, fi = transform_any(zr, zi, m, +1, scale=1.0 / m)
            else:
                fr, fi = ifft_exact_device(zr, zi)
            frames = fr
        dual = torch.from_numpy(self.dual_win.astype(np.float32)).to(self._device)
        span = (num - 1) * self._hop + self.m_num
        acc_r = overlap_add(frames[:, : self.m_num] * dual, self._hop, span)
        out = acc_r.cpu().numpy()
        if fi is not None:
            acc_i = overlap_add(fi[:, : self.m_num] * dual, self._hop, span)
            out = out + 1j * acc_i.cpu().numpy()
        lo = k0 - self.k_min
        return out[lo : lo + (k1 - k0)]


def _exact_irfft(zr, zi, m: int):
    """Real-output inverse at a non-pow2 mfft: Hermitian reconstruction +
    exact inverse (mixed-radix or Bluestein), real part."""
    from .exact import ifft_exact_device

    h = m // 2 + 1
    zi = zi.clone()
    zi[..., 0] = 0.0
    if m % 2 == 0:
        zi[..., h - 1] = 0.0
    tail = slice(1, h - 1) if m % 2 == 0 else slice(1, h)
    full_r = torch.cat([zr, torch.flip(zr[..., tail], (-1,))], dim=-1)
    full_i = torch.cat([zi, -torch.flip(zi[..., tail], (-1,))], dim=-1)
    yr, _ = ifft_exact_device(full_r, full_i)
    return yr
