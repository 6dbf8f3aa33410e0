"""FIR filtering tour: design, apply, verify — all through the FFT path.

A two-tone signal is cleaned with a window-method lowpass: ``kaiserord``
picks the tap count for a 60 dB spec, ``firwin`` designs the taps,
``freqz_fir`` verifies the response, ``filtfilt_fir`` applies it with zero
phase, and ``oaconvolve`` streams a long signal through the overlap-add
block path.  A 2-D Gaussian blur runs through ``fft_convolve2d_device``, an
IIR Butterworth through the block-state engine, and ``find_peaks`` picks
the surviving tone.

Run: python -m gpu_fft_tpu_torch.examples.filtering
"""

import numpy as np

import gpu_fft_tpu_torch as gt


def main(device=None) -> int:
    fs = 1000.0
    t = np.arange(8192) / fs
    rng = np.random.default_rng(0)
    ok = True

    lo = np.sin(2 * np.pi * 50.0 * t)  # wanted: 50 Hz
    hi = 0.8 * np.sin(2 * np.pi * 300.0 * t)  # unwanted: 300 Hz
    x = (lo + hi).astype(np.float32)

    # 1. Design: 60 dB stopband, 50 Hz transition band around 150 Hz.
    numtaps, beta = gt.kaiserord(60.0, width=50.0 / (fs / 2))
    h = gt.firwin(numtaps, 150.0, window=("kaiser", beta), fs=fs)
    print(f"Designed {numtaps}-tap Kaiser lowpass (beta {beta:.2f})")

    # 2. Verify the response: passband at 50 Hz, stopband at 300 Hz.
    w, hr, hi_ = gt.freqz_fir(h.astype(np.float32), n=512, fs=fs, device=device)
    mag = np.hypot(hr, hi_)
    g50 = mag[np.argmin(np.abs(w - 50.0))]
    g300 = mag[np.argmin(np.abs(w - 300.0))]
    db300 = 20 * np.log10(max(g300, 1e-12))
    print(f"Response: {g50:.3f}x at 50 Hz, {db300:.0f} dB at 300 Hz")
    ok &= abs(g50 - 1.0) < 0.01 and db300 < -58.0

    # 3. Apply with zero phase: the 300 Hz tone vanishes, 50 Hz unshifted.
    y = gt.filtfilt_fir(x, h.astype(np.float32), device=device)
    core = slice(numtaps, -numtaps)
    resid = float(np.abs(y[core] - lo[core]).max())
    print(f"filtfilt residual vs clean 50 Hz tone: {resid:.4f}")
    ok &= resid < 0.01

    # 4. Stream a LONG signal through the overlap-add block path.
    xl = rng.standard_normal(500_000).astype(np.float32)
    yl = gt.oaconvolve(xl, h.astype(np.float32), mode="same", device=device)
    start = (numtaps - 1) // 2  # 'same' centering offset
    ref = np.convolve(xl[:4096].astype(np.float64), h)[start : start + 2048]
    err = float(np.abs(yl[:2048] - ref).max())
    print(f"oaconvolve on 500k samples: same-mode err vs direct {err:.2e}")
    ok &= err < 1e-3

    # 5. Multirate: resample the filtered signal 1000 Hz -> 160 Hz.
    y160 = gt.resample_poly(y, 4, 25, device=device)
    print(f"resample_poly 1000 -> 160 Hz: {y.shape[0]} -> {y160.shape[0]} samples")
    ok &= y160.shape[0] == -(-y.shape[0] * 4 // 25)

    # 6. 2-D: Gaussian blur of an image batch.
    g = np.exp(-0.5 * ((np.arange(9) - 4.0) / 1.5) ** 2)
    kern = np.outer(g, g).astype(np.float32)
    kern /= kern.sum()
    img = rng.standard_normal((4, 128, 128)).astype(np.float32)
    blurred = gt.fft_convolve2d_device(img, kern, device=device).cpu().numpy()
    print(f"Blurred image batch: {img.shape} -> {blurred.shape}")
    ok &= blurred.shape == (4, 136, 136)
    ok &= float(blurred.std()) < float(img.std())  # smoothing reduces variance

    # 7. IIR: order-4 Butterworth through the block-state engine — the
    #    zero-phase filtfilt kills the 300 Hz tone like the FIR did, with
    #    9 coefficients instead of numtaps.
    bb, aa = gt.butter(4, 150.0, fs=fs)
    y_iir = gt.filtfilt(bb, aa, x, device=device)
    resid_iir = float(np.abs(y_iir[core] - lo[core]).max())
    print(f"IIR filtfilt residual vs clean 50 Hz tone: {resid_iir:.4f}")
    ok &= resid_iir < 0.02

    # 8. Streaming IIR: split-and-resume with zi/zf equals one shot.
    zi = gt.lfilter_zi(bb, aa) * x[0]
    y1, zf = gt.lfilter(bb, aa, x[:2000], zi=zi, device=device)
    y2, _ = gt.lfilter(bb, aa, x[2000:], zi=zf, device=device)
    whole, _ = gt.lfilter(bb, aa, x, zi=zi, device=device)
    split_err = float(np.abs(np.concatenate([y1, y2]) - whole).max())
    print(f"streaming lfilter split-and-resume err: {split_err:.2e}")
    ok &= split_err < 1e-4

    # 9. Peak picking on the filtered PSD: only the 50 Hz tone survives.
    f_w, p_w = gt.welch(y_iir, fs=fs, nperseg=1024, device=device)
    p_db = 10 * np.log10(np.maximum(p_w, 1e-20))
    # Suppressed tones still poke 20 dB above the (very quiet) stopband
    # floor, so gate on absolute height too: within 30 dB of the carrier.
    pk, props = gt.find_peaks(p_db, prominence=20.0, height=p_db.max() - 30.0)
    peak_hz = [round(float(f_w[i])) for i in pk]
    print(f"peaks within 30 dB of carrier after IIR lowpass: {peak_hz} Hz")
    ok &= peak_hz == [50]

    # 10. Savitzky-Golay: smooth the noisy tone without moving the phase.
    sm = gt.savgol_filter(x, 31, 3, device=device)
    print(f"savgol(31, 3) noise reduction: std {x.std():.3f} -> {sm.std():.3f}")
    ok &= float(sm.std()) < float(x.std())

    print("[OK]" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
