"""End-to-end signal-analysis tour.

A noisy amplitude-modulated tone is characterized with the library's
estimators: Welch PSD to find the carrier, coherence against a reference
channel, STFT -> ISTFT to denoise by spectral masking, the Hilbert envelope
to recover the modulation, Fourier resampling, and a DCT compression sketch.

Run: python -m gpu_fft_tpu_torch.examples.analysis
"""

import numpy as np

import gpu_fft_tpu_torch as gt


def main(device=None) -> int:
    fs = 1000.0
    t = np.arange(8192) / fs
    rng = np.random.default_rng(0)

    am = 1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)  # 3 Hz modulation
    clean = am * np.sin(2 * np.pi * 125.0 * t)  # 125 Hz carrier
    x = (clean + 0.8 * rng.standard_normal(t.size)).astype(np.float32)

    # 1. Welch PSD: find the carrier under the noise.
    f, p = gt.welch(x, fs=fs, nperseg=512, device=device)
    carrier = f[int(np.argmax(p))]
    print(f"Welch PSD peak: {carrier:.1f} Hz (expect 125.0)")

    # 2. Coherence against a second noisy copy of the same tone.
    y = (clean + 0.8 * rng.standard_normal(t.size)).astype(np.float32)
    fc, cxy = gt.coherence(x, y, fs=fs, nperseg=512, device=device)
    at_carrier = cxy[int(np.argmin(np.abs(fc - 125.0)))]
    off_band = cxy[int(np.argmin(np.abs(fc - 400.0)))]
    print(f"Coherence at 125 Hz: {at_carrier:.2f} (off-band {off_band:.2f})")

    # 3. STFT -> mask weak bins -> ISTFT: simple spectral denoising.
    sr, si = gt.stft(x, 512, hop=128, device=device)
    mag2 = sr * sr + si * si
    mask = (mag2 > 10.0 * np.median(mag2)).astype(np.float32)
    den = gt.istft(sr * mask, si * mask, hop=128, length=x.size, device=device)
    band = slice(512, -512)  # compare away from frame edges
    err_noisy = np.abs(x[band] - clean[band]).std()
    err_den = np.abs(den[band] - clean[band]).std()
    print(f"Spectral-mask denoise: residual std {err_noisy:.3f} -> {err_den:.3f}")

    # 4. Hilbert envelope recovers the 3 Hz modulation from the clean tone.
    env = gt.envelope(clean.astype(np.float32), device=device)
    err = np.abs(env[200:-200] - am[200:-200]).max()
    print(f"Hilbert envelope max error vs true AM: {err:.3f}")

    # 5. Fourier resampling: 8192 -> 4096 samples keeps the carrier in band.
    x_lo = gt.resample(x, 4096, device=device)
    f2, p2 = gt.welch(x_lo, fs=fs / 2, nperseg=512, device=device)
    peak_lo = f2[int(np.argmax(p2))]
    print(f"After 2x decimation, PSD peak: {peak_lo:.1f} Hz")

    # 6. DCT energy compaction: keep 10% of coefficients.
    c = gt.dct(clean.astype(np.float32), norm="ortho", device=device)
    k = c.size // 10
    keep = np.zeros_like(c)
    top = np.argsort(np.abs(c))[-k:]
    keep[top] = c[top]
    rec = gt.idct(keep, norm="ortho", device=device)
    snr = 10 * np.log10(np.sum(clean**2) / np.sum((clean - rec) ** 2))
    print(f"DCT 10% coefficients -> reconstruction SNR {snr:.1f} dB")

    ok = (
        abs(carrier - 125.0) < fs / 512
        and at_carrier > 0.5
        and err_den < err_noisy
        and err < 0.05
        and abs(peak_lo - 125.0) < (fs / 2) / 512
        and snr > 20.0
    )
    print("[OK]" if ok else "[FAIL]")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
