"""Extensions beyond the reference's surface: exact non-pow2 DFT, 2-D FFT,
the scipy namespaces, FFTLog, ShortTimeFFT and a serving artifact.

The reference library (and this library's ``fft``) zero-pads non-power-of-
two signals — which computes a padded-length spectrum whose bins sit at
different frequencies.  ``fft_exact`` computes the true spectrum at any
length; ``fft2`` transforms images/frames; the last step exports ``rfft``
to a ``torch.export`` artifact, loads it back and serves from it.

Run: python -m gpu_fft_tpu_torch.examples.extensions
"""

import os
import tempfile

import numpy as np

import gpu_fft_tpu_torch as gt


def main(device=None) -> int:
    # ── Exact non-pow2: a 60 Hz tone sampled at 48 kHz for 1 s ──────────────
    sr, f0, n = 48_000, 60.0, 48_000
    t = np.arange(n) / sr
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)

    re, im = gt.fft_exact(x, device=device)  # true 48,000-bin spectrum
    p = gt.psd(re, im)
    k = int(np.argmax(p[: n // 2 + 1]))
    print(f"fft_exact:  n={n}, dominant bin {k} = {k * sr / n:.2f} Hz (exact)")

    rep, imp = gt.fft(x, device=device)  # pads to 65,536: bins land OFF the tone
    pp = gt.psd(rep, imp)
    kp = int(np.argmax(pp[: len(rep) // 2 + 1]))
    print(
        f"fft (padded): n={len(rep)}, dominant bin {kp} = "
        f"{kp * sr / len(rep):.2f} Hz (padded-grid approximation)"
    )

    # ── 2-D: pick out a plane wave in an image ──────────────────────────────
    h, w = 128, 256
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.cos(2 * np.pi * (3 * yy / h + 17 * xx / w)).astype(np.float32)
    re2, im2 = gt.fft2(img, device=device)
    power = re2**2 + im2**2
    ky, kx = np.unravel_index(int(np.argmax(power)), power.shape)
    print(f"fft2: dominant 2-D bin (ky, kx) = ({ky}, {kx})  [expected (3, 17)]")

    # ── scipy.fft drop-in: same code, complex arrays, on the device ─────────
    import gpu_fft_tpu_torch.compat as cfft

    X = cfft.rfft(x[:4096], device=device)  # complex64 numpy out
    kc = int(np.argmax(np.abs(X)))
    print(f"compat.rfft: dominant bin {kc} = {kc * sr / 4096:.2f} Hz (complex API)")

    # ── scipy.signal drop-in: complex analytic signal ────────────────────────
    import gpu_fft_tpu_torch.signal as gsig

    env = np.abs(gsig.hilbert(np.sin(2 * np.pi * 5 * t[:2048]) * np.hanning(2048), device=device))
    print(f"signal.hilbert: envelope peak {env.max():.3f} at sample {int(np.argmax(env))}")

    # ── FFTLog: Hankel transform of exp(-r²/2)·r^1.5 on a log grid ──────────
    nlog, dln, mu = 256, 0.02, 0.5
    r = np.exp((np.arange(nlog) - (nlog - 1) / 2) * dln)
    a = (r**1.5 * np.exp(-r * r / 2)).astype(np.float32)
    off = gt.fhtoffset(dln, mu)
    A = gt.fht(a, dln, mu, offset=off, device=device)
    back = gt.ifht(A, dln, mu, offset=off, device=device)
    fht_err = float(np.abs(back - a).max())
    print(f"fht/ifht roundtrip (FFTLog, mu={mu}): max err {fht_err:.2e}")

    # ── ShortTimeFFT: scipy's modern sliding-window class ────────────────────
    sft = gt.ShortTimeFFT.from_window("hann", fs=sr, nperseg=256, noverlap=192, device=device)
    chirp = np.sin(2 * np.pi * (5 + 20 * t) * t).astype(np.float32)
    S = sft.stft(chirp)
    back_st = sft.istft(S, k1=len(chirp))
    st_err = float(np.abs(back_st - chirp).max())
    print(f"ShortTimeFFT: {S.shape[0]} bins x {S.shape[1]} slices, "
          f"istft max err {st_err:.2e}")

    # ── Mixed-radix exact length: true 48,000-bin spectrum, no padding ──────
    n48 = 48000
    t48 = np.arange(n48) / 48000.0
    a48 = np.sin(2 * np.pi * 440.0 * t48).astype(np.float32)
    r48, i48 = gt.fft_exact(a48, device=device)
    k440 = int(np.argmax(r48[: n48 // 2] ** 2 + i48[: n48 // 2] ** 2))
    print(f"fft_exact(48000): peak at bin {k440} = {k440 * 48000 / n48:.1f} Hz "
          f"(mixed-radix 200x240 four-step)")

    # ── Serving artifact: export once, run from the file ────────────────────
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rfft.pt2")
        nbytes = gt.save_transform(path, "rfft", batch=1, n=4096, device=device)
        art = gt.load_transform(path)
        ar, ai = gt.exported_call(art, x[None, :4096])
        ka = int(np.argmax(ar[0] ** 2 + ai[0] ** 2))
        print(f"serving artifact: {nbytes} bytes, peak bin {ka} "
              f"= {ka * sr / 4096:.2f} Hz (no retracing)")

    ok = ky in (3, h - 3) and kx in (17, w - 17)
    ok = ok and kc == round(f0 * 4096 / sr) and fht_err < 1e-4
    ok = ok and st_err < 1e-4 and k440 == 440 and ka == kc
    ok = ok and abs(k * sr / n - f0) < 0.5
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
