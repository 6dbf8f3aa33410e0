"""Soak: random (B, n) through the device API against an oracle on the device.

Counterpart of ``scripts/soak.py``.  The tests pin known boundaries; this
hammers RANDOM (B, n) configurations, memory-heavy batches included, each
held against ``torch.fft.fft`` in complex64 on the same device (no host
oracle), to catch launch-geometry and layout faults at shapes nobody picked
by hand; then identity checks on the analysis ops, which need no oracle.

* forward: max of |Re - Re X| and |Im - Im X| below 1e-4 of max|X| (both
  parts: real input has Re(conj X) = Re X, so a conjugation fault would
  pass a real-only gate);
* roundtrip ``ifft_device(fft_device(x))``: max|.| <= max(5 log2(n) eps, 1e-5);
* analysis identities (istft(stft), idct(dct) and idst(dst) of each type
  and norm, Re hilbert, resample up and down, overlap-add against the one
  transform, upfirdn against scipy, ifht(fht) (the bias capped to a
  condition number of 1e3, see ``_analysis_case``; a draw past the cap is
  also run as drawn and its error reported, not gated), ``compat`` ifft(fft) on
  either axis and norm, a separable 2-D convolution against two 1-D
  passes): 5e-3.

Runs on the card unless ``--device cpu``.  An exception counts as a
failure; the exit code is 1 if anything failed.

Usage: python -m gpu_fft_tpu_torch.scripts.soak [--iters N] [--seed S]
       [--max-bytes B] [--analysis-iters M] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

B_CHOICES = (1, 2, 3, 8, 24, 96, 256, 1024)
ANALYSIS_OPS = ("stft", "dct", "dst", "hilbert", "resample", "oaconvolve", "conv2d", "upfirdn", "fht", "compat")
GATE = 5e-3  # the analysis identities
FWD_GATE = 1e-4  # the forward transform, relative to max|X|


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _analysis_case(op: str, rng, dev) -> tuple[str, float, bool]:
    """One random configuration of ``op``: (description, error, passed)."""
    import gpu_fft_tpu_torch as gt

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    if op == "stft":
        frame = 1 << int(rng.integers(4, 10))
        hop = max(1, frame >> int(rng.integers(1, 3)))
        ln = frame * int(rng.integers(2, 30)) + int(rng.integers(0, frame))
        window = str(rng.choice(["hann", "hamming", "blackman", "rect"]))
        x = rng.uniform(-1, 1, ln).astype(np.float32)
        sr, si = gt.stft(x, frame, hop=hop, window=window, device=dev)
        y = _np(gt.istft(sr, si, hop=hop, window=window, length=ln, device=dev))
        num = (ln - frame) // hop + 1
        cov = (num - 1) * hop + frame
        w = gt.window_table(window, frame).astype(np.float64)
        wsq = np.zeros(cov)
        for m in range(num):
            wsq[m * hop : m * hop + frame] += w * w
        ok = wsq > 1e-6
        err = float(np.abs(y[:cov][ok] - x[:cov][ok]).max())
        return f"stft f={frame} h={hop} L={ln} w={window}", err, err < GATE
    if op in ("dct", "dst"):
        n = int(rng.integers(2, 20000))
        b = int(rng.choice([1, 3, 8]))
        type_ = int(rng.choice([1, 2, 3, 4]))
        norm = rng.choice([None, "ortho"])
        fn, ifn = (gt.dct_device, gt.idct_device) if op == "dct" else (gt.dst_device, gt.idst_device)
        x = on(rng.uniform(-1, 1, (b, n)))
        y = ifn(fn(x, type=type_, norm=norm), type=type_, norm=norm)
        err = float((y - x).abs().max())
        return f"{op}{type_} b={b} n={n} norm={norm}", err, err < GATE
    if op == "hilbert":
        n = int(rng.integers(2, 50000))
        b = int(rng.choice([1, 4]))
        x = on(rng.uniform(-1, 1, (b, n)))
        ar, _ = gt.hilbert_device(x)
        err = float((ar - x).abs().max())
        return f"hilbert b={b} n={n}", err, err < GATE
    if op == "resample":
        n = int(rng.integers(2, 20000))
        x = on(rng.uniform(-1, 1, (1, n)))
        y = gt.resample_device(gt.resample_device(x, 2 * n), n)
        err = float((y - x).abs().max())
        return f"resample n={n}<->{2 * n}", err, err < GATE
    if op == "oaconvolve":
        # The block path against the independent one-transform path.
        n = int(rng.integers(100, 150000))
        lh = int(rng.integers(2, 513))
        b = int(rng.choice([1, 4]))
        x = on(rng.uniform(-1, 1, (b, n)))
        h = on(rng.uniform(-1, 1, lh))
        ya, yb = gt.oaconvolve_device(x, h), gt.fft_convolve_device(x, h)
        err = float((ya - yb).abs().max()) / max(1.0, float(yb.abs().max()))
        return f"oaconvolve b={b} n={n} lh={lh}", err, err < GATE
    if op == "upfirdn":
        import scipy.signal

        n = int(rng.integers(16, 30000))
        lh = int(rng.integers(1, 129))
        up = int(rng.integers(1, 8))
        down = int(rng.integers(1, 8))
        x = rng.uniform(-1, 1, n).astype(np.float32)
        hh = rng.uniform(-1, 1, lh).astype(np.float32)
        ya = _np(gt.upfirdn(hh, x, up, down, device=dev))
        yb = scipy.signal.upfirdn(hh.astype(np.float64), x.astype(np.float64), up, down)
        err = float(np.abs(ya - yb).max()) / max(1.0, float(np.abs(yb).max())) if ya.shape == yb.shape else np.inf
        return f"upfirdn n={n} lh={lh} {up}/{down}", err, err < GATE
    if op == "fht":
        # FFTLog: ifht(fht(a)) == a at any length.
        n = int(rng.integers(4, 8192))
        dln = float(rng.uniform(0.005, 0.2))
        mu = float(rng.uniform(-0.9, 3.0))
        drawn = float(rng.choice([0.0, rng.uniform(-0.8, 0.8)]))
        # A bias q scales the input by r^-q and the output by k^-q, so the
        # roundtrip's condition number is exp(|q| (n - 1) dln): beyond ~1/eps
        # no precision meets the identity (scipy's float64 fht misses it by
        # 3 to 1e92 at draws the JAX script allows).  |q| is capped to keep
        # it <= 1e3; a draw past the cap is also run as drawn and its error
        # reported, not gated.
        cap = np.log(1e3) / ((n - 1) * dln)
        bias = float(np.clip(drawn, -cap, cap))
        # a = r^1.2 exp(-r^2 / 2) on r = exp(t), in the log domain: r^2
        # overflows float64 at the widest grids, where a is 0.
        t = (np.arange(n) - (n - 1) / 2) * dln
        with np.errstate(over="ignore"):
            a = np.exp(1.2 * t - 0.5 * np.exp(2.0 * t)).astype(np.float32)

        def roundtrip(q):
            off = gt.fhtoffset(dln, mu, bias=q)
            back = _np(gt.ifht_device(gt.fht_device(a, dln, mu, offset=off, bias=q, device=dev),
                                      dln, mu, offset=off, bias=q, device=dev))
            return float(np.abs(back - a).max()) / max(1e-3, float(np.abs(a).max()))

        err = roundtrip(bias)
        desc = f"fht n={n} dln={dln:.3f} mu={mu:.2f} q={bias:.2f}"
        if bias != drawn:
            try:
                with np.errstate(all="ignore"):
                    desc += f" (drawn q={drawn:.2f}: err {roundtrip(drawn):.1e}, not gated)"
            except Exception as e:  # reported with the draw, not counted
                desc += f" (drawn q={drawn:.2f}: {type(e).__name__}, not gated)"
        return desc, err, err < GATE
    if op == "compat":
        # The scipy.fft namespace: ifft(fft(x)) == x, any length, axis and norm.
        from gpu_fft_tpu_torch import compat as cfft

        n = int(rng.integers(2, 20000))
        b = int(rng.choice([1, 4]))
        norm = rng.choice([None, "ortho", "forward"])
        axis = int(rng.choice([0, 1]))
        x = on(rng.uniform(-1, 1, (b, n) if axis == 1 else (n, b)))
        y = cfft.ifft(cfft.fft(x, axis=axis, norm=norm), axis=axis, norm=norm)
        err = max(float((y.real - x).abs().max()), float(y.imag.abs().max()))
        return f"compat fft/ifft b={b} n={n} axis={axis} norm={norm}", err, err < GATE
    # conv2d: a separable kernel against two 1-D passes.
    hgt = int(rng.integers(8, 200))
    wid = int(rng.integers(8, 200))
    kh = int(rng.integers(2, 17))
    kw = int(rng.integers(2, 17))
    x = on(rng.uniform(-1, 1, (hgt, wid)))
    u = rng.uniform(-1, 1, kh).astype(np.float32)
    v = rng.uniform(-1, 1, kw).astype(np.float32)
    y2 = gt.fft_convolve2d_device(x, on(np.outer(u, v)))
    rows = gt.fft_convolve_device(x, on(v))  # (hgt, wid + kw - 1)
    cols = gt.fft_convolve_device(rows.T.contiguous(), on(u)).T
    err = float((y2 - cols).abs().max()) / max(1.0, float(cols.abs().max()))
    return f"conv2d {hgt}x{wid} k{kh}x{kw}", err, err < GATE


def analysis_soak(rng, iters: int, dev) -> tuple[int, int]:
    """``iters`` random analysis-op identity checks: (ran, failures)."""
    failures = 0
    for _ in range(iters):
        op = str(rng.choice(list(ANALYSIS_OPS)))
        try:
            desc, err, good = _analysis_case(op, rng, dev)
        except Exception as e:  # a crash is a failure, reported and counted
            print(f"{op}: EXCEPTION {type(e).__name__}: {str(e)[:120]}", flush=True)
            failures += 1
            continue
        print(f"{desc}: err {err:.1e} {'ok' if good else 'FAIL'}", flush=True)
        failures += 0 if good else 1
    return iters, failures


def transform_soak(rng, iters: int, max_bytes: int, dev) -> tuple[int, int]:
    """``iters`` random (B, n) forward and roundtrip checks: (ran, failures)."""
    import gpu_fft_tpu_torch as gt

    failures = 0
    ran = 0
    eps = float(np.finfo(np.float32).eps)
    while ran < iters:
        b = int(rng.choice(B_CHOICES))
        n = 1 << int(rng.integers(1, 21))
        # Peak footprint ~8x the input: the complex64 oracle (2x), two
        # split-complex result pairs (4x), the staged intermediates.
        if b * n * 4 * 8 > max_bytes:
            continue
        ran += 1
        xs = torch.from_numpy(rng.uniform(-1, 1, (b, n)).astype(np.float32)).to(dev)
        try:
            yr, yi = gt.fft_device(xs)
            rr, _ = gt.ifft_device(yr, yi)
            spec = torch.fft.fft(xs.to(torch.complex64))
            denom = float(spec.abs().max()) + 1e-9
            fwd = max(float((yr - spec.real).abs().max()), float((yi - spec.imag).abs().max())) / denom
            rt = float((rr - xs).abs().max())
            good = fwd < FWD_GATE and rt <= max(5.0 * np.log2(max(n, 2)) * eps, 1e-5)
        except Exception as e:  # a crash is a failure, reported and counted
            print(f"b={b:5d} n={n:8d}: EXCEPTION {type(e).__name__}: {str(e)[:120]}", flush=True)
            failures += 1
            continue
        print(f"b={b:5d} n={n:8d}: fwd {fwd:.1e} roundtrip {rt:.1e} {'ok' if good else 'FAIL'}", flush=True)
        failures += 0 if good else 1
        del xs, yr, yi, rr, spec
    return ran, failures


def run(iters: int = 20, seed: int = 0, max_bytes: int = 512 * 1024 * 1024, analysis_iters: int | None = None,
        device="cuda") -> tuple[int, int]:
    """Both soaks from one seeded generator: (checks run, failures)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("soak: no CUDA device (pass --device cpu to run on the CPU)")
    rng = np.random.default_rng(seed)
    ran, failures = transform_soak(rng, iters, max_bytes, dev)
    a_ran, a_fail = analysis_soak(rng, iters // 2 if analysis_iters is None else analysis_iters, dev)
    ran += a_ran
    failures += a_fail
    print(f"soak: {ran - failures}/{ran} ok on {dev}", flush=True)
    return ran, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-bytes", type=int, default=512 * 1024 * 1024)
    ap.add_argument("--analysis-iters", type=int, default=None,
                    help="analysis-op identity checks (default: iters // 2)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    _, failures = run(args.iters, args.seed, args.max_bytes, args.analysis_iters, args.device)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
