#!/usr/bin/env python3
"""Drive the PyTorch port (gpu_fft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device and build: a CUDA card, TF32 off, the kernels built from
   ``gpu_fft_tpu_torch/csrc`` with nvcc (build seconds printed);
2. every kernel against its plain torch version on the card, at the shapes
   the transform path gives it (gate: max|kernel - plain| <= 1e-5 max|plain|);
3. the main path through the public API on ``device="cuda"``: the sine ->
   fft -> psd -> dominant frequency -> ifft demo, fft/ifft from n = 1024 to
   2^22, fft_batch and ifft_batch, each checked against numpy in float64 with
   the 5*log2(N)*eps gate and against torch.fft; the launch counts show each
   kernel ran;
4. warm median times with CUDA events (back-to-back calls, host included)
   and device times from torch.profiler (the kernels alone): each kernel
   against its plain version and each main-path call against torch.fft.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5  # kernel vs plain, relative to max|plain|: both fp32, TF32 would be ~50x over
EPS32 = 1.1920929e-07


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gate(n: int) -> float:
    return 5.0 * (n.bit_length() - 1) * EPS32


def cuda_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Warm median over ``repeats`` of the mean time of ``iters`` calls (ms)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_ms(fn, iters: int = 20):
    """Device time per call (ms) summed over the CUDA kernels torch.profiler
    records for ``iters`` warm calls, and the top kernels by time; None where
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / iters / 1000.0
    if not by_name:
        return None, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), [(k[:60], v) for k, v in top]


def main() -> None:
    if not (ROOT / "gpu_fft_tpu_torch" / "__init__.py").is_file():
        fail(f"gpu_fft_tpu_torch not found beside {Path(__file__).name}; run from the repo root")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch import plan as P
    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels import _build
    from gpu_fft_tpu_torch.kernels import fused as K

    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report: dict = {"kernel_checks": [], "main_path": [], "times": []}

    # ── Phase 1: device and build ───────────────────────────────────────────
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print("phase 1: device")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    apply_precision()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")
    print("tf32: matmul off, cudnn off")
    info = _build.build()
    _build.library()
    print(f"build: {info.path.name} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  ptxas:", line.strip())
    report.update(card=smi, build_seconds=info.seconds, build_log=info.log)

    # ── Phase 2: each kernel against its plain version on the card ──────────
    print("phase 2: kernels vs plain torch (gate max|d| <= 1e-5 max|plain|)")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {"whole_transform": 0.0, "whole_transform_packed": 0.0, "stage_a": 0.0}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def compare(name, case, got, want):
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        ok = err <= TOL * scale
        max_err[name] = max(max_err[name], err)
        report["kernel_checks"].append(dict(kernel=name, case=case, max_abs_err=err, max_abs=scale, ok=ok))
        print(f"  {name:24s} {case:40s} max|d| {err:.3e} max|plain| {scale:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} {case}: kernel disagrees with its plain version")

    whole_cases = [("whole_transform_packed", 1024, 1)] + [
        ("whole_transform", n, b) for n in (2048, 4096, 16384) for b in (1, 3)
    ] + [("whole_transform", n, 1) for n in (32768, 65536)]  # beyond the gate: no n1 limit
    for name, n, b in whole_cases:
        kern = getattr(K, name)
        plain = getattr(K, name + "_plain")
        make_plan = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
        fwd = P.on_device(make_plan, n, -1, None, device=dev)
        inv = P.on_device(make_plan, n, 1, 1.0 / n, device=dev)
        xr, xi = randn(b, n), randn(b, n)
        compare(name, f"B={b} n={n} real fwd", kern(xr, None, fwd), plain(xr, None, fwd))
        compare(name, f"B={b} n={n} complex inv 1/n", kern(xr, xi, inv), plain(xr, xi, inv))
        torch.cuda.synchronize()

    for n in (1 << 17, 1 << 20, 1 << 24):
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        xr, xi = randn(1, n1, n2), randn(1, n1, n2)
        cases = [(f"n={n} real rows={rows}", xr, None, None, rows), (f"n={n} complex", xr, xi, None, None)]
        if n == 1 << 17:
            cases.append((f"n={n} complex col_tiles=1", xr, xi, 1, None))
        for case, a, b_, tiles, r in cases:
            got = K.stage_a(a, b_, n1, n2, plan, ct, col_tiles=tiles, rows=r)
            want = K.stage_a_plain(a, b_, n1, n2, plan, ct, col_tiles=tiles, rows=r)
            compare("stage_a", f"{case} ct={ct}", got, want)
        del xr, xi
        torch.cuda.synchronize()

    # ── Phase 3: the main path through the public API ───────────────────────
    print("phase 3: main path on device='cuda' (gate 5*log2(N)*eps)")
    K.reset_counts()
    rng = np.random.default_rng(0)

    def check(label, n, err, limit):
        report["main_path"].append(dict(case=label, n=n, err=err, limit=limit, ok=err <= limit))
        print(f"  {label:44s} err {err:.3e} limit {limit:.3e} {'ok' if err <= limit else 'FAIL'}")
        if not err <= limit:
            fail(f"{label}: error {err:.3e} over {limit:.3e}")

    def launches():
        return {k: c.launches for k, c in K.COUNTS.items()}

    # The reference demo: 15 Hz sine at 200 Hz for 5 s, padded 1000 -> 1024.
    wave = gt.generate_sine_wave(15.0, 200.0, 5.0)
    re, im = gt.fft(wave, device="cuda")
    n = len(re)
    p = gt.psd(re, im)
    freqs = gt.calculate_one_sided_frequencies(n, 200.0)
    dominant = gt.find_dominant_frequencies(p[: n // 2 + 1], freqs, threshold=100.0)
    print(f"  demo: {len(wave)} samples -> {n} bins; dominant {[(round(f, 2), round(w, 2)) for f, w in dominant]}")
    if len(dominant) != 1 or f"{dominant[0][0]:.2f}" != "15.04":
        fail(f"demo: dominant frequencies {dominant}, expected one at 15.04 Hz")
    back = gt.ifft(re, im, device="cuda")
    check("demo roundtrip n=1024", n, float(np.abs(back[: len(wave)] - wave).max()), gate(n))
    report["demo_dominant_hz"] = dominant[0][0]

    per_size = {}
    for n in (1024, 4096, 16384, 65536, 1 << 20, 1 << 22):
        before = launches()
        x = rng.standard_normal(n).astype(np.float32)
        re, im = gt.fft(x, device="cuda")
        ref = np.fft.fft(x.astype(np.float64))
        peak = float(np.abs(ref).max())
        check(f"fft n={n} vs numpy f64 (rel)", n,
              max(float(np.abs(re - ref.real).max()), float(np.abs(im - ref.imag).max())) / peak, gate(n))
        vr, vi = gt.fft(x, backend=gt.Backend.TORCH_FFT, device="cuda")
        check(f"fft n={n} vs torch.fft (rel)", n,
              max(float(np.abs(re - vr).max()), float(np.abs(im - vi).max())) / peak, gate(n))
        out = gt.ifft(re, im, device="cuda")
        check(f"ifft(fft) n={n} roundtrip", n, float(np.abs(out[:n] - x).max()), gate(n))
        vout = gt.ifft(re, im, backend=gt.Backend.TORCH_FFT, device="cuda")
        check(f"ifft n={n} vs torch.fft", n, float(np.abs(out - vout).max()), gate(n))
        after = launches()
        per_size[n] = {k: after[k] - before[k] for k in after}

    for b, n, inverse in ((16, 65536, False), (64, 4096, True)):
        xs = rng.standard_normal((b, n)).astype(np.float32)
        specs = gt.fft_batch(list(xs), device="cuda")
        ref = np.fft.fft(xs.astype(np.float64), axis=-1)
        peak = float(np.abs(ref).max())
        err = max(max(float(np.abs(r - ref[i].real).max()), float(np.abs(s - ref[i].imag).max()))
                  for i, (r, s) in enumerate(specs)) / peak
        check(f"fft_batch B={b} n={n} vs numpy f64 (rel)", n, err, gate(n))
        vs = gt.fft_batch(list(xs), backend=gt.Backend.TORCH_FFT, device="cuda")
        err = max(max(float(np.abs(r - vr).max()), float(np.abs(s - vi).max()))
                  for (r, s), (vr, vi) in zip(specs, vs)) / peak
        check(f"fft_batch B={b} n={n} vs torch.fft (rel)", n, err, gate(n))
        if inverse:
            outs = gt.ifft_batch(specs, device="cuda")
            check(f"ifft_batch B={b} n={n} roundtrip", n,
                  max(float(np.abs(o[:n] - x).max()) for o, x in zip(outs, xs)), gate(n))
            vouts = gt.ifft_batch(specs, backend=gt.Backend.TORCH_FFT, device="cuda")
            check(f"ifft_batch B={b} n={n} vs torch.fft", n,
                  max(float(np.abs(o - v).max()) for o, v in zip(outs, vouts)), gate(n))

    main_launches = launches()
    print(f"  launches in phase 3: {main_launches}")
    print(f"  launches per size: {per_size}")
    report["launches"] = main_launches
    report["launches_per_size"] = {str(k): v for k, v in per_size.items()}
    need = [("whole_transform_packed", 1024), ("whole_transform", 4096), ("whole_transform", 16384),
            ("stage_a", 1 << 20), ("stage_a", 1 << 22)]
    for name, n in need:
        if per_size[n][name] < 1:
            fail(f"{name} was not launched by the main path at n={n}")
    for name, count in main_launches.items():
        if count < 1:
            fail(f"{name} was launched no time on the main path")

    # ── Phase 4: warm median times (CUDA events) ────────────────────────────
    print(f"phase 4: warm medians, CUDA events ({smi})")
    kernel_ms = {}

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    def time_pair(label, name, kern_fn, plain_fn):
        k_ms, p_ms = cuda_ms(kern_fn), cuda_ms(plain_fn)
        (k_dev, _), (p_dev, _) = device_ms(kern_fn), device_ms(plain_fn)
        report["times"].append(dict(what=label, kernel=name, ms=k_ms, plain_ms=p_ms,
                                    device_ms=k_dev, plain_device_ms=p_dev))
        print(f"  {label:40s} events: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms | "
              f"device: kernel {fmt(k_dev)} plain {fmt(p_dev)}")
        return k_ms, p_ms

    for name, n in (("whole_transform_packed", 1024), ("whole_transform", 4096), ("whole_transform", 16384)):
        make_plan = P.get_whole_packed_plan if name == "whole_transform_packed" else P.get_whole_plan
        fwd = P.on_device(make_plan, n, -1, None, device=dev)
        x = randn(1, n)
        kern, plain = getattr(K, name), getattr(K, name + "_plain")
        res = time_pair(f"{name} B=1 n={n} real fwd", name,
                        lambda: kern(x, None, fwd), lambda: plain(x, None, fwd))
        kernel_ms.setdefault(name, res)
    for n in (1 << 20, 1 << 22):
        plan = P.on_device(P.get_stage_a_plan, n, -1, P.stage_a_ct_full_range(n), device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        rows = P.stage_a_real_rows(n1)
        x = randn(1, n1, n2)
        res = time_pair(f"stage_a n={n} real rows={rows}", "stage_a",
                        lambda: K.stage_a(x, None, n1, n2, plan, ct, rows=rows),
                        lambda: K.stage_a_plain(x, None, n1, n2, plan, ct, rows=rows))
        kernel_ms.setdefault("stage_a", res)

    for b, n in ((1, 1024), (1, 4096), (1, 16384), (1, 65536), (1, 1 << 20), (1, 1 << 22),
                 (16, 65536), (64, 4096)):
        x = randn(b, n)
        yr, yi = gt.fft_device(x)
        fwd = cuda_ms(lambda: gt.fft_device(x))
        vfwd = cuda_ms(lambda: gt.fft_device(x, backend=gt.Backend.TORCH_FFT))
        inv = cuda_ms(lambda: gt.ifft_device(yr, yi))
        vinv = cuda_ms(lambda: gt.ifft_device(yr, yi, backend=gt.Backend.TORCH_FFT))
        fdev, ftop = device_ms(lambda: gt.fft_device(x))
        idev, itop = device_ms(lambda: gt.ifft_device(yr, yi))
        vfdev, _ = device_ms(lambda: gt.fft_device(x, backend=gt.Backend.TORCH_FFT))
        report["times"].append(dict(what=f"fft_device B={b} n={n}", ms=fwd, torch_fft_ms=vfwd,
                                    device_ms=fdev, torch_fft_device_ms=vfdev, top_kernels=ftop))
        report["times"].append(dict(what=f"ifft_device B={b} n={n}", ms=inv, torch_fft_ms=vinv,
                                    device_ms=idev, top_kernels=itop))
        print(f"  fft_device  B={b:<3d} n={n:<8d} events: port {fwd:.4f} ms torch.fft {vfwd:.4f} ms | "
              f"device: port {fmt(fdev)} torch.fft {fmt(vfdev)}")
        print(f"  ifft_device B={b:<3d} n={n:<8d} events: port {inv:.4f} ms torch.fft {vinv:.4f} ms | "
              f"device: port {fmt(idev)}")
        print(f"    fft top kernels: {[(k, round(v, 4)) for k, v in ftop]}")

    sources = {
        "whole_transform_packed": ("gpu_fft_tpu_torch/csrc/whole_transform.cu", "gpu_fft_tpu/kernels/fused.py:383"),
        "whole_transform": ("gpu_fft_tpu_torch/csrc/whole_transform.cu", "gpu_fft_tpu/kernels/fused.py:424"),
        "stage_a": ("gpu_fft_tpu_torch/csrc/stage_a.cu", "gpu_fft_tpu/kernels/fused.py:188"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=main_launches[name],
             max_abs_err=max_err[name], ms=kernel_ms[name][0], plain_ms=kernel_ms[name][1])
        for name, (src, rep) in sources.items()
    ]
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
