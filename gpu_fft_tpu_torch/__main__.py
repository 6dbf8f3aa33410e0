"""Command-line interface: ``python -m gpu_fft_tpu_torch <command>``.

Port of ``gpu_fft_tpu/__main__.py``.  The reference ships example binaries
(``examples/simple.rs``, ``examples/backends.rs``); this CLI exposes the
same workloads plus a quick benchmark, so the library is driveable without
writing code.  Every command but ``plan`` runs on ``--device`` (default:
the card).

Commands:
  demo       the end-to-end sine -> FFT -> PSD -> peak -> IFFT workload
  backends   enumerate available backends and roundtrip through each
  bench      quick on-device benchmark of one (batch, n) configuration
  plan       explain how a (batch, n) transform will dispatch (no device)
  export     export one transform to a serialized serving artifact
  serve-check  load an artifact, run it, and print what it returns
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_demo(args) -> int:
    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch.utils import (
        calculate_one_sided_frequencies,
        find_dominant_frequencies,
        generate_sine_wave,
    )

    wave = generate_sine_wave(15.0, 200.0, 5.0)
    print(f"Generated {len(wave)} samples of a 15 Hz sine wave")
    re, im = gt.fft(wave, device=args.device)
    p = gt.psd(re, im)
    n = len(re)
    freqs = calculate_one_sided_frequencies(n, 200.0)
    for f, power in find_dominant_frequencies(p[: n // 2 + 1], freqs, 100.0):
        print(f"Dominant frequency: {f:.2f} Hz (power {power:.2f})")
    out = gt.ifft(re, im, device=args.device)
    err = float(np.abs(out[: len(wave)] - wave).max())
    limit = 5.0 * np.log2(n) * float(np.finfo(np.float32).eps)
    print(f"Roundtrip max error {err:.3e} vs limit {limit:.3e} "
          f"[{'OK' if err <= limit else 'FAIL'}]")
    return 0 if err <= limit else 1


def cmd_backends(args) -> int:
    import gpu_fft_tpu_torch as gt

    x = np.array([0.0, 1.0, 2.0, 3.0, 2.0, 1.0, 0.0, -1.0], dtype=np.float32)
    print("Available backends:", [b.name for b in gt.available_backends()])
    for backend in gt.available_backends():
        re, im = gt.fft_with(x, backend, device=args.device)
        out = gt.ifft_with(re, im, backend, device=args.device)
        err = float(np.abs(out[: len(x)] - x).max())
        print(f"{backend.name:9s} roundtrip max error: {err:.3e}")
    return 0


def cmd_bench(args) -> int:
    import torch

    from gpu_fft_tpu_torch.config import resolve_device
    from gpu_fft_tpu_torch.kernels.large import transform_any
    from gpu_fft_tpu_torch.utils.profiling import benchmark

    b, n = args.batch, args.n
    if n & (n - 1) or n < 2:
        print(f"n must be a power of two >= 2, got {n}", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        print(f"bench times on a CUDA card, not on {dev}", file=sys.stderr)
        return 2
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((b, n)).astype(np.float32)).to(dev)
    s = float(np.float32(1.0 / np.sqrt(n)))
    r = benchmark(lambda xx: transform_any(xx, None, n, -1)[0] * s, x, elements=b * n)
    print(f"fft B={b} n={n} on {dev}: {r.microseconds:.2f} us/transform, {r.melem_per_s:.0f} Melem/s")
    return 0


def cmd_plan(args) -> int:
    from gpu_fft_tpu_torch.plan import describe_plan

    try:
        info = describe_plan(args.n, batch=args.batch)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    width = max(len(k) for k in info)
    for k, v in info.items():
        print(f"{k:{width}s}  {v}")
    return 0


def cmd_export(args) -> int:
    from gpu_fft_tpu_torch.utils.serving import save_transform

    size = save_transform(args.output, args.kind, args.batch, args.n, device=args.device)
    print(f"exported {args.kind} (batch={args.batch}, n={args.n}) "
          f"-> {args.output} ({size} bytes)")
    return 0


def cmd_serve_check(args) -> int:
    from gpu_fft_tpu_torch.utils.serving import exported_call, input_specs, load_transform

    exported = load_transform(args.artifact)
    specs = input_specs(exported)
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal(shape).astype(np.float32) for shape, _ in specs]
    out = exported_call(exported, *inputs)
    flat = out if isinstance(out, (tuple, list)) else (out,)
    print(f"artifact: {len(specs)} input(s) "
          f"{[shape for shape, _ in specs]} -> {len(flat)} output(s), "
          f"device={specs[0][1] if specs else None}")
    print("first output head:", np.asarray(flat[0]).ravel()[:4])
    return 0


def main(argv=None) -> int:
    from gpu_fft_tpu_torch.utils.serving import EXPORT_KINDS

    parser = argparse.ArgumentParser(prog="gpu_fft_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, **kw):
        p = sub.add_parser(name, **kw)
        p.add_argument("--device", default=None,
                       help="torch device to run on (default: GPU_FFT_TPU_TORCH_DEVICE, else cuda)")
        return p

    command("demo", help="end-to-end signal-processing demo")
    command("backends", help="enumerate + roundtrip every backend")
    pb = command("bench", help="quick on-device benchmark")
    pb.add_argument("--batch", type=int, default=1)
    pb.add_argument("-n", type=int, default=65536)
    pp = sub.add_parser("plan", help="dispatch introspection (pure arithmetic)")
    pp.add_argument("--batch", type=int, default=1)
    pp.add_argument("-n", type=int, default=65536)
    pe = command("export", help="export one transform to an artifact")
    pe.add_argument("--kind", default="fft", choices=EXPORT_KINDS)
    pe.add_argument("--batch", type=int, default=1)
    pe.add_argument("-n", type=int, default=65536)
    pe.add_argument("-o", "--output", required=True)
    ps = sub.add_parser("serve-check", help="load + run an exported artifact (on the device it was exported for)")
    ps.add_argument("artifact")
    args = parser.parse_args(argv)
    return {
        "demo": cmd_demo,
        "backends": cmd_backends,
        "bench": cmd_bench,
        "plan": cmd_plan,
        "export": cmd_export,
        "serve-check": cmd_serve_check,
    }[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
