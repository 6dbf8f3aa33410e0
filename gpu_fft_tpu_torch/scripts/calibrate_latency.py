"""Measure the launch floors of the card.

Counterpart of ``scripts/calibrate_latency.py``.  Two floors:

* **chained**: the device time per step of ``x = step(x)`` replayed from a
  CUDA graph (``utils/profiling.chained_step_stats``), the host's launch
  cost cancelled: what the card itself spends per kernel.  This is the
  roofline's latency wall (``utils/roofline.py``).
* **unchained**: host wall time of one call followed by
  ``torch.cuda.synchronize()``, per call: what a caller that waits on each
  result pays.  Not a roofline term.

Probes, each timed both ways:

  scale_8x128, scale_256x1024   x * (1 + 2^-20), one torch elementwise kernel
  dot_128x128                   x @ w, one torch.matmul
  kernel_copy_8x128             S5, ``kernels/probes.copy_min``
  kernel_whole_n1024            K1 on ``get_whole_plan(1024, -1)``
  fft_n1024, fft_n4096          ``fft_forward_step`` through ``transform_any``

and a launch chain: steps of d = 1, 2, 4, 8 chained multiplies at (8, 128),
whose per-kernel time (step / d) tests the roofline's charge of one floor
per kernel.  ``nvidia-smi`` samples the SM clock every 100 ms while the
probes run; its median and range go into the results, beside the floor
they may move.  The run prints the ``CHIPS["h100"]`` launch field
(``kernel_call_us``, S5's chained step) and the roofline rows of the two
fft probes with their kernel counts (``roofline.compiled_stats``) and this
run's floor.

Usage: python -m gpu_fft_tpu_torch.scripts.calibrate_latency [--quick]
Writes ``chiprun_out/calibrate_latency_results.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ONE = 1.0 + 2.0**-20
CHAIN_DEPTHS = (1, 2, 4, 8)


def clock_summary(text: str) -> dict | None:
    """Median, least and largest SM clock (MHz) and the card's maximum from
    ``nvidia-smi --query-gpu=clocks.sm,clocks.max.sm`` lines; None if none."""
    rows = []
    for line in text.splitlines():
        try:
            sm, top = (float(v) for v in line.split(","))
        except ValueError:
            continue
        rows.append((sm, top))
    if not rows:
        return None
    sm = [r[0] for r in rows]
    return {"samples": len(sm), "median_mhz": float(np.median(sm)), "min_mhz": min(sm),
            "max_mhz": max(sm), "max_clock_mhz": rows[-1][1]}


class SmClocks:
    """Samples the card's SM clock with ``nvidia-smi`` every 100 ms while
    the ``with`` block runs; ``summary`` is :func:`clock_summary` of them
    (None off a CUDA card or where ``nvidia-smi`` is absent)."""

    def __init__(self, device: torch.device):
        self.cmd = None if device.type != "cuda" else [
            "nvidia-smi", f"--id={device.index or 0}", "--query-gpu=clocks.sm,clocks.max.sm",
            "--format=csv,noheader,nounits", "-lms", "100"]
        self.proc = None
        self.summary = None

    def __enter__(self):
        if self.cmd is None:
            return self
        try:
            self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except FileNotFoundError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                text, _ = self.proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                text, _ = self.proc.communicate()
            self.summary = clock_summary(text)
        return False


def unchained_us(fn, x, device, samples: int) -> dict:
    """Median and least host wall time of ``fn(x)`` then a synchronise, us."""
    fn(x)
    torch.cuda.synchronize(device)
    walls = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize(device)
        walls.append((time.perf_counter() - t0) * 1e6)
    return {"median": float(np.median(walls)), "min": float(np.min(walls))}


def main(quick: bool = False, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from ..config import apply_precision
    from ..kernels.fused import whole_transform
    from ..kernels.probes import copy_min
    from ..plan import get_whole_plan, on_device
    from ..utils import profiling, roofline

    apply_precision()
    dev = torch.device(device)
    timing = dict(k1=10, k2=110, reps=3, min_span_s=0.01) if quick else dict(
        k1=50, k2=1050, reps=5, retries=1)
    samples = 10 if quick else 30
    out: dict = {"device": torch.cuda.get_device_name(dev), "chip": roofline.detect_chip().name,
                 "quick": quick, "rows": {}}
    rows = out["rows"]

    def probe(name, step, x0):
        s = profiling.chained_step_stats(step, x0, **timing)
        rows[name] = {"per_call_us": s.median_s * 1e6, "iqr_us": s.iqr_s * 1e6,
                      "suspect": s.suspect, "unchained_us": unchained_us(step, x0, dev, samples)}
        print(f"[latency] {name}: {s.median_s * 1e6:.3f} us chained (iqr {s.iqr_s * 1e6:.3f}), "
              f"{rows[name]['unchained_us']['median']:.1f} us unchained", flush=True)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    steps = {n: profiling.fft_forward_step(n) for n in (1024, 4096)}
    chain_rows = {}
    with SmClocks(dev) as clocks:
        probe("scale_8x128", lambda x: x * ONE, ones(8, 128))
        probe("scale_256x1024", lambda x: x * ONE, ones(256, 1024))
        w = torch.eye(128, dtype=torch.float32, device=dev) * ONE
        probe("dot_128x128", lambda x: x @ w, ones(128, 128))
        probe("kernel_copy_8x128", copy_min, ones(8, 128))
        wp = on_device(get_whole_plan, 1024, -1, None, device=dev)
        probe("kernel_whole_n1024", lambda x: whole_transform(x, None, wp)[0], ones(1, 1024))
        for n, step in steps.items():
            probe(f"fft_n{n}", step, ones(1, n))
        for d in CHAIN_DEPTHS:

            def chain(x, d=d):
                for _ in range(d):
                    x = x * ONE
                return x

            chain_rows[d] = profiling.chained_step_stats(chain, ones(8, 128), **timing).median_s * 1e6
            print(f"[latency] chain: {d} kernels per step: {chain_rows[d]:.3f} us, "
                  f"{chain_rows[d] / d:.3f} us per kernel", flush=True)
    out["launch_chain"] = {str(d): {"per_step_us": v, "per_kernel_us": v / d} for d, v in chain_rows.items()}
    out["sm_clock"] = clocks.summary
    print(f"[latency] SM clock while probing: {clocks.summary}", flush=True)

    floor = min(r["per_call_us"] for k, r in rows.items() if k.startswith(("scale", "dot")))
    out["chained_floor_us"] = floor
    out["kernel_call_us"] = rows["kernel_copy_8x128"]["per_call_us"]
    out["unchained_dispatch_us"] = rows["scale_8x128"]["unchained_us"]

    # The fft probes against the roofline, with this run's launch floor.
    chip = dataclasses.replace(roofline.CHIPS["h100"], kernel_call_us=out["kernel_call_us"])
    out["roofline"] = {}
    for n, step in steps.items():
        stats = roofline.compiled_stats(step, ones(1, n))
        row = roofline.roofline_row(1, n, "fft", rows[f"fft_n{n}"]["per_call_us"] * 1e-6, chip=chip,
                                    n_kernels=stats["n_kernels"])
        out["roofline"][f"fft_n{n}"] = {**row, "kernel_names": stats["kernel_names"],
                                        "n_own_kernels": stats["n_own_kernels"]}
        print(f"[latency] fft_n{n}: {stats['n_kernels']} kernels ({stats['n_own_kernels']} own), "
              f"bound {row['sol_us']:.3f} us ({row['bound']}), {row['pct_sol']:.1f}% of it", flush=True)

    print(f"[latency] chained floor: {floor:.3f} us; S5 copy: {out['kernel_call_us']:.3f} us; "
          f"unchained dispatch: median {out['unchained_dispatch_us']['median']:.1f} us, "
          f"min {out['unchained_dispatch_us']['min']:.1f} us")
    print(f"# CHIPS['h100'] launch field: kernel_call_us={out['kernel_call_us']:.4f}")
    path = Path(out_dir) / "calibrate_latency_results.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer repetitions")
    main(quick=ap.parse_args().quick)
