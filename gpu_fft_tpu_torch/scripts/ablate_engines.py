"""Engine ablation: the left-matmul fused four-step as a CUDA kernel against
the torch four-step engines.

Counterpart of ``scripts/ablate_engines.py``.  Measured, interleaved in one
process (all variants per configuration per round), each step
x -> re(FFT(x)) / sqrt(n) through one variant:

  jnp         the port's transpose-form four-step, ``fused_fft`` on
              ``get_fused_plan(n, -1)`` (torch contractions)
  jnp_lm      the left-matmul form in torch, S1's plain version
              ``kernels/engines.fused_fft_lm_plain``: stage 1 contracts the
              major digit, one transpose at the end
  pallas_lm   S1, the same left-matmul four-step as ONE CUDA kernel
              (``kernels/engines.fused_fft_lm``, ``csrc/fused_lm.cu``)

and the ``pallas`` variant and ``rfft_pallas`` rows, whose kernels the JAX
package retired (its script cannot be imported for that reason), recorded
as ``{"error": "retired in the JAX package"}``.  The rfft rows time the
real-input ``real_jnp`` and ``real_jnp_lm`` engines at n = 32,768 and 65,536.
``accuracy`` rows hold each variant's error at n = 65,536 against numpy
float64, relative to max|X|.

Usage: python -m gpu_fft_tpu_torch.scripts.ablate_engines [--quick] [--rounds N]
Writes ``chiprun_out/ablate_engines_results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

RETIRED = "retired in the JAX package"
CONFIGS = ((1, 4096), (1, 16384), (1, 65536), (16, 4096), (16, 65536), (64, 4096))
QUICK_CONFIGS = ((1, 65536), (16, 65536))
ACCURACY_N = 65536
RFFT_SIZES = (32768, 65536, 131072)


def unexpected_errors(results: dict) -> list:
    """Entries holding an error other than the retired kernels' rows."""
    return [e for e in results["entries"] if "error" in e and e["error"] != RETIRED]


def accuracy_failures(results: dict) -> list:
    """Accuracy rows above 5 * log2(n) * eps (or not a number)."""
    limit = 5 * np.log2(ACCURACY_N) * float(np.finfo(np.float32).eps)
    return [e for e in results["entries"]
            if e["group"] == "accuracy" and "error" not in e and not e["rel_err"] <= limit]


def main(quick: bool = False, rounds: int = 2, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from ..config import apply_precision
    from ..kernels.engines import fused_fft_lm, fused_fft_lm_plain, lm_tables
    from ..kernels.fused_torch import fused_fft
    from ..plan import get_fused_plan, on_device
    from ..utils import profiling

    apply_precision()
    dev = torch.device(device)
    rng = np.random.default_rng(11)
    timing = dict(k1=3, k2=13, reps=2, min_span_s=0.01) if quick else dict(
        k1=10, k2=110, reps=3, min_span_s=0.05)
    results: dict = {"device": torch.cuda.get_device_name(dev), "quick": quick, "entries": []}
    entries = results["entries"]

    def jnp(n):
        plan = on_device(get_fused_plan, n, -1, False, None, device=dev)
        return lambda x: fused_fft(x, None, plan)

    def lm(fn):
        def make(n):
            t = on_device(lm_tables, n, -1, device=dev)
            return lambda x: fn(x, t)

        return make

    variants = {"jnp": jnp, "jnp_lm": lm(fused_fft_lm_plain), "pallas": None,
                "pallas_lm": lm(fused_fft_lm)}

    def step_of(fn, n):
        s = float(np.float32(1.0 / np.sqrt(n)))
        return lambda x: fn(x)[0] * s

    # Accuracy first: catches a kernel fault before paying for timing.
    x = rng.standard_normal((1, ACCURACY_N)).astype(np.float32)
    ref = np.fft.fft(x[0].astype(np.float64))
    for name, make in variants.items():
        if make is None:
            entries.append({"group": "accuracy", "variant": name, "error": RETIRED})
            continue
        yr, yi = make(ACCURACY_N)(torch.from_numpy(x).to(dev))
        err = max(np.abs(yr[0].cpu().numpy() - ref.real).max(),
                  np.abs(yi[0].cpu().numpy() - ref.imag).max()) / np.abs(ref).max()
        entries.append({"group": "accuracy", "variant": name, "n": ACCURACY_N, "rel_err": float(err)})
        print(f"accuracy {name}: rel err {err:.2e}", flush=True)

    configs = QUICK_CONFIGS if quick else CONFIGS
    times: dict = {}
    for rnd in range(rounds):
        for b, n in configs:
            xb = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)
            for name, make in variants.items():
                if make is None:
                    continue
                st = profiling.chained_step_stats(step_of(make(n), n), xb, **timing)
                times.setdefault((name, b, n), []).append(st.median_s)
                print(f"round{rnd} {name:10s} b{b:3d} n{n:6d}: {st.median_s * 1e6:8.2f} us "
                      f"(iqr {st.iqr_s * 1e6:.2f})", flush=True)
    for (name, b, n), ts in times.items():
        entries.append({"group": "engine", "variant": name, "batch": b, "n": n,
                        "best_us": min(ts) * 1e6, "all_us": [t * 1e6 for t in ts]})
    entries += [{"group": "engine", "variant": "pallas", "batch": b, "n": n, "error": RETIRED}
                for b, n in configs]

    # rfft decision data: the retired fused rfft kernel against the real
    # four-step engines.
    if not quick:
        for n in RFFT_SIZES:
            entries.append({"group": "rfft", "variant": "rfft_pallas", "batch": 1, "n": n,
                            "error": RETIRED})
            if n > 65536:
                continue
            xr = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev)
            for name, make in (("real_jnp", jnp), ("real_jnp_lm", variants["jnp_lm"])):
                st = profiling.chained_step_stats(step_of(make(n), n), xr, **timing)
                entries.append({"group": "rfft", "variant": name, "batch": 1, "n": n,
                                "best_us": st.median_s * 1e6})
                print(f"rfft n{n} {name:12s}: {st.median_s * 1e6:8.2f} us", flush=True)

    out = Path(out_dir) / "ablate_engines_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    print("\n== engine winners ==")
    for b, n in configs:
        row = {name: min(times[(name, b, n)]) for name in variants if (name, b, n) in times}
        best = min(row, key=row.get)
        line = "  ".join(f"{k}={v * 1e6:.2f}us" for k, v in row.items())
        print(f"b{b} n{n}: {line}  -> {best}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="two configurations, fewer repetitions")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    main(quick=args.quick, rounds=args.rounds)
