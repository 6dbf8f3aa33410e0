"""Calibrate the roofline's matmul model against bare fp32 matmuls on the card.

Counterpart of ``scripts/calibrate_matmul.py``.  The transform plans
contract over K = 32 ... 512; a stage's least time is what a bare
``z @ W`` of that K takes, so this measures, per K, the marginal time of one
fp32 ``torch.matmul`` with TF32 off (cuBLAS SGEMM on the CUDA cores) and
expresses it in the JAX package's unit,

    eff_passes(K) = marginal_s * bf16_peak / (2 M K K),

beside the effective rate 2 M K K / marginal_s.  M * K = 2^20 elements per
operand.  The marginal cost comes from chains of d1 and d2 = 3 d1 matmuls per
step, differenced, so the chain's own per-step ops and the step boundary
cancel.  The pair (two products sharing an operand) and Karatsuba-triple
patterns at K = 128 and 256 are timed whole, as in the JAX script.

Usage: python -m gpu_fft_tpu_torch.scripts.calibrate_matmul [--quick]
Writes ``chiprun_out/calibrate_matmul_results.json`` and prints the
``EFF_PASSES["h100"]`` entry.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

CONTRACTIONS = (32, 64, 128, 256, 512)
ELEMENTS = 1 << 20  # M * K per operand


def eff_passes_of(seconds: float, flops: float, bf16_tflops: float) -> float:
    """Effective bf16 passes of ``flops`` done in ``seconds``."""
    return seconds * bf16_tflops * 1e12 / flops


def main(quick: bool = False, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from ..config import apply_precision
    from ..utils import profiling, roofline

    apply_precision()
    dev = torch.device(device)
    chip = roofline.CHIPS["h100"]
    timing = dict(k1=2, k2=12, reps=3, min_span_s=0.01) if quick else dict(
        k1=5, k2=55, reps=5, min_span_s=0.05)
    rng = np.random.default_rng(11)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    out: dict = {"device": torch.cuda.get_device_name(dev), "chip": chip.name, "quick": quick,
                 "tf32": torch.backends.cuda.matmul.allow_tf32, "classes": {}, "patterns": {}}
    for k in CONTRACTIONS:
        m = ELEMENTS // k
        d1 = max(2, (1024 // k) // (4 if quick else 1))
        d2 = 3 * d1
        ws = [tensor(rng.standard_normal((k, k)) * (0.5 / k)) for _ in range(4)]
        x0 = tensor(rng.standard_normal((m, k)))

        def make_step(d, ws=ws):
            def step(z):
                y = z
                for i in range(d):
                    y = y @ ws[i % len(ws)]
                # Renormalise so the chain neither explodes nor underflows.
                return y * 1e-3 + z * 0.5

            return step

        s1 = profiling.chained_step_stats(make_step(d1), x0, **timing)
        s2 = profiling.chained_step_stats(make_step(d2), x0, **timing)
        marginal_s = (s2.median_s - s1.median_s) / (d2 - d1)
        flops = 2.0 * m * k * k
        spread = max(s1.rel_iqr, s2.rel_iqr)
        out["classes"][str(k)] = {
            "eff_passes": eff_passes_of(marginal_s, flops, chip.bf16_tflops),
            "tflops": flops / marginal_s / 1e12 if marginal_s > 0 else float("nan"),
            "marginal_us": marginal_s * 1e6, "us_d1": s1.median_s * 1e6, "us_d2": s2.median_s * 1e6,
            "rel_iqr": spread, "m": m, "d1": d1, "d2": d2,
        }
        c = out["classes"][str(k)]
        print(f"[calibrate] K={k:4d} M={m:7d} d={d1}->{d2}: marginal {c['marginal_us']:8.3f} us/dot "
              f"-> {c['tflops']:6.2f} TFLOP/s, eff_passes={c['eff_passes']:7.3f} "
              f"(rel iqr {spread:.1%})", flush=True)

    for k in (128, 256):
        m = ELEMENTS // k
        ws = [tensor(rng.standard_normal((k, k)) * (0.5 / k)) for _ in range(3)]
        x0 = tensor(rng.standard_normal((m, k)))

        def pair(z, ws=ws):
            return (z @ ws[0]) * 0.5 + (z @ ws[1]) * 0.5

        def triple(z, ws=ws):
            a, b = z, z * 0.5
            k1 = (a + b) @ ws[0]
            k2 = a @ ws[1]
            k3 = b @ ws[2]
            return (k1 - k3) * 0.5 + (k1 + k2) * 0.5

        for name, fn, d in (("pair", pair, 2), ("triple", triple, 3)):
            s = profiling.chained_step_stats(fn, x0, **timing)
            flops = 2.0 * m * k * k * d
            out["patterns"][f"{name}_k{k}"] = {
                "eff_passes": eff_passes_of(s.median_s, flops, chip.bf16_tflops),
                "tflops": flops / s.median_s / 1e12, "us": s.median_s * 1e6,
            }
            p = out["patterns"][f"{name}_k{k}"]
            print(f"[calibrate] {name:6s} K={k}: {p['us']:8.2f} us -> {p['tflops']:6.2f} TFLOP/s, "
                  f"eff_passes={p['eff_passes']:7.3f}", flush=True)

    entry = {k: round(v["eff_passes"], 3) for k, v in out["classes"].items()}
    out["eff_passes"] = entry
    out["max_rel_iqr"] = max(v["rel_iqr"] for v in out["classes"].values())
    print(f"# EFF_PASSES['h100'] = {{{', '.join(f'{k}: {v}' for k, v in entry.items())}}}",
          file=sys.stderr)
    path = Path(out_dir) / "calibrate_matmul_results.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer repetitions, shorter chains")
    main(quick=ap.parse_args().quick)
