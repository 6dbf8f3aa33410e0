"""Re-derive the port's tuning-table entry on the card.

Counterpart of ``scripts/calibrate_chip.py``: the measurements behind the
``tuning.ChipTuning`` fields, interleaved on the card, and a ready-to-paste
entry in the port's fields (``tuning.py`` is not edited: re-tuning a gate is
judged by the bench).

  wide-split crossover   ``fused_fft_folded`` on the balanced plan and on
                         the wide (n2 = 128) plan, per (B, n), for
                         ``wide_batch_min``.  n starts at 1,024: at n <= 512
                         both plans are the same direct DFT (the JAX
                         script's n = 256 rows raise there).
  stage-A digit          ``transform_any`` at 2^18 (quick) or 2^20 with
                         ``plan._stage_a_n1`` patched to 128 and 256, the
                         plan caches cleared and restored, for ``stage_a_n1``
  half-spectrum gate     ``fused_fft`` against ``fused_fft_half`` on the
                         balanced plan, B = 1, for ``half_spectrum_min``
  irfft fold gate        the full inverse (``transform_any``, sign +1,
                         1/n; K1 at 2^14) against the Hermitian fold
                         (``fused_irfft``), B = 1, for ``irfft_half_min``
  overlap-add block      ``oaconvolve_device`` of a 262,144-sample signal
                         with 257 ``firwin`` taps at each block length
                         4,096 ... 32,768, for ``oa_block_min``

The staged gate ``irfft_half_staged_min`` keeps the table's value, as in
the JAX script.

Usage: python -m gpu_fft_tpu_torch.scripts.calibrate_chip [--quick]
Writes ``chiprun_out/calibrate_chip_results.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

NEVER = 1 << 62  # a gate that never opens
OA_BLOCKS = (4096, 8192, 16384, 32768)


def tuning_entry(base, wide_batch_min: int, stage_a_n1: int, half_spectrum_min: int,
                 irfft_half_min: int, oa_block_min: int) -> str:
    """``base`` (a ``ChipTuning``) with the measured fields, as Python source."""
    t = dataclasses.replace(base, wide_batch_min=wide_batch_min, stage_a_n1=stage_a_n1,
                            half_spectrum_min=half_spectrum_min, irfft_half_min=irfft_half_min,
                            oa_block_min=oa_block_min, calibrated=True,
                            note="measured by gpu_fft_tpu_torch/scripts/calibrate_chip.py")
    fields = "\n".join(f"    {f.name}={getattr(t, f.name)!r}," for f in dataclasses.fields(t))
    return f"ChipTuning(\n{fields}\n)"


def main(quick: bool = False, out_dir: str = "chiprun_out", device="cuda") -> dict:
    from .. import plan as plan_mod
    from ..config import apply_precision
    from ..kernels.fused_torch import fused_fft, fused_fft_folded, fused_fft_half, fused_irfft
    from ..kernels.large import transform_any
    from ..ops.filter import firwin, oaconvolve_device
    from ..plan import get_fused_plan, get_irfft_plan, on_device
    from ..tuning import get_tuning
    from ..utils import profiling

    apply_precision()
    dev = torch.device(device)
    rng = np.random.default_rng(7)
    timing = dict(k1=3, k2=23, reps=3, min_span_s=0.01) if quick else dict(k1=20, k2=220, reps=5)
    results: dict = {"device": torch.cuda.get_device_name(dev), "quick": quick,
                     "wide_split": [], "stage_a_digit": [], "half_spectrum": [],
                     "oa_block": [], "irfft_fold": []}

    def us(step, x0):
        return profiling.chained_step_stats(step, x0, **timing).median_s * 1e6

    def rand(b, n):
        return torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dev)

    def carry(yr, x, k=1e-6):
        return yr * k + x * 0.9

    # ── wide_batch_min: balanced against the n2 = 128 split ─────────────────
    print("[calibrate] wide-split crossover (balanced vs n2=128):", flush=True)
    bs = (4, 16, 64) if quick else (4, 8, 16, 32, 64)
    ns = (1024, 4096, 16384)
    for n in ns:
        for b in bs:
            x = rand(b, n)
            t = {}
            for wide in (False, True):
                plan = on_device(get_fused_plan, n, -1, wide, None, device=dev)
                t[wide] = us(lambda v, p=plan: carry(fused_fft_folded(v, None, p)[0], v), x)
            results["wide_split"].append({"b": b, "n": n, "balanced_us": t[False], "wide_us": t[True]})
            print(f"  b={b:3d} n={n:6d}: balanced {t[False]:7.2f} us  wide {t[True]:7.2f} us  -> "
                  f"{'wide' if t[True] < t[False] else 'balanced'}", flush=True)
    wide_bs = sorted({r["b"] for r in results["wide_split"] if r["wide_us"] < r["balanced_us"]})
    wide_batch_min = wide_bs[0] if wide_bs else NEVER

    # ── stage_a_n1: the column digit at a staged size ───────────────────────
    n_staged = 1 << 18 if quick else 1 << 20
    print(f"[calibrate] stage-A digit at n=2^{n_staged.bit_length() - 1}:", flush=True)
    x = rand(1, n_staged)
    orig = plan_mod._stage_a_n1
    for digit in (128, 256):
        plan_mod._stage_a_n1 = lambda n, d=digit: d
        plan_mod.get_stage_a_plan.cache_clear()
        plan_mod.clear_device_cache()
        try:
            t = us(lambda v: carry(transform_any(v, None, n_staged, -1)[0], v), x)
        finally:
            plan_mod._stage_a_n1 = orig
            plan_mod.get_stage_a_plan.cache_clear()
            plan_mod.clear_device_cache()
        results["stage_a_digit"].append({"n": n_staged, "n1": digit, "us": t})
        print(f"  n1={digit}: {t:.2f} us", flush=True)
    best_digit = min(results["stage_a_digit"], key=lambda r: r["us"])["n1"]

    # ── half_spectrum_min: where the Hermitian half path wins ───────────────
    print("[calibrate] half-spectrum gate (real input, B=1):", flush=True)
    half_min = NEVER
    for n in ((1 << 14, 1 << 15) if quick else (1 << 13, 1 << 14, 1 << 15, 1 << 16)):
        plan = on_device(get_fused_plan, n, -1, False, None, device=dev)
        x = rand(1, n)
        t_full = us(lambda v, p=plan: carry(fused_fft(v, None, p)[0], v), x)
        t_half = us(lambda v, p=plan: carry(fused_fft_half(v, p)[0], v), x)
        results["half_spectrum"].append({"n": n, "full_us": t_full, "half_us": t_half})
        print(f"  n={n:6d}: full {t_full:7.2f} us  half {t_half:7.2f} us  -> "
              f"{'half' if t_half < t_full else 'full'}", flush=True)
        if t_half < t_full:
            half_min = min(half_min, n)

    # ── irfft_half_min: where the real-output fold beats the full inverse ──
    print("[calibrate] irfft fold gate (real output, B=1):", flush=True)
    irfft_min = NEVER
    for n in ((1 << 14, 1 << 15) if quick else (1 << 13, 1 << 14, 1 << 15, 1 << 16)):
        plan = on_device(get_irfft_plan, n, 1.0 / n, None, device=dev)
        x = rand(1, n)
        t_full = us(lambda v, n=n: carry(transform_any(v, v, n, +1, scale=1.0 / n)[0], v, 1e-3), x)
        t_fold = us(lambda v, p=plan: carry(fused_irfft(v, v, p), v, 1e-3), x)
        results["irfft_fold"].append({"n": n, "full_us": t_full, "fold_us": t_fold})
        print(f"  n={n:6d}: full {t_full:7.2f} us  fold {t_fold:7.2f} us  -> "
              f"{'fold' if t_fold < t_full else 'full'}", flush=True)
        if t_fold < t_full:
            irfft_min = min(irfft_min, n)

    # ── oa_block_min: the overlap-add block floor ───────────────────────────
    print("[calibrate] overlap-add block floor (262144-sample signal, 257 taps):", flush=True)
    sig = rand(1, 1 << 18)
    taps = torch.from_numpy(firwin(257, 0.3).astype(np.float32)).to(dev)
    for blk in OA_BLOCKS:
        t = us(lambda v, blk=blk: oaconvolve_device(v, taps, block=blk)[:, : v.shape[1]], sig)
        results["oa_block"].append({"block": blk, "us": t})
        print(f"  block={blk}: {t:.2f} us", flush=True)
    best_block = min(results["oa_block"], key=lambda r: r["us"])["block"]

    entry = tuning_entry(get_tuning(), wide_batch_min, best_digit, half_min, irfft_min, best_block)
    results["tuning_entry"] = entry
    print("[calibrate] a ChipTuning entry from these measurements (tuning.py is not edited):")
    print(entry)
    out = Path(out_dir) / "calibrate_chip_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="a smaller grid, fewer repetitions")
    main(quick=ap.parse_args().quick)
