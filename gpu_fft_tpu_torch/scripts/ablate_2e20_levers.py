"""The named 2^20 schedule levers, measured through the real composed path.

Counterpart of ``scripts/ablate_2e20_levers.py``: each lever is applied by
patching a plan builder and clearing the plan caches (the builder's own and
:func:`..plan.clear_device_cache`), so the whole dispatch of
``transform_any`` is what runs.

  L0  the shipped path.
  L1  stage-A column tile ct in {256, 1024, 2048} by patching
      ``plan.stage_a_col_tile``.  ``transform_any`` asks
      ``stage_a_ct_full_range``, which ignores that function wherever
      n2 >= ``stage_a_wide_ct_n2_min`` (8,192): at 2^20 (n1 = 128,
      n2 = 8,192) every L1 row runs the shipped ct = 2,048, so L1 changes
      nothing, as in today's JAX tree.  Ported as it is.
  L2  stage-B re-blocking (m1, m2) in {(32, 256), (128, 64)} by replacing
      ``kernels.large.get_stage_a_plan``.  The JAX script's replacement
      takes (n, sign) only, while its ``_staged`` now passes ``ct=``; the
      port's replacement takes ``ct`` and passes it on.
  L3  stage A alone: S2 ``stage_a_manual`` (F1 resident, column tiles
      pipelined by hand with cp.async, materialized twiddle) against the
      shipped K3 (factored twiddle) at the same shape.
  L4  the ct rule across staged sizes (2^17 … 2^22), forward rows and
      ``irfft_device`` rows, each held against the ct = 512 row of its n
      and kind.  The staged real-output inverse (from 2^18) reads
      ``stage_a_col_tile`` itself, so its rows do run each ct; the forward
      rows at 2^20 and 2^22 run ct = 2,048 (L1's note).

Every timed row carries ``parity``, max|row - reference| / max|reference|,
the reference being L0 (L1, L2), the shipped K3 (L3) or the ct = 512 row of
the same n (L4); :func:`parity_failures` lists the rows above the accuracy
gate.

A row that raises is recorded with its error and the run goes on, as in the
JAX script.  Unlike it, the port starts from an empty result set each run.

Usage: python -m gpu_fft_tpu_torch.scripts.ablate_2e20_levers [--quick]
Writes ``chiprun_out/ablate_2e20_levers_results.json``.
"""

from __future__ import annotations

import argparse
import json
import traceback
from pathlib import Path

import numpy as np
import torch

N = 1 << 20
# 5 * log2(n) * eps at the largest n swept (2^22): two fp32 transforms of
# the same input by different plans agree within the accuracy gate.
PARITY_LIMIT = 5 * 22 * float(np.finfo(np.float32).eps)


def main(quick: bool = False, out_dir: str = "chiprun_out") -> dict:
    import gpu_fft_tpu_torch.kernels.large as large_mod
    import gpu_fft_tpu_torch.plan as plan_mod
    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels.ablation import stage_a_manual
    from gpu_fft_tpu_torch.kernels.fused import stage_a as stage_a_grid
    from gpu_fft_tpu_torch.kernels.tables import dft_matrix_ext, twiddle_table
    from gpu_fft_tpu_torch.ops.transform import irfft_device
    from gpu_fft_tpu_torch.utils.profiling import chained_step_stats

    apply_precision()
    dev = torch.device("cuda")
    out = Path(out_dir) / "ablate_2e20_levers_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    results: dict = {"device": torch.cuda.get_device_name(dev), "quick": quick, "rows": {}}
    rows = results["rows"]
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.standard_normal((1, N)).astype(np.float32)).to(dev)
    s = float(np.float32(1.0 / np.sqrt(N)))
    timing = dict(k1=5, k2=25, reps=2, min_span_s=0.01) if quick else dict(k1=20, k2=220, reps=2)
    n_samples = 1 if quick else 3
    ref = None

    def save():
        out.write_text(json.dumps(results, indent=1))

    def us_of(step, x):
        return min(chained_step_stats(step, x, **timing).median_s for _ in range(n_samples)) * 1e6

    def record_error(name, e):
        rows[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        save()
        print(f"{name}: ERROR {rows[name]['error'][:160]}", flush=True)
        traceback.print_exc()

    def fft_step(x):
        yr, _ = large_mod.transform_any(x, None, N, -1)
        return yr * s

    def measure(name, step):
        nonlocal ref
        got = step(x0).cpu().numpy()
        if ref is None:
            ref = got
        par = float(np.abs(got - ref).max() / np.abs(ref).max())
        rows[name] = {"us": us_of(step, x0), "parity": par}
        save()
        print(f"{name}: {rows[name]['us']:8.2f} us  par={par:.1e}", flush=True)

    def clear_plans():
        plan_mod.get_stage_a_plan.cache_clear()
        plan_mod.clear_device_cache()

    # ── L0: shipped ─────────────────────────────────────────────────────────
    measure("L0_shipped", fft_step)

    # ── L1: stage-A column tile (a no-op at 2^20: see the docstring) ───────
    orig_ct = plan_mod.stage_a_col_tile
    for ct in (256, 1024, 2048):
        plan_mod.stage_a_col_tile = lambda n1, n2, _ct=ct: min(_ct, n2)
        clear_plans()
        try:
            measure(f"L1_ct{ct}", fft_step)
        except Exception as e:  # a row's failure is recorded; the sweep goes on
            record_error(f"L1_ct{ct}", e)
    plan_mod.stage_a_col_tile = orig_ct
    clear_plans()

    # ── L2: stage-B (m1, m2) re-block ──────────────────────────────────────
    orig_plan = plan_mod.get_stage_a_plan.__wrapped__

    def patched_stage_a_plan(n, sign, ct, m1m2):
        plan = dict(orig_plan(n, sign, ct))
        n2 = plan["n2"]
        m1, m2 = m1m2
        if m1 * m2 != n2:
            raise ValueError(f"m1 * m2 = {m1 * m2} != n2 = {n2}")
        g1 = dft_matrix_ext(m1, sign)
        g2 = dft_matrix_ext(m2, sign)
        btwr, btwi = twiddle_table(m2, m1, n2, sign)
        plan["stage_b"] = {
            "m1": m1, "m2": m2,
            "f1r": g1[0], "f1i": g1[1], "f1s": g1[2], "f1d": g1[3],
            "f2r": g2[0], "f2i": g2[1], "f2s": g2[2], "f2d": g2[3],
            "twr": btwr, "twi": btwi,
        }
        return plan

    for m1m2 in ((32, 256), (128, 64)):
        cache: dict = {}

        def cached(n, sign, ct=None, _m=m1m2, _cache=cache):
            if (n, sign, ct) not in _cache:
                _cache[(n, sign, ct)] = patched_stage_a_plan(n, sign, ct, _m)
            return _cache[(n, sign, ct)]

        large_mod.get_stage_a_plan = cached
        try:
            measure(f"L2_m{m1m2[0]}x{m1m2[1]}", fft_step)
        except Exception as e:
            record_error(f"L2_m{m1m2[0]}x{m1m2[1]}", e)
    large_mod.get_stage_a_plan = plan_mod.get_stage_a_plan
    clear_plans()

    # ── L3: S2 (hand-pipelined stage A) against the shipped K3 ─────────────
    try:
        plan = plan_mod.on_device(plan_mod.get_stage_a_plan, N, -1, None, device=dev)
        n1, n2, ct = plan["n1"], plan["n2"], plan["ct"]
        twr, twi = twiddle_table(n1, n2, N, -1)
        legacy = {
            "f1r": plan["f1r"], "f1i": plan["f1i"],
            "twr": torch.from_numpy(twr).to(dev), "twi": torch.from_numpy(twi).to(dev),
        }

        def stage_a_manual_step(x):
            yr, _ = stage_a_manual(x.reshape(n1, n2), legacy)
            return yr.reshape(1, N)  # shape-stable chain carry

        def stage_a_shipped(x):
            yr, _ = stage_a_grid(x.reshape(1, n1, n2), None, n1, n2, plan, ct)
            return yr.reshape(1, N)

        a = stage_a_shipped(x0).cpu().numpy()
        b = stage_a_manual_step(x0).cpu().numpy()
        par = float(np.abs(a - b).max() / np.abs(a).max())
        ta = us_of(stage_a_shipped, x0)
        tb = us_of(stage_a_manual_step, x0)
        rows["L3_stageA_shipped_grid"] = {"us": ta, "parity": 0.0}
        rows["L3_stageA_emit_pipeline"] = {"us": tb, "parity": par}
        print(f"L3 stage-A shipped K3:        {ta:8.2f} us", flush=True)
        print(f"L3 stage-A S2 manual pipeline: {tb:8.2f} us  par={par:.1e}", flush=True)
    except Exception as e:
        record_error("L3_stageA_emit_pipeline", e)
    save()

    # ── L4: ct rule sweep across staged sizes ──────────────────────────────
    orig_ct2 = plan_mod.stage_a_col_tile
    for nn in (1 << 17, 1 << 18, 1 << 20, 1 << 22):
        xs = torch.from_numpy(rng.standard_normal((1, nn)).astype(np.float32)).to(dev)
        ss = float(np.float32(1.0 / np.sqrt(nn)))

        def ffts(x, _n=nn, _s=ss):
            yr, _ = large_mod.transform_any(x, None, _n, -1)
            return yr * _s

        h = nn // 2 + 1

        def irffts(x, _h=h, _s=ss):
            z = x[..., :_h]
            return irfft_device(z, z * 0.5) * _s

        ref_n = {}
        for ct in (512, 1024, 2048):
            plan_mod.stage_a_col_tile = lambda a_, b_, _ct=ct: min(_ct, b_)
            clear_plans()
            for kind, stepf in (("fft", ffts), ("irfft", irffts)):
                key = f"L4_{kind}_n{nn}_ct{ct}"
                try:
                    got = stepf(xs).cpu().numpy()
                    ref = ref_n.setdefault(kind, got)
                    par = float(np.abs(got - ref).max() / np.abs(ref).max())
                    rows[key] = {"us": us_of(stepf, xs), "parity": par}
                    print(f"{key}: {rows[key]['us']:8.2f} us  par={par:.1e}", flush=True)
                except Exception as e:
                    record_error(key, e)
                save()
        del xs
    plan_mod.stage_a_col_tile = orig_ct2
    clear_plans()
    save()
    print(f"wrote {out}")
    return results


def unexpected_errors(results: dict) -> dict:
    """Rows holding an error: every row is ported, so no error is expected."""
    return {k: v["error"] for k, v in results["rows"].items() if "error" in v}


def parity_failures(results: dict) -> dict:
    """Timed rows whose parity is above :data:`PARITY_LIMIT` (or not a number)."""
    return {
        k: v.get("parity") for k, v in results["rows"].items()
        if "us" in v and not v.get("parity", float("nan")) <= PARITY_LIMIT
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer repetitions")
    main(quick=ap.parse_args().quick)
