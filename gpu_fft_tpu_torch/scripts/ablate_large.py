"""Large-n staged-path ablation: stage-A engine and digit-size sweep.

Counterpart of ``scripts/ablate_large.py``.  Two questions, measured
interleaved on the card:

1. Does the stage-A kernel (here K3-legacy, the port's ``stage_a`` on a plan
   with a materialized (n1, n2) twiddle: the radix engine of the main
   path's K3, reading that table) beat the plain torch form of the same
   stage (``stage_a_torch``)?  The JAX engines ``pallas`` and ``jnp`` are
   ``kernel`` and ``torch`` here.
2. Which stage-A digit n1 (hence stage-B row length n2 = n / n1) is fastest
   per n?

Also times the full automatic path at n = 131,072.  Times are device times
per call from :func:`..utils.profiling.chained_step_stats` (CUDA graphs).

It runs in the precision mode of the process (``GPU_FFT_TPU_PRECISION``),
as the JAX script does: under "fast" the kernel engine is K3-legacy-fast
(``stage_a_bf16`` on the legacy plan, bf16 tensor cores) and the torch
engines take bf16x1 products.  The results name the mode, and the first
kernel row of each n is held against numpy in float64 within the mode's
:data:`ACCURACY_LIMIT`.

Usage: [GPU_FFT_TPU_PRECISION=fast] python -m gpu_fft_tpu_torch.scripts.ablate_large [--quick]
Writes ``chiprun_out/ablate_large_results.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import config
from .. import plan as plan_mod
from ..config import apply_precision
from ..kernels.fused import stage_a
from ..kernels.fused_torch import stage_a_torch
from ..kernels.large import transform_any
from ..kernels.tables import dft_matrix_ext, twiddle_table
from ..utils.profiling import chained_step_stats

ENGINES = ("kernel", "torch")
SWEEPS = {
    1 << 17: [16, 32, 64, 128],
    1 << 20: [32, 64, 128, 256],
    1 << 22: [128, 256, 512],
}
#: A staged transform's error against numpy in float64, max|d| / max|ref|,
#: by mode: "full" well inside fp32's 5 log2(n) eps; "high" and "fast" the
#: JAX package's bands (tests/test_precision.py).
ACCURACY_LIMIT = {"full": 1e-4, "high": 2e-4, "fast": 2e-2}


def make_plan(n: int, n1: int, sign: int) -> dict:
    """A legacy stage-A plan: the (n1, n1) column DFT and a materialized
    (n1, n2) twiddle, as numpy arrays (``plan.on_device`` uploads it)."""
    n2 = n // n1
    f1r, f1i, f1s, f1d = dft_matrix_ext(n1, sign)
    twr, twi = twiddle_table(n1, n2, n, sign)
    return {
        "n1": n1, "n2": n2,
        "f1r": f1r, "f1i": f1i, "f1s": f1s, "f1d": f1d,
        "twr": twr, "twi": twi,
    }


def staged_fft(x, plan: dict, engine: str):
    """One staged real forward transform of (B, n) rows with an explicit
    plan (tensors on ``x``'s device) and stage-A engine."""
    b, n = x.shape
    n1, n2 = plan["n1"], plan["n2"]
    x3 = x.reshape(b, n1, n2)
    if engine == "torch":
        yr, yi = stage_a_torch(x3, None, plan)
    elif engine == "kernel":
        yr, yi = stage_a(x3, None, n1, n2, plan, plan_mod.stage_a_col_tile(n1, n2))
    else:
        raise ValueError(f"engine {engine!r} is not one of {ENGINES}")
    rr, ri = transform_any(yr.reshape(b * n1, n2), yi.reshape(b * n1, n2), n2, -1)
    out_r = rr.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    out_i = ri.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
    return out_r, out_i


def main(quick: bool = False, out_dir: str = "chiprun_out") -> dict:
    apply_precision()
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    mode = config.PRECISION
    results = {"device": torch.cuda.get_device_name(dev), "quick": quick, "mode": mode, "entries": []}
    rounds, reps = (1, 2) if quick else (2, 3)
    timing = dict(k1=5, k2=25, min_span_s=0.01) if quick else dict(k1=10, k2=110, min_span_s=0.05)

    def time_step(fn, x, n):
        s = float(np.float32(1.0 / np.sqrt(n)))

        def step(xx):
            yr, _ = fn(xx)
            return yr * s

        return chained_step_stats(step, x, reps=reps, **timing)

    def accuracy(fn, n):
        xh = rng.standard_normal((1, n)).astype(np.float32)
        yr, _ = fn(torch.from_numpy(xh).to(dev))
        ref = np.fft.fft(xh[0].astype(np.complex128))
        return float(np.abs(yr[0].cpu().numpy() - ref.real).max() / np.abs(ref).max())

    for rnd in range(rounds):
        for n, n1s in SWEEPS.items():
            x = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).to(dev)
            for n1 in n1s:
                plan = plan_mod.on_device(make_plan, n, n1, -1, device=dev)
                for engine in ENGINES:
                    fn = lambda xx, p=plan, e=engine: staged_fft(xx, p, e)  # noqa: E731
                    if rnd == 0 and n1 == n1s[0] and engine == "kernel":
                        err = accuracy(fn, n)
                        if not err < ACCURACY_LIMIT[mode]:
                            raise RuntimeError(f"staged_fft n={n} n1={n1} mode={mode}: error {err:.3e} >= "
                                               f"{ACCURACY_LIMIT[mode]}")
                    st = time_step(fn, x, n)
                    results["entries"].append(
                        {"group": "staged", "n": n, "n1": n1, "engine": engine, "mode": mode, "round": rnd,
                         "us": st.median_s * 1e6, "iqr_us": st.iqr_s * 1e6, "suspect": st.suspect}
                    )
                    print(
                        f"round{rnd} n=2^{n.bit_length() - 1} n1={n1:4d} {engine:6s}: "
                        f"{st.median_s * 1e6:8.2f} us (iqr {st.iqr_s * 1e6:.2f})",
                        flush=True,
                    )
            del x

    # Full automatic path at 131072 (for the real-input selection table).
    x = torch.from_numpy(rng.standard_normal((1, 131072)).astype(np.float32)).to(dev)
    st = time_step(lambda xx: transform_any(xx, None, 131072, -1), x, 131072)
    results["entries"].append({"group": "auto", "n": 131072, "mode": mode, "us": st.median_s * 1e6})
    print(f"auto n=131072: {st.median_s * 1e6:.2f} us", flush=True)
    plan_mod.clear_device_cache()

    best: dict = {}
    for e in results["entries"]:
        if e["group"] != "staged":
            continue
        key = (e["n"], e["n1"], e["engine"])
        best[key] = min(best.get(key, 1e9), e["us"])
    print("\n== staged winners ==")
    winners = {}
    for n in SWEEPS:
        rows = {(n1, eng): v for (nn, n1, eng), v in best.items() if nn == n}
        top = min(rows, key=rows.get)
        winners[str(n)] = {"n1": top[0], "engine": top[1], "us": rows[top]}
        print(f"n=2^{n.bit_length() - 1}: best n1={top[0]} engine={top[1]} "
              f"({rows[top]:.2f} us); all: " +
              "  ".join(f"{k[0]}/{k[1]}={v:.1f}" for k, v in sorted(rows.items())))
    results["winners"] = winners

    out = Path(out_dir) / "ablate_large_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="one round, fewer repetitions")
    main(quick=ap.parse_args().quick)
