"""Device time of the S3 kernels (the stage-A dot in three precisions), for
comparing two checkouts of the port on one card and for choosing their
launch shapes.

    python gpu_fft_tpu_torch/scripts/time_dot.py --tree DIR --label NAME [--sweep]

imports ``gpu_fft_tpu_torch`` from the checkout at DIR (built there on first
use), checks each variant of ``stage_a_dot`` at the shapes of
:data:`CHECKS` against its plain version (max|d| <= 1e-5 max|plain|) and,
for f32 and bf16_x6, against float64 (5 log2(n1) eps), then times each
variant at (1, 128, 8192), the ``ablate_mosaic_x6`` shape, with the one
PyTorch call that computes the same function where there is one
(``torch.matmul`` on the stacked LHS for f32; ``torch.mm`` with
``out_dtype=torch.float32`` on bf16 operands for bf16_x1, x rounded
outside the timed region).  A time is the profiler's device time per call,
median of 5 profiles of 50 calls (``time_stage_a.kernel_ms``).  Appends
one JSON line to ``chiprun_out/time_dot.jsonl``.  Run it once per checkout,
in turns (A B B A), in one call on one card.

``--sweep`` (a checkout with ``ablation.dot_launch_shapes``) also times
every launch shape the bf16 kernels take there, the shipped one among them,
each launch checked against the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

from time_stage_a import append_record, card_line, kernel_ms, open_tree  # this script's sibling

#: (B, n1, n2) checked per variant: the harness shape, the test shapes,
#: n1 = 256, an uneven last depth chunk (n1 = 96), the narrowest tile
#: (n2 = 64) and the largest n1 of x6 (384) and of x1 (1,472).
CHECKS = ((1, 128, 8192), (1, 32, 256), (2, 64, 512), (1, 256, 8192), (3, 128, 1024),
          (1, 64, 64), (2, 96, 192), (1, 384, 128), (1, 1472, 64))
TIMED = (1, 128, 8192)
EPS32 = 1.1920929e-07


def _case(torch, A, b, n1, n2, dev, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((n1, n1)).astype(np.float32) / n1
    fi = rng.standard_normal((n1, n1)).astype(np.float32) / n1
    x = rng.standard_normal((b, n1, n2)).astype(np.float32)
    tables = A.dot_tables(torch.from_numpy(fr).to(dev), torch.from_numpy(fi).to(dev))
    ref = (np.einsum("mk,bkn->bmn", fr.astype(np.float64), x.astype(np.float64)),
           np.einsum("mk,bkn->bmn", fi.astype(np.float64), x.astype(np.float64)))
    return tables, torch.from_numpy(x).to(dev), ref


def _errors(got, want, ref):
    import numpy as np

    d = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    peak = max(float(np.abs(r).max()) for r in ref)
    rel64 = max(float(np.abs(g.cpu().numpy() - r).max()) for g, r in zip(got, ref)) / peak
    return d, scale, rel64


def sweep(torch, A, K, tables, x, variant: str) -> list[dict]:
    """Every launch shape of ``variant`` at x's shape
    (``ablation.dot_launch_shapes``; the first is the shipped one)."""
    b, n1, n2 = x.shape
    want = A.stage_a_dot_plain(x, tables, variant)
    scale = max(float(w.abs().max()) for w in want)
    out = []
    for i, geo in enumerate(A.dot_launch_shapes(b, n1, n2, variant, K.sm_count(x.device))):
        got = A.dot_launch(x, tables, variant, geo)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        row = {"variant": variant, "shape": [b, n1, n2], "geometry": list(geo), "shipped": i == 0,
               "max_abs_err": err, "ok": bool(err <= 1e-5 * scale),
               "ms": kernel_ms(lambda geo=geo: A.dot_launch(x, tables, variant, geo))}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to import the port from")
    ap.add_argument("--label", required=True, help="name of the checkout in the output")
    ap.add_argument("--sweep", action="store_true", help="also time every launch shape that fits")
    args = ap.parse_args()
    open_tree(args.tree)
    import numpy as np
    import torch

    from gpu_fft_tpu_torch.config import apply_precision
    from gpu_fft_tpu_torch.kernels import _build
    from gpu_fft_tpu_torch.kernels import ablation as A
    from gpu_fft_tpu_torch.kernels import fused as K

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    apply_precision()
    dev = torch.device("cuda")
    card = card_line()
    info = _build.build()
    ptxas = [line.strip() for line in info.log.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    rec = {"label": args.label, "tree": args.tree, "card": card, "module": A.__file__,
           "build_seconds": info.seconds, "checks": [], "ms": {}, "library_ms": {}, "sweep": []}
    print(card, flush=True)
    print("\n".join(ptxas), flush=True)
    failed = []
    for i, (b, n1, n2) in enumerate(CHECKS):
        tables, x, ref = _case(torch, A, b, n1, n2, dev, i)
        for v in A.VARIANTS:
            try:
                got = A.stage_a_dot(x, tables, v)
                torch.cuda.synchronize()
            except ValueError as e:  # a shape the kernel refuses before the launch
                rec["checks"].append({"variant": v, "shape": [b, n1, n2], "refused": str(e)})
                print(f"{v:12s} {(b, n1, n2)} refused: {e}", flush=True)
                continue
            d, scale, rel64 = _errors(got, A.stage_a_dot_plain(x, tables, v), ref)
            gate = 5 * np.log2(n1) * EPS32
            ok = bool(d <= 1e-5 * scale and (v == "bf16_x1" or rel64 <= gate))
            rec["checks"].append({"variant": v, "shape": [b, n1, n2], "max_abs_err": d, "max_abs": scale,
                                  "rel_err_f64": rel64, "gate_f64": gate, "ok": ok})
            print(f"{v:12s} {(b, n1, n2)} max|d| {d:.3e} (1e-5 x {scale:.3e}) f64 rel {rel64:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((v, (b, n1, n2)))
    b, n1, n2 = TIMED
    tables, x, _ = _case(torch, A, b, n1, n2, dev, 99)
    for v in A.VARIANTS:
        rec["ms"][v] = kernel_ms(lambda v=v: A.stage_a_dot(x, tables, v))
    f_cat = torch.cat([tables["fr"], tables["fi"]])
    rec["library_ms"]["f32_highest"] = kernel_ms(lambda: torch.matmul(f_cat, x[0]))
    f_bf = f_cat.to(torch.bfloat16)
    x_bf = x[0].to(torch.bfloat16)
    try:
        rec["library_ms"]["bf16_x1"] = kernel_ms(lambda: torch.mm(f_bf, x_bf, out_dtype=torch.float32))
    except (TypeError, RuntimeError) as e:
        rec["library_ms"]["bf16_x1"] = f"none: {type(e).__name__}: {e}"
    print(json.dumps({"ms": rec["ms"], "library_ms": rec["library_ms"]}), flush=True)
    if args.sweep:
        for v in ("bf16_x6", "bf16_x1"):
            rec["sweep"] += sweep(torch, A, K, tables, x, v)
    rec["ptxas"] = ptxas
    append_record("time_dot.jsonl", rec)
    print(json.dumps({k: rec[k] for k in ("label", "card", "ms", "library_ms")}))
    if failed or not all(r["ok"] for r in rec["sweep"]):
        sys.exit(f"checks failed: {failed}")


if __name__ == "__main__":
    main()
