"""Device time of stage B of the staged transform: K4 (``stage_b_kernel``)
beside the torch engine it replaces, and every launch shape of K4.

    python gpu_fft_tpu_torch/scripts/time_stage_b.py [--tree DIR] [--label NAME] [--check] [--sweep] [--quick]

imports ``gpu_fft_tpu_torch`` from the checkout at DIR (default: this one;
built there on first use).  For each (B, n1, n2) of :data:`SHAPES` (n1 =
128, n2 = 1,024 ... 65,536, B·n1 = 128 ... 8,192 rows, and (1, 256, 65,536)
of n = 2^24) and both signs it checks one K4 launch against its plain
version (the torch ``stage_b``, max|d| <= 1e-5 max|plain|) and against a
float64 FFT of the rows (5 log2(n2) eps of max|ref|), then times K4 and the
torch ``stage_b`` by the profiler's device time (median of 5 profiles;
:func:`time_stage_a.kernel_ms`), and prints each beside the bytes bound:
16 bytes a complex point (Y read once, X written once) at 3.35 TB/s.
``--sweep`` also times K4 at every (G, C) of
``fused.stage_b_launch_shapes`` (G rows a cluster, C blocks a row) under
the first sign, each launch checked first, the rule's pick marked.  ``--check`` checks every
launch shape at every n2 at B = 1 and 3 and times nothing; ``--quick``
keeps B = 1 and the sign -1; ``--shape B,N1,N2`` (repeatable) times
that shape in place of :data:`SHAPES`.  One JSON line is appended to ``time_stage_b.jsonl`` where
``time_stage_a.append_record`` writes.  Run it as a file, not with ``-m``:
it imports its timing helpers from ``time_stage_a.py`` beside it.
"""

from __future__ import annotations

import argparse
import math

from time_stage_a import append_record, card_line, kernel_ms, open_tree  # this script's sibling

#: (B, n1, n2) timed: n1 = 128 (n = 2^17 ... 2^23) at B = 1, 8 and 64 up to
#: B n = 2^27, and n = 2^24 (n1 = 256).
SHAPES = tuple((b, 128, n2) for n2 in (1 << e for e in range(10, 17)) for b in (1, 8, 64)
               if b * 128 * n2 <= 1 << 27) + ((1, 256, 1 << 16),)
HBM_BYTES_PER_S = 3.35e12
RTOL = 1e-5


def bound_ms(b: int, n1: int, n2: int) -> float:
    """Stage B's bytes bound: 16 bytes a complex point at 3.35 TB/s."""
    return 16.0 * b * n1 * n2 / HBM_BYTES_PER_S * 1e3


def _case(b, n1, n2, sign, dev, seed):
    import torch

    from gpu_fft_tpu_torch import plan as P

    n = n1 * n2
    t = P.on_device(P.get_stage_a_plan, n, sign, None, device=dev)["stage_b"]
    tw = P.on_device(P.get_stage_b_twiddle, n2, sign, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    yr = torch.randn(b, n1, n2, device=dev, generator=g)
    yi = torch.randn(b, n1, n2, device=dev, generator=g)
    return yr, yi, t, tw, (1.0 / n if sign > 0 else None)


def _check(got, yr, yi, n1, n2, sign, t, tw, scale) -> dict:
    """max|K4 - plain| / max|plain| and max|K4 - float64| / max|ref|."""
    import torch

    from gpu_fft_tpu_torch.kernels import fused as K

    want = K.stage_b_kernel_plain(yr, yi, n1, n2, t, tw, scale)
    rel = max(float((g - w).abs().max()) for g, w in zip(got, want)) / max(float(w.abs().max()) for w in want)
    z = torch.complex(yr.double(), yi.double())
    ref = torch.fft.fft(z, dim=-1) if sign < 0 else torch.fft.ifft(z, dim=-1) * n2
    ref = ref * (1.0 if scale is None else scale)
    ref = ref.transpose(1, 2).reshape(yr.shape[0], n1 * n2)
    f64 = max(float((got[0] - ref.real).abs().max()), float((got[1] - ref.imag).abs().max())) / float(ref.abs().max())
    gate = 5 * math.log2(n2) * 1.1920929e-07
    if not (rel <= RTOL and f64 <= gate):
        raise SystemExit(f"stage_b kernel at {tuple(yr.shape)} sign {sign}: {rel:.3e} from plain, "
                         f"{f64:.3e} from float64 (gates {RTOL}, {gate:.3e})")
    return {"max_rel_plain": rel, "max_rel_f64": f64}


def _launch(yr, yi, t, tw, n1, scale, shape=None):
    from gpu_fft_tpu_torch.kernels import fused as K

    tables = K.stage_b_tables(t, tw)
    geometry = K.stage_b_geometry(n1, yr.shape[-1] // 128, shape)
    return lambda: K.stage_b_launch(yr, yi, tables, n1, 1.0 if scale is None else scale, geometry)


def check_all(dev) -> list:
    """Every launch shape at every n2 at B = 1 and 3, both signs."""
    from gpu_fft_tpu_torch.kernels import fused as K

    rows = []
    for n2 in (1 << e for e in range(10, 17)):
        for b in (1, 3):
            for sign in (-1, 1):
                yr, yi, t, tw, scale = _case(b, 128, n2, sign, dev, n2 + b)
                shapes = K.stage_b_launch_shapes(128, n2 // 128)
                for shape in shapes:
                    got = _launch(yr, yi, t, tw, 128, scale, shape)()
                    rows.append({"shape": [b, 128, n2], "sign": sign, "G_C": list(shape),
                                 **_check(got, yr, yi, 128, n2, sign, t, tw, scale)})
                worst = max(r["max_rel_f64"] for r in rows[-len(shapes):])
                print(f"  checked B={b} n2={n2} sign {sign:+d}: {len(shapes)} launch shapes, "
                      f"worst vs float64 {worst:.3e}", flush=True)
    return rows


def time_all(dev, shapes, signs, sweep: bool) -> list:
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels.fused_torch import stage_b

    rows = []
    for b, n1, n2 in shapes:
        for sign in signs:
            yr, yi, t, tw, scale = _case(b, n1, n2, sign, dev, b * n2 + sign)
            run = _launch(yr, yi, t, tw, n1, scale)
            row = {"shape": [b, n1, n2], "n": n1 * n2, "sign": sign,
                   **_check(run(), yr, yi, n1, n2, sign, t, tw, scale)}
            row["k4_ms"] = kernel_ms(run, "stage_b_kernel")
            row["torch_ms"] = kernel_ms(lambda: stage_b(yr, yi, n1, n2, t), "", calls=10, profiles=3)
            row["bound_ms"] = bound_ms(b, n1, n2)
            row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["k4_ms"]
            print(f"  B={b:3d} n1={n1} n2={n2:6d} sign {sign:+d}: K4 {row['k4_ms']:.5f} ms "
                  f"({row['pct_of_bound']:.1f}% of {row['bound_ms']:.5f}), torch stage_b {row['torch_ms']:.4f} ms "
                  f"({row['torch_ms'] / row['k4_ms']:.1f}x)", flush=True)
            if sweep and sign == signs[0]:
                pick = K.stage_b_geometry(n1, n2 // 128)
                row["sweep"] = []
                for shape in K.stage_b_launch_shapes(n1, n2 // 128):
                    fn = _launch(yr, yi, t, tw, n1, scale, shape)
                    _check(fn(), yr, yi, n1, n2, sign, t, tw, scale)
                    ms = kernel_ms(fn, "stage_b_kernel", profiles=3)
                    chosen = K.stage_b_geometry(n1, n2 // 128, shape) == pick
                    row["sweep"].append({"G_C": list(shape), "ms": ms, "pick": chosen})
                    print(f"      G={shape[0]:2d} C={shape[1]:2d}: {ms:.5f} ms{'  <- rule' if chosen else ''}",
                          flush=True)
            rows.append(row)
            del yr, yi
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".", help="root of the checkout to import the port from")
    ap.add_argument("--label", default="tree", help="name of the checkout in the output")
    ap.add_argument("--check", action="store_true", help="check every launch shape, time nothing")
    ap.add_argument("--sweep", action="store_true", help="also time every launch shape")
    ap.add_argument("--quick", action="store_true", help="B = 1 and sign -1 only")
    ap.add_argument("--shape", action="append", default=[], metavar="B,N1,N2",
                    help="time this (B, n1, n2) in place of SHAPES (repeatable)")
    args = ap.parse_args()
    open_tree(args.tree)
    import torch

    from gpu_fft_tpu_torch.config import apply_precision

    apply_precision()
    dev = torch.device("cuda")
    card = card_line()
    print(f"time_stage_b on {card}, tree {args.tree} ({args.label})", flush=True)
    if args.check:
        rec = {"label": args.label, "card": card, "checks": check_all(dev)}
    else:
        shapes = [tuple(int(v) for v in a.split(",")) for a in args.shape] or SHAPES
        if args.quick:
            shapes = [s for s in shapes if s[0] == 1]
        rec = {"label": args.label, "card": card,
               "rows": time_all(dev, shapes, (-1,) if args.quick else (-1, 1), args.sweep)}
    append_record("time_stage_b.jsonl", rec)


if __name__ == "__main__":
    main()
