"""Device time of the whole-transform kernel (K1, K2, and S1, the same
kernel at n2 = 64, 128 or 256) by cluster size, and against earlier builds,
on one card.

    python -m gpu_fft_tpu_torch.scripts.time_whole [--quick] [--no-sweep]
        [--baseline SRC.cu] [--baseline-lm SRC.cu]

1. Sweep (left out with ``--no-sweep``): K1 at B = 1 for n = 1,024 …
   65,536, and at B = 16 and 64 for n = 4,096 and 16,384, real forward and
   complex inverse (sign +1, scale 1/n); S1 (real forward, ``lm_tables``) at
   the seven (B, n) of ``LM_CASES``; each at every cluster size C in
   {1, 2, 4, 8, 16} that the kernel takes (n / (8 C) <= 1,024 threads,
   C <= n1).  Each launch is checked against the plain version
   (max|d| <= 1e-5 max|plain|); a launch the card refuses is recorded with
   its error.
2. A/B, with ``--baseline``: the shipped K1/K2 (``kernels/fused.py``, the
   geometry of ``whole_geometry``) against a kernel built from SRC.cu, a
   ``whole_transform.cu`` with the same C interface, compiled with nvcc
   into a temporary directory.  K2 at n = 1,024 and K1 at 4,096 and 16,384,
   real forward and complex inverse, in turns (new, old, old, new), beside
   ``torch.fft.fft`` / ``torch.fft.ifft`` of the same tensors.
3. A/B, with ``--baseline-lm``: the shipped S1 (``kernels/engines.py``,
   ``lm_geometry``) against a ``fused_lm.cu`` with the C interface that had
   no geometry arguments, built the same way, at the seven ``LM_CASES``, in
   turns, beside ``torch.fft.fft``.

Times: ``device_ms``, the profiler's device time of the kernels whose name
holds ``whole_kernel`` (``fused_lm_kernel`` for the earlier S1; all kernels
for ``torch.fft``), median of the profiles (5 of 50 calls; 3 of 20 with
``--quick``), null where the profiler records no such kernel (it may miss
launches made by a library it did not see load); and ``graph_ms``, the time
per call of the same calls captured into one CUDA graph and replayed
(median of the replays), which holds the kernels back to back and so also
each launch's gap.  Writes ``chiprun_out/time_whole.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

SWEEP_N = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
SWEEP_B = {4096: (1, 16, 64), 16384: (1, 16, 64)}  # batches beyond B = 1, by n
CLUSTERS = (1, 2, 4, 8, 16)
AB_CASES = (("whole_transform_packed", 1024), ("whole_transform", 4096), ("whole_transform", 16384))
#: S1's shapes: ``ablate_engines``' and the uneven split (1, 32,768).
LM_CASES = ((1, 4096), (1, 16384), (1, 65536), (16, 4096), (16, 65536), (64, 4096), (1, 32768))
TOL = 1e-5


def device_ms(fn, match: str | None, calls: int, profiles: int) -> float | None:
    """Median over ``profiles`` of the per-call device time (ms) of the CUDA
    kernels whose name holds ``match`` (every kernel for None); None where a
    profile records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if match is None or match in e.key)
        if us <= 0:
            return None
        samples.append(us / calls / 1000.0)
    return statistics.median(samples)


def graph_ms(fn, calls: int, replays: int) -> float:
    """Per-call time (ms) of ``calls`` calls of ``fn`` captured into one CUDA
    graph, median over ``replays`` replays timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def build_baseline(src: Path, signatures: dict):
    """Compile ``src`` (with the port's ``csrc`` on the include path) into a
    shared library in a temporary directory; load it with ``signatures``
    (entry point: argtypes)."""
    from ..kernels import _build

    out = Path(tempfile.mkdtemp(prefix="whole_baseline_")) / f"lib{src.stem}_baseline.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def ab_times(fns: dict, match: dict, calls: int, profiles: int) -> tuple[dict, dict]:
    """Device and CUDA-graph times of ``fns`` ("new", "baseline"), in turns
    new, old, old, new; ``match[who]`` names the kernels to sum."""
    t = {"new": [], "baseline": []}
    g = {"new": [], "baseline": []}
    for who in ("new", "baseline", "baseline", "new"):
        t[who].append(device_ms(fns[who], match[who], calls, profiles))
        g[who].append(graph_ms(fns[who], calls, 2 * profiles))
    return t, g


def main(quick: bool = False, baseline: str | None = None, baseline_lm: str | None = None,
         sweep: bool = True, out_dir: str = "chiprun_out") -> dict:
    import torch

    from ..config import apply_precision
    from ..kernels import _build
    from ..kernels import engines as E
    from ..kernels import fused as K
    from ..plan import get_whole_packed_plan, get_whole_plan, on_device

    if not torch.cuda.is_available():
        raise SystemExit("time_whole needs a CUDA card")
    apply_precision()
    dev = torch.device("cuda")
    calls, profiles = (20, 3) if quick else (50, 5)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    res: dict = {"card": card, "quick": quick, "sweep": [], "lm_sweep": [], "ab": [], "lm_ab": []}
    out = Path(out_dir) / "time_whole.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.library()

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    names = ("f1r", "f1i", "twr", "twi", "f2r", "f2i")

    def case(n, complex_, packed=False, b=1):
        make = get_whole_packed_plan if packed else get_whole_plan
        sign, scale = (1, 1.0 / n) if complex_ else (-1, None)
        plan = on_device(make, n, sign, scale, device=dev)
        xr = torch.randn(b, n, generator=gen, device=dev)
        xi = torch.randn(b, n, generator=gen, device=dev) if complex_ else None
        return plan, xr, xi

    def checked(row, launch, want, scale):
        """Launch once, record the error against the plain version, then
        the times; a refused launch is recorded with its error."""
        try:
            launch()
            torch.cuda.synchronize()
        except RuntimeError as e:
            row["error"] = str(e)
        else:
            row["max_abs_err"] = max(float((g - w).abs().max()) for g, w in zip(launch(), want))
            row["ok"] = row["max_abs_err"] <= TOL * scale
            row["device_ms"] = device_ms(launch, "whole_kernel", calls, profiles)
            row["graph_ms"] = graph_ms(launch, calls, 2 * profiles)

    # ── 1. Cluster sweeps (K1, S1) ───────────────────────────────────────
    k1_sweep = ((n, b) for n in SWEEP_N for b in SWEEP_B.get(n, (1,))) if sweep else ()
    for n, b in k1_sweep:
        n1 = n // 128
        for complex_ in (False, True):
            plan, xr, xi = case(n, complex_, b=b)
            want = K.whole_transform_plain(xr, xi, plan)
            scale = max(float(w.abs().max()) for w in want)
            yr, yi = torch.empty_like(xr), torch.empty_like(xr)
            for c in CLUSTERS:
                threads = n1 * 128 // (8 * c)
                if c > n1 or threads > 1024:
                    continue
                geo = (c, threads, K.whole_smem_bytes(n1, c))
                row = {"b": b, "n": n, "kind": "complex inv" if complex_ else "real fwd",
                       "cluster": c, "threads": threads, "smem_bytes": geo[2]}

                def launch(xr=xr, xi=xi, plan=plan, yr=yr, yi=yi, geo=geo, b=b):
                    err = lib.gft_whole_split(
                        xr.data_ptr(), None if xi is None else xi.data_ptr(),
                        *(plan[k].data_ptr() for k in names), yr.data_ptr(), yi.data_ptr(),
                        b, n1, *geo, stream())
                    if err:
                        raise RuntimeError(lib.gft_error_string(err).decode())
                    return yr, yi

                checked(row, launch, want, scale)
                res["sweep"].append(row)
                print(json.dumps(row), flush=True)
                out.write_text(json.dumps(res, indent=1))

    lm_names = ("f1r", "f1i", "twr", "twi", "f2r", "f2s", "f2d")

    def lm_case(b, n):
        t = on_device(E.lm_tables, n, -1, device=dev)
        x = torch.randn(b, n, generator=gen, device=dev)
        return t, x, torch.empty_like(x), torch.empty_like(x)

    for b, n in LM_CASES if sweep else ():
        t, x, yr, yi = lm_case(b, n)
        n1, n2 = t["n1"], t["n2"]
        want = E.fused_fft_lm_plain(x, t)
        scale = max(float(w.abs().max()) for w in want)
        for c in CLUSTERS:
            threads = n // (8 * c)
            if c > n1 or threads > 1024:
                continue
            geo = (c, threads, K.whole_smem_bytes(n1, c, n2))
            row = {"b": b, "n": n, "n1": n1, "n2": n2, "cluster": c, "threads": threads,
                   "smem_bytes": geo[2]}

            def launch(x=x, t=t, yr=yr, yi=yi, geo=geo, b=b, n1=n1, n2=n2):
                err = lib.gft_fused_lm(x.data_ptr(), *(t[k].data_ptr() for k in lm_names), yr.data_ptr(),
                                       yi.data_ptr(), b, n1, n2, *geo, stream())
                if err:
                    raise RuntimeError(lib.gft_error_string(err).decode())
                return yr, yi

            checked(row, launch, want, scale)
            res["lm_sweep"].append(row)
            print(json.dumps(row), flush=True)
            out.write_text(json.dumps(res, indent=1))

    # ── 2. A/B against the baseline build ────────────────────────────────
    if baseline:
        p, i = ctypes.c_void_p, ctypes.c_int
        old = build_baseline(Path(baseline), {"gft_whole_split": [p] * 10 + [i] * 5 + [p],
                                              "gft_whole_packed": [p] * 5 + [i] * 5 + [p]})
        for name, n in AB_CASES:
            n1 = n // 128
            packed = name == "whole_transform_packed"
            for complex_ in (False, True):
                plan, xr, xi = case(n, complex_, packed)
                yr, yi = torch.empty_like(xr), torch.empty_like(xr)
                xp = None if xi is None else xi.data_ptr()

                def new(xr=xr, xi=xi, plan=plan, name=name):
                    return getattr(K, name)(xr, xi, plan)

                def prev(xr=xr, xp=xp, plan=plan, yr=yr, yi=yi, packed=packed, n1=n1):
                    geo = K.whole_geometry(1, n1, K.sm_count(dev))
                    if packed:
                        err = old.gft_whole_packed(xr.data_ptr(), xp, plan["packed"].data_ptr(),
                                                   yr.data_ptr(), yi.data_ptr(), 1, n1, *geo, stream())
                    else:
                        err = old.gft_whole_split(xr.data_ptr(), xp, *(plan[k].data_ptr() for k in names),
                                                  yr.data_ptr(), yi.data_ptr(), 1, n1, *geo, stream())
                    if err:
                        raise RuntimeError(f"baseline launch failed: error {err}")

                z = None if xi is None else torch.complex(xr, xi)

                def lib_call(xr=xr, z=z):
                    return torch.fft.fft(xr) if z is None else torch.fft.ifft(z)

                prev()
                got, want = new(), K.whole_transform_packed_plain(xr, xi, plan) if packed else \
                    K.whole_transform_plain(xr, xi, plan)
                scale = max(float(w.abs().max()) for w in want)
                errs = {"new": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                        "baseline": max(float((g - w).abs().max()) for g, w in zip((yr, yi), want))}
                t, g = ab_times({"new": new, "baseline": prev},
                                {"new": "whole_kernel", "baseline": "whole_kernel"}, calls, profiles)
                row = {"kernel": name, "n": n, "kind": "complex inv 1/n" if complex_ else "real fwd",
                       "geometry": K.whole_geometry(1, n1, K.sm_count(dev)), "device_ms": t, "graph_ms": g,
                       "torch_fft_device_ms": device_ms(lib_call, None, calls, profiles),
                       "torch_fft_graph_ms": graph_ms(lib_call, calls, 2 * profiles),
                       "max_abs_err": errs, "ok": max(errs.values()) <= TOL * scale}
                res["ab"].append(row)
                print(json.dumps(row), flush=True)
                out.write_text(json.dumps(res, indent=1))

    # ── 3. A/B against the baseline S1 ───────────────────────────────────
    if baseline_lm:
        p, i = ctypes.c_void_p, ctypes.c_int
        old = build_baseline(Path(baseline_lm), {"gft_fused_lm": [p] * 10 + [i] * 3 + [p]})
        for b, n in LM_CASES:
            t, x, yr, yi = lm_case(b, n)

            def new(x=x, t=t):
                return E.fused_fft_lm(x, t)

            def prev(x=x, t=t, yr=yr, yi=yi, b=b):
                err = old.gft_fused_lm(x.data_ptr(), *(t[k].data_ptr() for k in lm_names), yr.data_ptr(),
                                       yi.data_ptr(), b, t["n1"], t["n2"], stream())
                if err:
                    raise RuntimeError(f"baseline launch failed: error {err}")

            prev()
            got, want = new(), E.fused_fft_lm_plain(x, t)
            scale = max(float(w.abs().max()) for w in want)
            errs = {"new": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                    "baseline": max(float((g - w).abs().max()) for g, w in zip((yr, yi), want))}
            dt, gt = ab_times({"new": new, "baseline": prev},
                              {"new": "whole_kernel", "baseline": "fused_lm_kernel"}, calls, profiles)
            row = {"b": b, "n": n, "n1": t["n1"], "n2": t["n2"],
                   "geometry": K.lm_geometry(b, t["n1"], t["n2"], K.sm_count(dev)),
                   "device_ms": dt, "graph_ms": gt,
                   "torch_fft_device_ms": device_ms(lambda x=x: torch.fft.fft(x), None, calls, profiles),
                   "torch_fft_graph_ms": graph_ms(lambda x=x: torch.fft.fft(x), calls, 2 * profiles),
                   "max_abs_err": errs, "ok": max(errs.values()) <= TOL * scale}
            res["lm_ab"].append(row)
            print(json.dumps(row), flush=True)
            out.write_text(json.dumps(res, indent=1))
    out.write_text(json.dumps(res, indent=1))
    print(f"wrote {out}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer profiles and calls")
    ap.add_argument("--no-sweep", action="store_true", help="leave out the cluster sweeps")
    ap.add_argument("--baseline", help="an earlier whole_transform.cu to time against")
    ap.add_argument("--baseline-lm", help="an earlier fused_lm.cu (no geometry arguments) to time against")
    args = ap.parse_args()
    main(quick=args.quick, baseline=args.baseline, baseline_lm=args.baseline_lm, sweep=not args.no_sweep)
