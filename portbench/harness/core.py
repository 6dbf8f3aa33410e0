"""One run of one cell: set-up (the program, its inputs from the seed, the
warm-up of every shape the traffic uses), the measured window, the
comparison with the plain reference, and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import inputs, window
from .spec import BENCH_DIR, ROOT, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_fft_tpu")
STRETCH_S = 0.5  # length of the traced stretch, estimated from the warm-up
STRETCH_CALLS = (10, 2000)
METER_WARMUP_CALLS = 20  # calls profiled in set-up to count a call's device operations


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (/proc), else since ``fallback_t0``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_t0


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (gpu_fft_tpu_torch is not gpu_fft_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def import_port(precision: str):
    """The program, run as the configuration states, from this checkout."""
    os.environ["GPU_FFT_TPU_PRECISION"] = precision
    os.environ.pop("GPU_FFT_TPU_BACKEND", None)
    os.environ.pop("GPU_FFT_TPU_TORCH_DEVICE", None)
    import gpu_fft_tpu_torch as port

    where = Path(port.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"gpu_fft_tpu_torch was imported from {where}, not from this checkout")
    if port.config.PRECISION != precision:
        raise RuntimeError(f"the program runs precision {port.config.PRECISION!r}, "
                           f"the configuration states {precision!r}")
    return port


def _load_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def devices_of(cell: Cell, device=None) -> list[torch.device]:
    """The cards a run of ``cell`` uses: the first ``cell.chips`` CUDA
    devices, or ``[device]`` where one is given (the CPU tests)."""
    if device is not None:
        return [torch.device(device)]
    return [torch.device(f"cuda:{i}") for i in range(cell.chips)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, devices, t0: float,
             port=None) -> tuple[dict, list]:
    """Run ``cell`` once on ``devices`` (a list; the inputs live on the
    first).  Returns the result (the line's object without the checks) and
    the checks: (name, value, limit) of each number compared."""
    tr, cfg = cell.traffic, cell.config
    guarantees = cfg["guarantees"]
    if port is None:
        port = import_port(guarantees["precision"])
    marks = {"imported": process_age_s(t0)}
    kind = tr["op"]
    op_mod = importlib.import_module(f"portbench.ops.{kind}")
    ref_mod = importlib.import_module(f"portbench.reference.{kind}")
    work = importlib.import_module(f"portbench.work.{kind}").count(tuple(tr["shape"]), tr["params"])
    params = tr["params"]
    devices = [torch.device(d) for d in (devices if isinstance(devices, (list, tuple)) else [devices])]
    dev = devices[0]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)

    pool = inputs.make_pool(cfg, tr, seed, dev)
    _sync(dev)
    marks["inputs made"] = process_age_s(t0)

    def op(x):
        return op_mod.call(port, x, params)

    # Warm-up: every pool input once, synchronously (the first call builds
    # and loads the kernels), then ``warmup_calls`` rounds of the pool in the
    # traffic's own dispatch, so that the allocator holds what calls in
    # flight need before the window opens.
    for x in pool:
        op(x)
        _sync(dev)
    marks["first calls"] = process_age_s(t0)
    warm = window.Caller(op, pool, tr, dev, None)
    t = time.perf_counter()
    calls = tr["warmup_calls"] * len(pool)
    for i in range(calls):
        warm.call(i, window.Stats(), record=False)
    warm.sync()
    per_call = (time.perf_counter() - t) / calls
    del warm
    marks["warmed up"] = process_age_s(t0)
    if guarantees.get("tf32") is False and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on after the warm-up; the configuration states it off")
    meter = None
    if cuda and not trace and any(m["source"] == "device_trace" for m in cell.end_to_end):
        from . import tracing

        def one():
            op(pool[0])
            _sync(dev)

        per_call = 0
        for _ in range(3):  # the profiler now and then records nothing
            per_call = tracing.ops_per_call(one, METER_WARMUP_CALLS)
            if per_call:
                break
        if per_call:
            meter = tracing.WindowMeter(len(devices), per_call)
        else:
            print("portbench: the profiler recorded no device operation in three profiled "
                  "warm-ups; the device-trace metrics are left out", file=sys.stderr)
    stretch = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from . import tracing

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            op(pool[0])
            _sync(dev)
        lo, hi = STRETCH_CALLS
        count = int(min(hi, max(lo, round(STRETCH_S / max(per_call, 1e-6)))))
        first = 2 * tr["depth"] + 2
        stretch = (first, lambda c, s, i: tracing.profile_calls(c, s, i, count, len(devices)))
    setup_s = process_age_s(t0)
    print("portbench set-up, seconds since the process started: "
          + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()) + f", window opens {setup_s:.2f}",
          file=sys.stderr)

    reservoir = window.Reservoir(tr["sample"], seed)
    caller = window.Caller(op, pool, tr, dev, reservoir)
    stats = window.run(caller, seconds, stretch, meter)
    del caller
    slow = sorted(stats.host_s)[-5:]
    print(f"portbench window: {stats.calls} calls in {stats.t_close - stats.t_open:.3f} s; "
          "longest host times in the entry call (ms) "
          + ", ".join(f"{1e3 * v:.3f}" for v in reversed(slow)), file=sys.stderr)
    if meter is not None:
        print(f"portbench device meter: {meter.calls} calls in {meter.chunks - len(meter.dropped)} "
              f"of {meter.chunks} chunks, {meter.per_call} device operations a call, busy "
              f"{meter.busy_s:.6f} s; chunks left out (calls, operations recorded): "
              f"{meter.dropped or 'none'}", file=sys.stderr)

    memory_peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    samples = reservoir.kept
    del reservoir
    if cuda:
        torch.cuda.empty_cache()

    # The comparison: every sampled call against the float64 reference.
    worst: dict[str, float] = {}
    refs = {}
    for _, slot, out in samples:
        if slot not in refs:
            refs[slot] = ref_mod.reference(pool[slot], params, "float64")
        for name, v in ref_mod.judge(out, refs[slot]).items():
            v = v if math.isfinite(v) else math.inf
            worst[name] = max(worst.get(name, 0.0), v)
    del refs, samples
    checks = [(name, worst.get(name, math.inf), float(lim["limit"]))
              for name, lim in cell.limits.items()]
    correct = (stats.failed == 0 and stats.calls > 0 and bool(checks)
               and all(v <= lim for _, v, lim in checks))

    # Every metric is read by its own reader (metrics/<name>.py) from one
    # context: the end-to-end metrics in an untraced run, the per-layer
    # metrics in a traced one.
    ctx = SimpleNamespace(cell=cell, work=work, setup_s=setup_s, stats=stats,
                          window_s=stats.t_close - stats.t_open, host_s=stats.host_s,
                          trace=stats.trace, events=stats.events,
                          traced_calls=stats.traced_calls, chips=len(devices),
                          window_busy_s=meter.busy_s if meter is not None and meter.calls else None,
                          metered_calls=meter.calls if meter is not None else 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = _load_reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v if math.isfinite(v) else None, "unit": m["unit"]}

    result = {"correct": correct, "attempted": stats.calls, "failed": stats.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                         "count": len(devices),
                         "memory_peak_bytes": memory_peak}}
    if trace and stats.trace is not None:
        result["device"]["busy_s"] = stats.trace["busy_s"]
        result["device"]["window_s"] = stats.trace["window_s"]
        if cuda:
            result["device"]["power"] = power_limit()
        result["breakdown"] = {"device_ops": stats.trace["device_ops"],
                               "idle_gaps": stats.trace["idle_gaps"]}
    return result, checks
