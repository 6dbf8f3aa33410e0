"""The port's profiler spans (``utils/profiling.py:span``): off, they call no
profiler range; under a torch profiler, the entry, dispatch, engine and
launch layers nest as ``gft.entry.* ⊃ gft.dispatch ⊃ gft.engine.* ⊃
gft.launch.*``; and the launch helper counts ``COUNTS`` as before.

The ``cuda`` cases run on a card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py

This file imports no jax.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels._build as B
import gpu_fft_tpu_torch.kernels.fused as K
from gpu_fft_tpu_torch.config import apply_precision
from gpu_fft_tpu_torch.utils import profiling


def _signal(n, b=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n if b is None else (b, n), generator=g)


# Each entry op and a call of it on CPU tensors.
ENTRY_CALLS = {
    "fft": lambda: gt.fft_device(_signal(4096)),
    "ifft": lambda: gt.ifft_device(_signal(4096), _signal(4096, seed=1)),
    "rfft": lambda: gt.rfft_device(_signal(1024, 2)),
    "irfft": lambda: gt.irfft_device(_signal(513), _signal(513, seed=1)),
    "fft2": lambda: gt.fft2_device(_signal(64, 32).reshape(32, 64)),
    "ifft2": lambda: gt.ifft2_device(_signal(64, 32).reshape(32, 64), _signal(64, 32, 1).reshape(32, 64)),
    "welch": lambda: gt.welch_device(_signal(4096), nperseg=256),
}


def _gft_events(prof):
    """The ``gft.`` ranges of a stopped profile: (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("gft.")]


def _chains(prof):
    """For each ``gft.`` range with none inside it: the names from the
    outermost enclosing range down to it."""
    ev = sorted(_gft_events(prof), key=lambda e: (e[1], -e[2]))
    chains = []
    for i, (name, a, b) in enumerate(ev):
        inside = [o for j, o in enumerate(ev) if j != i and a <= o[1] and o[2] <= b]
        if inside:
            continue
        outer = [o for j, o in enumerate(ev) if j != i and o[1] <= a and b <= o[2]]
        chains.append(tuple(o[0] for o in sorted(outer, key=lambda o: (o[1], -o[2]))) + (name,))
    return chains


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


# ── The gate ────────────────────────────────────────────────────────────────


def test_flag_is_true_exactly_while_a_profiler_records():
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag() is True
    assert flag() is False


def test_span_is_one_shared_no_op_with_no_profiler():
    a, b = profiling.span("gft.entry.fft"), profiling.span("gft.dispatch")
    assert a is b
    with a:
        pass


@pytest.mark.parametrize("op", sorted(ENTRY_CALLS))
def test_no_profiler_range_is_made_with_no_profiler(monkeypatch, op):
    made = []

    def counting(name, *args, **kwargs):
        made.append(name)
        return profiling._NO_SPAN

    monkeypatch.setattr(profiling, "_Range", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    ENTRY_CALLS[op]()
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        ENTRY_CALLS[op]()
    assert made and made[0] == f"gft.entry.{op}"


def test_span_shows_under_a_cpu_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("gft.engine.whole"):
            torch.ones(4) + 1
    names = [e[0] for e in _gft_events(prof)]
    assert names == ["gft.engine.whole"]


# ── The span tree ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("op", sorted(ENTRY_CALLS))
def test_every_entry_op_is_its_own_outermost_span(op):
    chains = _chains(_profiled(ENTRY_CALLS[op]))
    assert chains and all(c[0] == f"gft.entry.{op}" for c in chains)
    assert all(c[-1].startswith("gft.engine.") for c in chains), chains


def test_fft_device_16384_runs_the_whole_engine_under_dispatch():
    assert _chains(_profiled(lambda: gt.fft_device(_signal(16384)))) == [
        ("gft.entry.fft", "gft.dispatch", "gft.engine.whole")]


def test_fft_device_65536_runs_a_four_step_under_dispatch():
    (chain,) = _chains(_profiled(lambda: gt.fft_device(_signal(65536))))
    assert chain[:2] == ("gft.entry.fft", "gft.dispatch")
    assert chain[2] in ("gft.engine.fourstep", "gft.engine.fourstep_half", "gft.engine.fourstep_folded")
    assert len(chain) == 3


def test_welch_device_nests_its_entry_ops():
    (chain,) = _chains(_profiled(lambda: gt.welch_device(_signal(100000), fs=1e4, nperseg=1024)))
    assert chain[:5] == ("gft.entry.welch", "gft.entry.rfft", "gft.entry.fft", "gft.dispatch",
                         chain[4])
    assert chain[4].startswith("gft.engine.") and len(chain) == 5


def test_staged_transform_has_stage_a_and_stage_b():
    chains = _chains(_profiled(lambda: gt.fft_device(_signal(1 << 17))))
    assert [c[-1] for c in chains] == ["gft.engine.stage_a", "gft.engine.stage_b"]
    assert all(c[:2] == ("gft.entry.fft", "gft.dispatch") for c in chains)


def test_spans_leave_the_result_unchanged():
    x = _signal(16384)
    want = gt.fft_device(x)
    with profile(activities=[ProfilerActivity.CPU]):
        got = gt.fft_device(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ── The launch helper and COUNTS ────────────────────────────────────────────


def test_launch_counts_once_and_spans_the_call(monkeypatch):
    monkeypatch.setattr(B, "check", lambda err, kernel: None)
    K.reset_counts()
    args = []
    K._launch(K.COUNTS, "whole_transform", lambda *a: args.append(a) or 0, 1, 2, 3)
    assert args == [(1, 2, 3)]
    assert K.COUNTS["whole_transform"].launches == 1
    assert sum(c.launches for c in K.COUNTS.values()) == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        K._launch(K.COUNTS, "stage_a", lambda *a: 0)
    assert [e[0] for e in _gft_events(prof)] == ["gft.launch.stage_a"]
    assert K.COUNTS["stage_a"].launches == 1 and K.COUNTS["whole_transform"].launches == 1
    K.reset_counts()


def test_a_failed_launch_raises_and_is_not_counted(monkeypatch):
    def check(err, kernel):
        if err:
            raise RuntimeError(f"{kernel}: CUDA error {err}")

    monkeypatch.setattr(B, "check", check)
    K.reset_counts()
    with pytest.raises(RuntimeError, match="stage_a_legacy: CUDA error 7"):
        K._launch(K.COUNTS, "stage_a_legacy", lambda *a: 7)
    assert K.COUNTS["stage_a_legacy"].launches == 0
    K.reset_counts()


@pytest.mark.parametrize("traced", [False, True])
def test_plain_calls_count_as_before(traced):
    K.reset_counts()
    if traced:
        _profiled(lambda: gt.fft_device(_signal(16384)))
    else:
        gt.fft_device(_signal(16384))
    assert K.COUNTS["whole_transform"].plain_calls == 1
    assert sum(c.plain_calls for c in K.COUNTS.values()) == 1
    assert sum(c.launches for c in K.COUNTS.values()) == 0
    K.reset_counts()


# ── On the card ─────────────────────────────────────────────────────────────


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    apply_precision()
    return torch.device("cuda")


@pytest.mark.cuda
def test_launch_span_sits_inside_the_whole_engine_on_the_card(dev):
    x = _signal(16384).to(dev)
    gt.fft_device(x)
    torch.cuda.synchronize()
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gt.fft_device(x)
        torch.cuda.synchronize()
    assert _chains(prof) == [("gft.entry.fft", "gft.dispatch", "gft.engine.whole",
                              "gft.launch.whole_transform")]
    assert K.COUNTS["whole_transform"].launches == 1
    K.reset_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 65536])
def test_spans_add_no_device_operation_under_a_cuda_only_profile(dev, n):
    from torch._C import _autograd

    x = _signal(n).to(dev)
    gt.fft_device(x)
    torch.cuda.synchronize()

    def ops(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                gt.fft_device(x)
            torch.cuda.synchronize()
        cuda = _autograd.DeviceType.CUDA
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda and not e.is_user_annotation()]

    one = ops(1)
    assert not any(name.startswith("gft.") for name in one)
    assert len(ops(4)) == 4 * len(one)
    if n == 16384:
        assert len(one) == 1  # K1 alone
    assert np.isfinite(float(gt.fft_device(x)[0].abs().max()))
