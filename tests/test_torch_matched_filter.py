"""``matched_filter_device`` (``ops/matched.py``) on the CPU against the
benchmark's float64 reference (``portbench/reference/matched_filter.py``,
PyCBC's ``matched_filter_core`` written out), at one size in the
whole-transform band (T = 3, N = 2^12) and one staged size (T = 2,
N = 2^17, K3's plain version and stage B), on a simulated segment with
template 0 injected (``portbench/data/gw_segment.py``).

This file imports no jax.
"""

import doctest

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpu_fft_tpu_torch as gt
from gpu_fft_tpu_torch.ops import matched
from portbench.data import gw_segment
from portbench.reference import matched_filter as reference
from portbench.work.matched_filter import layout

SEED = 2**33 + 2024
# Sizes: (T, N, start pad s, end pad s) at 2,048 Hz.
SIZES = {"band": (3, 1 << 12, 0.25, 0.125), "staged": (2, 1 << 17, 8.0, 2.0)}
# fp32 against float64 reads ~1e-7 at N <= 2^17 (the transform's rounding,
# ~log2(N) * eps over the SNR's norm); the reference's products in TF32 read
# ~4e-4 on the card (PERF.md §2).  1e-5 lies between, with room either side.
RTOL_L2 = 1e-5


def _case(size):
    t, n, pad0, pad1 = SIZES[size]
    pads = {"segment_start_pad_s": pad0, "segment_end_pad_s": pad1}
    data = {"kind": "gw_segment", "sample_rate": 2048.0, "f_low": 20.0, "chirp_mass": [1.0, 10.0],
            "snr": 20.0, **pads}
    params = {"sample_rate": 2048.0, "f_low": 20.0, **pads}
    shape = (t + 2, 2, n // 2 + 1)
    x = gw_segment.make(shape, data, SEED, 0, "cpu")
    return x, params, gw_segment.injection(shape, data, SEED)


@pytest.fixture(scope="module")
def cases():
    return {size: _case(size) for size in SIZES}


def _filter(x, params, **kw):
    lay = layout(x.shape, params)
    kw = {"kmin": lay["kmin"], "valid": (lay["start"], lay["stop"]), **kw}
    return gt.matched_filter_device(x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0],
                                    delta_f=lay["delta_f"], **kw)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_snr_agrees_with_the_float64_reference(cases, size):
    x, params, _ = cases[size]
    (sr, si), _, _ = _filter(x, params)
    lay = layout(x.shape, params)
    assert sr.shape == (x.shape[0] - 2, lay["stop"] - lay["start"])
    assert sr.dtype == torch.float32
    got = reference.judge((sr, si), reference.reference(x, params, "float64"))
    assert got["rel_l2"] <= RTOL_L2, got


@pytest.mark.parametrize("size", sorted(SIZES))
def test_peak_of_template_zero_lands_on_the_injection(cases, size):
    x, params, at = cases[size]
    (sr, si), peak, where = _filter(x, params)
    assert int(where[0]) == at
    assert 15.0 < float(peak[0]) < 25.0  # optimal SNR 20 plus the noise's share
    torch.testing.assert_close(peak, torch.hypot(sr, si).max(dim=-1).values, rtol=1e-6, atol=0)


def test_valid_window_is_a_slice_of_the_whole_series(cases):
    x, params, _ = cases["band"]
    lay = layout(x.shape, params)
    (fr, fi), fpeak, fat = _filter(x, params, valid=None)
    (vr, vi), _, _ = _filter(x, params)
    assert fr.shape == (x.shape[0] - 2, lay["n"])
    assert torch.equal(fr[:, lay["start"]:lay["stop"]], vr)
    assert torch.equal(fi[:, lay["start"]:lay["stop"]], vi)
    torch.testing.assert_close(fpeak, torch.hypot(fr, fi).max(dim=-1).values, rtol=1e-6, atol=0)
    assert fat.shape == (x.shape[0] - 2,)


def test_bins_outside_kmin_kmax_are_not_read(cases):
    """q̃ is zero outside [kmin, N/2): what the data hold there (DC, the
    bins under f_low, Nyquist) does not reach ρ."""
    x, params, _ = cases["band"]
    lay = layout(x.shape, params)
    y = x.clone()
    y[0, :, : lay["kmin"]] = 1e6
    y[2:, :, lay["n"] // 2:] = -1e6
    (ar, ai), _, _ = _filter(x, params)
    (br, bi), _, _ = _filter(y, params)
    assert torch.equal(ar, br) and torch.equal(ai, bi)


def test_staged_size_runs_stage_a_and_stage_b_inside_the_entry_span(cases):
    x, params, _ = cases["staged"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _filter(x, params)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("gft.")]
    entry = [(a, b) for name, a, b in spans if name == "gft.entry.matched_filter"]
    assert len(entry) == 1
    a, b = entry[0]
    inner = {name for name, s, e in spans if a <= s and e <= b}
    assert {"gft.entry.ifft", "gft.dispatch", "gft.engine.stage_a", "gft.engine.stage_b"} <= inner


@pytest.mark.parametrize("size", sorted(SIZES))
def test_counts_add_the_templates_of_each_call(cases, size):
    x, params, _ = cases[size]
    c = matched.COUNTS["matched_filter"]
    calls, templates = c.calls, c.templates
    _filter(x, params)
    _filter(x, params)
    assert (c.calls, c.templates) == (calls + 2, templates + 2 * (x.shape[0] - 2))
    matched.reset_counts()
    assert (c.calls, c.templates) == (0, 0)


def _bad_calls(x):
    h = x.shape[-1]
    hr, hi, sr, si, s = x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0]
    ok = {"delta_f": 0.5, "kmin": 40}
    return {
        "templates_1d": ((hr[0], hi[0], sr, si, s), ok),
        "templates_differ": ((hr, hi[:, :-1], sr, si, s), ok),
        "not_power_of_two": ((hr[:, :-2], hi[:, :-2], sr[:-2], si[:-2], s[:-2]), ok),
        "data_length": ((hr, hi, sr[:-1], si, s), ok),
        "psd_length": ((hr, hi, sr, si, s[: h // 2]), ok),
        "no_template": ((hr[:0], hi[:0], sr, si, s), ok),
        "delta_f": ((hr, hi, sr, si, s), {**ok, "delta_f": 0.0}),
        "kmin_negative": ((hr, hi, sr, si, s), {**ok, "kmin": -1}),
        "kmin_at_nyquist": ((hr, hi, sr, si, s), {**ok, "kmin": h - 1}),
        "kmin_past_nyquist": ((hr, hi, sr, si, s), {**ok, "kmin": h}),
        "valid_reversed": ((hr, hi, sr, si, s), {**ok, "valid": (100, 50)}),
        "valid_past_n": ((hr, hi, sr, si, s), {**ok, "valid": (0, 2 * h)}),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls(torch.zeros(5, 2, 2049))))
def test_bad_shapes_and_bins_raise(cases, case):
    x, _, _ = cases["band"]
    args, kw = _bad_calls(x)[case]
    with pytest.raises(ValueError, match="matched_filter_device"):
        gt.matched_filter_device(*args, **kw)


def test_doctest():
    res = doctest.testmod(matched, verbose=False)
    assert res.failed == 0 and res.attempted >= 3, res
