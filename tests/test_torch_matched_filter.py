"""``matched_filter_device`` (``ops/matched.py``) on the CPU against the
benchmark's float64 reference (``portbench/reference/matched_filter.py``,
PyCBC's ``matched_filter_core`` written out), at one size in the
whole-transform band (T = 3, N = 2^12) and one staged size (T = 2,
N = 2^17, K3's plain version and stage B), on a simulated segment with
template 0 injected (``portbench/data/gw_segment.py``); its two operators
(``kernels/matched.py``) on the CPU against the ATen formula they replace.

Marked ``cuda``: the kernels against their plain versions on a card, run
there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_matched_filter.py

This file imports no jax.
"""

import doctest

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.kernels.matched as M
from gpu_fft_tpu_torch.config import apply_precision
from gpu_fft_tpu_torch.ops import matched
from gpu_fft_tpu_torch.scripts import time_matched
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


# ── The two operators (kernels/matched.py) ──────────────────────────────────


def _old_formula(x, params, valid=True):
    """matched_filter_device's body before its passes became operators: the
    ATen passes as they were, for the bit-for-bit check of the CPU path."""
    lay = layout(x.shape, params)
    hr, hi, sr, si, s_psd = x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0]
    t, n, kmin, delta_f = hr.shape[0], lay["n"], lay["kmin"], lay["delta_f"]
    start, stop = (lay["start"], lay["stop"]) if valid else (0, n)
    band = slice(kmin, n // 2)
    hr, hi = hr[:, band], hi[:, band]
    w = s_psd[band].reciprocal()
    ar, ai = sr[band] * w, si[band] * w
    qr = torch.zeros((t, n), dtype=torch.float32)
    qi = torch.zeros((t, n), dtype=torch.float32)
    qr[:, band] = torch.addcmul(hr * ar, hi, ai)
    qi[:, band] = torch.addcmul(hr * ai, hi, ar, value=-1.0)
    sigmasq = (4.0 * delta_f) * (torch.addcmul(hr * hr, hi, hi) * w).sum(dim=-1)
    norm = (n * 4.0 * delta_f) * sigmasq.rsqrt()
    yr, yi = gt.ifft_device(qr, qi)
    snr_r = yr[:, start:stop] * norm[:, None]
    snr_i = yi[:, start:stop] * norm[:, None]
    peak_sq, at = torch.addcmul(snr_r * snr_r, snr_i, snr_i).max(dim=-1)
    return (qr, qi, sigmasq), ((snr_r, snr_i), peak_sq.sqrt(), at + start)


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_cpu_operators_are_the_old_aten_formula_bit_for_bit(cases, size, valid):
    x, params, _ = cases[size]
    lay = layout(x.shape, params)
    (oqr, oqi, osig), ((osr, osi), opeak, oat) = _old_formula(x, params, valid)
    (sr, si), peak, at = _filter(x, params, **({} if valid else {"valid": None}))
    for got, want in ((sr, osr), (si, osi), (peak, opeak), (at, oat)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    qr, qi, parts = torch.ops.gpu_fft_tpu_torch.matched_correlate(x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0],
                                                                  lay["kmin"])
    assert parts.shape == (x.shape[0] - 2, 1)
    assert torch.equal(qr, oqr) and torch.equal(qi, oqi)
    assert torch.equal((4.0 * lay["delta_f"]) * parts.sum(dim=-1), osig)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_counts_count_plain_calls_on_the_cpu(cases, size):
    x, params, _ = cases[size]
    M.reset_counts()
    _filter(x, params)
    _filter(x, params)
    assert {k: (c.launches, c.plain_calls) for k, c in M.COUNTS.items()} == {
        "matched_correlate": (0, 2), "matched_snr": (0, 2)}
    M.reset_counts()
    assert all((c.launches, c.plain_calls) == (0, 0) for c in M.COUNTS.values())


def test_inputs_that_require_grad_take_the_aten_path(cases):
    """Templates that require grad skip the operators (which autograd does
    not follow): the same outputs, no operator call, a gradient."""
    x, params, _ = cases["band"]
    (wr, wi), wpeak, wat = _filter(x, params)
    y = x.clone().requires_grad_(True)
    M.reset_counts()
    (sr, si), peak, at = _filter(y, params)
    assert all(c.plain_calls == 0 for c in M.COUNTS.values())
    assert torch.equal(sr.detach(), wr) and torch.equal(si.detach(), wi)
    assert torch.equal(peak.detach(), wpeak) and torch.equal(at, wat)
    peak.sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all() and y.grad[2:].abs().sum() > 0


@pytest.mark.parametrize("size", sorted(SIZES))
def test_operator_spans_nest_in_the_entry_span_and_open_no_launch_span(cases, size):
    x, params, _ = cases[size]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _filter(x, params)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("gft.")]
    assert not [name for name, _, _ in spans if name.startswith("gft.launch.")]
    (a, b), = [(s, e) for name, s, e in spans if name == "gft.entry.matched_filter"]
    ours = [(name, s, e) for name, s, e in spans if name.startswith("gft.entry.matched_filter.")]
    assert sorted(name for name, _, _ in ours) == ["gft.entry.matched_filter.correlate",
                                                   "gft.entry.matched_filter.snr"]
    assert all(a <= s and e <= b for _, s, e in ours)


def test_fake_kernels_give_the_cpu_shapes(cases):
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, params, _ = cases["staged"]
    lay = layout(x.shape, params)
    args = (x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0])
    real = torch.ops.gpu_fft_tpu_torch.matched_correlate(*args, lay["kmin"])
    win = (lay["delta_f"], lay["start"], lay["stop"])
    real_snr = torch.ops.gpu_fft_tpu_torch.matched_snr(real[0], real[1], real[2], *win)
    with FakeTensorMode() as mode:
        fake = torch.ops.gpu_fft_tpu_torch.matched_correlate(*(mode.from_tensor(v) for v in args), lay["kmin"])
        fake_snr = torch.ops.gpu_fft_tpu_torch.matched_snr(*fake, *win)
    for f, r in zip((*fake, *fake_snr), (*real, *real_snr)):
        assert (f.shape, f.dtype) == (r.shape, r.dtype)


@pytest.mark.parametrize("t,n,length", [(64, 1 << 20, 720896), (1, 1 << 17, 92160), (1, 1 << 22, 2883584),
                                        (3, 1 << 12, 3584), (8, 1 << 22, 1 << 22), (1, 16, 16), (64, 1 << 17, 90113),
                                        (100000, 1 << 12, 7)])
def test_geometry_covers_the_window_once(t, n, length):
    """The SNR's blocks cover the window once, each at least one element,
    whole passes of 1,024 but the last; the correlation's partials at most
    512 a template and no more than its 1,024-bin tiles."""
    tile_blocks, seg, blocks = M.matched_geometry(t, n, length)
    assert 1 <= tile_blocks <= min(512, -(-n // 1024))
    assert seg % 1024 == 0 and seg <= max(8192, 1024 * -(-length // 1024))
    assert (blocks - 1) * seg < length <= blocks * seg


# ── On the card (``-m cuda``): the kernels against their plain versions ────

RTOL_CARD = 1e-6  # the same roundings as the plain passes; only the norm's sum runs in another order
CARD_SHAPES = [(3, 1 << 12), (2, 1 << 17), (64, 1 << 20)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    apply_precision()
    return torch.device("cuda")


def _card_input(t, n, dev):
    """The benchmark's layout (``scripts/time_matched.py``): strided template
    rows, every other one 8 bytes off a 16-byte boundary; kmin and the
    window in the cell's proportions."""
    kmin, start, stop = time_matched.layout(n)
    return time_matched.make_input(t, n, dev, t * n), kmin, (start, stop)


def _rel(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / max(float(w.abs().max()) for w in want)


@pytest.mark.cuda
@pytest.mark.parametrize("valid", ["cell", "whole", "unaligned"])
@pytest.mark.parametrize("t,n", CARD_SHAPES)
def test_kernels_agree_with_the_plain_passes_on_the_card(dev, t, n, valid):
    """``unaligned``: a window whose start and length are no multiple of 4,
    which the SNR kernel reads and writes 4 bytes at a time."""
    x, kmin, (start, stop) = _card_input(t, n, dev)
    start, stop = {"cell": (start, stop), "whole": (0, n), "unaligned": (start + 1, stop - 2)}[valid]
    args = (x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0], kmin)
    assert x[3, 0].data_ptr() % 16 == 8  # the strided, misaligned rows
    qr, qi, parts = M.matched_correlate(*args)
    pr, pi, pparts = M.matched_correlate_plain(*args)
    assert _rel((qr, qi), (pr, pi)) <= RTOL_CARD
    assert not qr[:, :kmin].any() and not qi[:, n // 2:].any()
    sig, psig = parts.double().sum(dim=-1), pparts.double().sum(dim=-1)
    assert float(((sig - psig) / psig).abs().max()) <= RTOL_CARD
    yr, yi = gt.ifft_device(qr, qi)
    sr, si, peak, at = M.matched_snr(yr, yi, parts, 0.5, start, stop)
    wr, wi, _, _ = M.matched_snr_plain(yr, yi, pparts, 0.5, start, stop)
    assert sr.shape == (t, stop - start) and at.dtype == torch.int64
    assert _rel((sr, si), (wr, wi)) <= RTOL_CARD
    mag = torch.addcmul(sr * sr, si, si)
    assert torch.equal(peak, mag.max(dim=-1).values.sqrt())
    assert torch.equal(at, mag.argmax(dim=-1) + start)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", CARD_SHAPES)
def test_one_call_launches_the_kernels_once_on_the_card(dev, t, n):
    """The correlation once, K3 and K4 once each (the band's kernel below
    2^17), the SNR's two kernels; no plain version."""
    x, kmin, window = _card_input(t, n, dev)
    call = lambda: gt.matched_filter_device(x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0],  # noqa: E731
                                            delta_f=0.5, kmin=kmin, valid=window)
    call()
    torch.cuda.synchronize()
    K.reset_counts()
    M.reset_counts()
    call()
    torch.cuda.synchronize()
    transform = {"whole_transform": 1} if n <= 65536 else {"stage_a": 1, "stage_b": 1}
    assert {k: c.launches for k, c in K.COUNTS.items() if c.launches} == transform
    assert {k: (c.launches, c.plain_calls) for k, c in M.COUNTS.items()} == {
        "matched_correlate": (1, 0), "matched_snr": (2, 0)}
    assert not any(c.plain_calls for c in K.COUNTS.values())


@pytest.mark.cuda
def test_kernel_spans_are_the_entry_ops_on_the_card(dev):
    """The kernels' C calls sit in ``gft.entry.matched_filter.*`` spans, so
    their device time is the entry layer's; K3 and K4 keep theirs."""
    x, kmin, window = _card_input(2, 1 << 17, dev)
    call = lambda: gt.matched_filter_device(x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0],  # noqa: E731
                                            delta_f=0.5, kmin=kmin, valid=window)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.name.startswith("gft.")]
    entry = "gft.entry.matched_filter"
    assert [n for n in names if n.startswith(entry + ".")] == [entry + ".correlate", entry + ".snr",
                                                               entry + ".peak"]
    assert sorted(n for n in names if n.startswith("gft.launch.")) == ["gft.launch.stage_a", "gft.launch.stage_b"]
