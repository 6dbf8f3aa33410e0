"""Plans of the PyTorch port against the JAX package's: identical tables,
identical dispatch predicates, and the deliberate packed-plan guard."""

from collections import Counter

import numpy as np
import pytest
import torch

import gpu_fft_tpu.plan as jplan
import gpu_fft_tpu.tuning as jtuning
import gpu_fft_tpu_torch.plan as tplan
import gpu_fft_tpu_torch.tuning as ttuning


def _assert_tables_equal(a, b, path=""):
    """Bit-equal arrays (same dtype and shape), equal scalars, same keys."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_tables_equal(a[k], b[k], f"{path}.{k}")
        return
    if hasattr(a, "shape"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path
        return
    assert a == b, (path, a, b)


FUSED_CASES = [
    (n, sign, wide, scale)
    for n in (256, 4096, 65536)
    for sign in (-1, 1)
    for wide in (False, True)
    for scale in (None, 1.0 / n)
]


@pytest.mark.parametrize("n,sign,wide,scale", FUSED_CASES)
def test_fused_tables_bit_equal(n, sign, wide, scale):
    jp = jplan.get_fused_plan(n, sign, wide=wide, scale=scale)
    tp = tplan.get_fused_plan(n, sign, wide=wide, scale=scale)
    assert (tp.n, tp.sign, tp.kind, tp.n1, tp.n2) == (jp.n, jp.sign, jp.kind, jp.n1, jp.n2)
    _assert_tables_equal(jp.tables, tp.tables)


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("sign,scale", [(-1, None), (1, None), (1, "inv")])
def test_whole_tables_bit_equal(n, sign, scale):
    s = None if scale is None else 1.0 / n
    _assert_tables_equal(jplan.get_whole_plan(n, sign, scale=s), tplan.get_whole_plan(n, sign, scale=s))


@pytest.mark.parametrize("sign,scale", [(-1, None), (1, 1.0 / 1024)])
def test_whole_packed_tables_bit_equal(sign, scale):
    _assert_tables_equal(
        jplan.get_whole_packed_plan(1024, sign, scale=scale),
        tplan.get_whole_packed_plan(1024, sign, scale=scale),
    )


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("ct", [None, 512, 1024])
def test_stage_a_tables_bit_equal(sign, ct):
    n = 1 << 17
    _assert_tables_equal(jplan.get_stage_a_plan(n, sign, ct=ct), tplan.get_stage_a_plan(n, sign, ct=ct))


@pytest.mark.parametrize(
    "get_j,get_t,args",
    [
        (jplan.get_fused_plan, tplan.get_fused_plan, (4096, -1)),
        (jplan.get_fused_plan, tplan.get_fused_plan, (256, 1)),
        (jplan.get_whole_plan, tplan.get_whole_plan, (4096, 1)),
        (jplan.get_whole_packed_plan, tplan.get_whole_packed_plan, (1024, -1)),
        (jplan.get_stage_a_plan, tplan.get_stage_a_plan, (1 << 17, -1)),
    ],
)
def test_from_jax_plan_round_trips(get_j, get_t, args):
    jp, tp = get_j(*args), get_t(*args)
    got = tplan.from_jax_plan(jp)
    if isinstance(tp, tplan.FusedPlan):
        assert isinstance(got, tplan.FusedPlan) and got == tp
        _assert_tables_equal(got.tables, tp.tables)
    else:
        _assert_tables_equal(got, tp)


def test_packed_plan_guard_is_a_recorded_divergence():
    """n = 32768 (n1 = 256): the JAX plan fails with an opaque broadcast
    error; the port rejects the size by name."""
    with pytest.raises(ValueError, match="broadcast"):
        jplan.get_whole_packed_plan(32768, -1)
    with pytest.raises(ValueError, match=r"n1 = n/128 <= 128"):
        tplan.get_whole_packed_plan(32768, -1)
    _assert_tables_equal(jplan.get_whole_packed_plan(16384, -1), tplan.get_whole_packed_plan(16384, -1))


# The whole-transform band on the H100 (``tuning._H100``), from the sweep of
# K1/K2 against the torch four-step (``scripts/time_whole.py --band``):
# K1/K2 won at every swept (B, n), n 1,024 ... 65,536, B 1 ... 4,096 with
# B * n <= 2^26, so the band is that swept set's edge.
H100_BAND = {"whole_n_max": 1 << 16, "whole_batch_max": 4096, "whole_samples_max": 1 << 26}


def _h100_band(b, n):
    """Whether (b, n) lies in the H100's whole-transform band ("full")."""
    return 1024 <= n <= 65536 and n % 128 == 0 and b <= 4096 and b * n <= 1 << 26


@pytest.mark.parametrize("b", [1, 2, 3, 16, 64])
@pytest.mark.parametrize("n", [2, 256, 512, 1024, 2048, 4096, 16384, 32768, 65536])
def test_dispatch_predicates_match(b, n):
    """The four-step's predicates are the JAX package's; the whole band is
    the H100's, wider than the v5e band the JAX package keeps."""
    assert tplan.whole_kernel_applies(b, n) == _h100_band(b, n)
    assert tplan.wide_split_applies(b, n) == jplan.wide_split_applies(b, n)
    assert tplan.use_folded_layout(b, n) == jplan.use_folded_layout(b, n)
    assert tplan.half_spectrum_applies(n) == jplan.half_spectrum_applies(n)
    assert tplan.fused_split(n, b) == jplan.fused_split(n, b)


@pytest.mark.parametrize("log_n", range(17, 25))
def test_staged_split_matches(log_n):
    n = 1 << log_n
    assert tplan._stage_a_n1(n) == jplan._stage_a_n1(n)
    assert tplan.stage_a_ct_full_range(n) == jplan.stage_a_ct_full_range(n)
    n2 = n // tplan._stage_a_n1(n)
    assert tplan.stage_b_plannable(n2) == jplan.stage_b_plannable(n2)


def test_tuning_rows_carry_the_v5e_gates():
    """Every gate but the whole band's is the v5e value; the band is the
    H100's measured one, on both rows (``cpu-approx`` mirrors ``h100``)."""
    v5e = jtuning.TUNING["v5e"]
    for row in ttuning.TUNING.values():
        assert row.calibrated is False
        for f in ttuning.ChipTuning.__dataclass_fields__:
            if f in H100_BAND:
                assert getattr(row, f) == H100_BAND[f], f
            elif f not in ("name", "calibrated", "note"):
                assert getattr(row, f) == getattr(v5e, f), f
    assert set(ttuning.TUNING) == {"h100", "cpu-approx"}


def test_tuning_env_forcing(monkeypatch):
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "h100")
    assert ttuning.get_tuning().name == "h100"
    monkeypatch.setenv("GPU_FFT_TPU_CHIP", "v5e")
    with pytest.raises(ValueError, match="unknown"):
        ttuning.get_tuning()
    monkeypatch.delenv("GPU_FFT_TPU_CHIP")
    assert ttuning.get_tuning().name == "cpu-approx"


def test_on_device_caches_tensors_per_device():
    a = tplan.on_device(tplan.get_whole_plan, 4096, -1, None, device="cpu")
    b = tplan.on_device(tplan.get_whole_plan, 4096, -1, None, device=torch.device("cpu"))
    assert a is b
    ref = tplan.get_whole_plan(4096, -1, None)
    for k in ("f1r", "twi", "f2d"):
        assert isinstance(a[k], torch.Tensor) and a[k].dtype == torch.float32
        assert np.array_equal(a[k].numpy(), ref[k])
    assert (a["n1"], a["n2"]) == (ref["n1"], ref["n2"])
    fp = tplan.on_device(tplan.get_fused_plan, 4096, 1, False, 1.0 / 4096, device="cpu")
    assert isinstance(fp, tplan.FusedPlan) and isinstance(fp.tables["f2r"], torch.Tensor)
    st = tplan.on_device(tplan.get_stage_a_plan, 1 << 17, -1, 512, device="cpu")
    assert isinstance(st["stage_b"]["f1r"], torch.Tensor) and st["stage_b"]["m2"] == 128


# ── describe_plan (JAX: gpu_fft_tpu.plan.describe_plan) ─────────────────────

PLAN_SIZES = [2, 256, 512, 1024, 2048, 4096, 16384, 32768, 65536, 1 << 17, 1 << 20, 1 << 22, 1 << 24]
PLAN_KEYS = ("path", "split", "layout", "wide", "stage_b_split")


@pytest.mark.parametrize("real_input", [True, False])
@pytest.mark.parametrize("b", [1, 2, 16, 64])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_describe_plan_matches_jax_outside_the_band(n, b, real_input):
    """Outside the whole-transform band the port's description is the JAX
    one on path, split, layout, wide and stage_b_split; inside it names the
    band's kernel where JAX says fourstep."""
    got = tplan.describe_plan(n, batch=b, real_input=real_input)
    want = jplan.describe_plan(n, batch=b, real_input=real_input)
    if tplan.whole_kernel_applies(b, n) and n <= tplan.FUSED_MAX:
        assert want["path"] == "fourstep"  # the JAX function's missing band
        assert got["path"] == "whole" and got["split"] == (n // 128, 128) and got["layout"] is None
        assert got["kernel"] == ("whole_transform_packed" if n <= 1024 else "whole_transform")
        return
    assert {k: got.get(k) for k in PLAN_KEYS} == {k: want.get(k) for k in PLAN_KEYS}
    assert (got["n"], got["batch"], got["real_input"]) == (n, b, real_input)


def test_describe_plan_dispatch_map(monkeypatch):
    """``tests/test_plan.py::test_describe_plan_dispatch_map`` on the port;
    in the H100 band ((1 ... 4,096, 1,024 ... 65,536), B * n <= 2^26) the
    port names K1 / K2 where JAX says fourstep, so the four-step's layouts
    show past its batch edge, and the transpose layout under "fast", whose
    band stops at (1, 16,384)."""
    from gpu_fft_tpu_torch import config

    d = tplan.describe_plan
    assert d(512)["path"] == "direct" and d(512)["engine"] == "torch matmul"
    p = d(4096, batch=8192)
    assert p["path"] == "fourstep" and p["wide"] and p["split"] == (32, 128)
    assert p["layout"] == "folded" and p["engine"] == "torch four-step"
    assert d(65536, batch=1025)["layout"] == "half-spectrum"
    assert d(65536, batch=1025, real_input=False)["layout"] == "folded"
    for b in (1, 16, 1024):
        assert (d(65536, batch=b)["path"], d(65536, batch=b)["kernel"]) == ("whole", "whole_transform")
    assert (d(16384)["path"], d(16384)["kernel"], d(16384)["layout"]) == ("whole", "whole_transform", None)
    assert (d(16384, batch=2)["path"], d(16384, batch=4097)["layout"]) == ("whole", "folded")
    assert (d(1024, batch=194)["path"], d(1024, batch=194)["kernel"]) == ("whole", "whole_transform_packed")
    s = d(1 << 20)
    assert s["path"] == "staged" and s["split"] == (128, 8192) and s["engine"] == "K3 stage_a + torch stage B"
    assert d(1 << 20, real_input=False)["engine"] == "K3 stage_a + K4 stage_b"
    assert s["layout"] == "half-spectrum"
    assert d(1 << 20, real_input=False)["layout"] == "folded"
    assert s["stage_b_split"] == (64, 128)
    for bad in (100, 0, 1 << 30):
        with pytest.raises(ValueError):
            d(bad)
    monkeypatch.setattr(config, "PRECISION", "fast")
    assert d(65536, batch=1, real_input=False)["layout"] == "transpose"
    assert d(16384, batch=2)["layout"] == "folded"


@pytest.mark.parametrize("real_input", [True, False])
@pytest.mark.parametrize("b,n", [(1, 256), (1, 1024), (2, 1024), (1, 4096), (1, 16384), (4, 16384),
                                 (1, 65536), (1, 1 << 17), (3, 1 << 18)])
def test_describe_plan_names_the_path_transform_any_takes(b, n, real_input):
    """The path it names is the one ``transform_any`` runs, read from the
    kernels' plain-call counts on the CPU."""
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels.large import transform_any

    info = tplan.describe_plan(n, batch=b, real_input=real_input)
    x = torch.zeros(b, n)
    K.reset_counts()
    transform_any(x, None if real_input else torch.zeros(b, n), n, -1)
    ran = {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls}
    staged = {"stage_a": 1, **({"stage_b": 1} if info.get("engine", "").endswith("K4 stage_b") else {})}
    want = {"whole": {info.get("kernel"): 1}, "staged": staged}.get(info["path"], {})
    assert ran == want, (info, ran)


# ── The whole-transform band: the engine ``transform_any`` takes ────────────

# (mode, b, n, engine): "whole" is K1/K2 (K1F/K2F under "fast"); "torch" any
# of the torch engines, no kernel.
BAND_CASES = [
    ("full", 1, 32768, "whole"),
    ("full", 1, 65536, "whole"),
    ("full", 16, 65536, "whole"),
    ("full", 194, 1024, "whole"),
    ("full", 3, 4096, "whole"),
    ("full", 4097, 1024, "torch"),  # one past the batch edge
    ("full", 4, 512, "torch"),  # under the band's n
    ("fast", 1, 16384, "whole"),
    ("fast", 1, 1024, "whole"),
    ("fast", 2, 4096, "torch"),
    ("fast", 1, 32768, "torch"),
    ("high", 1, 4096, "torch"),
    ("high", 3, 1024, "torch"),
]


def _engines(prof):
    return [e.name for e in prof.events() if e.name.startswith("gft.engine.")]


@pytest.mark.parametrize("real_input", [True, False])
@pytest.mark.parametrize("mode,b,n,engine", BAND_CASES)
def test_transform_any_takes_the_band_engine(monkeypatch, mode, b, n, engine, real_input):
    """The engine span and the kernels' plain-call counts of one
    ``transform_any`` call on the CPU: K1/K2 in the H100 band under "full";
    the band of K1F/K2F (B = 1, n <= 16,384) under "fast"; no kernel under
    "high"; the torch engines outside."""
    from torch.profiler import ProfilerActivity, profile

    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch.kernels import fused as K
    from gpu_fft_tpu_torch.kernels.large import transform_any

    monkeypatch.setattr(config, "PRECISION", mode)
    # Both "high" cases lie in the band: transform_any, not the predicate, bypasses it.
    assert tplan.whole_kernel_applies(b, n) == (engine == "whole" or mode == "high")
    x = torch.zeros(b, n)
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        transform_any(x, None if real_input else torch.zeros(b, n), n, -1)
    ran = {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls}
    fast = "_bf16" if mode == "fast" else ""
    if engine == "whole":
        assert _engines(prof) == ["gft.engine.whole"]
        assert ran == {("whole_transform_packed" if n <= 1024 else "whole_transform") + fast: 1}
    else:
        (name,) = _engines(prof)
        assert name in ("gft.engine.direct", "gft.engine.fourstep", "gft.engine.fourstep_folded",
                        "gft.engine.fourstep_half")
        assert ran == {}


# ── The route is what runs ───────────────────────────────────────────────────

# (B, n): both sides of every gate, B = 4,097 one past ``whole_batch_max``.
ROUTE_CASES = [(b, n) for n in (256, 1024, 16384, 32768, 65536, 1 << 17, 1 << 18) for b in (1, 3)] + [(4097, 1024)]
INVERSE_CASES = [(1, 256), (3, 1024), (1, 32768), (3, 65536), (1, 1 << 17), (3, 1 << 18)]


def _ran_by_route(monkeypatch, mode, call):
    """The ``gft.engine.*`` spans (outer before inner) and the kernels'
    plain-call counts of one CPU call in precision ``mode``."""
    from torch.profiler import ProfilerActivity, profile

    from gpu_fft_tpu_torch import config
    from gpu_fft_tpu_torch.kernels import fused as K

    monkeypatch.setattr(config, "PRECISION", mode)
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("gft.engine."))
    ran = Counter({k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls})
    return tuple(name for *_, name in spans), ran


def _route_kernels(r):
    return Counter(tplan.KERNELS[k] for k in r.kernels)


@pytest.mark.parametrize("mode", ["full", "high", "fast"])
@pytest.mark.parametrize("real_input", [True, False])
@pytest.mark.parametrize("b,n", ROUTE_CASES)
def test_route_is_what_transform_any_runs(monkeypatch, mode, b, n, real_input):
    """``plan.route``'s spans and kernels are the engine spans a CPU profile
    of ``transform_any`` records and the kernels' plain calls, in each mode."""
    from gpu_fft_tpu_torch.kernels.large import transform_any

    x = torch.zeros(b, n)
    xi = None if real_input else torch.zeros(b, n)
    spans, ran = _ran_by_route(monkeypatch, mode, lambda: transform_any(x, xi, n, -1))
    r = tplan.route(b, n, real_input=real_input)
    assert (spans, ran) == (r.spans, _route_kernels(r)), r


@pytest.mark.parametrize("mode", ["full", "high", "fast"])
@pytest.mark.parametrize("one_sided", [False, True])
@pytest.mark.parametrize("b,n", INVERSE_CASES)
def test_route_is_what_the_real_output_inverses_run(monkeypatch, mode, b, n, one_sided):
    """The same for ``inverse_real`` (a Hermitian (B, n) spectrum) and
    ``inverse_real_half`` (its n/2 + 1 bins)."""
    from gpu_fft_tpu_torch.kernels.large import inverse_real, inverse_real_half

    w = n // 2 + 1 if one_sided else n
    x = torch.zeros(b, w)
    fn = inverse_real_half if one_sided else inverse_real
    spans, ran = _ran_by_route(monkeypatch, mode, lambda: fn(x, x, n))
    r = tplan.route(b, n, real_output=True, one_sided=one_sided)
    assert (spans, ran) == (r.spans, _route_kernels(r)), r


@pytest.mark.parametrize("call", ["real", "complex", "inverse_real"])
def test_route_of_the_forced_small_staged_path(monkeypatch, call):
    """Stage B not plannable (forced-small configs): the route recurses into
    the rows' own route, and the staged real-output inverse falls back to the
    complex inverse's."""
    from gpu_fft_tpu_torch.kernels.large import inverse_real, transform_any

    n = 1 << 18
    x = torch.zeros(1, n)
    run = {"real": lambda: transform_any(x, None, n, -1), "complex": lambda: transform_any(x, x, n, -1),
           "inverse_real": lambda: inverse_real(x, x, n)}[call]
    monkeypatch.setattr(tplan, "stage_b_plannable", lambda n2: False)
    try:
        spans, ran = _ran_by_route(monkeypatch, "full", run)
        r = tplan.route(1, n, real_input=call == "real", real_output=call == "inverse_real")
    finally:  # stage-A plans built under the patch lack their stage-B tables
        tplan.get_stage_a_plan.cache_clear()
        tplan.clear_device_cache()
    assert r.path == "staged" and r.stage_b == "recursive" and r.inner.path == "whole"
    assert (spans, ran) == (r.spans, _route_kernels(r)), r
