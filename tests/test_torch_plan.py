"""Plans of the PyTorch port against the JAX package's: identical tables,
identical dispatch predicates, and the deliberate packed-plan guard."""

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


@pytest.mark.parametrize("b", [1, 2, 3, 16, 64])
@pytest.mark.parametrize("n", [2, 256, 512, 1024, 2048, 4096, 16384, 32768, 65536])
def test_dispatch_predicates_match(b, n):
    assert tplan.whole_kernel_applies(b, n) == jplan.whole_kernel_applies(b, n)
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
    v5e = jtuning.TUNING["v5e"]
    for row in ttuning.TUNING.values():
        assert row.calibrated is False
        for f in ttuning.ChipTuning.__dataclass_fields__:
            if f not in ("name", "calibrated", "note"):
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
