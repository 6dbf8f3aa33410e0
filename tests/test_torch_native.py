"""The port's NATIVE backend (``gpu_fft_tpu_torch/backends/native.py``), the
host entry points ``fft_native`` / ``ifft_native`` and ``warmup``, on the
CPU.

NATIVE loads the repo's host C++ library ``native/libtpufft.so``, built by
``make -C native``.  The tests build a private copy from ``native/``
(``native_library``) and load only that one, since another test process
(``tests/test_native.py``) may be building the repo's at the same moment;
they skip only where no toolchain can build it.  Both packages call
the same library through the same ctypes contract, so their outputs are
bit-equal; numpy's float64 transform is the oracle within 5*log2(N)*eps of
max|ref|.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import gpu_fft_tpu as gf
import gpu_fft_tpu_torch as gt
import gpu_fft_tpu_torch.kernels.fused as K
from gpu_fft_tpu.backends import native as jnative
from gpu_fft_tpu_torch.backends import Backend, native

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"


def _bound(n):
    return 5 * np.log2(n) * np.finfo(np.float32).eps


def native_library(mp, tmp_dir) -> bool:
    """Whether NATIVE's library loads: build a private one from ``native/``
    in ``tmp_dir`` and point both packages at it through
    ``GPU_FFT_TPU_NATIVE_LIB`` on ``mp`` (a MonkeyPatch).  The repo's own
    ``native/libtpufft.so`` is never loaded: another test process may be
    writing it, and a handle cached in ``_load`` by an earlier test may name
    a library that is gone, so both caches are cleared once the variable is
    set."""
    build = pathlib.Path(tmp_dir) / "native"
    shutil.copytree(NATIVE_DIR, build, ignore=shutil.ignore_patterns("*.so"))
    try:
        subprocess.run(["make", "-C", str(build)], check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    mp.setenv("GPU_FFT_TPU_NATIVE_LIB", str(build / "libtpufft.so"))
    native._load.cache_clear()
    jnative._load.cache_clear()
    return native.is_available()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        if not native_library(mp, tmp_path_factory.mktemp("native")):
            pytest.skip("native backend not built and toolchain unavailable")
        yield
    native._load.cache_clear()
    jnative._load.cache_clear()


def test_backend_listed(built):
    assert gt.available_backends() == [Backend.TORCH, Backend.TORCH_FFT, Backend.NATIVE]
    assert native.lib_path() == jnative.lib_path()


def test_backend_absent_without_the_library(built, monkeypatch, tmp_path):
    """No library at the override or the repo path: NATIVE is not listed and
    a call names ``make -C native``."""
    monkeypatch.setattr(native, "_REPO_ROOT", tmp_path)
    monkeypatch.setenv("GPU_FFT_TPU_NATIVE_LIB", str(tmp_path / "missing.so"))
    native._load.cache_clear()
    try:
        assert Backend.NATIVE not in gt.available_backends()
        with pytest.raises(RuntimeError, match="make -C native"):
            gt.fft_native(np.ones(8, np.float32))
    finally:
        monkeypatch.undo()
        native._load.cache_clear()
    assert native.is_available()


@pytest.mark.parametrize("n", [8, 256, 1000, 1024, 4096, 65536])
def test_fft_native_matches_jax_and_numpy(built, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    re, im = gt.fft_native(x)
    jre, jim = gf.fft_native(x)
    np.testing.assert_array_equal(re, jre)
    np.testing.assert_array_equal(im, jim)
    m = gt.next_power_of_two(n)
    ref = np.fft.fft(x.astype(np.float64), m)
    assert re.shape == (m,)
    assert max(np.abs(re - ref.real).max(), np.abs(im - ref.imag).max()) <= _bound(m) * np.abs(ref).max()


@pytest.mark.parametrize("n", [16, 1024, 16384])
def test_native_roundtrip_layout(built, n):
    """``ifft_native`` returns [real | imag] scaled by 1/N, as ``ifft``."""
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    out = gt.ifft_native(*gt.fft_native(x))
    np.testing.assert_array_equal(out, gf.ifft_native(*gf.fft_native(x)))
    assert out.shape == (2 * n,)
    assert np.abs(out[:n] - x).max() <= _bound(n) * np.abs(x).max()
    assert np.abs(out[n:]).max() <= _bound(n) * np.abs(x).max()


def test_native_batch_pads_to_the_longest(built):
    rng = np.random.default_rng(3)
    signals = [rng.standard_normal(k).astype(np.float32) for k in (100, 64, 129, 7)]
    got = gt.fft_batch(signals, backend=Backend.NATIVE)
    want = gf.fft_batch(signals, backend=gf.Backend.NATIVE)
    assert [r.shape for r, _ in got] == [(256,)] * 4
    for (r, i), (jr, ji), s in zip(got, want, signals):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(i, ji)
        ref = np.fft.fft(s.astype(np.float64), 256)
        assert max(np.abs(r - ref.real).max(), np.abs(i - ref.imag).max()) <= _bound(256) * np.abs(ref).max()
    outs = gt.ifft_batch(got, backend=Backend.NATIVE)
    for o, s in zip(outs, signals):
        assert np.abs(o[: s.shape[0]] - s).max() <= _bound(256) * np.abs(s).max()


def test_native_error_code_is_a_value_error(built):
    with pytest.raises(ValueError, match="code -2"):
        native._run(np.zeros((1, 12), np.float32), np.zeros((1, 12), np.float32), -1)
    with pytest.raises(ValueError, match="code -3"):
        native._run(np.zeros((1, 8), np.float32), np.zeros((1, 8), np.float32), 2)
    with pytest.raises(ValueError, match="matching"):
        native._run(np.zeros((1, 8), np.float32), np.zeros((1, 4), np.float32), -1)


def test_native_refuses_tensor_calls(built):
    x = torch.ones(1, 16)
    with pytest.raises(ValueError, match="host-side"):
        gt.fft_device(x, backend=Backend.NATIVE)
    with pytest.raises(ValueError, match="host-side"):
        gt.ifft_device(x, x, backend=Backend.NATIVE)


def test_env_native_routes_the_host_api(built, monkeypatch):
    """``GPU_FFT_TPU_BACKEND=native`` sends the host API to the library: no
    device is asked for and no kernel (nor its plain version) runs."""
    monkeypatch.setenv("GPU_FFT_TPU_BACKEND", "native")
    monkeypatch.delenv("GPU_FFT_TPU_TORCH_DEVICE", raising=False)
    assert gt.default_backend() is Backend.NATIVE
    x = np.random.default_rng(5).standard_normal(1024).astype(np.float32)
    K.reset_counts()
    re, im = gt.fft(x)
    out = gt.ifft(re, im)
    assert all(c.launches == 0 and c.plain_calls == 0 for c in K.COUNTS.values())
    np.testing.assert_array_equal(re, gt.fft_native(x)[0])
    assert np.abs(out[:1024] - x).max() <= _bound(1024) * np.abs(x).max()


def test_warmup_runs_each_shape_on_the_cpu():
    """Each (B, n) forward and inverse once: K2's plain version at 1,024 and
    K1's at 4,096 both ways, at B = 1 and 2 (both in the whole band)."""
    K.reset_counts()
    gt.warmup(sizes=(1024, 4096), batches=(1, 2), device="cpu")
    assert K.COUNTS["whole_transform_packed"].plain_calls == 4
    assert K.COUNTS["whole_transform"].plain_calls == 4
    K.reset_counts()
    gt.warmup(sizes=(1024,), inverse=False, device="cpu")
    assert K.COUNTS["whole_transform_packed"].plain_calls == 1


def test_warmup_under_native_warms_torch(monkeypatch):
    monkeypatch.setenv("GPU_FFT_TPU_BACKEND", "native")
    K.reset_counts()
    gt.warmup(sizes=(1024,), device="cpu")
    assert K.COUNTS["whole_transform_packed"].plain_calls == 2


@pytest.mark.parametrize("bad", [0, 1, 12, 1000])
def test_warmup_rejects_other_sizes(bad):
    with pytest.raises(ValueError, match="powers of two"):
        gt.warmup(sizes=(bad,), device="cpu")


def test_warmup_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("GPU_FFT_TPU_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        gt.warmup(sizes=(1024,))
