"""The port's 2-D and N-D transforms (``gpu_fft_tpu_torch/ops/fft2d.py``)
against the JAX package's (``gpu_fft_tpu/ops/fft2d.py``), on the CPU.

Every name of ``__all__`` runs at power-of-two and other sides, with the
batch, ``axes`` and error cases of ``tests/test_fft2d.py``; the same numpy
input, made from a seed, goes through both packages.  Tolerance:
max |port - JAX| <= 1e-5 * max |JAX| (fp32 on both sides, bit-identical
tables, different summation order).  Gradients of ``fft2_device`` and
``rfft2_device`` are held against ``jax.grad``.  The axis-0 column engine
is gate-closed in both packages, so both take the transpose branch:
pinned by ``test_column_pass_is_the_transpose_branch`` (the engine under an
opened gate: ``test_torch_gate_closed.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_fft_tpu.ops.fft2d as jf
import gpu_fft_tpu_torch.kernels.fused as K
import gpu_fft_tpu_torch.ops.fft2d as tf

RTOL = 1e-5


def _np(out):
    """Outputs of either package as a tuple of float64 numpy arrays."""
    if not isinstance(out, tuple):
        out = (out,)
    return tuple(np.asarray(o.detach() if isinstance(o, torch.Tensor) else o, dtype=np.float64) for o in out)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert [g.shape for g in got] == [w.shape for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert err <= rtol * scale, f"max|d| {err:.3e} > {rtol} * {scale:.3e}"


def _real(shape, seed=0):
    return np.random.default_rng(seed + sum(shape)).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (name, arrays, kwargs): each array a seeded numpy input; the host forms get
# numpy, the _device forms tensors (the JAX side jnp arrays).
CASES = [
    ("fft2", [(8, 16)], {}),
    ("fft2", [(2, 3, 8, 16)], {}),
    ("fft2", [(6, 10)], {}),
    ("fft2", [(3, 16)], {}),
    ("fft2_device", [(2, 16, 8)], {}),
    ("fft2_device", [(12, 25), (12, 25)], {}),  # complex input (imag), Bluestein sides
    ("ifft2", [(8, 16), (8, 16)], {}),
    ("ifft2", [(5, 12), (5, 12)], {}),
    ("ifft2_device", [(2, 8, 32), (2, 8, 32)], {}),
    ("fftn", [(4, 8, 16)], {}),
    ("fftn", [(5, 12, 16)], {"axes": (1, 2)}),
    ("fftn", [(4, 8)], {"axes": (-1,)}),
    ("fftn_device", [(3, 8, 16), (3, 8, 16)], {"axes": (0, 2)}),
    ("fftn_device", [(6, 7)], {}),
    ("fftn_device", [(16,)], {}),
    ("ifftn", [(4, 8, 32), (4, 8, 32)], {}),
    ("ifftn_device", [(3, 8, 16), (3, 8, 16)], {"axes": (1,)}),
    ("ifftn_device", [(5, 6), (5, 6)], {}),
    ("rfft2", [(8, 16)], {}),
    ("rfft2", [(32, 64)], {}),
    ("rfft2_device", [(2, 8, 32)], {}),
    ("irfft2", [(8, 9), (8, 9)], {}),
    ("irfft2_device", [(2, 16, 5), (2, 16, 5)], {}),
    ("rfftn", [(4, 8, 16)], {}),
    ("rfftn", [(6, 4, 8)], {"axes": (2, 0)}),
    ("rfftn", [(4, 12)], {}),
    ("rfftn_device", [(3, 5, 8)], {"axes": (0, 2)}),
    ("rfftn_device", [(2, 10)], {}),
    ("irfftn", [(4, 8, 9), (4, 8, 9)], {}),
    ("irfftn", [(5, 9, 4), (5, 9, 4)], {"axes": (2, 1)}),
    ("irfftn_device", [(3, 6, 17), (3, 6, 17)], {}),
    ("hfftn", [(5, 6, 9), (5, 6, 9)], {}),
    ("hfftn_device", [(3, 5), (3, 5)], {"axes": (0, 1)}),
    ("hfftn_device", [(17,), (17,)], {}),
    ("ihfftn", [(4, 6, 16)], {}),
    ("ihfftn_device", [(5, 8)], {"axes": (0, 1)}),
    ("hfft2", [(3, 8, 5), (3, 8, 5)], {}),
    ("ihfft2", [(3, 8, 8)], {}),
    ("ihfft2", [(8, 6)], {"axes": (1, 0)}),
]


@pytest.fixture(scope="module")
def jax_cache():
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = _np(fn())
        return cache[key]

    return get


@pytest.mark.parametrize("name,shapes,kw", CASES, ids=lambda v: str(v))
def test_name_matches_jax(jax_cache, name, shapes, kw):
    arrays = [_real(s, seed=i) for i, s in enumerate(shapes)]
    device_form = name.endswith("_device")
    want = jax_cache((name, tuple(shapes), tuple(kw.items())),
                     lambda: getattr(jf, name)(*(jnp.asarray(a) if device_form else a for a in arrays), **kw))
    got = getattr(tf, name)(*(_t(a) if device_form else a for a in arrays), **kw,
                            **({} if device_form else {"device": "cpu"}))
    _close(got, want)
    if device_form:
        assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu"
                   for g in (got if isinstance(got, tuple) else (got,)))


def test_all_names_are_the_jax_packages():
    assert tf.__all__ == jf.__all__
    assert {c[0] for c in CASES} == set(jf.__all__)


def test_fft2_rows_beyond_fused_max_run_the_staged_path(jax_cache):
    """A side longer than FUSED_MAX: the row pass runs K3 (its plain
    version on the CPU) at B = 2."""
    x = _real((2, 1 << 17))
    want = jax_cache(("fft2-staged",), lambda: jf.fft2(x))
    K.reset_counts()
    got = tf.fft2(x, device="cpu")
    _close(got, want)
    assert K.COUNTS["stage_a"].plain_calls == 1 and K.COUNTS["stage_a"].launches == 0


ERRORS = [
    ("fft2", [(16,)], {}),  # 1-D
    ("fft2", [(1, 16)], {}),  # height < 2
    ("ifft2", [(4, 4), (4, 8)], {}),
    ("fftn", [(4, 1)], {}),  # axis length < 2
    ("fftn", [(4, 8)], {"axes": (0, 0)}),  # repeated axes
    ("fftn", [(4, 8)], {"axes": ()}),
    ("fftn", [(4, 8)], {"axes": (2,)}),
    ("fftn", [(4, 8)], {"axes": (-3,)}),
    ("rfft2", [(8, 12)], {}),  # non-pow2 side
    ("rfft2", [(2, 2, 8, 8)], {}),  # rank 4
    ("irfft2", [(8, 6), (8, 6)], {}),  # 6 bins
    ("irfft2", [(8, 5), (8, 9)], {}),
    ("rfftn", [()], {}),  # rank 0
    ("rfftn", [(4, 1)], {}),
    ("rfftn", [(4, 8)], {"axes": (0, 0)}),
    ("rfftn", [(4, 8)], {"axes": (2,)}),
    ("irfftn", [(4, 6), (4, 6)], {}),
    ("irfftn", [(4, 9), (4, 8)], {}),
    ("hfftn", [(4, 6), (4, 6)], {}),
    ("hfftn", [(4, 9), (4, 8)], {}),
    ("ihfftn", [(4, 12)], {}),
    ("ihfftn", [()], {}),
]


@pytest.mark.parametrize("name,shapes,kw", ERRORS, ids=lambda v: str(v))
def test_errors_match_jax(name, shapes, kw):
    arrays = [np.ones(s, np.float32) for s in shapes]
    with pytest.raises(ValueError):
        getattr(jf, name)(*arrays, **kw)
    with pytest.raises(ValueError):
        getattr(tf, name)(*arrays, **kw, device="cpu")


def test_host_forms_default_to_the_card(monkeypatch):
    """No device and no GPU_FFT_TPU_TORCH_DEVICE: the host forms ask for
    CUDA, which this machine lacks."""
    monkeypatch.delenv("GPU_FFT_TPU_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tf.fft2(np.ones((4, 4), np.float32))
    monkeypatch.setenv("GPU_FFT_TPU_TORCH_DEVICE", "cpu")
    re, _ = tf.fft2(np.ones((4, 4), np.float32))
    assert re[0, 0] == 16.0


@pytest.mark.parametrize("shape", [(8, 16), (2, 4, 1024), (6, 10)])
def test_fft2_device_grad_matches_jax(shape):
    """d/dx of sum(wr * Re fft2(x) + wi * Im fft2(x)) against jax.grad: a
    direct-product image, 1,024-point rows at B = 8 (the torch four-step),
    and Bluestein sides."""
    x = _real(shape)
    wr, wi = _real(shape, 1), _real(shape, 2)

    def jloss(a):
        yr, yi = jf.fft2_device(a)
        return jnp.sum(wr * yr + wi * yi)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    yr, yi = tf.fft2_device(xt)
    (got,) = torch.autograd.grad((_t(wr) * yr + _t(wi) * yi).sum(), xt)
    _close(got, want)


@pytest.mark.parametrize("shape", [(8, 16), (2, 16, 32)])
def test_rfft2_device_grad_matches_jax(shape):
    x = _real(shape)
    hshape = shape[:-1] + (shape[-1] // 2 + 1,)
    wr, wi = _real(hshape, 1), _real(hshape, 2)

    def jloss(a):
        yr, yi = jf.rfft2_device(a)
        return jnp.sum(wr * yr + wi * yi)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    yr, yi = tf.rfft2_device(xt)
    (got,) = torch.autograd.grad((_t(wr) * yr + _t(wi) * yi).sum(), xt)
    _close(got, want)


def test_device_forms_carry_a_grad_fn_through_the_kernel_functions():
    """A length-1,024 axis at B = 1 runs K2 behind its autograd Function
    (its plain version here), so the output keeps a grad_fn."""
    K.reset_counts()
    x = _t(_real((1, 1024))).requires_grad_(True)
    yr, yi = tf.fftn_device(x, axes=(1,))
    assert yr.grad_fn is not None and yi.grad_fn is not None
    assert K.COUNTS["whole_transform_packed"].plain_calls == 1
    yr2, _ = tf.fft2_device(_t(_real((4, 8))).requires_grad_(True))
    assert yr2.grad_fn is not None


@pytest.mark.parametrize("shape", [(2048, 512), (4096, 4096), (8192, 2048)])
def test_jax_axis0_gate_is_closed(shape):
    """The JAX package's axis-0 column engine never runs at its default
    tuning, so its column pass is the transpose branch the port takes."""
    from gpu_fft_tpu.plan import axis0_applies

    assert not axis0_applies(*shape)


@pytest.mark.parametrize("fn", ["fft2_device", "rfft2_device", "irfft2_device"])
def test_column_pass_is_the_transpose_branch(monkeypatch, fn):
    """With its axis-0 gate closed (as shipped) the port takes the
    transpose branch.  Its outputs equal the JAX package's with the JAX gate
    closed and forced open (the axis-0 engine): the branch changes no
    output."""
    import gpu_fft_tpu.plan as jplan

    h, w = 64, 32
    args = [_real((2, h, w // 2 + 1), i) for i in range(2)] if fn == "irfft2_device" else [_real((2, h, w))]
    got = getattr(tf, fn)(*map(_t, args))
    closed = getattr(jf, fn)(*map(jnp.asarray, args))
    _close(got, closed)
    monkeypatch.setattr(jplan, "axis0_applies", lambda h, w: True)
    opened = getattr(jf, fn)(*map(jnp.asarray, args))
    _close(got, opened)


def test_reversed_views_are_taken():
    """A numpy view with negative strides (``x[::-1]``, what ``filtfilt``
    returns) is copied to a contiguous tensor: torch refuses such strides,
    and the welch of the filtering example failed on one."""
    import gpu_fft_tpu_torch as gt

    x = _real((8, 16))
    _close(tf.fft2_device(x[::-1, ::-1], device="cpu"), jf.fft2_device(jnp.asarray(x[::-1, ::-1])))
    sig = _real((2048,))
    f, p = gt.welch(sig[::-1], nperseg=256, device="cpu")
    _, want = gt.welch(sig[::-1].copy(), nperseg=256, device="cpu")
    np.testing.assert_array_equal(p, want)
