"""The port's FNO model family (``gpu_fft_tpu_torch.models``) against the
JAX package's flax modules and optax train step, on the CPU.

The flax initialisation's weights are carried across with
``load_flax_params``; the same seeded input then goes through both: the
forward within 2e-5 abs (``tests/test_models.py``'s ``atol``), the gradient
of ``sum(model(x) ** 2)`` for every parameter within 1e-4 * max|jax.grad|,
and five ``torch.optim.Adam`` steps against five optax.adam steps within
1e-4 * max|param|.  Shapes are the JAX tests': SpectralConv2d on
(2, 16, 32, 3) with modes 5 / 7, SpectralConv1d on (3, 64, 2) with modes
9, FNO2d on (2, 16, 16, 1) with width 8 and depth 2, FNO1d on (4, 64, 1).
The JAX package's mesh steps are ROADMAP item 15 (not ported).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpu_fft_tpu.models as jm
import gpu_fft_tpu.models.train as jtrain
import gpu_fft_tpu_torch.models as tm
from gpu_fft_tpu_torch.models.fno import _flatten

CASES = {
    "SpectralConv2d": (lambda: jm.SpectralConv2d(4, 5, 7),
                       lambda: tm.SpectralConv2d(4, 5, 7, in_channels=3, device="cpu"), (2, 16, 32, 3)),
    "SpectralConv1d": (lambda: jm.SpectralConv1d(5, 9),
                       lambda: tm.SpectralConv1d(5, 9, in_channels=2, device="cpu"), (3, 64, 2)),
    "FNO2d": (lambda: jm.FNO2d(modes1=4, modes2=4, width=8, depth=2),
              lambda: tm.FNO2d(modes1=4, modes2=4, width=8, depth=2, in_channels=1, device="cpu"), (2, 16, 16, 1)),
    "FNO1d": (lambda: jm.FNO1d(modes=8, width=16, depth=2),
              lambda: tm.FNO1d(modes=8, width=16, depth=2, in_channels=1, device="cpu"), (4, 64, 1)),
}


def _torch_names(tree) -> dict:
    """A flax gradient / parameter tree under the port's parameter names."""
    return {(k[: -len("kernel")] + "weight" if k.endswith(".kernel") else k): (v.T if k.endswith(".kernel") else v)
            for k, v in _flatten(tree).items()}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(name, flax module, its params, the port's module with them, x)."""
    make_j, make_t, shape = CASES[request.param]
    x = np.random.default_rng(1234).standard_normal(shape).astype(np.float32)
    jmod = make_j()
    params = jmod.init(jax.random.PRNGKey(0), x)
    tmod = tm.load_flax_params(make_t(), jax.tree.map(np.asarray, params["params"]))
    return request.param, jmod, params, tmod, x


def test_forward_matches_flax(pair):
    name, jmod, params, tmod, x = pair
    got = tmod(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jmod.apply(params, x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_gradients_match_jax_grad(pair):
    name, jmod, params, tmod, x = pair
    tmod.zero_grad()
    (tmod(torch.from_numpy(x)) ** 2).sum().backward()
    want = _torch_names(jax.grad(lambda p: jnp.sum(jmod.apply(p, x) ** 2))(params)["params"])
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    assert got.keys() == want.keys()
    for k in got:
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


def _derivative_problem(rng, batch, length):
    """Synthetic operator learning: u -> du/dx on band-limited signals
    (``tests/test_models.py``'s)."""
    k = np.arange(1, 5)
    amp = rng.standard_normal((batch, k.size))
    phase = rng.uniform(0, 2 * np.pi, (batch, k.size))
    t = np.arange(length) / length
    u = np.einsum("bk,bkl->bl", amp, np.sin(2 * np.pi * k[None, :, None] * t + phase[..., None]))
    du = np.einsum("bk,bkl->bl", amp * 2 * np.pi * k,
                   np.cos(2 * np.pi * k[None, :, None] * t + phase[..., None]))
    return u[..., None].astype(np.float32), (du / np.abs(du).max())[..., None].astype(np.float32)


@pytest.mark.parametrize("name", ["FNO1d", "FNO2d"])
def test_adam_steps_match_optax(name):
    make_j, make_t, shape = CASES[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    jmod = make_j()
    params = jmod.init(jax.random.PRNGKey(2), x)
    tmod = tm.load_flax_params(make_t(), jax.tree.map(np.asarray, params["params"]))
    opt = optax.adam(1e-3)
    jstep = jtrain.make_train_step(jmod.apply, opt)
    tstep = tm.make_train_step(tmod, torch.optim.Adam(tmod.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8))
    state = opt.init(params)
    for _ in range(5):
        params, state, jloss = jstep(params, state, x, y)
        tloss = tstep(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _torch_names(jax.tree.map(np.asarray, params["params"]))
    for k, p in tmod.named_parameters():
        assert np.abs(p.detach().numpy() - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


def test_fno1d_learns_derivative():
    x, y = _derivative_problem(np.random.default_rng(1234), 16, 64)
    model = tm.FNO1d(modes=8, width=16, depth=2, in_channels=1, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    step = tm.make_train_step(model, torch.optim.Adam(model.parameters(), lr=3e-3))
    losses = tm.fit(step, [(torch.from_numpy(x), torch.from_numpy(y))], steps=60)
    assert len(losses) == 60 and all(isinstance(v, float) for v in losses)
    assert losses[-1] < losses[0] / 10, f"no learning: {losses[0]} -> {losses[-1]}"


@pytest.mark.parametrize("shape", [(2, 8, 4, 1), (1, 16, 2), (3, 12, 7, 2), (1, 5, 3, 6, 1)], ids=str)
def test_append_grid_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tm.append_grid(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.append_grid(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_spectral_conv_mode_validation():
    with pytest.raises(ValueError, match="modes1"):
        tm.SpectralConv2d(1, modes1=9, modes2=2, in_channels=1, device="cpu")(torch.zeros(1, 16, 16, 1))
    with pytest.raises(ValueError, match="modes2"):
        tm.SpectralConv2d(1, modes1=2, modes2=10, in_channels=1, device="cpu")(torch.zeros(1, 16, 16, 1))
    with pytest.raises(ValueError, match="modes"):
        tm.SpectralConv1d(1, modes=40, in_channels=1, device="cpu")(torch.zeros(1, 32, 1))
    with pytest.raises(ValueError, match="input channels"):
        tm.SpectralConv1d(1, modes=4, in_channels=2, device="cpu")(torch.zeros(1, 32, 1))


def test_mse_value():
    assert float(tm.mse(torch.ones(2, 2), torch.zeros(2, 2))) == 1.0
    a, b = np.arange(6.0, dtype=np.float32).reshape(2, 3), np.ones((2, 3), np.float32)
    got, want = float(tm.mse(torch.from_numpy(a), torch.from_numpy(b))), float(jtrain.mse(a, b))
    assert abs(got - want) <= 1e-6 * want  # f32 means, summed in their own orders


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_flax_params_rejects_a_wrong_tree(fault):
    x = np.zeros((1, 16, 16, 1), np.float32)
    params = jax.tree.map(np.asarray, jm.FNO2d(modes1=4, modes2=4, width=8, depth=2).init(
        jax.random.PRNGKey(0), x)["params"])
    if fault == "missing":
        del params["pw1"]
    elif fault == "extra":
        params["pw9"] = params["pw0"]
    else:
        params["spec0"]["w1_real"] = params["spec0"]["w1_real"][..., :3]
    model = tm.FNO2d(modes1=4, modes2=4, width=8, depth=2, in_channels=1, device="cpu")
    with pytest.raises(ValueError, match={"missing": "missing", "extra": "extra", "shape": "shape"}[fault]):
        tm.load_flax_params(model, params)


def test_init_follows_flax_and_the_generator():
    """The same seed gives the same weights; the spectral weights are
    normal(1/(C*O)) and the dense kernels LeCun normal, as flax draws them."""
    a = tm.FNO1d(in_channels=1, device="cpu", generator=torch.Generator().manual_seed(3)).requires_grad_(False)
    b = tm.FNO1d(in_channels=1, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert abs(float(a.spec0.w_real.std()) * 64 * 64 - 1.0) < 0.05
    assert abs(float(a.pw0.weight.std()) * 8.0 - 1.0) < 0.05 and float(a.pw0.weight.abs().max()) <= 2 / 8 / 0.8796
    assert float(a.lift.bias.abs().max()) == 0.0


@pytest.mark.parametrize("name", ["make_data_parallel_step", "make_gspmd_step", "param_shardings"])
def test_mesh_steps_are_roadmap_item_15(name):
    with pytest.raises(AttributeError, match="ROADMAP item 15"):
        getattr(tm, name)
    assert name not in tm.__all__


def test_all_names_resolve():
    assert all(hasattr(tm, n) for n in tm.__all__)
    assert set(tm.__all__) - {"load_flax_params"} <= set(jm.__all__)
