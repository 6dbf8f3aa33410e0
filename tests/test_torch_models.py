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
The mesh steps (``make_data_parallel_step``, ``make_gspmd_step``,
``param_shardings``) run on a gloo world of 8 CPU ranks against the JAX
package's on its 8-device virtual mesh.
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


# ── The mesh steps on a gloo world of 8 CPU ranks ───────────────────────────
#
# One module-scoped fixture writes the flax weights and the data, spawns the
# 8 ranks once (init_method a file under pytest's tmp dir) and reads back
# rank 0's losses and gathered parameters; the parent holds them against
# gpu_fft_tpu.models.train's steps on the conftest's 8-device virtual mesh
# (the shapes of tests/test_models.py) and against the port's single-device
# step, over MESH_STEPS Adam steps (1e-4 of max|param|, losses 1e-5).

MESH_STEPS = 3
#: case -> (FNO1d modes, width, depth, flax seed, mesh, dp axis, tp axis)
MESH_CASES = {
    "dp": (4, 8, 1, 2, (8,), "dp", None),
    "gspmd_dp_tp": (8, 16, 2, 3, (2, 4), "dp", "tp"),
    "gspmd_dp": (8, 16, 2, 3, (2, 4), "dp", None),
    "gspmd_tp": (8, 16, 2, 3, (2, 4), None, "tp"),
}


def _mesh_inputs():
    x, y = _derivative_problem(np.random.default_rng(1234), 8, 64)
    params = {}
    for case, (modes, width, depth, seed, *_rest) in MESH_CASES.items():
        p = jm.FNO1d(modes=modes, width=width, depth=depth).init(jax.random.PRNGKey(seed), x)
        params[case] = jax.tree.map(np.asarray, p["params"])
    return x, y, params


class _Rule(torch.nn.Module):
    """tests/test_models.py's param_shardings tree as parameters."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Parameter(torch.zeros(3, 16))
        self.odd = torch.nn.Parameter(torch.zeros(3, 7))
        self.tiny = torch.nn.Parameter(torch.zeros(4))


def _mesh_rank(rank, init_file, in_path, out_path):
    import datetime
    import pickle

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(in_path, "rb") as f:
            x, y, params = pickle.load(f)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        out = {}
        for case, (modes, width, depth, _, shape, dp, tp) in MESH_CASES.items():
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("dp",) if len(shape) == 1 else ("dp", "tp"))
            model = tm.load_flax_params(tm.FNO1d(modes=modes, width=width, depth=depth, in_channels=1,
                                                 device="cpu"), params[case])
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            if case == "dp":
                step = tm.make_data_parallel_step(model, opt, mesh, axis="dp")
            else:
                step, shard = tm.make_gspmd_step(model, opt, mesh, dp_axis=dp, tp_axis=tp)
                shard()
            losses = [float(step(xt, yt)) for _ in range(MESH_STEPS)]
            got = {}
            for k, p in model.named_parameters():
                if isinstance(p, DTensor):
                    got[k] = (p.full_tensor().detach().numpy(),
                              [f"Shard({q.dim})" if q.is_shard() else type(q).__name__ for q in p.placements])
                else:
                    got[k] = (p.detach().numpy(), None)
            out[case] = (losses, got)
        tp_mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("tp",))
        fno = tm.FNO1d(modes=8, width=16, depth=2, in_channels=1, device="cpu")
        out["rule"] = {k: repr(v) for m in (fno, _Rule()) for k, v in tm.param_shardings(m, tp_mesh, "tp").items()}
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    import multiprocessing
    import pickle

    tmp = tmp_path_factory.mktemp("gloo_models")
    inputs = _mesh_inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, str(tmp / "init"), str(tmp / "in.pkl"), str(tmp / "out.pkl")))
             for r in range(8)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(tmp / "out.pkl", "rb") as f:
        return inputs, pickle.load(f)


def _jax_mesh_run(case, x, y, params):
    """The JAX package's mesh step of ``case`` from the same flax weights:
    (losses, params as the port names them)."""
    from jax.sharding import Mesh

    modes, width, depth, _, shape, dp, tp = MESH_CASES[case]
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.asarray(devs[:8]).reshape(shape), ("dp",) if len(shape) == 1 else ("dp", "tp"))
    model = jm.FNO1d(modes=modes, width=width, depth=depth)
    p = {"params": jax.tree.map(jnp.asarray, params)}
    opt = optax.adam(1e-3)
    s = opt.init(p)
    if case == "dp":
        step = jtrain.make_data_parallel_step(model.apply, opt, mesh, axis="dp")
    else:
        step, shard = jtrain.make_gspmd_step(model.apply, opt, mesh, dp_axis=dp, tp_axis=tp)
        p, s = shard(p, s)
    losses = []
    for _ in range(MESH_STEPS):
        p, s, loss = step(p, s, x, y)
        losses.append(float(loss))
    return losses, _torch_names(jax.tree.map(np.asarray, p["params"]))


def _single_device_run(case, x, y, params):
    modes, width, depth = MESH_CASES[case][:3]
    model = tm.load_flax_params(tm.FNO1d(modes=modes, width=width, depth=depth, in_channels=1, device="cpu"),
                                params)
    step = tm.make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))) for _ in range(MESH_STEPS)]
    return losses, {k: p.detach().numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_step_matches_jax_and_single_device(mesh_world, case):
    (x, y, params), out = mesh_world
    losses, got = out[case]
    for ref_losses, ref in (_jax_mesh_run(case, x, y, params[case]), _single_device_run(case, x, y, params[case])):
        for a, b in zip(losses, ref_losses):
            assert abs(a - b) <= 1e-5 * abs(b), (case, losses, ref_losses)
        assert got.keys() == ref.keys()
        for k, (g, _) in got.items():
            assert np.abs(g - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), (case, k)
    placed = {k: pl for k, (_, pl) in got.items()}
    if MESH_CASES[case][-1] is not None:  # FSDP over tp: every parameter a DTensor, some on the rule's dim
        assert all(pl is not None for pl in placed.values()), placed
        assert any(pl[-1] != "Shard(0)" for pl in placed.values()), placed
    else:
        assert all(pl is None for pl in placed.values()), placed


def test_param_shardings_rule(mesh_world):
    """Per parameter, the JAX rule on the flax tree: the port shards the dim
    that holds flax's last axis (a Linear weight's dim 0) exactly where the
    JAX layout shards that axis over tp; the tests/test_models.py tree too."""
    from jax.sharding import Mesh

    _, out = mesh_world
    rule = out["rule"]
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.asarray(devs[:8]), ("tp",))
    x = np.zeros((1, 64, 1), np.float32)
    flax_params = jm.FNO1d(modes=8, width=16, depth=2).init(jax.random.PRNGKey(0), x)["params"]
    want = {}
    specs = jtrain.param_shardings(flax_params, mesh, "tp")
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    for path, sh in flat:
        name = ".".join(str(getattr(e, "key", e)) for e in path)
        sharded = "tp" in str(sh.spec)
        if name.endswith(".kernel"):
            want[name[: -len("kernel")] + "weight"] = "Shard(dim=0)" if sharded else "Replicate()"
        else:
            ndim = len(_flatten(flax_params)[name].shape)
            want[name] = f"Shard(dim={ndim - 1})" if sharded else "Replicate()"
    got = {k: v for k, v in rule.items() if k not in ("dense", "odd", "tiny")}
    assert got == want
    assert any(v.startswith("Shard") for v in got.values()) and any(v == "Replicate()" for v in got.values())
    assert (rule["dense"], rule["odd"], rule["tiny"]) == ("Shard(dim=1)", "Replicate()", "Replicate()")


def test_all_names_resolve():
    assert all(hasattr(tm, n) for n in tm.__all__)
    assert set(tm.__all__) - {"load_flax_params"} <= set(jm.__all__)
