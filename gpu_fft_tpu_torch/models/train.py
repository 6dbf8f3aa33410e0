"""Training steps for the model family.

Port of ``gpu_fft_tpu/models/train.py`` on a ``torch.optim`` optimizer with
the parameters in the module, as PyTorch keeps them.
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is optax.adam's
update rule.  ``make_train_step`` is the single-device step; the mesh steps
run on a ``torch.distributed`` device mesh:

* :func:`make_data_parallel_step` — batch rows sharded over one mesh axis,
  parameters replicated, one all-reduce of the gradients and the loss (the
  JAX step's ``pmean``) before the update;
* :func:`make_gspmd_step` — batch rows over ``dp``, parameters sharded over
  ``tp`` by :func:`param_shardings`, through FSDP2's ``fully_shard`` (with
  both axes: replicated over ``dp``, sharded over ``tp``), so the
  optimizer's state follows the sharded parameters as optax's mirrors the
  parameter tree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["mse", "make_train_step", "make_data_parallel_step", "make_gspmd_step", "param_shardings", "fit"]


def mse(pred, target):
    """Mean-squared error over all axes."""
    return torch.mean((pred - target) ** 2)


def make_train_step(model, optimizer, loss_fn=mse):
    """``step(x, y) -> loss``: zero the gradients, run the forward and the
    backward, and take one ``optimizer`` step on ``model``'s parameters.
    The loss comes back as a detached 0-d tensor on the model's device."""

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _last_axis_shards(shape, size) -> bool:
    """The single layout rule shared by params and optimizer state: an
    array shards its LAST axis over the mesh axis iff that axis is
    divisible by (and at least) the axis size."""
    return bool(shape) and shape[-1] % size == 0 and shape[-1] >= size


def _check_batch_divisible(x, size, axis_name):
    if x.shape[0] % size:
        raise ValueError(
            f"batch dimension {x.shape[0]} must be divisible by mesh axis "
            f"{axis_name!r} (size {size}) — pad or rebatch the data"
        )


def _batch_shard(x, mesh, axis):
    """This rank's rows of the global batch ``x`` (all of it for no axis)."""
    from ..parallel import _sharding as S

    return S.to_local(S.global_tensor(x, mesh), mesh, S.placements(mesh, {axis: 0}))


def _mean_over(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``t`` summed over ``axis``'s ranks and divided by their number (JAX:
    ``pmean``; ``ReduceOp.AVG`` is NCCL's alone).  In place."""
    from ..parallel import _sharding as S

    if axis is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=S.group(mesh, axis))
        t /= S.axis_size(mesh, axis)
    return t


def _average(params, loss, mesh, axis):
    """Every parameter's gradient (zero where it has none, as ``jax.grad``
    gives) and the loss, averaged over ``axis`` in ONE all-reduce of a flat
    buffer; the gradients are set from it.  Returns the averaged loss."""
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params]
                     + [loss.detach().reshape(1)])
    _mean_over(flat, mesh, axis)
    at = 0
    for p in params:
        p.grad = flat[at : at + p.numel()].view_as(p)
        at += p.numel()
    return flat[-1]


def make_data_parallel_step(model, optimizer, mesh, axis="dp", loss_fn=mse):
    """Data-parallel ``step(x, y) -> loss`` over ``mesh``'s ``axis``.

    Batch rows shard over ``axis`` (``x`` / ``y`` global tensors that every
    rank holds, or DTensors); parameters and optimizer state are
    replicated: broadcast from the axis's rank 0 here, once.  Each rank
    computes its local loss and gradient (every spectral transform
    batch-local: no collective in the forward or backward), then ONE
    all-reduce of every gradient and the loss, in one flat buffer, divided
    by the axis size, then ``optimizer.step()``: every replica applies the
    identical update, so the parameters stay replicated.

    The leading batch dimension must be divisible by the axis size; the
    step raises ValueError otherwise.
    """
    from ..parallel import _sharding as S

    size = S.axis_size(mesh, axis)
    g = S.group(mesh, axis)
    params = list(model.parameters())
    with torch.no_grad():
        for p in params:
            dist.broadcast(p.data, src=dist.get_global_rank(g, 0), group=g)

    def step(x, y):
        _check_batch_divisible(x, size, axis)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(_batch_shard(x, mesh, axis)), _batch_shard(y, mesh, axis))
        loss.backward()
        loss = _average(params, loss, mesh, axis)
        optimizer.step()
        return loss

    return step


def _feature_axes(model) -> dict:
    """Each parameter's axis that JAX's last axis names: a ``Linear.weight``
    is flax's (in, out) kernel transposed, so its output features are dim
    0; every other parameter keeps flax's layout."""
    axes = {name: p.dim() - 1 for name, p in model.named_parameters()}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            axes[f"{mod_name}.weight" if mod_name else "weight"] = 0
    return axes


def param_shardings(model, mesh, axis="tp"):
    """The tensor-parallel layout of ``model``'s parameters over ``axis``:
    ``{name: Shard(dim) or Replicate()}``.

    JAX's rule (``_last_axis_shards``): an array shards its last axis when
    that axis divides by the axis size.  Dense kernels and biases split
    their output features, spectral-conv weights their kept modes.  A
    ``Linear.weight`` holds flax's kernel transposed, (out, in), so its
    output features are dim 0 here.  Correctness never depends on the rule.
    """
    from torch.distributed.tensor import Replicate, Shard

    from ..parallel import _sharding as S

    size = S.axis_size(mesh, axis)
    axes = _feature_axes(model)
    return {name: Shard(axes[name]) if _last_axis_shards((p.shape[axes[name]],), size) else Replicate()
            for name, p in model.named_parameters()}


def make_gspmd_step(model, optimizer, mesh, dp_axis=None, tp_axis=None, loss_fn=mse):
    """2-D-parallel train step: batch rows over ``dp_axis``, parameters over
    ``tp_axis`` per :func:`param_shardings`.

    Returns ``(step, shard_params)``.  ``shard_params()`` puts ``model``'s
    parameters (replicated so far) and ``optimizer``'s state on the mesh
    layout, in place, and returns ``(model, optimizer)``: with ``tp_axis``
    through FSDP2's ``fully_shard`` over ``mesh[tp_axis]``, or over the
    (dp, tp) mesh with both axes (replicated over dp, sharded over tp), each
    parameter on its :func:`param_shardings` dim; a parameter the rule
    replicates takes FSDP's default, dim 0 (a layout difference: JAX keeps
    it whole).  FSDP gathers the parameters for the forward and
    reduce-scatters the gradients, whose average over the tp ranks (each
    saw the same rows) and over dp is the step's gradient.  Without
    ``tp_axis`` the parameters stay replicated and the step all-reduces
    the gradients over ``dp_axis`` itself.  Either axis may be None.
    ``step(x, y) -> loss`` takes global ``x`` / ``y`` (or DTensors) and
    returns the loss averaged over ``dp_axis``.
    """
    from ..parallel import _sharding as S

    if dp_axis is not None:
        dp_size = S.axis_size(mesh, dp_axis)

    def shard_params():
        if tp_axis is None:
            return model, optimizer
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard, distribute_tensor

        rule = param_shardings(model, mesh, tp_axis)
        old = dict(model.named_parameters())
        by_id = {id(p): rule[name] for name, p in old.items()}
        sub = mesh[(dp_axis, tp_axis)] if dp_axis is not None else mesh[tp_axis]
        fully_shard(model, mesh=sub,
                    shard_placement_fn=lambda p: by_id[id(p)] if isinstance(by_id[id(p)], Shard) else None)
        new = dict(model.named_parameters())
        swap = {id(old[k]): new[k] for k in old}
        for group in optimizer.param_groups:
            group["params"] = [swap[id(p)] for p in group["params"]]
        for p_old in old.values():
            state = optimizer.state.pop(p_old, None)
            if state is not None:
                p = swap[id(p_old)]
                optimizer.state[p] = {
                    k: distribute_tensor(v, p.device_mesh, p.placements)
                    if torch.is_tensor(v) and v.shape == p.shape else v
                    for k, v in state.items()
                }
        return model, optimizer

    def step(x, y):
        if dp_axis is not None:
            _check_batch_divisible(x, dp_size, dp_axis)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(_batch_shard(x, mesh, dp_axis)), _batch_shard(y, mesh, dp_axis))
        loss.backward()
        if tp_axis is None:  # replicated parameters: the data-parallel reduction
            loss = _average(list(model.parameters()), loss, mesh, dp_axis)
        else:  # FSDP has reduced the gradients
            loss = _mean_over(loss.detach().clone(), mesh, dp_axis)
        optimizer.step()
        return loss

    return step, shard_params


def fit(step, data, steps):
    """Run ``steps`` updates cycling over ``data`` (a list of (x, y)).

    Returns the per-step losses as host floats — a convenience loop for
    examples and tests.  The JAX version returns ``(params, opt_state,
    losses)``; here the parameters and the optimizer state live in the
    module and the optimizer.
    """
    losses = []
    for i in range(steps):
        x, y = data[i % len(data)]
        losses.append(float(step(x, y)))
    return losses
