"""Training steps for the model family.

Port of the single-device part of ``gpu_fft_tpu/models/train.py``:
``mse``, ``make_train_step`` and ``fit``, on a ``torch.optim`` optimizer
with the parameters in the module, as PyTorch keeps them.
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is optax.adam's
update rule.  The mesh steps are ROADMAP item 15.
"""

from __future__ import annotations

import torch

__all__ = ["mse", "make_train_step", "fit"]


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
