"""The optimizers of the JAX package's trainer registry, with optax 0.2.6's
formulas (counterpart of ``_make_optimizer`` in the JAX package's
``models/estimator.py``).

Each optimizer is a pair of plain tensor functions over a flat
``{name: tensor}`` dict of trainable variables, as optax's
``GradientTransformation`` over its pytree: ``init(params) -> state`` and
``update(grads, state) -> (updates, state)``; :func:`apply_updates` adds
the updates into new tensors. ``torch.optim`` is not used: its Adagrad
starts the accumulator at 0 and adds eps outside the root, and its RMSprop
adds eps outside the root, where optax's do neither.

A state is a dict of its fields, in optax's field order; a field holds one
tensor (adam's int32 ``count``) or a ``{name: tensor}`` dict.
:func:`state_leaves` flattens it as ``jax.tree_util.tree_flatten`` flattens
optax's state (fields in order, dict entries by sorted name), which is the
layout of a checkpoint's ``opt_state``.
"""

import numpy as np
import torch


def _zeros(params, value=0.0):
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _bias_correction(moment, decay, count):
    """optax ``tree_bias_correction``: ``t / (1 - decay**count)``, the
    power in float32."""
    correction = 1 - torch.pow(
        torch.full((), decay, dtype=torch.float32, device=count.device),
        count)
    return {k: t / correction for k, t in moment.items()}


class Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the root,
    eps_root 0, bias-corrected moments, an int32 step count."""

    fields = ("count", "mu", "nu")

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        device = next((p.device for p in params.values()),
                      torch.device("cpu"))
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, grads, state):
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k]
              for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        updates = {k: -self.learning_rate
                   * (mu_hat[k] / (torch.sqrt(nu_hat[k]) + self.eps))
                   for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}


class Adagrad:
    """``optax.adagrad(lr)``: the accumulator starts at 0.1; the update is
    ``g * rsqrt(acc + 1e-7)``, 0 where the accumulator is 0."""

    fields = ("sum_of_squares",)

    def __init__(self, learning_rate, initial_accumulator_value=0.1,
                 eps=1e-7):
        self.learning_rate = learning_rate
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, params):
        return {"sum_of_squares": _zeros(params,
                                         self.initial_accumulator_value)}

    def update(self, grads, state):
        sums = {k: g * g + state["sum_of_squares"][k]
                for k, g in grads.items()}
        updates = {}
        for k, g in grads.items():
            inv = torch.where(sums[k] > 0, torch.rsqrt(sums[k] + self.eps),
                              torch.zeros_like(sums[k]))
            updates[k] = -self.learning_rate * (inv * g)
        return updates, {"sum_of_squares": sums}


class RMSprop:
    """``optax.rmsprop(lr, decay=0.9)``: ``nu = decay * nu + (1 - decay) *
    g**2`` from 0, the update ``g * rsqrt(nu + 1e-8)``, eps inside the
    root."""

    fields = ("nu",)

    def __init__(self, learning_rate, decay=0.9, eps=1e-8):
        self.learning_rate = learning_rate
        self.decay, self.eps = decay, eps

    def init(self, params):
        return {"nu": _zeros(params)}

    def update(self, grads, state):
        d = self.decay
        nu = {k: (1 - d) * (g * g) + d * state["nu"][k]
              for k, g in grads.items()}
        updates = {k: -self.learning_rate
                   * (torch.rsqrt(nu[k] + self.eps) * g)
                   for k, g in grads.items()}
        return updates, {"nu": nu}


class SGD:
    """``optax.sgd(lr)`` without momentum: the update is ``-lr * g`` and
    the state holds nothing. Not in the trainer registry (nor is it in the
    JAX package's); with ``lr = 1`` the step's variable delta is the
    gradient, which is how the tests compare gradients."""

    fields = ()

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, params):
        return {}

    def update(self, grads, state):
        return {k: -self.learning_rate * g for k, g in grads.items()}, {}


_TRAINERS = {"adagrad": Adagrad, "adam": Adam,
             "rmsprop": lambda lr: RMSprop(lr, decay=0.9)}


def make_optimizer(name, learning_rate):
    """Optimizer by the JAX package's trainer name (config ``trainer``):
    'adam', 'adagrad' or 'rmsprop'."""
    try:
        return _TRAINERS[name](learning_rate)
    except KeyError:
        raise ValueError(f"unknown trainer '{name}' (known: "
                         f"{sorted(_TRAINERS)})") from None


def apply_updates(params, updates):
    """New tensors ``p + u`` (optax ``apply_updates``), in p's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def state_leaves(optimizer, state):
    """The state's tensors in the order of optax's flattened leaves."""
    leaves = []
    for field in optimizer.fields:
        value = state[field]
        if isinstance(value, dict):
            leaves += [value[k] for k in sorted(value)]
        else:
            leaves.append(value)
    return leaves


def state_from_leaves(optimizer, leaves, names, device):
    """Inverse of :func:`state_leaves` for the trainable ``names``: a
    state of tensors on ``device`` from arrays in optax's leaf order.
    Raises ValueError when the count of leaves does not fit."""
    names = sorted(names)
    leaves = list(leaves)
    sizes = [1 if field == "count" else len(names)
             for field in optimizer.fields]
    if len(leaves) != sum(sizes):
        raise ValueError(f"{len(leaves)} optimizer-state leaves; "
                         f"{type(optimizer).__name__} over {len(names)} "
                         f"trainable variables has {sum(sizes)}")
    state, at = {}, 0
    for field, size in zip(optimizer.fields, sizes):
        tensors = [torch.from_numpy(np.array(leaf)).to(device)
                   for leaf in leaves[at:at + size]]
        state[field] = (tensors[0] if field == "count"
                        else dict(zip(names, tensors)))
        at += size
    return state
