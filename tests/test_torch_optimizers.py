"""The port's optimizers (``ops/optimizers.py``) against optax 0.2.6, which
the JAX package's trainer registry builds, on the CPU.

Each runs five steps on the same seeded gradient sequence from the same
parameters; the parameters and every state leaf must agree at rtol 1e-6
(atol 1e-7 for values near 0) after each step. The state's leaves come in
optax's flattened order, so a checkpoint's ``opt_state`` of one package
loads in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modular_semantic_segmentation_tpu.models.estimator import \
    _make_optimizer as jax_make_optimizer
from modular_semantic_segmentation_torch.ops import optimizers

SHAPES = {"b/kernel": (3, 3, 4, 5), "a/bias": (5,), "c/gamma": (7,)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch on one intra-op thread while JAX runs in the same process
    (ROADMAP.md section 3, item 4)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shape).astype(np.float32)
            for k, shape in SHAPES.items()}


def _gradients(seed, steps=5):
    """Seeded gradients over several magnitudes, with exact zeros (the
    adagrad and rmsprop branches at 0)."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(steps):
        grads = {}
        for k, shape in SHAPES.items():
            g = rng.randn(*shape) * 10.0 ** rng.randint(-4, 2, shape)
            g[rng.rand(*shape) < 0.1] = 0.0
            grads[k] = g.astype(np.float32)
        out.append(grads)
    return out


def _assert_close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7, err_msg=name)


def _run_both(jax_optimizer, optimizer, steps):
    params = _params(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_optimizer.init(jparams)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = optimizer.init(tparams)
    for i, grads in enumerate(_gradients(1, steps)):
        updates, jstate = jax_optimizer.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updates, tstate = optimizer.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        tparams = optimizers.apply_updates(tparams, updates)
        for k in SHAPES:
            _assert_close(tparams[k], jparams[k], f"step {i} {k}")
        leaves = jax.tree_util.tree_flatten(jstate)[0]
        tleaves = optimizers.state_leaves(optimizer, tstate)
        assert len(tleaves) == len(leaves)
        for j, (got, want) in enumerate(zip(tleaves, leaves)):
            assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
            _assert_close(got, want, f"step {i} leaf {j}")
    return jstate, tstate


@pytest.mark.parametrize("trainer,learning_rate",
                         [("adam", 0.01), ("adagrad", 0.1),
                          ("rmsprop", 0.01)])
def test_optimizer_matches_optax(trainer, learning_rate):
    _run_both(jax_make_optimizer(trainer, learning_rate),
              optimizers.make_optimizer(trainer, learning_rate), 5)


def test_sgd_matches_optax():
    _run_both(optax.sgd(1.0), optimizers.SGD(1.0), 2)


@pytest.mark.parametrize("trainer", ["adam", "adagrad", "rmsprop"])
def test_opt_state_carries_across(trainer):
    """optax's flattened leaves -> the port's state -> the same leaves;
    a wrong number of leaves is refused."""
    jstate, _ = _run_both(jax_make_optimizer(trainer, 0.01),
                          optimizers.make_optimizer(trainer, 0.01), 2)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_flatten(jstate)[0]]
    optimizer = optimizers.make_optimizer(trainer, 0.01)
    state = optimizers.state_from_leaves(optimizer, leaves, list(SHAPES),
                                         "cpu")
    back = [t.numpy() for t in optimizers.state_leaves(optimizer, state)]
    assert len(back) == len(leaves)
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="leaves"):
        optimizers.state_from_leaves(optimizer, leaves[:-1], list(SHAPES),
                                     "cpu")


def test_unknown_trainer_is_refused():
    with pytest.raises(ValueError, match="unknown trainer"):
        optimizers.make_optimizer("sgd", 0.1)
