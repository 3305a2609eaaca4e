"""Torch port, sparse optimizers: ``update_rows`` of all nine categories
against the JAX package's on the same numpy blocks, and
``table.optimizer_block_update`` on bf16-weight blocks.

The port writes each update expression for expression as the JAX package
does; the two still round differently in places (XLA may fuse and
contract), so the comparison holds at rtol 1e-6, atol 1e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openembedding_tpu import table as jax_table
from openembedding_tpu.optim import optimizers as jax_opt
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import table as tt
from openembedding_tpu_torch.optim import optimizers as to

RTOL, ATOL = 1e-6, 1e-7

CONFIGS = [
    {"category": "default"},
    {"category": "default", "learning_rate": 0.3},
    {"category": "adadelta", "learning_rate": 0.5},
    {"category": "adagrad", "learning_rate": 0.05},
    {"category": "adam", "learning_rate": 0.01},
    {"category": "adamax", "learning_rate": 0.01},
    {"category": "ftrl", "learning_rate": 0.05},
    {"category": "ftrl", "learning_rate": 0.05,
     "l1_regularization_strength": 0.01, "l2_regularization_strength": 0.1,
     "l2_shrinkage_regularization_strength": 0.02, "beta": 0.3},
    {"category": "rmsprop", "learning_rate": 0.01, "momentum": 0.5},
    {"category": "sgd", "learning_rate": 0.1},
    {"category": "sgd", "learning_rate": 0.1, "momentum": 0.9,
     "nesterov": True},
    {"category": "test", "learning_rate": 0.5},
]


def _ids(cfg):
    return "-".join(f"{v}" for v in cfg.values())


def _block(cfg, rows=37, dim=9, seed=0):
    """Weights, slots, summed grads and counts for one block, as numpy."""
    rng = np.random.RandomState(seed)
    opt = jax_opt.make_optimizer(cfg)
    w = rng.randn(rows, dim).astype(np.float32)
    slots = {k: rng.uniform(0.1, 0.9, (rows,) + s).astype(np.float32)
             for k, s in opt.slot_shapes(dim).items()}
    grads = (rng.randn(rows, dim) * 0.5).astype(np.float32)
    counts = rng.randint(0, 4, rows).astype(np.int32)
    return w, slots, grads, counts


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_update_rows_matches_jax(cfg):
    w, slots, grads, counts = _block(cfg)
    jw, js = jax_opt.make_optimizer(cfg).update_rows(
        jnp.asarray(w), {k: jnp.asarray(v) for k, v in slots.items()},
        jnp.asarray(grads), jnp.asarray(counts))
    tw, ts = to.make_optimizer(cfg).update_rows(
        torch.from_numpy(w), {k: torch.from_numpy(v)
                              for k, v in slots.items()},
        torch.from_numpy(grads), torch.from_numpy(counts))
    assert set(ts) == set(js)
    _close(tw, jw)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        _close(ts[k], js[k])


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_block_update_bf16_weights_matches_jax(cfg):
    """bf16 weights, f32 slots: both run the maths at f32 and cast the
    weights back to bf16."""
    w, slots, grads, counts = _block(cfg, seed=1)
    w16 = np.asarray(jnp.asarray(w, jnp.bfloat16))
    jopt = jax_opt.make_optimizer(cfg)
    topt = to.make_optimizer(cfg)
    jw, js = jax_table.optimizer_block_update(
        jopt, jnp.asarray(w16), {k: jnp.asarray(v) for k, v in slots.items()},
        jnp.asarray(grads), jnp.asarray(counts))
    tw, ts = tt.optimizer_block_update(
        topt, interop.tensor_from_numpy(w16, "cpu"),
        {k: torch.from_numpy(v) for k, v in slots.items()},
        torch.from_numpy(grads), torch.from_numpy(counts))
    assert tw.dtype == torch.bfloat16 and jw.dtype == jnp.bfloat16
    np.testing.assert_array_equal(interop.tensor_to_numpy(tw),
                                  np.asarray(jw).view(np.uint16))
    for k in js:
        assert ts[k].dtype == torch.float32
        _close(ts[k], js[k])


def test_ftrl_generic_power_within_pow_rounding():
    """FTRL with ``learning_rate_power != -0.5`` takes ``accum ** p``.
    Neither XLA's float32 power nor PyTorch's is correctly rounded (each
    is one unit in the last place off the float64 root for about 8 % of
    inputs, at different inputs), and FTRL subtracts two such powers. So
    the port is held to JAX within what one unit of rounding in each
    power can move the result: the bound below propagates a relative
    error of 2^-23 in ``pow_new`` and ``pow_old`` through the update, with
    a factor of 4 to spare."""
    cfg = {"category": "ftrl", "learning_rate": 0.05,
           "learning_rate_power": -0.7, "l1_regularization_strength": 0.01,
           "l2_regularization_strength": 0.1,
           "l2_shrinkage_regularization_strength": 0.02, "beta": 0.3}
    w, slots, grads, counts = _block(cfg, rows=200)
    jw, js = jax_opt.make_optimizer(cfg).update_rows(
        jnp.asarray(w), {k: jnp.asarray(v) for k, v in slots.items()},
        jnp.asarray(grads), jnp.asarray(counts))
    tw, ts = to.make_optimizer(cfg).update_rows(
        torch.from_numpy(w), {k: torch.from_numpy(v)
                              for k, v in slots.items()},
        torch.from_numpy(grads), torch.from_numpy(counts))
    eps, lr, p = 2.0 ** -23, 0.05, 0.7
    acc = slots["accum"].astype(np.float64)
    pow_new, pow_old = (acc + grads.astype(np.float64) ** 2) ** p, acc ** p
    quad = pow_new / lr + 2 * (0.1 + 0.3 / lr / 2)
    d_lin = np.abs(w) * (pow_new + pow_old) * eps / lr
    d_w = (2 * d_lin + np.abs(np.asarray(jw)) * pow_new * eps / lr) / quad
    for got, want, bound in ((tw, jw, d_w), (ts["linear"], js["linear"],
                                               d_lin)):
        err = np.abs(got.numpy().astype(np.float64)
                     - np.asarray(want, np.float64))
        assert np.all(err <= 4 * bound + ATOL + RTOL * np.abs(
            np.asarray(want))), float((err - 4 * bound).max())
    _close(ts["accum"], js["accum"])
