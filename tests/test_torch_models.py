"""Torch port, ``models/deepctr.py`` against the JAX package's flax
modules: the forward of ``LogisticRegression``, ``WideDeep``, ``DeepFM``,
``XDeepFM`` and ``DCN`` on fused and per-feature rows, with and without
dense features, and the gradients of the loss with respect to the dense
parameters and the rows (``jax.value_and_grad(argnums=(0, 1))`` against
``torch.autograd.grad``), with the flax parameters carried over by
``interop``, at rtol 1e-5; and each model's parameter names, shapes,
flax order of creation and initial values (``init_params`` against
``module.init`` with nothing copied)."""

import math

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from openembedding_tpu import training as jax_training
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import initializers as ti

FEATURES = ("C1", "C2", "C3", "C4")
DIM, NUM_DENSE, BATCH = 4, 13, 32
RTOL, ATOL = 1e-5, 1e-6


def _rows(fused: bool, rng):
    if fused:
        return {"fields": rng.randn(BATCH, len(FEATURES), DIM),
                "fields:linear": rng.randn(BATCH, len(FEATURES), 1)}
    out = {}
    for f in FEATURES:
        out[f] = rng.randn(BATCH, DIM)
        out[f + ":linear"] = rng.randn(BATCH, 1)
    return out


MODELS = {
    "lr": ({}, {"num_dense": NUM_DENSE}),
    "lr_no_dense": ({}, {"num_dense": 0}),
    "wdl": ({"dnn_units": (16, 8)},
            {"embedding_dim": DIM, "num_dense": NUM_DENSE,
             "dnn_units": (16, 8)}),
    "deepfm": ({"dnn_units": (16, 8)},
               {"embedding_dim": DIM, "num_dense": NUM_DENSE,
                "dnn_units": (16, 8)}),
    "xdeepfm": ({"dnn_units": (16, 8), "cin_layer_sizes": (8, 8)},
                {"embedding_dim": DIM, "num_dense": NUM_DENSE,
                 "dnn_units": (16, 8), "cin_layer_sizes": (8, 8),
                 "cin_split_half": False, "cin_bias": False}),
    "xdeepfm_no_dense": ({"dnn_units": (16, 8), "cin_layer_sizes": (8, 8)},
                         {"embedding_dim": DIM, "num_dense": 0,
                          "dnn_units": (16, 8), "cin_layer_sizes": (8, 8),
                          "cin_split_half": False, "cin_bias": False}),
    "dcn": ({"dnn_units": (16, 8)},
            {"embedding_dim": DIM, "num_dense": NUM_DENSE,
             "dnn_units": (16, 8)}),
    "dcn_no_dense": ({"dnn_units": (16, 8)},
                     {"embedding_dim": DIM, "num_dense": 0,
                      "dnn_units": (16, 8)}),
}


def _pair(name):
    jkw, tkw = MODELS[name]
    kind = name.split("_")[0]
    return (jax_models.build_model(kind, FEATURES, **jkw),
            tm.build_model(kind, FEATURES, **tkw),
            tkw.get("num_dense", NUM_DENSE))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_grads_match_flax(name, fused):
    rng = np.random.RandomState(0)
    rows = {k: v.astype(np.float32) for k, v in _rows(fused, rng).items()}
    jmod, tmod, num_dense = _pair(name)
    dense = rng.randn(BATCH, NUM_DENSE).astype(np.float32) \
        if num_dense else None
    labels = (rng.rand(BATCH) > 0.5).astype(np.float32)
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    jdense = None if dense is None else jnp.asarray(dense)
    jparams = jmod.init(jax.random.PRNGKey(1), jdense, jrows)["params"]
    # non-zero biases, so the bias terms are exercised
    jparams = jax.tree.map(
        lambda p: p + 0.01 * jnp.arange(p.size, dtype=p.dtype).reshape(
            p.shape), jparams)
    params = interop.dense_params_from_flax(tmod, jparams, "cpu")
    assert set(params) == {k for k, _ in tmod.named_parameters()}

    def lfn(p, r):
        return jax_training.binary_logloss(jmod.apply({"params": p}, jdense,
                                                      r), jnp.asarray(labels))

    jloss, (jgp, jgr) = jax.value_and_grad(lfn, argnums=(0, 1))(jparams,
                                                                  jrows)
    jlogits = jmod.apply({"params": jparams}, jdense, jrows)

    tparams = {k: v.requires_grad_() for k, v in params.items()}
    trows = {k: torch.from_numpy(v).requires_grad_()
             for k, v in rows.items()}
    tdense = None if dense is None else torch.from_numpy(dense)
    logits = functional_call(tmod, tparams, (tdense, trows))
    loss = tr.binary_logloss(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(
        loss, list(tparams.values()) + list(trows.values()),
        allow_unused=True, materialize_grads=True)
    _close(logits.detach().numpy(), jlogits)
    _close(loss.item(), jloss)
    gp = dict(zip(tparams, grads[:len(tparams)]))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jgp)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        interop.dense_params_to_flax(gp))[0])
    assert set(flat_t) == set(flat_j)
    for path, g in flat_j.items():
        _close(flat_t[path], g)
    for k, g in zip(trows, grads[len(tparams):]):
        _close(g.numpy(), jgr[k])


def test_param_names_and_init_follow_flax():
    """Flax's names, kernels transposed, and flax's initial-value rule:
    lecun_normal kernels (truncated at 2 standard deviations of
    sqrt(1/fan_in)/0.8796) drawn from flax's keys, so equal to JAX's
    ``module.init`` within the ``erf_inv`` bound, zero biases, one draw
    per key."""
    jmod, tmod, _ = _pair("deepfm")
    rng = np.random.RandomState(0)
    jrows = {k: jnp.asarray(v, jnp.float32)
             for k, v in _rows(True, rng).items()}
    jparams = jmod.init(jax.random.PRNGKey(0),
                        jnp.zeros((BATCH, NUM_DENSE)), jrows)["params"]
    want = {".".join(str(getattr(k, "key", k)) for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = jax.tree_util.tree_flatten_with_path(interop.dense_params_to_flax(
        {k: v.detach() for k, v in tmod.named_parameters()}))[0]
    assert {".".join(str(getattr(k, "key", k)) for k in path): v.shape
            for path, v in got} == want
    # the port draws flax's values from flax's keys: equal to JAX's
    # module.init(PRNGKey(0)) within the erf_inv bound
    p1 = tm.init_params(tmod, ti.prng_key(0), "cpu")
    p2 = tm.init_params(tmod, ti.prng_key(0), "cpu")
    jp = interop.dense_params_from_flax(tmod, jparams, "cpu")
    for k, v in p1.items():
        assert torch.equal(v, p2[k])
        if k.endswith("weight"):
            std = math.sqrt(1.0 / v.shape[1]) / 0.87962566103423978
            assert float(v.abs().max()) <= 2 * std + 1e-6
            bound = 2.0**-21 * (jp[k].abs() + std)
            assert bool(((v - jp[k]).abs() <= bound).all())
            if v.numel() >= 256:      # the sample's spread means something
                assert 0.5 * std < float(v.std()) < 1.5 * std
        else:
            assert torch.equal(v, torch.zeros_like(v))
    for name, cls in (("xdeepfm", tm.XDeepFM), ("dcn", tm.DCN)):
        assert type(tm.build_model(name, FEATURES, embedding_dim=DIM)) is cls
    with pytest.raises(ValueError, match="unknown model"):
        tm.build_model("nope", FEATURES)


def _flax_order(module) -> dict:
    """Each torch scope's modules, then its parameters, under flax's
    names: the order the flax module creates them in when every scope
    creates its own parameters last (true of all five models)."""
    out = {}
    for scope, m in module.named_modules():
        leaves = [interop.flax_path(n)[-1]
                  for n, _ in m.named_parameters(recurse=False)]
        out[scope] = [n for n, _ in m.named_children()] + leaves
    return out


@pytest.mark.parametrize("name", ["xdeepfm", "dcn"])
def test_new_models_follow_flax_names_order_and_init(name):
    """xDeepFM and DCN: flax's parameter names and shapes (``cin_w_i``
    ``[H_k·F, h]`` and ``cross_w_k`` ``[d, 1]`` untransposed), the scopes
    in flax's order of creation, and ``init_params`` equal to
    ``module.init(PRNGKey(s))`` with nothing copied: the glorot_uniform
    weights and the zeros exactly (JAX's uniform draw compiled, its scale
    applied eagerly, one float32 multiply, as the port does), the
    lecun_normal kernels within the ``erf_inv`` bound of
    ``test_param_names_and_init_follow_flax``."""
    jmod, tmod, _ = _pair(name)
    rng = np.random.RandomState(0)
    jrows = {k: jnp.asarray(v, jnp.float32)
             for k, v in _rows(True, rng).items()}
    for seed in (0, 7):
        jparams = jmod.init(jax.random.PRNGKey(seed),
                            jnp.zeros((BATCH, NUM_DENSE)), jrows)["params"]
        order = _flax_order(tmod)

        def walk(tree, scope=""):
            assert list(tree) == order[scope], scope
            for k, v in tree.items():
                if not hasattr(v, "shape"):
                    walk(v, f"{scope}.{k}" if scope else k)
        walk(jparams)
        want = interop.dense_params_from_flax(tmod, jparams, "cpu")
        got = tm.init_params(tmod, ti.prng_key(seed), "cpu")
        assert set(got) == set(want)
        glorot = [k for k in got if "cin_w_" in k or "cross_w_" in k]
        assert glorot
        for k, v in got.items():
            assert v.shape == want[k].shape, k
            if k.endswith(".weight"):
                std = math.sqrt(1.0 / v.shape[1]) / 0.87962566103423978
                bound = 2.0**-21 * (want[k].abs() + std)
                assert bool(((v - want[k]).abs() <= bound).all()), k
            else:
                assert torch.equal(v, want[k]), k
        assert all(float(got[k].abs().max()) > 0 for k in glorot)
