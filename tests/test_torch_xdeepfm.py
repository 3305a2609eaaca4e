"""Torch port, xDeepFM with DeepCTR's CIN (split half, a per-map bias)
against the benchmark's plain reference (``oebench/reference/xdeepfm.py``),
on the CPU at a small size: 5 fields of 8 floats, CIN (8, 6), tower
(16, 8), 3 dense features.

The logits and every leaf's gradient agree; the split passes the first
half of layer 1's maps on and pools the second; three
``Trainer.train_step`` steps over a fused array table agree with the
reference's three steps (``oebench/reference/train.py``); the default
``XDeepFM`` is the benchmark configuration's CIN; and the stage marks of
the CIN's forward and backward (``dense.cin``, ``dense.cin_grad``) leave
values and gradients as they were.

Tolerances: the port compresses each layer as one ``[B·D, H·F] x [H·F,
h]`` product and the reference with ``einsum`` over ``[B, H·F, D]``, the
same sums in another order, so float32 agrees to a few units of its
rounding (2^-24) times the terms summed (at most 40 a compression here,
82 a tower row): 1e-5 of a leaf's largest value covers that with room.
"""

import inspect
import json
import os
import statistics

import numpy as np
import pytest
import torch

from oebench import check, program, traffic
from oebench.initial import Initial
from oebench.reference import train as reference
from oebench.reference import xdeepfm as ref
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense as dense_opt
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.utils import observability as obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, D, NUM_DENSE, B = 5, 8, 3, 16
CIN, UNITS = (8, 6), (16, 8)
NAMES = tuple(f"C{j + 1}" for j in range(F))
REL = 1e-5          # of a leaf's largest value (module note)


def _config():
    """The benchmark's configuration, cut to the small size."""
    with open(os.path.join(REPO, "oebench", "configs",
                           "xdeepfm_dim64.json")) as f:
        cfg = json.load(f)
    cfg.update(num_features=F, embedding_dim=D, num_dense=NUM_DENSE,
               dnn_units=list(UNITS), cin_layer_sizes=list(CIN),
               vocab_sizes=[40, 7, 33, 50, 12], batch_size=32)
    return cfg


def _module(**kw):
    return tm.build_model("xdeepfm", NAMES, embedding_dim=D,
                          num_dense=NUM_DENSE, dnn_units=UNITS,
                          cin_layer_sizes=CIN, **kw)


def _inputs(seed=0, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    rows = {"fields": scale * torch.randn(B, F, D, generator=g),
            "fields:linear": scale * torch.randn(B, F, 1, generator=g)}
    dense = torch.rand(B, NUM_DENSE, generator=g)
    label = (torch.rand(B, generator=g) < 0.3).float()
    return rows, dense, label


def _params(module, seed):
    """Seeded weights for every leaf, biases too (zeros would hide them)."""
    g = torch.Generator().manual_seed(seed)
    return {k: 0.3 * torch.randn(v.shape, generator=g)
            for k, v in module.named_parameters()}


def _close(a, b, what):
    tol = REL * float(b.abs().max()) + 1e-12
    assert float((a - b).abs().max()) <= tol, what


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_and_every_gradient_match_the_reference(seed):
    module = _module()
    cfg = _config()
    params = _params(module, seed)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        dict(ref.param_shapes(cfg))
    rows, dense, label = _inputs(seed)

    def grads(fn):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        r = {k: v.clone().requires_grad_() for k, v in rows.items()}
        logits = fn(p, r)
        loss = ref.logloss(logits, label)
        g = torch.autograd.grad(loss, list(p.values()) + list(r.values()))
        return logits.detach(), dict(zip(list(p) + list(r), g))

    got, got_g = grads(lambda p, r: torch.func.functional_call(
        module, p, (dense, r)))
    want, want_g = grads(lambda p, r: ref.logits(p, r, dense, cfg))
    _close(got, want, "logits")
    assert set(got_g) == set(want_g)
    for k, g in want_g.items():
        assert float(g.abs().max()) > 0, k      # every leaf is reached
        _close(got_g[k], g, k)


def test_split_half_passes_the_first_half_on_and_pools_the_second():
    module = _module()
    cin = module.CIN_0
    assert cin.out_features == CIN[0] // 2 + CIN[1]
    x0 = _inputs(3)[0]["fields"]
    with torch.no_grad():
        for p in cin.parameters():
            p.normal_(0.0, 0.3)
        out = cin(x0)
        x0t = x0.transpose(1, 2)                          # [B, D, F]
        z1 = (x0t[..., :, None] * x0t[..., None, :]).reshape(B * D, -1)
        maps1 = torch.relu(z1 @ cin.conv_0.weight.T
                           + cin.conv_0.bias).reshape(B, D, CIN[0])
        passed, pooled = maps1[..., :CIN[0] // 2], maps1[..., CIN[0] // 2:]
        _close(out[:, :CIN[0] // 2], pooled.sum(dim=1), "layer 1's pool")
        z2 = (passed[..., :, None] * x0t[..., None, :]).reshape(B * D, -1)
        maps2 = torch.relu(z2 @ cin.conv_1.weight.T + cin.conv_1.bias)
        _close(out[:, CIN[0] // 2:], maps2.reshape(B, D, -1).sum(dim=1),
               "layer 2 over the passed half")
        # the pooled half reaches layer 2 through nothing
        cin.conv_1.weight.add_(1.0)
        assert torch.equal(cin(x0)[:, :CIN[0] // 2], out[:, :CIN[0] // 2])
    assert tuple(cin.conv_1.weight.shape) == (CIN[1], CIN[0] // 2 * F)
    with pytest.raises(ValueError, match="even"):
        tm.CIN(F, (7, 6))
    tm.CIN(F, (8, 7))                   # the last layer may be odd


def test_default_xdeepfm_is_the_benchmark_configuration_cin():
    with open(os.path.join(REPO, "oebench", "configs",
                           "xdeepfm_dim64.json")) as f:
        cfg = json.load(f)
    defaults = {k: v.default for k, v in
                inspect.signature(tm.XDeepFM.__init__).parameters.items()}
    assert list(defaults["cin_layer_sizes"]) == cfg["cin_layer_sizes"]
    assert defaults["cin_split_half"] is cfg["cin_split_half"]
    assert defaults["cin_bias"] is cfg["cin_bias"]
    assert list(defaults["dnn_units"]) == cfg["dnn_units"]
    assert cfg["cin_activation"] == "relu"
    # built as the benchmark builds it (oebench/program.py), the default
    # module has the configuration's parameters
    module = tm.build_model("xdeepfm", [f"C{j + 1}" for j in range(26)],
                            embedding_dim=cfg["embedding_dim"],
                            num_dense=cfg["num_dense"],
                            dnn_units=tuple(cfg["dnn_units"]))
    assert {k: tuple(v.shape) for k, v in module.named_parameters()} == \
        dict(ref.param_shapes(cfg))
    cin = dict(ref.param_shapes(cfg))
    assert cin["CIN_0.conv_0.weight"] == (128, 26 * 26)
    assert cin["CIN_0.conv_1.weight"] == (128, 64 * 26)
    assert cin["Dense_0.weight"] == (1, 192)


def test_init_params_draws_deepctr_filters_and_zero_biases():
    module = _module()
    p = tm.init_params(module, ti.prng_key(0), "cpu")
    for k in range(len(CIN)):
        w = p[f"CIN_0.conv_{k}.weight"]
        limit = float(np.sqrt(6.0 / (w.shape[0] + w.shape[1])))
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.5 * limit      # glorot, not lecun
        assert torch.equal(p[f"CIN_0.conv_{k}.bias"],
                           torch.zeros(w.shape[0]))
    assert torch.equal(p["bias"], torch.zeros(1))


def _trainer(cfg):
    specs, mapper = make_fused_specs(
        NAMES, cfg["vocab_sizes"], D, name=cfg["fused_name"],
        optimizer=dict(cfg["sparse_optimizer"]))
    dn = cfg["dense_optimizer"]
    module = _module()
    trainer = tr.Trainer(module, EmbeddingCollection(specs, device="cpu"),
                         dense_opt.adagrad(dn["learning_rate"],
                                           dn["initial_accumulator_value"],
                                           dn["eps"]))
    return trainer, mapper


def test_three_train_steps_match_the_reference():
    """Three ``Trainer.train_step`` steps over a fused array table from
    the benchmark's initial values, read as the benchmark reads them,
    against the reference's three steps: float32 sums in another order
    (the benchmark's tiny cells read up to 1.3e-5 on sound runs)."""
    cfg = _config()
    trainer, mapper = _trainer(cfg)
    mix = {"pool_batches": 4, "ids": {"dist": "zipf", "a": 1.2},
           "dense": {"dist": "log1p_poisson", "lam": 3.0},
           "positive_share": 0.25}
    pool = traffic.make_pool(mix, cfg, 2**31 + 11, "cpu")
    initial = Initial(cfg, 2**31 + 11, "cpu")
    batches = program.host_batches(pool, mapper, cfg)
    state = program.init_state(trainer, initial, batches[0])
    touched = [reference.touched_ids(cfg, pool.ids[t]) for t in range(3)]
    every = np.unique(np.concatenate([t.ravel() for t in touched]))
    losses = []
    for t in range(3):
        state, out = trainer.train_step(state, batches[t])
        losses.append(float(out["loss"]))
        if t == 0:
            first = np.unique(touched[0][touched[0] >= 0])
            grad = program.grad_readings(state, initial, first)
    change, stray = program.change_readings(state, initial,
                                            every[every >= 0])
    want = reference.run(cfg, [pool.ids[t] for t in range(3)],
                         [pool.dense[t] for t in range(3)],
                         [pool.label[t] for t in range(3)], initial, "cpu")
    gaps = check.gaps({"loss": losses, "grad": grad, "change": change,
                       "stray": stray}, want)
    assert gaps["loss_gap"] <= 1e-6, gaps
    assert gaps["grad_gap"] <= 1e-4, gaps
    assert gaps["change_gap"] <= 1e-5, gaps
    # every CIN leaf is checked: none is quiet at the configuration's scale
    median = statistics.median(want["grad"].values())
    for k, g in want["grad"].items():
        if k.startswith("CIN_0."):
            assert g >= check.QUIET_LEAF * median, k


def test_stage_marks_leave_values_and_gradients_unchanged():
    module = _module()
    params = _params(module, 5)
    rows, dense, label = _inputs(5)

    def run():
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        r = {k: v.clone().requires_grad_() for k, v in rows.items()}
        logits = torch.func.functional_call(module, p, (dense, r))
        g = torch.autograd.grad(ref.logloss(logits, label),
                                list(p.values()) + list(r.values()))
        return logits.detach(), g

    plain_logits, plain_grads = run()
    rec = obs.StageRecorder(cuda=False)
    with rec.recording():
        obs.stage("dense")
        logits, grads = run()
    assert torch.equal(logits, plain_logits)
    assert all(torch.equal(a, b) for a, b in zip(grads, plain_grads))
    # forward: the CIN, then the rest; backward: the CIN's, then the rest
    assert [n for n, _ in rec.marks] == ["dense", "dense.cin", "dense",
                                        "dense.cin_grad", "dense"]
    seconds = rec.seconds()
    assert seconds["dense.cin"] > 0 and seconds["dense.cin_grad"] > 0
    assert seconds["dense"] >= seconds["dense.cin"] \
        + seconds["dense.cin_grad"]
    # outside a recording the marks are no view and no hook
    x = torch.ones(2, requires_grad=True)
    assert obs.stage_grad(x, "dense") is x
    with rec.recording(), torch.no_grad():
        assert obs.stage_grad(x, "dense") is x


def test_gate_on_step_timings_hold_the_cin_stages():
    cfg = _config()
    trainer, mapper = _trainer(cfg)
    pool = traffic.make_pool({"pool_batches": 3, "ids": {"dist": "uniform"},
                              "dense": {"dist": "normal"},
                              "positive_share": 0.5}, cfg, 7, "cpu")
    batches = program.host_batches(pool, mapper, cfg)
    state = trainer.init(ti.prng_key(0), batches[0])
    obs.set_evaluate_performance(False)
    obs.reset_step_timings()
    try:
        obs.set_evaluate_performance(True)
        for b in batches:
            state, _ = trainer.train_step(state, b)
        device = obs.step_timings()["device"]
        text = obs.prometheus_text()
    finally:
        obs.set_evaluate_performance(False)
        obs.reset_step_timings()
    for name in ("dense.cin", "dense.cin_grad", "dense", "pull", "push"):
        assert device[name]["replays"] == len(batches) - 1, name
        assert device[name]["seconds"] > 0, name
    for name in ("dense.cin", "dense.cin_grad"):
        assert f'oe_step_device_seconds_total{{stage="{name}"}}' in text
