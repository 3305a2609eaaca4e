"""Torch port, the command-line drivers against the JAX package's examples
(``examples/criteo_deepctr.py``, ``examples/serving_cluster.py``), in
process on the CPU: JAX's ``main`` with ``jax.devices`` cut to one device
(a 1 x 1 mesh) and ``--data_parallel 1``, the port's with ``--device
cpu``, on the cases of ``tests/test_examples.py`` (fused DeepFM with
``--save``/``--load``/``--eval_steps``; LR with ``--no-fused
--sparse_as_dense --hist_len``; ``--format tfrecord``).

Both draw the same initial state from ``PRNGKey(0)`` and the same
batches, so the logged losses agree at rtol 1e-5 (float32 sums and the
dense Adam in another order), and each ``--save`` checkpoint, JAX's read
through the port's ``load_checkpoint``, agrees row for row at rtol 1e-5.
"""

import re

import numpy as np
import pytest
import torch

import jax

from examples import criteo_deepctr as jax_example
from openembedding_tpu_torch import checkpoint as tckpt
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.examples import criteo_deepctr, serving_cluster
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.models import deepctr as tm

BASE = ["--num_buckets", "2048", "--batch_size", "128", "--steps", "4",
        "--embedding_dim", "4", "--data_parallel", "1", "--log_every", "1"]
LOSS = re.compile(r"^step (\d+): loss=([0-9.]+)$", re.M)


@pytest.fixture()
def one_device(monkeypatch, devices8):
    """JAX's example on a 1 x 1 mesh."""
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices8[:1])


def _run_both(capsys, argv):
    """JAX's example and the port's driver on ``argv``; their stdouts."""
    assert jax_example.main(argv) == 0
    jout = capsys.readouterr().out
    assert criteo_deepctr.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    return jout, tout


def _losses(out):
    return [float(v) for _, v in LOSS.findall(out)]


def _assert_same_run(jout, tout, steps=4):
    jl, tl = _losses(jout), _losses(tout)
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert re.search(r"^trained \d+ steps, \d+ examples/s$", tout, re.M)


def _assert_same_tables(coll, jdir, tdir):
    jstates = tckpt.load_checkpoint(jdir, coll)
    tstates = tckpt.load_checkpoint(tdir, coll)
    for name in coll.specs:
        np.testing.assert_allclose(tstates[name].weights.numpy(),
                                   jstates[name].weights.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_fused_deepfm_save_load_eval(one_device, capsys, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_example.main(["--model", "deepfm", *BASE,
                             "--save", jdir]) == 0
    jout = capsys.readouterr().out
    assert criteo_deepctr.main(["--model", "deepfm", *BASE, "--save", tdir,
                                "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    _assert_same_run(jout, tout)
    assert f"saved checkpoint to {tdir}" in tout
    specs, _ = make_fused_specs(criteo.SPARSE_NAMES, 2048, 4)
    _assert_same_tables(EmbeddingCollection(specs, device="cpu"), jdir, tdir)
    # reload and eval: both AUCs from the reloaded tables
    evals = []
    for main, d, extra in ((jax_example.main, jdir, []),
                           (criteo_deepctr.main, tdir, ["--device", "cpu"])):
        assert main(["--model", "deepfm", *BASE, "--steps", "0", "--load", d,
                     "--eval_steps", "2", *extra]) == 0
        out = capsys.readouterr().out
        assert f"loaded checkpoint from {d}" in out
        evals.append(float(re.search(r"eval AUC over 2 batches: ([0-9.]+)",
                                     out).group(1)))
    assert evals[1] == pytest.approx(evals[0], abs=2e-4)


def test_lr_hybrid_and_history(one_device, capsys, tmp_path):
    argv = ["--model", "lr", *BASE, "--no-fused", "--sparse_as_dense",
            "2048", "--hist_len", "4"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_example.main(argv + ["--save", jdir]) == 0
    jout = capsys.readouterr().out
    assert criteo_deepctr.main(argv + ["--save", tdir, "--device",
                                       "cpu"]) == 0
    tout = capsys.readouterr().out
    _assert_same_run(jout, tout)
    kept = re.search(r"sparse_as_dense: \d+ dense-kept, \d+ sharded", tout)
    assert kept and kept.group(0) in jout
    from openembedding_tpu_torch.embedding import EmbeddingSpec
    from openembedding_tpu_torch.hybrid import split_sparse_dense
    specs, _ = split_sparse_dense(
        tm.make_feature_specs(criteo.SPARSE_NAMES, 2048, 4,
                              hash_capacity=1 << 22), 2048, batch_size=128)
    specs = tuple(specs) + (
        EmbeddingSpec(name="hist", input_dim=2048, output_dim=4,
                      pooling="mean", hash_capacity=1 << 22),
        EmbeddingSpec(name="hist:linear", input_dim=2048, output_dim=1,
                      pooling="sum", hash_capacity=1 << 22))
    _assert_same_tables(EmbeddingCollection(specs, device="cpu"), jdir, tdir)


def test_tfrecord_input(one_device, capsys, tmp_path):
    from openembedding_tpu_torch.data import tfrecord as tfr
    rng = np.random.RandomState(0)
    path = tmp_path / "tf-part.00001"
    with open(path, "wb") as f:
        for _ in range(600):
            feats = {"label": [int(rng.randint(0, 2))]}
            for j in range(1, 14):
                feats[f"I{j}"] = [float(np.float32(rng.randn()))]
            for j in range(1, 27):
                feats[f"C{j}"] = [int(rng.randint(0, 2048))]
            tfr.write_record(f, tfr.make_example(feats))
    jout, tout = _run_both(capsys, ["--model", "deepfm", *BASE, "--data",
                                    str(path), "--format", "tfrecord"])
    _assert_same_run(jout, tout)


def test_serving_cluster_one_replica(capsys):
    assert serving_cluster.main(["--replicas", "1", "--steps", "2",
                                 "--lookups", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cluster up: ['127.0.0.1:" in out
    assert re.search(r"lookup fields\[0:8\] -> shape \(8, 8\)", out)
    assert out.rstrip().endswith("done")


@pytest.mark.parametrize("argv", [
    ["--plane", "psum"], ["--cache_k", "8"], ["--data_parallel", "2"]])
def test_driver_refuses_multi_shard_options(argv, monkeypatch, devices8,
                                            capsys):
    """``--plane psum``, ``--cache_k`` and ``--data_parallel 2`` run:
    JAX's example on 4 devices and the port's driver on a mesh of 4
    positions build the same 2 x 2 mesh (``psum``: tables over the model
    axis; ``--cache_k`` off the cached plane sizes nothing, as in JAX)
    and log the same losses."""
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices8[:4])
    argv = ["--model", "deepfm", *BASE, "--data_parallel", "2", *argv]
    assert jax_example.main(argv) == 0
    jout = capsys.readouterr().out
    assert criteo_deepctr.main(argv + ["--devices", "4",
                                       "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2}" in jout
    assert "mesh: {'data': 2, 'model': 2} on cpu" in tout
    _assert_same_run(jout, tout)


@pytest.mark.parametrize("argv", [["--plane", "a2a+grouped+pipelined"],
                                  ["--plane", "a2a+int8", "--cache_k", "64"]],
                         ids=["grouped-pipelined", "int8-cache_k"])
def test_driver_later_planes_save_and_load(argv, capsys, tmp_path):
    """The port's driver on the grouped pipelined plane and the int8 wire,
    ``--data_parallel 2`` over 4 positions: it trains, saves, and a
    second run loads the checkpoint back (the tables it saved, row for
    row) and evaluates it. The grouped pipelined losses are the ``a2a``
    run's within the grouped plane's tolerance."""
    common = ["--model", "deepfm", *BASE, "--data_parallel", "2",
              "--devices", "4", "--device", "cpu"]
    d = str(tmp_path / "ck")
    assert criteo_deepctr.main(common + argv + ["--save", d]) == 0
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2} on cpu" in out
    assert f"saved checkpoint to {d}" in out
    losses = _losses(out)
    assert len(losses) == 4 and np.isfinite(losses).all()
    if argv[1] == "a2a+grouped+pipelined":
        assert criteo_deepctr.main(common + ["--plane", "a2a"]) == 0
        np.testing.assert_allclose(losses,
                                   _losses(capsys.readouterr().out),
                                   rtol=1e-5)
    assert criteo_deepctr.main(common + argv + ["--steps", "0", "--load", d,
                                                "--eval_steps", "2"]) == 0
    out = capsys.readouterr().out
    assert f"loaded checkpoint from {d}" in out
    assert re.search(r"eval AUC over 2 batches: [0-9.]+", out)
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    specs, _ = make_fused_specs(criteo.SPARSE_NAMES, 2048, 4,
                                plane=argv[1])
    coll = EmbeddingCollection(specs, create_mesh(2, 2, device="cpu"))
    again = tckpt.load_checkpoint(d, coll)
    tckpt.save_checkpoint(str(tmp_path / "again"), coll, again)
    for name, dense_rows in tckpt.export_dense(coll, again).items():
        np.testing.assert_array_equal(
            dense_rows, tckpt.export_dense(
                coll, tckpt.load_checkpoint(str(tmp_path / "again"),
                                            coll))[name])


def test_serving_cluster_refuses_shard_groups(capsys):
    """Shard groups are served since slice 15: ``--shards 2`` runs a 2 x 1
    grid behind the sharded router; shard and replica counts below one
    are refused."""
    for bad in (["--shards", "0"], ["--replicas", "0"]):
        with pytest.raises(ValueError, match="at least 1"):
            serving_cluster.main(bad + ["--device", "cpu"])
    assert serving_cluster.main(["--shards", "2", "--replicas", "1",
                                 "--steps", "2", "--lookups", "1",
                                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "shard-group cluster up: [['127.0.0.1:" in out
    assert re.search(r"lookup fields\[0:8\] -> shape \(8, 8\)", out)


def test_drivers_need_a_device_named_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        criteo_deepctr.main([*BASE, "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_cluster.main(["--steps", "1"])
