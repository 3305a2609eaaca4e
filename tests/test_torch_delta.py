"""Torch port, delta checkpoints and serving hot-swap against the JAX
package (``checkpoint_delta.py``, ``dirty.py``, the chain in
``checkpoint.py``, ``ModelRegistry.apply_delta`` and ``POST
/models/<sign>/delta``).

The first half mirrors ``tests/test_delta_checkpoint.py`` case for case
on the port (the compressed-base and peer-restore cases belong to later
slices). Its cases take the ``layout`` fixture: here one shard
(``device="cpu"``); ``tests/test_torch_delta_sharded.py`` runs the same
bodies on JAX's 2 x 4 mesh. The second half holds the port against JAX: chains written by
either package (array and wide hash variables, float32 and bfloat16)
load in the other bit for bit, with equal payload arrays, per-chunk
crc32s, dirty chunk sets, manifests and wire frames; faults injected at
the same sync points recover to the same version; the registry and the
REST route gate versions with JAX's answers. Every comparison is exact.
"""

import json
import os
import threading
import types
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jck
from openembedding_tpu import checkpoint_delta as jcd
from openembedding_tpu.analysis import chaos as jchaos
from openembedding_tpu.dirty import DirtyTracker as JaxTracker
from openembedding_tpu.parallel import hot_cache
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import checkpoint as ck
from openembedding_tpu_torch import checkpoint_delta as cd
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.analysis import chaos
from openembedding_tpu_torch.analysis.concurrency import (PointGate,
                                                          clear_schedule,
                                                          install_schedule)
from openembedding_tpu_torch.dirty import DirtyTracker
from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                EmbeddingSpec)
from openembedding_tpu_torch.parallel.mesh import create_mesh as tmesh
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.utils import observability as obs

VOCAB, DIM = 256, 4
ADAGRAD = {"category": "adagrad", "learning_rate": 0.1}


@pytest.fixture
def layout():
    """Where the collection's tables live: ``"one"``, one shard on the
    CPU; ``"a2a"`` and ``"psum"`` (``tests/test_torch_delta_sharded.py``),
    JAX's 2 x 4 mesh with the array variable on that plane and the hash
    variable on ``a2a``."""
    return "one"


def make_coll(vocab=VOCAB, chunks=32, track=True, layout="one"):
    plane = "a2a" if layout == "one" else layout
    specs = (EmbeddingSpec(name="arr", input_dim=vocab, output_dim=DIM,
                           plane=plane),
             EmbeddingSpec(name="hsh", input_dim=-1, output_dim=DIM,
                           hash_capacity=1024))
    where = {"device": "cpu"} if layout == "one" \
        else {"mesh": tmesh(2, 4, device="cpu")}
    coll = EmbeddingCollection(specs, default_optimizer=ADAGRAD, **where)
    if track:
        coll.enable_dirty_tracking(target_chunks=chunks)
    return coll


def train(coll, states, seed, *, arr_ids=None, n=16, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    if arr_ids is None:
        arr_ids = rng.randint(0, vocab, n)
    idx = {"arr": np.asarray(arr_ids, np.int32),
           "hsh": rng.randint(0, 2**20, n).astype(np.int32)}
    rows = coll.pull(states, idx, batch_sharded=False)
    coll.apply_gradients(states, idx,
                         {k: torch.ones_like(v) * 0.2 for k, v in rows.items()},
                         batch_sharded=False)
    return idx


def snapshot(states):
    """A copy of the states (the port's pushes update in place): every
    tensor field cloned, one shard's or a sharded state's."""
    import dataclasses

    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        return v
    return {n: dataclasses.replace(s, **{
        f.name: copy(getattr(s, f.name)) for f in dataclasses.fields(s)})
        for n, s in states.items()}


def assert_states_equal(coll, a, b, vocab=VOCAB, probe_keys=None):
    allv = np.arange(vocab, dtype=np.int32)
    assert torch.equal(
        coll.pull(a, {"arr": allv}, batch_sharded=False)["arr"],
        coll.pull(b, {"arr": allv}, batch_sharded=False)["arr"])
    for s in a["arr"].slots:
        assert torch.equal(a["arr"].slots[s], b["arr"].slots[s])
    if probe_keys is not None:
        pk = {"hsh": np.asarray(probe_keys, np.int32)}
        assert torch.equal(
            coll.pull(a, pk, read_only=True, batch_sharded=False)["hsh"],
            coll.pull(b, pk, read_only=True, batch_sharded=False)["hsh"])


# --- the port, case for case -------------------------------------------------

def _tracker_run(cls):
    t = cls(16, rows_per_chunk=8, name="u")
    out = [t.dirty_count]
    t.mark_rows([0, 7, 8, 127])
    out += [t.dirty_count, list(t.dirty_chunks()), bool(t[3]), bool(t[8]),
            bool(t[16]), list(t.mask_rows([0, 8, 64]))]
    snap = t.snapshot_clear()
    out += [t.dirty_count, list(snap)]
    t.mark_rows([64])
    t.restore(snap)
    out.append(t.dirty_count)
    t.clear_chunks([0, 1, 8, 15])
    out.append(list(t.dirty_chunks()))
    t.mark_chunks([-1, 99])
    out.append(t.dirty_count)
    kt = cls(16, name="k")
    kt.mark_keys(np.asarray([-5, 5, 21], np.int64))
    out += [kt.dirty_count, sorted(kt.dirty_chunks())]
    return out


def test_dirty_tracker_unit():
    got = _tracker_run(DirtyTracker)
    assert got == _tracker_run(JaxTracker)
    assert got[1:3] == [3, [0, 1, 15]] and got[-2:] == [2, [5, 11]]


def test_dirty_tracking_names_subset_rejects_unknown():
    coll = make_coll(track=False)
    with pytest.raises(ValueError, match="unknown variable.*'hshh'"):
        coll.enable_dirty_tracking(names={"arr", "hshh"})
    coll.enable_dirty_tracking(names={"arr"})
    assert set(coll.dirty_trackers) == {"arr"}


def test_delta_requires_tracking_and_matching_optimizer(tmp_path):
    coll = make_coll(track=False)
    states = coll.init()
    with pytest.raises(ValueError, match="dirty tracking"):
        ck.save_checkpoint(str(tmp_path / "m"), coll, states, mode="delta")
    coll.enable_dirty_tracking()
    info = ck.save_checkpoint(str(tmp_path / "m"), coll, states,
                              mode="delta", step=1)
    assert info["mode"] == "full" and info["forced_full"]
    with pytest.raises(ValueError, match="include_optimizer"):
        ck.save_checkpoint(str(tmp_path / "m"), coll, states, mode="delta",
                           include_optimizer=False)
    info = ck.save_checkpoint(str(tmp_path / "m"), coll, states,
                              mode="delta", step=2)
    assert info["skipped"] and info["seq"] == 0
    # a compressed base writes the part layout and arms no chain: a
    # delta save into it stays a forced full save, as in JAX
    info = ck.save_checkpoint(str(tmp_path / "z"), coll, states,
                              compress="zlib")
    assert info["mode"] == "full" and info["bytes"] > 0
    assert not (tmp_path / "z" / "delta_manifest").exists()
    assert any(f.startswith("part0_") and f.endswith(".npyz")
               for _root, _dirs, files in os.walk(tmp_path / "z")
               for f in files)
    info = ck.save_checkpoint(str(tmp_path / "z"), coll, states,
                              mode="delta", step=3)
    assert info["forced_full"]


def test_delta_bytes_ratio_10x(tmp_path, layout):
    vocab = 8192
    coll = make_coll(vocab=vocab, chunks=256, layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    c0 = obs.ckpt_stats()
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    c1 = obs.ckpt_stats()
    full_bytes = c1["ckpt_full_bytes"] - c0["ckpt_full_bytes"]
    assert full_bytes > 0
    train(coll, states, 1, arr_ids=np.arange(64), n=8, vocab=vocab)
    info = ck.save_checkpoint(path, coll, states, mode="delta", step=1)
    c2 = obs.ckpt_stats()
    delta_bytes = c2["ckpt_delta_bytes"] - c1["ckpt_delta_bytes"]
    assert info["mode"] == "delta" and delta_bytes == info["bytes"]
    assert full_bytes >= 10 * delta_bytes, (full_bytes, delta_bytes)
    assert c2["ckpt_chain_len"] >= 1 and c2["ckpt_write_gbps"] > 0


def test_delta_roundtrip_bit_identical(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    train(coll, states, 0)
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    keys = []
    for seed in (1, 2, 3):
        keys.append(train(coll, states, seed)["hsh"])
        info = ck.save_checkpoint(path, coll, states, mode="delta",
                                  step=seed)
        assert info["mode"] == "delta"
    cd.join_compactor(path)
    loaded = ck.load_checkpoint(path, coll)
    probe = np.concatenate(keys)
    assert_states_equal(coll, states, loaded, probe_keys=probe)
    full_path = str(tmp_path / "full")
    coll2 = make_coll(track=False, layout=layout)
    ck.save_checkpoint(full_path, coll2, states)
    assert_states_equal(coll, ck.load_checkpoint(full_path, coll2), loaded,
                        probe_keys=probe)


def test_torn_final_delta_discarded(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    train(coll, states, 1, arr_ids=np.arange(16))
    cd.save_delta(path, coll, states, step=1, compact_bytes_ratio=1e9,
                  background_compact=False)
    after_1 = snapshot(states)
    train(coll, states, 2, arr_ids=np.arange(16, 48))
    cd.save_delta(path, coll, states, step=2, compact_bytes_ratio=1e9,
                  background_compact=False)
    manifest = cd.read_manifest(path)
    assert [e["seq"] for e in manifest["chain"]] == [1, 2]
    fp = os.path.join(path, manifest["chain"][-1]["vars"]["arr"]["file"])
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.warns(RuntimeWarning, match="torn"):
        loaded = ck.load_checkpoint(path, coll)
    assert_states_equal(coll, after_1, loaded)
    assert cd.applied_seq(path) == 1
    os.remove(os.path.join(path,
                           manifest["chain"][0]["vars"]["arr"]["file"]))
    with pytest.raises(RuntimeError, match="mid-chain"):
        ck.load_checkpoint(path, coll)


def test_writer_killed_mid_delta_recovers(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    before = snapshot(states)
    idx = train(coll, states, 1, arr_ids=np.arange(24))
    gate = PointGate(["ckpt.writer.run"], timeout=0.4)
    install_schedule(gate)
    try:
        with pytest.raises(TimeoutError):
            ck.save_checkpoint(path, coll, states, mode="delta", step=1)
    finally:
        clear_schedule()
    manifest = cd.read_manifest(path)
    assert manifest["chain"] == [] and manifest["last_seq"] == 0
    assert_states_equal(coll, before, ck.load_checkpoint(path, coll))
    assert coll.dirty_trackers["arr"].dirty_count > 0
    info = ck.save_checkpoint(path, coll, states, mode="delta", step=1)
    assert info["mode"] == "delta" and info["seq"] == 1
    cd.join_compactor(path)
    assert_states_equal(coll, states, ck.load_checkpoint(path, coll),
                        probe_keys=idx["hsh"])
    manifest = cd.read_manifest(path)
    live = {i["file"] for e in manifest["chain"]
            for i in e["vars"].values()}
    on_disk = {f for f in os.listdir(path)
               if f.startswith("delta_") and f.endswith(".npz")}
    assert on_disk == live


def test_compaction_folds_chain(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    keys = []
    for seed in (1, 2):
        keys.append(train(coll, states, seed)["hsh"])
        cd.save_delta(path, coll, states, step=seed, compact_chain_len=2,
                      compact_bytes_ratio=1e9, background_compact=False)
    manifest = cd.read_manifest(path)
    assert manifest["chain"] == [] and manifest["last_seq"] == 2
    assert not [f for f in os.listdir(path)
                if f.startswith("delta_") and f.endswith(".npz")]
    loaded = ck.load_checkpoint(path, coll)
    assert_states_equal(coll, states, loaded,
                        probe_keys=np.concatenate(keys))
    # the folded base places every key where the trained table holds it
    assert torch.equal(loaded["hsh"].keys, states["hsh"].keys)
    idx = train(coll, states, 3)
    info = cd.save_delta(path, coll, states, step=3,
                         background_compact=False)
    assert info["seq"] == 3
    assert_states_equal(coll, states, ck.load_checkpoint(path, coll),
                        probe_keys=idx["hsh"])


def test_full_save_resets_stale_chain(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    train(coll, states, 1)
    ck.save_checkpoint(path, coll, states, mode="delta", step=1)
    cd.join_compactor(path)
    idx = train(coll, states, 2)
    ck.save_checkpoint(path, coll, states, mode="full", step=2)
    manifest = cd.read_manifest(path)
    assert manifest is not None and manifest["chain"] == []
    assert_states_equal(coll, states, ck.load_checkpoint(path, coll),
                        probe_keys=idx["hsh"])


def test_dense_state_persists_through_skipped_delta(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    v1 = ({"w": torch.ones(3)}, {"w": torch.full((3,), 0.1)})
    ck.save_checkpoint(path, coll, states, mode="delta", step=0,
                       dense_state=v1)
    v2 = ({"w": torch.full((3,), 7.0)}, {"w": torch.full((3,), 0.5)})
    info = ck.save_checkpoint(path, coll, states, mode="delta", step=1,
                              dense_state=v2)
    assert info["skipped"]
    _, (params, opt) = ck.load_checkpoint(path, coll,
                                          dense_state_template=v1)
    assert torch.equal(params["w"], v2[0]["w"])
    assert torch.equal(opt["w"], v2[1]["w"])


def test_parallel_full_save_matches_serial(tmp_path, monkeypatch):
    coll = make_coll(track=False)
    states = coll.init()
    train(coll, states, 0)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    monkeypatch.setenv("OE_CKPT_WRITERS", "1")
    ck.save_checkpoint(a, coll, states)
    monkeypatch.setenv("OE_CKPT_WRITERS", "6")
    ck.save_checkpoint(b, coll, states)
    for name in ("arr", "hsh"):
        vdir = ck._var_dir(coll.variable_id(name), name)
        files = sorted(os.listdir(os.path.join(a, vdir)))
        assert files == sorted(os.listdir(os.path.join(b, vdir)))
        for f in files:
            assert open(os.path.join(a, vdir, f), "rb").read() == \
                open(os.path.join(b, vdir, f), "rb").read()


def _wire_payload():
    import ml_dtypes
    w16 = np.random.RandomState(1).randn(2, 4).astype(ml_dtypes.bfloat16)
    jax_side = {
        "arr": {"chunks": np.asarray([1, 3], np.int64),
                "rows_per_chunk": np.int64(8), "vocab": np.int64(64),
                "weights": np.random.RandomState(0)
                .randn(16, 4).astype(np.float32)},
        "hsh": {"keys": np.asarray([[1, 0], [2, 0]], np.int32),
                "chunks": np.asarray([0], np.int64),
                "num_chunks": np.int64(16),
                "weights": w16}}
    port_side = {n: dict(p) for n, p in jax_side.items()}
    port_side["hsh"]["weights"] = w16.view(np.uint16).view("V2")
    return jax_side, port_side


def test_delta_wire_roundtrip_and_bytes_equal_jax():
    jvars, tvars = _wire_payload()
    delta = cd.Delta(seq=5, step=17, vars=tvars)
    for codec in ("", "zlib"):
        wire = cd.encode_delta(delta, compress=codec)
        assert wire == jcd.encode_delta(jcd.Delta(5, 17, jvars), codec)
        out = cd.decode_delta(wire)
        assert out.seq == 5 and out.step == 17 and set(out.vars) == {
            "arr", "hsh"}
        for name in tvars:
            for f, arr in tvars[name].items():
                assert np.asarray(out.vars[name][f]).tobytes() == \
                    np.asarray(arr).tobytes()
        assert out.rows == delta.rows == 18
        # JAX decodes the port's frame too
        assert jcd.decode_delta(wire).rows == 18
    for bad in (b"", b"{\n", b"[1]\nxx", b'{"seq": 1}\n',
                b'{"seq": 1, "step": 1, "vars": {"a": [["w", "<f4", [9]]]}}'
                b'\n\x00'):
        with pytest.raises(cd.DeltaDecodeError) as got:
            cd.decode_delta(bad)
        with pytest.raises(jcd.DeltaDecodeError) as want:
            jcd.decode_delta(bad)
        assert str(got.value) == str(want.value)


def test_apply_delta_hot_swap_e2e(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    train(coll, states, 0)
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=1)
    reg = ModelRegistry(device="cpu")
    sign = reg.create_model(path, model_sign="m-1")
    assert reg.find_model(sign).version == 0
    idx = train(coll, states, 7)
    info = cd.save_delta(path, coll, states, step=2,
                         compact_bytes_ratio=1e9, background_compact=False,
                         return_payload=True)
    assert info["seq"] == 1
    delta = cd.read_delta(path)
    assert delta.seq == info["delta"].seq
    for name in delta.vars:
        for f, arr in delta.vars[name].items():
            assert np.asarray(arr).tobytes() == \
                np.asarray(info["delta"].vars[name][f]).tobytes()
    old = reg.find_model(sign).states
    res = reg.apply_delta(sign, delta)
    assert res == {"applied": True, "version": 1, "rows": delta.rows}
    model = reg.find_model(sign)
    assert model.version == 1 and model.states is not old
    for name in ("arr", "hsh"):
        want = coll.pull(states, {name: idx[name]}, read_only=True)[name]
        assert torch.equal(model.lookup(name, idx[name]), want)
    res = reg.apply_delta(sign, cd.encode_delta(delta, compress="zlib"))
    assert res["applied"] is False and res["version"] == 1
    with pytest.raises(RuntimeError, match="gap"):
        reg.apply_delta(sign, cd.Delta(seq=3, step=9, vars={}))


def test_returned_payload_owns_its_rows(tmp_path, layout):
    """A published delta keeps the rows it was saved with: a push made
    after the save, in place on the same contiguous chunks, changes
    neither its bytes nor its per-chunk crcs."""
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    run = np.arange(24)            # chunks 0, 1 and 2: one run of rows
    train(coll, states, 1, arr_ids=run)
    info = cd.save_delta(path, coll, states, step=1,
                         background_compact=False, return_payload=True)
    arr = info["delta"].vars["arr"]
    assert list(arr["chunks"]) == [0, 1, 2]
    before = {f: np.asarray(v).tobytes() for f, v in arr.items()}
    crcs = cd.read_manifest(path)["chain"][-1]["vars"]["arr"]["chunk_crc"]
    train(coll, states, 2, arr_ids=run)
    assert {f: np.asarray(v).tobytes() for f, v in arr.items()} == before
    assert cd._verify_array_chunks(arr, crcs)


def test_hash_delta_apply_draws_no_init_rows(tmp_path, monkeypatch):
    coll = make_coll()
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    train(coll, states, 3)
    info = cd.save_delta(path, coll, states, step=1,
                         background_compact=False, return_payload=True)
    calls = []
    real = th._init_rows_kernel
    monkeypatch.setattr(th, "_init_rows_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fresh = coll.init(only=["hsh"])
    out = cd.apply_delta_to_states(coll, fresh, {"hsh": info["delta"].vars[
        "hsh"]}, donate=False)
    assert calls == [] and int(out["hsh"].insert_failures) == 0
    assert out["hsh"].num_used() == states["hsh"].num_used()
    assert fresh["hsh"].num_used() == 0     # copy-on-write


def test_swap_during_lookup_schedule(tmp_path):
    coll = make_coll()
    states = coll.init()
    train(coll, states, 0)
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=1)
    reg = ModelRegistry(device="cpu")
    sign = reg.create_model(path, model_sign="m-1")
    model = reg.find_model(sign)
    allv = np.arange(VOCAB, dtype=np.int32)
    old = model.lookup("arr", allv).clone()
    train(coll, states, 1, arr_ids=np.arange(VOCAB))
    info = cd.save_delta(path, coll, states, step=2,
                         compact_bytes_ratio=1e9, background_compact=False,
                         return_payload=True)
    new = coll.pull(states, {"arr": allv})["arr"]
    assert not torch.equal(new, old)
    gate = PointGate(["reader/serving.lookup.snapshot"])
    install_schedule(gate)
    got = []
    try:
        t = threading.Thread(target=lambda: got.append(
            model.lookup("arr", allv)), name="reader")
        t.start()
        assert gate.wait_arrival("reader/serving.lookup.snapshot")
        res = reg.apply_delta(sign, info["delta"])
        assert res["applied"] and model.version == 1
        gate.open("reader/serving.lookup.snapshot")
        t.join(20)
        assert not t.is_alive()
    finally:
        clear_schedule()
    assert torch.equal(got[0], old)
    assert torch.equal(model.lookup("arr", allv), new)


def test_full_save_carries_burned_seqs(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    for seed in (1, 2):
        train(coll, states, seed)
        cd.save_delta(path, coll, states, step=seed,
                      compact_bytes_ratio=1e9, background_compact=False)
    train(coll, states, 3)
    ck.save_checkpoint(path, coll, states, mode="full", step=3)
    st = cd.chain_state(path)
    assert st["last_seq"] == 2 and st["content_seq"] == 2
    assert cd.applied_seq(path) == 2
    train(coll, states, 4)
    info = cd.save_delta(path, coll, states, step=4,
                         background_compact=False, return_payload=True)
    assert info["seq"] == 3
    reg = ModelRegistry(device="cpu", default_hash_capacity=2048)
    sign = reg.create_model(path, model_sign="m")
    assert reg.find_model(sign).version == 3


def test_applied_seq_survives_compaction(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    for seed in (1, 2):
        train(coll, states, seed)
        cd.save_delta(path, coll, states, step=seed, compact_chain_len=2,
                      compact_bytes_ratio=1e9, background_compact=False)
    manifest = cd.read_manifest(path)
    assert manifest["chain"] == [] and manifest["content_seq"] == 2
    assert cd.applied_seq(path) == 2
    reg = ModelRegistry(device="cpu", default_hash_capacity=2048)
    sign = reg.create_model(path, model_sign="m")
    model = reg.find_model(sign)
    assert model.version == 2
    idx = train(coll, states, 3)
    info = cd.save_delta(path, coll, states, step=3,
                         background_compact=False, return_payload=True)
    out = reg.apply_delta(sign, info["delta"])
    assert out["applied"] and model.version == 3
    assert torch.equal(coll.pull(states, {"arr": idx["arr"]})["arr"],
                       model.lookup("arr", idx["arr"]))


def test_compactor_refuses_torn_entry(tmp_path, layout):
    coll = make_coll(layout=layout)
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0)
    after = {}
    for seed in (1, 2):
        train(coll, states, seed, arr_ids=np.arange(seed * 16,
                                                    seed * 16 + 8))
        cd.save_delta(path, coll, states, step=seed,
                      compact_bytes_ratio=1e9, background_compact=False)
        after[seed] = snapshot(states)
    manifest = cd.read_manifest(path)
    fp = os.path.join(path, manifest["chain"][-1]["vars"]["arr"]["file"])
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.warns(RuntimeWarning, match="refusing to compact"):
        out = cd.compact(path)
    assert out == {"compacted": False, "torn_seq": 2}
    assert [e["seq"] for e in cd.read_manifest(path)["chain"]] == [1, 2]
    with pytest.warns(RuntimeWarning, match="torn"):
        loaded = ck.load_checkpoint(path, coll)
    assert_states_equal(coll, after[1], loaded)
    train(coll, states, 3, arr_ids=np.arange(96, 104))
    cd.save_delta(path, coll, states, step=3, background_compact=False)
    with pytest.raises(RuntimeError, match="mid-chain"):
        ck.load_checkpoint(path, coll)
    ck.save_checkpoint(path, coll, states, mode="full", step=4)
    assert_states_equal(coll, states, ck.load_checkpoint(path, coll))


# --- against the JAX package --------------------------------------------------

XVARS = [("arr", 96, 4, "float32", False), ("arr16", 64, 3, "bfloat16",
                                              False),
         ("hsh", -1, 4, "float32", True), ("hsh16", -1, 3, "bfloat16", True)]


def _xcolls(devices8, chunks=16):
    mesh = create_mesh(1, 1, devices8[:1])
    jcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t,
                          hash_capacity=512) for n, v, d, t, _ in XVARS],
        mesh, default_optimizer=ADAGRAD)
    tcoll = EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t,
                       hash_capacity=512) for n, v, d, t, _ in XVARS],
        device="cpu", default_optimizer=ADAGRAD)
    jcoll.enable_dirty_tracking(target_chunks=chunks)
    tcoll.enable_dirty_tracking(target_chunks=chunks)
    return jcoll, tcoll


def _port_of(jcoll, jstates):
    """The port's copy of one-device JAX states (array rows in logical
    order, hash tables slot for slot)."""
    out = {}
    for name, vocab, _, _, hashed in XVARS:
        st = hot_cache.unwrap(jstates[name])
        if hashed:
            out[name] = interop.hash_state_from_numpy(
                np.asarray(st.keys), np.asarray(st.weights),
                {k: np.asarray(v) for k, v in st.slots.items()}, "cpu",
                init_rng=np.asarray(st.init_rng),
                insert_failures=int(st.insert_failures))
        else:
            perm = jck._logical_perm(jcoll.sharding_spec(name))[:vocab]
            out[name] = interop.table_state_from_numpy(
                np.asarray(st.weights)[perm],
                {k: np.asarray(v)[perm] for k, v in st.slots.items()},
                "cpu")
    return out


def _xtrain(jcoll, jstates, tcoll, seed):
    """One JAX push on every variable; the port's trackers marked with the
    same ids. Returns the new JAX states."""
    rng = np.random.RandomState(seed)
    idx = {}
    for name, vocab, _, _, hashed in XVARS:
        hi = 2**20 if hashed else vocab
        idx[name] = rng.randint(0, hi, 12).astype(np.int32)
    jidx = {k: jnp.asarray(v) for k, v in idx.items()}
    rows = jcoll.pull(jstates, jidx, batch_sharded=False)
    jstates = jcoll.apply_gradients(
        jstates, jidx, {k: jnp.ones_like(v) * 0.25 for k, v in rows.items()},
        batch_sharded=False)
    tcoll.mark_dirty(idx)
    return jstates


def _npz(path, fname):
    with np.load(os.path.join(path, fname)) as data:
        return [(k, str(data[k].dtype), data[k].shape,
                 np.asarray(data[k]).tobytes()) for k in data.files]


def _fixed_zip_time(monkeypatch):
    """Pin the zip members' timestamps, so two packages' npz files of the
    same arrays are byte-identical."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=lambda t=None: (2026, 1, 2, 3, 4, 5,
                                                       0, 0, 0)))


def _strip(manifest):
    m = dict(manifest)
    m.pop("base_id")
    return m


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_read_chains(devices8, tmp_path, monkeypatch, writer):
    """Base and 3 deltas of array and wide hash variables, f32 and bf16,
    written by both packages from the same states: equal dirty chunk
    sets, byte-identical delta files (payload arrays, per-chunk crcs),
    equal manifests but for the base uuid; ``writer``'s chain loads bit
    for bit in the other package."""
    _fixed_zip_time(monkeypatch)
    jcoll, tcoll = _xcolls(devices8)
    jstates = jcoll.init(jax.random.PRNGKey(0))
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jpath, jcoll, jstates, mode="delta", step=0)
    ck.save_checkpoint(tpath, tcoll, _port_of(jcoll, jstates),
                       mode="delta", step=0)
    for seq in (1, 2, 3):
        jstates = _xtrain(jcoll, jstates, tcoll, seq)
        for name in jcoll.dirty_trackers:
            assert list(jcoll.dirty_trackers[name].dirty_chunks()) == \
                list(tcoll.dirty_trackers[name].dirty_chunks()), name
        jcd.save_delta(jpath, jcoll, jstates, step=seq,
                       compact_bytes_ratio=1e18, background_compact=False)
        cd.save_delta(tpath, tcoll, _port_of(jcoll, jstates), step=seq,
                      compact_bytes_ratio=1e18, background_compact=False)
    jm, tm_ = jcd.read_manifest(jpath), cd.read_manifest(tpath)
    assert _strip(jm) == _strip(tm_)
    for entry in tm_["chain"]:
        for name, info in entry["vars"].items():
            assert _npz(jpath, info["file"]) == _npz(tpath, info["file"])
            if info["kind"] == "array":
                assert info["chunk_crc"]
    assert json.load(open(os.path.join(jpath, "model_meta")))["variables"] \
        == json.load(open(os.path.join(tpath, "model_meta")))["variables"]
    want = _port_of(jcoll, jstates)
    if writer == "jax":
        info = {}
        got = ck.load_checkpoint(jpath, tcoll, info=info)
        assert info["applied_seq"] == 3
    else:
        got = _port_of(jcoll, jck.load_checkpoint(tpath, jcoll))
    for name, *_ in XVARS:
        a, b = got[name], want[name]
        assert torch.equal(a.weights.view(torch.int16)
                           if a.weights.dtype == torch.bfloat16
                           else a.weights,
                           b.weights.view(torch.int16)
                           if b.weights.dtype == torch.bfloat16
                           else b.weights), name
        for s in a.slots:
            assert torch.equal(a.slots[s], b.slots[s]), (name, s)
        if hasattr(a, "keys"):
            assert torch.equal(a.keys, b.keys), name


@pytest.mark.parametrize("point", ["ckpt.delta.write", "ckpt.delta.commit",
                                   "ckpt.compact.commit"])
def test_chaos_kill_recovers_like_jax(devices8, tmp_path, point):
    """A ChaosKill at ``point`` during the second delta (and its fold)
    leaves a directory that loads to the same version in both packages,
    and a retried save continues the seq line alike."""
    jcoll, tcoll = _xcolls(devices8)
    jstates = jcoll.init(jax.random.PRNGKey(0))
    out = {}
    for pkg, coll, ckm, cdm, chm in (("jax", jcoll, jck, jcd, jchaos),
                                     ("port", tcoll, ck, cd, chaos)):
        path = str(tmp_path / pkg)
        js = jstates
        states = (lambda s: s) if pkg == "jax" else \
            (lambda s: _port_of(jcoll, s))
        ckm.save_checkpoint(path, coll, states(js), mode="delta", step=0)
        versions = []
        for seq in (1, 2):
            js = _xtrain(jcoll, js, tcoll, seq)
            plan = chm.FaultPlan([chm.FaultSpec(point=point,
                                                action="kill_thread")])
            kwargs = {"compact_chain_len": 2, "compact_bytes_ratio": 1e18,
                      "background_compact": False, "max_workers": 1}
            if seq == 2:
                with chm.active_plan(plan):
                    try:
                        cdm.save_delta(path, coll, states(js), step=seq,
                                       **kwargs)
                    except chm.ChaosKill:
                        pass
            else:
                cdm.save_delta(path, coll, states(js), step=seq, **kwargs)
            versions.append(cdm.applied_seq(path))
        info = {}
        ckm.load_checkpoint(path, coll, info=info)
        versions.append(info["applied_seq"])
        versions.append(cdm.chain_state(path)["last_seq"])
        out[pkg] = versions
    assert out["jax"] == out["port"]


def test_registry_and_rest_match_jax(devices8, tmp_path):
    """The same chain served by both packages: ``apply_delta`` answers and
    the REST delta route's status codes and bodies agree (next seq 200
    applied, re-sent 200 stale, gap 409, garbage 400, unknown model
    400)."""
    import http.client
    from openembedding_tpu.serving.registry import ModelRegistry as JaxReg
    from openembedding_tpu.serving.rest import ControllerServer as JaxServer
    from openembedding_tpu_torch.serving.rest import ControllerServer
    jcoll, tcoll = _xcolls(devices8)
    jstates = jcoll.init(jax.random.PRNGKey(0))
    path = str(tmp_path / "chain")
    jck.save_checkpoint(path, jcoll, jstates, mode="delta", step=0)
    deltas = []
    for seq in (1, 2):
        jstates = _xtrain(jcoll, jstates, tcoll, seq)
        deltas.append(jcd.save_delta(
            path, jcoll, jstates, step=seq, compact_bytes_ratio=1e18,
            background_compact=False, return_payload=True)["delta"])
    wires = [jcd.encode_delta(d) for d in deltas]
    gap = jcd.encode_delta(jcd.Delta(seq=5, step=0, vars={}))
    answers = {}
    for pkg, server in (
            ("jax", JaxServer(JaxReg(create_mesh(1, 1, devices8[:1])),
                              port=0)),
            ("port", ControllerServer(port=0, device="cpu"))):
        server.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            seen = []
            for method, route, body in (
                    ("POST", "/models", json.dumps(
                        {"model_uri": path, "model_sign": "m",
                         "block": True}).encode()),
                    ("POST", "/models/m/delta", wires[0]),
                    ("POST", "/models/m/delta", wires[0]),
                    ("POST", "/models/m/delta", gap),
                    ("POST", "/models/m/delta", b"garbage"),
                    ("POST", "/models/nope/delta", wires[1]),
                    ("POST", "/models/m/delta", wires[1])):
                conn.request(method, route, body)
                resp = conn.getresponse()
                raw = json.loads(resp.read() or b"null")
                if resp.status != 200:
                    raw = sorted(raw)      # error texts differ in detail
                seen.append((resp.status, raw))
            conn.close()
            answers[pkg] = seen
            rows = server.registry.lookup("m", "arr", np.arange(96))
            answers[pkg + "_rows"] = np.asarray(rows)
        finally:
            server.stop()
    assert answers["jax"] == answers["port"]
    assert [s for s, _ in answers["port"]] == [201, 200, 200, 409, 400, 400,
                                               200]
    np.testing.assert_array_equal(answers["jax_rows"], answers["port_rows"])
