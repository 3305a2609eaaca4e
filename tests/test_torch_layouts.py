"""Torch port, checkpoint layouts against the JAX package: compressed part
files (``.npyz``), fsspec URIs (``memory://``), the legacy single-file
``var_*.npz``, dumps of several parts, hash<->array conversion on load,
the serving registry over each, and the native reader.

Each layout is cross-read both ways: JAX saves and the port loads, the
port saves and JAX loads, with every table equal (array variables in
logical row order, hash variables key by key, bfloat16 by its bits).
Compressed files are byte-identical to JAX's where both sides hold the
same one-device state (the same zlib in one process).
"""

import hashlib
import json
import os
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu import hash_table as jh
from openembedding_tpu.parallel import hot_cache
from openembedding_tpu.parallel import sharded_hash as jsh
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.utils import fs as jfs
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import checkpoint_delta as tcd
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.utils import compress as tcompress
from openembedding_tpu_torch.utils import fs as tfs

ADAGRAD = {"category": "adagrad", "learning_rate": 0.05}
VARS = [("fields", 37, 9, "float32"), ("fields:linear", 37, 1, "float32"),
        ("emb_bf16", 21, 8, "bfloat16")]
HVARS = [("fields", 9, "float32"), ("fields:linear", 1, "float32"),
         ("emb_bf16", 8, "bfloat16")]
HCAP = 512


def _mem(tag):
    return f"memory://oe-layouts-{uuid.uuid4().hex[:8]}/{tag}"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


# --- array variables ------------------------------------------------------------

def _jax_coll(mesh):
    return oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t)
         for n, v, d, t in VARS], mesh, default_optimizer=ADAGRAD)


def _port_coll():
    return EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t)
         for n, v, d, t in VARS], device="cpu", default_optimizer=ADAGRAD)


def _port_states(seed=0):
    coll = _port_coll()
    states = coll.init()
    g = torch.Generator().manual_seed(seed)
    for st in states.values():
        st.weights.copy_(torch.randn(st.weights.shape, generator=g))
        st.slots["accum"].uniform_(0.0, 3.0, generator=g)
    return coll, states


def _jax_array(coll, states, name, vocab):
    state = hot_cache.unwrap(states[name])
    perm = jax_ckpt._logical_perm(coll.sharding_spec(name))[:vocab]
    return (_bits(np.asarray(state.weights)[perm]),
            np.asarray(state.slots["accum"])[perm])


def _port_array(states, name):
    w, slots = interop.table_state_to_numpy(states[name])
    return _bits(w), slots["accum"]


def _same_arrays(jcoll, jstates, tstates):
    for name, vocab, _, _ in VARS:
        jw, ja = _jax_array(jcoll, jstates, name, vocab)
        tw, ta = _port_array(tstates, name)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(ta, ja)


def _files(path):
    out = {}
    for root, _dirs, names in os.walk(path):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, path)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


@pytest.mark.parametrize("where", ["zlib", "memory"])
def test_array_part_layouts_cross_read(devices8, tmp_path, where):
    """The port's compressed (or memory://) save loads in JAX on the 2x4
    mesh, and JAX's (its part files framed per shard) loads in the port:
    equal tables both ways."""
    coll, states = _port_states()
    kw = {"compress": "zlib"} if where == "zlib" else {}
    ppath = str(tmp_path / "p") if where == "zlib" else _mem("p")
    info = tck.save_checkpoint(ppath, coll, states, **kw)
    assert info["bytes"] == sum(v * (d * (2 if t == "bfloat16" else 4) + d * 4)
                                for _, v, d, t in VARS)
    mesh = create_mesh(2, 4, devices8)
    jcoll = _jax_coll(mesh)
    jstates = jax_ckpt.load_checkpoint(ppath, jcoll)
    _same_arrays(jcoll, jstates, states)
    jpath = str(tmp_path / "j") if where == "zlib" else _mem("j")
    jax_ckpt.save_checkpoint(jpath, jcoll, jstates, **kw)
    back = tck.load_checkpoint(jpath, _port_coll())
    _same_arrays(jcoll, jstates, back)
    sfx = ".npyz" if where == "zlib" else ".npy"
    vdir = tfs.join(ppath, tck._var_dir(0, "fields"))
    assert sorted(tfs.listdir(vdir)) == sorted(
        f"part0_{f}{sfx}" for f in ("ids", "weights", "slot_accum"))


def test_array_npyz_byte_identical_to_jax(devices8, tmp_path):
    """The same one-device state saved compressed by both packages:
    every file byte-identical, frames included."""
    coll, states = _port_states(3)
    tck.save_checkpoint(str(tmp_path / "local"), coll, states)
    jcoll = _jax_coll(create_mesh(1, 1, devices8[:1]))
    jstates = jax_ckpt.load_checkpoint(str(tmp_path / "local"), jcoll)
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), jcoll, jstates,
                             compress="zlib", model_sign="z")
    tck.save_checkpoint(str(tmp_path / "t"), coll, states, compress="zlib",
                        model_sign="z")
    jf, tf = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    tf.pop("model_meta")
    jf.pop("model_meta")
    assert tf == jf and len(tf) == 9


def test_large_array_frames_byte_identical(devices8, tmp_path, monkeypatch):
    """Several frames a file (blocks of 256 bytes: 7 rows of dim 9, 64
    of dim 1): the port frames its rows where JAX does."""
    monkeypatch.setattr(tck, "_PART_BLOCK_BYTES", 256)
    monkeypatch.setattr(jax_ckpt, "_BLOCK_BYTES", 256)
    coll, states = _port_states(5)
    tck.save_checkpoint(str(tmp_path / "local"), coll, states)
    jcoll = _jax_coll(create_mesh(1, 1, devices8[:1]))
    jstates = jax_ckpt.load_checkpoint(str(tmp_path / "local"), jcoll)
    for name in ("j", "t"):
        (tmp_path / name).mkdir()
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), jcoll, jstates,
                             compress="zlib")
    tck.save_checkpoint(str(tmp_path / "t"), coll, states, compress="zlib")
    jf, tf = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    jf.pop("model_meta")
    tf.pop("model_meta")
    assert tf == jf
    frames = 0
    with open(tmp_path / "t" / tck._var_dir(0, "fields")
              / "part0_weights.npyz", "rb") as f:
        tfs.read_npyz_header(f)
        while True:
            head = f.read(16)
            if not head:
                break
            f.seek(int.from_bytes(head[:8], "little"), 1)
            frames += 1
    assert frames == 6          # 37 rows in frames of 7
    back = tck.load_checkpoint(str(tmp_path / "t"), _port_coll())
    _same_arrays(jcoll, jstates, back)


@pytest.mark.parametrize("blocks", [[5], list(range(1, 12)), [40, 0, 3]])
def test_npyz_container_matches_jax(tmp_path, blocks):
    """The port's pooled ``.npyz`` writer frames a stream as JAX's serial
    writer does, with more blocks than it keeps in flight, and its pooled
    reader re-chunks the stream as JAX's reader does."""
    from concurrent.futures import ThreadPoolExecutor
    arr = np.random.RandomState(len(blocks)).standard_normal(
        (sum(blocks), 3)).astype(np.float32)
    jp, tp = str(tmp_path / "j.npyz"), str(tmp_path / "t.npyz")
    with ThreadPoolExecutor(2) as pool:
        with jfs.NpyzWriter(jp, arr.dtype, arr.shape) as jw, \
                tfs.NpyzWriter(tp, arr.dtype, arr.shape, pool=pool) as tw:
            lo = 0
            for n in blocks:
                jw.write(arr[lo:lo + n])
                tw.write(arr[lo:lo + n])
                lo += n
        assert open(tp, "rb").read() == open(jp, "rb").read()
        for size in (1, 4, 64):
            got = list(tfs.iter_npyz_chunks(tp, size, pool=pool))
            want = list(jfs.iter_npyz_chunks(jp, size))
            assert [c.shape for c in got] == [c.shape for c in want]
            np.testing.assert_array_equal(np.concatenate(got), arr)


@pytest.mark.parametrize("layout,inflates",
                         [("local", False), ("memory", False),
                          ("zlib", True)])
def test_load_starts_inflate_pool_only_for_npyz(tmp_path, monkeypatch,
                                                layout, inflates):
    """A load starts its decompression pool at its first ``.npyz``
    stream, and a dump with none starts no pool."""
    started = []
    get = tck._InflatePool.get

    def spy(self):
        started.append(1)
        return get(self)

    monkeypatch.setattr(tck._InflatePool, "get", spy)
    coll, states = _port_states(7)
    path = _mem("p") if layout == "memory" else str(tmp_path / "p")
    kw = {"compress": "zlib"} if layout == "zlib" else {}
    tck.save_checkpoint(path, coll, states, **kw)
    back = tck.load_checkpoint(path, _port_coll())
    assert bool(started) == inflates
    for name in back:
        np.testing.assert_array_equal(_bits(_port_array(back, name)[0]),
                                      _bits(_port_array(states, name)[0]))


def test_zstd_where_installed(tmp_path):
    """zstd compresses where a binding is importable, else it is refused
    when the save is asked for, before anything is written."""
    coll, states = _port_states()
    path = str(tmp_path / "z")
    if tcompress._zstd() is None:
        with pytest.raises(ValueError, match="zstandard"):
            tck.save_checkpoint(path, coll, states, compress="zstd")
        assert not os.path.exists(path)
        return
    tck.save_checkpoint(path, coll, states, compress="zstd")
    back = tck.load_checkpoint(path, _port_coll())
    for name, _, _, _ in VARS:
        assert torch.equal(back[name].weights, states[name].weights)


def _legacy_npz(path):
    """Repack a local dump's ``var_*.d`` directories into the legacy
    single-file ``var_*.npz`` dumps."""
    for d in sorted(os.listdir(path)):
        if not d.endswith(".d"):
            continue
        vdir = os.path.join(path, d)
        arrays = {f[:-4]: np.load(os.path.join(vdir, f))
                  for f in os.listdir(vdir) if f.endswith(".npy")}
        np.savez(os.path.join(path, d[:-2] + ".npz"), **arrays)
        for f in os.listdir(vdir):
            os.remove(os.path.join(vdir, f))
        os.rmdir(vdir)


def test_array_legacy_npz_cross_read(devices8, tmp_path):
    coll, states = _port_states(2)
    ppath = str(tmp_path / "p")
    tck.save_checkpoint(ppath, coll, states)
    _legacy_npz(ppath)
    mesh = create_mesh(2, 4, devices8)
    jcoll = _jax_coll(mesh)
    jstates = jax_ckpt.load_checkpoint(ppath, jcoll)
    _same_arrays(jcoll, jstates, states)
    jpath = str(tmp_path / "j")
    jax_ckpt.save_checkpoint(jpath, jcoll, jstates)
    _legacy_npz(jpath)
    _same_arrays(jcoll, jstates, tck.load_checkpoint(jpath, _port_coll()))


# --- hash variables -------------------------------------------------------------

def _hash_specs(pkg, key_dtype, capacity=HCAP):
    make = oe.EmbeddingSpec if pkg == "jax" else EmbeddingSpec
    return [make(name=n, input_dim=-1, output_dim=d, dtype=t,
                 hash_capacity=capacity, key_dtype=key_dtype)
            for n, d, t in HVARS]


def _hash_keys(rng, n, key_dtype, lo=None, hi=None):
    if key_dtype == "wide":
        ids = rng.randint(lo if lo is not None else -2**62,
                          hi if hi is not None else 2**62, n, dtype=np.int64)
        return np.unique(jh.split64(np.unique(ids)), axis=0)
    return np.unique(rng.randint(lo if lo is not None else -2**31 + 1,
                                 hi if hi is not None else 2**31, n,
                                 dtype=np.int64).astype(np.int32))


def _jax_hash(mesh, key_dtype, n=300, seed=0, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    coll = oe.EmbeddingCollection(_hash_specs("jax", key_dtype), mesh,
                                  default_optimizer=ADAGRAD)
    states = coll.init(jax.random.PRNGKey(0))
    for name, dim, _ in HVARS:
        keys = _hash_keys(rng, n, key_dtype, lo, hi)
        states[name] = jsh.insert_rows_sharded(
            hot_cache.unwrap(states[name]), jnp.asarray(keys),
            jnp.asarray(rng.randn(len(keys), dim).astype(np.float32)),
            {"accum": jnp.asarray(rng.rand(len(keys), dim)
                                  .astype(np.float32))},
            mesh=mesh, spec=coll.sharding_spec(name))
    return coll, states


def _by_key(keys, weights, accum):
    keys = np.asarray(keys)
    live = (keys[:, 1] != np.int32(-2**31)) if keys.ndim == 2 \
        else keys != np.int32(-2**31)
    k64 = jh.join64(keys[live]) if keys.ndim == 2 \
        else keys[live].astype(np.int64)
    w, a = _bits(np.asarray(weights)[live]), np.asarray(accum)[live]
    return {int(k): (w[i].tobytes(), a[i].tobytes())
            for i, k in enumerate(k64)}


def _jax_by_key(states, name):
    st = hot_cache.unwrap(states[name])
    return _by_key(st.keys, st.weights, st.slots["accum"])


def _port_by_key(states, name):
    keys, w, slots, _ = interop.hash_state_to_numpy(states[name])
    return _by_key(keys, w, slots["accum"])


def _port_hash_coll(key_dtype, capacity=HCAP):
    return EmbeddingCollection(_hash_specs("port", key_dtype, capacity),
                               device="cpu", default_optimizer=ADAGRAD)


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
@pytest.mark.parametrize("where", ["zlib", "memory"])
def test_hash_part_layouts_cross_read(devices8, tmp_path, key_dtype, where):
    mesh = create_mesh(2, 4, devices8)
    jcoll, jstates = _jax_hash(mesh, key_dtype)
    kw = {"compress": "zlib"} if where == "zlib" else {}
    jpath = str(tmp_path / "j") if where == "zlib" else _mem("j")
    jax_ckpt.save_checkpoint(jpath, jcoll, jstates, **kw)
    tcoll = _port_hash_coll(key_dtype)
    tstates = tck.load_checkpoint(jpath, tcoll)
    for name, _, _ in HVARS:
        assert _port_by_key(tstates, name) == _jax_by_key(jstates, name)
        assert len(_port_by_key(tstates, name)) == 300
    ppath = str(tmp_path / "p") if where == "zlib" else _mem("p")
    tck.save_checkpoint(ppath, tcoll, tstates, **kw)
    back = jax_ckpt.load_checkpoint(ppath, oe.EmbeddingCollection(
        _hash_specs("jax", key_dtype), mesh, default_optimizer=ADAGRAD))
    for name, _, _ in HVARS:
        assert _jax_by_key(back, name) == _jax_by_key(jstates, name)


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
def test_hash_npyz_byte_identical_to_jax(devices8, tmp_path, key_dtype):
    """A one-device JAX hash table copied into the port slot for slot:
    the compressed dumps are byte-identical."""
    jcoll, jstates = _jax_hash(create_mesh(1, 1, devices8[:1]), key_dtype)
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), jcoll, jstates,
                             compress="zlib")
    states = {}
    for name, _, _ in HVARS:
        st = hot_cache.unwrap(jstates[name])
        states[name] = interop.hash_state_from_numpy(
            np.asarray(st.keys), np.asarray(st.weights),
            {k: np.asarray(v) for k, v in st.slots.items()}, "cpu")
    tck.save_checkpoint(str(tmp_path / "t"), _port_hash_coll(key_dtype),
                        states, compress="zlib")
    jf, tf = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    jf.pop("model_meta")
    tf.pop("model_meta")
    assert tf == jf and len(tf) == 9


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
def test_hash_legacy_npz_cross_read(devices8, tmp_path, key_dtype):
    mesh = create_mesh(2, 4, devices8)
    jcoll, jstates = _jax_hash(mesh, key_dtype)
    jpath = str(tmp_path / "j")
    jax_ckpt.save_checkpoint(jpath, jcoll, jstates)
    _legacy_npz(jpath)
    tcoll = _port_hash_coll(key_dtype)
    tstates = tck.load_checkpoint(jpath, tcoll)
    for name, _, _ in HVARS:
        assert _port_by_key(tstates, name) == _jax_by_key(jstates, name)
    ppath = str(tmp_path / "p")
    tck.save_checkpoint(ppath, tcoll, tstates)
    _legacy_npz(ppath)
    back = jax_ckpt.load_checkpoint(ppath, oe.EmbeddingCollection(
        _hash_specs("jax", key_dtype), mesh, default_optimizer=ADAGRAD))
    for name, _, _ in HVARS:
        assert _jax_by_key(back, name) == _jax_by_key(jstates, name)


# --- hash <-> array conversion ------------------------------------------------

CONV_VOCAB = 600


def _conv_array_specs(pkg):
    make = oe.EmbeddingSpec if pkg == "jax" else EmbeddingSpec
    return [make(name=n, input_dim=CONV_VOCAB, output_dim=d, dtype=t)
            for n, d, t in HVARS]


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_hash_dump_into_array_variable(devices8, tmp_path, key_dtype, saver):
    """A hash dump whose keys lie in ``[0, vocab)`` loads into an array
    variable: each key's row at its id, the rest zero (slots at their
    init), in both packages alike."""
    mesh = create_mesh(2, 4, devices8)
    jcoll, jstates = _jax_hash(mesh, key_dtype, n=200, lo=0, hi=CONV_VOCAB)
    path = str(tmp_path / "h")
    if saver == "jax":
        jax_ckpt.save_checkpoint(path, jcoll, jstates, compress="zlib")
    else:
        jax_ckpt.save_checkpoint(str(tmp_path / "j"), jcoll, jstates)
        tcoll = _port_hash_coll(key_dtype)
        tck.save_checkpoint(path, tcoll, tck.load_checkpoint(
            str(tmp_path / "j"), tcoll))
    acoll = oe.EmbeddingCollection(_conv_array_specs("jax"), mesh,
                                   default_optimizer=ADAGRAD)
    want = jax_ckpt.load_checkpoint(path, acoll)
    got = tck.load_checkpoint(path, EmbeddingCollection(
        _conv_array_specs("port"), device="cpu", default_optimizer=ADAGRAD))
    for name, _, _ in HVARS:
        jw, ja = _jax_array(acoll, want, name, CONV_VOCAB)
        tw, ta = _port_array(got, name)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(ta, ja)
        per_key = _jax_by_key(jstates, name)
        assert len(per_key) > 150
        assert all(tw[k].tobytes() == per_key[k][0] for k in per_key)
        absent = np.setdiff1d(np.arange(CONV_VOCAB), list(per_key))
        assert not tw[absent].any()


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_array_dump_into_hash_variable(devices8, tmp_path, key_dtype, saver):
    """An array dump loads into a hash variable: row id i becomes key i,
    every row inserted, in both packages alike (key by key)."""
    mesh = create_mesh(2, 4, devices8)
    coll, states = _port_states(7)
    path = str(tmp_path / "a")
    if saver == "port":
        tck.save_checkpoint(path, coll, states, compress="zlib")
    else:
        jcoll = _jax_coll(mesh)
        tck.save_checkpoint(str(tmp_path / "t"), coll, states)
        jax_ckpt.save_checkpoint(path, jcoll, jax_ckpt.load_checkpoint(
            str(tmp_path / "t"), jcoll))
    specs = [(n, d, t) for n, _, d, t in VARS]
    want = jax_ckpt.load_checkpoint(path, oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name=n, input_dim=-1, output_dim=d, dtype=t,
                          hash_capacity=HCAP, key_dtype=key_dtype)
         for n, d, t in specs], mesh, default_optimizer=ADAGRAD))
    got = tck.load_checkpoint(path, EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=-1, output_dim=d, dtype=t,
                       hash_capacity=HCAP, key_dtype=key_dtype)
         for n, d, t in specs], device="cpu", default_optimizer=ADAGRAD))
    for name, vocab, _, _ in VARS:
        mine = _port_by_key(got, name)
        assert mine == _jax_by_key(want, name)
        assert sorted(mine) == list(range(vocab))
        w, _ = _port_array(states, name)
        assert all(mine[i][0] == w[i].tobytes() for i in range(vocab))


# --- dumps of several parts -----------------------------------------------------

def _split_parts(path, num_parts=2):
    """A one-process part dump (``part0_*``, any codec) rewritten as
    ``num_parts`` parts of interleaved rows, as several JAX hosts would
    write it; the meta records ``num_parts``."""
    for d in sorted(os.listdir(path)):
        vdir = os.path.join(path, d)
        if not d.endswith(".d"):
            continue
        fields = {}
        for f in os.listdir(vdir):
            name = f[len("part0_"):].rsplit(".", 1)[0]
            p = os.path.join(vdir, f)
            it = jfs.iter_npyz_chunks(p, 1 << 20) if f.endswith(".npyz") \
                else jfs.iter_npy_chunks(p, 1 << 20)
            fields[name] = np.concatenate(list(it))
            os.remove(p)
        for k in range(num_parts):
            for name, arr in fields.items():
                np.save(os.path.join(vdir, f"part{k}_{name}.npy"),
                        arr[k::num_parts])
    mpath = os.path.join(path, "model_meta")
    meta = json.load(open(mpath))
    meta["extra"]["num_parts"] = num_parts
    json.dump(meta, open(mpath, "w"))


@pytest.mark.parametrize("kind", ["array", "wide", "int32"])
def test_multi_part_dump_loads_like_jax(devices8, tmp_path, kind):
    mesh = create_mesh(2, 4, devices8)
    path = str(tmp_path / "m")
    if kind == "array":
        coll, states = _port_states(9)
        tck.save_checkpoint(str(tmp_path / "t"), coll, states)
        jcoll = _jax_coll(mesh)
        jstates = jax_ckpt.load_checkpoint(str(tmp_path / "t"), jcoll)
    else:
        jcoll, jstates = _jax_hash(mesh, kind)
    jax_ckpt.save_checkpoint(path, jcoll, jstates, compress="zlib")
    _split_parts(path, 2)
    vdir = os.path.join(path, tck._var_dir(0, "fields"))
    assert {f.split("_", 1)[0] for f in os.listdir(vdir)} == \
        {"part0", "part1"}
    want = jax_ckpt.load_checkpoint(path, jcoll)
    if kind == "array":
        got = tck.load_checkpoint(path, _port_coll())
        _same_arrays(jcoll, want, got)
        _same_arrays(jcoll, jstates, got)
    else:
        got = tck.load_checkpoint(path, _port_hash_coll(kind))
        for name, _, _ in HVARS:
            assert _port_by_key(got, name) == _jax_by_key(want, name) \
                == _jax_by_key(jstates, name)


# --- serving and the native reader ----------------------------------------------

@pytest.mark.parametrize("layout", ["zlib", "memory", "legacy", "parts"])
def test_registry_serves_every_layout(devices8, tmp_path, layout):
    coll, states = _port_states(11)
    path = str(tmp_path / "m") if layout != "memory" else _mem("m")
    if layout == "zlib":
        tck.save_checkpoint(path, coll, states, compress="zlib",
                            model_sign="s")
    elif layout == "memory":
        tck.save_checkpoint(path, coll, states, model_sign="s")
    elif layout == "legacy":
        tck.save_checkpoint(path, coll, states, model_sign="s")
        _legacy_npz(path)
    else:
        tck.save_checkpoint(path, coll, states, compress="zlib",
                            model_sign="s")
        _split_parts(path, 3)
    reg = ModelRegistry(device="cpu")
    sign = reg.create_model(path)
    assert reg.find_model(sign).version == 0
    ids = np.array([0, 5, 36, 37, -1, 12], np.int64)
    for name, vocab, _, _ in VARS:
        got = interop.tensor_to_numpy(reg.lookup(sign, name, ids))
        w, _ = _port_array(states, name)
        want = np.where(((ids >= 0) & (ids < vocab))[:, None],
                        w[np.clip(ids, 0, vocab - 1)], 0)
        np.testing.assert_array_equal(_bits(got), want)


def test_registry_serves_compressed_hash_dump(tmp_path):
    rng = np.random.RandomState(2)
    coll = _port_hash_coll("wide")
    states = coll.init()
    keys = _hash_keys(rng, 100, "wide")
    for name, dim, _ in HVARS:
        th.insert_rows(states[name], torch.from_numpy(keys),
                       torch.randn(len(keys), dim),
                       {"accum": torch.rand(len(keys), dim)})
    path = str(tmp_path / "h")
    tck.save_checkpoint(path, coll, states, compress="zlib")
    reg = ModelRegistry(device="cpu")
    sign = reg.create_model(path)
    q = np.concatenate([keys[:20], _hash_keys(rng, 3, "wide")])
    for name, _, _ in HVARS:
        want = coll.pull(states, {name: q}, read_only=True)[name]
        assert torch.equal(reg.lookup(sign, name, q), want)


def _native():
    from openembedding_tpu_torch.serving import native
    try:
        return native, native.build_library()
    except RuntimeError as e:   # no compiler on this host
        pytest.fail(f"native build: {e}")


def test_native_reads_port_save_and_delta_chain(tmp_path):
    native, lib = _native()
    coll, states = _port_states(13)
    coll.enable_dirty_tracking(target_chunks=4)
    path = str(tmp_path / "n")
    tck.save_checkpoint(path, coll, states, model_sign="nat")
    ids = np.array([0, 3, 20, 36, 37, -2], np.int64)

    def check(version):
        reg = ModelRegistry(device="cpu")
        sign = reg.create_model(path)
        assert reg.find_model(sign).version == version
        with native.NativeModel(path, lib) as m:
            assert m.version == version and m.sign == "nat"
            for name, _, _, dtype in VARS:
                if dtype != "float32":
                    continue
                want = interop.tensor_to_numpy(reg.lookup(sign, name, ids))
                np.testing.assert_array_equal(m.lookup(name, ids), want)
                got = m.lookup_batched(name, [ids[:2], ids[2:]])
                np.testing.assert_array_equal(np.concatenate(got), want)
    check(0)
    rows = coll.pull(states, {"fields": np.array([3, 20])})
    states = coll.apply_gradients(
        states, {"fields": np.array([3, 20])},
        {"fields": torch.ones_like(rows["fields"])})
    info = tcd.save_delta(path, coll, states, step=1,
                          compact_bytes_ratio=1e18,
                          background_compact=False)
    assert info["mode"] == "delta" and info["seq"] == 1
    check(1)


def test_native_refuses_compressed_delta(tmp_path):
    native, lib = _native()
    coll, states = _port_states(14)
    coll.enable_dirty_tracking(target_chunks=4)
    path = str(tmp_path / "n")
    tck.save_checkpoint(path, coll, states)
    rows = coll.pull(states, {"fields": np.array([1])})
    states = coll.apply_gradients(states, {"fields": np.array([1])},
                                  {"fields": torch.ones_like(
                                      rows["fields"])})
    tcd.save_delta(path, coll, states, step=1, compress="zlib",
                   compact_bytes_ratio=1e18, background_compact=False)
    with pytest.raises(RuntimeError, match="deflated"):
        native.NativeModel(path, lib)
    # the Python loader replays it
    assert tcd.read_manifest(path)["last_seq"] == 1
    tck.load_checkpoint(path, _port_coll())
