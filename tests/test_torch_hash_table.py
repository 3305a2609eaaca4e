"""Torch port, hash tables: ``openembedding_tpu_torch.hash_table`` and the
collection's hash pull, held against the JAX package's ``hash_table`` and
its one-device ``EmbeddingCollection``.

Nothing here does floating-point arithmetic: hashing, probing and
placement are integer work and pulls are copies, so every comparison is
exact (bit-equal, bf16 included).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import hash_table as jh
from openembedding_tpu.parallel import sharded_hash as jsh
from openembedding_tpu.parallel.mesh import single_device_mesh
from openembedding_tpu.utils import jaxcompat
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.meta import EmbeddingVariableMeta

EMPTY = -2**31
# narrow capacities: under one bucket, an odd span (128 x 37), a power of 2
CAPACITIES = [64, 128 * 37, 4096]


def _narrow_keys(rng, n):
    k = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    k[:4] = [EMPTY, 0, -1, 2**31 - 1]
    return k


def _pair_keys(rng, n):
    k = rng.randint(-2**31, 2**31, (n, 2), dtype=np.int64).astype(np.int32)
    k[:4] = [[EMPTY, EMPTY], [0, 0], [-1, -1], [5, EMPTY + 1]]
    return k


@pytest.mark.parametrize("capacity", CAPACITIES + [1 << 23])
def test_probe_starts_and_mixing_bit_equal(capacity):
    """``probe_starts``, ``_mix`` and ``_mix_pair`` equal the JAX uint32
    arithmetic bit for bit: negative keys, EMPTY, pairs with hi != 0."""
    rng = np.random.RandomState(capacity % 1000)
    narrow, pairs = _narrow_keys(rng, 3000), _pair_keys(rng, 3000)
    for keys in (narrow, pairs):
        want = np.asarray(jh.probe_starts(jnp.asarray(keys), capacity,
                                          jh.DEFAULT_MAX_PROBES))
        got = th.probe_starts(torch.from_numpy(keys), capacity,
                              th.DEFAULT_MAX_PROBES)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        th._mix(torch.from_numpy(narrow)).numpy(),
        np.asarray(jh._mix(jnp.asarray(narrow))).astype(np.int64))
    np.testing.assert_array_equal(
        th._mix_pair(torch.from_numpy(pairs[:, 0]),
                     torch.from_numpy(pairs[:, 1])).numpy(),
        np.asarray(jh._mix_pair(jnp.asarray(pairs[:, 0]),
                                jnp.asarray(pairs[:, 1]))).astype(np.int64))


def test_layout_and_rounding_match_jax():
    for cap in (8, 64, 128, 1000, 4096, 128 * 37, 1 << 23):
        assert th.round_capacity(cap) == jh.round_capacity(cap)
        r = jh.round_capacity(cap)
        assert th.table_layout(r, 256) == jh.table_layout(r, 256)
        assert th.probe_window(r, 256) == jh.probe_window(r, 256)
    with pytest.raises(ValueError, match="round_capacity"):
        th.table_layout(1000, th.DEFAULT_MAX_PROBES)
    assert (th.BUCKET, th.DEFAULT_MAX_PROBES) == (jh.BUCKET,
                                                  jh.DEFAULT_MAX_PROBES)


def test_widen_split_join_pair_mod_match_jax():
    rng = np.random.RandomState(0)
    ids32 = _narrow_keys(rng, 500)
    np.testing.assert_array_equal(
        th.widen_ids(torch.from_numpy(ids32)).numpy(),
        np.asarray(jh.widen_ids(jnp.asarray(ids32))))
    ids64 = np.concatenate([
        rng.randint(-2**62, 2**62, 500, dtype=np.int64),
        np.asarray([np.iinfo(np.int64).min, -1, 0, 2**33 + 7], np.int64)])
    with jaxcompat.enable_x64(True):
        want64 = np.asarray(jh.widen_ids(jnp.asarray(ids64)))
    np.testing.assert_array_equal(
        th.widen_ids(torch.from_numpy(ids64)).numpy(), want64)
    assert th.widen_ids(torch.from_numpy(ids32.reshape(4, 125))).shape == \
        (4, 125, 2)
    pairs = th.split64(ids64)
    np.testing.assert_array_equal(pairs, jh.split64(ids64))
    np.testing.assert_array_equal(th.join64(pairs), jh.join64(pairs))
    np.testing.assert_array_equal(th.join64(pairs[:-4]), ids64[:-4])
    for g in (1, 2, 3, 7, 1000, 32767):
        np.testing.assert_array_equal(
            th.pair_mod(torch.from_numpy(pairs), g).numpy(),
            np.asarray(jh.pair_mod(jnp.asarray(pairs), g)))
    with pytest.raises(ValueError, match="shard count"):
        th.pair_mod(torch.from_numpy(pairs), 1 << 15)


def _stream(wide, capacity, rng):
    """Three insert batches into one table: EMPTY duplicates, re-inserted
    keys, enough keys to overflow buckets into their chain and, on the
    last batch, to overflow whole windows (counted failures)."""
    make = _pair_keys if wide else _narrow_keys
    out = []
    for n in (capacity // 3, capacity // 3, 2 * capacity):
        k = make(rng, n)
        k[4:8] = EMPTY                       # EMPTY duplicates
        if out:
            again = out[-1][3:3 + n // 4]    # keys already present
            k[8:8 + len(again)] = again
        k = np.unique(k, axis=0) if wide else np.unique(k)
        k = k[rng.permutation(len(k))]
        k[:3] = EMPTY
        out.append(k)
    return out


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_find_or_insert_matches_jax_slot_for_slot(wide, capacity):
    rng = np.random.RandomState(capacity)
    shape = (capacity, 2) if wide else (capacity,)
    jkeys = jnp.full(shape, EMPTY, jnp.int32)
    tkeys = torch.full(shape, EMPTY, dtype=torch.int32)
    failed_total = 0
    for batch in _stream(wide, capacity, rng):
        valid = (batch[:, 1] if wide else batch) != EMPTY
        jkeys, jslot, jins, jfail = jh.find_or_insert(
            jkeys, jnp.asarray(batch), jnp.asarray(valid))
        out = th.find_or_insert(tkeys, torch.from_numpy(batch),
                                torch.from_numpy(valid))
        assert out[0] is tkeys                      # in place
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        for got, want in zip(out[1:], (jslot, jins, jfail)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        failed_total += int(np.asarray(jfail).sum())
        q = np.concatenate([batch, _pair_keys(rng, 50) if wide
                            else _narrow_keys(rng, 50)])
        np.testing.assert_array_equal(
            th.find_rows(tkeys, torch.from_numpy(q)).numpy(),
            np.asarray(jh.find_rows(jkeys, jnp.asarray(q))))
    assert failed_total > 0                         # windows overflowed


def _meta(dim, dtype="float32"):
    return oe.meta.EmbeddingVariableMeta(datatype=dtype, embedding_dim=dim,
                                         vocabulary_size=2**63)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_insert_rows_matches_jax(wide, dtype):
    """Load-path insert: same keys array, weights and slot rows as the
    JAX one-device ``insert_rows``, failures counted alike."""
    rng = np.random.RandomState(1)
    cap, dim = 256, 9
    opt = {"category": "adagrad"}
    jstate = jh.create_hash_table(_meta(dim, dtype), opt, capacity=cap,
                                  key_width=64 if wide else 32)
    tstate = th.create_hash_table(
        EmbeddingVariableMeta(dtype, dim, 2**63), opt, capacity=cap,
        key_dtype="wide" if wide else "int32", device="cpu")
    for n in (100, 300):
        keys = (_pair_keys if wide else _narrow_keys)(rng, n)
        keys = np.unique(keys, axis=0) if wide else np.unique(keys)
        w = rng.randn(len(keys), dim).astype(np.float32)
        acc = rng.rand(len(keys), dim).astype(np.float32)
        jstate = jh.insert_rows(jstate, jnp.asarray(keys), jnp.asarray(w),
                                {"accum": jnp.asarray(acc)})
        th.insert_rows(tstate, torch.from_numpy(keys), torch.from_numpy(w),
                       {"accum": torch.from_numpy(acc)})
    keys, weights, slots, init_rng = interop.hash_state_to_numpy(tstate)
    np.testing.assert_array_equal(keys, np.asarray(jstate.keys))
    np.testing.assert_array_equal(init_rng, np.asarray(jstate.init_rng))
    jw = np.asarray(jstate.weights)
    np.testing.assert_array_equal(
        weights, jw.view(np.uint16) if dtype == "bfloat16" else jw)
    np.testing.assert_array_equal(slots["accum"],
                                  np.asarray(jstate.slots["accum"]))
    assert int(tstate.insert_failures) == int(jstate.insert_failures) > 0
    assert tstate.num_used() == int(jstate.num_used())


@pytest.mark.parametrize("wide", [False, True])
def test_read_only_pull_matches_jax(wide):
    """``pull(state, keys, None)`` on [B, F] / [B, F, 2] queries equals
    JAX ``hash_table.pull`` with the read-only contract."""
    rng = np.random.RandomState(2)
    jstate = jh.create_hash_table(_meta(9), "default", capacity=512,
                                  key_width=64 if wide else 32)
    keys = (_pair_keys if wide else _narrow_keys)(rng, 200)[4:]
    jstate = jh.insert_rows(jstate, jnp.asarray(keys), jnp.asarray(
        rng.randn(len(keys), 9).astype(np.float32)))
    tstate = interop.hash_state_from_numpy(
        np.asarray(jstate.keys), np.asarray(jstate.weights), {}, "cpu")
    q = np.concatenate([keys[:30], (_pair_keys if wide else _narrow_keys)(
        rng, 18)])
    q = q.reshape((6, 8, 2) if wide else (6, 8))
    want = np.asarray(jh.pull(jstate, jnp.asarray(q), None))
    got = th.pull(tstate, torch.from_numpy(q))
    assert got.shape == want.shape == (6, 8, 9)
    np.testing.assert_array_equal(got.numpy(), want)


def _hash_specs(pkg, key_dtype):
    mod = oe if pkg == "jax" else None
    make = mod.EmbeddingSpec if mod else EmbeddingSpec
    return [make(name="h", input_dim=-1, output_dim=9, hash_capacity=1000,
                 key_dtype=key_dtype),
            make(name="h:linear", input_dim=-1, output_dim=1,
                 hash_capacity=300, key_dtype=key_dtype)]


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
def test_collection_hash_pull_matches_jax(key_dtype):
    """The collection's read-only hash pull against the JAX collection's on
    a one-device mesh, on the same copied state: pair queries, narrow
    int32 ids and host int64 ids."""
    rng = np.random.RandomState(3)
    mesh = single_device_mesh()
    jcoll = oe.EmbeddingCollection(_hash_specs("jax", key_dtype), mesh)
    jstates = jcoll.init(jax.random.PRNGKey(0))
    tcoll = EmbeddingCollection(_hash_specs("port", key_dtype),
                                device="cpu")
    assert tcoll.model_meta("s", "u").dumps() == \
        jcoll.model_meta("s", "u").dumps()
    tstates = tcoll.init()
    ids = rng.randint(-5000, 5000, 400).astype(np.int64)
    ids[:2] = [2**40 + 3, -(2**35)] if key_dtype == "wide" else [7, -7]
    keys = jh.split64(ids) if key_dtype == "wide" else ids.astype(np.int32)
    for name, st in jstates.items():
        dim = st.weights.shape[1]
        st = jsh.insert_rows_sharded(
            st, jnp.asarray(keys), jnp.asarray(
                rng.randn(len(keys), dim).astype(np.float32)),
            mesh=mesh, spec=jcoll.sharding_spec(name))
        jstates[name] = st
        assert tstates[name].keys.shape == st.keys.shape
        tstates[name] = interop.hash_state_from_numpy(
            np.asarray(st.keys), np.asarray(st.weights), {}, "cpu")
    q = np.concatenate([ids[:40], rng.randint(-5000, 5000, 8)]).reshape(6, 8)
    inputs = [q.astype(np.int32), q.astype(np.int64)]
    if key_dtype == "wide":
        inputs.append(jh.split64(q))
        inputs.append(np.asarray([2**40 + 3, -(2**35), 1], np.int64))
    for inp in inputs:
        for name in jstates:
            want = np.asarray(jcoll.pull(jstates, {name: inp},
                                         batch_sharded=False,
                                         read_only=True)[name])
            got = tcoll.pull(tstates, {name: inp}, read_only=True)[name]
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)


def test_hash_refusals():
    """What the port does not run yet raises, naming its ROADMAP item;
    malformed queries raise ValueError as in the JAX package. int64 keys
    run now (``test_torch_x64.py`` holds them against JAX)."""
    coll = EmbeddingCollection(_hash_specs("port", "wide"), device="cpu")
    states = coll.init()
    assert EmbeddingSpec(name="x", input_dim=-1, output_dim=2,
                         key_dtype="int64").key_dtype == "int64"
    t64 = th.create_hash_table(EmbeddingVariableMeta("float32", 2, 2**63),
                               "default", capacity=8, key_dtype="int64",
                               device="cpu")
    assert t64.keys.dtype == torch.int64 and t64.keys.shape == (8,)
    assert int(t64.keys[0]) == th.empty_key(torch.int64) == -2**63
    # a replica size runs now: on the cached plane it sizes the replica
    cached = EmbeddingSpec(name="x", input_dim=-1, output_dim=2, cache_k=4,
                           plane="a2a+cache")
    assert (cached.cache_k, cached.plane) == (4, "a2a+cache")
    with pytest.raises(ValueError, match="unknown key_dtype"):
        EmbeddingSpec(name="x", input_dim=-1, output_dim=2,
                      key_dtype="int16")
    st = states["h"]
    with pytest.raises(ValueError, match="key-shape mismatch"):
        th.pull(st, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="exceed int32"):
        coll.pull(states, {"h": np.full((2, 2), 2**40, np.int64)},
                  read_only=True)
    narrow = th.create_hash_table(EmbeddingVariableMeta("float32", 2, 2**63),
                                  "default", capacity=8, device="cpu")
    with pytest.raises(ValueError, match="int64 but the table stores"):
        th.pull(narrow, torch.zeros(3, dtype=torch.int64))


def _foi_case(mode):
    """A CPU keys array holding some keys, and a batch of found, new and
    EMPTY entries for it."""
    rng = np.random.RandomState(len(mode))
    if mode == "int64":
        k = np.unique(rng.randint(-2**63 + 1, 2**63 - 1, 600, dtype=np.int64))
        empty = np.full(4, -2**63, np.int64)
    elif mode == "wide":
        k = np.unique(_pair_keys(rng, 600)[4:], axis=0)
        empty = np.full((4, 2), EMPTY, np.int32)
    else:
        k = np.unique(_narrow_keys(rng, 600)[4:])
        empty = np.full(4, EMPTY, np.int32)
    k = k[rng.permutation(len(k))]
    dtype = torch.int64 if mode == "int64" else torch.int32
    keys = torch.full((512, 2) if mode == "wide" else (512,),
                      th.empty_key(dtype), dtype=dtype)
    th.find_or_insert_reference(keys, torch.from_numpy(k[:200]),
                                torch.ones(200, dtype=torch.bool))
    batch = np.concatenate([k[100:400], empty])
    flat = batch[:, 1] if mode == "wide" else batch
    return keys, torch.from_numpy(batch), torch.from_numpy(
        flat != th.empty_key(dtype))


@pytest.mark.parametrize("mode", ["wide", "int32", "int64"])
def test_find_or_insert_on_cpu_is_the_plain_version(mode):
    """On CPU tensors ``find_or_insert`` (and the kernel wrapper) is
    ``find_or_insert_reference``: the same outputs and the same keys
    array, no kernel launch and nothing counted."""
    from openembedding_tpu_torch.ops import find_or_insert as k3
    keys, batch, valid = _foi_case(mode)
    twin, wrapped = keys.clone(), keys.clone()
    launched, counts = k3.find_or_insert.launches, k3.key_counts()
    got = th.find_or_insert(keys, batch, valid)
    want = th.find_or_insert_reference(twin, batch, valid)
    again = k3.find_or_insert(wrapped, batch, valid, th.DEFAULT_MAX_PROBES)
    assert got[0] is keys and again[0] is wrapped
    assert torch.equal(keys, twin) and torch.equal(wrapped, twin)
    for out in (got, again):
        for g, w in zip(out[1:], want[1:]):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[2].any()) and bool((valid & ~want[2]).any())
    assert k3.find_or_insert.launches == launched
    assert k3.key_counts() == counts == dict.fromkeys(k3.OUTCOMES, 0)


def _refusal(case):
    keys, batch, valid = _foi_case("wide")
    if case == "device":
        return (keys.to("meta"), batch.to("meta"), valid.to("meta")), \
            ValueError, "cpu or cuda"
    if case == "several_devices":
        return (keys, batch.to("meta"), valid), ValueError, "several"
    if case == "shape":
        return (keys, batch[:, 0], valid), ValueError, "key-shape"
    if case == "dtype":
        return (keys, batch.to(torch.int64), valid), TypeError, "dtype"
    if case == "int64_pairs":
        return (keys.to(torch.int64), batch.to(torch.int64), valid), \
            TypeError, "pairs"
    if case == "valid_dtype":
        return (keys, batch, valid.to(torch.int32)), ValueError, "bool"
    return (keys, batch, valid[1:]), ValueError, "valid"


@pytest.mark.parametrize("case", ["device", "several_devices", "shape",
                                  "dtype", "int64_pairs", "valid_dtype",
                                  "valid_shape"])
def test_find_or_insert_refusals(case):
    """The wrapper refuses a device that is neither cpu nor cuda, tensors
    on several devices, a wide/narrow mismatch, keys of another dtype or
    pairs that are not int32, and a ``valid`` that is not ``[n]`` bool;
    the keys array is left as it was."""
    args, error, words = _refusal(case)
    before = args[0].clone() if args[0].device.type == "cpu" else None
    with pytest.raises(error, match=words):
        th.find_or_insert(*args)
    if before is not None:
        assert torch.equal(args[0], before)


@pytest.mark.parametrize("mode", ["wide", "int32", "int64"])
def test_key_counts_on_cpu(mode):
    """``key_counts`` names every outcome and reads zeros where no kernel
    ran (the plain version counts nothing), without touching CUDA; the
    ``/metrics`` page shows those zeros."""
    from openembedding_tpu_torch.ops import find_or_insert as k3
    from openembedding_tpu_torch.utils import observability
    keys, batch, valid = _foi_case(mode)
    before = k3.find_or_insert.launches
    th.find_or_insert(keys, batch, valid)
    assert k3.find_or_insert.launches == before
    assert k3.key_counts() == {"found": 0, "inserted": 0, "failed": 0}
    text = observability.prometheus_text(include_mem=False)
    assert "# TYPE oe_hash_find_keys_total counter" in text
    for outcome in k3.OUTCOMES:
        assert f'oe_hash_find_keys_total{{outcome="{outcome}"}} 0' in text
