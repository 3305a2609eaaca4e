"""Torch port, data ingest against the JAX package: the Criteo TSV/CSV
readers, the TFRecord container, ``ShardStream``, ``preprocess`` and
``EnvConfig``.

Every comparison feeds the same files (or lines, or dicts) to the JAX
function and to the port's and requires equal results: batches equal in
dtype and bytes, shard files and preprocess outputs equal in sha256,
cursors, bad-row counts and warnings equal. All sizes are small (a few
hundred rows a shard).
"""

import hashlib
import os
import struct
import threading
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

from openembedding_tpu.data import criteo as jcriteo
from openembedding_tpu.data import preprocess as jpre
from openembedding_tpu.data import stream as jstream
from openembedding_tpu.data import tfrecord as jtfr
from openembedding_tpu.utils import envconfig as jenv
from openembedding_tpu.utils import observability as jobs
from openembedding_tpu_torch.data import criteo as tcriteo
from openembedding_tpu_torch.data import preprocess as tpre
from openembedding_tpu_torch.data import stream as tstream
from openembedding_tpu_torch.data import tfrecord as ttfr
from openembedding_tpu_torch.utils import envconfig as tenv
from openembedding_tpu_torch.utils import observability as tobs

ROWS, BATCH = 300, 64


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], dict):
                assert list(g[k]) == list(w[k])
                for n in w[k]:
                    _same_array(g[k][n], w[k][n])
            else:
                _same_array(g[k], w[k])
    return len(got)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Shard sets written by JAX's and the port's writers, both formats,
    with and without bad rows."""
    root = tmp_path_factory.mktemp("shards")
    out = {}
    for pkg, mod in (("jax", jstream), ("port", tstream)):
        for fmt in ("tsv", "tfrecord"):
            d = str(root / f"{pkg}-{fmt}")
            out[pkg, fmt] = mod.write_synthetic_shards(
                d, num_shards=3, rows_per_shard=ROWS, fmt=fmt, seed=5)
        d = str(root / f"{pkg}-bad")
        out[pkg, "bad"] = mod.write_synthetic_shards(
            d, num_shards=2, rows_per_shard=ROWS, fmt="tsv", seed=6,
            bad_rows_per_shard=40)
    return out


# --- rows ---------------------------------------------------------------------

VALID = "\t".join(["1"] + ["3", "", "-2"] + ["7"] * 10
                  + ["a1b2", "", "ffffffff"] + ["0"] * 23)


@pytest.mark.parametrize("line", [
    VALID + "\n", VALID, "1\t5\n", "", "\n",
    VALID.replace("a1b2", "zz-not-hex"),
    VALID.replace("\t3\t", "\tx\t", 1),
    "\t".join([""] * 40), "\t".join(["0"] * 41),
])
def test_parse_tsv_row_matches_jax(line):
    assert tcriteo.parse_tsv_row(line) == jcriteo.parse_tsv_row(line)


_FIELD = hs.one_of(hs.just(""), hs.integers(-5, 10 ** 6).map(str),
                   hs.integers(0, 2 ** 40).map(lambda v: "%x" % v),
                   hs.text("0123456789abcdefxyz- .", max_size=6))


@settings(max_examples=150, deadline=None)
@given(hs.lists(_FIELD, min_size=37, max_size=42))
def test_parse_tsv_row_generated_lines(fields):
    line = "\t".join(fields) + "\n"
    assert tcriteo.parse_tsv_row(line) == jcriteo.parse_tsv_row(line)


def test_hash_and_squash_match_jax():
    raw = np.random.RandomState(0).randint(-2 ** 62, 2 ** 62, 5000,
                                           dtype=np.int64)
    for buckets in (1 << 20, 1 << 22, 2 ** 31 + 11):
        _same_array(tcriteo.hash_bucket(raw, buckets),
                    jcriteo.hash_bucket(raw, buckets))
    counts = np.random.RandomState(1).randint(-3, 1000, (50, 13))
    _same_array(tcriteo._squash_dense(counts), jcriteo._squash_dense(counts))


# --- writers --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tsv", "tfrecord", "bad"])
def test_synthetic_shards_byte_identical(shards, kind):
    jp, tp = shards["jax", kind], shards["port", kind]
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    assert [_sha(p) for p in tp] == [_sha(p) for p in jp]


def test_tfrecord_container_and_example_match_jax(tmp_path):
    feats = {"label": [1], "I1": [2.5, -1.0], "C1": [2 ** 40, -3],
             "blob": [b"ab", b""], "empty": []}
    ex = ttfr.make_example(feats)
    assert ex == jtfr.make_example(feats)
    assert ttfr.parse_example(ex) == jtfr.parse_example(ex)
    for data in (b"", b"x", ex, bytes(range(256)) * 3):
        assert ttfr.masked_crc(data) == jtfr.masked_crc(data)
        assert ttfr._crc32c_py(data) == jtfr._crc32c_py(data)
    paths = []
    for mod, name in ((ttfr, "t"), (jtfr, "j")):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            for i in range(5):
                mod.write_record(f, ex + bytes([i]))
        paths.append(p)
    assert _sha(paths[0]) == _sha(paths[1])
    assert list(ttfr.read_records(paths[0])) == \
        list(jtfr.read_records(paths[0]))


# --- single-file readers -----------------------------------------------------

@pytest.mark.parametrize("drop", [True, False])
def test_read_criteo_tsv_matches_jax(shards, drop):
    for p in shards["jax", "tsv"] + shards["jax", "bad"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            n = _same_batches(
                tcriteo.read_criteo_tsv(p, BATCH, num_buckets=1 << 22,
                                        drop_remainder=drop),
                jcriteo.read_criteo_tsv(p, BATCH, num_buckets=1 << 22,
                                        drop_remainder=drop))
        assert n >= 3
    p = shards["jax", "tsv"][0]
    _same_batches(tcriteo.read_criteo_tsv(p, BATCH, max_batches=2),
                  jcriteo.read_criteo_tsv(p, BATCH, max_batches=2))


def test_read_criteo_csv_matches_jax(shards, tmp_path):
    src = shards["jax", "tsv"][0]
    csv = str(tmp_path / "p.csv")
    jpre.preprocess(src, csv)
    for drop in (True, False):
        _same_batches(tcriteo.read_criteo_csv(csv, 50, drop_remainder=drop),
                      jcriteo.read_criteo_csv(csv, 50, drop_remainder=drop))
    _same_batches(tcriteo.read_criteo_csv(csv, 50, max_batches=3),
                  jcriteo.read_criteo_csv(csv, 50, max_batches=3))


@pytest.mark.parametrize("limit", [0, 130])
def test_read_criteo_tfrecord_matches_jax(shards, limit):
    d = os.path.dirname(shards["jax", "tfrecord"][0])
    for path in (d, shards["jax", "tfrecord"][1]):
        _same_batches(ttfr.read_criteo_tfrecord(path, BATCH, limit=limit),
                      jtfr.read_criteo_tfrecord(path, BATCH, limit=limit))


def test_bad_rows_counted_and_warned_as_jax(shards):
    p = shards["jax", "bad"][0]
    got = {}
    for pkg, mod, obs in (("jax", jcriteo, jobs), ("port", tcriteo, tobs)):
        c0 = obs.GLOBAL.snapshot().get("ingest_bad_rows", {}).get(
            "count", 0.0)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            list(mod.read_criteo_tsv(p, BATCH))
        c1 = obs.GLOBAL.snapshot()["ingest_bad_rows"]["count"]
        got[pkg] = (c1 - c0, [str(x.message) for x in w
                              if x.category is RuntimeWarning])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 40 and len(got["port"][1]) == 1
    # below the threshold's row count nothing warns
    for mod in (jcriteo, tcriteo):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mod.note_bad_rows(1, 1, 2, "src", [])
        assert not w


def test_prefetch_matches_jax(shards):
    p = shards["jax", "tsv"][0]
    for depth in (1, 2, 5):
        placed = []

        def place(b):
            placed.append(b)
            return b
        got = list(tcriteo.prefetch(jcriteo.read_criteo_tsv(p, BATCH),
                                    place, depth))
        want = list(jcriteo.prefetch(jcriteo.read_criteo_tsv(p, BATCH),
                                     lambda b: b, depth))
        _same_batches(got, want)
        assert len(placed) == len(want)
    assert list(tcriteo.prefetch([], lambda b: b)) == []


def test_prefetch_places_with_the_trainer(shards):
    """``prefetch(place_fn=Trainer.place_batch)``: placed batches are
    tensors of their own on the trainer's device."""
    import torch
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models.deepctr import build_model
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    specs, mapper = make_fused_specs(tcriteo.SPARSE_NAMES, 1 << 12, 4)
    trainer = Trainer(build_model("deepfm", tcriteo.SPARSE_NAMES,
                                  embedding_dim=4, num_dense=13,
                                  dnn_units=(8,)),
                      EmbeddingCollection(specs, device="cpu"),
                      dense.adagrad(0.01))
    src = [mapper.fuse_batch(b) for b in tcriteo.read_criteo_tsv(
        shards["jax", "tsv"][0], BATCH, num_buckets=1 << 12)]
    placed = list(tcriteo.prefetch(iter(src), trainer.place_batch, 2))
    assert len(placed) == len(src)
    for got, b in zip(placed, src):
        assert isinstance(got["label"], torch.Tensor)
        assert torch.equal(got["label"], torch.from_numpy(b["label"]))
        assert torch.equal(got["sparse"]["fields"],
                           torch.from_numpy(b["sparse"]["fields"]))


# --- ShardStream ----------------------------------------------------------------

def _streams(paths, **kw):
    return (tstream.ShardStream(paths, **kw), jstream.ShardStream(paths, **kw))


@pytest.mark.parametrize("readers", [1, 2, 3])
@pytest.mark.parametrize("fmt", ["tsv", "tfrecord"])
def test_shard_stream_matches_jax(shards, readers, fmt):
    t, j = _streams(shards["jax", fmt], batch_size=BATCH, fmt=fmt,
                    num_buckets=1 << 20, readers=readers)
    with t, j:
        n = _same_batches(t, j)
    # batches never mix rows across readers; a reader's shards run on
    readers_rows = [ROWS * len(range(r, 3, readers)) for r in range(readers)]
    assert n == sum(rows // BATCH for rows in readers_rows)
    assert t.cursor() == j.cursor() == n
    assert t.stall_summary()["pops"] == n


@pytest.mark.parametrize("opts", [
    {"epochs": 2}, {"drop_remainder": False}, {"add_linear": True},
    {"ring_batches": 1, "readers": 2}, {"readers": 7},
])
def test_shard_stream_options_match_jax(shards, opts):
    kw = {"batch_size": BATCH, "num_buckets": 1 << 20, **opts}
    t, j = _streams(shards["jax", "tsv"], **kw)
    with t, j:
        _same_batches(t, j)
    assert t.readers == j.readers and t.ring_batches == j.ring_batches


def test_shard_stream_transform_and_directory(shards):
    from openembedding_tpu.fused import make_fused_specs as jfused
    from openembedding_tpu_torch.fused import make_fused_specs as tfused
    _, jm = jfused(jcriteo.SPARSE_NAMES, 1 << 10, 4)
    _, tm = tfused(tcriteo.SPARSE_NAMES, 1 << 10, 4)
    d = os.path.dirname(shards["jax", "tsv"][0])
    t = tstream.ShardStream(d, batch_size=BATCH, num_buckets=1 << 10,
                            transform=tm.fuse_batch)
    j = jstream.ShardStream(d, batch_size=BATCH, num_buckets=1 << 10,
                            transform=jm.fuse_batch)
    with t, j:
        assert _same_batches(t, j) == 13
    assert tstream.discover_shards(d) == jstream.discover_shards(d)
    assert tstream.discover_shards(
        os.path.dirname(shards["jax", "tfrecord"][0]), "tfrecord") == \
        jstream.discover_shards(
            os.path.dirname(shards["jax", "tfrecord"][0]), "tfrecord")
    with pytest.raises(FileNotFoundError) as te:
        tstream.discover_shards(d, "tfrecord")
    with pytest.raises(FileNotFoundError) as je:
        jstream.discover_shards(d, "tfrecord")
    assert str(te.value) == str(je.value)
    for bad in ({"fmt": "csv"}, {"epochs": 0}):
        with pytest.raises(ValueError) as te:
            tstream.ShardStream(d, batch_size=BATCH, **bad)
        with pytest.raises(ValueError) as je:
            jstream.ShardStream(d, batch_size=BATCH, **bad)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("skip", [0, 1, 5, 11])
def test_skip_batches_matches_jax(shards, skip):
    kw = {"batch_size": BATCH, "num_buckets": 1 << 20, "readers": 2}
    t, j = _streams(shards["jax", "tsv"], **kw)
    with t, j:
        assert t.skip_batches(skip) == j.skip_batches(skip) == skip
        assert t.cursor() == j.cursor()
        _same_batches(t, j)
    t, j = _streams(shards["jax", "tsv"], **kw)
    with t, j:
        with pytest.raises(ValueError) as te:
            t.skip_batches(14)
        with pytest.raises(ValueError) as je:
            j.skip_batches(14)
        assert str(te.value) == str(je.value)
        with pytest.raises(ValueError):
            t.skip_batches(-1)


def test_stream_bad_rows_and_warning_match_jax(shards):
    got = {}
    for pkg, mod in (("port", tstream), ("jax", jstream)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            s = mod.ShardStream(shards["jax", "bad"], batch_size=BATCH,
                                readers=1)
            with s:
                n = sum(1 for _ in s)
        got[pkg] = (n, s.bad_rows(), len([x for x in w
                                          if x.category is RuntimeWarning]))
    assert got["port"] == got["jax"]
    assert got["port"][1] == 80


def _torn_tfrecord(shards, tmp_path, how):
    src = shards["jax", "tfrecord"][0]
    raw = open(src, "rb").read()
    dst = str(tmp_path / "tf-part.00000")
    if how == "truncated":
        raw = raw[:len(raw) // 2]
    else:   # one data byte flipped in the third record
        (length,) = struct.unpack("<Q", raw[:8])
        off = 2 * (16 + length) + 12 + 3
        raw = raw[:off] + bytes([raw[off] ^ 0xFF]) + raw[off + 1:]
    open(dst, "wb").write(raw)
    return dst


@pytest.mark.parametrize("how", ["truncated", "crc"])
def test_damaged_tfrecord_fails_next_pop_without_hang(shards, tmp_path, how):
    """A dead reader fails the consumer's next pop with a RuntimeError,
    within a bound (run on a thread, joined with a 30 s limit)."""
    path = _torn_tfrecord(shards, tmp_path, how)
    for mod in (tstream, jstream):
        outcome = {}

        def drain():
            s = mod.ShardStream([path], batch_size=BATCH, fmt="tfrecord")
            try:
                for _ in s:
                    pass
                outcome["ok"] = True
            except RuntimeError as e:
                outcome["err"] = e
            finally:
                s.close()
        th = threading.Thread(target=drain, daemon=True)
        th.start()
        th.join(30.0)
        assert not th.is_alive(), "a dead reader hung the ring"
        assert "err" in outcome and "failed on" in str(outcome["err"])
        assert isinstance(outcome["err"].__cause__, IOError)
    with pytest.raises(IOError):
        list(ttfr.read_records(path))


def test_stall_is_exactly_zero_when_data_is_ready(shards):
    s = tstream.ShardStream(shards["jax", "tsv"], batch_size=BATCH,
                            readers=3, ring_batches=3, name="ready")
    with s:
        for _ in range(400):
            if s.memory_stats()["ring_batches"] == s.ring_batches:
                break
            threading.Event().wait(0.01)
        for _ in range(3):
            next(s)
        assert s.stall_stats().tolist() == [0.0, 0.0, 0.0]
        assert s.stall_summary()["p95_ms"] == 0.0
        stats = tobs.memory_stats()[f"ingest/{s.name}"]
        assert stats["batches_consumed"] == 3.0
    s.reset_stall_stats()
    assert s.stall_summary() == jstream.ShardStream(
        [shards["jax", "tsv"][0]], batch_size=BATCH).stall_summary()


# --- preprocess --------------------------------------------------------------

@pytest.mark.parametrize("opts", [{}, {"minmax": True}, {"repeat": 2},
                                  {"limit": 17}])
def test_preprocess_byte_identical(shards, tmp_path, opts):
    src = shards["jax", "bad"][0]
    out = {}
    for pkg, mod in (("port", tpre), ("jax", jpre)):
        p = str(tmp_path / f"{pkg}.csv")
        n = mod.preprocess(src, p, **opts)
        out[pkg] = (n, _sha(p))
    assert out["port"] == out["jax"]


def test_expand_and_cli_byte_identical(shards, tmp_path):
    csv = str(tmp_path / "p.csv")
    jpre.preprocess(shards["jax", "tsv"][0], csv)
    out = {}
    for pkg, mod in (("port", tpre), ("jax", jpre)):
        p = str(tmp_path / f"{pkg}-x.csv")
        assert mod.expand(csv, p, rows=1000, noise=0.4, seed=3) == 1000
        q = str(tmp_path / f"{pkg}-cli.csv")
        assert mod.main([shards["jax", "tsv"][1], q, "--repeat", "2",
                         "--minmax"]) == 0
        out[pkg] = (_sha(p), _sha(q))
    assert out["port"] == out["jax"]
    bad = str(tmp_path / "bad.csv")
    open(bad, "w").write("a,b\n1,2\n")
    for mod in (tpre, jpre):
        with pytest.raises(ValueError, match="not a preprocessed"):
            mod.expand(bad, str(tmp_path / "o.csv"), rows=2)


# --- EnvConfig ----------------------------------------------------------------

@pytest.mark.parametrize("config,env", [
    ({}, {}),
    ({"plan": {"readers": 3}, "serving": {"port": 0, "batch_rows": 64}},
     {}),
    ({}, {"OE_PLAN_READERS": "4", "OE_REPORT_EVALUATE_PERFORMANCE": "true",
          "OE_OFFLOAD_PERSIST_COMPRESS": "zlib", "HOME": "/x"}),
    ({"exchange": {"precision": "bf16", "push_precision": "int8_ef"},
      "a2a": {"slack": "1.5"}}, {"OE_A2A_CAPACITY": "128"}),
])
def test_envconfig_load_matches_jax(config, env):
    t = tenv.EnvConfig.load(config, env=env)
    j = jenv.EnvConfig.load(config, env=env)
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("config", [
    {"nope": {}}, {"plan": {"nope": 1}}, {"plan": 3},
    {"plan": {"readers": -1}}, {"plan": {"rows_floor": 64,
                                         "rows_ceiling": 8}},
    {"exchange": {"precision": "fp8"}}, {"serving": {"port": 70000}},
    {"serving": {"message_compress": "lz4"}},
    {"offload": {"persist_compress": "zstd"}},
    {"chaos": {"plan": "{not json"}},
])
def test_envconfig_refusals_match_jax(config):
    with pytest.raises(ValueError) as te:
        tenv.EnvConfig.load(config, env={})
    with pytest.raises(ValueError) as je:
        jenv.EnvConfig.load(config, env={})
    assert str(te.value) == str(je.value)


def test_stream_default_readers_from_envconfig(shards, monkeypatch):
    monkeypatch.setenv("OE_PLAN_READERS", "3")
    t, j = _streams(shards["jax", "tsv"], batch_size=BATCH)
    with t, j:
        assert t.readers == j.readers == 3
    monkeypatch.delenv("OE_PLAN_READERS")
    t = tstream.ShardStream(shards["jax", "tsv"], batch_size=BATCH)
    with t:
        assert t.readers == tstream.DEFAULT_READERS == 2


def test_tfrecord_and_tsv_streams_agree_where_jax_agrees(shards):
    """Shards of one seed read as TSV and as TFRecord: labels and dense
    features equal, categorical ids not (the TSV reader adds 1 before
    hashing, the TFRecord reader does not), in JAX's streams and in the
    port's alike: what the chip run's hash twin gates on."""
    for mod, pkg in ((jstream, "jax"), (tstream, "port")):
        with mod.ShardStream(shards[pkg, "tsv"], batch_size=BATCH,
                             num_buckets=1 << 22) as a, \
                mod.ShardStream(shards[pkg, "tfrecord"], batch_size=BATCH,
                                fmt="tfrecord", num_buckets=1 << 22) as b:
            pairs = list(zip(a, b))
        assert len(pairs) == 13      # 2 readers: 600 and 300 rows
        for x, y in pairs:
            _same_array(x["label"], y["label"])
            _same_array(x["dense"], y["dense"])
            assert not any(np.array_equal(x["sparse"][n], y["sparse"][n])
                           for n in x["sparse"])
