"""Torch port, the pinned fuzz corpus through the port's readers.

Each entry of ``tests/fixtures/fuzz_corpus.py`` is built by the JAX
package's ``fuzz.build_corpus_dir`` (a trained seed checkpoint with a
two-delta chain, then one known-bad mutation) and probed by the port's
full loader (``checkpoint.load_checkpoint``) and delta reader
(``checkpoint_delta.read_deltas_since``). The port's outcome must be
JAX's on the same directory (``fuzz.probe_python_full`` /
``probe_python_delta``): a load to the same version with the same probe
rows (or the same delta payloads), or a refusal with a typed error. The
refusal's message is not compared.
"""

import hashlib
import importlib.util
import os
import threading

import numpy as np
import pytest

from openembedding_tpu.analysis import fuzz
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import checkpoint_delta as tcd
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "fuzz_corpus.py")
DEADLINE_S = 60.0


def _load_fixture():
    spec = importlib.util.spec_from_file_location("fuzz_corpus_fixture",
                                                  FIXTURE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CORPUS_NAMES = [e["name"] for e in _load_fixture().iter_corpus()]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    return fuzz.SeedContext(str(tmp_path_factory.mktemp("graftfuzz")))


def _port_collection(ctx):
    """The port's twin of the seed context's loader collection."""
    return EmbeddingCollection(
        [EmbeddingSpec(name="arr", input_dim=ctx.vocab, output_dim=ctx.dim),
         EmbeddingSpec(name="hsh", input_dim=-1, output_dim=ctx.dim,
                       hash_capacity=256)],
        device="cpu", default_optimizer={"category": "adagrad",
                                         "learning_rate": 0.1})


def _bounded(fn):
    """``fn()`` on a thread joined within the deadline: ``("ok", value)``,
    ``("raise", exception)`` or ``("hang", None)``."""
    out = {}

    def run():
        try:
            out["ok"] = fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            out["raise"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(DEADLINE_S)
    if th.is_alive():
        return "hang", None
    return ("ok", out["ok"]) if "ok" in out else ("raise", out["raise"])


def _outcome(status, value, loaded):
    if status == "hang":
        return {"outcome": "hang"}
    if status == "raise":
        if isinstance(value, fuzz.PY_REFUSALS):
            return {"outcome": "refuse",
                    "error": f"{type(value).__name__}: {value}"}
        return {"outcome": "crash",
                "error": f"untyped {type(value).__name__}: {value}"}
    return loaded(value)


def _port_full(ctx, d):
    coll = _port_collection(ctx)

    def go():
        info = {}
        states = tck.load_checkpoint(d, coll, info=info)
        return states, info

    def loaded(value):
        states, info = value
        h = hashlib.sha256()
        ids = np.asarray(ctx.arr_ids, np.int64)
        gt = np.where((ids < 0) | (ids >= ctx.vocab), -1, ids)
        for name, q in (("arr", gt.astype(np.int32)),
                        ("hsh", np.asarray(ctx.hsh_keys, np.int64)
                         .astype(np.int32))):
            rows = coll.pull(states, {name: q}, read_only=True)[name]
            h.update(np.asarray(interop.tensor_to_numpy(rows),
                                np.float32).tobytes())
        return {"outcome": "load",
                "version": int(info.get("applied_seq", 0)),
                "digest": h.hexdigest()}
    return _outcome(*_bounded(go), loaded)


def _port_delta(d):
    def loaded(deltas):
        h = hashlib.sha256()
        for dl in deltas:
            h.update(str(int(dl.seq)).encode())
            for name in sorted(dl.vars):
                for field in sorted(dl.vars[name]):
                    h.update(field.encode())
                    h.update(np.asarray(dl.vars[name][field]).tobytes())
        return {"outcome": "load", "deltas": len(deltas),
                "seqs": [int(dl.seq) for dl in deltas],
                "digest": h.hexdigest()}
    return _outcome(*_bounded(lambda: tcd.read_deltas_since(d, 0)), loaded)


def _same_disposition(got, want):
    assert got["outcome"] == want["outcome"], (got, want)
    for key in ("version", "deltas", "seqs", "digest"):
        assert got.get(key) == want.get(key), (key, got, want)


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_corpus_disposition_through_port_readers(ctx, tmp_path, name):
    d = fuzz.build_corpus_dir(name, ctx, str(tmp_path))
    want_full = fuzz.probe_python_full(ctx, d)
    want_delta = fuzz.probe_python_delta(ctx, d)
    assert want_full["outcome"] in ("load", "refuse")
    assert want_delta["outcome"] in ("load", "refuse")
    _same_disposition(_port_full(ctx, d), want_full)
    _same_disposition(_port_delta(d), want_delta)


def test_clean_seed_loads_alike(ctx):
    """The unmutated seed: both loaders at version 2 with equal rows."""
    want = fuzz.probe_python_full(ctx, ctx.seed_dir)
    assert want["outcome"] == "load" and want["version"] == 2
    _same_disposition(_port_full(ctx, ctx.seed_dir), want)
    _same_disposition(_port_delta(ctx.seed_dir),
                      fuzz.probe_python_delta(ctx, ctx.seed_dir))
