"""Torch port, ``Trainer.fit`` fed from shard files against JAX's.

A 5-step port ``fit`` over a port ``ShardStream`` and JAX's ``fit`` over
JAX's stream of the same shards, from the same initial state (nothing
copied: ``Trainer.init(prng_key(0), batch)`` holds JAX's), agree in their
losses at rtol 1e-5 and in the number of ``ingest_stall`` records; so do
a plain list of batches and a stream behind a wrapper that hides its
``ingest_accounted`` mark. A fit killed by the chaos plan at
``trainer.fit.step`` and resumed with ``fit(resume_from=)`` on a fresh
stream skips the stream with ``skip_batches`` and ends bit for bit where
the uninterrupted streamed fit ends.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import optax

import openembedding_tpu as oe
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu.data import stream as jstream
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.utils import observability as jobs
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.analysis import chaos
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.data import stream as tstream
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim.initializers import prng_key
from openembedding_tpu_torch.utils import observability as tobs

VOCAB, DIM, BATCH, UNITS = 64, 4, 32, (16, 8)
ROWS = 96                 # 2 shards, 2 readers: 3 batches each, 6 in all
OPT = {"category": "adagrad", "learning_rate": 0.05}


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fit-shards"))
    tstream.write_synthetic_shards(d, num_shards=2, rows_per_shard=ROWS,
                                   fmt="tsv", seed=3)
    return d


def _port_trainer(track=False):
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                     optimizer=OPT)
    coll = EmbeddingCollection(specs, device="cpu")
    if track:
        coll.enable_dirty_tracking(target_chunks=8)
    losses = []

    class Recording(tr.Trainer):
        def train_step(self, state, batch):
            state, m = super().train_step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES,
                            embedding_dim=DIM, num_dense=criteo.NUM_DENSE,
                            dnn_units=UNITS)
    return Recording(module, coll, dense.adagrad(0.01)), mapper, losses


def _jax_trainer(devices8):
    specs, mapper = jax_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                    optimizer=OPT)
    losses = []

    class Recording(JaxTrainer):
        def train_step(self, state, batch, **kw):
            state, m = super().train_step(state, batch, **kw)
            losses.append(float(m["loss"]))
            return state, m
    trainer = Recording(
        jax_models.build_model("deepfm", criteo.SPARSE_NAMES,
                               dnn_units=UNITS),
        oe.EmbeddingCollection(specs, create_mesh(1, 1, devices8[:1])),
        optax.adagrad(0.01))
    return trainer, mapper, losses


def _port_stream(shard_dir, mapper, **kw):
    return tstream.ShardStream(shard_dir, batch_size=BATCH,
                               num_buckets=VOCAB, readers=2,
                               transform=mapper.fuse_batch, **kw)


def _fingerprint(state):
    out = [state.step.clone()]
    out += [v.clone() for _, v in sorted(state.params.items())]
    out += [v.clone() for _, v in sorted(state.opt_state.items())]
    for name in sorted(state.emb):
        st = state.emb[name]
        out += [st.weights.clone()] + [v.clone() for _, v in
                                       sorted(st.slots.items())]
    return out


def _assert_identical(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i}"


@pytest.mark.parametrize("source", ["stream", "list", "wrapped"])
def test_streamed_fit_matches_jax(devices8, shard_dir, source):
    """5 steps from the same initial state: losses at rtol 1e-5 and as
    many ``ingest_stall`` records as JAX's fit makes (the stream's own
    pops for a stream, one a step for a list); behind a wrapper, no pop
    counted twice."""
    trainer, mapper, losses = _port_trainer()
    jtrainer, jmapper, jlosses = _jax_trainer(devices8)
    first = next(_port_stream(shard_dir, mapper))
    jfirst = next(jstream.ShardStream(
        shard_dir, batch_size=BATCH, num_buckets=VOCAB, readers=2,
        transform=jmapper.fuse_batch))
    state = trainer.init(prng_key(0), first)
    jstate = jtrainer.init(jax.random.PRNGKey(0), jtrainer.shard_batch(jfirst))

    def src(pkg):
        if pkg == "port":
            s = _port_stream(shard_dir, mapper)
        else:
            s = jstream.ShardStream(shard_dir, batch_size=BATCH,
                                    num_buckets=VOCAB, readers=2,
                                    transform=jmapper.fuse_batch)
        batches = list(itertools.islice(s, 5)) if source == "list" \
            else itertools.islice(s, 5) if source == "wrapped" else s
        return s, batches

    ts, tb = src("port")
    js, jb = src("jax")
    if source == "stream":
        ts.skip_batches(1)
        js.skip_batches(1)
    t0, j0 = tobs.ingest_stall_records(), jobs.ingest_stall_records()
    state, m = trainer.fit(state, tb)
    jstate, jm = jtrainer.fit(jstate, jb)
    t1, j1 = tobs.ingest_stall_records(), jobs.ingest_stall_records()
    ts.close()
    js.close()
    assert len(losses) == len(jlosses) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert int(state.step) == 5
    if source == "wrapped":
        # each pop is the stream's record, never the loop's too; the
        # exhausted wrapper's last fetch reaches no stream, so the loop
        # records it (JAX's 5-batch window fetches the five at once and
        # records its 5 empty refills: the window depth differs)
        assert t1 - t0 == ts.stall_summary()["pops"] + 1 == 6
        assert j1 - j0 == js.stall_summary()["pops"] + 5
    else:
        assert t1 - t0 == j1 - j0 == 5


def test_fit_counts_a_wait_once(shard_dir):
    """A list source records one stall a step (exactly 0.0 for a batch in
    memory is not required: its fetch costs a few microseconds); a
    stream records only its pops."""
    trainer, mapper, _ = _port_trainer()
    batches = list(_port_stream(shard_dir, mapper))
    state = trainer.init(prng_key(0), batches[0])
    n0 = tobs.ingest_stall_records()
    trainer.fit(state, batches)
    assert tobs.ingest_stall_records() - n0 == len(batches) == 6
    s = _port_stream(shard_dir, mapper)
    n0 = tobs.ingest_stall_records()
    trainer.fit(state, s)
    assert tobs.ingest_stall_records() - n0 == s.stall_summary()["pops"] \
        == 6
    assert tobs.ingest_stall_records() - n0 == s.cursor()


def test_kill_and_resume_from_the_stream(shard_dir, tmp_path):
    """Killed at step 5 with autosaves every 2 steps, resumed on a fresh
    stream: ``fit`` calls ``skip_batches(4)`` and consumes no batch by
    hand, and the state equals the uninterrupted streamed fit's bit for
    bit."""
    base, mapper, _ = _port_trainer(track=True)
    first = next(_port_stream(shard_dir, mapper))
    s0 = base.init(prng_key(0), first)
    s0, _ = base.fit(s0, _port_stream(shard_dir, mapper))
    want = _fingerprint(s0)

    ck = str(tmp_path / "auto")
    killed, _, _ = _port_trainer(track=True)
    s1 = killed.init(prng_key(0), first)
    plan = chaos.FaultPlan([chaos.FaultSpec(point="trainer.fit.step",
                                            action="kill_thread", hit=5)])
    with chaos.active_plan(plan):
        with pytest.raises(chaos.ChaosKill):
            killed.fit(s1, _port_stream(shard_dir, mapper),
                       autosave_every=2, autosave_dir=ck)
    assert plan.injected

    resumed, _, _ = _port_trainer(track=True)
    s2 = resumed.init(prng_key(0), first)
    stream = _port_stream(shard_dir, mapper)
    skips = []
    real_skip = stream.skip_batches

    def spy(n):
        skips.append((n, stream.cursor()))
        return real_skip(n)
    stream.skip_batches = spy
    s2, _ = resumed.fit(s2, stream, resume_from=ck)
    assert skips == [(4, 0)]
    assert stream.cursor() == 6 and int(s2.step) == 6
    _assert_identical(want, _fingerprint(s2))
    assert resumed.builds == 1
