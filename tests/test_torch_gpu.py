"""Torch port, the CUDA kernels against their plain versions on the card.

Every test here carries the ``gpu`` marker and skips without a card. The
file imports torch, numpy and the port only, never jax, so it runs on a
machine that has the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX's virtual devices.)
K1 and K2 copy rows and compare integers, so their comparisons are
exact; so are KI's uniform and constant draws, and its normal draws lie
within the bound that ``_ki_within`` states.
"""

import numpy as np
import pytest
import torch

from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.ops import gather as tg
from openembedding_tpu_torch.ops import probe_gather as tp
from openembedding_tpu_torch.optim.initializers import prng_key

EMPTY = -2**31


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.gpu
def test_gather_rows_kernel_matches_plain():
    """K1: the CUDA kernel against its plain version, exact, at dims 9 / 1
    / 64, f32 and bf16, int32 and int64 ids (wild ones too)."""
    _need_card()
    rng = np.random.RandomState(0)
    for dim, dtype in ((9, torch.float32), (1, torch.float32),
                       (64, torch.bfloat16)):
        table = torch.randn(1000, dim, device="cuda").to(dtype)
        for ids in (rng.randint(-5, 1005, 3001).astype(np.int32),
                    np.asarray([2**32 + 3, -(2**40), 999, 0, 1000],
                               np.int64)):
            t_ids = torch.from_numpy(ids).cuda()
            before = tg.gather_rows.launches
            got = tg.gather_rows(table, t_ids)
            torch.cuda.synchronize()
            assert tg.gather_rows.launches == before + 1
            assert torch.equal(got, tg.gather_rows_reference(table, t_ids))
    empty = tg.gather_rows(table, torch.zeros(0, dtype=torch.int64,
                                              device="cuda"))
    assert empty.shape == (0, 64)


def _keys(rng, n, wide):
    if wide:
        k = rng.randint(-2**31, 2**31, (n, 2), dtype=np.int64)
        return np.unique(k.astype(np.int32), axis=0)
    return np.unique(rng.randint(-2**31 + 1, 2**31, n, dtype=np.int64)
                     .astype(np.int32))


@pytest.mark.gpu
def test_probe_gather_kernel_matches_plain():
    """K2: the CUDA kernel against its plain version, exact, on narrow and
    wide keys, dims 1 / 9 / 128, f32 and bf16, a one-bucket table and an
    odd span, hits, misses and EMPTY queries, one launch per call and
    none for n = 0."""
    _need_card()
    rng = np.random.RandomState(0)
    for capacity in (64, 128 * 37):
        for wide in (False, True):
            keys = _keys(rng, capacity // 2, wide)
            miss = _keys(rng, 40, wide)
            empty = np.full((3, 2) if wide else 3, EMPTY, np.int32)
            q = np.concatenate([keys, miss, empty])
            q = torch.from_numpy(q[rng.permutation(len(q))]).cuda()
            for dim, dtype in ((1, "float32"), (9, "float32"),
                               (128, "bfloat16")):
                st = th.create_hash_table(
                    EmbeddingVariableMeta(dtype, dim, 2**63), "default",
                    capacity=capacity,
                    key_dtype="wide" if wide else "int32", device="cuda")
                th.insert_rows(st, torch.from_numpy(keys).cuda(),
                               torch.randn(len(keys), dim, device="cuda"))
                assert int(st.insert_failures) == 0
                bsz, _nb, chain = th.table_layout(capacity,
                                                  th.DEFAULT_MAX_PROBES)
                kw = dict(chain=chain, bucket=bsz, empty=EMPTY)
                before = tp.probe_gather.launches
                rows, hit = tp.probe_gather(st.keys, st.weights, q, **kw)
                torch.cuda.synchronize()
                assert tp.probe_gather.launches == before + 1
                want_rows, want_hit = tp.probe_gather_reference(
                    st.keys, st.weights, q, **kw)
                assert torch.equal(rows, want_rows)
                assert torch.equal(hit, want_hit)
                assert int(hit.sum()) == len(keys)
                rows, hit = tp.probe_gather(st.keys, st.weights, q[:0], **kw)
                assert rows.shape == (0, dim) and hit.shape == (0,)
                assert tp.probe_gather.launches == before + 1


@pytest.mark.gpu
def test_gather_rows_kernel_boundaries():
    """K1 where its design has edges: n = 1, 2, 3 (mod 4) (the ragged end
    after the 4-row sets), dims 1 and 9 (compile-time widths) and 64, 128,
    300 (the runtime-width kernel), an invalid id at every position of a
    4-id vector, ids that are not 16-byte aligned, a table that is not
    16-byte aligned, and n = 1,000,003."""
    _need_card()
    rng = np.random.RandomState(1)
    vocab = 5000
    for dim, dtype in ((1, torch.float32), (9, torch.float32),
                       (9, torch.bfloat16), (64, torch.bfloat16),
                       (128, torch.float32), (300, torch.float32)):
        table = torch.randn(vocab, dim, device="cuda").to(dtype)
        for n in (1, 2, 3, 4, 5, 4097, 4098, 4099):
            ids = torch.from_numpy(rng.randint(0, vocab, n).astype(
                np.int32)).cuda()
            assert torch.equal(tg.gather_rows(table, ids),
                               tg.gather_rows_reference(table, ids))
        for bad in (-1, vocab, 2**32 + 3, -(2**40)):
            for pos in range(4):
                ids = rng.randint(0, vocab, 16).astype(np.int64)
                ids[4 + pos] = bad
                variants = [torch.from_numpy(ids).cuda()]
                if -2**31 <= bad < 2**31:
                    variants.append(variants[0].to(torch.int32))
                for t_ids in variants:
                    assert torch.equal(tg.gather_rows(table, t_ids),
                                       tg.gather_rows_reference(table, t_ids))
        ids = torch.from_numpy(rng.randint(-3, vocab + 3, 4099).astype(
            np.int32)).cuda()
        assert ids[1:].data_ptr() % 16 == 4           # unaligned id vectors
        assert torch.equal(tg.gather_rows(table, ids[1:]),
                           tg.gather_rows_reference(table, ids[1:]))
        shifted = torch.empty(vocab * dim + 1, dtype=dtype, device="cuda")
        view = shifted[1:].view(vocab, dim)
        view.copy_(table)
        assert torch.equal(tg.gather_rows(view, ids),
                           tg.gather_rows_reference(view, ids))
    table = torch.randn(1 << 20, 9, device="cuda")
    ids = torch.from_numpy(rng.randint(0, 1 << 20, 1_000_003).astype(
        np.int32)).cuda()
    assert torch.equal(tg.gather_rows(table, ids),
                       tg.gather_rows_reference(table, ids))
    assert torch.equal(tg.gather_rows(table, ids.long()),
                       tg.gather_rows_reference(table, ids.long()))
    torch.cuda.synchronize()


def _crafted(wide, capacity, rng):
    """Keys of a table whose window at bucket 5 and whose last window (the
    span's last start, ending at the table's end) each hold 256 keys that
    start there, with 8 more that failed: both windows are full, keys
    overflowed into their second bucket, and a miss scans a window with
    no EMPTY slot. Returns the inserted keys and keys that start in those
    windows but are absent."""
    bsz, nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    span = nb - chain + 1
    cand = _keys(rng, span * 1200, wide)
    cand = cand[(cand[:, 1] if wide else cand) != EMPTY]
    start = th.probe_starts(torch.from_numpy(cand), capacity,
                            th.DEFAULT_MAX_PROBES).numpy() // bsz
    placed, absent = [], []
    for b in (5, span - 1):
        mine = cand[start == b]
        assert len(mine) >= 300
        placed.append(mine[:chain * bsz + 8])
        absent.append(mine[chain * bsz + 8:300])
    return np.concatenate(placed), np.concatenate(absent)


@pytest.mark.gpu
def test_probe_gather_kernel_boundaries():
    """K2 where its design has edges: matches at window slots 31, 32 and 33
    (the end and start of a 32-pair step), keys that overflowed into the
    second bucket of their window, misses in full windows (no EMPTY slot
    to stop at) at bucket 5 and at the table's end, n = 300,001 (the
    one-wave grid strides several times), keys and weights that are not
    16-byte aligned, narrow and wide keys, f32 dims 1 / 9 / 128 and bf16
    dim 9, all exact against the plain version."""
    _need_card()
    rng = np.random.RandomState(2)
    capacity = 1 << 14
    bsz, _nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    kw = dict(chain=chain, bucket=bsz, empty=EMPTY)
    for wide in (False, True):
        placed, absent = _crafted(wide, capacity, rng)
        empty = np.full((4, 2) if wide else 4, EMPTY, np.int32)
        for dim, dtype in ((1, "float32"), (9, "float32"), (9, "bfloat16"),
                           (128, "float32")):
            st = th.create_hash_table(
                EmbeddingVariableMeta(dtype, dim, 2**63), "default",
                capacity=capacity, key_dtype="wide" if wide else "int32",
                device="cuda")
            th.insert_rows(st, torch.from_numpy(placed).cuda(),
                           torch.randn(len(placed), dim, device="cuda"))
            assert int(st.insert_failures) == 16
            q = torch.from_numpy(np.concatenate([placed, absent, empty])).cuda()
            slot = th.find_rows(st.keys, q)
            offset = (slot - th.probe_starts(q, capacity,
                                             th.DEFAULT_MAX_PROBES))[slot >= 0]
            for at in (31, 32, 33, bsz, 2 * bsz - 1):
                assert bool((offset == at).any())
            big = torch.from_numpy(np.resize(
                q.cpu().numpy()[rng.permutation(len(q))],
                (300_001,) + tuple(q.shape[1:]))).cuda()
            keys_buf = torch.empty(st.keys.numel() + 4, dtype=torch.int32,
                                   device="cuda")
            off = 2 if wide else 1                  # 8 or 4 bytes past 16
            keys_view = keys_buf[off:off + st.keys.numel()].view(
                st.keys.shape)
            keys_view.copy_(st.keys)
            w_buf = torch.empty(st.weights.numel() + 1,
                                dtype=st.weights.dtype, device="cuda")
            w_view = w_buf[1:].view(st.weights.shape)
            w_view.copy_(st.weights)
            for keys, weights, query in ((st.keys, st.weights, q),
                                         (st.keys, st.weights, big),
                                         (keys_view, w_view, q)):
                assert keys.data_ptr() % 16 != 0 or keys is st.keys
                rows, hit = tp.probe_gather(keys, weights, query, **kw)
                want_rows, want_hit = tp.probe_gather_reference(
                    keys, weights, query, **kw)
                torch.cuda.synchronize()
                assert torch.equal(rows, want_rows)
                assert torch.equal(hit, want_hit)
                assert torch.equal(hit, th.find_rows(keys, query) >= 0)


def _tiny_trainer(device):
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    specs, mapper = make_fused_specs(
        criteo.SPARSE_NAMES, 1000, 9,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=9,
                            dnn_units=(64, 32))
    return tr.Trainer(module, EmbeddingCollection(specs, device=device),
                      dense.adagrad(0.01)), mapper


def _close(a, b):
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                               rtol=1e-4, atol=1e-5)


def _close_change(a, b, start):
    """Each row's change on the card within 1e-3 of the CPU's largest
    change in that row, plus 2 float32 units at each value's size: a push
    that skips a cold row, moved by 1e-7 from ~1e-4, fails."""
    a, b, start = (t.cpu().double().reshape(len(t), -1)
                   for t in (a, b, start))
    size = torch.maximum(torch.maximum(a.abs(), b.abs()), start.abs())
    limit = (1e-3 * (b - start).abs().amax(1, keepdim=True)
             + 2 * torch.finfo(torch.float32).eps * size)
    assert bool(((a - b).abs() <= limit).all())


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu_without_host_sync():
    """A small fused DeepFM trainer takes 3 steps on the card and 3 on the
    CPU from the same state: losses within rtol 1e-4, tables, slots,
    dense parameters and accumulators within atol 1e-5 + rtol 1e-4 (the
    card's scatter-adds sum in any order), and each table row's change
    within rtol 1e-3 of the CPU's; two K1 launches a step; and no
    step reads anything back to the host (sync debug mode "error"). The
    steps are eager (``train_step_eager``): a step that synchronized
    could not be captured."""
    _need_card()
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    gpu, mapper = _tiny_trainer("cuda")
    cpu, _ = _tiny_trainer("cpu")
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        512, num_buckets=1000, seed=0, num_batches=4)]
    gstate = gpu.init(prng_key(0), batches[0])
    gstate, _ = gpu.train_step_eager(gstate, batches[3])   # warm: K1
    torch.cuda.synchronize()
    cstate = tr.copy_state(gstate, "cpu")
    initial = tr.copy_state(gstate, "cpu")
    losses = []
    before = tg.gather_rows.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[:3]:
            gstate, m = gpu.train_step_eager(gstate, b)
            losses.append(m["loss"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tg.gather_rows.launches == before + 6
    for i, b in enumerate(batches[:3]):
        cstate, m = cpu.train_step(cstate, b)
        np.testing.assert_allclose(float(losses[i]), float(m["loss"]),
                                   rtol=1e-4)

    for n in gstate.emb:
        for g, c, i in [(gstate.emb[n].weights, cstate.emb[n].weights,
                         initial.emb[n].weights),
                        (gstate.emb[n].slots["accum"],
                         cstate.emb[n].slots["accum"],
                         initial.emb[n].slots["accum"])]:
            _close(g, c)
            _close_change(g, c, i)
    for k in gstate.params:
        _close(gstate.params[k], cstate.params[k])
        _close(gstate.opt_state[k], cstate.opt_state[k])
    assert int(gstate.step) == int(cstate.step) == 4


def _ki_within(got, want, kind, stddev):
    """KI against its plain version: exact for uniform and constant; for
    normal draws (erf_inv on the card's log1pf) within
    ``2^-21 * (|want| + stddev)``, plus one bfloat16 unit in bfloat16."""
    from openembedding_tpu_torch.optim import initializers as ti
    if kind in (ti.UNIFORM, ti.CONSTANT):
        return torch.equal(got, want)
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    bound = 2.0**-21 * (want.abs() + stddev)
    if bf16:
        bound = bound + 2.0**-7 * want.abs()
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.gpu
def test_init_rows_kernel_matches_plain():
    """KI: the CUDA kernel against its plain version on the card, for the
    four draws, float32 and bfloat16 rows, dims 9 and 1, pair and int32
    keys, rows skipped and not, EMPTY and negative keys, n = 1."""
    _need_card()
    from openembedding_tpu_torch.ops import init_rows as ki
    from openembedding_tpu_torch.optim import initializers as ti
    rng = np.random.RandomState(5)
    inits = [{"category": "uniform", "minval": -1e-3, "maxval": 1e-3},
             {"category": "constant", "value": 0.1},
             {"category": "normal", "stddev": 1e-4},
             {"category": "normal", "truncated": True, "stddev": 0.5,
              "mean": 0.1}]
    for n in (5000, 1):
        for wide in (True, False):
            keys = rng.randint(-2**31, 2**31, (n, 2) if wide else n,
                               dtype=np.int64).astype(np.int32)
            keys[0] = [5, EMPTY] if wide else EMPTY
            skip = torch.from_numpy(rng.rand(n) < 0.3).cuda()
            k = torch.from_numpy(keys).cuda()
            for dim in (9, 1):
                for dtype in (torch.float32, torch.bfloat16):
                    for cfg in inits:
                        init = ti.make_initializer(cfg)
                        kind, params = ti.keyed_params(init)
                        out = torch.full((n, dim), 3.0, dtype=dtype,
                                         device="cuda")
                        ref = out.clone()
                        before = ki.init_rows.launches
                        ki.init_rows(out, k, skip, (7, 2**32 - 1), init)
                        ki.init_rows_reference(ref, k, skip, (7, 2**32 - 1),
                                               kind, params)
                        torch.cuda.synchronize()
                        assert ki.init_rows.launches == before + 1
                        assert _ki_within(out, ref, kind,
                                          cfg.get("stddev", 1.0)), (cfg, n)
                        assert bool((out[skip] == 3.0).all())


@pytest.mark.gpu
def test_init_rows_kernel_warp_edges():
    """KI per key at its warp's edges: n around one warp (31, 32, 33) and
    not a multiple of a block, every row skipped, none skipped, one row
    filled a warp; dims 1 and 9 (their own instances) and 5 and 300 (the
    general one)."""
    _need_card()
    from openembedding_tpu_torch.ops import init_rows as ki
    from openembedding_tpu_torch.optim import initializers as ti
    rng = np.random.RandomState(6)
    inits = [{"category": "uniform", "minval": -1e-3, "maxval": 1e-3},
             {"category": "constant", "value": 0.1},
             {"category": "normal", "truncated": True, "stddev": 0.5}]
    for n in (31, 32, 33, 4099):
        keys = torch.from_numpy(rng.randint(-2**31, 2**31, (n, 2),
                                            dtype=np.int64)
                                .astype(np.int32)).cuda()
        lone = torch.ones(n, dtype=torch.bool, device="cuda")
        lone[::32] = False
        skips = [torch.ones(n, dtype=torch.bool, device="cuda"),
                 torch.zeros(n, dtype=torch.bool, device="cuda"), lone]
        for dim in (1, 9, 5, 300):
            for skip in skips:
                for cfg in inits:
                    init = ti.make_initializer(cfg)
                    kind, params = ti.keyed_params(init)
                    out = torch.full((n, dim), 3.0, device="cuda")
                    ref = out.clone()
                    ki.init_rows(out, keys, skip, (3, 4), init)
                    ki.init_rows_reference(ref, keys, skip, (3, 4), kind,
                                           params)
                    torch.cuda.synchronize()
                    assert _ki_within(out, ref, kind,
                                      cfg.get("stddev", 1.0)), (n, dim, cfg)


@pytest.mark.gpu
def test_init_flat_kernel_matches_plain():
    """KI's array mode against its plain version: the four draws, float32
    and bfloat16, counts that are and are not multiples of 4, an array
    that is not 16-byte aligned (scalar stores), counters that cross
    2^32 and end at ``fields``' last element; one launch a call."""
    _need_card()
    from openembedding_tpu_torch.ops import init_rows as ki
    from openembedding_tpu_torch.optim import initializers as ti
    inits = [{"category": "uniform", "minval": -1e-3, "maxval": 1e-3},
             {"category": "constant", "value": 0.1},
             {"category": "normal", "stddev": 1e-4},
             {"category": "normal", "truncated": True, "stddev": 0.5,
              "mean": 0.1}]
    for count, offset in ((1, 0), (5, 0), (4097, 0), (36864, 0),
                          (4099, 2**32 - 7), (36864, 245_329_920)):
        for dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                for cfg in inits:
                    init = ti.make_initializer(cfg)
                    kind, params = ti.keyed_params(init)
                    buf = torch.zeros(count + 1, dtype=dtype, device="cuda")
                    out = buf[:count] if aligned else buf[1:]
                    before = ki.init_flat.launches
                    ki.init_flat(out, (9, 2**31 + 1), offset, init)
                    want = ti.flat_rows(kind, params, (9, 2**31 + 1),
                                        offset, count, dtype, "cuda")
                    torch.cuda.synchronize()
                    assert ki.init_flat.launches == before + 1
                    assert _ki_within(out, want, kind,
                                      cfg.get("stddev", 1.0)), \
                        (count, offset, dtype, aligned, cfg)


@pytest.mark.gpu
def test_trainer_init_same_on_card_and_cpu():
    """``Trainer.init(prng_key(0), batch)`` on the card and on the CPU
    hold the same state with nothing copied: dense parameters and array
    tables within the ``erf_inv`` bound (the ``:linear`` table and the
    slots exactly), and the hash tables' init keys."""
    _need_card()
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.optim import initializers as ti
    for build in (_tiny_trainer, _tiny_hash_trainer):
        gpu, mapper = build("cuda")
        cpu, _ = build("cpu")
        batch = mapper.fuse_batch(next(criteo.synthetic_criteo(
            64, num_buckets=1000, seed=0)))
        g = gpu.init(prng_key(0), batch)
        c = cpu.init(prng_key(0), batch)
        for k, v in c.params.items():
            stddev = (1.0 / v.shape[1]) ** 0.5 / 0.87962566103423978 \
                if v.dim() == 2 else 1.0
            kind = ti.TRUNCATED if v.dim() == 2 else ti.CONSTANT
            assert _ki_within(g.params[k].cpu(), v, kind, stddev), k
        for n, cs in c.emb.items():
            gs = g.emb[n]
            if hasattr(cs, "init_rng"):
                assert gs.init_rng == cs.init_rng
                continue
            init = gpu.collection.initializer(n)
            kind, _ = ti.keyed_params(init)
            assert _ki_within(gs.weights.cpu(), cs.weights, kind,
                              getattr(init, "stddev", 1.0)), n
            for s, v in cs.slots.items():
                assert torch.equal(gs.slots[s].cpu(), v)


def _tiny_hash_trainer(device, capacity=1 << 14):
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    specs, mapper = make_fused_specs(
        criteo.SPARSE_NAMES, -1, 9, hash_capacity=capacity,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=9,
                            dnn_units=(64, 32))
    return tr.Trainer(module, EmbeddingCollection(specs, device=device),
                      dense.adagrad(0.01)), mapper


@pytest.mark.gpu
def test_hash_train_step_on_card_matches_cpu_without_host_sync():
    """A small fused DeepFM over hash tables takes 3 steps on the card and
    3 on the CPU from the same state, every step inserting new keys: the
    keys arrays and failure counts bit-identical, losses within rtol
    1e-4, rows, slots and dense state within atol 1e-5 + rtol 1e-4, and
    each stored key's row and slots changed as on the CPU (from the key's
    init row when the steps inserted it, else from its row before them,
    within ``_close_change``'s limit); K2 launched twice a step and KI
    four times; no step reads the device back (sync debug mode
    "error"; eager steps, as the array test's)."""
    _need_card()
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.ops import init_rows as ki
    gpu, mapper = _tiny_hash_trainer("cuda")
    cpu, _ = _tiny_hash_trainer("cpu")
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        512, num_buckets=1 << 12, seed=0, num_batches=4)]
    gstate = gpu.init(prng_key(0), batches[0])
    gstate, _ = gpu.train_step_eager(gstate, batches[3])  # warm: kernels
    torch.cuda.synchronize()
    cstate = tr.copy_state(gstate, "cpu")
    initial = tr.copy_state(gstate, "cpu")
    losses = []
    k2, k_i = tp.probe_gather.launches, ki.init_rows.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[:3]:
            gstate, m = gpu.train_step_eager(gstate, b)
            losses.append(m["loss"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tp.probe_gather.launches == k2 + 6
    assert ki.init_rows.launches == k_i + 12
    for i, b in enumerate(batches[:3]):
        cstate, m = cpu.train_step(cstate, b)
        np.testing.assert_allclose(float(losses[i]), float(m["loss"]),
                                   rtol=1e-4)
    for n, g in gstate.emb.items():
        c, i = cstate.emb[n], initial.emb[n]
        assert torch.equal(g.keys.cpu(), c.keys)
        assert int(g.insert_failures) == int(c.insert_failures)
        assert g.num_used() > 4 * 512
        idx = torch.nonzero(c.live()).reshape(-1)
        new = ~i.live()[idx]
        assert int(new.sum()) > 512
        # a key keeps its slot, so a stored key's row before the steps is
        # its slot's row then, and an inserted key's is its init row
        start = i.weights[idx]
        start[new] = th.init_rows(gpu.collection.initializer(n), c.init_rng,
                                  c.keys[idx[new]], c.dim, c.weights.dtype)
        for a, b, s0 in ((g.weights, c.weights, start),
                         (g.slots["accum"], c.slots["accum"],
                          i.slots["accum"][idx])):
            _close(a, b)
            _close_change(a[idx.to(a.device)], b[idx], s0)
    for k in gstate.params:
        _close(gstate.params[k], cstate.params[k])


@pytest.mark.gpu
def test_kernels_captured_in_a_graph_match_eager():
    """K1, K2 and KI launched into one ``CountedGraph``: each replay equals
    eager calls on the same inputs exactly, a replay reads what its input
    buffers hold then, and each replay (not the capture) moves each
    launch counter by the kernel's launches in the graph."""
    _need_card()
    from openembedding_tpu_torch.ops import init_rows as ki
    from openembedding_tpu_torch.ops.launches import CountedGraph
    from openembedding_tpu_torch.optim import initializers as ti
    rng = np.random.RandomState(7)
    table = torch.randn(1000, 9, device="cuda")
    ids = torch.from_numpy(rng.randint(-5, 1005, 4099)
                           .astype(np.int32)).cuda()
    capacity = 128 * 37
    keys = torch.from_numpy(_keys(rng, capacity // 2, True)).cuda()
    st = th.create_hash_table(EmbeddingVariableMeta("float32", 9, 2**63),
                              "default", capacity=capacity,
                              key_dtype="wide", device="cuda")
    th.insert_rows(st, keys, torch.randn(len(keys), 9, device="cuda"))
    query = torch.cat([keys[:3000], torch.from_numpy(
        _keys(rng, 1099, True)).cuda()])
    bsz, _nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    init = ti.make_initializer({"category": "normal", "stddev": 1e-4})

    def step():
        rows = tg.gather_rows(table, ids)
        found, hit = tp.probe_gather(st.keys, st.weights, query,
                                     chain=chain, bucket=bsz, empty=EMPTY)
        ki.init_rows(found, query, hit, (3, 4), init)
        return rows, found, hit

    for _ in range(2):          # warm: every kernel's first launch
        step()
    torch.cuda.synchronize()
    counters = (tg.gather_rows, tp.probe_gather, ki.init_rows)
    before = [c.launches for c in counters]
    graph = CountedGraph()
    with graph.capture():
        out = step()
    assert [c.launches for c in counters] == before
    assert graph.tally == {c: 1 for c in counters}
    for replay in range(3):
        ids.copy_(torch.from_numpy(rng.randint(-5, 1005, 4099)
                                   .astype(np.int32)))
        query[:2000] = query[:2000].flip(0)
        graph.replay()
        want = step()
        torch.cuda.synchronize()
        for got, w in zip(out, want):
            assert torch.equal(got, w)
        assert [c.launches for c in counters] == [
            b + 2 * (replay + 1) for b in before]


def _counters():
    from openembedding_tpu_torch.ops import init_rows as ki
    return (tg.gather_rows, tp.probe_gather, ki.init_rows)


def _tensors(state):
    """Every tensor of a train state: step, dense state, and each table's
    weights and slots (a hash table's keys and failure count too)."""
    out = [state.step] + list(state.params.values()) \
        + list(state.opt_state.values())
    for s in state.emb.values():
        out += [s.weights] + list(s.slots.values())
        if isinstance(s, th.HashTableState):
            out += [s.keys, s.insert_failures]
    return out


def _run(state, batches, step):
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return torch.stack(losses), _tensors(state)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[1], b[1])) \
        and torch.equal(a[0], b[0])


def _captured_against_eager(trainer, state, batches):
    """The oracle of the captured step: from one state, copied, the
    captured steps (``train_step``) against the eager ones. Two eager runs
    go first; if they differ (the push's float scatter-adds use atomics),
    both sides run under ``torch.use_deterministic_algorithms``. Returns
    whether the two sides agree bit for bit, whether the deterministic
    mode was needed, and each launch counter's moves over the captured
    steps."""
    import os
    from openembedding_tpu_torch import training as tr

    def copy():
        return tr.copy_state(state, state.step.device)
    first = _run(copy(), batches, trainer.train_step_eager)
    second = _run(copy(), batches, trainer.train_step_eager)
    deterministic = not _same(first, second)
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        before = {c: c.launches for c in _counters()}
        captured = _run(copy(), batches, trainer.train_step)
        launched = {c.__name__: c.launches - before[c] for c in _counters()}
        eager = _run(copy(), batches, trainer.train_step_eager)
    finally:
        torch.use_deterministic_algorithms(False)
    return _same(captured, eager), deterministic, launched


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["array", "hash"])
def test_captured_step_matches_eager(kind):
    """A small DeepFM trainer over array (or hash) tables: 4 captured
    steps from a state equal 4 eager steps from a copy of it, bit for bit
    (losses, dense state, tables, slots; hash keys and failure counts;
    under deterministic algorithms if two eager runs differ); the launch
    counters move by 2 K1 a step (array) or 2 K2 and 4 KI (hash), the
    replays included; a ``copy_state`` builds a new program, the same
    state none; a loss the caller holds stays as it was."""
    _need_card()
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    build = _tiny_trainer if kind == "array" else _tiny_hash_trainer
    gpu, mapper = build("cuda")
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        512, num_buckets=1000 if kind == "array" else 1 << 12, seed=0,
        num_batches=4)]
    state = gpu.init(prng_key(0), batches[0])
    same, _deterministic, launched = _captured_against_eager(gpu, state,
                                                             batches)
    assert same
    assert gpu.builds == 1
    assert launched == ({"gather_rows": 8, "probe_gather": 0,
                         "init_rows": 0} if kind == "array" else
                        {"gather_rows": 0, "probe_gather": 8,
                         "init_rows": 16})
    # the same state builds nothing; a copy builds its own program
    state, _ = gpu.train_step(state, batches[0])
    state, _ = gpu.train_step(state, batches[1])
    assert gpu.builds == 2
    other = tr.copy_state(state, "cuda")
    other, m = gpu.train_step(other, batches[1])
    assert gpu.builds == 3
    state, m2 = gpu.train_step(state, batches[1])
    assert gpu.builds == 3
    held = m2["loss"].clone()
    state, _ = gpu.train_step(state, batches[2])
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and torch.equal(m2["loss"], held)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["array", "hash"])
def test_armed_captured_step_times_its_stages(kind):
    """With the evaluate-performance gate on, a small DeepFM trainer's
    captured step program is armed: its replays record CUDA events
    between the stages, each stage's device time a replay is above zero,
    and a replay's ``pull``, ``dense`` and ``push`` add up to the span
    from its first event to its last (``push.find`` only over hash
    tables). Arming builds one program; turning the gate off replays the
    first."""
    _need_card()
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.utils import observability as obs
    build = _tiny_trainer if kind == "array" else _tiny_hash_trainer
    gpu, mapper = build("cuda")
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        512, num_buckets=1000 if kind == "array" else 1 << 12, seed=0,
        num_batches=4)]
    state = gpu.init(prng_key(0), batches[0])
    state, _ = gpu.train_step(state, batches[0])
    obs.reset_step_timings()
    obs.set_evaluate_performance(True)
    try:
        for b in batches:
            state, _ = gpu.train_step(state, b)
        assert gpu.builds == 2
        obs.step_timings()
        obs.reset_step_timings()
        state, _ = gpu.train_step(state, batches[0])
    finally:
        obs.set_evaluate_performance(False)
    device = obs.step_timings()["device"]
    want = {"pull", "dense", "push", "push.dedup", "push.update"} | (
        {"push.find"} if kind == "hash" else set())
    assert set(device) == want
    assert all(v["replays"] == 1 and v["seconds"] > 0.0
               for v in device.values())
    (armed,) = [p for p in gpu.programs.values() if p.armed]
    marks = armed.stages.marks
    span = marks[0][1].elapsed_time(marks[-1][1]) / 1e3
    total = sum(device[k]["seconds"] for k in ("pull", "dense", "push"))
    assert abs(total - span) <= 1e-5 + 1e-3 * span
    state, _ = gpu.train_step(state, batches[1])
    assert gpu.builds == 2
    assert obs.step_timings()["device"]["pull"]["replays"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["xdeepfm", "dcn"])
def test_xdeepfm_and_dcn_steps_on_card_match_cpu(model):
    """A small xDeepFM (CIN (8, 8)) or DCN (3 cross layers) over fused
    array tables: 3 captured card steps and 3 CPU steps from the same
    ``Trainer.init`` agree (losses rtol 1e-4, state atol 1e-5 + rtol
    1e-4); float32 matrix products stay in float32 (no TF32)."""
    _need_card()
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    assert not torch.backends.cuda.matmul.allow_tf32

    def build(device):
        specs, mapper = make_fused_specs(
            criteo.SPARSE_NAMES, 1000, 16,
            optimizer={"category": "adagrad", "learning_rate": 0.01})
        extra = {"cin_layer_sizes": (8, 8), "cin_split_half": False,
                 "cin_bias": False} if model == "xdeepfm" else {}
        module = tm.build_model(model, criteo.SPARSE_NAMES, embedding_dim=16,
                                dnn_units=(64, 32), **extra)
        return tr.Trainer(module, EmbeddingCollection(specs, device=device),
                          dense.adagrad(0.01)), mapper

    gpu, mapper = build("cuda")
    cpu, _ = build("cpu")
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        256, num_buckets=1000, seed=0, num_batches=3)]
    gstate = gpu.init(prng_key(0), batches[0])
    cstate = cpu.init(prng_key(0), batches[0])
    for b in batches:
        gstate, gm = gpu.train_step(gstate, b)
        cstate, cm = cpu.train_step(cstate, b)
        np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                                   rtol=1e-4)
    assert gpu.builds == 1
    for k in cstate.params:
        _close(gstate.params[k], cstate.params[k])
        _close(gstate.opt_state[k], cstate.opt_state[k])
    for n, cs in cstate.emb.items():
        _close(gstate.emb[n].weights, cs.weights)
        _close(gstate.emb[n].slots["accum"], cs.slots["accum"])


def _hybrid_trainer(device, hash_hist=False):
    """A small ``criteo_hist_hybrid``: 4 features with their own
    vocabularies and ``:linear`` twins, those of vocabulary <= 16 kept
    dense (``sparse_as_dense``), a pooled history (``hist`` mean,
    ``hist:linear`` sum; wide hash variables with ``hash_hist``), DeepFM,
    sparse Adagrad and dense Adam."""
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.hybrid import split_sparse_dense
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    opt = {"category": "adagrad", "learning_rate": 0.01}
    names = criteo.SPARSE_NAMES[:4]
    hist = {"input_dim": -1, "hash_capacity": 1 << 12} if hash_hist \
        else {"input_dim": 1000}
    specs = tuple(tm.make_feature_specs(names, [8, 400, 600, 16], 4,
                                        optimizer=opt)) + (
        EmbeddingSpec(name="hist", output_dim=4, optimizer=opt,
                      pooling="mean", **hist),
        EmbeddingSpec(name="hist:linear", output_dim=1, optimizer=opt,
                      pooling="sum", **hist))
    sparse, kept = split_sparse_dense(specs, 16)
    module = tm.build_model("deepfm", names + ("hist",), embedding_dim=4,
                            num_dense=criteo.NUM_DENSE, dnn_units=(32, 16))
    return tr.Trainer(module, EmbeddingCollection(sparse, device=device),
                      dense.adam(1e-3), sparse_as_dense=kept)


def _hybrid_batches(n, wide=False):
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.ragged import pad_ragged, pad_ragged_wide
    rng = np.random.RandomState(7)
    out = []
    for b in criteo.add_linear_columns(criteo.synthetic_criteo(
            256, num_buckets=1 << 12, seed=0, num_batches=n)):
        sparse = {}
        for name, v in zip(criteo.SPARSE_NAMES[:4], (8, 400, 600, 16)):
            sparse[name] = sparse[name + ":linear"] = \
                (b["sparse"][name] % v).astype(np.int32)
        seqs = [rng.randint(0, 1000, rng.randint(0, 9)) for _ in range(256)]
        h = pad_ragged_wide([s * (1 << 33) + s for s in seqs], 8) if wide \
            else pad_ragged(seqs, 8)
        sparse["hist"] = sparse["hist:linear"] = h
        out.append({**b, "sparse": sparse})
    return out


@pytest.mark.gpu
def test_hybrid_pooled_captured_step_and_eval_match_eager():
    """The hybrid with a pooled history on the card: 4 captured steps
    equal 4 eager ones bit for bit (under deterministic algorithms if two
    eager runs differ: the dense-kept tables' gradient is an
    ``index_add_``), K1 launched once a step per collection table (4
    tables and 2 pooled histories: 6), and 3 card steps agree with 3 CPU
    steps (losses rtol 1e-4, state atol 1e-5 + rtol 1e-4). The captured
    eval equals the eager eval bit for bit, builds once, and leaves the
    step's graph replaying as before."""
    _need_card()
    from openembedding_tpu_torch import training as tr
    gpu = _hybrid_trainer("cuda")
    batches = _hybrid_batches(4)
    state = gpu.init(prng_key(0), batches[0])
    same, _deterministic, launched = _captured_against_eager(gpu, state,
                                                             batches)
    assert same
    assert launched == {"gather_rows": 6 * 4, "probe_gather": 0,
                        "init_rows": 0}
    cpu = _hybrid_trainer("cpu")
    cstate = tr.copy_state(state, "cpu")
    for b in batches[:3]:
        state, gm = gpu.train_step(state, b)
        cstate, cm = cpu.train_step(cstate, b)
        np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                                   rtol=1e-4)
    for k in cstate.params:
        _close(state.params[k], cstate.params[k])
    for k in cstate.opt_state:
        _close(state.opt_state[k], cstate.opt_state[k])
    for n, cs in cstate.emb.items():
        _close(state.emb[n].weights, cs.weights)
    builds = gpu.builds
    scores = [gpu.eval_step(state, b) for b in batches]
    eager = [gpu.eval_step_eager(state, b) for b in batches]
    assert all(torch.equal(a, b) for a, b in zip(scores, eager))
    assert gpu.eval_builds == 1
    np.testing.assert_allclose(scores[0].cpu().numpy(),
                               cpu.eval_step(cstate, batches[0]).numpy(),
                               rtol=1e-5, atol=1e-7)
    # the step's graph replays as before the eval program was built
    copy = tr.copy_state(state, "cuda")
    state, m = gpu.train_step(state, batches[3])
    copy, me = gpu.train_step_eager(copy, batches[3])
    torch.cuda.synchronize()
    np.testing.assert_allclose(float(m["loss"]), float(me["loss"]),
                               rtol=1e-6)
    assert gpu.builds == builds


@pytest.mark.gpu
def test_pooled_wide_hash_push_inserts_no_empty_key():
    """A pooled wide-hash history padded with EMPTY pairs: 3 captured
    card steps and 3 CPU steps leave the same keys arrays, every stored
    key a real id of the batches (no EMPTY key inserted from padding),
    and K2 2 / KI 4 launches a step."""
    _need_card()
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.hash_table import join64
    gpu = _hybrid_trainer("cuda", hash_hist=True)
    cpu = _hybrid_trainer("cpu", hash_hist=True)
    batches = _hybrid_batches(3, wide=True)
    state = gpu.init(prng_key(0), batches[0])
    cstate = tr.copy_state(state, "cpu")
    before = {c: c.launches for c in _counters()}
    for b in batches:
        state, _ = gpu.train_step(state, b)
        cstate, _ = cpu.train_step(cstate, b)
    torch.cuda.synchronize()
    moved = {c.__name__: c.launches - before[c] for c in _counters()}
    assert moved["probe_gather"] == 2 * 3 and moved["init_rows"] == 4 * 3
    pairs = np.concatenate([b["sparse"]["hist"].reshape(-1, 2)
                            for b in batches])
    real = set(join64(pairs[pairs[:, 1] != EMPTY]).tolist())
    for name in ("hist", "hist:linear"):
        keys = state.emb[name].keys.cpu()
        assert torch.equal(keys, cstate.emb[name].keys)
        stored = keys[keys[:, 1] != EMPTY].numpy()
        assert set(join64(stored).tolist()) == real


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["array", "hash"])
def test_save_right_after_a_replay_holds_the_step(kind, tmp_path):
    """A delta save issued right after a captured step's replay (no
    synchronize in between) writes the rows that step wrote: the loaded
    base and chain equal the live state, and the eager state, bit for
    bit."""
    _need_card()
    import os
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    # a hash table at a low load: a load re-inserts every key, and at a
    # load near 1 a window can overflow where the trained table's did not
    gpu, mapper = _tiny_trainer("cuda") if kind == "array" \
        else _tiny_hash_trainer("cuda", capacity=1 << 17)
    gpu.collection.enable_dirty_tracking(target_chunks=64)
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        512, num_buckets=1000 if kind == "array" else 1 << 12, seed=2,
        num_batches=4)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        state = gpu.init(prng_key(0), batches[0])
        eager = tr.copy_state(state, "cuda")
        path = str(tmp_path / "ck")
        for i, b in enumerate(batches):
            state, _ = gpu.train_step(state, b)       # a replay from i = 1
            eager, _ = gpu.train_step_eager(eager, b)
            info = ck.save_checkpoint(path, gpu.collection, state.emb,
                                      mode="delta", step=i + 1)
            assert info["mode"] == ("full" if i == 0 else "delta")
        loaded = ck.load_checkpoint(path, gpu.collection)
    finally:
        torch.use_deterministic_algorithms(False)
    for name in state.emb:
        for got, live, other in ((loaded[name].weights,
                                  state.emb[name].weights,
                                  eager.emb[name].weights),
                                 (loaded[name].slots["accum"],
                                  state.emb[name].slots["accum"],
                                  eager.emb[name].slots["accum"])):
            assert torch.equal(got, live) and torch.equal(live, other)


@pytest.mark.gpu
def test_resume_after_a_replay_matches_uninterrupted(tmp_path):
    """``fit`` resumed from autosaves taken between replayed steps ends
    where the uninterrupted fit ends, bit for bit, with one program build
    each (``retrace_budget=0``)."""
    _need_card()
    import os
    from openembedding_tpu_torch.data import criteo
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def fresh():
            trainer, mapper = _tiny_trainer("cuda")
            trainer.collection.enable_dirty_tracking(target_chunks=64)
            return trainer, mapper
        t0, mapper = fresh()
        batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
            512, num_buckets=1000, seed=3, num_batches=6)]
        base, _ = t0.fit(t0.init(prng_key(0), batches[0]), batches,
                         retrace_budget=0)
        path = str(tmp_path / "auto")
        t1, _ = fresh()
        t1.fit(t1.init(prng_key(0), batches[0]), batches[:4],
               autosave_every=2, autosave_dir=path, retrace_budget=0)
        t2, _ = fresh()
        resumed, _ = t2.fit(t2.init(prng_key(0), batches[0]), batches,
                            resume_from=path, retrace_budget=0)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert t0.builds == t1.builds == t2.builds == 1
    for a, b in zip(_tensors(base), _tensors(resumed)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_streamed_fit_on_card_matches_in_memory(tmp_path):
    """``fit`` over a ``ShardStream`` of TSV shards on the card equals
    ``fit`` over the same batches held in memory, bit for bit (one
    program build each, K1 on every pull); the stream records one stall
    a pop and the loop none."""
    _need_card()
    import os
    from openembedding_tpu_torch.data import stream
    from openembedding_tpu_torch.utils import observability as obs
    stream.write_synthetic_shards(str(tmp_path), num_shards=2,
                                  rows_per_shard=1536, seed=4)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def run(source_of):
            trainer, mapper = _tiny_trainer("cuda")
            src = source_of(mapper)
            state = trainer.init(prng_key(0), stream.ShardStream(
                str(tmp_path), batch_size=512, num_buckets=1000,
                transform=mapper.fuse_batch).__next__())
            k1 = tg.gather_rows.launches
            records = obs.ingest_stall_records()
            state, _ = trainer.fit(state, src, retrace_budget=0)
            torch.cuda.synchronize()
            return (state, trainer.builds, tg.gather_rows.launches - k1,
                    obs.ingest_stall_records() - records, src)

        def streamed(mapper):
            return stream.ShardStream(str(tmp_path), batch_size=512,
                                      num_buckets=1000,
                                      transform=mapper.fuse_batch)
        got, builds, k1, records, src = run(streamed)
        want, wbuilds, _, _, _ = run(lambda m: list(streamed(m)))
    finally:
        torch.use_deterministic_algorithms(False)
    assert builds == wbuilds == 1
    assert int(got.step) == 6 and k1 == 2 * 6
    assert records == src.stall_summary()["pops"] == 6
    assert all(torch.equal(a, b) for a, b in zip(_tensors(got),
                                                 _tensors(want)))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["array", "hash"])
def test_compressed_reload_on_card(kind, tmp_path):
    """Tables trained on the card, saved compressed (``.npyz`` part
    files), reload on the card bit for bit and serve through the registry
    with K1 (array) or K2 (hash) once a lookup."""
    _need_card()
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    trainer, mapper = _tiny_trainer("cuda") if kind == "array" \
        else _tiny_hash_trainer("cuda", capacity=1 << 17)
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        512, num_buckets=1000 if kind == "array" else 1 << 12, seed=5,
        num_batches=3)]
    state = trainer.init(prng_key(0), batches[0])
    for b in batches:
        state, _ = trainer.train_step(state, b)
    path = str(tmp_path / "z")
    info = ck.save_checkpoint(path, trainer.collection, state.emb,
                              compress="zlib", model_sign="z")
    assert info["bytes"] > 0
    loaded = ck.load_checkpoint(path, EmbeddingCollection(
        list(trainer.collection.specs.values()), device="cuda"))
    for name, st in state.emb.items():
        if kind == "array":
            assert torch.equal(loaded[name].weights, st.weights)
            assert torch.equal(loaded[name].slots["accum"],
                               st.slots["accum"])
        else:
            assert loaded[name].num_used() == st.num_used()
    reg = ModelRegistry(device="cuda")
    sign = reg.create_model(path)
    kernel = tg.gather_rows if kind == "array" else tp.probe_gather
    ids = batches[-1]["sparse"]["fields"]
    for name in state.emb:
        before = kernel.launches
        got = reg.lookup(sign, name, ids)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = trainer.collection.pull(state.emb, {name: ids},
                                       read_only=True)[name]
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_captured_bucket_pulls_match_eager_across_a_swap(tmp_path):
    """The batched registry's bucket pulls replay captured graphs whose
    rows equal the eager lookup's bit for bit, for int32, int64 and pair
    ids at several bucket sizes; after ``apply_delta`` the graphs are
    captured anew on the new snapshot and serve the new version's rows;
    the replays count as K1 and K2 launches."""
    _need_card()
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                    EmbeddingSpec)
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    adagrad = {"category": "adagrad", "learning_rate": 0.1}
    coll = EmbeddingCollection(
        [EmbeddingSpec(name="arr", input_dim=5000, output_dim=9),
         EmbeddingSpec(name="w", input_dim=-1, output_dim=9,
                       hash_capacity=1 << 14, key_dtype="wide")],
        device="cuda", default_optimizer=adagrad)
    coll.enable_dirty_tracking(target_chunks=16)
    states = coll.init()
    rng = np.random.RandomState(3)

    def train(seed):
        r = np.random.RandomState(seed)
        idx = {"arr": r.randint(0, 5000, 512).astype(np.int32),
               "w": th.split64(r.randint(0, 1 << 40, 512))}
        rows = coll.pull(states, idx)
        coll.apply_gradients(states, idx, {k: torch.ones_like(v) * 0.3
                                           for k, v in rows.items()})
        return idx

    keys = train(0)["w"]
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0,
                       model_sign="cap-1")
    reg = ModelRegistry(device="cuda")
    reg.enable_batching(max_batch_rows=1024, max_wait_us=0)
    sign = reg.create_model(path)
    model = reg.find_model(sign)
    assert reg.warm_batch_programs() == 5 * 2 + 5 * 3
    assert model.graph_reading()["graphs"] == 5 * 2 + 5 * 2

    def check():
        for n in (1, 63, 64, 65, 700, 1024):
            for dt in (np.int32, np.int64):
                ids = rng.randint(-3, 5003, n).astype(dt)
                before = tg.gather_rows.launches
                got = reg.lookup(sign, "arr", ids)
                assert tg.gather_rows.launches == before + 1
                want = model.lookup("arr", ids).cpu().numpy()
                np.testing.assert_array_equal(got, want)
            pairs = np.ascontiguousarray(
                keys[rng.randint(0, len(keys), n)]).astype(np.int32)
            pairs[::7] = th.split64(rng.randint(1 << 41, 1 << 42, 1))
            before = tp.probe_gather.launches
            got = reg.lookup(sign, "w", pairs)
            assert tp.probe_gather.launches == before + 1
            np.testing.assert_array_equal(
                got, model.lookup("w", pairs).cpu().numpy())

    check()
    builds = model.graph_reading()["build_s"]
    keys = np.concatenate([keys, train(1)["w"]])
    delta = cd.save_delta(path, coll, states, step=1, return_payload=True,
                          compact_bytes_ratio=1e18,
                          background_compact=False)["delta"]
    assert reg.apply_delta(sign, delta)["applied"]
    probe = np.arange(0, 5000, 7, dtype=np.int32)[:1000]
    np.testing.assert_array_equal(
        reg.lookup(sign, "arr", probe),
        coll.pull(states, {"arr": probe}, read_only=True)["arr"]
        .cpu().numpy())
    assert model.graph_reading()["build_s"] != builds   # captured anew
    check()
    reg.close()


def _offload_trainer(device, cache, depth=4, vocab=20000):
    """LR over an offloaded ``off`` (dim 4) and ``off:linear``, adagrad,
    uniform init (KI draws the host store on the card), dense SGD."""
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.offload import ShardedOffloadedTable
    from openembedding_tpu_torch.optim import dense
    opt = {"category": "adagrad", "learning_rate": 0.1}
    init = {"category": "uniform", "minval": -0.05, "maxval": 0.05}
    tabs = {n: ShardedOffloadedTable(
        n, EmbeddingVariableMeta(embedding_dim=d, vocabulary_size=vocab),
        opt, init, vocab=vocab, cache_capacity=cache, device=device, seed=3)
        for n, d in (("off", 4), ("off:linear", 1))}
    coll = EmbeddingCollection(tuple(t.embedding_spec()
                                     for t in tabs.values()), device=device)
    trainer = tr.Trainer(tm.LogisticRegression(feature_names=("off",)),
                         coll, dense.sgd(0.1), offload=tabs,
                         pipeline_depth=depth)
    return trainer, tabs


def _offload_batches(n, vocab=20000, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lo = (i * 3000) % (vocab - 4000)
        # out-of-range ids too: the push inserts them with init rows
        # drawn from the cache's device-held key, the writeback drops them
        ids = np.concatenate([rng.randint(lo, lo + 4000, 500),
                              [-7, vocab + 11]]).astype(np.int32)
        out.append({"label": (ids % 2).astype(np.float32), "dense": None,
                    "sparse": {"off": ids, "off:linear": ids}})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [1 << 16, 1024])
def test_offload_steps_on_card_match_cpu(cache):
    """The offload lane on the card (host store drawn by KI, captured
    steps, packed inserts, async writeback; with a 1024-row cache
    evicting every few steps, the cache rebuilt in place under the step
    program) against the same lane on the CPU: losses rtol 1e-4, cache
    keys bit-identical, host stores within atol 1e-5 + rtol 1e-4; one
    step program; with the larger cache, no device read between join
    points (``set_sync_debug_mode("error")``)."""
    _need_card()
    from openembedding_tpu_torch import interop
    from openembedding_tpu_torch.optim.initializers import prng_key
    batches = _offload_batches(8)
    runs = {}
    for device in ("cuda", "cpu"):
        trainer, tabs = _offload_trainer(device, cache)
        state = trainer.init(prng_key(0), batches[0])
        state, _ = trainer.fit(state, batches[:2])
        losses_dev = []
        # an eviction is a join point (it reads the overflow counter):
        # only the cache that never evicts runs under the debug mode
        if device == "cuda" and cache > 1024:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i, b in enumerate(batches[2:]):
                trainer.prefetch(batches[2 + i:2 + i + 5])
                state, m = trainer.train_step(state, b)
                losses_dev.append(m["loss"])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        losses = [float(x) for x in losses_dev]
        for name, t in tabs.items():
            t.finish()
            t.flush(state.emb[name])
            t._join_writeback()
        runs[device] = (trainer, tabs, state, losses)
    (gt, gtabs, gs, gl), (_, ctabs, cs, cl) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    assert gt.builds == 1
    assert gtabs["off"].evictions == ctabs["off"].evictions
    if cache == 1024:
        assert gtabs["off"].evictions >= 2
    for name in gtabs:
        g = interop.hash_state_to_numpy(gs.emb[name])
        c = interop.hash_state_to_numpy(cs.emb[name])
        np.testing.assert_array_equal(g[0], c[0])
        np.testing.assert_array_equal(g[3], c[3])
        np.testing.assert_allclose(gtabs[name].host_weights,
                                   ctabs[name].host_weights,
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(gtabs[name].host_work_id,
                                      ctabs[name].host_work_id)


@pytest.mark.gpu
def test_init_rows_kernel_reads_a_device_key():
    """KI with its base key in a device tensor (an offload cache's) equals
    the plain version, and a captured launch follows the key rewritten in
    place."""
    _need_card()
    from openembedding_tpu_torch.ops import init_rows as ki
    from openembedding_tpu_torch.optim.initializers import make_initializer
    init = make_initializer({"category": "uniform", "minval": -1.0,
                             "maxval": 1.0})
    rng = np.random.RandomState(4)
    keys = torch.from_numpy(rng.randint(-2**31, 2**31, 3000,
                                        dtype=np.int64).astype(np.int32))
    skip = torch.from_numpy(rng.rand(3000) < 0.3)
    words = np.asarray(prng_key(17), np.uint32).view(np.int32)
    key = torch.from_numpy(words.copy()).cuda()
    out = torch.zeros(3000, 9, device="cuda")
    ki.init_rows(out, keys.cuda(), skip.cuda(), key, init)
    want = ki.init_rows(torch.zeros(3000, 9), keys, skip, prng_key(17),
                        init)
    assert torch.equal(out.cpu(), want)
    out2 = torch.zeros(3000, 9, device="cuda")
    k_dev, s_dev = keys.cuda(), skip.cuda()
    ki.init_rows(out2, k_dev, s_dev, key, init)      # warm outside
    from openembedding_tpu_torch.ops.launches import CountedGraph
    graph = CountedGraph()
    with graph.capture():
        ki.init_rows(out2, k_dev, s_dev, key, init)
    new = np.asarray(prng_key(99), np.uint32).view(np.int32)
    key[0].fill_(int(new[0]))
    key[1].fill_(int(new[1]))
    out2.zero_()
    graph.replay()
    want2 = ki.init_rows(torch.zeros(3000, 9), keys, skip, prng_key(99),
                         init)
    assert torch.equal(out2.cpu(), want2)


def _int64_keys(rng, n):
    """Distinct int64 keys over the whole range, among them keys whose hi
    word is INT32_MIN (a pair reading would take them for EMPTY slots)
    and keys that differ from another only above bit 32."""
    k = rng.randint(-2**62, 2**62, n, dtype=np.int64) * 2
    k[:8] = [-2**63 + 1, -2**63 + 5, ((-2**31) << 32) + 3,
             ((-2**31) << 32) + 7,
             1, (1 << 40) + 1, 2**63 - 1, 0]
    return np.unique(k)


@pytest.mark.gpu
def test_probe_gather_int64_mode_matches_plain():
    """K2's int64 key mode against its plain version, exact: hits, misses,
    INT64_MIN (EMPTY) queries, stored keys whose hi word is INT32_MIN,
    dims 1 / 9, a one-bucket table and an odd span; one launch a call."""
    _need_card()
    rng = np.random.RandomState(2)
    empty64 = -2**63
    for capacity in (64, 128 * 37):
        keys = _int64_keys(rng, capacity // 2)
        miss = _int64_keys(rng, 40)
        miss = miss[~np.isin(miss, keys)]
        q = np.concatenate([keys, miss, np.full(3, empty64, np.int64)])
        q = torch.from_numpy(q[rng.permutation(len(q))]).cuda()
        for dim in (1, 9):
            st = th.create_hash_table(
                EmbeddingVariableMeta("float32", dim, 2**63), "default",
                capacity=capacity, key_dtype="int64", device="cuda")
            th.insert_rows(st, torch.from_numpy(keys).cuda(),
                           torch.randn(len(keys), dim, device="cuda"))
            assert int(st.insert_failures) == 0
            bsz, _nb, chain = th.table_layout(capacity,
                                              th.DEFAULT_MAX_PROBES)
            kw = dict(chain=chain, bucket=bsz, empty=empty64)
            before = tp.probe_gather.launches
            rows, hit = tp.probe_gather(st.keys, st.weights, q, **kw)
            torch.cuda.synchronize()
            assert tp.probe_gather.launches == before + 1
            want_rows, want_hit = tp.probe_gather_reference(
                st.keys, st.weights, q, **kw)
            assert torch.equal(rows, want_rows)
            assert torch.equal(hit, want_hit)
            assert int(hit.sum()) == len(keys)


@pytest.mark.gpu
def test_init_rows_int64_keys_match_plain():
    """KI on int64 keys against its plain version: the low 32 bits fold
    (keys 2^40 + 1 and 1 draw one row), uniform exactly, normal within
    ``_ki_within``'s bound."""
    _need_card()
    from openembedding_tpu_torch.ops import init_rows as ki
    from openembedding_tpu_torch.optim import initializers as ti
    rng = np.random.RandomState(6)
    keys = _int64_keys(rng, 3000)
    keys[:2] = [1, (1 << 40) + 1]
    k = torch.from_numpy(keys).cuda()
    skip = torch.from_numpy(rng.rand(len(keys)) < 0.3).cuda()
    skip[:2] = False
    for cfg in ({"category": "uniform", "minval": -1e-3, "maxval": 1e-3},
                {"category": "normal", "stddev": 1e-4}):
        init = ti.make_initializer(cfg)
        kind, params = ti.keyed_params(init)
        out = torch.full((len(keys), 9), 3.0, device="cuda")
        ref = out.clone()
        ki.init_rows(out, k, skip, (7, 2**32 - 1), init)
        ki.init_rows_reference(ref, k, skip, (7, 2**32 - 1), kind, params)
        torch.cuda.synchronize()
        assert _ki_within(out, ref, kind, cfg.get("stddev", 1.0))
        assert torch.equal(out[0], out[1])
        assert bool((out[skip] == 3.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["array", "hash", "int64"])
def test_sharded_captured_step_matches_eager_and_cpu(kind):
    """A 2 x 2 ``a2a`` mesh on the card: the captured step equals the
    eager one bit for bit (under deterministic algorithms), and both the
    CPU's at rtol 1e-4, on a small DeepFM."""
    _need_card()
    import os
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    from openembedding_tpu_torch.training import Trainer, copy_state
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    kw = {"optimizer": {"category": "adagrad", "learning_rate": 0.05}}
    if kind != "array":
        kw.update(hash_capacity=4096,
                  key_dtype="int64" if kind == "int64" else "wide")
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES,
                                     -1 if kind != "array" else 512, 4, **kw)

    def trainer(device):
        return Trainer(deepctr.build_model("deepfm", criteo.SPARSE_NAMES,
                                           embedding_dim=4,
                                           dnn_units=(16, 8)),
                       EmbeddingCollection(specs, create_mesh(
                           2, 2, device=device)), dense.adagrad(0.01))
    raw = criteo.synthetic_criteo(256, num_buckets=512, seed=3,
                                  num_batches=4)
    batches = []
    for b in raw:
        if kind == "int64":
            b = {**b, "sparse": {k: v.astype(np.int64) + (1 << 40)
                                 for k, v in b["sparse"].items()}}
        batches.append(mapper.fuse_batch(b))
    t = trainer("cuda")
    from openembedding_tpu_torch.optim.initializers import prng_key
    s0 = t.init(prng_key(1), batches[0])
    cpu = trainer("cpu")
    cs = copy_state(s0, "cpu")
    torch.use_deterministic_algorithms(True)
    try:
        a, b = copy_state(s0, "cuda"), copy_state(s0, "cuda")
        for batch in batches:
            a, ma = t.train_step(a, batch)
            b, mb = t.train_step_eager(b, batch)
            cs, mc = cpu.train_step(cs, batch)
            assert torch.equal(ma["loss"], mb["loss"])
            np.testing.assert_allclose(float(ma["loss"]), float(mc["loss"]),
                                       rtol=1e-4)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    for name in a.emb:
        assert torch.equal(a.emb[name].weights, b.emb[name].weights)
        if kind != "array":
            assert torch.equal(a.emb[name].keys, b.emb[name].keys)
            assert torch.equal(a.emb[name].keys.cpu(), cs.emb[name].keys)
        np.testing.assert_allclose(a.emb[name].weights.cpu().numpy(),
                                   cs.emb[name].weights.numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert t.builds == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    ("array", "a2a+bf16"), ("array", "a2a+int8"), ("array", "a2a+pipelined"),
    ("array", "a2a+cache"), ("per_feature", "a2a+grouped"),
    ("per_feature", "a2a+grouped+pipelined"), ("hash", "a2a+int8"),
    ("hash", "a2a+cache")], ids=lambda c: "-".join(c))
def test_plane_captured_step_matches_eager_and_cpu(case):
    """Each later plane on a 2 x 2 mesh of the card, a small DeepFM with
    the lookahead given: captured steps equal eager ones bit for bit
    (under deterministic algorithms; replicas refreshed in place every 2
    steps, one program over the run), and the CPU's at rtol 1e-4; after
    each step an int8_ef residual equal to the CPU's or one int8 unit
    from it, in units of the CPU step's per-row scales (where the card's
    pre-reduce rounds a total across a boundary: ``chip_smoke``'s gate),
    then carried on from the card's."""
    _need_card()
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.parallel import hot_cache
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    from openembedding_tpu_torch.parallel.precision import EFState
    from openembedding_tpu_torch.training import Trainer, copy_state
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    layout, plane = case
    kw = {"optimizer": {"category": "adagrad", "learning_rate": 0.05},
          "plane": plane}
    if plane == "a2a+cache":
        kw.update(cache_k=64, cache_refresh_every=2)
    if layout == "hash":
        kw.update(hash_capacity=4096)
    if layout == "per_feature":
        specs = deepctr.make_feature_specs(criteo.SPARSE_NAMES, 128, 4,
                                           **kw)
        mapper = None
    else:
        specs, mapper = make_fused_specs(
            criteo.SPARSE_NAMES, -1 if layout == "hash" else 512, 4, **kw)

    def trainer(device):
        return Trainer(deepctr.build_model("deepfm", criteo.SPARSE_NAMES,
                                           embedding_dim=4,
                                           dnn_units=(16, 8)),
                       EmbeddingCollection(specs, create_mesh(
                           2, 2, device=device)), dense.adagrad(0.01))
    raw = list(criteo.synthetic_criteo(256, num_buckets=128, seed=3,
                                       num_batches=5))
    batches = [mapper.fuse_batch(b) for b in raw] if mapper else \
        list(criteo.add_linear_columns(raw))
    t, e, cpu = trainer("cuda"), trainer("cuda"), trainer("cpu")
    s0 = t.init(prng_key(1), batches[0])
    a, b, cs = copy_state(s0, "cuda"), copy_state(s0, "cuda"), \
        copy_state(s0, "cpu")
    torch.use_deterministic_algorithms(True)
    try:
        for i, batch in enumerate(batches):
            nxt = batches[i + 1] if i + 1 < len(batches) else None
            a, ma = t.train_step(a, batch, next_batch=nxt)
            b, mb = e.train_step_eager(b, batch, next_batch=nxt)
            with chip_smoke._EFScales() as kept:
                cs, mc = cpu.train_step(cs, batch, next_batch=nxt)
            assert torch.equal(ma["loss"], mb["loss"]), i
            np.testing.assert_allclose(float(ma["loss"]), float(mc["loss"]),
                                       rtol=1e-4)
            for name, st in a.emb.items():
                if isinstance(st, EFState):
                    want = cs.emb[name]
                    assert torch.equal(st.keys.cpu(), want.keys)
                    chip_smoke._resid_close(
                        f"step {i} {name}", st.resid, want.resid,
                        kept.scale_of(name, want.resid))
                    want.resid.copy_(st.resid.cpu())
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert t.builds == 1
    for name in a.emb:
        ta, tb = hot_cache.unwrap(a.emb[name]), hot_cache.unwrap(b.emb[name])
        assert torch.equal(ta.weights, tb.weights)
        np.testing.assert_allclose(
            ta.weights.cpu().numpy(),
            hot_cache.unwrap(cs.emb[name]).weights.numpy(), rtol=1e-4,
            atol=1e-6)
        if isinstance(a.emb[name], EFState):
            assert torch.equal(a.emb[name].resid, b.emb[name].resid)
        if isinstance(a.emb[name], hot_cache.CachedState):
            assert torch.equal(a.emb[name].cache.keys,
                               b.emb[name].cache.keys)
            assert torch.equal(a.emb[name].cache.keys.cpu(),
                               cs.emb[name].cache.keys)
            assert t._hot[name].refreshes >= 2
            assert bool((a.emb[name].cache.keys >= 0).any()) \
                or a.emb[name].cache.wide


@pytest.mark.gpu
def test_bf16_pull_on_card_equals_cpu():
    """The bf16 wire on the card: pulled rows equal the CPU's bit for bit
    and the bf16 rounding of the f32 plane's rows."""
    _need_card()
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.embedding import EmbeddingSpec
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1000, (512, 3))
    rows = {}
    for plane in ("a2a", "a2a+bf16"):
        for dev in ("cuda", "cpu"):
            c = EmbeddingCollection([EmbeddingSpec("t", 1000, 9,
                                                   plane=plane)],
                                    create_mesh(2, 2, device=dev))
            rows[plane, dev] = c.pull(c.init(prng_key(0)), {"t": ids})[
                "t"].cpu()
    assert torch.equal(rows["a2a+bf16", "cuda"], rows["a2a+bf16", "cpu"])
    assert torch.equal(rows["a2a+bf16", "cuda"],
                       rows["a2a", "cuda"].to(torch.bfloat16).float())


# --- K3: the find-or-insert kernels ------------------------------------------

K3_MODES = ("wide", "int32", "int64")
# (capacity, max_probes): one whole-table bucket; two buckets with chains
# of 1 and 2 (one window start for the latter); 512 buckets, chains 1, 2
K3_GEOMETRIES = ((64, 256), (256, 128), (256, 256), (1 << 16, 128),
                 (1 << 16, 256))


def _k3_pool(rng, n, mode):
    """Distinct keys, none EMPTY, in random order."""
    if mode == "int64":
        k = _int64_keys(rng, n)
    else:
        k = _keys(rng, n, mode == "wide")
        k = k[k[:, 1] != EMPTY] if mode == "wide" else k[k != EMPTY]
    return k[rng.permutation(len(k))]


def _k3_empty(mode, n):
    if mode == "int64":
        return np.full(n, -2**63, np.int64)
    return np.full((n, 2) if mode == "wide" else n, EMPTY, np.int32)


def _k3_table(mode, capacity, offset):
    """An empty keys array on the card; ``offset`` slots into a larger
    buffer, so that it starts off the 16-byte grid (the slot-by-slot
    path)."""
    dtype = torch.int64 if mode == "int64" else torch.int32
    shape = (capacity + offset, 2) if mode == "wide" else (capacity + offset,)
    buf = torch.full(shape, th.empty_key(dtype), dtype=dtype, device="cuda")
    return buf[offset:]


def _k3_batch(rng, keys, mode, invalid=0.05):
    """A batch of ``keys`` with EMPTY entries mixed in and some valid keys
    marked not valid; returns ``(keys, valid)`` on the card."""
    both = np.concatenate([keys, _k3_empty(mode, max(1, len(keys) // 20))])
    both = both[rng.permutation(len(both))]
    valid = ((both[:, 1] if mode == "wide" else both)
             != (-2**63 if mode == "int64" else EMPTY))
    valid &= rng.rand(len(both)) >= invalid
    return torch.from_numpy(both).cuda(), torch.from_numpy(valid).cuda()


def _k3_step(tk, rk, batch, valid, max_probes):
    """One K3 call on ``tk`` and one plain call on its twin ``rk``: every
    output and the keys arrays word for word, the launches and the key
    counters moved by this call. Returns the outputs."""
    from openembedding_tpu_torch.ops import find_or_insert as k3
    _b, _nb, chain = th.table_layout(tk.shape[0], max_probes)
    launched, counts = k3.find_or_insert.launches, k3.key_counts()
    out = th.find_or_insert(tk, batch, valid, max_probes)
    want = th.find_or_insert_reference(rk, batch, valid, max_probes)
    torch.cuda.synchronize()
    assert out[0] is tk
    assert torch.equal(tk, rk)
    for got, w in zip(out[1:], want[1:]):
        assert got.dtype == w.dtype and torch.equal(got, w)
    n = batch.shape[0]
    assert k3.find_or_insert.launches == launched + (3 + chain if n else 0)
    slot, inserted, failed = want[1:]
    moved = {k: v - counts[k] for k, v in k3.key_counts().items()}
    assert moved == {"found": int((valid & ~inserted & ~failed).sum()),
                     "inserted": int(inserted.sum()),
                     "failed": int(failed.sum())}
    return slot, inserted, failed


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("capacity,max_probes", K3_GEOMETRIES)
@pytest.mark.parametrize("mode", K3_MODES)
def test_find_or_insert_kernel_matches_plain(mode, capacity, max_probes,
                                             offset):
    """K3 against ``find_or_insert_reference`` on the card, slot for slot
    and the keys arrays word for word, call after call on one table: all
    keys missing, mixed, all found, a crowd of keys with one window start
    (ranked past 128 contenders, overflowing into the chain's next bucket,
    failing when the window is full), more keys than the table holds, EMPTY
    and invalid entries, n = 0; keys on and off the 16-byte grid."""
    _need_card()
    rng = np.random.RandomState(capacity + max_probes + len(mode) + offset)
    bsz, _nb, chain = th.table_layout(capacity, max_probes)
    pool = _k3_pool(rng, 4 * capacity + 4000, mode)
    start = th.probe_starts(torch.from_numpy(pool), capacity, max_probes)
    crowd = pool[(start == start[0]).numpy()][:300]
    assert len(crowd) > bsz
    tk = _k3_table(mode, capacity, offset)
    rk = tk.clone()
    quarter = capacity // 4
    fresh, more = pool[:quarter], pool[quarter:2 * quarter]
    batches = [fresh,                                     # all missing
               np.concatenate([fresh[:quarter // 2], more]),   # mixed
               None,                                      # all found
               crowd,
               pool[2 * quarter:2 * quarter + 2 * capacity],   # overfull
               pool[:0]]
    outcomes = {"found": 0, "inserted": 0, "failed": 0, "overflowed": 0}
    for keys in batches:
        if keys is None:
            stored = rk.cpu().numpy()
            live = (stored[:, 1] if mode == "wide" else stored) != (
                -2**63 if mode == "int64" else EMPTY)
            keys = stored[live][rng.permutation(int(live.sum()))]
        batch, valid = _k3_batch(rng, keys, mode) if len(keys) else (
            torch.from_numpy(keys).cuda(),
            torch.zeros(0, dtype=torch.bool, device="cuda"))
        slot, inserted, failed = _k3_step(tk, rk, batch, valid, max_probes)
        first = th.probe_starts(batch, capacity, max_probes)
        outcomes["found"] += int((valid & ~inserted & ~failed).sum())
        outcomes["inserted"] += int(inserted.sum())
        outcomes["failed"] += int(failed.sum())
        outcomes["overflowed"] += int((inserted
                                       & (slot - first >= bsz)).sum())
    assert outcomes["found"] and outcomes["inserted"] and outcomes["failed"]
    assert bool(outcomes["overflowed"]) == (chain > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", K3_MODES)
def test_insert_rows_through_find_or_insert_kernel(mode):
    """A table filled through ``insert_rows`` (K3 on the card) holds the
    CPU's keys and rows exactly, keeps the probe precondition (no stored
    key after an EMPTY slot of its window) and answers every key through
    ``probe_gather``; absent keys miss."""
    _need_card()
    rng = np.random.RandomState(11 + len(mode))
    capacity = 1 << 16
    keys = _k3_pool(rng, 9 * capacity // 10 + 2000, mode)  # load 0.9
    absent, keys = keys[:2000], keys[2000:]
    rows = rng.randn(len(keys), 9).astype(np.float32)
    meta = EmbeddingVariableMeta("float32", 9, 2**63)
    states = {dev: th.create_hash_table(meta, "default", capacity=capacity,
                                        key_dtype=mode, device=dev)
              for dev in ("cuda", "cpu")}
    for dev, st in states.items():
        for lo in range(0, len(keys), 10_000):
            th.insert_rows(st, torch.from_numpy(keys[lo:lo + 10_000]).to(dev),
                           torch.from_numpy(rows[lo:lo + 10_000]).to(dev))
    card, cpu = states["cuda"], states["cpu"]
    assert torch.equal(card.keys.cpu(), cpu.keys)
    assert torch.equal(card.weights.cpu(), cpu.weights)
    assert int(card.insert_failures) == int(cpu.insert_failures)
    bsz, _nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    stored = cpu.keys
    live = cpu.live()
    slots = torch.nonzero(live).flatten()
    start = th.probe_starts(stored[slots], capacity, th.DEFAULT_MAX_PROBES)
    free_before = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum((~live).long(), 0)])
    assert torch.equal(free_before[slots] - free_before[start],
                       torch.zeros_like(slots))
    assert bool(((slots - start) >= bsz).any())       # overflowed keys
    query = torch.from_numpy(np.concatenate([keys, absent])).cuda()
    got, hit = tp.probe_gather(card.keys, card.weights, query, chain=chain,
                               bucket=bsz,
                               empty=th.empty_key(card.keys.dtype))
    placed = int(live.sum())
    assert placed == len(keys) - int(cpu.insert_failures)
    assert int(hit[:len(keys)].sum()) == placed and not bool(
        hit[len(keys):].any())
    assert torch.equal(got[:len(keys)][hit[:len(keys)]].cpu(),
                       torch.from_numpy(rows)[hit[:len(keys)].cpu()])


@pytest.mark.gpu
def test_find_or_insert_kernel_captured_in_a_graph():
    """K3 launched into a ``CountedGraph``: the capture launches nothing,
    each replay on new keys in the captured buffers equals the plain
    version on a twin table, moves ``find_or_insert.launches`` by its
    ``3 + chain`` kernels and the key counters by its keys, and
    ``/metrics`` shows the counters."""
    _need_card()
    from openembedding_tpu_torch.ops import find_or_insert as k3
    from openembedding_tpu_torch.ops.launches import CountedGraph
    from openembedding_tpu_torch.utils import observability
    rng = np.random.RandomState(5)
    capacity, n = 1 << 16, 4096
    _b, _nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    pool = _k3_pool(rng, 3 * capacity // 2, "wide")
    tk = _k3_table("wide", capacity, 0)
    th.find_or_insert(tk, torch.from_numpy(pool[:capacity // 4]).cuda(),
                      torch.ones(capacity // 4, dtype=torch.bool,
                                 device="cuda"))
    rk = tk.clone()
    batch = torch.from_numpy(pool[:n]).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    graph = CountedGraph()
    before = k3.find_or_insert.launches
    with graph.capture():
        out = th.find_or_insert(tk, batch, valid)
    assert k3.find_or_insert.launches == before
    assert graph.tally == {k3.find_or_insert: 3 + chain}
    for replay in range(3):
        lo = capacity // 4 - n // 2 + replay * n // 2   # found and new
        batch.copy_(torch.from_numpy(pool[lo:lo + n]))
        valid.copy_(torch.from_numpy(rng.rand(n) < 0.9))
        counts = k3.key_counts()
        graph.replay()
        want = th.find_or_insert_reference(rk, batch, valid)
        torch.cuda.synchronize()
        assert torch.equal(tk, rk)
        for got, w in zip(out[1:], want[1:]):
            assert torch.equal(got, w)
        assert k3.find_or_insert.launches == before + (3 + chain) * (
            replay + 1)
        _s, inserted, failed = want[1:]
        assert int(inserted.sum()) > 0
        moved = {k: v - counts[k] for k, v in k3.key_counts().items()}
        assert moved == {"found": int((valid & ~inserted & ~failed).sum()),
                         "inserted": int(inserted.sum()),
                         "failed": int(failed.sum())}
    text = observability.prometheus_text(include_mem=False)
    for outcome, v in k3.key_counts().items():
        assert f'oe_hash_find_keys_total{{outcome="{outcome}"}} {v}' in text
