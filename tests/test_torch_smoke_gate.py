"""Gates of ``chip_smoke.py`` that run without a card.

``replay_gate``: the check that each CUDA-graph replay in a profiler
trace launched each kernel as often as the wrappers' counters say. It
runs on plain dicts: a record the profiler dropped from one replay passes
and is reported, a real disagreement of the counters with the graph
fails.

``_resid_close`` and ``_EFScales``: a card's int8_ef residual against the
CPU's, in units of the CPU quantization's per-row scale. Equal residuals
and one-unit flips pass (the flips counted); a residual zeroed, off by
two units or half a unit, of the wrong sign or of another row fails.

Phase 19's gates (``wait_procs``, ``bitwise_equal``, ``tables_close``):
a worker that exits nonzero fails the phase at once, its peer killed; a
wrong row from the sharded router, or a value one float32 unit off where
the phase holds bit equality (served rows, the ranks' losses and dense
parameters), fails; a table beyond atol 1e-6 + rtol 1e-5 of the
one-process mesh's fails, one within it passes.

Phase 20's gates: ``_stores_close`` holds two offload host stores
(1 x 4 against one shard, a restored table against the kept one): rows
within the tolerance pass, a touched row beyond it, an untouched row
that moved or a work id that differs (where compared) fails;
``_logical_rows`` reads a sharded table's logical rows, the rows the
served ones are held to; ``_swap_into`` holds the rows a whole registry
and a shard group's members serve after the deltas to the trainer's (a
wrong row, a row a member does not own, a base at another version or a
refused delta fails); ``_check_saves`` wants one full base and a
published delta at every later autosave."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

COUNTED = {"gather_rows": 0.0, "probe_gather": 16.0, "init_rows": 24.0}
FULL = 3000


def _trace(per_replay, totals):
    replays = {c: dict(v) for c, v in enumerate(per_replay)}
    recorded = dict(enumerate(totals))
    window = {k: sum(v[k] for v in per_replay) for k in COUNTED}
    return replays, recorded, window


def _good():
    return {"gather_rows": 0, "probe_gather": 16, "init_rows": 24}


def test_complete_replays_agree():
    replays, recorded, window = _trace([_good()] * 10, [FULL] * 10)
    got = chip_smoke.replay_gate(replays, recorded, window, 10, COUNTED)
    assert got == {"replays_with_kernels_recorded": 10,
                   "replays_with_records_dropped": 0,
                   "kernel_records_dropped": 0}


def test_one_record_dropped_by_the_profiler_is_reported():
    short = dict(_good(), init_rows=23)
    replays, recorded, window = _trace(
        [_good()] * 5 + [short] + [_good()] * 4,
        [FULL] * 5 + [FULL - 1] + [FULL] * 4)
    got = chip_smoke.replay_gate(replays, recorded, window, 10, COUNTED)
    assert got == {"replays_with_kernels_recorded": 10,
                   "replays_with_records_dropped": 1,
                   "kernel_records_dropped": 1}


@pytest.mark.parametrize("case", [
    # every replay of the graph holds one launch fewer than counted
    "all_replays_short",
    # a replay holds more launches than counted
    "replay_over",
    # a replay lost two launches of a wrapper but only one record
    "short_beyond_dropped_records",
    # the complete replays disagree even though one replay is short
    "complete_replays_wrong",
])
def test_disagreement_fails(case):
    short = dict(_good(), init_rows=23)
    if case == "all_replays_short":
        per, totals = [short] * 10, [FULL - 1] * 10
    elif case == "replay_over":
        per = [_good()] * 9 + [dict(_good(), probe_gather=17)]
        totals = [FULL] * 9 + [FULL + 1]
    elif case == "short_beyond_dropped_records":
        per = [_good()] * 9 + [dict(_good(), init_rows=22)]
        totals = [FULL] * 9 + [FULL - 1]
    else:
        per = [dict(_good(), probe_gather=15)] * 9 + [short]
        totals = [FULL] * 9 + [FULL - 1]
    replays, recorded, window = _trace(per, totals)
    with pytest.raises(AssertionError, match="per replay"):
        chip_smoke.replay_gate(replays, recorded, window, 10, COUNTED)


def test_no_replay_recorded_falls_back_to_the_window():
    replays = {c: {k: 0 for k in COUNTED} for c in range(10)}
    recorded = dict.fromkeys(range(10), 0)
    window = {k: int(n * 10) for k, n in COUNTED.items()}
    got = chip_smoke.replay_gate(replays, recorded, window, 10, COUNTED)
    assert got["replays_with_kernels_recorded"] == 0
    window["init_rows"] -= 1
    with pytest.raises(AssertionError):
        chip_smoke.replay_gate(replays, recorded, window, 10, COUNTED)


# --- chip_smoke._resid_close: a card int8_ef residual against the CPU's ---

def _quantized(seed=0):
    """A CPU quantization's residual rows and per-row scales."""
    import torch
    from openembedding_tpu_torch.parallel import alltoall
    gen = torch.Generator().manual_seed(seed)
    total = torch.randn(2, 64, 9, generator=gen) * 1e-3
    uniq = torch.arange(128, dtype=torch.int32).view(2, 64)
    valid = torch.ones(2, 64, dtype=torch.bool)
    valid[1, 60:] = False
    _, scale, (_, resid) = alltoall._quantize_ef(uniq, total, valid, False)
    return resid.reshape(-1, 9), scale.reshape(-1)


def test_resid_gate_counts_one_unit_flips():
    """Equal residuals pass with no flip; two elements one unit (their
    row's scale) off either way pass and are counted."""
    want, scale = _quantized()
    assert chip_smoke._resid_close("same", want.clone(), want,
                                   scale)["one_unit_flips"] == 0
    got = want.clone()
    got[3, 2] -= scale[3]
    got[70, 0] += scale[70]
    got += 1e-4 * scale[:, None] * (want.sign())    # rounding noise
    r = chip_smoke._resid_close("flipped", got, want, scale)
    assert r["one_unit_flips"] == 2 and r["elements"] == want.numel()
    assert r["max_units_from_equal"] <= 1.1e-4


@pytest.mark.parametrize("mutation", ["zeroed", "two_units", "half_unit",
                                      "wrong_sign", "other_rows"])
def test_resid_gate_refuses(mutation):
    """A residual that is zero, two units or half a unit off, of the
    wrong sign or of another row fails the gate."""
    want, scale = _quantized()
    got = want.clone()
    if mutation == "zeroed":
        got.zero_()
    elif mutation == "two_units":
        got[5, 1] += 2 * scale[5]
    elif mutation == "half_unit":
        got[5, 1] += 0.5 * scale[5]
    elif mutation == "wrong_sign":
        got = -want
    else:
        got = want.roll(1, dims=0)
    with pytest.raises(AssertionError, match="neither the CPU's nor one"):
        chip_smoke._resid_close(mutation, got, want, scale)


def test_ef_scales_keep_the_push_scales():
    """``_EFScales`` around a CPU int8_ef push on a 2 x 2 mesh: the kept
    scales are the stored residual's (each element within half a unit)
    and the gate holds the residual against itself."""
    import numpy as np
    import torch
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.optim import initializers as ti
    from openembedding_tpu_torch.parallel import alltoall
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    coll = EmbeddingCollection(
        [EmbeddingSpec(name="t", input_dim=512, output_dim=4,
                       plane="a2a+int8",
                       optimizer={"category": "sgd", "learning_rate": 0.1})],
        create_mesh(2, 2, device="cpu"))
    states = coll.init(ti.prng_key(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, 64).astype(np.int32)
    grads = {"t": torch.from_numpy(
        rng.standard_normal((64, 4)).astype(np.float32))}
    real = alltoall._quantize_ef
    with chip_smoke._EFScales() as kept:
        coll.apply_gradients(states, {"t": ids}, grads)
    assert alltoall._quantize_ef is real
    resid = states["t"].resid
    scale = kept.scale_of("t", resid)
    assert scale.shape == (resid.shape[0],)
    assert bool((resid.abs() <= scale[:, None] * (0.5 + 1e-6)).all())
    assert bool((resid != 0).any())
    assert chip_smoke._resid_close("t", resid, resid,
                                   scale)["one_unit_flips"] == 0
    with pytest.raises(AssertionError, match="no int8 quantization"):
        kept.scale_of("t", resid + 1.0)


def _proc(code: str, tmp_path, name: str):
    out = str(tmp_path / f"{name}.log")
    with open(out, "w") as f:
        p = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                             stderr=subprocess.STDOUT)
    p.out = out
    return p


def test_worker_exiting_nonzero_fails_the_phase(tmp_path):
    """A worker that exits 3 while its peer waits in a collective: the
    gate raises at once with the worker's output, and kills the peer."""
    peer = _proc("import time; time.sleep(60)", tmp_path, "peer")
    bad = _proc("import sys; print('worker broke'); sys.exit(3)", tmp_path,
                "bad")
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="worker 1 exited 3"):
        chip_smoke.wait_procs({"worker 0": peer, "worker 1": bad}, 60,
                              "multiprocess training")
    assert time.monotonic() - t0 < 30
    assert peer.returncode is not None
    ok = {f"w{r}": _proc("pass", tmp_path, f"ok{r}") for r in range(2)}
    chip_smoke.wait_procs(ok, 60, "fine")


def test_worker_timeout_fails_the_phase(tmp_path):
    slow = _proc("import time; time.sleep(60)", tmp_path, "slow")
    with pytest.raises(AssertionError, match="worker 0 exited"):
        chip_smoke.wait_procs({"worker 0": slow}, 0.5, "multiprocess")


def _rows():
    rng = np.random.default_rng(0)
    return rng.standard_normal((64, 9)).astype(np.float32)


@pytest.mark.parametrize("mutation", ["row_swapped", "one_unit",
                                      "zero_row", "shape"])
def test_served_rows_gate_refuses(mutation):
    """A wrong row from the sharded client fails, and so does one value
    one float32 unit off."""
    want = _rows()
    got = want.copy()
    if mutation == "row_swapped":
        got[[3, 4]] = got[[4, 3]]
    elif mutation == "one_unit":
        got[7, 2] = np.nextafter(got[7, 2], np.float32(np.inf))
    elif mutation == "zero_row":
        got[10] = 0.0
    else:
        got = got[:-1]
    with pytest.raises(AssertionError):
        chip_smoke.bitwise_equal("served rows", got, want)
    chip_smoke.bitwise_equal("served rows", want.copy(), want)
    chip_smoke.bitwise_equal("losses", [0.5, 0.25], [0.5, 0.25])
    with pytest.raises(AssertionError):
        chip_smoke.bitwise_equal("losses", [0.5, 0.25],
                                 [0.5, float(np.nextafter(0.25, 1.0))])


def test_table_gate():
    """A table one float32 unit off a one-process table passes the
    tolerance gate; off by 1e-4 relative, or one element off by 1e-5
    absolute near zero, it fails; a wrong shape fails."""
    want = torch.from_numpy(_rows())
    ulp = torch.from_numpy(np.nextafter(want.numpy(), np.float32(np.inf)))
    assert chip_smoke.tables_close("t", ulp, want) > 0
    with pytest.raises(AssertionError, match="beyond"):
        chip_smoke.tables_close("t", want * (1 + 1e-4), want)
    near = want.clone()
    near[0, 0] = 0.0
    off = near.clone()
    off[0, 0] = 1e-5
    with pytest.raises(AssertionError, match="1 elements beyond"):
        chip_smoke.tables_close("t", off, near)
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.tables_close("t", want[:-1], want)


# --- phase 20 ----------------------------------------------------------------

class _Store:
    """The host half of an offload table, as ``_stores_close`` reads it."""

    def __init__(self, vocab=1 << 13, dim=2, seed=0):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        self.host_weights = rng.rand(vocab, dim).astype(np.float32)
        self.host_slots = {"accum": rng.rand(vocab, dim).astype(np.float32)}
        self.host_work_id = np.zeros(vocab, np.int64)
        self.host_work_id[:64] = 3

    def copy(self):
        out = _Store.__new__(_Store)
        out.vocab = self.vocab
        out.host_weights = self.host_weights.copy()
        out.host_slots = {k: v.copy() for k, v in self.host_slots.items()}
        out.host_work_id = self.host_work_id.copy()
        return out


def test_store_gate_passes_within_tolerance():
    a = _Store()
    b = a.copy()
    b.host_weights[:64] *= 1 + 5e-6
    worst = chip_smoke._stores_close("ok", a, b, 1e-5, 1e-6)
    assert 0 < worst < 1e-5
    assert chip_smoke._stores_close("same", a, a.copy(), 1e-6, 1e-7) == 0


@pytest.mark.parametrize("mutation", ["touched", "untouched", "slot",
                                      "work_id"])
def test_store_gate_refuses(mutation):
    a = _Store()
    b = a.copy()
    if mutation == "touched":
        b.host_weights[5, 1] += 1e-3
    elif mutation == "untouched":
        # every untouched row is in the bit-for-bit sample's reach
        b.host_weights[64:] += 1e-3
    elif mutation == "slot":
        b.host_slots["accum"][7, 0] *= 1.01
    else:
        b.host_work_id[10] = 4
    with pytest.raises(AssertionError):
        chip_smoke._stores_close(mutation, a, b, 1e-5, 1e-6)
    if mutation == "work_id":
        chip_smoke._stores_close("stamps off", a, b, 1e-5, 1e-6,
                                 work_ids=False)


def test_logical_rows_read_the_stacked_shards():
    from openembedding_tpu_torch.data.criteo import SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.parallel import sharded_table as st
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    specs, _ = make_fused_specs(SPARSE_NAMES[:2], 8, 3)
    coll = EmbeddingCollection(specs, create_mesh(2, 2, device="cpu"))
    states = coll.init()
    trainer = type("T", (), {"collection": coll})()
    state = type("S", (), {"emb": states})()
    ids = np.asarray([0, 5, 15, 6, 1], np.int64)
    want = st.to_logical(states["fields"], coll.sharding_spec("fields"),
                         16).weights.numpy()[ids]
    np.testing.assert_array_equal(
        chip_smoke._logical_rows(trainer, state, "fields", ids), want)


class _Model:
    """A registry's model as ``_swap_into`` reads it: a version and the
    rows it serves."""

    def __init__(self, rows):
        self.version, self.rows = 0, rows

    def lookup(self, name, ids):
        return torch.from_numpy(self.rows[name])


class _Registry:
    def __init__(self, rows, applied=True):
        self.model, self.applied = _Model(rows), applied

    def find_model(self, sign):
        return self.model

    def apply_delta(self, sign, delta):
        self.model.version = delta.seq
        return {"applied": self.applied, "version": delta.seq}


@pytest.mark.parametrize("mutation", ["none", "row", "foreign", "base",
                                      "refused"])
def test_swap_gate(monkeypatch, mutation):
    """Served rows of a whole registry and of a shard group's members:
    the trainer's rows pass; a wrong owned row, a row a member does not
    own, a base at another version, or a refused delta fail."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    ids = np.arange(10, dtype=np.int64) * 3 + 1
    want = {"t": np.random.RandomState(0).rand(10, 2).astype(np.float32)}
    members = []
    for k in range(2):
        rows = want["t"].copy()
        rows[ids % 2 != k] = 0
        members.append({"t": rows})
    whole = {"t": want["t"].copy()}
    applied = True
    if mutation == "row":
        whole["t"][3, 1] += 1e-7
    elif mutation == "foreign":
        members[0]["t"][ids % 2 == 1] = want["t"][ids % 2 == 1]
    elif mutation == "refused":
        applied = False
    registries = {"whole": (_Registry(whole, applied), 0, 1, 0.0)}
    if mutation == "base":
        registries["whole"][0].model.version = 1
    for k in range(2):
        registries[f"slice{k}"] = (_Registry(members[k]), k, 2, 0.0)
    published = [type("D", (), {"seq": 1, "rows": 10})()]
    if mutation == "none":
        swaps = chip_smoke._swap_into(registries, published, ids, want, ids)
        assert set(swaps) == {"whole", "slice0", "slice1"}
        assert all(len(s["swap_s"]) == 1 for s in swaps.values())
    else:
        with pytest.raises(AssertionError):
            chip_smoke._swap_into(registries, published, ids, want, ids)


@pytest.mark.parametrize("modes,published,ok", [
    (["full", "delta", "delta"], 2, True),
    (["full", "full", "delta"], 1, False),
    (["full", "delta", "delta"], 1, False),
    (["full", "delta"], 1, False),
])
def test_save_gate(modes, published, ok):
    """A 3-step fit autosaving each step: one full base, then a published
    delta at every later autosave."""
    saves = [{"mode": m, "bytes": 100 if m == "full" else 10}
             for m in modes]
    reading = {}
    if ok:
        chip_smoke._check_saves("fit", saves, [None] * published, 3,
                                reading)
        assert reading["full_over_delta_bytes"] == 10
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_saves("fit", saves, [None] * published, 3,
                                    reading)
