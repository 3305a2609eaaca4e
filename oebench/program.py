"""The system under test, built and read through its own entry points.

:func:`build` makes a configuration's trainer as a user of
``openembedding_tpu_torch`` does (``fused.make_fused_specs``,
``embedding.EmbeddingCollection``, ``models.deepctr.build_model``,
``optim.dense.adagrad``, ``training.Trainer``); :func:`init_state` gives it
the benchmark's initial values (a hash table's keys through
``hash_table.insert_rows``, the loader's path); :func:`grad_readings` and
:func:`change_readings` read its state as the reference is read
(``reference/train.py``). This is the only module of the benchmark that
touches the program's state; the program's own modules are imported
inside the functions.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .initial import CHUNK, Initial, table_dims, table_rows
from .reference import model
from .reference.mapping import vocab_sizes

# keys a call of ``insert_rows``
LOAD_CHUNK = 1 << 20


def feature_names(config: dict):
    return tuple(f"C{j + 1}" for j in range(int(config["num_features"])))


def build(config: dict, device):
    """The configuration's ``Trainer`` on ``device`` and its fused-id
    mapper."""
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models.deepctr import build_model
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    names = feature_names(config)
    hashed = config["table"] == "hash"
    extra = {"hash_capacity": int(config["hash_capacity"]),
             "key_dtype": config["key_dtype"]} if hashed else {}
    specs, mapper = make_fused_specs(
        names, -1 if hashed else [int(v) for v in vocab_sizes(config)],
        int(config["embedding_dim"]), name=config["fused_name"],
        dtype=config["dtype"], optimizer=dict(config["sparse_optimizer"]),
        **extra)
    module = build_model(config["model"], names,
                         embedding_dim=int(config["embedding_dim"]),
                         num_dense=int(config["num_dense"]),
                         dnn_units=tuple(config["dnn_units"]))
    dn = config["dense_optimizer"]
    trainer = Trainer(module, EmbeddingCollection(specs, device=device),
                      dense.adagrad(float(dn["learning_rate"]),
                                    float(dn["initial_accumulator_value"]),
                                    float(dn["eps"])))
    return trainer, mapper


def host_batches(pool, mapper, config: dict) -> List[dict]:
    """The pool's batches as the program's host batches (numpy), fused by
    the program's mapper, as a user's input pipeline hands them over."""
    names = feature_names(config)
    return [mapper.fuse_batch(pool.batch(p, names)) for p in range(len(pool))]


def init_state(trainer, initial: Initial, sample: dict):
    """The trainer's state (``Trainer.init``), its values then replaced
    by the benchmark's: dense parameters and accumulators, each array
    table's rows and accumulators; each hash table filled with every key
    of ``initial.keys`` and its row."""
    from openembedding_tpu_torch.hash_table import insert_rows
    from openembedding_tpu_torch.optim.initializers import prng_key
    from .reference.mapping import key_words
    config = initial.config
    state = trainer.init(prng_key(0), sample)
    want = dict(model(config).param_shapes(config))
    got = {k: tuple(v.shape) for k, v in state.params.items()}
    if got != want:
        raise ValueError(f"the program's dense parameters {got} are not "
                         f"the configuration's {want}")
    acc = initial.sparse_accumulator
    with torch.no_grad():
        for name, value in initial.dense().items():
            state.params[name].copy_(value)
            state.opt_state[name].fill_(initial.dense_accumulator)
        for leaf in table_dims(config):
            st = state.emb[leaf]
            if initial.keys is None:
                for c in range(math.ceil(table_rows(config) / CHUNK)):
                    st.weights[c * CHUNK:(c + 1) * CHUNK].copy_(
                        initial.array_chunk(leaf, c))
                for slot in st.slots.values():
                    slot.fill_(acc)
                continue
            words = torch.from_numpy(key_words(initial.keys)).to(
                st.weights.device)
            rows = initial.hash_all(leaf)
            for lo in range(0, rows.shape[0], LOAD_CHUNK):
                part = rows[lo:lo + LOAD_CHUNK]
                insert_rows(st, words[lo:lo + LOAD_CHUNK], part,
                            {k: torch.full((part.shape[0],) + v.shape[1:],
                                           acc, device=v.device)
                             for k, v in st.slots.items()})
            failures, used = int(st.insert_failures), st.num_used()
            if failures or used != rows.shape[0]:
                raise RuntimeError(
                    f"{leaf}: {failures} insert failures, {used} of "
                    f"{rows.shape[0]} keys placed")
    return state


def _chunks(state, leaf: str, initial: Initial):
    """``(weights, accumulator, initial rows, entry)`` for each chunk of a
    table's storage: ``entry`` is what each slot holds, the fused row of
    an array table or the int64 key of a hash table. A slot whose key is
    none of the pool's (an empty one: its words decode to a key no id
    reaches) starts at zero."""
    st = state.emb[leaf]
    acc = st.slots["accum"]
    dev = st.weights.device
    if initial.keys is None:
        for c in range(math.ceil(st.weights.shape[0] / CHUNK)):
            lo, hi = c * CHUNK, min((c + 1) * CHUNK, st.weights.shape[0])
            yield (st.weights[lo:hi], acc[lo:hi],
                   initial.array_chunk(leaf, c),
                   torch.arange(lo, hi, device=dev))
        return
    keys = torch.from_numpy(initial.keys).to(dev)
    rows = initial.hash_all(leaf)
    for lo in range(0, st.weights.shape[0], CHUNK):
        words = st.keys[lo:lo + CHUNK]
        entry = (words[:, 1].long() << 32) | (words[:, 0].long()
                                              & 0xFFFFFFFF)
        pos = torch.searchsorted(keys, entry).clamp(max=keys.numel() - 1)
        found = keys[pos] == entry
        w0 = torch.where(found[:, None], rows[pos], torch.zeros_like(
            rows[pos]))
        yield st.weights[lo:lo + CHUNK], acc[lo:lo + CHUNK], w0, entry


def _sum_sq(x: torch.Tensor) -> float:
    return float(torch.sum(x.double() ** 2))


def grad_readings(state, initial: Initial, touched: np.ndarray
                  ) -> Dict[str, float]:
    """After the first step: by leaf, the norm of the gradient the
    optimizer got, worked out from the change and the accumulator
    (``g = (w0 - w1) (sqrt(acc) + eps) / lr`` for a table's rows the
    first batch touched, ``g = (p0 - p1) sqrt(s + eps) / lr`` for a dense
    parameter)."""
    config = initial.config
    sp, dn = config["sparse_optimizer"], config["dense_optimizer"]
    out = {}
    with torch.no_grad():
        for leaf in table_dims(config):
            total = 0.0
            for w, acc, w0, entry in _chunks(state, leaf, initial):
                hit = torch.isin(entry, torch.from_numpy(touched).to(
                    entry.device))
                g = (w0[hit].double() - w[hit].double()) \
                    * (torch.sqrt(acc[hit].double()) + sp["epsilon"]) \
                    / sp["learning_rate"]
                total += _sum_sq(g)
            out[leaf] = math.sqrt(total)
        for name, p0 in initial.dense().items():
            g = (p0.double() - state.params[name].double()) * torch.sqrt(
                state.opt_state[name].double() + dn["eps"]) \
                / dn["learning_rate"]
            out[name] = math.sqrt(_sum_sq(g))
    return out


def change_readings(state, initial: Initial, touched: np.ndarray):
    """By leaf, the norm of the change from the initial values over the
    entries the reference touched, and over every other entry
    (``stray``, nought in a sound program)."""
    config = initial.config
    change, stray = {}, {}
    with torch.no_grad():
        for leaf in table_dims(config):
            inside = outside = 0.0
            for w, _acc, w0, entry in _chunks(state, leaf, initial):
                hit = torch.isin(entry, torch.from_numpy(touched).to(
                    entry.device))
                d = w.double() - w0.double()
                inside += _sum_sq(d[hit])
                outside += _sum_sq(d[~hit])
            change[leaf], stray[leaf] = math.sqrt(inside), math.sqrt(outside)
        for name, p0 in initial.dense().items():
            change[name] = math.sqrt(_sum_sq(
                state.params[name].double() - p0.double()))
            stray[name] = 0.0
    return change, stray
