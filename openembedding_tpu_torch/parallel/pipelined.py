"""The pipelined exchange schedule (``plane="a2a+pipelined"``,
``"a2a+grouped+pipelined"``; ``openembedding_tpu/parallel/pipelined.py``).

The ``Trainer`` cuts its step one pull earlier on pipelined variables:
step N's program runs the dense forward and backward on the rows pulled
for batch N by step N-1 (a :class:`PipelineState`, the only state the
schedule adds), pushes batch N, then pulls batch N+1's rows from the
tables that push wrote into that buffer. The op order on every table is
the serial plane's (``..., push(N), pull(N+1), push(N+1), ...``), so the
numbers are ``a2a``'s bit for bit: the version barrier of the reference's
prefetch, as an order of operations inside one program.

In the port the buffer is a set of fixed tensors of the state, rewritten
in place by each step's prefetch: a captured step program reads and
writes the same buffers on every replay, so one graph serves every step.
A first step, a drain, a batch the lookahead did not predict or an older
state re-primes: one eager pull of the batch's rows into the buffer,
exactly the pull a serial step opens with.

Variables on other planes (``a2a``, ``psum``, ``a2a+cache``) keep their
pull inside the step; offloaded variables must not be pipelined (their
host inserts change the table between the prefetch and its step), which
the ``Trainer`` refuses. Per-table calls (serving, checkpoints) run the
``a2a`` exchange: pipelining exists only in the ``Trainer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

PIPELINED_PLANES = ("a2a+pipelined", "a2a+grouped+pipelined")


@dataclasses.dataclass
class PipelineState:
    """The rows (pooled where the variable pools) the next step's dense
    half consumes, by variable, pulled after the producing step's push.
    Derived state: never checkpointed; a restore re-primes."""

    rows: Dict[str, torch.Tensor]


def split_columns(collection, inputs: Dict[str, Any]):
    """``(pipelined, inline)``: a batch's sparse columns by schedule."""
    pipelined = frozenset(collection.pipelined_names())
    pre = {n: v for n, v in inputs.items() if n in pipelined}
    inline = {n: v for n, v in inputs.items() if n not in pipelined}
    return pre, inline


def prefetch_pull(collection, states, inputs: Dict[str, Any], *,
                  batch_sharded: bool = True,
                  out: "PipelineState" = None) -> PipelineState:
    """The pipelined columns of ``inputs`` pulled through the collection
    (grouped members one exchange a group, pooled ones pooled), the pull
    a serial step would run. ``out``: a buffer of the same shapes that
    takes the rows in place (a captured step keeps it); else a new one."""
    pre, _ = split_columns(collection, inputs)
    rows = collection.pull(states, pre, batch_sharded=batch_sharded)
    if out is None:
        return PipelineState(rows=rows)
    for name, r in rows.items():
        out.rows[name].copy_(r)
    return out


def fits(pipe: "PipelineState", rows: Dict[str, torch.Tensor]) -> bool:
    """Whether ``pipe``'s buffers can take ``rows`` in place."""
    return pipe is not None and set(pipe.rows) == set(rows) and all(
        pipe.rows[k].shape == v.shape and pipe.rows[k].dtype == v.dtype
        and pipe.rows[k].device == v.device for k, v in rows.items())


def drain(state):
    """``state`` without its prefetched buffer (``pipe`` None). The
    tables are authoritative after every step, so nothing is lost; the
    next step re-primes."""
    if getattr(state, "pipe", None) is None:
        return state
    return dataclasses.replace(state, pipe=None)
