"""Training across processes (``openembedding_tpu/distributed.py``) over
``torch.distributed``.

The reference's cluster bootstrap (a master endpoint, the worker count,
each worker's rank) and its worker collectives (``barrier(name)``,
``boardcast(name, value)``) map to one ``init_process_group`` a process
(:func:`initialize`) and to this module's :func:`barrier` and
:func:`broadcast`. A ``(data, model)`` mesh over every process
(:func:`create_global_mesh`) gives process ``p`` its own consecutive data
rows, as JAX's global mesh does; each process feeds its own slice of the
batch (:func:`local_batch_to_global`), and the exchange planes move the
blocks between processes (``parallel/alltoall.py``).

A process drives one device: ``cuda`` unless the caller names ``cpu``.
The backend is the caller's choice: ``gloo`` on the CPU and for several
ranks that share one card, ``nccl`` only where each rank has a card of
its own (two ranks on one device raise here, before any collective: NCCL
refuses them). Gloo moves host memory, so a CUDA tensor crosses through
a pinned host buffer that this module fills and empties on the caller's
stream (:func:`all_to_all`, :func:`all_reduce`); NCCL takes the device
tensors as they are. Every collective here is one of ``all_to_all_single``,
``all_reduce``, ``broadcast`` and ``barrier``.

:data:`STATS` counts what the collectives cost: calls, seconds and the
bytes sent to other ranks. The seconds are host wall time: a host-staged
call (gloo on a card) waits for the card anyway, and its copy back is
waited for too, so they hold the whole crossing; a call that runs on the
card's stream (nccl) is only issued in them, with nothing synchronized,
so its device time is not counted.

Launch, one command a process (``examples/multihost_train.py``)::

    python -m openembedding_tpu_torch.examples.multihost_train \\
        --master 127.0.0.1:29511 --num_workers 2 --worker_rank 0 &
    python -m openembedding_tpu_torch.examples.multihost_train \\
        --master 127.0.0.1:29511 --num_workers 2 --worker_rank 1
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .parallel.mesh import DATA_AXIS, Mesh
from .utils.device import DeviceLike, resolve_device

BACKENDS = ("gloo", "nccl")
# seconds a collective may wait for its peers before it fails (JAX's
# two-process test gives its workers 240 s in all)
DEFAULT_TIMEOUT_S = 240.0

# collective cost: calls, seconds, bytes sent to other ranks
STATS: Dict[str, float] = {"calls": 0, "seconds": 0.0, "bytes": 0}

_STATE: Dict[str, Any] = {"device": None, "backend": None, "host": None}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes=0)


def _device_identity(dev: torch.device) -> int:
    """Host and device as one 63-bit number, one a physical device."""
    host = socket.gethostname()
    if dev.type != "cuda":
        name = f"{host}:{dev.type}:{os.getpid()}"
    else:
        props = torch.cuda.get_device_properties(dev)
        uuid = getattr(props, "uuid", None)
        name = f"{host}:cuda:{uuid if uuid is not None else dev.index}"
    digest = hashlib.sha256(name.encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def initialize(master_endpoint: str, num_workers: int, worker_rank: int,
               *, backend: Optional[str] = None, device: DeviceLike = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the training cluster: ``master_endpoint``
    (``"host:port"``, rank 0 listens there), ``num_workers`` processes,
    this one's ``worker_rank``. ``device``: this process's device (cuda
    unless named). ``backend``: ``"gloo"`` or ``"nccl"``; None takes
    ``gloo`` on the CPU and ``nccl`` on a card. ``nccl`` with two ranks
    on one device raises, naming ``gloo``. ``timeout``: the seconds a
    collective waits for its peers before it fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {dev}")
    if dist.is_initialized():
        raise RuntimeError("distributed.initialize called twice")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{master_endpoint}",
        world_size=int(num_workers), rank=int(worker_rank),
        timeout=datetime.timedelta(seconds=float(timeout)))
    # host values (barriers, broadcasts, the device check) travel on a
    # gloo group: the default group itself under gloo
    host = None if backend == "gloo" else dist.new_group(backend="gloo")
    n = int(num_workers)
    mine = torch.full((n,), _device_identity(dev), dtype=torch.int64)
    ids = torch.empty_like(mine)
    dist.all_to_all_single(ids, mine, group=host)
    if backend == "nccl" and len(set(ids.tolist())) < n:
        dist.destroy_process_group()
        raise ValueError(
            f"backend 'nccl' with {n} ranks on {len(set(ids.tolist()))} "
            "device(s): NCCL refuses two ranks on one device; use "
            "backend='gloo' for ranks that share a card")
    _STATE.update(device=dev, backend=backend, host=host)


def is_initialized() -> bool:
    return dist.is_initialized() and _STATE["backend"] is not None


def _require() -> None:
    if not is_initialized():
        raise RuntimeError("distributed.initialize has not been called")


def worker_rank() -> int:
    """This process's rank (the reference's ``comm_rank``)."""
    _require()
    return dist.get_rank()


def num_workers() -> int:
    _require()
    return dist.get_world_size()


def backend() -> str:
    _require()
    return _STATE["backend"]


def device() -> torch.device:
    """This process's device."""
    _require()
    return _STATE["device"]


def shutdown() -> None:
    """Leave the cluster (the process group is destroyed)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, backend=None, host=None)


def barrier(name: str = "barrier") -> None:
    """Every process waits for every other (``Communication::barrier``).
    ``name`` labels the call site only."""
    del name
    _require()
    dist.barrier(group=_STATE["host"])


class _HostTensor:
    """A tensor in a broadcast value: its CPU copy and its device."""

    def __init__(self, t: torch.Tensor):
        self.device = t.device
        self.data = t.detach().to("cpu", copy=True)


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def broadcast(value: Any, is_source: Optional[bool] = None) -> Any:
    """``value`` of the source process on every process (JAX's
    ``broadcast_one_to_all``, the reference's ``boardcast``): the source
    is rank 0, or the one process that passes ``is_source=True``. Values
    are trees (dicts, lists, tuples) of numpy arrays, tensors (each back
    on its device) and plain Python values."""
    _require()
    host = _STATE["host"]
    if is_source is None:
        is_source = dist.get_rank() == 0
    flag = torch.tensor([dist.get_rank() if is_source else -1],
                        dtype=torch.int64)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=host)
    src = int(flag.item())
    if src < 0:
        raise ValueError("broadcast: no process is the source")
    box = [_tree_map(lambda x: _HostTensor(x) if isinstance(
        x, torch.Tensor) else x, value) if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=host)
    return _tree_map(lambda x: x.data.to(x.device) if isinstance(
        x, _HostTensor) else x, box[0])


def create_global_mesh(data: int = 1, model: Optional[int] = None) -> Mesh:
    """The ``(data, model)`` mesh over every process, process ``p``
    owning the data rows ``p * data / P .. (p + 1) * data / P - 1``
    (JAX's ``create_global_mesh``). ``model=None``: one position a
    process, as JAX gives one a device (``P / data``). Every position of
    a process names its device."""
    _require()
    p = num_workers()
    if model is None:
        if p % data:
            raise ValueError(f"{p} processes not divisible by data={data}")
        model = p // data
    return Mesh([device()] * (data * model), data, model,
                process_count=p, process_index=worker_rank())


def local_batch_to_global(batch: Any, mesh: Mesh,
                          axis: str = DATA_AXIS) -> Any:
    """This process's slice of a global batch (JAX's
    ``local_batch_to_global``): every leaf on the mesh's device, its
    leading dimension this process's rows (a leaf None passes). Every
    process must feed slices of one size, as JAX's global arrays need;
    the sizes are checked across processes (two host collectives)."""
    if axis != DATA_AXIS:
        raise ValueError(f"batches split over {DATA_AXIS!r}, not {axis!r}")
    sizes = set()

    def place(x):
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.array(x, copy=True))
        sizes.add(int(t.shape[0]) if t.dim() else -1)
        return t.to(mesh.device, non_blocking=True)

    out = _tree_map(place, batch)
    if len(sizes) > 1:
        raise ValueError(f"batch leaves of different lengths {sorted(sizes)}")
    if mesh.spans_processes:
        check_agree(sizes.pop() if sizes else 0,
                    "rows fed: every process feeds one slice of one size")
    return out


def check_agree(value: int, what: str) -> None:
    """Raise ``ValueError`` on every process unless each passed the same
    ``value`` (``what`` names it): one host all-reduce of the value and
    its negation, a collective every process calls."""
    _require()
    n = int(value)
    both = torch.tensor([n, -n], dtype=torch.int64)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=_STATE["host"])
    if int(both[0]) != n or int(-both[1]) != n:
        raise ValueError(
            f"process {worker_rank()} has {n}, others up to {int(both[0])} "
            f"and down to {int(-both[1])}: {what}")


# --- the collectives of the exchange planes ----------------------------------

def _staged(t: torch.Tensor) -> bool:
    """Whether a tensor crosses through a host buffer (gloo on a card)."""
    return _STATE["backend"] == "gloo" and t.is_cuda


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _timed(fn, t: torch.Tensor, sent: int):
    t0 = time.perf_counter()
    out = fn()
    if _staged(t):
        # the copy back to the card ends the crossing (module note)
        torch.cuda.synchronize(t.device)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += int(sent)
    return out


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` ``[P, ...]`` (block ``q`` for process ``q``) -> ``[P, ...]``,
    block ``q`` the one process ``q`` sent here: in sender order. One
    ``all_to_all_single`` of the blocks' bytes; through pinned host
    buffers under gloo on a card."""
    p = mesh.process_count
    if x.shape[0] != p:
        raise ValueError(f"all_to_all: {x.shape[0]} blocks for {p} processes")
    # the blocks cross as their raw bytes: every dtype moves alike (gloo
    # has no 16-bit integer type), bit for bit
    shape, dtype = tuple(x.shape), x.dtype
    raw = x.contiguous().reshape(p, -1).view(torch.uint8)
    sent = raw.nbytes // p * (p - 1)

    def run():
        if _staged(raw):
            h = _pinned_like(raw)
            h.copy_(raw)
            out = torch.empty_like(h)
            dist.all_to_all_single(out, h)
            return out.to(raw.device, non_blocking=True)
        out = torch.empty_like(raw)
        dist.all_to_all_single(out, raw)
        return out
    return _timed(run, raw, sent).view(dtype).reshape(shape)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[P, ...]``: every process's ``x`` in rank order (an
    ``all_to_all_single`` of ``x`` repeated, bit for bit)."""
    p = mesh.process_count
    return all_to_all(x.unsqueeze(0).expand((p,) + tuple(x.shape)), mesh)


def all_reduce(x: torch.Tensor, mesh: Mesh, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (or ``"max"``) of ``x`` over the processes, in place;
    returns ``x``."""
    del mesh
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    sent = x.nbytes

    def run():
        if _staged(x):
            h = _pinned_like(x)
            h.copy_(x)
            dist.all_reduce(h, op=rop)
            x.copy_(h, non_blocking=True)
        else:
            dist.all_reduce(x, op=rop)
        return x
    return _timed(run, x, sent)
