"""The device mesh (``openembedding_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process drives a ``(data,
model)`` mesh of devices. The ``data`` axis is the reference's workers
(the batch is split over it), the ``model`` axis its parameter-server
shards (tables are split over it, or over the whole mesh on the ``a2a``
plane). The port keeps that program shape inside one process: a
:class:`Mesh` is a ``(data, model)`` grid of torch devices in row-major
order, and each mesh position holds its logical shard's tensors on its
device. Entries may repeat one device: on one GPU every position names
``cuda:0`` and the shards' exchange is a transpose of their stacked
buffers (``parallel/alltoall.py``). One process over several distinct
devices raises: several cards take one process each
(``distributed.py``).

A mesh may span processes (``distributed.create_global_mesh``): process
``p`` of ``P`` owns the data rows ``p * D / P .. (p + 1) * D / P - 1``,
as JAX's global mesh gives each process its own consecutive rows, so its
positions (:attr:`Mesh.local_positions`) are one contiguous run of the
row-major order. Such a mesh holds only its own positions' shards; its
exchanges cross processes through ``torch.distributed``
(``alltoall.grid_all_to_all``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(data, model)`` grid of devices, row-major: position ``(d, m)``
    is ``devices[d * model + m]``, its linear shard id over both axes.
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: Sequence[torch.device], data: int,
                 model: int, *, process_count: int = 1,
                 process_index: int = 0):
        devices = tuple(torch.device(d) for d in devices)
        if data < 1 or model < 1 or data * model != len(devices):
            raise ValueError(f"mesh {data}x{model} != {len(devices)} "
                             "devices")
        if len(set(devices)) > 1:
            raise ValueError(
                f"a mesh over {len(set(devices))} distinct devices "
                f"({', '.join(str(d) for d in sorted(set(devices), key=str))})"
                ": one process drives one device; run one process a card "
                "and span them with distributed.create_global_mesh")
        if process_count < 1 or data % process_count:
            raise ValueError(f"{process_count} processes do not split the "
                             f"{data} data rows evenly")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.devices = devices
        self.shape: Dict[str, int] = {DATA_AXIS: int(data),
                                      MODEL_AXIS: int(model)}
        self.process_count = int(process_count)
        self.process_index = int(process_index)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        """The one device every position of the mesh names."""
        return self.devices[0]

    @property
    def dims(self) -> Tuple[int, int]:
        return self.shape[DATA_AXIS], self.shape[MODEL_AXIS]

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    @property
    def local_data_rows(self) -> int:
        """The data rows this process owns."""
        return self.shape[DATA_AXIS] // self.process_count

    @property
    def local_positions(self) -> range:
        """This process's positions, linear row-major ids: its data rows'
        whole model rows, one contiguous run."""
        n = self.local_data_rows * self.shape[MODEL_AXIS]
        return range(self.process_index * n, (self.process_index + 1) * n)

    def process_of(self, position: int) -> int:
        """The process that owns linear position ``position``."""
        return position // len(self.local_positions)

    def __repr__(self) -> str:
        d, m = self.dims
        procs = (f", process {self.process_index} of "
                 f"{self.process_count}" if self.spans_processes else "")
        return f"Mesh({d}x{m} on {self.device}{procs})"


def create_mesh(data: int = 1, model: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None,
                device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh, as JAX's ``create_mesh``: ``model=None``
    takes the devices left after ``data``. ``devices`` lists one device
    per position; without it every position names ``device`` (cuda
    unless named), the one-card mesh of ``data * model`` logical shards
    (``model=None`` then means ``model=1``)."""
    if devices is None:
        if model is None:
            model = 1
        dev = resolve_device(device)
        devices = [dev] * (data * model)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if model is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        model = n // data
    return Mesh(devices, data, model)


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    """The 1 x 1 mesh of ``device`` (cuda unless named)."""
    return create_mesh(1, 1, device=device)
