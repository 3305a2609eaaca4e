"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device (the
CPU tests pass ``device="cpu"``). With no device named and no GPU present
they raise: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
