"""ids uniform over each feature's vocabulary: ``{"dist": "uniform"}``."""

import torch


def draw(params, shape, g, device, sizes):
    r = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    return torch.minimum(torch.floor(r * sizes).to(torch.int64), sizes - 1)
