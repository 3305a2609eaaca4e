"""Standard normal values: ``{"dist": "normal"}``."""

import torch


def draw(params, shape, g, device, sizes=None):
    return torch.randn(shape, generator=g, device=device)
