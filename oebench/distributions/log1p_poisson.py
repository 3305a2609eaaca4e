"""``log1p`` of poisson counts, as Criteo's dense counts are fed after
the usual log transform: ``{"dist": "log1p_poisson", "lam": 3.0}``."""

import torch


def draw(params, shape, g, device, sizes=None):
    lam = torch.full(shape, float(params["lam"]), device=device)
    return torch.log1p(torch.poisson(lam, generator=g))
