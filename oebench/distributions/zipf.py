"""ids of zipf popularity within each feature's vocabulary:
``{"dist": "zipf", "a": 1.2}``.

A feature of vocabulary ``V`` draws a rank ``r`` from the zipf law of
exponent ``a`` > 1 cut off at ``V`` (numpy's rejection method, a candidate
above ``V`` drawn again), and takes the id ``((r - 1) P + f Q) mod V``:
a bijection of the ranks onto the ids (``P`` a prime above any
vocabulary), so the most popular ids lie scattered over the table, not in
its first rows.
"""

import torch

P = 2654435761
Q = 40503


def draw(params, shape, g, device, sizes):
    a = float(params["a"])
    am1 = a - 1.0
    b = 2.0 ** am1
    cap = torch.broadcast_to(sizes.to(torch.float64), shape).reshape(-1)
    out = torch.empty(cap.numel(), dtype=torch.int64, device=device)
    todo = torch.arange(cap.numel(), device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=g, device=device,
                             dtype=torch.float64)
        v = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1) & (x <= cap[todo]) \
            & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok].to(torch.int64)
        todo = todo[~ok]
    rank = out.reshape(shape) - 1
    feature = torch.arange(shape[-1], device=device, dtype=torch.int64)
    return (rank * P + feature * Q) % sizes
