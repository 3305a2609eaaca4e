"""DeepFM (Guo et al., 2017), as DeepCTR and OpenEmbedding's Criteo
benchmark build it over field embeddings ``x [B, F, k]`` and their dim-1
linear twins ``w [B, F, 1]``, pulled from two fused tables, the
configuration's ``fused_name`` and ``<fused_name>:linear``::

    logit = sum_f w_f + 0.5 * sum_d ((sum_f x_f)^2 - sum_f x_f^2)
            + Dense_0(MLP([x flattened, dense features])) + bias

``MLP`` is a ReLU tower. Parameters are named as the benchmark draws
them: ``MLP_0.Dense_<i>.weight`` ``[out, in]`` and ``.bias``, then
``Dense_0.weight`` ``[1, units[-1]]``, ``Dense_0.bias`` and ``bias``.
The loss is the mean sigmoid cross-entropy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def tables(config: dict) -> Dict[str, int]:
    """The fused tables the model pulls from, by leaf name, with their
    widths."""
    name = config["fused_name"]
    return {name: int(config["embedding_dim"]), name + ":linear": 1}


def param_shapes(config: dict) -> List[Tuple[str, tuple]]:
    """The dense parameters of ``config``'s DeepFM, in order."""
    width = int(config["num_features"]) * int(config["embedding_dim"]) \
        + int(config["num_dense"])
    out = []
    for i, units in enumerate(config["dnn_units"]):
        out.append((f"MLP_0.Dense_{i}.weight", (int(units), width)))
        out.append((f"MLP_0.Dense_{i}.bias", (int(units),)))
        width = int(units)
    out += [("Dense_0.weight", (1, width)), ("Dense_0.bias", (1,)),
            ("bias", (1,))]
    return out


def logits(params: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
           dense: torch.Tensor, config: dict) -> torch.Tensor:
    """``[B]`` logits from the pulled rows by leaf (``[B, F, k]`` and
    ``[B, F, 1]``) and ``dense [B, D]``."""
    fields, linear = (rows[leaf] for leaf in tables(config))
    first = linear.sum(dim=(1, 2))
    total = fields.sum(dim=1)
    fm = 0.5 * (total * total - (fields * fields).sum(dim=1)).sum(dim=1)
    x = torch.cat([fields.reshape(fields.shape[0], -1), dense], dim=1)
    for i in range(len(config["dnn_units"])):
        x = torch.relu(x @ params[f"MLP_0.Dense_{i}.weight"].T
                       + params[f"MLP_0.Dense_{i}.bias"])
    deep = (x @ params["Dense_0.weight"].T + params["Dense_0.bias"])[:, 0]
    return first + fm + deep + params["bias"][0]


def forward_flops(config: dict) -> float:
    """Operations of one forward pass over a batch: the tower's
    multiply-adds at two each, the FM term's and the linear term's
    elementwise operations at one each."""
    b, f = int(config["batch_size"]), int(config["num_features"])
    k, d = int(config["embedding_dim"]), int(config["num_dense"])
    width, macs = f * k + d, 0
    for units in list(config["dnn_units"]) + [1]:
        macs += width * int(units)
        width = int(units)
    fm = b * (3 * f * k + 2 * k)        # sums, squares, difference, sum
    return float(2 * b * macs + fm + b * f)


def logloss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean of ``-y log sigmoid(x) - (1 - y) log sigmoid(-x)``."""
    return torch.mean(-label * F.logsigmoid(logit)
                      - (1.0 - label) * F.logsigmoid(-logit))
