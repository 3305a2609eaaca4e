"""xDeepFM (Lian et al., KDD 2018, arXiv:1803.05170), as DeepCTR's
``xDeepFM`` builds it, over field embeddings ``x0 [B, F, D]`` and their
dim-1 linear twins ``w [B, F, 1]``, pulled from two fused tables, the
configuration's ``fused_name`` and ``<fused_name>:linear``::

    logit = sum_f w_f + Dense_0(CIN(x0))
            + Dense_1(MLP([x0 flattened, dense features])) + bias

The CIN (DeepCTR's ``CIN`` layer, the configuration's
``cin_layer_sizes`` H, ``cin_split_half``, ``cin_bias``): layer k takes the
maps ``x_{k-1} [B, H_{k-1}, D]`` (``x_0`` itself, ``H_0 = F``) and::

    z_k[b, i, j, d] = x_{k-1}[b, i, d] * x0[b, j, d]
    a_k[b, h, d] = relu(sum_{i,j} W_k[h, i F + j] z_k[b, i, j, d] + c_k[h])

A filter row runs over the pairs map-major, ``n = i F + j`` (DeepCTR's
Conv1D runs field-major, a permutation of the filter's columns that
changes no sum). With ``cin_split_half`` a layer other than the last passes
its maps ``0 .. H_k/2 - 1`` on as ``x_k`` and sum-pools the others over
``d``; the last layer pools all of its maps (without it every layer passes
all on and pools all). The pooled maps, layer by layer, are ``Dense_0``'s
input.

Parameters, named as the program names them: ``CIN_0.conv_<k>.weight``
``[H_k, H_{k-1} F]`` and ``CIN_0.conv_<k>.bias`` ``[H_k]`` (without
``cin_bias``: ``CIN_0.cin_w_<k>`` ``[H_{k-1} F, H_k]``, no bias), then
``Dense_0.weight`` ``[1, pooled]``, ``Dense_0.bias``, the ReLU tower
``MLP_0.Dense_<i>.weight`` ``[out, in]`` and ``.bias``, ``Dense_1.weight``
``[1, units[-1]]``, ``Dense_1.bias`` and ``bias``. DeepCTR's two output
layers have no bias; these do. The loss is the mean sigmoid cross-entropy.
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


def cin_layers(config: dict) -> List[Tuple[int, int, int]]:
    """Each CIN layer's ``(maps in, maps out, maps pooled)``."""
    f = int(config["num_features"])
    sizes = [int(h) for h in config["cin_layer_sizes"]]
    out, hk = [], f
    for k, h in enumerate(sizes):
        split = bool(config["cin_split_half"]) and k < len(sizes) - 1
        if split and h % 2:
            raise ValueError("with cin_split_half every CIN layer but the "
                             "last needs an even size")
        out.append((hk, h, h // 2 if split else h))
        hk = h // 2 if split else h
    return out


def param_shapes(config: dict) -> List[Tuple[str, tuple]]:
    """The dense parameters of ``config``'s xDeepFM, in order."""
    f = int(config["num_features"])
    out = []
    for k, (hk, h, _pooled) in enumerate(cin_layers(config)):
        if config["cin_bias"]:
            out += [(f"CIN_0.conv_{k}.weight", (h, hk * f)),
                    (f"CIN_0.conv_{k}.bias", (h,))]
        else:
            out.append((f"CIN_0.cin_w_{k}", (hk * f, h)))
    pooled = sum(p for _, _, p in cin_layers(config))
    out += [("Dense_0.weight", (1, pooled)), ("Dense_0.bias", (1,))]
    width = f * int(config["embedding_dim"]) + int(config["num_dense"])
    for i, units in enumerate(config["dnn_units"]):
        out.append((f"MLP_0.Dense_{i}.weight", (int(units), width)))
        out.append((f"MLP_0.Dense_{i}.bias", (int(units),)))
        width = int(units)
    out += [("Dense_1.weight", (1, width)), ("Dense_1.bias", (1,)),
            ("bias", (1,))]
    return out


def cin(params: Dict[str, torch.Tensor], x0: torch.Tensor,
        config: dict) -> torch.Tensor:
    """The pooled maps ``[B, pooled]`` of ``x0 [B, F, D]``."""
    b, f, d = x0.shape
    xk, pooled = x0, []
    for k, (hk, h, n_pooled) in enumerate(cin_layers(config)):
        z = torch.einsum("bid,bjd->bijd", xk, x0).reshape(b, hk * f, d)
        if config["cin_bias"]:
            w = params[f"CIN_0.conv_{k}.weight"]
            maps = torch.einsum("hn,bnd->bhd", w, z) \
                + params[f"CIN_0.conv_{k}.bias"][None, :, None]
        else:
            maps = torch.einsum("nh,bnd->bhd", params[f"CIN_0.cin_w_{k}"], z)
        maps = torch.relu(maps)                               # [B, h, D]
        pooled.append(maps[:, h - n_pooled:].sum(dim=2))
        xk = maps[:, :h - n_pooled] if n_pooled < h else maps
    return torch.cat(pooled, dim=1)


def logits(params: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
           dense: torch.Tensor, config: dict) -> torch.Tensor:
    """``[B]`` logits from the pulled rows by leaf (``[B, F, D]`` and
    ``[B, F, 1]``) and ``dense [B, n]``."""
    fields, linear = (rows[leaf] for leaf in tables(config))
    first = linear.sum(dim=(1, 2))
    exfm = (cin(params, fields, config) @ params["Dense_0.weight"].T
            + params["Dense_0.bias"])[:, 0]
    x = torch.cat([fields.reshape(fields.shape[0], -1), dense], dim=1)
    for i in range(len(config["dnn_units"])):
        x = torch.relu(x @ params[f"MLP_0.Dense_{i}.weight"].T
                       + params[f"MLP_0.Dense_{i}.bias"])
    deep = (x @ params["Dense_1.weight"].T + params["Dense_1.bias"])[:, 0]
    return first + exfm + deep + params["bias"][0]


def _matmul_macs(config: dict) -> int:
    """Multiply-adds of one forward pass's matrix products over a batch:
    the CIN's compressions, the tower and the two output layers."""
    b, f = int(config["batch_size"]), int(config["num_features"])
    d = int(config["embedding_dim"])
    macs, pooled = 0, 0
    for hk, h, n_pooled in cin_layers(config):
        macs += b * d * hk * f * h
        pooled += n_pooled
    width = f * d + int(config["num_dense"])
    for units in config["dnn_units"]:
        macs += b * width * int(units)
        width = int(units)
    return macs + b * (pooled + width)


def forward_flops(config: dict) -> float:
    """Operations of one forward pass over a batch: the matrix products'
    multiply-adds (compressions, tower, output layers) at two each; the
    maps' products, the pools' sums and the linear term at one each."""
    b, f = int(config["batch_size"]), int(config["num_features"])
    d = int(config["embedding_dim"])
    maps = sum(b * d * hk * f for hk, _, _ in cin_layers(config))
    pools = sum(b * d * p for _, _, p in cin_layers(config))
    return float(2 * _matmul_macs(config) + maps + pools + b * f)


def matmul_flops(config: dict) -> float:
    """The step's matrix-product operations, forward and backward: each
    product's multiply-adds at two, three times (the forward, and the
    backward's gradients of both operands: every product's input carries
    the embeddings' gradient back, the tower's first through its
    concatenation with the dense features)."""
    return 3.0 * 2 * _matmul_macs(config)


def logloss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean of ``-y log sigmoid(x) - (1 - y) log sigmoid(-x)``."""
    return torch.mean(-label * F.logsigmoid(logit)
                      - (1.0 - label) * F.logsigmoid(-logit))
