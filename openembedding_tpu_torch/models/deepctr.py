"""CTR models: LR, Wide&Deep and DeepFM as ``torch.nn`` modules
(``openembedding_tpu/models/deepctr.py``).

The modules hold only the dense maths. The ``EmbeddingCollection`` pulls
the embedding rows outside the module and passes them in as a dict: per
feature ``rows[name] -> [B, dim]`` and ``rows[name + ":linear"] -> [B,
1]``, or fused ``rows["fields"] -> [B, F, dim]`` and
``rows["fields:linear"] -> [B, F, 1]``. The arithmetic is the JAX
modules', term for term.

Two differences follow from torch. A linear layer takes its input width
when it is built (torch has no lazy ``nn.Dense``), so a model takes the
embedding width and the number of dense features. And the parameters keep
flax's names (``MLP_0.Dense_0``, ``Dense_0``, ``bias``), with a flax
``kernel`` ``[in, out]`` stored as the torch ``weight`` ``[out, in]``, so
``interop.dense_params_from_flax`` maps one onto the other by name.
:func:`init_params` draws flax's initial values from flax's keys:
``lecun_normal`` kernels, zero biases, equal to ``module.init``'s.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..embedding import EmbeddingSpec, not_ported
from ..fused import FUSED_NAME, LINEAR_SUFFIX
from ..interop import flax_path
from ..optim.initializers import Normal, flax_param_key
from ..utils.device import resolve_device

# flax's lecun_normal: the stddev of a normal truncated at +-2 is this
# fraction of the untruncated one
_TRUNC_STD = 0.87962566103423978

def make_feature_specs(feature_names: Sequence[str],
                       vocab_sizes,
                       embedding_dim: int,
                       *,
                       need_linear: bool = True,
                       dtype: str = "float32",
                       optimizer: Any = None,
                       initializer: Any = None,
                       hash_capacity: int = 2**20,
                       **spec_kwargs) -> Tuple[EmbeddingSpec, ...]:
    """One spec per categorical feature (a dim-k table) plus, for models
    with a linear term, a dim-1 ``:linear`` twin initialized to zero.

    ``vocab_sizes``: an int per feature, one int, or -1 for the hash
    space. ``spec_kwargs`` pass through to every ``EmbeddingSpec`` (the
    JAX signature's plane, exchange and cache knobs).
    """
    if isinstance(vocab_sizes, int):
        vocab_sizes = [vocab_sizes] * len(feature_names)
    if len(vocab_sizes) != len(feature_names):
        raise ValueError("vocab_sizes must match feature_names")
    emb_init = initializer or {"category": "normal", "mean": 0.0,
                               "stddev": 1e-4}
    specs = []
    for name, vocab in zip(feature_names, vocab_sizes):
        specs.append(EmbeddingSpec(
            name=name, input_dim=vocab, output_dim=embedding_dim,
            dtype=dtype, optimizer=optimizer, initializer=emb_init,
            hash_capacity=hash_capacity, **spec_kwargs))
        if need_linear:
            specs.append(EmbeddingSpec(
                name=name + LINEAR_SUFFIX, input_dim=vocab, output_dim=1,
                dtype=dtype, optimizer=optimizer,
                initializer={"category": "constant", "value": 0.0},
                hash_capacity=hash_capacity, **spec_kwargs))
    return tuple(specs)


def _stack_fields(rows: Dict[str, torch.Tensor],
                  names: Sequence[str]) -> torch.Tensor:
    """``[B, F, dim]`` field-major embedding block, from the fused entry
    or stacked from the per-feature ones."""
    if FUSED_NAME in rows:
        return rows[FUSED_NAME]
    return torch.stack([rows[n] for n in names], dim=1)


def _linear_term(rows: Dict[str, torch.Tensor],
                 names: Sequence[str]) -> torch.Tensor:
    """Sum of the first-order (dim-1) embeddings -> ``[B]``."""
    fused = FUSED_NAME + LINEAR_SUFFIX
    if fused in rows:
        return torch.sum(rows[fused], dim=(-2, -1))
    lin = torch.cat([rows[n + LINEAR_SUFFIX] for n in names], dim=-1)
    return torch.sum(lin, dim=-1)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=float32)``: the input computes at the
    layer's dtype."""
    return layer(x.to(layer.weight.dtype))


class MLP(nn.Module):
    """Plain ReLU tower; its layers are ``Dense_0``, ``Dense_1``, ..."""

    def __init__(self, in_features: int, units: Sequence[int]):
        super().__init__()
        self.out_features = in_features
        for i, u in enumerate(units):
            self.add_module(f"Dense_{i}", nn.Linear(self.out_features, u))
            self.out_features = u

    def forward(self, x):
        for layer in self.children():
            x = torch.relu(_dense(layer, x))
        return x


def _deep_input(fields: torch.Tensor, dense: Optional[torch.Tensor]):
    deep_in = fields.reshape(fields.shape[0], -1)
    if dense is not None:
        deep_in = torch.cat([deep_in, dense.to(deep_in.dtype)], dim=-1)
    return deep_in


class LogisticRegression(nn.Module):
    """Sum of the per-feature weights, plus ``Dense_0`` over the dense
    features when there are any, plus ``bias``."""

    def __init__(self, feature_names: Sequence[str], num_dense: int = 13):
        super().__init__()
        self.feature_names = tuple(feature_names)
        if num_dense:
            self.Dense_0 = nn.Linear(num_dense, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, dense, rows):
        logit = _linear_term(rows, self.feature_names)
        if dense is not None:
            logit = logit + _dense(self.Dense_0, dense).reshape(-1)
        return logit + self.bias[0]


class WideDeep(nn.Module):
    """Wide&Deep: the linear term plus an MLP over the field embeddings
    and the dense features."""

    def __init__(self, feature_names: Sequence[str], embedding_dim: int,
                 num_dense: int = 13,
                 dnn_units: Tuple[int, ...] = (256, 128)):
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.MLP_0 = MLP(len(self.feature_names) * embedding_dim + num_dense,
                         dnn_units)
        self.Dense_0 = nn.Linear(self.MLP_0.out_features, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, dense, rows):
        wide = _linear_term(rows, self.feature_names)
        fields = _stack_fields(rows, self.feature_names)
        deep = self.MLP_0(_deep_input(fields, dense))
        deep_logit = _dense(self.Dense_0, deep).reshape(-1)
        return wide + deep_logit.to(wide.dtype) + self.bias[0]


class DeepFM(nn.Module):
    """DeepFM: the linear term, the FM second-order term
    ``0.5·Σ_d((Σ_f x)² − Σ_f x²)`` and an MLP, over shared field
    embeddings."""

    def __init__(self, feature_names: Sequence[str], embedding_dim: int,
                 num_dense: int = 13,
                 dnn_units: Tuple[int, ...] = (256, 128)):
        super().__init__()
        self.feature_names = tuple(feature_names)
        self.MLP_0 = MLP(len(self.feature_names) * embedding_dim + num_dense,
                         dnn_units)
        self.Dense_0 = nn.Linear(self.MLP_0.out_features, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, dense, rows):
        linear = _linear_term(rows, self.feature_names)
        fields = _stack_fields(rows, self.feature_names)      # [B, F, k]
        sum_f = torch.sum(fields, dim=1)
        fm = 0.5 * torch.sum(sum_f * sum_f
                             - torch.sum(fields * fields, dim=1), dim=-1)
        deep = self.MLP_0(_deep_input(fields, dense))
        deep_logit = _dense(self.Dense_0, deep).reshape(-1)
        return linear + fm + deep_logit.to(linear.dtype) + self.bias[0]


MODELS = {"lr": LogisticRegression, "wdl": WideDeep, "deepfm": DeepFM}


def build_model(name: str, feature_names: Sequence[str], **kwargs):
    """``"lr"``, ``"wdl"`` or ``"deepfm"`` over ``feature_names``; the
    keywords go to the model's constructor."""
    if name in ("xdeepfm", "dcn"):
        raise not_ported(f"model {name!r}", "xDeepFM and DCN models")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{sorted(MODELS) + ['dcn', 'xdeepfm']}")
    return MODELS[name](feature_names=tuple(feature_names), **kwargs)


def init_params(module: nn.Module, rng, device=None
                ) -> Dict[str, torch.Tensor]:
    """Initial values for every parameter of ``module`` on ``device``, as
    flax's ``module.init(rng, ...)`` gives them: each linear layer's
    kernel is ``lecun_normal`` (a normal truncated at +-2, times
    ``sqrt(1 / fan_in) / 0.87962566``, in float32 as JAX computes it),
    drawn from the key flax's ``make_rng`` gives the layer's first
    parameter (:func:`flax_param_key` of its path, ``interop.flax_path``),
    as a flat ``[in, out]`` array (KI's array mode on the card), and
    stored transposed as the torch ``weight``; every bias is zero. ``rng``
    is a threefry key (``prng_key(seed)``); the values do not depend on
    the device."""
    device = resolve_device(device)
    out = {}
    for name, p in module.named_parameters():
        path = flax_path(name)
        if path[-1] != "kernel":
            out[name] = torch.zeros(p.shape, dtype=p.dtype, device=device)
            continue
        fan_out, fan_in = p.shape
        std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(_TRUNC_STD)
        kernel = Normal(stddev=float(std), truncated=True).init(
            flax_param_key(rng, path[:-1], 1), (fan_in, fan_out), p.dtype,
            device)
        out[name] = kernel.t().contiguous()
    return out
