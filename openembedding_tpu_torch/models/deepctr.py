"""CTR models: LR, Wide&Deep, DeepFM, xDeepFM and DCN as ``torch.nn``
modules (``openembedding_tpu/models/deepctr.py``).

The modules hold only the dense maths. The ``EmbeddingCollection`` pulls
the embedding rows outside the module and passes them in as a dict: per
feature ``rows[name] -> [B, dim]`` and ``rows[name + ":linear"] -> [B,
1]``, or fused ``rows["fields"] -> [B, F, dim]`` and
``rows["fields:linear"] -> [B, F, 1]``. The arithmetic is the JAX
modules', term for term, except xDeepFM's default CIN, which is DeepCTR's
(split half and a per-map bias; ``cin_split_half=False, cin_bias=False``
gives the JAX package's).

Two differences follow from torch. A linear layer takes its input width
when it is built (torch has no lazy ``nn.Dense``), so a model takes the
embedding width and the number of dense features. And the parameters keep
flax's names (``MLP_0.Dense_0``, ``Dense_0``, ``CIN_0.cin_w_0``,
``CrossNet_0.cross_w_0``, ``bias``) and shapes, with a flax ``kernel``
``[in, out]`` stored as the torch ``weight`` ``[out, in]`` (a
``self.param`` array such as ``cin_w_0`` keeps its flax shape), so
``interop.dense_params_from_flax`` maps one onto the other by name; a
module registers its parameters in flax's order of creation. DeepCTR's
CIN has no flax twin: its filters are linear maps ``CIN_0.conv_<k>``.
:func:`init_params` draws flax's initial values from flax's keys: each
parameter's flax initializer (``lecun_normal`` kernels,
``glorot_uniform`` CIN and cross weights, zeros), equal to
``module.init``'s.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..embedding import EmbeddingSpec
from ..fused import FUSED_NAME, LINEAR_SUFFIX
from ..interop import flax_path
from ..optim.initializers import Normal, Uniform, flax_param_key
from ..utils.device import resolve_device
from ..utils.observability import stage, stage_grad

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


class CIN(nn.Module):
    """Compressed Interaction Network, xDeepFM's core block (Lian et al.,
    2018). Each layer takes the outer products of the maps ``x_k`` it is
    given and the fields ``x_0`` (``z[b, i, j, d] = x_k[b, i, d] *
    x_0[b, j, d]``, flattened to ``[B, H_k·F, D]`` with ``n = i·F + j``),
    compresses them to ``h`` maps (a 1x1 convolution over ``n``) and
    applies ReLU; the maps each layer pools are summed over ``d``, and the
    pooled maps concatenated.

    ``bias=True`` is DeepCTR's ``CIN`` (``deepctr/layers/interaction.py``):
    each layer's filter and per-map bias are a linear map ``conv_<k>``,
    ``.weight [h, H_k·F]`` (glorot_uniform, as DeepCTR draws its filters)
    and ``.bias [h]`` (zeros). DeepCTR flattens the pairs field-major
    (``n = j·H_k + i``); here every form is map-major, a fixed permutation
    of the filter's columns that changes no sum. ``bias=False`` is the JAX
    package's CIN: ``cin_w_<k>`` ``[H_k·F, h]`` in flax's shape and order,
    no bias.

    ``split_half`` (DeepCTR's ``split_half``): a layer other than the last
    passes its first ``h / 2`` maps on as the next ``x_k`` and pools the
    other half (so its ``h`` must be even); the last pools all of its
    maps. Without it every layer passes all of its maps on and pools them
    all, as the JAX package's CIN does.

    The maps are kept as ``[B, D, ·]``, so each layer's compression is one
    ``[B·D, H_k·F] x [H_k·F, h]`` matrix product in float32, the same sums
    as JAX's ``einsum("bnd,nh->bhd")`` in another order."""

    def __init__(self, num_fields: int, layer_sizes: Sequence[int],
                 split_half: bool = True, bias: bool = True):
        super().__init__()
        self.flax_init = {}
        self.split_half = split_half
        self.sizes = tuple(int(h) for h in layer_sizes)
        hk, pooled = num_fields, 0
        for k, h in enumerate(self.sizes):
            split = split_half and k < len(self.sizes) - 1
            if split and h % 2:
                raise ValueError("with split_half every CIN layer but the "
                                 f"last needs an even size, not {h}")
            if bias:
                conv = nn.Linear(hk * num_fields, h)
                conv.flax_init = {"weight": "glorot_uniform"}
                self.add_module(f"conv_{k}", conv)
            else:
                name = f"cin_w_{k}"
                self.register_parameter(
                    name, nn.Parameter(torch.zeros(hk * num_fields, h)))
                self.flax_init[name] = "glorot_uniform"
            hk = h // 2 if split else h          # passed on, and pooled
            pooled += hk
        self.out_features = pooled

    def _compress(self, k: int, z: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv_{k}", None)
        if conv is not None:
            return nn.functional.linear(z.to(conv.weight.dtype), conv.weight,
                                        conv.bias)
        w = getattr(self, f"cin_w_{k}")
        return z.to(w.dtype) @ w

    def forward(self, x0):                                    # [B, F, D]
        b, f, d = x0.shape
        x0t = x0.transpose(1, 2)                              # [B, D, F]
        xk = x0t
        pooled = []
        for k, h in enumerate(self.sizes):
            z = (xk[:, :, :, None] * x0t[:, :, None, :]).reshape(b * d, -1)
            maps = torch.relu(self._compress(k, z)).reshape(b, d, h)
            if self.split_half and k < len(self.sizes) - 1:
                xk, direct = maps[..., :h // 2], maps[..., h // 2:]
            else:
                xk = direct = maps
            pooled.append(torch.sum(direct, dim=1))           # [B, ·]
        return torch.cat(pooled, dim=-1)


class XDeepFM(nn.Module):
    """xDeepFM: the linear term, a ``Dense`` over the CIN's pooled maps
    and an MLP over the field embeddings and the dense features.

    By default its CIN is DeepCTR's ``xDeepFM``'s (``cin_split_half``,
    a per-map ``cin_bias``, layers (128, 128)); with both flags False it
    is the JAX package's. In an armed step program the CIN's forward is
    the stage ``dense.cin`` and its backward ``dense.cin_grad``
    (``utils/observability.py``)."""

    def __init__(self, feature_names: Sequence[str], embedding_dim: int,
                 num_dense: int = 13,
                 dnn_units: Tuple[int, ...] = (256, 128),
                 cin_layer_sizes: Tuple[int, ...] = (128, 128),
                 cin_split_half: bool = True, cin_bias: bool = True):
        super().__init__()
        self.feature_names = tuple(feature_names)
        num_fields = len(self.feature_names)
        self.CIN_0 = CIN(num_fields, cin_layer_sizes, cin_split_half,
                         cin_bias)
        self.Dense_0 = nn.Linear(self.CIN_0.out_features, 1)
        self.MLP_0 = MLP(num_fields * embedding_dim + num_dense, dnn_units)
        self.Dense_1 = nn.Linear(self.MLP_0.out_features, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, dense, rows):
        linear = _linear_term(rows, self.feature_names)
        fields = _stack_fields(rows, self.feature_names)
        stage("dense.cin")
        x0 = stage_grad(fields.to(self.Dense_0.weight.dtype), "dense")
        cin_out = stage_grad(self.CIN_0(x0), "dense.cin_grad")
        stage("dense")
        cin_logit = _dense(self.Dense_0, cin_out).reshape(-1)
        deep = self.MLP_0(_deep_input(fields, dense))
        deep_logit = _dense(self.Dense_1, deep).reshape(-1)
        return (linear + cin_logit.to(linear.dtype)
                + deep_logit.to(linear.dtype) + self.bias[0])


class CrossNet(nn.Module):
    """DCN's cross layers: ``x_{k+1} = x_0 · (x_k @ cross_w_k) + cross_b_k
    + x_k``, with ``cross_w_k`` ``[d, 1]`` and ``cross_b_k`` ``[d]``."""

    def __init__(self, width: int, num_layers: int = 3):
        super().__init__()
        self.flax_init = {}
        for k in range(num_layers):
            self.register_parameter(f"cross_w_{k}",
                                    nn.Parameter(torch.zeros(width, 1)))
            self.register_parameter(f"cross_b_{k}",
                                    nn.Parameter(torch.zeros(width)))
            self.flax_init[f"cross_w_{k}"] = "glorot_uniform"
        self.num_layers = num_layers

    def forward(self, x0):                                    # [B, d]
        x = x0
        for k in range(self.num_layers):
            w = getattr(self, f"cross_w_{k}")
            b = getattr(self, f"cross_b_{k}")
            xw = (x.to(w.dtype) @ w).to(x0.dtype)             # [B, 1]
            x = x0 * xw + b.to(x0.dtype) + x
        return x


class DCN(nn.Module):
    """Deep & Cross Network: a ``CrossNet`` and an MLP over the flattened
    field embeddings and the dense features, then one ``Dense``."""

    def __init__(self, feature_names: Sequence[str], embedding_dim: int,
                 num_dense: int = 13, cross_layers: int = 3,
                 dnn_units: Tuple[int, ...] = (256, 128)):
        super().__init__()
        self.feature_names = tuple(feature_names)
        width = len(self.feature_names) * embedding_dim + num_dense
        self.CrossNet_0 = CrossNet(width, cross_layers)
        self.MLP_0 = MLP(width, dnn_units)
        self.Dense_0 = nn.Linear(width + self.MLP_0.out_features, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, dense, rows):
        fields = _stack_fields(rows, self.feature_names)
        x0 = _deep_input(fields, dense)
        cross = self.CrossNet_0(x0)
        deep = self.MLP_0(x0)
        out = torch.cat([cross, deep.to(cross.dtype)], dim=-1)
        logit = _dense(self.Dense_0, out).reshape(-1)
        return logit.to(torch.float32) + self.bias[0]


MODELS = {"lr": LogisticRegression, "wdl": WideDeep, "deepfm": DeepFM,
          "xdeepfm": XDeepFM, "dcn": DCN}


def build_model(name: str, feature_names: Sequence[str], **kwargs):
    """``"lr"``, ``"wdl"``, ``"deepfm"``, ``"xdeepfm"`` or ``"dcn"`` over
    ``feature_names``; the keywords go to the model's constructor."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; known: {sorted(MODELS)}")
    return MODELS[name](feature_names=tuple(feature_names), **kwargs)


def _flax_initializer(owner: nn.Module, leaf: str) -> str:
    """The flax initializer of parameter ``leaf`` of module ``owner``: a
    ``Dense`` kernel is ``lecun_normal`` and its bias zeros; a module's own
    ``self.param`` arrays, and a linear map that is no ``Dense`` (a CIN
    filter), name theirs in ``flax_init`` (zeros if absent)."""
    default = "zeros"
    if isinstance(owner, nn.Linear) and leaf == "weight":
        default = "lecun_normal"
    return getattr(owner, "flax_init", {}).get(leaf, default)


def init_params(module: nn.Module, rng, device=None, *,
                dense_ids=None) -> Dict[str, torch.Tensor]:
    """Initial values for every parameter of ``module`` on ``device``, as
    flax's ``module.init(rng, ...)`` gives them. Each parameter is drawn
    from the key flax's ``make_rng`` hands it (:func:`flax_param_key` of
    its scope's path, ``interop.flax_path``, and its counter: its place
    among the scope's ``self.param`` calls, which the torch module
    registers in that order) by its flax initializer, as a flat array in
    flax's shape (KI's array mode on the card):

    - ``lecun_normal``: a normal truncated at +-2, times ``sqrt(1 /
      fan_in) / 0.87962566``, in float32 as JAX computes it; a ``Dense``
      kernel ``[in, out]``, stored transposed as the torch ``weight``;
    - ``glorot_uniform``: ``uniform(-1, 1) * sqrt(3 / ((fan_in +
      fan_out) / 2))``, the uniform draw as ``jax.random.uniform``
      compiles it and the scale as flax applies it, one float32 multiply
      (``fan_in, fan_out`` are the last two dims);
    - ``zeros``;
    - a dense-kept table of a ``hybrid.HybridModel``: its spec's
      initializer (``DenseEmbeddings.initializer``), as flax's
      ``DenseEmbeddings`` draws it.

    flax creates a dense-kept table only for a column of the sample
    batch, so its counter is its place among those columns in spec
    order: ``dense_ids`` names them (all tables if None), and a table not
    among them is left out of the result, as out of flax's tree.

    ``rng`` is a threefry key (``prng_key(seed)``); the values do not
    depend on the device."""
    from ..hybrid import DenseEmbeddings
    device = resolve_device(device)
    out = {}
    for name, p in module.named_parameters():
        path = flax_path(name)
        scope, _, leaf = name.rpartition(".")
        owner = module.get_submodule(scope)
        if isinstance(owner, DenseEmbeddings):
            made = [s.name for s in owner.specs
                    if dense_ids is None or s.name in dense_ids]
            if leaf in made:
                key = flax_param_key(rng, path[:-1], made.index(leaf) + 1)
                out[name] = owner.initializer(leaf).init(
                    key, tuple(p.shape), p.dtype, device)
            continue
        kind = _flax_initializer(owner, leaf)
        if kind == "zeros":
            out[name] = torch.zeros(p.shape, dtype=p.dtype, device=device)
            continue
        own = [k for k, _ in owner.named_parameters(recurse=False)]
        key = flax_param_key(rng, path[:-1], own.index(leaf) + 1)
        if kind == "lecun_normal":
            fan_out, fan_in = p.shape
            std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(_TRUNC_STD)
            kernel = Normal(stddev=float(std), truncated=True).init(
                key, (fan_in, fan_out), p.dtype, device)
            out[name] = kernel.t().contiguous()
            continue
        fan_in, fan_out = p.shape[-2:]
        variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
        scale = np.sqrt(np.float32(3) * variance)
        out[name] = Uniform(-1.0, 1.0).init(key, tuple(p.shape), p.dtype,
                                            device) * float(scale)
    return out
