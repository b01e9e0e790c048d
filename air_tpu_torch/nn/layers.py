"""Dense layers, MLPs and the two-layer heads over parameter dicts.

Counterpart of ``air_tpu/nn/layers.py``. A dense layer is ``{"w": [in, out],
"b": [out]}`` applied as ``x @ w + b``, the JAX package's layout, so that
checkpoints carry over unchanged (``air_tpu_torch.interop``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_apply(params: dict, x: torch.Tensor, activation=None) -> torch.Tensor:
    y = x @ params["w"] + params["b"]
    if activation is not None:
        y = activation(y)
    return y


def mlp_apply(params, x: torch.Tensor, activation=F.relu) -> torch.Tensor:
    """A stack of dense layers with ``activation`` after every layer."""
    for layer in params:
        x = dense_apply(layer, x, activation)
    return x


def two_layer_head_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """hidden (relu) -> linear output: the per-quantity head of the model."""
    h = dense_apply(params["hidden"], x, F.relu)
    return dense_apply(params["out"], h, None)
