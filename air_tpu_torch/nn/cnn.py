"""CNN encoder for the recurrent input.

Counterpart of ``air_tpu/nn/cnn.py``: three 5x5 SAME relu convolutions with
2x2 max-pools after the first two, flattened to ``(canvas // 4)**2 *
filters`` features. Weights are OIHW here (``interop.params_from_jax``
transposes the JAX package's HWIO). The features are flattened in NHWC
order, as the JAX package flattens them: the LSTM kernel's input rows are
laid out that way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv2d_same_relu(params: dict, x: torch.Tensor) -> torch.Tensor:
    return F.relu(F.conv2d(x, params["w"], params["b"], padding="same"))


def cnn_apply(params: dict, images: torch.Tensor, canvas_size: int,
              filters: int) -> torch.Tensor:
    """[B, canvas_size**2] flat images -> [B, feat] CNN features."""
    x = images.reshape(-1, 1, canvas_size, canvas_size)
    x = _conv2d_same_relu(params["conv1"], x)
    x = F.max_pool2d(x, 2)
    x = _conv2d_same_relu(params["conv2"], x)
    x = F.max_pool2d(x, 2)
    x = _conv2d_same_relu(params["conv3"], x)
    out_hw = canvas_size // 4
    return x.permute(0, 2, 3, 1).reshape(-1, out_hw * out_hw * filters)
