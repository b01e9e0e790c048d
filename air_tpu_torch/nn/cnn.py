"""CNN encoder for the recurrent input.

Counterpart of ``air_tpu/nn/cnn.py``: three 5x5 SAME relu convolutions with
2x2 max-pools after the first two, flattened to ``(canvas // 4)**2 *
filters`` features. Weights are OIHW here (``interop.params_from_jax``
transposes the JAX package's HWIO). The features are flattened in NHWC
order, as the JAX package flattens them: the LSTM kernel's input rows are
laid out that way. The convolutions run at the dtype of the images and of
the params (the caller casts both, bfloat16 under
``compute_dtype="bfloat16"``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from air_tpu_torch.nn.layers import uniform


def _conv_init(generator: torch.Generator, kh: int, kw: int, c_in: int,
               c_out: int) -> dict:
    """OIHW weight, glorot-uniform over the receptive field, zero bias."""
    limit = math.sqrt(6.0 / (kh * kw * c_in + kh * kw * c_out))
    return {
        "w": uniform(generator, (c_out, c_in, kh, kw), limit),
        "b": torch.zeros((c_out,), dtype=torch.float32,
                         device=generator.device),
    }


def cnn_init(generator: torch.Generator, filters: int) -> dict:
    return {
        "conv1": _conv_init(generator, 5, 5, 1, filters),
        "conv2": _conv_init(generator, 5, 5, filters, filters),
        "conv3": _conv_init(generator, 5, 5, filters, filters),
    }


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
