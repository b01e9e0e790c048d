"""Dense layers, MLPs and the two-layer heads over parameter dicts.

Counterpart of ``air_tpu/nn/layers.py``. A dense layer is ``{"w": [in, out],
"b": [out]}`` applied as ``x @ w + b``, the JAX package's layout, so that
checkpoints carry over unchanged (``air_tpu_torch.interop``).

The init functions draw from an explicit ``torch.Generator`` on the device
the parameters are made on (glorot-uniform weights, zero biases, as the JAX
package initialises them). The draws differ from ``jax.random``'s; the
tests compare shapes, dtypes and bounds.

Under a model axis (``air_tpu_torch.parallel``) a kernel may be this
rank's column slice: ``matmul`` gathers its product. Without one every
product is the plain ``x @ w``, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from air_tpu_torch.parallel.collectives import column_parallel


def uniform(generator: torch.Generator, shape, limit: float) -> torch.Tensor:
    """float32 draws in [-limit, limit) on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (2.0 * limit) - limit


def glorot_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    return uniform(generator, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int) -> dict:
    return {
        "w": glorot_uniform(generator, (in_dim, out_dim)),
        "b": torch.zeros((out_dim,), dtype=torch.float32,
                         device=generator.device),
    }


def mlp_init(generator: torch.Generator, in_dim: int, hidden_dims) -> list:
    """Stack of dense layers; a list of per-layer param dicts."""
    dims = [in_dim, *hidden_dims]
    return [dense_init(generator, d_in, d_out)
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def two_layer_head_init(generator: torch.Generator, in_dim: int, hidden: int,
                        out_dim: int) -> dict:
    """hidden (relu) -> linear output: the per-quantity head of the model."""
    return {
        "hidden": dense_init(generator, in_dim, hidden),
        "out": dense_init(generator, hidden, out_dim),
    }


def matmul(x: torch.Tensor, w: torch.Tensor, out_dim: int) -> torch.Tensor:
    """``x @ w`` for a kernel of ``out_dim`` columns; ``w`` holding fewer is
    this rank's column slice under the model axis, whose product is
    gathered (``parallel.collectives.column_parallel``, which raises for a
    width that is not ``out_dim / model``)."""
    if w.shape[-1] == out_dim:
        return x @ w
    return column_parallel(x, w, out_dim)


def dense_apply(params: dict, x: torch.Tensor, activation=None) -> torch.Tensor:
    """``x @ w + b`` at the dtype of ``x`` and of the params (the caller
    casts the params to the compute dtype). Under the model axis a
    column-sharded ``w`` (its columns fewer than ``b``'s, which stays
    whole) gives its slice, gathered before the bias."""
    b = params["b"]
    y = matmul(x, params["w"], b.shape[-1]) + b
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
