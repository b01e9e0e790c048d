"""LSTM cell with one fused gate product.

Counterpart of ``air_tpu/nn/lstm.py`` (TF1 ``BasicLSTMCell`` semantics):
``gates = [x, h] @ W + b`` split into (i, j, f, o), ``forget_bias = 1.0``
added to the forget gate, tanh cell nonlinearity. ``torch.nn.LSTM`` orders
its gates and biases differently, so it is not used.
"""

from __future__ import annotations

import torch

from air_tpu_torch.nn.layers import glorot_uniform


def lstm_init(generator: torch.Generator, input_dim: int, units: int) -> dict:
    return {
        "kernel": glorot_uniform(generator, (input_dim + units, 4 * units)),
        "bias": torch.zeros((4 * units,), dtype=torch.float32,
                            device=generator.device),
    }


def lstm_zero_state(batch_size: int, units: int, device) -> tuple:
    zeros = torch.zeros((batch_size, units), dtype=torch.float32,
                        device=device)
    return zeros, zeros.clone()


def lstm_apply(params: dict, state, x: torch.Tensor,
               forget_bias: float = 1.0):
    """One LSTM step. state = (c, h); returns (output h', new_state)."""
    c, h = state
    gates = torch.cat([x, h], dim=-1) @ params["kernel"] + params["bias"]
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = (c * torch.sigmoid(f + forget_bias)
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, (new_c, new_h)
