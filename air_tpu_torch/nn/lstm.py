"""LSTM cell with one fused gate product.

Counterpart of ``air_tpu/nn/lstm.py`` (TF1 ``BasicLSTMCell`` semantics):
``gates = [x, h] @ W + b`` split into (i, j, f, o), ``forget_bias = 1.0``
added to the forget gate, tanh cell nonlinearity. ``torch.nn.LSTM`` orders
its gates and biases differently, so it is not used.

Every step computes at the dtype of its inputs and of the params it is
given (the caller casts both under ``compute_dtype="bfloat16"``). Under a
model axis the gate kernel may be this rank's column slice: all four gates
are gathered (``nn.layers.matmul``) before they are split, and the hoisted
input projection row-slices the column slice.
"""

from __future__ import annotations

import torch

from air_tpu_torch.nn.layers import glorot_uniform, matmul


def lstm_init(generator: torch.Generator, input_dim: int, units: int) -> dict:
    return {
        "kernel": glorot_uniform(generator, (input_dim + units, 4 * units)),
        "bias": torch.zeros((4 * units,), dtype=torch.float32,
                            device=generator.device),
    }


def lstm_zero_state(batch_size: int, units: int, device,
                    dtype=torch.float32) -> tuple:
    zeros = torch.zeros((batch_size, units), dtype=dtype, device=device)
    return zeros, zeros.clone()


def lstm_apply(params: dict, state, x: torch.Tensor,
               forget_bias: float = 1.0):
    """One LSTM step. state = (c, h); returns (output h', new_state)."""
    c, h = state
    bias = params["bias"]
    gates = matmul(torch.cat([x, h], dim=-1), params["kernel"],
                   bias.shape[-1]) + bias
    return _gates_to_state(gates, c, forget_bias)


def _gates_to_state(gates, c, forget_bias):
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = (c * torch.sigmoid(f + forget_bias)
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_h, (new_c, new_h)


def lstm_input_proj(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The input half of the gate product, ``x @ W[:in_dim] + b``, computed
    once for an input that every step feeds unchanged (AIR's recurrence
    sees the same image encoding at each attention step). Same algebra as
    :func:`lstm_apply` up to float reassociation. ``W[:in_dim]`` is a slice
    of the one kernel, so autograd's gradient reaches that leaf."""
    in_dim, bias = x.shape[-1], params["bias"]
    return matmul(x, params["kernel"][:in_dim], bias.shape[-1]) + bias


def lstm_apply_hoisted(params: dict, state, x_proj: torch.Tensor,
                       forget_bias: float = 1.0):
    """One LSTM step from :func:`lstm_input_proj` (which carries the bias):
    reads only the recurrent ``[units, 4 * units]`` half of the kernel."""
    c, h = state
    units = h.shape[-1]
    gates = x_proj + matmul(h, params["kernel"][-units:], 4 * units)
    return _gates_to_state(gates, c, forget_bias)
