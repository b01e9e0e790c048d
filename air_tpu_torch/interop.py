"""Carry the JAX package's parameters into the port.

The JAX package keeps its parameters as a tree of dicts and lists of arrays
(``air_tpu.models.air.init_air_params``), and its checkpoints store that tree
flattened (``air_tpu_torch.train.checkpoint.load_params`` reads it back as
numpy). ``params_from_jax`` turns such a tree, with numpy leaves, into the
same tree of float32 torch tensors on ``device``. Dense ``w`` stays
``[in, out]`` (the port computes ``x @ w``); convolution kernels go from
JAX's HWIO to PyTorch's OIHW.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    """Tree of numpy arrays in the JAX package's layout -> torch params."""
    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, (*path, k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, (*path, i)) for i, v in enumerate(node)]
        arr = np.asarray(node, dtype=np.float32)
        if path[0] == "cnn" and path[-1] == "w":
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        return torch.tensor(arr, device=device)
    return convert(tree, ())
