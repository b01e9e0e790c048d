"""Carry the JAX package's parameters and optimizer state into the port and
back.

The JAX package keeps its parameters as a tree of dicts and lists of arrays
(``air_tpu.models.air.init_air_params``), and its checkpoints store that tree
flattened (``air_tpu_torch.train.checkpoint.load_params`` reads it back as
numpy). ``params_from_jax`` turns such a tree, with numpy leaves, into the
same tree of float32 torch tensors on ``device``. Dense ``w`` stays
``[in, out]`` (the port computes ``x @ w``); convolution kernels go from
JAX's HWIO to PyTorch's OIHW, and so do their Adam moments
(``opt_state_from_jax``). ``params_to_jax`` and ``opt_state_to_jax`` go
back.
"""

from __future__ import annotations

import numpy as np
import torch

from air_tpu_torch.train.state import AdamState
from air_tpu_torch.tree import (tree_leaves_with_path, tree_map_with_path,
                                tree_unflatten)


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


def _is_conv_weight(path: tuple) -> bool:
    return path[0] == "cnn" and path[-1] == "w"


def params_to_jax(params) -> dict:
    """torch params -> the JAX package's tree of numpy arrays (convolution
    kernels back to HWIO)."""
    def convert(path, t):
        if _is_conv_weight(path):
            t = t.permute(2, 3, 1, 0)                 # OIHW -> HWIO
        return t.detach().cpu().numpy().copy()
    return tree_map_with_path(convert, params)


def _leaf_to_torch(leaf) -> torch.Tensor:
    """A numpy array (bfloat16 ones as numpy's 'bfloat16' dtype or as a
    torch bfloat16 tensor already) -> a CPU tensor of the same dtype."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return bf16_from_bits(arr.view(np.uint16))
    return torch.from_numpy(arr.copy())


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> a bfloat16 CPU tensor."""
    return torch.from_numpy(np.array(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16)


def bf16_to_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor -> its uint16 bit patterns."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def opt_state_from_jax(leaves, params, device="cuda") -> AdamState:
    """The JAX package's optimizer state, as the list of its leaves in
    ``jax.tree_util.tree_leaves`` order (what a checkpoint stores as
    ``opt/<i>``), -> the port's ``AdamState`` for ``params`` (torch, the
    port's layout). The chains of ``make_optimizer`` have the leaves
    ``count, *mu, *nu`` and, with a learning-rate schedule, the schedule's
    count last; bfloat16 moments stay bfloat16."""
    paths = [p for p, _ in tree_leaves_with_path(params)]
    n = len(paths)
    if len(leaves) not in (1 + 2 * n, 2 + 2 * n):
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} "
                         f"parameters: expected {1 + 2 * n} or {2 + 2 * n}")

    def moments(block):
        out = []
        for path, leaf in zip(paths, block):
            t = _leaf_to_torch(leaf)
            if _is_conv_weight(path):
                t = t.permute(3, 2, 0, 1)             # HWIO -> OIHW
            out.append(t.contiguous().to(device))
        return tree_unflatten(params, out)

    schedule_count = int(np.asarray(leaves[-1])) if len(leaves) == 2 + 2 * n \
        else None
    return AdamState(int(np.asarray(leaves[0])), moments(leaves[1:1 + n]),
                     moments(leaves[1 + n:1 + 2 * n]), schedule_count)


def opt_state_to_jax(opt_state: AdamState) -> list:
    """Inverse of ``opt_state_from_jax``: the leaves in the JAX package's
    order, CPU tensors (int32 counts, convolution moments in HWIO)."""
    def moments(tree):
        return [t.detach().permute(2, 3, 1, 0).contiguous().cpu()
                if _is_conv_weight(path) else t.detach().cpu()
                for path, t in tree_leaves_with_path(tree)]
    leaves = [torch.tensor(opt_state.count, dtype=torch.int32),
              *moments(opt_state.mu), *moments(opt_state.nu)]
    if opt_state.schedule_count is not None:
        leaves.append(torch.tensor(opt_state.schedule_count,
                                   dtype=torch.int32))
    return leaves
