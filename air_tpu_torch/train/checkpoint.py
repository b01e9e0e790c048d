"""Read the JAX package's checkpoints with numpy alone.

Counterpart of ``load_params`` and ``checkpoint_arch`` in
``air_tpu/train/checkpoint.py``. A checkpoint is an ``.npz`` of
path-flattened arrays: parameters under ``params/<path>``, lists flattened
by index; everything else (``step``, optimizer leaves, the key) is skipped
here. ``load_params`` returns the parameter tree with numpy leaves in the
JAX package's layout; ``air_tpu_torch.interop.params_from_jax`` turns it
into torch tensors.
"""

from __future__ import annotations

import numpy as np


def _listify(node):
    """Convert {'0': ..., '1': ...} dicts (from flattened lists) to lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def load_params(path: str) -> dict:
    """The parameter tree of a checkpoint, numpy leaves."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if not key.startswith("params/"):
                continue
            parts = key[len("params/"):].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return _listify(tree)


def checkpoint_arch(path: str) -> dict:
    """Architecture flags inferable from a checkpoint's keys:
    {"cnn": bool, "learn_background": bool}."""
    with np.load(path) as z:
        keys = set(z.files)
    return {
        "cnn": any(k.startswith("params/cnn/") for k in keys),
        "learn_background": "params/background" in keys,
    }
