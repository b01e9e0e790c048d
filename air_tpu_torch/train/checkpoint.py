"""Checkpoints in the JAX package's format, written and read with numpy.

Counterpart of ``air_tpu/train/checkpoint.py``. A checkpoint is
``<prefix>-<step>.npz`` of path-flattened arrays plus a JSON sidecar:

  * ``params/<path>``, lists flattened by index, in the JAX package's layout
    (convolution kernels HWIO);
  * ``opt/<i>``, the optimizer's leaves in optax's ``tree_leaves`` order of
    the same chain (``air_tpu_torch.interop.opt_state_to_jax``); a bfloat16
    leaf is stored as its uint16 bit patterns under ``opt/<i>:bf16``;
  * ``step``.

The sidecar is written first and the ``.npz`` renamed into place last, so a
kill mid-save never exposes a checkpoint without its sidecar. It holds the
loader's position (``loader_state``, which ``load_checkpoint`` restores into
a loader it is given) and the trainer's stall-recovery bookkeeping
(``recovery``), as the JAX package's does. The port's ``seed`` goes in the
sidecar too; the JAX package's PRNG ``key`` entry is
neither written nor needed (its ``load_checkpoint`` then takes a fresh key).
The JAX package's ``load_checkpoint`` reads what ``save_checkpoint`` writes,
and ``load_checkpoint`` here reads the JAX package's checkpoints, optimizer
state included.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from air_tpu_torch.interop import (bf16_from_bits, bf16_to_bits,
                                   opt_state_from_jax, opt_state_to_jax,
                                   params_from_jax, params_to_jax)
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.parallel.mesh import gather_state, shard_state
from air_tpu_torch.train.state import TrainState, create_train_state
from air_tpu_torch.tree import tree_leaves


def _dtypes(tree) -> list:
    return [t.dtype for t in tree_leaves(tree)]


def _sidecar(path: str) -> str:
    """The .json metadata path of a .npz checkpoint path."""
    return os.path.splitext(path)[0] + ".json"


def _flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flatten(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _listify(node):
    """Convert {'0': ..., '1': ...} dicts (from flattened lists) to lists."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def _unflatten_params(arrays: dict) -> dict:
    tree: dict = {}
    for key, value in arrays.items():
        if not key.startswith("params/"):
            continue
        parts = key[len("params/"):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _listify(tree)


def load_params(path: str) -> dict:
    """The parameter tree of a checkpoint, numpy leaves, the JAX package's
    layout (``interop.params_from_jax`` makes torch params of it)."""
    with np.load(path) as z:
        return _unflatten_params({k: z[k] for k in z.files
                                  if k.startswith("params/")})


def checkpoint_arch(path: str) -> dict:
    """Architecture flags inferable from a checkpoint's keys:
    {"cnn": bool, "learn_background": bool}."""
    with np.load(path) as z:
        keys = set(z.files)
    return {
        "cnn": any(k.startswith("params/cnn/") for k in keys),
        "learn_background": "params/background" in keys,
    }


def checkpoint_meta(path: str) -> dict:
    """The sidecar JSON of a checkpoint ({} if absent)."""
    meta_path = _sidecar(path)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def sorted_checkpoints(directory: str, prefix: str = "air-model") -> list:
    pat = re.compile(re.escape(prefix) + r"-(\d+)\.npz$")
    found = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = pat.match(name)
            if m:
                found.append((int(m.group(1)), os.path.join(directory, name)))
    return [p for _, p in sorted(found)]


def latest_checkpoint(directory: str, prefix: str = "air-model"):
    ckpts = sorted_checkpoints(directory, prefix)
    return ckpts[-1] if ckpts else None


def save_checkpoint(directory: str, state: TrainState, step: int | None = None,
                    loader_state: dict | None = None,
                    max_to_keep: int = 10000,
                    prefix: str = "air-model",
                    recovery: dict | None = None, mesh=None,
                    config: AIRConfig | None = None) -> str:
    """Write ``<directory>/<prefix>-<step>.npz`` and its sidecar; keep the
    newest ``max_to_keep``. ``recovery``: the trainer's stall-recovery
    bookkeeping (``Trainer.recovery_meta``), kept in the sidecar when given.
    Returns the checkpoint path.

    With a ``mesh`` (``air_tpu_torch.parallel.mesh.Mesh``) every rank calls
    it: the model axis's shards are gathered (``gather_state``; ``config``
    gives the full shapes) and rank 0 writes the single-card checkpoint,
    which both packages read."""
    if step is None:
        step = int(state.step)
    path = os.path.join(directory, f"{prefix}-{step}.npz")
    if mesh is not None:
        state = gather_state(mesh, state, config)
        if mesh.rank != 0:
            return path
    os.makedirs(directory, exist_ok=True)
    arrays = _flatten(params_to_jax(state.params), "params/")
    opt_leaves = opt_state_to_jax(state.opt_state)
    for i, leaf in enumerate(opt_leaves):
        if leaf.dtype == torch.bfloat16:
            arrays[f"opt/{i}:bf16"] = bf16_to_bits(leaf)
        else:
            arrays[f"opt/{i}"] = leaf.numpy()
    arrays["step"] = np.asarray(int(state.step), np.int32)

    meta = {"step": step, "loader_state": loader_state,
            "num_opt_leaves": len(opt_leaves), "seed": int(state.seed)}
    if recovery is not None:
        meta["recovery"] = recovery
    sidecar = _sidecar(path)
    with open(sidecar + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(sidecar + ".tmp", sidecar)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
    os.replace(path + ".tmp", path)

    for old in sorted_checkpoints(directory, prefix)[:-max_to_keep]:
        for p in (old, _sidecar(old)):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
    return path


def load_checkpoint(path: str, config: AIRConfig, loader=None, meta=None,
                    device="cuda", mesh=None) -> TrainState:
    """A TrainState on ``device`` from a checkpoint of either package.
    ``config`` gives the optimizer's structure: a params-only checkpoint
    gets a fresh optimizer state. The seed comes from the sidecar (0 for a
    checkpoint the JAX package wrote). ``loader`` (optional) is restored in
    place from the sidecar's ``loader_state``; ``meta`` is the sidecar when
    the caller has read it already (``checkpoint_meta``). With a ``mesh``
    the state comes back as this rank's part (``shard_state``)."""
    if meta is None:
        meta = checkpoint_meta(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = params_from_jax(_unflatten_params(arrays), device)
    state = create_train_state(config, seed=int(meta.get("seed", 0)),
                               params=params, device=device)
    n = sum(1 for k in arrays if k.startswith("opt/"))
    if n:
        leaves = [arrays[f"opt/{i}"] if f"opt/{i}" in arrays
                  else bf16_from_bits(arrays[f"opt/{i}:bf16"])
                  for i in range(n)]
        opt_state = opt_state_from_jax(leaves, params, device)
        fresh = state.opt_state
        if ((opt_state.schedule_count is None)
                != (fresh.schedule_count is None)
                or _dtypes(opt_state.mu) != _dtypes(fresh.mu)):
            raise ValueError(f"{path}: optimizer state does not match the "
                             "config's optimizer (learning-rate schedule or "
                             "adam_storage_dtype)")
        state = state.replace(opt_state=opt_state)
    if loader is not None and meta.get("loader_state"):
        loader.restore(meta["loader_state"])
    state = state.replace(step=int(arrays["step"]))
    if mesh is not None:
        state = shard_state(mesh, state)
    return state
