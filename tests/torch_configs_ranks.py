"""The function that tests/test_torch_configs.py runs in its spawned ranks
(``air_tpu_torch.parallel.launch``): the model axis at the scaled
configuration's shapes. Imports no JAX, and only what the step needs, so
that the four ranks start quickly: the ranks import this module by name."""

from __future__ import annotations

import numpy as np
import torch

from air_tpu_torch.models.air import draw_noise
from air_tpu_torch.parallel.mesh import (make_mesh, param_sharding,
                                         shard_batch, shard_state)
from air_tpu_torch.parallel.train_parallel import make_parallel_train_step
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import make_train_step, step_generator
from air_tpu_torch.tree import tree_leaves, tree_leaves_with_path


def world4_scaled(rank, device, cfg, batch):
    """Data 2 x model 2 at the scaled configuration's shapes: the state
    made here from seed 0 and sharded, one step against the single-process
    step on the whole batch with the same draws (each rank holds its own
    shards against the matching columns). Every rank makes the same batch
    and draws from seeds: arrays passed to the ranks slow their start by
    seconds. Returns the layout before and after the step and the largest
    differences, as numbers."""
    torch.set_num_threads(2)
    mesh = make_mesh(4, model_axis=2)
    full = create_train_state(cfg, seed=0, device=device)
    placed = param_sharding(mesh, cfg)
    state = shard_state(mesh, full)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(
        size=(batch, cfg.canvas_size ** 2)).astype(np.float32))
    digits = torch.from_numpy(rng.integers(0, 3, batch).astype(np.int32))
    noise = draw_noise(cfg, batch, step_generator(0, 0, device), device)
    new, metrics = make_parallel_train_step(cfg, mesh, with_grad_stats=True)(
        state, *shard_batch(mesh, images, digits), noise=noise)
    want, want_m = make_train_step(cfg, with_grad_stats=True)(
        full, images, digits, noise=noise)

    def worst(got_tree, want_tree, relative):
        err = 0.0
        for t, w, p in zip(tree_leaves(got_tree), tree_leaves(want_tree),
                           placed):
            if p is not None:
                w = w.narrow(-1, mesh.model_rank * t.shape[-1], t.shape[-1])
            scale = max(1.0, float(w.abs().max())) if relative else 1.0
            err = max(err, float((t.float() - w.float()).abs().max()) / scale)
        return err

    def shapes(tree):
        return {"/".join(map(str, p)): tuple(t.shape)
                for p, t in tree_leaves_with_path(tree)}

    return {"placed": placed, "before": shapes(state.params),
            "after": shapes(new.params), "mu": shapes(new.opt_state.mu),
            "loss": (float(metrics["loss"]), float(want_m["loss"])),
            "grads": {k: worst(metrics["grad_tensors"][k],
                               want_m["grad_tensors"][k], True)
                      for k in ("original", "applied")},
            "params": worst(new.params, want.params, False)}
