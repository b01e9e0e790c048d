"""Data- and model-parallel train and eval steps.

Counterpart of ``air_tpu/parallel/train_parallel.py``. Each rank of a
``Mesh`` runs the step on its rows of the global batch (``shard_batch``)
with the params of its model index (``shard_state``: replicated at a model
axis of 1); the gradients and the forward metrics are averaged over the
data axis (``steps.make_train_step(pmean_axis=mesh)``), as the JAX
package's jitted step averages them over its ``data`` axis. Every rank
draws the global batch's noise and keeps its rows, so the step computes the
single-card step on the whole batch up to the order of the sums.
"""

from __future__ import annotations

import torch

from air_tpu_torch.models.air import AIROutputs, draw_noise
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.parallel.collectives import gather_slices, model_axis
from air_tpu_torch.parallel.mesh import Mesh, shard_batch
from air_tpu_torch.train.steps import (local_noise, make_eval_step,
                                       make_train_step)

__all__ = ["make_parallel_eval_step", "make_parallel_train_step",
           "shard_batch"]


def make_parallel_train_step(config: AIRConfig, mesh: Mesh,
                             with_grad_stats: bool = False, bg_image=None,
                             bg_schedule=None):
    """``train_step(state, images, targets, knobs=None, noise=None) ->
    (state, metrics)`` of one rank: ``images`` and ``targets`` its rows
    (``shard_batch``), ``state`` replicated or ``shard_state``'s, ``noise``
    (optional) the GLOBAL batch's draws. The metrics come back averaged
    over the data axis, the same on every rank."""
    return make_train_step(config, bg_image=bg_image,
                           bg_schedule=bg_schedule,
                           with_grad_stats=with_grad_stats, pmean_axis=mesh)


def make_parallel_eval_step(config: AIRConfig, mesh: Mesh):
    """``eval_step(params, images, targets, step, generator=None,
    noise=None) -> AIROutputs`` of one rank: the eval forward on its rows,
    with its rows of the global batch's draws (from ``generator``, or the
    global ``noise``). The per-example outputs are gathered over the data
    axis (each rank returns the whole batch's, exactly), and the loss and
    accuracy are computed from them, the same on every rank."""
    eval_fn = make_eval_step(config)

    def eval_step(params, images, targets, step, generator=None,
                  noise=None) -> AIROutputs:
        rows = images.shape[0]
        if noise is None:
            noise = draw_noise(config, rows * mesh.data, generator,
                               images.device)
        with model_axis(mesh):
            out = eval_fn(params, images, targets, step,
                          noise=local_noise(noise, mesh))
        full = {f: gather_slices(getattr(out, f), mesh, "data", 0)
                for f in AIROutputs._fields if f not in ("loss", "accuracy")}
        right = gather_slices(
            (targets.to(torch.int32) == out.rec_num_digits).to(torch.float32),
            mesh, "data", 0)
        return AIROutputs(**full, loss=full["per_example_loss"].mean(),
                          accuracy=right.mean())

    return eval_step
