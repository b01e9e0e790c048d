"""Eval step (the training step comes with the next slice of the port).

Counterpart of ``make_eval_step`` in ``air_tpu/train/steps.py``: the forward
pass with ``train=False`` (z_pres rounded) and the annealed hyperparameters
resolved at ``step``.
"""

from __future__ import annotations

import torch

from air_tpu_torch.models.air import AIROutputs, air_forward
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import resolve_annealed


def make_eval_step(config: AIRConfig):
    """Returns ``eval_step(params, images, targets, step, generator=None,
    noise=None) -> AIROutputs``, run without autograd."""

    def eval_step(params, images, targets, step, generator=None,
                  noise=None) -> AIROutputs:
        hp = resolve_annealed(config.schedules, config.annealable_defaults(),
                              step)
        with torch.no_grad():
            return air_forward(params, config, images, targets, train=False,
                               hparams=hp, noise=noise, generator=generator)

    return eval_step
