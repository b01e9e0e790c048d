"""Hyperparameter annealing schedules as functions of the global step.

Counterpart of ``air_tpu/ops/schedules.py``: ``tf.train.exponential_decay``
with optional ``min``/``max`` clamps, a final ``log``, a ``hold`` grace window
before the decay starts and an ``offset`` added last. Values are float32
0-d tensors, computed in float32 as the JAX package computes them.

Seed-parallel training resolves every replica at once: ``step`` may be an
[S] tensor (each replica's own clock) and a schedule's numeric fields [S]
tensors (its rotation knobs); each replica's value is then the one its
scalar step and fields give, bit for bit.
"""

from __future__ import annotations

import torch

EPS = 10e-10


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def exponential_decay(init, step, decay_steps, decay_rate,
                      staircase: bool = False) -> torch.Tensor:
    """init * decay_rate ** (step / decay_steps); staircase floors the
    exponent."""
    exponent = _f32(step) / decay_steps
    if staircase:
        exponent = torch.floor(exponent)
    return init * torch.pow(_f32(decay_rate), exponent)


def annealed_value(schedule: dict, step) -> torch.Tensor:
    """Resolve one annealing-schedule dict at ``step`` (a number or an [S]
    tensor; the numeric fields may be [S] tensors too)."""
    decay_step = torch.clamp(_f32(step) - schedule.get("hold", 0), min=0.0)
    value = exponential_decay(
        schedule["init"], decay_step, schedule["iters"], schedule["factor"],
        staircase=schedule.get("staircase", False),
    )
    if "min" in schedule:
        value = torch.maximum(value, _f32(schedule["min"]))
    if "max" in schedule:
        value = torch.minimum(value, _f32(schedule["max"]))
    if schedule.get("log", False):
        value = torch.log(value + EPS)
    return value + schedule.get("offset", 0.0)


def resolve_annealed(annealing_schedules: dict | None, defaults: dict,
                     step) -> dict:
    """Every annealable hyperparameter at ``step``: its static default, or
    its annealed value where a schedule names it."""
    resolved = dict(defaults)
    if annealing_schedules:
        for name, schedule in annealing_schedules.items():
            if name not in defaults:
                raise KeyError(f"unknown annealed hyperparameter: {name!r}")
            resolved[name] = annealed_value(schedule, step)
    return resolved
