#!/usr/bin/env python3
"""The JAX package's reference for the length of chip_smoke.py's train phase.

    python3 scripts/jax_train_reference.py [--seeds 0 1]   # from the repo root

chip_smoke.py asks the mean reconstruction loss of the last 5 of its
TRAIN_STEPS train steps to fall below that of the first 5. This script runs
the JAX package (air_tpu, on the CPU) at the same configuration
(DEFAULT_TRAINING_CONFIG with cnn=True, st_impl="xla") on the same batch of
64 (the 60 canvases of air_tpu_torch/assets/serve_canvases.npz and their
first 4 again) for TRAIN_STEPS steps from its own init, once per seed, and
prints both means for each seed. It runs the full-width model: expect
minutes and a few GiB of memory. Writes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from air_tpu.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu.train.state import create_train_state  # noqa: E402
from air_tpu.train.steps import make_train_step  # noqa: E402
from chip_smoke import FIXTURE, TRAIN_STEPS  # noqa: E402


def reconstruction_losses(config, images, digits, seed: int,
                          steps: int) -> list[float]:
    """The reconstruction loss of each of ``steps`` train steps from
    create_train_state(config, rng=seed)."""
    state = create_train_state(config, rng=seed)
    step = make_train_step(config, donate=False)
    recons = []
    for _ in range(steps):
        state, metrics = step(state, images, digits)
        recons.append(float(metrics["reconstruction_loss"]))
    return recons


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    config = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl="xla")
    with np.load(FIXTURE) as z:
        c, d = z["canvases"], z["digits"]
    images = jnp.asarray(np.concatenate([c, c[:4]]))
    digits = jnp.asarray(np.concatenate([d, d[:4]]))
    for seed in args.seeds:
        recons = reconstruction_losses(config, images, digits, seed,
                                       TRAIN_STEPS)
        first5, last5 = np.mean(recons[:5]), np.mean(recons[-5:])
        print(f"JAX reference, seed {seed}, {TRAIN_STEPS} steps: "
              f"reconstruction loss mean of first 5 {first5:.3f}, last 5 "
              f"{last5:.3f}, all finite {bool(np.all(np.isfinite(recons)))}",
              flush=True)


if __name__ == "__main__":
    main()
