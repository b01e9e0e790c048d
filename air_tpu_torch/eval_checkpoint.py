"""Evaluate a checkpoint on a test set, on the port:

    python -m air_tpu_torch.eval_checkpoint --model-path results/models \\
        --test-data real_digits_data/test.airrec

The counterpart of the JAX package's ``scripts/eval_checkpoint.py``: the
digit-count accuracy and the sliced metrics of the reference's test-model
summary pass, printed as the same JSON keys (``checkpoint``, ``n``,
``accuracy``, ``digit_acc*``, ``steps_*``, ``rec_loss*``). ``--model-path``
takes a checkpoint file or a directory (its latest checkpoint); the
architecture flags must match how the checkpoint was trained (``--cnn``
is read from its keys unless given). Checkpoints are in the JAX package's
format, so it reads the JAX package's and the shipped ones.

Beside the JAX script's flags, ``--device`` (default ``cuda``; ``cpu``
without a card) and ``--st-impl`` (default ``inline``: the eval forward
through kernels 1-2, as ``python -m air_tpu_torch.training`` evaluates).
The eval draws come from ``step_generator(0, 0)``, where the JAX script
folds each chunk's start into ``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", default="model")
    parser.add_argument("--test-data", default="multi_mnist_data/test.airrec")
    parser.add_argument("--batch-size", type=int, default=1000)
    # architecture flags (must match training's)
    parser.add_argument("--max-steps", type=int, default=3)
    parser.add_argument("--max-digits", type=int, default=2)
    parser.add_argument("--rnn-units", type=int, default=256)
    parser.add_argument("--canvas-size", type=int, default=50)
    parser.add_argument("--windows-size", type=int, default=28)
    parser.add_argument("--vae-latent", type=int, default=50)
    parser.add_argument("--cnn", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="default: read from the checkpoint's keys")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--st-impl", default="inline",
                        choices=["inline", "pallas", "xla"])
    return parser


def main(argv=None, draws=None) -> dict:
    """Evaluate and print the JSON; returns it. ``draws(lo)``, when given,
    gives a chunk's draws as ``train.evaluate.evaluate_params`` takes them
    (the tests feed the JAX script's)."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from air_tpu_torch.data.loader import load_test_data
    from air_tpu_torch.interop import params_from_jax
    from air_tpu_torch.models.air import AIROutputs
    from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
    from air_tpu_torch.train.checkpoint import (checkpoint_arch,
                                                latest_checkpoint,
                                                load_params)
    from air_tpu_torch.train.evaluate import evaluate_params
    from air_tpu_torch.train.metrics import summarize_outputs, to_host
    from air_tpu_torch.train.steps import make_eval_step, step_generator

    path = args.model_path
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            sys.exit(f"no checkpoints in {args.model_path}")
    arch = checkpoint_arch(path)
    if args.cnn is not None:
        arch["cnn"] = args.cnn
    cfg = DEFAULT_TRAINING_CONFIG.replace(
        max_steps=args.max_steps, max_digits=args.max_digits,
        rnn_units=args.rnn_units, canvas_size=args.canvas_size,
        windows_size=args.windows_size,
        vae_latent_dimensions=args.vae_latent, st_impl=args.st_impl,
        train=False, **arch)
    params = params_from_jax(load_params(path), args.device)
    images, digits = load_test_data(args.test_data)
    if draws is None:
        generator = step_generator(0, 0, args.device)

        def draws(lo):
            return {"generator": generator}

    merged = evaluate_params(make_eval_step(cfg), params, images, digits,
                             batch_size=args.batch_size, step=0, draws=draws)
    summ = to_host(summarize_outputs(
        AIROutputs(*(torch.from_numpy(np.asarray(v)) for v in merged)),
        torch.from_numpy(digits), cfg.max_steps, cfg.max_digits))
    result = {
        "checkpoint": path,
        "n": len(images),
        "accuracy": round(float(merged.accuracy), 4),
        **{k: round(float(v), 3) for k, v in summ.items()
           if k.startswith(("digit_acc", "steps_", "rec_loss"))
           and not np.isnan(float(v))},
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
