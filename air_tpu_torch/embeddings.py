"""Embedding-projector dataset CLI of the port:

    python -m air_tpu_torch.embeddings --model-path model/<checkpoint>.npz

The flags and defaults of the JAX package's root ``embeddings.py``, plus
``--device`` (the card unless ``cpu`` is asked for): infers the test set,
matches the inferred windows to the true digits and writes the projector
files (``air_tpu_torch.tools.embeddings``) into a fresh results folder.
"""

import argparse
import os
import shutil
import sys


def prepare_results_folder(results_folder):
    """Fresh-output-dir semantics with a safety guard: delete the folder
    only if everything in it was written by this tool, so that pointing
    --results-folder at a training run cannot delete its checkpoints."""
    if os.path.isdir(results_folder):
        own = ("_tensors.tsv", "mnist_metadata.tsv", "mnist_sprites.png",
               "projector_config.pbtxt")
        alien = [e for e in os.listdir(results_folder)
                 if not e.endswith(own)]
        if alien:
            sys.exit(f"{results_folder} contains files not written by "
                     f"this tool (e.g. {alien[0]}); refusing to delete it. "
                     "Pass a dedicated embeddings output folder.")
        shutil.rmtree(results_folder)
    os.makedirs(results_folder)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", default="./model/air-model")
    parser.add_argument("--test-data", default="multi_mnist_data/test.airrec")
    parser.add_argument("--results-folder",
                        default=os.path.join(os.getcwd(), "embeddings"))
    parser.add_argument("--max-distance", type=float, default=0.2)
    parser.add_argument("--canvas-size", type=int, default=50)
    parser.add_argument("--windows-size", type=int, default=28)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cpu without a card)")
    args = parser.parse_args(argv)

    from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
    from air_tpu_torch.serve.model_wrapper import ModelWrapper
    from air_tpu_torch.tools.embeddings import run
    from air_tpu_torch.train.checkpoint import (checkpoint_arch,
                                                latest_checkpoint,
                                                load_params)

    prepare_results_folder(args.results_folder)

    path = args.model_path
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            sys.exit(f"no checkpoints in {args.model_path}")
    config = DEFAULT_TRAINING_CONFIG.replace(
        canvas_size=args.canvas_size, windows_size=args.windows_size,
        train=False, **checkpoint_arch(path))
    print(f"Restoring model from {path}...")
    wrapper = ModelWrapper(config, load_params(path), device=args.device)

    return run(wrapper, args.test_data, args.results_folder,
               args.canvas_size, args.windows_size, args.max_distance)


if __name__ == "__main__":
    main()
