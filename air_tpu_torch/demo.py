"""AIR live-inference demo of the port:

    python -m air_tpu_torch.demo --model-path model/air-model-cnn-47500.npz
    python -m air_tpu_torch.demo --headless 20 --model-path ...

The flags and defaults of the JAX package's root ``demo.py``, plus
``--device`` (the card unless ``cpu`` is asked for). It loads a checkpoint,
serves it through ``ModelWrapper`` (eval mode, z_pres rounded; the
step-parallel decoder, as the JAX wrapper serves the default config) and
opens the Tk drawing window. ``--headless N`` streams N demo-style
inferences as JSON lines instead, for display-less machines.
"""

import argparse
import os
import sys

CANVAS_SIZE = 50
WINDOW_SIZE = 28


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", default="./model/air-model",
                        help="checkpoint file or directory of checkpoints")
    parser.add_argument("--headless", type=int, default=0, metavar="N",
                        help="stream N frames as JSON lines instead of GUI")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--canvas-size", type=int, default=CANVAS_SIZE)
    parser.add_argument("--windows-size", type=int, default=WINDOW_SIZE)
    parser.add_argument("--refresh-ms", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cpu without a card)")
    args = parser.parse_args(argv)

    from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG
    from air_tpu_torch.serve.model_wrapper import ModelWrapper
    from air_tpu_torch.train.checkpoint import (checkpoint_arch,
                                                latest_checkpoint,
                                                load_params)

    path = args.model_path
    if os.path.isdir(path):
        path = latest_checkpoint(path)
        if path is None:
            sys.exit(f"no checkpoints in {args.model_path}")
    config = DEFAULT_TRAINING_CONFIG.replace(
        canvas_size=args.canvas_size, windows_size=args.windows_size,
        train=False, **checkpoint_arch(path))
    print(f"Restoring model from {path}...", file=sys.stderr)
    wrapper = ModelWrapper(config, load_params(path), seed=args.seed,
                           device=args.device)

    if args.headless:
        from air_tpu_torch.tools.headless_demo import scribble_frames, stream
        stats = stream(wrapper,
                       scribble_frames(args.canvas_size, args.headless,
                                       args.seed),
                       batch_size=args.batch_size, out=sys.stdout)
        print(f"# {stats['frames']} frames, "
              f"{stats['frames_per_sec']:.1f} frames/sec, "
              f"{stats['mean_latency_ms']:.2f} ms/frame", file=sys.stderr)
        return stats

    import tkinter as tk

    from air_tpu_torch.tools.demo_tk import DemoWindow
    master = tk.Tk()
    master.title("Attend Infer Repeat - Live Demo (H100)")
    master.columnconfigure(0, weight=1)
    master.rowconfigure(1, weight=1)
    DemoWindow(master, wrapper, args.canvas_size, args.windows_size,
               refresh_period=args.refresh_ms)
    master.mainloop()


if __name__ == "__main__":
    main()
