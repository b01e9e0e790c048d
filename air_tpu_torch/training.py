"""AIR training driver of the port:

    python -m air_tpu_torch.training --synthetic-data 20000 --device-data ...

The flags and defaults of the JAX package's root ``training.py``, run on a
CUDA card (``--device cpu`` for a tiny run without one). With
``--synthetic-data N`` and no dataset on disk it first generates one, N
canvases per digit count, from real MNIST in ``mnist_data/`` when present,
else from the committed digit pool (``air_tpu_torch.data.get_mnist``).

``--st-impl`` picks the path of the attention read and write: ``inline``
(the default: the hand-written kernels 1-4 of ``kernels/st_inline.cu`` in
every train step, 1-2 in every eval), ``pallas`` (the streamed-weight
kernels) or ``xla`` (plain PyTorch products, no kernel; the only path of
``--decoder-layout stepparallel``). ``--compute-dtype bfloat16`` and
``--rnn-input-hoist`` take every path. ``--data-parallel`` trains on
``--n-devices`` cards (every visible one by default): one process per card,
rank r on ``cuda:r``, over NCCL, the global batch split over the ranks;
with ``--device cpu`` the ranks share the CPU over gloo. The kernels are
built once before the ranks start. ``--pipeline-unroll U`` (an int >= 1,
the JAX package's scan unroll) is taken in every loop; each step stays
one replay of the captured step, with the bits of U = 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-r", "--results-folder", default="air_results")
    parser.add_argument("-o", "--overwrite-results", type=int,
                        choices=[0, 1], default=0)
    parser.add_argument("-t", "--reader-threads", type=int, default=4)
    parser.add_argument("--train-data",
                        default="multi_mnist_data/common.airrec")
    parser.add_argument("--test-data", default="multi_mnist_data/test.airrec")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--steps", type=int, default=None,
                        help="cap on training iterations (default: epochs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-every", type=int, default=50)
    parser.add_argument("--img-every", type=int, default=500)
    parser.add_argument("--save-every", type=int, default=10000)
    parser.add_argument("--grad-every", type=int, default=100)
    parser.add_argument("--log-every", type=int, default=1)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--device-data", action="store_true",
                        help="dataset resident on the card, up to "
                             "--multi-step steps per host iteration")
    parser.add_argument("--multi-step", type=int, default=50)
    parser.add_argument("--pipeline-unroll", type=int, default=1,
                        help="the JAX package's K-step scan unroll; the "
                             "port takes any U >= 1 and replays one step "
                             "at a time, with the bits of 1")
    parser.add_argument("--data-parallel", action="store_true",
                        help="one rank per card (cuda:r, NCCL), the batch "
                             "split over them; with --device cpu, ranks on "
                             "the CPU over gloo")
    parser.add_argument("--n-devices", type=int, default=None,
                        help="ranks of --data-parallel (default: every "
                             "visible card; 1 with --device cpu)")
    parser.add_argument("--synthetic-data", type=int, default=0,
                        help="if no dataset exists, generate one with N "
                             "images per digit stratum first")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cpu for a tiny "
                             "run without a card)")
    parser.add_argument("--st-impl", default="inline",
                        choices=["inline", "pallas", "xla"],
                        help="attention read/write path: inline (kernels "
                             "1-4), pallas (streamed-weight kernels 5-7) "
                             "or xla (plain products, no kernel)")
    # model overrides
    parser.add_argument("--max-steps", type=int, default=3)
    parser.add_argument("--max-digits", type=int, default=2)
    parser.add_argument("--rnn-units", type=int, default=256)
    parser.add_argument("--canvas-size", type=int, default=50)
    parser.add_argument("--windows-size", type=int, default=28)
    parser.add_argument("--vae-latent", type=int, default=50)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--stopping-threshold", type=float, default=0.99)
    parser.add_argument("--cnn", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="CNN encoder (default ON — the robust-default "
                             "configuration; --no-cnn selects the raw-pixel "
                             "encoder)")
    parser.add_argument("--adam-dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="Adam moment storage dtype. Default: the "
                             "shipped config default")
    parser.add_argument("--unroll", type=int, default=None,
                        help="AIRConfig.scan_unroll (kept for parity; the "
                             "port's attention loop is a Python loop)")
    parser.add_argument("--compute-dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="AIRConfig.compute_dtype: bfloat16 runs the "
                             "CNN, LSTM, heads and VAE MLPs in bf16 "
                             "(fp32 master params and Adam)")
    parser.add_argument("--decoder-layout", default=None,
                        choices=["scan", "stepparallel"],
                        help="AIRConfig.decoder_layout; stepparallel needs "
                             "--st-impl xla")
    parser.add_argument("--rnn-input-hoist", action="store_true",
                        help="AIRConfig.rnn_input_hoist: the LSTM's input "
                             "projection once per image")
    parser.add_argument("--stop-at-accuracy", type=float, default=None,
                        help="stop once test accuracy reaches this value")
    parser.add_argument("--stall-restart-step", type=int, default=60000,
                        help="auto-restart from a re-seeded init (with "
                             "schedule rotation) when test accuracy is "
                             "below --stall-accuracy AND flat from this "
                             "step on (0 = off; device-data loop only)")
    parser.add_argument("--stall-accuracy", type=float, default=0.95)
    parser.add_argument("--stall-window", type=int, default=20000)
    parser.add_argument("--stall-min-progress", type=float, default=0.01)
    parser.add_argument("--stall-spare-accuracy", type=float, default=0.85)
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--attempt-stride", type=int, default=1009)
    parser.add_argument("--restart-rotation", type=int, choices=[0, 1],
                        default=1)
    parser.add_argument("--learn-background", action="store_true")
    parser.add_argument("--bg-init", choices=["data", "none"],
                        default="data")
    parser.add_argument("--bg-freeze", action="store_true")
    parser.add_argument("--bg-composite-kind", default="")
    parser.add_argument("--bg-composite-path", default="",
                        help="a PNG texture (8-bit, non-interlaced)")
    parser.add_argument("--bg-composite-seed", type=int, default=0)
    parser.add_argument("--bg-target", type=float, default=0.3)
    parser.add_argument("--bg-start", type=int, default=10000)
    parser.add_argument("--bg-ramp", type=int, default=40000)
    parser.add_argument("--anneal-hold", type=int, default=15000)
    parser.add_argument("--anneal-iters", type=int, default=0)
    parser.add_argument("--scale-curriculum",
                        action=argparse.BooleanOptionalAction, default=None)
    return parser


def synthesize(out_dir: str, per_stratum: int, max_digits: int = 2,
               canvas_size: int = 50, seed: int = 0) -> None:
    """Generate a multi-MNIST set into ``out_dir`` (``common.airrec`` and
    ``test.airrec``) the way the root training.py does: ``per_stratum``
    canvases per digit count, ``min(1000, per_stratum)`` of them held out,
    from real MNIST in ``mnist_data/`` or else the committed digit pool."""
    from air_tpu_torch.data import (MultiMNISTConfig, generate_dataset,
                                    get_mnist)
    print(f"generating synthetic dataset ({per_stratum} images/stratum)...")
    digits, labels, source = get_mnist("mnist_data")
    print(f"digit source: {source}")
    cfg = MultiMNISTConfig(
        max_digits=max_digits, max_in_common=max_digits,
        images_per_digit=per_stratum,
        test_set_size=min(1000, per_stratum),
        canvas_size=canvas_size, seed=seed)
    generate_dataset(digits, labels, cfg, out_dir=out_dir,
                     progress=lambda d, n: print(f"  {d}-digit: {n}"))


def generate_data(args) -> None:
    """Generate the dataset the way the root training.py does, into the
    directory of --train-data; point the args at what was written."""
    out_dir = os.path.dirname(args.train_data) or "."
    synthesize(out_dir, args.synthetic_data, args.max_digits,
               args.canvas_size, args.seed)
    gen_train = os.path.join(out_dir, "common.airrec")
    if not os.path.exists(args.train_data) and os.path.exists(gen_train):
        print(f"synthetic data written as {gen_train}; using it "
              f"(and {out_dir}/test.airrec) instead of {args.train_data}")
        args.train_data = gen_train
        args.test_data = os.path.join(out_dir, "test.airrec")


def configs(args):
    """(model config, trainer config) from the parsed flags, as the root
    training.py builds them."""
    from air_tpu_torch.data.multi_mnist import prepare_background
    from air_tpu_torch.models.config import (DEFAULT_TRAINING_CONFIG,
                                             pin_raw_pixel_numerics)
    from air_tpu_torch.train.trainer import (DEFAULT_RESTART_ROTATION,
                                             TrainerConfig)

    model_config = DEFAULT_TRAINING_CONFIG.replace(
        max_steps=args.max_steps, max_digits=args.max_digits,
        rnn_units=args.rnn_units, canvas_size=args.canvas_size,
        windows_size=args.windows_size,
        vae_latent_dimensions=args.vae_latent,
        learning_rate=args.learning_rate,
        stopping_threshold=args.stopping_threshold,
        cnn=args.cnn, st_impl=args.st_impl,
        learn_background=args.learn_background,
        freeze_background=args.bg_freeze,
        **pin_raw_pixel_numerics(args.cnn, args.adam_dtype, args.unroll),
        **({"compute_dtype": args.compute_dtype}
           if args.compute_dtype else {}),
        **({"decoder_layout": args.decoder_layout}
           if args.decoder_layout else {}),
        **({"rnn_input_hoist": True} if args.rnn_input_hoist else {}),
    )
    bg_image, bg_schedule = None, None
    if args.bg_composite_kind or args.bg_composite_path:
        bg_image = prepare_background(
            args.canvas_size, bg_path=args.bg_composite_path,
            bg_kind=args.bg_composite_kind, max_intensity=1.0,
            seed=args.bg_composite_seed).reshape(-1)
        bg_schedule = {"target": args.bg_target, "start": args.bg_start,
                       "ramp": args.bg_ramp}
    scale_curriculum = (not args.cnn if args.scale_curriculum is None
                        else args.scale_curriculum)
    if args.anneal_hold or args.anneal_iters or scale_curriculum:
        sched = model_config.schedules
        if args.anneal_hold:
            sched["z_pres_prior_log_odds"]["hold"] = args.anneal_hold
        if args.anneal_iters:
            sched["z_pres_prior_log_odds"]["iters"] = args.anneal_iters
        if scale_curriculum:
            sched["scale_prior_mean"] = {
                "init": 1.0, "min": 0.0, "factor": 0.5, "iters": 5000,
                "offset": -1.0, "hold": args.anneal_hold}
        model_config = model_config.replace(annealing_schedules=sched)
    trainer_config = TrainerConfig(
        results_folder=args.results_folder,
        overwrite_results=bool(args.overwrite_results),
        batch_size=args.batch_size,
        epochs=args.epochs,
        max_iterations=args.steps,
        num_summaries_every=args.eval_every,
        var_summaries_every=max(args.eval_every * 5, 1),
        img_summaries_every=args.img_every,
        grad_summaries_every=args.grad_every,
        save_params_every=args.save_every,
        log_every=args.log_every,
        seed=args.seed,
        resume=not args.no_resume,
        tensorboard=args.tensorboard,
        device_data=args.device_data,
        multi_step=args.multi_step,
        pipeline_unroll=args.pipeline_unroll,
        data_parallel=args.data_parallel,
        n_devices=args.n_devices,
        reader_threads=args.reader_threads,
        stop_at_accuracy=args.stop_at_accuracy,
        stall_detect_step=args.stall_restart_step or None,
        stall_accuracy=args.stall_accuracy,
        stall_window=args.stall_window,
        stall_min_progress=args.stall_min_progress,
        stall_spare_accuracy=args.stall_spare_accuracy,
        max_restarts=args.max_restarts,
        attempt_seed_stride=args.attempt_stride,
        restart_schedule_rotation=(
            DEFAULT_RESTART_ROTATION if args.restart_rotation else ()),
        bg_image=bg_image,
        bg_schedule=bg_schedule,
        background_init="data" if args.bg_init == "data" else None,
        device=args.device,
    )
    return model_config, trainer_config


def rank_devices(args) -> tuple[str, list]:
    """(backend, device of each rank) of ``--data-parallel``: rank r on
    ``cuda:r`` over NCCL, ``--n-devices`` of them (every visible card by
    default); with ``--device cpu``, ``--n-devices`` ranks (1 by default)
    on the CPU over gloo. Raises if fewer cards are visible than asked."""
    if torch.device(args.device).type == "cpu":
        return "gloo", ["cpu"] * (args.n_devices or 1)
    visible = torch.cuda.device_count()
    n = args.n_devices or visible
    if not 1 <= n <= visible:
        raise RuntimeError(f"--data-parallel over {n} cards: {visible} "
                           "visible")
    return "nccl", [f"cuda:{r}" for r in range(n)]


def train(args) -> dict:
    """The Trainer of ``args`` on ``args.device``, trained: its result."""
    from air_tpu_torch.data.loader import load_test_data
    from air_tpu_torch.train.trainer import Trainer

    model_config, trainer_config = configs(args)
    test_data = load_test_data(args.test_data, shift_zero_digits_images=True)
    trainer = Trainer(model_config, trainer_config, args.train_data,
                      test_data)
    return trainer.train()


def train_rank(rank: int, device, args) -> dict:
    """One rank of ``--data-parallel`` (``parallel.launch``'s function):
    the Trainer on this rank's device."""
    args.device = str(device)
    args.n_devices = torch.distributed.get_world_size()
    return train(args)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.synthetic_data and not os.path.exists(args.train_data):
        generate_data(args)
    if not os.path.exists(args.train_data):
        sys.exit(f"training data not found: {args.train_data} "
                 f"(pass --synthetic-data N)")
    if not args.data_parallel:
        return train(args)

    from air_tpu_torch.parallel.launch import launch

    backend, devices = rank_devices(args)
    if backend == "nccl":
        from air_tpu_torch.kernels import build
        build.load_all()        # once, before the ranks look for them
    return launch(train_rank, backend, devices, (args,), timeout=None)[0]


if __name__ == "__main__":
    main()
