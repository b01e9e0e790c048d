#!/usr/bin/env python3
"""Hold the port's training to the JAX package's over many steps, on the CPU.

    python3 scripts/trajectory_torch.py robust --steps 3000 --eval-every 500
    python3 scripts/trajectory_torch.py scaled --minutes 30 --batch-size 16

Both packages start from one JAX init (carried over by
``interop.params_from_jax`` / ``opt_state_from_jax``), take the same
batches (the port's ``TrainLoader`` with the numpy permutation, checked
against JAX's on the first batch) and the same draws (JAX's
``fold_in(key, step)`` draws fed to the port's eager step as ``noise``),
and run the train step side by side. A third run, the witness, is JAX
again from the init with every entry of the LSTM kernel moved one ulp up.

The gradient of this model is ill-conditioned (its norm swings over orders
of magnitude between steps), so any two runs that differ in the last bit
part within a few steps. The question is not whether the port parts from
JAX but how fast: at each step the relative L2 distance of the port's
params to JAX's is set beside the witness's, and the loss likewise. An
algorithmic difference (a schedule a step off, a bias correction, a
moment rounded otherwise) parts clearly faster than the witness or jumps
where a schedule turns. Each step also holds the port's host scalars
(``steps.host_scalars``: the annealed hyperparameters, Adam's bias
corrections) to JAX's values, in units in the last place of float32.

``robust`` is the robust default of ``training.py`` at full width (CNN,
hold 15000, batch 64) on a set generated from the committed digit pool
into ``--data`` (``--synthetic-data`` canvases per digit count when it
holds none); evals every ``--eval-every`` steps score all three runs'
params with JAX's eval step and one key on the test set. ``scaled`` is
BASELINE config 4's widths (canvas 100, LSTM 512, VAE latent 100) at a
cut batch, on digits drawn at 1.5-2.5x, run for ``--minutes`` of wall
time. The record (``--out``, JSON) keeps every step's distances for the
first 200 steps and every 10th after.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from air_tpu.data.loader import TrainLoader as JaxLoader  # noqa: E402
from air_tpu.ops.schedules import resolve_annealed as jax_resolve  # noqa: E402
from air_tpu.train.evaluate import evaluate_params as jax_evaluate  # noqa: E402
from air_tpu.train.state import create_train_state as jax_create  # noqa: E402
from air_tpu.train.steps import make_eval_step as jax_eval_step  # noqa: E402
from air_tpu.train.steps import make_train_step as jax_train_step  # noqa: E402
from air_tpu_torch.data.loader import TrainLoader  # noqa: E402
from air_tpu_torch.interop import (opt_state_from_jax,  # noqa: E402
                                   params_from_jax, params_to_jax)
from air_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                       make_optimizer)
from air_tpu_torch.train.steps import (host_scalars,  # noqa: E402
                                       make_train_step)

WITNESS_LEAF = ("lstm", "kernel")
EVAL_KEY = 0x5EED


def jax_draws(key, cfg, batch: int) -> dict:
    """The draws air_tpu's air_forward makes from ``key`` (split(key, T),
    then split(k, 4) -> scale/shift/vae/zpres, split(k_vae) ->
    latent/out), jnp arrays stacked over the steps."""
    out = {k: [] for k in ("scale", "shift", "vae_latent", "vae_out",
                           "z_pres_u")}
    f32 = jnp.float32
    for k in jax.random.split(key, cfg.max_steps):
        k_scale, k_shift, k_vae, k_zpres = jax.random.split(k, 4)
        k_latent, k_out = jax.random.split(k_vae)
        out["scale"].append(jax.random.normal(k_scale, (batch, 1), f32))
        out["shift"].append(jax.random.normal(k_shift, (batch, 2), f32))
        out["vae_latent"].append(jax.random.normal(
            k_latent, (batch, cfg.vae_latent_dimensions), f32))
        out["vae_out"].append(jax.random.normal(
            k_out, (batch, cfg.windows_size ** 2), f32))
        out["z_pres_u"].append(jax.random.uniform(k_zpres, (batch,), f32))
    return {k: jnp.stack(v) for k, v in out.items()}


def jax_noise(key, cfg, batch: int) -> dict:
    """``jax_draws`` as torch tensors, the port's ``noise`` argument."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in jax_draws(key, cfg, batch).items()}


def nudged(jstate, leaf=WITNESS_LEAF):
    """``jstate`` with every entry of one param leaf one ulp up."""
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    node = params
    for name in leaf[:-1]:
        node = node[name]
    node[leaf[-1]] = np.nextafter(node[leaf[-1]], np.float32(np.inf))
    return jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                        params))


def leaves64(tree) -> list:
    """The leaves of a JAX or torch param tree as float64 numpy arrays, in
    JAX's leaf order."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        tree = params_to_jax(tree)
    return [np.asarray(a, np.float64)
            for a in jax.tree_util.tree_leaves(tree)]


def rel_distance(a: list, b: list) -> float:
    """||a - b|| / ||b|| over all leaves."""
    num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(a, b))
    den = sum(float(np.sum(y ** 2)) for y in b)
    return float(np.sqrt(num / den))


def ulps(a: float, b: float) -> int:
    """How many float32 values lie between a and b (both float32 values)."""
    ia, ib = (int(np.array(v, np.float32).view(np.int32)) for v in (a, b))
    return abs(ia - ib)


def jax_host_scalars(jcfg, step: int, count: int) -> dict:
    """JAX's values of the port's host scalars at ``step``: each annealed
    hyperparameter (``resolve_annealed``) and Adam's bias corrections of
    the next count (``scale_by_adam_stored``: ``1 - b ** t`` in float32)."""
    hp = jax_resolve(jcfg.schedules, jcfg.annealable_defaults(),
                     jnp.asarray(step, jnp.int32))
    row = {name: float(hp[name]) for name in jcfg.schedules}
    t = jnp.asarray(count + 1, jnp.int32).astype(jnp.float32)
    row["c1"] = float(1.0 - jnp.power(0.9, t))
    row["c2"] = float(1.0 - jnp.power(0.999, t))
    return row


def trajectories(jcfg, cfg, batches, steps: int, seed: int = 0, test=None,
                 eval_every: int = 0, eval_batch: int = 500,
                 deadline: float | None = None, log=None,
                 jstate=None) -> dict:
    """Run JAX, the one-ulp witness and the port ``steps`` train steps from
    ``jstate`` (default ``jax_create(jcfg, rng=seed)``) on ``batches`` (an
    iterator of (images, digits) numpy pairs), stopping early past
    ``deadline`` (time.time()).

    Returns per step k (after the k-th update): ``port_param``,
    ``witness_param`` (relative L2 distances of the params to JAX's),
    ``port_loss``, ``witness_loss`` (|loss - JAX's loss| / |JAX's|, the
    loss of step k), ``loss`` (JAX's); ``host_ulps`` (per host scalar,
    the largest float32 ulp distance to JAX's value over the steps);
    ``evals`` ([step, JAX, witness, port] test accuracies)."""
    if jstate is None:
        jstate = jax_create(jcfg, rng=seed)
    wstate = nudged(jstate)
    jstep = jax_train_step(jcfg, donate=False)
    optimizer = make_optimizer(cfg)
    state = create_train_state(cfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), "cpu"),
        device="cpu")
    state = state.replace(opt_state=opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jax.tree_util.tree_leaves(jstate.opt_state)),
        state.params, "cpu"))
    step_fn = make_train_step(cfg)
    eval_fn = jax_eval_step(jcfg)
    out = {k: [] for k in ("port_param", "witness_param", "port_loss",
                           "witness_loss", "loss")}
    out["host_ulps"] = {}
    out["evals"] = []

    def evaluate(step):
        images, digits = test
        key = jax.random.PRNGKey(EVAL_KEY)
        accs = [float(jax_evaluate(eval_fn, p, images, digits,
                                   batch_size=eval_batch, key=key,
                                   step=step).accuracy)
                for p in (jstate.params, wstate.params,
                          params_to_jax(state.params))]
        out["evals"].append([step] + accs)
        if log:
            log(f"eval @ {step}: JAX {accs[0]:.3f} witness {accs[1]:.3f} "
                f"port {accs[2]:.3f}")

    for k in range(steps):
        if deadline is not None and time.time() > deadline:
            break
        if test is not None and eval_every and k % eval_every == 0:
            evaluate(k)
        images, digits = next(batches)
        key = jax.random.fold_in(jstate.key, k)
        # JAX's step and Adam count are both k here
        want = jax_host_scalars(jcfg, k, k)
        got = host_scalars(cfg, optimizer, state.step, state.opt_state)
        for name, value in want.items():
            out["host_ulps"][name] = max(out["host_ulps"].get(name, 0),
                                         ulps(got[name], value))
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(digits))
        wstate, wm = jstep(wstate, jnp.asarray(images), jnp.asarray(digits))
        state, m = step_fn(state, torch.from_numpy(images),
                           torch.from_numpy(digits),
                           noise=jax_noise(key, jcfg, len(images)))
        ref = leaves64(jstate.params)
        loss = float(jm["loss"])
        out["loss"].append(loss)
        out["port_param"].append(rel_distance(leaves64(state.params), ref))
        out["witness_param"].append(rel_distance(leaves64(wstate.params),
                                                 ref))
        out["port_loss"].append(abs(float(m["loss"]) - loss) / abs(loss))
        out["witness_loss"].append(abs(float(wm["loss"]) - loss) / abs(loss))
        if log and (k < 10 or (k + 1) % 100 == 0):
            log(f"step {k + 1}: loss {loss:.2f}  params port "
                f"{out['port_param'][-1]:.3e} witness "
                f"{out['witness_param'][-1]:.3e}")
    if test is not None and eval_every:
        evaluate(len(out["loss"]))
    return out


def batch_iter(images, digits, batch: int, seed: int):
    """(images, digits) batches of the port's TrainLoader (numpy
    permutation, no prefetch), endless; its first batch checked against
    the JAX package's loader."""
    loader = TrainLoader((images, digits), batch, seed=seed, prefetch=0,
                         native=False)
    first = next(iter(JaxLoader((images, digits), batch, seed=seed,
                                prefetch=0, native=False)))
    it = iter(loader)
    head = next(it)
    for a, b in zip(head, first):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    yield tuple(np.asarray(a) for a in head)
    for pair in it:
        yield tuple(np.asarray(a) for a in pair)


def ratio_summary(traj: dict) -> dict:
    """The port's distances over the witness's: quantiles over all steps
    and over the steps after 10 (both runs parted by then)."""
    summary = {}
    for what in ("param", "loss"):
        p = np.asarray(traj[f"port_{what}"])
        w = np.asarray(traj[f"witness_{what}"])
        r = p / np.maximum(w, 1e-30)
        late = r[10:] if len(r) > 10 else r
        summary[what] = {
            "median_ratio": float(np.median(r)),
            "median_ratio_after_10": float(np.median(late)),
            "max_ratio_after_10": float(np.max(late)),
            "final_port": float(p[-1]), "final_witness": float(w[-1])}
    return summary


def thin(traj: dict) -> dict:
    """Every step for the first 200, every 10th after."""
    n = len(traj["loss"])
    keep = [i for i in range(n) if i < 200 or (i + 1) % 10 == 0]
    out = {k: v for k, v in traj.items() if not isinstance(v, list)
           or k == "evals"}
    out["steps"] = [i + 1 for i in keep]
    for k in ("loss", "port_param", "witness_param", "port_loss",
              "witness_loss"):
        out[k] = [traj[k][i] for i in keep]
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", choices=["robust", "scaled"])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--minutes", type=float, default=0.0,
                   help="stop after this much wall time (0 = no limit)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hold", type=int, default=None,
                   help="the z_pres prior's hold (default: the "
                        "configuration's), to cross its end in fewer steps")
    p.add_argument("--data", default="multi_mnist_data")
    p.add_argument("--synthetic-data", type=int, default=20000)
    p.add_argument("--st-impl", default="xla",
                   choices=["inline", "pallas", "xla"])
    p.add_argument("--out", required=True)
    args = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))

    from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_DEFAULT
    from air_tpu.models.config import AIRConfig as JaxConfig
    from air_tpu_torch.data.loader import load_test_data
    from air_tpu_torch.data.records import read_records
    from air_tpu_torch.models.config import AIRConfig

    sched = JAX_DEFAULT.schedules
    sched["z_pres_prior_log_odds"]["hold"] = 15000
    jcfg = JAX_DEFAULT.replace(annealing_schedules=sched, cnn=True,
                               st_impl=args.st_impl)
    gen = []
    if args.config == "scaled":
        # BASELINE config 4's widths (bench.py:38-53) with its schedule
        sched["z_pres_prior_log_odds"].update(iters=190, hold=940)
        jcfg = jcfg.replace(canvas_size=100, rnn_units=512,
                            vae_latent_dimensions=100,
                            annealing_schedules=sched)
        gen = ["--canvas-size", "100", "--min-width-scale", "1.5",
               "--max-width-scale", "2.5", "--min-height-scale", "1.5",
               "--max-height-scale", "2.5"]
    if args.hold is not None:
        sched["z_pres_prior_log_odds"]["hold"] = args.hold
        jcfg = jcfg.replace(annealing_schedules=sched)
    fields = AIRConfig.__dataclass_fields__
    cfg = AIRConfig(**{f: getattr(jcfg, f)
                       for f in JaxConfig.__dataclass_fields__
                       if f in fields})
    train = os.path.join(args.data, "common.airrec")
    if not os.path.exists(train):
        import subprocess
        subprocess.run([sys.executable, "-m",
                        "air_tpu_torch.generate_multi_mnist",
                        "--images-per-digit", str(args.synthetic_data),
                        "--out-folder", args.data, *gen], check=True)
    rec = read_records(train)
    images = np.asarray(rec["images"], np.float32).reshape(
        len(rec["images"]), -1)
    digits = np.asarray(rec["digits"], np.int32)
    test = load_test_data(os.path.join(args.data, "test.airrec"))
    batches = batch_iter(images, digits, args.batch_size, args.seed)
    deadline = (time.time() + 60 * args.minutes) if args.minutes else None
    t0 = time.time()
    traj = trajectories(jcfg, cfg, batches, args.steps, seed=args.seed,
                        test=test, eval_every=args.eval_every,
                        deadline=deadline,
                        log=lambda s: print(s, flush=True))
    record = {
        "script": "scripts/trajectory_torch.py",
        "argv": sys.argv[1:],
        "config": args.config,
        "host": "CPU",
        "batch_size": args.batch_size,
        "st_impl": args.st_impl,
        "steps_run": len(traj["loss"]),
        "wall_seconds": round(time.time() - t0, 1),
        "train_set": len(images),
        "test_set": len(test[0]),
        "witness": "JAX from the init with every entry of "
                   + "/".join(WITNESS_LEAF) + " one ulp up",
        "schedules": jcfg.schedules,
        "summary": ratio_summary(traj),
        **thin(traj),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=0)
    print(json.dumps({"out": args.out, "steps_run": record["steps_run"],
                      "summary": record["summary"],
                      "host_ulps": traj["host_ulps"],
                      "evals": traj["evals"]}))


if __name__ == "__main__":
    main()
