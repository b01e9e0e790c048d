"""The functions that tests/test_torch_parallel.py runs in its spawned ranks
(``air_tpu_torch.parallel.launch``): one per world, each rank computing
every case of that world and returning numpy values for the test to hold
against the JAX package and the single-card step. Imports no JAX: the
ranks import this module by name."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from air_tpu_torch.interop import (opt_state_from_jax, params_from_jax,
                                   params_to_jax)
from air_tpu_torch.parallel.collectives import gather_slices
from air_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                         param_sharding, shard_batch,
                                         shard_state)
from air_tpu_torch.parallel.train_parallel import (make_parallel_eval_step,
                                                   make_parallel_train_step)
from air_tpu_torch.train.fast_pipeline import (make_multi_step,
                                               make_parallel_multi_step)
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       step_generator)
from air_tpu_torch.train.trainer import Trainer, TrainerConfig
from air_tpu_torch.tree import (tree_leaves, tree_leaves_with_path,
                                tree_unflatten)

K = 3          # steps of the multi-step cases
UNROLLS = (2,)     # the unrolled case: U = 2 leaves JAX's scan a
                   # remainder of one


def state_from_jax(cfg, params, opt_leaves, step: int = 0):
    """The port's TrainState on the CPU from the JAX package's numpy params
    and optimizer leaves."""
    state = create_train_state(cfg, params=params_from_jax(params, "cpu"),
                               device="cpu")
    return state.replace(step=step, opt_state=opt_state_from_jax(
        opt_leaves, state.params, "cpu"))


def arrays(tree) -> list:
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def scalars(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0}


def digest(tree) -> str:
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def collectives(rank, device) -> dict:
    """What the collectives the port uses give on ``device``: an
    all-reduce, a broadcast and an exact gather over a world of two."""
    from air_tpu_torch.parallel.collectives import all_reduce_
    import torch.distributed as dist
    mesh = make_mesh(2)
    t = torch.full((3, 5), float(rank + 1), device=device)
    summed = all_reduce_(t.clone(), mesh.data_group)
    b = torch.full((4,), float(rank), device=device)
    dist.broadcast(b, src=1)
    x = torch.randn((6, 3), generator=torch.Generator().manual_seed(rank))
    gathered = gather_slices(x.to(device), mesh, "data", 0)
    want = torch.cat([torch.randn((6, 3), generator=torch.Generator()
                                  .manual_seed(r)) for r in range(2)])
    half = torch.randn(2, 8, dtype=torch.bfloat16).to(device)
    return {"sum": summed.cpu().tolist(), "broadcast": b.cpu().tolist(),
            "gather_exact": torch.equal(gathered.cpu(), want),
            "bf16": all_reduce_(half.clone(), mesh.data_group).dtype
            == torch.bfloat16}


def _generator_draws(cfg, batch: int, seed: int, steps: int) -> list:
    from air_tpu_torch.models.air import draw_noise
    return [draw_noise(cfg, batch, step_generator(seed, s, "cpu"), "cpu")
            for s in range(steps)]


def world1(rank, device, cfg, images, digits, data):
    """A world of one on ``device``: the eager parallel step and the
    captured parallel multi-step (two graphs on a card) against the
    single-card ones, as bits."""
    torch.set_num_threads(1)
    mesh = make_mesh()
    state = create_train_state(cfg, seed=3, device=device)
    images, digits = (torch.as_tensor(a).to(device) for a in (images,
                                                               digits))
    single, m_s = make_train_step(cfg)(state, images, digits)
    par, m_p = make_parallel_train_step(cfg, mesh)(
        state, *shard_batch(mesh, images, digits))
    out = {"step": (digest(single.params) == digest(par.params)
                    and digest(single.opt_state.mu)
                    == digest(par.opt_state.mu)
                    and scalars(m_s) == scalars(m_p))}
    data_images, data_digits = (torch.as_tensor(a).to(device) for a in data)
    perm = torch.randperm(len(data_images),
                          generator=torch.Generator().manual_seed(0)).to(
                              device)
    runs = []
    for step_fn in (make_multi_step(cfg, K, len(images)),
                    make_parallel_multi_step(cfg, K, len(images), mesh)):
        new, metrics = step_fn(state, data_images, data_digits, perm, 1)
        runs.append((digest(new.params), digest(new.opt_state.nu),
                     metrics["loss"].tolist(), new.step))
    out["multi_step"] = runs
    return out


def world2(rank, device, cfg, jax_state, images, digits, noise, data,
           folder, unrolled):
    """Data axis 2: the step from the JAX package's state with its global
    draws, the eval step, the captured multi-step, the multi-step at
    pipeline_unroll 1 and UNROLLS (``unrolled``: the permutation and the
    K steps' global draws) and the trainer."""
    torch.set_num_threads(1)
    mesh = make_mesh(2)
    out = {"shape": mesh.shape}
    state = state_from_jax(cfg, *jax_state)
    step = make_parallel_train_step(cfg, mesh)
    new, metrics = step(state, *shard_batch(mesh, images, digits),
                        noise=noise)
    out["step"] = (params_to_jax(new.params), scalars(metrics))

    local = shard_batch(mesh, images, digits)
    want = make_eval_step(cfg)(state.params, torch.as_tensor(images),
                               torch.as_tensor(digits), 5,
                               generator=step_generator(9, 5, "cpu"))
    got = make_parallel_eval_step(cfg, mesh)(
        state.params, *local, 5, generator=step_generator(9, 5, "cpu"))
    out["eval"] = ({f: np.asarray(getattr(got, f)) for f in got._fields},
                   {f: np.asarray(getattr(want, f)) for f in want._fields})

    b = len(images)
    data_images, data_digits = (torch.as_tensor(a) for a in data)
    perm = torch.randperm(len(data_images),
                          generator=torch.Generator().manual_seed(1))
    draws = _generator_draws(cfg, b, 11, K)
    runs = []
    for step_fn in (make_multi_step(cfg, K, b),
                    make_parallel_multi_step(cfg, K, b, mesh)):
        new, m = step_fn(state, data_images, data_digits, perm, 2,
                         noise=draws)
        runs.append((arrays(new.params), m["loss"].tolist(), new.step))
    out["multi_step"] = runs

    perm, draws = unrolled
    out["unrolled"] = {}
    for u in (1, *UNROLLS):
        new, m = make_parallel_multi_step(cfg, K, b, mesh,
                                          pipeline_unroll=u)(
            state, data_images, data_digits, torch.from_numpy(perm), 1,
            noise=draws)
        out["unrolled"][u] = (arrays(new.params), m["loss"].tolist())

    out["trainer"] = {loop: _trainer_runs(rank, cfg, data, folder, loop)
                      for loop in ("host", "device")}
    return out


def _train_records(path: str, prefix: str) -> dict:
    """{step: [records]} of the JSONL lines that hold ``prefix``."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if any(k.startswith(prefix) for k in rec):
                out.setdefault(rec["step"], []).append(rec)
    return out


def _trainer_runs(rank, cfg, data, folder, loop: str) -> dict:
    """Six steps of the data-parallel trainer, then the same six from its
    step-3 checkpoint; what each rank saw."""
    def tcfg(name):
        return TrainerConfig(
            results_folder=os.path.join(folder, name), batch_size=8,
            epochs=None, max_iterations=6, num_summaries_every=3,
            var_summaries_every=3, img_summaries_every=6,
            grad_summaries_every=4, save_params_every=3, eval_batch_size=16,
            seed=0, log_every=1, source_snapshot=False, data_parallel=True,
            device="cpu", device_data=loop == "device", multi_step=K,
            reader_threads=1)

    test = (data[0][:12], data[1][:12])
    first = Trainer(cfg, tcfg(f"{loop}_a"), data, test)
    first.train()
    resumed_at = os.path.join(folder, f"{loop}_b", "models")
    if rank == 0:
        os.makedirs(resumed_at)
        for ext in (".npz", ".json"):
            shutil.copy(os.path.join(first.models_dir, f"air-model-3{ext}"),
                        resumed_at)
    again = Trainer(cfg, tcfg(f"{loop}_b"), data, test)
    again.train()
    out = {"folders": (first.folder, again.folder),
           "rank0": (first.rank0, again.rank0),
           "params": (digest(first.state.params),
                      digest(again.state.params)),
           "moments": (digest(first.state.opt_state.nu),
                       digest(again.state.opt_state.nu))}
    if rank == 0:
        out["records"] = (_train_records(first.metrics.path, "train/"),
                          _train_records(again.metrics.path, "train/"))
        out["files"] = sorted(os.listdir(first.models_dir))
    return out


def world4(rank, device, cfgs, jax_states, images, digits, noise):
    """Data 2 x model 2: one step from each JAX state with its global
    draws (the state sharded on the model axis, gathered after), its
    gradients before and after the clip (the shards gathered), the
    per-leaf gradient statistics, and the shard shapes."""
    torch.set_num_threads(1)
    mesh = make_mesh(4, model_axis=2)
    out = {"shape": mesh.shape, "steps": []}
    for cfg, jax_state in zip(cfgs, jax_states):
        full = state_from_jax(cfg, *jax_state)
        state = shard_state(mesh, full)
        new, metrics = make_parallel_train_step(
            cfg, mesh, with_grad_stats=True)(
            state, *shard_batch(mesh, images, digits), noise=noise)
        shapes = {"/".join(map(str, p)): tuple(t.shape)
                  for p, t in tree_leaves_with_path(new.params)}
        moments = {"/".join(map(str, p)): tuple(t.shape)
                   for p, t in tree_leaves_with_path(new.opt_state.mu)}
        gathered = gather_state(mesh, new, cfg)
        placed = param_sharding(mesh, full.params)

        def whole(tree):
            return params_to_jax(tree_unflatten(tree, [
                t if p is None else gather_slices(t, mesh, "model", -1)
                for t, p in zip(tree_leaves(tree), placed)]))

        grads = {k: whole(t) for k, t in metrics["grad_tensors"].items()}
        stats = {k: float(v) for k, v in metrics["grad_stats"].items()}
        out["steps"].append((params_to_jax(gathered.params),
                             scalars(metrics), shapes, moments, grads,
                             stats))
    return out
