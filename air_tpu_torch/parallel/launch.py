"""Run a function in one process per rank over ``torch.distributed``.

``launch(fn, backend, devices, args)`` spawns ``len(devices)`` processes
(start method ``spawn``: a child inherits no CUDA context), joins them to
one process group through a file store in a fresh temporary directory,
and calls ``fn(rank, device, *args)`` in each, rank r on ``devices[r]``
(made the current CUDA device). The backend and the device map are the
caller's: the training driver passes NCCL and ``cuda:r``; the tests and
the smoke run pass gloo and their own map. Nothing is chosen in their
place.

A rank that raises, dies or outlives ``timeout`` fails the launch: the
other ranks are terminated and ``launch`` raises with the rank's
traceback. There is no single-process fallback. ``fn`` must be importable
by name, and its arguments and result picklable (no CUDA tensors).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

JOIN_SECONDS = 30.0
# how long a collective may wait for the other ranks (rank 0 evaluates and
# writes while the others wait at the next broadcast)
COLLECTIVE_SECONDS = 3600.0


def _rank_main(rank: int, world: int, backend: str, device: str, store: str,
               fn, args: tuple, results) -> None:
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_SECONDS))
        try:
            value = fn(rank, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(fn, backend: str, devices, args: tuple = (),
           timeout: float | None = 900.0) -> list:
    """``[fn(0, devices[0], *args), ..., fn(n - 1, devices[n - 1], *args)]``
    from n spawned ranks of one ``backend`` process group. Raises
    ``RuntimeError`` if a rank fails and ``TimeoutError`` if the ranks do
    not all return within ``timeout`` seconds (None: no limit)."""
    devices = [torch.device(d) for d in devices]
    world = len(devices)
    if world < 1:
        raise ValueError("launch needs at least one rank")
    unnumbered = [str(d) for d in devices
                  if d.type == "cuda" and d.index is None]
    if unnumbered:
        raise ValueError(f"devices {unnumbered}: give each rank's card its "
                         "index (cuda:r)")
    devices = [str(d) for d in devices]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="air_tpu_torch_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, backend, devices[r], store, fn,
                               args, results))
             for r in range(world)]
    values, error, started = {}, None, []
    try:
        for p in procs:
            p.start()
            started.append(p)
        deadline = time.monotonic() + (float("inf") if timeout is None
                                       else timeout)
        while len(values) < world and error is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.name for r, p in enumerate(procs)
                        if r not in values and p.exitcode not in (None, 0)]
                codes = [p.exitcode for p in procs]
                if dead:
                    error = RuntimeError(f"{', '.join(dead)} died (exit "
                                         f"codes {codes})")
                elif time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(values))
                    error = TimeoutError(f"ranks {missing} did not return "
                                         f"within {timeout} s")
                continue
            if ok:
                values[rank] = value
            else:
                error = RuntimeError(f"rank {rank} of {world} failed:\n"
                                     f"{value}")
    finally:
        for p in started:
            # a failed rank or an interrupted launch ends the others
            if p.is_alive() and (error is not None or len(values) < world):
                p.terminate()
            p.join(JOIN_SECONDS)
            if p.is_alive():
                p.kill()
                p.join(JOIN_SECONDS)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise error
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
    return [values[r] for r in range(world)]
