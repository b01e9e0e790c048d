"""Train steps replayed as CUDA graphs, and the device-resident K-step loop.

Counterpart of ``air_tpu/train/fast_pipeline.py``. The JAX package runs K
train steps in one dispatch: ``jax.jit`` of a ``lax.scan`` over the step,
each step gathering its batch from the device-resident set through the
epoch's permutation. Here one train step is captured as a CUDA graph on
its first call (``StepGraph``) and replayed once per step, so the host
launches one graph a step instead of the step's ~2,500 kernels.
``pipeline_unroll`` (the JAX package's scan unroll, which changes XLA's
fusion scope and so its numbers) is taken and checked, and every step
stays one replay of the one-step graph, with the bits of U = 1: a graph
of U steps ran no faster on the card, since the host fills a step's slots
in less time than the card runs the step (PERF.md).

A graph replays the addresses and the host scalars it was captured with,
so what changes from step to step reaches it through static slots,
written before each replay:

  * the step's scalars (``steps.host_scalars``: the annealed
    hyperparameters, the background intensity, Adam's bias corrections and
    step size), resolved on the host from the Python step as the eager
    step resolves them; a call's K rows cross to the device in one copy
    and each replay's row is copied on the device into the scalars slot;
  * the batch, gathered on the device from the permutation
    (``data.loader.gather_batch``, clamped to the last full batch);
  * the draws, from the eager step's generator ``step_generator(seed,
    step)``, drawn into the noise slots.

The state lives in static buffers that the graph overwrites: a call
returns a state that aliases them, and the next call takes it without a
copy (the JAX package's donation). A state the step did not return (a
fresh or restored one, the instrumented step's) is copied in and not
changed. Metrics come back as [K] tensors, copied on the device out of
each replay. The steps give the eager step's bits: the same body
(``steps.make_step_body``) on the same values.

The data-parallel step (``make_parallel_multi_step``, one per rank of a
``parallel.mesh.Mesh``) gathers this rank's rows of each batch and of its
draws, and replays two graphs around the data axis's all-reduce of the
gradients, which stays eager (``ParallelMultiStep``).

On the CPU (the tests) the same slots are filled and the body is called
eagerly; nothing on the card falls back to that path.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import torch

from air_tpu_torch.data.loader import DeviceDataPipeline, gather_batch
from air_tpu_torch.kernels import st_fused, st_inline, st_pallas
from air_tpu_torch.models.air import draw_noise, noise_shapes
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.parallel.collectives import data_sum_
from air_tpu_torch.train.state import TrainState, make_optimizer
from air_tpu_torch.train.steps import (FORWARD_METRICS, TRAIN_METRICS,
                                       check_step_options, data_mean,
                                       device_scalars, host_scalars,
                                       local_noise, make_grad_body,
                                       make_step_body, make_update_body,
                                       pack_grads, step_generator)
from air_tpu_torch.tree import tree_leaves, tree_unflatten

__all__ = ["CapturedStep", "DeviceDataPipeline", "ParallelMultiStep",
           "StepGraph", "check_unroll", "make_multi_step",
           "make_parallel_multi_step"]

# the kernel modules whose LAUNCHES a replay adds to
KERNEL_MODULES = (st_inline, st_fused, st_pallas)
# warm-up runs of a step before its capture, on a side stream
WARMUP = 2


def _launches() -> list:
    return [dict(m.LAUNCHES) for m in KERNEL_MODULES]


def _set_launches(counts: list) -> None:
    for module, c in zip(KERNEL_MODULES, counts):
        module.LAUNCHES.update(c)


def state_leaves(state: TrainState) -> list:
    """The tensors of a state: params, then Adam's mu and nu."""
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu))


class StepGraph:
    """A train step (or a part of one) over static tensors. ``fn()`` reads
    the slots and the state ``buffers`` it closes over and returns (the new
    state's leaves, a metrics tensor or None); ``run()`` writes the new
    leaves into ``buffers`` and returns the metrics, valid until the next
    run.

    On the card the first ``run`` calls ``fn`` WARMUP times on a side
    stream and drops the results (the kernels' shared-memory attributes,
    cuBLAS and cuDNN handles and workspaces are set up outside the
    capture), then captures ``fn`` and the copy into ``buffers`` as one
    CUDA graph, with Python's garbage collector held off; every run
    replays it. A capture or a replay that fails raises. The kernel
    launches counted while the graph is captured are its launches per
    replay: each replay adds them to the kernel modules' ``LAUNCHES``, and
    the warm-up and the capture add nothing. On the CPU each run calls
    ``fn``."""

    def __init__(self, fn, buffers: list, device: torch.device):
        self.fn, self.buffers, self.device = fn, buffers, device
        self.graph = None
        self.launches = None        # per replay, as _launches() lists them
        self.metrics = None

    def run(self) -> torch.Tensor:
        if self.device.type != "cuda":
            new, metrics = self.fn()
            torch._foreach_copy_(self.buffers, new)
            return metrics
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for module, moved in zip(KERNEL_MODULES, self.launches):
            for name, n in moved.items():
                module.LAUNCHES[name] += n
        return self.metrics

    def _capture(self) -> None:
        before = _launches()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn()
        current.wait_stream(side)
        _set_launches(before)
        graph = torch.cuda.CUDAGraph()
        # a dead reference cycle holding another graph or its memory must
        # not be collected while this graph captures: freeing them then
        # invalidates the capture. So collect first, and not during it
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            # CUDA calls of other threads (the host loader's copies, the
            # process group's watchdog querying its collectives' events)
            # do not invalidate the capture; this thread's unsafe ones do
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                new, self.metrics = self.fn()
                torch._foreach_copy_(self.buffers, new)
        finally:
            if was_enabled:
                gc.enable()
        captured = _launches()
        self.launches = [{k: after[k] - was[k] for k in after
                          if after[k] != was[k]}
                         for after, was in zip(captured, before)]
        _set_launches(before)
        self.graph = graph


def check_unroll(pipeline_unroll) -> int:
    """``pipeline_unroll`` as an int >= 1, else ``ValueError``."""
    if (isinstance(pipeline_unroll, bool)
            or int(pipeline_unroll) != pipeline_unroll
            or pipeline_unroll < 1):
        raise ValueError(f"pipeline_unroll must be an integer >= 1, got "
                         f"{pipeline_unroll!r}")
    return int(pipeline_unroll)


class CapturedStep:
    """What the single-seed and the seed-parallel captured steps share:
    the state buffers, a ``StepGraph`` of ``self.body`` over static slots,
    and a call's loop. A subclass sets ``body`` and ``metric_names`` and
    gives ``_run`` a call's host rows ({name: [k, ...] float32 host
    tensor}), ``fill(i, slots)`` (step i's batch), ``draw(i, slots)``
    (step i's draws) and ``new_slots()`` (the slots, on the first call:
    ``images``, ``targets``, ``noise``; ``row`` is added here)."""

    body = None
    metric_names: tuple = ()
    graph = None

    def _setup(self, state: TrainState, slots, names: list) -> None:
        buffers = [torch.empty_like(t) for t in state_leaves(state)]
        n_p = len(tree_leaves(state.params))
        n_m = len(tree_leaves(state.opt_state.mu))
        params = tree_unflatten(state.params, buffers[:n_p])
        mu = tree_unflatten(state.opt_state.mu, buffers[n_p:n_p + n_m])
        nu = tree_unflatten(state.opt_state.nu, buffers[n_p + n_m:])
        self.slots, self.names, self.trees = slots, names, (params, mu, nu)
        self.graph = StepGraph(self._step_fn(params, mu, nu, slots, names),
                               buffers, slots.images.device)

    def _step_fn(self, params, mu, nu, slots, names):
        """The function ``StepGraph`` captures: the body on the state
        buffers' trees and the slots."""
        # fn holds no reference to self: a dropped step, its graph and the
        # graph's memory pool go when the last reference does, not at some
        # later collection of a reference cycle
        body, metric_names = self.body, self.metric_names

        def fn():
            new_p, new_mu, new_nu, metrics = body(
                params, mu, nu, slots.images, slots.targets, slots.noise,
                device_scalars(slots.row, names))
            return (tree_leaves(new_p) + tree_leaves(new_mu)
                    + tree_leaves(new_nu),
                    torch.stack([metrics[k] for k in metric_names]))

        return fn

    def _replay(self) -> torch.Tensor:
        """One step from the filled slots: its metrics tensor."""
        return self.graph.run()

    def _run(self, state: TrainState, rows: dict, fill, draw, new_slots):
        names = list(rows)
        rows = torch.stack(list(rows.values()))
        if self.graph is None:
            slots = new_slots()
            slots.row = torch.empty((len(names), *rows.shape[2:]),
                                    dtype=torch.float32,
                                    device=slots.images.device)
            self._setup(state, slots, names)
        elif names != self.names:
            raise ValueError(f"step scalars {names}, captured with "
                             f"{self.names}")
        graph, slots = self.graph, self.slots
        leaves = state_leaves(state)
        if any(a is not b for a, b in zip(leaves, graph.buffers)):
            torch._foreach_copy_(graph.buffers, leaves)
        rows = rows.to(graph.device)
        k = rows.shape[1]
        out = torch.empty((len(self.metric_names), *rows.shape[1:]),
                          dtype=torch.float32, device=graph.device)
        for i in range(k):
            fill(i, slots)
            draw(i, slots)
            slots.row.copy_(rows[:, i])
            out[:, i].copy_(self._replay())
        params, mu, nu = self.trees
        opt = state.opt_state
        new_state = TrainState(
            params=params,
            opt_state=opt._replace(
                count=opt.count + k, mu=mu, nu=nu,
                schedule_count=(None if opt.schedule_count is None
                                else opt.schedule_count + k)),
            step=state.step + k, seed=state.seed)
        return new_state, dict(zip(self.metric_names, out.unbind()))


def copy_noise(slots, noise) -> None:
    """Given draws (a dict of tensors or arrays) into the noise slots."""
    for name, t in slots.noise.items():
        t.copy_(torch.as_tensor(noise[name]))


class MultiStep(CapturedStep):
    """``make_multi_step``'s step: ``__call__`` runs ``num_steps`` (or a
    call's ``num_steps``) steps on batches of a device-resident set,
    ``step`` one step on a given batch; one captured train step replayed
    per step."""

    def __init__(self, config: AIRConfig, num_steps: int, batch_size: int,
                 bg_image=None, bg_schedule=None, pipeline_unroll: int = 1):
        check_step_options(bg_image, bg_schedule)
        check_unroll(pipeline_unroll)
        self.config, self.num_steps = config, num_steps
        self.batch_size = batch_size
        # the rows of each batch that this step trains on: all of them
        self.rows, self.offset = batch_size, 0
        self.bg_schedule = bg_schedule if bg_image is not None else None
        self.optimizer = make_optimizer(config)
        self.body = make_step_body(config, bg_image)
        self.metric_names = TRAIN_METRICS + (
            ("bg_intensity",) if bg_image is not None else ())

    def __call__(self, state: TrainState, images, digits, perm, start,
                 noise=None, num_steps: int | None = None):
        """Steps on batches ``start, start + 1, ...`` of ``perm``: (the
        state after them, {metric: [k] tensor})."""
        k = self.num_steps if num_steps is None else num_steps
        start = int(start)

        def fill(i, slots):
            gather_batch(images, digits, perm, start + i, self.batch_size,
                         out=(slots.images, slots.targets),
                         offset=self.offset, rows=self.rows)

        return self._steps(state, k, fill, noise, images, digits)

    def step(self, state: TrainState, images, targets, noise=None):
        """One step on the batch ``images``, ``targets`` (this rank's rows
        of it, for ``ParallelMultiStep``): (the state after it, {metric:
        0-d tensor})."""
        def fill(i, slots):
            slots.images.copy_(images)
            slots.targets.copy_(targets)

        state, metrics = self._steps(state, 1, fill,
                                     None if noise is None else [noise],
                                     images, targets)
        return state, {k: v[0] for k, v in metrics.items()}

    def _steps(self, state: TrainState, k: int, fill, noise, images,
               targets):
        config = self.config
        device = images.device
        opt = state.opt_state
        rows = [host_scalars(
            config, self.optimizer, state.step + i,
            opt._replace(count=opt.count + i, schedule_count=(
                None if opt.schedule_count is None
                else opt.schedule_count + i)),
            bg_schedule=self.bg_schedule) for i in range(k)]

        def draw(i, slots):
            self._draw(slots, None if noise is None else noise[i],
                       step_generator(state.seed, state.step + i, device))

        def new_slots():
            return SimpleNamespace(
                images=torch.empty((self.rows, images.shape[-1]),
                                   dtype=torch.float32, device=device),
                targets=torch.empty((self.rows,), dtype=targets.dtype,
                                    device=device),
                noise={name: torch.empty(shape, dtype=torch.float32,
                                         device=device)
                       for name, shape in noise_shapes(config,
                                                       self.rows).items()})

        return self._run(state, {name: torch.tensor([r[name] for r in rows],
                                                    dtype=torch.float32)
                                 for name in rows[0]},
                         fill, draw, new_slots)

    def _draw(self, slots, noise, generator) -> None:
        """A step's draws into the slots: ``noise`` when given, else from
        the step's ``generator``."""
        if noise is not None:
            copy_noise(slots, noise)
        else:
            draw_noise(self.config, self.batch_size, generator,
                       slots.images.device, out=slots.noise)


class ParallelMultiStep(MultiStep):
    """``make_parallel_multi_step``'s step: ``MultiStep`` on this rank's
    rows of every global batch, the gradients averaged over the mesh's
    data axis. A step replays two graphs around an eager all-reduce:
    ``grad_graph`` (the forward and backward passes into one flat buffer of
    the gradients and the forward metrics, ``steps.pack_grads``), the
    all-reduce of that buffer over the data axis (gloo runs it on the host,
    where no graph can hold it), and ``graph`` (the mean, the optimizer and
    the state copy). Each graph adds the launches its capture counted.

    The mesh's model axis must be 1, as the JAX package's step replicates
    its state: a model axis puts collectives inside the forward and the
    norms, where no graph can hold gloo's (``make_parallel_train_step``
    runs it, eagerly)."""

    grad_graph = None

    def __init__(self, config: AIRConfig, num_steps: int, batch_size: int,
                 mesh, bg_image=None, bg_schedule=None,
                 pipeline_unroll: int = 1):
        if mesh.model != 1:
            raise ValueError(
                f"make_parallel_multi_step is data-parallel only: a mesh of "
                f"model axis {mesh.model}; train a model axis with "
                "parallel.train_parallel.make_parallel_train_step")
        if batch_size % mesh.data != 0:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"data axis size {mesh.data}")
        super().__init__(config, num_steps, batch_size, bg_image,
                         bg_schedule, pipeline_unroll)
        self.mesh = mesh
        # this rank's rows of each batch
        self.rows = batch_size // mesh.data
        self.offset = mesh.data_rank * self.rows
        self.grad_body = make_grad_body(config, bg_image, mesh)
        self.update_body = make_update_body(config, mesh=mesh)

    def _step_fn(self, params, mu, nu, slots, names):
        grad, update = self.grad_body, self.update_body
        metric_names, mesh = self.metric_names, self.mesh
        flat = torch.empty(
            sum(t.numel() for t in tree_leaves(params))
            + len(FORWARD_METRICS), dtype=torch.float32,
            device=slots.images.device)

        def grad_fn():
            grads, forward = grad(params, slots.images, slots.targets,
                                  slots.noise,
                                  device_scalars(slots.row, names))
            return [pack_grads(grads, forward)], None

        def update_fn():
            grads, forward = data_mean(flat, params, mesh)
            new_p, new_mu, new_nu, metrics = update(
                params, mu, nu, grads, forward,
                device_scalars(slots.row, names))
            return (tree_leaves(new_p) + tree_leaves(new_mu)
                    + tree_leaves(new_nu),
                    torch.stack([metrics[k] for k in metric_names]))

        self.grad_graph = StepGraph(grad_fn, [flat], slots.images.device)
        return update_fn

    def _replay(self) -> torch.Tensor:
        self.grad_graph.run()
        data_sum_(self.grad_graph.buffers[0], self.mesh)
        return self.graph.run()

    def _draw(self, slots, noise, generator) -> None:
        """This rank's rows of the global batch's draws (``noise``, or drawn
        from the step's ``generator``) into the slots."""
        if noise is None:
            noise = draw_noise(self.config, self.batch_size, generator,
                               slots.images.device)
        copy_noise(slots, local_noise(noise, self.mesh))


def make_multi_step(config: AIRConfig, num_steps: int, batch_size: int,
                    bg_image=None, bg_schedule=None,
                    pipeline_unroll: int = 1) -> MultiStep:
    """Returns ``multi_step(state, images, digits, perm, start, noise=None,
    num_steps=None) -> (state, metrics)``: ``num_steps`` train steps, step i
    on rows ``perm[lo:lo + batch_size]``, ``lo = (start + i) * batch_size``
    (clamped to the last full batch), of the device-resident ``images``
    [N, canvas**2] and ``digits`` [N]. Metrics come back as [k] tensors. A
    call's ``num_steps`` runs a shorter (or longer) chunk through the same
    graph. ``noise``, k dicts of draws, overrides the step's generator (the
    tests feed JAX's draws). ``multi_step.step(state, images, targets)``
    runs one step on a given batch (the host loop's).

    The returned state aliases the step's buffers, which its next call
    overwrites: a caller that keeps a state across calls clones it. A
    state it did not return is copied in and left unchanged.

    ``pipeline_unroll`` must be an int >= 1 (else ``ValueError``); every
    step is one replay whatever its value, with the bits of U = 1."""
    return MultiStep(config, num_steps, batch_size, bg_image, bg_schedule,
                     pipeline_unroll)


def make_parallel_multi_step(config: AIRConfig, num_steps: int,
                             batch_size: int, mesh, bg_image=None,
                             bg_schedule=None,
                             pipeline_unroll: int = 1) -> ParallelMultiStep:
    """The data-parallel ``make_multi_step``, run by every rank of ``mesh``
    (a ``parallel.mesh.Mesh``): the same call, on the device-resident set
    replicated on each rank's device, ``batch_size`` the GLOBAL batch. Rank
    ``r`` of the data axis trains on rows ``lo + r * b`` to ``lo + (r + 1)
    * b`` of each batch (``lo = (start + i) * batch_size``, ``b =
    batch_size / data``) and keeps those rows of the global batch's draws
    (``step_generator(seed, step)``); the gradients and the forward
    metrics are averaged over the data axis before the optimizer
    (``ParallelMultiStep``). A world of one gives ``make_multi_step``'s
    bits. ``ValueError`` if ``batch_size`` does not divide by the data
    axis, the mesh has a model axis or ``pipeline_unroll`` is not an int
    >= 1; a step replays its two graphs around the eager all-reduce
    whatever ``pipeline_unroll``."""
    return ParallelMultiStep(config, num_steps, batch_size, mesh, bg_image,
                             bg_schedule, pipeline_unroll)
