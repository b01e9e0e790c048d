"""Training driver.

Counterpart of ``air_tpu/train/trainer.py``:
  * results folder layout with auto-renaming or overwrite, and a refusal to
    wipe a folder that holds checkpoints unless asked
    (reference training.py:42-62), plus a source snapshot (63-71);
  * tiered summary cadence on the FULL test set through the eval model,
    variable and gradient summaries (reference training.py:20-26,167-218);
  * checkpoints with restore-or-init resume that is exact: the loader's
    position and the stall-recovery bookkeeping go in the sidecar;
  * stall detection with re-seeded restarts and a rotated schedule (the
    device-data loop only, as in the JAX package);
  * per-iteration stdout line (reference training.py:226).

Two loops, both through one train step captured as a CUDA graph and
replayed once per step (``fast_pipeline.make_multi_step``; on the CPU its
body runs eagerly). The host loop feeds each step a batch from the
prefetching ``TrainLoader``. The device-data loop keeps the train set on
the card (``DeviceDataPipeline``) and runs up to ``multi_step`` steps per
host iteration, each gathering its batch on the card through the epoch's
permutation; the host fetches values only at log and event boundaries. The
JAX package runs those steps as one jitted scan; both give the eager
step's numerics. The instrumented gradient-summary step runs eagerly
(``make_train_step(with_grad_stats=True)``); a state it returns, a restored
one or a restart's fresh one is copied into the captured step's buffers on
its next call, and a schedule rotation rebuilds (and so recaptures) it.

Train-step draws come from ``(state.seed, state.step)``
(``steps.step_generator``); eval draws from ``(seed ^ 0x5EED, step)``, where
the JAX package folds the step into ``PRNGKey(seed ^ 0x5EED)``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from air_tpu_torch.data.loader import (DeviceDataPipeline, TrainLoader,
                                       to_device)
from air_tpu_torch.data.records import read_records
from air_tpu_torch.models.air import AIROutputs
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.train.checkpoint import (checkpoint_meta,
                                            latest_checkpoint,
                                            load_checkpoint, save_checkpoint)
from air_tpu_torch.train.evaluate import evaluate_params
from air_tpu_torch.parallel.collectives import broadcast_object
from air_tpu_torch.parallel.mesh import make_mesh, shard_batch
from air_tpu_torch.train.fast_pipeline import (check_unroll,
                                               make_multi_step,
                                               make_parallel_multi_step)
from air_tpu_torch.train.metrics import (MetricsWriter, named_leaves,
                                         summarize_outputs, to_host,
                                         variable_summaries)
from air_tpu_torch.train.state import create_train_state
from air_tpu_torch.train.steps import (make_eval_step,
                                       make_eval_summary_step,
                                       make_train_step, step_generator)
from air_tpu_torch.train.visualize import (save_grid_png,
                                           visualize_reconstructions)
from air_tpu_torch.utils.profiling import StepTimer


def _quiet(*args, **kwargs) -> None:
    """The stdout of a rank other than 0: nothing."""


class _NoMetrics:
    """The metrics sink of a rank other than 0: writes nothing."""

    def write(self, step, scalars, prefix=""):
        pass

    def write_histograms(self, step, arrays, prefix=""):
        pass

    def close(self):
        pass


@dataclasses.dataclass
class TrainerConfig:
    results_folder: str = "air_results"
    overwrite_results: bool = False
    batch_size: int = 64
    epochs: int | None = 300
    max_iterations: int | None = None        # extra stop knob (reference: epochs only)
    stop_at_accuracy: float | None = None    # stop once test accuracy >= this
    # -- stall detection / auto-recovery -------------------------------------
    # AIR training has a known degenerate-counting basin: the run pins DEAD
    # FLAT at ~0.63 accuracy while healthy slow convergers keep climbing
    # through the same absolute level. Detection is therefore slope-based:
    # from stall_detect_step on, a run is declared stalled when accuracy is
    # below stall_accuracy AND has improved less than stall_min_progress
    # over the last stall_window steps; it restarts from a fresh re-seeded
    # init (annealing clock included), bounded by max_restarts.
    # stall_window=0 degrades to a pure absolute threshold. None/0 detect
    # step disables.
    stall_detect_step: int | None = None
    stall_accuracy: float = 0.95
    stall_window: int = 20000
    stall_min_progress: float = 0.01
    # a run at/above this accuracy is spared from restart/give-up — it is
    # in the good basin, just slow (see is_stalled docstring)
    stall_spare_accuracy: float = 0.85
    max_restarts: int = 3
    # Restart schedule ROTATION: on the n-th auto-restart, overlay
    # restart_schedule_rotation[(n-1) % len] onto the model config's
    # annealing_schedules (value None deletes a key) and rebuild the train
    # step. Empty = re-seed only. Evaluation always runs at the BASE config
    # (comparable accuracy). The attempt index, active schedule variant and
    # eval history go in the checkpoint sidecar, so a process killed
    # mid-rescue resumes the SAME attempt.
    restart_schedule_rotation: tuple = ()
    # Stride for attempt_seed: the n-th restart trains at
    # seed + stride * n.
    attempt_seed_stride: int = 1009
    # When the restart budget is exhausted and the run stalls AGAIN, stop
    # early (report the stalled accuracy).
    stop_on_exhausted_restarts: bool = True
    num_summaries_every: int = 50            # reference training.py:20
    var_summaries_every: int = 250           # reference training.py:21
    img_summaries_every: int = 500           # reference training.py:22
    grad_summaries_every: int = 100          # reference training.py:24
    save_params_every: int = 10000           # reference training.py:25
    num_images_to_save: int = 60             # reference training.py:26
    eval_batch_size: int = 1000
    seed: int = 0
    log_every: int = 1                       # stdout cadence
    source_snapshot: bool = True
    tensorboard: bool = False
    resume: bool = True
    # device-resident pipeline: dataset on the card, up to multi_step steps
    # per host iteration
    device_data: bool = False
    multi_step: int = 50
    # the JAX package's scan unroll of its fused K-step dispatch: an int
    # >= 1; every step stays one replay, with the bits of 1
    pipeline_unroll: int = 1
    # data parallelism: one Trainer per rank of a process group
    # (air_tpu_torch.parallel.launch; python -m air_tpu_torch.training
    # --data-parallel spawns them), batches split over the mesh's "data"
    # axis; n_devices=None -> every rank of the group
    data_parallel: bool = False
    n_devices: int | None = None
    # host-loader gather threads (native C++ backend; reference
    # training.py:38 -t/--reader-threads)
    reader_threads: int = 4
    # background-intensity curriculum (harder scenes): composite
    # clip(images + s(step) * bg_image, 0, 1) inside the train step, with s
    # ramped per bg_schedule ({target, start, ramp}; steps.bg_intensity).
    bg_image: object = None
    bg_schedule: dict | None = None
    # learn_background parameter init: None -> blank sigmoid(-4) canvas;
    # "data" -> estimate the texture from the train set
    # (data.backgrounds.estimate_background) or, under the curriculum,
    # from target * bg_image; or an explicit pixel-space [canvas**2] array.
    background_init: object = None
    # the device the model trains on ("cuda", or "cpu" for the tests)
    device: str = "cuda"

    def __post_init__(self):
        # stride 0 would make every auto-restart reuse the base seed,
        # silently burning the whole restart budget on identical attempts
        if self.attempt_seed_stride == 0:
            raise ValueError("attempt_seed_stride must be nonzero (0 would "
                             "retry the identical attempt every restart)")


# Built-in rotation for restart_schedule_rotation, the JAX package's: the
# base attempt runs whatever the model config says; restarts then try:
DEFAULT_RESTART_ROTATION = (
    # 1st restart: the unmodified reference schedule
    {"z_pres_prior_log_odds": {"init": 1e4, "min": 1e-9, "factor": 0.1,
                               "iters": 3000, "log": True}},
    # 2nd restart: scale-prior curriculum — start the prior at mean 0
    # (25px windows) and decay to the reference -1 (13-19px)
    {"scale_prior_mean": {"init": 1.0, "min": 0.0, "factor": 0.5,
                          "iters": 5000, "offset": -1.0}},
    # 3rd restart: keep the hold, anneal the Concrete temperature 5 -> 1
    {"z_pres_temperature": {"init": 5.0, "min": 1.0, "factor": 0.5,
                            "iters": 5000, "log": False}},
    # 4th restart: double grace window + temperature anneal
    {"z_pres_prior_log_odds": {"init": 1e4, "min": 1e-9, "factor": 0.1,
                               "iters": 3000, "log": True, "hold": 30000},
     "z_pres_temperature": {"init": 5.0, "min": 1.0, "factor": 0.5,
                            "iters": 5000, "log": False}},
    # 5th restart: reference schedule + temperature anneal
    {"z_pres_prior_log_odds": {"init": 1e4, "min": 1e-9, "factor": 0.1,
                               "iters": 3000, "log": True},
     "z_pres_temperature": {"init": 5.0, "min": 1.0, "factor": 0.5,
                            "iters": 5000, "log": False}},
)


def is_stalled(history, step: int, acc: float, detect_step,
               stall_accuracy: float, window: int,
               min_progress: float, spare_accuracy: float = 0.0) -> bool:
    """Slope-based stall predicate (pure): stalled iff past
    ``detect_step``, below ``stall_accuracy``, AND — when ``window`` > 0 —
    improved less than ``min_progress`` over the last ``window`` steps of
    ``history`` ([(step, acc), ...] for the CURRENT attempt).

    Progress over the window is estimated TWO ways, and either spares:
      1. point-to-point: ``acc`` minus the last eval at/before
         ``step - window``;
      2. a least-squares slope fit over ALL evals in the window, scaled
         to the window length (robust to one noisy eval dip).

    ``spare_accuracy``: a run at/above this accuracy is in the GOOD basin
    (merely converging slowly), never the degenerate-counting one; 0
    disables."""
    if not detect_step or step < detect_step or acc >= stall_accuracy:
        return False
    if spare_accuracy and acc >= spare_accuracy:
        return False
    if window:
        past = [a for s, a in history if s <= step - window]
        if not past:
            return False                 # not enough history yet
        if acc - past[-1] >= min_progress:
            return False                 # still climbing — not stalled
        # regression slope over the window (include the current point in
        # case the caller's history snapshot does not already carry it)
        pts = [(s, a) for s, a in history if s >= step - window]
        if not pts or pts[-1][0] != step:
            pts.append((step, acc))
        if len(pts) >= 3:
            xs = np.asarray([s for s, _ in pts], np.float64)
            ys = np.asarray([a for _, a in pts], np.float64)
            xs -= xs.mean()
            denom = float((xs * xs).sum())
            if denom > 0:
                slope = float((xs * (ys - ys.mean())).sum()) / denom
                if slope * window >= min_progress:
                    return False         # climbing through the noise
    return True


def cadence_hit(step: int, every) -> bool:
    """True when ``step`` lands on the cadence; 0/None = disabled."""
    return bool(every) and every > 0 and step % every == 0


def attempt_seed(base_seed: int, attempt: int, stride: int = 1009) -> int:
    """Derived seed for the n-th auto-restart attempt (params AND data
    order). ``stride`` must be nonzero."""
    if stride == 0:
        raise ValueError("attempt_seed stride must be nonzero")
    return base_seed + stride * attempt


def prepare_results_folder(cfg: TrainerConfig) -> str:
    """Create results dirs; auto-rename unless overwriting
    (reference training.py:42-62). A folder is reused only to resume from
    its checkpoints, and wiped only with ``overwrite_results``."""
    folder = cfg.results_folder
    if os.path.exists(folder):
        if cfg.overwrite_results:
            shutil.rmtree(folder, ignore_errors=True)
        elif not cfg.resume or latest_checkpoint(
                os.path.join(folder, "models")) is None:
            base, i = folder, 0
            folder = f"{base}_{i}"
            while os.path.exists(folder):
                i += 1
                folder = f"{base}_{i}"
    for sub in ("models", "summary", "source"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    return folder


def snapshot_source(folder: str):
    """Copy the port's source next to the results — cheap provenance
    (reference training.py:63-71); built libraries and assets stay out."""
    import air_tpu_torch
    src_root = os.path.dirname(os.path.abspath(air_tpu_torch.__file__))
    dst = os.path.join(folder, "source", "air_tpu_torch")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.so", "_build", "assets"))


class Trainer:
    def __init__(self, model_config: AIRConfig, trainer_config: TrainerConfig,
                 train_data, test_data):
        """``train_data``: AIRREC path or (images, digits);
        ``test_data``: (images [N, canvas^2], digits [N]) numpy arrays."""
        tcfg = trainer_config
        # before the results folder is made: the steps are built later
        check_unroll(tcfg.pipeline_unroll)
        self.mesh = None
        if tcfg.data_parallel:
            if not dist.is_initialized():
                raise RuntimeError(
                    "data_parallel runs one Trainer per rank of a process "
                    "group: start the ranks with air_tpu_torch.parallel."
                    "launch (python -m air_tpu_torch.training "
                    "--data-parallel does)")
            self.mesh = make_mesh(tcfg.n_devices)
        # only rank 0 writes: the results folder, logs, summaries and
        # checkpoints; the others train in step with it
        self.rank0 = self.mesh is None or self.mesh.rank == 0
        self._print = print if self.rank0 else _quiet
        self.config = model_config.replace(train=True)
        # the ACTIVE training config: starts as the base config; restart
        # schedule rotation replaces it per attempt. Evaluation always
        # uses self.config so accuracies stay comparable across attempts.
        self.train_config = self.config
        self.tcfg = tcfg
        self.device = torch.device(tcfg.device)
        if self.rank0:
            self.folder = prepare_results_folder(tcfg)
            if tcfg.source_snapshot:
                snapshot_source(self.folder)
        if self.mesh is not None:
            self.folder = broadcast_object(
                self.folder if self.rank0 else None)
        self.models_dir = os.path.join(self.folder, "models")
        self.summary_dir = os.path.join(self.folder, "summary")

        if tcfg.device_data:
            if isinstance(train_data, str):
                rec = read_records(train_data)
                train_data = (rec["images"], rec["digits"])
            self.loader = DeviceDataPipeline(
                train_data[0], train_data[1], tcfg.batch_size,
                seed=tcfg.seed, device=self.device)
        else:
            put = to_device(self.device)
            if self.mesh is not None:
                # every rank loads the global batch and keeps its rows
                put = (lambda batch, put=put:
                       shard_batch(self.mesh, *put(batch)))
            self.loader = TrainLoader(
                train_data, tcfg.batch_size, epochs=tcfg.epochs,
                seed=tcfg.seed, prefetch=2, device_put=put,
                reader_threads=tcfg.reader_threads)
        self.test_images, self.test_digits = test_data

        # resolve the learn_background init (TrainerConfig.background_init)
        self._bg_init = None
        bg_cfg = tcfg.background_init
        if self.config.learn_background and bg_cfg is not None:
            if isinstance(bg_cfg, str) and bg_cfg == "data":
                from air_tpu_torch.data.backgrounds import estimate_background
                if tcfg.bg_image is not None:
                    # curriculum runs train on CLEAN data with the texture
                    # composited in the step — the steady-state background
                    # is target * bg_image, known exactly
                    target = float((tcfg.bg_schedule or {})
                                   .get("target", 1.0))
                    self._bg_init = np.clip(
                        target * np.asarray(tcfg.bg_image,
                                            np.float32).reshape(-1), 0., 1.)
                else:
                    self._bg_init = estimate_background(
                        self.loader.host.images if tcfg.device_data
                        else self.loader.images,
                        self.loader.host.digits if tcfg.device_data
                        else self.loader.digits)
            else:
                self._bg_init = np.asarray(bg_cfg, np.float32).reshape(-1)

        self._build_train_steps()
        self.eval_step = make_eval_step(self.config)
        self.eval_summary_step = make_eval_summary_step(self.config)
        self.metrics = (MetricsWriter(self.summary_dir,
                                      tensorboard=tcfg.tensorboard)
                        if self.rank0 else _NoMetrics())
        # forward passes run, by kind: "train" steps, "grad" (instrumented
        # steps of the grad summaries) and "eval" (each eval forward)
        self.calls = collections.Counter()

        # -- stall auto-recovery bookkeeping (persisted in checkpoints) --
        self.restarts = 0            # auto-restarts consumed so far
        self._variant = -1           # rotation index of the ACTIVE attempt
        self._eval_history = []      # [(step, acc)] of the current attempt

        self.state = self._fresh_state(self.config, tcfg.seed)
        if tcfg.resume:
            ckpt = latest_checkpoint(self.models_dir)
            if ckpt:
                meta = checkpoint_meta(ckpt)
                self.state = load_checkpoint(ckpt, self.config, self.loader,
                                             meta=meta, device=self.device,
                                             mesh=self.mesh)
                self._print(f"resumed from {ckpt} at step {self.state.step}")
                rec = meta.get("recovery")
                if rec:
                    # resume the SAME rescue attempt: restart budget, eval
                    # history (the stall slope window), and the rotated
                    # schedule the attempt was training under
                    self.restarts = int(rec.get("restarts", 0))
                    self._eval_history = [tuple(p) for p in
                                          rec.get("eval_history", [])]
                    variant = int(rec.get("variant", -1))
                    if variant >= 0 and tcfg.restart_schedule_rotation:
                        self._apply_rotation_variant(variant)
                        self._build_train_steps()
                    self._print(f"resumed recovery state: restarts="
                                f"{self.restarts} variant={self._variant}")

    def _save(self, step: int, **kw) -> None:
        """A checkpoint of the state at ``step`` (rank 0 writes it)."""
        save_checkpoint(self.models_dir, self.state, step, mesh=self.mesh,
                        config=self.config, **kw)

    def _fresh_state(self, config: AIRConfig, seed: int):
        return create_train_state(config, seed=seed,
                                  background_init=self._bg_init,
                                  device=self.device)

    def _build_train_steps(self):
        """(Re)build the train steps from ``self.train_config`` — called at
        init and whenever a restart rotates the schedule: the captured step
        of both loops (captured on its first call) and the eager
        instrumented step."""
        bg_kw = {"bg_image": self.tcfg.bg_image,
                 "bg_schedule": self.tcfg.bg_schedule}
        k, b = self.tcfg.multi_step, self.tcfg.batch_size
        unroll = self.tcfg.pipeline_unroll
        if self.mesh is None:
            self.multi_step = make_multi_step(self.train_config, k, b,
                                              pipeline_unroll=unroll,
                                              **bg_kw)
        else:
            self.multi_step = make_parallel_multi_step(
                self.train_config, k, b, self.mesh, pipeline_unroll=unroll,
                **bg_kw)
        # the host loop's step: one replay on the batch it is given
        self.train_step = self.multi_step.step
        self.train_step_gs = make_train_step(self.train_config,
                                             with_grad_stats=True,
                                             pmean_axis=self.mesh, **bg_kw)

    def _apply_rotation_variant(self, variant: int):
        """Overlay rotation variant ``variant`` onto the BASE annealing
        schedules, producing the active ``self.train_config``."""
        rotation = self.tcfg.restart_schedule_rotation
        overlay = rotation[variant % len(rotation)]
        sched = self.config.schedules        # thawed plain dict
        for name, spec in overlay.items():
            if spec is None:
                sched.pop(name, None)
            else:
                sched[name] = spec
        self.train_config = self.config.replace(annealing_schedules=sched)
        self._variant = variant % len(rotation)

    def recovery_meta(self) -> dict | None:
        """Recovery bookkeeping for the checkpoint sidecar (None when the
        run has never restarted and detection is off)."""
        if self.restarts == 0 and not self.tcfg.stall_detect_step:
            return None
        return {"restarts": self.restarts, "variant": self._variant,
                "eval_history": [[int(s), float(a)]
                                 for s, a in self._eval_history]}

    # -- stall detection / auto-recovery ---------------------------------------
    def _maybe_restart_on_stall(self, step: int, acc: float) -> str | None:
        """``"restart"`` -> the run was declared stalled and state/loader
        were reset to a fresh re-seeded attempt (annealing clock restarts
        with state.step = 0; schedule rotated if configured;
        ``self.restarts`` incremented). ``"giveup"`` -> stalled again with
        the restart budget exhausted (stop_on_exhausted_restarts).
        ``None`` -> keep training."""
        tcfg = self.tcfg
        if not tcfg.stall_detect_step:
            return None
        restarts = self.restarts
        self._eval_history.append((step, acc))
        if not is_stalled(self._eval_history, step, acc,
                          tcfg.stall_detect_step, tcfg.stall_accuracy,
                          tcfg.stall_window, tcfg.stall_min_progress,
                          tcfg.stall_spare_accuracy):
            return None
        if restarts >= tcfg.max_restarts:
            if tcfg.stop_on_exhausted_restarts:
                self._print(f"[stall detected @ {step}] accuracy {acc:.3f} "
                            "flat with restart budget exhausted — giving up "
                            "early")
                return "giveup"
            return None
        self._print(f"[stall detected @ {step}] test accuracy {acc:.3f} < "
                    f"{tcfg.stall_accuracy}; restarting (attempt "
                    f"{restarts + 2}/{tcfg.max_restarts + 1})")
        # archive the stalled attempt's checkpoints so resume never picks a
        # stale higher-step file from a failed attempt
        stale = [f for f in os.listdir(self.models_dir)
                 if f.startswith("air-model")] if self.rank0 else []
        if stale:
            attempt_dir = os.path.join(self.models_dir,
                                       f"stalled_attempt_{restarts + 1}")
            os.makedirs(attempt_dir, exist_ok=True)
            for f in stale:
                shutil.move(os.path.join(self.models_dir, f),
                            os.path.join(attempt_dir, f))
        rotation = tcfg.restart_schedule_rotation
        if rotation:
            self._apply_rotation_variant(restarts)
            self._print(f"[restart] schedule variant {self._variant}: "
                        f"{sorted(rotation[self._variant])}")
        new_seed = attempt_seed(tcfg.seed, restarts + 1,
                                tcfg.attempt_seed_stride)
        self.metrics.write(step, {
            "attempt_ended": restarts + 1, "stalled_accuracy": acc,
            "next_variant": (restarts % len(rotation)) if rotation else -1,
        }, prefix="recovery/")
        self.state = self._fresh_state(self.train_config, new_seed)
        # restart the data position AND re-seed the DATA ORDER
        self.loader.reseed(new_seed)
        self._eval_history = []
        self.restarts = restarts + 1
        return "restart"

    # -- summary helpers -------------------------------------------------------
    def _write_var_summaries(self, step: int):
        """Per-variable scalar stats (JSONL) + true histograms (TB sink);
        reference air/air_model.py:643-649. Rank 0's."""
        if not self.rank0:
            return
        self.metrics.write(step, variable_summaries(self.state.params),
                           prefix="var/")
        if self.tcfg.tensorboard:
            self.metrics.write_histograms(
                step, named_leaves(self.state.params), prefix="var/")

    def _write_grad_summaries(self, step: int, metrics: dict):
        """Pre/post-clip grad stats (JSONL) + true histograms (TB sink);
        reference air/air_model.py:658-687. Pops the heavyweight entries
        from ``metrics`` in place."""
        grad_tensors = metrics.pop("grad_tensors", None)
        self.metrics.write(step, metrics.pop("grad_stats"), prefix="grad/")
        if self.tcfg.tensorboard and grad_tensors is not None:
            hists = {}
            for kind, tree in grad_tensors.items():
                for name, arr in named_leaves(tree).items():
                    hists[f"{name}_grad_{kind}"] = arr
            self.metrics.write_histograms(step, hists, prefix="grad/")

    def _grad_step(self, images, targets):
        self.calls["grad"] += 1
        return self.train_step_gs(self.state, images, targets)

    # -- evaluation over the full test set ----------------------------------------
    def _eval_generator(self, step: int) -> torch.Generator:
        return step_generator(self.tcfg.seed ^ 0x5EED, step, self.device)

    def evaluate(self, step: int) -> AIROutputs:
        """The eval forward over the whole test set in chunks of
        ``eval_batch_size`` (numpy outputs)."""
        gen = self._eval_generator(step)
        n = len(self.test_images)
        self.calls["eval"] += -(-n // self.tcfg.eval_batch_size)
        return evaluate_params(self.eval_step, self.state.params,
                               self.test_images, self.test_digits,
                               batch_size=self.tcfg.eval_batch_size,
                               step=step, draws=lambda lo: {"generator": gen})

    def _test_on_device(self):
        if not hasattr(self, "_test_dev"):
            self._test_dev = (
                torch.from_numpy(np.asarray(self.test_images, np.float32))
                .to(self.device),
                torch.from_numpy(np.asarray(self.test_digits, np.int32))
                .to(self.device))
        return self._test_dev

    def write_eval_summaries(self, step: int, with_images: bool) -> float:
        """The eval summaries of the test set at ``step`` (rank 0 evaluates
        and writes them); returns the test accuracy, rank 0's on every
        rank, so that every rank takes the same decisions on it."""
        if self.mesh is None:
            return self._eval_summaries(step, with_images)
        acc = self._eval_summaries(step, with_images) if self.rank0 else None
        return broadcast_object(acc)

    def _eval_summaries(self, step: int, with_images: bool) -> float:
        n = len(self.test_images)
        if n <= self.tcfg.eval_batch_size:
            # eval + the full metric taxonomy on the card; only the
            # scalars come back, in one copy
            self.calls["eval"] += 1
            summ = to_host(self.eval_summary_step(
                self.state.params, *self._test_on_device(), step,
                generator=self._eval_generator(step)))
        else:
            out = self.evaluate(step)
            summ = to_host(summarize_outputs(
                AIROutputs(*(torch.from_numpy(np.asarray(v)) for v in out)),
                torch.from_numpy(np.asarray(self.test_digits, np.int32)),
                self.config.max_steps, self.config.max_digits))
        self.metrics.write(step, summ, prefix="test/")
        if with_images:
            k = min(self.tcfg.num_images_to_save, n)
            images, digits = (t[:k] for t in self._test_on_device())
            self.calls["eval"] += 1
            out_k = self.eval_step(self.state.params, images, digits, step,
                                   generator=self._eval_generator(step))
            grid = visualize_reconstructions(
                images, out_k.reconstruction, out_k.rec_st_back,
                out_k.rec_num_digits, self.config.canvas_size,
                self.config.windows_size, zoom=2)
            save_grid_png(os.path.join(self.summary_dir,
                                       f"reconstruction_{step}.png"), grid)
        return float(summ["accuracy"])

    # -- device-resident loop ---------------------------------------------------
    def _train_device_data(self):
        """Up to ``multi_step`` steps per host iteration, batches gathered
        on the card; no value comes to the host between events."""
        tcfg = self.tcfg
        K = tcfg.multi_step

        # log_every is NOT an event cadence: chunks span log boundaries and
        # per-step lines are read back from the chunk's metrics (log_steps)
        cadences = [c for c in (tcfg.num_summaries_every,
                                tcfg.save_params_every,
                                tcfg.img_summaries_every,
                                tcfg.grad_summaries_every)
                    if c and c > 0]

        def next_event(step):
            return (min(((step // c) + 1) * c for c in cadences)
                    if cadences else step + K)

        def log_steps(end_step, span, chunk):
            """Reference-parity stdout (training.py:226): one line per log
            boundary crossed by the last chunk of ``span`` steps, and one
            JSONL record of that step's metrics; the chunk's [span] metrics
            come over in one copy."""
            L = tcfg.log_every
            if not L or L <= 0:
                return
            first = ((end_step - span) // L + 1) * L
            if first > end_step:
                return
            host = to_host(chunk)
            for s in range(first, end_step + 1, L):
                i = s - (end_step - span) - 1
                values = {name: v[i] for name, v in host.items()}
                self._print(f"iteration {s}\tloss {float(values['loss']):.3f}\t"
                            f"accuracy {float(values['accuracy']):.2f}")
                self.metrics.write(s, values, prefix="train/")

        t_start = time.time()
        images_seen = 0
        self.timer = StepTimer(warmup=1)
        last_eval = (None, None)             # (step, acc) of the last eval
        step = self.state.step
        total_epochs = tcfg.epochs if tcfg.epochs is not None else 10 ** 9
        max_iters = tcfg.max_iterations
        self._print(f"training[device-data]: batch={tcfg.batch_size} "
                    f"K={K} epochs={tcfg.epochs} start_step={step}")

        while self.loader.epoch < total_epochs:
            if max_iters is not None and step >= max_iters:
                break
            if cadence_hit(step, tcfg.num_summaries_every):
                acc = self.write_eval_summaries(
                    step, cadence_hit(step, tcfg.img_summaries_every))
                last_eval = (step, acc)
                self._print(f"[eval @ {step}] test accuracy {acc:.4f}")
                if tcfg.stop_at_accuracy is not None \
                        and acc >= tcfg.stop_at_accuracy:
                    self._print(f"target accuracy {tcfg.stop_at_accuracy} "
                                "reached")
                    break
                verdict = self._maybe_restart_on_stall(step, acc)
                if verdict == "giveup":
                    break
                if verdict == "restart":
                    step = 0
                    if tcfg.restart_schedule_rotation:
                        self._build_train_steps()
                    continue
                if cadence_hit(step, tcfg.var_summaries_every):
                    self._write_var_summaries(step)
            if cadence_hit(step, tcfg.save_params_every):
                self._save(step, loader_state=self.loader.state(),
                                recovery=self.recovery_meta())
            if cadence_hit(step, tcfg.grad_summaries_every):
                # one instrumented step on the next batch, not applied
                batch = self.loader.gather_batch()
                if self.mesh is not None:
                    batch = shard_batch(self.mesh, *batch)
                _, gm = self._grad_step(*batch)
                self._write_grad_summaries(step, gm)

            k = self.loader.chunk(K)
            # chunk() may have rolled over to a new epoch — re-test the
            # epoch bound so we never train into an extra epoch
            if self.loader.epoch >= total_epochs:
                break
            k = min(k, max(next_event(step) - step, 1))
            if max_iters is not None:
                k = min(k, max_iters - step)
            with self.timer.step(k):
                self.state, chunk = self.multi_step(
                    self.state, self.loader.images, self.loader.digits,
                    self.loader.perm(), self.loader.index, num_steps=k)
                self.calls["train"] += k
                self.loader.advance(k)
                step += k
                images_seen += k * tcfg.batch_size
                log_steps(step, k, chunk)

        final_step = step
        if last_eval[0] == final_step:
            # the loop broke right after an eval at this step (stop-at-
            # accuracy / give-up): don't pay a duplicate full-test pass
            acc = last_eval[1]
        else:
            acc = self.write_eval_summaries(final_step, with_images=True)
        self._save(final_step, loader_state=self.loader.state(),
                        recovery=self.recovery_meta())
        return self._ended(final_step, acc, images_seen, t_start,
                           restarts=self.restarts)

    def _ended(self, final_step, acc, images_seen, t_start, **extra) -> dict:
        """The closing line and result. ``images_per_sec`` is over the whole
        run, events included (the JAX package's figure); ``ms_per_step``
        over the host time of the captured train steps and their logging
        only (``self.timer``); ``first_call_ms``, the first call, which
        captures the step; ``steady_ms_per_step``, the calls after it."""
        wall = time.time() - t_start
        ips = images_seen / wall if wall > 0 else 0.0
        steps = sum(self.timer.items)
        ms = sum(self.timer.times) / steps * 1e3 if steps else 0.0
        summary = self.timer.summary()
        steady = (1e3 / summary["items_per_sec"]
                  if summary["items_per_sec"] else 0.0)
        self._print(f"training has ended: step {final_step}, "
                    f"test accuracy {acc:.4f}, {ips:.0f} images/sec, "
                    f"{ms:.3f} ms/step in the train steps ({steady:.3f} "
                    f"after the first call, which took "
                    f"{summary['first_step_ms']:.1f} ms)")
        return {"step": final_step, "test_accuracy": acc,
                "images_per_sec": ips, "ms_per_step": ms,
                "steady_ms_per_step": steady,
                "first_call_ms": summary["first_step_ms"], **extra}

    def _log_step(self, step: int, metrics: dict) -> None:
        """The host loop's stdout line and JSONL record of a step, at the
        log cadence."""
        if cadence_hit(step, self.tcfg.log_every):
            values = to_host(metrics)
            self._print(f"iteration {step + 1}\tloss "
                        f"{float(values['loss']):.3f}\taccuracy "
                        f"{float(values['accuracy']):.2f}")
            self.metrics.write(step, values, prefix="train/")

    # -- main loop -------------------------------------------------------------
    def train(self):
        if self.tcfg.device_data:
            return self._train_device_data()
        tcfg = self.tcfg
        t_start = time.time()
        images_seen = 0
        self.timer = StepTimer(warmup=1)
        step = self.state.step
        self._print(f"training: batch={tcfg.batch_size} epochs={tcfg.epochs} "
                    f"start_step={step}")
        # loader position to checkpoint: captured BEFORE the current batch
        # was pulled, so a resumed run re-delivers the in-flight batch the
        # saved model state has not trained on yet (exact-resume contract)
        loader_state_snapshot = self.loader.state()
        for images, targets in self.loader:
            step = self.state.step
            if tcfg.max_iterations is not None and step >= tcfg.max_iterations:
                break

            if cadence_hit(step, tcfg.num_summaries_every):
                with_images = cadence_hit(step, tcfg.img_summaries_every)
                acc = self.write_eval_summaries(step, with_images)
                self._print(f"[eval @ {step}] test accuracy {acc:.4f}")
                if tcfg.stop_at_accuracy is not None \
                        and acc >= tcfg.stop_at_accuracy:
                    self._print(f"target accuracy {tcfg.stop_at_accuracy} "
                                "reached")
                    break
                if cadence_hit(step, tcfg.var_summaries_every):
                    self._write_var_summaries(step)

            if cadence_hit(step, tcfg.save_params_every):
                self._save(step, loader_state=loader_state_snapshot,
                                recovery=self.recovery_meta())

            if cadence_hit(step, tcfg.grad_summaries_every):
                self.state, metrics = self._grad_step(images, targets)
                self._write_grad_summaries(step, metrics)
                self._log_step(step, metrics)
            else:
                with self.timer.step(1):
                    self.calls["train"] += 1
                    self.state, metrics = self.train_step(
                        self.state, images, targets)
                    self._log_step(step, metrics)
            loader_state_snapshot = self.loader.state()
            images_seen += tcfg.batch_size

        # final eval + checkpoint. NOTE: loader_state_snapshot, NOT
        # self.loader.state() — a break can fire after the loop pulled an
        # in-flight batch the model never trained on; the snapshot is the
        # position the saved params actually correspond to (exact-resume)
        final_step = self.state.step
        acc = self.write_eval_summaries(final_step, with_images=True)
        self._save(final_step, loader_state=loader_state_snapshot)
        return self._ended(final_step, acc, images_seen, t_start)
