"""AIR model configuration (the port's own copy).

Field for field and default for default the same dataclass as the JAX
package's ``air_tpu/models/config.py``: the checkpoints, the tests and the
serving facade name the same knobs in both packages. The port keeps its own
copy so that it imports nothing of the JAX package.

Knobs that select a JAX/TPU execution strategy (``scan_unroll``) are kept
for surface parity. ``st_pad_mode="clamp_cancel"`` runs on
``st_impl="xla"`` in both decoder layouts; with ``"inline"`` or
``"pallas"`` it raises ``ValueError`` in ``air_tpu_torch.models.air``, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def _freeze(obj):
    """Recursively convert dicts/lists to tuples, so the config hashes."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj):
    """Inverse of _freeze for schedule dicts."""
    if isinstance(obj, tuple) and obj and all(
            isinstance(e, tuple) and len(e) == 2 and isinstance(e[0], str)
            for e in obj):
        return {k: _thaw(v) for k, v in obj}
    return obj


@dataclasses.dataclass(frozen=True)
class AIRConfig:
    # structure
    max_steps: int = 3
    max_digits: int = 2
    rnn_units: int = 256
    canvas_size: int = 50
    windows_size: int = 28
    # VAE
    vae_latent_dimensions: int = 50
    vae_recognition_units: tuple = (512, 256)
    vae_generative_units: tuple = (256, 512)
    # priors
    scale_prior_mean: float = -1.0
    scale_prior_variance: float = 0.1
    shift_prior_mean: float = 0.0
    shift_prior_variance: float = 1.0
    vae_prior_mean: float = 0.0
    vae_prior_variance: float = 1.0
    vae_likelihood_std: float = 0.3
    # heads
    scale_hidden_units: int = 64
    shift_hidden_units: int = 64
    z_pres_hidden_units: int = 64
    # z_pres / stopping
    z_pres_prior_log_odds: float = -2.0
    z_pres_temperature: float = 1.0
    stopping_threshold: float = 0.99
    # optimization
    learning_rate: float = 1e-3
    gradient_clipping_norm: float | None = 100.0
    cnn: bool = True
    cnn_filters: int = 8
    # bookkeeping
    num_summary_images: int = 60
    train: bool = False
    reuse: bool = False      # inert (surface parity)
    scope: str = "air"       # inert (surface parity)
    # annealing: {name: {init, iters, factor, staircase?, min?, max?, log?,
    # hold?, offset?}}
    annealing_schedules: Any = None
    # spatial transformer: "xla" (the plain separable products of
    # ops/transformer.py), "inline" (the hand-written kernels of
    # kernels/st_inline.py, weights built in-kernel from scalars) or
    # "pallas" (streamed-weight kernels: st_pallas.py, st_fused.py)
    st_impl: str = "xla"
    # off-support boundary semantics; the port implements "zeros"
    st_pad_mode: str = "zeros"
    adam_storage_dtype: str = "float32"
    scan_unroll: int = 1
    compute_dtype: str = "float32"
    decoder_layout: str = "scan"
    rnn_input_hoist: bool = False
    # canvas starts at sigmoid(params["background"]) instead of zeros
    learn_background: bool = False
    freeze_background: bool = False

    def __post_init__(self):
        object.__setattr__(self, "vae_recognition_units",
                           tuple(self.vae_recognition_units))
        object.__setattr__(self, "vae_generative_units",
                           tuple(self.vae_generative_units))
        if isinstance(self.annealing_schedules, dict):
            object.__setattr__(self, "annealing_schedules",
                               _freeze(self.annealing_schedules))
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or "
                             f"'bfloat16', got {self.compute_dtype!r}")
        if self.decoder_layout not in ("scan", "stepparallel"):
            raise ValueError(f"decoder_layout must be 'scan' or "
                             f"'stepparallel', got {self.decoder_layout!r}")

    @property
    def schedules(self) -> dict:
        """Annealing schedules as a plain dict (possibly empty)."""
        if self.annealing_schedules is None:
            return {}
        return _thaw(self.annealing_schedules)

    @property
    def rnn_input_dim(self) -> int:
        if self.cnn:
            return (self.canvas_size // 4) ** 2 * self.cnn_filters
        return self.canvas_size ** 2

    def annealable_defaults(self) -> dict:
        """Hyperparameters eligible for annealing, with their static values."""
        return {
            "z_pres_prior_log_odds": self.z_pres_prior_log_odds,
            "z_pres_temperature": self.z_pres_temperature,
            "stopping_threshold": self.stopping_threshold,
            "learning_rate": self.learning_rate,
            "vae_likelihood_std": self.vae_likelihood_std,
            "scale_prior_mean": self.scale_prior_mean,
            "scale_prior_variance": self.scale_prior_variance,
            "shift_prior_mean": self.shift_prior_mean,
            "shift_prior_variance": self.shift_prior_variance,
            "vae_prior_mean": self.vae_prior_mean,
            "vae_prior_variance": self.vae_prior_variance,
        }

    def replace(self, **kw) -> "AIRConfig":
        return dataclasses.replace(self, **kw)


# The default training configuration: raw-pixel encoder (cnn=False), z_pres
# prior log-odds annealed 1e4 -> 1e-9 in log space. The shipped CNN
# checkpoint is served with DEFAULT_TRAINING_CONFIG.replace(cnn=True).
DEFAULT_TRAINING_CONFIG = AIRConfig(
    max_steps=3, max_digits=2, rnn_units=256, canvas_size=50, windows_size=28,
    vae_latent_dimensions=50, vae_recognition_units=(512, 256),
    vae_generative_units=(256, 512),
    scale_prior_mean=-1.0, scale_prior_variance=0.05,
    shift_prior_mean=0.0, shift_prior_variance=1.0,
    vae_prior_mean=0.0, vae_prior_variance=1.0, vae_likelihood_std=0.3,
    scale_hidden_units=64, shift_hidden_units=64, z_pres_hidden_units=64,
    z_pres_prior_log_odds=-0.01, z_pres_temperature=1.0,
    stopping_threshold=0.99,
    learning_rate=1e-4, gradient_clipping_norm=1.0, cnn=False, cnn_filters=8,
    num_summary_images=60, train=True,
    scan_unroll=3, adam_storage_dtype="bfloat16",
    annealing_schedules={
        "z_pres_prior_log_odds": {
            "init": 10000.0, "min": 0.000000001,
            "factor": 0.1, "iters": 3000,
            "staircase": False, "log": True,
        },
    },
)


def pin_raw_pixel_numerics(cnn: bool, adam_dtype: str | None = None,
                           unroll: int | None = None) -> dict:
    """Config overrides of the JAX package's ``pin_raw_pixel_numerics``:
    a raw-pixel run (``cnn=False``) keeps the rolled scan and float32 Adam
    moments unless ``adam_dtype`` / ``unroll`` say otherwise; the CNN
    encoder takes the defaults. Returns kwargs for ``AIRConfig.replace``."""
    if not cnn:
        if unroll is None:
            unroll = 1
        if adam_dtype is None:
            adam_dtype = "float32"
    out = {}
    if adam_dtype is not None:
        out["adam_storage_dtype"] = adam_dtype
    if unroll is not None:
        out["scan_unroll"] = unroll
    return out
