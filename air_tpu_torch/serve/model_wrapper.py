"""Inference serving facade.

Counterpart of ``air_tpu/serve/model_wrapper.py``: ``infer`` takes a list or
array of images and returns ``(digits, positions, reconstructions, windows,
latents, loss)``, with the per-step outputs trimmed to each item's inferred
digit count; ``infer_batch`` returns the whole ``AIROutputs`` as numpy.
Batches are zero-padded up to a bucket size (1, 8, 64, 256, 1024), and
``infer`` packs its outputs into one ``[B, X]`` tensor so that one
device-to-host copy serves the call.

The wrapper runs on ``device`` ("cuda" unless the caller asks for "cpu").
Its draws come from one ``torch.Generator`` seeded with ``seed``, so two
wrappers with the same seed and the same sequence of calls draw the same
noise.

As the JAX package's wrapper does, it serves ``st_impl="xla"`` with the
step-parallel decoder whatever layout the checkpoint trained with (the
params are the same; the layout is a compute path, and the draws are the
scan's), and a kernel path (``"inline"``, ``"pallas"``) with its own
layout; ``decoder_layout`` forces one.
"""

from __future__ import annotations

import numpy as np
import torch

from air_tpu_torch.interop import params_from_jax
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.train.steps import make_eval_step

BUCKETS = (1, 8, 64, 256, 1024)


def _next_bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(n)))


def _pad_to_bucket(batch: np.ndarray):
    """Zero-pad [n, D] up to the next bucket size; returns (padded, n)."""
    n = len(batch)
    if n == 0:
        raise ValueError("infer called with no images")
    bucket = _next_bucket(n)
    if bucket != n:
        batch = np.concatenate(
            [batch, np.zeros((bucket - n, batch.shape[1]), np.float32)])
    return batch, n


class ModelWrapper:
    """``params`` is a checkpoint's parameter tree in the JAX package's layout
    (``air_tpu_torch.train.checkpoint.load_params``)."""

    def __init__(self, config: AIRConfig, params, canvas_size: int | None = None,
                 window_size: int | None = None, seed: int = 0,
                 decoder_layout: str | None = None, device="cuda"):
        if decoder_layout is None:
            decoder_layout = ("stepparallel" if config.st_impl == "xla"
                              else config.decoder_layout)
        self.config = config.replace(train=False,
                                     decoder_layout=decoder_layout)
        if canvas_size is not None and canvas_size != config.canvas_size:
            raise ValueError(f"canvas_size {canvas_size} != "
                             f"config.canvas_size {config.canvas_size}")
        if window_size is not None and window_size != config.windows_size:
            raise ValueError(f"window_size {window_size} != "
                             f"config.windows_size {config.windows_size}")
        self.canvas_size = config.canvas_size
        self.window_size = config.windows_size
        self.device = torch.device(device)
        self.params = params_from_jax(params, self.device)
        self._eval = make_eval_step(self.config)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

        cfg = self.config
        T, cs2, ws2, L = (cfg.max_steps, self.canvas_size ** 2,
                          self.window_size ** 2, cfg.vae_latent_dimensions)
        self._packed_cols = {
            "digits": (0, 1), "scales": (1, 1 + T),
            "shifts": (1 + T, 1 + 3 * T),
            "recon": (1 + 3 * T, 1 + 3 * T + cs2),
            "windows": (1 + 3 * T + cs2, 1 + 3 * T + cs2 + T * ws2),
            "latents": (1 + 3 * T + cs2 + T * ws2,
                        1 + 3 * T + cs2 + T * ws2 + T * L),
            "loss": (1 + 3 * T + cs2 + T * ws2 + T * L,
                     2 + 3 * T + cs2 + T * ws2 + T * L),
        }

    def _forward(self, batch: np.ndarray):
        images = torch.from_numpy(batch).to(self.device)
        targets = torch.zeros((len(batch),), dtype=torch.int32,
                              device=self.device)
        return self._eval(self.params, images, targets, 0,
                          generator=self._generator)

    def infer_batch(self, images: np.ndarray):
        """Raw batched inference: the full AIROutputs, as numpy, for the
        items of a [B, canvas^2] array (padded to a bucket internally)."""
        images = np.asarray(images, np.float32).reshape(len(images), -1)
        images, n = _pad_to_bucket(images)
        out = self._forward(images)
        arrays = {f: v.cpu().numpy() for f, v in zip(out._fields, out)}
        out = out._replace(**{f: a[:n] if a.ndim else a
                              for f, a in arrays.items()})
        # the batch means were taken over the padded bucket; recompute them
        # over the n real rows (targets are zeros)
        return out._replace(
            loss=np.float32(np.mean(out.per_example_loss)),
            accuracy=np.float32(np.mean(out.rec_num_digits == 0)))

    def infer(self, images):
        """Returns (all_digits, all_positions, all_reconstructions,
        all_windows, all_latents, all_loss), per-step lists trimmed to the
        inferred digit count."""
        batch = np.asarray([np.ravel(img) for img in images], np.float32)
        batch, n = _pad_to_bucket(batch)
        out = self._forward(batch)
        b = len(batch)
        packed = torch.cat([
            out.rec_num_digits[:, None].to(torch.float32),
            out.rec_scales[:, :, 0],
            out.rec_shifts.reshape(b, 2 * self.config.max_steps),
            out.reconstruction,
            out.rec_windows.reshape(b, -1),
            out.rec_latents.reshape(b, -1),
            out.reconstruction_loss[:, None],
        ], dim=1).cpu().numpy()[:n]

        cs, ws = self.canvas_size, self.window_size
        T = self.config.max_steps
        L = self.config.vae_latent_dimensions
        col = self._packed_cols
        digits_arr = packed[:, col["digits"][0]].astype(np.int32)
        scales = packed[:, col["scales"][0]:col["scales"][1]]
        shifts = packed[:, col["shifts"][0]:col["shifts"][1]].reshape(n, T, 2)
        recons = packed[:, col["recon"][0]:col["recon"][1]]
        windows = packed[:, col["windows"][0]:col["windows"][1]].reshape(
            n, T, ws, ws)
        latents = packed[:, col["latents"][0]:col["latents"][1]].reshape(
            n, T, L)
        losses = packed[:, col["loss"][0]]

        all_digits, all_positions = [], []
        all_windows, all_latents = [], []
        all_reconstructions, all_loss = [], []
        for i in range(n):
            d = int(digits_arr[i])
            all_digits.append(d)
            all_reconstructions.append(recons[i].reshape(cs, cs))
            # zero-digit items come out as empty 1-D arrays, as in the
            # reference's list-built returns
            all_positions.append(np.array(
                [[scales[i, j], *shifts[i, j]] for j in range(d)]))
            all_windows.append(windows[i, :d].copy() if d else np.array([]))
            all_latents.append(latents[i, :d].copy() if d else np.array([]))
            all_loss.append(losses[i])
        return (all_digits, all_positions, all_reconstructions,
                all_windows, all_latents, all_loss)
