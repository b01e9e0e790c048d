"""The reference's scalar metric taxonomy over one batch of outputs.

Counterpart of the summaries of ``air_tpu/train/metrics.py``:

  * per-digit-count slices "<name>_<i>_dig" and "<name>_all_dig";
  * per-step slices "<name>_<s>_step_<i>_dig" with the ``one_more_step`` and
    ``all_steps`` variants.

A slice is a masked mean ``sum(x * m) / sum(m)``, NaN where the mask is
empty, so that every key exists for every batch. Values are 0-d float32
tensors on the outputs' device.

And the sinks: ``MetricsWriter`` (JSONL, optionally mirrored to
TensorBoard event files by ``air_tpu_torch.utils.tb_writer``) and the
per-variable summaries (``variable_summaries``, ``named_leaves``). A record's
tensors come to the host in one copy.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from air_tpu_torch.tree import path_name, tree_leaves_with_path


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    values = values.to(torch.float32)
    mask = mask.to(torch.float32)
    denom = torch.sum(mask)
    return torch.where(denom > 0, torch.sum(values * mask) / denom,
                       torch.full_like(denom, float("nan")))


def summarize_by_digit_count(tensor, digits, name: str,
                             max_digits: int) -> dict:
    """"<name>_<i>_dig" for each digit count i, plus "<name>_all_dig"."""
    tensor = tensor.to(torch.float32)
    out = {f"{name}_{i}_dig": masked_mean(tensor, digits == i)
           for i in range(max_digits + 1)}
    out[f"{name}_all_dig"] = torch.mean(tensor)
    return out


def summarize_by_step(tensor, steps, digits, name: str, max_steps: int,
                      max_digits: int, one_more_step: bool = False,
                      all_steps: bool = False) -> dict:
    """Per-step x per-digit-count slices of a [B, max_steps] tensor."""
    tensor = tensor.to(torch.float32)
    out = {}
    for i in range(max_steps):
        step_name = f"{name}_{i + 1}_step"
        if all_steps:
            out.update(summarize_by_digit_count(
                tensor[:, i], digits, step_name, max_digits))
        else:
            mask = steps > (i - 1 if one_more_step else i)
            for d in range(max_digits + 1):
                out[f"{step_name}_{d}_dig"] = masked_mean(
                    tensor[:, i], mask & (digits == d))
            out[f"{step_name}_all_dig"] = masked_mean(tensor[:, i], mask)
    return out


def summarize_outputs(out, targets, max_steps: int, max_digits: int) -> dict:
    """The reference's post-loop scalar summaries of one ``AIROutputs``."""
    digits = torch.as_tensor(targets, device=out.loss.device).to(torch.int32)
    steps = out.rec_num_digits
    summ = {}
    summ.update(summarize_by_digit_count(steps, digits, "steps", max_digits))
    summ.update(summarize_by_digit_count(
        out.reconstruction_loss, digits, "rec_loss", max_digits))
    acc = (digits == steps).to(torch.float32)
    summ.update(summarize_by_digit_count(acc, digits, "digit_acc",
                                         max_digits))
    summ.update(summarize_by_digit_count(
        out.per_example_loss, digits, "total_loss", max_digits))
    for tensor, name, kw in (
            (out.rec_scales[:, :, 0], "scale", {}),
            (out.z_pres_probs, "z_pres_prob", {"all_steps": True}),
            (out.z_pres_kls, "z_pres_kl", {"one_more_step": True}),
            (out.scale_kls, "scale_kl", {}),
            (out.shift_kls, "shift_kl", {}),
            (out.vae_kls, "vae_kl", {})):
        summ.update(summarize_by_step(tensor, steps, digits, name, max_steps,
                                      max_digits, **kw))
    summ["loss"] = out.loss
    summ["accuracy"] = out.accuracy
    return summ


def to_host(values: dict) -> dict:
    """{name: value} with every tensor value as a numpy array; the float32
    tensors of one device come over in one copy (a copy per value would
    wait on the card once per value)."""
    out = dict(values)
    groups: dict = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.float32:
                groups.setdefault(v.device, []).append((k, v))
            else:
                out[k] = v.cpu().numpy()
    for items in groups.values():
        flat = torch.cat([v.reshape(-1) for _, v in items]).cpu().numpy()
        lo = 0
        for k, v in items:
            out[k] = flat[lo:lo + v.numel()].reshape(tuple(v.shape))
            lo += v.numel()
    return out


def named_leaves(tree) -> dict:
    """Flatten a tree of tensors to {path-name: numpy array}, in the JAX
    package's leaf order and names ('cnn/0/w', 'lstm/kernel', ...)."""
    return to_host({path_name(path): leaf
                    for path, leaf in tree_leaves_with_path(tree)})


def variable_summaries(params) -> dict:
    """Per-variable distribution stats — the JSONL counterpart of the
    reference's per-variable histograms (reference air/air_model.py:643-649).
    True histograms go to the TB sink via MetricsWriter.write_histograms."""
    out = {}
    for name, leaf in named_leaves(params).items():
        out[f"{name}/norm"] = float(np.linalg.norm(leaf.ravel()))
        out[f"{name}/mean"] = float(leaf.mean())
        out[f"{name}/std"] = float(leaf.std())
        out[f"{name}/min"] = float(leaf.min())
        out[f"{name}/max"] = float(leaf.max())
    return out


class MetricsWriter:
    """JSONL metrics sink with optional TensorBoard mirroring (pure-python
    event writer — works with TensorFlow absent)."""

    def __init__(self, directory: str, tensorboard: bool = False,
                 filename: str = "metrics.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._file = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            from air_tpu_torch.utils.tb_writer import EventWriter
            self._tb = EventWriter(directory)

    def write(self, step: int, scalars: dict, prefix: str = ""):
        record = {"step": int(step), "time": time.time()}
        flat = {}
        for k, v in scalars.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    flat[f"{prefix}{k}/{kk}"] = vv
            else:
                flat[f"{prefix}{k}"] = v
        for k, v in to_host(flat).items():
            v = np.asarray(v)
            record[k] = float(v) if v.size == 1 else v.tolist()
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(
                {k: v for k, v in record.items()
                 if k not in ("step", "time")
                 and isinstance(v, float) and np.isfinite(v)},
                step=step)
            self._tb.flush()

    def write_histograms(self, step: int, arrays: dict, prefix: str = ""):
        """True per-tensor histograms to the TB sink (reference
        air/air_model.py:643-687); no-op without tensorboard=True."""
        if self._tb is None:
            return
        for name, values in to_host(arrays).items():
            self._tb.add_histogram(f"{prefix}{name}", values, step=step)
        self._tb.flush()

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
