"""The reference's scalar metric taxonomy over one batch of outputs.

Counterpart of the summaries of ``air_tpu/train/metrics.py``:

  * per-digit-count slices "<name>_<i>_dig" and "<name>_all_dig";
  * per-step slices "<name>_<s>_step_<i>_dig" with the ``one_more_step`` and
    ``all_steps`` variants.

A slice is a masked mean ``sum(x * m) / sum(m)``, NaN where the mask is
empty, so that every key exists for every batch. Values are 0-d float32
tensors on the outputs' device.
"""

from __future__ import annotations

import torch


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
