"""Full-test-set evaluation: chunk, pad, merge, trim.

Counterpart of ``air_tpu/train/evaluate.py``: the reference's
feed-the-whole-test-set pass (training.py:169-200) in fixed-size chunks,
the last one padded with blank canvases and the padding trimmed from the
merged outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from air_tpu_torch.models.air import AIROutputs
from air_tpu_torch.train.metrics import to_host
from air_tpu_torch.tree import tree_leaves


def evaluate_params(eval_step, params, images, digits, *, batch_size: int,
                    step, draws) -> AIROutputs:
    """Run ``eval_step(params, images, targets, step, **draws(lo))`` over
    the full set in chunks of ``batch_size`` starting at ``lo``; ``draws``
    gives a chunk's random draws (``{"generator": ...}`` or ``{"noise":
    ...}``), as the JAX package folds ``lo`` into its key.

    Returns AIROutputs of numpy arrays with the per-example fields
    concatenated and trimmed to len(images), and loss/accuracy recomputed
    from the trimmed arrays.
    """
    device = tree_leaves(params)[0].device
    images = np.asarray(images, np.float32)
    digits = np.asarray(digits, np.int32)
    n = len(images)
    outs = []
    for lo in range(0, n, batch_size):
        im = images[lo:lo + batch_size]
        dg = digits[lo:lo + batch_size]
        pad = batch_size - len(im)
        if pad:
            im = np.concatenate([im, np.zeros((pad, im.shape[1]), im.dtype)])
            dg = np.concatenate([dg, np.zeros(pad, dg.dtype)])
        out = eval_step(params, torch.from_numpy(im).to(device),
                        torch.from_numpy(dg).to(device), step, **draws(lo))
        outs.append(to_host(out._asdict()))
    merged = {f: (np.concatenate([o[f] for o in outs])[:n]
                  if np.ndim(outs[0][f]) > 0 else outs[0][f])
              for f in AIROutputs._fields}
    merged["loss"] = np.mean(merged["per_example_loss"])
    merged["accuracy"] = np.mean(
        (merged["rec_num_digits"] == digits).astype(np.float32))
    return AIROutputs(**merged)
