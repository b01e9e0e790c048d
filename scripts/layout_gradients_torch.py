#!/usr/bin/env python3
"""Where the step-parallel and scan layouts' step-0 gradients part on a
CUDA card.

    python3 scripts/layout_gradients_torch.py      # from the repository root

The full-width CNN training state of ``chip_smoke.py`` (create_train_state,
seed 0, the 60 fixture canvases and their first 4 again, st_impl="xla",
the step-0 draws). For each layout it takes the gradient of the loss, once
as the port computes it and once with the spatial transformer's batched
products (``ops/transformer.py``'s ``torch.bmm``) done in float64 and
rounded back to float32, and prints per gradient leaf the relative L2
difference between the layouts in each setting. It also prints whether
``torch.bmm`` gives the same bits for a batch of 192 images as for three
batches of 64 at the transformer's shapes (the step-parallel layout runs
one product over T*B images where the scan runs T products over B), and
the loss of each run. Prints the card's name and power limit first. Needs a
card; writes nothing. Then the same gradients twice per layout on the
card and once per layout on the host's CPU, each held against the CPU's
scan layout and the card's scan layout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from air_tpu_torch.models.air import air_forward, draw_noise  # noqa: E402
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu_torch.ops import transformer  # noqa: E402
from air_tpu_torch.train.state import create_train_state  # noqa: E402
from air_tpu_torch.train.steps import step_generator  # noqa: E402
from air_tpu_torch.tree import (tree_leaves, tree_leaves_with_path,  # noqa
                                tree_map)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "air_tpu_torch", "assets", "serve_canvases.npz")
FLOAT32_BMM = torch.bmm


def float64_bmm(a, b):
    return FLOAT32_BMM(a.double(), b.double()).float()


def bmm_bits() -> None:
    """torch.bmm on 192 images against 3 x 64, forward and both backward
    products of the read (28 <- 50) and the write (50 <- 28)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for out_dim, in_dim in ((28, 50), (50, 28)):
        w = torch.rand((192, out_dim, in_dim), generator=gen, device="cuda")
        x = torch.rand((192, in_dim, in_dim), generator=gen, device="cuda")
        g = torch.randn((192, out_dim, in_dim), generator=gen, device="cuda")
        for name, a, b in (("W @ X", w, x), ("G @ X^T", g, x.transpose(1, 2)),
                           ("W^T @ G", w.transpose(1, 2), g)):
            whole = torch.bmm(a, b)
            parts = torch.cat([torch.bmm(a[i:i + 64], b[i:i + 64])
                               for i in range(0, 192, 64)])
            print(json.dumps({"bmm": name, "shape": [list(a.shape),
                                                     list(b.shape)],
                              "differ": int((whole != parts).sum()),
                              "max_abs": float((whole - parts).abs().max())}),
                  flush=True)


def gradients(config, state, images, digits, noise) -> tuple:
    params = tree_map(lambda p: p.detach().requires_grad_(True),
                      state.params)
    out = air_forward(params, config, images, digits, train=True, step=0,
                      noise=noise)
    leaves = tree_leaves(params)
    return out.loss.item(), dict(zip(
        ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(params)],
        torch.autograd.grad(out.loss, leaves)))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    bmm_bits()
    with np.load(FIXTURE) as z:
        canvases, truth = z["canvases"], z["digits"]
    images = torch.from_numpy(np.concatenate([canvases, canvases[:4]])).cuda()
    digits = torch.from_numpy(np.concatenate([truth, truth[:4]])).cuda()
    config = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl="xla")
    state = create_train_state(config, seed=0, device="cuda")
    noise = draw_noise(config, 64, step_generator(0, 0, "cuda"), "cuda")
    runs = {}
    for device in ("cuda", "cpu"):
        on = (lambda t: t) if device == "cuda" else (lambda t: t.cpu())
        st = state.replace(params=tree_map(on, state.params))
        for layout in ("stepparallel", "scan"):
            for rep in (0, 1) if device == "cuda" else (0,):
                runs[(device, layout, rep)] = gradients(
                    config.replace(decoder_layout=layout), st, on(images),
                    on(digits), {k: on(v) for k, v in noise.items()})
    ref = runs[("cpu", "scan", 0)][1]
    for key, (loss, grads) in runs.items():
        for name, other in (("vs cpu scan", ref),
                            ("vs cuda scan", runs[("cuda", "scan", 0)][1])):
            rel = {k: float(torch.linalg.norm(
                (grads[k].cpu() - other[k].cpu()).double())
                / (torch.linalg.norm(other[k].cpu().double()) + 1e-12))
                for k in other}
            top = sorted(rel, key=rel.get, reverse=True)[:4]
            print(json.dumps({"run": "/".join(map(str, key)), "loss": loss,
                              name: {k: rel[k] for k in top}}), flush=True)
    for setting, bmm in (("float32 bmm", FLOAT32_BMM),
                         ("float64 bmm", float64_bmm)):
        transformer.torch.bmm = bmm
        try:
            runs = {layout: gradients(config.replace(decoder_layout=layout),
                                      state, images, digits, noise)
                    for layout in ("stepparallel", "scan")}
        finally:
            transformer.torch.bmm = FLOAT32_BMM
        (loss_sp, g_sp), (loss_scan, g_scan) = runs["stepparallel"], \
            runs["scan"]
        rel = {k: float(torch.linalg.norm((g_sp[k] - g_scan[k]).double())
                        / (torch.linalg.norm(g_scan[k].double()) + 1e-12))
               for k in g_scan}
        top = sorted(rel, key=rel.get, reverse=True)[:5]
        print(json.dumps({"setting": setting, "loss_stepparallel": loss_sp,
                          "loss_scan": loss_scan,
                          "worst_relative_l2": {k: rel[k] for k in top}}),
              flush=True)


if __name__ == "__main__":
    main()
