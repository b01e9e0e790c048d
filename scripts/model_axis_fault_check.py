"""Does ``chip_smoke.py`` phase 11 (c)'s gradient bound catch a fault in the
model axis's backward? Run on the card:

    python3 scripts/model_axis_fault_check.py   # from the repository root

Builds the kernels and runs phase 11 (c)'s rank function
(``chip_smoke.rank_gloo_model``: data 2 x model 2, four gloo ranks on the
one card, step 0 at the robust default's full width on phase 5's batch,
rnn_input_hoist off and on) three times: as the code stands, then with a
factor of 2 planted at run time in the gather-from-model backward (the
sharded kernels' gradients twice their size, everything upstream of them
off too), then in the copy-to-model backward (its model sum plus the rank's
own part again). Prints, per run and rank, the measures that phase 11 (c)
holds to ``MODEL_GRAD_TOL``: the gradients and their norm against the
single card's on the ranks' halves of the batch; and the loss and the
params after the step, which Adam's sign-like first step leaves close
whatever the gradients' size. The faults are made in the ranks, in memory;
no file changes.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from air_tpu_torch.kernels import build  # noqa: E402

FAULTS = (None, "gather x2", "copy counted twice")


def plant(fault) -> None:
    """Patch the model axis's autograd Functions in this process."""
    from air_tpu_torch.parallel import collectives as c
    if fault == "gather x2":
        gather = c._GatherFromModel.backward

        def backward(ctx, dy):
            dx, none = gather(ctx, dy)
            return 2 * dx, none
        c._GatherFromModel.backward = staticmethod(backward)
    elif fault == "copy counted twice":
        copy = c._CopyToModel.backward

        def backward(ctx, dx):
            summed, none = copy(ctx, dx)
            return summed + dx, none
        c._CopyToModel.backward = staticmethod(backward)


def rank_fault(rank, device, fault, *args) -> dict:
    plant(fault)
    return cs.rank_gloo_model(rank, device, *args)


def main() -> None:
    print(cs.card(), flush=True)
    build.load_all()
    with np.load(cs.FIXTURE) as z:
        canvases, truth = z["canvases"], z["digits"]
    images = np.concatenate([canvases, canvases[:4]])
    digits = np.concatenate([truth, truth[:4]])
    cfg = cs.DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl="inline")
    lr = cfg.learning_rate
    for fault in FAULTS:
        out = cs.launch(rank_fault, "gloo", ["cuda:0"] * 4,
                        (fault, cfg, images, digits),
                        timeout=cs.RANK_SECONDS)
        for rank, res in enumerate(out):
            for hoist, r in res.items():
                held = (r["grad_err"] <= cs.MODEL_GRAD_TOL
                        and r["norm_err"] <= cs.MODEL_GRAD_TOL)
                print(f"fault={fault} rank={rank} rnn_input_hoist={hoist}: "
                      f"gradients {r['grad_err']:.4g}, norm (rel) "
                      f"{r['norm_err']:.4g} against the halves (tol "
                      f"{cs.MODEL_GRAD_TOL}: {'held' if held else 'FAILS'});"
                      f" against the whole batch {r['full_err']:.4g} (the "
                      f"card's halves {r['order_err']:.4g}); loss rel "
                      f"{abs(r['loss'][0] - r['loss'][1]) / abs(r['loss'][1]):.3g};"
                      f" params apart {r['apart'][0]:.3g} (mean "
                      f"{r['apart'][1]:.3g}; apart_ok "
                      f"{cs.apart_ok(*r['apart'], lr, 1)})", flush=True)


if __name__ == "__main__":
    main()
