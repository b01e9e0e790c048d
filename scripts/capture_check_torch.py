"""Quick check of the captured train step on the card, beside the eager one.

    python3 scripts/capture_check_torch.py      # from the repository root

Builds the kernels; runs one eager step body under
``torch.cuda.set_sync_debug_mode`` (warnings for hidden host syncs); trains
60 eager and 60 captured inline steps (``make_train_step``,
``fast_pipeline.make_multi_step``) on the committed fixture batch at full
width from ``create_train_state(seed 0)`` and prints both params digests,
whether the losses are bit-equal, and the launches the replays counted;
times one captured and one eager step (CUDA events, 20 steps, twice each);
names the ST kernels torch.profiler sees in 3 replayed steps; and holds 10
captured seed-parallel steps at S = 4 to 10 eager ones
(``make_replica_step``) and times both. ``chip_smoke.py`` phase 10 makes
the same checks and more; this is its short first version.
"""

import hashlib
import json
import os
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from air_tpu_torch.kernels import build, st_inline  # noqa: E402
from air_tpu_torch.models.air import draw_noise  # noqa: E402
from air_tpu_torch.models.config import DEFAULT_TRAINING_CONFIG  # noqa: E402
from air_tpu_torch.train.fast_pipeline import make_multi_step  # noqa: E402
from air_tpu_torch.train.multi_seed import (  # noqa: E402
    create_multi_seed_state, make_multi_seed_step, make_replica_step,
    multi_seed_perms, replica_batch)
from air_tpu_torch.train.state import create_train_state  # noqa: E402
from air_tpu_torch.train.steps import (  # noqa: E402
    device_scalars, host_scalars, make_step_body, make_train_step,
    step_generator)
from air_tpu_torch.tree import tree_leaves  # noqa: E402


def main():
    T0 = time.perf_counter()
    def say(*a): print(f"+{time.perf_counter()-T0:.1f}s", *a, flush=True)
    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(a.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        return h.hexdigest()[:16]
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(build.load, ("st_inline", "st_pallas", "st_fused")))
    say("built")
    with np.load("air_tpu_torch/assets/serve_canvases.npz") as z:
        canvases, truth = z["canvases"], z["digits"]
    images = torch.from_numpy(np.concatenate([canvases, canvases[:4]])).cuda()
    digits = torch.from_numpy(np.concatenate([truth, truth[:4]])).cuda()
    cfg = DEFAULT_TRAINING_CONFIG.replace(cnn=True, st_impl="inline")
    state0 = create_train_state(cfg, seed=0, device="cuda")
    # hidden syncs of the body
    from air_tpu_torch.train.state import make_optimizer
    opt = make_optimizer(cfg)
    row = host_scalars(cfg, opt, 0, state0.opt_state)
    sc = device_scalars(torch.tensor(list(row.values()), dtype=torch.float32).cuda(), row)
    noise = draw_noise(cfg, 64, step_generator(0, 0, "cuda"), "cuda")
    body = make_step_body(cfg)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        body(state0.params, state0.opt_state.mu, state0.opt_state.nu, images, digits, noise, sc)
        torch.cuda.set_sync_debug_mode(0)
    say("syncs in the body:", len(w), [str(x.message)[:200] for x in w[:5]])
    step = make_train_step(cfg)
    st, losses = state0, []
    t = time.perf_counter()
    for i in range(60):
        st, m = step(st, images, digits)
        losses.append(float(m["loss"]))
    say("eager 60", time.perf_counter() - t, "digest", digest(tree_leaves(st.params)), losses[:3], losses[-1])
    eager_digest = digest(tree_leaves(st.params))
    multi = make_multi_step(cfg, 60, 64)
    perm = torch.arange(64, device="cuda")
    st_inline.reset_launches()
    t = time.perf_counter()
    try:
        st2, m2 = multi(state0, images, digits, perm, 0)
        torch.cuda.synchronize()
    except Exception as e:
        import traceback; traceback.print_exc(); sys.exit(1)
    say("captured 60", time.perf_counter() - t, "digest", digest(tree_leaves(st2.params)),
        "losses equal", m2["loss"].cpu().tolist() == losses, dict(st_inline.LAUNCHES))
    d2 = digest(tree_leaves(st2.params))
    print(json.dumps({"eager_digest": eager_digest, "captured_digest": d2}))
    # timing
    def time_fn(fn, n=20):
        fn(); torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n): fn()
        e.record(); torch.cuda.synchronize()
        return s.elapsed_time(e) / n
    one = make_multi_step(cfg, 1, 64)
    holder = [state0]
    def cap(): holder[0] = one(holder[0], images, digits, perm, 0)[0]
    holder2 = [state0]
    def eag(): holder2[0] = step(holder2[0], images, digits)[0]
    say("ms/step captured", time_fn(cap), "eager", time_fn(eag), "captured", time_fn(cap), "eager", time_fn(eag))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3): cap()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    say("profiled kernels per step", sum(e.count for e in rows)/3, "device ms", sum(e.self_device_time_total for e in rows)/3e3)
    for e in rows:
        if "st_" in e.key: print("  ", e.key[:80], e.count)
    # seed parallel
    cfgS = cfg
    sS = create_multi_seed_state(cfgS, range(4), device="cuda")
    perms = multi_seed_perms(64, range(4), 0, device="cuda")
    ms = make_multi_seed_step(cfgS, 10, 64)
    a, ma = ms(sS, images, digits, perms, 0)
    torch.cuda.synchronize()
    rs = make_replica_step(cfgS)
    b, lb = sS, []
    for i in range(10):
        b, mb = rs(b, *replica_batch(images, digits, perms, i, 64))
        lb.append(mb["loss"])
    say("seed-parallel S=4 captured vs eager losses equal", torch.equal(ma["loss"], torch.stack(lb)),
        digest(tree_leaves(a.params)), digest(tree_leaves(b.params)))
    hS = [sS]
    def capS(): hS[0] = ms(hS[0], images, digits, perms, 0, num_steps=1)[0]
    hE = [sS]
    def eagS(): hE[0] = rs(hE[0], *replica_batch(images, digits, perms, 0, 64))[0]
    say("S=4 ms/step captured", time_fn(capS, 10), "eager", time_fn(eagS, 10))
    print("DONE")


if __name__ == "__main__":
    main()
