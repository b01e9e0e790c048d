"""Seed-parallel training of the port (air_tpu_torch.train.multi_seed and
python -m air_tpu_torch.seed_sweep) against the JAX package's
make_multi_seed_step and against the port's own single-seed step, on the
CPU.

Tolerances: against JAX, the losses 1e-4 abs/rel, as one train step
(tests/test_torch_train_step.py), and the gradient norm of step 0 1e-3
(see the test). Against the port's single-seed step, the losses 1e-5
relative, and the moments a gradient leaf's 1e-4 * max(1, max |leaf|) or
one bfloat16 rounding step: the batched products of S replicas round in
another order than S separate ones, the rest of the arithmetic is the
same. Trained parameters, against either, by ``params_close``: Adam turns
rounding-level gradient differences into steps up to 2 * lr apart where a
gradient element crosses zero, so each element is held to 2 * steps * lr
and each leaf's mean difference to rounding. Each kernel wrapper's vmap
rule against a per-replica loop of the same wrapper: 1e-6 abs (one batched
call against S calls, the same formulas). The replicas' hyperparameter
resolution at an [S] step against the scalar one: bit for bit. Every vmap
here runs with the per-replica fallback loop turned into an error.

The gpu-marked test, the one test of this file that runs where JAX is not
installed, holds the folded kernels against the per-replica calls of the
same kernels on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_multi_seed.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.func import vmap

from air_tpu_torch import seed_sweep
from air_tpu_torch.kernels import st_fused, st_inline, st_pallas
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.schedules import resolve_annealed
from air_tpu_torch.train import multi_seed
from air_tpu_torch.train.multi_seed import (
    EVAL_SEED, create_multi_seed_state, evaluate_replicas,
    make_multi_seed_step, multi_seed_perms, no_vmap_fallback,
    reinit_replica, rotation_knobs, schedules_from_knobs, stack_knobs,
    set_replica_knobs, vmap_rotation_variant)
from air_tpu_torch.train.state import (AdamState, TrainState,
                                       create_train_state, make_optimizer,
                                       stack_train_states)
from air_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       step_generator)
from air_tpu_torch.tree import tree_leaves, tree_map

try:    # the machine with the card has no JAX; only the gpu test runs there
    import jax
    import jax.numpy as jnp

    from air_tpu.models.config import AIRConfig as JaxConfig
    from air_tpu.ops.schedules import (
        resolve_annealed as jax_resolve_annealed)
    from air_tpu.train import multi_seed as jax_ms
    from air_tpu_torch.interop import opt_state_from_jax, params_from_jax
    from tests.test_multi_seed import SMALL as JAX_SMALL
    from tests.test_torch_model import SMALL, jax_noise
    from tests.test_torch_train import LR_SCHEDULE, MAIN_OPT, to_np
except ImportError:
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N, B, K = 24, 4, 2
SEEDS = (3, 7)
# knobs of two rotation variants: the sweep's base attempt and restart 3
KNOBS = [rotation_knobs(6.0), vmap_rotation_variant(3, 6.0)]


@pytest.fixture(autouse=True)
def no_fallback():
    """An op without a batching rule fails every test here."""
    with no_vmap_fallback():
        yield


def params_close(got, want, lr: float, steps: int, bf16: bool):
    """Trained parameters of two runs from the same state, per leaf: no
    element more than 2 * steps * lr apart (and 1e-6 for the params' own
    rounding), and the mean |difference| at
    most steps * lr * 2**-7 with bfloat16 moments, 1e-3 * lr with float32
    ones. Adam (eps 1e-8) moves an element by about lr whatever its
    gradient's size, so a gradient element that rounding moves across zero
    turns into steps up to 2 * lr apart, and a stored bfloat16 moment that
    rounds to the other neighbour (2**-8 relative) into updates up to
    2**-7 * lr apart; the mean holds every other element to rounding."""
    mean_bound = steps * lr * 2 ** -7 if bf16 else 1e-3 * lr
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        diff = (a - b).abs()
        assert float(diff.max()) <= 2 * steps * lr + 1e-6
        assert float(diff.mean()) <= mean_bound


def replica_state(state: TrainState, index: int) -> TrainState:
    """Replica ``index`` of a stacked TrainState as a single-seed one."""
    opt = state.opt_state

    def pick(tree):
        return tree_map(lambda x: x[index], tree)

    return TrainState(
        params=pick(state.params),
        opt_state=AdamState(int(opt.count[index]), pick(opt.mu),
                            pick(opt.nu), None if opt.schedule_count is None
                            else int(opt.schedule_count[index])),
        step=int(state.step[index]), seed=state.seed[index])


def _data(seed=11, n=N, cs=20):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(n, cs * cs)).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(
        (np.arange(n) % 3).astype(np.int32))


# -------------------- against JAX ------------------------------------------
@pytest.mark.parametrize("st_impl,knobbed", [("inline", False),
                                              ("xla", True)])
def test_multi_seed_step_matches_jax(st_impl, knobbed):
    """K = 2 steps of 2 replicas from JAX's stacked state, perms and draws;
    with knobs, each replica on its own rotation variant at its own
    clock."""
    check_against_jax(st_impl, knobbed, K)


@pytest.mark.parametrize("unroll", [2])
def test_unrolled_multi_seed_step_matches_jax(unroll):
    """3 steps at pipeline_unroll U (U = 2 leaves JAX's scan a remainder of
    one) against JAX's unrolled step, as above, and bit-equal to the port's
    U = 1."""
    new, m = check_against_jax("inline", False, 3, unroll)
    want, wm = check_against_jax("inline", False, 3, 1, check=False)
    for a, b in zip(tree_leaves((new.params, new.opt_state.mu,
                                 new.opt_state.nu)),
                    tree_leaves((want.params, want.opt_state.mu,
                                 want.opt_state.nu))):
        assert torch.equal(a, b)
    for k in wm:
        assert torch.equal(m[k], wm[k]), k


def check_against_jax(st_impl: str, knobbed: bool, k: int, unroll: int = 1,
                      check: bool = True):
    """k steps of JAX's make_multi_seed_step and the port's at
    ``pipeline_unroll``, from the same stacked state, perms and draws;
    with ``check``, the port held to JAX's. Returns the port's (state,
    metrics)."""
    jcfg = JAX_SMALL                     # st_impl "xla"
    if knobbed:   # the z_pres prior schedule the knobs rebuild
        jcfg = jcfg.replace(annealing_schedules={"z_pres_prior_log_odds": {
            "init": 1e4, "min": 1e-9, "factor": 0.1, "iters": 3,
            "log": True}})
    cfg = AIRConfig(**{f: getattr(jcfg, f)
                       for f in AIRConfig.__dataclass_fields__
                       if f in JaxConfig.__dataclass_fields__}).replace(
                           st_impl=st_impl,
                           annealing_schedules=jcfg.schedules or None)
    images, digits = _data(11, N, jcfg.canvas_size)
    jstate = jax_ms.create_multi_seed_state(jcfg, SEEDS)
    if knobbed:   # replica 1 restarted: its clock ahead of replica 0's
        jstate = jstate.replace(step=jnp.asarray([0, 4], jnp.int32))
    jperms = jax_ms.multi_seed_perms(N, SEEDS, 0)
    if check:
        jmulti = jax_ms.make_multi_seed_step(jcfg, k, B, donate=False,
                                             knob_schedules=knobbed,
                                             pipeline_unroll=unroll)
        extra = (jax_ms.stack_knobs(KNOBS),) if knobbed else ()
        jnew, jm = jmulti(jstate, jnp.asarray(images.numpy()),
                          jnp.asarray(digits.numpy()), jperms,
                          jnp.asarray(0, jnp.int32), *extra)

    singles = []
    for r in range(len(SEEDS)):
        jp = to_np(jax.tree_util.tree_map(lambda x: x[r], jstate.params))
        params = params_from_jax(jp, "cpu")
        st = create_train_state(cfg, params=params, device="cpu")
        opt = opt_state_from_jax(
            [np.asarray(x)[r] for x in
             jax.tree_util.tree_leaves(jstate.opt_state)], params, "cpu")
        singles.append(st.replace(opt_state=opt,
                                  step=int(jstate.step[r])))
    state = stack_train_states(singles)
    steps0 = np.asarray(jstate.step)
    noise = [{name: torch.stack([
        jax_noise(jax.random.fold_in(jstate.key[r], int(steps0[r]) + i),
                  jcfg, B)[name] for r in range(len(SEEDS))])
        for name in ("scale", "shift", "vae_latent", "vae_out", "z_pres_u")}
        for i in range(k)]
    multi = make_multi_seed_step(cfg, k, B, knob_schedules=knobbed,
                                 pipeline_unroll=unroll)
    knobs = (stack_knobs(KNOBS),) if knobbed else ()
    new, m = multi(state, images, digits,
                   torch.from_numpy(np.asarray(jperms, np.int64)), 0,
                   *knobs, noise=noise)
    if not check:
        return new, m
    for name in ("loss", "reconstruction_loss", "kl_loss", "grad_norm",
                 "z_pres_prior_log_odds", "accuracy"):
        assert tuple(m[name].shape) == (k, len(SEEDS)), name
        if name != "grad_norm":
            np.testing.assert_allclose(m[name].numpy(),
                                       np.asarray(jm[name]), err_msg=name,
                                       **TOL)
    # this config's gradient is ill-conditioned: its norm is dominated by
    # the BCE's -x / (r + 1e-9) at pixels whose reconstruction r is near 0,
    # where rounding is large relative to r. From the same params the norms
    # part by up to 2e-4; after one update from params 1e-6 apart, by 0.4%,
    # while the losses and Adam's steps stay within TOL. So the norm is held
    # at step 0, to 1e-3
    np.testing.assert_allclose(m["grad_norm"].numpy()[0],
                               np.asarray(jm["grad_norm"])[0], rtol=1e-3)
    params_close(new.params, params_from_jax(to_np(jnew.params), "cpu"),
                 cfg.learning_rate, k, bf16=False)
    assert new.step.tolist() == np.asarray(jnew.step).tolist()
    return new, m


def test_knob_schedules_resolve_as_jax():
    """Every rotation variant's resolved hyperparameters, at [S] replica
    steps before, inside and after the holds, against the JAX package's
    per replica; the [S] resolution equals the scalar one bit for bit."""
    base = AIRConfig(**SMALL).replace(
        annealing_schedules={**LR_SCHEDULE, "z_pres_prior_log_odds": {
            "init": 1e4, "min": 1e-9, "factor": 0.1, "iters": 3000,
            "log": True}}).schedules
    defaults = AIRConfig(**SMALL).annealable_defaults()
    variants = [rotation_knobs(300.0, scale_curriculum=True)] + [
        vmap_rotation_variant(n, 300.0) for n in range(1, 6)]
    knobs_S = stack_knobs(variants)
    for steps in ([0, 1, 299, 300, 301, 5000], [12000, 7, 30000, 600, 0, 3]):
        steps_S = torch.tensor(steps, dtype=torch.int64)
        got = resolve_annealed(schedules_from_knobs(base, knobs_S), defaults,
                               steps_S)
        for r, (knobs, step) in enumerate(zip(variants, steps)):
            one = resolve_annealed(schedules_from_knobs(base, knobs),
                                   defaults, step)
            want = jax_resolve_annealed(
                jax_ms.schedules_from_knobs(base, knobs), defaults, step)
            for k, v in got.items():
                if isinstance(v, torch.Tensor):
                    assert v[r].item() == torch.as_tensor(one[k]).item(), k
                    np.testing.assert_allclose(v[r].item(), float(want[k]),
                                               rtol=1e-6, err_msg=k)
                else:
                    assert v == one[k] == want[k], k


def test_knob_helpers_match_jax():
    assert multi_seed.N_ROTATION_VARIANTS == jax_ms.N_ROTATION_VARIANTS
    for n in range(1, 12):
        assert (multi_seed.rotation_variant_index(n)
                == jax_ms.rotation_variant_index(n))
        assert (vmap_rotation_variant(n, 1500.0)
                == jax_ms.vmap_rotation_variant(n, 1500.0))
    assert rotation_knobs(5.0, True, 2.0, 3.0) == jax_ms.rotation_knobs(
        5.0, True, 2.0, 3.0)
    knobs_S = stack_knobs(KNOBS)
    jknobs = jax_ms.stack_knobs(KNOBS)
    assert set(knobs_S) == set(jknobs)
    moved = set_replica_knobs(knobs_S, 1, rotation_knobs(9.0))
    jmoved = jax_ms.set_replica_knobs(jknobs, 1, rotation_knobs(9.0))
    for k in knobs_S:
        assert knobs_S[k].dtype == torch.float32
        np.testing.assert_array_equal(knobs_S[k].numpy(), np.asarray(jknobs[k]))
        np.testing.assert_array_equal(moved[k].numpy(), np.asarray(jmoved[k]))
    assert knobs_S["temp_init"].tolist() == [1.0, 5.0]   # left as it was


def test_multi_seed_perms_are_the_single_seed_loaders():
    from air_tpu_torch.data.loader import DeviceDataPipeline
    images, digits = _data(3, 30)
    perms = multi_seed_perms(30, (3, 7, 11), 2, device="cpu")
    assert perms.dtype == torch.int64 and tuple(perms.shape) == (3, 30)
    for r, seed in enumerate((3, 7, 11)):
        pipe = DeviceDataPipeline(images.numpy(), digits.numpy(), 4,
                                  seed=seed, device="cpu")
        pipe.epoch = 2
        assert torch.equal(perms[r], pipe.perm())


# -------------------- against the port's single-seed step ------------------
def _replicas_vs_single(cfg, seeds, knobs=None, steps=K, n=N, batch=B):
    images, digits = _data(5, n, cfg.canvas_size)
    state = create_multi_seed_state(cfg, seeds, device="cpu")
    perms = multi_seed_perms(n, seeds, 0, device="cpu")
    multi = make_multi_seed_step(cfg, steps, batch,
                                 knob_schedules=knobs is not None)
    extra = () if knobs is None else (stack_knobs(knobs),)
    new, m = multi(state, images, digits, perms, 1, *extra)
    base = cfg.schedules
    single = make_train_step(cfg, schedules_fn=None if knobs is None else (
        lambda k: schedules_from_knobs(base, k)))
    for r, seed in enumerate(seeds):
        st = create_train_state(cfg, seed=seed, device="cpu")
        losses = []
        for i in range(steps):
            lo = min((1 + i) * batch, n - batch)
            rows = perms[r, lo:lo + batch]
            st, ms = single(st, images[rows], digits[rows],
                            None if knobs is None else knobs[r])
            losses.append(float(ms["loss"]))
        np.testing.assert_allclose(m["loss"][:, r].numpy(), losses,
                                   rtol=1e-5)
        got = replica_state(new, r)
        assert (got.step, got.seed, got.opt_state.count) == (
            st.step, st.seed, st.opt_state.count)
        params_close(got.params, st.params, cfg.learning_rate, steps,
                     bf16=cfg.adam_storage_dtype == "bfloat16")
        for a, b in zip(tree_leaves((got.opt_state.mu, got.opt_state.nu)),
                        tree_leaves((st.opt_state.mu, st.opt_state.nu))):
            # a gradient leaf's tolerance (tests/test_torch_train_step.py),
            # or one bfloat16 rounding step of the stored moment
            assert a.dtype == b.dtype
            bf16 = a.dtype == torch.bfloat16
            a, b = a.float(), b.float()
            tol = 1e-4 * max(1.0, float(b.abs().max()))
            if bf16:
                tol = torch.clamp(b.abs() * 2.0 ** -7, min=tol)
            assert bool(((a - b).abs() <= tol).all())
    return m


@pytest.mark.parametrize("st_impl", ["inline", "pallas", "xla"])
def test_replica_matches_single_seed(st_impl):
    """Replica r of the seed-parallel step is the single-seed run of seed r
    (init, draws, data order), with bf16 moments and clip 1.0."""
    cfg = AIRConfig(**{**SMALL, **MAIN_OPT, "st_impl": st_impl})
    m = _replicas_vs_single(cfg, SEEDS)
    assert not np.allclose(m["loss"][:, 0], m["loss"][:, 1])


def test_replica_matches_single_seed_with_knobs_and_lr_schedule():
    """Three replicas on their own rotation variants (as the sweep's knobs)
    and a learning-rate schedule, float32 moments, through the folded
    kernels' plain versions."""
    cfg = AIRConfig(**{**SMALL, "st_impl": "inline",
                       "annealing_schedules": {
                           **LR_SCHEDULE, "z_pres_prior_log_odds": {
                               "init": 1e4, "min": 1e-9, "factor": 0.1,
                               "iters": 2, "log": True}}})
    knobs = [rotation_knobs(1.0), vmap_rotation_variant(2, 1.0),
             vmap_rotation_variant(3, 0.0)]
    _replicas_vs_single(cfg, (0, 1, 2), knobs=knobs, steps=3)


@pytest.mark.parametrize("knobbed", [False, True])
def test_captured_form_is_the_eager_form(knobbed):
    """make_multi_seed_step's slot-based body (the form it captures on the
    card), in two calls of 2 and 1 steps from batch 1, against 3 calls of
    its eager form (make_replica_step on the same batches): bit-equal at
    S = 2, with replica clocks apart and, knobbed, each replica on its own
    rotation variant; the state it was given is left unchanged."""
    cfg = AIRConfig(**{**SMALL, **MAIN_OPT, "annealing_schedules": {
        "z_pres_prior_log_odds": {"init": 1e4, "min": 1e-9, "factor": 0.1,
                                  "iters": 2, "log": True}}})
    images, digits = _data(6, N, cfg.canvas_size)
    state = create_multi_seed_state(cfg, SEEDS, device="cpu")
    state = state.replace(step=torch.tensor([0, 3]))
    kept = tree_map(torch.clone, (state.params, state.opt_state.mu))
    perms = multi_seed_perms(N, SEEDS, 0, device="cpu")
    knobs = (stack_knobs(KNOBS),) if knobbed else ()
    multi = make_multi_seed_step(cfg, 2, B, knob_schedules=knobbed)
    s1, m1 = multi(state, images, digits, perms, 1, *knobs)
    s2, m2 = multi(s1, images, digits, perms, 3, *knobs, num_steps=1)
    eager = multi_seed.make_replica_step(cfg, knob_schedules=knobbed)
    want, losses = state, []
    for i in range(3):
        want, m = eager(want, *multi_seed.replica_batch(
            images, digits, perms, 1 + i, B), *knobs)
        losses.append(m["loss"])
    assert torch.equal(torch.cat([m1["loss"], m2["loss"]]),
                       torch.stack(losses))
    assert s2.step.tolist() == want.step.tolist() == [3, 6]
    assert s2.opt_state.count.tolist() == want.opt_state.count.tolist()
    for a, b in zip(tree_leaves((s2.params, s2.opt_state.mu,
                                 s2.opt_state.nu)),
                    tree_leaves((want.params, want.opt_state.mu,
                                 want.opt_state.nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves((state.params, state.opt_state.mu)),
                    tree_leaves(kept)):
        assert torch.equal(a, b)


def test_optimizer_update_replicas_matches_update():
    """Stacked Adam from identical per-replica gradients and clocks equals
    the single-seed update bit for bit where no reduction is involved
    (the moments) and to the clip's norm's rounding in the params."""
    for kw in (MAIN_OPT, {"learning_rate": 1e-3,
                          "annealing_schedules": LR_SCHEDULE,
                          "gradient_clipping_norm": None,
                          "learn_background": True,
                          "freeze_background": True}):
        cfg = AIRConfig(**{**SMALL, **kw})
        opt = make_optimizer(cfg)
        states = [create_train_state(cfg, seed=s, device="cpu")
                  for s in (0, 1, 2)]
        gen = torch.Generator().manual_seed(4)
        grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen),
                          st.params) for st in states]
        # replica clocks 0, 3, 1
        opts = [st.opt_state._replace(count=c, schedule_count=(
            None if st.opt_state.schedule_count is None else c))
            for st, c in zip(states, (0, 3, 1))]
        states = [st.replace(opt_state=o) for st, o in zip(states, opts)]
        stacked = stack_train_states(states)
        g_S = tree_map(lambda *xs: torch.stack(xs), *grads)
        upd_S, opt_S = opt.update_replicas(g_S, stacked.opt_state)
        assert opt_S.count.tolist() == [1, 4, 2]
        for r, (st, g) in enumerate(zip(states, grads)):
            upd, o = opt.update(g, st.opt_state)
            for a, b in zip(tree_leaves(upd_S), tree_leaves(upd)):
                torch.testing.assert_close(a[r], b, rtol=1e-6, atol=1e-12)
            for a, b in zip(tree_leaves((opt_S.mu, opt_S.nu)),
                            tree_leaves((o.mu, o.nu))):
                if cfg.gradient_clipping_norm is None:
                    assert torch.equal(a[r], b)
                else:
                    torch.testing.assert_close(a[r].float(), b.float(),
                                               rtol=1e-2, atol=1e-9)


def test_reinit_replica_only_touches_target():
    cfg = AIRConfig(**{**SMALL, **MAIN_OPT,
                       "annealing_schedules": LR_SCHEDULE})
    images, digits = _data(2, N, cfg.canvas_size)
    state = create_multi_seed_state(cfg, SEEDS, device="cpu")
    perms = multi_seed_perms(N, SEEDS, 0, device="cpu")
    state, _ = make_multi_seed_step(cfg, K, B)(state, images, digits,
                                               perms, 0)
    def trees(st):
        return (st.params, st.opt_state.mu, st.opt_state.nu)

    kept = tree_map(torch.clone, trees(state))
    new = reinit_replica(state, cfg, 1, seed=99)
    fresh = create_train_state(cfg, seed=99, device="cpu")
    assert new.seed == [SEEDS[0], 99] and state.seed == list(SEEDS)
    for a, b, f, k in zip(tree_leaves(trees(new)), tree_leaves(trees(state)),
                          tree_leaves(trees(fresh)), tree_leaves(kept)):
        assert torch.equal(a[0], b[0])          # replica 0 bit-equal
        assert torch.equal(a[1], f)             # replica 1 fresh
        assert torch.equal(b, k)                # the input unchanged
    assert new.step.tolist() == [K, 0] and state.step.tolist() == [K, K]
    assert new.opt_state.count.tolist() == [K, 0]
    assert new.opt_state.schedule_count.tolist() == [K, 0]
    assert state.opt_state.count.tolist() == [K, K]


def test_multi_seed_step_arguments():
    cfg = AIRConfig(**SMALL)
    with pytest.raises(ValueError, match="pipeline_unroll"):
        make_multi_seed_step(cfg, K, B, pipeline_unroll=0)
    state = create_multi_seed_state(cfg, SEEDS, device="cpu")
    images, digits = _data(1, N, cfg.canvas_size)
    perms = multi_seed_perms(N, SEEDS, 0, device="cpu")
    new, m = make_multi_seed_step(cfg, K, B, pipeline_unroll=2)(
        state, images, digits, perms, 0)
    assert new.step.tolist() == [K, K] and m["loss"].shape == (K, 2)
    with pytest.raises(ValueError, match="knob_schedules"):
        make_multi_seed_step(cfg, 1, B, knob_schedules=True)(
            state, images, digits, perms, 0)
    with pytest.raises(RuntimeError, match="fallback"):
        vmap(lambda x: torch.histc(x, bins=4))(torch.rand(2, 5))


# -------------------- eval --------------------------------------------------
@pytest.mark.parametrize("n,chunk", [(5, 8), (11, 4)])
def test_evaluate_replicas_matches_single_evals(n, chunk):
    """Replicas at their own clocks (0 and 7) and knobs, a test set smaller
    than a chunk or ending in a tail chunk: each replica's accuracy and loss
    are the single-seed eval's at its clock and schedules, chunk by chunk,
    weighted by the chunks' sizes."""
    cfg = AIRConfig(**{**SMALL, "annealing_schedules": {
        "z_pres_prior_log_odds": {"init": 1e4, "min": 1e-9, "factor": 0.1,
                                  "iters": 3, "log": True}}})
    images, digits = _data(8, n, cfg.canvas_size)
    state = create_multi_seed_state(cfg, SEEDS, device="cpu")
    state = state.replace(step=torch.tensor([0, 7]))
    knobs = [rotation_knobs(2.0), vmap_rotation_variant(3, 2.0)]
    key = (EVAL_SEED, 40)
    acc, loss = evaluate_replicas(cfg, state, images.numpy(),
                                  digits.numpy(), key, batch_size=chunk,
                                  knobs_S=stack_knobs(knobs))
    assert acc.shape == loss.shape == (2,)
    for r in range(2):
        rcfg = cfg.replace(annealing_schedules=schedules_from_knobs(
            cfg.schedules, knobs[r]))
        eval_step = make_eval_step(rcfg)
        params = replica_state(state, r).params
        accs, losses, w = [], [], []
        for lo in range(0, n, chunk):
            out = eval_step(params, images[lo:lo + chunk],
                            digits[lo:lo + chunk], int(state.step[r]),
                            generator=step_generator(*key, "cpu"))
            accs.append(float(out.accuracy))
            losses.append(float(out.per_example_loss.mean()))
            w.append(len(images[lo:lo + chunk]))
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(acc[r], np.dot(accs, w) / w.sum(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(loss[r], np.dot(losses, w) / w.sum(),
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="knob_schedules"):
        evaluate_replicas(cfg, state, images.numpy(), digits.numpy(), key,
                          eval_fn=multi_seed.make_multi_seed_eval(cfg),
                          knobs_S=stack_knobs(knobs))


# -------------------- the kernels' vmap rules -------------------------------
CS, WS, S_, B_ = 12, 5, 3, 4
# each autograd Function behind its differentiable wrapper: (fn, the kinds
# of its per-image inputs)
WRAPPERS = {
    "inline_read": (lambda img, s, x, y: st_inline.inline_attention_read(
        img, s, x, y, WS), ("img", "s", "x", "y")),
    "inline_write": (
        lambda canvas, win, s, x, y, coeff:
        st_inline.inline_write_accumulate(canvas, win, s, x, y, coeff, CS),
        ("canvas", "win", "s", "x", "y", "coeff")),
    "pallas_read": (lambda img, s, x, y: st_pallas.pallas_attention_read(
        img, s, x, y, WS), ("img", "s", "x", "y")),
    "pallas_resample_write": (
        lambda win, s, x, y: st_pallas.pallas_attention_write(
            win.reshape(-1, WS, WS), s, x, y, CS), ("win", "s", "x", "y")),
    "fused_write": (
        lambda canvas, win, s, x, y, coeff: st_fused.fused_write_accumulate(
            canvas, win, s, x, y, coeff, CS),
        ("canvas", "win", "s", "x", "y", "coeff")),
}


def _inputs(kinds, seed):
    """[S, B, ...] inputs of the given kinds, requiring grad: s in
    [0.1, 1], x and y in [-1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((3, S_, B_), generator=gen)
    shapes = {"img": (CS, CS), "canvas": (CS * CS,), "win": (WS * WS,),
              "coeff": ()}
    made = {"s": 0.1 + 0.9 * u[0], "x": 2.0 * u[1] - 1.0,
            "y": 2.0 * u[2] - 1.0}
    return [(made[k] if k in made else torch.rand(
        (S_, B_, *shapes[k]), generator=gen)).requires_grad_(True)
        for k in kinds]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
@pytest.mark.parametrize("shared", [False, True])
def test_vmap_rule_folds_replicas(name, shared):
    """The wrapper under vmap over S = 3 replicas (its first input shared by
    every replica when ``shared``) against the same wrapper called per
    replica: outputs, and the gradient of every input through
    torch.autograd.grad taken outside the vmap."""
    fn, kinds = WRAPPERS[name]
    inputs = _inputs(kinds, len(name) + 10 * shared)
    if shared:
        inputs[0] = inputs[0][0].detach().requires_grad_(True)
    dims = (None if shared else 0,) + (0,) * (len(inputs) - 1)
    got = vmap(fn, in_dims=dims)(*inputs)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    g_got = torch.autograd.grad(got, inputs, cot)
    want = torch.stack([fn(*[t if d is None else t[r]
                             for t, d in zip(inputs, dims)])
                        for r in range(S_)])
    g_want = torch.autograd.grad(want, inputs, cot)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for a, w in zip(g_got, g_want):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)


def test_vmap_rule_applies_each_function_once(monkeypatch):
    """For S replicas the fold calls each forward and backward function of
    a Function once, on S*B images."""
    calls = []

    def spy(module, name):
        inner = getattr(module, name)

        def wrapped(*args):
            calls.append((name, args[0].shape[0]))
            return inner(*args)
        monkeypatch.setattr(module, name, wrapped)

    for fn in ("attention_read_fwd", "attention_read_bwd",
               "write_accumulate_fwd", "write_accumulate_bwd"):
        spy(st_inline, fn)
    spy(st_fused, "wmac_fwd")
    spy(st_fused, "wmac_bwd")
    spy(st_pallas, "fused_dots")
    for name, (fn, kinds) in WRAPPERS.items():
        calls.clear()
        inputs = _inputs(kinds, 1)
        torch.autograd.grad(vmap(fn)(*inputs).sum(), inputs)
        assert calls and all(n == S_ * B_ for _, n in calls), (name, calls)
        assert len(calls) == len({c for c, _ in calls}), (name, calls)


# -------------------- the sweep CLI -----------------------------------------
SWEEP_FLAGS = ["--device", "cpu", "--batch-size", "4", "--multi-step", "3",
               "--max-iters", "7", "--eval-every", "4", "--eval-batch", "5",
               "--cnn"]
ROW_KEYS = {"seed", "tag", "final_step", "test_accuracy", "converged",
            "restarts", "variant", "wall_minutes"}
MARKER_KEYS = {"seed", "tag", "in_flight", "final_step", "test_accuracy",
               "converged", "restarts", "wall_minutes"}


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    """A set of 8 canvases per digit count from the committed digit pool,
    written by the sweep's --synthetic-data."""
    from air_tpu_torch.training import synthesize
    data = str(tmp_path_factory.mktemp("sweep") / "data")
    synthesize(data, 8)
    return data


def test_seed_sweep_cli_writes_the_jax_scripts_rows(sweep_data, tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "air_tpu_torch.seed_sweep", "0", "1",
         "--data", sweep_data, "--out", str(out), *SWEEP_FLAGS],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in open(out / "results.jsonl")]
    assert [set(r) for r in rows] == [MARKER_KEYS] * 2 + [ROW_KEYS] * 2
    assert [r["seed"] for r in rows] == [0, 1, 0, 1]
    final = rows[2:]
    assert all(r["final_step"] == 7 and r["restarts"] == 0
               and r["variant"] == "base" and r["tag"] ==
               "vmap_hold15000_cnn_rot" and 0.0 <= r["test_accuracy"] <= 1.0
               for r in final), final
    printed = [json.loads(line.split(" ", 1)[1])
               for line in proc.stdout.splitlines()
               if line.startswith("SWEEPRESULT ")]
    assert printed == final
    evals = [line for line in proc.stdout.splitlines()
             if line.startswith("[eval @ ")]
    assert [e.split("]")[0] for e in evals] == [
        "[eval @ 0", "[eval @ 4", "[eval @ 7"]


@pytest.fixture(scope="module")
def base_sweep(sweep_data, tmp_path_factory):
    """(argv, result) of a sweep of seeds 0 and 1 that may restart from
    step 1 (none stalls)."""
    argv = ["0", "1", "--data", sweep_data, *SWEEP_FLAGS,
            "--stall-restart", "1", "--post-restart-iters", "0"]
    out = tmp_path_factory.mktemp("base_sweep")
    return argv, seed_sweep.main([*argv, "--out", str(out)])


def test_seed_sweep_stall_reseeds_only_that_replica(base_sweep, tmp_path,
                                                   monkeypatch):
    """A stall forced on replica 1 at the step-4 eval re-seeds it
    (attempt_seed, the next rotation variant, a fresh clock); replica 0
    trains on bit-equal to a sweep without the stall."""
    argv, base = base_sweep

    from air_tpu_torch.train import trainer
    calls = []

    def stalled(history, step, *a):
        calls.append(step)
        return len(calls) == 4          # replica 1, at the step-4 eval
    monkeypatch.setattr(trainer, "is_stalled", stalled)
    got = seed_sweep.main([*argv, "--out", str(tmp_path / "b")])
    assert got["seeds"] == [0, 1 + 1009]
    assert [r["restarts"] for r in got["rows"]] == [0, 1]
    assert [r["variant"] for r in got["rows"]] == ["base", 0]
    # replica 1 restarted at the shared step 4: 3 steps on its new clock
    assert got["state"].step.tolist() == [7, 3]
    assert [r["final_step"] for r in got["rows"]] == [7, 3]
    for a, b in zip(tree_leaves(got["state"].params),
                    tree_leaves(base["state"].params)):
        assert torch.equal(a[0], b[0])
        assert not torch.equal(a[1], b[1])


def test_seed_sweep_unrolled_is_the_rolled_sweep(base_sweep, tmp_path):
    """--pipeline-unroll 2 tags its rows _pu2 and trains the replicas to
    the bits of --pipeline-unroll 1."""
    argv, base = base_sweep
    got = seed_sweep.main([*argv, "--pipeline-unroll", "2",
                           "--out", str(tmp_path / "b")])
    assert all(r["tag"] == "vmap_hold15000_cnn_rot_pu2" for r in got["rows"])
    assert [r["test_accuracy"] for r in got["rows"]] == [
        r["test_accuracy"] for r in base["rows"]]
    assert got["state"].step.tolist() == [7, 7]
    for a, b in zip(tree_leaves(got["state"].params),
                    tree_leaves(base["state"].params)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_vmap_rule_on_the_card():
    """Each wrapper under vmap over S = 3 replicas on CUDA tensors launches
    each of its kernels once per application (S times fewer than the
    per-replica calls) and agrees with the per-replica calls of the same
    kernels: outputs and every input's gradient to 1e-5 (values) and 1e-4
    x max(1, max |grad|) (the scalar cotangents, as
    tests/test_torch_st_inline.py holds them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    modules = (st_inline, st_pallas, st_fused)
    for name, (fn, kinds) in WRAPPERS.items():
        inputs = [t.detach().cuda().requires_grad_(True)
                  for t in _inputs(kinds, 7)]
        counts = []
        for folded in (True, False):
            for m in modules:
                m.reset_launches()
            if folded:
                out = vmap(fn)(*inputs)
            else:
                out = torch.stack([fn(*[t[r] for t in inputs])
                                   for r in range(S_)])
            grads = torch.autograd.grad(out, inputs, torch.ones_like(out))
            torch.cuda.synchronize()
            counts.append({k: v for m in modules
                           for k, v in m.LAUNCHES.items() if v})
            if folded:
                got, g_got = out, grads
        assert counts[0] and counts[1] == {k: S_ * v
                                           for k, v in counts[0].items()}
        torch.testing.assert_close(got, out, rtol=1e-5, atol=1e-5)
        for a, w in zip(g_got, grads):
            tol = 1e-4 * max(1.0, float(w.abs().max()))
            torch.testing.assert_close(a, w, rtol=0, atol=tol)
