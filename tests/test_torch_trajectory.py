"""The port's training against the JAX package's across many steps, and the
port's random draws against JAX's in law.

Draws: each kind the forward pass takes (``scale``, ``shift``,
``vae_latent``, ``vae_out`` ~ N(0, 1); ``z_pres_u`` ~ U(0, 1)) from
``steps.step_generator(seed, step)`` on the CPU, at the robust default's
shapes (batch 64, 3 steps), against JAX's ``fold_in(key, step)`` draws and
the law itself: moments within 5 standard errors, two-sample and
one-sample Kolmogorov-Smirnov tests at p > 1e-3. The Concrete's logistic
noise ``log(u + 1e-9) - log(1 - u + 1e-9)`` at both tails: the port's
function gives JAX's values on the extreme float32 uniforms (to 0.1% next
to 1, where XLA drops the 1e-9), and the tail frequencies match the
logistic law. No correlation (|r| < 5 / sqrt(n))
between the streams of consecutive steps, consecutive seeds, the
seed-parallel step's replicas, a stall restart's ``attempt_seed`` and the
eval stream.

Trajectory (``scripts/trajectory_torch.py``): both packages run 40 train
steps from one JAX state on the same batches and draws (the port through
st_impl "inline" and "xla", JAX through its plain products), at the narrow
config with bf16 Adam moments and clip 1.0, with the z_pres prior held for
12 steps and then decaying a decade every 8 (so the run crosses the hold's
end and four decades). The witness is JAX from the init with the LSTM
kernel one ulp up. Tolerances: every host scalar (annealed
hyperparameters, Adam's bias corrections) within 2 float32 ulps of JAX's
at every step; the port's relative param distance to JAX within 4x the
witness's at every step; the port's loss within 1e-5 relative of JAX's at
every step. Both distances grow about linearly here and their ratio stays
between 0.4 and 2 in both cases (the port's rounding is made afresh every
step, the witness's ulp once). In a copy of the port run through "xla"
on the robust schedule, the Adam count one step on, the hold one step
longer and the moments kept in float32 each failed at least one of the
three (ratios 4724, 3.1 and 12.5; 2.4 million ulps of the prior at the
hold's end; losses 1e-2, 5e-4, 2e-5 apart)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from air_tpu.models.config import AIRConfig as JaxConfig
from air_tpu.models.config import DEFAULT_TRAINING_CONFIG as JAX_DEFAULT
from air_tpu.ops.concrete import _logistic_noise as jax_logistic_noise
from air_tpu.train.state import create_train_state as jax_create
from air_tpu_torch.models.air import draw_noise
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.ops.concrete import logistic_noise
from air_tpu_torch.train.multi_seed import EVAL_SEED, replica_noise
from air_tpu_torch.train.steps import step_generator
from air_tpu_torch.train.trainer import attempt_seed
from tests.test_torch_model import SMALL
from tests.test_torch_train import MAIN_OPT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = AIRConfig(**{f: getattr(JAX_DEFAULT.replace(cnn=True), f)
                   for f in JaxConfig.__dataclass_fields__
                   if f in AIRConfig.__dataclass_fields__})
BATCH = 64
STEPS = 200
# draws per kind kept for the tests: the large kinds from fewer steps
KEEP_STEPS = {"scale": STEPS, "shift": STEPS, "z_pres_u": STEPS,
              "vae_latent": 20, "vae_out": 2}
KINDS = tuple(KEEP_STEPS)
P_MIN = 1e-3


_spec = importlib.util.spec_from_file_location(
    "trajectory_torch", os.path.join(REPO, "scripts", "trajectory_torch.py"))
traj = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(traj)


@pytest.fixture(scope="module")
def draws():
    """{kind: (port sample, JAX sample)} over STEPS steps of seed 0."""
    key = jax.random.PRNGKey(0)
    keys = jax.vmap(lambda s: jax.random.fold_in(key, s))(
        jnp.arange(STEPS))
    jax_all = jax.jit(jax.vmap(
        lambda k: traj.jax_draws(k, CFG, BATCH)))(keys)
    port = [draw_noise(CFG, BATCH, step_generator(0, s, "cpu"), "cpu")
            for s in range(STEPS)]
    return {k: (torch.stack([d[k] for d in port[:n]]).numpy().ravel(),
                np.asarray(jax_all[k][:n]).ravel())
            for k, n in KEEP_STEPS.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_draws_match_jax_in_law(kind, draws):
    port, want = draws[kind]
    assert port.dtype == want.dtype == np.float32
    assert port.size == want.size
    n = port.size
    if kind == "z_pres_u":
        law = stats.uniform()
        assert port.min() >= 0.0 and port.max() < 1.0
    else:
        law = stats.norm()
    mean, var = law.mean(), law.var()
    # standard errors of the sample mean and variance under the law
    se_mean = np.sqrt(var / n)
    se_var = np.sqrt((law.moment(4) - 4 * mean * law.moment(3)
                      + 6 * mean ** 2 * law.moment(2) - 3 * mean ** 4
                      - var ** 2) / n)
    for sample in (port, want):
        x = sample.astype(np.float64)
        assert abs(x.mean() - mean) < 5 * se_mean
        assert abs(x.var() - var) < 5 * se_var
        assert stats.kstest(x, law.cdf).pvalue > P_MIN
    assert stats.ks_2samp(port, want).pvalue > P_MIN


def test_logistic_noise_tails_match_jax(draws):
    """The Concrete's noise at both tails. On the extreme float32 uniforms
    (0, the smallest steps of JAX's 2^-23 and the port's 2^-24 grids, the
    largest below 1) the port's function gives JAX's values, saturating at
    log(1e-9) at u = 0, except next to 1: there XLA folds ``1.0 + 1e-9``
    to 1 in float32, so JAX's top value is log(u) - log(1 - u) (15.942 at
    u = 1 - 2^-23 against the port's 15.934), a difference of 0.1% in
    draws of probability ~1e-7. Over the drawn uniforms the tail
    frequencies P(|L| > t) of both match the logistic law's
    2 / (1 + e^t), and the samples match each other and the law."""
    u = np.array([0.0, 2.0 ** -24, 2.0 ** -23, 3 * 2.0 ** -24, 1e-6,
                  0.5, 1 - 2.0 ** -23, 1 - 2.0 ** -24], np.float32)
    got = logistic_noise(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.jit(lambda x: jnp.log(x + 1e-9)
                              - jnp.log(1.0 - x + 1e-9))(jnp.asarray(u)))
    np.testing.assert_allclose(got[:-2], want[:-2], rtol=1e-6, atol=1e-6)
    u64 = u[-2:].astype(np.float64)
    np.testing.assert_allclose(want[-2:], np.log(u64) - np.log(1 - u64),
                               rtol=1e-6)
    np.testing.assert_allclose(got[-2:], want[-2:], rtol=2e-3)
    assert got[0] == pytest.approx(np.log(1e-9), rel=1e-6)
    assert np.all(np.diff(got) > 0) and np.all(np.abs(got) < 21.0)

    port_u, _ = draws["z_pres_u"]
    port = logistic_noise(torch.from_numpy(port_u)).numpy()
    want = np.asarray(jax_logistic_noise(jax.random.PRNGKey(3),
                                         port.shape))
    n = port.size
    for t in (2.0, 4.0, 6.0):
        p = 2.0 / (1.0 + np.exp(t))
        bound = 5 * np.sqrt(p * (1 - p) / n) + 1.0 / n
        for sample in (port, want):
            assert abs(np.mean(np.abs(sample) > t) - p) < bound, t
    assert stats.ks_2samp(port, want).pvalue > P_MIN
    for sample in (port, want):
        assert stats.kstest(sample, stats.logistic().cdf).pvalue > P_MIN


def _flat(d):
    return torch.cat([d[k].reshape(-1) for k in KINDS]).double().numpy()


def _corr(a, b):
    return float(np.corrcoef(a, b)[0, 1])


STREAM_PAIRS = {
    # (seed, step) of the two streams
    "consecutive steps": [((0, s), (0, s + 1)) for s in (0, 1, 7, 14999)],
    "consecutive seeds": [((r, 5), (r + 1, 5)) for r in (0, 1, 8)],
    "attempt_seed": [((3, 5), (attempt_seed(3, 1), 5)),
                     ((3, 0), (attempt_seed(3, 2, 7), 0))],
    "eval stream": [((0, 5), (0 ^ EVAL_SEED, 5)),
                    ((4, 2500), (4 ^ EVAL_SEED, 2500))],
    "step vs seed": [((0, 1), (1, 0)), ((2, 3), (3, 2))],
}


@pytest.mark.parametrize("pairs", STREAM_PAIRS.values(),
                         ids=STREAM_PAIRS.keys())
def test_streams_are_uncorrelated(pairs):
    for (sa, ka), (sb, kb) in pairs:
        a = _flat(draw_noise(CFG, BATCH, step_generator(sa, ka, "cpu"),
                             "cpu"))
        b = _flat(draw_noise(CFG, BATCH, step_generator(sb, kb, "cpu"),
                             "cpu"))
        assert not np.array_equal(a, b)
        assert abs(_corr(a, b)) < 5 / np.sqrt(a.size), ((sa, ka), (sb, kb))


def test_replica_draws_are_the_single_seed_streams():
    """Replica r of the seed-parallel step draws from its own (seed, step),
    as the single-seed step does, so replicas are uncorrelated too."""
    seeds = [0, 1, 2, attempt_seed(1, 1)]
    steps = torch.tensor([7, 7, 3, 0])
    stacked = replica_noise(CFG, BATCH, seeds, steps, "cpu")
    flat = []
    for r, (seed, step) in enumerate(zip(seeds, steps.tolist())):
        single = draw_noise(CFG, BATCH, step_generator(seed, step, "cpu"),
                            "cpu")
        for k in KINDS:
            torch.testing.assert_close(stacked[k][r], single[k], rtol=0,
                                       atol=0)
        flat.append(_flat(single))
    for a, b in zip(flat, flat[1:]):
        assert abs(_corr(a, b)) < 5 / np.sqrt(a.size)


SCHEDULES = {
    # the robust default's z_pres prior, hold and decade shortened
    "robust": {"z_pres_prior_log_odds": {
        "init": 1e4, "min": 1e-9, "factor": 0.1, "iters": 8, "log": True,
        "hold": 12}},
    # with the sequential sweep's temperature anneal and scale-prior
    # curriculum, shortened the same way
    "curricula": {
        "z_pres_prior_log_odds": {"init": 1e4, "min": 1e-9, "factor": 0.1,
                                  "iters": 8, "log": True, "hold": 12},
        "z_pres_temperature": {"init": 5.0, "min": 1.0, "factor": 0.5,
                               "iters": 6, "log": False},
        "scale_prior_mean": {"init": 1.0, "min": 0.0, "factor": 0.5,
                             "iters": 5, "offset": -1.0}},
}


@pytest.fixture(scope="module")
def jax_init():
    """One JAX init of the narrow config for both cases (the params do not
    depend on st_impl or the schedules); the port's small eager ops on
    one thread, as the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield jax_create(JaxConfig(**SMALL, **MAIN_OPT), rng=0)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("st_impl,schedules", [("inline", "robust"),
                                               ("xla", "curricula")])
def test_trajectory_parts_from_jax_no_faster_than_the_witness(
        st_impl, schedules, jax_init):
    kw = {**SMALL, **MAIN_OPT, "st_impl": st_impl,
          "annealing_schedules": SCHEDULES[schedules]}
    rng = np.random.default_rng(0)
    images = (rng.uniform(size=(96, SMALL["canvas_size"] ** 2)) ** 4
              ).astype(np.float32)
    digits = (np.arange(96) % 3).astype(np.int32)
    # JAX through its plain products: its Pallas kernel's reference, which
    # the port's inline twin matches (tests/test_torch_st_inline.py)
    out = traj.trajectories(JaxConfig(**{**kw, "st_impl": "xla"}),
                            AIRConfig(**kw),
                            traj.batch_iter(images, digits, 16, 0), 40,
                            jstate=jax_init)
    assert len(out["loss"]) == 40
    assert set(out["host_ulps"]) == {*SCHEDULES[schedules], "c1", "c2"}
    assert max(out["host_ulps"].values()) <= 2, out["host_ulps"]
    port, witness = np.asarray(out["port_param"]), np.asarray(
        out["witness_param"])
    assert np.all(witness > 0) and np.all(np.diff(witness[5:]) > 0)
    ratio = port / witness
    assert np.all(ratio <= 4.0), ratio
    assert np.all(np.asarray(out["port_loss"]) <= 1e-5)
