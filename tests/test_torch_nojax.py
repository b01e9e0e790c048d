"""The port imports neither JAX nor the JAX package: every module of
air_tpu_torch (the slice's modules among them), and the module-level code of
chip_smoke.py and of the port's profiling scripts, import and run in a
process where importing jax or air_tpu fails. And chip_smoke.py gives no
result without a card or without the rest of the repository."""

import os
import shutil
import subprocess
import sys

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py pins it)
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules the port must have; the walk imports every module it finds
PORT_MODULES = (
    "air_tpu_torch.interop", "air_tpu_torch.tree", "air_tpu_torch.training",
    "air_tpu_torch.data.backgrounds", "air_tpu_torch.data.loader",
    "air_tpu_torch.data.mnist", "air_tpu_torch.data.multi_mnist",
    "air_tpu_torch.data.png", "air_tpu_torch.generate_multi_mnist",
    "air_tpu_torch.eval_checkpoint",
    "air_tpu_torch.data.records", "air_tpu_torch.runtime.native",
    "air_tpu_torch.utils.tb_writer",
    "air_tpu_torch.kernels.build", "air_tpu_torch.kernels.st_fused",
    "air_tpu_torch.kernels.st_inline", "air_tpu_torch.kernels.st_pallas",
    "air_tpu_torch.models.air", "air_tpu_torch.models.config",
    "air_tpu_torch.nn.cnn", "air_tpu_torch.nn.layers", "air_tpu_torch.nn.lstm",
    "air_tpu_torch.nn.vae", "air_tpu_torch.ops.concrete",
    "air_tpu_torch.parallel", "air_tpu_torch.parallel.collectives",
    "air_tpu_torch.parallel.launch", "air_tpu_torch.parallel.mesh",
    "air_tpu_torch.parallel.train_parallel",
    "air_tpu_torch.ops.gaussian", "air_tpu_torch.ops.schedules",
    "air_tpu_torch.ops.transformer", "air_tpu_torch.serve.model_wrapper",
    "air_tpu_torch.train.checkpoint", "air_tpu_torch.train.metrics",
    "air_tpu_torch.train.state", "air_tpu_torch.train.steps",
    "air_tpu_torch.train.evaluate", "air_tpu_torch.train.trainer",
    "air_tpu_torch.train.visualize", "air_tpu_torch.train.multi_seed",
    "air_tpu_torch.train.fast_pipeline", "air_tpu_torch.utils.profiling",
    "air_tpu_torch.seed_sweep", "air_tpu_torch.seed_sweep_single",
    "air_tpu_torch.summarize_sweep", "air_tpu_torch.ledger",
    "air_tpu_torch.demo",
    "air_tpu_torch.embeddings", "air_tpu_torch.tools.demo_tk",
    "air_tpu_torch.tools.embeddings", "air_tpu_torch.tools.headless_demo")

NO_JAX = """
import importlib, pkgutil, runpy, sys
for name in ("jax", "jaxlib", "optax", "air_tpu"):
    sys.modules[name] = None          # any import of them now fails
import air_tpu_torch
walked = set()
for mod in pkgutil.walk_packages(air_tpu_torch.__path__, "air_tpu_torch."):
    importlib.import_module(mod.name)
    walked.add(mod.name)
missing = set(PORT_MODULES) - walked
assert not missing, missing
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
for script in ("profile_torch_serve.py", "profile_torch_train.py",
               "determinism_torch_train.py", "sweep_st_geometry.py",
               "capture_check_torch.py", "make_torch_uci_digits.py"):
    runpy.run_path("scripts/" + script, run_name="profile")
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "air_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK")
""".replace("PORT_MODULES", repr(PORT_MODULES))


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_without_jax():
    proc = _run(["-c", NO_JAX], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
