"""The port imports neither JAX nor the JAX package: every module of
air_tpu_torch, and chip_smoke.py's module-level code, import and run in a
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

NO_JAX = """
import importlib, pkgutil, runpy, sys
for name in ("jax", "jaxlib", "optax", "air_tpu"):
    sys.modules[name] = None          # any import of them now fails
import air_tpu_torch
for mod in pkgutil.walk_packages(air_tpu_torch.__path__, "air_tpu_torch."):
    importlib.import_module(mod.name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "air_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK")
"""


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
