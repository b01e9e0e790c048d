"""Multi-device training on the card (no JAX: the card's machine has none;
run there with ``python -m pytest --noconftest -m gpu``). The ranks share
the one card:

  * gloo takes CUDA tensors for the collectives the port uses (all-reduce,
    broadcast, the all-reduce gather), exactly;
  * an NCCL world of one trains the single-card step's bits, eager and
    captured (the data-parallel step's two graphs around the all-reduce
    against the one graph of the single-card step).

The CPU counterparts, against the JAX package, are
tests/test_torch_parallel.py."""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks   # tests/, beside this file
from air_tpu_torch.models.config import AIRConfig
from air_tpu_torch.parallel.launch import launch

SMALL = dict(max_steps=3, max_digits=2, rnn_units=32, canvas_size=20,
             windows_size=8, vae_latent_dimensions=6,
             vae_recognition_units=(32, 16), vae_generative_units=(16, 32),
             scale_hidden_units=8, shift_hidden_units=8,
             z_pres_hidden_units=8, cnn=False, train=True,
             adam_storage_dtype="bfloat16", gradient_clipping_norm=1.0,
             st_impl="inline")
pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return "cuda:0"


def test_gloo_collectives_take_cuda_tensors(card):
    out = launch(ranks.collectives, "gloo", [card] * 2, timeout=300)
    for r in out:
        assert r["sum"] == [[3.0] * 5] * 3
        assert r["broadcast"] == [1.0] * 4
        assert r["gather_exact"] and r["bf16"]


def test_nccl_world_of_one_is_the_single_card_step(card):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(8, 400)).astype(np.float32)
    digits = (np.arange(8) % 3).astype(np.int32)
    data = (rng.uniform(size=(40, 400)).astype(np.float32),
            (np.arange(40) % 3).astype(np.int32))
    out = launch(ranks.world1, "nccl", [card],
                 (AIRConfig(**SMALL), images, digits, data), timeout=300)[0]
    assert out["step"]
    single, parallel = out["multi_step"]
    assert single == parallel and single[3] == ranks.K
