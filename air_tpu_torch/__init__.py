"""air_tpu_torch: the PyTorch/CUDA port of air_tpu for an NVIDIA H100.

Mirrors ``air_tpu``'s module names. Plain tensor code is PyTorch; each
Pallas kernel of ``air_tpu`` on a ported path is a hand-written CUDA kernel
under ``air_tpu_torch/kernels/csrc``, built with nvcc on first use. Imports
torch and numpy only, never JAX or the JAX package.
"""

from air_tpu_torch.models.air import (AIRModel, AIROutputs, air_forward,
                                      init_air_params)
from air_tpu_torch.models.config import AIRConfig, DEFAULT_TRAINING_CONFIG
from air_tpu_torch.serve.model_wrapper import ModelWrapper

__all__ = ["AIRConfig", "AIRModel", "AIROutputs", "DEFAULT_TRAINING_CONFIG",
           "ModelWrapper", "air_forward", "init_air_params"]
