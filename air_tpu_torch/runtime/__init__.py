"""Native (C++) host runtime: the shuffle/batch loader.

Built on first use from air_tpu_torch/runtime/loader.cc (see
build_native()); the numpy loader in air_tpu_torch.data.loader is the
semantic reference and the fallback when no ``g++`` is found.
"""

from air_tpu_torch.runtime.native import NativeShuffleLoader, build_native  # noqa: F401
