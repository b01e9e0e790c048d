"""The data path of the port: digit sources, the multi-MNIST generator,
AIRREC records and the loaders. numpy only (scipy for the generator)."""

from air_tpu_torch.data.loader import (DeviceDataPipeline, TrainLoader,
                                       load_test_data, to_device)
from air_tpu_torch.data.mnist import get_mnist, load_digit_pool, load_mnist
from air_tpu_torch.data.multi_mnist import (MultiMNISTConfig,
                                            generate_dataset,
                                            generate_multi_image)
from air_tpu_torch.data.records import read_records, write_records

__all__ = [
    "DeviceDataPipeline", "MultiMNISTConfig", "TrainLoader",
    "generate_dataset", "generate_multi_image", "get_mnist",
    "load_digit_pool", "load_mnist", "load_test_data", "read_records",
    "to_device", "write_records",
]
