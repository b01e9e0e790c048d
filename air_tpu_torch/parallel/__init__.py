"""Multi-device training over ``torch.distributed``: the counterpart of
``air_tpu/parallel``.

One process per device (``launch``). Every rank builds the same
``Mesh`` of ``data x model`` ranks (``mesh.make_mesh``); the data axis
splits each batch and averages the gradients, the model axis holds the
large 2-D kernels as column slices (``mesh.shard_state``) that the layers
gather (``collectives``). ``train_parallel`` gives the parallel train and
eval steps; ``train.fast_pipeline.make_parallel_multi_step`` the captured
device-data one. The modules are imported by name: the layers import
``collectives``, so this package imports nothing itself.
"""
