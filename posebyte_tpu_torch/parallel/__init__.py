"""Several devices: multi-stream serving over a mesh of devices and
data-parallel training over a process group."""
from .sharding import (make_mesh, MultiStreamPipeline,
                       MultiStreamChunkPipeline)
from .train import (make_data_mesh, make_dp_train_step,
                    make_dp_scan_train, shard_dataset)

__all__ = ["make_mesh", "MultiStreamPipeline",
           "MultiStreamChunkPipeline", "make_data_mesh",
           "make_dp_train_step", "make_dp_scan_train", "shard_dataset"]
