"""Multi-device and multi-rank execution on torch.distributed."""
from .mesh import (DataMesh, make_data_mesh, make_sharded_step,
                   reduce_confusion_matrices, shard_batch)
