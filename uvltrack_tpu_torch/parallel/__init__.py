from .mesh import Mesh, init_distributed, make_mesh, replicated, shard_batch, zero1_axis
from .tp import (TensorParallel, gather_params_tp, shard_params_tp, tp_spec_for)

__all__ = ["Mesh", "TensorParallel", "gather_params_tp", "init_distributed", "make_mesh",
           "replicated", "shard_batch", "shard_params_tp", "tp_spec_for", "zero1_axis"]
