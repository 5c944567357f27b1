from .mesh import Mesh, init_distributed, make_mesh, replicated, shard_batch, zero1_axis

__all__ = ["Mesh", "init_distributed", "make_mesh", "replicated", "shard_batch", "zero1_axis"]
