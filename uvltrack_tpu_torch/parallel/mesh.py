"""The (data, model) device grid of data-parallel training and of the stream
mesh (port of uvltrack_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a jax.sharding.Mesh: the batch
sharded on "data", the parameters replicated, every collective inserted by
XLA. The port has two views of the same grid:

- in one process, a grid of torch devices (make_mesh(devices=...), or the
  visible cards): BatchTracker/StreamPool(mesh=) run one replica of the
  lockstep step per data index, each on its device with its share of the
  streams and a copy of the weights (replicated);
- one process per device under torch.distributed (cli/train --multihost,
  init_distributed): each process is one point of the grid; its data index
  is rank // model and its model index rank % model; the ranks of one model
  index form its data-parallel group (parallel/dp.py holds the
  collectives), the ranks of one data index its model group (parallel/
  tp.py's).

The ranks of one data index get the same rows. MESH_MODEL > 1 in
cli/train replicates the parameters, as the JAX CLI's mesh does without
parallel/tp.py; the train step splits them with tp= (train/step.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torchrun's environment, which init_distributed reads
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@dataclass(frozen=True)
class Mesh:
    """data x model grid. `devices`: in one process, the data*model devices
    row-major (data index i owns devices[i*model:(i+1)*model]); in a process
    group, this process's device. `rank`/`world`: the process's place in
    the group (0 and 1 in one process); `group`: its data-parallel process
    group (None: the default group); `model_group`: its model group (the
    ranks d*model .. d*model + model-1 of its data index d; None: the
    default group)."""
    data: int
    model: int
    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        """Process 0: the one that logs and writes checkpoints."""
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.world > 1

    def data_devices(self) -> list:
        """One device per data index (its model-column 0): where the stream
        mesh puts its replicas."""
        return list(self.devices[::self.model])


def local_devices(device=None) -> list:
    """The devices one process can see: every CUDA card, or the CPU when
    `device` is a CPU device (or no card is visible)."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """The (data, model) grid. data=-1: every device (process) not taken by
    `model`. Under an initialized process group the grid is the world's
    ranks (data * model must equal the world size) and `devices`, if given,
    is this process's one device; the ranks of each model index get their
    own data-parallel group and, with model > 1, the ranks of each data
    index their model group (every rank takes part in making each). Else
    the grid is `devices` (the visible cards by default) in this process."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        data = world // model if data == -1 else data
        if data * model != world:
            raise ValueError(f"mesh {data} x {model} over {world} processes")
        group = model_group = None
        if model > 1:
            for m in range(model):  # new_group is collective: every rank makes each
                g = dist.new_group([d * model + m for d in range(data)])
                if rank % model == m:
                    group = g
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if rank // model == d:
                    model_group = g
        own = tuple(torch.device(d) for d in devices) if devices else (torch.device("cpu"),)
        return Mesh(data, model, own[:1], rank=rank, world=world, group=group,
                    model_group=model_group)
    devs = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    data = len(devs) // model if data == -1 else data
    if not 0 < data * model <= len(devs):
        raise ValueError(f"mesh {data} x {model} over {len(devs)} devices")
    return Mesh(data, model, tuple(devs[:data * model]))


def replicated(mesh: Mesh, module: torch.nn.Module) -> dict:
    """{device: a copy of `module` on it} for every distinct device of the
    mesh's data axis; the module itself serves its own device."""
    import copy

    own = next(module.parameters()).device
    out = {}
    for dev in mesh.data_devices():
        if dev not in out:
            out[dev] = module if dev == own else copy.deepcopy(module).to(dev)
    return out


def shard_batch(mesh: Mesh, batch: dict, microbatches: int = 1) -> dict:
    """This data index's rows of every leaf (numpy arrays or tensors), cut
    along the batch axis of _split_microbatches's rule: leaves of ndim >= 3
    are frame-major (n, B, ...) and cut on axis 1, the others (text (B, Nt),
    flag (B,)) on axis 0. With k microbatches the global batch is split into
    k first and each microbatch sharded second, so microbatch i of every
    rank's rows is its share of the global microbatch i (the JAX step
    splits the global batch, then shards each microbatch)."""
    n, i, k = mesh.data, mesh.data_index, microbatches
    if n == 1:
        return batch
    b = batch["flag"].shape[0]
    if b % (n * k):
        raise ValueError(f"global batch {b} not divisible by {n} data shards x {k} microbatches")
    r = b // (n * k)

    def cut(x):
        if x.ndim >= 3:
            head, rest = x.shape[:1], x.shape[2:]
            return x.reshape(*head, k, n, r, *rest)[:, :, i].reshape(*head, k * r, *rest)
        return x.reshape(k, n, r, *x.shape[1:])[:, i].reshape(k * r, *x.shape[1:])

    return {key: cut(v) for key, v in batch.items()}


def zero1_axis(shape: Sequence[int], n: int) -> Optional[int]:
    """The axis ZeRO-1 partitions a moment of this shape along over n data
    shards (zero1_moment_sharding's rule, taken on the torch layout): the
    largest axis that n divides, the first of equal ones; None (replicated)
    for scalars, n <= 1 and shapes that no axis divides."""
    if n <= 1 or len(shape) == 0:
        return None
    for axis in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[axis] % n == 0 and shape[axis] >= n:
            return axis
    return None


def init_distributed(device, backend: Optional[str] = None) -> torch.device:
    """Join the process group torchrun describes (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK: all of them, or an error naming those
    missing). Returns this process's device: cuda:LOCAL_RANK for a CUDA
    `device` (made current), else the CPU. backend: NCCL for CUDA and gloo
    for the CPU unless named."""
    missing = [k for k in DIST_ENV if not os.environ.get(k)]
    if missing:
        raise SystemExit("--multihost needs torchrun's environment (" + ", ".join(DIST_ENV)
                         + "): " + ", ".join(missing) + " not set")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]))
    return device
