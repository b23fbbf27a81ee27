"""Process-group mesh for multi-device mapping.

Counterpart of splatloam_tpu/parallel/mesh.py.  JAX runs one controller
over a device mesh; the port runs one process per rank (SPMD over
torch.distributed), because its optimize loop is paced by the host and
one Python controller driving N devices would pay that host cost N times.
Axes, as in the JAX package:
  "data"  — the range image (row blocks, or a balanced subset of tiles)
            is split across ranks; gradients are summed over the axis;
  "model" — the surfel pool and its Adam state are split FSDP-style:
            parameters are all-gathered for a step, each rank updates its
            own slice.

World rank r sits at (data, model) = divmod(r, model), the row-major
layout of the JAX mesh's ``reshape(data, model)``.  Every axis gets its own
process group (``torch.distributed.new_group``), created by every rank in
the same order.  A ``DeviceMesh`` is not used: it ties its groups to its
device type's default backend, and ranks that share one GPU need gloo
groups that carry CUDA tensors.

Transport is chosen once, here, from the world's backend: NCCL when every
rank has a GPU of its own; gloo on the CPU and for ranks that share one
GPU (NCCL refuses two ranks on one device).  Under gloo the collective
layer stages every CUDA tensor through host memory; that rule is fixed
when the mesh is built and printed, never a retry after a failure.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..logging_utils import get_logger

logger = get_logger("parallel")

# a desynchronised collective fails after this long instead of hanging
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class Group:
    """One process group of the mesh, seen from this rank."""
    pg: object            # torch.distributed ProcessGroup
    ranks: tuple          # world ranks, in group order
    rank: int             # this rank's index in ``ranks``
    staged: bool          # CUDA tensors pass through host memory (gloo)

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh of torch.distributed ranks; ``device`` is this
    rank's device, where its kernels run."""
    data: int
    model: int
    device: torch.device
    backend: str
    groups: dict          # "data" / "model" / "world" -> Group

    @property
    def rank(self) -> int:
        return self.groups["world"].rank

    @property
    def data_index(self) -> int:
        return self.groups["data"].rank

    @property
    def model_index(self) -> int:
        return self.groups["model"].rank

    def group(self, axis: str) -> Group:
        return self.groups[axis]


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when the host has a GPU per
    local rank, ``cuda:LOCAL_RANK % n_gpus`` for ranks that share (one GPU:
    ``cuda:0``), the CPU when ``kind`` is "cpu"."""
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def transport_backend(device: torch.device) -> str:
    """NCCL when every local rank has a GPU of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           device: torch.device | str | None = None,
                           backend: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group: from the arguments, or from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``).
    A no-op for one process or when already joined; returns whether this
    process is part of a group of more than one rank."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        dev = torch.device(device) if device is not None else rank_device()
        backend = transport_backend(dev)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return world_size > 1


def make_mesh(data: int | None = None, model: int = 1,
              device: torch.device | str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Mesh over (data, model) of the joined process group; data defaults
    to world_size // model.  Raises unless data * model == world size."""
    if not (dist.is_available() and dist.is_initialized()):
        n = (data or 1) * model
        raise RuntimeError(
            f"parallel mesh {data}x{model} needs {n} torch.distributed "
            f"ranks, but no process group is initialised (launch with "
            f"torchrun --nproc-per-node {n}, or call "
            f"parallel.initialize_distributed first)")
    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"world size {world} is not a multiple of "
                             f"model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != world size {world}")
    device = torch.device(device) if device is not None else rank_device()
    backend = dist.get_backend()
    staged = backend == "gloo" and device.type == "cuda"
    me = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    # every rank creates every group, in the same order
    layouts = {
        "data": [[d * model + m for d in range(data)]
                 for m in range(model)],
        "model": [[d * model + m for m in range(model)]
                  for d in range(data)],
        "world": [list(range(world))],
    }
    for axis, lists in layouts.items():
        for ranks in lists:
            pg = dist.new_group(ranks, timeout=timeout)
            if me in ranks:
                groups[axis] = Group(pg=pg, ranks=tuple(ranks),
                                     rank=ranks.index(me), staged=staged)
    mesh = Mesh(data=data, model=model, device=device, backend=backend,
                groups=groups)
    if me == 0:
        logger.info(f"mesh: data={data} model={model} over {world} ranks, "
                    f"backend {backend}, device {device.type}"
                    + (", CUDA tensors staged through host memory"
                       if staged else ""))
    return mesh
