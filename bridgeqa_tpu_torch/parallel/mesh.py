"""The process group, the device and the (data, model) mesh (counterpart of
``bridgeqa_tpu/parallel/mesh.py``).

JAX starts one process per host and puts one global array over a mesh of
devices. Here each rank is a process with one device, started by
``python -m torch.distributed.run`` (torchrun), and holds its shard of the
batch (``BatchIterator(num_shards=, shard_index=)``); the quantities that
JAX computes over the global batch take their collectives in
``parallel/global_batch.py``. ``make_mesh`` lays the ranks out as JAX lays
out devices, ``(data, model)`` row-major, and keeps the mesh current for
those collectives and for ``parallel/tp.py``.
"""

import contextlib
import contextvars
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# the mesh make_mesh made last (process state, as the process group is)
_mesh: DeviceMesh | None = None
# each data-parallel rank's own group for DDP's gradient reductions, so that
# DDP's collectives never interleave with the global-batch ones on a group
_ddp_group = None
# inside ``local_batch``: batch-wide quantities cover this rank's shard only
_local = contextvars.ContextVar("local_batch", default=False)


def initialize_distributed(backend: str | None = None, *, device: str = "cuda") -> torch.device:
    """Join torchrun's process group (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) and bind this rank's device.
    The counterpart of ``jax.distributed.initialize`` and of the reference's
    ``init_process_group`` (``scripts/train.py:181-187``).

    ``device`` "cuda" binds ``cuda:$LOCAL_RANK`` (the reference binds the
    global rank, which is wrong past one node); "cuda:i" binds card i (two
    ranks may share a card over gloo); "cpu" binds the CPU. The backend is
    ``nccl`` for a card and ``gloo`` for the CPU unless ``backend`` names
    one. Nothing falls back: a failed init raises. Idempotent, as JAX's is:
    a second call returns the device it binds and joins nothing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"initialize_distributed(device={device!r}): no CUDA card here")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://")
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, the one that writes a run's artifacts."""
    return rank() == 0


def make_mesh(data: int | None = None, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` ``DeviceMesh`` over the ranks, JAX's axis names:
    ``data`` (the batch's shards) defaults to ``world_size() // model``,
    ``model`` is the tensor-parallel size (``parallel/tp.py``). Rank ``r``
    sits at ``(r // model, r % model)``. Becomes the current mesh."""
    global _mesh, _ddp_group
    world = world_size()
    if data is None:
        if world % model:
            raise ValueError(f"model axis {model} must divide the world size {world}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) does not cover the {world} ranks")
    # only the groups are used: NCCL's are the cards', gloo's take CPU and
    # CUDA tensors alike
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    ddp_group = None
    for m in range(model):  # every rank takes part in making every group
        group = dist.new_group([d * model + m for d in range(data)])
        if rank() % model == m:
            ddp_group = group
    _mesh, _ddp_group = mesh, ddp_group
    return mesh


def current_mesh() -> DeviceMesh | None:
    return _mesh


def data_size() -> int:
    """The number of data-parallel ranks (the batch's shards)."""
    if _mesh is not None:
        return _mesh.size(0)
    return world_size()


def data_rank() -> int:
    """This rank's index on the data axis: which shard of the batch it holds."""
    if _mesh is not None:
        return _mesh.get_local_rank("data")
    return rank()


def data_group():
    """The group that batch-wide quantities are reduced over, or None where
    this rank holds the whole batch: no process group, one data-parallel
    rank, or inside ``local_batch``. Without a mesh every rank is a
    data-parallel rank."""
    if _local.get() or data_size() == 1:
        return None
    return _mesh.get_group("data") if _mesh is not None else dist.group.WORLD


def ddp_group():
    """The data-parallel group DDP reduces gradients over (the same ranks
    as ``data_group``, a group of its own)."""
    if _mesh is not None:
        return _ddp_group
    return dist.group.WORLD if dist.is_initialized() else None


@contextlib.contextmanager
def local_batch():
    """Inside, batch-wide quantities cover this rank's shard alone: the
    sharded eval step's per-shard losses (JAX's ``pmean`` of per-shard
    values, ``parallel/eval.py``)."""
    token = _local.set(True)
    try:
        yield
    finally:
        _local.reset(token)
