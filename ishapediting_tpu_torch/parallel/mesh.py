"""Ranks on a data axis: the counterpart of the JAX package's device mesh
(``ishapediting_tpu/parallel/mesh.py``).

The reference's only parallelism is data-parallel sampling with one process
per GPU over ``torch.distributed`` (dist_util.py:21-85,
image_sample.py:104-132). The JAX package drives every device from one
process through a ``Mesh``; the port follows the reference: one process per
rank, launched with ``torchrun`` (``python -m torch.distributed.run``), and a
``DataMesh`` that names this rank's place on the ``data`` axis. Independent
trajectories are this workload's scaling axis, so every rank holds the whole
model (``replicate``) and its own rows of a batch (``shard_batch``);
``gather`` concatenates the rows again, the fetch of a ``P("data")`` array.

The collectives are only ``all_reduce``, ``broadcast`` and ``all_gather``
in its list form: the ones gloo implements for CUDA tensors, so ranks that
share one card can run over gloo (NCCL refuses two ranks on one device).
The backend is explicit: ``nccl`` for ranks on CUDA devices, ``gloo`` on the
CPU, as the reference's ``setup_dist`` chooses; ranks sharing a card pass
``gloo``. Without a launcher environment nothing here starts a process group:
``make_mesh()`` is one rank and every helper is the identity.

Tensor parallelism (the JAX package's ``model`` axis, ``shard_params_tp``)
is not ported: the 421M model fits one H100.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ishapediting_tpu_torch.utils.device import resolve_device

# A collective that waits this long for another rank raises, so a rank that
# failed ends the run instead of leaving the others waiting.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``rank``: this process's rank; ``size``: the ranks on the ``data``
    axis, 0 .. size-1 (ranks past it sit idle); ``device``: this rank's
    device; ``group``: the process group over the axis (None for one rank)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def active(self) -> bool:
        return self.rank < self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n``."""
        if n % self.size:
            raise ValueError(f"batch {n} not divisible by the data axis of {self.size} ranks")
        if not self.active:
            raise ValueError(f"rank {self.rank} is not on the data axis of {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def launched() -> bool:
    """Whether a launcher (``torchrun``) gave this process a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_distributed(backend: Optional[str] = None, *, device=None, **kwargs) -> bool:
    """Join the process group that ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or ``kwargs`` (passed to
    ``torch.distributed.init_process_group``: ``init_method``, ``rank``,
    ``world_size``, ``timeout``) describe. Returns whether a group is up.

    A second call reuses the group. With neither an environment nor
    arguments it logs a warning and the caller goes on as one process, as
    the JAX package's does; otherwise a failure propagates. ``backend``
    defaults to ``nccl`` when ``device`` (default ``cuda``) is a CUDA device
    and ``gloo`` on the CPU; ranks that share a card need ``gloo``."""
    if dist.is_initialized():
        return True
    if not kwargs and not launched():
        log.warning(
            "no RANK/WORLD_SIZE in the environment and no arguments: continuing as one "
            "process; launch with torchrun (python -m torch.distributed.run) for several ranks"
        )
        return False
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kwargs.setdefault("timeout", DEFAULT_TIMEOUT)
    dist.init_process_group(backend, **kwargs)
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for CUDA
    (``LOCAL_RANK`` 0 without a launcher), or the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              device: Union[str, torch.device, None] = None) -> DataMesh:
    """The ``data`` axis over ranks 0 .. ``n_devices``-1 (default: every
    rank). Every rank of the world must call it, in the same order: a
    smaller axis creates its process group collectively."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism (the JAX package's model axis, "
            "shard_params_tp) is not ported yet; the port has the data axis only"
        )
    n_world, rank = world()
    size = n_world if n_devices is None else int(n_devices)
    if not 1 <= size <= n_world:
        raise ValueError(f"a data axis of {size} ranks in a world of {n_world}")
    group = None
    if size > 1:
        group = dist.group.WORLD if size == n_world else dist.new_group(list(range(size)))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DataMesh(rank=rank, size=size, device=dev, group=group)


def shard_batch(x, mesh: DataMesh):
    """This rank's rows of the leading (batch / trajectory) axis."""
    return x[mesh.rows(x.shape[0])]


def gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in rank order, on every rank
    of the axis (each rank gives the same shape)."""
    if mesh.size == 1:
        return x
    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is not on the data axis of {mesh.size} ranks")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def _through_flat(tensors, collective) -> None:
    """Run ``collective`` on one flat copy of ``tensors`` (one dtype) and
    copy the result back, in place: gloo moves a CUDA tensor through host
    memory and each call has its own fixed cost."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def broadcast_flat(tensors, src: int = 0, group=None) -> None:
    """Broadcast ``tensors`` from rank ``src``, in place, one call per
    dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        _through_flat(ts, lambda flat: dist.broadcast(flat, src=src, group=group))


@torch.no_grad()
def all_reduce_flat(tensors, mesh: DataMesh) -> None:
    """Sum ``tensors`` (one dtype) over the ranks of the axis, in place, in
    one call."""
    _through_flat(list(tensors), lambda flat: dist.all_reduce(flat, group=mesh.group))


def replicate(module: nn.Module, mesh: DataMesh) -> nn.Module:
    """Every rank of the axis takes rank 0's parameters and buffers (the
    reference's ``sync_params``, dist_util.py:79-85; the JAX package's
    replicated ``device_put``). Returns ``module``, changed in place."""
    if mesh.size > 1 and mesh.active:
        broadcast_flat([t.data for t in [*module.parameters(), *module.buffers()]], group=mesh.group)
    return module


def barrier() -> None:
    """Wait for every rank of the world (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()
