"""Ranks on a (data, model) mesh: the counterpart of the JAX package's
device mesh (``ishapediting_tpu/parallel/mesh.py``).

The reference's only parallelism is data-parallel sampling with one process
per GPU over ``torch.distributed`` (dist_util.py:21-85,
image_sample.py:104-132). The JAX package drives every device from one
process through a ``Mesh``; the port follows the reference: one process per
rank, launched with ``torchrun`` (``python -m torch.distributed.run``), and a
``DataMesh`` that names this rank's place on the mesh. The ranks are laid
out row-major over ``data`` x ``model``, as the JAX package reshapes its
devices: rank r sits at data index r // model and model index r % model.
Independent trajectories are this workload's scaling axis: each data index
holds its own rows of a batch (``shard_batch``) and ``gather`` concatenates
them again, the fetch of a ``P("data")`` array, which the ``model`` axis
replicates. The ``model`` axis cuts the UNet's widest layers
(``parallel/tensor.py::shard_params_tp``); with ``model_parallel=1`` every
rank holds the whole model (``replicate``).

The collectives are only ``all_reduce``, ``broadcast`` and ``all_gather``
in its list form: the ones gloo implements for CUDA tensors, so ranks that
share one card can run over gloo (NCCL refuses two ranks on one device).
The backend is explicit: ``nccl`` for ranks on CUDA devices, ``gloo`` on the
CPU, as the reference's ``setup_dist`` chooses; ranks sharing a card pass
``gloo``. Without a launcher environment nothing here starts a process group:
``make_mesh()`` is one rank and every helper is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

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
    """This rank's place on a ``data`` x ``model`` mesh of ranks 0 ..
    size * model - 1, row-major (ranks past it sit idle). ``rank``: this
    process's rank; ``size``: the ranks on the ``data`` axis; ``device``:
    this rank's device; ``group``: the process group over this rank's
    ``data`` axis (the ranks of its model index; None for one rank);
    ``model``: the ranks on the ``model`` axis; ``model_group``: over this
    rank's ``model`` axis (the ranks of its data index); ``mesh_group``:
    over every rank of the mesh."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    model: int = 1
    model_group: Optional[dist.ProcessGroup] = None
    mesh_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        """Ranks per axis, as the JAX package's ``mesh.shape``."""
        return {"data": self.size, "model": self.model}

    @property
    def n_ranks(self) -> int:
        return self.size * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def active(self) -> bool:
        return self.rank < self.n_ranks

    def _slice(self, n: int, parts: int, index: int, what: str) -> slice:
        if n % parts:
            raise ValueError(f"batch {n} not divisible by {what} of {parts} ranks")
        if not self.active:
            raise ValueError(f"rank {self.rank} is not on the data axis of {self.size} ranks")
        per = n // parts
        return slice(index * per, (index + 1) * per)

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` split over the data
        axis (the ranks of one data index share them)."""
        return self._slice(n, self.size, self.data_index, "the data axis")

    def mesh_rows(self, n: int) -> slice:
        """This rank's rows of ``n`` split over every rank of the mesh in
        row-major order (the JAX package's ``P(("data", "model"))``)."""
        return self._slice(n, self.n_ranks, self.rank, "the mesh")


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
    _GROUPS["timeout"] = kwargs["timeout"]
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for CUDA
    (``LOCAL_RANK`` 0 without a launcher), or the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return dev


# The groups ``make_mesh`` made in this process group world, by their ranks:
# ``dist.new_group`` is collective, so a long-lived process (a server that
# plans a mesh per request) makes each group once and reuses it.
_GROUPS: Dict = {}


def _group(ranks: Sequence[int]) -> Optional[dist.ProcessGroup]:
    """The process group over ``ranks``: None for one rank, the world's for
    all of them, else one made by ``dist.new_group`` the first time. Every
    rank of the world calls it for the same ranks in the same order."""
    ranks = tuple(ranks)
    if len(ranks) == 1:
        return None
    world_group = dist.group.WORLD
    if len(ranks) == dist.get_world_size():
        return world_group
    if _GROUPS.get("world") is not world_group:  # a new process group world
        timeout = _GROUPS.get("timeout", DEFAULT_TIMEOUT)
        _GROUPS.clear()
        _GROUPS.update(world=world_group, timeout=timeout)
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks), timeout=_GROUPS["timeout"])
    return _GROUPS[ranks]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              device: Union[str, torch.device, None] = None) -> DataMesh:
    """A ``data`` x ``model`` mesh of ranks 0 .. ``n_devices``-1 (default:
    every rank), ``model_parallel`` ranks on the model axis, laid out
    row-major. Every rank of the world must call it, in the same order: it
    makes the process group of every row and every column, collectively
    (once per process; later meshes over the same ranks reuse them)."""
    n_world, rank = world()
    n = n_world if n_devices is None else int(n_devices)
    m = int(model_parallel)
    if not 1 <= n <= n_world:
        raise ValueError(f"a mesh of {n} ranks in a world of {n_world}")
    if m < 1 or n % m:
        raise ValueError(f"{n} devices not divisible by model_parallel={m}")
    d = n // m
    columns = [_group(range(j, n, m)) for j in range(m)]  # the data axis of each model index
    rows = [_group(range(i * m, (i + 1) * m)) for i in range(d)]  # the model axis of each data index
    whole = _group(range(n))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank >= n:
        return DataMesh(rank=rank, size=d, device=dev, model=m)
    return DataMesh(rank=rank, size=d, device=dev, group=columns[rank % m], model=m,
                    model_group=rows[rank // m], mesh_group=whole)


def shard_batch(x, mesh: DataMesh):
    """This rank's rows of the leading (batch / trajectory) axis."""
    return x[mesh.rows(x.shape[0])]


def _all_gather(x: torch.Tensor, parts: int, group, mesh: DataMesh) -> torch.Tensor:
    if parts == 1:
        return x
    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is not on the mesh of {mesh.n_ranks} ranks")
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(out, x, group=group)
    return torch.cat(out)


def gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every data index's rows of ``x`` concatenated in order, on every rank
    of the mesh (each rank gives the same shape)."""
    return _all_gather(x, mesh.size, mesh.group, mesh)


def gather_mesh(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated in row-major rank order (the
    fetch of a ``P(("data", "model"))`` array), on every rank of the mesh."""
    return _all_gather(x, mesh.n_ranks, mesh.mesh_group, mesh)


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
    """Every rank of the mesh takes rank 0's parameters and buffers (the
    reference's ``sync_params``, dist_util.py:79-85; the JAX package's
    replicated ``device_put``). Returns ``module``, changed in place."""
    if mesh.n_ranks > 1 and mesh.active:
        broadcast_flat([t.data for t in [*module.parameters(), *module.buffers()]], group=mesh.mesh_group)
    return module


def barrier() -> None:
    """Wait for every rank of the world (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()
