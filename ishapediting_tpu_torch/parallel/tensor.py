"""The ``model`` axis: tensor parallelism of the UNet's widest layers (the
JAX package's ``shard_params_tp``, ``ishapediting_tpu/parallel/mesh.py``).

JAX's policy (``_tp_spec``) cuts a dense layer, an embedding table (a
class-conditional UNet's ``label_emb``) or a convolution along its output
features when it has 256 or more, and leaves everything else whole; GSPMD
then inserts the collectives. Here each rank of a model axis keeps
its slice of every cut layer's weight and bias (``shard_params_tp``), and
the UNet's forward (``models/unet.py::dense``) computes a cut layer in
three steps:

(a) ``copy_to_model``: the identity forward; the backward all-reduces the
    input's gradient over the model axis, since each rank's slice of the
    output reaches the input only through its own weights;
(b) the product with this rank's weight and bias slice;
(c) ``gather_from_model``: all-gathers the slices and concatenates them on
    the channel axis (the last: activations are NHWC); the backward takes
    this rank's slice of the output's gradient.

Everything between two cut layers (GroupNorm-SiLU, attention, the uncut
layers) then runs on whole activations, the same on every rank of the axis,
so the Hopper kernels launch as often per forward as on one rank. The
collectives are list-form ``all_gather`` and ``all_reduce``, which gloo
implements for CUDA tensors (``torch.distributed.nn.functional``'s backward
uses others). The slices travel as their bytes (``uint8``, which gloo
takes where it refuses ``int16``), so a gather is exact in every dtype.

Training a cut model (``train/trainer.py``) keeps each rank's slices in the
EMA and the Adam moments; ``cut_dims`` names each parameter's cut axis, and
``gather_named`` / ``slice_named`` turn any tensors keyed and shaped like
the parameters (EMA, moments, a checkpoint's whole tensors) into whole
tensors or this rank's slices, as a checkpoint holds and loads them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ishapediting_tpu_torch.parallel.mesh import DataMesh, broadcast_flat, replicate

# JAX's ``_tp_spec``: a layer with this many output features or more is cut
MIN_CUT_FEATURES = 256

# gathers made by cut layers' forwards since the last reset: count, bytes
# of the gathered outputs, and seconds, which only a gloo group's gathers
# add (they return when the data has arrived; nccl's return once enqueued)
GATHERS: Dict[str, float] = {"calls": 0, "bytes": 0, "s": 0.0}


def reset_gather_counts() -> None:
    GATHERS.update(calls=0, bytes=0, s=0.0)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A cut layer's place on the model axis: the axis's ``group``, its
    ``size`` and this rank's ``index`` (which slice it holds)."""

    group: dist.ProcessGroup
    size: int
    index: int


def _out_features(mod: nn.Module) -> int:
    """Output features of a dense layer (``nn.Linear``; the attention
    blocks' 1x1 ``nn.Conv1d``, a dense ``(in, out)`` in the JAX tree), an
    embedding table (``(num, dim)`` in both trees) or a convolution; 0 for
    any other module."""
    if isinstance(mod, nn.Linear):
        return mod.out_features
    if isinstance(mod, nn.Embedding):
        return mod.embedding_dim
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
        return mod.out_channels
    return 0


def _cut_dim(mod: nn.Module) -> int:
    """The weight's axis of output features: 1 for an embedding table, 0
    for the torch layout of a dense layer or a convolution."""
    return 1 if isinstance(mod, nn.Embedding) else 0


def cut_layers(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """The (name, module) of every layer the policy cuts, in module order."""
    return [(n, m) for n, m in model.named_modules() if _out_features(m) >= MIN_CUT_FEATURES]


def is_cut(model: nn.Module) -> bool:
    """Whether ``shard_params_tp`` cut any layer of ``model``."""
    return model_axis(model) is not None


def model_axis(model: nn.Module) -> Optional[ModelAxis]:
    """The model axis ``model``'s cut layers lie on (None when uncut)."""
    return next((m.model_axis for m in model.modules() if getattr(m, "model_axis", None) is not None), None)


def cut_dims(model: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's cut axis, by ``named_parameters`` name: 0 for a cut
    dense or conv weight and every cut bias, 1 for a cut embedding table,
    None for a parameter held whole."""
    out: Dict[str, Optional[int]] = {}
    for prefix, mod in model.named_modules():
        cut = getattr(mod, "model_axis", None) is not None
        for key, _ in mod.named_parameters(recurse=False):
            out[f"{prefix}.{key}" if prefix else key] = (_cut_dim(mod) if key == "weight" else 0) if cut else None
    return out


def gather_cut(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's slice along ``dim``:
    the ranks' slices concatenated in rank order. Every rank of the axis
    calls it; the bytes travel, so it is exact in every dtype."""
    front = t.detach().movedim(dim, 0).contiguous()
    bits = front.reshape(front.shape[0], -1).view(torch.uint8) if front.dim() > 1 else front.view(torch.uint8)
    parts = [torch.empty_like(bits) for _ in range(axis.size)]
    dist.all_gather(parts, bits, group=axis.group)
    whole = torch.cat(parts).view(t.dtype)
    return whole.reshape((-1,) + front.shape[1:]).movedim(0, dim)


def slice_cut(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` along ``dim`` (a copy)."""
    per = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * per, per).clone()


def gather_named(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` keyed by ``model``'s parameter names (parameters, their
    EMA or Adam moments), each cut one gathered whole over the model axis;
    the others as they are. Every rank of the axis calls it."""
    dims, axis = cut_dims(model), model_axis(model)
    return {k: v if dims.get(k) is None else gather_cut(v, dims[k], axis) for k, v in tensors.items()}


def slice_named(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``gather_named``: whole tensors keyed by ``model``'s
    parameter names, each cut one narrowed to this rank's slice."""
    dims, axis = cut_dims(model), model_axis(model)
    return {k: v if dims.get(k) is None else slice_cut(v, dims[k], axis) for k, v in tensors.items()}


@torch.no_grad()
def shard_params_tp(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """Place ``model``'s parameters on ``mesh.device`` with the
    tensor-parallel policy over the model axis; returns ``model``, changed
    in place. Each cut layer keeps only this rank's slice of its weight and
    bias along the output features (torch dim 0; dim 1 of an embedding
    table), so a model built on the
    CPU moves only its slices to the card; every other parameter goes
    whole. The uncut parameters are rank 0's on every rank of the mesh and
    each slice its data axis's first rank's (``replicate``'s rule): the
    ranks of one data index must hold the same weights (one seed or one
    checkpoint), since each keeps only its slice. At one rank on the model
    axis it is ``replicate``."""
    if mesh.model == 1:
        return replicate(model.to(mesh.device), mesh)
    if not mesh.active:
        raise ValueError(f"rank {mesh.rank} is not on the mesh of {mesh.n_ranks} ranks")
    layers = cut_layers(model)
    for name, mod in layers:
        if _out_features(mod) % mesh.model:
            raise ValueError(f"layer {name}: {_out_features(mod)} output features not divisible by "
                             f"model_parallel={mesh.model}")
    axis = ModelAxis(mesh.model_group, mesh.model, mesh.model_index)
    slices = []
    for _, mod in layers:
        per = _out_features(mod) // mesh.model
        for key in ("weight", "bias"):
            p = getattr(mod, key, None)
            if p is not None:
                dim = _cut_dim(mod) if key == "weight" else 0
                part = p.narrow(dim, axis.index * per, per).to(mesh.device, copy=True)
                setattr(mod, key, nn.Parameter(part, requires_grad=p.requires_grad))
                slices.append(getattr(mod, key))
        mod.model_axis = axis
    model.to(mesh.device)
    cut = {id(t) for t in slices}
    whole = [t.data for t in [*model.parameters(), *model.buffers()] if id(t) not in cut]
    broadcast_flat(whole, group=mesh.mesh_group)
    if mesh.size > 1:  # each slice from the first rank of its data axis, which holds the same index
        broadcast_flat([t.data for t in slices], src=mesh.model_index, group=mesh.group)
    return model


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: ModelAxis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # the partial gradients of the ranks' slices, summed in fp32
        total = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.axis.group)
        return total.to(grad.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis: ModelAxis):
        ctx.axis, ctx.width = axis, y.shape[-1]
        t0 = time.perf_counter()
        bits = y.contiguous().view(torch.uint8)  # each element's bytes stay together on the last axis
        parts = [torch.empty_like(bits) for _ in range(axis.size)]
        dist.all_gather(parts, bits, group=axis.group)
        out = torch.cat(parts, dim=-1).view(y.dtype)
        GATHERS["calls"] += 1
        GATHERS["bytes"] += out.numel() * out.element_size()
        if dist.get_backend(axis.group) == "gloo":
            GATHERS["s"] += time.perf_counter() - t0
        return out

    @staticmethod
    def backward(ctx, grad):
        i, w = ctx.axis.index, ctx.width
        return grad[..., i * w : (i + 1) * w].contiguous(), None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """(a): ``x`` as it is; its gradient summed over the model axis."""
    return _CopyToModel.apply(x, axis)


def gather_from_model(y: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """(c): the ranks' slices of the last axis, concatenated in rank order;
    the gradient of this rank's slice is its part of the whole's."""
    return _GatherFromModel.apply(y, axis)
