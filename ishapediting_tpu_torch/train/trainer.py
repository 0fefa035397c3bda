"""The train step for triplane DDPMs.

The reference ships training scaffolding with no training script
(MixedPrecisionTrainer fp16_util.py:147-231, update_ema nn.py:54-64,
training_losses gaussian_diffusion.py:884-957; SURVEY.md §2.4); this is the
counterpart of the JAX package's ``train/trainer.py``: fp32 master
parameters, the UNet's bf16 torso (weights cast per op, so no loss
scaling), gradient clipping by global norm and AdamW as optax computes
them, and an EMA after each applied update. The forward runs in train mode
(dropout) and, by default, under ``remat``.

Each step draws ``t``, the noise and the dropout masks from an explicit
``torch.Generator``; each can be injected instead, so a step can be
replayed against another implementation. A step whose loss is not finite
changes nothing: the check comes before the optimizer, which updates its
tensors in place.

Over the ranks of a data axis (``mesh=``; the JAX step on a ``shard_batch``ed
batch with ``replicate``d parameters) every rank takes the global batch,
draws ``t``, the noise and the masks for all of it and keeps its rows; one
``all_reduce`` of a flat buffer sums the gradients and the loss terms, so
the metrics are the global batch's, the non-finite check skips the step on
every rank at once, and the parameters and the EMA stay bit-equal on every
rank.

A model cut over the model axis (``parallel/tensor.py::shard_params_tp``;
the JAX step on ``shard_params_tp``-cut parameters) trains its slices: the
gradient of each slice is exact through the cut layers' collectives, and
the ranks of one model group compute the same rows, so the gradient sum
stays over the data axis. The EMA and the Adam moments are kept per
slice (AdamW, weight decay and EMA are elementwise). Each rank of a model
group computes the whole parameters' gradients itself, and two processes
may round them differently (cuDNN times its algorithms in each), so the
model group takes its first rank's: the replicated parameters stay
bit-equal. The one global norm (``optax.global_norm`` of the whole
gradient) sums each cut slice's squares over the model group and adds
each whole parameter's once; it feeds the clip and the ``grad_norm``
metric. The non-finite check decides for the whole mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ishapediting_tpu_torch.config import UNetConfig
from ishapediting_tpu_torch.core.losses import training_losses, update_ema
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.models.unet import draw_dropout_masks
from ishapediting_tpu_torch.parallel.mesh import DataMesh, all_reduce_flat, broadcast_flat
from ishapediting_tpu_torch.parallel.tensor import ModelAxis, cut_dims, model_axis


@dataclasses.dataclass
class TrainState:
    """``step``: applied updates; ``model``: the fp32 master parameters;
    ``ema_params``: their EMA, keyed as ``model.named_parameters()`` (the
    UNet has no buffers, so it is also a full state_dict); ``optimizer``
    (a ``ClippedAdamW``) holds the Adam moments. ``axis`` (the model axis
    the model is cut over, None when uncut) and ``cut`` (per parameter, in
    ``named_parameters`` order, whether it is a slice) are read from the
    model once, here, not at every step."""

    step: int
    model: nn.Module
    ema_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    axis: Optional[ModelAxis] = dataclasses.field(init=False)
    cut: Tuple[bool, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        self.axis = model_axis(self.model)
        self.cut = tuple(d is not None for d in cut_dims(self.model).values())


@torch.no_grad()
def grad_square_norms(state: TrainState) -> torch.Tensor:
    """The squared norm of each parameter's gradient (``named_parameters``
    order; 0 where there is none), each cut slice's summed over the model
    axis in one ``all_reduce``: the whole gradient's, as one rank holding
    the whole model sees it. Every rank of the model axis calls it."""
    params = list(state.model.parameters())
    grads = [torch.zeros((), device=p.device) if p.grad is None else p.grad for p in params]
    squares = torch.stack(torch._foreach_norm(grads)).square()
    if state.axis is not None:
        cut = torch.tensor(state.cut, device=squares.device)
        part = torch.where(cut, squares, 0.0)
        dist.all_reduce(part, group=state.axis.group)
        squares = torch.where(cut, part, squares)
    return squares


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """In place, as ``optax.clip_by_global_norm``: ``g`` where the global
    ``norm`` (of the whole gradient, which on a cut model is more than
    ``grads``) is below ``max_norm``, else ``g / norm * max_norm``
    (``clip_grad_norm_`` divides by ``norm + 1e-6`` instead). No host
    synchronisation."""
    grads = list(grads)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, torch.tensor(max_norm, device=norm.device)))


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay=weight_decay))``: optax's betas and eps, and the weight
    decay given explicitly (torch's default is 1e-2, optax's 1e-4; the JAX
    trainer passes 0). ``grad_clip`` <= 0 turns clipping off. ``step(norm=)``
    clips by the global norm the train step computed (``grad_square_norms``):
    on a cut model one rank's gradients are only its slices, so the norm
    cannot come from them."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None, *, norm: torch.Tensor):
        if closure is not None:
            raise ValueError("ClippedAdamW.step takes no closure: the gradients must exist before clipping")
        if self.grad_clip > 0:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip, norm)
        return super().step()


def make_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-4, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> ClippedAdamW:
    return ClippedAdamW(params, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    """The state before the first step: the EMA starts at the parameters
    (a cut model's at its slices)."""
    model.requires_grad_(True)
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(step=0, model=model, ema_params=ema, optimizer=optimizer)


def make_train_step(
    cfg: UNetConfig,
    sched: Schedule,
    *,
    ema_rate: float = 0.9999,
    remat: bool = True,
    mesh: Optional[DataMesh] = None,
) -> Callable[..., Dict[str, float]]:
    """Build the train step ``step(state, batch, generator=None, *, t=None,
    noise=None, dropout_masks=None) -> metrics``, which updates ``state`` in
    place. ``batch``: [B, H, W, C] normalized latents in [-1, 1] (a NumPy
    array or a tensor); ``t`` [B] respaced timesteps. Metrics are floats:
    the mean loss, mse and vb, and the gradient's global norm before
    clipping. With a ``mesh`` of several ranks, ``batch`` and the injected
    draws are the global batch's (the same on every rank), and the model
    starts from ``replicate``d parameters, or from ``shard_params_tp``'s cut
    over the mesh's model axis."""
    sharded = mesh is not None and mesh.size > 1
    whole_mesh = mesh is not None and mesh.model > 1

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None) -> Dict[str, float]:
        model = state.model
        params = list(model.parameters())
        dev = params[0].device
        batch = torch.as_tensor(batch, dtype=torch.float32).to(dev)
        b = batch.shape[0]
        if t is None:
            t = torch.randint(0, sched.num_timesteps, (b,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(batch.shape, generator=generator, device=dev)
        if dropout_masks is None and cfg.dropout > 0:
            dropout_masks = draw_dropout_masks(cfg, b, generator)
        if sharded:
            rows = mesh.rows(b)
            batch = batch[rows]
            t = torch.as_tensor(t, device=dev)[rows]
            noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)[rows]
            if dropout_masks is not None:
                dropout_masks = [None if m is None else torch.as_tensor(m, device=dev)[rows]
                                 for m in dropout_masks]

        def model_fn(x, t_orig):
            return model(x, t_orig, train=True, dropout_masks=dropout_masks, remat=remat)

        state.optimizer.zero_grad(set_to_none=True)
        terms = training_losses(sched, model_fn, batch, t, noise=noise)
        if sharded:
            # this rank's share of the global mean; the all_reduce sums the shares
            (terms["loss"].sum() / b).backward()
            grads = [p.grad for p in params if p.grad is not None]
            sums = torch.stack([terms[k].detach().sum() for k in ("loss", "mse", "vb")])
            all_reduce_flat(grads + [sums], mesh)
            sums = sums / b
        else:
            terms["loss"].mean().backward()
            sums = torch.stack([terms[k].detach().mean() for k in ("loss", "mse", "vb")])
        if state.axis is not None:  # the model group's first rank's whole gradients (each rank keeps its loss)
            whole = [p.grad for p, c in zip(params, state.cut) if not c and p.grad is not None]
            broadcast_flat(whole, src=dist.get_global_rank(state.axis.group, 0), group=state.axis.group)
        with torch.no_grad():
            norm = grad_square_norms(state).sum().sqrt()
            finite = torch.isfinite(sums[0]).float()
            if whole_mesh:  # a rank whose loss is not finite stops every rank of the mesh
                finite = finite.reshape(1)
                dist.all_reduce(finite, op=dist.ReduceOp.MIN, group=mesh.mesh_group)
            values = torch.cat([sums, norm.reshape(1), finite.reshape(1)]).tolist()
        metrics = dict(zip(("loss", "mse", "vb", "grad_norm"), values))
        if values[-1] == 1.0:
            state.optimizer.step(norm=norm)
            update_ema(state.ema_params.values(), params, ema_rate)
            state.step += 1
        return metrics

    return train_step
