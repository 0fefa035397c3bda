"""The train step for triplane DDPMs.

The reference ships training scaffolding with no training script
(MixedPrecisionTrainer fp16_util.py:147-231, update_ema nn.py:54-64,
training_losses gaussian_diffusion.py:884-957; SURVEY.md §2.4); this is the
counterpart of the JAX package's ``train/trainer.py`` on one device: fp32
master parameters, the UNet's bf16 torso (weights cast per op, so no loss
scaling), gradient clipping by global norm and AdamW as optax computes
them, and an EMA after each applied update. The forward runs in train mode
(dropout) and, by default, under ``remat``.

Each step draws ``t``, the noise and the dropout masks from an explicit
``torch.Generator``; each can be injected instead, so a step can be
replayed against another implementation. A step whose loss is not finite
changes nothing: the check comes before the optimizer, which updates its
tensors in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn

from ishapediting_tpu_torch.config import UNetConfig
from ishapediting_tpu_torch.core.losses import training_losses, update_ema
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.models.unet import draw_dropout_masks


@dataclasses.dataclass
class TrainState:
    """``step``: applied updates; ``model``: the fp32 master parameters;
    ``ema_params``: their EMA, keyed as ``model.named_parameters()`` (the
    UNet has no buffers, so it is also a full state_dict); ``optimizer``
    holds the Adam moments."""

    step: int
    model: nn.Module
    ema_params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place, as ``optax.clip_by_global_norm``: ``g`` where the global norm
    is below ``max_norm``, else ``g / norm * max_norm`` (``clip_grad_norm_``
    divides by ``norm + 1e-6`` instead). Returns the norm before clipping;
    no host synchronisation."""
    grads = list(grads)
    norm = global_norm(grads)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, torch.tensor(max_norm, device=norm.device)))
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay=weight_decay))``: optax's betas and eps, and the weight
    decay given explicitly (torch's default is 1e-2, optax's 1e-4; the JAX
    trainer passes 0). ``grad_clip`` <= 0 turns clipping off."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedAdamW.step takes no closure: the gradients must exist before clipping")
        if self.grad_clip > 0:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip)
        return super().step()


def make_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-4, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> ClippedAdamW:
    return ClippedAdamW(params, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    model.requires_grad_(True)
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(step=0, model=model, ema_params=ema, optimizer=optimizer)


def make_train_step(
    cfg: UNetConfig,
    sched: Schedule,
    *,
    ema_rate: float = 0.9999,
    remat: bool = True,
) -> Callable[..., Dict[str, float]]:
    """Build the train step ``step(state, batch, generator=None, *, t=None,
    noise=None, dropout_masks=None) -> metrics``, which updates ``state`` in
    place. ``batch``: [B, H, W, C] normalized latents in [-1, 1] (a NumPy
    array or a tensor); ``t`` [B] respaced timesteps. Metrics are floats:
    the mean loss, mse and vb, and the gradient's global norm before
    clipping."""

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

        def model_fn(x, t_orig):
            return model(x, t_orig, train=True, dropout_masks=dropout_masks, remat=remat)

        state.optimizer.zero_grad(set_to_none=True)
        terms = training_losses(sched, model_fn, batch, t, noise=noise)
        loss = terms["loss"].mean()
        loss.backward()
        with torch.no_grad():
            metrics = {
                "loss": float(loss.detach()),
                "mse": float(terms["mse"].mean()),
                "vb": float(terms["vb"].mean()),
                "grad_norm": float(global_norm([p.grad for p in params if p.grad is not None])),
            }
        if math.isfinite(metrics["loss"]):
            state.optimizer.step()
            update_ema(state.ema_params.values(), params, ema_rate)
            state.step += 1
        return metrics

    return train_step
