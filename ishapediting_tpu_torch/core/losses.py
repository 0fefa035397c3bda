"""Diffusion training losses (reference: losses.py:12-77,
gaussian_diffusion.py:849-1032), as the JAX package's ``core/losses.py``
computes them. Everything is fp32.

Randomness comes from an explicit ``torch.Generator``; ``training_losses``
also takes its noise directly (``noise=``) and ``calc_bpd_loop`` a list of
per-timestep noises (``noises=``, in loop order T-1 .. 0), so a run can be
replayed against another implementation.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ishapediting_tpu_torch.core.diffusion import (
    ModelFn,
    _randn,
    p_mean_variance,
    predict_eps_from_xstart,
    q_posterior_mean_variance,
    q_sample,
)
from ishapediting_tpu_torch.core.schedule import Schedule, extract, model_timesteps

_LN2 = math.log(2.0)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N1 || N2) in nats (reference: losses.py:12-39)."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + (mean1 - mean2).square() * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """(reference: losses.py:42-47)"""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of a discretized Gaussian on [-1,1] data quantized to
    255 bins (reference: losses.py:50-77)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta)
    )


def vb_terms_bpd(
    sched: Schedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    *,
    frozen_out: Optional[torch.Tensor] = None,
    clip_denoised: bool = False,
) -> Dict[str, torch.Tensor]:
    """Per-step variational-bound term in bits (reference:
    gaussian_diffusion.py:849-882). ``frozen_out`` stands in for the model's
    output (the model is not called)."""
    sched = sched.to(x_t.device)
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    fn = model_fn if frozen_out is None else (lambda x, t_orig: (frozen_out, None))
    out = p_mean_variance(sched, fn, x_t, t, clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean, out.log_variance)) / _LN2
    decoder_nll = -discretized_gaussian_log_likelihood(
        x_start, means=out.mean, log_scales=0.5 * out.log_variance
    )
    decoder_nll = mean_flat(decoder_nll) / _LN2
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out.pred_xstart}


def training_losses(
    sched: Schedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,
    t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    vb_weight_rescaled: bool = True,
) -> Dict[str, torch.Tensor]:
    """Hybrid eps-MSE + rescaled-VLB loss for LEARNED_RANGE models
    (reference: gaussian_diffusion.py:884-957, RESCALED_MSE branch). The
    noise is ``noise`` or drawn from ``generator``. Returns the per-example
    terms 'loss', 'mse', 'vb'."""
    sched = sched.to(x_start.device)
    if noise is None:
        noise = _randn(x_start, generator)
    x_t = q_sample(sched, x_start, t, noise)
    model_output, _ = model_fn(x_t, model_timesteps(sched, t))
    model_eps, model_var_values = model_output.float().chunk(2, dim=-1)
    # the variance is learned through the VLB with the mean frozen (detached eps)
    frozen = torch.cat([model_eps.detach(), model_var_values], dim=-1)
    vb = vb_terms_bpd(sched, model_fn, x_start, x_t, t, frozen_out=frozen)["output"]
    if vb_weight_rescaled:
        vb = vb * sched.num_timesteps / 1000.0
    mse = mean_flat((noise - model_eps).square())
    return {"loss": mse + vb, "mse": mse, "vb": vb}


def prior_bpd(sched: Schedule, x_start: torch.Tensor) -> torch.Tensor:
    """Prior KL term in bits/dim (reference: gaussian_diffusion.py:959-975)."""
    sched = sched.to(x_start.device)
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long, device=x_start.device)
    nd = x_start.ndim
    qt_mean = extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    qt_log_var = extract(sched.log_one_minus_alphas_cumprod, t, nd)
    zero = torch.zeros_like(qt_mean)
    return mean_flat(normal_kl(qt_mean, qt_log_var, zero, zero)) / _LN2


@torch.no_grad()
def calc_bpd_loop(
    sched: Schedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noises: Optional[Sequence[torch.Tensor]] = None,
    clip_denoised: bool = True,
) -> Dict[str, torch.Tensor]:
    """Full variational bound in bits/dim over every timestep, T-1 down to 0
    (reference: gaussian_diffusion.py:977-1032). Returns total_bpd,
    prior_bpd, and vb, xstart_mse, mse as [B, T] in loop order (column 0
    is t = T-1), as the reference and the JAX package stack them."""
    sched = sched.to(x_start.device)
    b, steps = x_start.shape[0], sched.num_timesteps
    if noises is not None and len(noises) != steps:
        raise ValueError(f"{len(noises)} noises for {steps} timesteps")
    vb, xstart_mse, mse = [], [], []
    for i, t in enumerate(range(steps - 1, -1, -1)):
        tb = torch.full((b,), t, dtype=torch.long, device=x_start.device)
        noise = _randn(x_start, generator) if noises is None else noises[i]
        x_t = q_sample(sched, x_start, tb, noise)
        out = vb_terms_bpd(sched, model_fn, x_start, x_t, tb, clip_denoised=clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start).square()))
        eps = predict_eps_from_xstart(sched, x_t, tb, out["pred_xstart"])
        mse.append(mean_flat((eps - noise).square()))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    pb = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb,
            "xstart_mse": xstart_mse, "mse": mse}


@torch.no_grad()
def update_ema(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               rate: float = 0.9999) -> None:
    """EMA of parameters in place: ``e = e * rate + p * (1 - rate)``
    (reference: nn.py:54-64)."""
    ema_params, params = list(ema_params), [p.detach() for p in params]
    torch._foreach_mul_(ema_params, rate)
    torch._foreach_add_(ema_params, params, alpha=1.0 - rate)
