"""Diffusion processes as functions on tensors plus Python step loops.

Covers the reference's GaussianDiffusion/SpacedDiffusion surface that the
generation path needs (reference: gaussian_diffusion.py:101-847,
respace.py:62-127). Carries stay fp32 even when the UNet torso runs bf16.

The model function contract everywhere is::

    model_fn(x_nhwc, t_original) -> (out [B,H,W,2C], feat or None)

with ``t_original`` already mapped through ``Schedule.timestep_map`` (done
here; callers pass respaced ``t``). Randomness comes from an explicit
``torch.Generator``; every stochastic step also accepts its noise directly
(``noise=``), and every loop a list of per-step noises (``noises=``, in loop
order), so a run can be replayed against another implementation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.core.schedule import Schedule, extract, model_timesteps
from ishapediting_tpu_torch.utils.trace import span

ModelFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _randn(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError("need a generator when no noise is given")
    return torch.randn(
        x.shape, generator=generator, device=x.device, dtype=torch.float32
    )


def _tb(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), int(t), dtype=torch.long, device=x.device)


# ---------------------------------------------------------------------------
# q process
# ---------------------------------------------------------------------------


def q_sample(sched: Schedule, x_start, t, noise):
    """Sample q(x_t | x_0) (reference: gaussian_diffusion.py:188-206)."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_posterior_mean_variance(sched: Schedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0) (reference: gaussian_diffusion.py:208-230)."""
    nd = x_t.ndim
    mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    var = extract(sched.posterior_variance, t, nd)
    log_var = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, var, log_var


def predict_xstart_from_eps(sched: Schedule, x_t, t, eps):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_eps_from_xstart(sched: Schedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


# ---------------------------------------------------------------------------
# p process (one step)
# ---------------------------------------------------------------------------


def xstart_model_adapter(base_sched: Schedule, model_fn: ModelFn) -> ModelFn:
    """Adapt an x0-prediction model to the epsilon contract every sampler
    here uses: eps = (sqrt(1/abar_t) x_t - x0) / sqrt(1/abar_t - 1).

    ``base_sched`` must be the full (non-respaced) schedule, so that its
    arrays are indexed by the original timesteps the model receives."""
    assert base_sched.num_timesteps == base_sched.original_num_steps, (
        "pass the full base schedule (timestep_respacing='')"
    )

    def fn(x, t_model):
        out, feat = model_fn(x, t_model)
        sched = base_sched.to(x.device)
        # invert model_timesteps' rescale before using t as an index
        if sched.rescale_timesteps:
            t_orig = torch.round(
                t_model * (sched.original_num_steps / 1000.0)
            ).long()
        else:
            t_orig = t_model.long()
        x0_pred, var_values = out.float().chunk(2, dim=-1)
        nd = x.ndim
        eps = (
            extract(sched.sqrt_recip_alphas_cumprod, t_orig, nd) * x.float()
            - x0_pred
        ) / extract(sched.sqrt_recipm1_alphas_cumprod, t_orig, nd)
        return torch.cat([eps, var_values], dim=-1), feat

    return fn


class PMeanVar(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor
    eps: torch.Tensor  # the model's epsilon prediction (mean half of output)
    feat: Optional[torch.Tensor]


def p_mean_variance(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    clip_denoised: bool = True,
    predict_xstart: bool = False,
) -> PMeanVar:
    """Model -> p(x_{t-1} | x_t) with LEARNED_RANGE variance interpolation
    (reference: gaussian_diffusion.py:232-331). ``t`` is respaced, [B].
    What follows the model call is the first of a step's two
    ``sampler_step`` spans; the sampler's update is the second."""
    sched = sched.to(x.device)
    nd = x.ndim
    model_output, feat = model_fn(x, model_timesteps(sched, t))
    with span("sampler_step"):
        model_output = model_output.float()
        c = x.shape[-1]
        assert model_output.shape[-1] == 2 * c, (model_output.shape, c)
        model_eps, model_var_values = model_output.chunk(2, dim=-1)

        min_log = extract(sched.posterior_log_variance_clipped, t, nd)
        max_log = extract(sched.log_betas, t, nd)
        frac = (model_var_values + 1.0) * 0.5
        model_log_variance = frac * max_log + (1.0 - frac) * min_log
        model_variance = torch.exp(model_log_variance)

        x32 = x.float()
        if predict_xstart:
            pred_xstart = model_eps
        else:
            pred_xstart = predict_xstart_from_eps(sched, x32, t, model_eps)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean, _, _ = q_posterior_mean_variance(sched, pred_xstart, x32, t)
        return PMeanVar(mean, model_variance, model_log_variance, pred_xstart, model_eps, feat)


def _nonzero_mask(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return (t != 0).float().reshape((-1,) + (1,) * (ndim - 1))


def p_sample(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
) -> Dict[str, torch.Tensor]:
    """Ancestral DDPM step (reference: gaussian_diffusion.py:400-444)."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised=clip_denoised)
    with span("sampler_step"):
        if noise is None:
            noise = _randn(x, generator)
        sample = out.mean + _nonzero_mask(t, x.ndim) * torch.exp(0.5 * out.log_variance) * noise
        return {"sample": sample, "pred_xstart": out.pred_xstart}


def p_sample_guidance(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    variance: Optional[torch.Tensor] = None,
    variance_noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
) -> Dict[str, Any]:
    """The editing step primitive (reference: gaussian_diffusion.py:446-510).

    Like ``p_sample`` but returns every quantity the editing engine consumes
    (inter_feat, variance, mean, noise) and accepts overrides: a fixed
    ``noise`` draw, a fixed ``variance`` (case-1 edit mode), or a fixed
    ``variance_noise`` (exact replay: sample = mean + variance_noise).
    """
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised=clip_denoised)
    with span("sampler_step"):
        result: Dict[str, Any] = {
            "mean": out.mean,
            "variance": out.variance,
            "pred_xstart": out.pred_xstart,
            "inter_feat": out.feat,
            "model_output": out.eps,
        }
        if variance_noise is not None:
            result["sample"] = out.mean + variance_noise
            return result
        if noise is None:
            noise = _randn(x, generator)
        var = out.variance if variance is None else variance
        result["noise"] = noise
        result["variance"] = var
        result["sample"] = out.mean + _nonzero_mask(t, x.ndim) * torch.sqrt(var) * noise
        return result


def ddim_sample(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    eta: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    clip_denoised: bool = True,
) -> Dict[str, Any]:
    """DDIM step (reference: gaussian_diffusion.py:654-705)."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised=clip_denoised)
    with span("sampler_step"):
        sched = sched.to(x.device)
        nd = x.ndim
        eps = predict_eps_from_xstart(sched, x.float(), t, out.pred_xstart)
        alpha_bar = extract(sched.alphas_cumprod, t, nd)
        alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = (
            out.pred_xstart * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps
        )
        if eta != 0.0:
            if noise is None:
                noise = _randn(x, generator)
            sample = mean_pred + _nonzero_mask(t, nd) * sigma * noise
        else:
            sample = mean_pred
        return {
            "sample": sample,
            "pred_xstart": out.pred_xstart,
            "inter_feat": out.feat,
            "model_output": out.eps,
        }


def ddim_reverse_sample(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    clip_denoised: bool = True,
) -> Dict[str, torch.Tensor]:
    """Deterministic DDIM reverse-ODE step x_t -> x_{t+1}
    (reference: gaussian_diffusion.py:718-761)."""
    out = p_mean_variance(sched, model_fn, x, t, clip_denoised=clip_denoised)
    sched = sched.to(x.device)
    nd = x.ndim
    eps = predict_eps_from_xstart(sched, x.float(), t, out.pred_xstart)
    alpha_bar_next = extract(sched.alphas_cumprod_next, t, nd)
    mean_pred = out.pred_xstart * torch.sqrt(alpha_bar_next) + torch.sqrt(1 - alpha_bar_next) * eps
    return {"sample": mean_pred, "pred_xstart": out.pred_xstart}


# ---------------------------------------------------------------------------
# Trajectory loops
# ---------------------------------------------------------------------------


def _step_noise(noises: Optional[Sequence[torch.Tensor]], i: int, x: torch.Tensor):
    if noises is None:
        return None
    return torch.as_tensor(noises[i], dtype=torch.float32, device=x.device)


def p_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noises: Optional[Sequence[torch.Tensor]] = None,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """Full ancestral sampling trajectory (reference: gaussian_diffusion.py:534-652).
    ``noises[i]`` is the noise of loop step i (t = T-1-i)."""
    x = x_T.float()
    for i, t in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        x = p_sample(
            sched, model_fn, x, _tb(x, t), generator,
            noise=_step_noise(noises, i, x), clip_denoised=clip_denoised,
        )["sample"]
    return x


def ddim_reverse_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    *,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """Deterministic DDIM encode x_0 -> x_T: ``ddim_reverse_sample`` at
    t = 0 .. T-2. Step t lifts the noise level abar[t] -> abar[t+1], ending
    at abar[T-1], the level ``ddim_sample_loop``'s first step consumes
    (t = T-1 would lift to ``alphas_cumprod_next[T-1] == 0`` and zero the
    signal term)."""
    x = x0.float()
    for t in range(sched.num_timesteps - 1):
        x = ddim_reverse_sample(sched, model_fn, x, _tb(x, t), clip_denoised=clip_denoised)["sample"]
    return x


def ddim_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    eta: float = 0.0,
    noises: Optional[Sequence[torch.Tensor]] = None,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """Full DDIM trajectory (reference: gaussian_diffusion.py:763-847)."""
    x = x_T.float()
    for i, t in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        x = ddim_sample(
            sched, model_fn, x, _tb(x, t), generator, eta=eta,
            noise=_step_noise(noises, i, x), clip_denoised=clip_denoised,
        )["sample"]
    return x


def _dpm_solver_tables(sched: Schedule):
    """Per-iteration DPM-Solver++(2M) coefficients, derived on the host in
    float64 from the respaced schedule's fp32 arrays.

    Iteration i steps the carry from respaced time ``t_i = T-1-i`` toward
    ``t_i - 1`` (final boundary: alpha_bar -> 1; the data-prediction form
    stays finite there: a=0, b=1). Returns numpy ``(ts, a, b, m)`` with
    ``x_next = a*x + b*D`` and ``D = (1+m)*x0(t_i) - m*x0(previous iteration)``.
    """
    acp = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
    acp_prev = sched.alphas_cumprod_prev.cpu().numpy().astype(np.float64)
    ts = np.arange(sched.num_timesteps - 1, -1, -1)
    cur, nxt = acp[ts], acp_prev[ts]
    # lambda = log(alpha/sigma); +inf at the acp=1 boundary, handled below
    with np.errstate(divide="ignore"):
        lam_cur = 0.5 * (np.log(cur) - np.log1p(-cur))
        lam_nxt = 0.5 * (np.log(nxt) - np.log1p(-nxt))
    h = lam_nxt - lam_cur  # per-step log-SNR increment; +inf on the last step
    a = np.sqrt((1.0 - nxt) / (1.0 - cur))  # sigma_next / sigma_cur
    b = -np.sqrt(nxt) * np.expm1(-h)  # alpha_next * (1 - e^{-h})
    h_prev = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(invalid="ignore"):
        m = h / (2.0 * h_prev)  # = 1/(2 r_i), r_i = h_{i-1}/h_i
    # Order matters: the first step has no history (m[0] = 0); the boundary
    # step's infinite weight is zeroed (lower-order final) BEFORE the cap at
    # the uniform-lambda value 0.5, which would otherwise turn inf into 0.5.
    m[0] = 0.0
    m[~np.isfinite(m)] = 0.0
    m = np.minimum(m, 0.5)
    return (
        ts.astype(np.int64),
        a.astype(np.float32),
        b.astype(np.float32),
        m.astype(np.float32),
    )


def dpm_solver_sample_loop(
    sched: Schedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    *,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """DPM-Solver++(2M) multistep sampler (Lu et al. 2022): deterministic,
    second order in the log-SNR step. The learned-variance half of the model
    output is ignored. Carries ``(x, prev_x0)`` in fp32."""
    ts, a, b, m = _dpm_solver_tables(sched)
    sched = sched.to(x_T.device)
    x = x_T.float()
    prev_x0 = torch.zeros_like(x)  # unused: m[0] = 0
    for t, a_i, b_i, m_i in zip(ts, a.tolist(), b.tolist(), m.tolist()):
        tb = _tb(x, t)
        out, _ = model_fn(x, model_timesteps(sched, tb))
        eps = out.float()[..., : x.shape[-1]]
        x0 = predict_xstart_from_eps(sched, x, tb, eps)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        d = (1.0 + m_i) * x0 - m_i * prev_x0
        x, prev_x0 = a_i * x + b_i * d, x0
    return x


def sample_loop_with_features(
    sched: Schedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    w_time: int,
    feat_postprocess: Callable[[torch.Tensor], torch.Tensor],
    noises: Optional[Sequence[torch.Tensor]] = None,
    clip_denoised: bool = True,
) -> Dict[str, torch.Tensor]:
    """Generation with guidance-feature caching (reference: drag_utils.py:252-280).

    Runs T-1..w_time without feature capture, snapshots ``w = x_{w_time}``,
    then runs w_time-1..0 capturing the post-processed intermediate feature
    at every step. Returns dict(sample, w, features[w_time, ...]).
    """
    x = x_T.float()
    w = x
    feats = []
    for i, t in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        if t == w_time - 1:
            w = x
        out = p_sample_guidance(
            sched, model_fn, x, _tb(x, t), generator,
            noise=_step_noise(noises, i, x), clip_denoised=clip_denoised,
        )
        if t < w_time:
            feats.append(feat_postprocess(out["inter_feat"]))
        x = out["sample"]
    return {"sample": x, "w": w, "features": torch.stack(feats)}


def ddpm_inversion(
    sched: Schedule,
    model_fn: ModelFn,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    steps: int,
    feat_postprocess: Callable[[torch.Tensor], torch.Tensor],
    clip_denoised: bool = True,
    chunk: int = 8,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Edit-friendly DDPM inversion (reference: gaussian_diffusion.py:512-532).

    Forward: the stochastic chain x_{t+1} = sqrt(abar_t/abar_{t-1}) x_t +
    sqrt(1 - .) noise_t, t = 0..steps-1, every state kept; ``noises[t]``
    replaces the draw of step t. Backward: the model mean at each x_{t+1},
    and ``variance_noise_t = x_t - mean_t``, so that replaying
    ``mean + variance_noise`` reproduces x_0 exactly. The backward model
    evaluations are independent of each other, so they run ``chunk`` steps
    per forward, as a batch of ``chunk * B`` (the last chunk padded with
    copies of the last step).

    Returns, ordered like the reference's lists (index k <-> t = steps-1-k):
    ``latent`` x_steps [B, ...]; ``features`` [steps, B, ...];
    ``variances`` and ``variance_noise`` [steps, B, ...]; ``sample`` x_0."""
    nd = x0.ndim
    b = x0.shape[0]
    sched = sched.to(x0.device)
    x = x0.float()
    x_inter = [x]
    for t in range(steps):
        tb = _tb(x, t)
        cof = extract(sched.alphas_cumprod, tb, nd) / extract(sched.alphas_cumprod_prev, tb, nd)
        noise = _step_noise(noises, t, x)
        if noise is None:
            noise = _randn(x, generator)
        x = torch.sqrt(cof) * x + torch.sqrt(1.0 - cof) * noise
        x_inter.append(x)

    xin = torch.stack(x_inter[1:])  # [steps, B, ...] = x_{t+1}, t ascending
    ts = list(range(steps))
    pad = (-steps) % chunk
    if pad:
        xin = torch.cat([xin, xin[-1:].expand(pad, *xin.shape[1:])])
        ts += [steps - 1] * pad
    means, variances, feats = [], [], []
    for c0 in range(0, len(ts), chunk):
        xc = xin[c0 : c0 + chunk]
        tf = torch.tensor(ts[c0 : c0 + chunk], dtype=torch.long, device=x0.device).repeat_interleave(b)
        out = p_mean_variance(sched, model_fn, xc.reshape((-1,) + xc.shape[2:]), tf,
                              clip_denoised=clip_denoised)
        f = feat_postprocess(out.feat)
        means.append(out.mean.reshape(xc.shape))
        variances.append(out.variance.reshape(xc.shape))
        feats.append(f.reshape((xc.shape[0], b) + f.shape[1:]))
    means = torch.cat(means)[:steps]
    variances = torch.cat(variances)[:steps]
    feats = torch.cat(feats)[:steps]
    variance_noise = torch.stack(x_inter[:steps]) - means
    return {
        "latent": x_inter[steps],
        "features": feats.flip(0),
        "variances": variances.flip(0),
        "variance_noise": variance_noise.flip(0),
        "sample": x_inter[0],
    }


def sample_partial(
    sched: Schedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    t_start: int,
    t_stop: int = 0,
    use_ddim: bool = False,
    eta: float = 0.0,
    clip_denoised: bool = True,
    capture_features: bool = False,
    feat_postprocess: Callable[[torch.Tensor], torch.Tensor] = lambda f: f,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Partial trajectory t_start-1 .. t_stop (DDIM, or the guidance step
    without guidance), optionally capturing every step's post-processed
    feature (the reference's ``synthesize_latent``, drag_utils.py:61-131).
    ``noises[i]`` replaces the draw of loop step i. Returns dict(sample,
    pred_xstart [steps, ...], features [steps, ...] if captured)."""
    x = x.float()
    feats, pred_x0 = [], []
    for i, t in enumerate(range(t_start - 1, t_stop - 1, -1)):
        kw = dict(noise=_step_noise(noises, i, x), clip_denoised=clip_denoised)
        if use_ddim:
            out = ddim_sample(sched, model_fn, x, _tb(x, t), generator, eta=eta, **kw)
        else:
            out = p_sample_guidance(sched, model_fn, x, _tb(x, t), generator, **kw)
        if capture_features:
            feats.append(feat_postprocess(out["inter_feat"]))
        pred_x0.append(out["pred_xstart"])
        x = out["sample"]
    result = {"sample": x, "pred_xstart": torch.stack(pred_x0)}
    if capture_features:
        result["features"] = torch.stack(feats)
    return result


def p_sample_loop_snapshots(
    sched: Schedule,
    model_fn: ModelFn,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    snapshot_steps: Sequence[int],
    use_ddim: bool = False,
    clip_denoised: bool = True,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """A whole sampling trajectory that also keeps the post-step sample at
    the given loop indices (0 = the first step from pure noise; the
    reference's ``save_intermediate``, gaussian_diffusion.py:545-601,
    image_sample.py:70-102). DDIM runs at eta 0. Returns dict(sample,
    snapshots [K, B, ...]) in the order of ``snapshot_steps``."""
    snapshot_steps = tuple(int(s) for s in snapshot_steps)
    num = sched.num_timesteps
    if not all(0 <= s < num for s in snapshot_steps):
        raise ValueError(f"snapshot_steps must be loop indices in [0, {num}); got {snapshot_steps}")
    kept = {}
    x = x_T.float()
    for i, t in enumerate(range(num - 1, -1, -1)):
        kw = dict(noise=_step_noise(noises, i, x), clip_denoised=clip_denoised)
        if use_ddim:
            x = ddim_sample(sched, model_fn, x, _tb(x, t), generator, **kw)["sample"]
        else:
            x = p_sample(sched, model_fn, x, _tb(x, t), generator, **kw)["sample"]
        if i in snapshot_steps:
            kept[i] = x
    if snapshot_steps:
        snaps = torch.stack([kept[s] for s in snapshot_steps])
    else:
        snaps = x.new_zeros((0,) + x.shape)
    return {"sample": x, "snapshots": snaps}


def guided_sample_loop(
    sched: Schedule,
    x_T: torch.Tensor,
    *,
    guidance_fn: Callable[[torch.Tensor, torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    t_start: Optional[int] = None,
) -> torch.Tensor:
    """Classifier-guided sampling loop (reference: drag_utils.py:443-463):
    ``x_{t-1} = sample + variance * grad`` for t = t_start-1 .. 0.

    ``guidance_fn(x, t_batch, i) -> (grad, sample, variance)`` runs one
    sampling step (``i`` is the loop index, for per-step noise), differentiates
    through the model itself and returns the already-scaled gradient."""
    t_start = sched.num_timesteps if t_start is None else t_start
    x = x_T.float()
    for i, t in enumerate(range(t_start - 1, -1, -1)):
        grad, sample, variance = guidance_fn(x, _tb(x, t), i)
        x = sample + variance * grad
    return x
