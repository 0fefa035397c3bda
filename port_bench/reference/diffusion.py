"""Plain diffusion arithmetic of guided-diffusion (``gaussian_diffusion.py``,
``respace.py``) as iShapEditing drives it: the linear beta schedule,
respacing, learned-range variance, the DDIM step, the guided ancestral step
of a drag edit, the forward chain of the edit-friendly inversion and the
window-respaced schedule of fast editing. Coefficients in float64 NumPy,
held as fp32 tensors; the model is called with original-chain steps.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch


def linear_betas(steps: int) -> np.ndarray:
    scale = 1000 / steps
    return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """guided-diffusion ``respace.space_timesteps`` (MIT licence)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start, steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            steps.append(start + round(cur))
            cur += stride
        start += size
    return set(steps)


class Sched:
    """A respaced chain's fp32 coefficients on ``device``; ``tmap[t]`` is the
    original step of respaced step ``t``."""

    def __init__(self, base_betas: np.ndarray, keep: Iterable[int], device):
        acp_base = np.cumprod(1.0 - base_betas)
        keep = set(int(k) for k in keep)
        last, betas, tmap = 1.0, [], []
        for i, a in enumerate(acp_base):
            if i in keep:
                betas.append(1 - a / last)
                last = a
                tmap.append(i)
        b = np.array(betas, np.float64)
        acp = np.cumprod(1.0 - b)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = b * (1.0 - acp_prev) / (1.0 - acp)
        f32 = lambda v: torch.tensor(np.asarray(v, np.float64).astype(np.float32), device=device)  # noqa: E731
        self.n = len(b)
        self.tmap = torch.tensor(tmap, dtype=torch.long, device=device)
        self.log_betas = f32(np.log(b))
        self.acp, self.acp_prev = f32(acp), f32(acp_prev)
        self.sqrt_recip_acp = f32(np.sqrt(1.0 / acp))
        self.sqrt_recipm1_acp = f32(np.sqrt(1.0 / acp - 1))
        self.post_log_var = f32(np.log(np.append(post_var[1], post_var[1:])))
        self.coef1 = f32(b * np.sqrt(acp_prev) / (1.0 - acp))
        self.coef2 = f32((1.0 - acp_prev) * np.sqrt(1.0 - b) / (1.0 - acp))


def respaced(base_steps: int, respacing: str, device) -> Sched:
    betas = linear_betas(base_steps)
    if respacing in ("", str(base_steps)):
        return Sched(betas, range(base_steps), device)
    return Sched(betas, space_timesteps(base_steps, respacing), device)


def fast_edit(sched: Sched, base_steps: int, w_time: int, count: int, device) -> Tuple[Sched, np.ndarray]:
    """The first ``w_time`` positions of ``sched`` respaced to ``count``,
    the later ones kept: (schedule, kept positions ascending)."""
    positions = np.array(sorted(space_timesteps(w_time, [count])), np.int64)
    tmap = sched.tmap.cpu().numpy()
    keep = {int(tmap[p]) for p in positions} | {int(t) for t in tmap[w_time:]}
    return Sched(linear_betas(base_steps), keep, device), positions


def _at(v: torch.Tensor, t: int) -> torch.Tensor:
    return v[t]


def p_mean_variance(s: Sched, model: Callable, x: torch.Tensor, t: int):
    """(mean, variance, pred_xstart, feature) at respaced step ``t`` with the
    learned-range variance and the prediction clipped to [-1, 1]."""
    out, feat = model(x, s.tmap[t].expand(x.shape[0]))
    eps, v = out.float().chunk(2, dim=1)
    frac = (v + 1.0) * 0.5
    log_var = frac * _at(s.log_betas, t) + (1.0 - frac) * _at(s.post_log_var, t)
    x0 = (_at(s.sqrt_recip_acp, t) * x - _at(s.sqrt_recipm1_acp, t) * eps).clamp(-1.0, 1.0)
    mean = _at(s.coef1, t) * x0 + _at(s.coef2, t) * x
    return mean, torch.exp(log_var), x0, feat


def ddim_step(s: Sched, model: Callable, x: torch.Tensor, t: int) -> torch.Tensor:
    """Deterministic DDIM (eta 0)."""
    _, _, x0, _ = p_mean_variance(s, model, x, t)
    eps = (_at(s.sqrt_recip_acp, t) * x - x0) / _at(s.sqrt_recipm1_acp, t)
    a_prev = _at(s.acp_prev, t)
    return x0 * torch.sqrt(a_prev) + torch.sqrt(1 - a_prev) * eps


def ddim_sample(s: Sched, model: Callable, x_T: torch.Tensor) -> torch.Tensor:
    x = x_T.float()
    for t in range(s.n - 1, -1, -1):
        x = ddim_step(s, model, x, t)
    return x


def inversion_chain(s: Sched, x0: torch.Tensor, noises: Callable[[int], torch.Tensor], steps: int):
    """The forward chain of the edit-friendly DDPM inversion: x_{t+1} =
    sqrt(c) x_t + sqrt(1 - c) noise_t with c = acp_t / acp_prev_t, every
    state kept ([x_0 .. x_steps])."""
    xs = [x0.float()]
    for t in range(steps):
        c = _at(s.acp, t) / _at(s.acp_prev, t)
        xs.append(torch.sqrt(c) * xs[-1] + torch.sqrt(1.0 - c) * noises(t))
    return xs


def guided_step(s: Sched, model: Callable, x: torch.Tensor, t: int, noise: torch.Tensor,
                loss_fn: Callable[[torch.Tensor], torch.Tensor], scale) -> Dict[str, torch.Tensor]:
    """One drag step: an ancestral step with fresh ``noise``, plus
    ``variance * scale * d loss / d x`` (the loss of the tapped feature)."""
    im = x.detach().float().requires_grad_(True)
    with torch.enable_grad():
        mean, var, _, feat = p_mean_variance(s, model, im, t)
        loss = loss_fn(feat)
    (grad,) = torch.autograd.grad(loss, im)
    nonzero = 1.0 if t != 0 else 0.0
    sample = mean.detach() + nonzero * torch.sqrt(var.detach()) * noise
    return {"next": sample + var.detach() * (scale * grad), "unguided": sample}
