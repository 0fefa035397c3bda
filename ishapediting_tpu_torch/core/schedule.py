"""Noise schedules and timestep respacing, derived on the host in float64.

Every per-step coefficient is computed once in NumPy float64 (reference:
gaussian_diffusion.py:133-169), cast to fp32 and held as a torch tensor;
the samplers index them with a [B] timestep tensor on the data's device.
Respacing follows SpacedDiffusion (reference: respace.py:6-112): the model is
always called with the *original* timestep index (respace.py:115-127).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch


def named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """Beta schedule library (reference: gaussian_diffusion.py:18-42)."""
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_steps, dtype=np.float64
        )
    if name == "cosine":
        return betas_for_alpha_bar(
            num_steps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {name}")


def betas_for_alpha_bar(num_steps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize an alpha-bar function (reference: gaussian_diffusion.py:45-62)."""
    betas = []
    for i in range(num_steps):
        t1 = i / num_steps
        t2 = (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]):
    """Select the subset of original steps to keep (reference: respace.py:6-59).

    Kept verbatim from OpenAI's MIT-licensed guided-diffusion ``respace.py``:
    converted checkpoints reproduce reference trajectories only if the kept
    step set matches exactly.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        if section_counts == "":
            section_counts = [num_timesteps]
        else:
            section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1.0
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(section_count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken
        start_idx += size
    return set(all_steps)


def lambda_uniform_timesteps(alphas_cumprod: np.ndarray, count: int):
    """log-SNR-uniform kept-step selection (the ``"dpmN"`` respacing):
    a uniform grid in ``lambda = 0.5*(log acp - log(1-acp))`` between the
    chain ends, snapped to the nearest original indices. Both endpoints are
    kept; duplicate snaps collapse."""
    if count < 2:
        raise ValueError("lambda-uniform respacing needs count >= 2")
    acp = np.asarray(alphas_cumprod, np.float64)
    lam = 0.5 * (np.log(acp) - np.log1p(-acp))
    n = len(acp)
    targets = np.linspace(lam[n - 1], lam[0], count)
    idx = np.abs(lam[None, :] - targets[:, None]).argmin(axis=1)
    return set(idx.tolist()) | {0, n - 1}


_COEF_FIELDS = (
    "timestep_map",
    "betas",
    "log_betas",
    "alphas_cumprod",
    "alphas_cumprod_prev",
    "alphas_cumprod_next",
    "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod",
    "posterior_variance",
    "posterior_log_variance_clipped",
    "posterior_mean_coef1",
    "posterior_mean_coef2",
)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """All respaced per-step diffusion coefficients as fp32 tensors.

    Index ``t`` runs over the *respaced* chain, 0..T-1; ``timestep_map[t]``
    (int64) is the original-chain index the model is called with.
    """

    num_timesteps: int
    original_num_steps: int
    rescale_timesteps: bool
    timestep_map: torch.Tensor
    betas: torch.Tensor
    log_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def to(self, device) -> "Schedule":
        """The same schedule with every coefficient tensor on ``device``."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _COEF_FIELDS}
        )


def _schedule_from_betas(
    betas: np.ndarray,
    timestep_map: np.ndarray,
    original_num_steps: int,
    rescale_timesteps: bool = False,
) -> Schedule:
    """Derive every coefficient array in float64, then cast to fp32
    (reference math: gaussian_diffusion.py:133-169)."""
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )

    def f32(x):
        return torch.from_numpy(np.asarray(x).astype(np.float32))

    return Schedule(
        num_timesteps=int(betas.shape[0]),
        original_num_steps=int(original_num_steps),
        rescale_timesteps=bool(rescale_timesteps),
        timestep_map=torch.from_numpy(np.asarray(timestep_map, dtype=np.int64)),
        betas=f32(betas),
        log_betas=f32(np.log(betas)),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
    )


def make_schedule(
    base_steps: int = 1000,
    noise_schedule: str = "linear",
    timestep_respacing: str = "",
    rescale_timesteps: bool = False,
) -> Schedule:
    """Build a (possibly respaced) schedule. Respacing recomputes betas over
    the kept steps so the respaced chain has the same cumulative alpha at each
    kept step (reference: respace.py:71-85)."""
    base_betas = named_beta_schedule(noise_schedule, base_steps)
    base_alphas_cumprod = np.cumprod(1.0 - base_betas)
    tr = str(timestep_respacing)
    if timestep_respacing in ("", str(base_steps)) and not tr.startswith("ddim"):
        keep = set(range(base_steps))
    elif tr.startswith("dpm"):
        keep = lambda_uniform_timesteps(base_alphas_cumprod, int(tr[3:]))
    else:
        keep = space_timesteps(base_steps, timestep_respacing)
    return respaced_schedule_from_keep(
        base_betas, keep, rescale_timesteps=rescale_timesteps
    )


def respaced_schedule_from_keep(
    base_betas: np.ndarray, keep, rescale_timesteps: bool = False
) -> Schedule:
    """The respaced :class:`Schedule` over an explicit kept-step set of
    ORIGINAL-chain step ids (reference math: respace.py:71-85)."""
    base_betas = np.asarray(base_betas, np.float64)
    base_steps = len(base_betas)
    base_alphas_cumprod = np.cumprod(1.0 - base_betas)
    keep = set(int(i) for i in keep)
    last_alpha_cumprod = 1.0
    new_betas = []
    timestep_map = []
    for i, alpha_cumprod in enumerate(base_alphas_cumprod):
        if i in keep:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return _schedule_from_betas(
        np.array(new_betas),
        np.array(timestep_map, dtype=np.int64),
        base_steps,
        rescale_timesteps,
    )


def fast_edit_schedule(
    sched: Schedule,
    base_betas: np.ndarray,
    w_time: int,
    count: int,
    rescale_timesteps: bool = False,
) -> Tuple[Schedule, np.ndarray]:
    """Window-respaced schedule for fast drag editing: the first ``w_time``
    positions of ``sched``'s chain respaced to ``count`` kept positions
    (``space_timesteps``), later positions kept as they are, so cumulative
    alphas match ``sched`` at every kept position and an inversion's ``w``
    is a valid start. Returns ``(schedule, positions)``: fast step ``j`` is
    full-chain position ``positions[j]`` (ascending), i.e. feature-cache row
    ``w_time - 1 - positions[j]``."""
    if not 2 <= count < w_time:
        raise ValueError(f"edit_steps must be in [2, w_time={w_time}); got {count}")
    positions = np.array(sorted(space_timesteps(w_time, [count])), np.int32)
    tmap = sched.timestep_map.cpu().numpy()
    keep = {int(tmap[p]) for p in positions} | {int(t) for t in tmap[w_time:]}
    fast = respaced_schedule_from_keep(base_betas, keep, rescale_timesteps=rescale_timesteps)
    return fast, positions


def validate_w_time(sched: Schedule, w_time: int, context: str = "") -> int:
    """Fail loudly when an edit window is longer than the respaced chain."""
    if not 0 < w_time <= sched.num_timesteps:
        raise ValueError(
            f"w_time={w_time} must be in [1, num respaced steps = "
            f"{sched.num_timesteps}]" + (f" ({context})" if context else "")
        )
    return w_time


def model_timesteps(sched: Schedule, t: torch.Tensor) -> torch.Tensor:
    """Respaced t -> the value the model's time embedding receives."""
    t_orig = sched.timestep_map[t]
    if sched.rescale_timesteps:
        return t_orig.float() * (1000.0 / sched.original_num_steps)
    return t_orig


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch fp32 coefficients and reshape to broadcast over
    ``ndim`` data dims (reference: gaussian_diffusion.py:1035-1048)."""
    out = arr[t].float()
    return out.reshape(out.shape + (1,) * (ndim - out.ndim))
