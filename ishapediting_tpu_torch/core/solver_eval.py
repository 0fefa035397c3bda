"""Mesh-level solver-quality evaluation.

Compares each sampler (the reference's DDPM/DDIM family,
gaussian_diffusion.py:534-847, plus DPM-Solver++(2M)) at fixed step budgets
against the dense-chain DDIM (probability-flow ODE) solution, at the level
users feel: the extracted surface, via Chamfer/IoU of the decoded meshes,
not latent RMS. ``cli.eval --solver_sweep`` runs it on any model directory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class StepNoises:
    """The JAX package's step noise of ``p_sample_loop`` from ``key``
    (``core/diffusion.py``: ``key, sub = split(key)`` once per step, then
    ``normal(sub, shape)``), drawn when the loop asks for step ``i``."""

    def __init__(self, key: np.ndarray, steps: int, shape):
        from ishapediting_tpu_torch.utils.threefry import split

        self.subs, self.shape = [], tuple(shape)
        for _ in range(steps):
            key, sub = split(key)
            self.subs.append(sub)

    def __len__(self) -> int:
        return len(self.subs)

    def __getitem__(self, i: int) -> np.ndarray:
        from ishapediting_tpu_torch.utils.threefry import normal

        return normal(self.subs[i], self.shape)


@torch.no_grad()
def solver_mesh_sweep(
    engine,
    n_seeds: int = 3,
    seed0: int = 100,
    budgets: Sequence[int] = (50, 25, 16, 12),
    max_attempts: Optional[int] = None,
    point_num: int = 30_000,
    x_Ts: Optional[Sequence[np.ndarray]] = None,
):
    """Per-solver Chamfer/IoU of the decoded mesh against the dense-chain
    DDIM solution, across ``n_seeds`` fixed x_T draws, on the engine's
    device through ``engine.model_fn(feat=False)`` (the product's model
    closure, with its x0-prediction adapter where the checkpoint has one).

    ``dpmN`` holds mesh parity with ``ddim50`` iff its mean CD to the ODE
    solution is <= ddim50's (with seed-noise margin). The full ancestral
    DDPM chain is included for context only: it injects noise, so its
    distance from the ODE solution measures sampler spread, not error.
    Draws whose reference mesh decodes empty are skipped (up to
    ``max_attempts`` total draws, default ``8 * n_seeds``); ``ddimN``
    budgets that don't divide the base chain are omitted (integer stride),
    ``dpmN`` has no such constraint.

    Draw ``s`` takes x_T = ``threefry.normal(prng_key(seed0 + s))``, the
    JAX package's x_T for the same seeds to 2e-5 (or ``x_Ts[s]`` where
    given), and the ancestral chain the JAX package's step noise from
    ``run_key = prng_key(seed0 + 7919 * (s + 1))`` (``StepNoises``), so
    every row is the JAX report's."""
    from ishapediting_tpu_torch.core.diffusion import ddim_sample_loop, dpm_solver_sample_loop, p_sample_loop
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.geometry.metrics import chamfer_distance, iou
    from ishapediting_tpu_torch.utils.threefry import normal, prng_key

    cfg = engine.config
    base = cfg.diffusion.base_steps
    clip = cfg.diffusion.clip_denoised
    mf = engine.model_fn(feat=False)
    device = engine.device

    def sched(respacing):
        return make_schedule(
            base, cfg.diffusion.noise_schedule, respacing, rescale_timesteps=cfg.diffusion.rescale_timesteps,
        ).to(device)

    dense = sched("")
    solvers = {f"ddpm{base}": lambda x, key: p_sample_loop(dense, mf, x, noises=StepNoises(key, base, x.shape),
                                                          clip_denoised=clip)}
    skipped_budgets = []
    for n in budgets:
        if n >= base:  # nothing to respace: the dense chain is this budget
            skipped_budgets.append(int(n))
            continue
        if base % n == 0:  # ddimN needs an integer stride
            sd = sched(f"ddim{n}")
            solvers[f"ddim{n}"] = lambda x, key, s=sd: ddim_sample_loop(s, mf, x, clip_denoised=clip)
        sp = sched(f"dpm{n}")
        solvers[f"dpm{n}"] = lambda x, key, s=sp: dpm_solver_sample_loop(s, mf, x, clip_denoised=clip)

    per = {name: {"cd": [], "iou": [], "empty": 0} for name in solvers}
    shape = (1,) + tuple(cfg.latent_shape)
    done = skipped = s = 0
    cap = 8 * n_seeds if max_attempts is None else max_attempts
    while done < n_seeds and s < cap:
        draw = x_Ts[s] if x_Ts is not None else normal(prng_key(seed0 + s), shape)
        x_T = torch.as_tensor(np.asarray(draw, np.float32).reshape(shape), device=device)
        run_key = prng_key(seed0 + 7919 * (s + 1))
        s += 1
        ref_mesh = engine.get_mesh(ddim_sample_loop(dense, mf, x_T, clip_denoised=clip))
        if len(ref_mesh.triangles) == 0:
            # an unconditional prior draw can decode to empty space: no
            # surface to compare against, skip this draw
            skipped += 1
            continue
        done += 1
        for name, fn in solvers.items():
            mesh = engine.get_mesh(fn(x_T, run_key))
            if len(mesh.triangles) == 0:
                per[name]["empty"] += 1
                continue
            per[name]["cd"].append(chamfer_distance(ref_mesh, mesh, point_num))
            per[name]["iou"].append(iou(ref_mesh, mesh, point_num))

    out = {"ref": f"ddim{base}-dense", "seeds": done, "skipped_empty_ref": skipped}
    if skipped_budgets:
        out["skipped_budgets_at_or_above_base"] = skipped_budgets
    for name, d in per.items():
        out[name] = {
            "cd_mean": round(float(np.mean(d["cd"])), 6) if d["cd"] else None,
            "cd_max": round(float(np.max(d["cd"])), 6) if d["cd"] else None,
            "iou_mean": round(float(np.mean(d["iou"])), 4) if d["iou"] else None,
            "empty": d["empty"],
        }
    return out
