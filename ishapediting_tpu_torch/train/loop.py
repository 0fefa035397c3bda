"""The training loop: checkpoint/resume, EMA, NaN guard, metrics.

The reference ships no trainer (SURVEY.md §2.4); this is the counterpart of
the JAX package's ``train/loop.py``:

- periodic checkpoints of the full train state (``io/checkpoint.py``:
  ``step_<N>`` directories, each the orbax train state JAX's loop writes,
  at the steps it writes them) and resume from the newest one,
- failure detection: a step with a non-finite loss leaves the parameters,
  the EMA, the optimizer's moments and the step count untouched (the step
  checks the loss before the optimizer runs); ``max_bad_steps`` bad steps
  in a row abort with ``FloatingPointError``,
- kv-logger metrics (``utils/logger.py``).

Each step draws from a generator on the model's device seeded from
(``seed``, step index), so a resumed run draws what an uninterrupted one
would have.

Over ranks (``mesh=``: a data axis of ``replicate``d models, a model axis
of ``shard_params_tp``-cut ones, or both) every rank takes the same global
batch and draws, the step keeps this rank's rows, and a checkpoint holds
whole tensors written by the mesh's first rank: JAX's loop trains sharded
parameters unchanged and saves them whole. ``latest_checkpoint`` takes the
newest ``step_<N>``, whichever package wrote it.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ishapediting_tpu_torch.config import UNetConfig
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.io.checkpoint import load_train_state, save_train_state
from ishapediting_tpu_torch.parallel.mesh import DataMesh
from ishapediting_tpu_torch.train.trainer import (
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from ishapediting_tpu_torch.utils.logger import get_logger


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n[5:]) for n in os.listdir(ckpt_dir) if n.startswith("step_") and n[5:].isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


def _step_seed(seed: int, step_idx: int) -> int:
    """The generator seed of step ``step_idx`` of a run seeded ``seed``."""
    return (int(seed) * 1_000_003 + int(step_idx)) % 2**63


def train(
    cfg: UNetConfig,
    sched: Schedule,
    model: torch.nn.Module,
    batches: Iterator[np.ndarray],
    *,
    total_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 1000,
    log_every: int = 50,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    grad_clip: float = 1.0,
    ema_rate: float = 0.9999,
    seed: int = 0,
    max_bad_steps: int = 20,
    step_transform: Optional[Callable] = None,
    mesh: Optional[DataMesh] = None,
) -> TrainState:
    """Run (or resume) training of ``model`` (its parameters are the
    initial ones, trained in place on their device; over ``mesh``'s ranks
    ``replicate``d or cut by ``shard_params_tp``, and ``batches`` the same
    global batches on every rank); returns the final TrainState."""
    logger = get_logger()
    state = init_train_state(model, make_optimizer(
        model.parameters(), lr, weight_decay=weight_decay, grad_clip=grad_clip))

    def save(step: int) -> None:
        path = os.path.join(ckpt_dir, f"step_{step}")
        t0 = time.perf_counter()
        nbytes = save_train_state(path, state, mesh)
        logger.log(f"checkpointed {path} ({nbytes} bytes in {time.perf_counter() - t0:.2f} s)")

    start_step = 0
    if ckpt_dir:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            t0 = time.perf_counter()
            load_train_state(latest, state)
            start_step = state.step
            logger.log(f"resumed from {latest} at step {start_step} "
                       f"(loaded in {time.perf_counter() - t0:.2f} s)")
    saved_at = start_step if start_step else None

    train_step = make_train_step(cfg, sched, ema_rate=ema_rate, mesh=mesh)
    if step_transform is not None:
        train_step = step_transform(train_step)

    gen = torch.Generator(device=next(model.parameters()).device)
    bad_streak = 0
    for step_idx in range(start_step, total_steps):
        batch = next(batches)
        gen.manual_seed(_step_seed(seed, step_idx))
        metrics = train_step(state, batch, gen)
        loss = metrics["loss"]
        if not np.isfinite(loss):
            bad_streak += 1
            logger.log(
                f"step {step_idx}: non-finite loss ({loss}); skipping update "
                f"({bad_streak}/{max_bad_steps})"
            )
            if bad_streak >= max_bad_steps:
                raise FloatingPointError(f"{max_bad_steps} consecutive non-finite steps — aborting")
            continue
        bad_streak = 0

        if step_idx % log_every == 0:
            logger.logkv("step", step_idx)
            for k, v in metrics.items():
                logger.logkv(k, v)
            logger.dumpkvs()
        if ckpt_dir and (step_idx + 1) % ckpt_every == 0:
            save(step_idx + 1)
            saved_at = step_idx + 1

    if ckpt_dir and saved_at != state.step:
        save(state.step)
    return state
