"""Model-directory discovery + normalization statistics (NumPy only).

The reference's per-category asset layout (reference: drag_utils.py:213-228,
normalization.py:6-15)::

    models/<category>/
      ddpm_*_ckpts/ema_*.pt          DDPM EMA UNet state_dict
      *_decoder.pt  (any *.pt)       decoder MLP state_dict
      statistics/<name>/{lower_bound,upper_bound,means,stds}.npy

and, in the same folder, the JAX package's orbax checkpoints
(``unet.orbax/``, ``decoder.orbax/``, read by ``io/orbax.py``), which a
loader prefers over the ``.pt`` files, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ModelDir:
    root: str
    unet_ckpt: Optional[str] = None  # torch .pt
    decoder_ckpt: Optional[str] = None  # torch .pt
    stats_dir: Optional[str] = None
    unet_orbax: Optional[str] = None  # the JAX package's orbax dir
    decoder_orbax: Optional[str] = None  # the JAX package's orbax dir


def discover_model_dir(main_path: str) -> ModelDir:
    """Scan a category directory for checkpoints + stats
    (reference: drag_utils.py:216-226)."""
    info = ModelDir(root=main_path)
    for name in sorted(os.listdir(main_path)):
        full = os.path.join(main_path, name)
        if name.startswith("ddpm") and os.path.isdir(full):
            for sub in sorted(os.listdir(full)):
                if sub.startswith("ema"):
                    info.unet_ckpt = os.path.join(full, sub)
                    break
        elif name.endswith(".pt"):
            info.decoder_ckpt = full
        elif name == "statistics" and os.path.isdir(full):
            subdirs = sorted(os.listdir(full))
            if subdirs:
                info.stats_dir = os.path.join(full, subdirs[0])
        elif name == "unet.orbax":
            info.unet_orbax = full
        elif name == "decoder.orbax":
            info.decoder_orbax = full
    return info


@dataclasses.dataclass(frozen=True)
class TriplaneStats:
    """Per-channel affine between normalized latents x in [-1,1] and physical
    triplane features: ``tri = x * half_range + middle``
    (reference: drag_utils.py:236-245, normalization.py:6-15). Arrays are [C]."""

    half_range: np.ndarray
    middle: np.ndarray
    means: Optional[np.ndarray] = None
    stds: Optional[np.ndarray] = None

    @staticmethod
    def identity(channels: int = 96) -> "TriplaneStats":
        return TriplaneStats(
            half_range=np.ones(channels, np.float32),
            middle=np.zeros(channels, np.float32),
        )


def load_stats(stats_dir: str) -> TriplaneStats:
    def load(name):
        return np.load(os.path.join(stats_dir, name)).astype(np.float32).reshape(-1)

    lower, upper = load("lower_bound.npy"), load("upper_bound.npy")
    optional = {
        key: load(f"{key}.npy") if os.path.exists(os.path.join(stats_dir, f"{key}.npy")) else None
        for key in ("means", "stds")
    }
    return TriplaneStats(half_range=(upper - lower) / 2.0, middle=(upper + lower) / 2.0, **optional)
