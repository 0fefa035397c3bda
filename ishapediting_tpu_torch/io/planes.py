"""Saved triplane ``.npy`` files -> NHWC planes (the layouts
``cli.generate`` and the reference's ``generate.py`` write, and the port's
own)."""

from __future__ import annotations

import numpy as np


def planes_to_nhwc(triplanes: np.ndarray) -> np.ndarray:
    """[3, C, H, H] (reference NCHW) -> [3, H, H, C]; [3, H, H, C] passes
    through. Planes are square, so the layout is told by which pair of
    trailing dims matches; a full cube (C == H) is taken as NHWC."""
    if triplanes.ndim != 4 or triplanes.shape[0] != 3:
        raise ValueError(f"expected [3,...] triplanes, got {triplanes.shape}")
    if triplanes.shape[2] == triplanes.shape[3] != triplanes.shape[1]:
        return triplanes.transpose(0, 2, 3, 1)
    if triplanes.shape[1] != triplanes.shape[2]:
        raise ValueError(f"planes are not square in either layout: {triplanes.shape}")
    return triplanes


def load_planes(path: str) -> np.ndarray:
    """``.npy`` -> [3, H, W, C] float32: the flattened [3C, H, W] NCHW of
    ``cli.generate``, [3, C, H, W] or [3, H, W, C]."""
    arr = np.asarray(np.load(path), np.float32)
    if arr.ndim == 3:  # [3*C, H, W]: the layout is known, transpose outright
        if arr.shape[0] % 3:
            raise ValueError(f"{path}: first dim {arr.shape[0]} not divisible by 3 "
                             f"(expected [3C,H,W]); shape={arr.shape}")
        arr = arr.reshape(3, arr.shape[0] // 3, *arr.shape[1:])
        return arr.transpose(0, 2, 3, 1)
    if arr.ndim != 4 or arr.shape[0] != 3:
        raise ValueError(f"{path}: expected 3 planes, got shape {arr.shape}")
    try:
        return planes_to_nhwc(arr)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc
