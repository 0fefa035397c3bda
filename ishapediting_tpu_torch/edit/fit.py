"""Latent -> physical triplanes (reference: drag_utils.py:295,449-450).
Channel groups are contiguous: plane p <- channels [C/3*p, C/3*(p+1))."""

from __future__ import annotations

import torch


def latents_to_planes(latents: torch.Tensor, half_range: torch.Tensor, middle: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] normalized latents -> [B, 3, H, W, C/3] physical planes."""
    tri = latents * half_range + middle
    b, h, w, c = tri.shape
    return tri.reshape(b, h, w, 3, c // 3).permute(0, 3, 1, 2, 4)


def latent_to_planes(latent: torch.Tensor, half_range: torch.Tensor, middle: torch.Tensor) -> torch.Tensor:
    """[1, H, W, C] normalized latent -> [3, H, W, C/3] physical planes."""
    return latents_to_planes(latent, half_range, middle)[0]
