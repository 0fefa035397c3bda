"""Feature-space plumbing for drag editing (reference: drag_utils.py:141-159).

Internal feature layout is planes-first NHWC: ``[3, s, s, C']`` per step;
channel grouping matches the reference exactly.
"""

from __future__ import annotations

import torch

from ishapediting_tpu_torch.ops.nn import channel_nearest_resize


def regroup_features(feat: torch.Tensor, cat_var: bool = True) -> torch.Tensor:
    """[B, s, s, 2C] tapped activation -> [B, 3, s, s, C''] fp32 plane features.

    Channels split into mean/var halves, each truncated to a multiple of 3
    with nearest-neighbor channel resampling, grouped contiguously into the
    three planes, then (optionally) re-concatenated.
    """
    b, s1, s2, c2 = feat.shape
    assert c2 % 2 == 0, c2
    c = c2 // 2
    mean, var = feat[..., :c], feat[..., c:]
    if c % 3:
        c -= c % 3
        mean = channel_nearest_resize(mean, c)
        var = channel_nearest_resize(var, c)

    def to_planes(x):
        return x.reshape(b, s1, s2, 3, c // 3).permute(0, 3, 1, 2, 4)

    if not cat_var:
        return to_planes(mean).float()
    return torch.cat([to_planes(mean), to_planes(var)], dim=-1).float()
