"""Faults of the timed path that more than one kind can have, planted with
a ``monkeypatch`` (pytest's) under the program. A kind module lists the
faults its cells can have in ``FAULTS``."""

from __future__ import annotations

import torch


def half_batch(mp):
    """The UNet runs the first half of each batch; the rest gets its mean."""
    from port_bench import system

    real = system.DragEngine.model_fn

    def model_fn(self, *a, **k):
        fn = real(self, *a, **k)

        def half(x, t):
            h = max(1, x.shape[0] // 2)
            out, feat = fn(x[:h], t[:h])
            fill = lambda v: None if v is None else torch.cat(  # noqa: E731
                [v, v.mean(0, keepdim=True).expand((x.shape[0] - h,) + v.shape[1:])])
            return fill(out), fill(feat)

        return half

    mp.setattr(system.DragEngine, "model_fn", model_fn)
