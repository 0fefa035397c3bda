"""Joint triplane-decoder training: shared occupancy MLP + per-object planes.

The upstream capability that produced the released ``*_decoder.pt``
checkpoints (MultiTriplane over num_objs objects, reference:
axisnetworks.py:517-575 + dataset_3d.py), as the JAX package's
``train/decoder.py`` computes it: Adam over one shared Fourier+MLP decoder
and a [num_objs, 3, H, W, C] plane bank against occupancy labels, with the
smoothness/TV/L2 regularizers of the direct fit (reference loss recipe:
drag_utils.py:516-531). As in the JAX package, every decoder tensor is
trained, the Fourier projection ``B`` included.

The smoothness term's draws (uniform points and their normal jitter) come
from an explicit ``torch.Generator`` or are injected.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.edit.fit import bce_with_logits
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_points, init_decoder_, l2_reg, tv_reg
from ishapediting_tpu_torch.utils.device import resolve_device
from ishapediting_tpu_torch.utils.logger import get_logger


def init_plane_bank(generator: torch.Generator, num_objs: int, resolution: int = 128,
                    channels: int = 32) -> torch.Tensor:
    """[num_objs, 3, H, W, C] on the generator's device, init scale 0.001
    (reference: axisnetworks.py:523)."""
    shape = (num_objs, 3, resolution, resolution, channels)
    return torch.randn(shape, generator=generator, device=generator.device) * 0.001


def make_decoder_train_step(
    *,
    lr: float = 1e-3,
    smooth_weight: float = 0.3,
    l2_weight: float = 0.001,
    tv_weight: float = 0.01,
) -> Tuple[Callable, Callable]:
    """Build (make_opt, step). ``make_opt(decoder, bank)`` is the Adam
    optimizer over both; ``step(decoder, bank, opt, obj_idx, coords, labels,
    generator=None, *, rand=None, jitter=None) -> metrics`` updates them in
    place; its metrics stay on the device (no synchronisation). ``rand``
    (uniform in [-1, 1]) and ``jitter`` (standard normal) are the smoothness
    term's draws, each of ``coords``' shape."""

    def make_opt(decoder: TriplaneDecoder, bank: torch.Tensor) -> torch.optim.Adam:
        decoder.requires_grad_(True)
        bank.requires_grad_(True)
        return torch.optim.Adam([*decoder.parameters(), bank], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(decoder, bank, opt, obj_idx: int, coords, labels, generator: Optional[torch.Generator] = None,
             *, rand: Optional[torch.Tensor] = None, jitter: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = bank.device
        coords = torch.as_tensor(coords, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels, dtype=torch.float32).to(dev)
        if rand is None:
            rand = torch.rand(coords.shape, generator=generator, device=dev) * 2.0 - 1.0
        if jitter is None:
            jitter = torch.randn(coords.shape, generator=generator, device=dev)
        offs = rand + 1e-2 * jitter
        opt.zero_grad(set_to_none=True)
        planes = bank[obj_idx]
        loss = bce_with_logits(decode_points(decoder, planes, coords), labels[:, None])
        smooth = (decode_points(decoder, planes, rand) - decode_points(decoder, planes, offs)).square().mean()
        loss = loss + smooth_weight * smooth
        loss = loss + l2_weight * l2_reg(planes) + tv_weight * tv_reg(planes)
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    return make_opt, step


def train_decoder(
    batches: Iterator[Tuple[int, np.ndarray, np.ndarray]],
    *,
    num_objs: int,
    steps: int,
    resolution: int = 128,
    channels: int = 32,
    mapping: int = 64,
    hidden: int = 128,
    seed: int = 0,
    lr: float = 1e-3,
    log_every: int = 100,
    device=None,
) -> Tuple[TriplaneDecoder, torch.Tensor]:
    """Train the shared decoder + plane bank on ``device`` (default cuda);
    returns (decoder, planes_bank)."""
    logger = get_logger()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        decoder = init_decoder_(TriplaneDecoder(channels, mapping, hidden), gen)
    bank = init_plane_bank(gen, num_objs, resolution, channels)
    make_opt, step = make_decoder_train_step(lr=lr)
    opt = make_opt(decoder, bank)
    for i in range(steps):
        obj_idx, coords, labels = next(batches)
        metrics = step(decoder, bank, opt, obj_idx, coords, labels, gen)
        if i % log_every == 0:
            logger.log(f"decoder step {i}: loss {float(metrics['loss']):.4f}")
    return decoder, bank.detach()
