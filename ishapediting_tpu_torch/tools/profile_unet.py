"""Where one chairs UNet forward spends its device time, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.profile_unet --batch 1 2

For each batch size: the steady-state forward time (CUDA events), the
device time of the kernels per forward and the device's idle share, and a
``torch.profiler`` table of device time by kernel name over a few forwards,
on random weights from a seed. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

ITERS = 5  # forwards per timing and per profile


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    p.add_argument("--rows", type=int, default=15, help="kernel names to list")
    p.add_argument("--no_cudnn_benchmark", action="store_true",
                   help="take cuDNN's heuristic algorithm choice instead of timing")
    args = p.parse_args(argv)

    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
    from ishapediting_tpu_torch.utils.device import (
        cuda_ms, kernel_rows, resolve_device, set_cuda_flags,
    )

    dev = resolve_device("cuda")
    set_cuda_flags(cudnn_benchmark=not args.no_cudnn_benchmark)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}; cudnn.benchmark={torch.backends.cudnn.benchmark}")
    cfg = preset("chairs")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        unet = init_unet_(UNetModel(cfg.unet), gen).eval().requires_grad_(False)
    for batch in args.batch:
        x = torch.randn((batch,) + cfg.latent_shape, generator=gen, device=dev)
        t = torch.full((batch,), 500, dtype=torch.long, device=dev)

        def fwd():
            with torch.no_grad():
                unet(x, t)

        ms = cuda_ms(fwd, ITERS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fwd()
            torch.cuda.synchronize()
        events = kernel_rows(prof)
        busy = sum(e.self_device_time_total for e in events) / 1e3 / ITERS
        print(f"batch {batch}: forward {ms:.3f} ms (CUDA events); kernels busy {busy:.3f} ms "
              f"per forward (profiler), device idle {1 - busy / ms:.1%}")
        for name in ("gn_stats_kernel", "gn_norm_kernel", "attention_kernel"):  # csrc/*.cu
            rows = [e for e in events if name in e.key]
            print(f"  {name}: {sum(e.self_device_time_total for e in rows) / 1e3 / ITERS:.3f} ms, "
                  f"{sum(e.count for e in rows) // ITERS} launches per forward")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[: args.rows]:
            print(f"  {e.self_device_time_total / 1e3 / ITERS:9.3f} ms "
                  f"{e.count // ITERS:5d}x  {e.key[:110]}")


if __name__ == "__main__":
    main()
