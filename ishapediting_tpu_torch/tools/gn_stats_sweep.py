"""Time the GroupNorm kernels at other ``gn_stats`` launch geometries, on one
CUDA card.

    python -m ishapediting_tpu_torch.tools.gn_stats_sweep

For each (threads per block, cluster size, blocks per SM, partials per
group at most, rows per thread past which blocks form clusters; 0:
clusters for every input) in turn, the shipped geometry first and last:
the device
time of ``gn_stats`` and of ``gn_norm`` (which merges the partials) per
chairs UNet forward at batch 1 and 2 (``profile_unet.kernel_accounting``,
random weights from a seed), and ``gn_stats`` alone at the three GN cases
of ``chip_smoke.py`` (``utils/device.py::device_ms``). Prints the card's
name and power limit first.
"""

from __future__ import annotations

import subprocess

import torch

# (threads per block, cluster CTAs, blocks per SM, partials per group at
# most, cluster rows threshold)
VARIANTS = [(512, 2, 2, 32, 16), (512, 2, 2, 32, 0), (512, 2, 2, 16, 16), (512, 4, 2, 32, 16),
            (512, 8, 2, 32, 16), (512, 2, 2, 32, 16)]
CASES = [((2, 128, 128, 512), torch.bfloat16), ((2, 128, 128, 256), torch.float32),
         ((2, 8, 8, 2048), torch.bfloat16)]
KNOBS = ("_GN_STATS_THREADS", "_GN_STATS_CLUSTER", "_GN_STATS_BLOCKS_PER_SM", "_GN_MAX_SPLITS",
         "_GN_STATS_CLUSTER_ROWS")


def main() -> None:
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.tools.profile_unet import kernel_accounting
    from ishapediting_tpu_torch.utils.device import device_ms, resolve_device, set_cuda_flags

    dev = resolve_device("cuda")
    set_cuda_flags()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}")
    cfg = preset("chairs")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        unet = init_unet_(UNetModel(cfg.unet), gen).eval().requires_grad_(False)
    forwards = {}
    for batch in (1, 2):
        x = torch.randn((batch,) + cfg.latent_shape, generator=gen, device=dev)
        t = torch.full((batch,), 500, dtype=torch.long, device=dev)
        forwards[batch] = (x, t)
    cases = [(torch.randn(s, generator=gen, device=dev) * 2 + 0.5).to(d) for s, d in CASES]

    defaults = tuple(getattr(hk, k) for k in KNOBS)
    try:
        for variant in VARIANTS:
            for knob, v in zip(KNOBS, variant):
                setattr(hk, knob, v)
            line = []
            for batch, (x, t) in forwards.items():
                def fwd():
                    with torch.no_grad():
                        unet(x, t)

                acc = kernel_accounting(fwd)["kernels"]
                line.append(f"batch {batch}: gn_stats {acc['gn_stats']['ms']:.4f} + gn_norm "
                            f"{acc['gn_norm']['ms']:.4f} ms per forward")
            for (shape, dtype), xc in zip(CASES, cases):
                ms = device_ms(lambda: hk.gn_stats_cuda(xc, 32), kernel="gn_stats_kernel")
                line.append(f"gn_stats {list(shape)} {str(dtype)[6:]} {ms:.4f} ms")
            print(f"{variant[0]} threads, cluster {variant[1]}, {variant[2]} blocks/SM, "
                  f"S <= {variant[3]}, cluster past {variant[4]} rows: " + "; ".join(line),
                  flush=True)
    finally:
        for knob, v in zip(KNOBS, defaults):
            setattr(hk, knob, v)


if __name__ == "__main__":
    main()
