"""Per-SM copy rate of cp.async against TMA, the two ways the generic
attention kernel fills its K/V ring, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.copy_rate

Builds ``tools/copy_rate.cu`` (nvcc, linked with the driver library for the
tensor map) into ``build/copy_rate`` and runs it: for 8 to 128 CTAs at
T = 256 and 2048, the kernel time, the mean time per CTA and GB/s per SM of
each way (see the source's header). Prints the card's name and power limit
first.
"""

from __future__ import annotations

import os
import subprocess

from ishapediting_tpu_torch.ops import hopper_kernels as hk


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    exe = os.path.join(os.path.dirname(hk.BUILD_DIR), "copy_rate")
    os.makedirs(os.path.dirname(exe), exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "copy_rate.cu")
    subprocess.run([hk._nvcc(), *hk.NVCC_ARCH, "-std=c++17", "-O3", "-o", exe, src, "-lcuda"],
                   check=True)
    subprocess.run([exe], check=True)


if __name__ == "__main__":
    main()
