"""How far the generic attention kernel and its plain fp32 version each are
from a float64 evaluation, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.attention_accuracy

For each shape (T, heads, head dim, input scale; batch 2, fp32 inputs from
a seed, as ``tests/test_torch_kernels.py`` draws them): the largest
absolute difference of the kernel and of ``dense_qkv_attention`` in fp32
from ``dense_qkv_attention`` in float64, and of the kernel from the plain
fp32 version (what the card tests hold to 1e-4 + 1e-5|plain|). Inputs x4
give logits of size ~50, where fp32 rounding of the plain version itself
reaches the tests' tolerance. Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

SHAPES = [(130, 2, 100, 4.0), (97, 2, 191, 4.0), (70, 2, 333, 4.0), (77, 2, 40, 4.0),
          (97, 2, 191, 1.0), (70, 2, 333, 1.0), (1024, 2, 64, 1.0)]


def main() -> None:
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.ops.attention import dense_qkv_attention

    if not torch.cuda.is_available():
        raise SystemExit("attention_accuracy needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for t, heads, ch, scale in SHAPES:
        rng = np.random.default_rng(t + ch)
        qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32) * scale)
        qkv = qkv.cuda()
        got = hk.attention_qkv(qkv, heads).double()
        plain = dense_qkv_attention(qkv, heads).double()
        exact = dense_qkv_attention(qkv.double(), heads)
        print(f"T={t} H={heads} ch={ch} inputs x{scale:g}: kernel - float64 "
              f"{float((got - exact).abs().max()):.2e}, plain fp32 - float64 "
              f"{float((plain - exact).abs().max()):.2e}, kernel - plain fp32 "
              f"{float((got - plain).abs().max()):.2e}", flush=True)


if __name__ == "__main__":
    main()
