"""Time the attention kernels against their plain version and SDPA, on one
CUDA card.

    python -m ishapediting_tpu_torch.tools.attention_bench
    python -m ishapediting_tpu_torch.tools.attention_bench --shape 1024 8 64 float32

For each shape (T, heads, head dim, dtype; batch 2, inputs from a seed): the
kernel ``hk.attention_qkv`` launches (``attention`` or
``attention_generic``), its device time (``utils/device.py::device_ms``,
profiler, 20 calls), the plain version's (5 calls), SDPA's at the same
q, k, v (the library yardstick; the port never calls it), the bound (bytes
at 3.35 TB/s or the products at the rate of the route's type: bf16 tensor
cores, or three TF32 passes for fp32; the fp32 FMA bound beside it) and the
largest error against the plain version. Prints the card's name and power
limit first, then one JSON object per shape. A shape the checkout's kernels
refuse prints its error.

It uses only functions every slice of the port has, so the same script times
another checkout's kernels: ``PYTHONPATH=<checkout> python
ishapediting_tpu_torch/tools/attention_bench.py`` run with this file's path
imports the package from ``<checkout>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

# T, heads, head dim, dtype; batch 2. The fp32 chairs shapes and the tiny
# preset's head dim (the PR 3 rows), then the heads-by-count chairs UNet's
# bf16 shapes (16^2 at ch 192, 8^2 at ch 256) and a head dim above 256.
SHAPES = [(1024, 8, 64, "float32"), (256, 12, 64, "float32"), (64, 16, 64, "float32"),
          (64, 4, 8, "float32"), (64, 4, 8, "bfloat16"), (256, 4, 192, "bfloat16"),
          (64, 4, 256, "bfloat16"), (64, 2, 512, "bfloat16")]

# The published peaks of utils/device.py, kept here so that the script also
# runs against a checkout whose bound_ms has no TF32 rate.
HBM = 3.35e12
RATE = {"bfloat16": 989e12, "float32": 495e12 / 3}  # bf16 tensor cores; 3xTF32
FP32_FMA = 67e12


def bounds(t: int, heads: int, ch: int, dtype: str, n: int = 2) -> dict:
    """Bound of one call: bytes (qkv read, output written) against the
    products at the route's rate; the fp32 FMA bound beside it."""
    elt = 4 if dtype == "float32" else 2
    nbytes = elt * n * t * heads * ch * 4
    flops = 4.0 * n * heads * t * t * ch
    by_bytes, by_ops = nbytes / HBM * 1e3, flops / RATE[dtype] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                fp32_fma_bound_ms=max(by_bytes, flops / FP32_FMA * 1e3))


def bench(t: int, heads: int, ch: int, dtype: str, n: int = 2, seed: int = 0) -> dict:
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.ops.attention import dense_qkv_attention
    from ishapediting_tpu_torch.utils.device import device_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((n, t, heads * 3 * ch), generator=gen, device=dev).to(getattr(torch, dtype))
    row = dict(shape=[n, t, heads * 3 * ch], heads=heads, ch=ch, dtype=dtype,
               **bounds(t, heads, ch, dtype, n))
    try:
        before = dict(hk.LAUNCHES)
        got = hk.attention_qkv(qkv, heads)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - reported: an older checkout refuses the shape
        return dict(row, error=f"{type(e).__name__}: {e}")
    route = next(k for k in hk.LAUNCHES if hk.LAUNCHES[k] != before.get(k))
    want = dense_qkv_attention(qkv, heads)
    q, k, v = qkv.view(n, t, heads, 3, ch).permute(3, 0, 2, 1, 4).unbind(0)
    row.update(
        route=route, max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=device_ms(lambda: hk.attention_qkv(qkv, heads), kernel=f"{route}_kernel"),
        plain_ms=device_ms(lambda: dense_qkv_attention(qkv, heads), 5),
        sdpa_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5)),
    )
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", nargs=4, action="append", metavar=("T", "HEADS", "CH", "DTYPE"),
                    help="a shape to time instead of the default list (repeatable)")
    ap.add_argument("--repeat", type=int, default=1, help="time each shape this many times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench needs a CUDA card")
    from ishapediting_tpu_torch.utils.device import set_cuda_flags

    set_cuda_flags()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    shapes = SHAPES if not args.shape else [(int(a), int(b), int(c), d) for a, b, c, d in args.shape]
    for _ in range(args.repeat):
        for shape in shapes:
            print(json.dumps(bench(*shape)), flush=True)


if __name__ == "__main__":
    main()
