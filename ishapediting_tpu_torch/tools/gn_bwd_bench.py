"""Time the GroupNorm-SiLU backward kernels against their plain twins, on one
CUDA card.

    python -m ishapediting_tpu_torch.tools.gn_bwd_bench [--out PATH] [--shape N H W C DTYPE FILM ...]

For each shape (batch, height, width, channels, dtype, FiLM 0 or 1; inputs
from a seed): ``gn_bwd_reduce`` and ``gn_bwd_apply`` as the checkout's
``gn_silu_bwd_cuda`` launches them, their device times
(``utils/device.py::device_ms``, profiler, 20 calls), the device time of
everything one ``gn_silu_bwd_cuda`` call launches and of one backward of
``GroupNormSiLU`` through autograd, with what of each is not the two
kernels (``between_ms``, ``node_between_ms``), the plain twin's time
(``gn_silu_bwd_plain``, 5 calls), each kernel's bound
(``utils/device.py::bound_ms`` of the bytes its function must move: the
reduce reads x and gy, the apply reads them again and writes dx) and the
largest error of dx against the twin's. Prints the card's name and power
limit first, then one JSON object per shape.

It runs against another checkout's kernels too: ``PYTHONPATH=<checkout>
python ishapediting_tpu_torch/tools/gn_bwd_bench.py`` run with this file's
path imports the package, from ``<checkout>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

# batch, height, width, channels, dtype, FiLM: the chairs train step's
# largest GroupNorm input at batch 8 (a ResBlock's second norm, FiLM), the
# widest at 64^2, the 8^2 level's widest, the drag step's largest at batch 1
# and one with 40-channel groups, then the fp32 UNets' (one and three
# channels per group).
SHAPES = [(8, 128, 128, 256, "bfloat16", 1), (8, 64, 64, 512, "bfloat16", 0), (1, 8, 8, 2048, "bfloat16", 1),
          (1, 128, 128, 256, "bfloat16", 1), (1, 32, 32, 1280, "bfloat16", 1), (1, 16, 16, 16, "float32", 1),
          (2, 16, 16, 96, "float32", 1)]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bench(n: int, h: int, w: int, c: int, dtype: str, film: int, seed: int = 0) -> dict:
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.ops.nn import effective_groups
    from ishapediting_tpu_torch.utils.device import bound_ms, device_ms

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((n, h, w, c), generator=gen, device=dev) * 2 + 0.5).to(dt)
    scale = torch.randn(c, generator=gen, device=dev) * 0.1 + 1.0
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    f = tuple((torch.randn((n, c), generator=gen, device=dev) * 0.2).to(dt) for _ in range(2)) if film else None
    gy = torch.randn(x.shape, generator=gen, device=dev).to(dt)
    part = hk.gn_stats_cuda(x, effective_groups(c, 32))
    row = dict(shape=[n, h, w, c], dtype=dtype, film=bool(film))
    bwd = lambda: hk.gn_silu_bwd_cuda(x, part, gy, scale, bias, film=f)  # noqa: E731
    got = bwd()
    want = hk.gn_silu_bwd_plain(x, part, gy, scale, bias, film=f)
    torch.cuda.synchronize()
    row["dx_max_abs_err"] = float((got[0].float() - want[0].float()).abs().max())
    row["reduce_ms"] = device_ms(bwd, kernel="gn_bwd_reduce_kernel")
    row["apply_ms"] = device_ms(bwd, kernel="gn_bwd_apply_kernel")
    row["pair_ms"] = row["reduce_ms"] + row["apply_ms"]
    row["call_ms"] = device_ms(bwd)
    row["between_ms"] = row["call_ms"] - row["pair_ms"]
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, *(f or ()))]
    y = hk.groupnorm_silu(leaves[0], leaves[1], leaves[2], film=tuple(leaves[3:]) or None)
    row["node_ms"] = device_ms(lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True))
    row["node_between_ms"] = row["node_ms"] - row["pair_ms"]
    row["plain_ms"] = device_ms(lambda: hk.gn_silu_bwd_plain(x, part, gy, scale, bias, film=f), 5)
    row["reduce_bound_ms"] = bound_ms(nbytes(x, gy))[0]
    row["apply_bound_ms"] = bound_ms(nbytes(x, gy, x))[0]
    row["pair_bound_ms"] = row["reduce_bound_ms"] + row["apply_bound_ms"]
    hk.reset_launch_counts()
    bwd()
    row["launches"] = {k: v for k, v in hk.LAUNCHES.items() if v}
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the rows as one JSON list here")
    p.add_argument("--shape", nargs=6, action="append", metavar=("N", "H", "W", "C", "DTYPE", "FILM"),
                   help="time these shapes in place of the list")
    args = p.parse_args(argv)
    shapes = ([(int(a), int(b), int(c), int(d), e, int(f)) for a, b, c, d, e, f in args.shape]
              if args.shape else SHAPES)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rows = []
    for shape in shapes:
        rows.append(bench(*shape))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
