"""Time the attention backward kernels against their plain twins and SDPA's
backward, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.attn_bwd_bench [--out PATH] [--shape N T H CH DTYPE ...]

For each shape (batch, T, heads, head dim, dtype; inputs from a seed):
``attn_bwd_dq`` and ``attn_bwd_dkdv`` as the checkout's wrappers launch them,
their device times (``utils/device.py::device_ms``, profiler, 20 calls), the
plain twins' (5 calls), the backward of ``F.scaled_dot_product_attention``
at the same q, k, v and cotangent (the library yardstick; the port never
calls it), each kernel's bound (``utils/device.py::bound_ms`` of its bytes
and of the work ``ops/hopper_kernels.py::_attn_bwd_flops`` counts: dQ's
function three T^2*ch products, dK and dV's four) and the largest error
against the twins. Prints the card's name and power limit first, then one
JSON object per shape.

It runs against another checkout's kernels too (the route only where that
checkout has one): ``PYTHONPATH=<checkout> python
ishapediting_tpu_torch/tools/attn_bwd_bench.py`` run with this file's path
imports the package, its bound included, from ``<checkout>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

# batch, T, heads, head dim, dtype: the chairs train step's attention at
# batch 8, the drag step's T = 1024 level at batch 1, the heads-by-count
# head dims, the fp32 UNets', the Hopper route at ch 32 and 128, then the
# generic route at ch <= 64 and T = 1024 (bf16 at ch 48, fp32 at 64), where
# the two-sweep attn_bwd_dq of a checkout before the Hopper route differs
# from this one only by its second key sweep.
SHAPES = [(8, 1024, 8, 64, "bfloat16"), (1, 1024, 8, 64, "bfloat16"), (8, 256, 12, 64, "bfloat16"),
          (8, 64, 16, 64, "bfloat16"), (1, 256, 4, 192, "bfloat16"), (1, 64, 4, 256, "bfloat16"),
          (2, 64, 4, 8, "float32"), (1, 64, 4, 16, "float32"), (2, 1024, 16, 32, "bfloat16"),
          (2, 1024, 4, 128, "bfloat16"), (2, 1024, 8, 48, "bfloat16"), (2, 1024, 8, 64, "float32")]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bench(n: int, t: int, heads: int, ch: int, dtype: str, seed: int = 0) -> dict:
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.utils.device import bound_ms, device_ms

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((n, t, heads * 3 * ch), generator=gen, device=dev).to(dt)
    gout = torch.randn((n, t, heads * ch), generator=gen, device=dev).to(dt)
    out = hk.attention_qkv(qkv, heads)
    dqkv = torch.zeros_like(qkv)
    route = hk.attention_bwd_route(dt, ch) if hasattr(hk, "attention_bwd_route") else None
    row = dict(shape=[n, t, heads * 3 * ch], heads=heads, ch=ch, dtype=dtype, route=route)
    ws = hk.attn_bwd_dq_cuda(qkv, out, gout, heads, dqkv)
    lse, d = ws[:2]
    # the workspace holds sQ too (None on the generic route); a checkout before the Hopper route's is (lse, D)
    extra = {"sq": ws[2]} if len(ws) > 2 else {}
    hk.attn_bwd_dkdv_cuda(qkv, gout, lse, d, heads, dqkv, **extra)
    torch.cuda.synchronize()
    dq, lse_p, d_p = hk.attn_bwd_dq_plain(qkv, out, gout, heads)
    dk, dv = hk.attn_bwd_dkdv_plain(qkv, gout, lse, d, heads)
    got = dqkv.float().view(n, t, heads, 3, ch).unbind(3)
    row["max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                             for a, b in ((lse, lse_p), (d, d_p), (got[0], dq), (got[1], dk), (got[2], dv)))
    row["dq_ms"] = device_ms(lambda: hk.attn_bwd_dq_cuda(qkv, out, gout, heads, dqkv), kernel="attn_bwd_dq_kernel")
    row["dkdv_ms"] = device_ms(lambda: hk.attn_bwd_dkdv_cuda(qkv, gout, lse, d, heads, dqkv, **extra),
                               kernel="attn_bwd_dkdv_kernel")
    row["dq_plain_ms"] = device_ms(lambda: hk.attn_bwd_dq_plain(qkv, out, gout, heads), 5)
    row["dkdv_plain_ms"] = device_ms(lambda: hk.attn_bwd_dkdv_plain(qkv, gout, lse, d, heads), 5)
    row["dq_bound_ms"], row["dq_bound_by"] = bound_ms(nbytes(qkv, out, gout, lse, d) + nbytes(dqkv) // 3,
                                                      **hk._attn_bwd_flops(qkv, n, t, heads, ch, products=3))
    row["dkdv_bound_ms"], row["dkdv_bound_by"] = bound_ms(nbytes(qkv, gout, lse, d) + 2 * nbytes(dqkv) // 3,
                                                          **hk._attn_bwd_flops(qkv, n, t, heads, ch, products=4))
    leaves = [a.detach().requires_grad_(True) for a in qkv.view(n, t, heads, 3, ch).permute(3, 0, 2, 1, 4).unbind(0)]
    o = F.scaled_dot_product_attention(*leaves, scale=ch ** -0.5)
    go = gout.view(n, t, heads, ch).transpose(1, 2)
    try:
        row["sdpa_backward_ms"] = device_ms(lambda: torch.autograd.grad(o, leaves, go, retain_graph=True))
    except Exception as e:  # noqa: BLE001 - a yardstick, not a path of the port
        row["sdpa_backward_ms"] = f"refused: {type(e).__name__}"
    row["pair_ms"] = row["dq_ms"] + row["dkdv_ms"]
    del o, leaves
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the rows as one JSON list here")
    p.add_argument("--shape", nargs=5, action="append", metavar=("N", "T", "H", "CH", "DTYPE"),
                   help="time these shapes in place of the list")
    args = p.parse_args(argv)
    shapes = [(int(a), int(b), int(c), int(d), e) for a, b, c, d, e in args.shape] if args.shape else SHAPES
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rows = []
    for shape in shapes:
        try:
            rows.append(bench(*shape))
        except Exception as e:  # noqa: BLE001 - another checkout may refuse a shape
            rows.append(dict(shape=list(shape), error=f"{type(e).__name__}: {e}"))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
