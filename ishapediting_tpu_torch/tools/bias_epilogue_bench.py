"""Time the bias epilogue kernels against the eager adds they replace and
their bytes bound, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.bias_epilogue_bench [--out PATH] [--shape ROWS C DTYPE FORM ...]

For each shape ([rows, C] of an NHWC product flattened, dtype, form:
``plain`` = y + b, ``fused`` = res + (y + b), ``fused_skip`` = (res + rb) +
(y + b); inputs from a seed, the biases fp32 as the UNet's layers store
them): the kernel's device time as ``hopper_kernels.bias_epilogue``
launches it with no gradient wanted (into y's own buffer), the eager
composition's device time (the port's casts and adds before the epilogue:
PyTorch's elementwise kernels, one per bias cast and one per ``+``), each
against the bound (``utils/device.py::bound_ms`` of the bytes: y, res and
the skip's raw product read once, the output written once; the composition
also writes and reads each intermediate), whether the two agree bit for
bit, and the launch counter it moved. Prints the card's name and power
limit first, then one JSON object per shape.

It runs against another checkout's kernels too: ``PYTHONPATH=<checkout>
python ishapediting_tpu_torch/tools/bias_epilogue_bench.py`` run with this
file's path imports the package from ``<checkout>`` (one without the
epilogue times the composition alone).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

# rows, C, dtype, form: at batch 32, a 128^2 ResBlock's products (conv1
# plain, conv2 fused, an output ResBlock's with its skip), a 32^2 input
# ResBlock's with its skip, the 32^2 qkv (chairs
# width 512, 3 x 512 channels) and attention projection, the 8^2 level's
# widest, the time MLP, and the fp32 heads (chairs 192 channels, adm128 6).
SHAPES = [(32 * 128 * 128, 256, "bfloat16", "plain"), (32 * 128 * 128, 256, "bfloat16", "fused"),
          (32 * 128 * 128, 256, "bfloat16", "fused_skip"),
          (32 * 32 * 32, 512, "bfloat16", "fused_skip"), (32 * 32 * 32, 1536, "bfloat16", "plain"),
          (32 * 32 * 32, 512, "bfloat16", "fused"), (32 * 8 * 8, 1024, "bfloat16", "fused"),
          (32, 1024, "float32", "plain"), (32 * 128 * 128, 192, "float32", "plain"),
          (32 * 128 * 128, 6, "float32", "plain")]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def cell_configs() -> dict:
    """The UNet configurations of the benchmark's two cells: NFD's chairs
    model and guided-diffusion's ImageNet 128x128 model by its README's
    flags (bf16 torso, no label table)."""
    from ishapediting_tpu_torch.config import UNetConfig, preset

    adm = UNetConfig.from_reference_args(
        image_size=128, num_channels=256, num_res_blocks=2, channel_mult="1,1,2,3,4",
        attention_resolutions="32,16,8", learn_sigma=True, in_out_channels=3, num_heads=4,
        num_head_channels=-1, num_heads_upsample=-1, use_scale_shift_norm=True, resblock_updown=True,
        dropout=0.0)
    return {"nfd_chairs": preset("chairs").unet,
            "adm_imagenet128": dataclasses.replace(adm, compute_dtype="bfloat16")}


def forward_epilogues(cfg, batch: int) -> list:
    """Each bias epilogue of one batch-``batch`` forward of a UNet of
    ``cfg``, in call order, as ((rows, C), dtype, form): a forward on the
    meta device (no memory, no kernel), ``hopper_kernels``' three ops
    replaced by recorders or shape-only stand-ins while it runs. Raises
    where a layer hands a bias that is not fp32 (the kernel reads the bias
    as every layer stores it)."""
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.ops import hopper_kernels as hk

    calls = []

    def record(y, b, res=None, res_bias=None):
        if any(t is not None and t.dtype != torch.float32 for t in (b, res_bias)):
            raise ValueError(f"a bias of {y.shape[-1]} channels is not fp32")
        form = "plain" if res is None else "fused" if res_bias is None else "fused_skip"
        calls.append(((y.numel() // y.shape[-1], y.shape[-1]), y.dtype, form))
        return hk.bias_epilogue_plain(y, b, res, res_bias)

    stand_ins = dict(bias_epilogue=record, groupnorm_silu=lambda x, *a, **k: torch.empty_like(x),
                     attention_qkv=lambda qkv, heads: qkv.new_empty(*qkv.shape[:2], qkv.shape[-1] // 3))
    real = {k: getattr(hk, k) for k in stand_ins}
    try:
        for k, v in stand_ins.items():
            setattr(hk, k, v)
        with torch.device("meta"), torch.no_grad():
            unet = UNetModel(cfg)
            unet(torch.empty((batch, cfg.image_size, cfg.image_size, cfg.in_channels)),
                 torch.zeros(batch, dtype=torch.long))
    finally:
        for k, v in real.items():
            setattr(hk, k, v)
    return calls


def inputs(rows: int, c: int, dtype: torch.dtype, form: str, gen: torch.Generator) -> tuple:
    """(y, b, res, res_bias) of ``form`` drawn from ``gen`` on its device,
    y and res [rows, c] in ``dtype``, the biases fp32 as the UNet's layers
    store them."""
    def draw(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=gen.device).to(dt)

    y, b = draw((rows, c)), draw((c,), torch.float32)
    res = draw((rows, c)) if form != "plain" else None
    rb = draw((c,), torch.float32) if form == "fused_skip" else None
    return y, b, res, rb


def bench(rows: int, c: int, dtype: str, form: str, seed: int = 0) -> dict:
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.utils.device import bound_ms, device_ms

    dt = getattr(torch, dtype)
    y, b, res, rb = inputs(rows, c, dt, form, torch.Generator(device="cuda").manual_seed(seed))

    def eager():
        hh = y + b.to(dt)
        if res is None:
            return hh
        return (res if rb is None else res + rb.to(dt)) + hh

    row = dict(shape=[rows, c], dtype=dtype, form=form)
    want = eager()
    row["eager_ms"] = device_ms(eager)
    # eager: y + b writes hh, the residual add reads it again (and res + rb
    # writes and reads one more tensor)
    inter = 0 if res is None else nbytes(y) * (2 if rb is None else 4)
    row["eager_bound_ms"] = bound_ms(nbytes(y, b, res, rb, y) + inter)[0]
    row["bound_ms"] = bound_ms(nbytes(y, b, res, rb, y))[0]
    if not hasattr(hk, "bias_epilogue"):
        return row
    scratch = y.clone()

    def kernel():  # into the product's own buffer, as the no-grad forward calls it
        with torch.no_grad():
            return hk.bias_epilogue(scratch, b, res, rb)

    got = hk.bias_epilogue_cuda(y, b, res, rb)
    torch.cuda.synchronize()
    row["bit_equal"] = bool(torch.equal(got, want))
    name = "bias_add_kernel" if res is None else "bias_residual_kernel"
    row["kernel_ms"] = device_ms(kernel, kernel=name)
    row["kernel_pct_of_bound"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
    row["speedup"] = row["eager_ms"] / row["kernel_ms"]
    row["vec"] = hk.bias_vec(c, y.element_size(), [0 if t is None else t.data_ptr() for t in (y, res)])
    hk.reset_launch_counts()
    kernel()
    row["launches"] = {k: v for k, v in hk.LAUNCHES.items() if v}
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the rows as one JSON list here")
    p.add_argument("--shape", nargs=4, action="append", metavar=("ROWS", "C", "DTYPE", "FORM"),
                   help="time these shapes in place of the list")
    args = p.parse_args(argv)
    shapes = [(int(r), int(c), d, f) for r, c, d, f in args.shape] if args.shape else SHAPES
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
