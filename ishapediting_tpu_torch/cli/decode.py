"""Decode saved triplane ``.npy`` files to meshes (reference:
triplane_decoder/visualize.py ``main()``, :108-128).

    python -m ishapediting_tpu_torch.cli.decode --input samples/triplanes/0.npy \
        --output out.obj --model_path models/chairs/chairs_decoder.pt --res 256

Takes the reference layout ([96,H,W] or [3,32,H,W] NCHW, physical scale:
what ``cli.generate`` and the reference's ``generate.py`` save) and NHWC
[3,H,W,32]. The decoder comes from a torch ``.pt`` state_dict or the JAX
package's orbax directory, a category ``--model_dir`` (its
``decoder.orbax`` preferred over a ``.pt``, as the JAX package's CLI does)
or ``--random_init`` for smoke tests. Several inputs
decode in one process, ``--smooth`` applies the engine's Laplacian
smoothing and ``--cross_section`` saves the mid-plane occupancy image
(reference: visualize.py:10-33). Decoding runs on the card unless
``--device cpu``; marching and smoothing run on the host.
"""

from __future__ import annotations

import argparse
import os
import time

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Decode triplane .npy files to .obj meshes")
    p.add_argument("--input", type=str, nargs="+", required=True,
                   help="triplane .npy file(s): [96,H,W] / [3,32,H,W] NCHW "
                        "(reference contract) or [3,H,W,32] NHWC")
    p.add_argument("--output", type=str, required=True,
                   help=".obj path (single input) or directory (writes <stem>.obj per input)")
    p.add_argument("--model_path", type=str, default=None,
                   help="decoder checkpoint: a torch .pt state_dict or the JAX package's orbax dir")
    p.add_argument("--model_dir", type=str, default=None,
                   help="category dir: finds the decoder like cli.generate (io/model_dir.py)")
    p.add_argument("--random_init", action="store_true", help="random decoder weights (smoke tests)")
    p.add_argument("--res", type=int, default=256, help="occupancy grid resolution (reference uses 256)")
    p.add_argument("--smooth", type=int, default=0,
                   help="Laplacian smoothing iterations (0 = raw marching output, as the "
                        "reference's create_obj)")
    p.add_argument("--cross_section", type=str, default=None,
                   help="also save a mid-plane occupancy .png (reference: visualize.py cross_section)")
    p.add_argument("--cross_section_axis", type=str, default="z", choices=("x", "y", "z"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def _load_decoder(args, in_channels: int, device):
    import torch

    from ishapediting_tpu_torch.io.convert import load_torch_decoder
    from ishapediting_tpu_torch.io.model_dir import discover_model_dir
    from ishapediting_tpu_torch.io.orbax import load_decoder
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, init_decoder_

    if args.model_path:
        if os.path.isdir(args.model_path):
            return load_decoder(args.model_path, TriplaneDecoder(in_channels)).to(device)
        return load_torch_decoder(args.model_path, TriplaneDecoder(in_channels)).to(device)
    if args.model_dir:
        info = discover_model_dir(args.model_dir)
        if info.decoder_orbax:
            return load_decoder(info.decoder_orbax, TriplaneDecoder(in_channels)).to(device)
        if info.decoder_ckpt:
            return load_torch_decoder(info.decoder_ckpt, TriplaneDecoder(in_channels)).to(device)
        raise SystemExit(f"no decoder checkpoint found under {args.model_dir}")
    if args.random_init:
        # the input's plane channels: tiny-preset planes carry 2, the published decoder 32
        with torch.device(device):
            dec = TriplaneDecoder(in_channels)
        return init_decoder_(dec, torch.Generator(device=device).manual_seed(args.seed))
    raise SystemExit("need --model_path, --model_dir or --random_init")


def _load_planes(path: str):
    """npy -> [3, H, W, C] float32 NHWC (takes the reference's NCHW)."""
    from ishapediting_tpu_torch.io.planes import load_planes

    try:
        return load_planes(path)
    except ValueError as exc:
        raise SystemExit(str(exc)) from exc


def main(argv=None):
    """Returns the meshes written, one per input."""
    args = build_parser().parse_args(argv)
    from ishapediting_tpu_torch.compat import create_obj, cross_section
    from ishapediting_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    all_planes = [_load_planes(p) for p in args.input]
    decoder = _load_decoder(args, all_planes[0].shape[-1], device).eval().requires_grad_(False)

    out_is_dir = len(args.input) > 1 or os.path.isdir(args.output)
    if out_is_dir:
        os.makedirs(args.output, exist_ok=True)
    meshes = []
    for path, planes in zip(args.input, all_planes):
        stem = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output, stem + ".obj") if out_is_dir else args.output
        t0 = time.time()
        mesh = create_obj(decoder, planes, res=args.res)
        if args.smooth > 0:
            mesh = mesh.filter_smooth_simple(args.smooth)
        mesh.write(out_path)
        meshes.append(mesh)
        print(f"{path} -> {out_path} ({len(mesh.vertices)} verts, {round(time.time() - t0, 3)}s)")
        if args.cross_section:
            cs_path = os.path.join(args.output, stem + "_cross.png") if out_is_dir else args.cross_section
            cross_section(decoder, planes, res=min(args.res, 512), axis=args.cross_section_axis,
                          save_path=cs_path)
            print(f"cross-section -> {cs_path}")
    return meshes


if __name__ == "__main__":
    main()
