"""Headless drag editing from the command line.

Generates a shape (or loads an x_T, or fits a real mesh), applies drag edits
from the command line or an EditLog file, and writes the meshes and the
EditLog. The EditLog is the reference GUI's audit file (reference:
main.py:400-404)::

    Edit01:
    [x, y, z]  [x, y, z]
    Scale:1200   Lambda:0.4

Examples (on the card unless ``--device cpu``)::

    python -m ishapediting_tpu_torch.cli.edit --random_init --preset chairs \
        --latent_seed 7 --source 0.1 0.2 0.3 --target 0.1 0.5 0.3 \
        --scale 1200 --lam 0.4 --out edited/

    python -m ishapediting_tpu_torch.cli.edit --model_dir models/chairs \
        --mesh chair.obj --edit_log EditLog --edit_id 01 --out edited/

Seeds give other shapes than the JAX package's CLI: the random streams
differ.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Dict, Optional

import numpy as np


def parse_edit_log(path: str) -> Dict[str, Dict]:
    """The reference EditLog format -> {edit_id: {sources, targets, scale, lam}}."""
    edits: Dict[str, Dict] = {}
    current: Optional[str] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("Edit") and line.endswith(":"):
                current = line[4:-1]
                edits[current] = {"sources": [], "targets": [], "scale": 600.0, "lam": 0.2}
            elif line.startswith("Scale:"):
                parts = line.replace("Lambda:", " ").replace("Scale:", " ").split()
                edits[current]["scale"] = float(parts[0])
                edits[current]["lam"] = float(parts[1])
            elif line.startswith("[") and current is not None:
                mid = line.index("]") + 1  # "[x, y, z]  [x, y, z]"
                edits[current]["sources"].append(ast.literal_eval(line[:mid]))
                edits[current]["targets"].append(ast.literal_eval(line[mid:].strip()))
    for e in edits.values():
        e["sources"] = np.asarray(e["sources"], np.float32)
        e["targets"] = np.asarray(e["targets"], np.float32)
    return edits


def write_edit_log(path: str, edit_id: str, sources, targets, scale: float, lam: float) -> None:
    """Append an edit record (reference: main.py:400-404)."""
    with open(path, "a+") as f:
        f.write(f"Edit{edit_id}:\n")
        for s, t in zip(np.asarray(sources), np.asarray(targets)):
            f.write(f"{s.tolist()}  {t.tolist()}\n")
        f.write(f"Scale:{scale:g}   Lambda:{lam:g}\n\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Headless drag editing")
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--preset", type=str, default="chairs",
                   help="chairs|cars|planes|tiny (tiny = CPU smoke config)")
    p.add_argument("--num_steps", type=int, default=200)
    # shape source (choose one)
    p.add_argument("--latent_seed", type=int, default=None, help="generate a shape from this seed")
    p.add_argument("--latent_npy", type=str, default=None,
                   help="x_T latent .npy ([1,C,H,W] NCHW or [1,H,W,C])")
    p.add_argument("--mesh", type=str, default=None,
                   help="real mesh: fit + invert (caches tri_feat.npy beside it)")
    # edit spec
    p.add_argument("--source", type=float, nargs=3, action="append", default=[])
    p.add_argument("--target", type=float, nargs=3, action="append", default=[])
    p.add_argument("--edit_log", type=str, default=None)
    p.add_argument("--edit_id", type=str, default=None)
    p.add_argument("--scale", type=float, default=600.0)
    p.add_argument("--lam", type=float, default=0.2)
    p.add_argument("--edit_steps", type=int, default=None,
                   help="fast editing: respace the w_time edit window to this many guided "
                        "steps (resample noise); default: every step")
    p.add_argument("--fit_steps", type=int, default=None,
                   help="fast fitting: respace the guided real-shape fit to this many steps; "
                        "default: the full chain")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="edited")
    p.add_argument("--render", action="store_true",
                   help="also save before/after PNG renders (headless)")
    p.add_argument("--feat_dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="guidance-feature cache dtype; default: keep the config's")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # validate the edit spec before any model work
    if args.edit_log:
        edits = parse_edit_log(args.edit_log)
        if args.edit_id is not None:
            edits = {args.edit_id: edits[args.edit_id]}
    else:
        if not args.source or len(args.source) != len(args.target):
            raise SystemExit("need matching --source/--target triplets or --edit_log")
        edits = {"00": {"sources": np.asarray(args.source, np.float32),
                        "targets": np.asarray(args.target, np.float32),
                        "scale": args.scale, "lam": args.lam}}

    from ishapediting_tpu_torch.config import preset, with_feat_store_dtype
    from ishapediting_tpu_torch.edit.engine import DragEngine, latent_from_nchw

    config = with_feat_store_dtype(preset(args.preset, args.num_steps), args.feat_dtype)
    if args.model_dir:
        engine = DragEngine.from_model_dir(args.model_dir, config=config, device=args.device)
    elif args.random_init:
        engine = DragEngine(config, seed=args.seed, device=args.device)
    else:
        raise SystemExit("need --model_dir or --random_init")
    os.makedirs(args.out, exist_ok=True)

    # --- the editable latent state -------------------------------------
    if args.mesh is not None:
        cache = os.path.join(os.path.dirname(args.mesh) or ".", "tri_feat.npy")
        if os.path.isfile(cache):
            print(f"using cached fit {cache}")
            engine.fit_real_shape(tri_feat_path=cache)
        else:
            if args.fit_steps is not None and args.fit_steps < engine.sched.num_timesteps:
                print(f"fast fitting: {args.fit_steps} of {engine.sched.num_timesteps} guided steps")
            print("fitting mesh to triplane (classifier-guided) ...")
            engine.fit_real_shape(mesh_path=args.mesh, path=os.path.dirname(args.mesh) or ".",
                                  seed=args.seed, fit_steps=args.fit_steps)
    elif args.latent_npy is not None:
        latent = np.load(args.latent_npy)
        if latent.shape[1] == engine.config.latent_shape[-1]:
            latent = latent_from_nchw(latent)
        engine.update_latent_params(latent=latent, seed=args.seed)
    else:
        seed = args.latent_seed if args.latent_seed is not None else args.seed
        print(f"generating shape from seed {seed} ...")
        engine.update_latent_params(seed=seed)

    engine.mesh0.write(os.path.join(args.out, "original.obj"))
    if args.render:
        from ishapediting_tpu_torch.geometry.render import render_mesh

        render_mesh(engine.mesh0, save_path=os.path.join(args.out, "original.png"))
    for edit_id, spec in edits.items():
        print(f"edit {edit_id}: {len(spec['sources'])} handle(s), "
              f"scale={spec['scale']}, lambda={spec['lam']}")
        mesh = engine.drag_edit(
            spec["sources"], spec["targets"], scale=spec["scale"], cof=spec["lam"],
            seed=args.seed, edit_steps=args.edit_steps,
            progress_callback=lambda p: print(f"  progress {p:5.1%}", flush=True),
        )
        summary = engine.drag_loss_summary()
        if summary is not None:
            print(f"  motion loss {summary['motion_first']:.4f} -> {summary['motion_last']:.4f}, "
                  f"mask loss {summary['mask_last']:.4f} (per-step guidance diagnostics)")
        out_path = os.path.join(args.out, f"edit{edit_id}.obj")
        mesh.write(out_path)
        if args.render:
            from ishapediting_tpu_torch.geometry.render import render_mesh

            render_mesh(mesh, save_path=os.path.join(args.out, f"edit{edit_id}.png"))
        write_edit_log(os.path.join(args.out, "EditLog"), edit_id, spec["sources"],
                       spec["targets"], spec["scale"], spec["lam"])
        engine.reset_params()
        print(f"  wrote {out_path}")
    return engine


if __name__ == "__main__":
    main()
