"""Offline quality evaluation CLI: the reference's paper-eval metrics as a
command (reference: meshProcess.py:18-105, which ships the metric functions
with no in-repo caller).

    # one pair
    python -m ishapediting_tpu_torch.cli.eval --mesh_a ref.obj --mesh_b ours.obj

    # two directories, paired by sorted filename
    python -m ishapediting_tpu_torch.cli.eval --dir_a ref_out/ --dir_b our_out/ \
        --metrics chamfer hausdorff iou --out report.json

    # local agreement around the handle points of an edit
    python -m ishapediting_tpu_torch.cli.eval --mesh_a before.obj --mesh_b after.obj \
        --metrics local --edit_log edited/EditLog --edit_id 01 --local_r 0.1

    # per-solver mesh quality against the dense DDIM chain, on the card
    python -m ishapediting_tpu_torch.cli.eval --solver_sweep --model_dir models/chairs \
        --budgets 50 25 16 12

Prints one JSON object per pair plus a ``summary`` row of means, and writes
the full report to ``--out`` when given. The metrics run on the host
(geometry/metrics.py): symmetric squared Chamfer, symmetric Hausdorff,
volumetric IoU, and local IoU/L2 in [-r, r]^3 neighborhoods around paired
handle points (the edit-locality measure of the paper's tables). The solver
sweep samples on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_MESH_EXTS = (".obj", ".ply", ".off", ".stl")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mesh-set quality metrics")
    p.add_argument("--mesh_a", type=str, default=None, help="single mesh A")
    p.add_argument("--mesh_b", type=str, default=None, help="single mesh B")
    p.add_argument("--dir_a", type=str, default=None, help="directory of meshes A")
    p.add_argument("--dir_b", type=str, default=None, help="directory of meshes B")
    p.add_argument("--metrics", nargs="+", default=["chamfer", "hausdorff", "iou"],
                   choices=["chamfer", "hausdorff", "iou", "local"])
    p.add_argument("--point_num", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--edit_log", type=str, default=None,
                   help="EditLog file with the handle points for 'local'")
    p.add_argument("--edit_id", type=str, default=None,
                   help="edit id inside the EditLog (default: first)")
    p.add_argument("--local_r", type=float, default=0.1,
                   help="half-width of the local neighborhood cube")
    p.add_argument("--local_metric", type=str, default="IoU", choices=["IoU", "L2"])
    p.add_argument("--out", type=str, default=None, help="write report JSON here")
    # -- solver sweep mode (core/solver_eval.py) ---------------------------
    p.add_argument("--solver_sweep", action="store_true",
                   help="ignore mesh pairs; instead sample a model with ddpm/ddimN/dpmN at "
                        "--budgets and report per-solver mesh Chamfer/IoU against the "
                        "dense-chain DDIM solution")
    p.add_argument("--model_dir", type=str, default=None, help="category dir for --solver_sweep")
    p.add_argument("--random_init", action="store_true",
                   help="random weights for --solver_sweep (smoke only)")
    p.add_argument("--preset", type=str, default=None,
                   help="pipeline config for --solver_sweep (chairs|cars|planes|tiny); with "
                        "--model_dir it overrides the default chairs config; for "
                        "--random_init it defaults to chairs")
    p.add_argument("--budgets", type=int, nargs="+", default=[50, 25, 16, 12])
    p.add_argument("--sweep_seeds", type=int, default=3, help="non-empty reference draws to evaluate")
    p.add_argument("--max_attempts", type=int, default=None,
                   help="total prior draws before giving up (default 8x seeds)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the solver sweep: cuda (default) or cpu")
    return p


def _list_meshes(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.lower().endswith(_MESH_EXTS)]


def _pairs(args) -> List[Tuple[str, str]]:
    if args.mesh_a and args.mesh_b:
        return [(args.mesh_a, args.mesh_b)]
    if args.dir_a and args.dir_b:
        a, b = _list_meshes(args.dir_a), _list_meshes(args.dir_b)
        if len(a) != len(b):
            raise SystemExit(f"--dir_a has {len(a)} meshes but --dir_b has {len(b)}; "
                             "sets must pair up by sorted filename")
        if not a:
            raise SystemExit("no meshes found (.obj/.ply/.off/.stl)")
        return list(zip(a, b))
    raise SystemExit("give either --mesh_a/--mesh_b or --dir_a/--dir_b")


def _handles(args) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    if args.edit_log is None:
        return None
    from ishapediting_tpu_torch.cli.edit import parse_edit_log

    edits = parse_edit_log(args.edit_log)
    if not edits:
        raise SystemExit(f"no edits found in {args.edit_log}")
    edit_id = args.edit_id or next(iter(edits))
    if edit_id not in edits:
        raise SystemExit(f"edit id {edit_id!r} not in {sorted(edits)}")
    return edits[edit_id]["sources"], edits[edit_id]["targets"]


def evaluate_pair(
    mesh_a,
    mesh_b,
    metrics: List[str],
    *,
    point_num: int = 100_000,
    seed: int = 0,
    handles: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    local_r: float = 0.1,
    local_metric: str = "IoU",
) -> Dict[str, float]:
    """The pair's metrics; each mesh (a path or a TriMesh) is read once."""
    from ishapediting_tpu_torch.geometry import metrics as gm
    from ishapediting_tpu_torch.geometry.mesh import TriMesh

    a = TriMesh.read(mesh_a) if isinstance(mesh_a, str) else mesh_a
    b = TriMesh.read(mesh_b) if isinstance(mesh_b, str) else mesh_b
    row: Dict[str, float] = {}
    if "chamfer" in metrics:
        row["chamfer"] = gm.chamfer_distance(a, b, point_num, seed=seed)
    if "hausdorff" in metrics:
        row["hausdorff"] = gm.hausdorff_distance(a, b, point_num, seed=seed)
    if "iou" in metrics:
        row["iou"] = gm.iou(a, b, point_num, seed=seed)
    if "local" in metrics:
        if handles is None:
            raise SystemExit("'local' needs --edit_log (handle points)")
        src, tgt = handles
        row[f"local_{local_metric.lower()}"] = gm.local_distance(
            a, b, src, tgt, local_r, point_num=min(point_num, 20_000), metric=local_metric, seed=seed,
        )
    return row


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _solver_sweep(args):
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.core.solver_eval import solver_mesh_sweep
    from ishapediting_tpu_torch.edit.engine import DragEngine

    if args.model_dir:
        engine = DragEngine.from_model_dir(
            args.model_dir, config=preset(args.preset) if args.preset else None, device=args.device,
        )
    elif args.random_init:
        engine = DragEngine(preset(args.preset or "chairs"), seed=args.seed, device=args.device)
    else:
        raise SystemExit("--solver_sweep needs --model_dir or --random_init")
    report = solver_mesh_sweep(
        engine, n_seeds=args.sweep_seeds, seed0=100 + args.seed, budgets=tuple(args.budgets),
        max_attempts=args.max_attempts, point_num=args.point_num,
    )
    print(json.dumps(report))
    if args.out:
        _write_json(args.out, report)
    return report


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.solver_sweep:
        return _solver_sweep(args)
    handles = _handles(args)
    if "local" in args.metrics and handles is None:
        raise SystemExit("'local' metric needs --edit_log")
    rows = []
    for a, b in _pairs(args):
        row = {"mesh_a": a, "mesh_b": b}
        row.update(evaluate_pair(
            a, b, args.metrics, point_num=args.point_num, seed=args.seed, handles=handles,
            local_r=args.local_r, local_metric=args.local_metric,
        ))
        print(json.dumps(row))
        rows.append(row)
    numeric = [k for k in rows[0] if isinstance(rows[0][k], float)]
    summary = {"summary": True, "pairs": len(rows),
               **{k: float(np.mean([r[k] for r in rows])) for k in numeric}}
    print(json.dumps(summary))
    if args.out:
        _write_json(args.out, {"rows": rows, "summary": summary})
    return rows, summary


if __name__ == "__main__":
    main()
