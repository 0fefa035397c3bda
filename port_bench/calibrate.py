"""Readings that set a cell's limits, at the cell's own size, in one process:
for each seed, the cell set up afresh (weights from the seed), one request,
then the program's numbers against the reference and, for the first
``--control`` seeds, the control's: the reference computed with fp8 (e4m3,
one scale per tensor) operands in every convolution, dense layer and
attention product, the precision below the configuration's bf16 torso,
against the fp32 reference. With ``--fault <name>`` the program runs with
that fault of its kind (``FAULTS`` of ``kinds/<kind>.py``) planted, and the
readings are the fault's.

    python3 -m port_bench.calibrate --workload <cell> --seeds 11 12 ... --control 3 [--fault half_batch]

One JSON line per seed, then one summary line: the largest program reading
and the smallest control reading of each number (with a fault: the
smallest reading under it).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from port_bench import check
from port_bench.reference.unet import fp8_quant
from port_bench.run import cache_dirs
from port_bench.spec import load


def one_seed(spec, seed: int, control: bool, device="cuda", fault: str = None) -> dict:
    planted = contextlib.nullcontext()
    if fault is not None:
        import pytest

        planted = pytest.MonkeyPatch.context()
    with planted as mp:
        if fault is not None:
            spec.kind.FAULTS[fault](mp)
        cell = spec.kind.Cell(spec.config, spec.traffic, seed, torch.device(device), None)
        cell.setup()
        cell.open_window()
        cell.request(0)
        cell.free()
    gc.collect()
    chosen = cell.picks()
    ref = check.reference(cell, chosen)
    out = {"seed": seed, "picks": chosen, fault or "program": cell.numbers(cell.answers(chosen), ref)}
    if control:
        out["control"] = cell.numbers(list(check.reference(cell, chosen, fp8_quant)["edited"]), ref)
    del cell, ref
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds (the first) that also run the control")
    p.add_argument("--fault", default=None, help="a fault of the cell's kind to plant")
    args = p.parse_args(argv)
    cache_dirs()
    spec = load(args.workload)
    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for k, seed in enumerate(args.seeds):
        rows.append(one_seed(spec, seed, k < args.control, fault=args.fault))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"program_max": {}, "control_min": {}, "fault_min": {}}
    for r in rows:
        for side, key, pick in (("program", "program_max", max), ("control", "control_min", min),
                                (args.fault, "fault_min", min)):
            for name, v in r.get(side, {}).items():
                summary[key][name] = pick(summary[key].get(name, v), v)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
