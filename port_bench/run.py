"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic mix and the mix's kind of request
(``spec.py``, ``kinds/<kind>.py``), makes the weights and inputs from the
seed, sets the program up and warms up every shape the cell's traffic uses
(``setup_s``, from process start), then lets the kind send its requests
until one crosses ``--seconds`` (each request's wall, this process's CPU
seconds and the machine's stolen seconds go to standard error). With
``--trace 1`` a profiler records a stretch of the window and the cell's
per-layer metrics are read from it; otherwise its end-to-end metrics are
reported. Once the window has closed and the program's state is freed, a
sample of its answers is compared with the plain reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``), and last ``check``, each compared number beside its
limit; the same numbers end standard error. Without a CUDA card, or with
fewer cards than the cell asks for, or with JAX or the JAX package loaded,
it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.time()  # before the heavy imports: set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench.spec import ROOT  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ishapediting_tpu")
THREADS = 4


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``ishapediting_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"


def host_seconds():
    """(this process's CPU seconds, the machine's stolen seconds): read
    around each request, to tell a slow host from slow work."""
    steal = float("nan")
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return time.process_time(), steal


def measure(spec, seed: int, seconds: float, trace: bool, device="cuda", t0: float = T0) -> dict:
    """Set the cell up, run its window and its check; the result object."""
    import torch

    from port_bench import check
    from port_bench.spec import readers
    from port_bench.trace import Capture

    torch.set_num_threads(THREADS)
    dev = torch.device(device)
    capture = Capture(dev.type == "cuda") if trace else None
    cell = spec.kind.Cell(spec.config, spec.traffic, seed, dev, capture)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t0
    host = [host_seconds()]
    n, window_s, ends = cell.window(seconds, after=lambda: host.append(host_seconds()))
    peak = max(torch.cuda.max_memory_allocated(), 0) if dev.type == "cuda" else 0
    if capture is not None:
        capture.stop()
    line = {"correct": False, "attempted": n, "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        tr = capture.reduce(cell.outer_span)
        ctx = cell.per_layer_context(tr)
        ctx["trace"] = tr
        for name, read in readers([m.name for m in spec.per_layer]).items():
            v = read(ctx)
            if v is not None:
                unit = next(m.unit for m in spec.per_layer if m.name == name)
                line["metrics"][name] = {"value": float(v), "unit": unit}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
    else:
        values = cell.end_to_end(n, window_s)
        values["setup_s"] = setup_s
        for m in spec.end_to_end:
            if m.name in values:
                line["metrics"][m.name] = {"value": float(values[m.name]), "unit": m.unit}
    line["device"] = device_info
    if trace:
        line["breakdown"] = tr.breakdown()
    for phase, secs in cell.phases.items():
        print(f"setup {phase} {secs:.3f} s", file=sys.stderr)
    for name, k in (("request_s", None), ("cpu_s", 0), ("steal_s", 1)):
        vals = ([b - a for a, b in zip([0.0] + ends, ends)] if k is None
                else [b[k] - a[k] for a, b in zip(host, host[1:])])
        print(f"window {name} " + " ".join(f"{v:.3f}" for v in vals), file=sys.stderr)
    cell.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = check.readings(cell)
    line["correct"], line["check"] = check.judge(values, spec.traffic.get("limits", {}))
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    from port_bench import spec as spec_mod

    spec = spec_mod.load(args.workload)
    import torch

    from port_bench import system  # noqa: F401  (the program: a checkout without it fails here)

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"port_bench: the cell needs {spec.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = measure(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
