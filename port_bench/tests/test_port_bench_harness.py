"""The harness: files found by name (and a cell added as files alone), the
import check, a run without a card, the result line, the generator, the
weights, the trace reduction and the readers."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import cells
from port_bench import spec as spec_mod
from port_bench.run import FORBIDDEN, forbidden_modules, measure
from port_bench.spec import HERE, ROOT
from port_bench.tests.mini import MINI_ARCH, benchmark, mini
from port_bench.trace import Trace
from port_bench.traffic import Traffic, sub_seed

BENCH = spec_mod.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD = benchmark()  # with the held-out cells


def test_every_file_of_the_benchmark_is_found_by_name():
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
    for w in HELD["workloads"]:
        s = spec_mod.load(w["name"], HELD)
        assert s.config["name"] == w["config"] and issubclass(s.kind.Cell, cells.Cell)
        assert "setup_s" in [m.name for m in s.end_to_end] and len(s.end_to_end) >= 2
        assert s.per_layer
    for m in HELD["per_layer"]:
        assert callable(spec_mod.reader(m["name"]))
        assert any(e["name"] == m["moves"] for e in HELD["end_to_end"])


def test_a_cell_config_traffic_and_metric_added_as_files_alone(tmp_path):
    """A new configuration, mix, per-layer metric and cell in a copy of the
    benchmark's folder, with no file that is there edited, runs."""
    root = tmp_path / "port_bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "configs" / "nfd_chairs.json").read_text())
    cfg.update(name="nfd_wide_heads", num_head_channels=128)
    (root / "configs" / "nfd_wide_heads.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "gen_ddim50.json").read_text())
    mix.update(batch=8, steps=10)
    (root / "traffic" / "gen_ddim10.json").write_text(json.dumps(mix))
    (root / "metrics" / "calls_traced.gen.py").write_text(
        "def read(ctx):\n    return float(ctx['trace'].calls) if ctx.get('kind') == 'generate' else None\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [{"name": "nfd_wide_heads", "source": "x", "reduced": [],
                                            "file": "port_bench/configs/nfd_wide_heads.json", "why": "x"}]
    bench["workloads"] = BENCH["workloads"] + [{"name": "wide-gen-b8", "config": "nfd_wide_heads",
                                                "traffic": "gen_ddim10", "chips": 1, "why": "x"}]
    bench["per_layer"] = BENCH["per_layer"] + [{"name": "calls_traced.gen", "unit": "calls", "better": "higher",
                                                "source": "program_counter", "layer": "unet",
                                                "moves": "gen_samples_per_s", "workloads": ["wide-gen-b8"]}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["wide-gen-b8"])
                           if m["name"] == "gen_samples_per_s" else m for m in BENCH["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    s = spec_mod.load("wide-gen-b8", str(tmp_path / "BENCHMARK.json"), str(root))
    assert s.config["num_head_channels"] == 128 and s.traffic["batch"] == 8
    assert [m.name for m in s.per_layer] == ["calls_traced.gen"]
    assert spec_mod.reader("calls_traced.gen", str(root))({"kind": "edit"}) is None
    s.config.update({"image_size": 16, "in_channels": 6, "num_channels": 32, "num_res_blocks": 1,
                     "channel_mult": [1, 2], "attention_resolutions": "8", "num_head_channels": 16,
                     "plane_channels": 2})
    s.traffic.update(batch=2, steps=3, limits={"rel_err": 1.0})
    line = measure(s, 99, 0.1, False, device="cpu", t0=time.time())
    assert line["correct"] and set(line["metrics"]) == {"gen_samples_per_s", "setup_s"}


NEW_KIND = '''
"""``denoise``: one client sends batches of noisy latents; a request is one
UNet call through the engine's model function."""

import torch

from port_bench import cells


class Cell(cells.Cell):
    outer_span = "denoise"

    @property
    def rows_per_request(self):
        return self.p["batch"]

    def setup(self):
        from port_bench import system

        self.make_weights()
        self.config = system.pipeline_config(self.cfg, "10")
        self.engine = system.engine(self.config, self.weights, self.device)
        self.mf = self.engine.model_fn(feat=False)
        with torch.no_grad():
            self.mf(*self._inputs(-1))
        self.phase("warm-up")

    def _inputs(self, i):
        g = torch.Generator(device=self.device).manual_seed(self.traffic.request(i).seed)
        x = torch.randn((self.p["batch"],) + self.latent_shape, generator=g, device=self.device)
        return x, torch.full((self.p["batch"],), self.p["t"], device=self.device)

    def request(self, i):
        with torch.no_grad():
            out, _ = self.mf(*self._inputs(i))
        self.outputs[i] = out[..., : self.latent_shape[-1]].cpu().numpy()

    def end_to_end(self, n, window_s):
        return {"denoise_calls_per_s": n / window_s}

    def per_layer_context(self, trace):
        return {"kind": "denoise"}

    def free(self):
        super().free()
        self.engine = self.mf = None

    def reference(self, chosen, quant=None):
        net = self.reference_net(quant)
        rows = []
        for r, row in chosen:
            x, t = self._inputs(r)
            with torch.no_grad():
                out, _ = net(cells.nchw(x[row:row + 1]), t[row:row + 1])
            rows.append(out[0, : self.latent_shape[-1]])
        return {"edited": torch.stack(rows)}


FAULTS = {}
'''


def test_a_kind_of_request_added_as_a_file_alone(tmp_path):
    """A new kind of request (``kinds/<kind>.py``), with its mix, cell and
    end-to-end metric, in a copy of the benchmark's folder with no file
    that is there edited, runs and is checked against the reference."""
    root = tmp_path / "port_bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "kinds" / "denoise.py").write_text(NEW_KIND)
    (root / "traffic" / "denoise_b2.json").write_text(json.dumps(
        {"kind": "denoise", "loop": "closed", "clients": 1, "batch": 2, "t": 500, "check": {"rows": 2},
         "limits": {"rel_err": 1e-4}}))
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{"name": "chairs-denoise-b2", "config": "nfd_chairs",
                                                "traffic": "denoise_b2", "chips": 1, "why": "x"}]
    bench["end_to_end"] = BENCH["end_to_end"] + [{"name": "denoise_calls_per_s", "unit": "calls/s",
                                                  "better": "higher", "bound": 0.05, "source": "host_clock",
                                                  "workloads": ["chairs-denoise-b2"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    s = spec_mod.load("chairs-denoise-b2", str(tmp_path / "BENCHMARK.json"), str(root))
    assert s.kind.Cell.outer_span == "denoise" and s.kind.FAULTS == {}
    s.config.update(MINI_ARCH, compute_dtype="float32")
    line = measure(s, 2 ** 31 + 3, 0.1, False, device="cpu", t0=time.time())
    assert line["correct"], line["check"]
    assert set(line["metrics"]) == {"denoise_calls_per_s", "setup_s"}


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "ishapediting_tpu"}
    for name in ("ishapediting_tpu_torch.fake", "jaxtyping_fake", "flaxen_fake"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not set(forbidden_modules()) - {m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN}
    assert "ishapediting_tpu_torch" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "ishapediting_tpu.fake_sub", object())
    assert "ishapediting_tpu" in forbidden_modules()


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; from port_bench import run, check, calibrate, cells, system, trace; "
            "from port_bench.tests.mini import mini; "
            "run.measure(mini('chairs-edit-b16', {'rel_err': 1, 'guide_err': 1}), 3, 0.1, True, "
            "device='cpu', t0=time.time()); print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in ("__future__", "dataclasses", "math", "typing", "numpy",
                                             "torch", "port_bench"), (f, mod)
                assert not mod.startswith("port_bench.") or mod.startswith("port_bench.reference"), (f, mod)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a run here would measure")


def test_a_run_without_a_card_fails_and_prints_no_result(no_card):
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", CELLS[0], "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(HERE, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "ishapediting_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", [w["name"] for w in HELD["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(cell, trace):
    line = measure(mini(cell), 2 ** 33 + 1, 0.1, trace, device="cpu", t0=time.time())
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == keys
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        s = spec_mod.load(cell, HELD)
        assert set(line["metrics"]) == {m.name for m in s.end_to_end}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    assert len(json.dumps(line)) < 600


def test_a_traced_line_stays_short():
    """The longest a --trace 1 line gets: every per-layer metric of a cell
    and full breakdown lists of the longest names."""
    from port_bench.trace import NAME_CHARS, OP_CHARS, TOP

    MOST = max(len(spec_mod.load(w["name"], HELD).per_layer) for w in HELD["workloads"])
    op, gap = "x" * NAME_CHARS, "drag_edit_batched / " + "y" * OP_CHARS
    line = {"correct": True, "attempted": 12, "failed": 0,
            "metrics": {f"{m['name']}{k}": {"value": 1234.56789012345, "unit": m["unit"]}
                        for k, m in enumerate(HELD["per_layer"][:MOST])},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                       "memory_peak_bytes": 51203283968, "busy_s": 1.23456789012345, "window_s": 1.3456789012345},
            "breakdown": {"device_ops": [[op, 0.123456789012345]] * TOP,
                          "idle_gaps": [[gap, 0.00123456789012345]] * TOP},
            "check": {"rel_err": {"value": 0.0123456789012345, "limit": 0.05},
                      "guide_err": {"value": 0.0123456789012345, "limit": 0.05}}}
    assert len(json.dumps(line)) < 2000


def test_the_generator_is_a_function_of_the_seed():
    p = spec_mod.load("chairs-edit-b16", HELD).traffic
    a, b, c = Traffic(p, 2 ** 31 + 7), Traffic(p, 2 ** 31 + 7), Traffic(p, 12)
    ra, rb, rc = a.request(3), b.request(3), c.request(3)
    assert ra.seed == rb.seed != rc.seed
    assert np.array_equal(ra.sources, rb.sources) and not np.array_equal(ra.sources, rc.sources)
    assert ra.sources.shape == rc.sources.shape == (p["shapes"], p["handles_per_shape"], 3)
    d = np.linalg.norm(ra.targets - ra.sources, axis=-1)
    assert (d >= p["shift_min"] - 1e-6).all() and (d <= p["shift_max"] + 1e-6).all()
    assert (np.abs(ra.sources) <= p["source_box"]).all()
    picks = a.check_picks(5, 16, 2)
    assert picks == b.check_picks(5, 16, 2) and len(picks) == 2 and 4 in [r for r, _ in picks]
    assert sub_seed(1, "x") != sub_seed(1, "y") and 0 <= sub_seed(2 ** 40, "x") < 2 ** 63


def test_weights_carry_signal_and_follow_the_seed():
    from port_bench.reference.unet import Arch
    from port_bench.weights import make_weights

    arch = Arch.from_config(mini("chairs-gen-b32").config)
    w1, w2, w3 = (make_weights(arch, s, "cpu") for s in (5, 5, 6))
    for k, v in w1.items():
        assert v.abs().min() >= 0 and v.std() > 0, k
        assert torch.equal(v, w2[k]) and not torch.equal(v, w3[k])
    assert w1["out.2.weight"].abs().max() > 0 and w1["input_blocks.1.0.out_layers.3.weight"].abs().max() > 0


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_reduction():
    """Spans by correlation (a backward launched from autograd's thread
    counts to the span the main thread waits in), busy time as a union,
    idle gaps named by span and launching op, and a kernel with no launch
    record taking the span before it."""
    ev = [
        _ev("user_annotation", "bench:drag_edit_batched", 0, 100),
        _ev("user_annotation", "bench:unet", 10, 20),
        _ev("cpu_op", "aten::conv", 12, 5), _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
        _ev("cpu_op", "aten::add", 20, 5), _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=2),
        _ev("cpu_op", "autograd::mm", 50, 5, tid=2), _ev("cuda_runtime", "cudaLaunchKernel", 51, 1, tid=2, corr=3),
        _ev("kernel", "void gn_stats_kernel<bf16>", 30, 10, corr=1),
        _ev("kernel", "attention_kernel", 35, 10, corr=2),
        _ev("kernel", "sm90_xmma_dgrad", 60, 20, corr=3),
        _ev("kernel", "no_launch_record", 80, 5),
    ]
    t = Trace(ev)
    t.steps = 1
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((45 - 30 + 20 + 5) * 1e-6)
    assert t.device_ms(span="unet") == pytest.approx(0.020)
    assert t.device_ms(outside="unet") == pytest.approx(0.025)
    assert t.device_ms(names=("gn_stats_kernel",)) == pytest.approx(0.010)
    assert t.gaps["unet / aten::conv"] == pytest.approx(30e-6)
    assert t.gaps["drag_edit_batched / autograd::mm"] == pytest.approx(15e-6)
    assert t.gaps["after the last launch"] == pytest.approx(15e-6)
    assert t.launches == 3
    b = t.breakdown()
    assert b["device_ops"][0] == ["sm90_xmma_dgrad", pytest.approx(20e-6)]


def test_readers_read_their_own_cells():
    from port_bench import flops
    from port_bench.reference.unet import Arch

    ev = [_ev("user_annotation", "bench:unet", 0, 10), _ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
          _ev("kernel", "gn_norm_kernel", 5, 1000, corr=1), _ev("kernel", "attention_kernel", 1005, 1000),
          _ev("cuda_runtime", "cudaDeviceSynchronize", 11, 3000)]
    t = Trace(ev)
    arch = Arch.from_config(spec_mod.load("chairs-gen-b32").config)
    ctx = {"kind": "generate", "trace": t, "flops_per_call": flops.forward_flops(arch, 32),
           "unit_calls": flops.forward_calls(arch, 32)}
    t.calls = t.steps = 1
    for m in HELD["per_layer"]:
        v = spec_mod.reader(m["name"])(ctx)
        if m["name"].endswith(".gen"):
            assert v is not None and v >= 0, m["name"]
        else:
            assert v is None, m["name"]
    assert spec_mod.reader("unet_device_ms.gen")(ctx) == pytest.approx(2.0)
    assert spec_mod.reader("device_idle_pct.gen")(ctx) == pytest.approx(100 * (1 - 2000 / 3011))
