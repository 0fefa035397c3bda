"""Port parity, the serving surface on ``preset("tiny")``: ``cli.serve``'s
``EditServer`` answers every command of the JAX package's ``EditServer``
with the same keys (both servers load one model directory of ``.pt``
checkpoints, so their weights are the same) and the same numbers where the
state is shared (status, the first drag step's motion loss, metrics, the
rendered PNG, the EditLog, morph frames from latent files); unknown and
underscored commands are refused; ``serve_loop`` takes a ``stop`` between
progress events. Then ``geometry/metrics.py`` and ``geometry/render.py``
against the JAX package's on the same meshes and seeds, and the PNG written
without an imaging package read back.

Tolerances: metrics equal (the same NumPy and SciPy calls); renders
pixel-equal; motion loss rel 1e-4; morph frames atol 1e-3 (as in
test_torch_morph.py).
"""

import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ishapediting_tpu.cli.serve import EditServer as JEditServer
from ishapediting_tpu.geometry import metrics as jmetrics
from ishapediting_tpu.geometry import render as jrender
from ishapediting_tpu.geometry.mesh import TriMesh as JTriMesh
from ishapediting_tpu_torch.cli import serve as tserve
from ishapediting_tpu_torch.cli.serve import EditServer, serve_loop
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.geometry import metrics as tmetrics
from ishapediting_tpu_torch.geometry import render as trender
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from torch_parity_helpers import decoder_pair, jax_step_noises, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")
SHAPE = (1,) + CFG.latent_shape


def sphere(r, c=(0.0, 0.0, 0.0), res=20):
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return grid_to_mesh((r - np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)).astype(np.float32))


def as_jax(m):
    return JTriMesh(m.vertices.copy(), m.triangles.copy())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A reference-layout category directory: UNet and decoder ``.pt``
    state_dicts of random weights and the statistics."""
    root = tmp_path_factory.mktemp("models")
    _, _, unet = unet_pair(dict(vars(CFG.unet)), seed=71)
    _, tdec = decoder_pair(CFG.plane_channels, seed=72)
    os.makedirs(root / "ddpm_ckpts")
    torch.save(unet.state_dict(), root / "ddpm_ckpts" / "ema_0.pt")
    torch.save(tdec.state_dict(), root / "decoder.pt")
    stats = root / "statistics" / "tiny"
    os.makedirs(stats)
    rng = np.random.default_rng(73)
    c = CFG.latent_shape[-1]
    lower = rng.uniform(-1.5, -0.5, c).astype(np.float32)
    np.save(stats / "lower_bound.npy", lower)
    np.save(stats / "upper_bound.npy", lower + rng.uniform(1.0, 3.0, c).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def servers(model_dir):
    """(JAX server, port server), both after ``load_model`` of one
    directory: the same weights and statistics."""
    pair = JEditServer(), EditServer(device="cpu")
    resp = [s.handle({"cmd": "load_model", "model_dir": model_dir, "preset": "tiny"}) for s in pair]
    assert resp[0] == resp[1] == {"model_dir": model_dir, "ok": True, "cmd": "load_model"}
    assert pair[1].engine.device.type == "cpu"
    return pair


def run_both(servers, req):
    out = []
    for s in servers:
        events = []
        out.append((s.handle(dict(req), emit=events.append), events))
    return out


def test_every_command_answers_with_jax_keys(servers, tmp_path):
    """The same script of requests on both servers: every response has the
    JAX server's keys and both are ok, every stream the same event kinds."""
    mesh_path = str(tmp_path / "sphere.obj")
    sphere(0.5).write(mesh_path)
    src = [[0.2, 0.0, 0.0]]
    tgt = [[0.35, 0.0, 0.0]]
    script = [
        {"cmd": "ping"},
        {"cmd": "sample", "seed": 3},
        {"cmd": "status"},
        {"cmd": "drag", "sources": src, "targets": tgt, "scale": 20, "cof": 0.2, "chunk": 2},
        {"cmd": "save_mesh", "path": "{out}/m/edit.obj"},
        {"cmd": "save_mesh", "path": "{out}/orig.obj", "which": "original"},
        "small mesh",  # the JAX package rasterizes one triangle per iteration
        {"cmd": "render", "path": "{out}/shot.png", "size": 32},
        {"cmd": "metrics", "points": 500},
        {"cmd": "edit_log", "path": "{out}/EditLog"},
        {"cmd": "reset"},
        {"cmd": "stop"},
        {"cmd": "fit", "mesh_path": mesh_path, "workdir": "{out}/fit", "fit_steps": 3},
        {"cmd": "morph", "seed_a": 1, "seed_b": 2, "frames": 2, "smooth": 0, "out_dir": "{out}/morph"},
        {"cmd": "generate", "num_samples": 2, "batch_size": 2, "sampler": "ddim", "num_steps": 3,
         "seed": 1, "out_dir": "{out}/gen", "decode": True, "shape_resolution": 16},
        {"cmd": "clear"},
        {"cmd": "status"},
        {"cmd": "quit"},
    ]
    for req in script:
        if req == "small mesh":
            servers[0].engine.mesh, servers[1].engine.mesh = as_jax(sphere(0.5)), sphere(0.5)
            continue
        (jr, je), (tr, te) = [
            (s.handle(json.loads(json.dumps(req).replace("{out}", str(tmp_path / name))), emit=ev.append), ev)
            for s, name, ev in ((servers[0], "j", []), (servers[1], "t", []))
        ]
        assert jr["ok"] and tr["ok"], (req["cmd"], jr, tr)
        assert set(tr) == set(jr), (req["cmd"], sorted(tr), sorted(jr))
        assert [e.get("event") for e in te] == [e.get("event") for e in je], req["cmd"]
        if req["cmd"] == "status":
            assert tr == jr
    for sub in ("", "m", "morph", "gen/triplanes", "gen/objects", "fit"):
        assert sorted(os.listdir(tmp_path / "t" / sub)) == sorted(os.listdir(tmp_path / "j" / sub)), sub


def test_numbers_match_jax_on_shared_state(servers, tmp_path):
    """Both engines generate from one x_T (JAX's step noises injected into
    the port): the drag's first motion loss, the EditLog, the metrics of
    the same two meshes, the rendered PNG and morph frames of the same
    latent files agree."""
    jsrv, tsrv = servers
    x_T = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
    jsrv.engine.update_latent_params(latent=x_T, seed=0)
    tsrv.engine.update_latent_params(latent=x_T, seed=0, noises=jax_step_noises(
        jax.random.PRNGKey(1), SHAPE, tsrv.engine.sched.num_timesteps))
    drag = {"cmd": "drag", "sources": [[0.3, 0.1, -0.2]], "targets": [[0.5, 0.1, -0.2]], "scale": 40,
            "cof": 0.3, "chunk": 2}
    (jr, _), (tr, _) = run_both(servers, drag)
    assert tr["motion_loss_first"] == pytest.approx(jr["motion_loss_first"], rel=1e-4)
    log = [str(tmp_path / f"{n}.log") for n in "jt"]
    for s, p in zip(servers, log):
        s.handle({"cmd": "edit_log", "path": p, "edit_id": "07"})
    assert open(log[1]).read() == open(log[0]).read()

    a, b = sphere(0.5), sphere(0.45, (0.1, 0.0, 0.0))
    jsrv.engine.mesh, jsrv.engine.mesh0 = as_jax(a), as_jax(b)
    tsrv.engine.mesh, tsrv.engine.mesh0 = a, b
    (jr, _), (tr, _) = run_both(servers, {"cmd": "metrics", "points": 3000})
    assert tr == jr
    for s, n in zip(servers, "jt"):
        assert s.handle({"cmd": "render", "path": str(tmp_path / f"{n}.png"), "size": 40})["ok"]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))

    lat = np.random.default_rng(6).uniform(-0.8, 0.8, (2,) + SHAPE).astype(np.float32)
    for k in range(2):
        np.save(tmp_path / f"l{k}.npy", lat[k])
    frames = []
    for s, n in zip(servers, "jt"):
        r = s.handle({"cmd": "morph", "latent_a": str(tmp_path / "l0.npy"), "latent_b": str(tmp_path / "l1.npy"),
                      "frames": 2, "out_dir": str(tmp_path / f"morph_{n}"), "smooth": 0})
        assert r["ok"] and r["frames"] == 2
        frames.append(np.load(tmp_path / f"morph_{n}" / "latents.npy"))
    np.testing.assert_allclose(frames[1], frames[0], atol=1e-3)


@pytest.mark.parametrize("req", [{"cmd": "nope"}, {}, {"cmd": "_cmd_ping"}, {"cmd": "__class__"},
                                 {"cmd": "_require_engine"}, {"cmd": "handle"}])
def test_unknown_and_underscored_commands_refused(req):
    for s in (JEditServer(), EditServer(device="cpu")):
        r = s.handle(dict(req))
        assert r["ok"] is False and "unknown cmd" in r["error"], (s, r)


def test_engine_and_state_guards():
    s = EditServer(device="cpu")
    assert s.handle({"cmd": "status"}) == {"engine": None, "ok": True, "cmd": "status"}
    r = s.handle({"cmd": "sample"})
    assert r["ok"] is False and "no engine" in r["error"]
    r = s.handle({"cmd": "init_random", "preset": "tiny", "seed": 1, "w_time": 4, "shape_resolution": 16})
    assert r == {"preset": "tiny", "ok": True, "cmd": "init_random"}
    assert s.engine.config.edit.w_time == 4 and s.engine.device.type == "cpu"
    for cmd in ("save_mesh", "render", "metrics", "drag"):
        r = s.handle({"cmd": cmd, "path": "x", "sources": [[0, 0, 0]], "targets": [[0, 0, 0]]})
        assert r["ok"] is False and "no mesh" in r["error"], cmd
    r = s.handle({"cmd": "edit_log", "path": "x"})
    assert r["ok"] is False and "no drag" in r["error"]
    s.handle({"cmd": "sample", "seed": 2})
    r = s.handle({"cmd": "drag", "sources": [[0, 0, 0]], "targets": []})
    assert r["ok"] is False and "equal-length" in r["error"]
    r = s.handle({"cmd": "generate", "sampler": "magic"})
    assert r["ok"] is False and "sampler" in r["error"]


def test_serve_loop_protocol():
    reqs = ['{"cmd": "ping"}', "not json", '{"cmd": "status"}', '{"cmd": "quit"}', '{"cmd": "ping"}']
    out = io.StringIO()
    serve_loop(io.StringIO("\n".join(reqs) + "\n"), out, EditServer(device="cpu"))
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert lines[0] == {"pong": True, "ok": True, "cmd": "ping"}
    assert lines[1]["ok"] is False and "bad json" in lines[1]["error"]
    assert lines[2]["cmd"] == "status"
    assert lines[3] == {"bye": True, "ok": True, "cmd": "quit"}
    assert len(lines) == 4  # nothing after quit
    out = io.StringIO()
    serve_loop(io.StringIO(""), out)
    assert out.getvalue() == ""


def test_serve_loop_takes_stop_between_progress_events():
    """A ``ping`` and then a ``stop`` wait behind a drag: the first is read
    at a progress event and answered after the drag, the second stops the
    drag at the next progress event."""
    reqs = [{"cmd": "init_random", "preset": "tiny", "seed": 2}, {"cmd": "sample", "seed": 1},
            {"cmd": "drag", "sources": [[0.2, 0, 0]], "targets": [[0.4, 0, 0]], "scale": 20, "chunk": 1},
            {"cmd": "ping"}, {"cmd": "stop"}, {"cmd": "status"}, {"cmd": "quit"}]
    out = io.StringIO()
    serve_loop(io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n"), out, EditServer(device="cpu"))
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    kinds = [line.get("event") or line["cmd"] for line in lines]
    assert kinds == ["init_random", "sample", "progress", "progress", "stop", "drag", "ping", "status", "quit"]
    drag = lines[5]
    assert drag["ok"] and drag["stopped_early"]
    assert all(line.get("ok", True) for line in lines)


def test_serve_main_reads_stdin(monkeypatch):
    stdin = io.StringIO('{"cmd": "init_random", "preset": "tiny"}\n{"cmd": "status"}\n')
    stdout = io.StringIO()
    monkeypatch.setattr(sys, "stdin", stdin)
    monkeypatch.setattr(sys, "stdout", stdout)
    tserve.main(["--device", "cpu"])
    lines = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert lines[0]["ok"] and lines[1]["engine"]["image_size"] == 16


def test_serve_main_takes_cpu_flag(monkeypatch):
    """``--cpu``, the JAX package's flag, runs the server on the CPU as
    ``--device cpu`` does."""
    stdin = io.StringIO('{"cmd": "init_random", "preset": "tiny"}\n{"cmd": "quit"}\n')
    stdout = io.StringIO()
    monkeypatch.setattr(sys, "stdin", stdin)
    monkeypatch.setattr(sys, "stdout", stdout)
    tserve.main(["--cpu"])
    lines = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert len(lines) == 2 and all(line["ok"] for line in lines)


# ---------------------------------------------------------------------------
# metrics and rendering
# ---------------------------------------------------------------------------


def test_metrics_match_jax(tmp_path):
    a, b = sphere(0.5), sphere(0.42, (0.08, -0.05, 0.0))
    ja, jb = as_jax(a), as_jax(b)
    a.write(str(tmp_path / "a.obj"))
    for fn in ("chamfer_distance", "hausdorff_distance", "iou"):
        want = getattr(jmetrics, fn)(ja, jb, point_num=3000, seed=4)
        assert getattr(tmetrics, fn)(a, b, point_num=3000, seed=4) == want, fn
        want = getattr(jmetrics, fn)(str(tmp_path / "a.obj"), jb, point_num=3000, seed=4)
        assert getattr(tmetrics, fn)(str(tmp_path / "a.obj"), b, point_num=3000, seed=4) == want, fn
    pa = np.array([[0.4, 0.0, 0.0], [0.0, 0.45, 0.1]])
    for metric in ("IoU", "L2"):
        want = jmetrics.local_distance(ja, jb, pa, pa + 0.05, r=0.15, point_num=2000, metric=metric, seed=3)
        got = tmetrics.local_distance(a, b, pa, pa + 0.05, r=0.15, point_num=2000, metric=metric, seed=3)
        assert got == want, metric
    assert tmetrics.iou(a, a, point_num=1000) == 1.0
    with pytest.raises(NotImplementedError):
        tmetrics.local_distance(a, b, pa, pa, r=0.1, point_num=10, metric="x")
    with pytest.raises(ValueError, match="same shape"):
        tmetrics.local_distance(a, b, pa, pa[:1], r=0.1)


def scene():
    """A sphere, an empty geometry and a random triangle soup drawn twice in
    two colours: overlaps, exact depth ties, degenerate and off-screen
    triangles."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-1.2, 1.2, (200, 3))
    t = rng.integers(0, 200, (150, 3))
    t[:5, 1] = t[:5, 0]  # degenerate
    s = sphere(0.6)
    return [(s.vertices, s.triangles, None), (np.zeros((0, 3)), np.zeros((0, 3), np.int64), None),
            (v, t, (0.9, 0.1, 0.1)), (v, t, (0.1, 0.9, 0.1))]


@pytest.mark.parametrize("size,eye", [((48, 48), (1.8, 1.4, 1.8)), ((64, 40), (1.8, 1.4, 1.8)),
                                      ((40, 40), (0.2, 0.1, 0.3))])
def test_render_scene_pixel_equal_to_jax(size, eye):
    """The native z-buffer loop (rows split over threads) against JAX's
    per-triangle Python loop, pixel for pixel and depth for depth."""
    w, h = size
    want = jrender.render_scene(scene(), width=w, height=h, eye=eye)
    got = trender.render_scene(scene(), width=w, height=h, eye=eye)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] < 1.0).sum() > 100
    empty = trender.render_scene([], width=8, height=6)
    assert empty[0].shape == (6, 8, 3) and (empty[0] == 255).all() and (empty[1] == 1.0).all()


def test_render_mesh_png_reads_back(tmp_path):
    m = sphere(0.55, (0.1, 0.0, 0.0))
    path = str(tmp_path / "shot.png")
    img = trender.render_mesh(m, size=56, save_path=path)
    np.testing.assert_array_equal(img, jrender.render_mesh(as_jax(m), size=56))
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    back = Image.open(path)
    assert back.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(back), img)
