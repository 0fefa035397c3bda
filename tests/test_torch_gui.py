"""The port's GUI (``gui/app.py``) on the port's headless Open3D backend
(``gui/headless.py``): the cases of the JAX package's GUI tests (widget
wiring, layout, depth-unproject picking and vertex snap, overlays, arrow
orientation, the EditLog, the depth-masked picture) with worker threads
made synchronous and a ``tiny`` engine on the CPU; model selection from a
model directory, load and inversion; the headless depth image against the
JAX package's renderer; and import hygiene."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ishapediting_tpu.cli.edit import parse_edit_log as jparse_edit_log
from ishapediting_tpu.geometry.render import render_scene as jrender_scene
from ishapediting_tpu_torch.gui import headless
from ishapediting_tpu_torch.gui.headless import (
    AxisAlignedBoundingBox,
    Camera,
    SyntheticMouseEvent,
    TriangleMesh,
    install_headless_open3d,
)

# The app binds the ``open3d`` in sys.modules when it is first imported; the
# JAX package's GUI tests register their own backend under that name, so
# the port's goes in right before the port's app is imported.
install_headless_open3d()

import ishapediting_tpu_torch.gui.app as gui_app  # noqa: E402
from ishapediting_tpu_torch.cli.edit import parse_edit_log  # noqa: E402
from ishapediting_tpu_torch.config import preset  # noqa: E402
from ishapediting_tpu_torch.edit.engine import DragEngine  # noqa: E402
from ishapediting_tpu_torch.geometry.mesh import TriMesh  # noqa: E402
from ishapediting_tpu_torch.geometry.render import read_png, render_scene, write_png  # noqa: E402

torch.set_num_threads(2)

App = gui_app.App
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _SyncThread:
    """threading.Thread replacement that runs the target synchronously."""

    def __init__(self, target=None, daemon=None, args=(), kwargs=None):
        self._target, self._args, self._kwargs = target, args, kwargs or {}

    def start(self):
        self._target(*self._args, **self._kwargs)

    def join(self, timeout=None):
        pass


@pytest.fixture
def sync_threads(monkeypatch):
    """The App's worker threads run synchronously; other modules' threads
    (the orbax reader's and writer's pools) stay threads."""
    monkeypatch.setattr(gui_app, "threading", types.SimpleNamespace(Thread=_SyncThread))


@pytest.fixture
def app(tmp_path):
    models = tmp_path / "models"
    (models / "chairs").mkdir(parents=True)
    return App(models_root=str(models), device="cpu")


def tri_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0.5]], np.float64)
    f = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 4]], np.int32)
    return TriMesh(v, f)


def tiny_model_dir(root):
    """A random tiny model dir as ``cli.train --export_model_dir`` writes
    one (unet.orbax, decoder.orbax, statistics/)."""
    from ishapediting_tpu_torch.cli.train import export_model_dir

    cfg = preset("tiny")
    engine = DragEngine(cfg, seed=3, device="cpu")
    os.makedirs(root, exist_ok=True)
    dec_pt = os.path.join(root, "..", "dec.pt")
    torch.save(engine.decoder.state_dict(), dec_pt)
    export_model_dir(root, engine.unet.state_dict(), decoder_from=dec_pt, channels=cfg.latent_shape[-1])
    return engine


def test_app_holds_the_ports_backend():
    """The open3d modules the port's app bound are the port's headless
    backend, whichever backend was registered before."""
    assert gui_app.o3d.geometry.TriangleMesh is headless.TriangleMesh
    assert gui_app.gui.Application is headless.Application
    assert gui_app.rendering.Open3DScene is headless.Open3DScene
    assert gui_app.o3d.geometry.TriangleMesh.__module__ == "ishapediting_tpu_torch.gui.headless"


def test_construction_wires_all_widgets(app):
    assert app._model_combo.items == ["chairs"]
    for btn in (
        app._create_btn, app._load_btn, app._inv_btn, app._start_btn,
        app._stop_btn, app._reset_btn, app._clear_pnt_btn,
        app._save_mesh_btn, app._save_pic_btn,
    ):
        assert btn.on_clicked is not None
    # reference GUI defaults (main.py:102,105)
    assert app._grads_scale_edit.text_value == "1200"
    assert app._lambda_edit.text_value == "0.4"
    assert app._radius_edit.text_value == "12"
    assert app._scene.on_mouse is not None
    assert App(models_root="missing").device == "cuda"  # the card unless asked


def test_layout_splits_scene_and_panel(app):
    class Ctx:
        class theme:
            font_size = 14

    app.window.content_rect = gui_app.gui.Rect(0, 0, 1280, 800)
    app._on_layout(Ctx)
    assert app._scene.frame.width == 1280 - 16 * 14
    assert app._panel.frame.x == 1280 - 16 * 14
    assert app._scene.scene.render_size == (1280 - 16 * 14, 800)


def test_buttons_require_engine(app):
    app._create_btn.click()
    assert app._status.text == "select a model first"
    app._inv_btn.click()
    assert app._status.text == "select a model first"
    app._start_btn.click()
    assert app._status.text == "select a model first"


def test_update_mesh_adds_geometry_and_kdtree(app):
    mesh = tri_mesh()
    app.update_mesh(mesh)
    assert "mesh" in app._scene.scene.geometry
    assert app._scene.camera_setup is not None
    assert app._kdtree is not None
    app._scene.camera_setup = None
    app.update_mesh(mesh, update_camera=False)
    assert app._scene.camera_setup is None


def test_mouse_pick_snaps_to_vertex_and_alternates(app):
    mesh = tri_mesh()
    app.update_mesh(mesh)
    app._scene.scene.scene.depth_image = np.full((480, 640), 0.5, np.float32)
    app._scene.scene.camera.unproject_result = np.array([0.52, 0.48, 0.51])

    ev = SyntheticMouseEvent(x=100, y=120)
    assert app._mouse_event(ev) == gui_app.gui.Widget.EventCallbackResult.HANDLED
    assert len(app.source_pnt) == 1 and len(app.target_pnt) == 0
    np.testing.assert_array_equal(app.source_pnt[0], mesh.vertices[4])
    assert "src0" in app.drag_geometry

    app._scene.scene.camera.unproject_result = np.array([0.9, 0.05, 0.02])
    app._mouse_event(ev)
    assert len(app.target_pnt) == 1
    np.testing.assert_array_equal(app.target_pnt[0], mesh.vertices[1])
    assert "tgt0" in app.drag_geometry and "arrow0" in app.drag_geometry

    app._scene.scene.scene.depth_image = np.ones((480, 640), np.float32)
    app._mouse_event(ev)
    assert len(app.source_pnt) == 1  # background click ignored

    res = app._mouse_event(SyntheticMouseEvent(x=1, y=1, ctrl=False))
    assert res == gui_app.gui.Widget.EventCallbackResult.IGNORED


def test_clear_points_removes_overlays(app):
    app.update_mesh(tri_mesh())
    app.source_pnt.append(np.zeros(3))
    app.target_pnt.append(np.ones(3) * 0.2)
    app._redraw_points()
    assert app.drag_geometry
    app._clear_points()
    assert not app.drag_geometry and not app.source_pnt and not app.target_pnt


def test_make_arrow_orientation():
    """The arrow's +z axis rotates onto the drag direction."""
    src = np.array([0.1, 0.2, 0.3])
    dst = np.array([0.4, -0.1, 0.5])
    arrow = App._make_arrow(src, dst)
    rotations = [p for k, p in arrow.transforms if k == "rotate"]
    assert len(rotations) == 1
    direction = (dst - src) / np.linalg.norm(dst - src)
    np.testing.assert_allclose(rotations[0] @ [0, 0, 1], direction, atol=1e-8)
    translates = [p for k, p in arrow.transforms if k == "translate"]
    np.testing.assert_allclose(translates[-1], src)
    assert App._make_arrow(src, src) is None
    assert App._make_arrow(np.zeros(3), np.array([0, 0, 0.5])) is not None


def test_save_mesh_writes_editlog_both_packages_parse(app, tmp_path):
    app.update_mesh(tri_mesh())
    app.source_pnt = [np.array([0.1, 0.2, 0.3]), np.array([0.0, -0.5, 0.25])]
    app.target_pnt = [np.array([0.4, 0.5, 0.6]), np.array([0.0, -0.4, 0.25])]
    app._save_mesh_btn.click()
    dialog = app.window.dialog
    assert dialog is not None and dialog.mode == gui_app.gui.FileDialog.SAVE
    out = tmp_path / "edited.ply"
    dialog.on_done(str(out))
    assert TriMesh.read(str(out)).triangles.shape == (3, 3)
    log = (tmp_path / "EditLog").read_text()
    assert "Edit01:" in log and "[0.1, 0.2, 0.3]" in log and "[0.4, 0.5, 0.6]" in log
    assert "Scale:1200" in log and "Lambda:0.4" in log
    assert app.window.dialog is None
    for parse in (parse_edit_log, jparse_edit_log):
        e = parse(str(tmp_path / "EditLog"))["01"]
        np.testing.assert_allclose(e["sources"], np.stack(app.source_pnt), atol=1e-7)
        np.testing.assert_allclose(e["targets"], np.stack(app.target_pnt), atol=1e-7)
        assert (e["scale"], e["lam"]) == (1200.0, 0.4)


def test_read_png_matches_pillow(tmp_path):
    """``read_png`` decodes what ``write_png`` writes as Pillow does, and
    refuses a PNG that ``write_png`` would not write."""
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), rgb)
    Image.fromarray(rgb[:, :, 0]).save(tmp_path / "grey.png")
    with pytest.raises(ValueError, match="8-bit RGB"):
        read_png(str(tmp_path / "grey.png"))


def test_save_picture_masks_background_white(app, tmp_path):
    app._scene.scene.scene.color_image = np.full((2, 2, 3), 10, np.uint8)
    app._scene.scene.scene.depth_image = np.array([[1.0, 0.5], [0.2, 1.0]], np.float32)
    app._save_pic_btn.click()
    out = tmp_path / "shot.png"
    app.window.dialog.on_done(str(out))
    img = read_png(str(out))
    np.testing.assert_array_equal(img[0, 0], [255, 255, 255])
    np.testing.assert_array_equal(img[1, 1], [255, 255, 255])
    np.testing.assert_array_equal(img[0, 1], [10, 10, 10])


class _FakeEngine:
    def __init__(self):
        self.train_flag = True
        self.w = None
        self.mesh = tri_mesh()
        self.mesh0 = tri_mesh()
        self.reset_called = False
        self.cleared = False
        self.config = preset("tiny")

    def reset_params(self):
        self.reset_called = True

    def clear_params(self):
        self.cleared = True


def test_stop_and_reset(app):
    eng = _FakeEngine()
    app.engine = eng
    app._stop_btn.click()
    assert eng.train_flag is False
    app.source_pnt = [np.zeros(3)]
    app._reset_btn.click()
    assert eng.reset_called and not app.source_pnt


def test_start_requires_points_and_latent(app, sync_threads):
    app.engine = _FakeEngine()
    app._start_btn.click()
    assert app._status.text == "pick matching source/target points first"
    app.source_pnt = [np.zeros(3)]
    app.target_pnt = [np.ones(3) * 0.1]
    app._start_btn.click()
    assert app._status.text == 'click "Create Mesh" or "Inversion" first'
    app.engine.w = np.zeros(3)
    app._edit_steps_edit.text_value = "two"
    app._start_btn.click()
    assert app._status.text == "invalid Steps 'two'"


def test_create_mesh_and_drag_with_real_engine(app, sync_threads):
    """Create-mesh and drag against a real tiny engine on the CPU."""
    app.engine = DragEngine(preset("tiny"), seed=0, device="cpu")
    app._latent_edit.text_value = "3"
    app._create_btn.click()
    assert app._status.text == "mesh created"
    assert app.mesh is not None and "mesh" in app._scene.scene.geometry
    assert app.engine.w is not None

    app.source_pnt = [app.mesh.vertices[0].astype(np.float64)]
    app.target_pnt = [app.mesh.vertices[0] + np.array([0.15, 0, 0])]
    app._radius_edit.text_value = "3"
    app._grads_scale_edit.text_value = "20"
    app._lambda_edit.text_value = "0.2"
    app._start_btn.click()
    assert app.engine.config.edit.r1 == 3
    assert app._status.text.startswith("edit done (motion loss ")
    assert app._progress.value > 0.99

    app._edit_steps_edit.text_value = "3"
    app._start_btn.click()
    assert app.engine.last_phase_walls["edit_steps"] == 3
    app._edit_steps_edit.text_value = ""
    app._start_btn.click()
    assert app.engine.last_phase_walls["edit_steps"] == app.engine.config.edit.w_time


def test_select_model_load_mesh_and_invert(tmp_path, sync_threads):
    """The combobox loads a model directory into an engine of the App's
    device and config; Load Mesh normalizes a mesh file; Inversion fits it
    (Fit steps field) and then reuses the cached fit."""
    models = tmp_path / "models"
    want = tiny_model_dir(str(models / "tiny"))
    app = App(models_root=str(models), device="cpu", config=preset("tiny"))
    assert app._model_combo.items == ["tiny"]
    app._model_combo.on_selection_changed("tiny", 0)
    assert app._status.text == "tiny loaded"
    assert app.engine.device.type == "cpu" and app.engine.config == preset("tiny")
    for k, v in want.unet.state_dict().items():
        torch.testing.assert_close(app.engine.unet.state_dict()[k], v, rtol=0, atol=0)

    x = np.linspace(-1, 1, 20)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    from ishapediting_tpu_torch.geometry.marching import grid_to_mesh

    sphere = grid_to_mesh((0.6 - np.sqrt(X**2 + Y**2 + Z**2)).astype(np.float32))
    sphere.vertices = sphere.vertices * 3.0  # out of [-1, 1]: normalized on load
    shapes = tmp_path / "shapes"
    shapes.mkdir()
    sphere.write(str(shapes / "ball.off"))
    app._load_btn.click()
    app.window.dialog.on_done(str(shapes / "ball.off"))
    assert np.abs(app.mesh.vertices).max() <= 1.0 and app.real_path == str(shapes)

    app._fit_steps_edit.text_value = "x"
    app._inv_btn.click()
    assert app._status.text == "invalid Fit steps 'x'"
    app._fit_steps_edit.text_value = "3"
    app._inv_btn.click()
    assert app._status.text == "inversion done"
    assert app.engine.last_phase_walls["fit_steps"] == 3
    assert (shapes / "tri_feat.npy").exists() and app.engine.w is not None
    app._inv_btn.click()  # the cached fit is inverted again, not refit
    assert app._status.text == "inversion done" and app.engine.last_phase_walls["path"] == "inversion"


# ---------------------------------------------------------------------------
# the headless backend
# ---------------------------------------------------------------------------


def test_render_scene_depth_contract():
    """Depth is 1.0 exactly on background, < 1.0 on the surface; the color
    buffer is shaded where the depth says something was hit."""
    sph = TriangleMesh.create_sphere(0.5)
    rgb, depth = render_scene(
        [(sph.vertices, sph.triangles, (0.8, 0.2, 0.2))],
        width=96, height=64, eye=(0, 0, 2.5), center=(0, 0, 0), fov_deg=40, near=0.5, far=5.0,
    )
    assert rgb.shape == (64, 96, 3) and depth.shape == (64, 96) and depth.dtype == np.float32
    assert depth[0, 0] == 1.0
    np.testing.assert_allclose(depth[32, 48], (2.5 - 0.5 - 0.5) / 4.5, atol=0.02)
    assert (rgb[32, 48] != [255, 255, 255]).any()
    np.testing.assert_array_equal(rgb[0, 0], [255, 255, 255])
    assert ((depth < 1.0) == (rgb != 255).any(axis=-1)).mean() > 0.99


def test_headless_render_matches_jax_renderer(app):
    """The app's scene (mesh, handle spheres, arrow) through the headless
    camera: colour and depth equal to the JAX package's renderer on the same
    geometries and camera."""
    mesh = tri_mesh()
    app.update_mesh(mesh)
    app.source_pnt, app.target_pnt = [mesh.vertices[4]], [mesh.vertices[1]]
    app._redraw_points()
    scene = app._scene.scene
    rgb, depth = scene.render()
    cam = scene.camera
    w, h = scene.render_size
    want_rgb, want_depth = jrender_scene(
        [(g.vertices, g.triangles, g.color) for g in scene.geometry.values()],
        width=w, height=h, eye=tuple(cam.eye), center=tuple(cam.center), up=tuple(cam.up),
        fov_deg=cam.fov_deg, near=cam.near, far=cam.far, light_dir=tuple(scene.scene.light_dir),
        background=tuple(scene.background[:3]),
    )
    np.testing.assert_array_equal(depth, want_depth)
    np.testing.assert_array_equal(rgb, want_rgb)
    assert (depth < 1.0).sum() > 100 and len(scene.geometry) == 4


def test_camera_project_unproject_roundtrip():
    cam = Camera()
    cam.frame_bounds(60, AxisAlignedBoundingBox([-1, -1, -1], [1, 1, 1]), np.zeros(3))
    pts = np.random.default_rng(0).uniform(-0.8, 0.8, (32, 3))
    w, h = 640, 480
    for p, (px, py, d) in zip(pts, cam.project(pts, w, h)):
        np.testing.assert_allclose(cam.unproject(px, py, d, w, h), p, atol=1e-9)


def test_pick_through_real_render(tmp_path):
    """Ctrl-click on the rendered mesh, no depth or unproject overrides,
    lands on (and snaps to) the clicked vertex."""
    app = App(models_root=str(tmp_path), device="cpu")
    v = np.array([[0, 0, 0], [0.6, 0, 0], [0, 0.6, 0], [0, 0, 0.6], [0.4, 0.4, 0.4]], np.float64)
    f = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 4], [2, 3, 4], [1, 3, 4]], np.int32)
    app.update_mesh(TriMesh(v, f))
    cam = app._scene.scene.camera
    w, h = app._scene.scene.render_size
    cent = v[f].mean(axis=1)
    click_world = cent[int(np.argmax((cent - cam.center) @ (cam.eye - cam.center)))]
    expected = v[int(np.argmin(np.linalg.norm(v - click_world, axis=1)))]
    px, py, _ = cam.project(click_world, w, h)[0]
    res = app._mouse_event(SyntheticMouseEvent(x=int(round(px)), y=int(round(py))))
    assert res == gui_app.gui.Widget.EventCallbackResult.HANDLED
    np.testing.assert_allclose(app.source_pnt[0], expected, atol=1e-12)
    app._mouse_event(SyntheticMouseEvent(x=1, y=1))
    assert len(app.source_pnt) == 1 and len(app.target_pnt) == 0


def test_save_picture_renders_real_image(tmp_path):
    app = App(models_root=str(tmp_path), device="cpu")
    v = np.array([[0, 0, 0], [0.8, 0, 0], [0, 0.8, 0], [0, 0, 0.8]], np.float64)
    f = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    app.update_mesh(TriMesh(v, f))
    app._save_pic_btn.click()
    out = tmp_path / "shot.png"
    app.window.dialog.on_done(str(out))
    img = read_png(str(out))
    assert img.shape == (480, 640, 3)
    assert (img != 255).any()
    np.testing.assert_array_equal(img[0, 0], [255, 255, 255])


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_new_modules_import_without_jax():
    res = _run(
        "import sys\n"
        "import ishapediting_tpu_torch.compat, ishapediting_tpu_torch.cli.decode, "
        "ishapediting_tpu_torch.cli.eval, ishapediting_tpu_torch.core.solver_eval, "
        "ishapediting_tpu_torch.geometry.recon, ishapediting_tpu_torch.geometry.arap, "
        "ishapediting_tpu_torch.gui, ishapediting_tpu_torch.gui.headless, ishapediting_tpu_torch.gui.app, "
        "ishapediting_tpu_torch.utils.images\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ishapediting_tpu', 'PIL', 'open3d')]\n"
        "assert not bad, bad\n"
    )
    assert res.returncode == 0, res.stderr


def test_app_without_open3d_raises_on_construction():
    """Without open3d (and no headless backend installed) the app module
    imports and ``App()`` names both ways out."""
    res = _run(
        "import sys\n"
        "sys.modules['open3d'] = None\n"
        "import ishapediting_tpu_torch.gui.app as a\n"
        "try:\n"
        "    a.App(models_root='.')\n"
        "except ImportError as e:\n"
        "    assert 'install_headless_open3d' in str(e) and 'open3d' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('App() without open3d did not raise')\n"
    )
    assert res.returncode == 0, res.stderr
