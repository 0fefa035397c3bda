"""Open3D GUI for interactive drag editing (reference: main.py:12-631), over
the port's ``DragEngine``: generation, fitting and dragging run on the
engine's device (``cuda`` unless the caller asks for the CPU).

Capability map (reference -> here):
- model/category combobox + latent id field (main.py:25-67)
- drag parameter fields: scale / lambda / radius (main.py:70-134)
- Create Mesh / Inversion / Start / Stop / Reset buttons (main.py:254-315,441-486)
- mouse picking with depth unproject + nearest-vertex snap (main.py:488-527)
- source/target point + arrow overlays (main.py:539-590)
- save mesh + drag overlay + EditLog provenance (main.py:372-406)
- save picture with white background via depth mask (main.py:345-367)
- progress bar fed by the edit loop (main.py:226-231,471-477)

Threading follows the reference discipline exactly: all heavy work on
``threading.Thread`` workers, every widget mutation marshalled through
``gui.Application.instance.post_to_main_thread`` (SURVEY.md §5.2).

Requires ``open3d``, or the headless backend that
``ishapediting_tpu_torch.gui.headless.install_headless_open3d()`` registers
under that name before this module is imported (the module binds the
``open3d`` it finds at import; without one it imports, and ``App()``
raises). Everything here is a thin shell over DragEngine.
"""

from __future__ import annotations

import os
import threading

import numpy as np

try:  # optional dependency: App() raises without it
    import open3d as o3d
    import open3d.visualization.gui as gui
    import open3d.visualization.rendering as rendering
except ImportError as e:
    o3d = gui = rendering = None
    _OPEN3D_ERROR = e

from ishapediting_tpu_torch.cli.edit import write_edit_log
from ishapediting_tpu_torch.config import PipelineConfig, preset
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.render import write_png


def _to_o3d(mesh: TriMesh) -> "o3d.geometry.TriangleMesh":
    m = o3d.geometry.TriangleMesh()
    m.vertices = o3d.utility.Vector3dVector(mesh.vertices)
    m.triangles = o3d.utility.Vector3iVector(mesh.triangles)
    m.compute_vertex_normals()
    return m


class App:  # pragma: no cover - interactive
    MENU_QUIT = 1

    def __init__(
        self,
        models_root: str = "models",
        width: int = 1280,
        height: int = 800,
        device: str = "cuda",
        config: PipelineConfig | None = None,
    ):
        """``device`` and ``config`` (default ``preset("chairs")``) are those
        of the engine each selected model loads into."""
        if o3d is None:
            raise ImportError(
                "the GUI requires open3d (`pip install open3d`), or call "
                "ishapediting_tpu_torch.gui.headless.install_headless_open3d() before "
                "importing ishapediting_tpu_torch.gui.app; every capability is also "
                "available through ishapediting_tpu_torch.edit.engine.DragEngine and the "
                "ishapediting_tpu_torch.cli.* drivers"
            ) from _OPEN3D_ERROR
        self.models_root = models_root
        self.device = device
        self.config = config or preset("chairs")
        self.engine: DragEngine | None = None
        self.mesh: TriMesh | None = None
        self.source_pnt: list[np.ndarray] = []
        self.target_pnt: list[np.ndarray] = []
        self.drag_geometry: dict[str, o3d.geometry.TriangleMesh] = {}
        self.real_path = "."
        self.edit_count = 0
        self._kdtree = None

        gui.Application.instance.initialize()
        self.window = gui.Application.instance.create_window(
            "iShapEditing", width, height
        )
        em = self.window.theme.font_size

        self._scene = gui.SceneWidget()
        self._scene.scene = rendering.Open3DScene(self.window.renderer)
        self._scene.scene.set_background([1, 1, 1, 1])
        self._scene.scene.scene.set_sun_light([-1, -1, -1], [1, 1, 1], 60000)
        self._scene.scene.scene.enable_sun_light(True)
        self._scene.set_on_mouse(self._mouse_event)

        panel = gui.Vert(0.25 * em, gui.Margins(em, em, em, em))

        # --- model / latent ------------------------------------------------
        panel.add_child(gui.Label("Model"))
        self._model_combo = gui.Combobox()
        if os.path.isdir(models_root):
            for name in sorted(os.listdir(models_root)):
                if os.path.isdir(os.path.join(models_root, name)):
                    self._model_combo.add_item(name)
        self._model_combo.set_on_selection_changed(self._model_select_callback)
        panel.add_child(self._model_combo)

        row = gui.Horiz(0.25 * em)
        row.add_child(gui.Label("Latent id"))
        self._latent_edit = gui.TextEdit()
        self._latent_edit.text_value = "0"
        row.add_child(self._latent_edit)
        panel.add_child(row)

        self._create_btn = gui.Button("Create Mesh")
        self._create_btn.set_on_clicked(self._create_mesh_callback)
        panel.add_child(self._create_btn)

        self._load_btn = gui.Button("Load Mesh")
        self._load_btn.set_on_clicked(self._load_mesh_callback)
        panel.add_child(self._load_btn)

        self._inv_btn = gui.Button("Inversion")
        self._inv_btn.set_on_clicked(self._inversion_callback)
        panel.add_child(self._inv_btn)

        # --- drag params ----------------------------------------------------
        panel.add_child(gui.Label("Drag parameters"))
        row = gui.Horiz(0.25 * em)
        row.add_child(gui.Label("Scale"))
        self._grads_scale_edit = gui.TextEdit()
        self._grads_scale_edit.text_value = "1200"
        row.add_child(self._grads_scale_edit)
        row.add_child(gui.Label("Lambda"))
        self._lambda_edit = gui.TextEdit()
        self._lambda_edit.text_value = "0.4"
        row.add_child(self._lambda_edit)
        panel.add_child(row)
        row = gui.Horiz(0.25 * em)
        row.add_child(gui.Label("Radius"))
        self._radius_edit = gui.TextEdit()
        self._radius_edit.text_value = "12"
        row.add_child(self._radius_edit)
        # fast editing (framework extension): respaced guided-step count;
        # empty = full w_time walk (docs/PERF.md "Fast editing")
        row.add_child(gui.Label("Steps"))
        self._edit_steps_edit = gui.TextEdit()
        self._edit_steps_edit.text_value = ""
        row.add_child(self._edit_steps_edit)
        # fast fitting (framework extension): respaced guided-fit step
        # count; empty = full chain (docs/PERF.md "Fast fitting")
        row.add_child(gui.Label("Fit steps"))
        self._fit_steps_edit = gui.TextEdit()
        self._fit_steps_edit.text_value = ""
        row.add_child(self._fit_steps_edit)
        panel.add_child(row)

        self._start_btn = gui.Button("Start")
        self._start_btn.set_on_clicked(self._train_start_callback)
        panel.add_child(self._start_btn)
        self._stop_btn = gui.Button("Stop")
        self._stop_btn.set_on_clicked(self._train_stop_callback)
        panel.add_child(self._stop_btn)
        self._reset_btn = gui.Button("Reset")
        self._reset_btn.set_on_clicked(self._reset_callback)
        panel.add_child(self._reset_btn)
        self._clear_pnt_btn = gui.Button("Clear Points")
        self._clear_pnt_btn.set_on_clicked(self._clear_points)
        panel.add_child(self._clear_pnt_btn)

        # --- capture --------------------------------------------------------
        self._save_mesh_btn = gui.Button("Save Mesh")
        self._save_mesh_btn.set_on_clicked(self._save_mesh_callback)
        panel.add_child(self._save_mesh_btn)
        self._save_pic_btn = gui.Button("Save Picture")
        self._save_pic_btn.set_on_clicked(self._save_pic_callback)
        panel.add_child(self._save_pic_btn)

        self._progress = gui.ProgressBar()
        panel.add_child(self._progress)
        self._status = gui.Label("ready")
        panel.add_child(self._status)

        self.window.add_child(self._scene)
        self.window.add_child(panel)
        self._panel = panel
        self.window.set_on_layout(self._on_layout)

    # -- layout / status ----------------------------------------------------

    def _on_layout(self, layout_context):
        r = self.window.content_rect
        panel_width = 16 * layout_context.theme.font_size
        self._scene.frame = gui.Rect(r.x, r.y, r.width - panel_width, r.height)
        self._panel.frame = gui.Rect(
            r.get_right() - panel_width, r.y, panel_width, r.height
        )

    def _set_status(self, text: str):
        def fn():
            self._status.text = text

        gui.Application.instance.post_to_main_thread(self.window, fn)

    def _set_progress(self, value: float):
        def fn():
            self._progress.value = float(value)

        gui.Application.instance.post_to_main_thread(self.window, fn)

    # -- engine / mesh plumbing ---------------------------------------------

    def _ensure_engine(self) -> bool:
        if self.engine is None:
            self._set_status("select a model first")
            return False
        return True

    def _model_select_callback(self, name, index):
        def work():
            self._set_status(f"loading {name}...")
            self.engine = DragEngine.from_model_dir(
                os.path.join(self.models_root, name), config=self.config, device=self.device
            )
            self._set_status(f"{name} loaded")

        threading.Thread(target=work, daemon=True).start()

    def update_mesh(self, mesh: TriMesh, update_camera: bool = True):
        self.mesh = mesh

        def fn():
            self._scene.scene.clear_geometry()
            self.drag_geometry.clear()
            mat = rendering.MaterialRecord()
            mat.shader = "defaultLit"
            o3 = _to_o3d(mesh)
            self._scene.scene.add_geometry("mesh", o3, mat)
            if update_camera:
                bounds = o3.get_axis_aligned_bounding_box()
                self._scene.setup_camera(60, bounds, bounds.get_center())
            self._redraw_points()

        gui.Application.instance.post_to_main_thread(self.window, fn)
        from scipy.spatial import cKDTree

        self._kdtree = cKDTree(mesh.vertices)

    def _create_mesh_callback(self):
        if not self._ensure_engine():
            return

        def work():
            self._set_status("sampling...")
            seed = int(self._latent_edit.text_value or 0)
            self.engine.update_latent_params(seed=seed)
            self.update_mesh(self.engine.mesh)
            self._set_status("mesh created")

        threading.Thread(target=work, daemon=True).start()

    def _load_mesh_callback(self):
        picker = gui.FileDialog(gui.FileDialog.OPEN, "Select mesh...", self.window.theme)
        for ext in (".obj", ".ply", ".off", ".stl"):
            picker.add_filter(ext, ext[1:])
        picker.set_on_cancel(self.window.close_dialog)

        def done(filename):
            self.window.close_dialog()
            mesh = TriMesh.read(filename).normalize_unit_cube()
            self._clear_points()
            if self.engine is not None:
                self.engine.clear_params()
            self.update_mesh(mesh)
            self.real_path = os.path.dirname(filename)

        picker.set_on_done(done)
        self.window.show_dialog(picker)

    def _inversion_callback(self):
        if not self._ensure_engine():
            return

        steps_text = self._fit_steps_edit.text_value.strip()
        try:
            fit_steps = int(steps_text) if steps_text else None
        except ValueError:
            # don't silently run the full slow fit the user asked to skip
            self._set_status(f"invalid Fit steps {steps_text!r}")
            return

        def work():
            self._set_status("inversion...")
            cache = os.path.join(self.real_path, "tri_feat.npy")
            if os.path.isfile(cache):
                self.engine.fit_real_shape(tri_feat_path=cache)
            else:
                self.engine.fit_real_shape(
                    mesh=self.mesh, path=self.real_path, fit_steps=fit_steps
                )
            self.update_mesh(self.engine.mesh)
            self._set_status("inversion done")

        threading.Thread(target=work, daemon=True).start()

    # -- editing -------------------------------------------------------------

    def _train_start_callback(self):
        if not self._ensure_engine():
            return
        if not self.source_pnt or len(self.source_pnt) != len(self.target_pnt):
            self._set_status("pick matching source/target points first")
            return
        if self.engine.w is None:
            self._set_status('click "Create Mesh" or "Inversion" first')
            return
        try:
            r1 = int(self._radius_edit.text_value)
            if r1 != self.engine.config.edit.r1:
                import dataclasses

                self.engine.config = dataclasses.replace(
                    self.engine.config,
                    edit=dataclasses.replace(self.engine.config.edit, r1=r1),
                )
        except ValueError:
            pass

        steps_text = self._edit_steps_edit.text_value.strip()
        try:
            edit_steps = int(steps_text) if steps_text else None
        except ValueError:
            # don't silently run the full slow walk the user asked to skip
            self._set_status(f"invalid Steps {steps_text!r}")
            return

        def work():
            self._set_status("editing...")
            mesh = self.engine.drag_edit(
                np.stack(self.source_pnt),
                np.stack(self.target_pnt),
                scale=float(self._grads_scale_edit.text_value),
                cof=float(self._lambda_edit.text_value),
                edit_steps=edit_steps,
                progress_callback=self._set_progress,
            )
            self.update_mesh(mesh, update_camera=False)
            summary = self.engine.drag_loss_summary()
            if summary is not None:
                self._set_status(
                    f"edit done (motion loss {summary['motion_first']:.3f} -> "
                    f"{summary['motion_last']:.3f})"
                )
            else:
                self._set_status("edit done")

        threading.Thread(target=work, daemon=True).start()

    def _train_stop_callback(self):
        if self.engine is not None:
            self.engine.train_flag = False

    def _reset_callback(self):
        if self.engine is not None:
            self.engine.reset_params()
            if self.engine.mesh is not None:
                self.update_mesh(self.engine.mesh, update_camera=False)
        self._clear_points()

    # -- picking / overlays ---------------------------------------------------

    def _mouse_event(self, event):
        if (
            event.type == gui.MouseEvent.Type.BUTTON_DOWN
            and event.is_modifier_down(gui.KeyModifier.CTRL)
            and self.mesh is not None
        ):
            x = event.x - self._scene.frame.x
            y = event.y - self._scene.frame.y

            def depth_cb(depth_image):
                depth = np.asarray(depth_image)[int(y), int(x)]
                if depth == 1.0:
                    return
                world = self._scene.scene.camera.unproject(
                    x, y, depth, self._scene.frame.width, self._scene.frame.height
                )
                point = self._snap_to_vertex(np.asarray(world))

                def add():
                    if len(self.source_pnt) == len(self.target_pnt):
                        self.source_pnt.append(point)
                    else:
                        self.target_pnt.append(point)
                    self._redraw_points()

                gui.Application.instance.post_to_main_thread(self.window, add)

            self._scene.scene.scene.render_to_depth_image(depth_cb)
            return gui.Widget.EventCallbackResult.HANDLED
        return gui.Widget.EventCallbackResult.IGNORED

    def _snap_to_vertex(self, point: np.ndarray) -> np.ndarray:
        if self._kdtree is None:
            return point
        _, idx = self._kdtree.query(point)
        return self.mesh.vertices[idx].copy()

    def _clear_points(self):
        self.source_pnt.clear()
        self.target_pnt.clear()

        def fn():
            for name in list(self.drag_geometry):
                self._scene.scene.remove_geometry(name)
            self.drag_geometry.clear()

        gui.Application.instance.post_to_main_thread(self.window, fn)

    def _redraw_points(self):
        for name in list(self.drag_geometry):
            self._scene.scene.remove_geometry(name)
        self.drag_geometry.clear()
        mat = rendering.MaterialRecord()
        mat.shader = "defaultLit"
        for i, p in enumerate(self.source_pnt):
            sphere = o3d.geometry.TriangleMesh.create_sphere(0.02)
            sphere.translate(p)
            sphere.paint_uniform_color([1, 0, 0])
            sphere.compute_vertex_normals()
            name = f"src{i}"
            self.drag_geometry[name] = sphere
            self._scene.scene.add_geometry(name, sphere, mat)
        for i, p in enumerate(self.target_pnt):
            sphere = o3d.geometry.TriangleMesh.create_sphere(0.02)
            sphere.translate(p)
            sphere.paint_uniform_color([0, 0, 1])
            sphere.compute_vertex_normals()
            name = f"tgt{i}"
            self.drag_geometry[name] = sphere
            self._scene.scene.add_geometry(name, sphere, mat)
            if i < len(self.source_pnt):
                arrow = self._make_arrow(self.source_pnt[i], p)
                if arrow is not None:
                    name = f"arrow{i}"
                    self.drag_geometry[name] = arrow
                    self._scene.scene.add_geometry(name, arrow, mat)

    @staticmethod
    def _make_arrow(src, dst):
        vec = np.asarray(dst) - np.asarray(src)
        length = np.linalg.norm(vec)
        if length < 1e-6:
            return None
        arrow = o3d.geometry.TriangleMesh.create_arrow(
            cylinder_radius=0.008,
            cone_radius=0.016,
            cylinder_height=0.8 * length,
            cone_height=0.2 * length,
        )
        arrow.paint_uniform_color([0, 0.8, 0])
        z = np.array([0.0, 0, 1])
        axis = np.cross(z, vec / length)
        s = np.linalg.norm(axis)
        if s > 1e-8:
            angle = np.arctan2(s, np.dot(z, vec / length))
            arrow.rotate(
                o3d.geometry.get_rotation_matrix_from_axis_angle(axis / s * angle),
                center=np.zeros(3),
            )
        arrow.translate(src)
        arrow.compute_vertex_normals()
        return arrow

    # -- capture --------------------------------------------------------------

    def _save_mesh_callback(self):
        picker = gui.FileDialog(gui.FileDialog.SAVE, "Save mesh...", self.window.theme)
        picker.set_on_cancel(self.window.close_dialog)

        def done(filename):
            self.window.close_dialog()
            if self.mesh is None:
                return
            self.mesh.write(filename)
            if self.source_pnt:
                self.edit_count += 1
                write_edit_log(
                    os.path.join(os.path.dirname(filename), "EditLog"),
                    f"{self.edit_count:02d}",
                    np.stack(self.source_pnt),
                    np.stack(self.target_pnt) if self.target_pnt else np.zeros((0, 3)),
                    float(self._grads_scale_edit.text_value),
                    float(self._lambda_edit.text_value),
                )

        picker.set_on_done(done)
        self.window.show_dialog(picker)

    def _save_pic_callback(self):
        picker = gui.FileDialog(gui.FileDialog.SAVE, "Save picture...", self.window.theme)
        picker.set_on_cancel(self.window.close_dialog)

        def done(filename):
            self.window.close_dialog()
            img_holder = []

            def img_cb(img):
                img_holder.append(np.asarray(img))

            self._scene.scene.scene.render_to_image(img_cb)

            def depth_cb(depth_image):
                d = np.asarray(depth_image)
                rgb = img_holder[0].copy()
                rgb[d == 1.0] = [255, 255, 255]
                write_png(filename, rgb)

            self._scene.scene.scene.render_to_depth_image(depth_cb)

        picker.set_on_done(done)
        self.window.show_dialog(picker)

    def run(self):
        gui.Application.instance.run()
