"""Headless Open3D-compatible backend for the GUI (no open3d required).

Implements the exact ``open3d``/``open3d.visualization.gui``/``.rendering``
API surface that ``gui/app.py`` uses (reference GUI: main.py:12-631), with
REAL rendering: the scene rasterizes through the framework's own z-buffer
renderer (``geometry/render.py``), the camera does true perspective
projection/unprojection, and ``render_to_depth_image`` returns a normalized
depth buffer with 1.0 background — so the reference's depth-unproject mouse
picking path (main.py:488-527) runs end-to-end without a display server.

Uses:
- ``install_headless_open3d()`` before importing
  ``ishapediting_tpu_torch.gui.app`` turns the full GUI into a scriptable
  headless app; widgets are plain recording objects and
  ``post_to_main_thread`` executes synchronously for determinism.

Test hooks: ``_LowLevelScene.depth_image``/``color_image`` and
``Camera.unproject_result`` override the rendered values when set.
"""

from __future__ import annotations

import sys
import types

import numpy as np

from ishapediting_tpu_torch.geometry.render import _look_at, render_scene

# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


class Vector3dVector(np.ndarray):
    def __new__(cls, data):
        return np.asarray(data, dtype=np.float64).view(cls)


class Vector3iVector(np.ndarray):
    def __new__(cls, data):
        return np.asarray(data, dtype=np.int32).view(cls)


class AxisAlignedBoundingBox:
    def __init__(self, lo, hi):
        self.lo, self.hi = np.asarray(lo), np.asarray(hi)

    def get_center(self):
        return (self.lo + self.hi) / 2


class TriangleMesh:
    def __init__(self):
        self.vertices = np.zeros((0, 3))
        self.triangles = np.zeros((0, 3), np.int32)
        self.color = None
        self.transforms = []  # record of (kind, payload)

    # factories -------------------------------------------------------------
    @staticmethod
    def create_sphere(radius=1.0):
        """Octahedron subdivided once (24 faces) — smooth enough for the
        handle-point overlays."""
        v = np.array(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
            np.float64,
        )
        f = np.array(
            [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
             [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
            np.int64,
        )
        # one midpoint subdivision, vertices pushed back onto the sphere
        edge_mid = {}
        verts = [p for p in v]

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                p = verts[i] + verts[j]
                p = p / np.linalg.norm(p)
                edge_mid[key] = len(verts)
                verts.append(p)
            return edge_mid[key]

        faces = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        m = TriangleMesh()
        m.vertices = radius * np.asarray(verts)
        m.triangles = np.asarray(faces, np.int32)
        m.kind = "sphere"
        return m

    @staticmethod
    def create_arrow(
        cylinder_radius=1.0, cone_radius=1.5, cylinder_height=5.0, cone_height=4.0
    ):
        """Hexagonal cylinder + cone along +z (open3d convention: base at
        the origin, tip at cylinder_height + cone_height)."""
        n = 6
        ang = np.arange(n) * (2 * np.pi / n)
        ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], axis=1)
        v = [np.zeros(3)]  # 0: base center
        v += list(cylinder_radius * ring)  # 1..n: base ring
        v += list(cylinder_radius * ring + [0, 0, cylinder_height])  # n+1..2n
        v += list(cone_radius * ring + [0, 0, cylinder_height])  # 2n+1..3n
        v.append(np.array([0, 0, cylinder_height + cone_height]))  # tip
        tip = len(v) - 1
        faces = []
        for i in range(n):
            j = (i + 1) % n
            faces.append([0, 1 + j, 1 + i])  # base cap
            # cylinder side
            faces.append([1 + i, 1 + j, 1 + n + i])
            faces.append([1 + j, 1 + n + j, 1 + n + i])
            # cone side
            faces.append([1 + 2 * n + i, 1 + 2 * n + j, tip])
        m = TriangleMesh()
        m.vertices = np.asarray(v, np.float64)
        m.triangles = np.asarray(faces, np.int32)
        m.kind = "arrow"
        return m

    # ops ---------------------------------------------------------------------
    def translate(self, offset):
        self.vertices = self.vertices + np.asarray(offset, np.float64)
        self.transforms.append(("translate", np.asarray(offset, np.float64)))
        return self

    def rotate(self, R, center=None):
        # real open3d's no-center overload rotates about the geometry's own
        # center (Geometry3D.rotate docs) — keep the fake's default honest
        c = self.vertices.mean(axis=0) if center is None else np.asarray(center)
        self.vertices = (self.vertices - c) @ np.asarray(R).T + c
        self.transforms.append(("rotate", np.asarray(R)))
        return self

    def paint_uniform_color(self, color):
        self.color = list(color)
        return self

    def compute_vertex_normals(self):
        return self

    def get_axis_aligned_bounding_box(self):
        if len(self.vertices) == 0:
            return AxisAlignedBoundingBox(np.zeros(3), np.zeros(3))
        return AxisAlignedBoundingBox(self.vertices.min(0), self.vertices.max(0))


def get_rotation_matrix_from_axis_angle(axis_angle):
    """Rodrigues formula — matches open3d's convention."""
    aa = np.asarray(axis_angle, np.float64)
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        return np.eye(3)
    k = aa / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


# --------------------------------------------------------------------------
# gui widgets (recording objects)
# --------------------------------------------------------------------------


class _Widget:
    def __init__(self, *a, **k):
        self.children = []
        self.frame = None

    def add_child(self, c):
        self.children.append(c)


class Label(_Widget):
    def __init__(self, text=""):
        super().__init__()
        self.text = text


class Button(_Widget):
    def __init__(self, text=""):
        super().__init__()
        self.text = text
        self.on_clicked = None

    def set_on_clicked(self, fn):
        self.on_clicked = fn

    def click(self):
        assert self.on_clicked is not None
        return self.on_clicked()


class TextEdit(_Widget):
    def __init__(self):
        super().__init__()
        self.text_value = ""


class Combobox(_Widget):
    def __init__(self):
        super().__init__()
        self.items = []
        self.on_selection_changed = None

    def add_item(self, name):
        self.items.append(name)

    def set_on_selection_changed(self, fn):
        self.on_selection_changed = fn


class ProgressBar(_Widget):
    def __init__(self):
        super().__init__()
        self.value = 0.0


class Vert(_Widget):
    pass


class Horiz(_Widget):
    pass


class Margins:
    def __init__(self, *a):
        pass


class Rect:
    def __init__(self, x=0, y=0, width=0, height=0):
        self.x, self.y, self.width, self.height = x, y, width, height

    def get_right(self):
        return self.x + self.width


# --------------------------------------------------------------------------
# camera + scene with real rendering
# --------------------------------------------------------------------------


class Camera:
    """True perspective camera; projection matches geometry/render.py bit
    for bit so unproject(render_depth) lands back on the surface."""

    def __init__(self):
        self.eye = np.array([1.8, 1.4, 1.8])
        self.center = np.zeros(3)
        self.up = np.array([0.0, 1.0, 0.0])
        self.fov_deg = 60.0
        self.near = 0.05
        self.far = 20.0
        self.unproject_result = None  # test override
        self.calls = []

    def frame_bounds(self, fov_deg, bounds, center):
        """Place the camera on a 3/4 view framing ``bounds`` (the headless
        equivalent of SceneWidget.setup_camera)."""
        self.fov_deg = float(fov_deg)
        center = np.asarray(center, np.float64)
        radius = max(float(np.linalg.norm(bounds.hi - bounds.lo)) / 2, 1e-6)
        direction = np.array([1.0, 0.6, 1.4])
        direction = direction / np.linalg.norm(direction)
        dist = radius / np.tan(np.radians(self.fov_deg) / 2) * 1.6
        self.center = center
        self.eye = center + direction * dist
        self.near = max(dist - 4 * radius, dist * 0.05)
        self.far = dist + 4 * radius

    def view_matrix(self):
        return _look_at(self.eye, self.center, self.up)

    def project(self, points, w, h):
        """World points -> (px, py, normalized depth); the exact forward of
        ``unproject`` (helper for demos/tests, not part of the open3d API)."""
        pts = np.atleast_2d(np.asarray(points, np.float64))
        vh = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ self.view_matrix().T
        f = 1.0 / np.tan(np.radians(self.fov_deg) / 2)
        aspect = w / h
        z = -vh[:, 2]
        zc = np.maximum(z, 1e-9)
        px = (vh[:, 0] * f / (zc * aspect) * 0.5 + 0.5) * (w - 1)
        py = (1.0 - (vh[:, 1] * f / zc * 0.5 + 0.5)) * (h - 1)
        d = np.clip((z - self.near) / max(self.far - self.near, 1e-9), 0.0, 1.0)
        return np.stack([px, py, d], axis=1)

    def unproject(self, x, y, depth, w, h):
        self.calls.append((x, y, depth, w, h))
        if self.unproject_result is not None:
            return self.unproject_result
        z = self.near + float(depth) * (self.far - self.near)
        f = 1.0 / np.tan(np.radians(self.fov_deg) / 2)
        aspect = w / h
        ndc_x = x / (w - 1) * 2.0 - 1.0
        ndc_y = (1.0 - y / (h - 1)) * 2.0 - 1.0
        xv = ndc_x * aspect * z / f
        yv = ndc_y * z / f
        view_inv = np.linalg.inv(self.view_matrix())
        world = view_inv @ np.array([xv, yv, -z, 1.0])
        return world[:3]


class _LowLevelScene:
    def __init__(self, owner=None):
        self.owner = owner
        self.sun = None
        self.light_dir = np.array([-1.0, -1.0, -1.0])
        self.depth_image = None  # test override
        self.color_image = None  # test override

    def set_sun_light(self, direction, color=None, intensity=None):
        self.sun = (direction, color, intensity)
        self.light_dir = np.asarray(direction, np.float64)

    def enable_sun_light(self, flag):
        pass

    def render_to_depth_image(self, cb):
        if self.depth_image is not None:
            cb(self.depth_image)
        else:
            cb(self.owner.render()[1])

    def render_to_image(self, cb):
        if self.color_image is not None:
            cb(self.color_image)
        else:
            cb(self.owner.render()[0])


class Open3DScene:
    """Doubles as rendering.Open3DScene; gui SceneWidget.scene."""

    def __init__(self, renderer=None):
        self.geometry = {}
        self.background = None
        self.scene = _LowLevelScene(owner=self)
        self.camera = Camera()
        self.camera_setup = None
        self.render_size = (640, 480)  # (width, height); keep == widget frame

    def set_background(self, color):
        self.background = color

    def clear_geometry(self):
        self.geometry.clear()

    def add_geometry(self, name, geom, mat):
        self.geometry[name] = geom

    def remove_geometry(self, name):
        self.geometry.pop(name, None)

    def setup_camera(self, fov, bounds, center):
        self.camera_setup = (fov, bounds, center)
        self.camera.frame_bounds(fov, bounds, center)

    def render(self):
        """Rasterize the current geometry; returns (rgb uint8, depth f32)."""
        w, h = self.render_size
        bg = (1.0, 1.0, 1.0) if self.background is None else tuple(self.background[:3])
        geoms = [
            (g.vertices, g.triangles, g.color) for g in self.geometry.values()
        ]
        return render_scene(
            geoms,
            width=w,
            height=h,
            eye=tuple(self.camera.eye),
            center=tuple(self.camera.center),
            up=tuple(self.camera.up),
            fov_deg=self.camera.fov_deg,
            near=self.camera.near,
            far=self.camera.far,
            light_dir=tuple(self.scene.light_dir),
            background=bg,
        )


class SceneWidget(_Widget):
    """``frame`` and ``scene`` are properties so the scene's render_size
    always tracks the widget frame — picking unprojects with
    (frame.width, frame.height) and indexes the depth image, so a layout
    pass resizing the frame must resize the rasterization too."""

    def __init__(self):
        super().__init__()
        self._scene = None
        self.on_mouse = None
        self._frame = Rect(0, 0, 640, 480)
        self.camera_setup = None

    @property
    def frame(self):
        return self._frame

    @frame.setter
    def frame(self, rect):
        self._frame = rect
        self._sync_render_size()

    @property
    def scene(self):
        return self._scene

    @scene.setter
    def scene(self, s):
        self._scene = s
        self._sync_render_size()

    def _sync_render_size(self):
        # getattr: the base __init__ assigns ``frame`` before _scene exists
        scene = getattr(self, "_scene", None)
        frame = getattr(self, "_frame", None)
        if (
            scene is not None
            and getattr(frame, "width", 0)
            and getattr(frame, "height", 0)
        ):
            scene.render_size = (int(frame.width), int(frame.height))

    def set_on_mouse(self, fn):
        self.on_mouse = fn

    def setup_camera(self, fov, bounds, center):
        self.camera_setup = (fov, bounds, center)
        if self.scene is not None:
            self.scene.setup_camera(fov, bounds, center)


class FileDialog(_Widget):
    OPEN = 0
    SAVE = 1

    def __init__(self, mode, title, theme):
        super().__init__()
        self.mode = mode
        self.on_done = None
        self.on_cancel = None

    def add_filter(self, *a):
        pass

    def set_on_cancel(self, fn):
        self.on_cancel = fn

    def set_on_done(self, fn):
        self.on_done = fn


class _Theme:
    font_size = 14


class _Window:
    def __init__(self, title, width, height):
        self.title = title
        self.theme = _Theme()
        self.content_rect = Rect(0, 0, width, height)
        self.children = []
        self.renderer = object()
        self.on_layout = None
        self.dialog = None

    def add_child(self, c):
        self.children.append(c)

    def set_on_layout(self, fn):
        self.on_layout = fn

    def show_dialog(self, d):
        self.dialog = d

    def close_dialog(self):
        self.dialog = None


class _AppInstance:
    def __init__(self):
        self.windows = []
        self.posted = []

    def initialize(self):
        pass

    def create_window(self, title, width, height):
        w = _Window(title, width, height)
        self.windows.append(w)
        return w

    def post_to_main_thread(self, window, fn):
        # synchronous execution keeps headless runs deterministic
        self.posted.append(fn)
        fn()

    def run(self):
        pass


class Application:
    instance = _AppInstance()


class MouseEvent:
    class Type:
        BUTTON_DOWN = 1
        BUTTON_UP = 2
        DRAG = 3


class KeyModifier:
    CTRL = 1
    SHIFT = 2


class Widget:
    class EventCallbackResult:
        HANDLED = 1
        IGNORED = 0


class SyntheticMouseEvent:
    """Scriptable mouse event for headless driving (not part of open3d)."""

    def __init__(self, x, y, etype=MouseEvent.Type.BUTTON_DOWN, ctrl=True):
        self.x, self.y = x, y
        self.type = etype
        self._ctrl = ctrl

    def is_modifier_down(self, mod):
        return self._ctrl if mod == KeyModifier.CTRL else False


class MaterialRecord:
    def __init__(self):
        self.shader = None


# --------------------------------------------------------------------------
# module assembly
# --------------------------------------------------------------------------


def install_headless_open3d():
    """Register this backend as ``open3d`` in sys.modules; returns the root.

    Must run before ``import ishapediting_tpu_torch.gui.app``: the app binds
    the ``open3d`` modules it finds when it is imported. If a real open3d is
    already imported it is replaced for this process (headless wins — call
    sites opt in explicitly).
    """
    o3d = types.ModuleType("open3d")
    geometry = types.ModuleType("open3d.geometry")
    geometry.TriangleMesh = TriangleMesh
    geometry.AxisAlignedBoundingBox = AxisAlignedBoundingBox
    geometry.get_rotation_matrix_from_axis_angle = get_rotation_matrix_from_axis_angle
    utility = types.ModuleType("open3d.utility")
    utility.Vector3dVector = Vector3dVector
    utility.Vector3iVector = Vector3iVector

    vis = types.ModuleType("open3d.visualization")
    gui_mod = types.ModuleType("open3d.visualization.gui")
    for name, obj in [
        ("Application", Application),
        ("SceneWidget", SceneWidget),
        ("Vert", Vert),
        ("Horiz", Horiz),
        ("Margins", Margins),
        ("Label", Label),
        ("Button", Button),
        ("TextEdit", TextEdit),
        ("Combobox", Combobox),
        ("ProgressBar", ProgressBar),
        ("Rect", Rect),
        ("FileDialog", FileDialog),
        ("MouseEvent", MouseEvent),
        ("KeyModifier", KeyModifier),
        ("Widget", Widget),
    ]:
        setattr(gui_mod, name, obj)
    rend_mod = types.ModuleType("open3d.visualization.rendering")
    rend_mod.Open3DScene = Open3DScene
    rend_mod.MaterialRecord = MaterialRecord

    o3d.geometry = geometry
    o3d.utility = utility
    o3d.visualization = vis
    vis.gui = gui_mod
    vis.rendering = rend_mod

    sys.modules["open3d"] = o3d
    sys.modules["open3d.geometry"] = geometry
    sys.modules["open3d.utility"] = utility
    sys.modules["open3d.visualization"] = vis
    sys.modules["open3d.visualization.gui"] = gui_mod
    sys.modules["open3d.visualization.rendering"] = rend_mod
    return o3d
