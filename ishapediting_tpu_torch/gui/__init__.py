"""Interactive GUI (optional; requires open3d, or the headless backend of
``gui/headless.py``).

The engine (edit/engine.py) covers every capability; this package adds the
reference's interactive click-and-drag front end (reference: main.py) on
top of it. Import is lazy so the rest of the package has no Open3D
dependency.
"""

def launch(*args, **kwargs):  # pragma: no cover - requires open3d + display
    from ishapediting_tpu_torch.gui.app import App

    App(*args, **kwargs).run()
