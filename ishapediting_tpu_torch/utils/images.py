"""Image post-processing helpers for rendered batches, a host tool
(reference: meshProcess.py:161-252): alpha-aware cropping, per-image
bounding-box crops, downsampling, png -> jpg on a white background.

They need Pillow, which is imported only when a function runs, so that the
rest of the package imports without it.
"""

from __future__ import annotations

import os

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "ishapediting_tpu_torch.utils.images needs Pillow (`pip install pillow`); "
            "PNGs of rendered meshes are written without it by geometry/render.py::write_png"
        ) from e
    return Image


def _read_rgba(path: str) -> np.ndarray:
    return np.asarray(_pil().open(path).convert("RGBA"))


def crop_images_rgba(path: str) -> None:
    """Crop every image in a directory to the union alpha bbox
    (reference: meshProcess.py:161-177); writes to ``<path>/Resize``."""
    Image = _pil()
    names = [n for n in sorted(os.listdir(path)) if n.endswith((".png", ".jpg"))]
    images = np.stack([_read_rgba(os.path.join(path, n)) for n in names])
    alpha = (images[..., -1] > 0).max(axis=0)  # [h, w]
    xs = np.nonzero(alpha.max(axis=0))[0]
    ys = np.nonzero(alpha.max(axis=1))[0]
    out_dir = os.path.join(path, "Resize")
    os.makedirs(out_dir, exist_ok=True)
    for n, img in zip(names, images):
        Image.fromarray(img[ys[0] : ys[-1] + 1, xs[0] : xs[-1] + 1]).save(os.path.join(out_dir, n))


def _on_white(Image, im):
    bg = Image.new("RGB", im.size, (255, 255, 255))
    bg.paste(im, mask=im.split()[3])
    return bg


def crop_images_rgba_each(path: str, save_format: str = "png") -> None:
    """Per-image alpha-bbox crop into ``<path>/png`` or, on white,
    ``<path>/jpg`` (reference: meshProcess.py:181-209)."""
    Image = _pil()
    if save_format not in ("png", "jpg"):
        raise NotImplementedError("Unsupported image format")
    for name in sorted(os.listdir(path)):
        if not name.endswith((".png", ".jpg")):
            continue
        img = _read_rgba(os.path.join(path, name))
        alpha = img[..., -1] > 0
        if not alpha.any():
            continue
        xs = np.nonzero(alpha.max(axis=0))[0]
        ys = np.nonzero(alpha.max(axis=1))[0]
        crop = Image.fromarray(img[ys[0] : ys[-1] + 1, xs[0] : xs[-1] + 1])
        out = os.path.join(path, save_format)
        os.makedirs(out, exist_ok=True)
        if save_format == "png":
            crop.save(os.path.join(out, name))
        else:
            _on_white(Image, crop).save(os.path.join(out, name.replace(".png", ".jpg")), "JPEG")


def down_sample(path: str, factor: float = 0.5) -> None:
    """Resize every image by ``factor`` into ``<path>/DownSample``
    (reference: meshProcess.py:212-219)."""
    Image = _pil()
    out = os.path.join(path, "DownSample")
    os.makedirs(out, exist_ok=True)
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        img = Image.open(full)
        img.resize((int(img.size[0] * factor), int(img.size[1] * factor))).save(os.path.join(out, name))


def png_to_jpg(path: str) -> None:
    """RGBA png -> white-background jpg beside it (reference:
    meshProcess.py:239-252)."""
    Image = _pil()
    for name in sorted(os.listdir(path)):
        if not name.endswith(".png"):
            continue
        img = Image.open(os.path.join(path, name)).convert("RGBA")
        _on_white(Image, img).save(os.path.join(path, name).replace(".png", ".jpg"), "JPEG")
