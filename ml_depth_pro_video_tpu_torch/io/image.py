"""Image loading with EXIF focal-length extraction.

The port's own copy of ``ml_depth_pro_video_tpu/io/image.py``: EXIF
auto-rotation (orientations 3/6/8), grayscale->RGB, alpha strip, and focal
length from the 35mm-equivalent EXIF tag via
``f_px = f_mm * sqrt(w^2+h^2) / sqrt(36^2+24^2)``. HEIC decoding works when
pillow_heif is installed. Pillow is imported inside the functions, so the
module imports where Pillow is absent; decoding a file needs it.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

LOGGER = logging.getLogger(__name__)


def extract_exif(img_pil) -> Dict[str, Any]:
    """EXIF + TIFF tags of a PIL image as a name->value dict."""
    from PIL import ExifTags, TiffTags

    exif = img_pil.getexif()
    ifd = exif.get_ifd(0x8769)
    out = {ExifTags.TAGS[k]: v for k, v in ifd.items() if k in ExifTags.TAGS}
    tiff = {TiffTags.TAGS_V2[k].name: v for k, v in exif.items() if k in TiffTags.TAGS_V2}
    out.update(tiff)
    return out


def fpx_from_f35(width: float, height: float, f_mm: float = 50) -> float:
    """35mm-equivalent focal length (mm) -> pixels for this image size."""
    return f_mm * np.sqrt(width**2.0 + height**2.0) / np.sqrt(36**2 + 24**2)


def _open(path: Path):
    from PIL import Image

    if path.suffix.lower() != ".heic":
        return Image.open(path)
    try:
        import pillow_heif
    except ImportError as exc:
        raise RuntimeError("HEIC input requires pillow_heif, which is not installed") from exc
    return pillow_heif.open_heif(path, convert_hdr_to_8bit=True).to_pillow()


def load_rgb(
    path: Union[Path, str],
    auto_rotate: bool = True,
    remove_alpha: bool = True,
) -> Tuple[np.ndarray, List[bytes], Optional[float]]:
    """Load an RGB image. Returns (HxWx3 uint8 array, icc_profile, f_px or None)."""
    from PIL import Image

    img_pil = _open(Path(path))
    img_exif = extract_exif(img_pil)
    icc_profile = img_pil.info.get("icc_profile", None)

    if auto_rotate:
        rotations = {3: Image.ROTATE_180, 6: Image.ROTATE_270, 8: Image.ROTATE_90}
        orientation = img_exif.get("Orientation", 1)
        if orientation in rotations:
            img_pil = img_pil.transpose(rotations[orientation])
        elif orientation != 1:
            LOGGER.warning("Ignoring image orientation %s.", orientation)

    img = np.array(img_pil)
    if img.ndim < 3 or img.shape[2] == 1:
        img = np.dstack((img, img, img))
    if remove_alpha:
        img = img[:, :, :3]

    f_35mm = img_exif.get(
        "FocalLengthIn35mmFilm",
        img_exif.get("FocalLenIn35mmFilm", img_exif.get("FocalLengthIn35mmFormat")),
    )
    # corrupt EXIF (negative or zero f_35mm) falls back to FOV estimation
    valid_f35 = f_35mm is not None and isinstance(f_35mm, (int, float)) and f_35mm > 0
    f_px = fpx_from_f35(img.shape[1], img.shape[0], f_35mm) if valid_f35 else None
    return img, icc_profile, f_px


def load_stream_item(item, downscale_factor: float = 1.0):
    """Decode and normalize one video-stream item: path | (path, f_px) |
    ndarray | (ndarray, f_px). Returns (key, uint8 image, f_px).

    The runner's process decode pool ships this function to spawn workers,
    which then import only this module's dependencies (numpy, Pillow), never
    torch's device state."""
    f_px = None
    if isinstance(item, tuple):
        item, f_px = item
    if isinstance(item, (str, os.PathLike)):
        img, _, exif_f = load_rgb(item)
        f_px = f_px if f_px is not None else exif_f
        key = str(item)
    else:
        img = np.asarray(item)
        key = None
    if img.dtype != np.uint8:
        # convert before any PIL resize: Image.fromarray cannot take float RGB
        if np.issubdtype(img.dtype, np.floating) and img.size and img.max() <= 1.0:
            img = img * 255.0  # [0, 1] floats
        img = np.clip(img, 0, 255).astype(np.uint8)
    if downscale_factor != 1.0:
        from PIL import Image

        h = int(img.shape[0] * downscale_factor)
        w = int(img.shape[1] * downscale_factor)
        if f_px is not None:
            f_px = f_px * downscale_factor
        img = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    return key, img, f_px
