"""Single-image clean-pointcloud driver.

Parity with the reference's `pointcloud_cleaner.py:311-436`
(``process_image_to_clean_pointcloud``): normalized cloud -> stray
removal -> shadow cleanup -> PLY + preview render. Uses ONE inference
(the reference runs the model twice per image, SURVEY §2.2 — fixed).

Port of ``ml_depth_pro_video_tpu/cli/pointcloud_cleaner.py`` on the port's
runner: ``device`` (``--device``, default ``cuda``) is where a runner built
here runs the model.
"""

from __future__ import annotations

import argparse
import os

from ..geom.clean import clean_shadows, remove_stray_points
from ..geom.pointcloud import write_ply
from ..geom.render import save_render
from .img_to_pointcloud import create_normalized_pointcloud

# quality presets (parity with demo_pointcloud_cleaner.py:41-55: FAST is
# the aggressive cleaner at reduced resolution, HIGH_QUALITY keeps more
# points at full resolution)
QUALITY_PRESETS = {
    "fast": dict(nb_points=25, radius=0.15, downscale_factor=0.3),
    "default": dict(nb_points=20, radius=0.1, downscale_factor=1.0),
    "high_quality": dict(nb_points=10, radius=0.05, downscale_factor=1.0),
}


def process_image_to_clean_pointcloud(
    image_path: str,
    output_dir: str | None = None,
    nb_points: int = 20,
    radius: float = 0.1,
    shadow_height_threshold: float = 0.1,
    max_shadow_angle: float = 75.0,
    downscale_factor: float = 1.0,
    half_precision: bool = True,
    preview: bool = True,
    view_preset: str = "front",
    runner=None,
    device="cuda",
):
    output_dir = output_dir or os.path.dirname(os.path.abspath(image_path))
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_path))[0]

    cloud, _ = create_normalized_pointcloud(
        image_path, return_pointcloud=True,
        downscale_factor=downscale_factor, half_precision=half_precision,
        ground_params_dir=output_dir, runner=runner, device=device,
    )
    cloud = remove_stray_points(cloud, nb_points=nb_points, radius=radius)
    cloud = clean_shadows(cloud, shadow_height_threshold=shadow_height_threshold,
                          max_shadow_angle=max_shadow_angle)

    ply_path = os.path.join(output_dir, f"{stem}_clean.ply")
    write_ply(ply_path, cloud)
    if preview:
        # reference default: a single front view, selectable via
        # --view_preset (`pointcloud_cleaner.py:434,460-463`)
        save_render(os.path.join(output_dir, f"{stem}_clean_preview.png"),
                    cloud, view=view_preset)
    return ply_path, cloud


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Image -> cleaned point cloud (PyTorch port)")
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--output_dir", default=None)
    # None defaults: an EXPLICIT flag must win over a --quality preset
    ap.add_argument("--nb_points", type=int, default=None)
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--shadow_height_threshold", type=float, default=0.1)
    ap.add_argument("--max_shadow_angle", type=float, default=75.0)
    ap.add_argument("--downscale_factor", type=float, default=None)
    ap.add_argument("--quality", choices=list(QUALITY_PRESETS), default=None)
    ap.add_argument("--view_preset", default="front",
                    choices=["front", "top", "side", "iso", "isometric", "multi"],
                    help="preview view (reference default: front)")
    ap.add_argument("--no_preview", dest="preview", action="store_false")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    # precedence: explicit flag > quality preset > built-in default
    kw = dict(nb_points=20, radius=0.1, downscale_factor=1.0)
    if args.quality:
        kw.update(QUALITY_PRESETS[args.quality])
    for name in ("nb_points", "radius", "downscale_factor"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    process_image_to_clean_pointcloud(
        args.image_path, args.output_dir,
        shadow_height_threshold=args.shadow_height_threshold,
        max_shadow_angle=args.max_shadow_angle, preview=args.preview,
        view_preset=args.view_preset, device=args.device, **kw,
    )


if __name__ == "__main__":  # pragma: no cover
    main()
