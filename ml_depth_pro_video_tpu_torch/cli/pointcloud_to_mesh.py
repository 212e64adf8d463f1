"""Image -> cleaned point cloud -> triangle mesh driver.

Parity with the reference's `pointcloud_to_mesh.py:467-591`
(``process_image_to_mesh``) and the quality-preset demo wrappers
(`demo_pointcloud_to_mesh.py:11-82`).

Port of ``ml_depth_pro_video_tpu/cli/pointcloud_to_mesh.py`` on the port's
runner: ``device`` (``--device``, default ``cuda``) is where a runner built
here runs the model, and the Poisson solve runs on the runner's device.
"""

from __future__ import annotations

import argparse
import os

from ..geom.mesh import create_mesh_from_pointcloud
from ..geom.pointcloud import PointCloud
from ..geom.render import save_render
from .pointcloud_cleaner import process_image_to_clean_pointcloud

QUALITY_PRESETS = {
    # voxel size, poisson depth, downscale, (stray nb_points, radius)
    "fast": dict(voxel_size=0.1, depth=6, downscale_factor=0.5, nb_points=10, radius=0.15),
    "default": dict(voxel_size=0.05, depth=7, downscale_factor=1.0, nb_points=20, radius=0.1),
    "high_quality": dict(voxel_size=0.03, depth=8, downscale_factor=1.0, nb_points=25, radius=0.08),
}


def process_image_to_mesh(
    image_path: str,
    output_path: str | None = None,
    voxel_size: float = 0.05,
    depth: int = 8,
    method: str = "poisson",
    downscale_factor: float = 1.0,
    nb_points: int = 20,
    radius: float = 0.1,
    max_shadow_angle: float = 75.0,
    add_ground_plane: bool = False,
    preview: bool = True,
    runner=None,
    html: bool = False,
    device="cuda",
):
    from ..video.runner import DepthVideoRunner

    out_dir = os.path.dirname(os.path.abspath(output_path or image_path)) or "."
    stem = os.path.splitext(os.path.basename(image_path))[0]
    output_path = output_path or os.path.join(out_dir, f"{stem}_mesh.obj")

    # the runner the cleaner would build, here so that its device reaches the solve
    runner = runner or DepthVideoRunner(precision="bf16", downscale_factor=downscale_factor,
                                        device=device)
    _, cloud = process_image_to_clean_pointcloud(
        image_path, out_dir, nb_points=nb_points, radius=radius,
        max_shadow_angle=max_shadow_angle,
        downscale_factor=downscale_factor, preview=False, runner=runner,
    )
    mesh = create_mesh_from_pointcloud(cloud, voxel_size=voxel_size,
                                       depth=depth, method=method, device=runner.device)
    if add_ground_plane:
        from ..geom.mesh import add_ground_plane_mesh

        mesh = add_ground_plane_mesh(mesh)
    mesh.save_obj(output_path)
    if html and len(mesh.vertices):
        from ..geom.html_viewer import export_mesh_html

        export_mesh_html(mesh, os.path.splitext(output_path)[0] + ".html",
                         title=os.path.basename(output_path))
    if preview and len(mesh.vertices):
        save_render(
            os.path.splitext(output_path)[0] + "_preview.png",
            PointCloud(mesh.vertices, mesh.vertex_colors), view="iso",
        )
    print(f"Mesh: {len(mesh.vertices)} vertices, {len(mesh.faces)} triangles -> {output_path}")
    return output_path, mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Image -> mesh (PyTorch port)")
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--quality", choices=list(QUALITY_PRESETS), default=None,
                    help="preset overriding voxel/depth/downscale")
    # None defaults: an EXPLICIT flag must win over a --quality preset
    ap.add_argument("--voxel_size", type=float, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--method", default="poisson",
                    choices=["poisson", "ball_pivoting", "simple"])
    ap.add_argument("--downscale_factor", type=float, default=None)
    ap.add_argument("--no_preview", dest="preview", action="store_false")
    ap.add_argument("--html", action="store_true",
                    help="also write a self-contained interactive WebGL viewer")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    # precedence: explicit flag > quality preset > built-in default
    kw = dict(voxel_size=0.05, depth=8, downscale_factor=1.0)
    if args.quality:
        preset = dict(QUALITY_PRESETS[args.quality])
        kw.update({k: preset[k] for k in ("voxel_size", "depth", "downscale_factor")})
        kw.update(nb_points=preset["nb_points"], radius=preset["radius"])
    for name in ("voxel_size", "depth", "downscale_factor"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    process_image_to_mesh(args.image_path, args.output_path, method=args.method,
                          preview=args.preview, html=args.html, device=args.device, **kw)


if __name__ == "__main__":  # pragma: no cover
    main()
