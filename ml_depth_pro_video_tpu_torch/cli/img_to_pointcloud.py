"""Single image -> ground-normalized point cloud.

Capability parity with the reference's `img_to_normalized_pointcloud.py`
(`create_normalized_pointcloud` `:1120-1329`): depth inference,
unprojection, ground-plane load/fit (+ optional L-BFGS-B optimization
and manual rotation offsets), normalization, grid adjustment, then PLY
export and/or offscreen renders. One resident model, one inference per
image (the reference reloads + re-infers, SURVEY §2.2).

Port of ``ml_depth_pro_video_tpu/cli/img_to_pointcloud.py`` on the port's
runner: ``device`` (``--device``, default ``cuda``) is where a runner built
here runs the model.
"""

from __future__ import annotations

import argparse
import os

from ..geom.ground import (
    apply_rotation_to_plane,
    fit_ground_plane,
    grid_ground_adjustment,
    load_ground_plane,
    normalize_to_ground,
    optimize_ground_plane,
    save_ground_plane,
)
from ..geom.pointcloud import PointCloud, write_ply
from ..geom.render import save_render
from ..geom.unproject import depth_to_3d


def create_normalized_pointcloud(
    image_path: str,
    output_path: str | None = None,
    rotation_offset=None,
    ground_params_dir: str | None = None,
    grid_size: int = 20,
    ground_percentile: float = 5.0,
    downscale_factor: float = 1.0,
    half_precision: bool = True,
    optimize_ground: bool = True,
    render_view: str | None = None,
    return_pointcloud: bool = False,
    runner=None,
    seed: int = 0,
    device="cuda",
):
    """Full single-image pipeline; returns (cloud, ground_model) when
    ``return_pointcloud`` else writes ``output_path``."""
    from ..video.runner import DepthVideoRunner

    runner = runner or DepthVideoRunner(
        precision="bf16" if half_precision else "fp32",
        downscale_factor=downscale_factor,
        device=device,
    )
    result = runner.infer_one(image_path)
    cloud = depth_to_3d(result["depth"], result["focallength_px"], image=result["image"])

    ground_dir = ground_params_dir or os.path.dirname(os.path.abspath(image_path))
    ground_model = load_ground_plane(ground_dir, image_path=image_path)
    if ground_model is None:
        # the reference's ALWAYS-on three-stage chain (`:1237-1258`):
        # fit on a <=50k sample, L-BFGS-B optimize, then a guided refit
        # over ALL points with the optimized model as the initial guide
        pts_all = cloud.points
        if len(pts_all) > 50_000:
            import numpy as np

            sel = np.random.default_rng(seed).choice(len(pts_all), 50_000, replace=False)
            sample = pts_all[sel]
        else:
            sample = pts_all
        initial = fit_ground_plane(sample, seed=seed)
        if optimize_ground:
            initial = optimize_ground_plane(sample, initial)
        ground_model = fit_ground_plane(pts_all, initial_model=initial, seed=seed)
    # rotation offset FIRST, then persist — the saved ground.json must
    # carry the manual correction so later frames/runs inherit it; the
    # reference also re-saves loaded models (`:1270-1279`)
    if rotation_offset is not None:
        ground_model = apply_rotation_to_plane(ground_model, rotation_offset)
    save_ground_plane(ground_model, ground_dir)

    pts = normalize_to_ground(cloud.points, ground_model)
    pts = grid_ground_adjustment(pts, grid_size=grid_size, percentile=ground_percentile)
    cloud = PointCloud(pts, cloud.colors)

    if output_path:
        if output_path.endswith(".ply"):
            write_ply(output_path, cloud)
        else:
            save_render(output_path, cloud, view=render_view or "front")
    if return_pointcloud:
        return cloud, ground_model
    return output_path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Image -> normalized point cloud (PyTorch port)")
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--output_path", required=True, help=".ply or image path")
    ap.add_argument("--rotation_offset", type=float, nargs=3, default=None,
                    help="manual plane rotation in degrees [x y z]")
    ap.add_argument("--ground_params_dir", default=None)
    ap.add_argument("--grid_size", type=int, default=20)
    ap.add_argument("--ground_percentile", type=float, default=5.0)
    ap.add_argument("--downscale_factor", type=float, default=1.0)
    ap.add_argument("--half_precision", action="store_true", default=True)
    ap.add_argument("--full_precision", dest="half_precision", action="store_false")
    ap.add_argument("--optimize_ground", action="store_true", default=True,
                    help="L-BFGS-B plane refinement (reference default: ON)")
    ap.add_argument("--no_optimize_ground", dest="optimize_ground", action="store_false")
    ap.add_argument("--view", default=None, choices=[None, "front", "top", "side", "iso", "multi"])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    create_normalized_pointcloud(
        args.image_path, args.output_path, rotation_offset=args.rotation_offset,
        ground_params_dir=args.ground_params_dir, grid_size=args.grid_size,
        ground_percentile=args.ground_percentile, downscale_factor=args.downscale_factor,
        half_precision=args.half_precision, optimize_ground=args.optimize_ground,
        render_view=args.view, device=args.device,
    )


if __name__ == "__main__":  # pragma: no cover
    main()
