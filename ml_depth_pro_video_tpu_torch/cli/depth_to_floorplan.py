"""Image -> depth-space shadow removal -> floor plan (one shot).

Capability parity with the legacy front-end
the reference's `OLD_SCRIPTS/create_floor_plan.py:16-123`
(``remove_depth_shadows`` + ``create_floor_plan``), composed from the
current stack: depth -> shadow interpolation -> unprojection ->
normalization -> direct floor plan. Legacy semantics preserved:
height_threshold defaults to 0.5 m (`create_floor_plan.py:20`), ground
parameters persist by default and accept manual rotation offsets
(`:28-37`), shadow removal/interpolation can be toggled, and the X axis
is un-negated so the plan's left/right matches the legacy output
(`mesh_from_depth.py:2036` uses camera X directly; our Y-up
unprojection negates it).

Port of ``ml_depth_pro_video_tpu/cli/depth_to_floorplan.py`` on the port's
runner: ``device`` (``--device``, default ``cuda``) is where a runner built
here runs the model.
"""

from __future__ import annotations

import argparse
import os

from ..geom.depth_shadows import remove_depth_shadows
from ..geom.floorplan import create_direct_floorplan
from ..geom.ground import (
    apply_rotation_to_plane,
    fit_ground_plane,
    load_ground_plane,
    normalize_to_ground,
    save_ground_plane,
)
from ..geom.unproject import depth_to_3d


def depth_image_to_floorplan(
    image_path: str,
    output_dir: str | None = None,
    height_threshold: float | None = 0.5,
    threshold_factor: float = 0.2,
    force_horizontal: bool = False,
    grid_resolution: float = 0.05,
    remove_shadows: bool = True,
    interpolate_ground: bool = True,
    use_saved_ground: bool = True,
    rotation_offset=None,
    simplified: bool = True,
    max_height: float = 2.5,
    runner=None,
    seed: int = 0,
    device="cuda",
) -> str:
    from ..video.runner import DepthVideoRunner

    runner = runner or DepthVideoRunner(precision="bf16", device=device)
    result = runner.infer_one(image_path)

    ground_dir = output_dir or os.path.dirname(os.path.abspath(image_path))
    os.makedirs(ground_dir, exist_ok=True)
    ground = load_ground_plane(ground_dir, image_path=image_path) if use_saved_ground else None

    depth = result["depth"]
    if remove_shadows:
        depth, _, ground = remove_depth_shadows(
            depth, f_px=result["focallength_px"],
            threshold_factor=threshold_factor,
            interpolate_ground=interpolate_ground,
            ground_model=ground, force_horizontal=force_horizontal,
            seed=seed,
        )
    cloud = depth_to_3d(depth, result["focallength_px"], image=result["image"])
    if ground is None:
        ground = fit_ground_plane(cloud.points, seed=seed)
    if rotation_offset is not None:
        ground = apply_rotation_to_plane(ground, rotation_offset)
    if use_saved_ground:
        save_ground_plane(ground, ground_dir)
    points = normalize_to_ground(cloud.points, ground)
    # legacy plan orientation: camera X un-negated
    points = points.copy()
    points[:, 0] = -points[:, 0]

    stem = os.path.splitext(os.path.basename(image_path))[0]
    out = os.path.join(ground_dir, f"{stem}_floorplan.png")
    create_direct_floorplan(points, out, height_threshold=height_threshold,
                            grid_resolution=grid_resolution,
                            simplified=simplified, max_height=max_height)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Image -> floor plan (depth-space cleanup)")
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--height_threshold", default="0.5",
                    help="meters above the floor, or 'none' for all objects "
                         "(legacy default 0.5, create_floor_plan.py:20)")
    ap.add_argument("--threshold_factor", type=float, default=0.2)
    ap.add_argument("--force_horizontal", action="store_true")
    ap.add_argument("--grid_resolution", type=float, default=0.05)
    ap.add_argument("--keep_shadows", dest="remove_shadows", action="store_false",
                    help="skip depth-space shadow removal")
    ap.add_argument("--no_ground_interp", dest="interpolate_ground",
                    action="store_false",
                    help="detect shadows but keep their original depth")
    ap.add_argument("--no_saved_ground", dest="use_saved_ground",
                    action="store_false",
                    help="refit the ground instead of loading/saving ground.json")
    ap.add_argument("--rot_x", type=float, default=0.0)
    ap.add_argument("--rot_y", type=float, default=0.0)
    ap.add_argument("--rot_z", type=float, default=0.0)
    ap.add_argument("--no_simplified", dest="simplified", action="store_false",
                    help="per-cell coloring instead of filled contours")
    ap.add_argument("--max_height", type=float, default=2.5)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    ht = None if args.height_threshold.lower() in ("none", "") else float(args.height_threshold)
    rot = [args.rot_x, args.rot_y, args.rot_z]
    out = depth_image_to_floorplan(
        args.image_path, args.output_dir, height_threshold=ht,
        threshold_factor=args.threshold_factor,
        force_horizontal=args.force_horizontal,
        grid_resolution=args.grid_resolution,
        remove_shadows=args.remove_shadows,
        interpolate_ground=args.interpolate_ground,
        use_saved_ground=args.use_saved_ground,
        rotation_offset=rot if any(rot) else None,
        simplified=args.simplified,
        max_height=args.max_height,
        device=args.device,
    )
    print(f"wrote {out}")


if __name__ == "__main__":  # pragma: no cover
    main()
