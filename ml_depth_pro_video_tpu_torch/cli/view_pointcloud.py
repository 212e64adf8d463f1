"""Render saved point clouds to images (the Open3D interactive-viewer
replacement; capability parity with `OLD_SCRIPTS/video3D.py` viewing and
`simple_pointcloud_viewer.py` top-down plots). ``--view html`` (or
``--html``) emits a self-contained interactive WebGL viewer instead —
the headless stand-in for the reference's onscreen Open3D windows
(`img_to_normalized_pointcloud.py:38-223`).

Copy of ``ml_depth_pro_video_tpu/cli/view_pointcloud.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import os

from ..geom.floorplan_viz import floorplan_visualization
from ..geom.html_viewer import export_html
from ..geom.pointcloud import read_ply
from ..geom.render import save_render


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Render a .ply point cloud")
    ap.add_argument("pointcloud")
    ap.add_argument("-o", "--output", required=True, help="output PNG (or .html)")
    ap.add_argument("--view", default="multi",
                    choices=["front", "top", "side", "iso", "multi", "floorplan", "html"])
    ap.add_argument("--html", action="store_true",
                    help="shorthand for --view html (interactive offline viewer)")
    ap.add_argument("--max_points", type=int, default=1_000_000,
                    help="html view: subsample cap for the embedded cloud")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--point_size", type=int, default=2)
    ap.add_argument("--height_threshold", type=float, default=None,
                    help="drop points below this height (any view)")
    ap.add_argument("--fit_shapes", action="store_true")
    ap.add_argument("--dpi", type=int, default=150, help="floorplan view only")
    args = ap.parse_args(argv)

    cloud = read_ply(args.pointcloud)
    if args.html:
        args.view = "html"
    if args.view == "html":
        if args.height_threshold is not None:
            cloud = cloud.select(cloud.points[:, 1] >= args.height_threshold)
        out = args.output
        if os.path.splitext(out)[1].lower() not in (".html", ".htm"):
            out = os.path.splitext(out)[0] + ".html"
        export_html(cloud, out,
                    title=os.path.basename(args.pointcloud),
                    max_points=args.max_points,
                    point_size=args.point_size)
        print(f"wrote {out}")
        return
    if args.view == "floorplan":
        floorplan_visualization(cloud, args.output,
                                height_threshold=args.height_threshold,
                                point_size=args.point_size, dpi=args.dpi,
                                fit_shapes=args.fit_shapes)
    else:
        if args.height_threshold is not None:
            cloud = cloud.select(cloud.points[:, 1] >= args.height_threshold)
        save_render(args.output, cloud, view=args.view,
                    width=args.width, height=args.height,
                    point_size=args.point_size)
    print(f"wrote {args.output}")


if __name__ == "__main__":  # pragma: no cover
    main()
