"""Point-cloud container and PLY/OBJ I/O.

Replaces the reference's Open3D ``PointCloud``/``TriangleMesh`` usage
(`img_to_normalized_pointcloud.py:1318`, `pointcloud_to_mesh.py:523`)
with a plain numpy container plus self-contained binary/ascii PLY and
OBJ writers — no native third-party geometry dependency.

Copy of ``ml_depth_pro_video_tpu/geom/pointcloud.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) float
    colors: np.ndarray | None = None  # (N, 3) float in [0, 1]

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64).reshape(-1, 3)
        if self.colors is not None:
            raw_shape = np.shape(self.colors)
            self.colors = np.asarray(self.colors, dtype=np.float64).reshape(-1, 3)
            if len(self.colors) != len(self.points):
                raise ValueError(
                    f"colors shape {raw_shape} does not provide one RGB "
                    f"triplet per point ({len(self.points)} points)"
                )

    def __len__(self) -> int:
        return len(self.points)

    def select(self, mask_or_idx) -> "PointCloud":
        return PointCloud(
            self.points[mask_or_idx],
            self.colors[mask_or_idx] if self.colors is not None else None,
        )

    def copy(self) -> "PointCloud":
        return PointCloud(
            self.points.copy(), None if self.colors is None else self.colors.copy()
        )


def write_ply(path: str, cloud: PointCloud, binary: bool = True) -> None:
    """Write a PLY file (binary little-endian by default)."""
    n = len(cloud)
    has_color = cloud.colors is not None
    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    pts = cloud.points.astype(np.float32)
    if has_color:
        rgb = np.clip(cloud.colors * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = pts
                rec["rgb"] = rgb
                f.write(rec.tobytes())
            else:
                f.write(pts.tobytes())
        else:
            for i in range(n):
                row = f"{pts[i,0]} {pts[i,1]} {pts[i,2]}"
                if has_color:
                    row += f" {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}"
                f.write((row + "\n").encode())


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> PointCloud:
    """Read the vertex element of a PLY file: written by
    :func:`write_ply` or common tool output (Open3D etc.) — any scalar
    property types, ascii or binary either-endian, trailing non-vertex
    elements (e.g. a mesh's face list) ignored. The vertex element must
    come first in a binary file (it does in practice — PLY convention)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        # collect only the VERTEX element's scalar properties; elements
        # after it (faces etc.) are ignored, elements before it are not
        # supported for binary reads (no fixed offset without parsing them)
        n = None
        props: list[tuple[str, str]] = []
        current = None
        vertex_first = True
        for l in header:
            parts = l.split()
            if not parts:
                continue
            if parts[0] == "element":
                if parts[1] == "vertex":
                    current = "vertex"
                    n = int(parts[2])
                else:
                    if n is None:
                        vertex_first = False
                    current = parts[1]
            elif parts[0] == "property" and current == "vertex":
                if parts[1] == "list":
                    raise ValueError(
                        f"{path}: list-typed vertex properties are not supported")
                props.append((parts[1], parts[2]))
        if n is None:
            raise ValueError(f"{path}: no vertex element in PLY header")

        uchar_colors = any(
            name in ("red", "green", "blue") and _PLY_TYPES.get(typ) == "u1"
            for typ, name in props
        )
        if not vertex_first:
            # without parsing the preceding element's rows there is no
            # way to find the vertex data in EITHER format — ascii used
            # to silently load the wrong element's rows as points
            raise ValueError(
                f"{path}: PLY with elements before 'vertex' is not supported")
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n, ndmin=2) if n else np.zeros((0, len(props)))
            cols = {name: data[:, i] for i, (_, name) in enumerate(props)}
        else:
            endian = ">" if fmt == "binary_big_endian" else "<"
            try:
                dtype = np.dtype([(name, endian + _PLY_TYPES[typ]) for typ, name in props])
            except KeyError as exc:
                raise ValueError(f"{path}: unsupported PLY property type {exc}") from None
            rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            cols = {name: rec[name] for _, name in props}
    points = np.column_stack([cols["x"], cols["y"], cols["z"]]).astype(np.float64)
    colors = None
    if "red" in cols:
        colors = np.column_stack([cols["red"], cols["green"], cols["blue"]]).astype(np.float64)
        # integer-typed colors are ALWAYS byte-scaled — a values-based
        # guess would read a near-black uchar cloud as full-bright
        if uchar_colors:
            colors = colors / 255.0
        elif len(colors) and colors.max() > 1.0:
            colors = colors / 255.0
    return PointCloud(points, colors)


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """Write a triangle mesh as OBJ (1-based face indices)."""
    with open(path, "w") as f:
        f.write("# ml-depth-pro-video-tpu mesh\n")
        if vertex_colors is not None:
            for v, c in zip(vertices, vertex_colors):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        else:
            for v in vertices:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces, dtype=np.int64) + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
