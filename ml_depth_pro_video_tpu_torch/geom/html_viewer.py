"""Self-contained interactive HTML viewers (point clouds and meshes).

Capability parity with the reference's interactive Open3D windows
(`img_to_normalized_pointcloud.py:38-223` onscreen path,
`OLD_SCRIPTS/video3D.py:70-78` `draw_geometries`, and
`pointcloud_to_mesh.py:532` `visualize_mesh`): on a headless host we
cannot open a GL window, so instead we emit ONE dependency-free HTML
file with the geometry embedded (base64 float32/uint8/uint32) and a
hand-written WebGL orbit viewer — it opens offline in any browser, with
left-drag rotate, wheel zoom, and right-drag pan. Meshes render with
per-vertex normals and a camera headlight; point clouds as gl.POINTS.

The file is fully self-contained: no CDN, no three.js, no network.

Copy of ``ml_depth_pro_video_tpu/geom/html_viewer.py`` (host code: the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import base64
import html as _html

import numpy as np

from .pointcloud import PointCloud

# ---------------------------------------------------------------------------
# the embedded viewer: minimal WebGL1 + orbit controls, ~170 lines of JS

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
  html, body { margin: 0; height: 100%; overflow: hidden; background: #111; }
  #c { width: 100%; height: 100%; display: block; }
  #hud { position: fixed; top: 8px; left: 10px; color: #ccc;
         font: 12px monospace; user-select: none; }
</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="hud">__TITLE__ &middot; __HUD__ &middot;
  drag: rotate &middot; wheel: zoom &middot; right-drag: pan</div>
<script>
"use strict";
const POS_B64 = "__POS__";
const COL_B64 = "__COL__";
const NRM_B64 = "__NRM__";
const IDX_B64 = "__IDX__";
const N = __NPTS__;
const N_INDEX = __NIDX__;
const CENTER = __CENTER__;
const RADIUS = __RADIUS__;
const POINT_SIZE = __PSIZE__;

function b64ToBytes(s) {
  const bin = atob(s), out = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) out[i] = bin.charCodeAt(i);
  return out;
}
const positions = new Float32Array(b64ToBytes(POS_B64).buffer);
const colors = b64ToBytes(COL_B64);

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", { antialias: true });

const VS_POINTS = `
attribute vec3 aPos; attribute vec3 aCol;
uniform mat4 uMVP; uniform float uSize;
varying vec3 vCol;
void main() {
  gl_Position = uMVP * vec4(aPos, 1.0);
  gl_PointSize = uSize;
  vCol = aCol;
}`;
const VS_MESH = `
attribute vec3 aPos; attribute vec3 aCol; attribute vec3 aNorm;
uniform mat4 uMVP; uniform vec3 uEye;
varying vec3 vCol;
void main() {
  gl_Position = uMVP * vec4(aPos, 1.0);
  vec3 L = normalize(uEye - aPos);
  float diff = abs(dot(normalize(aNorm), L));   // two-sided headlight
  vCol = aCol * (0.25 + 0.75 * diff);
}`;
const FS = `
precision mediump float; varying vec3 vCol;
void main() { gl_FragColor = vec4(vCol, 1.0); }`;

function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  return s;
}
const isMesh = N_INDEX > 0;
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, isMesh ? VS_MESH : VS_POINTS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);

function attr(name, data, normalize) {
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
  const loc = gl.getAttribLocation(prog, name);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc, 3,
    normalize ? gl.UNSIGNED_BYTE : gl.FLOAT, normalize, 0, 0);
}
attr("aPos", positions, false);
attr("aCol", colors, true);
let indexType = 0;
if (isMesh) {
  attr("aNorm", new Float32Array(b64ToBytes(NRM_B64).buffer), false);
  const raw = b64ToBytes(IDX_B64);
  const ibuf = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibuf);
  if (N <= 65535) {
    const idx32 = new Uint32Array(raw.buffer);
    const idx16 = new Uint16Array(idx32.length);
    for (let i = 0; i < idx32.length; i++) idx16[i] = idx32[i];
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, idx16, gl.STATIC_DRAW);
    indexType = gl.UNSIGNED_SHORT;
  } else {
    gl.getExtension("OES_element_index_uint");
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint32Array(raw.buffer), gl.STATIC_DRAW);
    indexType = gl.UNSIGNED_INT;
  }
}
const uMVP = gl.getUniformLocation(prog, "uMVP");
const uSize = gl.getUniformLocation(prog, "uSize");
const uEye = gl.getUniformLocation(prog, "uEye");

// --- tiny mat4 helpers (column-major) ---
function perspective(fovy, aspect, near, far) {
  const f = 1 / Math.tan(fovy / 2), nf = 1 / (near - far);
  return [f / aspect, 0, 0, 0,  0, f, 0, 0,
          0, 0, (far + near) * nf, -1,  0, 0, 2 * far * near * nf, 0];
}
function mul(a, b) {
  const o = new Array(16).fill(0);
  for (let c = 0; c < 4; c++)
    for (let r = 0; r < 4; r++)
      for (let k = 0; k < 4; k++)
        o[c * 4 + r] += a[k * 4 + r] * b[c * 4 + k];
  return o;
}
function orbitEye(az, el, dist, target) {
  const ce = Math.cos(el), se = Math.sin(el);
  return [target[0] + dist * ce * Math.sin(az),
          target[1] + dist * se,
          target[2] + dist * ce * Math.cos(az)];
}
function lookAt(eye, target) {
  let fwd = [target[0] - eye[0], target[1] - eye[1], target[2] - eye[2]];
  const fl = Math.hypot(fwd[0], fwd[1], fwd[2]);
  fwd = fwd.map(v => v / fl);
  const upW = [0, 1, 0];
  let right = [fwd[1] * upW[2] - fwd[2] * upW[1],
               fwd[2] * upW[0] - fwd[0] * upW[2],
               fwd[0] * upW[1] - fwd[1] * upW[0]];
  const rl = Math.hypot(right[0], right[1], right[2]) || 1;
  right = right.map(v => v / rl);
  const up = [right[1] * fwd[2] - right[2] * fwd[1],
              right[2] * fwd[0] - right[0] * fwd[2],
              right[0] * fwd[1] - right[1] * fwd[0]];
  return [
    right[0], up[0], -fwd[0], 0,
    right[1], up[1], -fwd[1], 0,
    right[2], up[2], -fwd[2], 0,
    -(right[0] * eye[0] + right[1] * eye[1] + right[2] * eye[2]),
    -(up[0] * eye[0] + up[1] * eye[1] + up[2] * eye[2]),
    (fwd[0] * eye[0] + fwd[1] * eye[1] + fwd[2] * eye[2]), 1];
}

let az = 0.6, el = 0.35, dist = RADIUS * 2.5;
let tgt = CENTER.slice();
let dragging = 0, lastX = 0, lastY = 0;
canvas.addEventListener("contextmenu", e => e.preventDefault());
canvas.addEventListener("mousedown", e => {
  dragging = e.button === 2 ? 2 : 1; lastX = e.clientX; lastY = e.clientY;
});
window.addEventListener("mouseup", () => dragging = 0);
window.addEventListener("mousemove", e => {
  if (!dragging) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  if (dragging === 1) {
    az -= dx * 0.006;
    el = Math.max(-1.55, Math.min(1.55, el + dy * 0.006));
  } else {
    // pan in the camera plane
    const eye = orbitEye(az, el, dist, tgt);
    const v = lookAt(eye, tgt);
    const k = dist * 0.0012;
    tgt[0] -= (v[0] * dx - v[1] * dy) * k;
    tgt[1] -= (v[4] * dx - v[5] * dy) * k;
    tgt[2] -= (v[8] * dx - v[9] * dy) * k;
  }
  draw();
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  dist = Math.max(RADIUS * 0.05, Math.min(RADIUS * 40, dist));
  draw();
}, { passive: false });

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
    gl.viewport(0, 0, w, h);
  }
  gl.clearColor(0.066, 0.066, 0.066, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const proj = perspective(0.9, w / h, RADIUS * 0.01, RADIUS * 100);
  const eye = orbitEye(az, el, dist, tgt);
  gl.uniformMatrix4fv(uMVP, false, new Float32Array(mul(proj, lookAt(eye, tgt))));
  if (isMesh) {
    gl.uniform3f(uEye, eye[0], eye[1], eye[2]);
    gl.drawElements(gl.TRIANGLES, N_INDEX, indexType, 0);
  } else {
    gl.uniform1f(uSize, POINT_SIZE);
    gl.drawArrays(gl.POINTS, 0, N);
  }
}
window.addEventListener("resize", draw);
draw();
</script>
</body>
</html>
"""


def _colors_u8(colors, pts: np.ndarray) -> np.ndarray:
    """Colors -> (N, 3) uint8; height-ramp fallback for colorless input."""
    n = len(pts)
    if colors is None:
        y = pts[:, 1] if n else np.zeros(0, np.float32)
        lo, hi = (y.min(), y.max()) if n else (0.0, 1.0)
        t = (y - lo) / (hi - lo) if hi > lo else np.zeros_like(y)
        return np.stack([
            np.clip(255 * (0.28 + 0.7 * t), 0, 255),
            np.clip(255 * (0.1 + 0.8 * t), 0, 255),
            np.clip(255 * (0.55 - 0.4 * t), 0, 255),
        ], axis=1).astype(np.uint8)
    c = np.asarray(colors)
    if c.dtype.kind == "f":
        return (np.clip(c, 0, 1) * 255).astype(np.uint8)
    return np.clip(c, 0, 255).astype(np.uint8)


def _emit(path: str, title: str, hud: str, pts: np.ndarray, col8: np.ndarray,
          normals: np.ndarray | None, faces: np.ndarray | None,
          point_size: float) -> str:
    n = len(pts)
    center = pts.mean(axis=0) if n else np.zeros(3, np.float32)
    radius = float(np.linalg.norm(pts - center, axis=1).max()) if n else 1.0
    radius = max(radius, 1e-3)

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    doc = (
        _TEMPLATE
        .replace("__TITLE__", _html.escape(title))
        .replace("__HUD__", hud)
        .replace("__NPTS__", str(n))
        .replace("__NIDX__", str(0 if faces is None else 3 * len(faces)))
        .replace("__POS__", b64(pts.astype(np.float32)))
        .replace("__COL__", b64(col8))
        .replace("__NRM__", "" if normals is None else b64(normals.astype(np.float32)))
        .replace("__IDX__", "" if faces is None else b64(faces.astype(np.uint32)))
        .replace("__CENTER__", "[%.6g, %.6g, %.6g]" % tuple(center))
        .replace("__RADIUS__", "%.6g" % radius)
        .replace("__PSIZE__", "%.3g" % point_size)
    )
    with open(path, "w") as f:
        f.write(doc)
    return path


def export_html(
    cloud: PointCloud,
    path: str,
    title: str = "Point cloud",
    max_points: int = 1_000_000,
    point_size: float = 2.0,
    seed: int = 0,
) -> str:
    """Write a self-contained interactive HTML viewer for ``cloud``.

    Points above ``max_points`` are uniformly subsampled (seeded) to
    bound the file size (~16 bytes/point in base64). Returns ``path``.
    """
    pts = np.asarray(cloud.points, dtype=np.float32)
    colors = cloud.colors
    if len(pts) > max_points:
        idx = np.random.default_rng(seed).choice(
            len(pts), size=max_points, replace=False)
        idx.sort()
        pts = pts[idx]
        colors = None if colors is None else colors[idx]
    return _emit(path, title, f"{len(pts)} points", pts,
                 _colors_u8(colors, pts), None, None, point_size)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (unnormalized cross products
    accumulated per vertex, then unit-normalized)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    n = np.zeros_like(v)
    if len(f):
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        for k in range(3):
            np.add.at(n, f[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.divide(n, ln, out=np.tile(np.array([[0.0, 1.0, 0.0]]), (len(v), 1)),
                  where=ln > 1e-12)
    return n.astype(np.float32)


def export_mesh_html(
    mesh,
    path: str,
    title: str = "Mesh",
    point_size: float = 2.0,
) -> str:
    """Write a self-contained interactive HTML viewer for a
    ``geom.mesh.TriangleMesh`` (vertices/faces/vertex_colors): indexed
    triangles with per-vertex normals and a two-sided camera headlight.
    A mesh with no faces degrades to the point viewer."""
    verts = np.asarray(mesh.vertices, np.float32)
    faces = np.asarray(mesh.faces, np.int64)
    colors = getattr(mesh, "vertex_colors", None)
    if len(faces) == 0:
        return export_html(PointCloud(verts, colors), path, title=title,
                           point_size=point_size)
    col8 = _colors_u8(colors, verts)
    if colors is None:
        col8 = np.full_like(col8, 190)  # neutral gray shades better
    normals = vertex_normals(verts, faces)
    return _emit(path, title, f"{len(verts)} verts / {len(faces)} tris",
                 verts, col8, normals, faces, point_size)
