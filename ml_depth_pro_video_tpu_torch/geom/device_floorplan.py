"""Frames -> floor plan geometry on the card (``--geometry device``).

The port's own version of ``ml_depth_pro_video_tpu/geom/device_floorplan.py``,
in plain PyTorch ops on one device (``cuda`` unless the caller asks for the
CPU). The host pipeline (``video/pipeline.py``) spends its time per frame in
the host geometry chain; this module runs the same stage chain over the
depth-map grid on the device, where every stage is regular (the cloud IS an
(H, W) grid): unproject -> ground-normalise -> grid ground adjustment ->
stray filter -> shadow-column filter -> height split -> tallest-wins colour
splat. The host then only fetches the raster and writes it to PNG.

Agreement with the host chain (``tests/test_torch_device_floorplan.py``):

- unproject / rotate / clamps / global floor percentile / per-cell
  grid-adjust percentiles: the same math (fp32 here against the host's
  float64; percentiles are exact order statistics via sort, matching
  np.percentile's linear interpolation).
- shadow-column filter: same grouping, same pair-angle counting rule,
  with one divergence: the even-pair-count median tie (the host computes
  the exact two-middle-value median; here a tie keeps the cell).
- stray filter: 27-voxel-block counts (voxel edge = radius) instead of
  exact sphere counts: an over-count, so the device only ever keeps points
  the exact rule would drop (never drops a kept point).

Written for a device that PyTorch drives from the host:

- No host round trip inside the program: data-dependent scalars (the
  extents, the floor percentile's gate, the shadow grid's size) stay 0-d
  tensors; no ``.item()``, no boolean-mask indexing, no ``nonzero``. The
  one host sync per frame is the raster's fetch.
- Float -> int casts: torch leaves the cast of NaN, inf or an out-of-range
  value undefined (and the CPU and CUDA differ), so each value is masked
  (invalid points to 0) and clamped in floating point before its cast.
  Masked points never reach an output, so the results stay the JAX
  program's.
- fp32 in the JAX program's order of operations; the rotation and the
  plane distance are elementwise multiply-adds, not a matmul that TF32
  could touch.
- Scatters: ``index_add_`` for the voxel counts (``bincount`` reads its
  maximum back to the host on CUDA), ``scatter_reduce_("amax")`` for the
  height buffer (it returns an input exactly, which the winner test
  needs), ``index_copy_`` for the colours (a tied point's colour may land,
  as in the JAX program).

Scope: the plain-mode floor plan (``fast_floorplan_image`` semantics:
tallest-point-wins splat + radius-1 dilation, fixed axis limits). Shape
fitting stays on the host: it needs the cleaned cloud, which this mode
does not fetch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import torch

from ..core.precision import resolve_device
from .ground import HORIZONTAL, grid_ground_adjustment, normalize_to_ground, rotation_between
from .unproject import depth_to_3d

INF = float("inf")
SHADOW_SENTINEL = 2**31 - 1  # above any shadow cell id (nx * nz <= 2^30)


@dataclasses.dataclass(frozen=True)
class DeviceFloorplanConfig:
    """Static configuration of one per-frame program."""

    height: int  # depth-map rows
    width: int  # depth-map cols
    x_limits: tuple  # raster framing (meters, pre-flip)
    z_limits: tuple
    raster_width: int = 1024
    height_threshold: float = 0.1  # floorplan keeps y >= this
    max_depth: float | None = None
    # stray filter (remove_stray_points defaults)
    stray_nb_points: int = 20
    stray_radius: float = 0.1
    # voxel edge = stray_radius * stray_cell_scale; the block half-width
    # grows to keep covering the radius-r sphere (scale 1.0 = 3³ block,
    # 0.5 = 5³). Smaller cells tighten the over-count at 8x the grid
    # memory; both preserve keep ⊇ exact.
    stray_cell_scale: float = 0.5
    # voxel-grid bounds for the stray counts (normalized-cloud meters);
    # points outside clamp into the edge voxels
    voxel_bounds: tuple = ((-10.0, 10.0), (-0.5, 6.0), (0.0, 20.0))
    # shadow filter (clean_shadows defaults)
    shadow_height_threshold: float = 0.1
    max_shadow_angle: float = 75.0
    min_points_per_column: int = 3
    # grid ground adjustment
    grid_size: int = 20
    ground_percentile: float = 5.0
    point_radius: int = 1
    background: tuple = (0.94, 0.94, 0.94)
    # pixel stride through the depth grid: 1 = every point (the parity
    # setting); 2 = a quarter of the points, while the 1024-wide raster
    # stays covered (splat + dilation). Per-pixel geometry stays exact
    # (original pixel coordinates unproject); only the cleanup statistics
    # and the splat density see the thinner cloud.
    subsample: int = 1

    @property
    def raster_height(self) -> int:
        (x0, x1), (z0, z1) = self.x_limits, self.z_limits
        span_x = max(x1 - x0, 1e-9)
        span_z = max(z1 - z0, 1e-9)
        # a degenerate aspect (garbage depth framing) must not allocate an
        # unbounded device raster
        return min(max(int(round(self.raster_width * span_z / span_x)), 1), 8192)


def _cell_index(v: torch.Tensor, valid: torch.Tensor, hi) -> torch.Tensor:
    """int64 of ``v`` (already floored or truncated) clipped to [0, hi],
    clamped in floating point before the cast; invalid points read 0."""
    v = torch.where(valid, v, 0.0).clamp(min=0.0)
    v = torch.minimum(v, hi) if torch.is_tensor(hi) else v.clamp(max=float(hi))
    return v.long()


def _pixel(v: torch.Tensor, size: int) -> torch.Tensor:
    """``v.astype(int32)`` (truncation toward zero) where the result decides
    only whether 0 <= pixel < size: clamped to [-1, size] first, so every
    out-of-range or non-finite value stays out of range after the cast."""
    return v.nan_to_num(nan=-1.0).clamp(-1.0, float(size)).trunc().long()


def _masked_percentile(vals: torch.Tensor, mask: torch.Tensor, pct: float) -> torch.Tensor:
    """np.percentile(vals[mask], pct) (linear interpolation) as a 0-d
    tensor: masked values sort to +inf, the order statistic indexes the
    prefix."""
    v = torch.where(mask, vals, INF).sort().values
    n = mask.sum()
    pos = (n - 1).float() * (pct / 100.0)
    last = v.shape[0] - 1
    lo = pos.floor().clamp(0, last).long().reshape(1)
    hi = pos.ceil().clamp(0, last).long().reshape(1)
    frac = pos - lo.float()
    return (v.index_select(0, lo) * (1.0 - frac) + v.index_select(0, hi) * frac).reshape(())


def _segment_sort(cell, y, valid, sentinel: int):
    """Stable lexicographic sort by (cell, y); invalid points get the
    sentinel cell so they group at the end. Returns sorted (cell, y,
    original index). Two stable passes: y first, then the cell."""
    key = torch.where(valid, cell, sentinel)
    _, by_y = torch.sort(y, stable=True)
    _, by_cell = torch.sort(key[by_y], stable=True)
    idx = by_y[by_cell]
    return key[idx], y[idx], idx


def _segment_bounds(cell_sorted):
    """Per-point [start, last] indices of the point's contiguous sorted
    segment: each segment's first and last index is scattered to the
    segment's id (a cumsum of the segment starts) and gathered back per
    point. The JAX program takes a prefix max and min scan instead, which
    keeps scatters off the TPU; torch's cummax / cummin run one long row as
    one scan on CUDA and took 80% of the program there."""
    n = cell_sorted.shape[0]
    dev = cell_sorted.device
    idx = torch.arange(n, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_seg = torch.cat([one, cell_sorted[1:] != cell_sorted[:-1]])
    is_last = torch.cat([new_seg[1:], one])
    seg = torch.cumsum(new_seg, 0) - 1

    def at_segment(flags):
        # one write per segment id; every other point writes a slot of its own past n
        slots = torch.empty(2 * n, dtype=torch.long, device=dev)
        return slots.scatter_(0, torch.where(flags, seg, n + idx), idx)[seg]

    return at_segment(new_seg), at_segment(is_last)


def _valid_extent(v, valid):
    return torch.where(valid, v, INF).amin(), torch.where(valid, v, -INF).amax()


def unproject_normalize(depth, f_px, cfg: DeviceFloorplanConfig, rot, shift, normal, d):
    """Flat (N,) normalized coordinates + validity, mirroring
    ``geom/unproject.depth_to_3d`` + ``geom/ground.normalize_to_ground``."""
    h, w, s = cfg.height, cfg.width, cfg.subsample
    dev = depth.device
    # ORIGINAL pixel indices survive the stride
    ys = torch.arange(0, h, s, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(0, w, s, dtype=torch.float32, device=dev)[None, :]
    z = depth[::s, ::s].float()
    valid = torch.isfinite(z) & (z > 0)
    if cfg.max_depth is not None:
        valid &= z < cfg.max_depth
    x = (-(xs - w / 2.0) * z / f_px).reshape(-1)
    y = (-(ys - h / 2.0) * z / f_px).reshape(-1)
    z = z.reshape(-1)
    valid = valid.reshape(-1)

    # signed plane distance on the RAW points (normalize_to_ground)
    nrm = normal / torch.linalg.vector_norm(normal)
    dist = x * nrm[0] + y * nrm[1] + z * nrm[2] + d
    ox = x * rot[0, 0] + y * rot[0, 1] + z * rot[0, 2]
    oy = x * rot[1, 0] + y * rot[1, 1] + z * rot[1, 2] - shift
    oz = x * rot[2, 0] + y * rot[2, 1] + z * rot[2, 2]

    # floor alignment: 2-percentile of y over near-plane points
    ground_near = (dist.abs() < 0.1) & valid
    y_shift = torch.where(ground_near.sum() > 10, _masked_percentile(oy, ground_near, 2.0), 0.0)
    oy = oy - y_shift

    ground_mask = dist.abs() < 0.05
    oy = torch.where((oy < 0) & ground_mask, 0.0, oy)
    oy = torch.where((oy < -0.1) & ~ground_mask, -0.1, oy)
    return ox, oy, oz, valid


def _grid_adjust(ox, oy, oz, valid, cfg: DeviceFloorplanConfig):
    """``geom/ground.grid_ground_adjustment``: per-XZ-cell p-percentile of
    the sub-0.2 m heights, height-graduated lowering. Percentiles are exact
    order statistics (one (cell, y) sort)."""
    g = cfg.grid_size
    n = ox.shape[0]
    x_min, x_max = _valid_extent(ox, valid)
    z_min, z_max = _valid_extent(oz, valid)
    # digitize against linspace edges == floor against the uniform step,
    # with the right edge landing in the last cell (the host clips the same)
    xi = _cell_index(((ox - x_min) / torch.clamp(x_max - x_min, min=1e-12) * g).floor(),
                     valid, g - 1)
    zi = _cell_index(((oz - z_min) / torch.clamp(z_max - z_min, min=1e-12) * g).floor(),
                     valid, g - 1)
    cell_sorted, y_sorted, idx_sorted = _segment_sort(xi * g + zi, oy, valid, g * g)

    # y ascends within a segment, so the sub-0.2 m subset is its prefix and
    # its size a cumsum boundary difference
    start, last = _segment_bounds(cell_sorted)
    cnt = last - start + 1
    low_c = torch.cat([torch.zeros(1, dtype=torch.long, device=ox.device),
                       torch.cumsum((y_sorted < 0.2).long(), 0)])
    k = low_c[last + 1] - low_c[start]
    # the host gates (>=10 points, >=5 low points) are DENSITY gates; a
    # subsampled cloud is ~s² thinner, so they scale with it
    s2 = cfg.subsample ** 2
    min_cnt = 10 if s2 == 1 else max(3, round(10 / s2))
    min_low = 5 if s2 == 1 else max(2, round(5 / s2))
    ok = (cnt >= min_cnt) & (k >= min_low)
    # percentile over the cell's ascending low prefix [start, start+k)
    pos = (k - 1).float() * (cfg.ground_percentile / 100.0)
    lo = (start + pos.floor().clamp(min=0).long()).clamp(0, n - 1)
    hi = (start + pos.ceil().clamp(min=0).long()).clamp(0, n - 1)
    frac = pos - pos.floor()
    y_pct = y_sorted[lo] * (1.0 - frac) + y_sorted[hi] * frac
    y_pct = torch.where(ok & (y_pct > 0.01), y_pct, 0.0)

    # back to the original point order (the inverse permutation)
    per_point_pct = torch.zeros_like(y_pct).index_copy_(0, idx_sorted, y_pct)
    active = per_point_pct > 0
    adj = torch.where(active & (oy < 0.1), per_point_pct, 0.0)
    mid = active & (oy >= 0.1) & (oy < 1.5)
    adj = torch.where(mid, per_point_pct * (1.0 - (oy - 0.1) / 1.4), adj)
    out_y = oy - adj
    return torch.where(active & (out_y < 0), 0.0, out_y)


def _box(a: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Sum over the (2k+1)-wide window along ``axis``, zeros outside."""
    out = a.clone()
    size = a.shape[axis]
    for off in range(1, min(k, size - 1) + 1):
        out.narrow(axis, off, size - off).add_(a.narrow(axis, 0, size - off))
        out.narrow(axis, 0, size - off).add_(a.narrow(axis, off, size - off))
    return out


def stray_keep(ox, oy, oz, valid, cfg: DeviceFloorplanConfig):
    """Voxel-block stray filter: per-point count of points in the
    (2k+1)³-voxel neighbourhood, a superset of the exact radius-``r``
    sphere, so ``keep ⊇ remove_stray_points``'s keep."""
    r = cfg.stray_radius * cfg.stray_cell_scale
    k = int(np.ceil(1.0 / cfg.stray_cell_scale))  # block half-width in cells
    (x0, x1), (y0, y1), (z0, z1) = cfg.voxel_bounds
    nx = int(np.ceil((x1 - x0) / r))
    ny = int(np.ceil((y1 - y0) / r))
    nz = int(np.ceil((z1 - z0) / r))
    xi = _cell_index(((ox - x0) / r).floor(), valid, nx - 1)
    yi = _cell_index(((oy - y0) / r).floor(), valid, ny - 1)
    zi = _cell_index(((oz - z0) / r).floor(), valid, nz - 1)
    flat = (xi * ny + yi) * nz + zi
    grid = torch.zeros(nx * ny * nz, dtype=torch.int32, device=ox.device)
    grid = grid.index_add_(0, flat, valid.int()).view(nx, ny, nz)
    blocked = _box(_box(_box(grid, 0, k), 1, k), 2, k)
    cnt = blocked.view(-1)[flat]
    # the host rule keeps when exact neighbours + self >= nb_points; the block
    # count includes self already. Subsampling thins the cloud ~s², so the
    # density threshold scales with it (floor 2: a point plus one neighbour)
    nb = (cfg.stray_nb_points if cfg.subsample == 1
          else max(2, round(cfg.stray_nb_points / (cfg.subsample ** 2))))
    return valid & (cnt >= nb)


def shadow_keep(ox, oy, oz, valid, cfg: DeviceFloorplanConfig):
    """``geom/clean.clean_shadows``: same cell sizing, same pair-angle
    counting; even-count median TIES keep the cell (the host resolves them
    with the exact median)."""
    n = ox.shape[0]
    x_min, x_max = _valid_extent(ox, valid)
    z_min, z_max = _valid_extent(oz, valid)
    area = torch.clamp((x_max - x_min) * (z_max - z_min), min=1e-9)
    density = valid.sum().float() / area
    cell_size = torch.clamp(1.0 / torch.sqrt(torch.clamp(density / 10.0, min=1e-12)), min=0.05)

    # coarsen the grid until nx*nz <= 2^30 (only degenerate framings, at
    # kilometre extents, trigger it); cell ids stay injective at every scale
    nx = torch.clamp(torch.ceil((x_max - x_min) / cell_size), min=1.0)
    nz = torch.clamp(torch.ceil((z_max - z_min) / cell_size), min=1.0)
    cell_size = cell_size * torch.sqrt(torch.clamp(nx * nz / 2.0**30, min=1.0))
    nx = torch.clamp(torch.ceil((x_max - x_min) / cell_size), min=1.0)
    nz = torch.clamp(torch.ceil((z_max - z_min) / cell_size), min=1.0)
    xi = _cell_index(((ox - x_min) / cell_size).trunc(), valid, nx - 1)
    zi = _cell_index(((oz - z_min) / cell_size).trunc(), valid, nz - 1)
    cell_sorted, y_sorted, idx_sorted = _segment_sort(xi * nz.long() + zi, oy, valid,
                                                      SHADOW_SENTINEL)
    seg_valid = cell_sorted < SHADOW_SENTINEL

    # y ascends within a segment, so its extent is last minus first
    start, last = _segment_bounds(cell_sorted)
    seg_cnt = last - start + 1
    # density gate scales with the subsample thinning (s=1 = host exact);
    # floor 2: a "column" needs at least one pair
    mppc = max(cfg.min_points_per_column, 3)
    if cfg.subsample > 1:
        mppc = max(2, round(mppc / cfg.subsample ** 2))
    qual = (seg_cnt >= mppc) & (y_sorted[last] - y_sorted[start] > cfg.shadow_height_threshold)

    # consecutive height-sorted pairs within a cell: every adjacent pair of
    # a segment is same-cell, so segment s's pairs are exactly [start, last)
    # and per-segment pair sums are cumsum boundary differences
    dvy = y_sorted.diff()
    dn2 = dvy * dvy + ox[idx_sorted].diff() ** 2 + oz[idx_sorted].diff() ** 2

    cos_t = float(np.cos(np.radians(cfg.max_shadow_angle)))
    # sign-aware squared test: angle < t <=> dvy > cos(t)*|v|
    if cos_t >= 0:
        below = (dvy > 0) & (dvy * dvy > cos_t * cos_t * dn2)
    else:
        below = ~((dvy < 0) & (dvy * dvy >= cos_t * cos_t * dn2))

    zero = torch.zeros(1, dtype=torch.long, device=ox.device)

    def pair_segment_sum(flags):
        c = torch.cat([zero, torch.cumsum(flags.long(), 0)])
        return c[last] - c[start]

    m = torch.where(qual, seg_cnt - 1, 0)
    cnt_below = torch.where(qual, pair_segment_sum(below), 0)
    drop = torch.where(m % 2 == 1, cnt_below >= (m + 1) // 2,
                       cnt_below >= m // 2 + 1) & (m > 0)
    # duplicate-point pairs (zero length) NaN the host's median -> keep
    drop &= pair_segment_sum(dn2 == 0) == 0

    keep_sorted = ~drop | ~seg_valid
    keep = torch.empty_like(keep_sorted)
    keep[idx_sorted] = keep_sorted
    return valid & keep


def splat_raster(ox, oy, oz, colors, valid, cfg: DeviceFloorplanConfig, background):
    """``geom/floorplan_viz.fast_floorplan_image``: flip X, tallest-point-wins
    colour splat at fixed limits, radius-``point_radius`` dilation."""
    W, H = cfg.raster_width, cfg.raster_height
    (x0, x1), (z0, z1) = cfg.x_limits, cfg.z_limits
    span_x = max(x1 - x0, 1e-9)
    span_z = max(z1 - z0, 1e-9)

    px = _pixel((-ox - x0) / span_x * (W - 1), W)
    pz = _pixel((z1 - oz) / span_z * (H - 1), H)
    ok = valid & (oy >= cfg.height_threshold) & (px >= 0) & (px < W) & (pz >= 0) & (pz < H)
    lin = torch.where(ok, pz * W + px, H * W)  # rejected -> overflow slot

    hbuf = torch.full((H * W + 1,), -INF, dtype=torch.float32, device=ox.device)
    hbuf = hbuf.scatter_reduce_(0, lin, torch.where(ok, oy, -INF), "amax", include_self=True)
    # winners re-scatter their colour; losers go to the overflow slot (ties:
    # any tied point's colour may land)
    win = ok & (hbuf[lin] == oy)
    img = torch.zeros((H * W + 1, 3), dtype=torch.float32, device=ox.device)
    img = img.index_copy_(0, torch.where(win, lin, H * W), colors)
    hbuf = hbuf[:-1].view(H, W)
    img = img[:-1].view(H, W, 3)

    r = cfg.point_radius
    src_h, src_img = hbuf, img
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            ys0, ys1 = max(dy, 0), H + min(dy, 0)
            xs0, xs1 = max(dx, 0), W + min(dx, 0)
            sh = torch.full_like(src_h, -INF)
            sh[ys0:ys1, xs0:xs1] = src_h[ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
            simg = torch.zeros_like(src_img)
            simg[ys0:ys1, xs0:xs1] = src_img[ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
            winm = sh > hbuf
            img = torch.where(winm[..., None], simg, img)
            hbuf = torch.where(winm, sh, hbuf)

    img = torch.where((hbuf > -INF)[..., None], img, background)
    return img, hbuf


def _on(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; a host array is uploaded without
    waiting for the device (no host sync)."""
    return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)


def make_device_floorplan(cfg: DeviceFloorplanConfig, ground_model: dict, debug: bool = False,
                          device="cuda"):
    """Build the per-frame program on ``device``.

    ``fn(depth (H,W) f32, rgb (H,W,3) uint8, f_px scalar) -> {"raster":
    (Hr,Wr,3) f32, ...}``, each a host array or a tensor; the outputs are
    tensors on ``device``. With ``debug=True`` the dict also carries the
    per-stage coordinates and masks (``x``, ``y``, ``z``, ``valid``,
    ``keep_stray``, ``keep``, ``hbuf``) that the parity tests compare.
    """
    dev = resolve_device(device)
    normal = np.asarray(ground_model["normal"], np.float64)
    nrm = normal / np.linalg.norm(normal)
    d = float(ground_model["d"])
    if abs(nrm @ HORIZONTAL) > 0.99:
        rot, shift = np.eye(3), 0.0
    else:
        rot = rotation_between(normal, HORIZONTAL)
        shift = -d / float((rot @ normal)[1])
    consts = {name: torch.tensor(v, dtype=torch.float32, device=dev) for name, v in (
        ("rot", rot), ("shift", shift), ("normal", nrm), ("d", d),
        ("background", cfg.background))}

    def fn(depth, rgb, f_px):
        depth = _on(depth, dev, torch.float32)
        rgb = _on(rgb, dev)
        f_px = _on(f_px, dev, torch.float32)
        ox, oy, oz, valid = unproject_normalize(depth, f_px, cfg, consts["rot"], consts["shift"],
                                                consts["normal"], consts["d"])
        oy = _grid_adjust(ox, oy, oz, valid, cfg)
        keep_s = stray_keep(ox, oy, oz, valid, cfg)
        keep = shadow_keep(ox, oy, oz, keep_s, cfg)
        ss = cfg.subsample
        # XLA divides by a constant as a multiply by its reciprocal: the same
        # bits as the JAX program's colours
        colors = rgb[::ss, ::ss].reshape(-1, 3).float() * (1.0 / 255.0)
        raster, hbuf = splat_raster(ox, oy, oz, colors, keep, cfg, consts["background"])
        out = {"raster": raster}
        if debug:
            out.update(x=ox, y=oy, z=oz, valid=valid, keep_stray=keep_s, keep=keep, hbuf=hbuf)
        return out

    return fn


class DeviceFloorplanSession:
    """Per-video wrapper for the pipeline's ``--geometry device`` mode:
    derives the raster's fixed framing from the first frame (one host-chain
    pass per video, mirroring the fixed-axis framing of the host path)
    unless explicit limits are given, builds the program lazily on
    ``device`` and writes the fetched raster to PNG. Thread-safe:
    ``video/pipeline`` calls :meth:`process` from its geometry worker pool."""

    def __init__(self, ground_model: dict, height_threshold: float = 1.3,
                 x_limits=None, z_limits=None, raster_width: int = 1024,
                 max_depth: float | None = None,
                 limits_cache: str | None = None, subsample: int = 1, device="cuda"):
        self.device = resolve_device(device)
        # pixel stride (DeviceFloorplanConfig.subsample): 2 takes a quarter
        # of the points
        self.subsample = max(int(subsample), 1)
        self.ground_model = ground_model
        self.height_threshold = float(height_threshold)
        self.x_limits = tuple(x_limits) if x_limits is not None else None
        self.z_limits = tuple(z_limits) if z_limits is not None else None
        self.raster_width = int(raster_width)
        self.max_depth = max_depth
        # persisted derived framing (a ground.json-style sidecar): without it
        # a --resume run would derive limits from the first UNPROCESSED frame
        # and the video's plans would jump in scale and offset mid-sequence
        self.limits_cache = limits_cache
        self.cfg = None
        self._fn = None
        self._shape = None
        self._lock = threading.Lock()

    def _derive_limits(self, depth, f_px):
        """Fixed-axis framing from one host-chain pass (once per video)."""
        pts, _ = depth_to_3d(depth, f_px, max_depth=self.max_depth)
        pts = grid_ground_adjustment(normalize_to_ground(pts, self.ground_model))
        m = pts[:, 1] >= self.height_threshold
        if not m.any():  # degenerate frame: frame everything
            m = np.ones(len(pts), bool)
        x, z = -pts[m, 0], pts[m, 2]
        # percentile framing, not min/max: an untrained or degenerate model
        # clamps depth at 1e4 m and a single such ray would blow the frame
        # (and the voxel grid) up by four orders of magnitude
        x0, x1 = np.percentile(x, [0.5, 99.5])
        z0, z1 = np.percentile(z, [0.5, 99.5])
        mx = 0.05 * max(float(x1 - x0), 1e-3)
        mz = 0.05 * max(float(z1 - z0), 1e-3)
        self.x_limits = (float(x0) - mx, float(x1) + mx)
        self.z_limits = (float(z0) - mz, float(z1) + mz)

    def _fingerprint(self) -> str:
        """Identity of everything the derived framing depends on: a cached
        limits file from a different ground fit or threshold is re-derived,
        not silently reused."""
        n = np.asarray(self.ground_model["normal"], np.float64)
        return (f"n={n[0]:.9f},{n[1]:.9f},{n[2]:.9f};"
                f"d={float(self.ground_model['d']):.9f};"
                f"ht={self.height_threshold};md={self.max_depth}")

    def _build(self, depth, f_px):
        if self.x_limits is None or self.z_limits is None:
            cached = None
            if self.limits_cache and os.path.exists(self.limits_cache):
                with open(self.limits_cache) as f:
                    lim = json.load(f)
                # an absent fingerprint (a file from before it existed) is
                # accepted: rejecting it would re-derive the framing from the
                # first UNPROCESSED frame of a resumed run, the jump the cache
                # prevents
                if lim.get("fingerprint", self._fingerprint()) == self._fingerprint():
                    cached = lim
            if cached is not None:
                self.x_limits = tuple(cached["x_limits"])
                self.z_limits = tuple(cached["z_limits"])
            else:
                self._derive_limits(depth, f_px)
                if self.limits_cache:
                    tmp = self.limits_cache + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump({"x_limits": list(self.x_limits),
                                   "z_limits": list(self.z_limits),
                                   "fingerprint": self._fingerprint()}, f)
                    os.replace(tmp, self.limits_cache)
        # voxel bounds from the framing (+margin); ox = -raster-x
        (x0, x1), (z0, z1) = self.x_limits, self.z_limits
        vb = ((-x1 - 1.0, -x0 + 1.0), (-0.5, 8.0), (min(z0, 0.0) - 1.0, z1 + 1.0))
        # voxel budget: coarsen the stray grid until it fits (the block
        # half-width shrinks with coarser cells, so keep ⊇ exact holds at
        # ANY scale: stray_keep derives the reach from the scale)
        scale, radius = 0.5, 0.1
        while True:
            n_vox = 1.0
            for b0, b1 in vb:
                n_vox *= np.ceil((b1 - b0) / (radius * scale))
            if n_vox <= 48e6 or scale > 64:
                break
            scale *= 2.0
        self.cfg = DeviceFloorplanConfig(
            height=depth.shape[0], width=depth.shape[1],
            x_limits=self.x_limits, z_limits=self.z_limits,
            raster_width=self.raster_width,
            height_threshold=self.height_threshold,
            max_depth=self.max_depth, voxel_bounds=vb,
            stray_cell_scale=scale, subsample=self.subsample)
        self._fn = make_device_floorplan(self.cfg, self.ground_model, device=self.device)
        self._shape = depth.shape

    def process(self, depth, image, f_px, output_path: str) -> None:
        """Render one frame's floor-plan PNG on the device; the raster's
        fetch is the frame's one host sync."""
        depth = np.asarray(depth, np.float32)
        with self._lock:
            if self._fn is None or self._shape != depth.shape:
                self._build(depth, f_px)
            fn = self._fn
        raster = fn(depth, image, np.float32(f_px))["raster"]
        raster = (raster * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        from PIL import Image

        Image.fromarray(raster).save(output_path)
