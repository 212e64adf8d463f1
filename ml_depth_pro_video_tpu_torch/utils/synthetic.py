"""Synthetic structured scene families: data without a download.

Copy of ``ml_depth_pro_video_tpu/utils/synthetic.py`` (numpy host code: the
port imports nothing of the JAX package), with ``tome_deviation_curves`` on
the port's ``infer_fn``. Random-init features have no spatial redundancy, so
the speed tiers (ToMe token merging, ``models/vit.py``) are quality-gated
against a proxy model trained on ray-cast scenes whose RGB and depth share
the statistics the tier exploits: large smooth regions separated by sharp
depth edges. Two families:

- ``make_scene_boxes``: shaded boxes in a room, mostly smooth, redundancy-
  rich (the tier's best case);
- ``make_scene_edges``: thin slats and poles over high-frequency striped
  albedo, a depth discontinuity in most 16-px tokens (the tier's worst).

Both ray-cast a pinhole camera (the convention of ``geom/unproject.py``):
RGB = per-surface albedo x Lambert shading, depth = euclidean ray length.
``write_dataset`` writes them in the layout ``train/data.py`` reads, which
is how the training tests and ``chip_smoke.py`` get (image, depth) pairs.
"""

from __future__ import annotations

import os

import numpy as np


class _Caster:
    """Accumulates nearest-hit t/normal/albedo over registered surfaces."""

    def __init__(self, size: int, f: float):
        ys, xs = np.mgrid[0:size, 0:size]
        dx = (xs - size / 2) / f
        dy = -(ys - size / 2) / f
        self.d = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
        self.t_hit = np.full((size, size), np.inf)
        self.normal = np.zeros((size, size, 3))
        self.albedo = np.zeros((size, size, 3))

    def register(self, t, cond, n, alb):
        ok = cond & (t > 0.1) & (t < self.t_hit)
        self.t_hit = np.where(ok, t, self.t_hit)
        self.normal[ok] = n
        self.albedo[ok] = np.broadcast_to(alb, self.albedo.shape)[ok] \
            if np.ndim(alb) > 1 else alb

    def box(self, cx, cz, w, h, floor_y, alb):
        """Axis-aligned box: front face at z=cz, top at y=floor_y+h."""
        d = self.d
        top = floor_y + h
        with np.errstate(divide="ignore", invalid="ignore"):
            tz = cz / d[..., 2]
            p = d * tz[..., None]
            self.register(tz, (np.abs(p[..., 0] - cx) < w)
                          & (p[..., 1] > floor_y) & (p[..., 1] < top),
                          [0, 0, -1], alb)
            ty = top / d[..., 1]
            p = d * ty[..., None]
            self.register(ty, (d[..., 1] < 0) & (np.abs(p[..., 0] - cx) < w)
                          & (p[..., 2] > cz) & (p[..., 2] < cz + 2 * w),
                          [0, 1, 0], alb)

    def shade(self, rng, zb):
        self.t_hit = np.where(np.isfinite(self.t_hit), self.t_hit, zb)
        light = np.asarray([0.5, 0.8, -0.3])
        light = light / np.linalg.norm(light)
        lam = np.clip((self.normal * light).sum(-1), 0.15, 1.0)[..., None]
        img = np.clip(self.albedo * lam * 255 * rng.uniform(0.8, 1.2),
                      0, 255).astype(np.uint8)
        depth = (self.t_hit * np.linalg.norm(self.d, axis=-1)).astype(np.float32)
        return img, depth


def make_scene_boxes(rng: np.random.Generator, size: int = 512):
    """Room with floor + back wall + 2-4 shaded boxes (round-4 family)."""
    c = _Caster(size, size * 0.9)
    d = c.d
    floor_y = -1.0 - rng.uniform(0, 0.5)
    zb = rng.uniform(4.0, 7.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tf = floor_y / d[..., 1]
        c.register(tf, d[..., 1] < 0, [0, 1, 0], rng.uniform(0.3, 0.9, 3))
        tb = zb / d[..., 2]
        c.register(tb, np.isfinite(tb), [0, 0, -1], rng.uniform(0.3, 0.9, 3))
    for _ in range(rng.integers(2, 5)):
        c.box(rng.uniform(-1.5, 1.5), rng.uniform(1.5, zb - 0.5),
              rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), floor_y,
              rng.uniform(0.2, 1.0, 3))
    return c.shade(rng, zb)


def make_scene_edges(rng: np.random.Generator, size: int = 512):
    """Edge-heavy family: 6-12 THIN slats/poles at staggered depths over
    a striped back wall — thin-structure widths (0.02-0.10 world units ≈
    a few px) put a depth discontinuity in most 16-px tokens, and the
    high-frequency albedo kills the smooth-region redundancy the merge
    tier exploits."""
    c = _Caster(size, size * 0.9)
    d = c.d
    floor_y = -1.0 - rng.uniform(0, 0.3)
    zb = rng.uniform(3.5, 6.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        tf = floor_y / d[..., 1]
        c.register(tf, d[..., 1] < 0, [0, 1, 0], rng.uniform(0.3, 0.9, 3))
        # striped back wall: high-frequency horizontal texture
        tb = zb / d[..., 2]
        p = d * tb[..., None]
        freq = rng.uniform(6.0, 14.0)
        stripes = 0.5 + 0.45 * np.sign(np.sin(p[..., 0] * freq))
        base = rng.uniform(0.3, 0.9, 3)
        c.register(tb, np.isfinite(tb), [0, 0, -1],
                   stripes[..., None] * base)
    # thin vertical slats at staggered depths (the clutter)
    for _ in range(rng.integers(6, 13)):
        c.box(rng.uniform(-1.8, 1.8), rng.uniform(1.2, zb - 0.3),
              rng.uniform(0.02, 0.10), rng.uniform(0.8, 1.8), floor_y,
              rng.uniform(0.2, 1.0, 3))
    return c.shade(rng, zb)


FAMILIES = {"boxes": make_scene_boxes, "edges": make_scene_edges}


def tome_deviation_curves(params, proxy_cfg, ratios=(0.25, 0.5), n_eval=4, seed=123):
    """Per-family inverse-depth deviation of the merge tier against the exact
    path on FRESH scenes (``seed`` must stay disjoint from the training
    dataset's seed 0), bf16 on the device the params live on. ``proxy_cfg``
    is the proxy's architecture (``chip_smoke.py::tome_proxy_config``, the
    twin of the JAX package's ``tome_proxy_config``). Returns
    {"family/ratio": {mean, p95, max}}."""
    import dataclasses

    import torch

    from ..core.precision import Precision
    from ..ckpt.params import map_tree
    from ..models.depth_pro import infer_fn

    leaves = []
    map_tree(leaves.append, params)
    device = leaves[0].device
    f_px = torch.full((n_eval,), float(proxy_cfg.img_size), dtype=torch.float32, device=device)

    def depth(ratio, x):
        cfg = dataclasses.replace(proxy_cfg, token_merge_ratio=ratio)
        with torch.inference_mode():
            out = infer_fn(params, x, f_px, cfg, Precision.bf16())["depth"]
        return out.float().cpu().numpy()

    out = {}
    for family, make in FAMILIES.items():
        rng = np.random.default_rng(seed)
        imgs = np.stack([make(rng, proxy_cfg.img_size)[0] for _ in range(n_eval)])
        x = torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1.0).to(device)
        base = 1.0 / np.maximum(depth(0.0, x), 1e-6)
        for ratio in ratios:
            inv = 1.0 / np.maximum(depth(ratio, x), 1e-6)
            rel = np.abs(inv - base) / (np.abs(base) + 1e-9)
            out[f"{family}/{ratio}"] = {
                "mean": float(rel.mean()),
                "p95": float(np.percentile(rel, 95)),
                "max": float(rel.max()),
            }
    return out


def write_dataset(root: str, n: int, seed: int = 0, size: int = 512,
                  families=("boxes",)) -> None:
    """Write n (image, depth) pairs cycling over ``families`` in the
    layout `train/data.py` expects (scene_XXXX.png + _depth.npy)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, depth = FAMILIES[families[i % len(families)]](rng, size)
        Image.fromarray(img).save(os.path.join(root, f"scene_{i:04d}.png"))
        np.save(os.path.join(root, f"scene_{i:04d}_depth.npy"), depth)
