"""Depth Pro model in PyTorch (twin of ``ml_depth_pro_video_tpu/models/depth_pro.py``).

Functions on param trees (``encoder_apply``, ``decoder_apply``,
``head_apply``, ``fov_apply``, ``forward``, ``infer_fn``) mirror the JAX
package one for one, on NHWC tensors: the 3-level pyramid split into 35
patches of 384^2 that go through ONE patch-ViT call, an image ViT, the DPT
decoder with the out-conv folded into the deconv, the depth head with its
deconv+conv fold, and the FOV head (a third ViT). ``infer_fn`` keeps the
reference ``infer()`` contract: resize to the network resolution, f_px
derived as ``0.5*W/tan(0.5*fov)`` from the ORIGINAL width, inverse-depth
scaling, resize back and ``1/clamp(inverse_depth, 1e-4, 1e4)``.

``DepthProModel`` holds a param tree as ``nn.Module``s (three ``ViT``s and
the encoder, decoder, head and FOV weights); ``DepthPro`` and
``create_model_and_transforms`` are the public API, with an explicit device.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ckpt.convert import convert_depth_pro
from ..ckpt.params import ParamTree, from_numpy_tree, init_depth_pro, load_params
from ..core.precision import Precision, disable_tf32, resolve_device, resolve_precision
from ..ops.conv import conv2d, conv_transpose2x2, depth_to_space2x2, fold_deconv2x2_conv3x3, linear
from ..ops.resblock import residual_block
from ..ops.resize import resize2d
from .vit import VIT_CONFIG_DICT, ViT, ViTConfig, vit_apply

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    """Model architecture configuration (mirrors the JAX package's)."""

    vit: ViTConfig = ViTConfig()
    decoder_features: int = 256
    dims_encoder: tuple = (256, 512, 1024, 1024)
    hook_block_ids: tuple = (5, 11)
    use_fov_head: bool = True
    checkpoint_uri: Optional[str] = "./checkpoints/depth_pro_tpu.npz"
    token_merge_ratio: float = 0.0
    token_merge_block: int = 2

    @property
    def img_size(self) -> int:
        """Full network resolution = 4x the backbone resolution."""
        return self.vit.img_size * 4

    @property
    def out_size(self) -> int:
        return self.vit.grid_size


DEFAULT_MONODEPTH_CONFIG = DepthProConfig()
MODEL_PRESETS = ("large", "base", "small", "tiny")

# --speed presets (runner, CLI): the non-exact tiers trade a bounded output
# deviation for throughput through ToMe token merging with proportional
# attention in the 35-patch ViT (models/vit.py; kernel K3 on CUDA)
SPEED_PRESETS = {"exact": 0.0, "balanced": 0.25, "fast": 0.5}


def apply_speed(cfg: DepthProConfig, speed: str) -> DepthProConfig:
    """Return ``cfg`` with the named speed preset's merge ratio set."""
    if speed not in SPEED_PRESETS:
        raise ValueError(f"speed must be one of {sorted(SPEED_PRESETS)}, got {speed!r}")
    if SPEED_PRESETS[speed] > 0:
        LOGGER.warning(
            "--speed %s is an APPROXIMATE tier (token merge ratio %.2f): "
            "deviation bounds in docs/PERFORMANCE.md are from a "
            "structured-feature proxy model; sign-off vs the real "
            "checkpoint pending (use --speed exact for reference parity)",
            speed, SPEED_PRESETS[speed])
    return dataclasses.replace(cfg, token_merge_ratio=SPEED_PRESETS[speed])


def tiny_config(use_fov_head: bool = True) -> DepthProConfig:
    """Miniature config for CPU tests: same topology, 512px, 2-block ViT."""
    return DepthProConfig(
        vit=ViTConfig(img_size=128, patch_size=16, embed_dim=64, depth=2, num_heads=2,
                      mlp_ratio=2),
        decoder_features=16,
        dims_encoder=(16, 32, 64, 64),
        hook_block_ids=(0, 1),
        use_fov_head=use_fov_head,
        checkpoint_uri=None,
    )


def model_preset(name: str = "large") -> DepthProConfig:
    """The Depth Pro family: ``large`` is the reference ViT-L architecture;
    ``base``/``small`` keep the topology at DINOv2 B/S widths; ``tiny`` is
    the test config."""
    presets = {
        "large": ("dinov2l16_384", None),
        "base": ("dinov2b16_384", "./checkpoints/depth_pro_tpu_base.npz"),
        "small": ("dinov2s16_384", "./checkpoints/depth_pro_tpu_small.npz"),
    }
    if name == "tiny":
        return tiny_config()
    if name not in presets:
        raise ValueError(f"model must be one of {sorted(presets) + ['tiny']}, got {name!r}")
    if name == "large":
        return DEFAULT_MONODEPTH_CONFIG
    vit_name, ckpt = presets[name]
    vit = VIT_CONFIG_DICT[vit_name]
    d = vit.embed_dim
    return DepthProConfig(vit=vit, decoder_features=d // 4, dims_encoder=(d // 4, d // 2, d, d),
                          hook_block_ids=(vit.depth // 4 - 1, vit.depth // 2 - 1),
                          checkpoint_uri=ckpt)


# ---------------------------------------------------------------------------
# pyramid split / merge


def split_patches(x: torch.Tensor, patch: int, overlap: float) -> torch.Tensor:
    """Sliding-window split of (B, S, S, C) into (n*n*B, patch, patch, C),
    patch-major (row-major grid)."""
    size = x.shape[1]
    stride = int(patch * (1 - overlap))
    steps = (size - patch + stride - 1) // stride + 1
    tiles = [x[:, j * stride:j * stride + patch, i * stride:i * stride + patch, :]
             for j in range(steps) for i in range(steps)]
    return torch.cat(tiles, dim=0)


def merge_patches(x: torch.Tensor, batch: int, padding: int) -> torch.Tensor:
    """Inverse of split at feature resolution: trim ``padding`` from
    interior edges and stitch."""
    steps = int(round((x.shape[0] // batch) ** 0.5))
    g = x.shape[1]
    x = x.reshape(steps, steps, batch, g, g, -1)
    rows = []
    for j in range(steps):
        cols = []
        for i in range(steps):
            t = x[j, i]
            t = t[:, (padding if j > 0 else 0):g - (padding if j < steps - 1 else 0),
                  (padding if i > 0 else 0):g - (padding if i < steps - 1 else 0), :]
            cols.append(t)
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def tokens_to_grid(tokens: torch.Tensor, grid: int) -> torch.Tensor:
    """Drop the cls token, (B, 1+G*G, D) -> (B, G, G, D)."""
    return tokens[:, 1:, :].reshape(tokens.shape[0], grid, grid, -1)


# ---------------------------------------------------------------------------
# encoder / decoder / heads


def _apply_upsample_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = conv2d(x, p["proj_w"])
    for w in p["deconvs"]:
        x = conv_transpose2x2(x, w)
    return x


def encoder_apply(params: dict, x: torch.Tensor, cfg: DepthProConfig,
                  precision: Precision) -> list[torch.Tensor]:
    """Multi-resolution encoding. x: (B, 4p, 4p, 3)."""
    vit_cfg = cfg.vit
    b = x.shape[0]
    p = vit_cfg.img_size
    g = vit_cfg.grid_size
    pad0, pad1 = g // 8, g // 4

    x = x.to(precision.compute_dtype)
    x1 = resize2d(x, (2 * p, 2 * p))
    x2 = resize2d(x, (p, p))
    pyramid = torch.cat([split_patches(x, p, overlap=0.25),    # 25B
                         split_patches(x1, p, overlap=0.5),    # 9B
                         x2], dim=0)                            # 35B

    # only the 35-patch ViT merges tokens; the image and FOV ViTs stay exact
    tokens, (h0, h1) = vit_apply(params["patch_vit"], pyramid, vit_cfg, precision,
                                 capture_blocks=cfg.hook_block_ids,
                                 merge_ratio=cfg.token_merge_ratio,
                                 merge_block=cfg.token_merge_block)
    n0, n1 = 25 * b, 9 * b
    latent0 = merge_patches(tokens_to_grid(h0[:n0], g), b, pad0)
    latent1 = merge_patches(tokens_to_grid(h1[:n0], g), b, pad0)
    feat = tokens_to_grid(tokens, g)
    x0_feat = merge_patches(feat[:n0], b, pad0)
    x1_feat = merge_patches(feat[n0:n0 + n1], b, pad1)
    x2_feat = feat[n0 + n1:]

    image_tokens, _ = vit_apply(params["image_vit"], x2, vit_cfg, precision)
    global_feat = tokens_to_grid(image_tokens, g)

    latent0 = _apply_upsample_block(params["upsample_latent0"], latent0)
    latent1 = _apply_upsample_block(params["upsample_latent1"], latent1)
    x0_feat = _apply_upsample_block(params["upsample0"], x0_feat)
    x1_feat = _apply_upsample_block(params["upsample1"], x1_feat)
    x2_feat = _apply_upsample_block(params["upsample2"], x2_feat)

    global_feat = conv_transpose2x2(global_feat, params["upsample_lowres"]["w"],
                                    params["upsample_lowres"]["b"])
    fused = conv2d(torch.cat([x2_feat, global_feat], dim=-1),
                   params["fuse_lowres"]["w"], params["fuse_lowres"]["b"])
    return [latent0, latent1, x0_feat, x1_feat, fused]


def _residual(p: dict, x: torch.Tensor) -> torch.Tensor:
    return residual_block(x, p["w1"], p["b1"], p["w2"], p["b2"])


def _fusion_apply(p: dict, x0: torch.Tensor, x1: torch.Tensor | None) -> torch.Tensor:
    """FeatureFusionBlock2d; with the 2x upsample present, the trailing 1x1
    out-conv is folded into the deconv matmul."""
    x = x0
    if x1 is not None:
        x = x + _residual(p["res1"], x1)
    x = _residual(p["res2"], x)
    if p["deconv_w"] is not None:
        wd = p["deconv_w"]                # (C, 4*M) packed (a, b, m)
        wo = p["out"]["w"][0, 0]          # (M, O)
        c, m = wd.shape[0], wd.shape[1] // 4
        w_fold = (wd.reshape(c, 4, m) @ wo).reshape(c, -1)
        return conv_transpose2x2(x, w_fold, p["out"]["b"])
    return conv2d(x, p["out"]["w"], p["out"]["b"])


def decoder_apply(params: dict, encodings: list[torch.Tensor]):
    """Fuse low -> high resolution. Returns (features, lowres_features);
    the latter feeds the FOV head."""
    proj = [e if w is None else conv2d(e, w, padding=1)
            for e, w in zip(encodings, params["convs"])]
    fusions = params["fusions"]
    features = proj[-1]
    lowres = features
    features = _fusion_apply(fusions[-1], features, None)
    for i in range(len(proj) - 2, -1, -1):
        features = _fusion_apply(fusions[i], features, proj[i])
    return features, lowres


def head_apply(params: dict, x: torch.Tensor,
               precision: Precision = Precision.fp32()) -> torch.Tensor:
    """Depth head. The deconv and the following 3x3 conv are folded into
    one 3x3 conv at half resolution over subpixel-packed channels; convs run
    in the compute dtype; the final 1x1 conv is fp32."""
    x = x.to(precision.compute_dtype)
    x = conv2d(x, params["conv_in"]["w"], params["conv_in"]["b"], padding=1)
    wcomp = params.get("folded_wcomp")
    if wcomp is None:
        wcomp = fold_deconv2x2_conv3x3(params["deconv"]["w"], params["deconv"]["b"],
                                       params["conv_mid"]["w"])
    cin = x.shape[-1]
    h = conv2d(x, wcomp[:, :, :cin], padding=1)
    ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype, device=x.device)
    h = h + conv2d(ones, wcomp[:, :, cin:], padding=1)
    n = params["conv_mid"]["b"].shape[0]
    h = h + params["conv_mid"]["b"].repeat(4).to(h.dtype)
    h = F.relu(h).float()

    # the 1x1 output conv per packed subpixel group as ONE block-diagonal matmul
    wo = params["conv_out"]["w"].reshape(n, -1).float()
    n_out = wo.shape[-1]
    eye4 = torch.eye(4, dtype=wo.dtype, device=wo.device)
    wbig = torch.einsum("gh,no->gnho", eye4, wo).reshape(4 * n, 4 * n_out)
    y = h @ wbig + params["conv_out"]["b"].float().repeat(4)
    return F.relu(depth_to_space2x2(y))


def fold_head_params(params: dict) -> dict:
    """Copy of the tree with the head's deconv+conv_mid fold precomputed."""
    head = dict(params["head"])
    head["folded_wcomp"] = fold_deconv2x2_conv3x3(head["deconv"]["w"], head["deconv"]["b"],
                                                  head["conv_mid"]["w"])
    return {**params, "head": head}


def fov_apply(params: dict, x: torch.Tensor, lowres: torch.Tensor, cfg: DepthProConfig,
              precision: Precision) -> torch.Tensor:
    """FOV estimation: quarter-res image through a third ViT, projected
    tokens summed with downsampled decoder features, then a strided conv
    stack to one value in degrees per image. Computes in fp32 after the ViT."""
    vit_cfg = cfg.vit
    p, g = vit_cfg.img_size, vit_cfg.grid_size
    x = resize2d(x.to(precision.compute_dtype), (p, p))
    tokens, _ = vit_apply(params["vit"], x, vit_cfg, precision)
    t = linear(tokens.float(), params["proj"]["w"], params["proj"]["b"])
    t = t[:, 1:, :].reshape(t.shape[0], g, g, -1)

    lo = lowres.detach().float()
    lo = F.relu(conv2d(lo, params["down"]["w"], params["down"]["b"], stride=2, padding=1))
    h = t + lo
    head = params["head"]
    h = F.relu(conv2d(h, head[0]["w"], head[0]["b"], stride=2, padding=1))
    h = F.relu(conv2d(h, head[1]["w"], head[1]["b"], stride=2, padding=1))
    h = conv2d(h, head[2]["w"], head[2]["b"])  # valid conv over the remaining grid
    return h.reshape(h.shape[0])


def forward(params: dict, x: torch.Tensor, cfg: DepthProConfig,
            precision: Precision = Precision.fp32(), compute_fov: bool = True):
    """(B, img, img, 3) -> (canonical inverse depth (B, img, img, 1),
    fov_deg (B,) or None). ``compute_fov=False`` skips the third ViT."""
    if x.shape[1] != cfg.img_size or x.shape[2] != cfg.img_size:
        raise ValueError(f"forward expects {cfg.img_size}x{cfg.img_size} input, got "
                         f"{tuple(x.shape)}; use infer_fn() for arbitrary sizes")
    encodings = encoder_apply(params["encoder"], x, cfg, precision)
    features, lowres = decoder_apply(params["decoder"], encodings)
    canonical = head_apply(params["head"], features, precision)
    fov_deg = None
    if cfg.use_fov_head and compute_fov:
        fov_deg = fov_apply(params["fov"], x, lowres, cfg, precision)
    return canonical, fov_deg


def infer_fn(params: dict, x: torch.Tensor, f_px: torch.Tensor | None, cfg: DepthProConfig,
             precision: Precision = Precision.fp32(), interpolation_mode: str = "bilinear",
             derive_missing: bool = False) -> dict:
    """The ``infer()`` contract, NHWC. x: (B, H, W, 3) normalized; f_px:
    (B,) or None. With ``derive_missing=True`` NaN entries of ``f_px`` are
    replaced by the FOV-derived focal length and the others kept.
    Returns {"depth": (B, H, W) fp32 metres, "focallength_px": (B,)}."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    s = cfg.img_size
    needs_resize = (h, w) != (s, s)
    xi = resize2d(x, (s, s), mode=interpolation_mode) if needs_resize else x

    need_fov = f_px is None or derive_missing
    if need_fov and not cfg.use_fov_head:
        raise ValueError("f_px is required for every frame when the model has no FOV head "
                         "(cfg.use_fov_head=False): there is nothing to derive it from")
    canonical, fov_deg = forward(params, xi, cfg, precision, compute_fov=need_fov)
    canonical = canonical[..., 0].float()

    if need_fov:
        derived = 0.5 * w / torch.tan(0.5 * torch.deg2rad(fov_deg.float()))
        if f_px is None:
            f_px = derived
        else:
            given = torch.as_tensor(f_px, dtype=torch.float32, device=x.device).reshape(b)
            f_px = torch.where(torch.isnan(given), derived, given)
    else:
        f_px = torch.as_tensor(f_px, dtype=torch.float32, device=x.device).reshape(b)

    inverse_depth = canonical * (w / f_px)[:, None, None]
    if needs_resize:
        inverse_depth = resize2d(inverse_depth[..., None], (h, w), mode=interpolation_mode)[..., 0]
    depth = 1.0 / torch.clamp(inverse_depth, 1e-4, 1e4)
    return {"depth": depth, "focallength_px": f_px}


# ---------------------------------------------------------------------------
# modules and public API


class DepthProModel(nn.Module):
    """A Depth Pro param tree as modules: the three ViTs (patch, image, FOV)
    and the remaining encoder, decoder, head and FOV weights. The head's
    deconv+conv fold is precomputed. ``tree()`` gives the JAX-layout param
    tree back (sharing storage)."""

    def __init__(self, params: dict, cfg: DepthProConfig):
        super().__init__()
        self.cfg = cfg
        if "folded_wcomp" not in params["head"]:
            params = fold_head_params(params)
        enc = dict(params["encoder"])
        self.patch_vit = ViT(enc.pop("patch_vit"), cfg.vit)
        self.image_vit = ViT(enc.pop("image_vit"), cfg.vit)
        self.encoder = ParamTree(enc)
        self.decoder = ParamTree(params["decoder"])
        self.head = ParamTree(params["head"])
        self.fov_vit = self.fov = None
        if "fov" in params:
            fov = dict(params["fov"])
            self.fov_vit = ViT(fov.pop("vit"), cfg.vit)
            self.fov = ParamTree(fov)

    def tree(self) -> dict:
        out = {
            "encoder": {**self.encoder.tree(), "patch_vit": self.patch_vit.tree(),
                        "image_vit": self.image_vit.tree()},
            "decoder": self.decoder.tree(),
            "head": self.head.tree(),
        }
        if self.fov is not None:
            out["fov"] = {**self.fov.tree(), "vit": self.fov_vit.tree()}
        return out

    def forward(self, x: torch.Tensor, precision: Precision = Precision.fp32(),
                compute_fov: bool = True):
        return forward(self.tree(), x, self.cfg, precision, compute_fov)


def load_checkpoint(cfg: DepthProConfig, device="cpu") -> dict | None:
    """Params for ``cfg.checkpoint_uri`` on ``device``, or None when there is
    no such file. Takes a converted flat npz (``ckpt/convert.py::save_params``)
    or a reference ``.pt`` / ``.pth`` state dict, converted on the fly."""
    uri = cfg.checkpoint_uri
    if uri is None or not os.path.exists(uri):
        return None
    if uri.endswith((".pt", ".pth")):
        sd = torch.load(uri, map_location="cpu", weights_only=True)
        return from_numpy_tree(convert_depth_pro(sd, cfg), device)
    return from_numpy_tree(load_params(uri), device)


def build_params(cfg: DepthProConfig, device, rng_seed: int = 0) -> dict:
    """The checkpoint's params when it exists, else random ones from
    ``rng_seed``, built on ``device``."""
    params = load_checkpoint(cfg, device)
    if params is None:
        if cfg.checkpoint_uri is not None:
            LOGGER.warning("checkpoint %s not found; running with RANDOM weights "
                           "(depth output will be garbage)", cfg.checkpoint_uri)
        params = init_depth_pro(cfg, torch.Generator(device).manual_seed(rng_seed), device)
    return params


class DepthPro:
    """Resident Depth Pro model on one device."""

    def __init__(self, params: dict, cfg: DepthProConfig, precision="fp32", device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.cfg = cfg
        self.precision = resolve_precision(precision)
        self.model = DepthProModel(params, cfg).to(self.device).eval()
        self.params = self.model.tree()

    @property
    def img_size(self) -> int:
        return self.cfg.img_size

    @torch.inference_mode()
    def forward(self, x: torch.Tensor):
        """(B, img, img, 3) -> (canonical inverse depth, fov_deg)."""
        return forward(self.params, x.to(self.device), self.cfg, self.precision)

    @torch.inference_mode()
    def infer(self, x, f_px=None, interpolation_mode: str = "bilinear") -> dict:
        """Depth of (H, W, 3) or (B, H, W, 3) normalized input (torch-style
        (3, H, W) / (B, 3, H, W) also accepted). Returns {"depth",
        "focallength_px"}, without the batch dim when the input had none."""
        x = torch.as_tensor(x).to(self.device)
        if x.shape[-1] != 3 and x.shape[-3] == 3:
            x = x.movedim(-3, -1)
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        if f_px is not None:
            f_px = torch.as_tensor(f_px, dtype=torch.float32, device=self.device)
            f_px = torch.atleast_1d(f_px).expand(x.shape[0])
        out = infer_fn(self.params, x, f_px, self.cfg, self.precision, interpolation_mode)
        if squeeze:
            out = {"depth": out["depth"][0], "focallength_px": out["focallength_px"][0]}
        return out


def create_model_and_transforms(config: DepthProConfig = DEFAULT_MONODEPTH_CONFIG,
                                device="cuda", precision="fp32", rng_seed: int = 0):
    """A ``DepthPro`` model and its input transform (uint8 HWC -> [-1, 1]
    in the compute dtype, on the model's device). Loads
    ``config.checkpoint_uri`` when present, else random weights."""
    dev = resolve_device(device)
    model = DepthPro(build_params(config, dev, rng_seed), config, precision, dev)

    def transform(img) -> torch.Tensor:
        arr = np.asarray(img)
        x = torch.as_tensor(arr.astype(np.float32)).to(dev)
        if arr.dtype == np.uint8:
            x = x / 255.0
        return ((x - 0.5) / 0.5).to(model.precision.compute_dtype)

    return model, transform
