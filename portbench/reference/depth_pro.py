"""Plain PyTorch Depth Pro: the yardstick that decides a run's ``correct``.

A frozen copy of the model's plain math (Apple's Depth Pro, arXiv:2410.02073,
``apple/ml-depth-pro`` ``src/depth_pro``), written against the parameter tree
that ``portbench/weights.py`` makes: three DINOv2-style ViTs (patch, image,
FOV), the 3-level pyramid split into 35 patches of 384^2 per frame, the DPT
decoder, the depth head and the FOV head, and ``infer()``'s contract (resize
to the network size, f_px from the FOV, inverse depth scaled by w / f_px and
resized back, ``1 / clamp``). The speed tiers' token merge (ToMe,
arXiv:2210.09461) with proportional attention is here too.

It follows the precision policy of the configuration it is given: matmuls and
convolutions in ``dtype`` (bf16 for the benchmark's configurations) with fp32
accumulation, LayerNorm statistics, resizes, the head's last 1x1 conv and the
FOV head after its ViT in fp32, attention scores and softmax in fp32. There
is no kernel, cache or batching trick: attention is ``softmax(q k^T) v`` and
every convolution is ``F.conv2d``. It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Arch:
    """The shapes of one Depth Pro configuration."""

    img_size: int = 384          # the ViTs' input; the network runs at 4x this
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    decoder_features: int = 256
    dims_encoder: tuple = (256, 512, 1024, 1024)
    hook_block_ids: tuple = (5, 11)
    token_merge_ratio: float = 0.0
    token_merge_block: int = 2
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1

    @property
    def net_size(self) -> int:
        return 4 * self.img_size


def arch_of(config: dict) -> Arch:
    """The ``Arch`` of a configuration file's ``model`` group."""
    m = config["model"]
    return Arch(img_size=m["vit_img_size"], patch_size=m["patch_size"], embed_dim=m["embed_dim"],
                depth=m["depth"], num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                decoder_features=m["decoder_features"], dims_encoder=tuple(m["dims_encoder"]),
                hook_block_ids=tuple(m["hook_block_ids"]),
                token_merge_ratio=m["token_merge_ratio"],
                token_merge_block=m["token_merge_block"])


# ---------------------------------------------------------------------------
# resize: torch's F.interpolate(align_corners=False) taps, weights in fp64


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    scale = in_size / out_size
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(center).astype(np.int64)
    taps = lo[:, None] + np.arange(2)[None, :]
    w = np.maximum(0.0, 1.0 - np.abs(taps - center[:, None]))
    w = w / w.sum(axis=1, keepdims=True)
    return np.clip(taps, 0, in_size - 1), w.astype(np.float32)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    idx, w = _taps(x.shape[axis], out_size)
    g = x.index_select(axis, torch.as_tensor(idx, device=x.device).flatten())
    g = g.unflatten(axis, idx.shape)
    wt = torch.as_tensor(w, device=x.device).reshape(idx.shape + (1,) * (x.dim() - axis - 1))
    return (g * wt).sum(axis + 1)


def resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) in fp32, returned in x's dtype."""
    h_axis, w_axis = x.dim() - 3, x.dim() - 2
    y = x.float()
    if hw[0] != y.shape[h_axis]:
        y = _resize_axis(y, h_axis, hw[0])
    if hw[1] != y.shape[w_axis]:
        y = _resize_axis(y, w_axis, hw[1])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# layers (NHWC activations, HWIO conv weights, (in, out) matmul weights)


def conv(x, w, b=None, stride=1, padding=0):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 None if b is None else b.to(x.dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def depth_to_space(x):
    b, h, w, c4 = x.shape
    y = x.reshape(b, h, w, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, c4 // 4)


def deconv(x, w, b=None):
    """2x2 stride-2 transposed conv; w (Cin, 4*Cout) packed (kh, kw, cout)."""
    y = depth_to_space(x @ w.to(x.dtype))
    return y if b is None else y + b.to(y.dtype)


def dense(x, w, b):
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def layer_norm(x, g, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps).to(x.dtype)


def attention(qkv, heads, key_bias=None):
    """Packed head-contiguous qkv (B, S, 3D) -> (B, S, D). Scores in fp32;
    softmax as exp(s - max) in v's dtype times v, summed in fp32 and divided
    by the sum of the exponentials, then rounded to v's dtype once."""
    b, s, d3 = qkv.shape
    hd = d3 // (3 * heads)
    q, k, v = qkv.reshape(b, s, heads, 3, hd).permute(3, 0, 2, 1, 4)
    scores = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :].float()
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = (e.to(v.dtype).float() @ v.float()) / e.sum(dim=-1, keepdim=True)
    return out.to(v.dtype).transpose(1, 2).reshape(b, s, d3 // 3)


def block(x, p, i, arch: Arch, key_bias=None):
    cdt = x.dtype
    h = layer_norm(x, p["ln1_g"][i], p["ln1_b"][i], arch.layer_norm_eps)
    a = attention(dense(h, p["qkv_w"][i], p["qkv_b"][i]), arch.num_heads, key_bias)
    x = torch.addcmul(x, p["ls1"][i].to(cdt), dense(a, p["proj_w"][i], p["proj_b"][i]))
    h = layer_norm(x, p["ln2_g"][i], p["ln2_b"][i], arch.layer_norm_eps)
    h = F.gelu(dense(h, p["fc1_w"][i], p["fc1_b"][i]))
    return torch.addcmul(x, p["ls2"][i].to(cdt), dense(h, p["fc2_w"][i], p["fc2_b"][i]))


def token_merge(tokens, ratio):
    """ToMe bipartite soft matching over the patch tokens (the cls token is
    never merged): alternate tokens into A and B, merge the r most similar A
    tokens into their best B match by averaging. Returns (merged tokens,
    gather map back to full length, log token sizes) or None if r < 1."""
    b, s, d = tokens.shape
    n = s - 1
    na, nb = (n + 1) // 2, n // 2
    r = min(int(ratio * n), na)
    if r < 1 or nb < 1:
        return None
    xs = tokens[:, 1:]
    a, bb = xs[:, 0::2], xs[:, 1::2]
    an = a / (torch.linalg.vector_norm(a.float(), dim=-1, keepdim=True) + 1e-6)
    bn = bb / (torch.linalg.vector_norm(bb.float(), dim=-1, keepdim=True) + 1e-6)
    sim = an @ bn.transpose(1, 2)
    best_val, best_idx = sim.amax(dim=-1), sim.argmax(dim=-1)
    order = torch.argsort(-best_val, dim=-1, stable=True)
    merged_rank, kept_rank = order[:, :r], order[:, r:]
    dst = torch.gather(best_idx, 1, merged_rank)
    a_sel = torch.gather(a, 1, merged_rank[..., None].expand(-1, -1, d))
    sum_b = bb.float().scatter_add(1, dst[..., None].expand(-1, -1, d), a_sel.float())
    cnt = torch.ones((b, nb), device=tokens.device).scatter_add(
        1, dst, torch.ones_like(dst, dtype=torch.float32))
    b_merged = (sum_b / cnt[..., None]).to(tokens.dtype)
    a_kept = torch.gather(a, 1, kept_rank[..., None].expand(-1, -1, d))
    merged = torch.cat([tokens[:, :1], a_kept, b_merged], dim=1)
    dev = tokens.device
    a_pos = 1 + 2 * torch.arange(na, device=dev)
    b_pos = 2 + 2 * torch.arange(nb, device=dev)
    gmap = torch.zeros((b, s), dtype=torch.int64, device=dev)
    gmap.scatter_(1, a_pos[kept_rank], (1 + torch.arange(na - r, device=dev)).expand(b, -1))
    gmap.scatter_(1, a_pos[merged_rank], 1 + (na - r) + dst)
    gmap[:, b_pos] = 1 + (na - r) + torch.arange(nb, device=dev)
    log_sizes = torch.cat([torch.zeros((b, 1 + na - r), device=dev), torch.log(cnt)], dim=1)
    return merged, gmap, log_sizes


def unmerge(tokens, gmap):
    return torch.gather(tokens, 1, gmap[..., None].expand(-1, -1, tokens.shape[-1]))


def vit(p, x, arch: Arch, captures=(), merge=False):
    """(B, 384, 384, 3) -> (final normed tokens, [tokens after each captured
    block]); with ``merge`` the tokens merge once after block
    ``token_merge_block`` and later blocks take the log sizes as key bias."""
    cdt = x.dtype
    b, s = x.shape[0], arch.patch_size
    g = arch.grid
    patches = x.reshape(b, g, s, g, s, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, s * s * 3)
    t = dense(patches, p["patch_embed"]["w"], p["patch_embed"]["b"])
    t = torch.cat([p["cls_token"].to(cdt).expand(b, 1, -1), t], dim=1) + p["pos_embed"].to(cdt)
    blocks = p["blocks"]
    gmap = bias = None
    out = []
    for i in range(arch.depth):
        if merge and arch.token_merge_ratio > 0 and i == arch.token_merge_block:
            m = token_merge(t, arch.token_merge_ratio)
            if m is not None:
                t, gmap, bias = m
        t = block(t, blocks, i, arch, bias)
        if i in captures:
            out.append(t if gmap is None else unmerge(t, gmap))
    t = layer_norm(t, p["norm"]["g"], p["norm"]["b"], arch.layer_norm_eps)
    return (t if gmap is None else unmerge(t, gmap)), out


def split(x, patch, overlap):
    size = x.shape[1]
    stride = int(patch * (1 - overlap))
    steps = (size - patch + stride - 1) // stride + 1
    return torch.cat([x[:, j * stride:j * stride + patch, i * stride:i * stride + patch]
                      for j in range(steps) for i in range(steps)], dim=0)


def stitch(x, batch, pad):
    steps = int(round((x.shape[0] // batch) ** 0.5))
    g = x.shape[1]
    x = x.reshape(steps, steps, batch, g, g, -1)
    rows = []
    for j in range(steps):
        cols = [x[j, i][:, (pad if j else 0):g - (pad if j < steps - 1 else 0),
                        (pad if i else 0):g - (pad if i < steps - 1 else 0)]
                for i in range(steps)]
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def grid_of(tokens, g):
    return tokens[:, 1:].reshape(tokens.shape[0], g, g, -1)


def upsample(p, x):
    x = conv(x, p["proj_w"])
    for w in p["deconvs"]:
        x = deconv(x, w)
    return x


def encoder(p, x, arch: Arch, dtype):
    b, s, g = x.shape[0], arch.img_size, arch.grid
    x = x.to(dtype)
    pyramid = torch.cat([split(x, s, 0.25), split(resize(x, (2 * s, 2 * s)), s, 0.5),
                         resize(x, (s, s))], dim=0)
    tokens, (h0, h1) = vit(p["patch_vit"], pyramid, arch, arch.hook_block_ids, merge=True)
    n0, n1 = 25 * b, 9 * b
    lat0 = stitch(grid_of(h0[:n0], g), b, g // 8)
    lat1 = stitch(grid_of(h1[:n0], g), b, g // 8)
    feat = grid_of(tokens, g)
    x0 = stitch(feat[:n0], b, g // 8)
    x1 = stitch(feat[n0:n0 + n1], b, g // 4)
    x2 = feat[n0 + n1:]
    glob = grid_of(vit(p["image_vit"], resize(x, (s, s)), arch)[0], g)
    glob = deconv(glob, p["upsample_lowres"]["w"], p["upsample_lowres"]["b"])
    x2 = upsample(p["upsample2"], x2)
    fused = conv(torch.cat([x2, glob], dim=-1), p["fuse_lowres"]["w"], p["fuse_lowres"]["b"])
    return [upsample(p["upsample_latent0"], lat0), upsample(p["upsample_latent1"], lat1),
            upsample(p["upsample0"], x0), upsample(p["upsample1"], x1), fused]


def residual(p, x):
    h = conv(F.relu(x), p["w1"], p["b1"], padding=1)
    return x + conv(F.relu(h), p["w2"], p["b2"], padding=1)


def fusion(p, x0, x1):
    x = x0 if x1 is None else x0 + residual(p["res1"], x1)
    x = residual(p["res2"], x)
    if p["deconv_w"] is None:
        return conv(x, p["out"]["w"], p["out"]["b"])
    c = p["deconv_w"].shape[0]
    m = p["deconv_w"].shape[1] // 4
    w_fold = (p["deconv_w"].reshape(c, 4, m) @ p["out"]["w"][0, 0]).reshape(c, -1)
    return deconv(x, w_fold, p["out"]["b"])


def decoder(p, enc):
    proj = [e if w is None else conv(e, w, padding=1) for e, w in zip(enc, p["convs"])]
    fusions = p["fusions"]
    feats = lowres = proj[-1]
    feats = fusion(fusions[-1], feats, None)
    for i in range(len(proj) - 2, -1, -1):
        feats = fusion(fusions[i], feats, proj[i])
    return feats, lowres


def head(p, x, dtype):
    """conv 3x3 -> deconv 2x2 -> conv 3x3 -> ReLU -> conv 1x1 (fp32) -> ReLU.
    The deconv and the second conv run as one 3x3 conv over subpixel-packed
    channels at half resolution (the same products, exact at the borders)."""
    x = conv(x.to(dtype), p["conv_in"]["w"], p["conv_in"]["b"], padding=1)
    wd, bd, wc = p["deconv"]["w"], p["deconv"]["b"], p["conv_mid"]["w"]
    cin, m, n = wd.shape[0], wd.shape[1] // 4, wc.shape[-1]
    wd4 = torch.cat([wd.reshape(cin, 2, 2, m), bd.reshape(1, 1, 1, m).expand(1, 2, 2, m)], 0)
    tap = torch.zeros((3, 2, 2, 3), dtype=wc.dtype, device=wc.device)
    for s in range(3):
        for a in range(2):
            for ap in range(2):
                dy = 2 * (s - 1) + ap - a
                if abs(dy) <= 1:
                    tap[s, a, ap, dy + 1] = 1.0
    wcomp = torch.einsum("cpqm,yxmn,sapy,tbqx->stcabn", wd4, wc, tap, tap).reshape(
        3, 3, cin + 1, 4 * n)
    h = conv(x, wcomp[:, :, :cin], padding=1)
    ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype, device=x.device)
    h = h + conv(ones, wcomp[:, :, cin:], padding=1)
    h = F.relu(h + p["conv_mid"]["b"].repeat(4).to(h.dtype)).float()
    y = conv(depth_to_space(h), p["conv_out"]["w"].float(), p["conv_out"]["b"].float())
    return F.relu(y)


def fov(p, x, lowres, arch: Arch, dtype):
    s, g = arch.img_size, arch.grid
    tokens = vit(p["vit"], resize(x.to(dtype), (s, s)), arch)[0]
    t = tokens.float() @ p["proj"]["w"].float() + p["proj"]["b"].float()
    t = t[:, 1:].reshape(t.shape[0], g, g, -1)
    lo = F.relu(conv(lowres.float(), p["down"]["w"], p["down"]["b"], stride=2, padding=1))
    h = t + lo
    h = F.relu(conv(h, p["head"][0]["w"], p["head"][0]["b"], stride=2, padding=1))
    h = F.relu(conv(h, p["head"][1]["w"], p["head"][1]["b"], stride=2, padding=1))
    return conv(h, p["head"][2]["w"], p["head"][2]["b"]).reshape(-1)


@torch.inference_mode()
def infer(params: dict, frames: torch.Tensor, arch: Arch, dtype) -> dict:
    """uint8 frames (B, H, W, 3) -> {"depth": (B, H, W) fp32 metres,
    "focallength_px": (B,)}, f_px from the FOV head."""
    fp32_matmul = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        b, h, w = frames.shape[:3]
        x = frames.float() / 127.5 - 1.0
        n = arch.net_size
        xi = resize(x, (n, n))
        enc = encoder(params["encoder"], xi, arch, dtype)
        feats, lowres = decoder(params["decoder"], enc)
        canonical = head(params["head"], feats, dtype)[..., 0].float()
        fov_deg = fov(params["fov"], xi, lowres, arch, dtype).float()
        f_px = 0.5 * w / torch.tan(0.5 * torch.deg2rad(fov_deg))
        inv = canonical * (w / f_px)[:, None, None]
        inv = resize(inv[..., None], (h, w))[..., 0]
        return {"depth": 1.0 / torch.clamp(inv, 1e-4, 1e4), "focallength_px": f_px}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = fp32_matmul

