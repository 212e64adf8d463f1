"""DINOv2-style ViT backbone (twin of ``ml_depth_pro_video_tpu/models/vit.py``).

Patch embed PxP/sP as patchify + matmul (P = 16 in Depth Pro, 14 in Video
Depth Anything), cls token, learned pos embed,
pre-norm blocks with LayerScale and exact GELU, eps=1e-6 LayerNorms, and a
final LayerNorm. Block params are stacked along a leading depth axis; a
Python loop over that axis replaces the JAX package's ``lax.scan``, and
``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, the twin of the JAX package's per-block
``jax.checkpoint``).
Attention runs on the packed head-contiguous qkv through
``ops.attention.attention_packed``: kernel K1 on CUDA, or K3 on the blocks
after a ToMe token merge, which carry the merged tokens' log sizes as a
per-key score bias (``compute_token_merge``, the speed tiers). The block
matmul weights may be int8 codes with per-channel scales
(``ckpt/quantize.py``), dequantized to the compute dtype per matmul.
The residual adds with their LayerScale and the LayerNorms go through
``ops.norm`` (kernel K5 on CUDA in bf16): a block's first LayerNorm, its
attention residual with the LayerNorm after it, and its MLP residual, each
one call.

Under tensor parallelism (``tp``, a ``parallel/sharding.py::TensorParallel``
passed down ``vit_apply`` -> ``_run_blocks`` -> ``_block``) a block runs on
the rank's shard: the qkv and fc1 columns and the proj and fc2 rows, with
``num_heads // tp`` heads, *copy to tp* before the column GEMMs and *reduce
from tp* after the row GEMMs, whose bias is added once, after the sum.

A ViT may run on a grid that is not square (``GridViTConfig.img_hw``): the tree
then holds its position table at that grid, interpolated once from the
pretrained square table by ``interpolate_pos_embed`` (DINOv2's rule), and
the blocks are those of every other ViT.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ckpt.params import ParamTree
from ..ckpt.quantize import materialize_weight
from ..core.precision import Precision
from ..ops.attention import attention_packed
from ..ops.norm import add_layer_norm, layer_norm
from ..ops.resize import _cubic_filter


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT backbone configuration (default: dinov2l16_384)."""

    img_size: int = 384
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def grid_hw(self) -> tuple[int, int]:
        return self.grid_size, self.grid_size

    @property
    def num_tokens(self) -> int:
        gh, gw = self.grid_hw
        return gh * gw + 1


@dataclasses.dataclass(frozen=True)
class GridViTConfig(ViTConfig):
    """A ViT on (H, W) images that need not be square: ``img_size`` stays
    the pretrained table's square size, ``img_hw`` is the input's."""

    img_hw: tuple = (384, 384)

    @property
    def grid_hw(self) -> tuple[int, int]:
        return self.img_hw[0] // self.patch_size, self.img_hw[1] // self.patch_size


VIT_CONFIG_DICT = {
    "dinov2l16_384": ViTConfig(img_size=384, patch_size=16, embed_dim=1024, depth=24,
                               num_heads=16, mlp_ratio=4),
    "dinov2b16_384": ViTConfig(img_size=384, patch_size=16, embed_dim=768, depth=12,
                               num_heads=12, mlp_ratio=4),
    "dinov2s16_384": ViTConfig(img_size=384, patch_size=16, embed_dim=384, depth=12,
                               num_heads=6, mlp_ratio=4),
}


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/patch)*(W/patch), patch*patch*C), (kh, kw, c)-ordered."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _pos_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) fp64 matrix of torch's bicubic resize (a = -0.75, no
    antialias, taps clamped at the edges) with its scale factor given: output
    i samples input (i + 0.5) / scale - 0.5."""
    center = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    taps = np.floor(center).astype(np.int64)[:, None] + np.arange(-1, 3)[None, :]
    w = _cubic_filter(taps - center[:, None])
    mat = np.zeros((out_size, in_size), np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), 4), np.clip(taps, 0, in_size - 1).ravel()),
              w.ravel())
    return mat


def interpolate_pos_embed(pos: torch.Tensor, grid_hw: tuple[int, int],
                          offset: float = 0.1) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding``: the (1, 1+G*G, D) pretrained
    table with its patch rows resampled to the (gh, gw) grid by a bicubic
    resize whose scale factors are ``((gh + offset) / G, (gw + offset) / G)``
    (given, not the sizes' ratio: the offset shifts every sample). The cls
    row is kept. Computed in fp64, returned in ``pos``'s dtype."""
    n = pos.shape[1] - 1
    g = int(round(math.sqrt(n)))
    gh, gw = grid_hw
    if g * g != n:
        raise ValueError(f"the pretrained position table must be square, got {n} patch rows")
    if (gh, gw) == (g, g):
        return pos
    dev = pos.device
    mh = torch.as_tensor(_pos_matrix(g, gh, (gh + offset) / g), device=dev)
    mw = torch.as_tensor(_pos_matrix(g, gw, (gw + offset) / g), device=dev)
    grid = pos[0, 1:].double().reshape(g, g, -1)
    out = torch.einsum("ih,hwd,jw->ijd", mh, grid, mw).reshape(1, gh * gw, -1)
    return torch.cat([pos[:, :1], out.to(pos.dtype)], dim=1)


def _dense(x: torch.Tensor, w, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype, the bias added inside the GEMM (one pass over
    the output instead of a second elementwise one). ``w`` is a tensor or a
    quantized ``{'q', 's'}`` dict, dequantized to x's dtype first."""
    w = materialize_weight(w, x.dtype)
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _dense_rows(x: torch.Tensor, w, b: torch.Tensor, tp=None) -> torch.Tensor:
    """``_dense`` of a row-split weight: under ``tp`` the partial products are
    summed over the tp group (*reduce from tp*) and the bias is added once,
    after the sum, not inside each rank's GEMM."""
    if tp is None:
        return _dense(x, w, b)
    w = materialize_weight(w, x.dtype)
    y = (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])
    return tp.reduce(y) + b.to(x.dtype)


def _unstack(blocks: dict, depth: int) -> list[dict]:
    """Per-block views of the stacked block params (a leaf may be a
    ``{'q', 's'}`` dict). One ``unbind`` per leaf: under autograd its
    backward stacks the blocks' gradients once, as the JAX scan's cotangent
    does, where slicing block ``i`` out of the stack would fill and add a
    zero tensor of the whole stack for every block."""
    cols = {k: ({kk: t.unbind(0) for kk, t in v.items()} if isinstance(v, dict)
                else v.unbind(0)) for k, v in blocks.items()}
    return [{k: ({kk: c[kk][i] for kk in c} if isinstance(c, dict) else c[i])
             for k, c in cols.items()} for i in range(depth)]


def _block(x: torch.Tensor, bp: dict, cfg: ViTConfig,
           key_bias: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    heads = cfg.num_heads if tp is None else cfg.num_heads // tp.size
    h = layer_norm(x, bp["ln1_g"], bp["ln1_b"], cfg.layer_norm_eps)
    if tp is not None:
        h = tp.copy(h)
    attn = attention_packed(_dense(h, bp["qkv_w"], bp["qkv_b"]), heads, key_bias)
    x, h = add_layer_norm(x, _dense_rows(attn, bp["proj_w"], bp["proj_b"], tp), bp["ls1"],
                          bp["ln2_g"], bp["ln2_b"], cfg.layer_norm_eps)
    if tp is not None:
        h = tp.copy(h)
    h = F.gelu(_dense(h, bp["fc1_w"], bp["fc1_b"]))
    return add_layer_norm(x, _dense_rows(h, bp["fc2_w"], bp["fc2_b"], tp), bp["ls2"])[0]


def _run_blocks(x: torch.Tensor, layers: list, lo: int, hi: int, cfg: ViTConfig,
                key_bias: torch.Tensor | None = None, remat: bool = False,
                tp=None) -> torch.Tensor:
    """Blocks [lo, hi) of ``layers`` (``_unstack``'s per-block params);
    ``key_bias`` (B, S) is the per-key score bias of every block in the
    segment (ToMe proportional attention). ``remat`` keeps only each
    block's input for the backward pass and runs the block again there
    (its kernels included); a block draws no random numbers, so no RNG
    state is saved. Under ``tp`` the recomputed block issues its sums over
    the tp group again, in the backward, at the same point on every rank."""
    for i in range(lo, hi):
        if remat:
            x = checkpoint(_block, x, layers[i], cfg, key_bias, tp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, layers[i], cfg, key_bias, tp)
    return x


# ---------------------------------------------------------------------------
# token merging (ToMe speed tier)


def compute_token_merge(tokens: torch.Tensor, ratio: float):
    """Bipartite soft matching over the patch tokens (ToMe, Bolya et al.,
    ICLR 2023; the cls token is never merged). Twin of the JAX package's
    ``models/vit.py::compute_token_merge``.

    Patch tokens alternate into sets A and B; each A token's best cosine
    match in B is found, and the ``r = int(ratio * n_patch)`` most similar A
    tokens are averaged into their matches. Returns ``(merged (B, S-r, D),
    gather map (B, S) int64, log_sizes (B, S-r) fp32)``: the gather map
    rebuilds a full-length sequence by copying each merged token back to its
    source positions, and ``log_sizes`` (the log of how many original tokens
    each merged token stands for) is the per-key score bias of proportional
    attention. ``None`` if r < 1. Similarity is measured on the tokens
    themselves, in fp32.
    """
    b, s, d = tokens.shape
    n = s - 1
    na = (n + 1) // 2
    nb = n - na
    r = min(int(ratio * n), na)
    if r < 1 or nb < 1:
        return None

    xs = tokens[:, 1:]
    a, bb = xs[:, 0::2], xs[:, 1::2]
    # dividing by an fp32 norm promotes bf16 tokens: the similarity is fp32
    an = a / (torch.linalg.vector_norm(a.float(), dim=-1, keepdim=True) + 1e-6)
    bn = bb / (torch.linalg.vector_norm(bb.float(), dim=-1, keepdim=True) + 1e-6)
    sim = an @ bn.transpose(1, 2)                                   # (B, na, nb)
    best_val = sim.amax(dim=-1)
    best_idx = sim.argmax(dim=-1)                                   # first maximum
    order = torch.argsort(-best_val, dim=-1, stable=True)           # (B, na)
    merged_rank, kept_rank = order[:, :r], order[:, r:]

    dst = torch.gather(best_idx, 1, merged_rank)                    # (B, r)
    a_sel = torch.gather(a, 1, merged_rank[..., None].expand(-1, -1, d))
    # atomics on CUDA: the sums into one B token run in no fixed order
    sum_b = bb.float().scatter_add(1, dst[..., None].expand(-1, -1, d), a_sel.float())
    cnt = torch.ones((b, nb), dtype=torch.float32, device=tokens.device).scatter_add(
        1, dst, torch.ones_like(dst, dtype=torch.float32))
    b_merged = (sum_b / cnt[..., None]).to(tokens.dtype)
    a_kept = torch.gather(a, 1, kept_rank[..., None].expand(-1, -1, d))
    merged = torch.cat([tokens[:, :1], a_kept, b_merged], dim=1)

    # inverse gather map: original position -> merged-sequence index
    dev = tokens.device
    a_pos = 1 + 2 * torch.arange(na, device=dev)
    b_pos = 2 + 2 * torch.arange(nb, device=dev)
    gmap = torch.zeros((b, s), dtype=torch.int64, device=dev)
    gmap.scatter_(1, a_pos[kept_rank], (1 + torch.arange(na - r, device=dev)).expand(b, -1))
    gmap.scatter_(1, a_pos[merged_rank], 1 + (na - r) + dst)
    gmap[:, b_pos] = 1 + (na - r) + torch.arange(nb, device=dev)

    # cls and kept A tokens stand for themselves (log 1 = 0); each B token
    # for itself plus whatever merged into it
    log_sizes = torch.cat([torch.zeros((b, 1 + na - r), device=dev), torch.log(cnt)], dim=1)
    return merged, gmap, log_sizes


def unmerge_tokens(tokens: torch.Tensor, gmap: torch.Tensor) -> torch.Tensor:
    """(B, S-r, D) + gather map -> (B, S, D), copying merged tokens back to
    every source position."""
    return torch.gather(tokens, 1, gmap[..., None].expand(-1, -1, tokens.shape[-1]))


def embed_tokens(params: dict, x: torch.Tensor, cfg: ViTConfig,
                 precision: Precision = Precision.fp32()) -> torch.Tensor:
    """The tokens before the first block: patch embed, cls token, pos embed."""
    cdt = precision.compute_dtype
    tokens = _dense(patchify(x.to(cdt), cfg.patch_size), params["patch_embed"]["w"],
                    params["patch_embed"]["b"])
    cls = params["cls_token"].to(cdt).expand(x.shape[0], 1, cfg.embed_dim)
    return torch.cat([cls, tokens], dim=1) + params["pos_embed"].to(cdt)


def vit_apply(params: dict, x: torch.Tensor, cfg: ViTConfig,
              precision: Precision = Precision.fp32(),
              capture_blocks: Sequence[int] = (),
              merge_ratio: float = 0.0,
              merge_block: int = 2,
              remat: bool = False, tp=None) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """x: (B, H, W, 3) normalized NHWC (img x img, or a ``GridViTConfig``'s ``img_hw``).
    Returns (final tokens after the last LayerNorm, [outputs of the blocks
    in ``capture_blocks``, in sorted order]), each (B, 1+gh*gw, D).

    ``merge_ratio > 0`` turns on the ToMe speed tier: after ``merge_block``
    exact blocks, ``int(ratio * n_patch)`` tokens are merged away once and
    the remaining blocks run on the shorter sequence with the log token
    sizes as key bias; captures and the final tokens are unmerged back to
    full length. A ratio too small to merge one token changes nothing, and
    a merge point at or after the last block is skipped. ``remat=True``
    recomputes each block in the backward pass (training at 1536 px).
    ``tp`` (a ``parallel/sharding.py::TensorParallel``): the blocks hold
    this rank's tensor-parallel shard."""
    tokens = embed_tokens(params, x, cfg, precision)
    blocks = _unstack(params["blocks"], cfg.depth)
    captures = []
    gmap = key_bias = None
    lo = 0

    def merge_now(t):
        m = compute_token_merge(t, merge_ratio)
        return (t, None, None) if m is None else m

    mb = min(max(merge_block, 0), cfg.depth) if merge_ratio > 0.0 else None
    merge_pending = mb is not None and mb < cfg.depth
    for idx in sorted(capture_blocks):
        if merge_pending and mb <= idx:
            tokens = _run_blocks(tokens, blocks, lo, mb, cfg, remat=remat, tp=tp)
            lo = mb
            tokens, gmap, key_bias = merge_now(tokens)
            merge_pending = False
        tokens = _run_blocks(tokens, blocks, lo, idx + 1, cfg, key_bias, remat, tp)
        captures.append(unmerge_tokens(tokens, gmap) if gmap is not None else tokens)
        lo = idx + 1
    if merge_pending and max(mb, lo) < cfg.depth:
        mb = max(mb, lo)
        tokens = _run_blocks(tokens, blocks, lo, mb, cfg, remat=remat, tp=tp)
        lo = mb
        tokens, gmap, key_bias = merge_now(tokens)
    tokens = _run_blocks(tokens, blocks, lo, cfg.depth, cfg, key_bias, remat, tp)

    tokens = layer_norm(tokens, params["norm"]["g"], params["norm"]["b"], cfg.layer_norm_eps)
    if gmap is not None:
        tokens = unmerge_tokens(tokens, gmap)
    return tokens, captures


class ViT(nn.Module):
    """A ViT backbone: its param tree as module parameters, and
    ``vit_apply`` as the forward."""

    def __init__(self, params: dict, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, x: torch.Tensor, precision: Precision = Precision.fp32(),
                capture_blocks: Sequence[int] = ()):
        return vit_apply(self.tree(), x, self.cfg, precision, capture_blocks)
