"""The yardstick's arithmetic: the card's peaks, a frame's FLOPs, and the
FLOPs and bytes of each hand-written kernel's call, from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
700 W limit. A frame's FLOPs count the model's matmuls and convolutions (2
FLOPs a multiply-add) as the configuration's shapes set them, whatever
implements a layer; elementwise work, norms and resizes are not counted.
"""

from __future__ import annotations

from .reference.depth_pro import Arch

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, moved: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    return max(flops / peak_flops, moved / PEAK_BYTES)


def attention_flops(b: int, h: int, s: int, hd: int) -> float:
    return 4.0 * b * h * s * s * hd  # q k^T and p v


def attention_bytes(b: int, s: int, d: int, elem: int = 2, bias: bool = False) -> float:
    """Packed qkv (B, S, 3D) read once, out (B, S, D) written once, and the
    fp32 key bias (B, S) read once."""
    return elem * b * s * 4 * d + (4.0 * b * s if bias else 0.0)


def resblock_flops(b: int, h: int, w: int, c: int) -> float:
    return 2 * 2.0 * b * h * w * 9 * c * c  # two 3x3 convolutions, C -> C


def resblock_bytes(b: int, h: int, w: int, c: int, elem: int = 2, w_elem: int = 4) -> float:
    """x read once and the output written once (bf16), the two (3, 3, C, C)
    weights and two biases read once in the type the model holds them (fp32)."""
    return 2.0 * elem * b * h * w * c + w_elem * (2 * 9 * c * c + 2 * c)


def vit_matmul_flops(arch: Arch, tokens: int) -> float:
    """Matmul FLOPs of one ViT block at ``tokens`` tokens: the four linears
    and q k^T, p v."""
    d = arch.embed_dim
    return 2.0 * tokens * d * d * (3 + 1 + 2 * arch.mlp_ratio) + 4.0 * tokens * tokens * d


def merged_tokens(arch: Arch) -> int:
    """Tokens left after the speed tier's merge: ``int(ratio * patches)`` of
    them merge away, at most one of each pair."""
    n = arch.tokens - 1
    return arch.tokens - min(int(arch.token_merge_ratio * n), (n + 1) // 2)


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def vit_pass_flops(arch: Arch, merge: bool = False) -> float:
    """One ViT pass: patch embed, the blocks (after the merge point at the
    merged length) and the merge's similarity matmul."""
    g2 = arch.grid ** 2
    d = arch.embed_dim
    total = 2.0 * g2 * arch.patch_size ** 2 * 3 * d
    tokens = arch.tokens
    if merge and arch.token_merge_ratio > 0:
        short = merged_tokens(arch)
        mb = arch.token_merge_block
        n = tokens - 1
        total += 2.0 * ((n + 1) // 2) * (n // 2) * d
        return total + mb * vit_matmul_flops(arch, tokens) + (
            arch.depth - mb) * vit_matmul_flops(arch, short)
    return total + arch.depth * vit_matmul_flops(arch, tokens)


def decoder_flops(arch: Arch) -> float:
    """Encoder upsampling, decoder, depth head and FOV head (its ViT aside)
    for one frame, layer by layer as published (the program may fold some of
them together: the count does not follow it)."""
    d, df, dims = arch.embed_dim, arch.decoder_features, arch.dims_encoder
    g = arch.grid
    total = 0.0

    def upsample(size, cin, mid, out, k):
        f = _conv(size, size, 1, cin, mid)
        c = mid
        for _ in range(k):
            f += 2.0 * size * size * c * 4 * out
            size, c = 2 * size, out
        return f

    # the 5x5 and 3x3 patch grids stitched, each inner edge trimmed by g/8 and g/4
    l0 = 5 * g - 4 * 2 * (g // 8)
    l1 = 3 * g - 2 * 2 * (g // 4)
    total += upsample(l0, d, dims[0], df, 3)
    total += upsample(l0, d, dims[0], dims[0], 2)
    total += upsample(l0, d, dims[1], dims[1], 1)
    total += upsample(l1, d, dims[2], dims[2], 1)
    total += upsample(g, d, dims[3], dims[3], 1)
    total += 2.0 * g * g * d * 4 * dims[3]                  # upsample_lowres
    total += _conv(2 * g, 2 * g, 1, 2 * dims[3], dims[3])  # fuse_lowres
    sizes = [8 * l0, 4 * l0, 2 * l0, 2 * l1, 2 * g]         # the five encodings
    for size, cin in zip(sizes[1:], dims):
        total += _conv(size, size, 3, cin, df)               # decoder convs
    for i, size in enumerate(sizes):
        blocks = 2 if i < len(sizes) - 1 else 1
        total += blocks * 2 * _conv(size, size, 3, df, df)  # residual blocks
        out = size
        if i:
            total += 2.0 * size * size * df * 4 * df         # deconv 2x2, stride 2
            out = 2 * size
        total += _conv(out, out, 1, df, df)                  # out conv
    top = sizes[0]
    total += _conv(top, top, 3, df, df // 2)                 # head conv_in
    total += 2.0 * top * top * (df // 2) * 4 * (df // 2)     # head deconv
    total += _conv(2 * top, 2 * top, 3, df // 2, 32)         # head conv_mid
    total += _conv(2 * top, 2 * top, 1, 32, 1)               # head conv_out
    lo = sizes[-1]
    total += 2.0 * arch.tokens * d * (df // 2)               # FOV proj
    total += _conv(lo // 2, lo // 2, 3, df, df // 2)         # FOV down
    total += _conv(lo // 4, lo // 4, 3, df // 2, df // 4)
    total += _conv(lo // 8, lo // 8, 3, df // 4, df // 8)
    total += _conv(1, 1, lo // 8, df // 8, 1)
    return total


def frame_flops(arch: Arch) -> float:
    """A frame's matmul and convolution FLOPs: 35 patch-ViT passes (merged
    in the speed tiers), the image and FOV ViTs, and the rest."""
    return (35 * vit_pass_flops(arch, merge=True) + 2 * vit_pass_flops(arch)
            + decoder_flops(arch))
