"""Video Depth Anything's work, from the configuration's shapes alone.

As ``portbench/flops.py`` counts Depth Pro's: the model's matmuls and
convolutions (2 FLOPs a multiply-add) as upstream's layers set them,
whatever implements a layer; norms, resizes and elementwise work are not
counted. The work a window needs is the encoder once per new frame (a
carried keyframe's features do not change) and the head and temporal
modules over every frame of the window; ``new_frame_flops`` spreads it over
the window's new frames. The program re-encodes the carried frames, which
this count leaves out, so that a program that stops doing so is read on the
same work.
"""

from __future__ import annotations

from .reference.video_depth_anything import Arch


def encoder_flops(arch: Arch) -> float:
    """One frame through the ViT: the patch embedding and the blocks (the
    four linears, q k^T and p v)."""
    d, s = arch.embed_dim, arch.tokens
    patches = s - 1
    block = 2.0 * s * d * d * (3 + 1 + 2 * arch.mlp_ratio) + 4.0 * s * s * d
    return 2.0 * patches * arch.patch_size ** 2 * 3 * d + arch.depth * block


def _conv(px: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * px * k * k * cin * cout


def head_flops(arch: Arch) -> float:
    """One frame through the DPT head, its temporal modules aside."""
    gh, gw = arch.grid_hw
    d, f, oc = arch.embed_dim, arch.features, arch.out_channels
    g = gh * gw
    px = [16 * g, 4 * g, g, ((gh + 1) // 2) * ((gw + 1) // 2)]   # the four reassembled grids
    total = sum(_conv(g, 1, d, c) for c in oc)                   # projects
    total += 2.0 * g * oc[0] * 16 * oc[0] + 2.0 * g * oc[1] * 4 * oc[1]   # 4x4/s4, 2x2/s2
    total += _conv(px[3], 3, oc[3], oc[3])                        # 3x3/s2
    total += sum(_conv(p, 3, c, f) for p, c in zip(px, oc))      # layerN_rn
    outs = [4 * px[0], px[0], px[1], px[2]]                      # each fusion's output grid
    for i in range(4):
        units = 1 if i == 3 else 2
        total += units * 2 * _conv(px[i], 3, f, f) + _conv(outs[i], 1, f, f)
    total += _conv(outs[0], 3, f, f // 2)                        # output_conv1
    net = arch.net_hw[0] * arch.net_hw[1]
    total += _conv(net, 3, f // 2, arch.head_features_2) + _conv(net, 1, arch.head_features_2, 1)
    return total


def temporal_flops(arch: Arch) -> float:
    """One frame through the four temporal modules: proj_in and proj_out,
    two attentions (q, k, v, out; q k^T and p v over the window), the GEGLU
    feed-forward."""
    gh, gw = arch.grid_hw
    g, f, oc, t = gh * gw, arch.features, arch.out_channels, arch.window
    total = 0.0
    for d, c in ((g, oc[2]), (((gh + 1) // 2) * ((gw + 1) // 2), oc[3]), (g, f), (4 * g, f)):
        total += 2.0 * d * c * c * (2 + 2 * 4 + 8 + 4) + 2 * 4.0 * d * t * c
    return total


def window_flops(arch: Arch) -> float:
    """The work one window needs: its new frames' encoding, and the head
    and temporal modules over all its frames."""
    return (arch.step * encoder_flops(arch)
            + arch.window * (head_flops(arch) + temporal_flops(arch)))


def new_frame_flops(arch: Arch) -> float:
    return window_flops(arch) / arch.step
