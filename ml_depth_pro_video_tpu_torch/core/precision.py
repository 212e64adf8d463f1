"""Dtype and device policy of the PyTorch port.

Params are stored in fp32. ``bf16`` computes the ViT and the conv trunk in
bfloat16; LayerNorm statistics, the depth head's final 1x1 conv, the FOV
head's projection, convs and trigonometry, and every resize stay fp32, so
the ``1/clamp(inverse_depth)`` output keeps the JAX package's accuracy.
Matmuls and convs accumulate in fp32 in both modes (Hopper's tensor cores
do so at full rate, so the JAX package's bf16-accumulate rule, a TPU v5e
workaround, is not carried over).

On CUDA, cuDNN runs fp32 convolutions in TF32 unless told otherwise, which
keeps about three decimal digits. The port's fp32 ops are meant as fp32 in
both modes, so building a model on CUDA turns TF32 off for matmuls and
cuDNN convs (:func:`disable_tf32`) and logs that it did.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``compute_dtype``: what the ViT and conv trunk compute in. Params
    stay fp32; outputs and head math are fp32."""

    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def fp32() -> "Precision":
        return Precision(torch.float32)

    @staticmethod
    def bf16() -> "Precision":
        return Precision(torch.bfloat16)


def resolve_precision(precision) -> Precision:
    if isinstance(precision, Precision):
        return precision
    if precision in (None, "fp32", "float32"):
        return Precision.fp32()
    if precision in ("bf16", "bfloat16", "half"):
        return Precision.bf16()
    raise ValueError(f"Unknown precision {precision!r}")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA where there is none
    raises (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def disable_tf32() -> None:
    """Make fp32 matmuls and cuDNN convs run in true fp32 (no TF32)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        LOGGER.info("disabling TF32 for CUDA matmuls and cuDNN convs: "
                    "the port's fp32 ops run in full fp32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
