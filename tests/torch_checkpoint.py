"""Random tiny-config params as the JAX converter writes them, for the
tests that run the port's runner beside the JAX package's on one npz."""

import numpy as np
import torch

from ml_depth_pro_video_tpu.ckpt.convert import save_params
from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro, to_numpy_tree
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config


def write_tiny_checkpoint(path: str, seed: int = 11) -> str:
    """Write the tiny tree with every leaf redrawn from numpy (biases and
    LayerScale included) to ``path``; return ``path``."""
    rng = np.random.default_rng(seed)
    tree = to_numpy_tree(init_depth_pro(tiny_config(), torch.Generator().manual_seed(0)))

    def redraw(node):
        if isinstance(node, dict):
            return {k: redraw(v) for k, v in node.items()}
        if isinstance(node, list):
            return [redraw(v) for v in node]
        if node is None:
            return None
        std = float(node.std())
        return (node.mean() + rng.standard_normal(node.shape) * (std if std > 0 else 0.1)
                ).astype(np.float32)

    save_params(path, redraw(tree))
    return path
