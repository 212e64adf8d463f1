"""ml-depth-pro-video ported to PyTorch and CUDA (NVIDIA Hopper).

The PyTorch twin of ``ml_depth_pro_video_tpu``: same subpackage layout and
module names, same param-tree layouts, no jax. The JAX package is the
reference it is tested against. The hand-written CUDA kernels live in
``csrc/`` and are built with nvcc at first use (``kernels/loader.py``).

    from ml_depth_pro_video_tpu_torch import create_model_and_transforms
"""

__version__ = "0.1.0"

_EXPORTS = {
    "create_model_and_transforms": ("ml_depth_pro_video_tpu_torch.models.depth_pro",
                                    "create_model_and_transforms"),
    "DepthPro": ("ml_depth_pro_video_tpu_torch.models.depth_pro", "DepthPro"),
    "DepthProConfig": ("ml_depth_pro_video_tpu_torch.models.depth_pro", "DepthProConfig"),
    "DEFAULT_MONODEPTH_CONFIG": ("ml_depth_pro_video_tpu_torch.models.depth_pro",
                                 "DEFAULT_MONODEPTH_CONFIG"),
    "DepthVideoRunner": ("ml_depth_pro_video_tpu_torch.video.runner", "DepthVideoRunner"),
    "load_rgb": ("ml_depth_pro_video_tpu_torch.io.image", "load_rgb"),
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
