"""The one place the Depth Pro family touches the program under test
(``portbench/families/depth_pro.py`` hands it to the harness).

It takes from ``ml_depth_pro_video_tpu_torch`` only the system under test
(the streaming runner) and its counters (kernel launches). The runner builds its model
from a parameter tree it makes itself; ``weights_injected`` hands it the
benchmark's tree instead, so that the program and the reference start from
the same seeded weights and neither takes the other's.
"""

from __future__ import annotations

import contextlib


def _port():
    import ml_depth_pro_video_tpu_torch.video.runner as runner_mod
    from ml_depth_pro_video_tpu_torch.models import depth_pro

    return runner_mod, depth_pro


@contextlib.contextmanager
def weights_injected(weights: dict):
    """While open, a runner built by the program takes ``weights`` as its
    parameter tree (the tree it would otherwise draw at random)."""
    runner_mod, _ = _port()
    made = runner_mod.build_params

    def given(cfg, device, rng_seed=0):
        return weights

    runner_mod.build_params = given
    try:
        yield
    finally:
        runner_mod.build_params = made


def model_config(config: dict):
    """The program's ``DepthProConfig`` for a configuration file, checked
    against the file's shapes (after the speed tier is applied)."""
    _, depth_pro = _port()
    m = config["model"]
    cfg = depth_pro.apply_speed(depth_pro.model_preset(m["preset"]), m["speed"])
    vit = cfg.vit
    have = {"vit_img_size": vit.img_size, "patch_size": vit.patch_size,
            "embed_dim": vit.embed_dim, "depth": vit.depth, "num_heads": vit.num_heads,
            "mlp_ratio": vit.mlp_ratio, "decoder_features": cfg.decoder_features,
            "dims_encoder": list(cfg.dims_encoder), "hook_block_ids": list(cfg.hook_block_ids),
            "token_merge_ratio": cfg.token_merge_ratio,
            "token_merge_block": cfg.token_merge_block}
    wrong = {k: (v, m[k]) for k, v in have.items() if v != m[k]}
    if wrong:
        raise ValueError(f"the program's preset {m['preset']!r} at speed {m['speed']!r} is not "
                         f"the configuration: {wrong} (program, file)")
    return cfg


def build_runner(config: dict, weights: dict, batch: int, device, quantize: bool = False):
    """A ``DepthVideoRunner`` as users get it (its defaults), on the
    benchmark's weights."""
    runner_mod, _ = _port()
    cfg = model_config(config)
    with weights_injected(weights):
        return runner_mod.DepthVideoRunner(cfg=cfg, precision=config["model"]["precision"],
                                           batch_size=batch, device=device, quantize=quantize)


def launches() -> dict:
    """The hand-written kernels' launch counters."""
    from ml_depth_pro_video_tpu_torch.ops import attention, resblock

    return {"K1": attention.K1.launches, "K3": attention.K3.launches,
            "K2": resblock.K2.launches}
