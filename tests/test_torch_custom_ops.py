"""The four kernels as ``torch.library`` custom operators (``ops/attention.py``,
``ops/resblock.py``) on the CPU, where each operator's CPU kernel is its plain
version: ``torch.library.opcheck`` (schema, autograd registration, the fake
kernel against the real one, AOTAutograd tracing), gradients equal to the
plain math's, a ViT block traced by Dynamo without a graph break, and no
kernel for any device but the CPU and CUDA."""

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu_torch.models import vit as V
from ml_depth_pro_video_tpu_torch.ops import attention as A
from ml_depth_pro_video_tpu_torch.ops import resblock as R

HEADS = 2


def _t(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _inputs(name: str, seed: int = 0) -> tuple:
    """Small inputs of each operator (head dim 16, 8 channels)."""
    rng = np.random.default_rng(seed)
    if name == "attention_packed":
        return (_t(rng, (2, 9, 3 * HEADS * 16)), HEADS)
    if name == "attention_packed_bias":
        return (_t(rng, (2, 9, 3 * HEADS * 16)),
                torch.log(torch.from_numpy(rng.integers(1, 4, (2, 9)).astype(np.float32))), HEADS)
    if name == "attention_bhsd":
        return tuple(_t(rng, (2, HEADS, 9, 16)) for _ in range(3))
    c = 8
    return (_t(rng, (1, 5, 6, c)), _t(rng, (3, 3, c, c), 0.1), _t(rng, (c,), 0.1),
            _t(rng, (3, 3, c, c), 0.1), _t(rng, (c,), 0.1))


OPS = {
    "attention_packed": (A.attention_packed_op,
                         lambda qkv, h: A.attention_packed_reference(qkv, h)),
    "attention_packed_bias": (A.attention_packed_bias_op,
                              lambda qkv, kb, h: A.attention_packed_reference(qkv, h, kb)),
    "attention_bhsd": (A.attention_bhsd_op, A.attention_reference),
    "resblock": (R.resblock_op, R.residual_block_reference),
}


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck(name, requires_grad):
    args = tuple(a.requires_grad_(requires_grad) if isinstance(a, torch.Tensor) else a
                 for a in _inputs(name))
    torch.library.opcheck(OPS[name][0], args)


@pytest.mark.parametrize("name", sorted(OPS))
def test_operator_gradients_equal_the_plain_math(name):
    op, plain = OPS[name]
    grads = []
    for fn in (op, plain):
        args = tuple(a.requires_grad_(True) if isinstance(a, torch.Tensor) else a
                     for a in _inputs(name, seed=1))
        out = fn(*args)
        cot = torch.from_numpy(np.random.default_rng(2).standard_normal(out.shape)
                               .astype(np.float32))
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        grads.append(torch.autograd.grad(out, tensors, cot))
        assert torch.equal(out.detach(), plain(*args).detach())
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _block_params(cfg: V.ViTConfig, rng) -> dict:
    d, hidden = cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim
    shapes = {"ln1_g": (d,), "ln1_b": (d,), "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
              "proj_w": (d, d), "proj_b": (d,), "ls1": (d,), "ln2_g": (d,), "ln2_b": (d,),
              "fc1_w": (d, hidden), "fc1_b": (hidden,), "fc2_w": (hidden, d), "fc2_b": (d,),
              "ls2": (d,)}
    return {k: _t(rng, s, d ** -0.5) for k, s in shapes.items()}


@pytest.mark.parametrize("bias", [False, True])
def test_vit_block_compiles_without_a_graph_break(bias):
    """One ViT block (K1, or K3 with a key bias) under ``torch.compile(
    backend=..., fullgraph=True)``: one graph that calls the operator, and the
    eager block's result. A recording backend runs the graph as traced, so no
    C++ compiler is needed."""
    torch._dynamo.reset()
    cfg = V.ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=HEADS,
                      mlp_ratio=2)
    rng = np.random.default_rng(3)
    x, bp = _t(rng, (2, 5, cfg.embed_dim)), _block_params(cfg, rng)
    key_bias = torch.log(torch.from_numpy(rng.integers(1, 4, (2, 5)).astype(np.float32))) \
        if bias else None
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    compiled = torch.compile(V._block, backend=backend, fullgraph=True)
    got = compiled(x, bp, cfg, key_bias)
    torch.testing.assert_close(got, V._block(x, bp, cfg, key_bias), rtol=0, atol=0)
    assert len(graphs) == 1
    op = "attention_packed_bias" if bias else "attention_packed"
    assert [str(n.target) for n in graphs[0].graph.nodes
            if "depth_pro" in str(n.target)] == [f"depth_pro.{op}.default"]


@pytest.mark.parametrize("name", sorted(OPS))
def test_no_kernel_for_other_devices(name):
    """A CPU kernel (the plain version) and a CUDA kernel (the hand-written
    one); no default kernel, so the dispatcher raises for any other device,
    and a fake kernel for tracing."""
    qualname = f"depth_pro::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualname, "CPU") and has(qualname, "CUDA") and has(qualname, "Meta")
    for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd", "XPU", "MPS",
                "PrivateUse1"):
        assert not has(qualname, key), key
