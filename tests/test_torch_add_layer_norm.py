"""K5 (``ops/norm.py``, ``csrc/add_layer_norm.cu``) against the plain
composition, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the kernel is built with nvcc for sm_90a and has no CPU mode). On a
machine with the card run
``python -m pytest --noconftest tests/test_torch_add_layer_norm.py``.
Each of K5's three modes (add and LayerNorm, LayerNorm only, add only) at
the widths of ViT-L, -B and -S and at the row counts of the video cells'
patch ViT (280 x 577 and 280 x 289 tokens), of one 8-frame ViT pass and an
odd one: ``x_new`` equal to ``torch.addcmul``'s bit for bit, the LayerNorm
output within one bf16 ulp of the fp32 LayerNorm's (its statistics are
summed in another order; the ulp at the larger of the output and its bias,
``_assert_within_an_ulp``). Then the widths at the edges of the kernel's
per-lane chunk counts, the inputs it refuses, and K5's launches in a bf16
forward of the large preset at the exact and the fast tier: 3 per ViT
block and 1 for each ViT's final norm, with no call of the plain
composition.
"""

import pytest
import torch

from ml_depth_pro_video_tpu_torch.core.precision import Precision, disable_tf32
from ml_depth_pro_video_tpu_torch.ops import attention as A
from ml_depth_pro_video_tpu_torch.ops import norm as N

pytestmark = pytest.mark.cuda

EPS = 1e-6
MODES = {"add_norm": (True, True), "norm": (False, True), "add": (True, False)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    disable_tf32()
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, rows: int, d: int, mode: str):
    add, norm = MODES[mode]
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3 + 0.5).bfloat16()
    branch = torch.randn((rows, d), generator=gen, device="cuda").bfloat16() if add else None
    ls = torch.rand(d, generator=gen, device="cuda") * 2 - 0.5 if add else None
    g = torch.randn(d, generator=gen, device="cuda") if norm else None
    b = torch.randn(d, generator=gen, device="cuda") * 0.1 if norm else None
    return x, branch, ls, g, b


def _assert_within_an_ulp(y: torch.Tensor, want: torch.Tensor, b: torch.Tensor) -> None:
    """|y - want| at most one bf16 ulp (2^(e - 7) for a value in [2^e, 2^(e+1)))
    at the larger of |want| and |b|: where the normalised value times g and
    the bias b nearly cancel, the two fp32 sums' roundings of the terms
    outweigh the small output's own ulp."""
    scale = torch.maximum(want.float().abs(), b.abs()).clamp_min(2.0 ** -126)
    ulps = (y.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)
    assert ulps.max().item() <= 1, f"LayerNorm output {ulps.max().item()} bf16 ulps off"


def _check(gen, rows: int, d: int, mode: str) -> None:
    args = _inputs(gen, rows, d, mode)
    before = N.K5.launches
    x_new, y = N.add_layer_norm(*args, EPS)
    torch.cuda.synchronize()
    assert N.K5.launches == before + 1
    want_x, want_y = N.add_layer_norm_reference(*args, EPS)
    add, norm = MODES[mode]
    if add:
        assert x_new.dtype == torch.bfloat16 and torch.equal(x_new, want_x)
    else:
        assert x_new is args[0]
    if norm:
        assert y.shape == (rows, d) and y.dtype == torch.bfloat16
        _assert_within_an_ulp(y, want_y, args[4])
    else:
        assert y is None


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("d", [384, 768, 1024])
@pytest.mark.parametrize("rows", [280 * 577, 280 * 289, 8 * 577, 1001])
def test_k5_matches_plain(cuda, rows, d, mode):
    _check(cuda, rows, d, mode)


# the least width, one past a lane's single chunk, the edges of 8 and 16 chunks a lane
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("d", [8, 264, 2056, 4096])
def test_k5_width_edges(cuda, d, mode):
    _check(cuda, 33, d, mode)


def test_k5_takes_a_view_off_alignment(cuda):
    """Contiguous views that start 2 bytes into their storage, and strided
    ones: the wrapper copies them."""
    x, branch, ls, g, b = _inputs(cuda, 65, 1024, "add_norm")
    x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(65, 1024)
    assert x.is_contiguous() and x.data_ptr() % 16
    branch = torch.cat([branch, branch], dim=1)[:, 1024:]
    got = N.add_layer_norm(x, branch, ls, g, b, EPS)
    want = N.add_layer_norm_reference(x, branch, ls, g, b, EPS)
    assert torch.equal(got[0], want[0])
    _assert_within_an_ulp(got[1], want[1], b)


def test_k5_raises_on_fp32(cuda):
    x, branch, ls, g, b = _inputs(cuda, 4, 64, "add_norm")
    with pytest.raises(ValueError, match="bf16"):
        N.add_layer_norm_op(x.float(), branch.float(), ls, g, b, EPS)
    with pytest.raises(ValueError, match="bf16"):
        N.add_layer_norm_op(x, branch.float(), ls, g, b, EPS)


@pytest.mark.parametrize("d", [100, 4100])
def test_k5_raises_on_widths_it_does_not_take(cuda, d):
    x, branch, ls, g, b = _inputs(cuda, 4, d, "add_norm")
    assert not N.k5_takes(x, branch)
    with pytest.raises(ValueError, match="width"):
        N.add_layer_norm_op(x, branch, ls, g, b, EPS)


def test_k5_raises_on_tensors_on_different_devices(cuda):
    x, branch, ls, g, b = _inputs(cuda, 4, 64, "add_norm")
    with pytest.raises(ValueError, match="one device"):
        N.add_layer_norm_op(x, branch, ls.cpu(), g, b, EPS)
    with pytest.raises(ValueError, match="one device"):
        N.add_layer_norm_op(x, branch, ls, g, b.cpu(), EPS)


def test_k5_refuses_half_a_pair(cuda):
    x, branch, ls, g, b = _inputs(cuda, 4, 64, "add_norm")
    with pytest.raises(ValueError, match="pairs"):
        N.add_layer_norm_op(x, branch, None, g, b, EPS)
    with pytest.raises(ValueError, match="pairs"):
        N.add_layer_norm_op(x, None, None, None, None, EPS)


# per ViT pass: 24 blocks x 3 (the first LayerNorm, the attention residual with the second,
# the MLP residual) and the final norm; three ViTs (the 35 patches, the image, the FOV)
K5_PER_FORWARD = {"exact": 3 * (3 * 24 + 1), "fast": 3 * (3 * 24 + 1)}


@pytest.mark.parametrize("speed", sorted(K5_PER_FORWARD))
def test_k5_launches_in_a_bf16_forward(cuda, speed, monkeypatch):
    from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro
    from ml_depth_pro_video_tpu_torch.models.depth_pro import apply_speed, forward, model_preset

    cfg = apply_speed(model_preset("large"), speed)
    params = init_depth_pro(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    x = torch.randn((1, cfg.img_size, cfg.img_size, 3), generator=cuda, device="cuda")
    plain = []
    reference = N.add_layer_norm_reference
    monkeypatch.setattr(N, "add_layer_norm_reference",
                        lambda *a, **k: plain.append(1) or reference(*a, **k))
    k1, k5 = A.K1.launches, N.K5.launches
    with torch.inference_mode():
        depth, fov = forward(params, x, cfg, Precision.bf16())
    torch.cuda.synchronize()
    assert torch.isfinite(depth).all() and torch.isfinite(fov).all()
    assert A.K1.launches - k1 == (72 if speed == "exact" else 50)
    assert N.K5.launches - k5 == K5_PER_FORWARD[speed]
    assert not plain, f"{len(plain)} calls of the plain composition"
