"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the kernels are built with nvcc for sm_90a and have no CPU mode).
On a machine with the card run
``python -m pytest --noconftest tests/test_torch_kernels.py`` (the suite's
conftest imports jax, which that machine need not have);
``chip_smoke.py`` covers the same ground at the model's full shapes.
Bounds: the attention kernels (K1, K3, K4) fp32 1e-5 of scale (TF32 off),
bf16 1e-2; K2 bf16 < 2e-2 (the JAX package's resblock band,
tests/test_ops.py:263).
"""

import pytest
import torch

from ml_depth_pro_video_tpu_torch.core.precision import disable_tf32
from ml_depth_pro_video_tpu_torch.ops import attention as A
from ml_depth_pro_video_tpu_torch.ops import resblock as R

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (sm_90a)")
    disable_tf32()
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("shape,heads", [((3, 33, 192), 4), ((2, 65, 384), 2),
                                         ((2, 65, 192), 2), ((1, 577, 3072), 16),
                                         ((2, 577, 3072), 16), ((70, 577, 3072), 16),
                                         ((2, 130, 768), 2), ((4, 70, 3 * 2 * 16), 2)])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_attention_kernel_matches_plain(cuda, shape, heads, dtype, bound):
    qkv = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    before = A.K1.launches
    got = A.attention_packed(qkv, heads)
    torch.cuda.synchronize()
    assert A.K1.launches == before + 1
    assert got.shape == (shape[0], shape[1], shape[2] // 3) and got.dtype == dtype
    assert _rel(got, A.attention_packed_reference(qkv, heads)) <= bound


def _wide_grid(batch, heads, s):
    """Whether a bf16 hd=64 call of this shape takes the 128-query blocks (32
    rows per warp) on this card: csrc/attention_packed.cu::wide_blocks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return batch * heads * -(-s // 128) >= 2 * sms


def _packed_case(cuda, batch, s, heads, hd, dtype, with_bias):
    qkv = torch.randn((batch, s, 3 * heads * hd), generator=cuda, device="cuda").to(dtype)
    bias = _log_sizes((batch, s), cuda) if with_bias else None
    kernel = A.K3 if with_bias else A.K1
    before = kernel.launches
    got = A.attention_packed(qkv, heads, bias)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (batch, s, heads * hd) and torch.isfinite(got).all()
    return _rel(got, A.attention_packed_reference(qkv, heads, bias))


# the edges of the 64-key tiles and of the 64- and 128-query blocks, K1 and K3 at hd 64:
# (1, 2) is a grid that stays on 64-query blocks, (24, 16) one that takes the 128-query
# blocks on a card of up to 192 SMs (the test checks that it does on this one)
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 191, 257])
@pytest.mark.parametrize("batch,heads,wide", [(1, 2, False), (24, 16, True)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_attention_kernel_tile_edges(cuda, s, batch, heads, wide, with_bias, dtype, bound):
    assert _wide_grid(batch, heads, s) == wide
    assert _packed_case(cuda, batch, s, heads, 64, dtype, with_bias) <= bound


@pytest.mark.parametrize("s", [65, 129])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_attention_kernel_tile_edges_head_dim_128(cuda, s, with_bias, dtype, bound):
    assert _packed_case(cuda, 2, s, 2, 128, dtype, with_bias) <= bound


@pytest.mark.parametrize("s", [128 + 1, 128 + 33, 384 + 64])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_wide_block_with_whole_warps_past_the_end(cuda, s, with_bias):
    """The last 128-query block holds 1, 33 or 64 valid rows: one warp with a
    single row, then whole warps past S that must skip their compute and
    still take part in the loads and barriers."""
    assert _wide_grid(24, 16, s)
    assert _packed_case(cuda, 24, s, 16, 64, torch.bfloat16, with_bias) <= 1e-2


def test_attention_kernel_raises_on_unsupported_head_dim(cuda):
    with pytest.raises(ValueError):
        A.attention_packed(torch.zeros(1, 8, 3 * 2 * 24, device="cuda"), 2)


def _log_sizes(shape, generator):
    """A ToMe bias: log of integer token counts >= 1."""
    counts = torch.randint(1, 5, shape, generator=generator, device="cuda")
    return counts.float().log()


# the speed tiers' shapes at batch 1 and 2 (balanced: 433 tokens, fast: 289), then ragged ones
@pytest.mark.parametrize("shape,heads", [((35, 433, 3072), 16), ((70, 433, 3072), 16),
                                         ((70, 289, 3072), 16), ((3, 33, 192), 4),
                                         ((2, 65, 192), 2), ((2, 130, 768), 2)])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_attention_bias_kernel_matches_plain(cuda, shape, heads, dtype, bound):
    qkv = torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    bias = _log_sizes(shape[:2], cuda)
    k1, k3 = A.K1.launches, A.K3.launches
    got = A.attention_packed(qkv, heads, bias)
    torch.cuda.synchronize()
    assert (A.K1.launches, A.K3.launches) == (k1, k3 + 1)
    assert got.shape == (shape[0], shape[1], shape[2] // 3) and got.dtype == dtype
    assert _rel(got, A.attention_packed_reference(qkv, heads, bias)) <= bound


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_attention_bias_kernel_takes_minus_inf_keys(cuda, dtype, bound):
    """-inf bias on a whole first key tile, on scattered keys, and on every
    key of one batch item: no NaN; that item's rows are zeros (the plain
    version gives NaN there), the other items match the plain version."""
    b, s, heads = 3, 150, 2
    qkv = torch.randn((b, s, 3 * 2 * 64), generator=cuda, device="cuda").to(dtype)
    bias = _log_sizes((b, s), cuda)
    bias[0, :64] = -float("inf")
    bias[1, ::3] = -float("inf")
    bias[2] = -float("inf")
    got = A.attention_packed(qkv, heads, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got[2] == 0).all()
    ref = A.attention_packed_reference(qkv, heads, bias)
    assert _rel(got[:2], ref[:2]) <= bound


def test_attention_without_bias_launches_k1_only(cuda):
    qkv = torch.randn((2, 65, 384), generator=cuda, device="cuda").bfloat16()
    k1, k3 = A.K1.launches, A.K3.launches
    A.attention_packed(qkv, 2)
    assert (A.K1.launches, A.K3.launches) == (k1 + 1, k3)


@pytest.mark.parametrize("shape", [(70, 16, 577, 64), (1, 16, 577, 64), (3, 4, 33, 32),
                                   (2, 2, 65, 16), (1, 2, 130, 128)])
@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_unpacked_attention_kernel_matches_plain(cuda, shape, dtype, bound):
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda").to(dtype) for _ in range(3))
    before = A.K4.launches
    got = A.multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.K4.launches == before + 1
    assert got.shape == shape and got.dtype == dtype
    assert _rel(got, A.attention_reference(q, k, v)) <= bound


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unpacked_kernel_equals_packed_kernel(cuda, dtype):
    """K4 is K1's kernel body read through other strides: on the same q, k, v
    the two give the same bits."""
    b, s, heads, hd = 4, 97, 4, 64
    qkv = torch.randn((b, s, 3 * heads * hd), generator=cuda, device="cuda").to(dtype)
    q, k, v = (t.contiguous() for t in A._split_packed(qkv, heads))
    packed = A.attention_packed(qkv, heads)
    unpacked = A.multi_head_attention(q, k, v).transpose(1, 2).reshape(b, s, heads * hd)
    torch.cuda.synchronize()
    assert torch.equal(packed, unpacked)


def _resblock_case(cuda, shape):
    c = shape[-1]
    x = (torch.randn(shape, generator=cuda, device="cuda") * 0.5).bfloat16()
    w1, w2 = (torch.randn((3, 3, c, c), generator=cuda, device="cuda") * (9 * c) ** -0.5
              for _ in range(2))
    b1, b2 = (torch.randn((c,), generator=cuda, device="cuda") * 0.1 for _ in range(2))
    before = R.K2.launches
    got = R.fused_residual_block(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert R.K2.launches == before + 1
    assert got.shape == shape and got.dtype == torch.bfloat16
    return _rel(got, R.residual_block_reference(x, w1, b1, w2, b2))


@pytest.mark.parametrize("shape", [(1, 48, 48, 256), (2, 48, 48, 256), (2, 96, 96, 256),
                                   (1, 20, 24, 64), (1, 9, 7, 24)])
def test_resblock_kernel_matches_plain(cuda, shape):
    assert _resblock_case(cuda, shape) < 2e-2


def _wide_tiles(batch, h, w):
    """Whether K2 takes its wide 10x8 tiles for this shape on this card (6x6
    else): csrc/resblock.cu::wide_tiles."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return batch * -(-h // 10) * -(-w // 8) >= sms


# H and W that are multiples of neither tile side, a single pixel and a single row, at every
# width the kernel's warps split differently (24 pads to 64 channels: warp 1 computes zeros,
# warps 2-7 are idle)
@pytest.mark.parametrize("hw", [(9, 7), (17, 23), (1, 1), (1, 50)])
@pytest.mark.parametrize("c", [24, 64, 128, 256])
def test_resblock_kernel_tile_edges(cuda, hw, c):
    assert not _wide_tiles(2, *hw)
    assert _resblock_case(cuda, (2, *hw, c)) < 2e-2


# both tilings of the dispatch: (2, 48, 48) gives 60 10x8 tiles and takes 6x6 ones, the others
# give at least 168 10x8 tiles (ragged at 61 = 6 * 10 + 1, 57, 101 and 90) and take them, on a
# card of up to 168 SMs
@pytest.mark.parametrize("shape,wide", [((2, 48, 48, 256), False), ((1, 48, 48, 256), False),
                                        ((2, 96, 96, 256), True), ((3, 61, 57, 256), True),
                                        ((2, 101, 90, 128), True), ((2, 101, 90, 24), True)])
def test_resblock_kernel_tilings(cuda, shape, wide):
    assert _wide_tiles(*shape[:3]) == wide
    assert R.k2_tile(*shape[:3]) == ((10, 8) if wide else (6, 6))
    assert _resblock_case(cuda, shape) < 2e-2


def test_resblock_kernel_raises_on_odd_channels(cuda):
    c = 12
    w, b = torch.zeros(3, 3, c, c, device="cuda"), torch.zeros(c, device="cuda")
    with pytest.raises(ValueError):
        R.fused_residual_block(torch.zeros(1, 8, 8, c, device="cuda").bfloat16(), w, b, w, b)


def test_resblock_kernel_raises_past_its_widest_channels(cuda):
    c = R.K2_MAX_CHANNELS + 8
    w, b = torch.zeros(3, 3, c, c, device="cuda"), torch.zeros(c, device="cuda")
    with pytest.raises(ValueError):
        R.fused_residual_block(torch.zeros(1, 8, 8, c, device="cuda").bfloat16(), w, b, w, b)
