"""The yardstick of ``chip_smoke.py`` (``attention_flops``, ``nbytes``,
``bound``, ``median_ms``), pinned on the CPU at the shapes whose bounds
``PERF.md`` quotes, so that the documented bounds cannot drift from the code
that prints them. Shapes only: the tensors live on the ``meta`` device. And
the ``maps`` phase's arithmetic: the share of pixels outside the packed
bound, the host-twin reference and its blended share, the noisy frames.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ml_depth_pro_video_tpu_torch.video.temporal import _update_core_np


def _packed(b, s, heads, hd, dtype, with_bias):
    qkv = torch.empty((b, s, 3 * heads * hd), dtype=dtype, device="meta")
    out = torch.empty((b, s, heads * hd), dtype=dtype, device="meta")
    bias = [torch.empty((b, s), dtype=torch.float32, device="meta")] if with_bias else []
    return chip_smoke.nbytes(qkv, out, *bias)


# K1 at the exact path's batch-2 shape in both dtypes, at the image ViT's shape, and K3 at
# the balanced and fast tiers' shapes: (B, S, with a bias, dtype) -> bound in ms, bound by
@pytest.mark.parametrize("b,s,with_bias,dtype,want_ms,want_by", [
    (70, 577, False, torch.bfloat16, 0.0988, "bytes"),
    (70, 577, False, torch.float32, 1.4247, "operations"),
    (2, 577, False, torch.bfloat16, 0.0028, "bytes"),
    (70, 433, True, torch.bfloat16, 0.0742, "bytes"),
    (70, 289, True, torch.bfloat16, 0.0495, "bytes"),
    (70, 433, True, torch.float32, 0.8023, "operations"),
])
def test_attention_bound_at_the_documented_shapes(b, s, with_bias, dtype, want_ms, want_by):
    flops = chip_smoke.attention_flops(b, 16, s, 64)
    assert flops == 4.0 * b * 16 * s * s * 64
    ms, by = chip_smoke.bound(flops, _packed(b, s, 16, 64, dtype, with_bias), dtype)
    assert by == want_by
    assert round(ms, 4) == want_ms


# K2 at the decoder's levels at batch 2: 48^2 and 96^2 run K2, 192^2 and 384^2 are the width
# gate's evidence; bf16 x and out, fp32 weights and biases as chip_smoke makes them
@pytest.mark.parametrize("hw,want_ms", [(48, 0.0110), (96, 0.0440), (192, 0.1759),
                                        (384, 0.7035)])
def test_resblock_bound_at_the_documented_shapes(hw, want_ms):
    b, c = 2, 256
    x, out = (torch.empty((b, hw, hw, c), dtype=torch.bfloat16, device="meta") for _ in range(2))
    w = torch.empty((3, 3, c, c), device="meta")
    bias = torch.empty((c,), device="meta")
    flops = chip_smoke.resblock_flops(b, hw, hw, c)
    assert flops == 2 * 2.0 * b * hw * hw * 9 * c * c
    ms, by = chip_smoke.bound(flops, chip_smoke.nbytes(x, w, bias, w, bias, out), torch.bfloat16)
    assert by == "operations"
    assert round(ms, 4) == want_ms


def test_unpacked_attention_moves_the_same_bytes_as_packed():
    """K4 reads q, k, v and writes out of (B, H, S, D): K1's bytes, so K1's bound."""
    qkvo = [torch.empty((70, 16, 577, 64), dtype=torch.bfloat16, device="meta")] * 4
    assert chip_smoke.nbytes(*qkvo) == _packed(70, 577, 16, 64, torch.bfloat16, False)


def test_median_takes_more_events_for_a_short_kernel(monkeypatch):
    """Under ``short_ms`` the median is over ``short_iters`` event pairs, not
    ``iters``; each pair brackets ``calls`` back-to-back calls."""
    made = []

    class Event:
        def __init__(self, enable_timing):
            made.append(self)

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return Event.ms

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    for ms, events in ((0.05, 2 * (20 + 100)), (0.5, 2 * 20)):  # per call
        Event.ms = 5 * ms
        made.clear()
        calls.clear()
        assert chip_smoke.median_ms(lambda: calls.append(1), calls=5) == pytest.approx(ms)
        assert len(made) == events
        assert len(calls) == 3 + 5 * events // 2  # three warm-up calls


def test_outside_bound_counts_the_pixels_above_it():
    want = np.full((2, 10, 10), 4.0)
    got = want.copy().astype(np.float32)
    got[0, 0, 0] = 4.0 * (1 + 2e-4)   # above a 1.5e-4 bound
    got[1, 5, 5] = 4.0 * (1 - 1e-4)   # inside it
    share, worst = chip_smoke.outside_bound(got, want, 1.5e-4)
    assert share == pytest.approx(1 / 200)
    assert worst == pytest.approx(2e-4, rel=1e-3)
    assert chip_smoke.outside_bound(want, want, 0.0) == (0.0, 0.0)


def test_smoothed_reference_is_the_host_twin_in_order_and_counts_the_blend():
    """The first frame seeds and passes; later frames are the host twin's output
    chained in order; the blended share is 0 for a moving scene and near 1 for
    a static one."""
    rng = np.random.default_rng(0)
    base = (2.0 + rng.random((16, 20))).astype(np.float32)
    static = [(base * (1 + 0.001 * rng.standard_normal(base.shape))).astype(np.float32)
              for _ in range(3)]
    out, blended = chip_smoke.smoothed_reference(static)
    np.testing.assert_array_equal(out[0], static[0])
    state = static[0]
    for got, d in zip(out[1:], static[1:]):
        state, _ = _update_core_np(state, d, alpha=chip_smoke.SMOOTH_ALPHA, tau=0.05, align=True)
        np.testing.assert_array_equal(got, state)
    assert blended > 0.99
    moving = [base, base * 3.0, base * 9.0]  # every pixel changes by far more than tau
    assert chip_smoke.smoothed_reference(moving)[1] == 0.0


def test_noisy_frames_stay_within_three_levels_of_one_base():
    frames = chip_smoke.noisy_frames(3, np.random.default_rng(1))
    assert len(frames) == 3 and all(f.shape == (1080, 1920, 3) and f.dtype == np.uint8
                                    for f in frames)
    spread = np.ptp(np.stack(frames).astype(np.int16), axis=0)
    assert spread.max() <= 6
