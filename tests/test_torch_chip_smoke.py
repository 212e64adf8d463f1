"""The yardstick of ``chip_smoke.py`` (``attention_flops``, ``nbytes``,
``bound``, ``median_ms``), pinned on the CPU at the shapes whose bounds
``PERF.md`` quotes, so that the documented bounds cannot drift from the code
that prints them. Shapes only: the tensors live on the ``meta`` device.
"""

import pytest
import torch

import chip_smoke


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
