"""Video Depth Anything in the port, on the CPU at a tiny size.

The tiny model (``vda_tiny_config``: a ViT 64 wide with 4 blocks, all four
captured; head features 64, so that GroupNorm's 32 groups hold 2 channels
each; input 28, so that 40x60 frames run at 28x42, a 2x3 grid) keeps the
real window of 32 frames and the real ``KEYFRAMES``. Its weights are the
benchmark's seeded ones in upstream's module layout
(``portbench/weights_vda.py``), through the port's converter
(``ckpt/convert_vda.py``), and the port is held against the benchmark's
plain reference (``portbench/reference/video_depth_anything.py``), which
shares no code with it.

Tolerances, each with its reason:

- ``FP32_REL`` 1e-4, the window's output in fp32 (L2 over the reference's
  L2): the two compute the same products in other orders (the transposed
  convs as matmuls, the position table in fp64, K1's plain path); measured
  6e-7. The port in bf16 lies ~8e-3 away, so a bf16 run fails it.
- ``POS_REL`` 1e-5 of the table's largest entry, the interpolated position
  table: ``F.interpolate`` computes its bicubic source coordinates in fp32,
  the port in fp64 (measured 3e-6 at 37x66).
- ``STITCH_REL`` 1e-5, stitching against upstream's loop transcribed in
  numpy: upstream sums its least-squares terms in fp32 numpy, the port in
  fp64 on the device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu_torch.ckpt import convert_vda
from ml_depth_pro_video_tpu_torch.core.precision import Precision
from ml_depth_pro_video_tpu_torch.models import video_depth_anything as vda
from ml_depth_pro_video_tpu_torch.models.vit import (GridViTConfig, ViTConfig,
                                                      interpolate_pos_embed)
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from portbench.frames import make_frames
from portbench.reference import video_depth_anything as ref
from portbench.weights_vda import layout, make_weights

FP32_REL = 1e-4
POS_REL = 1e-5
STITCH_REL = 1e-5
SEED = 2 ** 31 + 77
FRAME_HW = (40, 60)
CFG = vda.vda_tiny_config()
ARCH = ref.Arch(patch_size=14, embed_dim=64, depth=4, num_heads=2, mlp_ratio=2,
                pretrain_size=28, hooks=(0, 1, 2, 3), features=64, out_channels=(32, 64, 64, 64),
                head_features_2=8, input_size=28, frame_hw=FRAME_HW)


@pytest.fixture(scope="module")
def sd():
    return make_weights(ARCH, SEED, "cpu")


@pytest.fixture(scope="module")
def model(sd):
    return vda.VideoDepthAnything(convert_vda.convert_video_depth_anything(sd, CFG), CFG)


@pytest.fixture(scope="module")
def pool():
    return make_frames(40, *FRAME_HW, SEED, "cpu")


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).norm() / b.norm()).item()


def _port_window(model, frames, precision=Precision.fp32()):
    x = vda.preprocess(torch.as_tensor(frames), vda.net_hw(FRAME_HW, CFG.input_size))
    out = model.window_forward(x, precision)
    return vda.resize_ac(out[..., None], FRAME_HW)[..., 0]


@pytest.fixture(scope="module")
def window0(sd, model, pool):
    frames = torch.from_numpy(pool[:32])
    return frames, ref.infer_window(sd, frames, ARCH, torch.float32)


def test_tiny_shapes_are_the_issue_s():
    assert vda.net_hw(FRAME_HW, CFG.input_size) == (28, 42)
    assert vda.net_hw((1080, 1920)) == ref.net_hw((1080, 1920)) == (518, 924)
    assert ref.Arch().tokens == 2443 and ref.Arch().grid_hw == (37, 66)
    assert CFG.window == 32 and CFG.keyframes == vda.KEYFRAMES and CFG.step == 22


def test_upstream_layout_is_the_benchmark_s(sd):
    got = {k: tuple(s) for k, (s, _) in convert_vda.upstream_layout(CFG).items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    assert {k: s for k, (s, _) in layout(ARCH).items()} == {k: s for k, (s, _) in
                                                           convert_vda.upstream_layout(CFG).items()}


def test_converter_refuses_an_unknown_key(sd):
    with pytest.raises(ValueError, match="not consumed"):
        convert_vda.convert_video_depth_anything({**sd, "head.extra.weight": torch.zeros(1)}, CFG)


def test_window_forward_matches_the_reference_in_fp32(model, window0):
    frames, want = window0
    assert _rel(_port_window(model, frames), want) < FP32_REL
    assert (want > 0).float().mean() > 0.9  # the final ReLUs are open: every layer reaches it


def test_a_bf16_window_fails_the_fp32_tolerance(model, window0):
    frames, want = window0
    got = _port_window(model, frames, Precision.bf16())
    assert FP32_REL * 10 < _rel(got, want) < 0.05


@pytest.mark.parametrize("grid", [(2, 3), (3, 2), (37, 66)])
def test_position_table_matches_f_interpolate(grid):
    pos = torch.randn((1, 37 * 37 + 1, 16), generator=torch.Generator().manual_seed(3))
    got = interpolate_pos_embed(pos, grid)
    want = ref.pos_table({"pretrained.pos_embed": pos}, grid)
    assert got.shape == want.shape == (1, grid[0] * grid[1] + 1, 16)
    assert (got - want).abs().max() <= POS_REL * want.abs().max()
    assert torch.equal(got[:, 0], pos[:, 0])


def test_vit_grid_is_square_unless_told():
    assert ViTConfig().grid_hw == (24, 24) and ViTConfig().num_tokens == 577
    vit = GridViTConfig(**dataclasses.asdict(vda.VDA_LARGE.vit), img_hw=(518, 924))
    assert vit.grid_hw == (37, 66) and vit.num_tokens == 2443 and vit.grid_size == 37


def _runner(sd, stitch, **kw):
    params = convert_vda.convert_video_depth_anything(sd, CFG)
    return DepthVideoRunner(cfg=CFG, precision="fp32", device="cpu", params=params,
                            stitch=stitch, decode_workers=1, **kw)


@pytest.fixture(scope="module")
def raw_stream(sd, pool):
    frames = [pool[i % len(pool)] for i in range(32 + 3 * 22)]
    return frames, list(_runner(sd, False).depth_stream(frames))


def test_runner_positions_follow_window_frames(raw_stream):
    frames, got = raw_stream
    assert len(got) == len(frames)
    seen = []
    for out in got:
        w, p = out["window"], out["position"]
        index = ref.window_frames(w)[p]
        assert np.array_equal(out["image"], frames[index])
        assert p >= (0 if w == 0 else CFG.overlap)
        seen.append(index)
    assert seen == list(range(len(frames)))  # in order, once each
    assert [o["window"] for o in got][-1] == 3


def test_runner_windows_match_the_reference(sd, raw_stream):
    frames, got = raw_stream
    w = 2
    inputs = torch.from_numpy(np.stack([frames[i] for i in ref.window_frames(w)]))
    want = ref.infer_window(sd, inputs, ARCH, torch.float32)
    mine = [o for o in got if o["window"] == w]
    assert len(mine) == CFG.step
    for out in mine:
        assert _rel(out["inverse_depth"], want[out["position"]]) < FP32_REL


def _stitch_chain(raws, last_index):
    state, frames = None, []
    for i, raw in enumerate(raws):
        state, done, _ = vda.stitch_window(state, raw, CFG, last=i == last_index)
        frames.extend(done)
    return frames


def test_stitching_matches_upstream_loop():
    gen = torch.Generator().manual_seed(5)
    raws = [torch.rand((32, 6, 9), generator=gen) * 3 + 0.5 * w for w in range(4)]
    want = ref.stitch([r.numpy() for r in raws], ARCH)
    got = _stitch_chain(raws, 3)
    assert len(got) == len(want) == 32 + 3 * 22
    for g, w in zip(got, want):
        assert _rel(g, w) < STITCH_REL


@pytest.mark.parametrize("n", [20, 30, 54, 80])
def test_stitched_stream_is_upstream_s(sd, model, pool, n):
    """The runner with ``stitch=True`` against upstream's whole loop: the
    windows it would run (a window starts at every multiple of 22 inside
    the stream, past its end the last frame repeats) through the port's
    forward, stitched by the numpy transcription."""
    frames = [pool[i % len(pool)] for i in range(n)]
    got = list(_runner(sd, True).depth_stream(frames))
    raws = []
    for w in range(-(-n // CFG.step)):
        idx = [min(i, n - 1) for i in ref.window_frames(w)]
        raws.append(_port_window(model, np.stack([frames[i] for i in idx])).numpy())
    want = ref.stitch(raws, ARCH)[:n]
    assert [np.array_equal(o["image"], f) for o, f in zip(got, frames)] == [True] * n
    for g, w in zip(got, want):
        assert _rel(g["inverse_depth"], w) < FP32_REL


def _wrong_axis(monkeypatch):
    apply = vda.temporal_apply

    def along_rows(p, x, *a):
        return apply(p, x.permute(1, 0, 2, 3), *a).permute(1, 0, 2, 3)

    monkeypatch.setattr(vda, "temporal_apply", along_rows)


def test_attention_along_the_wrong_axis_changes_the_answer(model, window0, monkeypatch):
    frames, want = window0
    _wrong_axis(monkeypatch)
    assert _rel(_port_window(model, frames), want) > 100 * FP32_REL


def test_a_wrong_keyframe_changes_the_answer(sd, raw_stream):
    frames, got = raw_stream
    wrong = dataclasses.replace(CFG, keyframes=(1,) + CFG.keyframes[1:])
    params = convert_vda.convert_video_depth_anything(sd, wrong)
    runner = DepthVideoRunner(cfg=wrong, precision="fp32", device="cpu", params=params,
                              stitch=False, decode_workers=1)
    bad = {(o["window"], o["position"]): o["inverse_depth"] for o in runner.depth_stream(frames)}
    for out in got:
        if out["window"] >= 1:
            assert _rel(bad[(out["window"], out["position"])], out["inverse_depth"]) > (
                100 * FP32_REL)


def test_counters_count_windows_and_frames(sd, pool):
    before = dict(vda.COUNTERS)
    list(_runner(sd, False).depth_stream([pool[i % 40] for i in range(54)]))
    got = {k: vda.COUNTERS[k] - before[k] for k in before}
    assert got == {"windows": 2, "frames_new": 54, "frames_carried": 10, "temporal_k1": 0}


def test_spans_mark_a_window_s_launches(sd, pool, tmp_path):
    import json

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = list(_runner(sd, False).depth_stream([pool[i % 40] for i in range(54)]))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = {e.get("name") for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert len(got) == 54
    for w in (0, 1):
        for span in ("vda.encode", "vda.temporal", "vda.head", "depth_stream.stage",
                     "depth_stream.launch", "depth_stream.collect"):
            assert f"{span}#{w}" in names, (span, w)


@pytest.mark.parametrize("kw", [{"speed": "fast"}, {"temporal_smooth": 0.5},
                                {"fetch_pack": "u16"}])
def test_runner_refuses_what_vda_does_not_run(sd, kw):
    with pytest.raises(ValueError, match="Video Depth Anything"):
        _runner(sd, True, **kw)


def test_quantized_runner_takes_int8_vit_weights(sd):
    params = convert_vda.convert_video_depth_anything(sd, CFG)
    runner = DepthVideoRunner(cfg=CFG, precision="fp32", device="cpu", params=params,
                              quantize=True)
    assert runner.params["vit"]["blocks"]["qkv_w"]["q"].dtype == torch.int8
    assert isinstance(runner.params["head"]["temporal"][0]["attn"][0]["qkv_w"], torch.Tensor)


def test_maps_cli_writes_relative_inverse_depth(tmp_path):
    from PIL import Image

    from ml_depth_pro_video_tpu_torch.cli import generate_depth_maps as maps

    frames = make_frames(30, *FRAME_HW, SEED, "cpu")
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(src / f"f{i:03d}.png")
    maps.main([str(src), "-o", str(tmp_path / "out"), "--model", "vda_tiny", "--device", "cpu",
               "--save_npz"])
    pngs = sorted((tmp_path / "out").glob("*_depth.png"))
    npzs = sorted((tmp_path / "out").glob("*_depth.npz"))
    assert len(pngs) == len(npzs) == 30
    inv = np.load(npzs[-1])["inverse_depth"]
    assert inv.shape == FRAME_HW and np.isfinite(inv).all() and (inv >= 0).all()
