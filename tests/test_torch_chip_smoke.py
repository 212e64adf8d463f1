"""The yardstick of ``chip_smoke.py`` (``attention_flops``, ``nbytes``,
``bound``, ``median_ms``), pinned on the CPU at the shapes whose bounds
``PERF.md`` quotes, so that the documented bounds cannot drift from the code
that prints them. Shapes only: the tensors live on the ``meta`` device. And
the ``maps`` phase's arithmetic: the share of pixels outside the packed
bound, the host-twin reference and its blended share, the noisy frames. And
the on-card geometry phases' CPU side: the structured scene, the host
filters' keep masks, the floor-plan checks run with the CPU on both sides at
a small size, and the launches the device pipeline and the effect expect.
And the ``serve`` and ``quantize`` phases' arithmetic: the bytes the int8
ViTs save, the launches per forward from ``/metrics``' batch count, the
latency percentiles and the count of processes started. And the ``train``
and ``export`` phases' launches per step and per forward, counted on meta
tensors, and the gradient and state comparisons. And the ``parallel``
phase's arithmetic: the patch split, the band rows and cuts, the kernel
shapes it holds, and the deviation that tells a halo error from rounding.
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
    (18, 577, False, torch.bfloat16, 0.0254, "bytes"),  # the latency slice over 2 ranks
    (18, 289, True, torch.bfloat16, 0.0127, "bytes"),
    (35, 577, False, torch.bfloat16, 0.0494, "bytes"),  # dp=2 at batch 2: a row per rank
    (14, 577, False, torch.bfloat16, 0.0198, "bytes"),  # a pp microbatch: 70 patch rows / 5
])
def test_attention_bound_at_the_documented_shapes(b, s, with_bias, dtype, want_ms, want_by):
    flops = chip_smoke.attention_flops(b, 16, s, 64)
    assert flops == 4.0 * b * 16 * s * s * 64
    ms, by = chip_smoke.bound(flops, _packed(b, s, 16, 64, dtype, with_bias), dtype)
    assert by == want_by
    assert round(ms, 4) == want_ms


def test_attention_bound_on_the_tp_local_heads():
    """tp=2: each rank's 8 of the 16 heads at the patch ViT's 70 rows, (70, 577, 1536)."""
    ms, by = chip_smoke.bound(chip_smoke.attention_flops(70, 8, 577, 64),
                              _packed(70, 577, 8, 64, torch.bfloat16, False), torch.bfloat16)
    assert (round(ms, 4), by) == (0.0494, "bytes")


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


# K2 on the latency path's bands plus halo over 2 ranks, batch 1
@pytest.mark.parametrize("shape,want_ms", [((1, 26, 48, 256), 0.0030),
                                           ((1, 50, 96, 256), 0.0115)])
def test_resblock_bound_on_the_latency_bands(shape, want_ms):
    c = shape[-1]
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, c, c), device="meta")
    bias = torch.empty((c,), device="meta")
    ms, by = chip_smoke.bound(chip_smoke.resblock_flops(*shape),
                              chip_smoke.nbytes(x, w, bias, w, bias, x), torch.bfloat16)
    assert by == "operations"
    assert round(ms, 4) == want_ms


def test_unpacked_attention_moves_the_same_bytes_as_packed():
    """K4 reads q, k, v and writes out of (B, H, S, D): K1's bytes, so K1's bound."""
    qkvo = [torch.empty((70, 16, 577, 64), dtype=torch.bfloat16, device="meta")] * 4
    assert chip_smoke.nbytes(*qkvo) == _packed(70, 577, 16, 64, torch.bfloat16, False)


@pytest.mark.parametrize("readings,want", [([0.0, 0.25], 0.25), ([0.5], 0.5),
                                           ([0.0, 0.0, 0.0], None)])
def test_device_ms_retakes_a_profile_with_no_kernel_time(monkeypatch, readings, want):
    """A profile whose kernels sum to no time is taken again; three such
    profiles raise instead of giving 0 ms, which a ratio would divide by."""
    left = iter(readings)
    monkeypatch.setattr(chip_smoke, "kernel_times",
                        lambda fn, calls: [("k", next(left) / 2), ("k2", 0.0)] * 2)
    if want is None:
        with pytest.raises(RuntimeError, match="no kernel time in 3 profiles"):
            chip_smoke.device_ms(lambda: None)
    else:
        assert chip_smoke.device_ms(lambda: None) == want


@pytest.mark.parametrize("want,bias,got,ulps", [
    (1.0, 0.0, 1.0 + 2.0 ** -7, 1.0),  # one ulp at 1 is 2^-7
    (1.5, 0.0, 1.5 - 2.0 ** -6, 2.0),
    (0.0078125, 0.5, 0.0078125 + 2.0 ** -8, 1.0),  # the bias's ulp (2^-8) where it is larger
    (-3.0, 0.0, -3.0, 0.0),
])
def test_bf16_ulps_counts_at_the_larger_of_output_and_bias(want, bias, got, ulps):
    t = lambda v: torch.tensor([v, 2.0])  # noqa: E731
    assert chip_smoke.bf16_ulps(t(got), t(want), torch.tensor([bias, 0.0])) == ulps


def test_attention_entries_name_their_body_and_tile():
    """The fields each K1, K3 and K4 line and JSON entry carries: the body the
    call took and its tile, queries per block x keys per tile."""
    assert chip_smoke.body_fields("wgmma", 128) == {"body": "wgmma", "tile": "128x64"}
    assert chip_smoke.body_fields("mma.sync", 64) == {"body": "mma.sync", "tile": "64x64"}


@pytest.mark.parametrize("body,hd,dtype,fails", [("wgmma", 64, torch.bfloat16, False),
                                                 ("mma.sync", 64, torch.bfloat16, True),
                                                 ("mma.sync", 32, torch.bfloat16, False),
                                                 ("fp32", 64, torch.float32, False)])
def test_bf16_head_dim_64_must_take_the_wgmma_body(monkeypatch, body, hd, dtype, fails):
    monkeypatch.setattr(chip_smoke, "attention_body", lambda *args: (body, 128))
    if fails:
        with pytest.raises(AssertionError, match="not wgmma"):
            chip_smoke.attention_body_checked(70, 433, 16, hd, dtype, "K3")
    else:
        assert chip_smoke.attention_body_checked(70, 433, 16, hd, dtype, "K3") == {
            "body": body, "tile": "128x64"}


@pytest.mark.parametrize("shape,body,fails", [((2, 96, 96, 256), "wgmma", False),
                                              ((2, 48, 48, 256), "mma.sync", True),
                                              ((1, 20, 24, 64), "mma.sync", False)])
def test_k2_at_256_channels_must_take_the_wgmma_body(monkeypatch, shape, body, fails):
    """Every model shape of K2 (256 channels) must take its wgmma body; other
    widths may take the mma.sync body; each K2 line and entry names its body and tile."""
    monkeypatch.setattr(chip_smoke, "k2_body", lambda *args: (body, (6, 14)))
    if fails:
        with pytest.raises(AssertionError, match="not wgmma"):
            chip_smoke.k2_body_checked(shape)
    else:
        assert chip_smoke.k2_body_checked(shape) == {"body": body, "tile": "6x14"}


_SASS = """
	code for sm_90a
		Function : _ZN19depth_pro_attention12_GLOBAL__N_122attention_wgmma_kernelILi2EEEvS1_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0b40*/              @!P0 UTMALDG.4D [UR8], [UR16] ;      /* 0x000000080800 */
        /*0b50*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
		Function : _ZN12_GLOBAL__N_121attention_bf16_kernelILi64ELb1ELi2EEEvNS_4ArgsI13__nv_bfloat16EE
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0020*/              @UP0 HMMA.16816.F32.BF16 R8, R4, R14, R8 ;
"""


def _instances(kernel, n, **counts):
    ops = {"HGMMA": 8, "UTMALDG": 3, "HMMA": 0, "LDSM": 0, **counts}
    return {f"_ZN{kernel}ILi{i}EE": dict(ops) for i in range(n)}


def test_wgmma_sass_check_takes_every_hopper_instance():
    """The SASS check's names: K1, K3 and K4's four instances (two block sizes,
    with and without a bias) and K2's two tiles, each with HGMMA and UTMALDG
    and without HMMA."""
    assert chip_smoke.WGMMA_KERNELS == {"attention_wgmma_kernel": 4, "resblock_wgmma_kernel": 2}
    good = {**_instances("attention_wgmma_kernel", 4), **_instances("resblock_wgmma_kernel", 2),
            **_instances("attention_bf16_kernel", 3, HGMMA=0, UTMALDG=0, HMMA=16)}
    chip_smoke.check_wgmma_sass(good)


@pytest.mark.parametrize("kernel,n,counts", [
    ("attention_wgmma_kernel", 2, {}),                 # the bias instances missing
    ("attention_wgmma_kernel", 4, {"HMMA": 2}),        # mma.sync inside the wgmma body
    ("resblock_wgmma_kernel", 2, {"UTMALDG": 0}),      # K2's weights not loaded by TMA
    ("resblock_wgmma_kernel", 2, {"HGMMA": 0}),        # K2 not on wgmma
    ("resblock_wgmma_kernel", 1, {}),                  # a tile missing
])
def test_wgmma_sass_check_fails_on_a_missing_or_wrong_instance(kernel, n, counts):
    other = ("resblock_wgmma_kernel" if kernel == "attention_wgmma_kernel"
             else "attention_wgmma_kernel")
    sass = {**_instances(kernel, n, **counts),
            **_instances(other, chip_smoke.WGMMA_KERNELS[other])}
    with pytest.raises(AssertionError):
        chip_smoke.check_wgmma_sass(sass)


def test_sass_counts_read_each_function_s_opcodes():
    """``cuobjdump -sass`` output, counted per function: predicated
    instructions count, modifiers after the first dot do not matter."""
    counts = chip_smoke.sass_counts(_SASS)
    assert list(counts.values()) == [{"HGMMA": 2, "UTMALDG": 1, "HMMA": 0, "LDSM": 0},
                                     {"HGMMA": 0, "UTMALDG": 0, "HMMA": 2, "LDSM": 1}]
    assert "attention_wgmma_kernel" in next(iter(counts))


def test_k4_equals_k1_at_the_model_shape_and_ragged_lengths():
    shapes = dict(chip_smoke.K4_EQUAL_SHAPES)
    assert shapes[(70, 577, 3072)] == 16
    ragged = [(b, heads) for (b, s, _), heads in shapes.items() if s != 577 and s % 64]
    # one grid of 128-query blocks (24 x 16 heads), one of 64-query blocks (2 x 2)
    assert sorted(ragged) == [(2, 2), (24, 16)]
    assert chip_smoke.K1_REPORT[(chip_smoke.BATCH, 577, 3072)] == "small_shape"


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


# the pipeline phase: frame 0 alone for the ground fit, then the rest at batch 2
@pytest.mark.parametrize("n_frames,batch,forwards", [(8, 2, 5), (1, 2, 1), (2, 2, 2), (3, 2, 2),
                                                     (9, 2, 5), (8, 1, 8), (8, 4, 3)])
def test_pipeline_forwards_count_the_frame_0_inference(n_frames, batch, forwards):
    assert chip_smoke.pipeline_forwards(n_frames, batch) == forwards


def test_pipeline_phase_expects_72_k1_and_3_k2_per_forward():
    forwards = chip_smoke.pipeline_forwards(chip_smoke.PIPELINE_FRAMES)
    assert forwards == 5
    want = {name: n * forwards for name, n in chip_smoke.PER_FORWARD["exact"].items()}
    assert want == {"K1": 360, "K2": 15, "K3": 0, "K4": 0, "K5": 1095}


def test_shape_flags_follow_scikit_learn(monkeypatch):
    import builtins

    flags, _ = chip_smoke.shape_flags()
    assert flags == ["--fit_shapes", "--output_main_only"]  # scikit-learn imports here
    real = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.split(".")[0] == "sklearn":
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    monkeypatch.delitem(__import__("sys").modules, "sklearn", raising=False)
    flags, why = chip_smoke.shape_flags()
    assert flags == ["--no_fit_shapes"] and "does not import" in why


def test_structured_scene_is_finite_and_of_the_frame_shape():
    scene = chip_smoke.structured_scene(90, 160, chip_smoke.SCENE_F_PX * 160 / 1920, 8)
    assert scene["image"].shape == (90, 160, 3) and scene["image"].dtype == np.uint8
    assert scene["depth"].shape == (90, 160) and scene["depth"].dtype == np.float32
    assert np.isfinite(scene["depth"]).all() and (scene["depth"] > 0).all()
    # a room a few metres deep, not the 136 m - 1e4 m of random weights
    assert 1.0 < scene["depth"].min() and scene["depth"].max() < 8.5
    assert len(np.unique(scene["image"].reshape(-1, 3), axis=0)) >= 4  # floor, wall, boxes


def test_host_keep_follows_each_point_through_the_filter():
    from ml_depth_pro_video_tpu_torch.geom.pointcloud import PointCloud

    points = np.random.default_rng(0).random((50, 3))
    drop = points[:, 1] > 0.5

    def keep_low(cloud):
        return PointCloud(cloud.points[::-1][~drop[::-1]], cloud.colors[::-1][~drop[::-1]])

    np.testing.assert_array_equal(chip_smoke.host_keep(keep_low, points), ~drop)


def test_floorplan_checks_on_the_cpu():
    """The device_floorplan phase's checks with the CPU in the card's place, at
    270x480: the two sides agree exactly and the host-chain gates pass."""
    from ml_depth_pro_video_tpu_torch.video import pipeline

    scene = chip_smoke.structured_scene(270, 480, chip_smoke.SCENE_F_PX / 4, chip_smoke.SEED + 8)
    ground = pipeline.compute_ground_from_frame(scene["depth"], scene["f_px"])
    r, cfg = chip_smoke.check_device_floorplan(scene, ground, "cpu")
    assert r["coord_err"] == 0 and r["raster_share"] == 0
    assert r["valid_share"] == r["keep_stray_share"] == r["keep_share"] == 0
    assert r["stray_dropped"] == 0 and r["stray_extra"] < chip_smoke.STRAY_EXTRA
    assert cfg.raster_width == 1024 and cfg.height == 270


def test_device_pipeline_and_effect_expect_the_exact_launches():
    """pipeline_device: frame 0 alone for the ground fit, then 7 frames in 4
    batches; effect: one forward per image, the parallax PNG and the anaglyph."""
    forwards = chip_smoke.pipeline_forwards(chip_smoke.PIPELINE_FRAMES)
    assert {k: n * forwards for k, n in chip_smoke.PER_FORWARD["exact"].items()} == {
        "K1": 360, "K2": 15, "K3": 0, "K4": 0, "K5": 1095}
    assert {k: n * 2 for k, n in chip_smoke.PER_FORWARD["exact"].items()} == {
        "K1": 144, "K2": 6, "K3": 0, "K4": 0, "K5": 438}
    duration, fps = chip_smoke.EFFECT_FRAMES
    assert int(duration * fps) == 8


def test_quantized_saving_is_the_vit_matmuls_at_a_quarter_of_their_bytes():
    """The large preset: 24 blocks x (1024*3072 + 1024*1024 + 2*1024*4096) = 302 M weights per
    ViT with 24 x 9216 scales; three ViTs save 3 of every 4 bytes, less the scales."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import model_preset

    large = model_preset("large")
    assert chip_smoke.vit_matmul_params(large.vit) == (301_989_888, 221_184)
    assert chip_smoke.quantized_saving(large) == 3 * (3 * 301_989_888 - 4 * 221_184)
    assert chip_smoke.quantized_saving(large) == 2_715_254_784  # 2.715 GB


@pytest.mark.parametrize("use_fov_head", [True, False])
def test_quantized_saving_matches_a_quantized_tiny_model(use_fov_head):
    """The prediction equals the parameter bytes two tiny models hold, fp32
    against int8 ViTs (with and without the FOV ViT)."""
    from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro
    from ml_depth_pro_video_tpu_torch.ckpt.quantize import quantize_vit_weights
    from ml_depth_pro_video_tpu_torch.models.depth_pro import DepthProModel, tiny_config

    cfg = tiny_config(use_fov_head=use_fov_head)
    tree = init_depth_pro(cfg, torch.Generator().manual_seed(0))
    held = [sum(chip_smoke.nbytes(p) for p in DepthProModel(t, cfg).parameters())
            for t in (tree, quantize_vit_weights(tree))]
    assert held[0] - held[1] == chip_smoke.quantized_saving(cfg)


def test_serve_launches_per_forward_come_from_the_batches_metrics_counts():
    """The serve phase's forwards are /metrics' depthpro_batches_total: each
    batch is one forward of 72 K1 and 3 K2, whatever its fill."""
    from ml_depth_pro_video_tpu_torch.serve.server import _Metrics

    m = _Metrics()
    for size in (1, 4, 4, 2, 1):
        m.record_batch(size)
    for _ in range(12):
        m.record_request(0.3, error=False)
    metrics = chip_smoke.parse_metrics(m.render(chip_smoke.SERVE_BATCH))
    forwards = int(metrics["depthpro_batches_total"])
    assert forwards == 5 and metrics["depthpro_requests_total"] == 12
    assert metrics["depthpro_batch_fill_ratio"] == pytest.approx(12 / 20)
    want = {k: n * forwards for k, n in chip_smoke.PER_FORWARD["exact"].items()}
    assert want == {"K1": 360, "K2": 15, "K3": 0, "K4": 0, "K5": 1095}
    # the phase's own count of requests: lone, concurrent, npz, png16, the session stream twice
    sent = chip_smoke.SERVE_LONE + chip_smoke.SERVE_REQUESTS + 2 + 2 * chip_smoke.SERVE_SESSION
    assert sent == 50


def test_percentiles_interpolate_linearly():
    assert chip_smoke.percentiles([1.0, 2.0, 3.0, 4.0, 5.0]) == (3.0, pytest.approx(4.8))
    assert chip_smoke.percentiles([0.25]) == (0.25, 0.25)


def test_count_process_starts_counts_spawned_processes_only(monkeypatch):
    import multiprocessing
    import os
    from concurrent.futures import ThreadPoolExecutor
    from multiprocessing import resource_tracker

    def threads():
        with ThreadPoolExecutor(2) as ex:
            return sum(ex.map(abs, [-1, -2]))

    assert chip_smoke.count_process_starts(threads) == (3, 0)
    resource_tracker.ensure_running()

    def one_process():
        p = multiprocessing.get_context("spawn").Process(target=os.getpid)
        p.start()
        p.join(60)
        return p.exitcode

    assert chip_smoke.count_process_starts(one_process) == (0, 1)
    # the resource tracker counts once, when it starts during the call
    tracker = resource_tracker._resource_tracker
    pid = tracker._pid
    monkeypatch.setattr(tracker, "_pid", None)
    assert chip_smoke.count_process_starts(lambda: setattr(tracker, "_pid", pid)) == (None, 1)


def _count_k5(patch) -> dict:
    """Count K5's calls (the ViT's ``add_layer_norm`` and ``layer_norm``, the
    pipeline's final norm) and the ViT blocks run, through the names the
    model code looks up; ``patch(module, name, fn)`` installs each counter.
    On meta tensors the calls take the plain composition; on the card each
    is one K5 launch."""
    from ml_depth_pro_video_tpu_torch.models import vit as vit_module
    from ml_depth_pro_video_tpu_torch.parallel import pipeline

    counts = {"K5": 0, "blocks": 0}

    def counted(fn, key):
        def call(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return call

    for module, name, key in ((vit_module, "add_layer_norm", "K5"),
                              (vit_module, "layer_norm", "K5"), (pipeline, "layer_norm", "K5"),
                              (vit_module, "_block", "blocks")):
        patch(module, name, counted(getattr(module, name), key))
    return counts


def _launches_per_forward(cfg, batch=2):
    """K1 / K3 / K2 / K5 calls of one bf16 forward without the FOV head, and
    the ViT blocks run, counted on meta tensors (shapes only) through the
    names the model code looks up."""
    from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro
    from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
    from ml_depth_pro_video_tpu_torch.models import vit as vit_module
    from ml_depth_pro_video_tpu_torch.ops import resblock
    from ml_depth_pro_video_tpu_torch.core.precision import Precision

    counts = {"K1": 0, "K2": 0, "K3": 0}
    real_attn = vit_module.attention_packed

    def attn(qkv, heads, key_bias=None):
        counts["K1" if key_bias is None else "K3"] += 1
        return real_attn(qkv, heads, key_bias)

    def fused(x, *args):
        counts["K2"] += 1
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vit_module, "attention_packed", attn)
        mp.setattr(resblock, "fused_residual_block", fused)
        k5 = _count_k5(mp.setattr)
        params = init_depth_pro(cfg, torch.Generator().manual_seed(0), "meta")
        x = torch.empty((batch, cfg.img_size, cfg.img_size, 3), device="meta")
        dp.forward(params, x, cfg, Precision.bf16(), compute_fov=False)
    return {**counts, **k5}


@pytest.mark.parametrize("name,per_step", [("large", "PER_TRAIN_STEP"),
                                           ("small", "PER_STUDENT_STEP")])
def test_train_phase_launches_per_step(name, per_step):
    """A training step runs the forward without the FOV head once and its ViT
    blocks again in the per-block recompute: twice the forward's K1, its K2
    once (the decoder's residual blocks are not recomputed), the forward's
    K5 and each block's 3 again (the final norm lies outside the recomputed
    blocks)."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import model_preset

    fwd = _launches_per_forward(model_preset(name))
    want = getattr(chip_smoke, per_step)
    assert want == {"K1": 2 * fwd["K1"], "K2": fwd["K2"], "K3": 0, "K4": 0,
                    "K5": fwd["K5"] + 3 * fwd["blocks"]}
    assert want["K1"] == 2 * 2 * model_preset(name).vit.depth and want["K2"] == 3


def test_export_cut_launches_per_forward():
    """The balanced artifact at 8 blocks: 2 exact patch-ViT blocks, the merge,
    6 with the size bias; 8 K1 each for the image and FOV ViTs."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import apply_speed

    cfg = apply_speed(chip_smoke.EXPORT_CUT, "balanced")
    assert cfg.vit.depth == 8 and cfg.vit.embed_dim == 1024 and cfg.img_size == 1536
    fwd = _launches_per_forward(cfg)
    fov = cfg.vit.depth  # the exported program derives f_px: the FOV ViT runs
    assert chip_smoke.EXPORT_CUT_PER_FORWARD == {"K1": fwd["K1"] + fov, "K2": fwd["K2"],
                                                 "K3": fwd["K3"], "K4": 0,
                                                 "K5": fwd["K5"] + 3 * fov + 1}


def test_grad_agreement_of_flattened_gradients():
    a = [torch.tensor([1.0, 0.0]), None, torch.tensor([[0.0]])]
    l2, cos = chip_smoke.grad_agreement(a, a)
    assert l2 == 0.0 and cos == pytest.approx(1.0)
    b = [torch.tensor([0.0, 1.0]), None, torch.tensor([[0.0]])]
    l2, cos = chip_smoke.grad_agreement(a, b)
    assert l2 == pytest.approx(2 ** 0.5) and cos == pytest.approx(0.0)
    with pytest.raises(AssertionError, match="different leaves"):
        chip_smoke.grad_agreement(a, [torch.zeros(2), torch.zeros(1), torch.zeros((1, 1))])


def test_conditioned_depth_leaves_out_the_ill_conditioned_pixels():
    depth = torch.tensor([[2.0, 3.0, 4.0, 5.0, 6.0]])
    a = torch.tensor([[0.5, 1e-3, 0.0, 1.0, 1e-6]])
    b = torch.tensor([[0.5004, 1.2e-3, 1e-3, 1.0, 1e-6]])
    # kept: within 1e-3 of the smaller value, above the clamp; left out: 20% apart, one run
    # at the ReLU's 0, one at the clamp
    got, left_out = chip_smoke.conditioned_depth(depth, [a, b], 1e-3)
    assert torch.equal(got, torch.tensor([[2.0, 0.0, 0.0, 5.0, 0.0]]))
    assert left_out == pytest.approx(0.6)
    got, left_out = chip_smoke.conditioned_depth(depth, [a, b, a], 0.25)
    assert torch.equal(got, torch.tensor([[2.0, 3.0, 0.0, 5.0, 0.0]]))
    assert left_out == pytest.approx(0.4)


def test_states_equal_compares_every_part():
    from ml_depth_pro_video_tpu_torch.train.step import TrainState, make_optimizer

    def state(step=3, bump=0.0):
        params = {"w": torch.ones(3) + bump}
        opt = make_optimizer(1e-3)
        return TrainState(params, opt.init(params), step)

    assert chip_smoke.states_equal(state(), state())
    assert not chip_smoke.states_equal(state(), state(bump=1e-7))
    assert not chip_smoke.states_equal(state(), state(step=4))
    s = state()
    s.opt_state.nu[0][0] = 1e-30
    assert not chip_smoke.states_equal(s, state())


def test_parallel_phase_patch_split_and_attention_shapes():
    """The latency path's padded patch split (35 patches over 2 ranks pad to
    36, B*35 over 3 to a multiple of 3) and each rank's attention launches per
    forward, whose sums are the one-device forward's."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import apply_speed, model_preset

    assert chip_smoke.patch_split(35, 2) == (36, 18)
    assert chip_smoke.patch_split(35, 3) == (36, 12) and chip_smoke.patch_split(70, 3) == (72, 24)
    large = model_preset("large")
    assert chip_smoke.latency_shapes(large, 2) == {"K1 18x577x3072": 24, "K1 1x577x3072": 48}
    assert chip_smoke.latency_shapes(large, 3, batch=2) == {"K1 24x577x3072": 24,
                                                            "K1 2x577x3072": 48}
    assert chip_smoke.latency_shapes(apply_speed(large, "fast"), 2) == {
        "K1 18x577x3072": 2, "K3 18x289x3072": 22, "K1 1x577x3072": 48}
    assert chip_smoke.latency_shapes(apply_speed(large, "balanced"), 2)["K3 18x433x3072"] == 22
    for speed in ("exact", "fast"):
        cfg = large if speed == "exact" else apply_speed(large, speed)
        shapes = chip_smoke.latency_shapes(cfg, 2)
        for kernel in ("K1", "K3"):
            assert sum(v for k, v in shapes.items() if k.startswith(kernel)) == \
                chip_smoke.PER_FORWARD[speed][kernel]


def test_parallel_phase_band_rows_per_decoder_level():
    """The 24 token-grid rows of the large preset split 12 / 12 over 2 ranks
    and 8 / 8 / 8 over 3; a level k grids high holds k times that; K2 runs on
    the two coarsest levels' bands plus two halo rows per neighbour."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import model_preset, tiny_config

    large = model_preset("large")
    assert chip_smoke.band_rows(large, 2) == [[24, 48, 96, 192, 384]] * 2
    assert chip_smoke.band_rows(large, 3) == [[16, 32, 64, 128, 256]] * 3
    assert chip_smoke.band_rows(tiny_config(), 3) == [[6, 12, 24, 48, 96]] * 2 + [
        [4, 8, 16, 32, 64]]
    assert chip_smoke.k2_band_shapes(large, 2, 0) == [(1, 26, 48, 256), (1, 50, 96, 256),
                                                      (1, 50, 96, 256)]
    assert chip_smoke.k2_band_shapes(large, 3, 1) == [(1, 20, 48, 256), (1, 36, 96, 256),
                                                      (1, 36, 96, 256)]


def test_latency_forward_launches_per_rank_on_meta(monkeypatch):
    """One latency forward of the large preset on rank 0 of 2, shapes only
    (meta tensors, the collectives stubbed to return pieces of the ranks'
    shapes): 24 K1 on the 18-patch slice, 24 on the image ViT's one patch
    (the FOV ViT is off here), 3 K2 on the bands plus halo."""
    from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro
    from ml_depth_pro_video_tpu_torch.core.precision import Precision
    from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
    from ml_depth_pro_video_tpu_torch.models import vit as vit_module
    from ml_depth_pro_video_tpu_torch.ops import resblock
    from ml_depth_pro_video_tpu_torch.parallel import latency
    from ml_depth_pro_video_tpu_torch.parallel import multihost as mh

    monkeypatch.setattr(mh, "world_size", lambda: 2)
    monkeypatch.setattr(mh, "rank", lambda: 0)
    monkeypatch.setattr(mh, "all_gather",
                        lambda t, shapes=None: [t.new_empty(s) for s in shapes or [t.shape] * 2])
    monkeypatch.setattr(mh, "exchange", lambda sends: {p: t.new_empty(t.shape)
                                                       for p, t in sends.items()})
    attn_shapes, k2 = {}, []
    real_attn = vit_module.attention_packed

    def attn(qkv, heads, key_bias=None):
        key = f"{'K1' if key_bias is None else 'K3'} {'x'.join(map(str, qkv.shape))}"
        attn_shapes[key] = attn_shapes.get(key, 0) + 1
        return real_attn(qkv, heads, key_bias)

    def fused(x, *args):
        k2.append(tuple(x.shape))
        return x

    monkeypatch.setattr(vit_module, "attention_packed", attn)
    monkeypatch.setattr(resblock, "fused_residual_block", fused)
    cfg = dp.model_preset("large")
    mesh = latency.make_sp_mesh()
    params = init_depth_pro(cfg, torch.Generator().manual_seed(0), "meta")
    x = torch.empty((1, cfg.img_size, cfg.img_size, 3), device="meta")
    canonical, _ = dp.forward(params, x, cfg, Precision.bf16(), compute_fov=False,
                              patch_vit_fn=latency._sharded_patch_vit(mesh, cfg, Precision.bf16()),
                              rows=latency.RowBands(cfg.vit.grid_size, mesh))
    assert tuple(canonical.shape) == (1, cfg.img_size, cfg.img_size, 1)
    assert attn_shapes == {"K1 18x577x3072": 24, "K1 1x577x3072": 24}
    assert k2 == chip_smoke.k2_band_shapes(cfg, 2, 0)


def test_kernel_shapes_cover_the_parallel_path():
    """Every shape the ``parallel`` phase's latency runs give K1, K3 and K2 on
    each rank is among those the ``kernels`` phase holds against the plain
    versions."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import apply_speed, model_preset

    large = model_preset(chip_smoke.PARALLEL_MODEL)
    n = chip_smoke.PARALLEL_RANKS
    held = {"K1": {s for s, _ in chip_smoke.K1_SHAPES}, "K3": {s for s, _ in chip_smoke.K3_SHAPES}}
    for cfg in (large, apply_speed(large, "fast")):
        for key in chip_smoke.latency_shapes(cfg, n):
            kernel, dims = key.split()
            assert tuple(map(int, dims.split("x"))) in held[kernel], key
    for rank in range(n):
        assert set(chip_smoke.k2_band_shapes(large, n, rank)) <= set(chip_smoke.K2_SHAPES)


def test_band_cuts_and_the_deviation_locate_a_halo_error():
    """The bands of the large preset meet at output row 540 of 1080 over 2
    ranks (360 and 720 over 3). An error on the rows next to a cut crowds the
    top 1% there and puts the max beside it; noise spread over the map does
    neither."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import model_preset

    large = model_preset("large")
    assert chip_smoke.band_cuts(large, 2, 1080) == [540.0]
    assert chip_smoke.band_cuts(large, 3, 1080) == [360.0, 720.0]
    window = chip_smoke.halo_window(large, 1080)
    assert window == 45.0
    rng = np.random.default_rng(0)
    ref = rng.uniform(1.0, 10.0, (2, 1080, 64))
    noisy = ref * (1 + rng.normal(0, 1e-3, ref.shape))
    spread = chip_smoke.deviation(noisy, ref, [540.0], window)
    assert 0.5 < spread["crowding"] < 1.5 and not spread["equal"]
    assert spread["max_from_cut"] > 0
    broken = noisy.copy()
    broken[1, 536:544] *= 1.2
    near = chip_smoke.deviation(broken, ref, [540.0], window)
    assert near["max_from_cut"] < 4.5 and 536 <= near["max_row"] < 544
    assert near["crowding"] > 5 and near["max"] > 10 * spread["max"]
    assert chip_smoke.halo_fault(near) and not chip_smoke.halo_fault(spread)
    assert chip_smoke.deviation(ref, ref, [540.0], window)["equal"]


def test_zero_halo_control_zeroes_one_level_only(monkeypatch):
    """The control's bands over 2 ranks (the exchange stubbed): at the chosen
    width the neighbour's halo rows are zeros, at another width they are the
    neighbour's rows."""
    from ml_depth_pro_video_tpu_torch.parallel import latency
    from ml_depth_pro_video_tpu_torch.parallel import multihost as mh

    monkeypatch.setattr(mh, "world_size", lambda: 2)
    monkeypatch.setattr(mh, "rank", lambda: 0)
    monkeypatch.setattr(mh, "exchange", lambda sends: {p: torch.full_like(t, 7.0)
                                                       for p, t in sends.items()})
    bands = chip_smoke.zero_halo_bands(48)(24, latency.make_sp_mesh())
    x = torch.ones((1, 24, 48, 4))
    assert bands.extend(x, 2).shape == (1, 26, 48, 4)
    assert bands.extend(x, 2)[:, -2:].eq(0).all() and bands.extend(x, 2)[:, :24].eq(1).all()
    y = torch.ones((1, 48, 96, 4))
    assert bands.extend(y, 2)[:, -2:].eq(7).all()


def _train_parallel_forward_shapes(monkeypatch, mode):
    """K1's shapes in one forward (FOV off) of the large preset on rank 0 of
    a train_parallel mode, and its K5 calls and ViT blocks (``_count_k5``),
    shapes only: meta tensors, the collectives stubbed
    to return tensors of the shapes they would (the ranks' tp sums, the GPipe
    stage's receives and the banks' broadcasts)."""
    from ml_depth_pro_video_tpu_torch.ckpt.params import init_depth_pro
    from ml_depth_pro_video_tpu_torch.core.precision import Precision
    from ml_depth_pro_video_tpu_torch.models import depth_pro as dp
    from ml_depth_pro_video_tpu_torch.models import vit as vit_module
    from ml_depth_pro_video_tpu_torch.ops import resblock
    from ml_depth_pro_video_tpu_torch.parallel import multihost as mh
    from ml_depth_pro_video_tpu_torch.parallel import pipeline, sharding
    from ml_depth_pro_video_tpu_torch.parallel.mesh import AxisGroup, Mesh

    monkeypatch.setattr(mh, "all_reduce", lambda t, group=None: t.new_empty(t.shape))
    monkeypatch.setattr(mh, "broadcast", lambda t, src, group=None: t.new_empty(t.shape))
    monkeypatch.setattr(mh, "transfer", lambda sends, recvs: {
        p: t.new_empty(t.shape) for p, t in recvs.items()})
    shapes = {}
    real_attn = vit_module.attention_packed

    def attn(qkv, heads, key_bias=None):
        key = f"K1 {'x'.join(map(str, qkv.shape))}"
        shapes[key] = shapes.get(key, 0) + 1
        return real_attn(qkv, heads, key_bias)

    monkeypatch.setattr(vit_module, "attention_packed", attn)
    monkeypatch.setattr(resblock, "fused_residual_block", lambda x, *a: x)
    k5 = _count_k5(monkeypatch.setattr)
    cfg = dp.model_preset("large")
    kw = chip_smoke.TRAIN_PARALLEL_MODES[mode]
    params = init_depth_pro(cfg, torch.Generator().manual_seed(0), "meta")
    rows = chip_smoke.BATCH // kw.get("dp", 1)
    x = torch.empty((rows, cfg.img_size, cfg.img_size, 3), device="meta")
    fwd = dict(compute_fov=False)
    if "tp" in kw:
        mesh = Mesh(np.arange(2).reshape(1, 2), ("dp", "tp"), {"tp": AxisGroup(None, (0, 1), 0)})
        layout = sharding.Layout.build(mesh, params, sharding.param_shardings(params, mesh))
        params, fwd["tp"] = sharding.shard_params(params, mesh), layout.tp
    if "pp" in kw:
        mesh = Mesh(np.arange(2).reshape(1, 2), ("dp", "pp"), {"pp": AxisGroup(None, (0, 1), 0)})
        layout = sharding.Layout.build(mesh, params, pipeline._param_specs(params),
                                       kw["microbatches"])
        params = pipeline.shard_pp_params(params, mesh)
        fwd["patch_vit_fn"] = pipeline.pp_patch_vit_fn(cfg, Precision.bf16(), layout)
    with torch.no_grad():
        canonical, _ = dp.forward(params, x, cfg, Precision.bf16(), **fwd)
    assert tuple(canonical.shape) == (rows, cfg.img_size, cfg.img_size, 1)
    return shapes, k5


@pytest.mark.parametrize("mode", ["dp", "tp", "pp"])
def test_train_parallel_launches_per_rank_per_step(monkeypatch, mode):
    """A train_parallel step on a rank runs each block's forward and its
    recompute: twice one forward's K1, at the shapes the phase expects (dp:
    the rank's row; tp: 8 of 16 heads, (70, 577, 1536); pp: the stage's 12
    blocks on 5 microbatches of 14 patch rows, the image ViT whole); each is
    held by the kernels phase."""
    from ml_depth_pro_video_tpu_torch.models.depth_pro import model_preset

    forward_shapes, k5 = _train_parallel_forward_shapes(monkeypatch, mode)
    want = chip_smoke.train_parallel_shapes(model_preset("large"), mode)
    assert want == {k: 2 * v for k, v in forward_shapes.items()}
    # K5: the forward's, and each block's 3 again in the recompute
    assert chip_smoke.train_parallel_k5(model_preset("large"), mode) == (k5["K5"]
                                                                         + 3 * k5["blocks"])
    held = {s for s, _ in chip_smoke.K1_SHAPES}
    for key in want:
        assert tuple(map(int, key.split()[1].split("x"))) in held, key
