"""The port's frames -> depth -> floor-plan pipeline (``video/pipeline.py``,
``depth-pro-video-torch``) against the JAX package's, on the CPU.

Both packages' runners load the params of one npz (fp32, tiny config) and
run ``process_images_to_floor_plans`` over the same three 120x160 frames
(as ``tests/test_pipeline.py`` builds them), each in a frames directory of
its own (``ground.json`` is written there). The depth of the two runners
differs by fp32 rounding, so the ground plane agrees within ``GROUND_ATOL``
and a floor-plan or preview PNG may differ in at most ``PNG_SHARE`` of its
pixels (a few splats may move); the progress record has the same keys. Then
the JAX package's pipeline tests of resume, the frame range, retrying a
failed frame and the fast renderer run on the port, the CLI runs once, and
the multi-rank refusals and flags hold on one process. With
``geometry="device"`` (the floor-plan program on the runner's device, here
the CPU) both packages' plans agree within ``PNG_SHARE`` and their
``floorplan_limits.json`` are equal.
"""

import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import ml_depth_pro_video_tpu_torch.video.pipeline as tpipeline
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.video import pipeline as jpipeline
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.cli import pipeline as cli_pipeline
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint

GROUND_ATOL = 1e-5  # normal, d and origin; fp32 depth rounding moves them by ~1e-7
PNG_SHARE = 1e-3    # of a PNG's pixels that may differ between the packages


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


def _write_frames(folder, n=3, h=120, w=160, seed=0):
    """``tests/test_pipeline.py``'s frames: uniform noise, output_%04d.png."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(folder / f"output_{i:04d}.png")
    return str(folder)


@pytest.fixture(scope="module")
def port_runner(checkpoint):
    return DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                            precision="fp32", batch_size=2, decode_workers=1, device="cpu")


@pytest.fixture
def frames_dir(tmp_path):
    return _write_frames(tmp_path / "frames")


def _count_inferred(runner, monkeypatch) -> list:
    """Record how many frames each ``depth_stream`` call of ``runner`` takes
    (``infer_one`` streams one)."""
    counts, real = [], runner.depth_stream

    def counting(items):
        items = list(items)
        counts.append(len(items))
        return real(items)

    monkeypatch.setattr(runner, "depth_stream", counting)
    return counts


def test_pipeline_matches_jax(checkpoint, port_runner, tmp_path, monkeypatch, capsys):
    jax_runner = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint),
                           precision="fp32", batch_size=2, decode_workers=1)
    out = {}
    for name, pipeline, runner in (("jax", jpipeline, jax_runner),
                                   ("port", tpipeline, port_runner)):
        frames = _write_frames(tmp_path / f"frames_{name}")
        out[name] = (frames, str(tmp_path / f"out_{name}"))
        counts = _count_inferred(runner, monkeypatch) if name == "port" else None
        pipeline.process_images_to_floor_plans(frames, output_dir=out[name][1], num_workers=2,
                                               fit_shapes=False, visualize_3d=True,
                                               runner=runner)
    # frame 0's ground-fit inference is reused: three frames inferred, not four
    assert sum(counts) == 3 and counts[0] == 1

    grounds = [json.load(open(os.path.join(out[n][0], "ground.json"))) for n in ("jax", "port")]
    assert sorted(grounds[0]) == sorted(grounds[1]) == ["d", "normal", "origin"]
    for key in ("normal", "d", "origin"):
        np.testing.assert_allclose(grounds[1][key], grounds[0][key], rtol=0, atol=GROUND_ATOL)

    progress = [json.load(open(os.path.join(out[n][1], "processing_progress.json")))
                for n in ("jax", "port")]
    assert sorted(progress[1]) == sorted(progress[0]) == [f"output_{i:04d}.png"
                                                          for i in range(3)]
    assert all(v["success"] for v in progress[1].values())

    names = sorted(os.listdir(out["port"][1]))
    assert names == sorted(os.listdir(out["jax"][1]))
    pngs = [n for n in names if n.endswith(".png")]
    assert len(pngs) == 6  # a floor plan and a 3D preview per frame
    for n in pngs:
        want = np.asarray(Image.open(os.path.join(out["jax"][1], n)))
        got = np.asarray(Image.open(os.path.join(out["port"][1], n)))
        assert got.shape == want.shape, n
        share = np.mean(np.any(got != want, axis=-1))
        assert share <= PNG_SHARE, (n, share)

    # resume: everything already done -> early exit, progress unchanged, nothing inferred
    capsys.readouterr()
    counts.clear()
    done = tpipeline.process_images_to_floor_plans(out["port"][0], output_dir=out["port"][1],
                                                   resume=True, runner=port_runner)
    assert set(done) == set(progress[1]) and counts == []
    assert "All frames already processed." in capsys.readouterr().out


def test_pipeline_reuses_cached_ground(port_runner, frames_dir, tmp_path, monkeypatch, capsys):
    """A second run over the same frames reads ground.json and infers each
    frame once in the stream."""
    tpipeline.process_images_to_floor_plans(frames_dir, output_dir=str(tmp_path / "a"),
                                            num_workers=1, fit_shapes=False, renderer="fast",
                                            runner=port_runner)
    ground = open(os.path.join(frames_dir, "ground.json")).read()
    capsys.readouterr()
    counts = _count_inferred(port_runner, monkeypatch)
    done = tpipeline.process_images_to_floor_plans(frames_dir, output_dir=str(tmp_path / "b"),
                                                   num_workers=1, fit_shapes=False,
                                                   renderer="fast", runner=port_runner)
    assert len(done) == 3 and counts == [3]
    assert "Computing ground plane" not in capsys.readouterr().out
    assert open(os.path.join(frames_dir, "ground.json")).read() == ground


def test_pipeline_frame_range(port_runner, frames_dir, tmp_path):
    completed = tpipeline.process_images_to_floor_plans(
        frames_dir, output_dir=str(tmp_path / "range_out"), start_frame=1, end_frame=1,
        num_workers=2, fit_shapes=False, runner=port_runner)
    assert list(completed) == ["output_0001.png"]


def test_fast_floorplan_renderer_with_shapes(port_runner, frames_dir, tmp_path):
    out = str(tmp_path / "fast_out")
    completed = tpipeline.process_images_to_floor_plans(
        frames_dir, output_dir=out, num_workers=2, fit_shapes=True, output_all_files=False,
        renderer="fast", runner=port_runner, force_reprocess=True)
    assert len(completed) == 3
    for i in range(3):
        img = np.asarray(Image.open(os.path.join(out, f"output_{i:04d}_clean_simple_view.png")))
        assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8


def test_resume_retries_failed_frames(port_runner, frames_dir, tmp_path, monkeypatch):
    """Only successful frames land in processing_progress.json, so a failed
    frame is retried on --resume instead of being skipped forever."""
    calls = {"n": 0}

    def fake_process(result, *a, **k):
        calls["n"] += 1
        return "0001" not in result["key"], 0.0  # frame 1 fails

    monkeypatch.setattr(tpipeline, "process_single_frame", fake_process)
    out_dir = str(tmp_path / "plans")
    tpipeline.process_images_to_floor_plans(frames_dir, output_dir=out_dir, num_workers=1,
                                            runner=port_runner, fit_shapes=False,
                                            renderer="fast")
    with open(f"{out_dir}/processing_progress.json") as f:
        progress = json.load(f)
    assert "output_0001.png" not in progress
    assert len(progress) == 2 and all(v["success"] for v in progress.values())

    calls["n"] = 0
    tpipeline.process_images_to_floor_plans(frames_dir, output_dir=out_dir, num_workers=1,
                                            runner=port_runner, fit_shapes=False,
                                            renderer="fast", resume=True)
    assert calls["n"] == 1


def test_a_failing_frame_is_isolated(port_runner, frames_dir, tmp_path, monkeypatch, capsys):
    """An error in one frame's geometry is printed and the frame is left out
    of the progress record; the other frames are done."""
    real = tpipeline.clean_shadows

    def flaky(cloud):
        if flaky.calls == 1:
            flaky.calls += 1
            raise RuntimeError("injected geometry failure")
        flaky.calls += 1
        return real(cloud)

    flaky.calls = 0
    monkeypatch.setattr(tpipeline, "clean_shadows", flaky)
    done = tpipeline.process_images_to_floor_plans(frames_dir, output_dir=str(tmp_path / "o"),
                                                   num_workers=1, fit_shapes=False,
                                                   renderer="fast", runner=port_runner)
    assert sorted(done) == ["output_0000.png", "output_0002.png"]
    assert "injected geometry failure" in capsys.readouterr().out


def test_cli_runs_on_the_cpu(frames_dir, tmp_path, capsys):
    """``depth-pro-video-torch`` with the tiny preset (random weights) on the
    CPU; --parallel dp on one device runs unsharded and says so."""
    out = str(tmp_path / "cli_out")
    cli_pipeline.main(["--frames_dir", frames_dir, "--output_dir", out, "--model", "tiny",
                       "--full_precision", "--batch_size", "2", "--num_workers", "2",
                       "--renderer", "fast", "--no_fit_shapes", "--parallel", "dp",
                       "--device", "cpu"])
    assert "--parallel dp: single device, running unsharded" in capsys.readouterr().out
    progress = json.load(open(os.path.join(out, "processing_progress.json")))
    assert sorted(progress) == [f"output_{i:04d}.png" for i in range(3)]
    assert len(glob.glob(os.path.join(out, "*_clean_simple_view.png"))) == 3
    assert os.path.exists(os.path.join(frames_dir, "ground.json"))


def test_cli_decodes_a_video_first(port_runner, tmp_path, monkeypatch):
    """--video: frames are extracted into --frames_dir with the decode-complete
    marker, then a rerun skips the decode."""
    from ml_depth_pro_video_tpu_torch.video.writer import VideoSink

    rng = np.random.default_rng(1)
    vid = str(tmp_path / "clip.mp4")
    with VideoSink(vid, fps=4) as sink:
        for _ in range(3):
            sink.append(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8))
    seen = []
    monkeypatch.setattr(cli_pipeline, "process_images_to_floor_plans",
                        lambda **kw: seen.append(kw))
    frames = str(tmp_path / "clip_frames")
    cli_pipeline.main(["--video", vid, "--frames_dir", frames, "--device", "cpu"])
    assert len(glob.glob(os.path.join(frames, "output_*.png"))) == 3
    assert open(os.path.join(frames, ".decode_complete")).read().strip() == "3"
    stamp = os.path.getmtime(os.path.join(frames, "output_000000.png"))
    cli_pipeline.main(["--video", vid, "--frames_dir", frames, "--device", "cpu"])
    assert os.path.getmtime(os.path.join(frames, "output_000000.png")) == stamp
    assert [kw["frames_dir"] for kw in seen] == [frames, frames]
    assert seen[0]["device"] == "cpu"


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num_processes", "2"], ["--process_id", "1"]])
def test_cli_multihost_flags_raise(flag, frames_dir, monkeypatch):
    """The multi-host flags, which raised before they were ported: a group of
    several ranks needs the coordinator and this rank's id (else the flags
    raise before anything joins); a coordinator or a rank id alone, with no
    rank count, is a single process that joins nothing
    (``tests/test_torch_multihost.py`` runs the CLI over 2 ranks)."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    seen = []
    monkeypatch.setattr(cli_pipeline, "process_images_to_floor_plans",
                        lambda **kw: seen.append(kw))
    argv = ["--frames_dir", frames_dir, *flag, "--device", "cpu"]
    if flag[0] == "--num_processes":
        with pytest.raises(ValueError, match="--coordinator host:port and --process_id"):
            cli_pipeline.main(argv)
        assert seen == []
    else:
        cli_pipeline.main(argv)
        assert [kw["frames_dir"] for kw in seen] == [frames_dir]
    assert cli_pipeline.multihost.cluster() is None


def test_unported_modes_raise(port_runner, frames_dir, tmp_path, monkeypatch):
    """An unknown geometry raises; over several ranks (which raised before
    they were ported) the JAX package's pod refusals hold before anything is
    inferred: ``temporal_smooth`` and ``packed_fetch`` (frames interleave
    across ranks) and ``--geometry device`` without a fixed framing, and a
    given runner without a dp mesh cannot stream the ranks' rows."""
    with pytest.raises(ValueError, match="geometry"):
        tpipeline.process_images_to_floor_plans(frames_dir, geometry="gpu", runner=port_runner)
    monkeypatch.setattr(tpipeline.mh, "world_size", lambda: 2)
    out = str(tmp_path / "pod")
    for kwargs, match in (({"temporal_smooth": 0.5}, "temporal_smooth is single-host"),
                          ({"packed_fetch": True}, "packed_fetch is single-host"),
                          ({"geometry": "device", "fit_shapes": False}, "explicit --x_limits")):
        with pytest.raises(ValueError, match=match):
            tpipeline.process_images_to_floor_plans(frames_dir, output_dir=out, device="cpu",
                                                    **kwargs)
    with pytest.raises(ValueError, match="dp mesh"):
        tpipeline.process_images_to_floor_plans(frames_dir, output_dir=out, runner=port_runner)
    assert not os.path.exists(os.path.join(frames_dir, "ground.json"))


def test_frame_number_moved_here():
    from ml_depth_pro_video_tpu_torch.cli import smooth_depth

    assert tpipeline.frame_number("output_0243.png") == 243
    assert tpipeline.frame_number("nodigits.png") is None
    assert smooth_depth.frame_number is tpipeline.frame_number


def test_pipeline_on_an_empty_directory(port_runner, tmp_path, capsys):
    empty = tmp_path / "none"
    empty.mkdir()
    assert tpipeline.process_images_to_floor_plans(str(empty), runner=port_runner) == {}
    assert "No images to process" in capsys.readouterr().out
    shutil.rmtree(empty)


def test_device_geometry_matches_jax(checkpoint, port_runner, tmp_path, monkeypatch):
    """Both packages' ``geometry="device"`` on one npz: the same files, plans
    within PNG_SHARE, equal framing files; frame 0's ground-fit inference is
    reused as with the host geometry."""
    jax_runner = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint),
                           precision="fp32", batch_size=2, decode_workers=1)
    out = {}
    for name, pipeline, runner in (("jax", jpipeline, jax_runner),
                                   ("port", tpipeline, port_runner)):
        frames = _write_frames(tmp_path / f"frames_{name}")
        out[name] = (frames, str(tmp_path / f"out_{name}"))
        counts = _count_inferred(runner, monkeypatch) if name == "port" else None
        done = pipeline.process_images_to_floor_plans(
            frames, output_dir=out[name][1], num_workers=2, fit_shapes=False,
            geometry="device", device_subsample=2, runner=runner)
        assert sorted(done) == [f"output_{i:04d}.png" for i in range(3)]
    assert sum(counts) == 3 and counts[0] == 1

    limits = [json.load(open(os.path.join(out[n][0], "floorplan_limits.json")))
              for n in ("jax", "port")]
    assert sorted(limits[1]) == ["fingerprint", "x_limits", "z_limits"]
    # the fingerprint names the ground plane, which each package fits to its
    # own fp32 depth of frame 0 (within GROUND_ATOL of each other): its numbers
    # within GROUND_ATOL, the rest equal
    fields = [dict(f.split("=") for f in lim["fingerprint"].split(";")) for lim in limits]
    assert fields[1]["ht"] == fields[0]["ht"] and fields[1]["md"] == fields[0]["md"]
    for key in ("n", "d"):
        np.testing.assert_allclose(np.asarray(fields[1][key].split(","), float),
                                   np.asarray(fields[0][key].split(","), float),
                                   rtol=0, atol=GROUND_ATOL)
    # and so does the framing
    for key in ("x_limits", "z_limits"):
        np.testing.assert_allclose(limits[1][key], limits[0][key], rtol=1e-5, atol=1e-6)
    names = sorted(os.listdir(out["port"][1]))
    assert names == sorted(os.listdir(out["jax"][1]))
    pngs = [n for n in names if n.endswith(".png")]
    assert pngs == [f"output_{i:04d}_clean_simple_view.png" for i in range(3)]
    for n in pngs:
        want = np.asarray(Image.open(os.path.join(out["jax"][1], n)))
        got = np.asarray(Image.open(os.path.join(out["port"][1], n)))
        assert got.shape == want.shape and got.shape[1] == 1024, n
        assert np.mean(np.any(got != want, axis=-1)) <= PNG_SHARE, n


def test_device_geometry_refuses_host_cloud_modes(port_runner, frames_dir):
    """Shape fitting and 3D previews need the host cloud: ValueError, as in
    the JAX package, before anything runs."""
    for flags in ({"fit_shapes": True}, {"fit_shapes": False, "visualize_3d": True}):
        with pytest.raises(ValueError, match="fit_shapes"):
            tpipeline.process_images_to_floor_plans(frames_dir, geometry="device",
                                                    runner=port_runner, **flags)
    assert not os.path.exists(os.path.join(frames_dir, "ground.json"))


def test_cli_device_geometry_on_the_cpu(frames_dir, tmp_path, capsys):
    """``depth-pro-video-torch --geometry device`` (shape fitting implied off)
    with the tiny preset on the CPU; ignored host-renderer flags are named."""
    out = str(tmp_path / "cli_device")
    cli_pipeline.main(["--frames_dir", frames_dir, "--output_dir", out, "--model", "tiny",
                       "--full_precision", "--batch_size", "2", "--num_workers", "2",
                       "--geometry", "device", "--renderer", "fast", "--device", "cpu"])
    assert "ignoring: --renderer fast" in capsys.readouterr().out
    progress = json.load(open(os.path.join(out, "processing_progress.json")))
    assert sorted(progress) == [f"output_{i:04d}.png" for i in range(3)]
    plans = sorted(glob.glob(os.path.join(out, "*_clean_simple_view.png")))
    assert len(plans) == 3
    assert all(np.asarray(Image.open(p)).shape[1:] == (1024, 3) for p in plans)
    assert os.path.exists(os.path.join(frames_dir, "floorplan_limits.json"))
