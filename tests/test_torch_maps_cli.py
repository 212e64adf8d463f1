"""The port's ``depth-pro-maps-torch`` and ``depth-pro-smooth-torch`` CLIs
against the JAX package's, on the CPU.

Both packages' runners load the params of one npz (fp32, tiny config) and run
``generate_depth_maps`` over the same frames directory: the ``.npz`` depth
agrees within rtol 1e-3 / atol 1e-4 (the JAX parity bar) and the PNGs, whose
levels come from that depth, within ``PNG_LEVELS`` of their range. A video
goes through ``generate_depth_video`` (OpenCV here), and the smooth CLI
orders files by frame number.
"""

import dataclasses
import importlib
import os
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ml_depth_pro_video_tpu.cli import generate_depth_maps as jmaps
from ml_depth_pro_video_tpu.cli import smooth_depth as jsmooth
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.ckpt import convert as tconvert
from ml_depth_pro_video_tpu_torch.ckpt.export import main as export_main
from ml_depth_pro_video_tpu_torch.cli import generate_depth_maps as tmaps
from ml_depth_pro_video_tpu_torch.cli import smooth_depth as tsmooth
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.video.pack import max_rel_error
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from ml_depth_pro_video_tpu_torch.video.temporal import smooth_depth_files
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-3, 1e-4
PNG_LEVELS = 2e-3  # share of the PNG's range


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


def _frames_dir(folder, n=3, h=48, w=64, seed=0):
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            folder / f"frame_{i:03d}.png")
    return folder


def _port_runner(checkpoint, **kwargs):
    return DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=checkpoint),
                            precision="fp32", batch_size=2, decode_workers=1, device="cpu",
                            **kwargs)


@pytest.mark.parametrize("colormap,fetch_pack", [("gray16", "none"), ("turbo", "none"),
                                                 ("gray", "u16")])
def test_maps_match_jax_cli(checkpoint, tmp_path, colormap, fetch_pack):
    frames = _frames_dir(tmp_path / "frames")
    port = _port_runner(checkpoint, fetch_pack=fetch_pack)
    jaxr = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=checkpoint),
                     precision="fp32", batch_size=2, decode_workers=1, fetch_pack=fetch_pack)
    got = tmaps.generate_depth_maps(str(frames), str(tmp_path / "port"), colormap=colormap,
                                    save_npz=True, runner=port)
    want = jmaps.generate_depth_maps(str(frames), str(tmp_path / "jax"), colormap=colormap,
                                     save_npz=True, runner=jaxr)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    rtol = RTOL + (max_rel_error() if fetch_pack == "u16" else 0.0)
    for g, w in zip(got, want):
        img_g, img_w = np.asarray(Image.open(g)), np.asarray(Image.open(w))
        assert img_g.shape == img_w.shape and img_g.dtype == img_w.dtype
        top = 65535 if colormap == "gray16" else 255
        assert np.abs(img_g.astype(np.int64) - img_w.astype(np.int64)).max() <= max(
            1, PNG_LEVELS * top)
        with np.load(g.replace(".png", ".npz")) as zg, np.load(w.replace(".png", ".npz")) as zw:
            assert zg.files == zw.files
            np.testing.assert_allclose(zg["depth"], zw["depth"], rtol=rtol, atol=ATOL)
            np.testing.assert_allclose(zg["focallength_px"], zw["focallength_px"], rtol=RTOL)


def test_colorize_depth_matches_jax():
    d = np.random.default_rng(1).uniform(0.5, 9.0, (20, 30)).astype(np.float32)
    d[0, 0], d[1, 1] = np.nan, np.inf
    for cmap in ("turbo", "gray", "gray16"):
        for kw in ({}, {"invert": True}, {"vmin": 1.0, "vmax": 4.0}):
            np.testing.assert_array_equal(tmaps.colorize_depth(d, cmap, **kw),
                                          jmaps.colorize_depth(d, cmap, **kw))
    np.testing.assert_array_equal(tmaps.colorize_depth(np.full((3, 3), np.nan), "gray"),
                                  jmaps.colorize_depth(np.full((3, 3), np.nan), "gray"))


def test_range_tracker_matches_jax():
    rng = np.random.default_rng(2)
    ours, theirs = tmaps._RangeTracker(0.7), jmaps._RangeTracker(0.7)
    for _ in range(4):
        d = rng.uniform(1.0, 10.0, (8, 8))
        assert ours.update(d) == theirs.update(d)
    assert tmaps._RangeTracker(fixed=(1.0, 2.0)).update(d) == (1.0, 2.0)


def test_main_writes_packed_gray16_maps_and_npz(tmp_path, capsys):
    frames = _frames_dir(tmp_path / "frames", n=3)
    out = tmp_path / "out"
    tmaps.main([str(frames), "-o", str(out), "--model", "tiny", "--device", "cpu",
                "--save_npz", "--packed_fetch", "--colormap", "gray16", "--batch_size", "2"])
    pngs = sorted(out.glob("*_depth.png"))
    npzs = sorted(out.glob("*_depth.npz"))
    assert len(pngs) == len(npzs) == 3
    for png, npz in zip(pngs, npzs):
        img = np.asarray(Image.open(png))
        assert img.shape == (48, 64) and img.dtype == np.uint16
        depth = np.load(npz)["depth"]
        assert depth.shape == (48, 64) and np.isfinite(depth).all() and (depth > 0).all()
    assert "Successfully wrote 3/3" in capsys.readouterr().out


def test_main_writes_maps_through_an_artifact(tmp_path, monkeypatch):
    """``depth-pro-maps-torch --exported``: frames at the tiny model's 512^2 in
    batches of 2 (the last one padded) go through the artifact, and the npz
    files equal an eager run's bit for bit."""
    frames = _frames_dir(tmp_path / "frames", n=3, h=512, w=512, seed=7)
    art = str(tmp_path / "tiny.pt2")
    export_main(["-o", art, "--tiny", "--device", "cpu", "--batch_size", "2"])
    runners = []

    class Recording(DepthVideoRunner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runners.append(self)

    monkeypatch.setattr(tmaps, "DepthVideoRunner", Recording)
    outs = []
    for extra in (["--exported", art], []):
        outs.append(tmp_path / f"out{len(outs)}")
        tmaps.main([str(frames), "-o", str(outs[-1]), "--model", "tiny", "--device", "cpu",
                    "--save_npz", "--batch_size", "2", *extra])
    assert [r.exported_calls for r in runners] == [2, 0]
    names = sorted(p.name for p in outs[0].glob("*_depth.npz"))
    assert len(names) == 3 and names == sorted(p.name for p in outs[1].glob("*_depth.npz"))
    for name in names:
        assert np.array_equal(np.load(outs[0] / name)["depth"], np.load(outs[1] / name)["depth"])


def test_main_refuses_what_is_not_ported(tmp_path):
    frames = _frames_dir(tmp_path / "frames", n=1)
    with pytest.raises(SystemExit):  # no multi-host flags yet
        tmaps.main([str(frames), "-o", str(tmp_path / "o"), "--coordinator_address", "x:1"])
    with pytest.raises(SystemExit):  # a video file needs --video_out
        tmaps.main([str(tmp_path / "clip.mp4"), "-o", str(tmp_path / "o")])


def _write_video(path, n, h=48, w=64):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for _ in range(n):
        vw.write(np.clip(base.astype(np.int16) + rng.integers(-3, 4, base.shape), 0, 255)
                 .astype(np.uint8))
    vw.release()


def _count_frames(path) -> int:
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_generate_depth_video_writes_every_frame(checkpoint, tmp_path):
    clip, out = tmp_path / "clip.mp4", tmp_path / "depth.mp4"
    _write_video(clip, 5)
    port = _port_runner(checkpoint, temporal_smooth=0.8, fetch_pack="u16")
    n = tmaps.generate_depth_video(str(clip), str(out), runner=port, side_by_side=True)
    assert n == 5 and _count_frames(out) == 5
    frames = _frames_dir(tmp_path / "frames", n=5)
    out2 = tmp_path / "dir.mp4"
    n = tmaps.generate_depth_video(str(frames), str(out2), runner=port, colormap="gray",
                                   start=1, end=3, stride=2)
    assert n == 2 and _count_frames(out2) == 2  # frames 1 and 3 (end inclusive)
    with pytest.raises(ValueError, match="16-bit"):
        tmaps.generate_depth_video(str(frames), str(out2), runner=port, colormap="gray16")


def test_smooth_cli_orders_by_frame_number(tmp_path):
    """frame_2 comes before frame_10; the port's CLI writes what the JAX CLI
    writes, and what smoothing in numeric order writes."""
    rng = np.random.default_rng(4)
    base = 2.0 + rng.random((24, 32)).astype(np.float32)
    numbers = [10, 2, 1, 33, 3]
    folders = ("port", "jax", "ref", "lex_in")
    for folder in folders:
        (tmp_path / folder).mkdir()
    for k in sorted(numbers):
        d = (base * (1 + 0.01 * rng.standard_normal(base.shape))).astype(np.float32)
        for folder in folders:
            np.savez(tmp_path / folder / f"frame_{k}_depth.npz", depth=d)
    assert tsmooth._ordered([f"a/frame_{k}.npz" for k in numbers]) == [
        f"a/frame_{k}.npz" for k in sorted(numbers)]
    assert tsmooth.frame_number("x/f_0012.png") == 12 and tsmooth.frame_number("abc") is None
    tsmooth.main([str(tmp_path / "port"), "--device", "cpu"])
    jsmooth.main([str(tmp_path / "jax")])
    smooth_depth_files([str(tmp_path / "ref" / f"frame_{k}_depth.npz") for k in sorted(numbers)],
                       device="cpu")
    lexicographic = smooth_depth_files(
        sorted(str(p) for p in (tmp_path / "lex_in").glob("*.npz")), str(tmp_path / "lex"),
        device="cpu")
    assert lexicographic == len(numbers)
    differs = False
    for k in numbers:
        name = f"frame_{k}_depth.npz"
        got = np.load(tmp_path / "port" / name)["depth"]
        np.testing.assert_allclose(got, np.load(tmp_path / "jax" / name)["depth"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got, np.load(tmp_path / "ref" / name)["depth"])
        differs |= not np.array_equal(got, np.load(tmp_path / "lex" / name)["depth"])
    assert differs  # the order matters, so the test can tell the orders apart


@pytest.mark.parametrize("script,main", [("depth-pro-maps-torch", tmaps.main),
                                         ("depth-pro-smooth-torch", tsmooth.main),
                                         ("depth-pro-convert-torch", tconvert.main)])
def test_console_scripts_name_the_port_mains(script, main):
    pyproject = Path(__file__).resolve().parents[1] / "pyproject.toml"
    module, func = tomllib.loads(pyproject.read_text())["project"]["scripts"][script].split(":")
    assert module.startswith("ml_depth_pro_video_tpu_torch.")
    assert getattr(importlib.import_module(module), func) is main


def test_extract_frames_writes_what_jax_writes(tmp_path):
    from ml_depth_pro_video_tpu.video import decode as jdecode
    from ml_depth_pro_video_tpu_torch.video import decode as tdecode

    clip = tmp_path / "clip.mp4"
    _write_video(clip, 6)
    assert tdecode.video_info(str(clip)) == jdecode.video_info(str(clip))
    got = tdecode.extract_frames(str(clip), str(tmp_path / "port"), start=1, end=4, stride=2)
    want = jdecode.extract_frames(str(clip), str(tmp_path / "jax"), start=1, end=4, stride=2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(Image.open(g)), np.asarray(Image.open(w)))
    marker = tdecode.DECODE_COMPLETE_MARKER
    assert (tmp_path / "port" / marker).read_text() == (tmp_path / "jax" / marker).read_text()
