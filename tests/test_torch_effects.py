"""The port's effects (``effects/parallax.py``, ``depth-pro-effect-torch``)
against the JAX package's, on the CPU.

The same numpy image and depth go through both packages. ``bilinear_sample``
agrees within ``SAMPLE_ATOL``; the uint8 frames of ``parallax_frames`` (circle,
zoom, swing) and ``anaglyph_image`` may differ by 1 on at most ``U8_SHARE``
of their values and by no more anywhere: XLA's CPU backend contracts the
blend's ``v00 * (1 - fx) + v01 * fx`` into a fused multiply-add, torch rounds
the product first, so a blend that lands an ulp from an integer can truncate
one level apart (2 of the anaglyph's 960 values here). Then the port's own checks
as the JAX package has them (``tests/test_effects_cli.py``): chunking is
value-exact, an unknown motion raises, a cv2 round trip, the end-to-end
functions on a tiny port runner beside the JAX runner on one npz, and the CLI.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ml_depth_pro_video_tpu.effects import parallax as jpar
from ml_depth_pro_video_tpu.models.depth_pro import tiny_config as j_tiny_config
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JaxRunner
from ml_depth_pro_video_tpu_torch.effects import parallax as tpar
from ml_depth_pro_video_tpu_torch.models.depth_pro import tiny_config
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner
from torch_checkpoint import write_tiny_checkpoint

SAMPLE_ATOL = 1e-5  # values in [0, 255)
U8_SHARE = 5e-3     # of uint8 values that may differ by 1
PNG_SHARE = 1e-2    # of anaglyph values that may differ between runners' depths (fp32 rounding)


def _inputs(h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    depth = (1 + 9 * rng.random((h, w))).astype(np.float32)
    return img, depth


def _close_u8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert np.mean(diff > 0) <= U8_SHARE


def _read_video(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    img = (rng.random((30, 44, 3)) * 255).astype(np.float32)
    # inside, on pixel centres, and beyond every border (clamped)
    map_x = rng.uniform(-5, 50, (17, 23)).astype(np.float32)
    map_y = rng.uniform(-5, 36, (17, 23)).astype(np.float32)
    map_x[0, :5] = [0.0, 1.0, 43.0, 43.5, -1.0]
    want = np.asarray(jpar.bilinear_sample(jnp.asarray(img), jnp.asarray(map_x),
                                           jnp.asarray(map_y)))
    got = tpar.bilinear_sample(torch.from_numpy(img), torch.from_numpy(map_x),
                               torch.from_numpy(map_y)).numpy()
    assert got.shape == (17, 23, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL)


def test_bilinear_sample_identity_and_interp():
    img = torch.arange(12, dtype=torch.float32).reshape(3, 4, 1)
    ys, xs = torch.meshgrid(torch.arange(3.0), torch.arange(4.0), indexing="ij")
    torch.testing.assert_close(tpar.bilinear_sample(img, xs, ys), img)
    mid = tpar.bilinear_sample(img, torch.tensor([[0.5]]), torch.tensor([[0.0]]))
    torch.testing.assert_close(mid, torch.tensor([[[0.5]]]))


@pytest.mark.parametrize("motion", ["circle", "zoom", "swing"])
def test_parallax_frames_match_jax(motion):
    img, depth = _inputs()
    want = jpar.parallax_frames(img, depth, duration=1.0, fps=10, amplitude=0.1,
                                motion_type=motion)
    got = tpar.parallax_frames(img, depth, duration=1.0, fps=10, amplitude=0.1,
                               motion_type=motion, device="cpu")
    assert got.shape == (10, 40, 56, 3)
    _close_u8(got, want)
    if motion != "zoom":  # the depth-weighted motions move pixels
        assert np.abs(got[0].astype(int) - got[2].astype(int)).max() > 0


def test_anaglyph_matches_jax():
    img, _ = _inputs(16, 20, seed=1)
    depth = np.tile(np.linspace(1, 5, 20), (16, 1))
    got = tpar.anaglyph_image(img, depth, separation=0.1, device="cpu")
    _close_u8(got, jpar.anaglyph_image(img, depth, separation=0.1))
    assert (got[..., 0] != img[..., 0]).any()  # red comes from the shifted left view


def test_parallax_chunking_is_value_exact(monkeypatch):
    """Clips render in fixed-size chunks, the last one phase-padded: chunk
    boundaries change no pixel."""
    img, _ = _inputs(40, 48)
    depth = (1 + np.random.default_rng(0).random((40, 48))).astype(np.float32)
    whole = tpar.parallax_frames(img, depth, duration=0.6, fps=10, device="cpu")  # 6 frames
    dn = torch.from_numpy((depth - depth.min()) / max(depth.max() - depth.min(), 1e-9))
    phases = 2.0 * np.pi * np.arange(6, dtype=np.float32) / 6
    out = np.empty_like(whole)
    chunk = 4  # forces a padded tail chunk
    for i in range(0, 6, chunk):
        sel = phases[i:i + chunk]
        ts = torch.from_numpy(np.pad(sel, (0, chunk - len(sel))))
        fr = tpar._parallax_chunk(torch.from_numpy(img.astype(np.float32)), dn, 0.05, ts,
                                  "circle")
        out[i:i + len(sel)] = fr[:len(sel)].numpy()
    np.testing.assert_array_equal(out, whole)
    # and through parallax_frames itself, with a chunk of 4 frames
    monkeypatch.setattr(tpar, "CHUNK_BYTES", 4 * 40 * 48 * 3)
    np.testing.assert_array_equal(
        tpar.parallax_frames(img, depth, duration=0.6, fps=10, device="cpu"), whole)


def test_unknown_motion_raises():
    img, depth = _inputs(8, 8)
    with pytest.raises(ValueError, match="Unknown motion type"):
        tpar.parallax_frames(img, depth, duration=0.2, fps=10, motion_type="spin", device="cpu")


def test_effects_refuse_a_missing_card(monkeypatch):
    img, depth = _inputs(8, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.parallax_frames(img, depth, duration=0.2, fps=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.anaglyph_image(img, depth)


def test_write_video_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    frames = np.zeros((5, 32, 48, 3), np.uint8)
    frames[..., 0] = 200  # red in RGB: cv2 reads it back as BGR
    frames += rng.integers(0, 20, frames.shape, dtype=np.uint8)
    path = tmp_path / "clip.mp4"
    assert tpar.write_video(str(path), frames, fps=5) == "cv2"
    back = _read_video(path)
    assert len(back) == 5 and back[0].shape == (32, 48, 3)
    assert back[0][..., 2].mean() > 150 and back[0][..., 0].mean() < 60


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    ckpt = write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))
    port = DepthVideoRunner(cfg=dataclasses.replace(tiny_config(), checkpoint_uri=ckpt),
                            precision="fp32", decode_workers=1, device="cpu")
    jax = JaxRunner(cfg=dataclasses.replace(j_tiny_config(), checkpoint_uri=ckpt),
                    precision="fp32", decode_workers=1)
    return port, jax


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    img, _ = _inputs(48, 64, seed=3)
    path = tmp_path_factory.mktemp("photo") / "photo.png"
    Image.fromarray(img).save(path)
    return str(path)


def test_create_effects_on_a_tiny_runner(runners, photo, tmp_path):
    port, jax = runners
    mp4 = tmp_path / "parallax.mp4"
    tpar.create_parallax_effect(photo, str(mp4), duration=0.5, fps=8, motion_type="swing",
                                runner=port)
    back = _read_video(mp4)
    assert len(back) == 4 and back[0].shape == (48, 64, 3)
    scaled = tmp_path / "scaled.mp4"
    tpar.create_parallax_effect(photo, str(scaled), duration=0.25, fps=8,
                                resolution_scale=0.5, runner=port)
    assert _read_video(scaled)[0].shape == (24, 32, 3)

    got = tpar.create_3d_anaglyph(photo, str(tmp_path / "port.png"), runner=port)
    want = jpar.create_3d_anaglyph(photo, str(tmp_path / "jax.png"), runner=jax)
    assert got.shape == want.shape == (48, 64, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), got)
    # the two runners' depths differ by fp32 rounding, so a few values may move
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.mean(got != want) <= PNG_SHARE


@pytest.mark.parametrize("effect", ["parallax", "anaglyph"])
def test_cli_on_the_cpu(photo, tmp_path, effect):
    out = tmp_path / ("out.mp4" if effect == "parallax" else "out.png")
    tpar.main(["--image_path", photo, "--output_path", str(out), "--effect", effect,
               "--duration", "0.5", "--fps", "6", "--motion", "zoom", "--model", "tiny",
               "--device", "cpu"])
    if effect == "parallax":
        back = _read_video(out)
        assert len(back) == 3 and back[0].shape == (48, 64, 3)
    else:
        assert np.asarray(Image.open(out)).shape == (48, 64, 3)
