"""The port's distillation (``train/distill.py``) against the JAX package's:
``distill_labels`` on the same frames with both packages' tiny fp32 runners on
one npz (the same files, depth and focal length within the runner tests'
tolerance, resume), from a video, ``distill`` end to end, and
``depth-pro-distill-torch`` through ``main`` on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from ml_depth_pro_video_tpu.models import depth_pro as jdp
from ml_depth_pro_video_tpu.train.distill import distill_labels as j_distill_labels
from ml_depth_pro_video_tpu.video.runner import DepthVideoRunner as JRunner
from ml_depth_pro_video_tpu_torch.effects.parallax import write_video
from ml_depth_pro_video_tpu_torch.models import depth_pro as tdp
from ml_depth_pro_video_tpu_torch.train import distill as tdistill
from ml_depth_pro_video_tpu_torch.train.step import tree_leaves
from ml_depth_pro_video_tpu_torch.video.runner import DepthVideoRunner as TRunner
from torch_checkpoint import write_tiny_checkpoint

RTOL, ATOL = 1e-3, 1e-4  # the runner tests' bar (tests/test_torch_runner.py)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"))


@pytest.fixture(scope="module")
def teachers(npz):
    jt = JRunner(cfg=dataclasses.replace(jdp.tiny_config(), checkpoint_uri=npz),
                 precision="fp32", batch_size=2)
    tt = TRunner(cfg=dataclasses.replace(tdp.tiny_config(), checkpoint_uri=npz),
                 precision="fp32", batch_size=2, decode_pool="thread", device="cpu")
    return jt, tt


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    for i in range(4):
        Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)).save(
            str(d / f"f_{i:04d}.png"))
    return str(d)


def test_labels_equal_jax_and_resume(teachers, frames_dir, tmp_path):
    jt, tt = teachers
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert j_distill_labels(frames_dir, jdir, teacher_runner=jt) == 4
    assert tdistill.distill_labels(frames_dir, tdir, teacher_runner=tt) == 4
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for i in range(4):
        name = f"f_{i:04d}"
        # the cached image is exactly what the teacher saw
        assert (np.asarray(Image.open(os.path.join(tdir, name + ".png")))
                == np.asarray(Image.open(os.path.join(jdir, name + ".png")))).all()
        with np.load(os.path.join(tdir, name + "_depth.npz")) as t, \
                np.load(os.path.join(jdir, name + "_depth.npz")) as j:
            assert sorted(t.files) == sorted(j.files) == ["depth", "focallength_px"]
            assert t["depth"].shape == (48, 64) and t["depth"].dtype == np.float32
            np.testing.assert_allclose(t["depth"], j["depth"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(t["focallength_px"], j["focallength_px"], rtol=RTOL)
    # resume: everything is already labelled; a removed label is redone alone
    assert tdistill.distill_labels(frames_dir, tdir, teacher_runner=tt) == 0
    os.remove(os.path.join(tdir, "f_0002_depth.npz"))
    assert tdistill.distill_labels(frames_dir, tdir, teacher_runner=tt) == 1


def test_labels_from_a_video_and_a_frame_range(teachers, tmp_path):
    _, tt = teachers
    rng = np.random.default_rng(5)
    vid = str(tmp_path / "clip.mp4")
    write_video(vid, (rng.random((3, 48, 64, 3)) * 255).astype(np.uint8), fps=4)
    labels = str(tmp_path / "labels")
    assert tdistill.distill_labels(vid, labels, teacher_runner=tt) == 3
    assert sorted(f for f in os.listdir(labels) if f.endswith(".npz")) == [
        f"clip_{i:06d}_depth.npz" for i in range(3)]
    assert tdistill.distill_labels(vid, labels, teacher_runner=tt) == 0
    ranged = str(tmp_path / "ranged")
    assert tdistill.distill_labels(vid, ranged, teacher_runner=tt, start=1, end=2) == 2


def test_no_frames_raises(teachers, tmp_path):
    with pytest.raises(FileNotFoundError, match="no"):
        tdistill.distill_labels(str(tmp_path), str(tmp_path / "l"), teacher_runner=teachers[1])


def test_distill_end_to_end_on_the_cpu(teachers, frames_dir, tmp_path):
    """Teacher labels, then the tiny student's fit on the cache: two steps,
    finite params; the labels' focal length feeds the canonical targets."""
    state = tdistill.distill(frames_dir, str(tmp_path / "labels"), student="tiny",
                             teacher_runner=teachers[1], batch_size=2, epochs=1, lr=1e-5,
                             warmup_steps=0, log_every=1, device="cpu")
    assert state.step == 2
    assert all(np.isfinite(t.detach().numpy()).all() for t in tree_leaves(state.params))


def test_distill_cli_on_the_cpu(frames_dir, tmp_path):
    labels, ckpt = tmp_path / "labels", tmp_path / "ckpt"
    tdistill.main(["--frames", frames_dir, "--labels_dir", str(labels), "--tiny", "--device",
                   "cpu", "--batch_size", "2", "--teacher_batch_size", "2", "--warmup_steps",
                   "0", "--checkpoint_dir", str(ckpt)])
    assert len(list(labels.glob("*_depth.npz"))) == 4
    assert (ckpt / "2" / "state.pt").is_file()


@pytest.mark.parametrize("kw,match", [
    (dict(tp=2), "mesh 0x2 needs 2 devices, have 1"),
    (dict(pp=2), "pp=2 needs at least 2 devices, have 1")])
def test_student_parallelism_reaches_fit(teachers, frames_dir, tmp_path, kw, match):
    """``tp`` / ``pp`` flow to ``fit``, whose mesh in one process raises the
    JAX package's ValueError (``fit`` across ranks:
    tests/test_torch_fit_parallel.py)."""
    with pytest.raises(ValueError, match=match):
        tdistill.distill(frames_dir, str(tmp_path / "labels"), student="tiny",
                         teacher_runner=teachers[1], batch_size=2, device="cpu", **kw)
