"""The PyTorch port never imports jax: every module of the package and
everything ``chip_smoke.py`` imports load in a fresh interpreter with
``jax`` absent from ``sys.modules`` afterwards."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import ml_depth_pro_video_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(ml_depth_pro_video_tpu_torch.__path__,
                                                        "ml_depth_pro_video_tpu_torch."))


def test_port_covers_the_slice_modules():
    mods = set(_port_modules())
    for name in ("core.precision", "ops.norm", "ops.conv", "ops.resize", "ops.attention",
                 "ops.resblock", "kernels.loader", "models.vit", "models.depth_pro",
                 "ckpt.params", "video.runner", "cli.run"):
        assert f"ml_depth_pro_video_tpu_torch.{name}" in mods


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "ml_depth_pro_video_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_slice_profile.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert not words[1].startswith("jax"), f"{path}: {line}"
