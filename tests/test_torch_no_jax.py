"""The PyTorch port never imports jax or the JAX package, nor the JAX
package's training libraries (``optax``, ``orbax``): every module of the
package and everything ``chip_smoke.py`` imports load in a fresh interpreter
with none of them in ``sys.modules`` afterwards, and no source line imports
one."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import ml_depth_pro_video_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "ml_depth_pro_video_tpu", "optax", "orbax")  # as a top-level package name


def _port_modules():
    """Every Python module of the port. A name that is no identifier is no
    Python module: ``native/geom-native.so``, the C++ geometry library that
    ctypes loads once it is built."""
    return sorted(m.name for m in pkgutil.walk_packages(ml_depth_pro_video_tpu_torch.__path__,
                                                        "ml_depth_pro_video_tpu_torch.")
                  if m.name.rsplit(".", 1)[-1].isidentifier())


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_port_covers_the_slice_modules():
    mods = set(_port_modules())
    for name in ("core.precision", "ops.norm", "ops.conv", "ops.resize", "ops.attention",
                 "ops.resblock", "kernels.loader", "models.vit", "models.depth_pro",
                 "ckpt.params", "ckpt.convert", "video.runner", "video.pack", "video.temporal",
                 "video.decode", "video.writer", "video.pipeline", "cli.run",
                 "cli.generate_depth_maps", "cli.smooth_depth", "cli.pipeline", "io.image",
                 "native", "geom.pointcloud", "geom.unproject", "geom.ground", "geom.clean",
                 "geom.shapes", "geom.floorplan_viz", "geom.render", "geom.device_floorplan",
                 "effects.parallax", "ckpt.quantize", "serve.server", "ckpt.export",
                 "utils.compile_cache", "train.step", "train.data", "train.loop",
                 "train.distill", "ckpt.checkpointing", "utils.synthetic", "utils.profiling",
                 "parallel.multihost", "parallel.mesh", "parallel.spmd", "parallel.latency",
                 "parallel.sharding", "parallel.pipeline"):
        assert f"ml_depth_pro_video_tpu_torch.{name}" in mods


def test_port_and_chip_smoke_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import ml_depth_pro_video_tpu_torch as port\n"
        "port.load_rgb\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _imported_modules(line: str) -> list[str]:
    """The modules an ``import`` or ``from`` line names (empty for others)."""
    words = line.strip().split(None, 1)
    if len(words) < 2 or words[0] not in ("from", "import"):
        return []
    if words[0] == "from":
        return [words[1].split()[0]]
    return [part.split()[0] for part in words[1].split(",") if part.strip()]


def test_imported_modules_parser():
    assert _imported_modules("import jax.numpy as jnp") == ["jax.numpy"]
    assert _imported_modules("from ml_depth_pro_video_tpu.io import image") == [
        "ml_depth_pro_video_tpu.io"]
    assert _imported_modules("import os, jax") == ["os", "jax"]
    assert not any(map(_forbidden, _imported_modules("from ..io.image import load_rgb")))
    assert not _forbidden("ml_depth_pro_video_tpu_torch.ops")
    assert _forbidden("ml_depth_pro_video_tpu.ops") and _forbidden("jax")
    assert _forbidden("optax") and _forbidden("orbax.checkpoint")


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "ml_depth_pro_video_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("torch_*.py"))]
    for path in files:
        for line in path.read_text().splitlines():
            bad = [m for m in _imported_modules(line) if _forbidden(m)]
            assert not bad, f"{path}: {line}"
