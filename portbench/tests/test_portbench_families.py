"""A configuration of another model family is new files only.

The toy window family (``portbench/tests/toy_family/``) is laid out as the
files a new family adds under ``portbench/``: its configuration
(``configs/toy_window.json``, ``"family": "toy_window"``), its family module
(``families/``), its plain reference (``reference/``), the program under
test (``stubs/``: a runner whose answers each depend on a window of 8
frames), a traffic kind and mix (``traffic/``) and the cell's limits
(``limits/``). Each case copies the benchmark into a temporary root, adds
those files and the cell to that copy's ``BENCHMARK.json``, and drives the
cell through the harness as it is, on the CPU.
"""

from __future__ import annotations

import ast
import json
import shutil
import time
from pathlib import Path

import pytest

from portbench import correct, run
from portbench.lifecycle import Teardown

ROOT = run.ROOT
TOY = Path(__file__).resolve().parent / "toy_family"
CELL = "toy_window_w8"


def toy_root(tmp: Path, shift: int = 0, limits: dict | None = None) -> Path:
    """A copy of the benchmark with the toy family's files added; ``shift``
    plants the fault of an answer taken from another position in its window."""
    root = tmp / "checkout"
    root.mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in TOY.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            dest = root / "portbench" / path.relative_to(TOY)
            assert not dest.exists(), f"{dest} is a file the benchmark already has"
            dest.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, dest)
    stub = root / "portbench" / "stubs" / "toy_window.py"
    stub.write_text(stub.read_text().replace("SHIFT = 0", f"SHIFT = {shift}"))
    if limits is not None:
        (root / "portbench" / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy_window", "source": "portbench/tests/toy_family",
                           "file": "portbench/configs/toy_window.json", "reduced": [],
                           "why": "a toy family whose answers depend on a window of frames"})
    man["workloads"].append({"name": CELL, "config": "toy_window", "traffic": "toy_clips",
                             "chips": 1, "why": "windows of 8 frames, 2 carried over"})
    for metric in man["end_to_end"]:
        if metric["name"] == "frames_per_s":
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run_toy(root: Path, seed: int = 2 ** 31 + 5):
    man = run.manifest(root)
    cell, config, traffic = run.cell_files(man, CELL, root)
    arch = run.family_of(config, root).arch_of(config)
    ctx = run.Ctx(CELL, cell, config, traffic, arch, seed, 1.0, False, 1, "cpu", Teardown(),
                  time.perf_counter())
    return run.execute(ctx, man, root)


def test_toy_family_runs_end_to_end(tmp_path, capsys):
    result, report = run_toy(toy_root(tmp_path))
    log = capsys.readouterr().err
    assert report["survivors"] == []
    assert result is not None, log
    assert result["correct"] is True, result["compared"]
    assert set(result["compared"]) == {"depth_rel"}
    assert result["attempted"] >= 1 and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert "depth_gap" in log and "fpx" not in log


def test_toy_answer_from_the_wrong_position_fails(tmp_path):
    result, report = run_toy(toy_root(tmp_path, shift=1))
    assert report["survivors"] == [] and result is not None
    assert result["correct"] is False
    assert result["compared"]["depth_rel"]["value"] > 10 * result["compared"]["depth_rel"]["limit"]


@pytest.mark.parametrize("name", correct.FPX_NAMES)
def test_a_limit_on_f_px_fails_to_load_for_a_family_without_it(tmp_path, name):
    root = toy_root(tmp_path, limits={"depth_rel": 3.0, name: 0.01})
    with pytest.raises(ValueError, match=f"{name}.*'toy_window'"):
        correct.load_limits(root, CELL)
    assert correct.load_limits(toy_root(tmp_path / "plain"), CELL) == {"depth_rel": 3.0}


@pytest.mark.parametrize("config", [c["file"] for c in run.manifest()["configs"]])
def test_existing_configurations_are_depth_pro(config):
    from portbench import program, weights
    from portbench.reference import depth_pro

    data = json.loads((ROOT / config).read_text())
    assert "family" not in data and run.family_name(data) == "depth_pro"
    family = run.family_of(data)
    assert Path(family.__file__) == ROOT / "portbench" / "families" / "depth_pro.py"
    assert family.arch_of is depth_pro.arch_of and family.make_weights is weights.make_weights
    assert (family.build_runner, family.launches, family.model_config) == (
        program.build_runner, program.launches, program.model_config)
    assert correct.names_of(family.YIELDS) == correct.NAMES


@pytest.mark.parametrize("name", ["../weights", "depth-pro", "", 3])
def test_a_family_is_named_by_a_module_name(name):
    with pytest.raises(ValueError):
        run.family_of({"family": name})


DEPTH_PRO_MODULES = {"portbench.reference.depth_pro", "portbench.weights", "portbench.program"}


@pytest.mark.parametrize("path", ["run.py", "calibrate.py", "correct.py", "traffic/stream.py"])
def test_the_harness_names_no_depth_pro_module(path):
    file = ROOT / "portbench" / path
    package = ".".join(("portbench",) + Path(path).parent.parts)
    imported = set()
    for node in ast.walk(ast.parse(file.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            base = parts[:len(parts) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            imported |= {module} | {f"{module}.{a.name}" for a in node.names}
    assert not imported & DEPTH_PRO_MODULES, (path, imported & DEPTH_PRO_MODULES)
