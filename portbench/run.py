"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The cell
comes from ``BENCHMARK.json``; its configuration file, the configuration's
model family (``portbench/families/<family>.py``, named by the file's
``"family"`` key, ``depth_pro`` where it has none), its traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the generator
``portbench/traffic/<kind>.py``) and its limits
(``portbench/limits/<cell>.json``) are found by name, and so is each per-layer
metric's reader (``portbench/metrics/<metric>.py``).

The run makes its weights and inputs from ``--seed``, sets up and warms the
program, measures for ``--seconds``, checks a seeded sample of what the timed
path produced against the family's plain reference, tears down everything it
started (``portbench/lifecycle.py``), and prints as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones read from
a profiled slice of the window), ``device``, with ``--trace 1`` ``breakdown``,
and last ``compared``: each number compared beside its limit, as the last
lines of standard error also give them.

Exit codes: 0 with a result; 2 without one where there is no CUDA card, too
few cards or no program beside the benchmark; 3 without one where ``jax``,
``jaxlib``, ``flax`` or the JAX package was loaded; 1 without one where the
run failed before it could judge its output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402 - the set-up clock starts before any import

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "ml_depth_pro_video_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_depth_pro_video_tpu")
DEFAULT_FAMILY = "depth_pro"  # the family of a configuration file without a "family" key


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = root / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["DEPTH_PRO_COMPILE_CACHE"] = str(cache / "inductor")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: the port's name begins with the JAX
    package's and is not among them."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Ctx:
    """What a traffic kind gets: the cell, its files, the run's flags."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    arch: object
    seed: int
    seconds: float
    trace: bool
    chips: int
    device: str
    teardown: object
    t_start: float
    control: bool = False
    family: object = None  # the configuration's family module, set by ``run_cell``

    def log(self, msg: str) -> None:
        log(f"[{self.name}] {msg}")


@dataclasses.dataclass
class Outcome:
    """What a traffic kind hands back once the program's state is freed."""

    e2e: dict             # end-to-end metric -> value (setup_s aside)
    window_start: float   # perf_counter at the window's start
    attempted: int
    failed: int
    memory_peak: int      # bytes, on the fullest card
    samples: list         # (sample key, answer) of the seeded sample
    inputs: dict          # sample key -> the reference's input, in the family's form
    slice: object = None  # trace.Slice of the profiled part of the window


def peak_bytes(device: str) -> int:
    """The card's peak of allocated memory in this process (0 on the CPU)."""
    import torch

    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def free(device: str) -> None:
    """Return the program's freed memory to the card before the reference runs."""
    import gc

    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def load_module(path: Path, name: str):
    """The module at ``path``, run anew as ``sys.modules[name]`` (where a
    dataclass it defines looks its module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def family_name(config: dict) -> str:
    """The model family a configuration file names (``DEFAULT_FAMILY`` if none)."""
    name = config.get("family", DEFAULT_FAMILY)
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]{0,63}", name):
        raise ValueError(f"a configuration's family is a module name, not {name!r}")
    return name


def family_of(config: dict, root: Path = ROOT):
    """The configuration's family module, ``portbench/families/<family>.py``.

    It supplies ``arch_of(config)``; ``make_weights(arch, seed, device)``;
    the program adapter ``model_config(config)``, ``build_runner(config,
    weights, batch, device, quantize)`` (``quantize``: the control, the
    family's next precision below the configuration's) and ``launches()``;
    ``reference_answers(inputs, weights_fn, arch, dtype, device)``, which
    gives each sample key's reference answer in the configuration's ``dtype``
    and in fp32; ``sample(out)``, what the sample keeps of one answer the
    runner yields; ``arrays(answer)``, the arrays an answer or a reference
    answer yields for comparison; and ``YIELDS``, their names
    (``portbench/correct.py``).
    """
    name = family_name(config)
    path = root / "portbench" / "families" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"the configuration's family {name!r} has no module {path}")
    return load_module(path, f"portbench_family_{name}")


def cell_files(man: dict, name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or
    without that key, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def e2e_of(man: dict, cell: str) -> list[dict]:
    """The end-to-end metrics ``cell`` reports: those that list it, and
    those that list no cells (every cell reports them)."""
    return [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]


def run_cell(ctx: Ctx, man: dict, root: Path = ROOT,
             limits: dict | None = None) -> tuple[dict, dict]:
    """Set up, measure, judge; no teardown. Returns the result line and each
    sampled answer's compared numbers."""
    import torch

    from . import correct

    family = ctx.family = family_of(ctx.config, root)
    kind = load_module(root / "portbench" / "traffic" / f"{ctx.traffic['kind']}.py",
                       f"portbench_traffic_{ctx.traffic['kind']}")
    out: Outcome = kind.run(ctx)
    limits = limits or correct.load_limits(root, ctx.name)
    arch = ctx.arch
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[ctx.config["model"]["precision"]]
    t0 = time.perf_counter()
    refs = family.reference_answers(out.inputs,
                                    lambda: family.make_weights(arch, ctx.seed, ctx.device),
                                    arch, dtype, ctx.device)
    ok, compared, each = correct.judge(out.samples, refs, limits, family)
    ctx.log(f"reference: {len(out.inputs)} inputs in {time.perf_counter() - t0:.3f} s for "
            f"{len(out.samples)} sampled answers; each answer's gaps {json.dumps(each)}")

    e2e_metrics = e2e_of(man, ctx.name)
    e2e_names = {m["name"] for m in e2e_metrics}
    metrics = {}
    device = {"platform": "gpu" if ctx.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu",
              "count": ctx.chips,
              "memory_peak_bytes": int(out.memory_peak)}
    result = {"correct": bool(ok), "attempted": int(out.attempted), "failed": int(out.failed)}
    if ctx.trace:
        sl = out.slice
        mctx = MetricContext(sl, arch)
        for m in man["per_layer"]:
            if not reports(m, ctx.name, e2e_names):
                continue
            reader = load_module(root / "portbench" / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if sl is None or sl.busy_s <= 0:
            raise RuntimeError("the profiled slice has no device time: is the profiler tracing "
                               "the card?")
        device["busy_s"] = sl.busy_s
        device["window_s"] = sl.window_s
        result["breakdown"] = {"device_ops": sl.top_ops(10), "idle_gaps": sl.top_gaps(10)}
    else:
        for m in e2e_metrics:
            value = (out.window_start - ctx.t_start if m["name"] == "setup_s"
                     else out.e2e.get(m["name"]))
            if value is None:
                raise RuntimeError(f"the cell produced no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    result["compared"] = compared
    return result, each


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader gets."""

    slice: object       # trace.Slice of the card, or None
    arch: object


def execute(ctx: Ctx, man: dict, root: Path = ROOT, limits: dict | None = None):
    """``run_cell``, then the teardown whether it passed or raised. Returns
    (the result line, or None if the run raised; the teardown's report)."""
    result = None
    try:
        result, _ = run_cell(ctx, man, root, limits)
    except Exception:  # noqa: BLE001 - reported by the caller, after the teardown
        traceback.print_exc()
    finally:
        report = ctx.teardown.run()
    for err in report["errors"]:
        log(f"[lifecycle] teardown: {err}")
    log(f"[lifecycle] strays ended by the teardown: {report['ended']}")
    log(f"[lifecycle] descendants after the teardown: {report['survivors']}")
    if result is not None and report["survivors"]:
        result["correct"] = False
        log("[lifecycle] a process outlived the teardown: the run fails")
    return result, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env()
    man = manifest()
    cell, config, traffic = cell_files(man, args.workload)
    if importlib.util.find_spec(PROGRAM) is None:
        log(f"the program {PROGRAM} is not beside the benchmark: nothing to measure")
        return 2
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2

    from .lifecycle import Teardown

    arch = family_of(config).arch_of(config)
    ctx = Ctx(args.workload, cell, config, traffic, arch, args.seed, args.seconds,
              bool(args.trace), chips, "cuda", Teardown(), T_START)
    result, report = execute(ctx, man)
    found = forbidden_modules()
    if found:
        log(f"[no-jax] loaded in this process: {found}")
        return 3
    if result is None:
        return 1
    for name, c in result["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
