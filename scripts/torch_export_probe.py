"""Probe the exported program (``ckpt/export.py``) on the card: is the
balanced tier deterministic?

    python3 scripts/torch_export_probe.py

Needs a CUDA card and nvcc (the kernels build at first use; ~2 min in all).
At the ``large`` preset, bf16, batch 2, 1536x1536 uint8 frames, balanced
tier (whose ToMe merge sums with ``scatter_add``): eager against eager, the
artifact against itself and against eager, with and without
``torch.use_deterministic_algorithms(True)``.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def export(speed: str) -> str:
    path = C.EXPORT_DIR / f"probe_{speed}.pt2"
    C.export_main(["-o", str(path), "--model", "large", "--precision", "bf16", "--batch_size",
                   str(C.BATCH), "--speed", speed, "--device", "cuda"])
    return str(path)


def probe_determinism(frames: list) -> None:
    path = export("balanced")
    served, _ = C.first_batch_s(frames, speed="balanced", exported_path=path)
    eager, _ = C.first_batch_s(frames, speed="balanced")

    def same(a, b):
        return (all(np.array_equal(x["depth"], y["depth"]) for x, y in zip(a, b)),
                max(float(np.abs(x["depth"] - y["depth"]).max()) for x, y in zip(a, b)))

    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        runs = {"served": [list(served.depth_stream(frames)) for _ in range(2)],
                "eager": [list(eager.depth_stream(frames)) for _ in range(2)]}
        C.log(f"[determinism] deterministic algorithms {deterministic}: (equal, max |depth diff|) "
              f"eager/eager {same(*runs['eager'])}, artifact/artifact {same(*runs['served'])}, "
              f"artifact/eager {same(runs['served'][0], runs['eager'][0])}")
    torch.use_deterministic_algorithms(False)


def main() -> int:
    C.phase_device()
    C.phase_build()
    C.EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(C.SEED + 11)
    frames = [rng.integers(0, 256, (1536, 1536, 3), dtype=np.uint8) for _ in range(4)]
    probe_determinism(frames)
    C.log(f"[done] {C.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
