"""Training-state checkpointing on ``torch.save``.

Twin of ``ml_depth_pro_video_tpu/ckpt/checkpointing.py`` (orbax there), and
as generic: a state is any nest of dicts, lists, tensors and numbers that
``torch.load(weights_only=True)`` reads back (the training loop saves
``TrainState.to_dict()``). Step ``n`` lives in ``<directory>/<n>/state.pt``.
A save writes into a temporary directory beside it and renames it into
place, so a killed save never leaves a step that ``latest_step`` would
report; the oldest steps beyond ``max_to_keep`` are deleted after it. Saving
a step that is already the latest is a no-op (orbax raises there).

A run over several ranks saves one checkpoint in the one-rank layout, as
orbax saves the JAX package's global arrays: every rank gathers the state
(``TrainState.to_dict``, collective) and calls :func:`save_train_state`, rank
0 writes it, and every rank waits at a barrier until it has. A restore reads
the one-rank state on every rank, and the caller cuts it for the mesh it
runs on (``TrainState.from_dict(layout=)``), so a checkpoint of a tp or pp
run restores into a one-rank run bit for bit, and the reverse.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

from ..parallel import multihost

STATE_FILE = "state.pt"


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isfile(os.path.join(directory, name, STATE_FILE)))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_train_state(directory: str, state: dict, step: int, max_to_keep: int = 3) -> None:
    """Write ``state`` as step ``step``; across ranks every rank calls this,
    rank 0 writes and all wait until it has."""
    if multihost.is_primary():
        _save(directory, state, int(step), max_to_keep)
    multihost.barrier("save_train_state")


def _save(directory: str, state: dict, step: int, max_to_keep: int) -> None:
    if latest_step(directory) == step:
        return  # already saved
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=directory)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        final = os.path.join(directory, str(step))
        if os.path.isdir(final):  # a step older than the latest, saved again
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(directory)[:-max_to_keep] if max_to_keep else []:
        shutil.rmtree(os.path.join(directory, str(old)))


def restore_train_state(directory: str, step: int | None = None, device=None) -> dict | None:
    """The state saved at ``step`` (default: the latest), or None when there
    is none; its tensors go to ``device``, by default where they were saved."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    return torch.load(os.path.join(directory, str(step), STATE_FILE), map_location=device,
                      weights_only=True)
