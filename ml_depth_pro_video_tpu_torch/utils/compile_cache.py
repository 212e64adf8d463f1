"""Persistent cache of compiled programs across processes.

Twin of ``ml_depth_pro_video_tpu/utils/compile_cache.py``, on inductor's
FX-graph cache: a program that ``torch.compile`` (or AOTInductor) compiled
once is read back from disk by the next process instead of compiled again.
The eager runner and the ``torch.export`` artifact (``ckpt/export.py``)
compile nothing, so today the cache only holds what a caller compiles
itself; it is configured where the JAX runner configures its cache, so
compiled paths get it without another call.

Policy (the JAX package's): on by default on a machine with a CUDA device,
off on a CPU-only one. ``DEPTH_PRO_COMPILE_CACHE=<dir>`` sets the location
and also turns the cache on without a card; ``DEPTH_PRO_COMPILE_CACHE=0``
(or ``off`` / ``none`` / ``false``) turns it off. A
``TORCHINDUCTOR_CACHE_DIR`` the caller set beforehand is kept, and used,
unless a directory is asked for by argument or by
``DEPTH_PRO_COMPILE_CACHE``. Safe to call any number of times from any
thread; the first successful call wins.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

LOGGER = logging.getLogger(__name__)

_OFF = ("0", "off", "none", "false")
_DEFAULT_DIR = os.path.join("~", ".cache", "ml_depth_pro_video_tpu_torch", "inductor_cache")
_lock = threading.Lock()
_state: dict = {"configured": False, "dir": None}


def enable_compilation_cache(cache_dir: str | None = None, force: bool = False) -> str | None:
    """Point inductor's FX-graph cache at ``cache_dir`` (default: the
    ``DEPTH_PRO_COMPILE_CACHE`` env var, else a ``TORCHINDUCTOR_CACHE_DIR``
    the caller set, left as it is, else
    ``~/.cache/ml_depth_pro_video_tpu_torch/inductor_cache``). Returns the
    directory in use, or ``None`` when disabled (env opt-out, or no CUDA
    device without the env var or ``force``). Idempotent: the first
    successful call wins."""
    with _lock:
        if _state["configured"]:
            return _state["dir"]
        env = os.environ.get("DEPTH_PRO_COMPILE_CACHE")
        if env is not None and env.strip().lower() in _OFF:
            _state["configured"] = True
            return None
        if cache_dir is None:
            cache_dir = env or os.environ.get("TORCHINDUCTOR_CACHE_DIR") or _DEFAULT_DIR
        if not torch.cuda.is_available() and not force and not env:
            _state["configured"] = True
            return None

        import torch._inductor.config as inductor_config

        cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
        os.makedirs(cache_dir, exist_ok=True)
        # inductor reads its cache root from this variable at each lookup
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache_dir
        inductor_config.fx_graph_cache = True
        _state["configured"] = True
        _state["dir"] = cache_dir
        LOGGER.info("persistent inductor FX-graph cache at %s", cache_dir)
        return cache_dir
