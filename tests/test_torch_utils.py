"""The port's ``utils/compile_cache.py`` (counterpart of the compile-cache
case of ``tests/test_utils.py``): the JAX package's policy, on inductor's
FX-graph cache."""

import os

import torch
import torch._inductor.config as inductor_config

from ml_depth_pro_video_tpu_torch.utils import compile_cache as cc


def test_compilation_cache_policy(tmp_path, monkeypatch):
    """Off without a card by default, on with an explicit dir or ``force``,
    idempotent, the env opt-out beats ``force``, an env dir turns it on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(inductor_config, "fx_graph_cache", False)
    monkeypatch.delenv("DEPTH_PRO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR", raising=False)

    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    assert cc.enable_compilation_cache() is None
    assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ and not inductor_config.fx_graph_cache

    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    d = cc.enable_compilation_cache(str(tmp_path / "cache"), force=True)
    assert d == str(tmp_path / "cache") and os.path.isdir(d)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == d and inductor_config.fx_graph_cache
    # idempotent: the first successful call wins
    assert cc.enable_compilation_cache("/somewhere/else") == d

    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    monkeypatch.setenv("DEPTH_PRO_COMPILE_CACHE", "off")
    assert cc.enable_compilation_cache(force=True) is None

    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    monkeypatch.setenv("DEPTH_PRO_COMPILE_CACHE", str(tmp_path / "envc"))
    d2 = cc.enable_compilation_cache()
    assert d2 == str(tmp_path / "envc") and os.path.isdir(d2)

    # a card turns it on by default, at the default directory under HOME
    # (in a process where no inductor cache directory is set yet)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("DEPTH_PRO_COMPILE_CACHE")
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    assert cc.enable_compilation_cache() == str(
        tmp_path / "home" / ".cache" / "ml_depth_pro_video_tpu_torch" / "inductor_cache")


def test_compilation_cache_keeps_a_directory_the_caller_set(tmp_path, monkeypatch):
    """A ``TORCHINDUCTOR_CACHE_DIR`` set beforehand survives a runner's call
    without arguments (and is the cache in use); an explicit directory or
    ``DEPTH_PRO_COMPILE_CACHE`` still moves it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(inductor_config, "fx_graph_cache", False)
    monkeypatch.delenv("DEPTH_PRO_COMPILE_CACHE", raising=False)
    mine = str(tmp_path / "mine")
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", mine)

    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    assert cc.enable_compilation_cache() == mine
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == mine and inductor_config.fx_graph_cache

    monkeypatch.setattr(cc, "_state", {"configured": False, "dir": None})
    monkeypatch.setenv("DEPTH_PRO_COMPILE_CACHE", str(tmp_path / "asked"))
    assert cc.enable_compilation_cache() == str(tmp_path / "asked")
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "asked")
