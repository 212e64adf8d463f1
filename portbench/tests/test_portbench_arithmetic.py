"""The yardstick's arithmetic against hand-worked numbers, and the manifest."""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import pytest

from portbench import flops, run
from portbench.flops import vit_matmul_flops
from portbench.reference.depth_pro import Arch

ROOT = Path(__file__).resolve().parents[2]
LARGE = Arch()
FAST = dataclasses.replace(LARGE, token_merge_ratio=0.5)


def test_vit_l_pass_of_577_tokens():
    # per block: 24 S D^2 for qkv, proj, fc1, fc2 plus 4 S^2 D for q k^T and p v
    assert 24 * 577 * 1024 ** 2 == 14_520_680_448
    assert 4 * 577 ** 2 * 1024 == 1_363_677_184
    assert LARGE.depth * vit_matmul_flops(LARGE, 577) == 381_224_583_168
    # with the patch embed, 576 patches of 16 x 16 x 3 onto 1024
    assert flops.vit_pass_flops(LARGE) == 381_224_583_168 + 905_969_664


def test_fast_tier_pass():
    # r = int(0.5 * 576) = 288 tokens merge away after block 2: 289 left
    short = 24 * 289 * 1024 ** 2 + 4 * 289 ** 2 * 1024
    blocks = 2 * 15_884_357_632 + 22 * short
    similarity = 2 * 288 * 288 * 1024
    assert flops.vit_pass_flops(FAST, merge=True) == blocks + similarity + 905_969_664


def test_frame_totals():
    # decoder, head and FOV head layer by layer as published, for one 1536^2 frame
    layers = [
        2 * 96**2 * 1024 * 256 + 2 * 96**2 * 256 * 1024 + 2 * 192**2 * 256 * 1024
        + 2 * 384**2 * 256 * 1024,                                   # upsample_latent0
        2 * 96**2 * 1024 * 256 + 2 * 96**2 * 256 * 1024 + 2 * 192**2 * 256 * 1024,
        2 * 96**2 * 1024 * 512 + 2 * 96**2 * 512 * 2048,             # upsample0
        2 * 48**2 * 1024 * 1024 + 2 * 48**2 * 1024 * 4096,           # upsample1
        2 * 24**2 * 1024 * 1024 + 2 * 24**2 * 1024 * 4096,           # upsample2
        2 * 24**2 * 1024 * 4096,                                     # upsample_lowres
        2 * 48**2 * 2048 * 1024,                                     # fuse_lowres
        2 * 384**2 * 9 * 256 * 256 + 2 * 192**2 * 9 * 512 * 256
        + 2 * 96**2 * 9 * 1024 * 256 + 2 * 48**2 * 9 * 1024 * 256,   # decoder convs
        4 * 2 * 9 * 256 * 256 * (768**2 + 384**2 + 192**2 + 96**2) + 2 * 2 * 9 * 256**2 * 48**2,
        2 * 256 * 1024 * (384**2 + 192**2 + 96**2 + 48**2),         # fusion deconvs
        2 * 256 * 256 * (768**2 + 768**2 + 384**2 + 192**2 + 96**2),  # fusion out convs
        2 * 768**2 * 9 * 256 * 128 + 2 * 768**2 * 128 * 512
        + 2 * 1536**2 * 9 * 128 * 32 + 2 * 1536**2 * 32,             # depth head
        2 * 577 * 1024 * 128 + 2 * 24**2 * 9 * 256 * 128 + 2 * 12**2 * 9 * 128 * 64
        + 2 * 6**2 * 9 * 64 * 32 + 2 * 36 * 32,                      # FOV head
    ]
    assert flops.decoder_flops(LARGE) == sum(layers)
    assert flops.frame_flops(LARGE) == 37 * 382_130_552_832 + sum(layers)
    assert flops.frame_flops(LARGE) == 19_247_351_974_144
    assert flops.frame_flops(FAST) == (35 * flops.vit_pass_flops(FAST, merge=True)
                                       + 2 * 382_130_552_832 + sum(layers))


def test_k1_bound_at_70_577_3072():
    b, s, d = 70, 577, 1024
    moved = flops.attention_bytes(b, s, d)
    assert moved == 2 * 70 * 577 * 3072 + 2 * 70 * 577 * 1024 == 330_874_880
    bound = flops.bound_s(flops.attention_flops(b, 16, s, 64), moved)
    assert bound == pytest.approx(330_874_880 / 3.35e12)  # bytes bound it
    assert round(bound * 1e3, 4) == 0.0988
    assert flops.attention_flops(b, 16, s, 64) / 989e12 < bound


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_names_and_units():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["name"] for w in man["workloads"]] + [c["name"] for c in man["configs"]]
    names += [w["traffic"] for w in man["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in man["end_to_end"] + man["per_layer"])
    assert len(set(m["name"] for m in man["end_to_end"] + man["per_layer"])) == len(
        man["end_to_end"]) + len(man["per_layer"])
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in man["workloads"]:
        mix = json.loads((ROOT / "portbench/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench/traffic" / f"{mix['kind']}.py").is_file()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()
    for m in man["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
    assert 0.01 <= min(m["bound"] for m in man["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in man["end_to_end"])


def test_every_metric_cell_reports_what_it_moves():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in man["workloads"]]
    for cell in cells:
        e2e = {m["name"] for m in run.e2e_of(man, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(run.reports(m, cell, e2e) for m in man["per_layer"])
    for m in man["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in run.e2e_of(man, cell)}, (m["name"], cell)


def test_jax_check_compares_top_level_names_whole():
    loaded = ["ml_depth_pro_video_tpu_torch", "ml_depth_pro_video_tpu_torch.ops", "jaxtyping",
              "numpy", "flaxen.x"]
    assert run.forbidden_modules(loaded) == []
    assert run.forbidden_modules(loaded + ["jax.numpy", "ml_depth_pro_video_tpu.ops"]) == [
        "jax.numpy", "ml_depth_pro_video_tpu.ops"]
    assert run.forbidden_modules(["jaxlib", "flax"]) == ["flax", "jaxlib"]
