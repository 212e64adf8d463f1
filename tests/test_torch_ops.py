"""The PyTorch port's ops against the JAX package's, on the same numpy inputs.

Both sides run fp32 on the CPU unless a test says otherwise; tolerances
are stated per test (the JAX package's own bars, e.g. 2e-4 for attention,
tests/test_ops.py:139, and the < 2e-2-of-scale bf16 resblock band,
tests/test_ops.py:263). The CUDA kernels themselves cannot run here: their
wrappers take the plain versions for CPU tensors, which is what these
tests hold against JAX (tests/test_torch_kernels.py covers the card).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_depth_pro_video_tpu.ops import attention as jattn
from ml_depth_pro_video_tpu.ops import conv as jconv
from ml_depth_pro_video_tpu.ops import resblock as jres
from ml_depth_pro_video_tpu.ops.norm import layer_norm as j_layer_norm
from ml_depth_pro_video_tpu.ops.resize import resize2d as j_resize2d
from ml_depth_pro_video_tpu_torch.kernels import loader
from ml_depth_pro_video_tpu_torch.ops import attention as tattn
from ml_depth_pro_video_tpu_torch.ops import conv as tconv
from ml_depth_pro_video_tpu_torch.ops import resblock as tres
from ml_depth_pro_video_tpu_torch.ops.norm import layer_norm as t_layer_norm
from ml_depth_pro_video_tpu_torch.ops.resize import resize2d as t_resize2d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=rtol, atol=atol)


def test_layer_norm_matches_jax():
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    got = t_layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    _close(got, j_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)), 1e-5, 1e-5)


def test_layer_norm_keeps_bf16_input_dtype():
    x = torch.randn(3, 8).bfloat16()
    assert t_layer_norm(x, torch.ones(8), torch.zeros(8)).dtype == torch.bfloat16


@pytest.mark.parametrize("k,stride,padding,bias", [(3, 1, 1, True), (1, 1, 0, False),
                                                    (3, 2, 1, True), (6, 1, 0, True)])
def test_conv2d_matches_jax(k, stride, padding, bias):
    rng = _rng(k * 10 + stride)
    x = rng.standard_normal((2, 12, 12, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32) if bias else None
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       None if b is None else torch.from_numpy(b), stride, padding)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                       stride, padding)
    _close(got, ref, 1e-5, 1e-5)


def test_conv_transpose2x2_and_depth_to_space_match_jax():
    rng = _rng(2)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4 * 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    got = tconv.conv_transpose2x2(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, jconv.conv_transpose2x2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           1e-5, 1e-5)
    y = rng.standard_normal((2, 3, 4, 12)).astype(np.float32)
    _close(tconv.depth_to_space2x2(torch.from_numpy(y)), jconv.depth_to_space2x2(jnp.asarray(y)),
           0, 0)


def test_linear_matches_jax():
    rng = _rng(3)
    x = rng.standard_normal((4, 3, 10)).astype(np.float32)
    w = rng.standard_normal((10, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    got = tconv.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, jconv.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 1e-5, 1e-5)


def test_fold_deconv_conv3x3_matches_jax_and_is_exact():
    rng = _rng(4)
    wd = rng.standard_normal((6, 4 * 5)).astype(np.float32)
    bd = rng.standard_normal(5).astype(np.float32)
    wc = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    got = tconv.fold_deconv2x2_conv3x3(torch.from_numpy(wd), torch.from_numpy(bd),
                                       torch.from_numpy(wc))
    _close(got, jconv.fold_deconv2x2_conv3x3(jnp.asarray(wd), jnp.asarray(bd), jnp.asarray(wc)),
           1e-5, 1e-5)
    # the fold equals deconv -> conv3x3 (no conv bias), borders included
    x = torch.from_numpy(rng.standard_normal((1, 7, 9, 6)).astype(np.float32))
    direct = tconv.conv2d(tconv.conv_transpose2x2(x, torch.from_numpy(wd), torch.from_numpy(bd)),
                          torch.from_numpy(wc), padding=1)
    xo = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    folded = tconv.depth_to_space2x2(tconv.conv2d(xo, got, padding=1))
    torch.testing.assert_close(folded, direct, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_hw,out_hw,mode", [
    ((1536, 1536), (768, 768), "bilinear"),   # encoder pyramid level 1
    ((1536, 1536), (384, 384), "bilinear"),   # encoder level 2 and FOV input
    ((300, 410), (1536, 1536), "bilinear"),   # infer(): frame -> network size
    ((1536, 1536), (300, 410), "bilinear"),   # infer(): inverse depth back
    ((40, 50), (23, 61), "bicubic"),
])
def test_resize2d_matches_jax(in_hw, out_hw, mode):
    ch = 1 if in_hw == (1536, 1536) and out_hw == (300, 410) else 3
    x = _rng(5).standard_normal((1, *in_hw, ch)).astype(np.float32)
    got = t_resize2d(torch.from_numpy(x), out_hw, mode=mode)
    assert got.shape == (1, *out_hw, ch) and got.dtype == torch.float32
    _close(got, j_resize2d(jnp.asarray(x), out_hw, mode=mode), 1e-5, 1e-5)


def test_resize2d_keeps_dtype_and_leading_dims():
    x = torch.randn(2, 3, 16, 16, 4).bfloat16()
    y = t_resize2d(x, (8, 12))
    assert y.shape == (2, 3, 8, 12, 4) and y.dtype == torch.bfloat16


@pytest.mark.parametrize("shape,heads", [((2, 33, 192), 4), ((2, 33, 768), 4)])
def test_attention_plain_matches_jax_kernel_and_xla(shape, heads):
    qkv = _rng(6).standard_normal(shape).astype(np.float32)
    got = tattn.attention_packed_reference(torch.from_numpy(qkv), heads)
    pallas = jattn.flash_attention_packed(jnp.asarray(qkv), heads, interpret=True)
    xla = jattn.xla_attention_packed(jnp.asarray(qkv), heads)
    _close(got, pallas, 2e-4, 2e-4)
    _close(got, xla, 2e-4, 2e-4)


def test_attention_packed_wrapper_on_cpu_is_plain_and_differentiable():
    qkv = torch.randn(2, 9, 3 * 32, dtype=torch.float64, requires_grad=True)
    launches = tattn.K1.launches
    out = tattn.attention_packed(qkv, 2)
    torch.testing.assert_close(out, tattn.attention_packed_reference(qkv, 2))
    assert tattn.K1.launches == launches  # no kernel on a CPU tensor
    assert torch.autograd.gradcheck(lambda t: tattn.attention_packed(t, 2), (qkv,))


@pytest.mark.parametrize("shape,heads,dtype", [((1, 4, 3 * 24), 1, torch.float32),
                                               ((1, 4, 3 * 64), 2, torch.float16)])
def test_attention_kernel_wrapper_rejects_what_k1_does_not_take(shape, heads, dtype):
    with pytest.raises(ValueError):
        tattn._attention_packed_cuda(torch.zeros(shape, dtype=dtype), heads)


def _log_sizes(rng, shape):
    """A ToMe key bias: log of integer token counts >= 1."""
    return np.log(rng.integers(1, 5, shape)).astype(np.float32)


@pytest.mark.parametrize("block_heads", [None, 2])  # full width and head-grouped
@pytest.mark.parametrize("shape,heads", [((2, 33, 192), 4), ((2, 33, 3 * 4 * 64), 4)])
def test_attention_bias_plain_matches_jax_kernel_and_xla(shape, heads, block_heads):
    rng = _rng(9)
    qkv = rng.standard_normal(shape).astype(np.float32)
    bias = _log_sizes(rng, shape[:2])
    got = tattn.attention_packed_reference(torch.from_numpy(qkv), heads, torch.from_numpy(bias))
    pallas = jattn.flash_attention_packed_bias(jnp.asarray(qkv), jnp.asarray(bias), heads,
                                               interpret=True, block_heads=block_heads)
    xla = jattn.xla_attention_packed(jnp.asarray(qkv), heads, key_bias=jnp.asarray(bias))
    _close(got, pallas, 1e-3, 1e-4)
    _close(got, xla, 1e-3, 1e-4)


def test_attention_bias_wrapper_gradients_match_jax_vjp():
    """The K3 wrapper's backward (plain math on the CPU) against jax.vjp of
    xla_attention_packed, for qkv and for the bias."""
    import jax

    rng = _rng(10)
    qkv = rng.standard_normal((2, 17, 3 * 2 * 16)).astype(np.float32)
    bias = _log_sizes(rng, (2, 17))
    g = rng.standard_normal((2, 17, 2 * 16)).astype(np.float32)
    t_qkv = torch.from_numpy(qkv).requires_grad_(True)
    t_bias = torch.from_numpy(bias).requires_grad_(True)
    tattn.attention_packed(t_qkv, 2, t_bias).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda q, kb: jattn.xla_attention_packed(q, 2, kb), jnp.asarray(qkv),
                     jnp.asarray(bias))
    j_qkv, j_bias = vjp(jnp.asarray(g))
    _close(t_qkv.grad, j_qkv, 1e-3, 1e-4)
    _close(t_bias.grad, j_bias, 1e-3, 1e-4)


def test_attention_bias_wrapper_on_cpu_is_plain_and_differentiable():
    qkv = torch.randn(2, 9, 3 * 32, dtype=torch.float64, requires_grad=True)
    bias = torch.log(torch.randint(1, 4, (2, 9)).double()).requires_grad_(True)
    launches = (tattn.K1.launches, tattn.K3.launches)
    out = tattn.attention_packed(qkv, 2, bias)
    torch.testing.assert_close(out, tattn.attention_packed_reference(qkv, 2, bias))
    assert (tattn.K1.launches, tattn.K3.launches) == launches
    assert torch.autograd.gradcheck(lambda t, b: tattn.attention_packed(t, 2, b), (qkv, bias))


@pytest.mark.parametrize("bias_shape,bias_device", [((2, 8), "cpu"), ((1, 9), "cpu"),
                                                    ((2, 9), "meta")])
def test_attention_kernel_wrapper_rejects_a_bias_k3_does_not_take(bias_shape, bias_device):
    with pytest.raises(ValueError, match="key_bias"):
        tattn._attention_packed_cuda(torch.zeros(2, 9, 3 * 32), 2,
                                     torch.zeros(bias_shape, device=bias_device))


@pytest.mark.parametrize("shape", [(2, 3, 9, 16), (1, 4, 33, 64)])
def test_unpacked_attention_matches_jax(shape):
    rng = _rng(11)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = jattn._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(tattn.attention_reference(tq, tk, tv), ref, 1e-3, 1e-4)
    launches = tattn.K4.launches
    _close(tattn.multi_head_attention(tq, tk, tv), ref, 1e-3, 1e-4)
    assert tattn.K4.launches == launches  # no kernel on a CPU tensor
    bias = _log_sizes(rng, (shape[0], shape[2]))
    _close(tattn.attention_reference(tq, tk, tv, torch.from_numpy(bias)),
           jattn._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias)), 1e-3, 1e-4)


def test_multi_head_attention_gradients_match_jax_vjp():
    import jax

    rng = _rng(12)
    q, k, v, g = (rng.standard_normal((1, 2, 7, 16)).astype(np.float32) for _ in range(4))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tattn.multi_head_attention(*ts).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jattn._xla_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for t, j in zip(ts, vjp(jnp.asarray(g))):
        _close(t.grad, j, 1e-3, 1e-4)
    q64 = [torch.randn(1, 2, 5, 16, dtype=torch.float64, requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(tattn.multi_head_attention, q64)


@pytest.mark.parametrize("shapes,dtypes", [
    (((1, 2, 4, 24),) * 3, (torch.float32,) * 3),                   # head dim 24
    (((1, 2, 4, 32),) * 3, (torch.float16,) * 3),                   # fp16
    (((1, 2, 4, 32), (1, 2, 5, 32), (1, 2, 4, 32)), (torch.float32,) * 3),  # shapes differ
    (((1, 2, 4, 32),) * 3, (torch.float32, torch.bfloat16, torch.float32)),  # dtypes differ
    (((2, 4, 32),) * 3, (torch.float32,) * 3),                      # not 4-d
])
def test_unpacked_kernel_wrapper_rejects_what_k4_does_not_take(shapes, dtypes):
    q, k, v = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises(ValueError):
        tattn._attention_bhsd_cuda(q, k, v)


def _resblock_inputs(shape, seed, dtype):
    rng = _rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 0.1
    ws = [rng.standard_normal((3, 3, c, c)).astype(np.float32) * 0.05 for _ in range(2)]
    bs = [rng.standard_normal(c).astype(np.float32) * 0.1 for _ in range(2)]
    j = [jnp.asarray(a, dtype) for a in (x, ws[0], bs[0], ws[1], bs[1])]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    t = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt) for a in j]
    return j, t


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (1, 24, 20, 128)])
def test_resblock_plain_bf16_matches_jax_pallas_kernel(shape):
    j, t = _resblock_inputs(shape, 7, jnp.bfloat16)
    ref = np.asarray(jres.residual_block(*j, interpret=True).astype(jnp.float32))
    got = tres.residual_block_reference(*t).float().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err  # bf16 tap-accumulation band (tests/test_ops.py:263)


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (1, 24, 20, 128)])
def test_resblock_plain_fp32_matches_jax_xla(shape):
    j, t = _resblock_inputs(shape, 8, jnp.float32)
    _close(tres.residual_block_reference(*t), jres.residual_block(*j, impl="xla"), 1e-5, 1e-5)


def test_residual_block_routes_like_jax(monkeypatch):
    """bf16 square blocks at W <= 96 take the fused wrapper; fp32 and wider
    levels take the plain composition (as the JAX package's gate: on the H100
    K2 did not beat the plain composition by 10% at 192^2, PERF.md), and so do
    blocks wider than K2's 256 channels."""
    calls = []
    monkeypatch.setattr(tres, "fused_residual_block",
                        lambda *a: calls.append(a[0].shape) or tres.residual_block_reference(*a))
    for c in (16, 264):
        w, b = torch.randn(3, 3, c, c) * 0.1, torch.randn(c) * 0.1
        for shape, dtype in [((1, 8, 96, c), torch.bfloat16), ((1, 8, 97, c), torch.bfloat16),
                             ((1, 8, 8, c), torch.float32)]:
            tres.residual_block(torch.randn(shape).to(dtype), w, b, w, b)
    assert calls == [(1, 8, 96, 16)]


def test_fused_residual_block_on_cpu_is_plain_and_differentiable():
    c = 8
    x = torch.randn(1, 5, 6, c, dtype=torch.float64, requires_grad=True)
    w1, w2 = (torch.randn(3, 3, c, c, dtype=torch.float64, requires_grad=True) for _ in range(2))
    b1, b2 = (torch.randn(c, dtype=torch.float64, requires_grad=True) for _ in range(2))
    launches = tres.K2.launches
    out = tres.fused_residual_block(x, w1, b1, w2, b2)
    torch.testing.assert_close(out, tres.residual_block_reference(x, w1, b1, w2, b2))
    assert tres.K2.launches == launches
    assert torch.autograd.gradcheck(tres.fused_residual_block, (x, w1, b1, w2, b2))


@pytest.mark.parametrize("shape,dtype,w_device,b_len", [
    ((1, 4, 4, 12), torch.bfloat16, "cpu", 12),   # channels not a multiple of 8
    ((1, 4, 4, 16), torch.float32, "cpu", 16),    # not bf16
    ((1, 4, 4, 16), torch.bfloat16, "meta", 16),  # weights on another device
    ((1, 4, 4, 16), torch.bfloat16, "cpu", 8),    # bias of the wrong length
    ((1, 4, 4, 264), torch.bfloat16, "cpu", 264),  # wider than one pass of K2's warps
])
def test_resblock_kernel_wrapper_rejects_what_k2_does_not_take(shape, dtype, w_device, b_len):
    c = shape[-1]
    w, b = torch.zeros(3, 3, c, c, device=w_device), torch.zeros(b_len)
    with pytest.raises(ValueError):
        tres._resblock_cuda(torch.zeros(shape, dtype=dtype), w, b, w, b)


class _FakeLibrary:
    def __init__(self, code):
        self.code = code

    def fake_entry(self, *args):
        return self.code


def test_kernel_counts_only_successful_launches(monkeypatch):
    k = loader.Kernel("fake", "fake_entry", "src.cu", "file.py:1")
    monkeypatch.setattr(loader, "load_library", lambda: _FakeLibrary(0))
    k.launch(1, 2)
    k.launch()
    assert k.launches == 2
    monkeypatch.setattr(loader, "load_library", lambda: _FakeLibrary(701))
    with pytest.raises(loader.KernelLaunchError, match="cudaErrorLaunchOutOfResources"):
        k.launch()
    assert k.launches == 2


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if any("{bad}" in a for a in args):
    sys.stderr.write("error: refused\\n")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").write("built")
"""


def _fake_nvcc(tmp_path, monkeypatch, bad="no-such-source"):
    nvcc, log = tmp_path / "nvcc", tmp_path / "nvcc.log"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log), bad=bad))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    (tmp_path / "cuda" / "bin" / "nvcc").symlink_to(nvcc)
    return log


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    log = _fake_nvcc(tmp_path, monkeypatch)
    lib = tmp_path / "out" / loader.LIBRARY_NAME
    loader._build(lib)
    assert lib.read_text() == "built"
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(loader.sources()) == 2
    assert sorted(c.split()[-1] for c in compiles) == sorted(map(str, loader.sources()))
    assert len(calls) == 3 and "-shared" in calls[-1].split()
    assert sorted(p.name for p in lib.parent.iterdir()) == [loader.LIBRARY_NAME]


def test_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    _fake_nvcc(tmp_path, monkeypatch, bad="resblock.cu")
    lib = tmp_path / "out" / loader.LIBRARY_NAME
    with pytest.raises(loader.KernelBuildError, match="refused"):
        loader._build(lib)
    assert not lib.exists() and list(lib.parent.iterdir()) == []


def test_build_time_script_times_both_ways(monkeypatch, tmp_path):
    log = _fake_nvcc(tmp_path, monkeypatch)
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_build_time.py"
    spec = importlib.util.spec_from_file_location("torch_build_time", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    times = script.time_builds(("parallel", "serial"))
    assert [len(times["parallel"]), len(times["serial"])] == [1, 1]
    serial = log.read_text().splitlines()[-1].split()
    assert "-shared" in serial and "-c" not in serial
    assert serial[-len(loader.sources()):] == list(map(str, loader.sources()))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(loader.os.path, "exists", lambda p: False)
    with pytest.raises(loader.KernelBuildError):
        loader._nvcc()


def test_library_path_is_keyed_by_sources_and_flags(monkeypatch):
    path = loader.library_path()
    assert path.parent.parent == loader.BUILD_ROOT and path.name == loader.LIBRARY_NAME
    assert [p.name for p in loader.sources()] == ["attention_packed.cu", "resblock.cu"]
    monkeypatch.setattr(loader, "NVCC_FLAGS", loader.NVCC_FLAGS + ("-lineinfo",))
    assert loader.library_path() != path


def test_build_root_is_checkout_build_dir_else_user_cache(monkeypatch, tmp_path):
    repo = loader.PACKAGE_DIR.parent
    assert loader._build_root() == repo / "build" / "torch_kernels"
    # an installed copy (no pyproject.toml beside the package) builds into the user cache
    monkeypatch.setattr(loader, "PACKAGE_DIR", tmp_path / "site-packages" / "pkg")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert loader._build_root() == (tmp_path / "cache" / "ml_depth_pro_video_tpu_torch"
                                    / "torch_kernels")
