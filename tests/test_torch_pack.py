"""The port's packed depth fetch (``video/pack.py``) against the JAX package's.

The same numpy depth maps go through the port's ``pack_depth_u16`` (torch,
fp32 on the CPU) and the JAX package's. The codes are equal wherever the two
backends' fp32 ``log`` agree and within one step elsewhere: XLA's CPU ``log``
is one ulp off the correctly rounded value on 4-8% of inputs, torch's is not,
and a one-ulp change moves a code where the value sits at a code boundary.
Over the model's whole output range that leaves at least 99.99% of codes
equal; at an indoor range of 0.5-12 m, where a code step is smaller, about
99.97%. ``log_min`` and ``log_scale`` agree within rtol 1e-6. The LUT unpack
is bit-identical to the elementwise form and to the JAX package's, and the
round trip stays within ``max_rel_error`` of the frame's own log spread
plus ``FP32_SLACK`` for the fp32 ``log`` and ``exp`` of log depths up to 9.2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_depth_pro_video_tpu.video import pack as jpack
from ml_depth_pro_video_tpu_torch.video import pack as tpack

CODE_SHARE = 0.9999  # over the model's whole output range
FP32_SLACK = 1e-5


def _depth_maps(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "wide":  # log-uniform over the model's whole output clamp
        return np.exp(rng.uniform(np.log(1e-4), np.log(1e4), (3, 64, 80))).astype(np.float32)
    if kind == "indoor":
        return rng.uniform(0.5, 12.0, (2, 90, 120)).astype(np.float32)
    if kind == "constant":
        return np.full((2, 8, 8), 3.7, np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["wide", "indoor", "constant"])
def test_pack_matches_jax(kind):
    d = _depth_maps(kind)
    u, lmin, lscale = tpack.pack_depth_u16(torch.from_numpy(d))
    ju, jlmin, jlscale = (np.asarray(a) for a in jpack.pack_depth_u16(d))
    assert u.dtype == torch.uint16 and u.shape == d.shape
    assert lmin.shape == lscale.shape == (d.shape[0],)
    codes = u.numpy().astype(np.int64) - ju.astype(np.int64)
    logs_agree = np.asarray(jax.jit(jnp.log)(d)) == torch.log(torch.from_numpy(d)).numpy()
    assert (codes[logs_agree] == 0).all() and np.abs(codes).max() <= 1
    if kind == "wide":
        assert np.mean(codes == 0) >= CODE_SHARE
    np.testing.assert_allclose(lmin.numpy(), jlmin, rtol=1e-6)
    np.testing.assert_allclose(lscale.numpy(), jlscale, rtol=1e-6)


def test_lut_unpack_is_bit_identical():
    rng = np.random.default_rng(7)
    u = rng.integers(0, 65536, (3, 17, 23)).astype(np.uint16)
    lmin = rng.uniform(-2, 0, 3).astype(np.float32)
    lscale = rng.uniform(0, 1e-4, 3).astype(np.float32)
    direct = np.exp(u.astype(np.float32) * lscale[:, None, None] + lmin[:, None, None])
    got = tpack.unpack_depth_u16(u, lmin, lscale)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_array_equal(got, jpack.unpack_depth_u16(u, lmin, lscale))
    # one frame without a batch dim, scalars for its parameters
    np.testing.assert_array_equal(tpack.unpack_depth_u16(u[1], lmin[1], lscale[1]), direct[1])


def test_unpack_refuses_other_dtypes_and_shapes():
    with pytest.raises(TypeError):
        tpack.unpack_depth_u16(np.zeros((1, 4, 4), np.int32), [0.0], [1.0])
    with pytest.raises(ValueError):
        tpack.unpack_depth_u16(np.zeros((3, 4, 4), np.uint16), [0.0, 1.0], [1.0, 1.0])


@pytest.mark.parametrize("kind", ["wide", "indoor", "constant"])
def test_round_trip_within_max_rel_error(kind):
    d = _depth_maps(kind, seed=1)
    u, lmin, lscale = tpack.pack_depth_u16(torch.from_numpy(d))
    out = tpack.unpack_depth_u16(u.numpy(), lmin.numpy(), lscale.numpy())
    rel = np.abs(out - d) / d
    spread = np.log(d.max(axis=(1, 2)) / d.min(axis=(1, 2)))
    assert np.all(rel <= np.array([tpack.max_rel_error(s) for s in spread])[:, None, None]
                  + FP32_SLACK)
    assert rel.max() <= tpack.max_rel_error() + FP32_SLACK
    if kind == "constant":
        assert u.numpy().max() == 0 and (lscale == 0).all()
        np.testing.assert_allclose(out, d, rtol=1e-6)


def test_max_rel_error_matches_jax():
    assert tpack.max_rel_error() == jpack.max_rel_error() < 1.5e-4
    assert tpack.max_rel_error(3.0) == jpack.max_rel_error(3.0)


def test_pack_takes_bf16_depth():
    d = torch.from_numpy(_depth_maps("indoor")).bfloat16()
    u, lmin, lscale = tpack.pack_depth_u16(d)
    out = tpack.unpack_depth_u16(u.numpy(), lmin.numpy(), lscale.numpy())
    np.testing.assert_allclose(out, d.float().numpy(), rtol=tpack.max_rel_error() + 1e-6)
