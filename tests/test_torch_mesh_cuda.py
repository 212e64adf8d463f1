"""The Poisson conjugate gradient of ``geom/mesh.py`` on the card against the
same solve on the CPU, at 64^3.

``tests/test_torch_mesh.py`` holds the CPU solve against the JAX package's
(max |diff| within ``CHI_BOUND`` of max |chi|); this file holds the card's
against the CPU's under the same bound, and needs no jax: on a machine with
the card run ``python -m pytest --noconftest tests/test_torch_mesh_cuda.py``.
Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
Both sides run fp32 in the same operation order; only the sums' order
differs, so the iterations run agree within one (an exit test that falls on
its boundary) and the inside/outside split at the iso level is the same.
"""

import numpy as np
import pytest
import torch

from ml_depth_pro_video_tpu_torch.geom import mesh

pytestmark = pytest.mark.cuda
CHI_BOUND = 1e-4  # max |chi_card - chi_cpu| over max |chi_cpu|


@pytest.fixture
def sphere():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(6000, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts, -mesh.estimate_normals(pts, radius=0.3, camera=(0, 0, 0))


@pytest.mark.parametrize("screen", [0.0, 4.0])
def test_poisson_cg_card_matches_cpu(sphere, screen):
    pts, nrm = sphere
    res = 64
    origin, spacing = mesh._grid_frame(pts, res)
    b, diag, _ = mesh._poisson_system(pts, nrm, res, origin, spacing, screen)
    out = {}
    for dev in ("cuda", "cpu"):
        bt = torch.as_tensor(b.astype(np.float32), device=dev)
        d = None if diag is None else torch.as_tensor(diag.astype(np.float32), device=dev)
        x, n = mesh._poisson_cg(bt, d, 300, 1e-6)
        out[dev] = (x.cpu().numpy().astype(np.float64), n)
    (card, n_card), (cpu, n_cpu) = out["cuda"], out["cpu"]
    assert abs(n_card - n_cpu) <= 1
    assert np.abs(card - cpu).max() <= CHI_BOUND * np.abs(cpu).max()
    ijk = np.clip(np.round((pts - origin) / spacing).astype(np.int64), 0, res - 1)
    iso = {k: float(np.mean(v[ijk[:, 0], ijk[:, 1], ijk[:, 2]])) for k, v in
           (("card", card), ("cpu", cpu))}
    np.testing.assert_array_equal(card > iso["card"], cpu > iso["cpu"])
    vc, fc = mesh.marching_tetrahedra(card, iso["card"], origin, spacing)
    vh, fh = mesh.marching_tetrahedra(cpu, iso["cpu"], origin, spacing)
    # unscreened, a pair of coincident edge points may round to two dedupe keys
    assert len(fc) == len(fh) > 1000 and abs(len(vc) - len(vh)) <= (screen == 0.0)


def test_dense_chi_on_the_card(sphere):
    pts, nrm = sphere
    origin, spacing = mesh._grid_frame(pts, 32)
    chi, _ = mesh._dense_chi(pts, nrm, 32, origin, spacing, 300, screen=4.0, device="cuda")
    want, _ = mesh._dense_chi(pts, nrm, 32, origin, spacing, 300, screen=4.0, device="cpu")
    assert chi.dtype == np.float64
    assert np.abs(chi - want).max() <= CHI_BOUND * np.abs(want).max()
