"""FAST-9 response, NMS and keypoint selection: the port's plain version
(`vi_slam_tpu_torch/ops/fast.py`) against the JAX package's XLA path and
its Pallas kernel (interpret mode), on the same numpy images.

Tolerance of the response map: rtol 1e-5, atol 1e-3, as in
tests/test_frontend.py (the Pallas kernel sums each arc in a rolling
window, in another order than the XLA path). The port sums in the XLA
path's order, so against XLA it is also checked bit for bit. Keypoint
selection must be exactly equal (same cells, same top-k order).

The CUDA kernel itself needs the card; chip_smoke.py holds it to this
plain version there. Here the wrapper's CPU dispatch and its checks are
tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.ops import fast as ref_fast
from vi_slam_tpu.ops import fast_pallas
from vi_slam_tpu_torch.kernels import build as kbuild
from vi_slam_tpu_torch.ops import fast as port_fast
from vi_slam_tpu_torch.ops import fast_kernel

TH, TH_LO = 20.0, 7.0


def _textured():
    """tests/test_frontend.py's textured_pair left image (192x256)."""
    rng = np.random.default_rng(19)
    H, W, D = 192, 256, 20
    base = np.kron(
        rng.uniform(0, 255, size=(H // 4, (W + D) // 4)), np.ones((4, 4))
    ).astype(np.float32)
    return base[:, :W]


def _random():
    return np.random.default_rng(23).uniform(0, 255, size=(64, 96)).astype(np.float32)


IMAGES = {"textured_192x256": _textured, "random_64x96": _random}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def case(request):
    img = IMAGES[request.param]()
    with jax.enable_x64(False):
        want = np.asarray(ref_fast.resp_pref(jnp.asarray(img), TH, TH_LO))
        pallas = np.asarray(
            fast_pallas.fast_resp_pref(jnp.asarray(img), TH, TH_LO, interpret=True)
        )
    got = port_fast.resp_pref(torch.from_numpy(img), TH, TH_LO).numpy()
    return img, want, pallas, got


def test_resp_pref_matches_xla(case):
    _, want, _, got = case
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got, want)


def test_resp_pref_matches_pallas_interpret(case):
    _, _, pallas, got = case
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-3)


_ref_select = jax.jit(ref_fast.select_keypoints, static_argnums=(1, 2))


@pytest.mark.parametrize("cell,top_k", [(32, 40), (16, 100), (8, 500)])
def test_select_keypoints_equal(case, cell, top_k):
    _, want, _, got = case
    with jax.enable_x64(False):
        r = [np.asarray(a) for a in _ref_select(jnp.asarray(want), cell, top_k)]
    p = [a.numpy() for a in port_fast.select_keypoints(torch.from_numpy(got), cell, top_k)]
    for a, b in zip(r, p):
        np.testing.assert_array_equal(a, b)


def test_nms_matches(case):
    img, _, _, _ = case
    with jax.enable_x64(False):
        r = np.asarray(ref_fast.fast_response(jnp.asarray(img), TH))
        n = np.asarray(ref_fast.nms3x3(jnp.asarray(r)))
    np.testing.assert_array_equal(port_fast.nms3x3(torch.from_numpy(r)).numpy(), n)


def test_wrapper_takes_plain_version_on_cpu(case):
    img, _, _, got = case
    fast_kernel.reset_launches()
    out = fast_kernel.resp_pref(torch.from_numpy(img), TH, TH_LO)
    np.testing.assert_array_equal(out.numpy(), got)
    assert fast_kernel.launches == 0


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        fast_kernel.resp_pref_cuda(torch.zeros((8, 8)), TH, TH_LO)
    assert fast_kernel.launches == 0


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 0.0])
    vals, idx = port_fast.top_k(x, 4)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_build_needs_nvcc_and_writes_to_ignored_dir(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(kbuild.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.find_nvcc()
    d = kbuild.build_dir()
    assert d.parent == kbuild.PKG_DIR / "_build"
    ignored = (kbuild.PKG_DIR.parent / ".gitignore").read_text().split()
    assert "vi_slam_tpu_torch/_build/" in ignored
    assert all("torch/extension.h" not in s.read_text() for s in kbuild._sources())
