"""FAST-9 response, NMS and keypoint selection: the port's plain version
(`vi_slam_tpu_torch/ops/fast.py`, and the pyramid wrapper's plain path in
`ops/fast_kernel.py`) against the JAX package's XLA path and its Pallas
kernel (interpret mode), on the same numpy images.

Tolerance of the response map: rtol 1e-5, atol 1e-3, as in
tests/test_frontend.py (the Pallas kernel sums each arc in a rolling
window, in another order than the XLA path). The port sums in the XLA
path's order, so against XLA it is also checked bit for bit. Keypoint
selection and the per-cell winners' positions must be exactly equal (same
cells, same top-k order); a winner's score is the map value, so it holds
to the map's tolerance against the Pallas map and is exact against XLA's.

The CUDA kernel itself needs the card; chip_smoke.py holds it to this
plain version there. Here the wrapper's CPU dispatch, its checks and the
kernel's tile work list are tested.
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
from vi_slam_tpu_torch.ops import pyramid as port_pyr

TH, TH_LO = 20.0, 7.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this file's tests run: the tests run in
    parallel workers that share the machine's cores, and torch's default
    of one thread per core in each worker oversubscribes them (spinning
    threads made these files about ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    pc = fast_kernel.pyramid_resp_cells([torch.from_numpy(img)], TH, TH_LO, 32)
    np.testing.assert_array_equal(pc.maps.numpy(), got.reshape(-1))
    np.testing.assert_array_equal(pc.level_maps()[0].numpy(), got)
    for a, b in zip(pc.level_cells()[0], port_fast.cell_max(torch.from_numpy(got), 32)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert fast_kernel.launches == 0


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        fast_kernel.pyramid_resp_cells_cuda([torch.zeros((8, 8))], TH, TH_LO, 32)
    assert fast_kernel.launches == 0


@pytest.mark.parametrize("cell", [8, 24, 64])
def test_kernel_wrapper_refuses_unsupported_cell_size(cell):
    # A tensor off the CPU goes to the kernel's launcher, which refuses the
    # cell size before it touches a device; the CPU path takes any size.
    img = torch.empty((64, 96), device="meta")
    with pytest.raises(ValueError, match=f"cell size {cell}"):
        fast_kernel.pyramid_resp_cells([img], TH, TH_LO, cell)
    with pytest.raises(ValueError, match="CUDA"):
        fast_kernel.pyramid_resp_cells([img], TH, TH_LO, 32)
    assert fast_kernel.launches == 0


@pytest.mark.parametrize(
    "th,th_lo", [(-1.0, TH_LO), (TH, -0.5), (TH, float("nan")), (-0.0, TH_LO), (TH, -0.0)]
)
def test_kernel_wrapper_refuses_negative_threshold(th, th_lo):
    # The kernel tells bright from dark circle points by the sign bit of
    # th - |d| and the sign of d, which is d > th or d < -th for th >= +0.0
    # only: with th = -0.0 and d = +0.0, th - |d| is -0.0.
    img = torch.empty((64, 96), device="meta")
    with pytest.raises(ValueError, match="thresholds >= 0"):
        fast_kernel.pyramid_resp_cells([img], th, th_lo, 32)
    assert fast_kernel.launches == 0


@pytest.fixture(scope="module")
def small_pyramid():
    """A 4-level pyramid of the textured image, with each level's map from
    the JAX package's XLA path and from its Pallas kernel (interpret)."""
    levels = port_pyr.build_pyramid(torch.from_numpy(_textured()), 4, 1.2)
    xla, pallas = [], []
    with jax.enable_x64(False):
        for img in levels:
            a = jnp.asarray(img.numpy())
            xla.append(np.asarray(ref_fast.resp_pref(a, TH, TH_LO)))
            pallas.append(np.asarray(fast_pallas.fast_resp_pref(a, TH, TH_LO, interpret=True)))
    return levels, xla, pallas


@pytest.mark.parametrize("cell", [16, 32])
def test_pyramid_resp_cells_matches_reference(small_pyramid, cell):
    levels, xla, pallas = small_pyramid
    pc = fast_kernel.pyramid_resp_cells(levels, TH, TH_LO, cell)
    maps, cells = pc.level_maps(), pc.level_cells()
    assert len(maps) == len(cells) == len(levels)
    assert pc.maps.shape == (sum(img.numel() for img in levels),)
    assert pc.score.shape == (pc.tiles.total,) and pc.xy.shape == (2, pc.tiles.total)
    for m, c, x, p in zip(maps, cells, xla, pallas):
        np.testing.assert_allclose(m.numpy(), p, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(m.numpy(), x)
        with jax.enable_x64(False):
            from_x = [np.asarray(a) for a in ref_fast.cell_max(jnp.asarray(x), cell)]
            from_p = [np.asarray(a) for a in ref_fast.cell_max(jnp.asarray(p), cell)]
        got = [a.numpy() for a in c]
        assert [a.dtype for a in got] == [np.float32, np.int32, np.int32]
        for a, b in zip(got, from_x):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[1], from_p[1])
        np.testing.assert_array_equal(got[2], from_p[2])
        np.testing.assert_allclose(got[0], from_p[0], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("cell,top_k", [(32, 40), (16, 100)])
def test_select_from_cells_composes_select_keypoints(case, cell, top_k):
    _, _, _, got = case
    pref = torch.from_numpy(got)
    a = port_fast.select_from_cells(*port_fast.cell_max(pref, cell), top_k)
    b = port_fast.select_keypoints(pref, cell, top_k)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("cell,budget", [(32, 5), (16, 40), (32, 1000)])
def test_select_from_level_cells_matches_per_level(small_pyramid, cell, budget):
    # The extractor's selection of all levels at once from the flat cells
    # equals select_from_cells level by level, concatenated; a budget above
    # a level's cell count takes all its cells.
    levels, _, _ = small_pyramid
    pc = fast_kernel.pyramid_resp_cells(levels, TH, TH_LO, cell)
    ks = [min(budget, n) for n in pc.tiles.count]
    got = port_fast.select_from_level_cells(
        pc.score, pc.xy[0], pc.xy[1], *port_fast.level_picks(pc.tiles.count, ks, "cpu")
    )
    want = [port_fast.select_from_cells(*c, budget) for c in pc.level_cells()]
    assert got[0].shape == (sum(ks), 2)
    for a, b in zip(got, zip(*want)):
        np.testing.assert_array_equal(a.numpy(), torch.cat(b).numpy())


@pytest.mark.parametrize("cell,n_tiles", [(32, 1492), (16, 5858)])
def test_tile_list_covers_kitti_pyramid_once(cell, n_tiles):
    shapes = tuple(port_pyr.level_shapes(376, 1241, 8, 1.2))
    tiles = fast_kernel.tile_list(shapes, cell)
    assert tiles.total == n_tiles == sum(tiles.count)
    assert list(tiles.first) == [sum(tiles.count[:l]) for l in range(len(shapes))]
    covered = 0
    for (h, w), t0, n in zip(shapes, tiles.first, tiles.count):
        hits = np.zeros((h, w), np.int32)
        tiles_x = -(-w // cell)
        for b in range(t0, t0 + n):  # block b's tile, found as the kernel does
            level = max(l for l in range(len(shapes)) if b >= tiles.first[l])
            assert tiles.first[level] == t0
            t = b - t0
            y0, x0 = (t // tiles_x) * cell, (t % tiles_x) * cell
            hits[y0 : y0 + cell, x0 : x0 + cell] += 1
        assert np.all(hits == 1)
        covered += hits.sum()
    assert covered == 1444097


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
