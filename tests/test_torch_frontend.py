"""ORB frontend of the port against the JAX package, on the same numpy
inputs: pyramid, blur, moments and orientations, rBRIEF descriptors, the
whole OrbExtractor, Hamming distances and stereo scanline matching.

The reference runs with x64 off (`jax.enable_x64(False)`), as the bench
does; tests/conftest.py turns x64 on for the whole test run.

Tolerances, and why:
  * pyramid levels >= 1: atol 2e-2 grey levels. `jax.image.resize` on the
    CPU is itself inexact (about 0.01 from an exact evaluation of its own
    weights); the port applies the same weight formula as two float32
    products. Level 0 is the image itself and is exact.
  * descriptor bits: equal wherever the pair difference is at least
    DESC_EPS in magnitude. A pair whose two samples fall in one flat
    region has a difference of about 1e-6 whose sign depends on the
    order of the float32 sum, which differs between XLA's and PyTorch's
    matrix products.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.features.extractor import OrbExtractor as RefExtractor
from vi_slam_tpu.ops import hamming as ref_hamming
from vi_slam_tpu.ops import orb as ref_orb
from vi_slam_tpu.ops import pyramid as ref_pyr
from vi_slam_tpu.ops import stereo as ref_stereo
from vi_slam_tpu.utils.config import ExtractorConfig as RefExtractorConfig
from vi_slam_tpu_torch.features.extractor import Features, OrbExtractor
from vi_slam_tpu_torch.ops import hamming, orb, pyramid, stereo
from vi_slam_tpu_torch.utils.config import ExtractorConfig


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


DESC_EPS = 1e-4
LEVEL_ATOL = 2e-2


def _textured_pair():
    """tests/test_frontend.py's stereo pair: disparity 20 px."""
    rng = np.random.default_rng(19)
    H, W, D = 192, 256, 20
    base = np.kron(
        rng.uniform(0, 255, size=(H // 4, (W + D) // 4)), np.ones((4, 4))
    ).astype(np.float32)
    return base[:, :W], base[:, D : D + W], D


def _to_np(t):
    return t.detach().cpu().numpy()


def _feats_to_torch(f) -> Features:
    """Reference Features (numpy views of jax arrays) -> port Features."""
    a = [np.asarray(x) for x in f]
    a[4] = a[4].astype(np.uint32).view(np.int32)
    return Features(*(torch.from_numpy(np.ascontiguousarray(x)) for x in a))


def _desc_bits(words: np.ndarray) -> np.ndarray:
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).reshape(*words.shape[:-1], 256)


def _atlas_xy(ext, f):
    """Atlas coordinates of the reference's keypoints."""
    lv = f[1]
    offs = np.asarray(ext.row_offsets)[lv]
    xy = np.stack([f[0][:, 0] / ext.scales[lv], f[0][:, 1] / ext.scales[lv] + offs], -1)
    return np.round(xy).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _textured_pair()


@pytest.fixture(scope="module")
def ref_extract(pair):
    left, right, _ = pair
    ext = RefExtractor(RefExtractorConfig(n_features=512), left.shape[0], left.shape[1])
    with jax.enable_x64(False):
        fL, aL = ext._fn_atlas(jnp.asarray(left))
        fR, aR = ext._fn_atlas(jnp.asarray(right))
        fL = [np.array(x) for x in fL]
        fR = [np.array(x) for x in fR]
        aL, aR = np.array(aL), np.array(aR)
    return ext, fL, aL, fR, aR


def test_level_shapes_and_scales_match():
    for h, w in [(376, 1241), (192, 256), (240, 320)]:
        assert pyramid.level_shapes(h, w, 8, 1.2) == ref_pyr.level_shapes(h, w, 8, 1.2)
    np.testing.assert_array_equal(pyramid.scale_factors(8, 1.2), ref_pyr.scale_factors(8, 1.2))


def test_pyramid_matches(pair):
    left, _, _ = pair
    pyr = jax.jit(ref_pyr.build_pyramid, static_argnums=(1, 2))
    with jax.enable_x64(False):
        want = [np.asarray(x) for x in pyr(jnp.asarray(left), 8, 1.2)]
    # H1: the reference fed float32 under the test run's x64 stays float32
    # and agrees with its x64-off run to the same tolerance
    want64 = [np.asarray(x) for x in pyr(jnp.asarray(left), 8, 1.2)]
    got = [_to_np(x) for x in pyramid.build_pyramid(torch.from_numpy(left), 8, 1.2)]
    np.testing.assert_array_equal(got[0], want[0])
    for w32, w64, g in zip(want, want64, got):
        assert w32.dtype == w64.dtype == g.dtype == np.float32
        np.testing.assert_allclose(g, w32, rtol=0, atol=LEVEL_ATOL)
        np.testing.assert_allclose(w64, w32, rtol=0, atol=LEVEL_ATOL)


def test_gaussian_blur_matches(pair):
    left, _, _ = pair
    with jax.enable_x64(False):
        want = np.asarray(ref_pyr.gaussian_blur(jnp.asarray(left)))
    got = _to_np(pyramid.gaussian_blur(torch.from_numpy(left)))
    # separable 7-tap sums; XLA may fuse the multiply-adds differently
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_moments_and_orientations_match(ref_extract):
    ext, fL, aL, _, _ = ref_extract
    xy = _atlas_xy(ext, fL)[fL[5]]
    with jax.enable_x64(False):
        m10, m01 = [np.asarray(x) for x in jax.jit(ref_orb.moment_images)(jnp.asarray(aL))]
        ang = np.asarray(jax.jit(ref_orb.orientations)(jnp.asarray(aL), jnp.asarray(xy)))
    p10, p01 = [_to_np(x) for x in orb.moment_images(torch.from_numpy(aL))]
    # the same log-step prefix sums in the same order; the partial sums
    # reach ~6e7 (float32 ulp 4) and XLA fuses `dQ - x * dP`, so the two
    # differ by a few ulps of the partial sums
    np.testing.assert_allclose(p10, m10, rtol=0, atol=16.0)
    np.testing.assert_allclose(p01, m01, rtol=0, atol=16.0)
    got = _to_np(orb.orientations(torch.from_numpy(aL), torch.from_numpy(xy)))
    # atan2 of moments equal to a few ulps of their partial sums
    np.testing.assert_allclose(got, ang, rtol=0, atol=1e-3)


def test_pattern_and_stencils_match():
    np.testing.assert_array_equal(orb.PATTERN, ref_orb.PATTERN)
    want = ref_orb._stencils().transpose(1, 0, 2).reshape(41 * 41, -1)
    np.testing.assert_array_equal(orb.stencil_matrix(), want)


def test_descriptors_match_outside_flat_pairs(ref_extract):
    ext, fL, aL, _, _ = ref_extract
    xy_atlas = _atlas_xy(ext, fL)
    angle = fL[2]
    with jax.enable_x64(False):
        blurred = np.asarray(ref_pyr.gaussian_blur(jnp.asarray(aL)))
        want = np.asarray(ref_orb.describe_patches(
            jnp.asarray(blurred), jnp.asarray(xy_atlas), jnp.asarray(angle)))
    bl = torch.from_numpy(blurred)
    got = _to_np(orb.describe_patches(bl, torch.from_numpy(xy_atlas), torch.from_numpy(angle),
                                      torch.from_numpy(orb.stencil_matrix())))
    # exact pair differences, for locating the flat pairs
    patches = orb.extract_patches(bl.double(), torch.from_numpy(xy_atlas)).reshape(len(angle), -1)
    diffs = (patches @ torch.from_numpy(orb.stencil_matrix()).double()).reshape(len(angle), 32, 256)
    d = _to_np(diffs[torch.arange(len(angle)), orb.angle_bins(torch.from_numpy(angle))])
    valid = fL[5]
    flip = _desc_bits(want.view(np.int32)) != _desc_bits(got)
    flat = np.abs(d) < DESC_EPS
    assert not (flip & ~flat)[valid].any()
    # measured on this input: the flipped bits are a minority of the flat ones
    assert flip[valid].sum() <= flat[valid].sum()


def test_extractor_matches(pair, ref_extract):
    left, _, _ = pair
    _, fL, aL, _, _ = ref_extract
    ext = OrbExtractor(ExtractorConfig(n_features=512), left.shape[0], left.shape[1], device="cpu")
    feats, atlas = ext.extract(torch.from_numpy(left))
    got = [_to_np(x) for x in feats]
    for name in ("xy", "level", "valid"):
        i = Features._fields.index(name)
        np.testing.assert_array_equal(got[i], fL[i], err_msg=name)
    assert got[5].sum() > 50
    np.testing.assert_allclose(got[2], fL[2], rtol=0, atol=1e-3)  # angle (levels differ by <2e-2)
    np.testing.assert_allclose(got[3], fL[3], rtol=0, atol=5e-2)  # score (ditto)
    np.testing.assert_allclose(_to_np(atlas), aL, rtol=0, atol=LEVEL_ATOL)
    flip = _desc_bits(fL[4].view(np.int32)) != _desc_bits(got[4])
    # bits of flat pairs only: at most a few per descriptor
    assert flip[fL[5]].sum(axis=1).max() <= 8
    assert flip[fL[5]].mean() < 0.01


def test_flat_image_has_no_keypoints():
    ext = OrbExtractor(ExtractorConfig(n_features=512, cell_size=16), 192, 256, device="cpu")
    feats = ext(torch.zeros((192, 256)))
    assert int(feats.valid.sum()) == 0


def test_popcount_and_hamming_match():
    xs = np.asarray([0, 1, 0xFFFFFFFF, 0x80000000, 0x0F0F0F0F], dtype=np.uint32)
    got = hamming.popcount_u32(torch.from_numpy(xs.view(np.int32)))
    np.testing.assert_array_equal(_to_np(got), [0, 1, 32, 1, 16])
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 2 ** 32, size=(64, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2 ** 32, size=(48, 8), dtype=np.uint32)
    want = np.asarray(ref_hamming.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    t1, t2 = torch.from_numpy(d1.view(np.int32)), torch.from_numpy(d2.view(np.int32))
    np.testing.assert_array_equal(_to_np(hamming.hamming_matrix(t1, t2)), want)
    np.testing.assert_array_equal(np.diag(_to_np(hamming.hamming_matrix(t1, t1))), 0)


@pytest.mark.parametrize("use_mutual,use_median", [(True, True), (False, True), (False, False)])
def test_match_stereo_matches_reference(ref_extract, use_mutual, use_median):
    ext, fL, aL, fR, aR = ref_extract
    with jax.enable_x64(False):
        want = ref_stereo.match_stereo(
            _ref_feats(fL),
            _ref_feats(fR), jnp.asarray(aL), jnp.asarray(aR),
            jnp.asarray(ext.row_offsets, jnp.int32), jnp.asarray(ext.scales),
            jnp.asarray(100.0, jnp.float32), max_disp=64.0,
            use_mutual=use_mutual, use_median=use_median,
        )
        want = [np.asarray(x) for x in want]
    got = stereo.match_stereo(
        _feats_to_torch(fL), _feats_to_torch(fR), torch.from_numpy(aL), torch.from_numpy(aR),
        torch.tensor(ext.row_offsets, dtype=torch.int32), torch.from_numpy(ext.scales),
        torch.tensor(100.0), max_disp=64.0, use_mutual=use_mutual, use_median=use_median,
    )
    got = [_to_np(x) for x in got]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _ref_feats(f):
    from vi_slam_tpu.features.extractor import Features as RefFeatures

    return RefFeatures(*(jnp.asarray(x) for x in f))


def test_port_stereo_recovers_disparity(pair):
    """The cases of test_stereo_scanline_recovers_disparity, on the port
    end to end."""
    left, right, D = pair
    ext = OrbExtractor(ExtractorConfig(n_features=512), left.shape[0], left.shape[1], device="cpu")
    fL, aL = ext.extract(torch.from_numpy(left))
    fR, aR = ext.extract(torch.from_numpy(right))
    sm = stereo.match_stereo(
        fL, fR, aL, aR, torch.tensor(ext.row_offsets, dtype=torch.int32),
        torch.from_numpy(ext.scales), torch.tensor(100.0), max_disp=64.0,
    )
    ok = _to_np(sm.ok & fL.valid)
    disp = _to_np(fL.xy[:, 0] - sm.u_right)[ok]
    assert ok.sum() > 25, ok.sum()
    assert abs(float(np.median(disp)) - D) < 0.75
    assert float(np.mean(np.abs(disp - D) < 1.5)) > 0.8


def test_extractor_and_map_default_to_the_card(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    without a device argument the extractor and a map made from the
    reference's arrays ask for CUDA, and raise where there is none."""
    from vi_slam_tpu_torch.slam_map import state as map_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        OrbExtractor(ExtractorConfig(n_features=64), 64, 96)
    arrays = map_state.map_state_to_numpy(map_state.allocate(2, 4, 8, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        map_state.map_state_from_numpy(arrays)
    assert OrbExtractor(ExtractorConfig(n_features=64), 64, 96, device="cpu").device.type == "cpu"
    assert map_state.map_state_from_numpy(arrays, device="cpu").kf_mp.device.type == "cpu"
