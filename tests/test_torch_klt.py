"""The LK tracker's parts of the port against the JAX package, on the same
seeded numpy inputs: the half-sampling pyramid (`ops/pyramid.py`), the
pyramidal IC-LK tracker (`ops/klt.py`) and the Harris / Shi-Tomasi
detector (`ops/harris.py`).

Tolerances and their reasons:
  * the pyramid of a uint8 image is dyadic (2x2 means of integers, then
    of quarter-integers ...), so it is bit-equal;
  * `track_pyramidal` is fed the reference's pyramids (a float image's
    2x2 means may round differently in another order). Its `ok` masks are
    equal; positions agree within 1e-3 px and residuals within 1e-3 grey
    levels where the reference's track is ok: XLA fuses the bilinear
    blends and the patch sums into multiply-adds in another order, which
    moves positions by about 1e-6 px a step over 40 steps. A lost track's
    position is where 40 steps of a divergent iteration left it, and is
    not compared;
  * Harris: the prefix sums run in XLA's CPU order and the response with
    its multiply-adds (`ops/harris.py`), so the response is held to rtol
    1e-5 and is bit-equal here; cells and keypoints are equal.
tests/test_klt_harris.py's cases (an integer shift, a 12 px shift that
needs the pyramid, an uncorrelated image) run on both sides, and a random
textured pair with 500 tracks, with and without a guess.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vi_slam_tpu.ops import harris as ref_harris
from vi_slam_tpu.ops import klt as ref_klt
from vi_slam_tpu.ops import pyramid as ref_pyr
from vi_slam_tpu_torch.io import synthetic
from vi_slam_tpu_torch.ops import harris, klt
from vi_slam_tpu_torch.ops import pyramid as pyr


def x64_off():
    """A fresh context per use (a shared one, entered nested, would leave
    x64 off for every later test in the process)."""
    return jax.enable_x64(False)


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def _texture(h, w, seed=0, block=4):
    """tests/test_klt_harris.py's blocky random texture."""
    rng = np.random.default_rng(seed)
    return np.kron(rng.uniform(0, 255, size=(h // block, w // block)),
                   np.ones((block, block))).astype(np.float32)


def _warp(img, dx, dy):
    """img sampled bilinearly at (x - dx, y - dy): the content moves by
    (dx, dy); borders clamp."""
    h, w = img.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = np.clip(xs - dx, 0, w - 1.001)
    y = np.clip(ys - dy, 0, h - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return out.astype(np.float32)


# ----------------------------------------------------------------- pyramid


@pytest.mark.parametrize("source", ["rendered", "random"])
def test_halfsample_pyramid_bit_equal(source):
    """5 levels of a uint8 image with odd rows and columns at every level
    (the odd ones cropped): bit-equal."""
    if source == "rendered":
        world = synthetic.make_billboard_world(n_frames=2, n_boards=800, seed=3)
        img = synthetic.render_billboard_image(world, world.poses_wc[1], 300.0, 300.0, 160.0,
                                               120.0, 323, 243).astype(np.uint8)
    else:
        img = np.random.default_rng(1).integers(0, 256, (241, 321)).astype(np.uint8)
    img = img.astype(np.float32)
    with x64_off():
        want = [np.asarray(a) for a in ref_pyr.build_halfsample_pyramid(jnp.asarray(img), 5)]
    got = pyr.build_halfsample_pyramid(torch.from_numpy(img), 5)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------- tracking


def _track_both(img, nxt, levels, xy, valid, guess=None, **kw):
    """(reference TrackResult as numpy, port TrackResult), the port fed the
    reference's pyramids."""
    with x64_off():
        pa = ref_pyr.build_halfsample_pyramid(jnp.asarray(img), levels)
        pb = ref_pyr.build_halfsample_pyramid(jnp.asarray(nxt), levels)
        g = None if guess is None else jnp.asarray(guess, jnp.float32)
        r = ref_klt.track_pyramidal(pa, pb, jnp.asarray(xy, jnp.float32), jnp.asarray(valid),
                                    xy_guess=g, **kw)
        r = ref_klt.TrackResult(*(np.asarray(a) for a in r))
    ta = [torch.from_numpy(np.array(a)) for a in pa]
    tb = [torch.from_numpy(np.array(a)) for a in pb]
    p = klt.track_pyramidal(ta, tb, torch.from_numpy(np.asarray(xy, np.float32)),
                            torch.from_numpy(np.asarray(valid)),
                            xy_guess=None if guess is None else torch.from_numpy(
                                np.asarray(guess, np.float32)), **kw)
    return r, p


def _assert_tracks_match(r, p):
    np.testing.assert_array_equal(p.ok.numpy(), r.ok)
    ok = r.ok
    np.testing.assert_allclose(p.xy.numpy()[ok], r.xy[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p.residual.numpy()[ok], r.residual[ok], rtol=0, atol=1e-3)


def _harris_keypoints(img, **kw):
    with x64_off():
        xy, _, valid = ref_harris.detect_harris(jnp.asarray(img), cell=16, top_k=128, **kw)
        return np.asarray(xy), np.asarray(valid)


def test_track_integer_shift():
    """tests/test_klt_harris.py::test_klt_integer_shift on both sides."""
    img = _texture(128, 160, seed=7)
    nxt = np.roll(np.roll(img, 2, axis=0), 3, axis=1)
    xy, valid = _harris_keypoints(img)
    r, p = _track_both(img, nxt, 3, xy, valid)
    _assert_tracks_match(r, p)
    assert r.ok.sum() > 30
    flow = p.xy.numpy()[r.ok] - xy[r.ok]
    assert np.median(np.abs(flow - [3, 2]), axis=0).max() < 0.15


def test_track_large_shift_through_the_pyramid():
    """tests/test_klt_harris.py::test_klt_large_shift_needs_pyramid: 12 px,
    4 levels."""
    img = _texture(160, 192, seed=9, block=8)
    nxt = np.roll(img, 12, axis=1)
    xy, valid = _harris_keypoints(img)
    r, p = _track_both(img, nxt, 4, xy, valid)
    _assert_tracks_match(r, p)
    assert r.ok.sum() > 20
    assert abs(np.median(p.xy.numpy()[r.ok, 0] - xy[r.ok, 0]) - 12) < 0.3


def test_track_rejects_garbage():
    """tests/test_klt_harris.py::test_klt_rejects_garbage: an uncorrelated
    image fails the residual gate on both sides alike."""
    img = _texture(128, 160, seed=11)
    other = _texture(128, 160, seed=12)
    xy, valid = _harris_keypoints(img)
    r, p = _track_both(img, other, 3, xy, valid)
    _assert_tracks_match(r, p)
    assert r.ok.sum() / max(valid.sum(), 1) < 0.25


@pytest.mark.parametrize("with_guess", [False, True])
def test_track_random_textured_pair(with_guess):
    """500 tracks at random positions (some near the border, some invalid)
    on a 240x320 texture moved by (2.3, -1.6) px, 5 levels, the pipeline's
    patch and gates; with a guess, each track starts within 1.5 px of its
    true position."""
    rng = np.random.default_rng(21)
    img = _texture(240, 320, seed=13, block=3)
    nxt = _warp(img, 2.3, -1.6)
    xy = rng.uniform([2, 2], [318, 238], (500, 2)).astype(np.float32)
    valid = rng.uniform(size=500) < 0.9
    guess = (xy + [2.3, -1.6] + rng.uniform(-1.5, 1.5, (500, 2))).astype(np.float32) \
        if with_guess else None
    r, p = _track_both(img, nxt, 5, xy, valid, guess, half=5, iters=8, max_residual=25.0)
    _assert_tracks_match(r, p)
    assert r.ok.sum() > 300


def test_sample_matches():
    """The scattered bilinear sampler, clamped at the borders."""
    img = _texture(64, 80, seed=3)
    xy = np.random.default_rng(2).uniform([-3, -3], [83, 67], (200, 2)).astype(np.float32)
    with x64_off():
        want = np.asarray(ref_klt._sample(jnp.asarray(img), jnp.asarray(xy)))
    got = klt._sample(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ------------------------------------------------------------------ Harris


HARRIS_IMAGES = {
    "blocks": lambda: _texture(128, 160, seed=5),
    "fine": lambda: _texture(240, 320, seed=3, block=2),
    "noise": lambda: np.random.default_rng(4).uniform(0, 255, (97, 131)).astype(np.float32),
    "corner": lambda: np.pad(np.full((44, 44), 200.0, np.float32), ((20, 0), (20, 0))),
}


@pytest.mark.parametrize("shi_tomasi", [False, True], ids=["harris", "shi_tomasi"])
@pytest.mark.parametrize("name", list(HARRIS_IMAGES))
def test_harris_response_and_detection_match(name, shi_tomasi):
    img = HARRIS_IMAGES[name]()
    with x64_off():
        want = np.asarray(ref_harris.harris_response(jnp.asarray(img), shi_tomasi=shi_tomasi))
        want_kp = [np.asarray(a) for a in ref_harris.detect_harris(
            jnp.asarray(img), cell=16, top_k=256, shi_tomasi=shi_tomasi)]
    got = harris.harris_response(torch.from_numpy(img), shi_tomasi=shi_tomasi).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    got_kp = harris.detect_harris(torch.from_numpy(img), cell=16, top_k=256,
                                  shi_tomasi=shi_tomasi)
    for g, w in zip(got_kp, want_kp):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want_kp[2].sum() > 0


def test_detect_harris_flat_image_has_no_corner():
    img = np.zeros((128, 160), np.float32)
    _, score, valid = harris.detect_harris(torch.from_numpy(img), cell=16, top_k=256)
    assert not bool(valid.any()) and float(score.max()) == 0.0
