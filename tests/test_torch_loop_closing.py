"""Loop closing of the port against the JAX package on
tests/test_loop_closing.py's drifted ring, built in numpy
(`test_torch_loop_parts.build_ring`): 12 keyframes on a circle whose
odometry drifts, the last two re-seeing the first two's points as
duplicated late-era map points.

Both `LoopCloser`s get every keyframe, then one query for the last
keyframe (consistency threshold 1, as the reference test drives it). The
port's Sim3 RANSAC gets the reference's draws (key 7, split per
verification), so the verification's inlier masks, the fused seam and
every discrete decision are the reference's; with its own draws (a
generator seeded 7) the port must still close the loop on the same pair
within the reference test's limits.

Limits (the reference test's own): the seam closed to < 0.05 m, the
worst keyframe centre < 0.25 m from the truth and < 0.35 x the drift.
Tolerances against the reference: keyframe poses within 2e-4 (rotation)
and 2e-3 m after the Sim3 GN, 15 pose-graph iterations and 10 global-BA
iterations in float32 summed in another order; map points within 5e-3 m.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_parts import K_KF, N, ReferenceDraws, build_ring, x64_off  # noqa: F401

from vi_slam_tpu.cameras.base import CameraParams as RefCam
from vi_slam_tpu.pipeline import loop_closing as ref_loop_closing
from vi_slam_tpu.pipeline.loop_closing import LoopCloser as RefLoopCloser
from vi_slam_tpu.retrieval import vocabulary as ref_voc
from vi_slam_tpu.slam_map import state as ref_state
from vi_slam_tpu.utils.config import MapConfig as RefMapConfig
from vi_slam_tpu.utils.config import SystemConfig as RefSystemConfig
from vi_slam_tpu_torch.cameras.base import CameraParams
from vi_slam_tpu_torch.pipeline import loop_closing
from vi_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from vi_slam_tpu_torch.retrieval import vocabulary
from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy, map_state_to_numpy
from vi_slam_tpu_torch.utils.config import MapConfig, SystemConfig


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


@pytest.fixture(autouse=True)
def _x64_restored():
    yield
    assert jax.config.jax_enable_x64 is True, "a test left JAX's x64 mode off"


def _centres(R, t):
    return np.einsum("kji,kj->ki", R, -t)


@contextlib.contextmanager
def _recording_edges(module):
    """Record the live edges, as (i, j) pairs in slot order, of every pose
    graph that `module`'s loop closer solves."""
    solve = module.optimize_pose_graph
    solved = []

    def recording(poses, edges, meas, valid, *args, **kwargs):
        e, v = np.asarray(edges), np.asarray(valid)
        solved.append([tuple(int(x) for x in p) for p in e[v]])
        return solve(poses, edges, meas, valid, *args, **kwargs)

    module.optimize_pose_graph = recording
    try:
        yield solved
    finally:
        module.optimize_pose_graph = solve


def _close(d, desc, bf, run_gba, draws):
    """One query for the last keyframe on both sides: (reference closer,
    its map as numpy, port closer, its map as numpy)."""
    with x64_off():
        cam = RefCam.make(300.0, 300.0, 160.0, 120.0, bf=bf)
        vocab = ref_voc.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2)
        cfg = RefSystemConfig(map=RefMapConfig(max_keyframes=16, max_points=4096,
                                               max_obs_per_point=8, essential_weight_min=100))
        ref = RefLoopCloser(cfg, cam, vocab, fix_scale=True, min_gap_kfs=8, run_gba=run_gba)
        ref.consistency_th = 1
        state = ref_state.MapState(**{k: jnp.array(v, copy=True) for k, v in d.items()})
        for k in range(K_KF):
            ref.add_keyframe(state, k)
        with _recording_edges(ref_loop_closing) as ref_edges:
            out, closed = ref.process(state, K_KF - 1, K_KF)
        assert closed
        want = {k: np.array(v) for k, v in zip(out._fields, out)}
    pcfg = SystemConfig(map=MapConfig(max_keyframes=16, max_points=4096, max_obs_per_point=8,
                                      essential_weight_min=100))
    pcam = CameraParams.make(300.0, 300.0, 160.0, 120.0, bf=bf)
    pvocab = vocabulary.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2, device="cpu")
    port = LoopCloser(pcfg, pcam, pvocab, fix_scale=True, min_gap_kfs=8, run_gba=run_gba)
    port.consistency_th = 1
    if draws is not None:
        port.draw = draws
    pstate = map_state_from_numpy(d, device="cpu")
    for k in range(K_KF):
        port.add_keyframe(pstate, k)
    with _recording_edges(loop_closing) as port_edges:
        pout, pclosed = port.process(pstate, K_KF - 1, K_KF)
    assert pclosed, "the port did not close the loop"
    port.solved_edges, ref.solved_edges = port_edges, ref_edges
    return ref, want, port, map_state_to_numpy(pout)


@pytest.fixture(scope="module")
def ring():
    return build_ring()


@pytest.fixture(scope="module")
def graph_runs(ring):
    d, desc, seam, truth = ring
    return {name: _close(d, desc, 0.0, False, draws)
            for name, draws in (("ref_draws", ReferenceDraws(7)), ("own_draws", None))}


def _assert_ring_restored(m, d, truth):
    c_gt = _centres(*truth)
    before = np.linalg.norm(_centres(d["kf_R"][:K_KF], d["kf_t"][:K_KF]) - c_gt, axis=-1)
    after = np.linalg.norm(_centres(m["kf_R"][:K_KF], m["kf_t"][:K_KF]) - c_gt, axis=-1)
    assert before[-1] > 0.25
    assert after[-1] < 0.05
    assert after.max() < 0.35 * before.max()
    assert after.max() < 0.25
    return after


@pytest.mark.parametrize("draws", ["ref_draws", "own_draws"])
def test_loop_closes_on_the_same_pair_and_restores_the_ring(graph_runs, ring, draws):
    """Same query keyframe, same candidate, one loop each; the port's
    ring within the reference test's limits; most seam duplicates fused."""
    d, _, seam, truth = ring
    ref, want, port, got = graph_runs[draws]
    assert port.loop_edges == ref.loop_edges == [(K_KF - 1, 0)] or (
        port.loop_edges == ref.loop_edges and len(ref.loop_edges) == 1)
    assert port.stats.n_loops_closed == ref.stats.n_loops_closed == 1
    assert port.stats.n_queries == ref.stats.n_queries == 1
    _assert_ring_restored(want, d, truth)
    _assert_ring_restored(got, d, truth)
    dup = np.asarray(sorted(seam.values()))
    assert got["mp_valid"][dup].mean() < 0.6


@pytest.mark.parametrize("draws", ["ref_draws", "own_draws"])
def test_essential_graph_edges_match_reference(graph_runs, draws):
    """The essential graph the port solves has the reference's edges in the
    reference's order: spanning tree, strong covisibility and earlier loop
    edges over the live keyframes, then the new loop edge (cand, cur) last;
    the reference's padding slots are the only edges left out."""
    ref, _, port, _ = graph_runs[draws]
    assert len(ref.solved_edges) == len(port.solved_edges) == 1
    want, got = ref.solved_edges[0], port.solved_edges[0]
    assert got == want
    assert want[-1][1] == K_KF - 1 and len(want) >= K_KF


def test_corrected_map_matches_reference(graph_runs):
    """With the reference's draws: every integer and boolean array of the
    corrected map (the fused seam, the links) equal; keyframe poses and
    points within the stated tolerances."""
    _, want, _, got = graph_runs["ref_draws"]
    for name, w in want.items():
        if w.dtype.kind != "f":
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    np.testing.assert_allclose(got["kf_R"], want["kf_R"], atol=2e-4)
    np.testing.assert_allclose(got["kf_t"], want["kf_t"], atol=2e-3)
    np.testing.assert_allclose(got["mp_pos"], want["mp_pos"], atol=5e-3)


def test_own_draws_close_to_reference(graph_runs):
    """The port's own draws: another RANSAC sample, the same optimum of the
    Sim3 GN and the pose graph: keyframe poses within 2e-3 / 2e-2 m."""
    _, want, _, got = graph_runs["own_draws"]
    np.testing.assert_allclose(got["kf_R"], want["kf_R"], atol=2e-3)
    np.testing.assert_allclose(got["kf_t"], want["kf_t"], atol=2e-2)


def _reproj_cost(m, bf):
    """Mean reprojection error over the live observations
    (tests/test_loop_closing.py::_map_reproj_cost)."""
    errs = []
    for k in range(K_KF):
        sel = np.flatnonzero((m["kf_mp"][k] >= 0) & m["mp_valid"][np.clip(m["kf_mp"][k], 0, None)])
        if sel.size:
            pc = m["mp_pos"][m["kf_mp"][k, sel]] @ m["kf_R"][k].T + m["kf_t"][k]
            uv = np.stack([300 * pc[:, 0] / pc[:, 2] + 160, 300 * pc[:, 1] / pc[:, 2] + 120], -1)
            errs.append(np.linalg.norm(uv - m["kf_xy"][k, sel], axis=-1))
    return float(np.mean(np.concatenate(errs)))


def test_gba_after_essential_graph(ring):
    """tests/test_loop_closing.py::test_gba_after_essential_graph on the
    port (stereo measurements, bf 60): global BA after the essential graph
    tightens the ring, keeps the seam closed and halves the map's
    reprojection error, as the reference's does; with the reference's
    draws the port's corrected poses agree with the reference's."""
    _, desc, _, truth = ring
    d, *_ = build_ring(bf=60.0)
    c_gt = _centres(*truth)
    runs = {gba: _close(d, desc, 60.0, gba, ReferenceDraws(7)) for gba in (False, True)}
    err = {}
    for gba, (_, want, _, got) in runs.items():
        for m in (want, got):
            e = np.linalg.norm(_centres(m["kf_R"][:K_KF], m["kf_t"][:K_KF]) - c_gt, axis=-1)
            err[gba, m is got] = e
        np.testing.assert_allclose(got["kf_R"], want["kf_R"], atol=2e-4)
        np.testing.assert_allclose(got["kf_t"], want["kf_t"], atol=2e-3)
        np.testing.assert_allclose(got["mp_pos"], want["mp_pos"], atol=5e-3)
    for port in (False, True):
        assert err[True, port].max() < err[False, port].max()
        assert err[True, port][-1] < 0.05
    assert _reproj_cost(runs[True][3], 60.0) < 0.5 * _reproj_cost(runs[False][3], 60.0)
    assert _reproj_cost(runs[True][1], 60.0) < 0.5 * _reproj_cost(runs[False][1], 60.0)
    assert runs[True][2].timer.runs["gba"] == 1 and runs[False][2].timer.runs["gba"] == 0
