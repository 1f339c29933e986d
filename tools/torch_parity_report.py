"""Where the PyTorch port's main path departs from the JAX package's, on the
CPU, over the smoke's cadence-off slice world (KITTI-00-sized rendered
frames, bench.py's configuration, mapping, local BA and maintenance off),
or with `--bench-cadences` over the full phase's world with bench.py's
cadences.

Runs three StereoVOs side by side, frame by frame:
  * ref: the JAX package's (x64 off);
  * own: the port on device="cpu", extracting its own features;
  * fed: the port on device="cpu", fed the reference's features of each
    frame (left keypoints and descriptors, right-image u and depth).
and records, per frame, the keyframe decision, the inlier count and the
map-point count. Prints one JSON line with:
  * the first frame where own departs from ref, and the first where fed
    does (null where it never does): a port fault shows in fed, a
    difference of the features in own only;
  * at own's first departing frame, what differs in that frame's
    features: keypoint slots per level (levels >= 1 come from the
    resampled pyramid, ROADMAP H6), descriptor bits of shared keypoints and
    how many of them are flat pairs (ROADMAP H7), and stereo depths of
    shared keypoints;
  * frame 0's pyramid difference per level, and each run's final
    keyframes, map points and ATE.

With `--loop` the world is bench.py --loop's closed circle (200 frames,
bench.py's cadences, atlas off, the pipeline drained before frame 10 as
the smoke's loop phase does): the reference and the fed port use the
reference's vocabulary (trained as bench.py trains it) and the fed port's
Sim3 and PnP RANSACs get the reference's draws; the own port trains its
vocabulary from its own descriptors and draws its own samples. The line
then adds each run's loop figures (queries, loops closed, relocalized
frames, the frames where loops close) and the first frame where the lost
or tracked state differs.

With `--klt` it runs bench.py --frontend klt over the first F frames of
bench.py's 200-frame world (bench.py's cadences, the pipeline drained
before frame 10, as the smoke's klt phase runs): the reference first,
with every extraction recorded by the bytes of its image pair
(`tests/test_torch_klt_vo.py::ReferenceFeatures`), then the own and the
fed port. The line adds each run's rescue frames and keyframe frames, and
at the fed port's first departing frame the port's frame program run on
the reference's own inputs of that frame: where its counts equal the
reference's, the departure comes from the state before that frame.

With `--vio` it runs tools/bench_vio.py's stereo-inertial configuration
over its world (`make_billboard_inertial_sequence(F, ..., seed=5)` with
the 200 Hz IMU stream, drained before frame 8 as the smoke's vio phase
runs; `--smoother` turns the fixed-lag smoother on): the reference, the
own port and the port fed the reference's features of each frame (from
its extraction program before the IMU is ready, from its fused inertial
frame program after). The line adds each run's initialization stages with
their frames, gravity and biases, the first frame whose lost or tracked
state differs, and the largest pose difference of each port run from the
reference before and at its first departure.

With `--mono` it runs MonoVO over the left images of tools/bench_vio.py's
world at its configuration with sensor=MONOCULAR and bf=0 (the smoke's
mono phase): the reference first, with its features and its map and
live pose after the initialization and after each local BA recorded;
then the own port (its own features and two-view draws), the port fed the
reference's features and two-view draws (PRNGKey(3), split per attempt),
and the port fed those and the reference's map and pose after each BA
(`fed_ba`: a monocular map's scale is a gauge that float32 BAs walk
along differently, ROADMAP F14). The line adds each run's init frame,
two-view model and good count, scale-aligned ATE over the OK frames with
its Horn scale, keyframe frames and map points.

With `--mono-seeds` it runs tests/test_mono_vo.py's world (oracle
features, the first `--frames` frames) through the reference with its two-view key 3, 103,
203, 303 and 403, and through the port with its Sampler seeded the same,
with the monocular guards (`MonoVO.ba_guard`, the rescale after
the initialization BA) and without them, at one torch thread as the test
runs; one JSON line with each run's
scale-aligned ATE, OK frames, keyframes and points: the spread of the
limits that tests/test_torch_mono_vo.py holds its own-sampler run to.

    JAX_PLATFORMS=cpu python tools/torch_parity_report.py [--frames 100]
    JAX_PLATFORMS=cpu python tools/torch_parity_report.py --bench-cadences --frames 200
    JAX_PLATFORMS=cpu python tools/torch_parity_report.py --loop --frames 200
    JAX_PLATFORMS=cpu python tools/torch_parity_report.py --klt --frames 60
    JAX_PLATFORMS=cpu python tools/torch_parity_report.py --vio [--smoother] --frames 60
    JAX_PLATFORMS=cpu python tools/torch_parity_report.py --mono --frames 60
    JAX_PLATFORMS=cpu python tools/torch_parity_report.py --mono-seeds --frames 20
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from slice_reference_ate import bench_vocabulary, instrument_loop, loop_frames  # noqa: E402
from slice_reference_ate import slice_config as ref_slice_config  # noqa: E402
from slice_reference_ate import vio_config as ref_vio_config  # noqa: E402
from test_torch_loop_parts import ReferenceDraws  # noqa: E402
from vi_slam_tpu.io import evaluation as ref_evaluation  # noqa: E402
from vi_slam_tpu.ops import pyramid as ref_pyr  # noqa: E402
from vi_slam_tpu.pipeline.klt_vo import make_stereo_vo as ref_make_stereo_vo  # noqa: E402
from vi_slam_tpu_torch.features.extractor import Features  # noqa: E402
from vi_slam_tpu_torch.io import synthetic  # noqa: E402
from vi_slam_tpu_torch.ops import orb  # noqa: E402
from vi_slam_tpu_torch.ops import pyramid as pyr_ops  # noqa: E402
from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo  # noqa: E402
from vi_slam_tpu_torch.retrieval import vocabulary  # noqa: E402
from vi_slam_tpu_torch.utils.config import config_from_dict  # noqa: E402


def bits(words):
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).reshape(*w.shape[:-1], 256)


def feature_diff(ext, left, rf, pf, r_depth, p_depth):
    """What differs between the reference's features `rf` and the port's
    `pf` (lists of numpy arrays in Features order) of one left image."""
    kp_diff = []
    for lv in range(ext.cfg.n_levels):
        sl = rf[1] == lv
        differ = np.any(rf[0][sl] != pf[0][sl], axis=1) | (rf[5][sl] != pf[5][sl])
        kp_diff.append(int(differ.sum()))
    same = rf[5] & pf[5] & np.all(rf[0] == pf[0], axis=1) & (rf[1] == pf[1])
    # float64 pair differences of the port's inputs, to find flat pairs
    lv = pf[1]
    offs = np.asarray(ext.row_offsets)[lv]
    xy = np.round(np.stack([pf[0][:, 0] / ext.scales[lv],
                            pf[0][:, 1] / ext.scales[lv] + offs], -1)).astype(np.float32)
    levels = pyr_ops.build_pyramid(torch.from_numpy(left), ext.cfg.n_levels,
                                   ext.cfg.scale_factor, ext.pyramid_weights())
    W = ext.width
    atlas = torch.cat([torch.nn.functional.pad(levels[l], (0, W - levels[l].shape[1], 0,
                                                           orb_atlas_sep()))
                       for l in ext.used], dim=0)
    bl = pyr_ops.gaussian_blur(atlas).double()
    patches = orb.extract_patches(bl, torch.from_numpy(xy)).reshape(len(xy), -1)
    d = (patches @ torch.from_numpy(orb.stencil_matrix()).double()).reshape(len(xy), 32, 256)
    d = d[torch.arange(len(xy)), orb.angle_bins(torch.from_numpy(pf[2]))].numpy()
    flip = (bits(rf[4].view(np.int32)) != bits(pf[4]))[same]
    flat = (np.abs(d) < 1e-4)[same]
    depth_differs = same & (r_depth != p_depth)
    one_side = depth_differs & ((r_depth > 0) != (p_depth > 0))
    both = depth_differs & (r_depth > 0) & (p_depth > 0)
    return {
        "keypoint_slots_differing_per_level": kp_diff,
        "shared_valid_keypoints": int(same.sum()),
        "descriptor_bits_compared": int(flip.size),
        "descriptor_bits_differing": int(flip.sum()),
        "flat_pairs": int(flat.sum()),
        "differing_bits_outside_flat_pairs": int((flip & ~flat).sum()),
        "max_abs_pair_diff_at_differing_bits":
            float(np.abs(d[same][flip]).max()) if flip.any() else 0.0,
        "shared_keypoints_with_other_stereo_depth": int(depth_differs.sum()),
        "of_which_depth_on_one_side_only": int(one_side.sum()),
        "max_abs_depth_diff_m_where_both_have_depth": float(
            np.abs(r_depth - p_depth)[both].max()) if both.any() else 0.0,
        "median_abs_depth_diff_m_where_both_have_depth": float(
            np.median(np.abs(r_depth - p_depth)[both])) if both.any() else 0.0,
    }


def orb_atlas_sep():
    from vi_slam_tpu_torch.features.extractor import ATLAS_SEP

    return ATLAS_SEP


def record_frames(vo, out):
    """Wrap vo._finalize to record (frame, keyframes after, inliers, map
    points) of each finalized frame."""
    fin = vo._finalize

    def wrapped(job):
        st = fin(job)
        out[job.frame_id] = (st.n_kfs, st.n_inliers, st.n_mps)
        return st

    vo._finalize = wrapped


def first_departure(ref, other, n):
    """First frame whose keyframe decision, inliers or map points differ."""
    prev_r = prev_o = 0
    for f in range(n):
        r, o = ref.get(f), other.get(f)
        if r is None or o is None:
            continue
        kf_r, kf_o = r[0] > prev_r, o[0] > prev_o
        prev_r, prev_o = r[0], o[0]
        diff = [name for name, a, b in (("keyframe", kf_r, kf_o), ("inliers", r[1], o[1]),
                                        ("map_points", r[2], o[2])) if a != b]
        if diff:
            return {"frame": f, "differs": diff, "ref": [bool(kf_r), r[1], r[2]],
                    "port": [bool(kf_o), o[1], o[2]]}
    return None


def port_vocabulary(ref_vocab):
    """The reference's vocabulary as the port's."""
    return vocabulary.Vocabulary(
        node_bits=torch.from_numpy(np.asarray(ref_vocab.node_bits)),
        idf=torch.from_numpy(np.asarray(ref_vocab.idf)), k=ref_vocab.k, levels=ref_vocab.levels)


def own_vocabulary(port_cfg, frames):
    """bench.py's vocabulary trained from the port's own descriptors."""
    from vi_slam_tpu_torch.features.extractor import OrbExtractor

    ext = OrbExtractor(port_cfg.extractor, chip_smoke.H, chip_smoke.W, device="cpu")
    descs = []
    for i in range(0, len(frames), max(len(frames) // 10, 1)):
        f, _ = ext.extract(torch.from_numpy(np.asarray(frames[i][0], np.float32)))
        descs.append(f.desc[f.valid])
    return vocabulary.train_vocabulary(torch.cat(descs), k=8, levels=3, iters=4, seed=3)


def loop_events(vo, out):
    """Record the frames dispatched when each loop closes."""
    after = vo._after_loop_correction

    def wrapped():
        out.append(len(vo.records))
        return after()

    vo._after_loop_correction = wrapped


def state_departure(ref, other):
    for f, (a, b) in enumerate(zip(ref.records, other.records)):
        if a.state != b.state:
            return {"frame": f, "ref": a.state, "port": b.state}
    return None


def klt_report(n: int) -> None:
    """The KLT frontend's reference, own and fed runs; one JSON line."""
    from test_torch_klt_vo import ReferenceFeatures, pair_key

    t0 = time.time()
    world = synthetic.make_billboard_world(n_frames=chip_smoke.N_FULL_FRAMES, n_boards=4000,
                                           seed=11, speed=1.0)
    frames = chip_smoke.render_frames(world, n)
    ref_cfg = ref_slice_config(True)
    ref_cfg = ref_cfg.replace(tracker=dataclasses.replace(ref_cfg.tracker, frontend="klt"))
    port_cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    runs, stats, extra = {}, {}, {}
    ref = ref_make_stereo_vo(ref_cfg)
    store = ReferenceFeatures(ref)
    own = make_stereo_vo(port_cfg, device="cpu")
    fed = make_stereo_vo(port_cfg, device="cpu")
    store.feed(fed)
    for name, vo in (("ref", ref), ("own", own), ("fed", fed)):
        stats[name] = {}
        record_frames(vo, stats[name])
        for i, (imgL, imgR) in enumerate(frames):
            if i == chip_smoke.N_WARM:
                vo.flush()
            vo.process_stereo(imgL, imgR, i * 0.1)
            print(f"{name} frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
        traj = vo.trajectory_wc()
        ate = ref_evaluation.ate_rmse(traj[:, :3, 3], world.poses_wc[:n, :3, 3])
        runs[name] = {"keyframes": vo.n_kf, "map_points": vo.n_mp, "ate_cm": ate["rmse"] * 100.0,
                      "lost": sum(1 for r in vo.records if r.state != "OK"),
                      "keyframe_frames": [r.frame_id for r in vo.records
                                          if np.array_equal(r.T_rel, np.eye(4))]}
        extra[name] = traj
    key = {pair_key(*f): i for i, f in enumerate(frames)}
    runs["ref"]["rescue_frames"] = sorted(key[k] for k in store.rescue_keys())
    for name, vo in (("own", own), ("fed", fed)):
        runs[name]["rescue_frames"] = vo.rescue_frames
    fed_dep = first_departure(stats["ref"], stats["fed"], n)
    print(json.dumps({
        "world": f"{chip_smoke.W}x{chip_smoke.H}, {n} frames of bench.py's 200-frame world,"
                 " frontend klt, bench cadences, drained before frame 10, CPU",
        "first_departure_own": first_departure(stats["ref"], stats["own"], n),
        "first_departure_fed": fed_dep,
        "fed_frame_on_reference_state": None if fed_dep is None else klt_frame_on_reference_state(
            ref_cfg, port_cfg, frames, fed_dep["frame"]),
        "fed_pose_max_abs_diff": float(np.abs(extra["fed"] - extra["ref"]).max()),
        "ref": runs["ref"], "own": runs["own"], "fed": runs["fed"],
        "seconds": time.time() - t0,
    }))


def vio_report(n: int, smoother: bool, flush_at: int = chip_smoke.VIO_WARM) -> None:
    """The stereo-inertial pipeline's reference, own and fed runs over
    tools/bench_vio.py's world; one JSON line."""
    from vi_slam_tpu.pipeline import vio as ref_vio
    from vi_slam_tpu_torch.pipeline.vio import make_stereo_inertial_vo

    t0 = time.time()
    iw, frames = chip_smoke.vio_world()
    frames = frames[:n]
    ref_cfg = ref_vio_config(smoother)
    port_cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    ref = ref_vio.StereoInertialVO(ref_cfg)
    ref_feats = []
    extract_fn, frame_fn = ref._extract_pair_fn, ref._frame_vio_fn

    def keep(f, u, d):
        ref_feats.append(([np.array(x) for x in f], np.array(u), np.array(d)))

    def ref_extract(imgs):
        out = extract_fn(imgs)
        keep(*out)
        return out

    def ref_frame(*a):
        out = frame_fn(*a)
        keep(*out[12:15])
        return out

    ref._extract_pair_fn, ref._frame_vio_fn = ref_extract, ref_frame
    own = make_stereo_inertial_vo(port_cfg, device="cpu")
    fed = make_stereo_inertial_vo(port_cfg, device="cpu")
    fed_queue = iter(ref_feats)

    def fed_extract(imgs):
        f, u, d = next(fed_queue)
        f = list(f)
        f[4] = f[4].view(np.int32)
        return Features(*(torch.from_numpy(x) for x in f)), torch.from_numpy(u), torch.from_numpy(d)

    fed._extract_pair = fed_extract
    runs = {"ref": ref, "own": own, "fed": fed}
    stats, stages = {k: {} for k in runs}, {k: [] for k in runs}
    for name, vo in runs.items():
        record_frames(vo, stats[name])
    for i, (imgL, imgR) in enumerate(frames):
        for name, vo in runs.items():
            if i == flush_at:
                vo.flush()
            stage = vo._init_stage
            vo.process_stereo_inertial(imgL, imgR, iw.imu_per_frame[i], iw.timestamps[i])
            if vo._init_stage != stage:
                stages[name].append(vo.records[-1].frame_id)
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    for vo in runs.values():
        vo.flush()
    trajs = {name: vo.trajectory_wc() for name, vo in runs.items()}

    def summary(name, vo):
        ate = ref_evaluation.ate_rmse(trajs[name][:, :3, 3], iw.world.poses_wc[:n, :3, 3])
        g = np.asarray(vo.g_w_dev, np.float64)
        cos = g @ iw.gravity_w / max(np.linalg.norm(g) * np.linalg.norm(iw.gravity_w), 1e-12)
        return {"ate_cm": ate["rmse"] * 100.0, "keyframes": vo.n_kf, "map_points": vo.n_mp,
                "lost": sum(1 for r in vo.records if r.state != "OK"),
                "imu_ready": bool(vo.imu_ready), "init_stage": int(vo._init_stage),
                "init_stage_frames": stages[name],
                "gravity_angle_deg": float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
                "bias_gyro": np.asarray(vo.bg_dev, np.float64).tolist(),
                "bias_acc": np.asarray(vo.ba_dev, np.float64).tolist(),
                "keyframe_frames": [r.frame_id for r in vo.records
                                    if np.array_equal(r.T_rel, np.eye(4))]}

    def pose_diff(name, dep):
        d = np.abs(trajs[name][:, :3, 3] - trajs["ref"][:, :3, 3]).max(axis=1)
        f = n if dep is None else dep["frame"]
        return {"before": float(d[:f].max()) if f > 0 else 0.0,
                "at": None if dep is None else float(d[f]), "end": float(d[-1])}

    deps = {k: first_departure(stats["ref"], stats[k], n) for k in ("own", "fed")}
    print(json.dumps({
        "world": f"{chip_smoke.W}x{chip_smoke.H}, {n} frames of tools/bench_vio.py's world,"
                 f" smoother {'on' if smoother else 'off'}, drained before frame {flush_at}, CPU",
        "first_departure_own": deps["own"], "first_departure_fed": deps["fed"],
        "first_state_departure_own": state_departure(ref, own),
        "first_state_departure_fed": state_departure(ref, fed),
        "position_max_abs_diff_m_own": pose_diff("own", deps["own"]),
        "position_max_abs_diff_m_fed": pose_diff("fed", deps["fed"]),
        "ref": summary("ref", ref), "own": summary("own", own), "fed": summary("fed", fed),
        "seconds": time.time() - t0,
    }))


def mono_report(n: int) -> None:
    """MonoVO's reference, own, fed and fed_ba runs over the left images of
    tools/bench_vio.py's world; one JSON line."""
    from slice_reference_ate import mono_config as ref_mono_config
    from test_torch_mono_vo import _feed, _instrument_reference, _Snapshots
    from vi_slam_tpu.pipeline import mono_vo as ref_mono
    from vi_slam_tpu_torch.pipeline.mono_vo import MonoVO

    t0 = time.time()
    iw, frames = chip_smoke.vio_world()
    ref_cfg = ref_mono_config()
    port_cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    ref = ref_mono.MonoVO(ref_cfg)
    snaps = _Snapshots()
    _instrument_reference(ref, snaps)
    ref_feats, solves = [], []
    extract = ref.extractor

    def ref_extract(img):
        f = extract(img)
        ref_feats.append([np.array(x) for x in f])
        return f

    ref.extractor = ref_extract
    two_view = ref_mono.reconstruct_two_view

    def solve(*a, **kw):
        res = two_view(*a, **kw)
        if bool(res.ok):
            solves.append((bool(res.used_homography), int(res.n_good)))
        return res

    ref_mono.reconstruct_two_view = solve
    try:
        for i in range(n):
            ref.process_mono(frames[i][0], iw.timestamps[i])
            print(f"ref frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    finally:
        ref_mono.reconstruct_two_view = two_view
    own = MonoVO(port_cfg, device="cpu")
    fed = MonoVO(port_cfg, device="cpu", draw=ReferenceDraws(3))
    fed_ba = MonoVO(port_cfg, device="cpu", draw=ReferenceDraws(3))
    _feed(fed_ba, snaps)
    for vo in (fed, fed_ba):
        queue = iter(ref_feats)

        def fed_extract(img, _q=queue):
            f = list(next(_q))
            f[4] = f[4].view(np.int32)
            return Features(*(torch.from_numpy(x) for x in f))

        vo.extractor = fed_extract
    runs = {"own": own, "fed": fed, "fed_ba": fed_ba}
    stats = {k: {} for k in runs}
    for name, vo in runs.items():
        record_frames(vo, stats[name])
    for i in range(n):
        for vo in runs.values():
            vo.process_mono(frames[i][0], iw.timestamps[i])
        print(f"port frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    ref_stats = {r.frame_id: (s.n_kfs, s.n_inliers, s.n_mps) for r, s in zip(ref.records,
                                                                             ref.stats)}
    trajs = {"ref": ref.trajectory_wc(), **{k: vo.trajectory_wc() for k, vo in runs.items()}}

    def summary(name, vo, init):
        states = [r.state for r in vo.records]
        ok = [i for i, st in enumerate(states) if st == "OK"]
        ate = ref_evaluation.ate_rmse(trajs[name][ok, :3, 3], iw.world.poses_wc[ok, :3, 3],
                                      with_scale=True)
        first = states.index("OK") if ok else None
        return {"init_frame": first, "two_view": init, "ate_cm": ate["rmse"] * 100.0,
                "horn_scale": ate["scale"], "keyframes": vo.n_kf, "map_points": vo.n_mp,
                "lost_after_init": None if first is None else sum(
                    1 for st in states[first:] if st != "OK"),
                "keyframe_frames": np.asarray(vo.map.kf_frame_id[:vo.n_kf]).tolist()}

    out = {"world": f"{chip_smoke.W}x{chip_smoke.H}, the left images of {n} frames of"
                    " tools/bench_vio.py's world, sensor MONOCULAR, bf 0, CPU",
           "ref": summary("ref", ref, solves[-1] if solves else None)}
    for k, vo in runs.items():
        out[f"first_departure_{k}"] = first_departure(ref_stats, stats[k], n)
        out[f"first_state_departure_{k}"] = state_departure(ref, vo)
        out[k] = summary(k, vo, vo.init_result)
    out["seconds"] = time.time() - t0
    print(json.dumps(out))


def mono_seeds_report(n: int) -> None:
    """tests/test_mono_vo.py's world, its first `n` frames, over five
    two-view seeds: the reference, and the port with and without its
    monocular guards; one JSON line."""
    import test_torch_mono_vo as tm
    from vi_slam_tpu.pipeline import mono_vo as ref_mono
    from vi_slam_tpu_torch.pipeline.mono_vo import MonoVO
    from vi_slam_tpu_torch.utils.sampling import Sampler

    torch.set_num_threads(1)  # as the test runs it: the sums' order moves the runs
    t0 = time.time()
    world, frames = tm.mono_frames()  # the test's world (its length sets the landmarks)
    frames = frames[:n]
    cfg = tm.make_cfg()

    def summary(vo):
        traj = vo.trajectory_wc()
        ok = [i for i, r in enumerate(vo.records) if r.state == "OK"]
        ate = tm._ate(world, vo, traj) if len(ok) >= 3 else {"rmse": None}
        return {"ate_m": ate["rmse"], "ok_frames": len(ok), "keyframes": vo.n_kf,
                "map_points": vo.n_mp, "ate_limit_m": tm._ate_limit(world, vo) if ok else None}

    out = {"world": f"tests/test_mono_vo.py's, {n} frames, CPU", "ref": [], "port": [],
           "port_no_guards": []}
    for k in range(5):
        seed = 3 + 100 * k
        ref = ref_mono.MonoVO(cfg)
        ref._key = jax.random.PRNGKey(seed)
        for i, fr in enumerate(frames):
            ref.process_oracle_mono(fr.xy, fr.desc, fr.level, i * 0.1)
        out["ref"].append({"key": seed, **summary(ref)})
        for name, guards in (("port", True), ("port_no_guards", False)):
            vo = MonoVO(tm.port_cfg(cfg), device="cpu", draw=Sampler(seed, "cpu"))
            if not guards:
                vo.ba_guard = False
                vo._rescale_initial_map = lambda ids: None
            for i, fr in enumerate(frames):
                vo.process_oracle_mono(fr.xy, fr.desc, fr.level, i * 0.1)
            out[name].append({"seed": seed, **summary(vo)})
        print(f"seed {seed} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    out["seconds"] = time.time() - t0
    print(json.dumps(out))


def klt_frame_on_reference_state(ref_cfg, port_cfg, frames, f):
    """The reference run again up to frame `f`, its KLT frame program's
    inputs at `f` kept (map, track set, previous pyramid, carry, motion
    model); then the port's frame program on those same inputs, fed the
    reference's features. Returns both sides' packed counts and pose
    difference: equal counts put the departure in the state before `f`."""
    from test_torch_klt_vo import ReferenceFeatures

    from vi_slam_tpu_torch.lie.se3 import SE3
    from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy

    ref = ref_make_stereo_vo(ref_cfg)
    store = ReferenceFeatures(ref)
    fn, kept = ref._frame_klt_fn, {}

    def frame(*a):
        if int(a[10]) == f:
            kept["args"] = jax.tree_util.tree_map(np.array, a)
        out = fn(*a)
        if int(a[10]) == f:
            kept["packed"] = np.array(out[0].packed)
        return out

    ref._frame_klt_fn = frame
    for i in range(f + 1):
        if i == chip_smoke.N_WARM:
            ref.flush()
        ref.process_stereo(*frames[i], i * 0.1)
    ref.flush()
    a = kept["args"]
    port = make_stereo_vo(port_cfg, device="cpu")
    store.feed(port)

    def t(x):
        return torch.from_numpy(np.array(x))

    port.map = map_state_from_numpy(dict(zip(ref.map._fields, a[1])), device="cpu")
    port.prev_pyr = tuple(t(x) for x in a[2])
    port.trk_xy, port.trk_mp, port.trk_level, port.trk_valid = (t(x) for x in a[3:7])
    port.carry_dev = t(a[7])
    port.T_dev, port.vel_dev = SE3(t(a[8].R), t(a[8].t)), SE3(t(a[9].R), t(a[9].t))
    got = port._frame_klt(t(a[0]), f, float(a[11])).packed.numpy()
    want = kept["packed"]
    return {"frame": f, "ref_counts": want[24:].tolist(), "port_counts": got[24:].tolist(),
            "pose_max_abs_diff": float(np.abs(got[:12] - want[:12]).max())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--bench-cadences", action="store_true",
                    help="bench.py's mapping/local-BA/maintenance cadences, over the"
                         " full phase's 200-frame world")
    ap.add_argument("--loop", action="store_true",
                    help="bench.py --loop's world with a vocabulary, atlas off")
    ap.add_argument("--klt", action="store_true",
                    help="bench.py --frontend klt over the first --frames of its world")
    ap.add_argument("--mono", action="store_true",
                    help="MonoVO over the left images of tools/bench_vio.py's world")
    ap.add_argument("--mono-seeds", action="store_true",
                    help="tests/test_mono_vo.py's world over five two-view seeds")
    ap.add_argument("--vio", action="store_true",
                    help="tools/bench_vio.py's stereo-inertial configuration and world")
    ap.add_argument("--smoother", action="store_true",
                    help="with --vio: the fixed-lag smoother on")
    args = ap.parse_args()
    if args.mono:
        mono_report(args.frames)
        return
    if args.mono_seeds:
        mono_seeds_report(args.frames)
        return
    if args.vio:
        vio_report(args.frames, args.smoother)
        return
    if args.klt:
        klt_report(args.frames)
        return
    n = args.frames
    t0 = time.time()
    W, H = chip_smoke.W, chip_smoke.H
    if args.loop:
        world, frames = loop_frames(n)
        n_world = n
    else:
        n_world = chip_smoke.N_FULL_FRAMES if args.bench_cadences else chip_smoke.SLICE_WORLD_FRAMES
        world = synthetic.make_billboard_world(n_frames=n_world, n_boards=4000, seed=11, speed=1.0)
        frames = chip_smoke.render_frames(world, n)
    left0 = frames[0][0].astype(np.uint8).astype(np.float32)

    ref_cfg = ref_slice_config(args.bench_cadences or args.loop, atlas=not args.loop)
    port_cfg = config_from_dict(dataclasses.asdict(ref_cfg))
    ref_vocab = bench_vocabulary(ref_cfg, frames) if args.loop else None

    # the reference, with the features of each frame captured
    ref_feats, ref_stats = [], {}
    ref = ref_make_stereo_vo(ref_cfg, vocab=ref_vocab)
    frame_fn, extract_fn = ref._frame_fn, ref._extract_pair_fn

    def ref_frame(*a):
        out = frame_fn(*a)
        ref_feats.append(([np.array(x) for x in out[3]], np.array(out[4]), np.array(out[5])))
        return out

    def ref_extract(imgs):
        out = extract_fn(imgs)
        ref_feats.append(([np.array(x) for x in out[0]], np.array(out[1]), np.array(out[2])))
        return out

    ref._frame_fn, ref._extract_pair_fn = ref_frame, ref_extract
    record_frames(ref, ref_stats)

    own_feats, own_stats = [], {}
    own = make_stereo_vo(port_cfg, device="cpu",
                         vocab=own_vocabulary(port_cfg, frames) if args.loop else None)
    own_extract = own._extract_pair

    def own_capture(imgs):
        f, u, d = own_extract(imgs)
        own_feats.append(([x.numpy().copy() for x in f], u.numpy().copy(), d.numpy().copy()))
        return f, u, d

    own._extract_pair = own_capture
    record_frames(own, own_stats)

    fed_stats = {}
    fed = make_stereo_vo(port_cfg, device="cpu",
                         vocab=port_vocabulary(ref_vocab) if args.loop else None)
    if args.loop:
        fed.loop_closer.draw = ReferenceDraws(7)
        fed.relocalizer.draw = ReferenceDraws(11)
    closes = {"ref": [], "own": [], "fed": []}
    ref_counts = {}
    if args.loop:
        instrument_loop(ref, ref_counts)
        for name, vo in (("ref", ref), ("own", own), ("fed", fed)):
            loop_events(vo, closes[name])
    fed_queue = iter(ref_feats)

    def fed_extract(imgs):
        f, u, d = next(fed_queue)
        f = list(f)
        f[4] = f[4].view(np.int32)
        return Features(*(torch.from_numpy(x) for x in f)), torch.from_numpy(u), torch.from_numpy(d)

    fed._extract_pair = fed_extract
    record_frames(fed, fed_stats)

    for i, (imgL, imgR) in enumerate(frames):
        if args.loop and i == chip_smoke.N_WARM:
            for vo in (ref, own, fed):
                vo.flush()
        ref.process_stereo(imgL, imgR, i * 0.1)
        own.process_stereo(imgL, imgR, i * 0.1)
        fed.process_stereo(imgL, imgR, i * 0.1)
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    trajs = {name: vo.trajectory_wc() for name, vo in (("ref", ref), ("own", own), ("fed", fed))}

    own_dep = first_departure(ref_stats, own_stats, n)
    fed_dep = first_departure(ref_stats, fed_stats, n)
    at = None
    if own_dep is not None:
        f = own_dep["frame"]
        left = frames[f][0].astype(np.uint8).astype(np.float32)
        rf, r_u, r_d = ref_feats[f]
        pf, p_u, p_d = own_feats[f]
        at = feature_diff(own.extractor, left, rf, pf, r_d, p_d)
        at["frame"] = f
        at["accounted_for_by"] = (
            "the features (H6 pyramid, H7 flat-pair bits): the fed port tracks"
            " like the reference through this frame"
            if fed_dep is None or fed_dep["frame"] > f else
            "the port's tracking: the fed port departs too")

    ref_levels = [np.asarray(x) for x in jax.jit(ref_pyr.build_pyramid, static_argnums=(1, 2))(
        jnp.asarray(left0), 8, 1.2)]
    port_levels = [x.numpy() for x in pyr_ops.build_pyramid(
        torch.from_numpy(left0), 8, 1.2, own.extractor.pyramid_weights())]

    def summary(name, vo):
        ate = ref_evaluation.ate_rmse(trajs[name][:, :3, 3], world.poses_wc[:n, :3, 3])
        out = {"keyframes": vo.n_kf, "map_points": vo.n_mp, "ate_cm": ate["rmse"] * 100.0,
               "lost": sum(1 for r in vo.records if r.state != "OK")}
        if args.loop:
            st = vo.loop_closer.stats
            out.update(loop_queries=st.n_queries, loops_closed=st.n_loops_closed,
                       loops_closed_after_frames=closes[name],
                       relocalized=ref_counts.get("reloc_ok", 0) if vo is ref else vo.n_relocalized)
        return out

    print(json.dumps({
        "world": f"{W}x{H}, {n} frames of the {n_world}-frame"
                 f" {'loop' if args.loop else 'billboard'} world, cadences"
                 f" {'bench' if args.bench_cadences or args.loop else 'off'}, CPU",
        "first_state_departure_own": state_departure(ref, own) if args.loop else None,
        "first_state_departure_fed": state_departure(ref, fed) if args.loop else None,
        "first_departure_own": own_dep,
        "first_departure_fed": fed_dep,
        "features_at_own_departure": at,
        "pyramid_max_abs_diff_frame0": [float(np.abs(a - b).max())
                                        for a, b in zip(ref_levels, port_levels)],
        "ref": summary("ref", ref), "own": summary("own", own), "fed": summary("fed", fed),
        "seconds": time.time() - t0,
    }))


if __name__ == "__main__":
    main()
