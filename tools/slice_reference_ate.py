"""Reference accuracy of the PyTorch port's main path, on the host CPU.

Runs the JAX package's `StereoVO.process_stereo` (x64 off, CPU) over the
worlds that `chip_smoke.py` drives:
`make_billboard_world(n_frames=F, n_boards=4000, seed=11, speed=1.0)`
rendered at 1241x376 with bench.py's configuration. By default the
mapping, local-BA and maintenance cadences are set beyond the run's
length (the smoke's cadence-off slice phase, 100 frames); with
`--bench-cadences` they are bench.py's (mapping every 2nd keyframe, local
BA every 3rd, maintenance every 8th: the smoke's full phase, 200 frames).
Prints the ATE RMSE in cm, the lost-frame count, the keyframe, map-point
and culled-keyframe counts, and the commit, as one JSON line.

With `--loop` it runs `bench.py --loop`'s world instead (the closed
circle of `make_billboard_inertial_sequence(closed_loop=True)`, period
0.8 x the frames, 5 m/s) with bench.py's cadences and a vocabulary
trained as bench.py trains it (ORB descriptors of every (frames // 10)-th
left image, k=8, 3 levels, 4 iterations, seed 3), so loop closing and
relocalization run. It adds the loop figures: relocalizations (attempts
and fixes), loop queries, loops closed, global-BA runs, map forks and
merges of the atlas, and the runs of each loop program (BoW add, loop
detection, Sim3 verification, essential-graph correction, global BA,
relocalization attempt, map fork, merge detection, merge; "merge_try_ok"
counts the merges done), and the frame dispatched last when each fork and
merge happened. `--no-atlas` sets `atlas_enabled=False`.

With `--ring` it runs the board ring instead: a closed circle of 3 m
driven once every 100 frames (3.6 degrees a frame) inside a ring of 1500 textured boards all
round it (`vi_slam_tpu_torch.io.synthetic.make_board_ring_loop`, built
here from the JAX package's own world functions), rendered at 1241x376,
with bench.py's configuration and the vocabulary trained as for `--loop`.
Tracking holds all round this circle, and the frames after the first
period re-see the start, so a loop closes and global BA runs. It adds the
loop figures as `--loop` does, and the frame on which each loop was
corrected (the frames dispatched when the correction ends).

    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py [--frames 100]
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --bench-cadences --frames 120 --world-frames 200 --flush-at 10
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --frames 30 --world-frames 50 --flush-at 10
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --loop --frames 200 --flush-at 10 [--no-atlas]
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --ring --frames 120 --flush-at 10 --no-atlas
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --vio [--smoother] --frames 60 --flush-at 8
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --klt --frames 60 --flush-at 10
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --rgbd --frames 30
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --mono --frames 60
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --mono-inertial --frames 60 [--perturb SEED]
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --mono-inertial --oracle --frames 60 [--key SEED]

With `--vio` it runs `tools/bench_vio.py`'s configuration instead: the
stereo-inertial pipeline (`StereoInertialVO.process_stereo_inertial`) over
`make_billboard_inertial_sequence(F, ..., n_landmarks=2000, seed=5)` with
its 200 Hz IMU stream, no vocabulary. It adds the inertial figures:
`imu_ready`, the final initialization stage and the frame of each stage,
the estimated gyro and accelerometer biases beside the truth, the angle of
the estimated gravity to the truth, and the runs of each program
(integration, inertial track, inertial init, VI local BA, full inertial BA,
mapping pass, maintenance). `--smoother` turns the fixed-lag smoother on
(`use_smoother=True`, as `tools/bench_vio.py --smoother` does) and adds its
steps (one in every inertial track) and slides (a step that found the
window full and marginalized its oldest state first).

With `--klt` it runs bench.py's configuration with `frontend="klt"`
(`bench.py --frontend klt`: the KLT track-then-redetect frontend of
`pipeline/klt_vo.py`) over the first F frames of bench.py's 200-frame world
(`make_billboard_world(n_frames=200, n_boards=4000, seed=11, speed=1.0)`).
It adds the KLT figures: the frames whose ORB rescue ran, the keyframes
made by the KLT keyframe branch (frames), relocalizations, and the runs of
the keyframe-rate programs.

With `--rgbd` it runs `StereoVO.process_rgbd` over the same world's first
F frames at bench.py's configuration: the left images as `--klt` renders
them, and depth maps from the port's numpy z-buffer
(`vi_slam_tpu_torch.io.synthetic.render_billboard_depth`, the rasterizer
of tests/test_lifecycle.py), so that the reference gets the same maps as
`chip_smoke.py`'s rgbd phase.

With `--mono` it runs `MonoVO.process_mono` over the left images of
`tools/bench_vio.py`'s world (`make_billboard_inertial_sequence(F, ...,
n_landmarks=2000, seed=5)`) at its camera, extractor, BA and tracker
settings with `sensor=MONOCULAR` and `bf=0` (the smoke's mono phase). The
monocular path tracks synchronously, so there is no pipeline to drain and
`--flush-at` does not apply. It prints the frame of the first OK record
(initialization), the frames lost after it, the keyframes (and the frame
of each) and map points, the scale-aligned ATE over the OK frames
(`ate_rmse(with_scale=True)`) with its Horn scale, the accepted two-view
solve's model and good count, the runs of the keyframe-rate programs, and
the keyframes from `_create_keyframe` with the new points each
triangulated.

With `--mono-inertial` it runs `MonoInertialVO.process_mono_inertial` over
the left images and the 200 Hz IMU stream of `tools/bench_vio.py`'s world
at its configuration with `sensor=IMU_MONOCULAR` and `bf=0` (the smoke's
mono-inertial image run); with `--oracle` as well,
`process_oracle_mono_inertial` over tests/test_mono_inertial.py's world
(oracle features with 0.3 px noise at 640x480, `make_inertial_world(60,
10 fps, 8000 landmarks, seed 3, excitation 4.0)`) at that test's
configuration (the smoke's oracle run). `--key SEED` replaces the two-view
RANSAC key PRNGKey(3) by PRNGKey(SEED). Both track synchronously, so
`--flush-at` does not apply. It prints the states (first letters), the
init frame, the LOST frames after the two bootstrap frames, `imu_ready`,
the initialization stages with their frames and the scale applied at each,
the Horn scale and the scale-aligned and unscaled ATE over the OK frames,
the gravity's angle to the truth, the biases, the keyframe frames and the
runs of each program.

This is an accuracy figure, not a speed: `chip_smoke.py` holds the port's
ATE on the GPU to it.

`--world-frames N` builds the billboard world for N frames (default: the
frames run) and runs its first `--frames`: the world's boards depend on
its length, so the smoke's full phase (the first 120 frames of bench.py's
200-frame world) and slice phase (the first 30 of a 50-frame world) take
their references with `--world-frames 200` and `--world-frames 50`.

`--flush-at N` drains the pipeline before frame N, as bench.py does at
the end of its warm-up (`--warmup`, 10) and `chip_smoke.py` does at frame
N_WARM (10) before it starts the steady clock. The drain changes which
frames' results the host decisions see (they lag `pipeline_depth`
frames), so the trajectory depends on it; the full phase's reference is
taken with `--flush-at 10`, as the smoke runs.

`--perturb SEED` moves 20 random pixels of every left image by one grey
level (up or down, drawn from SEED): a change far below the port's known
differences from the reference (ROADMAP H6, H7), to measure how far the
reference's own ATE moves under it.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vi_slam_tpu.features.extractor import OrbExtractor  # noqa: E402
from vi_slam_tpu.io import evaluation, synthetic  # noqa: E402
from vi_slam_tpu.retrieval import vocabulary as voc  # noqa: E402
from vi_slam_tpu.pipeline.klt_vo import make_stereo_vo  # noqa: E402
from vi_slam_tpu.pipeline import vio as ref_vio  # noqa: E402
from vi_slam_tpu.utils.config import (  # noqa: E402
    BAConfig, CameraConfig, ExtractorConfig, IMUConfig, MapConfig, Sensor, SystemConfig,
    TrackerConfig,
)

W, H = 1241, 376
FX = FY = 718.856
CX, CY = 607.1928, 185.2157
BF = 386.1448
NEVER = 10 ** 9  # a keyframe cadence no run reaches


def slice_config(bench_cadences: bool = False, atlas: bool = True) -> SystemConfig:
    """bench.py's configuration; the keyframe-rate programs off unless
    `bench_cadences`."""
    every = dict(maintenance_every=8, local_ba_every=3, mapping_every=2) if bench_cadences \
        else dict(maintenance_every=NEVER, local_ba_every=NEVER, mapping_every=NEVER)
    return SystemConfig(
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                            bf=BF, th_depth=35.0),
        extractor=ExtractorConfig(n_features=2000, use_pallas_fast=True),
        ba=BAConfig(max_local_kfs=6, max_local_points=2048,
                    local_ba_iters=2, mapping_fuse_window=1),
        map=MapConfig(max_keyframes=256, max_points=65536,
                      max_obs_per_point=8),
        tracker=TrackerConfig(min_frames_between_kf=1, pipeline_depth=3,
                              atlas_enabled=atlas, **every),
    )


def vio_config(smoother: bool = False) -> SystemConfig:
    """tools/bench_vio.py's configuration (`--smoother`: the fixed-lag
    smoother on)."""
    return SystemConfig(
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                            bf=BF, th_depth=35.0, fps=10.0),
        extractor=ExtractorConfig(n_features=2000),
        ba=BAConfig(max_local_kfs=6, max_local_points=2048, local_ba_iters=4,
                    inertial_window=8, mapping_fuse_window=1, use_smoother=smoother),
        map=MapConfig(max_keyframes=256, max_points=65536, max_obs_per_point=8),
        imu=IMUConfig(freq=200.0),
        tracker=TrackerConfig(max_frames_between_kf=4, maintenance_every=8,
                              local_ba_every=2, mapping_every=2),
    )


def instrument_vio(vo, counts, stage_frames):
    """Count the inertial programs of a reference StereoInertialVO (with the
    smoother on, its steps and slides too), and record the frame of each
    initialization stage."""
    for attr, key in (("_integrate_fn", "integrate"), ("_vi_ba_fn", "vi_local_ba"),
                      ("_full_vi_ba_fn", "full_inertial_ba"), ("_mapping_fn", "mapping"),
                      ("_maintenance_fn", "maintenance")):
        count_calls(vo, attr, counts, key)
    smoother = vo.cfg.ba.use_smoother
    window = vo.cfg.ba.smoother_window

    def tracked(fn, fused):
        def wrapped(*a, **kw):  # the last argument: the smoother's step count
            if fused:  # one fused frame integrates and tracks
                counts["integrate"] = counts.get("integrate", 0) + 1
            counts["track_vio"] = counts.get("track_vio", 0) + 1
            if smoother:
                counts["smoother"] = counts.get("smoother", 0) + 1
                if int(a[-1]) >= window:
                    counts["smoother_slide"] = counts.get("smoother_slide", 0) + 1
            return fn(*a, **kw)
        return wrapped

    vo._track_vio_fn = tracked(vo._track_vio_fn, False)
    vo._frame_vio_fn = tracked(vo._frame_vio_fn, True)
    count_calls(ref_vio.iinit, "inertial_init", counts, "inertial_init")
    init = vo._maybe_init_imu

    def maybe_init():
        stage = vo._init_stage
        init()
        if vo._init_stage != stage:
            stage_frames.append(vo.records[-1].frame_id)

    vo._maybe_init_imu = maybe_init


def run_vio(args):
    """bench_vio.py's run: (figures, ATE)."""
    iw, _, frames = synthetic.make_billboard_inertial_sequence(
        args.frames, FX, FY, CX, CY, W, H, BF, n_landmarks=2000, seed=5)
    vo = ref_vio.StereoInertialVO(vio_config(args.smoother))
    counts, stage_frames = {}, []
    instrument_vio(vo, counts, stage_frames)
    t0 = time.time()
    for i, (imgL, imgR) in enumerate(frames):
        if i == args.flush_at:
            vo.flush()
        vo.process_stereo_inertial(imgL, imgR, iw.imu_per_frame[i], iw.timestamps[i])
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    est = vo.trajectory_wc()
    ate = evaluation.ate_rmse(est[:, :3, 3], iw.world.poses_wc[:, :3, 3])
    g = np.asarray(vo.g_w_dev, np.float64)
    cos = g @ iw.gravity_w / max(np.linalg.norm(g) * np.linalg.norm(iw.gravity_w), 1e-12)
    return {
        "imu_ready": bool(vo.imu_ready), "init_stage": int(vo._init_stage),
        "init_stage_frames": stage_frames,
        "gravity_angle_deg": float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
        "bias_gyro": np.asarray(vo.bg_dev).tolist(), "bias_acc": np.asarray(vo.ba_dev).tolist(),
        "bias_gyro_true": iw.bias_gyro.tolist(), "bias_acc_true": iw.bias_acc.tolist(),
        "programs": counts,
    }, vo, ate


def mono_config() -> SystemConfig:
    """tools/bench_vio.py's configuration with `sensor=MONOCULAR`, no
    baseline and the smoother off (the smoke's mono phase)."""
    cfg = vio_config()
    return dataclasses.replace(cfg, sensor=Sensor.MONOCULAR,
                               camera=dataclasses.replace(cfg.camera, bf=0.0))


def run_mono(args):
    """MonoVO over the left images of bench_vio.py's world: (figures,
    MonoVO, world)."""
    from vi_slam_tpu.pipeline import mono_vo as ref_mono

    iw, _, frames = synthetic.make_billboard_inertial_sequence(
        args.frames, FX, FY, CX, CY, W, H, BF, n_landmarks=2000, seed=5)
    vo = ref_mono.MonoVO(mono_config())
    counts, solves, new_points = {}, [], []
    for attr, key in (("_mapping_fn", "mapping"), ("_local_ba_fn", "local_ba"),
                      ("_maintenance_fn", "maintenance")):
        count_calls(vo, attr, counts, key)
    two_view = ref_mono.reconstruct_two_view

    def solve(*a, **kw):
        res = two_view(*a, **kw)
        solves.append((bool(res.ok), bool(res.used_homography), int(res.n_good)))
        return res

    ref_mono.reconstruct_two_view = solve
    create = vo._create_keyframe

    def created(*a, **kw):
        n = vo.n_mp
        out = create(*a, **kw)
        new_points.append((vo.frame_id, vo.n_mp - n))
        return out

    vo._create_keyframe = created
    rng = np.random.default_rng(args.perturb) if args.perturb is not None else None
    t0 = time.time()
    try:
        for i in range(args.frames):
            img = frames[i][0] if rng is None else perturbed(frames[i][0], rng)
            vo.process_mono(img, iw.timestamps[i])
            print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    finally:
        ref_mono.reconstruct_two_view = two_view
    states = [r.state for r in vo.records]
    first_ok = states.index("OK") if "OK" in states else None
    accepted = [s for s in solves if s[0]]
    return {
        "init_frame": first_ok,
        "lost_after_init": None if first_ok is None else sum(
            1 for s in states[first_ok:] if s != "OK"),
        "keyframe_frames": np.asarray(vo.map.kf_frame_id[:vo.n_kf]).tolist(),
        "two_view_attempts": len(solves),
        "used_homography": accepted[-1][1] if accepted else None,
        "n_good": accepted[-1][2] if accepted else None,
        "programs": counts,
        "created_keyframes": [[f, n] for f, n in new_points],
    }, vo, iw.world


# tests/test_mono_inertial.py's world and configuration (the smoke's
# mono-inertial oracle run)
ORACLE_W, ORACLE_H, ORACLE_F = 640, 480, 500.0


def mono_inertial_config(oracle: bool) -> SystemConfig:
    """With `oracle`, tests/test_mono_inertial.py's configuration; else
    tools/bench_vio.py's with `sensor=IMU_MONOCULAR` and `bf=0`."""
    if oracle:
        return SystemConfig(
            sensor=Sensor.IMU_MONOCULAR,
            camera=CameraConfig(width=ORACLE_W, height=ORACLE_H, fx=ORACLE_F, fy=ORACLE_F,
                                cx=320.0, cy=240.0, bf=0.0, fps=10.0),
            extractor=ExtractorConfig(n_features=1200),
            ba=BAConfig(max_local_kfs=8, max_local_points=2048, local_ba_iters=6,
                        inertial_window=8),
            map=MapConfig(max_keyframes=128, max_points=32768, max_obs_per_point=8),
            imu=IMUConfig(freq=200.0),
            tracker=TrackerConfig(max_frames_between_kf=4),
        )
    cfg = vio_config()
    return dataclasses.replace(cfg, sensor=Sensor.IMU_MONOCULAR,
                               camera=dataclasses.replace(cfg.camera, bf=0.0))


def run_mono_inertial(args):
    """MonoInertialVO over tests/test_mono_inertial.py's oracle world
    (`--oracle`) or over the left images and IMU stream of bench_vio.py's
    world: (figures, MonoInertialVO, InertialWorld)."""
    vo = ref_vio.MonoInertialVO(mono_inertial_config(args.oracle))
    if args.key is not None:
        vo._key = jax.random.PRNGKey(args.key)
    counts, stage_frames, scales = {}, [], []
    instrument_vio(vo, counts, stage_frames)
    count_calls(vo, "_local_ba_fn", counts, "local_ba")
    apply_scale = vo._apply_map_scale

    def applied(s):
        scales.append(float(s))
        return apply_scale(s)

    vo._apply_map_scale = applied
    t0 = time.time()
    if args.oracle:
        iw = synthetic.make_inertial_world(n_frames=60, fps=10.0, n_landmarks=8000, seed=3,
                                           excitation=4.0)
        for i in range(args.frames):
            fr = synthetic.render_oracle_frame(iw.world, i, ORACLE_F, ORACLE_F, 320.0, 240.0,
                                               250.0, ORACLE_W, ORACLE_H, max_features=1000,
                                               px_noise=0.3)
            vo.process_oracle_mono_inertial(fr.xy, fr.desc, fr.level, iw.imu_per_frame[i],
                                            iw.timestamps[i])
            print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    else:
        iw, _, frames = synthetic.make_billboard_inertial_sequence(
            args.frames, FX, FY, CX, CY, W, H, BF, n_landmarks=2000, seed=5)
        rng = np.random.default_rng(args.perturb) if args.perturb is not None else None
        for i in range(args.frames):
            img = frames[i][0] if rng is None else perturbed(frames[i][0], rng)
            vo.process_mono_inertial(img, iw.imu_per_frame[i], iw.timestamps[i])
            print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    vo.flush()
    states = [r.state for r in vo.records]
    first_ok = states.index("OK") if "OK" in states else None
    g = np.asarray(vo.g_w_dev, np.float64)
    cos = g @ iw.gravity_w / max(np.linalg.norm(g) * np.linalg.norm(iw.gravity_w), 1e-12)
    return {
        "init_frame": first_ok, "states": "".join(st[0] for st in states),
        "lost_after_bootstrap": states[2:].count("LOST"),
        "not_ok_after_init": None if first_ok is None else sum(
            1 for st in states[first_ok:] if st != "OK"),
        "last_state": states[-1],
        "imu_ready": bool(vo.imu_ready), "init_stage": int(vo._init_stage),
        "init_stage_frames": stage_frames, "applied_scales": scales,
        "gravity_angle_deg": float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
        "bias_gyro": np.asarray(vo.bg_dev).tolist(), "bias_acc": np.asarray(vo.ba_dev).tolist(),
        "keyframe_frames": np.asarray(vo.map.kf_frame_id[:vo.n_kf]).tolist(),
        "programs": counts,
    }, vo, iw


def loop_frames(n_frames: int):
    """bench.py --loop's world: (landmark world, stereo frames)."""
    iw, _, frames = synthetic.make_billboard_inertial_sequence(
        n_frames, FX, FY, CX, CY, W, H, BF, fps=10.0, n_landmarks=2000, n_boards=4000,
        seed=11, closed_loop=True, closed_loop_period_frames=int(n_frames * 0.8), speed=5.0,
    )
    return iw.world, frames


RING_PERIOD, RING_RADIUS = 100, 3.0


def ring_frames(n_frames: int):
    """The board ring: (billboard world, stereo frames)."""
    w_c = 2 * np.pi / (RING_PERIOD / 10.0)
    iw = synthetic.make_inertial_world(
        n_frames=n_frames, fps=10.0, n_landmarks=10, seed=11, speed=RING_RADIUS * w_c,
        closed_loop=True, closed_loop_period_frames=RING_PERIOD)
    rng = np.random.default_rng(13)
    nb = 1500
    ang = rng.uniform(0, 2 * np.pi, nb)
    rad = rng.uniform(RING_RADIUS + 4, RING_RADIUS + 25, nb)
    centers = np.stack([RING_RADIUS - rad * np.cos(ang), rng.uniform(-3, 2, nb),
                        rad * np.sin(ang)], -1)
    world = synthetic.BillboardWorld(
        centers=centers, sizes=rng.uniform(0.3, 1.2, nb), intensities=rng.uniform(60, 255, nb),
        poses_wc=iw.world.poses_wc,
        textures=rng.uniform(30, 255, (nb, 5, 5)).astype(np.float32))
    frames = [(synthetic.render_billboard_image(world, T, FX, FY, CX, CY, W, H, baseline=0.0),
               synthetic.render_billboard_image(world, T, FX, FY, CX, CY, W, H,
                                                baseline=BF / FX))
              for T in world.poses_wc[:n_frames]]
    return world, frames


def bench_vocabulary(cfg: SystemConfig, frames):
    """The vocabulary bench.py --loop trains on the sequence's own ORB
    descriptors."""
    ext = OrbExtractor(cfg.extractor, H, W)
    descs = []
    for i in range(0, len(frames), max(len(frames) // 10, 1)):
        f = ext(jnp.asarray(frames[i][0], jnp.float32))
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    return voc.train_vocabulary(np.concatenate(descs).astype(np.uint32), k=8, levels=3,
                                iters=4, seed=3)


def count_calls(obj, name, counts, key, success=None):
    """Wrap obj.name to count its calls (and, with `success`, the calls
    whose result it accepts) under counts[key]."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        counts[key] = counts.get(key, 0) + 1
        if success is not None and success(out):
            counts[key + "_ok"] = counts.get(key + "_ok", 0) + 1
        return out

    setattr(obj, name, wrapped)


def instrument_loop(vo, counts):
    """Count the loop programs of a reference StereoVO with a vocabulary."""
    lc = vo.loop_closer
    count_calls(lc, "add_bow", counts, "bow_add")
    count_calls(type(lc.db), "detect_loop_candidates_fused", counts, "detect")  # every map's db
    count_calls(lc, "_verify", counts, "verify", success=lambda out: out[0])
    count_calls(lc, "_correct", counts, "correct")
    count_calls(vo, "_try_relocalize", counts, "reloc", success=lambda n: n > 0)
    count_calls(vo, "_create_map_in_atlas", counts, "fork")
    count_calls(vo, "_try_merge_maps", counts, "merge_detect")
    count_calls(vo, "_do_merge", counts, "merge_try", success=lambda ok: ok)


BENCH_WORLD_FRAMES = 200  # bench.py's --frames default: its world's length


def bench_world():
    return synthetic.make_billboard_world(n_frames=BENCH_WORLD_FRAMES, n_boards=4000, seed=11,
                                          speed=1.0)


def stereo_pair(world, Twc):
    return (synthetic.render_billboard_image(world, Twc, FX, FY, CX, CY, W, H, baseline=0.0),
            synthetic.render_billboard_image(world, Twc, FX, FY, CX, CY, W, H,
                                             baseline=BF / FX))


def run_klt(args):
    """bench.py --frontend klt over the first `args.frames` frames of its
    world: (figures, StereoVO, world)."""
    cfg = slice_config(bench_cadences=True)
    cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, frontend="klt"))
    world = bench_world()
    vo = make_stereo_vo(cfg)
    counts, rescues, klt_kfs = {}, [], []
    for attr, key in (("_mapping_fn", "mapping"), ("_local_ba_fn", "local_ba"),
                      ("_maintenance_fn", "maintenance"), ("_extract_pair_fn", "extract")):
        count_calls(vo, attr, counts, key)
    count_calls(vo, "_try_relocalize", counts, "reloc", success=lambda n: n > 0)
    frame_fn, track = vo._frame_klt_fn, vo._track_core
    dispatched = [-1]

    def track_core(mstate, ref_slot, *a):  # traced into the rescue branch
        jax.debug.callback(lambda _: rescues.append(dispatched[0]), ref_slot)
        return track(mstate, ref_slot, *a)

    def frame(*a):  # a[10]: the frame id
        dispatched[0] = int(a[10])
        out = frame_fn(*a)
        jax.block_until_ready(out)  # the rescue's callback has run
        if np.asarray(out[0].packed)[30] > 0:
            klt_kfs.append(dispatched[0])
        return out

    vo._frame_klt_fn, vo._track_core = frame, track_core
    rng = np.random.default_rng(args.perturb) if args.perturb is not None else None
    t0 = time.time()
    for i in range(args.frames):
        if i == args.flush_at:
            vo.flush()
        imgL, imgR = stereo_pair(world, world.poses_wc[i])
        if rng is not None:
            imgL = perturbed(imgL, rng)
        vo.process_stereo(imgL, imgR, i * 0.1)
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    return {"programs": counts, "klt_keyframe_frames": klt_kfs, "rescue_frames": rescues,
            "relocalizations": counts.get("reloc_ok", 0)}, vo, world


def perturbed(img, rng):
    """img with 20 random pixels moved by one grey level (`--perturb`)."""
    img = np.array(img, np.float32)
    idx = rng.integers(0, img.size, 20)
    img.flat[idx] = np.clip(img.flat[idx] + rng.choice([-1.0, 1.0], 20), 0, 255)
    return img


def run_rgbd(args):
    """StereoVO.process_rgbd over the first `args.frames` frames of
    bench.py's world: (figures, StereoVO, world)."""
    from vi_slam_tpu_torch.io import synthetic as port_synthetic
    from vi_slam_tpu.pipeline.stereo_vo import StereoVO

    cfg = slice_config(bench_cadences=True)
    world = bench_world()
    vo = StereoVO(cfg)
    counts = {}
    for attr, key in (("_mapping_fn", "mapping"), ("_local_ba_fn", "local_ba"),
                      ("_maintenance_fn", "maintenance")):
        count_calls(vo, attr, counts, key)
    t0 = time.time()
    for i in range(args.frames):
        Twc = world.poses_wc[i]
        img = synthetic.render_billboard_image(world, Twc, FX, FY, CX, CY, W, H, baseline=0.0)
        depth = port_synthetic.render_billboard_depth(world, Twc, FX, FY, CX, CY, W, H)
        vo.process_rgbd(img, depth, i * 0.1)
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    return {"programs": counts}, vo, world


def git_commit() -> str:
    return subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    ).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--world-frames", type=int, metavar="N",
                    help="the billboard world's length (default: --frames); its first --frames run")
    ap.add_argument("--bench-cadences", action="store_true",
                    help="bench.py's mapping/local-BA/maintenance cadences (2/3/8)")
    ap.add_argument("--flush-at", type=int, metavar="N",
                    help="drain the pipeline before frame N (bench.py and the smoke: 10)")
    ap.add_argument("--perturb", type=int, metavar="SEED",
                    help="move 20 random pixels of each left image by one grey level")
    ap.add_argument("--loop", action="store_true",
                    help="bench.py --loop's closed-loop world and vocabulary (bench cadences)")
    ap.add_argument("--ring", action="store_true",
                    help="the board ring, where a loop closes (bench cadences, vocabulary)")
    ap.add_argument("--no-atlas", action="store_true", help="atlas_enabled=False")
    ap.add_argument("--vio", action="store_true",
                    help="tools/bench_vio.py's stereo-inertial configuration and world")
    ap.add_argument("--smoother", action="store_true",
                    help="with --vio: the fixed-lag smoother on (bench_vio.py --smoother)")
    ap.add_argument("--klt", action="store_true",
                    help="bench.py --frontend klt over the first --frames of its world")
    ap.add_argument("--rgbd", action="store_true",
                    help="process_rgbd over the first --frames of bench.py's world")
    ap.add_argument("--mono", action="store_true",
                    help="MonoVO over the left images of tools/bench_vio.py's world")
    ap.add_argument("--mono-inertial", action="store_true",
                    help="MonoInertialVO over the left images and IMU of tools/bench_vio.py's"
                         " world")
    ap.add_argument("--oracle", action="store_true",
                    help="with --mono-inertial: tests/test_mono_inertial.py's oracle world")
    ap.add_argument("--key", type=int, metavar="SEED",
                    help="with --mono-inertial: the two-view RANSAC key PRNGKey(SEED)"
                         " (default 3, the pipeline's own)")
    args = ap.parse_args()
    if args.mono_inertial:
        t0 = time.time()
        extra, vo, iw = run_mono_inertial(args)
        est = vo.trajectory_wc()
        ok = [i for i, r in enumerate(vo.records) if r.state == "OK"]
        gt = iw.world.poses_wc[ok, :3, 3]
        scaled = evaluation.ate_rmse(est[ok, :3, 3], gt, with_scale=True)
        unscaled = evaluation.ate_rmse(est[ok, :3, 3], gt, with_scale=False)
        out = {"frames": args.frames, "world": "oracle" if args.oracle else "vio_left",
               "perturb": args.perturb, "key": args.key, "ok_frames": len(ok),
               "horn_scale": scaled["scale"], "scaled_ate_cm": scaled["rmse"] * 100.0,
               "unscaled_ate_cm": unscaled["rmse"] * 100.0, "keyframes": vo.n_kf,
               "map_points": vo.n_mp, **extra, "commit": git_commit(),
               "platform": jax.devices()[0].platform, "seconds": time.time() - t0}
        print(json.dumps(out))
        return
    if args.mono:
        t0 = time.time()
        extra, vo, world = run_mono(args)
        est = vo.trajectory_wc()
        ok = [i for i, r in enumerate(vo.records) if r.state == "OK"]
        ate = evaluation.ate_rmse(est[ok, :3, 3], world.poses_wc[ok, :3, 3], with_scale=True)
        out = {"frames": args.frames, "world": "vio_left", "perturb": args.perturb,
               "ate_cm": ate["rmse"] * 100.0,
               "horn_scale": ate["scale"], "ok_frames": len(ok), "keyframes": vo.n_kf,
               "map_points": vo.n_mp, **extra, "commit": git_commit(),
               "platform": jax.devices()[0].platform, "seconds": time.time() - t0}
        print(json.dumps(out))
        return
    if args.klt or args.rgbd:
        t0 = time.time()
        extra, vo, world = (run_klt if args.klt else run_rgbd)(args)
        est = vo.trajectory_wc()
        ate = evaluation.ate_rmse(est[:, :3, 3], world.poses_wc[:args.frames, :3, 3])
        out = {"frames": args.frames, "world": "klt" if args.klt else "rgbd",
               "flush_at": args.flush_at, "perturb": args.perturb, "ate_cm": ate["rmse"] * 100.0,
               "lost": sum(1 for r in vo.records if r.state != "OK"),
               "keyframes": vo.n_kf, "map_points": vo.n_mp, **extra,
               "commit": git_commit(), "platform": jax.devices()[0].platform,
               "seconds": time.time() - t0}
        print(json.dumps(out))
        return
    if args.vio:
        t0 = time.time()
        extra, vo, ate = run_vio(args)
        out = {"frames": args.frames, "world": "vio", "smoother": args.smoother,
               "flush_at": args.flush_at,
               "ate_cm": ate["rmse"] * 100.0,
               "lost": sum(1 for r in vo.records if r.state != "OK"),
               "keyframes": vo.n_kf, "map_points": vo.n_mp, **extra,
               "commit": git_commit(), "platform": jax.devices()[0].platform,
               "seconds": time.time() - t0}
        print(json.dumps(out))
        return
    looped = args.loop or args.ring
    rng = np.random.default_rng(args.perturb) if args.perturb is not None else None
    t0 = time.time()
    cfg = slice_config(args.bench_cadences or looped, atlas=not args.no_atlas)
    counts = {}
    loop_frames_at = []
    if looped:
        world, frames = (ring_frames if args.ring else loop_frames)(args.frames)
        vo = make_stereo_vo(cfg, vocab=bench_vocabulary(cfg, frames))
        instrument_loop(vo, counts)
        events = []  # (frame dispatched last, "fork" or "merge")
        for name, tag in (("_create_map_in_atlas", "fork"), ("_do_merge", "merge")):
            fn = getattr(vo, name)

            def logged(*a, _fn=fn, _tag=tag, **kw):
                out = _fn(*a, **kw)
                if _tag == "fork" or out:
                    events.append((vo.frame_id, _tag))
                return out

            setattr(vo, name, logged)
        after = vo._after_loop_correction

        def corrected():
            loop_frames_at.append(vo.frame_id + 1)
            return after()

        vo._after_loop_correction = corrected
    else:
        world = synthetic.make_billboard_world(
            n_frames=args.world_frames or args.frames, n_boards=4000, seed=11, speed=1.0
        )
        vo = make_stereo_vo(cfg)
    for i in range(args.frames):
        if i == args.flush_at:
            vo.flush()
        if looped:
            imgL, imgR = frames[i]
        else:
            Twc = world.poses_wc[i]
            imgL = synthetic.render_billboard_image(
                world, Twc, FX, FY, CX, CY, W, H, baseline=0.0)
            imgR = synthetic.render_billboard_image(
                world, Twc, FX, FY, CX, CY, W, H, baseline=BF / FX)
        if rng is not None:
            imgL = perturbed(imgL, rng)
        vo.process_stereo(imgL, imgR, i * 0.1)
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr,
              flush=True)
    est = vo.trajectory_wc()
    ate = evaluation.ate_rmse(est[:, :3, 3], world.poses_wc[:args.frames, :3, 3])
    commit = git_commit()
    out = {
        "frames": args.frames,
        "world": "ring" if args.ring else "loop" if args.loop else "billboard",
        "world_frames": args.world_frames or args.frames,
        "atlas": not args.no_atlas,
        "cadences": "bench" if args.bench_cadences or looped else "never",
        "perturb": args.perturb,
        "flush_at": args.flush_at,
        "ate_cm": ate["rmse"] * 100.0,
        "lost": sum(1 for r in vo.records if r.state != "OK"),
        "keyframes": vo.n_kf,
        "map_points": vo.n_mp,
        "culled_keyframes": len(vo.culled_parent),
        "commit": commit,
        "platform": jax.devices()[0].platform,
        "seconds": time.time() - t0,
    }
    if looped:
        st = vo.loop_closer.stats
        out.update(loop_queries=st.n_queries, loops_closed=st.n_loops_closed,
                   verified=st.n_verified, gba_runs=counts.get("correct", 0),
                   relocalizations=counts.get("reloc_ok", 0), programs=counts,
                   loop_frames=loop_frames_at,
                   fork_frames=[f for f, t in events if t == "fork"],
                   merge_frames=[f for f, t in events if t == "merge"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
