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

    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py [--frames 100]
    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py --bench-cadences --frames 200 --flush-at 10

This is an accuracy figure, not a speed: `chip_smoke.py` holds the port's
ATE on the GPU to it.

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
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402

from vi_slam_tpu.io import evaluation, synthetic  # noqa: E402
from vi_slam_tpu.pipeline.klt_vo import make_stereo_vo  # noqa: E402
from vi_slam_tpu.utils.config import (  # noqa: E402
    BAConfig, CameraConfig, ExtractorConfig, MapConfig, SystemConfig,
    TrackerConfig,
)

W, H = 1241, 376
FX = FY = 718.856
CX, CY = 607.1928, 185.2157
BF = 386.1448
NEVER = 10 ** 9  # a keyframe cadence no run reaches


def slice_config(bench_cadences: bool = False) -> SystemConfig:
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
                              **every),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--bench-cadences", action="store_true",
                    help="bench.py's mapping/local-BA/maintenance cadences (2/3/8)")
    ap.add_argument("--flush-at", type=int, metavar="N",
                    help="drain the pipeline before frame N (bench.py and the smoke: 10)")
    ap.add_argument("--perturb", type=int, metavar="SEED",
                    help="move 20 random pixels of each left image by one grey level")
    args = ap.parse_args()
    rng = np.random.default_rng(args.perturb) if args.perturb is not None else None
    t0 = time.time()
    world = synthetic.make_billboard_world(
        n_frames=args.frames, n_boards=4000, seed=11, speed=1.0
    )
    vo = make_stereo_vo(slice_config(args.bench_cadences))
    for i in range(args.frames):
        if i == args.flush_at:
            vo.flush()
        Twc = world.poses_wc[i]
        imgL = synthetic.render_billboard_image(
            world, Twc, FX, FY, CX, CY, W, H, baseline=0.0)
        imgR = synthetic.render_billboard_image(
            world, Twc, FX, FY, CX, CY, W, H, baseline=BF / FX)
        if rng is not None:
            imgL = np.array(imgL, np.float32)
            idx = rng.integers(0, imgL.size, 20)
            imgL.flat[idx] = np.clip(imgL.flat[idx] + rng.choice([-1.0, 1.0], 20), 0, 255)
        vo.process_stereo(imgL, imgR, i * 0.1)
        print(f"frame {i} {time.time() - t0:.1f}s", file=sys.stderr,
              flush=True)
    est = vo.trajectory_wc()
    ate = evaluation.ate_rmse(est[:, :3, 3], world.poses_wc[:, :3, 3])
    commit = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    ).stdout.strip()
    print(json.dumps({
        "frames": args.frames,
        "cadences": "bench" if args.bench_cadences else "never",
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
    }))


if __name__ == "__main__":
    main()
