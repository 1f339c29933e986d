"""Reference accuracy of the PyTorch port's first slice, on the host CPU.

Runs the JAX package's `StereoVO.process_stereo` (x64 off, CPU) over the
world that `chip_smoke.py` drives: 100 frames of
`make_billboard_world(n_frames=100, n_boards=4000, seed=11, speed=1.0)`
rendered at 1241x376, with bench.py's configuration and the mapping,
local-BA and maintenance cadences set beyond the run's length (the slice
runs none of them). Prints the ATE RMSE in cm, the lost-frame count, the
keyframe and map-point counts, and the commit, as one JSON line.

    JAX_PLATFORMS=cpu python tools/slice_reference_ate.py [--frames 100]

This is an accuracy figure, not a speed: `chip_smoke.py` holds the port's
ATE on the GPU to it.
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


def slice_config() -> SystemConfig:
    """bench.py's configuration with the keyframe-rate programs off."""
    return SystemConfig(
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                            bf=BF, th_depth=35.0),
        extractor=ExtractorConfig(n_features=2000, use_pallas_fast=True),
        ba=BAConfig(max_local_kfs=6, max_local_points=2048,
                    local_ba_iters=2, mapping_fuse_window=1),
        map=MapConfig(max_keyframes=256, max_points=65536,
                      max_obs_per_point=8),
        tracker=TrackerConfig(min_frames_between_kf=1, pipeline_depth=3,
                              maintenance_every=NEVER, local_ba_every=NEVER,
                              mapping_every=NEVER),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args()
    t0 = time.time()
    world = synthetic.make_billboard_world(
        n_frames=args.frames, n_boards=4000, seed=11, speed=1.0
    )
    vo = make_stereo_vo(slice_config())
    for i in range(args.frames):
        Twc = world.poses_wc[i]
        imgL = synthetic.render_billboard_image(
            world, Twc, FX, FY, CX, CY, W, H, baseline=0.0)
        imgR = synthetic.render_billboard_image(
            world, Twc, FX, FY, CX, CY, W, H, baseline=BF / FX)
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
        "ate_cm": ate["rmse"] * 100.0,
        "lost": sum(1 for r in vo.records if r.state != "OK"),
        "keyframes": vo.n_kf,
        "map_points": vo.n_mp,
        "commit": commit,
        "platform": jax.devices()[0].platform,
        "seconds": time.time() - t0,
    }))


if __name__ == "__main__":
    main()
