"""Where the time of the PyTorch port's main path goes, on a GPU.

Runs `chip_smoke.py`'s slice (bench.py's configuration, KITTI-00-sized
rendered frames; the keyframe-rate programs off, or with `--bench-cadences`
on at bench.py's cadences, as the smoke's full phase runs them) on "cuda":
a warm pass, then `--frames` frames under `torch.profiler`, with one range
per stage of the frame (extract pair, track, keyframe creation) and per
keyframe-rate program (mapping pass, local BA, maintenance). Prints:

  * wall ms per frame and the device's busy and idle share (sum of kernel
    times over the wall time of the profiled window);
  * host and device ms per frame of each stage range;
  * the top operations by device time.

    python3 tools/torch_slice_profile.py [--frames 20] [--warm 10] [--bench-cadences]
    python3 tools/torch_slice_profile.py --reloc [--frames 200]
    python3 tools/torch_slice_profile.py --vio [--warm 30] [--frames 30]
    python3 tools/torch_slice_profile.py --klt [--warm 10] [--frames 20]

With `--vio` it runs `chip_smoke.py`'s vio phase instead
(tools/bench_vio.py's stereo-inertial configuration and world, 200 Hz
IMU): the first `--warm` frames unprofiled (the IMU initializes in them,
and the pipeline fills), then `--frames` frames under the profiler with one
range per stage of an inertial frame: extraction, IMU integration, the
inertial track, keyframe creation and the segment's close, and at keyframe
rate the mapping pass, maintenance, the inertial initialization and the
visual-inertial BA (local and full). The output is as above.

With `--klt` it runs `chip_smoke.py`'s klt phase instead (bench.py
--frontend klt over bench.py's world): `--warm` frames unprofiled, then
`--frames` frames under the profiler with one range per stage of a KLT
frame: the pyramids, the LK passes (`_lk`, three a tracked frame), the two
pose passes (`pose_optimize`), the ORB rescue's extraction and tracking,
the keyframe branch's extraction, association and keyframe creation, and
at keyframe rate the mapping pass, local BA and maintenance. The output
is as above: host and device ms a frame per stage, kernels a frame and
the idle share.

With `--reloc` it runs `chip_smoke.py`'s loop phase instead (bench.py
--loop's world and vocabulary, atlas off; the tracking fails on many of
its frames, and each lost frame attempts a relocalization), without the
profiler, and splits the relocalization attempts into their steps: the
frame's BoW vector, the database query, and per candidate the matching,
the PnP RANSAC and the pose Gauss-Newton (the runs of the last two count
the candidates solved). Each step prints its host ms (the time to
dispatch it, on the host's clock) and its device span (CUDA events around
it), summed and per attempt; "rest" is the attempt's host time outside
the steps: its waits for each candidate's counts, and glue.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import chip_smoke  # noqa: E402
from vi_slam_tpu_torch.io import synthetic  # noqa: E402
from vi_slam_tpu_torch.pipeline import relocalization  # noqa: E402
from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo  # noqa: E402
from vi_slam_tpu_torch.retrieval import vocabulary  # noqa: E402
from vi_slam_tpu_torch.utils.timing import ProgramTimer  # noqa: E402

STAGES = ("_extract_pair", "_track", "_create_kf_body", "_mapping_pass", "_local_ba_program",
          "_maintenance_program")
KLT_STAGES = ("_pyramid", "_lk", "_optimize", "_extract_pair", "_track", "_associate",
              "_create_kf_body", "_mapping_pass", "_local_ba_program", "_maintenance_program")
VIO_STAGES = ("_extract_pair", "_integrate_and_accum", "_track_vio", "_create_kf_body",
              "_close_segment", "_mapping_pass", "_maintenance_program", "_maybe_init_imu",
              "_vi_local_ba")


def instrument(vo, stages=STAGES):
    """Wrap each stage method of one StereoVO in a profiler range."""
    for name in stages:
        fn = getattr(vo, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with record_function(f"stage{_name}"):
                return _fn(*a, **kw)

        setattr(vo, name, wrapped)


def timed(obj, name, timer, step, inside):
    """Wrap obj.name in a span of `timer` named `step`, taken only while
    inside[0] is set (inside a relocalization attempt); the step "attempt"
    sets it."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        if step != "attempt" and not inside[0]:
            return fn(*a, **kw)
        inside[0] = True
        try:
            with timer.span(step):
                return fn(*a, **kw)
        finally:
            inside[0] = step != "attempt"

    setattr(obj, name, wrapped)


RELOC_STEPS = ("bow_transform", "bow_vectors", "db_query", "match", "pnp_ransac", "pose_gn")


def reloc_profile(n_frames: int) -> None:
    """The loop phase's run with each relocalization step timed."""
    import dataclasses

    _, frames = chip_smoke.loop_world_frames()
    frames = frames[:n_frames]
    cfg = chip_smoke.slice_config(bench_cadences=True)
    cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, atlas_enabled=False))
    vocab = chip_smoke.train_loop_vocabulary(cfg, frames)
    vo = make_stereo_vo(cfg, vocab=vocab)
    steps, inside = ProgramTimer("cuda"), [False]
    timed(vocabulary, "transform", steps, "bow_transform", inside)
    timed(vocabulary, "bow_vectors", steps, "bow_vectors", inside)
    timed(vo.loop_closer.db, "detect_reloc_candidates", steps, "db_query", inside)
    timed(relocalization, "_match_frame_to_kf", steps, "match", inside)
    timed(relocalization, "pnp_ransac_core", steps, "pnp_ransac", inside)
    timed(relocalization.pose_opt, "pose_optimize", steps, "pose_gn", inside)
    timed(vo, "_try_relocalize", steps, "attempt", inside)
    t0 = time.perf_counter()
    for i, (imgL, imgR) in enumerate(frames):
        vo.process_stereo(imgL, imgR, i * 0.1)
    vo.flush()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    dev = steps.device_ms()
    n = max(steps.runs.get("attempt", 0), 1)
    host = {k: v * 1e3 for k, v in steps.host_s.items()}
    host["rest"] = host.get("attempt", 0.0) - sum(host.get(k, 0.0) for k in RELOC_STEPS)
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"frames {len(frames)}: wall {wall_s:.3f} s, lost"
          f" {sum(1 for r in vo.records if r.state != 'OK')}, relocalization attempts"
          f" {steps.runs.get('attempt', 0)}, relocalized {vo.n_relocalized}")
    out = {}
    for name in ("attempt",) + RELOC_STEPS + ("rest",):
        runs = steps.runs.get(name, 0)
        out[name] = dict(runs=runs, host_ms=host.get(name, 0.0), device_ms=dev.get(name))
        span = "" if name == "rest" else (
            f", device span {dev.get(name, 0.0):.2f} ms ({dev.get(name, 0.0) / n:.3f} ms an"
            " attempt)")
        print(f"{name}: runs {runs}, host {host.get(name, 0.0):.2f} ms"
              f" ({host.get(name, 0.0) / n:.3f} ms an attempt){span}")
    print("rest: the attempt's host time outside the steps (the host's wait for each"
          " candidate's counts, and the glue)")
    print(json.dumps({"wall_s": wall_s, "attempts": steps.runs.get("attempt", 0), "steps": out}))


def profiled(step, n_warm: int, n: int, label: str) -> None:
    """Run step(i) for frames [0, n_warm) unprofiled and [n_warm, n) under
    the profiler; print the per-frame split."""
    for i in range(n_warm):
        step(i)
    step(None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, n):
            step(i)
        step(None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA" and not e.key.startswith("stage")]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per = n - n_warm
    print(f"device: {torch.cuda.get_device_name(0)} | {label}")
    print(f"frames {per}: wall {wall_ms / per:.3f} ms/frame, device busy"
          f" {kernel_ms / per:.3f} ms/frame, busy share {kernel_ms / wall_ms:.4f},"
          f" idle share {1 - kernel_ms / wall_ms:.4f}")
    for e in events:
        if e.key.startswith("stage") and e.device_type.name == "CPU":
            print(f"{e.key}: calls {e.count}, host {e.cpu_time_total / 1e3 / per:.3f} ms/frame,"
                  f" device kernels {e.device_time_total / 1e3 / per:.3f} ms/frame")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    n_launch = sum(e.count for e in kernels)
    print(json.dumps({"wall_ms_per_frame": wall_ms / per, "device_ms_per_frame": kernel_ms / per,
                      "idle_share": 1 - kernel_ms / wall_ms, "kernels_per_frame": n_launch / per}))


def vio_profile(n_warm: int, n_frames: int) -> None:
    """The vio phase's world and configuration, split by stage."""
    from vi_slam_tpu_torch.pipeline.vio import make_stereo_inertial_vo

    n = n_warm + n_frames
    iw, _, frames = synthetic.make_billboard_inertial_sequence(
        n, chip_smoke.FX, chip_smoke.FY, chip_smoke.CX, chip_smoke.CY, chip_smoke.W,
        chip_smoke.H, chip_smoke.BF, n_landmarks=2000, seed=5)
    cfg = chip_smoke.vio_config()
    warm = make_stereo_inertial_vo(cfg)
    for i in range(chip_smoke.VIO_WARM):
        warm.process_stereo_inertial(*frames[i], iw.imu_per_frame[i], iw.timestamps[i])
    warm.flush()
    vo = make_stereo_inertial_vo(cfg)
    instrument(vo, VIO_STAGES)

    def step(i):
        if i is None:
            vo.flush()
        else:
            vo.process_stereo_inertial(*frames[i], iw.imu_per_frame[i], iw.timestamps[i])

    profiled(step, n_warm, n, "vio")
    print(f"after the run: imu_ready {vo.imu_ready}, init stage {vo._init_stage} at frames"
          f" {vo.init_stage_frames}, lost {sum(1 for r in vo.records if r.state != 'OK')}")


def klt_profile(n_warm: int, n_frames: int) -> None:
    """The klt phase's world and configuration, split by stage."""
    from vi_slam_tpu_torch.optim import pose_opt

    n = n_warm + n_frames
    world = chip_smoke.full_world()
    frames = chip_smoke.render_frames(world, n)
    cfg = chip_smoke.klt_config()
    warm = make_stereo_vo(cfg)
    for i in range(n_warm):
        warm.process_stereo(*frames[i], i * 0.1)
    warm.flush()
    vo = make_stereo_vo(cfg)
    stages = tuple(s for s in KLT_STAGES if s != "_optimize")
    instrument(vo, stages)
    solve = pose_opt.pose_optimize

    def optimize(*a, **kw):
        with record_function("stage_optimize"):
            return solve(*a, **kw)

    pose_opt.pose_optimize = optimize

    def step(i):
        if i is None:
            vo.flush()
        else:
            vo.process_stereo(*frames[i], i * 0.1)

    try:
        profiled(step, n_warm, n, "klt, bench cadences")
    finally:
        pose_opt.pose_optimize = solve
    print(f"after the run: keyframes {vo.n_kf}, from the KLT keyframe branch at frames"
          f" {vo.klt_kf_frames}, rescues at frames {vo.rescue_frames}, lost"
          f" {sum(1 for r in vo.records if r.state != 'OK')}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--bench-cadences", action="store_true",
                    help="mapping, local BA and maintenance at bench.py's cadences (2/3/8)")
    ap.add_argument("--reloc", action="store_true",
                    help="the loop phase's run, relocalization attempts split by step")
    ap.add_argument("--vio", action="store_true",
                    help="the vio phase's stereo-inertial run, split by stage")
    ap.add_argument("--klt", action="store_true",
                    help="the klt phase's run (bench.py --frontend klt), split by stage")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_slice_profile: needs a CUDA device")
    if args.vio:
        vio_profile(args.warm if args.warm != 10 else 30, args.frames if args.frames != 20 else 30)
        return
    if args.klt:
        klt_profile(args.warm, args.frames)
        return
    if args.reloc:
        reloc_profile(args.frames if args.frames != 20 else chip_smoke.N_FULL_FRAMES)
        return
    n = args.warm + args.frames
    world = synthetic.make_billboard_world(n_frames=n, n_boards=4000, seed=11, speed=1.0)
    frames = chip_smoke.render_frames(world, n)
    cfg = chip_smoke.slice_config(bench_cadences=args.bench_cadences)

    warm = make_stereo_vo(cfg)
    for i in range(args.warm):
        warm.process_stereo(*frames[i], i * 0.1)
    warm.flush()

    vo = make_stereo_vo(cfg)
    instrument(vo)

    def step(i):
        if i is None:
            vo.flush()
        else:
            vo.process_stereo(*frames[i], i * 0.1)

    profiled(step, args.warm, n, "slice" + (", bench cadences" if args.bench_cadences else ""))


if __name__ == "__main__":
    main()
