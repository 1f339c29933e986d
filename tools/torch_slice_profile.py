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
from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo  # noqa: E402

STAGES = ("_extract_pair", "_track", "_create_kf_body", "_mapping_pass", "_local_ba_program",
          "_maintenance_program")


def instrument(vo):
    """Wrap each stage method of one StereoVO in a profiler range."""
    for name in STAGES:
        fn = getattr(vo, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with record_function(f"stage{_name}"):
                return _fn(*a, **kw)

        setattr(vo, name, wrapped)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--bench-cadences", action="store_true",
                    help="mapping, local BA and maintenance at bench.py's cadences (2/3/8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_slice_profile: needs a CUDA device")
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
    for i in range(args.warm):
        vo.process_stereo(*frames[i], i * 0.1)
    vo.flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.warm, n):
            vo.process_stereo(*frames[i], i * 0.1)
        vo.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA" and not e.key.startswith("stage")]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per = args.frames
    print(f"device: {torch.cuda.get_device_name(0)}")
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


if __name__ == "__main__":
    main()
