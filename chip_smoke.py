"""GPU smoke test of the PyTorch port (`vi_slam_tpu_torch`) on one card.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and `nvidia-smi`; imports nothing of JAX or of
the JAX package. It runs four phases in order and prints one line per
phase with its seconds, flushed as the phase ends:

  device  the card's name and `nvidia-smi` name and power limit;
  build   `nvcc` of vi_slam_tpu_torch/csrc/*.cu into the ignored
          vi_slam_tpu_torch/_build/ (ctypes-loaded, no PyTorch headers);
  kernel fast_resp_pref
          the FAST-9 CUDA kernel (response, NMS, bonus and per-cell winner
          of every level of a pyramid in one launch) against its plain
          PyTorch version on the card, on the 8-level left and right
          pyramids of a rendered 1241x376 frame and on a random-texture
          image as a one-level pyramid: rtol 1e-5, atol 1e-3 on each map,
          equal cells (score, x, y), and equal keypoints, per level and from
          the extractor's selection of all levels at once; per pyramid the
          device time (calls queued back to back behind a busy device) and
          the time per call, both by CUDA events, the plain version's, and
          the bound with its bytes term and the operations term of what
          this image needs, beside the earlier per-level kernel's times
          and ptxas's registers and shared memory;
  slice   the tracking frame loop (`make_stereo_vo` ->
          `process_stereo`) over 100 rendered KITTI-00-sized frames on
          "cuda", after a 10-frame warm pass: steady frames/s, ATE, lost
          frames, keyframes, map points and the kernel's launch count,
          which must be 2 per frame processed (one per image pyramid).
          ATE must be within max(1 cm, 20 %) of the JAX reference's ATE
          on the same frames.

Any failure raises and the script exits non-zero with the traceback. On
success it prints the `nvidia-smi` line, a JSON line of per-kernel
measurements ("ms", "plain_ms" and "bound_ms" are device times for the
8-level left pyramid of frame 0), and last a JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

# The JAX reference's ATE on the slice world, on the host CPU with x64
# off: `python tools/slice_reference_ate.py` at commit 3ae1616 gave
# 3.004895313875399 cm with 0 lost frames. An accuracy figure, not a speed.
REF_ATE_CM = 3.004895313875399
REF_ATE_COMMIT = "3ae1616da44f970b81e3b9d63fc47b9c82ced020"

# KITTI-00 stereo geometry and the slice world (bench.py's).
W, H = 1241, 376
FX = FY = 718.856
CX, CY = 607.1928, 185.2157
BF = 386.1448
N_FRAMES = 100
N_WARM = 10
NEVER = 10 ** 9  # a keyframe cadence no run reaches

# H100 SXM peaks (NVIDIA data sheet) for the bound of a kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNEL_SOURCE = "vi_slam_tpu_torch/csrc/fast_resp_pref.cu"
KERNEL_REPLACES = "vi_slam_tpu/ops/fast_pallas.py:174"
# The same kernel phase at commit edc5e27, where the kernel ran one launch
# per level: device time and time per call for the left pyramid of frame 0.
EARLIER_COMMIT = "edc5e27caf275d9a132b48d3d792ab10803fd3a1"
EARLIER_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
EARLIER_PYRAMID_US = 107.0
EARLIER_PYRAMID_CALL_MS = 0.281


def log_phase(name: str, t0: float, detail: str = "") -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s {detail}".rstrip(), flush=True)


def slice_config():
    """bench.py's configuration with the keyframe-rate programs (mapping,
    local BA, maintenance) set beyond the run's length."""
    from vi_slam_tpu_torch.utils.config import (
        BAConfig, CameraConfig, ExtractorConfig, MapConfig, SystemConfig,
        TrackerConfig,
    )

    return SystemConfig(
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                            bf=BF, th_depth=35.0),
        extractor=ExtractorConfig(n_features=2000, use_pallas_fast=True),
        ba=BAConfig(max_local_kfs=6, max_local_points=2048,
                    local_ba_iters=2, mapping_fuse_window=1),
        map=MapConfig(max_keyframes=256, max_points=65536, max_obs_per_point=8),
        tracker=TrackerConfig(min_frames_between_kf=1, pipeline_depth=3,
                              maintenance_every=NEVER, local_ba_every=NEVER,
                              mapping_every=NEVER),
    )


def render_frames(world, n):
    from vi_slam_tpu_torch.io import synthetic

    frames = []
    for i in range(n):
        Twc = world.poses_wc[i]
        frames.append((
            synthetic.render_billboard_image(world, Twc, FX, FY, CX, CY, W, H, baseline=0.0),
            synthetic.render_billboard_image(world, Twc, FX, FY, CX, CY, W, H, baseline=BF / FX),
        ))
    return frames


def call_ms(fn, reps: int, warm: int = 3) -> float:
    """Median milliseconds from before one call to the end of its device
    work, by CUDA events, after warm-up: what a caller waits, dispatch
    included."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int) -> float:
    """Milliseconds of device work per call, by CUDA events around `reps`
    calls that run back to back: the device is first held busy for longer
    than the host takes to enqueue them, so no launch waits for the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 2_000_000)  # cycles, <= 2 GHz clock
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def fast_ops_count(img, th_lo: float, pref) -> int:
    """Float operations that the FAST-9 map `pref` of `img` and its cell
    winners need: per interior pixel 16 differences and 32 low-threshold
    compares; per pixel 9 NMS compares and 1 cell-max compare; per pixel
    with a low-threshold 9-arc one polarity's 16 excesses (a subtract and a
    clamp each; a pixel never has both); per valid arc start 8 adds and 1
    max; per kept pixel 32 high-threshold compares and the bonus add."""
    import torch
    from vi_slam_tpu_torch.ops import fast as fast_ops

    h, w = img.shape
    d = fast_ops._circle_diffs(img)
    runs = (fast_ops._arc_runs(d > th_lo) | fast_ops._arc_runs(d < -th_lo)) & 0xFFFF
    runs = torch.where(fast_ops._interior_mask(h, w, img.device), runs, torch.zeros_like(runs))
    arc_px = int(torch.count_nonzero(runs))
    starts = sum(int(torch.count_nonzero((runs >> j) & 1)) for j in range(16))
    kept = int(torch.count_nonzero(pref))
    interior = max(h - 2 * fast_ops.BORDER, 0) * max(w - 2 * fast_ops.BORDER, 0)
    return 48 * interior + 10 * h * w + 32 * arc_px + 9 * starts + 33 * kept


def ptxas_usage(log: str) -> str:
    """ptxas's registers, shared memory and spills per kernel entry, from
    nvcc's -Xptxas -v output."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            t = re.search(r"ILi(\d+)E", entry)
            entry = f"fast_pyramid_kernel<{t.group(1)}>" if t and "fast_pyramid" in entry else entry
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            out.append(f"{entry}: spill stores {m.group(1)} B, loads {m.group(2)} B")
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry:
            out.append(f"{entry}: {m.group(1)} registers, {m.group(2)} B shared memory")
    return "; ".join(out) if out else "not rebuilt in this run"


def phase_kernel(extractor_cfg, world):
    """The grouped FAST-9 kernel vs its plain version on the card: the left
    and right pyramids of frame 0, and a random-texture image as a
    one-level pyramid."""
    import torch
    from vi_slam_tpu_torch.features.extractor import level_budgets
    from vi_slam_tpu_torch.ops import fast as fast_ops
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.ops import pyramid as pyr_ops

    dev = torch.device("cuda")
    th, th_lo = extractor_cfg.fast_threshold, extractor_cfg.fast_min_threshold
    cell = extractor_cfg.cell_size
    budgets = level_budgets(extractor_cfg.n_features, extractor_cfg.n_levels,
                            extractor_cfg.scale_factor)
    weights = pyr_ops.pyramid_weights(H, W, extractor_cfg.n_levels,
                                      extractor_cfg.scale_factor, dev)

    def pyramid(u8):
        img = torch.from_numpy(u8.astype(np.uint8)).to(dev).to(torch.float32)
        return pyr_ops.build_pyramid(img, extractor_cfg.n_levels,
                                     extractor_cfg.scale_factor, weights)

    left, right = render_frames(world, 1)[0]
    rng = np.random.default_rng(5)
    noise = torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dev)
    cases = [("left", pyramid(left)), ("right", pyramid(right)), ("random", [noise])]

    rows = []
    for name, levels in cases:
        got = fast_kernel.pyramid_resp_cells_cuda(levels, th, th_lo, cell)
        want = fast_kernel.pyramid_resp_cells_plain(levels, th, th_lo, cell)
        torch.cuda.synchronize()
        want_maps = want.level_maps()
        err, n_kp, want_kp = 0.0, 0, []
        for l, (m, c, wm, wc) in enumerate(zip(got.level_maps(), got.level_cells(),
                                                want_maps, want.level_cells())):
            diff = torch.abs(m - wm)
            lerr = float(torch.max(diff))
            close = bool(torch.all(diff <= 1e-3 + 1e-5 * torch.abs(wm)))
            same_cells = all(bool(torch.equal(a, b)) for a, b in zip(c, wc))
            kg = fast_ops.select_from_cells(*c, budgets[l])
            kw = fast_ops.select_keypoints(wm, cell, budgets[l])
            same_kp = all(bool(torch.equal(a, b)) for a, b in zip(kg, kw))
            if not (close and same_cells and same_kp):
                raise AssertionError(
                    f"fast_pyramid {name} level {l} {tuple(m.shape)}: max_abs_err {lerr},"
                    f" allclose {close}, equal cells {same_cells}, equal keypoints {same_kp}"
                )
            err = max(err, lerr)
            n_kp += int(kg[2].sum())
            want_kp.append(kw)
        # The extractor's selection of all levels at once, from the flat cells.
        counts = got.tiles.count
        ks = [min(b, n) for b, n in zip(budgets, counts)]
        all_kp = fast_ops.select_from_level_cells(
            got.score, got.xy[0], got.xy[1], *fast_ops.level_picks(counts, ks, dev))
        if not all(bool(torch.equal(a, torch.cat(b))) for a, b in zip(all_kp, zip(*want_kp))):
            raise AssertionError(f"fast_pyramid {name}: select_from_level_cells differs"
                                 " from select_keypoints per level")

        def kernel():
            return fast_kernel.pyramid_resp_cells_cuda(levels, th, th_lo, cell)

        def plain():
            return fast_kernel.pyramid_resp_cells_plain(levels, th, th_lo, cell)

        ms, plain_ms = device_ms(kernel, 100), device_ms(plain, 5)
        ms_call, plain_call = call_ms(kernel, 100), call_ms(plain, 5)
        n_px = sum(img.numel() for img in levels)
        n_cells = got.tiles.total
        bytes_ms = (8 * n_px + 12 * n_cells) / HBM_BYTES_PER_S * 1e3
        n_ops = sum(fast_ops_count(img, th_lo, m) for img, m in zip(levels, want_maps))
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        row = dict(name=name, levels=len(levels), px=n_px, cells=n_cells, err=err, ms=ms,
                   plain_ms=plain_ms, ms_call=ms_call, plain_call=plain_call,
                   bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        rows.append(row)
        print(f"  fast_pyramid {name}: {len(levels)} levels, {n_px} px, {n_cells} cells:"
              f" max_abs_err {err:.3g}, cells and {n_kp} keypoints equal | device: kernel"
              f" {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.1f} us | per call: kernel"
              f" {ms_call * 1e3:.3f} us, plain {plain_call * 1e3:.1f} us | bound"
              f" {row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} (bytes"
              f" {bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us)", flush=True)
    torch.cuda.synchronize()
    return rows


def phase_slice(world):
    """The tracking loop on the card over the slice world."""
    import torch
    from vi_slam_tpu_torch.io import evaluation
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo

    cfg = slice_config()
    t_render = time.perf_counter()
    frames = render_frames(world, N_FRAMES)
    render_s = time.perf_counter() - t_render

    fast_kernel.reset_launches()
    vo_w = make_stereo_vo(cfg)
    for i in range(N_WARM):
        vo_w.process_stereo(*frames[i], i * 0.1)
    vo_w.flush()
    vo = make_stereo_vo(cfg)
    t_all = time.perf_counter()
    t_steady = None
    for i, (imgL, imgR) in enumerate(frames):
        if i == N_WARM:
            vo.flush()
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        vo.process_stereo(imgL, imgR, i * 0.1)
    vo.flush()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fast_kernel.launches

    frames_done = N_WARM + N_FRAMES
    if launches <= 0 or launches != 2 * frames_done:
        raise AssertionError(
            f"fast_resp_pref launched {launches} times for {frames_done} frames,"
            f" expected {2 * frames_done} (one per image pyramid)"
        )
    est = vo.trajectory_wc()
    ate_cm = evaluation.ate_rmse(est[:, :3, 3], world.poses_wc[:, :3, 3])["rmse"] * 100.0
    lost = sum(1 for r in vo.records if r.state != "OK")
    if not np.all(np.isfinite(est)) or est.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"trajectory not finite or of shape {est.shape}")
    if lost != 0:
        raise AssertionError(f"{lost} frames not tracked")
    tol_cm = max(1.0, 0.2 * REF_ATE_CM)
    if abs(ate_cm - REF_ATE_CM) > tol_cm:
        raise AssertionError(
            f"ATE {ate_cm:.4f} cm vs reference {REF_ATE_CM:.4f} cm (tolerance {tol_cm:.4f} cm)"
        )
    return {
        "render_s": render_s,
        "steady_fps": (N_FRAMES - N_WARM) / (t_end - t_steady),
        "all_fps": N_FRAMES / (t_end - t_all),
        "ate_cm": ate_cm,
        "lost": lost,
        "keyframes": vo.n_kf,
        "map_points": vo.n_mp,
        "launches": launches,
        "frames": frames_done,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    from vi_slam_tpu_torch.io import synthetic
    from vi_slam_tpu_torch.kernels import build as kbuild
    from vi_slam_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log_phase("device", t0, f"| {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
              f" cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = kbuild.build()
    kbuild.load_library()
    ptxas = ptxas_usage(built.log)
    log_phase("build", t0, f"| nvcc {built.seconds:.2f} s -> {built.path.name} | {ptxas}")

    world = synthetic.make_billboard_world(n_frames=N_FRAMES, n_boards=4000, seed=11, speed=1.0)
    cfg = slice_config()

    t0 = time.perf_counter()
    rows = phase_kernel(cfg.extractor, world)
    kern = rows[0]  # the left pyramid of frame 0
    log_phase("kernel fast_resp_pref", t0,
              f"| 8-level pyramid of one image, one launch: device {kern['ms'] * 1e3:.3f} us,"
              f" per call {kern['ms_call'] * 1e3:.3f} us, plain {kern['plain_ms']:.3f} ms;"
              f" bound {kern['bound_ms'] * 1e3:.3f} us by {kern['bound_by']} (bytes"
              f" {kern['bytes_ms'] * 1e3:.3f} us, operations {kern['ops_ms'] * 1e3:.3f} us)"
              f" | earlier, one launch per level ({EARLIER_COMMIT[:7]}, {EARLIER_CARD}):"
              f" device {EARLIER_PYRAMID_US} us, per call {EARLIER_PYRAMID_CALL_MS} ms"
              f" | {ptxas}")

    t0 = time.perf_counter()
    sl = phase_slice(world)
    log_phase("slice", t0,
              f"| render {sl['render_s']:.1f} s | steady {sl['steady_fps']:.3f} frames/s"
              f" (all {sl['all_fps']:.3f}) | ATE {sl['ate_cm']:.4f} cm"
              f" (reference {REF_ATE_CM:.4f} cm at {REF_ATE_COMMIT[:7]}) | lost {sl['lost']}"
              f" | keyframes {sl['keyframes']} | map points {sl['map_points']}"
              f" | fast_resp_pref launches {sl['launches']} for {sl['frames']} frames")
    print(f"total: {time.perf_counter() - t_start:.2f} s", flush=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fast_resp_pref",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sl["launches"],
        "max_abs_err": max(r["err"] for r in rows),
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
