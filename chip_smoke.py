"""GPU smoke test of the PyTorch port (`vi_slam_tpu_torch`) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ate [--klt] [--perturb SEED ...] [--flush-at N]
    python3 chip_smoke.py --mono [--repeat N] [--perturb SEED ...]
    python3 chip_smoke.py --mono-inertial [--seeds SEED ...]

The second form is not the check: it runs the full phase's loop (with
`--klt`, the klt phase's) alone, unperturbed and once per seed with 20
pixels of each left image moved by one grey level, and prints one JSON
line a run (the port's ATE spread). The third runs the mono phase's run
alone after its worker's warm-up: on the unperturbed left images N times
(`--repeat`) and once per `--perturb` seed, one JSON line a run with its
numbers and the per-run gates' verdict; it is not the check either. The
fourth runs the mono-inertial phase's oracle run (the reference's
two-view key 3, and once per `--seeds` key) and image run alone, one JSON
line a run with its gates' verdict; not the check either.

Needs one CUDA card, `nvcc` and `nvidia-smi`; imports nothing of JAX or of
the JAX package. The frames are rendered in a pool of worker processes
(`multiprocessing`, spawned, stopped on the way out). It runs fourteen
phases in order and prints one line per phase with its seconds, flushed
as the phase ends (and a `render` line for the first 120 frames of
bench.py's 200-frame world, which the full, klt and rgbd phases share).
The vio-smoother and mono phases run each in a worker process of its
own, which warms up its first solves on the card while the first phases
run (the smoother's: an inertial initialization and a smoother step; the
mono phase's: a two-view solve and a whole-map BA), the mono-inertial
phase's runs after the mono phase in both workers, and a second `render`
line reports the vio phase's world, rendered after the build phase:

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
          `process_stereo`) over the first 30 frames of a rendered
          50-frame KITTI-00-sized world on
          "cuda", with the keyframe-rate programs off, after a 10-frame
          warm pass: steady frames/s, ATE, lost frames, keyframes, map
          points and the kernel's launch count, which must be 2 per frame
          processed (one per image pyramid). ATE must be within max(1 cm,
          20 %) of the JAX reference's ATE on the same frames;
  full    bench.py's configuration end to end: the same loop with the
          mapping pass every 2nd keyframe, local BA every 3rd and
          maintenance every 8th, over the first 120 frames of bench.py's
          200-frame world,
          after the same warm pass. It fails on a lost frame, a trajectory
          that is not finite, an ATE further than max(1 cm, 20 %) from the
          JAX reference's ATE on the same frames with the same drain
          before frame 10, a launch count other than 2 per frame, or a
          program (mapping, local BA, maintenance) that ran no time. (No
          keyframe of this world is redundant enough to be culled, in the
          reference or the port; a real cull runs in the CPU tests.) It
          prints ATE, lost
          frames, keyframes, map points, culled keyframes beside the
          reference's, the runs of each program, steady frames/s and the
          host ms of each program.
  loop-parts
          loop closing on "cuda" on the JAX package's drifted-ring test map
          (12 keyframes, `make_drifted_ring`): the `LoopCloser` closes the
          loop of the last keyframe, first with the essential graph alone,
          then with global BA after it (stereo measurements). It fails
          unless the reference test's limits hold: the seam closed to
          < 0.05 m, every keyframe centre < 0.25 m and < 0.35 x the drift
          from the truth; with global BA the worst centre closer than the
          graph alone and the map's reprojection error halved. It prints
          the device span and host ms of the correction and of global BA.
  loop    bench.py --loop's configuration: the closed-loop world (200
          frames, the tail re-traversing the start), bench.py's cadences,
          a vocabulary trained on the card from the port's own ORB
          descriptors of every 20th left image, as bench.py trains it, and
          the atlas on, as bench.py runs it. It fails on a trajectory that
          is not finite, a launch count other than 2 per frame, no loop
          query, no map fork or no merge where the reference forks and
          merges, or a loop or atlas program (BoW add, loop detection,
          Sim3 verification, relocalization attempt, map fork, merge
          detection, merge) that ran no time where the reference's run ran
          it. (The reference's one loop correction on this world comes and
          goes under one grey level; the correction and global BA are
          gated in the loop-parts and ring phases.) It prints the forks and merges with the
          frame of each beside the reference's, the host ms of a merge,
          ATE, lost frames, relocalizations, loop queries and loops closed
          beside the reference's, steady frames/s and the host ms of each
          loop program.
  ring    the board ring (`make_board_ring_loop`: a 3 m circle driven once
          every 100 frames inside a ring of 1,500 boards all round it) at
          full width, 120 frames, bench.py's configuration and map capacity
          with a vocabulary trained as in `loop`, atlas off. Tracking holds
          all round, and the reference closes one loop on it and runs global
          BA after the correction. It fails unless the port closes a loop
          through `make_stereo_vo` and runs the correction and global BA, on
          a trajectory that is not finite, on a launch count other than 2 per
          frame, or on a loop program that ran no time where the
          reference's run ran it. It prints the frame on which each
          correction ended beside the reference's, the device span and host
          ms of the correction and of global BA, and ATE, lost frames, loop
          queries and keyframes beside the reference's.
  vio     tools/bench_vio.py's configuration unreduced: the stereo-inertial
          pipeline (`make_stereo_inertial_vo` -> `process_stereo_inertial`)
          over its 60-frame world (`make_billboard_inertial_sequence`, seed
          5) with the 200 Hz IMU stream, 2000 ORB features, the inertial
          window of 8, the smoother off, after an 8-frame warm pass and with
          the pipeline drained before frame 8. It fails on a lost frame
          where the reference lost none, `imu_ready` or the final
          initialization stage other than the reference's, an ATE further
          than max(1 cm, 20 %) from the reference's, a trajectory that is
          not finite, a launch count other than 2 per frame, or a program
          (integration, inertial track, inertial init, VI local BA, full
          inertial BA, mapping pass, maintenance) that ran no time where the
          reference's ran it. It prints steady frames/s, the frame of each
          initialization stage, the gravity's angle to the truth and the
          biases, keyframes, and the host ms of each program, beside the
          reference's.
  vio-smoother
          tools/bench_vio.py --smoother: the vio phase's configuration with
          the fixed-lag smoother on (`use_smoother=True`, a 6-slot window,
          96 anchors a slot, 2 iterations a frame) over the vio phase's
          world and frames (rendered once for both), run in a worker
          process on the card while the vio phase runs. It fails on the vio
          phase's gates against the reference's figures with the smoother
          on, on smoother steps other than one per inertial track or none,
          and on a window that never slid. It prints the vio phase's
          figures, the smoother's steps and host ms a step, and its slides
          (each one `eigh`, a wait for the host on the card) with their
          host ms.
  mono    `MonoVO.process_mono` over the left images of the vio phase's world
          (rendered after the build phase, once for the vio, vio-smoother
          and mono phases) at tools/bench_vio.py's camera, extractor, BA and
          tracker settings with sensor=MONOCULAR, bf 0 and the smoother
          off, run in a worker process on the card beside the slice and
          later phases: the unperturbed run and four one-grey-level
          perturbations. It fails unless each of the five initializes
          (two-view reconstruction and whole-map BA) within 2 frames of the
          reference's first OK frame, and on a frame lost after that in any
          of them (the reference loses none in each), on K1 launches other
          than 1 a frame, and, in the unperturbed run, on no keyframe from
          `_create_keyframe` with a new triangulated point or a mapping
          pass or local BA that ran no time where the reference ran it.
          Its scale-aligned ATE (Horn with scale, over the OK frames) is a
          draw on this world, in the reference (2.65-7.12 cm under one grey
          level) and between runs of one code on the card (ROADMAP F14):
          the phase fails if the mean of the five exceeds the reference's
          mean over the same five by more than max(1 cm, 20 %), or lies
          under MONO_ATE_FLOOR_CM. It prints the init frame,
          the two-view model and good count, the initialization's host ms
          (two-view, and the map with its BA), the calls of torch.linalg.svd
          and the host ms inside them (each a wait for the card), the Horn
          scale, steady frames/s and the host ms of a keyframe's
          triangulation.
  mono-inertial
          `MonoInertialVO`: an oracle run, `process_oracle_mono_inertial` over
          tests/test_mono_inertial.py's world (oracle features with 0.3 px
          noise at 640x480, `make_inertial_world(60, 10 fps, 8000
          landmarks, seed 3, excitation 4.0)`, 200 Hz IMU) at that test's
          configuration, and an image run, `process_mono_inertial` over the
          left images and IMU stream of the vio phase's world at
          tools/bench_vio.py's configuration with sensor=IMU_MONOCULAR and
          bf 0. Both draw the two-view samples from the reference's own
          stream (`KeySampler(3)`, its PRNGKey(3)). The oracle run goes
          five times (three in the vio-smoother phase's worker before
          that phase, queued when the mono phase ends; two in the mono
          worker after its five mono runs): where it ends is a draw of the
          card's float32 sums, which atomics make differ from run to run
          (ROADMAP F15). The mono worker's first run goes under
          torch.use_deterministic_algorithms, and so is the same run on
          every call; the phase fails unless it follows the reference
          run's course: the initialization within 2 frames of the
          reference's (1), a finite trajectory with one pose a frame,
          imu_ready and the reference's last stage (2), each stage within
          3 frames of the reference's (20, 53), both counted from the
          initialization (a stage runs on the first keyframe once the
          chain spans its seconds, and a keyframe comes at least every 4
          frames), every frame tracked after the initialization, the
          inertial initialization, whole-chain and window VI BAs, mapping
          and local BA run; and unless it meets tests/test_mono_inertial.py's
          limits, as the reference's run does: Horn scale within 2 % of 1,
          unscaled ATE under 25 cm, gravity within 2 deg. Every oracle run
          fails the phase on a pose that is not finite; the other four
          runs' course and limits are printed. The image
          run fails unless K1 launches once a frame, it initializes within
          2 frames of the reference's (1), reaches imu_ready with its first
          stage within 3 frames of the reference's (21), counted as above,
          and keeps a finite trajectory (it runs in the mono worker after
          the oracle runs); its lost frames, scale, ATE and gravity are printed
          beside the reference's, which loses track at that stage. It
          prints the applied scale of each stage, the host ms of the
          inertial track a frame, steady frames/s and the card's
          `nvidia-smi` name and power limit.
  klt     bench.py --frontend klt: bench.py's configuration with the KLT
          track-then-redetect frontend over the first 60 frames of
          bench.py's world, drained before frame 10. It fails on a lost
          frame where the reference lost none, a trajectory that is not
          finite, fewer than 2 keyframes from the KLT keyframe branch after
          the drain, K1 launches other than 2 per extraction, a
          keyframe-rate program that ran no time where the reference ran
          it, or a mean ATE further than max(1 cm, 20 %) from the
          reference's mean over the same five versions of the frames (the
          unperturbed ones and four one-grey-level perturbations, each run
          in a worker process on the card; one run's ATE is a draw, ROADMAP
          F11). It prints each run's ATE beside the reference's,
          keyframes, map points, rescues and relocalizations, LK calls a
          frame, steady frames/s, the host ms a KLT frame of LK, the pose
          passes, the rescue and the keyframe branch, and the LK tracker's
          (candidate K7) host and device ms a call.
  rgbd    `process_rgbd` over the first 30 frames of bench.py's world at its
          configuration: the left images of the full phase and z-buffer
          depth maps (`synthetic.render_billboard_depth`). It fails on a
          lost frame where the reference lost none, an ATE further than
          max(1 cm, 20 %) from the reference's, a trajectory that is not
          finite, or K1 launches other than 1 a frame; it prints frames/s.

Any failure raises and the script exits non-zero with the traceback. On
success it prints the `nvidia-smi` line, a JSON line of per-kernel
measurements ("launches" is the full phase's count, "launches_by_phase"
adds the vio-smoother, klt, rgbd, mono and mono-inertial phases'; "ms",
"plain_ms" and "bound_ms" are device times for the 8-level left pyramid
of frame 0), and last a JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

import numpy as np

# The JAX reference's ATE on the slice phase's frames (the first 30 of the
# 50-frame slice world), on the host CPU with x64 off: `python
# tools/slice_reference_ate.py --frames 30 --world-frames 50 --flush-at
# 10`, as the smoke drains the pipeline, with the JAX package of commit
# 319d32d: 0.8284291253083997 cm with 0 lost frames and 29 keyframes. An
# accuracy figure, not a speed.
REF_ATE_CM = 0.8284291253083997
REF_ATE_COMMIT = "319d32d38d3f5e78a3dc7f1895ed0a19d2b897a9"

# The same for the full phase, the first 120 frames of bench.py's
# 200-frame world: `python tools/slice_reference_ate.py --bench-cadences
# --frames 120 --world-frames 200 --flush-at 10` at commit 319d32d (an
# accuracy figure, not a speed). The pipeline is drained before frame 10,
# as run_loop drains it before its steady clock (and bench.py after its
# warm-up): the drain changes which results the lagged host decisions see,
# so it is part of the configuration. The reference culls no keyframe in
# these frames.
REF_FULL = dict(ate_cm=6.866469075143339, lost=0, keyframes=99, map_points=24827,
                culled_keyframes=0)
REF_FULL_COMMIT = "319d32d38d3f5e78a3dc7f1895ed0a19d2b897a9"

# The same for the loop phase, atlas on as bench.py runs it: `python
# tools/slice_reference_ate.py --loop --frames 200 --flush-at 10` with the
# JAX package of commit 22ba74e (an accuracy figure, not a speed): the
# runs of each loop and atlas program, and the last frame dispatched when
# the map forked and when it merged back (fork_frames, merge_frames). The
# merge ends in the re-anchoring that a loop correction ends in, so
# loop_frames lists it (167) beside the loop's (194). Under one grey level
# (`--perturb 1` to `4`) the fork (frames 157-158) and the merge (165-166)
# stay and the loop correction goes: the phase gates the fork and the
# merge, not the correction.
REF_LOOP = dict(ate_cm=626.026744623195, lost=59, keyframes=83, relocalizations=1,
                loop_queries=81, loops_closed=1, fork_frames=[158], merge_frames=[166],
                loop_frames=[167, 194],
                programs=dict(bow_add=85, detect=75, verify=13, correct=1, gba=1, reloc=60,
                              fork=1, merge_detect=2, merge=1))
REF_LOOP_COMMIT = "22ba74e49f1b6ba06912721b09bd55dfa792f2fd"

# The same for the vio phase: `python tools/slice_reference_ate.py --vio
# --frames 60 --flush-at 8` with the JAX package of commit 22ba74e (an
# accuracy figure, not a speed): tools/bench_vio.py's configuration and
# world, the stereo-inertial pipeline drained before frame 8 as bench_vio
# drains it after its warm-up.
REF_VIO = dict(ate_cm=0.4789413901156036, lost=0, keyframes=17, imu_ready=True, init_stage=2,
               init_stage_frames=[21, 51], gravity_angle_deg=0.3406486459760357,
               bias_gyro=[0.002451913431286812, -0.0013419506140053272, 0.002509200247004628],
               bias_acc=[-0.012370639480650425, -0.03199164196848869, 0.0037461910396814346],
               bias_gyro_true=[0.002, -0.001, 0.0015], bias_acc_true=[0.05, -0.03, 0.02],
               programs=dict(integrate=59, track_vio=38, inertial_init=2, vi_local_ba=6,
                             full_inertial_ba=2, mapping=8, maintenance=1))
# The same for the vio-smoother phase: `python tools/slice_reference_ate.py
# --vio --smoother --frames 60 --flush-at 8` at commit 319d32d (an accuracy
# figure, not a speed): tools/bench_vio.py --smoother's configuration over
# the vio phase's world, drained before frame 8; "smoother" counts its
# steps (one per inertial track), "smoother_slide" the steps that found
# the window full and marginalized its oldest state.
REF_VIO_SMOOTHER = dict(
    ate_cm=1.0161164893288437, lost=0, keyframes=16, imu_ready=True, init_stage=2,
    init_stage_frames=[21, 52], gravity_angle_deg=0.4118864732497005,
    bias_gyro=[0.0018093077233061194, -0.0017238747095689178, 0.0025783346500247717],
    bias_acc=[-0.006343938875943422, -0.03270953521132469, -0.0103732505813241],
    bias_gyro_true=[0.002, -0.001, 0.0015], bias_acc_true=[0.05, -0.03, 0.02],
    programs=dict(integrate=59, track_vio=38, inertial_init=2, vi_local_ba=5, full_inertial_ba=2,
                  smoother=38, smoother_slide=28, mapping=7, maintenance=1))
REF_VIO_SMOOTHER_COMMIT = "319d32d38d3f5e78a3dc7f1895ed0a19d2b897a9"
ATLAS_PROGRAMS = ("fork", "merge_detect", "merge")
LOOP_PROGRAMS = ("bow_add", "detect", "verify", "correct", "gba", "reloc") + ATLAS_PROGRAMS

# The same for the ring phase: `python tools/slice_reference_ate.py --ring
# --frames 120 --flush-at 10 --no-atlas` (an accuracy figure, not a speed):
# the board ring (`synthetic.make_board_ring_loop(120, 100, 3.0)`), where
# tracking holds all round and one loop closes, with global BA after its
# correction, on the frame at which the correction ended. The world and its
# frames equal the reference's (tests/test_torch_synthetic.py).
RING_FRAMES, RING_PERIOD, RING_RADIUS = 120, 100, 3.0
REF_RING = dict(ate_cm=2.7374575745641176, lost=0, keyframes=25, loop_queries=24,
                loops_closed=1, loop_frames=[109],
                programs=dict(bow_add=24, detect=21, verify=3, correct=1, gba=1, reloc=0))

# The same for the klt phase: `python tools/slice_reference_ate.py --klt
# --frames 60 --flush-at 10` with the JAX package of commit f8d4416 (an
# accuracy figure, not a speed): bench.py --frontend klt over the first 60
# frames of bench.py's 200-frame world, drained before frame 10. The
# frames (ids at dispatch) whose keyframe came from the KLT keyframe
# branch, and those that ran the ORB rescue.
# The klt phase's ATE gate is over the unperturbed frames and one
# grey-level perturbation of each of these seeds: `... --klt --frames 60
# --flush-at 10 --perturb SEED` at the same commit gives
# perturbed_ate_cm (0 lost, 49 keyframes each).
KLT_FRAMES = 60
KLT_SEEDS = (1, 2, 3, 4)
REF_KLT = dict(ate_cm=5.968677776355511, lost=0, keyframes=49, map_points=14025,
               perturbed_ate_cm={1: 4.857557321560796, 2: 5.434511345338162,
                                 3: 4.599345483452369, 4: 3.56095742099975},
               klt_keyframe_frames=[1, 3, 5, 7, 8, 10, 12, 14, 15, 16, 17, 18, 19, 21, 23, 25, 27,
                                    29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
                                    45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59],
               rescue_frames=[], relocalizations=0,
               programs=dict(mapping=24, local_ba=16, maintenance=5))
REF_KLT_COMMIT = "f8d44161526ea7a72593fc4927d77fa580d27f49"

# The same for the rgbd phase: `python tools/slice_reference_ate.py --rgbd
# --frames 30` at commit f8d4416: process_rgbd over the first 30 frames of
# bench.py's world at bench.py's configuration, the depth maps of
# `synthetic.render_billboard_depth` (an accuracy figure, not a speed).
RGBD_FRAMES = 30
REF_RGBD = dict(ate_cm=0.9727923364275151, lost=0, keyframes=13, map_points=5377,
                programs=dict(mapping=6, local_ba=4, maintenance=1))

# The same for the mono phase: `python tools/slice_reference_ate.py --mono
# --frames 60` (an accuracy figure, not a speed): MonoVO over the left
# images of tools/bench_vio.py's world at its configuration with
# sensor=MONOCULAR and bf=0. The monocular path tracks synchronously, so
# no drain applies. The ATE is scale-aligned (Horn with scale) over the OK
# frames; "created_keyframes" counts the keyframes from _create_keyframe
# (each with new points). perturbed_ate_cm: `... --mono --frames 60
# --perturb SEED` at the same commit (0 lost, init at frame 1 each).
REF_MONO = dict(ate_cm=3.8019256296391046, horn_scale=23.147696959919436, init_frame=1,
                lost_after_init=0, keyframes=19, map_points=1958, used_homography=True,
                n_good=418, programs=dict(mapping=8, local_ba=8, maintenance=2),
                created_keyframes=17,
                perturbed_ate_cm={1: 2.651133143321288, 2: 3.486651064499434,
                                  3: 7.120393393941872, 4: 4.0630597160728})
REF_MONO_COMMIT = "822208b0e82cece903c05e46c845ac8b2ae793c8"

# The same for the mono-inertial phase (accuracy figures, not speeds), both
# runs synchronous, so no drain applies. The oracle run: `python
# tools/slice_reference_ate.py --mono-inertial --oracle --frames 60`:
# MonoInertialVO over tests/test_mono_inertial.py's world at its
# configuration, which meets every limit of that test. The image run:
# `... --mono-inertial --frames 60`: over the left images and IMU stream of
# tools/bench_vio.py's world at its configuration with sensor=IMU_MONOCULAR
# and bf=0, where the reference's first stage applies a scale of 0.042 and
# tracking is lost from the next frame on (ROADMAP H16). Stage frames are
# the frames whose keyframe ran the stage; the ATEs are over the OK frames.
REF_MI_ORACLE = dict(init_frame=1, not_ok_after_init=0, imu_ready=True, init_stage=2,
                     init_stage_frames=[20, 53],
                     applied_scales=[15.050155639648438, 1.003909945487976],
                     horn_scale=0.9986560007464932, scaled_ate_cm=4.428518015532757,
                     unscaled_ate_cm=4.443284204676447, gravity_angle_deg=0.1849130545422118,
                     keyframes=18, map_points=2306,
                     programs=dict(mapping=16, local_ba=5, maintenance=15, inertial_init=2,
                                   full_inertial_ba=2, vi_local_ba=11, track_vio=39))
REF_MI_IMAGE = dict(init_frame=1, not_ok_after_init=38, imu_ready=True, init_stage=1,
                    init_stage_frames=[21], applied_scales=[0.04225722327828407],
                    horn_scale=528.1506213890839, scaled_ate_cm=1.297491064824696,
                    unscaled_ate_cm=85.78197338638607, gravity_angle_deg=0.37647617464980965,
                    keyframes=9, map_points=857,
                    programs=dict(mapping=3, local_ba=3, inertial_init=1, full_inertial_ba=1,
                                  track_vio=38))
REF_MI_COMMIT = "b63510fd292c2425d0abe73bc9456971fc4cec4a"
# The reference over the oracle world with other two-view keys (`python
# tools/torch_parity_report.py --mono-inertial-seeds --frames 60`, the same
# commit): with keys 103, 203, 303 and 403 it loses its map within the first
# frames and reaches no stage, so the figures above hold for key 3 alone;
# the port draws key 3's samples (KeySampler) and is held to them.

# KITTI-00 stereo geometry and the slice world (bench.py's).
W, H = 1241, 376
FX = FY = 718.856
CX, CY = 607.1928, 185.2157
BF = 386.1448
N_FRAMES = 30  # the slice phase's frames (cut from 50 for the smoke's time)
SLICE_WORLD_FRAMES = 50  # of the slice world, whose boards depend on its length
N_FULL_FRAMES = 200  # bench.py's --frames default: its world, and the loop world
FULL_FRAMES = 120  # the full phase's frames of bench.py's world (cut from 200)
N_WARM = 10
NEVER = 10 ** 9  # a keyframe cadence no run reaches
VIO_FRAMES = 60  # tools/bench_vio.py's --frames default
VIO_WARM = 8  # and its --warmup

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


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"


def log_phase(name: str, t0: float, detail: str = "") -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s {detail}".rstrip(), flush=True)


def slice_config(bench_cadences: bool = False):
    """bench.py's configuration; the keyframe-rate programs (mapping, local
    BA, maintenance) set beyond the run's length unless `bench_cadences`,
    which gives bench.py's: every 2nd, 3rd and 8th keyframe."""
    from vi_slam_tpu_torch.utils.config import (
        BAConfig, CameraConfig, ExtractorConfig, MapConfig, SystemConfig,
        TrackerConfig,
    )

    every = dict(maintenance_every=8, local_ba_every=3, mapping_every=2) if bench_cadences \
        else dict(maintenance_every=NEVER, local_ba_every=NEVER, mapping_every=NEVER)

    return SystemConfig(
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY,
                            bf=BF, th_depth=35.0),
        extractor=ExtractorConfig(n_features=2000, use_pallas_fast=True),
        ba=BAConfig(max_local_kfs=6, max_local_points=2048,
                    local_ba_iters=2, mapping_fuse_window=1),
        map=MapConfig(max_keyframes=256, max_points=65536, max_obs_per_point=8),
        tracker=TrackerConfig(min_frames_between_kf=1, pipeline_depth=3, **every),
    )


def render_frames(world, n, pool=None):
    """The stereo pairs of the first `n` poses of a billboard world at
    KITTI-00 geometry (in `pool`'s processes when given)."""
    from vi_slam_tpu_torch.io import synthetic

    return synthetic.render_stereo_pairs(world, world.poses_wc[:n], FX, FY, CX, CY, W, H,
                                         BF / FX, pool=pool)


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


def perturb_frames(frames, seed):
    """Move 20 random pixels of every left image by one grey level, drawn
    from `seed` frame by frame, as `tools/slice_reference_ate.py --perturb`
    does for the reference."""
    rng = np.random.default_rng(seed)
    out = []
    for imgL, imgR in frames:
        imgL = np.array(imgL, np.float32)
        idx = rng.integers(0, imgL.size, 20)
        imgL.flat[idx] = np.clip(imgL.flat[idx] + rng.choice([-1.0, 1.0], 20), 0, 255)
        out.append((imgL, imgR))
    return out


def run_loop(cfg, world, n_frames, perturb=None, flush_at=N_WARM, frames=None, vocab=None,
             all_tracked=True, expected_launches=None):
    """Render `n_frames` of `world` (perturbed by `perturb_frames` when
    `perturb` is a seed; or take the given `frames`), warm a StereoVO up on
    the first N_WARM, then drive a fresh one over all of them with the
    kernel's launch count set to 0 just before (the warm pass included)
    and read just after. The pipeline is drained before frame `flush_at`
    (None: never; bench.py drains it where its steady clock starts, as the
    default does here). A vocabulary turns loop closing on; with
    `all_tracked` a lost frame fails the run. The kernel must have launched
    `expected_launches(frames_done, warm_vo, vo)` times (default: 2 per
    frame, one per image pyramid). Returns the StereoVO and the run's
    numbers (the warm StereoVO among them)."""
    import torch
    from vi_slam_tpu_torch.io import evaluation
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo

    t_render = time.perf_counter()
    if frames is None:
        frames = render_frames(world, n_frames)
    if perturb is not None:
        frames = perturb_frames(frames, perturb)
    render_s = time.perf_counter() - t_render

    fast_kernel.reset_launches()
    vo_w = make_stereo_vo(cfg, vocab=vocab)
    for i in range(N_WARM):
        vo_w.process_stereo(*frames[i], i * 0.1)
    vo_w.flush()
    vo = make_stereo_vo(cfg, vocab=vocab)
    loop_frames, atlas_events = [], []
    if vocab is not None:
        after = vo._after_loop_correction

        def corrected():
            loop_frames.append(vo.frame_id + 1)  # frames dispatched when it ends
            return after()

        vo._after_loop_correction = corrected
        # (last frame dispatched, "fork" or "merge"), as
        # tools/slice_reference_ate.py logs the reference's
        for name, tag in (("_create_map_in_atlas", "fork"), ("_do_merge", "merge")):
            fn = getattr(vo, name)

            def logged(*a, _fn=fn, _tag=tag, **kw):
                out = _fn(*a, **kw)
                if _tag == "fork" or out:
                    atlas_events.append((vo.frame_id, _tag))
                return out

            setattr(vo, name, logged)
    t_all = time.perf_counter()
    t_steady = None
    for i, (imgL, imgR) in enumerate(frames):
        if i == flush_at:
            vo.flush()
        if i == N_WARM:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        vo.process_stereo(imgL, imgR, i * 0.1)
    vo.flush()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fast_kernel.launches

    frames_done = N_WARM + n_frames
    want = 2 * frames_done if expected_launches is None else expected_launches(
        frames_done, vo_w, vo)
    if launches <= 0 or launches != want:
        raise AssertionError(
            f"fast_resp_pref launched {launches} times for {frames_done} frames,"
            f" expected {want} (one per image pyramid)"
        )
    est = vo.trajectory_wc()
    if not np.all(np.isfinite(est)) or est.shape != (n_frames, 4, 4):
        raise AssertionError(f"trajectory not finite or of shape {est.shape}")
    lost = sum(1 for r in vo.records if r.state != "OK")
    if all_tracked and lost != 0:
        raise AssertionError(f"{lost} frames not tracked")
    ate_cm = evaluation.ate_rmse(est[:, :3, 3], world.poses_wc[:n_frames, :3, 3])["rmse"] * 100.0
    return vo, {
        "render_s": render_s,
        "steady_fps": (n_frames - N_WARM) / (t_end - t_steady),
        "all_fps": n_frames / (t_end - t_all),
        "ate_cm": ate_cm,
        "lost": lost,
        "keyframes": vo.n_kf,
        "map_points": vo.n_mp,
        "launches": launches,
        "frames": frames_done,
        "loop_frames": loop_frames,
        "fork_frames": [f for f, t in atlas_events if t == "fork"],
        "merge_frames": [f for f, t in atlas_events if t == "merge"],
        "warm_vo": vo_w,
        "steady_s": t_end - t_steady,
    }


def phase_slice(world, pool=None):
    """The tracking loop on the card over the slice world, the
    keyframe-rate programs off."""
    t0 = time.perf_counter()
    frames = render_frames(world, N_FRAMES, pool)
    render_s = time.perf_counter() - t0
    _, sl = run_loop(slice_config(), world, N_FRAMES, frames=frames)
    sl["render_s"] = render_s
    tol_cm = max(1.0, 0.2 * REF_ATE_CM)
    if abs(sl["ate_cm"] - REF_ATE_CM) > tol_cm:
        raise AssertionError(
            f"ATE {sl['ate_cm']:.4f} cm vs reference {REF_ATE_CM:.4f} cm (tolerance {tol_cm:.4f} cm)"
        )
    return sl


def full_world():
    from vi_slam_tpu_torch.io import synthetic

    return synthetic.make_billboard_world(n_frames=N_FULL_FRAMES, n_boards=4000, seed=11,
                                          speed=1.0)


def phase_full(world, frames):
    """bench.py's configuration end to end over the first FULL_FRAMES frames
    of bench.py's 200-frame world (`frames`: its rendered stereo pairs)."""
    vo, full = run_loop(slice_config(bench_cadences=True), world, FULL_FRAMES,
                        frames=frames[:FULL_FRAMES])
    tol_cm = max(1.0, 0.2 * REF_FULL["ate_cm"])
    if abs(full["ate_cm"] - REF_FULL["ate_cm"]) > tol_cm:
        raise AssertionError(
            f"ATE {full['ate_cm']:.4f} cm vs reference {REF_FULL['ate_cm']:.4f} cm"
            f" (tolerance {tol_cm:.4f} cm)")
    programs = ("mapping", "local_ba", "maintenance")
    runs = {k: vo.program_runs[k] for k in programs}
    idle = [name for name, n in runs.items() if n <= 0]
    if idle:
        raise AssertionError(f"programs that ran no time: {idle} (runs {runs})")
    full["runs"] = runs
    full["host_ms"] = {k: vo.program_host_s[k] * 1e3 for k in programs}
    full["culled_keyframes"] = len(vo.culled_parent)
    return full


def ring_errors(m, truth):
    """Per-keyframe distance of the ring's camera centres from the truth."""
    from vi_slam_tpu_torch.io import synthetic

    k = synthetic.RING_KFS

    def centres(R, t):
        return np.einsum("kji,kj->ki", R, -t)

    return np.linalg.norm(centres(m["kf_R"][:k], m["kf_t"][:k]) - centres(*truth), axis=-1)


def ring_reprojection(m):
    """Mean reprojection error (px) of the ring map's live observations."""
    from vi_slam_tpu_torch.io import synthetic

    fx, fy, cx, cy = synthetic.RING_CAM
    errs = []
    for k in range(synthetic.RING_KFS):
        sel = np.flatnonzero((m["kf_mp"][k] >= 0) & m["mp_valid"][np.clip(m["kf_mp"][k], 0, None)])
        pc = m["mp_pos"][m["kf_mp"][k, sel]] @ m["kf_R"][k].T + m["kf_t"][k]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
        errs.append(np.linalg.norm(uv - m["kf_xy"][k, sel], axis=-1))
    return float(np.mean(np.concatenate(errs)))


def phase_loop_parts():
    """The drifted ring closed on the card, by the essential graph alone
    and then with global BA (stereo, bf 60), held to the reference test's
    limits. Returns the correction's and global BA's timings."""
    from vi_slam_tpu_torch.cameras.base import CameraParams
    from vi_slam_tpu_torch.io import synthetic
    from vi_slam_tpu_torch.pipeline.loop_closing import LoopCloser
    from vi_slam_tpu_torch.retrieval import vocabulary
    from vi_slam_tpu_torch.slam_map.state import map_state_from_numpy, map_state_to_numpy
    from vi_slam_tpu_torch.utils.config import MapConfig, SystemConfig

    cfg = SystemConfig(map=MapConfig(max_keyframes=16, max_points=4096, max_obs_per_point=8,
                                     essential_weight_min=100))
    d, desc, seam, truth = synthetic.make_drifted_ring(bf=60.0)
    before = ring_errors(d, truth)
    vocab = vocabulary.train_vocabulary(desc, k=6, levels=3, iters=4, seed=2, device="cuda")
    out = {}
    for gba in (False, True):
        cam = CameraParams.make(*synthetic.RING_CAM, bf=60.0, device="cuda")
        lc = LoopCloser(cfg, cam, vocab, fix_scale=True, min_gap_kfs=8, run_gba=gba)
        lc.consistency_th = 1  # one query, as the reference test drives it
        state = map_state_from_numpy(d, device="cuda")
        for k in range(synthetic.RING_KFS):
            lc.add_keyframe(state, k)
        state, closed = lc.process(state, synthetic.RING_KFS - 1, synthetic.RING_KFS)
        m = map_state_to_numpy(state)
        err = ring_errors(m, truth)
        if not closed or lc.loop_edges != [(synthetic.RING_KFS - 1, 0)]:
            raise AssertionError(f"the ring's loop did not close (edges {lc.loop_edges})")
        if not (err[-1] < 0.05 and err.max() < 0.25 and err.max() < 0.35 * before.max()):
            raise AssertionError(f"ring not restored: seam {err[-1]:.4f} m, worst {err.max():.4f}"
                                 f" m, drift {before.max():.4f} m")
        dup = np.asarray(sorted(seam.values()))
        if m["mp_valid"][dup].mean() >= 0.6:
            raise AssertionError("the seam duplicates were not fused")
        out[gba] = dict(err=err, reproj=ring_reprojection(m), device_ms=lc.timer.device_ms(),
                        host_ms={k: v * 1e3 for k, v in lc.timer.host_s.items()})
    if not (out[True]["err"].max() < out[False]["err"].max()
            and out[True]["reproj"] < 0.5 * out[False]["reproj"]):
        raise AssertionError(
            f"global BA did not tighten the ring: worst {out[True]['err'].max():.4f} vs"
            f" {out[False]['err'].max():.4f} m, reprojection {out[True]['reproj']:.3f} vs"
            f" {out[False]['reproj']:.3f} px")
    return dict(drift=before.max(), graph=out[False], gba=out[True])


def loop_world_frames(pool=None):
    """bench.py --loop's world (tools/slice_reference_ate.py --loop)."""
    from vi_slam_tpu_torch.io import synthetic

    iw, _, frames = synthetic.make_billboard_inertial_sequence(
        N_FULL_FRAMES, FX, FY, CX, CY, W, H, BF, fps=10.0, n_landmarks=2000, n_boards=4000,
        seed=11, closed_loop=True, closed_loop_period_frames=int(N_FULL_FRAMES * 0.8), speed=5.0,
        pool=pool,
    )
    return iw.world, frames


def vio_config(smoother: bool = False):
    """tools/bench_vio.py's configuration, unreduced (`smoother`: its
    --smoother, the fixed-lag smoother on)."""
    from vi_slam_tpu_torch.utils.config import (
        BAConfig, CameraConfig, ExtractorConfig, IMUConfig, MapConfig, SystemConfig,
        TrackerConfig,
    )

    return SystemConfig(
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY, bf=BF,
                            th_depth=35.0, fps=10.0),
        extractor=ExtractorConfig(n_features=2000),
        ba=BAConfig(max_local_kfs=6, max_local_points=2048, local_ba_iters=4,
                    inertial_window=8, mapping_fuse_window=1, use_smoother=smoother),
        map=MapConfig(max_keyframes=256, max_points=65536, max_obs_per_point=8),
        imu=IMUConfig(freq=200.0),
        tracker=TrackerConfig(max_frames_between_kf=4, maintenance_every=8, local_ba_every=2,
                              mapping_every=2),
    )


def vio_world(pool=None):
    """tools/bench_vio.py's world: the 60-frame billboard sequence with its
    200 Hz IMU stream, (InertialWorld, stereo pairs)."""
    from vi_slam_tpu_torch.io import synthetic

    iw, _, frames = synthetic.make_billboard_inertial_sequence(
        VIO_FRAMES, FX, FY, CX, CY, W, H, BF, n_landmarks=2000, seed=5, pool=pool)
    return iw, frames


def run_vio(cfg, ref, iw, frames):
    """The stereo-inertial pipeline over tools/bench_vio.py's world, after a
    warm pass over the first VIO_WARM frames, the pipeline drained before
    frame VIO_WARM as bench_vio.py drains it, held to the reference's
    figures `ref`; with the smoother on, its steps (one per inertial
    track) and slides too. Raises on a failed gate; returns the run's
    numbers."""
    import torch
    from vi_slam_tpu_torch.io import evaluation
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.pipeline.vio import INERTIAL_PROGRAMS, make_stereo_inertial_vo

    fast_kernel.reset_launches()
    warm = make_stereo_inertial_vo(cfg)
    for i in range(VIO_WARM):
        warm.process_stereo_inertial(*frames[i], iw.imu_per_frame[i], iw.timestamps[i])
    warm.flush()
    vo = make_stereo_inertial_vo(cfg)
    for i, (imgL, imgR) in enumerate(frames):
        if i == VIO_WARM:
            vo.flush()
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        vo.process_stereo_inertial(imgL, imgR, iw.imu_per_frame[i], iw.timestamps[i])
    vo.flush()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fast_kernel.launches
    frames_done = VIO_WARM + VIO_FRAMES
    if launches != 2 * frames_done:
        raise AssertionError(f"fast_resp_pref launched {launches} times for {frames_done}"
                             f" frames, expected {2 * frames_done}")
    est = vo.trajectory_wc()
    if not np.all(np.isfinite(est)) or est.shape != (VIO_FRAMES, 4, 4):
        raise AssertionError(f"trajectory not finite or of shape {est.shape}")
    lost = sum(1 for r in vo.records if r.state != "OK")
    if ref["lost"] == 0 and lost > 0:
        raise AssertionError(f"{lost} frames lost where the reference lost none")
    if (vo.imu_ready, vo._init_stage) != (ref["imu_ready"], ref["init_stage"]):
        raise AssertionError(f"imu_ready {vo.imu_ready}, init stage {vo._init_stage}; the"
                             f" reference's {ref['imu_ready']}, {ref['init_stage']}")
    ate_cm = evaluation.ate_rmse(est[:, :3, 3], iw.world.poses_wc[:, :3, 3])["rmse"] * 100.0
    tol_cm = max(1.0, 0.2 * ref["ate_cm"])
    if abs(ate_cm - ref["ate_cm"]) > tol_cm:
        raise AssertionError(f"ATE {ate_cm:.4f} cm vs reference {ref['ate_cm']:.4f} cm"
                             f" (tolerance {tol_cm:.4f} cm)")
    programs = INERTIAL_PROGRAMS + ("mapping", "maintenance")
    runs = {k: vo.program_runs[k] for k in programs}
    idle = [k for k in programs if ref["programs"].get(k, 0) > 0 and runs[k] <= 0]
    if idle:
        raise AssertionError(f"programs that ran no time where the reference ran them: {idle}"
                             f" (port {runs}, reference {ref['programs']})")
    if cfg.ba.use_smoother:
        if runs["smoother"] <= 0 or runs["smoother"] != runs["track_vio"]:
            raise AssertionError(f"{runs['smoother']} smoother steps for {runs['track_vio']}"
                                 " inertial tracks (one each expected)")
        if runs["smoother_slide"] <= 0:
            raise AssertionError("the smoother's window never slid (no marginalization)")
    g = vo.g_w_dev.cpu().numpy().astype(np.float64)
    cos = g @ iw.gravity_w / max(np.linalg.norm(g) * np.linalg.norm(iw.gravity_w), 1e-12)
    device = vo.timer.device_ms()
    return dict(
        steady_fps=(VIO_FRAMES - VIO_WARM) / (t_end - t_steady), ate_cm=ate_cm,
        lost=lost, keyframes=vo.n_kf, launches=launches, frames=frames_done, runs=runs,
        host_ms={k: vo.program_host_s[k] * 1e3 for k in programs},
        device_ms={k: device.get(k) for k in programs},
        init_stage=vo._init_stage, init_stage_frames=vo.init_stage_frames,
        gravity_deg=float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
        bg=vo.bg_dev.cpu().numpy(), ba=vo.ba_dev.cpu().numpy(),
    )


def vio_smoother_run(iw, frames):
    """The vio-smoother phase: tools/bench_vio.py --smoother's
    configuration over the vio phase's world and frames, in a worker
    process on the card (the kernel library the parent built) while the
    parent runs the vio phase. Raises as `run_vio` does."""
    from vi_slam_tpu_torch.kernels import build as kbuild

    kbuild.load_library()
    t0 = time.perf_counter()
    r = run_vio(vio_config(smoother=True), REF_VIO_SMOOTHER, iw, frames)
    r["seconds"] = time.perf_counter() - t0
    return r


def phase_vio(vio_pool, iw, frames):
    """tools/bench_vio.py's configuration end to end: the stereo-inertial
    pipeline over its 60-frame world (`iw`, rendered `frames`) with the
    200 Hz IMU stream, the smoother off. The vio-smoother phase's run on
    the same world and frames goes to `vio_pool`'s worker before this
    phase's own run starts, and is returned pending."""
    pending = vio_pool.apply_async(vio_smoother_run, (iw, frames))
    return run_vio(vio_config(), REF_VIO, iw, frames), pending


MONO_FRAMES = VIO_FRAMES  # the left images of the vio phase's world
MONO_STEADY_FROM = 10  # the mono phase's frames/s is counted from this frame on
MONO_SEEDS = (1, 2, 3, 4)  # its one-grey-level perturbations
# The lower limit of the mono phase's mean ATE over its five runs. The
# port's runs land below the reference's (ROADMAP F14): the mean of the
# five 1.4316-1.9872 cm over four calls of this script on an H100 80GB
# HBM3 at 700 W, 0.95-4.09 cm a run, against the reference's 4.2246 cm. A
# fault that loses the map leaves a few OK frames that Horn with scale
# fits almost exactly; `check_mono_run` catches it by its lost frames, and
# this floor catches what else would drop the mean: half the lowest mean
# measured, and the stereo-inertial estimate's ATE over the same frames
# (the vio phase's, 0.6968 cm), which a monocular run with less to go on
# is not held to beat.
MONO_ATE_FLOOR_CM = 0.7


def mono_config():
    """tools/bench_vio.py's configuration with sensor=MONOCULAR, no
    baseline and the smoother off: the mono phase's."""
    import dataclasses

    from vi_slam_tpu_torch.utils.config import Sensor

    cfg = vio_config()
    return dataclasses.replace(cfg, sensor=Sensor.MONOCULAR,
                               camera=dataclasses.replace(cfg.camera, bf=0.0))


class SvdWaits:
    """Calls of torch.linalg.svd and the host seconds spent inside them
    while installed. On the card each call returns only once the device
    has run everything queued before it and the SVD: PyTorch checks the
    result on the host."""

    def __init__(self):
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        import torch

        self._orig = torch.linalg.svd

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = self._orig(*a, **kw)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        torch.linalg.svd = timed
        return self

    def __exit__(self, *exc):
        import torch

        torch.linalg.svd = self._orig


def mono_run(iw, frames):
    """MonoVO over the left images of the vio phase's world
    (`process_mono`: two-view initialization, triangulated keyframes),
    with K1's launch count set to 0 just before and read just after.
    Returns the run's numbers (ATE scale-aligned over the OK frames), to
    be held to the reference by `check_mono_run`."""
    import torch
    from vi_slam_tpu_torch.io import evaluation
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.pipeline.mono_vo import MonoVO

    t0 = time.perf_counter()
    vo = MonoVO(mono_config())
    created = []  # (frame, new points) of each keyframe from _create_keyframe
    create = vo._create_keyframe

    def counted(*a, **kw):
        n = vo.n_mp
        out = create(*a, **kw)
        created.append((vo.frame_id, vo.n_mp - n))
        return out

    vo._create_keyframe = counted
    fast_kernel.reset_launches()
    with SvdWaits() as svd:
        for i in range(MONO_FRAMES):
            if i == MONO_STEADY_FROM:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            vo.process_mono(frames[i][0], iw.timestamps[i])
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fast_kernel.launches
    states = [r.state for r in vo.records]
    first_ok = states.index("OK") if "OK" in states else None
    lost = None if first_ok is None else sum(1 for st in states[first_ok:] if st != "OK")
    grown = [c for c in created if c[1] > 0]
    runs = dict(vo.program_runs)
    est = vo.trajectory_wc()
    if not np.all(np.isfinite(est)) or est.shape != (MONO_FRAMES, 4, 4):
        raise AssertionError(f"trajectory not finite or of shape {est.shape}")
    ok = [i for i, st in enumerate(states) if st == "OK"]
    ate = evaluation.ate_rmse(est[ok, :3, 3], iw.world.poses_wc[ok, :3, 3], with_scale=True) \
        if len(ok) >= 3 else {"rmse": float("nan"), "scale": float("nan")}
    return dict(
        seconds=time.perf_counter() - t0, init_frame=first_ok, lost=lost, states=states,
        inliers=[st.n_inliers for st in vo.stats], created_list=created,
        ate_cm=ate["rmse"] * 100.0, horn_scale=ate["scale"], keyframes=vo.n_kf,
        map_points=vo.n_mp, launches=launches, frames=MONO_FRAMES, runs=runs,
        host_ms={k: v * 1e3 for k, v in vo.program_host_s.items()},
        device_ms=vo.timer.device_ms(), init=vo.init_result, created=len(created),
        grown=len(grown), init_depth_after_ba=vo.init_depth_after_ba, svd_calls=svd.calls,
        svd_ms=svd.seconds * 1e3, steady_fps=(MONO_FRAMES - MONO_STEADY_FROM) / (t_end - t_steady),
    )


def check_mono_run(r, name: str, full: bool) -> None:
    """Raises unless the mono run `r` launched K1 once a frame,
    initialized within 2 frames of the reference and lost no frame after
    that (the reference, unperturbed and on each seed of MONO_SEEDS,
    initializes at frame 1 and loses none). With `full` (the unperturbed
    run) also unless a keyframe from `_create_keyframe` made new points
    and the mapping pass and local BA ran where the reference ran them."""
    ref = REF_MONO
    if r["launches"] != MONO_FRAMES:
        raise AssertionError(f"{name}: fast_resp_pref launched {r['launches']} times for"
                             f" {MONO_FRAMES} mono frames, expected one a frame")
    if r["init_frame"] is None or abs(r["init_frame"] - ref["init_frame"]) > 2:
        raise AssertionError(f"{name}: initialized at frame {r['init_frame']}, the reference at"
                             f" {ref['init_frame']}")
    if ref["lost_after_init"] == 0 and r["lost"] > 0:
        raise AssertionError(
            f"{name}: {r['lost']} frames lost after the initialization; the reference lost none"
            f" (states {r['states']}, inliers {r['inliers']}, the initial points' median depth"
            f" after the BA {r['init_depth_after_ba']})")
    if not full:
        return
    if not r["grown"]:
        raise AssertionError(f"{name}: no keyframe from _create_keyframe triangulated a new"
                             f" point ({r['created_list']})")
    idle = [k for k in ("mapping", "local_ba")
            if ref["programs"].get(k, 0) > 0 and r["runs"].get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"{name}: programs that ran no time where the reference ran them:"
                             f" {idle} (port {r['runs']}, reference {ref['programs']})")


def mono_phase(iw, frames):
    """The mono phase, in a worker process on the card (the kernel library
    the parent built) while the parent runs the slice, full and later
    phases: the run over the unperturbed left images, then one run
    per seed of MONO_SEEDS over the same images moved by one grey level
    (`perturb_frames`), each held to the reference by `check_mono_run`.
    One run's ATE is a draw here, in the reference and on the card
    (ROADMAP F14), so the ATE gate holds the mean of the five within a
    band: at most the reference's mean over the same five plus max(1 cm,
    20 %), at least MONO_ATE_FLOOR_CM."""
    from vi_slam_tpu_torch.kernels import build as kbuild

    kbuild.load_library()
    t0 = time.perf_counter()
    r = mono_run(iw, frames)
    check_mono_run(r, "unperturbed", full=True)
    ates = [r["ate_cm"]]
    lost = [r["lost"]]
    for seed in MONO_SEEDS:
        v = mono_run(iw, perturb_frames(frames, seed))
        check_mono_run(v, f"seed {seed}", full=False)
        ates.append(v["ate_cm"])
        lost.append(v["lost"])
    ref_ates = [REF_MONO["ate_cm"]] + [REF_MONO["perturbed_ate_cm"][s] for s in MONO_SEEDS]
    mean, ref_mean = float(np.mean(ates)), float(np.mean(ref_ates))
    tol_cm = max(1.0, 0.2 * ref_mean)
    if not MONO_ATE_FLOOR_CM <= mean <= ref_mean + tol_cm:
        raise AssertionError(f"mean scale-aligned ATE of the five runs {mean:.4f} cm ({ates}) is"
                             f" outside [{MONO_ATE_FLOOR_CM:.4f}, {ref_mean + tol_cm:.4f}] cm (the"
                             f" reference's mean {ref_mean:.4f} cm over {ref_ates})")
    r.update(port_ates=ates, ref_ates=ref_ates, port_mean=mean, ref_mean=ref_mean, tol_cm=tol_cm,
             lost_all=lost, phase_s=time.perf_counter() - t0)
    return r


# tests/test_mono_inertial.py's world and configuration: the mono-inertial
# phase's oracle run
MI_W, MI_H, MI_F = 640, 480, 500.0
MI_FRAMES = 60
MI_STEADY_FROM = 10  # its frames/s is counted from this frame on
MI_PROGRAMS = ("inertial_init", "vi_local_ba", "full_inertial_ba", "mapping", "local_ba")
# The oracle run is repeated: its scale and ATE are a draw of the float32
# summation order (ROADMAP F15), which varies from run to run on the card
# where atomics sum. The mono worker's first run is the gated one: with
# torch.use_deterministic_algorithms it is the same run, bit for bit, on
# every call.
MI_ORACLE_RUNS = 5
MI_VIO_WORKER_RUNS = 3  # of them in the vio worker, idle until its vio-smoother phase
# cuBLAS is deterministic under torch.use_deterministic_algorithms only with
# this set before its first call in the process
CUBLAS_DETERMINISTIC = ("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# tests/test_mono_inertial.py's limits, which the reference meets
MI_HORN_TOL, MI_ATE_LIMIT_CM, MI_GRAVITY_LIMIT_DEG = 0.02, 25.0, 2.0


def mono_inertial_config(oracle: bool):
    """With `oracle`, tests/test_mono_inertial.py's configuration (640x480,
    1200 features, a keyframe at least every 4 frames, local BA at every
    keyframe); else tools/bench_vio.py's with sensor=IMU_MONOCULAR and no
    baseline."""
    import dataclasses

    from vi_slam_tpu_torch.utils.config import (
        BAConfig, CameraConfig, ExtractorConfig, IMUConfig, MapConfig, Sensor, SystemConfig,
        TrackerConfig,
    )

    if not oracle:
        cfg = vio_config()
        return dataclasses.replace(cfg, sensor=Sensor.IMU_MONOCULAR,
                                   camera=dataclasses.replace(cfg.camera, bf=0.0))
    return SystemConfig(
        sensor=Sensor.IMU_MONOCULAR,
        camera=CameraConfig(width=MI_W, height=MI_H, fx=MI_F, fy=MI_F, cx=MI_W / 2, cy=MI_H / 2,
                            bf=0.0, fps=10.0),
        extractor=ExtractorConfig(n_features=1200),
        ba=BAConfig(max_local_kfs=8, max_local_points=2048, local_ba_iters=6, inertial_window=8),
        map=MapConfig(max_keyframes=128, max_points=32768, max_obs_per_point=8),
        imu=IMUConfig(freq=200.0),
        tracker=TrackerConfig(max_frames_between_kf=4),
    )


def mono_inertial_oracle_world():
    """tests/test_mono_inertial.py's world: (InertialWorld, oracle frames
    with 0.3 px noise)."""
    from vi_slam_tpu_torch.io import synthetic

    iw = synthetic.make_inertial_world(n_frames=MI_FRAMES, fps=10.0, n_landmarks=8000, seed=3,
                                       excitation=4.0)
    frames = [synthetic.render_oracle_frame(iw.world, i, MI_F, MI_F, MI_W / 2, MI_H / 2, 250.0,
                                            MI_W, MI_H, max_features=1000, px_noise=0.3)
              for i in range(MI_FRAMES)]
    return iw, frames


def mono_inertial_run(iw, frames, oracle: bool, seed: int = 3, deterministic: bool = False):
    """MonoInertialVO over `frames` of the world `iw` with its IMU stream:
    with `oracle`, oracle features through `process_oracle_mono_inertial`,
    else the left images of stereo pairs through `process_mono_inertial`
    (K1 once a frame). The two-view draws are the reference's stream with
    key `seed` (`KeySampler`; the pipeline's default is key 3). With
    `deterministic`, under torch.use_deterministic_algorithms (the process
    must have CUBLAS_DETERMINISTIC set). K1's launch count is set to 0 just
    before and read just after. Returns the run's numbers."""
    import torch
    from vi_slam_tpu_torch.io import evaluation
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.pipeline.vio import MonoInertialVO
    from vi_slam_tpu_torch.utils.sampling import KeySampler

    t0 = time.perf_counter()
    vo = MonoInertialVO(mono_inertial_config(oracle), draw=KeySampler(seed))
    scales = []
    apply_scale = vo._apply_map_scale

    def applied(s):
        scales.append(float(s))
        return apply_scale(s)

    vo._apply_map_scale = applied
    n = len(frames)
    fast_kernel.reset_launches()
    torch.use_deterministic_algorithms(deterministic)
    try:
        for i in range(n):
            if i == MI_STEADY_FROM:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            if oracle:
                fr = frames[i]
                vo.process_oracle_mono_inertial(fr.xy, fr.desc, fr.level, iw.imu_per_frame[i],
                                                iw.timestamps[i])
            else:
                vo.process_mono_inertial(frames[i][0], iw.imu_per_frame[i], iw.timestamps[i])
        vo.flush()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    t_end = time.perf_counter()
    launches = fast_kernel.launches
    states = [r.state for r in vo.records]
    first_ok = states.index("OK") if "OK" in states else None
    est = vo.trajectory_wc()
    ok = [i for i, st in enumerate(states) if st == "OK"]
    nan = {"rmse": float("nan"), "scale": float("nan")}
    gt = iw.world.poses_wc[ok, :3, 3]
    scaled = evaluation.ate_rmse(est[ok, :3, 3], gt, with_scale=True) if len(ok) >= 3 else nan
    unscaled = evaluation.ate_rmse(est[ok, :3, 3], gt) if len(ok) >= 3 else nan
    g = vo.g_w_dev.cpu().numpy().astype(np.float64)
    cos = g @ iw.gravity_w / max(np.linalg.norm(g) * np.linalg.norm(iw.gravity_w), 1e-12)
    runs = dict(vo.program_runs)
    return dict(
        seconds=time.perf_counter() - t0, seed=seed, deterministic=deterministic, frames=n,
        states="".join(x[0] for x in states),
        init_frame=first_ok, not_ok_after_init=None if first_ok is None else sum(
            1 for st in states[first_ok:] if st != "OK"),
        lost_after_bootstrap=states[2:].count("LOST"), finite=bool(np.all(np.isfinite(est))),
        shape_ok=est.shape == (n, 4, 4), imu_ready=bool(vo.imu_ready),
        init_stage=int(vo._init_stage), stage_frames=list(vo.init_stage_frames),
        applied_scales=scales, horn_scale=scaled["scale"], scaled_ate_cm=scaled["rmse"] * 100.0,
        unscaled_ate_cm=unscaled["rmse"] * 100.0,
        gravity_deg=float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
        keyframes=vo.n_kf, map_points=vo.n_mp, two_view=vo.init_result, launches=launches,
        runs=runs, host_ms={k: v * 1e3 for k, v in vo.program_host_s.items()},
        track_vio_ms=vo.program_host_s.get("track_vio", 0.0) * 1e3
        / max(runs.get("track_vio", 0), 1),
        steady_fps=(n - MI_STEADY_FROM) / (t_end - t_steady),
    )


def stages_on_time(r, ref, n: int) -> bool:
    """Whether run `r` has at least `n` stages and each of its first `n`
    came within 3 frames of the reference's, both counted from their
    initialization frames. A stage runs on the first keyframe once the
    keyframe chain spans its seconds from the map's first keyframe (the
    held frame, one before the initialization), and a keyframe comes at
    least every 4 frames, so a stage's frame follows the initialization's
    and moves with the cadence's phase by up to 3."""
    got, want = r["stage_frames"], ref["init_stage_frames"]
    return len(got) >= n and all(
        abs((a - r["init_frame"]) - (b - ref["init_frame"])) <= 3 for a, b in zip(got[:n], want))


def check_mono_inertial_oracle(r) -> None:
    """Raises if the oracle run `r` launched K1 (it extracts nothing) or
    left a pose that is not finite."""
    if r["launches"] != 0:
        raise AssertionError(f"oracle run: K1 launched {r['launches']} times on oracle features")
    if not r["finite"]:
        raise AssertionError(f"oracle run: a pose is not finite (states {r['states']})")


def mono_inertial_misses(r) -> list:
    """What of the reference run's course the oracle run `r` misses: the
    initialization within 2 frames of the reference's, a finite trajectory
    with one pose a frame (a run that loses its map is reset, and its
    records with it), `imu_ready` and the reference's last stage with each
    stage on time, every frame tracked after the initialization, each
    program of MI_PROGRAMS that the reference ran. Empty where it follows
    it."""
    ref = REF_MI_ORACLE
    misses = []
    if r["init_frame"] is None or abs(r["init_frame"] - ref["init_frame"]) > 2:
        return [f"initialized at frame {r['init_frame']} (states {r['states']})"]
    if not (r["finite"] and r["shape_ok"]):
        misses.append("trajectory not finite or not one pose a frame")
    if (not r["imu_ready"] or r["init_stage"] != ref["init_stage"]
            or not stages_on_time(r, ref, len(ref["init_stage_frames"]))):
        misses.append(f"stage {r['init_stage']} at frames {r['stage_frames']}")
    if r["not_ok_after_init"] != ref["not_ok_after_init"]:
        misses.append(f"{r['not_ok_after_init']} frames not tracked")
    idle = [k for k in MI_PROGRAMS if ref["programs"].get(k, 0) > 0 and r["runs"].get(k, 0) <= 0]
    if idle:
        misses.append(f"programs not run {idle}")
    return misses


def mono_inertial_off_limits(r) -> list:
    """tests/test_mono_inertial.py's limits that the oracle run `r`
    misses (Horn scale within 2 % of 1, unscaled ATE under 25 cm, gravity
    within 2 deg); the reference's run meets them all."""
    off = []
    if not abs(r["horn_scale"] - 1.0) < MI_HORN_TOL:
        off.append(f"Horn scale {r['horn_scale']:.5f}")
    if not r["unscaled_ate_cm"] < MI_ATE_LIMIT_CM:
        off.append(f"unscaled ATE {r['unscaled_ate_cm']:.4f} cm")
    if not r["gravity_deg"] < MI_GRAVITY_LIMIT_DEG:
        off.append(f"gravity {r['gravity_deg']:.4f} deg")
    return off


def check_mono_inertial_runs(runs) -> None:
    """Each oracle run's own gates (`check_mono_inertial_oracle`), then
    that the deterministic run follows the reference run's course
    (`mono_inertial_misses`) and meets tests/test_mono_inertial.py's limits
    (`mono_inertial_off_limits`). Where the other runs end is a draw of the
    card's sums (F15): printed, not gated."""
    for i, r in enumerate(runs):
        try:
            check_mono_inertial_oracle(r)
        except AssertionError as e:
            raise AssertionError(f"oracle run {i} of {len(runs)}: {e}") from None
    det = [r for r in runs if r["deterministic"]]
    if len(det) != 1:
        raise AssertionError(f"{len(det)} deterministic oracle runs, expected one")
    bad = mono_inertial_misses(det[0]) + mono_inertial_off_limits(det[0])
    if bad:
        raise AssertionError(f"deterministic oracle run: {bad} (states {det[0]['states']},"
                             f" applied scales {det[0]['applied_scales']})")


def check_mono_inertial_image(r) -> None:
    """Raises unless the image run `r` launched K1 once a frame,
    initialized within 2 frames of the reference, reached `imu_ready` with
    its first stage on time (`stages_on_time`), and kept a finite
    trajectory. (The reference loses track at its first stage on this
    world: its lost frames, scale, ATE and gravity are printed, not
    gated.)"""
    ref = REF_MI_IMAGE
    if r["launches"] != r["frames"]:
        raise AssertionError(f"image run: K1 launched {r['launches']} times for {r['frames']}"
                             " frames, expected one a frame")
    if not (r["finite"] and r["shape_ok"]):
        raise AssertionError("image run: trajectory not finite or of the wrong shape")
    if r["init_frame"] is None or abs(r["init_frame"] - ref["init_frame"]) > 2:
        raise AssertionError(f"image run: initialized at frame {r['init_frame']}, the reference"
                             f" at {ref['init_frame']}")
    if not r["imu_ready"] or not stages_on_time(r, ref, 1):
        raise AssertionError(f"image run: imu_ready {r['imu_ready']}, stages at"
                             f" {r['stage_frames']} (init at {r['init_frame']}); the reference's"
                             f" first at {ref['init_stage_frames'][0]} (init at"
                             f" {ref['init_frame']})")


def mono_inertial_oracle_runs(n: int, deterministic_first: bool = False):
    """`n` oracle runs over tests/test_mono_inertial.py's world, the first
    with `deterministic_first` under torch.use_deterministic_algorithms
    (each run's numbers; the gates are the parent's)."""
    iw, frames = mono_inertial_oracle_world()
    return [mono_inertial_run(iw, frames, oracle=True, deterministic=deterministic_first and i == 0)
            for i in range(n)]


def mono_inertial_phase(vio_iw, vio_frames, n_oracle: int):
    """The mono-inertial phase's share in the mono phase's worker after
    its runs: `n_oracle` oracle runs, the first deterministic, then the
    image run over the left images and IMU stream of the vio phase's world
    (its gates checked here)."""
    t0 = time.perf_counter()
    oracle = mono_inertial_oracle_runs(n_oracle, deterministic_first=True)
    image = mono_inertial_run(vio_iw, vio_frames, oracle=False)
    check_mono_inertial_image(image)
    return dict(oracle=oracle, image=image, phase_s=time.perf_counter() - t0)


def mono_inertial_line(mi, smi: str) -> str:
    """The mono-inertial phase's line: each run's numbers beside the
    reference's, with the card."""

    def run(r, ref):
        prog = ", ".join(f"{k} {r['runs'].get(k, 0)} (reference {ref['programs'].get(k, 0)})"
                         for k in MI_PROGRAMS)
        return (f"init at frame {r['init_frame']} (reference {ref['init_frame']}), two-view"
                f" {r['two_view']} | imu_ready {r['imu_ready']}, stage {r['init_stage']} at frames"
                f" {r['stage_frames']} (reference {ref['init_stage']} at"
                f" {ref['init_stage_frames']}), applied scales {fmt_list(r['applied_scales'])}"
                f" (reference {fmt_list(ref['applied_scales'])}) | frames not tracked after the"
                f" initialization {r['not_ok_after_init']} (reference {ref['not_ok_after_init']})"
                f" | Horn scale {r['horn_scale']:.5f} (reference {ref['horn_scale']:.5f})"
                f" | unscaled ATE {r['unscaled_ate_cm']:.4f} cm (reference"
                f" {ref['unscaled_ate_cm']:.4f}), scale-aligned {r['scaled_ate_cm']:.4f} cm"
                f" (reference {ref['scaled_ate_cm']:.4f}) | gravity {r['gravity_deg']:.4f} deg"
                f" from the truth (reference {ref['gravity_angle_deg']:.4f}) | keyframes"
                f" {r['keyframes']} (reference {ref['keyframes']}), map points {r['map_points']}"
                f" (reference {ref['map_points']}) | runs: {prog} | host ms of the inertial track"
                f" (track_vio) a frame {r['track_vio_ms']:.2f} over {r['runs'].get('track_vio', 0)}"
                f" frames | steady {r['steady_fps']:.3f} frames/s (from"
                f" frame {MI_STEADY_FROM}) | {r['seconds']:.2f} s | fast_resp_pref launches"
                f" {r['launches']} for {r['frames']} frames")

    runs = mi["oracle"]
    follow = [i for i, r in enumerate(runs) if not mono_inertial_misses(r)]
    met = [i for i in follow if not mono_inertial_off_limits(runs[i])]
    det = [i for i, r in enumerate(runs) if r["deterministic"]]
    per_run = " | ".join(
        f"run {i}{' (deterministic)' if r['deterministic'] else ''}: states {r['states']},"
        f" stages at {r['stage_frames']}, applied"
        f" {fmt_list(r['applied_scales'])}, Horn {r['horn_scale']:.5f}, unscaled ATE"
        f" {r['unscaled_ate_cm']:.4f} cm, gravity {r['gravity_deg']:.4f} deg, two-view"
        f" {r['two_view']}, {r['seconds']:.2f} s, misses"
        f" {mono_inertial_misses(r) + mono_inertial_off_limits(r) or 'none'}"
        for i, r in enumerate(runs))
    return (f"MonoInertialVO with the reference's two-view draws (key 3), {len(runs)} oracle runs"
            f" ({MI_VIO_WORKER_RUNS} in the vio worker before its vio-smoother phase, the rest"
            f" and the image run in the mono worker after its runs: {mi['phase_s']:.2f} s) | card"
            f" {smi} | reference at {REF_MI_COMMIT[:7]} | oracle runs (tests/test_mono_inertial.py's"
            f" world, {MI_FRAMES} frames, process_oracle_mono_inertial): {len(follow)} of"
            f" {len(runs)} follow the reference's course (runs {follow}), {len(met)} of them within"
            f" tests/test_mono_inertial.py's limits as the reference (runs {met}; gated: the"
            f" deterministic run {det}, every run's poses finite; F15) | {per_run}"
            f" | the deterministic run in full: {run(runs[det[0]], REF_MI_ORACLE) if det else None}"
            f" | image run (the left images and IMU of tools/bench_vio.py's world,"
            f" {VIO_FRAMES} frames, process_mono_inertial; lost frames, scale, ATE and gravity"
            f" not gated): {run(mi['image'], REF_MI_IMAGE)}")


def train_loop_vocabulary(cfg, frames):
    """bench.py's vocabulary, trained on the card: the port's ORB
    descriptors of every (frames // 10)-th left image, k=8, 3 levels, 4
    iterations, seed 3."""
    import torch
    from vi_slam_tpu_torch.features.extractor import OrbExtractor
    from vi_slam_tpu_torch.retrieval import vocabulary

    ext = OrbExtractor(cfg.extractor, H, W, device="cuda")
    descs = []
    for i in range(0, len(frames), max(len(frames) // 10, 1)):
        feats, _ = ext.extract(torch.from_numpy(np.asarray(frames[i][0], np.float32)).cuda())
        descs.append(feats.desc[feats.valid])
    return vocabulary.train_vocabulary(torch.cat(descs), k=8, levels=3, iters=4, seed=3,
                                       device="cuda")


def phase_loop(pool=None):
    """bench.py --loop's configuration end to end, with the atlas on as
    bench.py runs it."""
    t0 = time.perf_counter()
    world, frames = loop_world_frames(pool)
    cfg = slice_config(bench_cadences=True)
    vocab = train_loop_vocabulary(cfg, frames)
    prep_s = time.perf_counter() - t0
    vo, r = run_loop(cfg, world, N_FULL_FRAMES, frames=frames, vocab=vocab, all_tracked=False)
    lc = vo.loop_closer
    runs, host, _ = loop_numbers(vo)
    if lc.stats.n_queries <= 0:
        raise AssertionError("no loop query ran")
    if REF_LOOP["fork_frames"] and not r["fork_frames"]:
        raise AssertionError(f"no map fork; the reference forks at {REF_LOOP['fork_frames']}")
    if REF_LOOP["merge_frames"] and not r["merge_frames"]:
        raise AssertionError(f"no merge; the reference merges at {REF_LOOP['merge_frames']}")
    # the reference's one loop correction here comes and goes under one grey
    # level (ROADMAP F4): the correction and global BA are gated in the
    # loop-parts and ring phases
    gated = [p for p in LOOP_PROGRAMS if p not in ("correct", "gba")]
    missing = [p for p in gated if REF_LOOP["programs"].get(p, 0) > 0 and runs[p] <= 0]
    if missing:
        raise AssertionError(f"loop programs that ran no time where the reference ran them:"
                             f" {missing} (port {runs}, reference {REF_LOOP['programs']})")
    r.update(prep_s=prep_s, runs=runs, host_ms=host, queries=lc.stats.n_queries,
             closed=lc.stats.n_loops_closed, relocalized=vo.n_relocalized)
    return r


def loop_numbers(vo):
    """Runs, host ms and device span (ms; None where not measured) of each
    loop program of a StereoVO's run."""
    lc = vo.loop_closer
    own = ("reloc",) + ATLAS_PROGRAMS
    runs = dict(lc.timer.runs, **{k: vo.program_runs[k] for k in own})
    host = dict({k: v * 1e3 for k, v in lc.timer.host_s.items()},
                **{k: vo.program_host_s[k] * 1e3 for k in own})
    vdev = vo.timer.device_ms()
    device = dict(lc.timer.device_ms(), **{k: vdev.get(k) for k in own})
    return runs, host, device


def phase_ring(pool=None):
    """The board ring end to end at full width, atlas off: a loop closes
    through `make_stereo_vo`, and its correction and global BA run on the
    card over bench.py's map capacity (256 keyframes, 65,536 points)."""
    import dataclasses

    from vi_slam_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    world = synthetic.make_board_ring_loop(RING_FRAMES, RING_PERIOD, RING_RADIUS)
    frames = render_frames(world, RING_FRAMES, pool)
    cfg = slice_config(bench_cadences=True)
    cfg = cfg.replace(tracker=dataclasses.replace(cfg.tracker, atlas_enabled=False))
    vocab = train_loop_vocabulary(cfg, frames)
    prep_s = time.perf_counter() - t0
    vo, r = run_loop(cfg, world, RING_FRAMES, frames=frames, vocab=vocab, all_tracked=False)
    runs, host, device = loop_numbers(vo)
    lc = vo.loop_closer
    if lc.stats.n_loops_closed < 1 or runs["correct"] < 1 or runs["gba"] < 1:
        raise AssertionError(
            f"the ring's loop was not closed with global BA: {lc.stats.n_loops_closed} loops,"
            f" runs {runs} (reference: {REF_RING['loops_closed']} loop at frame"
            f" {REF_RING['loop_frames']}, runs {REF_RING['programs']})")
    missing = [p for p in LOOP_PROGRAMS if REF_RING["programs"].get(p, 0) > 0 and runs[p] <= 0]
    if missing:
        raise AssertionError(f"loop programs that ran no time where the reference ran them:"
                             f" {missing} (port {runs}, reference {REF_RING['programs']})")
    r.update(prep_s=prep_s, runs=runs, host_ms=host, device_ms=device,
             queries=lc.stats.n_queries, closed=lc.stats.n_loops_closed,
             relocalized=vo.n_relocalized)
    return r


def klt_config():
    """bench.py --frontend klt: bench.py's configuration with the KLT
    frontend."""
    import dataclasses

    cfg = slice_config(bench_cadences=True)
    return cfg.replace(tracker=dataclasses.replace(cfg.tracker, frontend="klt"))


def klt_variant(seed):
    """The klt phase's loop over its frames with 20 pixels of each left
    image moved by one grey level (`perturb_frames(..., seed)`), run in a
    worker process on the card (the kernel library the parent built);
    returns its ATE, lost frames and keyframes. Raises as `run_loop` does
    (launch count, finite trajectory)."""
    import torch
    from vi_slam_tpu_torch.kernels import build as kbuild

    torch.set_num_threads(1)
    kbuild.load_library()
    world = full_world()
    _, r = run_loop(klt_config(), world, KLT_FRAMES, perturb=seed,
                    frames=render_frames(world, KLT_FRAMES), all_tracked=False,
                    expected_launches=lambda n, w, v: 2 * (w.n_extractions + v.n_extractions))
    return dict(seed=seed, ate_cm=r["ate_cm"], lost=r["lost"], keyframes=r["keyframes"])


def phase_klt(world, frames, pool):
    """bench.py --frontend klt over the first KLT_FRAMES frames of bench.py's
    world, drained before frame N_WARM as bench.py drains it. K1 runs in
    every extraction (initialization, rescues, keyframes, failed frames):
    2 launches each.

    The ATE of one run of this world is a draw: one grey level on 20
    pixels a frame moves the reference's between 3.56 and 5.97 cm (ROADMAP
    F11). So the ATE gate compares like with like over the same five
    versions of the frames, the unperturbed ones and those of KLT_SEEDS:
    the mean of the port's ATEs must lie within max(1 cm, 20 %) of the mean
    of the reference's. The perturbed runs go to `pool`'s workers while
    this process runs the unperturbed one; every run must lose no frame
    where the reference's lost none."""
    import torch
    from vi_slam_tpu_torch.ops import klt

    pending = [pool.apply_async(klt_variant, (seed,)) for seed in KLT_SEEDS]
    lk_calls = [0]
    track = klt.track_pyramidal

    def counted(*a, **kw):
        lk_calls[0] += 1
        return track(*a, **kw)

    klt.track_pyramidal = counted
    try:
        vo, r = run_loop(klt_config(), world, KLT_FRAMES, frames=frames[:KLT_FRAMES],
                         all_tracked=False,
                         expected_launches=lambda n, w, v: 2 * (w.n_extractions + v.n_extractions))
    finally:
        klt.track_pyramidal = track
    variants = [p.get(timeout=900) for p in pending]
    ref = REF_KLT
    ref_ates = [ref["ate_cm"]] + [ref["perturbed_ate_cm"][s] for s in KLT_SEEDS]
    port_ates = [r["ate_cm"]] + [v["ate_cm"] for v in variants]
    lost = [r["lost"]] + [v["lost"] for v in variants]
    if ref["lost"] == 0 and any(lost):
        raise AssertionError(f"frames lost {lost} (unperturbed, then seeds {KLT_SEEDS}) where"
                             " the reference lost none")
    ref_mean, port_mean = float(np.mean(ref_ates)), float(np.mean(port_ates))
    tol_cm = max(1.0, 0.2 * ref_mean)
    if abs(port_mean - ref_mean) > tol_cm:
        raise AssertionError(f"mean ATE {port_mean:.4f} cm (runs {port_ates}) vs the reference's"
                             f" {ref_mean:.4f} cm (runs {ref_ates}), tolerance {tol_cm:.4f} cm")
    klt_kfs = [f for f in vo.klt_kf_frames if f >= N_WARM]
    if len(klt_kfs) < 2:
        raise AssertionError(f"{len(klt_kfs)} keyframes from the KLT keyframe branch after the"
                             f" drain (frames {vo.klt_kf_frames})")
    programs = ("mapping", "local_ba", "maintenance")
    runs = {k: vo.program_runs[k] for k in programs}
    idle = [k for k in programs if ref["programs"].get(k, 0) > 0 and runs[k] <= 0]
    if idle:
        raise AssertionError(f"programs that ran no time where the reference ran them: {idle}"
                             f" (port {runs}, reference {ref['programs']})")
    # the frames that ran the KLT frame program (two pose passes each);
    # the others initialized
    n_klt, n_klt_all = (v.klt_timer.runs["pose"] // 2 for v in (vo, r["warm_vo"]))
    n_klt_all += n_klt
    host = {k: vo.klt_timer.host_s[k] * 1e3 / n_klt for k in vo.klt_timer.host_s}
    k7 = measure_k7(vo, frames[KLT_FRAMES - 2:KLT_FRAMES])
    torch.cuda.synchronize()
    r.update(port_ates=port_ates, ref_ates=ref_ates, port_mean=port_mean, ref_mean=ref_mean,
             tol_cm=tol_cm, variant_keyframes=[v["keyframes"] for v in variants],
             klt_kf_frames=vo.klt_kf_frames, rescue_frames=vo.rescue_frames,
             relocalized=vo.n_relocalized, runs=runs, extractions=vo.n_extractions
             + r["warm_vo"].n_extractions, lk_per_frame=lk_calls[0] / n_klt_all,
             host_ms=host, k7=k7)
    return r


def measure_k7(vo, pair):
    """`ops/klt.py::track_pyramidal` (candidate K7) on the card at the
    main path's shapes: the run's live track set from the left pyramid of
    the second-to-last frame into the last one's, guessed at its own
    positions. Host ms to dispatch a call; device ms a call, the sum of its
    kernels' times by `torch.profiler` (a call is host-bound, so CUDA events
    around it time the host); ms a call from its start to the end of its
    device work, by CUDA events; kernels a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vi_slam_tpu_torch.ops import klt

    imgs = [vo._upload_images(*p) for p in pair]
    pa, pb = vo._pyramid(imgs[0]), vo._pyramid(imgs[1])
    tr = vo.cfg.tracker
    xy, valid = vo.trk_xy, vo.trk_valid

    def call():
        return klt.track_pyramidal(pa, pb, xy, valid, xy_guess=xy, half=tr.klt_half,
                                   iters=tr.klt_iters, max_residual=tr.klt_max_residual)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return dict(tracks=int(valid.sum()), capacity=int(xy.shape[0]), host_ms=host_ms,
                device_ms=device_ms, kernels=sum(e.count for e in kernels) / reps,
                call_ms=call_ms(call, reps))


def phase_rgbd(world, frames):
    """`process_rgbd` over the first RGBD_FRAMES frames of bench.py's world
    at bench.py's configuration: the full phase's left images and the
    z-buffer depth maps of `synthetic.render_billboard_depth`, after a warm
    pass over the first N_WARM frames. K1: one launch a frame (one image)."""
    import torch
    from vi_slam_tpu_torch.io import evaluation, synthetic
    from vi_slam_tpu_torch.ops import fast_kernel
    from vi_slam_tpu_torch.pipeline.stereo_vo import make_stereo_vo

    t0 = time.perf_counter()
    depths = [synthetic.render_billboard_depth(world, world.poses_wc[i], FX, FY, CX, CY, W, H)
              for i in range(RGBD_FRAMES)]
    prep_s = time.perf_counter() - t0
    cfg = slice_config(bench_cadences=True)
    fast_kernel.reset_launches()
    warm = make_stereo_vo(cfg)
    for i in range(N_WARM):
        warm.process_rgbd(frames[i][0], depths[i], i * 0.1)
    vo = make_stereo_vo(cfg)
    for i in range(RGBD_FRAMES):
        if i == N_WARM:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        vo.process_rgbd(frames[i][0], depths[i], i * 0.1)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = fast_kernel.launches
    done = N_WARM + RGBD_FRAMES
    if launches != done:
        raise AssertionError(f"fast_resp_pref launched {launches} times for {done} RGB-D frames,"
                             f" expected {done} (one image a frame)")
    est = vo.trajectory_wc()
    if not np.all(np.isfinite(est)) or est.shape != (RGBD_FRAMES, 4, 4):
        raise AssertionError(f"trajectory not finite or of shape {est.shape}")
    ref = REF_RGBD
    lost = sum(1 for rec in vo.records if rec.state != "OK")
    if ref["lost"] == 0 and lost > 0:
        raise AssertionError(f"{lost} frames lost where the reference lost none")
    ate_cm = evaluation.ate_rmse(est[:, :3, 3], world.poses_wc[:RGBD_FRAMES, :3, 3])["rmse"] * 100
    tol_cm = max(1.0, 0.2 * ref["ate_cm"])
    if abs(ate_cm - ref["ate_cm"]) > tol_cm:
        raise AssertionError(f"ATE {ate_cm:.4f} cm vs reference {ref['ate_cm']:.4f} cm"
                             f" (tolerance {tol_cm:.4f} cm)")
    return dict(prep_s=prep_s, steady_fps=(RGBD_FRAMES - N_WARM) / (t_end - t_steady),
                ate_cm=ate_cm, lost=lost, keyframes=vo.n_kf, map_points=vo.n_mp,
                launches=launches, frames=done, runs=dict(vo.program_runs))


def mono_alone(seeds=(), repeat: int = 1) -> None:
    """The mono phase's run by itself: build the kernels, warm up as its
    worker does, render the vio phase's world, then run on its left
    images `repeat` times and once per perturbation seed
    (`perturb_frames`); one JSON line a run, with "failed" where
    `check_mono_run` refuses it (the next run goes on)."""
    import torch
    from vi_slam_tpu_torch.kernels import build as kbuild

    kbuild.build()
    kbuild.load_library()
    t0 = time.perf_counter()
    warm_mono_worker()
    warm_s = time.perf_counter() - t0
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(8, os.cpu_count() or 1))
    try:
        iw, frames = vio_world(pool)
    finally:
        pool.terminate()
        pool.join()
    for seed in [None] * repeat + list(seeds):
        run_frames = frames if seed is None else perturb_frames(frames, seed)
        r = None
        try:
            r = mono_run(iw, run_frames)
            check_mono_run(r, f"perturb {seed}", full=seed is None)
        except AssertionError as e:  # a run the phase would refuse: report it, go on
            r = {"failed": str(e), **({} if r is None else r)}
        print(json.dumps({"perturb": seed, "warm_s": warm_s, **r,
                          "device": torch.cuda.get_device_name(0)}, default=str), flush=True)


def mono_inertial_alone(seeds=(), deterministic: bool = False) -> None:
    """The mono-inertial phase's runs by themselves: build the kernels,
    warm up as the mono worker does, then the oracle run with the two-view
    sampler seeded 3 and each of `seeds` (with `deterministic` under
    torch.use_deterministic_algorithms), and the image run over the vio
    phase's world; one JSON line a run, with "failed" where its gates
    refuse it (the next run goes on)."""
    import torch
    from vi_slam_tpu_torch.kernels import build as kbuild

    kbuild.build()
    kbuild.load_library()
    t0 = time.perf_counter()
    warm_mono_worker()
    warm_s = time.perf_counter() - t0
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(8, os.cpu_count() or 1))
    try:
        vio_iw, vio_frames = vio_world(pool)
    finally:
        pool.terminate()
        pool.join()
    iw, frames = mono_inertial_oracle_world()
    runs = [(True, s) for s in [3] + list(seeds)] + [(False, 3)]
    for oracle, seed in runs:
        r = None
        try:
            if oracle:
                r = mono_inertial_run(iw, frames, oracle=True, seed=seed,
                                      deterministic=deterministic)
                r["misses"] = mono_inertial_misses(r) + mono_inertial_off_limits(r)
                check_mono_inertial_oracle(r)
            else:
                r = mono_inertial_run(vio_iw, vio_frames, oracle=False, seed=seed)
                check_mono_inertial_image(r)
        except AssertionError as e:  # a run the phase would refuse: report it, go on
            r = {"failed": str(e), **({} if r is None else r)}
        print(json.dumps({"run": "oracle" if oracle else "image", "warm_s": warm_s, **r,
                          "device": torch.cuda.get_device_name(0)}, default=str), flush=True)


def ate_runs(seeds, flush_at, klt: bool = False) -> None:
    """The full phase's loop alone (with `klt`, the klt phase's),
    unperturbed and once per perturbation seed, with the pipeline drained
    before frame `flush_at` (None: never); one JSON line a run, for the
    spread of the port's ATE beside the reference's
    (`tools/slice_reference_ate.py --perturb SEED`)."""
    import torch
    from vi_slam_tpu_torch.kernels import build as kbuild

    kbuild.build()
    kbuild.load_library()
    world = full_world()
    cfg, n = (klt_config(), KLT_FRAMES) if klt else (slice_config(bench_cadences=True),
                                                       FULL_FRAMES)
    frames = render_frames(world, n)
    for seed in [None] + list(seeds):
        vo, r = run_loop(cfg, world, n, perturb=seed, flush_at=flush_at, frames=frames,
                         all_tracked=not klt, expected_launches=(lambda f, w, v: 2 * (
                             w.n_extractions + v.n_extractions)) if klt else None)
        print(json.dumps({
            "perturb": seed, "flush_at": flush_at, "ate_cm": r["ate_cm"], "lost": r["lost"],
            "keyframes": r["keyframes"], "map_points": r["map_points"],
            "culled_keyframes": len(vo.culled_parent), "runs": vo.program_runs,
            "steady_fps": r["steady_fps"], "device": torch.cuda.get_device_name(0),
            **({"klt_kf_frames": vo.klt_kf_frames, "rescue_frames": vo.rescue_frames}
               if klt else {}),
        }), flush=True)


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ate", action="store_true",
                    help="run only the full phase's loop and print its ATE (not the check)")
    ap.add_argument("--perturb", type=int, nargs="*", default=[], metavar="SEED",
                    help="with --ate: also one run per seed, one grey level moved")
    ap.add_argument("--flush-at", type=int, default=N_WARM, metavar="N",
                    help="with --ate: drain the pipeline before frame N (-1: never)")
    ap.add_argument("--klt", action="store_true",
                    help="with --ate: the klt phase's loop instead of the full phase's")
    ap.add_argument("--mono", action="store_true",
                    help="run only the mono phase and print its numbers (not the check)")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="with --mono: run the unperturbed frames N times")
    ap.add_argument("--mono-inertial", action="store_true",
                    help="run only the mono-inertial phase's runs and print their numbers (not"
                         " the check)")
    ap.add_argument("--seeds", type=int, nargs="*", default=[], metavar="SEED",
                    help="with --mono-inertial: also one oracle run per two-view key (the"
                         " reference's PRNGKey(SEED) stream)")
    ap.add_argument("--deterministic", action="store_true",
                    help="with --mono-inertial: the oracle runs under"
                         " torch.use_deterministic_algorithms")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    if args.ate:
        ate_runs(args.perturb, None if args.flush_at < 0 else args.flush_at, klt=args.klt)
        return 0
    if args.mono:
        mono_alone(args.perturb, args.repeat)
        return 0
    if args.mono_inertial:
        mono_inertial_alone(args.seeds, args.deterministic)
        return 0
    # the frames of every phase are rendered in worker processes, and the
    # vio-smoother phase runs in a worker of its own, warmed up from the
    # start; both pools are stopped on the way out, whatever happens
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(8, os.cpu_count() or 1))
    vio_pool = ctx.Pool(1, initializer=warm_vio_worker)
    mono_pool = ctx.Pool(1, initializer=warm_mono_worker)
    try:
        return check(pool, vio_pool, mono_pool)
    finally:
        for p in (pool, vio_pool, mono_pool):
            p.terminate()
            p.join()


def warm_vio_worker() -> None:
    """The vio-smoother phase's worker at its start: a process's first
    inertial initialization on the card sets up forward-mode
    differentiation and the card's linear-algebra libraries, which takes
    seconds (PERF.md, PR 11); an initialization and a smoother step on a
    small window are run here, while the parent runs the first phases."""
    import torch
    from vi_slam_tpu_torch.cameras.base import CameraParams
    from vi_slam_tpu_torch.imu import preintegration as pre
    from vi_slam_tpu_torch.optim import inertial_init, smoother

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    K = 4
    inertial_init.inertial_init(
        torch.eye(3, device=dev).expand(K, 3, 3), torch.zeros((K, 3), device=dev),
        pre.identity_preintegrated((K - 1,), device=dev),
        torch.ones((K - 1,), dtype=torch.bool, device=dev), optimize_scale=False)
    cam = CameraParams.make(FX, FY, CX, CY, bf=BF, device=dev)
    win = smoother.allocate_window(3, 4, device=dev)
    win = smoother.marginalize_oldest(cam, win, torch.zeros(3, device=dev), 1.0, 1.0)
    smoother.optimize_window(cam, win, torch.zeros(3, device=dev), 1.0, 1.0, iters=1)
    torch.cuda.synchronize()


def warm_mono_worker() -> None:
    """The mono phase's worker at its start: a process's first SVDs and
    whole-map BA on the card set up the card's linear-algebra libraries; a
    two-view solve on a small general scene and two BA iterations over it
    run here, while the parent runs the first phases. cuBLAS is set up for
    the deterministic mono-inertial run first."""
    os.environ.setdefault(*CUBLAS_DETERMINISTIC)
    import torch
    from vi_slam_tpu_torch.cameras.base import CameraParams
    from vi_slam_tpu_torch.geometry import two_view
    from vi_slam_tpu_torch.lie.se3 import SE3
    from vi_slam_tpu_torch.optim import local_ba
    from vi_slam_tpu_torch.utils.sampling import Sampler

    torch.set_num_threads(1)
    dev = torch.device("cuda")
    n = 300
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], 1)
    shift = np.array([0.5, 0.0, 0.1])

    def pixels(p):
        return torch.tensor(np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY],
                                     -1), dtype=torch.float32, device=dev)

    cam = CameraParams.make(FX, FY, CX, CY, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    uv1, uv2 = pixels(pts), pixels(pts + shift)
    two_view.reconstruct_two_view(cam, uv1, uv2, ones > 0, ones, Sampler(0, dev))
    poses = SE3.identity((2,), device=dev)
    poses.t[1] = torch.tensor(shift, dtype=torch.float32, device=dev)
    uvr = torch.stack([torch.cat([uv1, torch.zeros_like(uv1[:, :1])], -1),
                       torch.cat([uv2, torch.zeros_like(uv2[:, :1])], -1)], 1)
    prob = local_ba.BAProblem(
        poses=poses, fixed=torch.tensor([True, False], device=dev),
        points=torch.tensor(pts, dtype=torch.float32, device=dev), point_valid=ones > 0,
        obs_cam=torch.tensor([[0, 1]] * n, dtype=torch.int32, device=dev), obs_uvr=uvr,
        obs_stereo=torch.zeros((n, 2), dtype=torch.bool, device=dev),
        obs_sigma2=torch.ones((n, 2), device=dev), obs_mask=torch.ones((n, 2), dtype=torch.bool,
                                                                      device=dev))
    local_ba.bundle_adjust(cam, prob, iters=2, assembly="scatter")
    torch.cuda.synchronize()


def check(pool, vio_pool, mono_pool) -> int:
    """The phases in order; any failure raises."""
    import torch
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

    # the vio phase's world, rendered now so that the mono phase's worker
    # runs on its left images beside the slice and later phases
    t0 = time.perf_counter()
    vio_iw, vio_frames = vio_world(pool)
    # the vio worker's share of the mono-inertial oracle runs is queued when
    # the mono phase ends, so that the mono phase runs beside the earlier
    # phases alone, as before that phase existed
    mi_vio = []
    mono_pending = mono_pool.apply_async(
        mono_phase, (vio_iw, vio_frames), callback=lambda _: mi_vio.append(
            vio_pool.apply_async(mono_inertial_oracle_runs, (MI_VIO_WORKER_RUNS,))))
    mi_pending = mono_pool.apply_async(mono_inertial_phase,
                                       (vio_iw, vio_frames, MI_ORACLE_RUNS - MI_VIO_WORKER_RUNS))
    log_phase("render", t0, f"| tools/bench_vio.py's world, {VIO_FRAMES} stereo pairs at {W}x{H}"
              " (the vio, vio-smoother, mono and mono-inertial phases')")

    world = synthetic.make_billboard_world(n_frames=SLICE_WORLD_FRAMES, n_boards=4000, seed=11,
                                           speed=1.0)
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
    sl = phase_slice(world, pool)
    log_phase("slice", t0,
              f"| render {sl['render_s']:.1f} s | steady {sl['steady_fps']:.3f} frames/s"
              f" (all {sl['all_fps']:.3f}) | ATE {sl['ate_cm']:.4f} cm"
              f" (reference {REF_ATE_CM:.4f} cm at {REF_ATE_COMMIT[:7]}) | lost {sl['lost']}"
              f" | keyframes {sl['keyframes']} | map points {sl['map_points']}"
              f" | fast_resp_pref launches {sl['launches']} for {sl['frames']} frames")

    t0 = time.perf_counter()
    bench_world = full_world()
    bench_frames = render_frames(bench_world, FULL_FRAMES, pool)
    log_phase("render", t0, f"| bench.py's world, the first {FULL_FRAMES} of its"
              f" {N_FULL_FRAMES} stereo pairs at {W}x{H}")

    t0 = time.perf_counter()
    full = phase_full(bench_world, bench_frames)
    runs, host = full["runs"], full["host_ms"]
    per_run = ", ".join(
        f"{k} {host[k]:.1f} ms ({host[k] / runs[k]:.2f} ms a run)" for k in host)
    log_phase("full", t0,
              f"| render {full['render_s']:.1f} s | steady {full['steady_fps']:.3f} frames/s"
              f" (all {full['all_fps']:.3f}) | ATE {full['ate_cm']:.4f} cm (reference"
              f" {REF_FULL['ate_cm']:.4f} cm at {REF_FULL_COMMIT[:7]}, tolerance"
              f" {max(1.0, 0.2 * REF_FULL['ate_cm']):.4f} cm) | lost {full['lost']}"
              f" of {FULL_FRAMES} | keyframes {full['keyframes']} (reference"
              f" {REF_FULL['keyframes']}) | map points {full['map_points']} (reference"
              f" {REF_FULL['map_points']}) | culled keyframes {full['culled_keyframes']}"
              f" (reference {REF_FULL['culled_keyframes']}) | runs: mapping"
              f" {runs['mapping']}, local BA {runs['local_ba']}, maintenance"
              f" {runs['maintenance']}"
              f" | host: {per_run} | fast_resp_pref launches {full['launches']} for"
              f" {full['frames']} frames")

    t0 = time.perf_counter()
    lp = phase_loop_parts()

    def spans(res, name):
        dev = res["device_ms"].get(name)
        dev = "not measured" if dev is None else f"{dev:.2f} ms"
        return f"device span {dev}, host {res['host_ms'][name]:.2f} ms"

    log_phase("loop-parts", t0,
              f"| ring drift {lp['drift']:.4f} m | graph only: seam {lp['graph']['err'][-1]:.4f} m,"
              f" worst {lp['graph']['err'].max():.4f} m, reprojection"
              f" {lp['graph']['reproj']:.3f} px | with global BA: seam"
              f" {lp['gba']['err'][-1]:.4f} m, worst {lp['gba']['err'].max():.4f} m, reprojection"
              f" {lp['gba']['reproj']:.3f} px | correction (essential graph):"
              f" {spans(lp['gba'], 'correct')} | global BA: {spans(lp['gba'], 'gba')}")

    t0 = time.perf_counter()
    lo = phase_loop(pool)
    ref = REF_LOOP
    per_prog = ", ".join(
        f"{k} {lo['runs'][k]} runs (reference {ref['programs'].get(k, 0)}) {lo['host_ms'][k]:.1f} ms"
        for k in LOOP_PROGRAMS)
    merge_ms = (f"{lo['host_ms']['merge'] / lo['runs']['merge']:.1f} ms host a merge"
                if lo["runs"]["merge"] else "no merge")
    log_phase("loop", t0,
              f"| atlas on | forks {len(lo['fork_frames'])} at frames {lo['fork_frames']}"
              f" (reference {ref['fork_frames']}) | merges {len(lo['merge_frames'])} at frames"
              f" {lo['merge_frames']} (reference {ref['merge_frames']}), {merge_ms}"
              f" | loop re-anchorings at frames {lo['loop_frames']} (reference"
              f" {ref['loop_frames']})"
              f" | world and"
              f" vocabulary {lo['prep_s']:.1f} s | steady {lo['steady_fps']:.3f} frames/s"
              f" (all {lo['all_fps']:.3f}) | ATE {lo['ate_cm']:.4f} cm (reference"
              f" {ref['ate_cm']:.4f} cm at {REF_LOOP_COMMIT[:7]}) | lost {lo['lost']} of"
              f" {N_FULL_FRAMES} (reference {ref['lost']}) | relocalizations {lo['relocalized']}"
              f" (reference {ref['relocalizations']}) | loop queries {lo['queries']} (reference"
              f" {ref['loop_queries']}) | loops closed {lo['closed']} (reference"
              f" {ref['loops_closed']}) | keyframes {lo['keyframes']} (reference"
              f" {ref['keyframes']}) | host: {per_prog} | fast_resp_pref launches"
              f" {lo['launches']} for {lo['frames']} frames")

    t0 = time.perf_counter()
    ri = phase_ring(pool)
    ref = REF_RING

    def span(name):
        dev = ri["device_ms"].get(name)
        dev = "not measured" if dev is None else f"{dev:.2f} ms"
        return f"device span {dev}, host {ri['host_ms'][name]:.2f} ms"

    log_phase("ring", t0,
              f"| atlas off | {RING_FRAMES} frames, a {RING_RADIUS} m circle every {RING_PERIOD}"
              f" frames | world and vocabulary {ri['prep_s']:.1f} s | steady"
              f" {ri['steady_fps']:.3f} frames/s (all {ri['all_fps']:.3f}) | loop corrected at"
              f" frame {ri['loop_frames']} (reference {ref['loop_frames']}) | correction:"
              f" {span('correct')} | global BA: {span('gba')} | ATE {ri['ate_cm']:.4f} cm"
              f" (reference {ref['ate_cm']:.4f} cm) | lost {ri['lost']} (reference {ref['lost']})"
              f" | loop queries {ri['queries']} (reference {ref['loop_queries']}) | loops closed"
              f" {ri['closed']} (reference {ref['loops_closed']}) | keyframes {ri['keyframes']}"
              f" (reference {ref['keyframes']}) | runs {ri['runs']} (reference"
              f" {ref['programs']}) | fast_resp_pref launches {ri['launches']} for"
              f" {ri['frames']} frames")
    t0 = time.perf_counter()
    vi, vs_pending = phase_vio(vio_pool, vio_iw, vio_frames)

    def vio_line(r, ref):
        vec = lambda a: "[" + ", ".join(f"{x:.6f}" for x in a) + "]"
        prog = ", ".join(
            f"{k} {r['runs'][k]} runs (reference {ref['programs'].get(k, 0)}) host"
            f" {r['host_ms'][k]:.1f} ms ({r['host_ms'][k] / max(r['runs'][k], 1):.2f} ms a run)"
            for k in r["runs"])
        return (f"steady {r['steady_fps']:.3f} frames/s | ATE {r['ate_cm']:.4f} cm (reference"
                f" {ref['ate_cm']:.4f} cm, tolerance {max(1.0, 0.2 * ref['ate_cm']):.4f} cm)"
                f" | lost {r['lost']} (reference {ref['lost']}) | keyframes {r['keyframes']}"
                f" (reference {ref['keyframes']}) | init stage {r['init_stage']} at frames"
                f" {r['init_stage_frames']} (reference {ref['init_stage']} at"
                f" {ref['init_stage_frames']}) | gravity {r['gravity_deg']:.4f} deg from the"
                f" truth (reference {ref['gravity_angle_deg']:.4f}) | gyro bias {vec(r['bg'])}"
                f" (reference {vec(ref['bias_gyro'])}, truth {vec(ref['bias_gyro_true'])})"
                f" | accel bias {vec(r['ba'])} (reference {vec(ref['bias_acc'])}, truth"
                f" {vec(ref['bias_acc_true'])}) | {prog} | fast_resp_pref launches"
                f" {r['launches']} for {r['frames']} frames")

    log_phase("vio", t0,
              f"| tools/bench_vio.py's configuration, {VIO_FRAMES} frames, 200 Hz IMU"
              f" | {vio_line(vi, REF_VIO)}")
    t0 = time.perf_counter()
    vs = vs_pending.get(timeout=900)
    runs, host = vs["runs"], vs["host_ms"]
    log_phase("vio-smoother", t0,
              f"(the wait after the vio phase) | tools/bench_vio.py --smoother, {VIO_FRAMES}"
              f" frames, in a worker process beside the vio phase: {vs['seconds']:.2f} s"
              f" | smoother steps {runs['smoother']} for {runs['track_vio']} inertial tracks,"
              f" host {host['smoother'] / max(runs['smoother'], 1):.2f} ms a step | slides"
              f" {runs['smoother_slide']}, each one eigh wait on the card, host"
              f" {host['smoother_slide'] / max(runs['smoother_slide'], 1):.2f} ms a slide"
              f" | reference at {REF_VIO_SMOOTHER_COMMIT[:7]} | {vio_line(vs, REF_VIO_SMOOTHER)}")
    t0 = time.perf_counter()
    mo = mono_pending.get(timeout=900)
    ref = REF_MONO
    runs, host, dev_ms = mo["runs"], mo["host_ms"], mo["device_ms"]
    attempts = max(runs.get("init_two_view", 0), 1)
    kf_ms = host.get("kf_triangulate", 0.0) / max(runs.get("kf_triangulate", 0), 1)

    def dev_span(k):
        v = dev_ms.get(k)
        return "not measured" if v is None else f"{v:.2f} ms"

    log_phase("mono", t0,
              f"(the wait after the vio-smoother phase) | MonoVO.process_mono over the left images"
              f" of tools/bench_vio.py's world, {MONO_FRAMES} frames, in a worker process beside"
              f" the slice and later phases: {mo['phase_s']:.2f} s for the five runs, the unperturbed one"
              f" {mo['seconds']:.2f} s | init at frame {mo['init_frame']} (reference"
              f" {ref['init_frame']}), used_homography {mo['init'][0]} (reference"
              f" {ref['used_homography']}), n_good {mo['init'][1]} (reference {ref['n_good']})"
              f" | initialization host ms: two-view {host.get('init_two_view', 0.0):.1f} over"
              f" {runs.get('init_two_view', 0)} attempts (device span"
              f" {dev_span('init_two_view')}), map and whole-map BA {host.get('init_map', 0.0):.1f}"
              f" (device span {dev_span('init_map')}) | SVD waits: {mo['svd_calls']} calls,"
              f" {mo['svd_ms']:.1f} ms host inside them ({mo['svd_calls'] / attempts:.1f} calls a"
              f" two-view attempt) | steady {mo['steady_fps']:.3f} frames/s (from frame"
              f" {MONO_STEADY_FROM}) | scale-aligned ATE {mo['ate_cm']:.4f} cm (reference"
              f" {ref['ate_cm']:.4f} cm at {REF_MONO_COMMIT[:7]}); of the unperturbed and seeds"
              f" {MONO_SEEDS} runs {fmt_list(mo['port_ates'])} cm (reference"
              f" {fmt_list(mo['ref_ates'])}), mean {mo['port_mean']:.4f} cm, at least"
              f" {MONO_ATE_FLOOR_CM} cm and at most the reference's {mo['ref_mean']:.4f} cm +"
              f" {mo['tol_cm']:.4f} cm | Horn scale"
              f" {mo['horn_scale']:.4f} (reference {ref['horn_scale']:.4f}), the initial points'"
              f" median depth after the BA {mo['init_depth_after_ba']} (rescaled to 1)"
              f" | lost after init {mo['lost']}, of the five runs {mo['lost_all']} (reference"
              f" {ref['lost_after_init']} in each) | keyframes {mo['keyframes']} (reference"
              f" {ref['keyframes']}), {mo['created']} from _create_keyframe, {mo['grown']} of them"
              f" with new points (reference {ref['created_keyframes']}) | map points"
              f" {mo['map_points']} (reference {ref['map_points']}) | host ms a keyframe's"
              f" triangulation {kf_ms:.2f}"
              f" | runs {runs} (reference {ref['programs']}) | fast_resp_pref launches"
              f" {mo['launches']} for {mo['frames']} frames")

    t0 = time.perf_counter()
    mi = mi_pending.get(timeout=900)
    mi["oracle"] = mi_vio[0].get(timeout=900) + mi["oracle"]
    log_phase("mono-inertial", t0,
              f"(the wait after the mono phase) | {mono_inertial_line(mi, smi)}")
    check_mono_inertial_runs(mi["oracle"])

    t0 = time.perf_counter()
    kl = phase_klt(bench_world, bench_frames, pool)
    ref = REF_KLT
    host = ", ".join(f"{k} {v:.2f}" for k, v in kl["host_ms"].items())
    k7 = kl["k7"]
    log_phase("klt", t0,
              f"| bench.py --frontend klt, {KLT_FRAMES} frames | steady"
              f" {kl['steady_fps']:.3f} frames/s (all {kl['all_fps']:.3f}; {len(KLT_SEEDS)}"
              f" perturbed runs in worker processes meanwhile) | ATE {kl['ate_cm']:.4f} cm"
              f" (reference {ref['ate_cm']:.4f} cm at {REF_KLT_COMMIT[:7]}) | ATE of the"
              f" unperturbed and seeds {KLT_SEEDS} runs {fmt_list(kl['port_ates'])} cm (reference"
              f" {fmt_list(kl['ref_ates'])}), mean {kl['port_mean']:.4f} cm (reference"
              f" {kl['ref_mean']:.4f} cm, tolerance {kl['tol_cm']:.4f} cm), keyframes of the"
              f" perturbed runs {kl['variant_keyframes']} | lost"
              f" {kl['lost']} (reference {ref['lost']}) | keyframes {kl['keyframes']} (reference"
              f" {ref['keyframes']}), from the KLT keyframe branch at frames {kl['klt_kf_frames']}"
              f" (reference {ref['klt_keyframe_frames']}) | map points {kl['map_points']}"
              f" (reference {ref['map_points']}) | rescues at frames {kl['rescue_frames']}"
              f" (reference {ref['rescue_frames']}) | relocalizations {kl['relocalized']}"
              f" (reference {ref['relocalizations']}) | runs {kl['runs']} (reference"
              f" {ref['programs']}) | LK calls a frame {kl['lk_per_frame']:.3f} | host ms a KLT"
              f" frame: {host} | K7 track_pyramidal, {k7['tracks']} live tracks of"
              f" {k7['capacity']}: host {k7['host_ms']:.3f} ms a call, device (its"
              f" {k7['kernels']:.0f} kernels) {k7['device_ms']:.3f} ms a call,"
              f" {k7['call_ms']:.3f} ms a call to its end"
              f" | fast_resp_pref launches {kl['launches']} for {kl['extractions']} extractions"
              f" in {kl['frames']} frames")

    t0 = time.perf_counter()
    rg = phase_rgbd(bench_world, bench_frames)
    ref = REF_RGBD
    log_phase("rgbd", t0,
              f"| process_rgbd, bench.py's configuration, {RGBD_FRAMES} frames | depth maps"
              f" {rg['prep_s']:.1f} s | steady {rg['steady_fps']:.3f} frames/s | ATE"
              f" {rg['ate_cm']:.4f} cm (reference {ref['ate_cm']:.4f} cm, tolerance"
              f" {max(1.0, 0.2 * ref['ate_cm']):.4f} cm) | lost {rg['lost']} (reference"
              f" {ref['lost']}) | keyframes {rg['keyframes']} (reference {ref['keyframes']}) | map"
              f" points {rg['map_points']} (reference {ref['map_points']}) | runs {rg['runs']}"
              f" | fast_resp_pref launches {rg['launches']} for {rg['frames']} frames")
    print(f"total: {time.perf_counter() - t_start:.2f} s", flush=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fast_resp_pref",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": full["launches"],
        "launches_by_phase": {"full": full["launches"], "vio-smoother": vs["launches"],
                              "klt": kl["launches"], "rgbd": rg["launches"],
                              "mono": mo["launches"],
                              "mono-inertial": mi["image"]["launches"]},
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
    sys.exit(main(sys.argv[1:]))
