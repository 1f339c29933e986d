"""vi_slam_tpu_torch — the PyTorch and CUDA port of `vi_slam_tpu`.

The port runs on an NVIDIA Hopper GPU. Plain tensor code is PyTorch; the
JAX package's Pallas kernel (FAST-9 + NMS, `ops/fast_pallas.py`) is a
CUDA kernel written by hand (`csrc/fast_resp_pref.cu`), built with `nvcc`
into a shared library at first use and called through `ctypes`.

This package imports neither JAX nor `vi_slam_tpu`. Entry points take a
`device` argument, default "cuda", and raise when CUDA is absent; the
tests pass `device="cpu"`, where each kernel's plain PyTorch version runs.

The port covers the main path: `make_stereo_vo` ->
`StereoVO.process_stereo`, the stereo tracking frame loop (slice 1) and
the keyframe-rate mapping pass, local BA and map maintenance (slice 2).
"""

__version__ = "0.1.0"
