"""Wrapper of the FAST-9 CUDA kernel (`csrc/fast_resp_pref.cu`), the port
of the TPU kernel `vi_slam_tpu/ops/fast_pallas.py::fast_resp_pref`.

`resp_pref` launches the kernel for a CUDA image and takes the plain
PyTorch version (`ops/fast.py::resp_pref`) only for an image on the CPU.
There is no fallback from CUDA to the plain version: a CUDA image that
the kernel does not take raises.
"""

from __future__ import annotations

import torch

from vi_slam_tpu_torch.ops import fast as fast_ops

# Kernel launches since the last `reset_launches()`; only the launch below
# counts.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def resp_pref_cuda(image: torch.Tensor, threshold: float, min_threshold: float) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; (H, W) float32,
    contiguous, on a CUDA device."""
    global launches
    if image.device.type != "cuda":
        raise ValueError(f"fast_resp_pref kernel needs a CUDA tensor, got {image.device}")
    if image.dtype != torch.float32:
        raise TypeError(f"fast_resp_pref kernel needs float32, got {image.dtype}")
    if image.dim() != 2 or image.shape[0] < 1 or image.shape[1] < 1:
        raise ValueError(f"fast_resp_pref kernel needs a 2-D image, got {tuple(image.shape)}")
    if not image.is_contiguous():
        raise ValueError("fast_resp_pref kernel needs a contiguous image")
    from vi_slam_tpu_torch.kernels.build import load_library

    lib = load_library()
    h, w = image.shape
    out = torch.empty_like(image)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = lib.fast_resp_pref_launch(
            image.data_ptr(), out.data_ptr(), int(h), int(w),
            float(min_threshold), float(threshold), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fast_resp_pref launch failed: cudaError {rc}")
    launches += 1
    return out


def resp_pref(image: torch.Tensor, threshold: float, min_threshold: float) -> torch.Tensor:
    """FAST-9 + NMS + high-threshold preference map of one pyramid level:
    the CUDA kernel for a CUDA image, the plain version for a CPU image."""
    if image.device.type == "cpu":
        return fast_ops.resp_pref(image, threshold, min_threshold)
    return resp_pref_cuda(image, threshold, min_threshold)
