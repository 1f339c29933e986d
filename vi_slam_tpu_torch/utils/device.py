"""Device set-up for the port's entry points.

There is no fallback: asking for CUDA on a machine without it raises. The
float32 matrix products and convolutions run in full float32 (TF32 off),
as the JAX package's solver paths do (`utils/precision.py`): the rBRIEF
bits threshold an f32 product at zero, and the pose solver needs the
digits.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device after checking it exists, with
    TF32 turned off for matmuls and cuDNN."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
