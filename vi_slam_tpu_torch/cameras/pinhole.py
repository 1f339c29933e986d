"""Pinhole camera — a PyTorch copy of the JAX package's
`cameras/pinhole.py`: the functions the tracking path reaches through the
reference's `cameras/dispatch.py`. The port has one camera model, so its
callers use this module directly; the dispatch comes back with the
fisheye model. All functions are batched over leading dims; keypoints are
already undistorted, so no distortion is applied."""

from __future__ import annotations

import torch

from vi_slam_tpu_torch.cameras.base import CameraParams


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: CameraParams, xyz: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    inv_z = _inv_z(xyz[..., 2])
    u = cam.fx * xyz[..., 0] * inv_z + cam.cx
    v = cam.fy * xyz[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_jac(cam: CameraParams, xyz: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(xyz) (..., 2, 3)."""
    x, y = xyz[..., 0], xyz[..., 1]
    inv_z = _inv_z(xyz[..., 2])
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def unproject(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth bearing (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def stereo_project(cam: CameraParams, xyz: torch.Tensor) -> torch.Tensor:
    """Project to (u_L, v_L, u_R)."""
    uv = project(cam, xyz)
    ur = uv[..., 0] - cam.bf * _inv_z(xyz[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def stereo_project_jac(cam: CameraParams, xyz: torch.Tensor) -> torch.Tensor:
    """d(u_L, v_L, u_R)/d(xyz) (..., 3, 3)."""
    J2 = project_jac(cam, xyz)
    x = xyz[..., 0]
    inv_z = _inv_z(xyz[..., 2])
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(x)
    row_ur = J2[..., 0, :] + torch.stack([zeros, zeros, cam.bf * inv_z2], dim=-1)
    return torch.cat([J2, row_ur[..., None, :]], dim=-2)
