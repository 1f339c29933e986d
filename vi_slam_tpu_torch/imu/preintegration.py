"""IMU preintegration on the manifold (Forster et al.) — a PyTorch copy of
the JAX package's `imu/preintegration.py`.

`integrate` folds a padded batch of samples into the deltas (dR, dV, dP),
their 15x15 covariance [phi, v, p, bg, ba] and the bias Jacobians; samples
with dt = 0 are skipped. The per-sample quantities that do not depend on
the running state (bias-corrected measurements, the rotation increments
and their right Jacobians) are computed for the whole batch at once; the
rest is a loop over the time axis, `n_steps` long when the caller knows
that every later row is padding. `compose` chains two segments in closed
form. Every function takes leading batch dimensions: a keyframe chain is
one `Preintegrated` with a leading (K,) dimension.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vi_slam_tpu_torch.lie import so3

GRAVITY = 9.81


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (R @ x[..., None])[..., 0]


class ImuCalib(NamedTuple):
    """Noise and random-walk variances per sample: sigma^2 * freq for the
    noise, sigma^2 / freq for the walk."""

    noise_gyro2: float
    noise_acc2: float
    walk_gyro2: float
    walk_acc2: float

    @staticmethod
    def make(noise_gyro, noise_acc, walk_gyro, walk_acc, freq) -> "ImuCalib":
        f32 = lambda v: float(np.float32(v))  # the reference keeps them as float32
        return ImuCalib(f32(noise_gyro ** 2 * freq), f32(noise_acc ** 2 * freq),
                        f32(walk_gyro ** 2 / freq), f32(walk_acc ** 2 / freq))


class Preintegrated(NamedTuple):
    """Accumulated deltas between two frames or keyframes (any leading
    batch dimensions)."""

    dR: torch.Tensor  # (..., 3, 3)
    dV: torch.Tensor  # (..., 3)
    dP: torch.Tensor  # (..., 3)
    C: torch.Tensor  # (..., 15, 15) covariance of [phi, v, p, bg, ba]
    JRg: torch.Tensor  # (..., 3, 3) d dR / d bg
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    dt: torch.Tensor  # (...,) total time
    bias_gyro: torch.Tensor  # (..., 3) linearization bias
    bias_acc: torch.Tensor  # (..., 3)


def map_preint(fn: Callable, *ps: Preintegrated) -> Preintegrated:
    """Apply `fn` field by field across one or more Preintegrated."""
    return Preintegrated(*(fn(*fields) for fields in zip(*ps)))


def identity_preintegrated(batch_shape=(), dtype=torch.float32, device="cpu") -> Preintegrated:
    z3 = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    z33 = torch.zeros((*batch_shape, 3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dR=torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone(),
        dV=z3, dP=z3.clone(),
        C=torch.zeros((*batch_shape, 15, 15), dtype=dtype, device=device),
        JRg=z33, JVg=z33.clone(), JVa=z33.clone(), JPg=z33.clone(), JPa=z33.clone(),
        dt=torch.zeros(batch_shape, dtype=dtype, device=device),
        bias_gyro=z3.clone(), bias_acc=z3.clone(),
    )


def preintegrated_from_numpy(d, device="cuda") -> Preintegrated:
    """The reference's Preintegrated (a NamedTuple of arrays, or a dict
    by field name) -> the port's on `device`."""
    from vi_slam_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    get = d.get if isinstance(d, dict) else (lambda k: getattr(d, k))
    return Preintegrated(*(torch.from_numpy(np.array(get(k), np.float32)).to(device)
                           for k in Preintegrated._fields))


def _to_numpy(p: Preintegrated) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in zip(Preintegrated._fields, p)}


def integrate(calib: ImuCalib, acc: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
              bias_gyro: torch.Tensor, bias_acc: torch.Tensor,
              n_steps: Optional[int] = None) -> Preintegrated:
    """Integrate a padded (T,) batch of samples (acc (T, 3), gyro (T, 3),
    dts (T,), rows with dt = 0 skipped) into deltas, covariance and bias
    Jacobians, linearized at the given biases. `n_steps` (default T)
    bounds the loop: rows past it must be padding."""
    dtype = acc.dtype
    dev = acc.device
    T = acc.shape[0] if n_steps is None else min(int(n_steps), acc.shape[0])
    bg = bias_gyro.to(dtype)
    ba = bias_acc.to(dtype)
    gyro = gyro.to(dtype)
    dts = dts.to(dtype)
    # the running state never changes the biases: the corrected
    # measurements, rotation increments and right Jacobians are per sample
    a_c = acc[:T] - ba
    wdt = (gyro[:T] - bg) * dts[:T, None]
    dRi = so3.exp(wdt)
    Jr = so3.right_jacobian(wdt)
    a_hat = so3.hat(a_c)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    nga = torch.tensor([calib.noise_gyro2] * 3 + [calib.noise_acc2] * 3, dtype=dtype, device=dev)
    walk = torch.tensor([calib.walk_gyro2] * 3 + [calib.walk_acc2] * 3, dtype=dtype, device=dev)

    dR = I3.clone()
    dV = torch.zeros(3, dtype=dtype, device=dev)
    dP = torch.zeros(3, dtype=dtype, device=dev)
    C9 = torch.zeros((9, 9), dtype=dtype, device=dev)
    Cw = torch.zeros((6, 6), dtype=dtype, device=dev)
    JRg, JVg, JVa, JPg, JPa = (torch.zeros((3, 3), dtype=dtype, device=dev) for _ in range(5))
    tot = torch.zeros((), dtype=dtype, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    for k in range(T):
        dt = dts[k]
        active = dt > 0
        dt2 = dt * dt
        Ra = _mv(dR, a_c[k])
        dP_n = dP + dV * dt + 0.5 * Ra * dt2
        dV_n = dV + Ra * dt
        Rah = dR @ a_hat[k]
        A = torch.cat([
            torch.cat([dRi[k].T, Z3, Z3], 1),
            torch.cat([-Rah * dt, I3, Z3], 1),
            torch.cat([-0.5 * Rah * dt2, I3 * dt, I3], 1),
        ], 0)
        B = torch.cat([
            torch.cat([Jr[k] * dt, Z3], 1),
            torch.cat([Z3, dR * dt], 1),
            torch.cat([Z3, 0.5 * dR * dt2], 1),
        ], 0)
        C9_n = A @ C9 @ A.T + (B * nga) @ B.T
        Cw_n = Cw + torch.diag(walk * dt)
        RahJ = Rah @ JRg
        JPa_n = JPa + JVa * dt - 0.5 * dR * dt2
        JPg_n = JPg + JVg * dt - 0.5 * RahJ * dt2
        JVa_n = JVa - dR * dt
        JVg_n = JVg - RahJ * dt
        JRg_n = dRi[k].T @ JRg - Jr[k] * dt
        dR_n = so3.normalize(dR @ dRi[k])
        sel = lambda n, o: torch.where(active, n, o)
        dR, dV, dP, C9, Cw = sel(dR_n, dR), sel(dV_n, dV), sel(dP_n, dP), sel(C9_n, C9), sel(Cw_n, Cw)
        JRg, JVg, JVa, JPg, JPa = (sel(JRg_n, JRg), sel(JVg_n, JVg), sel(JVa_n, JVa),
                                   sel(JPg_n, JPg), sel(JPa_n, JPa))
        tot = sel(tot + dt, tot)
    C = torch.zeros((15, 15), dtype=dtype, device=dev)
    C[:9, :9] = C9
    C[9:, 9:] = Cw
    return Preintegrated(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         dt=tot, bias_gyro=bg.clone(), bias_acc=ba.clone())


def _block3(rows) -> torch.Tensor:
    return torch.cat([torch.cat(r, -1) for r in rows], -2)


def compose(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Chain two segments (1 then 2) that share a linearization bias, in
    closed form: deltas, bias Jacobians and covariance."""
    dt2 = p2.dt[..., None]
    dt2m = p2.dt[..., None, None]
    dR = so3.normalize(p1.dR @ p2.dR)
    dV = p1.dV + _mv(p1.dR, p2.dV)
    dP = p1.dP + p1.dV * dt2 + _mv(p1.dR, p2.dP)
    R2t = p2.dR.transpose(-1, -2)
    JRg = R2t @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg - p1.dR @ so3.hat(p2.dV) @ p1.JRg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * dt2m + p1.dR @ p2.JPg - p1.dR @ so3.hat(p2.dP) @ p1.JRg
    JPa = p1.JPa + p1.JVa * dt2m + p1.dR @ p2.JPa
    I3 = torch.eye(3, dtype=dR.dtype, device=dR.device).expand(dR.shape)
    Z3 = torch.zeros_like(dR)
    A1 = _block3([[R2t, Z3, Z3],
                  [-p1.dR @ so3.hat(p2.dV), I3, Z3],
                  [-p1.dR @ so3.hat(p2.dP), I3 * dt2m, I3]])
    A2 = _block3([[I3, Z3, Z3], [Z3, p1.dR, Z3], [Z3, Z3, p1.dR]])
    C9 = (A1 @ p1.C[..., :9, :9] @ A1.transpose(-1, -2)
          + A2 @ p2.C[..., :9, :9] @ A2.transpose(-1, -2))
    C = torch.zeros_like(p1.C)
    C[..., :9, :9] = C9
    C[..., 9:, 9:] = p1.C[..., 9:, 9:] + p2.C[..., 9:, 9:]
    return Preintegrated(dR=dR, dV=dV, dP=dP, C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         dt=p1.dt + p2.dt, bias_gyro=p1.bias_gyro, bias_acc=p1.bias_acc)


def delta_with_bias(p: Preintegrated, bias_gyro: torch.Tensor, bias_acc: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order bias-corrected deltas."""
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    dR = p.dR @ so3.exp(_mv(p.JRg, dbg))
    dV = p.dV + _mv(p.JVg, dbg) + _mv(p.JVa, dba)
    dP = p.dP + _mv(p.JPg, dbg) + _mv(p.JPa, dba)
    return dR, dV, dP


def predict_state(p: Preintegrated, R1, v1, p1, bias_gyro, bias_acc, gravity: float = GRAVITY):
    """Propagate a world-frame body state (Rwb, v_w, p_w) through the
    deltas, with gravity (0, 0, -gravity)."""
    g_w = torch.tensor([0.0, 0.0, -gravity], dtype=R1.dtype, device=R1.device)
    dR, dV, dP = delta_with_bias(p, bias_gyro, bias_acc)
    dt = p.dt[..., None]
    return (R1 @ dR, v1 + g_w * dt + _mv(R1, dV),
            p1 + v1 * dt + 0.5 * g_w * dt * dt + _mv(R1, dP))


def inertial_residual(p: Preintegrated, R1, v1, p1, R2, v2, p2, bias_gyro, bias_acc,
                      gravity_vec) -> torch.Tensor:
    """The 9-dim residual [e_R, e_v, e_p] of a segment between two body
    states."""
    dR, dV, dP = delta_with_bias(p, bias_gyro, bias_acc)
    dt = p.dt[..., None]
    R1t = R1.transpose(-1, -2)
    eR = so3.log(dR.transpose(-1, -2) @ R1t @ R2)
    ev = _mv(R1t, v2 - v1 - gravity_vec * dt) - dV
    ep = _mv(R1t, p2 - p1 - v1 * dt - 0.5 * gravity_vec * dt * dt) - dP
    return torch.cat([eR, ev, ep], dim=-1)


def information(p: Preintegrated) -> torch.Tensor:
    """9x9 information of the residual: the inverse of the symmetrized
    covariance."""
    C = p.C[..., :9, :9]
    eye = torch.eye(9, dtype=C.dtype, device=C.device)
    C = 0.5 * (C + C.transpose(-1, -2)) + 1e-12 * eye
    return torch.linalg.inv_ex(C)[0]
