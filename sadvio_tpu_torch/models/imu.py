"""On-manifold IMU preintegration (Forster style) on tensors.

Port of the main-path subset of ``sadvio_tpu/models/imu.py``.  The JAX
package integrates with a masked ``lax.scan``; here the per-sample terms
that do not depend on the running state (bias-corrected rates, the
incremental rotations and their right Jacobians) are computed for the whole
buffer at once and the recursion is a Python loop.  Samples with dt == 0
stay strict no-ops, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sadvio_tpu_torch.utils import geometry as geo
from sadvio_tpu_torch.utils.struct import Struct, select, tree_map

GRAVITY = 9.81


@dataclass
class ImuParams(Struct):
    """Continuous-time noise densities (EuRoC yaml convention), as floats."""

    acc_noise: float
    gyr_noise: float
    acc_walk: float
    gyr_walk: float
    rate_hz: float = 200.0

    @classmethod
    def euroc(cls):
        return cls(acc_noise=2.0e-3, gyr_noise=1.7e-4, acc_walk=3.0e-3,
                   gyr_walk=2.0e-5, rate_hz=200.0)


@dataclass
class Preintegration(Struct):
    """Preintegrated deltas between two keyframes (optionally batched)."""

    dR: torch.Tensor  # (...,3,3)
    dv: torch.Tensor  # (...,3)
    dp: torch.Tensor  # (...,3)
    cov: torch.Tensor  # (...,9,9) over (dphi, dv, dp)
    J_dR_bg: torch.Tensor
    J_dv_ba: torch.Tensor
    J_dv_bg: torch.Tensor
    J_dp_ba: torch.Tensor
    J_dp_bg: torch.Tensor
    dt: torch.Tensor  # (...)
    ba_lin: torch.Tensor  # (...,3)
    bg_lin: torch.Tensor  # (...,3)

    @classmethod
    def identity(cls, dtype=torch.float32, device=None, batch=()):
        eye = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3).clone()
        z3 = torch.zeros((*batch, 3, 3), dtype=dtype, device=device)
        z = lambda *s: torch.zeros((*batch, *s), dtype=dtype, device=device)
        return cls(dR=eye, dv=z(3), dp=z(3), cov=z(9, 9),
                   J_dR_bg=z3, J_dv_ba=z3.clone(), J_dv_bg=z3.clone(),
                   J_dp_ba=z3.clone(), J_dp_bg=z3.clone(),
                   dt=z(), ba_lin=z(3), bg_lin=z(3))

    def __getitem__(self, k):
        """Element k of a batched preintegration."""
        return tree_map(lambda x: x[k], self)


def preintegrate(acc, gyr, dt, ba, bg, params: ImuParams, init: Preintegration | None = None):
    """Integrate a buffer of IMU samples; padding samples must have dt == 0.

    acc, gyr: (N,3); dt: (N,); ba, bg: (3,) bias linearization point.
    """
    dtype, dev = acc.dtype, acc.device
    if init is None:
        init = Preintegration.identity(dtype, dev)
    s = init.replace(ba_lin=ba, bg_lin=bg)
    active = dt > 0.0
    hs = torch.where(active, dt, torch.ones_like(dt))
    h_all = torch.where(active, dt, torch.zeros_like(dt))
    a_c_all = acc - ba
    wdt = (gyr - bg) * h_all[:, None]
    dR_inc_all = geo.so3_exp(wdt)
    Jr_all = geo.so3_right_jacobian(wdt)
    qg_all = params.gyr_noise ** 2 / hs
    qa_all = params.acc_noise ** 2 / hs
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    for i in range(acc.shape[0]):
        h = h_all[i]
        a_c = a_c_all[i]
        dR_inc, Jr = dR_inc_all[i], Jr_all[i]
        Ra = s.dR @ geo.skew(a_c)
        A = torch.cat([
            torch.cat([dR_inc.T, z3, z3], 1),
            torch.cat([-Ra * h, eye3, z3], 1),
            torch.cat([-0.5 * Ra * h * h, eye3 * h, eye3], 1),
        ], 0)
        B = torch.cat([
            torch.cat([Jr * h, z3], 1),
            torch.cat([z3, s.dR * h], 1),
            torch.cat([z3, 0.5 * s.dR * h * h], 1),
        ], 0)
        q = torch.cat([qg_all[i].expand(3), qa_all[i].expand(3)])
        cov = A @ s.cov @ A.T + (B * q) @ B.T
        new = s.replace(
            dR=s.dR @ dR_inc,
            dv=s.dv + geo.mv(s.dR, a_c) * h,
            dp=s.dp + s.dv * h + 0.5 * geo.mv(s.dR, a_c) * h * h,
            cov=cov,
            J_dR_bg=dR_inc.T @ s.J_dR_bg - Jr * h,
            J_dv_ba=s.J_dv_ba - s.dR * h,
            J_dv_bg=s.J_dv_bg - Ra @ s.J_dR_bg * h,
            J_dp_ba=s.J_dp_ba + s.J_dv_ba * h - 0.5 * s.dR * h * h,
            J_dp_bg=s.J_dp_bg + s.J_dv_bg * h - 0.5 * Ra @ s.J_dR_bg * h * h,
            dt=s.dt + h,
        )
        s = select(active[i], new, s)
    return s


def bias_corrected_deltas(pre: Preintegration, ba, bg):
    """First-order bias correction; returns (dR', dv', dp') at (ba, bg)."""
    dba = ba - pre.ba_lin
    dbg = bg - pre.bg_lin
    dR = pre.dR @ geo.so3_exp(geo.mv(pre.J_dR_bg, dbg))
    dv = pre.dv + geo.mv(pre.J_dv_ba, dba) + geo.mv(pre.J_dv_bg, dbg)
    dp = pre.dp + geo.mv(pre.J_dp_ba, dba) + geo.mv(pre.J_dp_bg, dbg)
    return dR, dv, dp


def _gravity(like):
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=like.dtype, device=like.device)


def predict(pre: Preintegration, R_i, p_i, v_i, ba=None, bg=None, g=None):
    """IMU-only state prediction."""
    if g is None:
        g = _gravity(p_i)
    if ba is not None:
        dR, dv, dp = bias_corrected_deltas(pre, ba, bg)
    else:
        dR, dv, dp = pre.dR, pre.dv, pre.dp
    dt = pre.dt[..., None]
    R_j = R_i @ dR
    v_j = v_i + g * dt + geo.mv(R_i, dv)
    p_j = p_i + v_i * dt + 0.5 * g * dt * dt + geo.mv(R_i, dp)
    return R_j, p_j, v_j


def residual(pre: Preintegration, R_i, p_i, v_i, ba_i, bg_i, R_j, p_j, v_j, g=None):
    """9-dim preintegration residual (r_dR, r_dv, r_dp), batched over pairs."""
    if g is None:
        g = _gravity(p_i)
    dR, dv, dp = bias_corrected_deltas(pre, ba_i, bg_i)
    dt = pre.dt[..., None]
    RiT = R_i.transpose(-1, -2)
    r_R = geo.so3_log(dR.transpose(-1, -2) @ (RiT @ R_j))
    r_v = geo.mv(RiT, v_j - v_i - g * dt) - dv
    r_p = geo.mv(RiT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p], -1)


def sqrt_info(pre: Preintegration, eps_rel: float = 1e-5):
    """Whitening W with W cov W^T = I, from a diagonally equilibrated
    Cholesky factor (batched over leading dims)."""
    cov = pre.cov
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-16))
    Cn = cov / (d[..., :, None] * d[..., None, :])
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    Cn = Cn + eye * eps_rel
    L, info = torch.linalg.cholesky_ex(Cn)
    # a failed factorization yields NaN, as jnp.linalg.cholesky does
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    Ln_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Ln_inv / d[..., None, :]
