"""Residuals of the visual-inertial factor graph, whitened, batched over
leading dims (port of the main-path subset of
``sadvio_tpu/backend/factors.py``).  Reprojection Jacobians are
hand-derived; the small factors are linearized by ``torch.func.jacfwd`` in
the solvers."""

from __future__ import annotations

import torch

from sadvio_tpu_torch.models import cameras
from sadvio_tpu_torch.models import imu as imu_mod
from sadvio_tpu_torch.utils import geometry as geo


def huber_weight(r_norm, delta: float = 1.345):
    """IRLS weight of the Huber loss on a whitened residual norm."""
    return torch.clamp(delta / torch.clamp(r_norm, min=1e-12), max=1.0)


def reprojection_residual(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w, uv_meas, sigma_px):
    """Whitened pixel residual r = (meas - h(x)) / sigma and its Jacobians."""
    uv, J_pose, J_lmk, valid = cameras.project_world_jac(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w)
    inv_s = 1.0 / sigma_px
    return (uv_meas - uv) * inv_s, -J_pose * inv_s, -J_lmk * inv_s, valid


def imu_factor_residual(pre, W, R_i, p_i, v_i, ba_i, bg_i, R_j, p_j, v_j, g=None):
    """Whitened 9-dof preintegration residual."""
    return geo.mv(W, imu_mod.residual(pre, R_i, p_i, v_i, ba_i, bg_i, R_j, p_j, v_j, g))


def bias_rw_residual(ba_i, bg_i, ba_j, bg_j, dt, acc_walk, gyr_walk):
    """Bias random-walk residual."""
    sdt = torch.sqrt(torch.clamp(dt, min=1e-6))[..., None]
    return torch.cat([(ba_j - ba_i) / (acc_walk * sdt), (bg_j - bg_i) / (gyr_walk * sdt)], -1)


def state_prior_residual(R, t, v, ba, bg, R0, t0, v0, ba0, bg0, sqrt_info15):
    """15-dof VIO state prior on the retraction chart."""
    dx = geo.pose_local(R0, t0, R, t)
    return geo.mv(sqrt_info15, torch.cat([dx, v - v0, ba - ba0, bg - bg0], -1))


def lmk_prior_residual(p, p0, sqrt_info):
    return geo.mv(sqrt_info, p - p0)


def lmk_lmk_residual(p_a, p_b, d_ab, sqrt_info):
    return geo.mv(sqrt_info, (p_a - p_b) - d_ab)


def pose_lmk_residual(R, t, p_w, p_f0, sqrt_info):
    """Landmark prior in frame coordinates: r = W (R^T (p_w - t) - p_f0)."""
    return geo.mv(sqrt_info, geo.mv(R.transpose(-1, -2), p_w - t) - p_f0)


def relative_pose_residual(R_i, t_i, R_j, t_j, dx_meas, sqrt_info):
    """Relative 6-dof pose factor: r = W (local(T_i^-1 T_j) - dx_meas), with
    dx_meas the expected retraction from frame i to frame j."""
    Rij, tij = geo.pose_compose(*geo.pose_inverse(R_i, t_i), R_j, t_j)
    return geo.mv(sqrt_info, torch.cat([geo.so3_log(Rij), tij], -1) - dx_meas)
