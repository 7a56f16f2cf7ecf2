"""Residuals of the visual-inertial factor graph, whitened, batched over
leading dims (port of ``sadvio_tpu/backend/factors.py``; the line residual
lives in ``frontend/lines.py``, as in the JAX package).  Reprojection and
bearing Jacobians are hand-derived, the numeric variant takes central
differences; the small factors are linearized by ``torch.func.jacfwd`` in
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


def reprojection_residual_numeric(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w, uv_meas, sigma_px,
                                  eps=1e-3):
    """The pixel residual of ``reprojection_residual`` with Jacobians from
    central differences under the retraction (6 pose dims) and Euclidean
    landmark steps (3 dims): the autodiff-free correctness baseline."""
    uv0, valid = cameras.project_world(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w)
    inv_s = 1.0 / sigma_px
    batch = torch.broadcast_shapes(R_w_f.shape[:-2], t_w_f.shape[:-1], p_w.shape[:-1])

    def h_pose(dx):
        return cameras.project_world(model, *geo.pose_retract(R_w_f, t_w_f, dx), R_f_s, t_f_s,
                                     p_w)[0]

    def h_lmk(dp):
        return cameras.project_world(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w + dp)[0]

    def fd(h, n):
        cols = []
        for i in range(n):
            e = torch.zeros(batch + (n,), dtype=p_w.dtype, device=p_w.device)
            e[..., i] = eps
            cols.append((h(e) - h(-e)) / (2.0 * eps))
        return torch.stack(cols, -1)  # (...,2,n)

    return (uv_meas - uv0) * inv_s, -fd(h_pose, 6) * inv_s, -fd(h_lmk, 3) * inv_s, valid


def _tangent_basis(ray, guard: bool = True):
    """Orthonormal (...,2,3) basis of the plane orthogonal to the unit ray
    (``guard=False``: the unclamped normalization of ``angular_residual``)."""
    # helper axis: e_x unless the ray is within ~25 deg of it, then e_y
    use_x = (torch.abs(ray[..., 0:1]) < 0.9).to(ray.dtype)
    a = torch.cat([use_x, 1.0 - use_x, torch.zeros_like(use_x)], -1)
    b1 = torch.linalg.cross(ray, a, dim=-1)
    n1 = torch.linalg.norm(b1, dim=-1, keepdim=True)
    b1 = b1 / (torch.clamp(n1, min=1e-12) if guard else n1)
    return torch.stack([b1, torch.linalg.cross(ray, b1, dim=-1)], -2)


def angular_residual(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w, ray_meas, sigma):
    """Bearing residual: the predicted unit bearing minus the observed unit
    ray (sensor frame), on the observed ray's tangent basis, over sigma.
    The model is not used: the measurement is already a ray."""
    p_c = cameras.world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p_w)
    n = torch.linalg.norm(p_c, dim=-1, keepdim=True)
    diff = p_c / torch.clamp(n, min=1e-9) - ray_meas
    r = torch.einsum("...ab,...b->...a", _tangent_basis(ray_meas, guard=False), diff) / sigma
    return r, n[..., 0] > 1e-6


def angular_residual_jac(R_w_f, t_w_f, R_f_s, t_f_s, p_w, ray_meas, sigma):
    """Whitened bearing residual r = B (ray_meas - pred) / sigma and its
    hand Jacobians: r (...,2), J_pose (...,2,6), J_lmk (...,2,3), valid."""
    R_s_f, t_s_f = geo.pose_inverse(R_f_s, t_f_s)
    p_f = geo.mv(R_w_f.transpose(-1, -2), p_w - t_w_f)
    p_c = geo.mv(R_s_f, p_f) + t_s_f
    n = torch.linalg.norm(p_c, dim=-1, keepdim=True)
    ns = torch.clamp(n, min=1e-9)
    pred = p_c / ns
    B = _tangent_basis(ray_meas)
    inv_s = 1.0 / sigma
    r = torch.einsum("...ab,...b->...a", B, ray_meas - pred) * inv_s
    # d pred / d p_c = (I - pred pred^T) / |p_c|
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device)
    P = (eye - pred[..., :, None] * pred[..., None, :]) / ns[..., None]
    J_pf = B @ P @ R_s_f
    J_h = torch.cat([J_pf @ geo.skew(p_f), -J_pf], -1)
    J_lmk_h = J_pf @ R_w_f.transpose(-1, -2)
    # residual = (meas - h) / sigma  =>  J_r = -J_h / sigma
    return r, -J_h * inv_s, -J_lmk_h * inv_s, n[..., 0] > 1e-6


def imu_factor_residual(pre, W, R_i, p_i, v_i, ba_i, bg_i, R_j, p_j, v_j, g=None):
    """Whitened 9-dof preintegration residual."""
    return geo.mv(W, imu_mod.residual(pre, R_i, p_i, v_i, ba_i, bg_i, R_j, p_j, v_j, g))


def bias_rw_residual(ba_i, bg_i, ba_j, bg_j, dt, acc_walk, gyr_walk):
    """Bias random-walk residual."""
    sdt = torch.sqrt(torch.clamp(dt, min=1e-6))[..., None]
    return torch.cat([(ba_j - ba_i) / (acc_walk * sdt), (bg_j - bg_i) / (gyr_walk * sdt)], -1)


def pose_prior_residual(R, t, R0, t0, sqrt_info):
    """6-dof pose prior on the retraction chart."""
    return geo.mv(sqrt_info, geo.pose_local(R0, t0, R, t))


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


def scale_prior_residual(log_scale, log_scale0, weight):
    """Scale prior for monocular VI init."""
    return weight * (log_scale - log_scale0)


def motion2d_residual(R_i, t_i, R_j, t_j, motion_2d, dt, sqrt_info):
    """Planar (ground-vehicle) odometry prior: motion_2d = (v_x, omega_z),
    so over dt the body advances v_x dt along its own x axis and yaws by
    omega_z dt, staying in plane.  r = W local(T_i T_delta, T_j)."""
    dx = motion_2d[..., 0] * dt
    dth = motion_2d[..., 1] * dt
    c, s = torch.cos(dth), torch.sin(dth)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Rd = torch.stack([torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2).to(R_i.dtype)
    td = torch.stack([dx, zero, zero], -1).to(R_i.dtype)
    Rp, tp = geo.pose_compose(R_i, t_i, Rd, td)
    return geo.mv(sqrt_info, geo.pose_local(Rp, tp, R_j, t_j))
