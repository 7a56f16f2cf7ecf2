"""Error-state Kalman frame-rate pose update in information form
(port of ``sadvio_tpu/frontend/eskf.py``): one batched linearization of all
landmark reprojections plus the IMU prior, solved as a 6x6 system and
iterated a fixed small number of times (IEKF)."""

from __future__ import annotations

import torch

from portbench.reference.frontend.pnp import _solve6
from portbench.reference.models import cameras
from portbench.reference.utils import geometry as geo


def eskf_update(model, R_f_s, t_f_s, R_prior, t_prior, P_prior, lmk_w, uv, valid,
                sigma_px=1.0, *, iters: int = 2, gate_px: float = 3.0):
    """Fuse a pose prior (6x6 covariance over [omega, nu]) with landmark
    reprojections.  Returns (R, t, P_post, n_used)."""
    eye6 = torch.eye(6, dtype=P_prior.dtype, device=P_prior.device)
    P_inv = torch.linalg.inv_ex(P_prior + eye6 * 1e-12)[0]
    inv_r2 = 1.0 / (sigma_px * sigma_px)

    def weights(R, t):
        uv_hat, J_pose, _, vis = cameras.project_world_jac(model, R, t, R_f_s, t_f_s, lmk_w)
        r = uv - uv_hat
        rn = torch.linalg.norm(r, dim=-1)
        w = (valid & vis & (rn < gate_px)).to(r.dtype) * inv_r2
        return r, J_pose, w

    R, t = R_prior, t_prior
    for _ in range(iters):
        r, J_pose, w = weights(R, t)
        wJ = w[:, None, None] * J_pose
        H = torch.einsum("nai,naj->ij", wJ, J_pose)
        b = torch.einsum("nai,na->i", wJ, r)
        dx_prior = geo.pose_local(R_prior, t_prior, R, t)
        R, t = geo.pose_retract(R, t, _solve6(P_inv + H, b - P_inv @ dx_prior))
    _, J_pose, w = weights(R, t)
    wJ = w[:, None, None] * J_pose
    H = torch.einsum("nai,naj->ij", wJ, J_pose)
    P_post = torch.linalg.inv_ex(P_inv + H)[0]
    return R, t, P_post, (w > 0).sum()


def imu_prior_covariance(pre_cov, dT_cov_floor=1e-6):
    """6x6 pose prior covariance from the (dphi, dv, dp) preintegration
    covariance: the (dphi, dp) blocks."""
    rows = torch.cat([pre_cov[0:3], pre_cov[6:9]])
    P = torch.cat([rows[:, 0:3], rows[:, 6:9]], 1)
    return P + torch.eye(6, dtype=pre_cov.dtype, device=pre_cov.device) * dT_cov_floor
