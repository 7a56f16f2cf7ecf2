"""Robust pose from 3D-2D matches: batched-hypothesis Gauss-Newton "PnP".

Port of ``sadvio_tpu/frontend/pnp.py``.  Each hypothesis runs a short
pose-only GN on a random 4-point subset warm-started at the prediction; all
hypotheses run as one batch, the best-scoring one is refined with Huber
IRLS over all points, and the 6x6 covariance comes from the inlier normal
matrix.  Subsets come from a ``torch.Generator`` (the JAX package uses
``jax.random``), or from ``sample_idx`` when the caller supplies them.
"""

from __future__ import annotations

import torch

from portbench.reference.models import cameras
from portbench.reference.utils import geometry as geo
from portbench.reference.utils.struct import take


def _solve6(H, b):
    """Batched 6x6 solve; a failed or non-finite step becomes zero."""
    dx, info = torch.linalg.solve_ex(H, b[..., None])
    dx = dx[..., 0]
    ok = (info == 0) & torch.isfinite(dx).all(-1)
    return torch.where(ok[..., None], dx, torch.zeros_like(dx))


def _pose_gn(model, R_f_s, t_f_s, R0, t0, p_w, uv, w, iters: int):
    """Pose-only GN from (R0,t0), batched over leading dims of p_w (...,N,3)."""
    eye6 = torch.eye(6, dtype=p_w.dtype, device=p_w.device)
    R, t = R0, t0
    for _ in range(iters):
        uv_hat, J_pose, _, valid = cameras.project_world_jac(
            model, R[..., None, :, :], t[..., None, :], R_f_s, t_f_s, p_w)
        r = uv - uv_hat
        wJ = (w * valid)[..., None, None] * J_pose
        H = torch.einsum("...nai,...naj->...ij", wJ, J_pose) + eye6 * 1e-4
        b = torch.einsum("...nai,...na->...i", wJ, r)
        R, t = geo.pose_retract(R, t, _solve6(H, b))
    return R, t


def pnp_ransac(model, R_f_s, t_f_s, p_w, uv, valid, R_pred, t_pred, generator=None,
               *, n_hyp: int = 48, gn_iters: int = 5, refine_iters: int = 5,
               inlier_px: float = 2.0, min_inliers: int = 10, sample_idx=None):
    """Returns (R, t, inlier_mask, ok, cov6).

    sample_idx: optional (n_hyp, 4) int indices of each hypothesis' subset;
    otherwise they are drawn from ``generator``."""
    N = p_w.shape[0]
    dev = p_w.device
    if sample_idx is None:
        sample_idx = torch.randint(0, N, (n_hyp, 4), generator=generator, device=dev)
    idx = sample_idx.to(dev).long()
    n_h = idx.shape[0]
    Rh = R_pred.expand(n_h, 3, 3)
    th = t_pred.expand(n_h, 3)
    Rh, th = _pose_gn(model, R_f_s, t_f_s, Rh, th, p_w[idx], uv[idx],
                      valid[idx].to(p_w.dtype), gn_iters)
    uv_hat, v = cameras.project_world(model, Rh[:, None], th[:, None], R_f_s, t_f_s, p_w)
    err = torch.linalg.norm(uv - uv_hat, dim=-1)
    scores = (valid & v & (err < inlier_px)).sum(-1)
    best = torch.argmax(scores)
    R, t = take(Rh, best), take(th, best)

    eye6 = torch.eye(6, dtype=p_w.dtype, device=dev)
    for _ in range(refine_iters):
        uv_hat, J_pose, _, v = cameras.project_world_jac(model, R, t, R_f_s, t_f_s, p_w)
        r = uv - uv_hat
        rn = torch.linalg.norm(r, dim=-1)
        w = (valid & v & (rn < 3.0 * inlier_px)).to(p_w.dtype)
        w = w * torch.clamp(inlier_px / torch.clamp(rn, min=1e-6), max=1.0)
        wJ = w[:, None, None] * J_pose
        H = torch.einsum("nai,naj->ij", wJ, J_pose) + eye6 * 1e-6
        b = torch.einsum("nai,na->i", wJ, r)
        R, t = geo.pose_retract(R, t, _solve6(H, b))

    uv_hat, v = cameras.project_world(model, R, t, R_f_s, t_f_s, p_w)
    err = torch.linalg.norm(uv - uv_hat, dim=-1)
    inliers = valid & v & (err < inlier_px)
    ok = inliers.sum() >= min_inliers
    _, J_pose, _, _ = cameras.project_world_jac(model, R, t, R_f_s, t_f_s, p_w)
    wJ = inliers[:, None, None].to(p_w.dtype) * J_pose
    H = torch.einsum("nai,naj->ij", wJ, J_pose) + eye6 * 1e-6
    cov = torch.linalg.inv_ex(H)[0]
    return R, t, inliers, ok, cov
