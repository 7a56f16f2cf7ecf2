"""Non-overlapping field-of-view stereo: metric scale from rigidity.

Port of ``sadvio_tpu/frontend/nofov.py``.  Two rigidly mounted cameras look
in opposite directions.  With body motion (R_b, s d), d a unit direction
from camera 0, camera 1's relative translation is affine in the scale s,
    t_1(s) = a + s b,   a = R_s1^T (R_b - I) t_s1,   b = R_s1^T d,
and each camera-1 correspondence's epipolar constraint t_1(s) . m_i = 0,
m_i = (R_1 rc_i) x rk_i, gives one hypothesis s_i = -(a.m_i)/(b.m_i).
Voting over every hypothesis (``scale_ransac``) and the robust cost over a
log grid of s (``scale_grid``) are each one broadcast over
(hypotheses x features).  Every argmin and argmax takes the lowest index on
ties, as the JAX package's do.
"""

from __future__ import annotations

import math

import torch

from sadvio_tpu_torch.frontend.match import first_argmin
from sadvio_tpu_torch.utils import geometry as geo


def cam1_motion_terms(R_b, d_unit, R_f_s1, t_f_s1):
    """(R_1, a, b): camera-1 relative rotation and affine translation terms."""
    R_s1t = R_f_s1.T
    R_1 = R_s1t @ R_b @ R_f_s1
    a = R_s1t @ ((R_b - torch.eye(3, dtype=R_b.dtype, device=R_b.device)) @ t_f_s1)
    return R_1, a, R_s1t @ d_unit


def _epi_angle(R_1, t1, rays_kf, rays_cur):
    """Angular distance of each keyframe ray from its epipolar plane.
    t1: (3,) or (H,1,3) for H hypotheses; returns (N,) or (H,N)."""
    n = torch.linalg.cross(*torch.broadcast_tensors(t1, geo.mv(R_1, rays_cur)), dim=-1)
    nn = torch.clamp(torch.linalg.norm(n, dim=-1), min=1e-9)
    s = torch.abs((n * rays_kf).sum(-1)) / nn
    return torch.asin(torch.clamp(s, 0.0, 1.0))


def _first_argmax(x):
    return first_argmin(-x, 0)[0]


def scale_ransac(R_b, d_unit, R_f_s1, t_f_s1, rays1_kf, rays1_cur, valid,
                 inlier_angle_deg=0.5, min_inliers=8):
    """1-point RANSAC metric scale: every feature's closed-form hypothesis
    is voted on at once, the winner refined by weighted least squares over
    its inliers.  Returns (s, inliers, ok)."""
    R_1, a, b = cam1_motion_terms(R_b, d_unit, R_f_s1, t_f_s1)
    m = torch.linalg.cross(geo.mv(R_1, rays1_cur), rays1_kf, dim=-1)  # (N,3)
    am, bm = m @ a, m @ b
    s_hyp = -am / torch.where(torch.abs(bm) < 1e-9, torch.full_like(bm, 1e-9), bm)
    hyp_ok = valid & (torch.abs(bm) > 1e-6) & torch.isfinite(s_hyp)
    thr = math.radians(inlier_angle_deg)
    err = _epi_angle(R_1, (a + s_hyp[:, None] * b)[:, None, :], rays1_kf, rays1_cur)  # (N,N)
    votes = (valid[None, :] & (err < thr)).sum(-1) * hyp_ok
    best = _first_argmax(votes)
    s0 = s_hyp[best]
    inl = valid & (_epi_angle(R_1, a + s0 * b, rays1_kf, rays1_cur) < thr)
    w = inl.to(s_hyp.dtype)
    # minimize sum w ((a + s b) . m_hat)^2 with m_hat = m / |m|
    mn = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True), min=1e-9)
    am_n, bm_n = mn @ a, mn @ b
    denom = (w * bm_n * bm_n).sum()
    s = -(w * am_n * bm_n).sum() / torch.where(denom < 1e-12, torch.full_like(denom, 1e-12),
                                                denom)
    ok = (votes[best] >= min_inliers) & torch.isfinite(s)
    return s, inl, ok


def _geomspace(lo, hi, n):
    """n log-spaced values from lo to hi, both included (0-d tensors, on the
    device: no host copy): 10 to the power of a float64 linspace of the
    log10 bounds, rounded once to the bounds' dtype, so every value is the
    exact grid's within half a unit in the last place.  The JAX package's
    ``jnp.geomspace`` runs the same recipe in float32 and lands a few units
    away on some values."""
    a, b = torch.log10(lo.double()), torch.log10(hi.double())
    step = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=lo.device)
    return torch.pow(10.0, a + (b - a) * step).to(lo.dtype)


def _guard(x, eps):
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def scale_grid(R_b, d_unit, R_f_s1, t_f_s1, rays1_kf, rays1_cur, valid, s_lo, s_hi, *,
               n_grid: int = 512, huber_deg: float = 0.3, min_inliers: int = 8,
               inlier_angle_deg: float = 0.5):
    """Robust grid M-estimator of the metric scale: the Huber epipolar
    angular cost over n_grid/2 log-spaced s in [s_lo, s_hi] and their
    negatives, one broadcast; the minimum refined by a parabola through its
    neighbours when they lie in the same half of the grid.  Consistent where
    the 1-point least squares shrinks toward zero under ray noise.  Returns
    (s, inliers, ok)."""
    R_1, a, b = cam1_motion_terms(R_b, d_unit, R_f_s1, t_f_s1)
    half = n_grid // 2
    grid = _geomspace(torch.clamp(torch.as_tensor(s_lo, dtype=a.dtype, device=a.device), min=1e-6),
                      torch.clamp(torch.as_tensor(s_hi, dtype=a.dtype, device=a.device), min=1e-5),
                      half)
    s_grid = torch.cat([grid, -grid])
    hub = math.radians(huber_deg)
    err = _epi_angle(R_1, (a + s_grid[:, None] * b)[:, None, :], rays1_kf, rays1_cur)
    rho = torch.where(err < hub, err * err, 2 * hub * err - hub * hub)
    costs = torch.where(valid[None, :], rho, torch.zeros_like(rho)).sum(-1)
    i = first_argmin(costs, 0)[0]
    s = s_grid[i]
    # parabolic refinement on the local triple, in the raw s coordinate
    im = torch.clamp(i - 1, 0, n_grid - 1)
    ip = torch.clamp(i + 1, 0, n_grid - 1)
    x0, x1, x2 = s_grid[im], s_grid[i], s_grid[ip]
    c0, c1, c2 = costs[im], costs[i], costs[ip]
    denom = _guard((x0 - x1) * (x0 - x2) * (x1 - x2), 1e-18)
    A = (x2 * (c1 - c0) + x1 * (c0 - c2) + x0 * (c2 - c1)) / denom
    B = (x2 * x2 * (c0 - c1) + x1 * x1 * (c2 - c0) + x0 * x0 * (c1 - c2)) / denom
    s_par = -B / torch.where(torch.abs(A) < 1e-18, torch.full_like(A, 1e-18), 2 * A)
    same_bracket = (s_par > torch.minimum(x0, x2)) & (s_par < torch.maximum(x0, x2))
    # refine only inside one monotone half: the +s and -s halves are
    # concatenated, so a triple across the seam (or a clipped endpoint
    # repeating x1) fits a meaningless parabola
    same_half = ((im // half == i // half) & (ip // half == i // half) & (im != i) & (ip != i))
    s = torch.where((A > 0) & same_bracket & same_half, s_par, s)
    inl = valid & (_epi_angle(R_1, a + s * b, rays1_kf, rays1_cur)
                   < math.radians(inlier_angle_deg))
    ok = (inl.sum() >= min_inliers) & torch.isfinite(s)
    return s, inl, ok


def is_degenerate_motion(R_b, d_unit, R_f_s1, t_f_s1, min_lever=1e-3, min_angle_deg=3.0):
    """Scale is unobservable when the rotation-induced lever displacement a
    is near zero (pure translation, or a rotation axis through camera 1's
    lever) or when a is (anti)parallel to b."""
    _, a, b = cam1_motion_terms(R_b, d_unit, R_f_s1, t_f_s1)
    na = torch.linalg.norm(a)
    cosab = torch.abs(a @ b) / torch.clamp(na * torch.linalg.norm(b), min=1e-12)
    return ~((na > min_lever) & (cosab < math.cos(math.radians(min_angle_deg))))
