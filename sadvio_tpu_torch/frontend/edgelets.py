"""Edgelet features: oriented edge points (point + tangent direction).

Port of ``sadvio_tpu/frontend/edgelets.py``.  Detection: gradient magnitude
with non-maximum suppression along the gradient direction, then the grid
top-k of the point detector.  The 3D direction intersects the two viewing
planes of each view's edge tangent: line triangulation of an infinitesimal
segment.
"""

from __future__ import annotations

import math

import torch

from sadvio_tpu_torch.frontend import detect as det_mod
from sadvio_tpu_torch.frontend import lines as lines_mod
from sadvio_tpu_torch.frontend import triangulate as tri_mod


def detect_edgelets(img, *, grad_tsh: float = 12.0, gh: int = 8, gw: int = 12,
                    k_per_cell: int = 4):
    """Oriented edge points: uv (N,2), unit tangent (N,2), score (N,),
    valid (N,) with N = gh*gw*k_per_cell."""
    gx, gy = lines_mod._sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    nx = gx / torch.clamp(mag, min=1e-9)
    ny = gy / torch.clamp(mag, min=1e-9)
    H, W = img.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=img.dtype, device=img.device),
                            torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    fwd = det_mod.bilinear_sample(mag, torch.stack([xs + nx, ys + ny], -1))
    bwd = det_mod.bilinear_sample(mag, torch.stack([xs - nx, ys - ny], -1))
    score = torch.where((mag >= fwd) & (mag >= bwd) & (mag > grad_tsh), mag,
                        torch.zeros_like(mag))
    uv, s, valid = det_mod.grid_topk(score, torch.ones((H, W), dtype=torch.bool,
                                                       device=img.device), gh, gw, k_per_cell)
    g = torch.stack([det_mod.bilinear_sample(gx, uv), det_mod.bilinear_sample(gy, uv)], -1)
    n_hat = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-9)
    return uv, torch.stack([-n_hat[:, 1], n_hat[:, 0]], -1), s, valid


def match_edgelets(uv_a, dir_a, valid_a, uv_b, dir_b, valid_b, search_px=15.0,
                   max_angle_deg=15.0):
    """Proximity + tangent-angle mutual-best matching; tangents are
    180-degree ambiguous, so |cos| is compared.  Returns (idx (Na,) or -1,
    squared distance)."""
    d2 = ((uv_a[:, None] - uv_b[None, :]) ** 2).sum(-1)
    cosang = torch.abs(dir_a @ dir_b.T)
    ok = ((d2 < search_px * search_px) & (cosang > math.cos(math.radians(max_angle_deg)))
          & valid_a[:, None] & valid_b[None, :])
    score = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(score, 1)
    best_b = torch.argmin(score, 0)
    mutual = best_b[best] == torch.arange(uv_a.shape[0], device=uv_a.device)
    hit = mutual & torch.isfinite(score.amin(1)) & valid_a
    return torch.where(hit, best, torch.full_like(best, -1)), score.amin(1)


def triangulate_edgelet(cam_a, cam_b, R_ws_a, t_ws_a, R_ws_b, t_ws_b, uv_a, dir_a, uv_b, dir_b,
                        eps_px=2.0):
    """3D edgelet (point, unit direction, ok) from two oriented observations:
    the point by two-view midpoint of the centre rays, the direction by
    plane intersection of a virtual +-eps_px segment along each tangent."""
    ra_w = torch.einsum("ij,...j->...i", R_ws_a, cam_a.backproject(uv_a))
    rb_w = torch.einsum("ij,...j->...i", R_ws_b, cam_b.backproject(uv_b))
    origins = torch.stack([t_ws_a.expand_as(ra_w), t_ws_b.expand_as(rb_w)], -2)
    dirs = torch.stack([ra_w, rb_w], -2)
    p_w, ok_p = tri_mod.midpoint_triangulate(
        origins, dirs, torch.ones(dirs.shape[:-1], dtype=torch.bool, device=dirs.device),
        det_eps=1e-6)
    ends_a = torch.stack([uv_a - eps_px * dir_a, uv_a + eps_px * dir_a], -2)
    ends_b = torch.stack([uv_b - eps_px * dir_b, uv_b + eps_px * dir_b], -2)
    q0, q1, ok_l = lines_mod.triangulate_line(cam_a, cam_b, R_ws_a, t_ws_a, R_ws_b, t_ws_b,
                                              ends_a, ends_b, cond_min=0.0)
    d = q1 - q0
    return p_w, d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12), ok_p & ok_l
