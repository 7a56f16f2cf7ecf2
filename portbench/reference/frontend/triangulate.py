"""Multi-view midpoint triangulation, batched over candidate tracks
(port of ``sadvio_tpu/frontend/triangulate.py``).

The midpoint solve minimizes sum_i ||(I - d_i d_i^T)(x - o_i)||^2, i.e.
A x = b with A = sum (I - d d^T), b = sum (I - d d^T) o.
"""

from __future__ import annotations

import torch


def midpoint_triangulate(origins, dirs, mask, det_eps=1e-4, min_depth=0.1, max_depth=40.0):
    """origins, dirs: (...,M,3); mask: (...,M).  Returns (p (...,3), ok)."""
    m = mask[..., None, None].to(origins.dtype)
    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    ddt = dirs[..., :, None] * dirs[..., None, :]
    Pi = (eye - ddt) * m
    A = Pi.sum(-3)
    b = torch.einsum("...mij,...mj->...i", Pi, origins)
    det = torch.linalg.det(A)
    ok_sys = (mask.sum(-1) >= 2) & (torch.abs(det) > det_eps)
    A_safe = torch.where(ok_sys[..., None, None], A, eye.expand_as(A))
    p = torch.linalg.solve_ex(A_safe, b[..., None])[0][..., 0]
    depth = torch.sum((p[..., None, :] - origins) * dirs, -1)
    ok_ray = (~mask) | ((depth > min_depth) & (depth < max_depth))
    return p, ok_sys & ok_ray.all(-1)


def stereo_triangulate(rig_origins_w, rays_w, valid, det_eps=1e-4, max_depth=40.0):
    """rig_origins_w (C,3), rays_w (C,N,3), valid (C,N) -> (p (N,3), ok (N,))."""
    origins = rig_origins_w[:, None, :].expand_as(rays_w)
    return midpoint_triangulate(
        origins.movedim(0, -2), rays_w.movedim(0, -2), valid.movedim(0, -1),
        det_eps=det_eps, max_depth=max_depth)

