"""Epipolar angular filtering (port of the main-path subset of
``sadvio_tpu/frontend/epipolar.py``; the essential-matrix RANSAC waits)."""

from __future__ import annotations

import math

import torch

from sadvio_tpu_torch.utils import geometry as geo


def epipolar_angular_error(R_ab, t_ab, rays_a, rays_b):
    """Angular distance (rad) of ray_b from the epipolar plane of ray_a;
    T_ab maps frame-b coordinates into frame a."""
    rb_in_a = geo.mv(R_ab, rays_b)
    n = torch.linalg.cross(t_ab.expand_as(rb_in_a), rb_in_a, dim=-1)
    nn = torch.linalg.norm(n, dim=-1)
    n_hat = n / torch.clamp(nn, min=1e-9)[..., None]
    s = torch.abs(torch.sum(n_hat * rays_a, -1))
    return torch.asin(torch.clamp(s, 0.0, 1.0))


def epipolar_filter(R_ab, t_ab, rays_a, rays_b, valid, max_angle_deg=0.5):
    """Outlier gate at a fixed angular threshold."""
    err = epipolar_angular_error(R_ab, t_ab, rays_a, rays_b)
    tiny_t = torch.linalg.norm(t_ab) < 1e-6  # plane undefined: keep all
    return valid & (tiny_t | (err < math.radians(max_angle_deg)))
