"""Camera models and the world chain with the BA Jacobians.

Port of ``sadvio_tpu/models/cameras.py``: the pinhole model with its
hand-derived Jacobian (the benchmark's configurations use no other lens),
and the world-chain helpers (``world_to_cam``, ``project_world(_jac)``,
``bearing_world``).  Projection returns a
validity mask instead of raising.  A rig's model carries a leading (C,)
dim on its parameters; ``model.camera(c)`` picks one camera.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from portbench.reference.utils import geometry as geo
from portbench.reference.utils.struct import Struct

_Z_MIN = 1e-4


class _Model(Struct):
    """Shared parts of the camera models: focal length and camera pick."""

    @property
    def focal(self):
        return 0.5 * (self.fx + self.fy)

    def camera(self, c: int):
        """Camera ``c`` of a rig whose parameters carry a leading (C,) dim."""
        pick = lambda x: x[c] if isinstance(x, torch.Tensor) and x.ndim > 0 else x
        return dataclasses.replace(self, **{f.name: pick(getattr(self, f.name))
                                            for f in dataclasses.fields(self)})


@dataclass
class Pinhole(_Model):
    """K-based pinhole; fx, fy, cx, cy are tensors (scalar or (C,))."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 752
    height: int = 480

    def project(self, p_c):
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        zs = torch.where(torch.abs(z) < _Z_MIN, torch.full_like(z, _Z_MIN), z)
        uv = torch.stack([self.fx * x / zs + self.cx, self.fy * y / zs + self.cy], -1)
        valid = (z > _Z_MIN) & _in_bounds(uv, self.width, self.height)
        return uv, valid

    def project_jac(self, p_c):
        """uv, J (...,2,3) = d uv / d p_c, valid."""
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        zs = torch.where(torch.abs(z) < _Z_MIN, torch.full_like(z, _Z_MIN), z)
        iz = 1.0 / zs
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        J = torch.stack([
            torch.stack([self.fx * iz, zero, -self.fx * x * iz2], -1),
            torch.stack([zero, self.fy * iz, -self.fy * y * iz2], -1),
        ], -2)
        uv, valid = self.project(p_c)
        return uv, J, valid

    def backproject(self, uv):
        """Pixel -> unit ray in the camera frame."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        r = torch.stack([x, y, torch.ones_like(x)], -1)
        return r / torch.linalg.norm(r, dim=-1, keepdim=True)


def _in_bounds(uv, width, height):
    u, v = uv[..., 0], uv[..., 1]
    return (u >= 0) & (u < width) & (v >= 0) & (v < height) & torch.isfinite(u) & torch.isfinite(v)


def world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p_w):
    """p_c = T_f_s^-1 T_w_f^-1 p_w."""
    R_s_f, t_s_f = geo.pose_inverse(R_f_s, t_f_s)
    p_f = geo.mv(R_w_f.transpose(-1, -2), p_w - t_w_f)
    return geo.mv(R_s_f, p_f) + t_s_f


def project_world_jac(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w):
    """uv (...,2), J_pose (...,2,6) wrt the retraction, J_lmk (...,2,3), valid."""
    R_s_f, t_s_f = geo.pose_inverse(R_f_s, t_f_s)
    p_f = geo.mv(R_w_f.transpose(-1, -2), p_w - t_w_f)
    p_c = geo.mv(R_s_f, p_f) + t_s_f
    uv, J_m, valid = model.project_jac(p_c)
    J_uv_pf = J_m @ R_s_f
    J_pose = torch.cat([J_uv_pf @ geo.skew(p_f), -J_uv_pf], -1)
    J_lmk = J_uv_pf @ R_w_f.transpose(-1, -2)
    return uv, J_pose, J_lmk, valid


def project_world(model, R_w_f, t_w_f, R_f_s, t_f_s, p_w):
    return model.project(world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p_w))


def bearing_world(model, R_w_f, t_w_f, R_f_s, t_f_s, uv):
    """Pixel -> unit bearing ray in the world frame."""
    ray_c = model.backproject(uv)
    return geo.mv(R_w_f, geo.mv(R_f_s, ray_c))


