"""Camera models and the world chain with the BA Jacobians.

Port of ``sadvio_tpu/models/cameras.py``: the pinhole model with its
hand-derived Jacobian; the double-sphere, equidistant fisheye and omni
(unified sphere + radtan) models, whose point Jacobians come from
``torch.func.jacfwd`` under ``torch.func.vmap`` (so their raw projections
are branch-free: ``torch.where``, fixed iteration counts); and the
world-chain helpers (``world_to_cam``, ``project_world(_jac)``,
``bearing_world``), which dispatch on the model.  Projection returns a
validity mask instead of raising.  A rig's model carries a leading (C,)
dim on its parameters; ``model.camera(c)`` picks one camera.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from sadvio_tpu_torch.utils import geometry as geo
from sadvio_tpu_torch.utils.struct import Struct

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

    def project_jac(self, p_c):
        """uv, J (...,2,3) = d uv / d p_c by forward-mode autodiff, valid."""
        uv, valid = self.project(p_c)
        return uv, _autodiff_point_jac(self._project_raw, p_c), valid


def _guard(x, eps=_Z_MIN):
    """x with entries of magnitude below eps replaced by eps."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


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


def _unit(ray):
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


@dataclass
class DoubleSphere(_Model):
    """Double-sphere model (alpha, xi)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    alpha: torch.Tensor
    xi: torch.Tensor
    width: int = 752
    height: int = 480

    def _project_raw(self, p_c):
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        d1 = torch.sqrt(x * x + y * y + z * z)
        zz = self.xi * d1 + z
        d2 = torch.sqrt(x * x + y * y + zz * zz)
        denom = _guard(self.alpha * d2 + (1.0 - self.alpha) * zz)
        return torch.stack([self.fx * x / denom + self.cx, self.fy * y / denom + self.cy], -1)

    def project(self, p_c):
        uv = self._project_raw(p_c)
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        d1 = torch.sqrt(x * x + y * y + z * z)
        # validity region of the model: z > -w2 * d1
        a, xi = self.alpha, self.xi
        w1 = torch.where(a <= 0.5, a / (1 - a), (1 - a) / a)
        w2 = (w1 + xi) / torch.sqrt(2 * w1 * xi + xi * xi + 1)
        return uv, (z > -w2 * d1) & _in_bounds(uv, self.width, self.height)

    def backproject(self, uv):
        a, xi = self.alpha, self.xi
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        r2 = mx * mx + my * my
        mz = (1.0 - a * a * r2) / (
            a * torch.sqrt(torch.clamp(1.0 - (2 * a - 1.0) * r2, min=0.0)) + 1.0 - a)
        s = (mz * xi + torch.sqrt(torch.clamp(mz * mz + (1 - xi * xi) * r2, min=0.0))) / (
            mz * mz + r2)
        return _unit(torch.stack([s * mx, s * my, s * mz - xi], -1))


@dataclass
class Fisheye(_Model):
    """Equidistant (Kannala-Brandt k1..k4) fisheye."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    width: int = 752
    height: int = 480

    def _distort(self, th):
        t2 = th * th
        return th * (1 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4))))

    def _project_raw(self, p_c):
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta_d = self._distort(torch.atan2(r, z))
        near_axis = r < _Z_MIN
        rs = torch.where(near_axis, torch.full_like(r, _Z_MIN), r)
        scale = torch.where(near_axis, 1.0 / _guard(z), theta_d / rs)
        return torch.stack([self.fx * x * scale + self.cx, self.fy * y * scale + self.cy], -1)

    def project(self, p_c):
        uv = self._project_raw(p_c)
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        theta = torch.atan2(torch.sqrt(x * x + y * y), z)
        return uv, (theta < math.pi * 0.49 * 2) & _in_bounds(uv, self.width, self.height)

    def backproject(self, uv, iters: int = 8):
        """Invert theta_d(theta) by a fixed count of Newton steps."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        theta_d = torch.sqrt(mx * mx + my * my)
        th = theta_d
        for _ in range(iters):
            t2 = th * th
            fp = 1 + t2 * (3 * self.k1 + t2 * (5 * self.k2 + t2 * (7 * self.k3
                                                                  + t2 * 9 * self.k4)))
            th = th - (self._distort(th) - theta_d) / _guard(fp)
        on_axis = theta_d < _Z_MIN
        s = torch.sin(th) / torch.where(on_axis, torch.ones_like(theta_d), theta_d)
        zero = torch.zeros_like(s)
        return _unit(torch.stack([torch.where(on_axis, zero, s * mx),
                                  torch.where(on_axis, zero, s * my), torch.cos(th)], -1))


@dataclass
class Omni(_Model):
    """Unified-sphere (Mei) model: xi + radtan distortion."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    xi: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    width: int = 752
    height: int = 480

    def _radtan(self, mx, my):
        """(distorted - undistorted) offsets and the radial factor."""
        r2 = mx * mx + my * my
        rad = 1 + self.k1 * r2 + self.k2 * r2 * r2
        dx = 2 * self.p1 * mx * my + self.p2 * (r2 + 2 * mx * mx)
        dy = self.p1 * (r2 + 2 * my * my) + 2 * self.p2 * mx * my
        return rad, dx, dy

    def _project_raw(self, p_c):
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        d = torch.sqrt(x * x + y * y + z * z)
        denom = _guard(self.xi * d + z)
        mx, my = x / denom, y / denom
        rad, dx, dy = self._radtan(mx, my)
        return torch.stack([self.fx * (mx * rad + dx) + self.cx,
                            self.fy * (my * rad + dy) + self.cy], -1)

    def project(self, p_c):
        uv = self._project_raw(p_c)
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        d = torch.sqrt(x * x + y * y + z * z)
        return uv, (self.xi * d + z > _Z_MIN) & _in_bounds(uv, self.width, self.height)

    def backproject(self, uv):
        """Undistort by 5 fixed-point steps on radtan, then lift to the sphere."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        ux, uy = mx, my
        for _ in range(5):
            rad, dx, dy = self._radtan(ux, uy)
            ux, uy = (mx - dx) / rad, (my - dy) / rad
        r2 = ux * ux + uy * uy
        xi = self.xi
        mz = (xi + torch.sqrt(torch.clamp(1 + (1 - xi * xi) * r2, min=0.0))) / (1 + r2) - xi
        s = mz + xi
        return _unit(torch.stack([s * ux, s * uy, mz], -1))


def _in_bounds(uv, width, height):
    u, v = uv[..., 0], uv[..., 1]
    return (u >= 0) & (u < width) & (v >= 0) & (v < height) & torch.isfinite(u) & torch.isfinite(v)


def _autodiff_point_jac(fn, p_c):
    """d fn / d p_c (...,2,3) of a (...,3)->(...,2) projection: jacfwd per
    point, vmapped over the flattened points.  Each point goes in as a batch
    of one: 0-dim ``torch.where`` operands under ``torch.func`` transforms
    get float64 tangents (see ``utils.geometry._lift``)."""
    flat = p_c.reshape(-1, 3)
    J = torch.func.vmap(torch.func.jacfwd(lambda q: fn(q[None])[0]))(flat)
    return J.reshape(*p_c.shape[:-1], 2, 3)


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


MODELS = {"pinhole": Pinhole, "fisheye": Fisheye, "double_sphere": DoubleSphere,
          "omni": Omni}


def make_pinhole(fx, fy, cx, cy, width=752, height=480, dtype=torch.float32, device=None):
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return Pinhole(fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy), width=width, height=height)
