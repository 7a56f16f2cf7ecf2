"""SO(3)/SE(3) Lie-group math on tensors with arbitrary leading batch dims.

Port of ``sadvio_tpu/utils/geometry.py`` (same conventions, same names):

* Poses are world-from-body ``T_w_f = (R, t)`` with ``x_w = R @ x_f + t``.
* The optimizer perturbation is the decoupled right delta
  ``dx = [omega, nu]``: ``T' = (R @ Exp(omega), t + R @ nu)``.

Every function is branch-free (``torch.where`` on guarded operands), so it
stays exact under ``torch.func.jacfwd``/``vmap`` near 0 and near pi.
"""

from __future__ import annotations

import functools
import math

import torch

_EPS = 1e-8


def _eye(like: torch.Tensor, shape=None) -> torch.Tensor:
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye if shape is None else eye.expand(shape)


def _lift(core_ndim):
    """Run the decorated function on a leading batch of one when it is given
    a single vector/matrix: under ``torch.func`` transforms, 0-dim
    ``torch.where`` operands built with Python-scalar arithmetic get float64
    tangents."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(x):
            return fn(x[None])[0] if x.ndim == core_ndim else fn(x)
        return wrapped

    return deco


def skew(w: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix, batched. w: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _theta_split(theta2):
    """(small, theta_safe): sqrt taken on a clamped operand so its tangent
    stays finite at 0; small-angle branches are polynomials in theta2."""
    small = theta2 < _EPS
    theta_safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return small, theta_safe


@_lift(1)
def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta2 = torch.sum(w * w, -1)
    small, theta = _theta_split(theta2)
    W = skew(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(theta2), theta2))
    return _eye(w, W.shape) + a[..., None, None] * W + b[..., None, None] * W2


@_lift(2)
def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (...,3,3) -> (...,3); near pi by the diagonal."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    vn2 = torch.sum(v * v, -1)  # = 4 sin^2(theta)
    small = vn2 < _EPS  # theta near 0 or near pi
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = torch.atan2(0.5 * vn, cos_t)
    generic = (theta / vn)[..., None] * v
    taylor = 0.5 * (1.0 + vn2 / 24.0)[..., None] * v
    near_pi = cos_t < -0.999995
    theta_pi = math.pi - torch.asin(torch.clamp(
        0.5 * torch.sqrt(torch.clamp(vn2, min=1e-20)), 0.0, 1.0))
    B = (R + _eye(R, R.shape)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], -1)
    k = torch.argmax(diag, -1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(B, -1, idx)[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(torch.sum(axis * v, -1, keepdim=True) < 0.0, -1.0, 1.0)
    pi_branch = theta_pi[..., None] * axis * sign
    out = torch.where(small[..., None], taylor, generic)
    return torch.where(near_pi[..., None], pi_branch, out)


@_lift(1)
def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, -1)
    small, theta = _theta_split(theta2)
    W = skew(w)
    W2 = W @ W
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t3 = safe_t2 * theta
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    return _eye(w, W.shape) + a[..., None, None] * W + b[..., None, None] * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian(-w)


def mv(A, x):
    """Batched matrix-vector product A (...,i,j) x (...,j) -> (...,i)."""
    return (A @ x[..., None])[..., 0]


def pose_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): first apply b, then a."""
    return Ra @ Rb, mv(Ra, tb) + ta


def pose_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -mv(Rt, t)


def so3_orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step toward the orthogonal polar factor: R(3I - R^T R)/2."""
    RtR = R.transpose(-1, -2) @ R
    return R @ (1.5 * _eye(R, R.shape) - 0.5 * RtR)


def pose_retract(R, t, dx):
    """Decoupled right retraction, re-orthonormalized."""
    omega, nu = dx[..., :3], dx[..., 3:6]
    Rn = so3_orthonormalize(R @ so3_exp(omega))
    return Rn, t + mv(R, nu)


def pose_local(Ra, ta, Rb, tb):
    """Inverse of the retraction: dx with retract((Ra,ta), dx) == (Rb,tb)."""
    omega = so3_log(Ra.transpose(-1, -2) @ Rb)
    nu = mv(Ra.transpose(-1, -2), tb - ta)
    return torch.cat([omega, nu], -1)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3x3 matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    det = torch.where(torch.abs(det) < _EPS, torch.full_like(det, _EPS), det)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj / det[..., None, None]

