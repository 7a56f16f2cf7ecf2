"""Visual-inertial initialization: gravity / velocity / bias / scale solve
(port of ``sadvio_tpu/backend/viinit.py``).

A fixed-iteration damped Gauss-Newton on the packed parameters
[g2 (2), v (3K), dba (3), dbg (3), log_s (1)] with the vision poses held
fixed; Jacobians by ``torch.func.jacfwd``.
"""

from __future__ import annotations

import torch

from sadvio_tpu_torch.data.window import ImuChain
from sadvio_tpu_torch.models import imu as imu_mod
from sadvio_tpu_torch.utils import geometry as geo


def _gravity_dir(g2):
    """2-dof tangent perturbation of the -z gravity direction."""
    base = torch.tensor([0.0, 0.0, -1.0], dtype=g2.dtype, device=g2.device)
    w = torch.cat([g2, g2.new_zeros(1)])
    return geo.so3_exp(w) @ base


def vi_init(R, t, kf_mask, imu_chain: ImuChain, *, optimize_scale: bool = False,
            iters: int = 12, g_mag: float = imu_mod.GRAVITY):
    """Solve gravity direction, velocities, shared bias delta and scale.

    Returns a dict with R_align, scale, v (aligned), ba, bg, g_dir, cost0,
    cost and converged, as the JAX package's vi_init does."""
    K = R.shape[0]
    pre = imu_chain.pre
    pm = imu_chain.mask
    dt_, dev = t.dtype, t.device
    n_v = 3 * K
    dim = 2 + n_v + 6 + 1
    ok = pm & kf_mask[:-1] & kf_mask[1:]
    Ri, Rj = R[:-1], R[1:]

    def unpack(x):
        log_s = x[8 + n_v] if optimize_scale else x.new_zeros(())
        return x[0:2], x[2: 2 + n_v].reshape(K, 3), x[2 + n_v: 5 + n_v], x[5 + n_v: 8 + n_v], log_s

    def residuals(x):
        g2, v, dba, dbg, log_s = unpack(x)
        s = torch.exp(log_s)
        g = _gravity_dir(g2) * g_mag
        dR, dv, dp = imu_mod.bias_corrected_deltas(pre, dba, dbg)
        dt = pre.dt[:, None]
        RiT = Ri.transpose(-1, -2)
        r_R = geo.so3_log(dR.transpose(-1, -2) @ (RiT @ Rj))
        r_v = geo.mv(RiT, v[1:] - v[:-1] - g * dt) - dv
        r_p = geo.mv(RiT, s * (t[1:] - t[:-1]) - v[:-1] * dt - 0.5 * g * dt * dt) - dp
        r = torch.cat([r_R * 1e2, r_v * 1e1, r_p * 1e1], -1)
        return torch.where(ok[:, None], r, torch.zeros_like(r)).reshape(-1)

    eye = torch.eye(dim, dtype=dt_, device=dev)
    x = torch.zeros(dim, dtype=dt_, device=dev)
    r0 = residuals(x)
    c0 = torch.sum(r0 * r0)
    cost = c0
    lam = torch.tensor(1e-4, dtype=dt_, device=dev)
    jac = torch.func.jacfwd(residuals)
    for _ in range(iters):
        r = residuals(x)
        J = jac(x)
        H = J.T @ J
        H = H + (lam * torch.diagonal(H) + 1e-8) * eye
        dx, info = torch.linalg.solve_ex(H, (-J.T @ r)[:, None])
        dx = dx[:, 0]
        good = (info == 0) & torch.isfinite(dx).all()
        x_t = x + torch.where(good, dx, torch.zeros_like(dx))
        r_t = residuals(x_t)
        c_t = torch.sum(r_t * r_t)
        accept = torch.isfinite(c_t) & (c_t < cost)
        x = torch.where(accept, x_t, x)
        cost = torch.where(accept, c_t, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0), 1e-9, 1e6)

    g2, v, dba, dbg, log_s = unpack(x)
    r1 = residuals(x)
    g_hat = _gravity_dir(g2)
    target = torch.tensor([0.0, 0.0, -1.0], dtype=dt_, device=dev)
    axis = torch.linalg.cross(g_hat, target)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.dot(g_hat, target)
    w = axis / torch.clamp(sin_a, min=1e-9) * torch.atan2(sin_a, cos_a)
    R_align = geo.so3_exp(torch.where(sin_a < 1e-9, torch.zeros_like(w), w))
    n_pairs = ok.sum()
    converged = (torch.sum(r1 * r1) < torch.sum(r0 * r0) + 1e-6) & (n_pairs >= 2)
    return {
        "R_align": R_align, "scale": torch.exp(log_s), "v": geo.mv(R_align, v),
        "ba": pre.ba_lin[0] + dba, "bg": pre.bg_lin[0] + dbg, "g_dir": g_hat,
        "cost0": c0, "cost": torch.sum(r1 * r1), "converged": converged,
    }


def apply_alignment(state, R_align, scale):
    """Rotate/rescale the whole window state."""
    return state.replace(R=R_align @ state.R, t=scale * geo.mv(R_align, state.t),
                         lmk=scale * geo.mv(R_align, state.lmk))
