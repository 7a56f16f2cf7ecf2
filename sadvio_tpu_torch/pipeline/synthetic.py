"""Synthetic EuRoC-like world: rendered stereo stream + IMU + ground truth.

Port of the pinhole, point-feature part of
``sadvio_tpu/pipeline/synthetic.py`` (no line segments, no exposure jitter
or occluder) with both trajectories.  The scene is a
wall of Gaussian intensity blobs rendered with torch on the caller's
device; IMU samples come from the analytic trajectory by high-rate finite
differences in float64 on the host.  With the same arguments it draws the
same random numbers in the same order as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sadvio_tpu_torch.data.window import Rig
from sadvio_tpu_torch.models import cameras, imu as imu_mod
from sadvio_tpu_torch.utils.struct import entry_device


class FrameData(NamedTuple):
    ts: float
    images: np.ndarray  # (C,H,W) float32 in [0,255]
    acc: np.ndarray  # (n,3) samples since the previous frame
    gyr: np.ndarray  # (n,3)
    dt: np.ndarray  # (n,)


class SyntheticWorld(NamedTuple):
    rig: Rig
    imu_params: imu_mod.ImuParams
    frames: list
    gt_R: np.ndarray  # (T,3,3) body pose world-from-frame
    gt_t: np.ndarray  # (T,3)
    gt_v: np.ndarray  # (T,3)
    points: np.ndarray  # (N,3)


def make_rig(width=320, height=240, baseline=0.11, f=200.0, camera="pinhole", device=None):
    """Stereo pinhole rig on ``device`` (None: the CUDA card)."""
    if camera != "pinhole":
        raise NotImplementedError(f"camera model {camera!r} is not ported yet")
    device = entry_device(device)
    C = 2
    full = lambda x: torch.full((C,), float(x), dtype=torch.float32, device=device)
    model = cameras.Pinhole(fx=full(f), fy=full(f), cx=full(width / 2.0),
                            cy=full(height / 2.0), width=width, height=height)
    R_f_s = torch.eye(3, device=device).expand(C, 3, 3).clone()
    t_f_s = torch.tensor([[0.0, 0.0, 0.0], [baseline, 0.0, 0.0]], dtype=torch.float32,
                         device=device)
    return Rig(cam=model, R_f_s=R_f_s, t_f_s=t_f_s)


def render_view(cam_f, cam_c, R_w_f, t_w_f, R_f_s, t_f_s, pts, intens, width: int, height: int):
    """Splat scene points into one image (H,W): each point is a sharp core
    plus a soft halo, so coarse pyramid levels keep signal."""
    R_s_f = R_f_s.T
    p_f = (pts - t_w_f) @ R_w_f
    p_c = p_f @ R_f_s + R_s_f @ (-t_f_s)
    z = p_c[:, 2]
    u = cam_f * p_c[:, 0] / torch.clamp(z, min=0.1) + cam_c[0]
    v = cam_f * p_c[:, 1] / torch.clamp(z, min=0.1) + cam_c[1]
    vis = (z > 0.3) & (u > -12) & (u < width + 12) & (v > -12) & (v < height + 12)
    w = torch.where(vis, intens, torch.zeros_like(intens))
    xs = torch.arange(width, dtype=torch.float32, device=pts.device)
    ys = torch.arange(height, dtype=torch.float32, device=pts.device)
    img = torch.zeros((height, width), dtype=torch.float32, device=pts.device)
    for sigma, amp in ((1.6, 1.0), (5.0, 0.55)):
        gx = torch.exp(-0.5 * ((xs[None, :] - u[:, None]) / sigma) ** 2)
        gy = torch.exp(-0.5 * ((ys[None, :] - v[:, None]) / sigma) ** 2)
        img = img + amp * torch.einsum("nh,nw->hw", gy * w[:, None], gx)
    return torch.clamp(img, 0.0, 255.0)


def _trajectory(t, rot_scale=1.0, mode="default"):
    """Analytic trajectory (f64): lateral sweep + gentle bob, looking at +z.

    mode="excursion": pan out 2.2 m to the right with a co-directed yaw and
    come back.  The start-of-run landmarks leave the field of view
    mid-excursion (with global_map they are archived), and the return is a
    revisit that exercises descriptor resurrection and loop closure."""
    if mode == "excursion":
        T = max(float(t[-1]), 1e-6)
        s = np.sin(np.pi * t / T)
        p = np.stack([2.2 * s, 0.12 * np.sin(0.9 * t + 0.7), 0.08 * np.sin(0.7 * t)], -1)
        return p, 0.5 * s, 0.04 * np.sin(0.8 * t + 1.0)
    p = np.stack([0.8 * np.sin(0.5 * t), 0.4 * np.sin(0.3 * t + 0.7),
                  0.15 * np.sin(0.23 * t)], -1)
    yaw = 0.12 * rot_scale * np.sin(0.4 * t)
    pitch = 0.06 * rot_scale * np.sin(0.31 * t + 1.0)
    return p, yaw, pitch


def _rot(yaw, pitch):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Ry @ Rx


def make_world(seed=0, n_frames=80, fps=20.0, imu_rate=200.0, width=320, height=240,
               n_points=240, noise_px=0.0, imu_noise=True, rot_scale=1.0, trajectory="default",
               wall_x=(-5.0, 5.0), device=None) -> SyntheticWorld:
    """Blob-wall world seen by a stereo pinhole rig.  ``trajectory``:
    "default" or "excursion"; ``wall_x``: horizontal extent of the wall.

    Images are rendered on ``device`` (None: the CUDA card) and returned as
    numpy arrays."""
    from scipy.spatial.transform import Rotation

    device = entry_device(device)
    rng = np.random.default_rng(seed)
    rig = make_rig(width, height, device=device)
    params = imu_mod.ImuParams.euroc()
    g = np.array([0.0, 0.0, -imu_mod.GRAVITY])

    span_x = wall_x[1] - wall_x[0]
    gx = int(np.ceil(np.sqrt(n_points * span_x / 7.0)))
    gy = int(np.ceil(n_points / gx))
    xs = np.linspace(wall_x[0], wall_x[1], gx)
    ys = np.linspace(-3.5, 3.5, gy)
    gxx, gyy = np.meshgrid(xs, ys)
    cell = np.array([xs[1] - xs[0], ys[1] - ys[0]])
    pts2 = np.stack([gxx.reshape(-1), gyy.reshape(-1)], -1)[:n_points]
    pts2 = pts2 + rng.uniform(-0.25, 0.25, pts2.shape) * cell
    ii, jj = np.meshgrid(np.arange(gx), np.arange(gy))
    zfield = 6.5 + 2.0 * np.sin(0.8 * ii) * np.cos(0.9 * jj)
    z = zfield.reshape(-1)[:n_points] + rng.uniform(-0.2, 0.2, len(pts2))
    pts = np.concatenate([pts2, z[:, None]], -1).astype(np.float32)
    intens = rng.uniform(80, 220, len(pts)).astype(np.float32)

    n_sub = int(round(imu_rate / fps))
    dt_imu = 1.0 / imu_rate
    t_dense = np.arange(n_frames * n_sub + 1) * dt_imu
    p_d, yaw_d, pitch_d = _trajectory(t_dense, rot_scale, mode=trajectory)
    R_d = np.stack([_rot(y, pp) for y, pp in zip(yaw_d, pitch_d)])
    v_d = np.gradient(p_d, dt_imu, axis=0)
    a_d = np.gradient(v_d, dt_imu, axis=0)
    dRs = np.einsum("nij,nik->njk", R_d[:-1], R_d[1:])
    w_d = np.zeros((len(t_dense), 3))
    w_d[:-1] = Rotation.from_matrix(dRs).as_rotvec() / dt_imu
    w_d[-1] = w_d[-2]

    pts_t = torch.as_tensor(pts, device=device)
    intens_t = torch.as_tensor(intens, device=device)
    fx, cx, cy = rig.cam.fx.tolist(), rig.cam.cx.tolist(), rig.cam.cy.tolist()
    frames, gt_R, gt_t, gt_v = [], [], [], []
    for k in range(n_frames):
        i0 = k * n_sub
        R_k, t_k = R_d[i0], p_d[i0]
        gt_R.append(R_k)
        gt_t.append(t_k)
        gt_v.append(v_d[i0])
        R_kt = torch.as_tensor(R_k, dtype=torch.float32, device=device)
        t_kt = torch.as_tensor(t_k, dtype=torch.float32, device=device)
        imgs = [render_view(fx[c], (cx[c], cy[c]), R_kt, t_kt, rig.R_f_s[c], rig.t_f_s[c],
                            pts_t, intens_t, width, height).cpu().numpy()
                for c in range(2)]
        if noise_px > 0:
            imgs = [im + rng.standard_normal(im.shape).astype(np.float32) * noise_px
                    for im in imgs]
        if k == 0:
            acc, gyr, dts = np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
        else:
            sl = slice((k - 1) * n_sub, k * n_sub)
            acc = np.einsum("nij,nj->ni", R_d[sl].transpose(0, 2, 1), a_d[sl] - g)
            gyr = w_d[sl].copy()
            if imu_noise:
                # sums and noise in float32, as the JAX package forms them
                f32 = np.float32
                acc = acc.astype(f32) + (rng.standard_normal(acc.shape).astype(f32)
                                         * f32(params.acc_noise) * f32(np.sqrt(imu_rate)))
                gyr = gyr.astype(f32) + (rng.standard_normal(gyr.shape).astype(f32)
                                         * f32(params.gyr_noise) * f32(np.sqrt(imu_rate)))
            dts = np.full((n_sub,), dt_imu)
        frames.append(FrameData(ts=k / fps, images=np.stack(imgs).astype(np.float32),
                                acc=acc.astype(np.float32), gyr=gyr.astype(np.float32),
                                dt=dts.astype(np.float32)))
    return SyntheticWorld(rig=rig, imu_params=params, frames=frames,
                          gt_R=np.stack(gt_R).astype(np.float32),
                          gt_t=np.stack(gt_t).astype(np.float32),
                          gt_v=np.stack(gt_v).astype(np.float32), points=pts)


def ate_rmse(est_t, gt_t, align=True, with_scale=False):
    """Absolute trajectory error after optional Umeyama alignment."""
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        E, G = est - mu_e, gt - mu_g
        U, S, Vt = np.linalg.svd(E.T @ G)
        Dm = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        R = (U @ Dm @ Vt).T
        s = 1.0
        if with_scale:
            s = (S * np.diag(Dm)).sum() / max((E ** 2).sum(), 1e-12)
        est = s * (est - mu_e) @ R.T + mu_g
    return float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))
