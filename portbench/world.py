"""The benchmark's world: a frozen copy of the port's synthetic EuRoC-like
generator (``pipeline/synthetic.py:make_world``, default trajectory), seen
through the rig of a configuration file.

The scene is a wall of Gaussian intensity blobs.  Images are rendered on the
card in a few batched calls, with each camera's pinhole intrinsics and its
body-from-sensor extrinsics (``T_BS``) from the configuration, cast to uint8
there and copied to the host once: the frames are what a recorded sequence
hands the pipeline.  IMU samples come from the analytic trajectory by
high-rate finite differences in float64 on the host, with white noise at the
configuration's densities.  ``time_scale`` runs the trajectory's clock
faster or slower (positions and angles at ``time_scale * t``) and
``rot_scale`` scales its yaw and pitch; the IMU is differentiated from that.
A mix sets both to match a recorded sequence's mean speed and angular rate
(``motion_stats``).  Everything is drawn from ``seed``: the same seed gives
the same world.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GRAVITY = 9.81
RENDER_CHUNK = 64  # frames per batched render call


class Frame(NamedTuple):
    ts: float
    images: np.ndarray  # (C,H,W) uint8
    acc: np.ndarray  # (n,3) float32 samples since the previous frame
    gyr: np.ndarray  # (n,3)
    dt: np.ndarray  # (n,)


class World(NamedTuple):
    frames: list
    gt_R: np.ndarray  # (T,3,3) world-from-body
    gt_t: np.ndarray  # (T,3)
    gt_v: np.ndarray  # (T,3)


class Camera(NamedTuple):
    """One camera of a configuration, in float64 host arrays."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    R_f_s: np.ndarray  # (3,3) body-from-sensor
    t_f_s: np.ndarray  # (3,)


def cameras_of(cfg: dict) -> list:
    """The configuration's cameras (``cam0``, ``cam1``, ... up to ``ncam``)."""
    out = []
    for c in range(int(cfg["ncam"])):
        cam = cfg[f"cam{c}"]
        if cam["camera_model"] != "pinhole":
            raise ValueError(f"cam{c}: only pinhole cameras are rendered")
        fx, fy, cx, cy = (float(v) for v in cam["intrinsics"][:4])
        T = np.asarray(cam["T_BS"], np.float64).reshape(4, 4)
        out.append(Camera(fx, fy, cx, cy, int(cam["resolution"][0]), int(cam["resolution"][1]),
                          T[:3, :3], T[:3, 3]))
    return out


def imu_noise(cfg: dict) -> dict:
    imu = cfg["imu"]
    return dict(acc_noise=float(imu["accelerometer_noise_density"]),
                gyr_noise=float(imu["gyroscope_noise_density"]),
                acc_walk=float(imu["accelerometer_random_walk"]),
                gyr_walk=float(imu["gyroscope_random_walk"]),
                rate_hz=float(imu["rate_hz"]))


def _trajectory(t, rot_scale=1.0):
    """Analytic trajectory (f64): lateral sweep + gentle bob, looking at +z."""
    p = np.stack([0.8 * np.sin(0.5 * t), 0.4 * np.sin(0.3 * t + 0.7),
                  0.15 * np.sin(0.23 * t)], -1)
    yaw = 0.12 * rot_scale * np.sin(0.4 * t)
    pitch = 0.06 * rot_scale * np.sin(0.31 * t + 1.0)
    return p, yaw, pitch


def motion_stats(traffic: dict, seconds: float = 600.0, rate_hz: float = 200.0):
    """(mean speed m/s, mean angular rate rad/s) of the mix's trajectory."""
    dt = 1.0 / rate_hz
    t = np.arange(0.0, seconds, dt) * float(traffic["time_scale"])
    p, yaw, pitch = _trajectory(t, float(traffic["rot_scale"]))
    R = _rot(yaw, pitch)
    v = np.gradient(p, dt, axis=0)
    w = _rotvec(np.einsum("nij,nik->njk", R[:-1], R[1:])) / dt
    return float(np.linalg.norm(v, axis=1).mean()), float(np.linalg.norm(w, axis=1).mean())


def _rot(yaw, pitch):
    """(n,3,3) rotations Ry(yaw) @ Rx(pitch)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    o, z = np.ones_like(yaw), np.zeros_like(yaw)
    Ry = np.stack([np.stack([cy, z, sy], -1), np.stack([z, o, z], -1),
                   np.stack([-sy, z, cy], -1)], -2)
    Rx = np.stack([np.stack([o, z, z], -1), np.stack([z, cp, -sp], -1),
                   np.stack([z, sp, cp], -1)], -2)
    return Ry @ Rx


def _rotvec(R):
    """(n,3) axis-angle of (n,3,3) rotations (the angles here are far from pi)."""
    c = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    ang = np.arccos(c)
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    s = np.sin(ang)
    scale = np.where(s > 1e-12, ang / (2.0 * np.where(s > 1e-12, s, 1.0)), 0.5)
    return w * scale[:, None]


def render(cam: Camera, R_w_f, t_w_f, pts, intens):
    """Splat the scene points into (F,H,W) float32 images of one camera for
    F body poses (R_w_f (F,3,3), t_w_f (F,3)), all on the points' device:
    each point is a sharp core plus a soft halo, so coarse pyramid levels
    keep signal."""
    dev = pts.device
    R_f_s = torch.as_tensor(cam.R_f_s, dtype=torch.float32, device=dev)
    t_f_s = torch.as_tensor(cam.t_f_s, dtype=torch.float32, device=dev)
    p_f = torch.einsum("fnj,fji->fni", pts[None] - t_w_f[:, None], R_w_f)  # R^T (p - t)
    p_c = (p_f - t_f_s) @ R_f_s
    z = p_c[..., 2]
    u = cam.fx * p_c[..., 0] / torch.clamp(z, min=0.1) + cam.cx
    v = cam.fy * p_c[..., 1] / torch.clamp(z, min=0.1) + cam.cy
    W, H = cam.width, cam.height
    vis = (z > 0.3) & (u > -12) & (u < W + 12) & (v > -12) & (v < H + 12)
    w = torch.where(vis, intens[None], torch.zeros_like(z))
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    img = torch.zeros((R_w_f.shape[0], H, W), dtype=torch.float32, device=dev)
    for sigma, amp in ((1.6, 1.0), (5.0, 0.55)):
        gx = torch.exp(-0.5 * ((xs - u[..., None]) / sigma) ** 2)  # (F,N,W)
        gy = torch.exp(-0.5 * ((ys - v[..., None]) / sigma) ** 2)  # (F,N,H)
        img = img + amp * torch.einsum("fnh,fnw->fhw", gy * w[..., None], gx)
    return torch.clamp(img, 0.0, 255.0)


def make_world(cfg: dict, traffic: dict, seed: int, n_frames: int, device) -> World:
    """The world of configuration ``cfg`` under traffic mix ``traffic``:
    ``n_frames`` frames at the configuration's ``fps``, its IMU at
    ``imu.rate_hz``, rendered on ``device``."""
    if traffic["trajectory"] != "default":
        raise ValueError(f"trajectory {traffic['trajectory']!r}: only 'default' is generated")
    cams = cameras_of(cfg)
    noise = imu_noise(cfg)
    fps, imu_rate = float(cfg["fps"]), noise["rate_hz"]
    rng = np.random.default_rng(seed)
    n_points = int(traffic["n_points"])
    g = np.array([0.0, 0.0, -GRAVITY])

    wall_x = (-5.0, 5.0)
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
    p_d, yaw_d, pitch_d = _trajectory(t_dense * float(traffic["time_scale"]),
                                      float(traffic["rot_scale"]))
    R_d = _rot(yaw_d, pitch_d)
    v_d = np.gradient(p_d, dt_imu, axis=0)
    a_d = np.gradient(v_d, dt_imu, axis=0)
    w_d = np.zeros((len(t_dense), 3))
    w_d[:-1] = _rotvec(np.einsum("nij,nik->njk", R_d[:-1], R_d[1:])) / dt_imu
    w_d[-1] = w_d[-2]

    idx = np.arange(n_frames) * n_sub
    gt_R, gt_t, gt_v = R_d[idx], p_d[idx], v_d[idx]
    pts_t = torch.as_tensor(pts, device=device)
    intens_t = torch.as_tensor(intens, device=device)
    images = np.empty((n_frames, len(cams), cams[0].height, cams[0].width), np.uint8)
    for f0 in range(0, n_frames, RENDER_CHUNK):
        sl = slice(f0, min(f0 + RENDER_CHUNK, n_frames))
        R_t = torch.as_tensor(gt_R[sl], dtype=torch.float32, device=device)
        t_t = torch.as_tensor(gt_t[sl], dtype=torch.float32, device=device)
        chunk = torch.stack([render(c, R_t, t_t, pts_t, intens_t) for c in cams], 1)
        images[sl] = chunk.to(torch.uint8).cpu().numpy()

    f32 = np.float32
    frames = []
    for k in range(n_frames):
        if k == 0:
            acc, gyr, dts = np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,))
        else:
            sl = slice((k - 1) * n_sub, k * n_sub)
            acc = np.einsum("nij,nj->ni", R_d[sl].transpose(0, 2, 1), a_d[sl] - g)
            gyr = w_d[sl].copy()
            if traffic["imu_noise"]:
                acc = acc.astype(f32) + (rng.standard_normal(acc.shape).astype(f32)
                                         * f32(noise["acc_noise"]) * f32(np.sqrt(imu_rate)))
                gyr = gyr.astype(f32) + (rng.standard_normal(gyr.shape).astype(f32)
                                         * f32(noise["gyr_noise"]) * f32(np.sqrt(imu_rate)))
            dts = np.full((n_sub,), dt_imu)
        frames.append(Frame(ts=k / fps, images=images[k], acc=acc.astype(f32),
                            gyr=gyr.astype(f32), dt=dts.astype(f32)))
    return World(frames=frames, gt_R=gt_R.astype(f32), gt_t=gt_t.astype(f32),
                 gt_v=gt_v.astype(f32))
