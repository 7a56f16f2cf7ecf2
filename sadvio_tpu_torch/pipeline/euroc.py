"""EuRoC MAV dataset provider: CSV parsing, stereo and IMU sync, undistortion,
contrast enhancement, and the log writers.

Port of ``sadvio_tpu/pipeline/euroc.py``.  Timestamps are parsed with the
same float64 arithmetic (``float(ns) * 1e-9``), so both packages read
bit-equal stamps.  Undistortion is a precomputed remap grid applied as one
bilinear gather, and the contrast enhancers build their histograms with
``torch.bincount`` (exact integer counts); both run on the device the
provider is given (the CUDA card by default).  Frames leave the provider as
uint8 images on the host, as in the JAX package.

``write_sequence`` and ``write_dataset_yaml`` write frames and a rig in the
same layout, so a synthetic world can be replayed through the entry point
(``run_euroc``) like a recorded sequence.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, Optional

import numpy as np
import torch

from sadvio_tpu_torch.data.window import Rig
from sadvio_tpu_torch.frontend.detect import bilinear_sample
from sadvio_tpu_torch.models import cameras
from sadvio_tpu_torch.pipeline.config import DatasetConfig
from sadvio_tpu_torch.pipeline.synthetic import FrameData
from sadvio_tpu_torch.utils.struct import entry_device

NS = 1e-9


def _read_csv(path):
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append(row)
    return rows


def load_imu_csv(path):
    """imu0/data.csv -> (ts (N,), gyr (N,3), acc (N,3)).  EuRoC column order
    is [ts, wx, wy, wz, ax, ay, az]."""
    rows = _read_csv(path)
    a = np.asarray([[float(x) for x in r] for r in rows], np.float64)
    return a[:, 0] * NS, a[:, 1:4], a[:, 4:7]


def load_cam_csv(path):
    """camN/data.csv -> (ts (N,), filenames)."""
    rows = _read_csv(path)
    ts = np.asarray([float(r[0]) for r in rows], np.float64) * NS
    names = [r[1].strip() for r in rows]
    return ts, names


def _load_image(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


# ---------------------------------------------------------------------------
# undistortion and contrast enhancement (device)
# ---------------------------------------------------------------------------


def undistort_grid(calib, new_f=None):
    """Precomputed remap grid for radtan undistortion (one-time, host).

    Returns (map_uv (H,W,2) float32 source coordinates, pinhole intrinsics
    of the rectified image)."""
    fx, fy, cx, cy = calib.intrinsics[:4]
    k1, k2, p1, p2 = (list(calib.distortion) + [0.0] * 4)[:4]
    W, H = calib.width, calib.height
    nf = new_f or fx
    xs = (np.arange(W) - cx) / nf
    ys = (np.arange(H) - cy) / nf
    gx, gy = np.meshgrid(xs, ys)
    r2 = gx * gx + gy * gy
    rad = 1 + k1 * r2 + k2 * r2 * r2
    dx = 2 * p1 * gx * gy + p2 * (r2 + 2 * gx * gx)
    dy = p1 * (r2 + 2 * gy * gy) + 2 * p2 * gx * gy
    u = fx * (gx * rad + dx) + cx
    v = fy * (gy * rad + dy) + cy
    return np.stack([u, v], -1).astype(np.float32), (nf, nf, cx, cy)


def remap(img, map_uv):
    """Apply a remap grid (H,W,2) to an image with bilinear sampling."""
    return bilinear_sample(img, map_uv)


def clahe(img, tiles: int = 8, clip: float = 2.0, bins: int = 64):
    """Contrast-limited adaptive histogram equalization: one clipped
    histogram per tile, and each pixel's value from the bilinear blend of
    the four nearest tiles' transfer functions."""
    img = img.to(torch.float32)
    dev = img.device
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    x = img[: th * tiles, : tw * tiles].reshape(tiles, th, tiles, tw)
    x = x.permute(0, 2, 1, 3).reshape(tiles * tiles, th * tw)
    q = torch.clamp(x / 256.0 * bins, 0, bins - 1).long()
    tile = torch.arange(tiles * tiles, device=dev)[:, None]
    hist = torch.bincount((tile * bins + q).reshape(-1), minlength=tiles * tiles * bins)
    hist = hist.reshape(tiles * tiles, bins).to(torch.float32)
    limit = clip * th * tw / bins
    excess = torch.clamp(hist - limit, min=0.0).sum(1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / bins
    cdf = torch.cumsum(hist, 1)
    cdf = cdf / cdf[:, -1:]
    lut = (cdf * 255.0).reshape(tiles, tiles, bins)

    yy = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xx = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(yy).long(), 0, tiles - 1)
    x0 = torch.clamp(torch.floor(xx).long(), 0, tiles - 1)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    wy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    qi = torch.clamp(img / 256.0 * bins, 0, bins - 1).long()
    g = lambda ty, tx: lut[ty[:, None], tx[None, :], qi]
    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
            + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)


def _histogram(q, bins):
    return torch.bincount(q.reshape(-1), minlength=bins).to(torch.float32)


def hist_equalize(img, bins: int = 256):
    """Global histogram equalization."""
    q = torch.clamp(img.to(torch.float32), 0, 255).long()
    cdf = torch.cumsum(_histogram(q, bins), 0)
    cdf = (cdf - cdf[0]) / torch.clamp(cdf[-1] - cdf[0], min=1.0)
    return cdf[q] * 255.0


def agcwd(img, alpha: float = 0.5, bins: int = 256):
    """Adaptive gamma correction with weighting distribution: the gamma of
    each intensity from the alpha-weighted histogram CDF."""
    img = img.to(torch.float32)
    q = torch.clamp(img, 0, 255).long()
    hist = _histogram(q, bins)
    pdf = hist / torch.clamp(hist.sum(), min=1.0)
    pdf_w = pdf.max() * ((pdf / torch.clamp(pdf.max(), min=1e-12)) ** alpha)
    cdf_w = torch.cumsum(pdf_w, 0) / torch.clamp(pdf_w.sum(), min=1e-12)
    levels = torch.arange(bins, dtype=img.dtype, device=img.device) / (bins - 1)
    lut = 255.0 * levels ** (1.0 - cdf_w)
    return lut[q]


def enhance_contrast(img, method: str):
    """Dispatch on the config's ``contrast_enhancer`` string."""
    if method in (None, "", "none"):
        return img
    if method == "clahe":
        return clahe(img)
    if method in ("histogram", "histeq"):
        return hist_equalize(img)
    if method == "agcwd":
        return agcwd(img)
    raise ValueError(f"unknown contrast enhancer: {method}")


def rig_from_dataset(ds: DatasetConfig, device=None) -> Rig:
    """Rig from a DatasetConfig (EuRoC T_BS is body-from-sensor = T_f_s), on
    ``device`` (None: the CUDA card).  The camera model of the calibration
    picks the class: pinhole | fisheye (equidistant, k1..k4) | double_sphere
    (fx fy cx cy xi alpha) | omni (fx fy cx cy xi + radtan).  The cameras of
    one rig share a model."""
    device = entry_device(device)
    kinds = {c.model for c in ds.cameras}
    if len(kinds) != 1:
        raise ValueError(f"mixed camera models in one rig: {sorted(kinds)}")
    kind = kinds.pop()

    def col(i, default=None, from_dist=None):
        vals = []
        for c in ds.cameras:
            if i < len(c.intrinsics):
                vals.append(c.intrinsics[i])
            elif from_dist is not None and from_dist < len(c.distortion):
                vals.append(c.distortion[from_dist])
            elif default is not None:
                vals.append(default)
            else:
                raise ValueError(f"{kind} calibration needs intrinsics[{i}]")
        return torch.tensor(vals, dtype=torch.float32, device=device)

    base = dict(fx=col(0), fy=col(1), cx=col(2), cy=col(3),
                width=ds.cameras[0].width, height=ds.cameras[0].height)
    if kind == "pinhole":
        model = cameras.Pinhole(**base)
    elif kind == "fisheye":
        # k1..k4 follow fx fy cx cy in intrinsics, or live in the
        # distortion coefficients: both spellings occur
        model = cameras.Fisheye(**base, k1=col(4, 0.0, 0), k2=col(5, 0.0, 1),
                                k3=col(6, 0.0, 2), k4=col(7, 0.0, 3))
    elif kind == "double_sphere":
        model = cameras.DoubleSphere(**base, xi=col(4), alpha=col(5))
    elif kind == "omni":
        model = cameras.Omni(**base, xi=col(4), k1=col(5, 0.0, 0), k2=col(6, 0.0, 1),
                             p1=col(7, 0.0, 2), p2=col(8, 0.0, 3))
    else:
        raise ValueError(f"unknown camera model '{kind}'")
    Ts = np.stack([np.asarray(c.T_f_s, np.float64).reshape(4, 4) for c in ds.cameras])
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return Rig(cam=model, R_f_s=f32(Ts[:, :3, :3]), t_f_s=f32(Ts[:, :3, 3]))


def undistort_maps(dataset: Optional[DatasetConfig], device):
    """Per camera, the radtan remap grid on ``device`` or None, or None for
    the whole rig when no camera needs one: only the pinhole path
    undistorts ahead of the pipeline; the wide-angle models keep their
    distortion inside the projection."""
    if dataset is None or not dataset.cameras:
        return None
    maps = [torch.as_tensor(undistort_grid(c)[0], device=device)
            if c.model == "pinhole" and any(abs(d) > 1e-12 for d in c.distortion[:4]) else None
            for c in dataset.cameras]
    return maps if any(m is not None for m in maps) else None


def prepare_images(imgs, maps, contrast, device):
    """Undistort and enhance a frame's images on ``device``; (C,H,W) uint8
    on the host.  With neither, the images are only clipped and cast."""
    imgs = np.stack(imgs).astype(np.float32)
    if maps is not None or contrast not in (None, "", "none"):
        t = torch.as_tensor(imgs, device=device)
        out = []
        for c in range(t.shape[0]):
            im = t[c]
            if maps is not None and maps[c] is not None:
                im = remap(im, maps[c])
            out.append(enhance_contrast(im, contrast))
        imgs = torch.clamp(torch.stack(out), 0, 255).to(torch.uint8).cpu().numpy()
    # truncation toward zero, as numpy's astype after the JAX provider's clip
    return np.clip(imgs, 0, 255).astype(np.uint8)


class EurocProvider:
    """Frame stream from an EuRoC MAV directory (mav0/...).

    Yields FrameData with stereo-synced images (2.5 ms tolerance, 20 ms
    stereo gate) as (2,H,W) uint8 and the IMU batch since the previous
    frame.  Undistortion and contrast enhancement run on ``device`` (None:
    the CUDA card); a provider that does neither never touches a device."""

    def __init__(self, root: str, dataset: Optional[DatasetConfig] = None,
                 contrast: str = "none", undistort: bool = True, device=None):
        m = os.path.join(root, "mav0") if os.path.isdir(os.path.join(root, "mav0")) else root
        self.root = m
        self.ts_imu, self.gyr, self.acc = load_imu_csv(os.path.join(m, "imu0", "data.csv"))
        self.ts0, self.names0 = load_cam_csv(os.path.join(m, "cam0", "data.csv"))
        self.ts1, self.names1 = load_cam_csv(os.path.join(m, "cam1", "data.csv"))
        self.dataset = dataset
        self.contrast = contrast
        maps = undistort_maps(dataset, "cpu") if undistort else None
        self.device = (entry_device(device)
                       if maps is not None or contrast not in (None, "", "none") else None)
        self.maps = None if maps is None else [m if m is None else m.to(self.device)
                                               for m in maps]

    def make_rig(self, device=None) -> Rig:
        return rig_from_dataset(self.dataset, device)

    def frames(self, max_frames: Optional[int] = None) -> Iterator[FrameData]:
        j1 = 0
        last_t = None
        i_imu = 0
        n_done = 0
        for i0, t0 in enumerate(self.ts0):
            # stereo partner within 20 ms
            while j1 + 1 < len(self.ts1) and self.ts1[j1] < t0 - 0.0025:
                j1 += 1
            if abs(self.ts1[j1] - t0) > 0.020:
                continue
            imgs = [_load_image(os.path.join(self.root, "cam0", "data", self.names0[i0])),
                    _load_image(os.path.join(self.root, "cam1", "data", self.names1[j1]))]
            # IMU batch covering (last_t, t0]
            k0 = i_imu
            while i_imu < len(self.ts_imu) and self.ts_imu[i_imu] <= t0:
                i_imu += 1
            if last_t is None:
                acc = np.zeros((0, 3), np.float32)
                gyr = np.zeros((0, 3), np.float32)
                dts = np.zeros((0,), np.float32)
            else:
                sel = slice(k0, i_imu)
                tsb = self.ts_imu[sel]
                prev = np.concatenate([[last_t], tsb[:-1]])
                dts = (tsb - prev).astype(np.float32)
                acc = self.acc[sel].astype(np.float32)
                gyr = self.gyr[sel].astype(np.float32)
            last_t = t0
            yield FrameData(ts=float(t0),
                            images=prepare_images(imgs, self.maps, self.contrast, self.device),
                            acc=acc, gyr=gyr, dt=dts)
            n_done += 1
            if max_frames is not None and n_done >= max_frames:
                return


# ---------------------------------------------------------------------------
# log writers
# ---------------------------------------------------------------------------


def write_results_csv(path, kf_traj):
    """log_slam/results.csv: per keyframe, ts and the 3x4 [R|t] row-major."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for ts, R, t in kf_traj:
            M = np.concatenate([np.asarray(R), np.asarray(t)[:, None]], 1)
            f.write(",".join([f"{ts:.9f}"] + [f"{x:.9f}" for x in M.reshape(-1)]) + "\n")


def write_vio_csv(path, rows):
    """log_slam/vio_poses.csv: per frame, (ts, t, v, ba, bg) with VIO, else
    (ts, t)."""
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(f"{x:.9f}" for x in r) + "\n")


# ---------------------------------------------------------------------------
# writing a sequence in the EuRoC layout
# ---------------------------------------------------------------------------


def write_sequence(root, frames, t0: float = 1.0):
    """Write stereo frames and their IMU batches as ``root/mav0``: uint8 PNGs
    named by nanosecond stamps ``int((t0 + ts) * 1e9)``, cam0/cam1 and
    imu0 ``data.csv`` (the IMU stamps accumulate the frames' ``dt``).
    Returns the directory that holds ``mav0``."""
    from PIL import Image

    mav = os.path.join(root, "mav0")
    for c in (0, 1):
        d = os.path.join(mav, f"cam{c}", "data")
        os.makedirs(d, exist_ok=True)
        rows = ["#ts,filename"]
        for f in frames:
            ts_ns = int((t0 + f.ts) * 1e9)
            name = f"{ts_ns}.png"
            Image.fromarray(np.asarray(f.images[c]).astype(np.uint8), "L").save(
                os.path.join(d, name), compress_level=1)
            rows.append(f"{ts_ns},{name}")
        with open(os.path.join(mav, f"cam{c}", "data.csv"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    rows = ["#ts,wx,wy,wz,ax,ay,az"]
    t_abs = t0
    for f in frames:
        for k in range(len(f.dt)):
            t_abs += float(f.dt[k])
            vals = [*np.asarray(f.gyr[k]).tolist(), *np.asarray(f.acc[k]).tolist()]
            rows.append(",".join([str(int(t_abs * 1e9))] + [f"{v:.7f}" for v in vals]))
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return root


def write_dataset_yaml(path, rig: Rig, imu_params=None, rate_hz: float = 200.0):
    """dataset.yaml of a pinhole rig (and the IMU's noise densities)."""
    cam = rig.cam
    R, t = rig.R_f_s.cpu().numpy().astype(np.float64), rig.t_f_s.cpu().numpy().astype(np.float64)
    text = f"ncam: {rig.C}\n"
    for i in range(rig.C):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R[i], t[i]
        text += (f"cam{i}:\n  camera_model: pinhole\n  resolution: [{cam.width}, {cam.height}]\n"
                 f"  intrinsics: [{float(cam.fx[i])}, {float(cam.fy[i])}, {float(cam.cx[i])},"
                 f" {float(cam.cy[i])}]\n  distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
                 f"  T_BS:\n    data: {T.reshape(-1).tolist()}\n")
    ip = imu_params
    noise = ((2.0e-3, 1.7e-4, 3.0e-3, 2.0e-5) if ip is None
             else (ip.acc_noise, ip.gyr_noise, ip.acc_walk, ip.gyr_walk))
    text += (f"imu0:\n  rate_hz: {float(rate_hz if ip is None else ip.rate_hz)}\n"
             f"  accelerometer_noise_density: {float(noise[0])}\n"
             f"  gyroscope_noise_density: {float(noise[1])}\n"
             f"  accelerometer_random_walk: {float(noise[2])}\n"
             f"  gyroscope_random_walk: {float(noise[3])}\n"
             f"  T_BS:\n    data: {np.eye(4).reshape(-1).tolist()}\n")
    with open(path, "w") as f:
        f.write(text)
