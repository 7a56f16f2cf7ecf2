"""The reference's configuration, rig and IMU noise, made from a
configuration file's keys by the reference's own types."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.data.window import Rig
from portbench.reference.models.cameras import Pinhole
from portbench.reference.models.imu import ImuParams


@dataclass(frozen=True)
class Caps:
    K: int
    L: int
    P: int
    pyr_levels: int
    klt_radius: int


@dataclass(frozen=True)
class Feature:
    n_per_cell: int


@dataclass(frozen=True)
class Config:
    """The keys the stages read."""

    slam_mode: str
    tracker: str
    pose_estimator: str
    optimizer: str
    ba_iterations: int
    marginalization: bool
    sparsification: bool
    marg_f64: bool
    features: tuple
    caps: Caps


def config(cfg: dict) -> Config:
    c = cfg["capacities"]
    return Config(
        slam_mode=cfg["slam_mode"], tracker=cfg["tracker"], pose_estimator=cfg["pose_estimator"],
        optimizer=cfg["optimizer"], ba_iterations=int(cfg["ba_iterations"]),
        marginalization=bool(int(cfg["marginalization"])),
        sparsification=bool(int(cfg["sparsification"])), marg_f64=bool(int(cfg["marg_f64"])),
        features=tuple(Feature(int(f["number_kept"])) for f in cfg["features_handled"]),
        caps=Caps(K=int(cfg["max_kf_number"]) + 1, L=int(c["L"]), P=int(c["P"]),
                  pyr_levels=int(c["pyr_levels"]), klt_radius=int(c["klt_radius"])))


def rig(cfg: dict, device) -> Rig:
    cams = [cfg[f"cam{c}"] for c in range(int(cfg["ncam"]))]
    col = lambda i: torch.tensor([float(c["intrinsics"][i]) for c in cams], dtype=torch.float32,
                                 device=device)
    T = np.stack([np.asarray(c["T_BS"], np.float64).reshape(4, 4) for c in cams])
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    w, h = cams[0]["resolution"]
    return Rig(cam=Pinhole(fx=col(0), fy=col(1), cx=col(2), cy=col(3), width=int(w),
                           height=int(h)), R_f_s=f32(T[:, :3, :3]), t_f_s=f32(T[:, :3, 3]))


def imu_params(cfg: dict) -> ImuParams:
    imu = cfg["imu"]
    return ImuParams(acc_noise=float(imu["accelerometer_noise_density"]),
                     gyr_noise=float(imu["gyroscope_noise_density"]),
                     acc_walk=float(imu["accelerometer_random_walk"]),
                     gyr_walk=float(imu["gyroscope_random_walk"]), rate_hz=float(imu["rate_hz"]))
