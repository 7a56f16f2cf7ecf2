"""The system under test, built from a configuration file: the port's
``StereoSLAM`` or ``MonoSLAM`` on the configuration's rig, and the frame
loop that hands it a recorded sequence closed loop.

This module and the per-layer readers are the only parts of the benchmark
that import the program (``sadvio_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import world as world_mod

SLAM_KEYS_INT = ("min_kf_number", "max_kf_number", "fixed_frame_number", "min_lmk_number",
                 "ba_iterations")
SLAM_KEYS_FLOAT = ("min_movement_parallax", "max_movement_parallax", "max_length_tsh")
SLAM_KEYS_BOOL = ("marginalization", "sparsification", "marg_f64", "mesh3d", "multithreading",
                  "async_health")
SLAM_KEYS_STR = ("slam_mode", "tracker", "pose_estimator", "optimizer", "contrast_enhancer")


def slam_config(cfg: dict):
    """The program's SLAMConfig from a configuration file's keys, with the
    config loader's rules (``K`` = ``max_kf_number`` + 1, capacities from
    ``capacities``)."""
    from sadvio_tpu_torch.pipeline.config import Capacities, FeatureConfig, SLAMConfig

    kw = {k: str(cfg[k]) for k in SLAM_KEYS_STR if k in cfg}
    kw.update({k: int(cfg[k]) for k in SLAM_KEYS_INT if k in cfg})
    kw.update({k: float(cfg[k]) for k in SLAM_KEYS_FLOAT if k in cfg})
    kw.update({k: bool(int(cfg[k])) for k in SLAM_KEYS_BOOL if k in cfg})
    if "ZNCC_tsh" in cfg:
        kw["zncc_tsh"] = float(cfg["ZNCC_tsh"])
    kw["features"] = tuple(FeatureConfig(
        label=f["label"], detector=f["detector"], tracker=f["tracker"], matcher=f["matcher"],
        n_total=int(f["number_detected"]), n_per_cell=int(f["number_kept"]),
        max_reproj_err=float(f["max_reproj_err"])) for f in cfg["features_handled"])
    out = SLAMConfig(**kw)
    caps = {k: int(v) for k, v in cfg["capacities"].items()}
    return dataclasses.replace(out, caps=Capacities(K=out.max_kf_number + 1, **caps))


def rig(cfg: dict, device):
    """The program's Rig: pinhole cameras with the configuration's
    intrinsics and body-from-sensor extrinsics."""
    from sadvio_tpu_torch.data.window import Rig
    from sadvio_tpu_torch.models.cameras import Pinhole

    cams = world_mod.cameras_of(cfg)
    col = lambda k: torch.tensor([getattr(c, k) for c in cams], dtype=torch.float32,
                                 device=device)
    model = Pinhole(fx=col("fx"), fy=col("fy"), cx=col("cx"), cy=col("cy"),
                    width=cams[0].width, height=cams[0].height)
    f32 = lambda a: torch.as_tensor(np.stack(a).astype(np.float32), device=device)
    return Rig(cam=model, R_f_s=f32([c.R_f_s for c in cams]), t_f_s=f32([c.t_f_s for c in cams]))


def imu_params(cfg: dict):
    from sadvio_tpu_torch.models.imu import ImuParams

    return ImuParams(**world_mod.imu_noise(cfg))


def make_slam(cfg: dict, device, seed: int = 0):
    """The pipeline of the configuration's ``slam_mode`` on ``device``, its
    RANSAC generator seeded with ``seed``."""
    scfg = slam_config(cfg)
    if scfg.slam_mode in ("bimono", "bimonovio"):
        from sadvio_tpu_torch.pipeline.slam import StereoSLAM as cls
    elif scfg.slam_mode in ("mono", "monovio"):
        from sadvio_tpu_torch.pipeline.mono import MonoSLAM as cls
    else:
        raise ValueError(f"slam_mode {scfg.slam_mode!r} has no pipeline in the benchmark")
    imu = imu_params(cfg) if scfg.slam_mode.endswith("vio") else None
    return cls(rig(cfg, device), scfg, imu_params=imu, seed=seed, device=device)


def build_kernels(device) -> float:
    """Build or load the program's CUDA kernels (its own cache inside the
    checkout); seconds taken.  Nothing to build on the CPU."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        from sadvio_tpu_torch.ops import klt_kernel

        klt_kernel._library()
    return time.perf_counter() - t0


def n_variants(slam) -> int:
    return sum(len(v) for v in slam.graphs.variants.values())


class Loop:
    """The closed frame loop: frame i+1 is handed over once frame i's pose
    is on the host (``process_frame`` returns after its host read), and the
    next frame's images are uploaded during frame i, as ``drive`` does."""

    def __init__(self, slam, frames):
        self.slam = slam
        self.frames = frames
        self.i = 0
        self.pending = None

    def step(self):
        """Process the next frame; (latency s, is keyframe, output)."""
        if self.i >= len(self.frames):
            raise RuntimeError(f"the sequence ran out after {self.i} frames")
        frame = self.frames[self.i]
        nxt = self.frames[self.i + 1] if self.i + 1 < len(self.frames) else None
        t0 = time.perf_counter()
        out = self.slam.process_frame(frame, images_dev=self.pending, prefetch_frame=nxt)
        dt = time.perf_counter() - t0
        self.pending = self.slam._prefetched
        self.i += 1
        return dt, bool(out.get("is_kf")), out


def warm_up(loop: Loop, max_frames: int, settle: int) -> dict:
    """Drive until VIInit has fired (VIO), the window has rolled and a whole
    keyframe period (keyframe to keyframe) captured no new stage variant,
    then ``settle`` frames more: on an H100 machine the first seconds after
    the last capture ran slower (up to ~4 s of 9.2–10.0 ms tracking frames
    against ~8.1 ms after), and the window starts past them."""
    slam = loop.slam
    rolled = False
    quiet_from = None  # variant count at the last keyframe after which all else held
    while loop.i < max_frames:
        _, is_kf, _ = loop.step()
        if slam.n_resets:
            raise RuntimeError(f"the pipeline reset during warm-up (frame {loop.i})")
        if not is_kf:
            continue
        rolled = rolled or len(slam.archived_kf) > 0
        ready = rolled and slam.vi_initialized
        nv = n_variants(slam)
        if ready and quiet_from is not None and nv == quiet_from:
            for _ in range(settle):
                loop.step()
            return {"frames": loop.i, "variants": nv}
        quiet_from = nv if ready else None
    raise RuntimeError(f"warm-up did not settle in {max_frames} frames (rolled {rolled}, "
                       f"VIInit {slam.vi_initialized}, {n_variants(slam)} variants)")
