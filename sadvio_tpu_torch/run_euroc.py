"""Offline entry point: replay a EuRoC sequence with the pipeline the config
names, and write ``log_slam/``.

Port of ``sadvio_tpu/run_euroc.py``.

Usage:
    python -m sadvio_tpu_torch.run_euroc <config_dir> <euroc_dir> [max_frames]
        [--device cpu|cuda] [--profile]

``config_dir`` holds ``config.yaml`` and ``dataset.yaml`` (or
``dataset/eth.yaml``), in the reference's layouts (``pipeline/config.py``).
The pipeline runs on the CUDA card unless ``--device`` names another
device.  Frames come from the native prefetching loader when it builds
(``pipeline/native_io.py``), else from the Python provider; the line
``[native loader]`` or ``[python loader]`` says which.  ``log_slam/`` is
written into the working directory; ``--profile`` adds ``slam_profiler.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from sadvio_tpu_torch.utils.profiler import Profiler
from sadvio_tpu_torch.utils.struct import entry_device


def build_slam(cfg, rig, imu_params, device=None):
    """The pipeline class of ``cfg.slam_mode`` on ``device`` (None: the card)."""
    from sadvio_tpu_torch.pipeline.mono import MonoSLAM
    from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    mode = cfg.slam_mode
    if mode in ("mono", "monovio"):
        return MonoSLAM(rig, cfg, imu_params=imu_params, device=device)
    if mode == "nofov":
        return NoFovSLAM(rig, cfg, imu_params=imu_params, device=device)
    if mode in ("bimono", "bimonovio"):
        return StereoSLAM(rig, cfg, imu_params=imu_params, device=device)
    raise SystemExit(f"unknown slam_mode: {mode}")


def load_configs(config_dir):
    """(SLAMConfig, DatasetConfig or None) of a config directory."""
    from sadvio_tpu_torch.pipeline import config as cfg_mod

    cfg = cfg_mod.load_slam_config(os.path.join(config_dir, "config.yaml"))
    for cand in ("dataset.yaml", os.path.join("dataset", "eth.yaml")):
        p = os.path.join(config_dir, cand)
        if os.path.exists(p):
            return cfg, cfg_mod.load_dataset_config(p)
    return cfg, None


def imu_params_of(dataset):
    from sadvio_tpu_torch.models import imu as imu_mod

    if dataset is None or dataset.imu is None:
        return None
    i = dataset.imu
    return imu_mod.ImuParams(acc_noise=i.acc_noise, gyr_noise=i.gyr_noise,
                             acc_walk=i.acc_walk, gyr_walk=i.gyr_walk, rate_hz=i.rate_hz)


def open_provider(data_dir, dataset, contrast, device):
    """The native loader when it builds, else the Python provider; returns
    (provider, "native" | "python")."""
    from sadvio_tpu_torch.pipeline import euroc
    from sadvio_tpu_torch.pipeline.native_io import NativeEurocProvider

    try:
        provider = NativeEurocProvider(data_dir, dataset=dataset, contrast=contrast,
                                       device=device)
        print(f"[native loader] {provider.n_frames} synced frames")
        return provider, "native"
    except (RuntimeError, FileNotFoundError) as e:
        print(f"[python loader] (native unavailable: {e})")
        return euroc.EurocProvider(data_dir, dataset=dataset, contrast=contrast,
                                   device=device), "python"


def replay(config_dir, euroc_dir, max_frames=None, device=None, profile=False,
           log_dir="log_slam"):
    """Build the config's pipeline on ``device``, replay the sequence through
    it, and write ``log_dir``.  Returns (slam, frames, loader, seconds of the
    frame loop)."""
    from sadvio_tpu_torch.pipeline import euroc

    device = entry_device(device)
    cfg, dataset = load_configs(config_dir)
    if dataset is None or not dataset.cameras:
        raise SystemExit("a dataset yaml with camera calibration is required")
    provider, loader = open_provider(euroc_dir, dataset, cfg.contrast_enhancer, device)
    slam = build_slam(cfg, euroc.rig_from_dataset(dataset, device), imu_params_of(dataset),
                      device)
    if profile:
        slam._prof = Profiler()
    t0 = time.perf_counter()
    n = slam.drive(provider.frames(max_frames=max_frames), log_every=50)
    dt = time.perf_counter() - t0
    print(f"{n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)")
    slam.write_logs(log_dir, n_frames=n)
    print(f"wrote {log_dir}/results.csv, vio_poses.csv")
    return slam, n, loader, dt


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sadvio_tpu_torch.run_euroc",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("config_dir")
    ap.add_argument("euroc_dir")
    ap.add_argument("max_frames", nargs="?", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="time every stage and write log_slam/slam_profiler.txt")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    replay(args.config_dir, args.euroc_dir, args.max_frames, args.device, args.profile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
