#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the LK kernel from
the sources in this checkout, checks it against its plain PyTorch version
at the main path's shapes, then drives the flagship stereo-VIO main path
(``StereoSLAM(rig, cfg, imu_params).run``) at EuRoC shapes and checks the
trajectory against ground truth.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME or /usr/local/cuda); exits
non-zero without a result when either is missing or any phase fails.  The
last line of stdout is {"ok": true, "device": {...}}; the line before it
lists each kernel with its launch count on the main path, its largest
disagreement with the plain version and both times.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FEATURES = 512  # landmark slots L of the main path
RADIUS = 5  # KLT radius: 11 x 11 patches
LEVELS = 4
N_FRAMES = 130  # VIInit fires and the window rolls within this run
UV_TOL_PX = 5e-3  # kernel vs plain, good features (fp32, different sum order)
ERR_TOL = 1e-3
ATE_TOL_M = 0.05


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _cuda_events_ms(fn, warmup=3, reps=20):
    """Median device time of fn() over reps, after warmup calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_env():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    _require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")
    _require(not torch.backends.cudnn.allow_tf32, "TF32 convolution must be off")
    return card


def phase_build():
    from sadvio_tpu_torch.ops import klt_kernel

    info = klt_kernel.build()
    print(f"build: {info['path'].name} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        print(f"build: {line}")


def make_world(device, n_frames):
    from sadvio_tpu_torch.pipeline import synthetic

    world = synthetic.make_world(seed=5, n_frames=n_frames, width=752, height=480,
                                 n_points=400, imu_noise=True, device=device)
    frames = [f._replace(images=np.clip(f.images, 0, 255).astype(np.uint8))
              for f in world.frames]
    return world, frames


def phase_kernel(frame, device):
    """lk_iterate vs lk_iterate_ref on the stereo track of one frame, with
    N=512 features and 11x11 templates on every pyramid level."""
    from sadvio_tpu_torch.frontend import detect, klt
    from sadvio_tpu_torch.ops import klt_kernel

    imgs = torch.as_tensor(frame.images, device=device).float()
    pyr0 = klt.build_pyramid(imgs[0], LEVELS)
    pyr1 = klt.build_pyramid(imgs[1], LEVELS)
    uv0, _, _ = detect.detect_features(pyr0[0], gh=8, gw=16, k_per_cell=4)
    _require(uv0.shape[0] == N_FEATURES, "detector slot count changed")
    eye = torch.eye(2, device=device).expand(N_FEATURES, 2, 2)
    rows = []
    for lvl in range(LEVELS):
        uv = (uv0 / 2.0 ** lvl).contiguous()
        T, gx, gy, nrm, good = klt._templates(pyr0[lvl], uv, eye, RADIUS, 1e-3)
        img1 = pyr1[lvl].contiguous()
        iters = 10 if lvl == 0 else 6
        run_k = lambda: klt_kernel.lk_iterate(img1, uv, T, gx, gy, nrm, iters=iters)
        run_r = lambda: klt_kernel.lk_iterate_ref(img1, uv, T, gx, gy, nrm, iters=iters)
        out_k, out_r = run_k(), run_r()
        torch.cuda.synchronize()
        fin = torch.isfinite(out_k).all(1) & torch.isfinite(out_r).all(1)
        g = good & fin
        _require(int(g.sum()) > N_FEATURES // 4, f"level {lvl}: {int(g.sum())} good features")
        _require(torch.equal(torch.isfinite(out_k), torch.isfinite(out_r)), "NaN pattern differs")
        d_uv = float((out_k[g, :2] - out_r[g, :2]).abs().max())
        d_err = float((out_k[g, 2] - out_r[g, 2]).abs().max())
        ms_r = _cuda_events_ms(run_r)
        ms_k = _cuda_events_ms(run_k)
        rows.append({"level": lvl, "H": img1.shape[0], "W": img1.shape[1], "iters": iters,
                     "good": int(g.sum()), "max_abs_err_uv": d_uv, "max_abs_err_err": d_err,
                     "ms": ms_k, "plain_ms": ms_r})
        print(f"kernel: level {lvl} {img1.shape[0]}x{img1.shape[1]} N={N_FEATURES} "
              f"S={2 * RADIUS + 1} iters={iters} good={int(g.sum())} "
              f"max|duv|={d_uv:.3e} px max|derr|={d_err:.3e} kernel {ms_k:.4f} ms "
              f"plain {ms_r:.4f} ms")
        _require(d_uv < UV_TOL_PX and d_err < ERR_TOL, f"level {lvl}: kernel disagrees")
    return rows


MAIN_CAPS = dict(K=11, L=512, P=48, pyr_levels=LEVELS, klt_radius=RADIUS)


def phase_main_path(world, frames, device, caps=MAIN_CAPS):
    from sadvio_tpu_torch.ops import klt_kernel
    from sadvio_tpu_torch.pipeline import synthetic
    from sadvio_tpu_torch.pipeline.config import Capacities, SLAMConfig
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    cfg = SLAMConfig(slam_mode="bimonovio", max_kf_number=10, min_lmk_number=40,
                     max_movement_parallax=1.0, min_movement_parallax=0.02,
                     async_health=False,
                     caps=Capacities(**caps))
    slam = StereoSLAM(world.rig, cfg, imu_params=world.imu_params, device=device)
    klt_kernel.lk_iterate.launches = 0
    frame_ms = []
    t_run = time.perf_counter()
    for f in frames:
        t0 = time.perf_counter()
        slam.process_frame(f)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    run_s = time.perf_counter() - t_run
    launches = klt_kernel.lk_iterate.launches

    est = np.asarray([t for _, _, t in slam.traj])
    _require(len(est) == len(frames), "one pose per frame expected")
    _require(np.isfinite(est).all() and all(np.isfinite(R).all() for _, R, _ in slam.traj),
             "non-finite pose")
    ate = synthetic.ate_rmse(est, world.gt_t[: len(est)])
    n_kf = len(slam.kf_traj)
    n_roll = len(slam.archived_kf)
    print(f"main path: frames={len(frames)} keyframes={n_kf} rolls={n_roll} "
          f"vi_initialized={slam.vi_initialized} ATE={ate * 1e3:.3f} mm "
          f"median frame {np.median(frame_ms):.2f} ms (kf frames included; "
          f"first frame {frame_ms[0]:.1f} ms) run {run_s:.1f} s lk_iterate launches={launches}")
    _require(slam.vi_initialized, "VIInit never fired")
    _require(n_roll >= 1, "the window never rolled")
    _require(bool(slam.priors.sp_mask.any()), "sparsified VIO prior missing")
    _require(ate < ATE_TOL_M, f"ATE {ate:.4f} m")
    _require(launches > 0, "the main path never launched the LK kernel")
    _require(slam.window.R.is_cuda and slam.window.lmk.is_cuda and slam.obs.uv.is_cuda,
             "window state left the card")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import sadvio_tpu_torch  # noqa: F401  (pins full fp32)

    device = torch.device("cuda")
    phase_env()
    phase_build()
    world, frames = make_world(device, N_FRAMES)
    rows = phase_kernel(frames[0], device)
    launches = phase_main_path(world, frames, device)
    lvl0 = rows[0]
    print(json.dumps({"kernels": [{
        "name": "lk_iterate", "route": "cuda",
        "source": "sadvio_tpu_torch/ops/csrc/lk_iterate.cu",
        "replaces": "sadvio_tpu/ops/klt_kernel.py:47",
        "launches": launches,
        "max_abs_err": max(max(r["max_abs_err_uv"], r["max_abs_err_err"]) for r in rows),
        "ms": lvl0["ms"], "plain_ms": lvl0["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
