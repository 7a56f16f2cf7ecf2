"""EuRoC comparison protocol: the reference binary against the port, one
command.

Port of ``tools/compare_euroc.py``: run both systems on the same sequence,
score both trajectories (``log_slam/results.csv``) against the sequence's
ground truth, and write one ATE / fps table.

Usage:
    python -m sadvio_tpu_torch.tools.compare_euroc --dataset /data/V1_01_easy \\
        [--config configs/euroc_bimonovio] [--device cpu] \\
        [--ref-bin /opt/isae_slam/build/isae_slam --ref-config /opt/.../config] \\
        [--gt /data/V1_01_easy/mav0/state_groundtruth_estimate0/data.csv] \\
        [--max-frames 500] [--out compare_out]

Without ``--ref-bin`` only the port's row is produced.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SYSTEM = "sadvio_tpu_torch"


def load_results_csv(path):
    """results.csv rows: ts, then the 3x4 [R|t] row-major."""
    ts, pos = [], []
    for line in open(path):
        parts = line.strip().split(",")
        if len(parts) < 13:
            continue
        ts.append(float(parts[0]))
        pos.append(np.asarray([float(x) for x in parts[1:13]]).reshape(3, 4)[:, 3])
    return np.asarray(ts), np.asarray(pos)


def load_euroc_gt(path):
    """EuRoC state_groundtruth_estimate0/data.csv: ts[ns], p(3), q(4), ..."""
    ts, pos = [], []
    for line in open(path):
        if line.startswith("#"):
            continue
        parts = line.strip().split(",")
        if len(parts) < 4:
            continue
        ts.append(float(parts[0]) * 1e-9)
        pos.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(ts), np.asarray(pos)


def associate(ts_est, p_est, ts_gt, p_gt, max_dt=0.05):
    """Nearest-timestamp association (the TUM evaluation pairing)."""
    idx = np.searchsorted(ts_gt, ts_est)
    pairs_e, pairs_g = [], []
    for i, t in enumerate(ts_est):
        cands = [j for j in (idx[i] - 1, idx[i]) if 0 <= j < len(ts_gt)]
        if not cands:
            continue
        j = min(cands, key=lambda j: abs(ts_gt[j] - t))
        if abs(ts_gt[j] - t) <= max_dt:
            pairs_e.append(p_est[i])
            pairs_g.append(p_gt[j])
    return np.asarray(pairs_e), np.asarray(pairs_g)


def ate_vs_gt(results_csv, gt_csv):
    from sadvio_tpu_torch.pipeline.synthetic import ate_rmse

    ts_e, p_e = load_results_csv(results_csv)
    ts_g, p_g = load_euroc_gt(gt_csv)
    # results.csv may carry relative or absolute seconds: align the time
    # origins by the first-frame offset when the scales clearly differ
    if len(ts_e) and len(ts_g) and abs(ts_e[0] - ts_g[0]) > 1e3:
        ts_e = ts_e - ts_e[0] + ts_g[0]
    pe, pg = associate(ts_e, p_e, ts_g, p_g)
    if len(pe) < 3:
        return float("nan"), len(pe)
    return float(ate_rmse(pe, pg, align=True)), len(pe)


def run_port(config_dir, data_dir, out_dir, max_frames=None, device=None):
    """Replay through the port's entry point in a subprocess; returns
    (results_csv_path, wall_s, n_frames)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "sadvio_tpu_torch.run_euroc", str(config_dir), str(data_dir)]
    if max_frames:
        cmd.append(str(max_frames))
    if device:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=out_dir, check=True, env=env)
    wall = time.perf_counter() - t0
    vio = out_dir / "log_slam" / "vio_poses.csv"
    n = sum(1 for _ in open(vio)) if vio.exists() else 0
    return out_dir / "log_slam" / "results.csv", wall, n


def run_reference(ref_bin, ref_config, data_dir, out_dir):
    """Run the reference binary (argv: config dir, EuRoC dir); it writes
    log_slam/ into its working directory."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([str(ref_bin), str(ref_config), str(data_dir)], cwd=out_dir, check=True)
    wall = time.perf_counter() - t0
    res = out_dir / "log_slam" / "results.csv"
    n = sum(1 for _ in open(res)) if res.exists() else 0
    return res, wall, n


def _row(system, res, wall, n, gt):
    ate, n_pairs = ate_vs_gt(res, gt) if os.path.exists(gt) else (float("nan"), 0)
    return {"system": system, "frames": n, "wall_s": round(wall, 2),
            "fps": round(n / wall, 2) if wall > 0 else 0.0,
            "ate_m": round(ate, 4) if np.isfinite(ate) else None, "gt_pairs": n_pairs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True, help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--config", default=str(REPO / "configs" / "euroc_bimonovio"))
    ap.add_argument("--device", default=None, help="the port's device (default: the card)")
    ap.add_argument("--ref-bin", default=None,
                    help="reference isae_slam binary (no reference row without it)")
    ap.add_argument("--ref-config", default=None)
    ap.add_argument("--gt", default=None, help="ground-truth csv (default: the sequence's "
                                               "state_groundtruth_estimate0)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default="compare_out")
    args = ap.parse_args(argv)

    gt = args.gt or os.path.join(args.dataset, "mav0", "state_groundtruth_estimate0", "data.csv")
    res, wall, n = run_port(args.config, args.dataset, Path(args.out) / SYSTEM, args.max_frames,
                            args.device)
    rows = [_row(SYSTEM, res, wall, n, gt)]
    if args.ref_bin and not (os.path.isfile(args.ref_bin) and os.access(args.ref_bin, os.X_OK)):
        print(f"[compare] no executable reference binary at {args.ref_bin}; "
              "skipping the reference row")
        args.ref_bin = None
    if args.ref_bin:
        res_r, wall_r, n_r = run_reference(args.ref_bin, args.ref_config or args.config,
                                           args.dataset, Path(args.out) / "reference")
        rows.append(_row("reference", res_r, wall_r, n_r, gt))

    hdr = f"{'system':<17} {'frames':>7} {'wall[s]':>8} {'fps':>7} {'ATE[m]':>8}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        ate_s = f"{r['ate_m']:.4f}" if r["ate_m"] is not None else "n/a"
        print(f"{r['system']:<17} {r['frames']:>7} {r['wall_s']:>8.2f} {r['fps']:>7.2f} "
              f"{ate_s:>8}")
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "comparison.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
