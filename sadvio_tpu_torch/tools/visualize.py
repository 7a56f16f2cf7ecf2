"""Offline visualization: trajectory + landmark/dense-cloud renders to PNG.

Port of ``sadvio_tpu/tools/visualize.py``: the pipeline's tensors are
copied to the host and drawn with matplotlib.
Counterpart of the reference's RViz visualizer surface
(reference: ros/src/rosVisualizer.h:78-604 -- pose/trajectory markers,
local+global clouds, mesh triangle lists), without ROS: the same
artifacts are rendered to PNG with matplotlib:

    python -m sadvio_tpu_torch.tools.visualize log_slam/results.csv out.png
or programmatically via plot_run(slam, path).
"""

from __future__ import annotations

import sys

import numpy as np


def _load_results_csv(path):
    rows = []
    for line in open(path):
        vals = [float(x) for x in line.strip().split(",")]
        rows.append((vals[0], np.asarray(vals[1:]).reshape(3, 4)))
    ts = np.asarray([r[0] for r in rows])
    t = np.stack([r[1][:, 3] for r in rows])
    return ts, t


def plot_trajectory(t_est, path, t_gt=None, cloud=None, title="trajectory"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 4.5))
    ax1 = fig.add_subplot(1, 2, 1)
    ax1.plot(t_est[:, 0], t_est[:, 1], "-", lw=1.5, label="estimate")
    if t_gt is not None:
        ax1.plot(t_gt[:, 0], t_gt[:, 1], "--", lw=1.0, label="ground truth")
    if cloud is not None and len(cloud):
        ax1.scatter(cloud[:, 0], cloud[:, 1], s=0.3, alpha=0.25, label="cloud")
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax1.set_aspect("equal", adjustable="datalim")
    ax1.legend(fontsize=8)
    ax1.set_title(f"{title} (top view)")

    ax2 = fig.add_subplot(1, 2, 2)
    s = np.arange(len(t_est))
    for i, lbl in enumerate("xyz"):
        ax2.plot(s, t_est[:, i], lw=1.0, label=f"est {lbl}")
        if t_gt is not None:
            ax2.plot(s, t_gt[: len(s), i], "--", lw=0.7)
    ax2.set_xlabel("frame")
    ax2.set_ylabel("position [m]")
    ax2.legend(fontsize=8)
    ax2.set_title("per-axis position")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    return path


def plot_run(slam, path, world=None):
    """Render a finished pipeline run (+ mesh cloud when present)."""
    t_est = np.asarray([t for _, _, t in slam.traj])
    t_gt = world.gt_t[: len(t_est)] if world is not None else None
    cloud = None
    mesher = getattr(slam, "mesher", None)
    if mesher is not None:
        cloud = mesher.dense_points()
    return plot_trajectory(t_est, path, t_gt=t_gt, cloud=cloud)


def plot_feature_overlay(img, uv, valid, path, uv_kf=None, has3d=None,
                         title="tracked features"):
    """Tracked-feature image overlay (the reference visualizer's drawn-match
    image, rosVisualizer.h:84-95): current feature positions over the frame,
    flow tails from the last keyframe, landmark-backed tracks highlighted."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    uv = np.asarray(uv)
    valid = np.asarray(valid).astype(bool)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 100, img.shape[0] / 100),
                           dpi=100)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if uv_kf is not None:
        uv_kf = np.asarray(uv_kf)
        for a, b in zip(uv_kf[valid], uv[valid]):
            ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="#2dd4bf", lw=0.6)
    if has3d is not None:
        h = np.asarray(has3d).astype(bool)
        ax.plot(uv[valid & ~h, 0], uv[valid & ~h, 1], ".", color="#facc15",
                ms=3, label="2D track")
        ax.plot(uv[valid & h, 0], uv[valid & h, 1], ".", color="#34d399",
                ms=3, label="landmark")
    else:
        ax.plot(uv[valid, 0], uv[valid, 1], ".", color="#34d399", ms=3)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.set_axis_off()
    ax.set_title(title, fontsize=8)
    fig.tight_layout(pad=0.1)
    fig.savefig(path, dpi=100)
    return path


def plot_mesh_wireframe(img, uv_vertices, tri, tri_mask, path,
                        title="mesh wireframe"):
    """Projected mesh-triangle wireframe over the camera image (the
    reference visualizer's mesh triangle-list markers,
    rosVisualizer.h:195-565 publishMesh)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    uv = np.asarray(uv_vertices)
    tri = np.asarray(tri)
    tm = np.asarray(tri_mask).astype(bool)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 100, img.shape[0] / 100),
                           dpi=100)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    for a, b, c in tri[tm]:
        pts = uv[[a, b, c, a]]
        ax.plot(pts[:, 0], pts[:, 1], "-", color="#60a5fa", lw=0.5)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.set_axis_off()
    ax.set_title(title, fontsize=8)
    fig.tight_layout(pad=0.1)
    fig.savefig(path, dpi=100)
    return path


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def snapshot(slam, frame, out_prefix):
    """Live-pipeline snapshot: feature overlay (+ mesh wireframe when the
    mesher is on).  Returns the list of written files."""
    from sadvio_tpu_torch.models import cameras

    written = []
    img0 = np.asarray(frame.images[0])
    tr = slam.tracks
    written.append(plot_feature_overlay(
        img0, _host(tr.uv[0]), _host(tr.valid[0]), f"{out_prefix}_features.png",
        uv_kf=_host(tr.uv_kf[0]), has3d=_host(tr.has3d)))
    mesher = getattr(slam, "mesher", None)
    if mesher is not None and getattr(mesher, "tri", None) is not None:
        uvp, _ = cameras.project_world(slam.rig.cam.camera(0), slam.R_cur, slam.t_cur,
                                       slam.rig.R_f_s[0], slam.rig.t_f_s[0], slam.window.lmk)
        written.append(plot_mesh_wireframe(img0, _host(uvp), _host(mesher.tri),
                                           _host(mesher.tri_mask), f"{out_prefix}_mesh.png"))
    return written


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    ts, t = _load_results_csv(argv[0])
    plot_trajectory(t, argv[1], title=argv[0])
    print(f"wrote {argv[1]} ({len(t)} poses)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
