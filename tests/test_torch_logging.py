"""The port's logs and profiler against the JAX package's.

World and config of tests/test_checkpoint.py (seed 9, 24 frames, 320x240,
bimono, K=6, L=160).  Each package runs ``run(frames, log_dir,
profile=True)`` once per module, the port on the CPU on the JAX world's
numpy frames.

Tolerances: the same files, the same ``results.csv`` row count and keyframe
stamps, the same profiler stages with the same call counts, and the same
``slam_profiler.txt`` rows (exact); positions frame by frame within
``POS_TOL_M`` (tests/test_torch_slam.py's bound: the packages draw different
RANSAC hypotheses).  ``multithreading`` gives the synchronous trajectory
within 1e-6 m.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu.utils.profiler import Profiler as JProfiler
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM
from sadvio_tpu_torch.utils.profiler import Profiler as TProfiler

torch.set_num_threads(2)

POS_TOL_M = 0.01
MT_TOL_M = 1e-6
CFG = SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=1.0, min_movement_parallax=0.02,
                 caps=Capacities(K=6, L=160, P=24, pyr_levels=3, klt_radius=5))


def _port(world, cfg, **kw):
    rig = from_numpy(jax.tree.map(np.asarray, world.rig), "cpu")
    imu = from_numpy(jax.tree.map(np.asarray, world.imu_params))
    return TSLAM(rig, cfg, imu_params=imu, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    world = jsyn.make_world(seed=9, n_frames=24, width=320, height=240, n_points=200)
    jlog = str(tmp_path_factory.mktemp("jax") / "log_slam")
    tlog = str(tmp_path_factory.mktemp("port") / "log_slam")
    js = JSLAM(world.rig, CFG)
    js.run(world.frames, log_dir=jlog, profile=True)
    ts = _port(world, CFG)
    ts.run(world.frames, log_dir=tlog, profile=True)
    return dict(world=world, js=js, ts=ts, jlog=jlog, tlog=tlog)


def _csv(path):
    return np.asarray([[float(x) for x in line.split(",")]
                       for line in open(path).read().strip().splitlines()])


def test_profiler_stage_names_and_counts():
    """The same tic/toc and stage calls give the same table rows and counts."""
    tables = []
    for prof in (JProfiler(), TProfiler()):
        prof.tic()
        x = sum(range(1000))
        prof.toc("stage_a")
        for _ in range(3):
            with prof.stage("stage_b"):
                _ = x * 2
        prof.tic()
        prof.toc("stage_c", block=torch.zeros(3) if isinstance(prof, TProfiler) else None)
        tables.append((dict(prof.counts), [ln.split()[0] for ln in prof.dump().splitlines()]))
    assert tables[0] == tables[1]
    assert tables[1][0] == {"stage_a": 1, "stage_b": 3, "stage_c": 1}


def test_run_writes_the_same_files(runs):
    assert sorted(os.listdir(runs["tlog"])) == sorted(os.listdir(runs["jlog"])) == [
        "results.csv", "slam_profiler.txt", "vio_poses.csv"]
    rj, rt = (_csv(os.path.join(runs[k], "results.csv")) for k in ("jlog", "tlog"))
    assert rt.shape == rj.shape and rt.shape[1] == 13
    assert rt.shape[0] == len(runs["ts"].kf_traj) >= 3
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])  # keyframe stamps
    vj, vt = (_csv(os.path.join(runs[k], "vio_poses.csv")) for k in ("jlog", "tlog"))
    assert vt.shape == vj.shape == (len(runs["world"].frames), 4)  # bimono: ts + position
    np.testing.assert_array_equal(vt[:, 0], vj[:, 0])


def test_run_positions_agree(runs):
    pj = np.asarray([t for _, _, t in runs["js"].traj])
    pt = np.asarray([t for _, _, t in runs["ts"].traj])
    d = np.linalg.norm(pj - pt, axis=1)
    assert d.max() < POS_TOL_M, (d.max(), d.argmax())
    rj, rt = (_csv(os.path.join(runs[k], "results.csv")) for k in ("jlog", "tlog"))
    assert np.abs(rt[:, [4, 8, 12]] - rj[:, [4, 8, 12]]).max() < POS_TOL_M
    assert tsyn.ate_rmse(pt, runs["world"].gt_t) < 0.05


def test_profiler_of_the_run_matches(runs):
    """The same stages, called the same number of times, and the same rows
    of slam_profiler.txt (its values are times and differ)."""
    assert dict(runs["ts"]._prof.counts) == dict(runs["js"]._prof.counts)
    assert runs["ts"]._prof.counts["frame_total"] == len(runs["world"].frames)
    rows = []
    for k in ("jlog", "tlog"):
        lines = open(os.path.join(runs[k], "slam_profiler.txt")).read().splitlines()
        rows.append([ln.split(":")[0] if ":" in ln else ln.split()[0] if ln.split() else ""
                     for ln in lines[2:]])  # after the header and the unix time
    assert rows[0] == rows[1]
    assert "frame_total" in rows[1]


def test_multithreading_gives_the_synchronous_trajectory(runs):
    ts = _port(runs["world"], dataclasses.replace(CFG, multithreading=True))
    assert ts.backend_exec is not None
    ts.run(runs["world"].frames)
    a = np.asarray([t for _, _, t in runs["ts"].traj])
    b = np.asarray([t for _, _, t in ts.traj])
    assert np.abs(a - b).max() <= MT_TOL_M
    assert [k for k, _, _ in ts.kf_traj] == [k for k, _, _ in runs["ts"].kf_traj]


def test_prefetch_gives_the_same_trajectory(runs):
    """The one-frame-ahead upload (off by default) changes no number."""
    ts = _port(runs["world"], CFG)
    ts.prefetch = True
    uploads = []
    upload = ts._upload_images
    ts._upload_images = lambda f: uploads.append(f.ts) or upload(f)
    ts.run(runs["world"].frames)
    assert uploads == [f.ts for f in runs["world"].frames]  # each frame once, in order
    np.testing.assert_array_equal(np.asarray([t for _, _, t in ts.traj]),
                                  np.asarray([t for _, _, t in runs["ts"].traj]))


def test_bimonovio_vio_poses_have_13_columns(runs, tmp_path):
    """(ts, t, v, ba, bg) per tracked frame (the bootstrap frame has no row,
    as in the JAX package); ba and bg are the keyframe-rate host copies."""
    world = runs["world"]
    ts = _port(world, dataclasses.replace(CFG, slam_mode="bimonovio"))
    ts.run(world.frames[:12], log_dir=str(tmp_path / "log"))
    v = _csv(tmp_path / "log" / "vio_poses.csv")
    assert v.shape == (11, 13) and np.isfinite(v).all()
    np.testing.assert_array_equal(v[:, 0], [f.ts for f in world.frames[1:12]])
    np.testing.assert_allclose(v[:, 1:4], np.asarray([t for _, _, t in ts.traj[1:]]), atol=1e-8)
    np.testing.assert_array_equal(v[-1, 7:10], ts._ba_h.astype(np.float64).round(9))


def test_nofov_rescaled_history_lands_in_results(tmp_path):
    """NoFovSLAM's first scale estimate rescales kf_traj; write_logs writes
    the rescaled trajectory."""
    from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM

    cfg = SLAMConfig(slam_mode="nofov", caps=Capacities(K=4, L=64, P=8))
    slam = NoFovSLAM(tsyn.make_nofov_rig(device="cpu"), cfg, device="cpu")
    eye = np.eye(3, dtype=np.float32)
    slam.kf_traj = [(0.1 * k, eye, np.array([k, 2.0 * k, 0.5], np.float32)) for k in range(3)]
    slam.traj = list(slam.kf_traj)
    slam._apply_scale_global(1.4)
    slam.write_logs(str(tmp_path / "log"))
    r = _csv(tmp_path / "log" / "results.csv")
    np.testing.assert_allclose(r[:, [4, 8, 12]], [[1.4 * k, 2.8 * k, 0.7] for k in range(3)],
                               atol=1e-6)
