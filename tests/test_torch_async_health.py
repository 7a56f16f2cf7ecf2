"""``async_health``: the port's one-frame-late health harvest against the JAX
package's.

World and config of tests/test_torch_slam.py (seed 3, 40 frames, 320x240,
bimonovio, K=4, L=160, P=24, window rolls) with ``async_health`` on; each
package runs once per module on the JAX world's numpy frames.

Tolerances: keyframe frames and the per-frame lag pattern (``pose_ts`` one
frame behind or not) are equal; positions agree frame by frame within 1 cm,
the existing pipeline tests' bound (tests/test_torch_slam.py); a run resumed
from a checkpoint continues the saved run within 1e-6 m
(tests/test_checkpoint.py's bound).
"""

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu.utils import checkpoint as jck
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM
from sadvio_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

POS_TOL_M = 0.01
RESUME_TOL_M = 1e-6
SPLIT = 22  # frames before the checkpoint
CFG = SLAMConfig(slam_mode="bimonovio", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=0.5, min_movement_parallax=0.02,
                 marginalization=True, sparsification=True, async_health=True,
                 caps=Capacities(K=4, L=160, P=24, pyr_levels=3, klt_radius=5))


def _drive(slam, frames):
    """process_frame over ``frames``; (is_kf, lagged) per frame."""
    outs = [slam.process_frame(f) for f in frames]
    return [(bool(o["is_kf"]), o.get("pose_ts", o["ts"]) != o["ts"]) for o in outs]


def _port(world):
    return TSLAM(from_numpy(jax.tree.map(np.asarray, world.rig), "cpu"), CFG,
                 imu_params=from_numpy(jax.tree.map(np.asarray, world.imu_params)), device="cpu")


def _positions(slam):
    return np.asarray([t for _, _, t in slam.traj])


@pytest.fixture(scope="module")
def world():
    return jsyn.make_world(seed=3, n_frames=40, width=320, height=240, n_points=200,
                           imu_noise=True)


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Both packages over the first SPLIT frames, each saved with its last
    frame's health still pending, then over the rest of the frames."""
    d = tmp_path_factory.mktemp("async")
    js = JSLAM(world.rig, CFG, imu_params=world.imu_params)
    ts = _port(world)
    rec = {"j": _drive(js, world.frames[:SPLIT]), "t": _drive(ts, world.frames[:SPLIT])}
    pend = {"j": js._health_pend is not None, "t": ts._health_pend is not None}
    n_rows = {"j": len(js.traj), "t": len(ts.traj)}
    jck.save_slam(str(d / "jax.npz"), js)
    tck.save_slam(str(d / "port.npz"), ts)
    saved_rows = {"j": len(js.traj), "t": len(ts.traj)}
    rec["j"] += _drive(js, world.frames[SPLIT:])
    rec["t"] += _drive(ts, world.frames[SPLIT:])
    before_flush = {"j": len(js.traj), "t": len(ts.traj)}
    js._flush_health()
    ts._flush_health()
    return dict(js=js, ts=ts, rec=rec, pend=pend, n_rows=n_rows, saved_rows=saved_rows,
                before_flush=before_flush, port_file=str(d / "port.npz"),
                jax_file=str(d / "jax.npz"))


def test_keyframes_and_lag_pattern_match_jax(runs, world):
    js, ts, rec = runs["js"], runs["ts"], runs["rec"]
    assert rec["t"] == rec["j"]
    assert [t for t, _, _ in ts.kf_traj] == [t for t, _, _ in js.kf_traj]
    assert any(lag for _, lag in rec["t"]), "no frame ran on lagged health"
    assert not any(lag for kf, lag in rec["t"] if kf), "a keyframe voted on stale health"
    pj, pt = _positions(js), _positions(ts)
    assert pj.shape == pt.shape == (len(world.frames), 3)
    assert np.linalg.norm(pj - pt, axis=1).max() < POS_TOL_M
    assert ts.vi_initialized and len(ts.archived_kf) >= 1
    assert tsyn.ate_rmse(pt, world.gt_t) < 0.05


def test_flush_at_run_end_writes_the_last_row(runs, world):
    """The last frame's health is still pending after its process_frame; the
    flush ingests it, as ``run`` and ``write_logs`` do."""
    ts, js = runs["ts"], runs["js"]
    n = len(world.frames)
    assert runs["before_flush"]["t"] == runs["before_flush"]["j"]
    assert runs["before_flush"]["t"] in (n - 1, n)
    assert len(ts.traj) == len(js.traj) == n
    assert [t for t, _, _ in ts.traj] == [f.ts for f in world.frames]
    assert ts.vio_log[-1][0] == world.frames[-1].ts
    assert ts._health_pend is None
    fresh = _port(world)
    est = fresh.run(world.frames[:12])
    assert est.shape == (12, 3) and fresh._health_pend is None
    assert fresh.traj[-1][0] == world.frames[11].ts


def test_checkpoint_with_pending_fetch_resumes_as_jax(runs, world):
    """A save with a pending fetch ingests it first (one row per frame), and
    a load clears the live instance's fetch and vote state; the resumed run
    continues the saved one in the port, and in the JAX package alike."""
    assert runs["pend"] == {"j": True, "t": True}, "no fetch pending at the save"
    assert runs["saved_rows"]["t"] == runs["n_rows"]["t"] + 1 == SPLIT
    assert runs["saved_rows"]["j"] == runs["n_rows"]["j"] + 1 == SPLIT
    ts, js = runs["ts"], runs["js"]
    kf_frame = lambda slam: next(f for f in world.frames if f.ts == slam.kf_ts[-1])

    b = _port(world)
    b._health_pend, b._par_prev = ("stale", None), 0.3  # a used instance's state
    tck.load_slam(runs["port_file"], b)
    assert b._health_pend is None and b._par_prev is None and not b._health_stale
    b.kf_pyr = b._pyramids(torch.as_tensor(kf_frame(b).images))
    rec_b = _drive(b, world.frames[SPLIT:])
    b._flush_health()

    jb = JSLAM(world.rig, CFG, imu_params=world.imu_params)
    jck.load_slam(runs["jax_file"], jb)
    jb.kf_pyr = jb._pyramids(jax.numpy.asarray(kf_frame(jb).images))
    rec_jb = _drive(jb, world.frames[SPLIT:])
    jb._flush_health()

    assert rec_b == runs["rec"]["t"][SPLIT:]
    assert rec_jb == rec_b
    np.testing.assert_allclose(_positions(b), _positions(ts), atol=RESUME_TOL_M)
    assert [t for t, _, _ in b.traj] == [t for t, _, _ in jb.traj]
    assert np.linalg.norm(_positions(b) - _positions(jb), axis=1).max() < POS_TOL_M
