"""The port's non-overlapping-FoV pipeline (``NoFovSLAM``) against the JAX
package's, end to end.

World and config of tests/test_nofov_pipeline.py::
test_nofov_recovers_from_scale_perturbation: seed 6, 52 frames, 320x240,
lever 1.5 m, rot_scale 1.5, K=6, L=320 (camera 0 in [0, 160), camera 1 in
[160, 320)), and the same 1.4x corruption of the window scale after frame
20.  The JAX run goes once per module; the port runs on the CPU on the JAX
world's numpy frames with the JAX package's bootstrap RANSAC draws.

Gates: those of the JAX test (initialized, scale applied, at least two
estimates, more than 20 camera-1 landmarks, tail segment scale within
0.75-1.3 of the ground truth's); the bootstrap and every keyframe on the
JAX run's frames; the first applied scale within 5% of the JAX run's
(measured 0.6%: the scale grid's inputs come through the bootstrap, the
joint BA and the re-track, each float32 in another order).  A JAX state
taken after frame 30 (the chained camera-1 tracks, their history and
pyramids included) finishes under the same tail gate in the port.
"""

import numpy as np
import pytest
import torch

import jax
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.nofov_mode import NoFovSLAM as JNoFov
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM as TNoFov
from tests.test_torch_mono import jax_boot_draws, load, snapshot

torch.set_num_threads(2)

SCALE_REL_TOL = 0.05
HANDOVER_AT = 30
CFG = SLAMConfig(slam_mode="nofov", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=0.5, min_movement_parallax=0.02,
                 caps=Capacities(K=6, L=320, P=24, pyr_levels=3, klt_radius=5))


def _drive(slam, frames, start=0, perturbed_at=None, snap_at=None):
    """The JAX test's loop: corrupt the window scale 1.4x once the scale is
    applied and frame 20 is reached."""
    outs, snap = [], None
    for i, f in enumerate(frames[start:], start=start):
        outs.append(slam.process_frame(f))
        if perturbed_at is None and slam.scale_state["applied"] and i >= 20:
            slam._apply_scale_window(1.4)
            perturbed_at = i
        if i == snap_at:
            snap = snapshot(slam, i)
    return outs, perturbed_at, snap


def _tail_ratio(slam, world, tail=10):
    est = np.asarray([t for _, _, t in slam.traj])
    seg_e = np.linalg.norm(np.diff(est[-tail:], axis=0), axis=-1).sum()
    seg_g = np.linalg.norm(np.diff(world.gt_t[len(est) - tail: len(est)], axis=0),
                           axis=-1).sum()
    return seg_e / max(seg_g, 1e-9)


def _check_gates(slam, world, perturbed_at):
    assert slam.initialized and slam.scale_state["applied"]
    assert perturbed_at is not None, "scale never bootstrapped"
    assert slam.scale_state["n_est"] >= 2, "continuous estimation inactive"
    L = slam.caps.L
    assert int(np.asarray(slam.window.lmk_mask.cpu())[L // 2:].sum()) > 20
    assert len(slam.traj) == len(world.frames) and slam.n_resets == 0
    ratio = _tail_ratio(slam, world)
    assert 0.75 < ratio < 1.3, f"tail scale {ratio:.3f} did not recover"


@pytest.fixture(scope="module")
def runs():
    world = jsyn.make_nofov_world(seed=6, n_frames=52, width=320, height=240, n_points=200,
                                  rot_scale=1.5, lever=1.5)
    js = JNoFov(world.rig, CFG, boot_parallax_deg=1.5)
    j_outs, j_pert, snap = _drive(js, world.frames, snap_at=HANDOVER_AT)
    trig = from_numpy(jax.tree.map(np.asarray, world.rig), "cpu")
    ts = TNoFov(trig, CFG, boot_parallax_deg=1.5, device="cpu")
    with jax_boot_draws():
        t_outs, t_pert, _ = _drive(ts, world.frames)
    return dict(world=world, js=js, ts=ts, trig=trig, j_outs=j_outs, t_outs=t_outs,
                j_pert=j_pert, t_pert=t_pert, snap=snap)


def test_port_recovers_from_scale_perturbation(runs):
    _check_gates(runs["ts"], runs["world"], runs["t_pert"])


def test_keyframes_and_scale_agree(runs):
    kf = lambda outs: [i for i, o in enumerate(outs) if o["is_kf"]]
    assert kf(runs["t_outs"]) == kf(runs["j_outs"])
    assert runs["t_pert"] == runs["j_pert"]
    applied = lambda outs: [o["scale_applied"] for o in outs if "scale_applied" in o]
    (a_t,), (a_j,) = applied(runs["t_outs"]), applied(runs["j_outs"])
    assert a_t == pytest.approx(a_j, rel=SCALE_REL_TOL)
    n_t, n_j = runs["ts"].scale_state["n_est"], runs["js"].scale_state["n_est"]
    assert abs(n_t - n_j) <= 1


def test_camera1_state_is_kept_on_host_and_device(runs):
    """The chained camera-1 tracks and their history stay host arrays; the
    keyframe pyramids of camera 1 stay tensors, one per live window slot."""
    ts = runs["ts"]
    K, L = ts.caps.K, ts.caps.L
    assert ts.uv1_hist.shape == (K, L, 2) and ts.hist_mask.dtype == bool
    assert not ts.v1_last[: L // 2].any(), "a camera-1 track sits in camera 0's slots"
    live = [p for p in ts.pyr1_hist if p is not None]
    assert 1 <= len(live) <= ts.n_kf
    assert all(isinstance(lvl, torch.Tensor) for p in live for lvl in p)
    assert len(ts.pyr1_hist) == K


def test_jax_state_at_frame_30_finishes_in_port(runs):
    snap, world = runs["snap"], runs["world"]
    assert snap is not None and snap["nofov"]["scale_state"]["applied"]
    ts = load(TNoFov(runs["trig"], CFG, boot_parallax_deg=1.5, device="cpu"), snap)
    assert ts._cam0_slot_limit == CFG.caps.L // 2
    assert [p is None for p in ts.pyr1_hist] == [p is None for p in snap["nofov"]["pyr1_hist"]]
    _, pert, _ = _drive(ts, world.frames, start=HANDOVER_AT + 1, perturbed_at=runs["j_pert"])
    _check_gates(ts, world, pert)


def test_degenerate_baselines_give_no_estimate(runs):
    """A window whose baselines have no rotation yields no ratio: the lever
    displacement is zero, so scale is unobservable."""
    ts = runs["ts"]
    saved = ts.window
    try:
        eye = torch.eye(3).expand_as(ts.window.R).clone()
        ts.window = ts.window.replace(R=eye)
        assert ts._estimate_scale_window(ts.n_kf - 1) is None
    finally:
        ts.window = saved


@pytest.mark.slow
def test_nofov_metric_scale():
    """Port counterpart of tests/test_nofov_pipeline.py::test_nofov_metric_scale."""
    world = jsyn.make_nofov_world(seed=4, n_frames=40, width=320, height=240, n_points=200)
    cfg = SLAMConfig(slam_mode="nofov", max_kf_number=5, min_lmk_number=25,
                     max_movement_parallax=1.0, min_movement_parallax=0.02,
                     marginalization=True, sparsification=True,
                     caps=Capacities(K=6, L=320, P=24, pyr_levels=3, klt_radius=5))
    ts = TNoFov(from_numpy(jax.tree.map(np.asarray, world.rig), "cpu"), cfg,
                boot_parallax_deg=1.5, device="cpu")
    scale_ratio, i0 = None, None
    with jax_boot_draws():
        for i, f in enumerate(world.frames):
            out = ts.process_frame(f)
            if i0 is None and ts.initialized:
                i0 = i
            scale_ratio = out.get("scale_applied", scale_ratio)
    assert ts.initialized, "nofov bootstrap never triggered"
    est = np.asarray([t for _, _, t in ts.traj])[i0:]
    gt = world.gt_t[i0: i0 + len(est)]
    assert jsyn.ate_rmse(est, gt, with_scale=True) < 0.08
    if scale_ratio is not None:
        assert jsyn.ate_rmse(est, gt, with_scale=False) < 0.25
