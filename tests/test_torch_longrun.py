"""The long-run stereo path of the port, end to end on the CPU: global map,
pose graph with loop closure, relocalization, and a JAX-package state that
continues in the port.

Worlds and configs are those of tests/test_loop_closure_e2e.py.  The two
packages draw different RANSAC hypotheses, so the drives gate on the
mechanism, as that file does: at least 10 archived nodes, at least 10
resurrections, at least 3 loop closures spanning more than a second, no
reset, and an end-of-loop drift that ``optimize_archive`` cuts below 0.8 of
the raw one.  The JAX package runs the 90 frames once per module.

State parity: ``optimize_archive`` of the port on the JAX run's final state
(window, archive, edges, covariances carried over by ``from_numpy`` and
``slam_state_from_numpy``) agrees with the JAX package's to 1e-3 m per node
(float32 Gauss-Newton on informations up to 1e7), and a JAX state captured
before the revisit continues in the port to loop closures of its own.
"""

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.data.convert import from_numpy, slam_state_from_numpy
from sadvio_tpu_torch.pipeline.slam import StereoSLAM as TSLAM

torch.set_num_threads(2)

CFG = SLAMConfig(slam_mode="bimono", max_kf_number=5, min_lmk_number=25,
                 max_movement_parallax=1.0, min_movement_parallax=0.02,
                 marginalization=True, sparsification=True, global_map=True, pose_graph=True,
                 caps=Capacities(K=6, L=256, P=24, pyr_levels=3, klt_radius=5))
SNAP_AT = 55  # frames the JAX package runs before its state is handed to the port


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _snapshot(js, last_kf_frame):
    """Everything the port needs to continue a JAX-package run."""
    return dict(
        device=_np((js.window, js.obs, js.imu, js.priors, js.tracks)),
        gm=_np(js.global_map_state), lmk_desc=np.asarray(js.lmk_desc),
        archived_kf=[(ts, np.asarray(R), np.asarray(t)) for ts, R, t in js.archived_kf],
        edges=list(js.pose_graph_edges), kf_cov=[np.asarray(c) for c in js.kf_cov],
        kf_ts=list(js.kf_ts), n_kf=js.n_kf, last_kf_frame=last_kf_frame,
        cur=_np((js.R_cur, js.t_cur, js.v_cur, js.dT[0], js.dT[1])),
        have_priors=js._have_priors, traj=list(js.traj))


def _load(ts, snap, frames):
    """Put a snapshot of the JAX pipeline into the port's pipeline."""
    ts.window, ts.obs, ts.imu, ts.priors, ts.tracks = [from_numpy(x, "cpu")
                                                       for x in snap["device"]]
    slam_state_from_numpy(ts, global_map=snap["gm"], lmk_desc=snap["lmk_desc"],
                          archived_kf=snap["archived_kf"], pose_graph_edges=snap["edges"],
                          kf_cov=snap["kf_cov"])
    ts.kf_ts, ts.n_kf = list(snap["kf_ts"]), snap["n_kf"]
    ts.R_cur, ts.t_cur, ts.v_cur, dR, dt = [torch.as_tensor(np.array(x)) for x in snap["cur"]]
    ts.dT = (dR, dt)
    ts._have_priors, ts.initialized = snap["have_priors"], True
    ts.traj = list(snap["traj"])
    kf_images = torch.as_tensor(np.array(frames[snap["last_kf_frame"]].images))
    ts.kf_pyr = ts._pyramids(kf_images)
    ts.kf_tmpl = ts._template_cache(ts.kf_pyr, ts.tracks.uv_kf[0])
    return ts


def _drive(slam, frames):
    lcs, res = [], 0
    for f in frames:
        out = slam.process_frame(f)
        res += out.get("gm_resurrected", 0)
        if "loop_closure" in out:
            lcs.append(out["loop_closure"])
    return lcs, res


def _drift(world, slam, nodes):
    """Live-window position errors (raw, optimized) against ground truth in
    the estimator gauge (world = first body frame)."""
    R0, t0 = world.gt_R[0], world.gt_t[0]
    gt = {float(f.ts): R0.T @ (world.gt_t[i] - t0) for i, f in enumerate(world.frames)}
    node_t = {}
    for ts, _, t in nodes:
        node_t.setdefault(float(ts), np.asarray(t))
    raw = [np.linalg.norm(np.asarray(slam.window.t[j]) - gt[ts])
           for j, ts in enumerate(slam.kf_ts)]
    opt = [np.linalg.norm(node_t[ts] - gt[ts]) for ts in slam.kf_ts]
    return np.asarray(raw), np.asarray(opt)


@pytest.fixture(scope="module")
def runs():
    world = jsyn.make_world(seed=11, n_frames=90, width=320, height=240, n_points=420,
                            imu_noise=False, noise_px=1.0, trajectory="excursion",
                            wall_x=(-5.0, 11.0))
    js = JSLAM(world.rig, CFG)
    snap, last_kf = None, 0
    pre_roll, roll = [], js._marg_roll

    def recording(window, obs, imu, priors, tracks, vio, **k):
        pre_roll.append(_np((window, obs, imu, priors)))
        return roll(window, obs, imu, priors, tracks, vio, **k)

    js._marg_roll = recording
    for i, f in enumerate(world.frames):
        if i == SNAP_AT:
            snap = _snapshot(js, last_kf)
        if js.process_frame(f).get("is_kf"):
            last_kf = i
    rig = from_numpy(_np(world.rig), "cpu")
    port = TSLAM(rig, CFG, device="cpu")
    lcs, res = _drive(port, world.frames)
    return dict(world=world, js=js, snap=snap, rig=rig, port=port, lcs=lcs, res=res,
                pre_roll=pre_roll)


def test_port_revisit_archives_resurrects_and_closes(runs):
    port = runs["port"]
    assert port.n_resets == 0
    assert len(port.archived_kf) >= 10
    assert runs["res"] >= 10, f"only {runs['res']} resurrections on the revisit"
    long_lcs = [(a, b) for a, b in runs["lcs"] if b - a > 1.0]
    assert len(long_lcs) >= 3, f"loop closures: {runs['lcs']}"
    assert len(port.pose_graph_edges) >= len(port.archived_kf) - 1 + len(runs["lcs"])
    # timestamps stay host float64, and every edge names nodes by them
    ts_nodes = {ts for ts, _, _ in port.archived_kf} | set(port.kf_ts)
    assert all(isinstance(e[0], float) and e[0] in ts_nodes and e[1] in ts_nodes
               for e in port.pose_graph_edges)
    gm = port.global_map_state
    assert int(gm.mask.sum()) > 50 and int(gm.src.max()) < len(port.archived_kf)


def test_port_loop_closure_reduces_end_drift(runs):
    port, world = runs["port"], runs["world"]
    raw, opt = _drift(world, port, port.optimize_archive())
    assert np.isfinite(opt).all()
    assert opt[-1] < 0.8 * raw[-1], f"loop closure did not close drift: {opt[-1]} vs {raw[-1]}"
    # with no edges the nodes come back unchanged
    edges, port.pose_graph_edges = port.pose_graph_edges, []
    nodes = port.optimize_archive()
    port.pose_graph_edges = edges
    assert len(nodes) == len(port.archived_kf) + len(port.kf_ts)
    np.testing.assert_array_equal(nodes[0][2], port.archived_kf[0][2])


def test_port_matches_the_jax_run_in_kind(runs):
    """Same world, different RANSAC draws: the same number of archived nodes
    within 2, resurrections within a third, closures within 3."""
    js, port = runs["js"], runs["port"]
    assert abs(len(port.archived_kf) - len(js.archived_kf)) <= 2
    n_lc_j = sum(1 for e in js.pose_graph_edges if e[1] - e[0] > 1.0)
    assert abs(len(runs["lcs"]) - n_lc_j) <= 3
    est_j = np.asarray([t for _, _, t in js.traj])
    est_t = np.asarray([t for _, _, t in port.traj])
    assert np.abs(est_t - est_j).max() < 0.05


def test_optimize_archive_on_the_jax_final_state(runs):
    js = runs["js"]
    nodes_j = js.optimize_archive()
    ts = TSLAM(runs["rig"], CFG, device="cpu")
    ts.window = from_numpy(_np(js.window), "cpu")
    slam_state_from_numpy(ts, archived_kf=js.archived_kf, pose_graph_edges=js.pose_graph_edges,
                          kf_cov=js.kf_cov)
    ts.kf_ts, ts.n_kf = list(js.kf_ts), js.n_kf
    nodes_t = ts.optimize_archive()
    assert [n[0] for n in nodes_t] == [n[0] for n in nodes_j]
    moved = max(np.linalg.norm(np.asarray(a[2]) - b[2]) for a, b in zip(nodes_j, js.archived_kf))
    assert moved > 5e-3  # the optimization did something to hold the port against
    for (_, Rj, tj), (_, Rt, tt) in zip(nodes_j, nodes_t):
        np.testing.assert_allclose(tt, np.asarray(tj), atol=1e-3)
        np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-3)


def test_one_camera_lonely_landmarks_leave_no_phantom_information(runs):
    """Deviation from the JAX package, on purpose (a fault of the reference).

    A landmark that only slot 0 sees is eliminated onto the x0 pose before
    the marginalization.  Seen by one camera only, its 3x3 information has
    rank 2; the JAX package inverts it (jittered) in float32, the
    cancellation that keeps the unobserved depth out of the pose block is
    lost, and the six square-root rows of the correction carry information
    that does not exist, orders of magnitude above the true correction.  The port eliminates in float64.  On the
    windows the JAX run rolled: where such landmarks exist the JAX rows are
    hundreds of times the port's, the port's stay at the rounding floor, and
    the port's float32 square-root marginal is the float64 QR marginal of the
    same stacked Jacobian to 1e-5.  (The float64 H-space chain is no yardstick
    here: its 1e-12 rank threshold keeps information that the QR marginalizes
    away, up to 8% of |Ak| on these windows, in both packages.)"""
    from sadvio_tpu.backend import marginalization as jmarg
    from sadvio_tpu_torch.backend import ba as tba, marginalization as tmarg
    from sadvio_tpu_torch.models import imu as timu

    js, rig = runs["js"], runs["rig"]
    opts = tba.BAOptions()
    worst = 0.0
    for st in runs["pre_roll"]:
        window, obs, imu, priors = st
        P = priors.P
        dim, m_dim = 30 + 6 * P, 15 + 3 * P
        bl = jmarg.partition_blanket(window, obs, priors, P)
        one_cam = int((np.asarray(bl.lonely) & (obs.mask[0].sum(0) == 1)).sum())
        rows_j = np.asarray(jmarg._reproj_sqrt_rows(window, obs, js.rig, js._ba_opts, bl, dim,
                                                    P))[-6:, :6]
        t = [from_numpy(x, "cpu") for x in st]
        bl_t = tmarg.partition_blanket(t[0], t[1], t[3], P)
        rows_t = tmarg._reproj_sqrt_rows(t[0], t[1], rig, opts, bl_t, dim, P)
        # a landmark seen only from slot 0 tells nothing about that pose
        assert float(rows_t[-6:, :6].norm()) < 1.0
        if one_cam:
            worst = max(worst, np.linalg.norm(rows_j) / float(rows_t[-6:, :6].norm()))
        a32 = tmarg.marginalize(*t[:2], rig, *t[2:], opts, vio=False)[1]["Ak"].double()
        W0 = timu.sqrt_info(t[2].pre[0])
        J = torch.func.jacfwd(lambda dxm: tmarg._marg_dense_residuals(
            t[0], t[2], t[3], opts, bl_t, dxm, W0))(torch.zeros(dim))
        R22 = np.linalg.qr(torch.cat([J, rows_t]).double().numpy(), mode="r")[m_dim:, m_dim:]
        a64 = torch.as_tensor(R22.T @ R22)
        assert float((a32 - a64).norm() / a64.norm()) < 1e-5
    assert worst > 100.0, f"the fault case did not occur in this run ({worst})"


def test_jax_state_continues_in_the_port(runs):
    """The JAX package runs the excursion out; its state (window, priors,
    tracks, global map, archive, edges) is handed over before the revisit
    and the port finds the loop closures on the way back."""
    world, snap = runs["world"], runs["snap"]
    assert len(snap["archived_kf"]) >= 5 and int(snap["gm"].mask.sum()) > 20
    ts = _load(TSLAM(runs["rig"], CFG, device="cpu"), snap, world.frames)
    lcs, res = _drive(ts, world.frames[SNAP_AT:])
    assert ts.n_resets == 0 and len(ts.traj) == len(world.frames)
    assert res >= 10 and len([1 for a, b in lcs if b - a > 1.0]) >= 3, (res, lcs)
    # closures anchor at nodes the JAX package archived
    ts_jax = {float(n[0]) for n in snap["archived_kf"]}
    assert sum(1 for a, _ in lcs if a in ts_jax) >= 3
    raw, opt = _drift(world, ts, ts.optimize_archive())
    assert opt[-1] < 0.8 * raw[-1]
    est = np.asarray([t for _, _, t in ts.traj])
    assert jsyn.ate_rmse(est, world.gt_t) < 0.05


def _occluded_run(rig, world, **cfg_changes):
    import dataclasses

    cfg = dataclasses.replace(CFG, caps=Capacities(K=6, L=200, P=24, pyr_levels=3, klt_radius=5),
                              **cfg_changes)
    slam = TSLAM(rig, cfg, device="cpu")
    relocalized, closures = False, 0
    for i, f in enumerate(world.frames):
        if 20 <= i < 26:  # 6 black frames: more than 5 consecutive PnP failures
            f = f._replace(images=np.zeros_like(f.images))
        out = slam.process_frame(f)
        relocalized |= out.get("relocalized", False)
        closures += "loop_closure" in out
    return slam, relocalized, closures


@pytest.fixture(scope="module")
def occlusion_world():
    from sadvio_tpu_torch.pipeline import synthetic as tsyn

    return tsyn.make_world(seed=7, n_frames=40, width=320, height=240, n_points=220,
                           imu_noise=False, device="cpu")


def test_relocalization_after_reset_keeps_gauge(occlusion_world):
    world = occlusion_world
    slam, relocalized, _ = _occluded_run(world.rig, world)
    assert slam.n_resets >= 1, "occlusion did not trigger a reset"
    assert relocalized, "bootstrap did not relocalize against the archive"
    # the window keyframes of the reset joined the archive, with odometry edges
    assert len(slam.archived_kf) >= 6
    R0, t0 = world.gt_R[0], world.gt_t[0]
    gt_last = R0.T @ (world.gt_t[len(world.frames) - 1] - t0)
    err = np.linalg.norm(slam.t_cur.numpy() - gt_last)
    assert err < 0.12, f"post-recovery gauge error {err:.3f} m"


def test_strict_gates_suppress_relocalization(occlusion_world):
    world = occlusion_world
    slam, relocalized, closures = _occluded_run(world.rig, world, lc_min_hits=999)
    assert slam.n_resets >= 1
    assert not relocalized and closures == 0
