"""Stereo VO ("bimono") / stereo VIO ("bimonovio") pipeline.

Port of ``sadvio_tpu/pipeline/slam.py`` (``StereoSLAM``), the base class of
the monocular and non-overlapping-FoV modes (``pipeline/mono.py``,
``pipeline/nofov_mode.py``):

  frontend  : pyramids + KLT from the last keyframe (or BRIEF matching with
              a level-0 KLT polish) + PnP (or essential-matrix RANSAC)
              + epipolar gate + ESKF fusion, one health vector read by the
              host per frame
  insert_kf : grid detection + resurrection (from the window and, with
              ``global_map``, from the descriptor archive) + stereo KLT
              + triangulation
  backend   : window Schur-LM VI-BA + 3 px outlier gate
  marg_roll : marginalization into a sparsified or dense prior + window
              shift; leaving landmarks are archived into the global map
  long run  : with ``pose_graph`` each roll condenses the links between the
              two oldest keyframes into a relative-pose edge; a burst of
              archive resurrections is a revisit and yields a PnP loop
              closure edge; ``optimize_archive`` solves the pose graph; after
              a reset the bootstrap keyframe relocalizes against the archive
  mesh3d    : Delaunay mesh over the landmarks + dense ray-cast cloud at
              keyframe rate
  channels  : each ``features_handled`` label beyond pointxd builds its
              typed channel, updated at keyframe rate; linexd lines enter
              the window BA as pose-constraining 6-dof blocks, and the csv
              point detector reads precomputed keypoints instead of
              detecting

All estimator state lives in fixed-shape tensors on ``device``; the host
loop reads back the health vector once per frame and a small state pack
once per keyframe.  Feature identity: track slot == landmark slot.

One deliberate deviation from the JAX package: before VIInit has run, the
motion prediction is the constant-velocity model, not the IMU prediction.
Before VIInit the window velocities are still zero, and the JAX package's
IMU prediction from zero velocity drifts by v * dt over a keyframe
interval; once that drift is ten times the motion since the keyframe, the
PnP sanity gate rejects the correct pose and tracking collapses.

Subclass hooks: ``_bootstrap`` (the first keyframe, before
``initialized``), ``_insert_kf``, ``vio_init_kfs``, ``_vi_opt_scale`` (VIInit
solves the scale too), ``_vi_init_chain`` (the IMU links VIInit solves
over) and ``_last_pyr`` (the latest frame's pyramids).
``optimizer: angular*`` switches the window BA to the bearing-vector
residual.  ``multithreading`` runs the window BA on a second CUDA stream
(``parallel/pipeline_parallel.py``).  ``run(frames, log_dir, profile)``
times the stages and writes ``log_slam/`` (``write_logs``).  ``async_health``
harvests each frame's health vector one frame late: its device-to-host copy
is started at frame k and read at frame k+1, the keyframe vote runs on the
stale health as a candidate gate, and a candidate is confirmed against the
frame's own health (a blocking read at candidate rate only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from sadvio_tpu_torch.backend import ba, marginalization as marg, posegraph as pg, viinit
from sadvio_tpu_torch.data import globalmap as gmap
from sadvio_tpu_torch.data.window import (
    LMK_RESURRECTED, ImuChain, Observations, PriorSet, Rig, WindowState,
)
from sadvio_tpu_torch.frontend import (
    csv_keypoints, detect, epipolar, eskf as eskf_mod, klt, lines as lines_mod,
    match as match_mod, pnp, triangulate,
)
from sadvio_tpu_torch.mesh.mesh import MeshConfig, Mesher
from sadvio_tpu_torch.models import cameras, imu as imu_mod
from sadvio_tpu_torch.parallel.pipeline_parallel import BackendExecutor
from sadvio_tpu_torch.pipeline.channels import BBoxChannel, EdgeletChannel, EllipseChannel
from sadvio_tpu_torch.pipeline.config import SLAMConfig
from sadvio_tpu_torch.pipeline.line_channel import LineChannel
from sadvio_tpu_torch.utils import geometry as geo, graphs
from sadvio_tpu_torch.utils.profiler import Profiler, Recorder
from sadvio_tpu_torch.utils.struct import Struct, entry_device, select, take, tree_map


@dataclass
class TrackState(Struct):
    """Per-camera feature tracks; slot index == landmark slot index."""

    uv: torch.Tensor  # (C,L,2)
    valid: torch.Tensor  # (C,L)
    uv_kf: torch.Tensor  # (C,L,2) positions at the last keyframe
    has3d: torch.Tensor  # (L,) landmark triangulated

    @classmethod
    def create(cls, C: int, L: int, device=None):
        return cls(uv=torch.zeros((C, L, 2), device=device),
                   valid=torch.zeros((C, L), dtype=torch.bool, device=device),
                   uv_kf=torch.zeros((C, L, 2), device=device),
                   has3d=torch.zeros(L, dtype=torch.bool, device=device))


CSV_DETECTORS = ("csv", "cvcsv")


def _check_config(cfg: SLAMConfig, modes):
    """Refuse a slam_mode outside ``modes`` (the class's own) and the config
    values that the JAX package does not dispatch either."""
    todo = {
        "slam_mode": cfg.slam_mode not in modes,
        "tracker": cfg.tracker not in ("klt", "matcher"),
        "pose_estimator": not cfg.pose_estimator.lower().startswith(("pnp", "epipolar")),
    }
    bad = [k for k, v in todo.items() if v]
    if bad:
        raise NotImplementedError(f"config values not supported: {', '.join(bad)}")


def _set(x, idx, val):
    """Copy of x with x[idx] = val.  ``idx``: an index or a tuple of indices
    into the leading dims, each a Python int or a 0-d integer tensor, which
    stays on the device (a captured stage reads no index on the host)."""
    sel = torch.ones((), dtype=torch.bool, device=x.device)
    for d, i in enumerate(idx if isinstance(idx, tuple) else (idx,)):
        shape = [1] * x.ndim
        shape[d] = x.shape[d]
        sel = sel & (torch.arange(x.shape[d], device=x.device) == i).reshape(shape)
    return torch.where(sel, val, x)


def _has_lines(self, window, obs, imu_chain, priors, fixed_n, lines=None):
    """The window BA with the line channel's blocks stays eager (not captured yet)."""
    return lines is not None


def _next_pinned(pins, dtype, shape, trace):
    """The next of the two pinned host buffers in ``pins`` (a list of two
    (buffer, event) slots used in turn), once the copy recorded behind its
    last use has finished (the span ``pinned.wait``); a buffer of another
    shape or dtype is replaced."""
    pins[:] = pins[1:] + pins[:1]
    buf, done = pins[0] or (None, None)
    if done is not None:
        with trace.span("pinned.wait"):
            done.synchronize()
    if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
        buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
    return buf


def _mark_pinned(pins, buf):
    """Record the event behind the copy just queued from or into ``buf``."""
    done = torch.cuda.Event()
    done.record()
    pins[0] = (buf, done)
    return done


def _odometry_edges(poses, covs):
    """Relative-pose edges between consecutive (ts, R, t) host poses, weighted
    by the endpoints' frame-rate pose covariance."""
    return [(a[0], b[0], pg.relative_pose(a[1], a[2], b[1], b[2]),
             pg.inflate_edge_info(np.eye(6) * 1e7, covs[j], covs[j + 1]))
            for j, (a, b) in enumerate(zip(poses[:-1], poses[1:]))]


class StereoSLAM:
    """Stereo VO / stereo VIO pipeline on one device (None: the CUDA card)."""

    MODES = ("bimono", "bimonovio")  # the slam_mode values this class runs
    PROFILE_BOOTSTRAP = True  # run(profile=True) times the bootstrap frames' stages too
    IMU_CAP = 32  # IMU samples per preintegration batch (one captured shape)
    SCALE_SEEN = 4.0  # a solved scale's information over the solve's cost, at least (C11)
    N_HYP = 48  # PnP RANSAC hypotheses of the frame track

    def __init__(self, rig: Rig, config: SLAMConfig, imu_params=None, seed=0, device=None):
        _check_config(config, self.MODES)
        self.device = entry_device(device)
        # the pipeline's spans and counts (utils/profiler.py), always on
        self.trace = Recorder()
        self.graphs = graphs.StageGraphs(self.device, self.trace)  # the captured stages
        self.klt_engine = "fused"  # klt.track engine: "fused" | "levels"
        self.rig = rig.to(self.device)
        self.cfg = config
        self.caps = config.caps
        self.vio = config.slam_mode.endswith("vio")
        self.imu_params = imu_params or imu_mod.ImuParams.euroc()
        self.C = rig.C
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        # the JAX package's PRNG key for this seed (jax.random.PRNGKey): the
        # port draws from ``gen``; the key is only a checkpoint leaf, carried
        # through unchanged so the JAX reader finds it
        self.key = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)
        self._pre_id = imu_mod.Preintegration.identity(device=self.device)
        # optimizer "angular*": the bearing-vector residual (fisheye, omni)
        self._ba_opts = ba.BAOptions(iters=config.ba_iterations, sigma_px=1.0,
                                     acc_walk=self.imu_params.acc_walk,
                                     gyr_walk=self.imu_params.gyr_walk,
                                     angular=config.optimizer.lower().startswith("angular"))
        self.vio_init_kfs = min(10, self.caps.K - 1)  # 10-KF vision-only bootstrap
        self._epipolar = config.pose_estimator.lower().startswith("epipolar")
        self._vi_opt_scale = False  # VIInit solves the scale too (monocular)
        self._last_pyr = None  # pyramids of the latest frame, for subclasses
        self.n_resets = 0
        self.traj = []  # (ts, R, t) at frame rate, host numpy
        self.kf_traj = []
        # frame-rate VIO rows (ts, t, v, ba, bg), the vio_poses.csv layout;
        # ba and bg are the host copies refreshed at each keyframe
        self.vio_log = []
        # drive(): upload the next frame's images during this one; off, as it
        # did not pay on the card (PERF.md §5)
        self.prefetch = False
        self._prefetched = None  # the next frame's device images, from process_frame
        self._pins = [None, None]  # two pinned upload buffers, used in turn
        self._hbufs = [None, None]  # two pinned health buffers, used in turn
        self._ibufs = [None, None]  # two pinned IMU batch buffers, used in turn
        self._prof = None  # the Profiler of a run(profile=True)
        # multithreading: the window BA on a second CUDA stream
        self.backend_exec = BackendExecutor(self.device) if config.multithreading else None
        self._lc_diag = (0, 0, False)  # (candidates, inliers, pnp_ok) of the last closure try
        # archive of the keyframes rolled out of the window, and the
        # pose-graph edges between them; timestamps stay host float64
        self.archived_kf = []  # (ts, R, t) host-side append-only log
        self.pose_graph_edges = []  # (ts0, ts1, dx (6,), inf (6,6))
        # descriptor global map: archived landmark positions + BRIEF
        # descriptors for long-range resurrection, on the device
        self.global_map_state = None
        self.lmk_desc = None
        if config.global_map:
            self.global_map_state = gmap.GlobalMap.create(config.archive_capacity,
                                                          device=self.device)
            self.lmk_desc = torch.zeros((self.caps.L, detect.DESC_BITS), dtype=torch.bool,
                                        device=self.device)
        self.mesher = None
        if config.mesh3d and rig.C >= 2:
            # the ray-cast depth window follows the landmark depth gate
            self.mesher = Mesher(self.rig, MeshConfig(
                zncc_tsh=config.zncc_tsh, max_edge_len=config.max_length_tsh,
                max_ray_depth=MeshConfig().max_lmk_depth))
        self._build_channels(config.features)
        # current-frame estimate and constant-velocity model (kept by reset)
        self.R_cur = torch.eye(3, device=self.device)
        self.t_cur = torch.zeros(3, device=self.device)
        self.v_cur = torch.zeros(3, device=self.device)
        self.dT = (torch.eye(3, device=self.device), torch.zeros(3, device=self.device))
        self._clear()

    def _build_channels(self, features):
        """The features_handled dispatch: linexd (in the window BA),
        edgeletxd, ellipsepatternxd, bboxxd, and pointxd with the csv
        detector; other labels are ignored, as in the JAX package."""
        stereo = self.C >= 2
        self.channels = []
        self._line_ch = None  # the in-BA linexd channel, if configured
        self._use_csv = False  # precomputed keypoints replace point detection
        for f in features:
            label = f.label.lower()
            if label == "linexd" and stereo:
                self._line_ch = LineChannel(self.rig, in_ba=True, k_window=self.caps.K)
                self.channels.append(self._line_ch)
            elif label == "edgeletxd" and stereo:
                self.channels.append(EdgeletChannel(self.rig))
            elif label == "ellipsepatternxd":
                self.channels.append(EllipseChannel(self.rig, side=f.pattern_side or 1.0))
            elif label == "bboxxd" and stereo:
                self.channels.append(BBoxChannel(self.rig))
            elif label == "pointxd" and f.detector.lower() in CSV_DETECTORS:
                self._use_csv = True
                self._csv_folder = f.folder
                self._csv_stamps = None

    def _clear(self):
        K, L, P = self.caps.K, self.caps.L, self.caps.P
        dev = self.device
        self.window = WindowState.create(K, L, device=dev)
        self.obs = Observations.create(K, self.C, L, device=dev)
        self.priors = PriorSet.create(K, P, device=dev)
        self.imu = ImuChain.create(K, device=dev)
        self.tracks = TrackState.create(self.C, L, device=dev)
        self.pre_cur = self._pre_id
        self._imu_n = 0  # samples in pre_cur (host count)
        self.kf_pyr = None
        self.kf_tmpl = None
        self.n_kf = 0
        self.kf_ts = []  # host mirror of the window slots' timestamps
        # frame-rate ESKF pose covariance: host mirror + one record per
        # window keyframe, used to weight pose-graph edges
        self._cov_h = np.zeros((6, 6))
        self.kf_cov = []
        self.initialized = False
        self.vi_initialized = not self.vio
        self.successive_fails = 0
        self._have_priors = False
        self._ba_h = np.zeros(3)
        self._bg_h = np.zeros(3)
        # health: the last ingested (ts, health); with async_health the
        # pending (ts, fetch) of the frame before, the flag that forces one
        # blocking read after a keyframe changed the template, and the
        # previous stale parallax (the vote's one-step extrapolation)
        self._last_health = None
        self._health_pend = None
        self._health_stale = False
        self._par_prev = None

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    @graphs.stage
    def _pyramids(self, images):
        images = images.to(torch.float32)
        return tuple(tuple(klt.build_pyramid(images[c], self.caps.pyr_levels))
                     for c in range(self.C))

    def _template_cache(self, pyr_new, uv_kf0):
        """Keyframe-rate template windows for the "levels" engine; the fused
        kernel reads the keyframe pyramid itself."""
        if self.klt_engine == "fused":
            return None
        return klt.template_windows_pyr(pyr_new[0], uv_kf0, self.caps.pyr_levels,
                                        self.caps.klt_radius)

    @graphs.stage(key_attrs=("klt_engine",),
                  eager_if=lambda self, *a, **k: self._epipolar)
    def _frontend(self, pyr_kf, pyr_new, tracks: TrackState, window: WindowState, R_pred,
                  t_pred, v_pred, R_cur, t_cur, kf_tmpl=None, eskf_on=False, pre_cov=None,
                  sample_idx=None):
        """Track cam0 from the last-KF template, PnP, epipolar gate, ESKF.

        ``sample_idx`` (N_HYP, 4): the PnP RANSAC subsets, drawn by the caller
        from ``self.gen`` (the essential-matrix RANSAC of ``pose_estimator:
        epipolar`` draws its own, and that front end stays eager).

        Returns (tracks, R_new, t_new, health, dR, dt) with health =
        [pnp_ok, parallax, n_tracked, n_lmk_tracked, R(9), t(3), v(3), P(36)]."""
        dev = self.device
        cam0 = self.rig.cam.camera(0)
        Rfs0, tfs0 = self.rig.R_f_s[0], self.rig.t_f_s[0]
        lmk, has3d = window.lmk, tracks.has3d
        # KLT init: landmarks projected with the predicted pose
        uv_proj, vis = cameras.project_world(cam0, R_pred, t_pred, Rfs0, tfs0, lmk)
        init = torch.where((has3d & vis)[:, None], uv_proj, tracks.uv[0])

        # affine template warp predicted from the geometry
        k_last = torch.clamp(window.kf_mask.sum() - 1, min=0)
        R_kf, t_kf = take(window.R, k_last), take(window.t, k_last)
        z_cur = cameras.world_to_cam(R_pred, t_pred, Rfs0, tfs0, lmk)[:, 2]
        R_w_c = R_pred @ Rfs0
        step = (z_cur / cam0.focal)[:, None]
        proj_kf = lambda p: cameras.project_world(cam0, R_kf, t_kf, Rfs0, tfs0, p)[0]
        uv_c0 = proj_kf(lmk)
        col_u = proj_kf(lmk + R_w_c[:, 0][None] * step) - uv_c0
        col_v = proj_kf(lmk + R_w_c[:, 1][None] * step) - uv_c0
        A = torch.stack([col_u, col_v], -1)
        warp_ok = has3d & window.lmk_mask & vis & (z_cur > 0.1)
        A = torch.where(warp_ok[:, None, None], A, torch.eye(2, device=dev))

        if self.cfg.tracker == "matcher":
            # descriptor-matcher tracking: detect candidates in the new
            # frame and BRIEF-match the last keyframe's features against
            # them inside a box around the prediction
            uv_c, _, v_c = detect.detect_features(
                pyr_new[0][0], existing_uv=torch.zeros((self.caps.L, 2), device=dev),
                existing_valid=torch.zeros(self.caps.L, dtype=torch.bool, device=dev),
                gh=8, gw=10, k_per_cell=max(2, self.cfg.features[0].n_per_cell))
            desc_c = detect.brief_describe(detect.smooth3(pyr_new[0][0]), uv_c)
            desc_t = detect.brief_describe(detect.smooth3(pyr_kf[0][0]), tracks.uv_kf[0])
            idx, _ = match_mod.match(desc_t, init, tracks.valid[0], desc_c, uv_c, v_c,
                                     search_radius=30.0)
            uv_m = torch.where((idx >= 0)[:, None], uv_c[torch.clamp(idx, min=0)], init)
            ok = tracks.valid[0] & (idx >= 0)
            # sub-pixel polish: matched detections are integer-pixel, a
            # level-0 LK refinement from the keyframe template closes the gap
            uv1, ok_r, _ = klt.track(pyr_kf[0], pyr_new[0], tracks.uv_kf[0], uv_m, ok, levels=1,
                                     radius=self.caps.klt_radius, warp=A, engine=self.klt_engine)
            # keep the raw match where the polish diverges
            uv1 = torch.where(ok_r[:, None], uv1, uv_m)
        else:
            uv1, ok, _ = klt.track(pyr_kf[0], pyr_new[0], tracks.uv_kf[0], init, tracks.valid[0],
                                   levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                                   warp=A, tmpl_wins=kf_tmpl, engine=self.klt_engine)

        if self._epipolar:
            # essential-matrix RANSAC over the keyframe->frame ray matches is
            # the success check and the inlier gate; the pose stays the
            # motion prediction
            _, _, inliers, pnp_ok = epipolar.essential_ransac(
                cam0.backproject(tracks.uv_kf[0]), cam0.backproject(uv1), ok, self.gen)
            R_new, t_new = R_pred, t_pred
            ok = ok & (~pnp_ok | inliers)
        else:
            lmk_ok = ok & has3d & window.lmk_mask
            R_new, t_new, inliers, pnp_ok, _ = pnp.pnp_ransac(
                cam0, Rfs0, tfs0, lmk, uv1, lmk_ok, R_pred, t_pred, sample_idx=sample_idx)
            # constant-velocity sanity at 1000%: a PnP translation 10x away
            # from the predicted one forces the prediction and reports failure
            R_kfT = R_kf.T
            t_rel_est = R_kfT @ (t_new - t_kf)
            t_rel_prd = R_kfT @ (t_pred - t_kf)
            n_est = torch.linalg.norm(t_rel_est)
            dev_ratio = torch.linalg.norm(t_rel_est - t_rel_prd) / torch.clamp(n_est, min=1e-9)
            cv_fail = ((n_est > 0.01) & (torch.linalg.norm(t_rel_prd) > 0.01)
                       & (dev_ratio > 10.0))
            pnp_ok = pnp_ok & ~cv_fail
            R_new = torch.where(pnp_ok, R_new, R_pred)
            t_new = torch.where(pnp_ok, t_new, t_pred)
            # the inlier gate applies only when the solve succeeded
            ok = ok & (~lmk_ok | inliers | ~pnp_ok)

        # epipolar gate against the last KF (0.5 deg)
        R_ws_kf, t_ws_kf = geo.pose_compose(R_kf, t_kf, Rfs0, tfs0)
        R_ws_new, t_ws_new = geo.pose_compose(R_new, t_new, Rfs0, tfs0)
        R_ab, t_ab = geo.pose_compose(*geo.pose_inverse(R_ws_kf, t_ws_kf), R_ws_new, t_ws_new)
        ok = epipolar.epipolar_filter(R_ab, t_ab, cam0.backproject(tracks.uv_kf[0]),
                                      cam0.backproject(uv1), ok)

        P_frame = torch.zeros((6, 6), device=dev)
        if self.vio:
            P_frame = eskf_mod.imu_prior_covariance(pre_cov)
            if eskf_on:
                R_e, t_e, P_post, n_used = eskf_mod.eskf_update(
                    cam0, Rfs0, tfs0, R_pred, t_pred, P_frame, lmk, uv1,
                    ok & has3d & window.lmk_mask, sigma_px=1.0)
                use = pnp_ok & (n_used >= 8)
                R_new = torch.where(use, R_e, R_new)
                t_new = torch.where(use, t_e, t_new)
                P_frame = torch.where(use, P_post, P_frame)

        tracks = tracks.replace(uv=torch.cat([uv1[None], tracks.uv[1:]]),
                                valid=torch.cat([ok[None], tracks.valid[1:]]))
        zero3 = torch.zeros(3, device=dev)
        r0 = cameras.bearing_world(cam0, R_kf, zero3, Rfs0, tfs0, tracks.uv_kf[0])
        r1 = cameras.bearing_world(cam0, R_new, zero3, Rfs0, tfs0, uv1)
        cr = torch.linalg.cross(r0, r1, dim=-1)
        par = torch.rad2deg(torch.atan2(torch.linalg.norm(cr, dim=-1), (r0 * r1).sum(-1)))
        n_trk = ok.sum()
        parallax = torch.where(ok, par, torch.zeros_like(par)).sum() / torch.clamp(n_trk, min=1)
        n_lmk_trk = (ok & has3d & window.lmk_mask).sum()
        health = torch.cat([
            torch.stack([pnp_ok.float(), parallax, n_trk.float(), n_lmk_trk.float()]),
            R_new.reshape(-1), t_new, v_pred, P_frame.reshape(-1)])
        dR, dt_ = geo.pose_compose(*geo.pose_inverse(R_cur, t_cur), R_new, t_new)
        return tracks, R_new, t_new, health, dR, dt_

    def _detect_into_slots(self, img0, tracks: TrackState, window: WindowState,
                           obs: Observations, R_kf, t_kf, slot_limit: int, ext_det=None):
        """Camera 0's half of a keyframe insertion: detect in the free image
        area (or take the precomputed keypoints ``ext_det`` = (uv, valid)
        outside 5 px of live tracks), resurrect dead in-map landmarks, and
        give each fresh detection a free landmark slot below ``slot_limit``.

        Returns (uv_det, v_det, take, slot_of_det, new_uv0, new_v0, window,
        obs): the detections, which of them claimed a slot and which slot,
        camera 0's slot positions and validity, the window with the
        resurrection flags and the observations with the claimed slots'
        stale rows cleared."""
        dev = self.device
        L = self.caps.L
        ar_L = torch.arange(L, device=dev)
        # 1. detect in free slots with the occupancy mask
        if ext_det is not None:
            uv_det, v_det = ext_det
            d2ex = ((uv_det[:, None] - tracks.uv[0][None]) ** 2).sum(-1)
            v_det = v_det & ~((d2ex < 25.0) & tracks.valid[0][None, :]).any(1)
        else:
            uv_det, _, v_det = detect.detect_features(
                img0, existing_uv=tracks.uv[0], existing_valid=tracks.valid[0],
                gh=8, gw=10, k_per_cell=max(1, self.cfg.features[0].n_per_cell))
        M = uv_det.shape[0]
        # 1b. resurrection: dead in-map landmarks re-associated to the
        # mutual-nearest fresh detection within 5 px of their projection
        dead = window.lmk_mask & ~tracks.valid[0]
        uv_prj, vis_p = cameras.project_world(self.rig.cam.camera(0), R_kf, t_kf,
                                              self.rig.R_f_s[0], self.rig.t_f_s[0], window.lmk)
        d2 = ((uv_prj[:, None] - uv_det[None, :]) ** 2).sum(-1)
        gate = (dead & vis_p)[:, None] & v_det[None, :] & (d2 < 25.0)
        d2g = torch.where(gate, d2, torch.full_like(d2, float("inf")))
        bestd = torch.argmin(d2g, 1)
        bestl = torch.argmin(d2g, 0)
        hit = (d2g.amin(1) < float("inf")) & (bestl[bestd] == ar_L)
        uv0_base = torch.where(hit[:, None], uv_det[bestd], tracks.uv[0])
        v0_base = tracks.valid[0] | hit
        consumed = torch.zeros(M + 1, dtype=torch.bool, device=dev).scatter(
            0, torch.where(hit, bestd, M), hit)[:M]
        v_det = v_det & ~consumed
        window = window.replace(lmk_flags=torch.where(
            hit, window.lmk_flags | LMK_RESURRECTED, window.lmk_flags))

        # assign detection d -> the (rank of d)-th free slot
        free = ~(v0_base | window.lmk_mask) & (ar_L < slot_limit)
        det_rank = torch.cumsum(v_det.long(), 0) - 1
        n_free = free.sum()
        order = torch.argsort((~free).to(torch.uint8), stable=True)
        free_slots = torch.where(ar_L < n_free, order, L - 1)
        take = v_det & (det_rank < n_free)
        slot_of_det = torch.where(take, free_slots[torch.clamp(det_rank, 0, L - 1)], L)
        pad = lambda x, fill: torch.cat(
            [x, torch.full((1, *x.shape[1:]), fill, dtype=x.dtype, device=dev)])
        new_uv0 = pad(uv0_base, 0.0).index_put((slot_of_det,), uv_det)[:L]
        new_v0 = pad(v0_base, False).index_put((slot_of_det,), torch.ones_like(v_det))[:L]
        # a claimed slot is a new landmark: clear its stale observation rows
        claimed = torch.zeros(L + 1, dtype=torch.bool, device=dev).index_put(
            (slot_of_det,), take)[:L]
        obs = obs.replace(mask=obs.mask & ~claimed[None, None, :])
        return uv_det, v_det, take, slot_of_det, new_uv0, new_v0, window, obs

    @graphs.stage(key_attrs=("klt_engine",))
    def _insert_kf(self, pyr_new, tracks: TrackState, window: WindowState, obs: Observations,
                   imu_chain: ImuChain, pre_cur, R_kf, t_kf, v_kf, ts, slot,
                   imu_gap_ok: bool = True, gm=None, lmk_desc=None, ext_det=None):
        """Insert a keyframe at ``slot``: detect (or take the csv keypoints
        ``ext_det``), resurrect, stereo-track, triangulate, write the
        observation rows.  ``ts`` (the keyframe's stamp, in ``window.ts``'s
        dtype) and ``slot`` (int64) are 0-d tensors.

        Returns (tracks, window, obs, imu_chain); with a global map ``gm``
        also (lmk_desc, gm_counts, gm_pack): the slot descriptors refreshed
        at this keyframe, [claimed resurrections, archive hits] and the
        per-detection loop-closure material [uv(2), archived landmark(3),
        source keyframe index(1), hit(1)]."""
        dev = self.device
        cam0, cam1 = self.rig.cam.camera(0), self.rig.cam.camera(1)
        Rfs, tfs = self.rig.R_f_s, self.rig.t_f_s
        L = self.caps.L
        img0 = pyr_new[0][0]
        uv_det, v_det, take, slot_of_det, new_uv0, new_v0, window, obs = \
            self._detect_into_slots(img0, tracks, window, obs, R_kf, t_kf, L, ext_det)

        # 1c. long-range resurrection from the descriptor global map: fresh
        # detections that match an archived landmark by projection + BRIEF
        # descriptor adopt its archived position, so the map re-uses old
        # structure when the camera revisits it
        if gm is not None:
            sm0 = detect.smooth3(img0)
            lmk_arch, hit_a, src_a = gmap.resurrect(
                gm, cam0, R_kf, t_kf, Rfs[0], tfs[0], uv_det,
                detect.brief_describe(sm0, uv_det), v_det)
            upd = hit_a & take  # only detections that claimed a slot
            upd_slot = torch.where(upd, slot_of_det, L)
            window = window.replace(
                lmk=gmap.put_rows(window.lmk, upd_slot, lmk_arch),
                lmk_mask=gmap.put_rows(window.lmk_mask, upd_slot, torch.ones_like(upd)),
                lmk_flags=gmap.put_rows(window.lmk_flags, upd_slot,
                               torch.full_like(upd_slot, LMK_RESURRECTED)))
            # every confident 2D-3D re-association (not only the
            # slot-claiming ones) is loop-closure material
            gm_pack = torch.cat([uv_det, lmk_arch, src_a[:, None].float(),
                                 hit_a[:, None].float()], -1)
            gm_counts = torch.stack([upd.sum(), hit_a.sum()])

        # 2. stereo track cam0 -> cam1 and the static epipolar gate
        uv1, ok1, _ = klt.track(pyr_new[0], pyr_new[1], new_uv0, new_uv0, new_v0,
                                levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                                engine=self.klt_engine)
        R_01, t_01 = geo.pose_compose(*geo.pose_inverse(Rfs[0], tfs[0]), Rfs[1], tfs[1])
        r0 = cam0.backproject(new_uv0)
        r1 = cam1.backproject(uv1)
        ok1 = epipolar.epipolar_filter(R_01, t_01, r0, r1, ok1)

        # 3. triangulate slots without a landmark yet
        R_w_s0, t_w_s0 = geo.pose_compose(R_kf, t_kf, Rfs[0], tfs[0])
        R_w_s1, t_w_s1 = geo.pose_compose(R_kf, t_kf, Rfs[1], tfs[1])
        rays_w = torch.stack([geo.mv(R_w_s0, r0), geo.mv(R_w_s1, r1)])
        p_tri, tri_ok = triangulate.stereo_triangulate(
            torch.stack([t_w_s0, t_w_s1]), rays_w, torch.stack([new_v0, ok1 & new_v0]))
        add3d = new_v0 & ~window.lmk_mask & tri_ok
        lmk = torch.where(add3d[:, None], p_tri, window.lmk)
        new_v0 = new_v0 & (window.lmk_mask | add3d)  # drop untriangulated fresh
        lmk_mask = window.lmk_mask | add3d
        ok1 = ok1 & new_v0

        # 4. write the window slot
        window = self._write_slot(window, slot, R_kf, t_kf, v_kf, ts).replace(
            lmk=lmk, lmk_mask=lmk_mask)
        obs = obs.replace(uv=_set(obs.uv, slot, torch.stack([new_uv0, uv1])),
                          mask=_set(obs.mask, slot, torch.stack([new_v0, ok1])))
        imu_chain = self._write_imu(imu_chain, slot, pre_cur, imu_gap_ok)
        tracks = TrackState(uv=torch.stack([new_uv0, uv1]), valid=torch.stack([new_v0, ok1]),
                            uv_kf=torch.stack([new_uv0, uv1]), has3d=lmk_mask)
        if gm is not None:
            # refresh the slot descriptors at this keyframe (archived on marginalize)
            lmk_desc = torch.where(new_v0[:, None], detect.brief_describe(sm0, new_uv0),
                                   lmk_desc)
            return tracks, window, obs, imu_chain, lmk_desc, gm_counts, gm_pack
        return tracks, window, obs, imu_chain

    @staticmethod
    def _write_slot(window, slot, R_kf, t_kf, v_kf, ts):
        """The window with keyframe ``slot`` (a 0-d tensor) set to the pose,
        velocity and stamp, and its biases carried over from the slot before."""
        prev = torch.clamp(slot - 1, min=0)
        return window.replace(
            R=_set(window.R, slot, R_kf), t=_set(window.t, slot, t_kf),
            v=_set(window.v, slot, v_kf), ba=_set(window.ba, slot, take(window.ba, prev)),
            bg=_set(window.bg, slot, take(window.bg, prev)),
            kf_mask=_set(window.kf_mask, slot, True), ts=_set(window.ts, slot, ts))

    @staticmethod
    def _write_imu(imu_chain, slot, pre_cur, imu_gap_ok):
        """The chain with ``pre_cur`` as the factor into ``slot`` (none into
        slot 0); a >1 s inter-KF gap, judged on the host in f64, drops it."""
        prev = torch.clamp(slot - 1, min=0)
        new = imu_chain.replace(
            pre=tree_map(lambda a, b: _set(a, prev, b), imu_chain.pre, pre_cur),
            mask=_set(imu_chain.mask, prev, (pre_cur.dt > 1e-6) & imu_gap_ok))
        return select(slot > 0, new, imu_chain)

    @graphs.stage(eager_if=_has_lines)
    def _backend(self, window, obs, imu_chain, priors, fixed_n: int, lines=None):
        """Window BA + outlier removal.  ``lines``: an optional LineBlock
        whose lines constrain poses; the optimized endpoints come back in
        stats["line_ends"] and the observations that fail the same 3 px gate
        (perpendicular error) are dropped in stats["line_obs_mask"]."""
        fixed = torch.arange(self.caps.K, device=self.device) < fixed_n
        problem = ba.BAProblem(window, obs, self.rig, imu_chain, priors, fixed, False, lines)
        new_window, stats = ba.ba_solve(problem, self._ba_opts)
        r, _, _, m, _ = ba._reproj_terms(new_window, obs, self.rig, self._ba_opts)
        bad_obs = m.bool() & (torch.linalg.norm(r, dim=-1) > 3.0)
        obs = obs.replace(mask=obs.mask & ~bad_obs)
        starved = new_window.lmk_mask & (obs.mask.sum((0, 1)) < 2)
        new_window = new_window.replace(lmk_mask=new_window.lmk_mask & ~starved)
        if lines is not None:
            ends = stats["line_ends"]
            perr = torch.stack([lines_mod.line_reproj_residual(
                self.rig.cam.camera(c), new_window.R[:, None], new_window.t[:, None],
                self.rig.R_f_s[c], self.rig.t_f_s[c], ends[None, :, 0], ends[None, :, 1],
                lines.obs[:, c])[0][..., :2].abs().amax(-1) for c in range(2)], 1)
            stats["line_obs_mask"] = lines.obs_mask & ~(lines.mask[None, None, :] & (perr > 3.0))
        return new_window, obs, stats

    @graphs.stage
    def _marg_roll(self, window, obs, imu_chain, priors, tracks, vio: bool, gm=None,
                   lmk_desc=None, arch_idx=None):
        """Marginalize slot 0 and shift the window left by one.  With a
        global map ``gm`` the landmarks that leave the map are archived
        (position + BRIEF descriptor, and ``arch_idx``, a 0-d tensor, as
        their source keyframe) and the new map is returned before the
        overflow count."""
        if self.cfg.marginalization:
            new_priors, info = marg.marginalize(
                window, obs, self.rig, imu_chain, priors, self._ba_opts, vio=vio,
                sparsify=self.cfg.sparsification, f64=self.cfg.marg_f64)
            marg_lmk, n_overflow, degen = (info["marg_lmk"], info["n_keep_overflow"],
                                           info["degenerate"])
        else:
            new_priors = PriorSet.create(self.caps.K, self.caps.P, device=self.device)
            seen0 = obs.mask[0].any(0)
            elsewhere = obs.mask[1:].flatten(0, 1).any(0)
            marg_lmk = window.lmk_mask & seen0 & ~elsewhere
            n_overflow = torch.zeros((), dtype=torch.int64, device=self.device)
            degen = torch.zeros((), dtype=torch.bool, device=self.device)
        new_priors = marg.shift_priors(new_priors)
        if gm is not None:
            gm = gmap.archive(gm, window.lmk, lmk_desc, marg_lmk, src_idx=arch_idx)
        roll = lambda x: torch.roll(x, -1, 0)
        last_off = lambda x: _set(roll(x), x.shape[0] - 1, False)
        window = window.replace(
            R=roll(window.R), t=roll(window.t), v=roll(window.v), ba=roll(window.ba),
            bg=roll(window.bg), ts=roll(window.ts), kf_mask=last_off(window.kf_mask),
            lmk_mask=window.lmk_mask & ~marg_lmk)
        obs = obs.replace(uv=roll(obs.uv), mask=last_off(obs.mask & ~marg_lmk[None, None, :]))
        imu_chain = imu_chain.replace(pre=tree_map(roll, imu_chain.pre),
                                      mask=last_off(imu_chain.mask))
        tracks = tracks.replace(valid=tracks.valid & ~marg_lmk[None, :],
                                has3d=tracks.has3d & ~marg_lmk)
        if gm is not None:
            return window, obs, imu_chain, new_priors, tracks, gm, n_overflow, degen
        return window, obs, imu_chain, new_priors, tracks, n_overflow, degen

    @graphs.stage
    def _roll_edge(self, window, obs, imu_chain, vio: bool):
        """The pose-graph edge from slot 0 to slot 1, packed: dx (6), info
        (36), shared landmarks (1)."""
        dx_e, inf_e, n_sh = marg.marginalize_relative(window, obs, self.rig, imu_chain,
                                                      self._ba_opts, vio=vio)
        return torch.cat([dx_e, inf_e.reshape(-1), n_sh.float()[None]])

    # ------------------------------------------------------------------
    # host-side frame loop
    # ------------------------------------------------------------------

    def _predict_pose(self, frame):
        """IMU prediction once VIInit has given velocities and biases, else
        the constant-velocity model (see the module docstring)."""
        if self.vio and self._imu_n > 0 and self.vi_initialized:
            w = self.window
            return self._predict_imu(self.pre_cur, w.R, w.t, w.v, w.ba, w.bg,
                                     self._int_scalar(self.n_kf - 1))
        return self._predict_cv(self.R_cur, self.t_cur, *self.dT, self.v_cur)

    @graphs.stage
    def _predict_imu(self, pre, R, t, v, ba, bg, k):
        return imu_mod.predict(pre, take(R, k), take(t, k), take(v, k), ba=take(ba, k),
                               bg=take(bg, k))

    @graphs.stage
    def _predict_cv(self, R, t, dR, dt, v):
        R_p, t_p = geo.pose_compose(R, t, dR, dt)
        return R_p, t_p, v

    @graphs.stage
    def _preint(self, batch, pre):
        """One (IMU_CAP, 7) batch [acc, gyr, dt] into ``pre``; padding rows
        have dt = 0 and are exact no-ops."""
        return imu_mod.preintegrate(batch[:, 0:3], batch[:, 3:6], batch[:, 6], pre.ba_lin,
                                    pre.bg_lin, self.imu_params, init=pre)

    def _pack_imu(self, frame):
        """The frame's IMU samples as (n_batches, IMU_CAP, 7) float32 host
        batches, zero-padded: one shape, whatever the sample count."""
        n, cap = len(frame.dt), self.IMU_CAP
        out = np.zeros((-(-n // cap), cap, 7), np.float32)
        flat = out.reshape(-1, 7)
        flat[:n, 0:3] = frame.acc
        flat[:n, 3:6] = frame.gyr
        flat[:n, 6] = frame.dt
        return out

    def _accumulate_imu(self, frame):
        """Preintegrate the frame's samples in fixed-shape batches: one
        ``_preint`` call (one graph replay on the card) per IMU_CAP samples.
        On the card the batches go up through a pinned buffer, copied
        without blocking."""
        n = len(frame.dt)
        if n == 0:
            return
        packed = self._pack_imu(frame)
        if self.device.type == "cuda":
            buf = _next_pinned(self._ibufs, torch.float32, packed.shape, self.trace)
            buf.numpy()[...] = packed
            batches = buf.to(self.device, non_blocking=True)
            _mark_pinned(self._ibufs, buf)
        else:
            batches = torch.from_numpy(packed)
        for b in range(batches.shape[0]):
            self.pre_cur = self._preint(batches[b], self.pre_cur)
        self._imu_n += n

    def _gravity_align_init(self, frame):
        """First-pose gravity alignment from the averaged accelerometer."""
        eye = torch.eye(3, device=self.device)
        if len(frame.acc) < 5:
            return eye
        a = np.asarray(frame.acc).mean(0)
        a = a / np.linalg.norm(a)
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(a, z)
        s = np.linalg.norm(v)
        if s < 1e-8:
            return eye
        w = v / s * np.arctan2(s, float(np.dot(a, z)))
        return geo.so3_exp(torch.as_tensor(w, dtype=torch.float32, device=self.device)).T

    def _health_copy(self, health):
        """Start the device-to-host copy of a frame's health vector and return
        the fetch for ``_read_health``.  On the card the copy goes into one
        of two pinned host buffers, used in turn, with ``non_blocking=True``
        and an event behind it; a buffer is refilled only once the event of
        its previous copy has fired."""
        if self.device.type != "cuda":
            return health, None
        buf = _next_pinned(self._hbufs, health.dtype, health.shape, self.trace)
        buf.copy_(health, non_blocking=True)
        return buf, _mark_pinned(self._hbufs, buf)

    def _read_health(self, fetch):
        """The health vector of a fetch, on the host; waits for its copy."""
        buf, done = fetch
        if done is not None:
            with self.trace.span("health.wait"):
                done.synchronize()
        return buf.numpy().copy()

    def _health_to_out(self, out):
        """The per-frame output from the last ingested health; ``pose_ts`` is
        the frame's own stamp unless the health lags by one frame."""
        ts_h, health_h = self._last_health
        out.update(pose=(health_h[4:13].reshape(3, 3).copy(), health_h[13:16].copy()),
                   pose_ts=ts_h, pnp_ok=bool(health_h[0] > 0.5), n_tracked=int(health_h[2]),
                   n_lmk_tracked=int(health_h[3]), parallax_deg=float(health_h[1]))
        return ts_h, health_h

    def _flush_health(self):
        """Ingest a still-pending async health fetch (the last frame's
        trajectory and log rows): at run end, before the logs are written,
        before a reset and before a checkpoint."""
        if self._health_pend is not None:
            ts, fetch = self._health_pend
            self._health_pend = None
            self._ingest_health(ts, self._read_health(fetch))

    def _ingest_health(self, ts, health_h):
        pnp_ok = bool(health_h[0] > 0.5)
        self.successive_fails = 0 if pnp_ok else self.successive_fails + 1
        self._cov_h = health_h[19:55].reshape(6, 6).copy()
        t_h = health_h[13:16].copy()
        self.traj.append((ts, health_h[4:13].reshape(3, 3).copy(), t_h))
        if self.vio:
            self.vio_log.append((ts, *t_h, *health_h[16:19], *self._ba_h, *self._bg_h))
        self._last_health = (ts, health_h)

    def _bootstrap(self, frame, pyr_new, out: dict) -> dict:
        """The first keyframe (after a reset too): a stereo keyframe at the
        gravity-aligned origin, or at the relocalized pose.  Subclasses
        replace it with their own bootstrap."""
        dev = self.device
        R0 = self._gravity_align_init(frame) if self.vio else torch.eye(3, device=dev)
        t0 = torch.zeros(3, device=dev)
        # relocalization after a tracking failure: reset() keeps the
        # global map and the last pose estimate; if enough archived
        # landmarks re-associate around that pose, the bootstrap
        # keyframe continues the original gauge instead of re-zeroing
        if self.global_map_state is not None and self.n_resets > 0:
            rl = self._try_relocalize(pyr_new[0][0])
            if rl is not None:
                R0, t0 = rl
                out["relocalized"] = True
        self.R_cur, self.t_cur = R0, t0
        ins = self._insert_kf(
            pyr_new, self.tracks, self.window, self.obs, self.imu, self.pre_cur,
            R0, t0, torch.zeros(3, device=dev), self._ts_scalar(frame.ts), self._int_scalar(0),
            gm=self.global_map_state, lmk_desc=self.lmk_desc, ext_det=self._csv_det(frame))
        self.tracks, self.window, self.obs, self.imu = ins[:4]
        R0_h, t0_h = R0.cpu().numpy(), t0.cpu().numpy()
        if self.global_map_state is not None:
            self.lmk_desc, gm_counts, gm_pack = ins[4:]
            counts_h = gm_counts.cpu().numpy()
            out["gm_resurrected"] = int(counts_h[0])
            # the relocalized bootstrap keyframe was just re-associated
            # against the archive around the kept pose: emit the loop
            # edge to the archived anchor now
            if (out.get("relocalized") and self.cfg.pose_graph and self.archived_kf
                    and int(counts_h[1]) >= self.cfg.lc_min_hits):
                lc = self._try_loop_closure(gm_pack, frame.ts, R0_h, t0_h)
                if lc is not None:
                    out["loop_closure"] = lc
        self.n_kf = 1
        self.pre_cur = self._pre_id
        self._imu_n = 0
        self.kf_pyr = pyr_new
        self.kf_tmpl = self._template_cache(pyr_new, self.tracks.uv_kf[0])
        self.initialized = True
        self.kf_ts.append(frame.ts)
        self.kf_cov.append(np.zeros((6, 6)))
        self.kf_traj.append((frame.ts, R0_h, t0_h))
        self.traj.append((frame.ts, R0_h, t0_h))
        out["is_kf"] = True
        if self._line_ch is not None:
            out.update(self._line_ch.on_keyframe_pre_ba(pyr_new[0][0], pyr_new[1][0], R0, t0, 0))
        return out

    def _ts_scalar(self, ts):
        """A keyframe stamp as a 0-d tensor in the window's stamp dtype."""
        return torch.full((), float(ts), dtype=self.window.ts.dtype, device=self.device)

    def _int_scalar(self, i):
        """A slot or an index as a 0-d int64 tensor (a stage argument that
        changes per call must not key a captured variant)."""
        return torch.full((), int(i), dtype=torch.int64, device=self.device)

    def _upload_images(self, frame):
        """Host-to-device copy of ``frame.images`` in the provider's dtype
        (uint8 from a recorded sequence; float renders are shipped exactly).
        On the card the copy goes through one of two pinned host buffers,
        used in turn, with ``non_blocking=True``: it overlaps the work queued
        before it, and a buffer is refilled only once the event recorded
        behind its previous copy has fired."""
        imgs = np.ascontiguousarray(frame.images)
        with self.trace.span("upload"):
            if self.device.type != "cuda":
                return torch.as_tensor(imgs.copy(), device=self.device)
            buf = _next_pinned(self._pins, torch.from_numpy(imgs).dtype, imgs.shape, self.trace)
            buf.numpy()[...] = imgs
            out = buf.to(self.device, non_blocking=True)
            _mark_pinned(self._pins, buf)
            return out

    def process_frame(self, frame, images_dev=None, prefetch_frame=None) -> dict:
        """One frame of the rig (+ the IMU samples since the previous frame).

        images_dev: the frame's images already on the device (from the
        previous call's prefetch).  prefetch_frame: the next frame, whose
        images are uploaded after this frame's IMU batch, so the copy runs
        during this frame's work; the device copy is left in
        ``self._prefetched``.  The frame is a ``frame`` span of
        ``self.trace``, the parent of every span of its work.  Under
        ``run(profile=True)`` every stage is timed to the end of its device
        work, which serializes the loop, and the frame's time to the end of
        its pose goes to ``frame_total`` and ``kf_step`` or ``track_step``."""
        tr = self.trace
        with tr.frame(frame.ts, self._prof):
            tr.prof = self._prof if (self.initialized or self.PROFILE_BOOTSTRAP) else None
            out = self._process_frame(frame, images_dev, prefetch_frame)
            tr.end_frame(out["is_kf"], self.t_cur)
        return out

    def _process_frame(self, frame, images_dev, prefetch_frame) -> dict:
        dev = self.device
        tr = self.trace
        prof = tr.prof
        if self.vio:
            with tr.span("imu_preint", timed=True):
                self._accumulate_imu(frame)
                tr.wait(self.pre_cur.dp)
        if images_dev is None:
            images_dev = self._upload_images(frame)
        self._prefetched = (self._upload_images(prefetch_frame) if prefetch_frame is not None
                            else None)
        with tr.span("pyramids", timed=True):
            pyr_new = self._pyramids(images_dev)
            tr.wait(pyr_new[0][0])
        out = {"ts": frame.ts, "is_kf": False, "ok": True}
        self._last_pyr = pyr_new
        if not self.initialized:
            return self._bootstrap(frame, pyr_new, out)

        R_pred, t_pred, v_pred = self._predict_pose(frame)
        # the health copy waits for the front end, so the span needs no wait
        with tr.span("track_predict_filter", timed=True):
            # the RANSAC subsets come from the generator here, outside the
            # captured front end: the eager and captured runs draw alike
            sample_idx = None if self._epipolar else torch.randint(
                0, self.caps.L, (self.N_HYP, 4), generator=self.gen, device=dev)
            self.tracks, R_new, t_new, health, dR_cv, dt_cv = self._frontend(
                self.kf_pyr, pyr_new, self.tracks, self.window, R_pred, t_pred, v_pred,
                self.R_cur, self.t_cur, kf_tmpl=self.kf_tmpl,
                eskf_on=bool(self.vi_initialized and self._imu_n > 0),
                pre_cov=self.pre_cur.cov if self.vio else None, sample_idx=sample_idx)
            # the health vector: the frame's one device-to-host copy.  With
            # async_health (not under a profiler) it is read one frame late,
            # so no frame waits for its own front end; the first tracked
            # frame and the first after a keyframe (whose parallax was
            # measured against the old template) read their own at once
            fetch = self._health_copy(health)
            if self.cfg.async_health and prof is None:
                pend, self._health_pend = self._health_pend, (frame.ts, fetch)
                if pend is not None:
                    self._ingest_health(pend[0], self._read_health(pend[1]))
                if self._health_stale or self._last_health is None:
                    self._ingest_health(frame.ts, self._read_health(fetch))
                    self._health_pend = None
                    self._health_stale = False
            else:
                self._ingest_health(frame.ts, self._read_health(fetch))
                self._health_pend = None
        self.dT = (dR_cv, dt_cv)
        self.R_cur, self.t_cur, self.v_cur = R_new, t_new, v_pred
        ts_h, health_h = self._health_to_out(out)

        if self.successive_fails > 5:  # failure recovery
            self.reset()
            return out

        # keyframe vote
        dt_kf = frame.ts - self.kf_ts[-1] if self.kf_ts else 0.0
        force_time = self.vio and dt_kf > 1.0
        force_boot = self.n_kf < self.cfg.min_kf_number

        def kf_vote(health_h, parallax_h):
            pnp_ok_h = bool(health_h[0] > 0.5)
            force_kf = (not pnp_ok_h) or int(health_h[3]) < self.cfg.min_lmk_number
            vote_kf = parallax_h > self.cfg.max_movement_parallax
            return (not pnp_ok_h) or force_time or force_boot or (
                (force_kf or vote_kf) and parallax_h >= self.cfg.min_movement_parallax)

        if ts_h != frame.ts:
            # the health is the frame before's: the vote on it is only a
            # candidate gate, with the parallax extrapolated by 1.5x its last
            # rise so that threshold crossings surface on time; a candidate
            # is confirmed against this frame's own health
            par_stale = parallax_h = float(health_h[1])
            if self._par_prev is not None:
                parallax_h += 1.5 * max(parallax_h - self._par_prev, 0.0)
            self._par_prev = par_stale
            is_kf = kf_vote(health_h, parallax_h)
            if is_kf:
                self._ingest_health(frame.ts, self._read_health(fetch))
                self._health_pend = None
                self._par_prev = None
                _, health_h = self._health_to_out(out)
                is_kf = kf_vote(health_h, float(health_h[1]))
        else:
            self._par_prev = None
            is_kf = kf_vote(health_h, float(health_h[1]))
        if not is_kf:
            return out

        out["is_kf"] = True
        # the tracking template changes below: the next vote must not run on
        # health measured against the old one
        self._health_stale = True
        self._par_prev = None
        K = self.caps.K
        n_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        degen = torch.zeros((), dtype=torch.bool, device=dev)
        did_marg = False
        if self.n_kf >= K:
            # archive the leaving keyframe; with pose_graph, condense its
            # links to the next keyframe into a relative-pose edge.  Pose
            # and edge ride one device-to-host copy; timestamps come from
            # the host mirror
            vio_now = self.vio and self.vi_initialized
            pose0 = [self.window.R[0].reshape(-1), self.window.t[0]]
            # the leaving keyframe's archive, and its edge with pose_graph
            # (the profile mode times the span only then, as the JAX package)
            with tr.span("nfr_edge", timed=self.cfg.pose_graph):
                if self.cfg.pose_graph:
                    pose0.append(self._roll_edge(self.window, self.obs, self.imu, vio_now))
                with tr.span("archive.wait"):
                    pk0 = torch.cat(pose0).cpu().numpy()
                self.archived_kf.append((self.kf_ts[0], pk0[:9].reshape(3, 3),
                                         pk0[9:12].copy()))
                if self.cfg.pose_graph and pk0[54] > 0:  # shared landmarks: an informative edge
                    inf_np = pg.inflate_edge_info(pk0[18:54].reshape(6, 6), self.kf_cov[0],
                                                  self.kf_cov[1])
                    self.pose_graph_edges.append((self.kf_ts[0], self.kf_ts[1],
                                                  pk0[12:18].copy(), inf_np))
            with tr.span("marginalization", timed=True):
                mr = self._marg_roll(self.window, self.obs, self.imu, self.priors, self.tracks,
                                     vio_now, gm=self.global_map_state, lmk_desc=self.lmk_desc,
                                     arch_idx=self._int_scalar(len(self.archived_kf) - 1))
                if self.global_map_state is not None:
                    (self.window, self.obs, self.imu, self.priors, self.tracks,
                     self.global_map_state, n_ovf, degen) = mr
                else:
                    self.window, self.obs, self.imu, self.priors, self.tracks, n_ovf, degen = mr
                tr.wait(self.window.R)
            did_marg = True
            if self.cfg.marginalization:
                self._have_priors = True
            if self._line_ch is not None:
                self._line_ch.on_roll()  # the slot-aligned line rows shift too
            self.kf_ts.pop(0)
            self.kf_cov.pop(0)
            self.n_kf = K - 1
            self._maybe_compact_archive()
        slot = self.n_kf
        # detection, stereo track, triangulation and the template cache
        with tr.span("detect_lmk_init", timed=True):
            gap_ok = (not self.kf_ts) or (frame.ts - self.kf_ts[-1]) <= 1.0
            lmk_before = self.window.lmk_mask
            ins = self._insert_kf(
                pyr_new, self.tracks, self.window, self.obs, self.imu, self.pre_cur,
                R_new, t_new, v_pred, self._ts_scalar(frame.ts), self._int_scalar(slot),
                imu_gap_ok=bool(gap_ok), gm=self.global_map_state, lmk_desc=self.lmk_desc,
                ext_det=self._csv_det(frame))
            self.tracks, self.window, self.obs, self.imu = ins[:4]
            gm_counts = gm_pack = None
            # the window's landmarks after the insertion and those it
            # triangulated (the slots new to the map, less the archive
            # resurrections): they ride the keyframe's state copy below
            lmk_after = self.window.lmk_mask
            lmk_counts = torch.stack([lmk_after.sum(), (lmk_after & ~lmk_before).sum()])
            if self.global_map_state is not None:
                self.lmk_desc, gm_counts, gm_pack = ins[4:]
                lmk_counts[1] -= gm_counts[0]
            self.n_kf += 1
            self.kf_ts.append(frame.ts)
            self.kf_cov.append(self._cov_h)
            self.kf_pyr = pyr_new
            self.kf_tmpl = self._template_cache(pyr_new, self.tracks.uv_kf[0])
            self.pre_cur = self._pre_id.replace(ba_lin=self.window.ba[slot],
                                                bg_lin=self.window.bg[slot])
            self._imu_n = 0
            tr.wait(self.tracks.uv)

        # the line channel detects and associates at the new keyframe before
        # the BA, and its lines enter the BA
        ba_lines = None
        if self._line_ch is not None:
            with tr.span("line_channel", timed=True):
                out.update(self._line_ch.on_keyframe_pre_ba(pyr_new[0][0], pyr_new[1][0], R_new,
                                                            t_new, slot))
                ba_lines = self._line_ch.ba_block()
                tr.wait(ba_lines.ends)
        fixed_n = 1 if not self._have_priors else 0
        fixed_n = max(fixed_n, self.cfg.fixed_frame_number if self.n_kf > 1 else 1)
        # vision-only window BA until VIInit has run
        imu_for_ba = (self.imu if self.vi_initialized else
                      self.imu.replace(mask=torch.zeros_like(self.imu.mask)))
        with tr.span("window_opt", timed=True):
            if self.backend_exec is not None:
                self.backend_exec.submit_fn(self._backend, self.window, self.obs, imu_for_ba,
                                            self.priors, fixed_n, ba_lines)
                self.window, self.obs, stats = self.backend_exec.collect()
            else:
                self.window, self.obs, stats = self._backend(self.window, self.obs, imu_for_ba,
                                                             self.priors, fixed_n, ba_lines)
            if ba_lines is not None:
                self._line_ch.apply_ba(stats["line_ends"], stats["line_obs_mask"])
            tr.wait(self.window.R)
        self.R_cur = self.window.R[slot]
        self.t_cur = self.window.t[slot]
        self.v_cur = self.window.v[slot]
        self.tracks = self.tracks.replace(has3d=self.window.lmk_mask)
        if self.vio and not self.vi_initialized and self.n_kf >= self.vio_init_kfs:
            with tr.span("vi_init"):
                self._run_vi_init()
        w = self.window
        parts = [w.R[slot].reshape(-1), w.t[slot], w.v[slot], w.ba[slot], w.bg[slot],
                 torch.stack([n_ovf.float(), degen.float(), stats["cost"].float()]),
                 lmk_counts.float()]
        if gm_counts is not None:
            parts.append(gm_counts.float())
        with tr.span("kf.wait"):
            pk = torch.cat(parts).cpu().numpy()  # the keyframe's one state copy
        self.kf_traj.append((frame.ts, pk[:9].reshape(3, 3), pk[9:12]))
        self._ba_h = pk[15:18].copy()
        self._bg_h = pk[18:21].copy()
        out["keep_overflow"] = int(pk[21])
        if prof and did_marg:
            prof.sums["keep_overflow_lmk"] += int(pk[21])
            prof.counts["keep_overflow_lmk"] += 1
        out["marg_degenerate"] = bool(pk[22] > 0.5)
        out["ba_cost"] = float(pk[23])
        with tr.span("kf.landmarks", int(pk[24])), tr.span("kf.born", int(pk[25])):
            pass
        if gm_counts is not None:
            out["gm_resurrected"] = int(pk[26])
            # loop closure: a burst of descriptor resurrections is a revisit
            # signal.  The hit count (riding the copy above) gates the copy
            # of the per-detection pack, so other keyframes never pay it;
            # the PnP warm-starts at the post-BA keyframe pose
            if (self.cfg.pose_graph and self.archived_kf
                    and int(pk[27]) >= self.cfg.lc_min_hits):
                lc = self._try_loop_closure(gm_pack, frame.ts, pk[:9].reshape(3, 3), pk[9:12])
                out["lc_diag"] = self._lc_diag
                if lc is not None:
                    out["loop_closure"] = lc
        out["vi_initialized"] = self.vi_initialized
        if self.mesher is not None:  # densification at keyframe rate
            with tr.span("mesh", timed=True):
                imgs = torch.stack([pyr_new[c][0] for c in range(2)])
                self.mesher.update(imgs, self.window, self.R_cur, self.t_cur)
                out["mesh_triangles"] = int(self.mesher.tri_mask.sum())
                tr.wait(self.mesher.tri_mask)
        img1 = pyr_new[1][0] if self.C > 1 else pyr_new[0][0]
        for ch in self.channels:
            if ch is not self._line_ch:  # the line channel ran before the BA
                out.update(ch.on_keyframe(frame, pyr_new[0][0], img1, self.R_cur, self.t_cur))
        return out

    def _run_vi_init(self):
        """VI bootstrap: gravity/velocity/shared-bias (and, with
        ``_vi_opt_scale``, scale) solve over the window, then rotate and
        rescale the map gravity-down and run a full VI window BA.  A
        non-converged solve, |ba| > 1 m/s^2 or a solved scale that the
        window does not see is rejected and retried at the next keyframe.

        The scale is seen when holding it at half its solve would at least
        double the cost, gravity, velocities and biases free: information
        on log s at least ``SCALE_SEEN`` times the cost (a deviation from
        the JAX package, ROADMAP C11).  Where the IMU links do not see the
        scale (too little acceleration, or a chain cut short) the cost is
        flat in it, and the solve may settle anywhere, down to nearly 0,
        with the accelerometer bias inside its gate."""
        res = viinit.vi_init(self.window.R, self.window.t, self.window.kf_mask,
                             self._vi_init_chain(), optimize_scale=self._vi_opt_scale, iters=20)
        ok = res["converged"]
        if self._vi_opt_scale:
            ok = ok & (res["scale_info"] >= self.SCALE_SEEN * res["cost"])
        ok_h = torch.cat([ok.float()[None], res["ba"]]).cpu().numpy()
        if not ok_h[0] > 0.5 or np.linalg.norm(ok_h[1:4]) > 1.0:
            return
        K = self.caps.K
        R_align, s = res["R_align"], res["scale"]
        self.window = viinit.apply_alignment(self.window, R_align, s).replace(
            v=res["v"], ba=res["ba"].expand(K, 3).clone(), bg=res["bg"].expand(K, 3).clone())
        self.R_cur = R_align @ self.R_cur
        self.t_cur = s * (R_align @ self.t_cur)
        if self._have_priors:
            # priors made before the alignment must move with the map
            self.priors = marg.gauge_transform_priors(self.priors, R_align, s)
        if self._line_ch is not None:
            self._line_ch.gauge_transform(R_align, s)
        self.vi_initialized = True
        self.window, self.obs, _ = self._backend(self.window, self.obs, self.imu,
                                                 self.priors, 1)
        k = self.n_kf - 1
        self.R_cur, self.t_cur, self.v_cur = self.window.R[k], self.window.t[k], self.window.v[k]
        self.pre_cur = self.pre_cur.replace(ba_lin=self.window.ba[k], bg_lin=self.window.bg[k])

    def _vi_init_chain(self):
        """The IMU links VIInit solves over: the window's chain as the BA
        has it."""
        return self.imu

    def _probe_archive(self, img0, R_seed, t_seed):
        """Detect fresh features and re-associate them against the archive
        around the seed pose, in the wide box of ``reloc_search_px`` (the
        pose drifted during the failure).  Returns (uv (M,2), archived
        landmark (M,3), hit (M,)).  Parallels step 1c of _insert_kf, with
        no live tracks to respect."""
        L = self.caps.L
        dev = self.device
        uv_det, _, v_det = detect.detect_features(
            img0, existing_uv=torch.zeros((L, 2), device=dev),
            existing_valid=torch.zeros(L, dtype=torch.bool, device=dev),
            gh=8, gw=10, k_per_cell=max(1, self.cfg.features[0].n_per_cell))
        det_desc = detect.brief_describe(detect.smooth3(img0), uv_det)
        lmk_arch, hit, _ = gmap.resurrect(
            self.global_map_state, self.rig.cam.camera(0), R_seed, t_seed, self.rig.R_f_s[0],
            self.rig.t_f_s[0], uv_det, det_desc, v_det, search_px=self.cfg.reloc_search_px)
        return uv_det, lmk_arch, hit

    def _try_relocalize(self, img0):
        """Re-anchor the post-reset bootstrap pose against the archived map.

        Local relocalization: the last pose estimate (kept across reset())
        seeds both the archive projection search and the PnP warm start.
        The recovery scenario is tracking loss from occlusion or blur with
        the camera still near its last estimate, not the kidnapped-robot
        problem.  Returns (R0, t0) in the original gauge, or None."""
        uv, lmk, hit = self._probe_archive(img0, self.R_cur, self.t_cur)
        min_hits = self.cfg.lc_min_hits
        R_p, t_p, inl, ok, _ = pnp.pnp_ransac(
            self.rig.cam.camera(0), self.rig.R_f_s[0], self.rig.t_f_s[0], lmk, uv, hit,
            self.R_cur, self.t_cur, self.gen, min_inliers=min_hits, inlier_px=3.0)
        n_hit, n_inl, ok_h = torch.stack([hit.sum(), inl.sum(), ok.long()]).tolist()
        if n_hit < min_hits or not ok_h:
            return None
        if n_inl < max(min_hits, int(self.cfg.reloc_consensus * n_hit)):
            return None
        return R_p, t_p

    def _try_loop_closure(self, gm_pack, ts_cur, R_cur, t_cur):
        """Emit a loop-closure pose-graph edge from a resurrection burst.

        gm_pack (M,7): per-detection [uv, archived landmark, source keyframe
        index, hit] from _insert_kf; R_cur, t_cur: the keyframe's pose on
        the host.  Solves PnP of the current keyframe against all
        re-associated archived landmark positions: the archive shares one
        world gauge, so hits from several archived keyframes jointly
        constrain the revisit.  The PnP-against-archive pose is the edge
        measurement: it expresses the current keyframe directly in the
        archive gauge, whereas the post-BA pose still carries the window's
        accumulated drift.  The edge anchors at the dominant source
        keyframe and is weighted by the PnP covariance inflated with the
        frame-rate ESKF covariance.  Returns (ts_archived, ts_cur) or None."""
        dev = self.device
        pk = gm_pack.cpu().numpy()
        src = pk[:, 5].astype(np.int64)
        cand = (pk[:, 6] > 0.5) & (src >= 0) & (src < len(self.archived_kf))
        n_cand = int(cand.sum())
        min_hits = self.cfg.lc_min_hits
        if n_cand < min_hits:
            self._lc_diag = (n_cand, 0, False)
            return None
        vals, counts = np.unique(src[cand], return_counts=True)
        dom = int(vals[np.argmax(counts)])
        # closures are rare and their pose is the edge measurement: spend
        # more hypotheses and refinement than the frame-rate PnP
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        R_p, t_p, inl, ok, cov = pnp.pnp_ransac(
            self.rig.cam.camera(0), self.rig.R_f_s[0], self.rig.t_f_s[0], gm_pack[:, 2:5],
            gm_pack[:, 0:2], torch.as_tensor(cand, device=dev), f32(R_cur), f32(t_cur),
            self.gen, min_inliers=min_hits, n_hyp=128, refine_iters=12)
        res = torch.cat([R_p.reshape(-1), t_p, cov.reshape(-1),
                         torch.stack([inl.sum(), ok.long()]).float()]).cpu().numpy()
        n_inl, ok_h = int(res[48]), bool(res[49] > 0.5)
        self._lc_diag = (n_cand, n_inl, ok_h)
        # descriptor re-association on weak texture admits false matches
        # inside the search box; a closure is trusted only when the PnP
        # consensus covers a solid majority of the candidates
        if not ok_h or n_inl < max(min_hits, int(self.cfg.lc_consensus * n_cand)):
            return None
        ts_a, R_a, t_a = self.archived_kf[dom]
        dx = pg.relative_pose(R_a, t_a, res[:9].reshape(3, 3), res[9:12])
        # weighted with the current frame's ESKF covariance: the edge
        # attaches to the keyframe being inserted now
        inf = pg.inflate_edge_info(
            np.linalg.inv(res[12:48].reshape(6, 6).astype(np.float64) + 1e-9 * np.eye(6)),
            self._cov_h, np.zeros((6, 6)))
        self.pose_graph_edges.append((ts_a, ts_cur, dx, inf))
        return (float(ts_a), float(ts_cur))

    def _maybe_compact_archive(self):
        """Bound the host-side archive: when the archived node count exceeds
        archive_max_nodes, remove the oldest chain-interior nodes by edge
        composition (posegraph.compact_archive) and remap the global map's
        archiving-keyframe provenance.  Loop-closure endpoints are never
        removed, so the cap is soft under many closures."""
        cap = self.cfg.archive_max_nodes
        if not cap or len(self.archived_kf) <= cap:
            return
        nodes, edges, remap = pg.compact_archive(self.archived_kf, self.pose_graph_edges, cap)
        if len(nodes) == len(self.archived_kf):
            return
        self.archived_kf = nodes
        self.pose_graph_edges = edges
        gm = self.global_map_state
        if gm is not None:
            remap_t = torch.as_tensor(remap, dtype=torch.int64, device=self.device)
            safe = torch.clamp(gm.src, 0, len(remap) - 1)
            self.global_map_state = gm.replace(src=torch.where(gm.src >= 0, remap_t[safe], -1))

    def _window_poses(self):
        """[(ts, R, t)] of the live window keyframes, host numpy, one copy."""
        n = len(self.kf_ts)
        pk = torch.cat([self.window.R[:n].reshape(n, 9), self.window.t[:n]], 1).cpu().numpy()
        return [(ts, pk[j, :9].reshape(3, 3), pk[j, 9:]) for j, ts in enumerate(self.kf_ts)]

    def optimize_archive(self, max_nodes=None):
        """Pose-graph optimization over the archived keyframes + the current
        window.

        max_nodes (default archive_max_nodes): nodes older than the newest
        max_nodes are held fixed (anchors), windowing the correction;
        together with _maybe_compact_archive this keeps the solve bounded
        over arbitrarily long runs.

        Besides the persisted relative-pose and loop-closure edges,
        odometric continuity edges between consecutive live-window nodes are
        synthesized from the current estimates: without them a loop edge is
        the newest nodes' only constraint and teleports them to the raw PnP
        pose; with them, several loop measurements fuse with odometry.

        Returns the corrected trajectory [(ts, R, t)] over archive + window
        nodes; with no edges, returns the nodes unchanged."""
        win_poses = self._window_poses()
        nodes = list(self.archived_kf) + win_poses
        if len(nodes) < 2 or not self.pose_graph_edges:
            return nodes
        dev = self.device
        ts_list = [n[0] for n in nodes]
        ea, eb, dx, W, emask = pg.edges_from_archive(
            self.pose_graph_edges + _odometry_edges(win_poses, self.kf_cov), ts_list, device=dev)
        if ea.shape[0] == 0:
            return nodes
        f32 = lambda xs: torch.as_tensor(np.stack(xs).astype(np.float32), device=dev)
        cap = self.cfg.archive_max_nodes if max_nodes is None else max_nodes
        node_mask = torch.ones(len(nodes), dtype=torch.bool, device=dev)
        if cap and len(nodes) > cap:
            node_mask[: len(nodes) - cap] = False  # old nodes: fixed anchors
        Rn, tn, _ = pg.optimize_pose_graph(f32([n[1] for n in nodes]), f32([n[2] for n in nodes]),
                                           node_mask, ea, eb, dx, W, emask)
        Rn, tn = Rn.cpu().numpy(), tn.cpu().numpy()
        return [(ts_list[i], Rn[i], tn[i]) for i in range(len(nodes))]

    def reset(self):
        """Re-initialize after a tracking failure.  The current pose estimate,
        the global map, the archive and the pose graph are kept: with
        ``global_map`` the live local map is pushed into the archive first
        (the freshest good landmarks are what a relocalization needs), the
        window keyframes join the archived trajectory, and the archived
        landmarks anchor at the last of them.  A pending health fetch (the
        last frame's rows) is ingested first."""
        self._flush_health()
        if self.global_map_state is not None and self.n_kf > 0:
            poses = self._window_poses()
            self.archived_kf.extend(poses)
            # odometric edges among the newly archived nodes: roll-time edges
            # do not cover them, and a loop closure to a floating chain
            # would correct nothing
            if self.cfg.pose_graph:
                self.pose_graph_edges.extend(_odometry_edges(poses, self.kf_cov))
            self.global_map_state = gmap.archive(
                self.global_map_state, self.window.lmk, self.lmk_desc, self.window.lmk_mask,
                src_idx=len(self.archived_kf) - 1)
            self._maybe_compact_archive()
        self._clear()
        if self._line_ch is not None:
            self._line_ch.clear()
        self.n_resets += 1

    def _csv_det(self, frame):
        """The precomputed keypoints of this frame, (uv (256,2), valid) on
        the device, or None without the csv detector.  Files are named by
        nanosecond stamps; float64 seconds cannot round-trip EuRoC-size
        stamps, so the folder is indexed once and the nearest stamp within
        1 ms is read.  Descriptors in the files are ignored (desc_dim=0):
        the tracker needs positions only."""
        if not self._use_csv:
            return None
        if self._csv_stamps is None:
            try:
                names = os.listdir(self._csv_folder)
            except OSError:
                names = []
            stamps = [int(n[:-4]) for n in names if n.endswith(".csv") and n[:-4].isdigit()]
            self._csv_stamps = np.sort(np.asarray(stamps, np.int64))
        ts_ns = int(round(frame.ts * 1e9))
        st = self._csv_stamps
        if len(st):
            i = int(np.searchsorted(st, ts_ns))
            best = min((j for j in (i - 1, i) if 0 <= j < len(st)),
                       key=lambda j: abs(int(st[j]) - ts_ns))
            if abs(int(st[best]) - ts_ns) < 1_000_000:
                ts_ns = int(st[best])
        uv, _, v = csv_keypoints.load_csv_keypoints(self._csv_folder, ts_ns, capacity=256,
                                                    desc_dim=0, device=self.device)
        return uv, v

    def run(self, frames, log_dir=None, profile=False):
        """Process a frame list; returns the frame-rate positions (T,3).

        profile (or a log_dir): time every stage to the end of its device
        work; log_dir: write results.csv, vio_poses.csv and
        slam_profiler.txt there (``write_logs``)."""
        if profile or log_dir:
            self._prof = Profiler()
        n = self.drive(frames)
        self._flush_health()
        if log_dir:
            self.write_logs(log_dir, n_frames=n)
        return np.asarray([t for _, _, t in self.traj])

    def drive(self, frames, log_every=0):
        """The frame loop over an iterable of frames, one frame ahead: with
        ``self.prefetch`` the next frame's images are uploaded during the
        current frame.  Returns the number of frames."""
        it = iter(frames)
        frame = next(it, None)
        pending = self._upload_images(frame) if frame is not None and self.prefetch else None
        n = 0
        while frame is not None:
            nxt = next(it, None)
            out = self.process_frame(frame, images_dev=pending,
                                     prefetch_frame=nxt if self.prefetch else None)
            pending = self._prefetched
            frame = nxt
            n += 1
            if log_every and n % log_every == 0:
                print(f"frame {n}: kf={len(self.kf_traj)} ntrk={out.get('n_tracked', '-')}")
        return n

    def write_logs(self, log_dir, n_frames=None):
        """Write the log_slam/ set: results.csv (keyframe trajectory),
        vio_poses.csv (frame-rate state), slam_profiler.txt when profiling,
        results_posegraph.csv with pose_graph.  Callable from any frame
        loop, not only run()."""
        from sadvio_tpu_torch.pipeline.euroc import write_results_csv, write_vio_csv

        self._flush_health()
        os.makedirs(log_dir, exist_ok=True)
        write_results_csv(os.path.join(log_dir, "results.csv"), self.kf_traj)
        if self.cfg.pose_graph:
            # end-of-run pose-graph correction over the archive
            write_results_csv(os.path.join(log_dir, "results_posegraph.csv"),
                              self.optimize_archive())
        # frame-rate VIO state (pose, velocity, biases) when there is one,
        # else position-only rows
        rows = self.vio_log or [(ts, *np.asarray(t).tolist()) for ts, _, t in self.traj]
        write_vio_csv(os.path.join(log_dir, "vio_poses.csv"), rows)
        if self._prof is not None:
            self._prof.dump_slam(
                os.path.join(log_dir, "slam_profiler.txt"),
                n_frames=n_frames if n_frames is not None else len(self.traj),
                n_keyframes=len(self.kf_traj), pose_estimator=self.cfg.pose_estimator,
                mesh_on=self.mesher is not None)
