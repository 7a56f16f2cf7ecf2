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
solves the scale too) and ``_last_pyr`` (the latest frame's pyramids).
``optimizer: angular*`` switches the window BA to the bearing-vector
residual.  Config keys for parts that are not ported yet raise
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sadvio_tpu_torch.backend import ba, marginalization as marg, posegraph as pg, viinit
from sadvio_tpu_torch.data import globalmap as gmap
from sadvio_tpu_torch.data.window import (
    LMK_RESURRECTED, ImuChain, Observations, PriorSet, Rig, WindowState,
)
from sadvio_tpu_torch.frontend import (
    detect, epipolar, eskf as eskf_mod, klt, match as match_mod, pnp, triangulate,
)
from sadvio_tpu_torch.mesh.mesh import MeshConfig, Mesher
from sadvio_tpu_torch.models import cameras, imu as imu_mod
from sadvio_tpu_torch.pipeline.config import SLAMConfig
from sadvio_tpu_torch.utils import geometry as geo
from sadvio_tpu_torch.utils.struct import Struct, entry_device, tree_map


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


def _check_config(cfg: SLAMConfig, modes):
    """Refuse a slam_mode outside ``modes`` (the class's own) and the config
    keys whose code paths are not ported yet."""
    todo = {
        "slam_mode": cfg.slam_mode not in modes,
        "async_health": cfg.async_health,
        "multithreading": cfg.multithreading,
        "tracker": cfg.tracker not in ("klt", "matcher"),
        "pose_estimator": not cfg.pose_estimator.lower().startswith(("pnp", "epipolar")),
        "features": any(f.label.lower() != "pointxd" or f.detector.lower() in ("csv", "cvcsv")
                        for f in cfg.features),
    }
    bad = [k for k, v in todo.items() if v]
    if bad:
        raise NotImplementedError(f"config keys not ported yet: {', '.join(bad)}")


def _set(x, i, val):
    """Copy of x with x[i] = val."""
    x = x.clone()
    x[i] = val
    return x


def _odometry_edges(poses, covs):
    """Relative-pose edges between consecutive (ts, R, t) host poses, weighted
    by the endpoints' frame-rate pose covariance."""
    return [(a[0], b[0], pg.relative_pose(a[1], a[2], b[1], b[2]),
             pg.inflate_edge_info(np.eye(6) * 1e7, covs[j], covs[j + 1]))
            for j, (a, b) in enumerate(zip(poses[:-1], poses[1:]))]


class StereoSLAM:
    """Stereo VO / stereo VIO pipeline on one device (None: the CUDA card)."""

    MODES = ("bimono", "bimonovio")  # the slam_mode values this class runs

    def __init__(self, rig: Rig, config: SLAMConfig, imu_params=None, seed=0, device=None):
        _check_config(config, self.MODES)
        self.device = entry_device(device)
        self.klt_engine = "fused"  # klt.track engine: "fused" | "levels"
        self.rig = rig.to(self.device)
        self.cfg = config
        self.caps = config.caps
        self.vio = config.slam_mode.endswith("vio")
        self.imu_params = imu_params or imu_mod.ImuParams.euroc()
        self.C = rig.C
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._pre_id = imu_mod.Preintegration.identity(device=self.device)
        # optimizer "angular*": the bearing-vector residual (fisheye, omni)
        self._ba_opts = ba.BAOptions(iters=config.ba_iterations, sigma_px=1.0,
                                     acc_walk=self.imu_params.acc_walk,
                                     gyr_walk=self.imu_params.gyr_walk,
                                     angular=config.optimizer.lower().startswith("angular"))
        self.vio_init_kfs = min(10, self.caps.K - 1)  # 10-KF vision-only bootstrap
        self._vi_opt_scale = False  # VIInit solves the scale too (monocular)
        self._last_pyr = None  # pyramids of the latest frame, for subclasses
        self.n_resets = 0
        self.traj = []  # (ts, R, t) at frame rate, host numpy
        self.kf_traj = []
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
        # current-frame estimate and constant-velocity model (kept by reset)
        self.R_cur = torch.eye(3, device=self.device)
        self.t_cur = torch.zeros(3, device=self.device)
        self.v_cur = torch.zeros(3, device=self.device)
        self.dT = (torch.eye(3, device=self.device), torch.zeros(3, device=self.device))
        self._clear()

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

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

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

    def _frontend(self, pyr_kf, pyr_new, tracks: TrackState, window: WindowState, R_pred,
                  t_pred, v_pred, R_cur, t_cur, kf_tmpl=None, eskf_on=False, pre_cov=None):
        """Track cam0 from the last-KF template, PnP, epipolar gate, ESKF.

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
        k_last = max(self.n_kf - 1, 0)
        R_kf, t_kf = window.R[k_last], window.t[k_last]
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

        if self.cfg.pose_estimator.lower().startswith("epipolar"):
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
                cam0, Rfs0, tfs0, lmk, uv1, lmk_ok, R_pred, t_pred, self.gen)
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
                           obs: Observations, R_kf, t_kf, slot_limit: int):
        """Camera 0's half of a keyframe insertion: detect in the free image
        area, resurrect dead in-map landmarks, and give each fresh detection
        a free landmark slot below ``slot_limit``.

        Returns (uv_det, v_det, take, slot_of_det, new_uv0, new_v0, window,
        obs): the detections, which of them claimed a slot and which slot,
        camera 0's slot positions and validity, the window with the
        resurrection flags and the observations with the claimed slots'
        stale rows cleared."""
        dev = self.device
        L = self.caps.L
        ar_L = torch.arange(L, device=dev)
        # 1. detect in free slots with the occupancy mask
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

    def _insert_kf(self, pyr_new, tracks: TrackState, window: WindowState, obs: Observations,
                   imu_chain: ImuChain, pre_cur, R_kf, t_kf, v_kf, ts: float, slot: int,
                   imu_gap_ok: bool = True, gm=None, lmk_desc=None):
        """Insert a keyframe at ``slot``: detect, resurrect, stereo-track,
        triangulate, write the observation rows.

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
            self._detect_into_slots(img0, tracks, window, obs, R_kf, t_kf, L)

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
        prev = max(slot - 1, 0)
        window = window.replace(
            R=_set(window.R, slot, R_kf), t=_set(window.t, slot, t_kf),
            v=_set(window.v, slot, v_kf), ba=_set(window.ba, slot, window.ba[prev]),
            bg=_set(window.bg, slot, window.bg[prev]),
            kf_mask=_set(window.kf_mask, slot, True), ts=_set(window.ts, slot, ts),
            lmk=lmk, lmk_mask=lmk_mask)
        obs = obs.replace(uv=_set(obs.uv, slot, torch.stack([new_uv0, uv1])),
                          mask=_set(obs.mask, slot, torch.stack([new_v0, ok1])))
        if slot > 0:
            # a >1 s inter-KF gap drops the IMU factor (verdict made on the host in f64)
            imu_chain = imu_chain.replace(
                pre=tree_map(lambda a, b: _set(a, prev, b), imu_chain.pre, pre_cur),
                mask=_set(imu_chain.mask, prev, (pre_cur.dt > 1e-6) & imu_gap_ok))
        tracks = TrackState(uv=torch.stack([new_uv0, uv1]), valid=torch.stack([new_v0, ok1]),
                            uv_kf=torch.stack([new_uv0, uv1]), has3d=lmk_mask)
        if gm is not None:
            # refresh the slot descriptors at this keyframe (archived on marginalize)
            lmk_desc = torch.where(new_v0[:, None], detect.brief_describe(sm0, new_uv0),
                                   lmk_desc)
            return tracks, window, obs, imu_chain, lmk_desc, gm_counts, gm_pack
        return tracks, window, obs, imu_chain

    def _backend(self, window, obs, imu_chain, priors, fixed_n: int):
        """Window BA + outlier removal."""
        fixed = torch.arange(self.caps.K, device=self.device) < fixed_n
        problem = ba.BAProblem(window, obs, self.rig, imu_chain, priors, fixed, False)
        new_window, stats = ba.ba_solve(problem, self._ba_opts)
        r, _, _, m, _ = ba._reproj_terms(new_window, obs, self.rig, self._ba_opts)
        bad_obs = m.bool() & (torch.linalg.norm(r, dim=-1) > 3.0)
        obs = obs.replace(mask=obs.mask & ~bad_obs)
        starved = new_window.lmk_mask & (obs.mask.sum((0, 1)) < 2)
        new_window = new_window.replace(lmk_mask=new_window.lmk_mask & ~starved)
        return new_window, obs, stats

    def _marg_roll(self, window, obs, imu_chain, priors, tracks, vio: bool, gm=None,
                   lmk_desc=None, arch_idx=None):
        """Marginalize slot 0 and shift the window left by one.  With a
        global map ``gm`` the landmarks that leave the map are archived
        (position + BRIEF descriptor) and the new map is returned before
        the overflow count."""
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
        last_off = lambda x: _set(roll(x), -1, False)
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

    # ------------------------------------------------------------------
    # host-side frame loop
    # ------------------------------------------------------------------

    def _predict_pose(self, frame):
        """IMU prediction once VIInit has given velocities and biases, else
        the constant-velocity model (see the module docstring)."""
        if self.vio and self._imu_n > 0 and self.vi_initialized:
            k = self.n_kf - 1
            w = self.window
            return imu_mod.predict(self.pre_cur, w.R[k], w.t[k], w.v[k], ba=w.ba[k], bg=w.bg[k])
        R_p, t_p = geo.pose_compose(self.R_cur, self.t_cur, *self.dT)
        return R_p, t_p, self.v_cur

    def _accumulate_imu(self, frame):
        n = len(frame.dt)
        if n == 0:
            return
        t = lambda x: torch.as_tensor(np.array(x, np.float32), device=self.device)
        pre = self.pre_cur
        self.pre_cur = imu_mod.preintegrate(t(frame.acc), t(frame.gyr), t(frame.dt), pre.ba_lin,
                                            pre.bg_lin, self.imu_params, init=pre)
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

    def _ingest_health(self, ts, health_h):
        pnp_ok = bool(health_h[0] > 0.5)
        self.successive_fails = 0 if pnp_ok else self.successive_fails + 1
        self._cov_h = health_h[19:55].reshape(6, 6).copy()
        self.traj.append((ts, health_h[4:13].reshape(3, 3).copy(), health_h[13:16].copy()))

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
            R0, t0, torch.zeros(3, device=dev), float(frame.ts), 0,
            gm=self.global_map_state, lmk_desc=self.lmk_desc)
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
        return out

    def process_frame(self, frame) -> dict:
        """One frame of the rig (+ the IMU samples since the previous frame)."""
        dev = self.device
        if self.vio:
            self._accumulate_imu(frame)
        images = torch.as_tensor(np.array(frame.images), device=dev)
        pyr_new = self._pyramids(images)
        out = {"ts": frame.ts, "is_kf": False, "ok": True}
        self._last_pyr = pyr_new
        if not self.initialized:
            return self._bootstrap(frame, pyr_new, out)

        R_pred, t_pred, v_pred = self._predict_pose(frame)
        self.tracks, R_new, t_new, health, dR_cv, dt_cv = self._frontend(
            self.kf_pyr, pyr_new, self.tracks, self.window, R_pred, t_pred, v_pred,
            self.R_cur, self.t_cur, kf_tmpl=self.kf_tmpl,
            eskf_on=bool(self.vi_initialized and self._imu_n > 0),
            pre_cov=self.pre_cur.cov if self.vio else None)
        health_h = health.cpu().numpy()  # the frame's one device-to-host copy
        self._ingest_health(frame.ts, health_h)
        self.dT = (dR_cv, dt_cv)
        self.R_cur, self.t_cur, self.v_cur = R_new, t_new, v_pred
        pnp_ok_h = bool(health_h[0] > 0.5)
        parallax_h = float(health_h[1])
        n_lmk_h = int(health_h[3])
        out.update(pose=(self.traj[-1][1], self.traj[-1][2]), pnp_ok=pnp_ok_h,
                   n_tracked=int(health_h[2]), n_lmk_tracked=n_lmk_h,
                   parallax_deg=parallax_h)

        if self.successive_fails > 5:  # failure recovery
            self.reset()
            return out

        # keyframe vote
        dt_kf = frame.ts - self.kf_ts[-1] if self.kf_ts else 0.0
        force_time = self.vio and dt_kf > 1.0
        force_boot = self.n_kf < self.cfg.min_kf_number
        force_kf = (not pnp_ok_h) or n_lmk_h < self.cfg.min_lmk_number
        vote_kf = parallax_h > self.cfg.max_movement_parallax
        is_kf = (not pnp_ok_h) or force_time or force_boot or (
            (force_kf or vote_kf) and parallax_h >= self.cfg.min_movement_parallax)
        if not is_kf:
            return out

        out["is_kf"] = True
        K = self.caps.K
        n_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        degen = torch.zeros((), dtype=torch.bool, device=dev)
        if self.n_kf >= K:
            # archive the leaving keyframe; with pose_graph, condense its
            # links to the next keyframe into a relative-pose edge.  Pose
            # and edge ride one device-to-host copy; timestamps come from
            # the host mirror
            vio_now = self.vio and self.vi_initialized
            pose0 = [self.window.R[0].reshape(-1), self.window.t[0]]
            if self.cfg.pose_graph:
                dx_e, inf_e, n_sh = marg.marginalize_relative(
                    self.window, self.obs, self.rig, self.imu, self._ba_opts, vio=vio_now)
                pose0 += [dx_e, inf_e.reshape(-1), n_sh.float()[None]]
            pk0 = torch.cat(pose0).cpu().numpy()
            self.archived_kf.append((self.kf_ts[0], pk0[:9].reshape(3, 3), pk0[9:12].copy()))
            if self.cfg.pose_graph and pk0[54] > 0:  # shared landmarks: the edge is informative
                inf_np = pg.inflate_edge_info(pk0[18:54].reshape(6, 6), self.kf_cov[0],
                                              self.kf_cov[1])
                self.pose_graph_edges.append((self.kf_ts[0], self.kf_ts[1], pk0[12:18].copy(),
                                              inf_np))
            mr = self._marg_roll(self.window, self.obs, self.imu, self.priors, self.tracks,
                                 vio_now, gm=self.global_map_state, lmk_desc=self.lmk_desc,
                                 arch_idx=len(self.archived_kf) - 1)
            if self.global_map_state is not None:
                (self.window, self.obs, self.imu, self.priors, self.tracks,
                 self.global_map_state, n_ovf, degen) = mr
            else:
                self.window, self.obs, self.imu, self.priors, self.tracks, n_ovf, degen = mr
            if self.cfg.marginalization:
                self._have_priors = True
            self.kf_ts.pop(0)
            self.kf_cov.pop(0)
            self.n_kf = K - 1
            self._maybe_compact_archive()
        slot = self.n_kf
        gap_ok = (not self.kf_ts) or (frame.ts - self.kf_ts[-1]) <= 1.0
        ins = self._insert_kf(
            pyr_new, self.tracks, self.window, self.obs, self.imu, self.pre_cur,
            R_new, t_new, v_pred, float(frame.ts), slot, imu_gap_ok=bool(gap_ok),
            gm=self.global_map_state, lmk_desc=self.lmk_desc)
        self.tracks, self.window, self.obs, self.imu = ins[:4]
        gm_counts = gm_pack = None
        if self.global_map_state is not None:
            self.lmk_desc, gm_counts, gm_pack = ins[4:]
        self.n_kf += 1
        self.kf_ts.append(frame.ts)
        self.kf_cov.append(self._cov_h)
        self.kf_pyr = pyr_new
        self.kf_tmpl = self._template_cache(pyr_new, self.tracks.uv_kf[0])
        self.pre_cur = self._pre_id.replace(ba_lin=self.window.ba[slot],
                                            bg_lin=self.window.bg[slot])
        self._imu_n = 0

        fixed_n = 1 if not self._have_priors else 0
        fixed_n = max(fixed_n, self.cfg.fixed_frame_number if self.n_kf > 1 else 1)
        # vision-only window BA until VIInit has run
        imu_for_ba = (self.imu if self.vi_initialized else
                      self.imu.replace(mask=torch.zeros_like(self.imu.mask)))
        self.window, self.obs, stats = self._backend(self.window, self.obs, imu_for_ba,
                                                     self.priors, fixed_n)
        self.R_cur = self.window.R[slot]
        self.t_cur = self.window.t[slot]
        self.v_cur = self.window.v[slot]
        self.tracks = self.tracks.replace(has3d=self.window.lmk_mask)
        if self.vio and not self.vi_initialized and self.n_kf >= self.vio_init_kfs:
            self._run_vi_init()
        w = self.window
        parts = [w.R[slot].reshape(-1), w.t[slot], w.v[slot], w.ba[slot], w.bg[slot],
                 torch.stack([n_ovf.float(), degen.float(), stats["cost"].float()])]
        if gm_counts is not None:
            parts.append(gm_counts.float())
        pk = torch.cat(parts).cpu().numpy()  # the keyframe's one state copy
        self.kf_traj.append((frame.ts, pk[:9].reshape(3, 3), pk[9:12]))
        out["keep_overflow"] = int(pk[21])
        out["marg_degenerate"] = bool(pk[22] > 0.5)
        out["ba_cost"] = float(pk[23])
        if gm_counts is not None:
            out["gm_resurrected"] = int(pk[24])
            # loop closure: a burst of descriptor resurrections is a revisit
            # signal.  The hit count (riding the copy above) gates the copy
            # of the per-detection pack, so other keyframes never pay it;
            # the PnP warm-starts at the post-BA keyframe pose
            if (self.cfg.pose_graph and self.archived_kf
                    and int(pk[25]) >= self.cfg.lc_min_hits):
                lc = self._try_loop_closure(gm_pack, frame.ts, pk[:9].reshape(3, 3), pk[9:12])
                out["lc_diag"] = self._lc_diag
                if lc is not None:
                    out["loop_closure"] = lc
        out["vi_initialized"] = self.vi_initialized
        if self.mesher is not None:  # densification at keyframe rate
            imgs = torch.stack([pyr_new[c][0] for c in range(2)])
            self.mesher.update(imgs, self.window, self.R_cur, self.t_cur)
            out["mesh_triangles"] = int(self.mesher.tri_mask.sum())
        return out

    def _run_vi_init(self):
        """VI bootstrap: gravity/velocity/shared-bias (and, with
        ``_vi_opt_scale``, scale) solve over the window, then rotate and
        rescale the map gravity-down and run a full VI window BA.  A
        non-converged solve or |ba| > 1 m/s^2 is rejected and retried at
        the next keyframe."""
        res = viinit.vi_init(self.window.R, self.window.t, self.window.kf_mask, self.imu,
                             optimize_scale=self._vi_opt_scale, iters=20)
        ok_h = torch.cat([res["converged"].float()[None], res["ba"]]).cpu().numpy()
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
        self.vi_initialized = True
        self.window, self.obs, _ = self._backend(self.window, self.obs, self.imu,
                                                 self.priors, 1)
        k = self.n_kf - 1
        self.R_cur, self.t_cur, self.v_cur = self.window.R[k], self.window.t[k], self.window.v[k]
        self.pre_cur = self.pre_cur.replace(ba_lin=self.window.ba[k], bg_lin=self.window.bg[k])

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
        landmarks anchor at the last of them."""
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
        self.n_resets += 1

    def run(self, frames, log_dir=None, profile=False):
        """Process a frame list; returns the frame-rate positions (T,3)."""
        if log_dir is not None or profile:
            raise NotImplementedError("run(log_dir=..., profile=...) is not ported yet")
        for f in frames:
            self.process_frame(f)
        return np.asarray([t for _, _, t in self.traj])
