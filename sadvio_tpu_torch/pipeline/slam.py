"""Stereo VO ("bimono") / stereo VIO ("bimonovio") pipeline.

Port of ``sadvio_tpu/pipeline/slam.py`` (``StereoSLAM``) on the main path:

  frontend  : pyramids + KLT from the last keyframe + PnP + epipolar gate
              + ESKF fusion, one health vector read by the host per frame
  insert_kf : grid detection + resurrection + stereo KLT + triangulation
  backend   : window Schur-LM VI-BA + 3 px outlier gate
  marg_roll : square-root marginalization into the sparsified prior +
              window shift

All estimator state lives in fixed-shape tensors on ``device``; the host
loop reads back the health vector once per frame and a small state pack
once per keyframe.  Feature identity: track slot == landmark slot.

One deliberate deviation from the JAX package: before VIInit has run, the
motion prediction is the constant-velocity model, not the IMU prediction.
Before VIInit the window velocities are still zero, and the JAX package's
IMU prediction from zero velocity drifts by v * dt over a keyframe
interval; once that drift is ten times the motion since the keyframe, the
PnP sanity gate rejects the correct pose and tracking collapses.

Config keys for parts that are not ported yet raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sadvio_tpu_torch.backend import ba, marginalization as marg, viinit
from sadvio_tpu_torch.data.window import (
    LMK_RESURRECTED, ImuChain, Observations, PriorSet, Rig, WindowState,
)
from sadvio_tpu_torch.frontend import detect, epipolar, eskf as eskf_mod, klt, pnp, triangulate
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


def _check_config(cfg: SLAMConfig):
    """Refuse the config keys whose code paths are not ported yet."""
    todo = {
        "slam_mode": cfg.slam_mode not in ("bimono", "bimonovio"),
        "async_health": cfg.async_health,
        "multithreading": cfg.multithreading,
        "mesh3d": cfg.mesh3d,
        "tracker": cfg.tracker != "klt",
        "pose_estimator": cfg.pose_estimator.lower() != "pnp",
        "optimizer": cfg.optimizer.lower().startswith("angular"),
        "global_map": cfg.global_map,
        "pose_graph": cfg.pose_graph,
        "marg_f64": cfg.marginalization and cfg.marg_f64,
        "sparsification": cfg.marginalization and not cfg.sparsification,
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


class StereoSLAM:
    """Stereo VO / stereo VIO pipeline on one device (None: the CUDA card)."""

    def __init__(self, rig: Rig, config: SLAMConfig, imu_params=None, seed=0, device=None):
        _check_config(config)
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
        self._ba_opts = ba.BAOptions(iters=config.ba_iterations, sigma_px=1.0,
                                     acc_walk=self.imu_params.acc_walk,
                                     gyr_walk=self.imu_params.gyr_walk)
        self.vio_init_kfs = min(10, self.caps.K - 1)  # 10-KF vision-only bootstrap
        self.n_resets = 0
        self.traj = []  # (ts, R, t) at frame rate, host numpy
        self.kf_traj = []
        self.archived_kf = []  # (ts, R, t) of keyframes rolled out of the window
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

        uv1, ok, _ = klt.track(pyr_kf[0], pyr_new[0], tracks.uv_kf[0], init, tracks.valid[0],
                               levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                               warp=A, tmpl_wins=kf_tmpl, engine=self.klt_engine)

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
        cv_fail = (n_est > 0.01) & (torch.linalg.norm(t_rel_prd) > 0.01) & (dev_ratio > 10.0)
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

        tracks = tracks.replace(uv=torch.stack([uv1, tracks.uv[1]]),
                                valid=torch.stack([ok, tracks.valid[1]]))
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

    def _insert_kf(self, pyr_new, tracks: TrackState, window: WindowState, obs: Observations,
                   imu_chain: ImuChain, pre_cur, R_kf, t_kf, v_kf, ts: float, slot: int,
                   imu_gap_ok: bool = True):
        """Insert a keyframe at ``slot``: detect, resurrect, stereo-track,
        triangulate, write the observation rows."""
        dev = self.device
        cam0, cam1 = self.rig.cam.camera(0), self.rig.cam.camera(1)
        Rfs, tfs = self.rig.R_f_s, self.rig.t_f_s
        L = self.caps.L
        img0 = pyr_new[0][0]
        ar_L = torch.arange(L, device=dev)

        # 1. detect in free slots with the occupancy mask
        uv_det, _, v_det = detect.detect_features(
            img0, existing_uv=tracks.uv[0], existing_valid=tracks.valid[0],
            gh=8, gw=10, k_per_cell=max(1, self.cfg.features[0].n_per_cell))
        M = uv_det.shape[0]
        # 1b. resurrection: dead in-map landmarks re-associated to the
        # mutual-nearest fresh detection within 5 px of their projection
        dead = window.lmk_mask & ~tracks.valid[0]
        uv_prj, vis_p = cameras.project_world(cam0, R_kf, t_kf, Rfs[0], tfs[0], window.lmk)
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
        free = ~(v0_base | window.lmk_mask)
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

    def _marg_roll(self, window, obs, imu_chain, priors, tracks, vio: bool):
        """Marginalize slot 0 and shift the window left by one."""
        if self.cfg.marginalization:
            new_priors, info = marg.marginalize(window, obs, self.rig, imu_chain, priors,
                                                self._ba_opts, vio=vio, sparsify=True)
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
        self.traj.append((ts, health_h[4:13].reshape(3, 3).copy(), health_h[13:16].copy()))

    def process_frame(self, frame) -> dict:
        """One stereo frame (+ the IMU samples since the previous frame)."""
        dev = self.device
        if self.vio:
            self._accumulate_imu(frame)
        images = torch.as_tensor(np.array(frame.images), device=dev)
        pyr_new = self._pyramids(images)
        out = {"ts": frame.ts, "is_kf": False, "ok": True}
        if not self.initialized:
            R0 = self._gravity_align_init(frame) if self.vio else torch.eye(3, device=dev)
            t0 = torch.zeros(3, device=dev)
            self.R_cur, self.t_cur = R0, t0
            self.tracks, self.window, self.obs, self.imu = self._insert_kf(
                pyr_new, self.tracks, self.window, self.obs, self.imu, self.pre_cur,
                R0, t0, torch.zeros(3, device=dev), float(frame.ts), 0)
            self.n_kf = 1
            self.pre_cur = self._pre_id
            self._imu_n = 0
            self.kf_pyr = pyr_new
            self.kf_tmpl = self._template_cache(pyr_new, self.tracks.uv_kf[0])
            self.initialized = True
            self.kf_ts.append(frame.ts)
            R0_h, t0_h = R0.cpu().numpy(), t0.cpu().numpy()
            self.kf_traj.append((frame.ts, R0_h, t0_h))
            self.traj.append((frame.ts, R0_h, t0_h))
            out["is_kf"] = True
            return out

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
            self.archived_kf.append((self.kf_ts[0], self.window.R[0].cpu().numpy(),
                                     self.window.t[0].cpu().numpy()))
            (self.window, self.obs, self.imu, self.priors, self.tracks, n_ovf,
             degen) = self._marg_roll(self.window, self.obs, self.imu, self.priors,
                                      self.tracks, self.vio and self.vi_initialized)
            if self.cfg.marginalization:
                self._have_priors = True
            self.kf_ts.pop(0)
            self.n_kf = K - 1
        slot = self.n_kf
        gap_ok = (not self.kf_ts) or (frame.ts - self.kf_ts[-1]) <= 1.0
        self.tracks, self.window, self.obs, self.imu = self._insert_kf(
            pyr_new, self.tracks, self.window, self.obs, self.imu, self.pre_cur,
            R_new, t_new, v_pred, float(frame.ts), slot, imu_gap_ok=bool(gap_ok))
        self.n_kf += 1
        self.kf_ts.append(frame.ts)
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
        pk = torch.cat([w.R[slot].reshape(-1), w.t[slot], w.v[slot], w.ba[slot], w.bg[slot],
                        torch.stack([n_ovf.float(), degen.float(),
                                     stats["cost"].float()])]).cpu().numpy()
        self.kf_traj.append((frame.ts, pk[:9].reshape(3, 3), pk[9:12]))
        out["keep_overflow"] = int(pk[21])
        out["marg_degenerate"] = bool(pk[22] > 0.5)
        out["ba_cost"] = float(pk[23])
        out["vi_initialized"] = self.vi_initialized
        return out

    def _run_vi_init(self):
        """VI bootstrap: gravity/velocity/shared-bias solve over the window,
        then rotate the map gravity-down and run a full VI window BA.  A
        non-converged solve or |ba| > 1 m/s^2 is rejected and retried at
        the next keyframe."""
        res = viinit.vi_init(self.window.R, self.window.t, self.window.kf_mask, self.imu,
                             optimize_scale=False, iters=20)
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

    def reset(self):
        """Re-initialize after a tracking failure."""
        self._clear()
        self.n_resets += 1

    def run(self, frames, log_dir=None, profile=False):
        """Process a frame list; returns the frame-rate positions (T,3)."""
        if log_dir is not None or profile:
            raise NotImplementedError("run(log_dir=..., profile=...) is not ported yet")
        for f in frames:
            self.process_frame(f)
        return np.asarray([t for _, _, t in self.traj])
