"""Monocular VO ("mono") / monocular VIO ("monovio") pipeline.

Port of ``sadvio_tpu/pipeline/mono.py`` (``MonoSLAM``).  It shares the
front end and back end of ``StereoSLAM``; what changes:

* bootstrap: camera 0's detections of the first frame are tracked until
  the rotation-compensated parallax against it passes
  ``boot_parallax_deg``; essential-matrix RANSAC gives the relative pose,
  its translation is fixed at 0.1 m (the monocular gauge), and the
  surviving tracks are triangulated from the two views;
* keyframe insertion: detection only, no stereo pair.  Fresh detections
  stay 2D until a later keyframe gives them a baseline; every slot with two
  or more window observations and no landmark yet is then triangulated by
  the multi-view midpoint;
* monovio: after ``vio_init_kfs`` keyframes VIInit solves gravity,
  velocities, biases and the scale, and rescales the map.

As in the JAX package, the mono modes have no descriptor global map
(``global_map_state`` stays None whatever the config says).
"""

from __future__ import annotations

import numpy as np
import torch

from sadvio_tpu_torch.frontend import detect, epipolar, klt, triangulate
from sadvio_tpu_torch.pipeline.slam import StereoSLAM, TrackState, _set
from sadvio_tpu_torch.utils import geometry as geo
from sadvio_tpu_torch.utils.struct import tree_map

BOOTSTRAP_SCALE = 0.1  # the monocular gauge: |t| of the bootstrap pair, m


class MonoSLAM(StereoSLAM):
    """Monocular VO / VIO on one device (None: the CUDA card)."""

    MODES = ("mono", "monovio")

    def __init__(self, rig, config, imu_params=None, seed=0, device=None,
                 boot_parallax_deg: float = 1.0, vio_init_kfs: int = 6):
        super().__init__(rig, config, imu_params=imu_params, seed=seed, device=device)
        self.boot_parallax_deg = boot_parallax_deg
        self.vio_init_kfs = vio_init_kfs
        self._vi_opt_scale = True  # monocular: VIInit solves the scale
        self._cam0_slot_limit = self.caps.L  # nofov keeps camera 0 to L/2
        self.global_map_state = None
        self.lmk_desc = None
        self._boot = None  # the bootstrap's first frame and its tracks

    # ------------------------------------------------------------------
    # bootstrap: detect at the first frame, track until parallax, essential
    # ------------------------------------------------------------------

    def _boot_detect(self, pyr):
        """Detections of the first frame, valid ones first (essential RANSAC
        samples slot indices uniformly: scattered validity would starve its
        8-point hypotheses), in camera 0's slot range."""
        L, dev = self.caps.L, self.device
        uv, _, v = detect.detect_features(
            pyr[0][0], existing_uv=torch.zeros((L, 2), device=dev),
            existing_valid=torch.zeros(L, dtype=torch.bool, device=dev),
            gh=8, gw=10, k_per_cell=max(1, self.cfg.features[0].n_per_cell))
        order = torch.argsort((~v).to(torch.uint8), stable=True)
        n = min(uv.shape[0], L)
        uv0 = torch.zeros((L, 2), device=dev)
        v0 = torch.zeros(L, dtype=torch.bool, device=dev)
        uv0[:n] = uv[order][:n]
        v0[:n] = v[order][:n]
        return uv0, v0 & (torch.arange(L, device=dev) < self._cam0_slot_limit)

    def _boot_track(self, pyr0, pyr_new, uv0, uv_prev, valid):
        """Track the first frame's features into this frame and fit the
        essential matrix; the parallax is the mean rotation-compensated angle
        between the rays of the inliers (raw flow is mostly rotation, which
        gives no triangulation baseline)."""
        cam0 = self.rig.cam.camera(0)
        uv1, ok, _ = klt.track(pyr0[0], pyr_new[0], uv0, uv_prev, valid,
                               levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                               engine=self.klt_engine)
        r0 = cam0.backproject(uv0)
        r1 = cam0.backproject(uv1)
        R_ab, t_ab, inl, ess_ok = epipolar.essential_ransac(r0, r1, ok, self.gen)
        r1_w = geo.mv(R_ab, r1)
        cr = torch.linalg.cross(r0, r1_w, dim=-1)
        par = torch.rad2deg(torch.atan2(torch.linalg.norm(cr, dim=-1), (r0 * r1_w).sum(-1)))
        good = ok & inl
        parallax = torch.where(good, par, torch.zeros_like(par)).sum() / torch.clamp(
            good.sum(), min=1)
        parallax = torch.where(ess_ok, parallax, torch.zeros_like(parallax))
        return uv1, ok, parallax, R_ab, t_ab, inl, ess_ok

    def _try_bootstrap(self, frame, pyr_new) -> bool:
        """One frame of the bootstrap; True when it made the first two
        keyframes."""
        if self._boot is None:
            uv0, v0 = self._boot_detect(pyr_new)
            self._boot = {"pyr0": pyr_new, "uv0": uv0, "uv": uv0, "valid": v0, "ts0": frame.ts}
            return False
        b = self._boot
        uv1, ok, parallax, R_ab, t_ab, inl, ess_ok = self._boot_track(
            b["pyr0"], pyr_new, b["uv0"], b["uv"], b["valid"])
        b["uv"], b["valid"] = uv1, ok
        par_h, ess_h = torch.stack([parallax, ess_ok.float()]).tolist()  # one copy
        if par_h < self.boot_parallax_deg or not ess_h > 0.5:
            return False

        # T_ab: the current camera in the first camera's frame, |t| = 1.
        # world := the first keyframe's body frame, scale BOOTSTRAP_SCALE
        dev = self.device
        cam0 = self.rig.cam.camera(0)
        Rfs0, tfs0 = self.rig.R_f_s[0], self.rig.t_f_s[0]
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        R_ws0, t_ws0 = geo.pose_compose(eye, zero, Rfs0, tfs0)
        R_ws1, t_ws1 = geo.pose_compose(R_ws0, t_ws0, R_ab, t_ab * BOOTSTRAP_SCALE)
        R1, t1 = geo.pose_compose(R_ws1, t_ws1, *geo.pose_inverse(Rfs0, tfs0))

        # two-view midpoint triangulation of the inlier tracks; det_eps 1e-6
        # (~0.04 deg of ray angle): the bootstrap baseline is small by
        # construction, the window BA refines the depths right after
        rays_w = torch.stack([geo.mv(R_ws0, cam0.backproject(b["uv0"])),
                              geo.mv(R_ws1, cam0.backproject(uv1))])
        p_tri, tri_ok = triangulate.stereo_triangulate(
            torch.stack([t_ws0, t_ws1]), rays_w, torch.stack([inl, inl]), det_eps=1e-6,
            max_depth=100.0)
        good = inl & tri_ok

        w = self.window
        self.window = w.replace(
            R=_set(_set(w.R, 0, eye), 1, R1), t=_set(_set(w.t, 0, zero), 1, t1),
            kf_mask=_set(_set(w.kf_mask, 0, True), 1, True),
            ts=_set(_set(w.ts, 0, float(b["ts0"])), 1, float(frame.ts)),
            lmk=torch.where(good[:, None], p_tri, torch.zeros_like(p_tri)), lmk_mask=good)
        uv, mask = self.obs.uv.clone(), self.obs.mask.clone()
        uv[0, 0], uv[1, 0] = b["uv0"], uv1
        mask[0, 0], mask[1, 0] = good, good
        self.obs = self.obs.replace(uv=uv, mask=mask)
        if self.vio:
            self.imu = self.imu.replace(
                pre=tree_map(lambda a, x: _set(a, 0, x), self.imu.pre, self.pre_cur),
                mask=_set(self.imu.mask, 0, self.pre_cur.dt > 1e-6))
        self.tracks = TrackState(uv=uv1[None], valid=good[None], uv_kf=uv1[None], has3d=good)
        self.pre_cur = self._pre_id
        self._imu_n = 0
        self.kf_pyr = pyr_new
        self.kf_tmpl = self._template_cache(pyr_new, uv1)
        self.n_kf = 2
        self.R_cur, self.t_cur = R1, t1
        self.initialized = True
        self.kf_ts = [b["ts0"], frame.ts]
        self.kf_cov = [np.zeros((6, 6)), np.zeros((6, 6))]
        pk = torch.cat([R1.reshape(-1), t1]).cpu().numpy()
        self.kf_traj.append((b["ts0"], np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
        self.kf_traj.append((frame.ts, pk[:9].reshape(3, 3), pk[9:]))
        # window BA to polish the two-view map (the IMU factor of the pair
        # included, as in the JAX package)
        self.window, self.obs, _ = self._backend(self.window, self.obs, self.imu, self.priors, 1)
        self._boot = None
        return True

    def _bootstrap(self, frame, pyr_new, out: dict) -> dict:
        """Pre-initialization frames: the IMU batch was accumulated once by
        ``process_frame``; the pose logged is the current estimate (the
        origin until the bootstrap pair is made)."""
        out["is_kf"] = self._try_bootstrap(frame, pyr_new)
        pk = torch.cat([self.R_cur.reshape(-1), self.t_cur]).cpu().numpy()
        self.traj.append((frame.ts, pk[:9].reshape(3, 3), pk[9:]))
        return out

    # ------------------------------------------------------------------
    # keyframe insertion: detect only; triangulate from window observations
    # ------------------------------------------------------------------

    def _insert_kf(self, pyr_new, tracks, window, obs, imu_chain, pre_cur, R_kf, t_kf, v_kf,
                   ts: float, slot: int, imu_gap_ok: bool = True, gm=None, lmk_desc=None):
        """Insert a keyframe at ``slot``: detect and resurrect in camera 0's
        slot range, write camera 0's observation row, and triangulate every
        slot that has two window observations and no landmark yet.  ``gm``
        and ``lmk_desc`` (the stereo pipeline's global map) are accepted and
        unused.  Returns (tracks, window, obs, imu_chain)."""
        _, _, _, _, new_uv0, new_v0, window, obs = self._detect_into_slots(
            pyr_new[0][0], tracks, window, obs, R_kf, t_kf, self._cam0_slot_limit)

        prev = max(slot - 1, 0)
        window = window.replace(
            R=_set(window.R, slot, R_kf), t=_set(window.t, slot, t_kf),
            v=_set(window.v, slot, v_kf), ba=_set(window.ba, slot, window.ba[prev]),
            bg=_set(window.bg, slot, window.bg[prev]),
            kf_mask=_set(window.kf_mask, slot, True), ts=_set(window.ts, slot, ts))
        uv, mask = obs.uv.clone(), obs.mask.clone()
        uv[slot, 0], mask[slot, 0] = new_uv0, new_v0
        obs = obs.replace(uv=uv, mask=mask)
        if slot > 0:
            imu_chain = imu_chain.replace(
                pre=tree_map(lambda a, b: _set(a, prev, b), imu_chain.pre, pre_cur),
                mask=_set(imu_chain.mask, prev, (pre_cur.dt > 1e-6) & imu_gap_ok))

        window = self._triangulate_window(window, obs, 0, ~window.lmk_mask)
        tracks = TrackState(uv=new_uv0[None], valid=new_v0[None], uv_kf=new_uv0[None],
                            has3d=window.lmk_mask)
        return tracks, window, obs, imu_chain

    def _triangulate_window(self, window, obs, c: int, candidates):
        """Give a landmark to every ``candidates`` slot that camera ``c``
        observes at two or more window keyframes: the multi-view midpoint of
        all its rays (det_eps 1e-5)."""
        R_ws, t_ws = geo.pose_compose(window.R, window.t, self.rig.R_f_s[c], self.rig.t_f_s[c])
        rays_w = torch.einsum("kij,klj->kli", R_ws,
                              self.rig.cam.camera(c).backproject(obs.uv[:, c]))
        origins = t_ws[:, None, :].expand_as(rays_w)
        m_obs = obs.mask[:, c] & window.kf_mask[:, None]
        p_tri, tri_ok = triangulate.midpoint_triangulate(
            origins.movedim(0, -2), rays_w.movedim(0, -2), m_obs.movedim(0, -1), det_eps=1e-5)
        add3d = candidates & ~window.lmk_mask & (m_obs.sum(0) >= 2) & tri_ok
        return window.replace(lmk=torch.where(add3d[:, None], p_tri, window.lmk),
                              lmk_mask=window.lmk_mask | add3d)
