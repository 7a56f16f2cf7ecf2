"""Non-overlapping-FoV bi-monocular VO ("nofov"): metric scale from rigidity.

Port of ``sadvio_tpu/pipeline/nofov_mode.py`` (``NoFovSLAM``).  Two cameras
look in opposite directions.  Camera 0 runs the monocular pipeline
(``MonoSLAM``); camera 1 keeps its own chained KLT tracks, keyframe to
keyframe, whose epipolar geometry, coupled through the rigid extrinsics,
makes the metric scale observable (``frontend.nofov``).

The landmark pool is split: camera 0 owns slots [0, L/2), camera 1 owns
[L/2, L).  Camera 1's landmarks are triangulated from its window
observations and enter the same window BA through the extrinsics, so the
joint bundle sees metric scale continuously.  At each keyframe the scale is
estimated over every usable window baseline (oldest keyframe to the new
one and so on): camera 1's templates of the older keyframe are re-tracked
directly into the new keyframe under the rotation homography, the scale
grid M-estimator runs on the rays, and the median of the baselines' ratios
is the measurement.  The first one rescales the map and the history; later
ones apply damped, clipped corrections about the window's oldest keyframe,
with the marginalization prior moved through the same gauge transform.
Camera 1's tracks, their history and its keyframe pyramids live on the
host (positions, masks) and the device (pyramids); each baseline costs one
device-to-host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from sadvio_tpu_torch.backend import marginalization as marg
from sadvio_tpu_torch.frontend import detect, klt, nofov
from sadvio_tpu_torch.pipeline.mono import MonoSLAM
from sadvio_tpu_torch.utils import geometry as geo


def rotation_warp(cam, R_1, uv):
    """(N,2,2) affine of the rotation homography H = K R_1 K^-1 (current
    pixels -> origin pixels) at each current pixel ``uv``: the Jacobian of
    dehom(H [u, v, 1]), the target-to-template warp of ``klt.track``.  ``cam``:
    one pinhole camera."""
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    Km = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                      torch.stack([zero, zero, one])])
    Kinv = torch.stack([torch.stack([1 / fx, zero, -cx / fx]),
                        torch.stack([zero, 1 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])])
    Hm = Km @ R_1 @ Kinv
    y = torch.cat([uv, torch.ones_like(uv[:, :1])], 1) @ Hm.T  # (N,3)
    return (Hm[:2, :2][None] * y[:, 2, None, None]
            - y[:, :2, None] * Hm[2, :2][None, None, :]) / y[:, 2, None, None] ** 2


class NoFovSLAM(MonoSLAM):
    """Bi-monocular VO with disjoint fields of view, on one device (None:
    the CUDA card)."""

    MODES = ("nofov",)
    SCALE_DAMP = 0.35  # log-space gain of each maintenance step
    SCALE_STEP_CLIP = (0.8, 1.25)  # largest multiplicative change per step
    SCALE_DEADBAND = 0.02  # ratios within 2% of unity are noise
    MIN_LEVER = 0.015  # m of rotation-induced lever displacement to trust
    RATIO_RANGE = (0.05, 20.0)  # searched map-scale correction range

    def __init__(self, rig, config, imu_params=None, seed=0, device=None,
                 boot_parallax_deg: float = 1.5):
        super().__init__(rig, config, imu_params=imu_params, seed=seed, device=device,
                         boot_parallax_deg=boot_parallax_deg)
        L, K = self.caps.L, self.caps.K
        self._cam0_slot_limit = L // 2
        self.scale_state = {"applied": False, "s": 1.0, "n_est": 0}
        # chained camera-1 tracks at the last keyframe, and per-keyframe
        # history rows aligned with the window slots (rolled with it)
        self.uv1_last = np.zeros((L, 2), np.float32)
        self.v1_last = np.zeros((L,), bool)
        self.uv1_hist = np.zeros((K, L, 2), np.float32)
        self.hist_mask = np.zeros((K, L), bool)
        # camera 1's pyramid per window slot: baselines re-track from the
        # origin keyframe's templates, so chained drift does not enter the
        # scale measurement
        self.pyr1_hist = [None] * K

    # -- camera 1: chained track, warped re-track, detection ---------------

    def _track_cam1(self, pyr_kf, pyr_new, uv_kf, valid):
        """Camera 1 from the previous keyframe to this one (the chain)."""
        uv1, ok, _ = klt.track(pyr_kf[1], pyr_new[1], uv_kf, uv_kf, valid,
                               levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                               engine=self.klt_engine)
        return uv1, ok

    def _track_cam1_refine(self, pyr1_a, pyr1_b, uv_a, init, valid, R_1):
        """Re-track the origin keyframe's templates directly into the current
        one, seeded by the chained positions.  R_1: camera 1's relative
        rotation (current -> origin).  A long baseline rotates enough that
        unwarped LK converges with a sub-pixel bias above the lever-arm
        signal; the affine of the rotation homography H = K R_1 K^-1 at each
        feature (target -> template) removes it."""
        A = rotation_warp(self.rig.cam.camera(1), R_1, init)
        uv, ok, _ = klt.track(pyr1_a, pyr1_b, uv_a, init, valid, warp=A,
                              levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                              engine=self.klt_engine)
        return uv, ok

    def _detect_cam1(self, img1, uv_exist, v_exist):
        return detect.detect_features(
            img1, existing_uv=uv_exist, existing_valid=v_exist,
            gh=8, gw=10, k_per_cell=max(1, self.cfg.features[0].n_per_cell))

    def _cam1_kf_update(self, window, obs, uv1, v1, slot: int):
        """Write camera 1's observation row at the new keyframe (its slot
        range only) and triangulate camera-1 slots from their window
        observations."""
        L = self.caps.L
        upper = torch.arange(L, device=self.device) >= L // 2
        uv, mask = obs.uv.clone(), obs.mask.clone()
        uv[slot, 1], mask[slot, 1] = uv1, v1 & upper
        obs = obs.replace(uv=uv, mask=mask)
        return self._triangulate_window(window, obs, 1, upper), obs

    # -- scale over the window's baselines ----------------------------------

    def _scale_baseline(self, pyr_o, pyr_k, R_o, t_o, R_k, t_k, uv_o, uv_k, common):
        """One baseline's scale estimate packed as [|t_b|, degenerate, s, ok]
        (one tensor, so the host copies it once)."""
        Rfs1, tfs1 = self.rig.R_f_s[1], self.rig.t_f_s[1]
        cam1 = self.rig.cam.camera(1)
        R_b, t_b = geo.pose_compose(*geo.pose_inverse(R_o, t_o), R_k, t_k)
        tn = torch.linalg.norm(t_b)
        d = t_b / torch.clamp(tn, min=1e-12)
        deg = nofov.is_degenerate_motion(R_b, d, Rfs1, tfs1, min_lever=self.MIN_LEVER)
        R_1 = Rfs1.T @ R_b @ Rfs1
        uv_ref, ok_ref = self._track_cam1_refine(pyr_o, pyr_k, uv_o, uv_k, common, R_1)
        common2 = common & ok_ref
        lo, hi = self.RATIO_RANGE
        s, _, ok_s = nofov.scale_grid(R_b, d, Rfs1, tfs1, cam1.backproject(uv_o),
                                      cam1.backproject(uv_ref), common2, lo * tn, hi * tn)
        ok = ok_s & (common2.sum() >= 12) & (tn > 1e-5) & ~deg & (s > 0)
        return torch.stack([tn, deg.to(tn.dtype), s, ok.to(tn.dtype)])

    def _estimate_scale_window(self, k: int):
        """The median map-scale correction s_metric / |t_map| over every
        window baseline o -> k with at least 12 common camera-1 tracks (the
        masks are on the host), or None."""
        dev = self.device
        ratios = []
        for o in range(k):
            common = self.hist_mask[o] & self.hist_mask[k]
            if int(common.sum()) < 12 or self.pyr1_hist[o] is None or self.pyr1_hist[k] is None:
                continue
            vals = self._scale_baseline(
                self.pyr1_hist[o], self.pyr1_hist[k], self.window.R[o], self.window.t[o],
                self.window.R[k], self.window.t[k], torch.as_tensor(self.uv1_hist[o], device=dev),
                torch.as_tensor(self.uv1_hist[k], device=dev),
                torch.as_tensor(common, device=dev)).cpu().numpy()  # the baseline's one copy
            tn, _, s, ok = vals
            if ok > 0.5:
                ratios.append(float(s) / float(tn))
        return float(np.median(ratios)) if ratios else None

    # -- gauge -------------------------------------------------------------

    def _apply_scale_window(self, s: float):
        """Rescale the window about its oldest keyframe position: poses,
        landmarks, the current estimate, the constant-velocity model and
        the prior (values and square-root information) move together; the
        recorded history does not."""
        t0 = self.window.t[0]
        self.window = self.window.replace(t=t0 + (self.window.t - t0) * s,
                                          lmk=t0 + (self.window.lmk - t0) * s)
        self.t_cur = t0 + (self.t_cur - t0) * s
        self.dT = (self.dT[0], self.dT[1] * s)
        self.priors = marg.gauge_transform_priors(
            self.priors, torch.eye(3, device=self.device), s, anchor=t0)

    def _apply_scale_global(self, s: float):
        """The first estimate: the whole map and the recorded history go to
        metric scale at once."""
        self.window = self.window.replace(t=self.window.t * s, lmk=self.window.lmk * s)
        self.t_cur = self.t_cur * s
        self.dT = (self.dT[0], self.dT[1] * s)
        self.traj = [(ts, R, t * s) for ts, R, t in self.traj]
        self.kf_traj = [(ts, R, t * s) for ts, R, t in self.kf_traj]

    # -- frame hook ----------------------------------------------------------

    def process_frame(self, frame) -> dict:
        pyr_prev_kf = self.kf_pyr
        n_arch0 = len(self.archived_kf)
        n_resets0 = self.n_resets
        out = super().process_frame(frame)
        if not self.initialized or self.n_resets != n_resets0:
            self.v1_last[:] = False
            self.hist_mask[:] = False
            return out
        if not out.get("is_kf"):
            return out
        dev = self.device
        L = self.caps.L

        # the window rolled inside the base class: shift the history rows
        if len(self.archived_kf) > n_arch0:
            self.uv1_hist = np.roll(self.uv1_hist, -1, axis=0)
            self.hist_mask = np.roll(self.hist_mask, -1, axis=0)
            self.hist_mask[-1] = False
            self.pyr1_hist = self.pyr1_hist[1:] + [None]

        k = self.n_kf - 1
        # chain camera 1's tracks from the previous keyframe to this one
        if pyr_prev_kf is not None and self.v1_last.any():
            uv_new, ok = self._track_cam1(pyr_prev_kf, self._last_pyr,
                                          torch.as_tensor(self.uv1_last, device=dev),
                                          torch.as_tensor(self.v1_last, device=dev))
            pk = torch.cat([uv_new, ok[:, None].float()], 1).cpu().numpy()
            self.uv1_last = pk[:, :2].copy()
            self.v1_last = (pk[:, 2] > 0.5) & self.v1_last

        # reseed dead camera-1 slots before the observation row is written,
        # so fresh tracks start gathering window observations now
        uv_det, _, v_det = self._detect_cam1(self._last_pyr[1][0],
                                             torch.as_tensor(self.uv1_last, device=dev),
                                             torch.as_tensor(self.v1_last, device=dev))
        M = uv_det.shape[0]
        pk = torch.cat([uv_det.reshape(-1), v_det.float(),
                        self.window.lmk_mask.float()]).cpu().numpy()
        uv_det_h, v_det_h, lmk_mask_h = pk[:2 * M].reshape(M, 2), pk[2 * M:3 * M] > 0.5, \
            pk[3 * M:] > 0.5
        claimable = ~self.v1_last & (np.arange(L) >= L // 2) & ~lmk_mask_h
        free = np.where(claimable)[0]
        src = np.where(v_det_h)[0][: len(free)]
        tgt = free[: len(src)]
        self.uv1_last[tgt] = uv_det_h[src]
        self.v1_last[tgt] = True
        if len(tgt):
            # a reseeded slot is a new landmark: clear the dead track's
            # observation rows and history
            cleared = torch.zeros(L, dtype=torch.bool, device=dev)
            cleared[torch.as_tensor(tgt, device=dev)] = True
            self.obs = self.obs.replace(mask=self.obs.mask & ~cleared[None, None, :])
            self.hist_mask[:, tgt] = False

        self.uv1_hist[k] = self.uv1_last
        self.hist_mask[k] = self.v1_last
        self.pyr1_hist[k] = tuple(self._last_pyr[1])

        # camera 1's observation row and landmarks, then the joint BA
        self.window, self.obs = self._cam1_kf_update(
            self.window, self.obs, torch.as_tensor(self.uv1_last, device=dev),
            torch.as_tensor(self.v1_last, device=dev), k)
        fixed_n = 1 if not self._have_priors else 0
        fixed_n = max(fixed_n, self.cfg.fixed_frame_number if self.n_kf > 1 else 1)
        self.window, self.obs, _ = self._backend(
            self.window, self.obs, self.imu.replace(mask=torch.zeros_like(self.imu.mask)),
            self.priors, fixed_n)
        self.R_cur = self.window.R[k]
        self.t_cur = self.window.t[k]
        self.tracks = self.tracks.replace(has3d=self.window.lmk_mask)

        # estimate and apply the scale correction
        ratio = self._estimate_scale_window(k)
        if ratio is not None and np.isfinite(ratio) and 0.05 < ratio < 20.0:
            self.scale_state["n_est"] += 1
            out["scale_ratio"] = ratio
            if not self.scale_state["applied"]:
                self._apply_scale_global(ratio)
                self.scale_state["applied"] = True
                self.scale_state["s"] = ratio
                out["scale_applied"] = ratio
            elif abs(ratio - 1.0) > self.SCALE_DEADBAND:
                lo, hi = self.SCALE_STEP_CLIP
                s = float(np.clip(ratio ** self.SCALE_DAMP, lo, hi))
                self._apply_scale_window(s)
                self.scale_state["s"] *= s
                out["scale_step"] = s
        return out
