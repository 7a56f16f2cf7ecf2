"""The stages of the port's frame loop as plain PyTorch functions: a frozen
copy of the bodies of ``StereoSLAM``'s and ``MonoSLAM``'s stage methods
(``pipeline/slam.py``, ``pipeline/mono.py``) over the frozen copies of the
modules they call, as far as the benchmark's configurations reach them:
``tracker: klt``, ``pose_estimator: pnp``, ``optimizer: analytic``, and no
line landmarks, global map or precomputed keypoints.  A stage handed
anything else raises.

``Stages`` holds what the methods read from their instance: the rig, the
configuration, the capacities, the IMU noise, the BA options and the RANSAC
generator.  Each stage runs eagerly on the device of its inputs; the LK track
is the plain version.  Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.backend import ba, marginalization as marg
from portbench.reference.data.window import (
    LMK_RESURRECTED, ImuChain, Observations, PriorSet, WindowState,
)
from portbench.reference.frontend import detect, epipolar, eskf as eskf_mod, klt, pnp, triangulate
from portbench.reference.models import cameras, imu as imu_mod
from portbench.reference.utils import geometry as geo
from portbench.reference.utils.struct import Struct, select, take, tree_map


@dataclass
class TrackState(Struct):
    """Per-camera feature tracks; slot index == landmark slot index."""

    uv: torch.Tensor  # (C,L,2)
    valid: torch.Tensor  # (C,L)
    uv_kf: torch.Tensor  # (C,L,2) positions at the last keyframe
    has3d: torch.Tensor  # (L,) landmark triangulated


def _set(x, idx, val):
    """Copy of x with x[idx] = val.  ``idx``: an index or a tuple of indices
    into the leading dims, each a Python int or a 0-d integer tensor."""
    sel = torch.ones((), dtype=torch.bool, device=x.device)
    for d, i in enumerate(idx if isinstance(idx, tuple) else (idx,)):
        shape = [1] * x.ndim
        shape[d] = x.shape[d]
        sel = sel & (torch.arange(x.shape[d], device=x.device) == i).reshape(shape)
    return torch.where(sel, val, x)


def _absent(**kw):
    """The program's stage arguments of paths the reference does not copy
    (line landmarks, the global map, precomputed keypoints) must be unset."""
    given = sorted(k for k, v in kw.items() if v is not None)
    if given:
        raise ValueError(f"the reference copies no path that takes {', '.join(given)}")


class Stages:
    """The stereo pipeline's stages (``StereoSLAM``'s)."""

    def __init__(self, rig, cfg, imu_params, gen=None):
        self.rig = rig
        self.cfg = cfg
        self.caps = cfg.caps
        self.C = rig.C
        self.device = rig.R_f_s.device
        self.vio = cfg.slam_mode.endswith("vio")
        self.imu_params = imu_params
        self.klt_engine = "fused"
        if (cfg.tracker != "klt" or not cfg.pose_estimator.lower().startswith("pnp")
                or cfg.optimizer.lower().startswith("angular")):
            raise ValueError(f"the reference copies the klt / pnp / analytic path only, not "
                             f"{cfg.tracker} / {cfg.pose_estimator} / {cfg.optimizer}")
        self.gen = gen
        self._ba_opts = ba.BAOptions(iters=cfg.ba_iterations, sigma_px=1.0,
                                     acc_walk=imu_params.acc_walk, gyr_walk=imu_params.gyr_walk)

    def _pyramids(self, images):
        images = images.to(torch.float32)
        return tuple(tuple(klt.build_pyramid(images[c], self.caps.pyr_levels))
                     for c in range(self.C))

    def _frontend(self, pyr_kf, pyr_new, tracks: TrackState, window: WindowState, R_pred,
                  t_pred, v_pred, R_cur, t_cur, kf_tmpl=None, eskf_on=False, pre_cov=None,
                  sample_idx=None):
        """Track cam0 from the last-KF template, PnP, epipolar gate, ESKF.

        ``sample_idx`` (N_HYP, 4): the PnP RANSAC subsets, drawn by the caller.

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

        uv1, ok, _ = klt.track(pyr_kf[0], pyr_new[0], tracks.uv_kf[0], init, tracks.valid[0],
                               levels=self.caps.pyr_levels, radius=self.caps.klt_radius,
                               warp=A, tmpl_wins=kf_tmpl, engine=self.klt_engine)

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
                           obs: Observations, R_kf, t_kf, slot_limit: int):
        """Camera 0's half of a keyframe insertion: detect in the free image
        area, resurrect dead in-map landmarks, and
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
                   imu_chain: ImuChain, pre_cur, R_kf, t_kf, v_kf, ts, slot,
                   imu_gap_ok: bool = True, gm=None, lmk_desc=None, ext_det=None):
        """Insert a keyframe at ``slot``: detect, resurrect, stereo-track,
        triangulate, write the observation rows.  ``ts`` (the keyframe's
        stamp, in ``window.ts``'s dtype) and ``slot`` (int64) are 0-d tensors.
        Returns (tracks, window, obs, imu_chain)."""
        _absent(gm=gm, lmk_desc=lmk_desc, ext_det=ext_det)
        cam0, cam1 = self.rig.cam.camera(0), self.rig.cam.camera(1)
        Rfs, tfs = self.rig.R_f_s, self.rig.t_f_s
        L = self.caps.L
        img0 = pyr_new[0][0]
        uv_det, v_det, take, slot_of_det, new_uv0, new_v0, window, obs = \
            self._detect_into_slots(img0, tracks, window, obs, R_kf, t_kf, L)

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

    def _backend(self, window, obs, imu_chain, priors, fixed_n: int, lines=None):
        """Window BA + outlier removal."""
        _absent(lines=lines)
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
        """Marginalize slot 0 and shift the window left by one."""
        _absent(gm=gm, lmk_desc=lmk_desc)
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
        return window, obs, imu_chain, new_priors, tracks, n_overflow, degen

    def _preint(self, batch, pre):
        """One (IMU_CAP, 7) batch [acc, gyr, dt] into ``pre``; padding rows
        have dt = 0 and are exact no-ops."""
        return imu_mod.preintegrate(batch[:, 0:3], batch[:, 3:6], batch[:, 6], pre.ba_lin,
                                    pre.bg_lin, self.imu_params, init=pre)


class MonoStages(Stages):
    """The monocular pipeline's stages (``MonoSLAM``'s): the keyframe
    insertion detects in camera 0 only and triangulates from the window."""

    def __init__(self, rig, cfg, imu_params, gen=None):
        super().__init__(rig, cfg, imu_params, gen)
        self._cam0_slot_limit = self.caps.L

    def _insert_kf(self, pyr_new, tracks, window, obs, imu_chain, pre_cur, R_kf, t_kf, v_kf,
                   ts, slot, imu_gap_ok: bool = True, gm=None, lmk_desc=None, ext_det=None):
        """Insert a keyframe at ``slot``: detect and resurrect in camera 0's
        slot range, write camera 0's observation row, and triangulate every
        slot that has two window observations and no landmark yet.  Returns
        (tracks, window, obs, imu_chain)."""
        _absent(gm=gm, lmk_desc=lmk_desc, ext_det=ext_det)
        _, _, _, _, new_uv0, new_v0, window, obs = self._detect_into_slots(
            pyr_new[0][0], tracks, window, obs, R_kf, t_kf, self._cam0_slot_limit)

        window = self._write_slot(window, slot, R_kf, t_kf, v_kf, ts)
        obs = obs.replace(uv=_set(obs.uv, (slot, 0), new_uv0),
                          mask=_set(obs.mask, (slot, 0), new_v0))
        imu_chain = self._write_imu(imu_chain, slot, pre_cur, imu_gap_ok)

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
