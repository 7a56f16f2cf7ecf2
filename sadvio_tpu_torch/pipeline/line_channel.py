"""Line-feature channel ("linexd"): the second feature type of the pipeline.

Port of ``sadvio_tpu/pipeline/line_channel.py``.  Per keyframe: Hough
detection in both cameras, stereo matching and plane-intersection
triangulation of candidate 3D segments, association of the map lines by
projecting them into each camera (clipped to the image) and matching, and
spawning of unclaimed candidates into stale slots.  All state lives in
fixed-shape tensors on the rig's device.

Two refinement modes:
  * in_ba=True (the pipeline's): observation rows are aligned to window
    slots and handed to the window BA as a ``LineBlock``, where the lines
    constrain poses;
  * in_ba=False (standalone): a fixed-pose Gauss-Newton on each line's
    endpoints over a ring buffer of its last W keyframe observations, all
    slots in one batched 6x6 solve per iteration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sadvio_tpu_torch.data.window import LineBlock
from sadvio_tpu_torch.frontend import lines as lines_mod
from sadvio_tpu_torch.models import cameras
from sadvio_tpu_torch.pipeline.channels import claim_slots, claimed, sensor_poses, spawn


def _put(x, idx, val):
    """Copy of x with x[idx] = val."""
    x = x.clone()
    x[idx] = val
    return x


class LineChannel:
    """Fixed-capacity line-landmark map + per-keyframe update."""

    def __init__(self, rig, *, n_slots: int = 32, n_detect: int = 24, window: int = 4,
                 gn_iters: int = 8, in_ba: bool = False, k_window: int | None = None):
        self.rig = rig
        self.device = rig.t_f_s.device
        self.M = n_slots
        self.n_detect = n_detect
        self.in_ba = in_ba
        # BA mode: row index = window slot (W = K); standalone: a W-deep ring
        self.W = int(k_window) if in_ba else window
        self.gn_iters = gn_iters
        self.clear()

    def clear(self):
        """Drop the whole line map and the observation buffers."""
        M, W, dev = self.M, self.W, self.device
        self.p0 = torch.zeros((M, 3), device=dev)
        self.p1 = torch.zeros((M, 3), device=dev)
        self.mask = torch.zeros(M, dtype=torch.bool, device=dev)
        self.age = torch.zeros(M, dtype=torch.int64, device=dev)
        # both cameras' segments and the keyframe pose per row
        self.obs_ends = torch.zeros((W, 2, M, 2, 2), device=dev)
        self.obs_mask = torch.zeros((W, 2, M), dtype=torch.bool, device=dev)
        self.obs_R = torch.eye(3, device=dev).expand(W, 3, 3).clone()
        self.obs_t = torch.zeros((W, 3), device=dev)
        self._head = 0

    # -- device-side update ------------------------------------------------

    def _kf_update(self, img0, img1, R_w_f, t_w_f, row: int, refine: bool):
        rig, dev = self.rig, self.device
        cams = [rig.cam.camera(0), rig.cam.camera(1)]
        p0, p1, mask, age = self.p0, self.p1, self.mask, self.age
        obs_ends, obs_mask = self.obs_ends.clone(), self.obs_mask.clone()

        ends0, s0, v0 = lines_mod.detect_lines(img0, n_lines=self.n_detect)
        ends1, s1, v1 = lines_mod.detect_lines(img1, n_lines=self.n_detect)
        v0 = lines_mod.dedup_lines(ends0, v0, s0)
        v1 = lines_mod.dedup_lines(ends1, v1, s1)
        R_ws, t_ws = sensor_poses(rig, R_w_f, t_w_f)

        # stereo candidates: match, triangulate, gate by reprojection onto
        # both observed segments and by scale
        idx01, _ = lines_mod.match_lines(ends0, v0, ends1, v1)
        ends1m = ends1[torch.clamp(idx01, min=0)]
        c0, c1, tri_ok = lines_mod.triangulate_line(cams[0], cams[1], R_ws[0], t_ws[0], R_ws[1],
                                                    t_ws[1], ends0, ends1m)
        r_a, vis_a = lines_mod.line_reproj_residual(cams[0], R_w_f, t_w_f, rig.R_f_s[0],
                                                    rig.t_f_s[0], c0, c1, ends0)
        r_b, vis_b = lines_mod.line_reproj_residual(cams[1], R_w_f, t_w_f, rig.R_f_s[1],
                                                    rig.t_f_s[1], c0, c1, ends1m)
        perp_err = torch.maximum(r_a[..., :2].abs().amax(-1), r_b[..., :2].abs().amax(-1))
        d0 = torch.linalg.norm(0.5 * (c0 + c1) - t_ws[0], dim=-1)
        seg_len = torch.linalg.norm(c1 - c0, dim=-1)
        scale_ok = (d0 > 0.5) & (d0 < 60.0) & (seg_len < 20.0)
        cand_ok = (idx01 >= 0) & tri_ok & v0 & vis_a & vis_b & (perp_err < 1.5) & scale_ok

        # map association per camera: project the map lines, clip them to
        # the image, match with tight gates, and require the matched
        # detection's midpoint to lie on the predicted infinite line
        trk = []
        for c, (ends_c, v_c) in enumerate(((ends0, v0), (ends1, v1))):
            cam_c, Rfs, tfs = cams[c], rig.R_f_s[c], rig.t_f_s[c]
            uv_a, _ = cameras.project_world(cam_c, R_w_f, t_w_f, Rfs, tfs, p0)
            uv_b, _ = cameras.project_world(cam_c, R_w_f, t_w_f, Rfs, tfs, p1)
            z_a = cameras.world_to_cam(R_w_f, t_w_f, Rfs, tfs, p0)[..., 2]
            z_b = cameras.world_to_cam(R_w_f, t_w_f, Rfs, tfs, p1)[..., 2]
            ca, cb, in_img = lines_mod.clip_segment_to_image(uv_a, uv_b, float(cam_c.width),
                                                             float(cam_c.height))
            clip_len = torch.linalg.norm(cb - ca, dim=-1)
            proj_ok = mask & (z_a > 0.1) & (z_b > 0.1) & in_img & (clip_len > 12.0)
            idx_c, _ = lines_mod.match_lines(torch.stack([ca, cb], 1), proj_ok, ends_c, v_c,
                                             max_midpoint_px=25.0, max_angle_deg=6.0,
                                             min_overlap=0.5)
            det_for_slot = ends_c[torch.clamp(idx_c, min=0)]
            p_dir = cb - ca
            p_dir = p_dir / torch.clamp(torch.linalg.norm(p_dir, dim=-1, keepdim=True), min=1e-6)
            p_n = torch.stack([-p_dir[:, 1], p_dir[:, 0]], -1)
            perp_c = torch.abs(((det_for_slot.mean(1) - ca) * p_n).sum(-1))
            trk_c = (idx_c >= 0) & (perp_c < 3.0)
            obs_ends[row, c] = torch.where(trk_c[:, None, None], det_for_slot,
                                           torch.zeros_like(det_for_slot))
            obs_mask[row, c] = trk_c
            trk.append((idx_c, trk_c))
        idx_map, tracked0 = trk[0]
        tracked = tracked0 | trk[1][1]
        obs_R = _put(self.obs_R, row, R_w_f)
        obs_t = _put(self.obs_t, row, t_w_f)
        age = torch.where(tracked, torch.zeros_like(age), age + 1)

        # spawn: unclaimed, well-triangulated detections into stale slots
        fresh = cand_ok & ~claimed(idx_map, tracked0, self.n_detect)
        stale = (~mask) | (age > self.W)
        tgt, src, do = claim_slots(stale, fresh, age)
        p0, p1 = spawn(p0, tgt, c0[src], do), spawn(p1, tgt, c1[src], do)
        mask = spawn(mask, tgt, torch.ones_like(do), do)
        age = spawn(age, tgt, torch.zeros_like(age), do)
        # a spawned slot starts its observation buffer at this keyframe
        for c, ends_c in enumerate((ends0, ends1m)):
            obs_ends[row, c, tgt] = torch.where(do[:, None, None], ends_c[src],
                                                obs_ends[row, c, tgt])
            obs_mask[row, c, tgt] = do | obs_mask[row, c, tgt]
        # and drops its older rows (a new landmark identity)
        keep_rows = ~do[None, None, :].expand(self.W, 1, -1).clone()
        keep_rows[row] = True
        obs_mask = obs_mask & keep_rows

        if refine:
            p0, p1 = self._refine(p0, p1, mask, obs_ends, obs_mask, obs_R, obs_t)
        # map-level 3D dedup: of two slots on one physical line the one with
        # less support is retired
        mid = 0.5 * (p0 + p1)
        dvec = p1 - p0
        that = dvec / torch.clamp(torch.linalg.norm(dvec, dim=-1, keepdim=True), min=1e-9)
        cosang = torch.abs(that @ that.T)
        rel = mid[None, :, :] - mid[:, None, :]  # (i,j): mid_j - mid_i
        along = torch.einsum("ijk,ik->ij", rel, that)
        perp = torch.linalg.norm(rel - along[..., None] * that[:, None, :], dim=-1)
        support = obs_mask.sum((0, 1))
        ar = torch.arange(self.M, device=dev)
        same3d = ((cosang > math.cos(math.radians(5.0))) & (perp < 0.25) & mask[:, None]
                  & mask[None, :] & (ar[:, None] != ar[None, :]))
        stronger = (support[:, None] > support[None, :]) | (
            (support[:, None] == support[None, :]) & (ar[:, None] < ar[None, :]))
        mask = mask & ~(same3d & stronger).any(0) & (age <= 2 * self.W)
        return (p0, p1, mask, age, obs_ends, obs_mask, obs_R, obs_t,
                torch.stack([mask.sum(), tracked.sum()]))

    def _refine(self, p0, p1, mask, obs_ends, obs_mask, obs_R, obs_t):
        """Fixed-pose Gauss-Newton with LM damping and a 0.5 m trust region
        on every slot's endpoints at once (vmap of jacfwd over slots)."""
        rig = self.rig
        cams = [rig.cam.camera(c) for c in range(2)]

        def residual(x, ends_m, om):
            # ends_m (W,2,2,2): both cameras' segments; om (W,2)
            rs = []
            for c in range(2):
                r, vis = lines_mod.line_reproj_residual(
                    cams[c], obs_R, obs_t, rig.R_f_s[c], rig.t_f_s[c], x[None, :3], x[None, 3:],
                    ends_m[:, c])
                rs.append(r * (om[:, c] & vis).to(x.dtype)[:, None])
            return torch.cat(rs, 0).reshape(-1)

        res_b = torch.func.vmap(residual)
        jac_b = torch.func.vmap(torch.func.jacfwd(residual))
        ends_m = obs_ends.permute(2, 0, 1, 3, 4)  # (M,W,2,2,2)
        om = obs_mask.permute(2, 0, 1)  # (M,W,2)
        cost = lambda x: (res_b(x, ends_m, om) ** 2).sum(-1)
        x = torch.cat([p0, p1], -1)
        lam = torch.full((self.M,), 1e-2, dtype=x.dtype, device=x.device)
        n_obs = om.sum((1, 2))
        for _ in range(self.gn_iters):
            r = res_b(x, ends_m, om)
            J = jac_b(x, ends_m, om)  # (M,R,6)
            H = J.transpose(1, 2) @ J
            H = H + lam[:, None, None] * torch.diag_embed(
                torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6))
            dx = torch.linalg.solve(H, -(J.transpose(1, 2) @ r[..., None]))[..., 0]
            nrm = torch.linalg.norm(dx, dim=-1, keepdim=True)
            dx = dx * torch.clamp(0.5 / torch.clamp(nrm, min=1e-9), max=1.0)
            ok = (n_obs >= 2) & torch.isfinite(dx).all(-1) & mask & (cost(x + dx) < cost(x))
            x = torch.where(ok[:, None], x + dx, x)
            lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 4.0), 1e-4, 1e3)
        return x[:, :3], x[:, 3:]

    # -- host-side wrappers ------------------------------------------------

    def on_keyframe(self, frame, img0, img1, R_w_f, t_w_f):
        """Standalone update with the fixed-pose refinement (``frame`` is
        unused: the signature is shared by every channel)."""
        return self._update(img0, img1, R_w_f, t_w_f, self._head % self.W, refine=True)

    def on_keyframe_pre_ba(self, img0, img1, R_w_f, t_w_f, slot: int):
        """BA-mode update before the window BA: detect, associate, spawn and
        write this keyframe's observation row at its window slot."""
        return self._update(img0, img1, R_w_f, t_w_f, slot, refine=False)

    def _update(self, img0, img1, R_w_f, t_w_f, row, refine):
        (self.p0, self.p1, self.mask, self.age, self.obs_ends, self.obs_mask, self.obs_R,
         self.obs_t, cnt) = self._kf_update(img0, img1, R_w_f, t_w_f, int(row), refine)
        self._head += 1
        n_lines, n_tracked = cnt.tolist()  # one copy
        return {"n_lines": n_lines, "n_lines_tracked": n_tracked}

    def ba_block(self) -> LineBlock:
        """The line map as a window-BA block: only lines seen at >= 2 window
        keyframes constrain poses, and lines seen at fewer than 3 are on
        probation."""
        support = self.obs_mask.any(1).sum(0)
        return LineBlock(ends=torch.stack([self.p0, self.p1], 1), mask=self.mask & (support >= 2),
                         obs=self.obs_ends, obs_mask=self.obs_mask, probation=support < 3)

    def apply_ba(self, ends, obs_mask=None):
        """Write back the BA's endpoints (M,2,3) and the pruned observation
        mask (lines outside the BA were frozen by its free mask)."""
        self.p0, self.p1 = ends[:, 0], ends[:, 1]
        if obs_mask is not None:
            self.obs_mask = obs_mask

    def on_roll(self):
        """Shift the slot-aligned observation buffers with the window."""
        roll = lambda x: torch.roll(x, -1, 0)
        self.obs_ends = _put(roll(self.obs_ends), -1, 0.0)
        self.obs_mask = _put(roll(self.obs_mask), -1, False)
        self.obs_R = _put(roll(self.obs_R), -1, torch.eye(3, device=self.device))
        self.obs_t = _put(roll(self.obs_t), -1, 0.0)

    def gauge_transform(self, R_align, scale, anchor=None):
        """Move the endpoints through a gauge change: p -> anchor + s R (p - anchor)."""
        anchor = torch.zeros(3, device=self.device) if anchor is None else anchor
        tr = lambda p: anchor + scale * (p - anchor) @ torch.as_tensor(R_align).T
        self.p0, self.p1 = tr(self.p0), tr(self.p1)

    def segments(self):
        """(n,2,3) world endpoints of the live line landmarks, on the host."""
        m = self.mask.cpu().numpy()
        return np.stack([self.p0.cpu().numpy(), self.p1.cpu().numpy()], 1)[m]
