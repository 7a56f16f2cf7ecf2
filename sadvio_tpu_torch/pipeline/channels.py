"""Feature-type channels beside points and lines: edgelets, coded-ellipse
patterns and semantic boxes.

Port of ``sadvio_tpu/pipeline/channels.py``.  Each label of
``features_handled`` beyond pointxd builds its channel; only points and
lines enter the window BA, the channels here keep typed landmark maps
refined at fixed poses.  Each channel owns a fixed-capacity slot map on the
rig's device, updated once per keyframe by ``on_keyframe(frame, img0, img1,
R_w_f, t_w_f) -> health dict`` with one device-to-host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from sadvio_tpu_torch.frontend import bbox as bbox_mod
from sadvio_tpu_torch.frontend import edgelets as edge_mod
from sadvio_tpu_torch.frontend import ellipses as ell_mod
from sadvio_tpu_torch.models import cameras


def claim_slots(stale, fresh, age):
    """Assign fresh candidates to stale map slots, oldest stale slot first.

    Returns (tgt (M,), src (M,), do (M,)): slot, candidate and activity of
    each potential spawn.  Active slots sort last (a +10**6 key) and both
    sorts are stable, so equal keys keep index order as in the JAX package.
    """
    M, N = stale.shape[0], fresh.shape[0]
    dev = stale.device
    key = torch.where(stale, -age, torch.full_like(age, 10 ** 6))
    slot_order = torch.argsort(key, stable=True)
    det_order = torch.argsort((~fresh).to(torch.uint8), stable=True)  # fresh first
    n_spawn = torch.minimum(stale.sum(), fresh.sum())
    ar = torch.arange(M, device=dev)
    take = ar < torch.clamp(n_spawn, max=N)
    tgt = slot_order[:M]
    src = det_order[torch.clamp(ar, max=N - 1)]
    return tgt, src, take & stale[tgt] & fresh[src]


def spawn(x, tgt, src_vals, do):
    """Copy of x with rows tgt replaced by src_vals where do."""
    x = x.clone()
    d = do.reshape(-1, *([1] * (x.dim() - 1)))
    x[tgt] = torch.where(d, src_vals, x[tgt])
    return x


def sensor_poses(rig, R_w_f, t_w_f):
    """Sensor-to-world rotations and origins of every camera of the rig at
    body pose (R_w_f, t_w_f)."""
    return ([R_w_f @ rig.R_f_s[c] for c in range(rig.C)],
            [t_w_f + R_w_f @ rig.t_f_s[c] for c in range(rig.C)])


def claimed(idx, hit, n):
    """(n,) bool: candidate j is the match of some slot that hit."""
    return ((torch.clamp(idx, min=0)[:, None] == torch.arange(n, device=idx.device)[None, :])
            & hit[:, None]).any(0)


class EdgeletChannel:
    """edgeletxd: oriented edge points -> 3D edgelets (point + unit direction).

    Per keyframe: detection in both cameras, proximity + tangent stereo
    matching, two-view triangulation, association of the map by projection
    into camera 0, measurement blending of tracked slots, spawning."""

    def __init__(self, rig, *, n_slots: int = 64, max_age: int = 8):
        self.rig = rig
        dev = rig.t_f_s.device
        self.M = n_slots
        self.max_age = max_age
        self.p = torch.zeros((n_slots, 3), device=dev)
        self.d = torch.zeros((n_slots, 3), device=dev)
        self.mask = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.age = torch.zeros(n_slots, dtype=torch.int64, device=dev)

    def _kf_update(self, img0, img1, R_w_f, t_w_f, p, d, mask, age):
        rig = self.rig
        cam0, cam1 = rig.cam.camera(0), rig.cam.camera(1)
        uv0, dir0, _, v0 = edge_mod.detect_edgelets(img0)
        uv1, dir1, _, v1 = edge_mod.detect_edgelets(img1)
        R_ws, t_ws = sensor_poses(rig, R_w_f, t_w_f)
        idx01, _ = edge_mod.match_edgelets(uv0, dir0, v0, uv1, dir1, v1)
        j = torch.clamp(idx01, min=0)
        p_c, d_c, ok_c = edge_mod.triangulate_edgelet(cam0, cam1, R_ws[0], t_ws[0], R_ws[1],
                                                      t_ws[1], uv0, dir0, uv1[j], dir1[j])
        depth0 = torch.einsum("ji,nj->ni", R_ws[0], p_c - t_ws[0][None])[:, 2]
        cand = (idx01 >= 0) & ok_c & v0 & (depth0 > 0.3) & (depth0 < 25.0)

        # association: the map's points and tangents projected into camera 0
        uv_m, vis_m = cameras.project_world(cam0, R_w_f, t_w_f, rig.R_f_s[0], rig.t_f_s[0], p)
        uv_m2, _ = cameras.project_world(cam0, R_w_f, t_w_f, rig.R_f_s[0], rig.t_f_s[0],
                                         p + 0.05 * d)
        tan = uv_m2 - uv_m
        tan = tan / torch.clamp(torch.linalg.norm(tan, dim=-1, keepdim=True), min=1e-9)
        idx_det, _ = edge_mod.match_edgelets(uv_m, tan, mask & vis_m, uv0, dir0, v0)
        tracked = idx_det >= 0
        age = torch.where(tracked, torch.zeros_like(age), age + 1)

        sel = torch.clamp(idx_det, min=0)
        upd = tracked & cand[sel]
        a = 0.3
        p_meas, d_meas = p_c[sel], d_c[sel]
        # edge directions are 180-degree ambiguous: sign-align, then blend
        sgn = torch.sign((d_meas * d).sum(-1, keepdim=True) + 1e-12)
        p = torch.where(upd[:, None], (1 - a) * p + a * p_meas, p)
        dn = (1 - a) * d + a * sgn * d_meas
        dn = dn / torch.clamp(torch.linalg.norm(dn, dim=-1, keepdim=True), min=1e-9)
        d = torch.where(upd[:, None], dn, d)

        fresh = cand & ~claimed(idx_det, tracked, v0.shape[0])
        stale = (~mask) | (age > self.max_age)
        tgt, src, do = claim_slots(stale, fresh, age)
        p = spawn(p, tgt, p_c[src], do)
        d = spawn(d, tgt, d_c[src], do)
        mask = spawn(mask, tgt, torch.ones_like(do), do)
        age = spawn(age, tgt, torch.zeros_like(age), do)
        mask = mask & (age <= self.max_age)
        return p, d, mask, age, torch.stack([mask.sum(), (tracked & mask).sum()])

    def on_keyframe(self, frame, img0, img1, R_w_f, t_w_f):
        self.p, self.d, self.mask, self.age, cnt = self._kf_update(
            img0, img1, R_w_f, t_w_f, self.p, self.d, self.mask, self.age)
        n, n_trk = cnt.tolist()
        return {"n_edgelets": n, "n_edgelets_tracked": n_trk}

    def points(self):
        m = self.mask.cpu().numpy()
        return self.p.cpu().numpy()[m], self.d.cpu().numpy()[m]


class EllipseChannel:
    """ellipsepatternxd: coded 4-marker patterns in camera 0 -> pattern pose
    landmarks, associated across keyframes by decoded pattern ID."""

    def __init__(self, rig, *, n_slots: int = 8, side: float = 1.0, max_age: int = 12):
        self.rig = rig
        dev = rig.t_f_s.device
        self.S = n_slots
        self.side = side
        self.max_age = max_age
        self.pid = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
        self.R_w_p = torch.eye(3, device=dev).expand(n_slots, 3, 3).clone()
        self.t_w_p = torch.zeros((n_slots, 3), device=dev)
        self.mask = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.age = torch.zeros(n_slots, dtype=torch.int64, device=dev)

    def _kf_update(self, img0, R_w_f, t_w_f, pid, R_w_p, t_w_p, mask, age):
        rig = self.rig
        cam0 = rig.cam.camera(0)
        det = ell_mod.detect_coded_ellipses(img0)
        uv4, det_pid, det_ok = ell_mod.group_patterns_4(det)
        z, o = torch.zeros((), device=uv4.device), torch.ones((), device=uv4.device)
        Kmat = torch.stack([torch.stack([cam0.fx.reshape(()), z, cam0.cx.reshape(())]),
                            torch.stack([z, cam0.fy.reshape(()), cam0.cy.reshape(())]),
                            torch.stack([z, z, o])])
        R_cp, t_cp = ell_mod.pattern_pose(Kmat, uv4, self.side)
        R_ws, t_ws = sensor_poses(rig, R_w_f, t_w_f)
        R_wp_det = torch.einsum("ij,njk->nik", R_ws[0], R_cp)
        t_wp_det = torch.einsum("ij,nj->ni", R_ws[0], t_cp) + t_ws[0]

        idx, tracked = ell_mod.match_patterns(pid, mask, det_pid, det_ok)
        age = torch.where(tracked, torch.zeros_like(age), age + 1)
        a = 0.4
        sel = torch.clamp(idx, min=0)
        t_w_p = torch.where(tracked[:, None], (1 - a) * t_w_p + a * t_wp_det[sel], t_w_p)
        R_w_p = torch.where(tracked[:, None, None], R_wp_det[sel], R_w_p)

        fresh = det_ok & ~claimed(idx, tracked, det_ok.shape[0])
        stale = (~mask) | (age > self.max_age)
        tgt, src, do = claim_slots(stale, fresh, age)
        pid = spawn(pid, tgt, det_pid[src], do)
        R_w_p = spawn(R_w_p, tgt, R_wp_det[src], do)
        t_w_p = spawn(t_w_p, tgt, t_wp_det[src], do)
        mask = spawn(mask, tgt, torch.ones_like(do), do)
        age = spawn(age, tgt, torch.zeros_like(age), do)
        mask = mask & (age <= self.max_age)
        return pid, R_w_p, t_w_p, mask, age, torch.stack([mask.sum(), tracked.sum()])

    def on_keyframe(self, frame, img0, img1, R_w_f, t_w_f):
        (self.pid, self.R_w_p, self.t_w_p, self.mask, self.age, cnt) = self._kf_update(
            img0, R_w_f, t_w_f, self.pid, self.R_w_p, self.t_w_p, self.mask, self.age)
        n, n_trk = cnt.tolist()
        return {"n_patterns": n, "n_patterns_tracked": n_trk}

    def patterns(self):
        m = self.mask.cpu().numpy()
        return (self.pid.cpu().numpy()[m], self.R_w_p.cpu().numpy()[m],
                self.t_w_p.cpu().numpy()[m])


class BBoxChannel:
    """bboxxd: semantic boxes from outside -> 3D boxes (centre + per-axis
    scale).  Detections come from ``frame.bboxes`` or a ``provider(ts)``
    callable, each {"boxes": (C,N,2,2), "labels": (C,N), "valid": (C,N)}.

    Per keyframe: label-gated IoU stereo matching, two-view triangulation,
    association of the map by projecting its boxes into camera 0."""

    def __init__(self, rig, *, n_slots: int = 16, provider=None, max_age: int = 6):
        self.rig = rig
        dev = rig.t_f_s.device
        self.M = n_slots
        self.provider = provider
        self.max_age = max_age
        self.center = torch.zeros((n_slots, 3), device=dev)
        self.scale = torch.zeros((n_slots, 3), device=dev)
        self.label = torch.full((n_slots,), -1, dtype=torch.int64, device=dev)
        self.mask = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self.age = torch.zeros(n_slots, dtype=torch.int64, device=dev)

    def _kf_update(self, boxes, labels, valid, R_w_f, t_w_f, center, scale, label, mask, age):
        rig = self.rig
        cam0 = rig.cam.camera(0)
        R_ws, t_ws = sensor_poses(rig, R_w_f, t_w_f)
        idx01, ok01 = bbox_mod.match_bboxes(boxes[0], labels[0], valid[0], boxes[1], labels[1],
                                            valid[1])
        c_w, s_w, tri_ok = bbox_mod.triangulate_bbox(
            cam0, boxes[0], valid[0], R_ws[0], t_ws[0], boxes[1][torch.clamp(idx01, min=0)],
            ok01, R_ws[1], t_ws[1])
        cand = ok01 & tri_ok

        proj, proj_ok = bbox_mod.project_box(cam0, R_ws[0], t_ws[0], center, scale, mask)
        idx_det, tracked = bbox_mod.match_bboxes(proj, label, mask & proj_ok, boxes[0], labels[0],
                                                 valid[0])
        age = torch.where(tracked, torch.zeros_like(age), age + 1)
        sel = torch.clamp(idx_det, min=0)
        upd = tracked & cand[sel]
        a = 0.3
        center = torch.where(upd[:, None], (1 - a) * center + a * c_w[sel], center)
        scale = torch.where(upd[:, None], (1 - a) * scale + a * s_w[sel], scale)

        fresh = cand & ~claimed(idx_det, tracked, valid.shape[1])
        stale = (~mask) | (age > self.max_age)
        tgt, src, do = claim_slots(stale, fresh, age)
        center = spawn(center, tgt, c_w[src], do)
        scale = spawn(scale, tgt, s_w[src], do)
        label = spawn(label, tgt, labels[0][src], do)
        mask = spawn(mask, tgt, torch.ones_like(do), do)
        age = spawn(age, tgt, torch.zeros_like(age), do)
        mask = mask & (age <= self.max_age)
        return center, scale, label, mask, age, torch.stack([mask.sum(), tracked.sum()])

    def on_keyframe(self, frame, img0, img1, R_w_f, t_w_f):
        det = getattr(frame, "bboxes", None)
        if det is None and self.provider is not None:
            det = self.provider(frame.ts)
        if det is None:
            return {"n_boxes": int(self.mask.sum()), "n_boxes_tracked": 0}
        dev = self.center.device
        (self.center, self.scale, self.label, self.mask, self.age, cnt) = self._kf_update(
            torch.as_tensor(np.asarray(det["boxes"], np.float32), device=dev),
            torch.as_tensor(np.asarray(det["labels"]).astype(np.int64), device=dev),
            torch.as_tensor(np.asarray(det["valid"], bool), device=dev), R_w_f, t_w_f,
            self.center, self.scale, self.label, self.mask, self.age)
        n, n_trk = cnt.tolist()
        return {"n_boxes": n, "n_boxes_tracked": n_trk}

    def boxes(self):
        m = self.mask.cpu().numpy()
        return (self.center.cpu().numpy()[m], self.scale.cpu().numpy()[m],
                self.label.cpu().numpy()[m])
