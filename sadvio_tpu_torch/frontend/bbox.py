"""Semantic bounding-box features and 3D box landmarks.

Port of ``sadvio_tpu/frontend/bbox.py``.  Detections come from outside (a
provider), as fixed-capacity arrays: corners (N,2,2) [[u0,v0],[u1,v1]],
integer labels and a validity mask.  Matching is one IoU matrix with a
label gate and mutual best; a 3D box (centre + per-axis scale) comes from
two-view midpoint triangulation of the box centres and the pixel extents at
the triangulated depth.
"""

from __future__ import annotations

import torch

from sadvio_tpu_torch.frontend import triangulate as tri

# ModelBBox3D unit-cube vertices
CUBE = ((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0),
        (0.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 1.0))


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU of (N,2,2) boxes -> (Na,Nb)."""
    lo = torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    hi = torch.minimum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    wh = torch.clamp(hi - lo, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(b):
        d = torch.clamp(b[:, 1] - b[:, 0], min=0.0)
        return d[:, 0] * d[:, 1]

    union = area(boxes_a)[:, None] + area(boxes_b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def match_bboxes(boxes_a, labels_a, valid_a, boxes_b, labels_b, valid_b, *, min_iou: float = 0.1):
    """Label-gated mutual-best IoU matching: idx_b (Na,), ok (Na,)."""
    iou = iou_matrix(boxes_a, boxes_b)
    ok = ((labels_a[:, None] == labels_b[None, :]) & valid_a[:, None] & valid_b[None, :]
          & (iou > min_iou))
    aff = torch.where(ok, iou, torch.full_like(iou, -1.0))
    best_b = torch.argmax(aff, 1)
    best_a = torch.argmax(aff, 0)
    mutual = best_a[best_b] == torch.arange(boxes_a.shape[0], device=boxes_a.device)
    return best_b, mutual & (aff.amax(1) > 0.0)


def triangulate_bbox(cam, boxes_a, valid_a, R_ws_a, t_ws_a, boxes_b, valid_b, R_ws_b, t_ws_b):
    """Two-view 3D box of row-aligned matched boxes: centre (N,3) by
    midpoint triangulation of the centre rays, scale (N,3) from the pixel
    extents at the depth in view a (depth extent taken as the height)."""
    ca = 0.5 * (boxes_a[:, 0] + boxes_a[:, 1])
    cb = 0.5 * (boxes_b[:, 0] + boxes_b[:, 1])
    n = ca.shape[0]
    ray_a = (R_ws_a @ cam.backproject(ca)[..., None])[..., 0]
    ray_b = (R_ws_b @ cam.backproject(cb)[..., None])[..., 0]
    origins = torch.stack([t_ws_a.expand(n, 3), t_ws_b.expand(n, 3)], 1)
    p_w, ok = tri.midpoint_triangulate(origins, torch.stack([ray_a, ray_b], 1),
                                       torch.stack([valid_a, valid_b], 1))
    p_a = torch.einsum("ji,nj->ni", R_ws_a, p_w - t_ws_a[None, :])
    depth = torch.clamp(p_a[:, 2], min=1e-6)
    ext = torch.clamp(boxes_a[:, 1] - boxes_a[:, 0], min=0.0)
    f = torch.stack([cam.fx.reshape(()), cam.fy.reshape(())])
    wh = depth[:, None] * ext / f[None, :]
    return p_w, torch.cat([wh, wh[:, 1:2]], -1), ok & valid_a & valid_b


def pose_from_provider(T_w_s, p_s, valid):
    """Box centres given in the sensor frame, moved to the world."""
    R, t = T_w_s
    return (R @ p_s[..., None])[..., 0] + t, valid


def project_box(cam, R_ws, t_ws, center_w, scale, valid):
    """2D box of a world-axis-aligned 3D box: min/max over the projections
    of its 8 scaled cube corners.  Returns boxes (N,2,2), ok (N,)."""
    cube = torch.tensor(CUBE, dtype=center_w.dtype, device=center_w.device)
    corners_w = center_w[:, None, :] + (cube[None] - 0.5) * scale[:, None, :]
    uv, ok = cam.project(torch.einsum("ji,nkj->nki", R_ws, corners_w - t_ws[None, None, :]))
    return torch.stack([uv.amin(1), uv.amax(1)], 1), valid & ok.all(1)
