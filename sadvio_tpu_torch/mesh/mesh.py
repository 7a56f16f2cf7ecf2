"""Mesh-based densification: Delaunay mesh over landmarks -> dense cloud.

Port of ``sadvio_tpu/mesh/mesh.py``.  Division of labour:

* Host: the Delaunay *topology only* (``scipy.spatial.Delaunay`` on the
  projected 2D landmark positions) -> a fixed-capacity triangle index
  array.  It is host work in the JAX package too.
* Device: every filter and the dense ray cast are batched tensor ops on the
  caller's device: triangles are rows of a (T,3) slot-index tensor, the
  sample grid is a dense lattice, and the per-pixel "nearest covering
  triangle" search is one masked reduction over T.

Call ``Mesher.update`` after each keyframe.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sadvio_tpu_torch.frontend.detect import window_sample
from sadvio_tpu_torch.models import cameras
from sadvio_tpu_torch.utils import geometry as geo


class MeshConfig(NamedTuple):
    max_lmk_depth: float = 10.0  # landmarks farther than this are not meshed
    min_angle_deg: float = 20.0  # triangle angle gates
    max_angle_deg: float = 160.0
    max_edge_len: float = 0.5  # config max_length_tsh
    zncc_tsh: float = 0.8  # config ZNCC_tsh
    patch_half: int = 7  # 15x15 barycenter patch
    normal_cos_tsh: float = 0.2  # normal-consistency filter
    ray_stride: int = 6  # every-6th-pixel cast
    min_ray_depth: float = 0.25  # valid depth window of the cast
    max_ray_depth: float = 5.0


def delaunay_triangles(uv: np.ndarray, valid: np.ndarray, cap: int):
    """2D Delaunay over the valid projected landmarks -> (cap,3) slot indices.

    Host-side topology by ``scipy.spatial.Delaunay``.  Triangles beyond
    ``cap`` are cut.  Returns (tri (cap,3) int64 landmark-slot indices,
    mask (cap,) bool, n_total: triangles before the cut)."""
    idx = np.flatnonzero(np.asarray(valid))
    tri_out = np.zeros((cap, 3), np.int64)
    mask_out = np.zeros((cap,), bool)
    if idx.size < 3:
        return tri_out, mask_out, 0
    from scipy.spatial import Delaunay, QhullError

    try:
        tris = Delaunay(np.asarray(uv)[idx]).simplices
    except (QhullError, ValueError):
        return tri_out, mask_out, 0
    simplices = idx[tris]  # back to landmark-slot space
    n = min(len(simplices), cap)
    tri_out[:n] = simplices[:n]
    mask_out[:n] = True
    return tri_out, mask_out, len(simplices)


def filter_triangles(lmk_w, lmk_mask, tri, tri_mask, cam, R_w_f, t_w_f, R_f_s, t_f_s,
                     cfg: MeshConfig = MeshConfig()):
    """Geometric gates on mesh triangles: all three vertices alive and
    within the depth range, triangle angles within [min,max], edges below
    max_edge_len (metres).  Returns the updated tri_mask."""
    p = lmk_w[tri]  # (T,3,3)
    alive = lmk_mask[tri].all(-1) & tri_mask
    z = cameras.world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p.reshape(-1, 3)).reshape(p.shape)[..., 2]
    depth_ok = ((z > 0.0) & (z < cfg.max_lmk_depth)).all(-1)

    e0, e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 1], p[:, 0] - p[:, 2]
    norm = lambda x: torch.linalg.norm(x, dim=-1)
    len_ok = torch.maximum(torch.maximum(norm(e0), norm(e1)), norm(e2)) < cfg.max_edge_len

    def angle(u, v):
        c = (u * v).sum(-1) / torch.clamp(norm(u) * norm(v), min=1e-12)
        return torch.rad2deg(torch.acos(torch.clamp(c, -1.0, 1.0)))

    a0, a1, a2 = angle(-e2, e0), angle(-e0, e1), angle(-e1, e2)
    amin = torch.minimum(torch.minimum(a0, a1), a2)
    amax = torch.maximum(torch.maximum(a0, a1), a2)
    return alive & depth_ok & len_ok & (amin > cfg.min_angle_deg) & (amax < cfg.max_angle_deg)


def triangle_normals(lmk_w, tri):
    """Unit normals of mesh triangles (world frame)."""
    p = lmk_w[tri]
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def normal_consistency(lmk_w, tri, tri_mask, cam_center_w, min_cos=0.2):
    """Drop triangles nearly parallel to the viewing ray."""
    n = triangle_normals(lmk_w, tri)
    view = cam_center_w[None, :] - lmk_w[tri].mean(1)  # from the barycenter
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True), min=1e-12)
    return tri_mask & ((n * view).sum(-1).abs() > min_cos)


def _zncc(a, b, eps=1e-6):
    am = a - a.mean(-1, keepdim=True)
    bm = b - b.mean(-1, keepdim=True)
    den = torch.sqrt((am * am).sum(-1) * (bm * bm).sum(-1))
    return (am * bm).sum(-1) / torch.clamp(den, min=eps)


def zncc_scores(img0, img1, lmk_w, tri, cam0, cam1, R_w_f, t_w_f, R_f_s0, t_f_s0, R_f_s1,
                t_f_s1, patch_half: int = 7):
    """Photometric score of every triangle: a (2h+1)^2 patch at the
    triangle's barycenter projection in cam0 is mapped through the
    triangle's plane into cam1 (each patch pixel's ray is intersected with
    the plane, exact, no homography matrix) and scored with ZNCC.

    Returns (score (T,), frac (T,): share of patch pixels that were usable,
    vis0 (T,): barycenter visible in cam0)."""
    T = tri.shape[0]
    dev = lmk_w.device
    bc_w = lmk_w[tri].mean(1)
    n_w = triangle_normals(lmk_w, tri)
    R_ws0, t_ws0 = geo.pose_compose(R_w_f, t_w_f, R_f_s0, t_f_s0)
    uv0_c, vis0 = cameras.project_world(cam0, R_w_f, t_w_f, R_f_s0, t_f_s0, bc_w)

    r = torch.arange(-patch_half, patch_half + 1, dtype=torch.float32, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)  # (S,2)
    S = offs.shape[0]
    pix0 = uv0_c[:, None, :] + offs[None]  # (T,S,2)
    rays_w = geo.mv(R_ws0, cam0.backproject(pix0.reshape(-1, 2)).reshape(T, S, 3))
    # intersect with the triangle plane: (o + d*s - bc) . n = 0
    denom = (rays_w * n_w[:, None, :]).sum(-1)
    num = ((bc_w - t_ws0[None, :]) * n_w).sum(-1)[:, None]
    s = num / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    pts_w = t_ws0 + rays_w * s[..., None]
    uv1, vis1 = cameras.project_world(cam1, R_w_f, t_w_f, R_f_s1, t_f_s1, pts_w.reshape(-1, 3))
    uv1 = uv1.reshape(T, S, 2)
    vis1 = vis1.reshape(T, S) & (s > 0.05)

    # a patch pixel counts only inside the window around the patch centre
    # (the JAX package samples from one window per triangle; the flags are
    # part of its mask, so they are reproduced)
    uv1_c, _ = cameras.project_world(cam1, R_w_f, t_w_f, R_f_s1, t_f_s1, bc_w)
    patch0, in0 = window_sample(img0, uv0_c, pix0, ws=2 * patch_half + 4)
    patch1, in1 = window_sample(img1, uv1_c, uv1, ws=48)
    # masked ZNCC: unusable pixels contribute zero to both patches
    m = (vis1 & in0 & in1).to(img0.dtype)
    return _zncc(patch0 * m, patch1 * m), m.mean(-1), vis0


def zncc_validate(img0, img1, lmk_w, tri, tri_mask, cam0, cam1, R_w_f, t_w_f, R_f_s0, t_f_s0,
                  R_f_s1, t_f_s1, zncc_tsh=0.8, patch_half: int = 7):
    """Photometric triangle validation: drop triangles whose ZNCC score
    (see zncc_scores) is below the threshold or whose patch is mostly
    unusable."""
    score, frac, vis0 = zncc_scores(img0, img1, lmk_w, tri, cam0, cam1, R_w_f, t_w_f, R_f_s0,
                                    t_f_s0, R_f_s1, t_f_s1, patch_half)
    return tri_mask & vis0 & (frac > 0.6) & (score > zncc_tsh)


def raycast_pointcloud(lmk_w, tri, tri_mask, cam, R_w_f, t_w_f, R_f_s, t_f_s, *,
                       stride: int = 6, height: int = 480, width: int = 752,
                       min_depth: float = 0.25, max_depth: float = 5.0):
    """Dense cloud: cast a ray at every ``stride``-th pixel against the mesh.

    Projects the mesh vertices, finds for each sample pixel the covering
    triangle (nearest by barycentrically interpolated depth among those
    whose projection contains the pixel) and returns the 3D point at that
    depth on the pixel's ray: one (Np, T) masked reduction.
    Returns pts_w (Np,3), valid (Np,)."""
    dev = lmk_w.device
    p = lmk_w[tri]  # (T,3,3)
    uvv, visv = cameras.project_world(cam, R_w_f, t_w_f, R_f_s, t_f_s, p.reshape(-1, 3))
    uvv = uvv.reshape(-1, 3, 2)
    tri_ok = tri_mask & visv.reshape(-1, 3).all(-1)

    ys = torch.arange(stride // 2, height, stride, dtype=torch.float32, device=dev)
    xs = torch.arange(stride // 2, width, stride, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # (Np,2)

    u, v, w = geo.barycentric_coords(pix[:, None, :], uvv[None, :, 0], uvv[None, :, 1],
                                     uvv[None, :, 2])
    inside = (u >= 0) & (v >= 0) & (w >= 0) & tri_ok[None, :]
    z = cameras.world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p.reshape(-1, 3)).reshape(-1, 3, 3)[..., 2]
    z_pix = u * z[None, :, 0] + v * z[None, :, 1] + w * z[None, :, 2]  # (Np,T)
    z_best = torch.where(inside, z_pix, torch.full_like(z_pix, float("inf"))).amin(1)
    valid = torch.isfinite(z_best) & (z_best > min_depth) & (z_best < max_depth)

    rays_c = cam.backproject(pix)
    pts_c = rays_c * (z_best / torch.clamp(rays_c[:, 2], min=1e-6))[:, None]
    R_ws, t_ws = geo.pose_compose(R_w_f, t_w_f, R_f_s, t_f_s)
    return geo.mv(R_ws, pts_c) + t_ws, valid


class Mesher:
    """Per-keyframe mesh maintenance + dense cloud generation.  Mesh and
    cloud tensors live on the rig's device."""

    def __init__(self, rig, cfg: MeshConfig = MeshConfig(), tri_cap: int = 512):
        self.rig = rig
        self.cfg = cfg
        self.tri_cap = tri_cap
        dev = rig.R_f_s.device
        self.tri = torch.zeros((tri_cap, 3), dtype=torch.int64, device=dev)
        self.tri_mask = torch.zeros(tri_cap, dtype=torch.bool, device=dev)
        self.cloud = []  # list of (pts_w, valid) tensors
        self.n_cut = 0  # Delaunay triangles beyond tri_cap, summed over the updates

    def update(self, images, window, R_kf, t_kf, make_cloud: bool = True):
        """Rebuild the keyframe-local mesh and (optionally) cast the dense cloud."""
        rig, cfg = self.rig, self.cfg
        dev = window.lmk.device
        cam0, cam1 = rig.cam.camera(0), rig.cam.camera(1)
        Rfs, tfs = rig.R_f_s, rig.t_f_s
        uv, vis = cameras.project_world(cam0, R_kf, t_kf, Rfs[0], tfs[0], window.lmk)
        z = cameras.world_to_cam(R_kf, t_kf, Rfs[0], tfs[0], window.lmk)[:, 2]
        ok = vis & window.lmk_mask & (z > 0) & (z < cfg.max_lmk_depth)
        # one device-to-host copy feeds the host Delaunay
        pk = torch.cat([uv, ok[:, None].to(uv.dtype)], -1).cpu().numpy()
        tri_h, mask_h, n_total = delaunay_triangles(pk[:, :2], pk[:, 2] > 0.5, self.tri_cap)
        self.n_cut += max(n_total - self.tri_cap, 0)
        tri = torch.as_tensor(tri_h, device=dev)
        mask = torch.as_tensor(mask_h, device=dev)

        mask = filter_triangles(window.lmk, window.lmk_mask, tri, mask, cam0, R_kf, t_kf,
                                Rfs[0], tfs[0], cfg)
        _, t_ws = geo.pose_compose(R_kf, t_kf, Rfs[0], tfs[0])
        mask = normal_consistency(window.lmk, tri, mask, t_ws, cfg.normal_cos_tsh)
        mask = zncc_validate(images[0], images[1], window.lmk, tri, mask, cam0, cam1, R_kf, t_kf,
                             Rfs[0], tfs[0], Rfs[1], tfs[1], cfg.zncc_tsh, cfg.patch_half)
        self.tri, self.tri_mask = tri, mask

        if make_cloud:
            H, W = images.shape[-2:]
            self.cloud.append(raycast_pointcloud(
                window.lmk, tri, mask, cam0, R_kf, t_kf, Rfs[0], tfs[0], stride=cfg.ray_stride,
                height=int(H), width=int(W), min_depth=cfg.min_ray_depth,
                max_depth=cfg.max_ray_depth))
        return tri, mask

    def dense_points(self):
        """Concatenated world-frame cloud across keyframes (host numpy)."""
        if not self.cloud:
            return np.zeros((0, 3), np.float32)
        return torch.cat([pts[valid] for pts, valid in self.cloud]).cpu().numpy()
