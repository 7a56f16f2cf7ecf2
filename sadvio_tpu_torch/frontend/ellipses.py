"""Coded-ellipse fiducial markers: detection, decoding, pattern grouping, pose.

Port of ``sadvio_tpu/frontend/ellipses.py``.  Fixed-shape stages: a
Bernsen local threshold to a dark-blob mask; connected components by 3x3
max-propagation to a fixed point; per-blob moments by one scatter-add and
the ellipse in closed form from the second-moment eigensystem, gated on
ellipticity; the code ring read by bilinear samples on the affine
circle-to-ellipse map; decoding by circular correlation against the sync
word and a majority vote per slot; 4-marker pattern grouping by predicted
corner positions; planar pose from the homography of the grouped corners.

Marker code: the ring holds 16 slots x 8 samples, slots 0..7 the sync word
"10110010", slots 8..15 the payload (MSB first); the ID is 6400 + payload.

Determinism: blob moments are integer-valued sums, accumulated exactly in
float64 whatever the order of the scatter; blob and pattern slots are
chosen with a stable descending sort, so equal areas go in label order,
as ``jax.lax.top_k`` takes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sadvio_tpu_torch.frontend.detect import bilinear_sample, topk_stable

SYNC_WORD = (1, 0, 1, 1, 0, 0, 1, 0)
N_RING = 128  # samples around the code ring
N_SLOTS = 16  # code slots (sync 8 + payload 8)
RADIUS_RATIO = 1.68  # code ring radius / semi-major axis
WHITE_RATIO = 1.15  # white reference ring
BLACK_RATIO = 0.75  # black reference ring
ID_BASE = 6400


def _max_pool(img, k):
    """k x k max over a SAME window (padding counts as -inf)."""
    return F.max_pool2d(img[None, None], k, stride=1, padding=k // 2)[0, 0]


def binarize_dark(img, *, block: int = 31, contrast_tsh: float = 25.0):
    """Dark-blob mask: darker than the local (min+max)/2 where the local
    contrast is high, else darker than the global midrange."""
    lmin = -_max_pool(-img, block)
    lmax = _max_pool(img, block)
    global_t = 0.5 * (img.amin() + img.amax())
    t = torch.where(lmax - lmin > contrast_tsh, 0.5 * (lmin + lmax), global_t)
    return img < t


def connected_components(fg, *, max_iters: int = 512, return_steps: bool = False):
    """8-connected labels (H,W) int64, 0 = background: each foreground pixel
    starts as its linear index + 1 and a 3x3 max pool propagates the
    component maximum until nothing changes or ``max_iters`` steps have
    run.  The labels are held in float32, exact up to 2^24 pixels.  With
    ``return_steps`` also the number of pool steps taken (one host read of
    the convergence flag per step)."""
    H, W = fg.shape
    seed = torch.arange(1, H * W + 1, dtype=torch.float32, device=fg.device).reshape(H, W)
    zero = torch.zeros_like(seed)
    lab = torch.where(fg, seed, zero)
    steps = 0
    while steps < max_iters:
        nxt = torch.where(fg, _max_pool(lab, 3), zero)
        steps += 1
        changed = bool((nxt != lab).any())
        lab = nxt
        if not changed:
            break
    lab = lab.long()
    return (lab, steps) if return_steps else lab


def blob_ellipses(labels, *, n_blobs: int = 32, min_area: int = 10, max_area: int = 20000):
    """Ellipse of each of the n_blobs largest components: center (K,2),
    axes (K,2) [a >= b], theta (K,), area (K,), valid (K,) (area and
    ellipticity gates)."""
    H, W = labels.shape
    dev = labels.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)
    vals = torch.stack([torch.ones_like(x), x, y, x * x, x * y, y * y], -1)
    sums = torch.zeros((H * W + 1, 6), dtype=torch.float64, device=dev).index_add_(
        0, labels.reshape(-1), vals).float()
    count = sums[:, 0].clone()
    count[0] = 0.0  # background
    _, lab_ids = topk_stable(count, n_blobs)
    m = sums[lab_ids]
    n = torch.clamp(m[:, 0], min=1.0)
    cx, cy = m[:, 1] / n, m[:, 2] / n
    mxx = m[:, 3] / n - cx * cx
    mxy = m[:, 4] / n - cx * cy
    myy = m[:, 5] / n - cy * cy
    tr = 0.5 * (mxx + myy)
    d = torch.sqrt(torch.clamp((0.5 * (mxx - myy)) ** 2 + mxy * mxy, min=0.0))
    # a filled ellipse's second moment along an axis is (semi-axis)^2 / 4
    a = 2.0 * torch.sqrt(torch.clamp(tr + d, min=1e-12))
    b = 2.0 * torch.sqrt(torch.clamp(tr - d, min=1e-12))
    theta = 0.5 * torch.atan2(2.0 * mxy, mxx - myy)
    area = m[:, 0]
    ellipticity = math.pi * a * b / torch.clamp(area, min=1.0)
    valid = ((area >= min_area) & (area <= max_area) & (ellipticity > 0.95)
             & (ellipticity < 1.05))
    return torch.stack([cx, cy], -1), torch.stack([a, b], -1), theta, area, valid


def _ring_points(center, axes, theta, ratio):
    """(K, N_RING, 2) points on the scaled ellipse, phi running 2pi -> 0."""
    phi = (2.0 * math.pi + torch.arange(N_RING, dtype=torch.float32, device=center.device)
           * np.float32(-2.0 * math.pi / N_RING))
    ex = ratio * axes[:, 0:1] * torch.cos(phi)[None, :]
    ey = ratio * axes[:, 1:2] * torch.sin(phi)[None, :]
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    return torch.stack([center[:, 0:1] + ct * ex - st * ey,
                        center[:, 1:2] + st * ex + ct * ey], -1)


def read_codes(img, center, axes, theta):
    """Ring codes (K, N_RING) as float (black = 1) and a contrast flag from
    the white and black reference rings."""
    ring = bilinear_sample(img, _ring_points(center, axes, theta, RADIUS_RATIO))
    white = bilinear_sample(img, _ring_points(center, axes, theta, WHITE_RATIO)).mean(-1)
    black = bilinear_sample(img, _ring_points(center, axes, theta, BLACK_RATIO)).mean(-1)
    code = ring < (0.5 * (white + black))[:, None]
    return code.float(), white - black > 10.0


def decode_codes(codes):
    """(K, N_RING) rings -> id (K,), orientation (K,), sync ok (K,)."""
    per = N_RING // N_SLOTS
    dev = codes.device
    sync = torch.tensor(SYNC_WORD, dtype=torch.float32, device=dev)
    ext = sync.repeat_interleave(per)
    ar = torch.arange(N_RING, device=dev)
    idx = (ar[:, None] + torch.arange(ext.shape[0], device=dev)[None, :]) % N_RING
    score = ((codes[:, idx] - ext[None, None, :]) ** 2).sum(-1)  # (K,128)
    offset = torch.argmin(score, -1)  # first best shift
    orientation = offset.float() / N_RING * 2.0 * math.pi
    aligned = torch.gather(codes, 1, (offset[:, None] + ar[None, :]) % N_RING)
    slots = aligned.reshape(-1, N_SLOTS, per).mean(-1) > 0.5
    sync_ok = (slots[:, :8] == (sync > 0.5)[None, :]).all(-1)
    weights = 2 ** torch.arange(7, -1, -1, device=dev)
    payload = (slots[:, 8:].long() * weights[None, :]).sum(-1)
    return ID_BASE + payload, orientation, sync_ok


def detect_coded_ellipses(img, *, n_blobs: int = 32):
    """Marker detection into fixed slots: {center (K,2), axes (K,2), theta
    (K,) [ellipse angle - ring offset - pi/2], id (K,), valid (K,)}."""
    labels = connected_components(binarize_dark(img))
    center, axes, theta, _, valid = blob_ellipses(labels, n_blobs=n_blobs)
    codes, contrast_ok = read_codes(img, center, axes, theta)
    ids, ring_orient, sync_ok = decode_codes(codes)
    return {"center": center, "axes": axes, "theta": theta - ring_orient - 0.5 * math.pi,
            "id": ids, "valid": valid & sync_ok & contrast_ok}


def group_patterns_4(det, *, max_patterns: int = 8, scale: float = 4.0):
    """Group markers into 4-marker patterns: 6401 anchors, 6402 is predicted
    at +y' (orientation + pi/2), 6403 at +x', the ID marker at the diagonal,
    all at scale*a.  Returns corner centres (P,4,2) in the order
    [E1,E2,E3,EN], pattern id (P,), valid (P,)."""
    c, a = det["center"], det["axes"][:, 0]
    th, ids, valid = det["theta"], det["id"], det["valid"]
    off_y = torch.stack([scale * a * torch.cos(-th + math.pi / 2),
                         -scale * a * torch.sin(-th + math.pi / 2)], -1)
    off_x = torch.stack([scale * a * torch.cos(-th), -scale * a * torch.sin(-th)], -1)
    tol = scale * a

    def best(pred_c, want_id=None):
        d = torch.linalg.norm(c[None, :, :] - pred_c[:, None, :], dim=-1)  # (anchor, cand)
        ok = valid[None, :] & (d < tol[:, None])
        if want_id is not None:
            ok = ok & (ids[None, :] == want_id)
        else:
            ok = (ok & (ids[None, :] >= ID_BASE) & (ids[None, :] != ID_BASE + 1)
                  & (ids[None, :] != ID_BASE + 2) & (ids[None, :] != ID_BASE + 3))
        d = torch.where(ok, d, torch.full_like(d, float("inf")))
        return torch.argmin(d, -1), torch.isfinite(d.amin(-1))

    j2, f2 = best(c + off_y, ID_BASE + 2)
    j3, f3 = best(c + off_x, ID_BASE + 3)
    jn, fn = best(c + off_x + off_y)
    anchor_ok = valid & (ids == ID_BASE + 1) & f2 & f3 & fn
    _, sel = topk_stable(torch.where(anchor_ok, a, torch.full_like(a, -1.0)), max_patterns)
    uv = torch.stack([c[sel], c[j2[sel]], c[j3[sel]], c[jn[sel]]], 1)
    return uv, ids[jn[sel]] - ID_BASE, anchor_ok[sel]


def match_patterns(ids_a, valid_a, ids_b, valid_b):
    """Match patterns by decoded ID: idx_b (P,) (first equal), ok (P,)."""
    eq = (ids_a[:, None] == ids_b[None, :]) & valid_a[:, None] & valid_b[None, :]
    return torch.argmax(eq.to(torch.uint8), -1), eq.any(-1)


# ModelEllipsePattern3D vertices, scaled by the pattern side; the order of
# group_patterns_4's corners
MODEL_CORNERS = np.asarray([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]], np.float32)


def _homography_dlt(xy, uv):
    """H (...,3,3) mapping plane coords xy (4,2) to pixels uv (...,4,2) by
    DLT (the SVD null vector, any sign)."""
    x = xy[:, 0].expand(uv.shape[:-1])
    y = xy[:, 1].expand(uv.shape[:-1])
    u, v = uv[..., 0], uv[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.stack([r1, r2], -2).reshape(*uv.shape[:-2], 8, 9)
    _, _, vt = torch.linalg.svd(torch.nan_to_num(A))
    return vt[..., -1, :].reshape(*uv.shape[:-2], 3, 3)


def pattern_pose(K, uv4, side: float = 1.0):
    """Planar pose (R_c_p, t_c_p) of patterns from their 4 corner pixels
    uv4 (...,4,2): K^-1 H has columns [r1, r2, t] up to scale (sign chosen
    so t_z > 0), R the nearest rotation by SVD.  The two small SVDs run in
    float64: in float32 the DLT's pixel-scale rows cost 1e-3 rad."""
    dtype = uv4.dtype
    K, uv4 = K.double(), uv4.double()
    xy = torch.as_tensor(MODEL_CORNERS, dtype=torch.float64, device=uv4.device) * side
    Hn = torch.linalg.solve(K, _homography_dlt(xy, uv4))
    s = 0.5 * (torch.linalg.norm(Hn[..., :, 0], dim=-1) + torch.linalg.norm(Hn[..., :, 1], dim=-1))
    s = torch.where(Hn[..., 2, 2] < 0, -s, s)
    Hn = Hn / torch.where(torch.abs(s) < 1e-12, torch.full_like(s, 1e-12), s)[..., None, None]
    r1, r2, t = Hn[..., :, 0], Hn[..., :, 1], Hn[..., :, 2]
    R0 = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], -1)
    u, _, vt = torch.linalg.svd(torch.nan_to_num(R0))
    d = torch.sign(torch.linalg.det(u @ vt))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    return ((u * flip[..., None, :]) @ vt).to(dtype), t.to(dtype)
