"""Line-segment features: detection, matching, triangulation, reprojection.

Port of ``sadvio_tpu/frontend/lines.py``.  Detection replaces sequential
edge drawing with fixed-shape stages: Sobel gradients, a Hough vote of
every edge pixel into a (theta, rho) accumulator, 3x3 NMS and top-K peaks,
a two-pass weighted total-least-squares refit of each peak's supporting
pixels, and a continuity trim that keeps the longest run of gradient
support along each segment.

The Hough vote is a scatter-add.  Float atomics on the card add in no fixed
order, and a different sum can flip an NMS plateau, so each vote is
quantized to a 2^-32 fixed point and summed in int64: the accumulator is
the same on every call and on every device, within 1e-5 of the float sum.
Peaks are taken with a stable descending sort, so equal bins go in index
order, as ``jax.lax.top_k`` takes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sadvio_tpu_torch.frontend.detect import topk_stable
from sadvio_tpu_torch.models import cameras

_VOTE_SCALE = 2.0 ** 32  # fixed-point step of one Hough vote


def _sobel(img):
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device) / 4.0
    conv = lambda k: F.conv2d(img[None, None], k[None, None], padding=1)[0, 0]
    return conv(kx), conv(kx.T.contiguous())


def _hough_votes(flat, weight, n_bins):
    """Deterministic scatter-add of float32 votes into n_bins bins."""
    q = torch.round(weight.double() * _VOTE_SCALE).long()
    acc = torch.zeros(n_bins, dtype=torch.int64, device=flat.device).index_add_(0, flat, q)
    return (acc.double() / _VOTE_SCALE).to(weight.dtype)


def _angle_diff(a, b):
    """|a - b| folded into [0, pi/2] for undirected angles (floor-mod)."""
    return torch.abs(torch.remainder((a - b) + math.pi / 2, math.pi) - math.pi / 2)


def detect_lines(img, *, n_lines: int = 32, grad_tsh: float = 12.0, n_theta: int = 90,
                 n_rho: int = 120, band_px: float = 2.0, min_len: float = 16.0,
                 min_support: int = 12):
    """Line segments from one image: endpoints (n_lines,2,2) [(u,v) x 2],
    strength (n_lines,), valid (n_lines,)."""
    H, W = img.shape
    dev, dt = img.device, img.dtype
    gx, gy = _sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    edge = mag > grad_tsh
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev), indexing="ij")
    # gradient direction = line normal, theta in [0, pi)
    theta_pix = torch.remainder(torch.atan2(gy, gx), math.pi)
    t_idx = torch.clamp((theta_pix / math.pi * n_theta).to(torch.int64), 0, n_theta - 1)
    thetas = (torch.arange(n_theta, dtype=dt, device=dev) + 0.5) * (math.pi / n_theta)
    rho_max = math.sqrt(float(H * H + W * W))
    rho_pix = xs * torch.cos(theta_pix) + ys * torch.sin(theta_pix)
    r_idx = torch.clamp(((rho_pix / rho_max + 1.0) * 0.5 * n_rho).to(torch.int64), 0, n_rho - 1)

    zero = torch.zeros_like(mag)
    flat = torch.where(edge, t_idx * n_rho + r_idx, torch.zeros_like(t_idx))
    acc = _hough_votes(flat.reshape(-1), torch.where(edge, mag, zero).reshape(-1),
                       n_theta * n_rho).reshape(n_theta, n_rho)
    m = F.max_pool2d(acc[None, None], 3, stride=1, padding=1)[0, 0]
    acc_n = torch.where(acc >= m, acc, torch.zeros_like(acc))
    strength, idx = topk_stable(acc_n.reshape(-1), n_lines)
    theta_l = thetas[idx // n_rho]
    rho_l = (((idx % n_rho).to(dt) + 0.5) / n_rho * 2.0 - 1.0) * rho_max

    # support: edge pixels within the band, gradient normal near the line's
    n_dir = torch.stack([torch.cos(theta_l), torch.sin(theta_l)], -1)
    p = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)  # (P,2)
    w_pix = torch.where(edge, mag, zero).reshape(-1)
    dist = torch.abs(p @ n_dir.T - rho_l[None, :])  # (P,K)
    dtheta = _angle_diff(theta_pix.reshape(-1)[:, None], theta_l[None, :])
    orient = (w_pix[:, None] > 0) & (dtheta < math.pi / 12)
    on = (dist < band_px) & orient
    sup = on.sum(0)

    def tls_fit(sel):
        wk = torch.where(sel, w_pix[:, None], torch.zeros_like(dist))
        Ws = torch.clamp(wk.sum(0), min=1e-6)
        mu = (wk.T @ p) / Ws[:, None]
        dp_x = p[:, 0][:, None] - mu[None, :, 0]
        dp_y = p[:, 1][:, None] - mu[None, :, 1]
        cxx = (wk * dp_x * dp_x).sum(0) / Ws
        cxy = (wk * dp_x * dp_y).sum(0) / Ws
        cyy = (wk * dp_y * dp_y).sum(0) / Ws
        ang = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
        return mu, torch.stack([torch.cos(ang), torch.sin(ang)], -1), dp_x, dp_y

    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    mu, d_dir, dp_x, dp_y = tls_fit(on)
    # re-select wide, then tighten, to centre on ridges whose support is two
    # parallel gradient stripes
    for band in (3.0 * band_px, 2.0 * band_px, 1.5 * band_px):
        perp = torch.abs(-dp_x * d_dir[None, :, 1] + dp_y * d_dir[None, :, 0])
        along = dp_x * d_dir[None, :, 0] + dp_y * d_dir[None, :, 1]
        in_seg = ((along > torch.where(on, along, inf).amin(0) - 2.0)
                  & (along < torch.where(on, along, -inf).amax(0) + 2.0))
        on = (perp < band) & orient & in_seg
        mu, d_dir, dp_x, dp_y = tls_fit(on)

    s = dp_x * d_dir[None, :, 0] + dp_y * d_dir[None, :, 1]
    s_min = torch.where(on, s, inf).amin(0)
    s_max = torch.where(on, s, -inf).amax(0)
    e0 = mu + d_dir * s_min[:, None]
    e1 = mu + d_dir * s_max[:, None]
    length = s_max - s_min

    # continuity trim: |grad| sampled 1.5 px either side of the centreline
    # at T stations; keep the longest contiguous supported run
    T = 48
    tt = torch.linspace(0.0, 1.0, T, dtype=dt, device=dev)
    n_hat = torch.stack([-d_dir[:, 1], d_dir[:, 0]], -1)
    seg = e0[:, None, :] + (e1 - e0)[:, None, :] * tt[None, :, None]  # (K,T,2)

    def sample_mag(pxy):
        x = torch.clamp(pxy[..., 0], 0.0, W - 1.001)
        y = torch.clamp(pxy[..., 1], 0.0, H - 1.001)
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        fx, fy = x - x0, y - y0
        return ((1 - fy) * ((1 - fx) * mag[y0, x0] + fx * mag[y0, x0 + 1])
                + fy * ((1 - fx) * mag[y0 + 1, x0] + fx * mag[y0 + 1, x0 + 1]))

    gm = torch.maximum(sample_mag(seg + 1.5 * n_hat[:, None, :]),
                       sample_mag(seg - 1.5 * n_hat[:, None, :]))
    ok_t = (gm > 0.75 * grad_tsh).to(dt)
    run = torch.zeros(ok_t.shape[0], dtype=dt, device=dev)
    runs = []
    for t_i in range(T):
        run = (run + 1.0) * ok_t[:, t_i]
        runs.append(run)
    runs = torch.stack(runs, 1)  # run length ending at each station
    r_len = runs.amax(1)
    t_end = torch.argmax(runs, 1).to(dt)  # the longest run's end (first if tied)
    t_start = t_end - (r_len - 1.0)
    step = 1.0 / (T - 1)
    f0 = torch.clamp((t_start - 0.5) * step, 0.0, 1.0)
    f1 = torch.clamp((t_end + 0.5) * step, 0.0, 1.0)
    d_e = e1 - e0
    e0t = e0 + d_e * f0[:, None]
    e1t = e0 + d_e * f1[:, None]
    length_t = length * (f1 - f0)
    valid = ((strength > 0) & (sup >= min_support) & torch.isfinite(length_t)
             & (length_t > min_len) & (r_len >= 3))
    return torch.stack([e0t, e1t], 1), strength, valid


def _seg_props(ends):
    mid = ends.mean(1)
    d = ends[:, 1] - ends[:, 0]
    ang = torch.remainder(torch.atan2(d[..., 1], d[..., 0]), math.pi)
    return mid, torch.linalg.norm(d, dim=-1), ang, d


def match_lines(ends_a, valid_a, ends_b, valid_b, *, max_midpoint_px=40.0, max_angle_deg=8.0,
                min_overlap=0.4):
    """Midpoint + angle + overlap matching with mutual best.  Returns (idx
    (Ka,) int64 into b or -1, score)."""
    mid_a, len_a, ang_a, d_a = _seg_props(ends_a)
    mid_b, len_b, ang_b, _ = _seg_props(ends_b)
    dmid = torch.linalg.norm(mid_a[:, None] - mid_b[None, :], dim=-1)
    dang = _angle_diff(ang_a[:, None], ang_b[None, :])
    ta = d_a / torch.clamp(len_a, min=1e-6)[:, None]
    rel = ends_b[None, :, :, :] - mid_a[:, None, None, :]  # (Ka,Kb,2,2)
    s0 = torch.einsum("ai,abji->abj", ta, rel)
    lo = torch.minimum(s0[..., 0], s0[..., 1])
    hi = torch.maximum(s0[..., 0], s0[..., 1])
    half = 0.5 * len_a[:, None]
    ov = torch.clamp(torch.minimum(hi, half) - torch.maximum(lo, -half), min=0.0)
    ov_frac = ov / torch.clamp(torch.minimum(len_a[:, None], len_b[None, :]), min=1e-6)
    okm = ((dmid < max_midpoint_px) & (dang < math.radians(max_angle_deg))
           & (ov_frac > min_overlap) & valid_a[:, None] & valid_b[None, :])
    score = torch.where(okm, dmid + 20.0 * dang, torch.full_like(dmid, float("inf")))
    best = torch.argmin(score, 1)
    best_s = score.amin(1)
    best_b = torch.argmin(score, 0)
    mutual = best_b[best] == torch.arange(score.shape[0], device=score.device)
    ok = mutual & torch.isfinite(best_s) & valid_a
    return torch.where(ok, best, torch.full_like(best, -1)), best_s


def dedup_lines(ends, valid, strength, *, max_angle_deg=4.0, max_perp_px=4.0):
    """Drop a detection when a stronger one has nearly the same infinite
    line (angle + midpoint-perpendicular gates).  Returns the valid mask."""
    mid, ln, ang, d = _seg_props(ends)
    t_hat = d / torch.clamp(ln, min=1e-6)[:, None]
    dang = _angle_diff(ang[:, None], ang[None, :])
    rel = mid[None, :, :] - mid[:, None, :]  # (i,j): mid_j - mid_i
    perp = torch.abs(rel[..., 0] * (-t_hat[:, None, 1]) + rel[..., 1] * t_hat[:, None, 0])
    same = (dang < math.radians(max_angle_deg)) & (perp < max_perp_px)
    ar = torch.arange(ends.shape[0], device=ends.device)
    stronger = (strength[None, :] > strength[:, None]) | (
        (strength[None, :] == strength[:, None]) & (ar[None, :] < ar[:, None]))
    return valid & ~(same & stronger & valid[None, :]).any(1)


def clip_segment_to_image(a, b, width, height):
    """Liang-Barsky clip of segments a->b to [0,width-1]x[0,height-1].
    Returns (a_c, b_c, ok): clipped endpoints, any part inside."""
    d = b - a
    t0 = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    t1 = torch.ones_like(t0)
    zero, one = torch.zeros_like(t0), torch.ones_like(t0)
    for i, hi_v in ((0, width - 1.0), (1, height - 1.0)):
        di, ai = d[..., i], a[..., i]
        par = torch.abs(di) < 1e-9
        safe = torch.where(par, torch.full_like(di, 1e-9), di)
        t_lo = (0.0 - ai) / safe
        t_hi = (hi_v - ai) / safe
        inside = (ai >= 0.0) & (ai <= hi_v)
        tmin = torch.where(par, torch.where(inside, zero, one), torch.minimum(t_lo, t_hi))
        tmax = torch.where(par, torch.where(inside, one, zero), torch.maximum(t_lo, t_hi))
        t0 = torch.maximum(t0, tmin)
        t1 = torch.minimum(t1, tmax)
    return a + t0[..., None] * d, a + t1[..., None] * d, t1 > t0


def triangulate_line(cam_a, cam_b, R_ws_a, t_ws_a, R_ws_b, t_ws_b, ends_a, ends_b,
                     cond_min: float = 0.2):
    """3D segment from two views by plane intersection: view b's endpoint
    rays meet the plane of view a's endpoint rays.  ends_*: (...,2,2) px.
    ``cond_min`` gates |baseline_hat . plane_normal| (epipolar degeneracy).
    Returns (p0_w, p1_w, ok), in view a's endpoint order."""
    ra_w = torch.einsum("ij,...kj->...ki", R_ws_a, cam_a.backproject(ends_a))
    n_plane = torch.linalg.cross(ra_w[..., 0, :], ra_w[..., 1, :], dim=-1)
    nn = torch.linalg.norm(n_plane, dim=-1, keepdim=True)
    n_plane = n_plane / torch.clamp(nn, min=1e-12)
    rb_w = torch.einsum("ij,...kj->...ki", R_ws_b, cam_b.backproject(ends_b))
    denom = torch.einsum("...ki,...i->...k", rb_w, n_plane)
    num = torch.einsum("...i,...i->...", t_ws_a - t_ws_b, n_plane)[..., None]
    s = num / torch.where(torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
    pts = t_ws_b[..., None, :] + rb_w * s[..., None]
    base = t_ws_a - t_ws_b
    b_hat = base / torch.clamp(torch.linalg.norm(base, dim=-1)[..., None], min=1e-9)
    cond = torch.abs(torch.einsum("...i,...i->...", b_hat, n_plane))
    ok = ((torch.abs(denom) > 1e-4).all(-1) & (s > 0.05).all(-1) & (nn[..., 0] > 1e-6)
          & (cond >= cond_min))
    return pts[..., 0, :], pts[..., 1, :], ok


def line_reproj_residual(model, R_w_f, t_w_f, R_f_s, t_f_s, p0_w, p1_w, ends_obs,
                         sigma_px=1.0, w_along=0.3):
    """4-dim line reprojection residual: signed distances of both projected
    endpoints to the observed infinite line, plus along-line endpoint terms
    at ``w_along`` (the lower-s projected endpoint matches observed end a).
    Validity is cheirality only.  Returns (r (...,4), valid)."""
    uv0, _ = cameras.project_world(model, R_w_f, t_w_f, R_f_s, t_f_s, p0_w)
    uv1, _ = cameras.project_world(model, R_w_f, t_w_f, R_f_s, t_f_s, p1_w)
    v0 = cameras.world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p0_w)[..., 2] > 0.05
    v1 = cameras.world_to_cam(R_w_f, t_w_f, R_f_s, t_f_s, p1_w)[..., 2] > 0.05
    a, b = ends_obs[..., 0, :], ends_obs[..., 1, :]
    d = b - a
    length = torch.linalg.norm(d, dim=-1, keepdim=True)
    t_hat = d / torch.clamp(length, min=1e-6)
    n_hat = torch.stack([-t_hat[..., 1], t_hat[..., 0]], -1)

    def comps(uv):
        rel = uv - a
        return (rel * n_hat).sum(-1), (rel * t_hat).sum(-1)

    p0, s0 = comps(uv0)
    p1, s1 = comps(uv1)
    swap = s0 > s1
    s_lo = torch.where(swap, s1, s0)
    s_hi = torch.where(swap, s0, s1)
    r = torch.stack([p0, p1, w_along * s_lo, w_along * (s_hi - length[..., 0])], -1) / sigma_px
    return r, v0 & v1
