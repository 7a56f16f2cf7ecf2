"""Batched feature detection: corner scores + grid-bucketed top-k.

Port of ``sadvio_tpu/frontend/detect.py``: the whole image is scored in one
pass, a 3x3 non-max suppression keeps local maxima, existing features
suppress a radius around themselves, and a reshape to grid cells + per-cell
top-k does the bucketing with fixed-size outputs.  ``brief_describe`` gives
each feature a 256-bit BRIEF descriptor, held as a (N,256) bool tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _shift2d(img, dy: int, dx: int):
    """out[y, x] = img[y - dy, x - dx] with zero fill (static offsets)."""
    H, W = img.shape
    out = torch.zeros_like(img)
    ys0, ys1 = max(dy, 0), H + min(dy, 0)
    xs0, xs1 = max(dx, 0), W + min(dx, 0)
    out[ys0:ys1, xs0:xs1] = img[ys0 - dy: ys1 - dy, xs0 - dx: xs1 - dx]
    return out


# FAST 16-pixel Bresenham circle of radius 3
_FAST_CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def fast_score(img, thresh: float = 10.0, arc: int = 9):
    """FAST-N corner score: max over arc starts of the min contiguous arc
    response, for bright and dark arcs.  img: (H,W) float."""
    diffs = torch.stack([_shift2d(img, dy, dx) - img for (dx, dy) in _FAST_CIRCLE])
    arcs = np.asarray([[(s + i) % 16 for i in range(arc)] for s in range(16)])
    gathered = diffs[torch.as_tensor(arcs, device=img.device)]  # (16,arc,H,W)
    bright = gathered.amin(1)
    dark = (-gathered).amin(1)
    score = torch.maximum(bright.amax(0), dark.amax(0))
    return torch.where(score > thresh, score, torch.zeros_like(score))


def shi_tomasi_score(img, window: int = 3):
    """Min-eigenvalue corner score."""
    gx = 0.5 * (_shift2d(img, 0, 1) - _shift2d(img, 0, -1))
    gy = 0.5 * (_shift2d(img, 1, 0) - _shift2d(img, -1, 0))
    k = torch.ones((1, 1, window, window), dtype=img.dtype, device=img.device) / (window * window)
    box = lambda x: F.conv2d(x[None, None], k, padding=window // 2)[0, 0]
    gxx, gyy, gxy = box(gx * gx), box(gy * gy), box(gx * gy)
    tr = 0.5 * (gxx + gyy)
    det = torch.sqrt(torch.clamp((0.5 * (gxx - gyy)) ** 2 + gxy * gxy, min=0.0))
    return torch.clamp(tr - det, min=0.0)


def _nms3(score):
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def occupancy_mask(H, W, uv, valid, radius: int = 5):
    """False inside `radius` (chebyshev) of an existing feature."""
    ui = torch.clamp(torch.round(uv[..., 0]).long(), 0, W - 1)
    vi = torch.clamp(torch.round(uv[..., 1]).long(), 0, H - 1)
    occ = torch.zeros(H * W, dtype=torch.float32, device=uv.device)
    occ = occ.scatter_reduce(0, vi * W + ui, valid.float(), reduce="amax")
    k = 2 * radius + 1
    occ = F.max_pool2d(occ.view(1, 1, H, W), k, stride=1, padding=radius)[0, 0]
    return occ < 0.5


def grid_topk(score, allow, gh: int, gw: int, k_per_cell: int, margin: int = 8):
    """Top k_per_cell per (gh,gw) cell; returns uv (N,2), s (N,), valid (N,).

    Ties resolve to the lower in-cell index, as ``jax.lax.top_k`` does."""
    H, W = score.shape
    ch, cw = H // gh, W // gw
    border = torch.zeros_like(score, dtype=torch.bool)
    border[margin: H - margin, margin: W - margin] = True
    s = torch.where(allow & border, score, torch.zeros_like(score))
    s = s[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw).permute(0, 2, 1, 3)
    s = s.reshape(gh * gw, ch * cw)
    top, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_per_cell], idx[:, :k_per_cell]
    cy = idx // cw
    cx = idx % cw
    cell = torch.arange(gh * gw, device=score.device)[:, None]
    u = ((cell % gw) * cw + cx).float().reshape(-1)
    v = ((cell // gw) * ch + cy).float().reshape(-1)
    return torch.stack([u, v], -1), top.reshape(-1), (top > 0.0).reshape(-1)


def detect_features(img, existing_uv=None, existing_valid=None, *,
                    kind: str = "fast", gh: int = 8, gw: int = 12,
                    k_per_cell: int = 5, thresh: float = 10.0, radius: int = 5):
    """Detection on one image -> fixed-capacity feature slots."""
    H, W = img.shape
    score = fast_score(img, thresh) if kind == "fast" else shi_tomasi_score(img)
    score = _nms3(score)
    if existing_uv is not None:
        allow = occupancy_mask(H, W, existing_uv, existing_valid, radius)
    else:
        allow = torch.ones((H, W), dtype=torch.bool, device=img.device)
    return grid_topk(score, allow, gh, gw, k_per_cell)


def bilinear_sample(img, uv):
    """Bilinear interpolation. uv: (...,2) in (u=x, v=y) pixel coords."""
    H, W = img.shape
    u = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    du = u - u0
    dv = v - v0
    flat = img.reshape(-1)
    at = lambda r, c: flat[r * W + c]
    return (at(v0, u0) * (1 - du) * (1 - dv) + at(v0, u0 + 1) * du * (1 - dv)
            + at(v0 + 1, u0) * (1 - du) * dv + at(v0 + 1, u0 + 1) * du * dv)


def window_sample(img, centers, pts, ws: int):
    """Bilinear-sample pts (N,S,2) inside one (ws,ws) window per row.

    Returns (values (N,S), inwin (N,S)).  The window's base is
    floor(center) - ws // 2, clipped so the window lies in the image; a
    point outside its window is sampled at the clamped cell (with its own
    fractional part) and flagged False.  The values and flags are those of
    the JAX package's window sampler; the taps are plain gathers."""
    H, W = img.shape
    ws = min(ws, H, W)
    c = torch.nan_to_num(centers, nan=0.0, posinf=0.0, neginf=0.0)
    hi = torch.tensor([W - ws, H - ws], dtype=c.dtype, device=c.device)
    base = torch.minimum(torch.clamp(torch.floor(c) - (ws // 2), min=0.0), hi)
    loc = pts - base[:, None, :]
    fl = torch.floor(loc)
    fx, fy = loc[..., 0] - fl[..., 0], loc[..., 1] - fl[..., 1]
    # non-finite points: flagged out, sampled at cell 0
    fl = torch.nan_to_num(fl, nan=-1.0, posinf=-1.0, neginf=-1.0)
    ix, iy = fl[..., 0].long(), fl[..., 1].long()
    inwin = (ix >= 0) & (ix <= ws - 2) & (iy >= 0) & (iy <= ws - 2)
    bx, by = base[:, None, 0].long(), base[:, None, 1].long()
    ix = torch.clamp(ix, 0, ws - 2) + bx
    iy = torch.clamp(iy, 0, ws - 2) + by
    flat = img.reshape(-1)
    at = lambda r, col: flat[r * W + col]
    vals = ((at(iy, ix) * (1 - fx) + at(iy, ix + 1) * fx) * (1 - fy)
            + (at(iy + 1, ix) * (1 - fx) + at(iy + 1, ix + 1) * fx) * fy)
    return vals, inwin


def _brief_offsets(n_bits: int = 256, patch: int = 24, seed: int = 7):
    """Static random sampling-pair table (2, n_bits, 2): [pair, bit, (dx,dy)].
    Drawn as the JAX package draws it, so both hold the same pairs."""
    r = np.random.default_rng(seed)
    pts = r.normal(0.0, patch / 5.0, size=(2, n_bits, 2)).clip(-patch / 2, patch / 2)
    return pts.astype(np.float32)


_BRIEF = _brief_offsets()
DESC_BITS = _BRIEF.shape[1]


def brief_describe(img_smooth, uv):
    """256-bit BRIEF descriptors (N,256) bool: bit b is set where the first
    point of pair b is brighter than the second on the smoothed image.  No
    rotation invariance (matching uses predicted search boxes)."""
    pairs = torch.as_tensor(_BRIEF, device=uv.device)
    pts = torch.cat([uv[:, None, :] + pairs[0][None], uv[:, None, :] + pairs[1][None]], 1)
    vals, _ = window_sample(img_smooth, uv, pts, ws=32)
    return vals[:, :DESC_BITS] > vals[:, DESC_BITS:]


def smooth3(img):
    """3x3 binomial blur."""
    k = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=img.dtype,
                     device=img.device) / 16.0
    return F.conv2d(img[None, None], k[None, None], padding=1)[0, 0]
