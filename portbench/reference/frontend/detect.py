"""Batched feature detection: corner scores + grid-bucketed top-k.

Port of ``sadvio_tpu/frontend/detect.py``: the whole image is scored in one
pass, a 3x3 non-max suppression keeps local maxima, existing features
suppress a radius around themselves, and a reshape to grid cells + per-cell
top-k does the bucketing with fixed-size outputs.
"""

from __future__ import annotations

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
    arcs = (torch.arange(16, device=img.device)[:, None]
            + torch.arange(arc, device=img.device)[None, :]) % 16
    gathered = diffs[arcs]  # (16,arc,H,W)
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


def topk_stable(x, k: int):
    """The k largest entries along the last dim, equal values in index
    order (the order of ``jax.lax.top_k``, on every device)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(score, allow, gh: int, gw: int, k_per_cell: int, margin: int = 8):
    """Top k_per_cell per (gh,gw) cell; returns uv (N,2), s (N,), valid (N,).

    Ties resolve to the lower in-cell index, as ``jax.lax.top_k`` does."""
    H, W = score.shape
    ch, cw = H // gh, W // gw
    ys = torch.arange(H, device=score.device)[:, None]
    xs = torch.arange(W, device=score.device)[None, :]
    border = (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)
    s = torch.where(allow & border, score, torch.zeros_like(score))
    s = s[: gh * ch, : gw * cw].reshape(gh, ch, gw, cw).permute(0, 2, 1, 3)
    s = s.reshape(gh * gw, ch * cw)
    top, idx = topk_stable(s, k_per_cell)
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
