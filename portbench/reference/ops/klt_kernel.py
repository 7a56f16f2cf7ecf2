"""Frozen copy of the port's Lucas-Kanade tracking in its plain PyTorch form
(``ops/klt_kernel.py``: ``lk_iterate_ref``, ``lk_track_ref`` and the template
code around them).  The CUDA kernels are not copied: the reference tracks
with the plain version on any device.

Semantics: the patch corner is floor((u, v) - half) and every pixel of the
patch shares the fractional offset; bilinear taps read the image at
edge-clamped integer coordinates; a feature stops at `iters` or once its
step is at most `eps` pixels, and a NaN step stops it at once.
"""

from __future__ import annotations

import torch

def _patches(img1, u, v, S):
    """(N,S,S) bilinear patches centred at (u, v), taps edge-clamped."""
    H, W = img1.shape
    half = (S - 1) // 2
    r = torch.arange(S, device=img1.device)
    lx, ly = u - half, v - half
    flx, fly = torch.floor(lx), torch.floor(ly)
    fx, fy = (lx - flx)[:, None, None], (ly - fly)[:, None, None]
    ix = torch.nan_to_num(torch.clamp(flx, -1.0, float(W)), nan=0.0).long()
    iy = torch.nan_to_num(torch.clamp(fly, -1.0, float(H)), nan=0.0).long()
    c0 = torch.clamp(ix[:, None] + r, 0, W - 1)[:, None, :]
    c1 = torch.clamp(ix[:, None] + r + 1, 0, W - 1)[:, None, :]
    r0 = torch.clamp(iy[:, None] + r, 0, H - 1)[:, :, None] * W
    r1 = torch.clamp(iy[:, None] + r + 1, 0, H - 1)[:, :, None] * W
    flat = img1.reshape(-1)
    return (flat[r0 + c0] * (1 - fx) * (1 - fy) + flat[r0 + c1] * fx * (1 - fy)
            + flat[r1 + c0] * (1 - fx) * fy + flat[r1 + c1] * fx * fy)


def lk_iterate_ref(img1, uv_init, T, gx, gy, nrm, *, iters: int = 10, eps: float = 0.01):
    """Plain PyTorch version of the kernel: all features advance in lock
    step and a feature that has stopped is frozen (masked update)."""
    S = T.shape[1]
    u, v = uv_init[:, 0], uv_init[:, 1]
    a, b, c, inv_det = nrm.unbind(1)
    active = torch.ones_like(u, dtype=torch.bool)
    eps2 = eps * eps
    for _ in range(iters):
        e = _patches(img1, u, v, S) - T
        bx = (e * gx).sum((1, 2))
        by = (e * gy).sum((1, 2))
        du = (c * bx - b * by) * inv_det
        dv = (a * by - b * bx) * inv_det
        u = torch.where(active, u - du, u)
        v = torch.where(active, v - dv, v)
        active = active & (du * du + dv * dv > eps2)
    err = (_patches(img1, u, v, S) - T).abs().mean((1, 2))
    return torch.stack([u, v, err], 1)


# ----------------------------------------------------------------------
# the whole pyramidal track: lk_track (one launch) and its plain version
# ----------------------------------------------------------------------


def pyramid_dims(shape0, levels: int):
    """(H, W) of each pyramid level given the level-0 shape."""
    dims = [tuple(shape0)]
    for _ in range(levels - 1):
        h, w = dims[-1]
        dims.append(((h - h % 2) // 2, (w - w % 2) // 2))
    return dims


def _template_ws(radius: int, H: int, W: int) -> int:
    """Template window side, sized for a scale <= 2 warped halo patch."""
    rh = radius + 1
    return min(2 * (2 * rh + 2) + 2, H, W)


def template_windows(img0, uv0, radius: int):
    """Per-feature (WS, WS) windows of img0 around uv0 and their corners.

    The keyframe-rate half of template building (uv0 and img0 are constant
    between keyframes).  Returns (wins (N,WS,WS), base (N,2))."""
    H, W = img0.shape
    WS = _template_ws(radius, H, W)
    ctr = torch.floor(torch.nan_to_num(uv0, nan=0.0, posinf=0.0, neginf=0.0))
    base = torch.clamp(ctr - (WS // 2), min=0.0)
    base = torch.stack([torch.clamp(base[:, 0], max=W - WS), torch.clamp(base[:, 1], max=H - WS)],
                       -1)
    bi = base.long()
    r = torch.arange(WS, device=img0.device)
    rows = (bi[:, 1:2] + r)[:, :, None]
    cols = (bi[:, 0:1] + r)[:, None, :]
    return img0.reshape(-1)[rows * W + cols], base


def templates(img0, uv0, warp, radius: int, min_eig: float, tmpl_win=None):
    """Warped template patch, central-difference gradients, 2x2 normal matrix.

    One bilinear sample of an (S+2)^2 halo patch per feature from its
    window (coordinates clamped inside the window, as in the JAX package).
    Returns T/gx/gy (N,S,S), nrm (N,4) = [a,b,c,inv_det], good_grad (N,)."""
    S = 2 * radius + 1
    rh = radius + 1
    Sh = S + 2
    H, W = img0.shape
    WS = _template_ws(radius, H, W)
    r = torch.arange(-rh, rh + 1, dtype=uv0.dtype, device=uv0.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs2 = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)  # ((S+2)^2,2)
    pts = uv0[:, None, :] + torch.einsum("sj,nij->nsi", offs2, warp)
    wins, base = template_windows(img0, uv0, radius) if tmpl_win is None else tmpl_win

    loc = pts - base[:, None, :]
    flx, fly = torch.floor(loc[..., 0]), torch.floor(loc[..., 1])
    fx, fy = loc[..., 0] - flx, loc[..., 1] - fly
    ix = torch.nan_to_num(torch.clamp(flx, 0, WS - 2), nan=0.0).long()
    iy = torch.nan_to_num(torch.clamp(fly, 0, WS - 2), nan=0.0).long()
    flat = wins.reshape(wins.shape[0], -1)
    at = lambda yy, xx: torch.gather(flat, 1, yy * WS + xx)
    P = (at(iy, ix) * (1 - fx) * (1 - fy) + at(iy, ix + 1) * fx * (1 - fy)
         + at(iy + 1, ix) * (1 - fx) * fy + at(iy + 1, ix + 1) * fx * fy)
    P = P.reshape(-1, Sh, Sh)

    T = P[:, 1:-1, 1:-1]
    gx = 0.5 * (P[:, 1:-1, 2:] - P[:, 1:-1, :-2])
    gy = 0.5 * (P[:, 2:, 1:-1] - P[:, :-2, 1:-1])
    a = (gx * gx).sum((1, 2))
    b = (gx * gy).sum((1, 2))
    c = (gy * gy).sum((1, 2))
    det = a * c - b * b
    tr = a + c
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    good_grad = eig_min / (S * S) > min_eig
    inv_det = torch.where(torch.abs(det) < 1e-9, torch.zeros_like(det), 1.0 / det)
    nrm = torch.stack([a, b, c, inv_det], -1)
    return T.contiguous(), gx.contiguous(), gy.contiguous(), nrm, good_grad


def track_levels(pyr0, pyr1, uv0, uv_init, valid0, warp=None, *, levels: int = 3,
                 radius: int = 7, iters: int = 10, iters_coarse: int = 6, min_eig: float = 1e-3,
                 fb_thresh: float = 0.5, max_err: float = 20.0, bwd_levels: int = 1,
                 eps: float = 0.01, tmpl_wins=None, iterate=None):
    """The track level by level: per level, templates as tensor ops and one
    call of ``iterate`` (``lk_iterate``, or ``lk_iterate_ref`` for the plain
    version); forward over all levels, backward on ``bwd_levels`` from the
    answer, then the forward-backward and residual gates.

    ``warp`` (N,2,2) or None maps target-patch offsets to template-patch
    offsets; a warp that is not finite or whose determinant is outside
    (0.25, 4) counts as the identity.  ``tmpl_wins``: optional cache from
    ``template_windows_pyr(pyr0, uv0, ...)`` for the forward pass."""
    iterate = lk_iterate_ref if iterate is None else iterate
    N = uv0.shape[0]
    eye = torch.eye(2, dtype=uv0.dtype, device=uv0.device).expand(N, 2, 2)
    if warp is None:
        warp = eye
    det = warp[:, 0, 0] * warp[:, 1, 1] - warp[:, 0, 1] * warp[:, 1, 0]
    good_w = (det > 0.25) & (det < 4.0) & torch.isfinite(warp).all(2).all(1)
    warp = torch.where(good_w[:, None, None], warp, eye)
    inv = torch.stack([
        torch.stack([warp[:, 1, 1], -warp[:, 0, 1]], -1),
        torch.stack([-warp[:, 1, 0], warp[:, 0, 0]], -1),
    ], -2) / torch.where(good_w, det, torch.ones_like(det))[:, None, None]

    def run(pa, pb, uv_a, uv_b0, A, use_levels, wins_pyr=None, is_bwd=False):
        uv = uv_b0 / (2 ** (use_levels - 1))
        ok = torch.ones(N, dtype=torch.bool, device=uv0.device)
        err = torch.zeros(N, dtype=uv0.dtype, device=uv0.device)
        for lvl in range(use_levels - 1, -1, -1):
            T, gx, gy, nrm, good_grad = templates(
                pa[lvl], uv_a / 2.0 ** lvl, A, radius, min_eig,
                tmpl_win=None if wins_pyr is None else wins_pyr[lvl])
            H, W = pb[lvl].shape
            out = iterate(pb[lvl].contiguous(), uv.contiguous(), T, gx, gy, nrm,
                          iters=iters if (lvl == 0 and not is_bwd) else iters_coarse, eps=eps)
            uv, err = out[:, :2], out[:, 2]
            inb = ((uv[:, 0] >= radius) & (uv[:, 0] < W - radius)
                   & (uv[:, 1] >= radius) & (uv[:, 1] < H - radius))
            ok = ok & good_grad & inb
            if lvl > 0:
                uv = uv * 2.0
        return uv, ok, err

    uv1, ok_f, err = run(pyr0, pyr1, uv0, uv_init, warp, levels, wins_pyr=tmpl_wins)
    uv0_back, ok_b, _ = run(pyr1, pyr0, uv1, uv0, inv, bwd_levels, is_bwd=True)
    fb = torch.linalg.norm(uv0_back - uv0, dim=-1)
    valid = valid0 & ok_f & ok_b & (fb < fb_thresh) & (err < max_err)
    return uv1, valid, err


def lk_track_ref(pyr0, pyr1, uv0, uv_init, valid0, warp=None, *, tmpl_wins=None, **kw):
    """Plain PyTorch version of ``lk_track``: ``track_levels`` around
    ``lk_iterate_ref``."""
    return track_levels(pyr0, pyr1, uv0, uv_init, valid0, warp, tmpl_wins=tmpl_wins,
                        iterate=lk_iterate_ref, **kw)

