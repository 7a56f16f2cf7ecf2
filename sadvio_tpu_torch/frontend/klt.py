"""Pyramidal inverse-compositional Lucas-Kanade tracking, batched.

Port of ``sadvio_tpu/frontend/klt.py``.  Template gradients and the 2x2
normal matrix are computed once per feature per level; the iteration loop
runs in ``ops.klt_kernel.lk_iterate`` (the CUDA kernel on the card, its
plain version on the CPU).  The JAX package's TPU workarounds are gone:
pyramid levels are not padded (the kernel clamps taps to the image edge,
which gives the values edge padding gave), and windows and patches are
read with plain indexing instead of one-hot matrix contractions.
"""

from __future__ import annotations

import torch

from sadvio_tpu_torch.ops import klt_kernel


def build_pyramid(img, levels: int = 3):
    """List of images, level 0 = full res; 2x2 average-pool downsampling."""
    pyr = [img]
    for _ in range(levels - 1):
        x = pyr[-1]
        H, W = x.shape
        x = x[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2).mean((1, 3))
        pyr.append(x)
    return pyr


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
    hi = torch.tensor([W - WS, H - WS], dtype=uv0.dtype, device=uv0.device)
    base = torch.minimum(torch.clamp(ctr - (WS // 2), min=0.0), hi)
    bi = base.long()
    r = torch.arange(WS, device=img0.device)
    rows = (bi[:, 1:2] + r)[:, :, None]
    cols = (bi[:, 0:1] + r)[:, None, :]
    return img0.reshape(-1)[rows * W + cols], base


def _templates(img0, uv0, warp, radius: int, min_eig: float, tmpl_win=None):
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


def _track_level(img0, img1, uv0, uv1, warp, radius: int, iters: int,
                 min_eig: float, tmpl_win=None, eps: float = 0.01):
    """One pyramid level of IC-LK for all features (uv in this level's scale).

    ``warp`` (N,2,2) maps target-patch offsets to template-patch offsets."""
    T, gx, gy, nrm, good_grad = _templates(img0, uv0, warp, radius, min_eig,
                                           tmpl_win=tmpl_win)
    H, W = img1.shape
    out = klt_kernel.lk_iterate(img1.contiguous(), uv1.contiguous(), T, gx, gy,
                                nrm, iters=iters, eps=eps)
    uv, err = out[:, :2], out[:, 2]
    inb = ((uv[:, 0] >= radius) & (uv[:, 0] < W - radius)
           & (uv[:, 1] >= radius) & (uv[:, 1] < H - radius))
    return uv, good_grad & inb, err


def template_windows_pyr(pyr, uv0, levels: int, radius: int):
    """Per-level cached template windows for track(tmpl_wins=...)."""
    return tuple(template_windows(pyr[lvl], uv0 / (2.0 ** lvl), radius)
                 for lvl in range(levels))


def track(pyr0, pyr1, uv0, uv_init, valid0, *, levels: int = 3, radius: int = 7,
          iters: int = 10, iters_coarse: int = 6, min_eig: float = 1e-3,
          fb_thresh: float = 0.5, max_err: float = 20.0, warp=None,
          bwd_levels: int = 1, tmpl_wins=None, eps: float = 0.01):
    """Track uv0 from pyramid pyr0 to pyr1 starting at uv_init.

    Forward pass over all levels, backward pass at level 0 from the answer,
    forward-backward gate at ``fb_thresh`` px.  Returns (uv1, valid, err)."""
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
            s = 2.0 ** lvl
            uv, ok_l, err = _track_level(
                pa[lvl], pb[lvl], uv_a / s, uv, A, radius,
                iters if (lvl == 0 and not is_bwd) else iters_coarse, min_eig,
                tmpl_win=None if wins_pyr is None else wins_pyr[lvl], eps=eps)
            ok = ok & ok_l
            if lvl > 0:
                uv = uv * 2.0
        return uv, ok, err

    uv1, ok_f, err = run(pyr0, pyr1, uv0, uv_init, warp, levels, wins_pyr=tmpl_wins)
    uv0_back, ok_b, _ = run(pyr1, pyr0, uv1, uv0, inv, bwd_levels, is_bwd=True)
    fb = torch.linalg.norm(uv0_back - uv0, dim=-1)
    valid = valid0 & ok_f & ok_b & (fb < fb_thresh) & (err < max_err)
    return uv1, valid, err
