"""Descriptor zoo: oriented BRIEF (ORB), a BRISK-style pattern, blob scores.

Port of ``sadvio_tpu/frontend/descriptors.py``, batched over feature
slots:

- ``orientation`` + ``orb_describe``: intensity-centroid orientation and
  BRIEF pairs rotated per feature (rBRIEF), (N,256) bool;
- ``brisk_describe``: concentric sampling rings, each point read from its
  ring's blur level (a gather from the stacked blur levels), orientation
  from the long pairs, 512 short-pair bits, (N,512) bool;
- ``hessian_score``: the determinant-of-Hessian multi-scale blob score.

Bit b of a descriptor is bit b % 32 of word b // 32 of the JAX package's
packed uint32 words.  The pipeline does not use this module; it is a
library, as it is in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sadvio_tpu_torch.frontend.detect import _brief_offsets, bilinear_sample, smooth3

_ORB_PAIRS = _brief_offsets(n_bits=256, patch=24, seed=11)  # (2,256,2)


def _disc_offsets(radius: int):
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    keep = xs ** 2 + ys ** 2 <= radius ** 2
    return np.stack([xs[keep], ys[keep]], -1).astype(np.float32)


def orientation(img, uv, *, radius: int = 15):
    """Intensity-centroid angle per feature over a disc: atan2(m01, m10)."""
    disc = torch.as_tensor(_disc_offsets(radius), device=uv.device)
    w = bilinear_sample(img, uv[:, None, :] + disc[None])  # (N,P)
    return torch.atan2((w * disc[None, :, 1]).sum(-1), (w * disc[None, :, 0]).sum(-1))


def _rotations(theta):
    ct, st = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([ct, -st], -1), torch.stack([st, ct], -1)], -2)


def orb_describe(img, uv, theta=None):
    """256-bit steered BRIEF (N,256) bool on the smoothed image; ``theta``
    reuses a precomputed orientation."""
    img_s = smooth3(img)
    if theta is None:
        theta = orientation(img_s, uv)
    R = _rotations(theta)
    pairs = torch.as_tensor(_ORB_PAIRS, device=uv.device)
    rot = lambda pr: torch.einsum("nij,bj->nbi", R, pr)
    return (bilinear_sample(img_s, uv[:, None, :] + rot(pairs[0]))
            > bilinear_sample(img_s, uv[:, None, :] + rot(pairs[1])))


def _brisk_pattern():
    """60 points (centre + 4 rings), each point's blur level (ring-scaled
    smoothing), the densest 512 short pairs and the long pairs (> 9 px).
    The pair order follows numpy's default argsort, as in the JAX package."""
    pts, lv = [(0.0, 0.0)], [0]
    for ring, (r, n, level) in enumerate([(2.9, 10, 0), (4.9, 14, 1), (7.4, 15, 1),
                                          (10.8, 20, 2)]):
        for i in range(n):
            a = 2 * np.pi * i / n + (ring % 2) * np.pi / n
            pts.append((r * np.cos(a), r * np.sin(a)))
            lv.append(level)
    pts = np.asarray(pts, np.float32)
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    iu, ju = np.triu_indices(len(pts), k=1)
    dist = d[iu, ju]
    short = np.argsort(dist)[:512]
    long_ = np.where(dist > 9.0)[0]
    return (pts, np.asarray(lv, np.int64), np.stack([iu[short], ju[short]], -1),
            np.stack([iu[long_], ju[long_]], -1))


_BRISK_PTS, _BRISK_LV, _BRISK_SHORT, _BRISK_LONG = _brisk_pattern()


def _blur_stack(img):
    s1 = smooth3(img)
    s2 = smooth3(smooth3(s1))
    s3 = smooth3(smooth3(smooth3(s2)))
    return torch.stack([s1, s2, s3])


def _sample_levels(stack, lv, pts):
    """Bilinear samples (N,P) of pts (N,P,2), point p read from level lv[p]
    of the (3,H,W) stack: one gather per tap with a level offset."""
    _, H, W = stack.shape
    u = torch.clamp(pts[..., 0], 0.0, W - 1.001)
    v = torch.clamp(pts[..., 1], 0.0, H - 1.001)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    du, dv = u - u0, v - v0
    flat = stack.reshape(-1)
    base = lv[None, :] * (H * W)
    at = lambda r, c: flat[base + r * W + c]
    return (at(v0, u0) * (1 - du) * (1 - dv) + at(v0, u0 + 1) * du * (1 - dv)
            + at(v0 + 1, u0) * (1 - du) * dv + at(v0 + 1, u0 + 1) * du * dv)


def brisk_describe(img, uv):
    """512-bit BRISK-style descriptor (N,512) bool, rotation compensated by
    the long-pair gradient direction."""
    dev = uv.device
    stack = _blur_stack(img)
    pts = torch.as_tensor(_BRISK_PTS, device=dev)
    lv = torch.as_tensor(_BRISK_LV, device=dev)
    lng = torch.as_tensor(_BRISK_LONG, device=dev)
    sht = torch.as_tensor(_BRISK_SHORT, device=dev)
    # pass 1: unrotated samples -> orientation from the long pairs
    v0 = _sample_levels(stack, lv, uv[:, None, :] + pts[None])
    dp = pts[lng[:, 0]] - pts[lng[:, 1]]
    nrm = torch.linalg.norm(dp, dim=-1, keepdim=True)
    gdir = dp / torch.clamp(nrm, min=1e-6)
    dv = v0[:, lng[:, 0]] - v0[:, lng[:, 1]]
    g = (dv / torch.clamp(nrm[:, 0][None, :], min=1e-6)) @ gdir
    theta = torch.atan2(g[:, 1], g[:, 0])
    # pass 2: the rotated pattern -> short-pair comparisons
    v1 = _sample_levels(stack, lv, uv[:, None, :] + torch.einsum("nij,pj->npi", _rotations(theta),
                                                                 pts))
    return v1[:, sht[:, 0]] > v1[:, sht[:, 1]]


def hessian_score(img, n_scales: int = 3):
    """max over scales of the scale-normalized det(Hessian) of the smoothed
    image, clipped at 0."""
    def hess_det(im):
        ixx = im[:-2, 1:-1] - 2 * im[1:-1, 1:-1] + im[2:, 1:-1]
        iyy = im[1:-1, :-2] - 2 * im[1:-1, 1:-1] + im[1:-1, 2:]
        ixy = 0.25 * (im[2:, 2:] - im[2:, :-2] - im[:-2, 2:] + im[:-2, :-2])
        return F.pad(ixx * iyy - ixy * ixy, (1, 1, 1, 1))

    out = torch.zeros_like(img)
    im, scale = img, 1.0
    for _ in range(n_scales):
        im = smooth3(smooth3(im))
        scale *= 2.0
        out = torch.maximum(out, scale * hess_det(im))
    return torch.clamp(out, min=0.0)
