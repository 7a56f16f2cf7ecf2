"""Epipolar geometry: angular filtering, essential-matrix RANSAC and the
homography path for planar or low-parallax motion (port of
``sadvio_tpu/frontend/epipolar.py``).

The 8-point solve, the DLT, the scoring and the refit are batched over the
hypotheses.  Subsets come from a ``torch.Generator`` (the JAX package uses
``jax.random``) or from ``sample_idx`` when the caller supplies them."""

from __future__ import annotations

import math

import torch

from sadvio_tpu_torch.frontend.match import first_argmin
from sadvio_tpu_torch.utils import geometry as geo


def epipolar_angular_error(R_ab, t_ab, rays_a, rays_b):
    """Angular distance (rad) of ray_b from the epipolar plane of ray_a;
    T_ab maps frame-b coordinates into frame a."""
    rb_in_a = geo.mv(R_ab, rays_b)
    n = torch.linalg.cross(t_ab.expand_as(rb_in_a), rb_in_a, dim=-1)
    nn = torch.linalg.norm(n, dim=-1)
    n_hat = n / torch.clamp(nn, min=1e-9)[..., None]
    s = torch.abs(torch.sum(n_hat * rays_a, -1))
    return torch.asin(torch.clamp(s, 0.0, 1.0))


def epipolar_filter(R_ab, t_ab, rays_a, rays_b, valid, max_angle_deg=0.5):
    """Outlier gate at a fixed angular threshold."""
    err = epipolar_angular_error(R_ab, t_ab, rays_a, rays_b)
    tiny_t = torch.linalg.norm(t_ab) < 1e-6  # plane undefined: keep all
    return valid & (tiny_t | (err < math.radians(max_angle_deg)))


def _svd(A):
    """SVD of 3x3 matrices in float64, returned in A's dtype."""
    U, S, Vh = torch.linalg.svd(A.double())
    return U.to(A.dtype), S.to(A.dtype), Vh.to(A.dtype)


def _null_vector(A):
    """Right singular vector of the smallest singular value of A (...,M,9):
    the lowest eigenvector of A^T A in float64 (the JAX package takes it
    from a full SVD of A; the 9x9 form is the same vector up to sign and
    far cheaper for a batch of hypotheses)."""
    A64 = A.double()
    return torch.linalg.eigh(A64.transpose(-1, -2) @ A64)[1][..., :, 0].to(A.dtype)


def _subset_weights(sample_idx, N, valid):
    """(n_hyp, N) 0/1 weights of each hypothesis' subset, masked by valid."""
    n_h = sample_idx.shape[0]
    w = torch.zeros((n_h, N + 1), dtype=torch.float32, device=valid.device)
    w = w.scatter(1, sample_idx.long(), 1.0)[:, :N]
    return w * valid.float()


def _draw(sample_idx, generator, n_hyp, k, N, device):
    if sample_idx is None:
        sample_idx = torch.randint(0, N, (n_hyp, k), generator=generator, device=device)
    return sample_idx.to(device)


def _eight_point(rays_a, rays_b, w):
    """Weighted 8-point essential estimate from unit rays; batched over the
    leading dims of w (...,N).  Constraint: rb^T E ra = 0."""
    A = (rays_a[:, None, :] * rays_b[:, :, None]).reshape(-1, 9)
    A = A * w[..., None]
    E = _null_vector(A).reshape(*w.shape[:-1], 3, 3)
    # project to essential space: singular values (1,1,0)
    U, _, Vh = _svd(E)
    return U @ torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)) @ Vh


def _sampson(E, rays_a, rays_b):
    Ex = torch.einsum("...ij,nj->...ni", E, rays_a)
    Etx = torch.einsum("...ji,nj->...ni", E, rays_b)
    num = (rays_b * Ex).sum(-1) ** 2
    den = Ex[..., 0] ** 2 + Ex[..., 1] ** 2 + Etx[..., 0] ** 2 + Etx[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _nonzero(x, eps):
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _first_argmax(votes):
    """Index (0-d tensor) of the maximum; the lowest index on ties."""
    return first_argmin(-votes, 0)[0]


def decompose_essential(E, rays_a, rays_b, valid):
    """Pick (R, t) among the 4 decompositions by cheirality voting.

    E solves rb^T E ra = 0, so the decomposed pair is the b-from-a
    transform; cheirality is voted there and the result inverted: returns
    T_ab = (R, t) with |t| = 1 mapping b-frame coordinates into frame a,
    and the winning vote count."""
    U, _, Vh = _svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vh)
    U = U * torch.where(d < 0, -1.0, 1.0)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                     device=E.device)
    R1, R2, t = U @ W @ Vh, U @ W.T @ Vh, U[:, 2]

    def count_cheirality(R_ba, t_ba):
        o2 = -R_ba.T @ t_ba
        d2 = rays_b @ R_ba
        d1 = rays_a
        m00, m01, m11 = (d1 * d1).sum(-1), -(d1 * d2).sum(-1), (d2 * d2).sum(-1)
        q0, q1 = (d1 * o2).sum(-1), -(d2 * o2).sum(-1)
        det = _nonzero(m00 * m11 - m01 * m01, 1e-12)
        z1 = (m11 * q0 - m01 * q1) / det
        z2 = (m00 * q1 - m01 * q0) / det
        return ((z1 > 0) & (z2 > 0) & valid).sum()

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    votes = torch.stack([count_cheirality(R, tt) for R, tt in cands])
    best = _first_argmax(votes)
    R_ba = torch.stack([c[0] for c in cands])[best]
    t_ba = torch.stack([c[1] for c in cands])[best]
    return R_ba.T, -R_ba.T @ t_ba, votes[best]


def essential_ransac(rays_a, rays_b, valid, generator=None, *, n_hyp: int = 64,
                     thresh: float = 1e-5, min_inliers: int = 15, sample_idx=None):
    """Batched-hypothesis essential RANSAC on bearing rays.

    Returns (R, t_unit, inliers, ok): T_ab up to scale.  sample_idx:
    optional (n_hyp, 8) subsets, otherwise drawn from ``generator``."""
    N = rays_a.shape[0]
    idx = _draw(sample_idx, generator, n_hyp, 8, N, rays_a.device)
    Es = _eight_point(rays_a, rays_b, _subset_weights(idx, N, valid))
    scores = (valid & (_sampson(Es, rays_a, rays_b) < thresh)).sum(-1)
    E = Es[_first_argmax(scores)]
    # one refit pass on the inliers
    inl = valid & (_sampson(E, rays_a, rays_b) < thresh)
    E = _eight_point(rays_a, rays_b, inl.to(rays_a.dtype))
    inl = valid & (_sampson(E, rays_a, rays_b) < thresh)
    R, t, votes = decompose_essential(E, rays_a, rays_b, inl)
    n_inl = inl.sum()
    ok = (n_inl >= min_inliers) & (votes >= n_inl * 0.7)
    return R, t, inl, ok


def _normalized(rays):
    return rays / torch.clamp(rays[:, 2:3], min=1e-9)


def _homography_dlt(rays_a, rays_b, w):
    """Weighted DLT on normalized coordinates x = ray / ray_z; batched over
    the leading dims of w (...,N) -> (...,3,3)."""
    xa, xb = _normalized(rays_a), _normalized(rays_b)
    x, y, u, v = xa[:, 0], xa[:, 1], xb[:, 0], xb[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    H = _null_vector(A).reshape(*w.shape[:-1], 3, 3)
    return H / _nonzero(H[..., 2:3, 2:3], 1e-9)


def _transfer_error(H, rays_a, rays_b):
    """Symmetric squared transfer error in normalized coordinates."""
    xa, xb = _normalized(rays_a), _normalized(rays_b)
    fb = xa @ H.transpose(-1, -2)
    fb = fb / _nonzero(fb[..., 2:3], 1e-9)
    Hi = torch.linalg.inv_ex(H)[0]
    fa = xb @ Hi.transpose(-1, -2)
    fa = fa / _nonzero(fa[..., 2:3], 1e-9)
    return ((fb[..., :2] - xb[:, :2]) ** 2).sum(-1) + ((fa[..., :2] - xa[:, :2]) ** 2).sum(-1)


def decompose_homography(H, rays_a, rays_b, valid):
    """Faugeras-Lustman decomposition H = R + t n^T / d on normalized
    coordinates: builds the 4 physical (R, t, n) candidates and picks the
    one with the best cheirality + visibility vote.  Returns (R_ab, t_ab
    unit, n_a, votes), T_ab as in essential_ransac."""
    U, S, Vh = _svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    d2c = torch.clamp(d2, min=1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def cand(e1, e3):
        sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2c
        cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2c
        Rp = torch.stack([torch.stack([cos_t, zero, -sin_t]), torch.stack([zero, one, zero]),
                          torch.stack([sin_t, zero, cos_t])])
        np_ = torch.stack([x1 * e1, zero, x3 * e3])
        tp = (d1 - d3) * torch.stack([x1 * e1, zero, -x3 * e3])
        R = s * U @ Rp @ Vh
        t = U @ tp
        n = Vh.T @ np_
        flip = torch.where(n[2] < 0, -1.0, 1.0)  # plane normal toward camera a
        return R, t * flip, n * flip

    cands = [cand(e1, e3) for e1 in (1.0, -1.0) for e3 in (1.0, -1.0)]
    xa = _normalized(rays_a)

    def vote(R_ba, t_ba, n):
        vis = (xa @ n) > 0
        rb = rays_b @ R_ba  # b rays in a's frame
        t_ab = -R_ba.T @ t_ba
        d = (rays_a * rb).sum(-1)
        q0, q1 = (rays_a * t_ab).sum(-1), (rb * t_ab).sum(-1)
        det = _nonzero(1.0 - d * d, 1e-12)
        z1 = (q0 - d * q1) / det
        z2 = (d * q0 - q1) / det
        return (vis & (z1 > 0) & (z2 > 0) & valid).sum()

    votes = torch.stack([vote(*c) for c in cands])
    best = _first_argmax(votes)
    R_ba, t_ba, n = (torch.stack([c[i] for c in cands])[best] for i in range(3))
    t_ba = t_ba / torch.clamp(torch.linalg.norm(t_ba), min=1e-12)
    t_ab = -R_ba.T @ t_ba
    # pure rotation (d1 ~ d2 ~ d3): t is unobservable, report zero
    pure_rot = (d1 - d3) / d2c < 1e-4
    t_ab = torch.where(pure_rot, torch.zeros_like(t_ab), t_ab)
    return R_ba.T, t_ab, n, votes[best]


def homography_ransac(rays_a, rays_b, valid, generator=None, *, n_hyp: int = 64,
                      thresh: float = 2e-5, min_inliers: int = 12, sample_idx=None):
    """Batched-hypothesis homography RANSAC + decomposition.

    Returns (R_ab, t_ab unit, n_plane, inliers, ok).  sample_idx: optional
    (n_hyp, 4) subsets, otherwise drawn from ``generator``."""
    N = rays_a.shape[0]
    idx = _draw(sample_idx, generator, n_hyp, 4, N, rays_a.device)
    Hs = _homography_dlt(rays_a, rays_b, _subset_weights(idx, N, valid))
    scores = (valid & (_transfer_error(Hs, rays_a, rays_b) < thresh)).sum(-1)
    H = Hs[_first_argmax(scores)]
    inl = valid & (_transfer_error(H, rays_a, rays_b) < thresh)
    H = _homography_dlt(rays_a, rays_b, inl.to(rays_a.dtype))
    inl = valid & (_transfer_error(H, rays_a, rays_b) < thresh)
    R, t, n, votes = decompose_homography(H, rays_a, rays_b, inl)
    n_inl = inl.sum()
    ok = (n_inl >= min_inliers) & (votes >= n_inl * 0.7)
    return R, t, n, inl, ok
