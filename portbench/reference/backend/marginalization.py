"""Marginalization of the oldest keyframe into a sparsified or dense prior.

Port of ``sadvio_tpu/backend/marginalization.py``.  The window is ordered:
slot 0 is the frame to marginalize, slot 1 the kept frame; the dense marg
delta is [x0(15) | dropped(3P) | x1(15) | kept(3P)].

* float32 route (default): square-root marginalization, QR on the stacked
  whitened blanket Jacobian, which works at the square root of the
  blanket's ~1e8 information spread.
* ``f64=True``: the reference's H-space Schur / eigendecomposition chain
  with a 1e-12 rank threshold.  The JAX package leaves the device for a
  host float64 island; here float64 is a dtype, so the chain runs in
  ``torch.float64`` on the caller's device and the priors come back in
  float32.
* ``sparsify=True`` emits the sparsified prior (VIO: pose-relative landmark
  priors + a 15-dof state prior on the kept frame; VO: a Chow-Liu chain);
  ``sparsify=False`` replays the marginal as one dense (15+3P)-dim linear
  factor.
* ``marginalize_relative`` condenses the links between slots 0 and 1 into
  one relative-pose edge for the pose graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.backend import factors as F
from portbench.reference.backend.ba import D, BAOptions, _reproj_terms
from portbench.reference.data.window import ImuChain, Observations, PriorSet, Rig, WindowState
from portbench.reference.models import imu as imu_mod
from portbench.reference.utils import geometry as geo
from portbench.reference.utils.struct import take


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _round_robin(m: int, device):
    """Round-robin pairings of m (even) indices as permutations, (m-1, m):
    round r pairs the entries 2i and 2i+1 of row r; the pairs of a round
    are disjoint and every two indices meet once over the m-1 rounds."""
    r = torch.arange(m - 1, device=device)[:, None]
    i = torch.arange(m, device=device)[None, :]
    seat = torch.where(i == 0, 0, (i - 1 + r) % (m - 1) + 1)
    return torch.stack([seat[:, : m // 2], seat[:, m // 2:].flip(-1)], -1).reshape(m - 1, m)


def sym_eig(A):
    """Eigenvalues (in no particular order) and orthonormal eigenvectors
    (columns) of the symmetric (..., n, n) ``A``, computed in float64 and
    returned in ``A``'s dtype.

    On a CUDA tensor by ``jacobi_eig``: ``torch.linalg.eigh``'s CUDA route
    checks its error code on the host, which a CUDA graph cannot capture.
    On the CPU by ``torch.linalg.eigh`` (LAPACK), the plain version, which
    is much faster there.  Both agree to float64 rounding on the
    eigenvalues; eigenvectors of a repeated eigenvalue may come in another
    basis of its eigenspace, which the functions of A built from them
    (pseudo-inverses, square roots) do not see."""
    if A.is_cuda:
        return jacobi_eig(A)
    lam, U = torch.linalg.eigh(A.double())
    return lam.to(A.dtype), U.to(A.dtype)


def jacobi_eig(A):
    """``sym_eig`` by cyclic Jacobi rotations in round-robin order, in
    float64; eigenvalues in no particular order.  Jacobi rotations are also
    how XLA computes eigh on a TPU.

    A size m matrix (n rounded up to even) takes m-1 rounds per sweep, each
    rotating m/2 disjoint index pairs at once: the matrix is kept permuted
    so that the round's pairs are adjacent 2x2 blocks, and a round is one
    gather into the next round's order and one product with the
    block-diagonal rotation.  A fixed 6 + ceil(log2 m) sweeps, no
    convergence test (which would read the device on the host): the
    off-diagonal mass falls quadratically once it is small, and the
    marginalization's 87 x 87 blanket is at 1e-9 of its norm after 12."""
    n = A.shape[-1]
    m = n + n % 2  # an odd size gains a zero row and column, decoupled from the rest
    h = m // 2
    dev = A.device
    perms = _round_robin(m, dev)
    inv = torch.argsort(perms, dim=-1)
    # rel[r]: round r's order -> round r+1's order (the last wraps to the first)
    rel = torch.gather(inv, 1, perms.roll(-1, 0))
    X = torch.nn.functional.pad(A.double(), (0, m - n, 0, m - n))
    X = X[..., perms[0][:, None], perms[0][None, :]]
    V = torch.eye(m, dtype=X.dtype, device=dev)[:, perms[0]].expand(X.shape).clone()
    sweeps = 6 + max(m - 1, 1).bit_length()
    eye_h = torch.eye(h, dtype=X.dtype, device=dev)[:, None, :, None]
    for sweep in range(sweeps):
        for r in range(m - 1):
            if sweep or r:
                X = X[..., rel[r - 1][:, None], rel[r - 1][None, :]]
                V = V[..., rel[r - 1]]
            blocks = X.unflatten(-1, (h, 2)).unflatten(-3, (h, 2)).diagonal(dim1=-4, dim2=-2)
            app, apq, aqq = blocks[..., 0, 0, :], blocks[..., 0, 1, :], blocks[..., 1, 1, :]
            # the rotation that zeroes (p, q): tan(2 theta) = 2 apq / (aqq - app)
            # with |theta| <= pi/4 (Golub & Van Loan, sym.schur2)
            two = 2.0 * apq
            theta = torch.where(two == 0, 0.0, 0.5 * torch.atan(two / (aqq - app)))
            c, s = torch.cos(theta), torch.sin(theta)
            J = torch.stack([c, s, -s, c], -1).unflatten(-1, (2, 2))  # (..., h, 2, 2)
            # G: block-diagonal, J's blocks on the round's adjacent pairs
            G = (J[..., :, :, None, :] * eye_h).flatten(-4, -3).flatten(-2)
            X = G.transpose(-1, -2) @ X @ G
            V = V @ G
    back = inv[-1]
    lam = torch.diagonal(X, dim1=-2, dim2=-1)[..., back][..., :n]
    return lam.to(A.dtype), V[..., back][..., :n, :n].to(A.dtype)


def _eigh(A, eps_rel):
    lam, U = sym_eig(_sym(A))
    thresh = eps_rel * torch.clamp(lam.abs().amax(-1, keepdim=True), min=1e-20)
    return lam, U, lam > thresh


def rank_revealing_pinv(A, eps_rel=1e-6):
    """Eigen pseudo-inverse with a relative threshold: (Ainv, U, lam, keep)."""
    lam, U, keep = _eigh(A, eps_rel)
    inv_lam = torch.where(keep, 1.0 / torch.where(keep, lam, torch.ones_like(lam)),
                          torch.zeros_like(lam))
    return (U * inv_lam[..., None, :]) @ U.transpose(-1, -2), U, lam, keep


def sqrt_psd(A, eps_rel=1e-6):
    """Symmetric PSD square root with eigenvalue clipping."""
    lam, U, keep = _eigh(A, eps_rel)
    s = torch.sqrt(torch.where(keep, lam, torch.zeros_like(lam)))
    return (U * s[..., None, :]) @ U.transpose(-1, -2)


def pinv_sqrt(cov, eps_rel=1e-6):
    """Square root of the pseudo-inverse of a covariance block."""
    lam, U, keep = _eigh(cov, eps_rel)
    s = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, lam, torch.ones_like(lam))),
                    torch.zeros_like(lam))
    return (U * s[..., None, :]) @ U.transpose(-1, -2)


_EPS64 = 1e-12  # relative rank threshold of the float64 chain


def rr_pinv64(A):
    """rank_revealing_pinv computed in float64 at a 1e-12 threshold; the
    results keep float64 (the caller casts what it stores)."""
    return rank_revealing_pinv(A.double(), _EPS64)


def pinv_sqrt64(cov):
    """pinv_sqrt computed in float64 at a 1e-12 threshold, returned in float32."""
    return pinv_sqrt(cov.double(), _EPS64).float()


def _eq_scales(A, eps_act=1e-10):
    """Equilibration scales; dims with ~0 diagonal are masked, not scaled."""
    d = torch.abs(torch.diagonal(A, dim1=-2, dim2=-1))
    dmax = torch.clamp(d.amax(-1, keepdim=True), min=1e-20)
    act = d > eps_act * dmax
    s = torch.where(act, 1.0 / torch.sqrt(torch.where(act, d, torch.ones_like(d))),
                    torch.ones_like(d))
    return s, act


def rank_revealing_pinv_eq(A, eps_rel=1e-6):
    """rank_revealing_pinv with Jacobi pre-equilibration."""
    s, act = _eq_scales(A)
    As = _sym(A) * s[..., :, None] * s[..., None, :]
    As = As * act[..., :, None] * act[..., None, :]
    Ainv_s = rank_revealing_pinv(As, eps_rel)[0]
    return Ainv_s * s[..., :, None] * s[..., None, :]


class Blanket(NamedTuple):
    keep_idx: torch.Tensor  # (P,) landmark indices in the keep set
    keep_mask: torch.Tensor  # (P,)
    drop_idx: torch.Tensor  # (P,) old-prior landmarks being marginalized
    drop_mask: torch.Tensor
    lonely: torch.Tensor  # (L,) 3x3-eliminable landmarks
    marg_lmk: torch.Tensor  # (L,) landmarks leaving the map
    n_overflow: torch.Tensor  # () keep-set landmarks beyond the P slots


def _top_p_indices(mask, P):
    """First P set indices of a boolean mask; (idx (P,), valid (P,))."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:P]
    return idx, mask[idx]


def _mark(L, idx, valid):
    """(L,) bool with True at idx[valid] (invalid entries go to a dump row)."""
    out = torch.zeros(L + 1, dtype=torch.bool, device=idx.device)
    return out.scatter(0, torch.where(valid, idx, L), valid)[:L]


def _positions(L, idx, valid):
    """(L+1,) position of each landmark in idx[valid], -1 elsewhere."""
    P = idx.shape[0]
    out = torch.full((L + 1,), -1, dtype=torch.int64, device=idx.device)
    return out.scatter(0, torch.where(valid, idx, L), torch.arange(P, device=idx.device))


def partition_blanket(state: WindowState, obs: Observations, priors: PriorSet, P: int) -> Blanket:
    """Markov-blanket partition of the frame in slot 0."""
    L = state.L
    seen0 = obs.mask[0].any(0) & state.lmk_mask
    elsewhere = obs.mask[1:].flatten(0, 1).any(0) & state.lmk_mask
    in_old = _mark(L, priors.prior_slots, priors.prior_slot_mask)
    keep = (seen0 | in_old) & elsewhere
    lonely = (seen0 & ~in_old) & ~elsewhere
    drop = in_old & ~elsewhere
    keep_idx, keep_valid = _top_p_indices(keep, P)
    overflow = keep & ~_mark(L, keep_idx, keep_valid)
    drop_idx, drop_valid = _top_p_indices(drop, P)
    return Blanket(keep_idx, keep_valid, drop_idx, drop_valid, lonely | overflow,
                   lonely | drop, overflow.sum())


def _gather_lmk(state, idx, valid):
    lmk_ext = torch.cat([state.lmk, state.lmk.new_zeros((1, 3))])
    return lmk_ext[torch.where(valid, idx, state.L)]


def _marg_dense_residuals(state, imu: ImuChain, priors: PriorSet, opts: BAOptions,
                          blanket: Blanket, dxm, W0=None):
    """Residuals of all small factors in the blanket as a function of the
    dense marg delta: IMU(0,1) + bias walk, the old state prior on slot 0,
    the old landmark priors and the old dense prior."""
    P = blanket.keep_idx.shape[0]
    L = state.L
    d0 = dxm[0:D]
    d_drop = dxm[D: D + 3 * P].reshape(P, 3)
    d1 = dxm[D + 3 * P: 2 * D + 3 * P]
    d_keep = dxm[2 * D + 3 * P:].reshape(P, 3)

    R0, t0 = geo.pose_retract(state.R[0], state.t[0], d0[:6])
    v0, ba0, bg0 = state.v[0] + d0[6:9], state.ba[0] + d0[9:12], state.bg[0] + d0[12:15]
    R1, t1 = geo.pose_retract(state.R[1], state.t[1], d1[:6])
    v1, ba1, bg1 = state.v[1] + d1[6:9], state.ba[1] + d1[9:12], state.bg[1] + d1[12:15]
    p_keep = _gather_lmk(state, blanket.keep_idx, blanket.keep_mask) + d_keep
    p_drop = _gather_lmk(state, blanket.drop_idx, blanket.drop_mask) + d_drop

    pre0 = imu.pre[0]
    W = imu_mod.sqrt_info(pre0) if W0 is None else W0
    m0 = imu.mask[0]
    zero = lambda x: torch.zeros_like(x)
    r_imu = F.imu_factor_residual(pre0, W, R0, t0, v0, ba0, bg0, R1, t1, v1)
    r_bias = F.bias_rw_residual(ba0, bg0, ba1, bg1, pre0.dt, opts.acc_walk, opts.gyr_walk)
    parts = [torch.where(m0, r_imu, zero(r_imu)), torch.where(m0, r_bias, zero(r_bias))]

    r_sp = F.state_prior_residual(R0, t0, v0, ba0, bg0, priors.sp_R[0], priors.sp_t[0],
                                  priors.sp_v[0], priors.sp_ba[0], priors.sp_bg[0],
                                  priors.sp_sqrt_info[0])
    parts.append(torch.where(priors.sp_mask[0], r_sp, zero(r_sp)))

    # old-slot landmarks: keep position wins, then drop, else fixed
    old_lidx = torch.where(priors.prior_slot_mask, priors.prior_slots, L)
    pos_k = _positions(L, blanket.keep_idx, blanket.keep_mask)[old_lidx]
    pos_d = _positions(L, blanket.drop_idx, blanket.drop_mask)[old_lidx]
    p_fixed = _gather_lmk(state, priors.prior_slots, priors.prior_slot_mask)
    p_old = torch.where((pos_k >= 0)[:, None], p_keep[torch.clamp(pos_k, min=0)],
                        torch.where((pos_d >= 0)[:, None], p_drop[torch.clamp(pos_d, min=0)],
                                    p_fixed))
    r_lp = F.lmk_prior_residual(p_old, priors.lp_val, priors.lp_sqrt_info)
    parts.append(torch.where(priors.lp_mask[:, None], r_lp, zero(r_lp)).reshape(-1))
    r_plp = F.pose_lmk_residual(R0, t0, p_old, priors.plp_val, priors.plp_sqrt_info)
    plp_m = priors.plp_mask & (priors.plp_frame == 0)
    parts.append(torch.where(plp_m[:, None], r_plp, zero(r_plp)).reshape(-1))
    r_ll = F.lmk_lmk_residual(p_old[priors.ll_a], p_old[priors.ll_b], priors.ll_val,
                              priors.ll_sqrt_info)
    parts.append(torch.where(priors.ll_mask[:, None], r_ll, zero(r_ll)).reshape(-1))

    dl = p_old - priors.dn_lmk
    dx_dn = torch.cat([geo.pose_local(priors.dn_R, priors.dn_t, R0, t0),
                       v0 - priors.dn_v, ba0 - priors.dn_ba, bg0 - priors.dn_bg,
                       torch.where(priors.prior_slot_mask[:, None], dl, zero(dl)).reshape(-1)])
    r_dn = priors.dn_J @ dx_dn + priors.dn_r
    parts.append(torch.where(priors.dn_mask, r_dn, zero(r_dn)))
    return torch.cat(parts)


def _reproj_h_slot0(state, obs, rig, opts, blanket, dim, P, dtype=None):
    """Reprojection contributions at slot 0 to the dense marg system, (H, g)
    with g = J^T W r.  Kept and dropped landmarks enter with their blocks;
    lonely landmarks are eliminated with batched 3x3 Schur blocks onto the
    x0 pose (keep in sync with _reproj_sqrt_rows).  ``dtype``: the products
    and the elimination are formed in this type from the residuals' own
    (float64 keeps g exactly in the range of H, which the dense replay of
    the float64 chain relies on)."""
    r, Jp, Jl, m, w = _reproj_terms(state, obs, rig, opts)
    dtype, dev = dtype or r.dtype, r.device
    r0, Jp0, Jl0, w0 = (x[0].to(dtype) for x in (r, Jp, Jl, w))  # (C,L,...)
    wJl = w0[..., None, None] * Jl0
    wJp = w0[..., None, None] * Jp0
    Hll = torch.einsum("clai,claj->lij", wJl, Jl0)
    Hpl = torch.einsum("clai,claj->lij", wJp, Jl0)
    Hpp = torch.einsum("clai,claj->ij", wJp, Jp0)
    gp = torch.einsum("clai,cla->i", wJp, r0)
    gl = torch.einsum("clai,cla->li", wJl, r0)

    # the elimination itself always runs in float64 (see _reproj_sqrt_rows)
    f64 = torch.float64
    em = blanket.lonely.to(f64)
    eye3 = torch.eye(3, dtype=f64, device=dev)
    Hll_inv = geo.inv3x3(Hll.to(f64) * em[:, None, None] + eye3 * opts.jitter) * em[:, None, None]
    Hpl_l = Hpl.to(f64) * em[:, None, None]
    corr = -torch.einsum("lij,ljk,lmk->im", Hpl_l, Hll_inv, Hpl_l).to(dtype)
    g_corr = -torch.einsum("lij,ljk,lk->i", Hpl_l, Hll_inv, gl.to(f64) * em[:, None]).to(dtype)

    H = torch.zeros((dim, dim), dtype=dtype, device=dev)
    g = torch.zeros(dim, dtype=dtype, device=dev)
    H[0:6, 0:6] = Hpp + corr
    g[0:6] = gp + g_corr
    ar = torch.arange(P, device=dev)
    for idx, valid, off in ((blanket.drop_idx, blanket.drop_mask, D),
                            (blanket.keep_idx, blanket.keep_mask, 2 * D + 3 * P)):
        safe = torch.where(valid, idx, 0)
        vf = valid.to(dtype)
        H[off: off + 3 * P, off: off + 3 * P].view(P, 3, P, 3)[ar, :, ar, :] += (
            Hll[safe] * vf[:, None, None])
        Hc = (Hpl[safe] * vf[:, None, None]).permute(1, 0, 2).reshape(6, 3 * P)
        H[0:6, off: off + 3 * P] += Hc
        H[off: off + 3 * P, 0:6] += Hc.T
        g[off: off + 3 * P] += (gl[safe] * vf[:, None]).reshape(-1)
    return H, g


def _reproj_sqrt_rows(state, obs, rig, opts, blanket, dim, P):
    """Whitened reprojection Jacobian rows at slot 0: keep/drop landmarks
    give their observation rows directly; lonely landmarks are eliminated
    with batched 3x3 Schur blocks and re-enter as the 6 square-root rows of
    their correction onto the x0 pose."""
    r, Jp, Jl, m, w = _reproj_terms(state, obs, rig, opts)
    Jp0, Jl0, w0 = Jp[0], Jl[0], w[0]  # (C,L,...)
    dtype, dev = r.dtype, r.device
    C, L = w0.shape

    pos_d = _positions(L, blanket.drop_idx, blanket.drop_mask)[:L]
    pos_k = _positions(L, blanket.keep_idx, blanket.keep_mask)[:L]
    in_d, in_k = pos_d >= 0, pos_k >= 0
    sel = (in_d | in_k).to(dtype)
    col0 = torch.where(in_d, D + 3 * torch.clamp(pos_d, min=0),
                       2 * D + 3 * P + 3 * torch.clamp(pos_k, min=0))
    sw = torch.sqrt(w0) * sel[None, :]
    rows = torch.zeros((C, L, 2, dim), dtype=dtype, device=dev)
    cols = (col0[:, None, None] + torch.arange(3, device=dev)).expand(C, L, 2, 3)
    rows = rows.scatter(-1, cols, Jl0 * sw[..., None, None])
    rows[..., 0:6] += Jp0 * sw[..., None, None]
    rows = rows.reshape(-1, dim)

    # The elimination of the lonely landmarks runs in float64 whatever the
    # window's dtype.  A landmark seen by one camera only has a rank-2 Hll;
    # in float32 its jittered 3x3 inverse loses the cancellation that keeps
    # the landmark's unobserved depth out of the pose block, and the six rows
    # then carry information on the x0 pose that is orders of magnitude above
    # the true correction and differs between backends; the marginal hands it
    # on as an over-confident prior.
    f64 = torch.float64
    Jp64, Jl64, w64 = Jp0.to(f64), Jl0.to(f64), w0.to(f64)
    em = blanket.lonely.to(f64)
    wl = (w64 * em[None, :])[..., None, None]
    Hll = torch.einsum("clai,claj->lij", wl * Jl64, Jl64)
    Hpl = torch.einsum("clai,claj->lij", wl * Jp64, Jl64)
    Hpp_l = torch.einsum("clai,claj->ij", wl * Jp64, Jp64)
    eye3 = torch.eye(3, dtype=f64, device=dev)
    Hll_inv = geo.inv3x3(Hll + eye3 * opts.jitter) * em[:, None, None]
    M6 = _sym(Hpp_l - torch.einsum("lij,ljk,lmk->im", Hpl, Hll_inv, Hpl))
    rows6 = torch.zeros((6, dim), dtype=dtype, device=dev)
    rows6[:, 0:6] = sqrt_psd(M6).to(dtype)
    return torch.cat([rows, rows6])


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def marginalize(state: WindowState, obs: Observations, rig: Rig, imu: ImuChain,
                priors: PriorSet, opts: BAOptions, vio: bool = True,
                sparsify: bool = True, f64: bool = False):
    """Marginalize KF slot 0; emit a sparsified or a dense prior.

    sparsify=False: the marginal is replayed as one dense (15+3P)-dim linear
    factor (float32 route: dn_J = R22 with a zero replayed gradient, whose
    float32 value at convergence is cancellation noise; float64 route:
    J = Lam^1/2 U^T, r = Lam^-1/2 U^T g_k on the kept eigen-subspace).
    f64=True: the H-space Schur chain in float64 on the caller's device.

    Returns (new_priors, info); new_priors is in pre-shift slot coordinates
    (kept frame = slot 1): apply shift_priors() after the window shift."""
    P = priors.P
    dt_, dev = state.lmk.dtype, state.lmk.device
    blanket = partition_blanket(state, obs, priors, P)
    dim = 2 * D + 6 * P
    m_dim = D + 3 * P
    W0 = imu_mod.sqrt_info(imu.pre[0])

    def rfun(dxm):
        return _marg_dense_residuals(state, imu, priors, opts, blanket, dxm, W0)

    z0 = torch.zeros(dim, dtype=dt_, device=dev)
    J = torch.func.jacfwd(rfun)(z0)
    if f64:
        # H-space chain of the reference, in float64 from the float32
        # Jacobians on: products, Schur complement and both pseudo-inverses
        J64 = J.double()
        H_r, g_r = _reproj_h_slot0(state, obs, rig, opts, blanket, dim, P, torch.float64)
        H = J64.T @ J64 + H_r
        g = J64.T @ rfun(z0).double() + g_r  # cost gradient, ~0 at convergence
        Hmm, Hmk, Hkk = H[:m_dim, :m_dim], H[:m_dim, m_dim:], H[m_dim:, m_dim:]
        Hmm_inv = rr_pinv64(Hmm)[0]
        Ak64 = _sym(Hkk - Hmk.T @ Hmm_inv @ Hmk)  # (15+3P) over [x1, kept]
        gk = g[m_dim:] - Hmk.T @ (Hmm_inv @ g[:m_dim])
        Sigma_k, U, lam, keep_eig = rr_pinv64(Ak64)
        degenerate = torch.clamp(-lam.min(), min=0.0) > 1e-2 * torch.clamp(lam.max(), min=1e-20)
        Ak = Ak64.to(dt_)
        psq = pinv_sqrt64
    else:
        # square-root marginalization: QR of the stacked whitened Jacobian
        # works at the square root of the blanket's ~1e8 information spread
        rows_r = _reproj_sqrt_rows(state, obs, rig, opts, blanket, dim, P)
        R_ = torch.linalg.qr(torch.cat([J, rows_r]), mode="r")[1]
        R22 = R_[m_dim:, m_dim:]
        degenerate = (~torch.isfinite(R22)).any()
        R22 = _finite(R22)
        Ak = _sym(R22.T @ R22)
        Sigma_k = rank_revealing_pinv_eq(Ak)
        # marginal square-root factor of x1 alone (triangular, inversion-free)
        R2p = torch.linalg.qr(torch.cat([R22[:, D:], R22[:, :D]], 1), mode="r")[1]
        sp_tri = _finite(R2p[3 * P:, 3 * P:])
        psq = pinv_sqrt
    sdt = Sigma_k.dtype

    new = PriorSet.create(state.K, P, dt_, dev).replace(
        prior_slots=blanket.keep_idx, prior_slot_mask=blanket.keep_mask)
    p_keep = _gather_lmk(state, blanket.keep_idx, blanket.keep_mask)
    R1, t1 = state.R[1], state.t[1]
    km = blanket.keep_mask

    if not sparsify:
        if f64:
            zero = torch.zeros_like(lam)
            sq = torch.sqrt(torch.where(keep_eig, lam, zero))
            isq = torch.where(keep_eig, 1.0 / torch.sqrt(torch.where(keep_eig, lam, zero + 1.0)),
                              zero)
            dn_J = (sq[:, None] * U.T).to(dt_)
            dn_r = (isq * (U.T @ gk)).to(dt_)
            has_info = (keep_eig & (lam > 0)).any()
        else:
            dn_J = R22
            dn_r = torch.zeros(m_dim, dtype=dt_, device=dev)
            dR_d = torch.abs(torch.diagonal(R22))
            has_info = (dR_d > 1e-6 * torch.clamp(dR_d.max(), min=1e-20)).any()
        new = new.replace(dn_J=dn_J, dn_r=dn_r, dn_R=R1, dn_t=t1, dn_v=state.v[1],
                          dn_ba=state.ba[1], dn_bg=state.bg[1], dn_lmk=p_keep,
                          dn_frame=torch.ones((), dtype=torch.int64, device=dev),
                          dn_mask=has_info)
    elif vio:
        # pose-relative landmark priors + 15-dof state prior on the kept frame
        p_f = geo.mv(R1.T, p_keep - t1)
        # Jacobian of R1^T (p - t1) - val wrt [dx1 (15) | kept landmarks (3P)]
        eye3 = torch.eye(3, dtype=dt_, device=dev)
        J_lmk = torch.eye(P, dtype=dt_, device=dev)[:, None, :, None] * R1.T[None, :, None, :]
        Jr = torch.cat([geo.skew(p_f), -eye3.expand(P, 3, 3),
                        torch.zeros((P, 3, D - 6), dtype=dt_, device=dev),
                        J_lmk.reshape(P, 3, 3 * P)], -1)
        Jr = Jr.to(sdt)
        cov = Jr @ Sigma_k @ Jr.transpose(-1, -2)
        new = new.replace(
            plp_val=p_f, plp_frame=torch.ones(P, dtype=torch.int64, device=dev),
            plp_sqrt_info=psq(cov) * km[:, None, None], plp_mask=km)
        # the float32 route takes the triangular marginal factor of x1 (an
        # invert-invert round trip there turns chain noise into phantom
        # information); the float64 chain keeps the reference's pinv recipe
        sp_sqrt = psq(Sigma_k[:D, :D]) if f64 else sp_tri
        set1 = lambda x, val: torch.cat([x[:1], val[None], x[2:]])
        new = new.replace(
            sp_R=set1(new.sp_R, R1), sp_t=set1(new.sp_t, t1),
            sp_v=set1(new.sp_v, state.v[1]), sp_ba=set1(new.sp_ba, state.ba[1]),
            sp_bg=set1(new.sp_bg, state.bg[1]), sp_sqrt_info=set1(new.sp_sqrt_info, sp_sqrt),
            sp_mask=set1(new.sp_mask, km.any() | imu.mask[0]))
    else:
        new = _chow_liu(new, Ak, Sigma_k, p_keep, km, P, psq)

    info = {"marg_lmk": blanket.marg_lmk, "lonely": blanket.lonely,
            "keep_idx": blanket.keep_idx, "keep_mask": km,
            "n_keep_overflow": blanket.n_overflow, "degenerate": degenerate, "Ak": Ak}
    return new, info


def _chow_liu(new: PriorSet, Ak, Sigma_k, p_keep, km, P: int, psq=pinv_sqrt) -> PriorSet:
    """VO sparsification: greedy max-MI chain of landmark-landmark factors
    plus one absolute prior on the min-entropy landmark."""
    dt_, dev = Ak.dtype, Ak.device
    fm = km.to(dt_)
    mi = torch.abs(Ak[D:, D:].reshape(P, 3, P, 3).diagonal(dim1=1, dim2=3).sum(-1))
    mi = mi * fm[:, None] * fm[None, :] * (1.0 - torch.eye(P, dtype=dt_, device=dev))

    # every index below stays on the device (no host read): rows and
    # columns are cleared by comparison masks, entries picked by take
    ar = torch.arange(P, device=dev)
    start = torch.argmax(mi)
    a0, b0 = start // P, start % P
    order = torch.where(ar == 0, a0, torch.where(ar == 1, b0, -1))
    mi_c = torch.where((ar[:, None] == a0) | (ar[None, :] == a0) | (ar[None, :] == b0), 0.0, mi)
    cur, n = b0, torch.full((), 2, dtype=torch.int64, device=dev)
    for _ in range(P - 2):
        row = take(mi_c, cur)
        nxt = torch.argmax(row)
        has = take(row, nxt) > 0
        order = torch.where(has & (ar == n), nxt, order)
        mi_n = torch.where((ar[:, None] == cur) | (ar[None, :] == cur), 0.0, mi_c)
        mi_c = torch.where(has, mi_n, mi_c)
        cur = torch.where(has, nxt, cur)
        n = n + has.long()
    n_chain = torch.where(take(mi.reshape(-1), start) > 0, n, torch.zeros_like(n))

    Sk4 = Sigma_k[D:, D:].reshape(P, 3, P, 3)
    blocks = Sk4[ar, :, ar, :]  # (P,3,3)
    ent = torch.where(km, torch.linalg.det(blocks),
                      torch.full((P,), float("inf"), dtype=blocks.dtype, device=dev))
    root = torch.argmin(ent)
    onehot = (ar == root)
    lp_val = torch.where(onehot[:, None], p_keep, new.lp_val)
    lp_info = torch.where(onehot[:, None, None], psq(take(blocks, root))[None],
                          new.lp_sqrt_info)
    lp_mask = onehot & km.any()

    i = torch.arange(P - 1, device=dev)
    a, b = order[:-1], order[1:]
    ok = (i + 1 < n_chain) & (a >= 0) & (b >= 0)
    ac, bc = torch.clamp(a, min=0), torch.clamp(b, min=0)
    cov = blocks[ac] + blocks[bc] - Sk4[ac, :, bc, :] - Sk4[bc, :, ac, :]
    pad = lambda x, fill: torch.cat(
        [x, torch.full((1, *x.shape[1:]), fill, dtype=x.dtype, device=dev)])
    return new.replace(
        lp_val=lp_val, lp_sqrt_info=lp_info, lp_mask=lp_mask,
        ll_a=pad(ac, 0), ll_b=pad(bc, 0), ll_val=pad(p_keep[ac] - p_keep[bc], 0.0),
        ll_sqrt_info=pad(psq(cov), 0.0), ll_mask=pad(ok, False))


def marginalize_relative(state: WindowState, obs: Observations, rig: Rig, imu: ImuChain,
                         opts: BAOptions, vio: bool = True):
    """Pose-graph edge between KF slots 0 and 1 by nonlinear factor recovery.

    Every landmark observed by both frames is marginalized (batched 3x3
    Schur) -- plus, for VIO, the preintegration and bias-walk factors
    between them -- and the joint marginal over the two poses is condensed
    into one relative-pose factor whose information matches it:
    cov = J Sigma J^T, inf = cov^+.

    Returns (dx_meas (6,), inf (6,6), n_shared): the measured relative
    retraction, its recovered information and the shared-landmark count (0
    means the edge carries nothing and should be skipped)."""
    dtype, dev = state.lmk.dtype, state.lmk.device
    D2 = 2 * D
    shared = obs.mask[0].any(0) & obs.mask[1].any(0) & state.lmk_mask

    r, Jp, Jl, m, w = _reproj_terms(state, obs, rig, opts)
    w2 = w[:2] * shared[None, None, :]
    wJp = w2[..., None, None] * Jp[:2]
    Hpp_s = torch.einsum("kclai,kclaj->kij", wJp, Jp[:2])  # (2,6,6)
    Hpl_s = torch.einsum("kclai,kclaj->klij", wJp, Jl[:2])  # (2,L,6,3)
    Hll = torch.einsum("kclai,kclaj->lij", w2[..., None, None] * Jl[:2], Jl[:2])

    H = torch.zeros((D2, D2), dtype=dtype, device=dev)
    H[0:6, 0:6] = Hpp_s[0]
    H[D: D + 6, D: D + 6] = Hpp_s[1]
    if vio:
        pre0 = imu.pre[0]
        W = imu_mod.sqrt_info(pre0)
        mm = imu.mask[0]

        def rfun(dx):
            d0, d1 = dx[:D], dx[D:]
            R0, t0 = geo.pose_retract(state.R[0], state.t[0], d0[:6])
            R1, t1 = geo.pose_retract(state.R[1], state.t[1], d1[:6])
            v0, ba0, bg0 = state.v[0] + d0[6:9], state.ba[0] + d0[9:12], state.bg[0] + d0[12:15]
            v1, ba1, bg1 = state.v[1] + d1[6:9], state.ba[1] + d1[9:12], state.bg[1] + d1[12:15]
            r_imu = F.imu_factor_residual(pre0, W, R0, t0, v0, ba0, bg0, R1, t1, v1)
            r_bias = F.bias_rw_residual(ba0, bg0, ba1, bg1, pre0.dt, opts.acc_walk,
                                        opts.gyr_walk)
            return torch.cat([torch.where(mm, r_imu, torch.zeros_like(r_imu)),
                              torch.where(mm, r_bias, torch.zeros_like(r_bias))])

        J_imu = torch.func.jacfwd(rfun)(torch.zeros(D2, dtype=dtype, device=dev))
        H = H + J_imu.T @ J_imu

    em = shared.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_inv = geo.inv3x3(Hll + eye3 * opts.jitter) * em[:, None, None]
    B = torch.zeros((state.L, D2, 3), dtype=dtype, device=dev)
    B[:, 0:6, :] = Hpl_s[0] * em[:, None, None]
    B[:, D: D + 6, :] = Hpl_s[1] * em[:, None, None]
    Ak = _sym(H - torch.einsum("lij,ljk,lmk->im", B, Hll_inv, B))

    Sigma_k = rank_revealing_pinv_eq(Ak)
    sel = torch.cat([torch.arange(6, device=dev), D + torch.arange(6, device=dev)])
    Sigma_pp = Sigma_k[sel][:, sel]

    dx_meas = geo.pose_local(state.R[0], state.t[0], state.R[1], state.t[1])
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def rel(dx12):
        R0, t0 = geo.pose_retract(state.R[0], state.t[0], dx12[:6])
        R1, t1 = geo.pose_retract(state.R[1], state.t[1], dx12[6:])
        return F.relative_pose_residual(R0, t0, R1, t1, dx_meas, eye6)

    Jr = torch.func.jacfwd(rel)(torch.zeros(12, dtype=dtype, device=dev))
    inf = rank_revealing_pinv(Jr @ Sigma_pp @ Jr.T)[0]
    return dx_meas, _sym(inf), shared.sum()


def shift_priors(priors: PriorSet) -> PriorSet:
    """Re-index a PriorSet after the window shifts left by one slot."""
    roll = lambda x: torch.roll(x, -1, 0)
    K = priors.sp_mask.shape[0]
    sp_mask = roll(priors.sp_mask) & (torch.arange(K, device=priors.sp_mask.device) < K - 1)
    return priors.replace(
        sp_R=roll(priors.sp_R), sp_t=roll(priors.sp_t), sp_v=roll(priors.sp_v),
        sp_ba=roll(priors.sp_ba), sp_bg=roll(priors.sp_bg),
        sp_sqrt_info=roll(priors.sp_sqrt_info), sp_mask=sp_mask,
        plp_frame=torch.clamp(priors.plp_frame - 1, min=0),
        dn_frame=torch.clamp(priors.dn_frame - 1, min=0))
