"""Marginalization of the oldest keyframe into a sparsified prior.

Port of the main-path subset of ``sadvio_tpu/backend/marginalization.py``:
the float32 square-root route (QR on the stacked whitened blanket Jacobian)
with the VIO sparsified prior (pose-relative landmark priors + a 15-dof
state prior on the kept frame) and the VO Chow-Liu chain, which the
pipeline uses for rolls before VIInit.  The window is ordered: slot 0 is
the frame to marginalize, slot 1 the kept frame; the dense marg delta is
[x0(15) | dropped(3P) | x1(15) | kept(3P)].  The host-f64 island and the
dense replay prior are not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sadvio_tpu_torch.backend import factors as F
from sadvio_tpu_torch.backend.ba import D, BAOptions, _reproj_terms
from sadvio_tpu_torch.data.window import ImuChain, Observations, PriorSet, Rig, WindowState
from sadvio_tpu_torch.models import imu as imu_mod
from sadvio_tpu_torch.utils import geometry as geo


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _eigh(A, eps_rel):
    lam, U = torch.linalg.eigh(_sym(A))
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

    wJl = w0[..., None, None] * Jl0
    Hll = torch.einsum("clai,claj->lij", wJl, Jl0)
    Hpl = torch.einsum("clai,claj->lij", w0[..., None, None] * Jp0, Jl0)
    em = blanket.lonely.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_inv = geo.inv3x3(Hll * em[:, None, None] + eye3 * opts.jitter) * em[:, None, None]
    Hpl_l = Hpl * em[:, None, None]
    Hpp_l = torch.einsum("clai,claj->ij", (w0 * em[None, :])[..., None, None] * Jp0, Jp0)
    M6 = _sym(Hpp_l - torch.einsum("lij,ljk,lmk->im", Hpl_l, Hll_inv, Hpl_l))
    rows6 = torch.zeros((6, dim), dtype=dtype, device=dev)
    rows6[:, 0:6] = sqrt_psd(M6)
    return torch.cat([rows, rows6])


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def marginalize(state: WindowState, obs: Observations, rig: Rig, imu: ImuChain,
                priors: PriorSet, opts: BAOptions, vio: bool = True,
                sparsify: bool = True, f64: bool = False):
    """Marginalize KF slot 0 into a sparsified prior.

    Returns (new_priors, info); new_priors is in pre-shift slot coordinates
    (kept frame = slot 1): apply shift_priors() after the window shift."""
    if f64:
        raise NotImplementedError("marg_f64 (host float64 marginalization) is not ported yet")
    if not sparsify:
        raise NotImplementedError("the dense replay prior (sparsification: 0) is not ported yet")
    P = priors.P
    dt_, dev = state.lmk.dtype, state.lmk.device
    blanket = partition_blanket(state, obs, priors, P)
    dim = 2 * D + 6 * P
    m_dim = D + 3 * P
    W0 = imu_mod.sqrt_info(imu.pre[0])

    def rfun(dxm):
        return _marg_dense_residuals(state, imu, priors, opts, blanket, dxm, W0)

    J = torch.func.jacfwd(rfun)(torch.zeros(dim, dtype=dt_, device=dev))
    # square-root marginalization: QR of the stacked whitened Jacobian works
    # at the square root of the blanket's ~1e8 information spread
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

    new = PriorSet.create(state.K, P, dt_, dev).replace(
        prior_slots=blanket.keep_idx, prior_slot_mask=blanket.keep_mask)
    p_keep = _gather_lmk(state, blanket.keep_idx, blanket.keep_mask)
    R1, t1 = state.R[1], state.t[1]
    km = blanket.keep_mask

    if vio:
        # pose-relative landmark priors + 15-dof state prior on the kept frame
        p_f = geo.mv(R1.T, p_keep - t1)
        # Jacobian of R1^T (p - t1) - val wrt [dx1 (15) | kept landmarks (3P)]
        eye3 = torch.eye(3, dtype=dt_, device=dev)
        J_lmk = torch.eye(P, dtype=dt_, device=dev)[:, None, :, None] * R1.T[None, :, None, :]
        Jr = torch.cat([geo.skew(p_f), -eye3.expand(P, 3, 3),
                        torch.zeros((P, 3, D - 6), dtype=dt_, device=dev),
                        J_lmk.reshape(P, 3, 3 * P)], -1)
        cov = Jr @ Sigma_k @ Jr.transpose(-1, -2)
        new = new.replace(
            plp_val=p_f, plp_frame=torch.ones(P, dtype=torch.int64, device=dev),
            plp_sqrt_info=pinv_sqrt(cov) * km[:, None, None], plp_mask=km)
        set1 = lambda x, val: torch.cat([x[:1], val[None], x[2:]])
        new = new.replace(
            sp_R=set1(new.sp_R, R1), sp_t=set1(new.sp_t, t1),
            sp_v=set1(new.sp_v, state.v[1]), sp_ba=set1(new.sp_ba, state.ba[1]),
            sp_bg=set1(new.sp_bg, state.bg[1]), sp_sqrt_info=set1(new.sp_sqrt_info, sp_tri),
            sp_mask=set1(new.sp_mask, km.any() | imu.mask[0]))
    else:
        new = _chow_liu(new, Ak, Sigma_k, p_keep, km, P)

    info = {"marg_lmk": blanket.marg_lmk, "lonely": blanket.lonely,
            "keep_idx": blanket.keep_idx, "keep_mask": km,
            "n_keep_overflow": blanket.n_overflow, "degenerate": degenerate, "Ak": Ak}
    return new, info


def _chow_liu(new: PriorSet, Ak, Sigma_k, p_keep, km, P: int) -> PriorSet:
    """VO sparsification: greedy max-MI chain of landmark-landmark factors
    plus one absolute prior on the min-entropy landmark."""
    dt_, dev = Ak.dtype, Ak.device
    fm = km.to(dt_)
    mi = torch.abs(Ak[D:, D:].reshape(P, 3, P, 3).diagonal(dim1=1, dim2=3).sum(-1))
    mi = mi * fm[:, None] * fm[None, :] * (1.0 - torch.eye(P, dtype=dt_, device=dev))

    start = torch.argmax(mi)
    a0, b0 = start // P, start % P
    order = torch.full((P,), -1, dtype=torch.int64, device=dev)
    order[0], order[1] = a0, b0
    mi_c = mi.clone()
    mi_c[a0, :] = 0.0
    mi_c[:, a0] = 0.0
    mi_c[:, b0] = 0.0
    cur, n = b0, torch.tensor(2, device=dev)
    for _ in range(P - 2):
        row = mi_c[cur]
        nxt = torch.argmax(row)
        has = row[nxt] > 0
        order_n = order.clone()
        order_n[n] = nxt
        order = torch.where(has, order_n, order)
        mi_n = mi_c.clone()
        mi_n[cur, :] = 0.0
        mi_n[:, cur] = 0.0
        mi_c = torch.where(has, mi_n, mi_c)
        cur = torch.where(has, nxt, cur)
        n = n + has.long()
    n_chain = torch.where(mi[a0, b0] > 0, n, torch.zeros_like(n))

    Sk4 = Sigma_k[D:, D:].reshape(P, 3, P, 3)
    ar = torch.arange(P, device=dev)
    blocks = Sk4[ar, :, ar, :]  # (P,3,3)
    ent = torch.where(km, torch.linalg.det(blocks), torch.full((P,), float("inf"), device=dev))
    root = torch.argmin(ent)
    onehot = (ar == root)
    lp_val = torch.where(onehot[:, None], p_keep, new.lp_val)
    lp_info = torch.where(onehot[:, None, None], pinv_sqrt(blocks[root])[None], new.lp_sqrt_info)
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
        ll_sqrt_info=pad(pinv_sqrt(cov), 0.0), ll_mask=pad(ok, False))


def gauge_transform_priors(priors: PriorSet, R_align, scale, anchor=None) -> PriorSet:
    """Move a PriorSet through the gauge transform p -> anchor + s R (p - anchor);
    every whitened residual is invariant."""
    dt_, dev = priors.sp_t.dtype, priors.sp_t.device
    s = torch.as_tensor(scale, dtype=dt_, device=dev)
    R_A = torch.as_tensor(R_align, dtype=dt_, device=dev)
    if anchor is None:
        anchor = torch.zeros(3, dtype=dt_, device=dev)
    A = s * R_A
    world = lambda p: anchor + geo.mv(A, p - anchor)
    vec = lambda p: geo.mv(A, p)
    colT_world = R_A.T / s
    inv_s = 1.0 / s

    sp_W = priors.sp_sqrt_info.clone()
    sp_W[:, :, 3:6] = sp_W[:, :, 3:6] * inv_s
    sp_W[:, :, 6:9] = priors.sp_sqrt_info[:, :, 6:9] @ colT_world
    P = priors.P
    Dd = 15 + 3 * P
    dn_J = priors.dn_J.clone()
    dn_J[:, 3:6] = dn_J[:, 3:6] * inv_s
    dn_J[:, 6:9] = priors.dn_J[:, 6:9] @ colT_world
    dn_J[:, 15:] = (priors.dn_J[:, 15:].reshape(Dd, P, 3) @ colT_world).reshape(Dd, 3 * P)
    return priors.replace(
        sp_R=R_A @ priors.sp_R, sp_t=world(priors.sp_t), sp_v=vec(priors.sp_v),
        sp_sqrt_info=sp_W,
        lp_val=world(priors.lp_val), lp_sqrt_info=priors.lp_sqrt_info @ colT_world,
        plp_val=s * priors.plp_val, plp_sqrt_info=priors.plp_sqrt_info * inv_s,
        ll_val=vec(priors.ll_val), ll_sqrt_info=priors.ll_sqrt_info @ colT_world,
        dn_J=dn_J, dn_R=R_A @ priors.dn_R, dn_t=world(priors.dn_t),
        dn_v=vec(priors.dn_v), dn_lmk=world(priors.dn_lmk))


def shift_priors(priors: PriorSet) -> PriorSet:
    """Re-index a PriorSet after the window shifts left by one slot."""
    roll = lambda x: torch.roll(x, -1, 0)
    sp_mask = roll(priors.sp_mask).clone()
    sp_mask[-1] = False
    return priors.replace(
        sp_R=roll(priors.sp_R), sp_t=roll(priors.sp_t), sp_v=roll(priors.sp_v),
        sp_ba=roll(priors.sp_ba), sp_bg=roll(priors.sp_bg),
        sp_sqrt_info=roll(priors.sp_sqrt_info), sp_mask=sp_mask,
        plp_frame=torch.clamp(priors.plp_frame - 1, min=0),
        dn_frame=torch.clamp(priors.dn_frame - 1, min=0))
