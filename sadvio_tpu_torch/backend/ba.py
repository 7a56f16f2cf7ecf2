"""Sliding-window visual-inertial bundle adjustment: batched Schur-LM.

Port of the main-path subset of ``sadvio_tpu/backend/ba.py`` (no line
rows, no angular or numeric variants).  Landmarks not retained by the
marginalization prior are eliminated with independent 3x3 blocks; the
reduced dense system holds the K keyframe 15-dof states plus the P
retained landmarks and is solved with a Jacobi-equilibrated Cholesky.
Reprojection Jacobians are hand-derived; the small factors (IMU, bias walk,
priors) are linearized with one ``torch.func.jacfwd`` over the dense delta.
LM uses deferred acceptance: one linearization per iteration serves as the
acceptance cost and, if accepted, as the next normal equations.

Normal equations: H dx = b with H = J^T W J, b = -J^T W r; eliminated
landmarks dl = Hll^-1 (bl - Hpl^T dp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from sadvio_tpu_torch.backend import factors
from sadvio_tpu_torch.data.window import ImuChain, Observations, PriorSet, Rig, WindowState
from sadvio_tpu_torch.models import imu as imu_mod
from sadvio_tpu_torch.utils import geometry as geo
from sadvio_tpu_torch.utils.struct import Struct, select

D = 15  # per-keyframe state dof: [omega(3), nu(3), dv(3), dba(3), dbg(3)]


@dataclass
class BAOptions(Struct):
    sigma_px: float = 1.0
    huber: float = 1.345
    iters: int = 10
    lam_init: float = 1e-4
    lam_up: float = 10.0
    lam_down: float = 0.5
    jitter: float = 1e-5
    acc_walk: float = 3.0e-3
    gyr_walk: float = 2.0e-5


class BAProblem(NamedTuple):
    state: WindowState
    obs: Observations
    rig: Rig
    imu: ImuChain
    priors: PriorSet
    fixed_mask: torch.Tensor  # (K,) bool: pose frozen (gauge)
    opt_lmk_only: bool = False  # freeze all KF states (landmark-only solve)


def slot_of_lmk(priors: PriorSet, L: int):
    """(L,) retained-slot index of each landmark, P if eliminated."""
    P = priors.P
    dev = priors.prior_slots.device
    idx = torch.where(priors.prior_slot_mask, priors.prior_slots, L)
    out = torch.full((L + 1,), P, dtype=torch.int64, device=dev)
    return out.scatter(0, idx, torch.arange(P, device=dev))[:L]


def _reproj_terms(state: WindowState, obs: Observations, rig: Rig, opts: BAOptions):
    """Linearize all (K,C,L) reprojection residuals: r (K,C,L,2),
    J_pose (K,C,L,2,6), J_lmk (K,C,L,2,3), base mask m and Huber weights w."""
    outs = []
    for c in range(rig.C):
        r, Jp, Jl, valid = factors.reprojection_residual(
            rig.cam.camera(c), state.R[:, None], state.t[:, None], rig.R_f_s[c],
            rig.t_f_s[c], state.lmk[None], obs.uv[:, c], opts.sigma_px)
        m = (obs.mask[:, c] & valid & state.lmk_mask[None, :]
             & state.kf_mask[:, None]).to(r.dtype)
        w = m * factors.huber_weight(torch.linalg.norm(r, dim=-1), opts.huber)
        outs.append((r, Jp, Jl, m, w))
    return tuple(torch.stack(xs, 1) for xs in zip(*outs))


def _retained_lmk(state: WindowState, priors: PriorSet):
    """(P,3) positions of the prior-retained landmarks (zeros for empty slots)."""
    lmk_ext = torch.cat([state.lmk, state.lmk.new_zeros((1, 3))])
    return lmk_ext[torch.where(priors.prior_slot_mask, priors.prior_slots, state.L)]


def _apply_dense_delta(state: WindowState, priors: PriorSet, dxd):
    """Retract the dense delta [K*D + P*3] onto the window state."""
    K = state.K
    dk = dxd[: K * D].reshape(K, D)
    R, t = geo.pose_retract(state.R, state.t, dk[:, :6])
    dl = dxd[K * D: K * D + priors.P * 3].reshape(-1, 3)
    upd = torch.where(priors.prior_slot_mask[:, None], dl, torch.zeros_like(dl))
    idx = torch.where(priors.prior_slot_mask, priors.prior_slots, state.L)
    lmk = torch.cat([state.lmk, state.lmk.new_zeros((1, 3))]).index_add(0, idx, upd)[: state.L]
    return state.replace(R=R, t=t, v=state.v + dk[:, 6:9], ba=state.ba + dk[:, 9:12],
                         bg=state.bg + dk[:, 12:15], lmk=lmk)


def _dense_residuals(state: WindowState, imu: ImuChain, priors: PriorSet, opts: BAOptions):
    """All whitened non-reprojection residuals, masked, as one flat vector."""
    return _dense_residuals_pl(state.R, state.t, state.v, state.ba, state.bg,
                               _retained_lmk(state, priors), imu, priors, opts)


def _masked(m, r):
    return torch.where(m, r, torch.zeros_like(r))


def _dense_residuals_pl(Rk, tk, vk, bak, bgk, pl, imu: ImuChain, priors: PriorSet,
                        opts: BAOptions, W_imu=None):
    """Dense-factor residuals of per-KF states + retained landmarks (the
    surface ``jacfwd`` differentiates).  W_imu: optional precomputed
    (K-1,9,9) IMU whitening."""
    pre = imu.pre
    W = imu_mod.sqrt_info(pre) if W_imu is None else W_imu
    r_imu = factors.imu_factor_residual(pre, W, Rk[:-1], tk[:-1], vk[:-1], bak[:-1],
                                        bgk[:-1], Rk[1:], tk[1:], vk[1:])
    r_bias = factors.bias_rw_residual(bak[:-1], bgk[:-1], bak[1:], bgk[1:], pre.dt,
                                      opts.acc_walk, opts.gyr_walk)
    m = imu.mask[:, None]
    r_imu, r_bias = _masked(m, r_imu), _masked(m, r_bias)

    r_sp = _masked(priors.sp_mask[:, None], factors.state_prior_residual(
        Rk, tk, vk, bak, bgk, priors.sp_R, priors.sp_t, priors.sp_v, priors.sp_ba,
        priors.sp_bg, priors.sp_sqrt_info))
    r_lp = _masked(priors.lp_mask[:, None],
                   factors.lmk_prior_residual(pl, priors.lp_val, priors.lp_sqrt_info))
    r_plp = _masked(priors.plp_mask[:, None], factors.pose_lmk_residual(
        Rk[priors.plp_frame], tk[priors.plp_frame], pl, priors.plp_val,
        priors.plp_sqrt_info))
    r_ll = _masked(priors.ll_mask[:, None], factors.lmk_lmk_residual(
        pl[priors.ll_a], pl[priors.ll_b], priors.ll_val, priors.ll_sqrt_info))

    # dense marginalization prior replayed at its linearization point
    f = priors.dn_frame
    dl = _masked(priors.prior_slot_mask[:, None], pl - priors.dn_lmk)
    dx_dn = torch.cat([geo.pose_local(priors.dn_R, priors.dn_t, Rk[f], tk[f]),
                       vk[f] - priors.dn_v, bak[f] - priors.dn_ba, bgk[f] - priors.dn_bg,
                       dl.reshape(-1)])
    r_dn = _masked(priors.dn_mask, priors.dn_J @ dx_dn + priors.dn_r)
    return torch.cat([r_imu.reshape(-1), r_bias.reshape(-1), r_sp.reshape(-1),
                      r_lp.reshape(-1), r_plp.reshape(-1), r_ll.reshape(-1), r_dn])


class _Lin(NamedTuple):
    """The lam-independent normal equations and the robust cost at one
    linearization point."""

    Hll: torch.Tensor  # (L,3,3)
    bl: torch.Tensor  # (L,3)
    Hpl: torch.Tensor  # (K,L,6,3)
    Hpp: torch.Tensor  # (K,6,6)
    bp: torch.Tensor  # (K,6)
    H: torch.Tensor  # (Dd,Dd) dense base: small factors + retained scatter
    b: torch.Tensor  # (Dd,)
    cost: torch.Tensor  # () true-Huber robust cost


def _huber_cost(r, m, d):
    rn = torch.linalg.norm(r, dim=-1)
    rho = torch.where(rn <= d, rn * rn, 2.0 * d * rn - d * d)
    return torch.sum(m * rho)


def _linearize(problem: BAProblem, opts: BAOptions) -> _Lin:
    state, obs, rig, imu, priors = problem[:5]
    K, C, L = obs.mask.shape
    P = priors.P
    KD, Dd = K * D, K * D + P * 3
    dt_, dev = state.lmk.dtype, state.lmk.device

    r, Jp, Jl, m, w = _reproj_terms(state, obs, rig, opts)
    slot = slot_of_lmk(priors, L)
    wJl = w[..., None, None] * Jl
    Hll = torch.einsum("kclai,kclaj->lij", wJl, Jl)
    bl = -torch.einsum("kclai,kcla->li", wJl, r)
    wJp = w[..., None, None] * Jp
    Hpl = torch.einsum("kclai,kclaj->klij", wJp, Jl)
    Hpp = torch.einsum("kclai,kclaj->kij", wJp, Jp)
    bp = -torch.einsum("kclai,kcla->ki", wJp, r)

    S = ((slot[:, None] == torch.arange(P, device=dev)[None, :])
         & state.lmk_mask[:, None]).to(dt_)
    Hll_ret = torch.einsum("lp,lij->pij", S, Hll)
    bl_ret = torch.einsum("lp,li->pi", S, bl)
    Hx = torch.einsum("lp,klij->kpij", S, Hpl)  # (K,P,6,3)

    pl0 = _retained_lmk(state, priors)
    W_imu = imu_mod.sqrt_info(imu.pre)

    def rfun(dxd):
        dk = dxd[:KD].reshape(K, D)
        Rk, tk = geo.pose_retract(state.R, state.t, dk[:, :6])
        dl = dxd[KD:].reshape(P, 3)
        pl = pl0 + torch.where(priors.prior_slot_mask[:, None], dl, torch.zeros_like(dl))
        return _dense_residuals_pl(Rk, tk, state.v + dk[:, 6:9], state.ba + dk[:, 9:12],
                                   state.bg + dk[:, 12:15], pl, imu, priors, opts, W_imu)

    dx0 = torch.zeros(Dd, dtype=dt_, device=dev)
    r_dense = rfun(dx0)
    J = torch.func.jacfwd(rfun)(dx0)
    H = J.T @ J
    b = -J.T @ r_dense

    eyeK = torch.eye(K, dtype=dt_, device=dev)
    H4 = H[:KD, :KD].reshape(K, D, K, D).clone()
    H4[:, :6, :, :6] += (Hpp[:, None] * eyeK[:, :, None, None]).transpose(1, 2)
    H[:KD, :KD] = H4.reshape(KD, KD)
    b[:KD] += torch.cat([bp, bp.new_zeros((K, D - 6))], 1).reshape(-1)

    eyeP = torch.eye(P, dtype=dt_, device=dev)
    Hd = H[KD:, KD:].reshape(P, 3, P, 3) + Hll_ret[:, :, None, :] * eyeP[:, None, :, None]
    H[KD:, KD:] = Hd.reshape(P * 3, P * 3)
    b[KD:] += bl_ret.reshape(-1)

    Hc = H[:KD, KD:].reshape(K, D, P, 3).clone()
    Hc[:, :6] += Hx.transpose(1, 2)
    Hc2 = Hc.reshape(KD, P * 3)
    H[:KD, KD:] = Hc2
    H[KD:, :KD] = Hc2.T

    cost = _huber_cost(r, m, opts.huber) + torch.sum(r_dense * r_dense)
    return _Lin(Hll, bl, Hpl, Hpp, bp, H, b, cost)


def _solve_from_lin(lin: _Lin, problem: BAProblem, opts: BAOptions, free, lam):
    """Damp + Schur-eliminate + Cholesky-solve the cached normal equations."""
    state, priors = problem.state, problem.priors
    K, L, P = state.K, state.L, priors.P
    KD = K * D
    Dd = lin.H.shape[0]
    dt_, dev = state.lmk.dtype, state.lmk.device

    elim = state.lmk_mask & ~(slot_of_lmk(priors, L) < P)
    em = elim.to(dt_)
    Hll_e = lin.Hll * em[:, None, None]
    bl_e = lin.bl * em[:, None]
    Hpl_e = lin.Hpl * em[None, :, None, None]
    dll = torch.abs(torch.diagonal(Hll_e, dim1=-2, dim2=-1))
    damp = lam * dll + opts.jitter + (1.0 - em[:, None])
    Hll_inv = geo.inv3x3(Hll_e + torch.diag_embed(damp)) * em[:, None, None]
    W_kl = torch.einsum("klij,ljm->klim", Hpl_e, Hll_inv)
    Hred_corr = -torch.einsum("klab,qlcb->kqac", W_kl, Hpl_e)  # (K,K,6,6)
    bred_corr = -torch.einsum("klab,lb->ka", W_kl, bl_e)

    H = lin.H.clone()
    H4 = H[:KD, :KD].reshape(K, D, K, D).clone()
    H4[:, :6, :, :6] += Hred_corr.transpose(1, 2)
    H[:KD, :KD] = H4.reshape(KD, KD)
    b = lin.b.clone()
    b[:KD] += torch.cat([bred_corr, bred_corr.new_zeros((K, D - 6))], 1).reshape(-1)

    # freeze masked dims, Jacobi-equilibrate, multiplicative LM damping
    eye = torch.eye(Dd, dtype=dt_, device=dev)
    Hm = H * free[:, None] * free[None, :] + eye * (1.0 - free)
    bm = b * free
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-10))
    Hs = Hm * s[:, None] * s[None, :] + eye * (lam + opts.jitter)
    Lc, info = torch.linalg.cholesky_ex(Hs)
    ok = (info == 0) & torch.isfinite(Lc).all()
    Lc = torch.where(ok, Lc, eye)
    y = torch.cholesky_solve((bm * s)[:, None], Lc)[:, 0]
    dxd = torch.where(ok, y * s, torch.zeros_like(y)) * free

    dpose = dxd[:KD].reshape(K, D)[:, :6]
    rhs = bl_e - torch.einsum("klij,ki->lj", Hpl_e, dpose)
    dl = torch.einsum("lij,lj->li", Hll_inv, rhs)
    dl = torch.where(elim[:, None], dl, torch.zeros_like(dl))
    return dxd, dl, ok


def _lm_step(problem: BAProblem, opts: BAOptions, free, lam):
    return _solve_from_lin(_linearize(problem, opts), problem, opts, free, lam)


def _free_mask(problem: BAProblem):
    """(Dd,) 1.0 where the dim is free, 0.0 where frozen."""
    state, P = problem.state, problem.priors.P
    K = state.K
    pose_free = (state.kf_mask & ~problem.fixed_mask).to(state.lmk.dtype)
    kf_free = state.kf_mask.to(state.lmk.dtype)
    m_k = torch.cat([pose_free[:, None].expand(K, 6), kf_free[:, None].expand(K, 9)], 1)
    if problem.opt_lmk_only:
        m_k = torch.zeros_like(m_k)
    m_p = problem.priors.prior_slot_mask.to(m_k.dtype)[:, None].expand(P, 3)
    return torch.cat([m_k.reshape(-1), m_p.reshape(-1)])


def robust_cost(problem: BAProblem, opts: BAOptions):
    """Total robust cost (true Huber)."""
    state = problem.state
    r, _, _, m, _ = _reproj_terms(state, problem.obs, problem.rig, opts)
    rd = _dense_residuals(state, problem.imu, problem.priors, opts)
    return _huber_cost(r, m, opts.huber) + torch.sum(rd * rd)


def _ba_solve_impl(problem: BAProblem, opts: BAOptions, n_iters: int):
    free = _free_mask(problem)
    lin = _linearize(problem, opts)
    cost0 = lin.cost
    state, cost = problem.state, cost0
    lam = torch.tensor(opts.lam_init, dtype=state.lmk.dtype, device=state.lmk.device)
    costs, accepts = [], []
    for _ in range(n_iters):
        dxd, dl, ok = _solve_from_lin(lin, problem._replace(state=state), opts, free, lam)
        trial = _apply_dense_delta(state, problem.priors, dxd)
        trial = trial.replace(lmk=trial.lmk + dl)
        lin_t = _linearize(problem._replace(state=trial), opts)
        accept = ok & torch.isfinite(lin_t.cost) & (lin_t.cost < cost)
        state = select(accept, trial, state)
        lin = select(accept, lin_t, lin)
        lam = torch.clamp(torch.where(accept, lam * opts.lam_down, lam * opts.lam_up), 1e-9, 1e6)
        cost = torch.where(accept, lin_t.cost, cost)
        costs.append(cost)
        accepts.append(accept)
    stats = {"cost0": cost0, "cost": cost}
    if n_iters:
        stats.update(costs=torch.stack(costs), accepted=torch.stack(accepts))
    return state, stats


def ba_solve(problem: BAProblem, opts: BAOptions):
    """Run LM on the window problem; returns (new_state, stats)."""
    return _ba_solve_impl(problem, opts, opts.iters)
