"""The other marginalization forms of the port against the JAX package:
the float64 H-space chain (``f64=True``), the dense replay prior
(``sparsify=False``), ``marginalize_relative`` and ``kld_gaussian_info``.

Inputs: the stressed window of tests/test_marg_conditioning.py (a
1e8-information state prior beside ~1 vision information, 30 lonely
landmarks), and the same window with an IMU factor for the relative edge.

Tolerances, with reasons:
* slots and masks identical in every form;
* prior blocks compared as information matrices W^T W relative to their own
  norm at 1e-2: the JAX package assembles H and takes the Schur complement
  in float32 and sends only the eigendecompositions to float64; the port
  runs the whole chain in float64 from the float32 Jacobians on, so the two
  differ by the JAX package's float32 assembly error;
* the port's float64 chain against the same chain written in numpy float64
  from the port's own H: 1e-6 relative;
* ``marginalize_relative``: dx 1e-4; information 1e-2 relative without the
  IMU factor.  With it the 6x6 information spans four decades (4e3 to 7e7)
  and each package's float32 result sits 1.4-1.9% from the same function run
  in float64, so there the two are held to 1e-2 as covariances, to 5e-2 as
  information matrices, and the port to 3e-2 of its own float64 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.backend import ba as jba, marginalization as jmarg
from sadvio_tpu.data.window import ImuChain as JImuChain
from sadvio_tpu_torch.backend import ba as tba, marginalization as tmarg
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.utils.struct import tree_map

torch.set_num_threads(2)

D = 15


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


def _info(W):
    W = np.asarray(W, np.float64)
    return np.swapaxes(W, -1, -2) @ W


@pytest.fixture(scope="module")
def stressed():
    from tests.test_ba import K
    from tests.test_marg_conditioning import _stressed_blanket

    gt, obs, rig, priors = _stressed_blanket(np.random.default_rng(0))
    jargs = (gt, obs, rig, JImuChain.create(K), priors)
    return jargs, [from_numpy(x) for x in _np(jargs)]


def _same_slots(pt, pj, it, ij):
    for name in ("prior_slots", "prior_slot_mask", "plp_mask", "sp_mask", "lp_mask", "ll_mask",
                 "dn_mask"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                      err_msg=name)
    for name in ("marg_lmk", "lonely", "keep_mask"):
        np.testing.assert_array_equal(it[name].numpy(), np.asarray(ij[name]), err_msg=name)
    assert int(it["n_keep_overflow"]) == int(ij["n_keep_overflow"])


@pytest.mark.parametrize("vio", [True, False])
def test_f64_chain_matches_on_stressed_window(stressed, vio):
    jargs, targs = stressed
    pj, ij = jmarg.marginalize(*jargs, jba.BAOptions(), vio=vio, f64=True)
    pt, it = tmarg.marginalize(*targs, tba.BAOptions(), vio=vio, f64=True)
    _same_slots(pt, pj, it, ij)
    assert pt.sp_sqrt_info.dtype == torch.float32 and pt.plp_sqrt_info.dtype == torch.float32
    assert _rel(it["Ak"].numpy(), ij["Ak"]) < 1e-2
    assert bool(it["degenerate"]) == bool(ij["degenerate"])
    if vio:
        assert _rel(_info(pt.sp_sqrt_info[1].numpy()), _info(pj.sp_sqrt_info[1])) < 1e-2
        m = np.asarray(pj.plp_mask)
        assert m.any()
        np.testing.assert_allclose(pt.plp_val.numpy()[m], np.asarray(pj.plp_val)[m], atol=1e-5)
        rel = [_rel(a, b) for a, b in zip(_info(pt.plp_sqrt_info.numpy())[m],
                                          _info(pj.plp_sqrt_info)[m])]
        assert max(rel) < 1e-2, max(rel)
    else:
        m = np.asarray(pj.ll_mask)
        assert m.sum() >= 1
        np.testing.assert_array_equal(pt.ll_a.numpy()[m], np.asarray(pj.ll_a)[m])
        np.testing.assert_array_equal(pt.ll_b.numpy()[m], np.asarray(pj.ll_b)[m])
        rel = [_rel(a, b) for a, b in zip(_info(pt.ll_sqrt_info.numpy())[m],
                                          _info(pj.ll_sqrt_info)[m])]
        assert max(rel) < 1e-2, max(rel)
        lm = np.asarray(pj.lp_mask)
        assert _rel(_info(pt.lp_sqrt_info.numpy())[lm], _info(pj.lp_sqrt_info)[lm]) < 1e-2
    rt = tba._dense_residuals(targs[0], targs[3], pt, tba.BAOptions()).numpy()
    assert np.isfinite(rt).all() and np.abs(rt).max() < 2e-2


def test_f64_chain_matches_numpy_float64(stressed):
    """The port's float64 products against numpy float64 on the same H:
    pseudo-inverse, Schur complement and the kept-frame square-root prior."""
    _, targs = stressed
    state, obs, rig, imu, priors = targs
    opts = tba.BAOptions()
    P = priors.P
    dim, m_dim = 2 * D + 6 * P, D + 3 * P
    blanket = tmarg.partition_blanket(state, obs, priors, P)
    rfun = lambda dxm: tmarg._marg_dense_residuals(state, imu, priors, opts, blanket, dxm)
    J = torch.func.jacfwd(rfun)(torch.zeros(dim)).double().numpy()
    H_r, _ = tmarg._reproj_h_slot0(state, obs, rig, opts, blanket, dim, P, torch.float64)
    H = J.T @ J + H_r.numpy()

    def pinv64(A):
        lam, U = np.linalg.eigh(0.5 * (A + A.T))
        keep = lam > 1e-12 * max(np.abs(lam).max(), 1e-300)
        return (U * np.where(keep, 1.0 / np.where(keep, lam, 1.0), 0.0)) @ U.T

    Ak = H[m_dim:, m_dim:] - H[:m_dim, m_dim:].T @ pinv64(H[:m_dim, :m_dim]) @ H[:m_dim, m_dim:]
    Ak = 0.5 * (Ak + Ak.T)
    Sigma = pinv64(Ak)
    # the spread the chain has to survive
    d = np.abs(np.diag(H))
    assert d.max() / d[d > 0].min() > 1e7

    pt, it = tmarg.marginalize(*targs, opts, vio=True, f64=True)
    assert _rel(it["Ak"].numpy(), Ak) < 1e-6
    lam, U = np.linalg.eigh(Sigma[:D, :D])
    keep = lam > 1e-12 * np.abs(lam).max()
    info_ref = (U * np.where(keep, 1.0 / np.where(keep, lam, 1.0), 0.0)) @ U.T
    assert _rel(_info(pt.sp_sqrt_info[1].numpy()), info_ref) < 1e-5
    assert _rel(tmarg.rr_pinv64(torch.as_tensor(Ak))[0].numpy(), Sigma) < 1e-6


@pytest.mark.parametrize("f64", [False, True])
def test_dense_replay_matches_on_stressed_window(stressed, f64):
    jargs, targs = stressed
    pj, ij = jmarg.marginalize(*jargs, jba.BAOptions(), vio=True, sparsify=False, f64=f64)
    pt, it = tmarg.marginalize(*targs, tba.BAOptions(), vio=True, sparsify=False, f64=f64)
    _same_slots(pt, pj, it, ij)
    assert bool(pt.dn_mask) and int(pt.dn_frame) == int(pj.dn_frame) == 1
    # the replayed factor as an information matrix J^T J (its rows are
    # defined up to an orthogonal transform: QR signs, eigenvector signs)
    assert _rel(_info(pt.dn_J.numpy()), _info(pj.dn_J)) < 1e-2
    for name in ("dn_R", "dn_t", "dn_v", "dn_ba", "dn_bg", "dn_lmk"):
        np.testing.assert_allclose(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                   atol=1e-6, err_msg=name)
    if f64:
        # true gradient replay: J^T r = g_k in both packages
        gt_, gj_ = pt.dn_J.numpy().T @ pt.dn_r.numpy(), np.asarray(pj.dn_J).T @ np.asarray(pj.dn_r)
        scale = np.linalg.norm(_info(pj.dn_J), 2) ** 0.5
        assert np.abs(gt_ - gj_).max() < 1e-2 * max(scale, 1.0)
    else:
        # the float32 route replays R22 with a zero gradient, as the JAX package does
        assert float(pt.dn_r.abs().max()) == 0.0 == float(jnp.abs(pj.dn_r).max())
    # the dense prior vanishes at its own linearization point and shifts like the others
    rt = tba._dense_residuals(targs[0], targs[3], pt, tba.BAOptions()).numpy()
    assert np.isfinite(rt).all() and np.abs(rt).max() < 2e-2
    assert int(tmarg.shift_priors(pt).dn_frame) == int(jmarg.shift_priors(pj).dn_frame) == 0


@pytest.fixture(scope="module")
def vio_window():
    """__graft_entry__._tiny_problem: a converged VIO window with IMU factors."""
    import __graft_entry__ as graft

    jp = graft._tiny_problem(K=4, C=2, L=64, P=8, seed=0)
    return jp, [from_numpy(x) for x in _np((jp.state, jp.obs, jp.rig, jp.imu))]


@pytest.mark.parametrize("vio", [True, False])
def test_marginalize_relative_matches(vio_window, vio):
    jp, targs = vio_window
    dxj, infj, nj = jmarg.marginalize_relative(jp.state, jp.obs, jp.rig, jp.imu, jba.BAOptions(),
                                               vio=vio)
    dxt, inft, nt = tmarg.marginalize_relative(*targs, tba.BAOptions(), vio=vio)
    assert int(nt) == int(nj) > 0
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), atol=1e-4)
    assert _rel(inft.numpy(), infj) < (5e-2 if vio else 1e-2)
    cov = lambda a: np.linalg.inv(np.asarray(a, np.float64))
    assert _rel(cov(inft.numpy()), cov(infj)) < 1e-2
    if vio:
        as64 = lambda x: x.double() if x.is_floating_point() else x
        inf64 = tmarg.marginalize_relative(*[tree_map(as64, a) for a in targs],
                                           tba.BAOptions(), vio=True)[1]
        assert _rel(inft.numpy(), inf64.numpy()) < 3e-2
    lam = np.linalg.eigvalsh(inft.double().numpy())
    assert lam.min() > -1e-6 * lam.max()


def test_marginalize_relative_without_shared_landmarks(vio_window):
    jp, targs = vio_window
    state, obs, rig, imu = targs
    mask = obs.mask.clone()
    mask[1] = False
    _, inf, n = tmarg.marginalize_relative(state, obs.replace(mask=mask), rig, imu,
                                           tba.BAOptions(), vio=False)
    assert int(n) == 0 and bool(torch.isfinite(inf).all())


def test_kld_gaussian_info_matches(rng):
    A = rng.standard_normal((12, 9))
    B = rng.standard_normal((12, 9))
    Ap, Aq = (A.T @ A).astype(np.float32), (B.T @ B).astype(np.float32)
    kj = float(jmarg.kld_gaussian_info(jnp.asarray(Ap), jnp.asarray(Aq)))
    kt = float(tmarg.kld_gaussian_info(torch.as_tensor(Ap), torch.as_tensor(Aq)))
    assert kt == pytest.approx(kj, rel=1e-3, abs=1e-3)
    assert abs(float(tmarg.kld_gaussian_info(torch.as_tensor(Ap), torch.as_tensor(Ap)))) < 1e-3


def test_f64_dense_replay_gradient_is_bounded_by_the_residual(stressed):
    """The float64 chain forms H and g from the same float32 Jacobians and
    residuals, all products in float64, so g lies in the range of H and the
    replayed residual r = Lam^-1/2 U^T g_k can never exceed the whitened
    residual it condenses.  (With the reprojection blocks formed in float32,
    g leaves that range by rounding, the 1e-12 rank threshold keeps
    directions whose eigenvalue is rounding noise, and 1/sqrt(lam) blows the
    noise up: a VIO run then diverged at its sixth roll.)"""
    _, targs = stressed
    state, obs, rig, imu, priors = targs
    opts = tba.BAOptions()
    P = priors.P
    dim = 2 * D + 6 * P
    blanket = tmarg.partition_blanket(state, obs, priors, P)
    r_small = tmarg._marg_dense_residuals(state, imu, priors, opts, blanket, torch.zeros(dim))
    r, _, _, _, w = tmarg._reproj_terms(state, obs, rig, opts)
    total = float(torch.sqrt((r_small.double() ** 2).sum()
                             + (w[0].double()[..., None] * r[0].double() ** 2).sum()))
    pt, _ = tmarg.marginalize(*targs, opts, vio=True, sparsify=False, f64=True)
    assert float(pt.dn_r.double().norm()) <= total * (1 + 1e-3) + 1e-4
    # the reprojection blocks are formed in the type that is asked for
    _, g_r = tmarg._reproj_h_slot0(state, obs, rig, opts, blanket, dim, P, torch.float64)
    assert g_r.dtype == torch.float64
