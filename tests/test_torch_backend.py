"""Window BA, marginalization and VIInit of the port against the JAX package.

Tolerances, with reasons:
* BA normal equations: relative Frobenius 1e-4 (float32, one jacfwd on
  each side, different reduction order); solved states after 10 LM
  iterations: 1e-4 m / 1e-4 rad.
* Marginalization on a stressed VIO window (a 1e8-information prior beside
  ~1 vision information): prior blocks are compared as information
  matrices W^T W, relative to their own norm, 1e-2 -- the QR and eigh work
  at float32 precision of the largest entries, so small entries carry
  absolute error ~1e-7 of the largest.  Slots and masks must be identical.
* VIInit: gravity/bias/velocity 1e-3 (a 20-iteration damped GN in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sadvio_tpu.backend import ba as jba, marginalization as jmarg, viinit as jvi
from sadvio_tpu.data.window import ImuChain as JImuChain
from sadvio_tpu_torch.backend import ba as tba, marginalization as tmarg, viinit as tvi
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.data.window import ImuChain as TImuChain

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_problem(jprob):
    p = _np(jprob)
    return tba.BAProblem(from_numpy(p.state), from_numpy(p.obs), from_numpy(p.rig),
                         from_numpy(p.imu), from_numpy(p.priors),
                         torch.as_tensor(np.array(p.fixed_mask)), bool(p.opt_lmk_only))


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def problems():
    """__graft_entry__._tiny_problem (K=4, L=64) with a seeded perturbation."""
    from sadvio_tpu.utils import geometry as jgeo

    jp = graft._tiny_problem(K=4, C=2, L=64, P=8, seed=0)
    rng = np.random.default_rng(5)
    dp = (rng.standard_normal((4, 6)) * 0.02).astype(np.float32)
    dp[0] = 0.0
    R, t = jgeo.pose_retract(jp.state.R, jp.state.t, jnp.asarray(dp))
    lmk = jp.state.lmk + jnp.asarray(rng.standard_normal((64, 3)) * 0.05, jnp.float32)
    jp = jp._replace(state=jp.state.replace(R=R, t=t, lmk=lmk))
    return jp, _port_problem(jp)


@pytest.fixture(scope="module")
def jax_lin(problems):
    return jba._linearize(problems[0], jba.BAOptions())


def test_linearization_matches(problems, jax_lin):
    jp, tp = problems
    lj = jax_lin
    lt = tba._linearize(tp, tba.BAOptions())
    for name in ("Hll", "bl", "Hpl", "Hpp", "bp", "H", "b"):
        assert _rel(getattr(lt, name).numpy(), getattr(lj, name)) < 1e-4, name
    assert abs(float(lt.cost) - float(lj.cost)) < 1e-4 * float(lj.cost)
    rj = jba.robust_cost(jp, jba.BAOptions())
    assert abs(float(tba.robust_cost(tp, tba.BAOptions())) - float(rj)) < 1e-4 * float(rj)


def test_lm_step_matches(problems, jax_lin):
    """One damped Schur solve (free mask, damping, back-substitution): the
    step is compared relative to its own norm at 1e-3, since the Cholesky
    solve amplifies the 1e-4 normal-equation differences by the damped
    system's condition number."""
    jp, tp = problems
    free_j, free_t = jba._free_mask(jp), tba._free_mask(tp)
    np.testing.assert_array_equal(free_t.numpy(), np.asarray(free_j))
    dj, lj, okj = jba._solve_from_lin(jax_lin, jp, jba.BAOptions(), free_j, 1e-3)
    dt, lt, okt = tba._lm_step(tp, tba.BAOptions(), free_t, torch.tensor(1e-3))
    assert bool(okj) and bool(okt)
    assert _rel(dt.numpy(), dj) < 1e-3
    assert _rel(lt.numpy(), lj) < 1e-3


def test_ba_solve_matches(problems):
    jp, tp = problems
    sj, stj = jba.ba_solve(jp, jba.BAOptions(iters=10))
    st, stt = tba.ba_solve(tp, tba.BAOptions(iters=10))
    np.testing.assert_allclose(st.R.numpy(), np.asarray(sj.R), atol=1e-4)
    np.testing.assert_allclose(st.t.numpy(), np.asarray(sj.t), atol=1e-4)
    np.testing.assert_allclose(st.lmk.numpy(), np.asarray(sj.lmk), atol=1e-3)
    np.testing.assert_allclose(st.v.numpy(), np.asarray(sj.v), atol=1e-4)
    assert float(stt["cost"]) < 1e-2 * float(stt["cost0"])
    np.testing.assert_array_equal(stt["accepted"].numpy(), np.asarray(stj["accepted"]))


def _stressed():
    from tests.test_ba import K
    from tests.test_marg_conditioning import _stressed_blanket

    gt, obs, rig, priors = _stressed_blanket(np.random.default_rng(0))
    return gt, obs, rig, JImuChain.create(K), priors


def _info(W):
    W = np.asarray(W, np.float64)
    return np.swapaxes(W, -1, -2) @ W


@pytest.mark.parametrize("vio", [True, False])
def test_marginalize_matches_on_stressed_window(vio):
    gt, obs, rig, imu, priors = _stressed()
    pj, ij = jmarg.marginalize(gt, obs, rig, imu, priors, jba.BAOptions(), vio=vio)
    args = [from_numpy(x) for x in _np((gt, obs, rig, imu, priors))]
    pt, it = tmarg.marginalize(*args, tba.BAOptions(), vio=vio)
    for name in ("prior_slots", "prior_slot_mask", "plp_mask", "sp_mask", "lp_mask", "ll_mask"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                                      err_msg=name)
    for name in ("marg_lmk", "lonely", "keep_mask"):
        np.testing.assert_array_equal(it[name].numpy(), np.asarray(ij[name]))
    assert _rel(it["Ak"].numpy(), ij["Ak"]) < 1e-2
    if vio:
        assert _rel(_info(pt.sp_sqrt_info[1].numpy()), _info(pj.sp_sqrt_info[1])) < 1e-2
        m = np.asarray(pj.plp_mask)
        assert m.any()
        np.testing.assert_allclose(pt.plp_val.numpy()[m], np.asarray(pj.plp_val)[m], atol=1e-5)
        for a, b in zip(_info(pt.plp_sqrt_info.numpy())[m], _info(pj.plp_sqrt_info)[m]):
            assert _rel(a, b) < 1e-2
    else:
        m = np.asarray(pj.ll_mask)
        assert m.sum() >= 1
        np.testing.assert_array_equal(pt.ll_a.numpy()[m], np.asarray(pj.ll_a)[m])
        np.testing.assert_array_equal(pt.ll_b.numpy()[m], np.asarray(pj.ll_b)[m])
        for a, b in zip(_info(pt.ll_sqrt_info.numpy())[m], _info(pj.ll_sqrt_info)[m]):
            assert _rel(a, b) < 1e-2
        lm = np.asarray(pj.lp_mask)
        assert _rel(_info(pt.lp_sqrt_info.numpy())[lm], _info(pj.lp_sqrt_info)[lm]) < 1e-2
    # the new prior vanishes at the linearization point in both packages
    rt = tba._dense_residuals(args[0], args[3], pt, tba.BAOptions()).numpy()
    assert np.isfinite(rt).all() and np.abs(rt).max() < 2e-2
    # and the shifted priors agree
    sj, st = jmarg.shift_priors(pj), tmarg.shift_priors(pt)
    for name in ("sp_mask", "plp_frame", "dn_frame"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)))
    np.testing.assert_allclose(st.sp_t.numpy(), np.asarray(sj.sp_t), atol=1e-6)


def test_gauge_transform_priors_matches(rng):
    from sadvio_tpu.data.window import PriorSet as JPriorSet
    from sadvio_tpu.utils import geometry as jgeo

    K, P = 4, 6
    pr = JPriorSet.create(K, P)
    fields = {f: jnp.asarray(rng.standard_normal(getattr(pr, f).shape), jnp.float32)
              for f in ("sp_t", "sp_v", "sp_sqrt_info", "lp_val", "lp_sqrt_info", "plp_val",
                        "plp_sqrt_info", "ll_val", "ll_sqrt_info", "dn_J", "dn_t", "dn_v",
                        "dn_lmk")}
    pr = pr.replace(**fields)
    R_align = jgeo.so3_exp(jnp.asarray([0.1, -0.2, 0.3], jnp.float32))
    gj = jmarg.gauge_transform_priors(pr, R_align, 1.3)
    gt = tmarg.gauge_transform_priors(from_numpy(_np(pr)), torch.as_tensor(np.array(R_align)),
                                      1.3)
    for f in fields:
        np.testing.assert_allclose(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)


def test_vi_init_matches():
    from tests.test_viinit_eskf import K, make_imu_world

    R_kf, t_kf, chain, _, _, _ = make_imu_world(np.random.default_rng(0))
    oj = jvi.vi_init(R_kf, t_kf, jnp.ones((K,), bool), chain, iters=20)
    tchain = TImuChain(pre=from_numpy(_np(chain.pre)), mask=torch.as_tensor(np.array(chain.mask)))
    ot = tvi.vi_init(torch.as_tensor(np.array(R_kf)), torch.as_tensor(np.array(t_kf)),
                     torch.ones(K, dtype=torch.bool), tchain, iters=20)
    assert bool(ot["converged"]) and bool(oj["converged"])
    for k in ("R_align", "g_dir", "ba", "bg", "v"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), atol=1e-3, err_msg=k)
    a_j = jvi.apply_alignment(_np_state(K), oj["R_align"], oj["scale"])
    a_t = tvi.apply_alignment(from_numpy(_np(_np_state(K))), ot["R_align"], ot["scale"])
    np.testing.assert_allclose(a_t.t.numpy(), np.asarray(a_j.t), atol=1e-3)


def _np_state(K):
    from sadvio_tpu.data.window import WindowState

    rng = np.random.default_rng(1)
    s = WindowState.create(K, 8)
    return s.replace(t=jnp.asarray(rng.standard_normal((K, 3)), jnp.float32),
                     lmk=jnp.asarray(rng.standard_normal((8, 3)), jnp.float32))
