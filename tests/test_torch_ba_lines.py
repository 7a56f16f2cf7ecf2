"""Line rows of the port's window BA against the JAX package's.

Problems of tests/test_ba_lines.py (K=4 stereo window, 16 random 3D
segments with exact projections).  Tolerances, with reasons:
* line rows: relative 1e-5 (float32 projections; measured 2.6e-6);
* normal equations with the line blocks: relative Frobenius 1e-4 (one
  jacfwd on each side, different reduction order; measured 1.2e-6);
* the 10-iteration solve of the lines-only problem: poses and endpoints
  1e-4 (both converge to the exact geometry; measured 7.6e-6).
Probation lines must contribute exactly zero pose Jacobian, and the
robust weight must carry no derivative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sadvio_tpu.backend import ba as jba
from sadvio_tpu.data.window import Observations as JObs
from sadvio_tpu_torch.backend import ba as tba
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.frontend import lines as tlines
from sadvio_tpu_torch.utils import geometry as tgeo
from tests.test_ba import C, K, L, make_world, perturb_state
from tests.test_ba_lines import _make_lines

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


def _port(jprob):
    p = _np(jprob)
    return tba.BAProblem(from_numpy(p.state), from_numpy(p.obs), from_numpy(p.rig),
                         from_numpy(p.imu), from_numpy(p.priors),
                         torch.as_tensor(np.array(p.fixed_mask)), bool(p.opt_lmk_only),
                         from_numpy(p.lines))


@pytest.fixture(scope="module")
def problems():
    """Lines-only (no point observations) and mixed (10 noisy points + 20
    noisy lines), both perturbed, as tests/test_ba_lines.py builds them."""
    rng = np.random.default_rng(0)
    gt, _, rig = make_world(rng)
    lines = _make_lines(rng, gt, rig, M=16)
    state0 = gt.replace(lmk_mask=jnp.zeros((L,), bool))
    noisy = perturb_state(rng, state0, pose_sig=0.02, lmk_sig=0.0)
    ends_n = lines.ends + jnp.asarray(rng.standard_normal(lines.ends.shape) * 0.03, jnp.float32)
    alone = jba.make_problem(noisy, JObs.create(K, C, L), rig)._replace(
        lines=lines.replace(ends=ends_n))

    gt, obs, rig = make_world(rng)
    keep = np.zeros((L,), bool)
    keep[:10] = True
    obs = obs.replace(mask=obs.mask & jnp.asarray(keep)[None, None, :],
                      uv=obs.uv + jnp.asarray(rng.standard_normal(obs.uv.shape) * 0.8,
                                              jnp.float32))
    gt_st = gt.replace(lmk_mask=gt.lmk_mask & jnp.asarray(keep))
    lines = _make_lines(rng, gt_st, rig, M=20)
    lines = lines.replace(obs=lines.obs + jnp.asarray(
        rng.standard_normal(lines.obs.shape) * 0.3, jnp.float32))
    # two of the lines on probation, so their rows go in with detached poses
    lines = lines.replace(probation=jnp.arange(20) < 2)
    noisy = perturb_state(rng, gt_st, pose_sig=0.03, lmk_sig=0.02)
    mixed = jba.make_problem(noisy, obs, rig)._replace(lines=lines)
    return {"alone": alone, "mixed": mixed}


def test_line_rows_and_normal_equations_match(problems):
    """The mixed problem (points, lines, two lines on probation); the
    lines-only problem's normal equations are exercised by its solve."""
    jp = problems["mixed"]
    tp = _port(jp)
    opts_j, opts_t = jba.BAOptions(), tba.BAOptions()
    s = jp.state
    rj = jax.jit(jba._line_residual_rows)(s.R, s.t, s.kf_mask, jp.lines.ends, jp.lines, jp.rig,
                                          opts_j)
    st = tp.state
    rt = tba._line_residual_rows(st.R, st.t, st.kf_mask, tp.lines.ends, tp.lines, tp.rig, opts_t)
    assert np.abs(np.asarray(rj)).max() > 1.0  # perturbed: the rows are not all zero
    assert _rel(rt.numpy(), rj) < 1e-5
    lj, lt = jax.jit(jba._linearize)(jp, opts_j), tba._linearize(tp, opts_t)
    assert lt.H.shape == lj.H.shape == (K * 15 + 8 * 3 + jp.lines.M * 6,) * 2
    for field in ("H", "b", "cost"):
        assert _rel(getattr(lt, field).numpy(), getattr(lj, field)) < 1e-4, field
    assert _rel(tba.robust_cost(tp, opts_t).numpy(), jax.jit(jba.robust_cost)(jp, opts_j)) < 1e-5
    np.testing.assert_array_equal(tba._free_mask(tp).numpy(),
                                  np.asarray(jax.jit(jba._free_mask)(jp)))


def test_lines_only_solve_matches(problems):
    jp = problems["alone"]
    tp = _port(jp)
    sj, stj = jba.ba_solve(jp, jba.BAOptions(iters=10))
    stt_state, stt = tba.ba_solve(tp, tba.BAOptions(iters=10))
    assert float(stt["cost"]) < float(stt["cost0"]) * 1e-3
    np.testing.assert_allclose(stt_state.t.numpy(), np.asarray(sj.t), atol=1e-4)
    np.testing.assert_allclose(stt_state.R.numpy(), np.asarray(sj.R), atol=1e-4)
    np.testing.assert_allclose(stt["line_ends"].numpy(), np.asarray(stj["line_ends"]), atol=1e-4)


def test_probation_lines_give_poses_no_jacobian(problems):
    """Every line on probation: the rows' Jacobian over the pose dims is
    exactly zero; over the endpoints it is the unweighted rows' Jacobian
    times the frozen weight (the weight has no derivative)."""
    tp = _port(problems["mixed"])
    lines = tp.lines.replace(probation=torch.ones_like(tp.lines.mask))
    st, rig, opts = tp.state, tp.rig, tba.BAOptions()
    M = lines.M

    def rows(dx, weighted=True):
        R, t = tgeo.pose_retract(st.R, st.t, dx[: K * 6].reshape(K, 6))
        ends = lines.ends + dx[K * 6:].reshape(M, 2, 3)
        if weighted:
            return tba._line_residual_rows(R, t, st.kf_mask, ends, lines, rig, opts)
        out = []
        for c in range(C):
            r, vis = tlines.line_reproj_residual(
                rig.cam.camera(c), R[:, None], t[:, None], rig.R_f_s[c], rig.t_f_s[c],
                ends[None, :, 0], ends[None, :, 1], lines.obs[:, c])
            m = lines.obs_mask[:, c] & vis & lines.mask[None, :] & st.kf_mask[:, None]
            out.append(torch.where(m[..., None], r, torch.zeros_like(r)))
        return torch.stack(out, 1).reshape(-1)

    dx0 = torch.zeros(K * 6 + M * 6)
    J = torch.func.jacfwd(rows)(dx0)
    assert J[:, : K * 6].abs().max().item() == 0.0
    assert J[:, K * 6:].abs().max().item() > 1.0
    r_w, r_u = rows(dx0), rows(dx0, weighted=False)
    w = torch.where(r_u != 0, r_w / torch.where(r_u != 0, r_u, torch.ones_like(r_u)),
                    torch.zeros_like(r_u))
    J_u = torch.func.jacfwd(lambda d: rows(d, weighted=False))(dx0)
    torch.testing.assert_close(J[:, K * 6:], w[:, None] * J_u[:, K * 6:], rtol=1e-5, atol=1e-5)
    # off probation the same rows do constrain the poses
    lines = lines.replace(probation=torch.zeros_like(lines.mask))
    assert torch.func.jacfwd(rows)(dx0)[:, : K * 6].abs().max().item() > 1.0
