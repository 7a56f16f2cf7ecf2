"""Associative and time-sharded IMU preintegration of the port against the
JAX package (``sadvio_tpu/models/imu.py:147-325``,
``sadvio_tpu/parallel/time_sharding.py``).

Inputs: tests/test_time_sharding.py's stream (seeded numpy, 200 Hz), with
and without a 37-sample zero-dt tail.  Tolerances: tests/test_time_sharding.py's
``_check_equal`` (dR 3e-6, dv/dp 1e-5, dt 1e-6, covariance rtol 2e-4 with
an atol of 2e-4 of its largest entry, bias Jacobians rtol 2e-4 atol 2e-6)
for each pair of preintegrations; the summaries' extra products M9, M15 at
the same rtol 2e-4 with atol 2e-4 of their largest entry.  The sharded
version runs on 2 spawned gloo ranks against the JAX package's over
``make_time_mesh(2)``.
"""

import jax
import numpy as np
import pytest
import torch

from sadvio_tpu.models import imu as jimu
from sadvio_tpu.parallel import time_sharding as jts
from sadvio_tpu_torch.models import imu as timu
from tests.test_time_sharding import _check_equal, _stream
from tests.test_torch_sharding import spawn

torch.set_num_threads(2)

BA = np.array([0.02, -0.01, 0.03], np.float32)
BG = np.array([0.001, 0.002, -0.001], np.float32)
N_SHARDED = 256

WORKER = r"""
import numpy as np
import torch
import torch.distributed as dist

rank, world, (d, *pads) = join_group()  # defined ahead of this source by tests/torch_ranks.py
torch.set_num_threads(1)
from sadvio_tpu_torch.models import imu
from sadvio_tpu_torch.parallel import time_sharding

mesh = time_sharding.make_time_mesh(2)
for pad in pads:
    inp = np.load(f"{d}/stream_{pad}.npz")
    t = {k: torch.as_tensor(inp[k]) for k in inp.files}
    pre = time_sharding.preintegrate_time_sharded(t["acc"], t["gyr"], t["dt"], t["ba"], t["bg"],
                                                  imu.ImuParams.euroc(), mesh)
    torch.save(pre, f"{d}/pre_{pad}_{rank}.pt")
try:
    time_sharding.preintegrate_time_sharded(t["acc"][:-1], t["gyr"][:-1], t["dt"][:-1],
                                            t["ba"], t["bg"], imu.ImuParams.euroc(), mesh)
    raise SystemExit("an indivisible sample count was accepted")
except ValueError:
    pass
dist.destroy_process_group()
"""


def _torch(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _np_pre(pre):
    """A port Preintegration as the namespace _check_equal reads."""
    return type("P", (), {k: np.asarray(getattr(pre, k)) for k in (
        "dR", "dv", "dp", "dt", "cov", "J_dR_bg", "J_dv_ba", "J_dv_bg", "J_dp_ba", "J_dp_bg")})


def _check_products(a, b):
    for f in ("M9", "M15"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4 * float(np.abs(y).max()),
                                   err_msg=f)


@pytest.mark.parametrize("pad_tail", [0, 37])
def test_assoc_and_summaries_match_jax_and_sequential(rng, pad_tail):
    acc, gyr, dt = _stream(rng, 128, pad_tail)
    params_j, params_t = jimu.ImuParams.euroc(), timu.ImuParams.euroc()
    ta, tg, tdt, tba, tbg = _torch(acc, gyr, dt, BA, BG)
    seq_t = timu.preintegrate(ta, tg, tdt, tba, tbg, params_t)
    assoc_t = timu.preintegrate_assoc(ta, tg, tdt, tba, tbg, params_t)
    assoc_j = jax.jit(jimu.preintegrate_assoc)(acc, gyr, dt, BA, BG, params_j)
    _check_equal(_np_pre(seq_t), _np_pre(assoc_t))
    _check_equal(assoc_j, _np_pre(assoc_t))
    # chunk summaries and their composition, chunk by chunk
    cut = 48
    parts = [slice(0, cut), slice(cut, 128)]
    sj = [jax.jit(jimu.chunk_summary)(acc[p], gyr[p], dt[p], BA, BG, params_j) for p in parts]
    st = [timu.chunk_summary(ta[p], tg[p], tdt[p], tba, tbg, params_t) for p in parts]
    for a, b in zip(st, sj):
        _check_products(a, b)
    cj, ct = jax.jit(jimu.combine_summary)(*sj), timu.combine_summary(*st)
    _check_products(ct, cj)
    _check_equal(_np_pre(timu.summary_to_preintegration(ct, tba, tbg)),
                 jimu.summary_to_preintegration(cj, BA, BG))
    # padding samples are the scan's identities: the tail adds nothing
    if pad_tail:
        n = 128 - pad_tail
        short = timu.preintegrate_assoc(ta[:n], tg[:n], tdt[:n], tba, tbg, params_t)
        _check_equal(_np_pre(short), _np_pre(assoc_t))


def test_combine_summary_associative(rng):
    acc, gyr, dt = _stream(rng, 96)
    ta, tg, tdt = _torch(acc, gyr, dt)
    z = torch.zeros(3)
    params = timu.ImuParams.euroc()
    a, b, c = [timu.chunk_summary(ta[i:i + 32], tg[i:i + 32], tdt[i:i + 32], z, z, params)
               for i in (0, 32, 64)]
    left = timu.combine_summary(timu.combine_summary(a, b), c)
    right = timu.combine_summary(a, timu.combine_summary(b, c))
    for f in ("dR", "dv", "dp", "dt", "M9", "cov", "M15", "X"):
        np.testing.assert_allclose(getattr(left, f), getattr(right, f), rtol=2e-4, atol=1e-6,
                                   err_msg=f)
    whole = timu.chunk_summary(ta, tg, tdt, z, z, params)
    np.testing.assert_allclose(left.dp, whole.dp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(left.cov, whole.cov, rtol=2e-4,
                               atol=2e-4 * float(whole.cov.abs().max()))


@pytest.mark.parametrize("n", [1, 10, 33, 200])
def test_scan_takes_any_length(rng, n):
    """The log-depth scan is not limited to powers of two."""
    acc, gyr, dt = _stream(rng, n)
    t = _torch(acc, gyr, dt, BA, BG)
    params = timu.ImuParams.euroc()
    _check_equal(_np_pre(timu.preintegrate(*t, params)),
                 _np_pre(timu.preintegrate_assoc(*t, params)))


PADS = (0, 37)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """One spawn of 2 gloo ranks over both streams."""
    d = tmp_path_factory.mktemp("time_sharding")
    streams = {}
    for pad in PADS:
        acc, gyr, dt = _stream(np.random.default_rng(0), N_SHARDED, pad)
        streams[pad] = (acc, gyr, dt)
        np.savez(d / f"stream_{pad}.npz", acc=np.asarray(acc), gyr=np.asarray(gyr),
                 dt=np.asarray(dt), ba=BA, bg=BG)
    spawn(WORKER, 2, [d, *PADS], d)
    return {pad: (streams[pad], [torch.load(d / f"pre_{pad}_{r}.pt", weights_only=False)
                                 for r in range(2)]) for pad in PADS}


@pytest.mark.parametrize("pad_tail", PADS)
def test_time_sharded_over_two_ranks_matches_jax(sharded_runs, pad_tail):
    (acc, gyr, dt), pres = sharded_runs[pad_tail]
    for f in ("dR", "dv", "dp", "cov", "J_dR_bg", "J_dp_bg", "dt"):
        assert torch.equal(getattr(pres[0], f), getattr(pres[1], f)), f  # replicated
    params = jimu.ImuParams.euroc()
    dist_j = jts.preintegrate_time_sharded(acc, gyr, dt, BA, BG, params, jts.make_time_mesh(2))
    _check_equal(dist_j, _np_pre(pres[0]))
    _check_equal(jimu.preintegrate(acc, gyr, dt, BA, BG, params), _np_pre(pres[0]))
    seq_t = timu.preintegrate(*_torch(acc, gyr, dt, BA, BG), timu.ImuParams.euroc())
    _check_equal(_np_pre(seq_t), _np_pre(pres[0]))
