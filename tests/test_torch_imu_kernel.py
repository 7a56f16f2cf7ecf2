"""The wrapper of the IMU preintegration kernel (``models/imu.py:preintegrate``)
on the CPU: CPU tensors take the plain loop and give, bit for bit, what the
frozen plain copy of the loop in ``portbench/reference`` gives; the checks
of what the kernel takes raise on the CPU as they would on the card.  The
kernel itself runs only on the card (``chip_smoke.py``'s ``phase_parallel``
holds it to ``preintegrate_ref`` on every field)."""

import numpy as np
import pytest
import torch

from portbench.reference.models import imu as frozen
from sadvio_tpu_torch.models import imu

CAP = 32  # StereoSLAM.IMU_CAP


def _samples(n, seed=3):
    """n samples at 200 Hz, packed as ``StereoSLAM._pack_imu`` packs them:
    (batches, CAP, 7) [acc, gyr, dt], dt = 0 on the padding rows."""
    rng = np.random.default_rng(seed)
    out = np.zeros((-(-n // CAP), CAP, 7), np.float32)
    flat = out.reshape(-1, 7)
    flat[:n, 0:3] = rng.normal(0.0, 2.0, (n, 3)) + [0.0, 0.0, 9.81]
    flat[:n, 3:6] = rng.normal(0.0, 0.5, (n, 3))
    flat[:n, 6] = 0.005
    return torch.from_numpy(out)


def _bias():
    return torch.tensor([0.05, -0.02, 0.03]), torch.tensor([1e-3, 2e-3, -1e-3])


def _plain_route(mod):
    """Two chained 32-row batches (33 samples, as ``_accumulate_imu`` makes
    them), the second from a non-identity start, then one unpadded call
    from none."""
    params = imu.ImuParams.euroc()  # both modules read its two noise densities
    ba, bg = _bias()
    pre = mod.Preintegration.identity().replace(ba_lin=ba, bg_lin=bg)
    for batch in _samples(33):
        pre = mod.preintegrate(batch[:, 0:3], batch[:, 3:6], batch[:, 6], pre.ba_lin,
                               pre.bg_lin, params, init=pre)
    flat = _samples(10)[0, :10]
    one = mod.preintegrate(flat[:, 0:3].contiguous(), flat[:, 3:6].contiguous(),
                           flat[:, 6].contiguous(), ba, bg, params)
    return pre, one


def _call(**change):
    """One call of the wrapper on a padded batch with one input replaced."""
    batch = _samples(10)[0]
    ba, bg = _bias()
    kw = dict(acc=batch[:, 0:3], gyr=batch[:, 3:6], dt=batch[:, 6], ba=ba, bg=bg,
              params=imu.ImuParams.euroc(), init=imu.Preintegration.identity())
    kw.update({k: f(kw) for k, f in change.items()})
    return imu.preintegrate(**kw)


_BAD = {
    "float64_acc": (TypeError, dict(acc=lambda kw: kw["acc"].double())),
    "int_dt": (TypeError, dict(dt=lambda kw: kw["dt"].int())),
    "float64_init": (TypeError, dict(init=lambda kw: kw["init"].replace(
        cov=kw["init"].cov.double()))),
    "acc_four_columns": (ValueError, dict(acc=lambda kw: torch.zeros(CAP, 4))),
    "dt_as_a_column": (ValueError, dict(dt=lambda kw: kw["dt"][:, None])),
    "gyr_short": (ValueError, dict(gyr=lambda kw: kw["gyr"][:-1])),
    "batched_bias": (ValueError, dict(ba=lambda kw: kw["ba"][None])),
    "init_cov_3x3": (ValueError, dict(init=lambda kw: kw["init"].replace(
        cov=torch.zeros(3, 3)))),
    "acc_columns_strided": (ValueError, dict(acc=lambda kw: kw["acc"].T.contiguous().T)),
    "init_dR_transposed": (ValueError, dict(init=lambda kw: kw["init"].replace(
        dR=torch.randn(3, 3).T))),
    "meta_device": (ValueError, dict(**{k: (lambda kw, k=k: kw[k].to("meta"))
                                        for k in ("acc", "gyr", "dt", "ba", "bg")},
                                     init=lambda kw: None)),
}


@pytest.mark.parametrize("case", ["cpu_plain_loop", *_BAD])
def test_preintegrate_wrapper(case):
    if case == "cpu_plain_loop":
        launches = imu.preintegrate.launches
        for got, want in zip(_plain_route(imu), _plain_route(frozen)):
            for f in ("dR", "dv", "dp", "cov", "J_dR_bg", "J_dv_ba", "J_dv_bg", "J_dp_ba",
                      "J_dp_bg", "dt", "ba_lin", "bg_lin"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert float(got.dt) == pytest.approx(0.05) and imu.preintegrate.launches == launches
        return
    err, change = _BAD[case]
    with pytest.raises(err, match="preintegrate"):
        _call(**change)
