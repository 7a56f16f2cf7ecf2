"""The port's captured stages (``utils/graphs.py``) on the CPU.

The CPU runs the stages eagerly, so these tests check what a CUDA graph
needs of them rather than the capture itself (``python3 chip_smoke.py``
holds the captured path against the eager one on the card):

* no stage of the main path (stereo VIO, marginalization and
  sparsification on, the fused LK engine) reads a device value on the host,
  copies host data to the device, checks a ``torch.linalg`` error code on
  the host or makes a tensor whose shape depends on the data: a
  ``TorchDispatchMode`` sees every op of each stage of a CPU run that
  reaches VIInit and a window roll, with the marginalization's eigen
  decomposition on the card's route (``jacobi_eig``);
* the IMU samples of a frame go through the fixed-shape padded batches
  (``IMU_CAP`` rows, dt = 0 padding) as the JAX package's ``_pack_imu`` and
  ``_preint`` take them, and agree with them and with the port's earlier
  per-sample preintegration: dp, dv and dR within 1e-6 abs, cov within
  1e-5 of its largest entry (float32 on both sides, sums in another
  order; padding rows are exact no-ops);
* ``jacobi_eig`` agrees with LAPACK's eigendecomposition.
"""

from collections import Counter, namedtuple

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sadvio_tpu.models import imu as jimu
from sadvio_tpu.pipeline import synthetic as jsyn
from sadvio_tpu.pipeline.config import Capacities, SLAMConfig
from sadvio_tpu.pipeline.slam import StereoSLAM as JSLAM
from sadvio_tpu_torch.backend import marginalization as marg
from sadvio_tpu_torch.data.convert import from_numpy
from sadvio_tpu_torch.models import imu as timu
from sadvio_tpu_torch.pipeline import synthetic as tsyn
from sadvio_tpu_torch.pipeline.config import SLAMConfig as TSLAMConfig
from sadvio_tpu_torch.pipeline.slam import StereoSLAM
from sadvio_tpu_torch.utils import graphs

torch.set_num_threads(2)

CAPS = dict(K=4, L=160, P=24, pyr_levels=3, klt_radius=5)
# the main path at test size: VIInit at frame 8, the first window roll at 16
MAIN_CFG = dict(slam_mode="bimonovio", max_kf_number=5, min_lmk_number=25,
                max_movement_parallax=0.5, min_movement_parallax=0.02,
                marginalization=True, sparsification=True)
N_FRAMES = 18
CAPTURED = ("_preint", "_predict_cv", "_predict_imu", "_pyramids", "_frontend", "_insert_kf",
            "_backend", "_marg_roll")

# ops that read a device value on the host, check linalg errors there, make
# data-dependent shapes, or carry host data into the stage
_HOST = {"_local_scalar_dense", "_linalg_check_errors", "nonzero", "masked_select",
         "_linalg_eigh", "_linalg_svd", "linalg_eig", "lift_fresh", "lift_fresh_copy"}


class _HostSyncs(TorchDispatchMode):
    """Counts, per op name, the ops of the stage that a CUDA graph cannot
    capture; a bool index is a data-dependent shape too."""

    def __init__(self, found: Counter):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        bad = name in _HOST or name.startswith(("unique", "_unique"))
        if name in ("index", "index_put", "index_put_"):
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                      for i in args[1] if i is not None)
        if bad:
            self.found[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def main_run():
    world = tsyn.make_world(seed=3, n_frames=N_FRAMES, width=320, height=240, n_points=200,
                            device="cpu")
    slam = StereoSLAM(world.rig, TSLAMConfig(**MAIN_CFG, caps=Capacities(**CAPS)),
                      imu_params=world.imu_params, device="cpu")
    calls, found = Counter(), {name: Counter() for name in CAPTURED}
    for name in CAPTURED:
        method = getattr(slam, name)

        def watched(*a, _m=method, _n=name, **k):
            calls[_n] += 1
            with _HostSyncs(found[_n]):
                return _m(*a, **k)

        setattr(slam, name, watched)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(marg, "sym_eig", marg.jacobi_eig)  # the card's route
        slam.run(world.frames)
    return dict(slam=slam, calls=calls, found=found)


def test_main_path_run_reaches_vi_init_and_a_roll(main_run):
    slam = main_run["slam"]
    assert slam.vi_initialized and len(slam.archived_kf) >= 1
    assert bool(slam.priors.sp_mask.any())


@pytest.mark.parametrize("stage", CAPTURED)
def test_main_path_stage_makes_no_host_sync(main_run, stage):
    assert getattr(StereoSLAM, stage).captured  # a stage of utils/graphs.py
    assert main_run["calls"][stage] > 0, f"{stage} never ran"
    assert not main_run["found"][stage], f"{stage}: {dict(main_run['found'][stage])}"


# ----------------------------------------------------------------------
# fixed-shape IMU batches
# ----------------------------------------------------------------------

Frame = namedtuple("Frame", "acc gyr dt")


@pytest.fixture(scope="module")
def imu_pipes():
    wj = jsyn.make_world(seed=3, n_frames=2, width=64, height=48, n_points=20)
    cfg = SLAMConfig(slam_mode="bimonovio", caps=Capacities(**CAPS))
    js = JSLAM(wj.rig, cfg, imu_params=wj.imu_params)
    ts = StereoSLAM(from_numpy(jax.tree.map(np.asarray, wj.rig), "cpu"),
                    TSLAMConfig(slam_mode="bimonovio", caps=Capacities(**CAPS)),
                    imu_params=from_numpy(jax.tree.map(np.asarray, wj.imu_params)),
                    device="cpu")
    return js, ts


def _samples(n, seed):
    r = np.random.default_rng(seed)
    acc = (np.array([0.3, -0.2, 9.81]) + 0.5 * r.normal(size=(n, 3))).astype(np.float32)
    gyr = (0.3 * r.normal(size=(n, 3))).astype(np.float32)
    dt = np.full(n, 0.005, np.float32) * (1.0 + 0.1 * r.uniform(size=n)).astype(np.float32)
    return Frame(acc, gyr, dt)


@pytest.mark.parametrize("n", [0, 1, 10, 32, 33, 70])
def test_padded_imu_batches_match_jax(imu_pipes, n):
    js, ts = imu_pipes
    frame = _samples(n, seed=n)
    ba, bg = np.array([0.05, -0.02, 0.03], np.float32), np.array([1e-3, 2e-3, -1e-3], np.float32)

    pre_j = jimu.Preintegration.identity().replace(ba_lin=ba, bg_lin=bg)
    for batch, _ in js._pack_imu(frame):
        pre_j = js._preint(batch, pre_j)
    pre_j = jax.tree.map(np.asarray, pre_j)

    pre0 = timu.Preintegration.identity().replace(ba_lin=torch.from_numpy(ba),
                                                  bg_lin=torch.from_numpy(bg))
    ts.pre_cur, ts._imu_n = pre0, 0
    ts._accumulate_imu(frame)
    assert ts._imu_n == n
    assert ts._pack_imu(frame).shape == (-(-n // StereoSLAM.IMU_CAP), StereoSLAM.IMU_CAP, 7)
    pre_t = ts.pre_cur
    # the port's earlier route: every sample in one unpadded buffer
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32).reshape(-1, *np.shape(x)[1:]))
    pre_old = (timu.preintegrate(t(frame.acc), t(frame.gyr), t(frame.dt), pre0.ba_lin,
                                 pre0.bg_lin, ts.imu_params, init=pre0) if n else pre0)

    keys = ("dp", "dv", "dR", "dt", "cov")
    refs = ({k: np.asarray(getattr(pre_j, k)) for k in keys},
            {k: getattr(pre_old, k).numpy() for k in keys})
    for ref in refs:
        for k in keys[:-1]:
            np.testing.assert_allclose(getattr(pre_t, k).numpy(), ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        cov_ref = ref["cov"]
        scale = max(float(np.abs(cov_ref).max()), 1e-30)
        assert np.abs(pre_t.cov.numpy() - cov_ref).max() <= 1e-5 * scale


# ----------------------------------------------------------------------
# the capturable eigendecomposition and the graph keys
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((6, 6), torch.float64), ((87, 87), torch.float32),
                                         ((24, 3, 3), torch.float32), ((30, 30), torch.float64)])
def test_jacobi_eig_matches_lapack(shape, dtype):
    r = np.random.default_rng(sum(shape))
    n = shape[-1]
    Q = np.linalg.qr(r.normal(size=shape))[0]
    lam = np.logspace(-5, 1, n) * r.choice([1.0, 1.0, 1.0, -1.0], size=(*shape[:-2], n))
    A = torch.from_numpy((Q * lam[..., None, :]) @ np.swapaxes(Q, -1, -2)).to(dtype)
    A = 0.5 * (A + A.transpose(-1, -2))
    found = Counter()
    with _HostSyncs(found):
        lam_j, U = marg.jacobi_eig(A)
    assert not found, dict(found)
    ref = torch.linalg.eigvalsh(A.double())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = float(ref.abs().max())
    assert (lam_j.double().sort(-1).values - ref).abs().max() <= tol * scale
    eye = torch.eye(n, dtype=torch.float64)
    assert (U.double().transpose(-1, -2) @ U.double() - eye).abs().max() <= 100 * tol
    rec = (U.double() * lam_j.double()[..., None, :]) @ U.double().transpose(-1, -2)
    assert (rec - A.double()).abs().max() <= 10 * tol * scale


def test_graph_key_holds_structure_and_scalars():
    from sadvio_tpu_torch.data.window import WindowState

    w = WindowState.create(4, 8)
    leaves = []
    spec = graphs._flatten(((w, None, (torch.zeros(3), 2)), {"vio": True}), leaves)
    w_leaves = []
    graphs._flatten(w, w_leaves)
    assert len(leaves) == len(w_leaves) + 1
    back = graphs._unflatten(spec, iter(leaves))
    assert back[1] == {"vio": True} and back[0][1] is None and back[0][2][1] == 2
    assert isinstance(back[0][0], WindowState) and back[0][0].R is w.R
    # a shape, a dtype, an optional argument or a flag makes another variant
    other = [((w, None, (torch.zeros(4), 2)), {"vio": True}),
             ((w, None, (torch.zeros(3, dtype=torch.float64), 2)), {"vio": True}),
             ((w, torch.zeros(1), (torch.zeros(3), 2)), {"vio": True}),
             ((w, None, (torch.zeros(3), 2)), {"vio": False})]
    assert len({spec, *(graphs._flatten(o, []) for o in other)}) == 5
    with pytest.raises(TypeError):
        graphs._flatten(object(), [])


def test_stages_run_plainly_on_the_cpu(imu_pipes):
    _, ts = imu_pipes
    img = torch.rand(2, 48, 64)
    with graphs.eager():
        pyr_e = ts._pyramids(img)
    pyr = ts._pyramids(img)
    assert not ts.graphs.variants  # nothing is captured off the card
    for a, b in zip(pyr, pyr_e):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
