"""The PyTorch port imports without JAX and without the JAX package.

Each module of the port is imported in a fresh interpreter, which must end
with neither ``jax`` nor ``sadvio_tpu`` (or any submodule) loaded.
"""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "sadvio_tpu_torch",
    "sadvio_tpu_torch.utils.geometry",
    "sadvio_tpu_torch.utils.struct",
    "sadvio_tpu_torch.models.cameras",
    "sadvio_tpu_torch.models.imu",
    "sadvio_tpu_torch.data.window",
    "sadvio_tpu_torch.data.convert",
    "sadvio_tpu_torch.pipeline.config",
    "sadvio_tpu_torch.frontend.detect",
    "sadvio_tpu_torch.ops.klt_kernel",
    "sadvio_tpu_torch.frontend.klt",
    "sadvio_tpu_torch.frontend.match",
    "sadvio_tpu_torch.frontend.epipolar",
    "sadvio_tpu_torch.frontend.triangulate",
    "sadvio_tpu_torch.frontend.pnp",
    "sadvio_tpu_torch.frontend.eskf",
    "sadvio_tpu_torch.backend.factors",
    "sadvio_tpu_torch.backend.ba",
    "sadvio_tpu_torch.backend.marginalization",
    "sadvio_tpu_torch.backend.viinit",
    "sadvio_tpu_torch.backend.posegraph",
    "sadvio_tpu_torch.data.globalmap",
    "sadvio_tpu_torch.mesh.mesh",
    "sadvio_tpu_torch.pipeline.synthetic",
    "sadvio_tpu_torch.pipeline.slam",
    "sadvio_tpu_torch.frontend.nofov",
    "sadvio_tpu_torch.pipeline.mono",
    "sadvio_tpu_torch.pipeline.nofov_mode",
]

_PROBE = """
import sys
import {mod}
import sadvio_tpu_torch
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sadvio_tpu'))
assert not bad, bad
import torch
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
"""


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_without_jax(mod):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(mod=mod)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    """On a CPU tensor lk_iterate is the plain version: no kernel launch."""
    from sadvio_tpu_torch.ops import klt_kernel

    g = torch.Generator().manual_seed(0)
    img = torch.rand((40, 60), generator=g) * 100
    N, S = 5, 11
    T = torch.rand((N, S, S), generator=g)
    uv = torch.full((N, 2), 25.0)
    nrm = torch.tensor([[1.0, 0.0, 1.0, 1.0]]).repeat(N, 1)
    before = klt_kernel.lk_iterate.launches
    out = klt_kernel.lk_iterate(img, uv, T, T, T, nrm, iters=3)
    ref = klt_kernel.lk_iterate_ref(img, uv, T, T, T, nrm, iters=3)
    assert torch.equal(out, ref)
    assert klt_kernel.lk_iterate.launches == before


@pytest.mark.parametrize("bad", ["dtype", "patch", "device", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    from sadvio_tpu_torch.ops import klt_kernel

    N, S = 4, 11
    args = dict(img1=torch.zeros((40, 60)), uv_init=torch.zeros((N, 2)),
                T=torch.zeros((N, S, S)), gx=torch.zeros((N, S, S)),
                gy=torch.zeros((N, S, S)), nrm=torch.zeros((N, 4)))
    if bad == "dtype":
        args["img1"] = args["img1"].double()
    elif bad == "patch":
        for k in ("T", "gx", "gy"):
            args[k] = torch.zeros((N, 17, 17))
    elif bad == "device":
        # a tensor that is neither on the CPU nor on a CUDA card
        args = {k: v.to("meta") for k, v in args.items()}
    else:
        args["nrm"] = torch.zeros((N, 3))
    with pytest.raises((TypeError, ValueError)):
        klt_kernel.lk_iterate(*args.values(), iters=2)
