"""The PyTorch port imports without JAX and without the JAX package.

Each module of the port is imported in a fresh interpreter, which must end
with neither ``jax`` nor ``sadvio_tpu`` (or any submodule) loaded.  Every
top-level function and class of each ``sadvio_tpu/**/*.py`` has a
counterpart of the same name in the port's file of the same path, but the
private helpers listed in ``FOLDED`` with the port code that does their
work (read from the sources, nothing imported).
"""

import ast
import os
import pathlib
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
    "sadvio_tpu_torch.frontend.lines",
    "sadvio_tpu_torch.frontend.edgelets",
    "sadvio_tpu_torch.frontend.ellipses",
    "sadvio_tpu_torch.frontend.bbox",
    "sadvio_tpu_torch.frontend.csv_keypoints",
    "sadvio_tpu_torch.frontend.descriptors",
    "sadvio_tpu_torch.pipeline.channels",
    "sadvio_tpu_torch.pipeline.line_channel",
    "sadvio_tpu_torch.utils.profiler",
    "sadvio_tpu_torch.utils.checkpoint",
    "sadvio_tpu_torch.parallel.pipeline_parallel",
    "sadvio_tpu_torch.parallel.sharding",
    "sadvio_tpu_torch.parallel.multiseq",
    "sadvio_tpu_torch.parallel.time_sharding",
    "sadvio_tpu_torch.pipeline.euroc",
    "sadvio_tpu_torch.pipeline.native_io",
    "sadvio_tpu_torch.pipeline.online",
    "sadvio_tpu_torch.run_euroc",
    "sadvio_tpu_torch.ros2_node",
    "sadvio_tpu_torch.tools.compare_euroc",
    "sadvio_tpu_torch.tools.visualize",
]

# private helpers of the JAX package that the port has under no such name
FOLDED = {
    "backend/marginalization.py": {
        "_np_sym64": "the symmetrization inside _eigh (float64 tensors, no numpy round trip)",
        "_np_rr_pinv64": "rr_pinv64: rank_revealing_pinv in float64 at 1e-12",
        "_np_pinv_sqrt64": "pinv_sqrt64: pinv_sqrt in float64 at 1e-12",
    },
    "frontend/bbox.py": {"_center": "inlined in triangulate_bbox (0.5 * (lo + hi))"},
    "frontend/descriptors.py": {
        "_pack_bits": "none needed: descriptors stay (N,256) bool rows; "
                      "data/convert.py:unpack_descriptors reads the JAX package's words",
    },
    "frontend/ellipses.py": {"_pool": "_max_pool (F.max_pool2d; the min as -max(-x))"},
    "frontend/klt.py": {
        "_patch_coords": "ops/klt_kernel.py:_patches (bilinear taps) and the CUDA kernels",
        "_template_ws": "ops/klt_kernel.py:_template_ws",
        "_iterate_batched": "ops/klt_kernel.py:lk_iterate / lk_iterate_ref",
        "_track_level": "ops/klt_kernel.py:track_levels (engine='levels') and lk_track",
    },
    "ops/klt_kernel.py": {
        "_lk_kernel": "ops/csrc/lk_iterate.cu, redesigned as ops/csrc/lk_track.cu",
    },
    "pipeline/slam.py": {"_cam0": "rig.cam.camera(0)", "_cam": "rig.cam.camera(c)"},
}


def _top_level(path, with_imports=False):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif with_imports and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif with_imports and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def test_every_function_of_the_jax_package_has_a_counterpart():
    jax_root = pathlib.Path(REPO, "sadvio_tpu")
    port_root = pathlib.Path(REPO, "sadvio_tpu_torch")
    missing, folded = {}, {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        port = port_root / rel
        assert port.exists(), f"no port of sadvio_tpu/{rel}"
        gone = _top_level(path) - _top_level(port, with_imports=True)
        public = sorted(n for n in gone if not n.startswith("_"))
        private = {n for n in gone if n.startswith("_")}
        if public:
            missing[rel] = public
        if private:
            folded[rel] = private
    assert not missing, missing
    assert folded == {k: set(v) for k, v in FOLDED.items()}


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
