"""Fixtures of the benchmark's own tests: a checkout in a temporary
directory that holds the benchmark's folder and a BENCHMARK.json with one
small cell (320x240, K=5, L=160), and the ``card`` marker for tests that need
an NVIDIA card."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


def small_config(cfg: dict) -> dict:
    """``cfg`` at 320x240 with a small window: what a CPU test run holds."""
    cfg = copy.deepcopy(cfg)
    for c in range(int(cfg["ncam"])):
        cam = cfg[f"cam{c}"]
        sx, sy = 320 / cam["resolution"][0], 240 / cam["resolution"][1]
        fx, fy, cx, cy = cam["intrinsics"]
        cam["resolution"] = [320, 240]
        cam["intrinsics"] = [fx * sx, fy * sy, cx * sx, cy * sy]
    cfg.update(name=f"small_{cfg['name']}", max_kf_number=4, min_lmk_number=25,
               max_movement_parallax=0.5)
    cfg["capacities"] = {"L": 160, "P": 24, "N_imu": 64, "pyr_levels": 3, "klt_radius": 5}
    return cfg


SMALL_TRAFFIC = {"why": "a small world on the gentle default trajectory", "n_points": 200,
                 "trajectory": "default",
                 "rot_scale": 1.0, "time_scale": 1.0, "imu_noise": True,
                 "warmup_frames_max": 80, "settle_frames": 2,
                 "max_frames_per_s": 20.0}


def make_checkout(dest: Path, configs=("euroc_stereo_vio",), limits=None) -> Path:
    """A checkout at ``dest`` with one small cell per configuration in
    ``configs``, named ``small_<config>``."""
    shutil.copytree(HERE, dest / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name in configs:
        cfg = small_config(json.loads((HERE / "configs" / f"{name}.json").read_text()))
        path = f"{HERE.name}/configs/{cfg['name']}.json"
        (dest / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "a test", "file": path,
                                 "reduced": []})
        bench["workloads"].append({"name": cfg["name"], "config": cfg["name"],
                                   "traffic": "small", "chips": 1, "why": "a test"})
        lim = limits or json.loads((HERE / "limits" / f"{name}.json").read_text())
        (dest / HERE.name / "limits" / f"{cfg['name']}.json").write_text(json.dumps(lim))
    (dest / HERE.name / "traffic" / "small.json").write_text(json.dumps(SMALL_TRAFFIC))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"
