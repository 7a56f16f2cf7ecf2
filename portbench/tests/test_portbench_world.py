"""The frozen world generator: determined by its seed, and moving as the
recorded sequence its mix names."""

from __future__ import annotations

import json

import numpy as np
from conftest import HERE, small_config

from portbench import world


def _make(seed, traffic="replay", n=6):
    cfg = small_config(json.loads((HERE / "configs" / "euroc_stereo_vio.json").read_text()))
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    return world.make_world(cfg, tr, seed, n, "cpu")


def test_same_seed_same_world_other_seed_other_world():
    a, b, c = _make(2 ** 31 + 11), _make(2 ** 31 + 11), _make(5)
    for fa, fb in zip(a.frames, b.frames):
        assert np.array_equal(fa.images, fb.images) and np.array_equal(fa.acc, fb.acc)
    assert not np.array_equal(a.frames[3].images, c.frames[3].images)
    assert not np.array_equal(a.frames[3].acc, c.frames[3].acc)
    assert np.array_equal(a.gt_t, c.gt_t)  # the trajectory is the mix's, not the seed's
    f = a.frames[2]
    assert f.images.dtype == np.uint8 and f.images.shape == (2, 240, 320)
    assert f.acc.shape == (10, 3) and abs(float(np.linalg.norm(f.acc.mean(0))) - 9.81) < 0.5


def test_each_mix_moves_at_its_sequences_mean_speed_and_angular_rate():
    for path in sorted((HERE / "traffic").glob("*.json")):
        tr = json.loads(path.read_text())
        speed, rate = world.motion_stats(tr)
        assert abs(speed / tr["motion"]["mean_speed_m_s"] - 1) < 0.02, path.name
        assert abs(rate / tr["motion"]["mean_angular_rate_rad_s"] - 1) < 0.02, path.name
