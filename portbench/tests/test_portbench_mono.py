"""The monocular VIO cell at a small size on the CPU: a sound run reads
correct, and a run whose keyframe insertion triangulates wrong does not.

The small cell is ``euroc_mono_vio`` at conftest's 320x240 and L=160, with
two of the configuration's own settings kept that conftest's small cell
cuts: the 4 deg keyframe parallax and a window of 7 keyframes (the mix is
the replay mix's MH_03_medium motion, on a 200-blob wall).  Monocular VIInit
needs ``vio_init_kfs`` = 6 keyframes in the window and enough acceleration
over them to see the scale; at 0.5 deg, 5 keyframes and the gentle motion
the solve could not see it, and the pipeline refuses such a solve (ROADMAP
C11), so that cell never leaves warm-up."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import HERE, make_checkout

from portbench import cells, run as run_mod

SEED = 2 ** 32 + 29
SECONDS = 15.0  # keyframes come ~8 frames apart: a loaded CPU still gets a few in the window
CELL = "small_euroc_mono_vio"


def _born_landmarks_moved(hooks):
    """The insertion's newly triangulated landmarks 10% farther from the
    origin than it computed them."""
    fn = hooks.inner["_insert_kf"]

    def insert_kf(pyr_new, tracks, window, *a, **k):
        out = list(fn(pyr_new, tracks, window, *a, **k))
        w = out[1]
        born = (w.lmk_mask & ~window.lmk_mask)[:, None]
        out[1] = w.replace(lmk=torch.where(born, 1.1 * w.lmk, w.lmk))
        return tuple(out)

    hooks.inner["_insert_kf"] = insert_kf


@pytest.fixture(scope="module")
def mono_cell(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("checkout"), configs=("euroc_mono_vio",))
    folder = root / HERE.name
    path = folder / "configs" / f"{CELL}.json"
    cfg = json.loads(path.read_text())
    cfg.update(max_kf_number=6, max_movement_parallax=4.0)
    path.write_text(json.dumps(cfg))
    mix = folder / "traffic" / "small.json"
    replay = json.loads((folder / "traffic" / "replay.json").read_text())
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "warmup_frames_max": 160,
                               "time_scale": replay["time_scale"],
                               "rot_scale": replay["rot_scale"]}))
    return root, cells.load(CELL, root)


def _run(mono_cell, fault=None):
    torch.manual_seed(0)
    root, cell = mono_cell
    return run_mod.run(cell, SEED, SECONDS, False, "cpu", fault=fault, root=root)


def test_a_sound_mono_run_is_correct(mono_cell):
    res = _run(mono_cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["check"]) == set(mono_cell[1].limits)


def test_a_wrong_triangulation_at_insertion_is_not_correct(mono_cell):
    res = _run(mono_cell, _born_landmarks_moved)
    assert not res["correct"]
    gap = res["check"]["insert_kf_gap"]
    assert gap["value"] > gap["limit"], res["check"]
