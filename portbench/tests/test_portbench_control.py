"""The control on the card: the reference computed with TF32 matrix
products, put in the program's place, comes out not correct, while the
program on the same calls is correct.  Runs the small stereo cell on three
seeds; skips without a card.  (The monocular pipeline at 320x240 loses its
pose on some seeds, so it has no sound small cell; its control readings
come from runs at the cell's own size, ``run.py --readings 1``.)"""

from __future__ import annotations

import pytest
from conftest import make_checkout

from portbench import cells, check, run as run_mod

SEEDS = (2 ** 31 + 3, 2 ** 33 + 5, 7)


@pytest.mark.card
@pytest.mark.parametrize("config", ["euroc_stereo_vio"])
def test_the_control_fails_a_number_the_program_passes(tmp_path, cuda_device, config):
    root = make_checkout(tmp_path, configs=(config,))
    cell = cells.load(f"small_{config}", root)
    for seed in SEEDS:
        res = run_mod.run(cell, seed, 3.0, False, cuda_device, readings=True, root=root)
        assert res["correct"], (seed, res["check"])
        control = res["readings"]["control"]
        assert any(control[k] > lim for k, lim in cell.limits.items()), (seed, control)
    assert set(check.NUMBERS.values()) | {"ate_m"} == set(cell.limits)
