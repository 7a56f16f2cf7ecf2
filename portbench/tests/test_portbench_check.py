"""The comparison that decides ``correct``, driven through a whole run on the
CPU at a small size: a sound run is correct, and a run whose timed path is
broken underneath the recording is not, once for each fault the cells can
have."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import make_checkout

from portbench import cells, check, run as run_mod

SEED = 2 ** 32 + 17
SECONDS = 6.0


def _returns_state_unchanged(hooks):
    """The window BA hands back the window it was given."""
    fn = hooks.inner["_backend"]

    def backend(window, obs, imu_chain, priors, fixed_n, lines=None):
        _, obs_out, stats = fn(window, obs, imu_chain, priors, fixed_n, lines)
        return window, obs_out, stats

    hooks.inner["_backend"] = backend


def _pose_altered(hooks):
    """The front end's pose moved by 1 cm where it is produced."""
    fn = hooks.inner["_frontend"]

    def frontend(*a, **k):
        tracks, R, t, health, dR, dt = fn(*a, **k)
        return tracks, R, t + 0.01, health, dR, dt

    hooks.inner["_frontend"] = frontend


def _preint_skipped(hooks):
    """The IMU batch is not integrated: the preintegration comes back as it went in."""
    hooks.inner["_preint"] = lambda batch, pre: pre


def _prior_altered(hooks):
    """The marginalization prior's information off by 5%."""
    fn = hooks.inner["_marg_roll"]

    def marg_roll(*a, **k):
        out = list(fn(*a, **k))
        out[3] = dataclasses.replace(out[3], sp_sqrt_info=out[3].sp_sqrt_info * 1.05,
                                     lp_sqrt_info=out[3].lp_sqrt_info * 1.05)
        return tuple(out)

    hooks.inner["_marg_roll"] = marg_roll


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("checkout"))
    return root, cells.load("small_euroc_stereo_vio", root)


def _run(small_cell, fault=None):
    torch.manual_seed(0)
    root, cell = small_cell
    return run_mod.run(cell, SEED, SECONDS, False, "cpu", fault=fault, root=root)


def test_a_sound_run_is_correct(small_cell):
    res = _run(small_cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(small_cell[1].limits)


@pytest.mark.parametrize("fault,number", [
    (_returns_state_unchanged, "ba_gap"), (_pose_altered, "pose_gap"),
    (_preint_skipped, "preint_gap"), (_prior_altered, "prior_gap")])
def test_a_broken_timed_path_is_not_correct(small_cell, fault, number):
    res = _run(small_cell, fault)
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def test_a_stage_never_kept_fails_the_run():
    """A number with no kept call reads infinite, above any limit."""
    assert check.numbers({"_backend": []}, {"_backend": []}) == {}
