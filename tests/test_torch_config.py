"""The port's jax-free config loader parses every preset in configs/ to the
same values as the JAX package's loader (exact equality: same parser on
the same YAML)."""

import dataclasses
import glob
import os

import pytest

from sadvio_tpu.pipeline import config as jcfg
from sadvio_tpu_torch.pipeline import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(os.path.basename(os.path.dirname(p))
                 for p in glob.glob(os.path.join(REPO, "configs", "*", "config.yaml")))


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_parse_identically(preset):
    d = os.path.join(REPO, "configs", preset)
    assert dataclasses.asdict(tcfg.load_slam_config(os.path.join(d, "config.yaml"))) == \
        dataclasses.asdict(jcfg.load_slam_config(os.path.join(d, "config.yaml")))
    ds = os.path.join(d, "dataset.yaml")
    if os.path.exists(ds):
        assert dataclasses.asdict(tcfg.load_dataset_config(ds)) == \
            dataclasses.asdict(jcfg.load_dataset_config(ds))


def test_defaults_are_the_same_schema():
    assert dataclasses.asdict(tcfg.SLAMConfig()) == dataclasses.asdict(jcfg.SLAMConfig())
    assert [f.name for f in dataclasses.fields(tcfg.SLAMConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.SLAMConfig)]
