"""The port's jax-free config loader parses every preset in configs/ to the
same values as the JAX package's loader (exact equality: same parser on
the same YAML), and each preset whose keys are ported builds its pipeline
class with the right camera model and optimizer."""

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


# the port's pipeline classes by slam_mode, as the JAX package's run_euroc
# dispatches them
MODE_CLASS = {"bimono": "StereoSLAM", "bimonovio": "StereoSLAM", "mono": "MonoSLAM",
              "monovio": "MonoSLAM", "nofov": "NoFovSLAM"}


def _port_classes():
    from sadvio_tpu_torch.pipeline.mono import MonoSLAM
    from sadvio_tpu_torch.pipeline.nofov_mode import NoFovSLAM
    from sadvio_tpu_torch.pipeline.slam import StereoSLAM

    return {c.__name__: c for c in (StereoSLAM, MonoSLAM, NoFovSLAM)}


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_builds_its_port_pipeline(preset):
    """The rig of the preset's dataset.yaml (built by the JAX package and
    carried over) and its config construct the port's class for its
    slam_mode; the other classes refuse the mode; ``_ba_opts.angular``
    follows ``optimizer`` (tests/test_configs.py::test_preset_builds_pipeline).
    Presets that name unported keys (typed channels, multithreading) raise
    NotImplementedError naming them."""
    import jax
    import numpy as np

    from sadvio_tpu.pipeline.euroc import rig_from_dataset
    from sadvio_tpu_torch.data.convert import from_numpy

    d = os.path.join(REPO, "configs", preset)
    cfg = tcfg.load_slam_config(os.path.join(d, "config.yaml"))
    ds = jcfg.load_dataset_config(os.path.join(d, "dataset.yaml"))
    jrig = rig_from_dataset(ds)
    rig = from_numpy(jax.tree.map(np.asarray, jrig), "cpu")
    assert type(rig.cam).__name__ == type(jrig.cam).__name__
    classes = _port_classes()
    cls = classes[MODE_CLASS[cfg.slam_mode]]
    unported = cfg.multithreading or any(f.label.lower() != "pointxd" for f in cfg.features)
    if unported:
        with pytest.raises(NotImplementedError):
            cls(rig, cfg, device="cpu")
        return
    slam = cls(rig, cfg, device="cpu")
    assert type(slam).__name__ == MODE_CLASS[cfg.slam_mode]
    assert slam._ba_opts.angular == cfg.optimizer.lower().startswith("angular")
    assert slam.vio == cfg.slam_mode.endswith("vio")
    for other in classes.values():
        if cfg.slam_mode not in other.MODES:
            with pytest.raises(NotImplementedError, match="slam_mode"):
                other(rig, cfg, device="cpu")
