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


def _jax_classes():
    from sadvio_tpu.pipeline.mono import MonoSLAM
    from sadvio_tpu.pipeline.nofov_mode import NoFovSLAM
    from sadvio_tpu.pipeline.slam import StereoSLAM

    return {c.__name__: c for c in (StereoSLAM, MonoSLAM, NoFovSLAM)}


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_builds_its_port_pipeline(preset):
    """The port's rig of the preset's dataset.yaml equals the JAX package's
    leaf by leaf, and with the preset's config it constructs the port's
    class for its slam_mode; the other classes refuse the mode;
    ``_ba_opts.angular`` follows ``optimizer``
    (tests/test_configs.py::test_preset_builds_pipeline).  Every preset
    builds as it is, ``multithreading`` included, and again with every typed
    label added, in the mono and nofov classes too: each time with the
    channels the JAX package's class builds for it."""
    import numpy as np

    from sadvio_tpu.pipeline.euroc import rig_from_dataset as jax_rig_from_dataset
    from sadvio_tpu_torch.pipeline.euroc import rig_from_dataset

    d = os.path.join(REPO, "configs", preset)
    cfg = tcfg.load_slam_config(os.path.join(d, "config.yaml"))
    ds = os.path.join(d, "dataset.yaml")
    rig = rig_from_dataset(tcfg.load_dataset_config(ds), "cpu")
    jrig = jax_rig_from_dataset(jcfg.load_dataset_config(ds))
    assert type(rig.cam).__name__ == type(jrig.cam).__name__
    for f in dataclasses.fields(rig.cam):
        a, b = getattr(rig.cam, f.name), getattr(jrig.cam, f.name)
        if isinstance(a, int):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
    for name in ("R_f_s", "t_f_s"):
        np.testing.assert_array_equal(getattr(rig, name).numpy(),
                                      np.asarray(getattr(jrig, name)), err_msg=name)
    classes = _port_classes()
    cls = classes[MODE_CLASS[cfg.slam_mode]]
    typed = dataclasses.replace(cfg, features=cfg.features + tuple(
        tcfg.FeatureConfig(label=lb) for lb in ("linexd", "edgeletxd", "ellipsepatternxd",
                                                 "bboxxd")) + (
        tcfg.FeatureConfig(label="pointxd", detector="csv", folder=d),))
    jclass = _jax_classes()[MODE_CLASS[cfg.slam_mode]]
    for c in (typed, cfg):
        slam = cls(rig, c, device="cpu")
        labels = [f.label.lower() for f in c.features]
        assert (slam._line_ch is not None) == ("linexd" in labels and rig.C >= 2)
        # the channels the JAX package builds for the config, in its order
        jslam = jclass(jrig, c)
        assert [type(ch).__name__ for ch in slam.channels] == \
            [type(ch).__name__ for ch in jslam.channels]
        assert slam._use_csv == jslam._use_csv == (c is typed)
    assert (slam.backend_exec is not None) == cfg.multithreading
    assert type(slam).__name__ == MODE_CLASS[cfg.slam_mode]
    assert slam._ba_opts.angular == cfg.optimizer.lower().startswith("angular")
    assert slam.vio == cfg.slam_mode.endswith("vio")
    for other in classes.values():
        if cfg.slam_mode not in other.MODES:
            with pytest.raises(NotImplementedError, match="slam_mode"):
                other(rig, cfg, device="cpu")
