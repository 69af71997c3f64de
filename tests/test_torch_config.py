"""libviso_torch.config mirrors libviso_tpu.config field for field."""

import dataclasses

import pytest

import libviso_tpu.config as jcfg
import libviso_torch.config as tcfg

CLASSES = sorted(tcfg.CONFIG_CLASSES)


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_jax(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(tcfg.CONFIG_CLASSES[name])
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.default == b.default or (
            dataclasses.is_dataclass(a.default)
            and dataclasses.asdict(a.default) == dataclasses.asdict(
                b.default)), (name, a.name)


def test_every_jax_config_class_is_mirrored():
    jax_classes = {n for n, c in vars(jcfg).items()
                   if dataclasses.is_dataclass(c) and isinstance(c, type)}
    assert jax_classes == set(CLASSES)


@pytest.mark.parametrize("variant", ["default", "l1", "custom"])
def test_from_jax_config_round_trip(variant):
    cfg = jcfg.PipelineConfig()
    if variant == "l1":
        cfg = cfg.with_metric("l1")
    elif variant == "custom":
        cfg = dataclasses.replace(
            cfg, min_circle_matches=5,
            detector=jcfg.DetectorConfig(max_features=480, nbinx=8, nbiny=4,
                                         num_slots=512),
            ransac=jcfg.RansacConfig(num_hypotheses=16,
                                     hypothesis_method="gn"))
    ported = tcfg.from_jax_config(cfg)
    assert isinstance(ported, tcfg.PipelineConfig)
    assert isinstance(ported.detector, tcfg.DetectorConfig)
    assert dataclasses.asdict(ported) == dataclasses.asdict(cfg)
    assert ported.detector.descriptor_dim_padded == \
        cfg.detector.descriptor_dim_padded
    assert ported.detector.corners_per_bin == cfg.detector.corners_per_bin


def test_calib_from_projections_matches_jax():
    from libviso_torch.synthetic import kitti_projections

    P1, P2 = kitti_projections()
    a = tcfg.Calib.from_projections(P1, P2)
    b = jcfg.Calib.from_projections(P1, P2)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_with_metric_and_validation():
    cfg = tcfg.PipelineConfig().with_metric("l1")
    assert cfg.stereo_match.metric == cfg.temporal_match.metric == "l1"
    with pytest.raises(ValueError):
        tcfg.RansacConfig(hypothesis_method="svd")
    with pytest.raises(ValueError):
        tcfg.RansacConfig(gn_unroll=0)
    with pytest.raises(ValueError):
        tcfg.DetectorConfig(descriptor_gather="bogus")
