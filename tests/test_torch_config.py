"""stego_torch.config is the port's own copy of stego_tpu.config: the same
fields with the same defaults, the same presets and the same command-line
parsing, so that a config (and a checkpoint that embeds one as a dict)
passes between the two packages unchanged. ``torch_config`` is the tests'
bridge from a JAX ``Config`` to the port's."""

import dataclasses

import pytest

from stego_tpu import config as jax_config
from stego_torch import config
from tests._torch_cpu import one_intra_op_thread  # noqa: F401


def torch_config(jcfg: jax_config.Config) -> config.Config:
    """The port's Config with every field of the JAX package's ``jcfg``."""
    return config.Config(**dataclasses.asdict(jcfg))


def field_table(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        out[f.name] = (str(f.type), default)
    return out


def test_fields_and_defaults_match_jax_package():
    assert field_table(config.Config) == field_table(jax_config.Config)
    assert list(field_table(config.Config)) == \
        list(field_table(jax_config.Config))


def test_presets_match_jax_package():
    assert config.PRESETS == jax_config.PRESETS
    for name in config.PRESETS:
        assert dataclasses.asdict(config.apply_preset(config.Config(), name)) \
            == dataclasses.asdict(jax_config.apply_preset(jax_config.Config(),
                                                          name))
    with pytest.raises(ValueError, match="Unknown preset"):
        config.apply_preset(config.Config(), "nope")


@pytest.mark.parametrize("argv", [
    ["res=320", "full_field_loss=true", "crop_type=null"],
    ["--dim", "90", "--lr", "1e-4", "model_paths=[a.ckpt, 'b.ckpt']"],
    ["pallas_loss_bf16=True", "fused_sampling=off", "extra_clusters=3"],
])
def test_prep_args_matches_jax_package(argv):
    got = config.prep_args(argv)
    assert got == jax_config.prep_args(argv)
    assert dataclasses.asdict(config.Config.from_dict(got, strict=True)) == \
        dataclasses.asdict(jax_config.Config.from_dict(got, strict=True))


@pytest.mark.parametrize("kw,match", [
    (dict(fused_sampling="sometimes"), "fused_sampling"),
    (dict(res=225), "divisible"),
    (dict(steps_per_dispatch=2), "steps_per_dispatch"),
    (dict(negatives_scope="everywhere"), "negatives_scope"),
])
def test_validation_matches_jax_package(kw, match):
    with pytest.raises(ValueError, match=match):
        config.Config(**kw)
    with pytest.raises(ValueError, match=match):
        jax_config.Config(**kw)


def test_dict_round_trip_between_packages():
    jcfg = jax_config.Config(dataset_name="directory", dim=12, res=64,
                             full_field_loss=True, model_paths=["x"])
    cfg = torch_config(jcfg)
    assert cfg.to_dict() == jcfg.to_dict()
    assert jax_config.Config.from_dict(cfg.to_dict()) == jcfg
    assert cfg.to_json() == jcfg.to_json()
    with pytest.raises(ValueError, match="Unknown config keys"):
        config.Config.from_dict({"not_a_key": 1}, strict=True)
