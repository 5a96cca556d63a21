"""The port's copy of the config schema against the JAX package's.

``nerf_keras_tpu_torch/config.py`` is a copy (the port imports nothing of
the JAX package); this test, which imports both, holds them together:
the same fields and defaults, the same parsed config for every shipped
``config/*.json``, the same JSON helpers, and the same ``ValueError`` for
invalid combinations.
"""

import dataclasses
import pathlib

import pytest

from nerf_keras_tpu import config as jcfg
from nerf_keras_tpu_torch import config as pcfg

CONFIGS = sorted((pathlib.Path(__file__).resolve().parents[1] / "config").glob("*.json"))


def test_same_fields_and_defaults():
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(jcfg.NeRFConfig)]
    pf = [(f.name, f.default, f.type) for f in dataclasses.fields(pcfg.NeRFConfig)]
    assert pf == jf
    assert pcfg._KEY_MAP == jcfg._KEY_MAP
    assert dataclasses.asdict(pcfg.NeRFConfig()) == dataclasses.asdict(jcfg.NeRFConfig())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_shipped_configs_parse_the_same(path):
    jc, pc = jcfg.load_config(str(path)), pcfg.load_config(str(path))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pcfg.to_reference_json(pc) == jcfg.to_reference_json(jc)
    assert pcfg.config_name(str(path)) == jcfg.config_name(str(path))
    assert (pc.xyz_dim, pc.dir_dim, pc.ns_total) == (jc.xyz_dim, jc.dir_dim, jc.ns_total)


def test_there_are_shipped_configs():
    assert len(CONFIGS) >= 5


@pytest.mark.parametrize("kw", [
    dict(prop_union=False),                                   # with train_sampler=coarse
    dict(prop_levels=2),                                      # with coarse
    dict(train_sampler="nope"),
    dict(train_sampler="proposal", stop_pdf_gradient=False),
    dict(train_sampler="proposal", prop_levels=3),
    dict(ns_coarse=1),
    dict(compute_dtype="float16"),
    dict(lr_final=1.0, learning_rate=1e-3),
    dict(ema_decay=1.0),
    dict(freq_anneal_steps=10, batch_norm=True),
])
def test_same_errors_for_invalid_combinations(kw):
    with pytest.raises(ValueError) as je:
        jcfg.NeRFConfig(**kw).validate()
    with pytest.raises(ValueError) as pe:
        pcfg.NeRFConfig(**kw).validate()
    assert str(pe.value) == str(je.value)
    inv = {v: k for k, v in jcfg._KEY_MAP.items()}
    with pytest.raises(ValueError) as pe2:
        pcfg.config_from_dict({inv[k]: v for k, v in kw.items()})
    assert str(pe2.value) == str(je.value)


def test_unknown_key_and_overrides():
    with pytest.raises(ValueError, match="unknown config keys"):
        pcfg.config_from_dict({"NOPE": 1})
    path = str(CONFIGS[0])
    over = dict(batch_size=17, stop_pdf_gradient=False)
    assert dataclasses.asdict(pcfg.load_config(path, **over)) == \
        dataclasses.asdict(jcfg.load_config(path, **over))
