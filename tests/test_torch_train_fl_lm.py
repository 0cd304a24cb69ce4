"""``repro_torch.launch.train_fl_lm.scaled_config`` against the JAX example's
rule (``examples/train_fl_lm.py:56-60``): the reduced config at the scale's
width, with the scale's layer count except in the hybrid and ssm families,
which keep the reduced config's (one whole period).

The port runs no hybrid or ssm arch yet, so its ``get_config`` is
monkeypatched to hand ``scaled_config`` the JAX package's config of every
arch in the registry, rebuilt field for field as the port's dataclasses.
"""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs.reduce import reduced_config as jreduced
from repro_torch.configs import base
from repro_torch.launch import train_fl_lm

SUBCONFIGS = {"mla": base.MLAConfig, "moe": base.MoEConfig, "ssm": base.SSMConfig,
              "hybrid": base.HybridConfig}


def _port_config(jcfg) -> base.ModelConfig:
    """The JAX ``ModelConfig`` as the port's, sub-configs included."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name, cls in SUBCONFIGS.items():
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return base.ModelConfig(**kw)


def _example_rule(arch: str, scale: str):
    """``examples/train_fl_lm.py:56-60`` on the JAX package's configs."""
    d, L, f, v = train_fl_lm.SCALES[scale]
    cfg = jreduced(jbase.get_config(arch)).replace(d_model=d, d_ff=f, vocab_size=v)
    if cfg.family not in ("hybrid", "ssm"):
        cfg = cfg.replace(n_layers=L)
    return cfg


@pytest.mark.parametrize("scale", sorted(train_fl_lm.SCALES))
@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_scaled_config_keeps_the_example_layer_rule(arch, scale, monkeypatch):
    monkeypatch.setattr(train_fl_lm, "get_config",
                        lambda name: _port_config(jbase.get_config(name)))
    got, want = train_fl_lm.scaled_config(arch, scale), _example_rule(arch, scale)
    assert got.family == want.family
    assert (got.n_layers, got.d_model, got.d_ff, got.vocab_size) == \
        (want.n_layers, want.d_model, want.d_ff, want.vocab_size)
    assert got == _port_config(want)


def test_every_family_is_covered():
    """The registry spans every family the rule tells apart, so the test
    above holds the rule for each."""
    families = {jbase.get_config(a).family for a in jbase.ARCHS}
    assert {"hybrid", "ssm", "dense", "moe", "encdec"} <= families
