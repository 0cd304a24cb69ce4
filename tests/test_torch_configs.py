"""The port's ``configs/base.py`` counters against the JAX package's:
``ModelConfig.param_count`` / ``active_param_count`` (both paddings) for
every arch of ``ARCHS``, its reduced config and the paper's small models,
and ``list_archs``."""
import pytest

from repro.configs.base import get_config as jget_config
from repro.configs.base import list_archs as jlist_archs
from repro.configs.reduce import reduced_config as jreduced
from repro_torch.configs.base import ARCHS, get_config, list_archs
from repro_torch.configs.reduce import reduced_config

SMALL = ("flsim-cnn", "flsim-mlp", "flsim-logreg")


def test_list_archs_is_the_jax_packages():
    assert tuple(list_archs()) == tuple(jlist_archs()) == ARCHS


CASES = [(a, False) for a in ARCHS + SMALL] + [(a, True) for a in ARCHS]


@pytest.mark.parametrize("arch,reduced", CASES,
                         ids=[f"{a}-{'reduced' if r else 'published'}" for a, r in CASES])
def test_param_counts_are_the_jax_packages(arch, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = reduced_config(cfg), jreduced(jcfg)
    for padded in (False, True):
        assert cfg.param_count(padded=padded) == jcfg.param_count(padded=padded)
        assert cfg.active_param_count(padded=padded) == \
            jcfg.active_param_count(padded=padded)
    assert 0 < cfg.active_param_count() <= cfg.param_count()
