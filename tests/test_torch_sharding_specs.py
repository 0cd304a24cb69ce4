"""The port's partition rule tables (``sharding/specs.py``) against the JAX
package's, and the JAX tests' checks of them (``tests/test_sharding_specs.py``):
for every arch of the registry and every phase the spec tree equals the
JAX package's (its ``PartitionSpec``s through ``interop.specs_from_jax``),
matches ``transformer.param_shapes`` leaf for leaf and divides the
production mesh; the gather table, ``placement_for`` and ``batch_specs``
equal the JAX package's."""
import math

import pytest

from repro.configs.base import get_config as j_get_config
from repro.sharding import specs as jspecs
from repro_torch.configs.base import ARCHS, get_config
from repro_torch.interop import specs_from_jax
from repro_torch.models import transformer
from repro_torch.sharding import specs

MESH_SIZES = {"data": 16, "model": 16, "pod": 2}
PHASES = ("fsdp", "tp", "spatial")


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], keys + (k,))
    else:
        yield keys, tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", PHASES)
def test_specs_equal_the_jax_tables(arch, phase):
    assert specs.param_specs(get_config(arch), phase) == \
        specs_from_jax(jspecs.param_specs(j_get_config(arch), phase))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("phase", PHASES)
def test_specs_match_and_divide(arch, phase):
    cfg = get_config(arch)
    shapes = list(_leaves(transformer.param_shapes(cfg)))
    spec_leaves = list(_leaves(specs.param_specs(cfg, phase)))
    assert [k for k, _ in shapes] == [k for k, _ in spec_leaves], f"{arch}/{phase}: tree mismatch"
    for (keys, shape), (_, spec) in zip(shapes, spec_leaves):
        assert len(spec) in (0, len(shape)), (arch, phase, keys)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            factor = math.prod(MESH_SIZES[n] for n in names)
            assert shape[dim] % factor == 0, (
                f"{arch}/{phase} {'/'.join(keys)}: dim {dim} size {shape[dim]} "
                f"not divisible by {names}={factor}")


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_table_equals_jax(arch):
    table = specs.gather_dim_table(get_config(arch))   # asserts on conflicts
    assert table and table == jspecs.gather_dim_table(j_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS + ("flsim-cnn", "flsim-logreg"))
def test_placement_and_batch_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert specs.placement_for(cfg) == jspecs.placement_for(jcfg)
    for kind in ("train", "prefill", "decode"):
        for batch in (1, 8, 32, 256):
            for axes in ((("data", 16), ("model", 16)),
                         (("pod", 2), ("data", 16), ("model", 16)), (("data", 2),)):
                assert specs.batch_specs(cfg, kind, batch, axes) == \
                    specs_from_jax(jspecs.batch_specs(jcfg, kind, batch, axes)), (kind, batch, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_invariant_across_phases(arch):
    """Sharding never changes the parameter count (subgrid packing too)."""
    cfg = get_config(arch)
    shapes = transformer.param_shapes(cfg)
    assert sum(math.prod(s) for _, s in _leaves(shapes)) > 0
    if cfg.moe is not None and cfg.moe.ep_mode == "subgrid":
        blocks = shapes["blocks"]["moe"]["w1"]
        assert blocks[1] == cfg.moe.n_experts * cfg.moe.f_sub
        assert blocks[3] == cfg.moe.expert_d_ff // cfg.moe.f_sub
