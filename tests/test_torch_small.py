"""The port's small models (``repro_torch/models/small.py``) against the JAX
package's, on JAX-initialised weights carried across through
``repro_torch.interop`` and the same numpy batch.

Tolerance rtol 1e-4 / atol 1e-5 on logits, loss and gradients: both run in
f32, but XLA's and PyTorch's CPU convolutions and matmuls sum in different
orders, which moves results by a few ulps per layer (observed max relative
differences around 1e-6); the bound leaves two decades of margin.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.configs.flsim_small import FLSIM_LOGREG as J_LOGREG
from repro.configs.flsim_small import FLSIM_MLP as J_MLP
from repro.models.small import SmallModel as JSmallModel
from repro.models.small import input_shape as j_input_shape
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import get_config
from repro_torch.core import determinism
from repro_torch.interop import params_from_numpy
from repro_torch.models import model_zoo
from repro_torch.models.small import SmallModel, input_shape


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread: the suite runs in
    several processes that share the cores, and with a thread per core in
    each, torch's many small CPU ops crawl (six of the port's test files took
    426 s under six processes against 75 s on one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL, ATOL = 1e-4, 1e-5
JCFGS = {"cnn": J_CNN.replace(d_model=8, d_ff=16),
         "mlp": J_MLP.replace(d_model=16, n_layers=2),
         "logreg": J_LOGREG}


def _setup(kind, seed=0):
    jcfg = JCFGS[kind]
    jm = JSmallModel(jcfg, kind)
    params = {k: np.asarray(v) for k, v in jm.init(jax.random.PRNGKey(seed)).items()}
    if kind == "logreg":   # zero init: give the comparison something to see
        rng = np.random.RandomState(seed)
        params = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32)
                  for k, v in params.items()}
    cfg = get_config(jcfg.name).replace(d_model=jcfg.d_model, d_ff=jcfg.d_ff,
                                        n_layers=jcfg.n_layers)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(6, *j_input_shape(jcfg)).astype(np.float32)
    y = rng.randint(0, 10, 6)
    return jm, SmallModel(cfg, kind), params, x, y


@pytest.mark.parametrize("kind", ["cnn", "mlp", "logreg"])
def test_logits_loss_grad_match_jax(kind):
    jm, m, params, x, y = _setup(kind)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    p = params_from_numpy(params)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    np.testing.assert_allclose(m.logits(p, batch["x"]).numpy(),
                               np.asarray(jm.logits(jp, jbatch["x"])),
                               rtol=RTOL, atol=ATOL)
    (jloss, _), jgrad = jax.value_and_grad(
        lambda q: jm.loss(AxisCtx(), q, jbatch), has_aux=True)(jp)
    grad, loss = torch.func.grad_and_value(m.loss)(p, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL, atol=ATOL)
    assert sorted(grad) == sorted(jgrad)
    for k in grad:
        np.testing.assert_allclose(grad[k].numpy(), np.asarray(jgrad[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(m.accuracy(p, batch).item(),
                               float(jm.accuracy(jp, jbatch)))


@pytest.mark.parametrize("kind", ["cnn", "mlp", "logreg"])
def test_init_names_shapes_and_seeding(kind):
    jm, m, params, _, _ = _setup(kind)
    mine = m.init(determinism.generator(determinism.root_key(0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in params.items()}
    again = m.init(determinism.generator(determinism.root_key(0)))
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    if kind == "logreg":
        assert all(not v.any() for v in mine.values())


def test_model_zoo_builds_paper_models_only():
    assert model_zoo.build("flsim-cnn").kind == "cnn"
    assert input_shape(get_config("flsim-logreg")) == (28, 28, 1)
    assert type(model_zoo.build("yi-34b")).__name__ == "Model"   # dense GQA LM
    assert type(model_zoo.build("qwen2.5-32b")).__name__ == "Model"   # + QKV bias
    assert type(model_zoo.build("arctic-480b")).__name__ == "Model"   # MoE
    # encoder-decoder, xLSTM and the Mamba hybrid, refused until slice 12
    assert type(model_zoo.build("whisper-base")).__name__ == "EncDecModel"
    assert type(model_zoo.build("xlstm-125m")).__name__ == "Model"
    assert type(model_zoo.build("jamba-1.5-large-398b")).__name__ == "Model"


@pytest.mark.parametrize("arch", ["flsim-cnn", "flsim-mlp", "flsim-logreg"])
def test_count_params_of_the_paper_models_equals_jax(arch):
    from repro.configs.base import get_config as j_get_config
    from repro.models import model_zoo as j_model_zoo
    want = j_model_zoo.count_params(j_get_config(arch))
    assert model_zoo.count_params(get_config(arch)) == want
    if arch == "flsim-cnn":
        assert want == 188_810


@pytest.mark.parametrize("arch", ["yi-34b", "qwen2.5-32b", "qwen1.5-32b", "chameleon-34b",
                                  "minicpm3-4b", "qwen3-moe-30b-a3b", "arctic-480b"])
def test_count_params_of_every_ported_lm_equals_jax(arch):
    """Padded and not (the vocab padding off once when tied), and active
    (top_k of each MoE layer's experts), at full and at reduced size."""
    from repro.configs.base import get_config as j_get_config
    from repro.configs.reduce import reduced_config as j_reduced
    from repro.models import model_zoo as j_model_zoo
    from repro_torch.configs.reduce import reduced_config
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (reduced_config(get_config(arch)), j_reduced(j_get_config(arch)))):
        for kw in ({}, {"padded": True}, {"active_only": True},
                   {"padded": True, "active_only": True}):
            assert model_zoo.count_params(cfg, **kw) == j_model_zoo.count_params(jcfg, **kw)
    if arch == "qwen3-moe-30b-a3b":   # 30.5 B params, 3.3 B active
        assert 30e9 < model_zoo.count_params(get_config(arch)) < 31e9
        assert 3e9 < model_zoo.count_params(get_config(arch), active_only=True) < 3.5e9
