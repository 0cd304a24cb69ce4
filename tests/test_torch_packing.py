"""The port's int8 packing and compressed-strategy emission
(``repro_torch/core/packing.py``, ``core/strategies/compressed.py``)
against the JAX package's, on the same numpy deltas.

Every comparison here is bitwise: packing is reshapes, pads and concats
in the same leaf order and layout, and the quantizer is the same f32
max / divide / round-half-to-even / clamp sequence.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.core import packing as jpacking
from repro.core.strategies.compressed import CompressedFedAvg as JCompressed
from repro.models.small import SmallModel as JSmallModel
from repro_torch.configs.base import FLConfig
from repro_torch.core import packing
from repro_torch.core.strategies.compressed import CompressedFedAvg
from repro_torch.interop import params_from_numpy, to_numpy


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


CFG = J_CNN.replace(d_model=8, d_ff=16)


def _template():
    params = JSmallModel(CFG, "cnn").init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


def _deltas(n_clients=None, seed=0):
    rng = np.random.RandomState(seed)
    lead = () if n_clients is None else (n_clients,)
    return {k: (rng.randn(*lead, *v.shape) * 1e-2).astype(np.float32)
            for k, v in _template().items()}


def test_pack_order_and_layout_match_jax():
    d = _deltas()
    want = np.asarray(jpacking.pack_tree({k: jnp.asarray(v) for k, v in d.items()}))
    got = packing.pack_tree(params_from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert packing.packed_size(params_from_numpy(d)) == jpacking.packed_size(d)
    assert packing.packed_nbytes(params_from_numpy(d)) == jpacking.packed_nbytes(d)


def test_quantize_and_unpack_match_jax():
    d = _deltas(seed=1)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    jpd = jpacking.quantize_tree(jd)
    pd = packing.quantize_tree(params_from_numpy(d))
    np.testing.assert_array_equal(pd.q.numpy(), np.asarray(jpd.q))
    np.testing.assert_array_equal(pd.scale.numpy(), np.asarray(jpd.scale))
    jflat = jpacking.dequant_flat(jpd)
    flat = packing.dequant_flat(pd)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    jback = jpacking.unpack_tree(jflat, jd)
    back = to_numpy(packing.unpack_tree(flat, params_from_numpy(d)))
    for k in d:
        np.testing.assert_array_equal(back[k], np.asarray(jback[k]))


def test_client_dim_packs_each_client_on_its_own():
    d = params_from_numpy(_deltas(n_clients=3, seed=2))
    pd = packing.quantize_tree(d, lead=1)
    for c in range(3):
        one = packing.quantize_tree({k: v[c] for k, v in d.items()})
        assert torch.equal(pd.q[c], one.q) and torch.equal(pd.scale[c], one.scale)
    back = packing.unpack_tree(packing.pack_tree(d, lead=1), d, lead=1)
    assert all(torch.equal(back[k], d[k]) for k in d)


@pytest.mark.parametrize("error_feedback", [True, False])
def test_compressed_packed_emission_matches_jax(error_feedback):
    """(C, N) int8 rows, scales and the error-feedback residual of the port
    equal the JAX strategy's per-client emission."""
    C = 3
    d, res = _deltas(n_clients=C, seed=3), _deltas(n_clients=C, seed=4)
    res = {k: v * 0.1 for k, v in res.items()}
    jstrat = JCompressed(JFLConfig(strategy="compressed", compression="int8",
                                   error_feedback=error_feedback))
    strat = CompressedFedAvg(FLConfig(strategy="compressed", compression="int8",
                                      error_feedback=error_feedback))
    cstate = {"residual": params_from_numpy(res)} if error_feedback else {}
    pd, new = strat.postprocess_packed(params_from_numpy(d), cstate, 0)
    for c in range(C):
        jcs = ({"residual": {k: jnp.asarray(v[c]) for k, v in res.items()}}
               if error_feedback else {})
        jpd, jnew = jstrat.postprocess_packed(
            {k: jnp.asarray(v[c]) for k, v in d.items()}, jcs, None)
        np.testing.assert_array_equal(pd.q[c].numpy(), np.asarray(jpd.q))
        np.testing.assert_array_equal(pd.scale[c].numpy(), np.asarray(jpd.scale))
        if error_feedback:
            for k in d:
                np.testing.assert_array_equal(new["residual"][k][c].numpy(),
                                              np.asarray(jnew["residual"][k]))


def test_packed_residual_equals_roundtrip_residual():
    """Per-leaf padding keeps quantization blocks inside leaves, so the
    packed path's residual is bitwise the unpacked round trip's."""
    fl = FLConfig(strategy="compressed", compression="int8")
    strat = CompressedFedAvg(fl)
    d = params_from_numpy(_deltas(n_clients=2, seed=5))
    cs = strat.client_state_init(d)
    sent, r1 = strat.postprocess(d, cs, 0)
    pd, r2 = strat.postprocess_packed(d, cs, 0)
    back = packing.unpack_tree(packing.dequant_flat(pd), d, lead=1)
    for k in d:
        assert torch.equal(r1["residual"][k], r2["residual"][k])
        assert torch.equal(sent[k], back[k])


@pytest.mark.parametrize("chunk", [256, 768, 1 << 24])
@pytest.mark.parametrize("lead", [0, 1])
def test_quantize_tree_leaf_by_leaf_is_the_whole_row_quantized(chunk, lead, monkeypatch):
    """``quantize_tree`` quantizes leaf by leaf, in chunks of whole blocks,
    into preallocated rows: bitwise ``quantize_blockwise_ref`` of the
    whole ``pack_tree`` row, and the JAX package's ``quantize_tree``, on
    leaves whose sizes are no multiple of 256 (a bf16 leaf among them), with
    chunks that split a leaf (256, 768 values) and one that holds it."""
    from repro_torch.kernels import ref as kref
    monkeypatch.setattr(packing, "QUANT_CHUNK", chunk)
    rng = np.random.RandomState(3)
    lead_shape = (3,) * lead
    tree = {"a": rng.randn(*lead_shape, 1000), "b": rng.randn(*lead_shape, 17, 5) * 1e-3,
            "c": rng.randn(*lead_shape, 2, 640), "z": np.zeros(lead_shape + (7,))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    ttree["c"] = ttree["c"].to(torch.bfloat16)
    pd = packing.quantize_tree(ttree, lead=lead)
    q, sc = kref.quantize_blockwise_ref(packing.pack_tree(ttree, lead=lead), block=256)
    assert pd.q.dtype == torch.int8 and pd.q.shape == lead_shape + (1024 + 256 + 1280 + 256,)
    assert torch.equal(pd.q, q) and torch.equal(pd.scale, sc)
    # into given rows (the temporal round's (C_t, N) matrix): in place there
    mq = torch.zeros((2, *q.shape), dtype=torch.int8)
    ms = torch.zeros((2, *sc.shape))
    into = packing.quantize_tree(ttree, lead=lead, out=packing.PackedDelta(mq[1], ms[1]))
    assert into.q.data_ptr() == mq[1].data_ptr()
    assert torch.equal(mq[1], q) and torch.equal(ms[1], sc)
    assert not mq[0].any() and not ms[0].any()
    # the JAX package quantizes one client's tree at a time (its rounds vmap it)
    for c in range(3 if lead else 1):
        jtree = {k: jnp.asarray((v[c] if lead else v).float().numpy())
                 for k, v in ttree.items()}
        jq, jsc = jpacking.quantize_tree(jtree)
        np.testing.assert_array_equal((pd.q[c] if lead else pd.q).numpy(), np.asarray(jq))
        np.testing.assert_array_equal((pd.scale[c] if lead else pd.scale).numpy(),
                                      np.asarray(jsc))
