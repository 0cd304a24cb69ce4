"""The per-layer metrics that read the program's layer spans and counters:
None where there is nothing to read, the hand-computed value on fabricated
``layer_times()``, and the frozen backward costs against
``torch.utils.flop_counter``."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.yardstick import bwd_costs, flops, peaks

READERS = {"attn_bwd_roofline.lm": "yi34b_l4_int8", "attn_bwd_share.lm": "yi34b_l4_int8",
           "rmsnorm_bwd_roofline.lm": "yi34b_l4_int8", "send_pack_share.lm": "yi34b_l4_int8",
           "server_share.lm": "yi34b_l4_int8", "useful_clients.cnn": "cnn_sweep8_int8",
           "local_train_util.cnn": "cnn_sweep8_int8"}
ATTN = (2, 4096, 4096, 56, 8, 128, 128, True, 0, 2)
NORM = (8192, 7168, 2, 2)


class _Trace:
    def __init__(self, busy_s: float):
        self.window_s, self.busy_s = 4.0, busy_s


def _ctx(name: str, traced: bool = True, busy_s: float = 3.9):
    cell, cfg, _ = harness.cell_files(READERS[name])
    return harness.Context(cell=cell, cfg=cfg, trace=_Trace(busy_s) if traced else None)


def _read(name: str, ctx):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(ctx)


def _span(device_s, by_shape=None):
    return {"count": 1, "host_s": device_s, "device_s": device_s, "self_device_s": device_s,
            "by_shape": by_shape or {}, "parents": {None: 1}}


FABRICATED = {"spans": {"attn.bwd": _span(0.8, {ATTN: 16}),
                        "rmsnorm.bwd": _span(0.2, {NORM: 36}),
                        "send.pack": _span(0.06), "server.aggregate": _span(0.03),
                        "server.update": _span(0.01), "local_train": _span(3.5)},
              "counters": {"clients_trained": 4000, "clients_weighted": 790}}


def _by_hand(name: str, cfg: dict, cell: dict) -> float:
    B, S, _, H, KV, Dk, Dv = ATTN[:7]
    pairs = S * (S + 1) // 2
    if name == "attn_bwd_roofline.lm":
        ops = 2 * B * H * pairs * (3 * Dk + 2 * Dv)
        nbytes = (B * S * H * (Dk + Dv + Dv + Dk) + B * S * KV * 2 * (Dk + Dv)) * 2 + 4 * B * H * S
        return 100 * 16 * max(ops / 989e12, nbytes / 3.35e12) / 0.8
    if name == "rmsnorm_bwd_roofline.lm":
        R, D = NORM[:2]
        return 100 * 36 * (3 * R * D * 2 + 2 * D * 2) / 3.35e12 / 0.2
    if name == "useful_clients.cnn":
        return 100 * 790 / 4000
    if name == "local_train_util.cnn":
        tr = cell["traffic"]["train"]
        work = 4000 * tr["local_steps"] * tr["batch_size"] * flops.cnn_train_flops_per_image(cfg)
        return 100 * work / (3.5 * 67e12)
    share = {"attn_bwd_share.lm": 0.8, "send_pack_share.lm": 0.06, "server_share.lm": 0.04}
    return 100 * share[name] / 4.0


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    import repro_torch.telemetry as tel
    tel.reset_layer_times()
    assert _read(name, _ctx(name)) is None              # the program recorded nothing
    monkeypatch.setattr(tel, "layer_times", lambda: FABRICATED)
    assert _read(name, _ctx(name, traced=False)) is None   # an untraced run
    on_cpu = _read(name, _ctx(name, busy_s=0.0))           # nothing ran on a device
    assert on_cpu is None or name == "useful_clients.cnn"
    monkeypatch.delattr(tel, "layer_times")            # a program without layer spans
    assert _read(name, _ctx(name)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_fabricated_layer_times(name, monkeypatch):
    import repro_torch.telemetry as tel
    monkeypatch.setattr(tel, "layer_times", lambda: FABRICATED)
    ctx = _ctx(name)
    got = _read(name, ctx)
    assert got == pytest.approx(_by_hand(name, ctx.cfg, ctx.cell), rel=1e-12)
    assert 0 < got <= 100


def _dense_bwd(q, k, v, dout):
    """A plain attention's backward from q, k, v: the scores again, then
    dP, dV, dQ and dK, each an einsum over every (query, key) pair."""
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k), torch.einsum("bhqk,bqhd->bkhd", ds, q),
            dv)


@pytest.mark.parametrize("bwd", ["dense", "program"])
def test_attn_bwd_ops_equal_the_counter(bwd):
    """Five products a pair, Dk and Dv apart: a plain attention's backward
    and the program's torch-op backward (``flash_attention.plain_bwd``,
    blocked over the keys) both count what the yardstick counts."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, H, KV, Dk, Dv = 2, 24, 40, 4, 2, 16, 8
    q, k = torch.randn(B, Sq, H, Dk), torch.randn(B, Sk, KV, Dk)
    v, dout = torch.randn(B, Sk, KV, Dv), torch.randn(B, Sq, H, Dv)
    out, lse = fa.plain(q, k, v, 0, False)
    with FlopCounterMode(display=False) as fc:
        if bwd == "dense":
            _dense_bwd(q, k, v, dout)
        else:
            fa.plain_bwd(q, k, v, out, lse, dout, 0, False, block_k=16)
    assert fc.get_total_flops() == bwd_costs.flash_attention_bwd(
        B, Sq, Sk, H, KV, Dk, Dv, False, 0, 4)[0]


@pytest.mark.parametrize("Sq,Sk,q_offset", [(16, 16, 0), (8, 32, 24), (8, 32, 4), (20, 12, 3)])
def test_attn_bwd_causal_ops_count_the_pairs_the_mask_lets_through(Sq, Sk, q_offset):
    B, H, KV, Dk, Dv = 1, 2, 1, 16, 8
    mask = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + q_offset
    ops, nbytes = bwd_costs.flash_attention_bwd(B, Sq, Sk, H, KV, Dk, Dv, True, q_offset, 2)
    assert ops == 2 * B * H * int(mask.sum()) * (3 * Dk + 2 * Dv)
    keys = int(mask.any(0).sum())
    assert nbytes == (2 * B * Sq * H * (Dk + Dv) + 2 * B * keys * KV * (Dk + Dv)) * 2 \
        + 4 * B * H * Sq


def test_backward_bounds_at_the_lm_cell():
    """yi-34b's (2, 4,096, 56/8 x 128) causal backward: 1.22 ms a call,
    bound by its operations; B2's backward at 8,192 rows of 7,168, bound by
    its bytes."""
    least = bwd_costs.attn_bwd_least_s("bf16")(ATTN, 1)
    ops, nbytes = bwd_costs.flash_attention_bwd(*ATTN)
    assert least == ops / peaks.FLOPS_PER_S["bf16"] > nbytes / peaks.HBM_BYTES_PER_S
    assert 1.2e-3 < least < 1.25e-3
    ops, nbytes = bwd_costs.rmsnorm_bwd(*NORM)
    assert bwd_costs.rmsnorm_bwd_least_s(NORM, 1) == nbytes / peaks.HBM_BYTES_PER_S
