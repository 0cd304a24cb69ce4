"""The yardstick's FLOP counts against ``torch.utils.flop_counter`` on a
reduced forward and backward of the plain references (no recompute), and
the frozen kernel costs at hand-worked shapes."""
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.drivers import campaign, temporal_lm
from portbench.reference import cnn as ref_cnn
from portbench.reference import lm as ref_lm
from portbench.yardstick import costs, flops


def test_lm_flops_match_the_counter(tiny):
    _, cfg, _ = tiny("yi34b_l4_int8")
    S = 16
    w = {k: v.float().requires_grad_() for k, v in
         temporal_lm.make_weights(cfg, 3, torch.device("cpu")).items()}
    tokens = torch.randint(0, cfg["vocab_size"], (S + 1,))
    with FlopCounterMode(display=False) as fc:
        x = F.embedding(tokens[:-1], w["embed"])
        for i in range(cfg["num_hidden_layers"]):
            x = ref_lm.block(cfg, "f32", x, *[w[f"blocks/{k}"][i] for k in ref_lm.LAYER_LEAVES])
        x = ref_lm.rms_norm(x, w["final_norm/w"], cfg["rms_norm_eps"])
        F.cross_entropy(x @ w["lm_head"], tokens[1:]).backward()
    want = flops.lm_train_flops(cfg, cfg["num_hidden_layers"], 1, S, causal=False)
    assert fc.get_total_flops() == want


def test_cnn_flops_match_the_counter():
    cfg = harness.load_json(harness.BENCH / "configs" / "flsim-cnn.json")
    p = {k: v.requires_grad_() for k, v in
         campaign.make_weights(cfg, 1, torch.device("cpu")).items()}
    x = torch.randn(4, *cfg["input"])
    y = torch.randint(0, cfg["classes"], (4,))
    with FlopCounterMode(display=False) as fc:
        ref_cnn.loss(p, x, y).backward()
    assert fc.get_total_flops() == 4 * flops.cnn_train_flops_per_image(cfg)


def test_frozen_costs():
    # B1: 2 clients of 512 values, blocks of 256
    assert costs.quant_aggregate(1, 2, 512, 256) == (3 * 2 * 512,
                                                     2 * 512 + 4 * 2 * 2 + 4 * 2 + 4 * 512)
    # B2: 3 rows of 8 bf16 values, a bf16 weight
    assert costs.rmsnorm(3, 8, 2, 2) == (96, 2 * 3 * 8 * 2 + 16)
    # B3: one row, 4 keys, causal at offset 0: 1 pair
    ops, nbytes = costs.flash_attention(1, 1, 4, 1, 1, 8, 8, 0, True, 2)
    assert ops == 2 * 1 * 1 * 1 * 16 and nbytes == (16 + 16) * 2 + 4
    # causal square: S (S + 1) / 2 pairs
    assert costs.flash_attention(1, 4, 4, 1, 1, 8, 8, 0, True, 2)[0] == 2 * 10 * 16
