"""An LM's int8 FL round on one card: the temporal round of
``repro_torch.core.rounds.build_temporal_round`` (the round that
``launch/train_fl_lm`` runs), meshless, for a dense GQA configuration.

The benchmark makes the weights on the device from the seed, in the
configuration's dtype, one generator call a leaf, and each round's token
rows (``traffic.lm_tokens``). Set-up builds the round and drives it through
``setup_rounds`` rounds on fresh rows; the window runs further rounds back
to back, each ending when its loss has been read. ``check`` frees the
program, follows the first ``ref_rounds`` rounds with the plain reference
(``reference/lm.py``) from the same weights and rows, and compares each
round's loss, every leaf's first-round change and its change after
``ref_rounds`` rounds.
"""
from __future__ import annotations

import gc

import torch

from portbench import traffic
from portbench.reference import lm as ref_lm
from portbench.yardstick import compare, flops

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_shapes(cfg: dict) -> dict:
    """The weights as the benchmark makes them: stacked over layers, dense
    weights (in, out), keyed as the program's flat parameter dict."""
    L, D, F_ = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    H, KV, V = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["vocab_size"]
    hd = D // H
    return {"blocks/attn/wk": (L, D, KV * hd), "blocks/attn/wo": (L, H * hd, D),
            "blocks/attn/wq": (L, D, H * hd), "blocks/attn/wv": (L, D, KV * hd),
            "blocks/ln1/w": (L, D), "blocks/ln2/w": (L, D),
            "blocks/mlp/w1": (L, D, F_), "blocks/mlp/w2": (L, F_, D),
            "blocks/mlp/w3": (L, D, F_),
            "embed": (V, D), "final_norm/w": (D,), "lm_head": (D, V)}


def make_leaf(cfg: dict, key: str, shape, seed: int, device):
    """One leaf from the seed: norms 1, every other weight N(0,
    initializer_range), drawn in the configuration's dtype on the device."""
    dtype = DTYPES[cfg["torch_dtype"]]
    if key.endswith("/w"):
        return torch.ones(shape, dtype=dtype, device=device)
    g = traffic.generator(seed, device, "weights", key)
    return torch.randn(shape, generator=g, dtype=dtype, device=device).mul_(
        cfg["initializer_range"])


def make_weights(cfg: dict, seed: int, device) -> dict:
    return {k: make_leaf(cfg, k, s, seed, device) for k, s in leaf_shapes(cfg).items()}


def change_norms(cfg: dict, params: dict, seed: int, device) -> dict:
    """Each leaf's norm of its change from the seed's weights (made again
    leaf by leaf), in f32, a layer at a time."""
    out = {}
    for k, s in leaf_shapes(cfg).items():
        w0 = make_leaf(cfg, k, s, seed, device)
        sq = sum(float((a.float() - b.float()).pow(2).sum())
                 for a, b in zip(params[k].reshape(-1, *s[-1:]).split(4096),
                                 w0.reshape(-1, *s[-1:]).split(4096)))
        out[k] = sq ** 0.5
        del w0
    return out


def program_config(cfg: dict):
    """The program's ModelConfig for the configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], tie_embeddings=cfg["tie_word_embeddings"])


class Run:
    span = "round"

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        from repro_torch.configs.base import FLConfig
        from repro_torch.core.rounds import build_temporal_round
        from repro_torch.core.strategies import get_strategy
        from repro_torch.models import model_zoo
        from repro_torch.models.transformer import FlatModel, flatten_params, param_shapes

        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        t = self.t = cell["traffic"]
        if not 1 <= cell["ref_rounds"] <= cell["setup_rounds"]:
            raise ValueError("the reference follows 1 .. setup_rounds of the set-up rounds")
        mcfg = program_config(cfg)
        want = {k: tuple(v) for k, v in flatten_params(param_shapes(mcfg)).items()}
        if want != leaf_shapes(cfg):
            raise RuntimeError(f"the program's parameter layout changed: {want}")
        fl = FLConfig(strategy="compressed", compression="int8", error_feedback=False,
                      n_clients=t["clients"], cohort=t["cohort"], local_epochs=1,
                      client_lr=t["client_lr"], seed=0)
        strategy = get_strategy(fl)
        model = FlatModel(model_zoo.build(mcfg))
        self.round_fn = build_temporal_round(model, strategy, fl)
        params = make_weights(cfg, seed, device)
        self.state = {"params": params, "server": strategy.server_state_init(params),
                      "clients": ()}
        self.weights = torch.ones((t["cohort"],), dtype=torch.float32, device=device)
        self.r = 0
        self.losses, self.first, self.after = [], None, None
        for _ in range(cell["setup_rounds"]):
            loss = self._round()
            self.losses.append(loss)
            if self.r == 1:
                self.first = change_norms(cfg, self.state["params"], seed, device)
            if self.r == cell["ref_rounds"]:
                self.after = change_norms(cfg, self.state["params"], seed, device)
        self.flops = flops.lm_train_flops(cfg, cfg["num_hidden_layers"], t["batch"],
                                          t["seq"]) * t["cohort"] * t["local_steps"]

    def _round(self) -> float:
        rf = torch.profiler.record_function
        with rf("portbench.feed"):
            tokens, labels = traffic.lm_tokens(self.t, self.cfg["vocab_size"], self.seed,
                                               self.r, self.device)
        with rf("portbench.temporal_round"):
            self.state, m = self.round_fn(self.state, {"tokens": tokens, "labels": labels},
                                          self.weights, traffic.derive(self.seed, "round", self.r))
        self.r += 1
        with rf("portbench.loss_read"):
            return float(m["loss"])          # waits for the round's kernels

    def step(self) -> dict:
        self._round()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = self.t
        return {"rounds": 1, "tokens": t["cohort"] * t["local_steps"] * t["batch"] * t["seq"],
                "model_flops": self.flops}

    def check(self) -> dict:
        """Free the program, follow its first rounds with the reference,
        compare; returns {name: {"value", "limit"}}."""
        del self.state, self.round_fn
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference_rounds(self.cell, self.cfg, self.seed, self.device)
        return judge(self.cell, self.losses, self.first, self.after, ref)


def reference_rounds(cell: dict, cfg: dict, seed: int, device, prec: str = "f32",
                     half_batch: bool = False) -> tuple:
    """(losses, first-round change norms, change norms after ``ref_rounds``)
    of the plain reference from the seed's weights and rows."""
    t = cell["traffic"]
    w = make_weights(cfg, seed, device)
    losses, first, after = [], None, None
    for r in range(cell["ref_rounds"]):
        tokens, labels = traffic.lm_tokens(t, cfg["vocab_size"], seed, r, device)
        if half_batch:
            tokens, labels = tokens[:, :, :t["batch"] // 2], labels[:, :, :t["batch"] // 2]
        w, loss = ref_lm.round_(cfg, w, tokens, labels, t["client_lr"], prec)
        losses.append(loss)
        if r == 0:
            first = change_norms(cfg, w, seed, device)
    after = change_norms(cfg, w, seed, device)
    return losses, first, after


def judge(cell: dict, losses: list, first: dict, after: dict, ref: tuple) -> dict:
    ref_losses, ref_first, ref_after = ref
    leaves = compare.moved(ref_first)
    lim = cell["limits"]
    got = {"loss_gap": compare.loss_gap(losses[:len(ref_losses)], ref_losses),
           "update_gap": compare.norm_gap(first, ref_first, leaves),
           "change_gap": compare.norm_gap(after, ref_after, leaves)}
    return {k: {"value": v, "limit": lim.get(k)} for k, v in got.items()}


def setup(cell: dict, cfg: dict, seed: int, device) -> Run:
    return Run(cell, cfg, seed, device)


def control_readings(cell: dict, cfg: dict, seed: int, device) -> dict:
    """The comparison's numbers for the reference put in the program's
    place: computed in the control's precision, and with half of each
    batch left out; each judged against the float32 reference."""
    ref = reference_rounds(cell, cfg, seed, device)
    out = {}
    for name, kw in (("control", {"prec": cell["control"]}), ("half_batch", {"half_batch": True})):
        out[name] = judge(cell, *reference_rounds(cell, cfg, seed, device, **kw), ref)
    return out
