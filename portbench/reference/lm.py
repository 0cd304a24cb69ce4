"""The int8 FL round of a dense GQA transformer, in plain PyTorch.

The model follows the Llama architecture that Yi-34B publishes
(arXiv:2403.04652; its config.json): token embedding; per layer an RMSNorm,
grouped-query attention with rotary embeddings (rotate-half form, angles in
float32, head h reading key/value head h // (heads / kv heads)) under a
causal mask, the residual, an RMSNorm and a SwiGLU FFN (silu(x w1) * (x w3))
w2, the residual; a final RMSNorm and an untied head; the loss is the mean
next-token cross-entropy. Weights are given as the benchmark made them:
stacked over layers, dense weights (in, out), keyed ``blocks/attn/wq`` and
so on.

A round (``strategy: compressed``, int8, no residual): the cohort's clients
train one after the other, each ``len(steps)`` SGD steps from the round's
weights; each client's update is sent as int8 (``int8.roundtrip``) and the
server adds their mean (equal weights). The configuration keeps its weights
in bfloat16: every arithmetic step here is float32 (TF32 off), and each
weight is rounded to the weights' dtype where the configuration stores it
(after each SGD step, the mean update, and the server's sum).

``prec="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale per tensor, the gradient passed straight
through.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import int8, numerics

LAYER_LEAVES = ("attn/wk", "attn/wo", "attn/wq", "attn/wv", "ln1/w", "ln2/w",
                "mlp/w1", "mlp/w2", "mlp/w3")
FP8_MAX = 448.0


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(x):
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x, prec: str):
    return _Fp8.apply(x) if prec == "fp8" else x


def _mm(a, b, prec: str):
    return _q(a, prec) @ _q(b, prec)


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (S, H, D): rotate-half rotary embedding at positions 0 .. S-1."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv.float()[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def block(cfg: dict, prec: str, x, wk, wo, wq, wv, ln1, ln2, w1, w2, w3):
    """One layer on one sequence x (S, D)."""
    S = x.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // H
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, ln1, eps)
    q = rope(_mm(h, wq, prec).view(S, H, hd), cfg["rope_theta"])
    k = rope(_mm(h, wk, prec).view(S, KV, hd), cfg["rope_theta"])
    v = _mm(h, wv, prec).view(S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("qhd,khd->hqk", _q(q, prec), _q(k, prec)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", _q(p, prec), _q(v, prec)).reshape(S, H * hd)
    x = x + _mm(o, wo, prec)
    h = rms_norm(x, ln2, eps)
    return x + _mm(F.silu(_mm(h, w1, prec)) * _mm(h, w3, prec), w2, prec)


def sequence_loss(cfg: dict, p: dict, tokens, labels, prec: str):
    """Mean next-token cross-entropy of one sequence; each layer is
    recomputed in the backward, so one layer's attention is held at a
    time."""
    x = F.embedding(tokens, p["embed"])
    for layer in p["layers"]:
        x = torch.utils.checkpoint.checkpoint(
            block, cfg, prec, x, *[layer[k] for k in LAYER_LEAVES], use_reentrant=False)
    x = rms_norm(x, p["final_norm/w"], cfg["rms_norm_eps"])
    return F.cross_entropy(_mm(x, p["lm_head"], prec), labels)


def _f32_leaves(w: dict) -> dict:
    """The stacked weights -> f32 leaves: a list of per-layer dicts under
    ``layers`` beside the others."""
    def f32(t):
        return t.to(torch.float32, copy=True)      # a copy even of f32 weights
    n = w["blocks/ln1/w"].shape[0]
    return {"embed": f32(w["embed"]), "final_norm/w": f32(w["final_norm/w"]),
            "lm_head": f32(w["lm_head"]),
            "layers": [{k: f32(w[f"blocks/{k}"][i]) for k in LAYER_LEAVES} for i in range(n)]}


def _flat(p: dict) -> list:
    out = [p["embed"], p["final_norm/w"], p["lm_head"]]
    for layer in p["layers"]:
        out += [layer[k] for k in LAYER_LEAVES]
    return out


def _stacked_leaf(p: dict, key: str):
    """The f32 leaf ``key`` in the benchmark's stacked layout."""
    if key.startswith("blocks/"):
        return torch.stack([layer[key[len("blocks/"):]] for layer in p["layers"]])
    return p[key]


def local_steps(cfg: dict, w: dict, tokens, labels, lr: float, prec: str):
    """One client's SGD steps from the stacked weights ``w`` on tokens,
    labels (steps, B, S), each step's weights rounded to ``w``'s dtype.
    Returns (its weights as f32 leaves, its losses)."""
    dtype = w["embed"].dtype
    p = _f32_leaves(w)
    leaves = _flat(p)
    losses = []
    for s in range(tokens.shape[0]):
        for t in leaves:
            t.requires_grad_(True)
        # one backward over the step's sequences: one gradient buffer; each
        # sequence's layers are recomputed on their own
        loss = sum(sequence_loss(cfg, p, tokens[s, b], labels[s, b], prec)
                   for b in range(tokens.shape[1])) / tokens.shape[1]
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.requires_grad_(False)
                t.sub_(lr * g)
                t.copy_(t.to(dtype))
        del grads, loss
    return p, losses


def round_(cfg: dict, w: dict, tokens, labels, lr: float, prec: str = "f32"):
    """One round from the stacked weights ``w`` (the configuration's
    dtype): tokens, labels (clients, steps, B, S). Returns (the new stacked
    weights, the round's loss)."""
    with numerics.tf32(False):
        return _round(cfg, w, tokens, labels, lr, prec)


def _round(cfg: dict, w: dict, tokens, labels, lr: float, prec: str):
    C = tokens.shape[0]
    agg = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in w.items()}
    losses = []
    for c in range(C):
        p, ls = local_steps(cfg, w, tokens[c], labels[c], lr, prec)
        for k in w:
            agg[k] += int8.roundtrip(_stacked_leaf(p, k) - w[k].float()) / C
        del p
        losses.append(sum(ls) / len(ls))
    new = {}
    for k in w:
        new[k] = (w[k].float() + agg[k].to(w[k].dtype).float()).to(w[k].dtype)
        del agg[k]
    return new, sum(losses) / C
