"""Model FLOPs of the work a window completes, counted from a
configuration's shapes: the products a training step needs (forward, and
the backward's gradients with respect to every weight and every input that
needs one), with recomputation not counted and nothing for elementwise
work. A multiply-add is 2 operations.
"""
from __future__ import annotations


def _matmul(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def cnn_train_flops_per_image(cfg: dict) -> int:
    """One image through the paper's CNN, forward and backward: each 3x3
    'SAME' convolution (then a 2x2 max-pool), the hidden and the output
    dense layer. The first convolution's input needs no gradient."""
    h, w, cin = cfg["input"]
    k = cfg["kernel"]
    total = 0
    for i, cout in enumerate(cfg["conv_channels"]):
        fwd = _matmul(h * w, cout, k * k * cin)
        total += fwd * (2 if i == 0 else 3)
        h, w, cin = h // cfg["pool"], w // cfg["pool"], cout
    for n_in, n_out in ((h * w * cin, cfg["fc"]), (cfg["fc"], cfg["classes"])):
        total += 3 * _matmul(1, n_out, n_in)
    return total


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask lets through in one sequence."""
    return S * (S + 1) // 2


def lm_train_flops(cfg: dict, n_layers: int, batch: int, seq: int,
                   causal: bool = True) -> int:
    """One local step of a dense GQA transformer with a SwiGLU FFN and an
    untied head, forward and backward (3x the forward), over ``batch``
    sequences of ``seq`` tokens: the q/k/v/o projections, the FFN's three
    matrices, the head, and attention's two products over the pairs the
    mask lets through (``causal=False``: every pair, as a plain attention
    computes them). The embedding is a lookup and counts nothing."""
    D, F_ = cfg["hidden_size"], cfg["intermediate_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    V = cfg["vocab_size"]
    T = batch * seq
    proj = _matmul(T, H * hd, D) * 2 + _matmul(T, KV * hd, D) * 2
    ffn = _matmul(T, F_, D) * 3
    pairs = causal_pairs(seq) if causal else seq * seq
    attn = 2 * 2 * batch * H * pairs * hd
    head = _matmul(T, V, D)
    return 3 * (n_layers * (proj + ffn + attn) + head)
