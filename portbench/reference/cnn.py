"""The paper's round for one trajectory of a sweep, in plain PyTorch.

The model (FLsim §4.1): three 3x3 'SAME' convolutions with ReLU, each
followed by a 2x2 max-pool, a dense ReLU layer and a dense output layer,
on NHWC images; conv kernels are kept HWIO and dense weights (in, out), and
the features are flattened in HWC order. The loss is the mean negative
log-likelihood.

A round (``strategy: compressed``, int8, with error feedback): every client
of the population runs ``local_steps`` SGD steps from the global weights
on its batches; its update plus its residual is sent as int8
(``int8.roundtrip``) and the residual keeps what the send lost; the server
adds the mean of the sends, weighted by each client's partition size times
the round's cohort mask (``keys.cohort``). The round's loss is the mean
over the clients of their mean over the steps.

``precision``: "f32" computes convolutions and products in float32 with
TF32 off; "tf32" lets cuDNN and cuBLAS use TF32 (the control).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from portbench.reference import int8, keys, numerics


def logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> (B, classes)."""
    h = x.permute(0, 3, 1, 2)
    for w, b in (("c1", "b1"), ("c2", "b2"), ("c3", "b3")):
        h = F.conv2d(h, p[w].permute(3, 2, 0, 1), p[b], padding=1)
        h = F.max_pool2d(F.relu(h), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ p["fc"] + p["fb"])
    return h @ p["out"] + p["ob"]


def loss(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits(p, x), y)


def lane_rounds(p0: dict, x: torch.Tensor, y: torch.Tensor, parts: list, seed: int,
                lr: float, rounds: int, train: dict, prec: str = "f32",
                half_batch: bool = False):
    """Rounds 0 .. rounds - 1 of one trajectory from the weights ``p0``.

    x, y: the root data on the device; parts: each client's item indices;
    ``train``: the job's n_clients, cohort, local_steps, batch_size,
    straggler_prob, straggler_overprovision, drop_prob, straggler_slowdown.
    ``half_batch``: each step reads only the first half of its batch (a
    fault the comparison must catch). Returns (losses, [params after each
    round])."""
    C, steps, B = train["n_clients"], train["local_steps"], train["batch_size"]
    dev = x.device
    lens = [len(p) for p in parts]
    p = {k: v.clone() for k, v in p0.items()}
    residual = {k: torch.zeros((C, *v.shape), dtype=v.dtype, device=dev)
                for k, v in p.items()}
    step = vmap(grad_and_value(loss))
    losses, after = [], []
    if prec not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {prec!r}")
    with numerics.tf32(prec == "tf32"):
        for r in range(rounds):
            mask = keys.cohort(seed, r, C, train["cohort"], train["straggler_overprovision"],
                               train["drop_prob"], train["straggler_prob"],
                               train["straggler_slowdown"])
            w = torch.tensor([lens[c] * mask[c] for c in range(C)], dtype=torch.float32,
                             device=dev)
            sel = torch.as_tensor(np.stack([
                parts[c][keys.batch_positions(seed, r, c, lens[c], steps * B)]
                for c in range(C)]), device=dev).reshape(C, steps, B)
            if half_batch:
                sel = sel[:, :, :B // 2]
            pc = {k: v.expand(C, *v.shape).clone() for k, v in p.items()}
            step_losses = []
            for s in range(steps):
                g, l_c = step(pc, x[sel[:, s]], y[sel[:, s]])
                pc = {k: pc[k] - lr * g[k] for k in pc}
                step_losses.append(l_c)
            losses.append(float(torch.stack(step_losses).mean(0).mean()))
            den = torch.clamp(w.sum(), min=1e-12)
            new = {}
            for k in p:
                d = pc[k] - p[k] + residual[k]
                sent = int8.roundtrip(d, lead=1)
                residual[k] = d - sent
                new[k] = p[k] + torch.tensordot(w, sent, dims=1) / den
            p = new
            after.append({k: v.clone() for k, v in p.items()})
    return losses, after
