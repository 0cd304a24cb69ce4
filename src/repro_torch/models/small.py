"""The paper's own experiment models: 3-conv CNN, 4-hidden MLP, logreg (port
of ``repro/models/small.py``).

Params are a plain ``dict[str, Tensor]`` with the JAX package's names and
layouts: HWIO conv kernels, ``(in, out)`` dense weights, NHWC inputs. That
keeps the packed int8 stream (``core/packing.py``) and weights carried across
(``interop.py``) identical between the two packages; ``logits`` converts to
PyTorch's NCHW/OIHW only around the convolutions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

CIFAR_SHAPE = (32, 32, 3)
MNIST_SHAPE = (28, 28, 1)


def _conv(h, w, b):
    """NCHW activations, HWIO kernel: a 3x3 'SAME' cross-correlation. The
    bias is added after the convolution, not fused into it: under a
    campaign's vmap over lanes (per-lane biases) the convolution runs
    without its bias, so the single run must too for the lanes to be
    bitwise its trajectory."""
    return F.conv2d(h, w.permute(3, 2, 0, 1), padding=1) + b[:, None, None]


@dataclasses.dataclass(frozen=True)
class SmallModel:
    """One of the paper's small classifiers over a param dict."""
    cfg: ModelConfig
    kind: str                     # cnn | mlp | logreg

    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        """Fresh params on the generator's device (logreg starts at zero)."""
        C = self.cfg.vocab_size   # num classes
        dev = generator.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if self.kind == "cnn":
            ch = self.cfg.d_model
            return {
                "c1": dense_init(generator, (3, 3, 3, ch // 2), 27, dtype),
                "b1": zeros(ch // 2),
                "c2": dense_init(generator, (3, 3, ch // 2, ch), 9 * ch // 2, dtype),
                "b2": zeros(ch),
                "c3": dense_init(generator, (3, 3, ch, ch), 9 * ch, dtype),
                "b3": zeros(ch),
                "fc": dense_init(generator, (4 * 4 * ch, self.cfg.d_ff), 4 * 4 * ch, dtype),
                "fb": zeros(self.cfg.d_ff),
                "out": dense_init(generator, (self.cfg.d_ff, C), self.cfg.d_ff, dtype),
                "ob": zeros(C),
            }
        if self.kind == "mlp":
            d_in = math.prod(CIFAR_SHAPE)
            h = self.cfg.d_model
            p = {"w0": dense_init(generator, (d_in, h), d_in, dtype), "b0": zeros(h)}
            for i in range(1, self.cfg.n_layers):
                p[f"w{i}"] = dense_init(generator, (h, h), h, dtype)
                p[f"b{i}"] = zeros(h)
            p["out"] = dense_init(generator, (h, C), h, dtype)
            p["ob"] = zeros(C)
            return p
        d_in = self.cfg.d_model                      # 784
        return {"w": zeros(d_in, C), "b": zeros(C)}

    def logits(self, params: dict, x):
        """x: (B, H, W, C) NHWC -> (B, n_classes)."""
        if self.kind == "cnn":
            # a contiguous NCHW copy: the convs then take the same path at
            # any batch, whatever strides a vmap gives the input
            h = x.permute(0, 3, 1, 2).contiguous()
            for i, name in enumerate(["c1", "c2", "c3"]):
                h = F.relu(_conv(h, params[name], params[f"b{i + 1}"]))
                h = F.max_pool2d(h, 2)
            # back to NHWC before the flatten, so ``fc`` rows keep the JAX order
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
            h = F.relu(h @ params["fc"] + params["fb"])
            return h @ params["out"] + params["ob"]
        if self.kind == "mlp":
            h = x.reshape(x.shape[0], -1)
            for i in range(self.cfg.n_layers):
                h = F.relu(h @ params[f"w{i}"] + params[f"b{i}"])
            return h @ params["out"] + params["ob"]
        h = x.reshape(x.shape[0], -1)
        return h @ params["w"] + params["b"]

    def loss(self, params: dict, batch: dict):
        """Mean negative log-likelihood of ``batch["y"]``."""
        lp = F.log_softmax(self.logits(params, batch["x"]).to(torch.float32), -1)
        return -torch.gather(lp, 1, batch["y"][:, None]).mean()

    def accuracy(self, params: dict, batch: dict):
        """Fraction of ``batch`` classified correctly."""
        lg = self.logits(params, batch["x"])
        return (torch.argmax(lg, -1) == batch["y"]).to(torch.float32).mean()


def build_small(cfg: ModelConfig) -> SmallModel:
    """The ``SmallModel`` for a ``flsim-*`` config."""
    kind = {"flsim-cnn": "cnn", "flsim-mlp": "mlp",
            "flsim-logreg": "logreg"}[cfg.name]
    return SmallModel(cfg, kind)


def count_small_params(cfg: ModelConfig) -> int:
    """Parameter count of a ``flsim-*`` model: the elements of its
    ``SmallModel.init`` leaves."""
    params = build_small(cfg).init(torch.Generator())
    return sum(t.numel() for t in params.values())


def input_shape(cfg: ModelConfig):
    """NHWC input shape of one example: MNIST for logreg, else CIFAR."""
    return MNIST_SHAPE if cfg.name == "flsim-logreg" else CIFAR_SHAPE
