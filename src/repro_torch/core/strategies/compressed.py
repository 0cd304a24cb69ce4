"""Communication-efficient FL: int8 / top-k delta compression with error
feedback (port of ``repro/core/strategies/compressed.py``). Deltas carry a
leading client dim."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.strategy import Strategy, tree_zeros_like
from repro_torch.kernels import ref as kref


def _roundtrip_int8(x, block=256):
    """Quantize-dequantize one (C, ...) leaf, each client on its own."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    pad = (-n) % block
    fp = F.pad(flat, (0, pad)) if pad else flat
    q, sc = kref.quantize_blockwise_ref(fp.float(), block=block)
    deq = (q.float().reshape(x.shape[0], -1, block) * sc[..., None])
    return deq.reshape(x.shape[0], -1)[:, :n].reshape(x.shape).to(x.dtype)


def _topk_mask(x, ratio):
    """Exactly-k mask of each client's (C, ...) leaf: the k largest
    magnitudes, ties to the lowest flat index (a stable descending sort;
    ``torch.topk`` promises no order among ties), k = max(1, int(n * ratio))."""
    flat = torch.abs(x.to(torch.float32)).reshape(x.shape[0], -1)
    k = max(1, int(flat.shape[1] * ratio))
    idx = torch.sort(flat, dim=1, descending=True, stable=True).indices[:, :k]
    mask = torch.zeros_like(flat).scatter_(1, idx, 1.0)
    return mask.reshape(x.shape).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class CompressedFedAvg(Strategy):
    """FedAvg over a lossy compressor with error feedback (int8/topk)."""
    name: str = "compressed"

    def client_state_init(self, params):
        """Zero error-feedback residual, shaped like the params."""
        if self.fl.error_feedback:
            return {"residual": tree_zeros_like(params)}
        return {}

    def _with_residual(self, delta, client_state):
        ef = self.fl.error_feedback and "residual" in (client_state or {})
        if ef:
            res = client_state["residual"]
            delta = {k: d + res[k].to(d.dtype) for k, d in delta.items()}
        return delta, ef

    def postprocess(self, delta, client_state, rng):
        """Compress delta + residual, round-trip it, keep the new residual."""
        delta, ef = self._with_residual(delta, client_state)
        if self.fl.compression == "int8":
            sent = {k: _roundtrip_int8(d) for k, d in delta.items()}
        elif self.fl.compression == "topk":
            sent = {k: d * _topk_mask(d, self.fl.topk_ratio)
                    for k, d in delta.items()}
        else:
            sent = delta
        if ef:
            return sent, {"residual": {k: delta[k] - sent[k] for k in delta}}
        return sent, client_state

    # -- packed int8 path (kernels/ops.quant_aggregate) -------------------
    @property
    def packs_deltas(self) -> bool:
        """True when the int8 path emits ``PackedDelta`` for fused aggregation."""
        return self.fl.compression == "int8"

    def postprocess_packed(self, delta, client_state, rng, out=None):
        """(C, N) int8 + (C, N/256) block-scale emission in the kernel's flat
        layout, into ``out``'s rows where given. The error-feedback residual
        is computed against the dequantized send (what the server
        reconstructs); per-leaf packing makes it bitwise the residual
        ``_roundtrip_int8`` would give."""
        delta, ef = self._with_residual(delta, client_state)
        pd = packing.quantize_tree(delta, lead=1, out=out)
        if ef:
            sent = packing.unpack_tree(packing.dequant_flat(pd), delta, lead=1)
            return pd, {"residual": {k: delta[k] - sent[k].to(delta[k].dtype)
                                     for k in delta}}
        return pd, client_state
