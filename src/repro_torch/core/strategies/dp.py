"""Client-level differential privacy (Geyer et al.): clip + Gaussian noise
(port of ``repro/core/strategies/dp.py``).

The noise of a client's leaf is keyed by ``fold_in(client key, leaf index)``
(leaves in sorted-key order) and drawn counter-based on the device
(``determinism.normal``), so it depends on (seed, absolute round, client,
leaf) alone: chunked and unchunked runs draw the same noise.

The clip uses the whole delta's norm and each element's noise is drawn at
its flat index in its whole leaf, both through the round's view of the
model (``Strategy.shards``), so on a mesh, where the rank holds a shard of
every leaf, the rank's shard of the result is the meshless result's (the
JAX package's ``shard_map`` round clips each shard to ``dp_clip`` and
draws the same noise into every shard of a leaf: ROADMAP C13)."""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import determinism
from repro_torch.core.strategy import Strategy, global_norm


@dataclasses.dataclass(frozen=True)
class DPFedAvg(Strategy):
    """FedAvg with per-client delta clipping and Gaussian noise (DP-FedAvg)."""
    name: str = "dp_fedavg"

    def postprocess(self, delta, client_state, rng):
        """Clip each client's (C, ...) delta to ``dp_clip``, then add noise
        of std ``dp_noise * dp_clip``; ``rng`` is the (C,) client keys."""
        clip, sigma = self.fl.dp_clip, self.fl.dp_noise
        nrm = global_norm(delta, lead=1, shards=self.shards)
        scale = torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)
        out = {}
        for j, k in enumerate(sorted(delta)):
            d = delta[k]
            z = determinism.normal_at(
                determinism.fold_in_tensor(rng, torch.full_like(rng, j))[:, None],
                d[0].numel(), functools.partial(self.shards.flat_index, k, d.device))
            bshape = (-1,) + (1,) * (d.dim() - 1)
            out[k] = d * scale.reshape(bshape) + \
                (sigma * clip * z.reshape(d.shape)).to(d.dtype)
        return out, client_state
