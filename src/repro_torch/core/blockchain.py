"""Pluggable blockchain (port of ``repro/core/blockchain.py``; paper §2.4,
RQ4) — host-side hash-chain ledger.

The paper plugs Ethereum / Hyperledger Fabric behind a Blockchain API with
three user extension points: a platform wrapper, smart contracts, and an
orchestration script. Real chains are I/O, not FLOPs — here the pluggable
boundary is the ``LedgerBackend`` protocol, with an in-process hash chain as
the default backend. It provides the paper's five benefits: parameter
verification, traceable decision-making, global-model provenance, reputation
scores, and (poisoning-)attack detection hooks.

"Smart contracts" are the consensus callables from core/consensus.py
registered by name — executing consensus "on-chain" means recording its
inputs/outputs in a block.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Protocol

import torch

from repro_torch.checkpoint.ckpt import leaves


def param_digest(tree) -> str:
    """Exact SHA256 over the concatenated parameter bytes (host-side): each
    leaf in JAX's flatten order, copied to the host contiguous, its bytes
    those ``np.asarray(leaf).tobytes()`` gives in the JAX package (a bf16
    leaf as its raw 16-bit words), so the same params give the same hex
    string in both packages."""
    h = hashlib.sha256()
    for leaf in leaves(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class Block:
    """One ledger entry; ``hash`` chains over ``prev_hash`` via SHA256."""

    index: int
    round: int
    kind: str                  # "aggregate" | "consensus" | "global"
    payload: dict
    prev_hash: str
    timestamp: float = 0.0
    hash: str = ""

    def compute_hash(self) -> str:
        """SHA256 over the canonical JSON body (excludes ``hash`` itself)."""
        body = json.dumps(
            {"i": self.index, "r": self.round, "k": self.kind,
             "p": self.payload, "prev": self.prev_hash, "t": self.timestamp},
            sort_keys=True)
        return hashlib.sha256(body.encode()).hexdigest()


class LedgerBackend(Protocol):
    """Pluggable chain interface (swap in a real chain here)."""

    def append(self, round: int, kind: str, payload: dict) -> str:
        """Append a block and return its hash."""
        ...

    def verify(self) -> bool:
        """Check the whole chain's hash links."""
        ...

    def blocks(self) -> list:
        """Return all blocks, genesis first."""
        ...


class HashChainLedger:
    """Default in-process backend."""

    def __init__(self):
        genesis = Block(0, -1, "genesis", {}, "0" * 64, 0.0)
        genesis.hash = genesis.compute_hash()
        self._chain = [genesis]
        self._clock = 0.0
        self.reputation: dict[str, float] = {}

    def append(self, round: int, kind: str, payload: dict) -> str:
        """Append a ``(round, kind, payload)`` block; returns its hash."""
        self._clock += 1.0          # logical clock: deterministic chains
        b = Block(len(self._chain), round, kind, payload,
                  self._chain[-1].hash, self._clock)
        b.hash = b.compute_hash()
        self._chain.append(b)
        return b.hash

    def verify(self) -> bool:
        """Re-hash every block and check the prev-hash links."""
        for prev, cur in zip(self._chain, self._chain[1:]):
            if cur.prev_hash != prev.hash or cur.hash != cur.compute_hash():
                return False
        return True

    def blocks(self) -> list:
        """Return a copy of the chain, genesis first."""
        return list(self._chain)

    # -- FL-specific conveniences ---------------------------------------
    def record_aggregate(self, round: int, worker: str, params) -> str:
        """Record a worker's aggregate-parameter digest for ``round``."""
        return self.append(round, "aggregate",
                           {"worker": worker, "digest": param_digest(params)})

    def record_consensus(self, round: int, contract: str, chosen_digest: str,
                         worker_digests: dict) -> str:
        """Record a consensus outcome and update worker reputations."""
        # reputation: workers whose digest lost the vote get penalized
        for w, d in worker_digests.items():
            rep = self.reputation.get(w, 1.0)
            self.reputation[w] = rep + (0.1 if d == chosen_digest else -0.25)
        return self.append(round, "consensus",
                           {"contract": contract, "chosen": chosen_digest,
                            "workers": worker_digests})

    def record_global(self, round: int, params) -> str:
        """Record the digest of the round's accepted global model."""
        return self.append(round, "global",
                           {"digest": param_digest(params)})

    def provenance(self, digest_: str) -> list:
        """Return every block whose payload mentions ``digest_``."""
        return [b for b in self._chain
                if digest_ in json.dumps(b.payload)]


def get_ledger(kind: str) -> Optional[HashChainLedger]:
    """Resolve a ledger backend by name (``none`` | ``hashchain``)."""
    if kind in ("none", None):
        return None
    if kind == "hashchain":
        return HashChainLedger()
    raise KeyError(f"unknown blockchain backend {kind!r} "
                   "(plug real chains by implementing LedgerBackend)")
