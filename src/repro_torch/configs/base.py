"""Configuration dataclasses for models and FL jobs (port of
``repro/configs/base.py``).

A copy, not an import: the port imports nothing of ``repro``. Only the
paper's small models (``flsim-*``) resolve here; the LM architectures come
with the LM slice (ROADMAP A15).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture dimensions; the fields of the JAX package's config."""
    name: str
    family: str                   # dense | moe | encdec | ssm | hybrid | small
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_type: str = "gqa"        # gqa | mla
    mla: Optional[Any] = None
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    hybrid: Optional[Any] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    n_enc_layers: int = 0
    dec_len_ratio: int = 8
    input_kind: str = "token"
    notes: str = ""
    source: str = ""

    def replace(self, **kw) -> "ModelConfig":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FLConfig:
    """One FL job's settings (paper Fig. 2), the JAX package's fields."""
    strategy: str = "fedavg"          # core strategy name
    topology: str = "client_server"   # client_server | hierarchical | decentralized
    placement: str = "auto"           # spatial | temporal | auto
    # rounds run back to back on the device between two host syncs; host
    # I/O (eval, logging) happens only at chunk boundaries. Chunked and
    # unchunked runs are bitwise-identical by contract.
    rounds_per_launch: int = 1
    mode: str = "sync"                # sync | async
    async_buffer: int = 0
    staleness_exponent: float = 0.0
    max_staleness: int = 8
    async_concurrency: int = 0
    n_clients: int = 16               # virtual clients (cohort per round)
    cohort: int = 0                   # 0 -> all clients each round
    max_cohort: int = 0               # ragged client plane (not yet ported)
    streaming: bool = False           # streaming data plane (not yet ported)
    local_epochs: int = 1
    local_steps: int = 1              # local optimizer steps per epoch
    batch_size: int = 32              # per-client local batch (device gather)
    client_lr: float = 0.1
    client_optimizer: str = "sgd"     # sgd | sgdm | adam
    client_momentum: float = 0.0
    server_lr: float = 1.0
    server_optimizer: str = "none"    # none | momentum | adam | yogi
    server_momentum: float = 0.9
    # strategy extras
    prox_mu: float = 0.0
    dp_clip: float = 0.0
    dp_noise: float = 0.0
    moon_mu: float = 0.0
    moon_tau: float = 0.5
    compression: str = "none"         # none | int8 | topk
    topk_ratio: float = 0.01
    error_feedback: bool = True
    # multi-worker consensus
    n_workers: int = 1
    consensus: str = "majority_digest"
    byzantine_workers: int = 0
    # decentralized
    gossip_steps: int = 1
    # data
    partition: str = "dirichlet"      # dirichlet | iid | shards
    dirichlet_alpha: float = 0.5
    seed: int = 0
    deterministic: bool = True
    # runtime / fault-tolerance
    straggler_overprovision: float = 1.0
    drop_tolerance: float = 0.0
    checkpoint_every: int = 0
    blockchain: str = "none"          # none | hashchain
    digest_every_events: int = 0
    rounds: int = 10


_SMALL = ("flsim-cnn", "flsim-mlp", "flsim-logreg")


def get_config(name: str) -> ModelConfig:
    """Resolve a ported architecture's config by name."""
    if name not in _SMALL:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported (the port covers {list(_SMALL)}; "
            "the LM architectures wait for the LM slice, see ROADMAP A15)")
    from repro_torch.configs import flsim_small
    return getattr(flsim_small, name.replace("-", "_").upper())
