"""Configuration dataclasses for models, input shapes, device meshes and FL
jobs (port of ``repro/configs/base.py``).

A copy, not an import: the port imports nothing of ``repro``. ``get_config``
resolves every architecture of the JAX package: the paper's small models
(``flsim-*``), the dense GQA LMs, MLA (minicpm3-4b), the MoE LMs
(qwen3-moe-30b-a3b, arctic-480b), the encoder-decoder (whisper-base),
xLSTM (xlstm-125m) and the Mamba hybrid (jamba-1.5-large-398b).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import importlib
from typing import Optional, Sequence


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek/MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (the JAX package's fields)."""
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    dense_residual_d_ff: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    ep_mode: str = "model"
    f_sub: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba / xLSTM settings (the JAX package's fields)."""
    kind: str = "mamba"           # "mamba" | "xlstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> d_model // 16
    chunk: int = 256
    slstm_every: int = 4
    proj_factor: float = 2.0


@dataclass(frozen=True)
class HybridConfig:
    """Jamba-style periodic layout."""
    period: int = 8
    attn_index: int = 4


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
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    n_enc_layers: int = 0
    dec_len_ratio: int = 8
    input_kind: str = "token"
    notes: str = ""
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX package shards it)."""
        v, m = self.vocab_size, 256
        return (v + m - 1) // m * m

    def replace(self, **kw) -> "ModelConfig":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **kw)

    # parameter counts (the N of a 6·N·D FLOP estimate)
    def param_count(self, padded: bool = False) -> int:
        """``models/model_zoo.count_params``: every parameter."""
        from repro_torch.models.model_zoo import count_params
        return count_params(self, padded=padded)

    def active_param_count(self, padded: bool = False) -> int:
        """``count_params(active_only=True)``: top_k of each MoE layer's
        experts."""
        from repro_torch.models.model_zoo import count_params
        return count_params(self, padded=padded, active_only=True)


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
    max_cohort: int = 0               # ragged client plane: K cohort slots (0: off)
    streaming: bool = False           # stream the sampled shards from the host
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


# ---------------------------------------------------------------------------
# Input shapes (the JAX package's assigned set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One step's input shape: sequence length, global batch and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}

# archs with sub-quadratic token mixing also run long_500k
SUBQUADRATIC = ("xlstm-125m", "jamba-1.5-large-398b")


def shapes_for(arch: str) -> Sequence[str]:
    """The shape names an arch runs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        names.append("long_500k")
    return tuple(names)


# FLConfig fields a campaign sweeps as per-lane runtime values (the scalar
# plane, ``core/sweeps.scalar_plane``); the single-run executor threads the
# same names as device tensors, so a lane computes what a single run does.
SWEEPABLE_SCALARS = ("seed", "client_lr", "server_lr", "server_momentum",
                     "prox_mu", "moon_mu", "moon_tau", "dp_clip", "dp_noise")

# FLConfig fields a campaign may sweep categorically: each value changes the
# round program itself, so the planner (``core/plan.py``) buckets lanes by
# program signature instead.
SWEEPABLE_CATEGORICAL = ("strategy", "topology", "placement", "mode",
                         "async_buffer", "compression")


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh: ``(data, model)``, or ``(pod, data, model)`` with
    ``multi_pod``, and the campaigns' lane axis in front when ``lanes > 1``
    (``launch/mesh.lane_mesh``; ``runtime/campaign.py`` pads S to a multiple
    of it with dead lanes). ``lanes = 1`` means no lane axis: the one-process
    campaign."""
    multi_pod: bool = False
    data: int = 16
    model: int = 16
    pods: int = 2
    lanes: int = 1

    @property
    def shape(self):
        base = ((self.pods, self.data, self.model) if self.multi_pod
                else (self.data, self.model))
        return (self.lanes,) + base if self.lanes > 1 else base

    @property
    def axes(self):
        base = (("pod", "data", "model") if self.multi_pod
                else ("data", "model"))
        return ("lanes",) + base if self.lanes > 1 else base

    @property
    def n_chips(self) -> int:
        n = self.data * self.model
        if self.multi_pod:
            n *= self.pods
        return n * self.lanes if self.lanes > 1 else n


ARCHS = (
    "minicpm3-4b",
    "qwen2.5-32b",
    "yi-34b",
    "qwen1.5-32b",
    "whisper-base",
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "chameleon-34b",
    "xlstm-125m",
    "jamba-1.5-large-398b",
)

_SMALL = ("flsim-cnn", "flsim-mlp", "flsim-logreg")
# LM architectures the port runs: every one of ARCHS
_PORTED_LM = ("yi-34b", "qwen2.5-32b", "qwen1.5-32b", "chameleon-34b", "minicpm3-4b",
              "qwen3-moe-30b-a3b", "arctic-480b", "whisper-base", "xlstm-125m",
              "jamba-1.5-large-398b")


def get_config(name: str) -> ModelConfig:
    """Resolve an architecture's config by name."""
    if name in _SMALL:
        from repro_torch.configs import flsim_small
        return getattr(flsim_small, name.replace("-", "_").upper())
    if name in _PORTED_LM:
        mod = importlib.import_module(
            f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
        return mod.CONFIG
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS + _SMALL)}")


def list_archs() -> Sequence[str]:
    """The LM architectures of the assignment (``ARCHS``)."""
    return ARCHS
