"""Model / training / parallelism configuration dataclasses.

One ``ModelConfig`` covers all 10 assigned families via the *super-block
pattern*: a model is ``prefix_layers`` (unscanned) followed by
``n_superblocks`` repetitions of ``pattern`` executed under ``lax.scan`` with
stacked parameters.  Each pattern entry is ``(mixer, ffn)``:

    mixer ∈ {"attn", "attn_local", "attn_mla", "mamba"}
    ffn   ∈ {"dense", "moe", "none"}

Scanning keeps the HLO size O(pattern) instead of O(n_layers) — essential for
compile time on 42-88-layer models — and gives XLA a natural window to overlap
per-layer collectives with the next layer's compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

Pattern = Tuple[Tuple[str, str], ...]

MIXERS = ("attn", "attn_local", "attn_mla", "mamba")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    sliding_window: int = 4096           # window for "attn_local" mixers
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    final_softcap: Optional[float] = None    # gemma2: 30.0
    # MLA (deepseek)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # dense FFN
    d_ff: int = 0
    activation: str = "swiglu"           # "swiglu" | "gelu"
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    moe_groups: int = 1                  # dispatch groups (= data shards for EP; see moe.py)
    # Mamba
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0                 # 0 => ceil(d_model/16)
    # structure
    pattern: Pattern = (("attn", "dense"),)
    prefix_pattern: Pattern = ()         # unscanned leading layers (deepseek dense layer)
    encoder_only: bool = False           # bidirectional, no decode step
    tie_embeddings: bool = True
    frontend: str = "none"               # "none" | "audio" | "vision" (stub: embeddings in)
    norm_eps: float = 1e-6
    post_norm: bool = False              # gemma2: extra post-mixer/post-ffn norms
    scale_embed: bool = False            # gemma2: embeddings scaled by sqrt(d)
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # kernels: force the Pallas rmsnorm / flash attention / ssm scan
    # (interpret mode off TPU) inside the train step instead of the reference
    # ops.  Static model fields so the population compile caches key on them
    # (via static_step_key).
    fused_rmsnorm: bool = False
    fused_attention: bool = False
    fused_ssm: bool = False

    def __post_init__(self):
        for mixer, ffn in self.pattern + self.prefix_pattern:
            assert mixer in MIXERS, mixer
            assert ffn in FFNS, ffn
        body = self.n_layers - len(self.prefix_pattern)
        assert body % len(self.pattern) == 0, (
            f"{self.name}: {body} body layers not divisible by pattern of {len(self.pattern)}"
        )

    @property
    def n_superblocks(self) -> int:
        return (self.n_layers - len(self.prefix_pattern)) // len(self.pattern)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def has_attention(self) -> bool:
        pats = self.pattern + self.prefix_pattern
        return any(m.startswith("attn") for m, _ in pats)

    @property
    def has_mamba(self) -> bool:
        return any(m == "mamba" for m, _ in self.pattern + self.prefix_pattern)

    @property
    def has_moe(self) -> bool:
        return any(f == "moe" for _, f in self.pattern + self.prefix_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no pattern entry does full-length dense attention —
        the prompt's criterion for running long_500k."""
        return not any(m in ("attn", "attn_mla") for m, _ in self.pattern + self.prefix_pattern)

    # -- parameter counting (for roofline MODEL_FLOPS) ---------------------------
    def param_counts(self) -> Dict[str, float]:
        d, hd = self.d_model, self.resolved_head_dim
        counts = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            counts["unembed"] = self.vocab_size * d

        def mixer_params(m: str) -> float:
            if m == "mamba":
                di, ds, dr = self.d_inner, self.ssm_state, self.dt_rank
                return (d * 2 * di + di * d + di * (dr + 2 * ds) + dr * di
                        + di * self.ssm_conv + di * ds + di)
            if m == "attn_mla":
                r, rr = self.kv_lora_rank, self.rope_head_dim
                # wq projects to (H, hd + rope_head_dim)
                q = d * self.n_heads * (hd + rr) if not self.q_lora_rank else (
                    d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (hd + rr))
                kv = d * (r + rr) + r * self.n_heads * (hd + hd)  # k_nope + v up-proj
                o = self.n_heads * hd * d
                return q + kv + o
            # gqa / local
            return d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d

        def ffn_params(f: str) -> float:
            if f == "none":
                return 0.0
            if f == "moe":
                n_mats = 3 if self.activation == "swiglu" else 2
                per = n_mats * d * self.moe_d_ff
                return (self.n_experts + self.n_shared_experts) * per + d * self.n_experts
            n_mats = 3 if self.activation == "swiglu" else 2
            return n_mats * d * self.d_ff

        def ffn_active(f: str) -> float:
            if f == "moe":
                n_mats = 3 if self.activation == "swiglu" else 2
                per = n_mats * d * self.moe_d_ff
                return (self.moe_top_k + self.n_shared_experts) * per
            return ffn_params(f)

        total_block = active_block = 0.0
        body = list(self.prefix_pattern) + list(self.pattern) * self.n_superblocks
        for m, f in body:
            total_block += mixer_params(m) + ffn_params(f)
            active_block += mixer_params(m) + ffn_active(f)
        counts["blocks_total"] = total_block
        counts["blocks_active"] = active_block
        counts["total"] = counts["embed"] + counts.get("unembed", 0) + total_block
        counts["active"] = counts["embed"] + counts.get("unembed", 0) + active_block
        return counts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: either a training step or a decode step."""

    name: str
    seq_len: int
    global_batch: int
    kind: str = "train"  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Parallelism + memory policy for one run."""

    mesh_shape: Tuple[int, ...] = (1, 1)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    microbatch: int = 0                  # 0 = no gradient accumulation
    remat: str = "full"                  # "none" | "full" | "dots"
    # optimizer state dtypes (memory levers for the 100B+ archs)
    master_dtype: Optional[str] = None   # None = update params in param_dtype
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"
    grad_allreduce_dtype: str = "bfloat16"  # gradient compression on the wire
    shard_cache_seq: bool = False        # long-context decode: shard KV/seq over data axis
    zero_stage: str = "fsdp"             # "fsdp" (params+opt data-sharded) | "zero1"
                                         # (params replicated over data, opt sharded:
                                         #  kills per-microbatch weight all-gathers)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    parallel: ParallelConfig = ParallelConfig()
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    z_loss: float = 0.0
