"""Architecture and shape configuration for the repro framework.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (the exact published configuration) and ``SMOKE_CONFIG`` (a
reduced same-family configuration for CPU smoke tests).  The full
configs are exercised only via the AOT dry-run (ShapeDtypeStruct — no
allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden dim
    num_shared_experts: int = 0
    d_shared: int = 0                # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD configuration."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    # small chunk: the exact pairwise intra-chunk tensor is [B,L,L,H,D]
    chunk: int = 32


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    # attention flavour
    attention: str = "gqa"           # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # local/global interleave (gemma3): window size for local layers and
    # the repeating pattern length; layer i is GLOBAL iff (i+1) % pattern == 0.
    sliding_window: int = 0          # 0 => all layers global full attention
    local_global_pattern: int = 0    # e.g. 6 => 5 local : 1 global
    # mixture of experts
    moe: Optional[MoEConfig] = None
    moe_layer_start: int = 0         # dense layers before the first MoE layer
    # MLA
    mla: Optional[MLAConfig] = None
    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_every: int = 0              # zamba2: shared attn block every k SSM layers
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500       # conv-frontend output length (stub)
    # vlm (llava)
    num_patches: int = 0             # patch embeddings prepended (stub frontend)
    # numerics / training
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # distribution knobs (overridable per shape at dry-run time)
    microbatch: int = 16             # micro-batch per grad-accum step (global)
    remat: bool = True
    sub_quadratic: bool = False      # eligible for long_500k
    source: str = ""                 # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        per_layer = 0
        if self.attention == "mla" and self.mla is not None:
            m = self.mla
            qd = (m.qk_nope_head_dim + m.qk_rope_head_dim) * self.num_heads
            if m.q_lora_rank:
                per_layer += d * m.q_lora_rank + m.q_lora_rank * qd
            else:
                per_layer += d * qd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        elif self.attention == "gqa":
            per_layer += d * self.num_heads * hd      # q
            per_layer += 2 * d * self.num_kv_heads * hd  # k, v
            per_layer += self.num_heads * hd * d      # o
        if self.ssm is not None:
            s = self.ssm
            d_inner = s.expand * d
            nheads = d_inner // s.head_dim
            per_layer_ssm = d * (2 * d_inner + 2 * s.state_dim + nheads)
            per_layer_ssm += d_inner * d + s.conv_width * (d_inner + 2 * s.state_dim)
            per_layer_ssm += nheads  # A_log
        if self.rwkv is not None:
            per_layer += 6 * d * d  # r,k,v,g,o,+decay/bonus approx

        def ffn_params(dff: int) -> int:
            return 3 * d * dff  # SwiGLU

        if self.family == "ssm" and self.rwkv is not None:
            per_layer += 2 * d * self.d_ff  # rwkv channel-mix (k,v) + recept
            per_layer += d * d
        elif self.ssm is None:
            per_layer += ffn_params(self.d_ff)

        n_moe_layers = 0
        if self.moe is not None:
            n_moe_layers = L - self.moe_layer_start
            moe_layer = self.moe.num_experts * 3 * d * self.moe.d_expert
            moe_layer += self.moe.num_shared_experts * 3 * d * self.moe.d_shared
            moe_layer += d * self.moe.num_experts
            dense_layer = per_layer + ffn_params(self.d_ff)
            n += self.moe_layer_start * dense_layer
            n += n_moe_layers * (per_layer + moe_layer)
        elif self.ssm is not None and self.attn_every:
            # zamba2: L ssm layers + shared attention applied every attn_every
            d_inner = self.ssm.expand * d
            nheads = d_inner // self.ssm.head_dim
            ssm_layer = (d * (2 * d_inner + 2 * self.ssm.state_dim + nheads)
                         + d_inner * d
                         + self.ssm.conv_width * (d_inner + 2 * self.ssm.state_dim) + nheads)
            shared_attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                           + self.num_heads * hd * d + ffn_params(self.d_ff))
            n += L * ssm_layer + shared_attn
        elif self.ssm is not None:
            d_inner = self.ssm.expand * d
            nheads = d_inner // self.ssm.head_dim
            ssm_layer = (d * (2 * d_inner + 2 * self.ssm.state_dim + nheads)
                         + d_inner * d
                         + self.ssm.conv_width * (d_inner + 2 * self.ssm.state_dim) + nheads)
            n += L * ssm_layer
        else:
            n += L * per_layer
        if self.encoder_layers:
            enc_layer = (d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd * 2
                         + ffn_params(self.d_ff))
            n += self.encoder_layers * enc_layer
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        total = self.param_count()
        m = self.moe
        n_moe_layers = L - self.moe_layer_start
        all_experts = n_moe_layers * m.num_experts * 3 * d * m.d_expert
        active_experts = n_moe_layers * m.top_k * 3 * d * m.d_expert
        return total - all_experts + active_experts


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> Sequence[Tuple[str, str]]:
    """All (arch, shape) dry-run cells for one architecture.

    ``long_500k`` requires sub-quadratic attention; it is skipped (and the
    skip is documented in DESIGN.md §4) for pure full-attention archs.
    """
    out = [(cfg.name, "train_4k"), (cfg.name, "prefill_32k"),
           (cfg.name, "decode_32k")]
    if cfg.sub_quadratic:
        out.append((cfg.name, "long_500k"))
    return out
