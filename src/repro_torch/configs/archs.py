"""The 10 assigned architecture configs (exact published configurations)
plus reduced same-family smoke configs for CPU tests.

Each arch also has its own module ``repro_torch/configs/<id>.py`` re-exporting
``CONFIG``/``SMOKE_CONFIG`` so ``--arch <id>`` resolves per file.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                RWKVConfig, SSMConfig)

# ---------------------------------------------------------------------------
# Full configs
# ---------------------------------------------------------------------------

GLM4_9B = ArchConfig(
    name="glm4-9b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
    attention="gqa", rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b; hf",
)

QWEN15_4B = ArchConfig(
    name="qwen1.5-4b", family="dense", num_layers=40, d_model=2560,
    num_heads=20, num_kv_heads=20, d_ff=6912, vocab_size=151936,
    attention="gqa", qkv_bias=True, rope_theta=5000000.0,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)

GEMMA3_4B = ArchConfig(
    name="gemma3-4b", family="dense", num_layers=34, d_model=2560,
    num_heads=8, num_kv_heads=4, d_ff=10240, vocab_size=262144,
    head_dim=256, attention="gqa", qk_norm=True,
    sliding_window=1024, local_global_pattern=6, rope_theta=1000000.0,
    tie_embeddings=True, sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)

QWEN3_17B = ArchConfig(
    name="qwen3-1.7b", family="dense", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=6144, vocab_size=151936,
    head_dim=128, attention="gqa", qk_norm=True, rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)

GRANITE_MOE_3B = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32,
    d_model=1536, num_heads=24, num_kv_heads=8, d_ff=512,
    vocab_size=49155, attention="gqa", rope_theta=10000.0,
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

DEEPSEEK_V2_236B = ArchConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=12288, vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, d_shared=1536),
    moe_layer_start=1, rope_theta=10000.0, microbatch=8,
    source="arXiv:2405.04434; hf",
)

ZAMBA2_27B = ArchConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    attention="gqa", ssm=SSMConfig(state_dim=64, head_dim=64, expand=2),
    attn_every=6, rope_theta=10000.0, sub_quadratic=True,
    source="arXiv:2411.15242; hf",
)

RWKV6_3B = ArchConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=8960, vocab_size=65536,
    attention="none", rwkv=RWKVConfig(head_dim=64), sub_quadratic=True,
    source="arXiv:2404.05892; hf",
)

LLAVA_NEXT_MISTRAL_7B = ArchConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32,
    d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
    vocab_size=32000, attention="gqa", rope_theta=1000000.0,
    num_patches=576,   # base 24x24 grid; anyres tiles are a stub frontend
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

WHISPER_SMALL = ArchConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    attention="gqa", encoder_layers=12, encoder_frames=1500,
    rope_theta=10000.0,
    source="arXiv:2212.04356; unverified",
)

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        GLM4_9B, QWEN15_4B, GEMMA3_4B, QWEN3_17B, GRANITE_MOE_3B,
        DEEPSEEK_V2_236B, ZAMBA2_27B, RWKV6_3B, LLAVA_NEXT_MISTRAL_7B,
        WHISPER_SMALL,
    ]
}

# ---------------------------------------------------------------------------
# Reduced smoke configs — same family/topology, tiny dims
# ---------------------------------------------------------------------------


def _smoke(cfg: ArchConfig, **over) -> ArchConfig:
    base = dict(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, microbatch=2, remat=False,
    )
    base.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)


SMOKE: dict[str, ArchConfig] = {
    "glm4-9b": _smoke(GLM4_9B),
    "qwen1.5-4b": _smoke(QWEN15_4B, num_heads=4, num_kv_heads=4),
    "gemma3-4b": _smoke(GEMMA3_4B, num_layers=7, num_heads=4,
                        num_kv_heads=2, sliding_window=8,
                        local_global_pattern=3),
    "qwen3-1.7b": _smoke(QWEN3_17B),
    "granite-moe-3b-a800m": _smoke(
        GRANITE_MOE_3B,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32)),
    "deepseek-v2-236b": _smoke(
        DEEPSEEK_V2_236B, num_heads=4, num_kv_heads=4,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                      num_shared_experts=1, d_shared=32),
        moe_layer_start=1, num_layers=3),
    "zamba2-2.7b": _smoke(ZAMBA2_27B, num_layers=5, attn_every=2,
                          ssm=SSMConfig(state_dim=8, head_dim=16, expand=2,
                                        conv_width=4, chunk=4)),
    "rwkv6-3b": _smoke(RWKV6_3B, num_heads=4, num_kv_heads=4,
                       rwkv=RWKVConfig(head_dim=16, chunk=4)),
    "llava-next-mistral-7b": _smoke(LLAVA_NEXT_MISTRAL_7B, num_patches=4),
    "whisper-small": _smoke(WHISPER_SMALL, encoder_layers=2,
                            encoder_frames=12),
}
