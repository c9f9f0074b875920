"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48 layers, d_model 2048, 32 query
heads over 4 KV heads of head_dim 128, MoE of 128 experts top-8 with expert
d_ff 768, vocab 151936, rope theta 1e6.  Pure full attention, so long_500k
is skipped.  The port's own copy of ``repro.configs.qwen3_moe_30b_a3b``."""
import torch

from repro_torch.models.transformer.layers import LMConfig

FAMILY = "lm"
SKIP_SHAPES = {"long_500k": "pure full-attention arch (per assignment brief)"}


def full_config() -> LMConfig:
    return LMConfig(name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048,
                    n_heads=32, n_kv_heads=4, d_head=128, d_ff=768,
                    vocab=151936, moe=True, n_experts=128, top_k=8,
                    window_pattern=(0,), rope_theta=1e6,
                    dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_head=16, d_ff=32, vocab=256, moe=True,
                    n_experts=8, top_k=2, capacity_factor=8.0,
                    window_pattern=(0,), dtype=torch.float32)
