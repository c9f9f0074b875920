"""Kimi-K2 1T-A32B [arXiv:2501.kimi2, paper table]: 61 layers, d_model
7168, 64 query heads over 8 KV heads, MoE of 384 experts top-8 with expert
d_ff 2048 and one shared expert, vocab 163840, rope theta 1e6.  As in the
JAX package: head_dim 128 (GQA in place of MLA; 7168 / 64 = 112 padded to
128) and the shared expert of the DeepSeek lineage.  Pure full attention,
so long_500k is skipped.  The optimizer state is 8-bit (1 T parameters).
The port's own copy of ``repro.configs.kimi_k2_1t_a32b``."""
import torch

from repro_torch.models.transformer.layers import LMConfig

FAMILY = "lm"
SKIP_SHAPES = {"long_500k": "pure full-attention arch (per assignment brief)"}
QUANTIZED_OPT = True


def full_config() -> LMConfig:
    return LMConfig(name="kimi-k2-1t-a32b", n_layers=61, d_model=7168,
                    n_heads=64, n_kv_heads=8, d_head=128, d_ff=2048,
                    vocab=163840, moe=True, n_experts=384, top_k=8,
                    n_shared_experts=1, window_pattern=(0,), rope_theta=1e6,
                    dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_head=16, d_ff=32, vocab=256, moe=True,
                    n_experts=8, top_k=2, n_shared_experts=1,
                    capacity_factor=8.0, window_pattern=(0,),
                    dtype=torch.float32)
