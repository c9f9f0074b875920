"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B]: 40 layers, d_model 2560, 20 heads (MHA)
of head_dim 128, d_ff 6912, vocab 151936, QKV bias.  Pure full attention,
so long_500k is skipped.  The port's own copy of
``repro.configs.qwen1_5_4b``."""
import torch

from repro_torch.models.transformer.layers import LMConfig

FAMILY = "lm"
SKIP_SHAPES = {"long_500k": "pure full-attention arch (per assignment brief)"}


def full_config() -> LMConfig:
    return LMConfig(name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20,
                    n_kv_heads=20, d_head=128, d_ff=6912, vocab=151936,
                    qkv_bias=True, window_pattern=(0,), dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
                    qkv_bias=True, window_pattern=(0,), dtype=torch.float32)
