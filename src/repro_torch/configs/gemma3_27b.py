"""Gemma-3 27B [hf:google/gemma-3-27b-pt lineage]: 62 layers, d_model 5376,
32 query heads over 16 KV heads of head_dim 128, d_ff 21504, vocab 262144;
five local layers (window 1024) to one global, rope theta 1e6.  Hybrid, so
long_500k runs.  The port's own copy of ``repro.configs.gemma3_27b``."""
import torch

from repro_torch.models.transformer.layers import LMConfig

FAMILY = "lm"
SKIP_SHAPES = {}


def full_config() -> LMConfig:
    return LMConfig(name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32,
                    n_kv_heads=16, d_head=128, d_ff=21504, vocab=262144,
                    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
                    rope_theta=1e6, dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(name="gemma3-smoke", n_layers=7, d_model=64, n_heads=4,
                    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                    window_pattern=(8, 8, 0), dtype=torch.float32)
