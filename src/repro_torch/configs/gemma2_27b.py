"""Gemma-2 27B [arXiv:2408.00118]: 46 layers, d_model 4608, 32 query heads
over 16 KV heads of head_dim 128, d_ff 36864, vocab 256000; local (window
4096) and global layers alternate; attention softcap 50, final softcap 30.
Hybrid local / global, so long_500k runs.  The port's own copy of
``repro.configs.gemma2_27b``."""
import torch

from repro_torch.models.transformer.layers import LMConfig

FAMILY = "lm"
SKIP_SHAPES = {}


def full_config() -> LMConfig:
    return LMConfig(name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
                    n_kv_heads=16, d_head=128, d_ff=36864, vocab=256000,
                    window_pattern=(4096, 0), attn_softcap=50.0,
                    final_softcap=30.0, dtype=torch.bfloat16)


def smoke_config() -> LMConfig:
    return LMConfig(name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4,
                    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                    window_pattern=(8, 0), attn_softcap=50.0,
                    final_softcap=30.0, dtype=torch.float32)
