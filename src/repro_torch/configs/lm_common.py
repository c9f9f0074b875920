"""The LM shape table (shapes assigned to the LM family), the port's copy
of ``repro.configs.lm_common.LM_SHAPES``.  The registry makes each shape's
batch and cache as ``device="meta"`` tensors where the JAX package builds
``ShapeDtypeStruct``s (``token_specs`` / ``decode_specs``)."""
from __future__ import annotations

# shape name -> (seq_len, global_batch, kind)
LM_SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}
