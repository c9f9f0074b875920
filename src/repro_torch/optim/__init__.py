"""Optimizers of the port (``repro.optim``): AdamW (plain and 8-bit), the
warmup-cosine schedule and the gradient compressors."""
from repro_torch.optim.adamw import (AdamWConfig, QTensor, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state)
from repro_torch.optim.compress import (ErrorFeedback, int8_compress,
                                        int8_decompress, topk_compress,
                                        topk_decompress)
from repro_torch.optim.schedules import warmup_cosine
