"""Optimizers of the port (``repro.optim`` without ``compress``, whose
gradient compression serves cross-pod data parallelism)."""
from repro_torch.optim.adamw import (AdamWConfig, QTensor, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedules import warmup_cosine
