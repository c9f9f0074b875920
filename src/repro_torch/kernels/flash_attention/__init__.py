from repro_torch.kernels.flash_attention.ops import attention, flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                   attention_ref_bf16_p)
