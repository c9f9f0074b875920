from repro_torch.kernels.paged_attention.ops import (decode_attention,
                                                     paged_attention)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
