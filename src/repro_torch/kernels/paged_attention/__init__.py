from repro_torch.kernels.paged_attention.ops import (decode_attention,
                                                     paged_attention,
                                                     paged_attention_split,
                                                     split_pages)
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_split_ref)
