"""Hand-written Hopper kernels of the port and their plain torch versions.

Each wrapper checks its inputs, runs the plain version for a CPU tensor and
launches its CUDA kernel (``repro_torch/csrc``) for a CUDA tensor: the
GTChain segment sum and block gather of the graph path, flash (prefill) and
paged (decode) attention of the LM serving path, EmbeddingBag (the
SASRec item lookup), and the FindNeighbor chain walks (point reads,
deletes and the sampler's draws).
"""
from repro_torch.kernels.block_gather import block_gather_ref, gather_rows
from repro_torch.kernels.chain_walk import (locate, locate_ref, rank_walk,
                                            rank_walk_ref)
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_ref,
                                               embedding_bag_sorted,
                                               embedding_bag_sorted_ref)
from repro_torch.kernels.segment_matmul import segment_matmul, segment_sum_ref
from repro_torch.kernels.flash_attention import (attention, attention_ref,
                                                 flash_attention)
from repro_torch.kernels.paged_attention import (decode_attention,
                                                 paged_attention,
                                                 paged_attention_ref,
                                                 paged_attention_split,
                                                 paged_attention_split_ref,
                                                 split_pages)
