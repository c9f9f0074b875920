"""Hand-written Hopper kernels of the port and their plain torch versions.

Each wrapper checks its inputs, runs the plain version for a CPU tensor and
launches its CUDA kernel (``repro_torch/csrc``) for a CUDA tensor.
"""
from repro_torch.kernels.block_gather import block_gather_ref, gather_rows
from repro_torch.kernels.segment_matmul import segment_matmul, segment_sum_ref
