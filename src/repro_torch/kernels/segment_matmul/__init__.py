from repro_torch.kernels.segment_matmul.ops import segment_matmul
from repro_torch.kernels.segment_matmul.ref import segment_sum_ref
