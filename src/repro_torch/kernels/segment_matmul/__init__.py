from repro_torch.kernels.segment_matmul.ops import (merge_path_partition,
                                                    segment_matmul,
                                                    segment_sum_csr,
                                                    sorted_layout)
from repro_torch.kernels.segment_matmul.ref import (segment_sum_csr_ref,
                                                    segment_sum_ref)
