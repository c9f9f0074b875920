from repro_torch.kernels.block_gather.ops import gather_rows
from repro_torch.kernels.block_gather.ref import block_gather_ref
