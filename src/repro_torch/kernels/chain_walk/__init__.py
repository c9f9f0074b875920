from repro_torch.kernels.chain_walk.ops import locate, rank_walk
from repro_torch.kernels.chain_walk.ref import locate_ref, rank_walk_ref
