from repro_torch.kernels.plan_patch.ops import locate_lanes, merge_lanes
from repro_torch.kernels.plan_patch.ref import locate_lanes_ref, merge_lanes_ref
