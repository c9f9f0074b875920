from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                   embedding_bag_sorted)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                   embedding_bag_sorted_ref)
