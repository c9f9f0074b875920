from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, Stacked,
                                               latest_step, restore, save)
