from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore, save)
