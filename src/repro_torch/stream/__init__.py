"""Update log, snapshots, maintenance and the GraphService facade (over a
CBList, or tiered storage with ``seal_after_epochs=K``)."""
from repro_torch.stream.log import (LogReceipt, PendingView, UpdateLog,
                                    append, drain, log_pending, make_log,
                                    peek)
from repro_torch.stream.maintenance import (MaintenanceAction,
                                            MaintenancePolicy, apply_action,
                                            chain_overlap_fraction, decide)
from repro_torch.stream.service import (FlushReport, GraphService,
                                        ServiceStats)
from repro_torch.stream.snapshot import (Snapshot, advance, query_degrees,
                                         query_edges, sample_khop,
                                         snapshot_of)
