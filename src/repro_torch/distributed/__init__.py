"""The GTChain-partitioned graph shards stacked on one device
(:mod:`repro_torch.distributed.graph`)."""
from repro_torch.distributed.graph import (ShardedCBList, compact_sharded,
                                           cut_fraction, grow_sharded,
                                           halo_masks, is_sharded,
                                           rebuild_sharded, shard_at,
                                           shard_cbl, shard_contiguity,
                                           sharded_add_vertices,
                                           sharded_batch_update_stats,
                                           sharded_delete_vertices,
                                           sharded_in_degrees,
                                           sharded_process_edge_pull,
                                           sharded_process_edge_push,
                                           sharded_process_edge_push_feat,
                                           sharded_read_edges,
                                           sharded_sample_neighbors,
                                           sharded_upsert_edges, unshard)
