"""GastCoCo core in torch: CBList storage, sealed CSR runs and the tiered
store over both, batched updates, the engine's sweeps and the
vertex-program executor (the port's share of ``repro.core``'s public
API)."""
from repro_torch.core.blockstore import (NULL, PAD, BlockStore, alloc_blocks,
                                         compact, free_blocks,
                                         free_blocks_left, grow_store,
                                         gtchain_contiguity, gtchain_order,
                                         make_store, sort_blocks)
from repro_torch.core.cblist import (CBList, block_fences, build_from_coo,
                                     compact_cbl, degrees, empty, grow,
                                     rebuild, to_coo)
from repro_torch.core.updates import (DELETE, INSERT, NOP, UpdateStats,
                                      add_vertices, batch_update,
                                      batch_update_stats, delete_vertices,
                                      read_edges, upsert_edges)
from repro_torch.core.engine import (SEMIRINGS, Semiring, in_degrees,
                                     out_degrees, process_edge_pull,
                                     process_edge_push,
                                     process_edge_push_feat, process_vertex)
from repro_torch.core.program import (ProgramContext, Sweep, VertexProgram,
                                      get_program, has_program,
                                      register_program,
                                      registered_programs, run_program)
from repro_torch.core.traversal import (Partition, PlacementPlan,
                                        gtchain_partition, lane_mask,
                                        make_placement_plan,
                                        partition_balance, read_vertex,
                                        scan_edges, scan_vertices,
                                        scan_vertices_cond,
                                        vertex_table_partition)
from repro_torch.core.tuner import (ExecPlan, RoutePlan, SystemProbe,
                                    choose_engine_impl, choose_lookahead,
                                    choose_plan, choose_route_plan)
from repro_torch.core.csr import (CSRGraph, csr_build, csr_build_counted,
                                  csr_degrees, csr_empty, csr_in_degrees,
                                  csr_merge, csr_pagerank_sweep, csr_pull,
                                  csr_push, csr_push_feat, csr_query,
                                  csr_sample_neighbors, csr_to_coo)
from repro_torch.core.tiered import (TieredGraph, cold_mask, seal,
                                     tier_from_cbl, tiered_grow, unseal)
