#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA device.

    python3 chip_smoke.py [--seed N] [--scale F] [--profile]

Phases, one report line each:

1. set-up: the card's name and power limit, the kernels' build, an RMAT
   graph the size of SNAP's soc-LiveJournal1 (4,847,571 vertices,
   68,993,773 edges) made on the device from ``--seed``, and
   ``GraphService.from_coo`` over it;
2. agreement on a small input: one update/read/analytics sequence on the
   card and on the host, stores bit-exact and analytics equal;
3. kernels against their plain versions at the service graph's shapes,
   over the engine's sweep plan (push and pull F = 1, plus push_feat F = 16
   on a 1/16-size graph): ``block_gather`` exact (x[src] in the plan's
   destination order, x[owner], x[dst]), ``segment_sum`` over the plan's
   sorted streams within rtol 1e-5 of a float64 sum and bit-identical on a
   repeat, each timed beside its plain version, one PyTorch library call
   (``index_select``; ``torch.segment_reduce`` on the sorted stream) and
   its bytes bound; the push sweep through the plan within rtol 1e-5 of
   ``impl="torch"`` run in float64, timed beside the route that sorts on
   each call and ``impl="torch"`` (``index_add_``);
4. the service's main path with every launch counter at 0: cold PageRank,
   BFS, SSSP and CC, three rounds of 1,000,000 updates (20 % deletes) through
   ``apply`` + ``flush`` with point reads of just-inserted and just-deleted
   pairs after each, then the same analytics warm;
5. checks: ranks sum to 1, PageRank with ``impl="torch"`` agrees with the
   kernel path, both kernels launched on the main path and ``chain_walk``
   on its flushes and reads (flush s per 1 M updates and read pairs/s
   printed beside the host-loop walk's); a cold PageRank through each route, the kernel
   route building one sweep plan and launching each graph kernel once per
   iteration, and the plan's build time.  Then ``chain_walk`` against its
   plain version at the service graph's shapes: locate on 2^20 queries
   (half live pairs, half random, the longest chain's vertex among both)
   and the rank walk on 2^16 vertices x 15 draws, each bit-identical to the
   plain version and on a repeat, timed beside it, with its bound (the
   blocks the walks read over the memory rate, or the longest walk's
   dependent steps at WALK_STEP_NS each, whichever is larger); and
   ``read_edges`` under ``torch.cuda.set_sync_debug_mode("error")``;
5b. the serve phase: the same graph behind a serving ``GraphService``
   (log of 8,192 records) and ``ServeFrontend`` with the plan of
   ``choose_serve_plan(2000, ...)``.  Two tenants, ``fraud``
   (read-your-writes, interactive) and ``dashboard`` (standard), send
   20,000 requests on the host-made trace of ``serve_trace`` (Poisson at
   2,000 a second: 60/20/20 point reads, degree reads and update batches
   of 4-32 lanes, a 8-seed (15, 10) k-hop sample every 100 requests, a
   batch-class PageRank every 2,000), replayed open loop on the wall
   clock after an untimed warm replay of 1,000, with every launch counter
   at 0.  It prints QPS, p50 / p99 by kind and tenant, flushes, epoch
   advances, bucket shapes, launches, peak memory and one replica's
   closed-loop read lanes/s.  Checks: every ticket completes, none shed,
   versions never decrease per tenant and kind in submission order, the
   walk and graph kernels launched, and once, with a pending window,
   overlay point and degree reads equal to flush-then-read bit for bit;
5b2. the kept sweep plan on phase 4's service: three rounds of 10^5
   updates (half deletes), each a flush and a warm PageRank.  Every job
   patches the kept plan, each patch kernel launches at most once a patch,
   and the plan after the last is bit for bit a fresh build.  (Phase 4's
   first flush grows the vertex capacity, which drops the plan its cold
   PageRank kept, so its warm PageRank builds one.)
5c. the tier phase (sealed CSR runs under the CBList delta).  From
   ``tier_from_cbl`` of the service's final CBList, seal 0.5, 0.9 and 1.0
   of the edges (low-degree vertices first, ``benchmarks/bench_tier.py``'s
   rule; a seal moves the chains into the run, the delta's capacity kept)
   and print, beside the all-delta graph in the same call: the seal's
   wall time, the real sealed fraction, the run's lanes and the delta's
   blocks, the run's destination stream's build time, one push sweep
   through the kernels (the run tier's sweep launching each graph kernel
   once, checked), PageRank ms per iteration and iterations, 2^20 point
   reads (half live pairs).  Checks: the push within rtol 1e-5 of the
   float64 all-delta sum, PageRank within rtol 1e-4 and one sweep plan (the
   delta's), point reads bit for bit, every edge of a (15, 10) k-hop from
   4,096 sealed seeds live; at 1.0, unseal half the sealed vertices (time,
   reads again).  The run's push stream at 0.9 gives the graph kernels'
   tier rows.  Then, the untiered service freed, its tiered twin:
   ``GraphService.from_coo(..., seal_after_epochs=2)`` over the same graph
   with the counters at 0, a cold PageRank, the same three rounds of
   1,000,000 updates (flush s per 1 M, seals / unseals and the edges they
   moved, ``tier_version``, sealed fraction, delta blocks), flush reports (epoch, watermark, applied
   inserts and deletes) and point reads bit for bit the untiered service's,
   the warm PageRank within rtol 1e-4 of its, both graph kernels and the
   locate walk launched (the plan patch's kernels, which a seal into a
   non-empty run launches, counted);
5d. the shard phase, the tier phase's tensors released: the graph cell's
   graph behind ``GraphService.from_coo(..., n_shards=S)`` for S = 2 and 8
   (``benchmarks/bench_shard.py``'s sharded counts), every number beside
   the unsharded service's graph after its three rounds in the same call.
   With the launch counters at 0: the build (s, blocks a shard,
   ``cut_fraction``, ``partition_balance`` of the GTChain and vertex
   partitions, the shards' edge balance), the same three rounds (flush s
   per 1 M; the route plan's lane cap, rounds and skew, read from
   ``repro_torch.obs`` enabled around the flush alone), 2^20 point reads
   (half live pairs), a cold PageRank through the kernels, BFS and CC
   through the service, ``GraphService.plan("scan_all")`` and
   ``plan("batch_update")``.  Checks: flush reports (epoch, watermark,
   applied inserts and deletes) and the rounds' point reads bit for bit
   the unsharded service's, the 2^20 reads, in-degrees, BFS levels and CC
   labels bit for bit the unsharded graph's, PageRank within rtol 1e-5 of
   the same iterations in float64 over the unsharded graph, and
   ``segment_sum``, ``block_gather`` and ``chain_walk_locate`` launched on
   the shard path.  At S = 8 a spill batch: 65,536 updates keyed to the top
   hub (80 % inserts of destinations it does not reach, 20 % deletes of its
   live edges) through ``batch_update_stats``, its stats and the reads of
   its pairs bit for bit the unsharded graph's, in >= 2 routed rounds.  At
   S = 2 a tiered stack: 0.9 of the edges sealed (low degree first), one
   PageRank (both kernels launched on every shard's delta and run, within
   rtol 1e-4 of the unsharded ranks) and the 2^20 reads bit for bit.  The
   phase prints its peak memory;
5e. the shard axis across ranks, phase 5d's state freed: the same graph
   behind ``GraphService.from_coo(..., n_shards=S)`` for S = 2 and 8 on a
   process group, whose ``shard_mesh(S)`` places each rank's block of
   shards: (a) a one-rank NCCL group in this process (mesh axis 1: the
   production backend's calls), destroyed before phase 11 makes its own;
   (b) SHARD_MESH_RANKS ranks spawned on the one card over gloo with CUDA
   tensors (NCCL refuses two ranks on one device), one shard a rank at
   S = 2 and four at S = 8.  Each rank makes the graph again from
   ``--seed`` and, with its launch counters at 0, runs the three rounds of
   1 M updates with their point reads, the 2^20 reads, in-degrees, a cold
   and a warm PageRank through the kernels, BFS and CC.  Checks, against
   phase 5d's unsharded results kept on the host: flush reports, reads,
   in-degrees, BFS levels and CC labels bit for bit, PageRank within rtol
   1e-5 of the same iterations in float64, both ranks' outputs equal, and
   ``segment_sum``, ``block_gather`` and ``chain_walk_locate`` launched on
   every rank.  One ``[shard.mesh]`` line a rank and count: backend,
   world, S, mesh axis, ``REDUCE_MODE``, build s, flush s per 1 M, read ms,
   PageRank ms an iteration, the group's set-up s, the sum sweep's
   cross-rank combine ms and an all_reduce's ms with their bytes, peak
   memory -- the code path on one card, not a multi-card speed.  Every
   group has a 60 s timeout and the spawned leg a join limit; a rank that
   fails or outlives it fails the phase;
5f. ``ServeFrontend`` over the shard axis across ranks, phase 5e's state
   freed: the same graph behind ``GraphService.from_coo(...,
   n_shards=SERVE_MESH_S, log_capacity=SERVE_LOG_CAPACITY)`` and
   ``serve_frontend``'s plan and two tenants on every rank, on (a) a
   one-rank NCCL group in this process and (b) SHARD_MESH_RANKS gloo ranks
   spawned on the card, each submitted the same requests in the same
   order.  First the serve phase's warm trace on a virtual clock that
   rank r reads r * 0.5 ms ahead (a poll of the shadow flush waits for the
   device: on a virtual clock device work takes no time); every ticket is
   held to the one-process frontend's over the unsharded service on rank
   0's timeline: point reads, degrees, receipts, k-hop draws (each rank
   draws from a generator in the same state), versions and times bit for
   bit, PageRank within rtol 1e-5.  Then the serve phase's trace open loop
   at 2,000 a second on each rank's ``perf_counter``, the loop timed by
   the frontend's agreed clock, with the launch counters at 0: every
   ticket completes, none is shed, versions never go back per (tenant,
   kind), both ranks' values (as digests), versions and times are equal,
   one agreement a step and a submit, and ``chain_walk_locate``,
   ``chain_walk_rank``, ``segment_sum`` and ``block_gather`` launched on
   every rank.  One ``[serve.mesh]`` line a rank and leg: backend, world,
   S, mesh axis, requests, QPS, p50 / p99 by kind and tenant, flushes,
   epoch advances, agreements a step and a submit and their ms, launches,
   peak memory, beside the serve phase's QPS and p99 -- the code path on
   one card, not a multi-card speed;
5g. the sweep plan's patch at Graph500 scale 24, the graph state freed: a
   lanes stream sorted by (dst, src) of an R-MAT's 2^28 distinct edges over
   2^24 vertices, and a flush's 10^5 records (half deletes of live edges,
   half fresh R-MAT inserts).  ``plan_patch_locate`` and
   ``plan_patch_merge`` each bit-identical to their plain versions (run on
   the card) and to the stream sorted afresh, timed beside them, with the
   merge's bytes bound (16 B a lane) and both kernels' launches; then a
   CBList of that graph: the full build and the whole patch (records
   joined, coalesced, sorted, located, merged) at 10^5 to 3 x 10^7 records
   of one flush, host-synchronised ms, where the service's rule to drop
   its kept plan comes from;
6. LM serving, once the graph state is freed: Gemma-2 27B at full width
   (d_model 4608, 32 / 16 heads, d_ff 36864, vocab 256000), depth cut to 8
   layers, bf16 weights from ``--seed``.  With the attention launch counters
   at 0, ``launch.serve.serve`` takes 8 requests (prompts of 2,048-7,168
   random tokens, padded to the longest), prefills them through the bf16
   tensor-core flash kernel (8 launches, none of the float32 one) and
   decodes 64 greedy steps through the split paged kernel over a page pool
   of 128-token pages, twice: replayed from one CUDA graph (the card's
   default) and by the eager loop (``graph=False``); 8 x 64 paged launches
   and the same greedy tokens on both routes.  Then each kernel against its
   plain version at the serve shapes (flash on the first local and global
   layers' own inputs, batch row 0 and heads 0-3, within the bf16 bound
   below and bit-identical on a repeat; the split-TF32 float32 flash
   kernel on both layers' inputs in float32, within 1e-4 |ref| + 1e-5;
   paged on the serve's caches after prefill, every row, bit-identical on
   a repeat, with its split size), timed beside its plain version, torch's
   compiled ``flex_attention`` with the softcap and window (flash's library
   call, bf16 on both layers and float32 on the global one with
   ``allow_tf32`` held False and its output held to the float32 bound;
   SDPA, without the softcap, beside it) and its floors (bytes, products
   -- for float32 split TF32's three TF32 products each, the CUDA-core
   floor beside it -- and for flash the transcendentals at 16 a clock per
   SM); 4 teacher-forced decode steps through the graph route against the
   dense plain ``serve_step``; and the float32 kernels' own path, a
   float32 ``serve`` at the Gemma-2 smoke config against the same on the
   host.  The set-up lines ``setup.flash_sass`` and
   ``setup.flash_f32_sass`` say how many wgmma instructions (HGMMA) each
   tensor-core kernel's SASS holds (none fails the run), its registers and
   spills and its build seconds;
6b. MoE serving, once phase 6's state is freed (the allocated and reserved
   memory printed at its start): qwen3-moe-30b-a3b at full width and all
   48 layers (30.53 B parameters, bf16 weights from ``--seed`` made on the
   card; ``MOE_LAYERS``).  With the launch counters at 0,
   ``launch.serve.serve`` takes 8 requests (prompts of 1,024-3,072 random
   tokens, padded to the longest), prefills them (flash at 32 / 4 heads,
   no softcap; the MoE at C = 1,921 slots an expert) and decodes 64 greedy
   steps twice, through one CUDA graph and by the eager loop: the same
   tokens on both, and exactly 48 flash, 96 ``block_gather`` and 48
   ``segment_sum`` launches in prefill and 48 paged, 96 and 48 in each
   decode step (the prefill counted alone again).  One eager MoE decode
   step under ``torch.cuda.set_sync_debug_mode("error")``.  A teacher-
   forced check over 4 steps, layer by layer from the post-prefill state:
   on each layer's input the MoE block on the kernel route bit for bit
   ``impl="torch"``'s and paged attention within its phase-6 bound of the
   plain version; the logits against the dense plain ``serve_step``
   within LOGIT_REL_L2 on the rows whose routes (experts and kept slots,
   C = 1 at B = 8) agreed at every layer, how many (row, layer) routes
   changed and the share of lanes kept printed.  It prints prefill s, fill
   s, decode ms a step (median) on each route, capture s, pages used,
   tokens/s and peak memory.  Then flash (G = 8; SDPA its library call)
   and paged (G = 8) against their plain versions, and both graph kernels
   at the MoE's prefill (24,576 tokens) and decode (8 tokens) shapes, each
   timed beside its plain version, its library call and its bound;
7. recsys serving, once the LM state is freed: SASRec at its full published
   config (2^20-row item table, embed_dim 50, 2 blocks, 1 head, seq_len
   50), weights from ``--seed``, left-padded histories of 25-50 items made
   on the device.  With the launch counters at 0: ``serve_p99`` (20
   requests of 512 users, top-100 over the whole catalog),
   ``retrieval_cand`` (1 user, 10^6 candidates through ``score_candidates``)
   and ``serve_bulk`` (262,144 users in chunks of 4,096).  Checks: both
   kernels launched; the kernel route's ``user_repr`` bit-identical to the
   plain route's and its top-100 ids equal; ``score_candidates`` against
   ``serve_step`` at the same candidates; ``embedding_bag`` against its
   plain version on the bulk chunk's lookup (bit-exact), on 65,536 bags of
   32 weighted slots and on ragged bags of 1-64 slots (rtol 1e-5 of a
   float64 sum, bit-identical on a repeat), each row naming the kernel
   its shape is routed to (short bags for the one-slot lookup, a warp per
   bag for the others); ``block_gather`` exact at the
   retrieval shape.  Each timed beside its plain version, one library call
   and its bound;
8. GNN training, once SASRec's state is freed: GIN-TU at its full config
   (5 layers, d_hidden 64) on the ogb_products shape of
   ``configs/gnn_common.py`` (RMAT at ogbn-products' live counts, 2,449,029
   nodes and 61,859,140 edges asked, padded to 2,449,408 / 61,859,840 with
   the pads invalid; 100 random features, 47 random classes, all made on
   the device from ``--seed``), the batch's edge plan built once.  The
   kernel route's loss and gradients on the first batch against
   ``impl="torch"`` on the card (loss within rtol 1e-5, each gradient
   leaf's largest difference within 1e-4 of its largest value), 9 + 9
   graph-kernel launches a step.  Then, with the launch counters at 0,
   ``TrainSupervisor`` runs 20 steps of ``launch/train.py``'s step (clip 1,
   warmup-cosine, AdamW) with a checkpoint every 10 and one failure
   injected at step 13.  Checks: the loss falls, exactly 1 failure
   recovered and 2 checkpoints written, the state after the restart equal
   to the step-10 state bit for bit, no exception out of the step itself,
   9 launches of each graph kernel per step run.  It prints the live
   edges, the plan's build s, step ms (the first apart, median and max of
   the rest), the losses, the report, the checkpoint's bytes and write s
   and the peak memory.  Then both graph kernels at the aggregation's
   shapes (forward: x[src] in destination order summed by destination;
   backward: grad[dst] in source order summed by source; F = 100 and 64):
   ``block_gather`` bit for bit, ``segment_sum`` within rtol 1e-5 of a
   float64 sum and bit-identical on a repeat, each timed beside its plain
   version, ``index_select`` / ``torch.segment_reduce`` and its bytes
   bound.  Last, PNA and EGNN at their full configs on the minibatch_lg
   shape (170,368 / 168,960 live, 602 features, 41 classes): 5 steps
   each, the loss falling and both graph kernels launched;
9. Equiformer-v2 and SASRec training, once the GNN state is freed.
   Equiformer-v2 at the JAX registry's molecule cell
   (``full_config(d_in=64, n_classes=1, graph_level=True)``: 12 layers,
   d_hidden 128, l_max 6, m_max 2, 8 heads; ``GNN_SHAPES["molecule"]``:
   128 graphs of 30 atoms, 3,840 live nodes padded to 4,096, 8,192 edges,
   each graph's 32 closest atom pairs both ways, positions N(0, 1.5^2), 64
   random features, one target a graph, made on the device from
   ``--seed``): the kernel route against ``impl="torch"`` on the batch
   (loss rtol 1e-5, each gradient leaf within 1e-4 of its largest value),
   2 + 4L block_gather and 2L segment_sum launches a step; 20 supervised
   steps as GIN's at learning rate 2e-4 (a checkpoint every 10, a failure
   at 13; the restart
   bit for bit the step-10 state, the loss falling, the launches exact);
   the registry's ``opt`` variant (truncated rotation, bf16 edges) for
   20 plain steps; both graph kernels at K·C = 6272 (z[src], the messages into
   destination order and summed, the gradients into source order and
   summed).  Then SASRec at ``full_config()`` on ``train_batch`` (65,536
   users x 50, the 2^20-row table; 4 cached ``sasrec_batches`` made on the
   device, each with its lookup plan): the same route check and supervised
   run, 1 embedding_bag + 2 block_gather + 1 segment_sum launches a step,
   and the kernels at the lookup's shapes (the history's 3.28 M one-slot
   bags, the 6.55 M positive and negative rows, the 9.8 M lane gradients
   into id order and their sum into 2^20 rows), each against its plain
   version and timed beside it, its library call and its bound;
10. LM training, once phase 9's state is freed: qwen3-moe-30b-a3b at full
   width (d_model 2048, 32 / 4 heads of 128, 128 experts top-8, expert
   d_ff 768, vocab 151,936, bf16), its depth cut to 2 of 48 layers
   (1.87 B parameters; ``LM_TRAIN_LAYERS`` says why), the train_4k
   cell's batch cut to one 4,096-token sequence a step (4 cached
   ``token_stream`` batches made on the device), weights from ``--seed``.
   ``loss_fn`` runs attention through the plain version and the MoE's
   dispatch and combine on the graph kernels.  The kernel route against
   ``impl="torch"`` on the first batch (the loss within rtol 1e-5, each
   gradient leaf's largest difference within 2^-6 of its largest |value|;
   see ``LM_TRAIN_GRAD_RTOL``), 4L block_gather + 2L segment_sum launches
   a step; 20 supervised steps as GIN's (the step-10 state copied to the
   host for the restart's bit-for-bit check; the checkpoints in the JAX
   package's period-stacked tree, as ``launch/train.py`` writes an LM's):
   step ms, losses, checkpoint bytes and the run's write s, peak memory.
   Then both kernels at the
   MoE's shapes (the dispatch, the combine's gather and its sum by token
   at F = 2048, the combine's backward into the buckets), each against its
   plain version and timed beside it, its library call and its bound;
11. the mesh modules, once phase 10's state is freed (``[mesh.*]``
   lines).  (a) The dry run on the host: ``launch.dryrun`` under the fake
   process group of 512 ranks (set up and destroyed in this process) for
   ``DRYRUN_CELLS`` on both production meshes, one line a cell: argument
   bytes a device, GFLOP a step (on the meta device; the qwen3-moe
   ``train_4k`` ``opt`` cell's step runs on DTensors under the mesh, rank
   0's share), whether the argument bytes fit one H100's 80 GB (computed),
   each record's FLOPs and bytes above 0, the ``opt`` cell's collective
   bytes by kind each above 0 and every other cell's null.
   (b) Gradient compression on the card at the LM-train cell's widest
   gradient leaf, one layer's expert stack [128, 2048, 768] in float32
   (201,326,592 values; N(0, 1) from ``--seed``: phase 10 keeps no
   gradient): ``topk_compress`` at k_frac 0.01 with error feedback for 20
   rounds, what was sent plus the last residual equal to 20 g within the
   float32 bound of ``COMPRESS_ULPS``; the card's top-k bit for bit the
   host's on a 2^20-value slice with distinct magnitudes; ``int8_compress``
   over 32 draws, the mean's error within the Hoeffding bound of the
   draws and its RMS within the one-draw deviation over sqrt(32); each of
   the four calls timed beside its bytes bound.  (c) The mesh path on the
   card: a one-rank NCCL group, ``make_debug_mesh((1, 1))``, the plan of
   ``plan_elastic_restart(1, 256, model_parallel=1)`` and its mesh, and
   ``reshard_state`` of phase 10's last checkpoint (restored on the host
   from the JAX package's period-stacked tree) onto it, placed by
   ``shardings_for_cell`` of the qwen3-moe ``train_4k`` cell over the
   2-layer tree: every leaf a DTensor with the cell's placements, its
   ``full_tensor()`` bit for bit the restored leaf.  On one rank every
   placement is trivial: this drives the code path on the card, not a
   layout;
12. the expert-parallel MoE and the LM's ``opt`` steps on a DTensor mesh,
   once phase 11's state is freed (``[mesh.ep]`` lines): qwen3-moe-30b-a3b's
   ``opt`` config (``act_shard_axes``, ``ep_shard_map``) at full width and
   phase 10's 2 layers, bf16, weights from ``--seed``.  (a) One NCCL rank
   in this process, ``make_debug_mesh((1, 1))``, the state placed by the
   ``train_4k`` cell's shardings: on each layer's one-card MoE input
   ``apply_moe_ep`` bit for bit the one-card ``apply_moe``; the loss
   within rtol 1e-5 of the one-card loss less its 0.01 aux; every
   gradient leaf within LM_TRAIN_GRAD_RTOL of the one-card gradients;
   then, with the launch counters at 0, 3 steps of the registry's step
   (value and grads, clip, AdamW) on one 4,096-token sequence each:
   exactly 4L ``block_gather`` + 2L ``segment_sum`` a step, step ms
   beside phase 10's.  (b) EP_RANKS gloo ranks spawned on the one card
   (a (data 1, model 2) mesh, 64 experts a rank; a 60 s group timeout,
   an EP_JOIN_S join limit), the parent's one-card path first: with the
   counters at 0, the prefill of 8 prompts of 2,048 tokens (flash in
   ``local_map``, the MoE expert-parallel on the kernels) and 8
   dense-cache decode steps teacher-forced with the one-card greedy
   tokens, the cache's positions over ``"model"``; both ranks' logits
   equal, within EP_LOGIT_REL_L2_SANE of the one-card path's (a wrong
   path's check), the head on the one-card final hidden state within its
   rounding bound; exactly L flash, 2L ``block_gather`` and L
   ``segment_sum`` launches a rank.  Then, on the one-card layer inputs,
   each layer held to the one-card functions piece by piece: attention
   for the prefill and for each decode step (the projections within a
   float32 dot's two orders, the attention of the one card's q / k / v bit
   for bit at prefill and within a float32 bound at decode, the cache
   write bit for bit, the output projection within its bf16 partials'
   roundings, the layer's output within that plus its o's difference
   carried through |wo|); the MoE's routes and expert rows bit for bit,
   its output within the bound EP_PARTIAL_ULPS derives, which a bf16
   cross-rank partial must fail.  One line a
   leg and rank: backend, mesh, step ms or prefill s, decode ms a step,
   the combine's cross-rank ms and bytes, launches, peak memory.

The last two lines are the ``kernels`` JSON object and the device line.  It
exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/`` beside it.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LJ_VERTICES, LJ_EDGES = 4_847_571, 68_993_773      # SNAP soc-LiveJournal1
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM, 700 W
FP32_OPS_PER_S = 67e12                             # non-tensor float32 peak
BF16_TENSOR_OPS_PER_S = 989e12                     # dense bf16 tensor cores
TF32_TENSOR_OPS_PER_S = 495e12                     # dense TF32 tensor cores
# float32-accurate products on the tensor cores: split TF32 takes three
# TF32 products (hi.hi + hi.lo + lo.hi) for each float32 one
SPLIT_TF32_PASSES = 3
UPDATES_PER_ROUND, ROUNDS, DELETE_FRAC = 1_000_000, 3, 0.2
# the kept sweep plan's refreshes on the same service (kept_plan_phase)
KEPT_PLAN_ROUNDS, KEPT_PLAN_UPDATES = 3, 100_000
READ_PAIRS = 65_536
SEG_RTOL, SEG_ATOL = 1e-5, 1e-6
# LM serving: Gemma-2 27B at full width, depth cut to 8 layers
LM_LAYERS, LM_REQUESTS, LM_DECODE, LM_CHECK_STEPS = 8, 8, 64, 4
LM_PROMPT_MIN, LM_PROMPT_MAX = 2048, 7168
FLASH_CHECK_HEADS = 4
GRAPH_KERNELS = ("segment_sum", "block_gather")
# tier phase: sealed edge fractions (low-degree vertices first), the one
# whose run push stream gives the kernel rows, point reads, k-hop seeds and
# the tiered service's seal threshold (flushes a vertex stays unwritten)
TIER_FRACTIONS, TIER_KERNEL_FRACTION = (0.5, 0.9, 1.0), 0.9
TIER_READS, TIER_KHOP_SEEDS, TIER_K = 1 << 20, 4096, 2
# the FindNeighbor chain walk's two entry points (point reads and the
# flush's delete locate; the k-hop sampler's rank walk)
WALK_KERNELS = ("chain_walk_locate", "chain_walk_rank")
# shard phase: the sharded counts of benchmarks/bench_shard.py:SHARD_COUNTS;
# the spill batch (keyed to the top hub, the graph cell's 20 % deletes) at
# the larger count; the tiered step's shard count and sealed fraction
SHARD_COUNTS, SHARD_READS = (2, 8), 1 << 20
SHARD_SPILL_S, SHARD_SPILL_UPDATES, SHARD_SPILL_DELETE_FRAC = 8, 65_536, 0.2
SHARD_TIER_S, SHARD_TIER_FRACTION = 2, 0.9
SHARD_KERNELS = GRAPH_KERNELS + ("chain_walk_locate",)
# phase 5e: the shard axis across ranks.  Leg (a) a one-rank NCCL group in
# this process, leg (b) SHARD_MESH_RANKS ranks spawned on the one card over
# gloo (NCCL refuses two ranks on one device); each group's timeout, the
# spawned leg's time limit, the collective timing's calls
SHARD_MESH_COUNTS, SHARD_MESH_RANKS = (2, 8), 2
SHARD_MESH_GROUP_TIMEOUT_S, SHARD_MESH_JOIN_S = 60, 300
COLLECTIVE_REPS = 20
# serve phase: the trace of benchmarks/bench_serve.py and
# examples/dynamic_graph_pagerank.py at LiveJournal size
SERVE_REQUESTS, SERVE_WARM, SERVE_QPS = 20_000, 1_000, 2000.0
SERVE_KHOP_EVERY, SERVE_PAGERANK_EVERY = 100, 2_000
SERVE_KHOP_SEEDS, SERVE_FANOUT = 8, (15, 10)
SERVE_LOG_CAPACITY = 8192
SERVE_PROFILE_REQUESTS = 2_000
# phase 5f: ServeFrontend over the shard axis across ranks, phase 5e's
# graph behind GraphService(n_shards=SERVE_MESH_S); rank r's virtual clock
# reads r * SERVE_MESH_SKEW_S ahead of rank 0's; leg (b)'s wall-clock
# trace, cut because over gloo the two ranks serve 112-169 a second
# (NVIDIA H100 80GB HBM3, 700 W): the whole trace took them 179 s (the
# phase 230 s), 12,000 requests 94 s (the phase 139 s); 8,000 keep 4
# PageRanks and 80 k-hop draws; the kernels every rank must launch on it
SERVE_MESH_S, SERVE_MESH_SKEW_S = 2, 0.5e-3
SERVE_MESH_GLOO_REQUESTS = 8_000
SERVE_MESH_KERNELS = WALK_KERNELS + GRAPH_KERNELS
WALK_QUERIES = 1 << 20
# the least time of one dependent step of a chain walk: an L2 hit's round
# trip on an H100 (~ 260-300 SM cycles at 1.755-1.98 GHz); a DRAM miss
# takes ~ 2-3x that
WALK_STEP_NS = 150.0
# the flush and point reads while the walk was a host loop with one device
# sync a chain step (this script, NVIDIA H100 80GB HBM3, 700 W)
HOST_LOOP_FLUSH_S_PER_1M, HOST_LOOP_READ_PAIRS_PER_S = ("1.97-2.52",
                                                        "0.5e5-1.5e5")
# phase 5g: the sweep plan's patch at Graph500 scale 24 (2^24 vertices,
# 2^28 edges) under a flush of the refresh cells' 10^5 records
PLAN_PATCH_SCALE, PLAN_PATCH_EDGES, PLAN_PATCH_RECORDS = 24, 28, 100_000
PLAN_PATCH_KERNELS = ("plan_patch_locate", "plan_patch_merge")
# ... and the whole patch against a build over a store of that graph, at
# these counts of one flush's records (the service's drop rule)
PLAN_PATCH_SWEEP = (10**5, 10**6, 10**7, 3 * 10**7)
# the bf16 serve path; the float32 kernel is driven by a float32 serve at
# the smoke config
LM_KERNELS = ("flash_attention_wgmma", "paged_attention")
F32_LM_KERNELS = ("flash_attention", "paged_attention")
F32_LM_REQUESTS, F32_LM_DECODE = 4, 8
MUFU_PER_CLK_PER_SM, H100_SMS = 16, 132           # special-function unit
# the paged kernel against its plain version, bf16 outputs: both compute in
# float32 and round once, so they differ by at most one bf16 ulp (2^-7
# relative) plus a floor for outputs near 0
ATTN_RTOL, ATTN_ATOL = 2 ** -7, 1e-5
PAGED_GRAPH_CALLS = 10      # paged calls in the graph that times the kernel
# the bf16 flash kernel rounds P to bf16 before P·V (the tensor cores take
# bf16): each p moves by at most 2^-8 · p, so the output by at most
# 2^-8 · max_k |v[k, d]| beyond the one-ulp bound above
FLASH_BF16_RTOL, FLASH_BF16_VTOL = 2 ** -7, 2 ** -8
# the float32 flash kernel: float32 sums in another order
FLASH_F32_RTOL, FLASH_F32_ATOL = 1e-4, 1e-5
# paged decode vs the dense plain serve_step, bf16 model: sums taken in
# another order flip bf16 roundings, which grow through the 8 random layers;
# the paged route through the plain attention is itself 0.83-0.88 % off the
# dense decoder (relative L2 of a step's [B, vocab] logits; H100 runs of
# this script, seeds 0 and 1).  The kernel route must stay within 3 %; a
# wrong kernel is off by about 100 %
LOGIT_REL_L2 = 3e-2
# phase 6b: MoE serving, qwen3-moe-30b-a3b at full width and all 48
# layers (30.53 B parameters, 61.1 GB in bf16: one card holds them with
# the prefill's transients), 8 requests of 1,024-3,072 prompt tokens, 64
# greedy decode steps on each route, 4 teacher-forced steps checked layer
# by layer
MOE_LAYERS, MOE_REQUESTS, MOE_DECODE, MOE_CHECK_STEPS = 48, 8, 64, 4
MOE_PROMPT_MIN, MOE_PROMPT_MAX = 1024, 3072
MOE_KERNELS = ("flash_attention_wgmma", "paged_attention", "block_gather",
               "segment_sum")
# the kernels line's phase-6b entries: kernel -> the row's shape
MOE_SERVE_MAIN = {"flash_attention_wgmma": "moe prefill G=8",
                  "paged_attention": "moe decode G=8",
                  "block_gather": "moe decode dispatch F=2048 bf16",
                  "segment_sum": "moe decode combine F=2048"}


def moe_prefill_launches(n_layers: int) -> dict:
    """MoE prefill: per layer one flash call, the MoE's dispatch and
    combine gathers and its sum by token."""
    return {"flash_attention_wgmma": n_layers, "paged_attention": 0,
            "block_gather": 2 * n_layers, "segment_sum": n_layers}


def moe_step_launches(n_layers: int) -> dict:
    """An MoE decode step: per layer one paged call, the MoE's two gathers
    and its sum by token."""
    return {"flash_attention_wgmma": 0, "paged_attention": n_layers,
            "block_gather": 2 * n_layers, "segment_sum": n_layers}


# SASRec serving at its full published config, the three serve shapes of
# configs/sasrec.py
RECSYS_KERNELS = ("embedding_bag", "block_gather")
P99_REQUESTS, RETRIEVAL_REQUESTS, TOPK, BULK_CHUNK = 20, 5, 100, 4096
BAG_CHECK_BAGS, BAG_CHECK_SLOTS, BAG_RAGGED_MAX = 65_536, 32, 64
EMB_TIMED_CALLS = 100
# float32 scores from two product routes (GEMM, batched dot) over d = 50:
# relative, with a floor for scores near 0
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# GNN training: OGB's live counts inside GNN_SHAPES' capacities
# (configs/gnn_common.py): ogbn-products and the sampled-Reddit batch
OGB_PRODUCTS_LIVE = (2_449_029, 61_859_140)
MINIBATCH_LG_LIVE = (170_368, 168_960)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 20, 10, 13
SMALL_TRAIN_STEPS = 5
# a gin-tu step: forward 5 aggregations, backward 4 (layer 0's input, the
# features, takes no gradient), each one block_gather and one segment_sum
TRAIN_LAUNCHES_PER_STEP = 9
# a step of the minibatch_lg models, L = 4 layers.  PNA: forward per layer
# two node gathers and two means (a gather into destination order and a
# sum each); backward the two means' gathers at each lane's destination
# in every layer and the node gathers' sums by source from layer 1 on
# (layer 0's input takes no gradient): block_gather 4L + 2L + 2(L - 1),
# segment_sum 2L + 2(L - 1).  EGNN: forward per layer four node gathers
# (positions and features at both ends), the position mean and the
# message sum; backward the message sum's gather in every layer, the
# position mean's in all but the last (the last positions reach no
# output), and the four node gathers' sums by source from layer 1 on:
# block_gather 6L + L + (L - 1) + 4(L - 1), segment_sum 2L + 4(L - 1)
SMALL_LAUNCHES_PER_STEP = {
    "pna": {"segment_sum": 14, "block_gather": 30},
    "egnn": {"segment_sum": 20, "block_gather": 43},
}
# the kernel route (float64 sums rounded once) against impl="torch"
# (float32 sums in another order): the loss relative; each gradient leaf's
# largest difference against rtol of its largest |value|.  Element by
# element, gradients that cancel to near 0 differ by the summation order:
# up to 12.5 % of a leaf's elements lie outside rtol 1e-4 / atol 1e-6 at
# ogb_products size while every leaf's largest difference stays below
# 2e-5 of its largest value (this script, seeds 0 and 1, NVIDIA H100 80GB
# HBM3, 700 W)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-5, 1e-4, 1e-6
# EGNN's position-update gradients (phi_x: a sum over edges of tanh' of
# saturated weights times coordinate differences) are ill-conditioned in
# float32: at minibatch_lg the float32 plain route lies 2.2e-3 / 3.5e-2
# of a phi_x leaf's largest value from the float64 plain route, and the
# two float32 routes up to 3.0e-4 / 1.5e-2 from each other (this script,
# seeds 0 / 1, NVIDIA H100 80GB HBM3, 700 W).  There a leaf outside the
# tolerance of impl="torch" is held against float64 instead
# (route_agreement's float64_floor)
TRAIN_FLOAT64_FLOOR = ("egnn",)
TRAIN_CHECK_CHUNK = 1 << 24          # gathered rows compared at a time
TRAIN_MAIN_SHAPE = "train fwd F=100"   # the kernels line's train entry
# phase 9: Equiformer-v2 at the molecule cell (30 atoms a graph); SASRec's
# cached train_batch batches
MOLECULE_ATOMS, SASREC_TRAIN_CACHE = 30, 4
# Equiformer-v2's AdamW learning rate, the order of the published
# EquiformerV2 OC20 runs': at launch/train.py's 1e-3 the 12-layer model's
# loss on its one batch swung between 1.23 and 19.7 over the 20 steps and
# ended at 1.28 from 1.56 (this script at seed 1, NVIDIA H100 80GB HBM3,
# 700 W), so "the loss falls" rested on where a swing stopped.  The opt
# variant runs as many steps: over 5 (3 updates after warmup's zero step)
# its loss at seed 0 rose above the first
EQUIFORMER_LR = 2e-4
# a SASRec training step: forward embedding_bag (the history) and one
# block_gather (positives and negatives); backward one sum by item id of
# all three lookups' lanes: block_gather (into id order) and segment_sum
SASREC_LAUNCHES_PER_STEP = {"embedding_bag": 1, "block_gather": 2,
                            "segment_sum": 1}
# the kernels line's phase-9 entries: (model, kernel) -> the row's shape
MODEL_TRAIN_MAIN = {
    ("equiformer", "segment_sum"): "equiformer fwd F=6272",
    ("equiformer", "block_gather"): "equiformer node F=6272",
    ("sasrec", "segment_sum"): "sasrec bwd F=50",
    ("sasrec", "block_gather"): "sasrec fwd pos|neg F=50",
    ("sasrec", "embedding_bag"): "sasrec fwd lookup",
}

# phase 10: LM training, qwen3-moe-30b-a3b at full width with its depth cut
# to 2 of 48 layers, one train_4k sequence a step, 4 cached token_stream
# batches.  A checkpoint holds 10 B a parameter (bf16 weights, float32
# AdamW moments) and the supervised run writes two: at 4 layers (3.11 B
# parameters, 31.1 GB a checkpoint) the card's host stopped this phase
# when 47.2 GiB had been written to its disk, over the 45 GiB of writes
# it allows a run of this script (and a step had run out of memory with
# 27.5 GiB of the card reserved but unallocated); 3 layers write 2 x 24.9
# GB, still over.  2 layers write 2 x 18.7 GB (this phase, NVIDIA H100
# 80GB HBM3, 700 W)
LM_TRAIN_LAYERS, LM_TRAIN_SEQ, LM_TRAIN_CACHE = 2, 4096, 4
# the kernel route against impl="torch", bf16 model: both routes compute
# the same float32 routing and gated rows, sum them by token in float64
# (the segment_sum kernel's accumulator; index_add in float64) and round
# once, and sum a token's bucket gradients in float32 before one rounding
# (the plain route's dispatch reads a float32 copy of the tokens), so they
# differ at most by the order of float32 reductions (the gate's gradient,
# a dot product over d), which may flip a bf16 rounding of an input
# gradient (2^-8 to 2^-7 of it) and so the earlier layers' gradients: each
# leaf's largest difference must stay within 2^-6 of its largest |value|,
# the loss within 1e-5.  On the card the two agree bit for bit (this
# script's diagnosis at seed 0, NVIDIA H100 80GB HBM3, 700 W); a wrong
# kernel is off by the leaf's whole size
LM_TRAIN_LOSS_RTOL, LM_TRAIN_GRAD_RTOL = 1e-5, 2 ** -6
LM_TRAIN_MAIN = {"block_gather": "lm fwd dispatch F=2048 bf16",
                 "segment_sum": "lm fwd combine F=2048"}

# phase 11: the mesh modules.  The dry run of every live cell on both
# meshes takes longer than the 60 s this phase may give it on the host
# (PERF.md gives the full sweep's time), so it runs the cheap cell of each
# small family and the two MoE train cells
DRYRUN_CELLS = (("gin-tu", "molecule", False), ("sasrec", "serve_p99", False),
                ("qwen3-moe-30b-a3b", "train_4k", False),
                ("kimi-k2-1t-a32b", "train_4k", False),
                ("qwen3-moe-30b-a3b", "train_4k", True))
# the LM-train cell's widest gradient leaf: one layer's expert stack
COMPRESS_SHAPE, COMPRESS_K_FRAC, COMPRESS_ROUNDS = (128, 2048, 768), 0.01, 20
COMPRESS_CHECK_VALUES, INT8_DRAWS = 1 << 20, 32
# top-k with error feedback: sent + residual = R g exactly in real numbers.
# In float32 an element meets at most two roundings a round (g + residual,
# and the add into the sent sum), each at most 2^-24 of a value no larger
# than R |g|, and R g itself one more: within (2 R + 1) R 2^-24 |g|
COMPRESS_ULPS = (2 * COMPRESS_ROUNDS + 1) * COMPRESS_ROUNDS
# int8: a draw's error on one value lies in an interval one scale wide, so
# the mean of n draws exceeds t = scale sqrt(ln(2 N / delta) / (2 n)) with
# probability at most delta / N (Hoeffding), over all N values at most
# delta; and its RMS is at most scale / (2 sqrt(n)) (a stochastic
# rounding's variance is f (1 - f) <= 1/4 in scale units), held with a 2 %
# margin for the estimate over 2 x 10^8 values
INT8_DELTA, INT8_RMS_MARGIN = 1e-6, 1.02
ELASTIC_GLOBAL_BATCH = 256                 # the train_4k cell's sequences

# phase 12: the expert-parallel MoE on a DTensor mesh.  Leg (a) trains
# phase 10's cut model for 3 steps on one NCCL rank; leg (b) serves it on
# two gloo ranks sharing the card (NCCL refuses two ranks on one device),
# the model axis 2 (64 experts a rank), the data axis 1: across ranks on
# this card its FSDP gathers of the expert stacks would move ~2.4 GB of
# bf16 weights a forward through the host, and tier-1 holds it on 4 ranks
EP_TRAIN_STEPS, EP_RANKS, EP_JOIN_S = 3, 2, 240
EP_PREFILL, EP_DECODE_STEPS = (8, 2048), 8
MESH_EP_KERNELS = ("block_gather", "segment_sum", "flash_attention_wgmma")
# leg (b)'s MoE outputs against the one-card apply_moe on the same layer
# inputs.  Both route alike (D = 1: C_loc = C) and sum each token's lanes
# in float64; the one card rounds that sum S to float32 once (error <= u
# |S|, u = 2^-24), each rank rounds its experts' part S_r once and the
# cross-rank add of the two float32 partials rounds once more (<= 2 u
# (|S_1| + |S_2|)), so the float32 values differ by at most 3 u A, A the
# sum over the token's lanes of |gate * row|; rounding both to bf16 adds
# the two roundings (bf16_pair).  That holds for equal expert rows: a
# rank's rows come from its own batched GEMMs (64 experts against the one
# card's 128) and are held bit for bit to the one card's rows for the
# same experts (on an NVIDIA H100 80GB HBM3 with torch 2.11 + cu128, 0 of
# 335,806,464 values differ), so a library that rounds them otherwise
# fails the check instead of widening the bound.  A partial rounded to
# bf16 before the cross-rank sum must fail this bound (checked on the one
# card's rows), or the bound would not guard the float32 partial
EP_PARTIAL_ULPS = 3
# |bf16(x) - x| <= 2^-8 |x| <= BF16_HALF_ULP |bf16(x)| (round to nearest)
BF16_HALF_ULP = 2.0 ** -8 * (1 + 2.0 ** -7)
# leg (b)'s logits.  The head on the one-card final hidden state: the
# vocabulary-parallel head is a GEMM on column blocks of lm_head, each
# logit a float32 dot over d in another order (at most d u S, S the dot's
# sum of |x * w|, Higham's bound) rounded to bf16 (2^-8 of the larger).
# End to end, bf16 tensor parallelism rounds the row-parallel partials
# before their sum and capacity-bound routing (C = 1 at a decode step of
# 8 tokens) moves whole lanes on a rounding, so the end-to-end logits are
# held only against a wrong path, which is off by about 100 % (phase 6b)
EP_LOGIT_REL_L2_SANE = 0.5


def lm_train_launches(n_layers: int) -> dict:
    """A step of the MoE LM at ``n_layers`` layers: per layer, forward the
    dispatch (a gather into the buckets) and the combine (a gather in
    token-major lane order and a sum by token); backward the combine's
    gather into the buckets and the dispatch's gather and sum by token."""
    return {"block_gather": 4 * n_layers, "segment_sum": 2 * n_layers}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi_line(query: str = "name,power.limit",
             fmt: str = "csv,noheader") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of ``fn`` per call: CUDA events around ``reps`` calls
    after a warm-up."""

    def __init__(self, torch):
        self.torch = torch

    def sync(self):
        self.torch.cuda.synchronize()

    def ms(self, fn, reps: int = 5) -> float:
        fn()
        self.sync()
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def wall(self, fn):
        """(result, seconds) of one call, synchronised on both ends."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0


def profiled(torch, fn, top: int = 15):
    """(result, summary) of one call of ``fn`` under ``torch.profiler``:
    device time by op, the device's busy share of the wall time, and the
    call counts of the ops that mark host-loop steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if "CUDA" in str(getattr(e, "device_type", ""))]
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in (kernels or events) if e.self_device_time_total > 0]
    dev.sort(key=lambda r: -r[2])
    busy_us = sum(r[2] for r in dev)
    calls = {e.key: e.count for e in events
             if e.key in ("aten::searchsorted", "aten::nonzero", "aten::sort",
                          "aten::item", "aten::_local_scalar_dense")}
    return out, dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                     device_busy_share=busy_us / 1e6 / wall,
                     host_calls=calls,
                     top=[dict(op=k, count=c, device_ms=t / 1e3)
                          for k, c, t in dev[:top]])


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
             ) -> tuple:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                          else "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def sweep_inputs(torch, cbl, x):
    """The engine's kernel inputs for one push, pull and (2-D x) push_feat
    sweep over ``cbl``: ((gather table, ids), (segment data, seg))."""
    from repro_torch.core.traversal import lane_mask
    st = cbl.store
    nv = cbl.capacity_vertices
    mask = lane_mask(st)
    owner = st.owner.clamp(min=0).contiguous()
    table = x.reshape(nv, -1).contiguous()
    xs = table[owner.long()]
    if table.shape[1] == 1:
        msg = torch.where(mask, xs * st.vals, 0.0).reshape(-1, 1)
    else:
        msg = (xs[:, None, :] * torch.where(mask, st.vals, 0.0)[:, :, None]
               ).reshape(-1, table.shape[1])
    seg = torch.where(mask, st.keys, nv).reshape(-1).contiguous()
    return (table, owner), (msg.contiguous(), seg)


def time_segment_sum(torch, timer, name, data_sorted, row_ptr, parts,
                     data, seg):
    """The CSR kernel over a plan's sorted stream (``data_sorted``,
    ``row_ptr``, ``parts``) against a float64 sum, bit-identical on a
    repeat, timed beside its plain version, ``torch.segment_reduce`` on the
    same stream and its bytes bound; the one-off wrapper over the unsorted
    stream (``data``, ``seg``: sort, gather, kernel) and ``index_add_`` on
    it beside them."""
    from repro_torch.kernels.segment_matmul.ops import (segment_matmul,
                                                        segment_sum_csr)
    from repro_torch.kernels.segment_matmul.ref import (segment_sum_csr_ref,
                                                        segment_sum_ref)
    num_rows = row_ptr.numel() - 1
    got = segment_sum_csr(data_sorted, row_ptr, parts)
    again = segment_sum_csr(data_sorted, row_ptr, parts)
    ref64 = segment_sum_csr_ref(data_sorted.double(), row_ptr)
    err = (got.double() - ref64).abs()
    ok = bool((err <= SEG_ATOL + SEG_RTOL * ref64.abs()).all())
    check(ok, f"segment_sum {name}: outside rtol {SEG_RTOL} of the "
              f"float64 sum (max abs err {float(err.max()):.3e})")
    check(torch.equal(got, again), f"segment_sum {name}: repeat differs")
    oneoff = segment_matmul(data, seg, num_rows)
    oneoff_err = (oneoff.double() - segment_sum_ref(data.double(), seg,
                                                    num_rows)).abs()
    check(bool((oneoff_err <= SEG_ATOL + SEG_RTOL * ref64.abs()).all()),
          f"segment_matmul {name}: the one-off route is outside rtol "
          f"{SEG_RTOL} of the float64 sum")
    del ref64, oneoff, oneoff_err
    valid = (seg >= 0) & (seg < num_rows)
    idx, vals = seg[valid].long(), data[valid]
    offsets = row_ptr.long()
    V, F = data_sorted.shape
    # the sorted stream read once, row_ptr read once, the output written
    # once; one add an item and feature
    b_ms, b_by = bound_ms(V * F * 4 + (num_rows + 1) * 4 + num_rows * F * 4,
                          V * F)
    row = dict(
        name="segment_sum", shape=name, V=V, F=F, rows=num_rows,
        tiles=parts.shape[0] - 1, E_unsorted=data.shape[0],
        max_abs_err=float(err.max()), bit_identical_repeat=True,
        ms=timer.ms(lambda: segment_sum_csr(data_sorted, row_ptr, parts)),
        plain_ms=timer.ms(lambda: segment_sum_csr_ref(data_sorted, row_ptr)),
        library_ms=timer.ms(lambda: torch.segment_reduce(
            data_sorted, "sum", offsets=offsets)),
        oneoff_ms=timer.ms(lambda: segment_matmul(data, seg, num_rows), 3),
        index_add_ms=timer.ms(lambda: torch.zeros(
            (num_rows, F), device=data.device).index_add_(0, idx, vals)),
        bound_ms=b_ms, bound_by=b_by)
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in row.items()})
    return row


def time_push_sweep(torch, timer, cbl, plan, x):
    """PageRank's push sweep (message x[src]) through the plan, through the
    kernel route that sorts on each call, and through ``impl="torch"``
    (``index_add_`` on the unsorted stream)."""
    from repro_torch.core.engine import process_edge_push
    msg = lambda xs, w: xs      # noqa: E731 — PageRank's message
    planned = lambda: process_edge_push(cbl, x, dense_f=msg,  # noqa: E731
                                        impl="cuda", plan=plan)
    got = planned()
    # the reference route in float64: in float32, index_add_'s atomics over
    # a hub's ~1.7e5 in-edges drift by about SEG_RTOL of the sum from run to
    # run; the kernel sums in float64 and rounds once
    ref = process_edge_push(cbl, x.double(), dense_f=msg, impl="torch")
    err = float((got.double() - ref).abs().max())
    check(torch.allclose(got.double(), ref, rtol=SEG_RTOL, atol=SEG_ATOL),
          f"push sweep through the plan off impl='torch' (float64) by "
          f"{err:.3e}")
    del ref
    row = dict(
        name="push_sweep", max_abs_err=err,
        plan_ms=timer.ms(planned),
        sort_each_call_ms=timer.ms(lambda: process_edge_push(
            cbl, x, dense_f=msg, impl="cuda"), 3),
        torch_index_add_ms=timer.ms(lambda: process_edge_push(
            cbl, x, dense_f=msg, impl="torch")))
    say("sweep", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                    for k, v in row.items()})
    return row


def time_gather(torch, timer, name, table, ids, rows_per_step=1):
    from repro_torch.kernels.block_gather.ops import gather_rows
    from repro_torch.kernels.block_gather.ref import block_gather_ref
    got = gather_rows(table, ids, rows_per_step=rows_per_step)
    ref = block_gather_ref(table, ids, rows_per_step)
    check(torch.equal(got, ref), f"block_gather {name}: differs from plain")
    ids64 = ids.long()
    # only the table rows the (clamped) ids name are read, each once
    rows_read = int(torch.unique(ids.clamp(0, table.shape[0] // rows_per_step
                                           - 1)).numel()) * rows_per_step
    nbytes = rows_read * table.shape[1] * 4 + ids.numel() * 4 \
        + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 0)
    row = dict(
        name="block_gather", shape=name, N=ids.numel(), F=table.shape[1],
        rows_read=rows_read,
        max_abs_err=float((got - ref).abs().max()),
        ms=timer.ms(lambda: gather_rows(table, ids,
                                        rows_per_step=rows_per_step)),
        plain_ms=timer.ms(lambda: block_gather_ref(table, ids,
                                                   rows_per_step)),
        library_ms=timer.ms(lambda: table.index_select(0, ids64)),
        bound_ms=b_ms, bound_by=b_by)
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in row.items()})
    return row


def kernel_phase(torch, timer, dev, cbl, small_cbl, seed, report):
    from repro_torch.core.engine import sweep_plan
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    nv = cbl.capacity_vertices
    x = torch.rand(nv, generator=gen, device=dev)
    (table, owner), (msg, seg) = sweep_inputs(torch, cbl, x)
    st = cbl.store
    plan = sweep_plan(cbl)
    rows = [time_gather(torch, timer, "push x[src] (plan)", table, plan.src),
            time_gather(torch, timer, "push x[owner]", table, owner)]
    dst_ids = st.keys.clamp(0, nv - 1).reshape(-1).contiguous()
    rows.append(time_gather(torch, timer, "pull x[dst]", table, dst_ids))
    del dst_ids
    # the default message x[src] * w, in the plan's order and unsorted
    sorted_msg = (x[plan.src.long()] * plan.w)[:, None].contiguous()
    rows.append(time_segment_sum(torch, timer, "push", sorted_msg,
                                 plan.row_ptr, plan.partition("lanes", 1),
                                 msg, seg))
    del sorted_msg
    per_blk = msg.reshape(st.num_blocks, -1).sum(1, keepdim=True).contiguous()
    owner_seg = torch.where(st.owner == -1, nv, st.owner).contiguous()
    rows.append(time_segment_sum(torch, timer, "pull",
                                 per_blk[plan.blocks.long()].contiguous(),
                                 plan.block_row_ptr,
                                 plan.partition("blocks", 1), per_blk,
                                 owner_seg))
    del msg, seg, per_blk
    report["push_sweep"] = time_push_sweep(torch, timer, cbl, plan, x)
    del plan
    snv = small_cbl.capacity_vertices
    xf = torch.rand((snv, 16), generator=gen, device=dev)
    (ftable, fowner), (fmsg, fseg) = sweep_inputs(torch, small_cbl, xf)
    fplan = sweep_plan(small_cbl, pull=False)
    rows.append(time_gather(torch, timer, "push_feat x[src] (plan) F=16",
                            ftable, fplan.src))
    fsorted = (xf[fplan.src.long()] * fplan.w[:, None]).contiguous()
    rows.append(time_segment_sum(torch, timer, "push_feat F=16", fsorted,
                                 fplan.row_ptr, fplan.partition("lanes", 16),
                                 fmsg, fseg))
    return rows


# ---------------------------------------------------------------------------
# agreement with the host on a small input
# ---------------------------------------------------------------------------

def agreement_phase(torch, dev, seed):
    """The same service sequence on ``dev`` and on the host, compared."""
    from repro_torch import interop
    from repro_torch.data.synthetic import rmat_edges, update_stream
    from repro_torch.stream.service import GraphService
    nv, ne = 3000, 30000
    src, dst = rmat_edges(nv, ne, seed=seed, device="cpu")
    w = torch.rand(ne, generator=torch.Generator().manual_seed(seed)) + 0.1
    svcs = [GraphService.from_coo(src, dst, w, num_vertices=nv, block_width=8,
                                  log_capacity=8192, device=d)
            for d in (dev, "cpu")]
    outs = [[], []]
    for s, d, uw, op in update_stream(nv, (src, dst), 4000, 2, seed=seed,
                                      device="cpu"):
        for k, svc in enumerate(svcs):
            svc.apply(s, d, uw, op)
            rep = svc.flush()
            outs[k].append((rep, interop.cbl_to_numpy(svc.snapshot.cbl),
                            svc.analytics("pagerank"),
                            svc.analytics("bfs", source=0),
                            svc.analytics("sssp", source=0),
                            svc.analytics("cc"),
                            svc.query_edges(s, d)))
    import numpy as np
    for got, ref in zip(*outs):
        check(got[0] == ref[0], "small input: flush reports differ")
        for k in ref[1]:
            a, b = got[1][k], ref[1][k]
            same = all(np.array_equal(a[f], b[f]) for f in b) \
                if isinstance(b, dict) else np.array_equal(a, b)
            check(same, f"small input: store array {k} differs")
        pr_d, pr_h = interop.to_numpy(got[2]), interop.to_numpy(ref[2])
        check(np.allclose(pr_d, pr_h, rtol=1e-5, atol=1e-8),
              "small input: PageRank differs")
        for i, name in ((3, "bfs"), (4, "sssp"), (5, "cc")):
            check(np.array_equal(interop.to_numpy(got[i]),
                                 interop.to_numpy(ref[i])),
                  f"small input: {name} differs")
        for a, b in zip(got[6], ref[6]):
            check(np.array_equal(interop.to_numpy(a), interop.to_numpy(b)),
                  "small input: point reads differ")
    say("agreement", vertices=nv, edges=ne, rounds=len(outs[0]),
        stores="bit-exact", pagerank="rtol 1e-5", bfs_sssp_cc="exact")


# ---------------------------------------------------------------------------
# the service's main path
# ---------------------------------------------------------------------------

def read_pairs(s, d, w, op):
    """The point reads after a round: up to READ_PAIRS just-inserted pairs
    (with their weights) and just-deleted pairs."""
    ins = op == 1
    return (s[ins][:READ_PAIRS], d[ins][:READ_PAIRS], w[ins][:READ_PAIRS],
            s[~ins][:READ_PAIRS], d[~ins][:READ_PAIRS])


def service_phase(torch, timer, dev, svc, coo, seed, report, profile=False):
    """The service's main path; returns the cold and warm ranks and, per
    round, the flush report and point-read results (the tiered twin's
    reference)."""
    from repro_torch import backend
    from repro_torch.data.synthetic import update_stream
    out, record = {}, []
    backend.reset_launch_counts()
    (ranks, pr_s) = timer.wall(lambda: svc.analytics("pagerank"))
    out["pagerank_cold"] = dict(seconds=pr_s, iterations=svc.last_iterations)
    for name, kw in (("bfs", {"source": 0}), ("sssp", {"source": 0}),
                     ("cc", {})):
        _, sec = timer.wall(lambda: svc.analytics(name, **kw))
        out[f"{name}_cold"] = dict(seconds=sec,
                                   iterations=svc.last_iterations)
    say("service.cold", **{k: f"{v['seconds']:.3f}s/{v['iterations']}it"
                           for k, v in out.items()})
    rounds = []
    stream = update_stream(svc.snapshot.cbl.capacity_vertices, coo,
                           UPDATES_PER_ROUND, ROUNDS,
                           delete_frac=DELETE_FRAC, seed=seed + 1, device=dev)
    for r, (s, d, w, op) in enumerate(stream):
        timer.sync()
        receipt, apply_s = timer.wall(lambda: svc.apply(s, d, w, op))
        check(bool(receipt.admitted), f"round {r}: batch not admitted")
        if profile and r == ROUNDS - 1:
            rep, prof = profiled(torch, svc.flush)
            flush_s = prof["wall_s"]         # the trace's processing left out
            report["profile_flush"] = prof
        else:
            rep, flush_s = timer.wall(svc.flush)
        qs_i, qd_i, w_i, qs_d, qd_d = read_pairs(s, d, w, op)
        (found_i, got_w), read_i_s = timer.wall(
            lambda: svc.query_edges(qs_i, qd_i))
        (found_d, w_d), read_d_s = timer.wall(
            lambda: svc.query_edges(qs_d, qd_d))
        record.append((rep, found_i, got_w, found_d, w_d))
        check(bool(found_i.all()), f"round {r}: an inserted pair is missing")
        check(torch.equal(got_w, w_i), f"round {r}: inserted weights differ")
        check(not bool(found_d.any()), f"round {r}: a deleted pair is found")
        row = dict(round=r, updates=int(s.numel()), apply_s=apply_s,
                   flush_s=flush_s,
                   updates_per_s=int(s.numel()) / (apply_s + flush_s),
                   applied_inserts=rep.applied_inserts,
                   applied_deletes=rep.applied_deletes,
                   grow_retries=rep.grow_retries,
                   maintenance=rep.maintenance.kind,
                   read_pairs=qs_i.numel() + qs_d.numel(),
                   read_pairs_per_s=(qs_i.numel() + qs_d.numel())
                   / (read_i_s + read_d_s))
        rounds.append(row)
        say("service.flush", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                for k, v in row.items()})
    out["rounds"] = rounds
    # the shard phase's reference: the graph after the rounds (updates are
    # pure, so later flushes leave these tensors as they are) and the
    # analytics over it
    shard_ref = dict(cbl=svc.snapshot.cbl)
    warm = {}
    if profile:
        ranks_warm, prof = profiled(torch, lambda: svc.analytics("pagerank"))
        sec = prof["wall_s"]
        report["profile_pagerank_warm"] = prof
    else:
        (ranks_warm, sec) = timer.wall(lambda: svc.analytics("pagerank"))
    warm["pagerank_warm"] = dict(seconds=sec, iterations=svc.last_iterations)
    for name, kw in (("bfs", {"source": 0}), ("sssp", {"source": 0}),
                     ("cc", {})):
        res, sec = timer.wall(lambda: svc.analytics(name, **kw))
        warm[f"{name}_warm"] = dict(seconds=sec,
                                    iterations=svc.last_iterations)
        shard_ref[name] = res
        if name == "bfs":
            check(int(res[0]) == 0 and bool((res >= -1).all()),
                  "bfs levels malformed")
        if name == "sssp":
            check(float(res[0]) == 0.0 and not bool(torch.isnan(res).any()),
                  "sssp distances malformed")
    out.update(warm)
    say("service.warm", **{k: f"{v['seconds']:.3f}s/{v['iterations']}it"
                           for k, v in warm.items()})
    out["launches"] = {k: backend.LAUNCHES[k] for k in GRAPH_KERNELS}
    out["walk_launches"] = {k: backend.LAUNCHES[k] for k in WALK_KERNELS}
    out["plan_builds"] = backend.PLAN_BUILDS
    out["plan_patches"] = backend.PLAN_PATCHES
    out["patch_launches"] = {k: backend.LAUNCHES[k]
                             for k in PLAN_PATCH_KERNELS}
    report["service"] = out
    return ranks, ranks_warm, record, shard_ref


# ---------------------------------------------------------------------------
# LM serving: Gemma-2 27B at full width over the paged KV cache
# ---------------------------------------------------------------------------

def live_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs of one head of S rows, within ``window``."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def mufu_per_s(smi_clock_mhz: float) -> float:
    """Special-function results per second: 16 a clock per SM."""
    return MUFU_PER_CLK_PER_SM * H100_SMS * smi_clock_mhz * 1e6


def time_flex(torch, timer, q, k, v, window, softcap, got, check_ref=None):
    """(ms, note) of torch's ``flex_attention``, compiled, with the tanh
    softcap as its ``score_mod`` and the causal (and sliding-window) mask as
    its block mask: the one PyTorch call that computes the flash kernel's
    own function.  (None, why) where it does not import or run, or where
    ``check_ref`` (ref, tol over the checked rows) is given and its output
    misses it."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
    except ImportError as e:
        return None, f"flex_attention does not import: {e}"

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        return keep & (qi - ki < window) if window > 0 else keep

    S, D = q.shape[2], q.shape[3]
    try:
        mask = create_block_mask(mask_mod, None, None, S, S,
                                 device=q.device)
        flex = torch.compile(flex_attention, dynamic=False)
        call = functools.partial(flex, q, k, v, score_mod=score_mod,
                                 block_mask=mask, scale=D ** -0.5,
                                 enable_gqa=True)
        out = call()
        ms = timer.ms(call)
    except Exception as e:      # the library's failure is recorded, not ours
        return None, f"flex_attention did not run: {type(e).__name__}: " \
            f"{str(e)[:200]}"
    diff = float((out.float() - got.float()).abs().max())
    if check_ref is not None:
        ref, tol = check_ref
        rows = out[:ref.shape[0], :ref.shape[1]].float()
        worst = float(((rows - ref).abs() / tol).max())
        if not worst <= 1.0:
            return None, f"flex_attention (compiled) off the plain version: " \
                f"worst err/bound {worst:.3g}; not timed"
        return ms, f"flex_attention (compiled), allow_tf32=False, worst " \
            f"err/bound against the plain version {worst:.3g}, max |flex - " \
            f"kernel| {diff:.3g}"
    return ms, f"flex_attention (compiled), max |flex - kernel| {diff:.3g}"


def time_flash(torch, timer, name, q, k, v, window, softcap, library,
               clock_mhz):
    """A flash kernel at a prefill layer's shape against its plain version
    (batch row 0, the first FLASH_CHECK_HEADS heads rounded up to whole kv
    groups, every row; bit-identical on a repeat), timed beside the plain
    version over the whole shape, the floors and, with ``library``, one
    PyTorch call of the same function: torch's compiled ``flex_attention``
    with a softcap (for float32 with ``allow_tf32`` held False and its
    output held to the float32 bound), SDPA without softcap or window.
    Without a window SDPA (no softcap) is timed beside it.  bf16 goes
    through the bf16 tensor-core kernel, float32 through the split-TF32
    one."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, H, S, D = q.shape
    G = H // k.shape[1]
    hs = G * -(-FLASH_CHECK_HEADS // G)
    bf16 = q.dtype == torch.bfloat16
    kw = dict(scale=D ** -0.5, causal=True, window=window, softcap=softcap)
    got = flash_attention(q, k, v, **kw)
    check(torch.equal(got, flash_attention(q, k, v, **kw)),
          f"flash_attention {name}: a repeat differs")
    ref = attention_ref(q[:1, :hs], k[:1, :hs // G], v[:1, :hs // G],
                        **kw).float()
    err = (got[:1, :hs].float() - ref).abs()
    if bf16:     # P rounded to bf16 before P·V: 2^-8 · max_k |v[k, d]| more
        vmax = v[:1, :hs // G].float().abs().amax(dim=2, keepdim=True) \
            .repeat_interleave(G, dim=1)
        tol = FLASH_BF16_RTOL * ref.abs() + FLASH_BF16_VTOL * vmax \
            + ATTN_ATOL
    else:
        tol = FLASH_F32_ATOL + FLASH_F32_RTOL * ref.abs()
    check(bool((err <= tol).all()),
          f"flash_attention {name}: off its plain version by "
          f"{float(err.max()):.3e} (worst err/bound "
          f"{float((err / tol).max()):.3f})")

    def plain():                     # the plain version over the whole shape
        for b in range(B):
            for h in range(0, H, hs):
                attention_ref(q[b:b + 1, h:h + hs], k[b:b + 1, h // G:
                                                     (h + hs) // G],
                              v[b:b + 1, h // G:(h + hs) // G], **kw)

    pairs = B * H * live_pairs(S, window)
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) \
        * q.element_size()
    ops = 4 * pairs * D
    # floors: the bytes; the products at the type's peak (bf16 tensor cores;
    # for float32 the least time of float32-accurate products, split TF32's
    # three TF32 products each, with the CUDA-core floor kept beside it);
    # the transcendentals the function needs, an exp a live pair and a tanh
    # with the softcap, at 16 a clock per SM
    mufu = pairs * (2 if softcap > 0 else 1)
    floors = dict(bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                  products=(ops / BF16_TENSOR_OPS_PER_S if bf16 else
                            SPLIT_TF32_PASSES * ops / TF32_TENSOR_OPS_PER_S)
                  * 1e3,
                  transcendentals=mufu / mufu_per_s(clock_mhz) * 1e3)
    binding = max(floors, key=floors.get)
    if not bf16:
        floors["cuda_core_products"] = ops / FP32_OPS_PER_S * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_call():
        return sdpa(q, k, v, is_causal=True, scale=D ** -0.5,
                    enable_gqa=True)

    check_ref = None if bf16 else (ref, tol)
    if library and not bf16:
        check(not torch.backends.cuda.matmul.allow_tf32,
              "float32 flex_attention timed with allow_tf32 on")
    if library and softcap == 0 and window == 0 and bf16:
        flex_ms = timer.ms(sdpa_call)  # SDPA computes this very function
        diff = float((sdpa_call().float() - got.float()).abs().max())
        flex_note = f"SDPA (is_causal, enable_gqa), max |sdpa - kernel| " \
            f"{diff:.3g}"
    elif library:
        flex_ms, flex_note = time_flex(torch, timer, q, k, v, window,
                                       softcap, got, check_ref)
    else:
        flex_ms, flex_note = None, "no library call timed"
    row = dict(
        name="flash_attention_wgmma" if bf16 else "flash_attention",
        shape=name, dtype=str(q.dtype).replace("torch.", ""), B=B, H=H,
        KVH=k.shape[1], S=S, D=D, window=window, softcap=softcap,
        live_pairs=pairs, mufu_ops=mufu, max_abs_err=float(err.max()),
        max_err_over_bound=float((err / tol).max()),
        ms=timer.ms(lambda: flash_attention(q, k, v, **kw)),
        plain_ms=timer.ms(plain),
        library_ms=flex_ms, library_note=flex_note,
        allow_tf32=(None if bf16 else
                    torch.backends.cuda.matmul.allow_tf32),
        # SDPA computes the same causal GQA attention without the softcap;
        # bf16 only (in float32 it falls back to a 37 GB score matrix)
        sdpa_ms=(timer.ms(sdpa_call) if library and window == 0 and bf16
                 else None),
        bound_ms=floors[binding],
        bound_by="bytes" if binding == "bytes" else "operations",
        binding_floor=binding, **{f"{k_}_floor_ms": v_
                                  for k_, v_ in floors.items()})
    say("lm.kernel", **{k_: (f"{v_:.4g}" if isinstance(v_, float) else v_)
                        for k_, v_ in row.items()})
    return row


def flash_build_report(torch, backend, source="flash_attention_wgmma",
                       kernel="flash_fwd_wgmma", templates=3,
                       line="setup.flash_sass",
                       consumer_regs="240 (setmaxnreg)") -> dict:
    """What was built for a tensor-core flash kernel: how many wgmma
    instructions (HGMMA) its SASS holds, registers and local memory
    (spills) per template from ``cuobjdump -res-usage``, and the seconds
    its build took.  Fails the run without HGMMA."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = str(backend.library_path(source))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    usage = [dict(template=m.group(1), regs=int(m.group(2)),
                  stack=int(m.group(3)), local=int(m.group(4)))
             for m in re.finditer(kernel + r"ILi(\d+)E\S*:\s*"
                                  r"REG:(\d+) STACK:(\d+) \S+ LOCAL:(\d+)",
                                  res)]
    hgmma = re.findall(r"HGMMA\.\S+", sass)
    out = dict(hgmma=len(hgmma), hgmma_kinds=sorted(set(hgmma)),
               templates=usage,
               build_seconds=backend.last_build_seconds_by_source.get(
                   source))
    say(line, hgmma=out["hgmma"], kinds=",".join(out["hgmma_kinds"]),
        regs="/".join(f"D{u['template']}:{u['regs']}" for u in usage),
        spill_bytes=sum(u["stack"] + u["local"] for u in usage),
        consumer_regs=consumer_regs,
        build_s=("cached" if out["build_seconds"] is None
                 else f"{out['build_seconds']:.2f}"))
    check(out["hgmma"] > 0, f"{source}: no HGMMA in its SASS")
    check(len(usage) == templates, f"{source}: res-usage unparsed: "
          f"{res[-500:]}")
    return out


def time_paged(torch, timer, name, cache, q, window, softcap):
    """The split paged kernel over a serve cache (every row) against its
    plain version (within ATTN_RTOL / ATTN_ATOL, bit-identical on a repeat),
    timed beside it and the bound, with the split size the wrapper picks.
    ``ms`` is the kernel replayed from a CUDA graph, as the decode step runs
    it; ``call_ms`` through its wrapper, one eager call after another."""
    from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                         split_pages)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, KVH, G, D = q.shape
    args = (q, cache.k_pages, cache.v_pages, cache.block_table.clamp(min=0),
            cache.lengths)
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    got = paged_attention(*args, **kw)
    check(torch.equal(got, paged_attention(*args, **kw)),
          f"paged_attention {name}: a repeat differs")
    ref = paged_attention_ref(*args, **kw).float()
    err = (got.float() - ref).abs()
    check(bool((err <= ATTN_ATOL + ATTN_RTOL * ref.abs()).all()),
          f"paged_attention {name}: off its plain version by "
          f"{float(err.max()):.3e}")
    npmax = cache.block_table.shape[1]
    pps = split_pages(npmax, B, KVH, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    n_split = -(-npmax // pps)
    check(n_split > 1, f"paged_attention {name}: {n_split} split, so no more "
          f"CTAs than B * KVH = {B * KVH}")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PAGED_GRAPH_CALLS):
            paged_attention(*args, **kw)
    lens = cache.lengths.long()
    live = int((lens.clamp(max=window) if window > 0 else lens).sum())
    # each live key's K and V row once, q read and o written once
    nbytes = live * KVH * D * 2 * q.element_size() + 2 * q.numel() \
        * q.element_size()
    b_ms, b_by = bound_ms(nbytes, 4 * live * KVH * G * D,
                          BF16_TENSOR_OPS_PER_S)
    row = dict(
        name="paged_attention", shape=name, B=B, KVH=KVH, G=G, D=D,
        page=cache.page_size, window=window, live_keys=live,
        npmax=npmax, pages_per_split=pps, n_split=n_split,
        ctas=n_split * KVH * B,
        max_abs_err=float(err.max()),
        ms=timer.ms(graph.replay) / PAGED_GRAPH_CALLS,
        call_ms=timer.ms(lambda: paged_attention(*args, **kw)),
        plain_ms=timer.ms(lambda: paged_attention_ref(*args, **kw)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    say("lm.kernel", **{k_: (f"{v_:.4g}" if isinstance(v_, float) else v_)
                        for k_, v_ in row.items()})
    return row


def lm_phase(torch, timer, dev, seed, report, clock_mhz,
             profile=False) -> None:
    """Phase 6: serve 8 requests of Gemma-2 27B (full width, 8 layers, bf16)
    through flash prefill and paged decode; kernels against their plain
    versions at the serve shapes; paged decode against the dense plain
    ``serve_step``, teacher-forced."""
    from repro_torch import backend
    from repro_torch.configs.gemma2_27b import full_config
    from repro_torch.launch.serve import (DecodeGraph, fill_paged,
                                          pages_per_seq, serve)
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.layers import (apply_layer,
                                                       attention_inputs,
                                                       rmsnorm)
    cfg = dataclasses.replace(full_config(), n_layers=LM_LAYERS)
    params, init_s = timer.wall(lambda: M.init_params(cfg, seed=seed,
                                                      device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    B = LM_REQUESTS
    lens = torch.randint(LM_PROMPT_MIN, LM_PROMPT_MAX + 1, (B,),
                         generator=gen, device=dev, dtype=torch.int32)
    S = int(lens.max())
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                            dtype=torch.int32)
    n_params = M.param_count(params)
    out = report["lm"] = dict(
        config=cfg.name, layers=cfg.n_layers, params=n_params,
        weight_bytes=2 * n_params, init_seconds=init_s, requests=B,
        prompt_lens=lens.tolist(), padded_prompt=S, decode_steps=LM_DECODE,
        page=cfg.kv_page_size)
    say("lm.setup", **{k: v for k, v in out.items() if k != "prompt_lens"})

    # the serve path, with the launch counters at 0: decode replayed from
    # one CUDA graph (the card's default), then the eager loop it replaces
    live_tokens = int(lens.sum())
    tokens = {}
    for route, graph in (("graph", None), ("eager", False)):
        backend.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res, serve_s = timer.wall(lambda: serve(cfg, params, prompts, lens,
                                                LM_DECODE, device=dev,
                                                graph=graph))
        launches = {k: backend.LAUNCHES[k] for k in LM_KERNELS}
        for name, n in launches.items():
            check(n > 0, f"kernel {name} never launched on the {route} "
                  f"serve path")
        check(launches["flash_attention_wgmma"] == cfg.n_layers,
              f"prefill launched the tensor-core flash kernel "
              f"{launches['flash_attention_wgmma']} times, not "
              f"{cfg.n_layers}")
        check(launches["paged_attention"] == cfg.n_layers * LM_DECODE,
              f"{route} decode launched the paged kernel "
              f"{launches['paged_attention']} times, not "
              f"{cfg.n_layers * LM_DECODE}")
        check(backend.LAUNCHES["flash_attention"] == 0,
              "a bf16 prefill reached the float32 flash kernel")
        check(res.graph == (route == "graph"),
              f"the {route} serve decoded with graph={res.graph}")
        check(bool(torch.isfinite(res.prefill_logits).all()),
              "prefill logits not finite")
        check(res.tokens.shape == (B, LM_DECODE + 1)
              and int(res.tokens.min()) >= 0
              and int(res.tokens.max()) < cfg.vocab,
              "generated tokens malformed")
        step_s = sorted(res.decode_s)
        mean_step = sum(step_s) / len(step_s)
        pre = "" if route == "graph" else "eager_"
        out.update({
            f"{pre}serve_seconds": serve_s,
            f"{pre}prefill_s": res.prefill_s,
            f"{pre}time_to_first_token_s": res.prefill_s,
            f"{pre}fill_s": res.fill_s,
            f"{pre}decode_ms_per_step": 1e3 * mean_step,
            f"{pre}decode_ms_per_step_median": 1e3 * step_s[len(step_s) // 2],
            f"{pre}decode_ms_per_step_max": 1e3 * step_s[-1],
            f"{pre}decode_first_step_ms": 1e3 * res.decode_s[0],
            f"{pre}decode_tokens_per_s": B / mean_step,
            f"{pre}max_memory_allocated": torch.cuda.max_memory_allocated(),
            f"{pre}launches": launches})
        if route == "graph":
            out.update(graph_capture_s=res.capture_s,
                       prompt_tokens=live_tokens,
                       prompt_tokens_per_s=live_tokens / res.prefill_s,
                       pages_used=res.pages_used,
                       pool_pages=int(res.caches[0].free_stack.numel()))
            first_logits = res.prefill_logits
        tokens[route] = res.tokens
        del res
        torch.cuda.empty_cache()
    check(torch.equal(tokens["graph"], tokens["eager"]),
          "the graph and eager decode routes' greedy tokens differ")
    out["greedy_tokens_equal_across_routes"] = True
    tokens = tokens["graph"]
    say("lm.serve", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                       for k, v in out.items()
                       if k.startswith(("prefill", "prompt_tokens", "time_",
                                        "fill", "decode_", "pages", "pool",
                                        "max_mem", "launches", "graph_",
                                        "greedy"))})
    say("lm.serve_eager", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                             for k, v in out.items()
                             if k.startswith("eager_")})

    # flash against its plain version on the first local and global layers'
    # own inputs at the prefill shape
    toks = torch.where(torch.arange(S, device=dev)[None, :] < lens[:, None],
                       prompts, 0)
    positions = torch.arange(S, device=dev, dtype=torch.int32)[None] \
        .expand(B, S)
    x = M.embed(params, cfg, toks)
    rows = report["lm_kernels"] = []
    for li, name in ((0, "local"), (1, "global")):
        lp, window = params["layers"][li], cfg.layer_windows[li]
        q, k, v = attention_inputs(lp["attn"], cfg,
                                   rmsnorm(lp["ln1"], x, cfg.norm_eps),
                                   positions)
        rows.append(time_flash(torch, timer, f"{name} w={window}", q, k, v,
                               window, cfg.attn_softcap, True, clock_mhz))
        # the float32 kernel on the same inputs; compiled flex_attention in
        # float32 beside the global layer's
        rows.append(time_flash(torch, timer, f"f32 {name} w={window}",
                               q.float(), k.float(), v.float(), window,
                               cfg.attn_softcap, window == 0, clock_mhz))
        del q, k, v
        if li == 0:
            x = apply_layer(lp, cfg, x, positions, window)[0]
    del x
    torch.cuda.empty_cache()

    # the serve's caches after prefill, rebuilt as serve builds them
    if profile:
        (logits0, dense), report["profile_prefill"] = profiled(
            torch, lambda: M.prefill(params, cfg, toks))
    else:
        logits0, dense = M.prefill(params, cfg, toks)
    out["prefill_repeat_bit_identical"] = bool(torch.equal(logits0,
                                                           first_logits))
    caches = fill_paged(cfg, dense, lens,
                        pages_per_seq(S, LM_DECODE, cfg.kv_page_size),
                        cfg.kv_page_size)
    qd = torch.randn((B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                      cfg.head_dim), generator=gen, device=dev,
                     dtype=cfg.dtype)
    for li, name in ((0, "local"), (1, "global")):
        window = cfg.layer_windows[li]
        rows.append(time_paged(torch, timer, f"{name} w={window}",
                               caches[li], qd, window, cfg.attn_softcap))

    # paged decode against the dense plain serve_step on the same tokens
    dense_c = M.init_cache(cfg, B, S + LM_CHECK_STEPS, device=dev)
    live = (torch.arange(S, device=dev)[None, :] < lens[:, None])
    for name in ("k", "v"):
        dense_c[name][:, :, :, :S] = dense[name] * live[None, :, None, :,
                                                          None]
    dense_c["lengths"] = lens.clone()
    del dense
    # the same paged steps through the plain paged attention: how far bf16
    # rounding alone moves the logits off the dense decoder.  In-place steps
    # write every field of a cache, so each route has its own
    plain_caches = [type(c)(*(x.clone() for x in c)) for c in caches]
    steps, replay = [], None
    for step in range(LM_CHECK_STEPS):
        tok = tokens[:, step:step + 1]
        if replay is None:   # the kernel route as serve decodes: one eager
            replay = DecodeGraph(params, cfg, caches, tok)   # step, replays
            paged, caches = replay.first_logits, replay.caches
        else:
            paged = replay.step(tok)
        plain, plain_caches = M.serve_step_paged(
            params, cfg, plain_caches, tok, impl="torch", inplace=True)
        ref, dense_c = M.serve_step(params, cfg, dense_c, tok)
        check(bool(torch.isfinite(paged).all() & torch.isfinite(ref).all()),
              f"decode step {step}: logits not finite")
        diff = paged - ref
        rel = float(diff.norm() / ref.norm())
        steps.append(dict(step=step, rel_l2=rel,
                          plain_paged_rel_l2=float((plain - ref).norm()
                                                   / ref.norm()),
                          max_abs_diff=float(diff.abs().max()),
                          mean_abs_diff=float(diff.abs().mean()),
                          logit_std=float(ref.std()),
                          max_abs_logit=float(ref.abs().max()),
                          argmax_agree=float((paged.argmax(-1)
                                              == ref.argmax(-1)).float()
                                             .mean()),
                          greedy_reproduced=bool(torch.equal(
                              paged.argmax(-1).to(torch.int32),
                              tokens[:, step + 1]))))
        check(rel <= LOGIT_REL_L2,
              f"decode step {step}: paged logits off the dense serve_step "
              f"by {rel:.4g} relative L2 (> {LOGIT_REL_L2})")
    out["paged_vs_dense"] = steps
    if profile:   # one replayed step, then one eager step, on the caches
        tok = tokens[:, LM_CHECK_STEPS:LM_CHECK_STEPS + 1]
        _, report["profile_decode_step"] = profiled(
            torch, lambda: replay.step(tok))
        _, report["profile_decode_step_eager"] = profiled(
            torch, lambda: M.serve_step_paged(params, cfg, caches, tok,
                                              inplace=True))
        # the profiler slows the host, so the busy time is also given over
        # the route's unprofiled median step
        for key, median in (("profile_decode_step",
                             out["decode_ms_per_step_median"]),
                            ("profile_decode_step_eager",
                             out["eager_decode_ms_per_step_median"])):
            prof = report[key]
            prof["busy_over_median_step"] = \
                prof["device_busy_s"] * 1e3 / median
            say(f"lm.{key}", wall_ms=f"{prof['wall_s'] * 1e3:.4g}",
                device_busy_ms=f"{prof['device_busy_s'] * 1e3:.4g}",
                device_busy_share=f"{prof['device_busy_share']:.3f}",
                busy_over_median_step=f"{prof['busy_over_median_step']:.3f}",
                top=", ".join(f"{r['op'][:40]} x{r['count']} "
                              f"{r['device_ms']:.3f}ms"
                              for r in prof["top"][:5]))
    say("lm.check", steps=len(steps),
        rel_l2=f"{max(s['rel_l2'] for s in steps):.4g}",
        plain_paged_rel_l2=f"{max(s['plain_paged_rel_l2'] for s in steps):.4g}",
        max_abs_diff=f"{max(s['max_abs_diff'] for s in steps):.4g}",
        max_abs_logit=f"{max(s['max_abs_logit'] for s in steps):.4g}",
        argmax_agree=min(s["argmax_agree"] for s in steps),
        prefill_repeat_bit_identical=out["prefill_repeat_bit_identical"])
    lm_f32_path(torch, timer, dev, seed, report)


def _tree_to(tree, dev):
    """A parameter tree (dicts and lists of tensors) copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def lm_f32_path(torch, timer, dev, seed, report) -> None:
    """The float32 kernels' path: ``serve`` at the Gemma-2 smoke config
    (float32, 4 layers, head_dim 16; decode replayed from a CUDA graph)
    with the launch counters at 0, against the same serve on the host
    (plain versions): greedy tokens equal, prefill logits within rtol
    1e-4."""
    from repro_torch import backend
    from repro_torch.configs.gemma2_27b import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import model as M
    cfg = smoke_config()
    params = M.init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    lens = torch.randint(20, 70, (F32_LM_REQUESTS,), generator=gen,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab, (F32_LM_REQUESTS, int(lens.max())),
                            generator=gen, device=dev)
    backend.reset_launch_counts()
    res, sec = timer.wall(lambda: serve(cfg, params, prompts, lens,
                                        F32_LM_DECODE, page=16, device=dev))
    launches = {k: backend.LAUNCHES[k] for k in F32_LM_KERNELS}
    host = serve(cfg, _tree_to(params, "cpu"), prompts.cpu(), lens.cpu(),
                 F32_LM_DECODE, page=16, device="cpu")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the float32 serve")
    check(backend.LAUNCHES["flash_attention_wgmma"] == 0,
          "a float32 prefill reached the bf16 flash kernel")
    check(res.graph and launches["paged_attention"]
          == cfg.n_layers * F32_LM_DECODE,
          f"float32 serve: graph={res.graph}, "
          f"{launches['paged_attention']} paged launches")
    check(torch.equal(res.tokens.cpu(), host.tokens),
          "float32 serve: card and host tokens differ")
    check(torch.allclose(res.prefill_logits.cpu(), host.prefill_logits,
                         rtol=1e-4, atol=1e-5),
          "float32 serve: card and host prefill logits differ")
    report["lm_f32"] = dict(config=cfg.name, requests=F32_LM_REQUESTS,
                            decode_steps=F32_LM_DECODE, serve_seconds=sec,
                            launches=launches)
    say("lm.f32_serve", config=cfg.name, seconds=f"{sec:.3f}",
        launches=launches, tokens="equal to the host's")


# ---------------------------------------------------------------------------
# MoE serving: qwen3-moe-30b-a3b at full size
# ---------------------------------------------------------------------------

def moe_teacher_forced(torch, cfg, params, caches, dense, tokens, steps):
    """MOE_CHECK_STEPS decode steps fed the served tokens, layer by layer
    from the post-prefill state, on three sides: the kernel route over the
    paged caches; the dense plain decoder (``serve_step``'s arithmetic over
    a dense cache) fed, at every layer, the kernel side's input and K/V
    (teacher-forced); and the dense plain decoder run on its own, its
    logits held to ``serve_step``'s bit for bit.  At every layer, on the
    kernel side's input: paged attention against its plain version
    (ATTN_RTOL / ATTN_ATOL), the MoE block on the kernel route against
    ``impl="torch"`` bit for bit, and the layer's output (the hidden state
    the next layer reads) against the teacher-forced dense layer's within
    LOGIT_REL_L2, relative L2 per row, on the rows whose route -- the
    (expert, kept) pairs of its K lanes -- is the same on both (the
    difference over the layer's own update is recorded beside it); the
    step's logits likewise.  The dense
    decoder on its own is compared, not held: at random init a bf16
    rounding moves a route somewhere in 48 layers and capacity couples the
    rows, so its logits part from the kernel route's (``rel_l2_free``,
    ``first_layer_apart``).  Each step's record is appended to ``steps``
    as it ends; returns the share of the kernel side's lanes that kept a
    slot."""
    from repro_torch.models.transformer import kvcache as KV
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M
    B, E, K = tokens.shape[0], cfg.n_experts, cfg.top_k
    C = L.capacity(cfg, B)
    b_idx = torch.arange(B, device=tokens.device)
    scale = cfg.head_dim ** -0.5
    forced = {k: v.clone() for k, v in dense.items()}

    def routed(z, p):
        """bool[B, E] pair: the experts each row routes to (top-k), and
        those it keeps a slot of."""
        _, eidx, _ = L.route(p, cfg, z.reshape(B, -1).float())
        plan = L.token_plan(eidx, C, E)
        keep = torch.zeros_like(plan.keep)
        keep[plan.order] = plan.keep
        chosen = torch.zeros((B, E), dtype=torch.bool, device=z.device)
        chosen[b_idx[:, None], eidx] = True
        kept = torch.zeros_like(chosen)
        kept[b_idx[:, None], eidx] = keep.view(B, K)
        return chosen, kept

    def dense_layer(lp, x, cache, li, q, k, v, lengths):
        """serve_step's layer on x [B, 1, d] with q, k, v of x: (x', z)."""
        pos = lengths.long()
        cache["k"][li, b_idx, :, pos] = k
        cache["v"][li, b_idx, :, pos] = v
        o = M._dense_decode_attention(cfg, q, cache["k"][li],
                                      cache["v"][li], lengths, 0)
        x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
        z = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        return x + L.apply_moe(lp["moe"], cfg, z, "torch")[0], z

    def rel(a, b, base):
        """Per row: |a - b| / |base| (relative L2 over the row)."""
        return ((a.float() - b.float()).reshape(B, -1).norm(dim=1)
                / base.float().reshape(B, -1).norm(dim=1).clamp(min=1e-30))

    kept_lanes = lanes = 0
    for step in range(MOE_CHECK_STEPS):
        tok = tokens[:, step:step + 1]
        ref, _ = M.serve_step(params, cfg, dense, tok)
        lengths = dense["lengths"]
        xk = M.embed(params, cfg, tok)
        xd = xk.clone()
        differ = torch.zeros((B, cfg.n_layers), dtype=torch.bool,
                             device=tok.device)
        apart = torch.zeros_like(differ)
        layer_rel = torch.zeros((B, cfg.n_layers), device=tok.device)
        update_rel = torch.zeros_like(layer_rel)
        attn_err = attn_worst = 0.0
        for li, lp in enumerate(params["layers"]):
            q, k, v = M._decode_qkv(lp, cfg, xk, caches[li].lengths)
            caches[li] = KV.append(caches[li], k, v, inplace=True)
            o = KV.attend(caches[li], q, scale=scale, impl="cuda")
            o_plain = KV.attend(caches[li], q, scale=scale, impl="torch")
            err = (o.float() - o_plain.float()).abs()
            attn_err = max(attn_err, float(err.max()))
            attn_worst = max(attn_worst, float(
                (err / (ATTN_ATOL + ATTN_RTOL * o_plain.float().abs()))
                .max()))
            # the dense layer on the same input and K/V
            xf, zf = dense_layer(lp, xk, forced, li, q, k, v, lengths)
            x_mid = xk + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
            zk = L.rmsnorm(lp["ln2"], x_mid, cfg.norm_eps)
            yk, _ = L.apply_moe(lp["moe"], cfg, zk, "cuda")
            yt, _ = L.apply_moe(lp["moe"], cfg, zk, "torch")
            check(torch.equal(yk, yt),
                  f"moe check step {step} layer {li}: the MoE block on the "
                  f"kernel route differs from impl=\"torch\"")
            x_out = x_mid + yk
            layer_rel[:, li] = rel(x_out, xf, xf)
            update_rel[:, li] = rel(x_out, xf, xf - xk)
            (ck, kk), (cf, kf) = routed(zk, lp["moe"]), routed(zf, lp["moe"])
            differ[:, li] = ((ck != cf) | (kk != kf)).any(-1)
            kept_lanes += int(kk.sum())
            lanes += B * K
            # the dense decoder on its own
            xd, zd = dense_layer(lp, xd, dense, li,
                                 *M._decode_qkv(lp, cfg, xd, lengths),
                                 lengths)
            cd, kd = routed(zd, lp["moe"])
            apart[:, li] = ((ck != cd) | (kk != kd)).any(-1)
            xk = x_out
        check(attn_worst <= 1.0,
              f"moe check step {step}: paged attention off its plain "
              f"version by {attn_worst:.3g} of the bound")
        check(torch.equal(M._head(params, cfg, xd[:, 0]), ref),
              f"moe check step {step}: the dense decoder is not "
              f"serve_step's arithmetic")
        dense["lengths"] = forced["lengths"] = lengths + 1
        paged = M._head(params, cfg, xk[:, 0])
        logit_rel = rel(paged, M._head(params, cfg, xf[:, 0]), paged)
        held = ~differ
        worst_layer = float(layer_rel[held].max()) if bool(held.any()) \
            else None
        worst_update = float(update_rel[held].max()) if bool(held.any()) \
            else None
        held_rows = ~differ[:, -1]
        worst_logits = float(logit_rel[held_rows].max()) \
            if bool(held_rows.any()) else None
        steps.append(dict(
            step=step, row_layers_held=int(held.sum()),
            row_layers_differ=int(differ.sum()),
            layer_rel_l2_max=worst_layer, logits_rel_l2_max=worst_logits,
            layer_update_rel_l2_max=worst_update,
            paged_max_abs_err=attn_err, paged_err_over_bound=attn_worst,
            row_layers_apart=int(apart.sum()),
            first_layer_apart=[int(r.nonzero()[0]) if bool(r.any()) else None
                               for r in apart],
            rel_l2_free=float((paged - ref).norm() / ref.norm()),
            greedy_reproduced=bool(torch.equal(
                paged.argmax(-1).to(torch.int32), tokens[:, step + 1]))))
        check(worst_layer is not None and worst_layer <= LOGIT_REL_L2,
              f"moe check step {step}: a layer's output off the teacher-"
              f"forced dense layer's by {worst_layer} relative L2 (> "
              f"{LOGIT_REL_L2}) on the {int(held.sum())} (row, layer) "
              f"routes that agree")
        check(worst_logits is None or worst_logits <= LOGIT_REL_L2,
              f"moe check step {step}: logits off the teacher-forced dense "
              f"decoder's by {worst_logits} relative L2 (> "
              f"{LOGIT_REL_L2})")
    return kept_lanes / lanes


def moe_serve_phase(torch, timer, dev, seed, report, clock_mhz,
                    profile=False) -> None:
    """Phase 6b: serve 8 requests of qwen3-moe-30b-a3b (full width, all 48
    layers, bf16) through flash prefill and paged decode with the MoE's
    dispatch and combine on the graph kernels, decoded through one CUDA
    graph and by the eager loop; the exact launches; one eager step under
    sync debug mode "error"; the teacher-forced check
    (``moe_teacher_forced``); each kernel at its MoE-serving shapes."""
    from repro_torch import backend
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    from repro_torch.launch.serve import fill_paged, pages_per_seq, serve
    from repro_torch.models.transformer import kvcache as KV
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.layers import (attention_inputs,
                                                       capacity, rmsnorm)
    gc.collect()
    torch.cuda.empty_cache()
    say("moe.memory", allocated=torch.cuda.memory_allocated(),
        reserved=torch.cuda.memory_reserved())
    cfg = dataclasses.replace(full_config(), n_layers=MOE_LAYERS)
    params, init_s = timer.wall(lambda: M.init_params(cfg, seed + 71,
                                                      device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 73)
    B = MOE_REQUESTS
    lens = torch.randint(MOE_PROMPT_MIN, MOE_PROMPT_MAX + 1, (B,),
                         generator=gen, device=dev, dtype=torch.int32)
    S = int(lens.max())
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                            dtype=torch.int32)
    n_params = M.param_count(params)
    out = report["moe_serve"] = dict(
        config=cfg.name, layers=cfg.n_layers,
        full_layers=full_config().n_layers, params=n_params,
        weight_bytes=2 * n_params, init_seconds=init_s, requests=B,
        prompt_lens=lens.tolist(), padded_prompt=S,
        decode_steps=MOE_DECODE, page=cfg.kv_page_size,
        capacity_prefill=capacity(cfg, B * S),
        capacity_decode=capacity(cfg, B),
        allocated_after_init=torch.cuda.memory_allocated())
    say("moe.setup", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in out.items() if k != "prompt_lens"})

    # the serve path, launch counters at 0: decode through one CUDA graph,
    # then the eager loop
    pre, step_n = moe_prefill_launches(cfg.n_layers), \
        moe_step_launches(cfg.n_layers)
    want = {k: pre[k] + MOE_DECODE * step_n[k] for k in MOE_KERNELS}
    live_tokens = int(lens.sum())
    tokens = {}
    for route, graph in (("graph", None), ("eager", False)):
        gc.collect()
        torch.cuda.empty_cache()
        backend.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res, serve_s = timer.wall(lambda: serve(cfg, params, prompts, lens,
                                                MOE_DECODE, device=dev,
                                                graph=graph))
        launches = {k: backend.LAUNCHES[k] for k in MOE_KERNELS}
        check(launches == want, f"the {route} MoE serve launched "
              f"{launches}, not {want}")
        check(backend.LAUNCHES["flash_attention"] == 0,
              "a bf16 prefill reached the float32 flash kernel")
        check(res.graph == (route == "graph"),
              f"the {route} MoE serve decoded with graph={res.graph}")
        check(bool(torch.isfinite(res.prefill_logits).all()),
              "MoE prefill logits not finite")
        check(res.tokens.shape == (B, MOE_DECODE + 1)
              and int(res.tokens.min()) >= 0
              and int(res.tokens.max()) < cfg.vocab,
              "MoE generated tokens malformed")
        step_s = sorted(res.decode_s)
        median = step_s[len(step_s) // 2]
        p_ = "" if route == "graph" else "eager_"
        out.update({
            f"{p_}serve_seconds": serve_s, f"{p_}prefill_s": res.prefill_s,
            f"{p_}fill_s": res.fill_s,
            f"{p_}decode_ms_per_step_median": 1e3 * median,
            f"{p_}decode_ms_per_step_mean": 1e3 * sum(step_s) / len(step_s),
            f"{p_}decode_ms_per_step_max": 1e3 * step_s[-1],
            f"{p_}decode_first_step_ms": 1e3 * res.decode_s[0],
            f"{p_}decode_tokens_per_s": B / median,
            f"{p_}max_memory_allocated": torch.cuda.max_memory_allocated(),
            f"{p_}max_memory_reserved": torch.cuda.max_memory_reserved(),
            f"{p_}launches": launches})
        if route == "graph":
            out.update(graph_capture_s=res.capture_s,
                       prompt_tokens=live_tokens,
                       prompt_tokens_per_s=live_tokens / res.prefill_s,
                       pages_used=res.pages_used,
                       pool_pages=int(res.caches[0].free_stack.numel()))
            first_logits = res.prefill_logits
        tokens[route] = res.tokens
        del res
    check(torch.equal(tokens["graph"], tokens["eager"]),
          "the graph and eager MoE decode routes' greedy tokens differ")
    out["greedy_tokens_equal_across_routes"] = True
    tokens = tokens["graph"]
    say("moe.serve", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in out.items()
                        if k.startswith(("prefill", "prompt_tokens", "fill",
                                         "decode_", "pages", "pool",
                                         "max_mem", "graph_", "greedy"))})
    say("moe.serve_eager", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                              for k, v in out.items()
                              if k.startswith("eager_")
                              and k != "eager_launches"})
    gc.collect()
    torch.cuda.empty_cache()

    # prefill again with the counters at 0: its launches alone
    toks = torch.where(torch.arange(S, device=dev)[None, :] < lens[:, None],
                       prompts, 0)
    backend.reset_launch_counts()
    logits0, dense = M.prefill(params, cfg, toks)
    got = {k: backend.LAUNCHES[k] for k in MOE_KERNELS}
    check(got == pre, f"MoE prefill launched {got}, not {pre}")
    out["prefill_repeat_bit_identical"] = bool(torch.equal(logits0,
                                                           first_logits))
    del logits0

    # flash at G = 8 on layer 0's own inputs
    rows = report["moe_serve_kernels"] = []
    x = M.embed(params, cfg, toks)
    lp = params["layers"][0]
    q, k, v = attention_inputs(lp["attn"], cfg,
                               rmsnorm(lp["ln1"], x, cfg.norm_eps),
                               torch.arange(S, device=dev, dtype=torch.int32)
                               [None].expand(B, S))
    rows.append(time_flash(torch, timer, MOE_SERVE_MAIN[
        "flash_attention_wgmma"], q, k, v, 0, 0.0, True, clock_mhz))
    del q, k, v, x

    # the caches serve decodes over; paged at G = 8 on layer 0's
    caches = fill_paged(cfg, dense, lens,
                        pages_per_seq(S, MOE_DECODE, cfg.kv_page_size),
                        cfg.kv_page_size)
    qd = torch.randn((B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                      cfg.head_dim), generator=gen, device=dev,
                     dtype=cfg.dtype)
    rows.append(time_paged(torch, timer, MOE_SERVE_MAIN["paged_attention"],
                           caches[0], qd, 0, 0.0))
    del qd

    # one eager MoE decode step as serve's eager loop runs it, on copies of
    # the caches, under sync debug mode "error"
    copies = [KV.PagedKVCache(*(t_.clone() for t_ in c)) for c in caches]
    tok = tokens[:, :1]
    backend.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_logits, _ = M.serve_step_paged(params, cfg, copies, tok,
                                            inplace=True)
    except RuntimeError as e:
        raise SmokeFailure(f"the eager MoE decode step read the device "
                           f"from the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k: backend.LAUNCHES[k] for k in MOE_KERNELS}
    check(got == step_n, f"an MoE decode step launched {got}, not {step_n}")
    check(torch.equal(step_logits.argmax(-1).to(torch.int32), tokens[:, 1]),
          "the sync-debug step's greedy tokens are not the served ones")
    out["sync_debug_step"] = dict(launches=got, ok=True)
    if profile:   # one replayed, then one eager step, on the copies
        from repro_torch.launch.serve import DecodeGraph
        replay = DecodeGraph(params, cfg, copies, tokens[:, 1:2])
        for key, fn in (("profile_decode_step",
                         lambda: replay.step(tokens[:, 2:3])),
                        ("profile_decode_step_eager",
                         lambda: M.serve_step_paged(params, cfg, copies,
                                                    tokens[:, 3:4],
                                                    inplace=True))):
            _, prof = profiled(torch, fn)
            report[f"moe_{key}"] = prof
            say(f"moe.{key}", wall_ms=f"{prof['wall_s'] * 1e3:.4g}",
                device_busy_ms=f"{prof['device_busy_s'] * 1e3:.4g}",
                device_busy_share=f"{prof['device_busy_share']:.3f}",
                top=", ".join(f"{r['op'][:40]} x{r['count']} "
                              f"{r['device_ms']:.3f}ms"
                              for r in prof["top"][:8]))
        del replay
    del copies, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    # the teacher-forced check against the dense plain decoder
    dense_c = M.init_cache(cfg, B, S + MOE_CHECK_STEPS, device=dev)
    live = torch.arange(S, device=dev)[None, :] < lens[:, None]
    for name in ("k", "v"):
        dense_c[name][:, :, :, :S] = dense[name] * live[None, :, None, :,
                                                          None]
    dense_c["lengths"] = lens.clone()
    del dense
    steps = out["check_steps"] = []
    kept_share = out["decode_kept_lane_share"] = moe_teacher_forced(
        torch, cfg, params, caches, dense_c, tokens, steps)

    def joined(key, fmt="{}"):
        return "/".join("-" if s_[key] is None else fmt.format(s_[key])
                        for s_ in steps)

    say("moe.check", steps=len(steps),
        row_layers_held=joined("row_layers_held"),
        row_layers_differ=joined("row_layers_differ"),
        layer_rel_l2_max=joined("layer_rel_l2_max", "{:.4g}"),
        layer_update_rel_l2_max=joined("layer_update_rel_l2_max", "{:.4g}"),
        logits_rel_l2_max=joined("logits_rel_l2_max", "{:.4g}"),
        paged_err_over_bound=joined("paged_err_over_bound", "{:.3g}"),
        row_layers_apart=joined("row_layers_apart"),
        first_layer_apart=steps[0]["first_layer_apart"],
        rel_l2_free=joined("rel_l2_free", "{:.4g}"),
        kept_lane_share=f"{kept_share:.4f}",
        moe_block_bit_identical=True,
        prefill_repeat_bit_identical=out["prefill_repeat_bit_identical"])
    del caches, dense_c
    gc.collect()
    torch.cuda.empty_cache()

    # the graph kernels at the MoE's prefill and decode shapes
    p0 = params["layers"][0]["moe"]
    for tag, T in (("moe prefill", B * S), ("moe decode", B)):
        rows += moe_kernel_rows(torch, timer, dev, p0, cfg, T, tag,
                                seed + 79)


# ---------------------------------------------------------------------------
# recsys serving: SASRec at its full published config
# ---------------------------------------------------------------------------

def sasrec_histories(torch, gen, cfg, B, dev):
    """Left-padded histories: lengths uniform in S/2..S (as
    ``sasrec_batches`` draws them), items uniform in [1, n_items]."""
    S = cfg.seq_len
    lens = torch.randint(S // 2, S + 1, (B, 1), generator=gen, device=dev)
    items = torch.randint(1, cfg.n_items + 1, (B, S), generator=gen,
                          device=dev, dtype=torch.int32)
    return torch.where(torch.arange(S, device=dev) >= S - lens, items, 0)


def time_embedding_bag(torch, timer, name, table, ids, weights, seg=None,
                       num_bags=None):
    """``embedding_bag`` (``[B, L]`` ids) or, with ``seg``,
    ``embedding_bag_sorted`` against its plain version (bit-exact for
    one-slot bags, else within rtol 1e-5 of a float64 sum and bit-identical
    on a repeat), timed beside the plain version,
    ``torch.nn.functional.embedding_bag`` and the bytes bound; the row names
    the kernel the shape is routed to (short bags or a warp per bag)."""
    from repro_torch.kernels.embedding_bag.ops import (embedding_bag,
                                                       embedding_bag_sorted,
                                                       kernel_route)
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_ref, embedding_bag_sorted_ref)
    V, F = table.shape
    if seg is None:
        B, L = ids.shape
        kern = functools.partial(embedding_bag, table, ids, weights)
        plain = functools.partial(embedding_bag_ref, table, ids, weights)
        w_t = weights if isinstance(weights, torch.Tensor) else \
            torch.tensor(weights, dtype=torch.float32, device=table.device)
        flat_w = w_t.expand(B, L).reshape(-1)
        offsets = None
    else:
        B, L = num_bags, 0
        args = (table, ids, seg, weights, num_bags)
        kern = functools.partial(embedding_bag_sorted, *args)
        plain = functools.partial(embedding_bag_sorted_ref, *args)
        flat_w = weights
        offsets = torch.searchsorted(seg, torch.arange(
            num_bags, dtype=torch.int32, device=seg.device), out_int32=True)
    got, again = kern(), kern()
    flat = ids.reshape(-1)
    live = flat >= 0
    if L == 1:
        ref = plain()
        err = (got - ref).abs()
        check(torch.equal(got, ref), f"embedding_bag {name}: one-slot bags "
              f"differ from the plain version")
    else:
        ref = (embedding_bag_ref(table.double(), ids, w_t.double())
               if seg is None else
               embedding_bag_sorted_ref(table.double(), ids, seg,
                                        weights.double(), num_bags))
        err = (got.double() - ref).abs()
        check(bool((err <= SEG_ATOL + SEG_RTOL * ref.abs()).all()),
              f"embedding_bag {name}: outside rtol {SEG_RTOL} of the "
              f"float64 sum (max abs err {float(err.max()):.3e})")
    check(torch.equal(got, again), f"embedding_bag {name}: repeat differs")
    # the library call: ids -1 passed as row 0 with weight 0
    lib_ids = flat.clamp(0, V - 1) if seg is not None else \
        ids.clamp(0, V - 1)
    lib_w = (flat_w * live).reshape(lib_ids.shape)
    emb_bag = torch.nn.functional.embedding_bag
    n_live = int(live.sum())
    rows_read = int(torch.unique(flat[live].clamp(max=V - 1)).numel())
    # each live row the ids name read once, the ids and a weight tensor read
    # once (a number weight is no bytes), the output written once; two flops
    # per live element
    w_bytes = weights.numel() * 4 if isinstance(weights, torch.Tensor) else 0
    b_ms, b_by = bound_ms(rows_read * F * 4 + flat.numel() * 4 + w_bytes
                          + B * F * 4, 2 * n_live * F)
    row = dict(
        name="embedding_bag", shape=name, kernel=kernel_route(B, L, F),
        bags=B, slots=flat.numel(),
        live_slots=n_live, rows_read=rows_read, F=F,
        max_abs_err=float(err.max()), bit_identical_repeat=True,
        # 100 calls a timing: at 0.04 ms a call, 5 would also time the
        # wrapper's host launch cost before the first one reaches the card
        ms=timer.ms(kern, EMB_TIMED_CALLS),
        plain_ms=timer.ms(plain, EMB_TIMED_CALLS),
        library_ms=timer.ms(lambda: emb_bag(lib_ids, table, offsets,
                                            mode="sum",
                                            per_sample_weights=lib_w),
                            EMB_TIMED_CALLS),
        bound_ms=b_ms, bound_by=b_by)
    say("recsys.kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                            for k, v in row.items()})
    return row


def recsys_kernel_checks(torch, timer, dev, gen, table, bulk_seq, cands,
                         d):
    """Each recsys kernel against its plain version at the path's shapes."""
    rows = []
    ids = torch.where(bulk_seq == 0, -1, bulk_seq).reshape(-1, 1)
    rows.append(time_embedding_bag(torch, timer, "serve_bulk chunk lookup",
                                   table, ids, d ** 0.5))
    V = table.shape[0]
    B, L = BAG_CHECK_BAGS, BAG_CHECK_SLOTS
    ids = torch.randint(1, V, (B, L), generator=gen, device=dev,
                        dtype=torch.int32)
    ids = torch.where(torch.rand((B, L), generator=gen, device=dev) < 0.1,
                      -1, ids)
    w = torch.rand((B, L), generator=gen, device=dev)
    rows.append(time_embedding_bag(torch, timer, f"{B}x{L} weighted", table,
                                   ids, w))
    lens = torch.randint(1, BAG_RAGGED_MAX + 1, (B,), generator=gen,
                         device=dev)
    seg = torch.repeat_interleave(
        torch.arange(B, dtype=torch.int32, device=dev), lens)
    n = seg.numel()
    ids = torch.randint(1, V, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids = torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, -1, ids)
    w = torch.rand(n, generator=gen, device=dev)
    rows.append(time_embedding_bag(torch, timer,
                                   f"ragged 1-{BAG_RAGGED_MAX} sorted", table,
                                   ids, w, seg=seg, num_bags=B))
    rows.append(time_gather(torch, timer, "retrieval candidates", table,
                            cands.reshape(-1)))
    return rows


def recsys_phase(torch, timer, dev, seed, report, profile=False) -> None:
    """Phase 7: SASRec at its full published config through its three serve
    shapes; the kernels against their plain versions at those shapes."""
    from repro_torch import backend
    from repro_torch.configs.sasrec import RECSYS_SHAPES, full_config
    from repro_torch.models.recsys import sasrec as M
    cfg = full_config()
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    params, init_s = timer.wall(lambda: M.init_params(cfg, gen, device=dev))
    table = params["item_emb"]
    S = cfg.seq_len
    n_p99 = RECSYS_SHAPES["serve_p99"]["batch"]
    n_bulk = RECSYS_SHAPES["serve_bulk"]["batch"]
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    p99 = sasrec_histories(torch, gen, cfg, P99_REQUESTS * n_p99, dev) \
        .reshape(P99_REQUESTS, n_p99, S)
    one = sasrec_histories(torch, gen, cfg, 1, dev)
    cands = torch.randint(1, cfg.n_items + 1, (1, n_cand), generator=gen,
                          device=dev, dtype=torch.int32)
    bulk = sasrec_histories(torch, gen, cfg, n_bulk, dev)
    out = report["recsys"] = dict(
        config=cfg.name, items=cfg.n_items, table_rows=table.shape[0],
        table_bytes=table.numel() * 4, embed_dim=cfg.embed_dim,
        blocks=cfg.n_blocks, heads=cfg.n_heads, seq_len=S,
        init_seconds=init_s,
        history_live_mean=float((bulk != 0).float().sum(1).mean()))
    say("recsys.setup", **out)

    # the serve path, with the launch counters at 0
    backend.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    p99_s = []
    for r in range(P99_REQUESTS):
        (vals, ids), sec = timer.wall(lambda: M.serve_step_topk(
            params, cfg, p99[r], k=TOPK))
        p99_s.append(sec)
        check(vals.shape == (n_p99, TOPK) and bool(torch.isfinite(vals)
                                                   .all()),
              f"serve_p99 request {r}: top-k values malformed")
    ret_s = []
    for _ in range(RETRIEVAL_REQUESTS):
        scores, sec = timer.wall(lambda: M.score_candidates(params, cfg, one,
                                                            cands))
        ret_s.append(sec)
    bulk_vals = torch.empty((n_bulk, TOPK), device=dev)
    bulk_ids = torch.empty((n_bulk, TOPK), dtype=torch.int32, device=dev)

    def serve_bulk():
        for c in range(0, n_bulk, BULK_CHUNK):
            bulk_vals[c:c + BULK_CHUNK], bulk_ids[c:c + BULK_CHUNK] = \
                M.serve_step_topk(params, cfg, bulk[c:c + BULK_CHUNK],
                                  k=TOPK)

    _, bulk_s = timer.wall(serve_bulk)
    launches = {k: backend.LAUNCHES[k] for k in RECSYS_KERNELS}
    p99_sorted, ret_sorted = sorted(p99_s), sorted(ret_s)
    out.update(
        p99_requests=P99_REQUESTS, p99_users=n_p99,
        p99_latency_ms_median=1e3 * p99_sorted[len(p99_s) // 2],
        p99_latency_ms_max=1e3 * p99_sorted[-1],
        p99_latency_ms_first=1e3 * p99_s[0],
        retrieval_candidates=n_cand,
        retrieval_latency_ms_median=1e3 * ret_sorted[len(ret_s) // 2],
        retrieval_latency_ms_max=1e3 * ret_sorted[-1],
        bulk_users=n_bulk, bulk_chunk=BULK_CHUNK, bulk_seconds=bulk_s,
        bulk_users_per_s=n_bulk / bulk_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches)
    say("recsys.serve", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                           for k, v in out.items()
                           if k.startswith(("p99_lat", "retrieval_lat",
                                            "bulk_", "max_mem", "launches"))})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the recsys path")
    check(bool(torch.isfinite(bulk_vals).all())
          and int(bulk_ids.min()) >= 0 and int(bulk_ids.max()) <= cfg.n_items
          and bool((bulk_vals[:, :-1] >= bulk_vals[:, 1:]).all()),
          "serve_bulk: top-k malformed")
    check(scores.shape == (1, n_cand) and bool(torch.isfinite(scores).all()),
          "retrieval scores malformed")

    # the kernel route against the plain route on a serve_p99 batch
    u_k = M.user_repr(params, cfg, p99[0], impl="cuda")
    u_p = M.user_repr(params, cfg, p99[0], impl="torch")
    check(torch.equal(u_k, u_p), "user_repr: kernel and plain routes differ")
    _, top_k = M.serve_step_topk(params, cfg, p99[0], k=TOPK, impl="cuda")
    _, top_p = M.serve_step_topk(params, cfg, p99[0], k=TOPK, impl="torch")
    check(torch.equal(top_k, top_p), "serve_p99: top-100 ids differ between "
                                     "the kernel and plain routes")
    # score_candidates against the full catalog's scores
    full = M.serve_step(params, cfg, one)
    ref = full.gather(1, cands.long())
    cand_err = float((scores - ref).abs().max())
    check(torch.allclose(scores, ref, rtol=SCORE_RTOL, atol=SCORE_ATOL),
          f"score_candidates off serve_step by {cand_err:.3e}")
    del full, ref
    out.update(user_repr_routes_bit_identical=True, topk_ids_equal=True,
               candidates_vs_serve_step_max_abs_err=cand_err)

    # where a request's time goes: CUDA events around each stage
    stages = {}
    for shape, seq in (("serve_p99", p99[0]),
                       ("serve_bulk", bulk[:BULK_CHUNK])):
        u = M.user_repr(params, cfg, seq)
        st = dict(user_repr_ms=timer.ms(lambda: M.user_repr(params, cfg,
                                                            seq), 3),
                  scores_ms=timer.ms(lambda: u @ table.T, 3))
        scores_full = u @ table.T
        st["topk_ms"] = timer.ms(lambda: torch.topk(scores_full, TOPK), 3)
        del scores_full
        stages[shape] = st
        say("recsys.stages", shape=shape,
            **{k: f"{v:.4g}" for k, v in st.items()})
    if profile:
        _, report["profile_recsys_bulk_chunk"] = profiled(
            torch, lambda: M.serve_step_topk(params, cfg, bulk[:BULK_CHUNK],
                                             k=TOPK))
    out["stages"] = stages
    say("recsys.check", user_repr_routes="bit-identical",
        topk_ids="equal", candidates_vs_serve_step=f"{cand_err:.3e}")
    report["recsys_kernels"] = recsys_kernel_checks(
        torch, timer, dev, gen, table, bulk[:BULK_CHUNK], cands,
        cfg.embed_dim)


# ---------------------------------------------------------------------------
# GNN training: GIN-TU at ogb_products size through launch/train.py's step
# ---------------------------------------------------------------------------

def gnn_batch(torch, shape, live, seed, dev, with_pos):
    """(GraphBatch, live edges): RMAT at the ``live`` (nodes, edges) counts
    padded to ``GNN_SHAPES[shape]``'s capacities (pads invalid), random
    features, labels and positions, all made on the device from ``seed``."""
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.models.gnn.common import GraphBatch
    n_cap, e_cap, d_feat, n_cls, _, _ = GNN_SHAPES[shape]
    n_live, e_live = live
    gen = torch.Generator(device=dev).manual_seed(seed)
    src, dst = rmat_edges(n_live, e_live, seed=seed, device=dev)
    E = src.numel()
    edge_src = torch.zeros(e_cap, dtype=torch.int32, device=dev)
    edge_dst = torch.zeros(e_cap, dtype=torch.int32, device=dev)
    edge_src[:E], edge_dst[:E] = src, dst
    del src, dst
    edge_valid = torch.zeros(e_cap, dtype=torch.bool, device=dev)
    edge_valid[:E] = True
    node_valid = torch.zeros(n_cap, dtype=torch.bool, device=dev)
    node_valid[:n_live] = True
    g = GraphBatch(
        x=torch.randn((n_cap, d_feat), generator=gen, device=dev),
        edge_src=edge_src, edge_dst=edge_dst, edge_valid=edge_valid,
        node_valid=node_valid,
        graph_id=torch.zeros(n_cap, dtype=torch.int32, device=dev),
        pos=(torch.randn((n_cap, 3), generator=gen, device=dev)
             if with_pos else None),
        labels=torch.randint(0, n_cls, (n_cap,), generator=gen, device=dev,
                             dtype=torch.int32))
    return g, E


def grad_agreement(torch, got, ref, rtol=TRAIN_GRAD_RTOL,
                   atol=TRAIN_GRAD_ATOL):
    """Each gradient leaf's largest |difference| against ``rtol`` of its
    largest |value| (+ ``atol``), the share of its elements within the same
    tolerances one by one, and the difference's norm over the leaf's (in
    float32 for a bf16 leaf)."""
    from repro_torch import tree as T
    paths, ref_leaves = T.flatten_with_paths(ref)
    rows, ok = [], True
    for path, a, b in zip(paths, T.leaves(got), ref_leaves):
        a, b = a.float(), b.float()
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        leaf_ok = bool(torch.isfinite(a).all()) and \
            diff <= rtol * scale + atol
        ok &= leaf_ok
        close = (a - b).abs() <= atol + rtol * b.abs()
        rows.append(dict(path=path, max_abs_diff=diff, max_abs=scale,
                         elementwise_share=float(close.float().mean()),
                         norm_rel=float(torch.linalg.vector_norm(a - b)
                                        / max(float(torch.linalg.vector_norm(
                                            b)), 1e-30)),
                         ok=leaf_ok))
    return ok, rows


def float64_distances(torch, loss_fn, params, g, trees):
    """For each gradient tree of ``trees``, each leaf's largest |difference|
    from the float64 plain route's gradient over that leaf's largest
    |value|."""
    from repro_torch import tree as T
    from repro_torch.launch.train import value_and_grad
    p64 = T.unflatten(params, [x.double() for x in T.leaves(params)])
    g64 = g._replace(x=g.x.double(), plan=None,
                     pos=None if g.pos is None else g.pos.double())
    _, ref = value_and_grad(lambda p, b: loss_fn(p, b, "torch"))(p64, g64)
    return [[float((a.double() - b).abs().max())
             / max(float(b.abs().max()), 1e-30)
             for a, b in zip(T.leaves(tree), T.leaves(ref))]
            for tree in trees]


def route_agreement(torch, timer, arch, loss_fn, params, g, want,
                    float64_floor=False, loss_rtol=TRAIN_LOSS_RTOL,
                    grad_rtol=TRAIN_GRAD_RTOL, grad_atol=TRAIN_GRAD_ATOL):
    """The kernel route's loss and gradients against ``impl="torch"`` on the
    card on one batch (within ``loss_rtol``; each gradient leaf's largest
    difference within ``grad_rtol`` of its largest |value| + ``grad_atol``),
    and the launches of one kernel-route value and gradient, which must
    equal ``want`` (kernel -> launches) exactly.
    With ``float64_floor`` (a model whose float32 gradients are
    ill-conditioned), a leaf off
    ``impl="torch"`` by more than the tolerance passes if it lies within
    the float32 floor of the float64 plain route's gradient: no farther
    from it than ``TRAIN_GRAD_RTOL`` (of the leaf's largest |value|) plus
    the float32 plain route's distance in its farthest leaf."""
    from repro_torch import backend
    from repro_torch.launch.train import value_and_grad
    backend.reset_launch_counts()
    (lk, gk), kern_s = timer.wall(lambda: value_and_grad(loss_fn)(params, g))
    per_step = {k: backend.LAUNCHES[k] for k in want}
    (lt, gt), plain_s = timer.wall(lambda: value_and_grad(
        lambda p, b: loss_fn(p, b, "torch"))(params, g))
    loss_rel = abs(float(lk) - float(lt)) / abs(float(lt))
    grads_ok, grad_rows = grad_agreement(torch, gk, gt, grad_rtol,
                                         grad_atol)
    grad_max_rel = max(r["max_abs_diff"] / max(r["max_abs"], 1e-30)
                       for r in grad_rows)
    share_min = min(r["elementwise_share"] for r in grad_rows)
    norm_rel_max = max(r["norm_rel"] for r in grad_rows)
    floor = {}
    if float64_floor:
        k64, t64 = float64_distances(torch, loss_fn, params, g, (gk, gt))
        bar = max(t64) + TRAIN_GRAD_RTOL
        for row, k, t in zip(grad_rows, k64, t64):
            row.update(kernel_vs_float64=k, torch_vs_float64=t,
                       within_floor=k <= bar)
        on_floor = [r["path"] for r in grad_rows
                    if not r["ok"] and r["within_floor"]]
        for r in grad_rows:
            r["ok"] = r["ok"] or r["within_floor"]
        grads_ok = all(r["ok"] for r in grad_rows)
        floor = dict(float32_floor=max(t64), kernel_vs_float64_max=max(k64),
                     leaves_on_floor=on_floor)
    out = dict(first_loss_kernel=float(lk), first_loss_torch=float(lt),
               loss_rel_diff=loss_rel, grads_within=grads_ok,
               grad_max_rel=grad_max_rel, grad_norm_rel_max=norm_rel_max,
               grad_leaves=grad_rows, launches_per_step=per_step,
               value_and_grad_seconds_kernel=kern_s,
               value_and_grad_seconds_torch=plain_s, **floor)
    say("train.routes", arch=arch, loss_kernel=f"{float(lk):.6g}",
        loss_torch=f"{float(lt):.6g}", loss_rel_diff=f"{loss_rel:.3e}",
        grad_max_rel=f"{grad_max_rel:.3e}",
        grad_norm_rel_max=f"{norm_rel_max:.3e}",
        grad_elementwise_share_min=f"{share_min:.6f}",
        kernel_s=f"{kern_s:.4g}", torch_s=f"{plain_s:.4g}",
        launches_per_step=per_step,
        **{k: (f"{v:.3e}" if isinstance(v, float) else v)
           for k, v in floor.items()})
    check(math.isfinite(float(lk)) and loss_rel <= loss_rtol,
          f"{arch} loss: kernel route {float(lk)} vs impl='torch' "
          f"{float(lt)} (rel {loss_rel:.3e})")
    check(grads_ok, f"{arch} gradients: kernel route off impl='torch' by "
          "more than the tolerance in some leaf: " + ", ".join(
              r["path"] for r in grad_rows if not r["ok"]))
    for name in want:
        check(per_step[name] == want[name],
              f"one {arch} step launched {name} {per_step[name]} times, "
              f"not {want[name]}")
    return out


def time_stream_gather(torch, timer, name, table, ids):
    """``block_gather`` of ``table`` rows at ``ids`` (a train-path stream)
    against its plain version chunk by chunk (bit for bit), timed beside
    it, ``index_select`` and its bytes bound."""
    from repro_torch.kernels.block_gather.ops import gather_rows
    from repro_torch.kernels.block_gather.ref import block_gather_ref
    got = gather_rows(table, ids, rows_per_step=1)
    for c in range(0, ids.numel(), TRAIN_CHECK_CHUNK):
        check(torch.equal(got[c:c + TRAIN_CHECK_CHUNK], block_gather_ref(
            table, ids[c:c + TRAIN_CHECK_CHUNK], 1)),
            f"block_gather {name}: differs from plain")
    del got
    rows_read = int(torch.unique(ids).numel())
    F = table.shape[1]
    b_ms, b_by = bound_ms(rows_read * F * 4 + ids.numel() * 4
                          + ids.numel() * F * 4, 0)
    row = dict(
        name="block_gather", shape=name, N=ids.numel(), F=F,
        rows_read=rows_read, max_abs_err=0.0,
        ms=timer.ms(lambda: gather_rows(table, ids, rows_per_step=1), 3),
        plain_ms=timer.ms(lambda: block_gather_ref(table, ids, 1), 3),
        library_ms=timer.ms(lambda: table.index_select(0, ids), 3),
        bound_ms=b_ms, bound_by=b_by)
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in row.items()})
    return row


def time_stream_sum(torch, timer, name, stream, row_ptr, parts):
    """``segment_sum`` over a train-path stream in CSR order against a
    float64 sum (16 features at a time), bit-identical on a repeat, timed
    beside its plain version, ``torch.segment_reduce`` on the same stream
    and its bytes bound."""
    from repro_torch.kernels.segment_matmul.ops import segment_sum_csr
    from repro_torch.kernels.segment_matmul.ref import segment_sum_csr_ref
    got = segment_sum_csr(stream, row_ptr, parts)
    check(torch.equal(got, segment_sum_csr(stream, row_ptr, parts)),
          f"segment_sum {name}: repeat differs")
    V, F = stream.shape
    R = row_ptr.numel() - 1
    err = 0.0
    for f0 in range(0, F, 16):
        ref64 = segment_sum_csr_ref(stream[:, f0:f0 + 16].double(), row_ptr)
        e = (got[:, f0:f0 + 16].double() - ref64).abs()
        check(bool((e <= SEG_ATOL + SEG_RTOL * ref64.abs()).all()),
              f"segment_sum {name}: outside rtol {SEG_RTOL} of the float64 "
              f"sum (max abs err {float(e.max()):.3e})")
        err = max(err, float(e.max()))
        del ref64, e
    del got
    offsets = row_ptr.long()
    b_ms, b_by = bound_ms(V * F * 4 + (R + 1) * 4 + R * F * 4, V * F)
    row = dict(
        name="segment_sum", shape=name, V=V, F=F, rows=R,
        tiles=parts.shape[0] - 1, max_abs_err=err, bit_identical_repeat=True,
        ms=timer.ms(lambda: segment_sum_csr(stream, row_ptr, parts), 3),
        plain_ms=timer.ms(lambda: segment_sum_csr_ref(stream, row_ptr), 3),
        library_ms=timer.ms(lambda: torch.segment_reduce(
            stream, "sum", offsets=offsets), 3),
        bound_ms=b_ms, bound_by=b_by)
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in row.items()})
    return row


def train_kernel_rows(torch, timer, dev, g, seed):
    """Both graph kernels at the aggregation's shapes on the ogb_products
    plan: forward (x[src] in destination order, summed by destination) at
    F = 100 and 64, backward (grad[dst] in source order, summed by source)
    at F = 64 and 100."""
    from repro_torch.kernels.block_gather.ops import gather_rows
    plan = g.plan
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    rows = []
    for F in (100, 64):
        table = g.x if F == g.x.shape[1] else torch.randn(
            (g.num_nodes, F), generator=gen, device=dev)
        for way, ids, side in (("fwd", plan.src_by_dst, "dst"),
                               ("bwd", plan.dst_by_src, "src")):
            shape = f"train {way} F={F}"
            rows.append(time_stream_gather(torch, timer, shape, table, ids))
            stream = gather_rows(table, ids, rows_per_step=1)
            rows.append(time_stream_sum(torch, timer, shape, stream,
                                        plan.row_ptr(side),
                                        plan.partition(side, F)))
            del stream
        del table
    return rows


def small_kernel_rows(torch, timer, dev, arch, g, table, F, seed):
    """Both graph kernels at ``arch``'s own widths on its plan: the node
    gather of ``table`` over every lane (PNA: the 602 input features,
    ``block_gather``'s two-float rows; EGNN: the 3 coordinates;
    Equiformer-v2: z at K·C = 6272), then messages at width ``F`` (PNA's 75,
    EGNN's position update's 3, Equiformer-v2's 6272) gathered into
    destination order and summed by destination (a sum's or mean's
    forward), and gradients gathered into source order and summed by source
    (a node gather's backward)."""
    from repro_torch.kernels.block_gather.ops import gather_rows
    plan = g.plan
    rows = [time_stream_gather(torch, timer,
                               f"{arch} node F={table.shape[1]}", table,
                               plan.src)]
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    msgs = torch.randn((plan.src.numel(), F), generator=gen, device=dev)
    for way, side in (("fwd", "dst"), ("bwd", "src")):
        shape = f"{arch} {way} F={F}"
        rows.append(time_stream_gather(torch, timer, shape, msgs,
                                       plan.order(side)))
        stream = gather_rows(msgs, plan.order(side), rows_per_step=1)
        rows.append(time_stream_sum(torch, timer, shape, stream,
                                    plan.row_ptr(side),
                                    plan.partition(side, F)))
        del stream
    return rows


def supervised_run(torch, timer, batches, params, loss_fn, opt_cfg, dev,
                   kernels=GRAPH_KERNELS, snapshot_device=None, layout=None,
                   ckpt_dir=None):
    """``TRAIN_STEPS`` steps of launch/train.py's step over ``batches(step)``
    under ``TrainSupervisor`` (a checkpoint every ``TRAIN_CKPT_EVERY`` in
    ``layout``, one failure injected at ``TRAIN_FAIL_AT``), every launch
    counter at 0.
    Records each call's step, wall time and loss, the state a restart
    resumes from (held against a copy of the step-10 state kept on
    ``snapshot_device``, the card by default), any exception out of the
    step itself and the launches of ``kernels``.  The checkpoints go to a
    temporary directory, or to ``ckpt_dir``, which the caller removes."""
    import contextlib
    import tempfile
    from repro_torch import backend
    from repro_torch import tree as T
    from repro_torch.launch.train import make_step
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime import (FailureInjector, StragglerPolicy,
                                     TrainSupervisor)
    step_fn = make_step(loss_fn, opt_cfg, TRAIN_STEPS)
    rec = dict(steps=[], seconds=[], losses=[], step_errors=[],
               restart_equals_checkpoint=None)
    snap = {}

    def recorded(s):
        rec["steps"].append(s)
        return batches(s)

    def wrapped(state, batch):
        s = rec["steps"][-1]
        if len(rec["steps"]) > 1 and s <= rec["steps"][-2] \
                and "state" in snap:
            # the supervisor restored a checkpoint: it must be the state
            # after step TRAIN_CKPT_EVERY, bit for bit
            rec["restart_equals_checkpoint"] = all(
                torch.equal(a.to(b.device), b)
                for a, b in zip(T.leaves(state), snap["state"]))
        try:
            (state, metrics), sec = timer.wall(lambda: step_fn(state, batch))
        except RuntimeError as e:            # a fault, not an injection
            rec["step_errors"].append(repr(e))
            raise
        rec["seconds"].append(sec)
        rec["losses"].append(float(metrics["loss"]))
        if s + 1 == TRAIN_CKPT_EVERY and "state" not in snap:
            snap["state"] = [x.to(snapshot_device or x.device, copy=True)
                             for x in T.leaves(state)]
        return state, metrics

    with (contextlib.nullcontext(ckpt_dir) if ckpt_dir else
          tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")) as ckpt_dir:
        sup = TrainSupervisor(ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
                              injector=FailureInjector([TRAIN_FAIL_AT]),
                              straggler=StragglerPolicy(), device=dev,
                              layout=layout)
        # the first state is held by the supervisor alone, so a step's
        # update frees it as the model's later states are freed
        first = [(params, init_opt_state(params, opt_cfg))]
        del params
        backend.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, run_s = timer.wall(lambda: sup.run(first.pop(), recorded,
                                                  TRAIN_STEPS, wrapped))
        rec["launches"] = {k: backend.LAUNCHES[k] for k in kernels}
        rec["checkpoint_write_seconds"] = list(sup.ckpt.write_seconds)
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        rec["run_seconds"] = run_s
        rec["report"] = dataclasses.asdict(sup.report)
    return state, step_fn, rec


def supervised_summary(rec) -> dict:
    """The numbers of a :func:`supervised_run` a report keeps."""
    secs = rec["seconds"]
    rest = sorted(secs[1:])
    return dict(
        steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        fail_at=TRAIN_FAIL_AT, supervisor=rec["report"], calls=rec["steps"],
        step_ms_first=secs[0] * 1e3,
        step_ms_median=rest[len(rest) // 2] * 1e3,
        step_ms_max=rest[-1] * 1e3, run_seconds=rec["run_seconds"],
        loss_first=rec["losses"][0], loss_last=rec["losses"][-1],
        losses=rec["losses"], launches=rec["launches"],
        restart_equals_checkpoint=rec["restart_equals_checkpoint"],
        step_errors=rec["step_errors"],
        max_memory_allocated=rec["max_memory_allocated"])


def check_supervised(arch, rec, want) -> None:
    """A supervised run's checks: no exception out of the step, exactly
    the 1 injected failure recovered, a checkpoint every
    ``TRAIN_CKPT_EVERY`` steps, the restart state bit for bit the step-10
    state, the loss falling, and ``want[kernel]`` launches of each counted
    kernel per step run."""
    r = rec["report"]
    check(not rec["step_errors"], f"the {arch} training step raised: "
          f"{rec['step_errors']}")
    check(r["failures_recovered"] == 1,
          f"{arch}: the supervisor recovered {r['failures_recovered']} "
          f"failures, not the 1 injected")
    check(r["checkpoints_written"] == TRAIN_STEPS // TRAIN_CKPT_EVERY,
          f"{arch}: {r['checkpoints_written']} checkpoints written, not "
          f"{TRAIN_STEPS // TRAIN_CKPT_EVERY}")
    check(rec["restart_equals_checkpoint"] is True,
          f"{arch}: the state after the restart is not the step-"
          f"{TRAIN_CKPT_EVERY} checkpoint's, bit for bit")
    check(all(map(math.isfinite, rec["losses"]))
          and rec["losses"][-1] < rec["losses"][0],
          f"{arch}: the loss did not fall ({rec['losses'][0]} -> "
          f"{rec['losses'][-1]})")
    for name, n in want.items():
        check(rec["launches"][name] == n * r["steps_run"],
              f"{arch}: {name} launched {rec['launches'][name]} times in "
              f"{r['steps_run']} steps, not {n * r['steps_run']}")


def short_run(torch, timer, loss_fn, params, batch, steps, want, arch,
              lr=1e-3):
    """``steps`` plain steps of launch/train.py's step (no supervisor) on
    one batch with the launch counters at 0: the loss must fall and each
    kernel of ``want`` launch exactly ``want[kernel]`` times a step."""
    from repro_torch import backend
    from repro_torch.launch.train import make_step
    from repro_torch.optim import AdamWConfig, init_opt_state
    opt_cfg = AdamWConfig(lr=lr)
    step_fn = make_step(loss_fn, opt_cfg, steps)
    state = (params, init_opt_state(params, opt_cfg))
    backend.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(steps):
        (state, metrics), sec = timer.wall(lambda: step_fn(state, batch))
        losses.append(float(metrics["loss"]))
        secs.append(sec)
    out = dict(loss_first=losses[0], loss_last=losses[-1],
               step_ms_first=secs[0] * 1e3,
               step_ms_median=1e3 * sorted(secs[1:])[len(secs[1:]) // 2],
               launches={k: backend.LAUNCHES[k] for k in want},
               max_memory_allocated=torch.cuda.max_memory_allocated())
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{arch}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    for name, n in out["launches"].items():
        check(n == want[name] * steps,
              f"{arch}: {name} launched {n} times in {steps} steps, not "
              f"{want[name] * steps}")
    return out


def small_gnn_run(torch, timer, dev, arch, seed):
    """``arch`` (pna, egnn) at its full config on the minibatch_lg shape:
    the kernel route against ``impl="torch"`` on the batch,
    ``SMALL_TRAIN_STEPS`` steps with every launch counter at 0, and both
    kernels at the model's own widths (:func:`small_kernel_rows`)."""
    import importlib
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.launch.train import ARCH_MODULES, GNN_MODEL_MODULES
    m = importlib.import_module(ARCH_MODULES[arch])
    mod = importlib.import_module(GNN_MODEL_MODULES[m.MODULE])
    _, _, d_feat, n_cls, _, _ = GNN_SHAPES["minibatch_lg"]
    cfg = m.full_config(d_in=d_feat, n_classes=n_cls)
    g, live = gnn_batch(torch, "minibatch_lg", MINIBATCH_LG_LIVE, seed, dev,
                        m.NEEDS_POS)
    g = g.with_plan()
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    params = mod.init_params(cfg, gen, device=dev)
    want = SMALL_LAUNCHES_PER_STEP[arch]
    loss_fn = (lambda p, b, impl="cuda":                      # noqa: E731
               mod.loss_fn(p, cfg, b, impl))
    routes = route_agreement(torch, timer, arch, loss_fn, params, g, want,
                             float64_floor=arch in TRAIN_FLOAT64_FLOOR)
    out = dict(arch=arch, config=cfg.name, shape="minibatch_lg",
               nodes=g.num_nodes, live_edges=live, d_in=cfg.d_in,
               layers=cfg.n_layers, d_hidden=cfg.d_hidden)
    out.update(short_run(torch, timer, loss_fn, params, g,
                         SMALL_TRAIN_STEPS, want, arch))
    say(f"train.{arch}", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                            for k, v in out.items()})
    out["routes"] = routes
    out["kernels"] = small_kernel_rows(
        torch, timer, dev, arch, g, g.x if arch == "pna" else g.pos,
        cfg.d_hidden if arch == "pna" else 3, seed)
    return out


def train_phase(torch, timer, dev, seed, report, profile=False) -> None:
    """Phase 8: GIN-TU at ogb_products size through launch/train.py's step
    under the supervisor, the kernel route against ``impl="torch"`` on the
    first batch, PNA and EGNN at minibatch_lg, and both graph kernels at
    the aggregation's shapes."""
    import tempfile
    from repro_torch import tree as T
    from repro_torch.checkpoint import save
    from repro_torch.configs.gin_tu import full_config
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.models.gnn import gin
    from repro_torch.optim import AdamWConfig

    n_cap, e_cap, d_feat, n_cls, _, _ = GNN_SHAPES["ogb_products"]
    cfg = full_config(d_in=d_feat, n_classes=n_cls)
    (g, live), gen_s = timer.wall(lambda: gnn_batch(
        torch, "ogb_products", OGB_PRODUCTS_LIVE, seed + 23, dev, False))
    g, plan_s = timer.wall(g.with_plan)
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    params = gin.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in T.leaves(params))
    out = report["train"] = dict(
        config=cfg.name, shape="ogb_products", nodes=n_cap,
        live_nodes=OGB_PRODUCTS_LIVE[0], edge_capacity=e_cap,
        live_edges_asked=OGB_PRODUCTS_LIVE[1], live_edges=live,
        plan_edges=g.plan.num_valid, d_in=cfg.d_in, layers=cfg.n_layers,
        d_hidden=cfg.d_hidden, classes=cfg.n_classes, params=n_params,
        rmat_seconds=gen_s, plan_build_seconds=plan_s)
    say("train.setup", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                          for k, v in out.items()})

    # the kernel route against impl="torch" on the first batch
    loss_fn = (lambda p, b, impl="cuda":                      # noqa: E731
               gin.loss_fn(p, cfg, b, impl))
    out.update(route_agreement(
        torch, timer, "gin-tu", loss_fn, params, g,
        dict.fromkeys(GRAPH_KERNELS, TRAIN_LAUNCHES_PER_STEP)))
    gc.collect()
    torch.cuda.empty_cache()

    # the supervised run
    opt_cfg = AdamWConfig(lr=1e-3)
    state, step_fn, rec = supervised_run(torch, timer, lambda s: g, params,
                                         loss_fn, opt_cfg, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_save_") as d:
        path, save_s = timer.wall(lambda: save(d, TRAIN_STEPS, state))
        ckpt_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
    out.update(supervised_summary(rec), checkpoint_bytes=ckpt_bytes,
               checkpoint_write_seconds=save_s)
    say("train.gin", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in out.items()
                        if k.startswith(("step_ms", "loss_f", "loss_l",
                                         "run_s", "supervisor", "launches",
                                         "restart", "checkpoint", "max_mem",
                                         "step_errors"))})
    check_supervised("gin-tu", rec, dict.fromkeys(GRAPH_KERNELS,
                                                  TRAIN_LAUNCHES_PER_STEP))
    if profile:
        _, out["profile_step"] = profiled(torch, lambda: step_fn(state, g))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    report["train_kernels"] = train_kernel_rows(torch, timer, dev, g, seed)
    del g
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = []
    for arch in ("pna", "egnn"):
        out["small"].append(small_gnn_run(torch, timer, dev, arch, seed))
        report["train_kernels"] += out["small"][-1].pop("kernels")
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Equiformer-v2 at the molecule cell, SASRec at train_batch
# ---------------------------------------------------------------------------

def molecule_batch(torch, seed, dev):
    """``GNN_SHAPES["molecule"]``: 128 graphs of 30 atoms (3,840 live nodes
    padded to 4,096), positions N(0, 1.5^2) per axis, each graph's 64 edges
    its 32 closest atom pairs in both directions (no self-loop), 64 random
    features, one float32 target a graph, all made on the device from
    ``seed``; the edge plan built once."""
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.models.gnn.common import GraphBatch
    n_cap, e_cap, d_feat, _, _, n_graphs = GNN_SHAPES["molecule"]
    A = MOLECULE_ATOMS
    n_live, pairs = n_graphs * A, e_cap // n_graphs // 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = 1.5 * torch.randn((n_graphs, A, 3), generator=gen, device=dev)
    iu = torch.triu_indices(A, A, 1, device=dev)                # [2, 435]
    d2 = ((pos[:, iu[0]] - pos[:, iu[1]]) ** 2).sum(-1)         # [G, 435]
    near = d2.topk(pairs, largest=False).indices                # [G, 32]
    base = (torch.arange(n_graphs, device=dev) * A)[:, None]
    i, j = iu[0][near] + base, iu[1][near] + base
    src = torch.cat([i, j], 1).reshape(-1).to(torch.int32)
    dst = torch.cat([j, i], 1).reshape(-1).to(torch.int32)
    node = torch.arange(n_cap, device=dev)
    g = GraphBatch(
        x=torch.randn((n_cap, d_feat), generator=gen, device=dev),
        edge_src=src, edge_dst=dst,
        edge_valid=torch.ones(e_cap, dtype=torch.bool, device=dev),
        node_valid=node < n_live,
        graph_id=torch.where(node < n_live, node // A, 0).to(torch.int32),
        pos=torch.cat([pos.reshape(n_live, 3),
                       pos.new_zeros((n_cap - n_live, 3))]),
        labels=torch.randn((n_graphs,), generator=gen, device=dev))
    check(src.numel() == e_cap and not bool((src == dst).any()),
          "molecule batch: wrong edge count or a self-loop")
    return g.with_plan()


def equiformer_launches(n_layers: int) -> dict:
    """A step of Equiformer-v2 at ``n_layers`` layers.  Forward: the
    positions at both ends (once), then per layer z[src] and the message
    sum (a gather into destination order and a sum); backward per layer the
    sum's gather at each lane's destination and z[src]'s sum by source (a
    gather into source order and a sum).  The positions take no gradient:
    block_gather 2 + 4L, segment_sum 2L."""
    return {"segment_sum": 2 * n_layers, "block_gather": 2 + 4 * n_layers}


def equiformer_run(torch, timer, dev, seed, profile):
    """Equiformer-v2 at ``full_config(d_in=64, n_classes=1,
    graph_level=True)`` on the molecule batch: the kernel route against
    ``impl="torch"``, the supervised run, the registry's ``opt`` variant
    for ``TRAIN_STEPS`` steps and both graph kernels at K·C = 6272."""
    from repro_torch import tree as T
    from repro_torch.configs.equiformer_v2 import full_config
    from repro_torch.configs.gnn_common import GNN_SHAPES
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.optim import AdamWConfig
    _, _, d_feat, _, _, n_graphs = GNN_SHAPES["molecule"]
    cfg = full_config(d_in=d_feat, n_classes=1, graph_level=True)
    g, batch_s = timer.wall(lambda: molecule_batch(torch, seed + 37, dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    params = EQ.init_params(cfg, gen, device=dev)
    want = equiformer_launches(cfg.n_layers)
    out = dict(config=cfg.name, shape="molecule", nodes=g.num_nodes,
               live_nodes=int(g.node_valid.sum()), graphs=n_graphs,
               edges=g.edge_src.numel(), layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, l_max=cfg.l_max, m_max=cfg.m_max,
               heads=cfg.n_heads, edge_tensor_bytes=(
                   g.edge_src.numel() * cfg.n_comps * cfg.d_hidden * 4),
               params=sum(p.numel() for p in T.leaves(params)),
               batch_and_plan_seconds=batch_s)
    say("mtrain.eq_setup", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                              for k, v in out.items()})
    loss_fn = (lambda p, b, impl="cuda":                      # noqa: E731
               EQ.loss_fn(p, cfg, b, impl))
    out["routes"] = route_agreement(torch, timer, "equiformer-v2", loss_fn,
                                    params, g, want)
    gc.collect()
    torch.cuda.empty_cache()
    state, step_fn, rec = supervised_run(
        torch, timer, lambda s: g, params, loss_fn,
        AdamWConfig(lr=EQUIFORMER_LR), dev, tuple(want))
    out.update(supervised_summary(rec))
    say("mtrain.equiformer", **{
        k: (f"{v:.4g}" if isinstance(v, float) else v)
        for k, v in out.items() if k.startswith((
            "step_ms", "loss_f", "loss_l", "run_s", "supervisor", "launches",
            "restart", "max_mem", "step_errors"))})
    check_supervised("equiformer-v2", rec, want)
    if profile:
        _, out["profile_step"] = profiled(torch, lambda: step_fn(state, g))
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    ocfg = dataclasses.replace(cfg, truncate_rotation=True, edge_bf16=True)
    out["opt"] = dict(truncate_rotation=True, edge_bf16=True, **short_run(
        torch, timer, lambda p, b: EQ.loss_fn(p, ocfg, b), params, g,
        TRAIN_STEPS, want, "equiformer-v2 opt", EQUIFORMER_LR))
    say("mtrain.equiformer_opt", **{
        k: (f"{v:.4g}" if isinstance(v, float) else v)
        for k, v in out["opt"].items()})
    gc.collect()
    torch.cuda.empty_cache()
    F = cfg.n_comps * cfg.d_hidden
    z = torch.randn((g.num_nodes, F), generator=gen, device=dev)
    out["kernels"] = small_kernel_rows(torch, timer, dev, "equiformer", g, z,
                                       F, seed)
    return out


def sasrec_train_run(torch, timer, dev, seed, profile):
    """SASRec at ``full_config()`` (2^20-row table) on
    ``RECSYS_SHAPES["train_batch"]`` (65,536 users x 50): the kernel route
    against ``impl="torch"`` on the first batch, the supervised run over
    ``SASREC_TRAIN_CACHE`` cached batches of ``sasrec_batches`` on the
    device (each with its lookup plan), and the three kernels at the
    lookup's shapes."""
    from repro_torch.configs.sasrec import RECSYS_SHAPES, full_config
    from repro_torch.data.synthetic import sasrec_batches
    from repro_torch.kernels.block_gather.ops import gather_rows
    from repro_torch.models.recsys import sasrec as S
    from repro_torch.optim import AdamWConfig
    cfg = full_config()
    B, V, d = RECSYS_SHAPES["train_batch"]["batch"], cfg.n_items + 1, \
        cfg.embed_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    params = S.init_params(cfg, gen, device=dev)
    stream = sasrec_batches(cfg.n_items, B, cfg.seq_len, seed=seed + 47,
                            device=dev)

    def make():
        seq, pos, neg = next(stream)
        return S.TrainBatch(seq, pos, neg, S.lookup_plan(seq, pos, neg, V))

    first, plan_s = timer.wall(make)
    cache = [first] + [make() for _ in range(SASREC_TRAIN_CACHE - 1)]
    out = dict(config=cfg.name, shape="train_batch", users=B,
               seq_len=cfg.seq_len, table_rows=V, embed_dim=d,
               lanes=3 * B * cfg.seq_len, plan_lanes=first.plan.num_valid,
               batch_and_plan_seconds=plan_s)
    say("mtrain.sas_setup", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                               for k, v in out.items()})
    loss_fn = (lambda p, b, impl="cuda":                      # noqa: E731
               S.loss_fn(p, cfg, b.seq, b.pos, b.neg, impl=impl,
                         plan=b.plan))
    out["routes"] = route_agreement(torch, timer, "sasrec", loss_fn, params,
                                    first, SASREC_LAUNCHES_PER_STEP)
    gc.collect()
    torch.cuda.empty_cache()
    state, step_fn, rec = supervised_run(
        torch, timer, lambda s: cache[s % len(cache)], params, loss_fn,
        AdamWConfig(lr=1e-3), dev, tuple(SASREC_LAUNCHES_PER_STEP))
    out.update(supervised_summary(rec))
    say("mtrain.sasrec", **{
        k: (f"{v:.4g}" if isinstance(v, float) else v)
        for k, v in out.items() if k.startswith((
            "step_ms", "loss_f", "loss_l", "run_s", "supervisor", "launches",
            "restart", "max_mem", "step_errors"))})
    check_supervised("sasrec", rec, SASREC_LAUNCHES_PER_STEP)
    if profile:
        _, out["profile_step"] = profiled(
            torch, lambda: step_fn(state, first))
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at the lookup's shapes: the history's one-slot bags, the
    # positives and negatives, the lanes' gradients into id order and their
    # sum by id
    table, plan = params["item_emb"], first.plan
    n = B * cfg.seq_len
    rows = [time_embedding_bag(torch, timer, "sasrec fwd lookup", table,
                               plan.dst[:n].reshape(n, 1), d ** 0.5),
            time_stream_gather(torch, timer, f"sasrec fwd pos|neg F={d}",
                               table, plan.dst[n:])]
    lanes = torch.randn((3 * n, d), generator=gen, device=dev)
    rows.append(time_stream_gather(torch, timer, f"sasrec bwd F={d}", lanes,
                                   plan.dst_order))
    stream = gather_rows(lanes, plan.dst_order, rows_per_step=1)
    rows.append(time_stream_sum(torch, timer, f"sasrec bwd F={d}", stream,
                                plan.dst_row_ptr, plan.partition("dst", d)))
    out["kernels"] = rows
    return out


def model_train_phase(torch, timer, dev, seed, report,
                      profile=False) -> None:
    """Phase 9: Equiformer-v2 at the molecule cell and SASRec at
    train_batch through launch/train.py's step under the supervisor, each
    kernel route against ``impl="torch"``, and the kernels at this path's
    shapes (``model_train_kernels``)."""
    out = report["model_train"] = {}
    out["equiformer"] = equiformer_run(torch, timer, dev, seed, profile)
    report["model_train_kernels"] = out["equiformer"].pop("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    out["sasrec"] = sasrec_train_run(torch, timer, dev, seed, profile)
    report["model_train_kernels"] += out["sasrec"].pop("kernels")


# ---------------------------------------------------------------------------
# LM training: qwen3-moe at full width, the MoE on the graph kernels
# ---------------------------------------------------------------------------

def moe_kernel_rows(torch, timer, dev, p0, cfg, T, tag, seed,
                    backward=None):
    """Both graph kernels at an MoE call's shapes over the token plan that
    router ``p0`` gives T random bf16 token rows (K lanes a token, C =
    ``capacity(cfg, T)`` slots an expert): the dispatch (the E·C bucket
    rows gathered from the token rows, bf16 as float32 pairs), the
    combine's gather (the T·K lanes from the buckets; the dispatch's
    backward has its shape) and its sum by token at F = d_model (the
    dispatch's backward sum too); with ``backward`` (that row's name) the
    combine's backward (float32 token gradients into the buckets).  Rows
    ``{tag} dispatch``, ``{tag} combine`` (bf16: the gather; float32: the
    sum)."""
    from repro_torch.models.transformer import layers as L
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    xt = torch.randn((T, d), generator=gen, device=dev, dtype=cfg.dtype)
    _, eidx, _ = L.route(p0, cfg, xt.float())
    plan = L.token_plan(eidx, L.capacity(cfg, T), cfg.n_experts)
    n_slots = plan.E * plan.C

    def pairs(rows):               # a bf16 table and its zero row, as f32
        return torch.cat([rows, rows.new_zeros((1, d))]).view(torch.float32)

    yb = torch.randn((n_slots, d), generator=gen, device=dev,
                     dtype=cfg.dtype)
    rows = [time_stream_gather(torch, timer, f"{tag} dispatch F={d} bf16",
                               pairs(xt), plan.tok_of_slot),
            time_stream_gather(torch, timer, f"{tag} combine F={d} bf16",
                               pairs(yb), plan.slot_of_lane)]
    if backward:
        grad_y = torch.randn((T, d), generator=gen, device=dev)
        rows.append(time_stream_gather(
            torch, timer, backward,
            torch.cat([grad_y, grad_y.new_zeros((1, d))]), plan.tok_of_slot))
        del grad_y
    lanes = L._rows(yb, plan.slot_of_lane).float()
    del yb
    rows.append(time_stream_sum(torch, timer, f"{tag} combine F={d}",
                                lanes, plan.row_ptr, plan.partition(d)))
    for r in rows:
        r.update(tokens=T, slots=n_slots, capacity=plan.C,
                 kept_lanes=int(plan.keep.sum()))
    return rows


def lm_kernel_rows(torch, timer, dev, params, cfg, seed):
    """Both graph kernels at the MoE's training shapes over a token plan of
    layer 0's router (T = 4,096 tokens, K = 8, C = 321): the dispatch
    (41,088 bucket rows from the 4,096 token rows), the combine's gather
    (32,768 lanes) and its sum by token at F = 2048, and the combine's
    backward (``moe_kernel_rows``)."""
    return moe_kernel_rows(torch, timer, dev, params["layers"][0]["moe"],
                           cfg, LM_TRAIN_SEQ, "lm fwd", seed + 61,
                           backward="lm bwd combine F=2048")


def lm_train_phase(torch, timer, dev, seed, report, ckpt_dir,
                   profile=False) -> None:
    """Phase 10: qwen3-moe-30b-a3b at full width, 2 of its 48 layers, one
    4,096-token sequence a step through launch/train.py's step: the kernel
    route against ``impl="torch"``, 20 supervised steps (their checkpoints
    in ``ckpt_dir``, which phase 11 reads), and both graph kernels at the
    MoE's shapes (``lm_train_kernels``)."""
    from repro_torch import tree as T
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.interop import lm_checkpoint_layout
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.layers import capacity
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(full_config(), n_layers=LM_TRAIN_LAYERS)
    params, init_s = timer.wall(lambda: M.init_params(cfg, seed + 53,
                                                      device=dev))
    stream = token_stream(cfg.vocab, 1, LM_TRAIN_SEQ, seed=seed + 59,
                          device=dev)
    cache, batch_s = timer.wall(lambda: [next(stream)
                                         for _ in range(LM_TRAIN_CACHE)])
    n_params = M.param_count(params)
    want = lm_train_launches(cfg.n_layers)
    out = report["lm_train"] = dict(
        config=cfg.name, shape="train_4k", layers=cfg.n_layers,
        full_layers=full_config().n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        experts=cfg.n_experts, top_k=cfg.top_k, expert_d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype=str(cfg.dtype), seq=LM_TRAIN_SEQ,
        sequences_a_step=1, capacity=capacity(cfg, LM_TRAIN_SEQ),
        params=n_params, init_seconds=init_s, batch_seconds=batch_s)
    say("lmtrain.setup", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                            for k, v in out.items()})

    loss_fn = (lambda p, b, impl="cuda":                      # noqa: E731
               M.loss_fn(p, cfg, b[0], b[1], impl))
    out["routes"] = route_agreement(
        torch, timer, cfg.name, loss_fn, params, cache[0], want,
        loss_rtol=LM_TRAIN_LOSS_RTOL, grad_rtol=LM_TRAIN_GRAD_RTOL,
        grad_atol=0.0)
    gc.collect()
    torch.cuda.empty_cache()

    # the run holds the only reference to the first parameters (31 GB of
    # state with their moments), so each step's update frees the last
    first = [params]
    del params
    # checkpoints in the JAX package's tree, as launch/train.py writes an
    # LM's: the layers stacked by period on the host copy
    state, step_fn, rec = supervised_run(
        torch, timer, lambda s: cache[s % len(cache)], first.pop(), loss_fn,
        AdamWConfig(lr=1e-3), dev, tuple(want), snapshot_device="cpu",
        layout=lm_checkpoint_layout(cfg.period), ckpt_dir=ckpt_dir)
    gc.collect()
    torch.cuda.empty_cache()
    # the run's own checkpoints give the write times: one more write of the
    # state would take the call past the disk it may write
    out.update(supervised_summary(rec), checkpoint_bytes=sum(
        x.numel() * x.element_size() for x in T.leaves(state)),
        checkpoint_write_seconds=rec["checkpoint_write_seconds"])
    say("lmtrain.qwen3_moe", **{
        k: (f"{v:.4g}" if isinstance(v, float) else v)
        for k, v in out.items() if k.startswith((
            "step_ms", "loss_f", "loss_l", "run_s", "supervisor", "launches",
            "restart", "checkpoint", "max_mem", "step_errors"))})
    check_supervised(cfg.name, rec, want)
    if profile:
        _, out["profile_step"] = profiled(
            torch, lambda: step_fn(state, cache[0]))
    params = state[0]
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    report["lm_train_kernels"] = lm_kernel_rows(torch, timer, dev, params,
                                                cfg, seed)


# ---------------------------------------------------------------------------
# phase 11: the mesh modules (dry run, compression, the elastic reshard)
# ---------------------------------------------------------------------------

def dryrun_cells(report) -> None:
    """(a) ``launch.dryrun`` on the host for ``DRYRUN_CELLS``, both meshes,
    under the fake process group it sets up and destroys."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    argv = ["--mesh", "both", "--force", "--out", str(out_dir)]
    rows, t0 = [], time.perf_counter()
    for arch, shape, opt in DRYRUN_CELLS:
        try:
            recs = dryrun.main(["--arch", arch, "--shape", shape] + argv
                               + (["--opt"] if opt else []))
        except SystemExit:           # its failures are printed above
            raise SmokeFailure(f"dryrun {arch} {shape} failed") from None
        for rec in recs:
            check(rec["flops_per_step"] and rec["flops_per_step"] > 0
                  and rec["flops_error"] is None,
                  f"dryrun {arch} {shape}: FLOPs {rec['flops_per_step']}, "
                  f"{rec['flops_error']}")
            check(rec["argument_bytes_per_device"] > 0
                  and rec["output_bytes_per_device"] > 0,
                  f"dryrun {arch} {shape}: no bytes")
            # an opt cell's step runs on DTensors: its collectives counted
            # by kind, each above 0; a plain step's are null, never 0
            coll = rec["collective_bytes"]
            check((bool(coll) and all(n > 0 for n in coll.values())) if opt
                  else coll is None,
                  f"dryrun {arch} {shape}: collective bytes {coll}")
            row = dict(cell=f"{arch} {shape}" + (" opt" if opt else ""),
                       mesh=rec["mesh"], collective_bytes=coll,
                       n_devices=rec["n_devices"],
                       argument_bytes_per_device=rec[
                           "argument_bytes_per_device"],
                       output_bytes_per_device=rec["output_bytes_per_device"],
                       gflop_per_step=rec["flops_per_step"] / 1e9,
                       fits_h100_80gb=rec["argument_bytes_fit_h100_80gb"],
                       step_on_meta_s=rec["timing"]["step_on_meta_s"])
            rows.append(row)
            say("mesh.dryrun", **{k: (f"{v:.6g}" if isinstance(v, float)
                                      else v) for k, v in row.items()})
    check(not dist.is_initialized(), "dryrun left its process group")
    report["mesh"]["dryrun"] = dict(cells=rows,
                                    seconds=time.perf_counter() - t0)


def compress_checks(torch, timer, dev, seed, report) -> None:
    """(b) the compressors at the LM-train cell's widest gradient leaf."""
    from repro_torch.optim import (ErrorFeedback, int8_compress,
                                   int8_decompress, topk_compress,
                                   topk_decompress)
    gen = torch.Generator(device=dev).manual_seed(seed + 67)
    g = torch.randn(COMPRESS_SHAPE, generator=gen, device=dev)
    n = g.numel()
    out = report["mesh"]["compress"] = dict(
        shape=list(COMPRESS_SHAPE), values=n, k_frac=COMPRESS_K_FRAC,
        rounds=COMPRESS_ROUNDS, source="N(0, 1) from --seed (phase 10 "
        "keeps no gradient)")

    # R rounds of top-k with error feedback: sent + residual = R g
    ef, sent = None, torch.zeros(n, device=dev)
    for _ in range(COMPRESS_ROUNDS):
        vals, idx, ef = topk_compress(g, COMPRESS_K_FRAC, ef)
        sent.index_add_(0, idx.long(), vals)
    k = vals.numel()
    err = ((sent + ef.residual) - COMPRESS_ROUNDS * g.reshape(-1)).abs()
    bound = COMPRESS_ULPS * 2.0 ** -24 * g.reshape(-1).abs()
    out.update(k=k, ef_max_err=float(err.max()),
               ef_worst_over_bound=float((err / bound.clamp(
                   min=1e-30)).max()))
    check(bool((err <= bound).all()),
          f"top-k with error feedback: sent + residual off 20 g by "
          f"{out['ef_max_err']:.3g} (the float32 bound is "
          f"{COMPRESS_ULPS} ulps of |g|)")
    del sent, err, bound

    # the card's top-k against the host's on distinct magnitudes
    sgen = torch.Generator(device=dev).manual_seed(seed + 71)
    mag = (torch.randperm(COMPRESS_CHECK_VALUES, generator=sgen,
                          device=dev) + 1).float()
    sign = torch.randint(0, 2, (COMPRESS_CHECK_VALUES,), generator=sgen,
                         device=dev).float() * 2 - 1
    # |m 2^-10 +- 2^-12| over distinct integers m: distinct and exact
    part = mag * sign * 2.0 ** -10
    res = (torch.randint(0, 2, (COMPRESS_CHECK_VALUES,), generator=sgen,
                         device=dev).float() * 2 - 1) * 2.0 ** -12
    got = topk_compress(part, COMPRESS_K_FRAC, ErrorFeedback(res))
    ref = topk_compress(part.cpu(), COMPRESS_K_FRAC,
                        ErrorFeedback(res.cpu()))
    check(torch.unique((part + res).abs()).numel() == COMPRESS_CHECK_VALUES,
          "top-k check slice: magnitudes not distinct")
    check(torch.equal(got[1].cpu(), ref[1])
          and torch.equal(got[0].cpu(), ref[0])
          and torch.equal(got[2].residual.cpu(), ref[2].residual),
          "top-k on the card differs from the host's")

    # int8 over INT8_DRAWS draws: the mean's error and its RMS
    igen = torch.Generator(device=dev).manual_seed(seed + 73)
    acc = torch.zeros_like(g)
    for _ in range(INT8_DRAWS):
        q, scale = int8_compress(g, igen)
        acc += int8_decompress(q, scale)
    mean_err = acc / INT8_DRAWS - g
    scale = float(scale)
    hoeffding = scale * math.sqrt(math.log(2 * n / INT8_DELTA)
                                  / (2 * INT8_DRAWS))
    rms_bound = scale / (2 * math.sqrt(INT8_DRAWS))
    out.update(int8_draws=INT8_DRAWS, int8_scale=scale,
               int8_mean_max_err=float(mean_err.abs().max()),
               int8_mean_err_bound=hoeffding,
               int8_mean_rms=float(mean_err.square().mean().sqrt()),
               int8_rms_bound=rms_bound)
    check(out["int8_mean_max_err"] <= hoeffding,
          f"int8: the mean of {INT8_DRAWS} draws is off by "
          f"{out['int8_mean_max_err']:.4g} > {hoeffding:.4g}")
    check(out["int8_mean_rms"] <= INT8_RMS_MARGIN * rms_bound,
          f"int8: the mean's RMS error {out['int8_mean_rms']:.4g} > "
          f"{rms_bound:.4g}")
    del acc, mean_err

    # the four calls timed beside their bytes bounds: top-k reads g and the
    # residual and writes the residual and k (value, index) pairs;
    # decompress writes n values from k pairs; int8 reads g and writes n
    # codes (its noise made in place); int8_decompress the reverse
    ef0 = ErrorFeedback(ef.residual)
    vals, idx, _ = topk_compress(g, COMPRESS_K_FRAC, ef0)
    q, s = int8_compress(g, igen)
    calls = {
        "topk_compress": (lambda: topk_compress(g, COMPRESS_K_FRAC, ef0),
                          3 * 4 * n + 8 * k),
        "topk_decompress": (lambda: topk_decompress(vals, idx,
                                                    COMPRESS_SHAPE),
                            4 * n + 8 * k),
        "int8_compress": (lambda: int8_compress(g, igen), 4 * n + n),
        "int8_decompress": (lambda: int8_decompress(q, s), n + 4 * n),
    }
    out["calls"] = {}
    for name, (fn, nbytes) in calls.items():
        ms = timer.ms(fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out["calls"][name] = dict(ms=ms, bytes=nbytes, bound_ms=bound,
                                  over_bound=ms / bound)
        say("mesh.compress", call=name, ms=f"{ms:.4g}",
            bound_ms=f"{bound:.4g}", bytes=nbytes)
    say("mesh.compress_checks", **{k: (f"{v:.6g}" if isinstance(v, float)
                                       else v) for k, v in out.items()
                                   if k != "calls"})


def elastic_reshard(torch, timer, dev, report, ckpt_dir) -> None:
    """(c) phase 10's last checkpoint, restored on the host and placed by
    ``reshard_state`` on the mesh of a one-device elastic plan over a
    one-rank NCCL group.  On one rank every placement is trivial: this
    drives the code path on the card (DTensor over NCCL, the cell's
    placements), not a layout."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as T
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.configs import registry
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    from repro_torch.distributed.sharding import shardings_for_cell
    from repro_torch.interop import lm_checkpoint_layout
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import model as M
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import (make_mesh_from_plan,
                                     plan_elastic_restart, reshard_state)

    cfg = dataclasses.replace(full_config(), n_layers=LM_TRAIN_LAYERS)
    params = M.init_params(cfg, device="meta")
    template = (params, init_opt_state(params, AdamWConfig()))
    step = latest_step(ckpt_dir)
    state, restore_s = timer.wall(lambda: restore(
        ckpt_dir, template, device="cpu",
        layout=lm_checkpoint_layout(cfg.period)))
    cell = registry.build_cell("qwen3-moe-30b-a3b", "train_4k")
    cell = cell._replace(cfg=cfg, arg_specs=template + cell.arg_specs[2:])

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        debug = make_debug_mesh((1, 1), device_type="cuda")
        plan = plan_elastic_restart(1, ELASTIC_GLOBAL_BATCH,
                                    model_parallel=1)
        mesh = make_mesh_from_plan(plan, device_type="cuda")
        shardings = shardings_for_cell(mesh, cell)[:2]
        placed, place_s = timer.wall(lambda: reshard_state(state,
                                                           shardings))
        leaves = T.leaves(placed)
        same, n_sharded = True, 0
        for x, ref, sh in zip(leaves, T.leaves(state), T.leaves(shardings)):
            check(isinstance(x, DTensor) and x.device_mesh == mesh
                  and tuple(x.placements) == sh.placements,
                  "reshard_state: a leaf off the mesh or its placements")
            n_sharded += any(p.is_shard() for p in x.placements)
            same &= torch.equal(x.full_tensor().cpu(), ref)
        nbytes = sum(x.numel() * x.element_size() for x in T.leaves(state))
        out = report["mesh"]["elastic"] = dict(
            debug_mesh=list(debug.shape), plan_mesh=list(plan.mesh_shape),
            per_host_batch=plan.per_host_batch, checkpoint_step=step,
            leaves=len(leaves), leaves_with_shard_placements=n_sharded,
            bytes=nbytes, restore_seconds=restore_s,
            reshard_seconds=place_s, bit_for_bit=bool(same))
        say("mesh.elastic", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                               for k, v in out.items()})
        check(same, "reshard_state changed a value of the restored state")
        del placed, leaves
    finally:
        dist.destroy_process_group()
    del state
    gc.collect()
    torch.cuda.empty_cache()


def mesh_phase(torch, timer, dev, seed, report, ckpt_dir) -> None:
    """Phase 11: the dry run on the host, compression on the card, and the
    elastic reshard of phase 10's checkpoint on a one-rank NCCL mesh."""
    report["mesh"] = {}
    dryrun_cells(report)
    compress_checks(torch, timer, dev, seed, report)
    gc.collect()
    torch.cuda.empty_cache()
    elastic_reshard(torch, timer, dev, report, ckpt_dir)


# ---------------------------------------------------------------------------
# phase 12: the expert-parallel MoE and the LM's steps on a DTensor mesh
# ---------------------------------------------------------------------------

def ep_config(model: int):
    """qwen3-moe-30b-a3b at full width, phase 10's 2 layers, with the
    ``opt`` cell's SPMD fields for a (data 1, model ``model``) mesh."""
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    return dataclasses.replace(
        full_config(), n_layers=LM_TRAIN_LAYERS, act_shard_axes=("data",),
        data_axis_size=1, model_axis_size=model, ep_shard_map=True)


def ep_one_card(cfg):
    """The config without its SPMD fields: the one-card path."""
    return dataclasses.replace(cfg, act_shard_axes=None, ep_shard_map=False)


def ep_place(mesh, cfg, params, opt_state, batch):
    """The state placed as DTensors by the qwen3-moe ``train_4k`` cell's
    shardings (``runtime.elastic.reshard_state``)."""
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import shardings_for_cell
    from repro_torch.runtime import reshard_state
    cell = registry.build_cell("qwen3-moe-30b-a3b", "train_4k")
    args = (params, opt_state, batch)
    cell = cell._replace(cfg=cfg, arg_specs=args)
    return reshard_state(args, shardings_for_cell(mesh, cell))


def ep_place_params(mesh, params):
    """The parameters alone placed by the LM rules (FSDP over "data")."""
    from repro_torch import tree as T
    from repro_torch.distributed.sharding import NamedSharding, lm_param_spec
    from repro_torch.runtime import reshard_state
    paths, leaves = T.flatten_with_paths(params)
    return reshard_state(params, T.unflatten(params, [
        NamedSharding(mesh, lm_param_spec(p, x.dim(), ("data",)))
        for p, x in zip(paths, leaves)]))


def moe_layer_inputs(torch, params, cfg, tokens, attn_impl):
    """Each layer's MoE input on the one-card path (the normed residual
    after attention) and the one-card ``apply_moe`` on it on the kernel
    route: ([(z, y)], the final hidden state at the last position, each
    layer's attention input, the normed residual)."""
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M
    out, attn_in, pos = [], [], M._positions(tokens)
    x = M.embed(params, cfg, tokens)
    for lp, window in zip(params["layers"], cfg.layer_windows):
        a = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        attn_in.append(a)
        h, _, _ = L.attention_with_kv(lp["attn"], cfg, a, pos, window,
                                      attn_impl)
        x = x + h
        z = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        y, _ = L.apply_moe(lp["moe"], cfg, z, "cuda")
        out.append((z, y))
        x = x + y
    return out, x[:, -1], attn_in


def combine_times(torch, mesh, rows: int, d: int) -> dict:
    """The combine's cross-rank step alone: a float32 [rows, d] partial,
    ``Partial()`` on ``"model"``, redistributed to a replica, host ms a
    call over COLLECTIVE_REPS synchronised calls, and its bytes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    part = DTensor.from_local(torch.rand((rows, d), device="cuda"), mesh,
                              [Replicate(), Partial()], run_check=False)
    whole = [Replicate(), Replicate()]
    part.redistribute(mesh, whole).to_local()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COLLECTIVE_REPS):
        part.redistribute(mesh, whole).to_local()
    torch.cuda.synchronize()
    return dict(combine_ms=(time.perf_counter() - t0) * 1e3
                / COLLECTIVE_REPS, combine_bytes=rows * d * 4)


def ep_train_leg(torch, timer, dev, seed, report) -> dict:
    """Leg (a): one NCCL rank in this process, ``make_debug_mesh((1, 1))``;
    the ``train_4k`` ``opt`` step (value and grads, clip, AdamW) on one
    4,096-token sequence for EP_TRAIN_STEPS steps, held to the one-card
    path."""
    import torch.distributed as dist

    from repro_torch import backend
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import token_stream
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_debug_mesh, use_mesh
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime import reshard_state
    from repro_torch.distributed.sharding import NamedSharding

    cfg = ep_config(1)
    base = ep_one_card(cfg)
    params = M.init_params(base, seed + 79, device=dev)
    stream = token_stream(base.vocab, 1, LM_TRAIN_SEQ, seed=seed + 83,
                          device=dev)
    batches = [next(stream) for _ in range(EP_TRAIN_STEPS)]

    # the one-card references: the loss less its 0.01 aux, its gradients
    # (on the host), each layer's MoE input and output
    def no_aux(p, b):
        return (M.loss_fn(p, base, b[0], b[1])
                - 0.01 * M.forward(p, base, b[0], attn_impl="torch")[1])
    ref_loss, ref_grads = value_and_grad(no_aux)(params, batches[0])
    ref_loss = float(ref_loss)
    ref_grads = T.tree_map(lambda g: g.cpu(), ref_grads)
    with torch.no_grad():
        layer_io, _, _ = moe_layer_inputs(torch, params, base,
                                          batches[0][0], "torch")
    gc.collect()
    torch.cuda.empty_cache()

    init_s = init_group(torch, "nccl", 0, 1, free_port())
    try:
        mesh = make_debug_mesh((1, 1), device_type="cuda")
        opt_cfg = AdamWConfig(lr=1e-3)
        state, place_s = timer.wall(lambda: ep_place(
            mesh, cfg, params, init_opt_state(params, opt_cfg),
            {"tokens": batches[0][0], "labels": batches[0][1]}))
        del params
        dparams, dopt, _ = state
        dbatches = [tuple(reshard_state(x, NamedSharding(mesh, P("data",
                                                                 None)))
                          for x in b) for b in batches]
        with use_mesh(mesh):
            moe_same = []
            for li, (z, y) in enumerate(layer_io):
                dz = reshard_state(z, NamedSharding(mesh, P("data", None,
                                                            None)))
                got, _ = L.apply_moe_ep(dparams["layers"][li]["moe"], cfg,
                                        dz, "cuda")
                moe_same.append(bool(torch.equal(got.full_tensor(), y)))
            del layer_io, dz, got
            loss, grads = value_and_grad(
                lambda p, b: M.loss_fn(p, cfg, b[0], b[1]))(dparams,
                                                            dbatches[0])
            loss = float(loss.full_tensor())
            grads = T.tree_map(lambda g: g.full_tensor().cpu(), grads)
        grads_ok, grad_rows = grad_agreement(torch, grads, ref_grads,
                                             rtol=LM_TRAIN_GRAD_RTOL,
                                             atol=0.0)
        del grads, ref_grads
        gc.collect()
        torch.cuda.empty_cache()

        step = registry._train_step(
            lambda p, b: M.loss_fn(p, cfg, b[0], b[1]), opt_cfg)
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launch_counts()
        secs, losses = [], []
        with use_mesh(mesh):
            for b in dbatches:
                (lval, gnorm, dparams, dopt), s = timer.wall(
                    lambda: step(dparams, dopt, b))
                secs.append(s)
                losses.append(float(lval.full_tensor()))
        launches = {k: backend.LAUNCHES[k] for k in MESH_EP_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        coll = combine_times(torch, mesh, LM_TRAIN_SEQ, cfg.d_model)
        del dparams, dopt, state
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    want = {k: EP_TRAIN_STEPS * n
            for k, n in lm_train_launches(cfg.n_layers).items()}
    out = dict(leg="a", backend="nccl", rank=0, world=1, mesh=[1, 1],
               layers=cfg.n_layers, seq=LM_TRAIN_SEQ, steps=EP_TRAIN_STEPS,
               group_init_s=init_s, place_s=place_s,
               step_ms=[x * 1e3 for x in secs],
               phase10_step_ms_median=report.get("lm_train", {}).get(
                   "step_ms_median"),
               loss=loss, one_card_loss_less_aux=ref_loss,
               loss_rel=abs(loss - ref_loss) / abs(ref_loss),
               losses=losses, moe_bit_for_bit=moe_same,
               grads_ok=grads_ok,
               worst_grad=max(r["max_abs_diff"] / max(r["max_abs"], 1e-30)
                              for r in grad_rows),
               launches=launches, want_launches=want,
               max_memory_allocated=peak, **coll)
    say("mesh.ep", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                      for k, v in out.items()})
    check(all(moe_same), f"mesh.ep (a): a layer's MoE output differs from "
          f"the one-card apply_moe's: {moe_same}")
    check(out["loss_rel"] <= LM_TRAIN_LOSS_RTOL,
          f"mesh.ep (a): loss {loss} vs the one-card {ref_loss} less its "
          f"aux: {out['loss_rel']:.3g} relative")
    check(grads_ok, f"mesh.ep (a): a gradient leaf off the one-card "
          f"gradients by more than {LM_TRAIN_GRAD_RTOL} of its largest")
    check(all(math.isfinite(x) for x in losses),
          f"mesh.ep (a): losses {losses}")
    check(all(launches[k] == n for k, n in want.items()),
          f"mesh.ep (a): launches {launches}, want {want}")
    return out


def gloo_cuda_all_gather() -> None:
    """Route the functional all-gather through c10d's
    ``all_gather_into_tensor``.  On gloo with CUDA tensors, torch 2.11's
    functional all-gather (``_c10d_functional.all_gather_into_tensor`` and
    its wait) ends the process with SIGSEGV, in float32 as in bf16, while
    c10d's call and the functional all-reduce and reduce-scatter work
    (probed on an NVIDIA H100 80GB HBM3, torch 2.11.0 + cu128): DTensor
    gathers through the functional call.  Only phase 12's spawned gloo
    ranks call this; NCCL takes the functional call as it is."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    def all_gather_tensor(self, gather_dim, group, tag=""):
        if isinstance(group, tuple):
            group = group[0].get_group(group[1])
        n = dist.get_world_size(group)
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        if gather_dim:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out

    funcol.all_gather_tensor = all_gather_tensor


def ep_serve_child(rank: int, world: int, port: int, backend_name: str,
                   work_dir: str) -> None:
    """One spawned rank of leg (b): the parent's prompts, decode tokens and
    one-card layer inputs from ``work_dir``; the weights made again from
    the seed; prefill and the dense-cache decode under a (1, EP_RANKS)
    mesh, then, on the one-card layer inputs, each layer's attention
    (:func:`ep_prefill_attention`, :func:`ep_decode_attention`) and MoE
    (:func:`ep_moe_layers`) against the one-card functions on this rank's
    copy of the weights, its results back in ``work_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch import backend
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_debug_mesh, use_mesh
    from repro_torch.models.transformer import model as M
    from repro_torch.runtime import reshard_state
    torch.cuda.set_device(0)
    backend.load_kernels()
    gloo_cuda_all_gather()
    init_s = init_group(torch, backend_name, rank, world, port)
    try:
        inputs = torch.load(f"{work_dir}/inputs.pt")
        dev, timer = torch.device("cuda"), Timer(torch)
        cfg = ep_config(world)
        one = M.init_params(ep_one_card(cfg), inputs["seed"], device=dev)
        check(ep_checksum(torch, one) == inputs["checksum"],
              "mesh.ep (b): the regenerated weights differ from the "
              "parent's")
        mesh = make_debug_mesh((1, world), device_type="cuda")

        def put(x, spec):
            return reshard_state(x.to(dev), NamedSharding(mesh, spec))

        dparams = ep_place_params(mesh, one)
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launch_counts()
        with use_mesh(mesh), torch.no_grad():
            (logits, cache), prefill_s = timer.wall(
                lambda: M.prefill(dparams, cfg, put(inputs["tokens"],
                                                    P("data", None))))
            got = dict(prefill_logits=logits.full_tensor().cpu())
            room = {}
            for k in ("k", "v"):
                whole = cache[k].full_tensor()
                pad = whole.new_zeros(whole.shape[:3] + (EP_DECODE_STEPS,)
                                      + whole.shape[4:])
                room[k] = put(torch.cat([whole, pad], 3),
                              P(None, "data", None, "model", None))
            room["lengths"] = put(cache["lengths"].full_tensor(), P("data"))
            del cache, whole
            step_s, decode_logits = [], []
            for tok in inputs["decode_tokens"]:
                (logits, room), s = timer.wall(lambda: M.serve_step(
                    dparams, cfg, room, put(tok, P("data", None))))
                step_s.append(s)
                decode_logits.append(logits.full_tensor().cpu())
            launches = {k: backend.LAUNCHES[k] for k in MESH_EP_KERNELS}
            peak = torch.cuda.max_memory_allocated()
            del room
            got["head"] = M._head(dparams, cfg, put(
                inputs["x_last"], P("data", None))).full_tensor().cpu()
            S = inputs["tokens"].shape[1]
            got["attention"] = dict(
                prefill=ep_prefill_attention(
                    torch, one, dparams, cfg, mesh, put,
                    inputs["attn_inputs"], M._positions(
                        inputs["tokens"].to(dev))),
                decode=ep_decode_attention(
                    torch, one, dparams, cfg, mesh, put,
                    inputs["decode_x"], inputs["k_final"].to(dev),
                    inputs["v_final"].to(dev), S))
            got["moe"] = ep_moe_layers(torch, one, dparams, cfg, mesh, put,
                                       inputs["layer_inputs"])
        T_all = inputs["tokens"].numel()
        got.update(decode_logits=decode_logits, launches=launches,
                   rank=rank, world=world, backend=dist.get_backend(),
                   group_init_s=init_s, prefill_s=prefill_s,
                   decode_ms=[x * 1e3 for x in step_s],
                   max_memory_allocated=peak,
                   **combine_times(torch, mesh, T_all, cfg.d_model))
        torch.save(got, f"{work_dir}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def ep_prefill_attention(torch, one, dparams, cfg, mesh, put, attn_in,
                         positions, dev="cuda") -> dict:
    """Each layer's prefill attention on the one-card attention input a,
    this rank against the one-card functions on the same weights, each
    piece on the same inputs: the q / k / v projections (this rank's
    columns) within :func:`dot_bound`; the attention of the one card's
    projections (``_attend_spmd``: RoPE, the KV heads of this rank's q
    heads, flash) bit for bit the one card's for this rank's heads, and its
    k, v; the output projection of the one card's o within
    :func:`row_parallel_bound`; the layer's output (``attention_with_kv``
    on a) within that bound plus its o's difference carried through
    |wo|.  The worst ratio to each bound, and the bit-for-bit verdicts."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models.transformer import layers as L
    base = ep_one_card(cfg)
    H, Dh, d = base.n_heads, base.head_dim, base.d_model
    out = dict(proj_over=0.0, core_bit_for_bit=True, kv_bit_for_bit=True,
               out_over=0.0, layer_over=0.0, o_ulps=0.0)
    for li, window in enumerate(base.layer_windows):
        po = one["layers"][li]["attn"]
        g = L.fsdp_gathered(dparams["layers"][li], cfg)["attn"]
        a = attn_in[li].to(dev)
        B, S, _ = a.shape
        proj = {n: a @ po["w" + n] for n in "qkv"}
        q1, k1, v1 = L.attention_inputs(po, base, a, positions)
        o1 = L.flash_attention(q1, k1, v1, scale=Dh ** -0.5, causal=True,
                               window=window, softcap=base.attn_softcap,
                               impl="cuda")
        h1 = L.attention_with_kv(po, base, a, positions, window, "cuda")[0]
        da = put(a, P("data", None, None))
        dproj = {n: da @ g["w" + n] for n in "qkv"}
        for n in "qkv":
            idx = block_of(dproj[n])
            got, ref = dproj[n].to_local(), proj[n][idx]
            A = a.float().abs() @ po["w" + n][:, idx[-1]].float().abs()
            out["proj_over"] = max(out["proj_over"], over_bound(
                got, ref, dot_bound(A, got, ref, d)))
        o2, k2, v2 = L._attend_spmd(
            *(put(proj[n], P("data", None, "model")) for n in "qkv"), cfg,
            window, "cuda", mesh, False)
        out["core_bit_for_bit"] &= bool(torch.equal(o2.to_local(),
                                                    o1[block_of(o2)]))
        out["kv_bit_for_bit"] &= bool(torch.equal(k2.full_tensor(), k1)
                                      and torch.equal(v2.full_tensor(), v1))
        wo_abs = po["wo"].float().abs()
        A_o = o1.transpose(1, 2).reshape(B, S, -1).float().abs() @ wo_abs
        h3 = (put(o1, P("data", "model", None, None)).transpose(1, 2)
              .reshape(B, S, -1) @ g["wo"]).full_tensor()
        out["out_over"] = max(out["out_over"], over_bound(
            h3, h1, row_parallel_bound(A_o, h3, h1, H * Dh)))
        hr = L.attention_with_kv(g, cfg, da, positions, window,
                                 "cuda")[0].full_tensor()
        orr = L._attend_spmd(dproj["q"], dproj["k"], dproj["v"], cfg,
                             window, "cuda", mesh, False)[0].full_tensor()
        out["o_ulps"] = max(out["o_ulps"], bf16_ulps(torch, orr, o1))
        carried = ((orr.float() - o1.float()).abs().transpose(1, 2)
                   .reshape(B, S, -1) @ wo_abs)
        out["layer_over"] = max(out["layer_over"], over_bound(
            hr, h1, row_parallel_bound(A_o, hr, h1, H * Dh)
            + (1 + 2.0 ** -7) * carried))
        del proj, q1, k1, v1, o1, h1, dproj, o2, k2, v2, A_o, h3, hr, orr
        del carried, A
    return out


def ep_decode_attention(torch, one, dparams, cfg, mesh, put, decode_x,
                        k_final, v_final, S: int, dev="cuda") -> dict:
    """Each decode step's attention, layer by layer, on the one-card layer
    input x [B, 1, d] at lengths S + t, over the one-card cache after the
    last step (positions at and past lengths are written or masked), this
    rank against serve_step's one-card body on the same weights, each piece
    on the same inputs: the projections within :func:`dot_bound`; the
    attention of the one card's projections (``_decode_attention_spmd``:
    the cache's positions over "model", the write at lengths, the
    cross-rank LSE merge) within the float32 bound of
    :func:`decode_core_bound`, the cache after its write bit for bit; the
    output projection within :func:`row_parallel_bound`; the layer
    (``_decode_layer_attention_spmd`` on x, then wo) within that bound plus
    its o's difference carried through |wo|."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M
    base = ep_one_card(cfg)
    H, Dh, d = base.n_heads, base.head_dim, base.d_model
    cache_spec = P(None, "data", None, "model", None)
    out = dict(proj_over=0.0, core_over=0.0, cache_bit_for_bit=True,
               out_over=0.0, layer_over=0.0, o_ulps=0.0)
    for t, xs in enumerate(decode_x):
        for li, window in enumerate(base.layer_windows):
            lp, x = one["layers"][li], xs[li].to(dev)
            B = x.shape[0]
            lengths = torch.full((B,), S + t, dtype=torch.int32,
                                 device=dev)
            q1, k1, v1 = M._decode_qkv(lp, base, x, lengths)
            kc, vc = k_final[li].clone(), v_final[li].clone()
            b, pos = torch.arange(B, device=dev), lengths.long()
            kc[b, :, pos], vc[b, :, pos] = k1, v1
            o1 = M._dense_decode_attention(base, q1, kc, vc, lengths, window)
            wo_abs = lp["attn"]["wo"].float().abs()
            h1 = o1.reshape(B, 1, -1) @ lp["attn"]["wo"]
            z1 = L.rmsnorm(lp["ln1"], x, base.norm_eps)
            proj = {n: z1 @ lp["attn"]["w" + n] for n in "qkv"}
            g = L.fsdp_gathered(dparams["layers"][li], cfg)
            dx, dlen = put(x, P("data", None, None)), put(lengths, P("data"))
            zr = L.rmsnorm(g["ln1"], dx, base.norm_eps)
            for n in "qkv":
                dp = zr @ g["attn"]["w" + n]
                idx = block_of(dp)
                got, ref = dp.to_local(), proj[n][idx]
                A = z1.float().abs() @ lp["attn"]["w" + n][
                    :, idx[-1]].float().abs()
                out["proj_over"] = max(out["proj_over"], over_bound(
                    got, ref, dot_bound(A, got, ref, d)))
            kall, vall = put(k_final, cache_spec), put(v_final, cache_spec)
            o2 = M._decode_attention_spmd(
                cfg, *(put(proj[n], P("data", None, "model")) for n in "qkv"),
                kall, vall, li, dlen, window, mesh).full_tensor()
            out["core_over"] = max(out["core_over"], over_bound(
                o2, o1, decode_core_bound(torch, base, q1, kc, vc, lengths,
                                          window) + bf16_pair(o2, o1)))
            for whole, cl, dt in ((k_final, kc, kall), (v_final, vc, vall)):
                after = whole.clone()
                after[li] = cl
                out["cache_bit_for_bit"] &= bool(torch.equal(
                    dt.to_local(), after[block_of(dt)]))
            A_o = o1.reshape(B, 1, -1).float().abs() @ wo_abs
            h3 = (put(o1, P("data", None, None)).reshape(B, 1, -1)
                  @ g["attn"]["wo"]).full_tensor()
            out["out_over"] = max(out["out_over"], over_bound(
                h3, h1, row_parallel_bound(A_o, h3, h1, H * Dh)))
            kall, vall = put(k_final, cache_spec), put(v_final, cache_spec)
            orr = M._decode_layer_attention_spmd(g, cfg, dx, kall, vall, li,
                                                 dlen, window, mesh)
            hr = (orr.reshape(B, 1, -1) @ g["attn"]["wo"]).full_tensor()
            orr = orr.full_tensor()
            out["o_ulps"] = max(out["o_ulps"], bf16_ulps(torch, orr, o1))
            carried = (orr.float() - o1.float()).abs().reshape(B, 1, -1) \
                @ wo_abs
            out["layer_over"] = max(out["layer_over"], over_bound(
                hr, h1, row_parallel_bound(A_o, hr, h1, H * Dh)
                + (1 + 2.0 ** -7) * carried))
    return out


def decode_core_bound(torch, cfg, q, k_cache, v_cache, lengths, window):
    """|o_a - o_b| in float32 for two evaluations of one decode step's
    attention o = sum_j p_j v_j over the same bf16 q [B, H, D] and cache
    [B, KVH, S, D] (the one card's softmax against a rank's block with the
    LSE merge).  The scores' dot products over D in two orders differ by
    at most 2 gamma_D sum_d |q_d k_jd| (times the scale), plus a rounding
    of the max's subtraction (2 u |s|); exp adds 2 ulps (2^-22); the sums
    of the weights and of the weighted values over S' = S keys, in any
    split, gamma_S each, and the division u.  Each weight's relative error
    eps moves o by eps V with V = sum_j p_j |v_j|, twice through the
    normalisation: 2 (2 eps_s + 2^-21 + 2 gamma_S + u) V for both
    evaluations together.  Rounding o to bf16 is added by the caller."""
    B, H, D = q.shape
    KVH, Sc = k_cache.shape[1], k_cache.shape[2]
    scale = cfg.head_dim ** -0.5
    qg = q.float().reshape(B, KVH, H // KVH, D)
    kf = k_cache.float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, kf) * scale
    mag = torch.einsum("bhgd,bhsd->bhgs", qg.abs(), kf.abs()) * scale
    ki = torch.arange(Sc, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = ki < lens + 1
    if window > 0:
        mask &= ki > lens - window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    zero = torch.zeros((), device=q.device)
    eps_s = (2 * gamma(D) * torch.where(mask, mag, zero).amax(-1)
             + 2 * 2.0 ** -24 * torch.where(mask, s.abs(), zero).amax(-1))
    V = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float().abs())
    c = 2 * (2 * eps_s + 2.0 ** -21 + 2 * gamma(Sc) + 2.0 ** -24)
    return (c[..., None] * V).reshape(B, H, D)


def ep_moe_layers(torch, one, dparams, cfg, mesh, put, layer_inputs,
                  dev="cuda") -> dict:
    """Each layer's ``apply_moe_ep`` on the one-card MoE input z against
    the one-card ``apply_moe`` on this rank's copy of the weights: the
    routes (expert ids, kept lanes) bit for bit the one-card plan's; this
    rank's expert rows (``probe["yb"]``) bit for bit the one card's rows
    for the same experts; the output within the bound of EP_PARTIAL_ULPS
    and the two bf16 roundings.  And a bf16 partial: this rank's part of
    the one card's combine rounded to bf16, summed across the ranks in
    bf16, against the same bound."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import P
    from repro_torch.models.transformer import layers as L
    base = ep_one_card(cfg)
    E, d = base.n_experts, base.d_model
    E_per = E // cfg.model_axis_size
    m = mesh.get_local_rank("model")
    out = dict(routes_bit_for_bit=True, rows_differ=0, row_values=0,
               over=0.0, bf16_partial_over=math.inf, eidx=[])
    for li, z in enumerate(layer_inputs):
        z, p1 = z.to(dev), one["layers"][li]["moe"]
        probe = {}
        y = L.apply_moe_ep(dparams["layers"][li]["moe"], cfg,
                           put(z, P("data", None, None)), "cuda",
                           probe)[0].full_tensor().reshape(-1, d)
        y1 = L.apply_moe(p1, base, z, "cuda")[0].reshape(-1, d)
        zt = z.reshape(-1, d)
        gate, eidx, _ = L.route(p1, base, zt.float())
        plan = L.token_plan(eidx, L.capacity(base, zt.shape[0]), E)
        out["routes_bit_for_bit"] &= bool(
            torch.equal(probe["eidx"], eidx)
            and torch.equal(probe["plan"].slot_of_lane, plan.slot_of_lane))
        out["eidx"].append(eidx.cpu())
        yb1 = L._experts(p1, L._Dispatch.apply(zt.contiguous(), plan)
                         .view(E, plan.C, d)).reshape(E * plan.C, d)
        rows = slice(m * E_per * plan.C, (m + 1) * E_per * plan.C)
        out["rows_differ"] += int((probe["yb"] != yb1[rows]).sum())
        out["row_values"] += probe["yb"].numel()
        g = gate.reshape(-1).contiguous()
        lanes = EP_PARTIAL_ULPS * 2.0 ** -24 * L._combine_plain(
            yb1.float().abs(), g.abs(), plan)
        out["over"] = max(out["over"], over_bound(
            y, y1, lanes + bf16_pair(y, y1)))
        part = L._combine_plain(yb1[rows], g, plan.experts(m * E_per, E_per)
                                ).to(torch.bfloat16)
        dist.all_reduce(part)
        out["bf16_partial_over"] = min(out["bf16_partial_over"], over_bound(
            part, y1, lanes + bf16_pair(part, y1)))
        del y, y1, yb1, lanes, part, probe
    return out


def ep_checksum(torch, params) -> list:
    """Sums of a few leaves that tell one regeneration of the weights from
    another."""
    lp = params["layers"][0]
    return [float(params["embed"].double().sum()),
            float(lp["moe"]["wi"].double().sum()),
            float(lp["attn"]["wq"].double().sum())]


def ep_serve_leg(torch, timer, dev, seed, report) -> list:
    """Leg (b): EP_RANKS gloo ranks spawned on the one card, a (data 1,
    model EP_RANKS) mesh, 64 experts a rank: the ``opt`` prefill of
    EP_PREFILL prompts and EP_DECODE_STEPS dense-cache decode steps,
    teacher-forced with the one-card greedy tokens; then each layer's
    attention and MoE on the one-card layer inputs.  Held to the one-card
    path computed here first, the ranks to each other."""
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M
    base = ep_one_card(ep_config(EP_RANKS))
    params = M.init_params(base, seed + 89, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 97)
    B, S = EP_PREFILL
    tokens = torch.randint(0, base.vocab, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    with torch.no_grad():
        logits, cache = M.prefill(params, base, tokens)
        ref_prefill = logits.float().cpu()
        room = M.init_cache(base, B, S + EP_DECODE_STEPS, device=dev)
        room["k"][:, :, :, :S] = cache["k"]
        room["v"][:, :, :, :S] = cache["v"]
        room["lengths"] = cache["lengths"]
        del cache
        dec_tokens, ref_decode, decode_x = [], [], []
        for _ in range(EP_DECODE_STEPS):
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            dec_tokens.append(tok.cpu())
            logits, xs = decode_layer_inputs(torch, params, base, room, tok)
            decode_x.append([x.cpu() for x in xs])
            step_logits, room = M.serve_step(params, base, room, tok)
            check(torch.equal(step_logits, logits), "mesh.ep (b): the "
                  "one-card decode's layer inputs come from another step "
                  "than serve_step's")
            ref_decode.append(logits.float().cpu())
        layer_io, x_last, attn_in = moe_layer_inputs(torch, params, base,
                                                     tokens, "cuda")
        head_ref = M._head(params, base, x_last).cpu()
        xn = L.rmsnorm(params["ln_f"], x_last, base.norm_eps).float()
        head_abs = (base.d_model * 2.0 ** -24
                    * (xn.abs() @ params["lm_head"].float().abs())).cpu()
        del xn
        inputs = dict(seed=seed + 89, checksum=ep_checksum(torch, params),
                      tokens=tokens.cpu(), decode_tokens=dec_tokens,
                      layer_inputs=[z.cpu() for z, _ in layer_io],
                      attn_inputs=[a.cpu() for a in attn_in],
                      decode_x=decode_x, k_final=room["k"].cpu(),
                      v_final=room["v"].cpu(), x_last=x_last.cpu())
    del params, layer_io, attn_in, logits, room
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as d:
        torch.save(inputs, f"{d}/inputs.pt")
        spawn_s = spawn_ranks(torch, "gloo", d, child=ep_serve_child,
                              nprocs=EP_RANKS, join_s=EP_JOIN_S,
                              what="mesh.ep (b)")
        outs = [torch.load(f"{d}/rank{r}.pt") for r in range(EP_RANKS)]
    for r, got in enumerate(outs):
        tag = f"mesh.ep (b) rank {r}"
        if r:
            check(torch.equal(got["prefill_logits"],
                              outs[0]["prefill_logits"])
                  and all(torch.equal(a, b) for a, b in zip(
                      got["decode_logits"], outs[0]["decode_logits"])),
                  f"{tag}: logits differ from rank 0's")
        rel = [rel_l2(torch, got["prefill_logits"], ref_prefill)] + [
            rel_l2(torch, a, b) for a, b in zip(got["decode_logits"],
                                                ref_decode)]
        a, b = got["head"], head_ref
        head_over = float(((a - b).abs() / (
            head_abs + 2.0 ** -8 * torch.maximum(a.abs(), b.abs()))
            .clamp(min=1e-30)).max())
        moe, att = got["moe"], got["attention"]
        want = {"block_gather": 2 * base.n_layers,
                "segment_sum": base.n_layers,
                "flash_attention_wgmma": base.n_layers}
        row = dict(leg="b", backend=got["backend"], rank=r,
                   world=got["world"], mesh=[1, EP_RANKS],
                   experts_per_rank=base.n_experts // EP_RANKS,
                   prompts=B, prompt_tokens=S, decode_steps=EP_DECODE_STEPS,
                   group_init_s=got["group_init_s"],
                   prefill_s=got["prefill_s"],
                   decode_ms_median=sorted(got["decode_ms"])[
                       len(got["decode_ms"]) // 2],
                   decode_ms=got["decode_ms"],
                   logits_rel_l2_max=max(rel), prefill_logits_rel_l2=rel[0],
                   decode_logits_rel_l2=rel[1:], head_worst_over_bound=head_over,
                   routes_bit_for_bit=moe["routes_bit_for_bit"],
                   moe_worst_over_bound=moe["over"],
                   moe_bf16_partial_over_bound=moe["bf16_partial_over"],
                   expert_rows_differ=moe["rows_differ"],
                   expert_row_values=moe["row_values"],
                   prefill_attention=att["prefill"],
                   decode_attention=att["decode"],
                   combine_ms=got["combine_ms"],
                   combine_bytes=got["combine_bytes"],
                   launches=got["launches"], want_launches=want,
                   max_memory_allocated=got["max_memory_allocated"],
                   spawn_s=spawn_s)
        say("mesh.ep", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                          for k, v in row.items() if k != "decode_ms"},
            note="the code path on one card, not a multi-card speed")
        pa, da = att["prefill"], att["decode"]
        check(moe["routes_bit_for_bit"] and all(
            torch.equal(x, y) for x, y in zip(moe["eidx"],
                                              outs[0]["moe"]["eidx"])),
              f"{tag}: routes differ from the one-card plan's")
        check(moe["rows_differ"] == 0, f"{tag}: {moe['rows_differ']} "
              f"values of this rank's expert rows differ from the one "
              f"card's")
        check(moe["over"] <= 1.0, f"{tag}: an MoE output off the one-card "
              f"one by {moe['over']:.3g} x its bound")
        check(moe["bf16_partial_over"] > 1.0, f"{tag}: a bf16 partial "
              f"summed across ranks stays within the MoE bound "
              f"({moe['bf16_partial_over']:.3g} x): it guards nothing")
        for what, v in (("prefill projections", pa["proj_over"]),
                        ("prefill output projection", pa["out_over"]),
                        ("prefill attention", pa["layer_over"]),
                        ("decode projections", da["proj_over"]),
                        ("decode attention on the one card's q, k, v",
                         da["core_over"]),
                        ("decode output projection", da["out_over"]),
                        ("decode attention", da["layer_over"])):
            check(v <= 1.0, f"{tag}: {what} off the one card's by {v:.3g} "
                  f"x its bound")
        check(pa["core_bit_for_bit"] and pa["kv_bit_for_bit"],
              f"{tag}: prefill attention on the one card's q, k, v differs "
              f"from the one card's (o {pa['core_bit_for_bit']}, k and v "
              f"{pa['kv_bit_for_bit']})")
        check(da["cache_bit_for_bit"], f"{tag}: the decode's cache write "
              f"differs from the one card's")
        check(head_over <= 1.0, f"{tag}: the head on the one-card final "
              f"state off by {head_over:.3g} x its bound")
        check(max(rel) <= EP_LOGIT_REL_L2_SANE, f"{tag}: logits off the "
              f"one-card path's by {max(rel):.4g} relative L2")
        check(all(got["launches"][k] == n for k, n in want.items()),
              f"{tag}: launches {got['launches']}, want {want}")
        rows.append(row)
    return rows


def decode_layer_inputs(torch, params, cfg, cache, tokens):
    """``model.serve_step``'s one-card body over the dense cache, with each
    layer's input kept: (logits, [x [B, 1, d] a layer]).  The cache is not
    modified."""
    from repro_torch.models.transformer import model as M
    lengths = cache["lengths"]
    k_all, v_all = cache["k"].clone(), cache["v"].clone()
    b_idx = torch.arange(tokens.shape[0], device=tokens.device)
    pos = lengths.long()
    x, xs = M.embed(params, cfg, tokens), []
    for li, (lp, window) in enumerate(zip(params["layers"],
                                          cfg.layer_windows)):
        xs.append(x)
        q, k, v = M._decode_qkv(lp, cfg, x, lengths)
        k_all[li, b_idx, :, pos] = k
        v_all[li, b_idx, :, pos] = v
        o = M._dense_decode_attention(cfg, q, k_all[li], v_all[li], lengths,
                                      window)
        x = M._decode_out(lp, cfg, x, o, "torch")
    return M._head(params, cfg, x[:, 0]), xs


def rel_l2(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def gamma(n: int) -> float:
    """Higham's gamma_n for float32: a sum of n terms in any order lies
    within gamma_n times the sum of their magnitudes of the exact sum."""
    nu = n * 2.0 ** -24
    return nu / (1 - nu)


def bf16_pair(a, b):
    """The most that rounding two float32 values to bf16 adds to |a - b|,
    from the rounded values a, b."""
    return BF16_HALF_ULP * (a.float().abs() + b.float().abs())


def dot_bound(A, a, b, n: int):
    """|a - b| for bf16 roundings of one float32 dot product of n exact
    bf16 products summed in two orders (GEMMs of other shapes): 2 gamma_n
    A, A the sum of the products' magnitudes, and the two roundings."""
    return 2 * gamma(n) * A + bf16_pair(a, b)


def row_parallel_bound(A, a, b, n: int):
    """:func:`dot_bound` where a is a row-parallel product: each rank's
    partial over its block of the n terms is rounded to bf16 before the
    cross-rank sum (DTensor's Partial() of a bf16 product), which adds 2^-8
    of each partial's magnitude, BF16_HALF_ULP A at most together."""
    return dot_bound(A, a, b, n) + BF16_HALF_ULP * A


def over_bound(a, b, bound) -> float:
    """The largest |a - b| / bound (0 where a and b agree)."""
    d = (a.float() - b.float()).abs()
    return float((d / bound.clamp(min=1e-30)).max())


def bf16_ulps(torch, a, b) -> float:
    """The largest |a - b| in bf16 ulps of the larger magnitude."""
    m = torch.maximum(a.float().abs(), b.float().abs())
    _, e = torch.frexp(m)
    return float(((a.float() - b.float()).abs()
                  / torch.ldexp(torch.ones_like(m), e - 8)).max())


def block_of(x):
    """The index of this rank's block of the Shard / Replicate DTensor x in
    the whole tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(slice(o, o + n) for o, n in zip(off, shape))


def ep_mesh_phase(torch, timer, dev, seed, report) -> None:
    """Phase 12: the expert-parallel MoE and the LM's ``opt`` steps on a
    ``("data", "model")`` DTensor mesh, leg (a) one NCCL rank in this
    process (training), leg (b) EP_RANKS gloo ranks on the one card
    (prefill and decode)."""
    import torch.distributed as dist
    check(not dist.is_initialized(), "mesh.ep: a process group is up "
          "before the phase")
    t0 = time.perf_counter()
    train = ep_train_leg(torch, timer, dev, seed, report)
    train_s = time.perf_counter() - t0
    serve = ep_serve_leg(torch, timer, dev, seed, report)
    report["mesh_ep"] = dict(train=train, serve=serve, train_seconds=train_s,
                             seconds=time.perf_counter() - t0)
    say("mesh.ep_phase", train_s=f"{train_s:.4g}",
        seconds=f"{report['mesh_ep']['seconds']:.4g}")


def plan_patch_phase(torch, timer, dev, seed, report,
                     scale_log2=PLAN_PATCH_SCALE,
                     edges_log2=PLAN_PATCH_EDGES,
                     records=PLAN_PATCH_RECORDS) -> None:
    """Phase 5g (module docstring): the two plan-patch kernels at Graph500
    scale 24's stream, each against its plain version and the stream sorted
    afresh; rows in ``report["plan_patch"]``."""
    from repro_torch import backend
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.kernels.plan_patch import (locate_lanes,
                                                locate_lanes_ref, merge_lanes,
                                                merge_lanes_ref)
    nv, ne = 1 << scale_log2, 1 << edges_log2
    src, dst = rmat_edges(nv, ne, seed=seed + 11, device=dev)
    key = torch.sort(dst.long() * nv + src.long()).values
    del src, dst
    V = key.numel()
    lanes_src = (key % nv).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    w = 0.1 + 0.9 * torch.rand(V, generator=gen, device=dev)
    row_ptr = torch.searchsorted(
        key, torch.arange(nv + 1, device=dev) * nv, out_int32=True)
    # half deletes of live keys, half fresh inserts (a live key among them
    # is a re-insert), each key once, in (dst, src) order
    half = records // 2
    dels = key[torch.randperm(V, generator=gen, device=dev)[:half]]
    ins_src, ins_dst = rmat_edges(nv, half, seed=seed + 13, device=dev)
    ins_key = ins_dst.long() * nv + ins_src.long()
    rkey = torch.unique(torch.cat([dels, ins_key]))      # sorted, each once
    is_ins = torch.isin(rkey, ins_key)
    del dels, ins_src, ins_dst, ins_key
    rdst, rsrc = (rkey // nv).to(torch.int32), (rkey % nv).to(torch.int32)
    rw = 0.1 + 0.9 * torch.rand(rkey.numel(), generator=gen, device=dev)

    before = {k: backend.LAUNCHES[k] for k in PLAN_PATCH_KERNELS}
    pos, found = locate_lanes(lanes_src, row_ptr, rdst, rsrc)
    pos_ref, found_ref = locate_lanes_ref(lanes_src, row_ptr, rdst, rsrc)
    check(torch.equal(pos, pos_ref) and torch.equal(found, found_ref),
          "plan_patch_locate differs from its plain version")
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    cum_found = torch.cat([zero, torch.cumsum(found, 0, dtype=torch.int32)])
    cum_ins = torch.cat([zero, torch.cumsum(is_ins, 0, dtype=torch.int32)])
    n_found, n_ins = int(cum_found[-1]), int(cum_ins[-1])
    lanes = V - n_found + n_ins
    new_src, new_w = merge_lanes(lanes_src, w, pos, cum_found, cum_ins, rsrc,
                                 rw, lanes)
    ref_src, ref_w = merge_lanes_ref(lanes_src, w, pos, cum_found, cum_ins,
                                     rsrc, rw, lanes)
    check(torch.equal(new_src, ref_src) and torch.equal(new_w, ref_w),
          "plan_patch_merge differs from its plain version")
    del ref_src, ref_w
    # the stream sorted afresh from the patched edge set
    kept = torch.ones(V, dtype=torch.bool, device=dev)
    kept[pos[found].long()] = False
    fresh_key, order = torch.sort(torch.cat([key[kept], rkey[is_ins]]))
    fresh_w = torch.cat([w[kept], rw[is_ins]])[order]
    check(torch.equal(new_src, (fresh_key % nv).to(torch.int32))
          and torch.equal(new_w, fresh_w),
          "the patched stream differs from the stream sorted afresh")
    del kept, fresh_key, order, fresh_w
    launches = {k: backend.LAUNCHES[k] - before[k] for k in PLAN_PATCH_KERNELS}
    check(launches == {k: 1 for k in PLAN_PATCH_KERNELS},
          f"plan patch launches {launches}, not one a kernel")
    K = rkey.numel()
    # the locate: each record's key read, a position and a flag written;
    # the lanes it searches are a few sectors each (not counted)
    loc_ms, loc_by = bound_ms(K * 8 + K * 5, 0)
    # the merge: the old stream read once and the new one written once
    # (8 B a lane each), the records read once
    mer_ms, mer_by = bound_ms(V * 8 + lanes * 8 + K * 20, 0)
    rows = [
        dict(name="plan_patch_locate", lanes=V, records=K, found=n_found,
             ms=timer.ms(lambda: locate_lanes(lanes_src, row_ptr, rdst,
                                              rsrc)),
             plain_ms=timer.ms(lambda: locate_lanes_ref(lanes_src, row_ptr,
                                                        rdst, rsrc), 3),
             bound_ms=loc_ms, bound_by=loc_by),
        dict(name="plan_patch_merge", lanes=V, new_lanes=lanes, records=K,
             inserts=n_ins,
             ms=timer.ms(lambda: merge_lanes(lanes_src, w, pos, cum_found,
                                             cum_ins, rsrc, rw, lanes)),
             plain_ms=timer.ms(lambda: merge_lanes_ref(
                 lanes_src, w, pos, cum_found, cum_ins, rsrc, rw, lanes), 3),
             bound_ms=mer_ms, bound_by=mer_by)]
    for row in rows:
        row["launches"] = launches[row["name"]]
        say("plan_patch", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                             for k, v in row.items()})
    report["plan_patch"] = rows
    del (key, lanes_src, w, row_ptr, rkey, is_ins, rdst, rsrc, rw, pos,
         found, new_src, new_w)
    plan_patch_vs_build(torch, timer, dev, seed, report, nv, ne)


def plan_patch_vs_build(torch, timer, dev, seed, report, nv, ne,
                        counts=PLAN_PATCH_SWEEP) -> None:
    """Phase 5g's second half: on a CBList of an R-MAT of ``ne`` edges over
    ``nv`` vertices, the full lanes build and the whole patch of its plan
    (``engine.patch_plan``) at each count of one flush's records (half
    deletes of live edges, half fresh R-MAT inserts), each the best of 3
    host-synchronised calls; in ``report["plan_patch_vs_build"]``."""
    from repro_torch import backend
    from repro_torch.core.cblist import blocks_needed, build_from_coo
    from repro_torch.core.engine import patch_plan, sweep_plan
    from repro_torch.core.updates import DELETE, INSERT
    from repro_torch.data.synthetic import rmat_edges
    src, dst = rmat_edges(nv, ne, seed=seed + 11, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    demand = blocks_needed(src, nv, 32)
    cbl = build_from_coo(src, dst, torch.rand(src.numel(), generator=gen,
                                              device=dev),
                         num_vertices=nv, block_width=32,
                         num_blocks=demand + demand // 2 + nv // 8)

    def best_ms(fn):
        fn()
        return min(timer.wall(fn)[1] for _ in range(3)) * 1e3

    plan = sweep_plan(cbl, pull=False)
    out = dict(lanes=plan.src.numel(),
               build_ms=best_ms(lambda: sweep_plan(cbl, pull=False)))
    patch_ms = {}
    i32 = dict(dtype=torch.int32, device=dev)
    for n in counts:
        half = n // 2
        pick = torch.randint(0, src.numel(), (half,), generator=gen,
                             device=dev)
        fs, fd = rmat_edges(nv, n - half, seed=seed + 15 + n, device=dev)
        rec = (torch.cat([src[pick], fs]), torch.cat([dst[pick], fd]),
               torch.rand(half + fs.numel(), generator=gen, device=dev),
               torch.cat([torch.full((half,), DELETE, **i32),
                          torch.full((fs.numel(),), INSERT, **i32)]))
        b0, p0 = backend.PLAN_BUILDS, backend.PLAN_PATCHES
        patch_ms[n] = best_ms(lambda: patch_plan(cbl, plan, [rec]))
        check(backend.PLAN_BUILDS == b0 and backend.PLAN_PATCHES == p0 + 4,
              f"the patch of {n} records built its plan")
        del pick, fs, fd, rec
    out["patch_ms"] = patch_ms
    report["plan_patch_vs_build"] = out
    say("plan_patch.vs_build", lanes=out["lanes"],
        build_ms=f"{out['build_ms']:.4g}",
        **{f"patch_ms_{n}": f"{v:.4g}" for n, v in patch_ms.items()})


def graph_phases(torch, timer, dev, scale, seed, profile, report) -> None:
    """Phases 1-5f: the GraphService at LiveJournal size, its serve, tier
    and shard phases, the last two on a process group."""
    from repro_torch import backend
    from repro_torch.core.engine import sweep_plan
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.stream.service import GraphService

    nv, ne = int(LJ_VERTICES * scale), int(LJ_EDGES * scale)
    (src, dst), gen_s = timer.wall(lambda: rmat_edges(nv, ne, seed=seed,
                                                      device=dev))
    wgen = torch.Generator(device=dev).manual_seed(seed + 3)
    w = 0.1 + 0.9 * torch.rand(ne, generator=wgen, device=dev)
    svc, build_s = timer.wall(lambda: GraphService.from_coo(
        src, dst, w, num_vertices=nv, log_capacity=2 ** 21, device=dev))
    cbl0 = svc.snapshot.cbl
    report["graph"] = dict(vertices=nv, edges=ne, rmat_seconds=gen_s,
                           from_coo_seconds=build_s,
                           num_blocks=cbl0.store.num_blocks,
                           block_width=cbl0.block_width)
    say("setup.graph", **report["graph"])

    agreement_phase(torch, dev, seed)

    ssrc, sdst = rmat_edges(nv // 16, ne // 16, seed=seed + 5, device=dev)
    small = GraphService.from_coo(ssrc, sdst, None, num_vertices=nv // 16,
                                  device=dev).snapshot.cbl
    report["kernels"] = kernel_phase(torch, timer, dev, cbl0, small, seed,
                                     report)
    del small, ssrc, sdst

    torch.cuda.reset_peak_memory_stats()
    ranks, ranks_warm, untiered, shard_ref = service_phase(
        torch, timer, dev, svc, (src, dst), seed, report, profile)
    launches = report["service"]["launches"]

    total = float(ranks.double().sum())
    check(abs(total - 1.0) <= 1e-3, f"PageRank ranks sum to {total}")
    # the same cold PageRank through each route, back to back, each with
    # the counters at 0
    per_it = {}
    for impl in ("cuda", "torch"):
        backend.reset_launch_counts()
        (ref, iters), sec = timer.wall(
            lambda: pagerank(cbl0, impl=impl, return_stats=True))
        per_it[impl] = dict(seconds=sec, iterations=iters,
                            ms_per_iteration=sec * 1e3 / max(iters, 1),
                            plan_builds=backend.PLAN_BUILDS,
                            launches={k: backend.LAUNCHES[k]
                                      for k in GRAPH_KERNELS})
    kern = per_it["cuda"]
    check(kern["plan_builds"] == 1, f"the kernel route's PageRank built "
          f"{kern['plan_builds']} sweep plans, not 1")
    check(per_it["torch"]["plan_builds"] == 0,
          "the plain route built a sweep plan")
    for name in GRAPH_KERNELS:
        check(kern["launches"][name] == kern["iterations"],
              f"PageRank launched {name} {kern['launches'][name]} times in "
              f"{kern['iterations']} iterations")
    _, plan_s = timer.wall(lambda: sweep_plan(cbl0, pull=False))
    kern["plan_build_ms"] = plan_s * 1e3
    rel = float(((ranks - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    check(torch.allclose(ranks, ref, rtol=1e-4, atol=0.0),
          f"PageRank impl=torch vs cuda: max rel diff {rel:.3e}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    check(report["service"]["walk_launches"]["chain_walk_locate"] > 0,
          "chain_walk never launched on the service's flushes and reads")
    # a patch launches each patch kernel at most once (none without records)
    patches = report["service"]["plan_patches"]
    for name, n in report["service"]["patch_launches"].items():
        check(n <= patches, f"kernel {name} launched {n} times in "
              f"{patches} plan patches on the main path")
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rounds = report["service"]["rounds"]
    vs = dict(
        flush_s_per_1M=[r["flush_s"] * 1e6 / r["updates"] for r in rounds],
        read_pairs_per_s=[r["read_pairs_per_s"] for r in rounds],
        walk_launches=report["service"]["walk_launches"])
    report["service_vs_host_loop"] = vs
    say("service.vs_host_loop",
        flush_s_per_1M="/".join(f"{x:.4g}" for x in vs["flush_s_per_1M"]),
        host_loop_flush_s_per_1M=HOST_LOOP_FLUSH_S_PER_1M,
        read_pairs_per_s="/".join(f"{x:.4g}"
                                  for x in vs["read_pairs_per_s"]),
        host_loop_read_pairs_per_s=HOST_LOOP_READ_PAIRS_PER_S,
        walk_launches=vs["walk_launches"])
    say("checks", ranks_sum=f"{total:.6f}", torch_vs_cuda_max_rel=f"{rel:.3e}",
        launches=launches, plan_builds=report["service"]["plan_builds"],
        plan_patches=report["service"]["plan_patches"],
        patch_launches=report["service"]["patch_launches"])
    say("pagerank.routes",
        **{f"{k}_ms_per_it": f"{v['ms_per_iteration']:.4g}"
           for k, v in per_it.items()},
        iterations=kern["iterations"],
        plan_build_ms=f"{kern['plan_build_ms']:.4g}",
        plan_builds=kern["plan_builds"], launches=kern["launches"])
    report["checks"] = dict(ranks_sum=total, torch_vs_cuda_max_rel=rel)
    report["pagerank_routes"] = per_it

    torch.cuda.reset_peak_memory_stats()
    report["walk_kernels"] = walk_kernel_checks(torch, timer, dev,
                                                svc.snapshot.cbl, seed)
    serve_phase(torch, timer, dev, svc, seed, report, profile)
    kept_plan_phase(torch, timer, dev, svc, seed, report)

    # the tier phase: sealed fractions of the final CBList, then (with the
    # untiered service freed) the tiered twin of the service
    t0 = time.perf_counter()
    report["tier"] = tier_fractions(torch, timer, dev, svc.snapshot.cbl,
                                    seed)
    del svc, cbl0, ranks, ref
    gc.collect()
    torch.cuda.empty_cache()
    report["tier"]["service"] = tier_service(
        torch, timer, dev, (src, dst, w), nv, untiered, ranks_warm,
        report["service"], seed)
    report["tier_seconds"] = time.perf_counter() - t0

    # the shard phase, the tier phase's tensors released: the same graph
    # behind GraphService(n_shards=S) beside the unsharded service
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["shard"] = shard_phase(torch, timer, dev, (src, dst, w), nv,
                                  untiered, shard_ref, report, seed, profile)
    report["shard_seconds"] = time.perf_counter() - t0

    # phase 5e, phase 5d's state freed: the shard axis across ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["shard_mesh"] = shard_mesh_phase(
        torch, timer, dev, (src, dst, w), nv, untiered, shard_ref, report,
        seed)
    report["shard_mesh_seconds"] = time.perf_counter() - t0

    # phase 5f, phase 5e's state freed: ServeFrontend on every rank
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["serve_mesh"] = serve_mesh_phase(
        torch, timer, dev, (src, dst, w), nv, report, seed)
    report["serve_mesh_seconds"] = time.perf_counter() - t0


def kept_plan_phase(torch, timer, dev, svc, seed, report) -> None:
    """Phase 5b2 (module docstring): on the service after its rounds and
    the serve phase, KEPT_PLAN_ROUNDS rounds of KEPT_PLAN_UPDATES updates (half fresh
    inserts, half deletes of live edges, as the benchmark's refresh cells
    send), a flush and a warm PageRank each.  Every round's job patches
    the kept sweep plan, each patch kernel launches at most once a patch,
    and the plan after the last is bit for bit a fresh build; in
    ``report["service"]["kept_plan"]``."""
    from repro_torch import backend
    from repro_torch.core.cblist import to_coo
    from repro_torch.core.engine import sweep_plan
    from repro_torch.data.synthetic import update_stream
    cbl = svc.snapshot.cbl
    ls, ld, _, valid = to_coo(cbl)
    b0, p0 = backend.PLAN_BUILDS, backend.PLAN_PATCHES
    l0 = {k: backend.LAUNCHES[k] for k in PLAN_PATCH_KERNELS}
    svc.analytics("pagerank")            # keeps a plan of this epoch
    jobs = []
    for s, d, w, op in update_stream(int(cbl.n_vertices), (ls[valid],
                                                           ld[valid]),
                                     KEPT_PLAN_UPDATES, KEPT_PLAN_ROUNDS,
                                     delete_frac=0.5, seed=seed + 21,
                                     device=dev):
        svc.apply(s, d, w, op)
        svc.flush()
        b, p = backend.PLAN_BUILDS, backend.PLAN_PATCHES
        _, sec = timer.wall(lambda: svc.analytics("pagerank"))
        jobs.append(dict(seconds=sec, iterations=svc.last_iterations,
                         builds=backend.PLAN_BUILDS - b,
                         patches=backend.PLAN_PATCHES - p))
    del ls, ld, valid
    out = dict(builds=backend.PLAN_BUILDS - b0,
               patches=backend.PLAN_PATCHES - p0,
               launches={k: backend.LAUNCHES[k] - l0[k]
                         for k in PLAN_PATCH_KERNELS}, jobs=jobs)
    check(all(j["patches"] == 1 and j["builds"] == 0 for j in jobs),
          f"the refreshes' jobs did not each patch the kept plan: {jobs}")
    for name, n in out["launches"].items():
        check(0 < n <= out["patches"], f"kernel {name} launched {n} times "
              f"in {out['patches']} plan patches on the main path")
    held, fresh = svc._held, sweep_plan(svc.snapshot.cbl, pull=False)
    check(held is not None and all(
        torch.equal(getattr(held, k).view(torch.int32),
                    getattr(fresh, k).view(torch.int32))
        for k in ("src", "w", "row_ptr")),
        "the kept plan differs from a fresh build of its store")
    del held, fresh
    report["service"]["kept_plan"] = out
    say("service.kept_plan", builds=out["builds"], patches=out["patches"],
        patch_launches=out["launches"],
        job_ms="/".join(f"{j['seconds'] * 1e3:.4g}" for j in jobs),
        iterations="/".join(str(j["iterations"]) for j in jobs),
        equals_fresh_build=True)


# ---------------------------------------------------------------------------
# tiered storage: sealed CSR runs under the CBList delta
# ---------------------------------------------------------------------------

def cold_mask_for_fraction(torch, v_deg, n_live, frac):
    """Seal the low-degree tail of the ``n_live`` live vertices first until
    ``frac`` of the edges are cold (the rule of
    ``benchmarks/bench_tier.py:_cold_mask_for_fraction``: a degree-1 vertex
    frees a whole delta block per edge sealed, a hub one per block
    width)."""
    deg = v_deg[:n_live].long()
    order = torch.sort(deg, stable=True)[1]            # low degree first
    cum = torch.cumsum(deg[order], 0).double()
    take = int(torch.searchsorted(cum, torch.tensor(
        [frac * float(cum[-1])], dtype=torch.float64,
        device=cum.device))) + 1
    mask = torch.zeros(v_deg.numel(), dtype=torch.bool, device=deg.device)
    mask[order[:take]] = True
    return mask


def tier_fractions(torch, timer, dev, cbl, seed):
    """Seal TIER_FRACTIONS of the graph cell's final CBList's edges
    (low-degree vertices first) and hold each tiered graph against the
    all-delta one: a push sweep through the kernels (the run tier's
    launches counted), PageRank, 2^20 point reads and a (15, 10) k-hop from
    sealed seeds; the run tier's kernel rows at the 0.9 push stream; at
    the last fraction, unseal half the sealed vertices."""
    from repro_torch import backend
    from repro_torch.core import csr as C
    from repro_torch.core.cblist import to_coo
    from repro_torch.core.engine import process_edge_push, sweep_plan
    from repro_torch.core.tiered import seal, tier_from_cbl, unseal
    from repro_torch.core.updates import read_edges
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.graph.sampler import sample_subgraph
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    nv = cbl.capacity_vertices
    x = torch.rand(nv, generator=gen, device=dev)
    msg = lambda xs, w: xs      # noqa: E731 — PageRank's message
    plan = sweep_plan(cbl, pull=False)
    ref_push = process_edge_push(cbl, x, dense_f=msg, impl="cuda", plan=plan)
    ref64 = process_edge_push(cbl, x.double(), dense_f=msg, impl="torch")
    delta_push_ms = timer.ms(lambda: process_edge_push(
        cbl, x, dense_f=msg, impl="cuda", plan=plan))
    del plan
    (ref_ranks, ref_iters), ref_pr_s = timer.wall(
        lambda: pagerank(cbl, impl="cuda", return_stats=True))
    # 2^20 point reads: half live pairs, half random pairs
    ls, ld, _, _ = to_coo(cbl)
    pick = torch.randint(0, ls.numel(), (TIER_READS // 2,), generator=gen,
                         device=dev)
    qs = torch.cat([ls[pick], torch.randint(0, nv, (TIER_READS // 2,),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)])
    qd = torch.cat([ld[pick], torch.randint(0, nv, (TIER_READS // 2,),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)])
    del ls, ld, pick
    ref_f, ref_w = read_edges(cbl, qs, qd)
    delta_read_ms = timer.ms(lambda: read_edges(cbl, qs, qd))
    out = dict(all_delta=dict(
        push_ms=delta_push_ms, pagerank_s=ref_pr_s, pagerank_iters=ref_iters,
        pagerank_ms_per_it=ref_pr_s * 1e3 / ref_iters,
        read_ms=delta_read_ms, num_blocks=cbl.store.num_blocks,
        found=int(ref_f.sum())), fractions=[], kernels=[])
    say("tier.all_delta", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                             for k, v in out["all_delta"].items()})
    tg0 = tier_from_cbl(cbl)
    n_live = int(cbl.n_vertices)
    for frac in TIER_FRACTIONS:
        tg, seal_s = timer.wall(lambda: seal(
            tg0, cold_mask_for_fraction(torch, cbl.v_deg, n_live, frac)))
        run = tg.runs
        _, stream_s = timer.wall(lambda: C._push_stream(run))
        dplan, dplan_s = timer.wall(lambda: sweep_plan(tg.delta, pull=False))
        before = dict(backend.LAUNCHES)
        y = process_edge_push(tg, x, dense_f=msg, impl="cuda", plan=dplan)
        for name in GRAPH_KERNELS:       # the delta's launch and the run's
            check(backend.LAUNCHES[name] == before[name] + 2,
                  f"tier {frac}: the tiered push launched {name} "
                  f"{backend.LAUNCHES[name] - before[name]} times, not 2")
        before = dict(backend.LAUNCHES)
        C.csr_push(run, x, dense_f=msg, impl="cuda")
        for name in GRAPH_KERNELS:
            check(backend.LAUNCHES[name] == before[name] + 1,
                  f"tier {frac}: the run-tier push did not launch {name}")
        err = float((y.double() - ref64).abs().max())
        check(torch.allclose(y.double(), ref64, rtol=SEG_RTOL, atol=SEG_ATOL),
              f"tier {frac}: the tiered push is off the float64 all-delta "
              f"sum by {err:.3e}")
        push_ms = timer.ms(lambda: process_edge_push(
            tg, x, dense_f=msg, impl="cuda", plan=dplan))
        run_push_ms = timer.ms(lambda: C.csr_push(run, x, dense_f=msg,
                                                  impl="cuda"))
        if frac == TIER_KERNEL_FRACTION:
            xs = x.reshape(nv, 1)
            n = run.n_live
            out["kernels"] = [
                time_gather(torch, timer, f"tier run push x[src] ({frac} "
                            f"sealed)", xs, run.push_src),
                time_segment_sum(
                    torch, timer, f"tier run push ({frac} sealed)",
                    x[run.push_src.long()][:, None].contiguous(),
                    run.push_ptr, run.partition("push", 1),
                    x[run.row[:n].long()][:, None].contiguous(),
                    run.indices[:n].contiguous())]
        del dplan
        backend.reset_launch_counts()
        (ranks, iters), pr_s = timer.wall(
            lambda: pagerank(tg, impl="cuda", return_stats=True))
        check(backend.PLAN_BUILDS == 1, f"tier {frac}: PageRank built "
              f"{backend.PLAN_BUILDS} sweep plans, not the delta's one")
        rel = float(((ranks - ref_ranks).abs()
                     / ref_ranks.abs().clamp(min=1e-30)).max())
        check(torch.allclose(ranks, ref_ranks, rtol=1e-4, atol=0.0),
              f"tier {frac}: PageRank off the all-delta ranks by {rel:.3e}")
        f, w = read_edges(tg, qs, qd)
        check(torch.equal(f, ref_f) and torch.equal(w, ref_w),
              f"tier {frac}: point reads differ from the all-delta reads")
        read_ms = timer.ms(lambda: read_edges(tg, qs, qd))
        cold = torch.nonzero(tg.sealed & (tg.v_deg > 0)).squeeze(1)
        seeds = cold[torch.randint(0, cold.numel(), (TIER_KHOP_SEEDS,),
                                   generator=gen, device=dev)].to(torch.int32)
        sg = sample_subgraph(tg, seeds, torch.Generator(device=dev)
                             .manual_seed(seed + 43), fanout=(15, 10))
        found, _ = read_edges(tg, sg.src, sg.dst)
        check(bool(found[sg.valid].all()) and int(sg.valid.sum()) > 0,
              f"tier {frac}: a k-hop edge from sealed seeds is not live")
        row = dict(
            fraction=frac, seal_s=seal_s,
            sealed_fraction=float(tg.sealed_fraction),
            sealed_vertices=int((tg.sealed & (tg.v_deg > 0)).sum()),
            run_lanes=run.n_live,
            run_capacity=run.capacity, delta_blocks=tg.num_blocks,
            stream_build_ms=stream_s * 1e3, delta_plan_ms=dplan_s * 1e3,
            push_ms=push_ms, run_push_ms=run_push_ms,
            all_delta_push_ms=delta_push_ms, push_max_abs_err=err,
            pagerank_ms_per_it=pr_s * 1e3 / iters, pagerank_iters=iters,
            all_delta_pagerank_ms_per_it=ref_pr_s * 1e3 / ref_iters,
            pagerank_max_rel=rel, read_ms=read_ms,
            all_delta_read_ms=delta_read_ms,
            khop_valid=int(sg.valid.sum()),
            launches={k: backend.LAUNCHES[k] for k in GRAPH_KERNELS})
        if frac == TIER_FRACTIONS[-1]:
            half = tg.sealed & (torch.arange(nv, device=dev) % 2 == 0)
            half &= tg.v_deg > 0
            back, unseal_s = timer.wall(lambda: unseal(tg, half))
            check(int(back.num_edges) == int(tg.num_edges)
                  and back.run_version == tg.run_version + 1,
                  "tier: unseal lost edges")
            f, w = read_edges(back, qs, qd)
            check(torch.equal(f, ref_f) and torch.equal(w, ref_w),
                  "tier: point reads after the unseal differ")
            row.update(unseal_s=unseal_s,
                       unsealed_vertices=int(half.sum()),
                       unseal_sealed_fraction=float(back.sealed_fraction))
            del back
        out["fractions"].append(row)
        say("tier", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                       for k, v in row.items()})
        del tg, run, ranks, y, sg
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def tier_service(torch, timer, dev, coo, nv, untiered, untiered_warm, plain,
                 seed):
    """The tiered twin of the graph cell's service:
    ``GraphService.from_coo(..., seal_after_epochs=TIER_K)`` over the same
    graph, fed the same three rounds of updates with every launch counter
    at 0: flush reports and point reads bit for bit the untiered service's
    (``untiered``, recorded by service_phase), the warm PageRank within
    rtol 1e-4 of its."""
    from repro_torch import backend
    from repro_torch.core.tiered import TieredGraph
    from repro_torch.data.synthetic import update_stream
    from repro_torch.stream.service import GraphService
    src, dst, w = coo
    torch.cuda.reset_peak_memory_stats()
    svc, build_s = timer.wall(lambda: GraphService.from_coo(
        src, dst, w, num_vertices=nv,
        log_capacity=2 ** 21, seal_after_epochs=TIER_K, device=dev))
    backend.reset_launch_counts()
    _, cold_s = timer.wall(lambda: svc.analytics("pagerank"))
    out = dict(from_coo_s=build_s, pagerank_cold_s=cold_s,
               pagerank_cold_iters=svc.last_iterations, rounds=[])
    stream = update_stream(svc.snapshot.cbl.capacity_vertices, (src, dst),
                           UPDATES_PER_ROUND, ROUNDS,
                           delete_frac=DELETE_FRAC, seed=seed + 1, device=dev)
    for r, (s, d, uw, op) in enumerate(stream):
        _, apply_s = timer.wall(lambda: svc.apply(s, d, uw, op))
        rep, flush_s = timer.wall(svc.flush)
        ref_rep, ref_fi, ref_wi, ref_fd, ref_wd = untiered[r]
        check(rep[:4] == ref_rep[:4],
              f"tier round {r}: flush report {rep[:4]} differs from the "
              f"untiered service's {ref_rep[:4]}")
        qs_i, qd_i, _, qs_d, qd_d = read_pairs(s, d, uw, op)
        (fi, wi), read_s = timer.wall(lambda: svc.query_edges(qs_i, qd_i))
        fd, wd = svc.query_edges(qs_d, qd_d)
        check(all(torch.equal(a, b) for a, b in
                  ((fi, ref_fi), (wi, ref_wi), (fd, ref_fd), (wd, ref_wd))),
              f"tier round {r}: point reads differ from the untiered "
              f"service's")
        tg = svc.snapshot.cbl
        check(isinstance(tg, TieredGraph), "tier: the service is untiered")
        row = dict(round=r, flush_s=flush_s,
                   flush_s_per_1M=flush_s * 1e6 / s.numel(),
                   untiered_flush_s_per_1M=plain["rounds"][r]["flush_s"]
                   * 1e6 / s.numel(), apply_s=apply_s,
                   maintenance=rep.maintenance.kind,
                   untiered_maintenance=ref_rep.maintenance.kind,
                   grow_retries=rep.grow_retries, seals=svc.stats.seals,
                   unseals=svc.stats.unseals,
                   seal_edges=svc.stats.seal_edges,
                   unseal_edges=svc.stats.unseal_edges,
                   tier_version=list(svc.snapshot.tier_version),
                   sealed_fraction=float(tg.sealed_fraction),
                   delta_blocks=tg.num_blocks, read_s=read_s)
        out["rounds"].append(row)
        say("tier.flush", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                             for k, v in row.items()})
    check(svc.stats.seals >= 1 and svc.stats.unseals >= 1,
          f"tier: {svc.stats.seals} seals and {svc.stats.unseals} unseals "
          f"in {ROUNDS} rounds (K = {TIER_K})")
    ranks, warm_s = timer.wall(lambda: svc.analytics("pagerank"))
    iters = svc.last_iterations
    rel = float(((ranks - untiered_warm).abs()
                 / untiered_warm.abs().clamp(min=1e-30)).max())
    check(torch.allclose(ranks, untiered_warm, rtol=1e-4, atol=0.0),
          f"tier: warm PageRank off the untiered service's by {rel:.3e}")
    plain_warm = plain["pagerank_warm"]
    out.update(pagerank_warm_s=warm_s, pagerank_warm_iters=iters,
               pagerank_warm_ms_per_it=warm_s * 1e3 / max(iters, 1),
               untiered_pagerank_warm_ms_per_it=plain_warm["seconds"] * 1e3
               / max(plain_warm["iterations"], 1),
               pagerank_max_rel=rel, max_memory_allocated=(
                   torch.cuda.max_memory_allocated()),
               launches={k: backend.LAUNCHES[k] for k in
                         GRAPH_KERNELS + WALK_KERNELS + PLAN_PATCH_KERNELS})
    for name in GRAPH_KERNELS + ("chain_walk_locate",):
        check(out["launches"][name] > 0,
              f"tier: {name} never launched on the tiered service's path")
    say("tier.warm", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in out.items() if k != "rounds"})
    return out


# ---------------------------------------------------------------------------
# the sharded stack: GTChain-balanced shards stacked on the one card
# ---------------------------------------------------------------------------

def pagerank64(torch, cbl, iters: int, damping: float = 0.85):
    """The PageRank program's iteration in float64 over ``cbl`` through the
    plain route, ``iters`` times from the cold start."""
    from repro_torch.core.engine import process_edge_push
    nv = cbl.capacity_vertices
    live = torch.arange(nv, device=cbl.device) < cbl.n_vertices
    n = cbl.n_vertices.clamp(min=1).double()
    deg0 = cbl.v_deg
    deg = deg0.clamp(min=1).double()
    dangling = live & (deg0 == 0)
    r = torch.where(live, 1.0 / n, 0.0).double()
    for _ in range(iters):
        x = torch.where(live, r / deg, 0.0)
        acc = process_edge_push(cbl, x, dense_f=lambda xs, w: xs,
                                impl="torch")
        dang = torch.where(dangling, r, 0.0).sum()
        r = torch.where(live, (1 - damping) / n + damping * (acc + dang / n),
                        0.0)
    return r


def read_batch(torch, cbl, n, gen):
    """``n`` point reads: half live pairs of ``cbl``, half random pairs."""
    from repro_torch.core.cblist import to_coo
    nv = cbl.capacity_vertices
    dev = cbl.device
    ls, ld, _, _ = to_coo(cbl)
    pick = torch.randint(0, ls.numel(), (n // 2,), generator=gen, device=dev)
    qs = torch.cat([ls[pick], torch.randint(0, nv, (n // 2,), generator=gen,
                                            device=dev, dtype=torch.int32)])
    qd = torch.cat([ld[pick], torch.randint(0, nv, (n // 2,), generator=gen,
                                            device=dev, dtype=torch.int32)])
    return qs, qd


def last_route(obs):
    """(lane_cap, n_rounds, skew) of the last sharded write recorded under
    ``obs``: the route plan its ``flush.upsert.fused`` span carries and the
    ``flush.shard_skew`` series."""
    span = [e for e in obs.tracer().events
            if e["name"] == "flush.upsert.fused"][-1]
    skew = obs.registry().series("flush.shard_skew").values()[-1]
    return span["args"]["lane_cap"], span["args"]["rounds"], skew


def plan_fields(plan):
    return dict(strategy=plan.strategy, impl=plan.impl,
                partition=plan.partition, lookahead=plan.lookahead,
                contiguity=round(plan.contiguity, 4),
                cut_fraction=round(plan.cut_fraction, 4),
                route_lane_cap=plan.route_lane_cap,
                route_rounds=plan.route_rounds)


def spill_batch(torch, cbl, gen):
    """SHARD_SPILL_UPDATES updates keyed to the top hub of ``cbl``: 80 %
    inserts of destinations it does not reach, 20 % deletes of its live
    edges (the graph cell's traffic mix)."""
    from repro_torch.core.cblist import to_coo
    nv = cbl.capacity_vertices
    dev = cbl.device
    hub = int(torch.argmax(cbl.v_deg))
    s, d, _, ok = to_coo(cbl)
    live = torch.unique(d[ok & (s == hub)])
    n_del = min(int(SHARD_SPILL_UPDATES * SHARD_SPILL_DELETE_FRAC),
                live.numel())
    dels = live[torch.randperm(live.numel(), generator=gen,
                               device=dev)[:n_del]]
    reach = torch.zeros(nv, dtype=torch.bool, device=dev)
    reach[live.long()] = True
    fresh = torch.nonzero(~reach).squeeze(1)
    n_ins = SHARD_SPILL_UPDATES - n_del
    ins = fresh[torch.randperm(fresh.numel(), generator=gen,
                               device=dev)[:n_ins]].to(torch.int32)
    dst = torch.cat([ins, dels.to(torch.int32)])
    src = torch.full_like(dst, hub)
    w = torch.rand(dst.numel(), generator=gen, device=dev)
    op = torch.cat([torch.ones(ins.numel(), dtype=torch.int32, device=dev),
                    -torch.ones(n_del, dtype=torch.int32, device=dev)])
    return hub, (src, dst, w, op)


def shard_run(torch, timer, dev, coo, nv, S, untiered, ref, plain, seed,
              profile=False):
    """One shard count: ``GraphService.from_coo(..., n_shards=S)`` over the
    graph cell's graph, its three rounds, reads, PageRank, BFS, CC and
    plans with every launch counter at 0 (each checked against the
    unsharded service), then the spill batch (S = SHARD_SPILL_S) or the
    tiered step (S = SHARD_TIER_S).  With ``profile`` the last flush and
    the PageRank at S = SHARD_SPILL_S run under ``torch.profiler``."""
    import repro_torch.obs as obs
    from repro_torch import backend
    from repro_torch.core.engine import in_degrees
    from repro_torch.core.traversal import (gtchain_partition,
                                            partition_balance,
                                            vertex_table_partition)
    from repro_torch.core.updates import batch_update_stats, read_edges
    from repro_torch.data.synthetic import update_stream
    from repro_torch.distributed.graph import ShardedCBList, cut_fraction
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.stream.service import GraphService
    src, dst, w = coo
    backend.reset_launch_counts()
    svc, build_s = timer.wall(lambda: GraphService.from_coo(
        src, dst, w, num_vertices=nv, log_capacity=2 ** 21, n_shards=S,
        device=dev))
    scbl = svc.snapshot.cbl
    check(isinstance(scbl, ShardedCBList) and scbl.n_shards == S,
          f"shard {S}: the service is not sharded {S} ways")
    edges = scbl.shards.v_deg.double().sum(1)
    out = dict(n_shards=S, build_s=build_s,
               unsharded_build_s=plain["from_coo_seconds"],
               blocks_per_shard=scbl.num_blocks,
               cut_fraction=float(cut_fraction(scbl)),
               partition_balance=float(partition_balance(
                   ref["cbl"], gtchain_partition(ref["cbl"], S))),
               vertex_partition_balance=float(partition_balance(
                   ref["cbl"], vertex_table_partition(ref["cbl"], S))),
               shard_edge_balance=float(edges.max() / edges.mean()),
               rounds=[])
    say("shard.build", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                          for k, v in out.items() if k != "rounds"})
    stream = update_stream(nv, (src, dst), UPDATES_PER_ROUND, ROUNDS,
                           delete_frac=DELETE_FRAC, seed=seed + 1,
                           device=dev)
    for r, (s, d, uw, op) in enumerate(stream):
        svc.apply(s, d, uw, op)
        obs.reset()
        obs.enable()
        try:
            if profile and S == SHARD_SPILL_S and r == ROUNDS - 1:
                rep, prof = profiled(torch, svc.flush)
                flush_s = prof["wall_s"]
                out["profile_flush"] = prof
            else:
                rep, flush_s = timer.wall(svc.flush)
            lane_cap, n_rounds, skew = last_route(obs)
        finally:
            obs.disable()
            obs.reset()
        ref_rep, ref_fi, ref_wi, ref_fd, ref_wd = untiered[r]
        check(rep[:4] == ref_rep[:4],
              f"shard {S} round {r}: flush report {rep[:4]} differs from "
              f"the unsharded service's {ref_rep[:4]}")
        qs_i, qd_i, _, qs_d, qd_d = read_pairs(s, d, uw, op)
        fi, wi = svc.query_edges(qs_i, qd_i)
        fd, wd = svc.query_edges(qs_d, qd_d)
        check(all(torch.equal(a, b) for a, b in
                  ((fi, ref_fi), (wi, ref_wi), (fd, ref_fd), (wd, ref_wd))),
              f"shard {S} round {r}: point reads differ from the unsharded "
              f"service's")
        row = dict(round=r, flush_s=flush_s,
                   flush_s_per_1M=flush_s * 1e6 / s.numel(),
                   unsharded_flush_s_per_1M=plain["rounds"][r]["flush_s"]
                   * 1e6 / s.numel(), lane_cap=lane_cap, n_rounds=n_rounds,
                   skew=skew, grow_retries=rep.grow_retries,
                   maintenance=rep.maintenance.kind,
                   blocks_per_shard=svc.snapshot.cbl.num_blocks)
        out["rounds"].append(row)
        say("shard.flush", S=S, **{k: (f"{v:.4g}" if isinstance(v, float)
                                       else v) for k, v in row.items()})
    scbl = svc.snapshot.cbl
    f, wq = read_edges(scbl, ref["qs"], ref["qd"])
    check(torch.equal(f, ref["found"]) and torch.equal(wq, ref["w"]),
          f"shard {S}: 2^20 point reads differ from the unsharded graph's")
    read_ms = timer.ms(lambda: read_edges(scbl, ref["qs"], ref["qd"]))
    check(torch.equal(in_degrees(scbl), ref["in_degrees"]),
          f"shard {S}: in-degrees differ from the unsharded graph's")
    if profile and S == SHARD_SPILL_S:
        (ranks, iters), prof = profiled(
            torch, lambda: pagerank(scbl, impl="cuda", return_stats=True))
        pr_s = prof["wall_s"]
        out["profile_pagerank"] = prof
    else:
        (ranks, iters), pr_s = timer.wall(
            lambda: pagerank(scbl, impl="cuda", return_stats=True))
    r64 = pagerank64(torch, ref["cbl"], iters)
    rel64 = float(((ranks.double() - r64).abs()
                   / r64.abs().clamp(min=1e-30)).max())
    check(torch.allclose(ranks.double(), r64, rtol=SEG_RTOL, atol=0.0),
          f"shard {S}: PageRank off the float64 ranks by {rel64:.3e}")
    bfs, bfs_s = timer.wall(lambda: svc.analytics("bfs", source=0))
    check(torch.equal(bfs, ref["bfs"]),
          f"shard {S}: BFS levels differ from the unsharded service's")
    cc, cc_s = timer.wall(lambda: svc.analytics("cc"))
    check(torch.equal(cc, ref["cc"]),
          f"shard {S}: CC labels differ from the unsharded service's")
    plans = {task: plan_fields(svc.plan(task))
             for task in ("scan_all", "batch_update")}
    launches = {k: backend.LAUNCHES[k] for k in GRAPH_KERNELS + WALK_KERNELS}
    for name in SHARD_KERNELS:
        check(launches[name] > 0,
              f"shard {S}: {name} never launched on the shard path")
    out.update(read_ms=read_ms, unsharded_read_ms=ref["read_ms"],
               pagerank_iters=iters, pagerank_ms_per_it=pr_s * 1e3 / iters,
               unsharded_pagerank_ms_per_it=ref["pagerank_ms_per_it"],
               pagerank_max_rel_f64=rel64, bfs_s=bfs_s,
               unsharded_bfs_s=ref["bfs_s"], cc_s=cc_s,
               unsharded_cc_s=ref["cc_s"], plans=plans, launches=launches)
    say("shard.path", S=S, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                              for k, v in out.items()
                              if k in ("read_ms", "unsharded_read_ms",
                                       "pagerank_iters",
                                       "pagerank_ms_per_it",
                                       "unsharded_pagerank_ms_per_it",
                                       "pagerank_max_rel_f64", "bfs_s",
                                       "unsharded_bfs_s", "cc_s",
                                       "unsharded_cc_s", "launches")})
    for task, fields in plans.items():
        say("shard.plan", S=S, task=task, **fields)
    gen = torch.Generator(device=dev).manual_seed(seed + 61 + S)
    if S == SHARD_SPILL_S:
        hub, batch = spill_batch(torch, ref["cbl"], gen)
        (ref_out, ref_st), ref_s = timer.wall(
            lambda: batch_update_stats(ref["cbl"], *batch))
        obs.reset()
        obs.enable()
        try:
            (got, st), spill_s = timer.wall(
                lambda: batch_update_stats(scbl, *batch))
            lane_cap, n_rounds, skew = last_route(obs)
        finally:
            obs.disable()
            obs.reset()
        stats = [int(x) for x in torch.stack(list(st)).tolist()]
        ref_stats = [int(x) for x in torch.stack(list(ref_st)).tolist()]
        check(stats == ref_stats,
              f"shard {S}: spill batch stats {stats} differ from the "
              f"unsharded {ref_stats}")
        check(n_rounds >= 2, f"shard {S}: the spill batch took {n_rounds} "
              f"round(s), not >= 2")
        qs, qd = batch[0], batch[1]
        a = read_edges(got, qs, qd)
        b = read_edges(ref_out, qs, qd)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"shard {S}: reads after the spill batch differ")
        out["spill"] = dict(hub=hub, hub_degree=int(ref["cbl"].v_deg[hub]),
                            updates=int(qs.numel()), stats=stats,
                            lane_cap=lane_cap, n_rounds=n_rounds, skew=skew,
                            seconds=spill_s, unsharded_seconds=ref_s)
        say("shard.spill", S=S, **{k: (f"{v:.4g}" if isinstance(v, float)
                                       else v)
                                   for k, v in out["spill"].items()})
        del got, ref_out
    if S == SHARD_TIER_S:
        out["tier"] = shard_tier_step(torch, timer, dev, scbl, ref, S)
    return out


def shard_tier_step(torch, timer, dev, scbl, ref, S):
    """A tiered shard stack: seal SHARD_TIER_FRACTION of the edges
    (low-degree vertices first), then one PageRank and the 2^20 reads,
    each against the unsharded graph's."""
    from repro_torch import backend
    from repro_torch.core.tiered import seal, tier_from_cbl
    from repro_torch.core.updates import read_edges
    from repro_torch.graph.algorithms import pagerank
    n_live = int(scbl.n_vertices)
    tg, seal_s = timer.wall(lambda: seal(tier_from_cbl(scbl),
                                         cold_mask_for_fraction(
                                             torch, scbl.v_deg, n_live,
                                             SHARD_TIER_FRACTION)))
    check(tg.is_sharded and len(tg.runs) == S,
          f"shard tier: not a tiered stack of {S} runs")
    backend.reset_launch_counts()
    (ranks, iters), pr_s = timer.wall(
        lambda: pagerank(tg, impl="cuda", return_stats=True))
    launches = {k: backend.LAUNCHES[k] for k in GRAPH_KERNELS}
    for name in GRAPH_KERNELS:             # S delta shards + S runs a sweep
        check(launches[name] >= 2 * S * iters,
              f"shard tier: {name} launched {launches[name]} times in "
              f"{iters} iterations over {S} shards and {S} runs")
    rel = float(((ranks - ref["ranks"]).abs()
                 / ref["ranks"].abs().clamp(min=1e-30)).max())
    check(torch.allclose(ranks, ref["ranks"], rtol=1e-4, atol=0.0),
          f"shard tier: PageRank off the unsharded ranks by {rel:.3e}")
    f, w = read_edges(tg, ref["qs"], ref["qd"])
    check(torch.equal(f, ref["found"]) and torch.equal(w, ref["w"]),
          "shard tier: point reads differ from the unsharded graph's")
    read_ms = timer.ms(lambda: read_edges(tg, ref["qs"], ref["qd"]))
    out = dict(seal_s=seal_s, sealed_fraction=float(tg.sealed_fraction),
               run_lanes=sum(g.n_live for g in tg.runs),
               delta_blocks_per_shard=tg.num_blocks,
               pagerank_ms_per_it=pr_s * 1e3 / iters, pagerank_iters=iters,
               pagerank_max_rel=rel, read_ms=read_ms, launches=launches)
    say("shard.tier", S=S, **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                              for k, v in out.items()})
    return out


def shard_phase(torch, timer, dev, coo, nv, untiered, shard_ref, report,
                seed, profile=False):
    """The graph cell's graph behind ``GraphService(..., n_shards=S)`` for
    each of SHARD_COUNTS, every number beside the unsharded service's in
    this call (its graph after the three rounds: ``shard_ref``)."""
    from repro_torch.core.engine import in_degrees
    from repro_torch.core.updates import read_edges
    from repro_torch.graph.algorithms import bfs, connected_components
    from repro_torch.graph.algorithms import pagerank
    torch.cuda.reset_peak_memory_stats()
    cbl = shard_ref["cbl"]
    gen = torch.Generator(device=dev).manual_seed(seed + 51)
    qs, qd = read_batch(torch, cbl, SHARD_READS, gen)
    found, w = read_edges(cbl, qs, qd)
    (ranks, iters), pr_s = timer.wall(
        lambda: pagerank(cbl, impl="cuda", return_stats=True))
    bfs_ref, bfs_s = timer.wall(lambda: bfs(cbl, 0, impl="cuda"))
    cc_ref, cc_s = timer.wall(lambda: connected_components(cbl,
                                                           impl="cuda"))
    check(torch.equal(bfs_ref, shard_ref["bfs"])
          and torch.equal(cc_ref, shard_ref["cc"]),
          "shard: cold BFS / CC differ from the service's warm results")
    ref = dict(cbl=cbl, qs=qs, qd=qd, found=found, w=w, ranks=ranks,
               in_degrees=in_degrees(cbl), bfs=shard_ref["bfs"],
               cc=shard_ref["cc"], bfs_s=bfs_s, cc_s=cc_s,
               read_ms=timer.ms(lambda: read_edges(cbl, qs, qd)),
               pagerank_ms_per_it=pr_s * 1e3 / iters)
    plain = dict(report["service"], from_coo_seconds=report["graph"][
        "from_coo_seconds"])
    out = dict(runs=[])
    for S in SHARD_COUNTS:
        out["runs"].append(shard_run(torch, timer, dev, coo, nv, S,
                                     untiered, ref, plain, seed, profile))
        gc.collect()
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    say("shard.memory", max_memory_allocated=out["max_memory_allocated"])
    return out


# ---------------------------------------------------------------------------
# phase 5e: the shard axis across ranks
# ---------------------------------------------------------------------------

def coo_checksum(torch, src, dst, w):
    """Three sums that tell one regenerated graph cell's COO from
    another."""
    return [int(src.long().sum()), int(dst.long().sum()),
            float(w.double().sum())]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(torch, backend_name: str, rank: int, world: int,
               port: int) -> float:
    """A process group over ``world`` ranks on this host, with a timeout
    of SHARD_MESH_GROUP_TIMEOUT_S: a rank that never comes fails the
    collective waiting for it.  One all_reduce on the card sets up the
    backend's connections (NCCL makes its communicator at the first
    collective), so no later timing holds them.  Returns its seconds."""
    import datetime
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.init_process_group(
        backend_name, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_MESH_GROUP_TIMEOUT_S))
    dist.all_reduce(torch.ones(1, device="cuda"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def collective_times(torch, dev, mesh, nv_cap: int) -> dict:
    """Host milliseconds a call, over COLLECTIVE_REPS synchronised calls,
    of one sum sweep's cross-rank combine of a float32 [nv_cap] partial:
    the mesh's own combine under REDUCE_MODE (nothing on a mesh axis of 1;
    None on a rank outside the mesh) and one all_reduce over the whole
    group."""
    import torch.distributed as dist

    import repro_torch.distributed.graph as tdist
    x = torch.rand(nv_cap, device=dev)

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / COLLECTIVE_REPS

    return dict(combine_ms=per_call(lambda: tdist._cross_shard_combine(
                    x.clone(), "sum", mesh)) if tdist._member(mesh) else None,
                all_reduce_ms=per_call(lambda: dist.all_reduce(x.clone())),
                collective_bytes=nv_cap * 4)


def shard_mesh_run(torch, timer, dev, S: int, inputs: dict) -> dict:
    """One shard count on the process group this process is in: the graph
    cell's graph (made again from the seed) behind
    ``GraphService.from_coo(..., n_shards=S)``, which lays the shards over
    ``shard_mesh(S)``, with the launch counters at 0: the three rounds with
    their point reads, the 2^20 reads, in-degrees, a cold PageRank through
    the kernels (then a warm one: the first call also pays the backend's
    first use of each collective at this size), BFS and CC through the
    service.  Everything the checks read comes back on the host."""
    import torch.distributed as dist

    import repro_torch.distributed.graph as tdist
    from repro_torch import backend
    from repro_torch.core.engine import in_degrees
    from repro_torch.core.updates import read_edges
    from repro_torch.data.synthetic import rmat_edges, update_stream
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.stream.service import GraphService
    nv, seed = inputs["nv"], inputs["seed"]
    src, dst = rmat_edges(nv, inputs["ne"], seed=seed, device=dev)
    wgen = torch.Generator(device=dev).manual_seed(seed + 3)
    w = 0.1 + 0.9 * torch.rand(inputs["ne"], generator=wgen, device=dev)
    check(coo_checksum(torch, src, dst, w) == inputs["checksum"],
          "shard mesh: the regenerated graph differs from the graph cell's")
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    svc, build_s = timer.wall(lambda: GraphService.from_coo(
        src, dst, w, num_vertices=nv, log_capacity=2 ** 21, n_shards=S,
        device=dev))
    scbl = svc.snapshot.cbl
    mesh = scbl.mesh
    check(mesh is not None and scbl.n_shards == S
          and len(scbl.views) == S // mesh.size(),
          f"shard mesh S={S}: the service's shards are not on the mesh")
    stream = update_stream(nv, (src, dst), UPDATES_PER_ROUND, ROUNDS,
                           delete_frac=DELETE_FRAC, seed=seed + 1,
                           device=dev)
    rounds = []
    for s, d, uw, op in stream:
        svc.apply(s, d, uw, op)
        rep, flush_s = timer.wall(svc.flush)
        qs_i, qd_i, _, qs_d, qd_d = read_pairs(s, d, uw, op)
        reads = svc.query_edges(qs_i, qd_i) + svc.query_edges(qs_d, qd_d)
        rounds.append(dict(report=tuple(rep[:4]), flush_s=flush_s,
                           flush_s_per_1M=flush_s * 1e6 / s.numel(),
                           grow_retries=rep.grow_retries,
                           maintenance=rep.maintenance.kind,
                           reads=[x.cpu() for x in reads]))
    scbl = svc.snapshot.cbl
    qs, qd = inputs["qs"].to(dev), inputs["qd"].to(dev)
    found, wq = read_edges(scbl, qs, qd)
    read_ms = timer.ms(lambda: read_edges(scbl, qs, qd))
    indeg = in_degrees(scbl)
    (ranks, iters), pr_s = timer.wall(
        lambda: pagerank(scbl, impl="cuda", return_stats=True))
    bfs = svc.analytics("bfs", source=0)
    cc = svc.analytics("cc")
    launches = {k: backend.LAUNCHES[k] for k in GRAPH_KERNELS + WALK_KERNELS}
    (again, iters2), warm_s = timer.wall(
        lambda: pagerank(scbl, impl="cuda", return_stats=True))
    check(iters2 == iters and torch.equal(again, ranks),
          f"shard mesh S={S}: a second PageRank differs from the first")
    peak = torch.cuda.max_memory_allocated()
    out = dict(backend=dist.get_backend(), world=dist.get_world_size(),
               rank=dist.get_rank(), n_shards=S, mesh_axis=mesh.size(),
               shards_per_rank=len(scbl.views),
               reduce_mode=tdist.REDUCE_MODE, build_s=build_s,
               read_ms=read_ms, pagerank_iters=iters,
               pagerank_ms_per_it=pr_s * 1e3 / iters,
               warm_pagerank_ms_per_it=warm_s * 1e3 / iters,
               launches=launches,
               max_memory_allocated=peak,
               **collective_times(torch, dev, mesh,
                                  scbl.capacity_vertices))
    out["rounds"] = rounds
    out["outputs"] = dict(found=found.cpu(), w=wq.cpu(),
                          in_degrees=indeg.cpu(), ranks=ranks.cpu(),
                          bfs=bfs.cpu(), cc=cc.cpu())
    return out


def shard_mesh_child(rank: int, world: int, port: int, backend_name: str,
                     work_dir: str) -> None:
    """One spawned rank of phase 5e's leg (b): it loads the kernels phase 1
    built, joins the group, runs every SHARD_MESH_COUNTS count and leaves
    its results in ``work_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch import backend
    torch.cuda.set_device(0)
    backend.load_kernels()
    init_s = init_group(torch, backend_name, rank, world, port)
    try:
        inputs = torch.load(f"{work_dir}/inputs.pt")
        for S in SHARD_MESH_COUNTS:
            out = shard_mesh_run(torch, Timer(torch), torch.device("cuda"),
                                 S, inputs)
            out["group_init_s"] = init_s
            torch.save(out, f"{work_dir}/S{S}_rank{rank}.pt")
            del out
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, backend_name: str, work_dir: str,
                child=None, nprocs: int = SHARD_MESH_RANKS,
                join_s: float = SHARD_MESH_JOIN_S,
                what: str = "shard mesh") -> float:
    """``nprocs`` ranks of ``child`` (phase 5e's leg (b) by default)
    spawned on the one card, joined within ``join_s``; a rank that fails
    or outlives the limit fails the phase (every rank is stopped).
    Returns the wall seconds."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        child or shard_mesh_child,
        args=(nprocs, free_port(), backend_name, work_dir),
        nprocs=nprocs, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < join_s,
                  f"{what}: the spawned ranks did not finish within "
                  f"{join_s} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SmokeFailure(f"{what}: a spawned rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return time.perf_counter() - t0


def check_shard_mesh(torch, out: dict, ref: dict, r64, tag: str) -> float:
    """One rank's run against phase 5d's unsharded results: flush reports
    and point reads of every round, the 2^20 reads, in-degrees, BFS levels
    and CC labels bit for bit, PageRank within SEG_RTOL of the same
    iterations in float64, and the shard path's kernels launched.  Returns
    PageRank's largest relative error."""
    for r, (row, (ref_rep, ref_reads)) in enumerate(zip(out["rounds"],
                                                        ref["rounds"])):
        check(row["report"] == ref_rep,
              f"{tag} round {r}: flush report {row['report']} differs "
              f"from the unsharded service's {ref_rep}")
        check(all(torch.equal(a, b) for a, b in zip(row["reads"],
                                                    ref_reads)),
              f"{tag} round {r}: point reads differ from the unsharded "
              "service's")
    got = out["outputs"]
    for k in ("found", "w", "in_degrees", "bfs", "cc"):
        check(torch.equal(got[k], ref[k]),
              f"{tag}: {k} differs from the unsharded graph's")
    want = r64(out["pagerank_iters"])
    rel = float(((got["ranks"].double() - want).abs()
                 / want.abs().clamp(min=1e-30)).max())
    check(torch.allclose(got["ranks"].double(), want, rtol=SEG_RTOL,
                         atol=0.0),
          f"{tag}: PageRank off the float64 ranks by {rel:.3e}")
    for name in SHARD_KERNELS:
        check(out["launches"][name] > 0,
              f"{tag}: {name} never launched on this rank's shard path")
    return rel


def shard_mesh_line(out: dict, rel: float, leg: str) -> dict:
    row = {k: out[k] for k in (
        "backend", "world", "rank", "n_shards", "mesh_axis",
        "shards_per_rank", "reduce_mode", "build_s", "read_ms",
        "pagerank_iters", "pagerank_ms_per_it", "warm_pagerank_ms_per_it",
        "group_init_s", "combine_ms",
        "all_reduce_ms", "collective_bytes", "launches",
        "max_memory_allocated")}
    row.update(leg=leg, pagerank_max_rel_f64=rel,
               flush_s_per_1M=[r["flush_s_per_1M"] for r in out["rounds"]],
               grow_retries=[r["grow_retries"] for r in out["rounds"]],
               maintenance=[r["maintenance"] for r in out["rounds"]])
    say("shard.mesh", **{k: ("/".join(f"{x:.4g}" for x in v)
                             if k == "flush_s_per_1M"
                             else f"{v:.4g}" if isinstance(v, float) else v)
                         for k, v in row.items()},
        note="the code path on one card, not a multi-card speed")
    return row


def shard_mesh_phase(torch, timer, dev, coo, nv, untiered, shard_ref,
                     report, seed) -> dict:
    """Phase 5e: the graph cell's graph behind ``GraphService(...,
    n_shards=S)`` on a process group, leg (a) a one-rank NCCL group in this
    process, leg (b) SHARD_MESH_RANKS ranks spawned on the one card over
    gloo, each held to phase 5d's unsharded results (kept on the host), the
    ranks of leg (b) to each other."""
    import torch.distributed as dist

    from repro_torch.core.engine import in_degrees
    from repro_torch.core.updates import read_edges
    check(not dist.is_initialized(), "shard mesh: a process group is up "
          "before the phase")
    cbl = shard_ref["cbl"]
    gen = torch.Generator(device=dev).manual_seed(seed + 51)
    qs, qd = read_batch(torch, cbl, SHARD_READS, gen)
    found, w = read_edges(cbl, qs, qd)
    ref = dict(found=found.cpu(), w=w.cpu(), in_degrees=in_degrees(cbl).cpu(),
               bfs=shard_ref["bfs"].cpu(), cc=shard_ref["cc"].cpu(),
               rounds=[(tuple(rep[:4]), [x.cpu() for x in reads])
                       for rep, *reads in untiered])
    src, dst, wt = coo
    inputs = dict(nv=nv, ne=src.numel(), seed=seed, qs=qs.cpu(),
                  qd=qd.cpu(), checksum=coo_checksum(torch, src, dst, wt))
    r64_cache = {}

    def r64(iters):
        if iters not in r64_cache:
            r64_cache[iters] = pagerank64(torch, cbl, iters).cpu()
        return r64_cache[iters]

    rows, launches = [], {}
    t0 = time.perf_counter()
    init_s = init_group(torch, "nccl", 0, 1, free_port())
    try:
        for S in SHARD_MESH_COUNTS:
            out = shard_mesh_run(torch, timer, dev, S, inputs)
            out["group_init_s"] = init_s
            tag = f"shard mesh nccl S={S}"
            check(out["backend"] == "nccl" and out["mesh_axis"] == 1,
                  f"{tag}: not a one-rank NCCL mesh")
            rel = check_shard_mesh(torch, out, ref, r64, tag)
            rows.append(shard_mesh_line(out, rel, "nccl"))
            launches[f"nccl S={S} rank 0"] = out["launches"]
            del out
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    nccl_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        torch.save(inputs, f"{d}/inputs.pt")
        spawn_s = spawn_ranks(torch, "gloo", d)
        for S in SHARD_MESH_COUNTS:
            outs = [torch.load(f"{d}/S{S}_rank{r}.pt")
                    for r in range(SHARD_MESH_RANKS)]
            for r, out in enumerate(outs):
                tag = f"shard mesh gloo S={S} rank {r}"
                check(out["backend"] == "gloo"
                      and out["world"] == SHARD_MESH_RANKS
                      and out["mesh_axis"] == min(S, SHARD_MESH_RANKS),
                      f"{tag}: not a {SHARD_MESH_RANKS}-rank gloo mesh")
                rel = check_shard_mesh(torch, out, ref, r64, tag)
                rows.append(shard_mesh_line(out, rel, "gloo"))
                launches[f"gloo S={S} rank {r}"] = out["launches"]
                if r:
                    same = outs[0]
                    check([x["report"] for x in out["rounds"]]
                          == [x["report"] for x in same["rounds"]]
                          and all(torch.equal(out["outputs"][k],
                                              same["outputs"][k])
                                  for k in out["outputs"]),
                          f"{tag}: outputs differ from rank 0's")
            del outs
    out = dict(rows=rows, launches=launches, nccl_seconds=nccl_s,
               gloo_seconds=spawn_s)
    say("shard.mesh_phase", nccl_s=f"{nccl_s:.4g}", gloo_s=f"{spawn_s:.4g}",
        counts=list(SHARD_MESH_COUNTS), ranks=SHARD_MESH_RANKS)
    return out


# ---------------------------------------------------------------------------
# phase 5f: the serving frontend over the shard axis across ranks
# ---------------------------------------------------------------------------

def fresh_ticket_ids() -> None:
    """Number the next replay's tickets from 0: a k-hop draw's salt reads
    ticket ids, so two replays of one trace draw alike only from the same
    ids."""
    import itertools

    from repro_torch.serve import request
    request._ticket_ids = itertools.count()


def settle_flushes(torch, svc) -> None:
    """On a virtual clock device work takes no time: each poll of the
    shadow flush waits for the device first and finds the flush done, on
    every rank and in the reference alike (the wall-clock replay polls the
    event as it stands: ``del svc.flush_ready`` restores it)."""
    poll = svc.flush_ready

    def flush_ready():
        torch.cuda.synchronize()
        return poll()

    svc.flush_ready = flush_ready


def ticket_rows(torch, tickets, digest: bool) -> list:
    """(kind, tenant, done, shed, version, value, arrival, completion) a
    ticket, values on the host; with ``digest`` each value as the SHA-256
    of its pickled bytes (bit for bit across ranks without holding every
    PageRank vector)."""
    import hashlib
    import pickle

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.cpu().numpy()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v

    rows = []
    for t in tickets:
        value = host(t.value)
        if digest:
            value = hashlib.sha256(pickle.dumps(value, protocol=4)).hexdigest()
        rows.append((t.request.kind, t.request.tenant, t.done, t.shed,
                     t.version, value, t.t_arrival, t.t_done))
    return rows


def mesh_virtual_replay(svc, trace, skew: float):
    """The warm trace on a virtual clock that reads ``skew`` s ahead of
    rank 0's timeline, every ticket numbered from 0, drained and flushed:
    (frontend, tickets)."""
    from repro_torch.serve import ManualClock
    base = ManualClock()
    fresh_ticket_ids()
    front = serve_frontend(svc, lambda: base.t + skew)
    tickets = []
    for arr, req in trace:
        base.advance(max(arr - base.t, 0.0))
        tickets.append(front.submit(req))
        front.step()
    front.drain(flush=True)
    return front, tickets


def serve_mesh_run(torch, timer, dev, inputs: dict, coo=None) -> dict:
    """One rank of phase 5f on the process group this process is in: the
    graph cell's graph (made again from the seed unless ``coo`` is given)
    behind ``GraphService.from_coo(..., n_shards=SERVE_MESH_S,
    log_capacity=SERVE_LOG_CAPACITY)`` on ``shard_mesh``; the warm trace on
    a virtual clock (rank r's reads r * SERVE_MESH_SKEW_S ahead), then the
    timed open-loop replay of the trace on this rank's ``perf_counter``
    with the launch counters at 0.  Everything the checks read comes back
    on the host."""
    import torch.distributed as dist

    from repro_torch import backend
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.stream.service import GraphService
    nv, seed = inputs["nv"], inputs["seed"]
    if coo is None:
        src, dst = rmat_edges(nv, inputs["ne"], seed=seed, device=dev)
        wgen = torch.Generator(device=dev).manual_seed(seed + 3)
        w = 0.1 + 0.9 * torch.rand(inputs["ne"], generator=wgen, device=dev)
    else:
        src, dst, w = coo
    check(coo_checksum(torch, src, dst, w) == inputs["checksum"],
          "serve mesh: the regenerated graph differs from the graph cell's")
    rank = dist.get_rank()
    svc, build_s = timer.wall(lambda: GraphService.from_coo(
        src, dst, w, num_vertices=nv, log_capacity=SERVE_LOG_CAPACITY,
        n_shards=SERVE_MESH_S, device=dev))
    del src, dst, w
    mesh = svc.snapshot.cbl.mesh
    check(mesh is not None and svc.snapshot.cbl.n_shards == SERVE_MESH_S,
          "serve mesh: the service's shards are not on the mesh")
    settle_flushes(torch, svc)
    (vfront, vtickets), virtual_s = timer.wall(lambda: mesh_virtual_replay(
        svc, inputs["warm"], rank * SERVE_MESH_SKEW_S))
    del svc.flush_ready
    virtual = ticket_rows(torch, vtickets, digest=False)
    virtual_agreement = vfront.report()["agreement"]
    del vfront, vtickets

    trace = inputs["trace"]
    fresh_ticket_ids()
    front = serve_frontend(svc, time.perf_counter)
    epoch0, flushes0 = svc.epoch, svc.stats.flushes
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    done, wall = serve_replay(torch, front, trace, agreed=True)
    launches = {k: backend.LAUNCHES[k] for k in SERVE_MESH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    rep = front.report()
    lat_kind, lat_tenant = {}, {}
    for _, t, lat in done:
        lat_kind.setdefault(t.request.kind, []).append(lat)
        lat_tenant.setdefault(t.request.tenant, []).append(lat)
    agr = rep["agreement"]
    n_agree = sum(agr["collectives"].values())
    return dict(
        backend=dist.get_backend(), world=dist.get_world_size(), rank=rank,
        n_shards=SERVE_MESH_S, mesh_axis=mesh.size(), build_s=build_s,
        virtual_s=virtual_s, requests=len(trace), wall_s=wall,
        qps=len(trace) / wall,
        latency_by_kind={k: _pcts(v) for k, v in sorted(lat_kind.items())},
        latency_by_tenant={k: _pcts(v) for k, v in
                           sorted(lat_tenant.items())},
        flushes=svc.stats.flushes - flushes0,
        epoch_advances=svc.epoch - epoch0,
        agreement=agr, virtual_agreement=virtual_agreement,
        agreement_ms=agr["seconds"] * 1e3 / max(n_agree, 1),
        agreement_s=agr["seconds"],
        launches=launches, max_memory_allocated=peak, virtual=virtual,
        wall=ticket_rows(torch, sorted((t for _, t, _ in done),
                                       key=lambda t: t.id), digest=True))


def serve_mesh_child(rank: int, world: int, port: int, backend_name: str,
                     work_dir: str) -> None:
    """One spawned rank of phase 5f's leg (b): it loads the kernels phase 1
    built, joins the group, runs :func:`serve_mesh_run` and leaves its
    results in ``work_dir``."""
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch import backend
    torch.cuda.set_device(0)
    backend.load_kernels()
    init_s = init_group(torch, backend_name, rank, world, port)
    try:
        with open(f"{work_dir}/inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        out = serve_mesh_run(torch, Timer(torch), torch.device("cuda"),
                             inputs)
        out["group_init_s"] = init_s
        with open(f"{work_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def same_ticket(g, r, rtol: float = 0.0) -> bool:
    """One ticket row equal to another: all but the value exactly, the
    value bit for bit (an analytics vector within ``rtol``)."""
    import numpy as np
    if g[:5] != r[:5] or g[6:] != r[6:]:
        return False
    gv, rv = g[5], r[5]
    if isinstance(rv, dict):
        return gv.keys() == rv.keys() and all(
            np.array_equal(gv[k], rv[k]) for k in rv)
    if isinstance(rv, np.ndarray):
        return gv.shape == rv.shape and bool(np.allclose(
            gv, rv, rtol=rtol, atol=0.0))
    return gv == rv


def check_serve_mesh(out: dict, ref_virtual: list, tag: str) -> None:
    """One rank's run: every virtual-clock ticket against the one-process
    frontend's over the unsharded service (reads, degrees, receipts,
    k-hop draws, versions and times bit for bit, PageRank within
    SEG_RTOL), the wall-clock replay's tickets complete, none shed,
    versions never back per (tenant, kind), one agreement a step and a
    submit, and the path's four kernels launched."""
    check(len(out["virtual"]) == len(ref_virtual),
          f"{tag}: {len(out['virtual'])} virtual-clock tickets, not "
          f"{len(ref_virtual)}")
    bad = [i for i, (g, r) in enumerate(zip(out["virtual"], ref_virtual))
           if not same_ticket(g, r, SEG_RTOL)]
    check(not bad, f"{tag}: {len(bad)} virtual-clock tickets differ from "
          f"the one-process frontend's, the first #{bad[:1]}")
    rows = out["wall"]
    check(len(rows) == out["requests"] and all(r[2] for r in rows),
          f"{tag}: a ticket did not complete")
    check(not any(r[3] for r in rows), f"{tag}: a ticket was shed")
    last = {}
    for kind, tenant, _, _, version, *_ in rows:
        key = (tenant, kind)
        check(last.get(key, (-1, -1)) <= version,
              f"{tag}: {key} versions went from {last.get(key)} to "
              f"{version}")
        last[key] = version
    for agr in (out["agreement"], out["virtual_agreement"]):
        check(agr["mesh"] and agr["per_step"] == 1.0
              and agr["per_submit"] == 1.0,
              f"{tag}: agreements a step {agr['per_step']}, a submit "
              f"{agr['per_submit']}, not 1")
    for name in SERVE_MESH_KERNELS:
        check(out["launches"][name] > 0,
              f"{tag}: {name} never launched on this rank's serve path")


def serve_mesh_line(out: dict, leg: str, one: dict, cut: int) -> dict:
    row = {k: out[k] for k in (
        "backend", "world", "rank", "n_shards", "mesh_axis", "requests",
        "qps", "wall_s", "flushes", "epoch_advances", "agreement_ms",
        "agreement_s",
        "build_s", "virtual_s", "group_init_s", "launches",
        "max_memory_allocated")}
    agr = out["agreement"]
    row.update(leg=leg, mesh="shard", cut_from=cut or None,
               agreements_per_step=agr["per_step"],
               agreements_per_submit=agr["per_submit"],
               agreements=agr["collectives"],
               one_process_qps=one["qps"])
    lat = {f"{k}_p50_p99_ms": f"{v['p50_ms']:.3g}/{v['p99_ms']:.3g}"
           for part in ("latency_by_kind", "latency_by_tenant")
           for k, v in out[part].items()}
    one_lat = {f"one_process_{k}_p99_ms": f"{v['p99_ms']:.3g}"
               for k, v in one["latency_by_tenant"].items()}
    say("serve.mesh", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                         for k, v in row.items()}, **lat, **one_lat,
        note="the code path on one card, not a multi-card speed")
    row.update(latency_by_kind=out["latency_by_kind"],
               latency_by_tenant=out["latency_by_tenant"])
    return row


def serve_mesh_phase(torch, timer, dev, coo, nv, report, seed) -> dict:
    """Phase 5f: the graph cell's graph behind ``GraphService(...,
    n_shards=SERVE_MESH_S)`` on a process group and ``ServeFrontend`` on
    every rank, leg (a) a one-rank NCCL group in this process, leg (b)
    SHARD_MESH_RANKS ranks spawned on the one card over gloo; the
    virtual-clock tickets held to the one-process frontend over the
    unsharded service on rank 0's timeline, leg (b)'s ranks to each
    other."""
    import pickle

    import torch.distributed as dist

    from repro_torch.stream.service import GraphService
    check(not dist.is_initialized(), "serve mesh: a process group is up "
          "before the phase")
    src, dst, w = coo
    ref_svc = GraphService.from_coo(src, dst, w, num_vertices=nv,
                                    log_capacity=SERVE_LOG_CAPACITY,
                                    device=dev)
    cbl = ref_svc.snapshot.cbl
    (trace, warm), gen_s = timer.wall(lambda: (
        serve_trace(torch, dev, cbl, SERVE_REQUESTS, seed + 23),
        serve_trace(torch, dev, cbl, SERVE_WARM, seed + 29)))
    del cbl
    settle_flushes(torch, ref_svc)
    (_, tickets), ref_s = timer.wall(lambda: mesh_virtual_replay(
        ref_svc, warm, 0.0))
    ref_virtual = ticket_rows(torch, tickets, digest=False)
    del ref_svc, tickets
    gc.collect()
    torch.cuda.empty_cache()
    inputs = dict(nv=nv, ne=src.numel(), seed=seed, warm=warm, trace=trace,
                  checksum=coo_checksum(torch, src, dst, w))
    one = report["serve"]
    rows, launches = [], {}

    t0 = time.perf_counter()
    init_s = init_group(torch, "nccl", 0, 1, free_port())
    try:
        out = serve_mesh_run(torch, timer, dev, inputs, coo=coo)
        out["group_init_s"] = init_s
    finally:
        dist.destroy_process_group()
    tag = "serve mesh nccl rank 0"
    check(out["backend"] == "nccl" and out["mesh_axis"] == 1,
          f"{tag}: not a one-rank NCCL mesh")
    check_serve_mesh(out, ref_virtual, tag)
    rows.append(serve_mesh_line(out, "nccl", one, 0))
    launches["nccl rank 0"] = out["launches"]
    nccl_s = time.perf_counter() - t0
    del out
    gc.collect()
    torch.cuda.empty_cache()

    cut = len(trace) if SERVE_MESH_GLOO_REQUESTS < len(trace) else 0
    inputs["trace"] = trace[:SERVE_MESH_GLOO_REQUESTS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_mesh_") as d:
        with open(f"{d}/inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        spawn_s = spawn_ranks(torch, "gloo", d, child=serve_mesh_child,
                              what="serve mesh")
        outs = []
        for r in range(SHARD_MESH_RANKS):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    for r, out in enumerate(outs):
        tag = f"serve mesh gloo rank {r}"
        check(out["backend"] == "gloo" and out["world"] == SHARD_MESH_RANKS
              and out["mesh_axis"] == min(SERVE_MESH_S, SHARD_MESH_RANKS),
              f"{tag}: not a {SHARD_MESH_RANKS}-rank gloo mesh")
        check_serve_mesh(out, ref_virtual, tag)
        if r:
            check(all(same_ticket(g, h) for g, h in zip(
                      out["virtual"], outs[0]["virtual"])),
                  f"{tag}: virtual-clock tickets differ from rank 0's")
            check(out["wall"] == outs[0]["wall"],
                  f"{tag}: wall-clock tickets (values, versions, times) "
                  "differ from rank 0's")
        rows.append(serve_mesh_line(out, "gloo", one, cut))
        launches[f"gloo rank {r}"] = out["launches"]
    res = dict(rows=rows, launches=launches, nccl_seconds=nccl_s,
               gloo_seconds=spawn_s, trace_seconds=gen_s,
               reference_seconds=ref_s, warm_requests=len(warm),
               gloo_requests=len(inputs["trace"]))
    say("serve.mesh_phase", nccl_s=f"{nccl_s:.4g}", gloo_s=f"{spawn_s:.4g}",
        reference_s=f"{ref_s:.4g}", trace_s=f"{gen_s:.4g}",
        warm_requests=len(warm), requests=len(trace),
        gloo_requests=len(inputs["trace"]), ranks=SHARD_MESH_RANKS,
        n_shards=SERVE_MESH_S,
        checks="virtual_vs_one_process,complete,no_shed,versions,"
               "ranks_equal,launches")
    return res


# ---------------------------------------------------------------------------
# the FindNeighbor chain walk against its plain version
# ---------------------------------------------------------------------------

def live_edges(torch, cbl):
    """Every live (src, dst) of ``cbl`` on the device, in GTChain order."""
    from repro_torch.core.cblist import to_coo
    src, dst, _, _ = to_coo(cbl)
    return src, dst


def walk_bound(torch, cbl, rows, steps, n_bytes_io):
    """(bound ms, bound_by, bytes bound ms, latency bound ms): the blocks
    the walks must read (per distinct vertex its longest walk, a key row
    and a next pointer each) with the queries and outputs over the memory
    rate, against the longest walk's dependent round trips (one a block,
    one for the head) at WALK_STEP_NS each."""
    st = cbl.store
    per_vertex = torch.zeros(cbl.capacity_vertices, dtype=torch.long,
                             device=rows.device)
    per_vertex.scatter_reduce_(0, rows, steps.long(), "amax")
    blocks = int(per_vertex.sum())
    heads = int((per_vertex > 0).sum())
    nbytes = blocks * (st.block_width * 4 + 4) + heads * 4 + n_bytes_io
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    latency_ms = (int(steps.max()) + 1) * WALK_STEP_NS * 1e-6
    return max(bytes_ms, latency_ms), "bytes", bytes_ms, latency_ms, blocks


def walk_kernel_checks(torch, timer, dev, cbl, seed):
    """``chain_walk`` at the service graph's shapes: locate on 2^20 queries
    (half live pairs, half random pairs, the longest chain's vertex among
    both) and the rank walk on k-hop draws, each bit-identical to its plain
    version and on a repeat, timed beside it; ``read_edges`` under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.core.updates import read_edges
    from repro_torch.graph.sampler import draw_ranks
    from repro_torch.kernels.chain_walk import (locate, locate_ref,
                                                rank_walk, rank_walk_ref)
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    st = cbl.store
    nv = cbl.capacity_vertices
    ls, ld = live_edges(torch, cbl)
    half = WALK_QUERIES // 2
    pick = torch.randint(0, ls.numel(), (half,), generator=gen, device=dev)
    hub = int(torch.argmax(cbl.v_level))
    qs = torch.cat([ls[pick], torch.randint(0, nv, (half,), generator=gen,
                                            device=dev, dtype=torch.int32)])
    qd = torch.cat([ld[pick], torch.randint(0, nv, (half,), generator=gen,
                                            device=dev, dtype=torch.int32)])
    on_hub = (ls == hub).nonzero().squeeze(1)
    k = min(256, on_hub.numel())
    qs[:k], qd[:k] = hub, ld[on_hub[-k:]]      # the chain's far end
    qs[half:half + 256] = hub                   # mostly absent: all of it
    del ls, ld, pick, on_hub
    active = torch.ones(WALK_QUERIES, dtype=torch.bool, device=dev)
    args = (st.keys, st.nxt, cbl.v_head, qs, qd, active)
    got = locate(*args)
    ref = locate_ref(*args)
    for a, b in zip(got, ref):
        check(torch.equal(a, b), "chain_walk locate differs from its plain "
                                 "version")
    check(all(torch.equal(a, b) for a, b in zip(got, locate(*args))),
          "chain_walk locate differs on a repeat")
    found = got[0] != -1
    rows = qs.long().clamp(0, nv - 1)
    steps = torch.where(found, st.seq[got[0].clamp(min=0).long()] + 1,
                        cbl.v_level[rows])
    b_ms, b_by, bytes_ms, lat_ms, blocks = walk_bound(
        torch, cbl, rows, steps, WALK_QUERIES * (4 + 4 + 1 + 8))
    rows_out = [dict(
        name="chain_walk", shape=f"locate, {WALK_QUERIES} queries "
        f"(half live pairs), width {st.block_width}",
        found=int(found.sum()), longest_walk=int(steps.max()),
        blocks_read=blocks, max_abs_err=0.0,
        ms=timer.ms(lambda: locate(*args)),
        plain_ms=timer.ms(lambda: locate_ref(*args), 1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bytes_bound_ms=bytes_ms, latency_bound_ms=lat_ms,
        latency_ns_per_step=WALK_STEP_NS)]
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in rows_out[0].items()})

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        read_edges(cbl, qs[:65536], qd[:65536])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    say("checks.read_edges_sync", sync_debug_mode="error", raised=False)

    verts = torch.cat([qs[:16], qs[half:half + (1 << 16) - 16]])
    kk = SERVE_FANOUT[0]
    ranks = draw_ranks(cbl, verts, gen, kk)
    rrows = verts.long()
    deg = cbl.v_deg[rrows]
    heads = torch.where(deg > 0, cbl.v_head[rrows], -1).to(torch.int32)
    rargs = (st.keys, st.count, st.nxt, heads, ranks)
    rgot = rank_walk(*rargs)
    check(torch.equal(rgot, rank_walk_ref(*rargs)),
          "chain_walk rank walk differs from its plain version")
    check(torch.equal(rgot, rank_walk(*rargs)),
          "chain_walk rank walk differs on a repeat")
    ok = (deg > 0)[:, None].expand_as(ranks)
    rsteps = torch.where(ok, ranks // st.block_width + 1, 0)
    b_ms, b_by, bytes_ms, lat_ms, blocks = walk_bound(
        torch, cbl, rrows[:, None].expand_as(ranks).reshape(-1),
        rsteps.reshape(-1), ranks.numel() * 8 + verts.numel() * 4)
    rows_out.append(dict(
        name="chain_walk_rank", shape=f"rank walk, {verts.numel()} vertices "
        f"x {kk} draws, width {st.block_width}",
        found=int((rgot != -1).sum()), longest_walk_at_least=int(
            rsteps.max()), blocks_read_at_least=blocks, max_abs_err=0.0,
        ms=timer.ms(lambda: rank_walk(*rargs)),
        plain_ms=timer.ms(lambda: rank_walk_ref(*rargs), 1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        bytes_bound_ms=bytes_ms, latency_bound_ms=lat_ms,
        latency_ns_per_step=WALK_STEP_NS))
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in rows_out[1].items()})
    return rows_out


# ---------------------------------------------------------------------------
# serving: the two-tenant trace through ServeFrontend
# ---------------------------------------------------------------------------

def serve_trace(torch, dev, cbl, n, seed):
    """``n`` (arrival s, request) pairs on the host from ``seed``: Poisson
    arrivals at SERVE_QPS; a KHopSample every SERVE_KHOP_EVERY requests
    (alternately fraud and dashboard), a batch-class PageRank every
    SERVE_PAGERANK_EVERY; the rest 60/20/20 point reads, degree reads and
    update batches of 4-32 lanes.  Updates are fraud's (batch class): 20 %
    deletes of live edges (without replacement), 80 % fresh inserts.  Half
    the point reads ask for pairs the trace updated earlier, the rest for
    live edges; reads are fraud's (interactive, read-your-writes) or the
    dashboard's (standard) at even odds."""
    import numpy as np
    from repro_torch.core.updates import read_edges
    from repro_torch.serve import (Analytics, DegreeRead, KHopSample,
                                   PointRead, UpdateBatch)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    nv = cbl.capacity_vertices
    arrivals = np.cumsum(rng.exponential(1.0 / SERVE_QPS, n))
    sizes = rng.integers(4, 33, n)
    kinds = rng.choice(3, n, p=[0.6, 0.2, 0.2])
    pos = np.arange(n)
    kinds[pos % SERVE_KHOP_EVERY == SERVE_KHOP_EVERY - 1] = 3
    kinds[pos % SERVE_PAGERANK_EVERY == SERVE_PAGERANK_EVERY - 1] = 4
    n_upd = int(sizes[kinds == 2].sum())
    is_del = rng.random(n_upd) < DELETE_FRAC
    n_del, n_ins = int(is_del.sum()), int((~is_del).sum())
    n_live = n_del + int(sizes[kinds == 0].sum()) + 8 * int((kinds == 3).sum())
    ls, ld = live_edges(torch, cbl)
    pick = torch.randperm(ls.numel(), generator=gen, device=dev)[:n_live]
    live_s, live_d = ls[pick].cpu().numpy(), ld[pick].cpu().numpy()
    del ls, ld, pick
    ins_s = rng.integers(0, nv, n_ins).astype(np.int32)
    ins_d = rng.integers(0, nv, n_ins).astype(np.int32)
    while True:                      # fresh: absent from the graph and once
        found, _ = read_edges(cbl, torch.from_numpy(ins_s).to(dev),
                              torch.from_numpy(ins_d).to(dev))
        dup = np.zeros(n_ins, bool)
        key = ins_s.astype(np.int64) * nv + ins_d
        _, first = np.unique(key, return_index=True)
        dup[np.setdiff1d(np.arange(n_ins), first)] = True
        redo = found.cpu().numpy() | dup
        if not redo.any():
            break
        ins_s[redo] = rng.integers(0, nv, int(redo.sum()))
        ins_d[redo] = rng.integers(0, nv, int(redo.sum()))
    upd_s = np.empty(n_upd, np.int32)
    upd_d = np.empty(n_upd, np.int32)
    upd_s[is_del], upd_d[is_del] = live_s[:n_del], live_d[:n_del]
    upd_s[~is_del], upd_d[~is_del] = ins_s, ins_d
    upd_op = np.where(is_del, -1, 1).astype(np.int32)
    upd_w = (0.1 + 0.9 * rng.random(n_upd)).astype(np.float32)
    lp, up, khops, trace = n_del, 0, 0, []
    for i in range(n):
        m = int(sizes[i])
        tenant = "fraud" if rng.random() < 0.5 else "dashboard"
        cls = "interactive" if tenant == "fraud" else "standard"
        if kinds[i] == 0:
            if up and rng.random() < 0.5:
                j = rng.integers(0, up, m)
                qs, qd = upd_s[j], upd_d[j]
            else:
                qs, qd = live_s[lp:lp + m], live_d[lp:lp + m]
                lp += m
            req = PointRead(qsrc=qs, qdst=qd, tenant=tenant,
                            latency_class=cls)
        elif kinds[i] == 1:
            req = DegreeRead(verts=rng.integers(0, nv, m), tenant=tenant,
                             latency_class=cls)
        elif kinds[i] == 2:
            sl = slice(up, up + m)
            up += m
            req = UpdateBatch(src=upd_s[sl], dst=upd_d[sl], w=upd_w[sl],
                              op=upd_op[sl], tenant="fraud",
                              latency_class="batch")
        elif kinds[i] == 3:
            tenant = ("fraud", "dashboard")[khops % 2]
            khops += 1
            req = KHopSample(seeds=live_s[lp:lp + SERVE_KHOP_SEEDS], seed=i,
                             tenant=tenant, latency_class=(
                                 "interactive" if tenant == "fraud"
                                 else "standard"))
            lp += SERVE_KHOP_SEEDS
        else:
            req = Analytics(name="pagerank", tenant="dashboard",
                            latency_class="batch")
        trace.append((float(arrivals[i]), req))
    return trace


def serve_frontend(svc, clock=None):
    from repro_torch.serve import ServeFrontend, choose_serve_plan
    plan = choose_serve_plan(SERVE_QPS, mean_lanes_per_request=18.0,
                             log_capacity=svc._log.capacity,
                             high_watermark=svc._high_watermark)
    front = ServeFrontend(svc, plan, clock=clock, fanout=SERVE_FANOUT)
    front.register_tenant("fraud", read_your_writes=True)
    front.register_tenant("dashboard")
    return front


def serve_replay(torch, front, trace, agreed: bool = False):
    """Open loop on the wall clock: each request submitted at its arrival
    time with ``step()`` pumped in between; a ticket's latency runs from
    its arrival to the end of the step that completed it.  ``agreed`` (a
    frontend on a mesh): the loop waits on the time the frontend agreed at
    its last step or submit (rank 0's clock), so every rank steps alike
    with no collective of the loop's own, and a latency ends on this
    rank's clock (``perf_counter``: one clock for the processes of a
    host).  Returns ([(arrival, ticket, latency s)], wall s)."""
    clock = front.clock
    t0 = front.now() if agreed else clock()
    ticking = (lambda: front.agreed_time) if agreed else clock
    out, waiting = [], []

    def pump():
        if front.step() and waiting:
            t = clock()
            for w in [w for w in waiting if w[1].done]:
                out.append((w[0], w[1], t - w[0]))
                waiting.remove(w)

    for arr, req in trace:
        due = t0 + arr
        while ticking() < due:
            pump()
        waiting.append((due, front.submit(req)))
        pump()
    while waiting:
        pump()
    torch.cuda.synchronize()
    return out, (front.now() if agreed else clock()) - t0


def warm_replay(svc, trace):
    """The trace on a virtual clock, drained and flushed: every request
    kind and bucket shape once before the timed replay."""
    from repro_torch.serve import ManualClock
    clock = ManualClock()
    front = serve_frontend(svc, clock)
    for arr, req in trace:
        clock.advance(max(arr - clock.t, 0.0))
        front.submit(req)
        front.step()
    front.drain(flush=True)


def replica_capacity(front, trace, batches: int = 50) -> float:
    """Point-read lanes a second one replica serves closed loop: the
    trace's point reads in largest-bucket batches through the read plane,
    each collected (one sync and host copy) before the next."""
    import numpy as np
    from repro_torch.serve.scheduler import _fetch
    reads = [r for _, r in trace if r.kind == "point_read"]
    qs = np.concatenate([r.qsrc for r in reads])
    qd = np.concatenate([r.qdst for r in reads])
    cap = front.plan.bucket_set[-1]
    n = min(batches, qs.size // cap)
    plane = front.read_plane
    _fetch(plane.query_edges(qs[:cap], qd[:cap])[1])
    t0 = time.perf_counter()
    for i in range(n):
        sl = slice(i * cap, (i + 1) * cap)
        _fetch(plane.query_edges(qs[sl], qd[sl])[1])
    return n * cap / (time.perf_counter() - t0)


def _pcts(xs):
    import numpy as np
    xs = np.asarray(xs) * 1e3
    return dict(n=int(xs.size), p50_ms=float(np.percentile(xs, 50)),
                p99_ms=float(np.percentile(xs, 99))) if xs.size else dict(n=0)


def serve_phase(torch, timer, dev, svc, seed, report, profile=False):
    """The serve phase: the graph of phases 4-5 behind a serving
    GraphService (the example's log size) and ServeFrontend; a warm replay
    on a virtual clock, the timed open-loop replay with every launch
    counter at 0, its checks, and the overlay against flush-then-read."""
    import numpy as np
    from repro_torch import backend
    from repro_torch.serve import overlay as ov
    from repro_torch.stream.service import GraphService
    cbl = svc.snapshot.cbl
    serve_svc = GraphService(cbl, log_capacity=SERVE_LOG_CAPACITY)
    (trace, warm), gen_s = timer.wall(lambda: (
        serve_trace(torch, dev, cbl, SERVE_REQUESTS, seed + 23),
        serve_trace(torch, dev, cbl, SERVE_WARM, seed + 29)))
    _, warm_s = timer.wall(lambda: warm_replay(serve_svc, warm))
    front = serve_frontend(serve_svc, time.perf_counter)
    epoch0, flushes0 = serve_svc.epoch, serve_svc.stats.flushes
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    done, wall = serve_replay(torch, front, trace)
    launches = {k: backend.LAUNCHES[k] for k in WALK_KERNELS + GRAPH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    tickets = [t for _, t, _ in done]
    check(len(done) == len(trace) and all(t.done for t in tickets),
          "serve: a ticket did not complete")
    check(not any(t.shed for t in tickets), "serve: a ticket was shed")
    by_submit = sorted(done, key=lambda r: r[1].id)
    last = {}
    for _, t, _ in by_submit:
        key = (t.request.tenant, t.request.kind)
        check(last.get(key, (-1, -1)) <= t.version,
              f"serve: {key} versions went from {last.get(key)} to "
              f"{t.version}")
        last[key] = t.version
    lat_kind, lat_tenant = {}, {}
    for _, t, lat in done:
        lat_kind.setdefault(t.request.kind, []).append(lat)
        lat_tenant.setdefault(t.request.tenant, []).append(lat)
    rep = front.report()
    out = dict(
        requests=len(trace), wall_s=wall, qps=len(trace) / wall,
        trace_seconds=gen_s, warm_replay_s=warm_s,
        latency_by_kind={k: _pcts(v) for k, v in sorted(lat_kind.items())},
        latency_by_tenant={k: _pcts(v) for k, v in
                           sorted(lat_tenant.items())},
        flushes=serve_svc.stats.flushes - flushes0,
        epoch_advances=serve_svc.epoch - epoch0,
        interleaved_flushes=rep["service"]["interleaved_flushes"],
        bucket_shapes={k: v["buckets"] for k, v in rep["kinds"].items()},
        dispatches={k: v["dispatches"] for k, v in rep["kinds"].items()},
        plan=dict(buckets=list(front.plan.bucket_set),
                  windows=front.plan.windows,
                  flush_pending_max=front.plan.flush_pending_max),
        launches=launches, max_memory_allocated=peak)
    check(launches["chain_walk_locate"] > 0 and launches["chain_walk_rank"]
          > 0, "serve: chain_walk not launched on the serve path")
    check(launches["segment_sum"] > 0 and launches["block_gather"] > 0,
          "serve: PageRank did not go through the graph kernels")
    point_lanes = sum(t.request.size for t in tickets
                      if t.request.kind == "point_read")
    out["point_read_lanes_per_s"] = point_lanes / wall
    out["replica_read_lanes_per_s"] = replica_capacity(front, trace)

    # once, with a pending window: the overlay against flush-then-read
    rng = np.random.default_rng(seed + 31)
    upd = [r for _, r in trace if r.kind == "update"][-64:]
    us = np.concatenate([r.src for r in upd])
    ud = np.concatenate([r.dst for r in upd])
    op = -np.concatenate([r.op for r in upd])          # undo them
    serve_svc.apply(us, ud, np.concatenate([r.w for r in upd]), op)
    check(serve_svc.pending_updates > 0, "serve: no pending window")
    nvq = cbl.capacity_vertices
    qs = torch.from_numpy(np.concatenate([us, rng.integers(0, nvq, 512)])
                          .astype(np.int32)).to(dev)
    qd = torch.from_numpy(np.concatenate([ud, rng.integers(0, nvq, 512)])
                          .astype(np.int32)).to(dev)
    pend = serve_svc.pending_view()
    o_found, o_w = ov.overlay_point_reads(serve_svc.snapshot, pend, qs, qd)
    o_deg = ov.overlay_degrees(serve_svc.snapshot, pend, qs)
    serve_svc.flush()
    f_found, f_w = serve_svc.query_edges(qs, qd)
    check(torch.equal(o_found, f_found) and torch.equal(o_w, f_w),
          "serve: overlay point reads differ from flush-then-read")
    check(torch.equal(o_deg, serve_svc.query_degrees(qs)),
          "serve: overlay degrees differ from flush-then-read")
    out["overlay_checked_lanes"] = int(qs.numel())
    if profile:
        pfront = serve_frontend(serve_svc, time.perf_counter)
        _, prof = profiled(torch, lambda: serve_replay(
            torch, pfront, trace[:SERVE_PROFILE_REQUESTS]))
        out["profile"] = prof
        report["profile_serve"] = prof
    report["serve"] = out
    say("serve", qps=f"{out['qps']:.5g}", wall_s=f"{wall:.3f}",
        **{f"{k}_p50_p99_ms": f"{v['p50_ms']:.3g}/{v['p99_ms']:.3g}"
           for k, v in out["latency_by_kind"].items()},
        **{f"{k}_p50_p99_ms": f"{v['p50_ms']:.3g}/{v['p99_ms']:.3g}"
           for k, v in out["latency_by_tenant"].items()},
        flushes=out["flushes"], epoch_advances=out["epoch_advances"],
        bucket_shapes={k: len(v) for k, v in out["bucket_shapes"].items()},
        launches=launches, max_memory_allocated=peak,
        point_read_lanes_per_s=f"{out['point_read_lanes_per_s']:.4g}",
        replica_read_lanes_per_s=f"{out['replica_read_lanes_per_s']:.4g}",
        **({"device_busy_share": f"{out['profile']['device_busy_share']:.3f}"}
           if profile else {}),
        checks="complete,no_shed,versions,overlay")



def run(report: dict, scale: float = 1.0, seed: int = 0,
        profile: bool = False) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import backend

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    timer = Timer(torch)
    card = smi_line()
    print(card, flush=True)
    report["card"] = card
    t0 = time.perf_counter()
    backend.load_kernels()
    say("setup.build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{backend.last_build_seconds:.2f}")
    report["build_seconds"] = backend.last_build_seconds
    report["flash_build"] = flash_build_report(torch, backend)
    report["flash_f32_build"] = flash_build_report(
        torch, backend, "flash_attention", "flash_fwd_tf32", 4,
        "setup.flash_f32_sass", "as ptxas gives them")
    clock_mhz = float(smi_line("clocks.max.sm", "csv,noheader,nounits"))
    report["sm_clock_max_mhz"] = clock_mhz

    t0 = time.perf_counter()
    graph_phases(torch, timer, dev, scale, seed, profile, report)
    report["graph_seconds"] = time.perf_counter() - t0
    gc.collect()                       # the graph state goes before 5g's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plan_patch_phase(torch, timer, dev, seed, report)
    report["plan_patch_seconds"] = time.perf_counter() - t0
    gc.collect()                       # 5g's state goes before the LM's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_phase(torch, timer, dev, seed, report, clock_mhz, profile)
    report["lm_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()           # phase 6b frees the LM state first
    moe_serve_phase(torch, timer, dev, seed, report, clock_mhz, profile)
    report["moe_serve_seconds"] = time.perf_counter() - t0
    gc.collect()                       # the MoE state goes before SASRec's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recsys_phase(torch, timer, dev, seed, report, profile)
    report["recsys_seconds"] = time.perf_counter() - t0
    gc.collect()                       # SASRec's state goes before the GNNs'
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_phase(torch, timer, dev, seed, report, profile)
    report["train_seconds"] = time.perf_counter() - t0
    gc.collect()                       # the GNN state goes before phase 9's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model_train_phase(torch, timer, dev, seed, report, profile)
    report["model_train_seconds"] = time.perf_counter() - t0
    gc.collect()                       # phase 9's state goes before the LM's
    torch.cuda.empty_cache()
    # phase 10's checkpoints stay on the disk for phase 11's restore
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_")
    try:
        t0 = time.perf_counter()
        lm_train_phase(torch, timer, dev, seed, report, ckpt_dir, profile)
        report["lm_train_seconds"] = time.perf_counter() - t0
        gc.collect()                   # phase 10's state goes before 11's
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mesh_phase(torch, timer, dev, seed, report, ckpt_dir)
        report["mesh_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()                       # phase 11's state goes before 12's
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ep_mesh_phase(torch, timer, dev, seed, report)
    report["mesh_ep_seconds"] = time.perf_counter() - t0


def model_train_entries(report: dict, name: str) -> dict:
    """Kernel ``name``'s phase-9 entries, one a model that launches it: its
    row at the model's main shape (``MODEL_TRAIN_MAIN``), its launches on
    the model's supervised run and in one measured step, the largest error
    over the model's rows of the kernel."""
    out = {}
    for model in ("equiformer", "sasrec"):
        if (model, name) not in MODEL_TRAIN_MAIN:
            continue
        rows = [r for r in report["model_train_kernels"]
                if r["name"] == name and r["shape"].startswith(model)]
        main = next(r for r in rows
                    if r["shape"] == MODEL_TRAIN_MAIN[(model, name)])
        run = report["model_train"][model]
        out[model] = dict(
            shape=main["shape"], launches=run["launches"][name],
            launches_per_step=run["routes"]["launches_per_step"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"])
    return out


def lm_train_entry(report: dict, name: str) -> dict:
    """Kernel ``name``'s phase-10 entry: its row at the MoE's main shape
    (``LM_TRAIN_MAIN``), its launches on the supervised run and in one
    measured step, the largest error over its MoE rows."""
    rows = [r for r in report["lm_train_kernels"] if r["name"] == name]
    main = next(r for r in rows if r["shape"] == LM_TRAIN_MAIN[name])
    run = report["lm_train"]
    return dict(shape=main["shape"], launches=run["launches"][name],
                launches_per_step=run["routes"]["launches_per_step"][name],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"])


def moe_serve_entry(report: dict, name: str) -> dict:
    """Kernel ``name``'s phase-6b entry: its row at the MoE-serving shape of
    ``MOE_SERVE_MAIN`` (the graph kernels: the decode step's), its launches
    on the graph-route serve, the largest error over its phase-6b rows."""
    rows = [r for r in report["moe_serve_kernels"] if r["name"] == name]
    main = next(r for r in rows if r["shape"] == MOE_SERVE_MAIN[name])
    return dict(shape=main["shape"],
                launches=report["moe_serve"]["launches"][name],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"])


def mesh_ep_launches(report: dict, name: str) -> dict:
    """Kernel ``name``'s launches on phase 12's main paths: leg (a)'s
    training steps, each leg-(b) rank's prefill and decode."""
    ep = report["mesh_ep"]
    out = {"nccl rank 0 train": ep["train"]["launches"][name]}
    out.update({f"gloo rank {r['rank']} serve": r["launches"][name]
                for r in ep["serve"]})
    return out


def kernels_line(report: dict) -> dict:
    """The ``kernels`` JSON object: each kernel at its path's dominant shape
    (the push sweep's first row: x[src] over the sweep plan and the CSR sum
    of its stream; the global attention layer; the serve_bulk lookup),
    errors over every shape checked, launches on its own path's run.  The
    graph kernels' ``tier`` entry holds the same numbers at the sealed
    run's push stream (0.9 of the edges sealed), launches on the tiered
    service's run; the ``train`` entry at the GNN train path's layer-0
    forward (F = 100), launches on the supervised gin-tu run and in one
    measured step, ``arch_launches`` the same for the PNA and EGNN runs,
    ``max_abs_err`` over every train-path row (F = 100, 64, and PNA's and
    EGNN's own 602, 75 and 3); the ``model_train`` entries (the graph
    kernels and ``embedding_bag``) the same for phase 9's Equiformer-v2
    (K·C = 6272) and SASRec (F = 50) runs; the ``lm_train`` entries the
    same for phase 10's MoE (the dispatch, F = 2048 bf16; the combine's sum
    by token); the ``moe_serve`` entries of the graph kernels and both
    attention kernels the same for phase 6b's qwen3-moe serve (the decode
    step's dispatch and sum by token, flash and paged at G = 8)."""
    launches = report["service"]["launches"]
    meta = {
        "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_matmul/kernel.py:57"),
        "block_gather": ("src/repro_torch/csrc/block_gather.cu",
                         "src/repro/kernels/block_gather/kernel.py:29"),
    }
    lm_meta = {
        "flash_attention_wgmma": (
            "src/repro_torch/csrc/flash_attention_wgmma.cu",
            "src/repro/kernels/flash_attention/kernel.py:69"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:72"),
    }
    # float32 prefill attention on the CUDA cores (the float32 serve path)
    lm_f32_meta = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:69"),
    }
    recsys_meta = {
        "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag/kernel.py:38"),
    }
    # no Pallas kernel: the JAX package walks chains in lax.while_loops
    walk_meta = {
        "chain_walk": ("src/repro_torch/csrc/chain_walk.cu",
                       "src/repro/core/updates.py:49"),
        "chain_walk_rank": ("src/repro_torch/csrc/chain_walk.cu",
                            "src/repro/graph/sampler.py:35"),
    }
    serve_launches = report["serve"]["launches"]
    walk_launches = {"chain_walk": serve_launches["chain_walk_locate"],
                     "chain_walk_rank": serve_launches["chain_walk_rank"]}
    out = []
    for table, rows_key, main_shape, launch_counts in (
            (meta, "kernels", "push", launches),
            (lm_meta, "lm_kernels", "global", report["lm"]["launches"]),
            (lm_f32_meta, "lm_kernels", "f32 global",
             report["lm_f32"]["launches"]),
            (recsys_meta, "recsys_kernels", "serve_bulk",
             report["recsys"]["launches"]),
            (walk_meta, "walk_kernels", "", walk_launches)):
        for name, (source, replaces) in table.items():
            rows = [r for r in report[rows_key] if r["name"] == name]
            main = next(r for r in rows if r["shape"].startswith(main_shape))
            out.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=launch_counts[name],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], shape=main["shape"]))
        if table is meta:            # the GNN train path, layer 0 forward
            for row in out[-2:]:
                rows = [r for r in report["train_kernels"]
                        if r["name"] == row["name"]]
                main = next(r for r in rows
                            if r["shape"] == TRAIN_MAIN_SHAPE)
                row["train"] = dict(
                    shape=main["shape"],
                    launches=report["train"]["launches"][row["name"]],
                    launches_per_step=report["train"][
                        "launches_per_step"][row["name"]],
                    arch_launches={
                        r["arch"]: dict(
                            launches=r["launches"][row["name"]],
                            launches_per_step=r["routes"][
                                "launches_per_step"][row["name"]])
                        for r in report["train"]["small"]},
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=main["ms"], plain_ms=main["plain_ms"],
                    bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                    library_ms=main["library_ms"])
        if table in (meta, recsys_meta):   # phase 9's training paths
            for row in out[-len(table):]:
                row["model_train"] = model_train_entries(report, row["name"])
        if table is meta:            # phase 10's MoE dispatch and combine
            for row in out[-2:]:
                row["lm_train"] = lm_train_entry(report, row["name"])
        if table in (meta, lm_meta):     # phase 12, each leg's ranks
            for row in out[-2:]:
                if row["name"] in MESH_EP_KERNELS:
                    row["mesh_ep_launches"] = mesh_ep_launches(
                        report, row["name"])
        if table in (meta, lm_meta):     # phase 6b, MoE serving
            for row in out[-2:]:
                row["moe_serve"] = moe_serve_entry(report, row["name"])
        if table is meta:            # the sealed run's push stream
            for row in out[-2:]:
                main = next(r for r in report["tier"]["kernels"]
                            if r["name"] == row["name"])
                row["tier"] = dict(
                    shape=main["shape"],
                    launches=report["tier"]["service"]["launches"][
                        row["name"]],
                    max_abs_err=main["max_abs_err"], ms=main["ms"],
                    plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"],
                    library_ms=main["library_ms"])
        if table in (meta, walk_meta):   # launches on each shard path
            locate = {"chain_walk": "chain_walk_locate",
                      "chain_walk_rank": "chain_walk_rank"}
            for row in out[-2:]:
                name = locate.get(row["name"], row["name"])
                row["shard_launches"] = {
                    str(r["n_shards"]): r["launches"][name]
                    for r in report["shard"]["runs"]}
                # phases 5e and 5f: each rank's launches on its own shards
                row["shard_launches"].update({
                    f"mesh {key}": counts[name] for key, counts in
                    report["shard_mesh"]["launches"].items()})
                row["shard_launches"].update({
                    f"serve mesh {key}": counts[name] for key, counts in
                    report["serve_mesh"]["launches"].items()})
        if table is walk_meta:       # the bound's two terms, as measured
            for row, name in zip(out[-2:], walk_meta):
                main = next(r for r in report[rows_key] if r["name"] == name)
                row.update(bytes_bound_ms=main["bytes_bound_ms"],
                           latency_bound_ms=main["latency_bound_ms"],
                           latency_ns_per_step=WALK_STEP_NS)
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of the LiveJournal-size graph")
    ap.add_argument("--profile", action="store_true",
                    help="profile the last flush, the warm PageRank, "
                         "2,000 requests of the serve trace, the last "
                         "flush and a PageRank at 8 shards, the LM "
                         "check's prefill, one replayed and one eager "
                         "paged decode step of Gemma-2 and of qwen3-moe, "
                         "one serve_bulk chunk of "
                         "SASRec, one gin-tu, Equiformer-v2, SASRec and "
                         "qwen3-moe training step (their times then "
                         "include the profiler's cost)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = {}
    try:
        run(report, args.scale, args.seed, args.profile)
    except SmokeFailure as e:
        (out_dir / "chip_smoke_failed.json").write_text(
            json.dumps(report, indent=1))
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    name = "chip_smoke_profile.json" if args.profile else "chip_smoke.json"
    (out_dir / name).write_text(json.dumps(report, indent=1))
    say("report", max_memory_allocated=report["max_memory_allocated"],
        lm_max_memory_allocated=report["lm"]["max_memory_allocated"],
        recsys_max_memory_allocated=report["recsys"]["max_memory_allocated"],
        graph_seconds=f"{report['graph_seconds']:.1f}",
        tier_seconds=f"{report['tier_seconds']:.1f}",
        shard_seconds=f"{report['shard_seconds']:.1f}",
        shard_max_memory_allocated=report["shard"]["max_memory_allocated"],
        shard_mesh_seconds=f"{report['shard_mesh_seconds']:.1f}",
        serve_mesh_seconds=f"{report['serve_mesh_seconds']:.1f}",
        lm_seconds=f"{report['lm_seconds']:.1f}",
        moe_serve_seconds=f"{report['moe_serve_seconds']:.1f}",
        moe_serve_max_memory_allocated=report["moe_serve"][
            "max_memory_allocated"],
        recsys_seconds=f"{report['recsys_seconds']:.1f}",
        train_seconds=f"{report['train_seconds']:.1f}",
        train_max_memory_allocated=report["train"]["max_memory_allocated"],
        model_train_seconds=f"{report['model_train_seconds']:.1f}",
        equiformer_max_memory_allocated=report["model_train"]["equiformer"][
            "max_memory_allocated"],
        sasrec_train_max_memory_allocated=report["model_train"]["sasrec"][
            "max_memory_allocated"],
        lm_train_seconds=f"{report['lm_train_seconds']:.1f}",
        lm_train_max_memory_allocated=report["lm_train"][
            "max_memory_allocated"],
        mesh_seconds=f"{report['mesh_seconds']:.1f}",
        mesh_ep_seconds=f"{report['mesh_ep_seconds']:.1f}",
        file=f"chiprun_out/{name}")
    print(json.dumps(kernels_line(report)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
