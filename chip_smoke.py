#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's serving (replicated, sharded and
heat-aware), request plane, ingest, partitioning and join paths, Mamba2
inference and training, and the other model families' inference and
training, on one CUDA card.

    python3 chip_smoke.py            # full size: 8 M osm-like objects served,
                                     # replicated and on 4 simulated owners
                                     # (count-balanced and heat-aware),
                                     # behind the request plane,
                                     # 7 M staged + 1 M streamed in,
                                     # 4 M + 4 M pi and 1 M + 1 M osm joined,
                                     # Mamba2-1.3B prefill and decode,
                                     # and 9 training steps at 8 x 2,048,
                                     # RecurrentGemma-9B prefill of 32,768
                                     # tokens and decode, and every other
                                     # family at full width, served and
                                     # trained, and qwen1.5-4b trained
                                     # sharded on 4 gloo ranks, a (2, 2)
                                     # ("data", "model") mesh

Phases, each printing JSON lines (launch counts are set to 0 just
before each path and read just after it) and its wall seconds:

0. checker -- the port's hazard checker (``python -m
   repro_torch.analysis repro_torch`` from ``port/``) over the
   checkout's ``port/repro_torch``: one line with the findings by rule
   and the report's counts.  Fails on any finding, on a kernel build
   (refused for its run) and on any launch count above 0 after it.
1. build  -- compile the four kernel sources of the checkout (range
   probe, Hilbert encode, MBR join, SSD) with one nvcc each, all at
   once (sm_90a), and report the compiler's register/spill summary.
2. serve  -- with every kernel launch count at 0: generate N osm-like
   objects on the card (seeded), partition them with ``bsp`` at payload
   4096 and stage them three times (``local_index="x"``, ``"off"`` and
   ``"hilbert"``, whose staging runs the Hilbert encode over every
   slot), then serve 20 ``range_counts`` batches of Q = 4096 boxes
   (centres uniform, half-extents uniform in [0, 0.03]) and 5
   ``range_ids`` batches of 1024 boxes (half-extents in [0, 0.003],
   max_hits = 1024) through each server.  Counts and ids of "x",
   "hilbert" and "off" must be equal; 1024 queries of the first counts
   batch and every query of the first ids batch are checked against a
   blocked brute force on the card, overflow flags included.  The
   launch counts are read right after: the routed counts and the
   routed hit lists must have launched, the routed hit-table kernels
   not at all.
3. knn    -- 5 batches of 1024 points (uniform in the unit square,
   k = 10, max_cand = 1024) through the "x", "off" and "hilbert"
   servers' pruned kNN, the widen-and-retry ladder included.  "off" and
   "hilbert" must flag the same points as "x" and equal it bit for bit
   (ids, d2) on every unflagged point, and 256 points of the first
   batch must equal an on-card brute force by (d2, id) over all N
   objects, d2 rounded as the executors round it (``mindist2_fused``).  A point flagged for
   more than max_cand candidates keeps the first max_cand hits in
   (tile, slot) order, as repro does, and the stagings order slots
   differently, so its answer is the staging's own.  The gathered
   kernels' launch counts are read right after (hit lists launched, no
   hit table).
4. dense  -- the dense oracle (``pruned=False``) on the "x" server,
   on whole batches: range_counts on the first counts batch (Q =
   4096), range_ids and knn on the first ids and kNN batches (1024
   rows each), three timed calls each plus one profiled (device time,
   the five largest items, peak memory), and range_ids and knn on
   their first 256 rows as well (the size earlier runs timed).  Each
   must equal the pruned answer bit for bit (kNN: on every point that
   neither side flags) and the on-card brute force (1024 counts, every
   ids query, 256 kNN points the dense side does not flag): the oracle
   and the pruned path share the tile-major probe.  The launch counts
   are read right after: ``dense_counts`` and ``dense_hits`` must have
   launched, the block-per-tile ``count`` and ``mask`` not at all.
5. kernels -- each of the range-probe kernels against its plain
   PyTorch version on the card, at the shapes its path gives it
   (routed counts: a routed counts batch; routed hit lists: the ids
   batch whole and one kNN refinement call at its own radii; routed
   tables: the old ids executor's largest hit-table block; dense
   counts: the Q = 4096 counts batch; the dense hit list: the ids
   batch whole and the dense kNN's refinement; dense tables: the old
   dense executor's hit-table block): the path's own inputs (staged
   alive mask, bounding chunk boxes), then ``alive`` None and a random
   mask and, for the skip kernels, chunk boxes that do not bound their
   members; the count and hit list kernels take the live extent of
   each alive mask.  Results must be bit-equal.  The hit lists' rows
   give each stage's time (grouping, count, scan, emit) and the old
   extraction's on the same inputs (the table kernel and ``nonzero``
   over its blocks, which must give the same list), beside the table
   kernel's time.  Kernel times come from CUDA events, plain times
   from the host clock.  The count kernels are also timed without the
   extent (bit-equal), the dense counts also in the old
   block-per-(tile, query block) design (``count``, bit-equal), and
   their rows give the grouping pass's time and the bound over all of
   cap beside the bound at the extent.  The dense skip pair has no
   serving caller (repro launches it from tests only), so it is
   launched from this phase only and its row says so; in all six cases
   its new design (to the case's extent and without it) and its first
   design (``count_skip_v1``, ``mask_skip_v1``) are held to the plain
   version and timed in turns, the counts beside ``dense_counts`` on
   the same inputs.  No dense kernel's row may read faster than its
   own bound.
5b. sharded -- the serve phase's objects and partitioning on
   ``ServeConfig(placement="sharded", shards=4)``: the four owners
   simulated on the card, their shards gathered from the staging on
   the card while the replicated "x" staging stays resident.  The "x"
   server runs all 20 counts, 5 ids and 5 kNN batches, "off" the first
   4, 2 and 2; every counts and ids answer must equal the replicated
   "x" server's bit for bit, and every kNN answer where neither flags
   (an owner flags past max_cand of its own candidates, so the sharded
   flags must be a subset of the replicated ones).  Each counts batch
   must launch the routed count kernel once (the owners' probes are one
   folded launch, not four).  On "x" the dense oracle runs the first
   batch of each kind and must equal the pruned answers, and the first
   batches are held to the brute force (1024 counts, every ids query,
   256 kNN points).  Prints build seconds and peak memory, bytes a
   device, p50/p99 a batch with device ms and the idle share,
   ``owner_split``'s host ms a batch, the exchange's ``messages``,
   ``m_per_pair``, ``f_local`` and ``probe_load_imbalance``, and the
   launches.  Then a sharded ingest stream on a sharded "x" server of
   the same objects with slack for 300,000 more: 3 appends of 100,000
   (served objects resampled, each shifted by up to 1e-4; none may
   re-stage), 2 deletes of 200,000, a
   forced compact, a burst of cap + 1 objects (which must re-stage and
   re-balance the owners); the extent of every shard row must cover
   its alive slots throughout (tight after compact and re-stage), and
   a counts, an ids and a kNN batch and the dense counts must equal a
   fresh sharded staging of the live set (and the counts the brute
   force).  Alone (the kernels build at first use): ``python3 -c
   "import torch, chip_smoke; chip_smoke.sharded_alone(torch,
   torch.device('cuda'))"``.
5c. heat -- the serve phase's objects and partitioning, the sharded
   phase's servers freed, a replicated "x" server staged again for the
   answers; hot counts batches of Q = 4096 boxes (the hotspot bench's
   stream, ``benchmarks/bench_range_query.py`` ``_hot_qboxes``, from a
   seeded torch generator: 85% of the centres in one 0.2-wide patch,
   half-extents 0.02 + U·0.14, the rest uniform with U·0.05), 1024-box
   ids batches around hot centres (half-extents to 0.003) and 1024 hot
   kNN points.  The bench's three legs on 4 owners: (a)
   ``placement="sharded"`` over 5 counts batches; (b) the same server
   after ``rebalance()`` over the same 5; (c) ``placement="heat"``
   with ``PlacementPolicy(heat_decay=0.85, replicate_top=64)``: 5 cold
   batches, ``rebalance()``, 10 hot counts batches, 5 ids and 5 kNN
   batches.  Then a ``rebalance_every=4`` heat server over 12 counts
   batches (3 automatic rebalances, counted) and, on it, an ingest
   stream through the replicas: 2 appends of 100,000 (served objects
   resampled, shifted by up to 1e-4), a delete of 200,000, an update of
   50,000, a forced ``compact()``, then a counts, an ids and a kNN batch
   and the dense oracle.  Fails unless every answer equals the
   replicated server's (kNN: where neither flags; the sharded flags a
   subset), 128 rows of every hot counts batch equal the brute force,
   every replica row equals its primary (boxes, ids, alive, chunk
   boxes, extent), the shard rows stay (4, 512 + 64) through every
   rebalance, every routed candidate resolves to exactly one resident
   copy, and after the ingest the answers equal the dense oracle and
   the brute force on the live set and the extent covers every alive
   slot.  Prints each leg's messages a batch and their ratios (the
   README's claim), ``routed_alt``, ``f_local``,
   ``probe_load_imbalance``, p50/p99, ``split_ms``, device ms and the
   idle share, each rebalance's report and split seconds (snapshot,
   staging rebuild, plan, re-gather), the ingest's operations, peak
   memory and the launches.
5d. frontend -- the request plane (``FrontendConfig()``: ladder
   64/128/256/512, max_delay 2 ms, queue_limit 4096, quantum 16) on the
   replicated "x" server: each kind's direct service ms at width 512
   give the mix's capacity R (70% counts to 0.03, 20% ids to 0.003 with
   max_hits 1024, 10% kNN k = 10; tenants 70/20/10%); then
   ``simulate_open_loop`` over ``poisson_workload`` (seed 0, 20,000
   arrivals) at 0.5 R and at 1.5 R with a 50 ms default deadline, 2,000
   arrivals at 0.5 of the heat server's own R on the rebalanced heat
   server (its ``placement_stats()``), and the asyncio ``ServeFrontend``
   on 1,024 concurrent mixed submissions drained by ``close()``.  Every
   OK response must equal a direct unpadded call on the same queries
   bit for bit (the check's launches not counted).  Prints p50/p99
   queue and total ms, sustained requests a second, the fill and padded
   slots by kind, rejected and timed-out counts, the plane's host µs a
   request and the routed kernels' launches.  Alone with the heat
   phase (the kernels build at first use): ``python3 -c "import torch,
   chip_smoke; chip_smoke.heat_alone(torch, torch.device('cuda'))"``.
6. ingest -- the serve phase's 8,000,000 objects again (same seed):
   ``bsp`` at payload 4096 over the first 7,000,000, staged with
   ``local_index="x"`` and a slack that holds the held-out 1,000,000
   (their fullest tile's copies, rounded up to 128).  With every launch
   count at 0: 10 appends of 100,000 (none may re-stage), 4 deletes of
   200,000 random live ids, a forced ``compact()``, 1 update of
   100,000 ids (each box shifted by up to 1e-3; it may not re-stage),
   a burst of cap + 1 coincident objects into tile 0 (which must
   re-stage), 1 more delete
   of 200,000 (leaving the extent stale-large), then a counts batch (Q
   = 4096), an ids batch (1024), a kNN batch (1024 points, k = 10) and
   the dense counts.  Fails unless the counts equal the brute force on
   the live set and a fresh staging of it, the ids and kNN (ids, d2 bit
   for bit, flags) equal the fresh staging's (its ids remapped through
   the ascending live ids), the dense counts equal the pruned ones, 256
   kNN points equal the brute force, and the extent covers every alive
   slot after every step (tight after compact and re-stage).  Then two
   shorter streams, ``"hilbert"`` and ``"off"``, from the first
   1,000,000 of the staged objects on the same partitioning, on the
   same commands (2 appends, 2 deletes, a forced compact, whose
   "hilbert" branch must launch the encode), whose answers must be
   equal.  Prints each
   operation's wall ms and bytes uploaded, the host mirrors' build
   time, compact and re-stage seconds, peak memory, the tiles whose
   extent is above tight, the p50 of a counts batch on the ingested
   server and on the fresh staging (in turns, one clock), and the
   launches of each kernel on the path, which must include every routed
   count and hit list, ``dense_counts`` and the encode.  Alone (the
   kernels build at first use): ``python3 -c "import torch, chip_smoke;
   chip_smoke.ingest_phase(torch, torch.device('cuda'))"``.
7. partition -- the six Table-1 partitioners on the join's merged pi
   input (8 M objects) at payload 4096: seconds, k, and the paper's
   lambda, balance stddev, skew and coverage; hc's encode launches.
8. join   -- ``plan_join`` then ``spatial_join_count`` for each of the
   six layouts on two inputs at payload 4096: pi |><| pi (4 M + 4 M
   ``pi_like``, seeds 0 and 1) and osm |><| osm (1 M + 1 M
   ``osm_like``, seeds 0 and 1).  Plan and join seconds are medians of
   3; the raw MASJ count comes from ``tile_counts(dedup="none")``'s
   per-tile counts, which must be one batched raw count launch and no
   ``count`` launch, and whose largest value sets
   ``max_pairs_per_tile``, so no tile's pairs are truncated; the raw
   count is also timed (median of 3 ``run_join_count(dedup="none")``)
   and held, tile for tile, to the per-tile path it replaced (the
   ``count`` kernel a tile, ``join.tile_join_count(dedup="none")``),
   whose launches are not counted.  The MASJ pair path runs for every
   layout.  Each ``spatial_join_count`` must launch the batched rp count
   once (fg, bsp, slc, bos) or the batched pair list once (str, hc),
   and neither the ``mask`` table kernel nor ``count``.  On the bsp and
   hc plans the per-tile table join (``mask``, ``rp_own_mask``, a sum or
   ``nonzero``) and the per-tile raw count run as yardsticks, timed
   (median of 3) beside the new ones and held to the same counts; their
   launches are not counted.  The kernels' launches are read right
   after: ``raw_counts``, ``rp_counts``, ``pair_list`` and ``encode``
   must have launched, ``count``, ``mask`` and ``encode_v1`` not at
   all.
9. join_check -- fails unless, on each input, all six exact counts are
   equal, rp equals MASJ pairs for the non-overlapping layouts, the
   exact count equals one unpartitioned ``join_count`` of the whole
   inputs (the count kernel over every pair), the partner counts of
   4096 sampled R objects in the deduplicated bsp pair list equal a
   plain brute force against all of S, the raw count is at least the
   exact count, and no tile was truncated.
9b. sharded_join -- the pi bsp and hc plans for 4 devices, run on the
   card (one batched launch over every device row), must count what the
   one-device plans count (which equals the unpartitioned count), raw
   and exact; then
   ``parallel_partition`` of the 8 M merged pi objects at payload 4096
   over 4 simulated devices must drop nothing and cover every object
   (one encode launch keys them all).
10. kernels -- encode over the 8 M merged pi centroids and over 2^25
   seeded grid points (a "hilbert" staging's launch size), timed in
   turns with the plane-loop design (``encode_v1``) on the same inputs,
   both bit-equal to the plain version; its operation count per point
   from the built kernel's SASS (``cuobjdump``, the vector loop's
   instructions over its four points).  The count and mask kernels on
   the largest live tile of the pi and the osm bsp joins, the batched
   rp and raw counts on the whole pi and osm bsp plans and the batched
   pair list on the whole pi and osm hc plans, each against its plain
   version (bit-equal) and the batched passes also against the per-tile
   path (the same counts, the same pair list), CUDA-event ms over 10
   launches beside the plain ms, the old design's ms and the bound
   (four compares a live (r, s) test at 67 T/s, integer instructions at
   33.5 T/s, or the bytes).

11. lm_prefill -- the spatial phases' tensors freed, the published
   Mamba2-1.3B configuration (48 SSD blocks, d_model 2048, 64 heads of
   64, state 128, bf16 activations) with random float32 weights from a
   seeded generator on the card, TF32 off for matmuls (asserted):
   ``make_prefill_step`` on B = 4 prompts of L = 32,768 tokens (the
   ``prefill_32k`` length; batch cut from its global 32).  Median of 3
   seconds, tokens/s, peak memory, the SSD launches (one a layer),
   device ms, idle share and the five largest device items from the
   profiler.  Layer 0's SSD inputs are kept for the kernel check.
12. lm_decode -- the greedy loop of ``launch/serve.py`` at batch 128,
   prompt 32, gen 32: tokens/s, p50 and p99 step ms, the idle share of
   a profiled step.
13. lm_check -- fails unless (a) the SSD kernel equals its plain version
   (the einsum form, run in blocks of chunks) within rtol = atol =
   2e-5 on layer 0's prefill inputs and on a random set; (b) in
   float32 at full width and depth, B = 2, L = 200 (the pad path), the
   teacher-forced logits through the kernel equal 200 ``decode_step``
   calls through the recurrence (which launch no kernel) within 1e-4,
   greedy tokens agreeing wherever the top-two margin exceeds it; (c)
   the prefill path launched the kernel once a layer, and the FFMA
   design never.  Then the kernel's CUDA-event ms over 10 launches at
   the prefill shape, timed in turns with the FFMA design on the same
   inputs, its plain ms and its bound.
14. lm_train -- the prefill phases' weights freed: ``launch/train.py``'s
   ``main`` on the published configuration (``--arch mamba2_1p3b``,
   float32 master weights, bf16 activations, TF32 off, asserted) at B =
   8 sequences of L = 2,048 tokens (the Mamba2 paper's training
   context; the global batch cut to 8), remat "full", the AdamW
   defaults, 2 warm steps, 6 timed and 1 profiled, a failure injected
   at step 3 (no checkpoint is due, so ``run_loop`` retries the step;
   ``--ckpt-every`` lies past the last step, so nothing is written).
   With the launch counts at 0 just before: every step must launch
   ``intra_chunk`` 96 times (a forward and a recompute a layer) and
   ``intra_chunk_v1`` never, every loss and ``grad_norm`` must be
   finite, the restarts 1, and the launcher's own check ``losses[-1] <
   losses[0]`` must hold.  Prints the median step seconds, tokens/s,
   peak memory, the profiled step's device ms, idle share, largest
   device items and operators, a breakdown by part (one layer's
   forward and backward, the SSD block's, the intra-chunk block's, the
   head's and the AdamW update, CUDA events), the losses and
   ``grad_norm``, and the first step's loss again, forward only,
   through the kernel and through the plain intra-chunk.  Layer 0's SSD
   inputs of that forward are kept.
15. lm_train_check -- fails unless (a) ``ops.IntraChunk`` on layer 0's
   training inputs and on a random set launches the kernel once, gives
   its plain version within 2e-5, and gives input gradients bit-equal
   to ``torch.autograd.grad`` through ``ref.intra_chunk_grouped`` (the
   backward recomputes that graph); (b) at full width and 2 layers (B
   = 2, L = 512), 6 steps with a checkpoint every 2 and a failure at
   step 4 restore step 4's checkpoint and end with the parameters and
   moments of an uninterrupted run bit for bit, under
   ``torch.use_deterministic_algorithms`` (the temporary directories
   removed, the bytes written printed); (c) in float32 at full width,
   2 layers, B = 2, L = 256, a train step with remat "full" gives the
   loss, gradients and new parameters of one with "none", bit for bit.
16. fam_prefill -- the training phases' weights freed: published
   RecurrentGemma-9B at full width and depth (38 layers: 12 x (rec,
   rec, local) and (rec, rec); random float32 weights, bf16
   activations, TF32 off, asserted): ``make_prefill_step`` on B = 1
   prompt of L = 32,768 tokens (``prefill_32k``'s length, its batch of
   32 cut to 1; cut to 16,384 if the warm run takes more than 30 s, and
   the cut printed), a warm run, 2 timed (median) and 1 profiled;
   seconds, tokens/s, peak memory, device ms, idle share, the five
   largest device items.  The logits must be finite: L lies past
   2,559, where the reference's windowed attention is NaN (ROADMAP
   Queue 3).
17. fam_decode -- ``launch/serve.py``'s greedy loop on the same model
   at batch 128, prompt 32, gen 32: tokens/s, p50 and p99 step ms, the
   idle share of a profiled step.
18. fam_check -- float32, the same weights: fails unless (a) at full
   depth, B = 2, L = 200, and (b) one super-block (rec, rec, local; the
   model's first three layers), B = 2, L = 2,600 (the local ring of
   2,048 wraps; from 2,559 on a query's first key chunk lies outside
   its window), the teacher-forced logits equal L ``decode_step`` calls
   within 1e-4 (``tests/test_models_smoke.py``'s tolerance), greedy
   tokens agreeing wherever the top-two margin exceeds 2e-4.
19. families -- every other family at full width, each model freed
   before the next: qwen1.5-4b (10 of 40 layers), gemma2-27b (4 of
   46), mixtral-8x22b (2 of 56), arctic-480b (1 of 35), internvl2-26b
   (4 of 48, 256 seeded image tokens of width 3,200) and whisper-medium
   (6 + 6 of 24 + 24 layers, 1,500 seeded frames); the depth cut is
   the most of each that 80 GB holds in float32 weights with room to
   run, qwen's and whisper's a quarter of their whole depth (the
   script's time).  For each:
   a bf16 prefill at B = 1, L = 5,120 text tokens (past 4,607, where
   the reference's 4,096 windows are NaN; whisper 448 decoder tokens),
   a warm and a timed run, logits finite; the greedy loop at batch 32,
   prompt 16, gen 16; and float32 decode against teacher forcing at B =
   2, L = 64 within 1e-4 (the MoE pair at capacity factor
   max(16, experts): a decode step routes 2 tokens, and below that a
   step could drop a choice the forward keeps).
   Every kernel's launch count must stay 0 over phases 16-19.
20. fam_train -- every family but ssm trains at full width, float32
   weights, bf16 activations, TF32 off, AdamW (warmup 1), remat
   "full", each model freed before the next: qwen1.5-4b (5 of 40
   layers, 4 x 2,048 tokens), gemma2-27b (2 of 46: a local and a global
   layer, 2 x 2,048: the batch cut from 4, its float32 logits do not
   fit beside its state), mixtral-8x22b (1 of 56, 4 x 2,048),
   recurrentgemma-9b (3 of 38: one super-block, 2 x 4,096, past 2,559
   where the reference's windowed attention and its gradient are NaN),
   internvl2-26b (4 of 48, 256 image tokens + 2,048, batch 4) and
   whisper-medium (6 + 6 of 24 + 24 layers, 1,500 frames + 448
   tokens, batch 8); the depth cut is what 80 GB holds at 16 bytes a
   parameter (weights, gradients, two moments) with room for the
   activations, qwen's and whisper's a quarter of that (the script's
   time);
   the allocator grows expandable segments over phases 20 and 21.
   Three timed steps and one profiled, all on one repeated batch: the
   median of the last two step seconds, tokens/s, peak memory, the
   profiled step's device ms, idle share, largest kernels and
   operators, the first loss against ln(vocab); fails unless every
   loss and ``grad_norm`` is finite (a finite norm is a finite
   gradient everywhere) and the loss falls.
21. fam_train_check -- fails unless (a) for each of the six at one
   super-block (whisper: one encoder and one decoder layer), full
   width, B = 2, L = 64, float32 inputs, the float32 gradients (TF32
   off) of every leaf are within 1e-4 of its largest |g| of the same
   loss's in float64 (mixtral's smallest router top-2 margin printed:
   a margin below rounding could flip an expert); (b) ``launch/
   train.py --preset 100m`` at the launcher's defaults (100 steps,
   batch 8, seq 256: at 30 steps the loss of a fresh batch a step had
   not yet fallen), once whole and once with a checkpoint every 30 and
   a failure at step 32, cut after 40 steps of its 100-step schedule,
   under deterministic algorithms, gives the same loss trail bit for
   bit as the whole run's first 40 (steps 30 and 31 run twice), and
   the whole run's loss falls; (c) the launcher with no arguments (the
   ``20m`` preset, 100 steps), its loss falling.  Every kernel's launch
   count must stay 0 over phases 20 and 21.
22. mesh_model -- the sharded train step: 4 spawned gloo ranks on the
   one card (NCCL refuses two ranks on one device) laid out as a (2, 2)
   ``("data", "model")`` mesh.  (a) qwen1.5-4b at full width, 2 of 40
   layers, float32 activations, TF32 off, AdamW (warmup 1), 3 steps on
   one sequence of 1,024 tokens a data rank (cut from 2,048: four
   ranks' replicated embedding and head state, 13.7 GB a rank, leave
   no room for more float32 logits); a rank's step seconds, tokens/s,
   the collectives' share of a step (``mesh.timers``) and peak memory;
   after the ranks exit the one-device step on the same 2 x 1,024
   must give every step's loss and ``grad_norm`` within 1e-4
   (relative).  (c) the state after (a) saved from (2, 2) (gathered,
   rank 0 writes) and restored onto (1, 4): every leaf, gathered and
   cut back to its (2, 2) block, equal to the saved rank's block bit
   for bit (two int64 checksums of its bits).  (b) mixtral-8x22b's MoE
   layer at full width (8 experts F-split, bf16), 2 x 2,048 tokens a
   data rank, forward and backward of ``sum(y * gy) + lb_loss``, in
   the local (``set_local_moe``) and the GSPMD form: outputs, input
   and router gradients and strided samples of the expert gradients
   within 3e-2 of their largest against the one-device math (the local
   form on each data rank's rows, the GSPMD form on the global batch;
   bf16 partial sums over F), the aux against the data shards' mean.
   Every kernel's launch count must stay 0 over phase 22 (the ranks'
   and this process's).
23. dryrun -- the dry-run sweep (``repro_torch.launch.dryrun``), host
   only: every arch x shape cell on the single (16, 16) recording mesh,
   extrapolated from its depth-1 and depth-2 runs on fake tensors,
   started in ``DRYRUN_WORKERS`` worker processes right after phase 1
   on half the host's cores, the main process keeping the other half.
   It overlaps phases 2-5 (serve, knn, dense, kernels) only: the main
   process waits for its last cell before phase 6, stops the workers
   and takes every core back, and its records are printed here.  One
   line a
   cell and the report's summary and table; fails on a ``fail`` cell,
   a skip without the reference's reason, or a kernel launched in a
   worker.
24. dryrun_check -- the dry-run held to the card: qwen1.5-4b at full
   width, 2 layers, a prefill of 1 x 4,096 and a train step of 1 x
   2,048 on a (1, 1) mesh, once on fake tensors (``launch.cells``, in
   phase 23's workers) and once on the card.  Fails unless ``FlopCounterMode`` counts the
   dry-run's FLOPs exactly on the card's step and the card's peak
   (``max_memory_allocated`` over the step, counted from the same
   starting state) is within 10% of the dry-run's; prints the measured
   step seconds beside max(t_compute, t_memory).  No kernel launched.

Then one ``{"kernels": [...]}`` line (all twelve kernels and the
join's two batched passes; ``launches_by_path`` holds each row's
launches on the ingest, the sharded, the heat, the frontend, the
families, the families' training and the mesh_model paths, and row
12's on the train path),
the card's
name and power limit as ``nvidia-smi`` prints them, and ``{"ok": true,
"device": ...}`` as the last line.  Any failure raises and the script
exits non-zero.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PORT = ROOT / "port"
sys.path.insert(0, str(PORT))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# H100 SXM5, INT32 outside the tensor cores (NVIDIA's H100 white paper):
# the Hilbert encode's integer instructions are counted against it
INT_OPS_PER_S = 33.5e12
PAYLOAD, MAX_HITS, SEED = 4096, 1024, 0
N = 8_000_000          # osm-like objects served
Q, Q_IDS = 4096, 1024  # boxes per range_counts / range_ids batch
BATCHES, ID_BATCHES = 20, 5
CHECK_Q = 1024         # queries of the first counts batch brute-forced
Q_KNN, KNN_BATCHES, K, MAX_CAND = 1024, 5, 10, 1024
CHECK_KNN = 256        # points of the first kNN batch brute-forced
DENSE_ROWS = 256       # rows of the dense calls earlier runs timed
PLAIN_Q = 256          # queries the dense counts' plain versions run on
STAGINGS = ("x", "off", "hilbert")
INDEXED = ("x", "hilbert")  # stagings probed by the *_skip kernels
METHODS = ("fg", "bsp", "slc", "bos", "str", "hc")
JOIN_INPUTS = {"pi": 4_000_000, "osm": 1_000_000}   # objects per side
JOIN_SAMPLE = 4096     # R objects whose partners are brute-forced
HILBERT_SLOTS = 1 << 25   # slots a "hilbert" staging encodes a launch
SOURCE = "port/repro_torch/kernels/range_probe/csrc/range_probe.cu"
HILBERT_SOURCE = "port/repro_torch/kernels/hilbert/csrc/hilbert.cu"
MBR_SOURCE = "port/repro_torch/kernels/mbr_join/csrc/mbr_join.cu"
TPU = "src/repro/kernels/range_probe/kernel.py"
CASES = {  # routed entry point on the serving path -> the TPU kernel
    "gather_count_skip": f"{TPU}:467",
    "gather_hits_skip": f"{TPU}:495",
    "gather_count": f"{TPU}:190",
    "gather_hits": f"{TPU}:215",
}
TABLES = {  # routed hit list -> the table kernel of the same TPU kernel
    "gather_hits_skip": "gather_mask_skip",
    "gather_hits": "gather_mask",
}
HIT_BYTES = 3 * 8      # a hit's (query, tile, slot), int64
PLAIN_TABLE = 80_000_000   # table bytes a block of the plain hit list (its
                           # gathered boxes and temporaries about 25x that)
DENSE_CASES = {  # dense entry point -> the TPU kernel it replaces
    "dense_counts": f"{TPU}:106",
    "dense_hits": f"{TPU}:126",
    "count_skip": f"{TPU}:329",
    "mask_skip": f"{TPU}:354",
}
DENSE_OLD = {  # dense path entry -> the block-per-tile kernel it replaced
    "dense_counts": "count",
    "dense_hits": "mask",
}
BF16_FLOPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
LM_ARCH = "mamba2_1p3b"
PREFILL_B, PREFILL_L = 4, 32_768   # prefill_32k's length; batch 32 -> 4
DECODE_B, DECODE_PROMPT, DECODE_GEN = 128, 32, 32   # decode_32k's batch
CHECK_B, CHECK_L = 2, 200          # float32 prefill-vs-decode check
SSD_TOL = 2e-5                     # the reference's kernel tolerance
LM_TOL = 1e-4                      # tests/test_models_smoke.py's
SSD_SOURCE = "port/repro_torch/kernels/ssd/csrc/ssd.cu"
TRAIN_B, TRAIN_L = 8, 2048         # the Mamba2 paper's training context;
                                   # the global batch cut to 8 sequences
TRAIN_WARM, TRAIN_TIMED = 2, 6     # steps; one more step is profiled
TRAIN_STEPS = TRAIN_WARM + TRAIN_TIMED + 1
TRAIN_FAIL_AT = 3                  # the injected failure (no checkpoint:
                                   # run_loop retries the step)
FT_LAYERS, FT_B, FT_L = 2, 2, 512  # lm_train_check (b): full width
FT_STEPS, FT_EVERY, FT_FAIL_AT = 6, 2, 4
REMAT_B, REMAT_L = 2, 256          # lm_train_check (c), float32
FAM_ARCH = "recurrentgemma_9b"     # fam_prefill, fam_decode, fam_check
FAM_L, FAM_L_CUT, FAM_CUT_S = 32_768, 16_384, 30.0
FAM_CHECK_L, FAM_WRAP_L = 200, 2_600   # fam_check (a) and (b), B = 2
FAMILIES = {  # arch -> layers run (None: all), each at full width;
    # qwen1.5-4b and whisper-medium cut to a quarter of their depth (from
    # all 40 and 24 + 24) to keep the script's time under 1,050 s
    "qwen15_4b": 10, "gemma2_27b": 4, "mixtral_8x22b": 2,
    "arctic_480b": 1, "internvl2_26b": 4, "whisper_medium": 6,
}
FAMILY_L, WHISPER_L = 5_120, 448   # a bf16 prefill's text tokens, B = 1
FAMILY_DECODE = (32, 16, 16)       # batch, prompt, gen
FAMILY_CHECK_B, FAMILY_CHECK_L = 2, 64
FAM_TRAIN = {  # arch -> (layers run (None: all), batch, text tokens)
    # gemma2's batch cut from 4 to 2: its softcapped float32 logits
    # (4 x 2,048 x 256,000, 8.4 GB a pass, four or five live in the
    # backward) do not fit beside 37 GB of state
    # qwen1.5-4b and whisper-medium at a quarter of the depth 80 GB holds
    # (from 20 and 24 + 24) to keep the script's time under 1,050 s:
    # their profiled steps' bookkeeping took 8-9 and 19-22 s at half
    "qwen15_4b": (5, 4, 2_048), "gemma2_27b": (2, 2, 2_048),
    "mixtral_8x22b": (1, 4, 2_048), "recurrentgemma_9b": (3, 2, 4_096),
    "internvl2_26b": (4, 4, 2_048), "whisper_medium": (6, 8, 448),
}
FAM_TRAIN_STEPS = 3        # timed steps on one repeated batch; one more
                           # is profiled
FAM_GRAD_B, FAM_GRAD_L = 2, 64     # fam_train_check (a), one super-block
FAM_GRAD_TOL = 1e-4        # float32 gradients against float64, of the
                           # leaf's largest |g|
# (b) and (c) run the launcher at its defaults (100 steps of 8 x 256
# tokens): at 30 steps of the 100m preset, or 20 of the 20m, the loss
# of a fresh batch a step had not yet fallen below the first.  (b)'s
# restart: three checkpoints of 1.5 GB, a failure two steps after one
PRESET_STEPS, PRESET_EVERY, PRESET_FAIL_AT = 100, 30, 32
PRESET_STOP = 40           # steps of progress the restarted 100m run
                           # makes (its schedule still PRESET_STEPS long)
MM_DIMS, MM_ELASTIC = (2, 2), (1, 4)   # mesh_model's ("data", "model")
MM_AXES = ("data", "model")
MM_ARCH, MM_LAYERS = "qwen15_4b", 2    # (a): full width, depth cut
MM_SEQ, MM_STEPS = 1_024, 3    # a sequence a data rank (cut from 2,048:
                               # four ranks' float32 logits beside 4 x 13 GB
                               # of replicated embedding and head state)
MM_STEP_TOL = 1e-4             # loss and grad_norm against one device,
                               # relative (float32 activations, TF32 off)
MM_MOE_ARCH = "mixtral_8x22b"  # (b): the MoE layer alone, full width
MM_MOE_B, MM_MOE_L = 2, 2_048  # sequences a data rank
MM_MOE_TOL = 3e-2              # bf16 outputs and gradients, of the largest
MM_SAMPLE = (61, 53)           # strides of the expert-gradient samples
MM_DEADLINE_S = 600.0          # the mesh_model phase's ranks, spawn to join
DRYRUN_WORKERS = 4             # processes of the dry-run sweep (host only)
DRYRUN_DEADLINE_S = 900.0      # the sweep, from its start to its last cell
DRYRUN_CHECK_ARCH, DRYRUN_CHECK_LAYERS = "qwen15_4b", 2
DRYRUN_CHECK = (("prefill", 4_096), ("train", 2_048))   # batch 1
DRYRUN_PEAK_TOL = 0.10         # the card's peak against the dry-run's
SSD_TPU = "src/repro/kernels/ssd/kernel.py:41"
NEW_CASES = {  # the join's kernels -> the TPU kernel each replaces
    "hilbert_encode": "src/repro/kernels/hilbert/kernel.py:41",
    "mbr_count": "src/repro/kernels/mbr_join/kernel.py:49",
    "mbr_mask": "src/repro/kernels/mbr_join/kernel.py:67",
    "mbr_rp_counts": "src/repro/kernels/mbr_join/kernel.py:67",
    "mbr_raw_counts": "src/repro/kernels/mbr_join/kernel.py:49",
    "mbr_pair_list": "src/repro/kernels/mbr_join/kernel.py:67",
}
BATCHED = {  # the join's batched passes -> the layout whose plan drives it
    "mbr_rp_counts": "bsp",
    "mbr_raw_counts": "bsp",
    "mbr_pair_list": "hc",
}
PAIR_BYTES = 2 * 4     # a listed pair's (r_id, s_id), int32
INGEST_BASE = 7_000_000    # of the N served objects staged before ingest
INGEST_BATCH = 100_000     # objects an append
INGEST_APPENDS = 10        # the held-out N - INGEST_BASE objects
INGEST_DELETE = 200_000    # ids a delete
INGEST_DELETES = 4
INGEST_UPDATE = 100_000    # ids the update moves
SHORT_APPENDS, SHORT_DELETES = 2, 2    # the "hilbert" and "off" streams
SHORT_BASE = 1_000_000     # of the INGEST_BASE staged, what they start from
SHARDS = 4                 # owners of the sharded servers, join plans and
                           # parallel partitioning, simulated on the card
SHARD_OFF_BATCHES = (4, 2, 2)   # counts, ids, kNN batches of sharded "off"
SHARD_APPENDS, SHARD_DELETES = 3, 2    # the sharded ingest stream
MESH_BATCHES = 3           # batches of each kind a mesh rank serves
MESH_TILES, MESH_PER_TILE = 100, 100   # the mesh append: objects in the
                           # centres of the least-filled tiles (no overflow)
MESH_DELETE = 100_000      # ids the mesh delete tombstones
MESH_DEADLINE_S = 900.0    # the mesh phase's ranks, spawn to join
HOT_FRAC = 0.85            # query centres in the hot patch (the hotspot bench)
HEAT_DECAY, HEAT_TOP = 0.85, 64    # the heat placement's policy
HEAT_LEG, HEAT_HOT = 5, 10         # counts batches a leg; leg (c) hot
HEAT_IDS, HEAT_KNN = 5, 5          # leg (c)'s ids and kNN batches
HEAT_CHECK = 128           # rows of every hot counts batch brute-forced
HEAT_EVERY, HEAT_EVERY_BATCHES = 4, 12     # rebalance_every, its batches
HEAT_APPENDS, HEAT_DELETE, HEAT_UPDATE = 2, 200_000, 50_000
FE_MIX = {"range_counts": 0.7, "range_ids": 0.2, "knn": 0.1}
FE_ARRIVALS, FE_HEAT_ARRIVALS = 20_000, 2_000   # a run's arrivals
FE_DEADLINE = 0.05         # the 1.5 R run's default deadline (s)
FE_ASYNC = 1024            # concurrent submissions to the asyncio frontend


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def qboxes(torch, g, q: int, half: float, dev):
    c = torch.rand(q, 2, generator=g, device=dev)
    s = torch.rand(q, 2, generator=g, device=dev) * half
    return torch.cat([c - s, c + s], dim=-1)


def brute_hits(geometry, mbrs, q):
    """(B, 4) queries vs all objects -> (B, N) bool, closed boxes."""
    return geometry.intersects(q[:, None, :], mbrs[None, :, :])


def check_counts(torch, geometry, mbrs, q, counts, block=32):
    for i in range(0, q.shape[0], block):
        want = brute_hits(geometry, mbrs, q[i:i + block]).sum(
            1, dtype=torch.int32)
        if not torch.equal(want, counts[i:i + block]):
            raise AssertionError(f"range_counts disagree with brute force "
                                 f"in queries {i}..{i + block}")


def check_ids(torch, geometry, mbrs, q, hit_ids, counts, overflow,
              max_hits, block=32):
    n_over = 0
    for i in range(0, q.shape[0], block):
        hit = brute_hits(geometry, mbrs, q[i:i + block])
        b = hit.shape[0]
        true_n = hit.sum(1, dtype=torch.int32)
        row, col = hit.nonzero(as_tuple=True)          # ascending ids
        start = torch.cumsum(true_n, 0) - true_n
        rank = torch.arange(row.shape[0], device=q.device) - start[row]
        keep = rank < max_hits
        want = torch.full((b, max_hits), -1, dtype=torch.int32,
                          device=q.device)
        want[row[keep], rank[keep]] = col[keep].to(torch.int32)
        ok = (torch.equal(want, hit_ids[i:i + b])
              and torch.equal(true_n, counts[i:i + b])
              and torch.equal(true_n > max_hits, overflow[i:i + b]))
        if not ok:
            raise AssertionError(f"range_ids disagree with brute force in "
                                 f"queries {i}..{i + b}")
        n_over += int((true_n > max_hits).sum())
    return n_over


def device_busy(torch, fn, reps: int):
    """Device time per call from torch.profiler (kernels, copies and
    sets on the card), and the five largest device consumers."""
    return device_items(profile_of(torch, fn, reps), reps)


def device_ops(torch, fn, reps: int, n: int = 8):
    """``device_busy`` with the operators too: device ms per call, the
    five largest kernels and the ``n`` largest operators by the device
    time of the kernels they launch (ms per call, calls per call)."""
    prof = profile_of(torch, fn, reps)
    dev_ms, top = device_items(prof, reps)
    return dev_ms, top, [[k, ms / reps, c / reps]
                         for k, ms, c in top_ops(prof, n)]


def profile_of(torch, fn, reps: int):
    """``fn`` run ``reps`` times under torch.profiler -> the profile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def device_items(prof, reps: int, top: int = 5):
    """A finished profile's device ms per call, and its ``top`` largest
    device consumers."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    items = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), [[k[:80], v] for k, v in items]


def serve_phase(torch, dev):
    from repro_torch.core import geometry
    from repro_torch.data import spatial_gen
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.serve import ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cbatches = [qboxes(torch, g, Q, 0.03, dev)
                for _ in range(BATCHES)]
    ibatches = [qboxes(torch, g, Q_IDS, 0.003, dev)
                for _ in range(ID_BATCHES)]

    kernel.reset_launches()
    hkernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    servers, results = {}, {}
    for li in STAGINGS:
        t0 = time.perf_counter()
        srv = SpatialServer.from_method("bsp", mbrs, PAYLOAD,
                                        ServeConfig(local_index=li),
                                        device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        servers[li] = srv

        srv.range_counts(cbatches[0])               # warm-up (loads kernel)
        srv.range_ids(ibatches[0], max_hits=MAX_HITS)
        torch.cuda.synchronize()
        counts, c_ms, f_max, fan = [], [], 0, []
        for qb in cbatches:
            t0 = time.perf_counter()
            cnt, st = srv.range_counts(qb)
            torch.cuda.synchronize()
            c_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(cnt)
            f_max = max(f_max, st["f_max"])
            fan.append(st["fanout_mean"])
        ids, i_ms, i_fmax = [], [], 0
        for qb in ibatches:
            t0 = time.perf_counter()
            out = srv.range_ids(qb, max_hits=MAX_HITS)
            torch.cuda.synchronize()
            i_ms.append((time.perf_counter() - t0) * 1e3)
            ids.append(out[:3])
            i_fmax = max(i_fmax, out[3]["f_max"])
        dev_ms, top = device_busy(torch, lambda: srv.range_counts(
            cbatches[1 % len(cbatches)]), 3)
        dev_ids_ms, top_ids = device_busy(torch, lambda: srv.range_ids(
            ibatches[1 % len(ibatches)], max_hits=MAX_HITS), 3)
        results[li] = dict(counts=counts, ids=ids)
        emit(dict(
            phase="serve", local_index=li, n=N, payload=PAYLOAD,
            t=srv.stats["t"], cap=srv.stats["cap"],
            t_live=srv.stats["t_live"], chunks=srv.stats["chunks"],
            replication=srv.stats["replication"], stage_s=stage_s,
            gen_s=gen_s, resident_tile_bytes=srv.resident_tile_bytes(),
            counts=dict(q=Q, batches=len(c_ms),
                        qps=Q * len(c_ms) / (sum(c_ms) / 1e3),
                        p50_ms=pct(c_ms, 0.5), p99_ms=pct(c_ms, 0.99),
                        f_max=f_max,
                        fanout_mean=sum(fan) / len(fan),
                        device_ms_per_batch=dev_ms, top_device=top,
                        chunk_skip_rate=srv.chunk_skip_rate(cbatches[0])),
            ids=dict(q=Q_IDS, batches=len(i_ms),
                     qps=Q_IDS * len(i_ms) / (sum(i_ms) / 1e3),
                     p50_ms=pct(i_ms, 0.5), p99_ms=pct(i_ms, 0.99),
                     f_max=i_fmax, device_ms_per_batch=dev_ids_ms,
                     top_device=top_ids, select_sweep_in_top5=any(
                         "SelectSweep" in k for k, _ in top_ids)),
            max_memory_allocated=torch.cuda.max_memory_allocated()))
    launches = dict(kernel.LAUNCHES)
    encode_launches = hkernel.LAUNCHES["encode"]

    for li in ("off", "hilbert"):
        for a, b in zip(results["x"]["counts"], results[li]["counts"]):
            if not torch.equal(a, b):
                raise AssertionError(f'counts of local_index "x" and '
                                     f'"{li}" differ')
        for a, b in zip(results["x"]["ids"], results[li]["ids"]):
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                raise AssertionError(f'ids of local_index "x" and "{li}" '
                                     f'differ')
    check_counts(torch, geometry, mbrs, cbatches[0][:CHECK_Q],
                 results["x"]["counts"][0][:CHECK_Q])
    hit_ids, cnt, ovf = results["x"]["ids"][0]
    n_over = check_ids(torch, geometry, mbrs, ibatches[0], hit_ids, cnt, ovf,
                       MAX_HITS)
    emit(dict(phase="check", x_equals_off=True, x_equals_hilbert=True,
              encode_launches=encode_launches, brute_force_counts=CHECK_Q,
              brute_force_ids=Q_IDS, overflowed_queries=n_over,
              hits_in_first_counts_batch=int(results["x"]["counts"][0].sum())))
    for name in CASES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the serving "
                                 f"path: {launches}")
    for name in TABLES.values():
        if launches[name]:
            raise AssertionError(f"{name} built a hit table on the serving "
                                 f"path: {launches}")
    if encode_launches <= 0:
        raise AssertionError("encode was not launched by the hilbert "
                             "staging")
    # per server: warm-up + timed + profiled batches
    calls = dict(counts=1 + len(cbatches) + 3, ids=1 + len(ibatches) + 3)
    return (servers, mbrs, cbatches[0], ibatches[0], results["x"],
            launches, calls, encode_launches,
            dict(counts=cbatches, ids=ibatches))


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def knn_brute(torch, knn_mod, mbrs, pts, k, block=8):
    """Exact kNN over all objects by the key ``bits(d2) << 32 | id``
    (d2 >= 0, so its bits order as its values) -> ``(ids, d2)``."""
    ar = torch.arange(mbrs.shape[0], device=mbrs.device)
    ids, d2s = [], []
    for i in range(0, pts.shape[0], block):
        d2 = knn_mod.mindist2_fused(pts[i:i + block], mbrs)
        key = (d2.view(torch.int32).long() << 32) | ar
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        ids.append((top & 0xFFFFFFFF).to(torch.int32))
        d2s.append((top >> 32).to(torch.int32).view(torch.float32))
    return torch.cat(ids), torch.cat(d2s)


def knn_phase(torch, servers, mbrs, dev):
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.query import knn as knn_mod

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    batches = [torch.rand(Q_KNN, 2, generator=g, device=dev)
               for _ in range(KNN_BATCHES)]
    kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    answers = {}
    for li in STAGINGS:
        srv = servers[li]
        ms, out = [], []
        for pts in batches:
            t0 = time.perf_counter()
            nn_ids, nn_d2, ovf, st = srv.knn(pts, K, max_cand=MAX_CAND)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(((nn_ids, nn_d2, ovf), st))
        dev_ms, top = device_busy(torch, lambda: srv.knn(
            batches[1], K, max_cand=MAX_CAND), 3)
        answers[li] = [a for a, _ in out]
        stats = [st for _, st in out]
        emit(dict(
            phase="knn", local_index=li, q=Q_KNN, k=K, max_cand=MAX_CAND,
            batches=len(ms), batch_ms=ms,
            qps=Q_KNN * len(ms) / (sum(ms) / 1e3), p50_ms=pct(ms, 0.5),
            p99_ms=pct(ms, 0.99), device_ms_per_batch=dev_ms,
            top_device=top, select_sweep_in_top5=any(
                "SelectSweep" in k for k, _ in top),
            f_max=[st["f_max"] for st in stats],
            retries=[st["retries"] for st in stats],
            max_rounds=max(st["rounds"] for st in stats),
            fanout_mean=sum(st["fanout_mean"] for st in stats) / len(stats),
            overflowed=sum(int(a[2].sum()) for a in answers[li]),
            max_memory_allocated=torch.cuda.max_memory_allocated()))
    launches = dict(kernel.LAUNCHES)

    for li in ("off", "hilbert"):
        for (xi, xd, xo), (oi, od, oo) in zip(answers["x"], answers[li]):
            if not (torch.equal(xo, oo) and torch.equal(xi[~xo], oi[~oo])
                    and torch.equal(xd[~xo], od[~oo])):
                raise AssertionError(f'kNN of local_index "x" and "{li}" '
                                     f'differ')
    nn_ids, nn_d2, ovf = answers["x"][0]
    want_ids, want_d2 = knn_brute(torch, knn_mod, mbrs,
                                  batches[0][:CHECK_KNN], K)
    ok = ~ovf[:CHECK_KNN]
    if not (torch.equal(nn_ids[:CHECK_KNN][ok], want_ids[ok])
            and torch.equal(nn_d2[:CHECK_KNN][ok], want_d2[ok])):
        raise AssertionError("kNN disagrees with the brute force")
    for name in CASES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the kNN "
                                 f"path: {launches}")
    for name in TABLES.values():
        if launches[name]:
            raise AssertionError(f"{name} built a hit table on the kNN "
                                 f"path: {launches}")
    emit(dict(phase="knn_check", x_equals_off_unflagged=True,
              x_equals_hilbert_unflagged=True,
              brute_force_points=CHECK_KNN,
              flagged_in_checked=int((~ok).sum()), launches=launches))
    return batches[0], answers["x"][0], launches, batches, answers["x"]


def dense_phase(torch, srv, mbrs, qc, qi, pts, pruned_x, pruned_knn):
    """The dense oracle on whole batches against the pruned answers of
    the same inputs and the on-card brute force -> the dense kernels'
    launches."""
    from repro_torch.core import geometry
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.query import knn as knn_mod

    kernel.reset_launches()
    calls = {}

    def timed(name, fn, reps=3):
        """``reps`` timed calls and one profiled -> the first answer."""
        before = dict(kernel.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms, out = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out = got if out is None else out
        peak = torch.cuda.max_memory_allocated()
        dev_ms, top = device_busy(torch, fn, 1)
        calls[name] = dict(
            ms=ms, p50_ms=median(ms), device_ms=dev_ms, top_device=top,
            idle_share=1 - dev_ms / median(ms), peak_bytes=peak,
            peak_above_resident=peak - resident,
            launches_per_call={k: (v - before[k]) / (reps + 1)
                               for k, v in kernel.LAUNCHES.items()
                               if v != before[k]})
        return out

    counts, _ = timed("range_counts", lambda: srv.range_counts(
        qc, pruned=False))
    if not torch.equal(counts, pruned_x["counts"][0]):
        raise AssertionError("dense range_counts differ from pruned")
    check_counts(torch, geometry, mbrs, qc[:CHECK_Q], counts[:CHECK_Q])
    ids = timed("range_ids", lambda: srv.range_ids(
        qi, max_hits=MAX_HITS, pruned=False))
    if not all(torch.equal(u, v) for u, v in zip(ids[:3],
                                                 pruned_x["ids"][0])):
        raise AssertionError("dense range_ids differ from pruned")
    check_ids(torch, geometry, mbrs, qi, *ids[:3], MAX_HITS)
    timed("range_ids_256", lambda: srv.range_ids(
        qi[:DENSE_ROWS], max_hits=MAX_HITS, pruned=False))
    nn_ids, nn_d2, ovf, st = timed("knn", lambda: srv.knn(
        pts, K, max_cand=MAX_CAND, pruned=False))
    p_ids, p_d2, p_ovf = pruned_knn
    ok = ~(ovf | p_ovf)
    if not (torch.equal(nn_ids[ok], p_ids[ok])
            and torch.equal(nn_d2[ok], p_d2[ok])):
        raise AssertionError("dense kNN differs from pruned")
    want_ids, want_d2 = knn_brute(torch, knn_mod, mbrs, pts[:CHECK_KNN], K)
    mine = ~ovf[:CHECK_KNN]
    if not (torch.equal(nn_ids[:CHECK_KNN][mine], want_ids[mine])
            and torch.equal(nn_d2[:CHECK_KNN][mine], want_d2[mine])):
        raise AssertionError("dense kNN disagrees with the brute force")
    timed("knn_256", lambda: srv.knn(pts[:DENSE_ROWS], K, max_cand=MAX_CAND,
                                     pruned=False))
    launches = dict(kernel.LAUNCHES)
    for name in DENSE_OLD:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the dense "
                                 f"path: {launches}")
    for name in DENSE_OLD.values():
        if launches[name]:
            raise AssertionError(f"{name} was launched on the dense path: "
                                 f"{launches}")
    emit(dict(phase="dense", counts_q=qc.shape[0], ids_q=qi.shape[0],
              knn_q=pts.shape[0], calls=calls, knn_rounds=st["rounds"],
              knn_flagged=int((~ok).sum()), equal_to_pruned=True,
              brute_force_counts=CHECK_Q, brute_force_ids=qi.shape[0],
              brute_force_knn=int(mine.sum()), launches=launches))
    return launches


def ingest_op(torch, log, kind, fn):
    """One timed ingest call -> its report; ``log`` gets its wall ms
    (ending in a synchronize), bytes uploaded, re-stage and
    compaction."""
    t0 = time.perf_counter()
    rep = fn()
    torch.cuda.synchronize()
    log.append(dict(op=kind, ms=(time.perf_counter() - t0) * 1e3,
                    bytes_transferred=rep["bytes_transferred"],
                    restaged=rep["restaged"],
                    compacted_tiles=rep.get("compacted_tiles", 0),
                    n=rep["n"]))
    return rep


class LiveSet:
    """The ingest stream's live set on the card: every id's current box
    and whether it is live, for the brute force and the fresh staging."""

    def __init__(self, torch, boxes, g):
        self.torch, self.g = torch, g
        self.boxes = boxes.clone()
        self.alive = torch.ones(boxes.shape[0], dtype=torch.bool,
                                device=boxes.device)

    def append(self, boxes):
        t = self.torch
        self.boxes = t.cat([self.boxes, boxes])
        self.alive = t.cat([self.alive, t.ones(boxes.shape[0],
                                               dtype=t.bool,
                                               device=boxes.device)])

    def pick(self, k):
        """``k`` random live ids, on the card."""
        live = self.alive.nonzero().squeeze(1)
        perm = self.torch.randperm(live.numel(), generator=self.g,
                                   device=live.device)
        return live[perm[:k]]

    def live(self):
        """-> (ascending live ids, their boxes)."""
        ids = self.alive.nonzero().squeeze(1)
        return ids, self.boxes[ids]


def burst_boxes(torch, parts, m):
    """``m`` coincident objects at the centre of tile 0's region."""
    tb = parts.boxes[0]
    ctr = torch.stack([(tb[0] + tb[2]) / 2, (tb[1] + tb[3]) / 2])
    return torch.cat([ctr, ctr]).expand(m, 4).contiguous()


def extent_slack(torch, ops, srv):
    """Fail unless the live extent covers every alive slot -> the
    tiles whose extent is larger than tight."""
    ext, tight = srv.tiles.extent, ops.live_extent(srv.layout.alive)
    if not bool((ext >= tight).all()):
        raise AssertionError("an alive slot lies past its tile's extent")
    return int((ext > tight).sum())


def ingest_queries(srv, qc, qi, pts):
    """A counts, an ids and a kNN batch and the dense counts."""
    return dict(counts=srv.range_counts(qc)[0],
                ids=srv.range_ids(qi, max_hits=MAX_HITS)[:3],
                knn=srv.knn(pts, K, max_cand=MAX_CAND)[:3],
                dense=srv.range_counts(qc, pruned=False)[0])


def knn_agree(torch, a, b):
    (ai, ad, ao), (bi, bd, bo) = a, b
    return (torch.equal(ao, bo) and torch.equal(ai[~ao], bi[~bo])
            and torch.equal(ad[~ao], bd[~bo]))


def ingest_phase(torch, dev):
    """Queue 1 item 9 on the card -> launches of each kernel on the
    ingest path."""
    from repro_torch.core import geometry
    from repro_torch.core.partition import api
    from repro_torch.core.partition.assign import membership, round_up
    from repro_torch.data import spatial_gen
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.range_probe import kernel, ops
    from repro_torch.query import knn as knn_mod
    from repro_torch.serve import ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    qc = qboxes(torch, g, Q, 0.03, dev)
    qi = qboxes(torch, g, Q_IDS, 0.003, dev)
    pts = torch.rand(Q_KNN, 2, generator=g, device=dev)
    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    base, held = mbrs[:INGEST_BASE], mbrs[INGEST_BASE:]
    t0 = time.perf_counter()
    parts = api.partition("bsp", base, PAYLOAD)
    torch.cuda.synchronize()
    partition_s = time.perf_counter() - t0
    # slack for the held-out objects' copies in their fullest tile
    _, part = membership(parts, held)
    slack = round_up(int(torch.bincount(part, minlength=parts.kmax).max()),
                     128)
    del part

    kernel.reset_launches()
    hkernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    log, model = [], LiveSet(torch, base, g)
    t0 = time.perf_counter()
    srv = SpatialServer(parts, base, ServeConfig(slack=slack), device=dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    cap0 = srv.stats["cap"]
    t0 = time.perf_counter()
    srv.tiles._ensure_mirror()         # the first mutation's host mirrors
    mirror_s = [time.perf_counter() - t0]
    for i in range(INGEST_APPENDS):
        new = held[i * INGEST_BATCH:(i + 1) * INGEST_BATCH]
        if ingest_op(torch, log, "append", lambda: srv.append(new))[
                "restaged"]:
            raise AssertionError("an append into the slack re-staged")
        model.append(new)
    for _ in range(INGEST_DELETES):
        ids = model.pick(INGEST_DELETE)
        ingest_op(torch, log, "delete", lambda: srv.delete(ids))
        model.alive[ids] = False
    # compaction reclaims the deleted objects' copies too: an update
    # inserts 1 + lambda copies an object and frees only its canonical
    # slot, so before it the update overflows the slack and re-stages
    ingest_op(torch, log, "compact", srv.compact)
    after_compact = extent_slack(torch, ops, srv)
    ids = model.pick(INGEST_UPDATE)
    shift = (torch.rand(ids.numel(), 2, generator=g, device=dev) - 0.5) * 2e-3
    new = model.boxes[ids] + torch.cat([shift, shift], 1)
    if ingest_op(torch, log, "update", lambda: srv.update(ids, new))[
            "restaged"]:
        raise AssertionError("the update after compaction re-staged")
    model.boxes[ids] = new
    new = burst_boxes(torch, parts, srv.stats["cap"] + 1)
    if not ingest_op(torch, log, "burst", lambda: srv.append(new))[
            "restaged"]:
        raise AssertionError("the burst of cap + 1 objects did not re-stage")
    model.append(new)
    after_restage = extent_slack(torch, ops, srv)
    t0 = time.perf_counter()
    srv.tiles._ensure_mirror()         # rebuilt after the re-stage
    mirror_s.append(time.perf_counter() - t0)
    ids = model.pick(INGEST_DELETE)
    ingest_op(torch, log, "delete", lambda: srv.delete(ids))
    model.alive[ids] = False
    stale = extent_slack(torch, ops, srv)
    got = ingest_queries(srv, qc, qi, pts)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if after_compact or after_restage:
        raise AssertionError("the extent is not tight after compact or "
                             "re-stage")

    # the checks: brute force and a fresh staging of the live set
    live_ids, live_boxes = model.live()
    if srv.stats["n"] != live_ids.numel():
        raise AssertionError("the server's n is not the live count")
    check_counts(torch, geometry, live_boxes, qc, got["counts"])
    if not torch.equal(got["dense"], got["counts"]):
        raise AssertionError("dense counts differ from pruned after ingest")
    t0 = time.perf_counter()
    fresh = SpatialServer(parts, live_boxes, ServeConfig(), device=dev)
    torch.cuda.synchronize()
    fresh_stage_s = time.perf_counter() - t0
    want = ingest_queries(fresh, qc, qi, pts)
    remap = lambda a: torch.where(a >= 0, live_ids[a.clamp_min(0)].to(  # noqa
        a.dtype), a)
    hid, cnt, ovf = want["ids"]
    if not (torch.equal(got["counts"], want["counts"])
            and all(torch.equal(u, v) for u, v in zip(
                got["ids"], (remap(hid), cnt, ovf)))):
        raise AssertionError("ingested answers differ from a fresh staging")
    nn, d2, kovf = want["knn"]
    if not knn_agree(torch, got["knn"], (remap(nn), d2, kovf)):
        raise AssertionError("ingested kNN differs from a fresh staging")
    ok = ~kovf[:CHECK_KNN]
    b_ids, b_d2 = knn_brute(torch, knn_mod, live_boxes, pts[:CHECK_KNN], K)
    if not (torch.equal(got["knn"][0][:CHECK_KNN][ok], remap(b_ids)[ok])
            and torch.equal(got["knn"][1][:CHECK_KNN][ok], b_d2[ok])):
        raise AssertionError("ingested kNN disagrees with the brute force")
    c_ms = {"ingested": [], "fresh": []}
    for _ in range(7):                 # in turns, one clock
        for name, s in (("ingested", srv), ("fresh", fresh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.range_counts(qc)
            torch.cuda.synchronize()
            c_ms[name].append((time.perf_counter() - t0) * 1e3)
    emit(dict(
        phase="ingest", local_index="x", base=INGEST_BASE, held=N - INGEST_BASE,
        payload=PAYLOAD, t=srv.stats["t"], slack=slack, cap_staged=cap0,
        cap=srv.stats["cap"], n=srv.stats["n"], n_total=srv.stats["n_total"],
        partition_s=partition_s, stage_s=stage_s, mirror_s=mirror_s,
        ops=log, compact_s=[e["ms"] / 1e3 for e in log
                            if e["op"] == "compact"][0],
        restage_s=[e["ms"] / 1e3 for e in log if e["op"] == "burst"][0],
        fresh_stage_s=fresh_stage_s, tiles_extent_above_tight=stale,
        counts_p50_ms=dict(ingested=median(c_ms["ingested"]),
                           fresh=median(c_ms["fresh"])),
        counts_ms=c_ms, max_memory_allocated=peak,
        equal_to_fresh_staging=True, brute_force_counts=Q,
        brute_force_knn=int(ok.sum()), knn_flagged=int(kovf.sum()),
        launches=launches))
    del srv, fresh, got, want, model, live_boxes, live_ids
    torch.cuda.empty_cache()

    # shorter streams: "hilbert" (its compaction launches the encode)
    # and "off" (the unindexed kernels), the same commands on each
    kernel.reset_launches()
    hkernel.reset_launches()
    answers, short = {}, {}
    short_base = base[:SHORT_BASE]
    for li in ("hilbert", "off"):
        gs = torch.Generator(device=dev).manual_seed(SEED + 4)
        log, model = [], LiveSet(torch, short_base, gs)
        srv = SpatialServer(parts, short_base, ServeConfig(local_index=li,
                                                           slack=slack),
                            device=dev)
        t0 = time.perf_counter()
        srv.tiles._ensure_mirror()
        mirror = time.perf_counter() - t0
        for i in range(SHORT_APPENDS):
            new = held[i * INGEST_BATCH:(i + 1) * INGEST_BATCH]
            ingest_op(torch, log, "append", lambda: srv.append(new))
            model.append(new)
        for _ in range(SHORT_DELETES):
            ids = model.pick(INGEST_DELETE)
            ingest_op(torch, log, "delete", lambda: srv.delete(ids))
            model.alive[ids] = False
        before = hkernel.LAUNCHES["encode"]
        ingest_op(torch, log, "compact", srv.compact)
        compact_encode = hkernel.LAUNCHES["encode"] - before
        if extent_slack(torch, ops, srv):
            raise AssertionError("the extent is not tight after compact")
        if li == "hilbert" and compact_encode <= 0:
            raise AssertionError('"hilbert" compaction did not launch the '
                                 'encode')
        answers[li] = ingest_queries(srv, qc, qi, pts)
        short[li] = dict(ops=log, mirror_s=mirror, n=srv.stats["n"],
                         compact_encode_launches=compact_encode)
        del srv
    short_launches = dict(kernel.LAUNCHES)
    encode = hkernel.LAUNCHES["encode"]
    a, b = answers["hilbert"], answers["off"]
    if not (torch.equal(a["counts"], b["counts"])
            and torch.equal(a["dense"], b["counts"])
            and all(torch.equal(u, v) for u, v in zip(a["ids"], b["ids"]))
            and knn_agree(torch, a["knn"], b["knn"])):
        raise AssertionError('"hilbert" and "off" answers differ after '
                             'ingest')
    check_counts(torch, geometry, model.live()[1], qc[:CHECK_Q],
                 a["counts"][:CHECK_Q])
    launches = {k: launches[k] + short_launches[k] for k in launches}
    launches["encode"] = encode
    for name in ("gather_count_skip", "gather_hits_skip", "gather_count",
                 "gather_hits", "dense_counts", "encode"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the ingest "
                                 f"path: {launches}")
    emit(dict(phase="ingest_short", base=SHORT_BASE, streams=short,
              hilbert_equals_off=True, brute_force_counts=CHECK_Q,
              launches=launches))
    del answers, model, mbrs, base, held, short_base
    torch.cuda.empty_cache()
    return launches


def shard_extent_slack(torch, ops, srv):
    """Fail unless every shard row's live extent covers its alive slots
    -> the rows whose extent is larger than tight."""
    ext = srv.tiles.extent
    tight = ops.live_extent(srv.slayout.alive_shards.flatten(0, 1)).view(
        ext.shape)
    if not bool((ext >= tight).all()):
        raise AssertionError("an alive slot lies past its shard row's "
                             "extent")
    return int((ext > tight).sum())


def knn_within(torch, a, b):
    """Sharded kNN ``a`` against the replicated ``b``: an owner flags
    past max_cand of its own candidates, so ``a``'s flags are a subset
    of ``b``'s; where neither flags, ids and d2 are equal."""
    (ai, ad, ao), (bi, bd, bo) = a, b
    both = ~ao & ~bo
    return (not bool((ao & ~bo).any()) and torch.equal(ai[both], bi[both])
            and torch.equal(ad[both], bd[both])), int((bo & ~ao).sum())


def sharded_serve(torch, dev, parts, mbrs, li, batches, pruned_x, knn_x,
                  sizes, checked, keep=None):
    """One sharded server (``SHARDS`` owners simulated on the card) over
    the serve phase's batches -> its launches.  ``keep``, when given,
    receives what the mesh phase holds its ranks to (``mesh_keep``)."""
    from repro_torch.core import geometry
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.query import knn as knn_mod
    from repro_torch.serve import ServeConfig, SpatialServer

    n_counts, n_ids, n_knn = sizes
    count_kernel = "gather_count_skip" if li != "off" else "gather_count"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    t0 = time.perf_counter()
    srv = SpatialServer(parts, mbrs, ServeConfig(placement="sharded",
                                                 shards=SHARDS,
                                                 local_index=li), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    xkeys = ("qpd", "skew", "messages", "m_per_pair", "f_local",
             "probe_load_imbalance", "exchange_bytes", "probe_rows")
    c_ms, split, xs, counts = [], [], [], []
    for i, qb in enumerate(batches["counts"][:n_counts]):
        before = kernel.LAUNCHES[count_kernel]
        t0 = time.perf_counter()
        cnt, st = srv.range_counts(qb)
        torch.cuda.synchronize()
        c_ms.append((time.perf_counter() - t0) * 1e3)
        if kernel.LAUNCHES[count_kernel] - before != 1:
            raise AssertionError(f"a sharded counts batch launched "
                                 f"{count_kernel} "
                                 f"{kernel.LAUNCHES[count_kernel] - before} "
                                 f"times, not once")
        if not torch.equal(cnt, pruned_x["counts"][i]):
            raise AssertionError(f'sharded "{li}" counts differ from the '
                                 f'replicated "x" server in batch {i}')
        split.append(srv.tiles.split_ms)
        xs.append({k: st[k] for k in xkeys})
        counts.append(cnt)
    i_ms, i_split, ids = [], [], []
    for i, qb in enumerate(batches["ids"][:n_ids]):
        t0 = time.perf_counter()
        out = srv.range_ids(qb, max_hits=MAX_HITS)
        torch.cuda.synchronize()
        i_ms.append((time.perf_counter() - t0) * 1e3)
        i_split.append(srv.tiles.split_ms)
        if not all(torch.equal(u, v) for u, v in zip(out[:3],
                                                      pruned_x["ids"][i])):
            raise AssertionError(f'sharded "{li}" ids differ from the '
                                 f'replicated "x" server in batch {i}')
        ids.append(out[:3])
    k_ms, k_split, knn, rounds, only_x = [], [], [], [], 0
    for i, pts in enumerate(batches["knn"][:n_knn]):
        t0 = time.perf_counter()
        out = srv.knn(pts, K, max_cand=MAX_CAND)
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
        k_split.append(srv.tiles.split_ms)
        ok, extra = knn_within(torch, out[:3], knn_x[i])
        if not ok:
            raise AssertionError(f'sharded "{li}" kNN differs from the '
                                 f'replicated "x" server in batch {i}')
        only_x += extra
        rounds.append(out[3]["rounds"])
        knn.append(out[:3])
    launches = dict(kernel.LAUNCHES)
    qc, qi, pts = (batches[k][0] for k in ("counts", "ids", "knn"))
    dev_c, top_c = device_busy(torch, lambda: srv.range_counts(qc), 3)
    dev_i, _ = device_busy(torch, lambda: srv.range_ids(
        qi, max_hits=MAX_HITS), 3)
    dev_k, top_k = device_busy(torch, lambda: srv.knn(
        pts, K, max_cand=MAX_CAND), 3)
    kernel.LAUNCHES.update(launches)            # the profiled repeats'
    row = dict(phase="sharded", local_index=li, shards=SHARDS, n=N,
               t=srv.stats["t"], t_local=srv.stats["t_local"],
               cap=srv.stats["cap"], build_s=build_s,
               build_peak_memory=build_peak,
               resident_tile_bytes=srv.resident_tile_bytes(),
               shard_bytes=srv.stats["shard_bytes"],
               placement_skew=srv.stats["placement_skew"])
    for name, ms, dms, sp in (("counts", c_ms, dev_c, split),
                              ("ids", i_ms, dev_i, i_split),
                              ("knn", k_ms, dev_k, k_split)):
        row[name] = dict(batches=len(ms), batch_ms=ms, p50_ms=pct(ms, 0.5),
                         p99_ms=pct(ms, 0.99), device_ms_per_batch=dms,
                         idle_share=1.0 - dms / pct(ms, 0.5),
                         owner_split_ms=sp,
                         owner_split_p50_ms=pct(sp, 0.5))
    row["counts"]["exchange"] = xs
    row["counts"]["top_device"] = top_c
    row["knn"].update(top_device=top_k, rounds=rounds,
                      flagged_by_replicated_only=only_x)
    if checked:
        # the dense oracle on the first batch of each kind, and the
        # brute force on the serve phase's checked sample
        before = dict(kernel.LAUNCHES)
        t0 = time.perf_counter()
        dc = srv.range_counts(qc, pruned=False)[0]
        di = srv.range_ids(qi, max_hits=MAX_HITS, pruned=False)[:3]
        dk = srv.knn(pts, K, max_cand=MAX_CAND, pruned=False)[:3]
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        dense = {k: kernel.LAUNCHES[k] - before[k] for k in before}
        if not (torch.equal(dc, counts[0])
                and all(torch.equal(u, v) for u, v in zip(di, ids[0]))):
            raise AssertionError("the sharded dense oracle differs from "
                                 "the sharded pruned answers")
        (ai, ad, ao), (bi, bd, bo) = knn[0], dk
        both = ~ao & ~bo
        if not (torch.equal(ai[both], bi[both])
                and torch.equal(ad[both], bd[both])):
            raise AssertionError("the sharded dense kNN differs from the "
                                 "pruned kNN")
        check_counts(torch, geometry, mbrs, qc[:CHECK_Q], counts[0][:CHECK_Q])
        check_ids(torch, geometry, mbrs, qi, *ids[0], MAX_HITS)
        ok = ~knn[0][2][:CHECK_KNN]
        b_ids, b_d2 = knn_brute(torch, knn_mod, mbrs, pts[:CHECK_KNN], K)
        if not (torch.equal(knn[0][0][:CHECK_KNN][ok], b_ids[ok])
                and torch.equal(knn[0][1][:CHECK_KNN][ok], b_d2[ok])):
            raise AssertionError("sharded kNN disagrees with the brute "
                                 "force")
        row.update(dense_s=dense_s, dense_launches=dense,
                   brute_force_counts=CHECK_Q, brute_force_ids=Q_IDS,
                   brute_force_knn=int(ok.sum()))
        for name in ("dense_counts", "dense_hits"):
            if dense[name] <= 0:
                raise AssertionError(f"the sharded dense oracle did not "
                                     f"launch {name}: {dense}")
    launches = dict(kernel.LAUNCHES)
    row.update(equal_to_replicated_x=True, launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(row)
    if keep is not None:
        mesh_keep(torch, srv, mbrs, parts, batches, counts, ids, knn,
                  build_peak, keep)
    del srv
    torch.cuda.empty_cache()
    return launches


def sharded_ingest(torch, dev, parts, mbrs, batches):
    """A short stream on a sharded "x" server staged over the served
    objects with slack for the appends; then one batch of each kind
    against a fresh sharded staging of the live set -> launches."""
    from repro_torch.core import geometry
    from repro_torch.core.partition.assign import membership, round_up
    from repro_torch.kernels.range_probe import kernel, ops
    from repro_torch.serve import ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    # the appends: served objects resampled and shifted by up to 1e-4, so
    # they follow the served hotspots (a fresh osm_like draw puts its
    # hotspots elsewhere: 112,512 slots of slack in one tile)
    m = SHARD_APPENDS * INGEST_BATCH
    pick = torch.randperm(mbrs.shape[0], generator=g, device=dev)[:m]
    shift = (torch.rand(m, 2, generator=g, device=dev) - 0.5) * 2e-4
    held = mbrs[pick] + torch.cat([shift, shift], 1)
    _, part = membership(parts, held)
    slack = round_up(int(torch.bincount(part, minlength=parts.kmax).max()),
                     128)
    del part
    cfg = ServeConfig(placement="sharded", shards=SHARDS, slack=slack)
    kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = SpatialServer(parts, mbrs, cfg, device=dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    owner0 = srv.slayout.owner.copy()
    log, model = [], LiveSet(torch, mbrs, g)
    t0 = time.perf_counter()
    srv.tiles._ensure_mirror()
    mirror_s = time.perf_counter() - t0
    for i in range(SHARD_APPENDS):
        new = held[i * INGEST_BATCH:(i + 1) * INGEST_BATCH]
        if ingest_op(torch, log, "append", lambda: srv.append(new))[
                "restaged"]:
            raise AssertionError("a sharded append into the slack "
                                 "re-staged")
        model.append(new)
    for _ in range(SHARD_DELETES):
        ids = model.pick(INGEST_DELETE)
        ingest_op(torch, log, "delete", lambda: srv.delete(ids))
        model.alive[ids] = False
    stale = shard_extent_slack(torch, ops, srv)
    ingest_op(torch, log, "compact", srv.compact)
    after_compact = shard_extent_slack(torch, ops, srv)
    new = burst_boxes(torch, parts, srv.stats["cap"] + 1)
    if not ingest_op(torch, log, "burst", lambda: srv.append(new))[
            "restaged"]:
        raise AssertionError("the sharded burst did not re-stage")
    model.append(new)
    after_restage = shard_extent_slack(torch, ops, srv)
    if after_compact or after_restage:
        raise AssertionError("a shard row's extent is not tight after "
                             "compact or re-stage")
    qc, qi, pts = (batches[k][0] for k in ("counts", "ids", "knn"))
    got = ingest_queries(srv, qc, qi, pts)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    live_ids, live_boxes = model.live()
    if srv.stats["n"] != live_ids.numel():
        raise AssertionError("the sharded server's n is not the live count")
    stats = {k: srv.stats[k] for k in ("n", "cap", "moved_tiles")}
    owners_changed = int((srv.slayout.owner != owner0).sum())
    del srv        # its shards and dense oracle (about 24 GB) before the
    torch.cuda.empty_cache()       # fresh staging of the doubled tile
    check_counts(torch, geometry, live_boxes, qc[:CHECK_Q],
                 got["counts"][:CHECK_Q])
    if not torch.equal(got["dense"], got["counts"]):
        raise AssertionError("sharded dense counts differ from pruned after "
                             "ingest")
    fresh = SpatialServer(parts, live_boxes, ServeConfig(
        placement="sharded", shards=SHARDS), device=dev)
    want = ingest_queries(fresh, qc, qi, pts)
    remap = lambda a: torch.where(a >= 0, live_ids[a.clamp_min(0)].to(  # noqa
        a.dtype), a)
    hid, cnt, ovf = want["ids"]
    if not (torch.equal(got["counts"], want["counts"])
            and all(torch.equal(u, v) for u, v in zip(
                got["ids"], (remap(hid), cnt, ovf)))):
        raise AssertionError("sharded ingested answers differ from a fresh "
                             "sharded staging")
    nn, d2, kovf = want["knn"]
    if not knn_agree(torch, got["knn"], (remap(nn), d2, kovf)):
        raise AssertionError("sharded ingested kNN differs from a fresh "
                             "sharded staging")
    emit(dict(phase="sharded_ingest", shards=SHARDS, n0=N, slack=slack,
              stage_s=stage_s, mirror_s=mirror_s, ops=log, **stats,
              owners_changed=owners_changed,
              rows_extent_above_tight_after_deletes=stale,
              equal_to_fresh_sharded_staging=True,
              brute_force_counts=CHECK_Q, max_memory_allocated=peak,
              launches=launches))
    for name in ("gather_count_skip", "gather_hits_skip", "dense_counts"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the sharded "
                                 f"ingest path: {launches}")
    del fresh, got, want, model, live_boxes, live_ids, held
    torch.cuda.empty_cache()
    return launches


def sharded_phase(torch, dev, servers, mbrs, batches, pruned_x, knn_x,
                  keep=None):
    """Queue 1 item 10 on the card: the sharded "x" server over every
    batch (the dense oracle and the brute force on the first), "off"
    over a few, and the sharded ingest -> launches of each range-probe
    kernel on the sharded path.  The sharded servers are built with the
    replicated ``servers["x"]`` resident; ``servers`` is emptied before
    the ingest, whose re-stage at a doubled capacity needs the room."""
    parts = servers["x"].parts
    runs = [sharded_serve(torch, dev, parts, mbrs, "x", batches, pruned_x,
                          knn_x, (BATCHES, ID_BATCHES, KNN_BATCHES), True,
                          keep),
            sharded_serve(torch, dev, parts, mbrs, "off", batches, pruned_x,
                          knn_x, SHARD_OFF_BATCHES, False)]
    servers.clear()
    torch.cuda.empty_cache()
    runs.append(sharded_ingest(torch, dev, parts, mbrs, batches))
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    for name in list(CASES) + ["dense_counts", "dense_hits"]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the sharded "
                                 f"path: {launches}")
    for name in list(TABLES.values()) + ["count", "mask"]:
        if launches[name]:
            raise AssertionError(f"{name} was launched on the sharded path: "
                                 f"{launches}")
    return launches


def sharded_alone(torch, dev):
    """The sharded phase on its own (the kernels build at first use):
    the serve phase's objects, batches and replicated "x" answers, then
    ``sharded_phase``."""
    from repro_torch.data import spatial_gen
    from repro_torch.serve import ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batches = dict(counts=[qboxes(torch, g, Q, 0.03, dev)
                           for _ in range(BATCHES)],
                   ids=[qboxes(torch, g, Q_IDS, 0.003, dev)
                        for _ in range(ID_BATCHES)])
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    batches["knn"] = [torch.rand(Q_KNN, 2, generator=g, device=dev)
                      for _ in range(KNN_BATCHES)]
    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    srv = SpatialServer.from_method("bsp", mbrs, PAYLOAD, ServeConfig(),
                                    device=dev)
    pruned_x = dict(counts=[srv.range_counts(q)[0]
                            for q in batches["counts"]],
                    ids=[srv.range_ids(q, max_hits=MAX_HITS)[:3]
                         for q in batches["ids"]])
    knn_x = [srv.knn(p, K, max_cand=MAX_CAND)[:3] for p in batches["knn"]]
    servers = {"x": srv}
    del srv
    return sharded_phase(torch, dev, servers, mbrs, batches, pruned_x, knn_x)


def hot_centres(torch, g, n, ctr, dev):
    """``n`` centres in the 0.2-wide hot patch around ``ctr``."""
    return ctr + (torch.rand(n, 2, generator=g, device=dev) - 0.5) * 0.2


def hot_qboxes(torch, g, q, ctr, dev, frac=HOT_FRAC):
    """``benchmarks/bench_range_query.py``'s ``_hot_qboxes`` from a
    seeded torch generator: ``frac`` of the centres in the hot patch with
    half-extents 0.02 + U·0.14, the rest uniform with U·0.05."""
    n_hot = int(q * frac)
    c = torch.cat([hot_centres(torch, g, n_hot, ctr, dev),
                   torch.rand(q - n_hot, 2, generator=g, device=dev)])
    s = torch.rand(q, 2, generator=g, device=dev) * 0.05
    s[:n_hot] = torch.rand(n_hot, 2, generator=g, device=dev) * 0.14 + 0.02
    return torch.cat([c - s, c + s], dim=-1)


def replica_rows_equal(torch, srv):
    """Fail unless every replica row equals its primary (boxes, ids,
    alive, chunk boxes, extent) -> the replicated tile count."""
    s = srv.slayout
    reps = np.flatnonzero(s.rep_owner >= 0)
    dev = s.id_shards.device
    take = lambda o, l: (torch.from_numpy(o[reps].astype(np.int64)).to(dev),  # noqa: E731
                         torch.from_numpy(l[reps].astype(np.int64)).to(dev))
    ro, rl = take(s.rep_owner, s.rep_local)
    po, pl = take(s.owner, s.local)
    for name, a in (("boxes", s.canon_shards), ("ids", s.id_shards),
                    ("alive", s.alive_shards), ("chunk", s.chunk_shards),
                    ("extent", srv.tiles.extent)):
        if a is not None and not torch.equal(a[ro, rl], a[po, pl]):
            raise AssertionError(f"a replica row's {name} differs from its "
                                 f"primary's")
    return int(reps.size)


def one_resident_copy(torch, srv, qb):
    """Fail unless every candidate of a routed batch resolves to exactly
    one (owner, row) holding the tile, primary or replica
    (``tests/test_heat_placement.py``'s check) -> the split's stats."""
    s = srv.slayout
    cand, costs, _ = srv._route_batch(qb)
    slots, ss, sc, xstats = srv.tiles._exchange_plan(cand, costs)
    d, t_rows = s.id_shards.shape[:2]
    inv = np.full((d, t_rows), -1, np.int64)
    inv[s.owner, s.local] = np.arange(s.owner.shape[0])
    reps = np.flatnonzero(s.rep_owner >= 0)
    inv[s.rep_owner[reps], s.rep_local[reps]] = reps
    ss, sc, cand = ss.cpu().numpy(), sc.cpu().numpy(), cand.cpu().numpy()
    h, o, m = np.nonzero(ss >= 0)
    q = slots[h, ss[h, o, m]]
    f = sc.shape[-1]
    lt = sc[h, o, m]                                    # (msgs, F_local)
    keep = lt >= 0
    got_q = np.repeat(q, f)[keep.ravel()]
    got_t = inv[np.repeat(o, f)[keep.ravel()], lt[keep]]
    if (got_t < 0).any():
        raise AssertionError("a routed candidate names a row holding no "
                             "tile")
    wq, wt = np.nonzero(cand >= 0)
    want = np.sort(wq.astype(np.int64) << 32 | cand[wq, wt])
    got = np.sort(got_q.astype(np.int64) << 32 | got_t)
    if not np.array_equal(want, got):
        raise AssertionError("routed candidates do not resolve to exactly "
                             "one resident copy each")
    return xstats


def heat_batches(torch, srv, batches, want, checked, log, rows=None):
    """Counts batches through ``srv``: each answer equal to the
    replicated server's, the first ``HEAT_CHECK`` rows of each held to
    the brute force when ``checked`` is given, the shard rows ``rows``
    after each (an automatic rebalance runs inside a batch) -> per-batch
    rows."""
    from repro_torch.core import geometry
    out = []
    for i, (qb, w) in enumerate(zip(batches, want)):
        before = srv._batches_since_rebalance
        t0 = time.perf_counter()
        cnt, st = srv.range_counts(qb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(cnt, w):
            raise AssertionError(f"{log} counts batch {i} differs from the "
                                 f"replicated server")
        if checked is not None:
            check_counts(torch, geometry, checked, qb[:HEAT_CHECK],
                         cnt[:HEAT_CHECK])
        if rows is not None and srv.slayout.canon_shards.shape[:2] != rows:
            raise AssertionError(f"{log} batch {i}: shard rows "
                                 f"{srv.slayout.canon_shards.shape[:2]}, "
                                 f"want {rows}")
        out.append(dict(ms=ms, split_ms=srv.tiles.split_ms,
                         rebalanced=srv._batches_since_rebalance <= before,
                         **{k: st[k] for k in (
                             "messages", "routed_alt", "f_local",
                             "m_per_pair", "probe_load_imbalance",
                             "exchange_bytes")}))
    return out


def timed_rebalance(torch, srv, rows_want):
    """``srv.rebalance()`` timed, its shard rows checked -> report."""
    if srv.slayout.canon_shards.shape[:2] != rows_want:
        raise AssertionError(f"shard rows {srv.slayout.canon_shards.shape[:2]}"
                             f" before a rebalance, want {rows_want}")
    t0 = time.perf_counter()
    rep = srv.rebalance()
    torch.cuda.synchronize()
    rep = dict(rep, seconds=time.perf_counter() - t0, **srv.rebalance_s)
    if srv.slayout.canon_shards.shape[:2] != rows_want:
        raise AssertionError(f"shard rows {srv.slayout.canon_shards.shape[:2]}"
                             f" after a rebalance, want {rows_want}")
    return rep


def leg_row(rows):
    ms = [r["ms"] for r in rows]
    sp = [r["split_ms"] for r in rows]
    return dict(batches=len(rows), p50_ms=pct(ms, 0.5), p99_ms=pct(ms, 0.99),
                split_p50_ms=pct(sp, 0.5),
                messages=[r["messages"] for r in rows],
                messages_mean=sum(r["messages"] for r in rows) / len(rows),
                routed_alt=[r["routed_alt"] for r in rows],
                f_local=[r["f_local"] for r in rows],
                m_per_pair=[r["m_per_pair"] for r in rows],
                probe_load_imbalance=[r["probe_load_imbalance"]
                                      for r in rows],
                exchange_bytes=[r["exchange_bytes"] for r in rows])


def heat_phase(torch, dev, mbrs, parts):
    """Queue 1 item 11 on the card: the hotspot bench's three legs at
    full size, the automatic rebalance, and an ingest stream through the
    replicas -> ``(replicated "x" server, rebalanced heat server,
    launches)``, the servers for the frontend phase."""
    from repro_torch.core import geometry
    from repro_torch.core.partition.assign import membership, round_up
    from repro_torch.kernels.range_probe import kernel, ops
    from repro_torch.query import knn as knn_mod
    from repro_torch.serve import PlacementPolicy, ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    ctr = torch.rand(2, generator=g, device=dev) * 0.6 + 0.2
    hot = [hot_qboxes(torch, g, Q, ctr, dev) for _ in range(HEAT_HOT)]
    c = hot_centres(torch, g, Q_IDS, ctr, dev)
    s = torch.rand(Q_IDS, 2, generator=g, device=dev) * 0.003
    ids_q = [torch.cat([c - s, c + s], -1)]
    for _ in range(HEAT_IDS - 1):
        c = hot_centres(torch, g, Q_IDS, ctr, dev)
        s = torch.rand(Q_IDS, 2, generator=g, device=dev) * 0.003
        ids_q.append(torch.cat([c - s, c + s], -1))
    knn_p = [hot_centres(torch, g, Q_KNN, ctr, dev)
             for _ in range(HEAT_KNN)]

    # the replicated "x" server's answers are what every placement gives
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rsrv = SpatialServer(parts, mbrs, ServeConfig(), device=dev)
    want_c = [rsrv.range_counts(q)[0] for q in hot]
    want_i = [rsrv.range_ids(q, max_hits=MAX_HITS)[:3] for q in ids_q]
    want_k = [rsrv.knn(p, K, max_cand=MAX_CAND)[:3] for p in knn_p]
    torch.cuda.synchronize()
    kernel.reset_launches()
    t_all = time.perf_counter()

    # (a) count-balanced, (b) the same server co-located on its heat
    t0 = time.perf_counter()
    ssrv = SpatialServer(parts, mbrs, ServeConfig(placement="sharded",
                                                  shards=SHARDS), device=dev)
    torch.cuda.synchronize()
    sharded_build_s = time.perf_counter() - t0
    t_local = ssrv.stats["t_local"]
    leg_a = heat_batches(torch, ssrv, hot[:HEAT_LEG], want_c, mbrs, "(a)")
    rb_b = timed_rebalance(torch, ssrv, (SHARDS, t_local))
    leg_b = heat_batches(torch, ssrv, hot[:HEAT_LEG], want_c, None, "(b)")
    del ssrv
    torch.cuda.empty_cache()

    # (c) the heat placement: cold, rebalanced, then hot traffic
    pol = PlacementPolicy(heat_decay=HEAT_DECAY, replicate_top=HEAT_TOP)
    rows = (SHARDS, t_local + HEAT_TOP)
    t0 = time.perf_counter()
    hsrv = SpatialServer(parts, mbrs, ServeConfig(
        placement="heat", shards=SHARDS, policy=pol), device=dev)
    torch.cuda.synchronize()
    heat_build_s = time.perf_counter() - t0
    cold_reps = replica_rows_equal(torch, hsrv)
    leg_c_cold = heat_batches(torch, hsrv, hot[:HEAT_LEG], want_c, None,
                              "(c) cold", rows)
    rb_c = timed_rebalance(torch, hsrv, rows)
    n_reps = replica_rows_equal(torch, hsrv)
    leg_c = heat_batches(torch, hsrv, hot, want_c, mbrs, "(c)", rows)
    i_ms, k_ms, only_r = [], [], 0
    for i, q in enumerate(ids_q):
        t0 = time.perf_counter()
        out = hsrv.range_ids(q, max_hits=MAX_HITS)
        torch.cuda.synchronize()
        i_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.equal(u, v) for u, v in zip(out[:3], want_i[i])):
            raise AssertionError(f"heat ids batch {i} differs from the "
                                 f"replicated server")
    check_ids(torch, geometry, mbrs, ids_q[0], *want_i[0], MAX_HITS)
    for i, p in enumerate(knn_p):
        t0 = time.perf_counter()
        out = hsrv.knn(p, K, max_cand=MAX_CAND)
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
        ok, extra = knn_within(torch, out[:3], want_k[i])
        if not ok:
            raise AssertionError(f"heat kNN batch {i} differs from the "
                                 f"replicated server")
        only_r += extra
    ok = ~want_k[0][2][:CHECK_KNN]
    b_ids, b_d2 = knn_brute(torch, knn_mod, mbrs, knn_p[0][:CHECK_KNN], K)
    if not (torch.equal(want_k[0][0][:CHECK_KNN][ok], b_ids[ok])
            and torch.equal(want_k[0][1][:CHECK_KNN][ok], b_d2[ok])):
        raise AssertionError("hot kNN disagrees with the brute force")
    xstats = one_resident_copy(torch, hsrv, hot[0])
    launches = dict(kernel.LAUNCHES)
    dev_c, top_c = device_busy(torch, lambda: hsrv.range_counts(hot[1]), 3)
    kernel.LAUNCHES.update(launches)         # the profiled repeats'
    c_p50 = leg_row(leg_c)["p50_ms"]
    msgs = {k: leg_row(r)["messages_mean"] for k, r in
            (("a", leg_a), ("b", leg_b), ("c", leg_c[:HEAT_LEG]))}
    emit(dict(
        phase="heat", n=N, shards=SHARDS, t=hsrv.stats["t"], t_local=t_local,
        replicate_top=HEAT_TOP, heat_decay=HEAT_DECAY, q=Q,
        sharded_build_s=sharded_build_s, heat_build_s=heat_build_s,
        shard_rows=list(rows), shard_bytes=hsrv.stats["shard_bytes"],
        resident_tile_bytes=hsrv.resident_tile_bytes(),
        replicated_tiles_cold=cold_reps, replicated_tiles=n_reps,
        leg_a=leg_row(leg_a), leg_b=leg_row(leg_b),
        leg_c_cold=leg_row(leg_c_cold), leg_c=leg_row(leg_c),
        messages_mean=msgs,
        messages_ratio_b_over_a=msgs["b"] / msgs["a"],
        messages_ratio_c_over_a=msgs["c"] / msgs["a"],
        rebalance_b=rb_b, rebalance_c=rb_c,
        counts_device_ms=dev_c, counts_idle_share=1.0 - dev_c / c_p50,
        top_device=top_c,
        ids=dict(batches=len(i_ms), p50_ms=pct(i_ms, 0.5),
                 p99_ms=pct(i_ms, 0.99)),
        knn=dict(batches=len(k_ms), p50_ms=pct(k_ms, 0.5),
                 p99_ms=pct(k_ms, 0.99), flagged_by_replicated_only=only_r),
        one_resident_copy=True, routed_alt=xstats["routed_alt"],
        equal_to_replicated_x=True, brute_force_counts_per_batch=HEAT_CHECK,
        brute_force_ids=Q_IDS, brute_force_knn=int(ok.sum()),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=launches))

    # rebalance_every, then an ingest stream through the replicas
    m = HEAT_APPENDS * INGEST_BATCH + HEAT_UPDATE
    pick = torch.randperm(mbrs.shape[0], generator=g, device=dev)[:m]
    shift = (torch.rand(m, 2, generator=g, device=dev) - 0.5) * 2e-4
    held = mbrs[pick] + torch.cat([shift, shift], 1)
    _, part = membership(parts, held)
    slack = round_up(int(torch.bincount(part, minlength=parts.kmax).max()),
                     128)
    del part
    epol = PlacementPolicy(heat_decay=HEAT_DECAY, replicate_top=HEAT_TOP,
                           rebalance_every=HEAT_EVERY)
    t0 = time.perf_counter()
    esrv = SpatialServer(parts, mbrs, ServeConfig(
        placement="heat", shards=SHARDS, slack=slack, policy=epol),
        device=dev)
    torch.cuda.synchronize()
    every_build_s = time.perf_counter() - t0
    batches = [hot[i % HEAT_HOT] for i in range(HEAT_EVERY_BATCHES)]
    every = heat_batches(torch, esrv, batches,
                         [want_c[i % HEAT_HOT]
                          for i in range(HEAT_EVERY_BATCHES)], None, "every",
                         rows)
    n_auto = sum(r["rebalanced"] for r in every)
    if n_auto != HEAT_EVERY_BATCHES // HEAT_EVERY:
        raise AssertionError(f"rebalance_every={HEAT_EVERY} rebalanced "
                             f"{n_auto} times in {HEAT_EVERY_BATCHES} "
                             f"batches")
    replica_rows_equal(torch, esrv)
    auto_s = esrv.rebalance_s
    log, model = [], LiveSet(torch, mbrs, g)
    t0 = time.perf_counter()
    esrv.tiles._ensure_mirror()
    mirror_s = time.perf_counter() - t0

    def step(kind, fn):
        rep = ingest_op(torch, log, kind, fn)
        if rep["restaged"]:
            raise AssertionError(f"the heat ingest's {kind} re-staged")
        log[-1]["replicated_tiles"] = replica_rows_equal(torch, esrv)
        log[-1]["rows_extent_above_tight"] = shard_extent_slack(torch, ops,
                                                                esrv)
        if esrv.slayout.canon_shards.shape[:2] != rows:
            raise AssertionError("shard rows changed through the ingest")
        return rep

    for i in range(HEAT_APPENDS):
        new = held[i * INGEST_BATCH:(i + 1) * INGEST_BATCH]
        step("append", lambda: esrv.append(new))
        model.append(new)
    ids = model.pick(HEAT_DELETE)
    step("delete", lambda: esrv.delete(ids))
    model.alive[ids] = False
    ids = model.pick(HEAT_UPDATE)
    new = held[HEAT_APPENDS * INGEST_BATCH:]
    step("update", lambda: esrv.update(ids, new))
    model.boxes[ids] = new
    step("compact", esrv.compact)
    if log[-1]["rows_extent_above_tight"]:
        raise AssertionError("a shard row's extent is not tight after the "
                             "heat ingest's compact")
    qc, qi, pts = hot[0], ids_q[0], knn_p[0]
    got = ingest_queries(esrv, qc, qi, pts)
    dense_i = esrv.range_ids(qi, max_hits=MAX_HITS, pruned=False)[:3]
    dense_k = esrv.knn(pts, K, max_cand=MAX_CAND, pruned=False)[:3]
    torch.cuda.synchronize()
    launches_e = dict(kernel.LAUNCHES)
    live_ids, live_boxes = model.live()
    if esrv.stats["n"] != live_ids.numel():
        raise AssertionError("the heat server's n is not the live count")
    check_counts(torch, geometry, live_boxes, qc[:HEAT_CHECK],
                 got["counts"][:HEAT_CHECK])
    if not (torch.equal(got["dense"], got["counts"])
            and all(torch.equal(u, v) for u, v in zip(got["ids"], dense_i))):
        raise AssertionError("the heat server's ingested answers differ "
                             "from its dense oracle")
    ok, _ = knn_within(torch, got["knn"], dense_k)
    (ai, ad, ao) = got["knn"]
    sub = ~ao[:CHECK_KNN]
    b_ids, b_d2 = knn_brute(torch, knn_mod, live_boxes, pts[:CHECK_KNN], K)
    b_ids = live_ids[b_ids.long()].to(torch.int32)
    if not (ok and torch.equal(ai[:CHECK_KNN][sub], b_ids[sub])
            and torch.equal(ad[:CHECK_KNN][sub], b_d2[sub])):
        raise AssertionError("the heat server's ingested kNN differs from "
                             "its dense oracle or the brute force")
    if not bool((esrv.tiles.extent >= ops.live_extent(
            esrv.slayout.alive_shards.flatten(0, 1)).view(
                esrv.tiles.extent.shape)).all()):
        raise AssertionError("extent < live_extent(alive) after the ingest")
    emit(dict(phase="heat_ingest", rebalance_every=HEAT_EVERY,
              batches=len(every), auto_rebalances=n_auto,
              every_p50_ms=pct([r["ms"] for r in every], 0.5),
              every_batch_ms=[r["ms"] for r in every],
              last_auto_rebalance_s=auto_s, build_s=every_build_s,
              slack=slack, mirror_s=mirror_s, ops=log,
              equal_to_dense_oracle=True, brute_force_counts=HEAT_CHECK,
              brute_force_knn=int(sub.sum()),
              max_memory_allocated=torch.cuda.max_memory_allocated(),
              launches=launches_e, phase_s=time.perf_counter() - t_all))
    for name in ("gather_count_skip", "gather_hits_skip", "dense_counts",
                 "dense_hits"):
        if launches_e[name] <= 0:
            raise AssertionError(f"{name} was not launched on the heat "
                                 f"path: {launches_e}")
    for name in list(TABLES.values()) + ["count", "mask"]:
        if launches_e[name]:
            raise AssertionError(f"{name} was launched on the heat path: "
                                 f"{launches_e}")
    del esrv, got, dense_i, dense_k, model, live_ids, live_boxes, held
    torch.cuda.empty_cache()
    return rsrv, hsrv, launches_e


def mix_request(rng, i):
    """The frontend's traffic mix, drawn from the arrival generator:
    70% ``range_counts`` (half-extents to 0.03), 20% ``range_ids`` (to
    0.003), 10% ``knn``; tenants take 70%, 20% and 10% of the
    arrivals."""
    u, v = rng.random(), rng.random()
    tenant = "t0" if v < 0.7 else "t1" if v < 0.9 else "t2"
    if u < 0.1:
        return "knn", rng.random(2).astype(np.float32), (K, MAX_CAND), tenant
    c = rng.random(2)
    if u < 0.3:
        s = rng.random(2) * 0.003
        kind, params = "range_ids", (MAX_HITS,)
    else:
        s = rng.random(2) * 0.03
        kind, params = "range_counts", ()
    return kind, np.concatenate([c - s, c + s]).astype(np.float32), params, \
        tenant


def direct_rows(torch, srv, kind, payloads, params):
    """One direct unpadded batched call -> host rows, as
    ``execute_batch`` returns them."""
    q = torch.from_numpy(np.stack(payloads)).to(srv.device)
    if kind == "range_counts":
        return srv.range_counts(q)[0].cpu().tolist()
    if kind == "range_ids":
        hid, cnt, ovf, _ = srv.range_ids(q, max_hits=params[0])
        hid, cnt, ovf = hid.cpu().numpy(), cnt.cpu().numpy(), ovf.cpu().numpy()
        return [(hid[i], int(cnt[i]), bool(ovf[i])) for i in range(len(q))]
    nn, d2, ovf, _ = srv.knn(q, params[0], max_cand=params[1])
    nn, d2, ovf = nn.cpu().numpy(), d2.cpu().numpy(), ovf.cpu().numpy()
    return [(nn[i], d2[i], bool(ovf[i])) for i in range(len(q))]


def same_rows(got, want) -> bool:
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            if not all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(g, w)):
                return False
        elif g != w:
            return False
    return len(got) == len(want)


class CheckedExecute:
    """``simulate_open_loop``'s executor: ``execute_batch`` timed on the
    host clock (the copies to the host wait for the card), then the
    batch's queries as one direct unpadded call, which must give the same
    rows bit for bit; the check's launches are not counted.  Keeps the
    slots and the fill by kind."""

    def __init__(self, torch, kernel, frontend):
        self.torch, self.kernel, self.fe = torch, kernel, frontend
        self.slots, self.fill, self.service = {}, {}, {}
        self.check_s = 0.0

    def __call__(self, srv, batch):
        t0 = time.perf_counter()
        results = self.fe.execute_batch(srv, batch)
        service_s = time.perf_counter() - t0
        counted = dict(self.kernel.LAUNCHES)
        want = direct_rows(self.torch, srv, batch.kind,
                           [r.payload for r in batch.requests], batch.params)
        self.kernel.LAUNCHES.update(counted)
        self.check_s += time.perf_counter() - t0 - service_s
        if not same_rows(results, want):
            raise AssertionError(f"a padded {batch.kind} batch of "
                                 f"{len(batch.requests)} (width "
                                 f"{batch.width}) differs from the direct "
                                 f"call")
        k = batch.kind
        self.slots[k] = self.slots.get(k, 0) + batch.width
        self.fill[k] = self.fill.get(k, 0) + len(batch.requests)
        self.service.setdefault(k, []).append(service_s * 1e3)
        return results, service_s


def service_capacity(torch, srv, frontend, rounds=10):
    """Each kind's direct service ms at the top rung (``execute_batch``
    on 512 requests; the kinds in turns over ``rounds`` rounds after a
    warm-up, the median of each, so a slow spell of the shared host
    weighs on every kind alike) -> (ms by kind, the mix's capacity R in
    requests a second)."""
    rng = np.random.default_rng(SEED + 7)
    top = frontend.FrontendConfig().max_batch
    kinds = {}
    while len(kinds) < 3 or min(len(v) for v in kinds.values()) < top:
        kind, payload, params, _ = mix_request(rng, 0)
        kinds.setdefault((kind, params), []).append(payload)
    batches = {kind: frontend.Batch(kind, params, [frontend.Request(
        kind, p, params) for p in pl[:top]], top, 0.0)
        for (kind, params), pl in kinds.items()}
    times = {kind: [] for kind in batches}
    for r in range(rounds + 1):
        for kind, batch in batches.items():
            t0 = time.perf_counter()
            frontend.execute_batch(srv, batch)
            if r:
                times[kind].append((time.perf_counter() - t0) * 1e3)
    ms = {kind: median(t) for kind, t in times.items()}
    per_req_ms = sum(FE_MIX[kind] * ms[kind] for kind in ms) / top
    return ms, 1e3 / per_req_ms


def open_loop_run(torch, kernel, frontend, srv, name, rate, arrivals, cfg):
    """One ``simulate_open_loop`` run of ``poisson_workload`` (seed 0) at
    ``rate`` -> its row."""
    t0 = time.perf_counter()
    wl = frontend.poisson_workload(rate, arrivals / rate, mix_request, seed=0)
    gen_s = time.perf_counter() - t0
    ex = CheckedExecute(torch, kernel, frontend)
    before = dict(kernel.LAUNCHES)
    t0 = time.perf_counter()
    resp, metrics = frontend.simulate_open_loop(srv, wl, cfg, execute=ex)
    wall_s = time.perf_counter() - t0
    launches = {k: kernel.LAUNCHES[k] - before[k] for k in CASES}
    snap = metrics.snapshot()
    done = [a.t + r.total_s for a, r in zip(wl, resp) if r.ok]
    span = max(done) - wl[0].t if done else 0.0
    if snap["completed"] + snap["rejected"] + snap["timed_out"] != len(wl):
        raise AssertionError(f"frontend run {name} lost requests")
    return dict(
        phase="frontend", run=name, offered_rate=rate, arrivals=len(wl),
        workload_gen_s=gen_s, wall_s=wall_s, config=dict(
            ladder=list(cfg.ladder), max_delay=cfg.max_delay,
            queue_limit=cfg.queue_limit, quantum=cfg.quantum,
            default_deadline=cfg.default_deadline),
        completed=snap["completed"], rejected=snap["rejected"],
        timed_out=snap["timed_out"], batches=snap["batches"],
        queue_depth_max=snap["queue_depth_max"],
        batches_by_kind={k: len(v) for k, v in ex.service.items()},
        virtual_s=max(done, default=0.0),
        sustained_rps=snap["completed"] / span if span else 0.0,
        queue_ms=dict(p50=snap["queue_s"]["p50"] * 1e3,
                      p99=snap["queue_s"]["p99"] * 1e3),
        total_ms=dict(p50=snap["total_s"]["p50"] * 1e3,
                      p99=snap["total_s"]["p99"] * 1e3),
        execute_ms=dict(p50=snap["execute_s"]["p50"] * 1e3,
                        p99=snap["execute_s"]["p99"] * 1e3),
        fill_ratio=snap["batch_fill_ratio"], padded_slots=snap["padded_slots"],
        fill_by_kind={k: ex.fill[k] / ex.slots[k] for k in ex.slots},
        padded_slots_by_kind={k: ex.slots[k] - ex.fill[k] for k in ex.slots},
        service_p50_ms_by_kind={k: pct(v, 0.5) for k, v in ex.service.items()},
        # the plane's own host time: the run's wall but the executions
        # and their checks
        host_us_per_request=(wall_s - ex.check_s - sum(
            sum(v) for v in ex.service.values()) / 1e3) * 1e6 / len(wl),
        tenants=snap["tenants"], equal_to_direct_calls=True,
        launches=launches)


def frontend_phase(torch, dev, rsrv, hsrv):
    """Queue 1 item 12 on the card: the request plane in front of the
    replicated "x" server (the open loop at 0.5 R and 1.5 R, the asyncio
    frontend) and of the rebalanced heat server -> launches."""
    import asyncio
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.serve import frontend

    kernel.reset_launches()
    cfg = frontend.FrontendConfig()
    ms, cap = service_capacity(torch, rsrv, frontend)
    emit(dict(phase="frontend_capacity", server="replicated",
              service_ms_at_512=ms, capacity_rps=cap))
    emit(open_loop_run(torch, kernel, frontend, rsrv, "replicated_0.5R",
                       0.5 * cap, FE_ARRIVALS, cfg))
    emit(open_loop_run(torch, kernel, frontend, rsrv, "replicated_1.5R",
                       1.5 * cap, FE_ARRIVALS,
                       cfg.replace(default_deadline=FE_DEADLINE)))
    hms, hcap = service_capacity(torch, hsrv, frontend)
    emit(dict(phase="frontend_capacity", server="heat",
              service_ms_at_512=hms, capacity_rps=hcap))
    row = open_loop_run(torch, kernel, frontend, hsrv, "heat_0.5R",
                        0.5 * hcap, FE_HEAT_ARRIVALS, cfg)
    emit(dict(row, placement_stats=frontend.ServeFrontend(
        hsrv).placement_stats()))

    rng = np.random.default_rng(SEED + 8)
    subs = [mix_request(rng, i) for i in range(FE_ASYNC)]

    async def serve_all():
        fe = frontend.ServeFrontend(rsrv, cfg)
        fe.start()
        calls = []
        for kind, payload, params, tenant in subs:
            if kind == "knn":
                calls.append(fe.knn(payload, *params, tenant=tenant))
            elif kind == "range_ids":
                calls.append(fe.range_ids(payload, *params, tenant=tenant))
            else:
                calls.append(fe.range_counts(payload, tenant=tenant))
        tasks = [asyncio.ensure_future(c) for c in calls]
        await asyncio.sleep(0)
        await fe.close()                     # drains every submission
        return await asyncio.gather(*tasks), fe

    before = dict(kernel.LAUNCHES)
    t0 = time.perf_counter()
    out, fe = asyncio.run(serve_all())
    async_s = time.perf_counter() - t0
    a_launches = {k: kernel.LAUNCHES[k] - before[k] for k in CASES}
    launches = dict(kernel.LAUNCHES)
    if not all(r.ok for r in out):
        raise AssertionError("the asyncio frontend did not serve every "
                             "submission")
    for kind in ("range_counts", "range_ids", "knn"):
        idx = [i for i, s in enumerate(subs) if s[0] == kind]
        want = direct_rows(torch, rsrv, kind, [subs[i][1] for i in idx],
                           subs[idx[0]][2])
        if not same_rows([out[i].value for i in idx], want):
            raise AssertionError(f"asyncio {kind} responses differ from a "
                                 f"direct call")
    snap = fe.metrics.snapshot()
    emit(dict(phase="frontend", run="asyncio", submissions=FE_ASYNC,
              wall_s=async_s, completed=snap["completed"],
              batches=snap["batches"], fill_ratio=snap["batch_fill_ratio"],
              total_ms=dict(p50=snap["total_s"]["p50"] * 1e3,
                            p99=snap["total_s"]["p99"] * 1e3),
              drained_on_close=True, equal_to_direct_calls=True,
              launches=a_launches))
    for name in CASES:
        if name in ("gather_count", "gather_hits"):
            continue
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the frontend "
                                 f"path: {launches}")
    return launches


def heat_alone(torch, dev):
    """The heat and frontend phases on their own (the kernels build at
    first use): the serve phase's objects and partitioning, then
    ``heat_phase`` and ``frontend_phase`` -> their launches."""
    from repro_torch.core.partition import api
    from repro_torch.data import spatial_gen

    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    parts = api.partition("bsp", mbrs, PAYLOAD)
    rsrv, hsrv, launches = heat_phase(torch, dev, mbrs, parts)
    return launches, frontend_phase(torch, dev, rsrv, hsrv)


def sharded_join_phase(torch, dev, inputs, results, keep=None):
    """Multi-device join plans and parallel partitioning on the card ->
    the launches of the encode and the join's batched passes.  ``keep``,
    when given, receives the counts and the parallel partition the mesh
    phase holds its ranks to."""
    from repro_torch.core import metrics
    from repro_torch.core.partition import partition_counts
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.query import engine, parallel_partition

    hkernel.reset_launches()
    mkernel.reset_launches()
    r, s = inputs["pi"]
    if keep is not None:
        keep["join_inputs"] = (r.cpu(), s.cpu())
    for method in ("bsp", "hc"):
        one = results["pi", method]
        plan, plan_s = timed_s(torch, lambda: engine.plan_join(
            method, r, s, PAYLOAD, SHARDS, device=dev))
        before = dict(mkernel.LAUNCHES)
        count, join_s = timed_s(torch, lambda: engine.spatial_join_count(
            plan, max_pairs_per_tile=one["max_n"]))
        per = {k: mkernel.LAUNCHES[k] - before[k] for k in before}
        want = "pair_list" if plan.stats["overlapping"] else "rp_counts"
        if per[want] != 1:
            raise AssertionError(f"the {SHARDS}-device {method} plan "
                                 f"launched {per}, want one {want}")
        if count != one["exact"]:
            raise AssertionError(f"the {SHARDS}-device {method} plan counts "
                                 f"{count}, the one-device plan "
                                 f"{one['exact']}")
        before = dict(mkernel.LAUNCHES)
        raw, raw_s = timed_s(torch, lambda: engine.run_join_count(
            plan, dedup="none"))
        if raw != one["raw"] or mkernel.LAUNCHES["raw_counts"] - before[
                "raw_counts"] != 1:
            raise AssertionError(f"the {SHARDS}-device {method} raw count "
                                 f"{raw} (one-device {one['raw']}) or its "
                                 f"launches")
        if keep is not None:
            keep[f"join_{method}"] = dict(exact=count, raw=raw,
                                          max_n=one["max_n"])
        emit(dict(phase="multidevice_join", input="pi", method=method,
                  n_devices=SHARDS, tpd=plan.stats["tpd"],
                  skew=plan.stats["skew"], plan_s=plan_s, join_s=join_s,
                  raw_count_s=raw_s, exact=count,
                  one_device_exact=one["exact"], raw=raw,
                  equals_unpartitioned=True, launches=per))
        del plan
    merged = torch.cat([r, s])
    n = merged.shape[0]
    before = hkernel.LAUNCHES["encode"]
    (parts, stats), secs = timed_s(torch, lambda: (
        parallel_partition.parallel_partition(merged, PAYLOAD, SHARDS)))
    if keep is not None:
        keep["pp"] = dict(boxes=parts.boxes.cpu(), valid=parts.valid.cpu(),
                          stats=stats)
    counts, copies = partition_counts(merged, parts)
    cov = float(metrics.coverage(copies))
    if stats["dropped"] or cov != 1.0:
        raise AssertionError(f"parallel partitioning dropped "
                             f"{stats['dropped']} objects, coverage {cov}")
    emit(dict(phase="parallel_partition", n=n, payload=PAYLOAD,
              buckets=SHARDS, seconds=secs, k=parts.k(), kmax=parts.kmax,
              lambda_=float(metrics.boundary_ratio(counts, parts.valid, n)),
              balance_stddev=float(metrics.balance_stddev(counts,
                                                          parts.valid)),
              skew=float(metrics.skew_ratio(counts, parts.valid)),
              coverage=cov, dropped=stats["dropped"],
              encode_launches=hkernel.LAUNCHES["encode"] - before))
    return dict(mkernel.LAUNCHES, **hkernel.LAUNCHES)


def mesh_keep(torch, srv, mbrs, parts, batches, counts, ids, knn,
              build_peak, keep):
    """What the mesh phase holds its ranks to, from the in-process
    sharded "x" server (bsp, ``SHARDS`` owners): its objects (the ranks
    load them, not a regeneration) and partition, the first
    ``MESH_BATCHES`` batches of each kind and their answers; the mesh
    ingest (an append into the centres of the least-filled tiles, so
    no tile overflows, and a delete) applied to it and a batch of each
    kind answered after; its staging's peak memory and shard bytes."""
    n = MESH_BATCHES
    host = lambda x: tuple(v.cpu() for v in x)   # noqa: E731
    keep.update(
        mbrs=mbrs.cpu(), parts_bsp=(parts.boxes.cpu(), parts.valid.cpu()),
        batches={k: [b.cpu() for b in batches[k][:n]]
                 for k in ("counts", "ids", "knn")},
        bsp=dict(counts=[c.cpu() for c in counts[:n]],
                 ids=[host(x) for x in ids[:n]],
                 knn=[host(x) for x in knn[:n]]),
        build_peak=build_peak, shard_bytes=srv.stats["shard_bytes"],
        cap=srv.stats["cap"])
    cap = srv.slayout.id_shards.shape[-1]
    fill = (srv.slayout.id_shards.view(-1, cap)[srv.tiles._rows] >= 0).sum(1)
    fill = torch.where(parts.valid, fill, cap)
    tiles = torch.argsort(fill, stable=True)[:MESH_TILES]
    if int(fill[tiles].max()) + MESH_PER_TILE > srv.stats["cap"]:
        raise AssertionError("the mesh append would overflow a tile")
    ctr = (parts.boxes[tiles, :2] + parts.boxes[tiles, 2:]) * 0.5
    g = torch.Generator(device=ctr.device).manual_seed(SEED + 9)
    off = (torch.rand(MESH_TILES, MESH_PER_TILE, 2, generator=g,
                      device=ctr.device) - 0.5) * 1e-6
    lo = (ctr[:, None] + off).reshape(-1, 2)
    append = torch.cat([lo, lo + 1e-7], 1)
    delete = torch.randperm(srv.stats["n"], generator=g,
                            device=ctr.device)[:MESH_DELETE]
    rep_a = srv.append(append)
    rep_d = srv.delete(delete)
    if rep_a["restaged"] or rep_d["restaged"]:
        raise AssertionError("the mesh ingest re-staged in-process")
    qc, qi, pts = (batches[k][0] for k in ("counts", "ids", "knn"))
    keep.update(append=append.cpu(), delete=delete.cpu(),
                ingest=dict(counts=srv.range_counts(qc)[0].cpu(),
                            ids=host(srv.range_ids(qi, max_hits=MAX_HITS)[
                                :3]),
                            knn=host(srv.knn(pts, K, max_cand=MAX_CAND)[:3]),
                            append=rep_a, delete=rep_d))


def mesh_rank(rank, size, path):
    """One rank of the mesh phase (spawned; the kernels are built):
    serve bsp (osm) and hc (pi) sharded over the gloo mesh on the card,
    ingest on bsp, the join at D = ``size`` and the parallel partition,
    each held to ``path/inputs.pt`` -> ``path/rank{rank}.json``."""
    import json

    import torch
    from repro_torch.core.partition import api
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.query import engine, parallel_partition
    from repro_torch.serve import ServeConfig, SpatialServer

    mods = (kernel, hkernel, mkernel)
    inp = torch.load(f"{path}/inputs.pt", weights_only=False)
    c = inp["consts"]                  # the parent's sizes and device
    mesh = mesh_lib.init_process_mesh("gloo", f"file://{path}/store", rank,
                                      size, c["device"],
                                      timeout=MESH_DEADLINE_S)
    dev = mesh.device
    on_card = dev.type == "cuda"
    out = dict(rank=rank, device=str(dev), paths={})

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def note(step):
        """The rank's device memory after ``step`` (also to stderr at
        once, so a rank that fails later has left its trail)."""
        sync()
        mem = ((torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev)) if on_card else (0, 0))
        out.setdefault("memory", []).append((step,) + mem)
        print(f"mesh rank {rank}: {step}: allocated {mem[0]}, reserved "
              f"{mem[1]}", file=sys.stderr, flush=True)

    def start():
        sync()
        for m in mods:
            m.reset_launches()
        mesh.reset_timers()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

    def finish(row):
        sync()
        row.update(launches={m.__name__.split(".")[-2]: {
            k: v for k, v in m.LAUNCHES.items() if v} for m in mods},
                   peak_memory=(torch.cuda.max_memory_allocated(dev)
                                if on_card else None),
                   comm_s=mesh.timers["comm_s"], copy_s=mesh.timers["copy_s"],
                   comm_calls=mesh.timers["calls"],
                   comm_bytes=mesh.timers["bytes"])
        return row

    def timed(fn):
        c0, k0 = mesh.timers["comm_s"], mesh.timers["copy_s"]
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, dict(ms=(time.perf_counter() - t0) * 1e3,
                         comm_ms=(mesh.timers["comm_s"] - c0) * 1e3,
                         copy_ms=(mesh.timers["copy_s"] - k0) * 1e3)

    def same(a, b):
        return all(torch.equal(x.cpu(), y) for x, y in zip(a, b))

    def serve(srv, method, ref):
        row = {}
        for kind, call in (
                ("counts", lambda q: srv.range_counts(q)[0]),
                ("ids", lambda q: srv.range_ids(q, max_hits=c["max_hits"])[
                    :3]),
                ("knn", lambda q: srv.knn(q, c["k"],
                                          max_cand=c["max_cand"])[:3])):
            times = []
            for i, q in enumerate(inp["batches"][kind]):
                got, t = timed(lambda: call(q.to(dev)))
                times.append(t)
                want = ref[kind][i]
                ok = (torch.equal(got.cpu(), want) if kind == "counts"
                      else same(got, want))
                if not ok:
                    raise AssertionError(f"rank {rank}: mesh {method} {kind} "
                                         f"batch {i} differs from the "
                                         f"in-process sharded phase")
            row[kind] = dict(batches=times,
                             p50_ms=pct([t["ms"] for t in times], 0.5),
                             comm_ms_p50=pct([t["comm_ms"] for t in times],
                                             0.5),
                             copy_ms_p50=pct([t["copy_ms"] for t in times],
                                             0.5))
        return row

    note("loaded")
    for method in ("bsp", "hc"):
        note(f"{method}: before staging")
        start()
        # bsp serves the sharded phase's osm objects, hc the join's pi
        mbrs = (inp["mbrs"] if method == "bsp"
                else torch.cat(inp["join_inputs"])).to(dev)
        boxes, valid = inp[f"parts_{method}"]
        parts = api.Partitioning(boxes.to(dev), valid.to(dev))
        srv, t = timed(lambda: SpatialServer(
            parts, mbrs, ServeConfig(placement="sharded", shards=size),
            device=dev, method=method, mesh=mesh))
        row = dict(build=t, t=srv.stats["t"], t_local=srv.stats["t_local"],
                   shard_bytes=srv.stats["shard_bytes"],
                   resident_rows=int(srv.slayout.id_shards.shape[1]),
                   resident_tile_bytes=srv.resident_tile_bytes())
        note(f"{method}: staged")
        if srv.slayout.id_shards.shape[0] != 1:
            raise AssertionError("a rank holds more than its own shard")
        row.update(serve(srv, method, inp[method]))
        note(f"{method}: served")
        if method == "bsp":
            ing = inp["ingest"]
            rep_a, row["append"] = timed(lambda: srv.append(
                inp["append"].to(dev)))
            rep_d, row["delete"] = timed(lambda: srv.delete(
                inp["delete"].to(dev)))
            qc, qi, pts = (inp["batches"][k][0].to(dev)
                           for k in ("counts", "ids", "knn"))
            if not (rep_a == ing["append"] and rep_d == ing["delete"]
                    and torch.equal(srv.range_counts(qc)[0].cpu(),
                                    ing["counts"])
                    and same(srv.range_ids(qi, max_hits=c["max_hits"])[:3],
                             ing["ids"])
                    and same(srv.knn(pts, c["k"],
                                     max_cand=c["max_cand"])[:3],
                             ing["knn"])):
                raise AssertionError(f"rank {rank}: the mesh ingest differs "
                                     f"from the in-process sharded server")
        note(f"{method}: done")
        out["paths"][f"serve_{method}"] = finish(row)
        del srv, mbrs
        if on_card:
            torch.cuda.empty_cache()

    r, s = (x.to(dev) for x in inp["join_inputs"])
    for method in ("bsp", "hc"):
        start()
        want = inp[f"join_{method}"]
        plan, t_plan = timed(lambda: mesh_lib.in_turns(mesh, lambda: (
            engine.plan_join(method, r, s, c["payload"], size, device=dev))))
        count, t_join = timed(lambda: engine.spatial_join_count(
            plan, mesh, max_pairs_per_tile=want["max_n"]))
        raw, t_raw = timed(lambda: engine.run_join_count(plan, mesh,
                                                         dedup="none"))
        if count != want["exact"] or raw != want["raw"]:
            raise AssertionError(f"rank {rank}: the mesh {method} join "
                                 f"counts {count} (raw {raw}), in-process "
                                 f"{want['exact']} ({want['raw']})")
        out["paths"][f"join_{method}"] = finish(dict(
            plan=t_plan, join=t_join, raw=t_raw, exact=count, raw_count=raw))
        del plan
        if on_card:
            torch.cuda.empty_cache()
    start()
    merged = torch.cat([r, s])
    (parts, stats), t = timed(lambda: parallel_partition.parallel_partition(
        merged, c["payload"], size, mesh))
    want = inp["pp"]
    if not (torch.equal(parts.boxes.cpu(), want["boxes"])
            and torch.equal(parts.valid.cpu(), want["valid"])
            and stats == want["stats"]):
        raise AssertionError(f"rank {rank}: the mesh parallel partition "
                             f"differs from the in-process one")
    out["paths"]["parallel_partition"] = finish(dict(partition=t,
                                                     stats=stats))
    with open(f"{path}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    mesh_lib.close(mesh)


MESH_PATHS = {  # mesh path -> the (module, kernel)s it must launch on
    # every rank
    "serve_bsp": (("range_probe", "gather_count_skip"),
                  ("range_probe", "gather_hits_skip")),
    "serve_hc": (("range_probe", "gather_count_skip"),
                 ("range_probe", "gather_hits_skip")),
    "join_bsp": (("mbr_join", "rp_counts"), ("mbr_join", "raw_counts")),
    "join_hc": (("mbr_join", "pair_list"), ("mbr_join", "raw_counts")),
    "parallel_partition": (("hilbert", "encode"),),
}


def mesh_launches_of(launches: dict, entry_name: str) -> int:
    """A kernels-line entry's launches in the mesh phase (summed over
    the ranks; ``launches`` is ``mesh_phase``'s)."""
    if entry_name == "hilbert_encode":
        return launches.get("hilbert", {}).get("encode", 0)
    if entry_name.startswith("mbr_"):
        return launches.get("mbr_join", {}).get(entry_name[4:], 0)
    return launches.get("range_probe", {}).get(entry_name, 0)


def mesh_phase(torch, dev, keep):
    """Queue 1 item 10's mesh mode on the card: ``SHARDS`` spawned ranks
    of a gloo process group on the one card, each holding one owner's
    shard: bsp over the sharded phase's osm objects, its answers and
    ingest held bit for bit to the in-process sharded "x" server
    (``keep``); hc over the join's merged pi objects, held to an
    in-process hc server built here; the joins to the ``SHARDS``-device
    plans' counts and the parallel partition to the in-process one ->
    the launches of every rank, summed by kernel name."""
    import json

    from repro_torch.core.partition import api
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import ServeConfig, SpatialServer

    # hc serves the join phase's 8 M merged pi objects: its MASJ staging
    # of the 8 M osm objects (overlapping tight boxes over the hotspots)
    # took 48.57 GB before its 12.12 GB canonical sort, which one card
    # cannot hold beside four ranks' shards
    pi = torch.cat(keep["join_inputs"]).to(dev)
    hc = api.partition("hc", pi, PAYLOAD)
    srv = SpatialServer(hc, pi, ServeConfig(placement="sharded",
                                            shards=SHARDS),
                        device=dev, method="hc")
    host = lambda x: tuple(v.cpu() for v in x)   # noqa: E731
    b = keep["batches"]
    keep["hc"] = dict(
        counts=[srv.range_counts(q.to(dev))[0].cpu() for q in b["counts"]],
        ids=[host(srv.range_ids(q.to(dev), max_hits=MAX_HITS)[:3])
             for q in b["ids"]],
        knn=[host(srv.knn(p.to(dev), K, max_cand=MAX_CAND)[:3])
             for p in b["knn"]])
    del srv, pi
    torch.cuda.empty_cache()
    ctx = 600 * 2**20             # a CUDA context, reckoned
    held = torch.cuda.memory_reserved(dev) + ctx      # this process
    objects = N * 16                                  # a rank's osm boxes
    plan = dict(phase="mesh_memory_plan", ranks=SHARDS,
                staging_turn_peak=keep["build_peak"],
                shard_bytes=keep["shard_bytes"], context_bytes=ctx,
                parent_bytes=held,
                reckoned_card_peak=held + keep["build_peak"] + SHARDS * (
                    keep["shard_bytes"] + ctx + objects),
                card_bytes=torch.cuda.get_device_properties(dev).total_memory)
    emit(plan)
    if plan["reckoned_card_peak"] > plan["card_bytes"]:
        raise AssertionError("the mesh phase would not fit on the card")
    inputs = dict(keep, parts_hc=(hc.boxes.cpu(), hc.valid.cpu()),
                  consts=dict(payload=PAYLOAD, max_hits=MAX_HITS, k=K,
                              max_cand=MAX_CAND, device=str(dev)))
    with tempfile.TemporaryDirectory() as path:
        torch.save(inputs, f"{path}/inputs.pt")
        t0 = time.perf_counter()
        mesh_lib.spawn(mesh_rank, (SHARDS, path), SHARDS, MESH_DEADLINE_S)
        wall_s = time.perf_counter() - t0
        rows = []
        for r in range(SHARDS):
            with open(f"{path}/rank{r}.json") as f:
                rows.append(json.load(f))
    launches = {}
    for row in rows:
        emit(dict(phase="mesh_rank", backend="gloo", **row))
        for name, path_row in row["paths"].items():
            for mod, k in MESH_PATHS[name]:
                if path_row["launches"][mod].get(k, 0) <= 0:
                    raise AssertionError(f"rank {row['rank']} did not launch "
                                         f"{k} on the mesh path {name}")
            for mod, per in path_row["launches"].items():
                tot = launches.setdefault(mod, {})
                for k, v in per.items():
                    tot[k] = tot.get(k, 0) + v
    for k in list(TABLES.values()) + ["count", "mask"]:
        if launches.get("range_probe", {}).get(k):
            raise AssertionError(f"{k} was launched on the mesh path")
    emit(dict(phase="mesh", ranks=SHARDS, backend="gloo", wall_s=wall_s,
              equal_to_in_process=True, launches=launches))
    return launches


def mesh_alone(torch, dev):
    """The serve, sharded and multi-device join phases' inputs and
    in-process answers (the sharded "x" server alone), then
    ``mesh_phase`` (the kernels build at first use)."""
    from repro_torch.data import spatial_gen
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.serve import ServeConfig, SpatialServer

    cuda_build.build_all([kernel.SOURCE, hkernel.SOURCE, mkernel.SOURCE])
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batches = dict(counts=[qboxes(torch, g, Q, 0.03, dev)
                           for _ in range(MESH_BATCHES)],
                   ids=[qboxes(torch, g, Q_IDS, 0.003, dev)
                        for _ in range(MESH_BATCHES)])
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    batches["knn"] = [torch.rand(Q_KNN, 2, generator=g, device=dev)
                      for _ in range(MESH_BATCHES)]
    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = SpatialServer.from_method("bsp", mbrs, PAYLOAD, ServeConfig(
        placement="sharded", shards=SHARDS), device=dev)
    keep = {}
    parts = srv.parts
    counts = [srv.range_counts(q)[0] for q in batches["counts"]]
    ids = [srv.range_ids(q, max_hits=MAX_HITS)[:3] for q in batches["ids"]]
    knn = [srv.knn(p, K, max_cand=MAX_CAND)[:3] for p in batches["knn"]]
    mesh_keep(torch, srv, mbrs, parts, batches, counts, ids, knn,
              torch.cuda.max_memory_allocated(), keep)
    del srv, mbrs
    torch.cuda.empty_cache()
    from repro_torch.query import engine
    inputs = join_inputs(torch, dev)
    results = {}
    for method in ("bsp", "hc"):       # as join_phase counts them
        plan = engine.plan_join(method, *inputs["pi"], PAYLOAD, 1, device=dev)
        per_tile = engine.tile_counts(plan, dedup="none")
        max_n = max(int(per_tile.max()), 1)
        results["pi", method] = dict(
            exact=engine.spatial_join_count(plan, max_pairs_per_tile=max_n),
            raw=int(per_tile.sum()), max_n=max_n)
        del plan
    sharded_join_phase(torch, dev, inputs, results, keep)
    del inputs
    torch.cuda.empty_cache()
    return mesh_phase(torch, dev, keep)


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_blocked(torch, fn, q, cand, cap, mask_out, budget=2e9):
    """The plain version of one kernel over all queries, in blocks that
    bound its gathered (rows, F, cap, 4) intermediates.

    Queries go in descending order of live candidates, and a block
    gathers only its rows' live prefix of candidates: the router lists
    each query's candidates first and pads with -1, and the plain
    version gives a -1 candidate zero hits, so the padding columns are
    zeros without being gathered (checked below).
    """
    qn, f = cand.shape
    live = (cand >= 0).sum(1)
    order = torch.argsort(live, descending=True)
    live_sorted = live[order].tolist()
    shape = (qn, f, cap) if mask_out else (qn, f)
    out = torch.zeros(shape, dtype=torch.bool if mask_out else torch.int32,
                      device=q.device)
    i = 0
    while i < qn:
        fb = max(1, live_sorted[i])
        rows = max(1, int(budget // (fb * cap * 24)))
        idx = order[i:i + rows]
        if bool((cand[idx, fb:] >= 0).any()):
            raise AssertionError("candidates are not listed live-first")
        out[idx, :fb] = fn(q[idx], cand[idx, :fb])
        i += rows
    return out


def kernel_phase(torch, servers, qc, qi, pts, launches, calls):
    from repro_torch.kernels.range_probe import kernel, ops, ref
    from repro_torch.serve import router
    from repro_torch.serve.engine import _f_width

    lay = {li: s.layout for li, s in servers.items()}
    t, cap = lay["x"].canon_tiles.shape[:2]
    c = lay["x"].chunk_boxes.shape[1]
    gen = torch.Generator(device=qc.device).manual_seed(7)
    rand_alive = torch.rand(t, cap, generator=gen, device=qc.device) < 0.7
    bad = lay["x"].chunk_boxes.clone()   # do NOT bound their members
    jitter = torch.rand(bad.shape, generator=gen, device=qc.device) * 0.02
    bad = torch.cat([bad[..., :2] + jitter[..., :2],
                     bad[..., 2:] - jitter[..., 2:]], dim=-1).contiguous()

    def routed(srv, q):
        """The candidate lists the server routes for batch ``q``, at the
        width its ratchet gives (as ``_route_batch``, minus the update)."""
        hit = router.probe_overlap(srv.probe_boxes, q)
        floor = _f_width(int(hit.sum(1).max()), srv.stats["t_live"])
        f = srv.widths.at_least("range", floor)
        return router.candidates_from_overlap(hit, f)[0]

    entries = []
    for name, replaces in CASES.items():
        skip = name.endswith("_skip")
        li = "x" if skip else "off"
        tiles = lay[li].canon_tiles
        # (alive, the live extent the count and hit-list kernels may
        # stop at)
        extent = servers[li].tiles.extent
        alives = (("staged", (lay[li].alive, extent)), ("none", (None, None)),
                  ("random", (rand_alive, ops.live_extent(rand_alive))))
        boxes = ((("bounding", lay["x"].chunk_boxes), ("non_bounding", bad))
                 if skip else (("none", None),))
        cb0 = lay["x"].chunk_boxes if skip else None
        if name in TABLES:
            entries.append(hit_entry(
                torch, kernel, ops, ref, name, replaces, servers[li], tiles,
                qi.contiguous(), routed(servers[li], qi).contiguous(), pts,
                alives, boxes, cb0, launches, calls))
            continue
        q, cand = qc, routed(servers[li], qc)
        qn, f = cand.shape
        kfn = getattr(kernel, name)
        plain = getattr(ref, name.replace("gather_", "gathered_")
                        .replace("count", "counts"))

        def k_of(al_ext, cb):
            alive, ext = al_ext
            return kfn(q, tiles, *((cb,) if skip else ()), cand, alive=alive,
                       extent=ext)

        def plain_of(al_ext, cb):
            alive = al_ext[0]

            def r(qq, cc):
                boxes = ((ops.gathered_chunk_boxes(cb, cc),) if skip
                         else ())
                return plain(qq, ops.gathered_rows(tiles, cc), *boxes,
                             None if alive is None
                             else ops.gathered_alive(alive, cc))
            return plain_blocked(torch, r, q, cand, cap, False)

        cases, worst = timed_cases(torch, name, k_of, plain_of, alives,
                                   boxes)
        main = cases[0]      # the serving path's own inputs
        work = bound_work(torch, ref, ops, q, cand, tiles, lay[li].alive,
                          cb0, False, extent)
        entry = dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name], max_abs_err=worst, ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=work["bound_ms"],
            bound_by=work["bound_by"], library_ms=None, bit_equal=worst == 0,
            launches_per_batch=launches[name] / calls["counts"] / (
                len(INDEXED) if skip else 1),
            shape=dict(q=qn, f=f, t=t, cap=cap, c=c),
            bound_ms_per_pair=work["pair_bytes"] / HBM_BYTES_PER_S * 1e3,
            cases=cases)
        entry.update(count_designs(torch, kernel, k_of, tiles, cand, cb0,
                                   lay[li].alive, extent, main),
                     bound_ms_full_cap=work["bound_ms_full_cap"])
        entries.append(entry)
    return entries


def refinement_call(torch, srv, pts, skip):
    """The arguments of the last refinement of one kNN batch through
    ``srv`` (the ladder's final attempt) -> ``(qboxes, cand)``."""
    from repro_torch.kernels.range_probe import ops
    fn = "gathered_hit_list_skip" if skip else "gathered_hit_list"
    orig, seen = getattr(ops, fn), []

    def capture(qb, tiles, *rest, **kw):
        seen.append((qb, rest[-1]))
        return orig(qb, tiles, *rest, **kw)

    setattr(ops, fn, capture)
    try:
        srv.knn(pts, K, max_cand=MAX_CAND)
    finally:
        setattr(ops, fn, orig)
    qb, cand = seen[-1]
    return qb.float().contiguous(), cand.int().contiguous()


def hit_stages(torch, kernel, q, tiles, cand, cb, alive, extent):
    """CUDA-event ms of each stage of the hit list, on the path's own
    inputs, and the sizes that set them."""
    t, cap = tiles.shape[:2]
    kw = dict(cboxes=cb, alive=alive, extent=extent)

    def group():
        return kernel.group_pairs(cand, t, cap, extent, zero_counts=False)[1]

    scratch = group()
    seg = kernel.hit_counts(q, tiles, cand, scratch, **kw)
    incl = seg.view(-1).cumsum(0)
    return dict(
        group_ms=cuda_ms(torch, group, 10),
        count_ms=cuda_ms(torch, lambda: kernel.hit_counts(
            q, tiles, cand, scratch, **kw), 10),
        scan_ms=cuda_ms(torch, lambda: seg.view(-1).cumsum(0), 10),
        emit_ms=cuda_ms(torch, lambda: kernel.emit_hits(
            q, tiles, cand, scratch, seg, incl, **kw), 10),
        hits=int(incl[-1]), segments=seg.shape[2],
        count_cells_bytes=seg.numel() * 4,
        live_pairs=int((cand >= 0).sum()))


def old_extraction(torch, kernel, ops, q, tiles, cand, cb, alive):
    """The extraction before the hit lists, composed from the table
    kernel: ``gather_mask{,_skip}`` over ``hit_table_blocks``, then
    ``nonzero`` -> (3, H) int64."""
    parts = []
    for rows, w in ops.hit_table_blocks(cand, tiles.shape[1]):
        cd = cand[rows, :w].contiguous()
        extra = () if cb is None else (cb,)
        fn = kernel.gather_mask if cb is None else kernel.gather_mask_skip
        m = fn(q[rows].contiguous(), tiles, *extra, cd, alive=alive)
        bq, bf, bs = m.nonzero(as_tuple=True)
        parts.append(torch.stack([bq + rows.start, cd[bq, bf].long(), bs]))
    return torch.cat(parts, 1) if parts else torch.zeros(
        (3, 0), dtype=torch.int64, device=q.device)


def hit_entry(torch, kernel, ops, ref, name, replaces, srv, tiles, q, cand,
              pts, alives, boxes, cb0, launches, calls):
    """One routed hit list's row: the emit pipeline held to its plain
    version on the ids batch whole and on one kNN refinement call, in
    every alive and chunk-box case; its stages; the old extraction on
    the same inputs; and the table kernel of the same TPU kernel held
    to its plain version on the old executor's largest table block."""
    skip = cb0 is not None
    cap = tiles.shape[1]
    alive, extent = alives[0][1]
    kfn = getattr(kernel, name)

    def pipeline(qq, cc):
        def k_of(al_ext, cb):
            return kfn(qq, tiles, *((cb,) if skip else ()), cc,
                       alive=al_ext[0], extent=al_ext[1])

        def plain_of(al_ext, cb):
            return torch.stack(ops.plain_hit_list(
                qq, tiles, cc, cb, alive=al_ext[0], budget=PLAIN_TABLE))

        cases, worst = timed_cases(torch, name, k_of, plain_of, alives,
                                   boxes)
        main = k_of(alives[0][1], cb0)
        old = old_extraction(torch, kernel, ops, qq, tiles, cc, cb0, alive)
        if not torch.equal(old, main):
            raise AssertionError(f"{name}: the old extraction gives another "
                                 f"list")
        stages = hit_stages(torch, kernel, qq, tiles, cc, cb0, alive, extent)
        work = bound_work(torch, ref, ops, qq, cc, tiles, alive, cb0, False,
                          extent, out_bytes=stages["hits"] * HIT_BYTES)
        return dict(
            ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
            max_abs_err=worst, bound_ms=work["bound_ms"],
            bound_by=work["bound_by"],
            old_extraction_ms=cuda_ms(torch, lambda: old_extraction(
                torch, kernel, ops, qq, tiles, cc, cb0, alive), 3),
            stages=stages, shape=dict(q=cc.shape[0], f=cc.shape[1],
                                      t=tiles.shape[0], cap=cap),
            cases=cases)

    ids = pipeline(q, cand)
    knn = pipeline(*refinement_call(torch, srv, pts, skip))

    # the table kernel, as before, on the old ids executor's largest block
    table = TABLES[name]
    rows, w = max(ops.hit_table_blocks(cand, cap),
                  key=lambda b: (b[0].stop - b[0].start) * b[1])
    tq, tc = q[rows].contiguous(), cand[rows, :w].contiguous()
    tfn = getattr(kernel, table)
    plain = getattr(ref, table.replace("gather_", "gathered_"))

    def t_of(al_ext, cb):
        return tfn(tq, tiles, *((cb,) if skip else ()), tc, alive=al_ext[0])

    def tplain_of(al_ext, cb):
        al = al_ext[0]

        def r(qq, cc):
            extra = (ops.gathered_chunk_boxes(cb, cc),) if skip else ()
            return plain(qq, ops.gathered_rows(tiles, cc), *extra,
                         None if al is None else ops.gathered_alive(al, cc))
        return plain_blocked(torch, r, tq, tc, cap, True)

    tcases, tworst = timed_cases(torch, table, t_of, tplain_of, alives, boxes)
    twork = bound_work(torch, ref, ops, tq, tc, tiles, alive, cb0, True)
    return dict(
        name=name, route="cuda", source=SOURCE, replaces=replaces,
        launches=launches[name], max_abs_err=max(ids["max_abs_err"],
                                                 knn["max_abs_err"], tworst),
        ms=ids["ms"], plain_ms=ids["plain_ms"], bound_ms=ids["bound_ms"],
        bound_by=ids["bound_by"], library_ms=None,
        bit_equal=max(ids["max_abs_err"], knn["max_abs_err"], tworst) == 0,
        design="count, scan, emit", table_kernel=table,
        table_ms=tcases[0]["ms"], table_plain_ms=tcases[0]["plain_ms"],
        table_bound_ms=twork["bound_ms"], table_launches=launches[table],
        table_shape=dict(q=tq.shape[0], f=w, cap=cap),
        table_cases=tcases, old_extraction_ms=ids["old_extraction_ms"],
        launches_per_batch=launches[name] / calls["ids"] / (
            len(INDEXED) if skip else 1),
        ids=ids, knn_refinement=knn)


def count_designs(torch, kernel, k_of, tiles, cand, cb, alive, extent,
                  main):
    """The routed count kernel on the serving path's inputs without the
    live extent (bit-equal, else raise), the grouping pass alone, and
    the batch's shape (live pairs, -1 share, extents)."""
    t, cap = tiles.shape[:2]
    full = lambda: k_of((alive, None), cb)  # noqa: E731
    if not torch.equal(full(), k_of((alive, extent), cb)):
        raise AssertionError("the count kernel differs without the extent")
    group_ms = cuda_ms(torch, lambda: kernel.group_pairs(cand, t, cap,
                                                         extent), 10)
    live = int((cand >= 0).sum())
    return dict(full_cap_ms=cuda_ms(torch, full, 10), group_ms=group_ms,
                group_share=group_ms / main["ms"], live_pairs=live,
                f=cand.shape[1], pad_share=1 - live / max(cand.numel(), 1),
                extent_mean=float(extent.float().mean()),
                extent_max=int(extent.max()))


def bound_work(torch, ref, ops, q, cand, tiles, alive, cboxes, mask_out,
               extent=None, rows=64, out_bytes=None):
    """Least bytes and operations of one call on these inputs.

    bytes: every (tile, chunk) that some live (query, candidate) pair
    must examine, read once (its alive flags, and its member boxes where
    alive), the chunk boxes of every referenced tile, the queries, the
    candidate list and the output.  With the live ``extent`` an input,
    no slot past it is alive, so the least work stops there: a tile's
    chunks, alive flags and chunk boxes count only up to its extent
    (``bound_ms``); ``bound_ms_full_cap`` counts them over all of cap,
    as before the extent existed.  The output is the (Q, F) counts,
    the (Q, F, cap) table (``mask_out``) or, given ``out_bytes``, a hit
    list's.  Also returned: the reads counted per pair,
    Q*F*live_chunks*128*(16 + 1) plus the output, the bound of a design
    that shares no tile between queries.  operations: four float
    compares per alive slot of every live pair's live chunks.
    """
    t, cap = tiles.shape[:2]
    chunk = ops.CHUNK
    n_chunks = -(-cap // chunk)
    dev = q.device
    c0 = torch.arange(n_chunks, device=dev) * chunk
    if extent is None:
        lim = torch.full((t,), cap, dtype=torch.int64, device=dev)
    else:
        lim = extent.long()
    # slots of each (tile, chunk) below the tile's limit
    below = (lim[:, None] - c0[None, :]).clamp(0, chunk)
    below = torch.cat([below, below.new_zeros(1, n_chunks)])   # -1 row
    touched = torch.zeros(t + 1, n_chunks, dtype=torch.bool, device=dev)
    touched_full = torch.zeros_like(touched)
    pair_chunks = pair_chunks_full = 0
    for i in range(0, q.shape[0], rows):
        cc = cand[i:i + rows]
        idx = torch.where(cc >= 0, cc, t).long()
        if cboxes is None:
            live = (cc >= 0)[..., None].expand(-1, -1, n_chunks)
        else:
            live = ref.gathered_chunk_hits(
                q[i:i + rows], ops.gathered_chunk_boxes(cboxes, cc))
            live = live & (cc >= 0)[..., None]
        live_e = live & (below[idx] > 0)
        for lv, tch in ((live, touched_full), (live_e, touched)):
            tt = idx[..., None].expand_as(lv)[lv]
            tch[tt, torch.nonzero(lv, as_tuple=True)[2]] = True
        pair_chunks_full += int(live.sum())
        pair_chunks += int(live_e.sum())
    touched, touched_full = touched[:t], touched_full[:t]
    slot_alive = torch.cat([alive, alive.new_zeros(
        t, n_chunks * chunk - cap)], dim=1)
    alive_per_chunk = slot_alive.reshape(t, n_chunks, chunk).sum(2)
    alive_touched = int(alive_per_chunk[touched_full].sum())
    ref_t = torch.unique(cand[cand >= 0]).long()
    if out_bytes is None:
        out_bytes = cand.numel() * (cap if mask_out else 4)
    fixed = q.numel() * 4 + cand.numel() * 4 + out_bytes + alive_touched * 16
    box_chunks = (int((-(-lim[ref_t] // chunk)).sum()) if cboxes is not None
                  else 0)
    bytes_ = (int(below[:t][touched].sum()) + box_chunks * 16 + fixed)
    bytes_full = (int(touched_full.sum()) * chunk + fixed
                  + (ref_t.numel() * n_chunks * 16 if cboxes is not None
                     else 0))
    ops_ = 4 * pair_chunks * alive_touched / max(int(touched.sum()), 1)
    ops_full = (4 * pair_chunks_full * alive_touched
                / max(int(touched_full.sum()), 1))

    def bound(b, o):
        return max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S) * 1e3

    return dict(
        bytes=bytes_, ops=ops_, bound_ms=bound(bytes_, ops_),
        bound_by=("bytes" if bytes_ / HBM_BYTES_PER_S >= ops_ / FP32_OPS_PER_S
                  else "operations"),
        bound_ms_full_cap=bound(bytes_full, ops_full),
        pair_bytes=pair_chunks * chunk * 17 + out_bytes)


def timed_cases(torch, name, k_of, plain_of, alives, boxes):
    """Run one kernel and its plain version on every (alive, chunk box)
    case; raise unless bit-equal -> ``(cases, worst error)``."""
    cases, worst = [], 0
    for alive_name, alive in alives:
        for cb_name, cb in boxes:
            def k():
                return k_of(alive, cb)
            got = k()
            t_plain = time.perf_counter()
            want = plain_of(alive, cb)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t_plain) * 1e3
            if got.shape != want.shape:
                raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                     f"{tuple(want.shape)}")
            err = 0 if not got.numel() else int(
                torch.ne(got, want).any() if got.dtype == torch.bool
                else (got - want).abs().max())
            if err != 0:
                raise AssertionError(
                    f"{name} (alive={alive_name}, chunk boxes={cb_name}) "
                    f"differs from its plain version: max abs err {err}")
            worst = max(worst, err)
            cases.append(dict(alive=alive_name, chunk_boxes=cb_name,
                              ms=cuda_ms(torch, k, 10), plain_ms=plain_ms))
    return cases, worst


def dense_kernel_phase(torch, srv, qc, qi, pts, launches):
    """The dense kernels on the "x" staging: the tile-major counts at the
    dense counts batch (Q = 4096), the dense hit list on the ids batch
    and the dense kNN's refinement, and the chunk-skipping pair (counts
    at Q = 4096, the table at the old dense executor's hit-table block
    of the ids batch), each in both its designs."""
    from repro_torch.kernels.range_probe import kernel, ops, ref

    lay = srv.layout
    tiles, alive, cbs = lay.canon_tiles, lay.alive, lay.chunk_boxes
    t, cap = tiles.shape[:2]
    gen = torch.Generator(device=qc.device).manual_seed(8)
    rand_alive = torch.rand(t, cap, generator=gen, device=qc.device) < 0.7
    jitter = torch.rand(cbs.shape, generator=gen, device=qc.device) * 0.02
    bad = torch.cat([cbs[..., :2] + jitter[..., :2],
                     cbs[..., 2:] - jitter[..., 2:]], dim=-1).contiguous()
    alives = (("staged", (alive, srv.tiles.extent)), ("none", (None, None)),
              ("random", (rand_alive, ops.live_extent(rand_alive))))
    entries = [
        dense_count_entry(torch, kernel, ref, qc, tiles, alives, launches),
        dense_hits_entry(torch, kernel, ops, ref, srv, qi, pts, tiles,
                         alives, launches)]
    rows = ops.dense_blocks(qi.shape[0], t * cap)[0]
    for name in ("count_skip", "mask_skip"):
        entries.append(dense_skip_entry(
            torch, kernel, ref, name, qi[rows] if name == "mask_skip" else qc,
            tiles, alive, cbs, bad, alives, launches))
    for e in entries:    # a time below the bound would be a wrong bound
        if e["ms"] < e["bound_ms"]:
            raise AssertionError(f"{e['name']}: {e['ms']} ms is below its "
                                 f"stated bound, {e['bound_ms']} ms")
    return entries


def dense_skip_entry(torch, kernel, ref, name, q, tiles, alive, cbs, bad,
                     alives, launches):
    """Rows 7 and 8, the dense chunk-skipping pair (no serving caller):
    in all six (alive, chunk box) cases the new design (to each case's
    extent, and without it) and the first design (``_v1``) held to the
    plain version, bit-equal else raise; the two designs timed in turns
    (new, first, first, new), and for the counts the tile-major dense
    counts on the same inputs in the same turns.  The counts' plain
    version runs on the batch's first ``PLAIN_Q`` queries, against each
    design at those queries; the designs are timed on the whole batch
    (and, for the entry's ``ms_at_plain_q``, at ``PLAIN_Q``)."""
    mask_out = name == "mask_skip"
    kfn, v1fn = getattr(kernel, name), getattr(kernel, name + "_v1")
    plain = getattr(ref, "probe_" + name.replace("count", "counts"))
    t, cap = tiles.shape[:2]
    qp = q if mask_out else q[:PLAIN_Q]

    def plain_of(al, cb, block=8):
        if mask_out:
            return plain(qp, tiles, cb, al).transpose(0, 1)
        return torch.cat([plain(qp[i:i + block], tiles, cb, al)
                          for i in range(0, qp.shape[0], block)])

    cases = []
    for alive_name, (al, ext) in alives:
        for cb_name, cb in (("bounding", cbs), ("non_bounding", bad)):
            designs = dict(
                new=lambda x, al=al, ext=ext, cb=cb: kfn(x, tiles, cb,
                                                         alive=al,
                                                         extent=ext),
                full_cap=lambda x, al=al, cb=cb: kfn(x, tiles, cb, alive=al),
                v1=lambda x, al=al, cb=cb: v1fn(x, tiles, cb, alive=al))
            got = {k: fn(qp) for k, fn in designs.items()}
            t0 = time.perf_counter()
            want = plain_of(al, cb)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for k, out in got.items():
                if out.shape != want.shape or not torch.equal(out, want):
                    raise AssertionError(
                        f"{name} ({k}, alive={alive_name}, chunk boxes="
                        f"{cb_name}) differs from its plain version")
            turns = [("new", designs["new"]), ("v1", designs["v1"])]
            if not mask_out and cb_name == "bounding":
                def dense(x, al=al, ext=ext):
                    return kernel.dense_counts(x, tiles, alive=al, extent=ext)
                # chunk boxes that bound their members skip no hit
                if not torch.equal(dense(qp), want):
                    raise AssertionError("dense counts differ from the "
                                         "skipping plain version on bounding "
                                         "chunk boxes")
                turns.append(("dense_counts", dense))
            ms = {k: [] for k, _ in turns}
            for k, fn in turns + turns[::-1]:
                ms[k].append(cuda_ms(torch, lambda fn=fn: fn(q), 10))
            case = dict(alive=alive_name, chunk_boxes=cb_name,
                        plain_ms=plain_ms, plain_q=qp.shape[0],
                        full_cap_ms=cuda_ms(
                            torch, lambda: designs["full_cap"](q), 10),
                        **{("ms" if k == "new" else f"{k}_ms"): sum(v) / 2
                           for k, v in ms.items()},
                        turns_ms=ms)
            if len(cases) == 0:
                case["ms_at_plain_q"] = cuda_ms(
                    torch, lambda: designs["new"](qp), 10)
            cases.append(case)
    main = cases[0]      # staged alive mask, bounding chunk boxes
    al0, ext0 = alives[0][1]
    work = dense_bound_work(torch, ref, q, tiles, al0, cbs, mask_out, ext0)
    entry = dict(
        name=name, route="cuda", source=SOURCE,
        replaces=DENSE_CASES[name], launches=launches[name],
        max_abs_err=0, ms=main["ms"], plain_ms=main["plain_ms"],
        plain_q=main["plain_q"], ms_at_plain_q=main["ms_at_plain_q"],
        bound_ms=work["bound_ms"], bound_by=work["bound_by"],
        library_ms=None, bit_equal=True, on_serving_path=False,
        launched_by="this phase only (repro launches it from tests only)",
        design=("tile-major to the extent, Morton-ordered runs, live "
                "(unit, run) items" if not mask_out else
                "slot-parallel, 16 slots a thread, 16-byte stores"),
        old_design=name + "_v1", old_design_ms=main["v1_ms"],
        old_launches=launches[name + "_v1"],
        bound_ms_full_cap=work["bound_ms_full_cap"],
        bound_bytes=work["bytes"], bound_ops=work["ops"],
        bound_share=work["bound_ms"] / main["ms"],
        shape=dict(q=q.shape[0], t=t, cap=cap, c=cbs.shape[1]),
        cases=cases)
    if not mask_out:
        entry["dense_counts_ms"] = main["dense_counts_ms"]
    return entry


def plain_dense_counts(torch, ref, q, tiles, alive, block=8):
    return torch.cat([ref.probe_counts(q[i:i + block], tiles, alive)
                      for i in range(0, q.shape[0], block)])


def dense_count_entry(torch, kernel, ref, q, tiles, alives, launches):
    """Row 5: the tile-major dense counts (four queries a thread, to each
    tile's extent) on the dense counts batch, in every alive case, held
    to the plain version; beside them on the same inputs, each held to
    it too: the same kernel without the extent and the old
    block-per-(tile, query block) ``count``.  The plain version runs on
    the batch's first ``PLAIN_Q`` queries, against each design at those
    queries; the designs are timed on the whole batch (``ms``) and at
    ``PLAIN_Q`` (``ms_at_plain_q``)."""
    t, cap = tiles.shape[:2]
    qp = q[:PLAIN_Q]
    cases = []
    for alive_name, (al, ext) in alives:
        t0 = time.perf_counter()
        want = plain_dense_counts(torch, ref, qp, tiles, al)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3

        def new(x, e=ext, al=al):
            return kernel.dense_counts(x, tiles, alive=al, extent=e)

        def old(x, al=al):
            return kernel.count(x, tiles, alive=al)

        case = dict(alive=alive_name, plain_ms=plain_ms, plain_q=qp.shape[0],
                    ms_at_plain_q=cuda_ms(torch, lambda: new(qp), 10))
        for key, fn, reps in (("ms", new, 10),
                              ("full_cap_ms", lambda x: new(x, None), 10),
                              ("old_design_ms", old, 3)):
            if not torch.equal(fn(qp), want):
                raise AssertionError(f"dense counts ({key}, alive="
                                     f"{alive_name}) differ from the plain "
                                     f"version")
            case[key] = cuda_ms(torch, lambda fn=fn: fn(q), reps)
        cases.append(case)
    main = cases[0]
    al, ext = alives[0][1]
    work = dense_bound_work(torch, ref, q, tiles, al, None, False, ext)
    return dict(
        name="dense_counts", route="cuda", source=SOURCE,
        replaces=DENSE_CASES["dense_counts"],
        launches=launches["dense_counts"], max_abs_err=0, ms=main["ms"],
        plain_ms=main["plain_ms"], plain_q=main["plain_q"],
        ms_at_plain_q=main["ms_at_plain_q"], bound_ms=work["bound_ms"],
        bound_by=work["bound_by"], library_ms=None, bit_equal=True,
        design="tile-major, four queries a thread, to the extent",
        old_design="count", old_design_ms=main["old_design_ms"],
        old_launches=launches["count"],
        bound_ms_full_cap=work["bound_ms_full_cap"],
        group_ms=cuda_ms(torch, lambda: kernel.dense_group(tiles, ext), 10),
        extent_sum=int(ext.long().sum()), alive_slots=int(al.sum()),
        shape=dict(q=q.shape[0], t=t, cap=cap), cases=cases)


def dense_refinement(torch, srv, pts):
    """The query boxes of the dense kNN's refinement of ``pts``."""
    from repro_torch.kernels.range_probe import ops
    orig, seen = ops.dense_hit_list, []

    def capture(qb, *args, **kw):
        seen.append(qb)
        return orig(qb, *args, **kw)

    ops.dense_hit_list = capture
    try:
        srv.knn(pts, K, max_cand=MAX_CAND, pruned=False)
    finally:
        ops.dense_hit_list = orig
    return seen[-1].float().contiguous()


def old_dense_extraction(torch, kernel, ops, q, tiles, alive):
    """The dense extraction before the hit list: ``mask``'s table over
    ``dense_blocks`` (2 GiB each), then ``nonzero`` -> (3, H) int64."""
    t, cap = tiles.shape[:2]
    parts = []
    for rows in ops.dense_blocks(q.shape[0], t * cap):
        m = kernel.mask(q[rows].contiguous(), tiles, alive=alive)
        bq, bt, bs = m.nonzero(as_tuple=True)
        parts.append(torch.stack([bq + rows.start, bt, bs]))
    return torch.cat(parts, 1)


def dense_hit_stages(torch, kernel, q, tiles, alive, extent):
    """CUDA-event ms of each stage of the dense hit list (one block), on
    the path's own inputs, and the sizes that set them."""
    t = tiles.shape[0]
    kw = dict(alive=alive, extent=extent)
    scratch = kernel.dense_group(tiles, extent)
    seg = kernel.dense_hit_counts(q, tiles, scratch, **kw)
    incl = seg.view(-1).cumsum(0)

    return dict(
        group_ms=cuda_ms(torch, lambda: kernel.dense_group(tiles, extent),
                         10),
        count_ms=cuda_ms(torch, lambda: kernel.dense_hit_counts(
            q, tiles, scratch, **kw), 10),
        scan_ms=cuda_ms(torch, lambda: seg.view(-1).cumsum(0), 10),
        emit_ms=cuda_ms(torch, lambda: kernel.dense_emit_hits(
            q, tiles, scratch, seg, incl, **kw), 10),
        hits=int(incl[-1]), segments=seg.shape[2],
        units=int(scratch[3 * t]), count_cells_bytes=seg.numel() * 4)


def dense_hits_entry(torch, kernel, ops, ref, srv, qi, pts, tiles, alives,
                     launches):
    """Row 6: the dense hit list (count, scan, emit to each tile's
    extent) held to its plain version (the reference's table in blocks,
    then ``nonzero``) on the ids batch whole and on the dense kNN's
    refinement, in every alive case; its stages; the old extraction on
    the same inputs; and the old table kernel ``mask`` held to its
    plain version on the old executor's table block."""
    t, cap = tiles.shape[:2]
    al0, ext0 = alives[0][1]

    def pipeline(qq):
        cases = []
        for alive_name, (al, ext) in alives:
            def fn(al=al, ext=ext):
                return torch.stack(ops.dense_hit_list(qq, tiles, alive=al,
                                                      extent=ext))
            got = fn()
            t0 = time.perf_counter()
            want = torch.stack(ops.plain_dense_hit_list(qq, tiles, alive=al))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got, want):
                raise AssertionError(f"dense_hits (alive={alive_name}) "
                                     f"differs from its plain version")
            full = torch.stack(ops.dense_hit_list(qq, tiles, alive=al))
            if not torch.equal(full, want):
                raise AssertionError("dense_hits differs without the extent")
            cases.append(dict(alive=alive_name, ms=cuda_ms(torch, fn, 10),
                              plain_ms=plain_ms, hits=got.shape[1]))
        main = torch.stack(ops.dense_hit_list(qq, tiles, alive=al0,
                                              extent=ext0))
        old = old_dense_extraction(torch, kernel, ops, qq, tiles, al0)
        if not torch.equal(old, main):
            raise AssertionError("dense_hits: the old extraction gives "
                                 "another list")
        stages = dense_hit_stages(torch, kernel, qq, tiles, al0, ext0)
        work = dense_bound_work(torch, ref, qq, tiles, al0, None, False, ext0,
                                out_bytes=stages["hits"] * HIT_BYTES)
        return dict(
            ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
            bound_ms=work["bound_ms"], bound_by=work["bound_by"],
            bound_ms_full_cap=work["bound_ms_full_cap"],
            old_extraction_ms=cuda_ms(torch, lambda: old_dense_extraction(
                torch, kernel, ops, qq, tiles, al0), 1),   # 1.6 s a call
            stages=stages, q=qq.shape[0], cases=cases)

    ids = pipeline(qi)
    ids_256 = pipeline(qi[:DENSE_ROWS].contiguous())
    knn = pipeline(dense_refinement(torch, srv, pts))

    # the old table kernel, on the old dense executor's first table block
    rows = ops.dense_blocks(qi.shape[0], t * cap)[0]
    tq = qi[rows].contiguous()

    def t_of(al, cb):
        return kernel.mask(tq, tiles, alive=al[0])

    def tplain_of(al, cb):
        return ref.probe_mask(tq, tiles, al[0]).transpose(0, 1)

    tcases, tworst = timed_cases(torch, "mask", t_of, tplain_of, alives,
                                 (("none", None),))
    twork = dense_bound_work(torch, ref, tq, tiles, al0, None, True)
    return dict(
        name="dense_hits", route="cuda", source=SOURCE,
        replaces=DENSE_CASES["dense_hits"], launches=launches["dense_hits"],
        max_abs_err=tworst, ms=ids["ms"], plain_ms=ids["plain_ms"],
        bound_ms=ids["bound_ms"], bound_by=ids["bound_by"], library_ms=None,
        bit_equal=tworst == 0, design="count, scan, emit, to the extent",
        bound_ms_full_cap=ids["bound_ms_full_cap"],
        old_design="mask + nonzero", old_design_ms=ids["old_extraction_ms"],
        old_extraction_ms=ids["old_extraction_ms"], table_kernel="mask",
        table_ms=tcases[0]["ms"], table_plain_ms=tcases[0]["plain_ms"],
        table_bound_ms=twork["bound_ms"], table_launches=launches["mask"],
        table_shape=dict(q=tq.shape[0], t=t, cap=cap), table_cases=tcases,
        ids=ids, ids_256=ids_256, knn_refinement=knn)


def dense_bound_work(torch, ref, q, tiles, alive, cboxes, mask_out,
                     extent=None, out_bytes=None, rows=16):
    """Least bytes and operations of one dense call on these inputs.

    bytes: the queries and the output written once ((Q, T) counts, the
    (Q, T, cap) table (``mask_out``) or, given ``out_bytes``, a hit
    list's), and each input read once: without chunk boxes every alive
    flag and every alive slot's box; with them, the alive flags of the
    chunks some query reaches, the boxes of their alive slots, and the
    chunk boxes.  Given the ``extent`` (no slot past it is alive), flags
    and chunk boxes count up to each tile's extent (``bound_ms``), else
    over all of cap (``bound_ms_full_cap``, also computed with it).
    operations: four float compares per (query, alive slot) and, with
    chunk boxes, per (query, alive slot) of the chunks the query hits
    plus per (query, chunk) test of the chunks that hold an alive slot
    (all below the extent; a chunk with none adds nothing to any count,
    tested or not).
    """
    t, cap = tiles.shape[:2]
    qn = q.shape[0]
    n_alive = int(alive.sum())
    if out_bytes is None:
        out_bytes = qn * t * (cap if mask_out else 4)
    base = q.numel() * 4 + out_bytes
    lim = (torch.full((t,), cap, dtype=torch.int64, device=q.device)
           if extent is None else extent.long())
    if cboxes is None:
        ops_ = ops_full = 4 * qn * n_alive
        bytes_ = base + n_alive * 16 + int(lim.sum())
        bytes_full = base + n_alive * 16 + t * cap
    else:
        n_chunks = cboxes.shape[1]
        c0 = torch.arange(n_chunks, device=q.device) * 128
        below = (lim[:, None] - c0[None, :]).clamp(0, 128)  # flags to read
        in_cap = (cap - c0).clamp(max=128).expand(t, -1)
        slot_alive = torch.cat([alive, alive.new_zeros(
            t, n_chunks * 128 - cap)], dim=1)
        per_chunk = slot_alive.reshape(t, n_chunks, 128).sum(2)
        reached = torch.zeros(t, n_chunks, dtype=torch.bool, device=q.device)
        live_slots = 0
        for i in range(0, qn, rows):
            hit = ref.chunk_hits(q[i:i + rows], cboxes)       # (B, T, C)
            reached |= hit.any(0)
            live_slots += int((hit * per_chunk).sum())
        boxes = int(per_chunk[reached].sum()) * 16
        chunks_below = int((-(-lim // 128)).sum())
        bytes_ = base + boxes + int(below[reached].sum()) + chunks_below * 16
        bytes_full = (base + boxes + int(in_cap[reached].sum())
                      + t * n_chunks * 16)
        ops_ = ops_full = 4 * live_slots + 4 * qn * int((per_chunk > 0).sum())

    def bound(b, o):
        return max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S) * 1e3

    return dict(
        bytes=bytes_, ops=ops_, bound_ms=bound(bytes_, ops_),
        bound_by=("bytes" if bytes_ / HBM_BYTES_PER_S >= ops_ / FP32_OPS_PER_S
                  else "operations"),
        bound_ms_full_cap=bound(bytes_full, ops_full))


def median(xs):
    return sorted(xs)[len(xs) // 2]


def timed_s(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def join_inputs(torch, dev):
    """R and S of each join input, generated on the card (seeds 0, 1)."""
    from repro_torch.data import spatial_gen
    return {name: (spatial_gen.dataset(name, n, seed=SEED, device=dev),
                   spatial_gen.dataset(name, n, seed=SEED + 1, device=dev))
            for name, n in JOIN_INPUTS.items()}


def partition_phase(torch, r, s):
    """The six partitioners on the merged pi input, with the paper's
    layout metrics -> hc's encode launches."""
    from repro_torch.core import metrics
    from repro_torch.core.partition import api, partition_counts
    from repro_torch.kernels.hilbert import kernel as hkernel

    merged = torch.cat([r, s])
    n = merged.shape[0]
    hkernel.reset_launches()
    for method in METHODS:
        before = hkernel.LAUNCHES["encode"]
        parts, secs = timed_s(torch, lambda: api.partition(method, merged,
                                                           PAYLOAD))
        counts, copies = partition_counts(merged, parts)
        emit(dict(
            phase="partition", method=method, n=n, payload=PAYLOAD,
            seconds=secs, k=parts.k(), kmax=parts.kmax,
            lambda_=float(metrics.boundary_ratio(counts, parts.valid, n)),
            balance_stddev=float(metrics.balance_stddev(counts,
                                                        parts.valid)),
            skew=float(metrics.skew_ratio(counts, parts.valid)),
            coverage=float(metrics.coverage(copies)),
            encode_launches=hkernel.LAUNCHES["encode"] - before))
    launches = hkernel.LAUNCHES["encode"]
    if launches <= 0:
        raise AssertionError("hc did not launch the encode kernel")
    return launches


def live_tiles(plan):
    """(slot, live_r, live_s) of a one-device plan's tiles with members
    on both sides."""
    for j, (nr, ns) in enumerate(zip(plan.live_r[0], plan.live_s[0])):
        if nr and ns:
            yield j, int(nr), int(ns)


def old_raw_counts(torch, plan):
    """The per-tile raw count the batched one replaced, a yardstick: tile
    by tile, ``join.tile_join_count(dedup="none")`` (``pad_cm`` and the
    ``count`` kernel's block sums) -> (T,) int64."""
    from repro_torch.query import join

    out = torch.zeros(plan.r_tiles.shape[1], dtype=torch.int64,
                      device=plan.r_tiles.device)
    for j, nr, ns in live_tiles(plan):
        out[j] = join.tile_join_count(plan.r_tiles[0, j, :nr],
                                      plan.s_tiles[0, j, :ns],
                                      plan.tile_boxes[0, j], plan.universe,
                                      dedup="none")
    return out


def old_join(torch, plan, overlapping, max_pairs):
    """The per-tile table join on the same plan, a yardstick: tile by tile, the
    ``mask`` table kernel, then ``rp_own_mask``, ``&`` and a sum (rp), or
    ``nonzero`` (MASJ) and ``unique_pairs`` over the concatenation ->
    ``(count, per-tile counts or (rid, sid))``."""
    from repro_torch.query import dedup, join

    tiles = list(live_tiles(plan))

    def args(j, nr, ns):
        return (plan.r_tiles[0, j, :nr], plan.s_tiles[0, j, :ns])

    if not overlapping:
        out = torch.zeros(plan.r_tiles.shape[1], dtype=torch.int64,
                          device=plan.r_tiles.device)
        for j, nr, ns in tiles:
            out[j] = join.tile_join_count(*args(j, nr, ns),
                                          plan.tile_boxes[0, j],
                                          plan.universe)
        return int(out.sum()), out
    prs, pss = [], []
    for j, nr, ns in tiles:
        pr, ps, _ = join.tile_pairs(*args(j, nr, ns), plan.r_ids[0, j, :nr],
                                    plan.s_ids[0, j, :ns],
                                    plan.tile_boxes[0, j], plan.universe,
                                    max_pairs)
        prs.append(pr)
        pss.append(ps)
    rid, sid = torch.cat(prs), torch.cat(pss)
    return int(dedup.unique_pairs(rid, sid)[0]), (rid, sid)


def join_phase(torch, dev, inputs):
    """plan_join + spatial_join_count for six layouts on each input ->
    ``(results, launches, bsp plans' largest tiles, bsp pair lists, the
    bsp and hc plans)``.  The per-tile table join runs on the bsp and hc
    plans as a yardstick; its launches are not counted."""
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.query import engine

    hkernel.reset_launches()
    mkernel.reset_launches()
    results, tiles, pairs, plans = {}, {}, {}, {}
    for name, (r, s) in inputs.items():
        for method in METHODS:
            torch.cuda.reset_peak_memory_stats()
            plan_s = []
            for _ in range(3):
                plan, secs = timed_s(torch, lambda: engine.plan_join(
                    method, r, s, PAYLOAD, 1, device=dev))
                plan_s.append(secs)
            m0 = dict(mkernel.LAUNCHES)
            per_tile = engine.tile_counts(plan, dedup="none")
            raw = int(per_tile.sum())
            max_n = max(int(per_tile.max()), 1)
            m1 = dict(mkernel.LAUNCHES)
            raw_launches = {k: m1[k] - m0[k] for k in m1}
            if raw_launches["raw_counts"] != 1 or raw_launches["count"]:
                raise AssertionError(f"{name} {method}: the raw count "
                                     f"launched {raw_launches}, want one "
                                     f"raw_counts and no count")
            raw_s = []
            for _ in range(3):
                _, secs = timed_s(torch, lambda: engine.run_join_count(
                    plan, dedup="none"))
                raw_s.append(secs)
            m1 = dict(mkernel.LAUNCHES)
            old_raw = old_raw_counts(torch, plan)
            mkernel.LAUNCHES.update(m1)              # the yardstick's
            if not torch.equal(old_raw, per_tile):
                raise AssertionError(f"{name} {method}: the per-tile raw "
                                     f"count differs from the batched one")
            join_s = []
            for _ in range(3):
                exact, secs = timed_s(torch, lambda: engine.spatial_join_count(
                    plan, max_pairs_per_tile=max_n))
                join_s.append(secs)
            m2 = dict(mkernel.LAUNCHES)
            per_join = {k: (m2[k] - m1[k]) / 3 for k in m2}
            st = plan.stats
            want = ({"pair_list": 1, "rp_counts": 0} if st["overlapping"]
                    else {"pair_list": 0, "rp_counts": 1})
            if any(per_join[k] != v for k, v in dict(want, mask=0,
                                                     count=0).items()):
                raise AssertionError(f"{name} {method}: spatial_join_count "
                                     f"launched {per_join}, want {want} "
                                     f"and no mask or count")
            mstats = {}
            rid, sid, uniq = engine.masj_pairs(plan, max_pairs_per_tile=max_n,
                                               stats=mstats)
            masj = int(uniq.sum())
            tpd = plan.r_tiles.shape[1]
            live = plan.live_r * plan.live_s
            results[name, method] = dict(
                exact=exact, raw=raw, masj=masj, max_n=max_n,
                overlapping=st["overlapping"],
                truncated_tiles=mstats["truncated_tiles"])
            emit(dict(
                phase="join", input=name, method=method,
                n_r=r.shape[0], n_s=s.shape[0], payload=PAYLOAD,
                plan_s=median(plan_s), join_s=median(join_s),
                plan_s_all=plan_s, join_s_all=join_s,
                raw_count_s=median(raw_s), raw_count_s_all=raw_s,
                k=st["k"], cap_r=st["cap_r"], cap_s=st["cap_s"],
                lambda_r=st["lambda_r"], lambda_s=st["lambda_s"],
                skew=st["skew"], exact=exact, raw=raw, masj_pairs=masj,
                max_tile_pairs=max_n, gathered_pairs=mstats["pairs"],
                truncated_tiles=mstats["truncated_tiles"],
                live_tests=int(live.sum()), live_tiles=int((live > 0).sum()),
                padded_pair_table_bytes=2 * 4 * tpd * max_n,
                launches_per_join=per_join,
                raw_count_launches=raw_launches,
                max_memory_allocated=torch.cuda.max_memory_allocated()))
            if method in ("bsp", "hc"):
                # a window of about 0.2 s: one call of a few ms is too
                # short for the profiler to report its device work
                reps = max(1, min(40, int(0.2 / median(join_s)) + 1))
                dev_ms, top = device_busy(torch, lambda: (
                    engine.spatial_join_count(plan,
                                              max_pairs_per_tile=max_n)),
                                          reps)
                counted = dict(mkernel.LAUNCHES)
                old_s, old_raw_s = [], []
                for _ in range(3):
                    (old, _), secs = timed_s(torch, lambda: old_join(
                        torch, plan, st["overlapping"], max_n))
                    old_s.append(secs)
                    _, secs = timed_s(torch, lambda: old_raw_counts(
                        torch, plan))
                    old_raw_s.append(secs)
                mkernel.LAUNCHES.update(counted)     # the yardsticks'
                if old != exact:
                    raise AssertionError(f"{name} {method}: the per-tile "
                                         f"join counts {old}, not {exact}")
                emit(dict(phase="join_device", input=name, method=method,
                          device_ms_per_join=dev_ms, profiled_joins=reps,
                          top_device=top,
                          join_s=median(join_s), old_join_s=median(old_s),
                          old_join_s_all=old_s, raw_count_s=median(raw_s),
                          old_raw_count_s=median(old_raw_s),
                          old_raw_count_s_all=old_raw_s))
                plans[name, method] = plan
            if method == "bsp":
                j = int(torch.from_numpy(live)[0].argmax())
                nr, ns = int(plan.live_r[0, j]), int(plan.live_s[0, j])
                tiles[name] = (plan.r_tiles[0, j, :nr].clone(),
                               plan.s_tiles[0, j, :ns].clone())
                pairs[name] = (rid[uniq], sid[uniq])
            del plan, rid, sid, uniq
    launches = dict(mkernel.LAUNCHES, **hkernel.LAUNCHES)
    for k in ("raw_counts", "rp_counts", "pair_list", "encode"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the join path: "
                                 f"{launches}")
    for k in ("count", "mask", "encode_v1"):
        if launches[k]:
            raise AssertionError(f"{k} was launched on the join path: "
                                 f"{launches}")
    return results, launches, tiles, pairs, plans


def join_check_phase(torch, inputs, results, pairs):
    """The join's exactness against the unpartitioned oracle and a
    brute force of sampled objects; raises on any disagreement."""
    from repro_torch.core import geometry
    from repro_torch.kernels.mbr_join import ops as mops

    for name, (r, s) in inputs.items():
        rows = [results[name, m] for m in METHODS]
        exact = rows[0]["exact"]
        oracle, oracle_s = timed_s(torch, lambda: int(mops.join_count(r, s)))
        for m, row in zip(METHODS, rows):
            if row["exact"] != exact:
                raise AssertionError(f"{name}: {m} counts {row['exact']}, "
                                     f"{METHODS[0]} {exact}")
            if not row["overlapping"] and row["exact"] != row["masj"]:
                raise AssertionError(f"{name}: {m} rp {row['exact']} != "
                                     f"MASJ pairs {row['masj']}")
            if row["raw"] < row["exact"] or row["truncated_tiles"]:
                raise AssertionError(f"{name}: {m} raw {row['raw']} or "
                                     f"truncation {row['truncated_tiles']}")
        if oracle != exact:
            raise AssertionError(f"{name}: exact {exact} != unpartitioned "
                                 f"join_count {oracle}")
        g = torch.Generator(device=r.device).manual_seed(SEED + 3)
        sample = torch.randperm(r.shape[0], generator=g,
                                device=r.device)[:JOIN_SAMPLE]
        rid, _ = pairs[name]
        got = torch.bincount(rid.long(), minlength=r.shape[0])[sample]
        want = torch.cat([
            geometry.intersects(r[sample[i:i + 64], None, :],
                                s[None, :, :]).sum(1)
            for i in range(0, JOIN_SAMPLE, 64)])
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: bsp partner counts differ from "
                                 f"the brute force")
        emit(dict(phase="join_check", input=name, exact=exact,
                  unpartitioned=oracle, unpartitioned_s=oracle_s,
                  all_six_equal=True, rp_equals_masj=True,
                  sampled_objects=JOIN_SAMPLE,
                  sampled_partners=int(want.sum()), truncated_tiles=0))


def encode_sass_ops() -> dict:
    """The built encode kernel's SASS (``cuobjdump -sass``): the
    instructions of ``encode_vec_kernel``'s grid-stride loop (the span of
    its widest backward branch), NOPs left out, over the four points an
    iteration encodes -> ops per point, the loop's length and its
    opcodes."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hilbert import kernel as hkernel

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(hkernel.build())],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                if "encode_vec_kernel" in f.split("\n", 1)[0])
    ops, at, labels = [], {}, {}
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if lab:
            labels[lab.group(1)] = len(ops)
        elif ins:
            at[int(ins.group(1), 16)] = len(ops)
            ops.append(ins.group(2))
    loops = []
    for i, op in enumerate(ops):
        jump = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", op)
        if jump:
            tgt = jump.group(1)
            j = labels.get(tgt) if tgt.startswith(".L") else at.get(
                int(tgt, 16))
            if j is not None and j <= i:
                loops.append((i - j, j, i))
    if not loops:
        raise AssertionError("no loop found in encode_vec_kernel's SASS")
    _, j, i = max(loops)
    loop = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
            for op in ops[j:i + 1]]
    loop = [op for op in loop if not op.startswith("NOP")]
    counts: dict[str, int] = {}
    for op in loop:
        counts[op] = counts.get(op, 0) + 1
    return dict(ops_per_point=len(loop) / 4, loop_instructions=len(loop),
                points_per_iteration=4, kernel_instructions=len(ops),
                opcodes=dict(sorted(counts.items(), key=lambda kv: -kv[1])))


def new_kernel_phase(torch, inputs, tiles, plans, results, launches):
    """encode on the 8 M merged pi centroids; count and mask on the
    largest live tile of each bsp join; the batched rp count on the bsp
    plans and the batched pair list on the hc plans, whole.  Bit-equal
    to the plain versions, else raise."""
    from repro_torch.core import geometry, hilbert
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.hilbert import ref as href
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.mbr_join import ops as mops
    from repro_torch.kernels.mbr_join import ref as mref

    def compare(name, k, plain):
        got = k()
        want, plain_s = timed_s(torch, plain)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        return dict(ms=cuda_ms(torch, k, 10), plain_ms=plain_s * 1e3)

    def entry(name, source, case, bytes_, ops_, shape, rate=FP32_OPS_PER_S):
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops_ / rate * 1e3
        return dict(name=name, route="cuda", source=source,
                    replaces=NEW_CASES[name], launches=launches[name],
                    max_abs_err=0, ms=case["ms"], plain_ms=case["plain_ms"],
                    bound_ms=max(b_ms, o_ms),
                    bound_by="bytes" if b_ms >= o_ms else "operations",
                    library_ms=None, bit_equal=True, shape=shape)

    r, s = inputs["pi"]
    merged = torch.cat([r, s])
    order = hilbert.DEFAULT_ORDER
    sass = encode_sass_ops()
    g = torch.Generator(device=r.device).manual_seed(SEED + 4)
    grids = {
        "pi_centroids": [c.contiguous() for c in hilbert.quantize(
            geometry.centroids(merged), geometry.universe(merged))],
        "staging_launch": [torch.randint(0, 1 << order, (HILBERT_SLOTS,),
                                         generator=g, device=r.device,
                                         dtype=torch.int32)
                           for _ in range(2)]}
    cases = {}
    for inp, (gx, gy) in grids.items():
        n = gx.shape[0]
        case = compare("hilbert_encode", lambda: hkernel.encode(gx, gy, order),
                       lambda: href.encode(gx, gy, order))
        if not torch.equal(hkernel.encode_v1(gx, gy, order),
                           hkernel.encode(gx, gy, order)):
            raise AssertionError("encode_v1 differs from encode")
        turns = [cuda_ms(torch, fn, 10) for fn in (
            lambda: hkernel.encode_v1(gx, gy, order),
            lambda: hkernel.encode(gx, gy, order),
            lambda: hkernel.encode(gx, gy, order),
            lambda: hkernel.encode_v1(gx, gy, order))]
        cases[inp] = dict(
            case, ms=(turns[1] + turns[2]) / 2,
            v1_ms=(turns[0] + turns[3]) / 2,
            turns_ms=turns, bytes=16 * n, ops=sass["ops_per_point"] * n,
            shape=dict(n=n, order=order))
    hkernel.LAUNCHES["encode_v1"] = 0     # the yardstick's
    main = cases["pi_centroids"]
    e = entry("hilbert_encode", HILBERT_SOURCE, main, main["bytes"],
              main["ops"], main["shape"], INT_OPS_PER_S)
    e.update(old_design="encode_v1 (one thread a point, one bit plane a "
             "step)", old_design_ms=main["v1_ms"], sass=sass,
             cases={k: dict(v, bound_ms=max(
                 v["bytes"] / HBM_BYTES_PER_S,
                 v["ops"] / INT_OPS_PER_S) * 1e3)
                 for k, v in cases.items()})
    entries = [e]
    del grids
    for name in ("mbr_count", "mbr_mask"):
        cases = {}
        for inp, (rt, st) in tiles.items():
            r4 = mops.pad_cm(rt, mops.DEFAULT_BR)
            s4 = mops.pad_cm(st, mops.DEFAULT_BS)
            np_, mp = r4.shape[1], s4.shape[1]
            if name == "mbr_count":
                c = compare(name, lambda: mkernel.count(
                    r4, s4, mops.DEFAULT_BR, mops.DEFAULT_BS),
                    lambda: mref.count_cm(r4, s4, mops.DEFAULT_BR,
                                          mops.DEFAULT_BS))
                cells = (np_ // mops.DEFAULT_BR) * (mp // mops.DEFAULT_BS)
                out_bytes = 4 * cells
            else:
                c = compare(name, lambda: mkernel.mask(r4, s4),
                            lambda: mref.mask_cm(r4, s4))
                out_bytes = np_ * mp
            cases[inp] = dict(c, bytes=16 * (np_ + mp) + out_bytes,
                              ops=4 * np_ * mp,
                              shape=dict(live_r=rt.shape[0],
                                         live_s=st.shape[0], n_pad=np_,
                                         m_pad=mp))
        main = cases["pi"]
        e = entry(name, MBR_SOURCE, main, main["bytes"], main["ops"],
                  main["shape"])
        e["cases"] = {
            k: dict(v, bound_ms=max(v["bytes"] / HBM_BYTES_PER_S,
                                    v["ops"] / FP32_OPS_PER_S) * 1e3)
            for k, v in cases.items()}
        entries.append(e)
    for name, method in BATCHED.items():
        cases = {inp: batched_case(torch, name, plans[inp, method],
                                   results[inp, method])
                 for inp in JOIN_INPUTS}
        main = cases["pi"]
        e = entry(name, MBR_SOURCE, main, main["bytes"], main["ops"],
                  main["shape"])
        e.update(old_design=main["old_design"],
                 old_design_ms=main["old_design_ms"],
                 cases={k: dict(v, bound_ms=max(
                     v["bytes"] / HBM_BYTES_PER_S,
                     v["ops"] / FP32_OPS_PER_S) * 1e3)
                     for k, v in cases.items()})
        entries.append(e)
    by_name = {e["name"]: e for e in entries}
    raw, rp = by_name["mbr_raw_counts"], by_name["mbr_rp_counts"]
    raw["rp_counts_ms_same_plans"] = {k: rp["cases"][k]["ms"]
                                      for k in JOIN_INPUTS}
    return entries


def batched_case(torch, name, plan, result):
    """One batched join pass on a whole plan against its plain version
    (bit-equal) and the per-tile table path on the same plan (the same
    counts, or the same pair list) -> its case row: kernel ms (CUDA
    events over 10 launches; the pair list's host read included, its
    stages apart), plain and old ms (host clock), bytes and operations
    of its bound."""
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.mbr_join import ref as mref
    from repro_torch.query import engine

    meta = engine._meta(plan)
    rt, st, rid, sid = (a[0] for a in (plan.r_tiles, plan.s_tiles,
                                       plan.r_ids, plan.s_ids))
    lr, ls = plan.live_r[0], plan.live_s[0]
    live = lr * ls
    tests = int(live.sum())
    box_bytes = 16 * int(lr[live > 0].sum() + ls[live > 0].sum())
    counted = dict(mkernel.LAUNCHES)
    if name == "mbr_rp_counts":
        tb, uni = plan.tile_boxes[0], plan.universe
        k = lambda: mkernel.rp_counts(rt, st, tb, uni, meta)  # noqa: E731
        plain = lambda: mref.tile_rp_counts(rt, st, tb, uni, lr, ls)  # noqa
        got = k()
        want, plain_s = timed_s(torch, plain)
        (_, old), old_s = timed_s(torch, lambda: old_join(torch, plan, False,
                                                          0))
        if not (torch.equal(got, want) and torch.equal(got, old)):
            raise AssertionError(f"{name} differs from its plain version or "
                                 f"the per-tile path")
        out_bytes, stages = 8 * rt.shape[0], {}
        listed = None
    elif name == "mbr_raw_counts":
        k = lambda: mkernel.raw_counts(rt, st, meta)  # noqa: E731
        got = k()
        want, plain_s = timed_s(torch, lambda: mref.tile_raw_counts(
            rt, st, lr, ls))
        old, old_s = timed_s(torch, lambda: old_raw_counts(torch, plan))
        if not (torch.equal(got, want) and torch.equal(got, old)):
            raise AssertionError(f"{name} differs from its plain version or "
                                 f"the per-tile path")
        out_bytes, stages = 8 * rt.shape[0], {}
        listed = None
    else:
        max_pairs = result["max_n"]
        k = lambda: mkernel.pair_list(rt, st, rid, sid, meta,  # noqa: E731
                                      max_pairs)
        got = k()
        want, plain_s = timed_s(torch, lambda: mref.tile_pair_list(
            rt, st, rid, sid, lr, ls, max_pairs))
        (_, old), old_s = timed_s(torch, lambda: old_join(torch, plan, True,
                                                          max_pairs))
        if not (all(torch.equal(g, w) for g, w in zip(got, want))
                and torch.equal(got[0], old[0])
                and torch.equal(got[1], old[1])):
            raise AssertionError(f"{name} differs from its plain version or "
                                 f"the per-tile path")
        listed = int(got[0].shape[0])
        cells = mkernel.pair_row_counts(rt, st, rid, sid, meta)
        stages = dict(
            count_ms=cuda_ms(torch, lambda: mkernel.pair_row_counts(
                rt, st, rid, sid, meta), 10),
            scan_emit_ms=cuda_ms(torch, lambda: mkernel.emit_pairs(
                rt, st, rid, sid, meta, cells, max_pairs), 10))
        out_bytes = PAIR_BYTES * listed
        box_bytes += 4 * int(lr[live > 0].sum() + ls[live > 0].sum())
    ms = cuda_ms(torch, k, 10)
    mkernel.LAUNCHES.update(counted)      # the comparison's launches
    del got, want, old
    old_design = ("per tile: pad_cm and the count kernel's block sums"
                  if name == "mbr_raw_counts" else "per tile: the mask "
                  "table kernel, then rp_own_mask and a sum, or nonzero")
    return dict(ms=ms, plain_ms=plain_s * 1e3, bytes=box_bytes + out_bytes,
                ops=4 * tests, old_design=old_design,
                old_design_ms=old_s * 1e3, **stages,
                shape=dict(tiles=int(rt.shape[0]),
                           live_tiles=int((live > 0).sum()),
                           work_items=meta.items, row_cells=meta.rows,
                           live_tests=tests, pairs=listed,
                           cap_r=int(rt.shape[1]), cap_s=int(st.shape[1])))


def prefill_batch(torch, dev, cfg):
    g = torch.Generator(dev).manual_seed(SEED + 4)
    return {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_L),
                                    generator=g, device=dev)}


def lm_prefill_phase(torch, dev, cfg, model, params):
    """make_prefill_step on PREFILL_B x PREFILL_L tokens -> the SSD
    launches of the timed prefills."""
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.models import api

    step = api.make_prefill_step(model)
    batch = prefill_batch(torch, dev, cfg)
    warm, warm_s = timed_s(torch, lambda: step(params, batch))
    torch.cuda.reset_peak_memory_stats()
    skernel.reset_launches()
    secs = []
    for _ in range(3):
        logits, t = timed_s(torch, lambda: step(params, batch))
        secs.append(t)
    launches = skernel.LAUNCHES["intra_chunk"]
    if skernel.LAUNCHES["intra_chunk_v1"]:
        raise AssertionError("the prefill launched the FFMA SSD kernel")
    peak = torch.cuda.max_memory_allocated()
    if not (logits.shape == (PREFILL_B, cfg.vocab_padded)
            and torch.isfinite(logits[:, :cfg.vocab]).all()
            and bool((logits[:, cfg.vocab:] == -1e9).all())):
        raise AssertionError("prefill logits are not finite, of the wrong "
                             "shape, or the padded vocab is not masked")
    dev_ms, top = device_busy(torch, lambda: step(params, batch), 1)
    wall = median(secs)
    tokens = PREFILL_B * PREFILL_L
    emit(dict(
        phase="lm_prefill", arch=cfg.name, n_params=cfg.n_params(),
        n_layers=cfg.n_layers, batch=PREFILL_B, seq=PREFILL_L,
        dtype=cfg.dtype, seconds=wall, seconds_all=secs, first_s=warm_s,
        tokens_per_s=tokens / wall, max_memory_allocated=peak,
        ssd_launches=launches, ssd_launches_per_prefill=launches / 3,
        device_ms=dev_ms, idle_share=1 - dev_ms / (wall * 1e3),
        top_device=top,
        repeat_max_abs_diff=float((logits - warm).abs().max()),
        model_flops=2 * cfg.n_params() * tokens,
        model_flops_bound_s=2 * cfg.n_params() * tokens / BF16_FLOPS_PER_S))
    if launches != 3 * cfg.n_layers:
        raise AssertionError(f"the SSD kernel launched {launches} times in "
                             f"3 prefills of {cfg.n_layers} layers")
    return launches


def prefill_layer0_inputs(torch, dev, cfg, model, params):
    """One more prefill of the same batch, keeping layer 0's SSD inputs
    (run after the timed phases, so their peaks do not hold them)."""
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.models import api

    step = api.make_prefill_step(model)
    captured = []
    launch = skernel.intra_chunk

    def capture(*args):
        if not captured:
            captured.append(args)
        return launch(*args)

    skernel.intra_chunk = capture
    try:
        step(params, prefill_batch(torch, dev, cfg))
    finally:
        skernel.intra_chunk = launch
    return captured[0]


def lm_decode_phase(torch, dev, cfg, model, params):
    """The serve launcher's greedy loop at DECODE_B -> tokens/s."""
    from repro_torch.kernels.ssd import kernel as skernel

    skernel.reset_launches()
    out, wall, step_ms = greedy_run(torch, dev, cfg, model, params,
                                    DECODE_B, DECODE_PROMPT, DECODE_GEN,
                                    SEED + 5)
    dev_ms, top, _ = decode_profile(torch, model, params, out[:, 0])
    p50 = pct(step_ms, 0.5)
    emit(dict(
        phase="lm_decode", arch=cfg.name, batch=DECODE_B,
        prompt=DECODE_PROMPT, gen=DECODE_GEN, steps=len(step_ms),
        seconds=wall, tokens_per_s=DECODE_B * DECODE_GEN / wall,
        p50_step_ms=p50, p99_step_ms=pct(step_ms, 0.99),
        device_ms_per_step=dev_ms, idle_share=1 - dev_ms / p50,
        top_device=top, ssd_launches=skernel.LAUNCHES["intra_chunk"],
        state_bytes=cfg.n_layers * DECODE_B * cfg.ssm_heads * cfg.ssm_state
        * cfg.ssm_head_dim * 4,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        sample=out[0, :16].tolist()))


def ssd_plain_blocked(torch, sref, x, dt, cl, b, c, chunk, rows=64):
    """The plain version over the whole input, in blocks of ``rows``
    chunks (its (B, nc, H, Q, Q) tables would be 17 GB at once)."""
    bs, l, h, p = x.shape
    out = torch.empty_like(x)
    step = rows * chunk
    for bi in range(bs):
        for t in range(0, l, step):
            sl = (slice(bi, bi + 1), slice(t, t + step))
            out[sl] = sref.intra_chunk_grouped(x[sl], dt[sl], cl[sl], b[sl],
                                               c[sl], chunk)
    return out


def ssd_inputs_random(torch, dev, bs, l, h, p, g, s, chunk):
    """tests/test_kernels_ssd.py's distributions, on the card."""
    gen = torch.Generator(dev).manual_seed(SEED + 6)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(bs, l, h, p)
    dt = torch.nn.functional.softplus(normal(bs, l, h)) * 0.1
    cl = torch.cumsum((-dt * 0.5).reshape(bs, l // chunk, chunk, h),
                      2).reshape(bs, l, h)
    return x, dt, cl, normal(bs, l, g, s) * 0.3, normal(bs, l, g, s) * 0.3


def ssd_bound(x, b, chunk):
    """Least bytes (inputs read once, y written once) and operations
    (causal G once per (batch, chunk, group), causal M . X per head, and
    four operations per causal element of M) of one launch."""
    bs, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    nc = l // chunk
    tri = chunk * (chunk + 1) // 2
    bytes_ = 4 * (2 * bs * l * h * p + 2 * bs * l * h + 2 * bs * l * g * s)
    flops = (bs * nc * g * tri * 2 * s + bs * nc * h * tri * 2 * p
             + bs * nc * h * tri * 4)
    return bytes_, flops


def lm_check_phase(torch, dev, cfg, model, params, launches):
    """Kernel against plain, float32 prefill against decode, and the
    launch count -> the SSD kernel's row."""
    import dataclasses
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.kernels.ssd import ref as sref

    chunk = 128
    layer0 = prefill_layer0_inputs(torch, dev, cfg, model, params)
    sets = {"layer0": layer0[:5]}
    x0 = layer0[0]
    sets["random"] = ssd_inputs_random(
        torch, dev, 1, 8192, x0.shape[2], x0.shape[3], layer0[3].shape[2],
        layer0[3].shape[3], chunk)
    cases = {}
    for name, args in sets.items():
        with torch.no_grad():
            got = skernel.intra_chunk(*args, chunk)
            got_v1 = skernel.intra_chunk_v1(*args, chunk)
            want, plain_s = timed_s(torch, lambda: ssd_plain_blocked(
                torch, sref, *args, chunk))
        err = (got - want).abs()
        ok = bool((err <= SSD_TOL + SSD_TOL * want.abs()).all())
        ms, ms_v1 = [], []
        for _ in range(2):                     # in turns: new, old, ...
            ms.append(cuda_ms(torch, lambda: skernel.intra_chunk(
                *args, chunk), 10))
            ms_v1.append(cuda_ms(torch, lambda: skernel.intra_chunk_v1(
                *args, chunk), 10))
        cases[name] = dict(max_abs_err=float(err.max()), ok=ok,
                           max_abs=float(want.abs().max()),
                           max_abs_err_v1=float((got_v1 - want).abs().max()),
                           plain_ms=plain_s * 1e3, ms=min(ms), ms_all=ms,
                           v1_ms=min(ms_v1), v1_ms_all=ms_v1,
                           shape=list(args[0].shape),
                           inputs={k: dict(std=float(a.std()),
                                           max_abs=float(a.abs().max()))
                                   for k, a in zip(("x", "dt", "cl", "b",
                                                    "c"), args)})
        del got, got_v1, want, err
        if not ok:
            raise AssertionError(f"SSD kernel ({name}) differs from its "
                                 f"plain version beyond {SSD_TOL}: "
                                 f"{cases[name]}")
    bytes_, flops = ssd_bound(x0, layer0[3], chunk)
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_OPS_PER_S * 1e3
    del sets, layer0, x0
    torch.cuda.empty_cache()

    # float32 prefill through the kernel against decode through the
    # recurrence, at full width and depth
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(dev).manual_seed(SEED + 7)
    toks = torch.randint(0, cfg.vocab, (CHECK_B, CHECK_L), generator=g,
                         device=dev)
    forward, init_cache, decode_step = lm_check_fns(torch, cfg32, dev)
    tf_launches = []

    def counted_forward(p, b):
        out = forward(p, b)
        tf_launches.append(skernel.LAUNCHES["intra_chunk"])
        return out

    skernel.reset_launches()
    check = decode_vs_forward(torch, cfg32, params, {"tokens": toks},
                              counted_forward, init_cache, decode_step)
    decode_launches = skernel.LAUNCHES["intra_chunk"] - tf_launches[0]
    emit(dict(phase="lm_check", prefill_vs_decode=dict(
        check, prefill_ssd_launches=tf_launches[0],
        decode_ssd_launches=decode_launches),
        ssd_kernel_cases=cases, main_path_ssd_launches=launches))
    if not (check["ok"] and tf_launches[0] == cfg.n_layers
            and decode_launches == 0):
        raise AssertionError(f"float32 prefill and decode disagree, or the "
                             f"kernel was launched off its path: {check}")
    main = cases["layer0"]
    return dict(
        name="ssd_intra_chunk", route="cuda", source=SSD_SOURCE,
        replaces=SSD_TPU, launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=max(b_ms, o_ms),
        bound_by="bytes" if b_ms >= o_ms else "operations",
        library_ms=None, tolerance=SSD_TOL,
        old_design="ssd_intra_chunk_v1 (scalar FFMA, one block an SM)",
        old_design_ms=main["v1_ms"],
        launches_per_prefill=launches // 3, bytes=bytes_, flops=flops,
        shape=dict(zip("blhp", main["shape"]), q=chunk), cases=cases)

def lm_train_phase(torch, dev):
    """``launch/train.main`` on the published configuration at TRAIN_B x
    TRAIN_L, remat "full", the AdamW defaults, a failure injected at step
    TRAIN_FAIL_AT -> (the SSD launches of the run, its launches a step,
    layer 0's SSD inputs of the first step's batch)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.data import tokens as data_tokens
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.kernels.ssd import ref as sref
    from repro_torch.launch import train
    from repro_torch.models import api

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get(LM_ARCH)
    stamps, seen, counts = [], [], []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(i, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        seen.append(metrics)
        counts.append(skernel.LAUNCHES["intra_chunk"])
        if i == TRAIN_STEPS - 1:
            prof.__enter__()
        elif i == TRAIN_STEPS:
            prof.__exit__(None, None, None)

    ckpt = tempfile.mkdtemp(prefix="lm_train_")
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skernel.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = train.main([
                "--arch", LM_ARCH, "--batch", str(TRAIN_B), "--seq",
                str(TRAIN_L), "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckpt,
                "--ckpt-every", str(TRAIN_STEPS + 1), "--inject-failure-at",
                str(TRAIN_FAIL_AT), "--log-every", "1", "--device",
                str(dev)], on_step=on_step)
    except BaseException:
        sys.stderr.write(out.getvalue())
        raise
    finally:
        written = os.listdir(ckpt)
        shutil.rmtree(ckpt)
    wall = time.perf_counter() - t0
    launches = skernel.LAUNCHES["intra_chunk"]
    v1 = skernel.LAUNCHES["intra_chunk_v1"]
    peak = torch.cuda.max_memory_allocated()
    lines = out.getvalue().splitlines()
    done = re.search(r"restarts=(\d+)", lines[-1])
    per_step = [b - a for a, b in zip([0] + counts, counts)]
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    timed = step_s[TRAIN_WARM - 1:TRAIN_WARM - 1 + TRAIN_TIMED]
    prof_s = step_s[-1]
    dev_ms, top = device_items(prof, 1, top=12)
    med = median(timed)
    tokens = TRAIN_B * TRAIN_L

    # the first step's loss again, forward only, through the kernel and
    # through the plain intra-chunk, on the launcher's initial weights
    # and first batch; layer 0's SSD inputs are kept for lm_train_check
    model = api.build(cfg, dev)
    params = model.init_params(torch.Generator(dev).manual_seed(0))
    batch = data_tokens.batch_for_step(data_tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_L, global_batch=TRAIN_B), 0, dev)
    captured = []
    launch = skernel.intra_chunk

    def capture(*args):
        if not captured:
            captured.append(args[:5])
        return launch(*args)

    losses = {}
    try:
        with torch.no_grad():
            skernel.intra_chunk = capture
            losses["kernel"] = float(model.loss_fn(params, batch, "none")[0])
            skernel.intra_chunk = sref.intra_chunk_grouped   # no launch
            losses["plain"] = float(model.loss_fn(params, batch, "none")[0])
    finally:
        skernel.intra_chunk = launch
    breakdown = train_breakdown(torch, dev, cfg, params, batch, captured[0])
    del params, model, batch
    torch.cuda.empty_cache()

    first, last = seen[0], seen[-1]
    emit(dict(
        phase="lm_train", arch=cfg.name, n_params=cfg.n_params(),
        n_layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_L, dtype=cfg.dtype,
        remat="full", steps=len(seen), warm_steps=TRAIN_WARM,
        timed_steps=TRAIN_TIMED, step_s=med, step_s_timed=timed,
        step_s_all=step_s, tokens_per_s=tokens / med,
        max_memory_allocated=peak, seconds=wall,
        ssd_launches=launches, ssd_launches_per_step=per_step,
        ssd_v1_launches=v1, profiled_step_s=prof_s, device_ms=dev_ms,
        idle_share=1 - dev_ms / (med * 1e3), top_device=top,
        top_ops=top_ops(prof), breakdown_ms=breakdown,
        first_loss=first["loss"], last_loss=last["loss"],
        losses=[m["loss"] for m in seen],
        grad_norms=[m["grad_norm"] for m in seen],
        lrs=[m["lr"] for m in seen],
        restarts=int(done.group(1)) if done else None,
        checkpoints_written=written,
        first_loss_forward_kernel=losses["kernel"],
        first_loss_forward_kernel_equal=losses["kernel"] == first["loss"],
        first_loss_forward_plain=losses["plain"],
        first_loss_plain_gap=losses["kernel"] - losses["plain"],
        model_flops_per_step=8 * cfg.n_params() * tokens,
        model_flops_bound_s=8 * cfg.n_params() * tokens / BF16_FLOPS_PER_S,
        launcher=lines[-3:]))
    if rc != 0 or not done or int(done.group(1)) != 1:
        raise AssertionError(f"the launcher returned {rc} or did not "
                             f"restart once: {lines[-1:]}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in seen):
        raise AssertionError("a training loss or grad_norm is not finite")
    if len(seen) != TRAIN_STEPS or written:
        raise AssertionError(f"{len(seen)} steps ran, checkpoints {written}")
    if per_step != [2 * cfg.n_layers] * TRAIN_STEPS or v1:
        raise AssertionError(f"the SSD kernel launched {per_step} times a "
                             f"step (and the FFMA design {v1} times)")
    return launches, 2 * cfg.n_layers, captured[0]


def top_ops(prof, n: int = 15):
    """The profile's operators by the device time of the kernels they
    launch themselves (autograd's backward nodes apart), in ms."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return [[k[:60], ms, c] for k, ms, c in rows[:n]]


def train_breakdown(torch, dev, cfg, params, batch, layer0):
    """CUDA-event ms of the training step's parts at its shapes: one
    layer's forward and backward under remat "full" (the recompute
    included), the SSD block's (``ssd_forward``) and the intra-chunk
    block's within it (the kernel forward and the plain backward), the
    head (final norm, unembed, loss), and the AdamW update of every
    parameter.  A step is about ``n_layers`` layers, the head and the
    update."""
    from torch.utils import checkpoint as ckpt
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.models import blocks, layers, lm
    from repro_torch.optim import adamw

    params.requires_grad_(True)
    g = torch.Generator(dev).manual_seed(SEED + 10)
    h = (torch.randn((TRAIN_B, TRAIN_L, cfg.d_model), generator=g,
                     device=dev).to(torch.bfloat16).requires_grad_(True))
    blk = params.blocks[0]
    wrt = [h] + list(blk.parameters())

    def layer():
        y, _ = ckpt.checkpoint(blocks.apply_block, h, blk, cfg, "ssm",
                               None, use_reentrant=False)
        torch.autograd.grad(y, wrt, torch.ones_like(y))

    def head():
        x = layers.rms_norm(h, params.final_norm, cfg.norm_eps)
        loss = lm.nll(lm._logits_of(x, params, cfg), batch["tokens"])
        torch.autograd.grad(loss, [h, params.final_norm, params.embed])

    x, dt, cl, b, c = layer0
    a_log = torch.full((x.shape[2],), -1.0, device=dev)
    ins = [t.detach().clone().requires_grad_(True)
           for t in (x, dt, a_log, b, c)]
    gy = torch.ones_like(x)

    def ssd():
        torch.autograd.grad(sops.ssd_forward(*ins), ins, gy)

    intra = [t.detach().clone().requires_grad_(True)
             for t in (x, dt, cl, b, c)]

    def intra_chunk():
        torch.autograd.grad(sops.IntraChunk.apply(*intra, 128), intra, gy)

    out = {k: cuda_ms(torch, fn, 3) for k, fn in (
        ("layer_fwd_bwd", layer), ("ssd_fwd_bwd", ssd),
        ("intra_chunk_fwd_bwd", intra_chunk), ("head_fwd_bwd", head))}
    with torch.no_grad():
        out["intra_chunk_fwd"] = cuda_ms(
            torch, lambda: sops.IntraChunk.apply(*intra, 128), 3)
    del h, wrt, ins, intra, gy
    named = lm.named_leaves(params, cfg)
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init_state(named, opt_cfg)
    grads = {k: torch.randn(p.shape, generator=g, device=dev) * 1e-3
             for k, p in named.items()}
    nd = lm.ref_ndims(named, cfg)
    out["adamw_update"] = cuda_ms(torch, lambda: adamw.update(
        grads, state, named, opt_cfg, nd), 3)
    del grads, state
    params.requires_grad_(False)
    out["layers_x_n"] = out["layer_fwd_bwd"] * cfg.n_layers
    return out


def ssd_grads(torch, fn, ins, gy):
    """fn's output and its input gradients against ``gy``."""
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    y = fn(*ins)
    return y.detach(), torch.autograd.grad(y, ins, gy)


def train_state(torch, dev, cfg, opt, seed=SEED):
    from repro_torch.models import api
    return api.init_train_state(api.build(cfg, dev),
                                torch.Generator(dev).manual_seed(seed), opt)


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms where it has them (the embedding
    gradient's scatter-add among them), warning where it has none: yields
    the list of those warnings.  torch asks for a cuBLAS workspace
    setting first."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    found: list[str] = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield found
        found += sorted({str(w.message)[:120] for w in caught
                         if "determinis" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)


def ft_check(torch, dev, cfg):
    """(b): FT_STEPS steps with a checkpoint every FT_EVERY and a failure
    at FT_FAIL_AT against an uninterrupted run, under deterministic
    algorithms."""
    from repro_torch.data import tokens as data_tokens
    from repro_torch.ft.runtime import FTConfig, run_loop
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig(total_steps=FT_STEPS, warmup=0)
    step_fn = api.make_train_step(api.build(cfg, dev), opt)
    pipe = data_tokens.TokenPipelineConfig(vocab=cfg.vocab, seq_len=FT_L,
                                           global_batch=FT_B)
    runs, written = {}, {}
    with deterministic(torch) as nondeterministic:
        for name, fail in (("uninterrupted", None), ("restarted",
                                                     FT_FAIL_AT)):
            d = tempfile.mkdtemp(prefix="lm_ft_")
            try:
                runs[name] = run_loop(
                    lambda st, i: step_fn(st, data_tokens.batch_for_step(
                        pipe, i, dev)), train_state(torch, dev, cfg, opt),
                    list(range(FT_STEPS)), FTConfig(
                        ckpt_dir=d, ckpt_every=FT_EVERY if fail else
                        FT_STEPS + 1), inject_failure_at=fail)
                written[name] = {
                    sub: sum(f.stat().st_size for f in (Path(d) / sub)
                             .iterdir()) for sub in sorted(os.listdir(d))}
            finally:
                shutil.rmtree(d)
    (want, _, info0), (got, _, info) = runs["uninterrupted"], runs[
        "restarted"]
    diff = {"params": 0.0, "m": 0.0, "v": 0.0}
    equal = int(got.step) == int(want.step) == FT_STEPS
    for (ka, a), (kb, b) in zip(want.params.named_parameters(),
                                got.params.named_parameters()):
        equal &= ka == kb and torch.equal(a, b)
        diff["params"] = max(diff["params"],
                             float((a - b).detach().abs().max()))
    for k in want.opt.m:
        for part in ("m", "v"):
            a, b = getattr(want.opt, part)[k], getattr(got.opt, part)[k]
            equal &= torch.equal(a, b)
            diff[part] = max(diff[part], float((a - b).abs().max()))
    return dict(layers=cfg.n_layers, batch=FT_B, seq=FT_L, steps=FT_STEPS,
                ckpt_every=FT_EVERY, fail_at=FT_FAIL_AT,
                restarts=[info0["restarts"], info["restarts"]],
                bytes_written=written, bit_equal=equal, max_abs_diff=diff,
                deterministic_algorithms=True,
                nondeterministic_ops=nondeterministic)


def remat_check(torch, dev, cfg):
    """(c): float32, one train step with remat "full" against "none":
    the loss and every gradient bit for bit, then the step's metrics and
    new parameters, under deterministic algorithms (the embedding
    gradient's scatter-add is not deterministic otherwise)."""
    from repro_torch.models import api, lm
    from repro_torch.optim.adamw import AdamWConfig

    opt = AdamWConfig()
    toks = torch.randint(0, cfg.vocab, (REMAT_B, REMAT_L), device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED + 8))
    grads, steps = {}, {}
    with deterministic(torch) as nondeterministic:
        for remat in ("none", "full"):
            state = train_state(torch, dev, cfg, opt)
            named = lm.named_leaves(state.params, cfg)
            loss, _ = lm.loss_fn(state.params, {"tokens": toks}, cfg, remat)
            grads[remat] = (loss.detach(), torch.autograd.grad(
                loss, list(named.values())))
            state, metrics = api.make_train_step(
                api.build(cfg, dev), opt, remat=remat)(state,
                                                       {"tokens": toks})
            steps[remat] = (metrics, [p.detach() for p in
                                      state.params.parameters()])
    (l0, g0), (l1, g1) = grads["none"], grads["full"]
    (m0, p0), (m1, p1) = steps["none"], steps["full"]
    equal = (torch.equal(l0, l1) and all(map(torch.equal, g0, g1))
             and all(torch.equal(m0[k], m1[k]) for k in m0)
             and all(map(torch.equal, p0, p1)))
    return dict(dtype=cfg.dtype, layers=cfg.n_layers, batch=REMAT_B,
                seq=REMAT_L, loss=float(l0), bit_equal=equal,
                nondeterministic_ops=nondeterministic,
                max_grad_diff=max(float((a - b).abs().max())
                                  for a, b in zip(g0, g1)))


def lm_train_check_phase(torch, dev, layer0):
    """(a) IntraChunk against the plain version, forward and backward;
    (b) a restart from a checkpoint against an uninterrupted run; (c)
    remat "full" against "none"."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd import ref as sref

    chunk = 128
    x0 = layer0[0]
    sets = {"layer0": layer0, "random": ssd_inputs_random(
        torch, dev, 1, 8192, x0.shape[2], x0.shape[3], layer0[3].shape[2],
        layer0[3].shape[3], chunk)}
    cases, ok = {}, True
    for name, ins in sets.items():
        gy = torch.randn(ins[0].shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED + 9))
        skernel.reset_launches()
        y, got = ssd_grads(torch, lambda *t: sops.IntraChunk.apply(
            *t, chunk), ins, gy)
        launched = skernel.LAUNCHES["intra_chunk"]
        y_plain, want = ssd_grads(torch, lambda *t: sref.intra_chunk_grouped(
            *t, chunk), ins, gy)
        bwd_ms = cuda_ms(torch, lambda: ssd_grads(
            torch, lambda *t: sops.IntraChunk.apply(*t, chunk), ins, gy), 3)
        err = (y - y_plain).abs()
        fwd_ok = bool((err <= SSD_TOL + SSD_TOL * y_plain.abs()).all())
        bits = all(map(torch.equal, got, want))
        cases[name] = dict(
            shape=list(ins[0].shape), launches=launched,
            forward_max_abs_err=float(err.max()), forward_ok=fwd_ok,
            grads_bit_equal=bits, forward_backward_ms=bwd_ms,
            grad_max_abs=[float(g.abs().max()) for g in want],
            grads_finite=all(bool(torch.isfinite(g).all()) for g in got))
        ok &= fwd_ok and bits and launched == 1 and cases[name][
            "grads_finite"]
        del y, got, y_plain, want, err
    del sets, layer0, x0
    torch.cuda.empty_cache()

    full = configs.get(LM_ARCH)
    ft = ft_check(torch, dev, dataclasses.replace(full, n_layers=FT_LAYERS))
    torch.cuda.empty_cache()
    remat = remat_check(torch, dev, dataclasses.replace(
        full, n_layers=FT_LAYERS, dtype="float32"))
    torch.cuda.empty_cache()
    emit(dict(phase="lm_train_check", intra_chunk=cases, ft_restart=ft,
              remat=remat))
    if not ok:
        raise AssertionError(f"IntraChunk differs from the plain version: "
                             f"{cases}")
    if not (ft["bit_equal"] and ft["restarts"] == [0, 1]):
        raise AssertionError(f"the restarted run differs from the "
                             f"uninterrupted one: {ft}")
    if not remat["bit_equal"]:
        raise AssertionError(f"remat full and none differ: {remat}")


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` prints them
    (printed beside every number of the families' phases: a card set
    below 700 W runs slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_modules():
    """(row-name prefix, module) of each kernel source's wrappers."""
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.kernels.ssd import kernel as skernel

    return (("", kernel), ("hilbert_", hkernel), ("mbr_", mkernel),
            ("ssd_", skernel))


def kernel_launches():
    """Every kernel wrapper's launch count, keyed by the kernel rows'
    names."""
    return {prefix + k: v for prefix, mod in kernel_modules()
            for k, v in mod.LAUNCHES.items()}


def reset_kernel_launches():
    for _, mod in kernel_modules():
        mod.reset_launches()


def no_kernel_launched(phase):
    """The families' paths run no hand-written kernel (their attention,
    MoE, RG-LRU and encoder-decoder code has no Pallas in the
    reference): every count must still be 0."""
    counts = kernel_launches()
    if any(counts.values()):
        raise AssertionError(f"{phase} launched a kernel: {counts}")
    return counts


def checker_phase(torch):
    """Phase 0: the port's hazard checker (``repro_torch.analysis``)
    over the checkout's port tree, as ``python -m repro_torch.analysis
    repro_torch`` runs it -> its report's counts.  It reads the sources
    and calls the range probe's plain twins on small CPU tensors: a
    build of any kernel source raises here, and every launch count must
    still be 0 after it.  Fails on any finding."""
    from repro_torch.analysis import api
    from repro_torch.kernels import cuda_build

    def no_build(sources):
        raise AssertionError(f"the checker built a kernel: {sources}")

    reset_kernel_launches()
    build_all, cuda_build.build_all = cuda_build.build_all, no_build
    t0 = time.perf_counter()
    try:
        report = api.run(PORT / "repro_torch",
                         baseline=PORT / "repro_torch" / "analysis"
                         / "baseline.json")
    finally:
        cuda_build.build_all = build_all
    seconds = time.perf_counter() - t0
    launches = sum(kernel_launches().values())
    by_rule = {rid: sum(f.rule == rid for f in report.findings)
               for rid in api.RULE_IDS}
    emit(dict(phase="checker", seconds=seconds, findings=by_rule,
              counts=report.to_json()["counts"], kernel_launches=launches,
              card=card_line()))
    if report.findings or launches:
        raise AssertionError(
            "the hazard checker found: " + "; ".join(
                f.render() for f in report.findings)
            + f" (kernel launches {launches})")
    return seconds


def cut_depth(cfg, n_layers):
    """``cfg`` at ``n_layers`` layers (the encoder-decoder's encoder
    too); None leaves it whole."""
    import dataclasses
    if n_layers is None:
        return cfg
    kw = dict(n_layers=n_layers)
    if cfg.family == "encdec":
        kw["enc_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def family_model(torch, dev, arch, n_layers=None):
    """The published configuration of ``arch`` at full width (depth cut
    to ``n_layers``), random float32 weights from a seeded generator on
    the card, TF32 off."""
    from repro_torch import configs
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = cut_depth(configs.get(arch), n_layers)
    model = api.build(cfg, dev)
    params = model.init_params(torch.Generator(dev).manual_seed(SEED))
    return cfg, model, params


def family_batch(torch, dev, cfg, b, l, seed, dtype=None):
    """Seeded tokens, and the vlm's image tokens or the encdec's frames
    (bf16 as the reference's launcher makes them, unless ``dtype``)."""
    g = torch.Generator(dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, l), generator=g,
                                     device=dev)}
    dtype = dtype or torch.bfloat16
    if cfg.family == "vlm":
        batch["img"] = torch.randn((b, cfg.vis_tokens, cfg.vis_dim),
                                   generator=g, device=dev).to(dtype)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.src_len, cfg.d_model),
                                      generator=g, device=dev).to(dtype)
    return batch


def logits_ok(torch, logits, cfg):
    return (bool(torch.isfinite(logits[..., :cfg.vocab]).all())
            and bool((logits[..., cfg.vocab:] == -1e9).all()))


def fam_prefill_phase(torch, dev, cfg, model, params):
    """make_prefill_step on 1 x FAM_L tokens (cut to FAM_L_CUT if the
    warm run takes more than FAM_CUT_S seconds)."""
    from repro_torch.models import api

    step = api.make_prefill_step(model)
    seq, cut = FAM_L, None
    batch = family_batch(torch, dev, cfg, 1, seq, SEED + 20)
    reset_kernel_launches()
    warm, warm_s = timed_s(torch, lambda: step(params, batch))
    if warm_s > FAM_CUT_S:
        cut = (f"L {FAM_L} -> {FAM_L_CUT}: the warm run took {warm_s:.1f} s"
               f" (> {FAM_CUT_S} s)")
        seq = FAM_L_CUT
        batch = family_batch(torch, dev, cfg, 1, seq, SEED + 20)
        warm, warm_s = timed_s(torch, lambda: step(params, batch))
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        logits, t = timed_s(torch, lambda: step(params, batch))
        secs.append(t)
    peak = torch.cuda.max_memory_allocated()
    if not (logits.shape == (1, cfg.vocab_padded)
            and logits_ok(torch, logits, cfg)):
        raise AssertionError("fam_prefill logits are not finite, of the "
                             "wrong shape, or the padded vocab is not "
                             "masked")
    dev_ms, top, ops = device_ops(torch, lambda: step(params, batch), 1)
    counts = no_kernel_launched("fam_prefill")
    wall = median(secs)
    emit(dict(
        phase="fam_prefill", card=card_line(), arch=cfg.name,
        n_params=cfg.n_params(),
        n_layers=cfg.n_layers, kinds=cfg.pattern, batch=1, seq=seq,
        cut=cut, dtype=cfg.dtype, seconds=wall, seconds_all=secs,
        first_s=warm_s, tokens_per_s=seq / wall, max_memory_allocated=peak,
        device_ms=dev_ms, idle_share=1 - dev_ms / (wall * 1e3),
        top_device=top, top_ops=ops,
        repeat_max_abs_diff=float((logits - warm).abs().max()),
        model_flops=2 * cfg.n_params() * seq,
        model_flops_bound_s=2 * cfg.n_params() * seq / BF16_FLOPS_PER_S,
        kernel_launches=sum(counts.values())))
    return counts


def greedy_run(torch, dev, cfg, model, params, b, prompt_len, gen, seed):
    """``launch/serve.py``'s ``generate`` at batch ``b``, each step
    synchronised -> (tokens, wall s, step ms)."""
    from repro_torch.launch import serve

    batch = family_batch(torch, dev, cfg, b, prompt_len, seed)
    frames = batch.get("frames")
    serve.generate(model, params, batch["tokens"][:, :2], 2,
                   frames=frames)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]

    def on_step(_pos):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    out = serve.generate(model, params, batch["tokens"], gen, on_step,
                         frames=frames)
    if not (out.shape == (b, gen)
            and bool(((out >= 0) & (out < cfg.vocab)).all())):
        raise AssertionError(f"{cfg.name}: decode produced tokens out of "
                             f"the vocab")
    return out, stamps[-1] - stamps[0], [
        (y - x) * 1e3 for x, y in zip(stamps, stamps[1:])]


def decode_profile(torch, model, params, tok, frames=None):
    """Device ms of a serve step (3 profiled, at position 0 of a fresh
    cache of 4), its largest kernels and operators."""
    from repro_torch.models import api, encdec

    serve_step = api.make_serve_step(model)
    if model.cfg.family == "encdec":
        with torch.no_grad():
            cache = encdec.init_cache(params, frames, model.cfg, 4)
    else:
        cache = model.init_cache(tok.shape[0], 4)
    tok = tok.contiguous()
    return device_ops(torch, lambda: serve_step(params, cache, tok, 0), 3)


def fam_decode_phase(torch, dev, cfg, model, params):
    """``launch/serve.py``'s greedy loop at DECODE_B, DECODE_PROMPT,
    DECODE_GEN (Mamba2's ``lm_decode`` shape)."""
    reset_kernel_launches()
    out, wall, step_ms = greedy_run(torch, dev, cfg, model, params,
                                    DECODE_B, DECODE_PROMPT, DECODE_GEN,
                                    SEED + 21)
    dev_ms, top, ops = decode_profile(torch, model, params, out[:, 0])
    counts = no_kernel_launched("fam_decode")
    p50 = pct(step_ms, 0.5)
    emit(dict(
        phase="fam_decode", card=card_line(), arch=cfg.name, batch=DECODE_B,
        prompt=DECODE_PROMPT, gen=DECODE_GEN, steps=len(step_ms),
        seconds=wall, tokens_per_s=DECODE_B * DECODE_GEN / wall,
        p50_step_ms=p50, p99_step_ms=pct(step_ms, 0.99),
        device_ms_per_step=dev_ms, idle_share=1 - dev_ms / p50,
        top_device=top, top_ops=ops,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        sample=out[0, :16].tolist(), kernel_launches=sum(counts.values())))
    return counts


def decode_vs_forward(torch, cfg, params, batch, forward, init_cache,
                      decode_step):
    """float32 teacher-forced logits against one ``decode_step`` a
    position -> the largest gaps, and the tokens that flip where the
    top-two margin exceeds twice the tolerance."""
    toks = batch["tokens"]
    b, n = toks.shape
    with torch.no_grad():
        tf = forward(params, batch)
        cache = init_cache(params, batch, n)
        err, rel, undecided, flipped, within = 0.0, 0.0, 0, 0, True
        for pos in range(n):
            logits, cache = decode_step(params, cache, toks[:, pos], pos)
            want = tf[:, pos, :cfg.vocab]
            d = (logits[:, :cfg.vocab] - want).abs()
            err = max(err, float(d.max()))
            rel = max(rel, float((d / (want.abs() + 1e-30)).max()))
            within &= bool((d <= LM_TOL + LM_TOL * want.abs()).all())
            top2 = torch.topk(want, 2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 * LM_TOL
            undecided += int((~decided).sum())
            flipped += int((decided & (logits[:, :cfg.vocab].argmax(-1)
                                       != want.argmax(-1))).sum())
    finite = bool(torch.isfinite(tf[..., :cfg.vocab]).all())
    return dict(dtype="float32", batch=b, seq=n, max_abs_err=err,
                max_rel_err=rel, tolerance=LM_TOL, within_tolerance=within,
                undecided_positions=undecided, flipped_tokens=flipped,
                finite=finite, ok=within and finite and flipped == 0)


def lm_check_fns(torch, cfg, dev):
    """(forward, init_cache, decode_step) of a decoder-only model, in the
    shape ``decode_vs_forward`` takes."""
    from repro_torch.models import lm

    return (lambda p, b: lm.forward(p, b["tokens"], cfg)[0],
            lambda p, b, n: lm.init_cache(cfg, len(b["tokens"]), n, dev),
            lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg))


def encdec_check_fns(torch, cfg, dev):
    from repro_torch.models import encdec

    return (lambda p, b: encdec.forward(p, b["frames"], b["tokens"],
                                        cfg)[0],
            lambda p, b, n: encdec.init_cache(p, b["frames"], cfg, n),
            lambda p, c, t, pos: encdec.decode_step(p, c, t, pos, cfg))


def fam_check_phase(torch, dev, cfg, params):
    """(a) full depth at L = FAM_CHECK_L and (b) one super-block at L =
    FAM_WRAP_L, float32, decode against teacher forcing."""
    import dataclasses
    from repro_torch.models import lm

    reset_kernel_launches()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    a = decode_vs_forward(
        torch, cfg32, params,
        family_batch(torch, dev, cfg32, 2, FAM_CHECK_L, SEED + 22),
        *lm_check_fns(torch, cfg32, dev))
    pat = cfg.pattern
    cfg_b = dataclasses.replace(cfg32, n_layers=len(pat))
    one = lm.LM(params.embed, params.final_norm,
                list(params.blocks[:len(pat)]), params.unembed)
    b = decode_vs_forward(
        torch, cfg_b, one,
        family_batch(torch, dev, cfg_b, 2, FAM_WRAP_L, SEED + 23),
        *lm_check_fns(torch, cfg_b, dev))
    b.update(kinds=list(pat), ring=min(FAM_WRAP_L, cfg.local_window),
             reference_nan_from=cfg.local_window + 511)
    counts = no_kernel_launched("fam_check")
    emit(dict(phase="fam_check", card=card_line(), arch=cfg.name, full_depth=a,
              one_super_block=b, kernel_launches=sum(counts.values())))
    for name, r in (("full depth", a), ("one super-block", b)):
        if not r["ok"]:
            raise AssertionError(f"fam_check ({name}): float32 prefill and "
                                 f"decode disagree: {r}")
    return counts


def family_phase(torch, dev, arch, layers_run):
    """One family at full width: bf16 prefill, greedy decode, float32
    decode against teacher forcing -> its JSON row."""
    import dataclasses
    from repro_torch.models import api

    cfg, model, params = family_model(torch, dev, arch, layers_run)
    step = api.make_prefill_step(model)
    seq = WHISPER_L if cfg.family == "encdec" else FAMILY_L
    batch = family_batch(torch, dev, cfg, 1, seq, SEED + 30)
    torch.cuda.reset_peak_memory_stats()
    _, warm_s = timed_s(torch, lambda: step(params, batch))
    logits, secs = timed_s(torch, lambda: step(params, batch))
    peak = torch.cuda.max_memory_allocated()
    if not (logits.shape == (1, cfg.vocab_padded)
            and logits_ok(torch, logits, cfg)):
        raise AssertionError(f"{arch}: prefill logits are not finite, of "
                             f"the wrong shape, or not masked")
    b, prompt_len, gen = FAMILY_DECODE
    out, wall, step_ms = greedy_run(torch, dev, cfg, model, params, b,
                                    prompt_len, gen, SEED + 31)
    frames = family_batch(torch, dev, cfg, b, 1, SEED + 31).get("frames")
    dev_ms, top, _ = decode_profile(torch, model, params, out[:, 0], frames)
    p50 = pct(step_ms, 0.5)
    # a decode step routes FAMILY_CHECK_B tokens: at a capacity factor of
    # at least the expert count no step drops a choice the forward keeps
    cf = max(16.0, cfg.n_experts) if cfg.n_experts else cfg.capacity_factor
    cfg32 = dataclasses.replace(cfg, dtype="float32", capacity_factor=cf)
    fns = (encdec_check_fns if cfg.family == "encdec" else lm_check_fns)(
        torch, cfg32, dev)
    check = decode_vs_forward(
        torch, cfg32, params,
        family_batch(torch, dev, cfg32, FAMILY_CHECK_B, FAMILY_CHECK_L,
                     SEED + 32, dtype=torch.float32), *fns)
    row = dict(
        arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
        enc_layers=cfg.enc_layers or None,
        weights_bytes=sum(p.numel() * 4 for p in params.parameters()),
        prefill=dict(batch=1, seq=seq, extra_tokens=cfg.vis_tokens or None,
                     src_len=cfg.src_len if frames is not None else None,
                     seconds=secs, first_s=warm_s,
                     tokens_per_s=seq / secs, max_memory_allocated=peak),
        decode=dict(batch=b, prompt=prompt_len, gen=gen, seconds=wall,
                    tokens_per_s=b * gen / wall, p50_step_ms=p50,
                    p99_step_ms=pct(step_ms, 0.99),
                    device_ms_per_step=dev_ms, idle_share=1 - dev_ms / p50,
                    top_device=top, sample=out[0, :8].tolist()),
        check=dict(check, capacity_factor=cf if cfg.n_experts else None))
    del params, model, step, batch, logits
    torch.cuda.empty_cache()
    if not check["ok"]:
        raise AssertionError(f"{arch}: float32 prefill and decode disagree: "
                             f"{check}")
    return row


def families_phase(torch, dev):
    from repro_torch import configs

    reset_kernel_launches()
    rows = []
    for arch, layers_run in FAMILIES.items():
        t0 = time.perf_counter()
        row = family_phase(torch, dev, arch, layers_run)
        full = configs.get(arch)
        row.update(layers_published=full.n_layers,
                   depth_cut=None if layers_run is None else
                   f"{full.n_layers} -> {layers_run} layers",
                   seconds_all=time.perf_counter() - t0)
        emit(dict(phase="family", card=card_line(), **row))
        rows.append(row)
    counts = no_kernel_launched("families")
    emit(dict(phase="families", archs=[r["arch"] for r in rows],
              kernel_launches=sum(counts.values())))
    return counts


def families_alone(torch, dev):
    """Phases 16-19, run by ``main`` after the training phases or on
    their own (no kernel is built: these paths launch none) ->
    {kernel row name: launches on those paths} (all 0) and their wall
    seconds."""
    wall = {}
    t0 = time.perf_counter()
    cfg, model, params = family_model(torch, dev, FAM_ARCH)
    fam_prefill_phase(torch, dev, cfg, model, params)
    t1 = time.perf_counter()
    fam_decode_phase(torch, dev, cfg, model, params)
    t2 = time.perf_counter()
    fam_check_phase(torch, dev, cfg, params)
    t3 = time.perf_counter()
    del params, model
    torch.cuda.empty_cache()
    counts = families_phase(torch, dev)
    wall.update(fam_prefill_s=t1 - t0, fam_decode_s=t2 - t1,
                fam_check_s=t3 - t2, families_s=time.perf_counter() - t3)
    return counts, wall


def fam_train_row(torch, dev, arch, layers_run, b, l):
    """One family's training at full width: float32 weights, bf16
    activations, AdamW (warmup 1), remat "full", FAM_TRAIN_STEPS timed
    steps and one profiled, all on one repeated batch -> its JSON row."""
    import math
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    full = configs.get(arch)
    cfg = cut_depth(full, layers_run)
    model = api.build(cfg, dev)
    opt = AdamWConfig(warmup=1, total_steps=FAM_TRAIN_STEPS + 1)
    torch.cuda.reset_peak_memory_stats()
    state = api.init_train_state(model, torch.Generator(dev).manual_seed(
        SEED), opt)
    n_params = sum(p.numel() for p in state.params.parameters())
    step = api.make_train_step(model, opt, remat="full")
    batch = family_batch(torch, dev, cfg, b, l, SEED + 40)
    seen, secs = [], []
    for _ in range(FAM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        seen.append({k: float(v) for k, v in metrics.items()})
    out = {}

    def profiled():
        out["state"], out["metrics"] = step(state, batch)

    t0 = time.perf_counter()
    dev_ms, top, ops = device_ops(torch, profiled, 1, n=10)
    profile_s = time.perf_counter() - t0
    seen.append({k: float(v) for k, v in out["metrics"].items()})
    peak = torch.cuda.max_memory_allocated()
    del state, out, model, batch, step
    torch.cuda.empty_cache()
    med = median(secs[1:])
    extra = cfg.vis_tokens or 0
    losses = [m["loss"] for m in seen]
    row = dict(
        arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
        layers_published=full.n_layers, enc_layers=cfg.enc_layers or None,
        depth_cut=(None if layers_run is None else
                   f"{full.n_layers} -> {layers_run} layers"),
        batch=b, seq=l, extra_tokens=extra or None,
        src_len=cfg.src_len if cfg.family == "encdec" else None,
        n_params=n_params, state_bytes=16 * n_params, dtype=cfg.dtype,
        remat="full", steps=len(seen), step_s=med, step_s_all=secs,
        tokens_per_s=b * l / med, max_memory_allocated=peak,
        profiled_device_ms=dev_ms, idle_share=1 - dev_ms / (med * 1e3),
        profile_s=profile_s, top_device=top, top_ops=ops, losses=losses,
        ln_vocab=math.log(cfg.vocab), first_loss_minus_ln_vocab=(
            losses[0] - math.log(cfg.vocab)),
        loss_falls=losses[-1] < losses[0],
        grad_norms=[m["grad_norm"] for m in seen],
        grads_finite=all(np.isfinite(m["grad_norm"]) for m in seen),
        moe_stats={k: [m[k] for m in seen] for k in seen[0]
                   if "skew" in k or "drop" in k} or None,
        model_flops_per_step=8 * cfg.n_params() * b * (l + extra),
        model_flops_bound_s=(8 * cfg.n_params() * b * (l + extra)
                             / BF16_FLOPS_PER_S))
    if not (row["grads_finite"] and all(np.isfinite(losses))
            and row["loss_falls"]):
        raise AssertionError(f"{arch}: training gave a non-finite loss or "
                             f"gradient, or the loss did not fall: "
                             f"{losses}, {row['grad_norms']}")
    return row


def fam_train_phase(torch, dev):
    """Every family but ssm trains at full width (depth cut to what 80
    GB holds at 16 bytes a parameter), FAM_TRAIN's shapes."""
    reset_kernel_launches()
    rows = []
    for arch, (layers_run, b, l) in FAM_TRAIN.items():
        t0 = time.perf_counter()
        row = fam_train_row(torch, dev, arch, layers_run, b, l)
        row["seconds_all"] = time.perf_counter() - t0
        emit(dict(phase="fam_train_row", card=card_line(), **row))
        rows.append(row)
    counts = no_kernel_launched("fam_train")
    emit(dict(phase="fam_train", archs=[r["arch"] for r in rows],
              kernel_launches=sum(counts.values())))
    return counts


def one_super_block(cfg):
    """``cfg`` at one super-block: its pattern's layers (the
    encoder-decoder one encoder and one decoder layer)."""
    import dataclasses
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=1, enc_layers=1)
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern))


def router_margin(torch, moe_mod, fn):
    """Run ``fn`` with the MoE layer's inputs captured -> the smallest
    gap between the second and third router probabilities over the
    tokens (a gap below rounding could flip a choice between two
    precisions)."""
    seen = []
    ffn = moe_mod.moe_ffn

    def capture(x, p, cfg, par=None):
        with torch.no_grad():
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).double()
                                  @ p.wr.double(), -1)
            top = torch.topk(probs, 3, -1).values
            seen.append(float((top[:, 1] - top[:, 2]).min()))
        return ffn(x, p, cfg, par)

    moe_mod.moe_ffn = capture
    try:
        out = fn()
    finally:
        moe_mod.moe_ffn = ffn
    return out, min(seen)


def grad_check(torch, dev, arch):
    """(a) one family at full width and one super-block, FAM_GRAD_B x
    FAM_GRAD_L tokens (float32 frames and image tokens): the float32
    loss's gradients (TF32 off) against the same loss's in float64 ->
    its row."""
    import copy
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import api, lm, moe

    cfg32 = dataclasses.replace(one_super_block(configs.get(arch)),
                                dtype="float32")
    cfg64 = dataclasses.replace(cfg32, dtype="float64")
    model32, model64 = api.build(cfg32, dev), api.build(cfg64, dev)
    params = model32.init_params(torch.Generator(dev).manual_seed(
        SEED + 50)).requires_grad_(True)
    batch = family_batch(torch, dev, cfg32, FAM_GRAD_B, FAM_GRAD_L,
                         SEED + 51, dtype=torch.float32)

    def grads(model, p, b):
        loss, _ = model.loss_fn(p, b)
        named = lm.named_leaves(p, model.cfg)
        return float(loss.detach()), dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))

    loss32, g32 = grads(model32, params, batch)
    params64 = copy.deepcopy(params).double()
    del params
    torch.cuda.empty_cache()
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    margin = None
    if cfg32.n_experts:
        (loss64, g64), margin = router_margin(
            torch, moe, lambda: grads(model64, params64, b64))
    else:
        loss64, g64 = grads(model64, params64, b64)
    worst, worst_leaf, finite = 0.0, None, True
    for k, g in g32.items():
        finite &= bool(torch.isfinite(g).all())
        scale = float(g64[k].abs().max())
        err = float((g.double() - g64[k]).abs().max())
        ratio = err / scale if scale else (0.0 if err == 0 else np.inf)
        if ratio > worst:
            worst, worst_leaf = ratio, k
    del params64, g32, g64
    torch.cuda.empty_cache()
    return dict(arch=cfg32.name, layers=cfg32.n_layers,
                enc_layers=cfg32.enc_layers or None, batch=FAM_GRAD_B,
                seq=FAM_GRAD_L, loss32=loss32, loss64=loss64,
                loss_rel_err=abs(loss32 - loss64) / abs(loss64),
                max_grad_err_of_leaf_max=worst, worst_leaf=worst_leaf,
                tolerance=FAM_GRAD_TOL, grads_finite=finite,
                router_top2_margin=margin,
                ok=finite and worst <= FAM_GRAD_TOL)


class _TrailCut(Exception):
    """Raised from the launcher's ``on_step`` to end its run early."""


def launcher_trail(torch, dev, argv, stop_after=None):
    """``launch/train.main`` with ``argv`` on the card, in a temporary
    checkpoint directory -> every completed step's loss, in order, and
    the launcher's last line (None when the run was cut after
    ``stop_after`` completed steps, redone ones included)."""
    from repro_torch.launch import train

    losses = []

    def on_step(i, m):
        losses.append(m["loss"])
        if len(losses) == stop_after:
            raise _TrailCut

    d = tempfile.mkdtemp(prefix="fam_train_ckpt_")
    out = io.StringIO()
    cut = False
    try:
        with contextlib.redirect_stdout(out):
            try:
                rc = train.main(argv + ["--ckpt-dir", d, "--device",
                                        str(dev), "--log-every", "1000"],
                                on_step=on_step)
            except _TrailCut:
                rc, cut = 0, True
    except BaseException:
        sys.stderr.write(out.getvalue())
        raise
    finally:
        shutil.rmtree(d)
    if rc != 0:
        raise AssertionError(f"launch/train.py {argv} returned {rc}")
    return losses, None if cut else out.getvalue().splitlines()[-1]


def fam_train_check_phase(torch, dev):
    """(a) every family's float32 gradients against float64 at one
    super-block; (b) the 100m preset at the launcher's defaults, whole
    and restarted after a failure, deterministic: the same loss trail
    bit for bit; (c) the launcher with no arguments (the 20m preset)."""
    reset_kernel_launches()
    t0 = time.perf_counter()
    checks = [grad_check(torch, dev, arch) for arch in FAM_TRAIN]
    t1 = time.perf_counter()
    with deterministic(torch) as nondeterministic:
        whole, _ = launcher_trail(torch, dev, [
            "--preset", "100m", "--ckpt-every", str(PRESET_STEPS + 1)])
        redo = PRESET_FAIL_AT - PRESET_FAIL_AT // PRESET_EVERY * PRESET_EVERY
        again, last = launcher_trail(torch, dev, [
            "--preset", "100m", "--ckpt-every", str(PRESET_EVERY),
            "--inject-failure-at", str(PRESET_FAIL_AT)],
            stop_after=PRESET_STOP + redo)
    bit_equal = (again[:PRESET_FAIL_AT] + again[PRESET_FAIL_AT + redo:]
                 == whole[:PRESET_STOP]
                 and again[PRESET_FAIL_AT:PRESET_FAIL_AT + redo]
                 == whole[PRESET_FAIL_AT - redo:PRESET_FAIL_AT])
    t2 = time.perf_counter()
    default, default_last = launcher_trail(torch, dev, [])
    t3 = time.perf_counter()
    counts = no_kernel_launched("fam_train_check")
    preset = dict(preset="100m", steps=PRESET_STEPS,
                  restarted_steps=PRESET_STOP,
                  ckpt_every=PRESET_EVERY, fail_at=PRESET_FAIL_AT,
                  losses=whole, restarted_losses=again,
                  restarted_last_line=last, bit_equal=bit_equal,
                  loss_falls=whole[-1] < whole[0],
                  nondeterministic_ops=nondeterministic, seconds=t2 - t1)
    dflt = dict(preset="20m (default)", steps=len(default), losses=default,
                last_line=default_last, loss_falls=default[-1] < default[0],
                seconds=t3 - t2)
    emit(dict(phase="fam_train_check", card=card_line(), grads=checks,
              grads_seconds=t1 - t0, preset_100m=preset, default_20m=dflt,
              kernel_launches=sum(counts.values())))
    bad = [c["arch"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"float32 gradients differ from float64 past "
                             f"{FAM_GRAD_TOL} of the leaf's largest: {bad}")
    if not (bit_equal and preset["loss_falls"]
            and len(again) == PRESET_STOP + redo):
        raise AssertionError(f"the 100m preset's restarted trail differs "
                             f"or its loss did not fall: {preset}")
    if not dflt["loss_falls"]:
        raise AssertionError(f"the default preset's loss did not fall: "
                             f"{default}")
    return counts


def fam_train_alone(torch, dev):
    """The two training phases of the other families, run by ``main``
    after the families' serving phases or on their own (no kernel is
    built: these paths launch none) -> their launch counts (all 0) and
    wall seconds.  The caching allocator grows expandable segments over
    these phases: a step allocates and frees float32 logits and weight
    casts of several GB, and fixed segments fragment under them (an
    out-of-memory with 23.68 GB reserved and free, gemma2 at batch 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        t0 = time.perf_counter()
        counts = fam_train_phase(torch, dev)
        t1 = time.perf_counter()
        check = fam_train_check_phase(torch, dev)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    return ({k: v + check[k] for k, v in counts.items()},
            dict(fam_train_s=t1 - t0,
                 fam_train_check_s=time.perf_counter() - t1))


def mm_train_cfg():
    """(a)'s configuration: the published qwen1.5-4b at ``MM_LAYERS``
    layers, float32 activations (the check against one device)."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(MM_ARCH), n_layers=MM_LAYERS,
                               dtype="float32")


def mm_tokens(torch, dev, cfg):
    """(a)'s global batch, one sequence a data rank, seeded."""
    g = torch.Generator(dev).manual_seed(SEED + 50)
    return torch.randint(0, cfg.vocab, (MM_DIMS[0], MM_SEQ), generator=g,
                         device=dev)


def mm_moe_inputs(torch, dev, cfg):
    """(b)'s global tokens and upstream gradient (bf16), and the MoE
    layer's weights in ``moe.init_params``' order, each from its own
    seeded generator: ``(x, gy, {name: (shape, seed)})``."""
    g = torch.Generator(dev).manual_seed(SEED + 60)
    shape = (MM_DIMS[0] * MM_MOE_B, MM_MOE_L, cfg.d_model)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    gy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_ff or cfg.d_ff
    return x, gy, {"wr": ((d, e), SEED + 61), "w1": ((e, d, f), SEED + 62),
                   "w3": ((e, d, f), SEED + 63), "w2": ((e, f, d), SEED + 64)}


def mm_weight(torch, dev, shape, seed):
    from repro_torch.models import layers
    return layers.dense_init(torch.Generator(dev).manual_seed(seed), shape)


def mm_moe_run(torch, fn, x, gy, p, lb_scale):
    """One forward and backward of an MoE form: ``sum(y * gy) +
    lb_scale * lb_loss`` -> its outputs, aux, gradients (x, wr, w1, w2)
    and seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = x.detach().requires_grad_(True)
    y, aux = fn(x, p)
    loss = (y.float() * gy.float()).sum() + lb_scale * aux["lb_loss"]
    dx, dwr, dw1, dw2 = torch.autograd.grad(loss, [x, p.wr, p.w1, p.w2])
    torch.cuda.synchronize()
    return dict(y=y.detach(),
                aux={k: float(v.detach()) for k, v in aux.items()},
                dx=dx, dwr=dwr, dw1=dw1, dw2=dw2,
                s=time.perf_counter() - t0)


def mm_sample(g):
    """The strided sample of an expert gradient the parent compares."""
    a, b = MM_SAMPLE
    return g[:, ::a, ::b].float().cpu()


def bit_sums(torch, t, chunk=1 << 25):
    """Two int64 checksums of ``t``'s bits (their sum, and their sum
    weighted by position): equal tensors give equal sums."""
    bits = t.detach().contiguous().view(
        torch.int32 if t.element_size() == 4 else torch.int16).flatten()
    s0 = s1 = 0
    for i in range(0, bits.numel(), chunk):
        b = bits[i:i + chunk].long()
        w = torch.arange(i + 1, i + 1 + b.numel(), device=b.device)
        s0 += int(b.sum())
        s1 += int((b * w).sum())
    return s0, s1


def mesh_model_rank(rank, size, path):
    """One rank of the mesh_model phase (spawned, gloo on the card):
    (a) qwen1.5-4b's sharded train step on the (2, 2) mesh, (c) its state
    saved from (2, 2) and restored onto (1, 4), (b) mixtral-8x22b's MoE
    layer in the local and the GSPMD form -> ``path/rank{rank}.json``
    and ``path/moe{rank}.pt``."""
    import json

    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.dist import parallel, sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import api, lm, moe
    from repro_torch.optim.adamw import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    base = mesh_lib.init_process_mesh("gloo", f"file://{path}/store", rank,
                                      size, "cuda", timeout=MM_DEADLINE_S)
    dev = base.device
    m = mesh_lib.make_mesh(base, MM_DIMS, MM_AXES, timeout=MM_DEADLINE_S)
    m14 = mesh_lib.make_mesh(base, MM_ELASTIC, MM_AXES,
                             timeout=MM_DEADLINE_S)
    reset_kernel_launches()
    out = dict(rank=rank, coords=m.coords, coords_elastic=m14.coords)

    def sync():
        torch.cuda.synchronize(dev)

    # (a) the sharded train step
    cfg = mm_train_cfg()
    model = api.build(cfg, dev)
    opt = AdamWConfig(warmup=1, total_steps=MM_STEPS + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    state = api.init_train_state(model, torch.Generator(dev).manual_seed(
        SEED), opt, mesh=m)
    specs = sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                 shard_experts=cfg.shard_experts, mesh=m)
    step = api.make_train_step(model, opt, remat="full", mesh=m)
    tokens = mm_tokens(torch, dev, cfg)
    steps = []
    for _ in range(MM_STEPS):
        m.reset_timers()
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        sync()
        steps.append(dict(s=time.perf_counter() - t0,
                          **{k: float(v) for k, v in metrics.items()},
                          **{f"timer_{k}": v for k, v in m.timers.items()}))
    out["train"] = dict(
        steps=steps, peak_bytes=torch.cuda.max_memory_allocated(dev),
        local_params=sum(p.numel() for p in state.params.parameters()),
        shapes={k: list(p.shape) for k, p in
                lm.named_leaves(state.params, cfg).items()})
    del step

    # (c) save from (2, 2), restore onto (1, 4)
    named = lm.named_leaves(state.params, cfg)
    leaves = {f"params/{k}": p for k, p in named.items()}
    leaves.update({f"opt/{part}/{k}": getattr(state.opt, part)[k]
                   for part in ("m", "v") for k in named})
    sums = {k: bit_sums(torch, t) for k, t in leaves.items()}
    ckpt = os.path.join(path, "ckpt")
    sync()
    t0 = time.perf_counter()
    store.save(ckpt, state, MM_STEPS, parallel.StateSpecs(m, specs))
    save_s = time.perf_counter() - t0
    with torch.no_grad():      # the state's structure only, memory freed
        for p in state.params.parameters():
            p.data = torch.empty(0, device=dev)
        for part in (state.opt.m, state.opt.v):
            for k in part:
                part[k] = torch.empty(0, device=dev)
    del leaves, named
    torch.cuda.empty_cache()
    specs14 = sharding.param_specs(sharding.abstract_params(cfg), cfg,
                                   shard_experts=cfg.shard_experts, mesh=m14)
    t0 = time.perf_counter()
    state, at = store.restore(ckpt, state,
                              shardings=parallel.StateSpecs(m14, specs14))
    sync()
    restore_s = time.perf_counter() - t0
    named = lm.named_leaves(state.params, cfg)
    equal = at == MM_STEPS and int(state.opt.step) == MM_STEPS
    for k, p in named.items():
        for name, t in ((f"params/{k}", p), (f"opt/m/{k}", state.opt.m[k]),
                        (f"opt/v/{k}", state.opt.v[k])):
            whole = parallel.unshard(t.detach(), specs14[k], m14)
            back = parallel.shard(whole, specs[k], m)
            equal &= bit_sums(torch, back) == sums[name]
    out["restore"] = dict(
        save_s=save_s, restore_s=restore_s, equal=bool(equal),
        leaves=len(sums),
        ckpt_bytes=sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ckpt) for f in fs),
        local_params_elastic=sum(p.numel() for p in named.values()))
    del state, named
    torch.cuda.empty_cache()

    # (b) the MoE layer: the local (shard_map) and the GSPMD forms
    mcfg = configs.get(MM_MOE_ARCH)
    x, gy, weights = mm_moe_inputs(torch, dev, mcfg)
    mspecs = sharding.param_specs(
        {f"blocks.0.moe.{k}": torch.empty(shape, device="meta")
         for k, (shape, _) in weights.items()}, mcfg,
        shard_experts=False, mesh=m)
    torch.cuda.reset_peak_memory_stats(dev)
    p = {}
    for k, (shape, seed) in weights.items():
        whole = mm_weight(torch, dev, shape, seed)
        p[k] = parallel.shard(whole, mspecs[f"blocks.0.moe.{k}"],
                              m).requires_grad_(True)
        del whole
    p = types.SimpleNamespace(**p)
    d = m.coords["data"]
    rows = slice(d * MM_MOE_B, (d + 1) * MM_MOE_B)
    par = parallel.Parallel.of(m, x.shape[0])
    def held(r):
        """What the parent holds a run to, on the host: the run's
        gradients leave the card before the next run starts."""
        return dict(s=r["s"], aux=r["aux"], **{
            k: mm_sample(r[k]) if k in ("dw1", "dw2") else r[k].cpu()
            for k in ("y", "dx", "dwr", "dw1", "dw2")})

    moe.set_local_moe((m, ("data",), "model", "data"))
    try:
        for _ in range(2):              # warm, then timed
            m.reset_timers()
            local = held(mm_moe_run(
                torch, lambda a, w: moe.moe_ffn(a, w, mcfg), x[rows],
                gy[rows], p, 1.0))
            local_timers = dict(m.timers)
    finally:
        moe.set_local_moe(None)
    for _ in range(2):
        m.reset_timers()
        gspmd = held(mm_moe_run(
            torch, lambda a, w: moe.moe_ffn(a, w, mcfg, par), x[rows],
            gy[rows], p, 1.0 / MM_DIMS[0]))
        gspmd_timers = dict(m.timers)
    out["moe"] = dict(
        local_s=local["s"], gspmd_s=gspmd["s"], local_timers=local_timers,
        gspmd_timers=gspmd_timers, local_aux=local["aux"],
        gspmd_aux=gspmd["aux"],
        peak_bytes=torch.cuda.max_memory_allocated(dev),
        shard_params=sum(t.numel() for t in vars(p).values()))
    torch.save({"local": local, "gspmd": gspmd},
               os.path.join(path, f"moe{rank}.pt"))
    out["launches"] = {k: v for k, v in kernel_launches().items() if v}
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh_lib.close(base)


def mm_close(torch, got, want, tol, what):
    """``got`` within ``tol`` of ``want``'s largest |value| -> the
    relative gap; raises past it."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    gap = float((got - want).abs().max()) / max(scale, 1e-30)
    if not gap <= tol:
        raise AssertionError(f"mesh_model {what}: {gap} of the largest "
                             f"{scale}, past {tol}")
    return gap


def mesh_model_phase(torch, dev):
    """Item 10's model side on the card: ``SHARDS`` spawned gloo ranks
    on the one card as a (2, 2) ``("data", "model")`` mesh (``(1, 4)``
    for the elastic restore), held after they exit to the port's one
    device: (a)'s losses and gradient norms against the one-device
    step on the global batch, (b)'s MoE outputs and gradients against
    the one-device math (the local form on each data rank's rows, the
    GSPMD form on the global batch), (c) the restore bit for bit (by
    checksums on the ranks) -> the launch counts (all 0)."""
    import json

    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import api, moe
    from repro_torch.optim.adamw import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_kernel_launches()
    torch.cuda.empty_cache()
    cfg = mm_train_cfg()
    n_rep = 2 * cfg.vocab_padded * cfg.d_model        # embedding and head
    n_layer = cfg.n_params() - 2 * cfg.vocab * cfg.d_model
    free, total = torch.cuda.mem_get_info(dev)
    plan = dict(phase="mesh_model_memory_plan", ranks=SHARDS,
                state_bytes_a_rank=16 * (n_rep + n_layer // MM_DIMS[1]),
                logits_bytes_a_rank=4 * MM_SEQ * cfg.vocab_padded,
                parent_allocated=torch.cuda.memory_allocated(dev),
                parent_reserved=torch.cuda.memory_reserved(dev),
                card_free_bytes=free, card_bytes=total, card=card_line())
    emit(plan)
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        mesh_lib.spawn(mesh_model_rank, (SHARDS, path), SHARDS,
                       MM_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
        rows, moe_rows = [], []
        for r in range(SHARDS):
            with open(os.path.join(path, f"rank{r}.json")) as f:
                rows.append(json.load(f))
            moe_rows.append(torch.load(os.path.join(path, f"moe{r}.pt")))
    t1 = time.perf_counter()
    for row in rows:
        if row["launches"]:
            raise AssertionError(f"mesh_model rank {row['rank']} launched "
                                 f"{row['launches']}")
        if not row["restore"]["equal"]:
            raise AssertionError(f"mesh_model rank {row['rank']}: the state "
                                 f"restored onto (1, 4) differs")
        for k in ("loss", "grad_norm"):
            if [s[k] for s in row["train"]["steps"]] != [
                    s[k] for s in rows[0]["train"]["steps"]]:
                raise AssertionError(f"mesh_model: the ranks' {k} differ")
    # (a) against the one-device step on the global batch
    model = api.build(cfg, dev)
    opt = AdamWConfig(warmup=1, total_steps=MM_STEPS + 1)
    state = api.init_train_state(model, torch.Generator(dev).manual_seed(
        SEED), opt)
    step = api.make_train_step(model, opt, remat="full")
    tokens = mm_tokens(torch, dev, cfg)
    one = []
    for _ in range(MM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        one.append(dict(s=time.perf_counter() - t0,
                        **{k: float(v) for k, v in metrics.items()}))
    del state, step, model
    torch.cuda.empty_cache()
    gaps = {}
    for k in ("loss", "grad_norm"):
        gaps[k] = max(abs(s[k] - o[k]) / abs(o[k]) for s, o in zip(
            rows[0]["train"]["steps"], one))
        if not gaps[k] <= MM_STEP_TOL:
            raise AssertionError(f"mesh_model (a): {k} {gaps[k]} from the "
                                 f"one-device step, past {MM_STEP_TOL}")
    # (b) against the one-device MoE math
    mcfg = configs.get(MM_MOE_ARCH)
    x, gy, weights = mm_moe_inputs(torch, dev, mcfg)
    p = types.SimpleNamespace(**{
        k: mm_weight(torch, dev, shape, seed).requires_grad_(True)
        for k, (shape, seed) in weights.items()})
    f_loc = (mcfg.moe_ff or mcfg.d_ff) // MM_DIMS[1]
    a, b = MM_SAMPLE
    moe_gaps = {}

    def hold(form, r, want, cols, summed=None):
        got = summed or moe_rows[r][form]
        for k in ("y", "dx", "dwr"):
            key = f"{form} {k}"
            moe_gaps[key] = max(moe_gaps.get(key, 0.0), mm_close(
                torch, got[k], want[k].cpu(), MM_MOE_TOL, key))
        for k, w in (("dw1", want["dw1"][..., cols]),
                     ("dw2", want["dw2"][:, cols])):
            key = f"{form} {k}"
            moe_gaps[key] = max(moe_gaps.get(key, 0.0), mm_close(
                torch, got[k], mm_sample(w), MM_MOE_TOL, key))

    for d in range(MM_DIMS[0]):
        rows_d = slice(d * MM_MOE_B, (d + 1) * MM_MOE_B)
        want = mm_moe_run(torch, lambda a_, w: moe._moe_math(a_, w, mcfg),
                          x[rows_d], gy[rows_d], p, 1.0)
        for mi in range(MM_DIMS[1]):
            r = d * MM_DIMS[1] + mi
            hold("local", r, want, slice(mi * f_loc, (mi + 1) * f_loc))
            for k, v in want["aux"].items():
                moe_gaps.setdefault(f"local aux {k}", []).append(
                    (rows[r]["moe"]["local_aux"][k], v))
        del want
    want = mm_moe_run(torch, lambda a_, w: moe.moe_ffn(a_, w, mcfg), x, gy,
                      p, 1.0)
    for mi in range(MM_DIMS[1]):
        ranks = [d * MM_DIMS[1] + mi for d in range(MM_DIMS[0])]
        for d, r in enumerate(ranks):
            rows_d = slice(d * MM_MOE_B, (d + 1) * MM_MOE_B)
            got = dict(moe_rows[r]["gspmd"])
            got.update({k: sum(moe_rows[q]["gspmd"][k] for q in ranks)
                        for k in ("dwr", "dw1", "dw2")})
            hold("gspmd", r, dict(want, y=want["y"][rows_d],
                                  dx=want["dx"][rows_d]),
                 slice(mi * f_loc, (mi + 1) * f_loc), got)
            for k, v in want["aux"].items():
                if abs(rows[r]["moe"]["gspmd_aux"][k] - v) > 1e-6 * max(
                        abs(v), 1e-30):
                    raise AssertionError(f"mesh_model (b) gspmd aux {k}")
    one_moe_s = want["s"]
    del want, p, x, gy
    torch.cuda.empty_cache()
    for key in [k for k in moe_gaps if " aux " in k]:
        pairs = moe_gaps.pop(key)
        mean = sum(v for _, v in pairs[::MM_DIMS[1]]) / MM_DIMS[0]
        got = pairs[0][0]
        if abs(got - mean) > 1e-5 * max(abs(mean), 1e-30):
            raise AssertionError(f"mesh_model (b) {key}: {got} against the "
                                 f"shards' mean {mean}")
    counts = no_kernel_launched("mesh_model")
    card = card_line()
    for row in rows:
        tr = row["train"]["steps"]
        med = median([s["s"] for s in tr[1:]])
        emit(dict(phase="mesh_model_rank", card=card, rank=row["rank"],
                  coords=row["coords"], backend="gloo",
                  step_s=med, step_s_all=[s["s"] for s in tr],
                  tokens_per_s=MM_DIMS[0] * MM_SEQ / med,
                  comm_share=median([s["timer_comm_s"] / s["s"]
                                     for s in tr[1:]]),
                  copy_share=median([s["timer_copy_s"] / s["s"]
                                     for s in tr[1:]]),
                  comm_calls=tr[-1]["timer_calls"],
                  comm_bytes=tr[-1]["timer_bytes"],
                  peak_gb=row["train"]["peak_bytes"] / 1e9,
                  local_params=row["train"]["local_params"],
                  losses=[s["loss"] for s in tr],
                  grad_norms=[s["grad_norm"] for s in tr],
                  restore=row["restore"], moe=row["moe"]))
    emit(dict(phase="mesh_model", card=card, ranks=SHARDS, dims=MM_DIMS,
              arch=cfg.name, layers=cfg.n_layers, seq=MM_SEQ,
              steps=MM_STEPS, ranks_s=ranks_s,
              one_device_step_s=median([o["s"] for o in one[1:]]),
              one_device_losses=[o["loss"] for o in one],
              step_gaps=gaps, step_tol=MM_STEP_TOL, moe_arch=mcfg.name,
              moe_tokens_a_rank=MM_MOE_B * MM_MOE_L, moe_gaps=moe_gaps,
              moe_tol=MM_MOE_TOL, one_device_moe_s=one_moe_s,
              check_s=time.perf_counter() - t1,
              kernel_launches=sum(counts.values())))
    return counts


def mesh_model_alone(torch, dev):
    """The mesh_model phase, run by ``main`` after the families'
    training or on its own (no kernel is built: it launches none) ->
    its launch counts (all 0) and wall seconds."""
    t0 = time.perf_counter()
    counts = mesh_model_phase(torch, dev)
    return counts, dict(mesh_model_s=time.perf_counter() - t0)


def dryrun_cell(arch, shape):
    """One cell of the dry-run sweep, in a worker process ->
    (``dryrun.run_cell``'s record on the single mesh, extrapolated; the
    worker's kernel launches so far)."""
    import torch
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    rec = dryrun.run_cell(arch, shape, False, verbose=False)
    return rec, sum(kernel_launches().values())


def dryrun_check_dry(kind, seq):
    """Phase 24's dry-run side, in a worker process: the
    ``DRYRUN_CHECK_ARCH`` cell at ``DRYRUN_CHECK_LAYERS`` layers, batch
    1, on a (1, 1) recording mesh -> (``roofline.Counts``, its seconds,
    the worker's kernel launches so far)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import cells, mesh as mesh_lib, shapes

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    counts = cells.build_cell(
        DRYRUN_CHECK_ARCH, shapes.ShapeSpec(f"{kind}_{seq}", seq, 1, kind),
        mesh_lib.RecordingMesh.of((1, 1), MM_AXES),
        cfg_override=cut_depth(configs.get(DRYRUN_CHECK_ARCH),
                               DRYRUN_CHECK_LAYERS)).run_fn()
    return (counts, time.perf_counter() - t0,
            sum(kernel_launches().values()))


def pin_worker(cores) -> None:
    """A sweep worker's initializer: it runs on ``cores`` only."""
    os.sched_setaffinity(0, cores)


def pin_threads(cores) -> None:
    """Every thread of this process on ``cores`` (a thread keeps the
    cores it was started with: the pools torch starts while the sweep
    runs too)."""
    for tid in os.listdir("/proc/self/task"):
        with contextlib.suppress(ProcessLookupError):
            os.sched_setaffinity(int(tid), cores)


class DryrunSweep:
    """Phase 23's sweep in ``DRYRUN_WORKERS`` spawned processes on the
    second half of the host's cores, the main process on the first:
    ``start`` submits every cell, the slowest (prefill) first; ``join``
    waits for every cell, stops the workers and gives the main process
    its cores back; ``collect`` prints the records; leaving the ``with``
    block kills the workers, finished or not."""

    def __init__(self):
        self.pool = self.futs = self.check = self.t0 = self.cores = None
        self.done = []          # each cell's finish time
        self.waited_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self.unpin()

    def close(self) -> None:
        """Kill the workers, finished or not (a finished cell's record
        stays in its future)."""
        if self.pool is not None:
            for proc in list(getattr(self.pool, "_processes", {}).values()):
                if proc.is_alive():
                    proc.kill()
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None

    def unpin(self) -> None:
        if self.cores:
            pin_threads(self.cores)
            self.cores = None

    def start(self) -> None:
        import concurrent.futures as cf
        import multiprocessing as mp
        from repro_torch import configs
        from repro_torch.launch import shapes

        cores = sorted(os.sched_getaffinity(0))
        half = len(cores) // 2
        if half:
            self.cores = cores
            pin_threads(cores[:half])
        self.pool = cf.ProcessPoolExecutor(
            DRYRUN_WORKERS, mp_context=mp.get_context("spawn"),
            initializer=pin_worker, initargs=(cores[half:],))
        order = {"prefill": 0, "train": 1, "decode": 2}
        cells = sorted(((a, s) for a in configs.ARCHS
                        for s in shapes.SHAPES),
                       key=lambda c: order[shapes.SHAPES[c[1]].kind])
        self.check = {kind: self.pool.submit(dryrun_check_dry, kind, seq)
                      for kind, seq in DRYRUN_CHECK}
        self.t0 = time.perf_counter()
        self.futs = [(a, s, self.pool.submit(dryrun_cell, a, s))
                     for a, s in cells]
        for _, _, fut in self.futs:
            fut.add_done_callback(
                lambda _f: self.done.append(time.perf_counter()))

    def join(self) -> None:
        """Wait for every cell (the records, or the exceptions
        ``collect`` raises), stop the workers and give the main process
        its cores back."""
        import concurrent.futures as cf

        t_wait = time.perf_counter()
        cf.wait([f for *_, f in self.futs] + list(self.check.values()),
                timeout=max(1.0, self.t0 + DRYRUN_DEADLINE_S - t_wait))
        self.waited_s = time.perf_counter() - t_wait
        self.close()
        self.unpin()

    def collect(self) -> dict:
        """Phase 23: one line a cell, then the report's summary and
        table -> its seconds (from its start, and waited for in
        ``join``).  Fails on a failed or unfinished cell, a skip without
        the reference's reason, or a kernel launched in a worker."""
        from repro_torch import configs
        from repro_torch.launch import report, shapes

        recs, launches = [], 0
        for _, _, fut in self.futs:
            rec, n = fut.result(timeout=0)
            launches = max(launches, n)
            recs.append(rec)
            emit(dict(phase="dryrun", **{k: v for k, v in rec.items()
                                         if k != "trace"}))
        summary = report.summary(recs)
        emit(dict(phase="dryrun_summary", summary=summary,
                  table=report.roofline_table(recs, "single"),
                  kernel_launches=launches,
                  seconds=max(self.done) - self.t0,
                  waited_s=self.waited_s, workers=DRYRUN_WORKERS,
                  cell_s=sum(r.get("t_lower_s") or 0 for r in recs)))
        bad = [r for r in recs if r["status"] == "fail" or (
            r["status"] == "skipped" and r["why"] != shapes.cell_supported(
                configs.get(r["arch"]), shapes.SHAPES[r["shape"]])[1])]
        if bad or launches or len(recs) != len(configs.ARCHS) * len(
                shapes.SHAPES):
            raise AssertionError(
                f"dry-run: {summary}; kernel launches {launches}; "
                f"{[r.get('error') for r in bad]}")
        return dict(dryrun_s=max(self.done) - self.t0,
                    dryrun_waited_s=self.waited_s)


def held_bytes(torch, tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def dryrun_check_phase(torch, dev, sweep: DryrunSweep) -> list:
    """Phase 24 (module docstring; its dry-run side ran in ``sweep``'s
    workers) -> its rows."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.launch import cells, mesh as mesh_lib, roofline
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cut_depth(configs.get(DRYRUN_CHECK_ARCH), DRYRUN_CHECK_LAYERS)
    reset_kernel_launches()
    rows = []
    for kind, seq in DRYRUN_CHECK:
        dry, dry_s, dry_launches = sweep.check[kind].result(
            timeout=DRYRUN_DEADLINE_S)
        rl = roofline.analyze(dry)
        mesh = mesh_lib.RecordingMesh.of((1, 1), MM_AXES, dev)
        model = api.build(cfg, dev)
        gen = torch.Generator(dev).manual_seed(SEED)
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, seq),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}
        if kind == "train":
            opt = AdamWConfig()
            state = api.init_train_state(model, gen, opt, mesh=mesh)
            step = api.make_train_step(model, opt, mesh=mesh)
            held = cells.state_tensors([state, batch])

            def run():
                step(state, batch)
        else:
            params = model.init_params(gen)
            step = api.make_prefill_step(model, mesh=mesh)
            held = cells.state_tensors([params, batch])

            def run():
                step(params, batch)
        run()                       # warm: cuBLAS workspaces and pools
        torch.cuda.synchronize()
        start = held_bytes(torch, held)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with FlopCounterMode(display=False) as fc:
            run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base + start
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        row = dict(
            arch=cfg.name, layers=cfg.n_layers, kind=kind, batch=1, seq=seq,
            dry_flops=dry.flops, card_flops=fc.get_total_flops(),
            dry_peak_bytes=dry.peak_memory, card_peak_bytes=peak,
            peak_gap=(dry.peak_memory - peak) / peak, held_bytes=start,
            base_bytes=base, dry_run_s=dry_s, step_s=median(secs),
            step_s_all=secs, t_compute_s=rl.t_compute,
            t_memory_s=rl.t_memory, bound_s=max(rl.t_compute, rl.t_memory),
            hbm_bytes=dry.hbm_bytes, dry_kernel_launches=dry_launches)
        emit(dict(phase="dryrun_check", card=card_line(), **row))
        rows.append(row)
        del run, step, held, batch, model
        if kind == "train":
            del state
        else:
            del params
        torch.cuda.empty_cache()
        if row["dry_flops"] != row["card_flops"] or dry_launches \
                or abs(row["peak_gap"]) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"dryrun_check {kind}: {row}")
    no_kernel_launched("dryrun_check")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda is not "
              "available", file=sys.stderr)
        return 2
    wall = {"checker_s": checker_phase(torch)}
    with DryrunSweep() as sweep:
        return phases(torch, wall, sweep)


def phases(torch, wall: dict, sweep: DryrunSweep) -> int:
    """Phases 1-24 (module docstring); phase 23's sweep runs in
    ``sweep``'s workers from the end of the build to the end of phase 5."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.kernels.ssd import kernel as skernel

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    t0 = time.perf_counter()
    libs = cuda_build.build_all([kernel.SOURCE, hkernel.SOURCE,
                                 mkernel.SOURCE, skernel.SOURCE])
    ptxas = {lib.name: [ln.strip() for ln in lib.with_suffix(".log")
                        .read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
             for lib in libs}
    wall["build_s"] = time.perf_counter() - t0
    sweep.start()
    emit(dict(phase="build", seconds=wall["build_s"],
              libraries=[lib.name for lib in libs], device=name,
              nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              ptxas=ptxas))

    t0 = time.perf_counter()
    (servers, mbrs, qc, qi, pruned_x, launches, calls,
     serve_encode, batches) = serve_phase(torch, dev)
    t1 = time.perf_counter()
    pts, pruned_knn, knn_launches, batches["knn"], knn_x = knn_phase(
        torch, servers, mbrs, dev)
    t2 = time.perf_counter()
    dense_launches = dense_phase(torch, servers["x"], mbrs, qc, qi, pts,
                                 pruned_x, pruned_knn)
    t3 = time.perf_counter()
    entries = kernel_phase(torch, servers, qc, qi, pts, launches, calls)
    entries += dense_kernel_phase(torch, servers["x"], qc, qi, pts,
                                  dense_launches)
    for e in entries:
        if e["name"] in CASES:
            e["knn_launches"] = knn_launches[e["name"]]
        emit(dict(phase="kernel", **e))
    t4 = time.perf_counter()
    wall.update(serve_s=t1 - t0, knn_s=t2 - t1, dense_s=t3 - t2,
                kernels_s=t4 - t3)
    sweep.join()             # no later phase shares the host with it
    t4 = time.perf_counter()
    servers = {"x": servers["x"]}
    parts = servers["x"].parts
    del qc, qi, pts, pruned_knn
    torch.cuda.empty_cache()
    keep = {}              # what the mesh phase holds its ranks to
    sharded_launches = sharded_phase(torch, dev, servers, mbrs, batches,
                                     pruned_x, knn_x, keep)
    t4b = time.perf_counter()
    wall["sharded_s"] = t4b - t4
    t4 = t4b
    del servers, batches, pruned_x, knn_x
    torch.cuda.empty_cache()
    rsrv, hsrv, heat_launches = heat_phase(torch, dev, mbrs, parts)
    t4b = time.perf_counter()
    wall["heat_s"] = t4b - t4
    t4 = t4b
    frontend_launches = frontend_phase(torch, dev, rsrv, hsrv)
    t4b = time.perf_counter()
    wall["frontend_s"] = t4b - t4
    t4 = t4b
    del rsrv, hsrv, parts, mbrs
    torch.cuda.empty_cache()

    ingest_launches = ingest_phase(torch, dev)
    for e in entries:
        e["launches_by_path"] = dict(ingest=ingest_launches[e["name"]],
                                     sharded=sharded_launches[e["name"]],
                                     heat=heat_launches[e["name"]],
                                     frontend=frontend_launches[e["name"]])
    t4b = time.perf_counter()
    wall["ingest_s"] = t4b - t4
    t4 = t4b

    inputs = join_inputs(torch, dev)
    part_encode = partition_phase(torch, *inputs["pi"])
    t5 = time.perf_counter()
    results, join_launches, tiles, pairs, plans = join_phase(torch, dev,
                                                             inputs)
    t6 = time.perf_counter()
    join_check_phase(torch, inputs, results, pairs)
    sharded_join = sharded_join_phase(torch, dev, inputs, results, keep)
    t7 = time.perf_counter()
    main_launches = dict(
        hilbert_encode=serve_encode + part_encode + join_launches["encode"],
        mbr_count=join_launches["count"], mbr_mask=join_launches["mask"],
        mbr_rp_counts=join_launches["rp_counts"],
        mbr_raw_counts=join_launches["raw_counts"],
        mbr_pair_list=join_launches["pair_list"])
    new_entries = new_kernel_phase(torch, inputs, tiles, plans, results,
                                   main_launches)
    for e in new_entries:
        e["launches_by_path"] = (
            dict(serve_hilbert_staging=serve_encode, partition=part_encode,
                 join=join_launches["encode"],
                 ingest=ingest_launches["encode"],
                 sharded=sharded_join["encode"])
            if e["name"] == "hilbert_encode" else
            dict(join=join_launches[e["name"][4:]],
                 sharded=sharded_join[e["name"][4:]]))
        emit(dict(phase="kernel", **e))
    entries += new_entries
    t8 = time.perf_counter()
    wall.update(partition_s=t5 - t4, join_s=t6 - t5, join_check_s=t7 - t6,
                new_kernels_s=t8 - t7)
    del inputs, results, tiles, pairs, plans
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(torch, dev, keep)
    del keep
    t8b = time.perf_counter()
    wall["mesh_s"] = t8b - t8
    t8 = t8b

    cfg, model, params = family_model(torch, dev, LM_ARCH)
    ssd_launches = lm_prefill_phase(torch, dev, cfg, model, params)
    t9 = time.perf_counter()
    lm_decode_phase(torch, dev, cfg, model, params)
    t10 = time.perf_counter()
    ssd_entry = lm_check_phase(torch, dev, cfg, model, params, ssd_launches)
    t11 = time.perf_counter()
    del params, model
    torch.cuda.empty_cache()
    train_launches, per_step, layer0 = lm_train_phase(torch, dev)
    t12 = time.perf_counter()
    lm_train_check_phase(torch, dev, layer0)
    del layer0
    torch.cuda.empty_cache()
    wall.update(lm_prefill_s=t9 - t8, lm_decode_s=t10 - t9,
                lm_check_s=t11 - t10, lm_train_s=t12 - t11,
                lm_train_check_s=time.perf_counter() - t12)
    family_launches, family_wall = families_alone(torch, dev)
    wall.update(family_wall)
    fam_train_launches, fam_train_wall = fam_train_alone(torch, dev)
    wall.update(fam_train_wall)
    mesh_model_launches, mesh_model_wall = mesh_model_alone(torch, dev)
    wall.update(mesh_model_wall)
    t0 = time.perf_counter()
    dryrun_check_phase(torch, dev, sweep)
    wall["dryrun_check_s"] = time.perf_counter() - t0
    wall.update(sweep.collect())
    ssd_entry["launches_by_path"] = dict(train=train_launches)
    ssd_entry["launches_per_train_step"] = per_step
    entries.append(ssd_entry)
    for e in entries:
        e["launches_by_path"]["families"] = family_launches[e["name"]]
        e["launches_by_path"]["fam_train"] = fam_train_launches[e["name"]]
        e["launches_by_path"]["mesh_model"] = mesh_model_launches[e["name"]]
        e["launches_by_path"]["mesh"] = mesh_launches_of(mesh_launches,
                                                         e["name"])
    emit(dict(phase="kernel", **ssd_entry))
    emit(dict(phase="wall", **wall))
    emit({"kernels": [dict(
        {k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: e[k] for k in ("bit_equal", "tolerance", "bound_ms_full_cap",
                             "plain_q", "ms_at_plain_q",
                             "design", "table_kernel", "table_ms",
                             "old_extraction_ms", "old_design",
                             "old_design_ms", "launches_by_path") if k in e})
        for e in entries]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
