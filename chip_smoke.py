#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (tuplewise_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --phase27`` builds the kernels and runs phase 27
alone, printing its record as one JSON line; ``--phase28`` does the same
for phase 28.) It builds the CUDA kernels from tuplewise_tpu_torch/csrc
with nvcc (one nvcc per source, all started together), then runs the
phases below. Each phase asserts what it checks, and nothing is caught:
any failure exits nonzero. Each phase prints its seconds.

1. Build: compile the kernels and print the build seconds, what ptxas
   reports for the pair-sum, gradient, sort-and-count and count kernels
   (registers, stack, spills), and, from the SASS of the logistic
   kernels (cuobjdump), the instructions a pair of each branch's hot
   loop: the pair sum's, and the straight-line body of a 256-pair chunk
   of each gradient kernel.
2. Kernel vs plain: pair_sum and masked_pair_sum for auc, hinge and
   logistic at a ragged size (4133 x 8197), batched (W = 8), at
   2^14 x 2^14 and at the harness's local-round batch (W = 512,
   1250 x 1250), each against its plain PyTorch version on the same card.
   AUC must be equal exactly (the unmasked auc is an int64 sort-and-count
   of csrc/rank_count.cu; the masked one sums {0, 1} weights and halves
   exactly in float64, csrc/rank_count.cu too). hinge and logistic must agree
   within rel 1e-5: both sum float32 values, in different orders. Then
   every body on edge-case scores (+-inf, NaN of both signs, +-0.0,
   subnormals, heavy ties) from 1 x 1 to W = 3 x 9000 x 70000: auc
   kernel equal to plain; hinge and logistic NaN where plain is NaN, inf
   where it is inf, finite sums within rel 1e-5. Then the logistic
   kernel's two branches in one launch (blocks with a non-finite score,
   or a score range wider than LOGISTIC_SPAN, beside narrow finite ones,
   scores about 0 and about 300, |d| up to 100), within rel 1e-5 of plain
   and both branches counted. Then the unmasked hinge's sort-and-search
   route (csrc/rank_count.cu) on scores on a 1/4 lattice with pairs at
   d == 1, a -inf score of a and a +inf of b, b past one 16384-value
   tile with a short last tile, and W = 512 x 1250: finite sums equal to
   plain (exact differences), +inf where plain is +inf, two calls bit
   for bit. The edge-value cases also run at W = 512 x 1250. Then the
   masked auc and hinge routes (csrc/rank_count.cu) with {0, 1} and
   {-1, 0, 1} weights and fractional weights in [0, 2) and in (-2, 2)
   (20 % zeros): b past one 8192- and one 16384-value tile with a short
   last tile, W = 512 x 1250, lattice scores, infinities of weight 0,
   facing a zero weight and meeting negative weights (-inf, +inf and NaN
   by the weights' signs), the four W = 1 inputs where a negative weight
   sets the hinge's infinity, edge values: the auc equal to plain with
   {0, 1} and {-1, 0, 1} weights (the hinge too on the lattice),
   otherwise NaN and +-inf where plain has them and finite sums within
   the gap that plain's float32 rounding allows (masked_gap, the
   derivation of tests/test_torch_masked_routes.py); two calls bit for
   bit.
3. Main path at full size, through Estimator(kernel, backend="torch") on
   the default device: complete at n = 2^20 and 2^20 + 64 per class (AUC
   with auc_fast=False, which must equal rank_auc exactly), local_average
   and repartitioned (N = 8, T = 4, n = 10^6), a local round over a
   ragged partition that keeps every row (the masked kernel), and
   incomplete (n = 10^6, B = 10^4), each timed with CUDA events.
4. Variance harness (BASELINE config 1): M = 64 batched reps at n = 10^4
   per class for the complete, local (N = 8), repartitioned (T = 4) and
   incomplete (B = 10^4) schemes; the Monte-Carlo variance must sit in
   the chi-square band of the closed form (see CHI2_BAND). Each scheme
   runs once to warm up before its timed run.
5. Timing at the main-path shapes: each kernel, its plain version and
   a PyTorch yardstick (library_ms) with CUDA events: for the auc,
   rank_auc; for the hinge, torch.sort + torch.cumsum +
   torch.searchsorted on the same scores; for the masked auc and hinge
   the same composition with the masks' weights; none computes the
   logistic. The bound: for the sort-and-count routes (auc, hinge,
   masked or not) the bytes of their inputs (scores and weights) and
   partials, or the sort of b's keys. Each
   timed kernel result is held against its plain result as in phase 2,
   and that full-size error of the mean is the row's max_abs_err (phase
   2's is max_abs_err_small). The logistic rows also give the blocks of
   each branch at their shape, the SASS instructions a pair and the time
   they take at the card's issue rate (PEAK_ISSUE). Phases 5, 6 and 12b
   print beside each row the parent commit's time of a route this commit
   replaced (EARLIER_MS; None for the others).

6. Gradient kernels vs plain (the learner's slice): pair_loss_grad and
   pair_grad_sums for hinge (the sort-and-search route of
   csrc/rank_count.cu) and logistic (csrc/pair_grad.cu) at a ragged size
   (4133 x 8197), batched (W = 8), at the simulated learner's batch
   (W = 1536, 16 x 16) and at the trainer's headline (W = 1, 5e5 x 5e5),
   against one plain pair_loss_grad per shape and body. hinge row and col
   must be equal (integer counts); logistic row and col within rel 1e-4
   per element (float32 sums of up to 5e5 same-signed terms in different
   orders); losses within rel 1e-5 of the plain loss and rel 1e-6 of
   pair_sum of the same body. The loss+grad and grad-only kernels must
   give bit-equal row and col. Then both bodies on edge-case scores
   (+-inf, NaN of both signs, +-0.0, subnormals, ties, d == 1) at ragged
   shapes that leave padding in the last tile of each side, a -inf score
   beside ragged columns, and single infinities: hinge row and col equal
   to plain, logistic row and col and both losses NaN and inf where plain
   has them and finite values within the same tolerances, kernel 3's row
   and col bit-equal to kernel 4's. At the headline each kernel is timed
   against its plain version and its bound; the hinge rows also against
   their yardstick, torch.sort + torch.searchsorted (+ torch.cumsum for
   the loss) on the same scores (library_ms), and the logistic rows give
   the SASS instructions a pair and their time at the issue rate.
7. Training at full width (BASELINE config 2 at the size of
   scripts/learning_suite.py stage_chip): train_pairwise on the default
   device, hinge, n = 5e5 per class, dim 5, for repartition_every in
   {1, 10, never} x loss_every in {1, never}, each warmed once and timed
   over 20 steps with CUDA events; held-out AUC after 20 steps >= 0.75
   and above the initial AUC, and the recorded loss falls. One logistic
   run (loss_every = 2, 4 steps) launches the other body.
8. Resume is exact: 20 steps in one call equal, bit for bit, 7 steps, a
   checkpoint and a resumed call (n = 2^16 per class, 4 workers).
9. Kernel trajectory vs plain: 20 hinge steps with the kernels and with
   impl="plain" (n = 2^14 per class) agree within rel 1e-6.
10. Simulated learner: one train_curves cell of learning_suite's gauss
   sweep (n = 512, dim 10, N = 32, n_r = 5, S = 48, 500 steps), timed;
   over 20 steps its replica 0 agrees with train_pairwise within rel 1e-4.
11. Triplet kernel vs plain (degree 3): batched_masked_pair_sum for the
   indicator and hinge combines on the JAX test's inputs (45x5 / 37x5,
   masks, ids, 29 visiting positives with ids 100+, through the
   factorised statistic, also held against the tiled scan), at a ragged
   size (1000 anchors x 4133 positives x 8197 negatives) and at a local
   round's batch (N = 8 workers x 1000 anchors, swr ids). Indicator sums
   must be equal, hinge sums within rel 1e-5. Then both sort-and-count
   routes (csrc/rank_count.cu) on edge-case distances (+-inf, NaN,
   +-0.0, ties between A and B), two groups, colliding ids: the
   indicator at margins 0 and 0.5, equal to plain with 0/1 masks, within
   rel 1e-6 with fractional ones; the hinge at margins 0, 0.5 and 1, NaN
   and inf where plain has them, finite sums within rel 1e-5.
12. Degree-3 main path at full width (the largest single-program cell of
   the JAX config-4 grid): Estimator(kernel, backend="torch") complete
   for both kernels at n = 32768 anchors/positives and 32768 negatives,
   d = 32 (3.5e13 triplets a call), local_average (N = 8),
   repartitioned (N = 8, T = 4) and incomplete (B = 2e4), after a warm-up
   at n = 1024, each timed with CUDA events. Then, outside the counted
   run: the kernel's per-anchor indicator sums for EVERY anchor equal an
   independent exact sort-count (K - searchsorted(sort(D_an[c]), D_pa[c],
   right=True)) on the same distances, and both statistics (indicator
   and hinge) equal the Estimator's within rel 1e-6; on a slice of 128
   anchors the kernel equals its plain version (hinge within rel 1e-5)
   and is timed against it, its yardstick (the indicator: the
   sort-count; the hinge: torch.sort + torch.cumsum + torch.searchsorted
   of A + margin) and the bound (both routes sort and count: the bytes
   of their inputs and partials), and at full width against the same
   yardsticks.
13. BASELINE config 4: triplet_mnist_statistic on the MNIST surrogate at
   n = 2000, incomplete (B = 2e4) and complete; the complete per-class
   values equal the CPU plain path's within rel 1e-6.
14. Triplet learner at the full width of scripts/learning_suite.py
   stage_triplet (N = 8, B = 4096, n_r = 1): the gauss-overlap cell (S = 8
   seeds, 300 steps) must end within 3 sqrt(se^2 + se_jax^2) of the
   committed JAX row and above each seed's initial accuracy; the
   mnist-surrogate cell (S = 1) >= 0.99; on the radial task (800 steps,
   S = 2) the MLP embedder must beat the linear one by 0.05. Steps/s.
15. Triplet resume is exact: 60 steps equal 20 steps, a checkpoint and 40
   resumed ones, bit for bit (params, losses, accuracy curve).
16. Count kernel vs plain (serving): kernel 6 (signed_count) against its
   plain version (comparison counting) and the torch.searchsorted chain,
   equal as integers: k = 6 runs (a ragged base of 1000003 values with
   duplicates, a -1 tombstone run of 4097, a +1 delta run | a second
   base, a -1 run, an empty run) for queries of 1/255, 255/1, 513/4099
   and 4099/513 with ties at run values; then the search's edge cases: k
   = 8 runs of mixed signs and sets, lengths 0, 1, 2, 3, 254, 255, 257
   and 30011 (+inf padded), -inf, +inf and -0.0 values, NaN, +-inf,
   +-0.0 and tied queries (kernel = plain, = searchsorted at every query
   that is not NaN; a NaN query counts 0); then at the headline (each
   class's base at cap 2^19, 512 queries a set, half of them run values)
   the three are timed, by CUDA events a call and by torch.profiler's
   device time a call, and the call is split by host timers (the argument
   checks, the ctypes marshalling and launch, the count layer's query
   copy up and block copy back, the whole count-layer call). The bound
   counts the 32-byte run sectors that binary searches of these queries
   read (replayed here), not the whole runs; the row prints the kernel's
   dependent rounds (count_kernels.signed_rounds) beside the replayed
   chain of the binary searches it replaced.
17. Serving index main path at bench.py _serving_kernel_cell's
   single-device size: 10^6 events of make_stream(seed=0) in float32,
   window 5e5, compact_every 1024, chunks of 256, through ExactAucIndex
   with count_kernel on and off, each warmed once on a 65536-event
   prefix. wins2 must be equal after every batch, the final auc() equal
   the float32 rank-AUC oracle of the window, and after seeding and
   compacting one launch of kernel 6 per micro-batch, no fallback.
   Events/s, insert p50/p99; then, outside the counted run, kernel 6 at
   the index's own final shape, with its call split.
18. Engine through replay at bench.py _streaming_events_per_sec's knobs,
   cut from its 300000 events to 100000 to leave the fleet phases room
   in the time limit: budget 64, max_batch 256, policy block, flush 0.5 ms,
   compact_every 1024, max_inflight 64, count_kernel on, warmup, with
   bg_compact on and off: auc_abs_err 0, every event applied, kernel 6
   launched. Events/s, latency p50/p99, insert-stage p99s and the
   host-tax split.
19. StreamingEstimator on the card at 10^5 events: its auc() equals the
   float32 rank-AUC oracle.
20. Tenant count kernel vs plain (the fleet): kernel 7 (tenant_count)
   against its plain version (comparison counting) and the batched
   torch.searchsorted route, equal as integers, at T_bucket 8 and 64
   with cap_pos != cap_neg, rows empty, full and with duplicates,
   queries tied to row values, q_bucket 256 and 1024. Then at the
   headline (T_bucket 1024, each class's pack filled with the final
   per-tenant runs of make_tenant_stream(10^6, 1024, skew 1.1, seed 0),
   caps 2^17, and one 256-event apply's query block) the three are
   timed, by CUDA events a call and by torch.profiler's device time a
   call. The bound counts the 32-byte row sectors that a lower and an
   upper binary search of these queries read (replayed here; the
   searches of the kernel before its redesign), the query blocks read
   once and the count block written once. The row prints the kernel's
   dependent rounds (count_kernels.tenant_rounds) beside the replayed
   chain of the earlier searches. Then the search's edge cases: NaN,
   +-inf and +-0.0 queries, ties on a run that spans the first
   halvings' probes, empty rows, caps 1, 3 and 2^17 + 5 and caps that
   differ between the sides: kernel = plain, and = searchsorted at every
   query that is not NaN (torch.searchsorted sorts NaN last, as the
   reference's jnp.searchsorted route does; the kernel and the JAX
   Pallas kernel count 0 there).
21. Fleet index main path at the headline: TenantFleetIndex fed
   make_tenant_stream(10^6, 1024, skew 1.1, seed 0) in float32,
   compact_every 128, chunks of 256 events coalesced per tenant (as
   bench.py's fleet leg), count_kernel on and off driven in lockstep,
   each warmed once on a 65536-event prefix: the touched tenants' wins2
   are equal between the routes after every apply, every tenant's auc()
   equals the float32 rank-AUC oracle of its events, and one launch of
   kernel 7 per apply, no fallback. Events/s, apply p50/p99,
   compactions, pack caps, bytes placed, full against dirty-row
   re-places, query and count bytes per apply.
21b. The incremental and whale path (bench.py _fleet_incremental_cell's
   knobs: T = 256, 40000 events, skew 1.1, compact_every 128,
   whale_threshold 1500, bg_compact on, chunks of 256), with no window
   and with a per-tenant window of 2048, each with the kernel on and off
   in lockstep: wins2 equal after every apply, promotions, and kernel 6
   launched for the whales and kernel 7 for the packs.
22. Fleet engine through replay_fleet (bench.py _multi_tenant_cell's
   knobs: budget 16, max_batch 256, policy block, flush 0.5 ms,
   compact_every 512, max_inflight 64, warmup) with count_kernel on at
   T = 1024, skew 1.1, 300000 events: tenant_auc_max_abs_err 0, every
   event applied, kernel 7 launched. Events/s, latency p50/p99, the
   worst and median tenant p99, and the host-tax split.
23. The distinct sampling designs (ops.device_design) on their paths at
   full width. (a) draw_pair_design_device at n = 10^6 a class, B = 10^4,
   64 rows a call, for swr, swor and bernoulli under
   torch.cuda.set_sync_debug_mode("error"), timed with CUDA events read
   after the mode is off: every swor row holds exactly B distinct
   tuples, the bernoulli sizes' mean lies within 5 standard errors of B.
   (b) Estimator("auc").incomplete at n = 10^6, B = 10^4, swor and
   bernoulli, each within 5 standard errors (the exact conditional form)
   of its complete statistic; the triplet indicator's swor incomplete on
   phase 12's data (n = 32768, d = 32, B = 2e4) within 5 of phase 12's
   complete value. (c) The harness at BASELINE config 3 (n = 10^6, B =
   10^4, M = 64) for swor and bernoulli: the variance / closed form in
   CHI2_BAND; the same run as 32 reps in chunks of 16 with a checkpoint,
   then resumed to 64, equals the straight run bit for bit. fix_data at
   n = 100 a class, B = G/2 = 5000, M = 800: each design's variance
   within 20 % of the exact conditional form, swor / swr in [0.4, 0.6].
   The three trade-off curves at n = 10^4, M = 64 (rounds 1 and 4, swor
   pairs 10^3 and 10^4, workers 2, 8 and 32), each cell in CHI2_BAND,
   and the looped degree-3 harness (complete and repartitioned, n = 512,
   d = 8, M = 8). (d) Budgeted hinge learners on phase 7's data (N = 8,
   B = 4096 a worker, 20 steps, swr, swor and bernoulli): steps/s and
   held-out AUC >= 0.75; the Adult surrogate of load_adult_splits() (N =
   1, B = 4096, lr 0.1, swor and bernoulli): held-out AUC >= 0.75; the
   triplet learner at phase 14's gauss-overlap cell (S = 8, 300 steps)
   with triplet_design="swor": above each seed's initial accuracy.
   (e) graft_entry (the logistic pair mean of a LinearScorer(dim=16) on
   two [2048, 16] blocks) against its plain version, within rel 1e-5.
24. Mesh ring (BASELINE config 5): Estimator(backend="mesh") on the
   card's worker axis of N = 8 (LocalComm). Complete auc and hinge at n
   = 10^7 a class, full (every stop kernel 1) and ragged (10^7 + 3 and
   10^7 - 5: every stop kernel 2), each call exactly 8 launches (one
   batched launch a stop): the auc equal to rank_auc's exact count
   (2 wins + ties) over 2 n1 n2, correctly rounded, and within one ulp
   of rank_auc's value (whose division on the card multiplies by a
   reciprocal), the hinge within
   rel 1e-10 of the single-device complete (float64 sums of the same
   float32 terms, grouped by other tiles); the (2, 4) mesh's ragged auc
   equal to the 1-D value; logistic at 2^20 a class within rel 1e-6 of
   the single-device complete; impl="plain" against the kernels on the
   same ring at n = 10^5 a class, full and ragged, on edge values and on
   lattice ties with +inf in a and -inf in b: auc and non-finite values
   equal, finite sums within rel 1e-5; the triplet indicator and hinge
   at n = 4096, d = 32 through the double ring (64 stops, 64 launches of
   kernel 5), the indicator equal to the single-device complete, the
   hinge within rel 1e-6; local, repartitioned (T = 4) and incomplete
   (swr, swor, B = 10^4) at n = 10^6, each within 5 standard errors
   (over 8 seeds) of the complete value; a one-rank NCCL group
   (DistComm, a file:// store) whose complete auc equals the worker axis
   of N = 1, and, on a machine of two or more cards, one rank a card
   against the worker axis of that N (the world size is printed). Then,
   after the launch counts are read, the timing: the ring's complete ms
   (CUDA events) and pairs/s at 10^7 beside the single-device complete,
   a stop's kernel and rotation ms (CUDA events; device time by kernel
   from torch.profiler where the profile captures any), the logistic
   ring at 2^20.
25. Elastic mesh (the batch path on a healed mesh, N = 8 on the card's
   worker axis): (a) the mesh trainer at phase 7's data (n = 5e5 a
   class, dim 5), 20 steps, hinge and logistic with loss_every=2, equal
   bit for bit to the mesh-less engine, steps/s and its launches of
   kernels 3 and 4; one full-shape step of both kernels ([8, 62500] x
   [8, 62500], the blocks of step 0) against plain as phase 6 holds
   them. (b) A chaos train_step fault dropping worker 3 on make_mesh(8,
   pool=12) with checkpoint_every=5: params and losses equal the
   fault-free run's bit for bit, one retry, the width kept, the heal's
   recovery_time_s. (c) The mesh triplet trainer at phase 14's
   gauss-overlap cell (seed 0, 300 steps, 10 evaluations through kernel
   5). (d) The harness on backend="mesh": config 1's four schemes (n =
   10^4, M = 64) in CHI2_BAND; config 5's complete auc at n = 10^7 a
   class, full and ragged, 4 reps (ms a rep, the 64-rep block's draw
   timed apart; rep 0 equal to the mesh Estimator on its rows). (e)
   Config 5 through Estimator(heal_retries=2, chaos=...) on make_mesh(8,
   pool=12), a fault dropping worker 3 and one dropping nobody, each
   equal to the fault-free value with one retry; on make_mesh(8), with
   no spare slot, HealExhaustedError. (f) A one-rank NCCL group's mesh
   trainer equal bit for bit to the worker axis of N = 1. (g)
   graft_entry.dryrun_multichip(8). Every fault-free run shows no retry.
26. Mesh serving (the mesh form of serving, S = 8 on the card's worker
   axis). (a) Phase 17's stream (10^6 events, window 5e5, chunks of
   256) through ExactAucIndex(shards=8) with count_kernel on and with
   the searchsorted route, in lockstep with the single-device index:
   wins2 equal after every batch, the auc equal to the float32 oracle,
   one worker-axis launch of kernel 6 a batch and 0 fallbacks, minor
   compactions and majors merged on the mesh (counted by wrapping the
   index's sharded_major_merge), bytes_h2d_saved > 0; events/s and
   insert p50/p99. (b) Heals on a 10^5-event stream: a sharded_count
   fault dropping worker 3 (8 -> 7), a place_base fault, a major_merge
   fault taking the counted host path; wins2 equal to the single-device
   index after every batch, reshard_events and recovery_time_s; on
   make_mesh(8) at fixed width, with no spare, HealExhaustedError. (c)
   TenantFleetIndex(shards=8) on phase 21's stream cut to 2e5 events (T =
   1024, Zipf 1.1) in lockstep with the single-device fleet, resized 8
   -> 4 -> 8 and healed after a drop of worker 5: per-tenant wins2 equal
   after every apply, every tenant's auc equal to its oracle, one
   worker-axis launch of kernel 7 an apply, dirty-row re-places
   dominant. (d) replay and replay_fleet at mesh_shards = 8 with
   bg_compact under a chaos schedule (a batcher crash, a compactor
   crash, a sharded_count drop, poison events): the index engine's auc
   equal to a fault-free replay of the admitted events, every tenant's
   auc equal to its oracle over the admitted events. (e) The sharded
   index on a one-rank NCCL group (DistComm) equal to the single-device
   index after every batch. Then, after the launch counts are read, the
   timing of kernels 6 and 7 over the worker axis (device time by
   torch.profiler, or by CUDA events where the profile holds none, ms a
   call, the bound, plain and the batched searchsorted twin): kernel 6
   at the mesh index's final runs and one batch's queries, kernel 7 at
   phase 21's packs split over 8 ([8, 1024, 2^14]) and one apply's
   queries.
27. Crash-safe serving and its observability (snapshots and the WAL,
   serving/recovery.py; the tracer, metrics export, sampling profiler and
   SLOs, obs/). (a) MicroBatchEngine with count_kernel on phase 17's
   stream cut to 7.5e5 events (window 5e5, requests of 256, snapshot_every
   4096), abandoned at 5e5 events with no close(), recovered and finished
   one request a batch beside the uninterrupted run's index (the engine
   without recovery over the same first half, then driven directly):
   wins2 and the AUC recorded after every batch equal, the final AUC the
   float32 oracle; events/s with recovery against the same half without it, the
   snapshots landed, capture and write ms (the recovery manager's spans),
   the wal_append and snapshot stage p99s, restore and tail replay
   seconds. (b) The sharded index (S = 8 on the card's worker axis,
   count_kernel) on phase 26(a)'s stream cut to 2e5 events (window 1e5),
   abandoned at 1.5e5 with a delta run and tombstones in its snapshot,
   recovered and finished in lockstep with the single-device index, one
   worker-axis launch of kernel 6 a recovered batch. (c) MultiTenantEngine
   with count_kernel on phase 21's stream cut to 1e5 events (T = 1024,
   Zipf 1.1, whale threshold 2048), abandoned after half its applies with
   a whale promoted, recovered and finished: every tenant's wins2 equal
   to an uninterrupted TenantFleetIndex's; snapshot keys and write ms.
   (d) A child process (tuplewise_tpu_torch/testing/serve_child.py,
   started before (b) so that its start overlaps (b) and (c)) serves the
   index engine on the card and acknowledges each insert; SIGKILLed
   after 12000 of 20000 events, the engine recovers in this process and
   finishes: the final AUC equals the float32 oracle. Each recovered
   engine's launches are read around its own work: one launch of kernel
   6 (flat in (a) and (d), over the worker axis in (b)) a replayed WAL
   record and a batch after; in (c) one launch of kernel 7 a fleet count
   (an apply holding a pack tenant) and one of kernel 6 a whale's count,
   each equal to the engine's own count of its kernel calls; the
   uninterrupted references' launches are counted apart. (e) replay over 10^5 events in requests of 16 with
   a Tracer, metrics_out, the sampling profiler and an SLO spec, against
   the same replay untraced (events/s, spans, the profiler's overhead
   fraction, the SLO verdicts); replay with profile_dir over 5000 events,
   and the torch.profiler trace's kernel names holding the count
   kernel's.
28. The control plane (serving/control.py), the doctor (obs/doctor.py)
   and the CLI (harness/cli.py). (a) replay_fleet over phase 21's stream
   cut to 4e4 events (T = 1024, Zipf 1.1), tenant t0's rate x 8 over the
   middle third, requests of one event, 64 in flight, a queue of 64,
   whales past 4096 events, under a saturation objective and
   insert_latency_s{tenant=*} p99 <= 50 ms, once without a controller and
   once with one (shed, flush, weights, promote): every tenant's AUC equal
   to the float32 oracle over its admitted events (so its wins2 too),
   at least one actuation, each carrying its triggering signal, no hard
   reject, a promotion; events/s of both runs, actuations by knob, typed
   sheds, hard rejects, the worst and median tenant p99. (b) A fleet
   engine at S = 2 on the card's worker axis under the mesh knob (up to 4
   workers) over the same stream's first 5e4 events, its SLO monitor
   pumped every 8 applies: a mesh_resize to 4 workers, every tenant's
   wins2 equal to a single-device fleet's over the same stream. (c) The
   CLI: train of 8 steps SIGKILLed by its chaos spec after its 2nd
   checkpoint and resumed (two processes), params_sha256 equal to an
   uninterrupted in-process run's; variance --scheme complete at 2^20 a
   class and triplet on the config-4 surrogate at n = 4096 (--n-pairs 0:
   the complete statistic), in-process; replay of 64 tenants with an
   SLO spec, a controller spec, metrics and flight dumps (a process of
   its own, started with the killed train at the phase's start), then
   doctor over its directory: every actuation attributed. The killed
   train and the replay start after (a), so that their start on the card
   overlaps (b) and not (a)'s measured replays.

The launch counters are set to 0 before phase 3 and read after phase 4,
set to 0 again before phase 7 and read after it, before phase 12 and
after it, before phase 14 and after it, before phase 17 and after it,
before phase 18 and after it, before each of phases 21, 21b and 22 and
after it, before phase 23 and after it, before phase 24 and after
its estimator calls (before its timing), and before phase 25 and after
it (less the references' own launches), and before phase 26 and after
its drives (before its timing), and before phase 27 and after it (the
recovered engines' own launches, read around their work), and before
phase 28 and after it (each part's launches read around it; the CLI's
processes are not counted): every
kernel must have been launched on
its path (pair sums on the estimator's, gradient kernels on
the trainer's, the triplet kernel on the degree-3 estimator's and on the
triplet learner's evaluations, the count kernel on the serving index's
and the engine's, the tenant count kernel on the fleet's and the fleet
engine's, kernel 6 on the promoted whales'; on the designs' path, kernel
1's auc body in the trade-off curves, its logistic body in graft_entry
and kernel 5's indicator in the looped degree-3 harness and the triplet
learner's evaluations; on the mesh's path kernels 1 and 2 for auc,
hinge and logistic and kernel 5 for both triplet kernels; on the
elastic path kernels 3 and 4 for both bodies in the mesh trainers,
kernels 1 and 2's auc in the mesh Monte-Carlo and the healed Estimator
and kernel 5's indicator in the mesh triplet trainer's evaluations; on
the mesh serving path kernels 6 and 7 over the worker axis and, on the
single-device twins in lockstep, their flat forms; on the recovery path
kernel 6 flat and over the worker axis and kernel 7, after every
recovery; on the control path kernel 7 under the controller, kernel 6 on
a promoted whale, kernel 7 over the worker axis under the mesh knob, and
kernels 1, 5 and 3 through the CLI's variance, triplet and train). The script
prints one JSON line of kernels,
the card's name and power limit as nvidia-smi reports them, and, last,
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, it exits nonzero and prints no result.

cuBLAS is made reproducible (CUBLAS_WORKSPACE_CONFIG=:4096:8, set before
the first CUDA call) so that the scorer's products, and with them the
resumed run of phase 8, repeat bit for bit; TF32 stays off.
"""

import concurrent.futures
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NAMES = ("auc", "hinge", "logistic")
SEED = 0
# chi2(63)/63 two-sided 1e-4 quantiles: the band of s^2 / sigma^2 for
# M = 64 reps; the plug-in closed form's own few-percent error fits in it
CHI2_BAND = (0.45, 1.85)
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per pair, counted from the body: the subtraction and
# the accumulating add, plus auc 3 (two compares, a select), hinge 2
# (1 - d, max), logistic 5 (abs, exp, log1p, max, add); the masked kernel
# adds a multiply. exp and log1p count as one operation each, which makes
# the bound a lower one.
OPS_PER_PAIR = {"auc": 5, "hinge": 4, "logistic": 7}
# the instruction issue rate of the card: 132 SMs x 4 schedulers x 32
# threads, one warp instruction a clock each, at the 1.98 GHz of the
# 67 TFLOP/s peak (thread instructions a second)
PEAK_ISSUE = 132 * 4 * 32 * 1.98e9
# the logistic gradient kernels, counted the same way: the subtraction,
# g' (exp, add, reciprocal, negation) and the row and col adds; the loss
# adds the g body (5, as above) and its add
GRAD_OPS_PER_PAIR = {"pair_grad_sums": 7, "pair_loss_grad": 13}
# the hinge gradient's operations: the radix sorts of both sides' 32-bit
# keys, 4 passes of 8 bits, each a digit extract and a scatter of each key
SORT_OPS_PER_KEY = 8
# the TPU kernel each timed row replaces, by wrapper
REPLACES = {
    "pair_sum": "tuplewise_tpu/ops/pallas_pairs.py:134",
    "masked_pair_sum": "tuplewise_tpu/ops/pallas_pairs.py:300",
    "pair_loss_grad": "tuplewise_tpu/ops/pallas_pairs.py:440",
    "pair_grad_sums": "tuplewise_tpu/ops/pallas_pairs.py:520",
    "batched_masked_pair_sum": "tuplewise_tpu/ops/pallas_triplets.py:185",
    "signed_count": "tuplewise_tpu/ops/pallas_counts.py:145",
    "tenant_count": "tuplewise_tpu/ops/pallas_counts.py:258",
}
# the CUDA source of each timed row: by row name where a body has its own
# route, else by wrapper (see source_of)
SOURCES = {
    "pair_sum[auc]": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "pair_sum[hinge]": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "masked_pair_sum[auc]": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "masked_pair_sum[hinge]": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "batched_masked_pair_sum": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "signed_count": "tuplewise_tpu_torch/csrc/signed_count.cu",
    "tenant_count": "tuplewise_tpu_torch/csrc/tenant_count.cu",
    "pair_sum": "tuplewise_tpu_torch/csrc/pair_sum.cu",
    "masked_pair_sum": "tuplewise_tpu_torch/csrc/pair_sum.cu",
    "pair_loss_grad[hinge]": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "pair_grad_sums[hinge]": "tuplewise_tpu_torch/csrc/rank_count.cu",
    "pair_loss_grad": "tuplewise_tpu_torch/csrc/pair_grad.cu",
    "pair_grad_sums": "tuplewise_tpu_torch/csrc/pair_grad.cu",
}
# kernel times of the routes this PR replaced, from the parent commit's
# run of this script on an NVIDIA H100 80GB HBM3 at 700 W (ms): printed
# beside this run's times, never written into the kernels line
EARLIER_MS = {
    "signed_count": 0.00713,
    "signed_count index": 0.00657,
}
EDGE_VALUES = (math.inf, -math.inf, math.nan, -math.nan, 0.0, -0.0, 1.0,
               -1.0, 1e-45, -1e-45)
GRAD_NAMES = ("hinge", "logistic")
TRIPLET_NAMES = ("triplet_indicator", "triplet_hinge")
# the largest single-program cell of the JAX package's config-4 grid
# (scripts/config_suite.py): n anchors/positives and n negatives, d = 32
TRIPLET_N, TRIPLET_D = 32768, 32
# anchors of the full-width problem on which the kernel is timed against
# its plain version and the sort-count
TRIPLET_SLICE = 128
# the committed JAX row of the gauss-overlap learner cell
# (results/learning_triplet.jsonl line 1): final test accuracy, its se
JAX_GAUSS_OVERLAP = (0.569129, 0.003846)
NEVER = 1 << 30
# the serving cells of bench.py: _serving_kernel_cell (single-device) and
# _streaming_events_per_sec
INDEX_EVENTS, INDEX_CHUNK, INDEX_COMPACT = 1_000_000, 256, 1024
INDEX_WARM_EVENTS = 1 << 16
ENGINE_EVENTS = 100_000     # _streaming_events_per_sec runs 300000
# kernel 6's headline: each class's base at cap 2^19, 512 queries a set
COUNT_BASE, COUNT_Q = 500_000, 512
# the fleet: bench.py _serving_kernel_cell's fleet leg at the fleet's own
# max_tenants and 10^6 events; _fleet_incremental_cell; _multi_tenant_cell
FLEET_EVENTS, FLEET_TENANTS, FLEET_SKEW = 1_000_000, 1024, 1.1
FLEET_CHUNK, FLEET_COMPACT, FLEET_WARM_EVENTS = 256, 128, 1 << 16
INCR_EVENTS, INCR_TENANTS, INCR_WHALE, INCR_WINDOW = 40_000, 256, 1500, 2048
FLEET_ENGINE_EVENTS = 300_000
# config 5 (BASELINE.json): cross-shard all-pairs on 8 shards at n = 10^7;
# the ragged shape pads every shard
MESH_WORKERS, MESH_N = 8, 10 ** 7
MESH_RAGGED = (MESH_N + 3, MESH_N - 5)
# the mesh form of serving (phase 26, at most 90 s): 8 workers on the
# card's worker axis; the fleet on phase 21's stream cut to 2e5 events, the
# heals' index stream 10^5 events, the engines 10000 and 6000 events, the
# one-rank NCCL index 20000
MESH_SERVE_WORKERS = 8
MESH_FLEET_EVENTS, MESH_HEAL_EVENTS = 200_000, 100_000
MESH_ENGINE_EVENTS, MESH_FLEET_ENGINE_EVENTS = 10_000, 6_000
MESH_NCCL_EVENTS = 20_000
# crash-safe serving and its observability (phase 27): (a) phase 17's
# stream and window (5e5), abandoned at 5e5 events and finished to 7.5e5
# (the whole 10^6 took 48-78 s alone: a capture at the full window costs
# 40-110 ms every 4096 events); (b) phase 26(a)'s stream cut to 2e5 events,
# abandoned at 1.5e5 (window 1e5: the tombstones are live); (c) phase
# 21's fleet cut to 1e5 events with whales past 2048 events; (d) a
# killed child at 12000 of 20000 events, started before (b); (e) traced
# replays of 1e5 events in requests of 16 and a torch.profiler trace of
# 5000 (2e4 took 14 s)
RECOVERY_WINDOW = INDEX_EVENTS // 2
RECOVERY_EVENTS, RECOVERY_CRASH_AT = 750_000, RECOVERY_WINDOW
RECOVERY_MESH_EVENTS, RECOVERY_MESH_CRASH_AT = 200_000, 150_000
RECOVERY_FLEET_EVENTS, RECOVERY_WHALE = 100_000, 2048
RECOVERY_KILL_EVENTS, RECOVERY_KILL_AT = 20_000, 12_000
RECOVERY_TRACED_EVENTS, RECOVERY_TRACED_CHUNK = 100_000, 16
RECOVERY_PROFILED_EVENTS = 5_000
# the control plane and the CLI (phase 28, at most 60 s): (a) phase 21's
# stream (T = 1024, Zipf 1.1) cut to 4e4 events, tenant t0's rate x 8 over
# the middle third, through replay_fleet with and without the controller
# (a run of 5e4 ran 2519-2903 events/s on an H100 80GB HBM3 at 700 W, so
# 2e5 would take 69-79 s a run);
# (b) its first 5e4 events on a fleet engine at S = 2 under the mesh knob
# (up to 4 workers); (c) the CLI: variance at 2^20 a class, triplet on the
# config-4 surrogate at n = 4096 (d = 32), train killed after its 2nd
# checkpoint and resumed, replay of 64 tenants and the doctor
CONTROL_EVENTS, CONTROL_FLASH, CONTROL_WHALE = 40_000, 8, 4096
CONTROL_WARM_EVENTS = 4096
CONTROL_MESH_EVENTS, CONTROL_MESH_SHARDS, CONTROL_MESH_MAX = 50_000, 2, 4
CONTROL_VARIANCE_N, CONTROL_TRIPLET_N = 1 << 20, 4096
CONTROL_REPLAY_EVENTS, CONTROL_REPLAY_TENANTS = 20_000, 64


def log(*a):
    print(*a, flush=True)


def source_of(row):
    """The CUDA source of a timed row ("<wrapper>[<body>]")."""
    return SOURCES.get(row, SOURCES.get(row.split("[")[0]))


def edge_values(gen, *shape):
    """Random normal values with 30 % drawn from EDGE_VALUES (+-inf, NaN
    of both signs, +-0.0, subnormals) and 20 % rounded to integers (heavy
    ties, more -0.0)."""
    x = torch.randn(*shape, generator=gen, device="cuda")
    pool = torch.tensor(EDGE_VALUES, device="cuda")
    at = torch.randint(0, len(EDGE_VALUES), shape, generator=gen,
                       device="cuda")
    x = torch.where(torch.rand(*shape, generator=gen, device="cuda") < 0.3,
                    pool[at], x)
    return torch.where(torch.rand(*shape, generator=gen, device="cuda") < 0.2,
                       x.round(), x)


def bytes_bound_ms(n_bytes):
    """The least time to move n_bytes at the HBM rate, in ms."""
    return n_bytes / PEAK_BYTES * 1e3


def cuda_ms(fn, reps=1):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def timed_on_device(fn, reps):
    """(milliseconds a call by CUDA events, milliseconds of device kernel
    time a call by torch.profiler, the last result). For a call that
    launches little work the two differ: the events also see the device
    wait for the host to enqueue the next call."""
    call_ms, out = cuda_ms(fn, reps)
    device_ms = sum(device_ms_by_kernel(fn, reps).values())
    assert device_ms > 0, "the profiler saw no device time"
    return call_ms, device_ms, out


def device_ms_by_kernel(fn, reps):
    """{kernel: ms of device time a call} of fn() over reps calls by
    torch.profiler, each kernel by its own name (no namespace, template
    arguments or parameters)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            name = re.match(r"[\w:]*", name).group(0).split("::")[-1] \
                or ev.name
            out[name] = out.get(name, 0.0) + (
                ev.time_range.end - ev.time_range.start) / 1e3 / reps
    return out


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from tuplewise_tpu_torch.ops import (
        _build, count_kernels, pair_grad_kernels, pair_kernels, rank_count,
        triplet_kernels,
    )

    t0 = time.perf_counter()
    sources = sorted({os.path.basename(p) for p in SOURCES.values()})
    reported = ("pair_sum.cu", "pair_grad.cu", "rank_count.cu",
                "signed_count.cu", "tenant_count.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 2) as ex:
        reports = {s: ex.submit(ptxas_report, s) for s in reported}
        list(ex.map(_build.build, sources))
    pair_kernels.load_library()
    pair_grad_kernels.load_library()
    rank_count.load_library()
    count_kernels.load_library()
    count_kernels.load_tenant_library()
    log(f"[build] {', '.join(sources)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS})")
    for source, report in reports.items():
        for line in report.result():
            log(f"[ptxas] {source}: {line}")
    sass = logistic_sass_per_pair(_build.build("pair_sum.cu"))
    sass.update(grad_sass_per_pair(_build.build("pair_grad.cu")))
    for (wrapper, branch), (n_instr, n_pairs) in sass.items():
        log(f"[sass] logistic {wrapper} {branch} loop: "
            f"{n_instr} instructions for {n_pairs} pairs, "
            f"{n_instr / n_pairs:.3f} a pair")
    return {k: n / m for k, (n, m) in sass.items()}


def ptxas_report(source):
    """What ptxas reports for each kernel of csrc/<source>: registers,
    stack frame, spills (a second nvcc, into a scratch directory)."""
    from tuplewise_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(d, "lib.so"), os.path.join(_build.CSRC, source)],
            capture_output=True, text=True, timeout=600, check=True)
    keep = ("Compiling entry", "Used", "spill")
    return [line.strip() for line in (out.stdout + out.stderr).splitlines()
            if any(k in line for k in keep)]


def sass_loops(lines):
    """The loops of one kernel's SASS listing (cuobjdump -sass, branch
    targets as addresses): for each backward branch, the instructions
    from its target to it."""
    import re

    instr, loops = [], []
    for line in lines:
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            instr.append((int(m.group(1), 16), m.group(2)))
    for i, (addr, text) in enumerate(instr):
        m = re.search(r"\bBRA(\.\S+)?\s.*?0x([0-9a-f]+)", text)
        if m and int(m.group(2), 16) <= addr:
            top = int(m.group(2), 16)
            loops.append([t for a, t in instr[:i + 1] if a >= top])
    return loops


def count_ops(loop, op):
    """Instructions of a SASS loop whose opcode starts with op (an
    instruction may carry a predicate: "@P0 MUFU.RCP R1, R2")."""
    return sum(1 for t in loop
               if t.split()[1 if t.startswith("@") else 0].startswith(op))


def logistic_sass_per_pair(lib_path):
    """{(wrapper, branch): (instructions, pairs)} of the hot loop of each
    branch of the logistic kernel, unmasked (pair_sum) and masked, from
    its SASS: the factored loop is the loop with the most MUFU.RCP (one a
    pair, the log1p's reciprocal) and no MUFU.EX2; the per-pair loop the
    one with the most MUFU.EX2 (one a pair, expf)."""
    return logistic_loops(cuobjdump_sass(lib_path))


def cuobjdump_sass(lib_path):
    from tuplewise_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def straight_segments(lines):
    """The straight-line runs of one kernel's SASS listing: cut before
    every branch target and after every branch."""
    import re

    instr, targets = [], set()
    for line in lines:
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            instr.append((int(m.group(1), 16), m.group(2)))
            t = re.search(r"\bBRA(\.\S+)?\s.*?0x([0-9a-f]+)", m.group(2))
            if t:
                targets.add(int(t.group(2), 16))
    segs, cur = [], []
    for addr, text in instr:
        if addr in targets and cur:
            segs.append(cur)
            cur = []
        cur.append(text)
        if re.search(r"\b(BRA|EXIT)\b", text):
            segs.append(cur)
            cur = []
    return segs + ([cur] if cur else [])


def grad_sass_per_pair(lib_path):
    """{(wrapper, branch): (instructions, pairs)} of the logistic
    gradient kernels' 256-pair chunk bodies, from their SASS: the
    factored body is the straight-line run with the most MUFU.RCP and no
    MUFU.EX2 (one RCP a pair for g', two with the loss), the per-pair
    body the run with the most MUFU.EX2 (one a pair). The reduce-scatter
    of each chunk's column sums (about 0.5 instructions a pair) is not in
    them."""
    return grad_loops(cuobjdump_sass(lib_path))


def grad_loops(sass):
    """grad_sass_per_pair's count on the text of a SASS listing."""
    funcs = sass.split("Function : ")[1:]
    res = {}
    for wrapper, mangled, rcp_per_pair in (("pair_grad_sums", "ILb0E", 1),
                                           ("pair_loss_grad", "ILb1E", 2)):
        body = [f for f in funcs if "logistic_grad_kernel" in f.split("\n")[0]
                and mangled in f.split("\n")[0]]
        assert len(body) == 1, [f.split("\n")[0] for f in funcs]
        segs = straight_segments(body[0].splitlines())
        fact = max((sg for sg in segs if count_ops(sg, "MUFU.EX2") == 0),
                   key=lambda sg: count_ops(sg, "MUFU.RCP"))
        per = max(segs, key=lambda sg: count_ops(sg, "MUFU.EX2"))
        res[wrapper, "factored"] = (len(fact), count_ops(fact, "MUFU.RCP")
                                    // rcp_per_pair)
        res[wrapper, "per-pair"] = (len(per), count_ops(per, "MUFU.EX2"))
    assert all(n > 0 and m > 0 for n, m in res.values()), res
    return res


def logistic_loops(sass):
    """logistic_sass_per_pair's count on the text of a SASS listing."""
    funcs = sass.split("Function : ")[1:]
    res = {}
    for wrapper, mangled in (("pair_sum", "ILb0E"),
                             ("masked_pair_sum", "ILb1E")):
        body = [f for f in funcs if "logistic_sum_kernel" in f.split("\n")[0]
                and mangled in f.split("\n")[0]]
        assert len(body) == 1, [f.split("\n")[0] for f in funcs]
        loops = sass_loops(body[0].splitlines())
        fact = max((lp for lp in loops if count_ops(lp, "MUFU.EX2") == 0),
                   key=lambda lp: count_ops(lp, "MUFU.RCP"))
        per = max(loops, key=lambda lp: count_ops(lp, "MUFU.EX2"))
        res[wrapper, "factored"] = (len(fact), count_ops(fact, "MUFU.RCP"))
        res[wrapper, "per-pair"] = (len(per), count_ops(per, "MUFU.EX2"))
    assert all(n > 0 and m > 0 for n, m in res.values()), res
    return res


def check_nonfinite(got, want, what, rtol=1e-5):
    """Hold a kernel result with NaN and infinities against its plain
    version: NaN positions equal, infinities equal, finite values within
    rel rtol. Returns the largest absolute error of the finite values."""
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan()), what
    inf = want.isinf()
    assert torch.equal(got.isinf(), inf), what
    assert torch.equal(got[inf], want[inf]), what
    fin = want.isfinite()
    if not fin.any():
        return 0.0
    err = (got[fin] - want[fin]).abs()
    rel = float((err / want[fin].abs().clamp_min(1e-30)).max())
    assert rel < rtol, (what, rel)
    return float(err.max())


def check_against_plain(name, got, want, count, what):
    """Assert a kernel result against its plain version (AUC exactly,
    hinge/logistic within rel 1e-5) and return the absolute error of the
    statistic the caller forms, sum / count."""
    torch.cuda.synchronize()
    if name == "auc":
        assert torch.equal(got, want), (name, what)
    else:
        rel = float(((got - want).abs() / want.abs()).max())
        assert rel < 1e-5, (name, what, rel)
    return float(((got - want) / count).abs().max())


def phase_kernel_vs_plain(errs):
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED)
    # ragged, batched, square, and the harness's local round (M = 64 reps
    # x N = 8 workers of 10^4 / 8 rows per class)
    for W, n1, n2 in [(1, 4133, 8197), (8, 4133, 8197), (1, 1 << 14, 1 << 14),
                      (512, 1250, 1250)]:
        a = torch.randn(W, n1, generator=g, device="cuda") + 1.0
        b = torch.randn(W, n2, generator=g, device="cuda")
        a[:, :97] = b[:, :97]                      # exact ties
        ma = (torch.rand(W, n1, generator=g, device="cuda") > 0.3).float()
        mb = (torch.rand(W, n2, generator=g, device="cuda") > 0.3).float()
        for name in NAMES:
            k = get_kernel(name)
            cases = {
                "pair_sum": (pk.pair_sum(a, b, k),
                             pk.pair_sum(a, b, k, impl="plain"),
                             float(n1 * n2)),
                "masked_pair_sum": (
                    pk.masked_pair_sum(a, b, ma, mb, k),
                    pk.masked_pair_sum(a, b, ma, mb, k, impl="plain"),
                    ma.sum(1, dtype=torch.float64)
                    * mb.sum(1, dtype=torch.float64)),
            }
            for wrapper, (got, want, count) in cases.items():
                err = check_against_plain(name, got, want, count,
                                          (wrapper, W, n1, n2))
                key = f"{wrapper}[{name}]"
                errs[key] = max(errs.get(key, 0.0), err)
        log(f"[kernel vs plain] W={W} {n1}x{n2}: auc exact, hinge/logistic "
            f"within rel 1e-5")
    # the auc body's edge cases: equal infinities score 0 (their
    # difference is NaN), NaN scores 0 against anything, -0.0 ties +0.0
    auc = get_kernel("auc")
    for W, n1, n2 in [(1, 1, 1), (3, 300, 517), (2, 20000, 17),
                      (1, 50, 40000), (3, 9000, 70000), (512, 1250, 1250)]:
        a, b = edge_values(g, W, n1), edge_values(g, W, n2)
        ma = (torch.rand(W, n1, generator=g, device="cuda") > 0.3).float()
        mb = (torch.rand(W, n2, generator=g, device="cuda") > 0.3).float()
        for wrapper, got, want, count in [
                ("pair_sum", pk.pair_sum(a, b, auc),
                 pk.pair_sum(a, b, auc, impl="plain"), float(n1 * n2)),
                ("masked_pair_sum", pk.masked_pair_sum(a, b, ma, mb, auc),
                 pk.masked_pair_sum(a, b, ma, mb, auc, impl="plain"),
                 (ma.sum(1, dtype=torch.float64)
                  * mb.sum(1, dtype=torch.float64)).clamp_min(1.0))]:
            err = check_against_plain("auc", got, want, count,
                                      (wrapper, "edge", W, n1, n2))
            key = f"{wrapper}[auc]"
            errs[key] = max(errs[key], err)
        log(f"[kernel vs plain] edge values W={W} {n1}x{n2}: auc and masked "
            f"auc equal to plain ({pk.pair_sum(a, b, auc).tolist()})")
        # hinge and logistic: a NaN difference gives NaN, d = -inf gives
        # +inf (and +inf times a zero mask NaN), d = +inf gives 0
        outcomes = []
        for name in ("hinge", "logistic"):
            k = get_kernel(name)
            for wrapper, got, want in [
                    ("pair_sum", pk.pair_sum(a, b, k),
                     pk.pair_sum(a, b, k, impl="plain")),
                    ("masked_pair_sum", pk.masked_pair_sum(a, b, ma, mb, k),
                     pk.masked_pair_sum(a, b, ma, mb, k, impl="plain"))]:
                check_nonfinite(got, want, (wrapper, name, "edge", W, n1, n2))
                outcomes += want.tolist()
        log(f"[kernel vs plain] edge values W={W} {n1}x{n2}: hinge and "
            f"logistic, masked and not, NaN and infinities where plain has "
            f"them, finite sums within rel 1e-5 ({sum(map(math.isnan, outcomes))}"
            f" NaN, {sum(map(math.isinf, outcomes))} inf of {len(outcomes)})")
    # infinities without NaN, one kind a problem: none, -inf in a and +inf
    # in b (d = -inf: +inf), +inf in a (d = +inf: 0): finite, +inf, +inf,
    # finite; with the infinities' masks 0, +inf * 0 makes problems 1-2 NaN
    a = torch.randn(4, 3000, generator=g, device="cuda")
    b = torch.randn(4, 5000, generator=g, device="cuda")
    a[1, 17], b[2, 4321], a[3, 2999] = -math.inf, math.inf, math.inf
    ones_a, ones_b = torch.ones_like(a), torch.ones_like(b)
    zero_a, zero_b = ones_a.clone(), ones_b.clone()
    zero_a[1, 17], zero_b[2, 4321] = 0.0, 0.0
    for name in ("hinge", "logistic"):
        k = get_kernel(name)
        for masks, want_inf, want_nan in [
                (None, [False, True, True, False], [False] * 4),
                ((ones_a, ones_b), [False, True, True, False], [False] * 4),
                ((zero_a, zero_b), [False] * 4, [False, True, True, False])]:
            if masks is None:
                got = pk.pair_sum(a, b, k)
                want = pk.pair_sum(a, b, k, impl="plain")
            else:
                got = pk.masked_pair_sum(a, b, *masks, k)
                want = pk.masked_pair_sum(a, b, *masks, k, impl="plain")
            check_nonfinite(got, want, ("infinities", name, masks is None))
            assert want.isinf().tolist() == want_inf, (name, want)
            assert want.isnan().tolist() == want_nan, (name, want)
    log("[kernel vs plain] infinities without NaN: hinge and logistic sums "
        "+inf where plain is +inf, NaN where a zero mask meets +inf")
    phase_masked_routes(g, errs)
    # the unmasked hinge's sort-and-search route: b past one tile with a
    # short last tile, a -inf score of a and a +inf of b, pairs at d == 1
    # exactly (scores on a 1/4 lattice: every difference and term exact,
    # so finite sums equal plain), the harness's W = 512 x 1250; a second
    # call repeats the first bit for bit
    hinge = get_kernel("hinge")
    for W, n1, n2 in [(3, 4133, (1 << 14) + 97), (512, 1250, 1250),
                      (2, 70000, 2049), (4, 1, (1 << 14) + 1)]:
        a = torch.round((torch.randn(W, n1, generator=g, device="cuda")
                         + 1.0) * 4) / 4
        b = torch.round(torch.randn(W, n2, generator=g, device="cuda") * 4) / 4
        k = min(97, n1, n2)
        b[:, :k] = a[:, :k] - 1.0
        a[W - 1, n1 // 2], b[W // 2, n2 - 1] = -math.inf, math.inf
        got = pk.pair_sum(a, b, hinge)
        want = pk.pair_sum(a, b, hinge, impl="plain")
        again = pk.pair_sum(a, b, hinge)
        assert torch.equal(got.view(torch.int64), again.view(torch.int64))
        check_nonfinite(got, want, ("hinge route", W, n1, n2))
        fin = want.isfinite()
        assert torch.equal(got[fin], want[fin]), ("hinge route", W, n1, n2)
        log(f"[kernel vs plain] hinge route W={W} {n1}x{n2} (d == 1 ties, "
            f"-inf in a, +inf in b, ragged tiles): {int(fin.sum())} finite "
            f"sums equal to plain, {int((~fin).sum())} +inf as plain")
    # blocks with a few non-finite scores beside all-finite ones, so that
    # the logistic kernel's two branches meet in one launch
    for W, n1, n2 in [(8, 3000, 5000), (1, 1 << 14, 1 << 14)]:
        a = torch.randn(W, n1, generator=g, device="cuda")
        b = torch.randn(W, n2, generator=g, device="cuda")
        a[0, n1 // 3], a[W - 1, n1 - 1] = math.nan, math.inf
        b[W // 2, n2 // 2], b[0, 7] = -math.inf, -0.0
        for name in ("hinge", "logistic"):
            k = get_kernel(name)
            check_nonfinite(pk.pair_sum(a, b, k),
                            pk.pair_sum(a, b, k, impl="plain"),
                            ("pair_sum", name, "sparse edge", W, n1, n2))
        fac, per, _ = pk.logistic_branch_blocks(a, b)
        log(f"[kernel vs plain] sparse edge values W={W} {n1}x{n2}: hinge "
            f"and logistic as plain; logistic blocks factored {fac}, "
            f"per-pair {per}")
        assert fac > 0 and per > 0, (fac, per)
    # the logistic kernel's two branches on finite scores up to |d| = 100:
    # a narrow cluster far from 0 (factored about c != 0) beside a spread
    # of [-50, 50] (per-pair)
    n = 1 << 14
    for c0 in (0.0, 300.0):
        a = torch.cat([torch.randn(n, generator=g, device="cuda") + c0 + 1,
                       torch.rand(n, generator=g, device="cuda") * 100 - 50])
        b = torch.cat([torch.randn(n, generator=g, device="cuda") + c0,
                       torch.rand(n, generator=g, device="cuda") * 100 - 50])
        b[:97] = a[:97]
        fac, per, got = pk.logistic_branch_blocks(a[None], b[None])
        want = pk.pair_sum(a[None], b[None], get_kernel("logistic"),
                           impl="plain")
        err = check_against_plain("logistic", got, want, float(4 * n * n),
                                  ("pair_sum", "wide", c0))
        errs["pair_sum[logistic]"] = max(errs["pair_sum[logistic]"], err)
        log(f"[kernel vs plain] logistic 2 x {n} scores about {c0} and over "
            f"[-50, 50]: within rel 1e-5 of plain; blocks factored {fac}, "
            f"per-pair {per}")
        assert fac > 0 and per > 0, (fac, per)


def mask_weights(gen, kind, *shape):
    """{0, 1} masks (30 % zeros), {-1, 0, 1} weights ("ternary"), or
    fractional weights in [0, 2) ("fractional") or in (-2, 2) ("signed")
    with 20 % zeros."""
    u = torch.rand(*shape, generator=gen, device="cuda")
    if kind == "binary":
        return (u > 0.3).float()
    if kind == "ternary":
        return torch.randint(-1, 2, shape, generator=gen,
                             device="cuda").float()
    w = torch.rand(*shape, generator=gen, device="cuda") * 2.0
    if kind == "signed":
        w = torch.where(torch.rand(*shape, generator=gen, device="cuda")
                        < 0.5, -w, w)
    return torch.where(u < 0.2, torch.zeros((), device="cuda"), w)


def half_ulp(x):
    """Half the float32 ulp at |x|, as float64."""
    x = x.abs()
    up = torch.nextafter(x, torch.full_like(x, math.inf))
    return (up - x).double() * 0.5


def masked_gap(name, a, b, ma, mb):
    """[W]: the largest |route - plain| of kernel 2's masked auc or hinge
    route that the plain version's float32 rounding allows (derived in
    tests/test_torch_masked_routes.py): the roundings of plain's products
    fl(fl(g mb) ma), exact in float64; for the hinge also, over the pairs
    with finite fl(a - b) < 1, half an ulp of fl(a - b) and of fl(1 - d)
    times |mb ma|. In tiles of the plain version's size; weights of either
    sign enter by their magnitude."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    body = get_kernel(name).diff
    W, n1 = a.shape
    n2 = b.shape[1]
    rows, cols = pk.plain_tile(a, n2)
    total = torch.zeros(W, dtype=torch.float64, device=a.device)
    for j0 in range(0, n2, cols):
        mbj = mb[:, None, j0:j0 + cols]
        for i0 in range(0, n1, rows):
            mai = ma[:, i0:i0 + rows, None]
            d = a[:, i0:i0 + rows, None] - b[:, None, j0:j0 + cols]
            g = body(d)
            p1 = g * mbj
            p2 = p1 * mai
            gap = ((p1.double() - g.double() * mbj.double()).abs()
                   * mai.double().abs()
                   + (p2.double() - p1.double() * mai.double()).abs())
            if name == "hinge":
                gap = torch.where(
                    (d < 1) & d.isfinite(),
                    gap + (half_ulp(d) + half_ulp(g))
                    * (mai.double() * mbj.double()).abs(),
                    torch.zeros((), dtype=torch.float64, device=a.device))
            total += gap.sum(dim=(1, 2))
    return total


def check_masked_route(name, a, b, ma, mb, exact, what, rtol=1e-5):
    """Kernel 2's masked auc or hinge route against its plain version: two
    calls bit-equal; NaN and inf where plain has them; finite sums equal
    where `exact`, else within masked_gap plus a float64 slack (1e-12 of
    the sum), and within rel rtol. With weights of both signs a sum
    cancels, and the gap, of the terms' magnitudes, is the one tolerance
    (rtol inf). Returns the largest error of the mean, sum / (sum|ma|
    sum|mb|), over the finite sums, and the plain sums."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    k = get_kernel(name)
    got = pk.masked_pair_sum(a, b, ma, mb, k)
    again = pk.masked_pair_sum(a, b, ma, mb, k)
    want = pk.masked_pair_sum(a, b, ma, mb, k, impl="plain")
    assert torch.equal(got.view(torch.int64), again.view(torch.int64)), what
    check_nonfinite(got, want, what, rtol)
    fin = want.isfinite()
    if not fin.any():
        return 0.0, want
    err = (got - want).abs()[fin]
    if exact:
        assert torch.equal(got[fin], want[fin]), what
    gap = masked_gap(name, a, b, ma, mb)[fin]
    assert (err <= gap + 1e-12 * want[fin].abs()).all(), (
        what, float((err - gap).max()))
    count = (ma.abs().sum(1, dtype=torch.float64)
             * mb.abs().sum(1, dtype=torch.float64)).clamp_min(1.0)
    return float((err / count[fin]).max()), want


def phase_masked_routes(g, errs):
    """Kernel 2's masked auc and hinge routes (csrc/rank_count.cu) in phase
    2: {0, 1}, {-1, 0, 1} and fractional weights of one or either sign, b
    past one 8192- and one 16384-value tile with a short last tile, the
    harness's W = 512 x 1250, lattice scores (heavy ties, d == 0 and d ==
    1), infinities of weight 0 and infinities facing a zero weight, the
    inputs where a negative weight sets the sign of an infinity, and edge
    values."""
    for W, n1, n2, lattice in [(3, 4133, 8192 + 97, False),
                               (2, 3000, (1 << 14) + 5, True),
                               (512, 1250, 1250, False), (1, 1, 1, False)]:
        a = torch.randn(W, n1, generator=g, device="cuda") + 1.0
        b = torch.randn(W, n2, generator=g, device="cuda")
        if lattice:
            a, b = torch.round(a * 4) / 4, torch.round(b * 4) / 4
        k = min(97, n1, n2)
        a[:, :k] = b[:, :k]                        # d == 0
        b[:, k:2 * k] = a[:, k:2 * k] - 1.0        # d == 1
        for weights in ("binary", "fractional", "ternary", "signed"):
            ma = mask_weights(g, weights, W, n1)
            mb = mask_weights(g, weights, W, n2)
            for name in ("auc", "hinge"):
                exact = (weights in ("binary", "ternary")
                         and (name == "auc" or lattice))
                rtol = (1e-5 if weights in ("binary", "fractional")
                        else math.inf)
                err, _ = check_masked_route(name, a, b, ma, mb, exact,
                                            ("masked route", name, weights,
                                             W, n1, n2), rtol)
                key = f"masked_pair_sum[{name}]"
                errs[key] = max(errs[key], err)
        log(f"[kernel vs plain] masked routes W={W} {n1}x{n2}"
            f"{' (lattice)' if lattice else ''}: auc equal to plain with "
            f"{{0, 1}} and {{-1, 0, 1}} weights and hinge too on the "
            f"lattice, fractional weights of either sign within the derived "
            f"gap; two calls bit-equal")
    # infinities without NaN, fractional weights otherwise > 0, one case a
    # problem: none; -inf in a (+inf); -inf in a of weight 0 (NaN); +inf in
    # b facing a zero weight in a (NaN); +inf in b of weight 0 (NaN); +inf
    # in a and -inf in b (finite)
    W, n1, n2 = 6, 3000, (1 << 14) + 97
    a = torch.randn(W, n1, generator=g, device="cuda")
    b = torch.randn(W, n2, generator=g, device="cuda")
    ma = torch.rand(W, n1, generator=g, device="cuda") + 0.5
    mb = torch.rand(W, n2, generator=g, device="cuda") + 0.5
    a[1, 17] = a[2, 17] = -math.inf
    a[5, 2999] = math.inf
    b[3, 16400] = b[4, 5] = math.inf
    b[5, 16480] = -math.inf
    ma[2, 17] = ma[3, 100] = mb[4, 5] = 0.0
    want_inf = [False, True, False, False, False, False]
    want_nan = [False, False, True, True, True, False]
    for name in ("auc", "hinge"):
        err, want = check_masked_route(name, a, b, ma, mb, False,
                                       ("masked infinities", name))
        errs[f"masked_pair_sum[{name}]"] = max(
            errs[f"masked_pair_sum[{name}]"], err)
    assert want.isinf().tolist() == want_inf, want
    assert want.isnan().tolist() == want_nan, want
    # negative weights, one case a problem: none; -inf in a of weight < 0
    # (-inf); +inf in b of weight < 0 (-inf); +inf in b of weights of both
    # signs (NaN); -inf in a against weights of b all < 0 (-inf); the same
    # with a's weight < 0 (+inf)
    ma = torch.rand(W, n1, generator=g, device="cuda") + 0.5
    mb = torch.rand(W, n2, generator=g, device="cuda") + 0.5
    a = torch.randn(W, n1, generator=g, device="cuda")
    b = torch.randn(W, n2, generator=g, device="cuda")
    a[1, 17] = a[4, 17] = a[5, 17] = -math.inf
    b[2, 16400] = b[3, 5] = b[3, 9000] = math.inf
    ma[1, 17] = ma[5, 17] = -0.7
    mb[2, 16400] = mb[3, 5] = -1.3
    mb[4:] = -mb[4:]
    for name in ("auc", "hinge"):
        err, want = check_masked_route(name, a, b, ma, mb, False,
                                       ("masked negative weights", name))
        errs[f"masked_pair_sum[{name}]"] = max(
            errs[f"masked_pair_sum[{name}]"], err)
    assert want[1:].tolist()[:2] == [-math.inf] * 2, want
    assert want[3].isnan() and want[4:].tolist() == [-math.inf, math.inf], \
        want
    # the four W = 1 inputs where a negative weight decides the hinge's
    # infinity (plain: -inf, NaN, -inf, -inf)
    inf = math.inf
    for row in ([[0.5, 0.0], [inf, 0.3], [1.0, 1.0], [-1.0, 1.0]],
                [[0.5, 0.0], [inf, inf], [1.0, 1.0], [1.0, -1.0]],
                [[-inf, 0.0], [0.1, 0.3], [1.0, 1.0], [-2.0, -1.0]],
                [[-inf, 0.0], [0.1, 0.3], [-1.0, 1.0], [1.0, 1.0]]):
        a, b, ma, mb = (torch.tensor([x], device="cuda") for x in row)
        for name in ("auc", "hinge"):
            check_masked_route(name, a, b, ma, mb, False,
                               ("negative-weight input", name, row))
    # edge values (+-inf, NaN of both signs, +-0.0, subnormals, ties) with
    # fractional weights, ragged tiles, and sparse ones at W = 512 x 1250
    for W, n1, n2, frac in [(3, 300, (1 << 14) + 517, 0.3),
                            (2, 2000, 8192 + 3, 0.3),
                            (512, 1250, 1250, 1e-4)]:
        a = (edge_values(g, W, n1) if frac == 0.3
             else sparse_edge(g, frac, W, n1))
        b = (edge_values(g, W, n2) if frac == 0.3
             else sparse_edge(g, frac, W, n2))
        for weights in ("fractional", "signed"):
            ma = mask_weights(g, weights, W, n1)
            mb = mask_weights(g, weights, W, n2)
            outcomes = []
            for name in ("auc", "hinge"):
                err, want = check_masked_route(
                    name, a, b, ma, mb, False,
                    ("masked edge", name, weights, W, n1, n2),
                    1e-5 if weights == "fractional" else math.inf)
                errs[f"masked_pair_sum[{name}]"] = max(
                    errs[f"masked_pair_sum[{name}]"], err)
                outcomes += want.tolist()
            log(f"[kernel vs plain] masked routes, edge values W={W} "
                f"{n1}x{n2} {weights} weights: as plain "
                f"({sum(map(math.isnan, outcomes))} NaN, "
                f"{sum(map(math.isinf, outcomes))} inf of {len(outcomes)})")
    log("[kernel vs plain] masked routes, infinities of weight 0, facing a "
        "zero weight and meeting negative weights: NaN where plain is NaN, "
        "+-inf where it is +-inf; the four negative-weight inputs as plain")


def ragged_blocks(gen, n, n_workers):
    """A partition of range(n) that keeps every row: blocks of
    ceil(n/N) or floor(n/N) rows, padded with -1."""
    perm = torch.randperm(n, generator=gen, device="cuda")
    m = -(-n // n_workers)
    blocks = torch.full((n_workers * m,), -1, dtype=torch.int64, device="cuda")
    sizes = [n // n_workers + (w < n % n_workers) for w in range(n_workers)]
    at = 0
    for w, size in enumerate(sizes):
        blocks[w * m:w * m + size] = perm[at:at + size]
        at += size
    return blocks.reshape(n_workers, m)


def phase_main_path(launches_by_phase):
    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.data import true_gaussian_auc
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.rank_auc import rank_auc

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    truth = true_gaussian_auc(1.0)

    def scores(n):
        return (torch.randn(n, generator=g, device="cuda") + 1.0,
                torch.randn(n, generator=g, device="cuda"))

    def snapshot(label, before):
        delta = {k: v - before.get(k, 0) for k, v in pk.LAUNCHES.items()
                 if v - before.get(k, 0)}
        launches_by_phase[label] = delta
        return dict(pk.LAUNCHES)

    seen = dict(pk.LAUNCHES)
    for n in (1 << 20, (1 << 20) + 64):
        s1, s2 = scores(n)
        for name in NAMES:
            est = Estimator(name, backend="torch", auc_fast=False)
            ms, val = cuda_ms(lambda: est.complete(s1, s2))
            assert math.isfinite(val), (name, n, val)
            log(f"[main] complete {name:8s} n={n}: {val:.9f}  "
                f"{n * n / ms * 1e3:.4g} pairs/s ({ms:.1f} ms)")
            if name == "auc":
                exact = float(rank_auc(s1, s2))
                assert val == exact, (val, exact)
                assert val == Estimator("auc", backend="torch").complete(s1, s2)
                assert abs(val - truth) < 5e-3, (val, truth)
    seen = snapshot("complete", seen)

    n = 10 ** 6
    s1, s2 = scores(n)
    for name in NAMES:
        est = Estimator(name, backend="torch", n_workers=8)
        full = est.complete(s1, s2)
        ms, loc = cuda_ms(lambda: est.local_average(s1, s2, seed=SEED))
        ms_r, rep = cuda_ms(lambda: est.repartitioned(s1, s2, n_rounds=4,
                                                      seed=SEED))
        ms_i, inc = cuda_ms(lambda: est.incomplete(s1, s2, n_pairs=10_000,
                                                   seed=SEED))
        for v, tol in [(loc, 0.01), (rep, 0.01), (inc, 0.1)]:
            assert math.isfinite(v) and abs(v - full) < tol, (name, v, full)
        per_round = 8 * (n // 8) ** 2
        log(f"[main] {name:8s} n={n} complete {full:.6f} local {loc:.6f} "
            f"({per_round / ms * 1e3:.4g} pairs/s) repartitioned(T=4) "
            f"{rep:.6f} ({4 * per_round / ms_r * 1e3:.4g} pairs/s) "
            f"incomplete(B=1e4) {inc:.6f} ({ms_i:.3f} ms)")
    seen = snapshot("local+repartitioned", seen)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    s1, s2 = scores(n + 5)
    i1, i2 = ragged_blocks(gen, n + 5, 8), ragged_blocks(gen, n, 8)
    for name in NAMES:
        be = Estimator(name, backend="torch").backend
        ms, val = cuda_ms(
            lambda: float(be.local_round_from_blocks(s1, s2, i1, i2)))
        full = Estimator(name, backend="torch").complete(s1, s2)
        assert math.isfinite(val) and abs(val - full) < 0.01, (name, val)
        log(f"[main] ragged local round {name:8s} (blocks of "
            f"{i1.shape[1]}/{i1.shape[1] - 1} rows): {val:.6f} ({ms:.3f} ms)")
    snapshot("ragged local round", seen)
    return i1, i2


def phase_harness(launches_by_phase):
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, run_variance_experiment,
    )
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    before = dict(pk.LAUNCHES)
    for scheme in ("complete", "local", "repartitioned", "incomplete"):
        cfg = VarianceConfig(kernel="auc", scheme=scheme, n_pos=10_000,
                             n_neg=10_000, n_workers=8, n_rounds=4,
                             n_pairs=10_000, n_reps=64, seed=SEED)
        run_variance_experiment(cfg)               # first use: warm-up
        r = run_variance_experiment(cfg)
        ratio = r["variance"] / r["closed_form_variance"]
        log(f"[harness] {scheme:13s} M=64 mean {r['mean']:.6f} var "
            f"{r['variance']:.4e} closed form {r['closed_form_variance']:.4e} "
            f"ratio {ratio:.3f} ({r['wallclock_s'] * 1e3:.1f} ms)")
        assert CHI2_BAND[0] < ratio < CHI2_BAND[1], (scheme, ratio)
        assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]
    launches_by_phase["harness"] = {
        k: v - before.get(k, 0) for k, v in pk.LAUNCHES.items()
        if v - before.get(k, 0)}


def bound_ms(name, pairs, masked, n_inputs):
    ops = pairs * (OPS_PER_PAIR[name] + (1 if masked else 0))
    byts = 4 * n_inputs + 8
    return max(ops / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, (
        "operations" if ops / PEAK_FP32_OPS >= byts / PEAK_BYTES else "bytes")


def logistic_fields(sass, wrapper, pairs, fac, per):
    """The logistic row's extra keys: the blocks of each branch in one
    launch at the row's shape, the SASS instructions a pair of the hot
    loops (weighted by the blocks of each branch) and the time they take
    at the card's issue rate."""
    ipp = ((fac * sass[wrapper, "factored"] + per * sass[wrapper, "per-pair"])
           / (fac + per))
    return dict(blocks_factored=fac, blocks_per_pair=per,
                sass_per_pair=ipp, issue_bound_ms=pairs * ipp / PEAK_ISSUE * 1e3)


def phase_timing(errs, launches, i1, i2, sass):
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops import rank_count
    from tuplewise_tpu_torch.ops.kernels import get_kernel
    from tuplewise_tpu_torch.ops.rank_auc import rank_auc

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n = 1 << 20
    a = torch.randn(n, generator=g, device="cuda") + 1.0
    b = torch.randn(n, generator=g, device="cuda")
    # the ragged local round's worker blocks, as the main path gave them
    ab = torch.randn(i1.shape, generator=g, device="cuda")
    bb = torch.randn(i2.shape, generator=g, device="cuda")
    ma, mb = (i1 >= 0).float(), (i2 >= 0).float()
    masked_pairs = float((ma.sum(1, dtype=torch.float64)
                          * mb.sum(1, dtype=torch.float64)).sum())
    rows = []
    for name in NAMES:
        k = get_kernel(name)
        reps = 3 if name == "logistic" else 20  # the sort routes: < 1 ms
        cuda_ms(lambda: pk.pair_sum(a, b, k))                 # warm-up
        ms, got = cuda_ms(lambda: pk.pair_sum(a, b, k), reps=reps)
        plain_ms, want = cuda_ms(lambda: pk.pair_sum(a, b, k, impl="plain"))
        err = check_against_plain(name, got, want, float(n * n),
                                  ("pair_sum", 1, n, n))
        library_ms = None
        if name == "auc":
            cuda_ms(lambda: rank_auc(a, b))
            library_ms, _ = cuda_ms(lambda: rank_auc(a, b), reps=reps)
            # sort-and-count: the scores read once, the int64 partials
            # (one a tile of b and chunk of a) written once
            T = rank_count.tile_size(n)
            partials = -(-n // T) * -(-n // rank_count.COUNT_CHUNK)
            bms, by = bytes_bound_ms(4 * 2 * n + 8 * partials), "bytes"
        elif name == "hinge":
            cuda_ms(lambda: hinge_sum_library(a[None], b[None]))
            library_ms, lib = cuda_ms(
                lambda: hinge_sum_library(a[None], b[None]), reps=reps)
            log(f"[timing] pair_sum[hinge] yardstick (sort + cumsum + "
                f"searchsorted, raw comparisons): rel diff to the kernel "
                f"{float((lib[0] - got).abs() / got.abs()):.3g}")
            bms, by = hinge_sum_bound_ms(n, n, 1)
        else:
            bms, by = bound_ms(name, float(n * n), False, 2 * n)
        extra = {}
        if name == "logistic":
            fac, per, _ = pk.logistic_branch_blocks(a[None], b[None])
            extra = logistic_fields(sass, "pair_sum", float(n * n), fac, per)
        rows.append(dict(
            name=f"pair_sum[{name}]", route="cuda",
            source=source_of(f"pair_sum[{name}]"),
            replaces=REPLACES["pair_sum"],
            launches=launches.get(f"pair_sum[{name}]", 0),
            max_abs_err=err, max_abs_err_small=errs[f"pair_sum[{name}]"],
            ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=library_ms,
            shape=f"W=1 {n}x{n}", **extra))
        cuda_ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, k))
        ms, got = cuda_ms(lambda: pk.masked_pair_sum(ab, bb, ma, mb, k),
                          reps=reps)
        plain_ms, want = cuda_ms(
            lambda: pk.masked_pair_sum(ab, bb, ma, mb, k, impl="plain"))
        err = check_against_plain(
            name, got, want,
            ma.sum(1, dtype=torch.float64) * mb.sum(1, dtype=torch.float64),
            ("masked_pair_sum", *i1.shape, i2.shape[1]))
        if name == "logistic":
            bms, by = bound_ms(name, masked_pairs, True,
                               2 * (i1.numel() + i2.numel()))
        else:
            bms, by = masked_sum_bound_ms(name, i1.shape[1], i2.shape[1],
                                          i1.shape[0])
        library_ms = None
        if name != "logistic":
            cuda_ms(lambda: masked_pair_library(name, ab, bb, ma, mb))
            library_ms, lib = cuda_ms(
                lambda: masked_pair_library(name, ab, bb, ma, mb), reps=reps)
            log(f"[timing] masked_pair_sum[{name}] yardstick (sort + cumsum "
                f"+ searchsorted with the mask weights): largest rel diff to "
                f"the kernel {float(((lib - got).abs() / got.abs()).max()):.3g}")
        extra = {}
        if name != "logistic":
            # the route's launches: the sort, the search, the finish
            extra["kernel_ms"] = device_ms_by_kernel(
                lambda: pk.masked_pair_sum(ab, bb, ma, mb, k), reps)
            log(f"[timing] masked_pair_sum[{name}] device ms a call by "
                f"kernel: {json.dumps(extra['kernel_ms'])}")
        if name == "logistic":
            fac, per, _ = pk.logistic_branch_blocks(ab, bb, ma, mb)
            extra = logistic_fields(sass, "masked_pair_sum",
                                    float(i1.numel()) * i2.shape[1], fac, per)
        rows.append(dict(
            name=f"masked_pair_sum[{name}]", route="cuda",
            source=source_of(f"masked_pair_sum[{name}]"),
            replaces=REPLACES["masked_pair_sum"],
            launches=launches.get(f"masked_pair_sum[{name}]", 0),
            max_abs_err=err,
            max_abs_err_small=errs[f"masked_pair_sum[{name}]"], ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=library_ms,
            shape=f"W={i1.shape[0]} {i1.shape[1]}x{i2.shape[1]}", **extra))
        for r in rows[-2:]:
            log(f"[timing] {r['name']:24s} {r['shape']:22s} {r['ms']:10.4f} ms"
                f" (bound {r['bound_ms']:.4g} ms by {r['bound_by']}, plain "
                f"{r['plain_ms']:.1f} ms, library {r['library_ms']}, parent "
                f"commit {EARLIER_MS.get(r['name'])} ms); error of the mean "
                f"vs plain {r['max_abs_err']:.3g}")
            if "sass_per_pair" in r:
                log(f"[timing] {r['name']}: blocks factored "
                    f"{r['blocks_factored']}, per-pair {r['blocks_per_pair']};"
                    f" {r['sass_per_pair']:.3f} SASS instructions a pair, "
                    f"issue bound {r['issue_bound_ms']:.2f} ms")
    return rows


def grad_bound_ms(wrapper, name, n1, n2, W):
    """Bound of a gradient kernel. Bytes: the scores read once, row and
    col written once, the loss. Operations: the logistic sweep's pairs at
    the FP32 peak; the hinge route's sorts of both sides' keys (its
    searches are this design's choice, not work the function needs)."""
    byts = 4 * 2 * W * (n1 + n2) + 8 * W
    if name == "hinge":
        ops = SORT_OPS_PER_KEY * W * (n1 + n2)
    else:
        ops = float(n1) * n2 * W * GRAD_OPS_PER_PAIR[wrapper]
    by = "operations" if ops / PEAK_FP32_OPS >= byts / PEAK_BYTES else "bytes"
    return max(ops / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by


def hinge_grad_library(a, b, with_loss):
    """The hinge rows' yardstick: PyTorch's sort and searchsorted (and a
    cumsum for the loss) on the same [W, n1] x [W, n2] scores: row_i =
    -#{b > a_i - 1}, col_j = -#{a < b_j + 1}, loss = sum_i c_i (1 - a_i)
    + the sum of the b past a_i - 1 (raw comparisons: equal to the body
    on finite scores away from rounding at d == 1)."""
    sb = torch.sort(b, dim=1).values
    sa = torch.sort(a, dim=1).values
    p = torch.searchsorted(sb, a - 1.0, right=True)
    row = (p - b.shape[1]).to(torch.float32)
    col = (-torch.searchsorted(sa, b + 1.0)).to(torch.float32)
    if not with_loss:
        return row, col
    return hinge_tail_loss(sb, torch.ones_like(sb), a, p), row, col


def hinge_tail_loss(sb, wb, a, p, wa=None):
    """sum_i wa_i (W_i (1 - a_i) + S_i), W_i and S_i the float64 sums of
    wb and wb * sb past position p_i of the sorted rows sb."""
    def tail(v):
        return torch.cat([torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1),
                                     [1]),
                          torch.zeros(v.shape[0], 1, dtype=torch.float64,
                                      device=v.device)], 1)
    w = wb.double()
    terms = (tail(w).gather(1, p) * (1.0 - a.double())
             + tail(w * sb.double()).gather(1, p))
    return (terms if wa is None else terms * wa.double()).sum(1)


def hinge_sum_library(a, b):
    """Kernel 1 hinge's yardstick: the loss of hinge_grad_library alone,
    torch.sort of b, torch.searchsorted of a - 1 and the cumsums."""
    sb = torch.sort(b, dim=1).values
    p = torch.searchsorted(sb, a - 1.0, right=True)
    return hinge_tail_loss(sb, torch.ones_like(sb), a, p)


def masked_pair_library(name, a, b, ma, mb):
    """Kernel 2's yardstick for the auc and hinge bodies: torch.sort of b
    with its mask, cumsums of the sorted weights (and weighted scores),
    torch.searchsorted of a (auc: wins + ties / 2, weighted) or a - 1
    (hinge), each row weighted by ma. Raw comparisons: equal to the body
    on finite scores away from rounding at d == 0 or d == 1."""
    sb, order = torch.sort(b, dim=1)
    wb = mb.gather(1, order)
    if name == "hinge":
        p = torch.searchsorted(sb, a - 1.0, right=True)
        return hinge_tail_loss(sb, wb, a, p, wa=ma)
    cw = torch.cat([torch.zeros(b.shape[0], 1, dtype=torch.float64,
                                device=b.device),
                    torch.cumsum(wb.double(), dim=1)], 1)
    lo = cw.gather(1, torch.searchsorted(sb, a))
    hi = cw.gather(1, torch.searchsorted(sb, a, right=True))
    return (ma.double() * (lo + 0.5 * (hi - lo))).sum(1)


def hinge_stop_gap(a, b, ma, mb, tile):
    """[W]: the largest |route - yardstick| of a hinge stop of the ring:
    kernel 1's or kernel 2's sort-and-search route (b in tiles of `tile`
    values) against hinge_sum_library or masked_pair_library("hinge"), on
    finite [W, n1] x [W, n2] scores with {0, 1} masks ma, mb. Both add the
    float64 terms (1 - a_i) + b_j, weighted by ma_i mb_j, over the pairs
    each selects, so they differ by
    (1) the pairs only one selects. The route keeps fl(a_i - b_j) < 1, the
    yardstick b_j > fl(a_i - 1). If the route keeps a pair the yardstick
    drops, a_i - b_j < 1 and b_j <= fl(a_i - 1), so 0 < 1 - a_i + b_j <=
    half an ulp of fl(a_i - 1); in the other case fl(a_i - b_j) >= 1 puts
    a_i - b_j at or past 1 - 2^-25, and b_j > fl(a_i - 1) puts 1 - a_i +
    b_j above minus that half ulp. Such a pair adds at most e_i = max(half
    an ulp of fl(a_i - 1), 2^-25) and lies in the window |b_j - (a_i - 1)|
    <= e_i (counted over 2 e_i, wide of float64's own rounding);
    (2) float64 rounding: a sum in any order errs by at most its depth of
    additions times 2^-53 of the sum of the magnitudes. The route's depth
    is a tile's suffix sum, a chunk of a's rows and the fixed-order sum of
    the tiles x chunks partials (ops/rank_count.py), the yardstick's the
    cumsum over b and the sum over a, each with a few products and adds;
    the magnitudes |ma_i| (|1 - a_i| sum |mb_j| + sum |mb_j b_j|) over the
    pairs of either selection (b_j >= a_i - 1 - 2 e_i)."""
    from tuplewise_tpu_torch.ops import rank_count

    W, n1 = a.shape
    n2 = b.shape[1]
    chunk = rank_count.load_library().tw_rank_sum_chunk(tile)
    depth = (tile + chunk + -(-n2 // tile) * -(-n1 // chunk) + 8) + (n1 + n2
                                                                      + 8)
    e = torch.clamp_min(half_ulp(a - 1.0), 2.0 ** -25)
    centre = a.double() - 1.0
    sb, order = torch.sort(b.double(), dim=1)
    wb = mb.gather(1, order).double().abs()
    zero = torch.zeros(W, 1, dtype=torch.float64, device=a.device)
    cw = torch.cat([zero, torch.cumsum(wb, dim=1)], 1)
    cwb = torch.cat([zero, torch.cumsum(wb * sb.abs(), dim=1)], 1)
    lo = torch.searchsorted(sb, centre - 2 * e)
    hi = torch.searchsorted(sb, centre + 2 * e, right=True)
    wa = ma.double().abs()
    window = (wa * e * (cw.gather(1, hi) - cw.gather(1, lo))).sum(1)
    mag = (wa * ((1.0 - a.double()).abs() * (cw[:, -1:] - cw.gather(1, lo))
                 + (cwb[:, -1:] - cwb.gather(1, lo)))).sum(1)
    return (window + depth * 2.0 ** -53 * mag) * (1 + 1e-6)


def logistic_stop_rel():
    """The largest relative |kernel - plain| of kernel 1's logistic body
    on finite scores (every term positive): the kernel adds its float32
    terms in float32, a thread's row over a column tile, then its rows,
    then the warp's and the block's shuffles, at most tile_b + tile_a
    additions deep, each within 2^-24 of the running sum; then float64
    partials. A term of either side is within 32 units in 2^-24 of the
    true body (csrc/pair_sum.cu: two expf and their product, the log1p
    within 4 units; plain's exp and log1p; both sides' fl(a - b)), so 64
    covers the two. The worst case, far above the errors a run shows."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    lib = pk.load_library()
    return (lib.tile_b + lib.tile_a + 64) * 2.0 ** -24 + 1e-12


def hinge_sum_bound_ms(n1, n2, W):
    """Bound of kernel 1's hinge route: bytes, the scores read once and
    the float64 partials (one a tile of b and chunk of a) and the sums
    written once; operations, the radix sort of b's keys."""
    from tuplewise_tpu_torch.ops import rank_count

    T = rank_count.grad_tile_size(n2)
    chunk = rank_count.load_library().tw_rank_sum_chunk(T)
    parts = W * -(-n2 // T) * -(-n1 // chunk)
    byts = 4 * W * (n1 + n2) + 8 * parts + 8 * W
    ops = SORT_OPS_PER_KEY * W * n2
    by = "operations" if ops / PEAK_FP32_OPS >= byts / PEAK_BYTES else "bytes"
    return max(ops / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by


def masked_sum_bound_ms(name, n1, n2, W):
    """Bound of kernel 2's masked auc and hinge routes: bytes, the scores
    and weights read once and the float64 partials (one a tile of b and
    chunk of a) and the sums written once; operations, the radix sort of
    b's keys."""
    from tuplewise_tpu_torch.ops import rank_count

    T = rank_count.masked_tile_size(n2, name == "hinge")
    chunk = rank_count.load_library().tw_rank_sum_chunk(T)
    parts = W * -(-n2 // T) * -(-n1 // chunk)
    byts = 8 * W * (n1 + n2) + 8 * parts + 8 * W
    ops = SORT_OPS_PER_KEY * W * n2
    by = "operations" if ops / PEAK_FP32_OPS >= byts / PEAK_BYTES else "bytes"
    return max(ops / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by


def sparse_edge(gen, frac, *shape):
    """Normal scores with a fraction frac drawn from EDGE_VALUES."""
    x = torch.randn(*shape, generator=gen, device="cuda")
    pool = torch.tensor(EDGE_VALUES, device="cuda")
    at = torch.randint(0, len(pool), shape, generator=gen, device="cuda")
    return torch.where(torch.rand(*shape, generator=gen, device="cuda") < frac,
                       pool[at], x)


def same_bits(x, y):
    """Bit equality of two float32 tensors (NaN included)."""
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def check_grad(name, got, want, what):
    """Hold row and col of a gradient kernel against the plain version:
    hinge equal, logistic within rel 1e-4 per element (NaN and infinities
    where plain has them). Returns the largest absolute error over the
    finite entries of row and col."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if name == "hinge":
            assert torch.equal(g, w), (name, what)
            err = max(err, float((g.double() - w.double()).abs().max()))
        else:
            err = max(err, check_nonfinite(g.double(), w.double(), what,
                                           rtol=1e-4))
    return err


def check_grad_case(name, a, b, what):
    """Both gradient kernels on a and b against one plain pair_loss_grad:
    row and col (check_grad), kernel 3's row and col bit-equal to kernel
    4's, the loss within rel 1e-5 of plain and rel 1e-6 of pair_sum, NaN
    and inf where they have them. Returns (row/col error, plain loss)."""
    from tuplewise_tpu_torch.ops import pair_grad_kernels as pg
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    k = get_kernel(name)
    loss, row, col = pg.pair_loss_grad(a, b, k)
    row2, col2 = pg.pair_grad_sums(a, b, k)
    lp, rp, cp = pg.pair_loss_grad(a, b, k, impl="plain")
    err = check_grad(name, (row, col), (rp, cp), what)
    check_grad(name, (row2, col2), (rp, cp), what)
    assert same_bits(row, row2) and same_bits(col, col2), what
    check_nonfinite(loss, lp, ("loss vs plain", what), rtol=1e-5)
    check_nonfinite(loss, pk.pair_sum(a, b, k), ("loss vs pair_sum", what),
                    rtol=1e-6)
    return err, lp


def phase_grad_vs_plain(sass):
    """Phase 6: both gradient kernels against one plain pair_loss_grad per
    shape and body, then on edge-case scores at ragged shapes; at the
    headline shape also the timing rows."""
    from tuplewise_tpu_torch.ops import pair_grad_kernels as pg
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    headline = (1, 500_000, 500_000)
    for W, n1, n2 in [(1, 4133, 8197), (8, 4133, 8197), (1536, 16, 16)]:
        # scores of a scorer early in training: the two classes overlap,
        # so both sides of the hinge's kink are well populated
        a = torch.randn(W, n1, generator=g, device="cuda") * 0.5 + 0.3
        b = torch.randn(W, n2, generator=g, device="cuda") * 0.5
        b[:, :5] = a[:, :5] - 1.0                       # d == 1
        for name in GRAD_NAMES:
            err, _ = check_grad_case(name, a, b, (name, W, n1, n2))
            log(f"[grad vs plain] W={W} {n1}x{n2} {name:8s}: row/col "
                f"{'equal' if name == 'hinge' else 'within rel 1e-4'} "
                f"(max abs err {err:.3g}), loss within rel 1e-5 of plain "
                f"and 1e-6 of pair_sum; kernel 3 and 4 row/col bit-equal")
    # edge values at ragged shapes (the last tile of each side padded): a
    # NaN difference gives g' 0 (hinge) or NaN (logistic) and a NaN loss,
    # -inf and +inf scores the plain version's infinities
    cases = [(3, 300, 517, 0.3), (2, 4133, 20000, 1e-3),
             (1, 17, 70000, 0.3), (4, 3000, 5000, 2e-4)]
    for W, n1, n2, frac in cases:
        a, b = sparse_edge(g, frac, W, n1), sparse_edge(g, frac, W, n2)
        b[:, :7] = a[:, :7] - 1.0
        outcomes = []
        for name in GRAD_NAMES:
            _, lp = check_grad_case(name, a, b, (name, "edge", W, n1, n2))
            outcomes += lp.tolist()
        log(f"[grad vs plain] edge values W={W} {n1}x{n2} ({frac:g} "
            f"non-finite or signed zeros): hinge and logistic as plain "
            f"({sum(map(math.isnan, outcomes))} NaN, "
            f"{sum(map(math.isinf, outcomes))} inf of {len(outcomes)} losses)")
    # single infinities beside ragged tiles: a -inf score of a met -inf
    # padding columns in the sentinel design (NaN, where plain is +inf)
    a = torch.randn(3, 300, generator=g, device="cuda")
    b = torch.randn(3, 1500, generator=g, device="cuda")
    a[0, 3], b[1, 7], a[2, 299] = -math.inf, math.inf, math.inf
    for name in GRAD_NAMES:
        _, lp = check_grad_case(name, a, b, (name, "infinities"))
        assert lp.isinf().tolist() == [True, True, False], (name, lp)
    log("[grad vs plain] single infinities beside ragged tiles: losses +inf "
        "where plain is +inf, row/col as plain")

    W, n1, n2 = headline
    a = torch.randn(W, n1, generator=g, device="cuda") * 0.5 + 0.3
    b = torch.randn(W, n2, generator=g, device="cuda") * 0.5
    for name in GRAD_NAMES:
        k = get_kernel(name)
        reps = 20 if name == "hinge" else 3
        cuda_ms(lambda: pg.pair_loss_grad(a, b, k))     # warm-up
        ms_lg, (loss, row, col) = cuda_ms(
            lambda: pg.pair_loss_grad(a, b, k), reps=reps)
        cuda_ms(lambda: pg.pair_grad_sums(a, b, k))
        ms_gs, (row2, col2) = cuda_ms(
            lambda: pg.pair_grad_sums(a, b, k), reps=reps)
        plain_ms, (lp, rp, cp) = cuda_ms(
            lambda: pg.pair_loss_grad(a, b, k, impl="plain"))
        what = (name, W, n1, n2)
        err = check_grad(name, (row, col), (rp, cp), what)
        err2 = check_grad(name, (row2, col2), (rp, cp), what)
        assert same_bits(row, row2) and same_bits(col, col2), what
        check_nonfinite(loss, lp, ("loss vs plain", what), rtol=1e-5)
        check_nonfinite(loss, pk.pair_sum(a, b, k), ("loss vs pair_sum", what),
                        rtol=1e-6)
        pairs = float(n1) * n2 * W
        loss_err = float((loss - lp).abs().max()) / pairs
        for wrapper, ms, e in [("pair_loss_grad", ms_lg, err),
                               ("pair_grad_sums", ms_gs, err2)]:
            with_loss = wrapper == "pair_loss_grad"
            bms, by = grad_bound_ms(wrapper, name, n1, n2, W)
            library_ms, extra = None, {}
            if name == "hinge":
                hinge_grad_library(a, b, with_loss)
                library_ms, _ = cuda_ms(
                    lambda: hinge_grad_library(a, b, with_loss), reps=reps)
            else:
                ipp = sass[wrapper, "factored"]
                extra = dict(sass_per_pair=ipp,
                             sass_per_pair_per_pair_form=sass[wrapper,
                                                              "per-pair"],
                             issue_bound_ms=pairs * ipp / PEAK_ISSUE * 1e3,
                             scratch_bytes=pg.scratch_bytes(n1, n2, W,
                                                            with_loss))
            rows.append(dict(
                name=f"{wrapper}[{name}]", route="cuda",
                source=source_of(f"{wrapper}[{name}]"),
                replaces=REPLACES[wrapper], launches=None, max_abs_err=e,
                loss_err_of_mean=loss_err if with_loss else None,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, shape=f"W={W} {n1}x{n2}", **extra))
            r = rows[-1]
            log(f"[timing] {r['name']:24s} {r['shape']:22s} "
                f"{ms:9.3f} ms (bound {bms:.4f} ms by {by}, plain "
                f"{plain_ms:.1f} ms, library {library_ms}, parent commit "
                f"{EARLIER_MS.get(r['name'])} ms); max abs err of row/col "
                f"vs plain {e:.3g}" + (
                    f"; {r['sass_per_pair']:.3f} SASS a pair (factored), "
                    f"issue bound {r['issue_bound_ms']:.2f} ms"
                    if "sass_per_pair" in r else ""))
    # the sim learner's problem shape, timed (phase 10's calls)
    W, n1, n2 = 1536, 16, 16
    a = torch.randn(W, n1, generator=g, device="cuda") * 0.5 + 0.3
    b = torch.randn(W, n2, generator=g, device="cuda") * 0.5
    for name in GRAD_NAMES:
        k = get_kernel(name)
        for wrapper in ("pair_loss_grad", "pair_grad_sums"):
            fn = getattr(pg, wrapper)
            fn(a, b, k)
            ms, _ = cuda_ms(lambda: fn(a, b, k), reps=50)
            for r in rows:
                if r["name"] == f"{wrapper}[{name}]":
                    r["ms_sim_shape"] = ms
            log(f"[timing] {wrapper}[{name}] W={W} {n1}x{n2}: {ms:.4f} ms "
                f"a call")
    return rows


def train_data():
    from tuplewise_tpu_torch.data import make_gaussian_splits

    return make_gaussian_splits(500_000, 125_000, dim=5, seed=0)


def phase_train(data):
    """Phase 7: the trainer at full width; the path whose launches count
    for the gradient kernels."""
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, evaluate_auc, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    Xp, Xn, Xp_te, Xn_te = data
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    auc0 = evaluate_auc(scorer, p0, Xp_te, Xn_te)
    pairs = float(len(Xp)) * len(Xn)
    rows = []
    for nr in (1, 10, NEVER):
        for le in (1, NEVER):
            cfg = TrainConfig(kernel="hinge", lr=0.3, n_workers=1,
                              repartition_every=nr, seed=7, tile=2048,
                              loss_every=le, steps=20)
            train_pairwise(scorer, p0, Xp, Xn,
                           dataclasses.replace(cfg, steps=2))  # warm-up
            ms, (params, hist) = cuda_ms(
                lambda: train_pairwise(scorer, p0, Xp, Xn, cfg))
            auc = evaluate_auc(scorer, params, Xp_te, Xn_te)
            loss = hist["loss"]
            assert loss.shape == (20,) and np.isfinite(loss[0]), loss
            if le == NEVER:
                assert np.isnan(loss[1:]).all(), loss
            else:
                assert np.isfinite(loss).all() and loss[-1] < loss[0], loss
            assert auc >= 0.75 and auc > auc0, (nr, le, auc, auc0)
            row = dict(repartition_every=None if nr == NEVER else nr,
                       loss_every=None if le == NEVER else le, ms=ms,
                       steps_per_s=20 / ms * 1e3,
                       grad_pairs_per_s=20 * pairs / ms * 1e3,
                       auc_test_before=auc0, auc_test_after=auc,
                       loss_first=float(loss[0]),
                       loss_last=float(loss[-1]) if le == 1 else None)
            rows.append(row)
            log(f"[train] hinge n=5e5/class n_r={row['repartition_every']} "
                f"loss_every={row['loss_every']}: {row['steps_per_s']:.3f} "
                f"steps/s, {row['grad_pairs_per_s']:.4g} grad-pairs/s "
                f"({ms:.1f} ms for 20 steps); test AUC {auc0:.5f} -> "
                f"{auc:.5f}; loss {loss[0]:.5f} -> {row['loss_last']}")
    cfg = TrainConfig(kernel="logistic", lr=0.3, n_workers=1,
                      repartition_every=10, seed=7, tile=2048, loss_every=2,
                      steps=4)
    ms, (params, hist) = cuda_ms(
        lambda: train_pairwise(scorer, p0, Xp, Xn, cfg))
    loss = hist["loss"]
    assert np.isfinite(loss[::2]).all() and np.isnan(loss[1::2]).all(), loss
    assert loss[2] < loss[0], loss
    auc = evaluate_auc(scorer, params, Xp_te, Xn_te)
    assert auc > auc0, (auc, auc0)
    log(f"[train] logistic n=5e5/class loss_every=2: 4 steps in {ms:.1f} ms; "
        f"loss {loss[0]:.5f} -> {loss[2]:.5f}; test AUC {auc:.5f}")
    return rows


def phase_resume():
    """Phase 8: a chunked, checkpointed and resumed run equals the uncut
    one bit for bit."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    Xp, Xn, _, _ = make_gaussian_splits(1 << 16, 1000, dim=5, seed=1)
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=20, n_workers=4,
                      repartition_every=5, seed=7, loss_every=3)
    p_full, h_full = train_pairwise(scorer, p0, Xp, Xn, cfg)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "train.npz")
        train_pairwise(scorer, p0, Xp, Xn, dataclasses.replace(cfg, steps=7),
                       checkpoint_path=path)
        p_res, h_res = train_pairwise(scorer, p0, Xp, Xn, cfg,
                                      checkpoint_path=path)
    for k in p_full:
        assert p_full[k].tobytes() == p_res[k].tobytes(), k
    assert h_full["loss"].tobytes() == h_res["loss"].tobytes()
    log(f"[resume] 20 steps = 7 steps + checkpoint + 13 resumed, bit for "
        f"bit (params {sorted(p_full)}, loss history of "
        f"{len(h_full['loss'])})")


def rel_diff(p, q):
    """Largest parameter difference relative to the largest parameter."""
    diff = max(float(np.abs(p[k] - q[k]).max()) for k in q)
    return diff / max(float(np.abs(q[k]).max()) for k in q)


def phase_plain_trajectory():
    """Phase 9: the kernels' trajectory against the plain versions'."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer

    Xp, Xn, _, _ = make_gaussian_splits(1 << 14, 1000, dim=5, seed=2)
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=20, n_workers=1,
                      repartition_every=10, seed=7)
    p_k, h_k = train_pairwise(scorer, p0, Xp, Xn, cfg)
    p_p, h_p = train_pairwise(scorer, p0, Xp, Xn, cfg, impl="plain")
    rel = rel_diff(p_k, p_p)
    assert rel < 1e-6, rel
    log(f"[kernel vs plain trajectory] 20 hinge steps at n=2^14/class: "
        f"params rel diff {rel:.3g}, final loss {h_k['loss'][-1]:.6f} / "
        f"{h_p['loss'][-1]:.6f}")


def phase_sim_learner():
    """Phase 10: one train_curves cell of the gauss sweep."""
    from tuplewise_tpu_torch.data import make_gaussian_splits
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.models.sim_learner import (
        curve_record, train_curves,
    )

    Xp, Xn, Xp_te, Xn_te = make_gaussian_splits(512, 20000, dim=10,
                                                separation=0.8, seed=0)
    scorer = LinearScorer(dim=10)
    p0 = scorer.init(0)
    cfg = TrainConfig(kernel="hinge", lr=0.3, steps=500, seed=1000,
                      n_workers=32, repartition_every=5)
    S = 48
    t0 = time.perf_counter()
    out = train_curves(scorer, p0, Xp, Xn, Xp_te, Xn_te, cfg, n_seeds=S,
                       eval_every=25)
    wall = time.perf_counter() - t0
    rec = curve_record(cfg, out, S)
    assert out["test_auc"].shape == (S, 21) and np.isfinite(out["loss"]).all()
    assert rec["final_auc_mean"] > out["test_auc"][:, 0].mean()
    log(f"[sim learner] gauss cell n=512 N=32 n_r=5 S=48 500 steps: "
        f"{wall:.2f} s wall-clock; test AUC {out['test_auc'][:, 0].mean():.5f}"
        f" -> {rec['final_auc_mean']:.5f} +- {rec['final_auc_se']:.5f}")
    short = dataclasses.replace(cfg, steps=20)
    out = train_curves(scorer, p0, Xp, Xn, Xp_te, Xn_te, short, n_seeds=S,
                       eval_every=20)
    p_one, h_one = train_pairwise(scorer, p0, Xp, Xn, short)
    rel = rel_diff({k: v[0] for k, v in out["final_params"].items()}, p_one)
    assert rel < 1e-4, rel
    log(f"[sim learner] 20 steps: replica 0 vs train_pairwise params rel "
        f"diff {rel:.3g}")
    return wall


# --------------------------------------------------------------------- #
# degree 3: kernel 5, the triplet statistics and the triplet learner    #
# --------------------------------------------------------------------- #

def check_triplet(name, got, want, what):
    """Hold per-anchor triplet sums against the plain version's: the
    indicator equal (exact integers on both sides), the hinge within rel
    1e-5 (float32 terms summed in different orders). Returns the largest
    absolute error."""
    torch.cuda.synchronize()
    if name == "triplet_indicator":
        assert torch.equal(got, want), (name, what)
    else:
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        assert rel < 1e-5, (name, what, rel)
    return float((got - want).abs().max())


def triplet_hinge_library(A, B, ip, ia, margin=1.0):
    """Kernel 5 hinge's yardstick: torch.sort of B's rows, the float64
    prefix sums of the sorted B, torch.searchsorted of A + margin: per
    anchor, the sum over the positives that the id exclusion keeps of
    (margin + A) c - (the sum of the c smallest B), c = #{B < A + margin}
    (raw comparisons: equal to the body away from rounding at the
    margin). float64 [C]."""
    sb = torch.sort(B, dim=1).values
    pre = torch.cat([torch.zeros(B.shape[0], 1, dtype=torch.float64,
                                 device=B.device),
                     torch.cumsum(sb.double(), dim=1)], 1)
    c = torch.searchsorted(sb, A + margin)
    keep = ip[None, :] != ia[:, None]
    return (((margin + A.double()) * c - pre.gather(1, c)) * keep).sum(1)


def sort_count(A, B, ip, ia):
    """Independent exact per-anchor indicator count (margin 0, unmasked
    negatives): #{(j, k): A[c,j] < B[c,k], ip[j] != ia[c]} as
    K - searchsorted(sort(B[c]), A[c], right=True), summed over the
    positives that the id exclusion keeps. int64 [C]."""
    below = torch.searchsorted(torch.sort(B, dim=1).values, A, right=True)
    keep = ip[None, :] != ia[:, None]
    return ((B.shape[1] - below) * keep).sum(1)


def phase_triplet_vs_plain(errs):
    """Phase 11: kernel 5 against its plain version."""
    from tuplewise_tpu_torch.ops import pair_tiles
    from tuplewise_tpu_torch.ops import triplet_kernels as tk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    def dev(a):
        return torch.as_tensor(a, device="cuda")

    # the JAX test's inputs (tests/test_pallas_and_rank.py): masks, ids,
    # and 29 visiting positives with ids 100+, through the statistic
    rng = np.random.default_rng(0)
    X = dev(rng.normal(size=(45, 5)).astype(np.float32))
    Y = dev(rng.normal(size=(37, 5)).astype(np.float32) + np.float32(0.3))
    mx = dev((rng.random(45) > 0.2).astype(np.float32))
    my = dev((rng.random(37) > 0.3).astype(np.float32))
    Pv = dev(rng.normal(size=(29, 5)).astype(np.float32))
    ids = torch.arange(45, device="cuda")
    for name in TRIPLET_NAMES:
        k = get_kernel(name)
        for kw in (dict(mask_x=mx, mask_y=my, ids_x=ids),
                   dict(mask_y=my, ids_x=ids, positives=Pv,
                        ids_p=100 + torch.arange(29, device="cuda"))):
            s, c = tk.factorized_triplet_stats(k, X, Y, **kw)
            sp, cp = tk.factorized_triplet_stats(k, X, Y, impl="plain", **kw)
            st, ct = pair_tiles.triplet_stats(k, X, Y, tile=16, **kw)
            check_triplet(name, s[None], sp[None], "jax test inputs")
            assert int(c) == int(cp) == int(ct), (name, c, cp, ct)
            assert abs(float(s) - float(st)) <= 1e-6 * abs(float(st)), name
    log("[triplet vs plain] JAX test inputs (45x5 / 37x5, masks, ids, 29 "
        "visiting positives): statistic equal to plain (indicator) / rel "
        "1e-5 (hinge), counts equal, tiled scan within rel 1e-6")

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    d = TRIPLET_D

    def rows(m):
        return torch.randn(m, d, generator=g, device="cuda")

    def mask(*shape):
        return (torch.rand(*shape, generator=g, device="cuda") > 0.2).float()

    # ragged: 1000 anchors x 4133 positives x 8197 negatives, one group
    Xa, Xp, Yn = rows(1000), rows(4133), rows(8197) + 0.3
    d_pa, d_an = tk.sqdist_matrix(Xa, Xp), tk.sqdist_matrix(Xa, Yn)
    ip = torch.arange(4133, device="cuda")[None]
    ia = torch.arange(0, 3000, 3, device="cuda")     # some ids collide
    mp, mk = mask(1, 4133), mask(1, 8197)
    # a local round's batch: N = 8 workers x 1000 anchors, 1000 positives
    # (swr global ids, with duplicates) and 1500 negatives each
    N, m1, m2 = 8, 1000, 1500
    A8, B8 = rows(N * m1).reshape(N, m1, d), rows(N * m2).reshape(N, m2, d)
    i8 = torch.randint(0, 4000, (N, m1), generator=g, device="cuda")
    dl_pa = tk.sqdist_matrix(A8, A8).reshape(N * m1, m1)
    dl_an = tk.sqdist_matrix(A8, B8).reshape(N * m1, m2)
    cases = [
        ("ragged W=1000 4133x8197", (d_pa, d_an, mp, ip, ia, mk), None),
        ("local round N=8 x 1000 anchors, 1000x1500",
         (dl_pa, dl_an, mask(N, m1), i8, i8.reshape(-1).contiguous(),
          mask(N, m2)), m1),
    ]
    for name in TRIPLET_NAMES:
        comb = tk.triplet_combine_kernel(get_kernel(name))
        for what, args, group in cases:
            got = tk.batched_masked_pair_sum(*args, comb, group)
            want = tk.batched_masked_pair_sum(*args, comb, group,
                                              impl="plain")
            err = check_triplet(name, got, want, what)
            key = f"batched_masked_pair_sum[{name}]"
            errs[key] = max(errs.get(key, 0.0), err)
            log(f"[triplet vs plain] {what} {name}: per-anchor sums "
                f"{'equal' if name == 'triplet_indicator' else 'within rel 1e-5'}"
                f" (max abs err {err:.3g})")

    # the indicator's edge cases: distances with +-inf, NaN, +-0.0 and ties
    # between A and B, two groups with their own masks, colliding ids
    key = "batched_masked_pair_sum[triplet_indicator]"
    for margin in (0.0, 0.5):
        comb = tk.TripletCombine("indicator", margin)
        for C, G, P, K, frac in [(1, 1, 1, 1, False), (3, 2, 300, 517, False),
                                 (2, 2, 40, 20000, True),
                                 (4, 1, 3000, 33000, False)]:
            W = C * G
            A, B = edge_values(g, W, P) + 3.0, edge_values(g, W, K) + 3.0
            B[:, :5] = A[:, :5]
            mp, mk = mask(G, P), mask(G, K)
            if frac:
                mp = mp * torch.rand(G, P, generator=g, device="cuda")
                mk = mk * torch.rand(G, K, generator=g, device="cuda")
            ip = (torch.arange(G * P, device="cuda") % 7).reshape(G, P)
            ia = torch.arange(W, device="cuda") % 5
            got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C)
            want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C,
                                              impl="plain")
            torch.cuda.synchronize()
            if frac:
                rel = float(((got - want).abs()
                             / want.abs().clamp_min(1e-30)).max())
                assert rel < 1e-6, (margin, W, P, K, rel)
            else:
                assert torch.equal(got, want), (margin, W, P, K)
            errs[key] = max(errs[key], float((got - want).abs().max()))
            log(f"[triplet vs plain] edge values margin {margin} W={W} "
                f"({G} groups) {P}x{K} {'fractional' if frac else '0/1'} "
                f"masks: indicator {'within rel 1e-6' if frac else 'equal'}")

    # the hinge's edge cases (rule 4 of csrc/rank_count.cu's note): a NaN
    # distance anywhere in an anchor's rows, or an equal infinity, makes
    # its sum NaN, +inf in A or -inf in B +inf (NaN against a zero weight)
    key = "batched_masked_pair_sum[triplet_hinge]"
    for margin in (0.0, 0.5, 1.0):
        comb = tk.TripletCombine("hinge", margin)
        nan = inf = fin = 0
        for C, G, P, K, frac, p_edge in [
                (1, 1, 1, 1, False, 0.3), (3, 2, 300, 517, False, 0.3),
                (2, 2, 40, 20000, True, 0.3), (4, 1, 3000, 33000, False, 0.3),
                (64, 1, 2000, 9000, True, 2e-4)]:
            W = C * G
            A = edge_values(g, W, P) + 3.0
            B = edge_values(g, W, K) + 3.0
            B[:, :5] = A[:, :5]
            if p_edge < 0.3:   # a few edge values: most sums finite
                A = torch.where(torch.rand(W, P, generator=g, device="cuda")
                                < p_edge, A, A.nan_to_num(3.0, 3.0, 3.0))
                B = torch.where(torch.rand(W, K, generator=g, device="cuda")
                                < p_edge, B, B.nan_to_num(3.0, 3.0, 3.0))
            mp, mk = mask(G, P), mask(G, K)
            if frac:
                mp = mp * torch.rand(G, P, generator=g, device="cuda")
                mk = mk * torch.rand(G, K, generator=g, device="cuda")
            ip = (torch.arange(G * P, device="cuda") % 7).reshape(G, P)
            ia = torch.arange(W, device="cuda") % 5
            got = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C)
            want = tk.batched_masked_pair_sum(A, B, mp, ip, ia, mk, comb, C,
                                              impl="plain")
            err = check_nonfinite(got, want, ("hinge edge", margin, W, P, K))
            errs[key] = max(errs[key], err)
            nan += int(want.isnan().sum())
            inf += int(want.isinf().sum())
            fin += int(want.isfinite().sum())
        log(f"[triplet vs plain] edge values margin {margin}: hinge sums NaN "
            f"and inf where plain has them ({nan} NaN, {inf} inf, {fin} "
            f"finite within rel 1e-5)")
    # infinities one kind an anchor (margin 1): none; +inf in A (+inf);
    # -inf in B (+inf); -inf in A (a term of 0); then the same with a zero
    # weight meeting each infinity, which makes anchors 1 and 2 NaN
    W, P, K = 4, 300, 517
    A = torch.rand(W, P, generator=g, device="cuda") * 20
    B = torch.rand(W, K, generator=g, device="cuda") * 20
    A[1, 7], B[2, 9], A[3, 5] = math.inf, -math.inf, -math.inf
    # no positive shares an anchor's id: a weight 0 times the +inf of a
    # positive's terms would make the sum NaN
    ip = 1000 + torch.arange(P, device="cuda")[None]
    ia = torch.arange(W, device="cuda")
    comb = tk.TripletCombine("hinge", 1.0)
    ones_p, ones_k = torch.ones(1, P, device="cuda"), torch.ones(1, K,
                                                                 device="cuda")
    zero_k = ones_k.clone()
    zero_k[0, 9] = 0.0       # -inf of anchor 2 (and a finite B of anchor 1)
    for mk, want_inf, want_nan in [
            (ones_k, [False, True, True, False], [False] * 4),
            (zero_k, [False] * 4, [False, True, True, False])]:
        got = tk.batched_masked_pair_sum(A, B, ones_p, ip, ia, mk, comb)
        want = tk.batched_masked_pair_sum(A, B, ones_p, ip, ia, mk, comb,
                                          impl="plain")
        check_nonfinite(got, want, ("hinge infinities", want_nan))
        assert want.isinf().tolist() == want_inf, want
        assert want.isnan().tolist() == want_nan, want
    log("[triplet vs plain] infinities without NaN: hinge sums +inf where "
        "plain is +inf, NaN where a zero weight meets +inf")


def gaussian_clouds(gen, n, d):
    """Anchors/positives N(0, I) and negatives N(0.3, I) in d dims: the
    data of the JAX package's config-4 grid."""
    X = torch.randn(n, d, generator=gen, device="cuda")
    Y = torch.randn(n, d, generator=gen, device="cuda") + 0.3
    return X, Y


def phase_triplet_main():
    """Phase 12: the degree-3 estimator at full width; the path whose
    launches count for kernel 5. Returns (X, Y, rows of results)."""
    from tuplewise_tpu_torch import Estimator

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n, d = TRIPLET_N, TRIPLET_D
    Xs, Ys = gaussian_clouds(g, 1024, d)
    for name in TRIPLET_NAMES:                       # warm-up, small
        est = Estimator(name, backend="torch", n_workers=8)
        est.complete(Xs, Ys)
        est.repartitioned(Xs, Ys, n_rounds=2)
        est.incomplete(Xs, Ys, n_pairs=20_000)
    X, Y = gaussian_clouds(g, n, d)
    triplets = float(n) * (n - 1) * n
    out = {}
    for name in TRIPLET_NAMES:
        est = Estimator(name, backend="torch", n_workers=8)
        ms, full = cuda_ms(lambda: est.complete(X, Y))
        ms_l, loc = cuda_ms(lambda: est.local_average(X, Y, seed=SEED))
        ms_r, rep = cuda_ms(lambda: est.repartitioned(X, Y, n_rounds=4,
                                                      seed=SEED))
        ms_i, inc = cuda_ms(lambda: est.incomplete(X, Y, n_pairs=20_000,
                                                   seed=SEED))
        scale = 1.0 if name == "triplet_indicator" else abs(full)
        for v, tol in [(loc, 0.01), (rep, 0.01), (inc, 0.05)]:
            assert math.isfinite(v) and abs(v - full) < tol * scale, (
                name, v, full)
        m = n // 8
        per_round = 8.0 * m * (m - 1) * m
        out[name] = dict(complete=full, complete_ms=ms,
                         triplets_per_s=triplets / ms * 1e3,
                         local=loc, local_ms=ms_l, repartitioned=rep,
                         repartitioned_ms=ms_r, incomplete=inc,
                         incomplete_ms=ms_i)
        log(f"[triplet main] {name} n={n} d={d}: complete {full:.9f} in "
            f"{ms:.1f} ms ({triplets / ms * 1e3:.4g} triplets/s); local "
            f"(N=8) {loc:.6f} ({per_round / ms_l * 1e3:.4g} triplets/s, "
            f"{ms_l:.1f} ms); repartitioned (N=8, T=4) {rep:.6f} "
            f"({4 * per_round / ms_r * 1e3:.4g} triplets/s, {ms_r:.1f} ms);"
            f" incomplete (B=2e4) {inc:.6f} ({ms_i:.3f} ms)")
    return X, Y, out


def sort_count_bytes(name, W, P, K):
    """Bytes a sort-and-count route of kernel 5 moves at least, for one
    group of W anchors (ops.rank_count): A [W, P] and B [W, K] float32, mp
    float32 and ip int64 [P], ia int64 [W], mk float32 [K] read once, the
    float64 partials (one a tile of B, whose size is the route's)
    written once."""
    from tuplewise_tpu_torch.ops import rank_count

    max_tile = (rank_count.MAX_TILE if name == "triplet_indicator"
                else rank_count.HINGE_MAX_TILE)
    tiles = -(-K // rank_count.tile_size(K, max_tile))
    return 4.0 * W * (P + K) + 12.0 * P + 8.0 * W + 4.0 * K + 8.0 * W * tiles


def phase_triplet_exact(X, Y, errs, launches, main_out):
    """Phase 12b, outside the counted run: at full width the kernel's
    per-anchor indicator sums equal the sort-count for EVERY anchor and
    equal the plain version on a slice of anchors (hinge within rel
    1e-5); the timing rows of kernel 5."""
    from tuplewise_tpu_torch.ops import triplet_kernels as tk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    n, K = X.shape[0], Y.shape[0]
    ids = torch.arange(n, device="cuda")
    ones_p, ones_k = torch.ones(1, n, device="cuda"), torch.ones(1, K,
                                                                 device="cuda")
    chunk = tk.anchor_chunk(1, n, n, K, X.device)
    combs = {name: tk.triplet_combine_kernel(get_kernel(name))
             for name in TRIPLET_NAMES}
    ms_full = {name: 0.0 for name in TRIPLET_NAMES}
    lib_ms_full = {name: 0.0 for name in TRIPLET_NAMES}
    bytes_full = {name: 0.0 for name in TRIPLET_NAMES}
    sums = {name: torch.empty(n, dtype=torch.float64, device="cuda")
            for name in TRIPLET_NAMES}
    exact = torch.empty(n, dtype=torch.int64, device="cuda")
    for a0, d_pa, d_an in tk.distance_chunks(X[None], X[None], Y[None],
                                             chunk):
        A, B = d_pa[0], d_an[0]
        ia = ids[a0:a0 + A.shape[0]]
        for name, comb in combs.items():
            ms, s = cuda_ms(lambda: tk.batched_masked_pair_sum(
                A, B, ones_p, ids[None], ia, ones_k, comb))
            ms_full[name] += ms
            bytes_full[name] += sort_count_bytes(name, *A.shape, K)
            sums[name][a0:a0 + A.shape[0]] = s
        ms, cnt = cuda_ms(lambda: sort_count(A, B, ids, ia))
        lib_ms_full["triplet_indicator"] += ms
        exact[a0:a0 + A.shape[0]] = cnt
        ms, _ = cuda_ms(lambda: triplet_hinge_library(A, B, ids, ia))
        lib_ms_full["triplet_hinge"] += ms
        del d_pa, d_an, A, B
    torch.cuda.synchronize()
    assert torch.equal(sums["triplet_indicator"], exact.to(torch.float64))
    count = float(n) * (n - 1) * K
    for name in TRIPLET_NAMES:
        stat = float(sums[name].sum()) / count
        ref = main_out[name]["complete"]
        rel = abs(stat - ref) / max(abs(ref), 1.0)
        assert rel <= 1e-6, (name, stat, ref)
        log(f"[triplet exact] {name}: sum of the per-anchor sums / count "
            f"vs Estimator.complete: rel diff {rel:.3g}")
    log(f"[triplet exact] n={n} d={TRIPLET_D}: the kernel's per-anchor "
        f"indicator sums equal the sort-count for all {n} anchors "
        f"(kernel {ms_full['triplet_indicator']:.1f} ms, sort-count "
        f"{lib_ms_full['triplet_indicator']:.1f} ms over {-(-n // chunk)} "
        f"chunks of {chunk})")

    # the timing rows: a slice of TRIPLET_SLICE anchors of the same
    # problem, where the plain version runs in seconds
    c = TRIPLET_SLICE
    d_pa, d_an = tk.sqdist_matrix(X[:c], X), tk.sqdist_matrix(X[:c], Y)
    ia = ids[:c]
    cuda_ms(lambda: sort_count(d_pa, d_an, ids, ia))           # warm-up
    library_ms, cnt = cuda_ms(lambda: sort_count(d_pa, d_an, ids, ia),
                              reps=20)
    cuda_ms(lambda: triplet_hinge_library(d_pa, d_an, ids, ia))
    hinge_lib_ms, hinge_lib = cuda_ms(
        lambda: triplet_hinge_library(d_pa, d_an, ids, ia), reps=20)
    library = {"triplet_indicator": library_ms, "triplet_hinge": hinge_lib_ms}
    rows = []
    for name, comb in combs.items():
        args = (d_pa, d_an, ones_p, ids[None], ia, ones_k, comb)
        cuda_ms(lambda: tk.batched_masked_pair_sum(*args))    # warm-up
        ms, got = cuda_ms(lambda: tk.batched_masked_pair_sum(*args), reps=20)
        plain_ms, want = cuda_ms(
            lambda: tk.batched_masked_pair_sum(*args, impl="plain"))
        err = check_triplet(name, got, want, ("slice", c, n, K))
        if name == "triplet_indicator":
            assert torch.equal(got, cnt.to(torch.float64))
        else:
            log(f"[timing] triplet_hinge yardstick (sort + cumsum + "
                f"searchsorted): largest rel diff to the kernel "
                f"{float(((hinge_lib - got).abs() / got.abs()).max()):.3g}")
        key = f"batched_masked_pair_sum[{name}]"
        # sort-and-count: bound by the bytes of its inputs and partials
        bms, by = bytes_bound_ms(sort_count_bytes(name, c, n, K)), "bytes"
        bms_full = bytes_bound_ms(bytes_full[name])
        rows.append(dict(
            name=key, route="cuda", source=source_of(key),
            replaces=REPLACES["batched_masked_pair_sum"],
            launches=launches.get(key, 0), max_abs_err=err,
            max_abs_err_small=errs[key], ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by,
            library_ms=library[name],
            shape=f"W={c} anchors {n}x{K} d={TRIPLET_D}",
            ms_full=ms_full[name],
            bound_ms_full=bms_full,
            library_ms_full=lib_ms_full[name],
            shape_full=f"W={n} anchors {n}x{K} d={TRIPLET_D}"))
        r = rows[-1]
        log(f"[timing] {key:44s} {r['shape']:30s} {ms:9.3f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {by}, plain {plain_ms:.1f} ms, "
            f"library {r['library_ms']:.3f} ms (full width "
            f"{r['library_ms_full']:.1f}), parent commit "
            f"{EARLIER_MS.get(key)} ms); full width {ms_full[name]:.1f} ms "
            f"(bound {r['bound_ms_full']:.2f} ms, parent commit "
            f"{EARLIER_MS.get(key + ' full')} ms); max abs err vs plain "
            f"{err:.3g}")
    return rows


def phase_config4():
    """Phase 13: BASELINE config 4, triplet_mnist_statistic on the
    surrogate at the JAX config_suite size."""
    from tuplewise_tpu_torch import triplet_mnist_statistic

    t0 = time.perf_counter()
    inc = triplet_mnist_statistic(n=2000, n_pairs=20_000, seed=SEED)
    t1 = time.perf_counter()
    comp = triplet_mnist_statistic(n=2000, n_pairs=None, seed=SEED)
    t2 = time.perf_counter()
    cpu = triplet_mnist_statistic(n=2000, n_pairs=None, seed=SEED,
                                  device="cpu")
    assert sorted(comp["per_class"]) == sorted(cpu["per_class"])
    for c, v in cpu["per_class"].items():
        assert abs(comp["per_class"][c] - v) <= 1e-6 * abs(v), (c, v)
        assert abs(inc["per_class"][c] - v) < 0.02, (c, v)
    log(f"[config 4] mnist surrogate n=2000 ({comp['data_meta']['source']}):"
        f" complete mean {comp['mean']:.9f} ({t2 - t1:.2f} s) equals the "
        f"CPU plain path per class within rel 1e-6; incomplete (B=2e4) mean"
        f" {inc['mean']:.6f} ({t1 - t0:.2f} s)")
    return dict(complete_mean=comp["mean"], incomplete_mean=inc["mean"],
                complete_s=t2 - t1, incomplete_s=t1 - t0)


def _split(X, frac, rng):
    p = rng.permutation(len(X))
    t = int(frac * len(X))
    return X[p[:t]], X[p[t:]]


def triplet_task(task, seed):
    """The data of scripts/learning_suite.py stage_triplet, uncut:
    (Xc_tr, Xo_tr, Xc_te, Xo_te) float32."""
    from tuplewise_tpu_torch.data import load_mnist_embeddings, make_gaussians

    rng = np.random.default_rng(seed)
    if task == "gauss-overlap":
        X, Y = make_gaussians(2_000, 6_000, dim=16, separation=1.0,
                              seed=seed)
    elif task == "mnist-surrogate":
        E, labels, _ = load_mnist_embeddings(n=4_000, seed=seed)
        X, Y = E[labels == 3], E[labels != 3]
    else:                                          # radial, d = 8
        def shell(m, r_lo, r_hi):
            v = rng.standard_normal((m, 8))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            r = rng.uniform(r_lo, r_hi, size=(m, 1))
            return (v * r).astype(np.float32)

        X, Y = shell(2_000, 0.5, 1.0), shell(6_000, 1.8, 2.6)
    Xc_tr, Xc_te = _split(np.asarray(X, np.float32), 0.75, rng)
    Xo_tr, Xo_te = _split(np.asarray(Y, np.float32), 0.75, rng)
    return Xc_tr, Xo_tr, Xc_te, Xo_te


def phase_triplet_learner():
    """Phase 14: the triplet learner at the full width of
    scripts/learning_suite.py stage_triplet (N = 8, B = 4096); the path
    whose evaluations count for kernel 5."""
    from tuplewise_tpu_torch.models.scorers import LinearEmbed, MLPEmbed
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, evaluate_triplet_accuracy, init_embed,
        train_triplet,
    )

    out = {}

    def cell(task, S, steps, lr, make_embed=None):
        accs, acc0s, train_s, total_steps = [], [], 0.0, 0
        for s in range(S):
            Xc_tr, Xo_tr, Xc_te, Xo_te = triplet_task(task, s)
            dim = Xc_tr.shape[1]
            emb = None if make_embed is None else make_embed(dim)
            p0 = init_embed(dim, 2, seed=s) if emb is None else emb.init(s)
            acc0s.append(evaluate_triplet_accuracy(p0, Xc_te, Xo_te,
                                                   embedder=emb))
            cfg = TripletTrainConfig(lr=lr, steps=steps, n_workers=8,
                                     repartition_every=1,
                                     triplets_per_worker=4_096,
                                     seed=1_000 + s, embed_dim=2)
            t0 = time.perf_counter()
            _, hist = train_triplet(p0, Xc_tr, Xo_tr, cfg,
                                    eval_every=max(steps // 10, 1),
                                    eval_data=(Xc_te, Xo_te), embedder=emb)
            train_s += time.perf_counter() - t0
            total_steps += steps
            assert np.isfinite(hist["loss"]).all() and len(
                hist["test_acc"]) == 10, hist
            accs.append(float(hist["test_acc"][-1]))
        accs = np.asarray(accs)
        se = float(accs.std(ddof=1) / np.sqrt(S)) if S > 1 else None
        return dict(acc_init=acc0s, final_acc=accs.tolist(),
                    final_acc_mean=float(accs.mean()), final_acc_se=se,
                    steps_per_s_with_eval=total_steps / train_s)

    r = cell("gauss-overlap", 8, 300, 0.1)
    band = 3 * math.sqrt(r["final_acc_se"] ** 2 + JAX_GAUSS_OVERLAP[1] ** 2)
    assert abs(r["final_acc_mean"] - JAX_GAUSS_OVERLAP[0]) < band, (r, band)
    assert all(a > a0 for a, a0 in zip(r["final_acc"], r["acc_init"])), r
    out["gauss-overlap"] = r
    log(f"[triplet learner] gauss-overlap N=8 B=4096 300 steps S=8: test "
        f"acc {np.mean(r['acc_init']):.6f} -> {r['final_acc_mean']:.6f} +- "
        f"{r['final_acc_se']:.6f} (JAX row {JAX_GAUSS_OVERLAP[0]} +- "
        f"{JAX_GAUSS_OVERLAP[1]}, band +-{band:.6f}); "
        f"{r['steps_per_s_with_eval']:.2f} steps/s with 10 evaluations")
    r = cell("mnist-surrogate", 1, 300, 0.1)
    assert r["final_acc_mean"] >= 0.99, r
    out["mnist-surrogate"] = r
    log(f"[triplet learner] mnist-surrogate S=1: test acc "
        f"{r['acc_init'][0]:.6f} -> {r['final_acc_mean']:.6f}")
    for name, make in (("linear", lambda d: LinearEmbed(dim=d, embed_dim=2)),
                       ("mlp", lambda d: MLPEmbed(dim=d, hidden=32,
                                                  embed_dim=2))):
        out[f"radial-{name}"] = cell("radial", 2, 800, 0.3, make)
    lin, mlp = out["radial-linear"], out["radial-mlp"]
    assert mlp["final_acc_mean"] > lin["final_acc_mean"] + 0.05, (lin, mlp)
    log(f"[triplet learner] radial 800 steps S=2: linear "
        f"{lin['final_acc_mean']:.6f}, mlp (hidden 32) "
        f"{mlp['final_acc_mean']:.6f}")

    # steps/s of the bare step engine: 300 gauss-overlap steps, no eval
    Xc_tr, Xo_tr, _, _ = triplet_task("gauss-overlap", 0)
    cfg = TripletTrainConfig(lr=0.1, steps=300, n_workers=8,
                             repartition_every=1, triplets_per_worker=4_096,
                             seed=1_000, embed_dim=2)
    ms, _ = cuda_ms(lambda: train_triplet(init_embed(16, 2), Xc_tr, Xo_tr,
                                          cfg))
    out["steps_per_s"] = 300 / ms * 1e3
    log(f"[triplet learner] gauss-overlap 300 steps without evaluation: "
        f"{out['steps_per_s']:.2f} steps/s "
        f"({out['steps_per_s'] * 8 * 4096:.4g} triplets/s)")
    return out


def phase_triplet_resume():
    """Phase 15: a triplet run cut at a checkpoint equals the uncut run
    bit for bit (params, losses and the accuracy curve)."""
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, init_embed, train_triplet,
    )

    Xc_tr, Xo_tr, Xc_te, Xo_te = triplet_task("gauss-overlap", 1)
    cfg = TripletTrainConfig(lr=0.1, steps=60, n_workers=8,
                             repartition_every=7, triplets_per_worker=4_096,
                             seed=5, embed_dim=2)
    kw = dict(eval_every=20, eval_data=(Xc_te, Xo_te))
    p0 = init_embed(16, 2, seed=3)
    p_full, h_full = train_triplet(p0, Xc_tr, Xo_tr, cfg, **kw)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "triplet.npz")
        train_triplet(p0, Xc_tr, Xo_tr, dataclasses.replace(cfg, steps=20),
                      checkpoint_path=path, **kw)
        p_res, h_res = train_triplet(p0, Xc_tr, Xo_tr, cfg,
                                     checkpoint_path=path, **kw)
    assert p_full["W"].tobytes() == p_res["W"].tobytes()
    for k in ("loss", "eval_steps", "test_acc"):
        assert h_full[k].tobytes() == h_res[k].tobytes(), k
    log(f"[triplet resume] 60 steps = 20 steps + checkpoint + 40 resumed, "
        f"bit for bit (params, loss, accuracy curve {h_full['test_acc']})")


def padded(run, cap):
    """A sorted run padded with +inf to ``cap``, as the index places it."""
    pad = torch.full((cap - len(run),), math.inf, device=run.device)
    return torch.cat([run, pad])


def tied_queries(gen, n, run):
    """n queries, half of them values of ``run`` (ties at run values)."""
    q = torch.randn(n, generator=gen, device="cuda")
    at = torch.randint(0, len(run), (n // 2,), generator=gen, device="cuda")
    q[: n // 2] = run[at]
    return q


def searched(run, q):
    """Replays kernel 6's lower and upper binary searches of ``run`` for
    queries ``q`` (the same halving as ``bound`` in signed_count.cu).
    Returns (distinct 32-byte sectors of the run they read, loads made,
    the longest chain of dependent loads of one query)."""
    touched, loads, chain = [], 0, 0
    for upper in (False, True):
        lo = torch.zeros(len(q), dtype=torch.int64, device=q.device)
        n = torch.full_like(lo, run.numel())
        steps = 0
        while run.numel() and bool((n > 0).any()):
            live = n > 0
            half = n >> 1
            at = lo + half
            touched.append(at[live])
            loads += int(live.sum())
            steps += 1
            v = run[at.clamp(max=run.numel() - 1)]
            right = (v <= q) if upper else (v < q)
            lo = torch.where(live & right, lo + half + 1, lo)
            n = torch.where(live, torch.where(right, n - half - 1, half), n)
        chain += steps
    sectors = (int(torch.unique(torch.cat(touched) // 8).numel())
               if touched else 0)
    return sectors, loads, chain


def count_bound_ms(runs, sets, qa, qb):
    """Bound of a signed count from what these inputs need: the run
    sectors the binary searches read (each once), the queries read once
    and the [4, q] int32 block written once, at HBM rate; or one
    comparison per load at the FP32 peak. Also returns the dependent
    loads a thread of kernel 6's first form made one after another (its
    latency chain, the lower and then the upper binary search)."""
    lens, qs = (len(qa), len(qb)), (qa, qb)
    sectors = loads = 0
    chains = [0, 0]           # a thread searches every run of its set
    for r, a in zip(runs, sets):
        s, l, c = searched(r, qs[a])
        sectors, loads, chains[a] = sectors + s, loads + l, chains[a] + c
    byts = 32.0 * sectors + 4.0 * sum(lens) + 16.0 * max(lens)
    by = ("operations" if loads / PEAK_FP32_OPS >= byts / PEAK_BYTES
          else "bytes")
    return (max(loads / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by,
            max(chains))


def count_call_split(args, reps=1000):
    """Host microseconds of each part of a signed count, the mean over
    reps calls (perf_counter; the device is not waited for inside a
    part): ``ck._check``; ``ck._launch`` at one worker (ctypes
    marshalling and the enqueued launch); the query copy up as ``signed_pair_counts`` makes it
    (one concatenation of the host queries to a device tensor); the [4, q]
    block copy back to int64 numpy; and the whole ``signed_pair_counts``
    call on the placed runs."""
    from tuplewise_tpu_torch.ops import count_kernels as ck
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    runs, signs, sets, qa, qb = args
    wargs = ([r[None] for r in runs], signs, sets, qa, qb)
    qa_h, qb_h = qa.cpu().numpy(), qb.cpu().numpy()
    out = ck.signed_count(*args)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / reps * 1e6

    sides = [[(r, r.numel(), s) for r, s, a in zip(runs, signs, sets)
              if a == side] for side in (0, 1)]
    return dict(
        check=host_us(lambda: ck._check(*wargs)),
        marshal_and_launch=host_us(lambda: ck._launch(
            *wargs, 1, "signed_count[flat]")),
        copy_up=host_us(lambda: torch.from_numpy(
            np.concatenate([qa_h, qb_h])).to("cuda")),
        copy_back=host_us(lambda: out.cpu().numpy().astype(np.int64)),
        count_layer_call=host_us(lambda: sc.signed_pair_counts(
            None, *sides, qa_h, qb_h, kernel=True)))


def phase_count_vs_plain():
    """Phase 16: kernel 6 against its plain version and the searchsorted
    chain, as integers, on phase 16's runs and on the search's edge cases;
    the timing row at the headline shape, with the call's split."""
    from tuplewise_tpu_torch.ops import count_kernels as ck
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def run_of(n, shift=0.0):
        # values on a 1/64 grid: many duplicates
        v = torch.round(torch.randn(n, generator=g, device="cuda") * 64) / 64
        return torch.sort(v + shift).values

    def picked(run, k):
        at = torch.randperm(len(run), generator=g, device="cuda")[:k]
        return torch.sort(run[at]).values

    base, pos = run_of(1_000_003), run_of(500_009, 0.5)
    runs = [padded(base, sc.next_bucket(len(base))), picked(base, 4097),
            run_of(30_011), padded(pos, sc.next_bucket(len(pos))),
            picked(pos, 777), torch.empty(0, device="cuda")]
    signs, sets = [1, -1, 1, 1, -1, 1], [0, 0, 0, 1, 1, 1]
    err = 0

    def differ(got, want):
        return int((got.long() - want.long()).abs().max())

    for la, lb in [(1, 255), (255, 1), (513, 4099), (4099, 513)]:
        qa, qb = tied_queries(g, la, base), tied_queries(g, lb, pos)
        args = (runs, signs, sets, qa, qb)
        got = ck.signed_count(*args)
        err = max(err, differ(got, ck.signed_count_plain(*args)),
                  differ(got, sc.signed_count_searchsorted(*args)))
        assert err == 0, (la, lb, err)
        log(f"[count vs plain] k=6 (base 1000003 +1, tombstones 4097 -1, "
            f"delta 30011 +1 | 500009 +1, 777 -1, empty) qa={la} qb={lb}: "
            f"kernel = plain = searchsorted")

    # the search's edge cases: 8 runs of mixed signs and sets, odd and
    # empty runs, runs shorter than the top, -inf, +inf and -0.0 values,
    # +inf padding; NaN, +-inf, +-0.0 and half-tied queries. A NaN query
    # counts 0 (comparisons, as the JAX Pallas kernel); the searchsorted
    # route sorts NaN last, as jnp.searchsorted does, so it is held to the
    # kernel at the other queries only
    lens = [0, 1, 2, 3, 254, 255, 257, 30011]
    e_runs = [run_of(n, 0.5 * (k % 2)) for k, n in enumerate(lens)]
    e_runs[2] = torch.tensor([-math.inf, math.inf], device="cuda")
    e_runs[3] = torch.tensor([-math.inf, -0.0, math.inf], device="cuda")
    e_runs[7] = padded(e_runs[7], sc.next_bucket(lens[7]))
    e_signs, e_sets = [1, -1, 1, -1, 1, 1, -1, 1], [0, 1, 0, 1, 0, 1, 1, 0]
    special = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.0],
                           device="cuda")

    def edge_queries(n, side):
        pool = torch.cat([r for r, a in zip(e_runs, e_sets) if a == side])
        q = tied_queries(g, n, pool)
        q[:min(n, 5)] = special[:min(n, 5)]
        return q

    for la, lb in [(255, 1), (64, 63), (1, 300), (513, 4099)]:
        qa, qb = edge_queries(la, 0), edge_queries(lb, 1)
        args = (e_runs, e_signs, e_sets, qa, qb)
        got = ck.signed_count(*args)
        lib = sc.signed_count_searchsorted(*args)
        num = torch.ones_like(got, dtype=torch.bool)
        num[:2, :la] = ~qa.isnan()
        num[2:, :lb] = ~qb.isnan()
        err = max(err, differ(got, ck.signed_count_plain(*args)),
                  differ(got[num], lib[num]))
        assert err == 0, (la, lb, err)
        assert not got[:, 0].any(), "a NaN query counts 0"
        log(f"[count vs plain] k=8 (lengths {lens}, signs {e_signs}, sets "
            f"{e_sets}; +-inf and -0.0 values; NaN, +-inf, +-0.0 and tied "
            f"queries) qa={la} qb={lb}: kernel = plain, = searchsorted but "
            f"at NaN; {ck.signed_rounds(max(r.numel() for r in e_runs))} "
            f"dependent rounds")

    neg_b, pos_b = run_of(COUNT_BASE), run_of(COUNT_BASE, 1.0)
    cap = sc.next_bucket(COUNT_BASE)
    runs = [padded(neg_b, cap), padded(pos_b, cap)]
    qa, qb = tied_queries(g, COUNT_Q, neg_b), tied_queries(g, COUNT_Q, pos_b)
    args = (runs, [1, 1], [0, 1], qa, qb)
    times = {}
    for name, fn, reps in (
            ("kernel", lambda: ck.signed_count(*args), 1000),
            ("plain", lambda: ck.signed_count_plain(*args), 5),
            ("library", lambda: sc.signed_count_searchsorted(*args), 200)):
        fn()                                                  # warm-up
        times[name] = timed_on_device(fn, reps)
    got, want, chain = (times[k][2] for k in ("kernel", "plain", "library"))
    err = max(err, differ(got, want), differ(got, chain))
    assert err == 0, err
    bms, by, loads = count_bound_ms(runs, [0, 1], qa, qb)
    (call_ms, ms, _), (_, plain_ms, _), (lib_call_ms, lib_ms, _) = (
        times["kernel"], times["plain"], times["library"])
    split = count_call_split(args)
    row = dict(
        name="signed_count[flat]", route="cuda",
        source=source_of("signed_count"),
        replaces=REPLACES["signed_count"], launches=None, max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        rounds=ck.signed_rounds(cap), dependent_loads_earlier=loads,
        call_split_us=split, library_ms=lib_ms, library_call_ms=lib_call_ms,
        library_calls=f"{2 * len(runs)} searchsorted",
        shape=f"2 runs of {COUNT_BASE} (cap {cap}), qa=qb={COUNT_Q}")
    log(f"[timing] signed_count[flat] {row['shape']}: {ms * 1e3:.2f} us of "
        f"device time a launch ({call_ms * 1e3:.2f} us a call by events; "
        f"bound {bms * 1e3:.3f} us by {by}, from the sectors the binary "
        f"searches read; a cell's chain is {row['rounds']} dependent rounds,"
        f" the first form's {loads} dependent loads; parent commit "
        f"{EARLIER_MS.get('signed_count')} ms), plain "
        f"{plain_ms * 1e3:.1f} us, searchsorted chain "
        f"({row['library_calls']}) {lib_ms * 1e3:.2f} us "
        f"({lib_call_ms * 1e3:.2f} us a call); max |kernel - plain|, "
        f"|kernel - searchsorted| = {err}")
    log(f"[timing] signed_count[flat] call split, host us a call: "
        f"{json.dumps({k: round(v, 2) for k, v in split.items()})}; kernel "
        f"{ms * 1e3:.2f} us of device time")
    return row


def drive_index(scores, labels, count_kernel, n, device="cuda"):
    """bench.py _serving_kernel_cell on one device: n events of the
    stream through ExactAucIndex (window n/2, compact_every 1024) in
    micro-batches of 256 after seeding and compacting the first one.
    Returns (record, wins2 after every batch, the index)."""
    from tuplewise_tpu_torch import ExactAucIndex
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    c = INDEX_CHUNK
    idx = ExactAucIndex(window=n // 2, compact_every=INDEX_COMPACT,
                        count_kernel=count_kernel, device=device)
    idx.insert_batch(scores[:c], labels[:c])
    idx.compact()
    calls0 = idx.metrics.snapshot()["count_kernel_calls_total"]["value"]
    launches0 = pk.LAUNCHES["signed_count[flat]"]
    wins, lats = [], []
    t_all = time.perf_counter()
    for i in range(c, n, c):
        t0 = time.perf_counter()
        idx.insert_batch(scores[i:i + c], labels[i:i + c])
        lats.append(time.perf_counter() - t0)
        wins.append(idx._wins2)
    wall = time.perf_counter() - t_all
    snap = idx.metrics.snapshot()
    lat = np.asarray(lats) * 1e3
    rec = dict(
        events_per_s=(n - c) / wall, wall_s=wall,
        insert_latency_p50_ms=float(np.percentile(lat, 50)),
        insert_latency_p99_ms=float(np.percentile(lat, 99)),
        batches=len(lats),
        kernel_calls=snap["count_kernel_calls_total"]["value"] - calls0,
        kernel_launches=pk.LAUNCHES["signed_count[flat]"] - launches0,
        kernel_fallbacks=snap["count_kernel_fallbacks_total"]["value"],
        compactions=snap["compactions_total"]["value"],
        bytes_h2d=snap["bytes_h2d"]["value"])
    return rec, wins, idx


def phase_index():
    """Phase 17: the index at _serving_kernel_cell's single-device size,
    count_kernel on and off, each warmed once on a prefix; the path whose
    launches count for kernel 6. Returns (record, the final runs and one
    batch's queries for the per-launch timing)."""
    from tuplewise_tpu_torch.models.metrics import auc_score
    from tuplewise_tpu_torch.serving import make_stream

    n, c = INDEX_EVENTS, INDEX_CHUNK
    scores, labels = make_stream(n, pos_frac=0.5, separation=1.0, seed=0)
    scores = scores.astype(np.float32)
    out, wins = {}, {}
    for mode, ck in (("kernel", True), ("searchsorted", False)):
        warm = drive_index(scores, labels, ck, INDEX_WARM_EVENTS)[2]
        warm.close()
        rec, wins[mode], idx = drive_index(scores, labels, ck, n)
        out[mode] = rec
        tail_s, tail_l = scores[n - n // 2:], labels[n - n // 2:]
        oracle = auc_score(tail_s[tail_l], tail_s[~tail_l])
        assert idx.auc() == oracle, (mode, idx.auc(), oracle)
        rec["auc"] = idx.auc()
        if ck:
            assert rec["kernel_calls"] == rec["batches"], rec
            assert rec["kernel_launches"] == rec["batches"], rec
            assert rec["kernel_fallbacks"] == 0, rec
            q_s, q_l = scores[n - 2 * c:], labels[n - 2 * c:]
            probe = (idx._runs(idx._neg) + idx._runs(idx._pos),
                     torch.from_numpy(q_s[q_l]).cuda(),
                     torch.from_numpy(q_s[~q_l]).cuda())
        idx.close()
        log(f"[index] {mode:12s} n={n} window={n // 2} chunk={c}: "
            f"{rec['events_per_s']:.0f} events/s, insert p50 "
            f"{rec['insert_latency_p50_ms']:.3f} ms p99 "
            f"{rec['insert_latency_p99_ms']:.3f} ms, {rec['batches']} "
            f"batches, {rec['kernel_launches']} kernel launches, "
            f"{rec['compactions']} compactions, {rec['bytes_h2d']} bytes "
            f"placed; auc {rec['auc']!r} = the float32 rank-AUC oracle")
    assert wins["kernel"] == wins["searchsorted"], "wins2 diverged"
    log(f"[index] wins2 equal after each of {len(wins['kernel'])} batches")
    return out, probe


def time_index_kernel(probe, out):
    """Kernel 6 at the index's own shape (its final base runs, one
    batch's insert and eviction queries), outside the counted run."""
    from tuplewise_tpu_torch.ops import count_kernels as ck

    runs, qa, qb = probe
    args = ([r for r, _, _ in runs], [1, 1], [0, 1], qa, qb)
    ck.signed_count(*args)                                    # warm-up
    call_ms, ms, got = timed_on_device(lambda: ck.signed_count(*args), 1000)
    assert torch.equal(got, ck.signed_count_plain(*args))
    bms, by, loads = count_bound_ms(args[0], [0, 1], qa, qb)
    out["kernel_us_per_launch"] = ms * 1e3
    out["kernel_call_us"] = call_ms * 1e3
    out["kernel_bound_us"] = bms * 1e3
    out["kernel_rounds"] = max(ck.signed_rounds(r.numel()) for r in args[0])
    out["kernel_call_split_us"] = count_call_split(args)
    out["kernel_shape"] = (f"caps {[r.numel() for r in args[0]]}, "
                           f"qa={len(qa)} qb={len(qb)}")
    log(f"[index] kernel 6 at the index's shape ({out['kernel_shape']}): "
        f"{ms * 1e3:.2f} us of device time a launch ({call_ms * 1e3:.2f} us "
        f"a call by events; bound {bms * 1e3:.3f} us by {by}; a cell's chain "
        f"is {out['kernel_rounds']} dependent rounds, the first form's "
        f"{loads} dependent loads; parent commit "
        f"{EARLIER_MS.get('signed_count index')} ms); call split, host us a "
        f"call: {json.dumps({k: round(v, 2) for k, v in out['kernel_call_split_us'].items()})}")


def phase_engine():
    """Phase 18: MicroBatchEngine through replay at the size of bench.py
    _streaming_events_per_sec, bg_compact on and off."""
    from tuplewise_tpu_torch import ServingConfig, make_stream, replay
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    scores, labels = make_stream(ENGINE_EVENTS, pos_frac=0.5, separation=1.0,
                                 seed=0)
    out = {}
    for bg in (True, False):
        cfg = ServingConfig(budget=64, max_batch=256, policy="block",
                            flush_timeout_s=0.0005, compact_every=1024,
                            bg_compact=bg, count_kernel=True)
        before = pk.LAUNCHES["signed_count[flat]"]
        rec = replay(scores, labels, config=cfg, warmup=True,
                     max_inflight=64)
        launched = pk.LAUNCHES["signed_count[flat]"] - before
        assert rec["events_applied"] == ENGINE_EVENTS, rec["events_applied"]
        assert rec["auc_abs_err"] == 0, rec["auc_abs_err"]
        assert launched > 0
        tax = rec["host_tax"]
        keep = ("events_per_s", "latency_p50_ms", "latency_p99_ms",
                "insert_latency_p50_ms", "insert_latency_p99_ms",
                "insert_stage_p99_ms", "batches", "mean_batch_fill",
                "compactions", "compaction_pause_p99_ms", "auc_exact",
                "auc_abs_err", "bytes_h2d")
        out[f"bg_compact={bg}"] = dict(
            {k: rec[k] for k in keep}, host_tax=tax, kernel_launches=launched)
        stages = ", ".join(f"{k} {v:.3f}"
                           for k, v in rec["insert_stage_p99_ms"].items())
        buckets = ", ".join(f"{k} {v:.3f}"
                            for k, v in tax["bucket_p99_ms"].items())
        log(f"[engine] replay n={ENGINE_EVENTS} bg_compact={bg}: "
            f"{rec['events_per_s']:.0f} events/s, latency p50 "
            f"{rec['latency_p50_ms']:.3f} ms p99 {rec['latency_p99_ms']:.3f}"
            f" ms, {rec['batches']} batches (fill "
            f"{rec['mean_batch_fill']:.3f}), {launched} kernel launches "
            f"(warm-up run included), auc_abs_err 0")
        log(f"[engine]   insert stage p99 ms: {stages}")
        log(f"[engine]   host tax: host {tax['host_fraction']:.4f} device "
            f"{tax['device_fraction']:.4f} (coverage {tax['coverage']:.6f}); "
            f"bucket p99 ms: {buckets}")
    return out


def phase_streaming_estimator():
    """Phase 19: StreamingEstimator on the card; its exact AUC equals the
    float32 rank-AUC oracle."""
    from tuplewise_tpu_torch import StreamingEstimator, make_stream
    from tuplewise_tpu_torch.models.metrics import auc_score

    n = 100_000
    scores, labels = make_stream(n, seed=3)
    est = StreamingEstimator(count_kernel=True, compact_every=1024)
    t0 = time.perf_counter()
    for i in range(0, n, 1000):
        est.extend(scores[i:i + 1000], labels[i:i + 1000])
    wall = time.perf_counter() - t0
    s32 = scores.astype(np.float32)
    oracle = auc_score(s32[labels], s32[~labels])
    assert est.auc() == oracle, (est.auc(), oracle)
    log(f"[streaming estimator] n={n} in batches of 1000: auc "
        f"{est.auc()!r} = oracle, incomplete estimate {est.estimate():.6f}"
        f" ({n / wall:.0f} events/s)")
    return dict(auc=est.auc(), estimate=est.estimate(),
                events_per_s=n / wall)


def fleet_stream(n, tenants, skew=FLEET_SKEW, seed=0):
    """make_tenant_stream in float32, as the fleet stores it."""
    from tuplewise_tpu_torch.serving import make_tenant_stream

    scores, labels, tids = make_tenant_stream(n, tenants, skew=skew,
                                              seed=seed)
    return scores.astype(np.float32), labels, tids


def tenant_groups(tids):
    """(tenant id, the indices of its events in arrival order) for each
    tenant of a stream."""
    order = np.argsort(tids, kind="stable")
    bounds = np.flatnonzero(tids[order][1:] != tids[order][:-1]) + 1
    return [(str(tids[g[0]]), g) for g in np.split(order, bounds)]


def fleet_chunks(scores, labels, tids, chunk):
    """Each chunk of ``chunk`` events coalesced per tenant, as bench.py's
    fleet legs apply it: a list of (tenant, scores, labels) per chunk."""
    out = []
    for i in range(0, len(scores), chunk):
        s, lab, t = scores[i:i + chunk], labels[i:i + chunk], tids[i:i + chunk]
        out.append([(str(u), s[t == u], lab[t == u]) for u in np.unique(t)])
    return out


def fleet_packs(scores, labels, tids, t_bucket):
    """The final per-tenant runs of a stream as the fleet's two packs on
    the card (slot k = tenant tk, sorted, +inf padded), and the caps."""
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    runs = {True: [np.empty(0, np.float32)] * t_bucket,
            False: [np.empty(0, np.float32)] * t_bucket}
    for tid, grp in tenant_groups(tids):
        for pos in (True, False):
            runs[pos][int(tid[1:])] = np.sort(
                scores[grp][labels[grp] == pos])
    packs = [sc.place_tenant_pack(None, runs[pos], t_bucket, device="cuda")
             for pos in (True, False)]
    return packs[0][0], packs[1][0], packs[0][1], packs[1][1]


def apply_queries(items, t_bucket):
    """One apply's dense query blocks, as the fleet builds them (no
    window): slot k's positives against the negatives' pack, its
    negatives against the positives', zero elsewhere."""
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    qb = sc.next_bucket(max(max(int(lab.sum()), int((~lab).sum()))
                            for _, _, lab in items))
    qn = np.zeros((t_bucket, qb), np.float32)
    qp = np.zeros((t_bucket, qb), np.float32)
    for tid, s, lab in items:
        k = int(tid[1:])
        qn[k, :int(lab.sum())] = s[lab]
        qp[k, :int((~lab).sum())] = s[~lab]
    return torch.from_numpy(qn).cuda(), torch.from_numpy(qp).cuda()


def tenant_searched(pack, q):
    """Replays a lower and an upper binary search of each pack row for
    the queries of the same row, one halving a load (the searches of
    kernel 7 before its redesign, whose paths define its bound). Returns
    (distinct 32-byte sectors read, loads, the longest chain of dependent
    loads of one thread)."""
    T, cap = pack.shape
    flat = pack.reshape(-1)
    qf = q.reshape(-1)
    row0 = torch.arange(T, device=q.device).repeat_interleave(q.shape[1]) * cap
    touched, loads, chain = [], 0, 0
    for upper in (False, True):
        lo = torch.zeros_like(row0)
        n = torch.full_like(row0, cap)
        steps = 0
        while cap and bool((n > 0).any()):
            live = n > 0
            half = n >> 1
            at = lo + half
            touched.append((row0 + at)[live])
            loads += int(live.sum())
            steps += 1
            v = flat[row0 + at.clamp(max=cap - 1)]
            right = (v <= qf) if upper else (v < qf)
            lo = torch.where(live & right, lo + half + 1, lo)
            n = torch.where(live, torch.where(right, n - half - 1, half), n)
        chain += steps
    sectors = (int(torch.unique(torch.cat(touched) // 8).numel())
               if touched else 0)
    return sectors, loads, chain


def tenant_bound_ms(pos, neg, qn, qp):
    """Bound of one tenant count from what these inputs need: the row
    sectors the searches read, the two query blocks read once and the
    [4, T, q] int32 block written once, at HBM rate; or one comparison a
    load at the FP32 peak. Also the longest dependent-load chain."""
    sn, ln, cn = tenant_searched(neg, qn)
    sp, lp, cp = tenant_searched(pos, qp)
    byts = (32.0 * (sn + sp) + 4.0 * (qn.numel() + qp.numel())
            + 16.0 * qn.numel())
    loads = ln + lp
    by = ("operations" if loads / PEAK_FP32_OPS >= byts / PEAK_BYTES
          else "bytes")
    return (max(loads / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by,
            max(cn, cp), byts)


def phase_tenant_count_vs_plain():
    """Phase 20: kernel 7 against its plain version and the batched
    searchsorted route, as integers; the timing row at the headline."""
    from tuplewise_tpu_torch.ops import count_kernels as ck
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def grid_values(*shape):
        # values on a 1/8 grid: many duplicates and ties
        return torch.round(torch.randn(*shape, generator=g,
                                       device="cuda") * 8) / 8

    def pack(T, cap, lengths):
        p = torch.full((T, cap), math.inf, device="cuda")
        for t in range(T):
            n = lengths[t % len(lengths)]
            p[t, :n] = torch.sort(grid_values(n)).values
        return p

    def tied(p, qb):
        # half of each row's queries are values of its own row (its
        # first element when the row is empty is +inf: then a grid value)
        q = grid_values(p.shape[0], qb)
        at = torch.randint(0, p.shape[1], (p.shape[0], qb // 2),
                           generator=g, device="cuda")
        picked = torch.gather(p, 1, at)
        q[:, : qb // 2] = torch.where(torch.isinf(picked), q[:, : qb // 2],
                                      picked)
        return q

    def differ(got, want):
        return int((got.long() - want.long()).abs().max())

    err = 0
    for T, cap_p, cap_n, qb in [(8, 256, 1024, 256), (64, 2048, 512, 1024),
                                (8, 512, 256, 1024), (64, 256, 256, 256)]:
        pos = pack(T, cap_p, [0, cap_p, 7, cap_p // 2, 1])
        neg = pack(T, cap_n, [cap_n, 0, 3, 100, cap_n - 1])
        args = (pos, neg, tied(neg, qb), tied(pos, qb))
        got = ck.tenant_count(*args)
        err = max(err, differ(got, ck.tenant_count_plain(*args)),
                  differ(got, sc.tenant_count_searchsorted(*args)))
        assert err == 0, (T, cap_p, cap_n, qb, err)
        log(f"[tenant count vs plain] T={T} cap_pos={cap_p} cap_neg={cap_n} "
            f"qb={qb} (rows empty, full, partial, duplicates; tied "
            f"queries): kernel = plain = searchsorted")

    # the search's edge cases: NaN, +-inf, +-0.0 and 0.5 queries, a run
    # of 0.5 from n/8 to n/2 + 2 of a row (ties across the first halvings'
    # probes, which split the lower and upper bounds), empty rows, caps 1,
    # 3 and 2^17 + 5, caps that differ between the sides. A NaN query
    # counts 0 (comparisons); the searchsorted route sorts NaN last, as
    # the reference's jnp.searchsorted route does, so it is held to the
    # kernel at the other queries only
    def edge_pack(T, cap):
        p = torch.full((T, cap), math.inf, device="cuda")
        for t in range(T):
            n = (0, cap, 1, cap // 2 + 1, cap - 1)[t % 5]
            v = torch.sort(grid_values(n)).values
            if n > 8:
                v[n // 8 - 1:n // 2 + 2] = 0.5
                v = torch.sort(v).values
            p[t, :n] = v
        return p

    def edge_queries(p, qb):
        q = tied(p, qb)
        q[:, :5] = torch.tensor([math.nan, math.inf, -math.inf, -0.0, 0.5],
                                device="cuda")
        return q

    for T, cap_p, cap_n, qb in [(5, 1, 3, 256), (10, 3, 1, 1024),
                                (5, (1 << 17) + 5, 7, 256),
                                (10, 513, 40, 256),
                                (5, 4096, (1 << 17) + 5, 512)]:
        pos, neg = edge_pack(T, cap_p), edge_pack(T, cap_n)
        qn, qp = edge_queries(neg, qb), edge_queries(pos, qb)
        args = (pos, neg, qn, qp)
        got = ck.tenant_count(*args)
        lib = sc.tenant_count_searchsorted(*args)
        num = ~torch.stack([qn, qn, qp, qp]).isnan()
        err = max(err, differ(got, ck.tenant_count_plain(*args)),
                  differ(got[num], lib[num]))
        assert err == 0, (T, cap_p, cap_n, qb, err)
        assert not got[:, :, 0].any(), "a NaN query counts 0"
        log(f"[tenant count vs plain] T={T} cap_pos={cap_p} cap_neg={cap_n} "
            f"qb={qb} (NaN, +-inf, +-0.0 queries; tie runs across probes; "
            f"empty rows): kernel = plain, = searchsorted but at NaN; "
            f"{max(ck.tenant_rounds(cap_p), ck.tenant_rounds(cap_n))} "
            f"dependent rounds")

    scores, labels, tids = fleet_stream(FLEET_EVENTS, FLEET_TENANTS)
    pos, neg, cap_p, cap_n = fleet_packs(scores, labels, tids, FLEET_TENANTS)
    last = fleet_chunks(scores[-FLEET_CHUNK:], labels[-FLEET_CHUNK:],
                        tids[-FLEET_CHUNK:], FLEET_CHUNK)[0]
    qn, qp = apply_queries(last, FLEET_TENANTS)
    args = (pos, neg, qn, qp)
    times = {}
    for name, fn, reps in (
            ("kernel", lambda: ck.tenant_count(*args), 200),
            ("plain", lambda: ck.tenant_count_plain(*args), 1),
            ("library", lambda: sc.tenant_count_searchsorted(*args), 200)):
        fn()                                                  # warm-up
        times[name] = timed_on_device(fn, reps)
    got, want, lib = (times[k][2] for k in ("kernel", "plain", "library"))
    err = max(err, differ(got, want), differ(got, lib))
    assert err == 0, err
    bms, by, chain, byts = tenant_bound_ms(pos, neg, qn, qp)
    rounds = max(ck.tenant_rounds(cap_p), ck.tenant_rounds(cap_n))
    (call_ms, ms, _), (_, plain_ms, _), (lib_call_ms, lib_ms, _) = (
        times["kernel"], times["plain"], times["library"])
    shape = (f"T_bucket {FLEET_TENANTS}, caps {cap_p}/{cap_n}, qb "
             f"{qn.shape[1]} ({len(last)} tenants of a 256-event apply)")
    row = dict(
        name="tenant_count", route="cuda", source=source_of("tenant_count"),
        replaces=REPLACES["tenant_count"], launches=None, max_abs_err=err,
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        bound_bytes=byts, dependent_rounds=rounds,
        dependent_loads_earlier=chain, library_ms=lib_ms,
        library_call_ms=lib_call_ms, library_calls="4 batched searchsorted",
        shape=shape)
    log(f"[timing] tenant_count {shape}: {ms * 1e3:.2f} us of device time "
        f"a launch ({call_ms * 1e3:.2f} us a call by events; bound "
        f"{bms * 1e3:.3f} us by {by}: {byts / 1e6:.3f} MB; a thread's chain "
        f"is {rounds} dependent rounds, the earlier search's {chain} "
        f"dependent loads; parent commit {EARLIER_MS.get('tenant_count')} "
        f"ms), plain "
        f"{plain_ms:.1f} ms, batched searchsorted {lib_ms * 1e3:.2f} us "
        f"({lib_call_ms * 1e3:.2f} us a call); max |kernel - plain|, "
        f"|kernel - searchsorted| = {err}")
    return row


def drive_fleets(chunks, fleets):
    """Apply every chunk to each fleet in turn (lockstep); after each
    apply the touched tenants' wins2 must be equal across the fleets.
    Returns each fleet's apply latencies (s)."""
    lats = [[] for _ in fleets]
    for items in chunks:
        for lat, fleet in zip(lats, fleets):
            t0 = time.perf_counter()
            fleet.apply_inserts(items)
            lat.append(time.perf_counter() - t0)
        for tid, _, _ in items:
            w = {f.wins2(tid) for f in fleets}
            assert len(w) == 1, (tid, w)
    return lats


def fleet_record(fleet, lat, n_events, chunks, launches, **extra):
    snap = fleet.metrics.snapshot()
    v = {k: snap[k]["value"] for k in (
        "fleet_count_calls_total", "count_kernel_calls_total",
        "count_kernel_fallbacks_total", "compactions_total", "bytes_h2d",
        "bytes_h2d_saved", "pack_replaces_total", "pack_full_replaces_total",
        "fleet_whale_promotions")}
    lat = np.asarray(lat) * 1e3
    st = fleet.state()
    return dict(
        events_per_s=n_events / (lat.sum() / 1e3), applies=len(chunks),
        apply_p50_ms=float(np.percentile(lat, 50)),
        apply_p99_ms=float(np.percentile(lat, 99)),
        apply_max_ms=float(lat.max()), fleet_count_calls=v[
            "fleet_count_calls_total"],
        kernel_calls=v["count_kernel_calls_total"], kernel_launches=launches,
        kernel_fallbacks=v["count_kernel_fallbacks_total"],
        compactions=v["compactions_total"], bytes_h2d=v["bytes_h2d"],
        bytes_h2d_saved=v["bytes_h2d_saved"],
        pack_replaces=v["pack_replaces_total"],
        pack_full_replaces=v["pack_full_replaces_total"],
        whale_promotions=v["fleet_whale_promotions"],
        pack_caps=st["pack_caps"], t_bucket=st["t_bucket"],
        whales=st["whales"], **extra)


def phase_fleet():
    """Phase 21: the fleet index at the headline, count_kernel on and off
    in lockstep, each warmed once on a prefix; the path whose launches
    count for kernel 7."""
    from tuplewise_tpu_torch import TenantFleetIndex
    from tuplewise_tpu_torch.models.metrics import auc_score
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    n = FLEET_EVENTS
    scores, labels, tids = fleet_stream(n, FLEET_TENANTS)
    chunks = fleet_chunks(scores, labels, tids, FLEET_CHUNK)
    warm = FLEET_WARM_EVENTS // FLEET_CHUNK

    def fleet(ck):
        return TenantFleetIndex(compact_every=FLEET_COMPACT, count_kernel=ck)

    warm_fleets = [fleet(True), fleet(False)]
    drive_fleets(chunks[:warm], warm_fleets)
    for f in warm_fleets:
        f.close()
    del warm_fleets
    fleets = [fleet(True), fleet(False)]
    before = pk.LAUNCHES["tenant_count"]
    lats = drive_fleets(chunks, fleets)
    launched = pk.LAUNCHES["tenant_count"] - before
    # query and count bytes of each apply's one count (no window: a
    # tenant's queries are its new events of each class)
    qbs = np.asarray([sc.next_bucket(max(max(int(l.sum()), int((~l).sum()))
                                         for _, _, l in items))
                      for items in chunks], dtype=np.float64)
    q_bytes = float((8.0 * FLEET_TENANTS * qbs).mean())
    out = {}
    for mode, f, lat in zip(("kernel", "searchsorted"), fleets, lats):
        out[mode] = fleet_record(
            f, lat, n, chunks, launched if mode == "kernel" else 0,
            query_bytes_per_apply=q_bytes,
            count_bytes_per_apply=2.0 * q_bytes)
    rec = out["kernel"]
    assert launched == rec["applies"] == rec["fleet_count_calls"], rec
    assert rec["kernel_calls"] == rec["applies"], rec
    assert rec["kernel_fallbacks"] == 0, rec
    assert out["searchsorted"]["kernel_calls"] == 0
    # every tenant's exact AUC equals the float32 rank-AUC oracle
    checked = 0
    for tid, grp in tenant_groups(tids):
        s, lab = scores[grp], labels[grp]
        if not lab.any() or lab.all():
            continue
        want = auc_score(s[lab], s[~lab])
        for f in fleets:
            assert f.auc(tid) == want, (tid, f.auc(tid), want)
        checked += 1
    for f in fleets:
        f.close()
    for mode, r in out.items():
        log(f"[fleet] {mode:12s} n={n} T={FLEET_TENANTS} skew={FLEET_SKEW} "
            f"chunk={FLEET_CHUNK}: {r['events_per_s']:.0f} events/s, apply "
            f"p50 {r['apply_p50_ms']:.3f} ms p99 {r['apply_p99_ms']:.3f} ms "
            f"max {r['apply_max_ms']:.1f} ms, {r['applies']} applies, "
            f"{r['kernel_launches']} kernel launches, {r['compactions']} "
            f"compactions, caps {r['pack_caps']}, {r['bytes_h2d']} bytes "
            f"placed ({r['bytes_h2d_saved']} saved), {r['pack_replaces']} "
            f"re-places of which {r['pack_full_replaces']} full")
    log(f"[fleet] wins2 equal after each of {len(chunks)} applies; "
        f"{checked} tenants' auc() = their float32 oracle; query blocks "
        f"{q_bytes / 1e6:.3f} MB up, counts {2 * q_bytes / 1e6:.3f} MB down "
        f"an apply (mean)")
    return out


def phase_fleet_incremental():
    """Phase 21b: _fleet_incremental_cell's knobs (whales, bg_compact),
    without and with a window, the kernel on and off in lockstep."""
    from tuplewise_tpu_torch import TenantFleetIndex
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    scores, labels, tids = fleet_stream(INCR_EVENTS, INCR_TENANTS)
    chunks = fleet_chunks(scores, labels, tids, FLEET_CHUNK)
    out = {}
    for window in (None, INCR_WINDOW):
        before = dict(pk.LAUNCHES)
        fleets = [TenantFleetIndex(window=window, compact_every=FLEET_COMPACT,
                                   whale_threshold=INCR_WHALE,
                                   bg_compact=True, count_kernel=ck)
                  for ck in (True, False)]
        lats = drive_fleets(chunks, fleets)
        for f in fleets:
            f.wait_idle()
        assert ({t: fleets[0].wins2(t) for t in fleets[0].tenants()}
                == {t: fleets[1].wins2(t) for t in fleets[1].tenants()})
        delta = {k: pk.LAUNCHES[k] - before.get(k, 0)
                 for k in ("tenant_count", "signed_count[flat]")}
        rec = fleet_record(fleets[0], lats[0], INCR_EVENTS, chunks,
                           delta["tenant_count"],
                           whale_kernel_launches=delta["signed_count[flat]"],
                           searchsorted_events_per_s=(INCR_EVENTS
                                                      / sum(lats[1])))
        for f in fleets:
            f.close()
        assert rec["whale_promotions"] > 0, rec
        assert delta["tenant_count"] > 0 and delta["signed_count[flat]"] > 0
        assert rec["kernel_fallbacks"] == 0, rec
        out[f"window={window}"] = rec
        log(f"[fleet incremental] window={window} T={INCR_TENANTS} "
            f"n={INCR_EVENTS} whale_threshold={INCR_WHALE} bg_compact: "
            f"{rec['events_per_s']:.0f} events/s (searchsorted "
            f"{rec['searchsorted_events_per_s']:.0f}), apply p50 "
            f"{rec['apply_p50_ms']:.3f} ms p99 {rec['apply_p99_ms']:.3f} ms, "
            f"{rec['whale_promotions']} promotions, kernel 7 x "
            f"{delta['tenant_count']}, kernel 6 x "
            f"{delta['signed_count[flat]']}, {rec['pack_replaces']} re-places "
            f"({rec['pack_full_replaces']} full), {rec['bytes_h2d']} bytes "
            f"placed, {rec['bytes_h2d_saved']} saved; wins2 equal after "
            f"every apply")
    return out


def phase_fleet_engine():
    """Phase 22: MultiTenantEngine through replay_fleet at
    _multi_tenant_cell's knobs, T = 1024."""
    from tuplewise_tpu_torch import ServingConfig, replay_fleet
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    scores, labels, tids = fleet_stream(FLEET_ENGINE_EVENTS, FLEET_TENANTS)
    cfg = ServingConfig(budget=16, max_batch=256, policy="block",
                        flush_timeout_s=0.0005, compact_every=512,
                        count_kernel=True)
    before = pk.LAUNCHES["tenant_count"]
    rec = replay_fleet(scores, labels, tids, config=cfg, max_inflight=64,
                       warmup=True)
    launched = pk.LAUNCHES["tenant_count"] - before
    assert rec["events_applied"] == FLEET_ENGINE_EVENTS, rec["events_applied"]
    assert rec["tenant_auc_max_abs_err"] == 0, rec["tenant_auc_max_abs_err"]
    assert launched > 0
    m = rec["report"]
    tax = rec["host_tax"]
    keep = ("events_per_s", "insert_latency_p50_ms", "insert_latency_p99_ms",
            "tenant_insert_p99_max_ms", "tenant_insert_p99_median_ms",
            "batches", "fleet_count_calls", "bytes_h2d", "bytes_h2d_saved",
            "pack_replaces", "pack_full_replaces", "tenant_auc_max_abs_err",
            "tenants_live")
    out = dict({k: rec[k] for k in keep}, host_tax=tax,
               kernel_launches=launched, compactions=m["compactions_total"])
    buckets = ", ".join(f"{k} {v:.3f}"
                        for k, v in tax["bucket_p99_ms"].items())
    log(f"[fleet engine] replay_fleet n={FLEET_ENGINE_EVENTS} "
        f"T={FLEET_TENANTS}: {rec['events_per_s']:.0f} events/s, insert p50 "
        f"{rec['insert_latency_p50_ms']:.3f} ms p99 "
        f"{rec['insert_latency_p99_ms']:.3f} ms, tenant p99 worst "
        f"{rec['tenant_insert_p99_max_ms']:.3f} ms median "
        f"{rec['tenant_insert_p99_median_ms']:.3f} ms, {rec['batches']} "
        f"batches, {rec['fleet_count_calls']} fleet counts, {launched} kernel "
        f"launches (warm-up run included), tenant_auc_max_abs_err 0")
    log(f"[fleet engine]   host tax: host {tax['host_fraction']:.4f} device "
        f"{tax['device_fraction']:.4f} (coverage {tax['coverage']:.6f}); "
        f"bucket p99 ms: {buckets}")
    return out


# --------------------------------------------------------------------- #
# slice 12: the distinct sampling designs drawn on the card              #
# --------------------------------------------------------------------- #

def phase_designs(data, triplet_main):
    """Phase 23: the swor and bernoulli designs on their paths at full
    width: the draws (under sync debug "error"), the estimator, the
    harness (config 3, fix_data, a chunked resume, the trade-off curves,
    the looped degree-3 schemes), the budgeted learners and the entry.
    Returns the numbers of the JSON line."""
    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.data import load_adult_splits
    from tuplewise_tpu_torch.estimators.variance import (
        conditional_incomplete_variance,
    )
    from tuplewise_tpu_torch.graft_entry import entry
    from tuplewise_tpu_torch.harness import variance as H
    from tuplewise_tpu_torch.models.pairwise_sgd import (
        TrainConfig, evaluate_auc, split_by_label, train_pairwise,
    )
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.ops.device_design import (
        draw_pair_design_device,
    )
    from tuplewise_tpu_torch.utils.checkpoint import load_checkpoint
    from tuplewise_tpu_torch.utils.rng import generator

    out = {}
    n, B, M = 10 ** 6, 10 ** 4, 64
    # 1. the draws at config 3's grid, 64 rows a call; nothing may stop
    # the host, so the events are read after the debug mode is off
    g = generator(SEED, "design", device="cuda")
    draws = {}
    for design in ("swr", "swor", "bernoulli"):
        draw_pair_design_device(g, n, n, B, design, batch=(M,))   # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        start.record()
        for _ in range(10):
            i, j, w = draw_pair_design_device(g, n, n, B, design,
                                              batch=(M,))
        end.record()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        draws[design] = start.elapsed_time(end) / 10
        sizes = w.sum(1).double()
        if design == "swor":
            code = i * n + j
            distinct = (code.sort(1).values.diff(dim=1) != 0).sum(1) + 1
            assert bool((sizes == B).all()) and bool((distinct == B).all())
        if design == "bernoulli":
            # K ~ Binomial(10^12, 10^-8): mean B, sd ~sqrt(B)
            assert abs(float(sizes.mean()) - B) < 5 * math.sqrt(B / M), sizes
    log(f"[designs] draw n={n} x {n} B={B} batch {M}: swr "
        f"{draws['swr']:.3f} ms, swor {draws['swor']:.3f} ms, bernoulli "
        f"{draws['bernoulli']:.3f} ms a call (no host sync)")
    out["draw_ms"] = draws

    # 2. the estimator: pairs at config 3, triplets at phase 12's data
    gs = torch.Generator(device="cuda").manual_seed(SEED + 23)
    s1 = torch.randn(n, generator=gs, device="cuda") + 1.0
    s2 = torch.randn(n, generator=gs, device="cuda")
    est = Estimator("auc", backend="torch")
    u = est.complete(s1, s2)
    out["estimator"] = {}
    for design in ("swor", "bernoulli"):
        est.incomplete(s1, s2, n_pairs=B, seed=SEED, design=design)
        ms, v = cuda_ms(lambda: est.incomplete(s1, s2, n_pairs=B, seed=SEED,
                                               design=design))
        se = math.sqrt(conditional_incomplete_variance(
            u * (1 - u), n * n, n_pairs=B, design=design))
        assert abs(v - u) < 5 * se, (design, v, u, se)
        out["estimator"][design] = dict(value=v, ms=ms)
        log(f"[designs] Estimator('auc').incomplete n={n} B={B} {design}: "
            f"{v:.6f} (complete {u:.6f}, se {se:.2e}) in {ms:.3f} ms")
    gt = torch.Generator(device="cuda").manual_seed(SEED + 6)
    gaussian_clouds(gt, 1024, TRIPLET_D)             # phase 12's draws
    X3, Y3 = gaussian_clouds(gt, TRIPLET_N, TRIPLET_D)
    full = triplet_main["triplet_indicator"]["complete"]
    tri = Estimator("triplet_indicator", backend="torch")
    tri.incomplete(X3, Y3, n_pairs=20_000, seed=SEED, design="swor")
    ms, v = cuda_ms(lambda: tri.incomplete(X3, Y3, n_pairs=20_000,
                                           seed=SEED, design="swor"))
    se = math.sqrt(full * (1 - full) / 20_000)
    assert abs(v - full) < 5 * se, (v, full, se)
    out["estimator"]["triplet_swor"] = dict(value=v, ms=ms)
    log(f"[designs] triplet_indicator incomplete n={TRIPLET_N} "
        f"d={TRIPLET_D} B=2e4 swor: {v:.6f} (complete {full:.6f}) in "
        f"{ms:.3f} ms")
    del X3, Y3, s1, s2

    # 3-4. the harness at config 3, straight and chunked with a checkpoint
    out["harness"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for design in ("swor", "bernoulli"):
            cfg = H.VarianceConfig(kernel="auc", scheme="incomplete",
                                   n_pos=n, n_neg=n, n_pairs=B, n_reps=M,
                                   design=design, seed=SEED)
            H.run_variance_experiment(cfg)                  # warm-up
            straight = os.path.join(tmp, f"{design}-straight.npz")
            r = H.run_variance_experiment(cfg, checkpoint_path=straight)
            ratio = r["variance"] / r["closed_form_variance"]
            assert CHI2_BAND[0] < ratio < CHI2_BAND[1], (design, ratio)
            assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]
            cut = os.path.join(tmp, f"{design}-cut.npz")
            H.run_variance_experiment(dataclasses.replace(cfg, n_reps=32),
                                      checkpoint_path=cut,
                                      checkpoint_every=16)
            rc = H.run_variance_experiment(cfg, checkpoint_path=cut,
                                           checkpoint_every=16)
            a = load_checkpoint(straight)["extra"]["estimates"]
            b = load_checkpoint(cut)["extra"]["estimates"]
            assert rc["recovery"]["resumed_from"] == 32
            assert a.tobytes() == b.tobytes(), design
            out["harness"][design] = dict(
                mean=r["mean"], variance=r["variance"],
                closed_form_variance=r["closed_form_variance"], ratio=ratio,
                ms=r["wallclock_s"] * 1e3,
                chunked_ms=rc["wallclock_s"] * 1e3)
            log(f"[designs] harness config 3 (n={n}, B={B}, M={M}) "
                f"{design}: var {r['variance']:.4e} closed form "
                f"{r['closed_form_variance']:.4e} ratio {ratio:.3f} "
                f"({r['wallclock_s'] * 1e3:.1f} ms); 2 + 2 chunks of 16 "
                f"with a resume equal the straight run bit for bit")
    var = {}
    for design in ("swr", "swor", "bernoulli"):
        cfg = H.VarianceConfig(kernel="auc", scheme="incomplete", n_pos=100,
                               n_neg=100, n_pairs=5000, n_reps=800,
                               design=design, fix_data=True, seed=SEED)
        r = H.run_variance_experiment(cfg)
        var[design] = r["variance"]
        rel = r["variance"] / r["closed_form_variance"] - 1
        assert abs(rel) < 0.2, (design, r["variance"],
                                r["closed_form_variance"])
        log(f"[designs] fix_data n=100 B=G/2 M=800 {design}: var "
            f"{r['variance']:.4e} exact {r['closed_form_variance']:.4e} "
            f"({rel:+.3f}; {r['wallclock_s'] * 1e3:.1f} ms)")
    out["fix_data_swor_over_swr"] = var["swor"] / var["swr"]
    assert 0.4 < out["fix_data_swor_over_swr"] < 0.6, var
    base = H.VarianceConfig(kernel="auc", n_pos=10_000, n_neg=10_000,
                            n_workers=8, n_pairs=10_000, n_reps=M,
                            design="swor", seed=SEED)
    curves = {"rounds": H.tradeoff_vs_rounds(base, rounds=(1, 4)),
              "pairs": H.tradeoff_vs_pairs(base, pairs=(1000, 10_000)),
              "workers": H.tradeoff_vs_workers(base, workers=(2, 8, 32))}
    for name, rows in curves.items():
        for r in rows:
            ratio = r["variance"] / r["closed_form_variance"]
            assert CHI2_BAND[0] < ratio < CHI2_BAND[1], (name, ratio)
    out["curves"] = {k: [dict(variance=r["variance"],
                              closed_form_variance=r["closed_form_variance"],
                              ms=r["wallclock_s"] * 1e3) for r in rows]
                     for k, rows in curves.items()}
    log("[designs] trade-off curves (n=1e4, M=64; variance / closed form): "
        + "; ".join(f"{k} " + ", ".join(
            f"{r['variance'] / r['closed_form_variance']:.3f}" for r in rows)
            for k, rows in curves.items()))
    looped = {}
    for scheme in ("complete", "repartitioned"):
        cfg = H.VarianceConfig(kernel="triplet_indicator", scheme=scheme,
                               n_pos=512, n_neg=512, dim=8, n_workers=8,
                               n_rounds=2, n_reps=8, seed=SEED)
        r = H.run_variance_experiment(cfg)
        assert not r["batched"] and math.isfinite(r["mean"]), r
        looped[scheme] = r["mean"]
    assert abs(looped["complete"] - looped["repartitioned"]) < 0.01, looped
    log(f"[designs] looped degree-3 harness n=512 d=8 M=8: {looped}")

    # 5. the budgeted learners
    Xp, Xn, Xp_te, Xn_te = data
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    auc0 = evaluate_auc(scorer, p0, Xp_te, Xn_te)
    out["learner"] = {}
    for design in ("swr", "swor", "bernoulli"):
        cfg = TrainConfig(kernel="hinge", lr=0.3, n_workers=8,
                          repartition_every=10, seed=7, steps=20,
                          pairs_per_worker=4096, pair_design=design)
        train_pairwise(scorer, p0, Xp, Xn, dataclasses.replace(cfg, steps=2))
        ms, (params, hist) = cuda_ms(
            lambda: train_pairwise(scorer, p0, Xp, Xn, cfg))
        auc = evaluate_auc(scorer, params, Xp_te, Xn_te)
        assert np.isfinite(hist["loss"]).all() and auc >= 0.75, (design, auc)
        out["learner"][design] = dict(steps_per_s=20 / ms * 1e3,
                                      auc_test_after=auc)
        log(f"[designs] budgeted hinge N=8 B=4096 {design}: "
            f"{20 / ms * 1e3:.2f} steps/s; test AUC {auc0:.5f} -> {auc:.5f}")
    Xtr, ytr, Xte, yte, meta = load_adult_splits()
    Ap, An = split_by_label(Xtr, ytr)
    Ap_te, An_te = split_by_label(Xte, yte)
    adult = LinearScorer(dim=Xtr.shape[1])
    a0 = adult.init(0)
    before = evaluate_auc(adult, a0, Ap_te, An_te)
    out["adult"] = {"source": meta["source"], "auc_test_before": before}
    for design in ("swor", "bernoulli"):
        cfg = TrainConfig(kernel="hinge", lr=0.1, steps=20, n_workers=1,
                          pairs_per_worker=4096, pair_design=design)
        params, _ = train_pairwise(adult, a0, Ap, An, cfg)
        auc = evaluate_auc(adult, params, Ap_te, An_te)
        assert auc >= 0.75, (design, auc)
        out["adult"][design] = auc
        log(f"[designs] Adult ({meta['source']}) N=1 B=4096 {design}: "
            f"test AUC {before:.5f} -> {auc:.5f} (JAX, CPU: 0.578 -> 0.791)")
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, evaluate_triplet_accuracy, init_embed,
        train_triplet,
    )
    accs, t_train = [], 0.0
    for seed in range(8):
        Xc_tr, Xo_tr, Xc_te, Xo_te = triplet_task("gauss-overlap", seed)
        p0t = init_embed(Xc_tr.shape[1], 2, seed=seed)
        acc0 = evaluate_triplet_accuracy(p0t, Xc_te, Xo_te)
        cfg = TripletTrainConfig(lr=0.1, steps=300, n_workers=8,
                                 repartition_every=1,
                                 triplets_per_worker=4_096, seed=1_000 + seed,
                                 embed_dim=2, triplet_design="swor")
        t0 = time.perf_counter()
        _, hist = train_triplet(p0t, Xc_tr, Xo_tr, cfg, eval_every=30,
                                eval_data=(Xc_te, Xo_te))
        t_train += time.perf_counter() - t0
        assert np.isfinite(hist["loss"]).all()
        assert hist["test_acc"][-1] > acc0, (seed, hist["test_acc"], acc0)
        accs.append(float(hist["test_acc"][-1]))
    out["triplet_learner_swor"] = dict(final_acc_mean=float(np.mean(accs)),
                                       steps_per_s_with_eval=8 * 300 / t_train)
    log(f"[designs] triplet learner gauss-overlap swor N=8 B=4096 300 steps "
        f"S=8: test acc {np.mean(accs):.6f} (swr, JAX row "
        f"{JAX_GAUSS_OVERLAP[0]}); {8 * 300 / t_train:.2f} steps/s with "
        f"10 evaluations")

    # 6. the flagship entry: kernel 1's logistic body against plain
    f, args = entry()
    v = float(f(*args))
    fp, ap = entry(impl="plain")
    vp = float(fp(*ap))
    assert abs(v - vp) <= 1e-5 * abs(vp), (v, vp)
    out["graft_entry"] = dict(value=v, plain=vp)
    log(f"[designs] graft_entry logistic pair mean 2048 x 2048: {v:.9f} "
        f"(plain {vp:.9f})")
    return out


# --------------------------------------------------------------------- #
# slice 13: the multi-worker ring (BASELINE config 5)                    #
# --------------------------------------------------------------------- #

def mesh_rank(rank, world, store, device, n, seed, out_dir):
    """One rank of a distributed mesh (DistComm, one worker a rank):
    brings up the group, computes the complete auc of the seeded data
    and writes it to out_dir/<rank>.json."""
    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.parallel import distributed
    from tuplewise_tpu_torch.parallel.mesh import make_mesh

    import torch.distributed as dist

    assert distributed.initialize(num_processes=world, process_id=rank,
                                  device=device, init_method=store)
    try:
        mesh = make_mesh(distributed=True, device=device)
        s1, s2 = mesh_rank_data(n, seed, mesh.device)
        val = Estimator("auc", backend="mesh", mesh=mesh,
                        device=device).complete(s1, s2)
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump({"rank": rank, "auc": val}, f)
        dist.barrier()      # no rank tears down while a peer still talks
    finally:
        dist.destroy_process_group()


def mesh_rank_data(n, seed, device):
    """Scores of (n + 3, n - 5) rows made on the CPU from ``seed``, so
    every rank and the worker axis hold the same data."""
    g = torch.Generator().manual_seed(seed)
    return ((torch.randn(n + 3, generator=g) + 1.0).to(device),
            torch.randn(n - 5, generator=g).to(device))


def mesh_ranks(world, device, n=10_000, seed=SEED + 25):
    """The complete auc of one rank a worker (``world`` processes, one
    card each on the card) against the worker axis of the same N:
    returns the value, equal on every rank and to the worker axis."""
    import torch.multiprocessing as mp

    from tuplewise_tpu_torch import Estimator

    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        mp.spawn(mesh_rank, args=(world, store, device, n, seed, tmp),
                 nprocs=world, join=True)
        vals = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.json")) as f:
                vals.append(json.load(f)["auc"])
    s1, s2 = mesh_rank_data(n, seed, device)
    want = Estimator("auc", backend="mesh", n_workers=world,
                     device=device).complete(s1, s2)
    assert vals == [want] * world, (vals, want)
    return want


def check_hinge_stop(s1, s2, mesh, label, reference):
    """One stop of the hinge ring at config 5's shape, the blocks the
    ring's first stop gives the kernel: kernel 1 (full) against
    hinge_sum_library, or kernel 2 (ragged) against masked_pair_library,
    each worker's sum within hinge_stop_gap. The launches go through
    `reference` (kept out of the mesh path's count). Returns the largest
    |kernel - yardstick| and its gap, relative to the sums."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops import rank_count
    from tuplewise_tpu_torch.ops.kernels import get_kernel
    from tuplewise_tpu_torch.parallel.device_partition import pack_blocks

    k = get_kernel("hinge")
    pa, ma, _ = pack_blocks(s1, mesh)
    pb, mb, _ = pack_blocks(s2, mesh)
    if label == "full":
        got = reference(lambda: pk.pair_sum(pa, pb, k))
        want = hinge_sum_library(pa, pb)
        tile = rank_count.grad_tile_size(pb.shape[1])
    else:
        got = reference(lambda: pk.masked_pair_sum(pa, pb, ma, mb, k))
        want = masked_pair_library("hinge", pa, pb, ma, mb)
        tile = rank_count.masked_tile_size(pb.shape[1], True)
    gap = hinge_stop_gap(pa, pb, ma, mb, tile)
    err = (got - want).abs()
    assert bool((err <= gap).all()), (label, err.tolist(), gap.tolist())
    rel = float((err / want.abs()).max())
    rel_gap = float((gap / want.abs()).max())
    log(f"[mesh] hinge stop {label} {list(pa.shape)} x {list(pb.shape)} "
        f"({-(-pb.shape[1] // tile)} tiles of {tile}) against the sort + "
        f"cumsum + searchsorted yardstick: largest rel diff {rel:.3g}, "
        f"derived gap {rel_gap:.3g}")
    return dict(rel_diff=rel, rel_gap=rel_gap, tiles=-(-pb.shape[1] // tile))


def phase_mesh():
    """Phase 24: config 5's ring on the card's worker axis (N = 8
    workers, LocalComm) through Estimator(backend="mesh"): complete auc
    and hinge at n = 10^7 a class, full (kernel 1 at every stop) and
    ragged (kernel 2), each complete call 8 launches; the auc equal to
    rank_auc's exact count over 2 n1 n2, the hinge within rel 1e-10 of
    the single-device complete, and one hinge stop at [8, 1.25e6] held
    to its sort + cumsum + searchsorted yardstick (check_hinge_stop);
    the 2-D (2, 4) mesh's ragged auc equal to the 1-D value; logistic at
    2^20 within rel 1e-6 of the single-device complete, and one stop at
    [8, 2^17] against plain; impl="plain" against the kernels at n =
    10^5 on edge values and on ties with infinities; the triplet double
    ring (64 stops) at n = 4096, d = 32;
    local, repartitioned (T = 4) and incomplete (swr, swor, B = 10^4)
    at n = 10^6 within 5 standard errors (8 seeds) of the complete value;
    a one-rank NCCL group (DistComm) equal to the worker axis of N = 1,
    and one rank a card where there are two or more. The launch counts
    are read after these calls, less the references' own launches
    (single-device calls, the stops against their yardsticks, the N = 1
    worker axis); then the timing: the ring's complete ms
    and pairs/s, a stop's kernel and rotation ms (CUDA events, and
    device time by kernel from torch.profiler where it captures any) and
    the single-device complete. Returns (numbers, launches)."""
    import torch.distributed as dist

    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel
    from tuplewise_tpu_torch.ops.rank_auc import rank_auc, rank_auc_counts
    from tuplewise_tpu_torch.parallel import distributed
    from tuplewise_tpu_torch.parallel.device_partition import pack_blocks
    from tuplewise_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    N, n = MESH_WORKERS, MESH_N
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    out = {"workers": N, "n": n}

    def launched(fn):
        before = dict(pk.LAUNCHES)
        val = fn()
        return val, {k: v - before.get(k, 0) for k, v in pk.LAUNCHES.items()
                     if v - before.get(k, 0)}

    # the references' own launches (single-device calls, the stops held
    # against their yardsticks, the N = 1 worker axis), kept out of the
    # mesh path's count
    refs = {}

    def reference(fn):
        val, delta = launched(fn)
        for k, v in delta.items():
            refs[k] = refs.get(k, 0) + v
        return val

    def scores(n1, n2):
        return (torch.randn(n1, generator=g, device="cuda") + 1.0,
                torch.randn(n2, generator=g, device="cuda"))

    # 1. complete auc and hinge at config 5's size, full and ragged
    mesh = make_mesh(N)
    data = {"full": scores(n, n), "ragged": scores(*MESH_RAGGED)}
    for label, (s1, s2) in data.items():
        wrapper = "pair_sum" if label == "full" else "masked_pair_sum"
        for name in ("auc", "hinge"):
            est = Estimator(name, backend="mesh", n_workers=N)
            val, delta = launched(lambda: est.complete(s1, s2))
            assert delta == {f"{wrapper}[{name}]": N}, (name, label, delta)
            if name == "auc":
                # rank_auc's exact count, correctly rounded (its own
                # division on the card multiplies by a reciprocal)
                twice = int(reference(lambda: rank_auc_counts(s1, s2)))
                want = twice / (2 * s1.numel() * s2.numel())
                ulps = abs(float(reference(lambda: rank_auc(s1, s2)))
                           - want) / math.ulp(want)
                assert val == want and ulps <= 1, (label, val, want, ulps)
            else:
                want = reference(lambda: Estimator(name).complete(s1, s2))
                assert abs(val - want) <= 1e-10 * abs(want), (label, val,
                                                              want)
                out[f"hinge_{label}_stop"] = check_hinge_stop(
                    s1, s2, mesh, label, reference)
            out[f"{name}_{label}"] = dict(value=val, single=want,
                                          rel_gap=abs(val - want) / abs(want))
            log(f"[mesh] complete {name} {label} {s1.numel()} x "
                f"{s2.numel()} on {N} workers: {val!r} (single device "
                f"{want!r}, rel gap {abs(val - want) / abs(want):.3g}); "
                f"{json.dumps(delta)}")
    s1, s2 = data["ragged"]
    val, delta = launched(lambda: Estimator(
        "auc", backend="mesh", mesh=make_mesh_2d(2, 4)).complete(s1, s2))
    assert delta == {"masked_pair_sum[auc]": N}, delta
    assert val == out["auc_ragged"]["value"], val
    log(f"[mesh] 2-D (2, 4) ragged auc {val!r} equal to the 1-D ring")

    # 2. logistic at 2^20 a class; one stop [8, 2^17] against plain
    a, b = scores(1 << 20, 1 << 20)
    val, delta = launched(lambda: Estimator(
        "logistic", backend="mesh", n_workers=N).complete(a, b))
    assert delta == {"pair_sum[logistic]": N}, delta
    want = reference(lambda: Estimator("logistic").complete(a, b))
    assert abs(val - want) <= 1e-6 * abs(want), (val, want)
    logistic = get_kernel("logistic")
    pa, _, _ = pack_blocks(a, mesh)
    pb, _, _ = pack_blocks(b, mesh)
    got = reference(lambda: pk.pair_sum(pa, pb, logistic))
    plain = pk.pair_sum(pa, pb, logistic, impl="plain")
    stop_rel = float(((got - plain).abs() / plain).max())
    # the derived worst case, and the rel 1e-5 phases 2 and 5 hold this
    # kernel to
    assert stop_rel <= logistic_stop_rel(), stop_rel
    check_against_plain("logistic", got, plain, 1.0,
                        ("mesh stop", *pa.shape, pb.shape[1]))
    del pa, pb
    out["logistic_full"] = dict(value=val, single=want,
                                rel_gap=abs(val - want) / abs(want),
                                stop_rel_diff_plain=stop_rel)
    log(f"[mesh] complete logistic 2^20 x 2^20: {val!r} (single device "
        f"{want!r}, rel gap {abs(val - want) / abs(want):.3g}); a stop "
        f"[8, 2^17] against plain: largest rel diff {stop_rel:.3g} (derived "
        f"worst case {logistic_stop_rel():.3g})")

    # 3. impl="plain" against the kernels at n = 10^5: edge values, and
    # lattice ties with +inf in a and -inf in b (finite hinge and
    # logistic sums)
    m = 10 ** 5

    def lattice(k, sign):
        x = (torch.randn(k, generator=g, device="cuda") * 4).round() / 4
        inf = torch.rand(k, generator=g, device="cuda") < 0.01
        return torch.where(inf, sign * math.inf, x)

    for label, (n1, n2) in (("full", (m, m)), ("ragged", (m + 3, m - 5))):
        cases = {"edge": (edge_values(g, n1), edge_values(g, n2)),
                 "ties": (lattice(n1, 1.0), lattice(n2, -1.0))}
        for case, (a, b) in cases.items():
            for name in NAMES:
                got = Estimator(name, backend="mesh",
                                n_workers=N).complete(a, b)
                want = Estimator(name, backend="mesh", n_workers=N,
                                 impl="plain").complete(a, b)
                if name == "auc" or not math.isfinite(want):
                    assert got == want or (math.isnan(got)
                                           and math.isnan(want)), (
                        name, label, case, got, want)
                else:
                    assert abs(got - want) <= 1e-5 * abs(want), (
                        name, label, case, got, want)
                log(f"[mesh] plain vs kernels {name} {label} {case}: "
                    f"{got!r} / {want!r}")

    # 4. the triplet double ring at n = 4096, d = 32
    X, Y = gaussian_clouds(g, 4096, TRIPLET_D)
    for name in TRIPLET_NAMES:
        val, delta = launched(lambda: Estimator(
            name, backend="mesh", n_workers=N).complete(X, Y))
        assert delta == {f"batched_masked_pair_sum[{name}]": N * N}, delta
        want = reference(lambda: Estimator(name).complete(X, Y))
        if name == "triplet_indicator":
            assert val == want, (val, want)
        else:
            assert abs(val - want) <= 1e-6 * abs(want), (val, want)
        out[name] = dict(value=val, single=want)
        log(f"[mesh] {name} n=4096 d={TRIPLET_D} double ring ({N * N} "
            f"stops): {val!r} (single device {want!r})")

    # 5. the schemes that draw, at n = 10^6: 8 seeds give the standard
    # error of one estimate
    a, b = scores(10 ** 6, 10 ** 6)
    est = Estimator("auc", backend="mesh", n_workers=N)
    full = est.complete(a, b)
    calls = {
        "local": lambda s: est.local_average(a, b, seed=s),
        "repartitioned": lambda s: est.repartitioned(a, b, n_rounds=4,
                                                     seed=s),
        "incomplete_swr": lambda s: est.incomplete(a, b, n_pairs=10_000,
                                                   seed=s),
        "incomplete_swor": lambda s: est.incomplete(
            a, b, n_pairs=10_000, seed=s, design="swor"),
    }
    for label, fn in calls.items():
        vals, delta = launched(lambda: [fn(s) for s in range(8)])
        if not label.startswith("incomplete"):
            assert delta.get("pair_sum[auc]", 0) == 8 * (
                4 if label == "repartitioned" else 1), (label, delta)
        se = float(np.std(vals, ddof=1))
        assert abs(vals[0] - full) < 5 * se, (label, vals, full, se)
        out[label] = dict(value=vals[0], se=se, complete=full)
        log(f"[mesh] {label} n=10^6: {vals[0]!r} (complete {full!r}, se "
            f"{se:.3g} over 8 seeds); {json.dumps(delta)}")

    # 6. a one-rank NCCL group: DistComm against the worker axis of N = 1
    with tempfile.TemporaryDirectory() as tmp:
        assert distributed.initialize(num_processes=1, process_id=0,
                                      init_method=f"file://{tmp}/store")
        try:
            dmesh = make_mesh(distributed=True)
            assert dmesh.distributed and dist.get_backend() == "nccl"
            val = Estimator("auc", backend="mesh", mesh=dmesh).complete(a, b)
        finally:
            dist.destroy_process_group()
    want = reference(lambda: Estimator("auc", backend="mesh",
                                       n_workers=1).complete(a, b))
    assert val == want, (val, want)
    world = 1
    if torch.cuda.device_count() >= 2:
        world = torch.cuda.device_count()
        reference(lambda: mesh_ranks(world, "cuda"))
    out["dist_world"] = world
    log(f"[mesh] DistComm (NCCL) world size {world}: complete auc {val!r} "
        f"equal to the worker axis")
    # the mesh path's own launches: the counts less the references'
    launches = {k: v - refs.get(k, 0) for k, v in pk.LAUNCHES.items()
                if v - refs.get(k, 0)}
    log(f"[launches] mesh references (not counted) {json.dumps(refs)}")

    # 7. timing: the ring against the single device, a stop's kernel
    # against its rotation
    for label, (s1, s2) in data.items():
        for name in ("auc", "hinge"):
            est = Estimator(name, backend="mesh", n_workers=N)
            ms, _ = cuda_ms(lambda: est.complete(s1, s2), reps=3)
            single = Estimator(name, auc_fast=False)
            single_ms, _ = cuda_ms(lambda: single.complete(s1, s2), reps=3)
            k = get_kernel(name)
            pa, ma, _ = pack_blocks(s1, mesh)
            pb, mb, _ = pack_blocks(s2, mesh)
            visiting = [pb] if label == "full" else [pb, mb]

            def stop_fn():
                if label == "full":
                    return pk.pair_sum(pa, pb, k)
                return pk.masked_pair_sum(pa, pb, ma, mb, k)

            def rot_fn():
                return mesh.comm.start_rotate(visiting, 0).wait()

            stop_ms, _ = cuda_ms(stop_fn, reps=5)
            rot_ms, _ = cuda_ms(rot_fn, reps=5)
            # device time by kernel (torch.profiler); a profile that saw
            # no device time is reported as not captured
            stop = device_ms_by_kernel(stop_fn, 5)
            rot = device_ms_by_kernel(rot_fn, 5)
            pairs = float(s1.numel()) * s2.numel()
            out[f"{name}_{label}"].update(
                ms=ms, pairs_per_s=pairs / ms * 1e3, single_ms=single_ms,
                stop_kernel_ms=stop_ms, stop_rotation_ms=rot_ms,
                stop_kernel_device_ms=sum(stop.values()) or None,
                stop_rotation_device_ms=sum(rot.values()) or None)
            log(f"[mesh] {name} {label} ring complete {ms:.3f} ms "
                f"({pairs / ms * 1e3:.4g} pairs/s), single device "
                f"{single_ms:.3f} ms; a stop (CUDA events): kernel "
                f"{stop_ms:.4f} ms, rotation {rot_ms:.4f} ms; device time "
                f"(torch.profiler): kernel {stop or 'not captured'}, "
                f"rotation {rot or 'not captured'}")
    a, b = scores(1 << 20, 1 << 20)
    est = Estimator("logistic", backend="mesh", n_workers=N)
    ms, _ = cuda_ms(lambda: est.complete(a, b))
    single_ms, _ = cuda_ms(lambda: Estimator("logistic").complete(a, b))
    out["logistic_full"].update(ms=ms, single_ms=single_ms)
    log(f"[mesh] logistic 2^20 ring complete {ms:.3f} ms, single device "
        f"{single_ms:.3f} ms")
    return out, launches


# --------------------------------------------------------------------- #
# slice 14: the elastic batch path on the mesh                          #
# --------------------------------------------------------------------- #

def meshless_run(scorer, cfg, p0, Xp, Xn):
    """The trainer's mesh-less engine (the step engine on the full arrays,
    the blocks indexed from them): what train_pairwise ran before the
    mesh. Returns (params, losses) as numpy."""
    from tuplewise_tpu_torch.models import pairwise_sgd as T

    kernel = T.check_config(cfg)
    p, losses = T.run_chunk(scorer, kernel, cfg, T.replicate(p0, 1, "cuda"),
                            T.to_device_rows(Xp, "cuda"),
                            T.to_device_rows(Xn, "cuda"), [cfg.seed], 0,
                            cfg.steps)
    return ({k: v[0].cpu().numpy() for k, v in p.items()},
            losses[0].cpu().numpy())


def phase_elastic(data):
    """Phase 25: the elastic batch path on the card's worker axis (N = 8,
    LocalComm). (a) train_pairwise(mesh=make_mesh(8)) at phase 7's data,
    20 steps, hinge and logistic with loss_every=2, equal bit for bit to
    the mesh-less engine, steps/s and launches of kernels 3 and 4, and one
    full-shape step ([8, 62500] x [8, 62500]) of both kernels against
    plain (check_grad_case: hinge equal, logistic as phase 6); (b) a
    chaos train_step fault dropping worker 3 on make_mesh(8, pool=12)
    with checkpoint_every=5, equal bit for bit to the fault-free run; (c)
    the mesh triplet trainer at phase 14's gauss-overlap cell (seed 0,
    300 steps, evaluations through kernel 5); (d) the harness on
    backend="mesh": config 1's four schemes in CHI2_BAND, config 5's
    complete auc at n = 10^7, full and ragged, 4 reps (a rep's value
    equal to the mesh Estimator's on its rows); (e) config 5 through
    Estimator(heal_retries=2, chaos=...) on make_mesh(8, pool=12): a
    fault dropping worker 3 and one dropping nobody, each equal to the
    fault-free value, then HealExhaustedError on make_mesh(8); (f) a
    one-rank NCCL group's mesh trainer equal to the worker axis of N =
    1; (g) graft_entry.dryrun_multichip(8). Runs without a fault show
    retries_total 0, runs with faults as many retries as faults. Returns
    (numbers, launches less the references' own)."""
    import torch.distributed as dist

    from tuplewise_tpu_torch import Estimator
    from tuplewise_tpu_torch.graft_entry import dryrun_multichip
    from tuplewise_tpu_torch.harness import mesh_mc
    from tuplewise_tpu_torch.harness.variance import (
        VarianceConfig, run_variance_experiment,
    )
    from tuplewise_tpu_torch.models import pairwise_sgd as T
    from tuplewise_tpu_torch.models.scorers import LinearScorer
    from tuplewise_tpu_torch.models.triplet_sgd import (
        TripletTrainConfig, evaluate_triplet_accuracy, init_embed,
        train_triplet,
    )
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.parallel import distributed
    from tuplewise_tpu_torch.parallel.device_partition import ShardedRows
    from tuplewise_tpu_torch.parallel.mesh import make_mesh
    from tuplewise_tpu_torch.parallel.self_heal import HealExhaustedError
    from tuplewise_tpu_torch.testing import FaultInjector
    from tuplewise_tpu_torch.utils.profiling import MetricsRegistry

    N = MESH_WORKERS
    out = {}
    refs = {}

    def reference(fn):
        """fn's launches are the references', kept out of the path's."""
        before = dict(pk.LAUNCHES)
        val = fn()
        for k, v in pk.LAUNCHES.items():
            if v - before.get(k, 0):
                refs[k] = refs.get(k, 0) + v - before.get(k, 0)
        return val

    def drop(point, workers, on_call=1):
        return FaultInjector.from_spec({"faults": [
            {"point": point, "on_call": on_call, "action": "error",
             "dropped": list(workers)}]})

    # (a) the mesh trainer at phase 7's data
    Xp, Xn, Xp_te, Xn_te = data
    scorer = LinearScorer(dim=5)
    p0 = scorer.init(0)
    auc0 = reference(lambda: T.evaluate_auc(scorer, p0, Xp_te, Xn_te))
    runs = {}
    for name in GRAD_NAMES:
        cfg = T.TrainConfig(kernel=name, lr=0.3, n_workers=N,
                            repartition_every=10, seed=7, tile=2048,
                            loss_every=2, steps=20)
        mesh = make_mesh(N)
        _, warm = T.train_pairwise(scorer, p0, Xp, Xn,
                                   dataclasses.replace(cfg, steps=2),
                                   mesh=mesh)                  # warm-up
        assert warm["recovery"]["retries_total"] == 0, warm["recovery"]
        before = dict(pk.LAUNCHES)
        ms, (params, hist) = cuda_ms(lambda: T.train_pairwise(
            scorer, p0, Xp, Xn, cfg, mesh=mesh))
        delta = {k: v - before.get(k, 0) for k, v in pk.LAUNCHES.items()
                 if v - before.get(k, 0)}
        assert hist["recovery"]["retries_total"] == 0, hist["recovery"]
        want_p, want_loss = reference(
            lambda: meshless_run(scorer, cfg, p0, Xp, Xn))
        for k in want_p:
            assert params[k].tobytes() == want_p[k].tobytes(), (name, k)
        assert hist["loss"].tobytes() == want_loss.tobytes(), name
        loss = hist["loss"]
        assert np.isfinite(loss[::2]).all() and np.isnan(loss[1::2]).all()
        assert loss[-2] < loss[0], loss
        auc = reference(lambda: T.evaluate_auc(scorer, params, Xp_te,
                                               Xn_te))
        assert auc > auc0, (name, auc, auc0)
        runs[name] = (cfg, params, hist)
        out[f"train_{name}"] = dict(
            ms=ms, steps_per_s=20 / ms * 1e3, launches=delta,
            auc_test_before=auc0, auc_test_after=auc,
            loss_first=float(loss[0]), loss_last=float(loss[-2]))
        log(f"[elastic] mesh trainer {name} N={N} n=5e5/class loss_every=2: "
            f"{20 / ms * 1e3:.3f} steps/s ({ms:.1f} ms for 20 steps); equal "
            f"bit for bit to the mesh-less run; test AUC {auc0:.5f} -> "
            f"{auc:.5f}; launches {json.dumps(delta)}")
    # one full-shape step of kernels 3 and 4: the blocks of step 0
    cfg = runs["hinge"][0]
    mesh = make_mesh(N)
    Ab, Bb = T._blocks(cfg, [cfg.seed], ShardedRows(
        T.to_device_rows(Xp, "cuda"), mesh), ShardedRows(
        T.to_device_rows(Xn, "cuda"), mesh), 0)
    ps = T.replicate(p0, 1, "cuda")
    with torch.no_grad():
        a = scorer.score(ps, Ab.reshape(1, -1, 5)).reshape(N, -1)
        b = scorer.score(ps, Bb.reshape(1, -1, 5)).reshape(N, -1)
    del Ab, Bb
    for name in GRAD_NAMES:
        err, _ = reference(lambda: check_grad_case(
            name, a, b, ("elastic step", name, *a.shape)))
        out[f"step_{name}"] = dict(shape=[list(a.shape), list(b.shape)],
                                   max_abs_err=err)
        log(f"[elastic] one step {list(a.shape)} x {list(b.shape)} {name}: "
            f"kernels 3 and 4 against plain, row/col "
            f"{'equal' if name == 'hinge' else 'within rel 1e-4'} (max abs "
            f"err {err:.3g}), loss within rel 1e-5")
    del a, b

    # (b) a chaos train_step fault dropping worker 3, spares available
    cfg, ref_params, ref_hist = runs["hinge"]
    metrics = MetricsRegistry()
    with tempfile.TemporaryDirectory() as tmp:
        params, hist = T.train_pairwise(
            scorer, p0, Xp, Xn, cfg, mesh=make_mesh(N, pool=12),
            checkpoint_path=os.path.join(tmp, "t.npz"), checkpoint_every=5,
            chaos=drop("train_step", [3], on_call=2), metrics=metrics)
    rec = hist["recovery"]
    for k in ref_params:
        assert params[k].tobytes() == ref_params[k].tobytes(), k
    assert hist["loss"].tobytes() == ref_hist["loss"].tobytes()
    assert rec["reshard_events"] >= 1 and rec["mesh_workers"] == N, rec
    assert rec["retries_total"] == 1, rec
    heal_s = metrics.snapshot()["recovery_time_s"]
    out["train_heal"] = dict(recovery=rec, recovery_time_s=heal_s["sum"])
    log(f"[elastic] train_step fault dropping worker 3 on make_mesh(8, "
        f"pool=12), checkpoint_every=5: params and loss equal bit for bit; "
        f"{json.dumps(rec)}; recovery_time_s {heal_s['sum']:.6f}")

    # (c) the mesh triplet trainer at phase 14's cell
    Xc_tr, Xo_tr, Xc_te, Xo_te = triplet_task("gauss-overlap", 0)
    tp0 = init_embed(16, 2, seed=0)
    acc0 = reference(lambda: evaluate_triplet_accuracy(tp0, Xc_te, Xo_te))
    tcfg = TripletTrainConfig(lr=0.1, steps=300, n_workers=N,
                              repartition_every=1, triplets_per_worker=4_096,
                              seed=1_000, embed_dim=2)
    t0 = time.perf_counter()
    _, th = train_triplet(tp0, Xc_tr, Xo_tr, tcfg, eval_every=30,
                          eval_data=(Xc_te, Xo_te), mesh=make_mesh(N))
    wall = time.perf_counter() - t0
    assert np.isfinite(th["loss"]).all() and len(th["test_acc"]) == 10
    assert th["test_acc"][-1] > acc0, (th["test_acc"], acc0)
    assert th["recovery"]["retries_total"] == 0
    out["triplet"] = dict(acc_init=acc0, acc_final=float(th["test_acc"][-1]),
                          steps_per_s_with_eval=300 / wall)
    log(f"[elastic] mesh triplet trainer gauss-overlap N={N} B=4096 300 "
        f"steps: test acc {acc0:.6f} -> {th['test_acc'][-1]:.6f}; "
        f"{300 / wall:.2f} steps/s with 10 evaluations")

    # (d) the harness on backend="mesh"
    for scheme in ("complete", "local", "repartitioned", "incomplete"):
        vcfg = VarianceConfig(kernel="auc", scheme=scheme, backend="mesh",
                              n_pos=10_000, n_neg=10_000, n_workers=N,
                              n_rounds=4, n_pairs=10_000, n_reps=64,
                              seed=SEED)
        r = run_variance_experiment(vcfg)
        ratio = r["variance"] / r["closed_form_variance"]
        assert CHI2_BAND[0] < ratio < CHI2_BAND[1], (scheme, ratio)
        assert abs(r["mean"] - r["population_value"]) < 5 * r["std_error"]
        assert r["recovery"]["retries_total"] == 0
        out[f"harness_{scheme}"] = dict(mean=r["mean"], ratio=ratio,
                                        ms=r["wallclock_s"] * 1e3)
        log(f"[elastic] harness mesh {scheme:13s} M=64 n=10^4 N={N}: mean "
            f"{r['mean']:.6f} var/closed form {ratio:.3f} "
            f"({r['wallclock_s'] * 1e3:.1f} ms)")
    for label, (n1, n2) in (("full", (MESH_N, MESH_N)),
                            ("ragged", MESH_RAGGED)):
        vcfg = VarianceConfig(kernel="auc", scheme="complete", backend="mesh",
                              n_pos=n1, n_neg=n2, n_workers=N, n_reps=4,
                              seed=SEED)
        r = run_variance_experiment(vcfg)
        assert r["recovery"]["retries_total"] == 0
        draw_ms, rows = cuda_ms(lambda: mesh_mc.worker_draws(
            vcfg, make_mesh(N), ("mc_rep", 0), mesh_mc.REP_BLOCK))
        # rep 0's value: the mesh Estimator on the same rows
        A, B = (x[0].reshape(-1)[:n] for x, n in zip(rows, (n1, n2)))
        del rows
        want = reference(lambda: Estimator(
            "auc", backend="mesh", n_workers=N).complete(A, B))
        got = mesh_mc.make_mesh_mc_runner(vcfg)(range(1))
        assert got[0] == want, (label, got, want)
        del A, B
        torch.cuda.empty_cache()
        out[f"config5_{label}"] = dict(
            ms_per_rep=r["wallclock_s"] * 1e3 / 4, block_draw_ms=draw_ms,
            mean=r["mean"], rep0=want)
        log(f"[elastic] harness mesh config 5 complete auc {label} {n1} x "
            f"{n2}, 4 reps: {r['wallclock_s'] * 1e3 / 4:.2f} ms a rep (the "
            f"64-rep block's draw, {draw_ms:.2f} ms, included once); rep 0 "
            f"equal to the mesh Estimator on its rows ({want!r})")

    # (e) config 5 through the healed Estimator
    g = torch.Generator(device="cuda").manual_seed(SEED + 25)
    s1 = torch.randn(MESH_N, generator=g, device="cuda") + 1.0
    s2 = torch.randn(MESH_N, generator=g, device="cuda")
    free = Estimator("auc", backend="mesh", mesh=make_mesh(N, pool=12),
                     heal_retries=2)
    want = free.complete(s1, s2)
    assert free._healer.retries_total == 0
    heals = {}
    for label, workers in (("drop 3", [3]), ("no drop", [])):
        est = Estimator("auc", backend="mesh", mesh=make_mesh(N, pool=12),
                        heal_retries=2, chaos=drop("estimator", workers))
        val = est.complete(s1, s2)
        h = est._healer
        assert val == want, (label, val, want)
        assert h.retries_total == 1 and h.n_workers == N, label
        heals[label] = dict(slots=list(h.mesh.slots),
                            recovery_time_s=h.metrics.snapshot()[
                                "recovery_time_s"]["sum"])
    try:
        Estimator("auc", backend="mesh", mesh=make_mesh(N), heal_retries=2,
                  chaos=drop("estimator", [3])).complete(s1, s2)
        raise AssertionError("a drop without spare slots did not raise")
    except HealExhaustedError as e:
        exhausted = str(e)
    out["estimator_heal"] = dict(value=want, heals=heals,
                                 exhausted=exhausted)
    log(f"[elastic] config 5 Estimator(heal_retries=2): drop of worker 3 "
        f"and a fault without a drop each equal the fault-free {want!r}; "
        f"{json.dumps(heals)}; no spares: HealExhaustedError ({exhausted})")
    del s1, s2

    # (f) a one-rank NCCL group runs the mesh trainer
    cfg = dataclasses.replace(runs["hinge"][0], n_workers=1)
    with tempfile.TemporaryDirectory() as tmp:
        assert distributed.initialize(num_processes=1, process_id=0,
                                      init_method=f"file://{tmp}/store")
        try:
            dmesh = make_mesh(distributed=True)
            assert dmesh.distributed and dist.get_backend() == "nccl"
            dp, dh = T.train_pairwise(scorer, p0, Xp, Xn, cfg, mesh=dmesh)
        finally:
            dist.destroy_process_group()
    assert dh["recovery"]["retries_total"] == 0, dh["recovery"]
    lp, lh = reference(lambda: T.train_pairwise(scorer, p0, Xp, Xn, cfg,
                                                mesh=make_mesh(1)))
    for k in lp:
        assert dp[k].tobytes() == lp[k].tobytes(), k
    assert dh["loss"].tobytes() == lh["loss"].tobytes()
    log("[elastic] one-rank NCCL group: the mesh trainer (hinge, 20 steps) "
        "equal bit for bit to the worker axis of N = 1")

    # (g) the multi-worker dry run
    out["dryrun"] = dryrun_multichip(N)
    log(f"[elastic] dryrun_multichip({N}): {json.dumps(out['dryrun'])}")
    launches = {k: v - refs.get(k, 0) for k, v in pk.LAUNCHES.items()
                if v - refs.get(k, 0)}
    log(f"[launches] elastic references (not counted) {json.dumps(refs)}")
    return out, launches


# --------------------------------------------------------------------- #
# slice 15: the mesh form of serving                                     #
# --------------------------------------------------------------------- #

def mesh_count_bound_ms(runs, sets, qa, qb):
    """Bound of a worker-axis signed count from what these inputs need:
    count_bound_ms over every worker's rows (the run sectors the binary
    searches read, the queries read once) and the [S, 4, q] int32 blocks
    written once; or one comparison a load at the FP32 peak."""
    S = runs[0].shape[0]
    sectors = loads = 0
    qs = (qa, qb)
    for r, a in zip(runs, sets):
        for w in range(S):
            sec, ld, _ = searched(r[w], qs[a])
            sectors, loads = sectors + sec, loads + ld
    byts = 32.0 * sectors + 4.0 * (len(qa) + len(qb)) + 16.0 * S * max(
        len(qa), len(qb))
    by = ("operations" if loads / PEAK_FP32_OPS >= byts / PEAK_BYTES
          else "bytes")
    return max(loads / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by, byts


def mesh_tenant_bound_ms(pos, neg, qn, qp):
    """Bound of a worker-axis tenant count: tenant_bound_ms over every
    worker's [T, cap] slices of both packs against the shared queries,
    and the [S, 4, T, q] int32 blocks written once."""
    S, T = pos.shape[0], qn.shape[0]
    sn, ln, _ = tenant_searched(neg.reshape(S * T, -1), qn.repeat(S, 1))
    sp, lp, _ = tenant_searched(pos.reshape(S * T, -1), qp.repeat(S, 1))
    byts = (32.0 * (sn + sp) + 4.0 * (qn.numel() + qp.numel())
            + 16.0 * S * qn.numel())
    loads = ln + lp
    by = ("operations" if loads / PEAK_FP32_OPS >= byts / PEAK_BYTES
          else "bytes")
    return max(loads / PEAK_FP32_OPS, byts / PEAK_BYTES) * 1e3, by, byts


def on_mesh_merges():
    """Counts the major merges that run on the mesh (the index's host
    path does not call sharded_major_merge): returns (counter, restore)."""
    from tuplewise_tpu_torch.serving import index as index_mod

    done = [0]
    real = index_mod.sharded_major_merge

    def counted(*a, **k):
        out = real(*a, **k)
        done[0] += 1
        return out

    index_mod.sharded_major_merge = counted

    def restore():
        index_mod.sharded_major_merge = real

    return done, restore


def drive_index_lockstep(scores, labels, n, indexes):
    """The first chunk seeded and compacted, then chunks of INDEX_CHUNK
    through every index in turn; wins2 equal across them after every
    batch. Returns each index's insert latencies (s)."""
    c = INDEX_CHUNK
    for idx in indexes:
        idx.insert_batch(scores[:c], labels[:c])
        idx.compact()
    lats = [[] for _ in indexes]
    for i in range(c, n, c):
        for lat, idx in zip(lats, indexes):
            t0 = time.perf_counter()
            idx.insert_batch(scores[i:i + c], labels[i:i + c])
            lat.append(time.perf_counter() - t0)
        w = {idx._wins2 for idx in indexes}
        assert len(w) == 1, (i, w)
    return lats


def mesh_index_record(idx, lat, n, launches):
    snap = idx.metrics.snapshot()
    lat = np.asarray(lat) * 1e3
    v = {k: snap[k]["value"] for k in (
        "count_kernel_calls_total", "count_kernel_fallbacks_total",
        "compactions_total", "major_merges_total", "major_merge_fallbacks",
        "bytes_h2d", "bytes_h2d_saved", "reshard_events", "mesh_width")}
    return dict(
        events_per_s=(n - INDEX_CHUNK) / (lat.sum() / 1e3),
        insert_latency_p50_ms=float(np.percentile(lat, 50)),
        insert_latency_p99_ms=float(np.percentile(lat, 99)),
        batches=len(lat), kernel_launches=launches,
        kernel_calls=v["count_kernel_calls_total"],
        kernel_fallbacks=v["count_kernel_fallbacks_total"],
        compactions=v["compactions_total"],
        minors=snap["compaction_bytes"]["count"],
        major_merges=v["major_merges_total"],
        major_merge_fallbacks=v["major_merge_fallbacks"],
        bytes_h2d=v["bytes_h2d"], bytes_h2d_saved=v["bytes_h2d_saved"],
        reshard_events=v["reshard_events"], mesh_width=v["mesh_width"],
        shard_occupancy=idx.shard_occupancy(), auc=idx.auc())


def phase_mesh_serving():
    """Phase 26: the mesh form of serving at S = MESH_SERVE_WORKERS on the
    card's worker axis. Returns (record, the path's launches, the two
    worker-axis timing rows)."""
    from tuplewise_tpu_torch import ExactAucIndex, TenantFleetIndex
    from tuplewise_tpu_torch.models.metrics import auc_score
    from tuplewise_tpu_torch.ops import count_kernels as ck
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.parallel import sharded_counts as sc
    from tuplewise_tpu_torch.parallel.mesh import make_mesh
    from tuplewise_tpu_torch.parallel.self_heal import (
        HealExhaustedError, MeshHealer,
    )
    from tuplewise_tpu_torch.serving import (
        ServingConfig, make_stream, replay, replay_fleet,
    )
    from tuplewise_tpu_torch.testing import FaultInjector

    S, c = MESH_SERVE_WORKERS, INDEX_CHUNK
    out = {"part_s": {}}
    merges, restore = on_mesh_merges()
    clock = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        out["part_s"][part] = now - clock[0]
        clock[0] = now

    # (a) the index: phase 17's stream on a mesh of S, the kernel and the
    # searchsorted route in lockstep with the single-device index
    n = INDEX_EVENTS
    scores, labels = make_stream(n, pos_frac=0.5, separation=1.0, seed=0)
    scores = scores.astype(np.float32)

    def index(shards, ck_on, **kw):
        return ExactAucIndex(window=n // 2, compact_every=INDEX_COMPACT,
                             count_kernel=ck_on, shards=shards, **kw)

    warm = [index(S, True), index(S, False), index(None, True)]
    drive_index_lockstep(scores, labels, INDEX_WARM_EVENTS // 4, warm)
    del warm
    trio = [index(S, True), index(S, False), index(None, True)]
    before = dict(pk.LAUNCHES)
    merges[0] = 0
    lats = drive_index_lockstep(scores, labels, n, trio)
    mesh_launched = pk.LAUNCHES["signed_count[mesh]"] - before.get(
        "signed_count[mesh]", 0)
    recs = {}
    for mode, idx, lat in zip(("mesh kernel", "mesh searchsorted",
                               "single device"), trio, lats):
        recs[mode] = mesh_index_record(
            idx, lat, n, mesh_launched if mode == "mesh kernel" else 0)
    tail_s, tail_l = scores[n - n // 2:], labels[n - n // 2:]
    oracle = auc_score(tail_s[tail_l], tail_s[~tail_l])
    k = recs["mesh kernel"]
    assert all(r["auc"] == oracle for r in recs.values()), (oracle, recs)
    assert mesh_launched == k["batches"] == k["kernel_calls"], k
    assert k["kernel_fallbacks"] == 0 and k["major_merge_fallbacks"] == 0, k
    assert recs["mesh searchsorted"]["kernel_calls"] == 0
    assert k["minors"] > 0 and merges[0] > 0 and k["bytes_h2d_saved"] > 0, k
    k["on_mesh_merges"] = merges[0]
    for mode, r in recs.items():
        log(f"[mesh serving] index {mode:17s} S={S if 'mesh' in mode else 1}"
            f" n={n} window={n // 2} chunk={c}: {r['events_per_s']:.0f} "
            f"events/s, insert p50 {r['insert_latency_p50_ms']:.3f} ms p99 "
            f"{r['insert_latency_p99_ms']:.3f} ms, {r['batches']} batches, "
            f"{r['kernel_launches']} worker-axis launches, {r['minors']} "
            f"minors, {r['major_merges']} majors "
            f"({r['major_merge_fallbacks']} on the host after a fault), "
            f"{r['bytes_h2d']} bytes placed "
            f"({r['bytes_h2d_saved']} saved), occupancy "
            f"{r['shard_occupancy']}")
    log(f"[mesh serving] index: wins2 equal after each of {k['batches']} "
        f"batches; {merges[0]} majors merged on the mesh; auc "
        f"{k['auc']!r} = the float32 rank-AUC oracle")
    out["index"] = recs
    probe_idx = trio[0]
    q_s, q_l = scores[n - 2 * c:], labels[n - 2 * c:]
    probe_runs = (probe_idx._runs(probe_idx._neg),
                  probe_idx._runs(probe_idx._pos))
    probe_q = (torch.from_numpy(q_s[q_l]).cuda(),
               torch.from_numpy(q_s[~q_l]).cuda())
    for idx in trio:
        idx.close()
    del trio
    lap("a index")

    # (b) heals on the index: a lost worker (8 -> 7), a placement fault,
    # a major-merge fault taking the counted host path
    nh = MESH_HEAL_EVENTS
    spec = {"faults": [
        {"point": "sharded_count", "on_call": 200, "action": "error",
         "dropped": [3]},
        {"point": "place_base", "on_call": 10, "action": "error"},
        {"point": "major_merge", "on_call": 1, "action": "error"}]}
    inj = FaultInjector.from_spec(spec)
    hurt = ExactAucIndex(window=nh // 2, compact_every=INDEX_COMPACT,
                         count_kernel=True, shards=S, chaos=inj,
                         retry_backoff_s=0.0)
    plain = ExactAucIndex(window=nh // 2, compact_every=INDEX_COMPACT,
                          count_kernel=True)
    drive_index_lockstep(scores, labels, nh, [hurt, plain])
    m = hurt.metrics.snapshot()
    fired = inj.snapshot()["fired"]
    assert fired == {"sharded_count": 1, "place_base": 1,
                     "major_merge": 1}, fired
    assert hurt.shards == S - 1 and m["mesh_width"]["value"] == S - 1
    assert m["major_merge_fallbacks"]["value"] == 1
    assert m["count_kernel_fallbacks_total"]["value"] == 0
    assert hurt.auc() == plain.auc()
    rec = m["recovery_time_s"]
    heals = dict(reshard_events=m["reshard_events"]["value"],
                 shard_retries=m["shard_retries_total"]["value"],
                 recovery_time_s_max=rec["max"],
                 recovery_time_s_mean=rec["mean"],
                 major_merge_fallbacks=m["major_merge_fallbacks"]["value"],
                 mesh_width=hurt.shards, fired=fired)
    exhausted = None
    drop = FaultInjector.from_spec({"faults": [
        {"point": "sharded_count", "on_call": 1, "action": "error",
         "dropped": [3]}]})
    try:
        MeshHealer(make_mesh(S), fixed_width=S, chaos=drop).run(
            lambda: drop.fire("sharded_count"))
    except HealExhaustedError as e:
        exhausted = str(e)
    assert exhausted is not None
    heals["fixed_width_exhausted"] = exhausted
    out["heals"] = heals
    log(f"[mesh serving] heals n={nh}: a sharded_count fault dropping "
        f"worker 3 (8 -> {hurt.shards}), a place_base fault, a major_merge "
        f"fault (the counted host path): wins2 equal after every batch; "
        f"{json.dumps({k2: v for k2, v in heals.items() if k2 != 'fired'})}")
    hurt.close()
    plain.close()
    lap("b heals")

    # (c) the fleet: phase 21's stream cut to MESH_FLEET_EVENTS on a mesh
    # of S, in lockstep with the single-device fleet; resize 8 -> 4 -> 8,
    # then a heal
    nf = MESH_FLEET_EVENTS
    fs, fl, ft = fleet_stream(nf, FLEET_TENANTS)
    chunks = fleet_chunks(fs, fl, ft, FLEET_CHUNK)
    third = len(chunks) // 3
    # the heal lands in the last third, on the mesh of S again
    fspec = {"faults": [{"point": "sharded_count", "on_call":
                         2 * third + (len(chunks) - 2 * third) // 2,
                         "action": "error", "dropped": [5]}]}
    finj = FaultInjector.from_spec(fspec)
    mfleet = TenantFleetIndex(compact_every=FLEET_COMPACT, count_kernel=True,
                              shards=S, chaos=finj, retry_backoff_s=0.0)
    sfleet = TenantFleetIndex(compact_every=FLEET_COMPACT, count_kernel=True)
    before = pk.LAUNCHES["tenant_count[mesh]"]
    lats, slats = [], []
    for part, width in ((chunks[:third], 4), (chunks[third:2 * third], S),
                        (chunks[2 * third:], None)):
        got = drive_fleets(part, [mfleet, sfleet])
        lats += got[0]
        slats += got[1]
        if width is not None:
            assert mfleet.resize_shards(width)
    fleet_launched = pk.LAUNCHES["tenant_count[mesh]"] - before
    frec = fleet_record(mfleet, lats, nf, chunks, fleet_launched)
    assert fleet_launched == frec["applies"] == frec["kernel_calls"], frec
    assert frec["kernel_fallbacks"] == 0, frec
    assert frec["bytes_h2d_saved"] > 0 and frec["pack_replaces"] > frec[
        "pack_full_replaces"], frec
    assert finj.snapshot()["fired"] == {"sharded_count": 1}
    assert mfleet.shards == S - 1
    fm = mfleet.metrics.snapshot()
    frec.update(reshard_events=fm["reshard_events"]["value"],
                mesh_width=mfleet.shards,
                recovery_time_s_max=fm["recovery_time_s"]["max"],
                # the lockstep single-device fleet, at the same depth
                single_events_per_s=nf / sum(slats),
                single_apply_p99_ms=float(np.percentile(slats, 99)) * 1e3)
    checked = 0
    for tid, grp in tenant_groups(ft):
        s_, l_ = fs[grp], fl[grp]
        if l_.any() and not l_.all():
            want = auc_score(s_[l_], s_[~l_])
            assert mfleet.auc(tid) == want == sfleet.auc(tid), tid
            checked += 1
    out["fleet"] = frec
    log(f"[mesh serving] fleet S={S} n={nf} T={FLEET_TENANTS} chunk="
        f"{FLEET_CHUNK}: {frec['events_per_s']:.0f} events/s, apply p50 "
        f"{frec['apply_p50_ms']:.3f} ms p99 {frec['apply_p99_ms']:.3f} ms "
        f"(the single-device fleet in lockstep: "
        f"{frec['single_events_per_s']:.0f} events/s, apply p99 "
        f"{frec['single_apply_p99_ms']:.3f} ms), "
        f"{frec['applies']} applies, {fleet_launched} worker-axis launches, "
        f"caps {frec['pack_caps']}, {frec['bytes_h2d']} bytes placed "
        f"({frec['bytes_h2d_saved']} saved), {frec['pack_replaces']} "
        f"re-places of which {frec['pack_full_replaces']} full; resize 8 -> "
        f"4 -> 8 and a heal dropping worker 5 ({frec['reshard_events']} "
        f"reshards, recovery max {frec['recovery_time_s_max']:.6f} s): "
        f"wins2 equal to the single-device fleet after every apply, "
        f"{checked} tenants' auc() = their float32 oracle")
    mfleet.close()
    sfleet.close()
    lap("c fleet")

    # (d) both engines on the mesh under a chaos schedule, against
    # fault-free runs over the admitted events
    ne = MESH_ENGINE_EVENTS
    es, el = make_stream(ne, pos_frac=0.5, separation=1.0, seed=3)
    poison = [100, ne // 2, ne // 2 + 1]
    espec = {"faults": [
        {"point": "batcher", "on_call": 5, "action": "error"},
        {"point": "compactor_build", "on_call": 1, "action": "error"},
        {"point": "sharded_count", "on_call": 20, "action": "error",
         "dropped": [3]},
        {"point": "poison", "at_events": poison, "value": "nan"}]}
    cfg = ServingConfig(policy="block", max_batch=256, compact_every=1024,
                        mesh_shards=S, bg_compact=True, count_kernel=True)
    erec = replay(es, el, config=cfg, chaos=espec, max_inflight=64)
    keep = np.ones(ne, dtype=bool)
    keep[poison] = False
    clean = replay(es[keep], el[keep], config=dataclasses.replace(
        cfg, mesh_shards=None, bg_compact=False), max_inflight=64)
    ef = erec["faults"]
    assert ef["chaos"]["fired"] == {"batcher": 1, "compactor_build": 1,
                                    "sharded_count": 1}, ef
    assert erec["shed_events"] == poison and ef["poison_rejects"] == 3
    assert erec["auc_exact"] == clean["auc_exact"] and erec[
        "auc_abs_err"] == 0, (erec["auc_exact"], clean["auc_exact"])
    assert (erec["index"]["n_pos"], erec["index"]["n_neg"]) == (
        clean["index"]["n_pos"], clean["index"]["n_neg"])
    nfe = MESH_FLEET_ENGINE_EVENTS
    gs, gl, gt = make_stream_fleet(nfe)
    fpoison = [7, nfe // 2]
    gspec = dict(espec, faults=[dict(f, at_events=fpoison)
                                if f["point"] == "poison" else f
                                for f in espec["faults"]])
    gcfg = dataclasses.replace(cfg, compact_every=FLEET_COMPACT)
    grec = replay_fleet(gs, gl, gt, config=gcfg, chaos=gspec,
                        max_inflight=64)
    gkeep = np.ones(nfe, dtype=bool)
    gkeep[fpoison] = False
    gclean = replay_fleet(gs[gkeep], gl[gkeep], gt[gkeep],
                          config=dataclasses.replace(
                              gcfg, mesh_shards=None, bg_compact=False),
                          max_inflight=64)
    gf = grec["faults"]
    assert gf["chaos"]["fired"] == {"batcher": 1, "compactor_build": 1,
                                    "sharded_count": 1}, gf
    assert grec["events_poison_rejected"] == 2
    assert grec["tenant_auc_max_abs_err"] == 0.0 == gclean[
        "tenant_auc_max_abs_err"], (grec["tenant_auc_max_abs_err"],
                                    gclean["tenant_auc_max_abs_err"])
    assert grec["events_applied"] == gclean["events_applied"]
    keepk = ("events_per_s", "insert_latency_p50_ms",
             "insert_latency_p99_ms", "batches")
    out["engine"] = dict({k2: erec[k2] for k2 in keepk},
                         faults=ef, auc_exact=erec["auc_exact"])
    out["fleet_engine"] = dict({k2: grec[k2] for k2 in keepk},
                               faults=gf, fleet_count_calls=grec[
                                   "fleet_count_calls"])
    log(f"[mesh serving] engine mesh_shards={S} n={ne} under a batcher "
        f"crash, a compactor crash, a drop of worker 3 and 3 poison events: "
        f"{erec['events_per_s']:.0f} events/s, insert p99 "
        f"{erec['insert_latency_p99_ms']:.3f} ms; auc {erec['auc_exact']!r}"
        f" = the fault-free run over the admitted events; "
        f"{json.dumps({k2: v for k2, v in ef.items() if k2 != 'chaos'})}")
    log(f"[mesh serving] fleet engine mesh_shards={S} n={nfe} T="
        f"{FLEET_TENANTS}, same schedule, 2 poison events: "
        f"{grec['events_per_s']:.0f} events/s, insert p99 "
        f"{grec['insert_latency_p99_ms']:.3f} ms; every tenant's auc = its "
        f"float32 oracle over the admitted events, as in the fault-free run")

    lap("d engines")
    # (e) a one-rank NCCL group: the sharded index on DistComm
    mesh_nccl_index(scores, labels)
    lap("e nccl")
    restore()
    launches = dict(pk.LAUNCHES)

    # timing, after the counts are read: kernel 6 over the worker axis at
    # the mesh index's shape, kernel 7 at phase 21's packs split over S
    rows = []
    runs_n, runs_p = probe_runs
    qa, qb = probe_q
    args = ([r for r, _, _ in runs_n + runs_p],
            [sg for _, _, sg in runs_n + runs_p],
            [0] * len(runs_n) + [1] * len(runs_p), qa, qb)
    rows.append(mesh_row(
        "signed_count[mesh]", args, ck.signed_count_mesh,
        ck.signed_count_mesh_plain, sc.signed_count_searchsorted_mesh,
        mesh_count_bound_ms(args[0], args[2], qa, qb),
        f"S={S}: caps {[r.shape[1] for r in args[0]]} (signs "
        f"{args[1]}), qa={len(qa)} qb={len(qb)}",
        f"{2 * len(args[0])} batched searchsorted", launches, plain_reps=3))
    mesh = make_mesh(S)
    hs, hl, ht = fleet_stream(FLEET_EVENTS, FLEET_TENANTS)
    fruns = {True: [np.empty(0, np.float32)] * FLEET_TENANTS,
             False: [np.empty(0, np.float32)] * FLEET_TENANTS}
    for tid, grp in tenant_groups(ht):
        for side in (True, False):
            fruns[side][int(tid[1:])] = np.sort(hs[grp][hl[grp] == side])
    pos, cap_p, _ = sc.place_tenant_pack(mesh, fruns[True], FLEET_TENANTS)
    neg, cap_n, _ = sc.place_tenant_pack(mesh, fruns[False], FLEET_TENANTS)
    last = fleet_chunks(hs[-FLEET_CHUNK:], hl[-FLEET_CHUNK:],
                        ht[-FLEET_CHUNK:], FLEET_CHUNK)[0]
    qn, qp = apply_queries(last, FLEET_TENANTS)
    targs = (pos, neg, qn, qp)
    rows.append(mesh_row(
        "tenant_count[mesh]", targs, ck.tenant_count_mesh,
        ck.tenant_count_mesh_plain, sc.tenant_count_searchsorted_mesh,
        mesh_tenant_bound_ms(*targs),
        f"S={S}: packs [{S}, {FLEET_TENANTS}, {cap_p}] / [{S}, "
        f"{FLEET_TENANTS}, {cap_n}] (phase 21's [1024, 2^17] split), qb "
        f"{qn.shape[1]} ({len(last)} tenants of a 256-event apply)",
        "4 batched searchsorted", launches, plain_reps=1, reps=200))
    del pos, neg, targs
    lap("timing")
    out["kernel_rows"] = [r["name"] for r in rows]
    parts = {k2: round(v, 1) for k2, v in out["part_s"].items()}
    log(f"[mesh serving] seconds by part: {json.dumps(parts)}")
    return out, launches, rows


def mesh_nccl_index(scores, labels):
    """Phase 26(e): the sharded index on a one-rank NCCL group (DistComm)
    against the single-device index, wins2 equal after every batch."""
    from tuplewise_tpu_torch import ExactAucIndex
    from tuplewise_tpu_torch.parallel import distributed
    from tuplewise_tpu_torch.parallel.mesh import make_mesh

    import torch.distributed as dist

    n = MESH_NCCL_EVENTS
    with tempfile.TemporaryDirectory() as tmp:
        assert distributed.initialize(num_processes=1, process_id=0,
                                      init_method=f"file://{tmp}/store")
        try:
            dmesh = make_mesh(distributed=True)
            assert dmesh.distributed and dist.get_backend() == "nccl"
            didx = ExactAucIndex(window=n // 2, compact_every=INDEX_COMPACT,
                                 count_kernel=True, mesh=dmesh)
            sidx = ExactAucIndex(window=n // 2, compact_every=INDEX_COMPACT,
                                 count_kernel=True)
            drive_index_lockstep(scores, labels, n, [didx, sidx])
            assert didx.n_major_merges > 0
        finally:
            dist.destroy_process_group()
    log(f"[mesh serving] one-rank NCCL group: the sharded index (DistComm) "
        f"over {n} events equal to the single-device index after every "
        f"batch")


def make_stream_fleet(n):
    """A Zipf tenant stream of n events over FLEET_TENANTS (seed 4)."""
    return fleet_stream(n, FLEET_TENANTS, seed=4)


def mesh_row(name, args, kernel, plain, library, bound, shape, library_calls,
             launches, plain_reps, reps=1000):
    """A worker-axis kernel's timing row: device ms a launch
    (torch.profiler), ms a call (CUDA events), its plain version and the
    batched searchsorted twin on the same inputs, the sums over workers
    held equal."""
    times, timed_by = {}, "torch.profiler"
    for label, fn, r in (("kernel", lambda: kernel(*args), reps),
                         ("plain", lambda: plain(*args), plain_reps),
                         ("library", lambda: library(*args), 200)):
        if label != "plain":
            fn()                                              # warm-up
        call_ms, out = cuda_ms(fn, r)
        dev_ms = sum(device_ms_by_kernel(fn, r).values())
        if dev_ms <= 0:
            # the profiler saw no device time (it has missed the ctypes
            # kernels late in the script): the events' time a call, which
            # bounds the device time from above
            dev_ms, timed_by = call_ms, "CUDA events (no profile)"
        times[label] = (call_ms, dev_ms, out)
    got, want, lib = (times[k][2] for k in ("kernel", "plain", "library"))
    err = max(int((got.long() - want.long()).abs().max()),
              int((got.long() - lib.long()).abs().max()))
    assert err == 0, (name, err)
    bms, by, byts = bound
    (call_ms, ms, _), (_, plain_ms, _), (lib_call_ms, lib_ms, _) = (
        times["kernel"], times["plain"], times["library"])
    replaces = {
        "signed_count[mesh]": "tuplewise_tpu/ops/pallas_counts.py:173",
        "tenant_count[mesh]": "tuplewise_tpu/ops/pallas_counts.py:295"}
    row = dict(name=name, route="cuda", source=source_of(name),
               replaces=replaces[name], launches=launches.get(name, 0),
               max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, bound_bytes=byts,
               library_ms=lib_ms,
               library_call_ms=lib_call_ms, library_calls=library_calls,
               shape=shape, ms_by=timed_by)
    log(f"[timing] {name} {shape}: {ms * 1e3:.2f} us of device time a "
        f"launch by {timed_by} ({call_ms * 1e3:.2f} us a call by events; "
        f"bound "
        f"{bms * 1e3:.3f} us by {by}: {byts / 1e6:.3f} MB), plain "
        f"{plain_ms:.3f} ms, batched searchsorted ({library_calls}) "
        f"{lib_ms * 1e3:.2f} us ({lib_call_ms * 1e3:.2f} us a call); max "
        f"|kernel - plain|, |kernel - searchsorted| over the worker sums' "
        f"blocks = {err}")
    return row


# --------------------------------------------------------------------- #
# slice 16: crash-safe serving and its observability                    #
# --------------------------------------------------------------------- #

# the count kernels' launch counters that phase 27 reads
RECOVERY_KEYS = ("signed_count[flat]", "signed_count[mesh]", "tenant_count")

# the SLO spec of phase 27(e): a latency quantile, an availability burn
# rate, a counter cap and a saturation objective
RECOVERY_SLO = {"objectives": [
    {"name": "insert_p99", "type": "latency", "metric": "insert_latency_s",
     "quantile": "p99", "threshold_ms": 50.0},
    {"name": "availability", "type": "error_rate",
     "errors": ["poison_rejects", "deadline_expired_total",
                "rejected_total", "dropped_total"],
     "total": "requests_insert_total", "objective": 0.999,
     "windows": [{"window_s": 1.0, "burn": 10.0},
                 {"window_s": 5.0, "burn": 2.0}]},
    {"name": "no_heal_exhaustion", "type": "counter_max",
     "metric": "heal_exhausted_total", "max": 0},
    {"name": "queue_saturation", "type": "saturation",
     "metric": "queue_depth_live", "capacity": "queue_size",
     "max_fraction": 0.9}]}


def count_launches(keys=RECOVERY_KEYS):
    """The launch counters of ``keys`` (the count kernels') now."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    return {k: pk.LAUNCHES.get(k, 0) for k in keys}


def launched_since(before, into=None, keys=RECOVERY_KEYS):
    """The launches of ``keys`` since ``before`` (a count_launches()),
    added into ``into`` when given; returns them."""
    now = count_launches(keys)
    out = into if into is not None else dict.fromkeys(keys, 0)
    for k in keys:
        out[k] += now[k] - before[k]
    return out


def kernel_calls(metrics, name="count_kernel_calls_total"):
    """A registry's count of the count-kernel calls that reached their
    kernel (its plain version on the CPU)."""
    return metrics.snapshot().get(name, {}).get("value", 0)


def abandon(eng):
    """A crash in miniature: the batcher parked with no close() and no
    final snapshot. The writer thread's in-flight snapshot is let land,
    as if the process died just after it."""
    eng._closed = True
    eng._worker.join(timeout=30)
    eng._recovery._drain_writer()


def recovery_spans(tracer):
    """{span name: [ms, ...]} of a recovery manager's tracer."""
    out = {}
    for s in tracer.spans():
        out.setdefault(s["name"], []).append(s["dur_s"] * 1e3)
    return out


def recover_engine(make):
    """make() constructs a recovering engine: returns (engine, its
    manager's recovery record: the snapshot's seq, the records and
    events replayed, the restore and replay seconds, and the count
    kernels' launches of the restore and the replay, this process's
    alone)."""
    before = count_launches()
    eng = make()
    return eng, dict(eng._recovery.last_recovery,
                     launches=launched_since(before))


def spans_of(lo, hi, chunk):
    """(i, j) bounds of ``chunk``-event requests covering [lo, hi)."""
    return [(i, min(i + chunk, hi)) for i in range(lo, hi, chunk)]


def pipelined(eng, scores, labels, lo, hi, chunk, inflight=64):
    """Inserts of ``chunk`` events from lo to hi, at most ``inflight``
    outstanding; returns the seconds until every one is applied."""
    futs = []
    t = time.perf_counter()
    for i, j in spans_of(lo, hi, chunk):
        futs.append(eng.insert(scores[i:j], labels[i:j]))
        if len(futs) >= inflight:
            futs[len(futs) - inflight].result(120)
    for f in futs:
        f.result(120)
    return time.perf_counter() - t


def snapshot_record(eng, tracer):
    """The snapshots a recovery manager's run landed and their costs."""
    spans = recovery_spans(tracer)
    cap, wr = spans.get("snapshot.capture", []), spans.get(
        "snapshot.write", [])
    from tuplewise_tpu_torch.obs.report import stage_metric

    m = eng.metrics.snapshot()
    return dict(
        snapshots_landed=eng.flight.counts().get("snapshot_landed", 0),
        captures=len(cap),
        capture_ms_p50=float(np.percentile(cap, 50)) if cap else None,
        capture_ms_max=max(cap) if cap else None,
        write_ms_p50=float(np.percentile(wr, 50)) if wr else None,
        write_ms_max=max(wr) if wr else None,
        **{f"{st}_p99_ms": m[stage_metric(st)]["p99"] * 1e3
           for st in ("wal_append", "snapshot")
           if stage_metric(st) in m},     # the fleet has no stages
        last_snapshot_error=eng._recovery.last_snapshot_error)


def recording(idx):
    """Wraps an index's insert_batch to record (wins2, auc) after each
    call: returns the list."""
    seen = []
    real = idx.insert_batch

    def insert_batch(scores, labels):
        real(scores, labels)
        seen.append((idx._wins2, idx.auc()))

    idx.insert_batch = insert_batch
    return seen


def check_recovered_launches(part, launches, calls, want, device):
    """A recovered engine's own count-kernel calls (its registry's
    counts, ``calls``) equal ``want`` for each key given there; on the
    card each of its calls is one launch of that kernel."""
    for key, n in calls.items():
        if key in want:
            assert n == want[key], (part, key, n, want[key])
        if device is None:
            assert launches[key] == n, (part, key, launches[key], n)


def recovery_index_crash(tmp, device=None):
    """Phase 27(a): the index engine (kernel 6) on phase 17's stream,
    abandoned halfway, recovered and finished beside an uninterrupted
    engine's index, batch by batch."""
    from tuplewise_tpu_torch.models.metrics import auc_score
    from tuplewise_tpu_torch.obs.tracing import Tracer
    from tuplewise_tpu_torch.serving import (
        MicroBatchEngine, ServingConfig, make_stream,
    )

    n, cut, c = RECOVERY_EVENTS, RECOVERY_CRASH_AT, INDEX_CHUNK
    w = RECOVERY_WINDOW
    flat = "signed_count[flat]"
    # phase 17's stream, its first n events
    scores, labels = make_stream(INDEX_EVENTS, pos_frac=0.5, separation=1.0,
                                 seed=0)
    scores, labels = scores[:n].astype(np.float32), labels[:n]
    d = os.path.join(tmp, "index")
    # max_batch counts requests: one request of c events a micro-batch
    kw = dict(window=w, compact_every=INDEX_COMPACT, count_kernel=True,
              policy="block", device=device, max_batch=1)
    # the same stream's first half without recovery: the events/s the
    # WAL and the snapshots are held against; its index goes on as the
    # uninterrupted run
    launches = {}
    before = count_launches()
    base = MicroBatchEngine(ServingConfig(**kw))
    base_s = pipelined(base, scores, labels, 0, cut, c)
    launched_since(before, launches.setdefault(
        "reference", dict.fromkeys(RECOVERY_KEYS, 0)))
    before = count_launches()
    eng = MicroBatchEngine(ServingConfig(snapshot_dir=d, **kw))
    eng._recovery.tracer = tracer = Tracer()
    rec_s = pipelined(eng, scores, labels, 0, cut, c)
    abandon(eng)
    launches["pre_crash"] = launched_since(before)
    out = dict(events_per_s_recovery=cut / rec_s,
               events_per_s_plain=cut / base_s,
               **snapshot_record(eng, tracer))
    out["ratio"] = out["events_per_s_recovery"] / out["events_per_s_plain"]
    assert out["last_snapshot_error"] is None, out
    assert out["snapshots_landed"] > 0, out
    del eng
    eng2, times = recover_engine(lambda: MicroBatchEngine(ServingConfig(
        snapshot_dir=d, recover=True, **kw)))
    launches["recovery"] = times.pop("launches")
    assert times["seq"] == cut and times["records"] > 0, times
    assert eng2.index._wins2 == base.index._wins2
    # every replayed WAL record one count of the restored runs
    check_recovered_launches(
        "(a) recovery", launches["recovery"],
        {flat: kernel_calls(eng2.index.metrics)}, {flat: times["records"]},
        device)
    # one request a batch on both: the recorded (wins2, auc) of each
    # batch after the recovery, held against the uninterrupted run's
    got, want = recording(eng2.index), recording(base.index)
    calls0 = kernel_calls(eng2.index.metrics)
    before = count_launches()
    t = time.perf_counter()
    pipelined(eng2, scores, labels, cut, n, c)
    times["finish_s"] = time.perf_counter() - t
    launches["after"] = launched_since(before)
    checked = len(spans_of(cut, n, c))
    # one launch a batch of the recovered engine, this run's alone
    check_recovered_launches(
        "(a) after", launches["after"],
        {flat: kernel_calls(eng2.index.metrics) - calls0}, {flat: checked},
        device)
    before = count_launches()
    with base._lock:    # the idle engine's index, driven directly
        for i, j in spans_of(cut, n, c):
            base.index.insert_batch(scores[i:j], labels[i:j])
    launched_since(before, launches["reference"])
    assert len(got) == len(want) == checked, (len(got), len(want))
    assert got == want, next(k for k, (a, b) in enumerate(zip(got, want))
                             if a != b)
    tail_s, tail_l = scores[n - w:], labels[n - w:]
    oracle = auc_score(tail_s[tail_l], tail_s[~tail_l])
    assert got[-1][1] == oracle, (got[-1], oracle)
    base.close()
    t = time.perf_counter()
    eng2.close()
    times["close_s"] = time.perf_counter() - t
    out.update(times, aucs_checked=checked, auc=oracle, launches=launches)
    log(f"[recovery] (a) index engine, kernel 6, n={n} window={w} "
        f"batches of {c}, snapshot_every 4096, abandoned at {cut}: "
        f"{out['events_per_s_recovery']:.0f} events/s with recovery, "
        f"{out['events_per_s_plain']:.0f} without ({out['ratio']:.3f}x); "
        f"{out['snapshots_landed']} snapshots landed ({out['captures']} "
        f"captures: {out['capture_ms_p50']:.2f} ms p50, "
        f"{out['capture_ms_max']:.2f} ms max; writes "
        f"{out['write_ms_p50']:.2f} ms p50, {out['write_ms_max']:.2f} ms "
        f"max); stage p99 wal_append {out['wal_append_p99_ms']:.4f} ms, "
        f"snapshot {out['snapshot_p99_ms']:.4f} ms")
    log(f"[recovery] (a) recovered to seq {times['seq']} in "
        f"{times['restore_s'] + times['replay_s']:.3f} s: restore "
        f"{times['restore_s']:.3f} s (snapshot at {times['snapshot_seq']}), "
        f"tail replay {times['replay_s']:.3f} s ({times['events']} events, "
        f"{times['records']} records, {launches['recovery'][flat]} "
        f"launches); wins2 and the AUC equal the uninterrupted run's after "
        f"each of {checked} batches ({launches['after'][flat]} launches of "
        f"the recovered engine, in {times['finish_s']:.2f} s); final auc "
        f"{oracle!r} = the float32 oracle; close (final snapshot) "
        f"{times['close_s']:.3f} s; launches by step {json.dumps(launches)}")
    return out


def recovery_mesh_crash(tmp, device=None):
    """Phase 27(b): the sharded index (S workers, kernel 6 over the
    worker axis) recovered mid-delta, each replayed record and each
    recovered batch one worker-axis launch."""
    from tuplewise_tpu_torch import ExactAucIndex
    from tuplewise_tpu_torch.serving import (
        MicroBatchEngine, ServingConfig, make_stream,
    )
    from tuplewise_tpu_torch.serving.recovery import SNAPSHOT_FILE
    from tuplewise_tpu_torch.utils.checkpoint import load_checkpoint

    n, cut, c = RECOVERY_MESH_EVENTS, RECOVERY_MESH_CRASH_AT, INDEX_CHUNK
    S, mesh = MESH_SERVE_WORKERS, "signed_count[mesh]"
    scores, labels = make_stream(n, pos_frac=0.5, separation=1.0, seed=0)
    scores = scores.astype(np.float32)
    d = os.path.join(tmp, "mesh")
    # TestDeltaRecovery's tiers: majors wait for 64 minors, so the crash
    # lands with a delta run and a tombstone multiset live
    kw = dict(window=n // 2, compact_every=INDEX_COMPACT, count_kernel=True,
              mesh_shards=S, delta_fraction=4.0, max_delta_runs=64,
              policy="block", device=device, max_batch=1)
    before = count_launches()
    eng = MicroBatchEngine(ServingConfig(snapshot_dir=d, **kw))
    pipelined(eng, scores, labels, 0, cut, c)
    live = eng.index.state()
    abandon(eng)
    launches = dict(pre_crash=launched_since(before))
    del eng
    snap = load_checkpoint(os.path.join(d, SNAPSHOT_FILE))
    held = {k: sum(len(snap["extra"][f"{s}_{k}"]) for s in ("pos", "neg"))
            for k in ("delta_run", "tomb_run")}
    assert held["delta_run"] > 0 and held["tomb_run"] > 0, held
    before = count_launches()
    ref = ExactAucIndex(window=n // 2, compact_every=INDEX_COMPACT,
                        count_kernel=True, device=device)
    for i, j in spans_of(0, cut, c):
        ref.insert_batch(scores[i:j], labels[i:j])
    launches["reference"] = launched_since(before)
    eng2, times = recover_engine(lambda: MicroBatchEngine(ServingConfig(
        snapshot_dir=d, recover=True, **kw)))
    launches["recovery"] = times.pop("launches")
    assert times["seq"] == cut and eng2.index._wins2 == ref._wins2
    assert eng2.index.state()["delta_events"] > 0
    check_recovered_launches(
        "(b) recovery", launches["recovery"],
        {mesh: kernel_calls(eng2.index.metrics)}, {mesh: times["records"]},
        device)
    launches["after"] = dict.fromkeys(RECOVERY_KEYS, 0)
    batches = 0
    for i, j in spans_of(cut, n, c):
        calls0, before = kernel_calls(eng2.index.metrics), count_launches()
        eng2.insert(scores[i:j], labels[i:j]).result(60)
        one = launched_since(before)
        check_recovered_launches(
            f"(b) batch at {i}", one,
            {mesh: kernel_calls(eng2.index.metrics) - calls0}, {mesh: 1},
            device)
        launched_since(before, launches["after"])
        before = count_launches()
        ref.insert_batch(scores[i:j], labels[i:j])
        launched_since(before, launches["reference"])
        assert eng2.index._wins2 == ref._wins2, i
        assert eng2.index.auc() == ref.auc(), i
        batches += 1
    eng2.close()
    out = dict(times, snapshot_delta_events=held["delta_run"],
               snapshot_tombstones=held["tomb_run"], batches=batches,
               live_at_crash={k: live[k] for k in ("delta_events",
                                                   "tombstones")},
               launches=launches)
    log(f"[recovery] (b) sharded index S={S} n={n} window={n // 2}, "
        f"abandoned at {cut} (live delta {live['delta_events']}, tombstones "
        f"{live['tombstones']}; the snapshot holds a delta run of "
        f"{held['delta_run']} and {held['tomb_run']} tombstones): restore "
        f"{times['restore_s']:.3f} s, tail {times['replay_s']:.3f} s "
        f"({times['events']} events, {times['records']} records, "
        f"{launches['recovery'][mesh]} worker-axis launches); {batches} "
        f"recovered batches equal to the single-device index, one "
        f"worker-axis launch each; launches by step {json.dumps(launches)}")
    return out


def counting_applies(fleet):
    """Wraps a fleet's apply_inserts to count the applies that hold a
    pack tenant (one kernel 7 call each) and the whale items whose index
    has a base run to count (one kernel 6 call each): returns the
    counts."""
    seen = {"applies": 0, "pack_applies": 0, "whale_counts": 0}
    real = fleet.apply_inserts

    def apply_inserts(items):
        seen["applies"] += 1
        whales = [fleet._by_tid[t].idx for t, _, _ in items
                  if fleet.is_whale(t)]
        seen["pack_applies"] += len(whales) < len(items)
        seen["whale_counts"] += sum(
            1 for idx in whales if len(idx._pos.base) or len(idx._neg.base))
        return real(items)

    fleet.apply_inserts = apply_inserts
    return seen


def recovery_fleet_crash(tmp, device=None):
    """Phase 27(c): the fleet engine (kernel 7, whales on kernel 6) on
    phase 21's stream cut, abandoned halfway, recovered and finished;
    every tenant equal to the uninterrupted fleet."""
    from tuplewise_tpu_torch import TenantFleetIndex
    from tuplewise_tpu_torch.obs.tracing import Tracer
    from tuplewise_tpu_torch.serving import (
        MultiTenantEngine, ServingConfig, TenancyConfig,
    )
    from tuplewise_tpu_torch.serving.recovery import SNAPSHOT_FILE
    from tuplewise_tpu_torch.utils.checkpoint import load_checkpoint

    n = RECOVERY_FLEET_EVENTS
    flat, tenant = "signed_count[flat]", "tenant_count"
    scores, labels, tids = fleet_stream(n, FLEET_TENANTS)
    chunks = fleet_chunks(scores, labels, tids, FLEET_CHUNK)
    half = len(chunks) // 2
    d = os.path.join(tmp, "fleet")
    cfg = dict(compact_every=FLEET_COMPACT, count_kernel=True,
               policy="block", device=device, max_batch=FLEET_CHUNK)
    ten = TenancyConfig(max_tenants=FLEET_TENANTS,
                        whale_threshold=RECOVERY_WHALE)

    def feed(eng, part):
        for groups in part:
            futs = [eng.insert(t, s, lab) for t, s, lab in groups]
            for f in futs:
                f.result(120)

    steps, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = now - clock[0]
        clock[0] = now

    # the uninterrupted fleet first, alone on the host
    before = count_launches()
    ref = TenantFleetIndex(compact_every=FLEET_COMPACT, count_kernel=True,
                           whale_threshold=RECOVERY_WHALE, device=device)
    for groups in chunks:
        ref.apply_inserts(groups)
    want = {t: ref.wins2(t) for t in ref.tenants()}
    want_whales = {t for t in ref.tenants() if ref.is_whale(t)}
    ref.close()
    launches = dict(reference=launched_since(before))
    lap("reference_s")
    before = count_launches()
    eng = MultiTenantEngine(ServingConfig(snapshot_dir=d, **cfg), ten)
    eng._recovery.tracer = tracer = Tracer()
    feed(eng, chunks[:half])
    lap("first_half_s")
    abandon(eng)
    launches["pre_crash"] = launched_since(before)
    lap("abandon_s")
    snaps = snapshot_record(eng, tracer)
    assert snaps["last_snapshot_error"] is None, snaps
    del eng
    keys = len(load_checkpoint(os.path.join(d, SNAPSHOT_FILE))["extra"])
    eng2, times = recover_engine(lambda: MultiTenantEngine(ServingConfig(
        snapshot_dir=d, recover=True, **cfg), ten))
    launches["recovery"] = times.pop("launches")
    lap("recover_s")
    m = eng2.fleet.metrics
    # each replayed record one apply of one tenant: a fleet count of the
    # re-placed packs, or its whale's count
    rec = launches["recovery"]
    fleet_calls = kernel_calls(m, "fleet_count_calls_total")
    assert 0 < fleet_calls <= times["records"], (fleet_calls, times)
    check_recovered_launches(
        "(c) recovery", rec,
        {tenant: fleet_calls, flat: kernel_calls(m) - fleet_calls}, {},
        device)
    if device is None:
        assert rec[tenant] + rec[flat] <= times["records"], (rec, times)
    whales = [t for t in eng2.fleet.tenants() if eng2.fleet.is_whale(t)]
    assert whales, "no whale promoted before the crash"
    applies = counting_applies(eng2.fleet)
    calls0 = (kernel_calls(m, "fleet_count_calls_total"), kernel_calls(m))
    before = count_launches()
    feed(eng2, chunks[half:])
    eng2.flush()
    launches["after"] = launched_since(before)
    lap("second_half_s")
    # one kernel 7 launch an apply with a pack tenant, one kernel 6
    # launch a counted whale item: the recovered engine's own
    fc = kernel_calls(m, "fleet_count_calls_total") - calls0[0]
    check_recovered_launches(
        "(c) after", launches["after"],
        {tenant: fc, flat: kernel_calls(m) - calls0[1] - fc},
        {tenant: applies["pack_applies"], flat: applies["whale_counts"]},
        device)
    got = {t: eng2.fleet.wins2(t) for t in eng2.fleet.tenants()}
    assert got == want, "tenant wins2 diverged"
    assert want_whales == {t for t in eng2.fleet.tenants()
                           if eng2.fleet.is_whale(t)}
    eng2.close()
    lap("close_s")
    out = dict(times, **snaps, tenants=len(got), whales_at_crash=len(whales),
               snapshot_keys=keys, steps=steps, applies_after=applies,
               launches=launches, first_half_events_per_s=(
                   sum(len(s) for g in chunks[:half] for _, s, _ in g)
                   / steps["first_half_s"]))
    log(f"[recovery] (c) fleet T={FLEET_TENANTS} Zipf {FLEET_SKEW} "
        f"n={n}, whale threshold {RECOVERY_WHALE}: abandoned after "
        f"{half} of {len(chunks)} applies ({len(whales)} whales), "
        f"{snaps['snapshots_landed']} snapshots landed, a snapshot "
        f"{keys} keys, written in {snaps['write_ms_p50']:.1f} ms p50 "
        f"({snaps['write_ms_max']:.1f} ms max), captured in "
        f"{snaps['capture_ms_p50']:.1f} ms p50; restore "
        f"{times['restore_s']:.3f} s, tail {times['replay_s']:.3f} s "
        f"({times['events']} events, {times['records']} records: "
        f"{rec[tenant]} kernel 7 and {rec[flat]} kernel 6 launches); "
        f"after it {applies['applies']} applies, {launches['after'][tenant]} "
        f"kernel 7 launches (one an apply with a pack tenant) and "
        f"{launches['after'][flat]} kernel 6 (the whales'); all {len(got)} "
        f"tenants' wins2 equal to the uninterrupted fleet's; seconds by "
        f"step {json.dumps({k: round(v, 2) for k, v in steps.items()})}; "
        f"launches by step {json.dumps(launches)}")
    return out


def start_serving_child(tmp, device=None):
    """Phase 27(d)'s child: the index engine on the card behind the
    port's line-protocol serving child, started early so that its start
    on the card overlaps the parts before (d). Returns (process, spec)."""
    d = os.path.join(tmp, "killed")
    kw = dict(window=RECOVERY_KILL_EVENTS // 2, compact_every=INDEX_COMPACT,
              count_kernel=True, policy="block", snapshot_dir=d,
              snapshot_every=2048, max_batch=1, device=device)
    code = ("import sys; from tuplewise_tpu_torch.testing.serve_child "
            "import main; main(sys.argv[1])")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    child = subprocess.Popen(
        [sys.executable, "-c", code, json.dumps({"config": kw})],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)
    return child, kw


def recovery_sigkill(tmp, child, kw, device=None):
    """Phase 27(d): a child process serves the index engine on the card
    and acknowledges each insert; killed with SIGKILL after its
    acknowledgements, the engine recovers here and finishes; the final
    AUC equals the float32 oracle."""
    import signal

    from tuplewise_tpu_torch.models.metrics import auc_score
    from tuplewise_tpu_torch.serving import (
        MicroBatchEngine, ServingConfig, make_stream,
    )

    n, cut, c = RECOVERY_KILL_EVENTS, RECOVERY_KILL_AT, INDEX_CHUNK
    flat = "signed_count[flat]"
    scores, labels = make_stream(n, pos_frac=0.5, separation=1.0, seed=3)
    scores = scores.astype(np.float32)
    try:
        acked = 0
        for i, j in spans_of(0, cut, c):
            child.stdin.write(json.dumps(
                {"op": "insert", "score": scores[i:j].tolist(),
                 "label": labels[i:j].astype(int).tolist()}) + "\n")
            child.stdin.flush()
            reply = json.loads(child.stdout.readline())
            assert reply["ok"], reply
            acked += reply["n"]
    finally:
        os.kill(child.pid, signal.SIGKILL)
        child.wait(timeout=60)
    assert acked == cut and child.returncode == -signal.SIGKILL
    eng, times = recover_engine(lambda: MicroBatchEngine(ServingConfig(
        recover=True, **kw)))
    launches = dict(recovery=times.pop("launches"))
    assert times["seq"] == cut, times
    check_recovered_launches(
        "(d) recovery", launches["recovery"],
        {flat: kernel_calls(eng.index.metrics)}, {flat: times["records"]},
        device)
    calls0, before = kernel_calls(eng.index.metrics), count_launches()
    for i, j in spans_of(cut, n, c):
        eng.insert(scores[i:j], labels[i:j]).result(60)
    eng.flush()
    launches["after"] = launched_since(before)
    check_recovered_launches(
        "(d) after", launches["after"],
        {flat: kernel_calls(eng.index.metrics) - calls0},
        {flat: len(spans_of(cut, n, c))}, device)
    tail_s, tail_l = scores[n - n // 2:], labels[n - n // 2:]
    oracle = auc_score(tail_s[tail_l], tail_s[~tail_l])
    assert eng.index.auc() == oracle, (eng.index.auc(), oracle)
    eng.close()
    log(f"[recovery] (d) SIGKILL: a child served {cut} acknowledged events "
        f"on the card and was killed; recovered here (restore "
        f"{times['restore_s']:.3f} s, tail {times['replay_s']:.3f} s, "
        f"{times['events']} events in {times['records']} records, "
        f"{launches['recovery'][flat]} launches) and finished {n} "
        f"({launches['after'][flat]} launches, one a batch): auc "
        f"{oracle!r} = the float32 oracle")
    return dict(times, acked=acked, auc=oracle, launches=launches)


def recovery_traced_replay(tmp, device=None):
    """Phase 27(e): replay with the span tracer, metrics export, the
    sampling profiler and an SLO spec, against the same replay untraced;
    then a torch.profiler trace (profile_dir) of a shorter prefix."""
    from tuplewise_tpu_torch.serving import ServingConfig, make_stream, replay

    scores, labels = make_stream(RECOVERY_TRACED_EVENTS, pos_frac=0.5,
                                 separation=1.0, seed=0)
    cfg = ServingConfig(budget=64, max_batch=256, policy="block",
                        flush_timeout_s=0.0005, compact_every=INDEX_COMPACT,
                        count_kernel=True, device=device)
    kw = dict(config=cfg, chunk=RECOVERY_TRACED_CHUNK, max_inflight=64)
    steps = {}
    t = time.perf_counter()
    plain = replay(scores, labels, **kw)
    steps["untraced_s"] = time.perf_counter() - t
    from tuplewise_tpu_torch.obs.tracing import Tracer

    tracer = Tracer(capacity=1 << 17)
    t = time.perf_counter()
    traced = replay(scores, labels, tracer=tracer,
                    trace_out=os.path.join(tmp, "spans.json"),
                    metrics_out=os.path.join(tmp, "metrics.jsonl"),
                    metrics_every_s=0.25, prof=True,
                    prof_out=os.path.join(tmp, "prof.collapsed"),
                    slo_spec=RECOVERY_SLO, **kw)
    steps["traced_s"] = time.perf_counter() - t
    for rec in (plain, traced):
        assert rec["auc_abs_err"] == 0, rec["auc_abs_err"]
    rows = open(os.path.join(tmp, "metrics.jsonl")).read().splitlines()
    spans = tracer.spans()
    names = {s["name"] for s in spans}
    assert {"request.insert", "insert.apply", "insert.index_insert"} <= names
    n_p = RECOVERY_PROFILED_EVENTS
    pdir = os.path.join(tmp, "torch_profile")
    t = time.perf_counter()
    profiled = replay(scores[:n_p], labels[:n_p], profile_dir=pdir, **kw)
    steps["profiled_s"] = time.perf_counter() - t
    with open(os.path.join(pdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"})
    named = [k for k in kernels if "signed_count" in k]
    slo = traced["slo"]
    verdicts = {name: dict(breaches=o["breaches_total"], worst=o["worst"])
                for name, o in slo["objectives"].items()}
    out = dict(spans=len(tracer), spans_dropped=tracer.dropped,
               traced_events_per_s=traced["events_per_s"],
               untraced_events_per_s=plain["events_per_s"],
               prof_overhead_fraction=traced["prof_overhead_fraction"],
               prof_samples=traced["prof_samples"], metrics_rows=len(rows),
               slo_healthy=slo["healthy"], slo_evaluations=slo["evaluations"],
               slo_objectives=verdicts,
               profiled_events_per_s=profiled["events_per_s"],
               profile_kernels=kernels, profile_names_count_kernel=named,
               steps=steps)
    log(f"[recovery] (e) traced replay n={RECOVERY_TRACED_EVENTS} chunk "
        f"{RECOVERY_TRACED_CHUNK}: {len(tracer)} spans ({tracer.dropped} "
        f"dropped), {traced['events_per_s']:.0f} events/s traced against "
        f"{plain['events_per_s']:.0f} untraced; sampling profiler "
        f"{traced['prof_samples']} samples, overhead fraction "
        f"{traced['prof_overhead_fraction']:.4f}; {len(rows)} metrics rows; "
        f"SLO healthy {slo['healthy']} over {slo['evaluations']} "
        f"evaluations, by objective {verdicts}")
    log(f"[recovery] (e) torch.profiler over {n_p} events "
        f"({profiled['events_per_s']:.0f} events/s): {len(kernels)} kernel "
        f"names, the count kernel named: {named}; seconds by step "
        f"{json.dumps({k: round(v, 2) for k, v in steps.items()})}")
    return out


# --------------------------------------------------------------------- #
# slice 17: the control plane and the CLI                                #
# --------------------------------------------------------------------- #

# the kernels phase 28 must launch: kernel 7 and, after a promotion,
# kernel 6 under the controller; kernel 7's worker-axis form under the
# mesh knob; kernels 1, 5 and 3 through the CLI's variance, triplet and
# train
CONTROL_KEYS = ("tenant_count", "signed_count[flat]", "tenant_count[mesh]",
                "pair_sum[auc]", "batched_masked_pair_sum[triplet_indicator]",
                "pair_loss_grad[hinge]")

# (a)'s SLOs: the queue's saturation and every tenant's insert p99
CONTROL_SLO = {"objectives": [
    {"name": "queue_sat", "type": "saturation", "metric": "queue_depth_live",
     "capacity": "queue_size", "max_fraction": 0.8},
    {"name": "tenant_insert_p99", "type": "latency",
     "metric": "insert_latency_s{tenant=*}", "quantile": "p99",
     "threshold_ms": 50.0}]}
CONTROL_SPEC = {"knobs": ["shed", "flush", "weights", "promote"],
                "cooldown_s": 0.25, "up_ticks": 1, "down_ticks": 4,
                "throttle_s": 0.25, "promote_lookahead_s": 2.0}
# (b)'s SLO holds the mesh knob under pressure: every insert p99 is over
MESH_KNOB_SLO = {"objectives": [
    {"name": "insert_p99", "type": "latency", "metric": "insert_latency_s",
     "quantile": "p99", "threshold_ms": 0.001}]}
KILL_AT_2ND_CHECKPOINT = json.dumps({"faults": [
    {"point": "checkpoint", "on_call": 2, "action": "sigkill"}]})


def control_stream(n):
    """Phase 21's stream (float32, T = 1024, Zipf 1.1) with a flash crowd:
    over the middle third tenant t0's rate is CONTROL_FLASH times its
    Zipf rate (the tenants of those events redrawn)."""
    scores, labels, tids = fleet_stream(n, FLEET_TENANTS)
    p = np.arange(1, FLEET_TENANTS + 1, dtype=np.float64) ** -FLEET_SKEW
    p[0] *= CONTROL_FLASH
    lo, hi = n // 3, 2 * n // 3
    ks = np.random.default_rng(SEED + 28).choice(
        FLEET_TENANTS, size=hi - lo, p=p / p.sum())
    tids = tids.copy()
    tids[lo:hi] = [f"t{k}" for k in ks]
    return scores, labels, tids


def has_signal(sig):
    """The doctor's test of an actuation's cause: a non-empty signal
    with a value."""
    return isinstance(sig, dict) and any(v is not None for v in sig.values())


def control_fleet(tmp, device=None):
    """Phase 28(a): replay_fleet over the flash-crowd stream without and
    with the controller (shed, flush, weights, promote) under a
    saturation and a per-tenant p99 objective."""
    from tuplewise_tpu_torch.obs.flight import FlightRecorder
    from tuplewise_tpu_torch.serving import (
        ServingConfig, TenancyConfig, replay_fleet,
    )

    n = CONTROL_EVENTS
    scores, labels, tids = control_stream(n)
    cfg = ServingConfig(budget=16, max_batch=256, policy="block",
                        flush_timeout_s=0.0005, compact_every=512,
                        count_kernel=True, queue_size=64,
                        flight_recorder_size=1 << 18, device=device)
    ten = TenancyConfig(whale_threshold=CONTROL_WHALE, tenant_quota=4096)
    w = CONTROL_WARM_EVENTS
    replay_fleet(scores[:w], labels[:w], tids[:w], config=cfg, tenancy=ten,
                 max_inflight=64, oracle_check=False)
    out = {}
    for mode, spec in (("uncontrolled", None), ("controlled", CONTROL_SPEC)):
        flight = os.path.join(tmp, f"{mode}.jsonl")
        before = count_launches(CONTROL_KEYS)
        rec = replay_fleet(scores, labels, tids, config=cfg, tenancy=ten,
                           max_inflight=64, slo_spec=CONTROL_SLO,
                           controller_spec=spec, metrics_every_s=0.25,
                           flight_out=flight)
        launched = launched_since(before, keys=CONTROL_KEYS)
        acts = [e for e in FlightRecorder.load_dump(flight)["events"]
                if e["kind"] == "actuation"]
        by_knob = {}
        for e in acts:
            key = f"{e['knob']}:{e['action']}"
            by_knob[key] = by_knob.get(key, 0) + 1
        # every admitted tenant's AUC equals its float32 oracle over its
        # admitted events exactly, so its wins2 (2 n_pos n_neg AUC) does
        assert rec["tenant_auc_max_abs_err"] == 0.0, rec.get(
            "tenant_auc_max_abs_err")
        assert rec["events_applied"] + rec["events_tenant_throttled"] == n
        # launches count on the card only (the CPU runs plain versions)
        assert device is not None or launched["tenant_count"] > 0, launched
        out[mode] = dict(
            events_per_s=rec["events_per_s"], wall_s=rec["wall_s"],
            events_applied=rec["events_applied"],
            typed_sheds=rec["events_tenant_throttled"],
            hard_rejects=(rec["events_rejected"]
                          + rec["events_tenant_rejected"]
                          + rec["requests_dropped"]),
            tenant_p99_max_ms=rec["tenant_insert_p99_max_ms"],
            tenant_p99_median_ms=rec["tenant_insert_p99_median_ms"],
            insert_p99_ms=rec["insert_latency_p99_ms"],
            whale_promotions=rec["whale_promotions"],
            slo_healthy=rec["slo"]["healthy"],
            slo_breaches={k: o["breaches_total"]
                          for k, o in rec["slo"]["objectives"].items()},
            actuations=len(acts), actuations_by_knob=by_knob,
            signals=all(has_signal(e["signal"]) for e in acts),
            knobs=(rec["controller"]["knobs"] if "controller" in rec
                   else None),
            boosted_tenants=len(rec.get("controller", {}).get(
                "boosted_weights", {})), launches=launched,
            host_fraction=rec["host_tax"]["host_fraction"])
        log(f"[control] (a) {mode:12s} n={n} T={FLEET_TENANTS} t0 x"
            f"{CONTROL_FLASH} over the middle third: "
            f"{rec['events_per_s']:.0f} events/s, {len(acts)} actuations "
            f"{json.dumps(by_knob)}, typed sheds "
            f"{rec['events_tenant_throttled']}, hard rejects "
            f"{out[mode]['hard_rejects']}, tenant p99 worst "
            f"{rec['tenant_insert_p99_max_ms']:.3f} ms median "
            f"{rec['tenant_insert_p99_median_ms']:.3f} ms, "
            f"{rec['whale_promotions']} promotions, SLO healthy "
            f"{rec['slo']['healthy']} {json.dumps(out[mode]['slo_breaches'])}"
            f", launches {json.dumps(launched)}")
    ctl = out["controlled"]
    assert ctl["actuations"] >= 1 and ctl["signals"], ctl
    assert ctl["hard_rejects"] == 0, ctl
    assert ctl["whale_promotions"] > 0, ctl
    assert device is not None or ctl["launches"][
        "signed_count[flat]"] > 0, ctl["launches"]
    log("[control] (a) every tenant's AUC equal to its float32 oracle over "
        "its admitted events in both runs; every actuation carries its "
        "signal")
    return out


def control_mesh(tmp, device=None):
    """Phase 28(b): a fleet engine at S = 2 on the card's worker axis
    under the mesh knob (up to CONTROL_MESH_MAX workers), its SLO monitor
    pumped every 8 chunks; every tenant's wins2 equals the same stream's
    on one device."""
    from tuplewise_tpu_torch import TenantFleetIndex
    from tuplewise_tpu_torch.obs.slo import SloMonitor
    from tuplewise_tpu_torch.serving import (
        FleetController, MultiTenantEngine, ServingConfig, TenancyConfig,
    )

    n = CONTROL_MESH_EVENTS
    scores, labels, tids = fleet_stream(n, FLEET_TENANTS)
    chunks = fleet_chunks(scores, labels, tids, FLEET_CHUNK)
    cfg = ServingConfig(budget=16, max_batch=1024, policy="block",
                        flush_timeout_s=0.0005, compact_every=FLEET_COMPACT,
                        count_kernel=True, queue_size=4096,
                        mesh_shards=CONTROL_MESH_SHARDS, device=device)
    before = count_launches(CONTROL_KEYS)
    t0 = time.perf_counter()
    with MultiTenantEngine(cfg, TenancyConfig(tenant_quota=4096)) as eng:
        mon = SloMonitor(MESH_KNOB_SLO, registry=eng.metrics,
                         flight=eng.flight, context=dataclasses.asdict(cfg))
        ctl = FleetController(eng, {
            "knobs": ["mesh"], "mesh_max_shards": CONTROL_MESH_MAX,
            "mesh_up_ticks": 1, "cooldown_s": 0.0}).attach(mon)
        for c, items in enumerate(chunks):
            for f in [eng.insert(tid, s, lab) for tid, s, lab in items]:
                f.result(120)
            if c % 8 == 7:
                mon.observe(eng.metrics.snapshot(), time.perf_counter())
        eng.flush()
        wall = time.perf_counter() - t0
        wins = {t: eng.fleet.wins2(t) for t in eng.fleet.tenants()}
        shards = eng.fleet.shards
        resizes = [e for e in eng.flight.events()
                   if e["kind"] == "mesh_resize"]
        state = ctl.state()
    launched = launched_since(before, keys=CONTROL_KEYS)
    one = TenantFleetIndex(compact_every=FLEET_COMPACT, count_kernel=True,
                           device=device)
    for items in chunks:
        one.apply_inserts(items)
    assert wins == {t: one.wins2(t) for t in one.tenants()}
    one.close()
    assert resizes and shards == CONTROL_MESH_MAX, (resizes, shards)
    assert device is not None or launched["tenant_count[mesh]"] > 0, \
        launched
    log(f"[control] (b) mesh knob: fleet engine n={n} T={FLEET_TENANTS} at "
        f"S={CONTROL_MESH_SHARDS} -> {shards} ({len(resizes)} mesh_resize "
        f"{json.dumps([(e['from_width'], e['to_width']) for e in resizes])})"
        f", {n / wall:.0f} events/s, {launched['tenant_count[mesh]']} "
        f"worker-axis launches of kernel 7; every tenant's wins2 equal to "
        f"the single-device fleet's")
    return dict(events_per_s=n / wall, shards=shards,
                resizes=[(e["from_width"], e["to_width"]) for e in resizes],
                knob=state["knobs"]["mesh"], launches=launched)


def cli_process(args, device=None):
    """A ``python -m tuplewise_tpu_torch.harness.cli`` process, started
    (its start on the card overlaps this process's work)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    extra = ["--device", device] if device else []
    return subprocess.Popen(
        [sys.executable, "-m", "tuplewise_tpu_torch.harness.cli"] + args
        + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env), time.perf_counter()


def cli_finish(proc, timeout=300):
    """(return code, the last stdout line as JSON or None, seconds from
    start) of a cli_process."""
    p, t = proc
    out, err = p.communicate(timeout=timeout)
    lines = out.strip().splitlines()
    last = json.loads(lines[-1]) if lines else None
    if p.returncode not in (0, -9):
        log(f"[control] CLI process failed: {err[-2000:]}")
    return p.returncode, last, time.perf_counter() - t


def cli_main(args, device=None):
    """(return code, last stdout line as JSON) of the CLI in-process."""
    import contextlib
    import io

    from tuplewise_tpu_torch.harness.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(args + (["--device", device] if device else []))
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_control(device=None):
    """Phase 28: the control plane and the CLI. (a) and (b) in this
    process; (c) the CLI: the killed train and the replay whose artifacts
    the doctor reads are processes started after (a) (their start on the
    card overlaps (b), not (a)'s measured replays), the resumed train one
    started once the killed one is dead, the rest in-process through
    main([...])."""
    out = {"part_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        def part(name, fn):
            t = time.perf_counter()
            sub = os.path.join(tmp, name)
            os.makedirs(sub)
            out[name] = fn(sub, device)
            out["part_s"][name] = time.perf_counter() - t

        part("a", control_fleet)
        ck = os.path.join(tmp, "train.npz")
        train = ["train", "--steps", "8"]
        killed = cli_process(train + [
            "--checkpoint", ck, "--checkpoint-every", "2",
            "--chaos-spec", KILL_AT_2ND_CHECKPOINT], device)
        rdir = os.path.join(tmp, "replay")
        os.makedirs(rdir)
        replayed = cli_process([
            "replay", "--tenants", str(CONTROL_REPLAY_TENANTS),
            "--n-events", str(CONTROL_REPLAY_EVENTS), "--count-kernel",
            "--policy", "block", "--queue-size", "64", "--flush-timeout-ms",
            "0.5", "--tenant-quota", "4096", "--flight-recorder-size",
            str(1 << 17), "--slo-spec", json.dumps(CONTROL_SLO),
            "--controller-spec", json.dumps(CONTROL_SPEC),
            "--metrics-out", os.path.join(rdir, "metrics.jsonl"),
            "--metrics-every", "0.25",
            "--flight-out", os.path.join(rdir, "flight.jsonl")], device)
        try:
            part("b", control_mesh)
            t = time.perf_counter()
            rc, last, killed_s = cli_finish(killed)
            assert rc == -9 and last is None and os.path.exists(ck), rc
            resumed = cli_process(train + [
                "--checkpoint", ck, "--checkpoint-every", "2", "--resume"],
                device)
            cli = {"killed_s": killed_s}
            before = count_launches(CONTROL_KEYS)
            n = str(CONTROL_VARIANCE_N)
            _, var = cli_main(["variance", "--scheme", "complete", "--n-pos",
                               n, "--n-neg", n, "--n-reps", "4"], device)
            cli["variance"] = launched_since(before, keys=CONTROL_KEYS)
            assert device is not None or cli["variance"][
                "pair_sum[auc]"] > 0, cli
            before = count_launches(CONTROL_KEYS)
            _, trip = cli_main(["triplet", "--n", str(CONTROL_TRIPLET_N),
                                "--n-pairs", "0"], device)
            cli["triplet"] = launched_since(before, keys=CONTROL_KEYS)
            key = "batched_masked_pair_sum[triplet_indicator]"
            assert device is not None or cli["triplet"][key] > 0, cli
            before = count_launches(CONTROL_KEYS)
            _, straight = cli_main(list(train), device)
            cli["train"] = launched_since(before, keys=CONTROL_KEYS)
            assert device is not None or cli["train"][
                "pair_loss_grad[hinge]"] > 0, cli
            rc, res, cli["resumed_s"] = cli_finish(resumed)
            assert rc == 0 and res["recovery"]["resumed_from"] > 0, res
            assert res["params_sha256"] == straight["params_sha256"]
            rc, rec, cli["replay_s"] = cli_finish(replayed)
            assert rc == 0, rc
            drc, verdict = cli_main(["doctor", "--dir", rdir, "--quiet"],
                                    device)
            assert verdict["actuations_attributed"] == verdict[
                "actuations"], verdict
            assert "unattributed_actuation" not in (verdict["detail"] or "")
            out["part_s"]["c"] = time.perf_counter() - t
        finally:
            for p, _ in (killed, replayed):
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    out["c"] = dict(
        cli, variance_mean=var["mean"], variance_auc_pop=var.get(
            "population_value"), triplet_mean=trip["mean"],
        params_sha256=straight["params_sha256"],
        resumed_from=res["recovery"]["resumed_from"],
        replay_events_per_s=rec["events_per_s"],
        replay_actuations=rec["controller"]["actuations_total"],
        doctor=verdict, doctor_rc=drc)
    log(f"[control] (c) CLI: variance complete at n={CONTROL_VARIANCE_N} "
        f"a class mean "
        f"{var['mean']:.6f}; triplet n={CONTROL_TRIPLET_N} complete mean "
        f"{trip['mean']:.6f}; train killed after its 2nd checkpoint "
        f"(reaped {cli['killed_s']:.1f} s after its start), resumed from "
        f"step "
        f"{res['recovery']['resumed_from']} ({cli['resumed_s']:.1f} s): "
        f"params_sha256 equal to the straight run's; replay of "
        f"{CONTROL_REPLAY_TENANTS} tenants ({cli['replay_s']:.1f} s, "
        f"{rec['events_per_s']:.0f} events/s, "
        f"{rec['controller']['actuations_total']} actuations); doctor "
        f"{json.dumps(verdict)} (exit {drc}); seconds by part "
        f"{json.dumps({k: round(v, 1) for k, v in out['part_s'].items()})}")
    return out


def check_control_launches():
    """Phase 28's launches (read after it, the counters set to 0 before
    it): every kernel of CONTROL_KEYS must have launched."""
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    launches = dict(pk.LAUNCHES)
    log(f"[launches] control plane and CLI path {json.dumps(launches)}")
    for key in CONTROL_KEYS:
        assert launches.get(key, 0) > 0, f"{key} never launched"
    return launches


def phase_recovery(device=None):
    """Phase 27: crash-safe serving and its observability on the card.
    Returns the record, with the count kernels' launches of the
    recovered engines (their restores, tails and batches after) and of
    the uninterrupted references apart."""
    out = {"part_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        def part(name, fn, *args):
            t = time.perf_counter()
            sub = os.path.join(tmp, name)
            os.makedirs(sub)
            out[name] = fn(sub, *args, device)
            out["part_s"][name] = time.perf_counter() - t

        part("a", recovery_index_crash)
        # (d)'s child reaches the card while (b) and (c) run
        child, kw = start_serving_child(tmp, device)
        try:
            part("b", recovery_mesh_crash)
            part("c", recovery_fleet_crash)
            part("d", recovery_sigkill, child, kw)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
        part("e", recovery_traced_replay)
    recovered = dict.fromkeys(RECOVERY_KEYS, 0)
    reference = dict.fromkeys(RECOVERY_KEYS, 0)
    for p in "abcd":
        for step, counts in out[p]["launches"].items():
            into = (recovered if step in ("recovery", "after") else
                    reference if step == "reference" else None)
            for k in RECOVERY_KEYS if into is not None else ():
                into[k] += counts[k]
    out["launches_recovered"], out["launches_reference"] = (recovered,
                                                            reference)
    log(f"[recovery] launches of the recovered engines (restores, tails "
        f"and the batches after) {json.dumps(recovered)}; of the "
        f"uninterrupted references {json.dumps(reference)}; seconds by "
        f"part {json.dumps({k: round(v, 1) for k, v in out['part_s'].items()})}")
    return out


def main(argv=()):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    missing = [p for p in SOURCES.values()
               if not os.path.exists(os.path.join(ROOT, p))]
    if missing:
        print("chip_smoke: run it from a checkout of the repository "
              f"({', '.join(sorted(set(missing)))} missing)", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    if list(argv) == ["--phase27"]:
        # phase 27 alone, after the build: its record as one JSON line
        log(f"[card] {card_line()}")
        phase_build()
        t = time.perf_counter()
        out = phase_recovery()
        log(f"[phase] 27 recovery and tracing: {time.perf_counter() - t:.1f} s")
        print(json.dumps(out), flush=True)
        return 0
    if list(argv) == ["--phase28"]:
        # phase 28 alone, after the build: its record as one JSON line
        from tuplewise_tpu_torch.ops import pair_kernels as pk

        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        log(f"[card] {card_line()}")
        phase_build()
        pk.reset_launch_counts()
        t = time.perf_counter()
        out = phase_control()
        log(f"[phase] 28 control plane and CLI: "
            f"{time.perf_counter() - t:.1f} s")
        out["launches_control"] = check_control_launches()
        print(json.dumps(out), flush=True)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {list(argv)} (none, "
              "--phase27 or --phase28)", file=sys.stderr)
        return 2
    from tuplewise_tpu_torch.ops import pair_kernels as pk

    # before the first CUDA call: reproducible cuBLAS for phase 8
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"CUBLAS_WORKSPACE_CONFIG={os.environ['CUBLAS_WORKSPACE_CONFIG']}, "
        f"TF32 off")
    seconds = {}

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        log(f"[phase] {label}: {seconds[label]:.1f} s")
        return out

    sass = timed("1 build", phase_build)
    errs = {}
    timed("2 kernel vs plain", phase_kernel_vs_plain, errs)

    pk.reset_launch_counts()
    by_phase = {}
    i1, i2 = timed("3 main path", phase_main_path, by_phase)
    timed("4 harness", phase_harness, by_phase)
    launches = dict(pk.LAUNCHES)
    log(f"[launches] estimator path {json.dumps(launches)}; by phase "
        f"{json.dumps(by_phase)}")
    for label, delta in by_phase.items():
        assert sum(delta.values()) > 0, f"no kernel launched in {label}"
    for wrapper in ("pair_sum", "masked_pair_sum"):
        for name in NAMES:
            key = f"{wrapper}[{name}]"
            assert launches.get(key, 0) > 0, f"{key} never launched"

    rows = timed("5 timing", phase_timing, errs, launches, i1, i2, sass)
    grad_rows = timed("6 grad vs plain", phase_grad_vs_plain, sass)
    data = train_data()

    pk.reset_launch_counts()
    train_rows = timed("7 training", phase_train, data)
    train_launches = dict(pk.LAUNCHES)
    log(f"[launches] trainer path {json.dumps(train_launches)}")
    for wrapper in ("pair_loss_grad", "pair_grad_sums"):
        for name in GRAD_NAMES:
            key = f"{wrapper}[{name}]"
            assert train_launches.get(key, 0) > 0, f"{key} never launched"
    for r in grad_rows:
        r["launches"] = train_launches[r["name"]]
    rows += grad_rows

    timed("8 resume", phase_resume)
    timed("9 plain trajectory", phase_plain_trajectory)
    sim_wall = timed("10 sim learner", phase_sim_learner)

    timed("11 triplet vs plain", phase_triplet_vs_plain, errs)
    pk.reset_launch_counts()
    X3, Y3, triplet_main = timed("12 triplet main path", phase_triplet_main)
    triplet_launches = dict(pk.LAUNCHES)
    log(f"[launches] degree-3 estimator path {json.dumps(triplet_launches)}")
    for name in TRIPLET_NAMES:
        key = f"batched_masked_pair_sum[{name}]"
        assert triplet_launches.get(key, 0) > 0, f"{key} never launched"
    triplet_rows = timed("12b triplet exact", phase_triplet_exact, X3, Y3,
                         errs, triplet_launches, triplet_main)
    del X3, Y3
    config4 = timed("13 config 4", phase_config4)
    pk.reset_launch_counts()
    learner = timed("14 triplet learner", phase_triplet_learner)
    learner_launches = dict(pk.LAUNCHES)
    log(f"[launches] triplet learner path {json.dumps(learner_launches)}")
    key = "batched_masked_pair_sum[triplet_indicator]"
    assert learner_launches.get(key, 0) > 0, f"{key} never launched"
    for r in triplet_rows:
        r["launches_learner"] = learner_launches.get(r["name"], 0)
    rows += triplet_rows
    timed("15 triplet resume", phase_triplet_resume)

    count_row = timed("16 count kernel vs plain", phase_count_vs_plain)
    key = "signed_count[flat]"
    pk.reset_launch_counts()
    index, probe = timed("17 index main path", phase_index)
    index_launches = dict(pk.LAUNCHES)
    log(f"[launches] serving index path {json.dumps(index_launches)}")
    assert index_launches.get(key, 0) > 0, f"{key} never launched"
    pk.reset_launch_counts()
    engine = timed("18 engine replay", phase_engine)
    engine_launches = dict(pk.LAUNCHES)
    log(f"[launches] serving engine path {json.dumps(engine_launches)}")
    assert engine_launches.get(key, 0) > 0, f"{key} never launched"
    time_index_kernel(probe, index)
    del probe
    count_row["launches"] = index_launches[key]
    count_row["launches_engine"] = engine_launches[key]
    rows.append(count_row)
    streaming = timed("19 streaming estimator", phase_streaming_estimator)

    tenant_row = timed("20 tenant count vs plain", phase_tenant_count_vs_plain)
    key = "tenant_count"
    fleet_out, fleet_launches = [], []
    for label, fn in (("21 fleet main path", phase_fleet),
                      ("21b fleet incremental", phase_fleet_incremental),
                      ("22 fleet engine replay", phase_fleet_engine)):
        pk.reset_launch_counts()
        fleet_out.append(timed(label, fn))
        fleet_launches.append(dict(pk.LAUNCHES))
        log(f"[launches] {label} {json.dumps(fleet_launches[-1])}")
        assert fleet_launches[-1].get(key, 0) > 0, f"{key} never launched"
    fleet, fleet_incr, fleet_engine = fleet_out
    tenant_row["launches"] = fleet_launches[0][key]
    tenant_row["launches_engine"] = fleet_launches[2][key]
    rows.append(tenant_row)

    pk.reset_launch_counts()
    designs = timed("23 designs", phase_designs, data, triplet_main)
    design_launches = dict(pk.LAUNCHES)
    log(f"[launches] designs path {json.dumps(design_launches)}")
    for key in ("pair_sum[auc]", "pair_sum[logistic]",
                "batched_masked_pair_sum[triplet_indicator]"):
        assert design_launches.get(key, 0) > 0, f"{key} never launched"
    for r in rows:
        r["launches_designs"] = design_launches.get(r["name"], 0)

    pk.reset_launch_counts()
    mesh, mesh_launches = timed("24 mesh ring", phase_mesh)
    log(f"[launches] mesh path {json.dumps(mesh_launches)}")
    for key in ("pair_sum[auc]", "pair_sum[hinge]", "pair_sum[logistic]",
                "masked_pair_sum[auc]", "masked_pair_sum[hinge]",
                "batched_masked_pair_sum[triplet_indicator]",
                "batched_masked_pair_sum[triplet_hinge]"):
        assert mesh_launches.get(key, 0) > 0, f"{key} never launched"
    for r in rows:
        r["launches_mesh"] = mesh_launches.get(r["name"], 0)

    pk.reset_launch_counts()
    elastic, elastic_launches = timed("25 elastic mesh", phase_elastic, data)
    log(f"[launches] elastic mesh path {json.dumps(elastic_launches)}")
    for key in ("pair_sum[auc]", "masked_pair_sum[auc]",
                "pair_loss_grad[hinge]", "pair_loss_grad[logistic]",
                "pair_grad_sums[hinge]", "pair_grad_sums[logistic]",
                "batched_masked_pair_sum[triplet_indicator]"):
        assert elastic_launches.get(key, 0) > 0, f"{key} never launched"
    for r in rows:
        r["launches_elastic"] = elastic_launches.get(r["name"], 0)

    pk.reset_launch_counts()
    mesh_serving, ms_launches, ms_rows = timed(
        "26 mesh serving", phase_mesh_serving)
    log(f"[launches] mesh serving path {json.dumps(ms_launches)}")
    for key in ("signed_count[mesh]", "tenant_count[mesh]",
                "signed_count[flat]", "tenant_count"):
        assert ms_launches.get(key, 0) > 0, f"{key} never launched"
    for r in rows:
        r["launches_mesh_serving"] = ms_launches.get(r["name"], 0)
    rows += ms_rows

    pk.reset_launch_counts()
    recovery = timed("27 recovery and tracing", phase_recovery)
    rec_launches = recovery["launches_recovered"]
    log(f"[launches] recovery phase {json.dumps(dict(pk.LAUNCHES))}; the "
        f"recovered engines' {json.dumps(rec_launches)}")
    for key in RECOVERY_KEYS:
        assert rec_launches[key] > 0, f"{key} never launched on recovery"
    for r in rows:
        r["launches_recovery"] = rec_launches.get(r["name"], 0)

    pk.reset_launch_counts()
    control = timed("28 control plane and CLI", phase_control)
    control_launches = check_control_launches()
    for r in rows:
        r["launches_control"] = control_launches.get(r["name"], 0)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows, "train": train_rows,
                      "sim_learner_cell_s": sim_wall,
                      "triplet": triplet_main, "config4": config4,
                      "triplet_learner": learner, "designs": designs,
                      "mesh": mesh, "elastic": elastic,
                      "mesh_serving": mesh_serving, "recovery": recovery,
                      "control": control,
                      "serving": {"index": index, "engine": engine,
                                  "streaming_estimator": streaming,
                                  "fleet": fleet,
                                  "fleet_incremental": fleet_incr,
                                  "fleet_engine": fleet_engine},
                      "phase_s": seconds, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
