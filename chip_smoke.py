#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with an NVIDIA Hopper GPU and the CUDA toolkit. Exits 0 only if every
phase passed; any failure exits nonzero. Phases:

1. header — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build — compiles every kernel of ``src/repro_torch/kernels/csrc`` with
   nvcc, all at once (seconds, and what ``-Xptxas -v`` reports for each);
3. kernels — each kernel against its plain PyTorch version on the card,
   at small edge-case shapes and then at the shapes its path gives it
   (kNN tables, distances and predictions bit-equal, ρ within
   ``RHO_ATOL``), with CUDA-event times of both, of one PyTorch library
   call where one computes the same function, the kernel's device time
   from the profiler (``device_ms``: the event loop of a small kernel
   measures the host's launch cost), and the least time the card could
   take. ``pairwise_distances`` also carries the card's write floor,
   ``D.fill_(1.0)`` on its (Lp, Lp) matrix, beside its own device time in
   three L2 states (``floor_device_ms``; ``warm_…``, ``cold_…``: one
   output block rewritten, and after a 128 MB scratch write), and its
   L = 10,000, E = 20 launch (``path_device_ms``, bit-equal there);
   ``lookup`` the launch floor ``out.zero_()`` (``floor_device_ms``) and
   ``embedding_bag`` as its library call. The rows of ``knn_multi_e`` and
   ``smap_gram`` also carry the
   CUDA-event time of one launch beside the profiler's; ``knn_multi_e``,
   ``knn_batch`` and ``knn_append`` are each held at both designs' edge
   shapes (the new one, and the insertion kernel each keeps for k > 32),
   the two designs bit-equal to each other at the path's shapes (the
   insertion kernel, the previous design, timed there too: ``insert_ms``,
   ``insert_device_ms``; the two top-k kernels likewise); ``knn_multi_e``
   is timed at one series (each of
   ``cache=False`` ``optimal_E``'s launches); ``knn_batch``, ``lookup_rho``,
   ``topk_select`` and ``knn_fused`` carry ``path_device_ms`` and
   ``path_bound_ms``, per launch at the shapes their paths launch them (the
   direct xmap's batch of B libraries, ``optimal_E``'s own-target launches
   at E = 1..E_max, the variants path's series: ``topk_select`` at its
   L = 10,000, k = 21 launch beside the row's Lp = 1598 one);
   ``lookup_rho`` also at both xmaps' launches
   (the master route's E-groups, the direct route's batch of B = 26:
   ``xmap_master_device_ms``, ``xmap_direct_device_ms``), each against its
   plain version, and bit-equal at B = 26 to the B = 154 launch's rows;
   ``knn_fused`` is held at its small shapes on both designs (and the
   selection kernel at a small tile), its kept insertion kernel timed at
   L = 10,000 (``insert_device_ms``), and it runs once at L = 65,536, past
   the length its first design refused, with 256 sampled rows bit-equal
   to the plain strict chain of those rows and its extra device memory
   (``huge_extra_bytes``); ``knn_append`` is also held on a panel whose
   new column ties a stored neighbour's root but not its value;
   ``smap_gram``'s bound is that of its three TF32 tensor-core products
   (the float32 figure beside it), its row carries the θ-sweep shape's
   times beside the xmap's, an earlier line the device µs of each of its
   five kernels at both shapes, and it is held bit-equal when a batch is
   cut into slices of libraries and one library into slices of rows;
4. main path — ``EDM(panel).optimal_E()`` then ``.xmap()``, and
   ``EDM(panel, E=3).xmap()``, on Fish1_Normo's published shape (154
   series × 1600 steps, E_max = 20), with every kernel's launch count read
   from that run; each call then timed as the median of ``RUNS`` runs;
   then the same calls with ``impl="ref"`` (the plain versions on the
   card): E_opt equal, ρ within ``RHO_ATOL``;
5. slice path — on the same session, the 8 strongest links by the CCM
   asymmetry ρ − ρᵀ, each through ``ccm(lib_sizes=...)`` (the convergence
   engine), ``ccm()`` (the full library, master-derived) and
   ``surrogate_test`` (100 shuffled nulls); then
   ``EDM(panel, E=3, cache=False).simplex()`` and
   ``EDM(panel, cache=False).optimal_E()``; launch counts per call,
   medians of ``RUNS`` runs, peak memory; then the same calls with
   ``impl="ref"``: ρ and null ρ within ``RHO_ATOL``, p-values equal
   except where a null lies within ``P_MARGIN`` of the real ρ, E_opt
   equal. Each call of both paths also runs once under ``torch.profiler``
   for its device busy time, idle share and per-kernel device times;
6. S-Map path — on the main path's session (E_opt cached),
   ``sess.smap()`` (the 8-θ sweep per series, grouped by E_opt),
   ``sess.xmap(method="smap", theta=1.0)`` (per-target E) and
   ``EDM(panel, E=3).xmap(method="smap")``; launches, peak memory,
   medians of ``RUNS`` runs, device busy time and idle share per call;
   the engine's solve timed against ``torch.cholesky_solve``; then the
   same calls with ``impl="ref"``: ρ within ``smap_rho_tol(θ)``, and the
   pair where they differ most against a float64 solve.
   The ``smap_gram`` kernel is held against its plain version beside the
   other kernels in phase 3, G and M within ``GRAM_RTOL`` of Σ|terms|;
   so are ``knn_append`` (bit-equal to its plain version and to a cold
   ``knn_multi_e`` build: edge shapes, an unordered master, the append
   path's shapes), ``pairwise_distances_mxu`` (within
   ``pairwise_dist.MXU_RTOL`` of ‖zᵢ‖² + ‖zⱼ‖²) and ``knn_fused``
   (bit-equal to its plain version and to the pairwise + top-k kernels);
7. append path — ``EDM(panel[:, :1536]).optimal_E()`` builds the master;
   then, on a fresh session holding that master each time,
   ``sess.append(next Δt columns)`` for Δt = 1, 16 and 64: the grown
   master bit-equal to a cold session's on the grown panel, E_opt and ρ
   of the following ``optimal_E()`` equal to the cold session's, one
   ``xmap()``; medians of ``RUNS`` appends beside the cold master build,
   launches, device busy time and idle share, the append's peak device
   memory above what was held before it;
8. kNN variants path — ``core.all_knn(x, E=E, variant="mxu")`` and
   ``ops.all_knn(x, E=E, fused=True)`` over the 154 series for E = 3 and
   20 and over one series at L = 10,000 (E = 20): fused bit-equal to the
   two-kernel path, mxu's neighbour sets equal vpu's away from near-ties,
   and at L = 10,000 the fused call's device memory holds no (Lp, Lp)
   buffer (the two-kernel call's is shown beside it);
9. journal path — ``xmap(run_dir=...)`` under temporary run dirs:
   ``EDM(panel).optimal_E()`` then the journaled xmap (master route),
   ``EDM(panel, E=3)``'s (direct route) and its ``method="smap"`` xmap,
   each bit-equal to the plain call, a finished journal launching nothing,
   ``report.json`` complete, ``events.jsonl`` through
   ``repro_torch.telemetry.schema``, ``inspect_run`` at 100 %; a child
   process at ``batch_libs=26`` SIGTERM'd at its second launch (exit 17,
   journal "preempted"), a second child resuming at ``batch_libs=40``
   with launches for the remaining rows only, bit-identical; a child
   whose allocator cap (``set_per_process_memory_fraction``) the S-Map
   xmap's first batch cannot fit — its ``torch.cuda.OutOfMemoryError``
   halves B (a ``halve`` entry, no ``unclassified``), bit-identical;
   ``core.ccm_group`` and ``plan.ccm_group_from_master`` on 8 libraries
   bit-equal to the batched engines; journaled against plain wall times
   (``RUNS`` turns each), each route's ratio beside the reference's
   5 % bound, the snapshots each run writes and the host time of the
   journal's parts; then the reference bench's own row
   (``bench_resume_row``: ``EDMConfig(E=3, cache=False)`` on
   ``tent_map_panel(154, 1600, seed=7)``, best of 3), reported beside
   the 5 % bound;
10. serving path — ``repro_torch.serving.EDMServer(workers=4)`` on the
   panel (E_max = 20, cached): 8 client threads ask 64 distinct ``ccm``
   pairs at their E_opt, each answer bit-equal to a direct session's
   ``ccm_batch([(l, t)], E=)``; appends of Δt = 1 and 16, each followed
   by queries bit-equal to a cold session on the grown panel and by one
   subscription's tick; a second panel under a master budget of 1.5
   masters evicts the first (the bytes freed confirmed by
   ``torch.cuda.memory_allocated``), whose lazy rebuild answers the same
   bits; ``serve_http`` on loopback (``GET /healthz``, ``POST`` ccm and
   append); a durable child server SIGKILL'd between append ticks and
   recovered with ``EDMServer.recover``, bit-equal to a never-crashed
   session. Requests/s, p50 and p99 latency, coalesced batch sizes, the
   ticks' ms, eviction and rebuild ms, recovery s (the child's start and
   kernel load not in it), the query stream's device busy time and idle
   share, and the path's launches (exact: one panel drains at a time).
11. sharded path — ``EDMConfig(mesh=...)`` on ``torch.distributed``, at
   the same shape. (a) A world of one: ``make_ccm_mesh((1, 1), ("data",
   "model"))`` starts NCCL itself; ``EDM(panel, mesh=mesh)``'s
   ``optimal_E()``, ``xmap()``, ``xmap(method="smap")``, ``smap()``,
   ``EDM(panel, E=3, mesh=mesh).xmap()``, ``sharded_ccm_convergence(X[:8],
   X, E=3, lib_sizes=...)``, a journaled mesh ``xmap(run_dir=)`` and the
   per-series engines ``sharded_optimal_E`` / ``sharded_smap_theta`` on
   axes ("data",): launches per kernel from that run, E_opt equal and every
   result bit-equal (or within ``RHO_ATOL`` / ``smap_rho_tol``, saying
   which) to a ``cache=False`` local session and to ``core``'s engines, the
   journaled run bit-equal to the plain one; medians of ``RUNS`` runs,
   device busy time and idle share per call. (b) Four ranks on the one
   card (``SHARDED_CHILD``: gloo on a ``FileStore``, every rank on
   ``cuda:0``, loading the kernels the parent built): mesh (2, 2) runs the
   session's ``xmap()`` of both methods and a journaled ``xmap(run_dir=)``,
   mesh (4,) over ("data",) ``sharded_optimal_E`` and
   ``sharded_smap_theta`` on the panel zero-padded to 156 rows; every
   rank's results against (a)'s, rank 0's wall seconds and the launches
   summed over the ranks. It checks code paths, not scaling: four ranks
   share one card. The process groups end before the last line.
12. LM serving path — the LM substrate (``repro_torch.models``,
   ``repro_torch.serving.ServeEngine``) in plain eager PyTorch, which
   launches none of the EDM kernels (their counts are read: 0 each).
   (a) llama3-8b as configured (32 layers, d_model 4,096, vocab 128,256,
   bf16 over float32 parameters, random weights from a seeded generator
   on the card): ``init_params`` seconds and peak memory;
   ``ServeEngine(s_max=128).generate`` of 4 prompts of 3–9 tokens (numpy
   seed 0), 32 new tokens, greedy, twice with identical tokens; tokens/s,
   the decode step's median ms beside its bytes bound (parameters + KV
   cache at 3.35 TB/s) and the bytes it moves as written, device busy
   time and idle share of a ``generate``, peak memory; the decode path's
   logits at every position of a prompt against ``forward_train``'s, and
   a 2,048-token prefill (the chunked path) against the full S×S path,
   both within ``LM_BF16_ATOL``. (b) The ten smoke archs: weights made on
   the CPU and loaded onto the card; ``forward_train`` logits, MoE aux,
   ``loss_fn`` and ``decode_step`` logits within ``LM_SMOKE_TOL`` of the
   CPU port's (TF32 off), gradients finite and non-zero after
   ``backward()`` on the card; for llama3-8b, deepseek-v2-lite-16b,
   jamba-v0.1-52b and xlstm-125m greedy decode of 8 tokens equal to the
   parallel forward's argmax (dropless MoE).
13. LM training path — the LM substrate's training half
   (``repro_torch.optim``, ``repro_torch.training``,
   ``repro_torch.data.pipeline``, ``repro_torch.distributed.compression``,
   ``repro_torch.launch.train``) in plain eager PyTorch, none of the EDM
   kernels (their counts read: 0 each, ``train_launches``). (a) qwen1.5-4b
   as configured (40 layers, d_model 2,560, vocab 151,936, bf16 over
   float32 parameters, random weights from a generator seeded 0 on the
   card; no cut): ``make_train_step`` with ``adamw8bit``, 4 steps of
   ``TokenPipeline(vocab, batch 1, seq_len 4,096, seed 0)`` in one
   microbatch (train_4k's sequence; its global batch of 256 cut to 1), the
   last step under the profiler (busy time, idle share):
   parameter and optimizer-state bytes beside the reckoning (the
   reference's stacked eligibility rule, checked leaf by leaf: int8 codes
   of the parameter's shape, float32 scales), each step's metrics beside
   ln V, CUDA-event ms, tokens/s, the step's FLOP and bytes bound, peak
   memory; sampled rows of ``embed.table``, ``units.20.l0.mlp.w_up.w``,
   ``units.20.l0.mix.wq.b`` and ``final_norm.g`` after step 3 against a
   float64 recomputation of the reference's update from that step's
   gradient (codes ±1); then float32 ``adamw`` on a fresh state, 3 steps
   at B = 1, S = 2,048 (1,024 if the reckoned peak passed 76 GB) and one
   more under the profiler (busy time, idle share). (b) The ten smoke
   archs' train step on the card against the CPU port from one state
   made on the CPU (float32, TF32 off), and on llama3-8b the widened
   8-bit config, the int8 wire and two microbatches (also against one
   batch on the card), at the CPU tests' tolerances. (c) ``train()`` on
   the reference loop tests' tiny config: learning over 40 steps, 20 + 10
   steps against 30 within rtol 1e-5, atol 1e-6, a child SIGTERM'd after
   its fourth batch exiting 0 with step 4 saved, and ``python -m
   repro_torch.launch.train --arch llama3-8b --steps 10 --device cuda``.
14. LM mesh path — the LM substrate on ``torch.distributed`` meshes
   (``repro_torch.launch.mesh``, ``.launch.sharding``, ``models.meshctx``,
   ``carry.place_params``), plain eager PyTorch, none of the EDM kernels
   (``mesh_launches`` 0 each). For llama3-8b and deepseek-v2-lite-16b as
   configured (random weights from a generator seeded 0 on the card): the
   plain ``ServeEngine`` (4 prompts of 3–9 tokens, 32 new tokens, s_max
   128) and its sequences replayed for every step's logits. (a) llama3-8b
   on a world of one, NCCL, mesh (1, 1), sequence-parallel decode on. (b)
   llama3-8b and (c) deepseek-v2-lite-16b (its 64 experts over "model",
   16 a rank) on ``MESH_RANKS`` gloo ranks on the card (``MESH_CHILD``),
   mesh (1, 4), each rank drawing its blocks leaf by leaf and generating
   ``MESH_RANK_NEW`` tokens. Each held to the plain run's logits by
   teacher forcing over its whole sequences, within ``LM_BF16_ATOL``
   (deepseek-v2-lite with float32 activations, ``MESH_F32``: within
   ``MESH_F32_ATOL`` wherever every routing so far agreed, the flipped
   routings counted), greedy tokens' first divergence reported; decode ms a step (CUDA
   events) and one step's collectives by kind on each rank, peak memory a
   rank. (d) unit 0 and the final norm of the world of one's llama3-8b,
   saved, restored by every rank onto (1, 4) (``restore(shardings=)``),
   bit-equal to its drawn blocks. The four ranks check code paths and
   collectives, not scaling: they share one card.
15. LM train step on a mesh — ``make_train_step`` under
   ``meshctx.use_mesh`` (the placed train state, the differentiable
   collectives, the vocab-parallel loss, the placed 8-bit AdamW), none of
   the EDM kernels (``mesh_train_launches`` 0 each). qwen1.5-4b as
   configured (random weights from a generator seeded 0 on the card),
   ``adamw8bit``, ``MESH_TRAIN_STEPS`` steps of one batch
   (``TokenPipeline(vocab, 2, 2,048, seed 0)``, one microbatch): the
   no-mesh step first (its metrics and sampled rows kept, its state
   freed); (a) a world of one on NCCL, mesh (1, 1), held to it at phase
   13's float32 bounds (``WORLD_OF_ONE_BOUNDS``); (b) four gloo ranks on
   the card (``MESH_TRAIN_CHILD``), mesh (2, 2), one row a dp group, each
   rank drawing its blocks leaf by leaf, held to (a) within
   ``MESH_TRAIN_BOUNDS`` (bf16 over another summation order). Per run:
   CUDA-event ms a step (per rank), collectives a step by kind (the remat
   recompute's included) and the host's ms inside them, local and peak
   bytes a rank, the step's FLOP bound; the phase's seconds. S is cut to
   1,024 (and printed) if the four ranks' reckoned bytes pass
   ``MESH_TRAIN_CAP``.
16. dry run — the compile-analysis tools (``repro_torch.launch.dryrun``,
   ``.roofline``) on fake process groups of 256 and 512 ranks (meta
   tensors placed as DTensors on "cuda" meshes; nothing is allocated on
   the card), in child processes. (a) Every cell of the models phases
   12-15 run (``DRYRUN_ARCHS``: train_4k, prefill_32k, decode_32k) and the
   EDM cell ``edm_ccm``/``ccm_subject6``, on both production meshes,
   through the probes, ``DRYRUN_WORKERS`` children at once; then
   ``roofline --probe --report``; per cell its status, FLOPs, bytes,
   collectives, temp GB, counting seconds, the dominant term and the
   roofline fraction (reckoned at H100 SXM rates); any cell not ``ok``
   fails. (b) The dry run of this smoke's own steps, beside the sweep: phase
   15's step on a fake (2, 2) world counts every rank's collectives a step
   exactly, phase 14's llama3 decode step on a fake (1, 4) world likewise;
   the reckoned peaks (arguments + peak live bytes) within
   ``DRYRUN_MEM_REL`` of phases 13 and 15's ``max_memory_allocated``;
   phase 13's FLOPs beside ``train_flops``, the roofline times of phases
   13 and 15 beside their ms a step. ``dryrun_launches`` 0 on every row.

The second line from the end is a JSON ``{"kernels": [...]}`` record, the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

N_SERIES, LENGTH, E_MAX, SEED = 154, 1600, 20, 0  # Fish1_Normo, Table 1
E_FIXED = 3           # the paper's fixed-E CCM benchmark setting
K_MASTER = E_MAX + 2  # session master: E_max + 1 + slack (Tp = 1)
LIB_SIZES = (50, 100, 200, 400, 800, 1200, 1500)  # convergence sweep
SURR_SIZES = (200, 800, 1500)
NUM_SURROGATES = 100
NUM_LINKS = 8
RUNS = 5              # timed runs per call, after one warm-up run
# ρ tolerance: the kernel takes two-pass moments of 32-row tiles and merges
# them in float64, the plain version a two-pass Pearson in another
# summation order in float32 over 1600 terms; they agree to a few float32
# ULPs of ρ ≤ 1.
RHO_ATOL = 1e-5
# A null ρ this close to the real ρ may fall on either side of it under the
# ρ tolerance, so its p-value may differ by one rank.
P_MARGIN = 2e-5
# Published H100 SXM peaks: HBM bytes/s, float32 (non-tensor-core) FLOP/s
# and dense TF32 tensor-core FLOP/s.
HBM_BPS, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
SMAP_THETA = 1.0      # the locality of xmap(method="smap") (EDMConfig.theta)
# S-Map G and M: float32 sums of ~1600 products, in the kernel's order and
# in cuBLAS's (TF32 off), each entry within GRAM_RTOL of Σ|terms|.
GRAM_RTOL = 1e-5
APPEND_L0 = 1536          # the append path binds this prefix of the panel
APPEND_DTS = (1, 16, 64)  # then appends this many points, each from it
VARIANT_ES = (3, 20)      # the kNN variants path: E (k = E + 1) ...
LONG_L = 10_000           # ... and one series at kEDM's scale (E = 20)
HUGE_L = 65_536           # the fused kNN past its old length ceiling ...
HUGE_ROWS = 256           # ... checked on this many sampled rows
JOURNAL_B = 26            # the preempted child's library batch ...
JOURNAL_RESUME_B = 40     # ... and its resume's (B-invariance on the card)
# The OOM child's memory cap: the bytes held before the S-Map xmap plus
# this share of the uncapped run's peak above them (its first B = N
# launch cannot be held; half of it can).
OOM_CAP_SHARE = 0.6
CCM_GROUP_LIBS = 8        # libraries of the per-series ccm_group check
CHILD_TIMEOUT_S = 300
# The reference bench's journal row (benchmarks/bench_ccm.py): a fixed-E
# direct xmap on tent_map_panel(154, 1600, seed=7), best of 3 with a fresh
# session a call, against a journaling bound of 5 %.
BENCH_SEED, BENCH_ITERS, RESUME_OVERHEAD_MAX = 7, 3, 0.05
SERVE_WORKERS = 4         # the serving path: the server's drain workers,
SERVE_CLIENTS = 8         # client threads,
SERVE_PAIRS = 64          # distinct ccm pairs asked at their E_opt,
SERVE_DTS = (1, 16)       # append ticks, each followed by
SERVE_TICK_PAIRS = 16     # this many of the pairs again,
SERVE_SUB_PAIRS = 4       # the watch list of one subscription,
SERVE_BUDGET = 1.5        # the master budget, in masters (two panels),
SERVE_KILL_TICKS = 6      # the durable child's Δt = 1 ticks (killed at 2)
LM_ARCH = "llama3-8b"      # the LM path at full width, as configured
LM_PROMPTS = 4            # prompts of 3–9 tokens (numpy seed 0, as the
LM_MAX_NEW = 32           # serve launcher), this many new tokens each,
LM_S_MAX = 128            # in caches of this length
LM_STEPS_TIMED = 40       # decode steps timed one by one
LM_PREFILL_S = 2048       # one prompt through the chunked prefill
LM_MATCH_TOKENS = 8       # greedy tokens held to the parallel forward
# The LM path in bfloat16 at 32 layers: the decode path (one row a step)
# and the parallel forward (all rows at once), and the chunked and the full
# prefill (float32 online softmax against probabilities cast to bf16 before
# the value product), round in different places; their logits (std ≈ 0.9,
# |max| ≈ 4 at init) may differ by this much.
LM_BF16_ATOL = 0.25
# The smoke archs, float32 with TF32 off: the card against the CPU port.
LM_SMOKE_TOL = 1e-4

TRAIN_ARCH = "qwen1.5-4b"   # the training path at full width, as configured
TRAIN_B, TRAIN_S = 1, 4096  # train_4k's sequence; its global batch 256 → 1
TRAIN_MICRO = 1             # one microbatch (phase 13 (b) checks several)
TRAIN_STEPS = 4             # adamw8bit steps (warmup 0, total 4)
TRAIN_F32_STEPS = 3         # then float32 adamw on a fresh state, B = 1,
TRAIN_F32_S = 2048          # S = 2048 (1024 when the reckoned peak > 76 GB)
TRAIN_MEM_CAP = 76e9        # the reckoning's ceiling for the float32 run
TRAIN_CHECK_STEP = 3        # the step whose sampled updates are recomputed,
                            # run under the profiler
TRAIN_CHECK_ROWS = 8        # rows of each checked leaf
BF16_FLOPS = 989e12
MESH_ARCHS = ("llama3-8b", "deepseek-v2-lite-16b")  # phase 14, full width
MESH_RANKS = 4              # gloo ranks on the one card, mesh (1, 4)
# deepseek-v2-lite's activations in float32 (its configured bf16 over the
# same float32 weights): in bf16 a few ulps of another summation order
# flip top-6 expert choices (0.65 in logits across paths at bf16), so the
# expert-parallel path is held in float32, where the paths differ only in
# rounding; logits within MESH_F32_ATOL wherever every routing so far
# agreed, and the routings that did not are counted.
MESH_F32 = ("deepseek-v2-lite-16b",)
MESH_F32_ATOL = 1e-3
MESH_MIN_AGREED = 0.5       # of the (row, step) pairs the check must cover
MESH_CHILD_TIMEOUT_S = 600
MESH_RANK_NEW = 8           # new tokens of the four ranks' own generate (the
                            # held replay covers all LM_MAX_NEW: ≈ 1.6 s a
                            # step there, four processes on one card)
# The checkpoint of phase 14 (d): these leaves of the world of one's
# llama3-8b, restored onto the four ranks' mesh.
MESH_CKPT_PREFIXES = ("units.0.", "final_norm.")

# Phase 15, the train step on a mesh: qwen1.5-4b as configured, adamw8bit,
# global batch MESH_TRAIN_B × MESH_TRAIN_S in one microbatch (one row a dp
# group on (2, 2)), MESH_TRAIN_STEPS steps of each run; the four ranks'
# mesh (2, 2) over ("data", "model"), every rank on cuda:0 (gloo).
MESH_TRAIN_ARCH = "qwen1.5-4b"
MESH_TRAIN_B, MESH_TRAIN_S = 2, 2048
MESH_TRAIN_STEPS = 2
MESH_TRAIN_SHAPE = (2, 2)
MESH_TRAIN_CAP = 70e9       # the four ranks' reckoned total; S 1,024 above
MESH_TRAIN_CHILD_TIMEOUT_S = 900
# Sampled rows of these leaves after the first step (vocab rows of both
# model blocks; the straddling MLP leaf; a bias and the final norm whole).
MESH_TRAIN_LEAVES = ("embed.table", "lm_head.table",
                     "units.20.l0.mlp.w_up.w", "units.20.l0.mix.wq.b",
                     "final_norm.g")
MESH_TRAIN_ROWS = 8
# (a) the world of one against the no-mesh step (the same bf16 ops; the
# loss takes the head on S − 1 positions and a sum over the global token
# count): phase 13's float32 bounds (TRAIN_SMOKE_RTOL's comment) on the
# metrics and the sampled blocks.
# (b) four ranks against (a): bf16 activations summed in another order
# (partial products over "model" rounded to bf16 before their sum, the
# vocab-parallel cross-entropy). Adam's first step moves an element by
# ≈ ±lr whatever |g| is, so a weight is off by at most 2·lr (+ the decay),
# and only where the gradient's sign differs; the moments are 0.1·g and
# 0.05·g², off by the gradients' bf16 noise (a gradient scaled by the
# wrong factor shows in them and in grad_norm, not in the weights). The
# bounds are about five times what the CPU proxy of this comparison shows
# at the card's shapes but the width (``tools/mesh_train_proxy.py``: 22
# layers, d_model 256, d_ff 768, vocab 1,024, bf16 over float32, S 2,048,
# the rows of ``mesh_train_rows``; in float32 the same comparison is
# within 1e-6: the differences are bf16 rounding): metrics ≤ 4.4e-5
# relative, weights more than 0.1·lr apart 0.69 %, codes more than one
# apart 5.2 % (a signed-sqrt code near zero moves by many), scales 4.7 %,
# decoded 8-bit moments 5.3 % of their block's scale, float32 moments
# 0.98 % of the leaf's largest.
MESH_TRAIN_BOUNDS = {
    "metric_rel": 5e-3,      # |Δ| / |(a)| of loss, ce, grad_norm, lr
    "weight_over_lr": 2.1,   # max |Δw| / lr
    "weight_moved_share": 5e-2,  # share of weights with |Δw| > 0.1·lr
    "code": 254,             # max |Δ code|: recorded, bounded below
    "code_share": 0.3,       # share of codes off by more than 1
    "scale_rel": 0.25,       # max relative Δ of the 8-bit scales
    "moment8_rel": 0.3,      # decoded 8-bit moments: max |Δ| / scale
    "moment_rel": 0.1,       # float32 moments: max |Δ| / the leaf's max
}

# The smoke archs' train step on the card against the CPU port (float32,
# TF32 off), one step from the same state, at the CPU tests' tolerances
# (tests/torch_train.py): metrics |Δ| ≤ 2e-5 (1 + |ref|); weights in two
# tiers, elements with a real gradient within 1e-3·lr (0.2·lr where a
# one-off rounding feeds the update: 8-bit moments, the int8 wire),
# elements whose gradient RMS is under 1e-3 of the model's largest within
# 2·lr (Adam's step is ±lr there whatever |g| is); float32 moments within
# 2e-4 of the leaf's largest |m| (floored at 1e-3 of the model's; 2e-2
# under the int8 wire, where a step's gradient may be one quantum, 1/127
# of its block's absmax, off); 8-bit codes ±1, scales 2e-4 relative;
# error buffers equal but where the wire rounded the other way (one
# element in a thousand at most).
TRAIN_SMOKE_RTOL = 2e-5
# The loop on the card: an unbroken 30-step run against 20 + 10, at the
# reference's own tolerance (tests/test_train_loop.py:57-58).
LOOP_RTOL, LOOP_ATOL = 1e-5, 1e-6

# Phase 16, the dry run (repro_torch.launch.dryrun, .roofline) on fake
# meshes of 256 and 512 ranks, in child processes (a fake process group
# cannot share a process with phase 15's world). The sweep: every cell of
# the models phases 12-15 run, and the EDM cell on the Subject6 shape, on
# both production meshes, a child an arch and mesh, DRYRUN_WORKERS at
# once (the others' cells, whose recurrent layers' loops over time steps
# take minutes to count, are the CLI's: PERF.md). The counts of phases 14
# and 15's own steps are held to theirs exactly; the reckoned peaks
# (arguments + the peak of live bytes) within DRYRUN_MEM_REL of phases 13
# and 15's max_memory_allocated.
DRYRUN_ARCHS = ("llama3-8b", "qwen1.5-4b", "deepseek-v2-lite-16b")
DRYRUN_EDM = ("ccm_subject6",)
DRYRUN_MESHES = ("single", "multi")
DRYRUN_WORKERS = 7           # children at once (the card's host: 8 cores)
DRYRUN_CHILD_TIMEOUT_S = 400
DRYRUN_MEM_REL = 0.2
DRYRUN_DEVICE = "cuda"      # the fake meshes' device type

# A child process of the training phase: the loop on the card, SIGTERM'd by
# the parent while it waits after its fourth batch.
TRAIN_CHILD = r"""
import dataclasses, sys
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.training import train
cfg = dataclasses.replace(get_config("llama3-8b", smoke=True), vocab_size=64)
tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                   weight_decay=0.01, seed=0)
pipe = TokenPipeline(vocab_size=64, batch=4, seq_len=32, seed=1)


class Waiting:
    def global_batch(self, step):
        print(f"BATCH {step}", flush=True)
        if step == 3:
            sys.stdin.readline()
        return pipe.global_batch(step)


_, hist = train(cfg, tcfg, Waiting(), workdir=sys.argv[1], num_steps=50,
                ckpt_every=100, verbose=True, device="cuda")
print(f"DONE {len(hist)}", flush=True)
"""

# A child process of the journal phase: ``kill`` runs the direct journaled
# xmap at B and delivers SIGTERM to itself at its second engine launch
# (tile 0 still in flight), as examples/resume_smoke.py does; ``resume``
# reruns it; ``oom`` caps the allocator below the S-Map xmap's first batch
# and runs it journaled. Prints its kernel launches and wall time.
JOURNAL_CHILD = r"""
import json, os, signal, sys, time
import numpy as np
import torch
from repro_torch.core import ccm
from repro_torch.data.timeseries import forced_network_panel
from repro_torch.edm import EDM
from repro_torch.kernels import knn_batch, lookup, smap_gram

mode, run_dir = sys.argv[1], sys.argv[2]
N, L, seed, E, B = (int(a) for a in sys.argv[3:8])
panel = forced_network_panel(N, L, seed=seed)[0]
wrappers = {"knn_batch": knn_batch.all_knn_batch,
            "lookup_rho": lookup.lookup_rho, "smap_gram": smap_gram.smap_gram}
out = {}
if mode == "oom":
    want = EDM(panel, E=E).xmap(method="smap")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    EDM(panel, E=E).xmap(method="smap")
    peak = torch.cuda.max_memory_allocated()
    cap = base + float(sys.argv[8]) * (peak - base)
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rho = EDM(panel, E=E).xmap(method="smap", run_dir=run_dir)
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, base_bytes=base,
               peak_bytes=peak, cap_bytes=cap, total_bytes=total,
               equal_uncapped=bool(np.array_equal(rho, want)))
    torch.cuda.set_per_process_memory_fraction(1.0)
else:
    orig = ccm._group_step
    n = {"launches": 0}
    def wrapped(*a, **k):
        n["launches"] += 1
        if mode == "kill" and n["launches"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **k)
    ccm._group_step = wrapped
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rho = EDM(panel, E=E, batch_libs=B).xmap(run_dir=run_dir)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
np.save(os.path.join(run_dir, mode + ".npy"), rho)
out["launches"] = {n: fn.launches for n, fn in wrappers.items()}
print(json.dumps({"journal_child": out}))
"""


# The serving path's durable child: registers the panel's first ``L``
# columns under ``state_dir`` on the card, builds its master, then appends
# the next columns one at a time, printing "ACK <version>" after each; the
# parent kills it with SIGKILL after the second.
SERVE_CHILD = r"""
import sys, time
from repro_torch.data.timeseries import forced_network_panel
from repro_torch.serving import EDMServer

state_dir = sys.argv[1]
N, L, seed, E_max, ticks = (int(a) for a in sys.argv[2:7])
full = forced_network_panel(N, L + ticks, seed=seed)[0]
srv = EDMServer(state_dir=state_dir, workers=1)
srv.register_panel("kp", full[:, :L], E_max=E_max, cache=True)
srv.call("optimal_E", "kp")
print("READY", flush=True)
for k in range(ticks):
    r = srv.call("append", "kp", delta=full[:, L + k:L + k + 1])
    print(f"ACK {r['version']}", flush=True)
time.sleep(600)
"""


# A rank of the sharded phase's four-rank world on the one card: gloo on a
# FileStore under ``out``, every rank on cuda:0. Mesh (2, 2): the session's
# optimal_E, xmap of both methods and a journaled xmap (rank 0 writes the
# run dir); mesh (4,) over ("data",): sharded_optimal_E and
# sharded_smap_theta on the panel zero-padded to a multiple of 4. Saves its
# results, prints the seconds of each step (its CUDA context and the
# world's first collective apart, and the session's optimal_E once more on
# a fresh session) and its kernel launches.
SHARDED_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.data.timeseries import forced_network_panel
from repro_torch.distributed import (gather_host, make_ccm_mesh,
                                     pad_to_multiple, sharded_optimal_E,
                                     sharded_smap_theta)
from repro_torch.edm import EDM
from repro_torch.kernels import (knn_batch, knn_multi_e, lookup, pairwise_dist,
                                 smap_gram, topk)

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
N, L, seed, E_max, E = (int(a) for a in sys.argv[4:9])
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out, "store"), world), rank=rank, world_size=world)
wrappers = {"knn_multi_e": knn_multi_e.all_knn_multi_e,
            "knn_batch": knn_batch.all_knn_batch,
            "lookup_rho": lookup.lookup_rho,
            "pairwise_distances": pairwise_dist.pairwise_distances,
            "topk_select_sizes": topk.topk_select_sizes,
            "smap_gram": smap_gram.smap_gram}
panel = forced_network_panel(N, L, seed=seed)[0]
res, sec = {}, {}
t_start = t0 = time.perf_counter()


def lap(name):
    global t0
    torch.cuda.synchronize()
    sec[name] = time.perf_counter() - t0
    t0 = time.perf_counter()


torch.zeros(1, device="cuda")  # the rank's CUDA context
lap("cuda_init")
dist.barrier()  # the world's first collective: gloo connects its pairs
lap("first_collective")
mesh22 = make_ccm_mesh((2, 2), ("data", "model"))
sess = EDM(panel, E_max=E_max, mesh=mesh22)
lap("mesh_2x2_init")
res["E_opt"], res["rho_E"] = sess.optimal_E()
lap("optimal_E")
res["xmap"] = sess.xmap()
lap("xmap")
res["xmap_smap"] = sess.xmap(method="smap")
lap("xmap_smap")
res["xmap_journaled"] = sess.xmap(run_dir=os.path.join(out, "run"))
lap("xmap_journaled")
EDM(panel, E_max=E_max, mesh=mesh22).optimal_E()
lap("optimal_E_again")
mesh4 = make_ccm_mesh((4,), ("data",))
lap("mesh_4_init")
Xp = pad_to_multiple(torch.as_tensor(panel, device="cuda"), 4)
E4, rho4 = sharded_optimal_E(Xp, E_max=E_max, mesh=mesh4, axes=("data",))
res["E_opt_direct"] = gather_host(E4)[:N]
res["rho_E_direct"] = gather_host(rho4)[:N]
lap("optimal_E_direct")
res["smap_theta"] = gather_host(sharded_smap_theta(
    Xp, E=E, mesh=mesh4, axes=("data",)))[:N]
lap("smap_theta_direct")
sec["total"] = time.perf_counter() - t_start
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
print(json.dumps({"sharded_child": {
    "rank": rank, "seconds": sec, "padded_rows": int(Xp.shape[0]),
    "launches": {n: fn.launches for n, fn in wrappers.items()}}}))
dist.destroy_process_group()
"""


# A rank of the mesh phase's world on the one card: gloo on a FileStore
# under ``out``, every rank on cuda:0, mesh (1, MESH_RANKS) over ("data",
# "model"). Draws ``arch`` as configured leaf by leaf (``place_params``),
# generates with sequence-parallel decode on, replays the world of one's
# sequences (teacher forcing) against its logits, and, given a checkpoint
# directory, restores its leaves onto the mesh (``restore(shardings=)``).
MESH_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, out, root, arch, ckpt = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, root)
import chip_smoke as cs
torch.set_num_threads(2)  # four ranks share the host's cores
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out, "store"), world), rank=rank, world_size=world)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import NamedSharding, param_spec
from repro_torch.models import carry, meshctx
from repro_torch.models import transformer as tf
from repro_torch.serving import ServeEngine

dev = torch.device("cuda", 0)
mesh = make_mesh((1, world), ("data", "model"))
cfg = cs.mesh_config(arch)
ref = json.load(open(os.path.join(out, "sequences.json")))
t0 = time.perf_counter()
placed = carry.place_params(cfg, mesh, generator=torch.Generator(
    device=dev).manual_seed(0))
torch.cuda.synchronize()
rec = {"init_s": time.perf_counter() - t0, "local_param_bytes": sum(
    p.to_local().numel() * p.element_size() for p in placed.parameters())}
meshctx.set_mesh(mesh)
meshctx.set_seqpar_decode(True)
res, rec["generate_s"] = cs.host_s(torch, lambda: ServeEngine(
    cfg, placed, s_max=ref["s_max"]).generate(ref["prompts"],
                                              max_new=cs.MESH_RANK_NEW))
rec["first_divergence"] = cs.first_divergence(ref["tokens"], res.tokens,
                                              ref["prompts"])
lg, rec["step_ms"], rec["collectives_a_step"], routes = cs.lm_teacher_logits(
    torch, cfg, placed, ref["tokens"], ref["s_max"], dev)
want = np.load(os.path.join(out, "logits.npy"))
rec.update(cs.held_logits(np, lg, want, routes, np.load(
    os.path.join(out, "routes.npy")) if routes is not None else None))
rec["peak_bytes"] = torch.cuda.max_memory_allocated()
if ckpt != "-":
    mgr = CheckpointManager(ckpt)
    names = json.load(open(os.path.join(ckpt, "names.json")))
    params = dict(placed.named_parameters())
    like = {n: torch.empty(params[n].shape, dtype=params[n].dtype,
                           device="meta") for n in names}
    sh = {n: NamedSharding(mesh, param_spec(n, params[n].shape, cfg, mesh))
          for n in names}
    t0 = time.perf_counter()
    got = mgr.restore(like, shardings=sh)
    rec["restore_s"] = time.perf_counter() - t0
    rec["restore_equal"] = all(
        list(got[n].placements) == list(params[n].placements)
        and torch.equal(got[n].to_local(), params[n].to_local())
        for n in names)
    rec["restore_leaves"] = len(names)
meshctx.set_seqpar_decode(False)
meshctx.set_mesh(None)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"mesh_child": rec}))
"""


# A rank of phase 15's four-rank world on the one card: gloo on a
# FileStore under ``out``, every rank on cuda:0, mesh MESH_TRAIN_SHAPE.
# Draws the placed train state leaf by leaf, takes MESH_TRAIN_STEPS steps
# of the batch ``out``/batch.npz (sampling rows after the first), and
# prints its record; rank 0 writes the sampled rows to ``out``.
MESH_TRAIN_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, out, root = sys.argv[1:5]
rank, world = int(rank), int(world)
sys.path.insert(0, root)
import chip_smoke as cs
torch.set_num_threads(2)  # four ranks share the host's cores
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out, "store"), world), rank=rank, world_size=world)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import meshctx

mesh = make_mesh(cs.MESH_TRAIN_SHAPE, ("data", "model"))
with meshctx.use_mesh(mesh):
    rec, rows = cs.mesh_train_run(torch, np, torch.device("cuda", 0),
                                  os.path.join(out, "batch.npz"))
if rank == 0:
    np.savez(os.path.join(out, "rows.npz"), **rows)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"mesh_train_child": rec}))
"""


# The dry run of phases 13-15's own steps in one child process over fake
# worlds (``dryrun_held``); prints its record.
DRYRUN_CHILD = r"""
import json, sys
root, args = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
import torch
torch.set_num_threads(1)
import chip_smoke as cs
print(json.dumps({"dryrun_child": cs.dryrun_held(args)}))
"""


def smap_rho_tol(theta: float) -> float:
    """S-Map ρ bound between the kernel's and the plain run. The two Gram
    sums (each within GRAM_RTOL of Σ|terms|) go through a Cholesky solve of
    AᵀWA, whose condition number is κ(√W·A)² and grows with θ; the worst of
    154 × 154 cross-map ρ sits far in that error's tail. Measured: JAX
    against the port's plain version on the CPU, 40 × 40 pairs at L = 1600
    (tests/test_torch_smap.py), ≤ 3.4e-5 at θ = 1 and ≤ 1.3e-3 at θ = 8;
    the kernel against the plain version on the H100, 154 × 154 pairs at
    θ = 1, ≤ 1.3e-4."""
    return 5e-4 if theta <= 4.0 else 5e-3


def smap_rho64(np, lib, tgt, *, E, Tp, theta, ridge=1e-6):
    """ρ of one S-Map cross-map (library ``lib``, target ``tgt``, τ = 1,
    leave-one-out) with every sum and the solve in float64: the arbiter
    between two float32 runs that differ."""
    lib, tgt = np.asarray(lib, np.float64), np.asarray(tgt, np.float64)
    Lp = lib.size - (E - 1)
    rows, off = Lp - Tp, E - 1 + Tp
    Z = np.stack([lib[k:k + Lp] for k in range(E)], axis=1)[:rows]
    A = np.concatenate([np.ones((rows, 1)), Z], axis=1)
    d = np.sqrt(((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1))
    dbar = d.mean(axis=1, keepdims=True)
    W = np.exp(-theta * d / np.where(dbar > 1e-30, dbar, 1.0))
    np.fill_diagonal(W, 0.0)
    y = tgt[off:off + rows]
    G = np.einsum("ji,ip,iq->jpq", W, A, A)
    m = np.einsum("ji,i,ip->jp", W, y, A)
    lam = ridge * np.trace(G, axis1=1, axis2=2) / (E + 1) + 1e-20
    b = np.linalg.solve(G + lam[:, None, None] * np.eye(E + 1), m[..., None])
    pred = (A * b[..., 0]).sum(1)
    return float(np.corrcoef(pred, y)[0, 1])


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least ms for ``nbytes`` of memory traffic and ``ops`` operations
    at ``rate`` per second, and which of the two bounds it."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_s(torch, fn):
    """(result, seconds) of one call, host clock, ended by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spread(samples) -> dict:
    """Median, min and max seconds of repeated runs."""
    return {"median_s": statistics.median(samples), "min_s": min(samples),
            "max_s": max(samples), "runs": len(samples)}


def device_profile(torch, fn) -> dict:
    """One call under ``torch.profiler`` (device activity only): its wall
    seconds, the seconds the device was busy (the union of its kernel and
    copy intervals), the idle share, and per kernel its launches and mean
    device µs. The profiler's own cost is in the wall time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        m = re.search(r"::(\w+_kernel)\(", e.name)
        name = m.group(1) if m else e.name[:48]
        n, us = per.get(name, (0, 0.0))
        per[name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "idle_share": (1.0 - busy_us * 1e-6 / wall) if spans else None,
            "kernels": {k: {"launches": n, "mean_us": us / n}
                        for k, (n, us) in top}}


def peak_extra(torch, fn):
    """(result, peak device bytes allocated above what was held before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def one_launch_ms(torch, fn, reps: int = 5) -> float:
    """Median ms of single calls, each bracketed by CUDA events on its own:
    beside the profiler's device time, it shows a launch the profiler may
    not list."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device-busy ms per call of ``fn`` (profiler), after one warm-up:
    the card's own time, without the host's launch cost that a CUDA-event
    loop of small kernels measures."""
    fn()
    return device_profile(torch, lambda: [fn() for _ in range(reps)])[
        "device_busy_s"] * 1e3 / reps


def named_device_ms(torch, fn, match: str, reps: int = 10,
                    evict=None) -> float:
    """Mean device ms of the kernels whose lower-case name holds ``match``
    over ``reps`` calls of ``fn``, each result dropped before the next call
    (so the caching allocator hands the same block back: its lines stay in
    L2), each call after ``evict()`` when given. Other kernels, such as
    the eviction's, are not counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if evict is not None:
                evict()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and match in e.name.lower()]
    if not us:
        fail(f"the profiler listed no kernel named like {match!r}")
    return statistics.mean(us) * 1e-3


def kernel_row(name, source, replaces, err, ms, plain_ms, bound, library_ms,
               dev_ms, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms, device_ms=dev_ms,
                **extra)


def check_main_path_kernels(torch, X, knn_multi_e, knn_batch, lookup, ref):
    """The three kernels of ``optimal_E`` → ``xmap`` against their plain
    versions: small edge cases, then the main path's shapes. ``knn_batch``
    and ``lookup_rho`` are also timed at the shapes their paths launch
    (``path_device_ms``): the direct xmap's batch of B libraries, and
    ``optimal_E``'s own-target launches at every E."""
    from repro_torch.core.ccm import auto_batch_libs
    from repro_torch.core.embedding import (embed_offset, num_embedded,
                                            pred_rows)
    from repro_torch.edm.plan import _derive as derive
    from repro_torch.edm.plan import _derive_idx as derive_idx
    from repro_torch.edm.plan import _gathered_dists_batch as gathered

    rows_out = []
    # Small shapes first: per-level k, capped and non-monotone masks, tau 2,
    # E_max 1 and 32, k 32, tied distances (a series rounded to halves),
    # all on the buffered selection, then k 40 and k 33 on the insertion
    # kernel; L = 257 is no multiple of 32.
    Xs = X[:3, :257]
    tied = torch.round(Xs * 2) / 2
    for xs_, kw in (
            (Xs, dict(E_max=6, tau=2, k=None, max_idx=None)),
            (Xs, dict(E_max=5, tau=1, k=9, max_idx=[200, 40, 180, 5, 100])),
            (Xs, dict(E_max=1, tau=1, k=None, max_idx=None)),
            (Xs, dict(E_max=32, tau=1, k=9, max_idx=None)),
            (Xs, dict(E_max=20, tau=1, k=32, max_idx=None)),
            (tied, dict(E_max=8, tau=1, k=None, max_idx=None)),
            (tied, dict(E_max=20, tau=1, k=22, max_idx=None)),
            (Xs, dict(E_max=4, tau=1, k=40, max_idx=None)),
            (Xs, dict(E_max=32, tau=1, k=None, max_idx=None))):
        got = knn_multi_e.all_knn_multi_e(xs_, **kw)
        want = knn_multi_e.plain(xs_, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"knn_multi_e differs from its plain version at {kw}")
    # knn_batch: both designs against the plain version, at k on each side
    # of every register-list size (tied values: 1/8 steps), E = 1, τ = 2,
    # caps above and below k, self kept, E = 32, L = 257; k 33 and 150 on
    # the insertion kernel alone.
    Xt = torch.round(Xs * 8) / 8
    cases = [(Xt, dict(E=3, tau=1, k=k)) for k in (4, 5, 8, 9, 16, 17, 32,
                                                    33)]
    cases += [(Xt, dict(E=1, tau=1, k=2)), (Xs, dict(E=4, tau=2, k=9)),
              (Xt, dict(E=3, tau=1, k=6, max_idx=100)),
              (Xt, dict(E=3, tau=1, k=6, max_idx=2)),
              (Xt, dict(E=3, tau=1, k=6, exclude_self=False)),
              (Xs, dict(E=32, tau=1, k=32)),
              (Xs, dict(E=4, tau=2, k=300 // 2, max_idx=60))]
    for xs_, kw in cases:
        got = knn_batch.all_knn_batch(xs_, **kw)
        want = knn_batch.plain(xs_, **kw)
        ins = knn_batch._launch(xs_, "insert", **kw)
        for a, b, c in zip(got, want, ins):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                fail(f"knn_batch's designs and plain version differ at {kw}")
    # The insertion kernel at one warp a block: the block's room scaled
    # down so that k = 40 fills it (the limit it lifts is k ≤ 29,056).
    room = knn_batch.SMEM_MAX
    knn_batch.SMEM_MAX = 8 * 40
    try:
        got = knn_batch._launch(Xt, "insert", E=2, k=40)
    finally:
        knn_batch.SMEM_MAX = room
    want = knn_batch.plain(Xt, E=2, k=40)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("knn_batch's insertion kernel differs at one warp a block")

    # multi-E at the session master's shape.
    mkw = dict(E_max=E_MAX, tau=1, k=K_MASTER, exclude_self=True)
    dk, ik = knn_multi_e.all_knn_multi_e(X, **mkw)
    dp, ip = knn_multi_e.plain(X, **mkw)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
        bad = int((dk != dp).sum() + (ik != ip).sum())
        fail(f"knn_multi_e differs from its plain version in {bad} entries")
    fin = torch.isfinite(dk)
    err = float((dk[fin] - dp[fin]).abs().max())
    del dp, ip
    kfn = lambda: knn_multi_e.all_knn_multi_e(X, **mkw)  # noqa: E731
    ms = time_ms(torch, kfn, 10)
    plain_ms = time_ms(torch, lambda: knn_multi_e.plain(X, **mkw), 1, 0)
    # One series: the shape of each of cache=False optimal_E's launches.
    n1 = lambda: knn_multi_e.all_knn_multi_e(X[:1], **mkw)  # noqa: E731
    # The kept insertion kernel (the previous design) at the same shape: the
    # same bits, timed beside the buffered selection in this run.
    ins = lambda: knn_multi_e._launch(  # noqa: E731
        X, "insert", max_idx=None, **mkw)
    di, ii = ins()
    if not (torch.equal(di, dk) and torch.equal(ii, ik)):
        fail("knn_multi_e's two designs differ at the main path's shape")
    del di, ii
    rows_out.append(kernel_row(
        "knn_multi_e", "src/repro_torch/kernels/csrc/knn_multi_e.cu",
        "src/repro/kernels/knn_multi_e.py:64", err, ms, plain_ms,
        bound_ms(X.numel() * 4 + dk.numel() * 8,
                 3.0 * N_SERIES * E_MAX * LENGTH * LENGTH), None,
        device_ms(torch, kfn, 3),
        design=knn_multi_e.route(LENGTH, E_MAX, 1, K_MASTER),
        one_launch_ms=one_launch_ms(torch, kfn, 3),
        insert_ms=time_ms(torch, ins, 2, 0),
        n1_ms=time_ms(torch, n1, 20), n1_device_ms=device_ms(torch, n1),
        n1_bound_ms=bound_ms(LENGTH * 4 + dk[0].numel() * 8,
                             3.0 * E_MAX * LENGTH * LENGTH)[0]))
    dM, iM = dk, ik  # the master, for optimal_E's own lookup_rho shapes

    # knn_batch at the fixed-E direct route's kernel (B = N here).
    Lp = LENGTH - (E_FIXED - 1)
    bkw = dict(E=E_FIXED, tau=1, k=E_FIXED + 1, exclude_self=True,
               max_idx=Lp - 1)
    dk, ik = knn_batch.all_knn_batch(X, **bkw)
    dp, ip = knn_batch.plain(X, **bkw)
    if not (torch.equal(dk, dp) and torch.equal(ik, ip)):
        fail("knn_batch differs from its plain version at B=154, E=3, k=4")
    err = float((dk - dp).abs().max())
    del dp, ip
    ins = lambda: knn_batch._launch(X, "insert", **bkw)  # noqa: E731
    di, ii = ins()
    if not (torch.equal(di, dk) and torch.equal(ii, ik)):
        fail("knn_batch's two designs differ at B=154, E=3, k=4")
    del di, ii
    # The direct xmap's batch: B libraries a launch under the memory rule.
    B = auto_batch_libs(Lp, N_SERIES, device=X.device)
    Xb = X[:B]
    got = knn_batch.all_knn_batch(Xb, **bkw)
    if not (torch.equal(got[0], dk[:B]) and torch.equal(got[1], ik[:B])):
        fail(f"knn_batch at B={B} differs from the B=154 tables")
    kfn = lambda: knn_batch.all_knn_batch(X, **bkw)  # noqa: E731
    bfn = lambda: knn_batch.all_knn_batch(Xb, **bkw)  # noqa: E731
    ms = time_ms(torch, kfn, 20)
    plain_ms = time_ms(torch, lambda: knn_batch.plain(X, **bkw), 2)
    rows_out.append(kernel_row(
        "knn_batch", "src/repro_torch/kernels/csrc/knn_batch.cu",
        "src/repro/kernels/knn_batch.py:42", err, ms, plain_ms,
        bound_ms(X.numel() * 4 + dk.numel() * 8,
                 3.0 * N_SERIES * E_FIXED * Lp * Lp), None,
        device_ms(torch, kfn),
        design=knn_batch.route(Lp, E_FIXED, 1, E_FIXED + 1),
        insert_ms=time_ms(torch, ins, 3),
        insert_device_ms=device_ms(torch, ins, 3),
        path_B=B, path_device_ms=device_ms(torch, bfn),
        path_bound_ms=bound_ms(B * LENGTH * 4 + B * Lp * (E_FIXED + 1) * 8,
                               3.0 * B * E_FIXED * Lp * Lp)[0]))

    # lookup_rho: E = 3, k = 4, 154 library tables × 154 targets (xmap),
    # and the own-target form of the ρ(E) sweep on the same tables.
    w = ref.make_weights(dk)
    off = E_FIXED - 1
    rk = lookup.lookup_rho(X, ik, w, offset=off)
    rp = lookup.plain(X, ik, w, offset=off)
    err = float((rk - rp).abs().max())
    if not err <= RHO_ATOL:
        fail(f"lookup_rho differs from its plain version by {err}")
    ok_own = lookup.lookup_rho(X, ik, w, offset=off, own=True)
    op = lookup.plain_own(X, ik, w, offset=off)
    err = max(err, float((ok_own - op).abs().max()))
    if not err <= RHO_ATOL:
        fail(f"lookup_rho (own target) differs by {err}")
    kfn = lambda: lookup.lookup_rho(X, ik, w, offset=off)  # noqa: E731
    ms = time_ms(torch, kfn, 20)
    plain_ms = time_ms(torch, lambda: lookup.plain(X, ik, w, offset=off), 2)
    # optimal_E's own launches: one per E = 1..E_max on the master's
    # derived tables, each table against its own series (154 × 1 target).
    own, own_bound = [], 0.0
    for E in range(1, E_MAX + 1):
        rows = pred_rows(LENGTH, E, 1, 1)
        dE, iE, _ = derive(dM[:, E - 1, :rows], iM[:, E - 1, :rows], k=E + 1,
                           max_idx=num_embedded(LENGTH, E, 1) - 2)
        own.append((iE, ref.make_weights(dE), embed_offset(E, 1, 1)))
        own_bound += bound_ms(iE.numel() * 8 + X.numel() * 4 + N_SERIES * 4,
                              N_SERIES * rows * (2.0 * (E + 1) + 8))[0]
    ofn = lambda: [lookup.lookup_rho(X, i, w_, offset=o, own=True)  # noqa
                   for i, w_, o in own]
    # The xmaps' launches. Master route: one launch per E-group of
    # optimal_E's E_opt (from these own-target launches, as the session
    # takes it), B = N library tables derived from the master against the
    # group's targets. Direct route: the batch of B libraries at E = 3
    # against all N targets.
    E_opt = torch.stack(ofn()).argmax(0) + 1
    master, master_bound = {}, []
    for E in sorted({int(e) for e in E_opt.tolist()}):
        tg = X[E_opt == E]
        LpE = num_embedded(LENGTH, E, 1)
        rows, o = pred_rows(LENGTH, E, 1, 0), embed_offset(E, 1, 0)
        iE, okE = derive_idx(iM[:, E - 1, :LpE], k=E + 1, max_idx=LpE - 1)
        wE = ref.make_weights(gathered(X, iE, okE, E=E, tau=1))
        iE, wE = iE[:, :rows], wE[:, :rows]
        Yt = lookup.transpose_targets(tg)
        got = lookup.lookup_rho(tg, iE, wE, offset=o, Yt=Yt)
        err = max(err, float((got - lookup.plain(tg, iE, wE, offset=o))
                             .abs().max()))
        master[E] = {"targets": int(tg.shape[0]), "device_ms": device_ms(
            torch, lambda: lookup.lookup_rho(tg, iE, wE, offset=o, Yt=Yt))}
        master_bound.append(bound_ms(
            iE.numel() * 8 + tg.numel() * 4 + N_SERIES * tg.shape[0] * 4,
            N_SERIES * tg.shape[0] * rows * (2.0 * (E + 1) + 8))[0])
    Yt = lookup.transpose_targets(X)
    ib, wb = ik[:B], w[:B]
    got = lookup.lookup_rho(X, ib, wb, offset=off, Yt=Yt)
    if not torch.equal(got, rk[:B]):
        fail(f"lookup_rho at B={B} differs from the B=154 launch's rows")
    if not err <= RHO_ATOL:
        fail(f"lookup_rho at the xmaps' shapes differs by {err}")
    dfn = lambda: lookup.lookup_rho(X, ib, wb, offset=off, Yt=Yt)  # noqa
    rows_out.append(kernel_row(
        "lookup_rho", "src/repro_torch/kernels/csrc/lookup_rho.cu",
        "src/repro/kernels/lookup.py:95", err, ms, plain_ms,
        bound_ms(ik.numel() * 8 + X.numel() * 4 + rk.numel() * 4,
                 N_SERIES * N_SERIES * Lp * (2.0 * (E_FIXED + 1) + 8)),
        None, device_ms(torch, kfn),
        path_device_ms=device_ms(torch, ofn, 5) / E_MAX,
        path_bound_ms=own_bound / E_MAX,
        xmap_master_groups=master,
        xmap_master_device_ms=statistics.mean(
            m["device_ms"] for m in master.values()),
        xmap_master_bound_ms=statistics.mean(master_bound),
        xmap_direct_B=B, xmap_direct_device_ms=device_ms(torch, dfn),
        xmap_direct_bound_ms=bound_ms(
            ib.numel() * 8 + X.numel() * 4 + B * N_SERIES * 4,
            B * N_SERIES * Lp * (2.0 * (E_FIXED + 1) + 8))[0]))
    return rows_out


def check_slice_kernels(torch, X, x_long, pairwise_dist, topk, lookup, ref,
                        lib_caps):
    """The four kernels of the convergence, significance and per-series
    simplex path against their plain versions, bit for bit: small edge
    cases, then the path's shapes (one series, Lp = 1598 at E = 3, k = 4,
    the convergence caps). Both top-k designs are held there, and the
    kept insertion kernels are timed beside the selection kernels
    (``insert_ms``,
    ``insert_device_ms``); ``topk_select`` also at the variants path's
    launch, L = 10,000, E = 20, k = 21 (``path_device_ms``)."""

    def equal_pair(got, want, what):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"{what} differs from its plain version")

    # Small shapes: tau 2, k up to 70 and on both sides of the designs'
    # boundary (32, 33), rows with fewer than k valid candidates, caps on
    # and across 32-column batches, a single cap (0 too), a cap below k,
    # close caps, caps past the last column, +inf values; the routed
    # kernel and the insertion kernel, each against the plain version.
    xs = X[5, :300].clone()
    xs[150:190] = xs[10:50]  # a duplicated stretch: exact ties
    # Lp mod 4 = 0, 0, 1, 2, 3, 0, 1; Lp below a tile (48, 61, 21) and 1.
    for n, E, tau in ((300, 1, 1), (300, 3, 2), (300, 20, 1), (300, 3, 1),
                      (300, 2, 1), (50, 3, 1), (61, 1, 1), (3, 3, 1),
                      (40, 20, 1)):
        xn = xs[:n]
        if not torch.equal(pairwise_dist.pairwise_distances(xn, E=E, tau=tau),
                           pairwise_dist.plain(xn, E=E, tau=tau)):
            fail(f"pairwise_dist differs from its plain version at L={n}, "
                 f"E={E}, tau={tau}")
    Ds = pairwise_dist.plain(xs, E=3, tau=2)
    Ds[7, 20:90] = float("inf")
    for k, mx in ((4, None), (70, None), (70, 30), (1, 0), (32, None),
                  (33, None), (32, 10), (21, 250)):
        want = topk.plain_select(Ds, k=k, max_idx=mx)
        equal_pair(topk.topk_select(Ds, k=k, max_idx=mx), want,
                   f"topk_select at k={k}, max_idx={mx}")
        equal_pair(topk._launch_select(Ds, "insert", k=k, max_idx=mx), want,
                   f"topk_select's insertion kernel at k={k}, max_idx={mx}")
    for k, caps in ((4, (31, 32, 33, 63, 64, 200)), (70, (2, 40, 40, 5000)),
                    (5, (150,)), (3, (0, 1, 95, 295)), (4, (0,)),
                    (32, (10, 31, 200, 295)), (33, (10, 31, 200, 295)),
                    (6, (100, 101, 101, 103)), (21, (0, 3, 20, 21, 600))):
        want = topk.plain_sizes(Ds, k=k, max_idxs=caps)
        equal_pair(topk.topk_select_sizes(Ds, k=k, max_idxs=caps), want,
                   f"topk_select_sizes at k={k}, caps={caps}")
        equal_pair(topk._launch_sizes(Ds, "insert", k=k, max_idxs=caps),
                   want, f"topk_select_sizes' insertion kernel at k={k}, "
                   f"caps={caps}")
    Ds = pairwise_dist.plain(xs, E=3, tau=2)
    # k 21 and 33 (word loads of the table), 4 and 8 (16-byte loads), a
    # series of 14,400 points, N 7 and 2.
    for k, Y in ((21, X[:7, :300]), (33, X[:7, :300]), (8, X[:7, :300]),
                 (4, X[:2].repeat(1, 9))):
        ds, is_ = topk.plain_select(Ds, k=k, max_idx=250)
        ws = ref.make_weights(ds)
        is_[::5, -1] = -1  # invalid slots, as derived tables carry them
        if not torch.equal(lookup.lookup(Y, is_, ws, offset=4),
                           lookup.plain_lookup(Y, is_, ws, offset=4)):
            fail(f"lookup differs from its plain version (small, k={k}, "
                 f"L={Y.shape[1]})")

    # The path's shapes. max_abs_err is 0: equality is checked above.
    rows_out = []

    def row(name, src, replaces, kfn, pfn, bound, lfn=None):
        rows_out.append(kernel_row(
            name, f"src/repro_torch/kernels/csrc/{src}",
            f"src/repro/kernels/{replaces}", 0.0, time_ms(torch, kfn, 50),
            time_ms(torch, pfn, 10), bound,
            None if lfn is None else time_ms(torch, lfn, 50),
            device_ms(torch, kfn)))

    x = X[0]
    E, k = E_FIXED, E_FIXED + 1
    Lp = LENGTH - (E - 1)
    D = pairwise_dist.pairwise_distances(x, E=E, tau=1)
    if not torch.equal(D, pairwise_dist.plain(x, E=E, tau=1)):
        fail("pairwise_dist differs from its plain version at L=1600, E=3")
    Z = ref.delay_embed(x, E, 1).contiguous()
    pfn = lambda: pairwise_dist.pairwise_distances(x, E=E)  # noqa: E731
    row("pairwise_distances", "pairwise_dist.cu", "pairwise_dist.py:38",
        pfn, lambda: pairwise_dist.plain(x, E=E, tau=1),
        bound_ms(LENGTH * 4 + Lp * Lp * 4, 3.0 * E * Lp * Lp),
        lambda: torch.cdist(Z, Z))
    pw_row = rows_out[-1]
    del Z
    # The card's write floor, D.fill_(1.0) on an (Lp, Lp) float32 matrix,
    # in three L2 states, each beside the kernel's: the table's (20 fresh
    # outputs held, 204 MB), warm (one output block written again and
    # again, as the per-series simplex path reuses it) and cold (after a
    # 128 MB scratch write that evicts the 50 MB L2).
    Df = torch.empty((Lp, Lp), dtype=torch.float32, device=x.device)
    scratch = torch.empty(32 << 20, dtype=torch.float32, device=x.device)
    ffn = lambda: Df.fill_(1.0)  # noqa: E731
    evict = lambda: scratch.add_(1.0)  # noqa: E731
    pw_row.update(
        floor_device_ms=device_ms(torch, lambda: torch.empty(
            (Lp, Lp), dtype=torch.float32, device=x.device).fill_(1.0)),
        warm_device_ms=named_device_ms(torch, pfn, "pairwise_dist"),
        warm_floor_device_ms=named_device_ms(torch, ffn, "fill"),
        cold_device_ms=named_device_ms(torch, pfn, "pairwise_dist",
                                       evict=evict),
        cold_floor_device_ms=named_device_ms(torch, ffn, "fill",
                                             evict=evict))
    del Df, scratch

    mx = Lp - 2  # simplex_predict's cap at Tp = 1
    dk, ik = topk.topk_select(D, k=k, max_idx=mx)
    equal_pair((dk, ik), topk.plain_select(D, k=k, max_idx=mx),
               "topk_select at Lp=1598, k=4")
    ins = lambda: topk._launch_select(D, "insert", k=k,  # noqa: E731
                                      max_idx=mx)
    equal_pair(ins(), (dk, ik), "topk_select's insertion kernel at Lp=1598")
    row("topk_select", "topk.cu", "topk.py:39",
        lambda: topk.topk_select(D, k=k, max_idx=mx),
        lambda: topk.plain_select(D, k=k, max_idx=mx),
        bound_ms(Lp * Lp * 4 + Lp * k * 8, float(Lp * Lp)),
        lambda: torch.topk(D, k, dim=1, largest=False))
    rows_out[-1].update(design=topk.route(k),
                        insert_ms=time_ms(torch, ins, 50),
                        insert_device_ms=device_ms(torch, ins))
    # The variants path's launch: L = 10,000, E = 20, k = 21 (core.all_knn's
    # two kernels), against the plain version and the insertion kernel.
    E_l, k_l = E_MAX, E_MAX + 1
    D_l = pairwise_dist.pairwise_distances(x_long, E=E_l, tau=1)
    Lp_l = D_l.shape[0]
    if not torch.equal(D_l, pairwise_dist.plain(x_long, E=E_l, tau=1)):
        fail(f"pairwise_dist differs from its plain version at "
             f"L={x_long.shape[0]}, E={E_l}")
    pw_row.update(
        path_L=x_long.shape[0], path_E=E_l,
        path_device_ms=device_ms(torch, lambda: pairwise_dist.
                                 pairwise_distances(x_long, E=E_l), 5),
        path_bound_ms=bound_ms(x_long.shape[0] * 4 + Lp_l * Lp_l * 4,
                               3.0 * E_l * Lp_l * Lp_l)[0])
    got = topk.topk_select(D_l, k=k_l)
    equal_pair(got, topk.plain_select(D_l, k=k_l),
               f"topk_select at L={x_long.shape[0]}, k={k_l}")
    ins_l = lambda: topk._launch_select(D_l, "insert", k=k_l)  # noqa: E731
    equal_pair(ins_l(), got, f"topk_select's insertion kernel at "
               f"L={x_long.shape[0]}, k={k_l}")
    rows_out[-1].update(
        path_L=x_long.shape[0], path_k=k_l,
        path_device_ms=device_ms(torch, lambda: topk.topk_select(D_l, k=k_l),
                                 5),
        path_bound_ms=bound_ms(Lp_l * Lp_l * 4 + Lp_l * k_l * 8,
                               float(Lp_l * Lp_l))[0],
        path_insert_device_ms=device_ms(torch, ins_l, 3))
    del D_l, got

    S, last = len(lib_caps), lib_caps[-1]
    sk = topk.topk_select_sizes(D, k=k, max_idxs=lib_caps)
    equal_pair(sk, topk.plain_sizes(D, k=k, max_idxs=lib_caps),
               f"topk_select_sizes at Lp=1598, k=4, caps={lib_caps}")
    ins = lambda: topk._launch_sizes(D, "insert", k=k,  # noqa: E731
                                     max_idxs=lib_caps)
    equal_pair(ins(), sk, "topk_select_sizes' insertion kernel at Lp=1598")
    row("topk_select_sizes", "topk.cu", "topk.py:124",
        lambda: topk.topk_select_sizes(D, k=k, max_idxs=lib_caps),
        lambda: topk.plain_sizes(D, k=k, max_idxs=lib_caps),
        bound_ms(Lp * (last + 1) * 4 + S * Lp * k * 8,
                 float(Lp * (last + 1))))
    rows_out[-1].update(design=topk.route(k, S),
                        insert_ms=time_ms(torch, ins, 50),
                        insert_device_ms=device_ms(torch, ins))

    rows = Lp - 1  # simplex_predict's rows and offset at Tp = 1
    off = E
    Y, ir, wr = x[None], ik[:rows], ref.make_weights(dk)[:rows]
    if not torch.equal(lookup.lookup(Y, ir, wr, offset=off),
                       lookup.plain_lookup(Y, ir, wr, offset=off)):
        fail("lookup differs from its plain version at the simplex shape")
    # The library's one call for the same sums: the (rows, N) bags of
    # Y's transposed rows at the table's indices, weighted (every index
    # on the path is valid).
    il, Yo = ir.long(), Y.t()[off:]
    bag = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        il, Yo, per_sample_weights=wr, mode="sum")
    row("lookup", "lookup.cu", "lookup.py:46",
        lambda: lookup.lookup(Y, ir, wr, offset=off),
        lambda: lookup.plain_lookup(Y, ir, wr, offset=off),
        bound_ms(LENGTH * 4 + rows * k * 8 + rows * 4, 2.0 * rows * k), bag)
    out = torch.empty((1, rows), dtype=torch.float32, device=x.device)
    rows_out[-1].update(
        floor_device_ms=device_ms(torch, out.zero_),
        library_max_abs_err=float((bag().t() - lookup.plain_lookup(
            Y, ir, wr, offset=off)).abs().max()))
    return rows_out


def check_smap_kernel(torch, X, smap_gram, ref, theta_grid):
    """``smap_gram`` against its plain version: small edge shapes, then the
    path's two shapes — one series at T = 8, N = 1 (the θ-sweep) and one
    library against all 154 targets at T = 1 (the S-Map xmap). Returns the
    kernel's row (at the xmap shape) and the sweep shape's timings."""

    def held(kw, x, Y, what):
        G, M = smap_gram.smap_gram(x, Y, **kw)
        Gp, Mp = smap_gram.plain(x, Y, **kw)
        Ga, Ma = ref.smap_gram_abs(x, Y, **kw)
        worst = 0.0
        for got, want, scale in ((G, Gp, Ga), (M, Mp, Ma)):
            if got.shape != want.shape:
                fail(f"smap_gram {what}: shape {tuple(got.shape)}, plain "
                     f"{tuple(want.shape)}")
            err = (got - want).abs()
            if not bool((err <= GRAM_RTOL * scale).all()):
                fail(f"smap_gram differs from its plain version beyond "
                     f"{GRAM_RTOL}·Σ|terms| at {what}")
            pos = scale > 0
            worst = max(worst, float((err[pos] / scale[pos]).max()))
        return worst, G, M

    # Small shapes: every E/τ/Tp/leave-one-out/N combination asked for,
    # rows (203 − (E−1)τ − Tp) never a multiple of the 64-row tile, a
    # constant series (d̄ = 0) and E + 1 = 21.
    xs, Ys = X[5, :203].contiguous(), X[6:9, :203].contiguous()
    small = (0.0, 0.5, 2.0, 8.0)
    worst = 0.0
    for E in (1, 2, 5):
        for tau in (1, 2):
            for Tp in (0, 1, 3):
                for excl in (True, False):
                    for N in (1, 3):
                        kw = dict(E=E, tau=tau, Tp=Tp, thetas=small,
                                  exclude_self=excl)
                        worst = max(worst, held(kw, xs, Ys[:N],
                                                f"small {kw}, N={N}")[0])
    const = torch.full_like(xs, 0.7)
    for excl in (True, False):
        kw = dict(E=2, tau=1, Tp=1, thetas=small, exclude_self=excl)
        worst = max(worst, held(kw, const, Ys, "a constant series")[0])
    kw = dict(E=20, tau=1, Tp=1, thetas=small, exclude_self=True)
    worst = max(worst, held(kw, X[7, :300].contiguous(),
                            X[8:10, :300].contiguous(), "E=20")[0])
    # Five θ: the narrow product's blocks take 2 θ each, the last one 1.
    kw = dict(E=2, tau=1, Tp=1, thetas=small + (1.0,), exclude_self=True)
    worst = max(worst, held(kw, xs, xs[None], "five thetas")[0])
    # A batch the scratch bound cuts into slices of 2 libraries: each
    # library's G and M the same bits as its own launch.
    kw = dict(E=3, tau=1, Tp=0, thetas=(SMAP_THETA,))
    Xb = X[:5, :300].contiguous()
    bound = smap_gram.SCRATCH_BYTES
    smap_gram.SCRATCH_BYTES = 2 * 4 * smap_gram.scratch_floats(298, 36, 1)
    try:
        G, M = smap_gram.smap_gram(Xb, Xb, **kw)
    finally:
        smap_gram.SCRATCH_BYTES = bound
    for b in range(5):
        g, m = smap_gram.smap_gram(Xb[b], Xb, **kw)
        if not (torch.equal(G[b], g) and torch.equal(M[b], m)):
            fail("smap_gram in scratch slices differs from a B = 1 launch")
    # One library over the bound: its query rows in slices of 128 (wide
    # product, 154 targets) and of 256 (the narrow one, 5 θ), each the same
    # bits as an unsliced launch.
    for Y, kw in ((X[:, :700], dict(E=3, tau=1, Tp=0, thetas=(SMAP_THETA,))),
                  (X[1:2, :700], dict(E=2, tau=1, Tp=1,
                                      thetas=small + (1.0,)))):
        x = X[0, :700].contiguous()
        G0, M0 = smap_gram.smap_gram(x, Y, **kw)
        rows, T = G0.shape[0], len(kw["thetas"])
        C = G0.shape[-1] ** 2 + M0.shape[-2] * G0.shape[-1]
        fixed = smap_gram.scratch_floats(rows, C, T, 0)
        step = smap_gram.scratch_floats(rows, C, T, smap_gram.ROW_STEP) - fixed
        smap_gram.SCRATCH_BYTES = 4 * (fixed + (T > 1) * 2 * step)
        try:
            G, M = smap_gram.smap_gram(x, Y, **kw)
        finally:
            smap_gram.SCRATCH_BYTES = bound
        if not (torch.equal(G, G0) and torch.equal(M, M0)):
            fail("smap_gram in row slices differs from an unsliced launch")

    def shape_timing(x, Y, kw):
        err, G, M = held(kw, x, Y, f"the path shape {kw}, N={Y.shape[0]}")
        rows, T, E1 = G.shape[0], G.shape[1], G.shape[2]
        C = E1 * E1 + Y.shape[0] * E1
        kfn = lambda: smap_gram.smap_gram(x, Y, **kw)  # noqa: E731
        pfn = lambda: smap_gram.plain(x, Y, **kw)  # noqa: E731
        # The library yardstick: the two torch.matmul of each θ, W @ (A⊗A)
        # and W @ (y⊗A), on a materialized W (not part of the timing).
        _, AA, yA = ref._smap_operands(x, Y, E=kw["E"], tau=kw["tau"],
                                       Tp=kw["Tp"])
        ratio = ref.smap_ratio(x, E=kw["E"], tau=kw["tau"], rows=rows)
        eye = torch.eye(rows, dtype=torch.bool, device=x.device)
        Ws = [torch.exp(-t * ratio).masked_fill(eye, 0.0)
              for t in kw["thetas"]]
        lfn = lambda: [(W @ AA, W @ yA) for W in Ws]  # noqa: E731
        flops = 2.0 * rows * rows * T * C
        nbytes = 4 * (x.numel() + Y.numel() + G.numel() + M.numel())
        # Device time per call, and the split over the kernel's five
        # kernels (mean µs a launch), from one profile of 10 calls.
        kfn()
        prof = device_profile(torch, lambda: [kfn() for _ in range(10)])
        return dict(
            max_rel_err=err, ms=time_ms(torch, kfn, 20),
            device_ms=prof["device_busy_s"] * 1e3 / 10,
            kernels_us={k: v["mean_us"] for k, v in prof["kernels"].items()},
            one_launch_ms=one_launch_ms(torch, kfn),
            plain_ms=time_ms(torch, pfn, 3), library_ms=time_ms(torch, lfn, 20),
            # The product runs as three TF32 products (the 3×TF32 split) on
            # the tensor cores; the float32 figure is kept beside it.
            bound=bound_ms(nbytes, 3.0 * flops, TF32_FLOPS),
            bound_f32_ms=bound_ms(nbytes, flops)[0],
            shape={"rows": rows, "T": T, "E": E1 - 1, "N": Y.shape[0]})

    x = X[0]
    sweep = shape_timing(x, x[None], dict(E=E_FIXED, tau=1, Tp=1,
                                          thetas=theta_grid,
                                          exclude_self=True))
    lib = shape_timing(x, X, dict(E=E_FIXED, tau=1, Tp=0,
                                  thetas=(SMAP_THETA,), exclude_self=True))
    row = kernel_row("smap_gram", "src/repro_torch/kernels/csrc/smap_gram.cu",
                     "src/repro/kernels/smap_gram.py:49",
                     max(worst, sweep["max_rel_err"], lib["max_rel_err"]),
                     lib["ms"], lib["plain_ms"], lib["bound"],
                     lib["library_ms"], lib["device_ms"],
                     one_launch_ms=lib["one_launch_ms"],
                     bound_f32_ms=lib["bound_f32_ms"],
                     sweep_ms=sweep["ms"], sweep_device_ms=sweep["device_ms"],
                     sweep_library_ms=sweep["library_ms"],
                     sweep_bound_ms=sweep["bound"][0],
                     sweep_bound_f32_ms=sweep["bound_f32_ms"])
    return row, {"small_shapes_max_rel_err": worst, "sweep_shape": sweep,
                 "xmap_library_shape": lib}


def fused_ops(E, Lp):
    """The fused all-kNN's least float32 work: E additions a distance in
    lag order, and a sub and a mul for each pair of lag values, whose
    square serves every distance on its diagonal."""
    return (E + 2.0) * Lp * Lp


def append_ops(N, E_max, L_old, dt, tau=1):
    """Float operations one panel append needs at the least: 3 per lag term
    of every (row, column) squared distance that some level compares, each
    chain carried once to the deepest level that needs it (the levels
    below share it). Old rows need the new columns only: the stored
    candidates' order is known. New rows need every column."""
    import numpy as np

    L_new = L_old + dt
    terms = 0
    rows = np.arange(L_new)
    # Old rows i < L_old − e·τ against the columns new at level e.
    for c in range(max(0, L_old - (E_max - 1) * tau), L_new):
        lv = [e for e in range(E_max)
              if L_old - e * tau <= c < L_new - e * tau]
        if lv:
            deep = np.minimum(lv[-1], (L_old - 1 - rows[:L_old]) // tau)
            terms += int((deep[deep >= lv[0]] + 1).sum())
    # New rows (new at levels [e_lo, e_hi]) against every valid column.
    for i in range(max(0, L_old - (E_max - 1) * tau), L_new):
        e_lo = 0 if i >= L_old else -(-(L_old - i) // tau)
        e_hi = min(E_max - 1, (L_new - 1 - i) // tau)
        if e_lo <= e_hi:
            deep = np.minimum(e_hi, (L_new - 1 - rows) // tau)
            ok = (deep >= e_lo) & (rows != i)
            terms += int((deep[ok] + 1).sum())
    return 3.0 * N * terms


def check_append_kernel(torch, X, knn_multi_e, knn_append, ref):
    """``knn_append`` against its plain version and the cold build, bit for
    bit, both designs: small edge shapes (ties, garbage slots, Δt = 1 and
    Δt > k_m, E = 1, 20 and 32, k 32 and 33, a stored list out of order, a
    root collision, one warp a block), then the append path's shapes (the
    154-series master at L = 1536, E_max = 20, k = 22, grown by each Δt),
    where the kept insertion kernel (the previous design) is timed beside
    the stream kernel. Returns the kernel's row at Δt = 64 and per-Δt
    times."""
    from repro_torch.data.timeseries import root_collision_panel

    def held(Xg, d, i, tau, what, cold=True):
        got = knn_append.master_append(Xg, d, i, tau=tau)
        want = knn_append.plain(Xg, d, i, tau=tau)
        ins = knn_append._launch(Xg, d, i, "insert", tau=tau)
        for a, b, c in zip(got, want, ins):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                fail(f"knn_append's designs and plain version differ at "
                     f"{what}")
        if cold:
            c = knn_multi_e.all_knn_multi_e(Xg, E_max=d.shape[1], tau=tau,
                                            k=d.shape[-1])
            if not (torch.equal(got[0], c[0]) and torch.equal(got[1], c[1])):
                fail(f"knn_append differs from a cold build at {what}")
        return got

    for L_new, E_max, tau, dt, k, tie in (
            (100, 3, 1, 1, 20, True), (211, 6, 1, 64, 20, True),
            (154, 4, 2, 7, 20, False), (400, 1, 1, 32, 20, True),
            (300, 20, 1, 16, 22, False), (30, 4, 2, 2, 25, False),
            (24, 6, 1, 3, 20, True), (300, 32, 1, 40, 32, True),
            (300, 3, 1, 5, 33, True)):
        Xs = X[:4, 100:100 + L_new].contiguous()
        if tie:
            Xs = torch.round(Xs * 8) / 8
        d, i = knn_multi_e.all_knn_multi_e(Xs[:, :L_new - dt], E_max=E_max,
                                           tau=tau, k=k)
        held(Xs, d, i, tau, f"L={L_new}, E_max={E_max}, tau={tau}, dt={dt}, "
                            f"k={k}, ties={tie}")
        if not tie:  # equal stored values keep their slot order: no ties
            perm = torch.randperm(k, generator=torch.Generator().manual_seed(
                k)).to(d.device)
            held(Xs, d[..., perm].contiguous(), i[..., perm].contiguous(),
                 tau, f"an unordered master, L={L_new}", cold=False)
    Xr = torch.as_tensor(root_collision_panel(8, 120, 3, seed=2),
                         device=X.device)
    d, i = knn_multi_e.all_knn_multi_e(Xr[:, :120], E_max=3, k=6)
    held(Xr, d, i, 1, "the root-collision panel")
    # The insertion kernel at one warp a block (the block's room scaled
    # down so that k = 40 fills it; the limit it lifts is k ≤ 29,056).
    Xs = torch.round(X[:3, :150] * 8) / 8
    d, i = knn_multi_e.all_knn_multi_e(Xs[:, :145], E_max=3, k=40)
    want = knn_append.plain(Xs, d, i)
    room = knn_append.SMEM_MAX
    knn_append.SMEM_MAX = 8 * 40
    try:
        got = knn_append._launch(Xs, d, i, "insert")
    finally:
        knn_append.SMEM_MAX = room
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("knn_append's insertion kernel differs at one warp a block")

    N = X.shape[0]
    dM, iM = knn_multi_e.all_knn_multi_e(X[:, :APPEND_L0].contiguous(),
                                         E_max=E_MAX, tau=1, k=K_MASTER)
    per_dt, row = {}, None
    for dt in APPEND_DTS:
        Xg = X[:, :APPEND_L0 + dt].contiguous()
        got = held(Xg, dM, iM, 1, f"the path shape, dt={dt}", cold=False)
        kfn = lambda: knn_append.master_append(Xg, dM, iM, tau=1)  # noqa
        ins = lambda: knn_append._launch(Xg, dM, iM, "insert")  # noqa
        pfn = lambda: knn_append.plain(Xg, dM, iM, tau=1)  # noqa: E731
        bound = bound_ms(Xg.numel() * 4 + dM.numel() * 8 + got[0].numel() * 8,
                         append_ops(N, E_MAX, APPEND_L0, dt))
        per_dt[dt] = {"ms": time_ms(torch, kfn, 10),
                      "device_ms": device_ms(torch, kfn, 5),
                      "insert_device_ms": device_ms(torch, ins, 3),
                      "plain_ms": time_ms(torch, pfn, 1),
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "design": knn_append.route(APPEND_L0 + dt, E_MAX, 1,
                                                 K_MASTER, dt)}
        del got
    # The library yardstick at Δt = 64: torch.topk over the same candidate
    # blocks, every level's old-row merge block in one call and every
    # level's new-row block in another (no tie promise; timed only).
    dt = APPEND_DTS[-1]
    Xg = X[:, :APPEND_L0 + dt].contiguous()
    blocks = [ref.append_candidates(Xg, dM, iM, tau=1, e=e)
              for e in range(E_MAX)]
    old = torch.cat([b[0].reshape(-1, b[0].shape[-1]) for b in blocks])
    new = torch.cat([b[2].reshape(-1, b[2].shape[-1]) for b in blocks])
    del blocks
    lib = time_ms(torch, lambda: (torch.topk(old, K_MASTER, largest=False),
                                  torch.topk(new, K_MASTER, largest=False)),
                  10)
    del old, new
    t = per_dt[dt]
    row = kernel_row("knn_append", "src/repro_torch/kernels/csrc/knn_append.cu",
                     "src/repro/kernels/knn_append.py:44", 0.0, t["ms"],
                     t["plain_ms"], (t["bound_ms"], t["bound_by"]), lib,
                     t["device_ms"], design=t["design"],
                     insert_device_ms=t["insert_device_ms"])
    return row, per_dt


def check_variant_kernels(torch, X, x_long, x_huge, pairwise_dist, knn_fused,
                          topk, ref):
    """The mxu distances within ``MXU_RTOL`` of ‖zᵢ‖² + ‖zⱼ‖² of their plain
    version, the fused kNN bit-equal to its plain version and to the
    two-kernel path (pairwise then top-k kernels): small edge shapes, then
    the series at L = 10,000, E = 20, k = 21. Returns both rows there."""

    def mxu_err(x, E, tau, what):
        got = pairwise_dist.pairwise_distances_mxu(x, E=E, tau=tau)
        want = pairwise_dist.plain_mxu(x, E=E, tau=tau)
        rel = ((got.double() - want.double()).abs()
               / pairwise_dist.mxu_scale(x, E=E, tau=tau))
        worst = float(rel.max())
        if got.shape != want.shape or not worst <= pairwise_dist.MXU_RTOL:
            fail(f"pairwise_mxu differs from its plain version by {worst} "
                 f"of the norm scale at {what}")
        return worst, float((got - want).abs().max())

    def fused_held(x, what, **kw):
        """The routed kernel against its plain version, the two-kernel
        path and the kept insertion kernel (and the selection kernel at a
        small tile, so tiles cut the lag windows, where it takes k)."""
        got = knn_fused.all_knn_fused(x, **kw)
        want = knn_fused.plain(x, **kw)
        D = pairwise_dist.pairwise_distances(x, E=kw["E"], tau=kw["tau"])
        two = topk.topk_select(D, k=kw["k"], max_idx=kw.get("max_idx"),
                               exclude_self=kw.get("exclude_self", True))
        del D
        others = [want, two, knn_fused._launch(x, "insert", **kw)]
        if knn_fused.route(x.shape[0], kw["E"], kw["tau"], kw["k"]) == \
                "select":
            others.append(knn_fused._launch(x, "select", tile_cols=256,
                                            **kw))
        for other in others:
            for a, b in zip(got, other):
                if not torch.equal(a, b):
                    fail(f"knn_fused differs from its plain version, the "
                         f"two-kernel path or its other design at {what}")

    xs = X[5, :300].clone()
    xs[150:190] = xs[10:50]  # a duplicated stretch: exact ties
    worst = 0.0
    for E, tau in ((1, 1), (3, 2), (20, 1)):
        worst = max(worst, mxu_err(xs * 3.0 + 40.0, E, tau,
                                   f"small, E={E}, tau={tau}")[0])
    for kw in (dict(E=1, tau=1, k=2), dict(E=3, tau=2, k=4),
               dict(E=20, tau=1, k=21), dict(E=4, tau=1, k=70, max_idx=30),
               dict(E=3, tau=1, k=9, max_idx=120, exclude_self=False),
               dict(E=4, tau=3, k=32, max_idx=200),
               dict(E=24, tau=1, k=25, exclude_self=False),
               dict(E=2, tau=1, k=6, max_idx=3)):
        fused_held(xs, f"small {kw}", **kw)

    E, k = E_MAX, E_MAX + 1
    L = x_long.shape[0]
    Lp = L - (E - 1)
    rel, err = mxu_err(x_long, E, 1, f"L={L}, E={E}")
    Z = ref.delay_embed(x_long - x_long.mean(), E, 1).contiguous()
    mfn = lambda: pairwise_dist.pairwise_distances_mxu(x_long, E=E)  # noqa
    mxu_row = kernel_row(
        "pairwise_distances_mxu", "src/repro_torch/kernels/csrc/pairwise_mxu.cu",
        "src/repro/kernels/pairwise_dist.py:50", err, time_ms(torch, mfn, 10),
        time_ms(torch, lambda: pairwise_dist.plain_mxu(x_long, E=E, tau=1),
                3),
        bound_ms(L * 4 + Lp * Lp * 4, (2.0 * E + 4) * Lp * Lp),
        time_ms(torch, lambda: torch.cdist(
            Z, Z, compute_mode="use_mm_for_euclid_dist").square(), 10),
        device_ms(torch, mfn, 5))
    del Z
    fused_held(x_long, f"L={L}, E={E}, k={k}", E=E, tau=1, k=k)
    ffn = lambda: knn_fused.all_knn_fused(x_long, E=E, k=k)  # noqa: E731
    ins = lambda: knn_fused._launch(x_long, "insert", E=E, k=k)  # noqa
    long_ms = device_ms(torch, ffn, 5)
    # The variants path's launches: each of the 154 series at L = 1600 for
    # each E of VARIANT_ES, then the long series once.
    n_path = X.shape[0] * len(VARIANT_ES) + 1
    path_ms, path_bound = long_ms, bound_ms(L * 4 + Lp * k * 8,
                                            fused_ops(E, Lp))[0]
    mix = {}
    for Ev in VARIANT_ES:
        Lv = LENGTH - (Ev - 1)
        mix[Ev] = device_ms(torch, lambda Ev=Ev: (
            knn_fused.all_knn_fused(X[0], E=Ev, k=Ev + 1)))
        path_ms += X.shape[0] * mix[Ev]
        path_bound += X.shape[0] * bound_ms(
            LENGTH * 4 + Lv * (Ev + 1) * 8, fused_ops(Ev, Lv))[0]
    # Past the old ceiling (L + 32·k ≤ 58,112 floats): one series of
    # HUGE_L, its rows checked against the plain strict chain for
    # HUGE_ROWS sampled rows only (the full plain matrix would not fit).
    Lh = x_huge.shape[0]
    Lph = Lh - (E - 1)
    (hd, hi), huge_extra = peak_extra(
        torch, lambda: knn_fused.all_knn_fused(x_huge, E=E, k=k))
    rows = torch.randperm(Lph, generator=torch.Generator().manual_seed(SEED)
                          )[:HUGE_ROWS].sort().values.to(X.device)
    rd, ri = ref.all_knn_rows(x_huge, rows, E=E, k=k)
    if not (torch.equal(hd[rows], rd) and torch.equal(hi[rows], ri)):
        fail(f"knn_fused at L={Lh} differs from the plain rows")
    if not huge_extra <= 2 * Lph * k * 8:  # its tables, twice over
        fail(f"knn_fused at L={Lh} allocated {huge_extra} B beside its "
             f"{Lph * k * 8} B of tables")
    del hd, hi, rd, ri
    hfn = lambda: knn_fused.all_knn_fused(x_huge, E=E, k=k)  # noqa: E731
    fused_row = kernel_row(
        "knn_fused", "src/repro_torch/kernels/csrc/knn_fused.cu",
        "src/repro/kernels/knn_fused.py:29", 0.0, time_ms(torch, ffn, 10),
        time_ms(torch, lambda: knn_fused.plain(x_long, E=E, k=k), 2),
        bound_ms(L * 4 + Lp * k * 8, fused_ops(E, Lp)), None, long_ms,
        design=knn_fused.route(L, E, 1, k),
        insert_ms=time_ms(torch, ins, 3), insert_device_ms=device_ms(
            torch, ins, 3),
        path_device_ms=path_ms / n_path, path_bound_ms=path_bound / n_path,
        path_mix_device_ms={f"L{LENGTH}_E{Ev}": v for Ev, v in mix.items()},
        huge_L=Lh, huge_device_ms=device_ms(torch, hfn, 2),
        huge_bound_ms=bound_ms(Lh * 4 + Lph * k * 8, fused_ops(E, Lph))[0],
        huge_extra_bytes=huge_extra, huge_sampled_rows=HUGE_ROWS)
    return [mxu_row, fused_row], {"mxu_small_max_rel_err": worst,
                                  "mxu_long_max_rel_err": rel}


def solve_yardstick(torch, X, smap_gram, groups, theta_grid):
    """The S-Map engine's solve (``cholesky_ex``, then two triangular
    solves) against ``cholesky_ex`` + ``torch.cholesky_solve`` on the same
    Gram matrices, at the path's two largest batched shapes: the fixed-E
    xmap (154 libraries × 1598 rows × 154 targets, E = 3) and the
    θ-sweep of the largest E-group (T = 8, each series its own target)."""
    from repro_torch.core.smap_engine import _ridge_solve

    def alt(G, M):
        E1 = G.shape[-1]
        lam = 1e-6 * (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / E1) \
            + 1e-20
        c, _ = torch.linalg.cholesky_ex(
            G + lam[..., None, None] * torch.eye(E1, device=G.device))
        return torch.cholesky_solve(M.transpose(-1, -2), c)

    E_big = max(groups, key=lambda e: len(groups[e]))
    Xg = X[torch.as_tensor(groups[E_big], device=X.device)]
    shapes = {"xmap_fixed_E": smap_gram.smap_gram(
                  X, X, E=E_FIXED, tau=1, Tp=0, thetas=(SMAP_THETA,)),
              f"sweep_E{E_big}": smap_gram.smap_gram(
                  Xg, Xg[:, None, :], E=E_big, tau=1, Tp=1,
                  thetas=theta_grid)}
    out = {}
    for name, (G, M) in shapes.items():
        diff = float((_ridge_solve(G, M, 1e-6) - alt(G, M)).abs().max())
        out[name] = {"systems": G[..., 0, 0].numel(), "rhs": M.shape[-2],
                     "engine_ms": time_ms(torch, lambda: _ridge_solve(
                         G, M, 1e-6), 5),
                     "cholesky_solve_ms": time_ms(torch, lambda: alt(G, M),
                                                  2),
                     "max_abs_diff": diff}
    return out


def run_append_path(torch, np, panel, dev, EDM, panel_master, knn_append,
                    reset_counts, counts):
    """The streaming append path at Fish1_Normo's shape: bind the first
    ``APPEND_L0`` columns, ``optimal_E()`` (builds the master), then on a
    fresh session holding that cached master each time, ``append`` the
    next Δt columns. The grown master must equal a cold session's on the
    grown panel bit for bit, and ``optimal_E()`` after it the cold E_opt
    and ρ bits; one ``xmap()`` runs. Returns (per-Δt record, launches)."""
    base = EDM(panel[:, :APPEND_L0], E_max=E_MAX)
    base.optimal_E()
    hit = base._cache["master"]

    def warm():  # a session holding the cached master; append makes new
        s = EDM(panel[:, :APPEND_L0], E_max=E_MAX)  # tensors, so the
        s._cache["master"] = hit  # base's are never changed
        return s

    out, launches = {}, {}
    for dt in APPEND_DTS:
        delta = panel[:, APPEND_L0:APPEND_L0 + dt]
        grown = panel[:, :APPEND_L0 + dt]
        s = warm()
        reset_counts()
        _, peak = peak_extra(torch, lambda: s.append(delta))
        c = {n: v for n, v in counts().items() if v}
        if c.get("knn_append", 0) != 1:
            fail(f"append of dt={dt} launched {c}, not one knn_append")
        for n, v in c.items():
            launches[n] = launches.get(n, 0) + v
        cold = EDM(grown, E_max=E_MAX)
        E_c, rho_c = cold.optimal_E()
        wm, cm = s._cache["master"], cold._cache["master"]
        same = torch.equal(wm[0], cm[0]) and torch.equal(wm[1], cm[1])
        if not same:
            fail(f"the grown master at dt={dt} differs from a cold build")
        E_w, rho_w = s.optimal_E()
        if not (np.array_equal(E_w, E_c) and np.array_equal(rho_w, rho_c)):
            fail(f"optimal_E after the append of dt={dt} differs from the "
                 f"cold session's")
        xm = s.xmap()
        if xm.shape != (N_SERIES, N_SERIES) or not np.isfinite(xm).all():
            fail(f"xmap after the append of dt={dt}: malformed")
        sessions = [warm() for _ in range(RUNS)]
        t_app = [host_s(torch, lambda w=w: w.append(delta))[1]
                 for w in sessions]
        Xg = torch.as_tensor(grown, device=dev)
        t_cold = [host_s(torch, lambda: panel_master(
            Xg, E_max=E_MAX, tau=1, k=K_MASTER, impl="auto"))[1]
            for _ in range(RUNS)]
        w = warm()
        prof = device_profile(torch, lambda: w.append(delta))
        out[dt] = {"append_s": spread(t_app), "cold_master_s": spread(t_cold),
                   "speedup_median": statistics.median(t_cold)
                   / statistics.median(t_app),
                   "launches": c, "device_busy_s": prof["device_busy_s"],
                   "idle_share": prof["idle_share"],
                   "device_kernels": prof["kernels"],
                   "peak_extra_bytes": peak, "master_bit_equal_cold": same,
                   "E_opt_equal": True, "rho_bit_equal": True}
        del s, cold, sessions, w, wm, cm
    return out, launches


def run_variants_path(torch, X, x_long, core, ops, pairwise_dist, ref,
                      reset_counts, counts):
    """``core.all_knn(x, E=E, variant="mxu")`` and ``ops.all_knn(x, E=E,
    fused=True)`` over the 154 series at L = 1600 for E = 3 and 20, and
    over one series at L = 10,000 (E = 20), with the launches of those
    calls. Then, against the two-kernel vpu tables: fused bit-equal, mxu's
    index sets equal wherever the k-th and (k+1)-th distances are further
    apart than twice the mxu tolerance; and the device memory of the fused
    and the two-kernel calls at L = 10,000."""
    series = [(E, s) for E in VARIANT_ES for s in range(X.shape[0])]
    reset_counts()
    outs = {}
    for E, s in series:
        outs[E, s] = (core.all_knn(X[s], E=E, variant="mxu"),
                      ops.all_knn(X[s], E=E, fused=True))
    outs["long"] = (core.all_knn(x_long, E=E_MAX, variant="mxu"),
                    ops.all_knn(x_long, E=E_MAX, fused=True))
    torch.cuda.synchronize()
    launches = {n: v for n, v in counts().items() if v}
    want = {"pairwise_distances_mxu": len(series) + 1,
            "topk_select": len(series) + 1, "knn_fused": len(series) + 1}
    if launches != want:
        fail(f"the variants path launched {launches}, not {want}")

    clear = rows = 0
    for key, (mxu, fused) in outs.items():
        x, E = (x_long, E_MAX) if key == "long" else (X[key[1]], key[0])
        k = E + 1
        vd, vi = ops.all_knn(x, E=E, k=k + 1)  # one more: the gap
        if not (torch.equal(fused[0], vd[:, :k]) and
                torch.equal(fused[1], vi[:, :k])):
            fail(f"fused all_knn differs from the two-kernel path at {key}")
        xd = x.double()
        Zc = ref.delay_embed(xd - xd.mean(), E, 1)
        n = (Zc * Zc).sum(-1)
        sq = vd.double() ** 2
        tol = pairwise_dist.MXU_RTOL * (n[:, None] + n[vi[:, k - 1:k + 1]
                                                       .long()])
        ok = (sq[:, k] - sq[:, k - 1]) > 2 * tol.max(dim=1).values
        got = torch.sort(mxu.idx[ok], dim=1).values
        if not torch.equal(got, torch.sort(vi[ok, :k], dim=1).values):
            fail(f"mxu neighbour sets differ from vpu's away from near-ties "
                 f"at {key}")
        clear += int(ok.sum())
        rows += ok.numel()

    Lp = x_long.shape[0] - (E_MAX - 1)
    fused_peak = peak_extra(torch, lambda: ops.all_knn(x_long, E=E_MAX,
                                                       fused=True))[1]
    two_peak = peak_extra(torch, lambda: ops.all_knn(x_long, E=E_MAX))[1]
    if not fused_peak < 4 * Lp * Lp:
        fail(f"fused all_knn at L={x_long.shape[0]} allocated {fused_peak} "
             f"B: an (Lp, Lp) buffer is {4 * Lp * Lp} B")
    calls = {f"mxu_E{E}": lambda E=E: core.all_knn(X[0], E=E, variant="mxu")
             for E in VARIANT_ES}
    calls.update({f"fused_E{E}": lambda E=E: ops.all_knn(X[0], E=E,
                                                         fused=True)
                  for E in VARIANT_ES})
    calls.update({f"vpu_E{E}": lambda E=E: ops.all_knn(X[0], E=E)
                  for E in VARIANT_ES})
    calls["mxu_long"] = lambda: core.all_knn(x_long, E=E_MAX, variant="mxu")
    calls["fused_long"] = lambda: ops.all_knn(x_long, E=E_MAX, fused=True)
    calls["vpu_long"] = lambda: ops.all_knn(x_long, E=E_MAX)
    for fn in calls.values():
        fn()
    # Device time of each variant over the 154 series at E = 20.
    prof = {name: device_profile(torch, lambda fn=fn: [
        fn(X[s]) for s in range(X.shape[0])]) for name, fn in (
            ("mxu_154_E20", lambda x: core.all_knn(x, E=E_MAX,
                                                   variant="mxu")),
            ("fused_154_E20", lambda x: ops.all_knn(x, E=E_MAX, fused=True)),
            ("vpu_154_E20", lambda x: ops.all_knn(x, E=E_MAX)))}
    return {"launches": launches, "device_profile": prof,
            "seconds_per_call": {n: spread([host_s(torch, fn)[1]
                                            for _ in range(RUNS)])
                                 for n, fn in calls.items()},
            "mxu_rows_away_from_near_ties": clear, "mxu_rows": rows,
            "long_L": x_long.shape[0], "long_fused_peak_extra_bytes": fused_peak,
            "long_two_kernel_peak_extra_bytes": two_peak,
            "long_distance_matrix_bytes": 4 * Lp * Lp}, launches


def journal_child(root, mode, run_dir, B, extra=()):
    """Run ``JOURNAL_CHILD`` in a fresh process → (return code, its record
    or None, its stderr's tail). It loads the kernels the parent built."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run(
        [sys.executable, "-c", JOURNAL_CHILD, mode, run_dir,
         *(str(v) for v in (N_SERIES, LENGTH, SEED, E_FIXED, B)),
         *(str(v) for v in extra)],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    rec = None
    for line in res.stdout.splitlines():
        if line.startswith('{"journal_child"'):
            rec = json.loads(line)["journal_child"]
    return res.returncode, rec, res.stderr[-3000:]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def journal_breakdown(torch, fn):
    """Host seconds and calls of the journal's parts in one call of
    ``fn``: each part's function wrapped with a host clock (nested parts
    counted in their callers too: ``_snapshot`` holds ``save`` and
    ``write_report``, which holds ``render_prom``)."""
    from repro_torch import telemetry
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import Heartbeat
    from repro_torch.edm import runner

    parts = [(runner, "run_key"), (runner.MatrixRunner, "__init__"),
             (runner.MatrixRunner, "_snapshot"), (CheckpointManager, "save"),
             (runner.MatrixRunner, "write_report"), (telemetry, "render_prom"),
             (Heartbeat, "beat"), (telemetry.JsonlSink, "emit"),
             (runner.MatrixRunner, "finalize")]
    acc = {attr: [0.0, 0] for _, attr in parts}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in parts]

    def timed(attr, orig):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                acc[attr][0] += time.perf_counter() - t0
                acc[attr][1] += 1
        return wrapper

    for owner, attr, orig in saved:
        setattr(owner, attr, timed(attr, orig))
    try:
        _, total = host_s(torch, fn)
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)
    return {"total_s": total, **{a: {"s": v[0], "calls": v[1]}
                                 for a, v in acc.items()}}


def run_journal_path(torch, np, panel, root, X, EDM, core, reset_counts,
                     counts, xm, xm3, xs3):
    """The journaled ``xmap(run_dir=)`` at Fish1_Normo's shape, under
    temporary run dirs: both simplex routes and the fixed-E S-Map route
    bit-equal to the plain calls, a finished journal relaunching nothing,
    its artifacts through the schema and the inspector; a child preempted
    by SIGTERM (exit 17) and resumed by another at a different B; a child
    whose allocator cap the first batch cannot fit (a real
    ``torch.cuda.OutOfMemoryError``: B halves); ``ccm_group`` and
    ``ccm_group_from_master`` on 8 libraries against the batched engines;
    then the journaled against the plain wall times and the snapshots a
    run writes. Returns (record, the path's launches)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.edm import PREEMPTED_EXIT
    from repro_torch.edm import inspect as edm_inspect
    from repro_torch.edm.plan import (ccm_group_from_master,
                                      ccm_group_from_master_batched)
    from repro_torch.telemetry import schema

    saves = {"n": 0}
    orig_save = CheckpointManager.save

    def counting_save(self, step, state):
        saves["n"] += 1
        return orig_save(self, step, state)

    def journaled(fn, run_dir):
        saves["n"] = 0
        out, sec = host_s(torch, lambda: fn(run_dir))
        return out, sec, saves["n"]

    CheckpointManager.save = counting_save
    tmp = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    rec, runs = {}, iter(range(10**6))

    def fresh():
        return os.path.join(tmp, f"run{next(runs)}")

    try:
        # Master route: optimal_E, then the journaled xmap, then again.
        reset_counts()
        js = EDM(panel, E_max=E_MAX)
        js.optimal_E()
        run_a = fresh()
        ja, t_ja, snaps_a = journaled(lambda d: js.xmap(run_dir=d), run_a)
        if not np.array_equal(ja, xm):
            fail("journaled master-route xmap differs from the plain xmap")
        master_launches = {n: c for n, c in counts().items() if c}
        before = counts()
        again = js.xmap(run_dir=run_a)
        relaunched = {n: c - before[n] for n, c in counts().items()
                      if c != before[n]}
        if relaunched or js.stats["runs_short_circuited"] != 1:
            fail(f"a finished journal launched {relaunched}")
        if not np.array_equal(again, xm):
            fail("the finished journal's matrix differs from the plain xmap")
        report = read_json(os.path.join(run_a, "report.json"))
        errs = schema.validate_events_file(
            os.path.join(run_a, "telemetry", "events.jsonl"))
        info = edm_inspect.inspect_run(run_a)
        if report["status"] != "complete" or errs:
            fail(f"master journal: status {report['status']}, schema "
                 f"{errs[:3]}")
        if not (info["rows_total"] and info["rows_done"]
                == info["rows_total"]):
            fail(f"inspect_run reads {info['rows_done']} of "
                 f"{info['rows_total']} rows")
        rec["master"] = {"groups": read_json(
            os.path.join(run_a, "run.json"))["groups"],
            "tiles": report["tiles_committed"], "snapshots": snaps_a,
            "launches": master_launches, "relaunched": relaunched,
            "inspect": next(line for line in edm_inspect.format_summary(
                info).splitlines() if line.startswith("rows:"))}

        # Direct and S-Map routes.
        before = counts()
        jd, _, snaps_d = journaled(
            lambda d: EDM(panel, E=E_FIXED).xmap(run_dir=d), fresh())
        if not np.array_equal(jd, xm3):
            fail("journaled direct-route xmap differs from the plain xmap")
        jsm, _, snaps_s = journaled(
            lambda d: EDM(panel, E=E_FIXED).xmap(method="smap", run_dir=d),
            fresh())
        if not np.array_equal(jsm, xs3):
            fail("journaled S-Map xmap differs from the plain xmap")
        rec["direct"] = {"snapshots": snaps_d}
        rec["smap"] = {"snapshots": snaps_s}

        # The per-series legacy forms on 8 libraries at E = 3.
        li = torch.as_tensor(np.linspace(0, N_SERIES - 1, CCM_GROUP_LIBS)
                             .round().astype(np.int64), device=X.device)
        g1 = core.ccm_group(X[li], X, E=E_FIXED).cpu().numpy()
        g2 = core.ccm_group_batched(X[li], X, E=E_FIXED)
        iM = js._master(E_FIXED)[1][:, E_FIXED - 1]
        kw = dict(E=E_FIXED, tau=1, Tp=0, k=E_FIXED + 1, impl="auto")
        h1 = ccm_group_from_master(X[li], iM[li], X, **kw).cpu().numpy()
        h2 = ccm_group_from_master_batched(X[li], iM[li], X, **kw)
        if not np.array_equal(g1, g2):
            fail("ccm_group differs from ccm_group_batched")
        if not np.array_equal(h1, h2):
            fail("ccm_group_from_master differs from its batched engine")
        rec["ccm_group"] = {"libraries": li.tolist(),
                            "from_master_equals_direct":
                                bool(np.array_equal(g1, h1))}
        launches = counts()
        rec["launches"] = {n: c for n, c in launches.items() if c}
        rec["launches_direct_smap_ccm_group"] = {
            n: c - before[n] for n, c in launches.items() if c != before[n]}

        # Preemption: SIGTERM at the second launch, exit 17, resume at
        # another B; the resumed matrix must be the plain one's bits.
        run_k = fresh()
        os.makedirs(run_k)
        rc, _, err = journal_child(root, "kill", run_k, JOURNAL_B)
        killed = read_json(os.path.join(run_k, "report.json"))
        if rc != PREEMPTED_EXIT or killed["status"] != "preempted":
            fail(f"the preempted child exited {rc} with journal status "
                 f"{killed['status']}: {err}")
        rc, child, err = journal_child(root, "resume", run_k,
                                       JOURNAL_RESUME_B)
        if rc != 0 or child is None:
            fail(f"the resuming child exited {rc}: {err}")
        left = N_SERIES - killed["rows_done"]
        want = -(-left // JOURNAL_RESUME_B)
        if (child["launches"]["knn_batch"] != want
                or child["launches"]["lookup_rho"] != want):
            fail(f"the resume launched {child['launches']} for {left} rows "
                 f"at B = {JOURNAL_RESUME_B}, not {want} of each")
        if not np.array_equal(np.load(os.path.join(run_k, "resume.npy")),
                              xm3):
            fail("the resumed matrix differs from the uninterrupted one")
        log = os.path.join(run_k, "telemetry", "events.jsonl")
        with open(log) as f:
            names = [json.loads(line)["name"] for line in f]
        if "run.resume" not in names or schema.validate_events_file(log):
            fail("the resumed journal's event log lacks run.resume or "
                 "fails the schema")
        resumed = read_json(os.path.join(run_k, "report.json"))
        rec["preempt"] = {"B": JOURNAL_B, "resume_B": JOURNAL_RESUME_B,
                          "rows_done_at_preempt": killed["rows_done"],
                          "resume_launches": child["launches"],
                          "resume_s": child["seconds"],
                          "rows_resumed": resumed["rows_resumed"],
                          "attempts": len(read_json(os.path.join(
                              run_k, "run.json"))["attempts"])}

        # A real CUDA OOM on the S-Map route.
        run_o = fresh()
        os.makedirs(run_o)
        rc, child, err = journal_child(root, "oom", run_o, 0,
                                       (OOM_CAP_SHARE,))
        if rc != 0 or child is None:
            fail(f"the OOM child exited {rc}: {err}")
        trail = read_json(os.path.join(run_o, "report.json"))["oom_backoff"]
        actions = [t["action"] for t in trail]
        if "halve" not in actions or "unclassified" in actions:
            fail(f"the OOM child's backoff trail is {trail}")
        if not (child["equal_uncapped"] and np.array_equal(
                np.load(os.path.join(run_o, "oom.npy")), xs3)):
            fail("the capped S-Map xmap differs from the uncapped one")
        rec["oom"] = {"route": "xmap(method='smap'), E = 3, B = N first",
                      "cap_share": OOM_CAP_SHARE, **child,
                      "trail": [{k: t[k] for k in ("action", "B", "to_B")
                                 if k in t} for t in trail],
                      "first_error": trail[0]["error"]}

        # Wall times, plain and journaled in turns; snapshots per run.
        calls = {
            "master": (js.xmap, lambda d: js.xmap(run_dir=d)),
            "direct": (lambda: EDM(panel, E=E_FIXED).xmap(),
                       lambda d: EDM(panel, E=E_FIXED).xmap(run_dir=d)),
            "smap": (lambda: EDM(panel, E=E_FIXED).xmap(method="smap"),
                     lambda d: EDM(panel, E=E_FIXED).xmap(method="smap",
                                                          run_dir=d))}
        for name, (plain, jour) in calls.items():
            t_p, t_j, snaps = [], [], []
            for _ in range(RUNS):
                t_p.append(host_s(torch, plain)[1])
                _, sec, n = journaled(jour, fresh())
                t_j.append(sec)
                snaps.append(n)
            ratio = statistics.median(t_j) / statistics.median(t_p)
            rec[name].update(
                plain_s=spread(t_p), journaled_s=spread(t_j),
                snapshots_per_run=snaps, overhead_median=ratio,
                overhead_vs_bound={"overhead": ratio - 1.0,
                                   "bound": RESUME_OVERHEAD_MAX,
                                   "within": ratio - 1.0
                                   <= RESUME_OVERHEAD_MAX},
                breakdown=journal_breakdown(
                    torch, lambda: jour(fresh())))
        rec["bench_resume_row"] = bench_resume_row(torch, EDM)
    finally:
        CheckpointManager.save = orig_save
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, launches


def agreement(np, got, want, tol):
    """How ``got`` stands to ``want``: bit-equal, or the largest
    difference beside ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return {"shape": [list(got.shape), list(want.shape)],
                "within": False}
    if np.array_equal(got, want):
        return {"bit_equal": True, "within": True}
    err = float(np.abs(got.astype(np.float64) - want).max())
    return {"bit_equal": False, "max_abs_err": err, "tol": tol,
            "within": err <= tol}


def run_sharded_path(torch, np, panel, root, X, E_opt, EDM, core,
                     reset_counts, counts):
    """``EDMConfig(mesh=...)`` at Fish1_Normo's shape: (a) a world of one
    (NCCL, started by ``make_ccm_mesh``) against the local engines, timed
    and profiled; (b) four gloo ranks on the one card (``SHARDED_CHILD``)
    against (a). Returns (record, the world of one's launches)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.smap_engine import DEFAULT_THETAS
    from repro_torch.distributed import (gather_host, make_ccm_mesh,
                                         sharded_ccm_convergence,
                                         sharded_optimal_E,
                                         sharded_smap_theta)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    runs = iter(range(10**6))

    def fresh():
        return os.path.join(tmp, f"run{next(runs)}")

    rec = {}
    try:
        # (a) a world of one; the counted run of the path.
        t0 = time.perf_counter()
        mesh = make_ccm_mesh((1, 1), ("data", "model"))
        rec["world_of_one_init_s"] = time.perf_counter() - t0
        rec["backend"] = str(dist.get_backend())
        calls = {
            "optimal_E": lambda: EDM(panel, E_max=E_MAX,
                                     mesh=mesh).optimal_E(),
            "xmap": lambda: ms.xmap(),
            "xmap_smap": lambda: ms.xmap(method="smap"),
            "smap": lambda: ms.smap(),
            "xmap_fixed_E": lambda: EDM(panel, E=E_FIXED, mesh=mesh).xmap(),
            "ccm_convergence": lambda: gather_host(sharded_ccm_convergence(
                X[:CCM_GROUP_LIBS], X, E=E_FIXED, lib_sizes=LIB_SIZES,
                mesh=mesh)),
            "xmap_journaled": lambda: ms.xmap(run_dir=fresh()),
            "optimal_E_direct": lambda: [gather_host(t) for t in
                                         sharded_optimal_E(
                                             X, E_max=E_MAX, mesh=mesh,
                                             axes=("data",))],
            "smap_theta_direct": lambda: gather_host(sharded_smap_theta(
                X, E=E_FIXED, mesh=mesh, axes=("data",)))}
        reset_counts()
        ms = EDM(panel, E_max=E_MAX, mesh=mesh)
        out, per_call, first_s = {}, {}, {}
        # counted: the session's own optimal_E, whose E_opt its xmaps use
        for name, fn in dict(calls, optimal_E=ms.optimal_E).items():
            before = counts()
            out[name], first_s[name] = host_s(torch, fn)
            per_call[name] = {n: c - before[n] for n, c in counts().items()
                              if c != before[n]}
        launches = counts()
        for name in ("knn_multi_e", "lookup_rho", "knn_batch",
                     "pairwise_distances", "topk_select_sizes", "smap_gram"):
            if launches[name] <= 0:
                fail(f"the sharded path launched {name} no time")
        E_m, rho_m = out["optimal_E"]
        if rho_m.shape != (N_SERIES, E_MAX) or not np.isfinite(rho_m).all():
            fail("sharded optimal_E: shape or non-finite values")
        for name in ("xmap", "xmap_smap", "xmap_fixed_E", "xmap_journaled"):
            m = out[name]
            if m.shape != (N_SERIES, N_SERIES) or not np.isfinite(m).all():
                fail(f"sharded {name}: shape {m.shape} or non-finite values")

        # Against the local engines (not counted).
        loc = EDM(panel, E_max=E_MAX, cache=False)
        E_l, rho_l = loc.optimal_E()
        cv_l = torch.stack([core.ccm_convergence(
            x, X, E=E_FIXED, lib_sizes=LIB_SIZES) for x in X[:CCM_GROUP_LIBS]],
            dim=1).cpu().numpy()
        th = smap_rho_tol(SMAP_THETA)
        sw_tol = min(smap_rho_tol(t) for t in DEFAULT_THETAS)
        checks = {
            "E_opt_equal_local": bool((E_m == E_l).all()),
            "E_opt_equal_cached_session": bool((E_m == E_opt).all()),
            "rho_E": agreement(np, rho_m, rho_l, RHO_ATOL),
            "xmap": agreement(np, out["xmap"], loc.xmap(), RHO_ATOL),
            "xmap_smap": agreement(np, out["xmap_smap"],
                                   loc.xmap(method="smap"), th),
            "smap": agreement(np, out["smap"], loc.smap(), sw_tol),
            "xmap_fixed_E": agreement(np, out["xmap_fixed_E"], EDM(
                panel, E=E_FIXED, cache=False).xmap(), RHO_ATOL),
            "xmap_fixed_E_core": agreement(
                np, out["xmap_fixed_E"], core.ccm_group_batched(
                    X, X, E=E_FIXED), RHO_ATOL),
            "ccm_convergence_core": agreement(
                np, out["ccm_convergence"], cv_l, RHO_ATOL),
            "xmap_journaled_vs_plain": agreement(
                np, out["xmap_journaled"], out["xmap"], 0.0),
            "optimal_E_direct": agreement(
                np, out["optimal_E_direct"][1], rho_l, RHO_ATOL),
            "smap_theta_direct_core": agreement(
                np, out["smap_theta_direct"], core.smap_theta_sweep(
                    X, E=E_FIXED).cpu().numpy(), sw_tol)}
        rec["world_of_one"] = {
            "first_run_s": first_s, "launches_per_call": per_call,
            "launches": {n: c for n, c in launches.items() if c},
            "checks": checks}
        if not (checks["E_opt_equal_local"]
                and checks["E_opt_equal_cached_session"]):
            fail("sharded optimal_E's E_opt differs from the local runs'")
        for name, c in checks.items():
            if isinstance(c, dict) and not c["within"]:
                fail(f"sharded {name}: {c}")

        # Timed runs (the counted run was the warm-up), then profiled.
        timed = {name: [host_s(torch, fn)[1] for _ in range(RUNS)]
                 for name, fn in calls.items()}
        rec["world_of_one"]["seconds_per_call"] = {
            n: spread(v) for n, v in timed.items()}
        rec["world_of_one"]["pairs_per_s"] = {
            n: N_SERIES * N_SERIES / statistics.median(timed[n])
            for n in ("xmap", "xmap_smap", "xmap_fixed_E")}
        rec["world_of_one"]["device_profile"] = {
            name: device_profile(torch, fn) for name, fn in calls.items()}

        # (b) four ranks on the one card: gloo, one process a rank.
        ref_ = {"E_opt": E_m, "rho_E": rho_m, "xmap": out["xmap"],
                "xmap_smap": out["xmap_smap"],
                "xmap_journaled": out["xmap"],
                "E_opt_direct": out["optimal_E_direct"][0],
                "rho_E_direct": out["optimal_E_direct"][1],
                "smap_theta": out["smap_theta_direct"]}
        wd = tempfile.mkdtemp(prefix="world_", dir=tmp)
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", SHARDED_CHILD, str(r), "4", wd,
             *(str(v) for v in (N_SERIES, LENGTH, SEED, E_MAX, E_FIXED))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(4)]
        results = []
        try:
            for p in procs:
                o, e = p.communicate(timeout=CHILD_TIMEOUT_S)
                results.append((p.returncode, o, e))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        child = {}
        for r, (rc, o, e) in enumerate(results):
            if rc != 0:
                fail(f"sharded rank {r} exited {rc}: {e[-2000:]}")
            for line in o.splitlines():
                if line.startswith('{"sharded_child"'):
                    child[r] = json.loads(line)["sharded_child"]
        if sorted(child) != [0, 1, 2, 3]:
            fail(f"sharded ranks printed no record: {sorted(child)}")
        # A rank whose share of an E-group is one target solves one
        # right-hand side, which the solve may round on another path.
        split_rhs = RHO_ATOL
        ranks_vs_one = {}
        for r in range(4):
            got = np.load(os.path.join(wd, f"rank{r}.npz"))
            ranks_vs_one[r] = {
                name: agreement(np, got[name], want,
                                split_rhs if name == "xmap_smap" else 0.0)
                for name, want in ref_.items()}
            for name, c in ranks_vs_one[r].items():
                if not c["within"]:
                    fail(f"sharded rank {r}: {name} against the world of "
                         f"one: {c}")
        summed = {}
        for c in child.values():
            for n, v in c["launches"].items():
                summed[n] = summed.get(n, 0) + v
        rec["four_ranks"] = {
            "backend": "gloo", "meshes": ["(2, 2) data×model", "(4,) data"],
            "padded_rows": child[0]["padded_rows"],
            "rank0_seconds": child[0]["seconds"], "parent_wall_s": wall,
            "seconds_by_rank": {r: c["seconds"] for r, c in child.items()},
            "launches_summed": summed, "vs_world_of_one": ranks_vs_one}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, launches


def run_serving_path(torch, np, root, EDM, reset_counts, counts, set_counts):
    """The EDM server (``repro_torch.serving``) on the card at Fish1_Normo's
    shape: ``EDMServer(workers=4)`` with the panel (E_max = 20, cached);
    8 client threads ask 64 distinct ``ccm`` pairs at their E_opt, each
    answer bit-equal to ``ccm_batch([(l, t)], E=)`` on a direct session;
    append ticks of Δt = 1 and 16, each followed by queries bit-equal to a
    cold session on the grown panel and one subscription's tick; a second
    panel under a master budget of 1.5 masters evicts the first, whose
    lazy rebuild answers the same bits; ``serve_http`` on loopback
    (``/healthz``, ``ccm``, an append); a durable child server killed with
    SIGKILL between append ticks and recovered with ``EDMServer.recover``,
    bit-equal to a never-crashed session. The oracles' launches are not
    counted. Returns (record, the path's launches)."""
    import shutil
    import signal
    import tempfile
    import threading
    import urllib.request

    from repro_torch.data.timeseries import forced_network_panel
    from repro_torch.serving import EDMServer, serve_http

    grow = sum(SERVE_DTS) + 1 + SERVE_KILL_TICKS
    full = forced_network_panel(N_SERIES, LENGTH + grow, seed=SEED)[0]
    panel = full[:, :LENGTH]
    wait_s = CHILD_TIMEOUT_S

    def uncounted(fn):
        torch.cuda.synchronize()
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        set_counts(before)
        return out

    def oracle(L, asked, E_of=None):
        """A direct session on the first L columns: E_opt, ρ(E), and the
        singleton ``ccm_batch`` of each asked pair at ``E_of`` of its
        target (default: the session's own E_opt)."""
        def run():
            d = EDM(full[:, :L], E_max=E_MAX)
            E_d, rho_d = d.optimal_E()
            E_t = E_d if E_of is None else E_of
            return E_d, rho_d, {p: np.float32(d.ccm_batch(
                [p], E=int(E_t[p[1]]))[0]) for p in asked}
        return uncounted(run)

    rng = np.random.default_rng(SEED)
    pairs = []
    for f in rng.permutation(N_SERIES * N_SERIES):
        lib, tgt = divmod(int(f), N_SERIES)
        if lib != tgt:
            pairs.append((lib, tgt))
        if len(pairs) == SERVE_PAIRS:
            break
    E_opt, rho0, want0 = oracle(LENGTH, pairs)

    batches = []
    srv = EDMServer(workers=SERVE_WORKERS)
    orig_execute = srv.scheduler._execute

    def execute(batch, pq=None):
        batches.append((batch[0].op, len(batch)))
        return orig_execute(batch, pq)

    srv.scheduler._execute = execute

    def call(op, name="fish", **kw):
        return srv.call(op, name, timeout=wait_s, **kw)

    def stream(asked, name="fish"):
        """The clients' queries → ({pair: ρ}, latencies s, wall s)."""
        got, lat, errs = {}, [], []
        chunks = [asked[i::SERVE_CLIENTS] for i in range(SERVE_CLIENTS)]

        def client(chunk):
            try:
                for lib, tgt in chunk:
                    a = time.perf_counter()
                    r = call("ccm", name, lib=lib, target=tgt,
                             E=int(E_opt[tgt]))
                    lat.append(time.perf_counter() - a)
                    got[(lib, tgt)] = np.float32(r)
            except Exception as exc:  # noqa: BLE001 — reported below
                errs.append(exc)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in chunks]
        a = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=wait_s)
        wall = time.perf_counter() - a
        if errs or any(t.is_alive() for t in threads):
            fail(f"serving clients failed: {errs[:3]}")
        return got, lat, wall

    def until(cond, what):
        deadline = time.monotonic() + wait_s
        while not cond():
            if time.monotonic() > deadline:
                fail(f"serving: {what} did not happen")
            time.sleep(0.001)

    def check(got, want, what):
        bad = [p for p in want if got[p] != want[p]]
        if bad:
            fail(f"serving, {what}: {len(bad)} answers differ from the "
                 f"direct session's, e.g. {bad[0]}: {got[bad[0]]} != "
                 f"{want[bad[0]]}")

    out = {"workers": SERVE_WORKERS, "clients": SERVE_CLIENTS,
           "pairs": len(pairs)}
    reset_counts()
    try:
        srv.register_panel("fish", panel, E_max=E_MAX, cache=True)
        (E_s, rho_s), t_opt = host_s(torch, lambda: call("optimal_E"))
        if not (np.array_equal(E_s, E_opt) and np.array_equal(rho_s, rho0)):
            fail("the served optimal_E differs from the direct session's")
        got, _, _ = stream(pairs)
        check(got, want0, "the first query stream")
        del batches[:]
        lat, walls = [], []
        for _ in range(RUNS):
            got, ls, wall = stream(pairs)
            check(got, want0, "a timed query stream")
            lat += ls
            walls.append(wall)
        sizes = [n for op, n in batches if op == "ccm"]
        prof = device_profile(torch, lambda: stream(pairs))
        out["query"] = {
            "optimal_E_s": t_opt, "stream_s": spread(walls),
            "requests_per_s": len(pairs) / statistics.median(walls),
            "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "latency_max_ms": max(lat) * 1e3, "requests": len(lat),
            "batch_sizes": {int(k): int(v) for k, v in zip(*np.unique(
                sizes, return_counts=True))},
            "batches": len(sizes), "mean_batch": float(np.mean(sizes)),
            "device_busy_s": prof["device_busy_s"],
            "idle_share": prof["idle_share"], "wall_s": prof["wall_s"],
            "device_kernels": prof["kernels"]}

        # Append ticks, each followed by queries and a subscription tick.
        watch = pairs[:SERVE_SUB_PAIRS]
        sub = srv.subscribe("fish", watch)
        if [np.float32(v) for v in sub["rho"]] != [want0[p] for p in watch]:
            fail("the subscription's baseline differs from the direct "
                 "session's")
        sub_q = srv.subscription(sub["id"])
        sub_q.poll(timeout=wait_s)
        asked = pairs[:SERVE_TICK_PAIRS]
        L, ticks, want = LENGTH, {}, {}
        for dt in SERVE_DTS:
            delta = full[:, L:L + dt]
            res, t_app = host_s(torch, lambda: call("append", delta=delta))
            L += dt
            got, lat_t, wall_t = stream(asked)
            tick = sub_q.poll(timeout=wait_s)
            _, _, want = oracle(L, asked, E_opt)
            check(got, want, f"after the append of dt={dt}")
            if (len(tick) != 1 or tick[0]["version"] != res["version"]
                    or tick[0]["L"] != L
                    or [np.float32(v) for v in tick[0]["rho"]]
                    != [want[p] for p in watch]):
                fail(f"the subscription's tick after dt={dt} is {tick}")
            ticks[dt] = {"append_call_ms": t_app * 1e3,
                         "version": res["version"], "L": res["L"],
                         "queries_s": wall_t,
                         "latency_max_ms": max(lat_t) * 1e3}
        out["ticks"] = ticks

        # A second panel under a budget below both masters: one eviction.
        entry = srv.registry.get("fish")
        one = entry.master_nbytes()
        srv.registry.set_budget(int(SERVE_BUDGET * one))
        evictions = []
        orig_evict = EDM.evict_master

        def evict(self):
            torch.cuda.synchronize()
            m0, a = torch.cuda.memory_allocated(), time.perf_counter()
            freed = orig_evict(self)
            torch.cuda.synchronize()
            evictions.append({"freed_bytes": freed,
                              "allocated_drop_bytes":
                                  m0 - torch.cuda.memory_allocated(),
                              "ms": (time.perf_counter() - a) * 1e3})
            return freed

        EDM.evict_master = evict
        try:
            srv.register_panel("fish_b", forced_network_panel(
                N_SERIES, LENGTH, seed=SEED + 1)[0], E_max=E_MAX,
                cache=True)
            _, t_b = host_s(torch, lambda: call("optimal_E", "fish_b"))
            # The budget is enforced after the batch's futures resolve.
            until(lambda: evictions, "the budget's eviction")
            if (entry.master_nbytes() != 0 or entry.evictions != 1
                    or len(evictions) != 1
                    or evictions[0]["freed_bytes"] != one
                    or evictions[0]["allocated_drop_bytes"] < one):
                fail(f"the budget's eviction: {evictions}, fish holds "
                     f"{entry.master_nbytes()} of {one} bytes")
            first = asked[0]
            before = counts()
            r0, t_rebuild = host_s(torch, lambda: call(
                "ccm", lib=first[0], target=first[1],
                E=int(E_opt[first[1]])))
            rebuild = {n: c - before[n] for n, c in counts().items()
                       if c != before[n]}
            got, _, _ = stream(asked)
            got[first] = np.float32(r0)
            check(got, want, "after the eviction and rebuild")
        finally:
            EDM.evict_master = orig_evict
        out["eviction"] = {
            "master_bytes": one, "budget_bytes": int(SERVE_BUDGET * one),
            "second_panel_optimal_E_s": t_b, "evictions": evictions,
            "rebuild_first_query_ms": t_rebuild * 1e3,
            "rebuild_launches": rebuild}

        # The HTTP front end on loopback.
        httpd = serve_http(srv)
        port = httpd.server_address[1]

        def http(path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                None if body is None else json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=wait_s) as r:
                return r.status, json.loads(r.read())

        try:
            code, health = http("/healthz")
            if code != 200 or not health["ok"]:
                fail(f"/healthz answered {code}: {health}")
            hp = asked[:4]
            for p in hp:
                _, r = http("/v1/ccm", {"panel": "fish", "lib": p[0],
                                        "target": p[1],
                                        "E": int(E_opt[p[1]])})
                if np.float32(r["result"]) != want[p]:
                    fail(f"HTTP ccm {p}: {r['result']} != {want[p]}")
            _, r = http("/v1/append", {"panel": "fish",
                                       "delta": full[:, L:L + 1].tolist()})
            L += 1
            _, _, want = oracle(L, hp, E_opt)
            if r["result"]["version"] != len(SERVE_DTS) + 1:
                fail(f"HTTP append answered {r}")
            for p in hp:
                _, r = http("/v1/ccm", {"panel": "fish", "lib": p[0],
                                        "target": p[1],
                                        "E": int(E_opt[p[1]])})
                if np.float32(r["result"]) != want[p]:
                    fail(f"HTTP ccm {p} after the HTTP append: "
                         f"{r['result']} != {want[p]}")
        finally:
            httpd.shutdown()
        out["http"] = {"healthz_workers": len(health["workers"]),
                       "ccm_requests": 2 * len(hp), "append_version": 3}
    finally:
        srv.close()

    # A durable child killed with SIGKILL between ticks, then recovered.
    sd = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        with open(os.path.join(sd, "child.err"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", SERVE_CHILD, sd,
                 *(str(v) for v in (N_SERIES, LENGTH, SEED, E_MAX,
                                    SERVE_KILL_TICKS))],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env)
            acked, deadline = 0, time.monotonic() + wait_s
            try:
                for line in proc.stdout:
                    if line.startswith("ACK"):
                        acked = int(line.split()[1])
                        if acked >= 2:
                            break
                    if time.monotonic() > deadline:
                        break
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        if acked < 2:
            with open(os.path.join(sd, "child.err")) as f:
                fail(f"the durable child acked {acked} ticks: "
                     f"{f.read()[-2000:]}")
        a = time.perf_counter()
        rec = EDMServer.recover(sd, workers=1)
        t_rec = time.perf_counter() - a
        try:
            v = rec.recovery_report["kp"]["version"]
            if not acked <= v <= SERVE_KILL_TICKS:
                fail(f"recovered version {v} after {acked} acks")
            (E_r, rho_r), t_first = host_s(
                torch, lambda: rec.call("optimal_E", "kp", timeout=wait_s))
            got_r = {p: np.float32(rec.call(
                "ccm", "kp", lib=p[0], target=p[1], E=int(E_r[p[1]]),
                timeout=wait_s)) for p in asked[:8]}
        finally:
            rec.close()

        def never_crashed():
            d = EDM(panel, E_max=E_MAX)
            d.optimal_E()
            for k in range(v):
                d.append(full[:, LENGTH + k:LENGTH + k + 1])
            E_n, rho_n = d.optimal_E()
            return E_n, rho_n, {p: np.float32(d.ccm_batch(
                [p], E=int(E_n[p[1]]))[0]) for p in got_r}

        E_n, rho_n, want_r = uncounted(never_crashed)
        if not (np.array_equal(E_r, E_n) and np.array_equal(rho_r, rho_n)):
            fail("the recovered optimal_E differs from the never-crashed "
                 "session's")
        check(got_r, want_r, "after the kill -9 recovery")
        out["recovery"] = {"acked": acked, "version": v,
                           "report": rec.recovery_report["kp"],
                           "recover_s": t_rec,
                           "first_optimal_E_s": t_first,
                           "pairs_checked": len(got_r)}
    finally:
        shutil.rmtree(sd, ignore_errors=True)
    launches = counts()
    out["launches"] = {n: c for n, c in launches.items() if c}
    for name in ("knn_multi_e", "lookup_rho", "knn_append"):
        if launches[name] <= 0:
            fail(f"the serving path launched {name} no time")
    return out, launches


def lm_full_config():
    """The LM path's model: ``LM_ARCH`` as configured (llama3-8b: 32
    layers, d_model 4,096, 32/8 heads, d_ff 14,336, vocab 128,256, bf16
    activations over float32 parameters), no layer cut."""
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def lm_prompts(np, vocab):
    """The serve launcher's prompts: ``LM_PROMPTS`` of 3–9 tokens, seed 0."""
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(0, vocab, int(rng.integers(3, 10)))))
            for _ in range(LM_PROMPTS)]


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def lm_greedy_matches_forward(torch, pm, ServeEngine, cfg, model, prompt,
                              dev):
    """Greedy decode of ``LM_MATCH_TOKENS`` tokens through the engine, then
    the parallel forward over prompt + output: every generated token is the
    forward's argmax at the position before it (a top-two gap under
    ``LM_SMOKE_TOL`` excused), and a teacher-forced decode's logits are the
    forward's within ``LM_SMOKE_TOL``. Returns (max |Δlogit|, near-ties)."""
    res = ServeEngine(cfg, model, s_max=32).generate(
        [prompt], max_new=LM_MATCH_TOKENS)
    seq = res.tokens[0]
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    with torch.no_grad():
        full, _ = pm.forward_train(model, cfg, {"tokens": toks})
        cache = pm.init_cache(cfg, 1, len(seq), device=dev)
        err = 0.0
        for t in range(len(seq)):
            lg, cache = pm.decode_step(model, cfg, toks[:, t:t + 1], cache, t)
            err = max(err, float((lg[0, 0] - full[0, t]).abs().max()))
    ties = 0
    for t in range(len(prompt) - 1, len(seq) - 1):
        top2 = torch.topk(full[0, t], 2).values
        if int(full[0, t].argmax()) != seq[t + 1]:
            if float(top2[0] - top2[1]) >= LM_SMOKE_TOL:
                fail(f"{cfg.name}: greedy token {t + 1} is {seq[t + 1]}, the "
                     f"parallel forward's argmax {int(full[0, t].argmax())}")
            ties += 1
    if not err <= LM_SMOKE_TOL:
        fail(f"{cfg.name}: decode logits differ from the forward's by {err}")
    return err, ties


def run_lm_path(torch, np, dev, reset_counts, counts):
    """The LM substrate's serving half (``repro_torch.models``,
    ``repro_torch.serving.ServeEngine``) on the card, plain eager PyTorch
    (none of the EDM kernels; their counts must stay 0). (a) llama3-8b at
    full width: ``init_params`` on the card, ``ServeEngine(s_max=128)``
    generating 32 tokens for 4 prompts twice (identical tokens), decode
    steps timed beside their bytes bound, the decode path's logits at every
    position of a prompt against ``forward_train``'s, and one 2,048-token
    prefill on the chunked path against the full S×S path, all within
    ``LM_BF16_ATOL``. (b) the ten smoke archs: weights made on the CPU and
    loaded onto the card; ``forward_train``, ``loss_fn`` and decode logits
    within ``LM_SMOKE_TOL`` of the CPU port's, gradients finite and
    non-zero on the card, and greedy decode equal to the parallel
    forward's argmax for four archs. Returns (record, launches)."""
    import dataclasses
    import gc

    from repro_torch import models as pm
    from repro_torch.configs import ARCHS, SKIP_CELLS, get_config
    from repro_torch.serving import ServeEngine

    # The smoke archs are float32: with TF32 on, the card's products would
    # round their operands to 10 mantissa bits and could not be held to the
    # CPU port at 1e-4. main() turns it off before phase 3; check it is.
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the LM path needs them off")
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t_phase = time.perf_counter()
    out = {"arch": LM_ARCH}

    # ------------------------------------------------ (a) full width
    cfg = lm_full_config()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = host_s(torch, lambda: pm.init_params(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = tree_bytes(list(model.parameters()))
    out["model"] = {
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "params": n_params,
        "param_bytes": param_bytes, "init_s": init_s,
        "init_peak_bytes": torch.cuda.max_memory_allocated() - held}
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters on the card, {cfg.param_count()} in "
             f"the config")

    prompts = lm_prompts(np, cfg.vocab_size)
    engine = ServeEngine(cfg, model, s_max=LM_S_MAX)
    torch.cuda.reset_peak_memory_stats()
    res1, gen1_s = host_s(torch, lambda: engine.generate(
        prompts, max_new=LM_MAX_NEW))
    res2, gen2_s = host_s(torch, lambda: engine.generate(
        prompts, max_new=LM_MAX_NEW))
    gen_peak = torch.cuda.max_memory_allocated()
    if res1.tokens != res2.tokens:
        fail("two greedy generate runs of the same prompts differ")
    for p, o in zip(prompts, res1.tokens):
        if o[:len(p)] != p or len(o) != len(p) + LM_MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"generate gave a malformed row for prompt {p}")
    # Decode steps timed one by one (CUDA events; host clock beside).
    t_prof = time.perf_counter()
    B = len(prompts)
    cache = pm.init_cache(cfg, B, LM_S_MAX, device=dev)
    kv_bytes = tree_bytes(cache)
    tok = torch.tensor([[p[0]] for p in prompts], dtype=torch.int32,
                       device=dev)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    step_ms, step_host_ms = [], []
    with torch.no_grad():
        pm.decode_step(model, cfg, tok, cache, 0)
        for t in range(1, LM_STEPS_TIMED + 1):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            ev0.record()
            pm.decode_step(model, cfg, tok, cache, t)
            ev1.record()
            torch.cuda.synchronize()
            step_host_ms.append((time.perf_counter() - h0) * 1e3)
            step_ms.append(ev0.elapsed_time(ev1))
    del cache
    secs = {"timed_steps": time.perf_counter() - t_prof}
    t0 = time.perf_counter()
    prof = device_profile(torch, lambda: engine.generate(
        prompts, max_new=LM_MAX_NEW))
    secs["profiled_generate"] = time.perf_counter() - t0
    new_tokens = LM_PROMPTS * LM_MAX_NEW
    steps = max(map(len, prompts)) + LM_MAX_NEW - 1

    step_bound = bound_ms(param_bytes + kv_bytes, 0.0)
    layer_bytes = tree_bytes(list(model["units"].parameters()))
    head_bytes = tree_bytes(list(model["lm_head"].parameters()))
    out["serve"] = {
        "batch": B, "prompt_lens": [len(p) for p in prompts],
        "max_new": LM_MAX_NEW, "s_max": LM_S_MAX, "decode_steps": steps,
        "generate_s": [gen1_s, gen2_s],
        "tokens_per_s": new_tokens / gen2_s,
        "generate_ms_per_step": gen2_s / steps * 1e3,
        "first_tokens": [o[len(p):len(p) + 8]
                         for p, o in zip(prompts, res1.tokens)],
        "peak_bytes": gen_peak, "held_before_bytes": held,
        "device_profile": prof,
        "step_ms": {"median": statistics.median(step_ms),
                    "min": min(step_ms), "max": max(step_ms),
                    "host_median": statistics.median(step_host_ms),
                    "steps": len(step_ms)},
        "step_bound_ms": step_bound[0], "step_bound_by": step_bound[1],
        "step_bound_bytes": {"params": param_bytes, "kv_cache": kv_bytes},
        # What the step moves as written: dense() casts each float32 layer
        # weight to bf16 at use (read 4 B, write 2 B, read 2 B a parameter),
        # the head reads its float32 table, the embedding only B rows.
        "step_traffic_bytes": 2 * layer_bytes + head_bytes + kv_bytes}

    # The decode path against the parallel forward, at every position of
    # the longest prompt.
    p0 = max(prompts, key=len)
    toks = torch.tensor([p0], dtype=torch.int32, device=dev)
    with torch.no_grad():
        full, _ = pm.forward_train(model, cfg, {"tokens": toks})
        cache = pm.init_cache(cfg, 1, len(p0), device=dev)
        steps_lg = []
        for t in range(len(p0)):
            lg, cache = pm.decode_step(model, cfg, toks[:, t:t + 1], cache, t)
            steps_lg.append(lg[0, 0])
    steps_lg = torch.stack(steps_lg)
    errs = (steps_lg - full[0]).abs().amax(-1).tolist()
    out["decode_vs_forward"] = {
        "positions": len(p0), "max_abs_err": max(errs), "per_position": errs,
        "max_abs_logit": float(full.abs().max()),
        "logit_std": float(full.std()), "tol": LM_BF16_ATOL,
        "argmax_equal": int((steps_lg.argmax(-1)
                             == full[0].argmax(-1)).sum())}
    del cache, full, steps_lg
    secs["decode_vs_forward"] = (time.perf_counter() - t_prof
                                 - sum(secs.values()))
    if not max(errs) <= LM_BF16_ATOL:
        fail(f"decode logits differ from forward_train's by {max(errs)}")

    # One long prompt: the chunked prefill against the full S×S path.
    rng = np.random.default_rng(1)
    long = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LM_PREFILL_S)
                                        ).astype(np.int32), device=dev)
    full_cfg = dataclasses.replace(cfg, attn_full_max=2 * LM_PREFILL_S)
    if not (LM_PREFILL_S > cfg.attn_full_max
            and LM_PREFILL_S % cfg.attn_chunk_q == 0):
        fail("the long prefill would not take the chunked path")
    times = {"chunked": [], "full": []}
    logits = {}
    with torch.no_grad():
        for _ in range(2):
            for name, c in (("chunked", cfg), ("full", full_cfg)):
                torch.cuda.reset_peak_memory_stats()
                (lg, caches), sec = host_s(torch, lambda: pm.prefill(
                    model, c, {"tokens": long}))
                times[name].append(sec)
                logits[name] = lg
                peak = torch.cuda.max_memory_allocated()
                del caches
    err = float((logits["chunked"] - logits["full"]).abs().max())
    out["prefill"] = {
        "S": LM_PREFILL_S, "chunk": cfg.attn_chunk_q, "seconds": times,
        "tokens_per_s": LM_PREFILL_S / times["chunked"][-1],
        "last_peak_bytes": peak, "max_abs_err": err, "tol": LM_BF16_ATOL,
        "max_abs_logit": float(logits["full"].abs().max()),
        "argmax_equal": int(logits["chunked"].argmax())
        == int(logits["full"].argmax())}
    if not (torch.isfinite(logits["chunked"]).all() and err <= LM_BF16_ATOL):
        fail(f"the chunked prefill's logits differ from the full path's by "
             f"{err}")
    del model, engine, logits, long
    gc.collect()
    torch.cuda.empty_cache()
    secs["prefills"] = time.perf_counter() - t_prof - sum(secs.values())
    out["full_width_s"] = dict(secs, total=time.perf_counter() - t_phase)

    # ------------------------------------------------ (b) smoke archs
    t_smoke = time.perf_counter()
    smoke = {}
    for arch in ARCHS:
        scfg = get_config(arch, smoke=True)
        cpu = pm.init_params(scfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        card = pm.abstract_params(scfg).to_empty(device=dev)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(2)
        inp = {"labels": rng.integers(0, scfg.vocab_size, (2, 16))}
        if scfg.embed_inputs:
            inp["embeds"] = rng.normal(size=(2, 16, scfg.d_model)).astype(
                np.float32)
        else:
            inp["tokens"] = rng.integers(0, scfg.vocab_size, (2, 16))
        on = {d: {k: torch.as_tensor(v, device=d) for k, v in inp.items()}
              for d in ("cpu", dev)}
        with torch.no_grad():
            lc, ac = pm.forward_train(cpu, scfg, on["cpu"])
            loss_c, _ = pm.loss_fn(cpu, scfg, on["cpu"])
            lg, ag = pm.forward_train(card, scfg, on[dev])
        loss_g, _ = pm.loss_fn(card, scfg, on[dev])
        loss_g.backward()
        grads = [p.grad for p in card.parameters() if p.grad is not None]
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                     for g in grads)))
        rec = {"logits": float((lg.cpu() - lc).abs().max()),
               "aux": abs(float(ag) - float(ac)),
               "loss": abs(float(loss_g.detach()) - float(loss_c)),
               "grad_norm": gnorm}
        if not (np.isfinite(gnorm) and gnorm > 0):
            fail(f"{arch}: gradient norm {gnorm} on the card")
        if "decode_32k" not in SKIP_CELLS.get(arch, set()):
            toks = rng.integers(0, scfg.vocab_size, (2, 4)).astype(np.int32)
            caches = {d: pm.init_cache(scfg, 2, 8, device=d)
                      for d in ("cpu", dev)}
            derr = 0.0
            with torch.no_grad():
                for t in range(toks.shape[1]):
                    got = {}
                    for d in ("cpu", dev):
                        got[d], caches[d] = pm.decode_step(
                            cpu if d == "cpu" else card, scfg,
                            torch.as_tensor(toks[:, t:t + 1], device=d),
                            caches[d], t)
                    derr = max(derr, float((got[dev].cpu()
                                            - got["cpu"]).abs().max()))
            rec["decode"] = derr
        for k in ("logits", "aux", "loss", "decode"):
            if k in rec and not rec[k] <= LM_SMOKE_TOL:
                fail(f"{arch}: {k} on the card differs from the CPU port's "
                     f"by {rec[k]}")
        if arch in ("llama3-8b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                    "xlstm-125m"):
            dcfg = scfg if scfg.moe is None else dataclasses.replace(
                scfg, moe=dataclasses.replace(
                    scfg.moe, capacity_factor=float(scfg.moe.num_experts)))
            rec["greedy_vs_forward"], rec["near_ties"] = \
                lm_greedy_matches_forward(torch, pm, ServeEngine, dcfg, card,
                                          [3, 1, 4, 1], dev)
        smoke[arch] = rec
    out["smoke"] = smoke
    out["smoke_s"] = time.perf_counter() - t_smoke
    out["phase_s"] = time.perf_counter() - t_phase
    launches = counts()
    if any(launches.values()):
        fail(f"the LM path launched EDM kernels: {launches}")
    return out, launches


def train_flops(cfg, B, S):
    """(bf16 FLOPs, float32 FLOPs) of one train step on B × S tokens: the
    layers' matrices 8·N·T (forward, remat recompute, backward) and causal
    attention 8·S²·d a layer and sequence, at the bf16 rate; the float32
    head (outside the remat) 6·N_head·T at the float32 rate, TF32 off; the
    embedding is a gather."""
    table = cfg.vocab_size * cfg.d_model
    n_body = cfg.param_count() - table * (1 if cfg.tie_embeddings else 2)
    T = B * S
    attn = 8 * S * S * cfg.n_heads * cfg.d_head * cfg.n_layers * B
    return 8 * n_body * T + attn, 6 * table * T


def opt_bytes(state):
    """Bytes one AdamW step must move: each weight, gradient and moment
    read once, each weight and moment written once."""
    p = tree_bytes(list(state["params"].parameters()))
    mv = tree_bytes(state["opt"]["m"]) + tree_bytes(state["opt"]["v"])
    return 3 * p + 2 * mv


def train_peak_reckon(cfg, B, S, state_bytes):
    """Device bytes reckoned for one float32-AdamW step: the state, the
    gradients (as large as the weights), and the larger of the step's
    activations (the float32 head's logits, log-probabilities and their
    two gradients; one layer's chunked-attention recompute, six float32
    (cq × cq) score tensors a head and chunk pair; the layers' saved
    inputs) and the optimizer's temporaries (four float32 copies of the
    largest leaf)."""
    params = state_bytes["params"]
    cq = min(cfg.attn_chunk_q, S)
    head = 4 * B * S * cfg.vocab_size * 4
    attn = 6 * (S // cq) ** 2 * B * cfg.n_heads * cq * cq * 4
    saved = cfg.n_layers * B * S * cfg.d_model * 2 * 2
    largest = cfg.vocab_size * cfg.d_model * 4
    return (sum(state_bytes.values()) + params
            + max(head + attn + saved, 4 * largest))


def host_tree(torch, t, rows=None):
    """A moment or weight (or its ``rows``) on the host in float64
    (codes as int64)."""
    if isinstance(t, dict):
        return {k: host_tree(torch, v, rows) for k, v in t.items()}
    t = t.detach()
    if rows is not None:
        t = t[rows]
    return t.cpu().to(torch.int64 if t.dtype == torch.int8
                      else torch.float64).numpy()


def adam64(np, p, g, m, v, *, step, lr, tcfg):
    """The reference's AdamW update (``repro.optim.adamw``) of one leaf in
    float64 on the host, its 8-bit codec included: (p, m, v) after the
    step ``step`` (0-based) from float64 copies of the card's."""
    from repro_torch.optim.adamw import BLOCK

    def blocks(x):
        return x.reshape(x.shape[:-1] + (x.shape[-1] // BLOCK, BLOCK))

    def decode(enc, kind):
        y = enc["q"] / 127.0
        y = np.abs(y) * y if kind == "sq" else y ** 4
        return (blocks(y) * enc["scale"][..., None]).reshape(y.shape)

    def encode(x, kind):
        amax = np.abs(blocks(x)).max(-1, keepdims=True)
        y = blocks(x) / np.maximum(amax, 1e-30)
        q = (np.round(127 * np.sign(y) * np.sqrt(np.abs(y))) if kind == "sq"
             else np.round(127 * np.abs(y) ** 0.25))
        return {"q": q.reshape(x.shape), "scale": amax[..., 0]}

    m0 = decode(m, "sq") if isinstance(m, dict) else m
    v0 = decode(v, "q4") if isinstance(v, dict) else v
    m1 = tcfg.b1 * m0 + (1 - tcfg.b1) * g
    v1 = tcfg.b2 * v0 + (1 - tcfg.b2) * g * g
    t = step + 1
    upd = (m1 / (1 - tcfg.b1 ** t)) / (np.sqrt(v1 / (1 - tcfg.b2 ** t))
                                       + tcfg.eps)
    p1 = p - lr * (upd + tcfg.weight_decay * p)
    return (p1, encode(m1, "sq") if isinstance(m, dict) else m1,
            encode(v1, "q4") if isinstance(v, dict) else v1)


def hold_update(np, name, before, after, grad, *, step, lr, norm, tcfg):
    """The card's update of sampled rows of one leaf against ``adam64`` from
    the rows before the step and their accumulated gradient (clipped here
    as the step clips it): weights within 1e-5 of their move plus two
    float32 ulps, 8-bit codes ±1 and scales 1e-5 relative, float32
    moments 1e-5 of the rows' largest. Returns the observed maxima."""
    scale = min(1.0, tcfg.grad_clip / max(norm, 1e-9))
    p1, m1, v1 = adam64(np, before["p"], grad * scale, before["m"],
                        before["v"], step=step, lr=lr, tcfg=tcfg)
    rec = {}
    move = np.abs(p1 - before["p"])
    ulp = np.spacing(np.abs(p1).astype(np.float32)).astype(np.float64)
    d = np.abs(after["p"] - p1)
    rec["p_err_over_tol"] = float((d / (1e-5 * move + 2 * ulp)).max())
    rec["p_max_abs_err"] = float(d.max())
    rec["p_max_move"] = float(move.max())
    for k, want in (("m", m1), ("v", v1)):
        got = after[k]
        if isinstance(want, dict):
            dq = np.abs(got["q"] - want["q"])
            rec[f"{k}_code_max"] = int(dq.max())
            rec[f"{k}_code_flips"] = int((dq > 0).sum())
            rec[f"{k}_codes"] = int(dq.size)
            rec[f"{k}_scale_rel"] = float(
                (np.abs(got["scale"] - want["scale"])
                 / np.maximum(want["scale"], 1e-30)).max())
            ok = dq.max() <= 1 and rec[f"{k}_scale_rel"] <= 1e-5
        else:
            rec[f"{k}_rel"] = float(np.abs(got - want).max()
                                    / max(np.abs(want).max(), 1e-30))
            ok = rec[f"{k}_rel"] <= 1e-5
        if not ok:
            fail(f"{name}: the card's {k} differs from the float64 "
                 f"recomputation: {rec}")
    if not rec["p_err_over_tol"] <= 1.0:
        fail(f"{name}: the card's weights differ from the float64 "
             f"recomputation: {rec}")
    return rec


def state_to(torch, pm, cfg, state, dev):
    """A copy of a train state on ``dev`` (weights loaded into a module
    made there, every other tensor copied)."""
    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return t.detach().to(dev, copy=True)

    params = pm.abstract_params(cfg).to_empty(device=dev)
    params.load_state_dict(state["params"].state_dict())
    out = {"params": params, "opt": copy(state["opt"])}
    if "ebuf" in state:
        out["ebuf"] = copy(state["ebuf"])
    return out


def hold_train_states(torch, np, got, want, *, lr, what):
    """The card's train state after one step against the CPU port's from
    the same state (the ``TRAIN_SMOKE_RTOL`` comment's tolerances).
    Returns the observed maxima."""
    from repro_torch.optim.adamw import _dequantize

    def host(t):
        return t.detach().cpu().to(torch.float64).numpy()

    v_rms = {}
    for n, v in want["opt"]["v"].items():
        if isinstance(v, dict):
            v = _dequantize(v, v["q"].shape, kind="q4")
        v_rms[n] = np.sqrt(np.maximum(host(v), 0.0))
    top = max(float(r.max()) for r in v_rms.values())
    wire = bool(want.get("ebuf"))
    rounded = wire or any(isinstance(v, dict)
                          for v in want["opt"]["m"].values())
    rec = {"param_real": 0.0, "param_floor": 0.0, "moment": 0.0,
           "code": 0, "scale": 0.0, "ebuf": 0.0}
    gp = dict(got["params"].named_parameters())
    for n, w in want["params"].named_parameters():
        d = np.abs(host(gp[n]) - host(w))
        floor = v_rms[n] < 1e-3 * top
        for key, part, tol in (("param_real", d[~floor],
                                (0.2 if rounded else 1e-3) * lr),
                               ("param_floor", d[floor], 2 * lr)):
            if part.size:
                rec[key] = max(rec[key], float(part.max()))
                if not part.max() <= tol:
                    fail(f"{what} {n}: the card's weights differ from the "
                         f"CPU port's by {float(part.max())} ({key})")
    for k in ("m", "v"):
        tops = [float(np.abs(host(t)).max()) for t in
                want["opt"][k].values() if not isinstance(t, dict)]
        floor = 1e-3 * max(tops or [0.0])
        for n, w in want["opt"][k].items():
            g = got["opt"][k][n]
            if isinstance(w, dict):
                dq = int((g["q"].cpu().long() - w["q"].long()).abs().max())
                rel = float(((host(g["scale"]) - host(w["scale"])).__abs__()
                             / np.maximum(host(w["scale"]), 1e-30)).max())
                rec["code"] = max(rec["code"], dq)
                rec["scale"] = max(rec["scale"], rel)
                if dq > 1 or rel > 2e-4:
                    fail(f"{what} {n}: the card's 8-bit {k} differs from "
                         f"the CPU port's (codes {dq}, scales {rel})")
            else:
                err = float(np.abs(host(g) - host(w)).max()) / max(
                    float(np.abs(host(w)).max()), floor, 1e-30)
                rec["moment"] = max(rec["moment"], err)
                if not err <= (2e-2 if wire else 2e-4):
                    fail(f"{what} {n}: the card's {k} differs from the CPU "
                         f"port's by {err} of the leaf's scale")
    if int(got["opt"]["step"]) != int(want["opt"]["step"]):
        fail(f"{what}: the card's step count differs from the CPU port's")
    off = total = 0
    for n, w in want.get("ebuf", {}).items():
        e = np.abs(host(got["ebuf"][n]) - host(w))
        rec["ebuf"] = max(rec["ebuf"], float(e.max()))
        off += int((e > 1e-6 + 1e-5 * np.abs(host(w))).sum())
        total += e.size
    # a residual differs only where the wire's rounding went the other way
    # (one quantum): at most one element in a thousand
    rec["ebuf_off"] = off
    if off > 1e-3 * max(total, 1):
        fail(f"{what}: {off} of {total} error-buffer elements differ "
             f"between the card and the CPU port")
    return rec


def train_smoke_batch(np, cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return out


def train_parity(torch, np, pm, make_train_step, cfg, tcfg, dev, what):
    """One train step from one state made on the CPU, on the CPU and on the
    card: (record of the observed maxima, the card's state)."""
    init, step, _ = make_train_step(cfg, tcfg)
    cpu = init(torch.Generator().manual_seed(0))
    card = state_to(torch, pm, cfg, cpu, dev)
    b = train_smoke_batch(np, cfg, 3)
    cpu, mc = step(cpu, {k: torch.as_tensor(v) for k, v in b.items()})
    card, mg = step(card, {k: torch.as_tensor(v, device=dev)
                           for k, v in b.items()})
    rec = {"metrics": 0.0}
    for k, v in mc.items():
        d = abs(float(mg[k]) - float(v))
        rec["metrics"] = max(rec["metrics"], d)
        if not (np.isfinite(float(mg[k]))
                and d <= TRAIN_SMOKE_RTOL * (1 + abs(float(v)))):
            fail(f"{what}: metric {k} on the card {float(mg[k])}, on "
                 f"the CPU {float(v)}")
    rec.update(hold_train_states(torch, np, card, cpu, lr=float(mc["lr"]),
                                 what=what))
    return rec, card


def run_train_path(torch, np, dev, root, reset_counts, counts):
    """The LM substrate's training half (``repro_torch.optim``,
    ``repro_torch.training``, ``repro_torch.data.pipeline``,
    ``repro_torch.distributed.compression``, ``repro_torch.launch.train``)
    on the card, plain eager PyTorch (none of the EDM kernels; their counts
    must stay 0): ``train_full_width``, ``train_smoke_archs``,
    ``train_loop_checks`` in turn, each part's record printed when it
    ends. Returns (record, launches)."""
    import gc

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the training path needs them off")
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t_phase = time.perf_counter()
    out, secs = {"arch": TRAIN_ARCH}, {}
    for name, part in (
            ("full_width", lambda: train_full_width(torch, np, dev)),
            ("smoke", lambda: train_smoke_archs(torch, np, dev)),
            ("loop", lambda: train_loop_checks(torch, np, dev, root))):
        t0 = time.perf_counter()
        rec = part()
        secs[name] = time.perf_counter() - t0
        if name == "full_width":
            out.update(rec)
        else:
            out[name] = rec
            print(json.dumps({"train_part": name, **rec}), flush=True)
    out["seconds"] = dict(secs, phase=time.perf_counter() - t_phase)
    launches = counts()
    if any(launches.values()):
        fail(f"the training path launched EDM kernels: {launches}")
    return out, launches


def train_full_width(torch, np, dev):
    """(a) ``TRAIN_ARCH`` as configured, uncut: ``adamw8bit`` steps at B =
    ``TRAIN_B``, S = ``TRAIN_S`` in ``TRAIN_MICRO`` microbatches through
    ``make_train_step``, the state's layout and bytes against the
    reckoning, sampled updates of four leaves against ``adam64`` at step
    ``TRAIN_CHECK_STEP``, which runs under the profiler; then float32
    ``adamw`` on a fresh state at B = 1 and one step under the
    profiler."""
    import gc

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim.adamw import BLOCK
    from repro_torch.training import make_train_step

    out = {}
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(optimizer="adamw8bit", microbatch=TRAIN_MICRO,
                       warmup_steps=0, total_steps=TRAIN_STEPS)
    init, step_fn, abstract = make_train_step(cfg, tcfg)
    meta = abstract()
    reckon = {"params": tree_bytes(list(meta["params"].parameters())),
              "opt": tree_bytes(meta["opt"]["m"])
              + tree_bytes(meta["opt"]["v"])}
    reckon["grads"] = reckon["params"]
    del meta
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, init_s = host_s(torch, lambda: init(
        torch.Generator(device=dev).manual_seed(0)))
    params = dict(state["params"].named_parameters())
    n_params = sum(p.numel() for p in params.values())
    if n_params != cfg.param_count():
        fail(f"{n_params} parameters on the card, {cfg.param_count()} in "
             f"the config")
    coded = plain = 0
    for name, p in params.items():
        stack = cfg.n_units if name.startswith("units.") else 1
        eligible = p.shape[-1] % BLOCK == 0 and p.numel() * stack >= 65536
        for k in ("m", "v"):
            mv = state["opt"][k][name]
            if isinstance(mv, dict) != eligible:
                fail(f"{name}: {k} is {'8-bit' if eligible else 'float32'} "
                     f"by the reference's rule, not in the port's state")
            if eligible and not (
                    mv["q"].dtype == torch.int8 and mv["q"].shape == p.shape
                    and mv["scale"].dtype == torch.float32
                    and tuple(mv["scale"].shape)
                    == tuple(p.shape[:-1]) + (p.shape[-1] // BLOCK,)):
                fail(f"{name}: 8-bit {k} has codes {mv['q'].dtype}"
                     f"{tuple(mv['q'].shape)}, scales "
                     f"{tuple(mv['scale'].shape)}")
        coded += p.numel() if eligible else 0
        plain += 0 if eligible else p.numel()
    got_bytes = {"params": tree_bytes(list(params.values())),
                 "opt": tree_bytes(state["opt"]["m"])
                 + tree_bytes(state["opt"]["v"])}
    if got_bytes["opt"] != reckon["opt"]:
        fail(f"optimizer state {got_bytes['opt']} B, reckoned "
             f"{reckon['opt']} B")
    out["model"] = {
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
        "vocab_size": cfg.vocab_size, "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "params": n_params,
        "param_bytes": got_bytes["params"], "opt_bytes": got_bytes["opt"],
        "reckoned_bytes": reckon, "codec_params": coded,
        "float32_moment_params": plain, "init_s": init_s,
        "init_peak_bytes": torch.cuda.max_memory_allocated() - held}

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=TRAIN_B,
                         seq_len=TRAIN_S, seed=0)
    host_batches = [pipe.global_batch(s) for s in range(TRAIN_STEPS)]
    # Two leaves with 8-bit moments on their own scale (the embedding, a
    # unit's MLP) and one whose moments are 8-bit only by the reference's
    # stacked rule (a unit's bias: (40, 2,560) stacked), plus the one leaf
    # with float32 moments (the final norm, 2,560 alone).
    checked = ("embed.table", "units.20.l0.mlp.w_up.w",
               "units.20.l0.mix.wq.b", "final_norm.g")
    rng = np.random.default_rng(0)
    seen = host_batches[TRAIN_CHECK_STEP]["tokens"].reshape(-1)
    rows = {"embed.table": torch.as_tensor(np.concatenate([
        np.unique(seen)[:TRAIN_CHECK_ROWS // 2],
        rng.integers(0, cfg.vocab_size, TRAIN_CHECK_ROWS // 2)])),
        "units.20.l0.mlp.w_up.w": torch.as_tensor(
            rng.integers(0, cfg.d_model, TRAIN_CHECK_ROWS)),
        "units.20.l0.mix.wq.b": None, "final_norm.g": None}

    def snapshot(st, name):
        r = rows[name]
        return {"p": host_tree(torch, params[name], r),
                "m": host_tree(torch, st["opt"]["m"][name], r),
                "v": host_tree(torch, st["opt"]["v"][name], r)}

    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    steps, check = [], {}
    torch.cuda.reset_peak_memory_stats()
    for s, hb in enumerate(host_batches):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in hb.items()}
        hooks, grads = [], {}
        if s == TRAIN_CHECK_STEP:
            before = {n: snapshot(state, n) for n in checked}
            for n in checked:
                hooks.append(params[n].register_post_accumulate_grad_hook(
                    lambda p, n=n: grads.__setitem__(
                        n, host_tree(torch, p.grad, rows[n]))))
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        box = {}

        def step():  # reads this iteration's state and batch when called
            ev0.record()
            box["out"] = step_fn(state, batch)
            ev1.record()

        if s == TRAIN_CHECK_STEP:
            window = device_profile(torch, step)
        else:
            step()
        state, met = box.pop("out")
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        for h in hooks:
            h.remove()
        met = {k: float(v) for k, v in met.items()}
        if not all(np.isfinite(v) for v in met.values()):
            fail(f"step {s}: metrics {met}")
        steps.append(dict(met, ms=ev0.elapsed_time(ev1), host_ms=host_ms,
                          hooks=bool(hooks)))
        if s == TRAIN_CHECK_STEP:
            for n in checked:
                check[n] = hold_update(
                    np, n, before[n], snapshot(state, n), grads[n], step=s,
                    lr=met["lr"], norm=met["grad_norm"], tcfg=tcfg)
    peak8 = torch.cuda.max_memory_allocated()
    # the median leaves out the first step and the profiled one, whose
    # grad hooks copy rows to the host
    ms = [r["ms"] for r in steps[1:] if not r["hooks"]]
    window.update(step=TRAIN_CHECK_STEP, B=TRAIN_B, S=TRAIN_S,
                  microbatches=TRAIN_MICRO,
                  seconds=steps[TRAIN_CHECK_STEP]["host_ms"] * 1e-3)
    tokens = TRAIN_B * TRAIN_S
    bf16_ops, f32_ops = train_flops(cfg, TRAIN_B, TRAIN_S)
    ob = opt_bytes(state)
    out["adamw8bit"] = {
        "B": TRAIN_B, "S": TRAIN_S, "microbatch": TRAIN_MICRO,
        "steps": steps, "ln_V": float(np.log(cfg.vocab_size)),
        "step_ms_median": statistics.median(ms), "median_of_steps": [
            i for i, r in enumerate(steps) if i and not r["hooks"]],
        "first_step_ms":
        steps[0]["ms"], "tokens_per_s": tokens / statistics.median(ms) * 1e3,
        "bound": {"bf16_flops": bf16_ops, "f32_flops": f32_ops,
                  "flops_ms": (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS)
                  * 1e3, "opt_bytes": ob, "opt_bytes_ms": ob / HBM_BPS * 1e3},
        "peak_bytes": peak8, "held_before_bytes": held,
        "reckoned_state_bytes": sum(reckon.values()),
        "sampled_updates": check, "profiled_window": window}
    del state, params, batch, grads, box, step
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"train_part": "adamw8bit", **out["adamw8bit"]}),
          flush=True)

    # ------------------------------------- (a) full width, float32 adamw
    tcfg32 = TrainConfig(optimizer="adamw", warmup_steps=0,
                         total_steps=TRAIN_F32_STEPS)
    init, step_fn, abstract = make_train_step(cfg, tcfg32)
    meta = abstract()
    sb = {"params": tree_bytes(list(meta["params"].parameters())),
          "opt": tree_bytes(meta["opt"]["m"]) + tree_bytes(meta["opt"]["v"])}
    del meta
    S32 = TRAIN_F32_S
    if train_peak_reckon(cfg, 1, S32, sb) > TRAIN_MEM_CAP:
        S32 = 1024
    reckoned32 = train_peak_reckon(cfg, 1, S32, sb)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = init(torch.Generator(device=dev).manual_seed(0))
    pipe32 = TokenPipeline(vocab_size=cfg.vocab_size, batch=1, seq_len=S32,
                           seed=0)
    steps32 = []
    for s in range(TRAIN_F32_STEPS):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe32.global_batch(s).items()}
        torch.cuda.synchronize()
        ev0.record()
        state, met = step_fn(state, batch)
        ev1.record()
        torch.cuda.synchronize()
        met = {k: float(v) for k, v in met.items()}
        if not all(np.isfinite(v) for v in met.values()):
            fail(f"float32 step {s}: metrics {met}")
        steps32.append(dict(met, ms=ev0.elapsed_time(ev1)))
    peak32 = torch.cuda.max_memory_allocated()
    box = {}
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             pipe32.global_batch(TRAIN_F32_STEPS).items()}
    t0 = time.perf_counter()
    prof = device_profile(torch, lambda: box.update(
        out=step_fn(state, batch)))
    prof["seconds"] = time.perf_counter() - t0
    state = box.pop("out")[0]
    bf16_ops, f32_ops = train_flops(cfg, 1, S32)
    ob = opt_bytes(state)
    ms = [r["ms"] for r in steps32[1:]]
    out["adamw"] = {
        "B": 1, "S": S32, "steps": steps32,
        "step_ms_median": statistics.median(ms),
        "tokens_per_s": S32 / statistics.median(ms) * 1e3,
        "bound": {"bf16_flops": bf16_ops, "f32_flops": f32_ops,
                  "flops_ms": (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS)
                  * 1e3, "opt_bytes": ob, "opt_bytes_ms": ob / HBM_BPS * 1e3},
        "peak_bytes": peak32, "held_before_bytes": held,
        "reckoned_peak_bytes": reckoned32,
        "profiled_step": prof}
    if peak32 - held > TRAIN_MEM_CAP:
        fail(f"the float32 run peaked at {peak32 - held} B")
    del state, batch, box
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_smoke_archs(torch, np, dev):
    """(b) the ten smoke archs' train step (float32 AdamW) on the card
    against the CPU port from one state made on the CPU; on llama3-8b also
    the widened 8-bit config, the int8 wire and two microbatches (against
    the CPU, and against one batch on the card)."""
    import dataclasses

    from repro_torch import models as pm
    from repro_torch.configs import ARCHS, TrainConfig, get_config
    from repro_torch.training import make_train_step

    smoke = {}
    for arch in ARCHS:
        scfg = get_config(arch, smoke=True)
        smoke[arch], _ = train_parity(torch, np, pm, make_train_step, scfg,
                                      TrainConfig(warmup_steps=0,
                                                  learning_rate=1e-3), dev,
                                      arch)
    lcfg = get_config("llama3-8b", smoke=True)
    wide = dataclasses.replace(lcfg, d_model=256, d_ff=128, vocab_size=256)
    for name, c, t in (
            ("llama3-8b adamw8bit widened", wide,
             TrainConfig(optimizer="adamw8bit", warmup_steps=0,
                         learning_rate=1e-3)),
            ("llama3-8b int8 wire", lcfg,
             TrainConfig(grad_compression="int8", warmup_steps=0,
                         learning_rate=1e-3)),
            ("llama3-8b microbatch 2", lcfg,
             TrainConfig(microbatch=2, warmup_steps=0, learning_rate=1e-3))):
        smoke[name], _ = train_parity(torch, np, pm, make_train_step, c, t,
                                      dev, name)
    # two microbatches against one batch, both on the card
    init, step2, _ = make_train_step(lcfg, TrainConfig(
        microbatch=2, warmup_steps=0, learning_rate=1e-3))
    _, step0, _ = make_train_step(lcfg, TrainConfig(
        microbatch=0, warmup_steps=0, learning_rate=1e-3))
    a = init(torch.Generator(device=dev).manual_seed(0))
    b = state_to(torch, pm, lcfg, a, dev)
    bt = {k: torch.as_tensor(v, device=dev)
          for k, v in train_smoke_batch(np, lcfg, 3).items()}
    a, ma = step2(a, bt)
    b, mb = step0(b, bt)
    dl = abs(float(ma["loss"]) - float(mb["loss"]))
    with torch.no_grad():
        dp = max(float(((x - y).abs() - 1e-3 * y.abs()).max())
                 for x, y in zip(a["params"].parameters(),
                                 b["params"].parameters()))
    smoke["microbatch 2 vs 0 on the card"] = {"loss": dl,
                                             "param_over_rtol": dp}
    if not (dl <= 1e-4 * abs(float(mb["loss"])) and dp <= 1e-5):
        fail(f"two microbatches differ from one batch on the card: loss "
             f"{dl}, weights {dp}")
    return smoke


def train_loop_checks(torch, np, dev, root):
    """(c) ``train()`` on the reference loop tests' tiny config on the
    card: learning over 40 steps, 20 + 10 steps against 30, a child
    SIGTERM'd after its fourth batch, ``python -m
    repro_torch.launch.train``."""
    import dataclasses
    import shutil
    import signal
    import tempfile

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.training import train

    lcfg = get_config("llama3-8b", smoke=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        tiny = dataclasses.replace(lcfg, vocab_size=64)
        tt = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                         total_steps=60, weight_decay=0.01, seed=0)
        tpipe = TokenPipeline(vocab_size=64, batch=4, seq_len=32, seed=1)
        kw = dict(ckpt_every=100, verbose=False, handle_preemption=False,
                  device=dev)
        t0 = time.perf_counter()
        _, hist = train(tiny, tt, tpipe, workdir=os.path.join(tmp, "l"),
                        num_steps=40, **kw)
        loop = {"steps_40_s": time.perf_counter() - t0}
        first = float(np.mean([h["loss"] for h in hist[:5]]))
        last = float(np.mean([h["loss"] for h in hist[-5:]]))
        loop["loss_first5_last5"] = [first, last]
        if not last < first - 0.2:
            fail(f"the loop did not learn on the card: {first} → {last}")
        sa, _ = train(tiny, tt, tpipe, workdir=os.path.join(tmp, "a"),
                      num_steps=30, **kw)
        train(tiny, tt, tpipe, workdir=os.path.join(tmp, "b"),
              num_steps=20, **dict(kw, ckpt_every=10))
        sb_, hb = train(tiny, tt, tpipe, workdir=os.path.join(tmp, "b"),
                        num_steps=30, **dict(kw, ckpt_every=10))
        worst, equal = 0.0, True
        with torch.no_grad():
            for x, y in zip(sa["params"].parameters(),
                            sb_["params"].parameters()):
                equal &= bool(torch.equal(x, y))
                worst = max(worst, float(
                    ((x - y).abs() - LOOP_RTOL * y.abs()).max()))
        loop["restart"] = {"resumed_steps": [h["step"] for h in hb],
                           "bit_equal": equal, "max_over_rtol": worst}
        if not (worst <= LOOP_ATOL and [h["step"] for h in hb]
                == list(range(20, 30))):
            fail(f"20 + 10 steps differ from 30 on the card: {worst}")
        # a child SIGTERM'd after its fourth batch, and the launcher, in two
        # processes at once (each spends most of its time starting up)
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        wd = os.path.join(tmp, "child")
        t0 = time.perf_counter()
        launcher = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "llama3-8b", "--steps", "10", "--device", "cuda", "--workdir",
             os.path.join(tmp, "launch")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        child = subprocess.Popen(
            [sys.executable, "-c", TRAIN_CHILD, wd], env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for line in child.stdout:
            if line.startswith("BATCH 3"):
                break
        child.send_signal(signal.SIGTERM)
        cout, cerr = child.communicate(input="\n", timeout=CHILD_TIMEOUT_S)
        from repro_torch.checkpoint import CheckpointManager
        latest = CheckpointManager(os.path.join(wd, "ckpt")).latest_step()
        loop["sigterm_child"] = {"returncode": child.returncode,
                                 "checkpoint": latest,
                                 "seconds": time.perf_counter() - t0}
        if child.returncode != 0 or "DONE 4" not in cout or latest != 4:
            fail(f"the SIGTERM'd child: rc {child.returncode}, checkpoint "
                 f"{latest}, {cout[-500:]} {cerr[-1500:]}")
        lout, lerr = launcher.communicate(timeout=CHILD_TIMEOUT_S)
        loop["launcher"] = {"returncode": launcher.returncode,
                            "seconds": time.perf_counter() - t0,
                            "last_line": lout.strip().splitlines()[-1]
                            if lout.strip() else ""}
        if launcher.returncode != 0 or "[train] done" not in lout:
            fail(f"the train launcher: rc {launcher.returncode} "
                 f"{lout[-500:]} {lerr[-1500:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return loop

def first_divergence(want, got, prompts):
    """Per row, the index of the first generated token that differs between
    two generations (None where they agree)."""
    out = []
    for w, g, p in zip(want, got, prompts):
        d = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        out.append(None if d is None else d - len(p))
    return out


def mesh_config(arch):
    """Phase 14's config of ``arch``: as configured, with float32
    activations for the archs of ``MESH_F32``."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return (dataclasses.replace(cfg, dtype="float32") if arch in MESH_F32
            else cfg)


def held_logits(np, got, want, routes, want_routes):
    """Logits against the plain run's: the largest |Δ| over every (step,
    row), and for an MoE model over the pairs where every routing of that
    row so far (each layer's top-k expert set) agreed, with the count of
    token-layer routings that did not and the share of pairs kept."""
    err = np.abs(got - want).max(-1)  # (steps, B)
    out = {"max_abs_err": float(err.max())}
    if routes is None:
        return out
    flip = (np.sort(routes, -1) != np.sort(want_routes, -1)).any(-1)
    agreed = ~np.logical_or.accumulate(flip.any(1), axis=0)  # (steps, B)
    out.update(routing_flips=int(flip.sum()), routings=int(flip.size),
               agreed_share=float(agreed.mean()),
               max_abs_err_agreed=float(err[agreed].max())
               if agreed.any() else None)
    return out


def lm_teacher_logits(torch, cfg, model, seqs, s_max, dev):
    """``decode_step`` over whole token rows ``seqs`` (each a prompt and its
    continuation, left-padded with its first token as the engine replays
    them), on the mesh set in ``meshctx`` if any: every step's logits on the
    host ((steps, B, V) float32), the steps' CUDA-event ms, one step's
    collectives by kind (``meshctx``'s counts, and the host's ms inside
    them, the step's host ms beside), and for an MoE model each
    step's top-k expert ids by layer ((steps, layers, B, k); else None)."""
    import numpy as np

    from repro_torch.models import meshctx
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    L = max(map(len, seqs))
    toks = torch.as_tensor(np.array(
        [[q[0]] * (L - len(q)) + list(q) for q in seqs], np.int32),
        device=dev)
    B = toks.shape[0]
    cache = tf.init_cache(cfg, B, s_max, device=dev, mesh=meshctx.get_mesh())
    out = np.empty((L - 1, B, cfg.vocab_size), np.float32)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ms, coll, routes = [], {}, []
    route = moe._route

    def recorded(xf, router, k, E, cf):
        r = route(xf, router, k, E, cf)
        step.append(torch.sort(r[5], dim=-1, descending=True,
                               stable=True).indices[:, :k].cpu().numpy())
        return r

    moe._route = recorded
    try:
        with torch.no_grad():
            for t in range(L - 1):
                step = []
                meshctx.reset_collective_counts()
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                ev0.record()
                lg, cache = tf.decode_step(model, cfg, toks[:, t:t + 1],
                                           cache, t)
                ev1.record()
                torch.cuda.synchronize()
                ms.append(ev0.elapsed_time(ev1))
                if t == (L - 1) // 2:
                    coll = dict(meshctx.collective_counts(), host_ms={
                        k: v * 1e3 for k, v in
                        meshctx.collective_seconds().items()},
                        step_host_ms=(time.perf_counter() - h0) * 1e3)
                out[t] = lg[:, 0].float().cpu().numpy()
                routes.append(step)
    finally:
        moe._route = route
    del cache
    routes = np.array(routes, np.int16) if routes[0] else None
    return out, {"median": statistics.median(ms), "min": min(ms),
                 "max": max(ms), "steps": len(ms)}, coll, routes


def mesh_ranks(root, wd, arch, ckpt):
    """``MESH_RANKS`` processes of ``MESH_CHILD`` on the card; their
    records by rank (any rank that fails, or prints none, fails the
    phase)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_CHILD, str(r), str(MESH_RANKS), wd, root,
         arch, ckpt], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(MESH_RANKS)]
    results = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=MESH_CHILD_TIMEOUT_S)
            results.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    child = {}
    for r, (rc, o, e) in enumerate(results):
        if rc != 0:
            fail(f"{arch}: mesh rank {r} exited {rc}: {e[-2000:]}")
        for line in o.splitlines():
            if line.startswith('{"mesh_child"'):
                child[r] = json.loads(line)["mesh_child"]
    if sorted(child) != list(range(MESH_RANKS)):
        fail(f"{arch}: mesh ranks printed no record: {sorted(child)}")
    return child, wall


def run_mesh_path(torch, np, dev, root, reset_counts, counts):
    """The LM substrate on a mesh (``repro_torch.launch.mesh``,
    ``.launch.sharding``, ``models.meshctx``, sequence-parallel decode,
    expert-parallel MoE), plain eager PyTorch (none of the EDM kernels;
    their counts must stay 0). For each of ``MESH_ARCHS`` as configured:
    the plain ``ServeEngine`` in this process generates and its sequences
    are replayed for their logits; (a, llama3-8b) a world of one on NCCL,
    mesh (1, 1), seqpar on, held to them; (b, c) ``MESH_RANKS`` gloo ranks
    on the card, mesh (1, 4), each drawing its blocks leaf by leaf,
    generating with seqpar on (deepseek-v2-lite through the expert-
    parallel MoE, 16 experts a rank) and replaying the plain sequences:
    logits held (``held_logits``), greedy tokens' first divergence
    reported; (d) leaves of the world of one's llama3-8b saved, restored by
    every rank onto its mesh by ``restore(shardings=)``, bit-equal to its
    drawn blocks. Returns (record, launches)."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import models as pm
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import carry, meshctx
    from repro_torch.serving import ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t_phase = time.perf_counter()
    out, secs = {"ranks": MESH_RANKS, "four_rank_backend": "gloo"}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        for arch in MESH_ARCHS:
            t_arch = time.perf_counter()
            cfg = mesh_config(arch)
            tol = LM_BF16_ATOL if cfg.dtype == "bfloat16" else MESH_F32_ATOL
            wd = os.path.join(tmp, arch)
            os.makedirs(wd)
            rec = out[arch] = {"n_layers": cfg.n_layers,
                               "d_model": cfg.d_model,
                               "vocab_size": cfg.vocab_size,
                               "params": cfg.param_count(),
                               "dtype": cfg.dtype, "tol": tol}
            prompts = lm_prompts(np, cfg.vocab_size)
            gen = torch.Generator(device=dev).manual_seed(0)
            torch.cuda.reset_peak_memory_stats()
            model = pm.init_params(cfg, device=dev, generator=gen)
            res, gen_s = host_s(torch, lambda: ServeEngine(
                cfg, model, s_max=LM_S_MAX).generate(prompts,
                                                     max_new=LM_MAX_NEW))
            want, step_ms, _, routes = lm_teacher_logits(
                torch, cfg, model, res.tokens, LM_S_MAX, dev)
            rec["plain"] = {"generate_s": gen_s, "step_ms": step_ms,
                            "peak_bytes": torch.cuda.max_memory_allocated()}
            np.save(os.path.join(wd, "logits.npy"), want)
            if routes is not None:
                np.save(os.path.join(wd, "routes.npy"), routes)
            with open(os.path.join(wd, "sequences.json"), "w") as f:
                json.dump({"prompts": prompts, "tokens": res.tokens,
                           "s_max": LM_S_MAX}, f)
            ckpt = "-"
            if arch == "llama3-8b":
                ckpt = os.path.join(wd, "ckpt")
                params = dict(model.named_parameters())
                names = [n for n in params if n.startswith(MESH_CKPT_PREFIXES)]
                _, save_s = host_s(torch, lambda: CheckpointManager(
                    ckpt).save(0, {n: params[n] for n in names}))
                with open(os.path.join(ckpt, "names.json"), "w") as f:
                    json.dump(names, f)
                rec["checkpoint"] = {"leaves": len(names), "save_s": save_s,
                                     "bytes": sum(params[n].numel() * 4
                                                  for n in names)}
                del params
            del model
            gc.collect()
            torch.cuda.empty_cache()

            if arch == "llama3-8b":  # (a) a world of one on NCCL
                mesh = make_mesh((1, 1), ("data", "model"))
                torch.cuda.reset_peak_memory_stats()
                placed, init_s = host_s(torch, lambda: carry.place_params(
                    cfg, mesh, generator=torch.Generator(
                        device=dev).manual_seed(0)))
                meshctx.set_mesh(mesh)
                meshctx.set_seqpar_decode(True)
                try:
                    res1, gen1_s = host_s(torch, lambda: ServeEngine(
                        cfg, placed, s_max=LM_S_MAX).generate(
                            prompts, max_new=LM_MAX_NEW))
                    lg1, step1, coll1, _ = lm_teacher_logits(
                        torch, cfg, placed, res.tokens, LM_S_MAX, dev)
                finally:
                    meshctx.set_seqpar_decode(False)
                    meshctx.set_mesh(None)
                err1 = float(np.abs(lg1 - want).max())
                rec["world_of_one"] = {
                    "backend": str(dist.get_backend()), "init_s": init_s,
                    "generate_s": gen1_s, "step_ms": step1,
                    "collectives_a_step": coll1, "max_abs_err": err1,
                    "first_divergence": first_divergence(
                        res.tokens, res1.tokens, prompts),
                    "peak_bytes": torch.cuda.max_memory_allocated()}
                if not err1 <= tol:
                    fail(f"{arch}: the world of one's logits differ from the "
                         f"plain engine's by {err1}")
                del placed, lg1
                dist.destroy_process_group()
                gc.collect()
                torch.cuda.empty_cache()
            del want
            gc.collect()

            child, wall = mesh_ranks(root, wd, arch, ckpt)
            for r, c in child.items():
                err = c.get("max_abs_err_agreed", c["max_abs_err"])
                if not (err is not None and err <= tol):
                    fail(f"{arch}: mesh rank {r}'s logits differ from the "
                         f"plain engine's by {err} (tolerance {tol}; {c})")
                if c.get("agreed_share", 1.0) < MESH_MIN_AGREED:
                    fail(f"{arch}: mesh rank {r}'s routings agreed with the "
                         f"plain run's on {c['agreed_share']} of the pairs")
                if ckpt != "-" and not c["restore_equal"]:
                    fail(f"{arch}: rank {r}'s restored blocks differ from "
                         f"its drawn blocks")
            rec["four_ranks"] = {"mesh": [1, MESH_RANKS], "wall_s": wall,
                                 "by_rank": child}
            secs[arch] = time.perf_counter() - t_arch
            print(json.dumps({"mesh_arch": arch, **rec}), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = dict(secs, phase=time.perf_counter() - t_phase)
    launches = counts()
    if any(launches.values()):
        fail(f"the mesh path launched EDM kernels: {launches}")
    return out, launches


def mesh_train_config():
    from repro_torch.configs import TrainConfig, get_config

    return get_config(MESH_TRAIN_ARCH), TrainConfig(
        optimizer="adamw8bit", warmup_steps=0, total_steps=MESH_TRAIN_STEPS)


def mesh_train_rows(np, cfg, tokens):
    """{leaf: its sampled rows (None: the whole leaf)}: vocab rows of
    tokens the batch holds once, in each half of the vocabulary (both
    "model" blocks of a table), random rows of the MLP leaf. (A frequent
    token's embedding gradient is a bf16 sum of its rows, as the
    reference's, whose rounding differs between summation orders by far
    more than the rest: 18 % of the scale at S 2,048 in the CPU proxy.)"""
    seen, count = np.unique(tokens, return_counts=True)
    seen = seen[count == 1]
    half = cfg.vocab_size // 2
    vocab = np.concatenate([seen[seen < half][:MESH_TRAIN_ROWS // 2],
                            seen[seen >= half][:MESH_TRAIN_ROWS // 2]])
    rng = np.random.default_rng(0)
    return {"embed.table": vocab, "lm_head.table": vocab,
            "units.20.l0.mlp.w_up.w": np.sort(rng.choice(
                cfg.d_model, MESH_TRAIN_ROWS, replace=False)),
            "units.20.l0.mix.wq.b": None, "final_norm.g": None}


def take_rows(torch, t, rows):
    """Rows (of dim 0; all when None) of a leaf, placed or plain, as a host
    float64 array on every rank: a placed leaf's ranks each fill the rows
    they hold and one all-reduce over the dims its rows are cut on puts
    them together (every rank of the mesh calls this)."""
    from repro_torch.models import meshctx
    from repro_torch.optim.adamw import _offset

    t = t.detach()
    if not meshctx.is_dtensor(t) or rows is None:
        whole = meshctx.full(t)
        got = whole if rows is None else whole[torch.as_tensor(
            rows, device=whole.device)]
        return got.double().cpu().numpy()
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    cut = tuple(names[i] for i, p in enumerate(t.placements)
                if p.is_shard() and p.dim == 0)
    local = meshctx.gather(t, tuple(a for a in names if a not in cut))
    idx = torch.as_tensor(rows, device=local.device) - _offset(t, 0)
    hit = (idx >= 0) & (idx < local.shape[0])
    got = torch.zeros((len(rows),) + tuple(local.shape[1:]),
                      dtype=torch.float32, device=local.device)
    got[hit] = local[idx[hit]].float()
    return meshctx.all_reduce_(got, cut, mesh=mesh).double().cpu().numpy()


def sample_state(torch, state, rows):
    """{"<leaf>/p", "<leaf>/m/q", …: sampled rows} of a train state."""
    params = dict(state["params"].named_parameters())
    out = {}
    for name, r in rows.items():
        out[f"{name}/p"] = take_rows(torch, params[name], r)
        for k in ("m", "v"):
            mv = state["opt"][k][name]
            for j, t in (mv.items() if isinstance(mv, dict) else [("", mv)]):
                out[f"{name}/{k}{'/' + j if j else ''}"] = take_rows(
                    torch, t, r)
    return out


def local_bytes(tree) -> int:
    """Bytes this rank holds of a (placed) tree."""
    import torch

    from repro_torch.models import meshctx

    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    t = meshctx.local(tree)
    return t.numel() * t.element_size()


def mesh_train_run(torch, np, dev, batch_path):
    """The train state drawn from a generator seeded 0 on the card (placed
    by ``state_specs`` when a mesh is set) and ``MESH_TRAIN_STEPS`` steps of
    the batch at ``batch_path``: (record, sampled rows after the first
    step). Per
    step the metrics, CUDA-event ms and host ms, the collectives by kind
    and the host's seconds inside them (``meshctx``); the state's local
    bytes, peak memory."""
    from repro_torch.models import meshctx
    from repro_torch.training import make_train_step

    cfg, tcfg = mesh_train_config()
    hb = dict(np.load(batch_path))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in hb.items()}
    init, step_fn, _ = make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state, init_s = host_s(torch, lambda: init(
        torch.Generator(device=dev).manual_seed(0)))
    rec = {"init_s": init_s, "held_before_bytes": held,
           "local_bytes": {"params": local_bytes(state["params"]),
                           "opt": local_bytes(state["opt"]["m"])
                           + local_bytes(state["opt"]["v"])},
           "init_peak_bytes": torch.cuda.max_memory_allocated(),
           "steps": []}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    rows = {}
    torch.cuda.reset_peak_memory_stats()
    for s in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        meshctx.reset_collective_counts()
        h0 = time.perf_counter()
        ev0.record()
        state, met = step_fn(state, batch)
        ev1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        met = {k: float(v) for k, v in met.items()}
        if not all(np.isfinite(v) for v in met.values()):
            fail(f"mesh train step {s}: metrics {met}")
        rec["steps"].append(dict(
            met, ms=ev0.elapsed_time(ev1), host_ms=host_ms,
            collectives=meshctx.collective_counts(),
            collective_host_ms={k: v * 1e3 for k, v in
                                meshctx.collective_seconds().items()}))
        if s == 0:
            rows = sample_state(torch, state, mesh_train_rows(
                np, cfg, hb["tokens"]))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state
    return rec, rows


def mesh_train_reckon(cfg, S, ranks, shape):
    """Device bytes reckoned for ``ranks`` ranks of mesh ``shape`` on one
    card, each holding its block of the 8-bit state: weights and
    gradients (float32), moments (int8 codes + a float32 scale a 256-block
    where the reference's rule codes them, float32 otherwise, ≈ 2 B an
    element), and the larger of the step's activations (its row's
    vocab-parallel logits, their exponentials and gradient in float32; the
    units' bf16 carries) and the optimizer's temporaries (four float32
    copies of the largest local leaf, the table's block); a CUDA context
    of 0.6 GB each, one more for the parent."""
    dp, mp = shape
    table = cfg.vocab_size * cfg.d_model
    n_tables = 1 if cfg.tie_embeddings else 2
    body = cfg.param_count() - n_tables * table
    local = n_tables * table / mp + body / (dp * mp)
    state = local * (4 + 4 + 2)
    rows = MESH_TRAIN_B // dp
    act = (3 * rows * S * cfg.vocab_size / mp * 4
           + cfg.n_layers * rows * S * cfg.d_model * 2)
    opt = 4 * table / mp * 4
    return {"per_rank": state + max(act, opt) + 0.6e9,
            "total": ranks * (state + max(act, opt) + 0.6e9) + 0.6e9,
            "local_params": local}


def sampled_diff(np, got, want, *, lr) -> dict:
    """How far sampled rows of a train state after one step
    (``sample_state``) are from another run's: the largest weight
    difference over lr, the share of weights more than 0.1·lr apart, the
    largest code difference and the share of codes more than one apart,
    the largest relative scale difference, the 8-bit moments' decoded
    values' largest difference over their block's scale, float32 moments'
    largest difference over the leaf's largest |m|."""
    from repro_torch.optim.adamw import BLOCK

    def decoded(q, scale, kind):
        y = q / 127.0
        y = np.abs(y) * y if kind == "sq" else y ** 4
        return y * np.repeat(scale, BLOCK, axis=-1)

    rec = {"weight_over_lr": 0.0, "code": 0, "scale_rel": 0.0,
           "moment8_rel": 0.0, "moment_rel": 0.0}
    by_key = {}
    moved = total = codes = off = 0
    for key, w in want.items():
        g = got[key]
        d = np.abs(g - w)
        if key.endswith("/p"):
            name, val = "weight_over_lr", float(d.max() / lr)
            moved += int((d > 0.1 * lr).sum())
            total += d.size
        elif key.endswith("/q"):
            name, val = "code", int(d.max())
            off += int((d > 1).sum())
            codes += d.size
            sk = key[:-1] + "scale"
            kind = "sq" if key.endswith("/m/q") else "q4"
            ref_scale = np.repeat(np.maximum(want[sk], 1e-30), BLOCK, -1)
            m8 = float((np.abs(decoded(g, got[sk], kind)
                               - decoded(w, want[sk], kind))
                        / ref_scale).max())
            rec["moment8_rel"] = max(rec["moment8_rel"], m8)
            by_key[key[:-2] + "/decoded"] = m8
        elif key.endswith("/scale"):
            name, val = "scale_rel", float(
                (d / np.maximum(np.abs(w), 1e-30)).max())
        else:
            name, val = "moment_rel", float(
                d.max() / max(np.abs(w).max(), 1e-30))
        rec[name] = max(rec[name], val)
        by_key[key] = val
    rec["weight_moved_share"] = moved / max(total, 1)
    rec["code_share"] = off / max(codes, 1)
    rec["by_key"] = by_key
    return rec


# (a)'s bounds in ``sampled_diff``'s terms: phase 13's float32 bounds
# (weights within 1e-3·lr but at the floor, where Adam's ±lr step may go
# the other way: at most one in a thousand more than 0.1·lr apart, none
# more than 2·lr; codes ±1; scales and float32 moments 2e-4).
WORLD_OF_ONE_BOUNDS = {"weight_over_lr": 2.0 + 1e-3,
                       "weight_moved_share": 1e-3, "code": 1,
                       "code_share": 0.0, "scale_rel": 2e-4,
                       "moment8_rel": 2 * 2 / 127, "moment_rel": 2e-4}


def hold_sampled(np, got, want, *, lr, bounds):
    rec = sampled_diff(np, got, want, lr=lr)
    bad = {k: v for k, v in rec.items() if k in bounds and not v <= bounds[k]}
    if bad:
        fail(f"sampled blocks differ beyond their bounds: {bad} ({rec}, "
             f"bounds {bounds})")
    return rec


def metric_diff(met, want) -> dict:
    """Relative differences of a step's metrics from another run's."""
    return {k: abs(met[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in ("loss", "ce", "grad_norm", "lr")}


def hold_metrics(met, want, rel):
    rec = metric_diff(met, want)
    bad = {k: v for k, v in rec.items() if not v <= rel}
    if bad:
        fail(f"metrics {met} against {want}: {bad} > {rel}")
    return rec


def mesh_train_ranks(root, wd):
    """Phase 15's four ranks (``MESH_TRAIN_CHILD``) on the card; their
    records by rank and the wall seconds."""
    ranks = MESH_TRAIN_SHAPE[0] * MESH_TRAIN_SHAPE[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_TRAIN_CHILD, str(r), str(ranks), wd,
         root], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(ranks)]
    results = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=MESH_TRAIN_CHILD_TIMEOUT_S)
            results.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    child = {}
    for r, (rc, o, e) in enumerate(results):
        if rc != 0:
            fail(f"mesh train rank {r} exited {rc}: {e[-3000:]}")
        for line in o.splitlines():
            if line.startswith('{"mesh_train_child"'):
                child[r] = json.loads(line)["mesh_train_child"]
    if sorted(child) != list(range(ranks)):
        fail(f"mesh train ranks printed no record: {sorted(child)}")
    return child, time.perf_counter() - t0


def run_mesh_train_path(torch, np, dev, root, reset_counts, counts):
    """The LM train step on a mesh (``make_train_step`` under
    ``meshctx.use_mesh``: the placed train state, the differentiable
    collectives, the vocab-parallel loss, the placed 8-bit AdamW), plain
    eager PyTorch, none of the EDM kernels (counts 0). qwen1.5-4b as
    configured, ``adamw8bit``, the same drawn state (seed 0) and batch
    (``TokenPipeline`` seed 0) in each run: the no-mesh step first (its
    metrics and sampled rows kept on the host, the state freed); (a) a
    world of one on NCCL, mesh (1, 1), held to it at phase 13's bounds;
    (b) four gloo ranks on the card, mesh (2, 2), one row a dp group,
    held to (a) at ``MESH_TRAIN_BOUNDS``. Returns (record, launches)."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import meshctx

    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t_phase = time.perf_counter()
    cfg, tcfg = mesh_train_config()
    ranks = MESH_TRAIN_SHAPE[0] * MESH_TRAIN_SHAPE[1]
    S = MESH_TRAIN_S
    reckon = mesh_train_reckon(cfg, S, ranks, MESH_TRAIN_SHAPE)
    if reckon["total"] > MESH_TRAIN_CAP:
        S = 1024
        print(json.dumps({"mesh_train_cut": {"S": S, "reckoned": reckon}}),
              flush=True)
        reckon = mesh_train_reckon(cfg, S, ranks, MESH_TRAIN_SHAPE)
    bf16_ops, f32_ops = train_flops(cfg, MESH_TRAIN_B, S)
    out = {"arch": MESH_TRAIN_ARCH, "B": MESH_TRAIN_B, "S": S,
           "optimizer": tcfg.optimizer, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
           "params": cfg.param_count(), "reckoned": reckon,
           "flop_bound_ms": (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS)
           * 1e3, "bounds": MESH_TRAIN_BOUNDS}
    secs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    try:
        batch_path = os.path.join(tmp, "batch.npz")
        np.savez(batch_path, **TokenPipeline(
            vocab_size=cfg.vocab_size, batch=MESH_TRAIN_B, seq_len=S,
            seed=0).global_batch(0))
        t0 = time.perf_counter()
        plain, plain_rows = mesh_train_run(torch, np, dev, batch_path)
        gc.collect()
        torch.cuda.empty_cache()
        out["no_mesh"] = plain
        secs["no_mesh"] = time.perf_counter() - t0
        print(json.dumps({"mesh_train_part": "no_mesh", **plain}),
              flush=True)

        t0 = time.perf_counter()  # (a) a world of one on NCCL
        mesh = make_mesh((1, 1), ("data", "model"))
        try:
            with meshctx.use_mesh(mesh):
                one, one_rows = mesh_train_run(torch, np, dev, batch_path)
            one["backend"] = str(dist.get_backend())
        finally:
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        lr = plain["steps"][0]["lr"]
        one["metrics_rel"] = hold_metrics(one["steps"][0],
                                          plain["steps"][0], TRAIN_SMOKE_RTOL)
        one["sampled"] = hold_sampled(np, one_rows, plain_rows, lr=lr,
                                      bounds=WORLD_OF_ONE_BOUNDS)
        out["world_of_one"] = one
        secs["world_of_one"] = time.perf_counter() - t0
        print(json.dumps({"mesh_train_part": "world_of_one", **one}),
              flush=True)

        t0 = time.perf_counter()  # (b) four gloo ranks on the card
        child, wall = mesh_train_ranks(root, tmp)
        rows4 = dict(np.load(os.path.join(tmp, "rows.npz")))
        four = {"mesh": list(MESH_TRAIN_SHAPE), "wall_s": wall,
                "by_rank": child, "sampled_vs_world_of_one": sampled_diff(
                    np, rows4, one_rows, lr=lr)}
        print(json.dumps({"mesh_train_part": "four_ranks", **four}),
              flush=True)
        for r, c in child.items():
            for k in ("loss", "ce", "grad_norm", "lr"):
                if c["steps"][0][k] != child[0]["steps"][0][k]:
                    fail(f"mesh train rank {r}'s {k} differs from rank 0's")
        four["metrics_rel"] = hold_metrics(
            child[0]["steps"][0], one["steps"][0],
            MESH_TRAIN_BOUNDS["metric_rel"])
        four["sampled"] = hold_sampled(np, rows4, one_rows, lr=lr,
                                       bounds=MESH_TRAIN_BOUNDS)
        out["four_ranks"] = four
        secs["four_ranks"] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = dict(secs, phase=time.perf_counter() - t_phase)
    launches = counts()
    if any(launches.values()):
        fail(f"the mesh train path launched EDM kernels: {launches}")
    return out, launches


def dryrun_summary(rec) -> dict:
    """The counts of a dry-run record (``dryrun.analyze``'s layout): FLOPs,
    bytes accessed, the port's collectives by kind and their bytes, and the
    reckoned peak (arguments + the peak of the bytes made in the step)."""
    mem = rec["memory"]
    return {"flops": rec["cost"]["flops"],
            "bytes_accessed": rec["cost"]["bytes accessed"],
            "counts": rec["collectives"]["by_port_kind"]["counts"],
            "collective_bytes": rec["collectives"]["total"],
            "argument_bytes": mem["argument_size_in_bytes"],
            "temp_bytes": mem["temp_size_in_bytes"],
            "peak_bytes": mem["argument_size_in_bytes"]
            + mem["temp_size_in_bytes"], "count_s": rec["count_s"]}


def dryrun_roofline_ms(summary) -> dict:
    """The roofline terms of a counted step, reckoned at H100 SXM rates
    (``launch.roofline``'s constants), in ms."""
    from repro_torch.launch import roofline as rl

    t = {"compute": summary["flops"] / rl.H100_BF16_FLOPS * 1e3,
         "memory": summary["bytes_accessed"] / rl.H100_HBM_BW * 1e3,
         "collective": summary["collective_bytes"] / rl.H100_COLL_BW * 1e3}
    return dict(t, roofline=max(t.values()), dominant=max(t, key=t.get))


def dryrun_held(args) -> dict:
    """The dry run of the steps phases 13-15 ran on the card, each counted
    as the sweep counts a cell (``dryrun.probe``: one and two units) on
    meta tensors: phase 13's no-mesh 8-bit step (B × S ``TRAIN_B`` ×
    ``TRAIN_S``), phase 15's step on a fake (2, 2) world (its config, its
    whole batch, no constraints), and phase 14's sequence-parallel llama3
    decode step on a fake (1, 4) world (counted whole)."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_mesh

    def train(cfg, tcfg, mesh, B, S):
        def build(n_layers, microbatch=None, global_batch=None):
            return dr.train_cell(
                dataclasses.replace(cfg, n_layers=n_layers), tcfg, mesh, B, S,
                constraints=False,
                stack=cfg.n_units if cfg.scan_layers else 1)
        return dryrun_summary(dr.probe(build, cfg.n_units, 1,
                                       len(cfg.pattern), B))

    out = {}
    cfg = get_config(TRAIN_ARCH)
    out["train"] = train(cfg, TrainConfig(
        optimizer="adamw8bit", microbatch=TRAIN_MICRO, warmup_steps=0,
        total_steps=TRAIN_STEPS), None, TRAIN_B, TRAIN_S)
    dr.fake_world(MESH_TRAIN_SHAPE[0] * MESH_TRAIN_SHAPE[1])
    mesh = make_mesh(MESH_TRAIN_SHAPE, ("data", "model"),
                     device_type=args["device"])
    cfg, tcfg = mesh_train_config()
    out["mesh_train"] = train(cfg, tcfg, mesh, MESH_TRAIN_B,
                              args["mesh_train_S"])
    dr.fake_world(MESH_RANKS)
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"),
                     device_type=args["device"])
    out["mesh_decode"] = dryrun_summary(dr.analyze(*dr.serve_cell(
        mesh_config("llama3-8b"), "decode", mesh, LM_PROMPTS,
        args["mesh_s_max"], seqpar=True)))
    out["device_type"] = mesh.device_type
    return out


def dryrun_sweep(root, out_dir):
    """The sweep's children (``python -m repro_torch.launch.dryrun``, the
    cells of one arch on one mesh each, ``DRYRUN_WORKERS`` at once) and
    the roofline (``--probe --report``) over their records: ({cell name:
    record}, report rows, wall seconds)."""
    from repro_torch.configs import cells

    jobs = [(["--arch", a], [(a, s, m) for s in cells(a)], m)
            for m in DRYRUN_MESHES for a in DRYRUN_ARCHS]
    jobs += [(["--arch", "edm_ccm", "--shape", s], [("edm_ccm", s, m)], m)
             for m in DRYRUN_MESHES for s in DRYRUN_EDM]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    rec_dir = os.path.join(out_dir, "dryrun")
    t0 = time.perf_counter()
    running, done = [], []
    try:
        while jobs or running:
            while jobs and len(running) < DRYRUN_WORKERS:
                argv, job_cells, m = jobs.pop(0)
                running.append((job_cells, time.perf_counter(),
                                subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     *argv, "--mesh", m, "--device", DRYRUN_DEVICE, "--out",
                     rec_dir], env=env, cwd=root,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            time.sleep(0.2)
            for item in list(running):
                job_cells, t_start, p = item
                if p.poll() is None:
                    if time.perf_counter() - t_start > DRYRUN_CHILD_TIMEOUT_S:
                        fail(f"dry run of {job_cells} outlived "
                             f"{DRYRUN_CHILD_TIMEOUT_S} s")
                    continue
                running.remove(item)
                log = p.stdout.read()
                if p.returncode != 0:
                    fail(f"dry run of {job_cells} exited {p.returncode}: "
                         f"{log[-3000:]}")
                done += job_cells
    finally:
        for _, _, p in running:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    roof_dir = os.path.join(out_dir, "roofline")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--probe",
         "--report", "--arch", ",".join(DRYRUN_ARCHS), "--dryrun", rec_dir,
         "--out", roof_dir, "--device", DRYRUN_DEVICE], env=env, cwd=root,
        capture_output=True, text=True, timeout=DRYRUN_CHILD_TIMEOUT_S)
    if res.returncode != 0:
        fail(f"roofline report exited {res.returncode}: {res.stderr[-3000:]}")
    records = {}
    for a, s, m in done:
        name = f"{a}__{s}__{m}"
        records[name] = read_json(os.path.join(rec_dir, name + ".json"))
    rows = read_json(os.path.join(roof_dir, "report.json"))
    return records, rows, wall


def run_dryrun_path(torch, np, root, reset_counts, counts, train_out,
                    mesh_out, mtrain_out):
    """Phase 16: the compile-analysis tools on fake meshes (none of the
    EDM kernels: the EDM cell counts the plain versions on meta tensors).
    (a) The sweep (``dryrun_sweep``): every record ``status: ok``. (b) The
    dry run of phases 13-15's own steps (``DRYRUN_CHILD``, beside the
    sweep): phase 15's collectives a step equal to every rank's, phase
    14's llama3 decode step's equal to every rank's, the reckoned peaks
    within ``DRYRUN_MEM_REL`` of phases 13 and 15's; phase 13's FLOPs
    beside ``train_flops``, and the roofline time of phases 13 and 15
    beside their ms a step. Returns (record, launches)."""
    import shutil
    import tempfile

    reset_counts()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    llama = mesh_out["llama3-8b"]["four_ranks"]["by_rank"]
    four = mtrain_out["four_ranks"]["by_rank"]
    held_args = {"mesh_train_S": mtrain_out["S"], "mesh_s_max": LM_S_MAX,
                 "device": DRYRUN_DEVICE}
    child = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD, root, json.dumps(held_args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        records, rows, sweep_s = dryrun_sweep(root, tmp)
        o, e = child.communicate(timeout=DRYRUN_CHILD_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if child.returncode != 0:
        fail(f"the dry-run child exited {child.returncode}: {e[-3000:]}")
    held = next(json.loads(line)["dryrun_child"] for line in o.splitlines()
                if line.startswith('{"dryrun_child"'))

    roof = {(r["arch"], r["shape"]): r for r in rows}
    cells_out = []
    for name, rec in records.items():
        row = {"cell": name, "status": rec["status"],
               "count_s": rec.get("count_s"), "total_s": rec.get("total_s")}
        if rec["status"] == "ok":
            row.update(flops=rec["cost"]["flops"],
                       bytes_accessed=rec["cost"]["bytes accessed"],
                       collectives=rec["collectives"]["counts"],
                       collective_bytes=rec["collectives"]["total"],
                       temp_gb=rec["memory"]["temp_size_in_bytes"] / 1e9)
            r = roof.get((rec["arch"], rec["shape"]))
            if rec["mesh"] == "single" and r is not None:
                row.update(dominant=r["dominant"],
                           roofline_fraction=r["roofline_fraction"],
                           useful_ratio=r["useful_ratio"])
        else:
            row["error"] = rec.get("error")
        cells_out.append(row)
    bad = [c["cell"] for c in cells_out if c["status"] != "ok"]

    # (b) held against the card's runs of this smoke
    strip = ("host_ms", "step_host_ms")
    checks = {"mesh_train_counts": held["mesh_train"]["counts"],
              "mesh_decode_counts": held["mesh_decode"]["counts"]}
    for r, c in four.items():
        for i, st in enumerate(c["steps"]):
            if st["collectives"] != held["mesh_train"]["counts"]:
                fail(f"the dry run counts {held['mesh_train']['counts']} "
                     f"collectives in phase 15's step; rank {r} step {i} "
                     f"counted {st['collectives']}")
    for r, c in llama.items():
        got = {k: v for k, v in c["collectives_a_step"].items()
               if k not in strip}
        if got != held["mesh_decode"]["counts"]:
            fail(f"the dry run counts {held['mesh_decode']['counts']} "
                 f"collectives in phase 14's llama3 decode step; rank {r} "
                 f"counted {got}")
    a8 = train_out["adamw8bit"]
    measured = {"train": a8["peak_bytes"] - a8["held_before_bytes"],
                "mesh_train": max(c["peak_bytes"] for c in four.values())}
    mem = {}
    for k, m in measured.items():
        rel = held[k]["peak_bytes"] / m - 1.0
        mem[k] = {"reckoned_bytes": held[k]["peak_bytes"],
                  "argument_bytes": held[k]["argument_bytes"],
                  "temp_bytes": held[k]["temp_bytes"],
                  "measured_bytes": m, "rel": rel}
        if not abs(rel) <= DRYRUN_MEM_REL:
            fail(f"the dry run reckons a {k} peak of "
                 f"{held[k]['peak_bytes']} B against {m} B measured "
                 f"({rel:+.3f})")
    from repro_torch.configs import get_config

    bf16_ops, f32_ops = train_flops(get_config(TRAIN_ARCH), TRAIN_B, TRAIN_S)
    flops = {"counted": held["train"]["flops"],
             "train_flops": bf16_ops + f32_ops,
             "ratio": held["train"]["flops"] / (bf16_ops + f32_ops)}
    roofline = {
        "train": dict(dryrun_roofline_ms(held["train"]),
                      measured_ms=a8["step_ms_median"]),
        "mesh_train": dict(dryrun_roofline_ms(held["mesh_train"]),
                           measured_ms=[c["steps"][-1]["ms"]
                                        for c in four.values()])}
    out = {"cells": cells_out, "sweep_s": sweep_s, "held": held,
           "counts_equal": checks, "memory": mem, "phase13_flops": flops,
           "roofline_ms": roofline, "rates": (
               "reckoned at H100 SXM rates: 989e12 FLOP/s bf16, 3.35e12 "
               "B/s HBM3, 50e9 B/s a card for collectives"),
           "seconds": time.perf_counter() - t_phase}
    if bad:
        fail(f"dry-run cells not ok: {bad}: "
             f"{[c.get('error') for c in cells_out if c['status'] != 'ok']}")
    launches = counts()
    if any(launches.values()):
        fail(f"the dry-run path launched EDM kernels: {launches}")
    return out, launches


def bench_resume_row(torch, EDM):
    """The reference bench's journal row (``benchmarks/bench_ccm.py``,
    ``_run_resume_overhead``) on the card: ``EDMConfig(E=3, cache=False)``
    on ``tent_map_panel(154, 1600, seed=7)``, best of 3 calls of
    ``xmap()`` and of ``xmap(run_dir=)``, each on a fresh session, the run
    dir made and removed outside the timed region; beside its 5 % bound.
    Reported, not gated: the journal's fixed host parts exceed 5 % of a
    call of this size."""
    import shutil
    import tempfile

    from repro_torch.data.timeseries import tent_map_panel

    panel = tent_map_panel(N_SERIES, LENGTH, seed=BENCH_SEED)
    EDM(panel, E=E_FIXED, cache=False).xmap()   # warm-up

    def best_of(journaled):
        best = float("inf")
        for _ in range(BENCH_ITERS):
            d = (tempfile.mkdtemp(prefix="chip_smoke_bench_") if journaled
                 else None)
            sess = EDM(panel, E=E_FIXED, cache=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.xmap(run_dir=d)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)
        return best

    t_plain = best_of(False)
    t_j = best_of(True)
    return {"config": "EDMConfig(E=3, cache=False), tent_map_panel(154, "
                      "1600, seed=7), best of 3",
            "plain_s": t_plain, "journaled_s": t_j,
            "pairs_per_s_journaled": N_SERIES * N_SERIES / t_j,
            "overhead": t_j / t_plain - 1.0, "bound": RESUME_OVERHEAD_MAX,
            "within": t_j / t_plain - 1.0 <= RESUME_OVERHEAD_MAX}


def run_links(sess, links):
    """The slice path's link calls on one session → per-link results."""
    out = []
    for f, d in links:
        out.append((sess.ccm(f, d, lib_sizes=LIB_SIZES), sess.ccm(f, d),
                    sess.surrogate_test(f, d, num_surrogates=NUM_SURROGATES,
                                        lib_sizes=SURR_SIZES, seed=0)))
    return out


def main() -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        fail("src/repro_torch is missing beside chip_smoke.py")
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    from repro_torch import core
    from repro_torch.core.ccm import normalize_lib_sizes
    from repro_torch.data.timeseries import forced_network_panel
    from repro_torch.edm import EDM
    from repro_torch.edm.plan import panel_master
    from repro_torch.core.smap_engine import (DEFAULT_THETAS,
                                              _series_per_launch)
    from repro_torch.kernels import (_build, knn_append, knn_batch, knn_fused,
                                     knn_multi_e, lookup, ops, pairwise_dist,
                                     ref, smap_gram, topk)

    # The plain versions' matrix products in full float32, as the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # --------------------------------------------------------- 3. kernels
    panel = forced_network_panel(N_SERIES, LENGTH, seed=SEED)[0]
    X = torch.as_tensor(panel, device=dev)
    lib_caps, _ = normalize_lib_sizes(LIB_SIZES, Lp=LENGTH - (E_FIXED - 1))
    rows_out = check_main_path_kernels(torch, X, knn_multi_e, knn_batch,
                                       lookup, ref)
    x_long = torch.as_tensor(
        forced_network_panel(4, LONG_L, seed=SEED)[0][3], device=dev)
    rows_out += check_slice_kernels(torch, X, x_long, pairwise_dist, topk,
                                    lookup, ref, lib_caps)
    smap_row, smap_shapes = check_smap_kernel(torch, X, smap_gram, ref,
                                              DEFAULT_THETAS)
    rows_out.append(smap_row)
    append_row, append_shapes = check_append_kernel(torch, X, knn_multi_e,
                                                    knn_append, ref)
    rows_out.append(append_row)
    x_huge = torch.as_tensor(
        forced_network_panel(4, HUGE_L, seed=SEED)[0][3], device=dev)
    variant_rows, variant_errs = check_variant_kernels(
        torch, X, x_long, x_huge, pairwise_dist, knn_fused, topk, ref)
    del x_huge
    rows_out += variant_rows
    for r in rows_out:
        print(json.dumps({"kernel_check": r}))
    print(json.dumps({"smap_gram_shapes": smap_shapes}))
    print(json.dumps({"knn_append_shapes": append_shapes,
                      "mxu_errors": variant_errs}))

    wrappers = {"knn_multi_e": knn_multi_e.all_knn_multi_e,
                "knn_batch": knn_batch.all_knn_batch,
                "lookup_rho": lookup.lookup_rho,
                "pairwise_distances": pairwise_dist.pairwise_distances,
                "topk_select": topk.topk_select,
                "topk_select_sizes": topk.topk_select_sizes,
                "lookup": lookup.lookup,
                "smap_gram": smap_gram.smap_gram,
                "knn_append": knn_append.master_append,
                "pairwise_distances_mxu": pairwise_dist.pairwise_distances_mxu,
                "knn_fused": knn_fused.all_knn_fused}

    def reset_counts():
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def set_counts(c):
        for name, fn in wrappers.items():
            fn.launches = c[name]

    def delta(before):
        return {n: c - before[n] for n, c in counts().items()
                if c != before[n]}

    # ------------------------------------------------------- 4. main path
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = EDM(panel, E_max=E_MAX)
    E_opt, rho = sess.optimal_E()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt_launches = {n: c for n, c in counts().items() if c}
    if opt_launches.get("knn_multi_e") != 1:
        fail(f"optimal_E launched {opt_launches}, not one knn_multi_e")
    xm = sess.xmap()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    xm3 = EDM(panel, E=E_FIXED).xmap()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    main_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("knn_multi_e", "knn_batch", "lookup_rho"):
        if main_launches[name] <= 0:
            fail(f"the main path launched {name} no time")
    for name, m in (("xmap", xm), ("xmap E=3", xm3)):
        if m.shape != (N_SERIES, N_SERIES) or not np.isfinite(m).all():
            fail(f"{name}: shape {m.shape} or non-finite values")
    if rho.shape != (N_SERIES, E_MAX) or not np.isfinite(rho).all():
        fail(f"optimal_E: rho shape {rho.shape} or non-finite values")
    # The counted run was the warm-up; now RUNS timed runs of each call.
    t_opt = [host_s(torch, lambda: EDM(panel, E_max=E_MAX).optimal_E())[1]
             for _ in range(RUNS)]
    t_xm = [host_s(torch, sess.xmap)[1] for _ in range(RUNS)]
    t_xm3 = [host_s(torch, lambda: EDM(panel, E=E_FIXED).xmap())[1]
             for _ in range(RUNS)]
    pairs = N_SERIES * N_SERIES
    print(json.dumps({"main_path": {
        "first_run_s": {"optimal_E": t1 - t0, "xmap_master": t2 - t1,
                        "xmap_fixed_E": t3 - t2},
        "optimal_E": spread(t_opt), "xmap_master": spread(t_xm),
        "xmap_fixed_E": spread(t_xm3),
        "pairs_per_s_master": pairs / statistics.median(t_xm),
        "pairs_per_s_fixed_E": pairs / statistics.median(t_xm3),
        "peak_bytes": peak, "launches_optimal_E": opt_launches,
        "E_opt_hist": {int(e): int((E_opt == e).sum())
                       for e in np.unique(E_opt)},
        "launches": {n: c for n, c in main_launches.items() if c}}}))

    sess_r = EDM(panel, E_max=E_MAX, impl="ref")
    E_opt_r, rho_r = sess_r.optimal_E()
    xm_r = sess_r.xmap()
    xm3_r = EDM(panel, E=E_FIXED, impl="ref").xmap()
    srt = np.sort(rho_r, axis=1)
    gap = float((srt[:, -1] - srt[:, -2]).min())
    errs = {"rho_E": float(np.abs(rho - rho_r).max()),
            "xmap": float(np.abs(xm - xm_r).max()),
            "xmap_fixed_E": float(np.abs(xm3 - xm3_r).max())}
    print(json.dumps({"main_path_vs_plain": dict(
        errs, E_opt_equal=bool((E_opt == E_opt_r).all()),
        min_top2_rho_gap=gap)}))
    if not (E_opt == E_opt_r).all():
        fail(f"E_opt differs from the plain run in "
             f"{int((E_opt != E_opt_r).sum())} series")
    for name, e in errs.items():
        if not e <= RHO_ATOL:
            fail(f"{name} differs from the plain run by {e}")

    # ------------------------------------------------------ 5. slice path
    # The strongest links by the CCM asymmetry: A[j, d] = ρ[j, d] − ρ[d, j]
    # is the evidence that d drives j (d cross-mapped from j's manifold).
    A = xm - xm.T
    np.fill_diagonal(A, -np.inf)
    links = [(int(f) // N_SERIES, int(f) % N_SERIES)
             for f in np.argsort(-A, axis=None)[:NUM_LINKS]]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    per_call = {"ccm_sweep": [], "ccm_full": [], "surrogate_test": []}
    res = []
    for f, d in links:
        before = counts()
        sweep = sess.ccm(f, d, lib_sizes=LIB_SIZES)
        per_call["ccm_sweep"].append(delta(before))
        before = counts()
        full = sess.ccm(f, d)
        per_call["ccm_full"].append(delta(before))
        before = counts()
        sig = sess.surrogate_test(f, d, num_surrogates=NUM_SURROGATES,
                                  lib_sizes=SURR_SIZES, seed=0)
        per_call["surrogate_test"].append(delta(before))
        res.append((sweep, full, sig))
    before = counts()
    skill = EDM(panel, E=E_FIXED, cache=False).simplex()
    per_call["simplex_uncached"] = delta(before)
    before = counts()
    E_unc, rho_unc = EDM(panel, E_max=E_MAX, cache=False).optimal_E()
    per_call["optimal_E_uncached"] = delta(before)
    torch.cuda.synchronize()
    slice_launches = counts()
    slice_peak = torch.cuda.max_memory_allocated()

    # One pairwise and one multi-cap top-k launch per curve grid, however
    # many sizes; the full-library ccm derives from the master (no kNN).
    grid = {"pairwise_distances": 1, "topk_select_sizes": 1}
    for name, n_sizes in (("ccm_sweep", len(LIB_SIZES)),
                          ("surrogate_test", len(SURR_SIZES))):
        for c in per_call[name]:
            if c != dict(grid, lookup_rho=n_sizes):
                fail(f"{name} launched {c}, not one pairwise and one "
                     f"multi-cap top-k per curve grid")
    for c in per_call["ccm_full"]:
        if c != {"lookup_rho": 1}:
            fail(f"full-library ccm launched {c}, not one lookup_rho")
    want = {"pairwise_distances": N_SERIES, "topk_select": N_SERIES,
            "lookup": N_SERIES}
    if per_call["simplex_uncached"] != want:
        fail(f"uncached simplex launched {per_call['simplex_uncached']}")
    if per_call["optimal_E_uncached"] != {"knn_multi_e": N_SERIES,
                                          "lookup_rho": N_SERIES * E_MAX}:
        fail(f"uncached optimal_E launched {per_call['optimal_E_uncached']}")
    for name in ("pairwise_distances", "topk_select", "topk_select_sizes",
                 "lookup"):
        if slice_launches[name] <= 0:
            fail(f"the slice path launched {name} no time")

    # What comes out: finite curves of the expected shapes, the full-library
    # ccm equal to the xmap entry it re-derives, E_opt as the cached run's.
    for (f, d), (sweep, full, sig) in zip(links, res):
        if sweep.shape != (len(LIB_SIZES),) or not np.isfinite(sweep).all():
            fail(f"ccm({f}, {d}, lib_sizes=...) gave {sweep}")
        if not abs(float(full) - float(xm[f, d])) <= RHO_ATOL:
            fail(f"ccm({f}, {d}) = {full} but xmap has {xm[f, d]}")
        if sig.surrogate_rho.shape != (len(SURR_SIZES), NUM_SURROGATES) or \
                not np.isfinite(sig.surrogate_rho).all() or \
                not ((sig.pvalue > 0) & (sig.pvalue <= 1)).all():
            fail(f"surrogate_test({f}, {d}) gave a malformed result")
    if skill.shape != (N_SERIES,) or not np.isfinite(skill).all():
        fail("uncached simplex: shape or non-finite values")
    if not (E_unc == E_opt).all():
        fail(f"uncached optimal_E's E_opt differs from the cached session's "
             f"in {int((E_unc != E_opt).sum())} series")

    # Timed runs (the counted run was the warm-up).
    t_calls = {"ccm_sweep": [], "ccm_full": [], "surrogate_test": []}
    for _ in range(RUNS):
        for f, d in links:
            t_calls["ccm_sweep"].append(host_s(
                torch, lambda: sess.ccm(f, d, lib_sizes=LIB_SIZES))[1])
            t_calls["ccm_full"].append(host_s(torch,
                                              lambda: sess.ccm(f, d))[1])
            t_calls["surrogate_test"].append(host_s(
                torch, lambda: sess.surrogate_test(
                    f, d, num_surrogates=NUM_SURROGATES,
                    lib_sizes=SURR_SIZES, seed=0))[1])
    t_calls["simplex_uncached"] = [host_s(torch, lambda: EDM(
        panel, E=E_FIXED, cache=False).simplex())[1] for _ in range(RUNS)]
    t_calls["optimal_E_uncached"] = [host_s(torch, lambda: EDM(
        panel, E_max=E_MAX, cache=False).optimal_E())[1] for _ in range(RUNS)]
    print(json.dumps({"slice_path": {
        "links": links, "seconds_per_call": {
            n: spread(v) for n, v in t_calls.items()},
        "launches_per_call": {
            "ccm_sweep": per_call["ccm_sweep"][0],
            "ccm_full": per_call["ccm_full"][0],
            "surrogate_test": per_call["surrogate_test"][0],
            "simplex_uncached": per_call["simplex_uncached"],
            "optimal_E_uncached": per_call["optimal_E_uncached"]},
        "launches": {n: c for n, c in slice_launches.items() if c},
        "peak_bytes": slice_peak,
        "convergence_first_link": [float(v) for v in res[0][0]],
        "pvalues_first_link": [float(v) for v in res[0][2].pvalue]}}))

    # Where the device time goes: each call once under the profiler.
    f, d = links[0]
    print(json.dumps({"device_profile": {
        "optimal_E": device_profile(
            torch, lambda: EDM(panel, E_max=E_MAX).optimal_E()),
        "xmap_master": device_profile(torch, sess.xmap),
        "xmap_fixed_E": device_profile(
            torch, lambda: EDM(panel, E=E_FIXED).xmap()),
        "ccm_sweep": device_profile(
            torch, lambda: sess.ccm(f, d, lib_sizes=LIB_SIZES)),
        "ccm_full": device_profile(torch, lambda: sess.ccm(f, d)),
        "surrogate_test": device_profile(torch, lambda: sess.surrogate_test(
            f, d, num_surrogates=NUM_SURROGATES, lib_sizes=SURR_SIZES,
            seed=0)),
        "simplex_uncached": device_profile(torch, lambda: EDM(
            panel, E=E_FIXED, cache=False).simplex()),
        "optimal_E_uncached": device_profile(torch, lambda: EDM(
            panel, E_max=E_MAX, cache=False).optimal_E())}}))

    # Against the plain versions on the card.
    res_r = run_links(sess_r, links)
    rho_err = null_err = 0.0
    near = 0
    for (sweep, full, sig), (sw_r, fu_r, sg_r) in zip(res, res_r):
        rho_err = max(rho_err, float(np.abs(sweep - sw_r).max()),
                      abs(float(full) - float(fu_r)),
                      float(np.abs(sig.rho - sg_r.rho).max()))
        null_err = max(null_err, float(np.abs(sig.surrogate_rho
                                              - sg_r.surrogate_rho).max()))
        close = (np.abs(sg_r.surrogate_rho - sg_r.rho[:, None])
                 <= P_MARGIN).any(axis=1)
        near += int(close.sum())
        if not ((sig.pvalue == sg_r.pvalue) | close).all():
            fail(f"p-values {sig.pvalue} differ from the plain run's "
                 f"{sg_r.pvalue} away from any near-tie")
    skill_r = EDM(panel, E=E_FIXED, cache=False, impl="ref").simplex()
    E_unc_r, rho_unc_r = EDM(panel, E_max=E_MAX, cache=False,
                              impl="ref").optimal_E()
    errs = {"ccm_rho": rho_err, "surrogate_null_rho": null_err,
            "simplex_rho": float(np.abs(skill - skill_r).max()),
            "optimal_E_uncached_rho": float(np.abs(rho_unc
                                                   - rho_unc_r).max())}
    print(json.dumps({"slice_path_vs_plain": dict(
        errs, pvalue_cells_with_a_null_within_margin=near,
        pvalue_cells=NUM_LINKS * len(SURR_SIZES),
        E_opt_equal=bool((E_unc == E_unc_r).all()))}))
    for name, e in errs.items():
        if not e <= RHO_ATOL:
            fail(f"slice path: {name} differs from the plain run by {e}")
    if not (E_unc == E_unc_r).all():
        fail("uncached optimal_E: E_opt differs from the plain run")

    # ------------------------------------------------------ 6. S-Map path
    groups = {int(e): np.nonzero(E_opt == e)[0] for e in np.unique(E_opt)}
    smap_calls = {
        "smap": sess.smap,
        "xmap_smap": lambda: sess.xmap(method="smap", theta=SMAP_THETA),
        "xmap_smap_fixed_E": lambda: EDM(panel, E=E_FIXED).xmap(
            method="smap")}
    reset_counts()
    smap_out, smap_per_call, smap_peak = {}, {}, {}
    for name, fn in smap_calls.items():
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        smap_out[name] = fn()
        torch.cuda.synchronize()
        smap_per_call[name] = delta(before)
        smap_peak[name] = torch.cuda.max_memory_allocated()
    smap_launches = counts()
    # One launch per chunk of an E-group's series (the sweep), one per
    # E-group (the xmap: B = N libraries), one for the fixed-E xmap.
    rows_smap = {e: LENGTH - (e - 1) - 1 for e in groups}
    want = {"smap": sum(
        -(-len(m) // _series_per_launch(len(m), rows_smap[e],
                                        len(DEFAULT_THETAS), e, dev))
        for e, m in groups.items()),
        "xmap_smap": len(groups), "xmap_smap_fixed_E": 1}
    for name, n in want.items():
        if smap_per_call[name] != {"smap_gram": n}:
            fail(f"{name} launched {smap_per_call[name]}, not {n} smap_gram")
    sw, xs1, xs3 = (smap_out[n] for n in smap_calls)
    if sw.shape != (N_SERIES, len(DEFAULT_THETAS)) or \
            not np.isfinite(sw).all():
        fail(f"smap(): shape {sw.shape} or non-finite values")
    for name, m in (("xmap_smap", xs1), ("xmap_smap_fixed_E", xs3)):
        if m.shape != (N_SERIES, N_SERIES) or not np.isfinite(m).all():
            fail(f"{name}: shape {m.shape} or non-finite values")
    t_smap = {name: [host_s(torch, fn)[1] for _ in range(RUNS)]
              for name, fn in smap_calls.items()}
    print(json.dumps({"smap_path": {
        "E_groups": {e: len(m) for e, m in groups.items()},
        "seconds_per_call": {n: spread(v) for n, v in t_smap.items()},
        "pairs_per_s": {n: N_SERIES * N_SERIES / statistics.median(t_smap[n])
                        for n in ("xmap_smap", "xmap_smap_fixed_E")},
        "launches_per_call": smap_per_call, "peak_bytes": smap_peak,
        "rho_theta_median": [float(v) for v in np.median(sw, axis=0)]}}))
    print(json.dumps({"smap_device_profile": {
        name: device_profile(torch, fn) for name, fn in smap_calls.items()}}))
    print(json.dumps({"smap_solve": solve_yardstick(
        torch, X, smap_gram, groups, DEFAULT_THETAS)}))

    sw_r = sess_r.smap()
    xs1_r = sess_r.xmap(method="smap", theta=SMAP_THETA)
    xs3_r = EDM(panel, E=E_FIXED, impl="ref").xmap(method="smap")
    errs = {f"smap_rho_theta_{t}": float(np.abs(sw[:, i] - sw_r[:, i]).max())
            for i, t in enumerate(DEFAULT_THETAS)}
    errs["xmap_smap"] = float(np.abs(xs1 - xs1_r).max())
    errs["xmap_smap_fixed_E"] = float(np.abs(xs3 - xs3_r).max())
    # The pair where the two runs differ most, against a float64 solve.
    worst = {}
    for name, k, p, E_of in (("xmap_smap", xs1, xs1_r, lambda t: E_opt[t]),
                             ("xmap_smap_fixed_E", xs3, xs3_r,
                              lambda t: E_FIXED)):
        li, ti = np.unravel_index(np.argmax(np.abs(k - p)), k.shape)
        r64 = smap_rho64(np, panel[li], panel[ti], E=int(E_of(ti)), Tp=0,
                         theta=SMAP_THETA)
        worst[name] = {"pair": [int(li), int(ti)], "kernel": float(k[li, ti]),
                       "plain": float(p[li, ti]), "float64": r64}
    print(json.dumps({"smap_path_vs_plain": dict(errs, worst_pair=worst)}))
    for i, t in enumerate(DEFAULT_THETAS):
        if not errs[f"smap_rho_theta_{t}"] <= smap_rho_tol(t):
            fail(f"smap() at θ={t} differs from the plain run by "
                 f"{errs[f'smap_rho_theta_{t}']}")
    for name in ("xmap_smap", "xmap_smap_fixed_E"):
        if not errs[name] <= smap_rho_tol(SMAP_THETA):
            fail(f"{name} differs from the plain run by {errs[name]}")

    # ------------------------------------------------- 7. append path
    append_out, append_launches = run_append_path(
        torch, np, panel, dev, EDM, panel_master, knn_append, reset_counts,
        counts)
    print(json.dumps({"append_path": {"L0": APPEND_L0, "per_dt": append_out}}))

    # ------------------------------------------- 8. kNN variants path
    variants_out, variant_launches = run_variants_path(
        torch, X, x_long, core, ops, pairwise_dist, ref, reset_counts, counts)
    print(json.dumps({"variants_path": variants_out}))

    # ---------------------------------------------- 9. journal path
    journal_out, journal_launches = run_journal_path(
        torch, np, panel, root, X, EDM, core, reset_counts, counts, xm, xm3,
        smap_out["xmap_smap_fixed_E"])
    print(smi)
    print(json.dumps({"journal_path": journal_out}))
    for name in ("knn_multi_e", "knn_batch", "lookup_rho",
                 "pairwise_distances", "topk_select", "smap_gram"):
        if journal_launches[name] <= 0:
            fail(f"the journal path launched {name} no time")

    # --------------------------------------------- 10. serving path
    serving_out, serving_launches = run_serving_path(
        torch, np, root, EDM, reset_counts, counts, set_counts)
    print(smi)
    print(json.dumps({"serving_path": serving_out}))

    # --------------------------------------------- 11. sharded path
    sharded_out, sharded_launches = run_sharded_path(
        torch, np, panel, root, X, E_opt, EDM, core, reset_counts, counts)
    print(smi)
    print(json.dumps({"sharded_path": sharded_out}))

    # ------------------------------------------------ 12. LM serving path
    lm_out, lm_launches = run_lm_path(torch, np, dev, reset_counts, counts)
    print(smi)
    print(json.dumps({"lm_path": lm_out}))

    # ----------------------------------------------- 13. LM training path
    train_out, train_launches = run_train_path(torch, np, dev, root,
                                               reset_counts, counts)
    print(smi)
    print(json.dumps({"train_path": train_out}))

    # ------------------------------------------------ 14. LM mesh path
    mesh_out, mesh_launches = run_mesh_path(torch, np, dev, root,
                                            reset_counts, counts)
    print(smi)
    print(json.dumps({"mesh_path": mesh_out}))

    # ---------------------------------------- 15. LM train step on a mesh
    mtrain_out, mtrain_launches = run_mesh_train_path(
        torch, np, dev, root, reset_counts, counts)
    print(smi)
    print(json.dumps({"mesh_train_path": mtrain_out}))

    # ------------------------------------------------------ 16. dry run
    dry_out, dry_launches = run_dryrun_path(
        torch, np, root, reset_counts, counts, train_out, mesh_out,
        mtrain_out)
    print(smi)
    print(json.dumps({"dryrun_path": dry_out}))

    path_of = {"knn_multi_e": main_launches, "knn_batch": main_launches,
               "lookup_rho": main_launches, "smap_gram": smap_launches,
               "knn_append": append_launches,
               "pairwise_distances_mxu": variant_launches,
               "knn_fused": variant_launches}
    for r in rows_out:
        r["launches"] = path_of.get(r["name"], slice_launches)[r["name"]]
        r["serving_launches"] = serving_launches[r["name"]]
        r["sharded_launches"] = sharded_launches[r["name"]]
        r["lm_launches"] = lm_launches[r["name"]]
        r["train_launches"] = train_launches[r["name"]]
        r["mesh_launches"] = mesh_launches[r["name"]]
        r["mesh_train_launches"] = mtrain_launches[r["name"]]
        r["dryrun_launches"] = dry_launches[r["name"]]
        if r["launches"] <= 0:
            fail(f"{r['name']} was launched no time on its path")
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "device_ms"} for r in rows_out]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
