#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--n 1000000] [--batch 1024] [--seed 0]
                          [--wiki-n 1000000] [--months 12]
                          [--serve-months 6]

With no arguments it runs twelve paths, each with the kernels' launch
counts set to 0 just before it and read just after (path 6 runs after
the kernel checks and before path 3, paths 7-12 last, in that order):

1. The main path, the SIFT1M-shaped cell: 1,000,000 clustered synthetic
   vectors of d=128 (L2; a mixture of 8192 Gaussian clusters with sizes
   proportional to i^-0.5, about eight clusters per partition),
   ``QuakeIndex.build`` with P = sqrt(n) = 1000 partitions,
   B=1024 queries at k=100 and recall target 0.9 through an executor
   that names the host (vectorized) planner and through ``search_batch``,
   whose executor names none and so plans with the fused planner on the
   card (gated: ``"fused"``, recall within DEFAULT_PLANNER_RECALL of the
   host planner's), then ``search_batch`` at ``nprobe=32, rounds=1`` and
   in bf16 storage, an insert burst of 10,000 vectors and 5,000 deletes,
   and a search again.
2. int8 serving on the same index: APS rounds and ``nprobe=32,
   rounds=1`` through the int8 executor (IVF-residual codes, the q8 scan
   kernel, exact re-rank of the top-2k), then a second insert/delete
   burst that the int8 executor must serve by a full rebuild.
3. The dynamic loop (paper Fig. 4): the Wikipedia-style workload at
   ``--wiki-n`` vectors of d=128 (inner product; its generator's 12
   months), a latency model profiled on the card (device time per query
   of a B-query scan, with the paper's tau rescaled to it), and per
   month the insert burst, per-query APS searches that record access
   statistics, ``Maintainer.run()``, the index invariants, and one
   batched search through the f32 and the int8 executors, held against
   the exact ground truth.  Each month also reports the pass that the
   single-query latency model would make on the same statistics, rolled
   back after it.
4. Online serving (``launch/serve.replay_runtime``) of the same
   Wikipedia-style workload at ``--wiki-n`` vectors (its first
   ``--serve-months`` months of inserts and 1024 queries; the generator
   makes no deletes): ``ServingRuntime`` with k=10 at recall target 0.9,
   the fused planner (its centroid pass on the card, through the dense
   scan kernel), flushes of 256 queries or after 5 ms (the deadline
   ticker), the
   result cache, drift-triggered maintenance under the default
   triggers, metrics, ``scan_backend="auto"`` (the device rounds on the
   card) and a WAL with checkpoints under a temporary directory
   (``fsync="batch"``).  Then the admission groups after the last write
   replayed through both scan backends (the same ids), one warm flush
   under ``torch.profiler``, those queries again at int8 storage (the q8
   kernel), one more insert burst through a runtime re-attached to the
   WAL directory, and ``ServingRuntime.recover`` on that directory (it
   must replay the insert and land on the live fingerprint).  The
   kernels are held against their plain versions on this path's own
   operands: the largest insert burst's assignment, the largest
   centroid pass, and up to four rounds of each indexed scan (the q8
   scan bit-equal).  It prints recall@10 per month, latency,
   throughput, rounds and riders, cache, maintenance, durability and
   recovery numbers beside the card's name and power limit.
5. LM serving (``LM_CONFIG``, qwen2.5-14b), after the
   Quake paths' tensors are freed.  First exact f32 checks at full width
   and two layers: prefill logits with the flash kernel against the
   plain attention, and decode at position t against a re-prefill over
   t + 1 tokens.  Then the served model at full width and depth in bf16
   from seeded random weights: ``prefill`` of 4 prompts of 4,096 seeded
   tokens, 32 greedy ``decode_step``s into a cache padded to 4,096 + 32,
   gates of 48 flash launches per prefill and none per decode step, the
   flash kernel's share of a warm prefill's device time, and decode step
   8 against a re-prefill of the prompts and their first 8 tokens
   (printed, ungated).  The kernel is held against its plain version at
   layers 0 and 47's operands and the JAX tests' f32 shapes, and timed
   at one request of ``LM_TIME_LEN`` tokens (prefill_32k's).

6. The sharded engine (``core/distributed.py``) inside a one-rank NCCL
   process group (``launch/mesh.make_host_mesh``, so every collective is
   a real NCCL call), on path 1's index after its bursts, at B =
   ``--batch`` and ``EngineConfig(k, nprobe=32, chunk=2, max_rounds=16,
   recall_target=0.9)``: ``search_bruteforce`` (the dense kernel over the
   engine's whole block), ``search_fixed``, ``search_adaptive`` and
   ``search_batch`` at ``scan_impl="union_cuda"`` in f32, then bf16 and
   int8 storage, each warmed and timed, with gates: brute force recall
   against the exact ground truth, ``search_batch`` equal to the
   executor's, the indexed scans of the timed calls held against their
   plain versions on their own operands (the whole batch, in blocks of
   queries), fixed and adaptive against ``"union_torch"`` (the plain
   oracles) and the ``"gather"`` scan on the first queries, int8
   distances bit-equal to ``"union_torch"``, a delta refresh after 100
   inserts and a full rebuild after a structural change.  Then the
   ``quake-ann`` capacity leg: ``IndexSnapshot.synthetic`` at
   configs/quake_arch.py's FULL shape (16,384 × 12,288 × 128) in int8
   storage, ``serve_fixed_1k`` and ``serve_adaptive_1k`` on 1,024 queries
   of the port's own near seeded centroids, the q8 kernel held bit-equal
   to its plain version on the first queries' union.  It prints recall,
   warm wall times, the device's idle share of a warm ``search_fixed`` and
   ``search_adaptive``, rounds, nprobe and launches per leg.

7. Recsys serving (``models/recsys.py``), after the LM path's tensors
   are freed: first each smoke config with the same weights on the card
   and the CPU (forward, serve, retrieval, chunked retrieval, and ids
   out of range both ways) within 1e-5 * |x| + 1e-5.  Then two-tower,
   DLRM RM-2, DIN and SASRec at their published configs
   (``configs/recsys_archs.py``; f32 tables drawn on the card from a
   seed, one model at a time, up to DLRM's 33.3 GB): ``serve_p99`` (B =
   512) and ``serve_bulk`` (B = 262,144) on ``RecsysPipeline`` batches
   in the model's vocabulary and history length, and ``retrieval_cand``
   (one user against 1,000,000 distinct candidates), in chunks of
   65,536 rows; shapes and finite outputs gated.  The two-tower then
   serves its retrieval through Quake: the 1M candidates encoded
   (``item_repr``), 512 users (``user_repr``), the exact top-100 by
   ``retrieval_scores`` + ``torch.topk``, the dense kernel over every
   candidate, ``QuakeIndex.build(metric="ip")`` with P = 1,000,
   ``search_batch`` probing every partition (both gated equal to the
   GEMM's ids but at near-ties), APS at target 0.9 (the fused planner)
   in f32 and int8 (overlap gated at INT8_OVERLAP; recall printed), the
   ``retrieval_cand`` user through per-query ``search``, and an insert
   of 10,000 new items (each its own top-1).  The four Quake kernels are
   held against their plain versions on this path's operands (the
   insert's assignment and a sample of the build's; the APS centroid
   pass and the brute force; the first 3 f32 APS rounds; every int8
   round, bit-equal) and timed there, at d = 256 under inner product.

8. MoE LM serving (``models/transformer.moe_ffn``): qwen3-moe-235b-a22b
   and then llama4-scout (``MOE_MODELS``), one model on the card at a
   time, at the reference's capacity factor (1.25) and group (512).
   First exact f32 checks at full width and two layers: prefill logits
   with the flash kernel against the plain attention (the share of
   (token, choice) pairs dropped per layer printed), and, at capacity
   factor E / top_k (nothing dropped), decode at 4 positions against a
   re-prefill over t + 1 tokens.  Then the smoke config with the same
   weights on the card and the CPU (prefill and decode, also with a zero
   router: every choice ties, most pairs drop) within 1e-5 * |x| + 1e-5.
   Then the model served in bf16 at full width and ``MOE_LAYERS`` layers
   from seeded random weights: ``prefill`` of 4 prompts of 4,096 tokens,
   32 greedy ``decode_step``s, gates of one flash launch per layer per
   prefill and none per step; prefill tokens/s, ms per step, the drop
   share and ``moe_ffn``'s and the flash kernel's shares of a warm
   prefill's device time.  The flash kernel is held against its plain
   version at layer 0's operands and timed beside
   ``scaled_dot_product_attention`` there (GQA 64/4 and 40/8).
9. The GAT forward (``models/gnn.py``, gat-cora: 2 layers, 8 heads of 8,
   7 classes) at the four ``GNN_SHAPES``, each graph drawn on the host
   by ``data/graphs.py`` from the seed: a 2,708-node community graph
   (1,433 features), one ``GraphMinibatchPipeline`` batch (1,024 seeds,
   fanouts 15/10, 602 features) of a power-law graph of Reddit's 232,965
   nodes, a power-law graph of ogbn-products' 2,449,029 nodes and about
   61.9 M edges (100 features, drawn on the card), and 128 molecules
   pooled by ``graph_pool_logits``.  Gates: shapes, finite values, two
   forwards bit-equal, the card equal to the CPU at ``full_graph_sm``
   and ``molecule`` and at every smoke shape (1e-5 * |x| + 1e-5), and no
   kernel of the port launched.  It prints the warm forward's ms and
   edges/s, the host's drawing seconds and peak device memory.
10. Training (``train/``, ``launch/train.py``, the models' losses), with
   no kernel of the port launched: (a) one ``make_train_step`` step of
   qwen25, granite and qwen3-moe smoke, the four recsys smoke configs
   and the GAT (full and pooled) on the card and on the CPU from the
   same weights, f32 with TF32 off: loss, grad norm and every parameter
   within 1e-5 * |x| + 1e-5 (entries of a rounding-level gradient, which
   Adam's first update moves by lr * sign(g), within 2 * lr); (b)
   qwen2.5-14b at full width and 4 layers, the reference's ``train_4k``
   step (S 4,096, B 4, 2 microbatches, ``lm_loss_chunked`` over 512,
   remat, bf16 cast, OPT_CFG): one warm and 3 timed steps, finite losses
   and grad norms, every parameter changed, then one step under
   torch.profiler; it prints step seconds, tokens/s, peak memory,
   TFLOP/s by ``train_flops``, the idle share and the optimizer's share;
   (c) ``launch.train.main`` on lm-20m for 100 steps (the loss falls),
   then ``train_loop`` with a failure one step after a checkpoint (one
   restart, a replay from it) and without, their losses within 1e-4;
   (d) DIN and DLRM RM-2 at ``train_batch`` (B 65,536), SASRec and
   two-tower at B 16,384, DLRM's and the two-tower's tables cut to 1.25
   M and 2.5 M rows, and the GAT at ``full_graph_sm``, ``minibatch_lg``
   and ``molecule``: finite losses, every parameter changed, step ms and
   peak memory; (e) ``make_compressed_dp_step`` on a one-rank NCCL group
   against the same step in a one-rank gloo group on the CPU.
11. The registry's cells (``configs``): ``launch/dryrun.py --all`` in a
   subprocess (every (arch x shape) cell counted for rank 0 of the 16 x
   16 and 2 x 16 x 16 meshes on ``meta``; gated: all 88 counted; the
   cells that do not fit 80 GB and each cell's dominant roofline term
   printed) while rank 0 of the 16 x 16 mesh runs ``CELL_RUNS`` on the
   card (an abstract mesh: its collectives are copies of the rank's own
   piece): quake-ann's four cells at ``scan_impl="union_cuda"``,
   qwen2.5-14b's four shapes and qwen3-moe's ``train_4k`` at 4 layers,
   the GAT at ``ogb_products``, DLRM's ``train_batch`` and the
   two-tower's ``retrieval_cand``, each at full width from seeded random
   arguments, one warm and one timed call.  It prints the count's bytes a
   device beside the card's memory growth (gated within max(10%, 0.5
   GB)), ms a step and the counted FLOPs' TFLOP/s; gates finite outputs
   and holds each kernel a cell launched against its plain version on
   the rank's own operands.
12. The port's examples (``repro_torch.examples``): (a) quickstart,
   dynamic_workload, retrieval_serving and train_lm at their own
   defaults (the JAX package's sizes), the quickstart's APS recall@10
   gated at 0.85 before and after maintenance, every number finite; (b)
   the quickstart at path 1's SIFT1M shape (1,000,000 x 128, 8192
   clusters): build seconds, us a query, nprobe, maintenance splits and
   merges; (c) on that index 150 per-query searches at tau_rho 0 with
   the table (APS-R) and with ``exact_beta_fn`` (APS-RP, paper Table 2),
   APS-RP's recall gated within 0.02 of APS-R's; (d) the indexed scans
   at text-embedding widths: 200,000 clustered rows of d = 3,072 drawn
   on the card (path 1's mixture in 128 dimensions, projected),
   ``QuakeIndex.build``, ``search_batch`` of 256 queries at
   k = 100 (target 0.9, then ``nprobe=32, rounds=1``) in f32, bf16 and
   int8 storage with recall against the exact top-100, the f32, bf16 and
   q8 kernels held against their plain versions on the first 32 queries'
   operands of the APS plan (q8 bit-equal) and timed on the whole batch
   beside their bounds, then a q8 scan at d = 8,192 (seeded codes)
   held bit-equal and timed; (e) k-means++ seeding on 100,000 x 128 at k
   = 316, its objective after 10 Lloyd steps gated within 1.05x the
   random seeding's.  The four Quake kernels must launch on this path.

It then holds each CUDA kernel against its plain PyTorch version at the
shapes the paths gave it, times both and a one-library-call yardstick,
profiles one warm ``search_batch``, and prints one JSON line of kernels,
the card's name and power limit, and a last JSON line with the device.
The dense scan is held and timed at each of its callers' shapes (the
centroid pass, the latency profile at the serving batch and at one
query, one-query partition probes), beside an empty kernel's launch, the
kernels one one-query call launches (one, and no memset), both of its
designs' times around their crossover and one per-query probe split
into its copy in, scan and pull-back.

It exits non-zero, printing no result, when CUDA is unavailable or the
port is not beside it, and on any failed check.  Detailed records go to
``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

# kernel vs plain: |diff| <= TOL_REL * |d| + TOL_ABS per entry, the f32
# rounding of the same dot products summed in another order.  The kernels'
# distances leave ||q||^2 out, so |d| is about ||x||^2 (~5e3 here) and the
# bound about 0.06, well under the gap between neighbouring entries.
TOL_REL, TOL_ABS = 1e-5, 1e-2
BF16_RECALL = 0.8             # bf16 vs f32 id overlap (the JAX tests' bar)
APS_RECALL_MIN = 0.85         # recall@100 of the APS path at target 0.9
DEFAULT_PLANNER_RECALL = 0.005  # the default (fused) planner's recall@100
                                # against the host planner's on the card
INT8_OVERLAP = 0.85           # int8 vs f32 id overlap (the JAX tests' bar)
# flash kernel vs its plain version, per entry: f32 within
# FLASH_F32_TOL * |o| + FLASH_F32_TOL (tests/test_kernels.py's bound for
# the TPU kernel); bf16 within one bf16 ulp of the output, 2^-7 * |o|, plus
# 1e-3 (a score that differs in its last f32 bit can round p the other way)
FLASH_F32_TOL = 2e-5
FLASH_BF16_REL, FLASH_BF16_ABS = 2.0 ** -7, 1e-3
# f32 LM logits (kernel vs plain attention, decode vs re-prefill): within
# LM_TOL * |x| + LM_TOL (tests/test_kernels.py's prefill bound)
LM_TOL = 1e-4
# the LM path: a config of repro_torch.configs.lm_archs at its full width
# and depth; prompts x tokens, greedy decode steps; the tokens of the one
# request at which the kernel is timed (prefill_32k's request)
LM_CONFIG = "qwen25_14b"
LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE = 4, 4096, 32
LM_TIME_LEN = 32768
# the serving path: k, recall target, the planner (the fused one plans on
# the card: its centroid pass is the dense scan kernel; the vectorized
# one plans in host numpy), and the near-tie allowance of its host/device
# agreement (two f32 scans that sum in another order; a differing id must
# lie within 2 * (REL * |kth| + ABS) of the k-th exact distance)
SERVE_K, SERVE_TARGET, SERVE_PLANNER = 10, 0.9, "fused"
SERVE_TIE_REL, SERVE_TIE_ABS = 1e-5, 1e-5
# the serving rounds held against the plain versions: at most this many
# per scan, each one whose plain version's gather of the union (its rows
# in the storage type and widened to f32) fits in this many bytes
SERVE_CHECK_ROUNDS, SERVE_PLAIN_BYTES = 4, 16e9
# the sharded engine (path 6): EngineConfig(k, nprobe 32, chunk 2, 16
# rounds, target 0.9).  The plain-oracle checks take the first
# ENGINE_CHECK_Q queries (the oracle sorts every (query, union row)
# distance: seconds a call at B = 1,024), the gather scan the first
# ENGINE_GATHER_Q (it gathers (B, n_sel, S_cap, d): 85 GB at B = 1,024);
# adaptive probe counts may differ only where an estimate lies within
# ENGINE_TARGET_TIE of the target.  The indexed scans of the timed legs
# are held against their plain versions on their own operands: the
# search_fixed call, the first ENGINE_HOLD_ROUNDS rounds of
# search_adaptive and of search_batch, ENGINE_HOLD_Q queries a block
ENGINE_NPROBE, ENGINE_CHUNK, ENGINE_ROUNDS, ENGINE_TARGET = 32, 2, 16, 0.9
ENGINE_CHECK_Q, ENGINE_GATHER_Q, ENGINE_TARGET_TIE = 64, 8, 1e-4
ENGINE_HOLD_ROUNDS, ENGINE_HOLD_Q = 3, 8
BRUTE_RECALL_MIN = 0.999      # brute force recall@k against exact
BRUTE_PLAIN_Q = 16            # queries a block of the brute-force plain hold
# the quake-ann capacity leg: configs/quake_arch.py's FULL and its
# serve_*_1k cells; recall@k on the first CAP_GT_Q queries, the q8 kernel
# held on the first CAP_CHECK_Q queries' union
CAP_P, CAP_S, CAP_D, CAP_K = 16384, 12288, 128, 100
CAP_B, CAP_NPROBE, CAP_GT_Q, CAP_CHECK_Q = 1024, 64, 64, 8
# the recsys path (path 7): the models of repro_torch.configs.recsys_archs
# in this order, one model's tables on the card at a time, at their
# published configs (RECSYS_SIZE 0; 1 takes the smoke configs) and the
# family's serving shapes (RECSYS_SHAPES None: recsys_archs.RECSYS_SHAPES);
# rows a chunk of every serve and retrieval call; the Quake leg's users,
# k, partitions, new items of its catalogue update, the sample of the
# build's points its assignment is held on, and the APS rounds held.
# Card against CPU, and every top-k of unit-norm 256-d inner products,
# within RECSYS_TOL * |x| + RECSYS_TOL: one f32 dot product of 256 terms
# summed in another order moves by about 1e-6 (the L2 bound TOL_ABS,
# 1e-2, would call every entry of a top-100 a near-tie)
RECSYS_ARCHS = ("two-tower-retrieval", "dlrm-rm2", "din", "sasrec")
RECSYS_SIZE, RECSYS_SHAPES, RECSYS_CHUNK = 0, None, 65_536
RECSYS_USERS, RECSYS_K, RECSYS_P = 512, 100, 1000
RECSYS_NEW_ITEMS, RECSYS_ASSIGN_SAMPLE, RECSYS_HOLD_ROUNDS = 10_000, 65_536, 3
RECSYS_TOL = 1e-5
# the MoE path (path 8): (published config, smoke config) of
# repro_torch.configs.lm_archs, one model on the card at a time, served in
# bf16 at full width and MOE_LAYERS layers (the depth cut: 94 and 48
# layers would need 470 and 215 GB of weights), its exact f32 checks at
# MOE_CHECK_LAYERS; the same prompts and decode steps as the LM path.
# Card against CPU at the smoke configs within MOE_TOL * |x| + MOE_TOL
MOE_MODELS = (("qwen3_moe_235b", "qwen3_moe_smoke"),
              ("llama4_scout", "llama4_scout_smoke"))
MOE_LAYERS, MOE_CHECK_LAYERS = 10, 2
MOE_TOL = 1e-5
# the GNN path (path 9): gat_cora at the four GNN_SHAPES; minibatch_lg
# samples GNN_BATCH_NODES seeds at GNN_FANOUTS from a power-law graph of
# Reddit's node count at a mean degree cut from Reddit's ~492 (symmetrised
# to about twice GNN_REDDIT_DEGREE); card against CPU at full width for
# GNN_CPU_SHAPES and at every smoke shape, within GNN_TOL * |x| + GNN_TOL
GNN_REDDIT_NODES, GNN_REDDIT_DEGREE = 232_965, 25
GNN_BATCH_NODES, GNN_FANOUTS = 1024, (15, 10)
GNN_CPU_SHAPES = ("full_graph_sm", "molecule")
GNN_TOL = 1e-5
# the training path (path 10).  (a) card against CPU: one step of each smoke
# config (TRAIN_SMOKE_LMS, the recsys smoke configs, the GAT's full_graph_sm
# and molecule) under TRAIN_SMOKE_OPT, a step that moves every parameter by
# about its lr; loss, grad norm and parameters within TRAIN_TOL * |x| +
# TRAIN_TOL, but entries whose gradient is under TRAIN_SMALL of its leaf's
# largest (Adam's first update is lr * sign(g) there), held to 2 * lr; so are
# entries under TRAIN_NOISE of the largest gradient of all, at its f32 rounding
# level.  (b) qwen2.5-14b at full width and TRAIN_LAYERS layers, B TRAIN_B, one
# warm and TRAIN_TIMED timed steps.  (c) the entry point on TRAIN_PRESET for
# TRAIN_STEPS steps, then two loops of TRAIN_LOOP_STEPS with a checkpoint every
# TRAIN_CKPT steps, their losses within TRAIN_LOOP_REL (the card's embedding
# backward adds with atomics).  (d) the recsys models at train_batch, the
# in-batch models at TRAIN_INBATCH_B, two tables cut to TRAIN_RECSYS_ROWS, and
# the GAT at TRAIN_GNN_SHAPES.  (e) the compressed step's code ties: (g + r) /
# scale within TRAIN_CODE_TIE of a half
TRAIN_SMOKE_LMS = ("qwen25_smoke", "granite_smoke", "qwen3_moe_smoke")
TRAIN_SMOKE_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
TRAIN_TOL, TRAIN_SMALL, TRAIN_NOISE = 1e-5, 1e-3, 1e-6
TRAIN_LM, TRAIN_LAYERS, TRAIN_B, TRAIN_TIMED = "qwen25_14b", 4, 4, 3
TRAIN_PRESET, TRAIN_STEPS = "lm-20m", 100
TRAIN_LOOP_STEPS, TRAIN_CKPT, TRAIN_LOOP_REL = 30, 10, 1e-4
TRAIN_INBATCH_B = 16_384
TRAIN_RECSYS_ROWS = {"two-tower-retrieval": 2_500_000, "dlrm-rm2": 1_250_000}
TRAIN_GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
TRAIN_CODE_TIE = 1e-3
# the registry's cells (path 11): the dry-run of every (arch x shape) cell
# on both production meshes in a subprocess (DRYRUN_JOBS processes, within
# DRYRUN_TIMEOUT s), then rank 0 of the 16 x 16 mesh on the card for
# CELL_RUNS, LM cells cut to CELL_LAYERS layers (the count made at the same
# depth), the engine at CELL_ENGINE; the card's memory growth within
# max(CELL_MEM_REL of the count, CELL_MEM_ABS bytes) of the count; the
# brute-force scan held on the first CELL_PLAIN_Q queries' operands
CELL_RUNS = (("quake-ann", "serve_fixed_1k"),
             ("quake-ann", "serve_adaptive_1k"),
             ("quake-ann", "bulk_brute_8k"), ("quake-ann", "maint_assign_1m"),
             ("qwen2.5-14b", "train_4k"), ("qwen2.5-14b", "prefill_32k"),
             ("qwen2.5-14b", "decode_32k"), ("qwen2.5-14b", "long_500k"),
             ("qwen3-moe-235b-a22b", "train_4k"), ("gat-cora", "ogb_products"),
             ("dlrm-rm2", "train_batch"),
             ("two-tower-retrieval", "retrieval_cand"))
CELL_LAYERS = 4
CELL_ENGINE = {"scan_impl": "union_cuda"}
CELL_MEM_REL, CELL_MEM_ABS = 0.10, 0.5e9
CELL_PLAIN_Q = 16
DRYRUN_JOBS, DRYRUN_TIMEOUT = 4, 600
# the port's examples (path 12): (a) the four at their own defaults, the
# quickstart's APS recall at least APS_RECALL_MIN before and after
# maintenance; (b) the quickstart at path 1's SIFT1M shape (EX_SIFT);
# (c) on (b)'s index EX_APS_QUERIES per-query searches at tau_rho 0 with
# the table (APS-R) and with the exact beta function (APS-RP), APS-RP's
# recall within EX_APS_RP_GAP of APS-R's; (d) the indexed scans past the
# widths that held the tile's queries whole: WIDE_N clustered rows (the
# mixture of path 1 with WIDE_CLUSTERS clusters, drawn in WIDE_LATENT
# dimensions and projected) of width WIDE_D through
# QuakeIndex.build and search_batch of WIDE_B queries at WIDE_K, the
# kernels held against their plain versions on the first WIDE_HOLD_Q
# queries' plan, and a q8 scan of WIDE_Q8 (P, S, d, B, U) codes; (e)
# k-means++ on KPP (n, d, k), its objective after 10 Lloyd steps within
# KPP_SLACK of the random seeding's.  The f32 and bf16 kernels sum each
# product as two sequential chains of d / 2 terms, whose f32 rounding grows
# like sqrt(d): TOL_REL (set at d = 128) is scaled by sqrt(d / 128) there
# (4.9e-5 at d = 3,072)
EX_SIFT = dict(n=1_000_000, dim=128, n_clusters=8192)
EX_APS_QUERIES, EX_APS_RP_GAP = 150, 0.02
WIDE_N, WIDE_D, WIDE_CLUSTERS, WIDE_LATENT = 200_000, 3072, 1638, 128
WIDE_B, WIDE_K, WIDE_HOLD_Q = 256, 100, 32
WIDE_Q8 = (64, 256, 8192, 256, 32)
KPP, KPP_SLACK = (100_000, 128, 316), 1.05
# kernel groups of the (b) step's profile: f32 GEMMs (the attention's
# scores and PV products of f32 copies: CUDA-core sgemm), the other GEMMs
# (bf16 on the tensor cores), elementwise and copy kernels, reductions
TRAIN_GROUPS = {"gemm_f32": ("sgemm", "f32f32_f32f32", "ffma"),
                "gemm_other": ("gemm", "nvjet", "cutlass"),
                "elementwise": ("elementwise", "copy"),
                "reduce": ("reduce",)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--insert", type=int, default=10_000)
    ap.add_argument("--delete", type=int, default=5_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=8192)
    ap.add_argument("--power", type=float, default=0.5)
    ap.add_argument("--wiki-n", type=int, default=1_000_000)
    ap.add_argument("--months", type=int, default=12)
    ap.add_argument("--month-queries", type=int, default=512,
                    help="per-query searches per month (access statistics)")
    # 6 of the generator's 12 months keep the whole run, path 12
    # included, well inside its time limit on a slow host
    ap.add_argument("--serve-months", type=int, default=6,
                    help="months of the workload the serving path replays")
    return ap.parse_args()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn):
    """(fn(), its device time in ms) for one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
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


def median_ms(*fns, rounds: int = 5):
    """``cuda_ms`` of each of ``fns``, the median over ``rounds`` rounds
    that take the functions in turn: in a long process a collection or a
    page fault on the host lands in one window of 10 calls, not in the
    median, and the functions compared share the host's state."""
    import statistics
    gc.collect()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(cuda_ms(fn))
    return [statistics.median(t) for t in times]


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls enqueued while a
    spin kernel holds the card (the port's ``cost_model._device_ms``), so
    the CUDA events bracket the card's work and not the wrapper's host
    dispatch, which ``cuda_ms`` also pays once a kernel is shorter."""
    import torch
    from repro_torch.core.cost_model import _device_ms
    fn()
    return _device_ms(fn, reps, torch.device("cuda")) / reps


def recall_at(ids, gt) -> float:
    import numpy as np
    k = gt.shape[1]
    hits = [len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
            for a, b in zip(ids, gt)]
    return float(np.mean(hits))


def compare_topk(name, d_k, i_k, d_p, i_p, tol=(TOL_REL, TOL_ABS)):
    """Kernel vs plain top-k lists (B, K): every distance within its
    tolerance ``tol[0] * |d| + tol[1]``; away from the k-th distance
    (whose neighbours outside the list are unseen), ids equal position by
    position wherever the plain list has no near-tie, and equal as sets.
    Returns (largest |distance diff|, largest tolerance)."""
    import torch
    d_k, d_p = d_k.double(), d_p.double()
    real = d_p < 1e37
    if not torch.equal(real, d_k < 1e37):
        fail(f"{name}: kernel and plain disagree on which entries miss")
    tol = torch.where(real, tol[0] * d_p.abs() + tol[1], 0.0)
    diff = torch.where(real, (d_k - d_p).abs(), 0.0)
    err = float(diff.max()) if diff.numel() else 0.0
    if bool((diff > tol).any()):
        fail(f"{name}: {int((diff > tol).sum())} distances beyond their "
             f"tolerance, max |diff| {err:.3g}")
    kth = torch.where(real, d_p, float("-inf")).max(dim=1,
                                                   keepdim=True).values
    firm = real & (d_p < kth - 2 * tol)
    step = (d_p[:, 1:] - d_p[:, :-1]).abs()
    gap = torch.full_like(d_p, float("inf"))
    gap[:, 1:] = step
    gap[:, :-1] = torch.minimum(gap[:, :-1], step)
    bad = (i_k != i_p) & firm & (gap > 2 * tol)
    if bool(bad.any()):
        b, j = (int(v) for v in torch.nonzero(bad)[0])
        fail(f"{name}: {int(bad.sum())} ids differ away from ties; first at "
             f"query {b}, position {j}: kernel id {int(i_k[b, j])} at "
             f"{float(d_k[b, j])!r}, plain id {int(i_p[b, j])} at "
             f"{float(d_p[b, j])!r}, k-th {float(kth[b, 0])!r}")
    same = i_p[:, :, None] == i_k[:, None, :]
    lost = firm & ~same.any(dim=2)
    extra = real & (d_k < kth - 2 * tol) & ~same.any(dim=1)
    if bool(lost.any()) or bool(extra.any()):
        fail(f"{name}: id sets differ: {int(lost.sum())} ids missing and "
             f"{int(extra.sum())} extra, away from the k-th distance")
    print(f"{name}: ids differ at {int(((i_k != i_p) & real).sum())} of "
          f"{int(real.sum())} positions, all at near-ties")
    return err, float(tol.max()) if tol.numel() else 0.0


def warm_then_time(fn, counters=None, during=contextlib.nullcontext):
    """Call ``fn`` once to warm it, then once timed (host clock to a
    synchronize), inside the context ``during()``.  Returns (the timed
    call's result, its wall ms, the launches it made of each of
    ``counters``' kernels that it launched)."""
    import torch
    fn()
    counters = counters or {}
    before = {n: c.count for n, c in counters.items()}
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t = time.perf_counter()
    with during():
        res = fn()
    sync()
    wall = (time.perf_counter() - t) * 1e3
    return res, wall, {n: c.count - before[n] for n, c in counters.items()
                       if c.count > before[n]}


def profile_call(fn, what: str = "search_batch", match: str = "",
                 out_dir=OUT_DIR, ranges=(), groups=None) -> dict:
    """Device busy time of one warm call of ``fn`` under torch.profiler,
    beside its wall time, the kernels that took the most device time, the
    device time of the kernels whose name holds ``match``, the device
    span of each ``record_function`` range named in ``ranges`` (summed
    over its calls; the kernels inside take all but the launch gaps),
    and with ``groups`` (name -> substrings) the device time of the
    kernels of each group, a kernel in the first group one of whose
    substrings its name holds ("other": none).  The trace goes to
    ``out_dir`` (none when it is None)."""
    import torch
    prof, wall_ms = traced(fn)
    rows, spans = [], {r: 0.0 for r in ranges}
    for e in prof.key_averages():
        # kernels only: the ops that launch them repeat their time, and a
        # range's device-side span covers its kernels again
        dev_us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type != torch.autograd.DeviceType.CUDA or dev_us <= 0:
            continue
        if e.key in spans:
            spans[e.key] += dev_us / 1e3
        else:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if out_dir is not None:
        prof.export_chrome_trace(str(Path(out_dir) / f"{what}_trace.json"))
    out = {"wall_ms_profiled": wall_ms,
           "device_busy_ms": busy_ms if rows else None,
           "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
           "top": [{"name": k[:80], "calls": c, "device_ms": ms}
                   for ms, c, k in rows[:12]],
           "port_kernels": [{"name": k[:80], "calls": c, "device_ms": ms}
                            for ms, c, k in rows if "quake::" in k]}
    if match:
        out["match_ms"] = sum(r[0] for r in rows if match in r[2]) \
            if rows else None
    if ranges:
        out["range_ms"] = spans
    if groups:
        out["group_ms"] = {g: 0.0 for g in list(groups) + ["other"]}
        for ms, _, k in rows:
            g = next((g for g, subs in groups.items()
                      if any(x in k for x in subs)), "other")
            out["group_ms"][g] += ms
    print(f"profile of one warm {what}: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms" if rows else
          "profile: the profiler saw no device time (not measured)")
    for r in out["top"]:
        print(f"  {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}")
    for r in out["port_kernels"]:
        if r not in out["top"]:
            print(f"  {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}"
                  f" (the port's)")
    return out


def burst(idx, rng, n_insert, n_delete, first_id, dim):
    """An insert burst near the members of 20 partitions (new content on
    a few topics) and deletes of older vectors there."""
    import numpy as np
    lvl0 = idx.levels[0]
    hot = rng.choice(np.nonzero(lvl0.sizes() >= 64)[0], size=20,
                     replace=False)
    pool = np.concatenate([lvl0.vectors[j] for j in hot])
    new_x = (pool[rng.integers(0, len(pool), n_insert)]
             + rng.normal(size=(n_insert, dim)).astype(np.float32)
             * 0.1).astype(np.float32)
    new_ids = np.arange(first_id, first_id + n_insert, dtype=np.int64)
    old_ids = np.concatenate([lvl0.ids[j] for j in hot])
    del_ids = rng.choice(old_ids, size=min(n_delete, len(old_ids)),
                         replace=False)
    return new_x, new_ids, del_ids


def overlap(a, b) -> float:
    """Mean share of b's ids (per row, -1 left out) that a also has."""
    import numpy as np
    return float(np.mean([len(set(x[x >= 0].tolist())
                              & set(y[y >= 0].tolist()))
                          / max(int((y >= 0).sum()), 1)
                          for x, y in zip(a, b)]))


def worklist(sti, qmask, sel_l, nrows) -> dict:
    """The grouped driver's work list at one plan: the grouping kernel
    held against its plain version (exactly), then the (query, union
    slot) pairs, the tiles of up to QT queries, the mean queries a tile,
    the rows the kernel reads (each tile reads its partition's live rows)
    against ``rows_read`` (each selected partition's live rows once), and
    their ratio, the times a partition is read on average."""
    import torch
    order = sti.slot_order(sel_l.to(torch.int32), nrows, len(sel_l))
    want = sti.group_queries_plain(qmask, order)
    got = sti.group_queries_cuda(qmask, order)
    for name, t in want.items():
        if not torch.equal(got[name], t):
            fail(f"group_queries: the kernel's {name} differs from the "
                 f"plain version's")
    ntiles = want["ntiles"].long()
    pairs = int(want["qcount"].sum())
    tiles = int(ntiles.sum())
    kernel_rows = int((ntiles * nrows[sel_l].long()).sum())
    rows_read = int(nrows[torch.unique(sel_l)].sum())
    return {"pairs": pairs, "tiles": tiles,
            "queries_per_tile": pairs / max(tiles, 1),
            "kernel_rows": kernel_rows, "rows_read": rows_read,
            "reads_per_partition": kernel_rows / max(rows_read, 1)}


def traced(fn, calls: int = 1, tries: int = 3):
    """(torch.profiler trace of ``calls`` warm calls of ``fn``, the wall
    ms they took).  A trace that holds no device event at all was lost
    by the profiler, not run without the card (every ``fn`` here launches
    work on it): CUPTI once delivered none for one short call late in a
    long run on the H100.  Such a trace is taken again, up to ``tries``
    times in all; the last one is returned whatever it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events()):
            break
    return prof, wall_ms


def count_kernels(fn, calls: int = 4) -> dict:
    """Device kernels and memsets that one warm call of ``fn`` launches,
    from torch.profiler's device events over ``calls`` calls (each count
    is the total over the calls divided by their number)."""
    import torch
    prof, _ = traced(fn, calls)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    memsets = [n for n in names if "memset" in n.lower()]
    kernels = [n for n in names if n not in memsets
               and "memcpy" not in n.lower()]
    return {"kernels": len(kernels) / calls, "memsets": len(memsets) / calls,
            "names": sorted(set(k[:60] for k in kernels))}


def scan_topk_phase(st, ops, idx, q, dev, launches, seed) -> dict:
    """The dense scan at the shapes of its four callers: the centroid
    pass (Q = B queries against the P centroids, k_pad of m = max(ceil(
    f_m P), min_candidates)), the lambda profile at the serving batch and
    at one query (N = 16,384, k_pad 128), and one-query probes of a
    partition (N ~ 1,000 from the index, and 16,384; k_pad 16 and 128).
    Each is held against the plain version and timed by events and by
    device time beside the library call (``torch.matmul`` + ``torch.
    topk``, ||x||^2 outside the timing).  Also: the launch time of an
    empty kernel (the floor of the one-query rows), the device kernels
    one Q = 1 call launches (gated: one, and no memset), both designs'
    device times around the crossover, and one ``QuakeIndex.
    _scan_vectors`` call split into its host-to-card copy, the kernel
    and the pull-back.  Returns the ``kernels`` row (the centroid pass's
    numbers, the others under ``shapes``)."""
    from repro_torch.kernels import build
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 17)
    cents = torch.as_tensor(idx.levels[0].centroids, device=dev)
    q_dev = torch.as_tensor(q, device=dev)
    b, d = q.shape
    nc = cents.shape[0]
    m = min(max(int(np.ceil(idx.config.f_m * nc)),
                idx.config.min_candidates), nc)
    sizes = idx.levels[0].sizes()
    part = int(np.argmin(np.abs(sizes - 1000)))       # a ~1,000-row probe
    x_part = torch.as_tensor(idx.levels[0].vectors[part], device=dev)

    def rand(rows):
        return torch.as_tensor(rng.normal(size=(rows, d)).astype(
            np.float32), device=dev)
    x16k = rand(16384)
    q_prof = rand(b)
    cases = [("centroid_pass", q_dev, cents, ops._next_pow2(m)),
             ("profile_batch", q_prof, x16k, 128),
             ("profile_one", q_prof[:1], x16k, 128),
             ("probe_k16", q_dev[:1], x_part, 16),
             ("probe_k128", q_dev[:1], x_part, 128),
             ("probe16k_k16", q_dev[:1], x16k, 16),
             ("probe16k_k128", q_dev[:1], x16k, 128)]
    lib = st.build.lib("scan_topk")
    stream = torch.cuda.current_stream().cuda_stream
    empty = {"ms": cuda_ms(lambda: lib.launch_empty(stream)),
             "device_ms": device_ms(lambda: lib.launch_empty(stream))}
    print(f"scan_topk: an empty kernel's launch takes {empty['ms']:.4f} ms "
          f"by events ({empty['device_ms']:.4f} device time)")
    shapes = {}
    for name, qq, xx, kp in cases:
        nq, nx = qq.shape[0], xx.shape[0]
        before = st.LAUNCHES.count
        dk, ik = st.scan_topk_cuda(qq, xx, k_pad=kp)
        per_call = st.LAUNCHES.count - before
        dp, ip_ = st.scan_topk_plain(qq, xx, k_pad=kp)
        err, tol = compare_topk(f"scan_topk {name}", dk, ik, dp, ip_)
        x2 = (xx * xx).sum(1)

        def kern(qq=qq, xx=xx, kp=kp):
            return st.scan_topk_cuda(qq, xx, k_pad=kp)

        def library(qq=qq, xx=xx, x2=x2, kp=min(kp, nx)):
            return torch.topk(x2 - 2.0 * torch.matmul(qq, xx.T), kp, dim=1,
                              largest=False)
        bound_ms, bound_by = build.bound(
            (nq + nx) * d * 4 + 2 * nq * kp * 4, 2.0 * nq * nx * d,
            build.F32_FLOPS_PER_S)
        ms, lib_ms = median_ms(kern, library)
        row = {"Q": nq, "N": nx, "d": d, "k_pad": kp,
               "design": st.design(nq), "launches_per_call": per_call,
               "max_abs_err": err, "tol": tol, "ms": ms,
               "device_ms": device_ms(kern),
               "plain_ms": cuda_ms(lambda: st.scan_topk_plain(
                   qq, xx, k_pad=kp)),
               "library_ms": lib_ms, "library_device_ms": device_ms(library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if nq == 1 and nx == x_part.shape[0]:
            row["profiled"] = count_kernels(kern)
            if row["profiled"]["kernels"] != 1 or \
                    row["profiled"]["memsets"]:
                fail(f"scan_topk {name}: one call launched "
                     f"{row['profiled']}, not one kernel and no memset")
        shapes[name] = row
        row["faster_than_library"] = {
            "events": row["ms"] < row["library_ms"],
            "device": row["device_ms"] < row["library_device_ms"]}
        print(f"scan_topk {name} (Q={nq}, N={nx}, k_pad {kp}, "
              f"{row['design']}): err {err:.3g}, {row['ms']:.4f} ms "
              f"({row['device_ms']:.4f} device), library "
              f"{row['library_ms']:.4f} ({row['library_device_ms']:.4f}), "
              f"bound {bound_ms:.5f} ({bound_by}), plain "
              f"{row['plain_ms']:.4f}; faster than the library "
              f"{row['faster_than_library']}"
              + (f"; kernels a call {row['profiled']}"
                 if "profiled" in row else ""))
    # both designs' device times around the crossover
    crossover = []
    saved = st.CROSSOVER_Q
    try:
        for nq in (1, 2, 3, 4, 6, 8):
            for xx in (x_part, x16k):
                for kp in (16, 128):
                    row = {"Q": nq, "N": xx.shape[0], "k_pad": kp}
                    for design, cut in (("rows", nq + 1), ("tiles", 0)):
                        st.CROSSOVER_Q = cut
                        row[design] = device_ms(
                            lambda: st.scan_topk_cuda(q_prof[:nq], xx,
                                                      k_pad=kp))
                    crossover.append(row)
    finally:
        st.CROSSOVER_Q = saved
    print("scan_topk crossover (device ms; the wrapper takes rows below "
          f"Q = {st.CROSSOVER_Q}):")
    for r in crossover:
        print(f"  Q={r['Q']:2d} N={r['N']:6d} k_pad {r['k_pad']:4d}: rows "
              f"{r['rows']:.4f}, tiles {r['tiles']:.4f}")
    # one per-query probe: host-to-card copy, kernel, pull-back
    xs_np = idx.levels[0].vectors[part]
    x2_np = idx.levels[0].sqnorms[part]
    ids_np = idx.levels[0].ids[part]
    q1 = np.ascontiguousarray(q[0])
    kk = 10

    def wall(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3
    qd = torch.as_tensor(q1[None, :], device=dev)
    xd = torch.as_tensor(xs_np, device=dev)
    dd, ii = ops.scan_topk(qd, xd, kk, metric=idx.config.metric)

    def copy_in():
        torch.as_tensor(q1[None, :], device=dev)
        torch.as_tensor(xs_np, device=dev)
        torch.cuda.synchronize()

    def scan():
        ops.scan_topk(qd, xd, kk, metric=idx.config.metric)
        torch.cuda.synchronize()

    def pull():
        dd[0].cpu().numpy()
        ii[0].cpu().numpy()
    probe = {"rows": int(xs_np.shape[0]), "k": kk,
             "scan_vectors_ms": wall(lambda: idx._scan_vectors(
                 q1, xs_np, x2_np, ids_np, kk)),
             "copy_in_ms": wall(copy_in), "scan_ms": wall(scan),
             "pull_back_ms": wall(pull)}
    print(f"per-query probe of {probe['rows']} rows (host clock): "
          f"_scan_vectors {probe['scan_vectors_ms']:.4f} ms = copy in "
          f"{probe['copy_in_ms']:.4f} + ops.scan_topk "
          f"{probe['scan_ms']:.4f} + pull back {probe['pull_back_ms']:.4f}")
    main = shapes["centroid_pass"]
    return {"name": "scan_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan_topk.cu",
            "replaces": "src/repro/kernels/scan_topk.py:168",
            "launches": launches["scan_topk"],
            **{k: main[k] for k in ("max_abs_err", "tol", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_device_ms")},
            "shape": {k: main[k] for k in ("Q", "N", "d", "k_pad",
                                           "design")},
            "shapes": shapes, "empty_kernel": empty,
            "crossover": crossover, "per_query_probe": probe}


def main() -> int:
    args = parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        import torch.distributed as dist
        from repro_torch.core import (BatchedSearchExecutor, QuakeIndex,
                                      get_executor, plan_batch)
        from repro_torch.data import datasets
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import kmeans_assign as ka
        from repro_torch.kernels import scan_topk as st
        from repro_torch.kernels import scan_topk_indexed as sti
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    record = {"args": vars(args)}
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- build the kernels ------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s ({took})")
    logs = {n: build.build_log(n) for n in build.SIGNATURES}
    (OUT_DIR / "ptxas.log").write_text(
        "\n".join(f"== {n}\n{l}" for n, l in logs.items()))
    for n, l in logs.items():
        for line in (l or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}")
    record["build_s"] = build_s

    steps, step_launches = {}, {}
    counters = {"scan_topk_indexed": sti.LAUNCHES, "scan_topk": st.LAUNCHES,
                "kmeans_assign": ka.LAUNCHES,
                "scan_topk_indexed_q8": sti.LAUNCHES_Q8,
                "flash_attention": fa.LAUNCHES}
    path_launches = {}

    def start_path():
        for c in counters.values():
            c.reset()

    def end_path(name, needs):
        got = {n: c.count for n, c in counters.items()}
        path_launches[name] = got
        print(f"launches on the {name} path: {got}")
        for n in needs:
            if got[n] <= 0:
                fail(f"kernel {n} was not launched on the {name} path")
        return got

    def step(name, fn):
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        step_launches[name] = {n: c.count - before[n]
                               for n, c in counters.items()}
        print(f"step {name}: {steps[name]:.3f} s, launches "
              f"{step_launches[name]}")
        return out

    # ---- path 1: the main path ------------------------------------------
    ds = step("data", lambda: datasets.clustered(
        args.n, args.dim, n_clusters=args.clusters, power=args.power,
        seed=args.seed))
    q = datasets.queries_near(ds, args.batch, seed=args.seed + 1)
    gt = step("ground_truth", lambda: ds.ground_truth(q, args.k,
                                                      device=dev))
    start_path()
    idx = step("build", lambda: QuakeIndex.build(ds.vectors, device=dev))
    runs = {}

    def search(name, fn, min_recall=None):
        r = step(name, fn)
        rec = recall_at(r.ids, gt)
        runs[name] = {"recall@k": rec, "mean_nprobe": float(r.nprobe.mean()),
                      "rounds": int(r.rounds),
                      "vectors_scanned": int(r.vectors_scanned),
                      "partitions_scanned": int(r.partitions_scanned),
                      "wall_s": steps[name]}
        print(f"  {name}: recall@{args.k} {rec:.4f}, mean nprobe "
              f"{r.nprobe.mean():.2f}, rounds {r.rounds}, vectors "
              f"{r.vectors_scanned}")
        if not np.isfinite(r.dists[r.ids >= 0]).all():
            fail(f"{name}: non-finite distances")
        if r.ids.shape != (args.batch, args.k):
            fail(f"{name}: result shape {r.ids.shape}")
        if min_recall is not None and rec < min_recall:
            fail(f"{name}: recall {rec:.4f} < {min_recall}")
        return r

    # the host planner, named: an executor that names none plans on the
    # card here
    host = BatchedSearchExecutor(idx, planner="vectorized")
    search("search_vectorized",
           lambda: host.search(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    search("search_vectorized_warm",
           lambda: host.search(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    del host             # its snapshot copy is not needed again
    torch.cuda.empty_cache()
    # the default: search_batch's executor plans with the fused planner
    search("search_default",
           lambda: idx.search_batch(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    search("search_default_warm",
           lambda: idx.search_batch(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    planner = get_executor(idx).planner
    gap = abs(runs["search_default_warm"]["recall@k"]
              - runs["search_vectorized_warm"]["recall@k"])
    print(f"  default planner {planner!r}: recall within {gap:.4f} of the "
          f"host planner's")
    if planner != "fused":
        fail(f"the default planner on the card is {planner!r}, not 'fused'")
    if gap > DEFAULT_PLANNER_RECALL:
        fail(f"the default planner's recall is {gap:.4f} from the host "
             f"planner's (> {DEFAULT_PLANNER_RECALL})")
    search("search_nprobe32",
           lambda: idx.search_batch(q, args.k, nprobe=32, rounds=1))
    search("search_bf16",
           lambda: idx.search_batch(q, args.k, recall_target=0.9,
                                    storage_dtype="bf16"), BF16_RECALL)

    # the vectors ever inserted, by id (ids are contiguous), and which live
    all_x = [ds.vectors]
    alive = np.ones(args.n, dtype=bool)

    def update(rng, first_id):
        new_x, new_ids, del_ids = burst(idx, rng, args.insert, args.delete,
                                        first_id, args.dim)
        step(f"insert@{first_id}", lambda: idx.insert(new_x, new_ids))
        removed = step(f"delete@{first_id}", lambda: idx.delete(del_ids))
        if removed != len(del_ids):
            fail(f"deleted {removed} of {len(del_ids)}")
        all_x.append(new_x)
        alive.resize(first_id + len(new_ids), refcheck=False)
        alive[new_ids] = True
        alive[del_ids] = False
        live_ids = np.nonzero(alive)[0]
        x_live = np.concatenate(all_x)[alive]
        q_new = np.concatenate([q[: args.batch // 2],
                                new_x[: args.batch - args.batch // 2]])
        ds_live = datasets.VectorDataset(
            x_live, np.zeros(len(live_ids), dtype=np.int64), ds.centers)
        return q_new, live_ids[ds_live.ground_truth(q_new, args.k,
                                                    device=dev)]

    q2, gt = update(np.random.default_rng(args.seed + 2), args.n)
    ex = get_executor(idx)
    r_after = search("search_after_update",
                     lambda: idx.search_batch(q2, args.k, recall_target=0.9),
                     APS_RECALL_MIN)
    print(f"f32 executor: delta_refreshes {ex.delta_refreshes}, "
          f"full_rebuilds {ex.full_rebuilds}")
    if ex.delta_refreshes != 1 or ex.full_rebuilds != 1:
        fail("the update should refresh the snapshot by one delta")
    idx.check_invariants()
    launches = end_path("main", ("scan_topk_indexed", "scan_topk",
                                 "kmeans_assign"))

    # ---- path 2: int8 serving on the same index -------------------------
    start_path()
    ex8 = get_executor(idx, "int8")
    search("int8_search",
           lambda: idx.search_batch(q2, args.k, recall_target=0.9,
                                    storage_dtype="int8"), APS_RECALL_MIN)
    before = sti.LAUNCHES_Q8.count
    r8 = search("int8_search_warm",
                lambda: idx.search_batch(q2, args.k, recall_target=0.9,
                                         storage_dtype="int8"),
                APS_RECALL_MIN)
    q8_per_search = sti.LAUNCHES_Q8.count - before
    print(f"q8 kernel launches per warm int8 search_batch: {q8_per_search} "
          f"({r8.rounds} rounds)")
    ov = overlap(r8.ids, r_after.ids)
    print(f"  int8 ids overlap the f32 ids: {ov:.4f}")
    if ov < INT8_OVERLAP:
        fail(f"int8 overlap with f32 {ov:.4f} < {INT8_OVERLAP}")
    search("int8_nprobe32",
           lambda: idx.search_batch(q2, args.k, nprobe=32, rounds=1,
                                    storage_dtype="int8"))
    rebuilds = ex8.full_rebuilds
    q3, gt = update(np.random.default_rng(args.seed + 3),
                    args.n + args.insert)
    search("int8_after_update",
           lambda: idx.search_batch(q3, args.k, recall_target=0.9,
                                    storage_dtype="int8"), APS_RECALL_MIN)
    print(f"int8 executor: delta_refreshes {ex8.delta_refreshes}, "
          f"full_rebuilds {rebuilds} -> {ex8.full_rebuilds}")
    if ex8.delta_refreshes != 0 or ex8.full_rebuilds != rebuilds + 1:
        fail("the int8 executor must requantize by one full rebuild")
    idx.check_invariants()
    end_path("int8", ("scan_topk_indexed_q8", "kmeans_assign"))
    record.update(steps=steps, step_launches=step_launches, runs=runs,
                  q8_per_warm_search=q8_per_search,
                  snapshot={"P": int(ex._snap.num_partitions),
                            "S_cap": int(ex._snap.capacity),
                            "S_cap_int8": int(ex8._snap.capacity)})

    # ---- kernels vs their plain versions, at the paths' shapes ----------
    kernels = []
    snap = ex.snapshot()
    valid = ex._valid
    # the scan's operands: the plan's union as the snapshot's pages (the
    # f32, bf16 and int8 snapshots of one index share their page layout)
    plan = plan_batch(idx, q, args.k, recall_target=0.9, pages=ex.pages)
    sel = plan.sel_dev.to(torch.int32).contiguous()
    sel_l = sel.long()
    qmask = plan.qmask_dev.contiguous()
    k_pad = ops._next_pow2(args.k)
    nrows = sti.live_rows(valid)
    pairs = qmask.sum(dim=0).long()
    live = nrows[sel_l].long()
    active_rows = int((pairs * live).sum())
    uniq = torch.unique(sel_l)
    rows_read = int(nrows[uniq].sum())
    bf16_snap = get_executor(idx, "bf16").snapshot().data
    q_dev = torch.as_tensor(q, device=dev)
    b, d = q.shape
    u = int(sel.shape[0])
    # the second timed plan: nprobe=32, rounds=1 (many queries a slot)
    plan32 = plan_batch(idx, q, args.k, nprobe=32, pages=ex.pages)
    sel32 = plan32.sel_dev.to(torch.int32).contiguous()
    qmask32 = plan32.qmask_dev.contiguous()
    work = {"aps": worklist(sti, qmask, sel_l, nrows),
            "nprobe32": worklist(sti, qmask32, sel32.long(), nrows)}
    for name, w in work.items():
        print(f"work list at the {name} plan: {w['pairs']} (query, slot) "
              f"pairs in {w['tiles']} tiles, {w['queries_per_tile']:.2f} "
              f"queries a tile; the kernel reads {w['kernel_rows']} rows "
              f"for rows_read {w['rows_read']} "
              f"({w['reads_per_partition']:.3f} reads a partition)")
    n_chk = 64          # queries of the nprobe=32 plan held against plain

    for dtype_name, data_t in (("f32", snap.data), ("bf16", bf16_snap)):
        qc = q_dev.to(data_t.dtype).contiguous()
        elem = data_t.element_size()
        for metric in ("l2", "ip"):
            def kern():
                return sti.scan_topk_indexed_cuda(
                    qc, data_t, valid, sel, qmask, k_pad=k_pad,
                    metric=metric)

            def plain():
                return sti.scan_topk_indexed_plain(
                    qc, data_t, valid, sel, qmask, k_pad=k_pad,
                    metric=metric)
            dk, ik = kern()
            (dp, ip_), plain_ms = timed(plain)
            err, tol = compare_topk(f"scan_topk_indexed {dtype_name} "
                                    f"{metric}", dk, ik, dp, ip_)
            if dtype_name == "bf16":
                d32, i32 = sti.scan_topk_indexed_plain(
                    q_dev, snap.data, valid, sel, qmask, k_pad=k_pad,
                    metric=metric)
                ov = recall_at(ik.cpu().numpy(),
                               i32.cpu().numpy()[:, :args.k])
                if ov < BF16_RECALL:
                    fail(f"bf16 {metric} overlap with f32 {ov:.3f}")
            ms = cuda_ms(kern)
            dev_ms = device_ms(kern)
            if (dtype_name, metric) == ("f32", "l2"):
                record["profile_scan_topk_indexed"] = profile_call(
                    kern, "scan_topk_indexed")

            def kern32(nq=b):
                return sti.scan_topk_indexed_cuda(
                    qc[:nq], data_t, valid, sel32, qmask32[:nq], k_pad=k_pad,
                    metric=metric)
            dk32, ik32 = kern32(n_chk)
            compare_topk(f"scan_topk_indexed {dtype_name} {metric} at "
                         f"nprobe=32 (first {n_chk} queries)", dk32, ik32,
                         *sti.scan_topk_indexed_plain(
                             qc[:n_chk], data_t, valid, sel32,
                             qmask32[:n_chk], k_pad=k_pad, metric=metric))
            ms32, dev_ms32 = cuda_ms(kern32), device_ms(kern32)
            lib_ms = timed(lambda: library_indexed(
                q_dev, data_t.index_select(0, sel_l).float(), valid, sel_l,
                qmask, metric, k_pad))[1]
            bound_ms, bound_by = build.bound(
                rows_read * d * elem + b * d * elem + 2 * b * k_pad * 4
                + b * u + rows_read, 2.0 * active_rows * d,
                build.F32_FLOPS_PER_S)
            kernels.append({
                "name": ("scan_topk_indexed" if (dtype_name, metric)
                         == ("f32", "l2") else
                         f"scan_topk_indexed[{dtype_name},{metric}]"),
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/scan_topk_indexed.cu",
                "replaces": "src/repro/kernels/scan_topk_indexed.py:85",
                "launches": launches["scan_topk_indexed"],
                "max_abs_err": err, "tol": tol, "ms": ms,
                "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "shape": {"B": b, "U": u, "S": int(data_t.shape[1]),
                          "d": d, "k_pad": k_pad,
                          "active_pair_rows": active_rows},
                "work_list": work["aps"],
                "nprobe32": {"ms": ms32, "device_ms": dev_ms32,
                             "U": int(sel32.shape[0]),
                             "work_list": work["nprobe32"]}})
            print(f"scan_topk_indexed {dtype_name} {metric}: err {err:.3g}"
                  f" (tol {tol:.3g}), {ms:.4f} ms ({dev_ms:.4f} device "
                  f"time) vs plain {plain_ms:.1f} ms, bound "
                  f"{bound_ms:.4f} ms; {ms32:.4f} ms ({dev_ms32:.4f}) at "
                  f"nprobe=32")
    del bf16_snap

    # the int8 scan at the same plan, k_scan = 2k (the re-rank's list)
    snap8 = ex8.snapshot()
    kp8 = ops._next_pow2(2 * args.k)
    nrows8 = sti.live_rows(ex8._valid)
    live8 = nrows8[sel_l].long()
    active8 = int((pairs * live8).sum())
    rows8 = int(nrows8[uniq].sum())

    def dequantized():
        return (ex8._page_cents.index_select(0, sel_l)[:, None, :]
                + snap8.data.index_select(0, sel_l).float()
                * snap8.scales.index_select(0, sel_l)[..., None])

    for metric in ("l2", "ip"):
        operands = ref.q8_scan_operands(q_dev, snap8.data, snap8.scales,
                                        ex8._valid, sel, metric,
                                        ex8._page_cents)
        args8 = (*operands[:2], snap8.data, snap8.scales, *operands[2:],
                 ex8._valid, sel, qmask)

        def kern():
            return sti.scan_topk_indexed_q8_cuda(*args8, k_pad=kp8,
                                                 metric=metric)

        def plain():
            return sti.scan_topk_indexed_q8_plain(*args8, k_pad=kp8,
                                                  metric=metric)
        dk, ik = kern()
        (dp, ip_), plain_ms = timed(plain)
        err, tol = compare_topk(f"scan_topk_indexed_q8 {metric}", dk, ik,
                                dp, ip_)
        ms = cuda_ms(kern)
        dev_ms = device_ms(kern)
        if metric == "l2":
            record["profile_scan_topk_indexed_q8"] = profile_call(
                kern, "scan_topk_indexed_q8")
        ops32 = ref.q8_scan_operands(q_dev, snap8.data, snap8.scales,
                                     ex8._valid, sel32, metric,
                                     ex8._page_cents)
        args32 = (*ops32[:2], snap8.data, snap8.scales, *ops32[2:],
                  ex8._valid, sel32, qmask32)

        def kern32(nq=b):
            a = args32
            return sti.scan_topk_indexed_q8_cuda(
                a[0][:nq], a[1][:nq], *a[2:5], a[5][:nq], a[6], a[7],
                a[8][:nq], k_pad=kp8, metric=metric)
        dk32, ik32 = kern32(n_chk)
        a = args32
        dp32, ip32 = sti.scan_topk_indexed_q8_plain(
            a[0][:n_chk], a[1][:n_chk], *a[2:5], a[5][:n_chk], a[6], a[7],
            a[8][:n_chk], k_pad=kp8, metric=metric)
        compare_topk(f"scan_topk_indexed_q8 {metric} at nprobe=32 (first "
                     f"{n_chk} queries)", dk32, ik32, dp32, ip32)
        if not torch.equal(dk32, dp32):
            fail(f"scan_topk_indexed_q8 {metric} at nprobe=32: distances "
                 f"not bit-equal to the plain version's")
        ms32, dev_ms32 = cuda_ms(kern32), device_ms(kern32)
        lib_ms = timed(lambda: library_indexed(
            q_dev, dequantized(), ex8._valid, sel_l, qmask, metric, kp8))[1]
        bound_ms, bound_by = build.bound(
            rows8 * (d + 4 + 4 + 1) + b * (d + 4) + b * u * (4 + 1)
            + 2 * b * kp8 * 4, 2.0 * active8 * d, build.INT8_OPS_PER_S)
        kernels.append({
            "name": ("scan_topk_indexed_q8" if metric == "l2"
                     else "scan_topk_indexed_q8[ip]"),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan_topk_indexed_q8.cu",
            "replaces": "src/repro/kernels/scan_topk_indexed.py:210",
            "launches": path_launches["int8"]["scan_topk_indexed_q8"],
            "max_abs_err": err, "tol": tol, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
            "library": "gather + dequantize, torch.matmul, torch.topk",
            "shape": {"B": b, "U": u, "S": int(snap8.capacity), "d": d,
                      "k_pad": kp8, "active_pair_rows": active8,
                      "rows_read": rows8},
            "work_list": worklist(sti, qmask, sel_l, nrows8),
            "nprobe32": {"ms": ms32, "device_ms": dev_ms32,
                         "U": int(sel32.shape[0]),
                         "work_list": worklist(sti, qmask32, sel32.long(),
                                               nrows8)}})
        print(f"scan_topk_indexed_q8 {metric}: err {err:.3g} (tol "
              f"{tol:.3g}), {ms:.4f} ms ({dev_ms:.4f} device time) vs "
              f"plain {plain_ms:.1f} ms, library {lib_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms; {ms32:.4f} ms ({dev_ms32:.4f}) at "
              f"nprobe=32")
        if err != 0.0:
            fail(f"scan_topk_indexed_q8 {metric}: distances differ from "
                 f"the plain version's by {err!r}, not 0")
        if metric == "l2":
            flat = ik[:, :2 * args.k].cpu().numpy()
            t = time.perf_counter()
            ex8._rerank_exact(q, flat, args.k)
            record["rerank_gather_ms"] = (time.perf_counter() - t) * 1e3
            print(f"exact re-rank of the B x 2k candidates: "
                  f"{record['rerank_gather_ms']:.1f} ms (host)")

    # the dense scan at its callers' shapes (the centroid pass first)
    kernels.append(scan_topk_phase(st, ops, idx, q, dev, launches,
                                   args.seed))
    cents = torch.as_tensor(idx.levels[0].centroids, device=dev)
    nc = cents.shape[0]

    # assignment: an insert burst against the base centroids, and an
    # exact-tie case (a centroid duplicated at a smaller index)
    xs = torch.as_tensor(all_x[1], device=dev)
    aux = (cents * cents).sum(1)
    err, tol, ap = hold_assign(ka, "kmeans_assign", xs, cents, aux)
    tied = cents.clone()
    top = int(torch.mode(ap.long()).values)
    lo_idx = 0 if top != 0 else 1
    tied[lo_idx] = tied[top]
    aux_t = (tied * tied).sum(1)
    at, _ = ka.kmeans_assign_cuda(xs, tied, aux_t)
    at_p, _ = ka.kmeans_assign_plain(xs, tied, aux_t)
    hit = ap == top
    if not bool((at[hit] == lo_idx).all()) or not torch.equal(
            at[hit], at_p[hit]):
        fail("kmeans_assign: exact ties must go to the smallest index")
    ms = cuda_ms(lambda: ka.kmeans_assign_cuda(xs, cents, aux))
    dev_ms = device_ms(lambda: ka.kmeans_assign_cuda(xs, cents, aux))
    plain_ms = cuda_ms(lambda: ka.kmeans_assign_plain(xs, cents, aux))

    def library():
        return torch.argmin(torch.cdist(xs, cents), dim=1)
    lib_ms, lib_dev_ms = cuda_ms(library), device_ms(library)
    n_x = xs.shape[0]
    bound_ms, bound_by = build.bound((n_x + nc) * d * 4 + n_x * 8,
                                     2.0 * n_x * nc * d,
                                     build.F32_FLOPS_PER_S)
    kernels.append({
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:67",
        "launches": launches["kmeans_assign"], "max_abs_err": err,
        "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "library_device_ms": lib_dev_ms,
        "shape": {"N": n_x, "C": nc, "d": d, "tied_points": int(hit.sum())}})
    print(f"kmeans_assign: err {err:.3g} (tol {tol:.3g}), {ms:.4f} ms "
          f"({dev_ms:.4f} device time), library {lib_ms:.4f} ms "
          f"({lib_dev_ms:.4f})")
    torch.cuda.synchronize()

    # ---- where the time of one warm search_batch goes ------------------
    record["profile"] = profile_call(
        lambda: idx.search_batch(q, args.k, recall_target=0.9))

    # ---- path 6: the sharded engine over a one-rank NCCL mesh -----------
    # the executor's result the engine's search_batch is held against (its
    # launches are not the engine path's); a fresh executor, so that its
    # planner calibrates the APS radius on these queries, as the engine's,
    # on the engine's own (host) planner
    ex_fresh = BatchedSearchExecutor(idx, planner="vectorized")
    r_ex = ex_fresh.search(q3, args.k, recall_target=0.9)
    del ex_fresh
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{pg_dir}/init",
                            world_size=1, rank=0)
    try:
        t = time.perf_counter()
        start_path()
        record["engine"], brute_row = run_engine(
            args, idx, q3, gt, r_ex, args.n + 2 * args.insert, dev, counters)
        del idx, ex, ex8, snap, snap8, valid, plan, sel, qmask, ds, all_x
        gc.collect()
        torch.cuda.empty_cache()
        record["engine"]["capacity"] = run_capacity(args, dev, counters)
        end_path("engine", ("scan_topk_indexed", "scan_topk_indexed_q8",
                            "scan_topk", "kmeans_assign"))
        record["engine"]["path_s"] = time.perf_counter() - t
        print(f"engine path took {record['engine']['path_s']:.1f} s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    for row in kernels:
        if row["name"] == "scan_topk":
            row["shapes"]["brute_force"] = brute_row
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 3: the dynamic loop (paper Fig. 4) ------------------------
    t = time.perf_counter()
    wl = wiki_workload(args)
    workload_s = time.perf_counter() - t
    record["dynamic"] = run_dynamic(args, wl, dev, start_path, end_path)
    record["dynamic"]["workload_s"] = workload_s
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 5: online serving (launch/serve.replay_runtime) -----------
    t = time.perf_counter()
    record["serving"] = run_serving(args, wl, dev, start_path, end_path)
    record["serving"]["path_s"] = time.perf_counter() - t
    print(f"serving path took {record['serving']['path_s']:.1f} s")
    for row in kernels:      # each kernel's launches on the serving path
        base = row["name"].split("[")[0]
        if base == "scan_topk_indexed_q8":
            row["serving_launches"] = \
                record["serving"]["int8_launches"][base]
        elif base in record["serving"]["launches"]:
            row["serving_launches"] = record["serving"]["launches"][base]
        if row["name"] in record["serving"]["kernel_checks"]:
            # held against the plain version on the serving path's own
            # operands
            row["serving_check"] = \
                record["serving"]["kernel_checks"][row["name"]]
    del wl
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 4: LM serving (prefill -> decode) ---------------------------
    t = time.perf_counter()
    record["lm"], row = run_lm(args, dev, start_path, end_path)
    record["lm"]["path_s"] = time.perf_counter() - t
    print(f"lm path took {record['lm']['path_s']:.1f} s")
    kernels.append(row)
    del row
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 7: recsys serving, two-tower retrieval through Quake -------
    record["recsys"] = run_recsys(args, dev, start_path, end_path)
    print(f"recsys path took {record['recsys']['path_s']:.1f} s")
    for row in kernels:      # each kernel's launches on the recsys path
        base = row["name"].split("[")[0]
        row["recsys_launches"] = record["recsys"]["launches"][base]
        # held against the plain version on the recsys path's own operands
        row["recsys_check"] = record["recsys"]["kernel_checks"].get(base)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 8: MoE LM serving (qwen3-moe-235b-a22b, llama4-scout) ------
    record["moe"] = run_moe(args, dev, start_path, end_path)
    print(f"moe path took {record['moe']['path_s']:.1f} s")
    for row in kernels:
        if row["name"] == "flash_attention":
            row["moe"] = {n_: m_["flash"]
                          for n_, m_ in record["moe"]["models"].items()}
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 9: the GAT forward at its four graph shapes -----------------
    record["gnn"] = run_gnn(args, dev, start_path, end_path)
    print(f"gnn path took {record['gnn']['path_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 10: training (the LM at full width, recsys, GAT) ------------
    record["train"] = run_train(args, dev, start_path, end_path, counters)
    print(f"train path took {record['train']['path_s']:.1f} s")
    for row in kernels:      # each kernel's launches on the training path
        row["train_launches"] = record["train"]["launches"][
            row["name"].split("[")[0]]

    # ---- path 11: the registry's cells (dry-run; rank 0 on the card) -------
    record["cells"] = run_cells(args, dev, start_path, end_path, counters)
    print(f"cells path took {record['cells']['path_s']:.1f} s")
    for row in kernels:      # each kernel's launches on the cells path
        row["cells_launches"] = record["cells"]["launches"][
            row["name"].split("[")[0]]
    # ---- path 12: the examples, the scans at embedding widths, k-means++ --
    record["examples"] = run_examples(args, dev, start_path, end_path)
    print(f"examples path took {record['examples']['path_s']:.1f} s")
    wide = record["examples"]["wide"]
    for row in kernels:      # each kernel's launches on the examples path
        base = row["name"].split("[")[0]
        row["examples_launches"] = record["examples"]["launches"][base]
        if row["name"] == "scan_topk_indexed":
            row["wide"] = {"f32": wide["f32"], "bf16": wide["bf16"]}
        elif row["name"] == "scan_topk_indexed_q8":
            row["wide"] = {"d3072": wide["q8"], "d8192": wide["q8_8192"]}
    checks = record["engine"]["engine_check"]
    for row in kernels:      # each kernel's launches on the engine path
        row["engine_launches"] = path_launches["engine"][
            row["name"].split("[")[0]]
        # held against the plain version on the engine path's own operands
        if row["name"] == "scan_topk_indexed":
            row["engine_check"] = {s_: checks[s_] for s_ in ("f32", "bf16")}
        elif row["name"] == "scan_topk_indexed_q8":
            row["engine_check"] = {"int8": checks["int8"]}
        elif row["name"] == "kmeans_assign":
            row["engine_check"] = {"insert": checks["kmeans_assign"]}
        elif row["name"] == "scan_topk":
            row["engine_check"] = {"bruteforce_f32": {
                k_: row["shapes"]["brute_force"][k_]
                for k_ in ("max_abs_err", "tol", "Q", "N", "k_pad")}}
    record.update(kernels=kernels, card=card, path_launches=path_launches,
                  total_s=time.perf_counter() - t_start)
    (OUT_DIR / "record.json").write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: all paths passed in "
          f"{record['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def uncounted(counters, fn):
    """``fn()`` with the kernels' launch counts left as they were: the
    launches of a comparison or a profile are not the path's."""
    saved = {n: c.count for n, c in counters.items()}
    try:
        return fn()
    finally:
        for n, c in counters.items():
            c.count = saved[n]


def library_indexed(q, blocks, valid, sel_l, qmask, metric, kp):
    """The indexed scan's function as library calls: ``torch.topk`` over
    a ``torch.matmul`` of the queries (64 at a time) against the gathered
    union rows ``blocks`` (U, S, d)."""
    import torch
    from repro_torch.kernels.ref import MASK_DIST
    d = blocks.shape[-1]
    xs_u = blocks.reshape(-1, d)
    ok = valid.index_select(0, sel_l).reshape(-1)
    aux = torch.where(ok, 0.0, MASK_DIST)
    if metric == "l2":
        aux = aux + (xs_u * xs_u).sum(1)
    coef = -2.0 if metric == "l2" else -1.0
    out = []
    for b0 in range(0, q.shape[0], 64):
        dist = aux + coef * torch.matmul(q[b0:b0 + 64], xs_u.T)
        m = qmask[b0:b0 + 64].repeat_interleave(blocks.shape[1], 1)
        dist = torch.where(m, dist, MASK_DIST)
        out.append(torch.topk(dist, kp, dim=1, largest=False))
    return out


def library_indexed_q8(q_codes, q_scales, codes, scales, aux, qc, valid,
                       sel, qmask, *, k_pad, metric):
    """The int8 scan's function (``ref.scan_indexed_q8_ref``) as library
    calls, from the kernel's own operands: the union's codes gathered and
    dequantized to f32, the queries dequantized, ``torch.topk`` over a
    ``torch.matmul`` of 64 queries at a time plus ``qc`` and ``aux``."""
    import torch
    from repro_torch.kernels.ref import MASK_DIST
    sel = sel.long()
    s, d = codes.shape[1], codes.shape[2]
    rows = (codes.index_select(0, sel).float()
            * scales.index_select(0, sel)[..., None]).reshape(-1, d)
    aux_u = aux.index_select(0, sel).reshape(-1)
    ok = valid.index_select(0, sel).reshape(-1)
    q = q_codes.float() * q_scales[:, None]
    coef = -2.0 if metric == "l2" else -1.0
    out = []
    for b0 in range(0, q.shape[0], 64):
        qx = qc[b0:b0 + 64].repeat_interleave(s, 1) \
            + torch.matmul(q[b0:b0 + 64], rows.T)
        keep = ok & qmask[b0:b0 + 64].repeat_interleave(s, 1)
        dist = torch.where(keep, aux_u + coef * qx, MASK_DIST)
        out.append(torch.topk(dist, k_pad, dim=1, largest=False))
    return out


def hold_bit_equal(name, d_k, i_k, d_p, i_p):
    """int8 results against the plain oracle's: distances bit-equal, ids
    equal wherever the distance is not exactly tied (with a neighbour in
    the list, or with the k-th, whose neighbours outside are unseen):
    the kernel's plain version walks the union in partition order, the
    oracle in union order, so exact ties may keep different rows."""
    import torch
    d_k, d_p = d_k.cpu(), d_p.cpu()
    if not torch.equal(d_k, d_p):
        fail(f"{name}: distances not bit-equal")
    tied = d_p == d_p[:, -1:]
    tied[:, 1:] |= d_p[:, 1:] == d_p[:, :-1]
    tied[:, :-1] |= d_p[:, :-1] == d_p[:, 1:]
    diff = i_k.cpu() != i_p.cpu()
    if bool((diff & ~tied).any()):
        fail(f"{name}: {int((diff & ~tied).sum())} ids differ away from "
             f"exact ties")
    print(f"{name}: distances bit-equal; ids differ at {int(diff.sum())} "
          f"positions, all exact ties")


def hold_adaptive(name, kern, plain, q, snap):
    """``search_adaptive`` of two engines (the one under test, its
    reference) on the same queries.  With equal probe counts the lists
    must agree (``compare_topk``).  Otherwise every query scans ``chunk``
    partitions a round, so one side took more rounds: it must be exactly
    one more, both engines rerun with ``max_rounds`` pinned to the
    smaller count must agree (probe counts equal, lists by
    ``compare_topk``), and at that round the side that went on must have
    had every query it left below the target within ENGINE_TARGET_TIE of
    it (the query that decided the extra round), the other none below.
    Returns the check's record."""
    import dataclasses
    import torch
    from repro_torch.core import ShardedQuakeEngine
    target, chunk = kern.cfg.recall_target, kern.cfg.chunk
    got, ref_ = kern.search_adaptive(q, snap), plain.search_adaptive(q, snap)
    rounds = [-(-int(r[3].max()) // chunk) for r in (got, ref_)]
    out = {"queries": int(q.shape[0]), "rounds": rounds}
    if not torch.equal(got[3].cpu(), ref_[3].cpu()):
        if abs(rounds[0] - rounds[1]) != 1:
            fail(f"{name}: {rounds[0]} rounds vs {rounds[1]}, not one apart")
        pin = min(rounds)
        got, ref_ = (ShardedQuakeEngine(e.mesh, dataclasses.replace(
            e.cfg, max_rounds=pin)).search_adaptive(q, snap)
            for e in (kern, plain))
        if not torch.equal(got[3].cpu(), ref_[3].cpu()):
            fail(f"{name}: probe counts differ with both pinned to {pin} "
                 f"rounds")
        went_on, stopped = (got, ref_) if rounds[0] > rounds[1] \
            else (ref_, got)
        below = went_on[2].double().cpu() < target
        margin = float((target - went_on[2].double().cpu()[below]).max()) \
            if bool(below.any()) else None
        if margin is None or margin >= ENGINE_TARGET_TIE or bool(
                (stopped[2].double().cpu() < target).any()):
            fail(f"{name}: at round {pin} the side that went on left "
                 f"{int(below.sum())} queries below the target, by up to "
                 f"{margin!r}, and the other "
                 f"{int((stopped[2].cpu() < target).sum())}; only queries "
                 f"within {ENGINE_TARGET_TIE} of the target may differ")
        out.update(pinned_rounds=pin, deciding_queries=int(below.sum()),
                   deciding_margin=margin)
        print(f"{name}: {rounds[0]} rounds vs {rounds[1]}; at round {pin} "
              f"the lists agree and {int(below.sum())} queries decided "
              f"the extra round, within {margin:.3g} of the target")
    out["max_abs_err"], _ = compare_topk(name, *got[:2], *ref_[:2])
    out["recall_estimate_max_diff"] = float(
        (got[2].double() - ref_[2].double()).abs().max())
    print(f"{name}: recall estimates differ by at most "
          f"{out['recall_estimate_max_diff']:.3g}")
    return out


def hold_query_blocks(name, calls, plain, rows, cols, exact,
                      tol=(TOL_REL, TOL_ABS)):
    """Hold each captured indexed-scan call's result (the path's own)
    against the plain version, ENGINE_HOLD_Q queries at a time: each
    block takes its query rows of the operands at positions ``rows`` and,
    of those at ``cols``, the union slots that some query of the block
    selects.  A query's plain result depends only on its own selected
    slots, walked in partition order, so each block gives its queries
    what the whole call's plain version would (that one would hold (B, U
    * S) scores at once).  ``exact``: distances bit-equal.  Returns the
    check's record."""
    import torch
    if not calls:
        fail(f"{name}: no call of the engine path was captured")
    errs, shapes = [], []
    for i, (a, kw, (dk, ik)) in enumerate(calls):
        b, u = (int(n) for n in a[-1].shape)
        parts = []
        for b0 in range(0, b, ENGINE_HOLD_Q):
            used = torch.nonzero(a[-1][b0:b0 + ENGINE_HOLD_Q].any(0))
            used = used.reshape(-1) if used.numel() else used.new_zeros(1)
            blk = []
            for j, t in enumerate(a):
                if j in rows:
                    t = t[b0:b0 + ENGINE_HOLD_Q]
                if j in cols:
                    t = t.index_select(t.dim() - 1, used)
                blk.append(t)
            parts.append(plain(*blk, **kw))
        dp = torch.cat([p_[0] for p_ in parts])
        ip_ = torch.cat([p_[1] for p_ in parts])
        err, _ = compare_topk(f"{name} call {i} (B {b}, U {u}, k_pad "
                              f"{kw['k_pad']})", dk, ik, dp, ip_, tol)
        if exact and not torch.equal(dk, dp):
            fail(f"{name} call {i}: distances differ from the plain "
                 f"version's by {err!r}, not bit-equal")
        errs.append(err)
        shapes.append({"B": b, "U": u, "k_pad": kw["k_pad"]})
        del parts, dp, ip_
    return {"calls": len(calls), "max_abs_err": max(errs),
            "bit_equal": bool(exact), "shapes": shapes}


def brute_force_shape(st, snap, q_dev):
    """The dense scan at ``search_bruteforce``'s shape: the B queries
    against every row of the engine's f32 block (its P * S_cap slots,
    ``valid`` the live ones), k_pad of k = 100.  Held against the plain
    version in blocks of BRUTE_PLAIN_Q queries (its (Q, N) distance
    matrix does not fit at B = 1,024: 42 GB), and timed beside the
    library's ``torch.matmul`` + ``torch.topk`` over 1M-row chunks,
    merged (||x||^2 and the mask bias outside the timing).  The bound
    counts the live rows only: those the function needs."""
    from repro_torch.kernels import build
    import torch
    from repro_torch.kernels.ref import MASK_DIST
    b, d = q_dev.shape
    flat = snap.data.reshape(-1, d)
    valid = snap.ids.reshape(-1) >= 0
    n, n_live = flat.shape[0], int(valid.sum())
    kp = 128

    def kern():
        return st.scan_topk_cuda(q_dev, flat, valid, k_pad=kp)
    dk, ik = kern()

    def plain():
        parts = [st.scan_topk_plain(q_dev[b0:b0 + BRUTE_PLAIN_Q], flat,
                                    valid, k_pad=kp)
                 for b0 in range(0, b, BRUTE_PLAIN_Q)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    (dp, ip_), plain_ms = timed(plain)
    err, tol = compare_topk("scan_topk at the brute-force shape", dk, ik,
                            dp, ip_)
    del dp, ip_
    aux = torch.where(valid, (flat * flat).sum(1), MASK_DIST)
    chunk = 1 << 20

    def library():
        vals, pos = [], []
        for r0 in range(0, n, chunk):
            dist = aux[r0:r0 + chunk] - 2.0 * torch.matmul(
                q_dev, flat[r0:r0 + chunk].T)
            v, i = torch.topk(dist, kp, dim=1, largest=False)
            vals.append(v)
            pos.append(i + r0)
        v, i = torch.topk(torch.cat(vals, 1), kp, dim=1, largest=False)
        return v, torch.gather(torch.cat(pos, 1), 1, i)
    ms = cuda_ms(kern, reps=3, warmup=1)
    lib_ms = cuda_ms(library, reps=3, warmup=1)
    bound_ms, bound_by = build.bound(
        (b + n_live) * d * 4 + n + 2 * b * kp * 4, 2.0 * b * n_live * d,
        build.F32_FLOPS_PER_S)
    row = {"Q": b, "N": n, "N_live": n_live, "d": d, "k_pad": kp,
           "design": st.design(b), "max_abs_err": err, "tol": tol,
           "ms": ms, "device_ms": device_ms(kern, reps=3),
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"scan_topk brute force (Q={b}, N={n}, {n_live} live, k_pad "
          f"{kp}): err {err:.3g}, {ms:.3f} ms ({row['device_ms']:.3f} "
          f"device), library {lib_ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ({bound_by})")
    return row


def run_engine(args, idx, q, gt, r_ex, first_id, dev, counters):
    """Path 6, part 1: the sharded engine on path 1's index, a one-rank
    mesh over NCCL (``make_host_mesh``: ("data", "model"), partitions on
    "data", queries on "model").  Legs at B = ``--batch``, each entry
    point called once to warm it and once timed (host clock to a
    synchronize): f32 at ``"union_cuda"`` (``search_bruteforce``,
    ``search_fixed``, ``search_adaptive``, ``search_batch``), then bf16
    and int8 storage (fixed, adaptive, batch), then the refresh leg.

    Gates: brute force recall@k >= BRUTE_RECALL_MIN against the exact
    ground truth; ``search_batch`` equal to the executor's on the same
    index and planner (``r_ex``, the host planner: ids but at near-ties,
    rounds and partitions scanned); in every storage, the indexed scans of the timed fixed,
    adaptive and batch calls held against their plain versions on their
    own operands (``hold_query_blocks``: the main path's tolerance, int8
    bit-equal); fixed and adaptive against the same engine at
    ``"union_torch"`` (the plain oracles) on the first ENGINE_CHECK_Q
    queries (the oracle sorts every (query, union row) distance); the
    ``"gather"`` scan on the first ENGINE_GATHER_Q queries against
    ``"union_cuda"``; bf16 ids overlapping f32's by BF16_RECALL; int8
    bit-equal to ``"union_torch"`` (fixed, adaptive, batch) on the check
    queries; 100 vectors inserted near 4 queries refresh the f32 block
    by one delta, no rebuild, and are found (their ``kmeans_assign``
    call held against its plain version); a structural change rebuilds
    it.  Returns (record, the brute-force ``scan_topk`` row)."""
    import numpy as np
    import torch
    from repro_torch.core import EngineConfig, ShardedQuakeEngine
    from repro_torch.kernels import scan_topk as st
    from repro_torch.launch.mesh import describe, make_host_mesh
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_topk_indexed as sti
    mesh = make_host_mesh(device="cuda")
    out = {"card": card_line(), "mesh": describe(mesh), "legs": {},
           "engine_check": {}}
    print(f"engine: mesh {out['mesh']} over NCCL on {mesh.device}")
    base = dict(k=args.k, nprobe=ENGINE_NPROBE, chunk=ENGINE_CHUNK,
                max_rounds=ENGINE_ROUNDS, recall_target=ENGINE_TARGET)

    def engine(**kw):
        return ShardedQuakeEngine(mesh, EngineConfig(**base, **kw))

    captured = {}     # storage -> the timed calls' indexed scans

    def capture(storage, calls):
        """The storage's indexed-scan wrapper, patched to record up to
        ``calls`` more of its calls."""
        got = captured.setdefault(storage, [])
        name, at, by_ref = ("scan_topk_indexed_q8", 2, {2, 3, 6}) \
            if storage == "int8" else ("scan_topk_indexed", 1, {1, 2})
        return sti, name, capture_rounds(getattr(sti, name), got, at,
                                         by_ref, len(got) + calls)

    def hold(storage):
        calls = captured.pop(storage)
        if storage == "int8":
            out["engine_check"][storage] = hold_query_blocks(
                "engine int8 scan_topk_indexed_q8", calls,
                sti.scan_topk_indexed_q8_plain, {0, 1, 5, 8}, {5, 7, 8},
                exact=True)
        else:
            out["engine_check"][storage] = hold_query_blocks(
                f"engine {storage} scan_topk_indexed", calls,
                sti.scan_topk_indexed_plain, {0, 4}, {3, 4}, exact=False)
        del calls
        torch.cuda.empty_cache()

    def leg(name, fn, storage=None, calls=ENGINE_HOLD_ROUNDS):
        """Warm ``fn``, then time it; with ``storage`` the timed call's
        first ``calls`` indexed scans are captured."""
        res, wall, launches = warm_then_time(fn, counters, lambda: patched(
            *([capture(storage, calls)] if storage else [])))
        batch = not isinstance(res, tuple)
        ids = res.ids if batch else res[1].cpu().numpy()
        dists = res.dists if batch else res[0].double().cpu().numpy()
        if ids.shape != (q.shape[0], args.k):
            fail(f"engine {name}: result shape {ids.shape}")
        if not np.isfinite(dists[ids >= 0]).all() or \
                (not batch and (dists[ids >= 0] >= 1e37).any()):
            fail(f"engine {name}: non-finite distances")
        row = {"wall_ms": wall, "launches_per_call": launches,
               "recall@k": recall_at(ids, gt)}
        if batch:
            row.update(rounds=int(res.rounds),
                       mean_nprobe=float(res.nprobe.mean()),
                       partitions_scanned=int(res.partitions_scanned))
        elif len(res) == 4:
            row.update(mean_nprobe=float(res[3].double().mean()),
                       rounds=int(res[3].max()) // ENGINE_CHUNK,
                       mean_recall_estimate=float(res[2].mean()))
        out["legs"][name] = row
        print(f"  engine {name}: recall@{args.k} {row['recall@k']:.4f}, "
              f"warm {wall:.1f} ms, launches {launches}"
              + (f", rounds {row['rounds']}, mean nprobe "
                 f"{row['mean_nprobe']:.2f}" if "rounds" in row else ""))
        return res

    q_dev = torch.as_tensor(q, device=dev)
    qc, qg = q[:ENGINE_CHECK_Q], q[:ENGINE_GATHER_Q]

    # ---- f32 ----
    e32 = engine(scan_impl="union_cuda")
    snap = e32.refresh_snapshot(idx)
    out["snapshot"] = {"P": snap.num_partitions, "S_cap": snap.capacity,
                       "live_rows": int((snap.ids >= 0).sum())}
    leg("bruteforce_f32", lambda: e32.search_bruteforce(q, snap))
    if out["legs"]["bruteforce_f32"]["recall@k"] < BRUTE_RECALL_MIN:
        fail(f"engine brute force recall "
             f"{out['legs']['bruteforce_f32']['recall@k']:.4f} < "
             f"{BRUTE_RECALL_MIN}")
    fixed = leg("fixed_f32", lambda: e32.search_fixed(q, snap), "f32", 1)
    leg("adaptive_f32", lambda: e32.search_adaptive(q, snap), "f32")
    rb = leg("batch_f32", lambda: e32.search_batch(idx, q, args.k,
                                                   recall_target=0.9),
             "f32")
    compare_topk("engine search_batch vs the executor's",
                 torch.as_tensor(rb.dists), torch.as_tensor(rb.ids),
                 torch.as_tensor(r_ex.dists), torch.as_tensor(r_ex.ids))
    if (rb.rounds, rb.partitions_scanned) != (r_ex.rounds,
                                              r_ex.partitions_scanned):
        fail(f"engine search_batch: rounds {rb.rounds}, partitions "
             f"{rb.partitions_scanned}; the executor's {r_ex.rounds}, "
             f"{r_ex.partitions_scanned}")

    def f32_checks():
        hold("f32")
        plain = engine(scan_impl="union_torch")
        compare_topk("engine f32 search_fixed vs union_torch",
                     *e32.search_fixed(qc, snap),
                     *plain.search_fixed(qc, snap))
        out["adaptive_vs_union_torch"] = hold_adaptive(
            "engine f32 search_adaptive vs union_torch", e32, plain, qc,
            snap)
        gather = engine(scan_impl="gather")
        compare_topk("engine gather search_fixed vs union_cuda",
                     *gather.search_fixed(qg, snap),
                     *e32.search_fixed(qg, snap))
        out["gather_adaptive_vs_union_cuda"] = hold_adaptive(
            "engine gather search_adaptive vs union_cuda", gather, e32, qg,
            snap)
        out["profile_fixed"] = profile_call(
            lambda: e32.search_fixed(q, snap), "engine_search_fixed")
        out["profile_adaptive"] = profile_call(
            lambda: e32.search_adaptive(q, snap), "engine_search_adaptive")
        return brute_force_shape(st, snap, q_dev)
    brute_row = uncounted(counters, f32_checks)

    # ---- bf16 ----
    e16 = engine(scan_impl="union_cuda", storage_dtype="bf16")
    s16 = e16.refresh_snapshot(idx)
    f16 = leg("fixed_bf16", lambda: e16.search_fixed(q, s16), "bf16", 1)
    leg("adaptive_bf16", lambda: e16.search_adaptive(q, s16), "bf16")
    leg("batch_bf16", lambda: e16.search_batch(idx, q, args.k,
                                               recall_target=0.9), "bf16")
    hold("bf16")
    ov = overlap(f16[1].cpu().numpy(), fixed[1].cpu().numpy())
    out["bf16_overlap_f32"] = ov
    print(f"  engine bf16 search_fixed ids overlap f32's: {ov:.4f}")
    if ov < BF16_RECALL:
        fail(f"engine bf16 overlap with f32 {ov:.4f} < {BF16_RECALL}")
    del e16, s16, f16

    # ---- int8 ----
    e8 = engine(scan_impl="union_cuda", storage_dtype="int8")
    s8 = e8.refresh_snapshot(idx)
    leg("fixed_int8", lambda: e8.search_fixed(q, s8), "int8", 1)
    leg("adaptive_int8", lambda: e8.search_adaptive(q, s8), "int8")
    leg("batch_int8", lambda: e8.search_batch(idx, q, args.k,
                                              recall_target=0.9), "int8")
    hold("int8")

    def int8_checks():
        # fresh engines: each planner calibrates its radius on these queries
        kern = engine(scan_impl="union_cuda", storage_dtype="int8")
        plain = engine(scan_impl="union_torch", storage_dtype="int8")
        pairs = [("search_fixed", e8.search_fixed(qc, s8),
                  plain.search_fixed(qc, s8)),
                 ("search_adaptive", e8.search_adaptive(qc, s8),
                  plain.search_adaptive(qc, s8))]
        for name, a, b in pairs:
            hold_bit_equal(f"engine int8 {name} vs union_torch", *a[:2],
                           *b[:2])
            for x, y in zip(a[2:], b[2:]):
                if not torch.equal(x.cpu(), y.cpu()):
                    fail(f"engine int8 {name}: recall estimates or probe "
                         f"counts differ from union_torch's")
        ra = kern.search_batch(idx, qc, args.k, recall_target=0.9)
        rp = plain.search_batch(idx, qc, args.k, recall_target=0.9)
        hold_bit_equal("engine int8 search_batch vs union_torch",
                       *(torch.as_tensor(v) for v in (ra.dists, ra.ids,
                                                      rp.dists, rp.ids)))
        if ra.rounds != rp.rounds or not np.array_equal(ra.nprobe,
                                                        rp.nprobe):
            fail("engine int8 search_batch: rounds or probe counts differ "
                 "from union_torch's")
    uncounted(counters, int8_checks)
    del e8, s8
    torch.cuda.empty_cache()

    # ---- refresh: a delta patch, then a structural rebuild ----
    rebuilds = e32.full_rebuilds
    rng = np.random.default_rng(args.seed + 6)
    new_x = (np.repeat(q[:4], 25, axis=0) + rng.normal(
        size=(100, q.shape[1])).astype(np.float32) * 0.01)
    new_ids = np.arange(first_id, first_id + 100, dtype=np.int64)
    before = counters["kmeans_assign"].count
    assign, real_assign = [], ka.kmeans_assign

    def captured_assign(xs, cents, aux):
        assign.append((xs.clone(), cents.clone(), aux.clone()))
        return real_assign(xs, cents, aux)
    with patched((ka, "kmeans_assign", captured_assign)):
        idx.insert(new_x, new_ids)
    if not assign:
        fail("engine refresh: the insert routed nothing through "
             "kmeans_assign")
    xs_a, c_a, aux_a = assign[-1]
    err, tol, _ = uncounted(counters, lambda: hold_assign(
        ka, "engine kmeans_assign (the refresh leg's insert)", xs_a, c_a,
        aux_a))
    out["engine_check"]["kmeans_assign"] = {
        "calls": len(assign), "max_abs_err": err, "tol": tol,
        "shape": {"N": int(xs_a.shape[0]), "C": int(c_a.shape[0]),
                  "d": int(xs_a.shape[1])}}
    del assign, xs_a, c_a, aux_a
    snap = e32.refresh_snapshot(idx)
    _, ids4 = e32.search_fixed(q[:4], snap)
    found = len(set(ids4.cpu().numpy().ravel().tolist())
                & set(new_ids.tolist()))
    out["refresh"] = {"delta_refreshes": e32.delta_refreshes,
                      "full_rebuilds": e32.full_rebuilds,
                      "new_ids_found": found,
                      "kmeans_assign_launches":
                          counters["kmeans_assign"].count - before}
    if e32.delta_refreshes != 1 or e32.full_rebuilds != rebuilds:
        fail(f"engine refresh: {e32.delta_refreshes} delta refreshes, "
             f"{e32.full_rebuilds} full rebuilds after an insert of 100")
    if found != len(new_ids):
        fail(f"engine refresh: {found} of {len(new_ids)} new ids found")
    idx.journal.record(structural=True, reason="chip_smoke structural")
    e32.refresh_snapshot(idx)
    out["refresh"]["full_rebuilds_after_structural"] = e32.full_rebuilds
    if e32.full_rebuilds != rebuilds + 1:
        fail("engine refresh: a structural change must rebuild the block")
    print(f"engine refresh: {out['refresh']}")
    return out, brute_row


def run_capacity(args, dev, counters):
    """Path 6, part 2: the ``quake-ann`` capacity leg, configs/
    quake_arch.py's FULL (p = 16,384, s_cap = 12,288, d = 128, k = 100)
    in int8 storage on one card, drawn by ``IndexSnapshot.synthetic``
    (25.8 GB of codes; no index behind it).  Queries are the port's
    own: CAP_B rows near centroids picked from a seeded generator.
    ``serve_fixed_1k`` (``search_fixed``, nprobe CAP_NPROBE) and
    ``serve_adaptive_1k`` (``search_adaptive``), each warmed and timed;
    recall@k of the first CAP_GT_Q queries against their exact top-k over
    the f32 rows (drawn again, block by block); the q8 kernel held
    bit-equal to its plain version on the first CAP_CHECK_Q queries'
    own union (the whole union's plain version would need (B, U*S)
    scores).  ``bulk_brute_8k`` is left out (about 422 TFLOP of f32)."""
    import torch
    from repro_torch.core import EngineConfig, IndexSnapshot, \
        ShardedQuakeEngine
    from repro_torch.core.snapshot import synthetic_blocks
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import scan_topk_indexed as sti
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    snap = IndexSnapshot.synthetic(CAP_P, CAP_S, CAP_D, seed=args.seed,
                                   dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    out = {"card": card_line(), "build_s": time.perf_counter() - t,
           "shape": {"p": CAP_P, "s_cap": CAP_S, "d": CAP_D, "k": CAP_K,
                     "B": CAP_B, "nprobe": CAP_NPROBE},
           "bytes": {"codes": snap.data.numel(),
                     "scales": snap.scales.numel() * 4,
                     "ids": snap.ids.numel() * 4},
           "legs": {}}
    print(f"capacity: int8 snapshot {CAP_P} x {CAP_S} x {CAP_D} drawn in "
          f"{out['build_s']:.1f} s: {out['bytes']}")
    eng = ShardedQuakeEngine(make_host_mesh(device="cuda"), EngineConfig(
        k=CAP_K, nprobe=CAP_NPROBE, chunk=ENGINE_CHUNK,
        max_rounds=ENGINE_ROUNDS, recall_target=ENGINE_TARGET,
        scan_impl="union_cuda", storage_dtype="int8"))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    pick = torch.randint(0, CAP_P, (CAP_B,), generator=gen, device=dev)
    q = snap.centroids[pick] + torch.randn((CAP_B, CAP_D), generator=gen,
                                           device=dev)
    # exact top-k of the first CAP_GT_Q queries over the f32 rows
    qg = q[:CAP_GT_Q]
    best_d = torch.full((CAP_GT_Q, 0), 0.0, device=dev)
    best_i = torch.full((CAP_GT_Q, 0), 0, dtype=torch.long, device=dev)
    for a, z, _, x in synthetic_blocks(CAP_P, CAP_S, CAP_D, args.seed,
                                       dev):
        x = x.reshape(-1, CAP_D)
        dist = (x * x).sum(1)[None] - 2.0 * qg @ x.T
        v, i = torch.topk(dist, CAP_K, dim=1, largest=False)
        v, j = torch.topk(torch.cat([best_d, v], 1), CAP_K, dim=1,
                          largest=False)
        best_i = torch.gather(torch.cat([best_i, i + a * CAP_S], 1), 1, j)
        best_d = v
    gt = best_i.cpu().numpy()     # ids are arange: flat index = id
    del x, dist
    # the q8 kernel on the first CAP_CHECK_Q queries' own union
    q8 = q[:CAP_CHECK_Q].contiguous()
    valid = snap.ids >= 0
    cd = eng._local_centroid_dists(q8, snap)
    sel_q = torch.sort(cd, dim=1, stable=True).indices[:, :CAP_NPROBE]
    selected = torch.zeros_like(cd, dtype=torch.bool).scatter_(1, sel_q,
                                                               True)
    sel_u, qmask = ops.pack_union(selected, CAP_CHECK_Q * CAP_NPROBE)
    operands = ref.q8_scan_operands(q8, snap.data, snap.scales, valid,
                                    sel_u, "l2", snap.centroids)
    args8 = (*operands[:2], snap.data, snap.scales, *operands[2:], valid,
             sel_u, qmask.contiguous())
    dk, ik = uncounted(counters, lambda: sti.scan_topk_indexed_q8_cuda(
        *args8, k_pad=128))
    dp, ip_ = sti.scan_topk_indexed_q8_plain(*args8, k_pad=128)
    if not (torch.equal(dk, dp) and torch.equal(ik, ip_)):
        fail("capacity: the q8 kernel is not bit-equal to its plain "
             "version on the check queries' union")
    out["q8_check"] = {"queries": CAP_CHECK_Q, "U": int(sel_u.shape[0]),
                       "bit_equal": True}
    print(f"capacity: q8 kernel bit-equal to its plain version on "
          f"{CAP_CHECK_Q} queries' union of {int(sel_u.shape[0])}")
    del operands, args8, dk, dp, valid, cd, selected, qmask
    torch.cuda.empty_cache()
    kp = ops._next_pow2(CAP_K)
    uc = max(1, sti.SCRATCH_BYTES // (CAP_B * kp * 8))
    for name, fn, u in (
            ("serve_fixed_1k", lambda: eng.search_fixed(q, snap),
             min(CAP_B * CAP_NPROBE, CAP_P)),
            ("serve_adaptive_1k", lambda: eng.search_adaptive(q, snap),
             min(CAP_B * ENGINE_CHUNK, CAP_P))):
        res, wall, launches = warm_then_time(fn, counters)
        d_, i_ = res[0], res[1].cpu().numpy()
        if i_.shape != (CAP_B, CAP_K) or not bool(torch.isfinite(
                d_[res[1] >= 0]).all()):
            fail(f"capacity {name}: bad result")
        row = {"wall_ms": wall, "launches_per_call": launches,
               "recall@k_first_queries": recall_at(i_[:CAP_GT_Q], gt),
               "union_slots_per_scan": u,
               "union_chunks_per_scan": -(-u // min(u, uc))}
        if len(res) == 4:
            row.update(mean_nprobe=float(res[3].double().mean()),
                       rounds=int(res[3].max()) // ENGINE_CHUNK)
        out["legs"][name] = row
        print(f"  capacity {name}: recall@{CAP_K} (first {CAP_GT_Q}) "
              f"{row['recall@k_first_queries']:.4f}, warm {wall:.1f} ms, "
              f"launches {row['launches_per_call']}, union "
              f"{u} slots in {row['union_chunks_per_scan']} chunk(s)"
              + (f", rounds {row['rounds']}" if "rounds" in row else ""))
    out["profile_fixed"] = uncounted(counters, lambda: profile_call(
        lambda: eng.search_fixed(q, snap), "capacity_serve_fixed_1k"))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"capacity: peak device memory {out['peak_gb']:.2f} GB "
          f"({out['card']})")
    return out


def dry_pass(idx, lam, tau):
    """The maintenance pass that ``lam`` with commit threshold ``tau``
    makes on the index's current statistics; the index is rolled back
    after it (``checkpoint_index`` / ``restore_index``)."""
    import dataclasses
    from repro_torch.core import Maintainer, checkpoint_index, restore_index
    ckpt, cfg = checkpoint_index(idx), idx.config
    idx.config = dataclasses.replace(cfg, tau_ns=tau)
    try:
        return Maintainer(idx, lam).run()
    finally:
        idx.config = cfg
        restore_index(idx, ckpt)


def wiki_workload(args):
    """The Wikipedia-style workload the dynamic loop and the serving path
    share (inner product, ``--wiki-n`` vectors, 1024 queries a month)."""
    from repro_torch.data.wikipedia import wikipedia_workload
    return wikipedia_workload(n_total=args.wiki_n, dim=args.dim,
                              months=args.months,
                              queries_per_month=max(args.batch,
                                                    args.month_queries),
                              seed=args.seed)


def run_dynamic(args, wl, dev, start_path, end_path) -> dict:
    """The dynamic loop on the Wikipedia-style workload: build, profile
    lambda on the card, then per month the insert burst, per-query APS
    searches (which record access statistics), one maintenance pass, the
    invariants, and one batched search through the f32 and the int8
    executors against the exact ground truth (recall@10 on the card).

    Maintenance is priced by lambda per query of a B-query scan, the
    batched path that serves the month's queries; each month also runs,
    and rolls back, the pass that the single-query lambda (the JAX
    package's ``profile``) would make on the same statistics.

    Fails when a pass's cost change net of refinement and level changes
    differs from the sum of its committed actions' verify deltas (the
    commit gate's accounting), no split commits, the invariants break,
    int8 overlaps f32 by less than INT8_OVERLAP, or the int8 executor
    patches its snapshot instead of rebuilding it.  A rise of the raw
    cost (refinement moves points after the gate, in the reference too)
    is reported per month, not gated."""
    import numpy as np
    import torch
    from repro_torch.core import (Maintainer, QuakeConfig, QuakeIndex,
                                  get_executor, profile)
    from repro_torch.core import kmeans
    from repro_torch.core.cost_model import paper_tau_ns
    from repro_torch.data.workload import IncrementalGroundTruth
    k = 10
    out = {"months": []}
    start_path()
    # lambda per query, in device time: the serving batch's scan, which
    # prices maintenance, and the single-query scan, whose pass is
    # reported beside it.  tau is the paper's, rescaled to each lambda.
    t = time.perf_counter()
    lams = {f"batch{b}": profile(args.dim, device=dev, batch=b)
            for b in (args.batch, 1)}
    out["profile_s"] = time.perf_counter() - t
    lam, lam_q = lams[f"batch{args.batch}"], lams["batch1"]
    tau, tau_q = paper_tau_ns(lam), paper_tau_ns(lam_q)
    card = card_line()
    out["lambda"] = {name: {"c_fixed": m.c_fixed, "c_lin": m.c_lin,
                            "c_sel": m.c_sel, "tau_ns": paper_tau_ns(m)}
                     for name, m in lams.items()}
    out["lambda"]["card"] = card
    print(f"dynamic: lambda profiled on {card} (ns per query, device "
          f"time; tau = 250 ns * lambda(500) / 1.2e6 ns):")
    for name, m in lams.items():
        print(f"  {name}: lambda(s) = {m.c_fixed:.3f} + {m.c_lin:.6f} s + "
              f"{m.c_sel:.6f} s log2 s, tau = {paper_tau_ns(m):.5f} ns")
    t = time.perf_counter()
    idx = QuakeIndex.build(wl.initial_vectors, wl.initial_ids,
                           config=QuakeConfig(metric="ip", tau_ns=tau),
                           device=dev)
    out["build_s"] = time.perf_counter() - t
    print(f"dynamic: {len(wl.initial_ids)} initial vectors, "
          f"{idx.num_partitions} partitions, built in {out['build_s']:.1f} "
          f"s")
    # k-means on the card is reproducible: two builds of one sample at
    # one seed give bit-equal centroids and the same assignments
    sample = wl.initial_vectors[:100_000]
    n_c = int(np.sqrt(len(sample)))
    c1, a1 = kmeans.kmeans(sample, n_c, seed=args.seed, device=dev)
    c2, a2 = kmeans.kmeans(sample, n_c, seed=args.seed, device=dev)
    out["kmeans_repeat"] = {"points": len(sample), "clusters": n_c,
                            "assignments_differ": int((a1 != a2).sum()),
                            "centroid_max_diff": float(np.abs(c1 - c2).max())}
    print(f"dynamic: two k-means builds of {len(sample)} vectors into "
          f"{n_c} clusters at seed {args.seed}: "
          f"{out['kmeans_repeat']['assignments_differ']} assignments "
          f"differ, largest centroid |diff| "
          f"{out['kmeans_repeat']['centroid_max_diff']!r}")
    if out["kmeans_repeat"]["assignments_differ"] or \
            out["kmeans_repeat"]["centroid_max_diff"]:
        fail("k-means on the card is not reproducible")
    maint = Maintainer(idx, lam)
    gt = IncrementalGroundTruth(wl.dataset, wl.initial_ids, device=dev)
    ex8 = get_executor(idx, "int8")
    seen_version = None      # index version the int8 snapshot last served
    inserted, splits, q_splits = 0, 0, 0
    print(f"month  vectors  parts    ins  pq_recall  pq_nprobe  pq_ms  splits "
          f"merges rejected  cost_before  cost_after    priced  unpriced  "
          f"maint_s | batch1: splits rejected | f32_rec  int8_rec  overlap")
    for op in wl.operations:
        if op.kind == "insert":
            idx.insert(op.vectors, op.ids)
            gt.insert(op.ids)
            inserted += len(op.ids)
            continue
        row = {"month": len(out["months"]) + 1, "inserted": inserted}
        inserted = 0
        qs = op.queries
        truth = gt.topk(qs, k)
        n_pq = args.month_queries
        torch.cuda.synchronize()
        t = time.perf_counter()
        hits, nps = [], []
        for qq, tt in zip(qs[:n_pq], truth):
            r = idx.search(qq, k, recall_target=0.9)
            hits.append(len(set(r.ids.tolist()) & set(tt.tolist())) / k)
            nps.append(r.nprobe[0])
        row.update(pq_queries=n_pq, pq_recall=float(np.mean(hits)),
                   pq_nprobe=float(np.mean(nps)),
                   pq_ms=(time.perf_counter() - t) / n_pq * 1e3)
        t = time.perf_counter()
        rq = dry_pass(idx, lam_q, tau_q)
        row.update(batch1_s=time.perf_counter() - t,
                   batch1_splits=rq.splits, batch1_merges=rq.merges,
                   batch1_rejected=rq.rejected_splits + rq.rejected_merges,
                   batch1_cost_before=rq.cost_before,
                   batch1_cost_after=rq.cost_after)
        q_splits += rq.splits
        t = time.perf_counter()
        rep = maint.run()
        priced = sum(a["delta"] for a in rep.actions if a["committed"])
        row.update(maint_s=time.perf_counter() - t, splits=rep.splits,
                   merges=rep.merges, rejected=rep.rejected_splits
                   + rep.rejected_merges, cost_before=rep.cost_before,
                   cost_after=rep.cost_after, priced=priced,
                   unpriced=rep.unpriced_cost, level_added=rep.level_added,
                   level_removed=rep.level_removed)
        splits += rep.splits
        # the commit gate's accounting: the splits and merges it committed
        # moved the cost by exactly the sum of their verify deltas
        moved = rep.cost_after - rep.unpriced_cost - rep.cost_before
        if abs(moved - priced) > 1e-6 * max(abs(rep.cost_before), 1.0):
            fail(f"month {row['month']}: the committed actions moved the "
                 f"cost by {moved:.6f}, their verify deltas sum to "
                 f"{priced:.6f}")
        try:
            idx.check_invariants()
        except AssertionError as e:
            fail(f"month {row['month']}: invariants broke after "
                 f"maintenance ({e!r})")
        qb = qs[:args.batch]
        rebuilds = ex8.full_rebuilds
        changed = seen_version is not None and idx.version != seen_version
        r32 = idx.search_batch(qb, k, recall_target=0.9)
        r8 = idx.search_batch(qb, k, recall_target=0.9, storage_dtype="int8")
        seen_version = idx.version
        row.update(vectors=idx.num_vectors, partitions=idx.num_partitions,
                   f32_recall=recall_at(r32.ids, truth[:args.batch]),
                   int8_recall=recall_at(r8.ids, truth[:args.batch]),
                   overlap=overlap(r8.ids, r32.ids),
                   int8_rebuilds=ex8.full_rebuilds,
                   int8_deltas=ex8.delta_refreshes)
        out["months"].append(row)
        print(f"{row['month']:5d} {row['vectors']:8d} {row['partitions']:6d}"
              f" {row['inserted']:6d} {row['pq_recall']:10.4f} "
              f"{row['pq_nprobe']:10.2f} {row['pq_ms']:6.2f} "
              f"{row['splits']:6d} {row['merges']:6d} {row['rejected']:8d} "
              f"{row['cost_before']:12.3f} {row['cost_after']:11.3f} "
              f"{row['priced']:9.3f} {row['unpriced']:9.3f} "
              f"{row['maint_s']:8.2f} | {row['batch1_splits']:14d} "
              f"{row['batch1_rejected']:8d} | {row['f32_recall']:7.4f} "
              f"{row['int8_recall']:9.4f} {row['overlap']:8.4f}")
        if row["overlap"] < INT8_OVERLAP:
            fail(f"month {row['month']}: int8 overlaps f32 by "
                 f"{row['overlap']:.4f} < {INT8_OVERLAP}")
        if ex8.delta_refreshes != 0 or (
                changed and ex8.full_rebuilds != rebuilds + 1):
            fail(f"month {row['month']}: the int8 executor must rebuild "
                 f"after a change (rebuilds {rebuilds} -> "
                 f"{ex8.full_rebuilds}, deltas {ex8.delta_refreshes})")
    if len(out["months"]) < 3:
        fail(f"the dynamic loop ran {len(out['months'])} months, not 3")
    if splits == 0:
        fail("no maintenance split was committed over the dynamic loop")
    rises = [(m["month"], m["cost_after"] - m["cost_before"])
             for m in out["months"] if m["cost_after"] > m["cost_before"]]
    out.update(splits=splits, batch1_splits=q_splits, raw_rises=rises)
    print(f"dynamic: {splits} splits committed at lambda batch{args.batch}; "
          f"{q_splits} would be at lambda batch1 (passes rolled back)")
    print(f"dynamic: cost_after <= cost_before in "
          f"{len(out['months']) - len(rises)} of {len(out['months'])} "
          f"passes; raw rises (month, ns): "
          + (", ".join(f"({m}, {d:+.3f})" for m, d in rises) or "none"))
    out["launches"] = end_path("dynamic", ("scan_topk", "kmeans_assign",
                                           "scan_topk_indexed",
                                           "scan_topk_indexed_q8"))
    return out


def serving_agreement(index, queries, groups, k, after_device=None):
    """Replay ``groups`` (lists of query rows in admission order) single-
    threaded through two runtimes over ``index``, one per scan backend;
    ``after_device()`` runs between the two.  Returns per backend (the
    per-query results, the runtime's rounds, its indexed-scan
    launches)."""
    from repro_torch.core import ServingConfig, ServingRuntime
    from repro_torch.kernels import scan_topk_indexed as sti
    out = {}
    for backend in ("device", "host"):
        rt = ServingRuntime(index, ServingConfig(
            k=k, recall_target=SERVE_TARGET, flush_size=10 ** 9,
            ticker=False, scan_backend=backend, planner=SERVE_PLANNER,
            record_stats=False, metrics=False, maint_min_ops=10 ** 9,
            maint_max_ops=None))
        before = sti.LAUNCHES.count
        qids = []
        for rows in groups:
            qids += [rt.submit_query(queries[r]) for r in rows]
            rt.flush()
        rt.drain()
        out[backend] = ([rt.result(i) for i in qids],
                        rt.stats()["rounds_run"],
                        sti.LAUNCHES.count - before)
        rt.close()
        if backend == "device" and after_device is not None:
            after_device()
    return out


@contextlib.contextmanager
def patched(*swaps):
    """Set each (object, attribute, value) of ``swaps`` for the block and
    put the old values back after it."""
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)


def capture_rounds(real, calls, data_arg, by_ref, limit):
    """A stand-in for an indexed-scan wrapper ``real`` that launches as
    ``real`` does and records the operands and the result of the calls
    while fewer than ``limit`` are recorded, each one whose plain version
    fits in SERVE_PLAIN_BYTES of card memory (it gathers the union's rows
    of argument ``data_arg`` and widens them to f32).  The snapshot's
    operands (positions ``by_ref``) are kept by reference, the call's own
    cloned."""
    def run(*a, **kw):
        codes, sel = a[data_arg], a[-2]
        elem = codes.element_size()
        need = (int(sel.shape[0]) * int(codes.shape[1]) * int(codes.shape[2])
                * (elem + (4 if elem != 4 else 0)))
        keep = len(calls) < limit and need <= SERVE_PLAIN_BYTES
        if keep:
            a_kept = [t if i in by_ref else t.clone() for i, t in enumerate(a)]
        out = real(*a, **kw)
        if keep:
            calls.append((a_kept, dict(kw), out))
        return out
    return run


def hold_rounds(name, calls, plain, exact):
    """Hold each captured round's kernel result (the path's own) against
    its plain version (``compare_topk``; ``exact``: distances
    bit-equal).  Returns the check's record."""
    if not calls:
        fail(f"{name}: no round of the serving path was captured")
    errs, shapes = [], []
    for i, (a, kw, (dk, ik)) in enumerate(calls):
        dp, ip_ = plain(*a, **kw)
        b, u = int(a[-1].shape[0]), int(a[-2].shape[0])
        err, tol = compare_topk(f"{name} serving round {i} (B {b}, U {u}, "
                                f"k_pad {kw['k_pad']})", dk, ik, dp, ip_)
        if exact and err != 0.0:
            fail(f"{name} serving round {i}: distances differ from the "
                 f"plain version's by {err!r}, not 0")
        errs.append(err)
        shapes.append({"B": b, "U": u, "S": int(a[-3].shape[1]),
                       "k_pad": kw["k_pad"]})
    return {"rounds": len(calls), "max_abs_err": max(errs),
            "shapes": shapes}


def exact_ip(index, q, ids):
    """Exact f64 inner-product distances (-q.x) of the external ``ids``,
    in their order, from the index's host rows: the arbiter of a
    near-tie at the k-th distance."""
    import numpy as np
    lvl0 = index.levels[0]
    x = []
    for e in ids:
        j = index.id_map[int(e)]
        x.append(lvl0.vectors[j][np.nonzero(lvl0.ids[j] == e)[0][0]])
    return -(np.stack(x).astype(np.float64) @ q.astype(np.float64))


def run_serving(args, wl, dev, start_path, end_path) -> dict:
    """The online serving path: ``launch/serve.replay_runtime`` drives the
    Wikipedia-style workload through ``ServingRuntime`` (micro-batching
    with a 5 ms deadline ticker, riding probe rounds on the card, the
    result cache, drift-triggered maintenance, metrics, a WAL with
    checkpoints under a temporary directory); then a replay of the
    admission groups after the last write through both scan backends,
    the idle share of one warm flush, those queries again at int8
    storage, one more insert burst through a runtime re-attached to the
    WAL directory, and ``ServingRuntime.recover`` on that directory.

    Fails unless every query reaches a terminal status with no scan
    fault, every device round launched the indexed-scan kernel and no
    round ran on the host, every insert burst launched ``kmeans_assign``,
    the int8 leg launched the q8 kernel, the kernels agree with their
    plain versions on this path's own operands (the largest insert
    burst's assignment, the largest centroid pass and up to
    SERVE_CHECK_ROUNDS rounds of the f32 and the int8 scans; the int8
    scan bit-equal), the two backends return the same ids (a differing
    id only at a near-tie with the k-th distance, by exact f64 scores),
    and the recovery replays the WAL's insert into an index whose
    fingerprint equals the live one's."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import (QuakeConfig, QuakeIndex, ServingConfig,
                                  ServingRuntime)
    from repro_torch.core import serving as srv
    from repro_torch.faults import index_state_fingerprint
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_topk as st
    from repro_torch.kernels import scan_topk_indexed as sti
    from repro_torch.launch import serve
    k = SERVE_K
    card = card_line()
    out = {"card": card, "kernel_checks": {}}
    checks = out["kernel_checks"]
    # the months of this path: the workload's operations up to its
    # ``serve_months``-th query op
    ops, n_q = [], 0
    for op in wl.operations:
        if n_q == args.serve_months:
            break
        ops.append(op)
        n_q += op.kind == "query"
    wl = dataclasses.replace(wl, operations=ops)
    wal = tempfile.mkdtemp(prefix="quake_wal_")
    scfg = ServingConfig(k=k, recall_target=SERVE_TARGET, flush_size=256,
                         flush_deadline_ms=5.0, ticker=True,
                         cache_entries=4096, metrics=True,
                         scan_backend="auto", storage_dtype="f32",
                         planner=SERVE_PLANNER, wal_dir=wal, fsync="batch",
                         record_admissions=True)
    cfg = QuakeConfig(metric="ip", recall_target=SERVE_TARGET)
    # counted on the way: rounds served on the host, the kmeans_assign
    # launches of each insert burst, and the largest burst's operands
    host_rounds, insert_kmeans, in_insert, burst = [0], [], [False], {}
    real_host_scan, real_insert = srv.host_scan_round, QuakeIndex.insert
    real_assign = ka.kmeans_assign

    def counted_host_scan(*a, **kw):
        host_rounds[0] += 1
        return real_host_scan(*a, **kw)

    def counted_insert(self, *a, **kw):
        before = ka.LAUNCHES.count
        in_insert[0] = True
        try:
            return real_insert(self, *a, **kw)
        finally:
            in_insert[0] = False
            insert_kmeans.append(ka.LAUNCHES.count - before)

    def captured_assign(xs, cents, aux):
        size = int(xs.shape[0]) * int(cents.shape[0])
        if in_insert[0] and size > burst.get("size", 0):
            burst.update(size=size, args=(xs.clone(), cents.clone(),
                                          aux.clone()))
        return real_assign(xs, cents, aux)

    start_path()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with patched((srv, "host_scan_round", counted_host_scan),
                 (QuakeIndex, "insert", counted_insert),
                 (ka, "kmeans_assign", captured_assign)):
        summary = serve.replay_runtime(wl, cfg, scfg, verbose=False,
                                       device=dev, gt_device=dev)
    out["replay_s"] = time.perf_counter() - t
    out["replay_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = end_path("serving", ())
    rt, index = summary["runtime"], summary["index"]
    st_ = summary["stats"]
    lat = np.asarray(summary["latencies_s"], dtype=np.float64)
    res = list(rt.results.values())
    rider_cells = sum(r.rounds for r in res)
    dstats = st_["durability"]
    n_queries, query_s = summary["n_queries"], summary["query_s"]
    stall_s = summary["query_maintenance_s"]
    durability_s = dstats["wal_append_s"] + dstats["checkpoint_s"]
    out.update(
        months=len(summary["recalls"]), queries=n_queries,
        recall_per_month=summary["recalls"],
        recall=float(np.mean(summary["recalls"])),
        p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_latency_ms=float(np.percentile(lat, 99)) * 1e3,
        serve_s=summary["serve_s"], query_s=query_s,
        qps=n_queries / query_s,
        query_maintenance_s=stall_s,
        search_s=query_s - stall_s,
        search_qps=n_queries / (query_s - stall_s),
        rounds=st_["rounds_run"], admitted_batches=st_["admitted_batches"],
        riders_per_round=rider_cells / max(st_["rounds_run"], 1),
        partitions_streamed=st_["partitions_streamed"],
        riding_savings=st_["riding_savings"],
        cache_hits=st_["cache_hits"],
        cache_hit_rate=st_["cache_hits"] / max(st_["queries_submitted"], 1),
        maintenance_passes=st_["maintenance_runs"],
        maintenance_reasons=st_["maintenance_reasons"],
        maintenance_s=rt.maintenance.snapshot()["pass_s"],
        maintenance_history=rt.maintenance.snapshot()["history"],
        partitions=index.num_partitions, vectors=index.num_vectors,
        wal_bytes=dstats["wal_bytes_written"],
        wal_appends=dstats["wal_appends"],
        checkpoints=dstats["checkpoints_written"],
        partitions_written=dstats["partitions_written"],
        partitions_linked=dstats["partitions_linked"],
        wal_s=dstats["wal_append_s"], checkpoint_s=dstats["checkpoint_s"],
        attach_s=dstats["attach_s"], durability_s=durability_s,
        durability_overhead=durability_s / summary["serve_s"],
        status_counts=st_["status_counts"], scan_faults=st_["scan_faults"],
        host_rounds=host_rounds[0], insert_kmeans_launches=insert_kmeans,
        calibration=summary.get("calibration"))
    print(f"serving [{card}]: {out['queries']} queries over {out['months']} "
          f"months, {out['vectors']} vectors in {out['partitions']} "
          f"partitions at the end; replay {out['replay_s']:.1f} s, peak "
          f"device memory {out['replay_peak_gb']:.2f} GB")
    print(f"serving [{card}]: recall@{k} per month "
          + " ".join(f"{r:.4f}" for r in out["recall_per_month"])
          + f"; overall {out['recall']!r}")
    per_month = lat[:len(lat) // out["months"] * out["months"]].reshape(
        out["months"], -1) * 1e3
    out["latency_ms_per_month"] = [
        {"p50": float(np.percentile(m, 50)), "p99": float(np.percentile(m, 99)),
         "max": float(m.max())} for m in per_month]
    print(f"serving [{card}]: submit-to-result latency p50 "
          f"{out['p50_latency_ms']!r} ms, p99 {out['p99_latency_ms']!r} ms; "
          f"per month p50/p99/max ms "
          + " ".join(f"{m['p50']:.1f}/{m['p99']:.1f}/{m['max']:.1f}"
                     for m in out["latency_ms_per_month"]))
    print(f"serving [{card}]: end to end {out['qps']!r} queries/s (all "
          f"{n_queries} queries over the {query_s!r} s of query ops, the "
          f"maintenance and checkpoints inside them included; "
          f"{out['serve_s']!r} s with writes); per layer, the query ops "
          f"without the {stall_s!r} s of maintenance passes and "
          f"checkpoints that ran inside them: {out['search_qps']!r} "
          f"queries/s over {out['search_s']!r} s")
    print(f"serving [{card}]: {out['rounds']} rounds for "
          f"{out['admitted_batches']} admitted batches, "
          f"{out['riders_per_round']!r} riders a round, riding savings "
          f"{out['riding_savings']!r}; cache hits {out['cache_hits']} "
          f"(rate {out['cache_hit_rate']!r})")
    print(f"serving [{card}]: {out['maintenance_passes']} maintenance passes "
          f"({', '.join(out['maintenance_reasons']) or 'none'}), seconds "
          + " ".join(f"{s:.3f}" for s in out["maintenance_s"]))
    print(f"serving [{card}]: WAL {out['wal_bytes']} bytes in "
          f"{out['wal_appends']} appends, {out['checkpoints']} checkpoints "
          f"({out['partitions_written']} partitions written, "
          f"{out['partitions_linked']} linked); durability "
          f"{out['durability_s']!r} s (WAL appends {out['wal_s']!r}, "
          f"checkpoints {out['checkpoint_s']!r}) = "
          f"{out['durability_overhead']!r} of the serve time; the "
          f"attach's baseline checkpoint {out['attach_s']!r} s before it")
    print(f"serving [{card}]: statuses {out['status_counts']}, scan faults "
          f"{out['scan_faults']}, host rounds {out['host_rounds']}, "
          f"kmeans_assign launches per insert burst "
          f"{out['insert_kmeans_launches']}")
    for name in ("scan_topk_indexed", "scan_topk", "kmeans_assign"):
        if out["launches"][name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    n_sub = st_["queries_submitted"]
    if sum(st_["status_counts"].values()) != n_sub or \
            len(rt.results) != n_sub:
        fail(f"serving: {len(rt.results)} results and "
             f"{sum(st_['status_counts'].values())} terminal statuses for "
             f"{n_sub} queries")
    if st_["status_counts"]["OK"] != n_sub or st_["scan_faults"]:
        fail(f"serving: statuses {st_['status_counts']}, scan faults "
             f"{st_['scan_faults']} with no injector set")
    if rt.scheduler.scan_backend != "device" or host_rounds[0]:
        fail(f"serving: backend {rt.scheduler.scan_backend}, "
             f"{host_rounds[0]} rounds on the host")
    if out["launches"]["scan_topk_indexed"] < st_["rounds_run"] or \
            not st_["rounds_run"]:
        fail(f"serving: {out['launches']['scan_topk_indexed']} indexed-scan "
             f"launches for {st_['rounds_run']} device rounds")
    n_inserts = sum(op.kind == "insert" for op in wl.operations)
    if len(insert_kmeans) != n_inserts or min(insert_kmeans, default=0) < 1:
        fail(f"serving: kmeans_assign launches per insert burst "
             f"{insert_kmeans} for {n_inserts} bursts")

    # the assignment of the largest insert burst, against its plain version
    if "args" not in burst:
        fail("serving: no insert burst's assignment was captured")
    xs_b, c_b, aux_b = burst.pop("args")
    err, tol, _ = hold_assign(
        ka, f"kmeans_assign at the largest serving insert burst (N "
        f"{xs_b.shape[0]}, C {c_b.shape[0]})", xs_b, c_b, aux_b)
    checks["kmeans_assign"] = {"max_abs_err": err, "tol": tol, "shape": {
        "N": int(xs_b.shape[0]), "C": int(c_b.shape[0]),
        "d": int(xs_b.shape[1])}}
    print(f"kmeans_assign at the largest serving insert burst: err "
          f"{err:.3g} (tol {tol:.3g})")
    del xs_b, c_b, aux_b

    # the queries admitted after the last write, replayed single-threaded
    # from the admission log through both backends; qid i is the i-th
    # query submitted, so the workload's query ops give each qid's vector
    allq = np.concatenate([op.queries for op in wl.operations
                           if op.kind == "query"]).astype(np.float32)
    if len(allq) != n_sub:
        fail(f"serving: {len(allq)} workload queries, {n_sub} submitted")
    log = rt.admission_log()
    last = max(i for i, e in enumerate(log) if e[0] != "q") \
        if any(e[0] != "q" for e in log) else -1
    groups_q = [list(e[1]) for e in log[last + 1:] if e[0] == "q"]
    order = [qid for g in groups_q for qid in g]
    qs = allq[order]
    pos = {qid: i for i, qid in enumerate(order)}
    groups = [[pos[qid] for qid in g] for g in groups_q]
    # the device leg's rounds and centroid passes are captured and held
    # against the plain versions while its snapshot is still alive
    f32_calls, dense = [], {}
    real_dense = st.scan_topk

    def captured_dense(queries, xs, valid=None, **kw):
        size = int(queries.shape[0]) * int(xs.shape[0])
        if size > dense.get("size", 0):
            dense.update(size=size, kw=dict(kw), args=(
                queries.clone(), xs.clone(),
                None if valid is None else valid.clone()))
        return real_dense(queries, xs, valid, **kw)

    def hold_device_rounds():
        gc.collect()          # the plain versions need the cached blocks
        torch.cuda.empty_cache()
        checks["scan_topk_indexed"] = hold_rounds(
            "scan_topk_indexed", f32_calls, sti.scan_topk_indexed_plain,
            exact=False)
        f32_calls.clear()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with patched((sti, "scan_topk_indexed", capture_rounds(
            sti.scan_topk_indexed, f32_calls, 1, {1, 2},
            SERVE_CHECK_ROUNDS)), (st, "scan_topk", captured_dense)):
        agree = serving_agreement(index, qs, groups, k,
                                  after_device=hold_device_rounds)
    out["agreement_s"] = time.perf_counter() - t
    if "args" not in dense:
        fail("serving: no centroid pass was captured")
    dq, dx, dv = dense.pop("args")
    dk, ik = st.scan_topk_cuda(dq, dx, dv, **dense["kw"])
    dp, ip_ = st.scan_topk_plain(dq, dx, dv, **dense["kw"])
    err, tol = compare_topk(
        f"scan_topk at the largest serving centroid pass (Q {dq.shape[0]}, "
        f"N {dx.shape[0]}, k_pad {dense['kw']['k_pad']})", dk, ik, dp, ip_)
    checks["scan_topk"] = {"max_abs_err": err, "tol": tol, "shape": {
        "Q": int(dq.shape[0]), "N": int(dx.shape[0]), "d": int(dx.shape[1]),
        "k_pad": dense["kw"]["k_pad"]}}
    del dq, dx, dv, dk, ik, dp, ip_
    (res_d, rounds_d, launch_d), (res_h, _, launch_h) = \
        agree["device"], agree["host"]
    strict = ties = 0
    for i, (a, b) in enumerate(zip(res_d, res_h)):
        if a.status != "OK" or b.status != "OK" or a.nprobe != b.nprobe:
            fail(f"serving agreement: query {i} statuses {a.status}/"
                 f"{b.status}, nprobe {a.nprobe}/{b.nprobe}")
        sa, sb = set(a.ids.tolist()), set(b.ids.tolist())
        if sa == sb:
            continue
        strict += 1
        # the k-th distance: the worst exact distance of either list
        kth = max(float(exact_ip(index, qs[i], a.ids).max()),
                  float(exact_ip(index, qs[i], b.ids).max()))
        tol = 2 * (SERVE_TIE_REL * abs(kth) + SERVE_TIE_ABS)
        diff = sorted(sa ^ sb)
        ed = exact_ip(index, qs[i], diff)
        if (np.abs(ed - kth) > tol).any():
            fail(f"serving agreement: query {i}: ids {sorted(sa ^ sb)} "
                 f"differ away from the k-th distance {kth!r} "
                 f"(exact {ed.tolist()})")
        ties += 1
    if launch_d < rounds_d or launch_h:
        fail(f"serving agreement: device launches {launch_d} for "
             f"{rounds_d} rounds, host launches {launch_h}")
    out["agreement"] = {"queries": len(order), "groups": len(groups),
                        "differing_sets": strict, "at_near_ties": ties}
    print(f"serving [{card}]: the {len(order)} queries after the last "
          f"write, in "
          f"{len(groups)} admission groups replayed through both backends: "
          f"{strict} id sets differ, all at near-ties of the k-th "
          f"distance ({out['agreement_s']:.1f} s)")

    # one warm flush under torch.profiler: the device's idle share
    prof_rt = ServingRuntime(index, ServingConfig(
        k=k, recall_target=SERVE_TARGET, flush_size=10 ** 9, ticker=False,
        planner=SERVE_PLANNER, record_stats=False, maint_min_ops=10 ** 9,
        maint_max_ops=None))
    q256 = qs[:256]

    def one_flush():
        prof_rt.submit_batch(q256)
        prof_rt.drain()
    out["profile_flush"] = profile_call(one_flush, "serving_flush")
    prof_rt.close()

    # those queries at int8 storage: the q8 kernel serves the rounds
    start_path()
    rt8 = ServingRuntime(index, ServingConfig(
        k=k, recall_target=SERVE_TARGET, flush_size=256, ticker=False,
        storage_dtype="int8", planner=SERVE_PLANNER, record_stats=False,
        maint_min_ops=10 ** 9, maint_max_ops=None))
    q8_calls = []
    t = time.perf_counter()
    with patched((sti, "scan_topk_indexed_q8", capture_rounds(
            sti.scan_topk_indexed_q8, q8_calls, 2, {2, 3, 6},
            SERVE_CHECK_ROUNDS))):
        qids = rt8.submit_batch(qs)
        rt8.drain()
    out["int8_s"] = time.perf_counter() - t
    st8 = rt8.stats()
    res8 = [rt8.result(i) for i in qids]
    out["int8_launches"] = end_path("serving_int8", ("scan_topk_indexed_q8",))
    checks["scan_topk_indexed_q8"] = hold_rounds(
        "scan_topk_indexed_q8", q8_calls, sti.scan_topk_indexed_q8_plain,
        exact=True)
    del q8_calls
    rt8.close()
    torch.cuda.empty_cache()
    ov = overlap(np.stack([r.ids for r in res8]),
                 np.stack([r.ids for r in res_d]))
    out["int8"] = {"rounds": st8["rounds_run"], "overlap_f32": ov,
                   "statuses": st8["status_counts"]}
    print(f"serving [{card}]: int8: {len(qids)} queries, "
          f"{st8['rounds_run']} rounds, "
          f"{out['int8_launches']['scan_topk_indexed_q8']} q8 launches, ids "
          f"overlap the f32 backend's by {ov!r} ({out['int8_s']:.1f} s)")
    if out["int8_launches"]["scan_topk_indexed_q8"] < st8["rounds_run"] \
            or not st8["rounds_run"]:
        fail("serving: int8 storage did not launch the q8 kernel each "
             "round")
    if st8["status_counts"]["OK"] != len(qids):
        fail(f"serving: int8 statuses {st8['status_counts']}")
    if ov < INT8_OVERLAP:
        fail(f"serving: int8 overlaps f32 by {ov:.4f} < {INT8_OVERLAP}")

    # one more insert burst after the last checkpoint (the served run's
    # last maintenance pass checkpointed after its last insert): fresh
    # ids, rows of the data with seeded noise, through a runtime
    # re-attached to the WAL directory (its attach writes a baseline
    # checkpoint); then recovery on the card must replay that insert
    # from the WAL and land on the live fingerprint
    rng = np.random.default_rng(args.seed + 7)
    data = wl.dataset.vectors
    n_new = args.insert
    new_x = (data[rng.integers(0, len(data), n_new)]
             + 0.01 * rng.standard_normal((n_new, data.shape[1]))
             ).astype(np.float32)
    new_ids = np.arange(len(data), len(data) + n_new, dtype=np.int64)
    rt_w = ServingRuntime(index, ServingConfig(
        k=k, ticker=False, wal_dir=wal, fsync="batch", record_stats=False,
        metrics=False, maint_min_ops=10 ** 9, maint_max_ops=None))
    rt_w.submit_insert(new_x, new_ids)
    rt_w.close()
    live = index_state_fingerprint(index)
    t = time.perf_counter()
    rt2 = ServingRuntime.recover(wal, ServingConfig(k=k, ticker=False),
                                 device=dev)
    out["recovery_s"] = time.perf_counter() - t
    rep = rt2.recovery_report
    out["recovery"] = dataclasses.asdict(rep)
    got = index_state_fingerprint(rt2.index)
    n_rec = rt2.index.num_vectors
    rt2.close()
    del rt2
    print(f"serving [{card}]: recovered generation {rep.generation} + "
          f"{rep.records_replayed} WAL records ({rep.inserts_replayed} "
          f"inserts, {n_new} vectors) to {n_rec} vectors in "
          f"{out['recovery_s']!r} s (with the re-attach's baseline "
          f"checkpoint); fingerprint "
          f"{'equals' if got == live else 'DIFFERS FROM'} the live one")
    if rep.inserts_replayed < 1:
        fail("serving: the recovery replayed no insert from the WAL")
    if got != live:
        fail("serving: the recovered index's fingerprint differs from the "
             "live index's")
    shutil.rmtree(wal, ignore_errors=True)
    return out


def hold_assign(ka, name, xs, cents, aux, tol=(TOL_REL, TOL_ABS)):
    """Hold ``kmeans_assign`` against its plain version on (xs, cents,
    aux): every minimum within ``tol[0] * |d| + tol[1]``, and the same
    centroid wherever the two nearest lie more than twice that apart.
    Returns (largest |diff|, largest tolerance, the plain assignment)."""
    import torch
    ak, dk = ka.kmeans_assign_cuda(xs, cents, aux)
    ap, dp = ka.kmeans_assign_plain(xs, cents, aux)
    tol_x = tol[0] * dp.abs() + tol[1]
    err, tol = float((dk - dp).abs().max()), float(tol_x.max())
    if bool(((dk - dp).abs() > tol_x).any()):
        fail(f"{name}: minima beyond their tolerance, max |diff| {err:.3g}")
    if cents.shape[0] > 1:
        dist = aux[None] - 2.0 * (xs @ cents.T)
        two = torch.topk(dist, 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 2 * tol_x
        if bool(((ak != ap) & clear).any()):
            fail(f"{name}: assignments differ away from ties")
    return err, tol, ap


def check_close(name, got, ref, rel, abs_):
    """Fail unless every entry of ``got`` is within ``rel * |ref| + abs_``
    of ``ref`` (and finite); returns the largest |diff|."""
    import torch
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    diff = (got - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    over = diff > rel * ref.abs() + abs_
    if bool(over.any()):
        fail(f"{name}: {int(over.sum())} of {diff.numel()} entries beyond "
             f"{rel:g}*|x| + {abs_:g}, max |diff| {err:.3g}")
    print(f"{name}: max |diff| {err:.3g} (bound {rel:g}*|x| + {abs_:g})")
    return err


def run_lm(args, dev, start_path, end_path):
    """The LM serving path: exact f32 checks at full width and two layers
    (kernel against plain attention, decode against re-prefill), then the
    served model at full width and depth in bf16 (prefill of the prompts,
    greedy decode, launch gates, a re-prefill check, the flash kernel's
    share of a warm prefill), then the kernel against its plain version
    at the captured and the JAX tests' shapes, and its time at one
    LM_TIME_LEN-token request.  Returns (record, kernels-line row)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.nn import functional as F
    from repro_torch.configs import lm_archs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Transformer, param_count
    torch.cuda.reset_peak_memory_stats()
    out = {}
    base = getattr(lm_archs, LM_CONFIG)()
    h, kh, dh, vocab = (base.n_heads, base.n_kv_heads, base.head_dim,
                        base.vocab_size)

    def plain_attention(q, k, v, *, causal, q_block, k_block):
        qb, kb = fa.TILES[q.dtype]
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        q_block=qb, k_block=kb)

    # -- exact f32 checks: full width, two layers -------------------------
    cfg32 = dataclasses.replace(base, n_layers=2, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    m32 = Transformer(cfg32, device=dev, generator=g)
    s32, steps32 = 512, 4
    toks = torch.randint(0, vocab, (2, s32 + steps32), generator=g,
                         device=dev)
    lg_k, (ck, cv) = m32.prefill(toks[:, :s32])
    before = fa.LAUNCHES.count
    lg_p, _ = m32.prefill(toks[:, :s32], attention=plain_attention)
    if fa.LAUNCHES.count != before:
        fail(f"lm f32 prefill with plain attention launched the flash "
             f"kernel {fa.LAUNCHES.count - before} times")
    errs = {"f32_prefill_kernel_vs_plain": check_close(
        "lm f32 prefill logits, kernel vs plain attention", lg_k, lg_p,
        LM_TOL, LM_TOL)}
    pad = (0, 0, 0, 0, 0, steps32)
    ck, cv = F.pad(ck, pad), F.pad(cv, pad)
    for t in range(s32, s32 + steps32):
        lg_d, (ck, cv) = m32.decode_step(
            toks[:, t], ck, cv, torch.full((2,), t, device=dev))
        lg_r, _ = m32.prefill(toks[:, :t + 1])
        errs[f"f32_decode_vs_reprefill@{t}"] = check_close(
            f"lm f32 decode at position {t} vs re-prefill", lg_d, lg_r,
            LM_TOL, LM_TOL)
    out["f32_checks"] = errs
    del m32, ck, cv, lg_k, lg_p, lg_d, lg_r
    torch.cuda.empty_cache()

    # -- serving at full width and depth, bf16 ----------------------------
    cfg = dataclasses.replace(base, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    n_l, b, s, n_dec = cfg.n_layers, LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE
    start_path()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = Transformer(cfg, device=dev, generator=g)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    print(f"lm: {LM_CONFIG} at {n_l} layers, d_model {cfg.d_model}, "
          f"{h}/{kh} heads of {dh}, bf16: {param_count(cfg)} parameters, "
          f"{weight_gb:.2f} GB, built in {out['build_s']:.2f} s")
    prompts = torch.randint(0, vocab, (b, s), generator=g, device=dev)
    captured, calls = {}, [0]

    def capture(q, k, v, **kw):
        if calls[0] in (0, n_l - 1):
            captured[calls[0]] = (q.clone(), k.clone(), v.clone())
        calls[0] += 1
        return fa.flash_attention(q, k, v, **kw)

    before = fa.LAUNCHES.count
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, (ck, cv) = model.prefill(prompts, attention=capture)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t
    prefill_launches = fa.LAUNCHES.count - before
    if tuple(logits.shape) != (b, vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"lm prefill: logits of shape {tuple(logits.shape)} or not "
             f"finite")
    shape = (n_l, b, s + n_dec, kh, dh)
    ckp = torch.zeros(shape, dtype=ck.dtype, device=dev)
    cvp = torch.zeros(shape, dtype=cv.dtype, device=dev)
    ckp[:, :, :s], cvp[:, :, :s] = ck, cv
    del ck, cv
    out["cache_gb"] = 2 * ckp.numel() * ckp.element_size() / 1e9
    tok = logits.argmax(-1)
    gen, step_ms, dec_launches = [tok], [], []
    cache_len = torch.full((b,), s, device=dev)
    for i in range(n_dec):
        before = fa.LAUNCHES.count
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, _ = model.decode_step(tok, ckp, cvp, cache_len)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        dec_launches.append(fa.LAUNCHES.count - before)
        if not bool(torch.isfinite(lg).all()):
            fail(f"lm decode step {i + 1}: non-finite logits")
        if i == 7:
            lg8 = lg.clone()
        tok = lg.argmax(-1)
        gen.append(tok)
        cache_len += 1
    got = end_path("lm", ("flash_attention",))
    warm = step_ms[2:] or step_ms
    out.update(prefill_launches=prefill_launches,
               decode_launches=dec_launches, decode_ms=step_ms,
               decode_ms_mean=float(np.mean(warm)),
               decode_ms_worst=float(np.max(warm)))
    print(f"lm prefill of {b} x {s} tokens: {out['prefill_s']:.3f} s "
          f"(first call), {prefill_launches} flash launches; decode "
          f"{n_dec} steps: {out['decode_ms_mean']:.2f} ms a step (mean "
          f"after 2 warm-up steps), worst {out['decode_ms_worst']:.2f} ms, "
          f"flash launches per step {sorted(set(dec_launches))}")
    if prefill_launches != n_l or got["flash_attention"] != n_l:
        fail(f"lm: {prefill_launches} flash launches in the prefill, "
             f"{got['flash_attention']} on the path, not {n_l}")
    if any(dec_launches):
        fail("lm: a decode step launched the flash kernel")

    torch.cuda.synchronize()
    t = time.perf_counter()
    model.prefill(prompts)
    torch.cuda.synchronize()
    out["prefill_warm_s"] = time.perf_counter() - t
    out["prefill_tokens_per_s"] = b * s / out["prefill_warm_s"]
    print(f"lm warm prefill: {out['prefill_warm_s']:.3f} s, "
          f"{out['prefill_tokens_per_s']:.0f} tokens/s")
    prof = profile_call(lambda: model.prefill(prompts), "prefill",
                          "flash_fwd_bf16_mma_kernel")
    if prof["device_busy_ms"]:
        prof["flash_share"] = prof["match_ms"] / prof["device_busy_ms"]
        print(f"lm: the flash kernel takes {prof['match_ms']:.1f} ms of "
              f"the warm prefill's {prof['device_busy_ms']:.1f} ms of "
              f"device time ({prof['flash_share']:.1%})")
    out["profile"] = prof

    # one more step, rewriting the last position: where a step's time goes
    out["decode_profile"] = profile_call(
        lambda: model.decode_step(tok, ckp, cvp, cache_len - 1),
        "decode_step")

    if n_dec >= 8:   # decode step 8 against a prefill over prompt + g1..g8
        lg_re, _ = model.prefill(torch.cat([prompts, torch.stack(gen[:8],
                                                                 1)], 1))
        out["reprefill_check"] = {
            "cosine_min": float(F.cosine_similarity(lg_re, lg8, -1).min()),
            "max_abs_diff": float((lg_re - lg8).abs().max()),
            "top1_agree": float((lg_re.argmax(-1) == lg8.argmax(-1))
                                .float().mean())}
        print(f"lm bf16 decode step 8 vs re-prefill (ungated): "
              f"{out['reprefill_check']}")
    out["peak_gb_serving"] = torch.cuda.max_memory_allocated() / 1e9
    del model, ckp, cvp
    torch.cuda.empty_cache()

    # -- the kernel against its plain version ------------------------------
    errs = {}
    bq, bk = fa.TILES[torch.bfloat16]
    for layer, (q, k, v) in sorted(captured.items()):
        o_k = fa.flash_attention_cuda(q, k, v, causal=True)
        o_p, plain_ms = timed(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, q_block=bq, k_block=bk))
        errs[f"bf16_layer{layer}"] = check_close(
            f"flash_attention bf16, layer {layer}'s operands", o_k, o_p,
            FLASH_BF16_REL, FLASH_BF16_ABS)
        if layer == 0:
            layer0_plain_ms = plain_ms
    q, k, v = captured[0]
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                 reps=5, warmup=1)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), reps=5, warmup=1)
    bound_ms, bound_by = fa.flash_bound(b, s, s, h, kh, dh, True, 2)
    gs = torch.Generator(device=dev).manual_seed(args.seed + 2)
    fq, fk = fa.TILES[torch.float32]
    for (bb, hh, kk, sq, sk, d, causal) in [
            (2, 8, 1, 96, 96, 32, True), (1, 8, 2, 128, 128, 64, True),
            (2, 4, 4, 100, 120, 32, False), (1, 6, 2, 64, 256, 16, True)]:
        qs = torch.randn((bb, sq, hh, d), generator=gs, device=dev)
        ks = torch.randn((bb, sk, kk, d), generator=gs, device=dev)
        vs = torch.randn((bb, sk, kk, d), generator=gs, device=dev)
        errs[f"f32_{bb}x{sq}x{sk}x{hh}/{kk}x{d}_{causal}"] = check_close(
            f"flash_attention f32 {(bb, hh, kk, sq, sk, d, causal)}",
            fa.flash_attention_cuda(qs, ks, vs, causal=causal),
            fa.flash_attention_plain(qs, ks, vs, causal=causal,
                                     q_block=fq, k_block=fk),
            FLASH_F32_TOL, FLASH_F32_TOL)
    # the f32 kernel (CUDA cores) at the exact checks' served shape: one
    # layer's operands of the f32 prefill, 2 x 512 tokens at full width
    q32, k32, v32 = (torch.randn((2, 512, n, dh), generator=gs, device=dev)
                     for n in (h, kh, kh))
    f32_ms = cuda_ms(lambda: fa.flash_attention_cuda(q32, k32, v32,
                                                     causal=True))
    f32_bound, f32_by = fa.flash_bound(2, 512, 512, h, kh, dh, True, 4)
    views32 = [x.transpose(1, 2) for x in (q32, k32, v32)]
    f32_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views32, is_causal=True, enable_gqa=True))
    f32_row = {"shape": {"B": 2, "S": 512, "H": h, "KH": kh, "D": dh},
               "ms": f32_ms, "bound_ms": f32_bound, "bound_by": f32_by,
               "library_ms": f32_lib_ms}
    print(f"flash_attention f32 kernel: {f32_ms:.4f} ms at "
          f"{(2, 512, h, kh, dh)} (library {f32_lib_ms:.4f} ms, bound "
          f"{f32_bound:.4f} ms)")
    del captured, q, k, v, views, q32, k32, v32, views32
    torch.cuda.empty_cache()

    # -- one request at LM_TIME_LEN tokens, one layer ----------------------
    n = LM_TIME_LEN
    q = torch.randn((1, n, h, dh), generator=gs, device=dev).bfloat16()
    k = torch.randn((1, n, kh, dh), generator=gs, device=dev).bfloat16()
    v = torch.randn((1, n, kh, dh), generator=gs, device=dev).bfloat16()
    long_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                      reps=3, warmup=1)
    o_k = fa.flash_attention_cuda(q, k, v, causal=True)
    o_p, long_plain_ms = timed(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, q_block=bq, k_block=bk))
    long_err = check_close(f"flash_attention bf16 at 1 x {n} tokens", o_k,
                           o_p, FLASH_BF16_REL, FLASH_BF16_ABS)
    del o_k, o_p
    views = [x.transpose(1, 2) for x in (q, k, v)]
    long_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), reps=3, warmup=1)
    long_bound, long_by = fa.flash_bound(1, n, n, h, kh, dh, True, 2)
    long = {"shape": {"B": 1, "S": n, "H": h, "KH": kh, "D": dh},
            "ms": long_ms, "plain_ms": long_plain_ms,
            "library_ms": long_lib_ms, "bound_ms": long_bound,
            "bound_by": long_by, "max_abs_err": long_err}
    print(f"flash_attention: {ms:.3f} ms at {(b, s, h, kh, dh)} (plain "
          f"{layer0_plain_ms:.1f}, library {lib_ms:.3f}, bound "
          f"{bound_ms:.3f} ms by {bound_by}); {long_ms:.3f} ms at "
          f"{(1, n, h, kh, dh)} (plain {long_plain_ms:.1f}, library "
          f"{long_lib_ms:.3f}, bound {long_bound:.3f} ms)")
    del q, k, v, views
    torch.cuda.empty_cache()
    out.update(checks=errs, at_time_len=long,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"lm path: peak device memory {out['peak_gb']:.2f} GB "
          f"(serving {out['peak_gb_serving']:.2f} GB)")
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": got["flash_attention"],
        "max_abs_err": max(errs[f"bf16_layer{i}"] for i in (0, n_l - 1)),
        "tol": f"{FLASH_BF16_REL:g}*|o| + {FLASH_BF16_ABS:g}",
        "ms": ms, "plain_ms": layer0_plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention(is_causal, enable_gqa)",
        "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": dh},
        "at_time_len": long, "f32": f32_row}
    return out, row


# ---------------------------------------------------------------------------
# path 7: recsys serving, and two-tower retrieval through Quake
# ---------------------------------------------------------------------------

def recsys_pipeline(cfg, batch: int, step: int, seed: int):
    """A ``RecsysPipeline`` batch in the model's vocabulary (the smaller
    of the two-tower's two) and history length, as numpy."""
    from repro_torch.data import RecsysPipeline
    from repro_torch.models.recsys import history_len
    vocab = getattr(cfg, "vocab", None) or min(cfg.user_vocab,
                                               cfg.item_vocab)
    return RecsysPipeline(batch=batch, vocab=vocab, hist_len=history_len(cfg),
                          seed=seed).batch_at(step)


def recsys_user(batch, dev):
    """The first row of a batch as a ``retrieval_cand`` user context."""
    import torch
    return {k: torch.as_tensor(batch[k][:1], device=dev)
            for k in ("history", "history_mask", "dense")}


def check_finite(name, x, shape):
    import torch
    if tuple(x.shape) != tuple(shape):
        fail(f"{name}: shape {tuple(x.shape)}, not {tuple(shape)}")
    if not bool(torch.isfinite(x).all()):
        fail(f"{name}: {int((~torch.isfinite(x)).sum())} non-finite values")


def wall_ms(fn, reps: int):
    """Median and largest host-clock ms of ``reps`` warm calls of ``fn``,
    each ended by a synchronize (after two warm-up calls)."""
    import statistics
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), max(times)


def recsys_card_vs_cpu(dev, seed) -> dict:
    """Each smoke config with the same weights on the card and the CPU:
    the model's forward, its serve output and its retrieval (chunked on
    the card too) on the pipeline's batches, within RECSYS_TOL * |x| +
    RECSYS_TOL; then the serve batch with ids out of range both ways,
    NaN exactly where the CPU has NaN."""
    import torch
    from repro_torch.configs import recsys_archs
    from repro_torch.models import recsys as rs
    shapes = recsys_archs.RECSYS_SMOKE_SHAPES
    out = {}
    for name in RECSYS_ARCHS:
        cfg = recsys_archs.ARCHS[name][1]()
        cpu = rs.MODELS[name][1](cfg, device="cpu", generator=torch.Generator(
            ).manual_seed(seed))
        card = rs.MODELS[name][1](cfg, device=dev, init=False)
        card.load_state_dict(cpu.state_dict())
        np_b = recsys_pipeline(cfg, shapes["serve_bulk"]["batch"], 0, seed)
        n_cand = shapes["retrieval_cand"]["n_cand"]
        vocab = getattr(cfg, "vocab", None) or cfg.item_vocab
        cand = torch.randperm(vocab, generator=torch.Generator().manual_seed(
            seed))[:n_cand].to(torch.int32)
        bc, bd = rs.batch_to(np_b, "cpu"), rs.batch_to(np_b, dev)
        uc, ud = recsys_user(np_b, "cpu"), recsys_user(np_b, dev)
        fwd = {"din": rs.din_forward, "dlrm-rm2": rs.dlrm_forward,
               "sasrec": lambda m, b: rs.sasrec_encode(
                   m, b["history"], b["history_mask"]),
               "two-tower-retrieval": lambda m, b: torch.cat([
                   rs.user_repr(m, b), rs.item_repr(m, b["target_item"])])}
        pairs = {
            "forward": (fwd[name](card, bd), fwd[name](cpu, bc)),
            "serve": (rs.recsys_serve(card, bd), rs.recsys_serve(cpu, bc)),
            "retrieval": (rs.recsys_retrieval(card, ud, cand.to(dev)),
                          rs.recsys_retrieval(cpu, uc, cand)),
            "retrieval_chunked": (rs.recsys_retrieval(
                card, ud, cand.to(dev), chunk=n_cand // 4 + 1),
                rs.recsys_retrieval(cpu, uc, cand))}
        errs = {what: check_close(f"recsys {name} smoke {what}, card vs CPU",
                                  got.cpu(), want, RECSYS_TOL, RECSYS_TOL)
                for what, (got, want) in pairs.items()}
        bad = {k: v.copy() for k, v in np_b.items()}
        bad["history"][0, 0], bad["history"][1, 0] = vocab + 7, -1
        bad["target_item"][2], bad["sparse"][3, 0] = 10 ** 9, -vocab - 1
        got = rs.recsys_serve(card, rs.batch_to(bad, dev)).cpu()
        want = rs.recsys_serve(cpu, rs.batch_to(bad, "cpu"))
        nan = torch.isnan(want)
        if not bool(nan.any()) or not torch.equal(torch.isnan(got), nan):
            fail(f"recsys {name}: out-of-range ids give NaN at "
                 f"{torch.nonzero(torch.isnan(got)).flatten().tolist()} on "
                 f"the card, {torch.nonzero(nan).flatten().tolist()} on "
                 f"the CPU")
        errs["out_of_range"] = check_close(
            f"recsys {name} smoke, out-of-range ids (finite rows)",
            got[~nan], want[~nan], RECSYS_TOL, RECSYS_TOL)
        errs["nan_rows"] = int(nan.sum())
        out[name] = errs
        del cpu, card
    return out


def recsys_serve_model(name, cfg, model, dev, seed, shapes) -> dict:
    """``serve_p99`` and ``serve_bulk`` on pipeline batches and
    ``retrieval_cand`` for the p99 batch's first user against
    ``n_cand`` distinct candidates, RECSYS_CHUNK rows at a time: shapes
    and finite outputs gated, warm times printed."""
    import torch
    from repro_torch.models import recsys as rs
    card = card_line()
    out = {}
    b99, bulk = shapes["serve_p99"]["batch"], shapes["serve_bulk"]["batch"]
    n_cand = shapes["retrieval_cand"]["n_cand"]
    t = time.perf_counter()
    np99 = recsys_pipeline(cfg, b99, 0, seed)
    np_bulk = recsys_pipeline(cfg, bulk, 1, seed)
    out["batches_s"] = time.perf_counter() - t
    p99 = rs.batch_to(np99, dev)
    y = rs.recsys_serve(model, p99)
    check_finite(f"recsys {name} serve_p99", y, (b99,))
    out["p99_ms"], out["p99_ms_max"] = wall_ms(
        lambda: rs.recsys_serve(model, p99), 10)
    tb = rs.batch_to(np_bulk, dev)
    y = rs.recsys_serve(model, tb, chunk=RECSYS_CHUNK)
    check_finite(f"recsys {name} serve_bulk", y, (bulk,))
    torch.cuda.synchronize()
    t = time.perf_counter()
    rs.recsys_serve(model, tb, chunk=RECSYS_CHUNK)
    torch.cuda.synchronize()
    out["bulk_s"] = time.perf_counter() - t
    out["bulk_rows_per_s"] = bulk / out["bulk_s"]
    del tb, y
    vocab = getattr(cfg, "vocab", None) or cfg.item_vocab
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cand = torch.randperm(vocab, generator=g, device=dev)[:n_cand]
    user = recsys_user(np99, dev)
    y = rs.recsys_retrieval(model, user, cand, chunk=RECSYS_CHUNK)
    check_finite(f"recsys {name} retrieval_cand", y, (n_cand,))
    torch.cuda.synchronize()
    t = time.perf_counter()
    rs.recsys_retrieval(model, user, cand, chunk=RECSYS_CHUNK)
    torch.cuda.synchronize()
    out["retrieval_ms"] = (time.perf_counter() - t) * 1e3
    print(f"recsys [{card}]: {name} serve_p99 (B {b99}) {out['p99_ms']!r} "
          f"ms a warm call (median of 10, max {out['p99_ms_max']!r}); "
          f"serve_bulk (B {bulk}) {out['bulk_rows_per_s']!r} rows/s "
          f"({out['bulk_s']!r} s); retrieval_cand (1 x {n_cand}) "
          f"{out['retrieval_ms']!r} ms; batches drawn on the host in "
          f"{out['batches_s']:.2f} s")
    return out, cand, user


def recsys_quake(cfg, model, cand, user, dev, seed):
    """Two-tower retrieval through Quake (examples/retrieval_serving.py's
    flow in the port's entry points): encode the candidates and
    RECSYS_USERS users, the exact top-k by ``retrieval_scores`` and
    ``torch.topk``, the same through the dense kernel, then a
    ``QuakeIndex(metric="ip")`` of RECSYS_P partitions on the card:
    ``search_batch`` probing every partition, APS at target 0.9 (the
    fused planner: its centroid pass on the card) in f32 and int8, the
    ``retrieval_cand`` user through per-query ``search``, and a
    catalogue update of RECSYS_NEW_ITEMS new items through ``insert``.
    Gates: the dense kernel and the exhaustive search return the GEMM's
    top-k but at near-ties, int8 overlaps f32 by INT8_OVERLAP, each new
    item is its own top-1.  Returns (record, the kernels' operands
    captured on the way: the brute force, the build's assignment on a
    sample, the APS centroid pass, the first RECSYS_HOLD_ROUNDS f32 APS
    rounds, the int8 rounds, the insert's assignment)."""
    import numpy as np
    import torch
    from repro_torch.core import (BatchedSearchExecutor, QuakeConfig,
                                  QuakeIndex)
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import ops
    from repro_torch.kernels import scan_topk as st
    from repro_torch.kernels import scan_topk_indexed as sti
    from repro_torch.models import recsys as rs
    cap = {"exhaustive": [], "aps": [], "int8": []}
    card = card_line()
    k, out = RECSYS_K, {}
    n = cand.shape[0]

    def encode(ids):
        return torch.cat([rs.item_repr(model, ids[i:i + RECSYS_CHUNK])
                          for i in range(0, ids.shape[0], RECSYS_CHUNK)])
    items, out["encode_items_ms"] = timed(lambda: encode(cand))
    np_users = recsys_pipeline(cfg, RECSYS_USERS, 2, seed)
    users_b = rs.batch_to(np_users, dev)
    users, out["encode_users_ms"] = timed(lambda: rs.user_repr(model,
                                                               users_b))
    (scores, top), gemm_ms = timed(lambda: (
        lambda sc: (sc, torch.topk(sc, k, dim=1)))(
            rs.retrieval_scores(model, users_b, items)))
    out["gemm_topk_ms"] = gemm_ms
    del scores
    u1 = rs.user_repr(model, user)
    # the catalogue update: items the corpus does not hold
    taken = torch.zeros(model.cfg.item_vocab, dtype=torch.bool, device=dev)
    taken[cand] = True
    new_ids = torch.nonzero(~taken)[:RECSYS_NEW_ITEMS, 0]
    new_items = rs.item_repr(model, new_ids).cpu().numpy()
    del taken
    check_finite("recsys two-tower items", items, (n, cfg.embed_dim))
    check_finite("recsys two-tower users", users,
                 (RECSYS_USERS, cfg.embed_dim))
    print(f"recsys [{card}]: encoded {n} items in "
          f"{out['encode_items_ms']:.1f} ms and {RECSYS_USERS} users in "
          f"{out['encode_users_ms']:.2f} ms; exact top-{k} "
          f"(retrieval_scores + torch.topk) {gemm_ms:.2f} ms, "
          f"{gemm_ms / RECSYS_USERS!r} ms a query")
    exact_d, exact_i = -top.values, top.indices
    uq = users.contiguous()

    # the dense kernel over every candidate
    ops.scan_topk(uq, items, k, metric="ip")
    (dk, ik), dense_ms = timed(lambda: ops.scan_topk(uq, items, k,
                                                      metric="ip"))
    out["dense_ms"] = dense_ms
    out["dense_err"], _ = compare_topk(
        f"recsys dense scan_topk vs the exact GEMM ({RECSYS_USERS} x {n})",
        dk, ik, exact_d, exact_i, (RECSYS_TOL, RECSYS_TOL))
    cap["brute_force"] = (uq, items)

    # the index: items_np by row, so external ids are rows of ``items``
    items_np = items.cpu().numpy()
    users_np = users.cpu().numpy()
    t = time.perf_counter()
    idx = QuakeIndex.build(items_np, num_partitions=RECSYS_P,
                           config=QuakeConfig(metric="ip"), device=dev)
    out["build_s"] = time.perf_counter() - t
    p = idx.num_partitions
    sizes = idx.levels[0].sizes()
    out["partition_sizes"] = {"min": int(sizes.min()),
                              "max": int(sizes.max()),
                              "mean": float(sizes.mean())}
    # the build's last assignment (its Lloyd loop's GEMM argmin), on a
    # sample: the kernel is held against it below
    samp = torch.randperm(n, generator=torch.Generator(device=dev)
                          .manual_seed(seed + 2), device=dev)[
        :RECSYS_ASSIGN_SAMPLE]
    cap["build_assign"] = (
        items.index_select(0, samp),
        torch.as_tensor(idx.levels[0].centroids, device=dev),
        torch.as_tensor(np.asarray([idx.id_map[int(i)] for i in
                                    samp.cpu().tolist()]), device=dev))
    print(f"recsys [{card}]: QuakeIndex(metric='ip').build of {n} x "
          f"{items.shape[1]} into {p} partitions (sizes "
          f"{out['partition_sizes']}) in {out['build_s']:.2f} s")

    def search(name, fn, gate):
        fn()                  # warm: the snapshot, the planner's radius
        r, ms = timed(fn)
        got = torch.as_tensor(r.ids, device=dev)
        rec = recall_at(r.ids, exact_i.cpu().numpy())
        out[name] = {"ms": ms, "ms_per_query": ms / RECSYS_USERS,
                     "recall@k": rec, "mean_nprobe": float(r.nprobe.mean()),
                     "rounds": int(r.rounds)}
        print(f"recsys [{card}]: {name}: recall@{k} {rec!r} against the "
              f"exact GEMM, mean nprobe {out[name]['mean_nprobe']!r}, "
              f"rounds {r.rounds}, {ms:.1f} ms "
              f"({ms / RECSYS_USERS!r} ms a query)")
        if gate:
            out[name]["err"], _ = compare_topk(
                f"recsys {name} vs the exact GEMM", torch.as_tensor(
                    r.dists, device=dev), got, exact_d, exact_i,
                (RECSYS_TOL, RECSYS_TOL))
        return r

    with patched((sti, "scan_topk_indexed", capture_rounds(
            sti.scan_topk_indexed, cap["exhaustive"], 1, {1, 2}, 1))):
        search("exhaustive", lambda: idx.search_batch(
            users_np, k, nprobe=p, rounds=1), gate=True)
    real_dense = st.scan_topk

    def centroid_pass(queries, xs, valid=None, **kw):
        if "centroid" not in cap and queries.shape[0] == RECSYS_USERS \
                and xs.shape[0] == p:
            cap["centroid"] = (queries.clone(), xs.clone(), valid, dict(kw))
        return real_dense(queries, xs, valid, **kw)
    ex32 = BatchedSearchExecutor(idx, planner="fused")
    with patched((st, "scan_topk", centroid_pass), (
            sti, "scan_topk_indexed", capture_rounds(
                sti.scan_topk_indexed, cap["aps"], 1, {1, 2},
                RECSYS_HOLD_ROUNDS))):
        r32 = search("aps_f32", lambda: ex32.search(
            users_np, k, recall_target=0.9), False)
    ex8 = BatchedSearchExecutor(idx, storage_dtype="int8", planner="fused")
    with patched((sti, "scan_topk_indexed_q8", capture_rounds(
            sti.scan_topk_indexed_q8, cap["int8"], 2, {2, 3, 6}, 64))):
        r8 = search("aps_int8", lambda: ex8.search(
            users_np, k, recall_target=0.9), False)
    ov = overlap(r8.ids, r32.ids)
    out["int8_overlap_f32"] = ov
    print(f"recsys [{card}]: int8 ids overlap the f32 APS ids by {ov!r}")
    if ov < INT8_OVERLAP:
        fail(f"recsys: int8 overlap with f32 {ov:.4f} < {INT8_OVERLAP}")
    if "centroid" not in cap:
        fail("recsys: no centroid pass of the APS batch was captured")

    # the retrieval_cand user through per-query search on the card
    q1 = u1.cpu().numpy()[0]
    (r1, ms1) = timed(lambda: idx.search(q1, k, recall_target=0.9))
    want1 = torch.topk(u1 @ torch.as_tensor(items_np, device=dev).T, k,
                       dim=1).indices.cpu().numpy()
    out["per_query"] = {"ms": ms1, "nprobe": int(r1.nprobe[0]),
                        "recall@k": recall_at(r1.ids[None, :], want1),
                        "vectors_scanned": int(r1.vectors_scanned)}
    print(f"recsys [{card}]: retrieval_cand user through QuakeIndex.search: "
          f"recall@{k} {out['per_query']['recall@k']!r}, nprobe "
          f"{r1.nprobe[0]}, {r1.vectors_scanned} vectors, {ms1:.1f} ms")
    if len(r1.ids) != k:
        fail(f"recsys: per-query search returned {len(r1.ids)} ids")

    # the catalogue update: new items routed by the assignment kernel; an
    # item is its own nearest neighbour under IP (unit norm)
    new_ext = np.arange(n, n + len(new_items), dtype=np.int64)
    real_assign = ka.kmeans_assign

    def routed(xs, cents, aux):
        cap["insert"] = (xs.clone(), cents.clone(), aux.clone())
        return real_assign(xs, cents, aux)
    with patched((ka, "kmeans_assign", routed)):
        _, out["insert_ms"] = timed(lambda: idx.insert(new_items, new_ext))
    if "insert" not in cap:
        fail("recsys: the insert launched no assignment")
    idx.check_invariants()
    r_new = idx.search_batch(new_items[:64], 1, nprobe=p, rounds=1)
    if not np.array_equal(r_new.ids[:, 0], new_ext[:64]):
        fail(f"recsys: {int((r_new.ids[:, 0] != new_ext[:64]).sum())} of "
             f"64 inserted items are not their own top-1")
    print(f"recsys [{card}]: inserted {len(new_items)} new items in "
          f"{out['insert_ms']:.1f} ms; each of the first 64 is its own "
          f"top-1 in an exhaustive search")
    # the int8 rounds' snapshot operands stay alive with the capture
    cap["int8_rounds"] = r8.rounds
    del idx, ex32, ex8
    return out, cap


def indexed_work(a, kp, q8):
    """(bytes, operations, active rows, rows read) of one indexed-scan
    call from its operands: each selected partition's live rows read once
    (codes, scales and ``aux`` for int8), the queries read and the top-k
    written once, and 2 d operations per live row of each (query, slot)
    pair the mask selects."""
    import torch
    from repro_torch.kernels import scan_topk_indexed as sti
    q, data, valid, sel, qmask = ((a[0], a[2], a[6], a[7], a[8]) if q8
                                  else (a[0], a[1], a[2], a[3], a[4]))
    b, d = q.shape
    u = int(sel.shape[0])
    nrows = sti.live_rows(valid)
    sel_l = sel.long()
    active = int((qmask.sum(dim=0).long() * nrows[sel_l].long()).sum())
    rows = int(nrows[torch.unique(sel_l)].sum())
    elem = 1 if q8 else data.element_size()
    ops_, nbytes = sti.work(b, u, 0, d, kp, elem, q8=q8, rows=rows,
                            active=active)
    return nbytes, ops_, active, rows


def recsys_kernel_checks(cap, dev) -> dict:
    """The four kernels of path 7 held against their plain versions on
    the path's own operands, and timed there (d = 256, inner product):
    ``kmeans_assign`` at the insert's routing call and on a sample of the
    build's points against its centroids (where the assignment must also
    equal the build's own GEMM argmin away from near-ties),
    ``scan_topk`` at the APS centroid pass and the brute force (its plain
    version in blocks of 64 queries), ``scan_topk_indexed`` at the
    exhaustive search's call and the first RECSYS_HOLD_ROUNDS APS rounds
    and ``scan_topk_indexed_q8`` at every int8 round (bit-equal).  Each
    is timed at its largest held APS call (the indexed scan also at the
    exhaustive call) beside its plain version, the library's version
    where there is one, and its bound."""
    from repro_torch.kernels import build
    import torch
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_topk as st
    from repro_torch.kernels import scan_topk_indexed as sti
    tol = (RECSYS_TOL, RECSYS_TOL)
    checks = {}

    # kmeans_assign
    xs, c, aux = cap["insert"]
    err, tol_a, _ = hold_assign(ka, f"recsys kmeans_assign at the insert "
                                f"(N {xs.shape[0]}, C {c.shape[0]})", xs, c,
                                aux, tol)
    xb, cb, a_build = cap["build_assign"]
    aux_b = (cb * cb).sum(1)
    err_b, _, ap = hold_assign(ka, f"recsys kmeans_assign on the build's "
                               f"sample (N {xb.shape[0]})", xb, cb, aux_b,
                               tol)
    dist = aux_b[None] - 2.0 * (xb @ cb.T)
    two = torch.topk(dist, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 2 * (RECSYS_TOL * two[:, 0].abs()
                                           + RECSYS_TOL)
    off = int(((ap.long() != a_build.long()) & clear).sum())
    if off:
        fail(f"recsys kmeans_assign: {off} of {xb.shape[0]} sampled points "
             f"assigned away from the build's own assignment, not at ties")
    del dist, two
    ms = cuda_ms(lambda: ka.kmeans_assign_cuda(xs, c, aux))
    plain_ms = cuda_ms(lambda: ka.kmeans_assign_plain(xs, c, aux))
    lib_ms = cuda_ms(lambda: torch.argmin(torch.cdist(xs, c), dim=1))
    n_x, nc, d = xs.shape[0], c.shape[0], xs.shape[1]
    b_ms, b_by = build.bound((n_x + nc) * d * 4 + n_x * 8,
                             2.0 * n_x * nc * d, build.F32_FLOPS_PER_S)
    checks["kmeans_assign"] = {
        "max_abs_err": max(err, err_b), "tol": tol_a, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by, "build_sample_agrees": True,
        "shape": {"N": n_x, "C": nc, "d": d,
                  "build_sample_N": int(xb.shape[0])}}

    # scan_topk: the centroid pass, then the brute force
    q, x, v, kw = cap["centroid"]
    dk, ik = st.scan_topk_cuda(q, x, v, **kw)
    dp, ip_ = st.scan_topk_plain(q, x, v, **kw)
    err_c, tol_c = compare_topk(
        f"recsys scan_topk at the APS centroid pass (Q {q.shape[0]}, N "
        f"{x.shape[0]}, k_pad {kw['k_pad']})", dk, ik, dp, ip_, tol)
    uq, items = cap["brute_force"]
    kp = 128
    bk, bi = st.scan_topk_cuda(uq, items, None, k_pad=kp, metric="ip")
    parts, plain_ms = [], 0.0
    for b0 in range(0, uq.shape[0], 64):
        r, t_ = timed(lambda: st.scan_topk_plain(uq[b0:b0 + 64], items,
                                                 None, k_pad=kp,
                                                 metric="ip"))
        parts.append(r)
        plain_ms += t_
    err_b, _ = compare_topk(
        f"recsys scan_topk at the brute force (Q {uq.shape[0]}, N "
        f"{items.shape[0]}, k_pad {kp})", bk, bi,
        torch.cat([p_[0] for p_ in parts]), torch.cat([p_[1] for p_ in parts]),
        tol)
    del parts
    ms = cuda_ms(lambda: st.scan_topk_cuda(uq, items, None, k_pad=kp,
                                           metric="ip"), reps=3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.topk(uq @ items.T, kp, dim=1), reps=3,
                     warmup=1)
    nq, n, d = uq.shape[0], items.shape[0], items.shape[1]
    b_ms, b_by = build.bound((nq + n) * d * 4 + 2 * nq * kp * 4,
                             2.0 * nq * n * d, build.F32_FLOPS_PER_S)
    c_ms = cuda_ms(lambda: st.scan_topk_cuda(q, x, v, **kw))
    c_lib = cuda_ms(lambda: torch.topk(q @ x.T, min(kw["k_pad"],
                                                    x.shape[0]), dim=1))
    cb_ms, cb_by = build.bound((q.shape[0] + x.shape[0]) * d * 4,
                               2.0 * q.shape[0] * x.shape[0] * d,
                               build.F32_FLOPS_PER_S)
    checks["scan_topk"] = {
        "max_abs_err": max(err_c, err_b), "tol": tol_c, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by,
        "shape": {"Q": nq, "N": n, "d": d, "k_pad": kp, "metric": "ip"},
        "centroid_pass": {"ms": c_ms, "library_ms": c_lib, "bound_ms": cb_ms,
                          "bound_by": cb_by, "shape": {
                              "Q": int(q.shape[0]), "N": int(x.shape[0]),
                              "k_pad": kw["k_pad"]}}}
    del bk, bi

    # the indexed scans: f32 APS rounds, then every int8 round bit-equal
    for name, calls, plain, kern, rows, cols, q8 in (
            ("scan_topk_indexed", cap["exhaustive"] + cap["aps"],
             sti.scan_topk_indexed_plain,
             sti.scan_topk_indexed_cuda, {0, 4}, {3, 4}, False),
            ("scan_topk_indexed_q8", cap["int8"],
             sti.scan_topk_indexed_q8_plain, sti.scan_topk_indexed_q8_cuda,
             {0, 1, 5, 8}, {5, 7, 8}, True)):
        torch.cuda.empty_cache()
        held = hold_query_blocks(f"recsys {name}", calls, plain, rows, cols,
                                 exact=q8, tol=tol)
        if not q8:          # the exhaustive call: every partition
            a, kw, _ = calls[0]
            nbytes, ops_, _, _ = indexed_work(a, kw["k_pad"], False)
            held["exhaustive"] = dict(zip(
                ("bound_ms", "bound_by"),
                build.bound(nbytes, ops_, build.F32_FLOPS_PER_S)), ms=cuda_ms(
                    lambda: kern(*a, **kw), reps=3, warmup=1),
                U=int(a[-1].shape[1]))
            calls = calls[1:]
        a, kw, _ = max(calls, key=lambda c_: int(c_[0][-1].sum()))
        ms = cuda_ms(lambda: kern(*a, **kw))
        _, plain_ms = timed(lambda: plain(*a, **kw))
        nbytes, ops_, active, rows_read = indexed_work(a, kw["k_pad"], q8)
        b_ms, b_by = build.bound(nbytes, ops_, build.INT8_OPS_PER_S if q8
                                 else build.F32_FLOPS_PER_S)
        if q8:
            lib_ms = timed(lambda: library_indexed_q8(*a, **kw))[1]
        else:
            sel_l = a[3].long()
            lib_ms = timed(lambda: library_indexed(
                a[0], a[1].index_select(0, sel_l), a[2], sel_l, a[4],
                kw["metric"], kw["k_pad"]))[1]
        held.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, timed_shape={
                        "B": int(a[-1].shape[0]), "U": int(a[-1].shape[1]),
                        "S": int(a[2 if q8 else 1].shape[1]),
                        "d": int(a[0].shape[1]), "k_pad": kw["k_pad"],
                        "active_pair_rows": active, "rows_read": rows_read,
                        "metric": kw["metric"]})
        checks[name] = held
    for name, c_ in checks.items():
        print(f"recsys {name} on the path's operands: err "
              f"{c_['max_abs_err']:.3g}, {c_['ms']:.4f} ms, plain "
              f"{c_['plain_ms']:.2f} ms, library {c_['library_ms']}, bound "
              f"{c_['bound_ms']:.4f} ms ({c_['bound_by']})")
    return checks


def run_recsys(args, dev, start_path, end_path) -> dict:
    """The recsys path: card against CPU at the smoke configs, then each
    of RECSYS_ARCHS at its published config (one model's tables on the
    card at a time) through serve_p99, serve_bulk and retrieval_cand, the
    two-tower's retrieval through Quake, the launch gates and the
    kernels held on the path's own operands."""
    import torch
    from repro_torch.configs import recsys_archs
    from repro_torch.models import recsys as rs
    t0 = time.perf_counter()
    card = card_line()
    out = {"card": card, "models": {}}
    out["card_vs_cpu"] = recsys_card_vs_cpu(dev, args.seed)
    shapes = RECSYS_SHAPES or recsys_archs.RECSYS_SHAPES
    start_path()
    torch.cuda.reset_peak_memory_stats()
    cap = None
    for name in RECSYS_ARCHS:
        cfg = recsys_archs.ARCHS[name][RECSYS_SIZE]()
        g = torch.Generator(device=dev).manual_seed(args.seed)
        model, build_ms = timed(lambda: rs.MODELS[name][1](
            cfg, device=dev, generator=g))
        gb = sum(p_.numel() * p_.element_size()
                 for p_ in model.parameters()) / 1e9
        print(f"recsys [{card}]: {name} at {cfg}: {gb:.2f} GB of f32 "
              f"weights drawn on the card in {build_ms:.1f} ms")
        rec, cand, user = recsys_serve_model(name, cfg, model, dev,
                                             args.seed, shapes)
        rec.update(build_ms=build_ms, weights_gb=gb)
        if name == "two-tower-retrieval":
            rec["quake"], cap = recsys_quake(cfg, model, cand, user, dev,
                                             args.seed)
        out["models"][name] = rec
        del model, cand, user
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = end_path("recsys", ("kmeans_assign", "scan_topk",
                                          "scan_topk_indexed",
                                          "scan_topk_indexed_q8"))
    if out["launches"]["flash_attention"]:
        fail("recsys: the path launched the flash kernel")
    out["kernel_checks"] = recsys_kernel_checks(cap, dev)
    del cap
    gc.collect()
    torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t0
    print(f"recsys [{card}]: peak device memory {out['peak_gb']:.2f} GB")
    return out


# ---------------------------------------------------------------------------
# path 8: MoE LM serving (qwen3-moe-235b-a22b, llama4-scout)
# ---------------------------------------------------------------------------

def moe_card_vs_cpu(name, dev, seed) -> dict:
    """The smoke config ``name`` with the same weights on the card and the
    CPU: ``prefill`` of a (2, 40) prompt (two groups of 64, the second
    padded) and one ``decode_step`` of two rows at different lengths,
    within MOE_TOL * |x| + MOE_TOL; then the same with a zero router
    (uniform probabilities: every choice ties, and every token asks for
    experts 0..k-1, so most are dropped)."""
    import torch
    from torch.nn import functional as F
    from repro_torch.configs import lm_archs
    from repro_torch.models import Transformer
    cfg = getattr(lm_archs, name)()
    out = {}
    for case in ("random", "zero_router"):
        cpu = Transformer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        if case == "zero_router":
            for blk in cpu.blocks:
                blk.moe.router.data.zero_()
        card = Transformer(cfg, device=dev, init=False)
        card.load_state_dict(cpu.state_dict())
        toks = torch.randint(0, cfg.vocab_size, (2, 40),
                             generator=torch.Generator().manual_seed(seed))
        lg, (ck, cv) = cpu.prefill(toks)
        lg_d, (ck_d, cv_d) = card.prefill(toks.to(dev))
        errs = {"prefill": check_close(
            f"moe {name} {case} prefill logits, card vs CPU", lg_d.cpu(), lg,
            MOE_TOL, MOE_TOL)}
        ck, cv = (F.pad(t_, (0, 0, 0, 0, 0, 1)) for t_ in (ck, cv))
        ck_d, cv_d = ck.to(dev), cv.to(dev)
        tok, cl = torch.tensor([3, 7]), torch.tensor([40, 37])
        want, _ = cpu.decode_step(tok, ck, cv, cl)
        got, _ = card.decode_step(tok.to(dev), ck_d, cv_d, cl.to(dev))
        errs["decode"] = check_close(
            f"moe {name} {case} decode logits, card vs CPU", got.cpu(), want,
            MOE_TOL, MOE_TOL)
        out[case] = errs
    return out


@contextlib.contextmanager
def moe_recording(records):
    """Append each MoE layer call's kept mask of its real tokens' (token,
    choice) pairs, (B*S, k) on the device, to ``records``, and mark each
    ``moe_ffn`` call as a profiler range of that name."""
    import torch
    from repro_torch.models import transformer as tr
    real_route, real_ffn = tr.route, tr.moe_ffn

    def route(moe, x, mcfg):
        r = real_route(moe, x, mcfg)
        t = x.shape[0] * x.shape[1]
        records.append((r.slot < r.cap).reshape(-1, mcfg.top_k)[:t])
        return r

    def moe_ffn(moe, x, cfg):
        with torch.profiler.record_function("moe_ffn"):
            return real_ffn(moe, x, cfg)

    with patched((tr, "route", route), (tr, "moe_ffn", moe_ffn)):
        yield


def drop_shares(records):
    """(share of (token, choice) pairs dropped, share of tokens that lost
    every choice) for each recorded layer call."""
    return [(1.0 - float(k.float().mean()), float((~k).all(1).float().mean()))
            for k in records]


def run_moe_model(name, smoke, args, dev, start_path, end_path) -> dict:
    """One MoE model of path 8: exact f32 checks at full width and
    MOE_CHECK_LAYERS layers, card against CPU at its smoke config, then
    serving at full width and MOE_LAYERS layers in bf16, then the flash
    kernel held and timed at layer 0's operands."""
    import dataclasses
    import statistics
    import numpy as np
    import torch
    from torch.nn import functional as F
    from repro_torch.configs import lm_archs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Transformer, param_count
    torch.cuda.reset_peak_memory_stats()
    out = {}
    base = getattr(lm_archs, name)()
    mcfg = base.moe
    h, kh, dh, vocab = (base.n_heads, base.n_kv_heads, base.head_dim,
                        base.vocab_size)

    def plain_attention(q, k, v, *, causal, q_block, k_block):
        qb, kb = fa.TILES[q.dtype]
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        q_block=qb, k_block=kb)

    # -- exact f32 checks: full width, MOE_CHECK_LAYERS layers -------------
    cfg32 = dataclasses.replace(base, n_layers=MOE_CHECK_LAYERS,
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    m32 = Transformer(cfg32, device=dev, generator=g)
    s32, steps32 = 512, 4
    toks = torch.randint(0, vocab, (2, s32 + steps32), generator=g,
                         device=dev)
    records = []
    with moe_recording(records):
        lg_k, _ = m32.prefill(toks[:, :s32])
    out["f32_drop_share"] = drop_shares(records)
    before = fa.LAUNCHES.count
    lg_p, _ = m32.prefill(toks[:, :s32], attention=plain_attention)
    if fa.LAUNCHES.count != before:
        fail(f"moe {name} f32 prefill with plain attention launched the "
             f"flash kernel")
    errs = {"f32_prefill_kernel_vs_plain": check_close(
        f"moe {name} f32 prefill logits, kernel vs plain attention", lg_k,
        lg_p, LM_TOL, LM_TOL)}
    # capacity_factor E / top_k: cap >= g, nothing dropped, so a token's
    # MoE output depends on that token alone
    m32.cfg = dataclasses.replace(cfg32, moe=dataclasses.replace(
        mcfg, capacity_factor=mcfg.n_experts / mcfg.top_k))
    _, (ck, cv) = m32.prefill(toks[:, :s32])
    pad = (0, 0, 0, 0, 0, steps32)
    ck, cv = F.pad(ck, pad), F.pad(cv, pad)
    for t_ in range(s32, s32 + steps32):
        lg_d, (ck, cv) = m32.decode_step(
            toks[:, t_], ck, cv, torch.full((2,), t_, device=dev))
        lg_r, _ = m32.prefill(toks[:, :t_ + 1])
        errs[f"f32_decode_vs_reprefill@{t_}"] = check_close(
            f"moe {name} f32 decode at position {t_} vs re-prefill "
            f"(capacity_factor {m32.cfg.moe.capacity_factor:g})", lg_d, lg_r,
            LM_TOL, LM_TOL)
    out["f32_checks"] = errs
    print(f"moe {name} f32: drop share per layer at capacity_factor "
          f"{mcfg.capacity_factor:g}, pairs / whole tokens: "
          f"{[(round(a, 4), round(b, 4)) for a, b in out['f32_drop_share']]}")
    del m32, ck, cv, lg_k, lg_p, lg_d, lg_r
    gc.collect()
    torch.cuda.empty_cache()

    out["card_vs_cpu"] = moe_card_vs_cpu(smoke, dev, args.seed)

    # -- serving at full width, MOE_LAYERS layers, bf16 ---------------------
    cfg = dataclasses.replace(base, n_layers=MOE_LAYERS,
                              param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    n_l, b, s, n_dec = cfg.n_layers, LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE
    start_path()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    model, out["build_ms"] = timed(lambda: Transformer(cfg, device=dev,
                                                       generator=g))
    out["weights_gb"] = sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9
    print(f"moe {name} at {n_l} of {base.n_layers} layers, d_model "
          f"{cfg.d_model}, {h}/{kh} heads of {dh}, {mcfg.n_experts} experts "
          f"top-{mcfg.top_k} of {mcfg.d_ff} (+{mcfg.n_shared} shared), "
          f"capacity_factor {mcfg.capacity_factor:g}, group {mcfg.group_size},"
          f" bf16: {param_count(cfg)} parameters, {out['weights_gb']:.2f} GB,"
          f" drawn in {out['build_ms']:.1f} ms")
    prompts = torch.randint(0, vocab, (b, s), generator=g, device=dev)
    captured = {}

    def capture(q, k, v, **kw):
        if not captured:
            captured[0] = (q.clone(), k.clone(), v.clone())
        return fa.flash_attention(q, k, v, **kw)

    before = fa.LAUNCHES.count
    (logits, (ck, cv)), out["prefill_first_ms"] = timed(
        lambda: model.prefill(prompts, attention=capture))
    prefill_launches = fa.LAUNCHES.count - before
    check_finite(f"moe {name} prefill logits", logits, (b, vocab))
    shape = (n_l, b, s + n_dec, kh, dh)
    ckp = torch.zeros(shape, dtype=ck.dtype, device=dev)
    cvp = torch.zeros(shape, dtype=cv.dtype, device=dev)
    ckp[:, :, :s], cvp[:, :, :s] = ck, cv
    del ck, cv
    tok = logits.argmax(-1)
    step_ms, dec_launches = [], []
    cache_len = torch.full((b,), s, device=dev)
    for i in range(n_dec):
        before = fa.LAUNCHES.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = model.decode_step(tok, ckp, cvp, cache_len)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        dec_launches.append(fa.LAUNCHES.count - before)
        check_finite(f"moe {name} decode step {i + 1} logits", lg, (b, vocab))
        tok = lg.argmax(-1)
        cache_len += 1
    got = end_path(f"moe {name}", ("flash_attention",))
    out.update(prefill_launches=prefill_launches,
               decode_launches=dec_launches, decode_ms=step_ms,
               decode_ms_median=statistics.median(step_ms))
    if prefill_launches != n_l or got["flash_attention"] != n_l:
        fail(f"moe {name}: {prefill_launches} flash launches in the "
             f"prefill, {got['flash_attention']} on the path, not {n_l}")
    if any(dec_launches):
        fail(f"moe {name}: a decode step launched the flash kernel")
    _, out["prefill_warm_ms"] = timed(lambda: model.prefill(prompts))
    records = []
    with moe_recording(records):
        prof = profile_call(lambda: model.prefill(prompts),
                            f"moe_prefill_{name}",
                            "flash_fwd_bf16_mma_kernel", ranges=("moe_ffn",))
    out["drop_share"] = drop_shares(records[:n_l])
    out["prefill_tokens_per_s"] = b * s / out["prefill_warm_ms"] * 1e3
    if prof["device_busy_ms"]:
        prof["moe_share"] = prof["range_ms"]["moe_ffn"] / \
            prof["device_busy_ms"]
        prof["flash_share"] = prof["match_ms"] / prof["device_busy_ms"]
    out["profile"] = prof
    out["peak_gb_serving"] = torch.cuda.max_memory_allocated() / 1e9
    pairs = [a for a, _ in out["drop_share"][:n_l]]
    print(f"moe {name}: prefill of {b} x {s} tokens {out['prefill_warm_ms']:.1f}"
          f" ms warm ({out['prefill_first_ms']:.1f} first), "
          f"{out['prefill_tokens_per_s']:.0f} tokens/s; decode "
          f"{out['decode_ms_median']:.2f} ms a step (median of {n_dec}); "
          f"flash launches {prefill_launches} a prefill, "
          f"{sorted(set(dec_launches))} a step; peak "
          f"{out['peak_gb_serving']:.2f} GB")
    print(f"moe {name}: pairs dropped per layer in the warm prefill "
          f"{[round(x, 4) for x in pairs]} (mean {np.mean(pairs):.4f})")
    if prof["device_busy_ms"]:
        print(f"moe {name}: moe_ffn takes {prof['range_ms']['moe_ffn']:.1f} "
              f"ms and the flash kernel {prof['match_ms']:.1f} ms of the warm "
              f"prefill's {prof['device_busy_ms']:.1f} ms of device time "
              f"({prof['moe_share']:.1%}, {prof['flash_share']:.1%})")
    del model, ckp, cvp, logits, lg
    gc.collect()
    torch.cuda.empty_cache()

    # -- the flash kernel at layer 0's operands ------------------------------
    q, k, v = captured.pop(0)
    bq, bk = fa.TILES[torch.bfloat16]
    o_k = fa.flash_attention_cuda(q, k, v, causal=True)
    o_p, plain_ms = timed(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, q_block=bq, k_block=bk))
    err = check_close(f"flash_attention bf16, {name} layer 0's operands",
                      o_k, o_p, FLASH_BF16_REL, FLASH_BF16_ABS)
    del o_k, o_p
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                 reps=5, warmup=1)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), reps=5, warmup=1)
    bound_ms, bound_by = fa.flash_bound(b, s, s, h, kh, dh, True, 2)
    out["flash"] = {"shape": {"B": b, "S": s, "H": h, "KH": kh, "D": dh},
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": err, "launches": got["flash_attention"]}
    print(f"flash_attention at {name}'s {(b, s, h, kh, dh)}: {ms:.4f} ms "
          f"(plain {plain_ms:.1f}, library {lib_ms:.4f}, bound "
          f"{bound_ms:.4f} ms by {bound_by})")
    del q, k, v, views
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def run_moe(args, dev, start_path, end_path) -> dict:
    """Path 8: each of MOE_MODELS in turn, one model on the card at a
    time."""
    import torch
    t0 = time.perf_counter()
    out = {"card": card_line(), "models": {}}
    for name, smoke in MOE_MODELS:
        out["models"][name] = run_moe_model(name, smoke, args, dev,
                                            start_path, end_path)
        gc.collect()
        torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# path 9: the GAT forward at the four graph shapes
# ---------------------------------------------------------------------------

def gnn_graph(shape, sh, seed):
    """(feats (N, d_feat) numpy or None to draw on the card, src, dst,
    graph_of or None, facts) of one GNN_SHAPES entry, drawn in host numpy
    by the port's data/graphs.py."""
    import numpy as np
    from repro_torch.data import GraphMinibatchPipeline, graphs
    if shape == "full_graph_sm":
        g, feats, _ = graphs.community_graph(
            sh["n_nodes"], sh["n_edges"] / sh["n_nodes"] / 2,
            d_feat=sh["d_feat"], seed=seed)
        src, dst = graphs.to_edges(g)
        return feats, src, dst, None, {}
    if shape == "minibatch_lg":
        g = graphs.power_law_graph(GNN_REDDIT_NODES, GNN_REDDIT_DEGREE,
                                   seed=seed)
        rng = np.random.default_rng(seed)
        feats = rng.standard_normal((g.n_nodes, sh["d_feat"]),
                                    dtype=np.float32)
        labels = rng.integers(0, 41, g.n_nodes).astype(np.int32)
        batch = GraphMinibatchPipeline(
            g, feats, labels, GNN_BATCH_NODES, GNN_FANOUTS,
            seed=seed).batch_at(0)
        n, e = int(batch["n_nodes"]), len(batch["src"])
        if n > sh["n_nodes"] or e > sh["n_edges"]:
            fail(f"gnn minibatch_lg: {n} nodes and {e} edges, past the "
                 f"shape's padded {sh['n_nodes']} / {sh['n_edges']}")
        return batch["feats"], batch["src"], batch["dst"], None, {
            "graph_nodes": g.n_nodes, "graph_edges": g.n_edges}
    if shape == "ogb_products":
        g = graphs.power_law_graph(sh["n_nodes"],
                                   sh["n_edges"] / sh["n_nodes"] / 2,
                                   seed=seed)
        if abs(g.n_edges - sh["n_edges"]) > 0.01 * sh["n_edges"]:
            fail(f"gnn ogb_products: {g.n_edges} edges, not within 1% of "
                 f"{sh['n_edges']}")
        src, dst = graphs.to_edges(g)
        return None, src, dst, None, {}
    src, dst, feats, graph_of = graphs.molecule_batch(
        sh["n_graphs"], sh["n_nodes"], sh["n_edges"], sh["d_feat"],
        seed=seed)
    return feats, src, dst, graph_of, {}


def gnn_run(model, shape, sh, feats, src, dst, graph_of):
    """The shape's forward: node logits, or graph logits for a pooled
    shape."""
    from repro_torch.models import gnn
    if sh["kind"] == "pooled":
        return gnn.graph_pool_logits(model, feats, src, dst, graph_of,
                                     sh["n_graphs"])
    return gnn.forward(model, feats, src, dst)


def gnn_card_vs_cpu(dev, seed) -> dict:
    """gat_cora_smoke at each GNN_SMOKE_SHAPES entry's d_feat on a graph of
    that shape, the same weights on the card and the CPU: equal within
    GNN_TOL * |x| + GNN_TOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import gnn_archs
    from repro_torch.data import graphs
    from repro_torch.models import GAT
    out = {}
    for shape, sh in gnn_archs.GNN_SMOKE_SHAPES.items():
        if sh["kind"] == "pooled":
            src, dst, feats, graph_of = graphs.molecule_batch(
                sh["n_graphs"], sh["n_nodes"], sh["n_edges"], sh["d_feat"],
                seed=seed)
        else:
            n = sh["n_nodes"]
            src, dst = graphs.to_edges(graphs.power_law_graph(
                n, sh["n_edges"] / n / 2, seed=seed))
            feats = np.random.default_rng(seed).normal(
                size=(n, sh["d_feat"])).astype(np.float32)
            graph_of = None
        cfg = dataclasses.replace(gnn_archs.gat_cora_smoke(),
                                  d_in=sh["d_feat"])
        cpu = GAT(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
        card = GAT(cfg, device=dev, init=False)
        card.load_state_dict(cpu.state_dict())
        args = [None if a is None else torch.as_tensor(a)
                for a in (feats, src, dst, graph_of)]
        want = gnn_run(cpu, shape, sh, *args)
        got = gnn_run(card, shape, sh, *[None if a is None else a.to(dev)
                                         for a in args])
        out[shape] = check_close(f"gnn smoke {shape}, card vs CPU", got.cpu(),
                                 want, GNN_TOL, GNN_TOL)
    return out


def run_gnn(args, dev, start_path, end_path) -> dict:
    """Path 9: the GAT forward (gat_cora at each shape's d_feat, weights
    drawn on the card from the seed) at the four GNN_SHAPES: the graph
    drawn on the host, a first and a warm forward, a second forward
    bit-equal to the first, shapes and finite values, and the card
    against the CPU at the full_graph_sm and molecule shapes (full width)
    and at the smoke shapes."""
    import dataclasses
    import torch
    from repro_torch.configs import gnn_archs
    from repro_torch.models import GAT
    t_path = time.perf_counter()
    card = card_line()
    out = {"card": card, "card_vs_cpu": gnn_card_vs_cpu(dev, args.seed),
           "shapes": {}}
    start_path()
    for shape, sh in gnn_archs.GNN_SHAPES.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        feats, src, dst, graph_of, facts = gnn_graph(shape, sh, args.seed)
        draw_s = time.perf_counter() - t0
        cfg = dataclasses.replace(gnn_archs.gat_cora(), d_in=sh["d_feat"])
        g = torch.Generator(device=dev).manual_seed(args.seed)
        model = GAT(cfg, device=dev, generator=g)
        n_nodes = len(feats) if feats is not None else sh["n_nodes"]
        if feats is None:
            feats_d = torch.randn((n_nodes, sh["d_feat"]), generator=g,
                                  device=dev)
        else:
            feats_d = torch.as_tensor(feats, device=dev)
        dev_args = (feats_d, torch.as_tensor(src, device=dev),
                    torch.as_tensor(dst, device=dev),
                    None if graph_of is None else
                    torch.as_tensor(graph_of, device=dev))
        first, first_ms = timed(lambda: gnn_run(model, shape, sh, *dev_args))
        rows = sh["n_graphs"] if sh["kind"] == "pooled" else n_nodes
        check_finite(f"gnn {shape} logits", first, (rows, cfg.n_classes))
        warm, warm_ms = timed(lambda: gnn_run(model, shape, sh, *dev_args))
        if not torch.equal(first, warm):
            fail(f"gnn {shape}: two forwards differ in "
                 f"{int((first != warm).sum())} entries")
        rec = {"nodes": n_nodes, "edges": len(src), "d_feat": sh["d_feat"],
               "draw_s": draw_s, "first_ms": first_ms, "warm_ms": warm_ms,
               "edges_per_s": len(src) / warm_ms * 1e3,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **facts}
        if shape in GNN_CPU_SHAPES:
            cpu = GAT(cfg, device="cpu", init=False)
            cpu.load_state_dict({k: v.cpu()
                                 for k, v in model.state_dict().items()})
            want = gnn_run(cpu, shape, sh, *[None if a is None else a.cpu()
                                             for a in dev_args])
            rec["card_vs_cpu"] = check_close(
                f"gnn {shape} at full width, card vs CPU", warm.cpu(), want,
                GNN_TOL, GNN_TOL)
        out["shapes"][shape] = rec
        print(f"gnn [{card}] {shape}: {n_nodes} nodes, {len(src)} edges, "
              f"d_feat {sh['d_feat']}: graph drawn in {draw_s:.2f} s, "
              f"forward {first_ms:.2f} ms first, {warm_ms:.2f} ms warm, "
              f"{rec['edges_per_s']:.4g} edges/s, repeat bit-equal, peak "
              f"{rec['peak_gb']:.2f} GB")
        del model, feats_d, dev_args, first, warm, feats, src, dst, graph_of
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = end_path("gnn", ())
    if any(out["launches"].values()):
        fail("gnn: the GAT forward launched a kernel of the port")
    out["path_s"] = time.perf_counter() - t_path
    return out


# ---------------------------------------------------------------------------
# path 10: training on the card
# ---------------------------------------------------------------------------

def sample_entries(model, n: int, seed: int) -> dict:
    """(indices, values) of ``n`` fixed entries of each parameter (all of
    a smaller one), to see which a step changed without a copy of the
    model."""
    import torch
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.named_parameters():
        flat = p.detach().reshape(-1)
        idx = (torch.arange(flat.numel()) if flat.numel() <= n else
               torch.randint(0, flat.numel(), (n,), generator=g))
        idx = idx.to(p.device)
        out[name] = (idx, flat[idx].clone())
    return out


def check_changed(name, model, before: dict) -> float:
    """Fail unless a step changed every parameter (at least half of each
    one's sampled entries); returns the smallest changed share."""
    shares = {}
    for pname, p in model.named_parameters():
        idx, old = before[pname]
        now = p.detach().reshape(-1)[idx]
        shares[pname] = float((now != old).float().mean())
    worst = min(shares, key=shares.get)
    if shares[worst] < 0.5:
        fail(f"{name}: the step left {1 - shares[worst]:.3f} of {worst}'s "
             f"sampled entries unchanged")
    return shares[worst]


def hold_params(name, got_model, want_model, small: dict,
                lr: float) -> float:
    """Every parameter of ``got_model`` within TRAIN_TOL * |x| + TRAIN_TOL
    of ``want_model``'s, except where ``small`` marks an entry (a
    near-zero gradient, or a code tie of the compressed step): Adam's
    first update there is lr * sign(g) of a rounding-level g, held to
    2 * lr.  Returns the largest |diff| outside the marked entries."""
    import torch
    worst = 0.0
    want = dict(want_model.named_parameters())
    for pname, p in got_model.named_parameters():
        w = want[pname].detach().double().cpu()
        x = p.detach().double().cpu()
        diff = (x - w).abs()
        mark = small[pname].cpu()
        over = diff > torch.where(mark, 2.0 * lr,
                                  TRAIN_TOL * w.abs() + TRAIN_TOL)
        if bool(over.any()):
            fail(f"{name}: {int(over.sum())} entries of {pname} beyond "
                 f"their bound, max |diff| {float(diff.max()):.3g}")
        if bool((~mark).any()):
            worst = max(worst, float(diff[~mark].max()))
    return worst


def near_zero(grads: dict) -> dict:
    """Entries whose gradient is under TRAIN_SMALL of its leaf's largest,
    or at the f32 rounding level of the largest of all (under TRAIN_NOISE
    of it: a leaf whose gradient cancels to zero, such as the bias before
    a softmax, holds rounding noise alone)."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {n: (g.abs() < TRAIN_SMALL * g.abs().max())
            | (g.abs() < TRAIN_NOISE * top) for n, g in grads.items()}


def train_smoke_cases(dev, seed):
    """(name, the CPU model, the card model with the same weights, loss,
    batch) of each smoke config that path 10 (a) steps on both."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import gnn_archs, lm_archs, recsys_archs
    from repro_torch.configs import training
    from repro_torch.data import TokenPipeline, graphs
    from repro_torch.models import GAT, Transformer, gnn
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tr

    def pair(make):
        cpu = make("cpu", torch.Generator().manual_seed(seed))
        card = make(dev, None)
        card.load_state_dict(cpu.state_dict())
        return cpu, card

    sh = training.LM_TRAIN_SMOKE_SHAPES["train_4k"]
    for name in TRAIN_SMOKE_LMS:
        cfg = dataclasses.replace(
            training.adapt_lm_cfg(getattr(lm_archs, name)()), q_block=16,
            k_block=32)
        cpu, card = pair(lambda d, g: Transformer(
            cfg, device=d, generator=g, init=g is not None))
        batch = TokenPipeline(cfg.vocab_size, sh["batch"], sh["seq"],
                              seed).batch_at(0)
        yield (name, cpu, card, lambda m, b: tr.lm_loss(m, b["tokens"]),
               batch)
    b = recsys_archs.RECSYS_SMOKE_SHAPES["train_batch"]["batch"]
    for name in RECSYS_ARCHS:
        cfg = recsys_archs.ARCHS[name][1]()
        cpu, card = pair(lambda d, g: rs.MODELS[name][1](
            cfg, device=d, generator=g, init=g is not None))
        yield (f"{name}_smoke", cpu, card, rs.recsys_loss,
               recsys_pipeline(cfg, b, 0, seed))
    rng = np.random.default_rng(seed)
    for shape in ("full_graph_sm", "molecule"):
        sh = gnn_archs.GNN_SMOKE_SHAPES[shape]
        cfg = dataclasses.replace(gnn_archs.gat_cora_smoke(),
                                  d_in=sh["d_feat"])
        cpu, card = pair(lambda d, g: GAT(cfg, device=d, generator=g,
                                          init=g is not None))
        if sh["kind"] == "pooled":
            src, dst, feats, graph_of = graphs.molecule_batch(
                sh["n_graphs"], sh["n_nodes"], sh["n_edges"], sh["d_feat"],
                seed=seed)
            n = sh["n_graphs"]
            batch = {"feats": feats, "src": src, "dst": dst,
                     "graph_of": graph_of,
                     "labels": rng.integers(0, 7, n).astype(np.int32)}
            yield (f"gat_{shape}_smoke", cpu, card,
                   lambda m, b, n=n: gnn.pooled_loss(
                       m, b["feats"], b["src"], b["dst"], b["graph_of"],
                       b["labels"], n), batch)
        else:
            n = sh["n_nodes"]
            src, dst = graphs.to_edges(graphs.power_law_graph(
                n, sh["n_edges"] / n / 2, seed=seed))
            batch = {"feats": rng.normal(size=(n, sh["d_feat"])).astype(
                         np.float32), "src": src, "dst": dst,
                     "labels": rng.integers(0, 7, n).astype(np.int32)}
            yield (f"gat_{shape}_smoke", cpu, card,
                   lambda m, b: gnn.loss_fn(m, b["feats"], b["src"],
                                            b["dst"], b["labels"]), batch)


def train_card_vs_cpu(dev, seed) -> dict:
    """Path 10 (a): one ``make_train_step`` step of each smoke config, f32
    with TF32 off, on the card and on the CPU from the same weights: loss
    and grad norm within TRAIN_TOL * |x| + TRAIN_TOL, and every parameter
    after the step (``hold_params``; the near-zero entries from the CPU's
    gradient)."""
    import torch
    from repro_torch.train import optimizer as opt, steps
    if torch.backends.cuda.matmul.allow_tf32:
        fail("train: TF32 is on for the f32 card-vs-CPU steps")
    cfg = opt.AdamWConfig(**TRAIN_SMOKE_OPT)
    out = {}
    for name, cpu, card, loss_fn, batch in train_smoke_cases(dev, seed):
        _, g = steps.value_and_grad(loss_fn, cpu,
                                    steps.to_device(batch, "cpu"))
        step = steps.make_train_step(loss_fn, cfg)
        _, _, mc = step(cpu, opt.init_state(cpu), batch)
        _, _, mg = step(card, opt.init_state(card), batch)
        rec = {k: check_close(f"train (a) {name} {k}, card vs CPU",
                              mg[k].reshape(1).cpu(), mc[k].reshape(1),
                              TRAIN_TOL, TRAIN_TOL)
               for k in ("loss", "grad_norm")}
        rec["params"] = hold_params(f"train (a) {name} params", card, cpu,
                                    near_zero(g), float(mc["lr"]))
        rec["near_zero_share"] = float(
            sum(int(s.sum()) for s in near_zero(g).values())
            / sum(t.numel() for t in g.values()))
        print(f"train (a) {name}: loss {float(mc['loss']):.6f}, card = CPU "
              f"(params max |diff| {rec['params']:.3g} away from "
              f"{rec['near_zero_share']:.4f} near-zero gradient entries)")
        out[name] = rec
    return out


def train_flops(cfg, b, s) -> dict:
    """The FLOP count of one qwen2.5 ``train_4k`` step as the port runs
    it: 6·N·T for the matmuls (N: the layers' projections and the
    unembedding; T = B·S tokens), 2·N_layers·T for the per-layer remat
    forward, 2·d·V·T for the chunked loss's recomputed unembedding, and
    attention over every (q, k) tile, the fully masked ones too: 4·B·S²·
    H·dh a layer forward, five times (forward, remat forward, the tiles'
    recompute, a backward of two)."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = d * dh * (h + 2 * kh) + h * dh * d + 3 * d * cfg.d_ff
    t = b * s
    parts = {"matmuls": 6.0 * (cfg.n_layers * layer + d * cfg.vocab_size) * t,
             "remat_forward": 2.0 * cfg.n_layers * layer * t,
             "loss_recompute": 2.0 * d * cfg.vocab_size * t,
             "attention": 5 * 4.0 * b * s * s * h * dh * cfg.n_layers}
    parts["total"] = sum(parts.values())
    return parts


def train_lm_full(dev, seed, counters) -> dict:
    """Path 10 (b): qwen2.5-14b at full width and TRAIN_LAYERS layers, the
    reference's ``train_4k`` step on one card (``lm_loss_chunked``,
    TRAIN_MB microbatches, remat, bf16 cast, OPT_CFG): one warm step and
    TRAIN_TIMED timed ones, each with a finite loss and grad norm; every
    parameter changed; none of the port's kernels launched; then one
    step under torch.profiler (idle share, the optimizer's range)."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import lm_archs, training
    from repro_torch.data import TokenPipeline
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer as opt, steps
    cfg = training.adapt_lm_cfg(dataclasses.replace(
        getattr(lm_archs, TRAIN_LM)(), n_layers=TRAIN_LAYERS))
    sh = training.LM_TRAIN_SHAPES["train_4k"]
    reduced = [f"{TRAIN_LAYERS} of 48 layers (f32 masters, gradients and "
               f"AdamW moments of 48 layers need 236 GB)",
               f"B {TRAIN_B} in place of {sh['batch']}",
               f"random weights from seed {seed}; tokens from TokenPipeline"]
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed)
    model = tr.Transformer(cfg, device=dev, generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    st = opt.init_state(model)
    step = steps.make_train_step(
        lambda m, b: tr.lm_loss_chunked(m, b["tokens"],
                                        chunk=training.LM_LOSS_CHUNK),
        training.OPT_CFG, training.LM_MICROBATCHES,
        training.lm_cast_dtype(cfg))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_B, sh["seq"], seed)
    before = sample_entries(model, 65536, seed)
    launched = {n: c.count for n, c in counters.items()}
    times, losses, norms = [], [], []
    for i in range(1 + TRAIN_TIMED):
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(model, st, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            fail(f"train (b) step {i}: loss {losses[-1]}, grad norm "
                 f"{norms[-1]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {n: c.count - launched[n] for n, c in counters.items()}
    if any(launches.values()):
        fail(f"train (b): a step launched the port's kernels {launches}")
    changed = check_changed("train (b)", model, before)
    step_s = sum(times[1:]) / TRAIN_TIMED
    tokens = TRAIN_B * sh["seq"]
    flops = train_flops(cfg, TRAIN_B, sh["seq"])
    prof = profile_call(lambda: step(model, st, pipe.batch_at(9)),
                        "train_step", out_dir=None,
                        ranges=(steps.UPDATE_RANGE,), groups=TRAIN_GROUPS)
    upd = (prof.get("range_ms") or {}).get(steps.UPDATE_RANGE)
    att = train_attention_ms(cfg, dev, seed)
    # a layer's attention runs forward twice (the step's and the layer's
    # remat) and backward once (which recomputes its tiles) a microbatch
    att["step_share"] = (cfg.n_layers * training.LM_MICROBATCHES
                         * (att["forward_ms"] + att["forward_backward_ms"])
                         / 1e3 / step_s)
    rec = {"config": f"{TRAIN_LM} (hf:Qwen/Qwen2.5-14B) d {cfg.d_model}, "
                     f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
                     f"{cfg.d_ff}, vocab {cfg.vocab_size}, QKV bias",
           "reduced": reduced, "params": n_params, "B": TRAIN_B,
           "S": sh["seq"], "microbatches": training.LM_MICROBATCHES,
           "loss_chunk": training.LM_LOSS_CHUNK,
           "grouped_attention": cfg.attn_grouped,
           "first_step_s": times[0], "step_s": times[1:],
           "mean_step_s": step_s, "tokens_per_s": tokens / step_s,
           "peak_gb": peak, "losses": losses, "grad_norms": norms,
           "min_changed_share": changed, "kernel_launches": launches,
           "flops": flops, "tflops_per_s": flops["total"] / step_s / 1e12,
           "profile": prof, "attention": att,
           "optimizer_share": (upd / prof["device_busy_ms"]
                               if upd and prof.get("device_busy_ms")
                               else None)}
    if prof.get("group_ms") and prof.get("device_busy_ms"):
        rec["group_shares"] = {k: v / prof["device_busy_ms"]
                               for k, v in prof["group_ms"].items()}
    print(f"train (b) [{card_line()}] {rec['config']}; {n_params / 1e9:.3f}"
          f" B parameters; reduced: {'; '.join(reduced)}")
    print(f"train (b): step {step_s:.3f} s (first {times[0]:.3f} s), "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB, "
          f"{rec['tflops_per_s']:.1f} TFLOP/s by the count "
          f"{flops['total']:.4g} FLOP a step (matmuls "
          f"{flops['matmuls']:.4g}, remat {flops['remat_forward']:.4g}, "
          f"loss recompute {flops['loss_recompute']:.4g}, attention "
          f"{flops['attention']:.4g}); losses {losses}; kernel launches a "
          f"step 0; idle share {prof.get('idle_share')}; optimizer share "
          f"of device time {rec['optimizer_share']}; kernel groups' shares "
          f"{rec.get('group_shares')}")
    print(f"train (b): the plain attention at a microbatch's shape "
          f"{att['shape']}: forward {att['forward_ms']:.2f} ms, forward + "
          f"backward {att['forward_backward_ms']:.2f} ms (about "
          f"{att['step_share']:.3f} of the step); "
          f"scaled_dot_product_attention forward + backward "
          f"{att['sdpa_forward_backward_ms']:.2f} ms")
    del model, st, step, before
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_attention_ms(cfg, dev, seed) -> dict:
    """The plain training attention (``layers.flash_attention``, grouped)
    alone at one microbatch of path 10 (b): its forward with gradients on
    (tiles under checkpoint) and its forward + backward, events around 3
    calls each; ``scaled_dot_product_attention`` forward + backward on the
    same bf16 operands as the library yardstick."""
    import torch
    from torch.nn import functional as F
    from repro_torch.configs import training
    from repro_torch.models import layers
    b = TRAIN_B // training.LM_MICROBATCHES
    s = training.LM_TRAIN_SHAPES["train_4k"]["seq"]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)

    def leaf(heads):
        return torch.randn((b, s, heads, dh), generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_()
    q, k, v = leaf(h), leaf(kh), leaf(kh)
    w = torch.randn((b, s, h, dh), generator=g, device=dev,
                    dtype=torch.bfloat16)

    def fwd():
        return layers.flash_attention(q, k, v, causal=True,
                                      q_block=cfg.q_block,
                                      k_block=cfg.k_block, grouped=True)

    def fwd_bwd():
        torch.autograd.grad((fwd() * w).float().sum(), (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        torch.autograd.grad((o.transpose(1, 2) * w).float().sum(), (q, k, v))
    out = {"shape": (b, s, h, kh, dh), "forward_ms": cuda_ms(fwd, 3, 1),
           "forward_backward_ms": cuda_ms(fwd_bwd, 3, 1),
           "sdpa_forward_backward_ms": cuda_ms(sdpa, 3, 1)}
    del q, k, v, w
    return out


def train_supervisor(dev) -> dict:
    """Path 10 (c): ``launch.train.main`` on TRAIN_PRESET for TRAIN_STEPS
    steps (the loss must fall), then ``train_loop`` on the same preset
    twice, with a failure injected one step after a checkpoint (one
    restart, a replay from that checkpoint) and uninterrupted: the losses
    agree step by step within TRAIN_LOOP_REL.  Checkpoints go to a
    temporary directory, removed after."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import CheckpointManager, LoopConfig, train_loop
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t = time.perf_counter()
        rep = launch_train.main([
            "--preset", TRAIN_PRESET, "--steps", str(TRAIN_STEPS),
            "--device", "cuda", "--ckpt-dir", f"{tmp}/main",
            "--ckpt-every", str(TRAIN_STEPS // 2)])
        out["main_s"] = time.perf_counter() - t
        if not rep.losses[-1] < rep.losses[0]:
            fail(f"train (c): the loss did not fall ({rep.losses[0]} -> "
                 f"{rep.losses[-1]})")
        out["main_losses"] = (rep.losses[0], rep.losses[-1])
        cfg = LoopConfig(n_steps=TRAIN_LOOP_STEPS, ckpt_every=TRAIN_CKPT)
        fired = []

        def inject(step):
            if step == TRAIN_CKPT + 1 and not fired:
                fired.append(step)
                raise RuntimeError(f"injected failure at step {step}")
        reports = []
        for tag, injector in (("failed", inject), ("clean", None)):
            state, step_fn, batch_at = launch_train.build(
                TRAIN_PRESET, 8, 128, 3e-4, TRAIN_LOOP_STEPS, device=dev)
            reports.append(train_loop(
                state, step_fn, batch_at, CheckpointManager(f"{tmp}/{tag}"),
                cfg, failure_injector=injector))
        failed, clean = reports
        if failed.restarts != 1 or clean.restarts != 0:
            fail(f"train (c): restarts {failed.restarts} and "
                 f"{clean.restarts}, not 1 and 0")
        if len(failed.losses) != TRAIN_LOOP_STEPS + 1:
            fail(f"train (c): {len(failed.losses)} losses, not one replay")
        # the restart restored step TRAIN_CKPT and replayed it
        replay = failed.losses[TRAIN_CKPT + 1]
        merged = failed.losses[:TRAIN_CKPT + 1] + \
            failed.losses[TRAIN_CKPT + 2:]
        worst = 0.0
        for i, (a, b) in enumerate([(replay, failed.losses[TRAIN_CKPT])]
                                   + list(zip(merged, clean.losses))):
            rel = abs(a - b) / abs(b)
            worst = max(worst, rel)
            if rel > TRAIN_LOOP_REL:
                fail(f"train (c): losses {a!r} and {b!r} differ by {rel:.3g}"
                     f" (pair {i})")
        out.update(restarts=failed.restarts, max_rel_diff=worst,
                   resumed_step=TRAIN_CKPT, losses_failed=failed.losses,
                   losses_clean=clean.losses)
    print(f"train (c): {TRAIN_PRESET} {TRAIN_STEPS} steps through "
          f"launch.train in {out['main_s']:.1f} s, loss "
          f"{out['main_losses'][0]:.3f} -> {out['main_losses'][1]:.3f}; a "
          f"failure at step {TRAIN_CKPT + 1} restored step {TRAIN_CKPT} "
          f"(1 restart), losses within {worst:.3g} of the clean run")
    return out


def train_step_timed(name, model, loss_fn, batch, before_seed) -> dict:
    """Two steps of ``make_train_step`` (OPT_CFG): finite loss and grad
    norm, every parameter changed; the second step timed."""
    import math
    import torch
    from repro_torch.configs import training
    from repro_torch.train import optimizer as opt, steps
    before = sample_entries(model, 65536, before_seed)
    st = opt.init_state(model)
    step = steps.make_train_step(loss_fn, training.OPT_CFG)
    batch = steps.to_device(batch, st.step.device)
    rec = {}
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(model, st, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            fail(f"train (d) {name} step {i}: loss {loss}, grad norm {norm}")
        rec["first_ms" if i == 0 else "step_ms"] = ms
        rec.setdefault("losses", []).append(loss)
    rec["min_changed_share"] = check_changed(f"train (d) {name}", model,
                                             before)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return rec


def train_published(args, dev) -> dict:
    """Path 10 (d): DIN and DLRM RM-2 at ``train_batch`` (B 65,536), SASRec
    and two-tower at TRAIN_INBATCH_B (their (B, B) logits), the two-tower
    and DLRM tables cut to TRAIN_RECSYS_ROWS, and the GAT at
    TRAIN_GNN_SHAPES, each at its published width from seeded weights."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import gnn_archs, recsys_archs
    from repro_torch.models import GAT, gnn
    from repro_torch.models import recsys as rs
    out = {}
    full_b = recsys_archs.RECSYS_SHAPES["train_batch"]["batch"]
    for name in ("din", "dlrm-rm2", "sasrec", "two-tower-retrieval"):
        cfg = recsys_archs.ARCHS[name][0]()
        rows = TRAIN_RECSYS_ROWS.get(name)
        reduced = []
        if rows is not None:
            fields = ("user_vocab", "item_vocab") if hasattr(
                cfg, "item_vocab") else ("vocab",)
            reduced.append(f"{rows:,} rows a table, not "
                           f"{getattr(cfg, fields[0]):,}")
            cfg = dataclasses.replace(cfg, **{f: rows for f in fields})
        b = TRAIN_INBATCH_B if name in ("sasrec", "two-tower-retrieval") \
            else full_b
        if b != full_b:
            reduced.append(f"B {b:,}, not {full_b:,} (the (B, B) in-batch "
                           f"logits)")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        batch = recsys_pipeline(cfg, b, 0, args.seed)
        draw_s = time.perf_counter() - t
        model = rs.MODELS[name][1](cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.seed))
        rec = train_step_timed(name, model, rs.recsys_loss, batch, args.seed)
        rec.update(B=b, reduced=reduced, draw_s=draw_s,
                   params=sum(p.numel() for p in model.parameters()))
        print(f"train (d) [{card_line()}] {name}: B {b}, "
              f"{rec['params'] / 1e6:.1f} M parameters, step "
              f"{rec['step_ms']:.2f} ms (first {rec['first_ms']:.2f}), peak "
              f"{rec['peak_gb']:.2f} GB, losses {rec['losses']}; reduced: "
              f"{'; '.join(reduced) or 'none'}")
        out[name] = rec
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    rng = np.random.default_rng(args.seed)
    for shape in TRAIN_GNN_SHAPES:
        sh = gnn_archs.GNN_SHAPES[shape]
        torch.cuda.reset_peak_memory_stats()
        feats, src, dst, graph_of, _ = gnn_graph(shape, sh, args.seed)
        cfg = dataclasses.replace(gnn_archs.gat_cora(), d_in=sh["d_feat"])
        model = GAT(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.seed))
        batch = {"feats": feats, "src": src, "dst": dst}
        if sh["kind"] == "pooled":
            n = sh["n_graphs"]
            batch.update(graph_of=graph_of, labels=rng.integers(
                0, cfg.n_classes, n).astype(np.int32))

            def loss_fn(m, b, n=n):
                return gnn.pooled_loss(m, b["feats"], b["src"], b["dst"],
                                       b["graph_of"], b["labels"], n)
        else:
            batch["labels"] = rng.integers(0, cfg.n_classes,
                                           len(feats)).astype(np.int32)

            def loss_fn(m, b):
                return gnn.loss_fn(m, b["feats"], b["src"], b["dst"],
                                   b["labels"])
        rec = train_step_timed(f"gat {shape}", model, loss_fn, batch,
                               args.seed)
        rec.update(nodes=len(feats), edges=len(src))
        print(f"train (d) [{card_line()}] gat {shape}: {len(feats)} nodes,"
              f" {len(src)} edges, step {rec['step_ms']:.2f} ms (first "
              f"{rec['first_ms']:.2f}), peak {rec['peak_gb']:.2f} GB, "
              f"losses {rec['losses']}")
        out[f"gat_{shape}"] = rec
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_compressed(dev, seed) -> dict:
    """Path 10 (e): ``make_compressed_dp_step`` (qwen25_smoke, f32) on a
    one-rank NCCL group (``make_host_mesh`` over the card, every
    collective a real NCCL call) against the same step on the CPU in a
    one-rank gloo group: loss and residuals within TRAIN_TOL * |x| +
    TRAIN_TOL, the parameters by ``hold_params``, whose marked entries
    here also take the code ties (the CPU's (g + r) / scale within
    TRAIN_CODE_TIE of a half: the card may round that code the other
    way)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import lm_archs
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Transformer
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer as opt, steps
    cfg = dataclasses.replace(lm_archs.qwen25_smoke(), q_block=16,
                              k_block=32)
    base = Transformer(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    batch = TokenPipeline(cfg.vocab_size, 4, 64, seed).batch_at(0)
    ocfg = opt.AdamWConfig(**TRAIN_SMOKE_OPT)

    def loss_fn(m, b):
        return tr.lm_loss(m, b["tokens"])

    def run(device, backend):
        pg = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        dist.init_process_group(backend, init_method=f"file://{pg}/init",
                                world_size=1, rank=0)
        try:
            mesh = make_host_mesh(device=device)
            model = Transformer(cfg, device=mesh.device, init=False)
            model.load_state_dict(base.state_dict())
            st, res = opt.init_state(model), opt.init_residual(model)
            step = steps.make_compressed_dp_step(loss_fn, ocfg, mesh,
                                                 dp_axes=("data",))
            _, _, _, m = step(model, st, res, batch)
            return model, res, m
        finally:
            dist.destroy_process_group()
            shutil.rmtree(pg, ignore_errors=True)

    cpu, res_c, mc = run("cpu", "gloo")
    card, res_g, mg = run("cuda", "nccl")
    _, g = steps.value_and_grad(loss_fn, base, batch)
    marked = near_zero(g)
    ties = 0
    for n, t in g.items():
        x = t.float()
        q = x / torch.clamp(x.abs().max() / 127.0, min=1e-12)
        tie = ((q.abs() - q.abs().floor()) - 0.5).abs() < TRAIN_CODE_TIE
        ties += int(tie.sum())
        marked[n] = marked[n] | tie
    rec = {"loss": check_close("train (e) compressed step loss, NCCL card "
                               "vs gloo CPU", mg["loss"].reshape(1).cpu(),
                               mc["loss"].reshape(1), TRAIN_TOL, TRAIN_TOL),
           "params": hold_params("train (e) compressed step params", card,
                                 cpu, marked, float(mc["lr"])),
           "code_ties": ties}
    worst = 0.0
    for n, r in res_c.items():
        ok = ~marked[n]
        diff = (res_g[n].cpu() - r).abs()
        over = (diff > TRAIN_TOL * r.abs() + TRAIN_TOL) & ok
        if bool(over.any()):
            fail(f"train (e): residual {n} differs at {int(over.sum())} "
                 f"entries, max {float(diff[ok].max()):.3g}")
        worst = max(worst, float(diff[ok].max()) if bool(ok.any()) else 0.0)
    rec["residual"] = worst
    print(f"train (e): compressed step on one NCCL rank = one gloo rank on "
          f"the CPU (loss {float(mc['loss']):.6f}, params max |diff| "
          f"{rec['params']:.3g}, residual {worst:.3g}; {ties} code ties)")
    return rec


def run_train(args, dev, start_path, end_path, counters) -> dict:
    """Path 10: training on the card, (a) to (e)."""
    import torch
    t_path = time.perf_counter()
    out = {"card": card_line()}
    start_path()
    t = time.perf_counter()
    out["card_vs_cpu"] = train_card_vs_cpu(dev, args.seed)
    out["a_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["qwen25_14b"] = train_lm_full(dev, args.seed, counters)
    out["b_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["supervisor"] = train_supervisor(dev)
    out["c_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["published"] = train_published(args, dev)
    out["d_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["compressed"] = train_compressed(dev, args.seed)
    out["e_s"] = time.perf_counter() - t
    out["launches"] = end_path("train", ())
    if any(out["launches"].values()):
        fail("train: the training path launched a kernel of the port")
    gc.collect()
    torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t_path
    print(f"train path: (a) {out['a_s']:.1f} s, (b) {out['b_s']:.1f} s, "
          f"(c) {out['c_s']:.1f} s, (d) {out['d_s']:.1f} s, (e) "
          f"{out['e_s']:.1f} s")
    return out


def cell_build(name, shape, mesh):
    """The registry's cell as path 11 runs it: LM cells at CELL_LAYERS
    layers, the engine at CELL_ENGINE."""
    from repro_torch import configs
    spec = configs.get_arch(name)
    kw = ({"engine_overrides": CELL_ENGINE} if name == "quake-ann"
          else {"layers": CELL_LAYERS} if spec.family == "lm" else {})
    return spec.build(shape, mesh, **kw)


def capture_kernels(mods):
    """Patch each (module, wrapper name) of ``mods`` to keep the operands
    and output of its first call; returns (captured, restore)."""
    captured = {}
    saved = []
    for mod, attr in mods:
        real = getattr(mod, attr)

        def wrap(*a, _real=real, _key=attr, **kw):
            out = _real(*a, **kw)
            captured.setdefault(_key, (a, kw, out))
            return out
        saved.append((mod, attr, real))
        setattr(mod, attr, wrap)

    def restore():
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return captured, restore


def hold_cell_kernels(name, captured) -> dict:
    """Each kernel a cell launched, held against its plain version on the
    operands of its first call there."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_topk as st
    from repro_torch.kernels import scan_topk_indexed as sti
    held = {}
    for key, (a, kw, out) in captured.items():
        label = f"{name} {key.replace('_cuda', '')}"
        if key == "scan_topk_indexed_cuda":
            held[key] = compare_topk(label, *out,
                                     *sti.scan_topk_indexed_plain(*a, **kw))
        elif key == "scan_topk_cuda":
            q, xs = a[0][:CELL_PLAIN_Q], a[1]
            rest = a[2:]
            d_p, i_p = st.scan_topk_plain(q, xs, *rest, **kw)
            held[key] = compare_topk(label, out[0][:CELL_PLAIN_Q],
                                     out[1][:CELL_PLAIN_Q], d_p, i_p)
        elif key == "kmeans_assign_cuda":
            held[key] = hold_assign(ka, label, *a)[:2]
        elif key == "flash_attention_cuda":
            # within one bf16 ulp of each (query, head) row's largest
            # output: both round p to bf16 before the PV product, and a
            # score that differs in its last f32 bit rounds one p the
            # other way, moving the whole row by that p's share of its
            # values (at 32k keys it exceeds one ulp of a small entry)
            bq, bk = fa.TILES[a[0].dtype]
            o_p = fa.flash_attention_plain(*a, q_block=bq, k_block=bk, **kw)
            o_k, o_p = out.double(), o_p.double()
            tol = FLASH_BF16_REL * o_p.abs().amax(-1, keepdim=True) \
                + FLASH_BF16_ABS
            diff = (o_k - o_p).abs()
            if not bool(torch.isfinite(o_k).all()) or bool((diff > tol)
                                                           .any()):
                fail(f"{label}: {int((diff > tol).sum())} entries beyond "
                     f"2^-7 * max|row| + {FLASH_BF16_ABS:g}")
            held[key] = (float(diff.max()), float(tol.max()))
            print(f"{label}: max |diff| {held[key][0]:.3g} (bound 2^-7 * "
                  f"max|row| + {FLASH_BF16_ABS:g})")
        torch.cuda.synchronize()
    return held


def run_cells(args, dev, start_path, end_path, counters) -> dict:
    """Path 11: the registry's cells.  The dry-run of every (arch x shape)
    cell on both production meshes runs in a subprocess while rank 0 of
    the 16 x 16 mesh runs CELL_RUNS on the card: each cell counted on meta
    at the depth it runs, its arguments drawn from the seed, one warm and
    one timed call; gates: every dry-run cell counted, memory growth
    within max(10%, 0.5 GB) of the count, finite outputs, each kernel a
    cell launched held against its plain version on the rank's own
    operands, a cell that does not fit not run."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_topk as st
    from repro_torch.kernels import scan_topk_indexed as sti
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.count import tensors_of
    t_path = time.perf_counter()
    out = {"card": card_line(), "cells": {}}
    dry_json = OUT_DIR / "dryrun.json"
    dry_log = open(OUT_DIR / "dryrun.log", "w")
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS), "--out", str(dry_json)],
        stdout=dry_log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
    try:
        meta_mesh = make_production_mesh(False)
        card_mesh = make_production_mesh(False, device=dev)
        mods = ((sti, "scan_topk_indexed_cuda"), (st, "scan_topk_cuda"),
                (ka, "kmeans_assign_cuda"), (fa, "flash_attention_cuda"))
        start_path()
        for name, shape in CELL_RUNS:
            key = f"{name}/{shape}"
            t0 = time.perf_counter()
            cell = cell_build(name, shape, meta_mesh)
            res = analyze(cell.count(), meta_mesh, arch=name, shape=shape)
            count_s = time.perf_counter() - t0
            row = {"count_gb": res["bytes_per_device_gb"],
                   "count_tf": res["flops_per_device_tf"],
                   "t_compute_ms": res["t_compute_ms"],
                   "t_memory_ms": res["t_memory_ms"],
                   "reduced": cell.reduced, "count_s": count_s,
                   "description": cell.description}
            out["cells"][key] = row
            if not res["fits"]:
                print(f"cells {key}: the count says it does not fit "
                      f"({res['bytes_per_device_gb']:.2f} GB): not run")
                continue
            run = cell_build(name, shape, card_mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            a = run.materialize(dev, torch.Generator(device=dev).manual_seed(
                args.seed))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = {n: c.count for n, c in counters.items()}
            res_out = run.fn(*a)
            torch.cuda.synchronize()
            del res_out
            res_out, ms = timed(lambda: run.fn(*a))
            grew = torch.cuda.max_memory_allocated() - base
            row["launches"] = {n: c.count - before[n]
                               for n, c in counters.items()}
            for t in tensors_of(res_out):
                if t.is_floating_point() and not bool(
                        torch.isfinite(t).all()):
                    fail(f"cells {key}: non-finite outputs")
            del res_out
            count_b = res["bytes_per_device_gb"] * 1e9
            row.update(card_gb=grew / 1e9, ms=ms,
                       tflops=res["flops_per_device_tf"] / (ms / 1e3)
                       if ms else None)
            print(f"cells {key}: count {row['count_gb']:.3f} GB, card "
                  f"{row['card_gb']:.3f} GB, {ms:.2f} ms a step, "
                  f"{row['count_tf']:.4f} TF counted ({row['tflops']:.2f} "
                  f"TFLOP/s; compute term by dtype "
                  f"{row['t_compute_ms']:.2f} ms, memory term unfused "
                  f"{row['t_memory_ms']:.2f} ms), launches "
                  f"{row['launches']}, counted in {count_s:.1f} s")
            if abs(grew - count_b) > max(CELL_MEM_REL * count_b,
                                         CELL_MEM_ABS):
                fail(f"cells {key}: the card's memory {grew / 1e9:.3f} GB "
                     f"is not within max(10%, 0.5 GB) of the count "
                     f"{count_b / 1e9:.3f} GB")
            # the kernels against their plain versions on this rank's
            # operands: one more call, captured, outside the measurement
            if any(row["launches"].values()):
                captured, restore = capture_kernels(mods)
                try:
                    held = uncounted(counters, lambda: run.fn(*a))
                    del held
                finally:
                    restore()
                row["held"] = uncounted(counters, lambda: hold_cell_kernels(
                    key, captured))
                del captured
            del a, run, cell
        out["launches"] = end_path("cells", ("scan_topk_indexed",
                                             "scan_topk", "kmeans_assign",
                                             "flash_attention"))
        out["card_s"] = time.perf_counter() - t_path
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - out["card_s"]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        dry_log.close()
    if rc != 0 or not dry_json.exists():
        fail(f"cells: the dry-run exited {rc} (chiprun_out/chip_smoke/"
             f"dryrun.log)")
    dry = json.loads(dry_json.read_text())
    bad = [k for k, v in dry.items() if "error" in v]
    if len(dry) != 88 or bad:
        fail(f"cells: {len(dry)} dry-run cells, failed {bad}")
    no_fit = [k for k, v in dry.items() if not v["fits"]]
    print(f"cells: the dry-run counted all {len(dry)} (cell, mesh) pairs; "
          f"cells that do not fit: {no_fit or 'none'}")
    for k, v in dry.items():
        print(f"  dryrun {k}: {v['bytes_per_device_gb']:.2f} GB, "
              f"{v['flops_per_device_tf']:.3f} TF, {v['collective_gb']:.3f} "
              f"GB on the wire, dominant {v['dominant']} (compute by "
              f"dtype {v['t_compute_ms']:.3f} ms, memory unfused "
              f"{v['t_memory_ms']:.3f} ms)")
    out["dryrun"] = {"pairs": len(dry), "no_fit": no_fit}
    gc.collect()
    torch.cuda.empty_cache()
    out["path_s"] = time.perf_counter() - t_path
    return out


# ---------------------------------------------------------------------------
# path 12: the port's examples, the indexed scans at embedding widths,
# k-means++
# ---------------------------------------------------------------------------

def finite_numbers(name, res) -> None:
    """Every number of an example's result (nested dicts and lists) is
    finite."""
    import math
    vals = [res]
    while vals:
        v = vals.pop()
        if isinstance(v, dict):
            vals.extend(v.values())
        elif isinstance(v, (list, tuple)):
            vals.extend(v)
        elif isinstance(v, float) and not math.isfinite(v):
            fail(f"{name}: a non-finite number in its result")


def run_examples_default(dev) -> dict:
    """Path 12 (a): the four examples' ``run()`` at their own defaults."""
    from repro_torch.examples import (dynamic_workload, quickstart,
                                      retrieval_serving, train_lm)
    out = {}
    t = time.perf_counter()
    qs = quickstart.run(device=dev)
    del qs["index"], qs["dataset"]
    finite_numbers("quickstart", qs)
    for key in ("recall", "recall_after"):
        if qs[key] < APS_RECALL_MIN:
            fail(f"quickstart: {key} {qs[key]:.3f} < {APS_RECALL_MIN}")
    out["quickstart"] = dict(qs, wall_s=time.perf_counter() - t)
    t = time.perf_counter()
    dyn = dynamic_workload.run(device=dev)
    finite_numbers("dynamic_workload", dyn)
    out["dynamic_workload"] = dict(dyn, wall_s=time.perf_counter() - t)
    t = time.perf_counter()
    ret = retrieval_serving.run(device=dev)
    finite_numbers("retrieval_serving", ret)
    out["retrieval_serving"] = dict(ret, wall_s=time.perf_counter() - t)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    try:
        tr = train_lm.run(train_lm.DEFAULT_ARGV + ["--ckpt-dir", ckpt],
                          device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    finite_numbers("train_lm", tr)
    if tr["steps"] != 60 or tr["restarts"]:
        fail(f"train_lm: {tr['steps']} steps, {tr['restarts']} restarts")
    out["train_lm"] = tr
    return out


def run_aps_variants(idx, ds, dev, seed) -> dict:
    """Path 12 (c): per-query ``search`` at tau_rho 0 on the quickstart's
    index, APS-R (the table) and APS-RP (``exact_beta_fn``)."""
    import numpy as np
    import dataclasses
    from repro_torch.core import geometry
    from repro_torch.data import datasets
    q = datasets.queries_near(ds, EX_APS_QUERIES, seed=seed + 7)
    gt = ds.ground_truth(q, 10, device=dev)
    config, table = idx.config, idx._beta_table
    idx.config = dataclasses.replace(config, tau_rho=0.0)
    out = {}
    try:
        for name, tbl in (("APS-R", table),
                          ("APS-RP", geometry.exact_beta_fn(
                              idx.geometry_dim))):
            idx._beta_table = tbl
            t = time.perf_counter()
            rs = [idx.search(q[i], 10, recall_target=0.9,
                             record_stats=False) for i in range(len(q))]
            us = (time.perf_counter() - t) / len(q) * 1e6
            out[name] = {
                "recall": recall_at(np.stack([np.pad(
                    r.ids, (0, 10 - len(r.ids)), constant_values=-1)
                    for r in rs]), gt),
                "us_per_query": us,
                "nprobe": float(np.mean([r.nprobe[0] for r in rs]))}
            print(f"quickstart {name} (tau_rho 0): recall@10 "
                  f"{out[name]['recall']:.4f}, {us:.0f} us a query, mean "
                  f"nprobe {out[name]['nprobe']:.2f}")
    finally:
        idx.config, idx._beta_table = config, table
    gap = out["APS-R"]["recall"] - out["APS-RP"]["recall"]
    if abs(gap) > EX_APS_RP_GAP:
        fail(f"APS-RP recall {out['APS-RP']['recall']:.4f} is not within "
             f"{EX_APS_RP_GAP} of APS-R's {out['APS-R']['recall']:.4f}")
    return out


def wide_embeddings(n, d, n_clusters, power, seed, dev):
    """(n, d) f32 rows on ``dev`` with the structure of path 1's mixture
    (``datasets.clustered``: centres of scale 6, cluster sizes
    proportional to i^-power, spreads 0.5-1.5) drawn in WIDE_LATENT
    dimensions and mapped to ``d`` by a seeded Gaussian projection, plus
    noise of 0.05 a coordinate: embeddings of a low intrinsic dimension,
    as real ones are.  (An isotropic mixture drawn in d = 3,072 itself
    makes Lloyd's centroids of mixed clusters, whose small norms pull in
    every far point: one partition took 84,000 of 200,000 rows.)"""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = WIDE_LATENT
    centers = torch.randn((n_clusters, lat), generator=g, device=dev) * 6.0
    w = 1.0 / torch.arange(1, n_clusters + 1, device=dev,
                           dtype=torch.float64) ** power
    cid = torch.multinomial(w / w.sum(), n, replacement=True, generator=g)
    scale = 0.5 + torch.rand((n_clusters,), generator=g, device=dev)
    z = centers[cid] + torch.randn((n, lat), generator=g, device=dev) \
        * scale[cid, None]
    proj = torch.randn((lat, d), generator=g, device=dev) / lat ** 0.5
    x = z @ proj
    x += 0.05 * torch.randn((n, d), generator=g, device=dev)
    return x


def sub_plan(sel, qmask, nq):
    """The first ``nq`` queries' part of a plan: their rows of ``qmask``
    and the union slots some of them select."""
    import torch
    used = torch.nonzero(qmask[:nq].any(0)).reshape(-1)
    return (sel.index_select(0, used).contiguous(),
            qmask[:nq].index_select(1, used).contiguous())


def hold_wide_f32(name, sti, data, valid, sel, qmask, qc, kp) -> dict:
    """The f32/bf16 indexed scan held against its plain version on the
    first WIDE_HOLD_Q queries' part of the plan, then timed at the whole
    batch beside its bound."""
    import torch
    from repro_torch.kernels import build
    b, d = qc.shape
    sel_h, qmask_h = sub_plan(sel, qmask, WIDE_HOLD_Q)
    qh = qc[:WIDE_HOLD_Q].contiguous()
    dk, ik = sti.scan_topk_indexed_cuda(qh, data, valid, sel_h, qmask_h,
                                        k_pad=kp)
    dp, ip_ = sti.scan_topk_indexed_plain(qh, data, valid, sel_h, qmask_h,
                                          k_pad=kp)
    err, tol = compare_topk(name, dk, ik, dp, ip_,
                            (TOL_REL * (d / 128) ** 0.5, TOL_ABS))
    del dk, ik, dp, ip_

    def kern():
        return sti.scan_topk_indexed_cuda(qc, data, valid, sel, qmask,
                                          k_pad=kp)
    ms = cuda_ms(kern)
    nrows = sti.live_rows(valid)
    sel_l = sel.long()
    rows_read = int(nrows[torch.unique(sel_l)].sum())
    active = int((qmask.sum(dim=0).long() * nrows[sel_l].long()).sum())
    u = int(sel.shape[0])
    elem = data.element_size()
    bound_ms, bound_by = build.bound(
        rows_read * d * elem + b * d * elem + 2 * b * kp * 4 + b * u
        + rows_read, 2.0 * active * d, build.F32_FLOPS_PER_S)
    where = sti._placement("bf16" if elem == 2 else "f32", d, kp,
                           torch.cuda.current_device())
    row = {"d": d, "B": b, "U": u, "S": int(data.shape[1]), "k_pad": kp,
           "max_abs_err": err, "tol": tol, "ms": ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "rows_read": rows_read,
           "held_U": int(sel_h.shape[0]), "placement": where}
    print(f"{name}: err {err:.3g} (tol {tol:.3g}), {ms:.4f} ms at B {b}, "
          f"U {u}, S {row['S']}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"placement {where}")
    return row


def hold_wide_q8(name, sti, q_dev, codes, scales, cents, valid, sel, qmask,
                 kp) -> dict:
    """The q8 scan bit-equal to its plain version on the first
    WIDE_HOLD_Q queries' part of the plan, then timed at the whole batch
    beside its bound."""
    import torch
    from repro_torch.kernels import build, ref
    b, d = q_dev.shape
    sel_h, qmask_h = sub_plan(sel, qmask, WIDE_HOLD_Q)
    ops_h = ref.q8_scan_operands(q_dev[:WIDE_HOLD_Q], codes, scales, valid,
                                 sel_h, "l2", cents)
    part = (*ops_h[:2], codes, scales, *ops_h[2:], valid, sel_h, qmask_h)
    dk, ik = sti.scan_topk_indexed_q8_cuda(*part, k_pad=kp)
    dp, ip_ = sti.scan_topk_indexed_q8_plain(*part, k_pad=kp)
    hold_bit_equal(name, dk, ik, dp, ip_)
    del dk, ik, dp, ip_, part, ops_h
    ops_ = ref.q8_scan_operands(q_dev, codes, scales, valid, sel, "l2",
                                cents)
    full = (*ops_[:2], codes, scales, *ops_[2:], valid, sel, qmask)

    def kern():
        return sti.scan_topk_indexed_q8_cuda(*full, k_pad=kp)
    ms = cuda_ms(kern)
    nrows = sti.live_rows(valid)
    sel_l = sel.long()
    rows = int(nrows[torch.unique(sel_l)].sum())
    active = int((qmask.sum(dim=0).long() * nrows[sel_l].long()).sum())
    u = int(sel.shape[0])
    bound_ms, bound_by = build.bound(
        rows * (d + 4 + 4 + 1) + b * (d + 4) + b * u * (4 + 1)
        + 2 * b * kp * 4, 2.0 * active * d, build.INT8_OPS_PER_S)
    where = sti._placement("q8", d, kp, torch.cuda.current_device())
    row = {"d": d, "B": b, "U": u, "S": int(codes.shape[1]), "k_pad": kp,
           "max_abs_err": 0.0, "bit_equal": True, "ms": ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "rows_read": rows,
           "held_U": int(sel_h.shape[0]), "placement": where}
    print(f"{name}: bit-equal, {ms:.4f} ms at B {b}, U {u}, S {row['S']}, "
          f"bound {bound_ms:.4f} ms ({bound_by}), placement {where}")
    return row


def run_wide(args, dev) -> dict:
    """Path 12 (d): the indexed scans at embedding widths past those that
    held the tile's queries whole.  Each storage's executor is dropped
    after its searches and its kernel's check, so one snapshot at a time
    is on the card."""
    import numpy as np
    import torch
    from repro_torch.core import QuakeIndex, get_executor, plan_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels import scan_topk_indexed as sti
    out = {"card": card_line()}
    t = time.perf_counter()
    x_dev = wide_embeddings(WIDE_N, WIDE_D, WIDE_CLUSTERS, args.power,
                            args.seed, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    pick = torch.randint(0, WIDE_N, (WIDE_B,), generator=g, device=dev)
    q_t = x_dev[pick] + 0.1 * torch.randn((WIDE_B, WIDE_D), generator=g,
                                          device=dev)
    x2 = (x_dev * x_dev).sum(1)
    gt = torch.topk(x2[None, :] - 2.0 * (q_t @ x_dev.T), WIDE_K, dim=1,
                    largest=False).indices.cpu().numpy()
    x = x_dev.cpu().numpy()
    q = q_t.cpu().numpy()
    del x_dev, x2
    out["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    idx = QuakeIndex.build(x, device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    del x
    sizes = idx.levels[0].sizes()
    out["partitions"], out["largest"] = len(sizes), int(sizes.max())
    print(f"wide: {WIDE_N} x {WIDE_D} rows built into {len(sizes)} "
          f"partitions (largest {int(sizes.max())}) in "
          f"{out['build_s']:.1f} s (data {out['data_s']:.1f} s)")
    kp = ops._next_pow2(WIDE_K)
    runs = {}
    for storage in ("f32", "bf16", "int8"):
        for name, kw in (("aps", dict(recall_target=0.9)),
                         ("nprobe32", dict(nprobe=32, rounds=1))):
            for _ in ("cold", "warm"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = idx.search_batch(q, WIDE_K, storage_dtype=storage, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            if not np.isfinite(r.dists[r.ids >= 0]).all() \
                    or r.ids.shape != (WIDE_B, WIDE_K):
                fail(f"wide {storage} {name}: bad result")
            rec = recall_at(r.ids, gt)
            runs[f"{storage}_{name}"] = {
                "recall": rec, "warm_s": wall, "rounds": int(r.rounds),
                "mean_nprobe": float(r.nprobe.mean())}
            print(f"wide search_batch {storage} {name}: recall@{WIDE_K} "
                  f"{rec:.4f}, warm {wall * 1e3:.1f} ms, rounds {r.rounds}, "
                  f"mean nprobe {r.nprobe.mean():.2f}")
        # the kernel on the path's own operands: the batch's APS plan
        ex = get_executor(idx, storage)
        snap = ex.snapshot()
        plan = plan_batch(idx, q, WIDE_K, recall_target=0.9, pages=ex.pages)
        sel = plan.sel_dev.to(torch.int32).contiguous()
        qmask = plan.qmask_dev.contiguous()
        if storage == "int8":
            out["q8"] = hold_wide_q8(
                f"scan_topk_indexed_q8 d={WIDE_D}", sti, q_t, snap.data,
                snap.scales, ex._page_cents, ex._valid, sel, qmask,
                ops._next_pow2(2 * WIDE_K))
        else:
            out[storage] = hold_wide_f32(
                f"scan_topk_indexed {storage} d={WIDE_D}", sti, snap.data,
                ex._valid, sel, qmask, q_t.to(snap.data.dtype), kp)
        del ex, snap
        idx._batch_executors.clear()
        gc.collect()
        torch.cuda.empty_cache()
    out["runs"] = runs
    del idx, plan
    gc.collect()
    torch.cuda.empty_cache()
    # the q8 scan at d = 8,192 on seeded codes
    p, s, d, b, u = WIDE_Q8
    g = torch.Generator(device=dev).manual_seed(args.seed + 2)
    cents = torch.randn((p, d), generator=g, device=dev) * 4
    codes = torch.randint(-127, 128, (p, s, d), generator=g, device=dev,
                          dtype=torch.int8)
    scales = 0.01 + 0.02 * torch.rand((p, s), generator=g, device=dev)
    valid = torch.rand((p, s), generator=g, device=dev) < 0.9
    sel = torch.randperm(p, generator=g, device=dev)[:u].to(torch.int32)
    qmask = torch.rand((b, u), generator=g, device=dev) < 0.5
    q8q = cents[sel[torch.randint(0, u, (b,), generator=g,
                                  device=dev)].long()] \
        + torch.randn((b, d), generator=g, device=dev)
    out["q8_8192"] = hold_wide_q8(f"scan_topk_indexed_q8 d={d}", sti, q8q,
                                  codes, scales, cents, valid, sel, qmask,
                                  ops._next_pow2(2 * WIDE_K))
    return out


def run_kmeanspp(args, dev) -> dict:
    """Path 12 (e): k-means++ seeding (host) and Lloyd steps on the card,
    against the random seeding."""
    import numpy as np
    import torch
    from repro_torch.core import kmeans
    from repro_torch.data import datasets
    n, d, k = KPP
    x = datasets.clustered(n, d, n_clusters=10 * k, power=args.power,
                           seed=args.seed + 3).vectors
    t = time.perf_counter()
    kmeans._kmeanspp_init(x, k, np.random.default_rng(args.seed))
    out = {"seeding_s": time.perf_counter() - t}
    x_dev = torch.as_tensor(x, device=dev, dtype=torch.float64)
    for init in ("pp", "random"):
        t = time.perf_counter()
        c, a = kmeans.kmeans(x, k, iters=10, seed=args.seed, init=init,
                             device=dev)
        wall = time.perf_counter() - t
        c_dev = torch.as_tensor(c, device=dev, dtype=torch.float64)
        obj = float(((x_dev - c_dev[torch.as_tensor(a, device=dev).long()])
                     ** 2).sum())
        out[init] = {"objective": obj, "wall_s": wall}
    ratio = out["pp"]["objective"] / out["random"]["objective"]
    out["ratio"] = ratio
    print(f"k-means++ on {n} x {d}, k {k}: seeding {out['seeding_s']:.2f} s "
          f"(host), objective after 10 Lloyd steps {out['pp']['objective']:.6g}"
          f" against random seeding's {out['random']['objective']:.6g} "
          f"(ratio {ratio:.4f})")
    if ratio > KPP_SLACK:
        fail(f"k-means++ objective {ratio:.4f}x the random seeding's")
    return out


def run_examples(args, dev, start_path, end_path) -> dict:
    """Path 12: (a) the four examples at their defaults, (b) the
    quickstart at the SIFT1M shape, (c) APS-R against APS-RP on its
    index, (d) the indexed scans at widths past the whole-query layout,
    (e) k-means++."""
    import torch
    from repro_torch.examples import quickstart
    t_path = time.perf_counter()
    out = {"card": card_line(), "part_s": {}}

    def part(name, fn):
        t = time.perf_counter()
        res = fn()
        out["part_s"][name] = time.perf_counter() - t
        print(f"examples ({name}) took {out['part_s'][name]:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        return res
    start_path()
    out["defaults"] = part("a", lambda: run_examples_default(dev))
    qs = part("b", lambda: quickstart.run(power=args.power, device=dev,
                                          **EX_SIFT))
    finite_numbers("quickstart at the SIFT1M shape", qs)
    idx, ds = qs.pop("index"), qs.pop("dataset")
    out["sift"] = qs
    out["aps_variants"] = part("c", lambda: run_aps_variants(
        idx, ds, dev, args.seed))
    del idx, ds
    out["wide"] = part("d", lambda: run_wide(args, dev))
    out["kmeanspp"] = part("e", lambda: run_kmeanspp(args, dev))
    out["launches"] = end_path("examples", (
        "scan_topk_indexed", "scan_topk", "kmeans_assign",
        "scan_topk_indexed_q8"))
    out["path_s"] = time.perf_counter() - t_path
    return out


if __name__ == "__main__":
    sys.exit(main())
