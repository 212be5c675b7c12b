#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. device   the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds the quorum-tally, SSD-scan, flash-attention and
              RMSNorm libraries from csrc/, all at once, with ptxas'
              registers and spills per kernel function
     sass     the tensor-core instructions (HMMA, HGMMA) of every kernel
              in ``cuobjdump -sass`` of the built libraries: nonzero for
              the bf16 instances of flash attention and the SSD scan
  3. kernels  each quorum-tally kernel against its plain PyTorch version on
              the card, at the main paths' shapes, the kernel tests' shapes
              and shapes of any K and n (masked_tally's MASKED_CASES and
              tally_votes' TALLY_VOTES_CASES among them, and both at a
              large shape, timed there too): integer outputs equal, sums to
              1e-5 relative, maxima equal, race_card_hist's and the stream
              kernel's sums the same bits over two calls; median
              CUDA-event times of one call of kernel and plain version, the
              kernel's device time per call from torch.profiler (launch and
              fill), and a torch fill's device time at the sweep chunk's
              size (the least a launch takes here); masked_sat at
              MASKED_SAT_CASES, timed at the mixed n=12 table's fast rows
              over a 65,536-trial chunk; sorted_prefix at the fast paths'
              chunks (2,097,152 x 11 values, 65,536 x 12 values and ids),
              timed there beside torch.sort (library_ms)
  4. masked materializing race   engine.race on the mixed n=12 table at
              8192 samples (the masked_tally path, and masked_sat for its
              three saturations), checked bit-identical
              to the cardinality lowering on the table's cardinality rows
              (the tally_decide path: its launch on the kernels line, on
              the 8192 x 12 votes phase 3 checks and times it at)
  5. mixed batch   the 13-system n=12 batch through score_systems at 2*10^6
              trials, chunk 8192 (the fused stream kernel's path on the race,
              masked_sat a chunk on the fast path)
  6. sweep    the 271-system n=11 sweep at 10^7 trials per pass, chunk
              16384, with the sweep's own checks (the race_card_hist path:
              one launch and one fill a race chunk)
  quorum_reached   ops.quorum_reached on the n=11 race's 16384 x 11 votes
              (the tally_votes path), equal to the plain version and to
              tally_decide's reached bits
  experiment  the Experiment API (``repro_torch.api``) on the card: (a)
              the quickstart's three n=11 systems (cardinality, grid,
              weighted) under a 2-way race at 0.2 ms, 20,000 samples
              (masked_tally), its DES run (within 5% on p50, 0.05 on
              P(recovery)) and the n=5 model-check batch (all safe); (b)
              three n=11 cardinality systems at 20,000 samples
              (tally_decide) and 10^6 trials, chunk 65,536
              (race_card_hist); (c) the quickstart at 10^6 trials
              (stream_tally_decide_hist); (d) examples/scenarios/
              diurnal_wan.json and trace_replay.json, loaded unchanged (10^6
              trials, chunk 16384, 3 Markov regimes: masked_tally and
              tally_decide a chunk), occupancy summing to the trials and
              the total the merge of the slices.  Each run again with the
              quorum kernels swapped for their plain versions: integers and
              maxima equal, means to 1e-5; warm wall (median of 3), rate,
              launches, the card's busy and idle share over one traced run
  planner     the search-and-serve planner (``repro_torch.planner``) on the
              card: (1) a cold n=11 cardinality search at 10^6 final
              trials (rungs of 10^5 and 10^6, chunk 16384, seed 0: the
              race_card_hist path), its frontier the direct 271-system
              sweep's at 10^6 trials and its survivors' rows the direct
              rows on every axis, at most 40% of the exhaustive budget;
              (2) the same geometry under another budget and objective:
              answered warm, no launch plan built and no kernel launched;
              (3) the n=11 "all" family (404 systems, 10^5 trials: the
              fused stream kernel) with its peak device memory; (4) the
              weighted family under examples/scenarios/diurnal_wan.json's
              regime workload (masked_tally a chunk); (5) a PlannerServer
              answering two concurrent n=11 queries (10^5 trials, chunk
              16384: one rung materialized, tally_decide) with one search,
              then a repeat warm.  Each query's launches (zeroed before,
              read after, held to those its rungs' batches take), launch
              plans built, wall, rungs, and the card's busy time and idle
              share over a traced cold run
  serve_mamba2_130m   mamba2_130m at full width (24 layers, d_model 768,
              vocab 50280), seeded weights, 4 requests of 1024 prompt
              tokens and 32 greedy decode steps through
              ``repro_torch.launch.serve``: 24 SSD launches per prefill, 49
              RMSNorm launches per pass; kernel path against plain path
              (the kernels' ops swapped for their plain versions: prefill
              logits, every superblock's first SSM state and attention
              cache) and decode against a plain ``forward`` over prompt +
              generated tokens, in f32 to 1e-3 and in bf16 to twice what
              two plain lowerings differ by (see SERVE_F32_TOL); token ids
              in range; prefill ms, decode tok/s, the greedy tokens both
              paths share, the card's idle share, peak memory
  serve_zamba2_2_7b   zamba2_2_7b at full width (54 Mamba2 layers, one
              shared attention + SwiGLU block applied in 9 places, d_model
              2560, vocab 32000, 2.42 G params), the same traffic and
              checks: per prefill 54 SSD, 9 flash-attention and 127 RMSNorm
              launches, 127 RMSNorm launches per decode step; served in
              bf16, every SSD and flash call is the tensor-core instance's
              (its own counters), with f32 compute none is
  serve_musicgen_medium / serve_internvl2_26b   the stub frontends, the
              same traffic and checks: musicgen at full size (48 layers,
              d_model 1536, hd 64, H = KV = 24, 1.36 G params; 1024 bf16
              frame embeddings a request, decode embedding each token
              through head.T): 48 flash and 97 RMSNorm launches a prefill;
              internvl2 at full width cut to 8 of its 48 layers
              (INTERNVL_LAYERS; d_model 6144, hd 128, GQA 48:8, 4.26 G
              params; 1024 bf16 patch embeddings + 1024 tokens, flash at
              S = 2048): 8 flash and 17 RMSNorm launches.  The plain
              forward that decode is held to reads what decode consumed
              (musicgen: frame_emb ++ head.T[generated])
  serve_deepseek_v2_lite_16b   at full width and depth (27 MLA + MoE
              layers, 64 experts top-6 + 2 shared, d_model 2048, vocab
              102400, 16.2 G params), built after the other models are
              freed, the same traffic: 55 RMSNorm launches a prefill and a
              decode step, no flash (MLA is plain products, as in the JAX
              package), no SSD.  MoE capacity is computed from a call's
              tokens, so decode is held to decode with the plain versions
              on the same tokens, not to a forward; the kernel and floor
              runs replay the plain run's routing (``routing``: equal in
              exact arithmetic), and the routing flips of the kernel runs
              routing themselves are counted.  The floor lowering keeps
              MLA's softmax weights in f32.  (c) layer 0's MoE block twice,
              the same bits, its combine the bits of an expert-order
              index_add_.  Every serve phase also holds the dry-run's
              abstract state to the real one: ``abstract_params`` /
              ``abstract_cache`` bytes (a meta build) equal the model's
              parameters' and ``init_cache``'s, and ``init_cache`` grows
              ``memory_allocated()`` by those bytes within the caching
              allocator's block rounding
  deepseek_ep   MoE's expert-parallel branch on that model: a 4 x 1024
              prefill under a 1 x 4 and a 2 x 2 ``ModelMesh`` on the one
              card (ranks one batch slice after another), in f32 held to
              the single-shard prefill (2 x 2: the two batch halves' own,
              whose capacity it takes) to SERVE_F32_TOL with the
              single-shard routing replayed, the flips counted where each
              layout routes itself; RMSNorm launches (55 a prefill); bf16
              prefill ms of each layout beside the single-shard one
  deepseek_mla   (a) a 4-layer full-width deepseek with moe=None: MLA
              decode against a forward, f32 to 1e-3; (b) absorbed_decode
              against the decompressing branch, f32 to 1e-3
  arctic_meta   arctic_480b built on the meta device: cfg.param_count()
              plus the norms (476.85 G), no weights drawn
  dryrun      ``repro_torch.launch.dryrun``: the 40 (architecture x
              shape) cells on the 16 x 16 and 2 x 16 x 16 meshes from the
              abstract state on meta, untraced, and each cell's step traced
              on meta at full size on 16 x 16 (flops), DRYRUN_JOBS worker
              processes; ok / skipped / error counts, the cells whose
              per-device total fits this card, the seconds
  ssd_kernel  the SSD-scan kernel against its plain versions (the chunked
              scan ``ssd_chunked`` and the recurrence ``ref.ssd``): JAX's
              kernel-test shapes, a 13-token single chunk, mamba2's
              serving shape with random inputs, and both models' own
              layer-0 serving inputs (bf16, B and C strided: the
              tensor-core instance; and as f32: the f32 instance), each
              with a nonzero initial state; event times at every shape;
              event and device times (the two launches of the tensor-core
              instance summed) at both serving shapes
  model_kernels   flash attention and RMSNorm against their plain versions:
              JAX's kernel-test shapes and the zamba2, musicgen and
              internvl2 serving paths' own inputs in bf16 and as f32
              (flash 2e-5 / 2e-2, RMSNorm 1e-5 / 5e-2, see close()):
              prefill's and a decode step's (4 rows, with the strides
              decode hands them), and RMSNorm at deepseek's d_model 2048
              (drawn); event, device, plain and library times
              (scaled_dot_product_attention, rms_norm) and bounds there
  train       training on the card (``repro_torch.training``,
              ``repro_torch.launch.train``; the models' plain code under
              autograd): (a) mamba2_130m at full width, AdamW with the JAX
              launcher's schedule, 4 x 1024 tokens a step, checkpoints
              through ControlPlane(QuorumSpec.paper_headline(11)) every 5
              steps, preempted at step 13 and restored into a fresh trainer
              at step 10 (step, cursor, every param and moment the same
              bits as step 10's), on to step 20 with the loss 0.5 nat under
              step 1's; one step of 2 microbatches against 1 (loss to 1e-2
              relative, params to 2e-2); (b) zamba2_2_7b at full width
              through the launcher, 5 steps, the loss falling; (c) reduced
              olmo_1b with int8 and top-k compression and with Adafactor,
              10 steps each, the loss 0.4 nat under step 1's; (d) no kernel
              of the four libraries launched by any train step, and a model
              built with kernels raising under grad; (e) both last
              checkpoints restored into fresh models with kernels and
              prefilled (4 x 1024) through make_prefill: SSD 24 / 54, flash
              0 / 9, RMSNorm 49 / 127 launches, the logits (f32 and bf16
              compute) the trained models' bit for bit, the kernel path
              held to the plain path as the serve phases hold it.  Step ms,
              tokens/s, peak memory, a traced step's card busy time and
              idle share, the phase's wall
  script      the script's wall seconds
  the kernels line: all nine kernels' launches on their main paths
              (summed; ``launches_by_path`` names each path's), error,
              times, bounds

Launch counts are zeroed just before each main-path phase and read just
after it; launches made to compare a kernel with its plain version do not
count.  Any mismatch or exception exits non-zero before the last line,
which is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
SOURCE = "src/repro_torch/kernels/quorum_tally/csrc/quorum_tally.cu"
MODEL_SOURCES = {
    "ssd": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rmsnorm": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
}
REPLACES = {
    "tally_votes": "src/repro/kernels/quorum_tally/kernel.py:55",
    "tally_decide": "src/repro/kernels/quorum_tally/kernel.py:439",
    "masked_tally": "src/repro/kernels/quorum_tally/kernel.py:138",
    "stream_tally_decide_hist":
        "src/repro/kernels/quorum_tally/kernel.py:321",
    "race_card_hist": "src/repro/kernels/quorum_tally/kernel.py:439 and the "
                      "XLA reductions of src/repro/montecarlo/streaming.py:394",
    "masked_sat": "none: src/repro/montecarlo/engine.py:411 _sat_time, plain "
                  "jnp (gather, cumsum, argmax, gather, min)",
    "sorted_prefix": "none: src/repro/montecarlo/engine.py:204 "
                     "_topk_ascending, lax.top_k",
    "ssd": "src/repro/kernels/ssd_scan/kernel.py:66",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:92",
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:32",
}
QUORUM_KERNELS = ("tally_votes", "tally_decide", "masked_tally",
                  "stream_tally_decide_hist", "race_card_hist", "masked_sat",
                  "sorted_prefix")
# Serving traffic: 4 requests of 1024 prompt tokens (four 256-token chunks,
# three carried-state hand-offs a Mamba2 layer), then 32 greedy decode
# steps.
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1024, 32
# The serve phases trace a prefill and a run of 4 decode steps (a trace of
# all 32 took 24-112 s a model, most of the script's model time).
SERVE_PROFILE_TOKENS = 4
# JAX's kernel-test shapes (tests/test_kernels.py): attention as (B, H, KV,
# S, T, hd, causal, window, dtype), RMSNorm as (shape, dtype).
ATTN_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, torch.float32),
    (1, 8, 8, 128, 128, 128, True, None, torch.float32),
    (1, 4, 1, 128, 128, 64, True, 64, torch.float32),
    (2, 2, 2, 64, 512, 32, True, None, torch.float32),
    (1, 4, 2, 256, 256, 64, False, None, torch.float32),
    (2, 4, 2, 256, 256, 64, True, None, torch.bfloat16),
    (1, 2, 2, 128, 128, 256, True, 32, torch.bfloat16),
]
RMSNORM_CASES = [((4, 64, 256), torch.float32),
                 ((2, 100, 384), torch.bfloat16),
                 ((8, 300), torch.float32), ((1, 7, 130), torch.bfloat16)]
# The quorum kernels at any K and n, as the reference takes them: K past one
# pass of 8 values, n past masked_tally's staged chunk of 128 lanes and
# past 256 (the stream kernel's byte-wide orders); (S, n, K).
ANY_KN_CASES = [(300, 11, 9), (300, 12, 12), (257, 11, 33), (500, 129, 2),
                (300, 130, 2), (200, 257, 3), (200, 300, 2), (100, 300, 9),
                (16383, 11, 2), (1000, 12, 17)]
# JAX's SSD kernel-test tolerances (tests/test_kernels.py:288): f32 differs
# from the plain versions by summation order only; with bf16 xw the output
# is rounded to bf16.  y is held to its dtype's, the f32 state to f32's,
# each times min(1, max|plain|): JAX's inputs are about unit scale, the
# serving path's are smaller.
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
# Device-side kernel names: each instance's launches, and the symbols of
# the tensor-core instances that the SASS check expects HMMA/HGMMA in.
SSD_TC_SYMBOLS = ("ssd_tc_states", "ssd_tc_out")
KERNEL_SYMBOLS = {"ssd": SSD_TC_SYMBOLS + ("ssd_kernel",),
                  "flash_attention": ("flash_tc_kernel", "flash_kernel"),
                  "rmsnorm": ("rmsnorm_kernel",)}
TENSOR_CORE_SYMBOLS = ("flash_tc_kernel", "ssd_tc_states", "ssd_tc_out")
# Serving checks, kernel path against plain path (and decode's recurrence
# against a chunked forward).  Both do the same f32 arithmetic in another
# order.  With f32 compute that is all they differ by: logits (about unit
# scale) and every superblock's first SSM state and attention cache,
# relative to its largest entry, must agree to 1e-3, JAX's f32 kernel
# tolerance.  With bf16 compute (as served), a value at a bf16 rounding
# edge rounds one ulp apart and the flip travels through the layers of the
# bf16 residual stream, by as much as any change of lowering does: the
# kernels may differ from the plain path by at most twice what two plain
# lowerings equal in exact arithmetic differ by (SSD chunks of 256 and of
# 128; attention with its softmax weights cast to bf16 before P.V, as the
# JAX oracle does, and kept in f32, as the kernel does; MLA's likewise).
# MoE routing is a step function of values that two lowerings round
# differently, so with MoE the kernel and floor runs replay the plain run's
# routing (``routing``), as exact arithmetic would route them.
SERVE_F32_TOL = 1e-3
# The norms whose inputs model_kernel_phase takes from the serving paths
# (capture_inputs): prefill's rows and a decode step's 4 (the gated ones
# only where there is a Mamba2 layer).
NORM_KEYS = ("rmsnorm", "gated_rmsnorm", "rmsnorm decode",
             "gated_rmsnorm decode")
SERVE_BF16_FLOOR_FACTOR = 2.0
SERVE_FLOOR_CHUNK = 128
# internvl2_26b's f32 weights (19.9 G params with the vision stub's embed
# table) do not fit the card whole: it is served at full width with the
# first 8 of its 48 layers (4.26 G params).  deepseek_v2_lite_16b's norms
# are timed at its d_model, drawn, before its model is built.
INTERNVL_LAYERS = 8
DEEPSEEK_D_MODEL = 2048
SWEEP_RACE_CHUNKS = -(-10_000_000 // 16_384)
MIXED_RACE_CHUNKS = -(-2_000_000 // 8_192)
# race_card_hist at the sweep chunk's shape (the n=11 sweep's 271-system
# table, coordinated, and its --relaxed 396-system table, uncoordinated),
# the sweep's ragged last chunk (5760 of 16384 trials valid), k_sat below
# n, n = 33 (rows past the register-held 16 lanes), and K = 9 at n = 130,
# n = 300: (name, trials, n, K, the table or the q maxima of 40 random
# systems, recovery, valid trials).
RACE_CARD_CASES = [
    ("sweep", 16384, 11, 2, "sweep", "coordinated", 16384),
    ("relaxed", 16384, 11, 2, "relaxed", "uncoordinated", 16384),
    ("sweep ragged", 16384, 11, 2, "sweep", "uncoordinated", 5760),
    ("k_sat below n", 3000, 12, 3, (9, 7, 8), "coordinated", 2999),
    ("n=33", 1000, 33, 3, (33, 20, 25), "coordinated", 900),
    ("K=9 n=130", 500, 130, 9, (130, 100, 40), "uncoordinated", 433),
    ("n=300", 200, 300, 2, (300, 250, 60), "coordinated", 171),
]


# masked_tally at the edges of its design: a table of unit rows, rows of
# small integer weights (bit planes) and rows of quarter weights (every sum
# exact in f32, in any order), rows with t <= 0 (an unvoted value sums to 0
# and answers there), negative weights, K = 8 (the largest instance with
# every mask in registers), K = 9 and K > n (voted values 8 a pass; a
# trial of exactly 8 distinct values takes a second, empty pass), n each
# side of a 32-lane mask word and past 128, n = 4000 (past a block's shared
# memory: the device-memory tier), and G = 65535 * 32 + 1 rows (past the
# old 2-D grid's cap; many row chunks, about 34 MB of weights): (name,
# trials, n, rows G, K, the rows' kind for masked_inputs).
MASKED_CASES = [
    ("unit and quarter rows", 2000, 12, 40, 2, "mixed"),
    ("t <= 0", 1000, 12, 24, 3, "nonpositive"),
    ("negative weights", 1000, 11, 24, 3, "negative"),
    ("K > n", 500, 12, 16, 70, "mixed"),
    ("K = 8", 800, 12, 16, 8, "negative"),
    ("K = 9", 800, 12, 16, 9, "nonpositive"),
    ("n=31", 600, 31, 20, 3, "mixed"),
    ("n=32", 600, 32, 20, 3, "nonpositive"),
    ("n=33", 600, 33, 20, 3, "mixed"),
    ("n=129", 300, 129, 20, 4, "negative"),
    ("n=4000", 70, 4000, 300, 3, "mixed"),
    ("G=65535*32+1", 33, 4, 65535 * 32 + 1, 2, "unit"),
]
# tally_votes at every K of its K-specialised instances and past them, at n
# each side of a 32-lane word, with trial counts that leave a warp ragged:
# (S, n, K).
TALLY_VOTES_CASES = ([(4097, 11, K) for K in range(1, 10)]
                     + [(3001, n, K) for n in (31, 32, 33) for K in (2, 8)]
                     + [(2049, 300, 5), (1500, 12, 70)])
# masked_sat at the main paths' shapes and the edges of its design: the
# mixed n=12 table's fast rows (13 systems, 3 rows each, 21 live) at the
# benchmark's 65,536-trial chunk, the planner's n=11 batch of 404 systems
# (more systems than one block's shared memory holds), per-system orders
# as the masked race's fast phase passes them, prefixes cut below n, n past
# the register-held 16 positions and past 256, unit, quarter, negative,
# non-integral and nonpositive-threshold rows, and a system's rows past a
# block's shared memory (read from device memory): (name, trials, n, L,
# systems M, rows G, the rows' kind for masked_sat_inputs, per-system
# orders).  "mixed_n12" takes the table itself.
MASKED_SAT_CASES = [
    ("mixed_n12", 65_536, 12, 12, 13, 3, "mixed_n12", False),
    ("mixed_n12 race orders", 8192, 12, 12, 13, 3, "mixed_n12", True),
    ("planner 404", 8192, 11, 11, 404, 12, "integral", False),
    ("integral k below n", 3000, 12, 9, 5, 7, "integral", False),
    ("unit", 2000, 12, 12, 4, 16, "unit", False),
    ("quarters", 2000, 11, 11, 6, 9, "quarters", True),
    ("negative", 1500, 10, 10, 3, 6, "negative", False),
    ("nonpositive", 1500, 9, 7, 3, 5, "nonpositive", True),
    ("normal", 1500, 12, 12, 5, 8, "normal", False),
    ("n=17", 1000, 17, 17, 3, 6, "integral", False),
    ("n=40 L=30", 1000, 40, 30, 3, 7, "integral", True),
    ("n=300 L=200", 200, 300, 200, 2, 5, "quarters", False),
    ("rows in device memory", 300, 12, 12, 2, 40_000, "integral", False),
]
# The two kernels at a large shape beside their main path's: masked_tally
# on the mixed n=12 table's 39 fast rows at 65,536 trials, tally_votes at
# 2^20 trials of 11 votes, K = 2.
MASKED_LARGE_S, TALLY_VOTES_LARGE_S = 65_536, 2 ** 20
# sorted_prefix at the ffp_n11.fast_4m cell's chunk: 2,097,152 rows of 11
SORTED_PREFIX_S = 2_097_152


def only(**launches) -> dict:
    """The quorum kernels' launch counts a path expects: those named, 0
    for the others."""
    return {k: launches.get(k, 0) for k in QUORUM_KERNELS}


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T_START,
                      **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def kernel_device_us(fn, symbol, reps: int = 10) -> tuple:
    """(device microseconds per call, launches recorded, microseconds per
    launch by symbol) of the kernels whose name holds ``symbol`` (a string,
    or a tuple of the symbols of the launches one call makes), over
    ``reps`` calls of ``fn`` traced by torch.profiler.  Each symbol's time
    is divided by the launches of it the trace recorded, and a call's time
    is the sum over its symbols: on the H100 short traces have dropped some
    kernel records (6 of 10 launches recorded), and dividing by ``reps``
    would then undercount; late in the script a trace has recorded none
    of them at all, and is then taken again with 10x, then 100x the
    calls."""
    for attempt in range(3):  # a trace that recorded none: again, longer
        prof = device_profile(
            lambda: [fn() for _ in range(reps * 10 ** attempt)])
        per, n_all = {}, 0
        for sym in ((symbol,) if isinstance(symbol, str) else symbol):
            t = sum(v for k, v in prof["by_kernel_s"].items() if sym in k)
            n = sum(v for k, v in prof["by_kernel_n"].items() if sym in k)
            if n:
                per[sym] = t * 1e6 / n
                n_all += n
        if per:
            break
    return (sum(per.values()) if per else float("nan")), n_all, per


def tensor_core_instructions(lib_path) -> dict:
    """The count of tensor-core instructions (HMMA, HGMMA) of each kernel
    function in ``cuobjdump -sass`` of a built library."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in ln or "HGMMA" in ln):
            counts[fn] += 1
    return counts


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_us(fn, n: int = 50) -> float:
    """Microseconds per call from CUDA events around ``n`` calls issued back
    to back: the card's time per call wherever a call runs longer than the
    host takes to issue the next, an upper bound on it elsewhere."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def device_profile(fn, top: int = 0) -> dict:
    """Run ``fn`` once under torch.profiler: its wall seconds, the seconds
    the card was busy (the device time of every kernel, copy and memset it
    ran), the device seconds and the recorded launches by kernel name and,
    with ``top``, the busiest kernels as [name, launches, ms].

    Only the trace's kernel, copy and memset records count (ffpbench's
    ``DEVICE_CATEGORIES``): the card's side of a ``repro_torch.tracing``
    span (``gpu_user_annotation``) is a range around kernels, not work."""
    from ffpbench.trace import Profiler
    torch.cuda.synchronize()
    prof = Profiler()
    prof.start()
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    secs, count = {}, {}
    for name, _, dur, _ in prof.records()["device"]:
        secs[name] = secs.get(name, 0.0) + dur * 1e-6
        count[name] = count.get(name, 0) + 1
    names = sorted(secs, key=lambda k: -secs[k])
    return {"wall_s": wall, "device_busy_s": sum(secs.values()),
            "by_kernel_s": secs, "by_kernel_n": count,
            "top": [[k[:70], count[k], secs[k] * 1e3] for k in names[:top]]}


def mixed_members(n: int = 12):
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.frontier import families
    return ([families.Member(f"card.{t}", s) for t, s in
             (("headline", QuorumSpec.paper_headline(n)),
              ("fast_paxos", QuorumSpec.fast_paxos(n)),
              ("majority", QuorumSpec.majority_fast(n)))]
            + families.grid_family(n) + families.weighted_family(n))


def stream_test_inputs(seed, S, n, M, G, K, dev, quarters=False, pad=False,
                       inf=False):
    """The kernel tests' stream inputs: integral weights, quantized arrival
    times (ties), ~10% lost 2b lanes, trailing padding trials.  ``quarters``:
    weights and thresholds in quarters instead, sums exact in f32 in any
    order; ``pad``: each phase's last row a padding row (zero weights,
    threshold 2^30) as ``build_mask_table`` pads; ``inf``: ~20% of the
    arrive and classic lanes +inf."""
    r = np.random.default_rng(seed)
    votes = r.integers(-1, K, (S, n)).astype(np.int32)
    arrive = np.floor(np.exp(r.standard_normal((S, n))) * 8.0) / 4.0
    classic = np.floor(np.exp(r.standard_normal((S, n))) * 8.0) / 4.0
    val_arr = np.floor(np.exp(r.standard_normal((S, K, n))) * 8.0) / 4.0 + .25
    lost = (votes[:, None, :] != np.arange(K)[None, :, None]) \
        | (r.random((S, K, n)) < 0.1)
    val_arr = np.where(lost, 1e9, val_arr)
    masks = []
    for _ in range(3):
        if quarters:
            w = r.integers(0, 9, (M, G, n)) / 4.0
            t = r.integers(1, 4 * n + 8, (M, G)) / 4.0
        else:
            w = r.integers(0, 3, (M, G, n))
            t = r.integers(1, n + 2, (M, G))
        w, t = w.astype(np.float32), t.astype(np.float32)
        if pad:
            w[:, -1], t[:, -1] = 0.0, 2.0 ** 30
        masks += [w, t]
    if inf:
        arrive[r.random((S, n)) < 0.2] = np.inf
        classic[r.random((S, n)) < 0.2] = np.inf
    valid = np.arange(S) < S - S // 7
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    return ([torch.as_tensor(votes).to(dev), f(val_arr), f(arrive),
             f(classic)] + [f(m) for m in masks]
            + [torch.as_tensor(valid).to(dev)])


def race_card_inputs(case, dev):
    """The race chunk's raw draws (``engine._draw_race``) and the table's
    recovery pairs for a RACE_CARD_CASES entry: (args, kwargs)."""
    from repro_torch.frontier import cardinality_family, relaxed_family
    from repro_torch.montecarlo import engine, rng, streaming
    _, S, n, K, tab, rec, nvalid = case
    if isinstance(tab, str):
        fam = cardinality_family(11) + (relaxed_family(11)
                                        if tab == "relaxed" else [])
        table = engine.build_mask_table([m.masks() for m in fam],
                                        device=dev)
        ks = engine.saturation_depths(table)
    else:
        r = np.random.default_rng(n + K)
        q = np.stack([r.integers(1, m + 1, 40) for m in tab], axis=1)
        q[0] = tab
        table = {"q": torch.as_tensor(q.astype(np.int32), device=dev)}
        ks = tab
    if rec == "uncoordinated":
        ks = (ks[0], ks[2], ks[2])
    offsets = torch.tensor([0.0, 0.2] + [0.3] * (K - 2), device=dev)
    raw = engine._draw_race(rng.generator(rng.root(S + n), dev), offsets,
                            streaming.default_delay(), n=n, k_proposers=K,
                            samples=S, recovery=rec)
    valid = torch.arange(S, device=dev) < nvalid
    return ([raw["votes"], raw["arrive"], raw["classic"], valid,
             streaming._card_layout(table, rec)[0]],
            dict(n_values=K, k_sat=ks, precision=0.01,
                 bins=streaming.sketch_bins(0.01),
                 undecided_ms=float(engine.UNDECIDED_MS)))


def masked_sat_inputs(case, dev):
    """(sorted_x, perm, w, t) on ``dev`` for a MASKED_SAT_CASES entry, drawn
    with numpy from a seed: arrivals quantized to quarters (ties), about 10%
    LOST (1e9) and 3% +inf, each row sorted stably and cut to its first L
    positions (a strided view where L < n, as a prefix sort leaves it);
    per-system orders (M, S, L), else one (S, L).  Rows (about a fifth of
    them padding: zero weights, threshold 2^30): ``integral`` weights in
    [0, 3) and thresholds in [1, n + 2); ``unit`` 0/1 weights; ``quarters``
    weights and thresholds in quarters (every sum exact in f32);
    ``negative`` integral weights in [-2, 3); ``nonpositive`` integral, a
    third of the thresholds -3, -0.0 or 0.0; ``normal`` |N(0, 1)| weights
    (sums inexact in f32); ``mixed_n12`` the mixed n=12 table's fast
    rows."""
    name, S, n, L, M, G, rows, per = case
    r = np.random.default_rng(S * 17 + n * 5 + L * 3 + M + G)
    if rows == "mixed_n12":
        from repro_torch.montecarlo.engine import build_mask_table
        table = build_mask_table([m.masks(n) for m in mixed_members(n)],
                                 device="cpu")
        w, t = table["p2f_w"].numpy(), table["p2f_t"].numpy()
    else:
        if rows == "normal":
            w = np.abs(r.standard_normal((M, G, n)))
        elif rows == "quarters":
            w = r.integers(0, 9, (M, G, n)) / 4.0
        elif rows == "unit":
            w = r.integers(0, 2, (M, G, n))
        else:
            w = r.integers(-2 if rows == "negative" else 0, 3, (M, G, n))
        hi = n + 2 if rows != "unit" else n // 2 + 2
        t = (r.integers(4, 4 * hi, (M, G)) / 4.0 if rows in
             ("quarters", "normal") else r.integers(1, hi, (M, G)))
        w, t = w.astype(np.float32), t.astype(np.float32)
        if rows == "nonpositive":
            third = r.random((M, G)) < 0.33
            t[third] = r.choice(np.array([-3.0, -0.0, 0.0], np.float32),
                                int(third.sum()))
        pad = r.random((M, G)) < 0.2
        w[pad], t[pad] = 0.0, 2.0 ** 30
    shape = (M, S, n) if per else (S, n)
    x = np.floor(np.exp(r.standard_normal(shape)) * 8.0) / 4.0
    x[r.random(shape) < 0.1] = 1e9
    x[r.random(shape) < 0.03] = np.inf
    x = x.astype(np.float32)
    perm = np.argsort(x, axis=-1, kind="stable")
    srt = np.take_along_axis(x, perm, axis=-1)
    f = lambda a: torch.as_tensor(a).to(dev)
    return (f(srt)[..., :L], f(perm.astype(np.int64))[..., :L], f(w), f(t))


def sequential_sat(sorted_x, perm, w, t, big: float):
    """masked_sat with each row's running sum taken one f32 add a position,
    in position order (the kernel's order): the plain version's
    ``cumsum`` may add in another order on the card, and in double on the
    CPU, which moves a crossing where the weights are not integral."""
    M, G, n = w.shape
    if sorted_x.dim() == 2:
        sorted_x = sorted_x.expand(M, -1, -1)
        perm = perm.expand(M, -1, -1)
    S, L = sorted_x.shape[1:]
    wp = torch.gather(w[:, :, None, :].expand(M, G, S, n), 3,
                      perm[:, None].expand(M, G, S, L))
    c = torch.zeros((M, G, S), dtype=torch.float32, device=w.device)
    first = torch.full((M, G, S), L, dtype=torch.long, device=w.device)
    for j in range(L):
        c = c + wp[..., j]
        first = torch.where((first == L) & (c >= t[..., None]), j, first)
    reached = c >= t[..., None]
    tt = torch.gather(sorted_x[:, None].expand(M, G, S, L), 3,
                      first.clamp(max=L - 1)[..., None])[..., 0]
    return torch.where(reached, tt, torch.full_like(tt, big)).amin(dim=1)


def masked_inputs(case, dev):
    """(votes, weights, thresholds, K) on ``dev`` for a MASKED_CASES entry,
    drawn with numpy from a seed.  Votes lie in [-1, K).  ``unit`` rows:
    0/1 weights, integral thresholds from 0 on, the last row a padding row
    (zero weights, threshold 2^30); the others: about a third of the rows
    unit, a quarter integral in [0, 4], a twentieth integral in [0, 300)
    (past the kernel's 8 bit planes), the rest quarter weights in [0, 2]
    (``negative``: in [-2, 2]), thresholds in quarters from -2 on;
    ``nonpositive`` also sets every third threshold to -0.0, 0.0, -0.25 or
    -3."""
    _, S, n, G, K, rows = case
    r = np.random.default_rng(S * 31 + n * 7 + K)
    votes = r.integers(-1, K, (S, n)).astype(np.int32)
    if rows == "unit":
        w = r.integers(0, 2, (G, n)).astype(np.float32)
        t = r.integers(0, n + 2, G).astype(np.float32)
        w[-1], t[-1] = 0.0, 2.0 ** 30
    else:
        lo = -8 if rows == "negative" else 0
        w = (r.integers(lo, 9, (G, n)) / 4.0).astype(np.float32)
        u = r.random(G)
        for rows_of, hi in ((u < 0.35, 2), ((u >= 0.35) & (u < 0.6), 5),
                            (u >= 0.95, 300)):
            w[rows_of] = r.integers(0, hi, (int(rows_of.sum()), n))
        t = (r.integers(-8, 4 * n // K + 8, G) / 4.0).astype(np.float32)
        if rows == "nonpositive":
            t[::3] = r.choice(np.array([-0.0, 0.0, -0.25, -3.0], np.float32),
                              len(t[::3]))
    f = lambda x: torch.as_tensor(x).to(dev)
    return f(votes), f(w), f(t), K


def ssd_cost(B, S, nh, hd, ds, chunk, x_bytes, bc_bytes, init: bool):
    """Bytes one SSD call must move (each input read once, each output
    written once) and its operations: ``least`` counts the chunked
    algorithm's work once -- the causal half of the chunk x chunk products,
    C.B once per batch row (B and C are shared by the heads) --, ``full``
    the whole chunk x chunk products for every head."""
    nc, L = S // chunk, chunk
    tri = L * (L + 1) // 2
    bytes_ = (2 * B * S * nh * hd * x_bytes + B * S * nh * 4
              + 2 * B * S * ds * bc_bytes + B * nh * hd * ds * 4 * (1 + init))
    least = 2 * B * nc * (tri * ds + nh * (tri * hd + 2 * L * hd * ds))
    full = 2 * B * nc * nh * (L * L * ds + L * L * hd + 2 * L * hd * ds)
    return bytes_, least, full


def ssd_test_inputs(seed, B, S, nh, hd, ds, x_dtype, bc_dtype, dev):
    """The JAX kernel tests' SSD inputs, drawn with numpy: xw and B, C
    ~ 0.5 N(0,1), da = -0.3 |N(0,1)|, a nonzero initial state 0.1 N(0,1)."""
    r = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(
        a.astype(np.float32)).to(dev).to(dt)
    return (t(r.standard_normal((B, S, nh, hd)) * 0.5, x_dtype),
            t(-np.abs(r.standard_normal((B, S, nh))) * 0.3),
            t(r.standard_normal((B, S, ds)) * 0.5, bc_dtype),
            t(r.standard_normal((B, S, ds)) * 0.5, bc_dtype),
            t(r.standard_normal((B, nh, hd, ds)) * 0.1))


def close(got, want, tol):
    """(max |error|, max |plain|, largest error / bound).  Each entry's bound
    is tol * max(|plain entry|, min(1, max |plain|)): absolute at unit
    scale, relative for large entries (a bf16 ulp grows with them), and
    relative to the largest entry where all are small."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    wmax = float(w.abs().max()) if w.numel() else 0.0
    bound = tol * torch.clamp(w.abs(), min=max(min(1.0, wmax), 1e-30))
    return (float(err.max()) if err.numel() else 0.0, wmax,
            float((err / bound).max()) if err.numel() else 0.0)


def model_kernels():
    """The ops modules of the model's three kernels, by kernel name, with
    the attribute the model calls."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"ssd": (ssd_ops, "ssd"),
            "flash_attention": (flash_ops, "attention"),
            "rmsnorm": (rmsnorm_ops, "rmsnorm")}


def model_launches() -> dict:
    return {k: m.LAUNCHES[k] for k, (m, _) in model_kernels().items()}


def tensor_core_launches() -> dict:
    """The launches of the tensor-core instances among model_launches()."""
    mods = model_kernels()
    return {"ssd": mods["ssd"][0].LAUNCHES["ssd_tc"],
            "flash_attention":
                mods["flash_attention"][0].LAUNCHES["flash_attention_tc"]}


def reset_model_launches() -> None:
    for m, _ in model_kernels().values():
        m.reset_launches()


def plain_versions(floor: bool = False) -> dict:
    """The plain versions swapped in for the model's kernels.  ``floor``
    gives a second plain lowering, equal to the first in exact arithmetic:
    attention with its softmax weights kept in f32 (the model's SSD chunk
    and MLA's softmax weights are changed by ``variant``)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.models.ssm import ssd_chunked

    def ssd(xw, da, Bm, Cm, chunk=256, init_state=None):
        return ssd_chunked(xw, da, Bm, Cm, min(chunk, xw.shape[1]),
                           init_state)

    def attention(q, k, v, causal=True, window=None):
        if not floor:
            return fa_ref.attention(q, k, v, causal, window)
        return fa_ref.attention(q.float(), k.float(), v.float(), causal,
                                window).to(q.dtype)

    return {"ssd": ssd, "flash_attention": attention,
            "rmsnorm": rn_ref.rmsnorm}


@contextlib.contextmanager
def variant(model, kernel: bool = True, dtype=torch.bfloat16,
            floor: bool = False):
    """The serving path with the kernels or, swapped in for their ops, the
    plain versions (``floor``: the second plain lowering, with the SSD
    chunk SERVE_FLOOR_CHUNK and MLA's softmax weights kept in f32 before
    they multiply V); compute in ``dtype``."""
    import functools
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import model as model_mod
    mods = model_kernels()
    saved = ({k: getattr(m, a) for k, (m, a) in mods.items()}, model.cfg,
             model_mod.COMPUTE_DTYPE, layers_mod.mla_attention)
    model_mod.COMPUTE_DTYPE = dtype
    if not kernel:
        for k, fn in plain_versions(floor).items():
            setattr(mods[k][0], mods[k][1], fn)
    if floor:
        cfg = model.cfg
        if cfg.ssm is not None:
            model.cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, chunk=SERVE_FLOOR_CHUNK))
        layers_mod.mla_attention = functools.partial(
            saved[3], weights_dtype=torch.float32)
    try:
        yield
    finally:
        for k, fn in saved[0].items():
            setattr(mods[k][0], mods[k][1], fn)
        model.cfg, model_mod.COMPUTE_DTYPE = saved[1], saved[2]
        layers_mod.mla_attention = saved[3]


@contextlib.contextmanager
def routing(mode=None, log=None):
    """The MoE router's two selections (``moe.top_k``: a token's top-k
    experts, an expert's top-C tokens), kept in ``log`` in call order
    (``mode="record"``) or taken from it (``"replay"``: the recorded
    indices, their values gathered from this call's input).  Routing is a
    step function of values that two lowerings round differently; replayed,
    two runs route the same tokens, as they do in exact arithmetic."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod.top_k
    if mode is None:
        yield
        return
    it = iter(log)

    def top_k(x, k):
        if mode == "record":
            v, i = real(x, k)
            log.append(i)
            return v, i
        i = next(it)
        return torch.gather(x, -1, i), i

    moe_mod.top_k = top_k
    try:
        yield
    finally:
        moe_mod.top_k = real


def routing_flips(a: list, b: list) -> int:
    """Rows (a token's experts, an expert's tokens) chosen differently in
    two recorded routings of the same calls."""
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def capture_inputs(fn, d_inner) -> dict:
    """Run ``fn`` with spies on the model's kernel ops; return the first
    arguments each was handed: "ssd", "flash_attention", "rmsnorm" (the
    first norm, d_model wide) and "gated_rmsnorm" (the first d_inner wide
    one, Mamba2's gated norm; ``d_inner`` None: no such norm), and of each
    norm the last call with SERVE_BATCH rows (the last decode step's),
    "rmsnorm decode" and "gated_rmsnorm decode"."""
    got = {}
    mods = model_kernels()
    saved = {k: getattr(m, a) for k, (m, a) in mods.items()}

    def spy(name):
        real = saved[name]

        def call(*args, **kw):
            key = name
            if name == "rmsnorm" and args[0].shape[-1] == d_inner:
                key = "gated_rmsnorm"
            if name == "rmsnorm" and \
                    args[0].numel() == SERVE_BATCH * args[0].shape[-1]:
                got[key + " decode"] = (args, kw)    # the last step's
            else:
                got.setdefault(key, (args, kw))
            return real(*args, **kw)
        return call

    for k, (m, a) in mods.items():
        setattr(m, a, spy(k))
    try:
        fn()
    finally:
        for k, fn_ in saved.items():
            setattr(mods[k][0], mods[k][1], fn_)
    return got


def ssd_check(errs, tag, xw, da, Bm, Cm, chunk, s0):
    """The SSD kernel against its plain chunked version and the recurrence:
    y within its dtype's tolerance, the f32 state within f32's, each times
    min(1, max|plain|)."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models.ssm import ssd_chunked
    tc = xw.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16
    before = ssd_kernel.LAUNCHES["ssd_tc"]
    y, f = ssd_kernel.ssd(xw, da, Bm, Cm, chunk, s0)
    torch.cuda.synchronize()
    if y.dtype != xw.dtype or tuple(f.shape) != tuple(s0.shape) \
            or not bool(torch.isfinite(y.float()).all()):
        fail(f"ssd {tag}: output dtype, shape or finiteness")
    if ssd_kernel.LAUNCHES["ssd_tc"] - before != int(tc):
        fail(f"ssd {tag}: the tensor-core instance ran "
             f"{ssd_kernel.LAUNCHES['ssd_tc'] - before} times, expected "
             f"{int(tc)}")
    plain = {"chunked": ssd_chunked(xw, da, Bm, Cm, chunk, s0),
             "recurrence": ssd_ref.ssd(xw.float(), da, Bm, Cm, s0)}
    if tc:
        plain["emulation"] = ssd_ref.ssd_decomposed(xw, da, Bm, Cm, chunk,
                                                    s0, split=True)
    for name, (yp, fp) in plain.items():
        e = dict(y_err=float((y.float() - yp.float()).abs().max()),
                 state_err=float((f - fp).abs().max()),
                 y_max=float(yp.float().abs().max()),
                 state_max=float(fp.abs().max()))
        e["y_tol"] = SSD_TOL[xw.dtype] * min(1.0, e["y_max"])
        e["state_tol"] = SSD_TOL[torch.float32] * min(1.0, e["state_max"])
        errs[f"{tag} vs {name}"] = e
        if not (e["y_err"] < e["y_tol"]
                and e["state_err"] < e["state_tol"]):
            fail(f"ssd {tag} vs {name}: {e}")
    errs[f"{tag} kernel ms"] = cuda_ms(
        lambda: ssd_kernel.ssd(xw, da, Bm, Cm, chunk, s0), reps=10,
        warmup=2)


def ssd_timing(xw, da, Bm, Cm, chunk, s0) -> dict:
    """Event, device and plain times of one SSD call, its bound."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models.ssm import ssd_chunked
    B, S, nh, hd = xw.shape
    ds = Bm.shape[-1]
    tc = xw.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16
    call = lambda: ssd_kernel.ssd(xw, da, Bm, Cm, chunk, s0)
    kms = cuda_ms(call)
    pms = cuda_ms(lambda: ssd_chunked(xw, da, Bm, Cm, chunk, s0), reps=10)
    dev_us, dev_n, per = kernel_device_us(
        call, SSD_TC_SYMBOLS if tc else "ssd_kernel")
    b2b_us = back_to_back_us(call, n=20)
    nbytes, least, full = ssd_cost(B, S, nh, hd, ds, chunk,
                                   xw.element_size(), Bm.element_size(),
                                   True)
    rate = BF16_TC_OPS_PER_S if tc else FP32_OPS_PER_S
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = least / rate * 1e3
    lib = ssd_kernel.LIB.load()
    return dict(
        shape=[B, S, nh, hd, ds, chunk], instance="tensor-core" if tc
        else "f32", ms=kms, plain_ms=pms,
        device_us=dev_us, device_us_by_launch=per,
        device_launches_recorded=dev_n,
        back_to_back_us=b2b_us, bound_ms=max(b_ms, o_ms),
        bound_by="bytes" if b_ms >= o_ms else "operations",
        bytes=nbytes, operations_least=least, operations_full=full,
        bound_rule=("max(bytes / 3.35 TB/s, least operations / 989 TFLOP/s "
                    "bf16 tensor cores: xw, B and C are bf16)" if tc else
                    "max(bytes / 3.35 TB/s, least operations / 67 TFLOP/s "
                    "f32: an operand is f32"),
        bytes_ms=b_ms, least_operations_ms=o_ms,
        least_f32_ms=least / FP32_OPS_PER_S * 1e3,
        smem_bytes=(lib.ssd_tc_smem(hd, ds, chunk) if tc
                    else lib.ssd_smem(hd, ds, chunk)))


def ssd_phase(dev):
    """Phase 7: the SSD kernel against its plain versions on the JAX kernel
    tests' shapes and a 13-token single chunk, each with a nonzero initial
    state.  Returns the errors."""
    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("jax 2x128x4x16x32 c32 f32",
              (2, 128, 4, 16, 32, 32, f32, f32)),
             ("jax 1x256x8x64x128 c64 f32",
              (1, 256, 8, 64, 128, 64, f32, f32)),
             ("jax 2x64x24x64x128 c64 f32",
              (2, 64, 24, 64, 128, 64, f32, f32)),
             ("jax 1x128x4x32x64 c32 bf16 xw",
              (1, 128, 4, 32, 64, 32, bf16, f32)),
             ("S=13 single chunk f32", (2, 13, 4, 16, 32, 13, f32, f32)),
             ("S=13 single chunk bf16", (2, 13, 4, 16, 32, 13, bf16, bf16)),
             ("mamba2 serving shape random f32",
              (SERVE_BATCH, SERVE_PROMPT, 24, 64, 128, 256, f32, f32))]
    for i, (tag, (B, S, nh, hd, ds, chunk, xd, bd)) in enumerate(cases):
        xw, da, Bm, Cm, s0 = ssd_test_inputs(100 + i, B, S, nh, hd, ds, xd,
                                             bd, dev)
        ssd_check(errs, tag, xw, da, Bm, Cm, chunk, s0)
    return errs


def serving_ssd(errs, tag, captured, cfg, dev) -> dict:
    """The SSD kernel at the inputs the serving path handed it in layer 0
    (bf16, B and C strided), and those inputs as f32, each with a nonzero
    initial state; then its times there."""
    (xw, da, Bm, Cm, chunk, _), _ = captured["ssd"]
    B, S, nh, hd = xw.shape
    ds = Bm.shape[-1]
    ssm = cfg.ssm
    if Bm.is_contiguous() or (B, S, nh, hd, ds, chunk) != (
            SERVE_BATCH, SERVE_PROMPT, ssm.n_heads(cfg.d_model),
            ssm.head_dim, ssm.d_state, ssm.chunk):
        fail(f"{tag} SSD inputs: shape {(B, S, nh, hd, ds, chunk)}, "
             f"B contiguous {Bm.is_contiguous()}")
    chunk = min(chunk, S)
    gen = torch.Generator(device=dev).manual_seed(7)
    s0 = 0.1 * torch.randn((B, nh, hd, ds), generator=gen, device=dev)
    ssd_check(errs, f"{tag} layer 0 bf16", xw, da, Bm, Cm, chunk, s0)
    ssd_check(errs, f"{tag} layer 0 as f32", xw.float(), da, Bm.float(),
              Cm.float(), chunk, s0)
    return ssd_timing(xw, da, Bm, Cm, chunk, s0)


def attention_cost(q, k, causal, window) -> tuple:
    """(bytes, operations) of one attention call: q, k, v read and o
    written once; two products of hd per (query, key) pair that the mask
    keeps (the causal half, the window's band)."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    qp = torch.arange(S, dtype=torch.float64) + (T - S)
    kp = torch.arange(T, dtype=torch.float64)
    ok = torch.ones((S, T), dtype=torch.bool)
    if causal:
        ok &= kp[None, :] <= qp[:, None]
    if window is not None:
        ok &= (qp[:, None] - kp[None, :]) < window
    pairs = int(ok.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * B * H * hd * pairs


def model_kernel_phase(dev, serving: dict) -> dict:
    """Phase 9: flash attention and RMSNorm against their plain versions on
    the JAX kernel tests' shapes and at each served model's own inputs
    (``serving``: arch -> its serve_phase result; bf16, and those inputs
    as f32), and RMSNorm at deepseek_v2_lite_16b's serving shapes (drawn
    here: that model is built after every per-kernel timing, see main);
    times, bounds and the library call's time there.  Returns the stats of
    each: zamba2's under the kernel's or norm's name, the others' with the
    architecture after it; and "errors", every check's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"flash_attention": {}, "rmsnorm": {}}

    def check(kind, tag, got, want, tol):
        err, mag, ratio = close(got, want, tol)
        errs[kind][tag] = dict(err=err, plain_max=mag, err_over_bound=ratio)
        if not ratio < 1.0 or not bool(torch.isfinite(got.float()).all()):
            fail(f"{kind} {tag}: error {err} against |plain| up to {mag}, "
                 f"{ratio} of the bound")

    fa_tol = {f32: 2e-5, bf16: 2e-2}
    rn_tol = {f32: 1e-5, bf16: 5e-2}

    def flash_check(tag, q, k, v, causal, window):
        """The instance for q's dtype against the plain version (and the
        tensor-core instance also against its plain emulation); its event
        time."""
        dt = q.dtype
        before = fa_kernel.LAUNCHES["flash_attention_tc"]
        got = fa_kernel.attention(q, k, v, causal, window)
        torch.cuda.synchronize()
        ran = fa_kernel.LAUNCHES["flash_attention_tc"] - before
        if ran != int(dt == bf16):
            fail(f"flash {tag}: the tensor-core instance ran {ran} times")
        check("flash_attention", tag, got, fa_ref.attention(
            q.float(), k.float(), v.float(), causal, window), fa_tol[dt])
        if dt == bf16:
            check("flash_attention", f"{tag} vs emulation", got,
                  fa_ref.attention_tc(q, k, v, causal, window), fa_tol[dt])
        errs["flash_attention"][f"{tag} kernel ms"] = cuda_ms(
            lambda: fa_kernel.attention(q, k, v, causal, window), reps=10,
            warmup=2)

    r = np.random.default_rng(11)
    for B, H, KV, S, T, hd, causal, window, dt in ATTN_CASES:
        q, k, v = (torch.as_tensor(r.standard_normal(s).astype(np.float32)
                                   ).to(dev).to(dt)
                   for s in ((B, H, S, hd), (B, KV, T, hd), (B, KV, T, hd)))
        flash_check(f"jax {B}x{H}/{KV}x{S}x{T}x{hd} causal={causal} "
                    f"window={window} {dt}", q, k, v, causal, window)
    for shape, dt in RMSNORM_CASES:
        x = torch.as_tensor(r.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(dt)
        s = torch.as_tensor(r.standard_normal(shape[-1]).astype(np.float32)
                            ).to(dev)
        check("rmsnorm", f"jax {shape} {dt}", rn_kernel.rmsnorm(x, s),
              rn_ref.rmsnorm(x, s), rn_tol[dt])

    # times at the serving inputs; device time from the profiler, and for
    # RMSNorm also after a write of 64 MB between calls (L2 is 50 MB: the
    # 4096-row inputs are then read from device memory, not L2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def stats(symbol, kf, pf, lf, nbytes, ops, ops_rate, flushed=False):
        kms, pms, lms = cuda_ms(kf), cuda_ms(pf, reps=10), cuda_ms(lf)
        dev_us, dev_n, _ = kernel_device_us(kf, symbol)
        extra = {}
        if flushed:
            extra["device_us_l2_flushed"] = kernel_device_us(
                lambda: (flush.fill_(1), kf()), symbol)[0]
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / ops_rate * 1e3
        return dict(ms=kms, plain_ms=pms, library_ms=lms, device_us=dev_us,
                    device_launches_recorded=dev_n,
                    back_to_back_us=back_to_back_us(kf),
                    library_back_to_back_us=back_to_back_us(lf),
                    bound_ms=max(b_ms, o_ms),
                    bound_by="bytes" if b_ms >= o_ms else "operations",
                    bytes=nbytes, operations=ops, bytes_ms=b_ms,
                    operations_ms=o_ms, **extra)

    def norm_stats(x, s, eps, flushed):
        # either instance: rmsnorm_kernel, or rmsnorm_loop_kernel for rows
        # of more than 10240 bf16 / 5120 f32 values
        D = x.shape[-1]
        return dict(shape=list(x.shape), strides=list(x.stride()),
                    dtype=str(x.dtype), **stats(
            "rmsnorm",
            lambda: rn_kernel.rmsnorm(x, s, eps),
            lambda: rn_ref.rmsnorm(x, s, eps),
            lambda: F.rms_norm(x, (D,), s, eps),
            2 * x.numel() * x.element_size() + 4 * D, 3 * x.numel(),
            FP32_OPS_PER_S, flushed=flushed))

    def norm_checks(tag, x, s, eps):
        """The path's own tensor, and as f32 with the same strides."""
        xs = {bf16: x, f32: torch.empty_strided(
            x.shape, x.stride(), dtype=f32, device=x.device).copy_(x)}
        for dt in (bf16, f32):
            check("rmsnorm", f"{tag} {tuple(x.shape)} strides {x.stride()} "
                  f"{dt}", rn_kernel.rmsnorm(xs[dt], s, eps),
                  rn_ref.rmsnorm(xs[dt], s, eps), rn_tol[dt])
        return xs

    out = {}
    for arch, res in serving.items():
        captured, cfg = res["captured"], res["cfg"]
        sfx = "" if arch == "zamba2_2_7b" else f" {arch}"
        short = arch.split("_")[0]
        L = res["phase"]["prefill_len"]
        (q, k, v), fkw = captured["flash_attention"]
        causal, window = fkw.get("causal", True), fkw.get("window")
        if q.dtype != bf16 or tuple(q.shape) != (
                SERVE_BATCH, cfg.n_heads, L, cfg.hd) \
                or k.shape[1] != cfg.n_kv_heads \
                or not q.transpose(1, 2).is_contiguous():
            fail(f"{arch} serving flash inputs: {q.dtype} {tuple(q.shape)} "
                 f"KV {k.shape[1]} strides {q.stride()}")
        if window is not None:
            fail(f"{arch}: global attention, no window expected")
        for dt in (bf16, f32):
            qq, kk, vv = (x.to(dt) for x in (q, k, v))
            flash_check(f"{short} serving {dt}", qq, kk, vv, causal, window)
        nbytes, ops = attention_cost(q, k, causal, window)
        out["flash_attention" + sfx] = dict(
            shape=list(q.shape), kv_heads=k.shape[1],
            instance="tensor-core",
            smem_bytes=fa_kernel.LIB.load().flash_smem(1, q.shape[-1]),
            bound_rule="max(q, k, v, o bytes / 3.35 TB/s, the causal pairs' "
                       "4*hd operations / 989 TFLOP/s bf16 tensor cores)",
            **stats("flash_tc_kernel",
                    lambda: fa_kernel.attention(q, k, v, causal, window),
                    lambda: fa_ref.attention(q, k, v, causal, window),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal,
                        enable_gqa=q.shape[1] != k.shape[1]),
                    nbytes, ops, BF16_TC_OPS_PER_S))
        for key in NORM_KEYS:
            if key not in captured:
                continue
            (x, s, *rest), _ = captured[key]
            eps = rest[0] if rest else 1e-6
            s = s.detach()
            if x.dtype != bf16:
                fail(f"{arch} serving {key} input: {x.dtype}")
            xs = norm_checks(f"{short} serving {key}", x, s, eps)
            for dt in ((bf16,) if "decode" not in key else (bf16, f32)):
                out[key + (" f32" if dt == f32 else "") + sfx] = norm_stats(
                    xs[dt], s, eps, flushed="decode" not in key)
    # deepseek_v2_lite_16b's norms: prefill's 4096 rows and a decode
    # step's 4, d_model 2048, drawn with the layout the path hands them
    # (serve_deepseek_v2_lite_16b checks its own inputs have it)
    D = DEEPSEEK_D_MODEL
    g = torch.Generator(device=dev).manual_seed(12)
    s = torch.randn(D, generator=g, device=dev)
    for key, shape in (("rmsnorm", (SERVE_BATCH, SERVE_PROMPT, D)),
                       ("rmsnorm decode", (SERVE_BATCH, 1, D))):
        x = torch.randn(shape, generator=g, device=dev).to(bf16)
        norm_checks(f"deepseek drawn {key}", x, s, 1e-6)
        out[f"{key} deepseek_v2_lite_16b"] = norm_stats(
            x, s, 1e-6, flushed="decode" not in key)
    out["errors"] = errs
    return out


def path_launches(cfg) -> tuple:
    """(SSD, flash, RMSNorm) launches of one prefill of ``cfg`` with the
    kernels: SSD a Mamba2 layer, flash a GQA attention block (MLA is plain
    products), RMSNorm every norm and the head's."""
    n_mamba = cfg.pattern.count("mamba") * cfg.n_superblocks
    n_attn = (len(cfg.pattern) - cfg.pattern.count("mamba")) \
        * cfg.n_superblocks
    n_flash = 0 if cfg.mla is not None else n_attn
    return n_mamba, n_flash, 2 * (n_mamba + n_attn) + 1


def serve_config(arch: str, layers=None):
    """``arch``'s configuration at full width, its depth cut to ``layers``
    where given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def prefill_checks(arch, model, batch, prefill, n_mamba: int,
                   n_flash: int, per_pass: int) -> dict:
    """The kernel path against the plain path for one prefill of ``batch``
    (SERVE_BATCH requests) through ``prefill(cache, batch)``: the prefill
    logits, every superblock's first SSM state and attention cache (MLA:
    its ckv), with f32 compute to SERVE_F32_TOL and as served (bf16)
    within SERVE_BF16_FLOOR_FACTOR times the bf16 floor; each prefill with
    the kernels launches SSD ``n_mamba``, flash ``n_flash`` and RMSNorm
    ``per_pass`` times, all on the tensor-core instances in bf16, and the
    plain path none.  With MoE the kernel and floor runs replay the plain
    run's routing (``routing``), and the routing flips of the kernel runs
    left to route themselves are counted.  Fails on a miss; returns the
    checks."""
    from repro_torch.launch import serve
    L = serve.prefill_len(batch)
    moe = model.cfg.moe is not None
    logs = {}

    def prefill_once(kernel, dtype, floor=False, mode=None, log=None):
        with variant(model, kernel, dtype, floor), routing(mode, log), \
                torch.inference_mode():
            reset_model_launches()
            c, lg = prefill(model.init_cache(SERVE_BATCH, L), batch)
            torch.cuda.synchronize()
            want = ({"ssd": n_mamba, "flash_attention": n_flash,
                     "rmsnorm": per_pass} if kernel
                    else dict.fromkeys(("ssd", "flash_attention",
                                        "rmsnorm"), 0))
            tc_on = kernel and dtype == torch.bfloat16
            want_tc = {"ssd": n_mamba * tc_on,
                       "flash_attention": n_flash * tc_on}
            if model_launches() != want \
                    or tensor_core_launches() != want_tc:
                fail(f"{arch} prefill kernel={kernel} {dtype}: "
                     f"{model_launches()}, tensor-core instances "
                     f"{tensor_core_launches()}")
        states = []
        for sb in c["layers"]:
            for key, cc in sorted(sb.items()):
                if key == "mamba_0":
                    states.append(cc["state"])
                elif "k" in cc:
                    states.append(cc["k"].float())
                elif "ckv" in cc:
                    states.append(cc["ckv"].float())
        return states, lg[:, -1].float()

    def run(kernel, dtype, floor=False):
        """The plain run records its routing, the others replay it."""
        if not moe:
            return prefill_once(kernel, dtype, floor)
        if not kernel and not floor:
            logs[dtype] = []
            return prefill_once(False, dtype, mode="record",
                                log=logs[dtype])
        return prefill_once(kernel, dtype, floor, "replay", logs[dtype])

    def diff(a, b):
        return (float((a[1] - b[1]).abs().max()),
                [float((x - y).abs().max()) / max(float(y.abs().max()),
                                                  1e-30)
                 for x, y in zip(a[0], b[0])])

    f32, bf16 = torch.float32, torch.bfloat16
    checks = {}
    plain32 = run(False, f32)
    checks["prefill f32 kernel vs plain"] = diff(run(True, f32), plain32)
    lg_err, st_err = checks["prefill f32 kernel vs plain"]
    if lg_err >= SERVE_F32_TOL or max(st_err) >= SERVE_F32_TOL:
        fail(f"{arch} f32 prefill kernel vs plain: logits off by {lg_err}, "
             f"states and caches by {max(st_err)} relative")
    plain = run(False, bf16)
    checks["prefill bf16 kernel vs plain"] = diff(run(True, bf16), plain)
    checks["prefill bf16 plain floor lowering vs plain"] = diff(
        run(False, bf16, floor=True), plain)
    (lg_k, st_k), (lg_f, st_f) = (
        checks["prefill bf16 kernel vs plain"],
        checks["prefill bf16 plain floor lowering vs plain"])
    if lg_k > SERVE_BF16_FLOOR_FACTOR * lg_f \
            or max(st_k) > SERVE_BF16_FLOOR_FACTOR * max(st_f) \
            or not (lg_f > 0 and max(st_f) > 0):
        fail(f"{arch} bf16 prefill kernel vs plain: logits off by {lg_k}, "
             f"states by {max(st_k)} relative; two plain lowerings differ "
             f"by {lg_f} and {max(st_f)}")
    if moe:
        for dtype in (f32, bf16):
            own = []
            prefill_once(True, dtype, mode="record", log=own)
            checks[f"prefill {dtype} kernel routing flips vs plain "
                   f"(rows of {sum(len(x) for x in own)})"] = \
                routing_flips(own, logs[dtype])
    return checks


def extended_batch(model, batch, gen, dtype) -> dict:
    """``batch`` with the tokens ``gen`` (B, n) appended as decode consumed
    them: as token ids, or for the audio stub as the rows of ``head.T``
    after ``frame_emb``, in ``dtype``."""
    if "frame_emb" in batch:
        rows = model.head.detach().T[gen]
        return {"frame_emb": torch.cat([batch["frame_emb"].to(dtype),
                                        rows.to(dtype)], dim=1)}
    out = dict(batch)
    out["tokens"] = torch.cat([batch["tokens"], gen], dim=1)
    return out


def teacher_forced(model, batch, tokens, kernel, dtype, floor=False,
                   mode=None, log=None) -> torch.Tensor:
    """Prefill ``batch``, then a decode step a column of ``tokens`` (B, n):
    the prefill's and each step's logits (B, n+1, V) as f32."""
    from repro_torch.launch import serve
    n = tokens.shape[1]
    with variant(model, kernel, dtype, floor), routing(mode, log), \
            torch.inference_mode():
        c = model.init_cache(SERVE_BATCH, serve.prefill_len(batch) + n)
        c, lg = model.prefill(batch, c)
        out = [lg[:, -1]]
        for i in range(n):
            lg, c = model.decode_step(c, tokens[:, i:i + 1])
            out.append(lg[:, -1])
    return torch.stack(out, dim=1).float()


def run_logits(run) -> torch.Tensor:
    return torch.stack([run["prefill_logits"]] + run["step_logits"],
                       dim=1).float()


def decode_checks(arch, model, batch, run_bf16, run_f32, n_tokens) -> dict:
    """Without MoE: decode's logits against a plain ``forward`` over the
    prompt and the generated tokens (``extended_batch``).  With MoE, whose
    capacity is computed from the tokens of a call (a forward's differs
    from a decode step's), decode with the kernels against decode with the
    plain versions, fed the same tokens (each run's greedy picks) and
    replaying the plain run's routing.  f32 to SERVE_F32_TOL, bf16 within
    SERVE_BF16_FLOOR_FACTOR times the floor lowering's difference."""
    from repro_torch.launch import serve
    L = serve.prefill_len(batch)
    f32, bf16 = torch.float32, torch.bfloat16
    checks, err = {}, {}
    for dtype, run in ((f32, run_f32), (bf16, run_bf16)):
        got = run_logits(run)
        if not bool(torch.isfinite(got).all()):
            fail(f"{arch} {dtype} serving logits not finite")
        gen = run["tokens"][:, :n_tokens]
        if model.cfg.moe is None:
            ref = {}
            for floor in (False, True):
                with variant(model, False, dtype, floor), \
                        torch.inference_mode():
                    ref[floor] = model.forward(extended_batch(
                        model, batch, gen, dtype))[:, L - 1:].float()
            err[dtype] = (float((got - ref[False]).abs().max()),
                          float((ref[True] - ref[False]).abs().max()))
            checks[f"decode {dtype} vs plain forward"] = err[dtype][0]
            if dtype == bf16:
                checks["forward bf16 plain floor lowering vs plain"] = \
                    err[dtype][1]
            continue
        log = []
        plain = teacher_forced(model, batch, gen, False, dtype,
                               mode="record", log=log)
        kern = teacher_forced(model, batch, gen, True, dtype,
                              mode="replay", log=log)
        err[dtype] = (float((kern - plain).abs().max()), None)
        checks[f"decode {dtype} kernel vs plain, same tokens and "
               f"routing"] = err[dtype][0]
        checks[f"decode {dtype} served run vs plain, own routing"] = float(
            (got - plain).abs().max())
        if dtype == bf16:
            floor = teacher_forced(model, batch, gen, False, dtype, True,
                                   mode="replay", log=log)
            err[dtype] = (err[dtype][0], float((floor - plain).abs().max()))
            checks["decode bf16 plain floor lowering vs plain"] = \
                err[dtype][1]
    if err[f32][0] >= SERVE_F32_TOL:
        fail(f"{arch} f32 decode logits off by {err[f32][0]}")
    if err[bf16][0] > SERVE_BF16_FLOOR_FACTOR * err[bf16][1] \
            or not err[bf16][1] > 0:
        fail(f"{arch} bf16 decode logits off by {err[bf16][0]}; two plain "
             f"lowerings differ by {err[bf16][1]}")
    return checks


def serve_phase(arch: str, dev, n_tokens: int, layers=None) -> dict:
    """Serve ``arch`` at full width (its depth cut to ``layers`` where
    given), seeded weights, SERVE_BATCH requests of SERVE_PROMPT tokens
    (frames; or patches and tokens) then ``n_tokens`` greedy decode steps,
    through ``repro_torch.launch.serve``, three times (the same tokens);
    hold the kernel path against the plain path (``prefill_checks``,
    ``decode_checks``).  Returns the model, its batch, the launches of one
    serving run, the inputs the path handed each kernel, and the phase's
    numbers so far, for ``serve_profile`` to finish and emit."""
    from repro_torch.launch import serve
    from repro_torch.models.model import DecoderLM

    cfg = serve_config(arch, layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    walls = {}
    n_params = sum(p.numel() for p in model.parameters())
    batch = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT, dev)
    abstract = abstract_checks(arch, model, serve.prefill_len(batch))
    n_mamba, n_flash, per_pass = path_launches(cfg)
    per_run = {"ssd": n_mamba, "flash_attention": n_flash,
               "rmsnorm": per_pass * (1 + n_tokens)}

    # Warm-up run (not counted), which also captures the inputs the main
    # path hands each kernel.
    captured = capture_inputs(
        lambda: serve.generate(model, batch, 2),
        cfg.ssm.d_inner(cfg.d_model) if cfg.ssm is not None else None)

    runs = []
    tc_per_run = {"ssd": n_mamba, "flash_attention": n_flash}
    for _ in range(3):
        reset_model_launches()
        out = serve.generate(model, batch, n_tokens)
        torch.cuda.synchronize()
        launches, tc_launches = model_launches(), tensor_core_launches()
        if launches != per_run or tc_launches != tc_per_run:
            fail(f"{arch} serving launches {launches}, of them on the "
                 f"tensor-core instances {tc_launches}; expected {per_run}, "
                 f"{tc_per_run}")
        runs.append(out)
    out = runs[0]
    toks = out["tokens"]
    if tuple(toks.shape) != (SERVE_BATCH, n_tokens + 1) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        fail(f"{arch} serving tokens: shape {tuple(toks.shape)}, range "
             f"[{int(toks.min())}, {int(toks.max())}]")
    if any(not torch.equal(r["tokens"], toks) for r in runs[1:]):
        fail(f"{arch} serving is not deterministic across runs")
    walls["runs_s"] = time.perf_counter() - t0 - init_s

    # (a) kernel vs plain path
    def prefill(cache, batch):
        with torch.inference_mode():
            return model.prefill(batch, cache)

    checks = prefill_checks(arch, model, batch, prefill, n_mamba, n_flash,
                            per_pass)

    # the plain path end to end, for the tokens the two paths share
    with variant(model, False):
        out_p = serve.generate(model, batch, n_tokens)

    # (c) decode against the plain path
    with variant(model, True, torch.float32):
        run_f32 = serve.generate(model, batch, n_tokens)
    checks.update(decode_checks(arch, model, batch, out, run_f32, n_tokens))
    walls["checks_s"] = time.perf_counter() - t0 - init_s - walls["runs_s"]
    same = (out_p["tokens"] == toks)
    first_diff = [int(torch.nonzero(~row)[0]) if not bool(row.all())
                  else None for row in same]

    phase = dict(
        arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
        param_count=cfg.param_count(), init_s=init_s, batch=SERVE_BATCH,
        prompt_len=SERVE_PROMPT, prefill_len=serve.prefill_len(batch),
        decode_tokens=n_tokens, launches_per_run=launches,
        tensor_core_launches_per_run=tc_launches,
        launches_per_prefill={"ssd": n_mamba, "flash_attention": n_flash,
                              "rmsnorm": per_pass},
        prefill_ms=[r["prefill_ms"] for r in runs],
        decode_s=[r["decode_s"] for r in runs], checks=checks,
        greedy_tokens_shared=int(same.sum()), greedy_tokens=same.numel(),
        first_divergence=first_diff, walls=walls, abstract=abstract,
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {"launches": launches, "captured": captured, "cfg": cfg,
            "model": model, "batch": batch, "phase": phase}


def tree_tensors(tree) -> list:
    """Every tensor of a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return []


def abstract_checks(arch, model, max_len: int) -> dict:
    """The dry-run's abstract state against the real one: the bytes of
    ``abstract_params`` / ``abstract_cache`` (a meta build of the same
    configuration) equal the bytes of the model's parameters and of its
    ``init_cache(SERVE_BATCH, max_len)``, and the allocator's
    ``memory_allocated()`` grows by the cache's bytes within its block
    rounding: each tensor's size up to a multiple of 512 bytes, and a
    block of the large pool (tensors over 1 MiB) left unsplit when less
    than 1 MiB of it would remain."""
    from repro_torch.launch.abstract import abstract_cache, abstract_params
    from repro_torch.models.model import DecoderLM

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    meta = DecoderLM(model.cfg, device="meta")
    p_abs, _ = abstract_params(meta)
    c_abs, _ = abstract_cache(meta, SERVE_BATCH, max_len)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache = model.init_cache(SERVE_BATCH, max_len)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    real = tree_tensors(cache)
    out = {"param_bytes": nbytes(model.parameters()),
           "abstract_param_bytes": nbytes(p_abs.values()),
           "cache_bytes": nbytes(real),
           "abstract_cache_bytes": nbytes(tree_tensors(c_abs)),
           "init_cache_allocated": delta,
           "cache_bytes_in_blocks": sum(
               -(-t.numel() * t.element_size() // 512) * 512 for t in real),
           "large_pool_tensors": sum(
               t.numel() * t.element_size() > 2 ** 20 for t in real)}
    del cache, real
    bound = out["cache_bytes_in_blocks"] + out["large_pool_tensors"] * 2 ** 20
    if out["param_bytes"] != out["abstract_param_bytes"] \
            or out["cache_bytes"] != out["abstract_cache_bytes"] \
            or not out["cache_bytes"] <= delta <= bound:
        fail(f"{arch} abstract state vs real: {out}")
    return out


EP_LAYOUTS = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2}}


def moe_ep_check(res) -> dict:
    """MoE's expert-parallel branch on the deepseek model already built: a
    full-width SERVE_BATCH x SERVE_PROMPT prefill under a 1 x 4 and a 2 x 2
    ``ModelMesh`` on the one card, against the single-shard run in f32.
    1 x 4 is held to the whole batch's single-shard prefill; 2 x 2, whose
    capacity is a batch half's, to the two halves' single-shard prefills.
    Replaying the single-shard runs' routing (``routing``: under the mesh a
    batch slice's ranks make the same two selections a layer that a
    single-shard run of the slice makes) the logits agree to SERVE_F32_TOL;
    left to route themselves, the flips are counted.  Prefill ms of each
    layout, routing itself, in bf16 as served.  RMSNorm launches of the
    mesh runs are counted (55 a prefill)."""
    from repro_torch.parallel.sharding import ModelMesh, sharding_ctx
    model, cfg, batch = res["model"], res["cfg"], res["batch"]
    dev = batch["tokens"].device
    f32, bf16 = torch.float32, torch.bfloat16
    half = SERVE_BATCH // 2
    halves = [{"tokens": batch["tokens"][:half]},
              {"tokens": batch["tokens"][half:]}]

    def prefill(b, mesh=None, dtype=f32, mode=None, log=None):
        with variant(model, True, dtype), routing(mode, log), \
                torch.inference_mode(), sharding_ctx(mesh):
            cache = model.init_cache(b["tokens"].shape[0], SERVE_PROMPT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, lg = model.prefill(b, cache)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return lg[:, -1].float(), ms

    logs = {"whole": [], "h0": [], "h1": []}
    single, _ = prefill(batch, mode="record", log=logs["whole"])
    split = torch.cat([prefill(h, mode="record", log=logs[k])[0]
                       for h, k in zip(halves, ("h0", "h1"))])
    # under 2 x 2 each layer routes batch half 0, then half 1
    interleaved = [e for i in range(0, len(logs["h0"]), 2)
                   for e in logs["h0"][i:i + 2] + logs["h1"][i:i + 2]]
    replay = {"1x4": (logs["whole"], single), "2x2": (interleaved, split)}
    out = {"single_shard_logits_max": float(single.abs().max())}
    reset_model_launches()
    n_mesh_prefills = 0
    for name, shape in EP_LAYOUTS.items():
        mesh = ModelMesh.of(shape, dev)
        log, want = replay[name]
        got, _ = prefill(batch, mesh, mode="replay", log=log)
        own_log = []
        own, _ = prefill(batch, mesh, mode="record", log=own_log)
        n_mesh_prefills += 2
        err = float((got - want).abs().max())
        out[f"{name} f32 vs single shard, same routing"] = err
        out[f"{name} f32 vs single shard, own routing"] = float(
            (own - want).abs().max())
        out[f"{name} f32 routing flips (rows of "
            f"{sum(len(x) for x in own_log)})"] = routing_flips(own_log, log)
        if not err < SERVE_F32_TOL or not bool(torch.isfinite(got).all()):
            fail(f"deepseek EP {name}: logits off by {err} from the "
                 f"single-shard run")
    launches = model_launches()
    if launches != {"ssd": 0, "flash_attention": 0,
                    "rmsnorm": path_launches(cfg)[2] * n_mesh_prefills}:
        fail(f"deepseek EP launches {launches}")
    ms = {}
    for name, shape in (("single", None),) + tuple(EP_LAYOUTS.items()):
        mesh = None if shape is None else ModelMesh.of(shape, dev)
        ms[name] = [prefill(batch, mesh, bf16)[1] for _ in range(3)]
    out["prefill_ms_bf16 (3 runs)"] = ms
    return {"checks": out, "launches": launches}


DRYRUN_JOBS = 6


def dryrun_phase(smi: str) -> dict:
    """The port's dry-run (``repro_torch.launch.dryrun``) of all 40 cells
    on both production meshes without a trace, plus each cell traced on
    the single-pod mesh, DRYRUN_JOBS cells at a time in worker processes
    (meta tensors: host work).  ``fits`` holds each per-device total to
    this card's memory.  Fails on any error, or if a traced record's
    memory differs from its untraced twin's."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun
    device_bytes = torch.cuda.get_device_properties(0).total_memory
    pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    cells = ([(a, s, mp, False) for a, s in pairs for mp in (False, True)]
             + [(a, s, False, True) for a, s in pairs])
    t0 = time.perf_counter()
    recs = dryrun.run_cells(cells, DRYRUN_JOBS, device_bytes)
    seconds = time.perf_counter() - t0
    errors = [(c, r["error"]) for c, r in zip(cells, recs)
              if r["status"] == "error"]
    if errors:
        fail(f"dryrun: {len(errors)} cells failed, first {errors[0]}")
    by = {(c[0], c[1], c[2], c[3]): r for c, r in zip(cells, recs)}
    rows = {}
    for a, s in pairs:
        for mp in (False, True):
            r = by[(a, s, mp, False)]
            if r["status"] != "ok":
                continue
            row = {"per_device_total": r["memory"]["per_device_total"],
                   "argument_size_in_bytes":
                       r["memory"]["argument_size_in_bytes"],
                   "fits": r["fits"]}
            if not mp:
                t = by[(a, s, False, True)]
                if t["memory"] != r["memory"]:
                    fail(f"dryrun {a}.{s}: traced memory {t['memory']} vs "
                         f"{r['memory']}")
                row.update(model_flops=t["cost"]["model_flops"],
                           trace_s=t["trace_s"])
            rows[f"{a}.{s}.{'multi' if mp else 'single'}"] = row
    untraced, traced = recs[:2 * len(pairs)], recs[2 * len(pairs):]
    count = {k: sum(r["status"] == k for r in untraced)
             for k in ("ok", "skipped", "error")}
    return {"card": smi, "device_bytes": device_bytes, "jobs": DRYRUN_JOBS,
            "untraced_cells": count,
            "traced_single_pod": {k: sum(r["status"] == k for r in traced)
                                  for k in ("ok", "skipped", "error")},
            "fit_card": {m: sum(bool(v["fits"]) for k, v in rows.items()
                                if k.endswith(m))
                         for m in (".single", ".multi")},
            "trace_s_total": sum(r.get("trace_s", 0.0) for r in traced),
            "seconds": seconds, "cells": rows}


def moe_combine_check(res) -> dict:
    """(c) of the deepseek phase: layer 0's MoE block on the card at the
    serving prefill's shape twice, the same bits, and its combine the bits
    of one ``index_add_`` an expert in ascending expert order (JAX's
    expert-major scatter-add); and the norms' inputs the path handed the
    kernel, in the layout model_kernel_phase timed (drawn there) and
    against the plain version."""
    from repro_torch.kernels.rmsnorm import kernel as rn_kernel
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.models import moe as moe_mod
    model, cfg, dev = res["model"], res["cfg"], res["batch"]["tokens"].device
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    p = model.blocks[0]["global_0"].ffn
    seen, real = [], moe_mod.combine

    def spy(*args):
        seen.append(args)
        return real(*args)

    moe_mod.combine = spy
    try:
        with torch.inference_mode():
            y1 = moe_mod.moe_block(cfg, p, x)
            y2 = moe_mod.moe_block(cfg, p, x)
    finally:
        moe_mod.combine = real
    torch.cuda.synchronize()
    if not torch.equal(y1.view(torch.int16), y2.view(torch.int16)):
        fail("deepseek MoE block: two calls differ")
    yg, idx, valid, T, k = seen[0]
    want = torch.zeros((T, yg.shape[-1]), dtype=yg.dtype, device=dev)
    for e in range(yg.shape[0]):
        want.index_add_(0, idx[e], yg[e])
    got = real(yg, idx, valid, T, k)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        fail("deepseek MoE combine differs from the expert-order "
             "index_add_")
    out = {"moe_block_repeat_bit_identical": True,
           "combine_equals_expert_order_index_add": True,
           "capacity": int(idx.shape[1]),
           "dropped_routed_entries": int(
               (T * k) - int(valid.sum()))}
    for key in ("rmsnorm", "rmsnorm decode"):
        (xn, s, *rest), _ = res["captured"][key]
        want_shape = ((SERVE_BATCH, SERVE_PROMPT, cfg.d_model)
                      if key == "rmsnorm" else (SERVE_BATCH, 1, cfg.d_model))
        if tuple(xn.shape) != want_shape or not xn.is_contiguous():
            fail(f"deepseek serving {key} input {tuple(xn.shape)} strides "
                 f"{xn.stride()}, timed as {want_shape} contiguous")
        err, mag, ratio = close(rn_kernel.rmsnorm(xn, s.detach()),
                                rn_ref.rmsnorm(xn, s.detach()), 5e-2)
        if not ratio < 1.0:
            fail(f"deepseek serving {key}: error {err}, {ratio} of bound")
        out[f"serving {key} err"] = err
    return out


def mla_checks(dev) -> dict:
    """(a) and (b) of the deepseek phase, on a 4-layer full-width
    deepseek_v2_lite_16b with a dense MLP (``moe=None``, seeded weights),
    f32 compute, kernels on: a 1024-token prefill and 8 decode steps give
    the logits of a forward over the same tokens to SERVE_F32_TOL (JAX's
    ``test_mla_decode_exact_without_moe``), and ``absorbed_decode`` gives
    those of the decompressing branch to 1e-3."""
    from repro_torch.launch import serve
    from repro_torch.models.model import DecoderLM
    cfg = dataclasses.replace(serve_config("deepseek_v2_lite_16b", 4),
                              moe=None, family="dense")
    model = DecoderLM(cfg, device=dev, seed=0)
    batch = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT + 8, dev)
    toks = batch["tokens"]
    prompt = {"tokens": toks[:, :SERVE_PROMPT]}
    f32 = torch.float32
    dec = teacher_forced(model, prompt, toks[:, SERVE_PROMPT:], True, f32)
    with variant(model, True, f32), torch.inference_mode():
        fwd = model.forward(batch)[:, SERVE_PROMPT - 1:].float()
    model.cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, absorbed_decode=True))
    absorbed = teacher_forced(model, prompt, toks[:, SERVE_PROMPT:], True,
                              f32)
    out = {"decode vs forward f32 (moe=None, 4 layers)":
           float((dec - fwd).abs().max()),
           "absorbed vs decompressing f32":
           float((absorbed - dec).abs().max()),
           "logits_max": float(fwd.abs().max())}
    if out["decode vs forward f32 (moe=None, 4 layers)"] >= SERVE_F32_TOL:
        fail(f"deepseek MLA decode vs forward: {out}")
    if out["absorbed vs decompressing f32"] >= 1e-3:
        fail(f"deepseek MLA absorbed vs decompressing: {out}")
    return out


def arctic_meta() -> dict:
    """arctic_480b built on the meta device (no weights drawn): its
    parameters are cfg.param_count() plus the norms' scales."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import DecoderLM
    cfg = get_config("arctic_480b")
    n = sum(p.numel() for p in DecoderLM(cfg, device="meta").parameters())
    want = cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model
    if n != want:
        fail(f"arctic_480b on meta: {n} params, expected {want}")
    return {"params": n, "param_count": cfg.param_count()}


# ---------------------------------------------------------------------------
# The Experiment API on the card: the quickstart, a cardinality batch, and
# both committed scenario configs (regime streams).
# ---------------------------------------------------------------------------

EXPERIMENT_SAMPLES = 20_000
EXPERIMENT_TRIALS = 10 ** 6
EXPERIMENT_CHUNK = 65_536
SCENARIOS = ("examples/scenarios/diurnal_wan.json",
             "examples/scenarios/trace_replay.json")
STREAM_FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
                 "max_ms")


@contextlib.contextmanager
def plain_quorum_kernels():
    """The quorum-tally kernels swapped for their plain versions (on the
    card's tensors): the dispatch calls ``ref`` and launches nothing."""
    from repro_torch.kernels.quorum_tally import kernel, ref
    saved = {k: getattr(kernel, k) for k in QUORUM_KERNELS}
    for k in QUORUM_KERNELS:
        setattr(kernel, k, getattr(ref, k))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(kernel, k, fn)


def same_stream(a, b, what: str) -> None:
    """Stream summaries (plain or regime-decomposed): integers and maxima
    equal, means within 1e-5 relative (f32 sums in another order)."""
    from repro_torch.montecarlo.regimes import RegimeStreamSummary
    pairs = [(a, b, what)]
    if isinstance(a, RegimeStreamSummary):
        if not torch.equal(a.occupancy, b.occupancy):
            fail(f"{what}: occupancy differs from the plain versions'")
        pairs += [(a.regime(i), b.regime(i), f"{what} regime {name}")
                  for i, name in enumerate(a.names)]
    for x, y, w in pairs:
        for f in STREAM_FIELDS:
            if not torch.equal(getattr(x, f), getattr(y, f)):
                fail(f"{w} {f} differs from the plain versions'")
        if not torch.allclose(x.mean_ms, y.mean_ms, rtol=1e-5, atol=0.0,
                              equal_nan=True):
            fail(f"{w} mean_ms off by more than 1e-5 relative")


def check_regime_stream(st, trials: int, m: int, what: str) -> None:
    """Occupancy sums to the trials and counts each slice's trials; the
    total is the merge of the slices, field by field."""
    occ = st.occupancy
    if int(occ.sum()) != trials:
        fail(f"{what}: occupancy {occ.tolist()} does not sum to {trials}")
    tot = st.total()
    per = [st.regime(i) for i in range(st.n_regimes)]
    for i, p in enumerate(per):
        if not bool((p.n_trials == occ[i]).all()):
            fail(f"{what}: regime {st.names[i]} counts {p.n_trials.tolist()}"
                 f" trials, occupancy {int(occ[i])}")
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist"):
        if not torch.equal(sum(getattr(p, f) for p in per), getattr(tot, f)):
            fail(f"{what}: total {f} is not the sum of the slices")
    if not torch.equal(torch.stack([p.max_ms for p in per]).amax(0),
                       tot.max_ms):
        fail(f"{what}: total max_ms is not the slices' max")
    if tot.n_trials.tolist() != [trials] * m:
        fail(f"{what}: {tot.n_trials.tolist()} trials, {trials} asked")


def experiment_run(name: str, exp, expect: dict, units: int) -> dict:
    """One Monte-Carlo run of an Experiment on the card: the main-path run
    (launch counts zeroed just before, read just after, ``expect`` held),
    three warm runs timed (median wall), one traced (busy and idle share),
    then the run with the plain versions, held to the kernel run."""
    from repro_torch.kernels.quorum_tally import ops
    ops.reset_launches()
    res = exp.run("montecarlo")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches != only(**expect):
        fail(f"experiment {name} launches {launches}, expected {expect}")

    def once():
        exp.run("montecarlo")
        torch.cuda.synchronize()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        once()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    prof = device_profile(once, top=4)
    with plain_quorum_kernels():
        ops.reset_launches()
        plain = exp.run("montecarlo")
        torch.cuda.synchronize()
        if any(ops.LAUNCHES.values()):
            fail(f"experiment {name}: the plain run launched {ops.LAUNCHES}")
    if res.raw is not None:
        for f in res.raw:
            if not torch.equal(res.raw[f], plain.raw[f]):
                fail(f"experiment {name} {f} differs from the plain "
                     f"versions'")
    else:
        same_stream(res.stream, plain.stream, f"experiment {name}")
    for k, v in res.summary.items():
        if tuple(v.shape) != (len(exp.systems),):
            fail(f"experiment {name} summary {k} shape {tuple(v.shape)}")
    lat = res.summary["p50_ms"]
    if not bool(torch.isfinite(lat).all()):
        fail(f"experiment {name}: p50 not finite {lat.tolist()}")
    return {"result": res, "row": dict(
        launches=launches, warm_wall_s=walls, wall_median_s=wall,
        per_sec=units / wall, units=units,
        device_busy_s=prof["device_busy_s"],
        busy_share=prof["device_busy_s"] / wall,
        idle_share=1.0 - prof["device_busy_s"] / wall,
        profiled_wall_s=prof["wall_s"],
        device_launches=sum(prof["by_kernel_n"].values()),
        top_ms=prof["top"],
        summary={k: [float(x) for x in v] for k, v in res.summary.items()
                 if k in ("p50_ms", "p99_ms", "recovery_rate",
                          "undecided_rate")})}


def experiment_phase(dev, smi: str) -> dict:
    """The Experiment API's four Monte-Carlo paths on the card, with the
    quickstart's DES and model-check backends: returns the rows and the
    launches by kernel on this path."""
    from repro_torch.api import Experiment, Workload
    from repro_torch.api.__main__ import quickstart, small_batch
    from repro_torch.core.quorum import QuorumSpec

    rows, launches = {}, {k: 0 for k in QUORUM_KERNELS}

    def record(name, exp, expect, units):
        r = experiment_run(name, exp, expect, units)
        rows[name] = r["row"]
        for k, v in r["row"]["launches"].items():
            launches[k] += v
        return r["result"]

    # (a) the quickstart: montecarlo (masked_tally), des and modelcheck
    quick = quickstart(device=dev)
    mc = record("quickstart", quick, dict(masked_tally=1, masked_sat=3,
                                          sorted_prefix=3),
                EXPERIMENT_SAMPLES)
    t0 = time.perf_counter()
    des = quick.run("des")
    des_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mcheck = small_batch().run("modelcheck")
    mcheck_s = time.perf_counter() - t0
    for i, label in enumerate(quick.labels):
        p_mc, p_des = float(mc.summary["p50_ms"][i]), des.summary["p50_ms"][i]
        r_mc = float(mc.summary["recovery_rate"][i])
        r_des = des.summary["recovery_rate"][i]
        if abs(p_mc - p_des) / p_des >= 0.05 or abs(r_mc - r_des) >= 0.05:
            fail(f"quickstart {label}: montecarlo p50 {p_mc}, P(recovery) "
                 f"{r_mc} vs des {p_des}, {r_des}")
    if not all(v["ok"] for v in mcheck.safety):
        fail(f"quickstart modelcheck: {mcheck.summary}")
    rows["quickstart"].update(
        des_wall_s=des_s, des_p50_ms=des.summary["p50_ms"],
        des_recovery_rate=des.summary["recovery_rate"],
        modelcheck_wall_s=mcheck_s, modelcheck=mcheck.summary)

    # (b) cardinality only: tally_decide materialized, race_card_hist
    # streamed
    card = Experiment(systems=[QuorumSpec.paper_headline(11),
                               QuorumSpec.fast_paxos(11),
                               QuorumSpec.majority_fast(11)],
                      workload=Workload.race(k=2, delta_ms=0.2),
                      samples=EXPERIMENT_SAMPLES, device=dev)
    chunks = -(-EXPERIMENT_TRIALS // EXPERIMENT_CHUNK)
    record("cardinality", card, dict(tally_decide=1, sorted_prefix=3),
           EXPERIMENT_SAMPLES)
    record("cardinality_stream",
           dataclasses.replace(card, trials=EXPERIMENT_TRIALS,
                               chunk=EXPERIMENT_CHUNK),
           dict(race_card_hist=chunks), EXPERIMENT_TRIALS)

    # (c) the quickstart's systems streamed: the fused stream kernel
    record("quickstart_stream",
           dataclasses.replace(quick, trials=EXPERIMENT_TRIALS,
                               chunk=EXPERIMENT_CHUNK),
           dict(stream_tally_decide_hist=chunks), EXPERIMENT_TRIALS)

    # (d) both committed configs, loaded unchanged: regime streams decide
    # through masked_tally and three masked_sat a chunk (diurnal_wan has a
    # grid) and tally_decide, each chunk's draws sorted by three
    # sorted_prefix
    for path, kern in zip(SCENARIOS, ("masked_tally", "tally_decide")):
        exp = Experiment.from_config(os.path.join(ROOT, path), device=dev)
        name = os.path.basename(path)[:-len(".json")]
        chunks = -(-exp.trials // exp.chunk)
        expect = {kern: chunks, "sorted_prefix": 3 * chunks}
        if kern == "masked_tally":
            expect["masked_sat"] = 3 * chunks
        st = record(name, exp, expect, exp.trials).stream
        check_regime_stream(st, exp.trials, len(exp.systems), name)
        rows[name].update(trials=exp.trials, chunk=exp.chunk,
                          regimes=list(st.names),
                          occupancy=st.occupancy.tolist())
    return {"card": smi, "rows": rows, "launches": launches}


# The mesh phase: the sweep's race pass (271 n=11 systems, 10^7 trials,
# chunk 16384) on 1 process x 4 domains in this process and on 2 x 2
# through the launcher; JAX's fixed workload (2 systems, 50,011 trials,
# chunk 2048) on 1 x 8 and 2 x 4; an explicit 1-domain mesh against the
# unsharded stream, and 3 trials on 4 domains.
MESH_TRIALS, MESH_CHUNK, MESH_DOMAINS = 10_000_000, 16_384, 4
MESH_FIXED_TRIALS, MESH_FIXED_CHUNK = 50_011, 2_048
MESH_ONE_TRIALS = 10_007
MESH_TIMEOUT_S = 300


def same_layout(a: dict, b: dict, what: str) -> bool:
    """Two layouts' summaries (npz dicts): counts and histogram the same
    bits, max_ms equal, mean_ms within 1e-5 relative.  Returns whether
    the means are the same bits too."""
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        if not np.array_equal(a[f], b[f]):
            fail(f"{what}: {f} differs between layouts")
    if not np.allclose(a["mean_ms"], b["mean_ms"], rtol=1e-5, atol=0.0):
        fail(f"{what}: mean_ms off by more than 1e-5 relative")
    return bool(np.array_equal(a["mean_ms"], b["mean_ms"]))


def mesh_phase(dev, smi: str, compute_mode: str) -> dict:
    """The multi-process trial mesh on the card (``repro_torch.parallel``,
    the streams' ``shard=``): returns the rows and the 1 x 4 pass's
    launches by kernel."""
    import tempfile
    from repro_torch.kernels.quorum_tally import ops
    from repro_torch.montecarlo import streaming
    from repro_torch.parallel import distributed, sharding

    if compute_mode != "Default":
        fail(f"compute mode {compute_mode!r}: two processes on one card "
             f"need the Default mode")
    rows = {"card": smi, "compute_mode": compute_mode}

    def layout(procs, per, name, trials, chunk, td):
        out = os.path.join(td, f"{name}_{procs}x{per}.npz")
        t0 = time.perf_counter()
        try:
            got = distributed.run_stream_layout(
                procs, per, out, trials=trials, chunk=chunk, name=name,
                device="cuda", timeout_s=MESH_TIMEOUT_S)
        except RuntimeError as e:
            fail(f"mesh {name} {procs} x {per}: {e}")
        got["launch_wall_s"] = time.perf_counter() - t0
        return got

    # (i) the sweep's race pass: 1 x 4 here, unsharded, 2 x 2 launched
    key, table, offsets = distributed.workload("sweep", dev)
    kw = dict(n=11, k_proposers=2, trials=MESH_TRIALS, chunk=MESH_CHUNK)
    mesh = sharding.trial_mesh(dev, MESH_DOMAINS)
    per_domain = -(-(-(-MESH_TRIALS // MESH_DOMAINS)) // MESH_CHUNK)
    streaming.race_stream(key, table, offsets, shard=False,
                          **dict(kw, trials=4 * MESH_CHUNK))   # warm
    ops.reset_launches()
    t0 = time.perf_counter()
    one = streaming.race_stream(key, table, offsets, shard=mesh, **kw)
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches != only(race_card_hist=MESH_DOMAINS * per_domain):
        fail(f"mesh 1 x {MESH_DOMAINS} launches {launches}")
    t0 = time.perf_counter()
    un = streaming.race_stream(key, table, offsets, shard=False, **kw)
    torch.cuda.synchronize()
    wall_un = time.perf_counter() - t0
    one_np, un_np = one.to_numpy(), un.to_numpy()
    if not ((one_np["n_trials"] == MESH_TRIALS).all()
            and (un_np["n_trials"] == MESH_TRIALS).all()):
        fail("mesh sweep: trial counts")
    if not np.array_equal(one_np["hist"].sum(1),
                          one_np["n_fast"] + one_np["n_recovery"]):
        fail("mesh sweep: histogram mass != decided count")
    p_one = one.quantile([0.5, 0.999]).cpu().numpy()
    p_un = un.quantile([0.5, 0.999]).cpu().numpy()
    if not (np.abs(p_one - p_un) <= 0.03 * p_un).all():
        fail(f"mesh sweep: sharded p50 / p99.9 more than 3% from the "
             f"unsharded pass's (max {np.max(np.abs(p_one - p_un) / p_un)})")
    with tempfile.TemporaryDirectory() as td:
        two = layout(2, 2, "sweep", MESH_TRIALS, MESH_CHUNK, td)
        bits = same_layout(one_np, two, "mesh sweep 2 x 2 vs 1 x 4")
        if int(two["race_card_hist_launches"]) != 2 * per_domain:
            fail(f"mesh sweep 2 x 2: process 0 launched "
                 f"{int(two['race_card_hist_launches'])} race_card_hist")
        rows["sweep"] = dict(
            systems=int(one_np["n_trials"].shape[0]), trials=MESH_TRIALS,
            chunk=MESH_CHUNK, launches_1x4=launches,
            launches_2x2_process0=int(two["race_card_hist_launches"]),
            wall_s_1x4=wall_one, wall_s_unsharded=wall_un,
            wall_s_2x2_stream=float(two["wall_s"]),
            wall_s_2x2_launch=two["launch_wall_s"],
            mean_same_bits_2x2=bits,
            max_rel_p50_p999_vs_unsharded=float(
                np.max(np.abs(p_one - p_un) / p_un)))

        # (ii) JAX's fixed workload: 1 x 8 against 2 x 4
        eight = layout(1, 8, "fixed", MESH_FIXED_TRIALS, MESH_FIXED_CHUNK,
                       td)
        four = layout(2, 4, "fixed", MESH_FIXED_TRIALS, MESH_FIXED_CHUNK,
                      td)
    bits = same_layout(eight, four, "mesh fixed 2 x 4 vs 1 x 8")
    if int(eight["global_devices"]) != 8 or int(four["global_devices"]) != 8:
        fail("mesh fixed: not 8 global domains")
    if not (four["n_trials"] == MESH_FIXED_TRIALS).all():
        fail("mesh fixed: trial counts")
    rows["fixed"] = dict(
        trials=MESH_FIXED_TRIALS, chunk=MESH_FIXED_CHUNK,
        launches_1x8=int(eight["race_card_hist_launches"]),
        launches_2x4_process0=int(four["race_card_hist_launches"]),
        wall_s_1x8_stream=float(eight["wall_s"]),
        wall_s_2x4_stream=float(four["wall_s"]),
        wall_s_1x8_launch=eight["launch_wall_s"],
        wall_s_2x4_launch=four["launch_wall_s"], mean_same_bits=bits,
        p50_ms=four["p50_ms"].tolist(), p9999_ms=four["p9999_ms"].tolist())

    # (iii) an explicit 1-domain mesh runs the sharded path (domain keys,
    # other draws); 3 trials on 4 domains leave one empty
    key, table, offsets = distributed.workload("fixed", dev)
    kw = dict(n=11, k_proposers=2, trials=MESH_ONE_TRIALS,
              chunk=MESH_FIXED_CHUNK)
    st = streaming.race_stream(key, table, offsets,
                               shard=sharding.trial_mesh(dev, 1), **kw)
    un = streaming.race_stream(key, table, offsets, shard=False, **kw)
    if st.n_trials.tolist() != un.n_trials.tolist() or \
            st.n_trials.tolist() != [MESH_ONE_TRIALS] * 2:
        fail("mesh 1-domain: trial totals")
    if torch.equal(st.hist, un.hist):
        fail("mesh 1-domain: the same draws as the unsharded stream")
    rel = ((st.quantile(0.5) - un.quantile(0.5)).abs()
           / un.quantile(0.5)).cpu()
    if not bool((rel < 0.05).all()):
        fail(f"mesh 1-domain: p50 {rel.tolist()} relative off")
    few = streaming.fast_path_stream(key, table, n=11, trials=3, chunk=64,
                                     shard=sharding.trial_mesh(dev, 4))
    if few.n_trials.tolist() != [3, 3] or int(few.hist.sum()) != \
            int(few.n_decided.sum()) or not bool(
                torch.isfinite(few.max_ms).all()):
        fail(f"mesh 3 trials on 4 domains: {few.n_trials.tolist()}")
    rows["one_domain"] = dict(p50_rel_diff=rel.tolist(),
                              three_on_four=few.n_fast.tolist())
    return {"rows": rows, "launches": launches}


# The planner phase: JAX's acceptance search (n=11, 10^6 final trials,
# rungs of 10^5 and 10^6, chunk 16384, seed 0), its warm repeat, the
# n=11 "all" family and a weighted search under diurnal_wan.json's regime
# workload at 10^5 trials (default schedule and chunk), and the server
# (two concurrent n=11 queries of 10^5 trials at chunk 16384: a rung of
# 10^4 trials materialized, tally_decide).
PLANNER_N = 11
PLANNER_TRIALS = 10 ** 6
PLANNER_CHUNK = 16_384
PLANNER_SCHEDULE = ((100_000, 1.0), (1_000_000, 1.0))
PLANNER_ALL_TRIALS = 10 ** 5
PLANNER_BUDGET = 0.40


def rung_launches(rungs, batches, chunk: int, regimes: bool) -> dict:
    """The quorum kernels' launches a search's race passes make: a
    cardinality batch (``"q"`` in its table) streams through
    ``race_card_hist`` a chunk and materializes (trials <= chunk) through
    one ``tally_decide``; a masked batch through the fused stream kernel a
    chunk, or one ``masked_tally``.  Regime streams decide every chunk
    through ``tally_decide`` / ``masked_tally``.  A masked batch's
    ``masked_tally`` call comes with three ``masked_sat`` (the race's fast,
    detection and recovery saturations), and its fast pass takes one
    ``masked_sat`` a chunk, or one.  Every batch's fast pass sorts through
    one ``sorted_prefix`` a chunk, or one, and a generic race through
    three a call.  ``batches[i]`` are rung i's members."""
    from repro_torch.frontier.score import _as_masks
    out = only()
    for r, members in zip(rungs, batches):
        card = all(m.cardinality_q() is not None
                   for m in _as_masks(members, None)[0])
        chunks = -(-r.trials // chunk)
        generic = regimes or r.trials <= chunk
        calls = chunks if regimes or r.trials > chunk else 1
        out["sorted_prefix"] += calls + (3 * calls if generic else 0)
        if card:
            out["tally_decide" if generic else "race_card_hist"] += calls
            continue
        if generic:
            out["masked_tally"] += calls
            out["masked_sat"] += 3 * calls
        else:
            out["stream_tally_decide_hist"] += calls
        out["masked_sat"] += calls
    return out


def survivors_by_family(members) -> dict:
    """How many of a search's survivors each family holds (by label)."""
    out = {}
    for m in members:
        fam = m.label.split("[")[0].split(".")[0]
        out[fam] = out.get(fam, 0) + 1
    return out


def planner_query(name: str, planner, query: dict, expect, *, cold: bool,
                  fresh=None) -> tuple:
    """One ``Planner.plan`` on the card: launch counts zeroed just before
    and read just after (held to ``expect``: a dict, or a function of the
    search's rungs and batches), launch plans built, untraced wall; then
    the same query traced (on ``fresh()``, a new planner, where the query
    is cold) for the card's busy time and idle share."""
    from repro_torch.kernels.quorum_tally import ops
    plans0 = ops.launch_plans()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = planner.plan(query)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    built = ops.launch_plans() - plans0
    if not res.ok:
        fail(f"planner {name}: {res.reason}")
    if res.cold != cold:
        fail(f"planner {name}: cold {res.cold}, expected {cold}")
    if res.engine_compiles != (built if cold else 0):
        fail(f"planner {name}: engine_compiles {res.engine_compiles}, "
             f"{built} launch plans built")
    # the search that answered: the planner's LRU, newest last
    sr = list(planner._searches.values())[-1]
    want = expect(sr) if callable(expect) else expect
    if launches != want:
        fail(f"planner {name} launches {launches}, expected {want}")
    target = fresh() if fresh is not None else planner
    prof = device_profile(lambda: target.plan(query), top=4)
    row = dict(
        launches=launches, launch_plans_built=built, wall_s=wall,
        device_busy_s=prof["device_busy_s"],
        idle_share=1.0 - prof["device_busy_s"] / wall,
        profiled_wall_s=prof["wall_s"],
        device_launches=sum(prof["by_kernel_n"].values()),
        top_ms=prof["top"], cold=res.cold,
        engine_compiles=res.engine_compiles,
        recommended=res.recommended, fault_tolerance=res.fault_tolerance,
        predicted_ms=res.predicted_ms,
        budget_fraction=res.search["budget_fraction"],
        rungs=[r.to_dict() for r in sr.rungs],
        frontier=list(res.frontier_labels))
    return res, sr, row


def planner_plain(name: str, dev, query: dict, sr) -> float:
    """The query's search again, on a new planner with the plain versions:
    nothing launches, every rung scores and keeps as many systems, the
    survivors and the final frontier (labels, values, mask) are equal, and
    its fast and race streams agree as ``same_stream`` holds them.  Returns
    the plain search's wall seconds."""
    from repro_torch.kernels.quorum_tally import ops
    from repro_torch.planner import Planner
    planner = Planner(device=dev)
    query = {k: v for k, v in query.items() if k != "op"}
    with plain_quorum_kernels():
        ops.reset_launches()
        t0 = time.perf_counter()
        planner.plan(query)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(ops.LAUNCHES.values()):
            fail(f"planner {name}: the plain search launched {ops.LAUNCHES}")
    ref = list(planner._searches.values())[-1]
    got = [(r.trials, r.n_scored, r.n_survivors) for r in sr.rungs]
    want = [(r.trials, r.n_scored, r.n_survivors) for r in ref.rungs]
    if got != want:
        fail(f"planner {name}: rungs {got}, the plain versions' {want}")
    a, b = sr.frontier, ref.frontier
    if tuple(a.labels) != tuple(b.labels):
        fail(f"planner {name}: survivors {a.labels}, the plain versions' "
             f"{b.labels}")
    if not np.array_equal(a.values, b.values, equal_nan=True):
        fail(f"planner {name}: frontier values differ from the plain "
             f"versions'")
    if not np.array_equal(np.asarray(a.mask), np.asarray(b.mask)):
        fail(f"planner {name}: frontier mask differs from the plain versions'")
    for k in ("fast", "race"):
        same_stream(a.streams[k], b.streams[k], f"planner {name} {k}")
    return wall


def planner_phase(dev) -> dict:
    """The search-and-serve planner (``repro_torch.planner``) on the card:
    returns the rows and the launches by kernel on this path."""
    import threading
    from repro_torch.api import Experiment
    from repro_torch.frontier import families, score_systems
    from repro_torch.kernels.quorum_tally import ops
    from repro_torch.planner import Planner, PlannerServer, query_server

    rows, launches = {}, only()
    fresh = lambda: Planner(device=dev)

    def record(name, *args, **kw):
        res, sr, row = planner_query(name, *args, **kw)
        rows[name] = row
        for k, v in row["launches"].items():
            launches[k] += v
        return res, sr

    # 1. cold: the acceptance search against the direct 271-system sweep
    planner = fresh()
    geo = dict(n=PLANNER_N, family="cardinality", trials=PLANNER_TRIALS,
               schedule=PLANNER_SCHEDULE, chunk=PLANNER_CHUNK, seed=0)
    members = families.cardinality_family(PLANNER_N)
    res, sr = record("cold", planner, dict(geo, faults={"classic": 1}),
                     lambda s: rung_launches(s.rungs, [members, s.members],
                                             PLANNER_CHUNK, False),
                     cold=True, fresh=fresh)
    direct = score_systems(members, n=PLANNER_N, trials=PLANNER_TRIALS,
                           chunk=PLANNER_CHUNK, seed=0, device=dev)
    if set(res.frontier_labels) != set(direct.frontier_labels):
        fail(f"planner frontier {res.frontier_labels} is not the direct "
             f"sweep's {direct.frontier_labels}")
    didx = {l: i for i, l in enumerate(direct.labels)}
    for row, label in enumerate(sr.frontier.labels):
        a, b = sr.frontier.values[row], direct.values[didx[label]]
        if not np.array_equal(a, b, equal_nan=True):
            fail(f"planner survivor {label}: {a.tolist()} is not the direct "
                 f"row {b.tolist()}")
    if res.search["budget_fraction"] > PLANNER_BUDGET:
        fail(f"planner budget fraction {res.search['budget_fraction']}")
    if res.fault_tolerance["classic"] < 1:
        fail(f"planner cold: {res.fault_tolerance} misses the budget")
    rows["cold"].update(direct_frontier=list(direct.frontier_labels),
                        n_survivors=len(sr.members),
                        plain_wall_s=planner_plain(
                            "cold", dev, dict(geo, faults={"classic": 1}),
                            sr))

    # 2. warm: same geometry, another budget and objective
    res, _ = record("warm", planner,
                    dict(geo, faults={"fast": 1, "phase1": 1},
                         objective="fast_p50_ms"), only(), cold=False)
    if res.fault_tolerance["fast"] < 1 or res.fault_tolerance["phase1"] < 1:
        fail(f"planner warm: {res.fault_tolerance} misses the budget")

    # 3. the n=11 "all" family (masked table), peak device memory
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    q_all = dict(n=PLANNER_N, family="all", trials=PLANNER_ALL_TRIALS,
                 seed=0)
    from repro_torch.frontier.score import DEFAULT_CHUNK
    batches = lambda s: [families.all_families(PLANNER_N), s.members]
    _, sr = record("all", planner, q_all,
                   lambda s: rung_launches(s.rungs, batches(s),
                                           DEFAULT_CHUNK, False),
                   cold=True, fresh=fresh)
    rows["all"].update(peak_bytes=torch.cuda.max_memory_allocated(),
                       allocated_before_bytes=mem0,
                       n_candidates=len(families.all_families(PLANNER_N)),
                       survivors_by_family=survivors_by_family(sr.members),
                       plain_wall_s=planner_plain("all", dev, q_all, sr))
    if not rows["all"]["launches"]["stream_tally_decide_hist"]:
        fail("planner all: the fused stream kernel did not run")

    # 4. a weighted search under diurnal_wan.json's regime workload
    cfg = os.path.join(ROOT, "examples/scenarios/diurnal_wan.json")
    exp = Experiment.from_config(cfg, device=dev)
    q_reg = dict(n=exp.n, family="weighted", trials=PLANNER_ALL_TRIALS,
                 workload=exp.workload.to_dict(), seed=0)
    wmembers = families.family("weighted", exp.n)
    _, sr = record("regimes", planner, q_reg,
                   lambda s: rung_launches(s.rungs, [wmembers, s.members],
                                           DEFAULT_CHUNK, True),
                   cold=True, fresh=fresh)
    rows["regimes"].update(n=exp.n, n_candidates=len(wmembers),
                           survivors_by_family=survivors_by_family(
                               sr.members),
                           plain_wall_s=planner_plain("regimes", dev, q_reg,
                                                      sr))

    # 5. the server: two concurrent same-geometry queries, one search
    server = PlannerServer(device=dev, port=0, batch_window_s=0.05)
    server.start()
    try:
        q_srv = dict(op="plan", n=PLANNER_N, family="cardinality",
                     trials=PLANNER_ALL_TRIALS, chunk=PLANNER_CHUNK, seed=0)
        replies = [None, None]

        def ask(i, faults):
            replies[i] = query_server(dict(q_srv, faults=faults),
                                      port=server.port)

        ops.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i, f)) for i, f in
                   enumerate(({"classic": 1}, {"fast": 1}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        srv_launches = dict(ops.LAUNCHES)
        if any(t.is_alive() for t in threads) or not all(
                r and r["ok"] for r in replies):
            fail(f"planner server: replies {replies}")
        stats = query_server({"op": "stats"}, port=server.port)
        if stats["search_misses"] != 1.0:
            fail(f"planner server: {stats['search_misses']} searches for "
                 f"two same-geometry queries")
        if sorted(r["engine_compiles"] for r in replies)[0] != 0:
            fail(f"planner server: the repeat built launch plans {replies}")
        sr_srv = list(server.planner._searches.values())[-1]
        want = rung_launches(sr_srv.rungs,
                             [members, sr_srv.members], PLANNER_CHUNK,
                             False)
        if srv_launches != want:
            fail(f"planner server launches {srv_launches}, expected {want}")
        ops.reset_launches()
        t1 = time.perf_counter()
        again = query_server(dict(q_srv, faults={"phase1": 1}),
                             port=server.port)
        warm_wall = time.perf_counter() - t1
        if again["cold"] or again["engine_compiles"] or any(
                ops.LAUNCHES.values()):
            fail(f"planner server repeat: {again}, launches {ops.LAUNCHES}")
        prof = device_profile(lambda: query_server(
            dict(q_srv, faults={"classic": 2}, seed=1), port=server.port),
            top=4)
    finally:
        server.shutdown()
    for k, v in srv_launches.items():
        launches[k] += v
    plain_s = planner_plain("server", dev, dict(q_srv, faults={"classic": 1}),
                            sr_srv)
    rows["server"] = dict(
        launches=srv_launches, wall_s=wall, repeat_wall_s=warm_wall,
        cold=[r["cold"] for r in replies],
        engine_compiles=[r["engine_compiles"] for r in replies],
        search_misses=stats["search_misses"],
        rungs=[r.to_dict() for r in sr_srv.rungs],
        traced_cold_wall_s=prof["wall_s"],
        traced_cold_device_busy_s=prof["device_busy_s"],
        traced_cold_idle_share=1.0 - prof["device_busy_s"] / prof["wall_s"],
        recommended=[r["recommended"] for r in replies],
        plain_wall_s=plain_s)
    return {"rows": rows, "launches": launches}


def serve_profile(res: dict) -> None:
    """Trace a prefill and a serving run of SERVE_PROFILE_TOKENS decode
    steps of ``serve_phase``'s model with torch.profiler (the card's busy
    and idle share against the untraced runs' median prefill and steps,
    device time by kernel) and emit the serving phase.  Runs after every
    per-kernel timing: on the card, short traces taken after these long
    ones lost kernel events."""
    from repro_torch.launch import serve
    model, batch, ph = res["model"], res["batch"], dict(res["phase"])
    n_tokens = ph["decode_tokens"]
    prefill_ms, decode_s = ph["prefill_ms"], ph.pop("decode_s")
    t0 = time.perf_counter()
    prof_pre = device_profile(lambda: serve.generate(model, batch, 0), top=8)
    prof_all = device_profile(
        lambda: serve.generate(model, batch, SERVE_PROFILE_TOKENS), top=8)
    ph["walls"] = dict(ph["walls"], profile_s=time.perf_counter() - t0)
    def by_kernel(prof):
        return {k: sum(v for name, v in prof["by_kernel_s"].items()
                       if any(sym in name for sym in syms)) * 1e3
                for k, syms in KERNEL_SYMBOLS.items()}
    med_pre = statistics.median(prefill_ms)
    med_all = (statistics.median(prefill_ms) * 1e-3 + SERVE_PROFILE_TOKENS
               * statistics.median(decode_s) / n_tokens)
    emit(f"serve_{ph['arch']}", ok=True, **ph,
         decode_tok_per_s=[SERVE_BATCH * n_tokens / d for d in decode_s],
         decode_ms_per_step=[d * 1e3 / n_tokens for d in decode_s],
         prefill_busy_ms=prof_pre["device_busy_s"] * 1e3,
         prefill_idle_share=1.0 - prof_pre["device_busy_s"] * 1e3 / med_pre,
         prefill_kernel_device_ms=by_kernel(prof_pre),
         prefill_top_ms=prof_pre["top"],
         serve_traced_steps=SERVE_PROFILE_TOKENS,
         serve_busy_ms=prof_all["device_busy_s"] * 1e3,
         serve_kernel_device_ms=by_kernel(prof_all),
         serve_idle_share=1.0 - prof_all["device_busy_s"] / med_all,
         serve_top_ms=prof_all["top"])



# ---------------------------------------------------------------------------
# Training on the card: the models' plain code under autograd (no kernel
# has a backward), checkpoints committed through the control plane, and the
# trained checkpoints served through the kernels.
# ---------------------------------------------------------------------------

# (a) mamba2_130m at full width: AdamW with the JAX launcher's schedule,
# batch 4 x seq 1024, checkpoints every 5 steps, preempted at step 13 and
# resumed from step 10, on to step 20; the loss down by JAX's
# test_loss_decreases margin.  (b) zamba2_2_7b at full width, 5 steps
# through the launcher.  (c) reduced olmo_1b with int8 and top-k
# compression and with Adafactor, JAX's _mk_trainer sizes, 10 steps each,
# the loss down by JAX's compressed-training margin.
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_PREEMPT_AT = 20, 10, 13
TRAIN_CKPT_EVERY, TRAIN_LOSS_MARGIN = 5, 0.5
ZAMBA_TRAIN_STEPS = 5
SMALL_STEPS, SMALL_MARGIN = 10, 0.4
CKPT_ROOT = os.path.join(ROOT, "build", "chip_smoke_ckpt")


def kernel_counters() -> list:
    """The launch counters of all four kernel libraries."""
    from repro_torch.kernels import _build
    return [lib.LAUNCHES for lib in _build.libraries()]


def reset_all_launches() -> None:
    for counter in kernel_counters():
        for k in counter:
            counter[k] = 0


def launched() -> dict:
    """Every counter that is not 0."""
    return {k: v for c in kernel_counters() for k, v in c.items() if v}


def launcher_optimizer():
    """JAX's launch/train.py optimizer: AdamW, lr 1e-3, cosine schedule
    (warm-up 10, total 1000)."""
    from repro_torch.training.optimizer import adamw, cosine_schedule
    return adamw(lr=1e-3, schedule=cosine_schedule(warmup=10, total=1000))


def train_state(tr) -> dict:
    """A copy of a trainer's params and optimizer state, on the card."""
    return {"params": {k: v.detach().clone() for k, v in tr.params.items()},
            "opt": {k: ({n: t.clone() for n, t in v.items()}
                        if isinstance(v, dict) else v.clone())
                    for k, v in tr.opt_state.items()}}


def state_equal(tr, state) -> bool:
    """Every param and optimizer leaf of ``tr`` the same bits as
    ``state``'s."""
    now = train_state(tr)
    return all(torch.equal(now["params"][k], v)
               for k, v in state["params"].items()) and all(
        torch.equal(now["opt"][k], v) if not isinstance(v, dict)
        else all(torch.equal(now["opt"][k][n], t) for n, t in v.items())
        for k, v in state["opt"].items())


def load_state(tr, state) -> None:
    with torch.no_grad():
        for k, v in state["params"].items():
            tr.params[k].copy_(v)
        for k, v in state["opt"].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    tr.opt_state[k][n].copy_(t)
            else:
                tr.opt_state[k].copy_(v)


def trained_logits(model, batch) -> dict:
    """The last-position prefill logits of ``batch`` through the kernels,
    with f32 compute and as served (bf16), as f32."""
    from repro_torch.training.trainer import make_prefill
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        with variant(model, True, dtype):
            _, lg = make_prefill(model)(model.init_cache(
                SERVE_BATCH, SERVE_PROMPT), batch)
        out[str(dtype)] = lg[:, -1].float()
    return out


def profile_step(tr) -> dict:
    """One more train step traced: the card's busy time and the busiest
    kernels."""
    prof = device_profile(lambda: tr.run(1), top=6)
    return {"busy_ms": prof["device_busy_s"] * 1e3,
            "traced_wall_ms": prof["wall_s"] * 1e3,
            "device_launches": sum(prof["by_kernel_n"].values()),
            "top_ms": prof["top"]}


def serve_trained(arch, cfg, dev, ckpt_dir, plane, reference, batch,
                  want_step) -> dict:
    """(e) Restore ``arch``'s last checkpoint into a fresh DecoderLM(cfg)
    (kernels on, its memory left unset until the restore fills it; the
    optimizer state checked against the digest, not loaded), check its
    step and (d) that a forward under grad raises, prefill SERVE_BATCH x
    SERVE_PROMPT through make_prefill with the serve phases' launch
    counts, its logits the trained model's bit for bit, and hold the
    kernels to the plain path as serve_phase does."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.trainer import make_prefill
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device="meta").to_empty(device=dev)
    params = dict(model.named_parameters())
    # the optimizer state's template on the meta device: checked, not loaded
    opt_state = launcher_optimizer().init(
        {k: torch.empty_like(p, device="meta") for k, p in params.items()})
    _, step, cursor = ckpt.restore({"params": params, "opt": opt_state},
                                   ckpt.latest_manifest(ckpt_dir, plane))
    if (step, cursor) != (want_step, want_step):
        fail(f"{arch}: restored step {step} cursor {cursor}, expected "
             f"{want_step}")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    # (d) a model built with kernels raises under grad
    try:
        model({"tokens": batch["tokens"][:, :16]})
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        refused = str(e)
    else:
        fail(f"{arch}: a forward under grad with kernels did not raise")
    n_mamba, n_flash, per_pass = path_launches(cfg)
    reset_model_launches()
    _, lg = make_prefill(model)(model.init_cache(SERVE_BATCH, SERVE_PROMPT),
                                batch)
    torch.cuda.synchronize()
    launches = model_launches()
    want = {"ssd": n_mamba, "flash_attention": n_flash, "rmsnorm": per_pass}
    if launches != want:
        fail(f"{arch}: the trained checkpoint's prefill launched "
             f"{launches}, expected {want}")
    if not bool(torch.isfinite(lg.float()).all()):
        fail(f"{arch}: the trained checkpoint's logits are not finite")
    got = trained_logits(model, batch)
    for k, v in reference.items():
        if not torch.equal(got[k], v):
            fail(f"{arch}: the restored model's {k} logits differ from the "
                 f"trained model's by {float((got[k] - v).abs().max())}")
    checks = prefill_checks(arch, model, batch, make_prefill(model),
                            n_mamba, n_flash, per_pass)
    return {"restore_s": restore_s, "kernels_under_grad": refused,
            "launches_per_prefill": launches, "logits_equal_trained": True,
            "checks": checks}


def train_phase(dev, smi: str) -> dict:
    """Train on the card (see TRAIN_*): (a) mamba2_130m, (b) zamba2_2_7b,
    (c) reduced olmo_1b compressed and with Adafactor; (d) no kernel
    launched by any train step, and a model with kernels raising under
    grad; (e) both trained checkpoints served through the kernels."""
    from repro_torch.cluster.coordinator import ControlPlane
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.launch import serve, train as launch_train
    from repro_torch.models.model import DecoderLM
    from repro_torch.training.data import DataConfig, SyntheticPipeline
    from repro_torch.training.optimizer import adafactor, adamw
    from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                              make_train_step)

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    out = {"card": smi}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # ---- (a) mamba2_130m ---------------------------------------------------
    arch = "mamba2_130m"
    cfg = get_config(arch)
    ckpt_dir = os.path.join(CKPT_ROOT, arch)
    plane = ControlPlane(QuorumSpec.paper_headline(11))
    pipe = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))

    def trainer(seed):
        model = DecoderLM(cfg, device=dev, seed=seed, use_kernels=False)
        tr = Trainer(model, launcher_optimizer(), pipe,
                     TrainerConfig(ckpt_dir=ckpt_dir,
                                   ckpt_every=TRAIN_CKPT_EVERY),
                     plane=plane)
        tr.init()
        return tr

    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t1 = trainer(0)
    t1.run(TRAIN_RESUME_AT)
    at_resume = train_state(t1)
    t1.run(TRAIN_PREEMPT_AT - TRAIN_RESUME_AT)        # lost to preemption
    t2 = trainer(1)
    if not t2.try_restore() or (t2.step, t2.cursor) != (TRAIN_RESUME_AT,
                                                        TRAIN_RESUME_AT):
        fail(f"{arch}: resumed at step {t2.step} cursor {t2.cursor}, "
             f"expected {TRAIN_RESUME_AT}")
    if not state_equal(t2, at_resume):
        fail(f"{arch}: the resumed params and moments differ from step "
             f"{TRAIN_RESUME_AT}'s")
    del at_resume
    t2.run(TRAIN_STEPS - TRAIN_RESUME_AT)
    # steps 1-10 of the preempted run, 11-20 of the resumed one
    hist = t1.history[:TRAIN_RESUME_AT] + t2.history
    del t1
    if hist[-1]["loss"] > hist[0]["loss"] - TRAIN_LOSS_MARGIN:
        fail(f"{arch}: loss {hist[0]['loss']} at step 1, "
             f"{hist[-1]['loss']} at step {TRAIN_STEPS}")
    # one step with 2 microbatches against 1, from step 20's state
    at_end = train_state(t2)
    batch = {k: v.to(dev) for k, v in pipe.batch_at(t2.cursor).items()}
    micro = {}
    for nm in (1, 2):
        b = batch if nm == 1 else {
            k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])
            for k, v in batch.items()}
        _, m = make_train_step(t2.model, t2.opt, n_microbatches=nm)(
            t2.opt_state, None, b)
        micro[nm] = (float(m["loss"]), {k: v.detach().clone()
                                        for k, v in t2.params.items()})
        load_state(t2, at_end)
    param_diff = max(float((micro[1][1][k] - micro[2][1][k]).abs().max())
                     for k in micro[1][1])
    loss_rel = abs(micro[1][0] - micro[2][0]) / abs(micro[1][0])
    del micro
    if loss_rel > 1e-2 or param_diff >= 2e-2:
        fail(f"{arch}: 2 microbatches against 1: loss off by {loss_rel} "
             f"relative, params by {param_diff}")
    prof_a = profile_step(t2)
    load_state(t2, at_end)
    memory_a = torch.cuda.max_memory_allocated() / 1e9
    if launched():
        fail(f"{arch}: train steps launched kernels: {launched()}")
    step_s = [h["step_s"] for h in hist]
    out[arch] = dict(
        params=sum(p.numel() for p in t2.model.parameters()),
        steps=TRAIN_STEPS, loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        step_ms=[x * 1e3 for x in step_s],
        median_step_ms=statistics.median(step_s[1:]) * 1e3,
        tokens_per_s=tokens / statistics.median(step_s[1:]),
        resumed_at=TRAIN_RESUME_AT, preempted_at=TRAIN_PREEMPT_AT,
        resume_bit_identical=True, microbatch_loss_rel=loss_rel,
        microbatch_param_diff=param_diff,
        committed_steps=[r["step"] for r in plane.history()
                         if r["kind"] == "checkpoint"],
        max_memory_gb=memory_a, profile=prof_a)
    out[arch]["idle_share"] = 1.0 - prof_a["busy_ms"] \
        / out[arch]["median_step_ms"]

    t2.model.use_kernels = True
    prompt = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT, dev)
    trained = [(arch, cfg, ckpt_dir, plane, trained_logits(t2.model, prompt),
                prompt, TRAIN_STEPS)]
    del t2, at_end, batch
    torch.cuda.empty_cache()

    # ---- (b) zamba2_2_7b through the launcher -------------------------------
    arch = "zamba2_2_7b"
    ckpt_dir = os.path.join(CKPT_ROOT, arch)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    tr = launch_train.main(["--arch", arch, "--steps",
                            str(ZAMBA_TRAIN_STEPS), "--seq", str(TRAIN_SEQ),
                            "--batch", str(TRAIN_BATCH), "--ckpt-dir",
                            ckpt_dir])
    torch.cuda.synchronize()
    memory_b = torch.cuda.max_memory_allocated() / 1e9
    if launched():
        fail(f"{arch}: train steps launched kernels: {launched()}")
    hist = list(tr.history)
    if hist[-1]["loss"] >= hist[0]["loss"]:
        fail(f"{arch}: loss {hist[0]['loss']} at step 1, "
             f"{hist[-1]['loss']} at step {ZAMBA_TRAIN_STEPS}")
    cfg = tr.model.cfg
    step_s = [h["step_s"] for h in hist]
    tr.model.use_kernels = True
    prompt = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT, dev)
    trained.append((arch, cfg, ckpt_dir, tr.plane,
                    trained_logits(tr.model, prompt), prompt,
                    ZAMBA_TRAIN_STEPS))
    tr.model.use_kernels = False
    reset_all_launches()
    prof_b = profile_step(tr)
    if launched():
        fail(f"{arch}: the traced train step launched kernels: "
             f"{launched()}")
    out[arch] = dict(
        params=sum(p.numel() for p in tr.model.parameters()),
        steps=ZAMBA_TRAIN_STEPS, loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        step_ms=[x * 1e3 for x in step_s],
        median_step_ms=statistics.median(step_s[1:]) * 1e3,
        tokens_per_s=tokens / statistics.median(step_s[1:]),
        max_memory_gb=memory_b, profile=prof_b)
    out[arch]["idle_share"] = 1.0 - prof_b["busy_ms"] \
        / out[arch]["median_step_ms"]
    del tr
    torch.cuda.empty_cache()

    # ---- (c) reduced olmo_1b: int8, top-k, Adafactor -----------------------
    small = reduced_config(get_config("olmo_1b"))
    reset_all_launches()
    out["olmo_1b_reduced"] = {}
    for name, opt, compression in (("int8", adamw(lr=3e-3), "int8"),
                                   ("topk", adamw(lr=3e-3), "topk"),
                                   ("adafactor", adafactor(), None)):
        tr = Trainer(DecoderLM(small, device=dev, seed=0, use_kernels=False),
                     opt, SyntheticPipeline(DataConfig(
                         vocab=small.vocab, seq_len=32, global_batch=8)),
                     TrainerConfig(ckpt_dir=os.path.join(CKPT_ROOT, name),
                                   ckpt_every=0, compression=compression))
        tr.init()
        tr.run(SMALL_STEPS)
        first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
        out["olmo_1b_reduced"][name] = {"loss_first": first,
                                        "loss_last": last}
        if last >= first - SMALL_MARGIN:
            fail(f"reduced olmo_1b {name}: loss {first} at step 1, {last} "
                 f"at step {SMALL_STEPS}")
    if launched():
        fail(f"reduced olmo_1b train steps launched kernels: {launched()}")
    out["train_step_launches"] = 0

    # ---- (e) serve the trained checkpoints through the kernels -------------
    launches = dict.fromkeys(("ssd", "flash_attention", "rmsnorm"), 0)
    for arch, cfg, ckpt_dir, plane, reference, prompt, step in trained:
        res = serve_trained(arch, cfg, dev, ckpt_dir, plane, reference,
                            prompt, step)
        out[arch]["served"] = res
        for k, v in res["launches_per_prefill"].items():
            launches[k] += v
        torch.cuda.empty_cache()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # The plain versions' f32 products must run in f32, not TF32, or the
    # comparisons would test TF32 rather than the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.frontier import score_systems
    from repro_torch.frontier.__main__ import (_legacy_fast_p50,
                                               _legacy_recovery_prob,
                                               run_sweep)
    from repro_torch.kernels.quorum_tally import kernel, ops, ref
    from repro_torch.montecarlo import engine, rng, streaming

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    compute_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, compute_mode=compute_mode, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = {lib.name: lib for lib in _build.libraries()}
    with ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source, at once
        futs = {k: ex.submit(m.build) for k, m in libs.items()}
        built = {k: f.result() for k, f in futs.items()}
    emit("build", seconds=time.perf_counter() - t0,
         **{k: {"library": os.path.relpath(path, ROOT),
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "entry function" in ln or "registers" in ln
                          or "spill" in ln]}
            for k, (path, log) in built.items()})
    sass = {k: tensor_core_instructions(path)
            for k, (path, _) in built.items()}
    missing = [sym for sym in TENSOR_CORE_SYMBOLS
               if not any(sym in fn and n > 0 for lib in sass.values()
                          for fn, n in lib.items())]
    emit("sass", ok=not missing, hmma_or_hgmma_by_function=sass)
    if missing:
        fail(f"no HMMA/HGMMA in the SASS of {missing}")

    # ---- 3. kernels vs plain versions on the card -------------------------
    stats = {k: {"max_abs_err": 0.0} for k in QUORUM_KERNELS}

    def same(a, b, what):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"{what}: {bad} entries differ from the plain version")

    def check_stream(args, kw, what):
        h_k, s_k = kernel.stream_tally_decide_hist(*args, **kw)
        h_r, s_r = ref.stream_tally_decide_hist(*args, **kw)
        same(h_k, h_r, what + " hist")
        for f in ("n_fast", "n_recovery", "n_undecided"):
            same(s_k[f], s_r[f].to(s_k[f].dtype), f"{what} {f}")
        same(s_k["max_ms"], s_r["max_ms"], what + " max_ms")
        num = (s_k["sum_ms"] - s_r["sum_ms"]).abs()
        if bool((num > 1e-5 * s_r["sum_ms"].abs()).any()):
            fail(f"{what} sum_ms off by more than 1e-5 relative")
        err = float(num.max()) if num.numel() else 0.0
        st = stats["stream_tally_decide_hist"]
        st["max_abs_err"] = max(st["max_abs_err"], err)

    n11_gen = rng.generator(rng.root(11), dev)
    offsets = torch.tensor([0.0, 0.2], device=dev)
    raw11 = engine._draw_race(n11_gen, offsets, streaming.default_delay(),
                              n=11, k_proposers=2, samples=16_384)
    v11 = raw11["votes"]
    got = kernel.tally_decide(v11, 2, 7)
    want = ref.tally_decide(v11, 2, 7)
    for a, b, f in zip(got, want, ("counts", "winner", "max", "reached")):
        same(a, b, f"tally_decide (16384, 11) {f}")
    # tally_decide's main path: phase 4's cardinality lowering of
    # engine.race, whose chunk is these draws (8192 x 12, K = 2)
    v4 = engine._draw_race(rng.generator(rng.root(4), dev), offsets,
                           streaming.default_delay(), n=12, k_proposers=2,
                           samples=8192)["votes"]
    for a, b, f in zip(kernel.tally_decide(v4, 2, 0),
                       ref.tally_decide(v4, 2, 0),
                       ("counts", "winner", "max", "reached")):
        same(a, b, f"tally_decide (8192, 12) {f}")
    same(kernel.tally_votes(v11, 2), ref.tally_votes(v11, 2),
         "tally_votes (16384, 11)")
    for S, n, V in ((100, 11, 2), (1024, 11, 3), (3000, 7, 2), (5000, 32, 5),
                    (700, 200, 12)):
        r = np.random.default_rng(S + n)
        v = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32)).to(dev)
        same(kernel.tally_votes(v, V), ref.tally_votes(v, V),
             f"tally_votes {(S, n, V)}")
    for S, n, V in TALLY_VOTES_CASES:
        r = np.random.default_rng(S * 3 + n + V)
        v = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32)).to(dev)
        same(kernel.tally_votes(v, V), ref.tally_votes(v, V),
             f"tally_votes {(S, n, V)}")
    # the large shape: 2^20 trials of the n=11 race's draws
    v11_large = engine._draw_race(
        rng.generator(rng.root(14), dev), offsets, streaming.default_delay(),
        n=11, k_proposers=2, samples=TALLY_VOTES_LARGE_S)["votes"]
    same(kernel.tally_votes(v11_large, 2), ref.tally_votes(v11_large, 2),
         f"tally_votes {tuple(v11_large.shape)}")
    for S, n, q, V in ((100, 11, 7, 2), (2049, 11, 9, 3), (500, 7, 4, 4)):
        g = torch.Generator(device=dev).manual_seed(S + V)
        v = torch.randint(-1, V, (S, n), generator=g, device=dev,
                          dtype=torch.int32)
        for a, b in zip(kernel.tally_decide(v, V, q),
                        ref.tally_decide(v, V, q)):
            same(a, b, f"tally_decide {(S, n, q, V)}")

    from repro_torch.montecarlo.engine import build_mask_table
    table12 = build_mask_table([m.masks(12) for m in mixed_members()],
                               device=dev)
    M12, G2f, _ = table12["p2f_w"].shape
    raw12 = engine._draw_race(rng.generator(rng.root(12), dev), offsets,
                              streaming.default_delay(), n=12,
                              k_proposers=2, samples=8192)
    w_flat = table12["p2f_w"].reshape(M12 * G2f, 12).contiguous()
    t_flat = table12["p2f_t"].reshape(M12 * G2f).contiguous()
    same(kernel.masked_tally(raw12["votes"], w_flat, t_flat, 2),
         ref.masked_tally(raw12["votes"], w_flat, t_flat, 2),
         "masked_tally n=12 fast rows")
    for S, n, V, G in ((257, 9, 2, 1), (1100, 11, 3, 4), (100, 6, 4, 12),
                       (300, 11, 2, 70)):
        r = np.random.default_rng(S * 7 + G)
        v = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32)).to(dev)
        w = torch.as_tensor(r.integers(0, 4, (G, n)).astype(np.float32)
                            ).to(dev)
        t = torch.as_tensor(r.integers(1, n + 2, (G,)).astype(np.float32)
                            ).to(dev)
        same(kernel.masked_tally(v, w, t, V), ref.masked_tally(v, w, t, V),
             f"masked_tally {(S, n, V, G)}")
    # any K and any n; masked_tally's weights in quarters (sums exact in f32
    # in any order), 40 rows
    for S, n, V in ANY_KN_CASES:
        r = np.random.default_rng(S + n + V)
        v = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32)).to(dev)
        for a, b in zip(kernel.tally_decide(v, V, n // 3),
                        ref.tally_decide(v, V, n // 3)):
            same(a, b, f"tally_decide {(S, n, V)}")
        w = torch.as_tensor((r.integers(0, 9, (40, n)) / 4.0).astype(
            np.float32)).to(dev)
        t = torch.as_tensor((r.integers(1, 4 * n // V + 8, (40,)) / 4.0
                             ).astype(np.float32)).to(dev)
        same(kernel.masked_tally(v, w, t, V), ref.masked_tally(v, w, t, V),
             f"masked_tally {(S, n, V, 40)}")

    for case in MASKED_CASES:
        v, w, t, V = masked_inputs(case, dev)
        same(kernel.masked_tally(v, w, t, V), ref.masked_tally(v, w, t, V),
             f"masked_tally {case[0]} {tuple(v.shape)} G={w.shape[0]} K={V}")
    # the large shape: the mixed table's fast rows at 65,536 trials
    v12_large = engine._draw_race(
        rng.generator(rng.root(15), dev), offsets, streaming.default_delay(),
        n=12, k_proposers=2, samples=MASKED_LARGE_S)["votes"]
    same(kernel.masked_tally(v12_large, w_flat, t_flat, 2),
         ref.masked_tally(v12_large, w_flat, t_flat, 2),
         f"masked_tally {tuple(v12_large.shape)} x {M12 * G2f} rows")
    torch.cuda.empty_cache()

    k_sat12 = engine.saturation_depths(table12)
    bins = streaming.sketch_bins(0.01)
    valid12 = torch.arange(8192, device=dev) < 8192 - 300
    und = float(engine.UNDECIDED_MS)
    kw12 = dict(n_values=2, precision=0.01, bins=bins, undecided_ms=und)
    args12 = {}
    for rec in ("coordinated", "uncoordinated"):
        raw = engine._draw_race(rng.generator(rng.root(13), dev), offsets,
                                streaming.default_delay(), n=12,
                                k_proposers=2, samples=8192, recovery=rec)
        ph = "p2c" if rec == "coordinated" else "p2f"
        ks = k_sat12 if rec == "coordinated" else (k_sat12[0], k_sat12[2],
                                                   k_sat12[2])
        args12[rec] = ([raw["votes"], engine._val_arr(raw, 2), raw["arrive"],
                        raw["classic"], table12["p1_w"], table12["p1_t"],
                        table12[ph + "_w"], table12[ph + "_t"],
                        table12["p2f_w"], table12["p2f_t"], valid12],
                       dict(kw12, k_sat=ks))
        check_stream(*args12[rec], f"stream n=12 {rec}")
    # the kernel tests' shapes, then the edges of the design: more rows than
    # a warp's 32, K = 8, n past the register-resident orders (16, 32) up to
    # 128, more systems than a block's 16, quarter weights, k_sat below n,
    # +inf lanes, padding rows.
    for S, n, M, G, K, ks, opts in (
            (300, 11, 2, 3, 2, (4, 5, 6), {}),
            (1025, 9, 1, 6, 3, (9, 9, 9), {}),
            (513, 7, 3, 1, 2, (2, 3, 2), {}),
            (700, 11, 4, 2, 2, (11, 1, 7), {}),
            (1000, 12, 5, 39, 2, (12, 12, 12), dict(pad=True)),
            (600, 9, 3, 4, 8, (9, 9, 9), {}),
            (500, 17, 3, 5, 3, (17, 9, 12), {}),
            (400, 33, 2, 4, 2, (33, 20, 25), {}),
            (300, 128, 2, 3, 2, (128, 64, 100), {}),
            (200, 128, 1, 2, 8, (128, 128, 128), {}),
            (2000, 11, 300, 3, 2, (11, 6, 8), dict(pad=True)),
            (1500, 12, 13, 12, 2, (12, 12, 12), dict(quarters=True,
                                                     pad=True)),
            (1025, 12, 4, 6, 2, (5, 3, 4), {}),
            (1000, 12, 4, 5, 2, (12, 12, 12), dict(inf=True, pad=True)),
            # any K and any n: more than 8 values, orders wider than a byte
            # (n > 256), and more quorum rows than a block's shared memory
            # held at n = 128, K = 8 (about 2360); from n = 257 on, and for
            # the last two, the tile and the lists are staged in device
            # memory.
            (300, 11, 3, 4, 9, (11, 9, 10), {}),
            (300, 12, 2, 5, 12, (12, 12, 12), dict(pad=True)),
            (200, 11, 2, 3, 33, (11, 11, 11), {}),
            (300, 129, 2, 4, 2, (129, 70, 100), {}),
            (300, 130, 3, 3, 2, (130, 130, 130), dict(quarters=True)),
            (200, 257, 2, 3, 2, (257, 200, 257), {}),
            (150, 300, 2, 3, 3, (300, 300, 300), dict(pad=True)),
            (96, 128, 1, 900, 8, (128, 128, 128), {}),
            (40, 600, 1, 2, 70, (600, 300, 600), {})):
        a = stream_test_inputs(S * 13 + M, S, n, M, G, K, dev, **opts)
        check_stream(a, dict(n_values=K, k_sat=ks, precision=0.01,
                             bins=bins, undecided_ms=5e8),
                     f"stream {(S, n, M, G, K, ks, sorted(opts))}")
    # two calls back to back: the same bits, sum_ms included.
    for rec in ("coordinated", "uncoordinated"):
        h_a, s_a = kernel.stream_tally_decide_hist(*args12[rec][0],
                                                   **args12[rec][1])
        h_b, s_b = kernel.stream_tally_decide_hist(*args12[rec][0],
                                                   **args12[rec][1])
        same(h_a, h_b, f"stream n=12 {rec} repeated hist")
        for f in s_a:
            same(s_a[f].view(torch.int32), s_b[f].view(torch.int32),
                 f"stream n=12 {rec} repeated {f}")
    a = stream_test_inputs(3, 128, 5, 1, 2, 2, dev)
    a[-1] = torch.zeros((128,), dtype=torch.bool, device=dev)
    h, s = kernel.stream_tally_decide_hist(
        *a, n_values=2, k_sat=(3, 3, 3), precision=0.01, bins=bins,
        undecided_ms=5e8)
    if int(h.sum()) or int(s["n_fast"].sum()) \
            or not bool(torch.isneginf(s["max_ms"]).all()):
        fail("stream kernel: an all-invalid block contributed")
    # race_card_hist at every shape of RACE_CARD_CASES: integers and maxima
    # equal, sums within 1e-5 of each cell and the same bits over two calls
    card_args = {}
    for case in RACE_CARD_CASES:
        a, kw = card_args[case[0]] = race_card_inputs(case, dev)
        got = kernel.race_card_hist(*a, **kw)
        again = kernel.race_card_hist(*a, **kw)
        for f, x, y, z in zip(("FH", "Fsum", "Fmax", "cnt", "RH", "Rsum",
                               "Rmax"), got, ref.race_card_hist(*a, **kw),
                              again):
            what = f"race_card_hist {case[0]} {f}"
            if f in ("Fsum", "Rsum"):
                num = (x - y).abs()
                if bool((num > 1e-5 * y.abs()).any()):
                    fail(f"{what} off by more than 1e-5 relative")
                st = stats["race_card_hist"]
                st["max_abs_err"] = max(st["max_abs_err"], float(num.max()))
            else:
                same(x, y, what)
            same(x.view(torch.int32), z.view(torch.int32), what + " repeated")
        if int(got[3].sum()) != case[-1]:
            fail(f"race_card_hist {case[0]}: {int(got[3].sum())} trials "
                 f"counted, {case[-1]} valid")
    # masked_sat at every shape of MASKED_SAT_CASES: the plain version's
    # bits (one f32 add a position where the weights are not exact in f32),
    # the same bits over two calls
    big = float(engine.BIG)
    sat_args = {}
    for case in MASKED_SAT_CASES:
        a = sat_args[case[0]] = masked_sat_inputs(case, dev)
        sat = kernel.masked_sat(*a, big=big)
        same(sat, sequential_sat(*a, big) if case[6] == "normal"
             else ref.masked_sat(*a, big=big), f"masked_sat {case[0]}")
        same(sat.view(torch.int32),
             kernel.masked_sat(*a, big=big).view(torch.int32),
             f"masked_sat {case[0]} repeated")
    del sat
    # sorted_prefix at the two main paths' shapes, the fast paths' draws:
    # ffp_n11's 2,097,152 x 11 chunk (values, k = n) and mixed_n12's
    # 65,536 x 12 chunk (values and ids, k its fast saturation depth)
    sp_args = {
        "ffp_n11": (engine._fast_path_draws(
            rng.generator(rng.root(16), dev), streaming.default_delay(), 11,
            SORTED_PREFIX_S), 11, False),
        "mixed_n12": (engine._fast_path_draws(
            rng.generator(rng.root(17), dev), streaming.default_delay(), 12,
            MASKED_LARGE_S), k_sat12[2], True)}
    for case, (x_sp, k_sp, ord_sp) in sp_args.items():
        sp_got = kernel.sorted_prefix(x_sp, k_sp, order=ord_sp)
        sp_want = ref.sorted_prefix(x_sp, k_sp, order=ord_sp)
        same(sp_got[0].view(torch.int32), sp_want[0].view(torch.int32),
             f"sorted_prefix {case} values")
        if ord_sp:
            same(sp_got[1], sp_want[1], f"sorted_prefix {case} ids")
    del sp_got, sp_want
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    args_c, kw_c = args12["coordinated"]
    timed = {
        "tally_votes": (lambda: kernel.tally_votes(v11, 2),
                        lambda: ref.tally_votes(v11, 2)),
        "tally_decide": (lambda: kernel.tally_decide(v4, 2, 0),
                         lambda: ref.tally_decide(v4, 2, 0)),
        "masked_tally": (
            lambda: kernel.masked_tally(raw12["votes"], w_flat, t_flat, 2),
            lambda: ref.masked_tally(raw12["votes"], w_flat, t_flat, 2)),
        "stream_tally_decide_hist": (
            lambda: kernel.stream_tally_decide_hist(*args_c, **kw_c),
            lambda: ref.stream_tally_decide_hist(*args_c, **kw_c)),
        "race_card_hist": (
            lambda: kernel.race_card_hist(*card_args["sweep"][0],
                                          **card_args["sweep"][1]),
            lambda: ref.race_card_hist(*card_args["sweep"][0],
                                       **card_args["sweep"][1])),
        "masked_sat": (
            lambda: kernel.masked_sat(*sat_args["mixed_n12"], big=big),
            lambda: ref.masked_sat(*sat_args["mixed_n12"], big=big)),
        "sorted_prefix": (
            lambda: kernel.sorted_prefix(sp_args["ffp_n11"][0], 11,
                                         order=False),
            lambda: ref.sorted_prefix(sp_args["ffp_n11"][0], 11,
                                      order=False)),
    }
    S11, S12, S4 = v11.shape[0], raw12["votes"].shape[0], v4.shape[0]
    p11 = card_args["sweep"][0][4].shape[0]
    k2f11 = card_args["sweep"][1]["k_sat"][2]
    slots11 = k2f11 + 1
    G1, G2c = table12["p1_w"].shape[1], table12["p2c_w"].shape[1]
    mask_bytes = 4 * M12 * 12 * (G1 + G2c + G2f) + 4 * M12 * (G1 + G2c + G2f)
    # masked_sat at the benchmark's fast chunk: the order (f32 arrivals and
    # int64 ids) read once, each system's live fast rows (n + 1 words a
    # row), the (M, S) answer written; a row's add and compare a position,
    # a minimum a system
    xs_, _, ws_, ts_ = sat_args["mixed_n12"]
    S_sat, L_sat = xs_.shape
    live_sat = int((~((ws_ == 0).all(-1) & (ts_ > 0))).sum())
    # sorted_prefix: each row read once and its k-prefix written once (k = n
    # here); its operations, the network's 38 compare-exchanges a row
    bytes_ = {
        "sorted_prefix": SORTED_PREFIX_S * 11 * 4 * 2,
        "masked_sat": (S_sat * L_sat * (4 + 8) + live_sat * 13 * 4
                       + M12 * S_sat * 4),
        "tally_votes": S11 * 11 * 4 + S11 * 2 * 4,
        "tally_decide": S4 * 12 * 4 + S4 * 2 * 4 + S4 * 4 * 2 + S4,
        "masked_tally": (S12 * 12 * 4 + M12 * G2f * 13 * 4
                         + S12 * M12 * G2f * 4),
        "stream_tally_decide_hist": (S12 * 12 * 4 * (1 + 2 + 2) + S12
                                     + mask_bytes + M12 * (bins + 5) * 4),
        # votes, arrive, classic and valid read once, the pairs; FH, RH,
        # the slot counts and the four (k2f or P) x V f32 outputs written
        "race_card_hist": (S11 * (11 * 12 + 1) + 8 * p11
                           + 4 * (k2f11 * slots11 * bins
                                  + p11 * slots11 * (bins + 1) + slots11
                                  + 2 * (k2f11 + p11) * slots11)),
    }
    # operations: one compare or add per (trial, acceptor, value) of the
    # tallies.  The fused kernel: per (system, trial) the masked tally
    # against the fast rows (G2f*n*K adds) and each phase's weight
    # contraction (G1*k1 + G2c*k2c + G2f*k2f adds); per trial one ordering
    # of its K + 2 rows (n*ceil(log2 n) compares a row, a comparison
    # sort's least).  race_card_hist: per trial the tally (n*K compares),
    # the order of its three rows (3*n*ceil(log2 n)), per pair an add, a
    # compare and a bucket, per fast column a bucket.
    k1, k2c, k2f = kw_c["k_sat"]
    ops_ = {
        "sorted_prefix": SORTED_PREFIX_S * 38,
        "masked_sat": S_sat * (live_sat * L_sat * 2 + M12),
        "tally_votes": S11 * 11 * 2,
        "tally_decide": S4 * 12 * 2,
        "masked_tally": S12 * M12 * G2f * 12 * 2,
        "stream_tally_decide_hist": (
            M12 * S12 * (G2f * 12 * 2 + G1 * k1 + G2c * k2c + G2f * k2f)
            + S12 * (2 + 2) * 12 * math.ceil(math.log2(12))),
        "race_card_hist": S11 * (11 * 2 + 3 * 11 * math.ceil(math.log2(11))
                                 + 3 * p11 + k2f11),
    }
    symbol = {"tally_votes": "tally_votes_kernel",
              "tally_decide": "tally_decide_kernel",
              "masked_tally": "masked_tally_kernel",
              "stream_tally_decide_hist": "stream_kernel",
              "race_card_hist": ("race_card_kernel", "Memset"),
              "masked_sat": "masked_sat_kernel",
              "sorted_prefix": "sorted_prefix_kernel"}
    for k, (kf, pf) in timed.items():
        kms, pms = cuda_ms(kf), cuda_ms(pf)
        ops.reset_launches()
        kf()
        per_call = ops.LAUNCHES[k]
        dev_us, dev_n, per_symbol = kernel_device_us(kf, symbol[k], reps=20)
        b_ms = bytes_[k] / HBM_BYTES_PER_S * 1e3
        o_ms = ops_[k] / FP32_OPS_PER_S * 1e3
        stats[k].update(ms=kms, plain_ms=pms, device_us=dev_us,
                        device_us_by_launch=per_symbol,
                        launches_per_call=per_call,
                        back_to_back_us=back_to_back_us(kf),
                        device_launches_recorded=dev_n,
                        bound_ms=max(b_ms, o_ms),
                        bound_by="bytes" if b_ms >= o_ms else "operations",
                        bytes=bytes_[k], operations=ops_[k])
    # both redesigned kernels at a large shape: device time, event time and
    # the bound (votes read once, outputs written once)
    SL, ML = v11_large.shape[0], v12_large.shape[0]
    large = {
        "tally_votes": (lambda: kernel.tally_votes(v11_large, 2),
                        SL * 11 * 4 + SL * 2 * 4, SL * 11 * 2,
                        f"{SL}x11, K=2"),
        "masked_tally": (
            lambda: kernel.masked_tally(v12_large, w_flat, t_flat, 2),
            ML * 12 * 4 + M12 * G2f * 13 * 4 + ML * M12 * G2f * 4,
            ML * M12 * G2f * 12 * 2, f"{ML}x12 x {M12 * G2f} rows"),
    }
    for k, (kf, nbytes, nops, shape) in large.items():
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        stats[k]["large"] = dict(
            shape=shape, ms=cuda_ms(kf),
            device_us=kernel_device_us(kf, symbol[k], reps=20)[0],
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            bytes=nbytes, operations=nops)
    # sorted_prefix's yardstick: torch.sort, which the port no longer calls
    # on rows of 32 or fewer; and the kernel at mixed_n12's chunk, with ids
    x11 = sp_args["ffp_n11"][0]
    stats["sorted_prefix"]["library_ms"] = cuda_ms(
        lambda: torch.sort(x11, dim=-1, stable=True))
    x12, k12, _ = sp_args["mixed_n12"]
    sp12 = lambda: kernel.sorted_prefix(x12, k12, order=True)
    b_ms = x12.shape[0] * (12 * 4 + k12 * (4 + 8)) / HBM_BYTES_PER_S * 1e3
    stats["sorted_prefix"]["mixed_n12"] = dict(
        shape=f"{x12.shape[0]}x12, k={k12}, ids", ms=cuda_ms(sp12),
        device_us=kernel_device_us(sp12, symbol["sorted_prefix"],
                                   reps=20)[0],
        plain_ms=cuda_ms(lambda: ref.sorted_prefix(x12, k12, order=True)),
        bound_ms=b_ms, bound_by="bytes")
    del sp_args, x11, x12
    torch.cuda.empty_cache()
    # the least device time of a launch on this card, for scale: torch's
    # fill of a tensor of the sweep chunk's 16384 ints (64 KB written)
    fill = torch.empty(S11, dtype=torch.int32, device=dev)
    floor_us = kernel_device_us(lambda: fill.fill_(1), "FillFunctor",
                                reps=20)[0]
    emit("kernels", ok=True, launch_floor_us=floor_us,
         **{k: {kk: vv for kk, vv in v.items()} for k, v in stats.items()})

    # ---- 4. masked materializing race (masked_tally) ----------------------
    ops.reset_launches()
    out = engine.race(rng.root(4), table12, [0.0, 0.2], n=12, k_proposers=2,
                      samples=8192)
    torch.cuda.synchronize()
    launches4 = dict(ops.LAUNCHES)
    if launches4 != only(masked_tally=1, masked_sat=3, sorted_prefix=3):
        fail(f"masked race launches {launches4}")
    lat = out["latency_ms"]
    if tuple(lat.shape) != (M12, 8192):
        fail(f"masked race latency shape {tuple(lat.shape)}")
    dec = ~out["undecided"]
    if not bool(torch.isfinite(lat[dec]).all()) or not bool(dec.any()):
        fail("masked race: decided latencies not finite")
    card = build_mask_table([m.masks(12) for m in mixed_members()[:3]],
                            device=dev)
    seen, tally_decide = [], kernel.tally_decide

    def spy(votes, *args):          # the votes the path hands the kernel
        seen.append(votes.clone())
        return tally_decide(votes, *args)

    kernel.tally_decide = spy
    try:
        ops.reset_launches()
        out_q = engine.race(rng.root(4), card, [0.0, 0.2], n=12,
                            k_proposers=2, samples=8192)
        torch.cuda.synchronize()
        launches4c = dict(ops.LAUNCHES)
    finally:
        kernel.tally_decide = tally_decide
    if launches4c != only(tally_decide=1, sorted_prefix=3):
        fail(f"cardinality race launches {launches4c}")
    if len(seen) != 1 or not torch.equal(seen[0], v4):
        fail("the cardinality race's votes are not those phase 3 checked")
    for f in out_q:
        same(out[f][:3], out_q[f], f"masked vs cardinality lowering {f}")
    emit("masked_race", ok=True, launches=launches4,
         cardinality_launches=launches4c,
         fast_rate=out["reached_fast"].float().mean(1).tolist())

    # ---- 5. mixed n=12 batch (stream_tally_decide_hist) --------------------
    members = mixed_members()
    ops.reset_launches()
    fr = score_systems(members, n=12, trials=2_000_000, chunk=8192, seed=0)
    torch.cuda.synchronize()
    launches5 = dict(ops.LAUNCHES)
    # the race through the fused kernel, the fast pass through
    # sorted_prefix and masked_sat (one each a chunk of the same size)
    if launches5 != only(stream_tally_decide_hist=MIXED_RACE_CHUNKS,
                         masked_sat=MIXED_RACE_CHUNKS,
                         sorted_prefix=MIXED_RACE_CHUNKS):
        fail(f"mixed batch launches {launches5}")
    race, fast = fr.streams["race"], fr.streams["fast"]
    for s in (race, fast):
        if not bool((s.n_trials == 2_000_000).all()):
            fail("mixed batch: trial counts")
        if not torch.equal(s.hist.sum(1, dtype=torch.int32), s.n_decided):
            fail("mixed batch: histogram mass != decided count")
    if not np.isfinite(np.asarray(fr.values)[:, :2]).all():
        fail("mixed batch: non-finite latency axes")
    check = rng.root(5)
    for i in range(3):                   # the cardinality landmarks
        spec, row = members[i].system, fr.row(i)
        p50 = _legacy_fast_p50(rng.generator(rng.derive(check, 0, i), dev),
                               12, spec.q2f, 50_000)
        prec = _legacy_recovery_prob(
            rng.generator(rng.derive(check, 0, 100 + i), dev), spec, 0.2,
            50_000)
        if abs(p50 - row["fast_p50_ms"]) >= 0.05 \
                or abs(prec - row["p_recovery"]) >= 4.5 * (0.5 / 5e4) ** .5:
            fail(f"mixed batch {fr.labels[i]}: {row} vs per-spec "
                 f"p50 {p50}, P(recovery) {prec}")
    emit("mixed_batch", ok=True, systems=len(members), trials=2_000_000,
         launches=launches5,
         race_trials_per_sec=2_000_000 / fr.wall_s["race"],
         fast_trials_per_sec=2_000_000 / fr.wall_s["fast"],
         frontier=list(fr.frontier_labels))

    # ---- 6. the n=11 sweep (race_card_hist) --------------------------------
    ops.reset_launches()
    sw = run_sweep(quick=False, device=dev)
    torch.cuda.synchronize()
    launches6 = dict(ops.LAUNCHES)
    # the race through race_card_hist, the fast pass through sorted_prefix
    # (one each a chunk of the same size)
    if launches6 != only(race_card_hist=SWEEP_RACE_CHUNKS,
                         sorted_prefix=SWEEP_RACE_CHUNKS):
        fail(f"sweep launches {launches6}")
    res = sw["result"]
    with open(os.path.join(ROOT, "BENCH_baseline.json")) as fh:
        metrics = json.load(fh).get("metrics", {})
    baseline = sorted({k.split("]")[0][len("sweep.["):] + "]"
                       for k in metrics if k.startswith("sweep.[")})
    emit("sweep", ok=True, systems=len(res.labels), trials=sw["trials"],
         launches=launches6,
         fast_trials_per_sec=sw["trials"] / res.wall_s["fast"],
         race_trials_per_sec=sw["trials"] / res.wall_s["race"],
         frontier_size=len(res.frontier_indices),
         frontier=list(res.frontier_labels),
         jax_cpu_frontier_for_reference=baseline)

    # ---- quorum_reached (tally_votes) --------------------------------------
    ops.reset_launches()
    reached = ops.quorum_reached(v11, 2, 7)
    torch.cuda.synchronize()
    launches_qr = dict(ops.LAUNCHES)
    if launches_qr != only(tally_votes=1):
        fail(f"quorum_reached launches {launches_qr}")
    same(reached, ref.quorum_reached(v11, 2, 7), "quorum_reached")
    same(reached, want[3], "quorum_reached vs tally_decide's reached")
    emit("quorum_reached", ok=True, launches=launches_qr,
         reached_share=float(reached.float().mean()))

    # ---- the Experiment API (tally_decide, masked_tally, race_card_hist,
    # stream_tally_decide_hist) -------------------------------------------
    exper = experiment_phase(dev, smi)
    emit("experiment", ok=True, card=exper["card"], rows=exper["rows"],
         launches=exper["launches"])

    # ---- the planner (race_card_hist, stream_tally_decide_hist,
    # masked_tally, tally_decide) ------------------------------------------
    plan = planner_phase(dev)
    emit("planner", ok=True, card=smi, rows=plan["rows"],
         launches=plan["launches"])

    # ---- the trial mesh (race_card_hist a domain chunk) ---------------------
    mesh = mesh_phase(dev, smi, compute_mode)
    emit("mesh", ok=True, card=smi, rows=mesh["rows"],
         launches=mesh["launches"])

    # ---- the model paths ----------------------------------------------------
    # Every per-kernel timing runs before the serving traces (serve_profile).
    ssd_errs = ssd_phase(dev)
    mamba = serve_phase("mamba2_130m", dev, SERVE_TOKENS)
    zamba = serve_phase("zamba2_2_7b", dev, SERVE_TOKENS)
    musicgen = serve_phase("musicgen_medium", dev, SERVE_TOKENS)
    internvl = serve_phase("internvl2_26b", dev, SERVE_TOKENS,
                           layers=INTERNVL_LAYERS)
    ssd_mamba = serving_ssd(ssd_errs, "mamba2 serving", mamba["captured"],
                            mamba["cfg"], dev)
    ssd_zamba = serving_ssd(ssd_errs, "zamba2 serving", zamba["captured"],
                            zamba["cfg"], dev)
    ssd_err = max(max(e["y_err"], e["state_err"]) for e in ssd_errs.values()
                  if isinstance(e, dict))
    emit("ssd_kernel", ok=True, errors=ssd_errs, max_abs_err=ssd_err,
         mamba2_serving=ssd_mamba, zamba2_serving=ssd_zamba)
    mk = model_kernel_phase(dev, {r["cfg"].name: r
                                  for r in (zamba, musicgen, internvl)})
    emit("model_kernels", ok=True, **mk)
    serve_launches = {}
    for res in (mamba, zamba, musicgen, internvl):
        serve_profile(res)
        serve_launches[f"serve_{res['cfg'].name}"] = res["launches"]
    del mamba, zamba, musicgen, internvl, res
    torch.cuda.empty_cache()

    # ---- deepseek_v2_lite_16b at full width and depth (MoE and MLA: RMSNorm
    # the only kernel), then MLA's checks and arctic_480b on meta ----------
    deepseek = serve_phase("deepseek_v2_lite_16b", dev, SERVE_TOKENS)
    deepseek["phase"]["checks"].update(moe_combine_check(deepseek))
    serve_profile(deepseek)
    serve_launches["serve_deepseek_v2_lite_16b"] = deepseek["launches"]
    ep = moe_ep_check(deepseek)
    emit("deepseek_ep", ok=True, card=smi, **ep)
    serve_launches["deepseek_ep"] = ep["launches"]
    del deepseek
    torch.cuda.empty_cache()
    emit("deepseek_mla", ok=True, **mla_checks(dev))
    torch.cuda.empty_cache()
    emit("arctic_meta", ok=True, **arctic_meta())

    # ---- the dry-run: every cell on both production meshes, on meta ------
    emit("dryrun", ok=True, **dryrun_phase(smi))

    # ---- training (no kernel under grad; the trained checkpoints served
    # through ssd, flash_attention and rmsnorm) ------------------------------
    train = train_phase(dev, smi)
    emit("train", ok=True, **train)

    # ---- the kernels line ---------------------------------------------------
    by_path = {"tally_votes": {"quorum_reached":
                               launches_qr["tally_votes"]},
               "tally_decide": {"masked_race":
                                launches4c["tally_decide"]},
               "masked_tally": {"masked_race": launches4["masked_tally"]},
               "stream_tally_decide_hist": {
                   "mixed_batch": launches5["stream_tally_decide_hist"]},
               "race_card_hist": {"sweep": launches6["race_card_hist"]},
               "masked_sat": {"masked_race": launches4["masked_sat"],
                              "mixed_batch": launches5["masked_sat"]},
               "sorted_prefix": {
                   "masked_race": (launches4["sorted_prefix"]
                                   + launches4c["sorted_prefix"]),
                   "mixed_batch": launches5["sorted_prefix"],
                   "sweep": launches6["sorted_prefix"]}}
    for k, v in exper["launches"].items():
        by_path[k]["experiment"] = v
    for k, v in plan["launches"].items():
        by_path[k]["planner"] = v
    for k, v in mesh["launches"].items():
        if v:
            by_path[k]["mesh"] = v
    for path, counts in serve_launches.items():
        if path == "serve_mamba2_130m":
            continue
        for k, v in counts.items():
            if v:
                by_path.setdefault(k, {})[path] = v
    for k in by_path:
        by_path[k]["train"] = train["launches"].get(k, 0)
    launches = {k: sum(v.values()) for k, v in by_path.items()}
    model_stats = {
        "ssd": dict(ssd_zamba, max_abs_err=ssd_err, library_ms=None),
        "flash_attention": dict(
            mk["flash_attention"], max_abs_err=max(
                e["err"] for e in mk["errors"]["flash_attention"].values()
                if isinstance(e, dict))),
        "rmsnorm": dict(mk["rmsnorm"], max_abs_err=max(
            e["err"] for e in mk["errors"]["rmsnorm"].values())),
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "launches_by_path": by_path[k],
         "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
         "plain_ms": stats[k]["plain_ms"], "bound_ms": stats[k]["bound_ms"],
         "bound_by": stats[k]["bound_by"],
         "library_ms": stats[k].get("library_ms")}
        for k in QUORUM_KERNELS] + [
        {"name": k, "route": "cuda", "source": MODEL_SOURCES[k],
         "replaces": REPLACES[k], "launches": launches[k],
         "launches_by_path": by_path[k],
         "max_abs_err": st["max_abs_err"], "ms": st["ms"],
         "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
         "bound_by": st["bound_by"], "library_ms": st["library_ms"]}
        for k, st in model_stats.items()]}
    if any(k["launches"] <= 0 for k in line["kernels"]):
        fail(f"a kernel was not launched on its path: {launches}")
    emit("script", seconds=time.perf_counter() - T_START)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
