#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Drives the port's paths — the paper's resource manager, with
branch-and-price pricing on the card, the serving path of the analysis
programs at the full width of gemma2-2b, mamba2-1.3b, recurrentgemma-9b
and qwen3-moe-30b-a3b, and training at the full width and depth of
internlm2-1.8b and mamba2-1.3b and at the full width of recurrentgemma-9b
and qwen3-moe-30b-a3b, and those four configs' steps sharded over four
ranks on a (2, 2) mesh — and holds every CUDA kernel of those paths
against its plain torch version.  Phases, each raising on failure:

1. device: the card's name, count and power limit;
2. build: every kernel, from ``src/repro_torch/kernels/csrc``, one nvcc
   process per source, all at once; ptxas's report of each kernel's
   registers and spills is logged, and a spill store in a tensor-core
   instantiation (``flash_wgmma``, ``decode_mma``, ``ssd_mma``,
   ``ssd_cb``), a knapsack instantiation (``knapsack_cluster``,
   ``knapsack_global``), an RG-LRU one (``rglru_tma``,
   ``rglru_cp_async``) or one of a backward (flash attention's
   ``flash_bwd_{dkdv,dq}_{wgmma,simt}``, the SSD scan's
   ``ssd_bwd_walk_mma``, ``ssd_bwd_grads_wgmma``, ``ssd_bwd_simt`` and
   ``ssd_bwd_finish``, the RG-LRU scan's ``rglru_bwd_split`` and
   ``rglru_bwd_walk``, the grouped GEMM's ``grouped_gemm_bwd_{dx,dw}_wgmma``
   and ``grouped_gemm_bwd_{dx,dw}_simt``) or in the live loop's kernels
   (``pack_scan_warp``, ``pack_scan_global``, ``placement_scores``) fails
   the phase;
3. knapsack kernel vs plain on the card, exact equality of ``best``, the
   packed take bits, the kernel's mask of steps taken (against the plain
   walk over the same bits) and the counts from it (against the host
   backtrack's): a seeded sweep of small pricings (float64 and float32),
   the 500-camera fleet's pricing grid (30,940 states) with 18 knapsacks
   and its large grid (120,384 states), each on both variants (``cluster``
   as `_variant` picks it, ``global`` forced), and a grid past 16 slices
   (217,800 states, ``global`` by shape);
4. manager path: the quickstart's paper scenario 1 under ST1-ST3 (61%
   headline), by `examples/torch_quickstart.py`'s `main`, then a 500-camera, 10-kind fleet allocated on the card
   (routes to branch-and-price), with the kernel's launches counted by
   variant (all on ``cluster``), each pricing call's wall time split into
   the host's binary split, the kernel, the wait for it, the copy of
   ``best`` and the mask of steps taken, and the host's counts, and the
   plan compared with the same fleet allocated with ``device="cpu"``;
4b. the live re-planning loop, each replay with the live loop's kernel
   counts set to 0 just before it and read just after: (a) phase 4's
   500-camera controller folds `LIVE_EVENTS` churn events over the same
   10 kinds (joins, leaves, rate and price changes, a reclamation notice
   and a preemption of the instance with the most streams), each event
   printed with its mode, $/h, gap, migrations, knapsack launches by
   variant and placement calls by route, wall and kernel ms, and compared
   with the same replay with ``device="cpu"`` and with the reference's
   `LIVE_GOLDEN`; (b) `benchmarks/churn_replan.py`'s 500-stream,
   200-event replay on ``CALIBRATION_ec2.json`` (warm path only), its
   digest against `REPLAN_GOLDEN`; (c) `benchmarks/lifecycle.py`
   experiment 3 (the acting autoscaler on the 500-stream bursty growth
   trace, 2-minute boot), billed cost, degraded stream-seconds and spares
   against `GROWTH_GOLDEN`, every what-if on the pack scan.  Then every
   greedy-repair matrix through numpy, the placement kernel and its
   plain version, bit for bit, plus one fleet-scale matrix; both kernels
   timed beside their plain versions and bounds, the pack scan also beside
   its empty walk (`pack.empty_walk`: the walk's n steps without their
   pair loop, the floor the dependent steps set), the placement scores
   beside an empty kernel of the same launch shape (`placement.empty_launch`,
   the call's floor); then every pack-scan launch is held
   against `pack_scan_plain` on the card, bit for bit;
4c. the sharded controller (`core/shard.py`), each part with the live
   loop's kernel counts set to 0 just before it and read just after:
   (a) `benchmarks/shard.py`'s 100,000 streams over 512 cells — two twins
   cold-started by one batched pack scan each (B = 512 fleets), the
   serial per-cell certification on one and the batched one (one knapsack
   launch a column-generation round over every (cell, instance type)
   knapsack, cold then warm) on the other, 192 events through the serial
   loop and through the batched pipeline (delta 0), and a third twin
   folding them on `SHARD_WORKERS` threads (equal) — against
   `SHARD_GOLDEN` (the summed lower bounds, the per-event (cost, lower
   bound) digest, the end state, the routing and pricing counters); (b)
   `repack()` on the live cells against `REPACK_GOLDEN`; (c) the
   500-stream cost parity on the benchmark trace's first `PARITY_EVENTS`
   events (flat, one cell equal to flat at every step, 8 cells with the
   market), run in processes of their own and joined last, so that the
   script keeps to its time limit: the 8-cell replay, whose market's
   trial moves take minutes of host work, from the start of phase 2, the
   flat and one-cell replays from the start of phase 4c; against
   `PARITY_GOLDEN`.  So phases 4, 4b and 4c's (a), (b) and (d) are timed
   beside one or two replay processes (each one host thread, the 8-cell
   one launching a few knapsacks on the card); (d) a sharded `simulate_churn` on a
   spot catalog (8 cells, a consolidation policy a cell, the batched
   reset, the market) whose whole output dict must digest to
   `CHURN_GOLDEN`'s.  Each step's wall time, kernel ms by kernel (CUDA
   events around every launch) and launches by variant are logged; then
   every pack-scan and knapsack launch of the phase against its plain
   version on the card, bit for bit, and both timed at the phase's
   largest launch beside their plain versions and bounds;
5. knapsack timing: each variant and the plain version on the card at the
   manager path's largest pricing call, with CUDA events around calls
   queued while the card spins (`time_cold_ms`), beside the bound with
   take at one byte a state (as the first port of the kernel counted it)
   and at one bit;
5b. the paper's test runs: VGG-16 and ZF at full width on a 640x480 frame
   (`PROGRAMS`, default device) against the same seeded weights on the
   CPU (1e-3 of the largest logit), each timed warm a frame a call (CUDA
   events, median of 25) beside its bound; ``calibrate(impl="torch")`` on
   the card against ``impl="numpy"`` bit for bit on both presets and 256
   random workloads each, quantized and raw, and the numpy artifacts
   against the committed ``CALIBRATION_*.json``; the reference's two
   calibrated allocations (`benchmarks/calibration.py`: ec2, 20 VGG-16 at
   0.2 FPS and 20 ZF at 5 FPS; the 50-stream tpu mix) through
   branch-and-price on the card, knapsack launches counted (set to 0
   just before each allocate), each plan compared with the same
   allocation with ``device="cpu"`` and with the reference's
   (`REFERENCE_CALIBRATED`); then ``cpu_mode="measured"`` on the ec2
   preset, the programs timed on this machine's CPU (logged);
6. serving kernels vs plain on the card.  Attention in float32 (atol =
   rtol = 2e-5) and bfloat16 (rtol one bf16 ulp, 2^-7, atol 1e-4): flash
   attention at gemma2-2b's served prefill (B=4, S=2048), at 8192 tokens
   with a binding 4096 window, at internlm2-1.8b's and recurrentgemma-9b's
   layers (H=16 over one KV head of 256, S=1024, window 2048), at ragged
   lengths and at ragged lengths with a binding window at D=128 and 256,
   each launch checked for the variant `_variant` picks (``wgmma`` for
   bf16, ``simt`` for float32), and, on ``wgmma``, the exact case for D =
   64, 128 and 256 (q_i = 2048 e_i, k_j = e_j: the output must be v bit
   for bit); flash-decode at gemma2-2b's served cache, a wrapped 4096-slot
   ring, internlm2-1.8b's, recurrentgemma-9b's (R=16, L=1040) and
   qwen3-moe-30b-a3b's (R=8) caches, a ragged cache, R=20 (two row
   groups) and a cache with no valid slot (the mean of v), each launch
   checked for the variant `_variant` picks (``mma`` for bf16, ``simt``
   for float32), and, on ``mma``, its exact case (L = D, k_j = e_j, q =
   2048 e_j*: the output must be v[j*] bit for bit) at D = 64, 128, 256
   and R = 2, 8, 16, 20.  The SSD scan in float32 (atol 2e-4, rtol 1e-3)
   and bfloat16 (one bf16 ulp more) at mamba2-1.3b's served prefill (B=4,
   S=1024, H=64, P=64, N=128) with and without h0, at ragged S=1000 and
   S=7, and at other head, state and chunk sizes it is built for, each
   launch checked for its variant (``mma`` or ``simt``).  The
   RG-LRU scan in float32 (2e-5) at recurrentgemma-9b's served prefill
   (B=4, S=1024, W=4096) with h0 and at ragged lengths, on the variant
   `_variant` picks (``tma`` where W is a multiple of 4, else
   ``cp_async``) and, where W allows both, on the other one forced.  The grouped GEMM
   in float32 and bfloat16 (the attention limits), each launch checked for
   the variant `_variant` picks (``wgmma`` or ``simt``) and
   for zero rows outside the segments: at qwen3-moe-30b-a3b's served
   prefill (about 32,768 (token, choice) pairs over 128 experts, K=2048,
   F=768, and K=768, F=2048 for ``down``), at a decode step's 32 pairs
   with empty experts, at ragged K and F, at segments of 0, 1, 63, 64,
   65, 129 and 320 rows (N=647, F=136; down's shape; over 650 experts),
   with all rows on one expert, at K=72, every variant forced on the same
   edge segments, identity weights rotated per expert (exact), and
   through the reference-contract adapter with block_t 64 and 128, and
   with its blocks in shuffled order;
7. serving path: (a) the launcher `repro_torch.launch.serve.main` for
   full-width gemma2-2b and mamba2-1.3b (the manager plans the fleet, one
   engine per instance serves it; its 6-10-token prompts are one ragged
   SSD chunk); (b) frame analysis: a `ServingEngine` for each of
   full-width, full-depth gemma2-2b, mamba2-1.3b, recurrentgemma-9b and
   qwen3-moe-30b-a3b in bf16 serves 8 requests of `PROMPT_TOKENS`-token
   prompts (2048, 1024, 1024, 1024) over 4 slots, 16 greedy tokens each,
   with every kernel's launches counted and asserted by layer kind, in
   prefill and in decode (gemma2-2b: 26 flash a wave, 26 flash-decode a
   step; mamba2-1.3b: 48 SSD scans a wave, none a step;
   recurrentgemma-9b: 26 RG-LRU scans and 12 flash a wave, 12
   flash-decode a step, every RG-LRU launch on ``tma``; qwen3-moe-30b-a3b: 48 flash and 144 grouped GEMMs
   a wave, 48 flash-decode and 144 grouped GEMMs a step; every flash and
   grouped GEMM launch on its ``wgmma`` variant, every flash-decode and
   SSD launch on ``mma``) and CUDA events around
   every launch and every forward call.  Each model is freed before the
   next: qwen3-moe-30b-a3b's 61 GB leave room for nothing else; (c)
   gemma2-2b with (b)'s weights serves one wave of 4 prompts and 4 decode
   steps through `launch/steps.py`'s `make_prefill_setup` and
   `make_decode_setup` on the (1, 1) mesh, launches counted, every logit
   bit-equal to `forward_prefill` and `forward_decode` called directly;
8. kernel timing and the models against their plain paths: each kernel
   held against its plain version on phase 7(b)'s own served inputs
   (attention gemma2-2b's, recurrentgemma-9b's and qwen3-moe-30b-a3b's,
   the SSD scan mamba2-1.3b's, the RG-LRU scan
   recurrentgemma-9b's (also on ``cp_async`` and at 128 lanes a CTA,
   forced), the grouped GEMM
   qwen3-moe-30b-a3b's first gate and down products and first decode
   step's gate product), then timed there beside its plain version, its
   bound (gemma2-2b's flash call also in float32, on ``simt``, with its
   own flex_attention yardstick) and a
   library yardstick where one PyTorch call computes the same
   function (``scaled_dot_product_attention`` at recurrentgemma-9b's
   attention, whose window does not bind, at qwen3-moe-30b-a3b's
   attention and at internlm2-1.8b's shapes; at gemma2-2b's, whose
   softcap SDPA cannot apply, `torch.compile` of flex_attention with the
   softcap as its score_mod (`flex_attention_call`); ``torch._grouped_mm`` where
   the card's PyTorch runs it, else, at
   prefill, one ``torch.bmm`` over the reference's capacity buffer), the
   decode product also with L2 flushed by reads only and not flushed;
   gemma2-2b's attention calls also in float32, on ``simt``; the SSD's
   C·Bᵀ and per-head passes and flash-decode's ``simt`` split and combine
   passes also apart (`time_cold_parts_ms`; flash-decode's ``mma`` kernel
   merges its splits in its one launch); then each model at full width in
   float32, one 2 x prompt prefill and 8 decode steps, on the kernels and
   again with every kernel's dispatch patched to its plain version (flash
   attention, flash-decode and the SSD scan on their ``simt`` variants,
   checked), logits compared:
   gemma2-2b at 12 layers, mamba2-1.3b at 24, recurrentgemma-9b at one
   19-layer group, qwen3-moe-30b-a3b at 4 of its 48 layers (`MODEL_LAYERS`;
   full depth in float32 would take 122 GB).  Routing is a discontinuous function of float32 sums, so
   the plain run takes the kernel run's expert choices (its own
   probabilities at them) and counts the choices it would have made
   otherwise;
9. training: (a) the flash backward kernel (`flash_attention_bwd.cu`,
   three passes) against `flash_attention_backward_plain` on the same q,
   k, v, o, lse and dO, and the forward's lse against the plain
   logsumexp, in bf16 and float32 at internlm2-1.8b's attention (B=2,
   S=4096, H=16, KV=8, D=128), gemma2-2b's local (window 4096, softcap
   50) and global layers (B=1, S=8192, H=8, KV=4, D=256) and
   recurrentgemma-9b's local layer (B=1, S=4096, H=16, KV=1, D=256,
   window 2048), limits in `BWD_TOLERANCE`, each bf16 case counted on
   the ``wgmma`` variant and each float32 one on ``simt``; each timed
   cold, whole and by pass (D and dk/dv, then dq), beside its bound, its
   plain version and a library yardstick: SDPA's backward at
   internlm2-1.8b's shape, SDPA's with the window as a boolean mask at
   recurrentgemma-9b's, and at gemma2-2b's, whose softcap SDPA cannot
   apply, `torch.compile` of flex_attention with the softcap as its
   score_mod (both types; the error it raises where it refuses the
   shape); the SSD scan's backward (`ssd_bwd.cu`) at mamba2-1.3b's
   training call (B=2, S=4096, H=64, P=64, N=128, chunk 128) in bf16
   (``mma``) and float32 (``simt``) and the RG-LRU scan's
   (`rglru_bwd.cu`) at recurrentgemma-9b's (B=1, S=4096, W=4096),
   against their plain versions within `ssd.BWD_TOLERANCE` and
   `rglru.BWD_TOLERANCE`, bit for bit over a repeat, timed cold beside
   their bounds and plain versions (no PyTorch call computes either), the
   SSD's with each of its launches (`ssd.BWD_PASSES`) timed apart, the
   RG-LRU's ``split`` beside its ``walk`` forced (at `rglru._lanes`'s
   width and at 32 lanes), and the RG-LRU forward at that shape beside
   its bound; the grouped GEMM's backward (`grouped_gemm_bwd.cu`, ``dx``
   and ``dw``) on the segments of a real routing at qwen3-moe-30b-a3b's
   training call (B=1, S=4096: 16 dispatch groups, capacity 20 an expert
   a group, 32,768 pairs, the dropped ones past the segments) at the
   gate/up products' (K=2048, F=768) and the down product's (K=768,
   F=2048) shapes, in bf16 (on ``wgmma``, and on ``simt`` forced) and
   float32 (``simt``), and on the same segments with four experts left
   empty, against `grouped_gemm_backward_plain` at the forward's limits,
   each launch counted on its design, bit for bit over a repeat, timed
   cold beside its bound, its plain version and ``torch._grouped_mm``
   (dx as (dy, wᵀ), dw as (xᵀ, dy) with the offsets on the contraction;
   the message where it refuses), the bf16 ``wgmma`` launch in turns with
   ``simt`` forced on the same inputs;
   (b) float32 at full width on the card and on the CPU from the same
   weights, B=1, S=256 (`TRAIN_PARITY`: internlm2-1.8b, mamba2-1.3b and
   qwen3-moe-30b-a3b at 1 layer, recurrentgemma-9b at 3): every gradient
   leaf within 1e-3 of its largest |grad|, then (but for
   `TRAIN_PARITY_GRADS_ONLY`) one train step's loss, grad norm and every
   updated weight within 1e-3, every backward on
   ``simt`` (RG-LRU's one variant; the grouped GEMM's float32 design);
   the MoE model's CPU runs take the card runs' expert choices, the rows that
   would have chosen others counted and printed, as in phase 8; (c) bf16
   with remat at S=4096, AdamW steps on one fixed batch (`TRAIN_RUNS`):
   internlm2-1.8b and mamba2-1.3b at full width and depth, B=2, 3 steps;
   recurrentgemma-9b at full width, its depth cut to 6 layers, and
   qwen3-moe-30b-a3b at full width, its depth cut from 48 layers to 6
   (`QWEN_TRAIN_LAYERS`; the cuts printed), B=1, 3 steps; every kernel
   count set to 0 just before and held after to `expected_train_counts`
   (one backward launch and two forward launches (remat) per layer a
   step, on the bf16 variants; a MoE layer's three grouped GEMMs six
   times and a ``dx`` and a ``dw`` launch for each, all on ``wgmma``):
   the loss must fall, each step's wall ms split by CUDA events into
   forward, backward and optimizer, tokens/s, the
   last step traced with `torch.profiler` for the card's busy share,
   peak memory against the card's; every step built by `launch/steps.py`'s
   `make_train_setup` on the (1, 1) mesh of a one-rank process group;
   (d) the launcher
   `python -m repro_torch.launch.train --smoke --steps 2 --ckpt ...` in a
   process of its own (its step built the same way), its checkpoint
   restored; (e) gradient accumulation: one internlm2-1.8b step at full
   width and depth (bf16, remat, B=2, S=4096) with 2 micro-batches and
   one with 1, from the same seed-0 weights and batch: loss within 1e-3
   and grad norm within 1e-2 relative, each step's launches held to
   `expected_train_counts` (2 micro-batches: twice the launches at half
   the rows), both wall times printed;
10. dry-run: `launch/dryrun.py`'s `run_one` (nothing saved) on
   qwen3-moe-30b-a3b train_4k 16x16, gemma2-2b long_500k 2x16x16 and
   yi-34b decode_32k 16x16: each step's leaves placed on meta over a fake
   process group of 256 or 512 ranks, every shard even, rank 0's bytes a
   device printed by kind, and each step run on those meta shards to
   count its collectives (CPU arithmetic; nothing runs on the card);
11. sharded execution: the kernels built, four processes share the card
   over gloo on a (2, 2) ("data", "model") mesh (`SHARD_ARCHS`:
   internlm2-1.8b, qwen3-moe-30b-a3b (expert-parallel, 64 of 128 experts
   a rank) and mamba2-1.3b at one layer, recurrentgemma-9b at one
   (recurrent, recurrent, attention) group, all at full width; each rank
   draws the whole model in turn and keeps its shard): in bf16 a train
   step (B 4 x S 1024, 2 rows a data rank), a prefill and 4 decode steps
   (recurrentgemma-9b's one KV head leaves its decode caches' slots split
   over model, merged by `decode_attention`'s lse), internlm2-1.8b and
   recurrentgemma-9b also in float32 (forward, prefill, decode); every
   launch count and collective counter set to 0 before, each rank's
   launches by kernel and design and the collectives gloo took on CUDA
   tensors printed, every model kernel and backward launched on every
   rank; then one rank on the card does the same work: the train step's
   loss within 1e-2 and grad norm within 5e-2 relative, bf16 logits
   (the prompt's last 16 positions, each decode step's) within 0.15 or
   one bf16 ulp of the largest |logit| (the MoE by the reference test's
   mean error under 0.02 and share over 0.2 under 0.02), float32 within
   1e-3 of the largest |logit|.

float32 products run in full float32: TF32 is switched off for matmuls
and cuDNN.  Every kernel time is taken with a cold L2 by `time_cold_ms`,
which spins the card for at least twice the host's dispatch time of one
call before each, so that the host's launch time stays outside the
events.  Phase 1 prints ``nvidia-smi``'s name and power limit on a line
of its own.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Needs one
CUDA card:

    python3 chip_smoke.py [--json PATH] [--kernel-only]

``--kernel-only`` runs phases 1-3 and 6.
``--parity PART PATH`` is how the script starts phase 4c (c)'s replays
(``cells``: the 8-cell one; ``flat``: the flat and one-cell ones) in
processes of their own.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import DEFAULT_TOKENS_PER_FRAME, get_config, smoke_variant  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import shard  # noqa: E402
from repro_torch.core import streams as port_streams  # noqa: E402
from repro_torch.core.binpack import colgen  # noqa: E402
from repro_torch.core.binpack import heuristics  # noqa: E402
from repro_torch.core.binpack.arcflow import group_items  # noqa: E402
from repro_torch.core.catalog import (  # noqa: E402
    paper_ec2_catalog, tpu_cloud_catalog, with_spot_variants)
from repro_torch.core.controller import FleetController  # noqa: E402
from repro_torch.core.lifecycle import BillingModel  # noqa: E402
from repro_torch.core.manager import ResourceManager  # noqa: E402
from repro_torch.core.profiler import paper_profile_table  # noqa: E402
from repro_torch.core.policy import ActingAutoscaler, ConsolidationPolicy  # noqa: E402
from repro_torch.core.simulator import simulate_churn, simulate_plan  # noqa: E402
from repro_torch.core.strategies import ST3  # noqa: E402
from repro_torch.core.streams import AnalysisProgram, FrameSize, StreamSpec  # noqa: E402
from repro_torch.interop import plan_to_plain, replan_result_to_plain  # noqa: E402
from repro_torch.kernels import _build, knapsack, pack, placement  # noqa: E402
from repro_torch.kernels import attention as flash  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.kernels import rglru, ssd  # noqa: E402
from repro_torch.launch import dryrun, serve  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.mesh import destroy_process_group, make_local_mesh  # noqa: E402
from repro_torch.models import analysis_programs  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.layers import init_dense  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.data import BatchSpec, make_batch  # noqa: E402
from repro_torch.interop import param_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_loop import batch_to_device, train  # noqa: E402

#: The JAX reference's result for the 500-camera fleet on a CPU, for the
#: reader: $/h and instance count (repro.core.manager, numpy pricing).
REFERENCE_500 = (24.657, 39)
#: Phase 4b: the JAX reference's answers on a CPU to the live loop's three
#: replays (`scripts/torch_live_loop_goldens.py`, numpy pricing).  (a) per
#: event of the 500-camera fleet's churn: (event, $/h, mode, migrated).
LIVE_GOLDEN = (
    ('PriceChanged', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamRateChanged', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRateChanged', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamAdded', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRateChanged', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('StreamRemoved', 22.587, 'warm', 0),
    ('InstancePreemptionNotice', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamAdded', 21.994500000000002, 'warm', 0),
    ('StreamRemoved', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamRemoved', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamAdded', 21.994500000000002, 'warm', 0),
    ('StreamRemoved', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamRemoved', 21.994500000000002, 'warm', 0),
    ('StreamRemoved', 21.994500000000002, 'warm', 0),
    ('StreamRemoved', 21.994500000000002, 'warm', 0),
    ('StreamAdded', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('StreamAdded', 21.994500000000002, 'warm', 0),
    ('StreamRateChanged', 21.994500000000002, 'warm', 0),
    ('InstancePreempted', 21.402, 'warm', 0),
    ('StreamAdded', 21.402, 'warm', 0),
    ('StreamRateChanged', 21.402, 'warm', 0),
    ('StreamRemoved', 21.402, 'warm', 0),
    ('StreamRateChanged', 21.402, 'noop', 0),
    ('StreamRateChanged', 21.402, 'warm', 0),
    ('StreamRateChanged', 21.402, 'warm', 0),
    ('StreamRateChanged', 21.402, 'warm', 0),
    ('StreamRemoved', 21.402, 'warm', 0),
    ('StreamAdded', 21.402, 'warm', 0),
    ('StreamRemoved', 21.402, 'warm', 0),
    ('PriceChanged', 21.402, 'warm', 0),
    ('StreamRemoved', 21.402, 'warm', 0),
    ('StreamRemoved', 21.402, 'warm', 0),
    ('PriceChanged', 21.372600000000002, 'warm', 0),
    ('StreamRateChanged', 21.372600000000002, 'warm', 0),
    ('StreamRateChanged', 21.372600000000002, 'warm', 0),
    ('StreamRateChanged', 21.372600000000002, 'warm', 0),
    ('StreamRateChanged', 21.372600000000002, 'noop', 0),
    ('StreamRateChanged', 21.372600000000002, 'warm', 0),
)
#: (b) `benchmarks/churn_replan.py`'s replay: the digest of its per-event
#: (cost, mode, migrated, gap) rows (`replay_digest`), its modes, its last $/h.
REPLAN_GOLDEN = {
    "digest": "381952d8ffb8b45fcff2cf8446727122e92aedd2e3c46983f8d7b408a66c772d",
    "modes": {"warm": 166, "full": 1, "noop": 33},
    "final_cost": 42.3853,
}
#: (c) `benchmarks/lifecycle.py` experiment 3: billed $, degraded
#: stream-seconds past the initial boot, spares provisioned.
GROWTH_GOLDEN = {
    "billed_cost": 154.70000000000002,
    "degraded_stream_seconds": 1071.0208979429153,
    "spares_provisioned": 13,
}
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; non-tensor fp32 op/s;
#: dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: Kernel vs plain on the card, (atol, rtol).  Both compute in float32 and
#: differ only in the order of their sums: float32 keeps the reference's
#: 2e-5 (tests/test_kernels.py:16-18); in bfloat16 the two float32 results
#: round to outputs at most one bf16 ulp apart, which rtol 2^-7 covers, and
#: atol 1e-4 covers the float32 difference (at most 2.2e-6 measured).
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}
#: The SSD kernel vs plain: float32 at the reference's kernel limits
#: (tests/test_kernels.py:83-84), since both cut S into the same chunks and
#: differ in the order of their float32 sums; bfloat16 adds one bf16 ulp
#: (rtol 2^-7), since both round the float32 y once.  The state is float32.
SSD_TOLERANCE = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (2e-4, 1e-3 + 2.0 ** -7)}
#: The RG-LRU kernel vs plain: the same float32 multiply-adds, fused or
#: not, the kernel's composed chunk by chunk: 2e-5, the reference's float32
#: kernel limit.
RGLRU_TOLERANCE = (2e-5, 2e-5)
#: The serving path's models and their frame-analysis deployment.  Their
#: prompts: DEFAULT_TOKENS_PER_FRAME's (2048, 1024 and 1024 tokens), and
#: 1024 for qwen3-moe-30b-a3b, which has no entry there.
SERVE_ARCHS = ("gemma2-2b", "mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b")
PROMPT_TOKENS = {**DEFAULT_TOKENS_PER_FRAME, "qwen3-moe-30b-a3b": 1024}
LAUNCHER_ARCHS = ("gemma2-2b", "mamba2-1.3b")
NEW_TOKENS = 16
SLOTS = 4
N_REQUESTS = 8
#: Phase 8: float32 logits of the kernel path vs the plain path, absolute.
#: Both are float32 throughout and differ only in the order of the kernels'
#: sums, carried through the layers: gemma2-2b's 26 (attention, logits
#: softcapped at 30); mamba2-1.3b's 48 (the SSD scan: the same chunks,
#: another order of the block products' sums); recurrentgemma-9b's 38 (the
#: RG-LRU scan, fused or separate multiply-adds, and attention at rep 16);
#: qwen3-moe-30b-a3b's 8 (attention at rep 8, the grouped GEMM's K-sums).
#: Logits are O(1) in all four (normed activations against embeddings of
#: scale 0.02, or an unembedding of scale 1/sqrt(d)), so 1e-3 is some 1e-3
#: of them.
MODEL_ATOL = {"gemma2-2b": 1e-3, "mamba2-1.3b": 1e-3, "recurrentgemma-9b": 1e-3,
              "qwen3-moe-30b-a3b": 1e-3}
#: Phase 8's depth cut: the float32 models at about half their depth
#: (recurrentgemma-9b one of its two 19-layer groups), which gives back
#: some of phase 11's seconds; qwen3-moe-30b-a3b at 4 of its 48 layers
#: (full depth in float32 would take 122 GB).
MODEL_LAYERS = {"gemma2-2b": 12, "mamba2-1.3b": 24, "recurrentgemma-9b": 19,
                "qwen3-moe-30b-a3b": 4}

VGG = AnalysisProgram("VGG-16", "vgg16")
ZF = AnalysisProgram("ZF", "zf")
KINDS = [(VGG, f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
    (ZF, f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)
]
#: The main path's fleet: cameras over the 10 kinds (REFERENCE_500's fleet).
N_CAMERAS = 500
#: Phase 5b: the JAX reference's calibrated allocations on a CPU (numpy
#: pricing; `benchmarks/calibration.py`'s two scenarios): $/h, instances by
#: type, optimal.
REFERENCE_CALIBRATED = {
    "ec2": (3.900, {"g2.2xlarge": 6}, True),
    "tpu": (12.870, {"v5e-4": 1, "v5e-8": 1}, False),
}
#: The tpu scenario's 50-stream mix, a copy of `benchmarks/calibration.py`'s
#: ``MIX``: (program, fps, count).
CALIBRATED_MIX = (
    ("vgg16", 0.2, 12),
    ("zf", 5.0, 8),
    ("internlm2-1.8b", 0.05, 10),
    ("gemma2-2b", 4.0, 8),
    ("llava-next-mistral-7b", 1.5, 6),
    ("mamba2-1.3b", 0.4, 6),
)
#: Phase 5b: VGG-16 and ZF on the card against the same weights on the
#: CPU, both float32 (TF32 off): cuDNN's and the CPU's convs sum in other
#: orders, so 1e-3 of the largest logit, as for the float32 models.
PROGRAM_RTOL = 1e-3
#: The analysis programs' camera frame (the paper's MJPEG streams).
PROGRAM_FRAME = FrameSize(640, 480)


def camera_fleet(n: int) -> list[StreamSpec]:
    """n cameras over 10 kinds (VGG-16 and ZF at five rates each)."""
    return [
        StreamSpec(f"cam{i}", KINDS[i % 10][0], KINDS[i % 10][1]) for i in range(n)
    ]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


PTXAS_FUNCTION = re.compile(
    r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
    r"stores, (\d+) bytes spill loads\s*\n.*?Used (\d+) registers")


def ptxas_report(build_log: str) -> dict:
    """Per kernel function of an ``-Xptxas -v`` log: registers a thread and
    bytes of spill stores and loads."""
    return {m[1]: {"registers": int(m[5]), "spill_stores": int(m[3]), "spill_loads": int(m[4])}
            for m in PTXAS_FUNCTION.finditer(build_log)}


def check_spills(source: str, kernel: str, expected: int) -> dict:
    """Phase 2's spill check: every instantiation of ``kernel`` (a piece of
    its mangled name) in ``source``'s build must come without spill
    stores, and there must be ``expected`` of them.  A library reused from
    an earlier build in this checkout has no log, and is reported as such."""
    info = _build.BUILD_INFO[source]
    if not info["log"]:
        log(f"  {source} reused from an earlier build: no ptxas report to check")
        return {}
    report = {f: r for f, r in ptxas_report(info["log"]).items() if kernel in f}
    if len(report) != expected:
        raise AssertionError(f"ptxas report: {len(report)} {kernel} instantiations, "
                             f"expected {expected}")
    spilled = {f: r for f, r in report.items() if r["spill_stores"]}
    if spilled:
        raise AssertionError(f"{kernel} spills: {spilled}")
    log(f"  {kernel} registers {sorted(r['registers'] for r in report.values())}, "
        "no spill stores")
    return report


def check_flash_wgmma_spills() -> dict:
    """`check_spills` of the ``flash_wgmma`` instantiations, one per head_dim."""
    return check_spills("flash_attention", "flash_wgmma", len(flash.HEAD_DIMS))


#: The instantiations phase 2 holds to no spill stores, by (source,
#: kernel): flash-decode's ``decode_mma`` per head_dim and row groups (1, 2,
#: ... up to 512 / D), the SSD's ``ssd_mma`` per (P, N, chunk) and
#: ``ssd_cb`` per (N, chunk), the knapsack's ``knapsack_cluster`` per value
#: type and states a thread (1, 2, 4, 8) and ``knapsack_global`` per value
#: type, the RG-LRU scan's ``rglru_tma`` and ``rglru_cp_async`` per CTA
#: width (64, 128 lanes), flash attention's backward ``flash_bwd_dkdv_*`` and
#: ``flash_bwd_dq_*`` per variant (``wgmma`` bf16, ``simt`` float32) and
#: head_dim, the SSD scan's backward ``ssd_bwd_walk_mma``,
#: ``ssd_bwd_grads_wgmma`` and ``ssd_bwd_simt`` per (P, N, chunk) and its
#: ``ssd_bwd_finish`` per chunk, the RG-LRU scan's backward
#: ``rglru_bwd_split`` (32 lanes) and ``rglru_bwd_walk`` per CTA width (32,
#: 64, 128 lanes), the pack scan's
#: ``pack_scan_warp`` (the scan and its empty walk, first and best fit, each
#: for 4 dimensions and 2 choices and for any) and ``pack_scan_global``,
#: the placement scores' ``placement_scores`` (4 dimensions and any), and
#: the grouped GEMM's backward ``grouped_gemm_bwd_dx_wgmma`` and
#: ``grouped_gemm_bwd_dw_wgmma`` (bf16) and ``grouped_gemm_bwd_dx_simt`` and
#: ``grouped_gemm_bwd_dw_simt`` per type (bf16, float32).
SPILL_CHECKED = {
    ("decode_attention", "decode_mma"): sum(int(np.log2(512 // d)) + 1
                                            for d in decode.HEAD_DIMS),
    ("ssd", "ssd_mma"): len(ssd.HEAD_DIMS) * len(ssd.STATES) * len(ssd.CHUNKS),
    ("ssd", "ssd_cb"): len(ssd.STATES) * len(ssd.CHUNKS),
    ("knapsack", "knapsack_cluster"): 2 * 4,
    ("knapsack", "knapsack_global"): 2,
    ("rglru", "rglru_tma"): 2,
    ("rglru", "rglru_cp_async"): 2,
    ("flash_attention_bwd", "flash_bwd_dkdv_wgmma"): len(flash.HEAD_DIMS),
    ("flash_attention_bwd", "flash_bwd_dq_wgmma"): len(flash.HEAD_DIMS),
    ("flash_attention_bwd", "flash_bwd_dkdv_simt"): len(flash.HEAD_DIMS),
    ("flash_attention_bwd", "flash_bwd_dq_simt"): len(flash.HEAD_DIMS),
    ("ssd_bwd", "ssd_bwd_walk_mma"): len(ssd.HEAD_DIMS) * len(ssd.STATES) * len(ssd.CHUNKS),
    ("ssd_bwd", "ssd_bwd_grads_wgmma"): len(ssd.HEAD_DIMS) * len(ssd.STATES) * len(ssd.CHUNKS),
    ("ssd_bwd", "ssd_bwd_simt"): len(ssd.HEAD_DIMS) * len(ssd.STATES) * len(ssd.CHUNKS),
    ("ssd_bwd", "ssd_bwd_finish"): len(ssd.CHUNKS),
    ("pack", "pack_scan_warp"): 8,
    ("pack", "pack_scan_global"): 1,
    ("rglru_bwd", "rglru_bwd_split"): 1,
    ("rglru_bwd", "rglru_bwd_walk"): 3,
    ("placement", "placement_scores"): 2,
    ("grouped_gemm_bwd", "grouped_gemm_bwd_dx_wgmma"): 1,
    ("grouped_gemm_bwd", "grouped_gemm_bwd_dw_wgmma"): 1,
    ("grouped_gemm_bwd", "grouped_gemm_bwd_dx_simt"): 2,
    ("grouped_gemm_bwd", "grouped_gemm_bwd_dw_simt"): 2,
}


def check_instance_spills() -> dict:
    return {kernel: check_spills(source, kernel, n)
            for (source, kernel), n in SPILL_CHECKED.items()}


# --------------------------------------------------------------- phase 3


class Patched:
    """Within the block, the attributes ``attrs`` of ``mod`` (a None value
    leaves that one as it is); restored after."""

    def __init__(self, mod, **attrs):
        self.mod = mod
        self.attrs = {k: v for k, v in attrs.items() if v is not None}
        self._saved = {k: getattr(mod, k) for k in self.attrs}

    def __enter__(self):
        for k, v in self.attrs.items():
            setattr(self.mod, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            setattr(self.mod, k, v)


def forced_knapsack(variant):
    """`knapsack._variant` answering ``variant`` (None: its own choice)."""
    return Patched(knapsack, _variant=None if variant is None else
                   (lambda s_n: variant))


def forced_rglru(variant=None, lanes=None):
    """`rglru._variant` answering ``variant`` and `rglru._lanes` ``lanes``
    (None: the wrapper's own choice)."""
    return Patched(rglru, _variant=None if variant is None else (lambda w, aligned=True: variant),
                   _lanes=None if lanes is None else (lambda bsz, w, n_sms: lanes))


def compare_on_card(steps: knapsack.PricingSteps, e_n: int, label: str,
                    variant=None) -> dict:
    """Kernel vs plain on the card on one pricing batch, exact equality:
    best, the packed take bits, the kernel's mask of steps taken against
    the plain walk over the plain bits, and the counts from that mask
    against the host backtrack's.  ``variant`` forces one (None: the one
    `_variant` picks); the launch is checked to have run on it."""
    args = steps.to("cuda")
    want = variant or knapsack._variant(steps.states)
    before = dict(knapsack.LAUNCHES_BY_VARIANT)
    with forced_knapsack(variant):
        best_k, take_k, taken_k = knapsack._dispatch(*args)
    torch.cuda.synchronize()
    rose = {n: knapsack.LAUNCHES_BY_VARIANT[n] - before[n] for n in before}
    if rose != {n: int(n == want) for n in before}:
        raise AssertionError(f"{label}: expected one {want} launch, counted {rose}")
    best_p, take_p = knapsack.knapsack_dp_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(take_k, take_p):
        bad = int((take_k != take_p).sum())
        raise AssertionError(f"{label} [{want}]: take words differ in {bad} places")
    if not torch.equal(best_k, best_p):
        raise AssertionError(f"{label} [{want}]: best differs: {best_k} vs {best_p}")
    taken_p = knapsack.taken_steps_plain(take_p, steps.shifts, steps.final_idx)
    if not np.array_equal(taken_k.cpu().numpy(), taken_p):
        raise AssertionError(f"{label} [{want}]: steps taken differ")
    counts_k = steps.counts_from_taken(taken_k.cpu().numpy(), e_n)
    counts_p = steps.counts(knapsack.unpack_take(take_p, steps.states).cpu().numpy(), e_n)
    if not np.array_equal(counts_k, counts_p):
        raise AssertionError(f"{label} [{want}]: counts differ")
    err = float((best_k.double() - best_p.double()).abs().max())
    b_n, t_n = steps.step_values.shape
    return {"label": label, "variant": want, "B": b_n, "T": t_n, "S": steps.states,
            "max_abs_err": err}


def random_pricing(rng, b_n, e_n, dim, dtype):
    values = rng.uniform(0.0, 1.0, size=(b_n, e_n)).astype(dtype)
    weights = rng.randint(0, 4, size=(b_n, e_n, dim)).astype(np.int64)
    weights[..., 0] = np.maximum(weights[..., 0], 1)
    bounds = rng.randint(0, 5, size=(b_n, e_n)).astype(np.int64)
    cap_levels = rng.randint(1, 7, size=(b_n, dim)).astype(np.int64)
    return values, weights, bounds, cap_levels


def fleet_pricing(problem, grid_states: int, n_nodes: int, seed: int):
    """colgen's pricing batch for ``problem`` with seeded duals: every
    (node, bin kind) knapsack on the shared grid, as `_price_dp` builds it."""
    class_reqs, demands, _members = group_items(problem)
    grid = colgen._discretize(problem, class_reqs, grid_states)
    rng = np.random.RandomState(seed)
    duals = rng.uniform(0.0, 0.5, size=(n_nodes, len(class_reqs)))
    n_kinds = grid.weights.shape[0]
    values = np.repeat(duals[:, grid.entry_class], n_kinds, axis=0)
    weights = np.tile(grid.weights, (n_nodes, 1, 1))
    caps = np.tile(grid.cap_levels, (n_nodes, 1))
    dem = np.asarray(demands, dtype=np.int64)[grid.entry_class]
    bounds = np.minimum(np.tile(grid.fit, (n_nodes, 1)), dem[None, :])
    return values, weights, bounds, caps


def phase_kernel_vs_plain(fleet_problem) -> list[dict]:
    rows = []
    for dtype in (np.float64, np.float32):
        for seed in range(8):
            rng = np.random.RandomState(seed)
            b_n, e_n, dim = (int(rng.randint(1, 5)), int(rng.randint(1, 6)),
                             int(rng.randint(1, 4)))
            v, w, b, c = random_pricing(rng, b_n, e_n, dim, dtype)
            steps = knapsack.pricing_steps(v, w, b, c)
            if steps.step_values.shape[1] == 0:
                continue
            rows.append(compare_on_card(
                steps, e_n, f"sweep seed={seed} {np.dtype(dtype).name}"))
    grids = {}
    for grid_states, label, variants in ((32_768, "main-path grid", (None, "global")),
                                         (131_072, "large grid", (None, "global")),
                                         (262_144, "grid past 16 slices", (None,))):
        v, w, b, c = fleet_pricing(fleet_problem, grid_states, n_nodes=6, seed=0)
        steps = knapsack.pricing_steps(v, w, b, c)
        grids[label] = steps.states
        for variant in variants:
            rows.append(compare_on_card(steps, v.shape[1], label, variant))
            r = rows[-1]
            log(f"  {r['label']} [{r['variant']}]: B={r['B']} T={r['T']} S={r['S']} "
                f"({r['S'] * 8} B of float64 per state row) exact")
    want = {"main-path grid": 30_940, "large grid": 120_384, "grid past 16 slices": 217_800}
    if grids != want:
        raise AssertionError(f"grid states {grids}, expected {want}")
    by_label = {(r["label"], r["variant"]) for r in rows}
    if not {("main-path grid", "cluster"), ("large grid", "cluster"),
            ("grid past 16 slices", "global")} <= by_label:
        raise AssertionError(f"phase 3 variants by grid: {sorted(by_label)}")
    return rows


# --------------------------------------------------------------- phase 4


class LaunchRecorder:
    """During the main path: CUDA events right around every kernel launch
    (the C function `knapsack._dispatch` calls), the inputs of the largest
    DP call on the card (by T*B*S), and each pricing call's wall time in
    parts, on the host's clock: `pricing_steps` (the binary split), the
    wait for the kernel and the copy of ``best`` and the mask of steps
    taken (`_fetch`, with a synchronize before the copy), and the counts
    from the mask (`PricingSteps.counts_from_taken`); the rest of the call
    is the copies to the card, the checks and the launch."""

    PARTS = ("split", "wait", "copy", "counts")

    def __init__(self):
        self.events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.largest = None
        self._size = -1
        self._dp = knapsack._dispatch
        self._kernel_fn = knapsack._kernel_fn
        self._saved = (knapsack.price_knapsacks, knapsack.pricing_steps, knapsack._fetch,
                       knapsack.PricingSteps.counts_from_taken)
        self.calls: list[float] = []
        self.parts = {k: 0.0 for k in self.PARTS}

    def _clocked(self, part, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.parts[part] += time.perf_counter() - t0
            return out
        return call

    def _fetch(self, best, taken):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = self._saved[2](best, taken)
        self.parts["wait"] += t1 - t0
        self.parts["copy"] += time.perf_counter() - t1
        return out

    def _price(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._saved[0](*args, **kwargs)
        self.calls.append(time.perf_counter() - t0)
        return out

    def _record_dp(self, step_values, step_weights, final_idx, levels):
        size = step_values.numel() * int(np.prod(levels))
        if step_values.device.type == "cuda" and size > self._size:
            self._size = size
            self.largest = (step_values.clone(), step_weights.clone(),
                            final_idx.clone(), tuple(levels))
        return self._dp(step_values, step_weights, final_idx, levels)

    def _timed_kernel_fn(self, dtype):
        fn = self._kernel_fn(dtype)

        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((start, end))
            return rc

        return launch

    def __enter__(self):
        knapsack._dispatch = self._record_dp
        knapsack._kernel_fn = self._timed_kernel_fn
        knapsack.price_knapsacks = self._price
        knapsack.pricing_steps = self._clocked("split", self._saved[1])
        knapsack._fetch = self._fetch
        knapsack.PricingSteps.counts_from_taken = self._clocked("counts", self._saved[3])
        return self

    def __exit__(self, *exc):
        knapsack._dispatch = self._dp
        knapsack._kernel_fn = self._kernel_fn
        (knapsack.price_knapsacks, knapsack.pricing_steps, knapsack._fetch,
         knapsack.PricingSteps.counts_from_taken) = self._saved

    def kernel_ms(self) -> float:
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in self.events))


def load_example(name: str) -> types.ModuleType:
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_quickstart() -> float:
    """`examples/torch_quickstart.py`'s `main` on the card: scenario 1
    under ST1-ST3, each plan validated and simulated to its target, and
    ST3's saving against ST1 held to the paper's 61% (it raises
    otherwise)."""
    out = load_example("torch_quickstart").main([])
    for strategy, cost in out["costs"].items():
        log(f"  scenario 1 {strategy}: ${cost:.3f}/h")
    log(f"  ST3 saves {out['savings']:.1%} vs ST1 (paper: 61%), "
        "by examples/torch_quickstart.py")
    return out["savings"]


def phase_main_path() -> dict:
    streams = camera_fleet(N_CAMERAS)
    table = paper_profile_table()
    manager = ResourceManager(paper_ec2_catalog(), table)  # default: the card
    if manager.device.type != "cuda":
        raise AssertionError(f"default manager device is {manager.device}")
    with LaunchRecorder() as rec:
        knapsack.LAUNCHES = 0
        for variant in knapsack.LAUNCHES_BY_VARIANT:
            knapsack.LAUNCHES_BY_VARIANT[variant] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = manager.allocate(streams, ST3)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = knapsack.LAUNCHES
        by_variant = dict(knapsack.LAUNCHES_BY_VARIANT)
    if launches == 0:
        raise AssertionError("the main path launched the knapsack kernel 0 times")
    if by_variant != {"cluster": launches, "global": 0} or len(rec.calls) < launches:
        raise AssertionError(f"main path: {launches} launches by variant {by_variant} in "
                             f"{len(rec.calls)} pricing calls")
    plan.solution.validate()
    sim = simulate_plan(plan, table, target=manager.utilization_cap)
    if not sim["meets_target"]:
        raise AssertionError("500-camera plan misses the performance target")
    kernel_ms = rec.kernel_ms()
    pricing_ms = sum(rec.calls) * 1e3
    parts_ms = {k: v * 1e3 for k, v in rec.parts.items()}
    log(f"  card plan: ${plan.hourly_cost:.3f}/h, {len(plan.instances)} instances, "
        f"optimal={plan.optimal}, {launches} kernel launches by variant {by_variant}")
    log(f"  allocate wall {wall_s:.3f} s; kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / 1e3 / wall_s:.4%} of it); host {wall_s - kernel_ms / 1e3:.3f} s")
    log(f"  pricing calls: {len(rec.calls)}, wall {pricing_ms:.3f} ms in all "
        f"({pricing_ms / 1e3 / wall_s:.3%} of the allocate): binary split "
        f"{parts_ms['split']:.3f} ms, wait for the kernel {parts_ms['wait']:.3f}, copy of best "
        f"and the steps taken {parts_ms['copy']:.3f}, counts {parts_ms['counts']:.3f}, rest "
        f"(copies to the card, checks, launch) "
        f"{pricing_ms - sum(parts_ms.values()):.3f}; kernel (events) {kernel_ms:.3f}")

    cpu_manager = ResourceManager(paper_ec2_catalog(), table, device="cpu")
    t0 = time.perf_counter()
    cpu_plan = cpu_manager.allocate(streams, ST3)
    cpu_s = time.perf_counter() - t0
    if knapsack.LAUNCHES != launches:
        raise AssertionError("the CPU allocate launched the kernel")
    a, b = plan_to_plain(plan), plan_to_plain(cpu_plan)
    for key in a:
        same = (np.array_equal(a[key], b[key]) if isinstance(a[key], np.ndarray)
                else a[key] == b[key])
        if not same:
            raise AssertionError(f"card and CPU plans differ in {key}")
    log(f"  CPU plan (device='cpu', same process, {cpu_s:.3f} s): identical")
    log(f"  reference (JAX package, numpy pricing, CPU): "
        f"${REFERENCE_500[0]:.3f}/h, {REFERENCE_500[1]} instances")
    largest = rec.largest
    b_n, t_n = largest[0].shape
    return {
        "cameras": N_CAMERAS,
        "hourly_cost": plan.hourly_cost,
        "instances": len(plan.instances),
        "optimal": plan.optimal,
        "launches": launches,
        "launches_by_variant": by_variant,
        "allocate_wall_s": wall_s,
        "kernel_ms": kernel_ms,
        "pricing_calls": len(rec.calls),
        "pricing_ms": pricing_ms,
        "pricing_parts_ms": parts_ms,
        "host_s": wall_s - kernel_ms / 1e3,
        "cpu_allocate_s": cpu_s,
        "largest_call": {"B": b_n, "T": t_n, "S": int(np.prod(largest[3]))},
        "_largest": largest,
        "_managers": (manager, cpu_manager),
    }


# --------------------------------------------------------------- phase 4b
#
# The trace builders below take the streams module they build events from
# (`st`), so that `scripts/torch_live_loop_goldens.py` replays the very
# same traces through the JAX package on a CPU to compute the goldens.

#: (a) the main path's churn: events after the 500-camera allocate, the
#: seed, and the events that reclaim the instance with the most streams
#: (a notice, then a preemption).  Those two displace a whole instance's
#: streams at once, the greedy repair's largest candidate matrices.
LIVE_EVENTS = 60
LIVE_SEED = 2020
LIVE_NOTICE_AT = 20
LIVE_PREEMPT_AT = 40
LIVE_GAP_H = 0.02
#: The controller's gap threshold for (a): wide, so that every event stays
#: on the warm path.  On this fleet colgen's budgeted duals certify a gap
#: near 0.5, and at the default 0.1 every event would fall back to a full
#: branch-and-price solve of some 70-90 s on a CPU.
LIVE_GAP_THRESHOLD = 10.0
LIVE_PRICES = {"c4.2xlarge": 0.419, "c4.8xlarge": 1.675, "g2.2xlarge": 0.650}
#: (b) `benchmarks/churn_replan.py`'s scenario, warm path only.
REPLAN_STREAMS = 500
REPLAN_EVENTS = 200
REPLAN_SEED = 1802
REPLAN_MAX_NODES = 20_000
#: (c) `benchmarks/lifecycle.py` experiment 3.
GROWTH_STREAMS = 500
GROWTH_EVENTS = 90
GROWTH_SEED = 2618
GROWTH_MAX_NODES = 20_000
GROWTH_GAP_THRESHOLD = 0.3
BOOT_H = 2.0 / 60.0
LOOKAHEAD_H = 0.15
MAX_SPARES = 3


def fleet_kinds(st) -> list:
    """The 10 camera kinds of `KINDS`, built from the streams module ``st``."""
    vgg, zf = st.AnalysisProgram("VGG-16", "vgg16"), st.AnalysisProgram("ZF", "zf")
    return [(vgg, f) for f in (0.05, 0.1, 0.15, 0.2, 0.25)] + [
        (zf, f) for f in (0.1, 0.2, 0.3, 0.4, 0.5)]


def largest_instance_uid(ctrl) -> int:
    """The uid of the live instance hosting the most streams (the lowest uid
    of equals)."""
    members = ctrl.placement_state().members
    uids = ctrl.instance_uids
    return uids[max(range(len(uids)), key=lambda b: (len(members[b]), -uids[b]))]


def live_event(st, ctrl, rng, i: int):
    """Event ``i`` of (a)'s trace, drawn against the live fleet of ``ctrl``:
    joins, leaves and rate changes over the 10 kinds, price moves of 5%,
    and at `LIVE_NOTICE_AT` / `LIVE_PREEMPT_AT` a reclamation notice and a
    preemption of the instance with the most streams."""
    at = (i + 1) * LIVE_GAP_H
    if i == LIVE_NOTICE_AT:
        return st.InstancePreemptionNotice(largest_instance_uid(ctrl), at=at,
                                           deadline=at + 2.5 / 60.0)
    if i == LIVE_PREEMPT_AT:
        return st.InstancePreempted(largest_instance_uid(ctrl), at=at)
    kinds = fleet_kinds(st)
    roll = rng.rand()
    if roll < 0.30:
        return st.StreamAdded(st.StreamSpec(f"live{i}", *kinds[rng.randint(10)]), at=at)
    if roll < 0.55:
        live = ctrl.fleet
        return st.StreamRemoved(live[rng.randint(len(live))].name, at=at)
    if roll < 0.90:
        live = ctrl.fleet
        s = live[rng.randint(len(live))]
        rates = [f for p, f in kinds if p.program_id == s.program.program_id]
        return st.StreamRateChanged(s.name, rates[rng.randint(len(rates))], at=at)
    name = sorted(LIVE_PRICES)[rng.randint(len(LIVE_PRICES))]
    return st.PriceChanged(name, round(LIVE_PRICES[name] * (1.0 + 0.05 * rng.randn()), 4),
                           at=at)


def replan_fleet(st) -> list:
    """`benchmarks/churn_replan.py`'s initial fleet: 500 streams, 5 kinds."""
    vgg, zf = st.AnalysisProgram("VGG-16", "vgg16"), st.AnalysisProgram("ZF", "zf")
    kinds = [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]
    return [st.StreamSpec(f"s{i}", *kinds[i % 5]) for i in range(REPLAN_STREAMS)], kinds


def replan_event(st, kinds, ctrl, rng, at: float):
    """`benchmarks/churn_replan.py`'s `_trace`: one event against the live
    fleet of ``ctrl``."""
    roll = rng.rand()
    if roll < 0.30:
        return st.StreamAdded(st.StreamSpec(f"j{rng.randint(10**9)}",
                                            *kinds[rng.randint(len(kinds))]), at=at)
    if roll < 0.55:
        live = ctrl.fleet
        return st.StreamRemoved(live[rng.randint(len(live))].name, at=at)
    if roll < 0.95:
        live = ctrl.fleet
        s = live[rng.randint(len(live))]
        rates = [f for p, f in kinds if p.program_id == s.program.program_id]
        return st.StreamRateChanged(s.name, rates[rng.randint(len(rates))], at=at)
    bt = ("c4.2xlarge", "c4.8xlarge", "g2.2xlarge")[rng.randint(3)]
    base = {"c4.2xlarge": 0.419, "c4.8xlarge": 1.675, "g2.2xlarge": 0.650}[bt]
    return st.PriceChanged(bt, round(base * (1.0 + 0.05 * rng.randn()), 4), at=at)


def growth_scenario(st):
    """`benchmarks/lifecycle.py` experiment 3's inputs: the consolidation
    benchmark's 500-stream fleet, the bursty growth trace and the oracle
    forecast of the joins within `LOOKAHEAD_H` (at most `MAX_SPARES`)."""
    vgg, zf = st.AnalysisProgram("VGG-16", "vgg16"), st.AnalysisProgram("ZF", "zf")
    kinds = [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]
    initial = [st.StreamSpec(f"s{i}", *kinds[i % 5]) for i in range(GROWTH_STREAMS)]
    trace = st.synthetic_timed_trace(
        initial, np.random.RandomState(GROWTH_SEED), n_events=GROWTH_EVENTS,
        mean_gap_hours=0.03, p_join=0.6, p_leave=0.15,
        make_join=lambda i: st.StreamSpec(f"g{i}", *kinds[i % 5]),
        rerate_fps=lambda s: [f for p, f in kinds if p.program_id == s.program.program_id],
        burst=3)
    adds = [(ev.at, ev.stream) for ev in trace if isinstance(ev, st.StreamAdded)]

    def forecast(fleet, event):
        now = event.at if event is not None else 0.0
        live = {s.name for s in fleet}
        upcoming = tuple(s for t, s in adds if now < t <= now + LOOKAHEAD_H
                         and s.name not in live)
        return st.StreamForecast(joins=upcoming[:MAX_SPARES])

    return initial, trace, forecast


def post_join_degraded(out: dict) -> float:
    """`benchmarks/lifecycle.py`'s degraded stream-seconds past the initial
    boot (which every policy pays once)."""
    return out["degraded_stream_seconds"] - out["timeline"][0]["boot_wait_stream_hours"] * 3600.0


def spares_provisioned(out: dict) -> int:
    return sum(a.startswith("autoscale:provision") for t in out["timeline"] for a in t["actions"])


def replay_digest(rows) -> str:
    """sha256 of per-event (cost, mode, migrated, gap) rows, floats in hex."""
    text = "\n".join(f"{float(c).hex()} {m} {n} {float(g).hex()}" for c, m, n, g in rows)
    return hashlib.sha256(text.encode()).hexdigest()


#: The live loop's kernels, by the name in the kernels line, and the
#: module whose `_dispatch` launches each.
LIVE_KERNELS = {"knapsack_dp": knapsack, "pack_scan": pack, "placement_scores": placement}
#: H100 SXM float64 peak outside the tensor cores (NVIDIA data sheet).
FP64_OPS_PER_S = 34e12


class LiveClock:
    """During phase 4b: CUDA events right around every launch of the live
    loop's kernels (each module's `_dispatch`, on CUDA tensors), the
    pack scan's inputs and outputs a launch (for the check against its
    plain version), and the greedy repair's placement-score inputs (each
    `heuristics.placement_scores` call, host arrays, whatever its route)."""

    def __init__(self):
        self.events = {name: [] for name in LIVE_KERNELS}
        self.pack_calls: list[tuple] = []
        self.placement_inputs: list[tuple] = []
        self._saved = {name: mod._dispatch for name, mod in LIVE_KERNELS.items()}
        self._scores = heuristics.placement_scores

    def _timed(self, name, fn):
        def call(*args):
            if args[0].device.type != "cuda":
                return fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.events[name].append((start, end))
            if name == "pack_scan":
                self.pack_calls.append((args, out))
            return out
        return call

    def _record_scores(self, req, choice_mask, resid, *, device=None):
        self.placement_inputs.append((np.array(req), np.array(choice_mask), np.array(resid)))
        return self._scores(req, choice_mask, resid, device=device)

    def __enter__(self):
        for name, mod in LIVE_KERNELS.items():
            mod._dispatch = self._timed(name, self._saved[name])
        heuristics.placement_scores = self._record_scores
        return self

    def __exit__(self, *exc):
        for name, mod in LIVE_KERNELS.items():
            mod._dispatch = self._saved[name]
        heuristics.placement_scores = self._scores

    def marks(self) -> dict:
        return {name: len(ev) for name, ev in self.events.items()}

    def ms_since(self, marks: dict) -> dict:
        """Kernel ms by kernel over the launches after ``marks``."""
        torch.cuda.synchronize()
        return {name: float(sum(a.elapsed_time(b) for a, b in ev[marks[name]:]))
                for name, ev in self.events.items()}


def reset_live_counts() -> None:
    """Every count of the live loop's kernels to 0: launches, launches by
    variant, placement calls by route."""
    for mod in LIVE_KERNELS.values():
        mod.LAUNCHES = 0
        for variant in getattr(mod, "LAUNCHES_BY_VARIANT", {}):
            mod.LAUNCHES_BY_VARIANT[variant] = 0
    for route in heuristics.PLACEMENT_ROUTES:
        heuristics.PLACEMENT_ROUTES[route] = 0


def live_counts() -> dict:
    out = {}
    for name, mod in LIVE_KERNELS.items():
        out[name] = {"launches": mod.LAUNCHES}
        if hasattr(mod, "LAUNCHES_BY_VARIANT"):
            out[name]["by_variant"] = dict(mod.LAUNCHES_BY_VARIANT)
    out["placement_routes"] = dict(heuristics.PLACEMENT_ROUTES)
    return out


def replay_events(ctrl, make_event, n_events, clock, label):
    """Apply ``n_events`` events from ``make_event(i)`` to ``ctrl``; per event
    the result, the wall ms (host clock, the card synchronised) and the
    kernel ms by kernel (events)."""
    rows, events = [], []
    for i in range(n_events):
        ev = make_event(i)
        marks = clock.marks()
        before = live_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ctrl.apply(ev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        after = live_counts()
        kernel_ms = clock.ms_since(marks)
        events.append(ev)
        rows.append({
            "event": type(ev).__name__, "mode": r.mode, "cost": r.plan.hourly_cost,
            "gap": r.gap, "migrated": len(r.migrated), "displaced": len(r.displaced),
            "wall_ms": wall_ms, "kernel_ms": sum(kernel_ms.values()),
            "kernel_ms_by_kernel": kernel_ms,
            "knapsack_by_variant": {
                v: after["knapsack_dp"]["by_variant"][v] - before["knapsack_dp"]["by_variant"][v]
                for v in knapsack.LAUNCHES_BY_VARIANT},
            "placement_routes": {
                k: after["placement_routes"][k] - before["placement_routes"][k]
                for k in heuristics.PLACEMENT_ROUTES},
            "_result": r,
        })
        if label:
            row = rows[-1]
            log(f"  {label} {i:3d} {row['event']:<24} {row['mode']:<5} ${row['cost']:.4f}/h "
                f"gap {row['gap']:.4f} migrated {row['migrated']:3d} knapsack "
                f"{row['knapsack_by_variant']} placement {row['placement_routes']} "
                f"wall {wall_ms:.1f} ms, kernels {row['kernel_ms']:.3f} ms")
    return rows, events


def warm_split(rows) -> dict:
    """Mean wall ms of the warm events, split into the kernels' time and the
    rest (host)."""
    warm = [r for r in rows if r["mode"] == "warm"]
    if not warm:
        return {"warm_events": 0}
    walls = [r["wall_ms"] for r in warm]
    wall = float(np.mean(walls))
    kern = float(np.mean([r["kernel_ms"] for r in warm]))
    return {"warm_events": len(warm), "wall_ms": wall, "kernel_ms": kern,
            "host_ms": wall - kern, "median_wall_ms": float(np.median(walls))}


def live_main_path(managers, clock) -> dict:
    """(a): the 500-camera allocate's controller folds `LIVE_EVENTS` events,
    on the card and again with ``device="cpu"``; both against
    `LIVE_GOLDEN`."""
    manager, cpu_manager = managers
    ctrl = manager.controller(ST3, gap_threshold=LIVE_GAP_THRESHOLD)
    rng = np.random.RandomState(LIVE_SEED)
    reset_live_counts()
    rows, events = replay_events(
        ctrl, lambda i: live_event(port_streams, ctrl, rng, i), LIVE_EVENTS, clock, "(a)")
    counts = live_counts()
    if counts["knapsack_dp"]["launches"] == 0:
        raise AssertionError("(a) launched the knapsack kernel 0 times")
    cpu_ctrl = cpu_manager.controller(ST3, gap_threshold=LIVE_GAP_THRESHOLD)
    t0 = time.perf_counter()
    cpu_rows = [replan_result_to_plain(cpu_ctrl.apply(ev)) for ev in events]
    cpu_s = time.perf_counter() - t0
    if any(live_counts()[name] != counts[name] for name in LIVE_KERNELS):
        raise AssertionError("(a) the CPU replay launched a kernel")
    for i, (row, cpu) in enumerate(zip(rows, cpu_rows)):
        if replan_result_to_plain(row["_result"]) != cpu:
            raise AssertionError(f"(a) event {i}: card and CPU differ: "
                                 f"{row['mode']} {row['cost']} vs {cpu['mode']} {cpu['cost']}")
        got = (row["event"], row["cost"], row["mode"], row["migrated"])
        if got != LIVE_GOLDEN[i]:
            raise AssertionError(f"(a) event {i}: {got} vs the reference's {LIVE_GOLDEN[i]}")
    split = warm_split(rows)
    log(f"  (a) {LIVE_EVENTS} events equal to the CPU replay ({cpu_s:.1f} s) and the "
        f"reference's; launches {counts}; warm event {split}")
    return {"events": [{k: v for k, v in r.items() if k != "_result"} for r in rows],
            "counts": counts, "warm": split, "cpu_replay_s": cpu_s}


def live_churn_replan(clock) -> dict:
    """(b): `benchmarks/churn_replan.py`'s replay on the card, warm path only
    (no cold samples); its digest against `REPLAN_GOLDEN`."""
    art = cal.CalibrationArtifact.load(ROOT / "CALIBRATION_ec2.json")
    manager = ResourceManager(paper_ec2_catalog(), calibration=art,
                              max_nodes=REPLAN_MAX_NODES)
    fleet, kinds = replan_fleet(port_streams)
    reset_live_counts()
    t0 = time.perf_counter()
    manager.allocate(fleet)
    reset_s = time.perf_counter() - t0
    ctrl = manager.controller()
    rng = np.random.RandomState(REPLAN_SEED)
    rows, _events = replay_events(
        ctrl, lambda i: replan_event(port_streams, kinds, ctrl, rng, (i + 1) * 0.02),
        REPLAN_EVENTS, clock, None)
    counts = live_counts()
    digest = replay_digest([(r["cost"], r["mode"], r["migrated"], r["gap"]) for r in rows])
    modes = {m: sum(r["mode"] == m for r in rows) for m in ("warm", "full", "noop")}
    if digest != REPLAN_GOLDEN["digest"] or modes != REPLAN_GOLDEN["modes"]:
        raise AssertionError(f"(b) digest {digest} modes {modes}, the reference's "
                             f"{REPLAN_GOLDEN}")
    split = warm_split(rows)
    log(f"  (b) {REPLAN_EVENTS} events, digest equal to the reference's, modes {modes}, "
        f"reset {reset_s:.2f} s; launches {counts}; warm event {split}")
    return {"digest": digest, "modes": modes, "reset_s": reset_s, "counts": counts,
            "warm": split, "final_cost": rows[-1]["cost"]}


def live_growth(clock) -> dict:
    """(c): `benchmarks/lifecycle.py` experiment 3 on the card; every
    what-if launches the pack scan; against `GROWTH_GOLDEN`."""
    initial, trace, forecast = growth_scenario(port_streams)
    manager = ResourceManager(paper_ec2_catalog(), paper_profile_table(),
                              max_nodes=GROWTH_MAX_NODES)
    manager.controller(gap_threshold=GROWTH_GAP_THRESHOLD)
    reset_live_counts()
    n_calls = len(clock.pack_calls)
    what_ifs = []
    inner = manager.controller().what_if

    def counted_what_if(fleets, **kw):
        what_ifs.append(len(fleets))
        return inner(fleets, **kw)

    manager.controller().what_if = counted_what_if
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = simulate_churn(
        manager, initial, trace, paper_profile_table(),
        policy=ActingAutoscaler(forecast=forecast, max_spares=MAX_SPARES),
        billing=BillingModel(boot_hours=BOOT_H, quantum_hours=1.0))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = live_counts()
    got = {"billed_cost": out["billed_cost"], "degraded_stream_seconds": post_join_degraded(out),
           "spares_provisioned": spares_provisioned(out)}
    if got != GROWTH_GOLDEN:
        raise AssertionError(f"(c) {got} vs the reference's {GROWTH_GOLDEN}")
    if counts["pack_scan"]["launches"] != len(what_ifs) or not what_ifs:
        raise AssertionError(f"(c) {len(what_ifs)} what-ifs, pack_scan launched "
                             f"{counts['pack_scan']}")
    log(f"  (c) {len(trace)} events in {wall_s:.1f} s: billed ${got['billed_cost']:.4f}, "
        f"degraded {got['degraded_stream_seconds']:.1f} stream-s, "
        f"{got['spares_provisioned']} spares, equal to the reference's; {len(what_ifs)} "
        f"what-ifs of {sorted(set(what_ifs))} fleets; launches {counts}")
    return {**got, "wall_s": wall_s, "counts": counts, "what_ifs": len(what_ifs),
            "pack_calls": (n_calls, len(clock.pack_calls))}


def check_pack_calls(calls) -> dict:
    """Every recorded pack-scan launch against `pack_scan_plain` on the card,
    on the same inputs, bit for bit."""
    for (args, (recs, n_open, total)) in calls:
        (p_recs, p_open, p_total) = pack.pack_scan_plain(*args[:6], best_fit=args[6])
        same = (all(torch.equal(a, b) for a, b in zip(recs, p_recs))
                and torch.equal(n_open, p_open) and torch.equal(total, p_total))
        if not same:
            raise AssertionError(f"pack_scan differs from its plain version at shape "
                                 f"{tuple(args[0].shape)}")
    shapes = sorted({tuple(a[0].shape) for a, _ in calls})
    log(f"  pack_scan: {len(calls)} launches equal to pack_scan_plain on the card, "
        f"bit for bit; shapes {shapes[:4]}{' ...' if len(shapes) > 4 else ''}")
    return {"checked": len(calls), "max_abs_err": 0.0}


def check_placement_inputs(inputs) -> dict:
    """Every recorded greedy-repair matrix through both routes (numpy and the
    kernel) and the plain version on the card, bit for bit, and one
    fleet-scale matrix above the threshold."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    k, c, p_n = 500, 2, 64
    big_req = rng.uniform(0.0, 2.0, size=(k, c, 4))
    big_mask = rng.rand(k, c) < 0.9
    big_req[~big_mask] = np.inf
    big = (big_req, big_mask, rng.uniform(0.0, 2.0, size=(p_n, 4)))
    if k * c * p_n < heuristics._CUDA_MIN_CANDIDATES:
        raise AssertionError("the fleet-scale matrix is below the threshold")
    before = placement.LAUNCHES
    sizes = []
    for req, mask, resid in list(inputs) + [big]:
        want = heuristics.placement_scores_np(req, mask, resid)
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (req, mask, resid)]
        got = placement._dispatch(*args).cpu().numpy()
        plain = placement.placement_scores_plain(*args).cpu().numpy()
        if not (np.array_equal(got, want) and np.array_equal(plain, want)):
            raise AssertionError(f"placement_scores differs at shape {want.shape}")
        sizes.append(want.size)
    placement.LAUNCHES = before  # comparison launches are not the path's
    log(f"  placement_scores: {len(sizes)} matrices ({min(sizes)}-{max(sizes)} candidates) "
        f"equal through numpy, the kernel and the plain version, bit for bit")
    launched = [x for x in inputs if x[0].shape[0] * x[0].shape[1] * x[2].shape[0]
                >= heuristics._CUDA_MIN_CANDIDATES]
    largest = max(launched, key=lambda x: x[0].size * x[2].shape[0]) if launched else big
    return {"checked": len(sizes), "max_abs_err": 0.0, "candidates": sizes, "_big": big,
            "_largest": largest}


def pack_bound(args, n_open_steps: int) -> dict:
    """The pack scan's least time: its inputs read once and its records
    written once over HBM; its operations (an add and a compare a
    dimension a candidate pair, best fit also a subtraction and a
    division), counted over the pairs this run's steps tried, over the
    float64 peak."""
    req, mask, score, order, caps, costs, best_fit = args
    b_n, n = order.shape
    bytes_moved = sum(t.numel() * t.element_size() for t in (req, mask, score, order, caps, costs))
    bytes_moved += 3 * b_n * n * 8 + b_n * 16
    ops = n_open_steps * req.shape[2] * req.shape[3] * (4 if best_fit else 2)
    out = _bound(bytes_moved, ops, FP64_OPS_PER_S)
    out["steps"] = n
    return out


def placement_timing(inputs) -> dict:
    """The placement kernel and its plain version on ``inputs`` (host
    arrays) on the card, beside the bound and beside an empty kernel of the
    same launch shape (`placement.empty_launch`: the call's floor)."""
    dev = torch.device("cuda")
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in inputs]
    ms = time_cold_ms(lambda: placement._dispatch(*targs), reps=20)
    empty_ms = time_cold_ms(lambda: placement.empty_launch(*targs), reps=20)
    plain_ms = time_cold_ms(lambda: placement.placement_scores_plain(*targs), reps=20)
    k, c, dim = inputs[0].shape
    p_n = inputs[2].shape[0]
    bytes_moved = sum(t.numel() * t.element_size() for t in targs) + k * c * p_n * 8
    bound = _bound(bytes_moved, k * c * p_n * dim * 4, FP64_OPS_PER_S)
    log(f"  placement_scores {ms:.5f} ms at {(k, c, p_n)} (plain {plain_ms:.4f} ms), "
        f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}), empty launch {empty_ms:.5f} ms "
        f"({ms / empty_ms:.2f}x)")
    return {"ms": ms, "plain_ms": plain_ms, **bound, "shape": [k, c, p_n], "empty_ms": empty_ms}


def pack_timing(pack_calls) -> dict:
    """The pack scan at the largest recorded launch: kernel, plain version,
    bound (timing launches are not the path's)."""
    args, (recs, _n_open, _total) = max(pack_calls, key=lambda c: c[0][0].numel())
    before = (pack.LAUNCHES, dict(pack.LAUNCHES_BY_VARIANT))
    bt_rec = recs[2]
    opened_before = (bt_rec >= 0).to(torch.int64).cumsum(dim=1) - (bt_rec >= 0).to(torch.int64)
    ms = time_cold_ms(lambda: pack._dispatch(*args), reps=10)
    empty_ms = time_cold_ms(lambda: pack.empty_walk(*args[:6], best_fit=args[6]), reps=10)
    plain_ms = time_cold_ms(lambda: pack.pack_scan_plain(*args[:6], best_fit=args[6]), reps=3)
    bound = pack_bound(args, int(opened_before.sum()))
    pack.LAUNCHES = before[0]
    pack.LAUNCHES_BY_VARIANT.update(before[1])
    b_n, n, c_n, dim = args[0].shape
    variant, fleets = pack.launch_shape(b_n, pack.fleets_that_fit(n, c_n, dim, args[4].shape[0]),
                                        torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"  pack_scan {variant} ({fleets} fleets a CTA) {ms:.4f} ms at B={b_n} n={n} C={c_n} "
        f"(plain {plain_ms:.3f} ms), bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; "
        f"{n} dependent steps, {ms / n * 1e3:.3f} us a step), empty walk {empty_ms:.4f} ms "
        f"({empty_ms / n * 1e3:.3f} us a step)")
    return {"ms": ms, "plain_ms": plain_ms, **bound, "B": b_n, "n": n, "C": c_n,
            "variant": variant, "fleets_per_cta": fleets, "us_per_step": ms / n * 1e3,
            "empty_walk_ms": empty_ms, "empty_walk_us_per_step": empty_ms / n * 1e3}


def phase_live_timing(pack_calls, largest, big) -> dict:
    """The pack scan at the largest recorded cone batch and the placement
    kernel at the largest matrix the replays launched it on (and at the
    fleet-scale matrix): kernel, plain version, bound."""
    before = placement.LAUNCHES
    out = {"pack_scan": pack_timing(pack_calls),
           "placement_scores": {**placement_timing(largest),
                                "fleet_scale": placement_timing(big)}}
    placement.LAUNCHES = before
    return out


def phase_live_loop(managers) -> dict:
    """Phase 4b: the live re-planning loop on the card — (a), (b), (c), then
    both new kernels timed and the placement kernel against its plain
    version, and the pack scan checked against its plain version last."""
    out = {}
    with LiveClock() as clock:
        out["main"] = live_main_path(managers, clock)
        out["churn_replan"] = live_churn_replan(clock)
        out["growth"] = live_growth(clock)
    placement_check = check_placement_inputs(clock.placement_inputs)
    big, largest = placement_check.pop("_big"), placement_check.pop("_largest")
    out["placement_check"] = {k: v for k, v in placement_check.items() if k != "candidates"}
    out["placement_candidates"] = {"max": max(placement_check["candidates"]),
                                   "threshold": heuristics._CUDA_MIN_CANDIDATES}
    out["timing"] = phase_live_timing(clock.pack_calls, largest, big)
    out["pack_check"] = check_pack_calls(clock.pack_calls)
    launches = {name: sum(out[part]["counts"][name]["launches"]
                          for part in ("main", "churn_replan", "growth"))
                for name in LIVE_KERNELS}
    for name in ("pack_scan", "placement_scores"):
        if launches[name] == 0:
            raise AssertionError(f"the live loop launched {name} 0 times")
    out["launches"] = launches
    return out


# --------------------------------------------------------------- phase 4c
#
# `benchmarks/shard.py`'s scenarios through the port's sharded controller.
# The builders and replays below take the package they run as a namespace
# (`port_package`), so that `scripts/torch_shard_goldens.py` runs the very
# same steps through the JAX package on a CPU to compute the goldens.

#: (a) and (b): the 100,000-stream fleet over 512 cells, 192 events.
SHARD_SEED = 7201
SHARD_STREAMS = 100_000
SHARD_CELLS = 512
SHARD_EVENTS = 192
SHARD_MAX_NODES = 400_000
SHARD_SUB_MAX_NODES = 5_000
#: Warm repair only, as the benchmark's replay: certification is a
#: calm-time activity at this scale, not a per-event one.
SHARD_GAP_THRESHOLD = 10.0
#: The rerun of the batched apply folds its cells on this many threads.
SHARD_WORKERS = 4
#: (c) the cost parity at 500 streams: the first `PARITY_EVENTS` events of
#: the benchmark's 48-event trace, so that the 8-cell replay's market runs
#: (after its 8th and 16th events).  A market round tries moves until 4
#: are kept, each a pair of exact cell solves: minutes of host time, so
#: the 8-cell replay runs in a process of its own from the start of phase
#: 2, and the flat and one-cell replays in another from the start of phase
#: 4c (`start_parity`), both joined at (c).
PARITY_STREAMS = 500
PARITY_TRACE_EVENTS = 48
PARITY_EVENTS = 16
PARITY_CELLS = 8
PARITY_REBALANCE_EVERY = 8
#: (d) a sharded `simulate_churn` on a spot catalog.
CHURN_STREAMS = 48
CHURN_EVENTS = 16
CHURN_SEED = 7203
CHURN_CELLS = 8
CHURN_REBALANCE_EVERY = 10
#: Rates each program can reach (VGG-16 saturates at 0.25 FPS).
SHARD_RATES = {"vgg16": [0.2, 0.25], "zf": [0.5, 2.0, 5.0]}


def port_package() -> types.SimpleNamespace:
    """The port's names the phase-4c replays use."""
    return types.SimpleNamespace(
        st=port_streams, ResourceManager=ResourceManager, ST3=ST3,
        ShardedController=shard.ShardedController, hash_cells=shard.hash_cells,
        FleetController=FleetController, ConsolidationPolicy=ConsolidationPolicy,
        paper_ec2_catalog=paper_ec2_catalog, paper_profile_table=paper_profile_table,
        with_spot_variants=with_spot_variants, simulate_churn=simulate_churn,
    )


def shard_fleet(st, n: int) -> list:
    """`benchmarks/shard.py`'s fleet: ``n`` streams over the consolidation
    benchmark's 5 kinds."""
    vgg, zf = st.AnalysisProgram("VGG-16", "vgg16"), st.AnalysisProgram("ZF", "zf")
    kinds = [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]
    return [st.StreamSpec(f"s{i}", *kinds[i % len(kinds)]) for i in range(n)]


def shard_events(st, rng, fleet, n_events: int) -> list:
    """`benchmarks/shard.py`'s `_events`: joins, leaves and re-rates with
    program-valid rates, 0.01 h apart."""
    vgg, zf = st.AnalysisProgram("VGG-16", "vgg16"), st.AnalysisProgram("ZF", "zf")
    kinds = [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]
    evs, t, nxt = [], 0.0, len(fleet)
    prog = {s.name: s.program.program_id for s in fleet}
    names = [s.name for s in fleet]
    for _ in range(n_events):
        t += 0.01
        roll = rng.rand()
        if roll < 0.3 or not names:
            kind = kinds[nxt % len(kinds)]
            name = f"j{nxt}"
            nxt += 1
            evs.append(st.StreamAdded(st.StreamSpec(name, *kind), at=t))
            names.append(name)
            prog[name] = kind[0].program_id
        elif roll < 0.55:
            name = names.pop(int(rng.rand() * len(names)))
            evs.append(st.StreamRemoved(name, at=t))
        else:
            name = names[int(rng.rand() * len(names))]
            rates = SHARD_RATES[prog[name]]
            evs.append(st.StreamRateChanged(name, rates[rng.randint(len(rates))], at=t))
    return evs


def shard_manager(pkg, max_nodes: int = SHARD_MAX_NODES):
    return pkg.ResourceManager(pkg.paper_ec2_catalog(), pkg.paper_profile_table(),
                               max_nodes=max_nodes)


def shard_twin(pkg, streams, workers: int = 0):
    """One controller of (a), cold-started by one batched pack."""
    sc = pkg.ShardedController(
        shard_manager(pkg), pkg.ST3, cell_key=pkg.hash_cells(SHARD_CELLS),
        sub_max_nodes=SHARD_SUB_MAX_NODES, gap_threshold=SHARD_GAP_THRESHOLD,
        batch_workers=workers)
    sc.reset(streams, at=0.0, pack="batched")
    return sc


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def floats_digest(values) -> str:
    """sha256 of the floats in hex: equal digests, equal bits."""
    return _sha(" ".join(float(v).hex() for v in values))


def plan_digest(plan) -> str:
    """sha256 of a plan's placements (stream, instance, type, device) and
    instance types, in the plan's order."""
    rows = [f"{p.stream.name} {p.instance_index} {p.instance_type} {p.device}"
            for p in plan.placements]
    return _sha("\n".join(rows) + "\n" + " ".join(plan.instances))


def shard_state(sc, horizon: float) -> dict:
    """The merged fleet's end state: placements and instances, uids, the
    billed cost at ``horizon``."""
    return {"plan": plan_digest(sc.plan), "uids": _sha(" ".join(map(str, sc.instance_uids))),
            "instances": len(sc.instance_uids), "billed": sc.lifecycle.billed_cost(horizon),
            "total_cost": sc.total_cost()}


def big_replay(pkg, tick, workers: bool = True) -> tuple[dict, object]:
    """(a): `benchmarks/shard.py`'s `_big_replay` — two twins cold-started by
    one batched pack each; the serial per-cell certification on one, the
    batched one (cold, then warm) on the other, then the serial one there
    too, so that both apply from the same prices; the 192 events through
    the serial loop on one and the batched pipeline on the other.  With
    ``workers``, a third twin, cold-started and certified serially as the
    first, folds them through the batched pipeline on `SHARD_WORKERS`
    threads (its cells are arc-flow priced, at most 5 item classes each,
    so the column pool the batched certification warms enters none of
    their pricing): ``workers_equal`` says whether it ends as the batched
    twin, event by event.  The reference's threaded fold is not run: its
    `formulate` cache evicts from several threads at once and raises at
    this scale.  ``tick(label)`` is called after each step (label None:
    the start).  Returns the plain outcome and the batched twin."""
    streams = shard_fleet(pkg.st, SHARD_STREAMS)
    events = shard_events(pkg.st, np.random.RandomState(SHARD_SEED), streams, SHARD_EVENTS)
    horizon = events[-1].at + 1.0
    tick(None)
    serial = shard_twin(pkg, streams)
    tick("reset")
    batched = shard_twin(pkg, streams)
    tick("reset_twin")
    if batched.n_cells != SHARD_CELLS or len(batched.fleet) != SHARD_STREAMS:
        raise AssertionError(f"{batched.n_cells} cells, {len(batched.fleet)} streams")
    lbs = {"serial": serial.refresh_prices(batched=False)}
    tick("certify_serial")
    lbs["batched_cold"] = batched.refresh_prices()
    tick("certify_batched_cold")
    lbs["batched"] = batched.refresh_prices()
    tick("certify_batched_warm")
    lbs["serial_twin"] = batched.refresh_prices(batched=False)
    tick("certify_serial_twin")
    certify_stats = {k: v for k, v in batched.stats().items() if k != "events_per_cell"}
    rows = []
    for ev in events:
        r = serial.apply(ev)
        rows.append((r.plan.hourly_cost, r.lower_bound))
    tick("apply_serial")
    rb = batched.apply_events(events)
    tick("apply_batched")
    rows_b = [(r.plan.hourly_cost, r.lower_bound) for r in rb]
    end, end_b = shard_state(serial, horizon), shard_state(batched, horizon)
    delta = max(abs(x - y) for a, b in zip(rows, rows_b) for x, y in zip(a, b))
    if end != end_b or len(rows) != len(rows_b):
        delta = float("inf")
    stats = batched.stats()
    out = {
        "cells": batched.n_cells,
        "lower_bounds": lbs,
        "certify_stats": certify_stats,
        "events": floats_digest(v for row in rows for v in row),
        "final_cost": rows[-1][0],
        "end": end,
        "delta": delta,
        "routed": stats["events_routed"],
        "barriers": stats["batch_barriers"],
        "seg_cache": (stats["seg_cache_hits"], stats["seg_cache_misses"]),
        "dispatches": (stats["batched_repair_dispatches"], stats["serial_repair_dispatches"]),
    }
    if workers:
        del serial
        threaded = shard_twin(pkg, streams, workers=SHARD_WORKERS)
        threaded.refresh_prices(batched=False)
        tick("workers_prepare")
        rw = threaded.apply_events(events)
        tick("apply_workers")
        out["workers_equal"] = ([(r.plan.hourly_cost, r.lower_bound) for r in rw] == rows
                                and shard_state(threaded, horizon) == end)
    return out, batched


def shard_repack(pkg, batched, tick) -> dict:
    """(b): the batched repair on the live cells of (a)'s batched twin (one
    pack launch over every cell)."""
    tick(None)
    r = batched.repack()
    tick("repack")
    return {"mode": r.mode, "actions": _sha("\n".join(r.actions)), "n_actions": len(r.actions),
            "migrated": len(r.migrated), "cost": r.plan.hourly_cost,
            "total_cost": batched.total_cost()}


def parity_trace(pkg) -> tuple[list, list]:
    """(c)'s fleet and its first `PARITY_EVENTS` events."""
    streams = shard_fleet(pkg.st, PARITY_STREAMS)
    events = shard_events(pkg.st, np.random.RandomState(SHARD_SEED + 2), streams,
                          PARITY_TRACE_EVENTS)[:PARITY_EVENTS]
    return streams, events


def parity_replay(ctrl, streams, events) -> list[float]:
    costs = [ctrl.reset(streams, at=0.0).plan.hourly_cost]
    costs += [ctrl.apply(ev).plan.hourly_cost for ev in events]
    return costs


def cells_parity(pkg, tick) -> list[float]:
    """(c)'s `PARITY_CELLS`-cell replay, the market every
    `PARITY_REBALANCE_EVERY` events: its per-step costs."""
    streams, events = parity_trace(pkg)
    tick(None)
    costs = parity_replay(pkg.ShardedController(
        shard_manager(pkg), pkg.ST3, cell_key=pkg.hash_cells(PARITY_CELLS),
        sub_max_nodes=SHARD_SUB_MAX_NODES, rebalance_every=PARITY_REBALANCE_EVERY),
        streams, events)
    tick("cells")
    return costs


def flat_parity(pkg, tick) -> list[list[float]]:
    """(c)'s flat and one-cell replays: their per-step costs."""
    streams, events = parity_trace(pkg)
    tick(None)
    flat = parity_replay(pkg.FleetController(shard_manager(pkg), pkg.ST3,
                                             sub_max_nodes=SHARD_SUB_MAX_NODES),
                         streams, events)
    tick("flat")
    one = parity_replay(pkg.ShardedController(shard_manager(pkg), pkg.ST3,
                                              sub_max_nodes=SHARD_SUB_MAX_NODES),
                        streams, events)
    tick("one_cell")
    return [flat, one]


#: (c)'s replays that `run_parity` runs in a process of their own, by name.
PARITY_PARTS = {"cells": cells_parity, "flat": flat_parity}


def cost_parity(pkg, tick, joins=None) -> dict:
    """(c): `benchmarks/shard.py`'s `_cost_parity` on its trace's first
    `PARITY_EVENTS` events: `flat_parity` (flat, one cell) and
    `cells_parity`; per-step costs.  ``joins``: where other processes run
    them (`start_parity`), ``{part: function}`` that waits for that part's
    process and returns its costs; else both run here."""
    flat, one = (flat_parity(pkg, tick) if joins is None else joins["flat"]())
    cells = cells_parity(pkg, tick) if joins is None else joins["cells"]()
    return {"flat": floats_digest(flat), "flat_final": flat[-1], "cells": floats_digest(cells),
            "cells_final": cells[-1], "one_cell_delta": max(abs(a - b) for a, b in zip(flat, one))}


def churn_digest(out: dict) -> str:
    """sha256 of a `simulate_churn` output dict (plain values only), every
    float by its repr (exact), keys sorted."""
    return _sha(json.dumps(out, sort_keys=True))


def sharded_churn(pkg, tick) -> dict:
    """(d): `simulate_churn` through the sharded path — `CHURN_CELLS` cells,
    a consolidation policy a cell, the batched reset and the market every
    `CHURN_REBALANCE_EVERY` events — on a spot catalog's seeded trace with
    preemption shocks and price drift."""
    catalog = pkg.with_spot_variants(pkg.paper_ec2_catalog(), price_ratio=0.35, hazard=0.4)
    manager = pkg.ResourceManager(catalog, pkg.paper_profile_table(), max_nodes=20_000)
    initial = shard_fleet(pkg.st, CHURN_STREAMS)
    trace = pkg.st.synthetic_timed_trace(
        initial, np.random.RandomState(CHURN_SEED), n_events=CHURN_EVENTS,
        preemption_hazard=0.4, hazard_pool=16, price_drift=0.3,
        price_drift_types=[("c4.2xlarge-spot", 0.147)], price_drift_gap_hours=0.1)
    tick(None)
    out = pkg.simulate_churn(
        manager, initial, trace, pkg.paper_profile_table(),
        cell_key=pkg.hash_cells(CHURN_CELLS),
        policy_factory=lambda: pkg.ConsolidationPolicy(max_migrations=2),
        rebalance_every=CHURN_REBALANCE_EVERY, reset_pack="batched")
    tick("simulate_churn")
    actions = [a for t in out["timeline"] for a in t["actions"]]
    return {"digest": churn_digest(out), "final_cost": out["final_cost"],
            "billed_cost": out["billed_cost"], "events": len(out["timeline"]) - 1,
            "rebalance_moves": sum(a.startswith("rebalance:") for a in actions)}


#: The goldens of (a)-(d), from `scripts/torch_shard_goldens.py` (the JAX
#: package on a CPU): its output, pasted.
SHARD_GOLDEN = {'cells': 512,
 'lower_bounds': {'serial': 13812.499999999987,
                  'batched_cold': 11894.242106268472,
                  'batched': 13811.283489623318,
                  'serial_twin': 13812.499999999987},
 'certify_stats': {'events_routed': 0,
                   'event_batches': 0,
                   'batch_barriers': 0,
                   'seg_cache_hits': 0,
                   'seg_cache_misses': 512,
                   'batched_repair_dispatches': 1,
                   'serial_repair_dispatches': 0,
                   'pricing_dispatches': 13,
                   'pricing_rounds': 13,
                   'serial_price_refreshes': 512},
 'events': 'd8ac8191ceefb89a1bfae29016852d23714e35e998d17ccc3fecbcb07ad27100',
 'final_cost': 16951.726999999984,
 'end': {'plan': '1398792b381e48a76ef2bdd7a1c4ceb69b6a38f5f0e668b3f1fb9270a753eeaf',
         'uids': '1b3b23658652c3703b99a3f23b77c074be0f8e3f67f2479bf27361697ba5c7d3',
         'instances': 29272,
         'billed': 49466.22244000003,
         'total_cost': 16951.727},
 'delta': 0.0,
 'routed': 192,
 'barriers': 0,
 'seg_cache': (38, 986),
 'dispatches': (1, 192)}
REPACK_GOLDEN = {'mode': 'warm',
 'actions': 'ceef3efb538fda955b485874600d17439cb37c5acf811067c8d94e704e9511f0',
 'n_actions': 72,
 'migrated': 5078,
 'cost': 16872.825999999994,
 'total_cost': 16872.826}
PARITY_GOLDEN = {'flat': '156b9d0f5e8b7a24ff538a9a7dfdf7a7b1d458093218ddd7519c6c62a5bfdb90',
 'flat_final': 69.55,
 'cells': 'e8cf29dea27a35f7e8826ff39ee233cc9e6757fc0551e3c8e1dc3f17225813e2',
 'cells_final': 70.388,
 'one_cell_delta': 0.0}
CHURN_GOLDEN = {'digest': '30194e3e7614b82666589530f074340d084572f45c5e2f4bdd7d4018a8133760',
 'final_cost': 2.73,
 'billed_cost': 2.8781420140692644,
 'events': 34,
 'rebalance_moves': 3}


class ShardClock(LiveClock):
    """`LiveClock` that also keeps each knapsack launch's inputs and outputs
    on the card, for the check against the plain version."""

    def __init__(self):
        super().__init__()
        self.knapsack_calls: list[tuple] = []

    def _timed(self, name, fn):
        call = super()._timed(name, fn)
        if name != "knapsack_dp":
            return call

        def record(*args):
            out = call(*args)
            if args[0].device.type == "cuda":
                self.knapsack_calls.append((args, out))
            return out

        return record


def card_tick(clock, steps: dict, part: str):
    """A `tick` for the replays on the card: per step, its wall seconds (the
    card synchronised at both ends), the kernels' ms by kernel (CUDA
    events around every launch), the rest (host), and the launches by
    kernel and variant."""
    state: dict = {}

    def launches() -> dict:
        counts = live_counts()
        out = {name: counts[name]["launches"] for name in LIVE_KERNELS}
        out.update({f"{name}.{v}": n for name in ("knapsack_dp", "pack_scan")
                    for v, n in counts[name]["by_variant"].items()})
        return out

    def tick(label):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if label is not None:
            kernel_ms = clock.ms_since(state["marks"])
            wall_s = now - state["t"]
            rose = {k: v - state["launches"][k] for k, v in launches().items()
                    if v != state["launches"][k]}
            steps[f"{part}.{label}"] = {
                "wall_s": wall_s, "kernel_ms": kernel_ms,
                "host_s": wall_s - sum(kernel_ms.values()) / 1e3, "launches": rose}
            log(f"  ({part}) {label}: wall {wall_s:.3f} s, kernels "
                f"{ {k: round(v, 3) for k, v in kernel_ms.items() if v} } ms, "
                f"launches {rose}")
        state.update(t=time.perf_counter(), marks=clock.marks(), launches=launches())

    return tick


def check_golden(label: str, got: dict, want: dict) -> None:
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)}
        raise AssertionError(f"{label} differs from the reference's golden: {diff}")


def check_knapsack_calls(calls) -> dict:
    """Every recorded knapsack launch against `knapsack_dp_plain` on the
    card, on the same inputs: ``best`` and the packed take words, bit for
    bit."""
    for args, (best, take, _taken) in calls:
        best_p, take_p = knapsack.knapsack_dp_plain(*args)
        if not (torch.equal(best, best_p) and torch.equal(take, take_p)):
            raise AssertionError(f"knapsack_dp differs from its plain version at "
                                 f"B={args[0].shape[0]} T={args[0].shape[1]}")
    shapes = sorted({(a[0].shape[0], a[0].shape[1], int(np.prod(a[3]))) for a, _ in calls})
    log(f"  knapsack_dp: {len(calls)} launches equal to knapsack_dp_plain on the card, bit "
        f"for bit; (B, T, S) from {shapes[0]} to {shapes[-1]}")
    return {"checked": len(calls), "max_abs_err": 0.0}


def knapsack_bound(args) -> dict:
    """The knapsack DP's least time: its steps, weights and final states
    read once, the take bits (one a state), ``best`` and the mask of steps
    taken written once; the fit compares, one add and one compare a state
    a step over the float32 peak."""
    step_values, _w, _f, levels = args
    b_n, t_n = step_values.shape
    s_n, d_n, item = int(np.prod(levels)), len(levels), step_values.element_size()
    inputs = b_n * t_n * (item + 8 * d_n) + b_n * 8 + 2 * d_n * 8
    bits_moved = inputs + t_n * b_n * -(-s_n // 32) * 4 + b_n * item + b_n * t_n
    return _bound(bits_moved, t_n * b_n * s_n * (d_n + 2), SIMT_OPS_PER_S)


def phase_shard_timing(pack_calls, knapsack_calls) -> dict:
    """The pack scan at (a)'s B = 512 launch and the knapsack DP at the
    batched certification's largest launch: kernel, plain version, bound."""
    pack_scan = pack_timing(pack_calls)
    before = (knapsack.LAUNCHES, dict(knapsack.LAUNCHES_BY_VARIANT))
    kargs, _out = max(knapsack_calls, key=lambda c: c[0][0].numel())
    k_ms = time_cold_ms(lambda: knapsack._dispatch(*kargs), reps=10)
    k_plain_ms = time_cold_ms(lambda: knapsack.knapsack_dp_plain(*kargs), reps=3)
    k_bound = knapsack_bound(kargs)
    kb, kt = kargs[0].shape
    ks = int(np.prod(kargs[3]))
    k_variant = knapsack._variant(ks)
    index = torch.cuda.current_device()
    ctas = (knapsack._cluster_size(kb, ks, knapsack.sm_count(index))
            if k_variant == "cluster" else 1)
    log(f"  knapsack_dp {k_variant} ({ctas} CTA a knapsack) {k_ms:.4f} ms at B={kb} T={kt} "
        f"S={ks} (plain {k_plain_ms:.3f} ms), bound {k_bound['bound_ms']:.5f} ms "
        f"({k_bound['bound_by']})")
    knapsack.LAUNCHES = before[0]
    knapsack.LAUNCHES_BY_VARIANT.update(before[1])
    return {
        "pack_scan": pack_scan,
        "knapsack_dp": {"ms": k_ms, "plain_ms": k_plain_ms, **k_bound, "B": kb, "T": kt,
                        "S": ks, "variant": k_variant, "ctas_per_knapsack": ctas},
    }


def shard_kernel_entry(sharded: dict, name: str) -> dict:
    """A kernel's phase-4c numbers for the kernels line: its launches by
    part, and, for the pack scan and the knapsack DP, its time at the
    phase's largest launch beside its plain version and bound."""
    entry = {"launches": sharded["launches"][name],
             "launches_by_part": {part: sharded[part]["counts"][name]["launches"]
                                  for part in "abcd"}}
    entry.update(sharded["timing"].get(name, {}))
    if name == "knapsack_dp":
        steps = sharded["steps"]
        entry["certify"] = {
            label: {"wall_s": steps[f"a.{label}"]["wall_s"],
                    "kernel_ms": steps[f"a.{label}"]["kernel_ms"]["knapsack_dp"],
                    "launches": steps[f"a.{label}"]["launches"].get("knapsack_dp", 0)}
            for label in ("certify_batched_cold", "certify_batched_warm")}
        entry["certify"]["rounds"] = sharded["a"]["certify_stats"]["pricing_rounds"]
    return entry


#: Each of (c)'s processes must end within this many seconds of its start.
PARITY_TIMEOUT_S = 900


def start_parity(part: str, workdir: pathlib.Path) -> tuple[subprocess.Popen, float]:
    """(c)'s replay ``part`` of `PARITY_PARTS` in a process of its own (this
    script with ``--parity``), so that its host work runs beside this
    process's; its outcome and its log go to ``workdir``.  Returns the
    process and its start time."""
    with open(workdir / f"{part}_parity.log", "w") as out:
        return subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--parity", part,
             str(workdir / f"{part}_parity.json")],
            stdout=out, stderr=subprocess.STDOUT, cwd=ROOT), time.perf_counter()


def finish_parity(part: str, started, workdir: pathlib.Path) -> dict:
    """Wait for `start_parity`'s process of ``part`` (killed past
    `PARITY_TIMEOUT_S`), log its lines and return its outcome."""
    proc, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, PARITY_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed past its time limit"
    for line in (workdir / f"{part}_parity.log").read_text().splitlines():
        log(f"  [{part}] {line}")
    if rc != 0:
        raise AssertionError(f"(c) the {part} replay's process: exit {rc}")
    return json.loads((workdir / f"{part}_parity.json").read_text())


def run_parity(part: str, path: str) -> int:
    """``--parity PART PATH``: (c)'s replay ``part`` of `PARITY_PARTS` on the
    card, the live loop's kernel counts set to 0 just before it and read
    just after, every kernel launch of it against its plain version; the
    outcome to PATH."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)  # host work beside the main process's
    steps: dict = {}
    with ShardClock() as clock:
        reset_live_counts()
        costs = PARITY_PARTS[part](port_package(), card_tick(clock, steps, "c"))
        counts = live_counts()
    out = {"costs": costs, "steps": steps, "counts": counts,
           "knapsack_check": (check_knapsack_calls(clock.knapsack_calls)
                              if clock.knapsack_calls else {"checked": 0, "max_abs_err": 0.0}),
           "pack_check": (check_pack_calls(clock.pack_calls)
                          if clock.pack_calls else {"checked": 0, "max_abs_err": 0.0})}
    pathlib.Path(path).write_text(json.dumps(out))
    return 0


def add_counts(a: dict, b: dict) -> dict:
    """Two `live_counts` added, key by key."""
    return {k: add_counts(v, b[k]) if isinstance(v, dict) else v + b[k] for k, v in a.items()}


def sharded_parts(pkg, out: dict, parity: dict, workdir: pathlib.Path) -> "ShardClock":
    """Phase 4c's parts, (a), (b), (d), (c), into ``out``; (c)'s replays
    are `start_parity`'s processes ``parity`` (``{part: (process, start
    time)}``), joined last.  Returns the clock with the launches made in
    this process."""
    with ShardClock() as clock:
        reset_live_counts()
        big, batched = big_replay(pkg, card_tick(clock, out["steps"], "a"))
        out["a"] = {**big, "counts": live_counts()}
        log(f"  (a) {big['cells']} cells: lower bounds {big['lower_bounds']}, final "
            f"${big['final_cost']:.4f}/h, delta {big['delta']}, workers equal "
            f"{big['workers_equal']}; routed {big['routed']}, barriers {big['barriers']}, "
            f"segment cache {big['seg_cache']}, repair dispatches {big['dispatches']}; "
            f"pricing {big['certify_stats']['pricing_dispatches']} dispatches in "
            f"{big['certify_stats']['pricing_rounds']} rounds")
        check_golden("(a)", {k: v for k, v in big.items() if k != "workers_equal"},
                     SHARD_GOLDEN)
        if not big["workers_equal"]:
            raise AssertionError(f"(a) the fold on {SHARD_WORKERS} threads differs")
        reset_live_counts()
        rep = shard_repack(pkg, batched, card_tick(clock, out["steps"], "b"))
        out["b"] = {**rep, "counts": live_counts()}
        log(f"  (b) repack: {rep}")
        check_golden("(b)", rep, REPACK_GOLDEN)
        del batched
        reset_live_counts()
        churn = sharded_churn(pkg, card_tick(clock, out["steps"], "d"))
        out["d"] = {**churn, "counts": live_counts()}
        log(f"  (d) {churn}")
        check_golden("(d)", churn, CHURN_GOLDEN)
        joined: dict = {}

        def join(part):
            def wait():
                joined[part] = finish_parity(part, parity[part], workdir)
                return joined[part]["costs"]
            return wait

        costs = cost_parity(pkg, None, joins={part: join(part) for part in PARITY_PARTS})
        out["c"] = {**costs, "counts": add_counts(*(r["counts"] for r in joined.values()))}
        for r in joined.values():
            out["steps"].update(r["steps"])
        out["c_checks"] = {kind: {"checked": sum(r[f"{kind}_check"]["checked"]
                                                 for r in joined.values()),
                                  "max_abs_err": max(r[f"{kind}_check"]["max_abs_err"]
                                                     for r in joined.values())}
                           for kind in ("knapsack", "pack")}
        log(f"  (c) flat ${costs['flat_final']:.4f}/h, {PARITY_CELLS} cells "
            f"${costs['cells_final']:.4f}/h, one cell delta {costs['one_cell_delta']}")
        check_golden("(c)", costs, PARITY_GOLDEN)
    return clock


def phase_sharded(parity: dict, workdir: pathlib.Path) -> dict:
    """Phase 4c: the sharded controller on the card — (a) the 100k replay,
    (b) the batched repair, (c) the cost parity (its replays are
    `start_parity`'s processes ``parity``, writing to ``workdir``), (d) a
    sharded churn replay, each with the live loop's kernel counts set to 0
    just before it and read just after, each against the reference's
    goldens; then every pack and knapsack launch of the phase against its
    plain version on the card ((c)'s, in their processes), and both timed
    at the phase's largest launch."""
    pkg = port_package()
    out: dict = {"steps": {}}
    clock = sharded_parts(pkg, out, parity, workdir)
    for part in ("a", "b"):
        if out[part]["counts"]["pack_scan"]["launches"] == 0:
            raise AssertionError(f"({part}) launched pack_scan 0 times")
    if out["a"]["counts"]["knapsack_dp"]["launches"] == 0:
        raise AssertionError("(a) launched knapsack_dp 0 times")
    out["pack_check"] = check_pack_calls(clock.pack_calls)
    out["knapsack_check"] = check_knapsack_calls(clock.knapsack_calls)
    for kind in ("pack", "knapsack"):  # and the 8-cell replay's, checked in its process
        out[f"{kind}_check"]["checked"] += out["c_checks"][kind]["checked"]
    out["timing"] = phase_shard_timing(clock.pack_calls, clock.knapsack_calls)
    out["launches"] = {name: sum(out[part]["counts"][name]["launches"] for part in "abcd")
                       for name in LIVE_KERNELS}
    return out


# --------------------------------------------------------------- phase 5


def phase_timing(largest) -> dict:
    step_values, step_weights, final_idx, levels = largest
    b_n, t_n = step_values.shape
    s_n = int(np.prod(levels))
    d_n = len(levels)
    variant = knapsack._variant(s_n)
    before = knapsack.LAUNCHES, dict(knapsack.LAUNCHES_BY_VARIANT)
    # `_dispatch` launches the kernel without `knapsack_dp`'s checks, whose
    # device-to-host sync would land between the timed launches.
    # Cold, as the other kernels: the card spins while the host queues a
    # call, whose dispatch (allocations, two launches) would otherwise
    # outlast the kernel.
    ms = time_cold_ms(lambda: knapsack._dispatch(*largest), reps=20)
    with forced_knapsack("global"):
        global_ms = time_cold_ms(lambda: knapsack._dispatch(*largest), reps=20)
    plain_ms = time_cold_ms(lambda: knapsack.knapsack_dp_plain(*largest), reps=5)
    # Timing launches are not the main path's.
    knapsack.LAUNCHES = before[0]
    knapsack.LAUNCHES_BY_VARIANT.update(before[1])
    item = step_values.element_size()
    inputs = b_n * t_n * (item + 8 * d_n) + b_n * 8 + 2 * d_n * 8
    # The first port's bound counted take at one byte a state; it needs one bit.
    bytes_moved = inputs + t_n * b_n * s_n + b_n * item  # take + best
    bits_bound = knapsack_bound(largest)
    bits_moved, ops = bits_bound["bytes"], bits_bound["ops"]
    ops_ms = ops / SIMT_OPS_PER_S * 1e3
    bound = _bound(bytes_moved, ops, SIMT_OPS_PER_S)
    log(f"  {variant} {ms:.4f} ms, global {global_ms:.4f} ms, plain {plain_ms:.4f} ms at "
        f"B={b_n} T={t_n} S={s_n}; bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}, "
        f"take a byte a state), {bits_bound['bound_ms']:.5f} ms ({bits_bound['bound_by']}, "
        f"take a bit a state); operations alone {ops_ms:.5f} ms")
    return {
        "variant": variant, "ms": ms, "global_ms": global_ms, "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "bound_bits_ms": bits_bound["bound_ms"], "bound_bits_by": bits_bound["bound_by"],
        "bytes": bytes_moved, "bytes_take_bits": bits_moved, "ops": ops,
        "B": b_n, "T": t_n, "S": s_n,
    }


# --------------------------------------------------------------- phase 5b


def time_frames_ms(fn, frame, reps: int = 25, warmup: int = 3) -> list[float]:
    """ms of each of ``reps`` warm calls ``fn(frame)`` (CUDA events around
    each; the frame's copy to the card included)."""
    for _ in range(warmup):
        fn(frame)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(frame)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def phase_analysis_programs() -> dict:
    """VGG-16 and ZF at full width on a 640x480 frame, one frame a call, on
    the card against the CPU; ms per frame beside the bound."""
    frame = analysis_programs.make_frame(PROGRAM_FRAME)
    out = {}
    for pid, run in analysis_programs.PROGRAMS.items():
        got = run(frame)  # default: the card
        if got.device.type != "cuda":
            raise AssertionError(f"{pid}: ran on {got.device}")
        want = run(frame, device="cpu")
        got = got.cpu()
        if got.shape != (1, 105) or not torch.isfinite(got).all():
            raise AssertionError(f"{pid}: logits {tuple(got.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not scale > 0 or err > PROGRAM_RTOL * scale:
            raise AssertionError(f"{pid}: card vs CPU {err:.3g} > {PROGRAM_RTOL} x {scale:.3g}")
        times = time_frames_ms(run, frame)
        flops = analysis_programs.program_flops(pid, PROGRAM_FRAME)
        weight_bytes = 4.0 * analysis_programs.program_params(pid)
        bound = _bound(weight_bytes, flops, SIMT_OPS_PER_S)
        ms = float(np.median(times))
        log(f"  {pid}: card vs CPU max |err| {err:.3g} (largest logit {scale:.4g}); "
            f"{ms:.4f} ms a frame (median of {len(times)}, {min(times):.4f}-{max(times):.4f}); "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: {flops:.4g} FLOPs, "
            f"{weight_bytes:.4g} weight bytes)")
        out[pid] = {"max_abs_err": err, "largest_logit": scale, "ms": ms,
                    "min_ms": min(times), "max_ms": max(times), "calls": len(times),
                    "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                    "flops": flops, "weight_bytes": weight_bytes}
    return out


def phase_calibration() -> dict:
    """``impl="torch"`` on the card against ``impl="numpy"`` bit for bit
    (quantized and raw, on the presets and 256 random workloads each), and
    the numpy artifacts against the committed ``CALIBRATION_*.json``."""
    out = {}
    for name, preset in sorted(cal.PRESETS.items()):
        kwargs = dict(cpu=preset.cpu, roofline=preset.roofline,
                      host_cores_fraction=preset.host_cores_fraction)
        catalog = preset.catalog_fn()
        np_art = cal.calibrate(catalog, preset.workloads_fn(), impl="numpy", **kwargs)
        if cal.CalibrationArtifact.load(cal.default_artifact_path(name)) != np_art:
            raise AssertionError(f"CALIBRATION_{name}.json differs from a fresh calibration")
        caps = cal._max_caps((bt.name, tuple(float(c) for c in bt.capacity)) for bt in catalog)
        rng = np.random.RandomState(len(name))
        randoms = tuple(
            cal.ProgramWorkload(f"w{i}", float(10.0 ** rng.uniform(3, 16)),
                                float(10.0 ** rng.uniform(3, 16)),
                                float(rng.uniform(1e-3, max(caps[1], caps[3]))))
            for i in range(256))
        quant = cal._quant
        t_card = []
        try:
            for raw in (False, True):
                cal._quant = float if raw else quant
                for label, workloads in (("preset", preset.workloads_fn()),
                                         ("random", randoms)):
                    want = cal.calibrate(catalog, workloads, impl="numpy", **kwargs)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = cal.calibrate(catalog, workloads, impl="torch", **kwargs)
                    t_card.append(time.perf_counter() - t0)
                    if got.entries != want.entries:
                        raise AssertionError(f"calibration {name} {label} raw={raw}: "
                                             "torch on the card differs from numpy")
        finally:
            cal._quant = quant
        log(f"  {name}: CALIBRATION_{name}.json fresh; impl='torch' on the card equals "
            f"numpy bit for bit ({len(np_art.entries)} preset entries, "
            f"{len(randoms)} random workloads; quantized and raw); "
            f"{min(t_card) * 1e3:.3f}-{max(t_card) * 1e3:.3f} ms a calibration")
        out[name] = {"entries": len(np_art.entries), "random_workloads": len(randoms),
                     "torch_ms": [t * 1e3 for t in t_card]}
    return out


def calibrated_streams(name: str) -> list[StreamSpec]:
    if name == "ec2":
        vgg, zf = AnalysisProgram("vgg16", "vgg16"), AnalysisProgram("zf", "zf")
        return ([StreamSpec(f"v{i}", vgg, 0.2) for i in range(20)]
                + [StreamSpec(f"z{i}", zf, 5.0) for i in range(20)])
    return [StreamSpec(f"{pid[:5]}{i}", AnalysisProgram(pid, pid), fps)
            for pid, fps, n in CALIBRATED_MIX for i in range(n)]


def phase_calibrated_allocations() -> dict:
    """The two calibrated scenarios through branch-and-price on the card:
    knapsack launches counted, plans equal to the CPU's and the
    reference's."""
    out = {}
    for name, catalog_fn in (("ec2", paper_ec2_catalog), ("tpu", tpu_cloud_catalog)):
        art = cal.load_or_calibrate(name)
        streams = calibrated_streams(name)
        for s in streams:
            art.check_stream(s)
        manager = ResourceManager(catalog_fn(), calibration=art, solver="colgen")
        if manager.device.type != "cuda":
            raise AssertionError(f"default manager device is {manager.device}")
        with LaunchRecorder() as rec:
            knapsack.LAUNCHES = 0
            for variant in knapsack.LAUNCHES_BY_VARIANT:
                knapsack.LAUNCHES_BY_VARIANT[variant] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = manager.allocate(streams)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = knapsack.LAUNCHES
            by_variant = dict(knapsack.LAUNCHES_BY_VARIANT)
        if launches == 0:
            raise AssertionError(f"calibrated {name}: the knapsack kernel launched 0 times")
        plan.solution.validate()
        kernel_ms = rec.kernel_ms()
        cpu_plan = ResourceManager(catalog_fn(), calibration=art, solver="colgen",
                                   device="cpu").allocate(streams)
        if knapsack.LAUNCHES != launches:
            raise AssertionError("the CPU allocate launched the kernel")
        a, b = plan_to_plain(plan), plan_to_plain(cpu_plan)
        for key in a:
            same = (np.array_equal(a[key], b[key]) if isinstance(a[key], np.ndarray)
                    else a[key] == b[key])
            if not same:
                raise AssertionError(f"calibrated {name}: card and CPU plans differ in {key}")
        cost, counts, optimal = REFERENCE_CALIBRATED[name]
        if (abs(plan.hourly_cost - cost) > 1e-9 or plan.instance_counts() != counts
                or plan.optimal != optimal):
            raise AssertionError(
                f"calibrated {name}: ${plan.hourly_cost:.3f}/h {plan.instance_counts()} "
                f"optimal={plan.optimal}, reference ${cost:.3f}/h {counts} optimal={optimal}")
        split = {}
        for p in plan.placements:
            split[p.device] = split.get(p.device, 0) + 1
        log(f"  {name} ({len(streams)} streams): ${plan.hourly_cost:.3f}/h "
            f"{plan.instance_counts()} optimal={plan.optimal}, split {split}; identical to "
            f"the CPU's plan and to the reference's; allocate wall {wall_s:.3f} s, "
            f"kernel {kernel_ms:.3f} ms, {launches} launches by variant {by_variant} in "
            f"{len(rec.calls)} pricing calls ({sum(rec.calls) * 1e3:.3f} ms)")
        out[name] = {"streams": len(streams), "hourly_cost": plan.hourly_cost,
                     "instances": plan.instance_counts(), "optimal": plan.optimal,
                     "split": split, "allocate_wall_s": wall_s, "kernel_ms": kernel_ms,
                     "launches": launches, "launches_by_variant": by_variant,
                     "pricing_calls": len(rec.calls), "pricing_ms": sum(rec.calls) * 1e3}
    return out


def phase_measured_calibration() -> dict:
    """``cpu_mode="measured"`` on the ec2 preset: real wall-clock test runs
    of VGG-16 and ZF on this machine's CPU (logged, not gated on values)."""
    preset = cal.PRESETS["ec2"]
    t0 = time.perf_counter()
    art = cal.calibrate(preset.catalog_fn(), preset.workloads_fn(), cpu=preset.cpu,
                        roofline=preset.roofline, cpu_mode="measured",
                        host_cores_fraction=preset.host_cores_fraction)
    seconds = time.perf_counter() - t0
    out = {}
    for e in art.entries:
        if e.device == "cpu":
            if e.source != "measured" or not (e.requirement[0] > 0 and e.max_fps > 0):
                raise AssertionError(f"measured {e.program_id}: source {e.source}, "
                                     f"requirement {e.requirement}, max {e.max_fps}")
        log(f"  {e.program_id} {e.device}: {list(e.requirement)} max {e.max_fps} fps "
            f"({e.source})")
        out[f"{e.program_id}/{e.device}"] = {"requirement": list(e.requirement),
                                             "max_fps": e.max_fps, "source": e.source}
    if {k for k, v in out.items() if v["source"] == "measured"} != {"vgg16/cpu", "zf/cpu"}:
        raise AssertionError(f"measured mode: sources {out}")
    log(f"  measured calibration took {seconds:.2f} s")
    return {"entries": out, "seconds": seconds}


# --------------------------------------------------------------- phase 6


def _normal(rng, shape, dtype) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", dtype)


def ring_positions(cache_len: int, cur: int) -> np.ndarray:
    """The ``pos`` buffer decode leaves after writing positions ``0..cur``
    to slot ``p % cache_len``: each slot holds its latest position."""
    slots = np.arange(cache_len)
    last = cur - (cur - slots) % cache_len
    return np.where(last >= 0, last, -1).astype(np.int32)


#: (label, B, S, H, KV, D, window, softcap)
FLASH_CASES = [
    ("gemma2-2b layer", 4, 2048, 8, 4, 256, None, 50.0),
    ("gemma2-2b, window binds", 1, 8192, 8, 4, 256, 4096, 50.0),
    ("internlm2-1.8b layer", 4, 512, 16, 8, 128, None, None),
    ("recurrentgemma-9b layer", 4, 1024, 16, 1, 256, 2048, None),
    ("ragged S=77", 2, 77, 4, 2, 64, None, 30.0),
    ("ragged S=2047, window 100", 1, 2047, 4, 1, 64, 100, None),
    ("ragged S=1000, window 300 binds, D=128", 2, 1000, 8, 2, 128, 300, None),
    ("ragged S=333, window 100 binds, D=256", 2, 333, 8, 4, 256, 100, 50.0),
]
#: The exact case's head_dims (S = D).
FLASH_EXACT_DIMS = (64, 128, 256)
#: (label, B, KV, R, D, L, cur, window, softcap, ring)
DECODE_CASES = [
    ("gemma2-2b cache", 4, 4, 2, 256, 2064, 2060, None, 50.0, False),
    ("wrapped ring", 4, 4, 2, 256, 4096, 6000, 4096, 50.0, True),
    ("internlm2-1.8b cache", 4, 8, 2, 128, 528, 520, None, None, False),
    ("recurrentgemma-9b cache", 4, 1, 16, 256, 1040, 1030, 2048, None, False),
    ("qwen3-moe-30b-a3b cache", 4, 4, 8, 128, 1040, 1030, None, None, False),
    ("ragged L=77", 3, 2, 4, 64, 77, 70, 32, None, False),
    ("R=20, two row groups, window binds", 2, 2, 20, 128, 300, 290, 100, 50.0, False),
    ("no valid slot: the mean of v", 2, 2, 4, 256, 700, -1, None, None, False),
]
#: decode_attention's lse against the plain version's: (atol, rtol).
DECODE_LSE_TOL = (2e-5, 0.0)
#: The decode exact case's head_dims and query heads a KV group.
DECODE_EXACT = ((64, 2), (128, 8), (256, 16), (128, 20))
#: (label, B, S, H, P, N, chunk, with h0)
SSD_CASES = [
    ("mamba2-1.3b prefill", 4, 1024, 64, 64, 128, 128, True),
    ("mamba2-1.3b prefill, no h0", 4, 1024, 64, 64, 128, 128, False),
    ("ragged S=1000", 4, 1000, 64, 64, 128, 128, True),
    ("ragged S=7", 4, 7, 64, 64, 128, 128, True),
    ("P=32 N=32 chunk 32, ragged S=77", 2, 77, 8, 32, 32, 32, True),
    ("N=64 chunk 64", 2, 256, 4, 64, 64, 64, True),
    ("P=32 N=128 chunk 64, ragged S=300", 2, 300, 8, 32, 128, 64, True),
    ("P=64 N=32 chunk 128, ragged S=333, no h0", 2, 333, 8, 64, 32, 128, False),
]
#: (label, B, S, W, with h0)
RGLRU_CASES = [
    ("recurrentgemma-9b prefill", 4, 1024, 4096, True),
    ("ragged S=1000", 4, 1000, 4096, True),
    ("ragged S=7, W=100", 2, 7, 100, False),
    ("one step, S=1", 4, 1, 4096, True),
    ("a box and a step, S=65, W=100", 2, 65, 100, True),
    ("ragged S=130, W=77", 3, 130, 77, True),
]
#: (label, kept pairs, experts, K, F, rows past the segments (dropped
#: pairs), experts left empty).  A pair's expert is drawn uniformly from
#: the others, so 32 pairs over 128 experts leave most of them empty.
GG_CASES = [
    ("qwen3-moe-30b-a3b prefill gate/up", 30_000, 128, 2048, 768, 2_768, ()),
    ("qwen3-moe-30b-a3b prefill down", 30_000, 128, 768, 2048, 2_768, ()),
    ("qwen3-moe-30b-a3b decode, 32 pairs", 32, 128, 2048, 768, 0, ()),
    ("ragged K=100 F=77, empty experts", 40, 16, 100, 77, 5, (0, 3, 4, 15)),
]
#: Segments of 0, 1, 63, 64, 65, 129 and 320 rows: one short of, at and past
#: the kernels' row tiles (128; 64 a warpgroup).
EDGE_SEGMENTS = [0, 1, 63, 64, 65, 129, 320]
#: (label, rows of each expert's segment, K, F, rows past the segments).
GG_SEGMENT_CASES = [
    ("edge segments, N=647, F=136", EDGE_SEGMENTS + [0], 2048, 136, 5),
    ("edge segments, down's K=768 F=2048", EDGE_SEGMENTS, 768, 2048, 3),
    ("edge segments over 650 experts", EDGE_SEGMENTS + [0] * 643, 256, 136, 7),
    ("all rows on one expert", [0, 0, 4096, 0], 2048, 768, 0),
    ("a decode step on one expert", [0] * 100 + [32] + [0] * 27, 2048, 768, 0),
    ("K=72, a K tail of 8", [100, 200, 0, 50], 72, 64, 9),
]
#: Every variant forced on the same inputs: (K, F) of the edge segments.
GG_FORCED_SHAPES = [(2048, 768), (768, 136)]
#: (label, T, E, K, F, block_t) through the reference-contract adapter.
GG_ADAPTER_CASES = [
    ("adapter block_t=64", 4096, 16, 512, 256, 64),
    ("adapter block_t=128", 4096, 16, 512, 256, 128),
]


def _compare(label, dtype, got, want, tol=None) -> dict:
    torch.cuda.synchronize()
    atol, rtol = TOLERANCE[dtype] if tol is None else tol
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{label} {dtype}: kernel vs plain max abs err {err:.3g} "
                             f"outside atol={atol} rtol={rtol}")
    return {"label": label, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "max_abs_want": float(want.float().abs().max())}


def ssd_inputs(rng, b, s, h, p, n, dtype, with_h0):
    """x, dt, A, Bm, Cm, h0 on the card, Bm and Cm column slices of one
    (B, S, 2N) tensor as the model passes them."""
    x = _normal(rng, (b, s, h, p), dtype)
    dt = F.softplus(_normal(rng, (b, s, h), torch.float32))
    A = -torch.exp(0.5 * _normal(rng, (h,), torch.float32))
    bc = (0.5 * _normal(rng, (b, s, 2 * n), torch.float32)).to(dtype)
    h0 = 0.1 * _normal(rng, (b, h, p, n), torch.float32) if with_h0 else None
    return x, dt, A, bc[..., :n], bc[..., n:], h0


def counted_launch(mod, call, dtype):
    """``call()`` through a wrapper with `_variant` and `LAUNCHES_BY_VARIANT`,
    checked to have launched the variant of ``dtype`` once; ``(variant,
    output)``."""
    want = mod._variant(dtype)
    before = dict(mod.LAUNCHES_BY_VARIANT)
    got = call()
    torch.cuda.synchronize()
    rose = {n: mod.LAUNCHES_BY_VARIANT[n] - before[n] for n in before}
    if rose != {n: int(n == want) for n in before}:
        raise AssertionError(f"{mod.__name__}: expected one {want} launch, counted {rose}")
    return want, got


def compare_ssd(label, args, chunk) -> list[dict]:
    """The SSD kernel of x's dtype against its plain version: y in its
    type, the final state."""
    variant, (y, h) = counted_launch(ssd, lambda: ssd.ssd_scan(*args, chunk=chunk),
                                     args[0].dtype)
    y_p, h_p = ssd.ssd_scan_plain(*args, chunk=chunk)
    return [{"kernel": "ssd_scan", "variant": variant, **_compare(
                f"ssd {label} [{variant}]", y.dtype, y, y_p, SSD_TOLERANCE[y.dtype])},
            {"kernel": "ssd_scan", "variant": variant, **_compare(
                f"ssd {label} state [{variant}]", h.dtype, h, h_p, SSD_TOLERANCE[h.dtype])}]


def gg_inputs(rng, pairs, e, k, f, tail, empty, dtype):
    """x sorted by expert (``tail`` rows past the segments, as dropped
    pairs), w and int32 offsets on the card, as the MoE block passes them."""
    p = np.ones(e)
    p[list(empty)] = 0.0
    counts = rng.multinomial(pairs, p / p.sum())
    x = _normal(rng, (pairs + tail, k), dtype)
    w = (_normal(rng, (e, k, f), torch.float32) / np.sqrt(k)).to(dtype)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    return x, w, offsets.to("cuda")


def gg_segment_inputs(rng, counts, k, f, tail, dtype):
    """x, w and offsets on the card for explicit segment lengths."""
    x = _normal(rng, (sum(counts) + tail, k), dtype)
    w = (_normal(rng, (len(counts), k, f), torch.float32) / np.sqrt(k)).to(dtype)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return x, w, torch.from_numpy(offsets).to("cuda")


def gg_launch(x, w, offsets, variant=None) -> tuple[str, torch.Tensor]:
    """The grouped GEMM through the wrapper (or with ``variant`` forced),
    checked to have launched that variant once and to leave the rows
    outside every segment zero; ``(variant, output)``."""
    k, f = w.shape[1:]
    want = variant or gg._variant(k, f, x.dtype)
    before = dict(gg.LAUNCHES_BY_VARIANT)
    got = (gg._dispatch(x, w, offsets, variant) if variant
           else gg.grouped_gemm_ragged(x, w, offsets))
    torch.cuda.synchronize()
    rose = {v: gg.LAUNCHES_BY_VARIANT[v] - before[v] for v in before}
    if rose != {v: int(v == want) for v in before}:
        raise AssertionError(f"grouped_gemm: expected one {want} launch, counted {rose}")
    lo, hi = int(offsets[0]), int(offsets[-1])
    if bool(got[:lo].any()) or bool(got[hi:].any()):
        raise AssertionError(f"grouped_gemm {want}: rows outside the segments are not zero")
    return want, got


def compare_gg(label, args, variant=None) -> dict:
    """The grouped GEMM against its plain version, in x's type."""
    x = args[0]
    variant, got = gg_launch(*args, variant=variant)
    return {"kernel": "grouped_gemm", "variant": variant, **_compare(
        f"grouped_gemm {label} [{variant}]", x.dtype, got, gg.grouped_gemm_plain(*args))}


def compare_gg_identity(variant) -> dict:
    """w[e] the identity with its columns rotated by e, in bf16: out[r, j]
    must equal x[r, (j - e) mod F] exactly.  A B tile read transposed, with
    the wrong swizzle or from the wrong expert cannot pass."""
    counts, k, f = [70, 0, 129, 1, 64, 200], 2048, 768
    x, _, offsets = gg_segment_inputs(np.random.RandomState(700), counts, k, f, 4,
                                      torch.bfloat16)
    e_n = len(counts)
    w = torch.zeros((e_n, k, f), dtype=torch.bfloat16, device="cuda")
    rows = torch.arange(f, device="cuda")
    for e in range(e_n):
        w[e, rows, (rows + e) % f] = 1.0
    _, got = gg_launch(x, w, offsets, variant)
    want = torch.zeros_like(got)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    for e in range(e_n):
        want[bounds[e]:bounds[e + 1]] = x[bounds[e]:bounds[e + 1], (rows - e) % f]
    if not torch.equal(got, want):
        raise AssertionError(f"grouped_gemm {variant}: identity weights not reproduced exactly "
                             f"({int((got != want).sum())} elements differ)")
    return {"kernel": "grouped_gemm", "variant": variant,
            "label": f"grouped_gemm identity weights [{variant}]", "dtype": "bfloat16",
            "max_abs_err": 0.0, "max_abs_want": float(want.float().abs().max())}


def flash_launch(q, k, v, window, cap) -> tuple[str, torch.Tensor]:
    """Flash attention through the wrapper, checked to have launched the
    variant of q's dtype once; ``(variant, output)``."""
    want = flash._variant(q.dtype)
    before = dict(flash.LAUNCHES_BY_VARIANT)
    got = flash.flash_attention(q, k, v, window=window, logit_softcap=cap)
    torch.cuda.synchronize()
    rose = {n: flash.LAUNCHES_BY_VARIANT[n] - before[n] for n in before}
    if rose != {n: int(n == want) for n in before}:
        raise AssertionError(f"flash_attention: expected one {want} launch, counted {rose}")
    return want, got


def compare_decode_exact(d: int, r: int) -> dict:
    """L = D slots, k_j = e_j, and query head r of (b, g) q = 2048 e_j* at
    j* = (7 r + 3 g + 5 b) % D: the score is 2048 / sqrt(D) on slot j* and 0
    elsewhere, whose weights are 0 in float32, so the output must equal
    v[j*] bit for bit through the splits and their merge.  A fragment,
    swizzle or lane-map fault of the ``mma`` split pass cannot pass."""
    b, kv = 2, 2
    q = torch.zeros((b, kv, r, d), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((b, d, kv, d), dtype=torch.bfloat16, device="cuda")
    slots = torch.arange(d, device="cuda")
    k[:, slots, :, slots] = 1.0
    v = _normal(np.random.RandomState(900 + d + r), (b, d, kv, d), torch.bfloat16)
    want = torch.empty_like(q)
    for bi in range(b):
        for g in range(kv):
            for ri in range(r):
                j = (7 * ri + 3 * g + 5 * bi) % d
                q[bi, g, ri, j] = 2048.0
                want[bi, g, ri] = v[bi, j, g]
    pos = torch.arange(d, dtype=torch.int32, device="cuda")
    variant, got = counted_launch(decode, lambda: decode.decode_attention(q, k, v, pos, d - 1),
                                  torch.bfloat16)
    if not torch.equal(got, want):
        raise AssertionError(f"decode_attention {variant} exact case D={d} R={r}: "
                             f"{int((got != want).sum())} elements differ from v")
    return {"kernel": "decode_attention", "variant": variant,
            "label": f"decode exact case D={d} R={r} [{variant}]", "dtype": "bfloat16",
            "max_abs_err": 0.0, "max_abs_want": float(want.float().abs().max())}


def compare_flash_exact(d: int) -> dict:
    """S = D, q_i = 2048 e_i, k_j = e_j, random bf16 v, no softcap: query i
    scores 2048 / sqrt(D) on key i and 0 elsewhere, whose weights
    exp(-2048 / sqrt(D)) are 0 in float32, so the output must equal v bit
    for bit.  A fragment, swizzle or repack fault cannot pass."""
    b, s, h, kv = 2, d, 4, 2
    pos = torch.arange(s, device="cuda")
    q = torch.zeros((b, s, h, d), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((b, s, kv, d), dtype=torch.bfloat16, device="cuda")
    q[:, pos, :, pos] = 2048.0
    k[:, pos, :, pos] = 1.0
    v = _normal(np.random.RandomState(800 + d), (b, s, kv, d), torch.bfloat16)
    variant, got = flash_launch(q, k, v, None, None)
    want = v.repeat_interleave(h // kv, dim=2)
    if not torch.equal(got, want):
        raise AssertionError(f"flash_attention {variant} exact case D={d}: "
                             f"{int((got != want).sum())} elements differ from v")
    return {"kernel": "flash_attention", "variant": variant,
            "label": f"flash exact case D={d} [{variant}]", "dtype": "bfloat16",
            "max_abs_err": 0.0, "max_abs_want": float(want.float().abs().max())}


def rglru_launch(a, b, h0, variant=None, lanes=None) -> tuple[str, torch.Tensor]:
    """One `rglru.rglru_scan` launch on ``variant`` and ``lanes`` a CTA
    (None: the wrapper's own choice), checked to have run on that variant;
    ``(variant, h)``."""
    want = variant or rglru._variant(a.shape[2])
    before = dict(rglru.LAUNCHES_BY_VARIANT)
    with forced_rglru(variant, lanes):
        got = rglru.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    rose = {n: rglru.LAUNCHES_BY_VARIANT[n] - before[n] for n in before}
    if rose != {n: int(n == want) for n in before}:
        raise AssertionError(f"rglru: expected one {want} launch, counted {rose}")
    return want, got


def phase_kernels_vs_plain() -> list[dict]:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, b, s, h, kv, d, window, cap) in enumerate(FLASH_CASES):
            rng = np.random.RandomState(100 + i)
            q = _normal(rng, (b, s, h, d), dtype)
            k = _normal(rng, (b, s, kv, d), dtype)
            v = _normal(rng, (b, s, kv, d), dtype)
            variant, got = flash_launch(q, k, v, window, cap)
            want = flash.flash_attention_plain(q, k, v, window=window, logit_softcap=cap)
            rows.append({"kernel": "flash_attention", "variant": variant,
                         **_compare(f"flash {label} [{variant}]", dtype, got, want)})
        if dtype == torch.bfloat16:
            rows += [compare_flash_exact(d) for d in FLASH_EXACT_DIMS]
        for i, (label, b, kv, r, d, cache_len, cur, window, cap, ring) in enumerate(
                DECODE_CASES):
            rng = np.random.RandomState(200 + i)
            q = _normal(rng, (b, kv, r, d), dtype)
            k = _normal(rng, (b, cache_len, kv, d), dtype)
            v = _normal(rng, (b, cache_len, kv, d), dtype)
            if ring:
                pos_np = ring_positions(cache_len, cur)
            else:
                pos_np = np.where(np.arange(cache_len) <= cur, np.arange(cache_len), -1)
            pos = torch.from_numpy(pos_np.astype(np.int32)).to("cuda")
            variant, got = counted_launch(decode, lambda: decode.decode_attention(
                q, k, v, pos, cur, window=window, logit_softcap=cap), dtype)
            want = decode.decode_attention_plain(q, k, v, pos, cur, window=window,
                                                 logit_softcap=cap)
            rows.append({"kernel": "decode_attention", "variant": variant,
                         **_compare(f"decode {label} [{variant}]", dtype, got, want)})
            # With the log-sum-exp of each row (context-parallel decode's
            # merge): the output at the same limits, lse within 2e-5.
            variant, (got, lse) = counted_launch(decode, lambda: decode.decode_attention(
                q, k, v, pos, cur, window=window, logit_softcap=cap, return_lse=True), dtype)
            want, want_lse = decode.decode_attention_plain(
                q, k, v, pos, cur, window=window, logit_softcap=cap, return_lse=True)
            rows.append({"kernel": "decode_attention", "variant": variant,
                         **_compare(f"decode {label} with lse [{variant}]", dtype, got, want)})
            rows.append({"kernel": "decode_attention_lse", "variant": variant,
                         **_compare(f"decode {label} lse [{variant}]", torch.float32, lse,
                                    want_lse, tol=DECODE_LSE_TOL)})
        if dtype == torch.bfloat16:
            rows += [compare_decode_exact(d, r) for d, r in DECODE_EXACT]
        for i, (label, b, s, h, p, n, chunk, with_h0) in enumerate(SSD_CASES):
            args = ssd_inputs(np.random.RandomState(300 + i), b, s, h, p, n, dtype, with_h0)
            rows += compare_ssd(label, args, chunk)
        for i, (label, pairs, e, k, f, tail, empty) in enumerate(GG_CASES):
            rng = np.random.RandomState(500 + i)
            rows.append(compare_gg(label, gg_inputs(rng, pairs, e, k, f, tail, empty, dtype)))
        for i, (label, counts, k, f, tail) in enumerate(GG_SEGMENT_CASES):
            rng = np.random.RandomState(520 + i)
            rows.append(compare_gg(label, gg_segment_inputs(rng, counts, k, f, tail, dtype)))
        variants = ("wgmma", "simt") if dtype == torch.bfloat16 else ("simt",)
        for i, (k, f) in enumerate(GG_FORCED_SHAPES):
            args = gg_segment_inputs(np.random.RandomState(540 + i), [0] + EDGE_SEGMENTS + [2, 0],
                                     k, f, 11, dtype)
            for variant in variants:
                rows.append(compare_gg(f"edge segments K={k} F={f}, forced", args, variant))
        if dtype == torch.bfloat16:
            rows += [compare_gg_identity(variant) for variant in variants]
        for i, (label, t, e, k, f, block_t) in enumerate(GG_ADAPTER_CASES):
            rng = np.random.RandomState(600 + i)
            x = _normal(rng, (t, k), dtype)
            w = (_normal(rng, (e, k, f), torch.float32) / np.sqrt(k)).to(dtype)
            eids = torch.from_numpy(rng.randint(0, e, size=t)).to("cuda")
            xs, bmap, _inv = gg.pad_and_sort_tokens(x, eids, e, block_t=block_t)
            got = gg.grouped_gemm(xs, w, bmap, block_t=block_t)
            counts = torch.bincount(bmap.long(), minlength=e) * block_t
            offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
            want = gg.grouped_gemm_plain(xs, w, offsets)
            rows.append({"kernel": "grouped_gemm", **_compare(
                f"grouped_gemm {label}", dtype, got, want)})
            # The same blocks in shuffled order: each block's product moves
            # with it.
            n_blocks = bmap.numel()
            perm = torch.from_numpy(rng.permutation(n_blocks)).to("cuda")
            got = gg.grouped_gemm(xs.view(n_blocks, block_t, k)[perm].reshape(-1, k), w,
                                  bmap[perm], block_t=block_t)
            rows.append({"kernel": "grouped_gemm", **_compare(
                f"grouped_gemm {label}, blocks shuffled", dtype, got,
                want.view(n_blocks, block_t, f)[perm].reshape(-1, f))})
    for i, (label, b, s, w, with_h0) in enumerate(RGLRU_CASES):
        rng = np.random.RandomState(400 + i)
        a = torch.sigmoid(_normal(rng, (b, s, w), torch.float32))
        bb = 0.3 * _normal(rng, (b, s, w), torch.float32)
        h0 = 0.1 * _normal(rng, (b, w), torch.float32) if with_h0 else None
        want = rglru.rglru_scan_plain(a, bb, h0)
        # The variant `_variant` picks, then the other one where W lets both run.
        for variant in (None, "cp_async") if w % 4 == 0 else (None,):
            variant, got = rglru_launch(a, bb, h0, variant)
            rows.append({"kernel": "rglru_scan", "variant": variant, **_compare(
                f"rglru {label} [{variant}]", torch.float32, got, want, RGLRU_TOLERANCE)})
    for r in rows:
        log(f"  {r['label']} {r['dtype']}: max abs err {r['max_abs_err']:.3g} "
            f"(max abs {r['max_abs_want']:.3g})")
    return rows


# --------------------------------------------------------------- phase 7

#: The serving path's kernels: the wrapper module, and which launch's
#: inputs `ServeRecorder` keeps: "largest", the first of the most elements
#: (flash attention's q, k, v are never written after), "products" (the
#: grouped GEMM's launches named in `GG_KEPT`: fresh activations and the
#: model's parameters, never written after, so a reference keeps them; it
#: also keeps the weights alive after the model is freed), or "last" (the
#: decode cache is written before each launch and not after its last; the
#: scans' inputs are fresh tensors, and their caches are replaced, not
#: written).
SERVE_KERNELS = {"flash_attention": (flash, "largest"), "decode_attention": (decode, "last"),
                 "ssd_scan": (ssd, "last"), "rglru_scan": (rglru, "last"),
                 "grouped_gemm": (gg, "products")}
#: The serving kernels with variants, whose launches `ServeRecorder` counts
#: by variant.
VARIANT_KERNELS = {"flash_attention": flash, "decode_attention": decode, "ssd_scan": ssd,
                   "rglru_scan": rglru, "grouped_gemm": gg}
#: The kernels whose `_kernel_fn` takes the variant (picked from shapes or
#: alignment) as its first argument; the others' take the dtype.
VARIANT_BY_ARGUMENT = ("grouped_gemm", "rglru_scan")
#: The grouped GEMM launches kept, by (phase, index of the launch in that
#: phase): layer 0's gate and down products of the first wave, and layer
#: 0's gate product of the first decode step.
GG_KEPT = {("prefill", 0): "prefill gate", ("prefill", 2): "prefill down",
           ("decode", 0): "decode gate"}
#: Each serving kernel's plain version, with its `_dispatch`'s arguments.
PLAIN_DISPATCH = {
    "flash_attention": lambda q, k, v, w, c: flash.flash_attention_plain(
        q, k, v, window=w, logit_softcap=c),
    "decode_attention": lambda q, k, v, p, cur, w, c: decode.decode_attention_plain(
        q, k, v, p, cur, window=w, logit_softcap=c),
    "ssd_scan": lambda x, dt, A, Bm, Cm, h0, chunk: ssd.ssd_scan_plain(
        x, dt, A, Bm, Cm, h0, chunk=chunk),
    "rglru_scan": rglru.rglru_scan_plain,
    "grouped_gemm": gg.grouped_gemm_plain,
}
#: Each serving kernel's source under src/repro_torch/kernels/csrc.
SOURCE_FILES = {"flash_attention": "flash_attention.cu",
                "decode_attention": "decode_attention.cu",
                "ssd_scan": "ssd.cu", "rglru_scan": "rglru.cu",
                "grouped_gemm": "grouped_gemm.cu"}


def expected_launches(cfg, waves: int, steps: int) -> dict:
    """Launches per kernel for ``waves`` prefills and ``steps`` decode steps:
    flash per attention or ``"moe"`` layer and wave, flash-decode per such
    layer and step, the SSD scan per ``"ssd"`` layer and wave, the RG-LRU
    scan per ``"recurrent"`` layer and wave, the grouped GEMM per
    ``"moe"`` layer and expert product (gate, up, down) in every wave and
    step.  The scans' decode steps are plain torch and launch nothing."""
    layers = {kind: cfg.layer_pattern.count(kind) * cfg.num_groups
              for kind in ("attention", "moe", "ssd", "recurrent")}
    attention = layers["attention"] + layers["moe"]
    products = 3 if cfg.gated_mlp else 2
    return {"flash_attention": attention * waves,
            "decode_attention": attention * steps,
            "ssd_scan": layers["ssd"] * waves,
            "rglru_scan": layers["recurrent"] * waves,
            "grouped_gemm": layers["moe"] * products * (waves + steps)}


def expected_gg_variants(cfg, waves: int, steps: int) -> dict:
    """The grouped GEMM's launches by phase and variant for a bf16 model:
    every product on ``wgmma`` (qwen3-moe-30b-a3b: 144 a wave, 144 a
    step)."""
    products = (3 if cfg.gated_mlp else 2) * cfg.layer_pattern.count("moe") * cfg.num_groups
    if not products:
        return {"prefill": {}, "decode": {}}
    return {"prefill": {"wgmma": products * waves}, "decode": {"wgmma": products * steps}}


def expected_flash_variants(cfg, waves: int) -> dict:
    """Flash attention's launches by phase and variant for a bf16 model:
    every prefill launch on ``wgmma`` (gemma2-2b 26 a wave,
    recurrentgemma-9b 12, qwen3-moe-30b-a3b 48), none in decode."""
    launches = expected_launches(cfg, waves, 0)["flash_attention"]
    return {"prefill": {"wgmma": launches} if launches else {}, "decode": {}}


def expected_decode_variants(cfg, steps: int) -> dict:
    """Flash-decode's launches by phase and variant for a bf16 model: every
    decode launch on ``mma`` (gemma2-2b 26 a step, recurrentgemma-9b 12,
    qwen3-moe-30b-a3b 48), none in prefill."""
    launches = expected_launches(cfg, 0, steps)["decode_attention"]
    return {"prefill": {}, "decode": {"mma": launches} if launches else {}}


def expected_ssd_variants(cfg, waves: int) -> dict:
    """The SSD scan's launches by phase and variant for a bf16 model: every
    prefill launch on ``mma`` (mamba2-1.3b 48 a wave), none in decode."""
    launches = expected_launches(cfg, waves, 0)["ssd_scan"]
    return {"prefill": {"mma": launches} if launches else {}, "decode": {}}


def expected_rglru_variants(cfg, waves: int) -> dict:
    """The RG-LRU scan's launches by phase and variant: every prefill launch
    on ``tma`` (recurrentgemma-9b 26 a wave, W = 4096), none in decode."""
    launches = expected_launches(cfg, waves, 0)["rglru_scan"]
    return {"prefill": {"tma": launches} if launches else {}, "decode": {}}


def _reset_serve_counts() -> None:
    for mod, _ in SERVE_KERNELS.values():
        mod.LAUNCHES = 0


def _serve_counts() -> dict:
    return {name: mod.LAUNCHES for name, (mod, _) in SERVE_KERNELS.items()}


class ServeRecorder:
    """During the serving path: CUDA events right around every kernel
    launch (the C function each wrapper's `_kernel_fn` returns), apart by
    the forward they ran in, and around every `forward_prefill` /
    `forward_decode` call; the inputs of one served launch of each kernel
    (see `SERVE_KERNELS`); the last position's logits of every prefill."""

    def __init__(self):
        self.launches = {name: {"prefill": [], "decode": []} for name in SERVE_KERNELS}
        self._phase = "prefill"
        self.forward = {"prefill": [], "decode": []}
        self.args = {name: None for name in SERVE_KERNELS}
        self.args["grouped_gemm"] = {}
        self.gg_seen = {"prefill": 0, "decode": 0}
        self.variants = {name: {"prefill": {}, "decode": {}} for name in VARIANT_KERNELS}
        self.prefill_logits = []
        self._saved = {name: (mod._kernel_fn, mod._dispatch)
                       for name, (mod, _) in SERVE_KERNELS.items()}
        self._saved_forward = (tfm.forward_prefill, tfm.forward_decode)

    @staticmethod
    def _timed(events, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        return call

    def _kernel_fn(self, name):
        kernel_fn = self._saved[name][0]

        def fn(*a):
            # grouped_gemm's a = (variant, dtype), rglru_scan's (variant,), the
            # others' (dtype,)
            if name in VARIANT_KERNELS:
                variant = (a[0] if name in VARIANT_BY_ARGUMENT
                           else VARIANT_KERNELS[name]._variant(a[0]))
                counts = self.variants[name][self._phase]
                counts[variant] = counts.get(variant, 0) + 1
            return self._timed(self.launches[name][self._phase], kernel_fn(*a))
        return fn

    def _dispatch(self, name, keep):
        dispatch = self._saved[name][1]

        def call(*args, **kwargs):
            old = self.args[name]
            if keep == "products":
                label = GG_KEPT.get((self._phase, self.gg_seen[self._phase]))
                self.gg_seen[self._phase] += 1
                if label is not None and label not in old:
                    old[label] = args
            elif keep == "last" or old is None or (
                    keep == "largest" and args[0].numel() > old[0].numel()):
                self.args[name] = args
            return dispatch(*args, **kwargs)
        return call

    def _in_phase(self, phase, fn):
        def call(*args, **kwargs):
            self._phase = phase
            return fn(*args, **kwargs)
        return call

    def __enter__(self):
        for name, (mod, keep) in SERVE_KERNELS.items():
            mod._kernel_fn = self._kernel_fn(name)
            mod._dispatch = self._dispatch(name, keep)
        prefill, decode_fwd = self._saved_forward

        def timed_prefill(*args, **kwargs):
            logits, caches = self._timed(self.forward["prefill"], self._in_phase(
                "prefill", prefill))(*args, **kwargs)
            self.prefill_logits.append(logits[:, -1].clone())
            return logits, caches

        tfm.forward_prefill = timed_prefill
        tfm.forward_decode = self._timed(self.forward["decode"],
                                         self._in_phase("decode", decode_fwd))
        return self

    def __exit__(self, *exc):
        for name, (mod, _) in SERVE_KERNELS.items():
            mod._kernel_fn, mod._dispatch = self._saved[name]
        tfm.forward_prefill, tfm.forward_decode = self._saved_forward

    @staticmethod
    def total_ms(events) -> float:
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in events))

    def phase_counts(self, phase) -> dict:
        """Launches per kernel during the forwards of ``phase``."""
        return {name: len(ev[phase]) for name, ev in self.launches.items()}

    def phase_ms(self, phase) -> dict:
        """Kernel ms per kernel during the forwards of ``phase``."""
        return {name: self.total_ms(ev[phase]) for name, ev in self.launches.items()}


def phase_serve_launcher(arch: str) -> dict:
    argv = ["--arch", arch, "--no-smoke-weights", "--streams", "3", "--requests", "2",
            "--new-tokens", "4"]
    with ServeRecorder() as rec:
        _reset_serve_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _serve_counts()
    cfg = get_config(arch)
    waves, steps = len(rec.forward["prefill"]), len(rec.forward["decode"])
    if counts != expected_launches(cfg, waves, steps) or waves == 0 or steps == 0:
        raise AssertionError(f"launcher {arch}: {counts} launches for {waves} waves, "
                             f"{steps} steps")
    for rs in out["results"].values():
        for r in rs:
            if len(r.tokens) != 4 or not all(0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"launcher {arch} request {r.rid}: bad tokens {r.tokens}")
    for logits in rec.prefill_logits:
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"launcher {arch}: non-finite prefill logits")
    launched = {k: v for k, v in counts.items() if v}
    log(f"  launcher {arch}: {len(out['plan'].instances)} instances "
        f"{out['plan'].instance_counts()}, {out['tokens']} tokens in {wall_s:.2f} s; "
        f"{waves} waves, {steps} decode steps; launches {launched}")
    return {"instances": len(out["plan"].instances), "hourly_cost": out["plan"].hourly_cost,
            "tokens": out["tokens"], "wall_s": wall_s, "waves": waves, "decode_steps": steps,
            "launches": counts}


def phase_frame_analysis(arch: str, params) -> dict:
    cfg = get_config(arch)
    prompt_tokens = PROMPT_TOKENS[arch]
    engine = ServingEngine(cfg, params, batch_slots=SLOTS, max_seq=prompt_tokens + NEW_TOKENS)
    rng = np.random.RandomState(0)
    for rid in range(N_REQUESTS):
        engine.submit(Request(rid=rid, prompt=rng.randint(0, cfg.vocab_size, prompt_tokens),
                              max_new_tokens=NEW_TOKENS))
    with ServeRecorder() as rec:
        _reset_serve_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _serve_counts()
    waves, steps = len(rec.forward["prefill"]), len(rec.forward["decode"])
    expect = expected_launches(cfg, waves, steps)
    if waves != N_REQUESTS // SLOTS or steps != waves * NEW_TOKENS or counts != expect:
        raise AssertionError(f"frame analysis {arch}: launches {counts} for {waves} waves and "
                             f"{steps} decode steps (expected {expect})")
    for phase, (w, n) in (("prefill", (waves, 0)), ("decode", (0, steps))):
        if rec.phase_counts(phase) != expected_launches(cfg, w, n):
            raise AssertionError(f"frame analysis {arch}: {phase} launches "
                                 f"{rec.phase_counts(phase)}, expected "
                                 f"{expected_launches(cfg, w, n)}")
    for name, want in (("grouped_gemm", expected_gg_variants(cfg, waves, steps)),
                       ("flash_attention", expected_flash_variants(cfg, waves)),
                       ("decode_attention", expected_decode_variants(cfg, steps)),
                       ("ssd_scan", expected_ssd_variants(cfg, waves)),
                       ("rglru_scan", expected_rglru_variants(cfg, waves))):
        if rec.variants[name] != want:
            raise AssertionError(f"frame analysis {arch}: {name} variants "
                                 f"{rec.variants[name]}, expected {want}")
    if sorted(r.rid for r in results) != list(range(N_REQUESTS)):
        raise AssertionError(f"frame analysis {arch}: missing results")
    for r in results:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"frame analysis {arch} request {r.rid}: bad tokens")
    for logits in rec.prefill_logits:
        if tuple(logits.shape) != (SLOTS, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"frame analysis {arch}: bad prefill logits")
    prefill_ms = [s.elapsed_time(e) for s, e in rec.forward["prefill"]]
    decode_ms = [s.elapsed_time(e) for s, e in rec.forward["decode"]]
    by_phase = {phase: rec.phase_ms(phase) for phase in ("prefill", "decode")}
    kernel_ms = {name: by_phase["prefill"][name] + by_phase["decode"][name]
                 for name in SERVE_KERNELS if counts[name]}
    tokens = sum(len(r.tokens) for r in results)
    out = {
        "arch": arch, "requests": N_REQUESTS, "prompt_tokens": prompt_tokens,
        "new_tokens": NEW_TOKENS, "slots": SLOTS, "waves": waves, "decode_steps": steps,
        "launches": counts, "variants": rec.variants,
        "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "prefill_ms": prefill_ms, "decode_ms_per_step": float(np.mean(decode_ms)),
        "kernel_ms": kernel_ms,
        "kernel_ms_by_phase": {ph: {n: ms for n, ms in v.items() if counts[n]}
                               for ph, v in by_phase.items()},
        "kernel_share": {n: ms / 1e3 / wall_s for n, ms in kernel_ms.items()},
        "prefill_kernel_share": sum(by_phase["prefill"].values()) / sum(prefill_ms),
        "decode_kernel_share": sum(by_phase["decode"].values()) / sum(decode_ms),
        "_args": rec.args,
    }
    log(f"  {arch}: {N_REQUESTS} requests x {prompt_tokens}-token prompts, {SLOTS} slots: "
        f"{waves} waves, {steps} decode steps; launches "
        f"{ {k: v for k, v in counts.items() if v} }; by variant "
        f"{ {n: v for n, v in rec.variants.items() if counts[n]} }")
    log(f"  wall {wall_s:.3f} s, {out['tokens_per_s']:.1f} generated tokens/s; prefill "
        f"{', '.join(f'{ms:.1f}' for ms in prefill_ms)} ms; decode "
        f"{out['decode_ms_per_step']:.3f} ms/step")
    log("  kernel time: " + "; ".join(
        f"{n} {ms:.2f} ms ({out['kernel_share'][n]:.2%} of wall)" for n, ms in kernel_ms.items())
        + f"; kernels {out['prefill_kernel_share']:.2%} of prefill, "
        f"{out['decode_kernel_share']:.2%} of decode")
    return out


#: Phase 7 (c): the arch served through the step builders, and its decode steps.
BUILDER_ARCH = "gemma2-2b"
BUILDER_DECODE_STEPS = 4


def serve_through_builders(arch: str, params) -> dict:
    """(c): one prefill wave of `SLOTS` `PROMPT_TOKENS`-token prompts and
    `BUILDER_DECODE_STEPS` greedy decode steps of ``arch`` at full width,
    with phase (b)'s weights, through `steps.make_prefill_setup` and
    `steps.make_decode_setup` on the (1, 1) mesh, every kernel count set
    to 0 just before and held after to `expected_launches`; then the same
    through `forward_prefill` and `forward_decode` called directly on fresh
    caches: every logit bit-equal."""
    cfg = get_config(arch)
    prompt = PROMPT_TOKENS[arch]
    cache_len = prompt + BUILDER_DECODE_STEPS
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (SLOTS, prompt))).to("cuda")

    def serve_wave(prefill, decode_step) -> tuple[list, float]:
        caches = tfm.init_serve_cache(cfg, SLOTS, cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill({"tokens": tokens}, caches)
        rows = [logits]
        tok = logits[:, -1:].argmax(-1)
        for pos in range(prompt, cache_len):
            logits, caches = decode_step(tok, pos, caches)
            rows.append(logits)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    with local_mesh() as mesh:
        prefill, _, _ = steps_lib.make_prefill_setup(cfg, mesh, multi_pod=False, batch=SLOTS,
                                                     seq_len=cache_len)
        decode_step, _, _ = steps_lib.make_decode_setup(
            cfg, mesh, multi_pod=False, batch=SLOTS, cache_len=cache_len, long_context=False)
        _reset_serve_counts()
        built, built_s = serve_wave(lambda b, c: prefill(params, b, c),
                                    lambda t, pos, c: decode_step(params, t, pos, c))
        counts = _serve_counts()
    expect = expected_launches(cfg, 1, BUILDER_DECODE_STEPS)
    if counts != expect:
        raise AssertionError(f"(c) {arch} through the builders: launches {counts}, "
                             f"expected {expect}")
    direct, direct_s = serve_wave(
        lambda b, c: tfm.forward_prefill(params, cfg, b, c),
        lambda t, pos, c: tfm.forward_decode(params, cfg, t, pos, c))
    unequal = [i for i, (a, b) in enumerate(zip(built, direct)) if not torch.equal(a, b)]
    if unequal or not bool(torch.isfinite(built[0]).all()):
        raise AssertionError(f"(c) {arch}: builder logits differ from the direct calls' at "
                             f"forwards {unequal} (0 = the prefill)")
    log(f"  (c) {arch} through make_prefill_setup/make_decode_setup: 1 wave of {SLOTS} x "
        f"{prompt} tokens, {BUILDER_DECODE_STEPS} decode steps in {built_s:.3f} s "
        f"(direct {direct_s:.3f} s); launches "
        f"{ {k: v for k, v in counts.items() if v} }; logits bit-equal to the direct calls")
    del built, direct
    torch.cuda.empty_cache()
    return {"arch": arch, "slots": SLOTS, "prompt_tokens": prompt,
            "decode_steps": BUILDER_DECODE_STEPS, "launches": counts, "wall_s": built_s,
            "direct_wall_s": direct_s, "bit_equal": True}


# --------------------------------------------------------------- phase 8


#: Every `time_cold_ms` call's host dispatch time, spin, and the mean,
#: median and largest of its timed calls, in ms.
COLD_TIMINGS: list[dict] = []
_SPIN_CYCLES_PER_MS: list[float] = []


def _spin_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` a millisecond, measured once."""
    if not _SPIN_CYCLES_PER_MS:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


#: How `time_cold_ms` flushes L2 before each call, by name: "write" zeroes
#: a 64 MB buffer (leaving dirty lines for the timed call to write back),
#: "read" reads it, "none" does not flush.
FLUSHES = {"write": lambda buf: buf.zero_(), "read": lambda buf: buf.max(),
           "none": lambda buf: None}


def time_cold_ms(fn, reps: int, warmup: int = 2, flush: str = "write") -> float:
    """Mean ms of ``fn`` with L2 flushed before each call as `FLUSHES`
    [``flush``] does (events right around each call): the serving path
    reaches each kernel after other layers' weights have passed through
    L2.  Before each flush the card spins for at least 1 ms and at least
    twice the host time of one ``fn()`` call (the most of three, measured
    on an idle card), so the host has queued the call before the card
    reaches the start event and the host's dispatch time stays outside the
    events.  Logs both times."""
    return time_cold_parts_ms(lambda mid: fn(), reps, warmup, flush, parts=False)[0]


def time_cold_launches_ms(fn, n_launches: int, reps: int, warmup: int = 2,
                          flush: str = "write") -> tuple:
    """`time_cold_ms` of ``fn(events)``, a call of ``n_launches`` kernel
    launches that records ``events[i]`` after launch i (the last launch's
    end is the call's): the mean of the whole call and the list of each
    launch's means."""
    buf = torch.zeros(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    for _ in range(warmup):
        fn(None)
    host_ms = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(None)
        host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    spin_ms = max(1.0, 2.0 * host_ms)
    cycles = int(spin_ms * _spin_cycles_per_ms())
    COLD_TIMINGS.append({"host_ms": host_ms, "spin_ms": spin_ms})
    log(f"    cold timing ({flush} flush): host dispatch {host_ms:.4f} ms, "
        f"spin {spin_ms:.4f} ms")
    runs = []
    for _ in range(reps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n_launches - 1)]
        for m in marks:
            m.record()  # created here, recorded again between the launches
        torch.cuda._sleep(cycles)
        FLUSHES[flush](buf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(marks)
        end.record()
        runs.append([start, *marks, end])
    torch.cuda.synchronize()
    times = [r[0].elapsed_time(r[-1]) for r in runs]
    total = float(np.mean(times))
    COLD_TIMINGS[-1].update(mean_ms=total, median_ms=float(np.median(times)),
                            max_ms=float(np.max(times)))
    parts = [float(np.mean([r[i].elapsed_time(r[i + 1]) for r in runs]))
             for i in range(n_launches)]
    return total, parts


def time_cold_parts_ms(fn, reps: int, warmup: int = 2, flush: str = "write",
                       parts: bool = True) -> tuple:
    """`time_cold_ms` of ``fn(mid)``, a call of two kernel passes that
    records the timing event ``mid`` between them: the means of the whole
    call, of the first pass and of the second (the parts are None without
    ``parts``, where ``fn`` gets None)."""
    if not parts:
        return time_cold_launches_ms(lambda marks: fn(None), 1, reps, warmup, flush)[0], None, None
    total, (first, second) = time_cold_launches_ms(
        lambda marks: fn(marks[0] if marks else None), 2, reps, warmup, flush)
    return total, first, second


def time_decode_parts(args, reps: int) -> dict:
    """Flash-decode on ``args`` (`_dispatch`'s) timed cold: the call and,
    where it is two launches (``simt``), its split and combine passes
    apart; the ``mma`` kernel merges its splits in its one launch."""
    if decode._variant(args[0].dtype) == "mma":
        return {"ms": time_cold_ms(lambda: decode._dispatch(*args), reps), "passes": 1}
    ms, split_ms, combine_ms = time_cold_parts_ms(
        lambda mid: decode._dispatch(*args, mid_event=mid), reps)
    return {"ms": ms, "split_ms": split_ms, "combine_ms": combine_ms, "passes": 2}


def _passes(t: dict) -> str:
    """A timing's passes, for the log."""
    if "split_ms" in t:
        return f" (split {t['split_ms']:.4f} + combine {t['combine_ms']:.4f})"
    return " (one launch)" if t.get("passes") == 1 else ""


def flash_bound(q, k, window) -> dict:
    b, s, h, d = q.shape
    item = q.element_size()
    i = np.arange(s)
    pairs = int(np.minimum(i + 1, window).sum() if window else (i + 1).sum())
    ops = 4 * b * h * d * pairs  # q k^T and p v, 2 operations per multiply-add
    bytes_moved = 2 * q.numel() * item + 2 * k.numel() * item  # q, k, v in; o out
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def decode_bound(q, k, pos, cur, window) -> dict:
    b, kv, r, d = q.shape
    item = q.element_size()
    p = pos.cpu().numpy()
    valid = (p >= 0) & (p <= cur)
    if window:
        valid &= p > cur - window
    n_valid = int(valid.sum())
    ops = 4 * b * kv * r * d * n_valid
    bytes_moved = 2 * q.numel() * item + 2 * b * n_valid * kv * d * item + pos.numel() * 4
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def _bound(bytes_moved, ops, peak) -> dict:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "ops": ops}


def _sdpa_causal(q, k, v):
    """One library call: causal GQA attention on (B, S, H, D) tensors."""
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), is_causal=True, enable_gqa=True)
    return out.transpose(1, 2)


def _sdpa_decode(q, k, v, mask):
    """One library call: one-token GQA attention over a masked cache."""
    b, kv, r, d = q.shape
    out = F.scaled_dot_product_attention(
        q.reshape(b, kv * r, 1, d), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[None, None, None, :], enable_gqa=True)
    return out.reshape(b, kv, r, d)


def flex_attention_call(s: int, window, cap):
    """One library call as a yardstick where SDPA cannot apply a softcap:
    `torch.compile` of PyTorch's flex_attention with ``cap tanh(x / cap)``
    as its score_mod and the causal (and window) mask as a block mask, on
    (B, S, H, D) tensors (GQA).  Timed here and used nowhere in the port.
    Its compiled code is cached under the checkout's ``build/``."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    inductor_config.compile_threads = 1  # no pool of compile worker processes

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        keep = kv_idx <= q_idx
        if window is not None:
            keep = keep & (kv_idx > q_idx - window)
        return keep

    block_mask = create_block_mask(mask_mod, None, None, s, s, device="cuda")
    compiled = torch.compile(flex_attention, dynamic=False)

    def call(q, k, v):
        out = compiled(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
        return out.transpose(1, 2)

    return call


def flex_yardstick(make, window, cap, s: int, want, reps: int = 5) -> dict:
    """``library_ms``: the call ``make(fn)`` returns (the forward of
    `flex_attention_call` ``fn``, or a backward of a graph it kept) timed
    cold, with its largest difference from ``want`` (the plain version's
    result, or a tuple of them); where flex_attention cannot compile or
    run the shape, ``library_ms`` is None and ``library_error`` says what
    it raised."""
    out = {"library": "torch.compile(flex_attention), softcap score_mod"}
    try:
        call = make(flex_attention_call(s, window, cap))
        got = call()
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        out["library_max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                         for g, w in pairs)
        del got
        out["library_ms"] = time_cold_ms(call, reps=reps)
    except Exception as e:  # a yardstick's refusal is a reading, not a failure of the port
        out["library_ms"] = None
        out["library_error"] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
        log(f"    flex_attention refused: {out['library_error']}")
    torch.cuda.empty_cache()
    return out


def phase_attention_timing(flash_args, decode_args) -> dict:
    before = (flash.LAUNCHES, decode.LAUNCHES)
    flash_variants = dict(flash.LAUNCHES_BY_VARIANT)
    q, k, v, window, cap = flash_args
    dq, dk, dv, pos, cur, dwin, dcap = decode_args
    served = [
        {"kernel": "flash_attention", **_compare(
            "flash served prefill", q.dtype, flash._dispatch(q, k, v, window, cap),
            flash.flash_attention_plain(q, k, v, window=window, logit_softcap=cap))},
        {"kernel": "decode_attention", **_compare(
            "decode served step", dq.dtype,
            decode._dispatch(dq, dk, dv, pos, cur, dwin, dcap),
            decode.decode_attention_plain(dq, dk, dv, pos, cur, window=dwin,
                                          logit_softcap=dcap))},
    ]
    for r in served:
        log(f"  {r['label']} {r['dtype']}: max abs err {r['max_abs_err']:.3g}")
    f = {"shape": list(q.shape), "kv_heads": k.shape[2], "window": window, "softcap": cap,
         "dtype": str(q.dtype).replace("torch.", "")}
    f["ms"] = time_cold_ms(lambda: flash._dispatch(q, k, v, window, cap), reps=10)
    f["plain_ms"] = time_cold_ms(lambda: flash.flash_attention_plain(
        q, k, v, window=window, logit_softcap=cap), reps=5)
    f.update(flash_bound(q, k, window))
    # The softcap: SDPA cannot apply it; flex_attention with it as its
    # score_mod can, compiled.
    f.update(flex_yardstick(lambda fn: lambda: fn(q, k, v), window, cap, q.shape[1],
                            flash.flash_attention_plain(q, k, v, window=window,
                                                        logit_softcap=cap)))
    # The same call in float32, on the `simt` variant that phase 8's
    # float32 models run: held against its plain version, then timed.
    q32, k32, v32 = q.float(), k.float(), v.float()
    variant32, got32 = flash_launch(q32, k32, v32, window, cap)
    served.append({"kernel": "flash_attention", "variant": variant32, **_compare(
        f"flash served prefill in float32 [{variant32}]", torch.float32, got32,
        flash.flash_attention_plain(q32, k32, v32, window=window, logit_softcap=cap))})
    del got32
    f["float32"] = {"variant": variant32, **flash_bound(q32, k32, window),
                    "ms": time_cold_ms(lambda: flash._dispatch(q32, k32, v32, window, cap),
                                       reps=5)}
    f["float32"].update(flex_yardstick(
        lambda fn: lambda: fn(q32, k32, v32), window, cap, q.shape[1],
        flash.flash_attention_plain(q32, k32, v32, window=window, logit_softcap=cap)))

    dd = {"shape": list(dq.shape), "cache_len": dk.shape[1], "cur": cur, "window": dwin,
          "softcap": dcap, "dtype": str(dq.dtype).replace("torch.", ""),
          "variant": decode._variant(dq.dtype)}
    dd.update(time_decode_parts((dq, dk, dv, pos, cur, dwin, dcap), reps=50))
    # With each row's log-sum-exp written too (context-parallel decode).
    dd["lse_ms"] = time_cold_ms(lambda: decode._dispatch(dq, dk, dv, pos, cur, dwin, dcap,
                                                         with_lse=True), 50)
    dd["plain_ms"] = time_cold_ms(lambda: decode.decode_attention_plain(
        dq, dk, dv, pos, cur, window=dwin, logit_softcap=dcap), reps=20)
    dd.update(decode_bound(dq, dk, pos, cur, dwin))
    dd["library_ms"] = None
    # The same step in float32, on the `simt` variant (split and combine
    # passes) that phase 8's float32 models run.
    dq32, dk32, dv32 = dq.float(), dk.float(), dv.float()
    variant32, got32 = counted_launch(decode, lambda: decode.decode_attention(
        dq32, dk32, dv32, pos, cur, window=dwin, logit_softcap=dcap), torch.float32)
    served.append({"kernel": "decode_attention", "variant": variant32, **_compare(
        f"decode served step in float32 [{variant32}]", torch.float32, got32,
        decode.decode_attention_plain(dq32, dk32, dv32, pos, cur, window=dwin,
                                      logit_softcap=dcap))})
    dd["float32"] = {"variant": variant32, **decode_bound(dq32, dk32, pos, cur, dwin),
                     **time_decode_parts((dq32, dk32, dv32, pos, cur, dwin, dcap), reps=20),
                     "lse_ms": time_cold_ms(lambda: decode._dispatch(
                         dq32, dk32, dv32, pos, cur, dwin, dcap, with_lse=True), 20)}
    del dq32, dk32, dv32, got32

    # internlm2-1.8b's shapes: no window, no softcap, so SDPA computes the
    # same functions; it is timed here and used nowhere in the port.
    rng = np.random.RandomState(7)
    iq = _normal(rng, (4, 512, 16, 128), torch.bfloat16)
    ik = _normal(rng, (4, 512, 8, 128), torch.bfloat16)
    iv = _normal(rng, (4, 512, 8, 128), torch.bfloat16)
    ref = flash.flash_attention_plain(iq, ik, iv)
    lib_err = float((_sdpa_causal(iq, ik, iv).float() - ref.float()).abs().max())
    f["internlm2"] = {
        "shape": [4, 512, 16, 128], "kv_heads": 8,
        "ms": time_cold_ms(lambda: flash._dispatch(iq, ik, iv, None, None), reps=20),
        "plain_ms": time_cold_ms(lambda: flash.flash_attention_plain(iq, ik, iv), reps=10),
        "library_ms": time_cold_ms(lambda: _sdpa_causal(iq, ik, iv), reps=20),
        "library_max_abs_err": lib_err, **flash_bound(iq, ik, None),
    }
    cache_len, cur_i = 528, 527
    dq_i = _normal(rng, (4, 8, 2, 128), torch.bfloat16)
    dk_i = _normal(rng, (4, cache_len, 8, 128), torch.bfloat16)
    dv_i = _normal(rng, (4, cache_len, 8, 128), torch.bfloat16)
    pos_i = torch.arange(cache_len, dtype=torch.int32, device="cuda")
    mask = (pos_i >= 0) & (pos_i <= cur_i)
    ref = decode.decode_attention_plain(dq_i, dk_i, dv_i, pos_i, cur_i)
    lib_err = float((_sdpa_decode(dq_i, dk_i, dv_i, mask).float() - ref.float()).abs().max())
    dd["internlm2"] = {
        "shape": [4, 8, 2, 128], "cache_len": cache_len,
        **time_decode_parts((dq_i, dk_i, dv_i, pos_i, cur_i, None, None), reps=50),
        "plain_ms": time_cold_ms(lambda: decode.decode_attention_plain(
            dq_i, dk_i, dv_i, pos_i, cur_i), reps=20),
        "library_ms": time_cold_ms(lambda: _sdpa_decode(dq_i, dk_i, dv_i, mask), reps=50),
        "library_max_abs_err": lib_err, **decode_bound(dq_i, dk_i, pos_i, cur_i, None),
    }
    flash.LAUNCHES, decode.LAUNCHES = before  # timing launches are not the path's
    flash.LAUNCHES_BY_VARIANT.update(flash_variants)
    f32 = f["float32"]
    log(f"  flash_attention at {f['shape']} float32 [{f32['variant']}]: kernel "
        f"{f32['ms']:.4f} ms, bound {f32['bound_ms']:.4f} ms ({f32['bound_by']}), flex "
        + (f"{f32['library_ms']:.4f} ms" if f32["library_ms"] is not None
           else f32["library_error"]))
    log(f"  decode_attention at {dd['shape']} float32 [{dd['float32']['variant']}]: kernel "
        f"{dd['float32']['ms']:.4f} ms{_passes(dd['float32'])}, with lse "
        f"{dd['float32']['lse_ms']:.4f} ms, bound {dd['float32']['bound_ms']:.4f} ms; "
        f"bf16{_passes(dd)}, with lse {dd['lse_ms']:.4f} ms")
    for name, t in (("flash_attention", f), ("decode_attention", dd)):
        i = t["internlm2"]
        log(f"  {name} at {t['shape']} {t['dtype']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); at "
            f"internlm2 {i['shape']}: kernel {i['ms']:.4f} ms, plain {i['plain_ms']:.4f} ms, "
            f"sdpa {i['library_ms']:.4f} ms, bound {i['bound_ms']:.4f} ms")
    return {"flash_attention": f, "decode_attention": dd, "served_checks": served}


def phase_attention_timing_rep16(flash_args, decode_args) -> dict:
    """Both attention kernels on recurrentgemma-9b's served inputs (16 query
    heads over one KV head of 256, window 2048, no softcap): held against
    their plain versions, then timed beside them, their bounds and SDPA,
    which computes the same functions there as long as the window does
    not bind (S and the cache's positions within it)."""
    before = (flash.LAUNCHES, decode.LAUNCHES)
    flash_variants = dict(flash.LAUNCHES_BY_VARIANT)
    q, k, v, window, cap = flash_args
    dq, dk, dv, pos, cur, dwin, dcap = decode_args
    served = [
        {"kernel": "flash_attention", **_compare(
            "flash served prefill, rep 16", q.dtype, flash._dispatch(q, k, v, window, cap),
            flash.flash_attention_plain(q, k, v, window=window, logit_softcap=cap))},
        {"kernel": "decode_attention", **_compare(
            "decode served step, rep 16", dq.dtype,
            decode._dispatch(dq, dk, dv, pos, cur, dwin, dcap),
            decode.decode_attention_plain(dq, dk, dv, pos, cur, window=dwin,
                                          logit_softcap=dcap))},
    ]
    for r in served:
        log(f"  {r['label']} {r['dtype']}: max abs err {r['max_abs_err']:.3g}")
    if cap is not None or dcap is not None or (window and q.shape[1] > window):
        raise AssertionError("recurrentgemma-9b's served attention is not SDPA's function")
    mask = (pos >= 0) & (pos <= cur)
    if dwin:
        mask &= pos > cur - dwin
    f = {"shape": list(q.shape), "kv_heads": k.shape[2], "window": window,
         "ms": time_cold_ms(lambda: flash._dispatch(q, k, v, window, cap), reps=10),
         "plain_ms": time_cold_ms(lambda: flash.flash_attention_plain(
             q, k, v, window=window), reps=5),
         "library_ms": time_cold_ms(lambda: _sdpa_causal(q, k, v), reps=10),
         **flash_bound(q, k, window)}
    dd = {"shape": list(dq.shape), "cache_len": dk.shape[1], "cur": cur, "window": dwin,
          **time_decode_parts((dq, dk, dv, pos, cur, dwin, dcap), reps=50),
          "plain_ms": time_cold_ms(lambda: decode.decode_attention_plain(
              dq, dk, dv, pos, cur, window=dwin), reps=20),
          "library_ms": time_cold_ms(lambda: _sdpa_decode(dq, dk, dv, mask), reps=50),
          **decode_bound(dq, dk, pos, cur, dwin)}
    flash.LAUNCHES, decode.LAUNCHES = before
    flash.LAUNCHES_BY_VARIANT.update(flash_variants)
    for name, t in (("flash_attention", f), ("decode_attention", dd)):
        log(f"  {name} at recurrentgemma-9b's {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {"flash_attention": f, "decode_attention": dd, "served_checks": served}


def phase_flash_timing_qwen3(flash_args) -> dict:
    """Flash attention on qwen3-moe-30b-a3b's served prefill (32 query heads
    over 4 KV heads of 128, no window, no softcap, so SDPA computes the same
    function): held against its plain version, then timed beside it, its
    bound and SDPA."""
    before = flash.LAUNCHES, dict(flash.LAUNCHES_BY_VARIANT)
    q, k, v, window, cap = flash_args
    if cap is not None or (window and q.shape[1] > window):
        raise AssertionError("qwen3-moe-30b-a3b's served attention is not SDPA's function")
    variant, got = flash_launch(q, k, v, window, cap)
    want = flash.flash_attention_plain(q, k, v, window=window, logit_softcap=cap)
    served = [{"kernel": "flash_attention", "variant": variant, **_compare(
        f"flash served prefill, qwen3-moe-30b-a3b [{variant}]", q.dtype, got, want)}]
    lib_err = float((_sdpa_causal(q, k, v).float() - want.float()).abs().max())
    f = {"shape": list(q.shape), "kv_heads": k.shape[2], "window": window, "variant": variant,
         "ms": time_cold_ms(lambda: flash._dispatch(q, k, v, window, cap), reps=20),
         "plain_ms": time_cold_ms(lambda: flash.flash_attention_plain(
             q, k, v, window=window), reps=5),
         "library_ms": time_cold_ms(lambda: _sdpa_causal(q, k, v), reps=20),
         "library_max_abs_err": lib_err, **flash_bound(q, k, window)}
    flash.LAUNCHES = before[0]
    flash.LAUNCHES_BY_VARIANT.update(before[1])
    log(f"  {served[0]['label']} {served[0]['dtype']}: max abs err "
        f"{served[0]['max_abs_err']:.3g}")
    log(f"  flash_attention at qwen3-moe-30b-a3b's {f['shape']} [{variant}]: kernel "
        f"{f['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms, sdpa {f['library_ms']:.4f} ms, bound "
        f"{f['bound_ms']:.4f} ms ({f['bound_by']})")
    return {"flash_attention": f, "served_checks": served}


def phase_decode_timing_qwen3(decode_args) -> dict:
    """Flash-decode on qwen3-moe-30b-a3b's served step (32 query heads over
    4 KV heads of 128, no window, no softcap, so SDPA computes the same
    function): held against its plain version, then timed beside it, its
    bound and SDPA."""
    dq, dk, dv, pos, cur, dwin, dcap = decode_args
    if dcap is not None or dwin is not None:
        raise AssertionError("qwen3-moe-30b-a3b's served decode is not SDPA's function")
    variant, got = counted_launch(decode, lambda: decode.decode_attention(dq, dk, dv, pos, cur),
                                  dq.dtype)
    want = decode.decode_attention_plain(dq, dk, dv, pos, cur)
    served = [{"kernel": "decode_attention", "variant": variant, **_compare(
        f"decode served step, qwen3-moe-30b-a3b [{variant}]", dq.dtype, got, want)}]
    mask = (pos >= 0) & (pos <= cur)
    lib_err = float((_sdpa_decode(dq, dk, dv, mask).float() - want.float()).abs().max())
    dd = {"shape": list(dq.shape), "cache_len": dk.shape[1], "cur": cur, "variant": variant,
          **time_decode_parts((dq, dk, dv, pos, cur, None, None), reps=50),
          "plain_ms": time_cold_ms(lambda: decode.decode_attention_plain(dq, dk, dv, pos, cur),
                                   reps=20),
          "library_ms": time_cold_ms(lambda: _sdpa_decode(dq, dk, dv, mask), reps=50),
          "library_max_abs_err": lib_err, **decode_bound(dq, dk, pos, cur, None)}
    log(f"  {served[0]['label']} {served[0]['dtype']}: max abs err "
        f"{served[0]['max_abs_err']:.3g}")
    log(f"  decode_attention at qwen3-moe-30b-a3b's {dd['shape']} [{variant}]: kernel "
        f"{dd['ms']:.4f} ms{_passes(dd)}, "
        f"plain {dd['plain_ms']:.4f} ms, sdpa {dd['library_ms']:.4f} ms, bound "
        f"{dd['bound_ms']:.4f} ms ({dd['bound_by']})")
    return {"decode_attention": dd, "served_checks": served}


def ssd_bound(x, Bm, h0, chunk) -> dict:
    """Bytes: x and y, dt, A, B and C (one (B, S, 2N) tensor), h0 if given
    and the final state, each once.  Operations: per (b, h) and chunk of q
    positions, the causal halves of C·Bᵀ and w·(dt x), then C·h_in and the
    state's outer products, 2 operations per multiply-add."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    item = x.element_size()
    bytes_moved = (2 * x.numel() * item + b * s * h * 4 + h * 4 + 2 * b * s * n * item
                   + (1 + (h0 is not None)) * b * h * p * n * 4)
    q = min(chunk, s)
    lens = [q] * (s // q) + ([s % q] if s % q else [])
    ops = 2 * b * h * sum(ln * (ln + 1) // 2 * (n + p) + 2 * ln * n * p for ln in lens)
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def rglru_bound(a, h0) -> dict:
    """Bytes: a, b and h, and h0 if given; one float32 multiply-add a step."""
    bytes_moved = 3 * a.numel() * 4 + (0 if h0 is None else h0.numel() * 4)
    return _bound(bytes_moved, 2 * a.numel(), SIMT_OPS_PER_S)


def phase_scan_timing(ssd_args, rglru_args) -> dict:
    """The SSD and RG-LRU kernels against their plain versions on phase
    7(b)'s served inputs, then timed there beside their plain versions and
    bounds.  No single PyTorch call computes either function."""
    before = (ssd.LAUNCHES, rglru.LAUNCHES)
    rglru_variants = dict(rglru.LAUNCHES_BY_VARIANT)
    *sargs, chunk = ssd_args
    x, _dt, _A, Bm, _Cm, h0 = sargs
    a, bb, h0r = rglru_args
    served = compare_ssd("served prefill", sargs, chunk) + [{"kernel": "rglru_scan", **_compare(
        "rglru served prefill", a.dtype, rglru._dispatch(a, bb, h0r),
        rglru.rglru_scan_plain(a, bb, h0r), RGLRU_TOLERANCE)}]
    for r in served:
        log(f"  {r['label']} {r['dtype']}: max abs err {r['max_abs_err']:.3g}")
    s_ = {"shape": list(x.shape), "state": Bm.shape[-1], "chunk": chunk, "h0": h0 is not None,
          "dtype": str(x.dtype).replace("torch.", ""), "variant": ssd._variant(x.dtype)}
    # The mma variant's two passes apart: C·Bᵀ, then the per-head pass.
    s_["ms"], s_["cb_ms"], s_["per_head_ms"] = time_cold_parts_ms(
        lambda mid: ssd._dispatch(*ssd_args, mid_event=mid), reps=10)
    s_["plain_ms"] = time_cold_ms(lambda: ssd.ssd_scan_plain(*sargs, chunk=chunk), reps=5)
    s_.update(ssd_bound(x, Bm, h0, chunk))
    s_["library_ms"] = None
    r_ = {"shape": list(a.shape), "h0": h0r is not None, "dtype": "float32",
          "variant": rglru._variant(a.shape[2]),
          "lanes": rglru._lanes(a.shape[0], a.shape[2], torch.cuda.get_device_properties(
              0).multi_processor_count)}
    r_["ms"] = time_cold_ms(lambda: rglru._dispatch(a, bb, h0r), reps=20)
    # The other variant, and the other CTA width, forced on the same call.
    with forced_rglru(variant="cp_async"):
        r_["cp_async_ms"] = time_cold_ms(lambda: rglru._dispatch(a, bb, h0r), reps=20)
    other = 192 - r_["lanes"]
    with forced_rglru(lanes=other):
        r_[f"lanes_{other}_ms"] = time_cold_ms(lambda: rglru._dispatch(a, bb, h0r), reps=20)
    r_["plain_ms"] = time_cold_ms(lambda: rglru.rglru_scan_plain(a, bb, h0r), reps=3)
    r_.update(rglru_bound(a, h0r))
    r_["library_ms"] = None
    ssd.LAUNCHES, rglru.LAUNCHES = before  # timing launches are not the path's
    rglru.LAUNCHES_BY_VARIANT.update(rglru_variants)
    for name, t in (("ssd_scan", s_), ("rglru_scan", r_)):
        log(f"  {name} at {t['shape']} {t['dtype']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    log(f"  ssd_scan [{s_['variant']}] parts: C·Bᵀ {s_['cb_ms']:.4f} ms + per-head "
        f"{s_['per_head_ms']:.4f} ms")
    log(f"  rglru_scan [{r_['variant']}, {r_['lanes']} lanes] {r_['ms']:.4f} ms; cp_async "
        f"{r_['cp_async_ms']:.4f} ms; {other} lanes {r_[f'lanes_{other}_ms']:.4f} ms")
    return {"ssd_scan": s_, "rglru_scan": r_, "served_checks": served}


def gg_bound(x, w, offsets) -> dict:
    """Bytes: the kept rows of x and of the output, and the weights of every
    expert that has a row, each once.  Operations: 2·N·K·F over the kept
    rows, at the bf16 tensor-core peak in bf16."""
    k, f = w.shape[1:]
    item = x.element_size()
    bounds = offsets.cpu().numpy()
    n_kept = int(bounds[-1] - bounds[0])
    touched = int((np.diff(bounds) > 0).sum())
    bytes_moved = (n_kept * (k + f) + touched * k * f) * item
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return {**_bound(bytes_moved, 2 * n_kept * k * f, peak), "rows": n_kept,
            "experts_touched": touched}


def _grouped_mm_yardstick(x, w, offsets, want, n_kept, capacity_fallback):
    """``(name, fn, max abs err)`` of one library call for the same product:
    ``torch._grouped_mm`` on the ragged inputs where this PyTorch has it and
    runs it; else, where ``capacity_fallback``, one ``torch.bmm`` over the
    reference's (E, G·C, K) capacity buffer (qwen3-moe-30b-a3b's served
    prefill: 16 groups of capacity 20 an expert), which has no error to
    report; else ``(None, None, None)``."""
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is not None:
        ends = offsets[1:].contiguous()
        try:
            got = grouped_mm(x, w, offs=ends)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as exc:
            log(f"  torch._grouped_mm refused the served inputs: {str(exc).splitlines()[0]}")
        else:
            err = float((got[:n_kept].float() - want[:n_kept].float()).abs().max())
            return "torch._grouped_mm", lambda: grouped_mm(x, w, offs=ends), err
    if not capacity_fallback:
        return None, None, None
    e, k, _ = w.shape
    cfg = get_config("qwen3-moe-30b-a3b")
    tokens = SLOTS * PROMPT_TOKENS[cfg.name]
    groups = cfg.moe_dispatch_groups
    capacity = int(max(1, cfg.moe_capacity_factor * cfg.experts_per_token * tokens
                       / (cfg.num_experts * groups)))
    buf = torch.zeros((e, groups * capacity, k), dtype=x.dtype, device=x.device)
    buf[:, :capacity] = x[:capacity]
    return "torch.bmm over the capacity buffer", lambda: torch.bmm(buf, w), None


def _gg_served_timing(label, x, w, offsets, reps, other_flushes=()) -> tuple[dict, dict]:
    """One served grouped GEMM: held against its plain version, then timed
    beside it, its bound and a library yardstick; kernel and yardstick
    timed again under each of ``other_flushes`` (`FLUSHES`)."""
    want = gg.grouped_gemm_plain(x, w, offsets)
    variant, got = gg_launch(x, w, offsets)
    check = {"kernel": "grouped_gemm", "variant": variant, **_compare(
        f"grouped_gemm served {label} [{variant}]", x.dtype, got, want)}
    t = {"shape": [list(x.shape), list(w.shape)], "dtype": str(x.dtype).replace("torch.", ""),
         "variant": variant, **gg_bound(x, w, offsets)}
    t["ms"] = time_cold_ms(lambda: gg._dispatch(x, w, offsets), reps=reps)
    t["plain_ms"] = time_cold_ms(lambda: gg.grouped_gemm_plain(x, w, offsets), reps=5)
    name, fn, err = _grouped_mm_yardstick(x, w, offsets, want, t["rows"],
                                          capacity_fallback=label.startswith("prefill"))
    t["library"], t["library_max_abs_err"] = name, err
    t["library_ms"] = None if fn is None else time_cold_ms(fn, reps=reps)
    t["flushes"] = {flush: {
        "ms": time_cold_ms(lambda: gg._dispatch(x, w, offsets), reps=reps, flush=flush),
        "library_ms": None if fn is None else time_cold_ms(fn, reps=reps, flush=flush),
    } for flush in other_flushes}
    for flush, f in t["flushes"].items():
        log(f"  grouped_gemm {label}, {flush} flush: kernel {f['ms']:.4f} ms, "
            f"library {f['library_ms']} ms")
    lib = "no library call" if fn is None else f"{name} {t['library_ms']:.4f} ms"
    log(f"  grouped_gemm {label} at {t['shape']} {t['dtype']} [{variant}] ({t['rows']} kept "
        f"rows, {t['experts_touched']} experts): kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
        f"{t['bytes'] / 1e6:.1f} MB, {t['ops'] / 1e9:.2f} GFLOP)")
    return t, check


def phase_gg_timing(gg_args: dict) -> dict:
    """The grouped GEMM on phase 7(b)'s served inputs (qwen3-moe-30b-a3b's
    first gate and down products and first decode step's gate product, L2
    flushed): each held against its plain version, then timed; the decode
    product also with L2 flushed by reads only and not flushed."""
    before = gg.LAUNCHES, dict(gg.LAUNCHES_BY_VARIANT)
    rows, served = {}, []
    for label, reps, other_flushes in (("prefill gate", 10, ()), ("prefill down", 10, ()),
                                       ("decode gate", 50, ("read", "none"))):
        rows[label], check = _gg_served_timing(label, *gg_args[label], reps=reps,
                                               other_flushes=other_flushes)
        served.append(check)
        log(f"  {check['label']} {check['dtype']}: max abs err {check['max_abs_err']:.3g}")
    gg.LAUNCHES = before[0]  # timing launches are not the path's
    gg.LAUNCHES_BY_VARIANT.update(before[1])
    t = rows["prefill gate"]
    t["down"], t["decode"] = rows["prefill down"], rows["decode gate"]
    return {"grouped_gemm": t, "served_checks": served}


class ForcedRouting:
    """Around phase 8's two runs of a MoE model: the kernel run records its
    router's top-k choices, call by call; the plain run takes them (with
    its own probabilities at those choices) and counts the rows whose own
    choices differ, since routing is a discontinuous function of float32
    sums that the two runs take in another order."""

    def __init__(self):
        self.choices: list[torch.Tensor] = []
        self.flips = self.forced_calls = 0
        self._route = moe_lib._route

    def _recording(self, logits, k):
        out = self._route(logits, k)
        self.choices.append(out[2])
        return out

    def recording(self):
        moe_lib._route = self._recording
        return self

    def forcing(self):
        calls = iter(self.choices)

        def forced(logits, k):
            probs, _, own = self._route(logits, k)
            top_i = next(calls).to(own.device)
            self.forced_calls += 1
            self.flips += int((own.sort(-1).values != top_i.sort(-1).values).any(-1).sum())
            top_p = probs.gather(-1, top_i)
            return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_i

        moe_lib._route = forced
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        moe_lib._route = self._route


class KeptPairs:
    """Around phase 9 (c)'s steps of a MoE model: the kept (token, choice)
    pairs of every dispatch (`moe_lib._sort_pairs`), read from the device
    once the steps are done, which is what the grouped GEMMs and their
    backward take (the routing depends on the data)."""

    def __init__(self):
        self.kept: list[torch.Tensor] = []
        self.pairs = 0
        self._sort_pairs = moe_lib._sort_pairs

    def _recording(self, top_i, *args):
        out = self._sort_pairs(top_i, *args)
        self.kept.append(out[2][-1])
        self.pairs = top_i.numel()
        return out

    def summary(self) -> dict:
        kept = [int(k) for k in self.kept]
        return {"dispatches": len(kept), "pairs": self.pairs, "kept_min": min(kept),
                "kept_max": max(kept), "kept_mean": float(np.mean(kept))}

    def __enter__(self):
        moe_lib._sort_pairs = self._recording
        return self

    def __exit__(self, *exc):
        moe_lib._sort_pairs = self._sort_pairs


#: The kernels whose float32 calls all take their ``simt`` variant.
SIMT_FLOAT32 = ("flash_attention", "decode_attention", "ssd_scan")


def _model_logits(params, cfg, prompt, steps) -> list[torch.Tensor]:
    b, s = prompt.shape
    caches = tfm.init_serve_cache(cfg, b, s + steps.shape[1])
    logits, caches = tfm.forward_prefill(params, cfg, {"tokens": prompt}, caches)
    out = [logits]
    for t in range(steps.shape[1]):
        step, caches = tfm.forward_decode(params, cfg, steps[:, t:t + 1], s + t, caches)
        out.append(step)
    return out


def phase_model_vs_plain(arch: str) -> dict:
    """The full-width model in float32 (`MODEL_LAYERS` cuts the depth), one
    2 x prompt prefill and 8 decode steps, on the kernels and again with
    every kernel's dispatch patched to its plain version; the logits
    compared.  A MoE model's plain run takes the kernel run's expert
    choices (`ForcedRouting`)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype="float32",
                              num_layers=MODEL_LAYERS.get(arch, full.num_layers))
    prompt_tokens = PROMPT_TOKENS[arch]
    params = tfm.init_params(cfg, seed=1)
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, prompt_tokens))).cuda()
    steps = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 8))).cuda()
    before = _serve_counts()
    by_variant = {name: dict(VARIANT_KERNELS[name].LAUNCHES_BY_VARIANT) for name in SIMT_FLOAT32}
    with ForcedRouting().recording() as routing:
        t0 = time.perf_counter()
        kern = _model_logits(params, cfg, prompt, steps)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in _serve_counts().items()}
        if launched != expected_launches(cfg, waves=1, steps=8):
            raise AssertionError(f"float32 {arch}: launches {launched}")
        rose = {name: {n: VARIANT_KERNELS[name].LAUNCHES_BY_VARIANT[n] - c
                       for n, c in counts.items()} for name, counts in by_variant.items()}
        for name, r in rose.items():
            if r != {n: launched[name] if n == "simt" else 0 for n in r}:
                raise AssertionError(f"float32 {arch}: {name} variants {r}")
        saved = {name: mod._dispatch for name, (mod, _) in SERVE_KERNELS.items()}
        for name, (mod, _) in SERVE_KERNELS.items():
            mod._dispatch = PLAIN_DISPATCH[name]
        routing.forcing()
        try:
            t0 = time.perf_counter()
            plain = _model_logits(params, cfg, prompt, steps)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            for name, (mod, _) in SERVE_KERNELS.items():
                mod._dispatch = saved[name]
                mod.LAUNCHES = before[name]
            for name, counts in by_variant.items():
                VARIANT_KERNELS[name].LAUNCHES_BY_VARIANT.update(counts)
    moe_layers = cfg.layer_pattern.count("moe") * cfg.num_groups
    if len(routing.choices) != moe_layers * 9 or routing.forced_calls != moe_layers * 9:
        raise AssertionError(f"float32 {arch}: {len(routing.choices)} routings recorded, "
                             f"{routing.forced_calls} forced, for {moe_layers} MoE layers")
    errs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    for a in kern:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"float32 {arch}: non-finite logits")
    atol = MODEL_ATOL[arch]
    if max(errs) > atol:
        raise AssertionError(f"float32 {arch}: kernel vs plain logits differ by "
                             f"{max(errs):.3g} > {atol}")
    log(f"  float32 {arch} ({cfg.num_layers} layers), 2 x {prompt_tokens} prefill + 8 decode "
        f"steps: logits max abs diff kernel vs plain {errs[0]:.3g} (prefill), "
        f"{max(errs[1:]):.3g} (decode), atol {atol}; kernel path {kern_s:.2f} s, plain path "
        f"{plain_s:.2f} s" + (f"; {routing.flips} rows of {len(routing.choices)} routings "
                              f"would have chosen other experts on the plain path"
                              if moe_layers else ""))
    return {"layers": cfg.num_layers, "variants": rose,
            "prefill_max_abs_err": errs[0],
            "decode_max_abs_err": max(errs[1:]), "atol": atol, "kernel_path_s": kern_s,
            "plain_path_s": plain_s, "routing_flips": routing.flips}

# --------------------------------------------------------------- phase 9

#: (a) the backward kernel against its plain version: (label, B, S, H, KV,
#: D, window, softcap): internlm2-1.8b's attention at `TRAIN_SEQ`, gemma2-2b's
#: local layer (window 4096, softcap 50) and its global layer at 8192 tokens.
BWD_CASES = [
    ("internlm2-1.8b", 2, 4096, 16, 8, 128, None, None),
    ("gemma2-2b local", 1, 8192, 8, 4, 256, 4096, 50.0),
    ("gemma2-2b global", 1, 8192, 8, 4, 256, None, 50.0),
    ("recurrentgemma-9b local", 1, 4096, 16, 1, 256, 2048, None),
]
#: (a) the scans' backward kernels against their plain versions at the
#: training shapes: the SSD scan at mamba2-1.3b's (B, S, H, P, N, chunk),
#: bf16 (``mma``) and float32 (``simt``); the RG-LRU scan at
#: recurrentgemma-9b's (B, S, W), float32.  Their limits are defined beside
#: the kernels (`ssd.BWD_TOLERANCE`, `rglru.BWD_TOLERANCE`), where the card
#: tests read them too.
SSD_BWD_CASE = (2, 4096, 64, 64, 128, 128)
RGLRU_BWD_CASE = (1, 4096, 4096)
#: (a) the grouped GEMM's backward kernels at qwen3-moe-30b-a3b's training
#: call: the segments of a real routing of B 1 x S `GG_BWD_TOKENS` (its
#: router at init on N(0, 1) activations; 16 dispatch groups, capacity 20
#: an expert a group, 32,768 pairs, the dropped ones past the segments), at
#: the gate/up products' (K, F) and the down product's; and the same
#: segments with the experts `GG_BWD_EMPTY` left empty, their rows joining
#: the dropped tail.
GG_BWD_ARCH = "qwen3-moe-30b-a3b"
GG_BWD_TOKENS = 4096
GG_BWD_SHAPES = (("gate/up", 2048, 768), ("down", 768, 2048))
GG_BWD_EMPTY = (0, 5, 77, 127)
#: The backward against its plain version, relative to the largest |grad|
#: of dq, dk and dv: (atol as a share of it, rtol), the forward's limits
#: (defined beside the kernel, where the card tests read them too).  The
#: forward's lse against the plain logsumexp: float32 2e-5 absolute and
#: relative, both dtypes (the scores are float32 sums of the same products).
BWD_TOLERANCE = flash.BWD_TOLERANCE
LSE_TOLERANCE = (2e-5, 2e-5)
#: (b) internlm2-1.8b at full width cut to `TRAIN_PARITY_LAYERS` layers,
#: float32, on the card and on the CPU: every gradient leaf within
#: `TRAIN_ATOL` of its largest |grad| on the CPU, then one train step's
#: loss, grad norm and every updated weight within `TRAIN_ATOL` absolute
#: (the float32 model limit).  Adam's first step moves a weight by about
#: lr (1e-3), so the weights alone cannot tell a wrong gradient from a
#: right one of the same sign: the gradients are what hold the backward.
TRAIN_ARCH = "internlm2-1.8b"
#: One layer a config in (b) (two before phase 11 took their seconds).
TRAIN_PARITY_LAYERS = 1
TRAIN_PARITY_SEQ = 256
TRAIN_ATOL = 1e-3
#: recurrentgemma-9b cut in depth for training on one card: its 8.5 B
#: parameters with AdamW's float32 moments take some 100 GB before
#: activations, so it trains at full width with the paper's 2:1 mix of
#: RG-LRU and local-attention layers kept, (recurrent, recurrent, attention)
#: a group.
RG_TRAIN_CUT = dict(layer_pattern=("recurrent", "recurrent", "attention"),
                    window_pattern=(None, None, 2048))
#: (b) the configs held card against CPU, each at full width: (arch, its
#: cut).  internlm2-1.8b, mamba2-1.3b and qwen3-moe-30b-a3b at
#: `TRAIN_PARITY_LAYERS` layers, recurrentgemma-9b at one group of
#: `RG_TRAIN_CUT` (3 layers).  The MoE model's CPU runs take the card runs'
#: expert choices (`ForcedRouting`), as phase 8 does.
TRAIN_PARITY = {
    TRAIN_ARCH: dict(num_layers=TRAIN_PARITY_LAYERS),
    "mamba2-1.3b": dict(num_layers=TRAIN_PARITY_LAYERS),
    "recurrentgemma-9b": dict(RG_TRAIN_CUT, num_layers=3),
    "qwen3-moe-30b-a3b": dict(num_layers=TRAIN_PARITY_LAYERS),
}
#: qwen3-moe-30b-a3b's depth in (c), cut from 48 layers to fit one card's
#: 80 GB: a layer holds some 0.623 B parameters (604 M of them expert
#: stacks), 7.5 GB at 12 bytes each (a bf16 weight and its grad, two
#: float32 moments); the untied embedding and unembedding (151,936 words)
#: another 7.5 GB and the float32 logits 2.5 GB before their grad: 6
#: layers is some 52 GB of state.  grok-1-314b cannot train on one card at
#: any depth (4.8 B expert parameters a layer, some 58 GB of state for
#: one): it trains only in the CPU tests' smoke variant.
QWEN_TRAIN_LAYERS = 6
#: (b)'s configs held by their gradients alone, with no train step after:
#: qwen3-moe-30b-a3b's 1.2 B float32 parameters (1 layer, 151,936 words)
#: make an AdamW step on the CPU take some 50 s, which the 1,200 s limit
#: cannot spare, for the optimizer the other configs' steps already hold.
#: Its launch counts are read around the card's gradient call (one forward
#: and backward: a step's launches).
TRAIN_PARITY_GRADS_ONLY = ("qwen3-moe-30b-a3b",)
#: (c) bf16 with remat at `TRAIN_BATCH` x `TRAIN_SEQ` (train_4k's sequence,
#: the batch cut from 256 to fit one card), AdamW steps on one fixed batch
#: (make_batch seed 0): (arch, cut, batch, steps).  internlm2-1.8b and
#: mamba2-1.3b at full width and depth; recurrentgemma-9b at full width, its
#: depth cut from 38 layers to two groups of `RG_TRAIN_CUT` (6 layers), at
#: B 1; qwen3-moe-30b-a3b at full width, its depth cut to
#: `QWEN_TRAIN_LAYERS`, at B 1.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4096, 3, 1e-3
TRAIN_RUNS = {
    TRAIN_ARCH: (dict(), TRAIN_BATCH, TRAIN_STEPS),
    "mamba2-1.3b": (dict(), TRAIN_BATCH, TRAIN_STEPS),
    "recurrentgemma-9b": (dict(RG_TRAIN_CUT, num_layers=6), 1, 3),
    "qwen3-moe-30b-a3b": (dict(num_layers=QWEN_TRAIN_LAYERS), 1, 3),
}
#: (d) the launcher's smoke run.
LAUNCH_TRAIN_STEPS = 2
#: (e) gradient accumulation: micro-batches, and the limits on M's loss and
#: grad norm against one batch's (relative).
ACCUM_MICROBATCHES = 2
ACCUM_LOSS_RTOL, ACCUM_GNORM_RTOL = 1e-3, 1e-2


@contextlib.contextmanager
def local_mesh():
    """The launcher's (1, 1) mesh on the card, over a one-rank process
    group that is destroyed on leaving."""
    mesh = make_local_mesh("cuda")
    try:
        yield mesh
    finally:
        destroy_process_group()


def _bwd_reset() -> None:
    flash.BWD_LAUNCHES = 0
    for counts in (flash.BWD_PASSES, flash.BWD_LAUNCHES_BY_VARIANT):
        for k in counts:
            counts[k] = 0


def reset_train_counts() -> None:
    """Every launch count the training path reads, set to 0."""
    _bwd_reset()
    for mod in (flash, ssd, rglru, gg):
        mod.LAUNCHES = 0
        for k in mod.LAUNCHES_BY_VARIANT:
            mod.LAUNCHES_BY_VARIANT[k] = 0
    ssd.BWD_LAUNCHES = rglru.BWD_LAUNCHES = gg.BWD_LAUNCHES = 0
    for counts in (ssd.BWD_LAUNCHES_BY_VARIANT, rglru.BWD_LAUNCHES_BY_VARIANT,
                   gg.BWD_LAUNCHES_BY_VARIANT, gg.BWD_LAUNCHES_BY_DESIGN):
        for k in counts:
            counts[k] = 0


def train_counts() -> dict:
    """The training path's launch counts: each forward kernel and each
    backward kernel, by variant where it has them."""
    return {"flash_attention": flash.LAUNCHES,
            "flash_attention_by_variant": dict(flash.LAUNCHES_BY_VARIANT),
            "flash_attention_bwd": flash.BWD_LAUNCHES,
            "flash_attention_bwd_by_variant": dict(flash.BWD_LAUNCHES_BY_VARIANT),
            "flash_attention_bwd_passes": dict(flash.BWD_PASSES),
            "ssd_scan": ssd.LAUNCHES, "ssd_scan_by_variant": dict(ssd.LAUNCHES_BY_VARIANT),
            "ssd_scan_backward": ssd.BWD_LAUNCHES,
            "ssd_scan_backward_by_variant": dict(ssd.BWD_LAUNCHES_BY_VARIANT),
            "rglru_scan": rglru.LAUNCHES, "rglru_scan_backward": rglru.BWD_LAUNCHES,
            "grouped_gemm": gg.LAUNCHES, "grouped_gemm_by_variant": dict(gg.LAUNCHES_BY_VARIANT),
            "grouped_gemm_bwd": gg.BWD_LAUNCHES,
            "grouped_gemm_bwd_by_variant": dict(gg.BWD_LAUNCHES_BY_VARIANT),
            "grouped_gemm_bwd_by_design": dict(gg.BWD_LAUNCHES_BY_DESIGN)}


def expected_train_counts(cfg, steps: int, remat: bool) -> dict:
    """`train_counts` after ``steps`` train steps of ``cfg``: one launch of
    each layer's forward kernel a step (two with remat, which recomputes
    each group in the backward) and one of its backward kernel, on the
    variant of the model's dtype; a ``"moe"`` layer's attention counts as
    an attention layer's, and its experts are three grouped GEMMs a
    forward (gate, up, down) with a ``dx`` and a ``dw`` launch each in the
    backward, all on the design of the model's dtype (``wgmma`` for bf16,
    ``simt`` for float32)."""
    dtype = tfm.torch_dtype(cfg)
    kinds = [cfg.layer_pattern[i % len(cfg.layer_pattern)] for i in range(cfg.num_layers)]
    n_ssd, n_rec, n_moe = (kinds.count(k) for k in ("ssd", "recurrent", "moe"))
    n_attn = kinds.count("attention") + n_moe
    fwd = 2 if remat else 1
    gg_variant = gg._variant(cfg.d_model, cfg.d_ff, dtype)

    def by(variants, want, n):
        return {v: n if v == want else 0 for v in variants}

    return {"flash_attention": fwd * steps * n_attn,
            "flash_attention_by_variant": by(flash.LAUNCHES_BY_VARIANT, flash._variant(dtype),
                                             fwd * steps * n_attn),
            "flash_attention_bwd": steps * n_attn,
            "flash_attention_bwd_by_variant": by(flash.BWD_LAUNCHES_BY_VARIANT,
                                                 flash._variant(dtype), steps * n_attn),
            "flash_attention_bwd_passes": {k: steps * n_attn for k in flash.BWD_PASSES},
            "ssd_scan": fwd * steps * n_ssd,
            "ssd_scan_by_variant": by(ssd.LAUNCHES_BY_VARIANT, ssd._variant(dtype),
                                      fwd * steps * n_ssd),
            "ssd_scan_backward": steps * n_ssd,
            "ssd_scan_backward_by_variant": by(ssd.BWD_LAUNCHES_BY_VARIANT, ssd._variant(dtype),
                                               steps * n_ssd),
            "rglru_scan": fwd * steps * n_rec, "rglru_scan_backward": steps * n_rec,
            "grouped_gemm": 3 * fwd * steps * n_moe,
            "grouped_gemm_by_variant": by(gg.LAUNCHES_BY_VARIANT, gg_variant,
                                          3 * fwd * steps * n_moe),
            "grouped_gemm_bwd": 6 * steps * n_moe,
            "grouped_gemm_bwd_by_variant": {k: 3 * steps * n_moe
                                            for k in gg.BWD_LAUNCHES_BY_VARIANT},
            "grouped_gemm_bwd_by_design": by(gg.BWD_LAUNCHES_BY_DESIGN,
                                             gg._bwd_variant(cfg.d_model, cfg.d_ff, dtype),
                                             6 * steps * n_moe)}


def bwd_bound(q, k, window) -> dict:
    """Five products of 2 operations a multiply-add over the visible (query,
    key) pairs of each (b, h); q, k, v, o, dO, dq, dk, dv and lse moved once."""
    b, s, h, d = q.shape
    item = q.element_size()
    i = np.arange(s)
    pairs = int(np.minimum(i + 1, window).sum() if window else (i + 1).sum())
    ops = 10 * b * h * d * pairs
    bytes_moved = 4 * q.numel() * item + 4 * k.numel() * item + b * h * s * 4
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def _compare_grads(label, dtype, got, want) -> dict:
    """dq, dk, dv against the plain backward, each within `BWD_TOLERANCE`
    relative to the largest |grad| of the three."""
    torch.cuda.synchronize()
    share, rtol = BWD_TOLERANCE[dtype]
    errs = {}
    scale = max(float(w.float().abs().max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} {dtype} {name}: non-finite kernel gradient")
        err = float((g.float() - w.float()).abs().max())
        if not torch.allclose(g.float(), w.float(), atol=share * scale, rtol=rtol):
            raise AssertionError(f"{label} {dtype} {name}: kernel vs plain max abs err "
                                 f"{err:.3g} outside {share} x {scale:.3g} + rtol {rtol}")
        errs[name] = {"max_abs_err": err, "max_abs_want": float(w.float().abs().max())}
    return {"label": label, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "grads": errs}


def _sdpa_backward(q, k, v, do, forward=_sdpa_causal):
    """One library call's backward (``forward``: SDPA, causal GQA) on (B, S,
    H, D), for timing: returns a function computing dq, dk, dv of a kept
    graph."""
    qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
    out = forward(qt, kt, vt)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), do, retain_graph=True)


def sdpa_window_yardstick(q, k, v, do, window, want, reps: int = 5) -> dict:
    """``library_ms`` where a window binds and no softcap applies: the
    backward of one SDPA call with the causal window as a boolean mask, its
    largest difference from ``want`` (the plain dq, dk, dv); where SDPA
    refuses the shape, None and ``library_error``."""
    out = {"library": "scaled_dot_product_attention, window as a boolean mask"}
    s = q.shape[1]
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def forward(q_, k_, v_):
        o = F.scaled_dot_product_attention(q_.transpose(1, 2), k_.transpose(1, 2),
                                           v_.transpose(1, 2), attn_mask=mask, enable_gqa=True)
        return o.transpose(1, 2)

    try:
        call = _sdpa_backward(q, k, v, do, forward)
        out["library_max_abs_err"] = max(float((g.float() - w.float()).abs().max())
                                         for g, w in zip(call(), want))
        out["library_ms"] = time_cold_ms(call, reps=reps)
    except Exception as e:  # a yardstick's refusal is a reading, not a failure of the port
        out["library_ms"] = None
        out["library_error"] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
        log(f"    SDPA refused: {out['library_error']}")
    torch.cuda.empty_cache()
    return out


def phase_backward_vs_plain() -> tuple[list, dict]:
    """(a): at each `BWD_CASES` shape in bf16 and float32, the forward's lse
    against the plain logsumexp and the backward kernel against
    `flash_attention_backward_plain` on the same q, k, v, o, lse, dO; each
    timed cold, whole and by pass, beside its bound and its plain version,
    and beside a library call's backward: SDPA's where it computes the
    same function (no window, no softcap: internlm2-1.8b's shape),
    compiled flex_attention's with the softcap (gemma2-2b's shapes), in
    both types.  Each call is counted on the variant `_variant` picks for
    its type."""
    rng = np.random.RandomState(9)
    checks, timing = [], {}
    for label, b, s, h, kv, d, window, cap in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (_normal(rng, (b, s, n, d), dtype) for n in (h, kv, kv, h))
            out, lse = flash._dispatch(q, k, v, window, cap, with_lse=True)
            want_o, want_lse = flash.flash_attention_plain(q, k, v, window=window,
                                                           logit_softcap=cap, return_lse=True)
            checks.append({"kernel": "flash_attention", **_compare(
                f"flash forward {label}", dtype, out, want_o)})
            checks.append({"kernel": "flash_attention_lse", **_compare(
                f"flash lse {label}", dtype, lse, want_lse, tol=LSE_TOLERANCE)})
            del want_o, want_lse
            variant = flash._variant(dtype)
            before = (flash.BWD_LAUNCHES, dict(flash.BWD_PASSES),
                      dict(flash.BWD_LAUNCHES_BY_VARIANT))
            got = flash._dispatch_bwd(q, k, v, out, lse, do, window, cap)
            if flash.BWD_LAUNCHES != before[0] + 1 or any(
                    flash.BWD_PASSES[n] != before[1][n] + 1 for n in flash.BWD_PASSES):
                raise AssertionError(f"backward {label}: launches not counted")
            if flash.BWD_LAUNCHES_BY_VARIANT != {**before[2], variant: before[2][variant] + 1}:
                raise AssertionError(f"backward {label} {dtype}: not one {variant} launch: "
                                     f"{before[2]} -> {flash.BWD_LAUNCHES_BY_VARIANT}")
            want = flash.flash_attention_backward_plain(q, k, v, out, lse, do, window=window,
                                                        logit_softcap=cap)
            check = {"kernel": "flash_attention_bwd", "variant": variant,
                     **_compare_grads(f"flash backward {label}", dtype, got, want)}
            del got
            args = (q, k, v, out, lse, do, window, cap)
            t = {"shape": [b, s, h, d], "kv_heads": kv, "window": window, "softcap": cap,
                 "variant": variant, **bwd_bound(q, k, window)}
            t["ms"], t["dot_dkdv_ms"], t["dq_ms"] = time_cold_parts_ms(
                lambda mid: flash._dispatch_bwd(*args, events=(None, mid)), reps=5)
            t["plain_ms"] = time_cold_ms(lambda: flash.flash_attention_backward_plain(
                q, k, v, out, lse, do, window=window, logit_softcap=cap), reps=2)
            if window is None and cap is None:
                t["library"] = "scaled_dot_product_attention"
                t["library_ms"] = time_cold_ms(_sdpa_backward(q, k, v, do), reps=5)
            elif cap is None:
                t.update(sdpa_window_yardstick(q, k, v, do, window, want))
            else:
                t.update(flex_yardstick(lambda fn: _sdpa_backward(q, k, v, do, fn), window,
                                        cap, s, want))
            del want
            key = f"{label} {str(dtype).replace('torch.', '')}"
            timing[key] = t
            check["timing"] = key
            checks.append(check)
            log(f"  {key} [{variant}]: lse err {checks[-2]['max_abs_err']:.3g}, grads err "
                f"{check['max_abs_err']:.3g} (largest |grad| "
                f"{max(g['max_abs_want'] for g in check['grads'].values()):.3g}); "
                f"{t['ms']:.3f} ms (D+dk/dv {t['dot_dkdv_ms']:.3f}, dq {t['dq_ms']:.3f}), "
                f"plain {t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} ({t['bound_by']})"
                + ("" if t["library_ms"] is None else
                   f", {t['library']} backward {t['library_ms']:.3f}")
                + (f", {t['library_error']}" if "library_error" in t else ""))
            del q, k, v, do, out, lse, args
            torch.cuda.empty_cache()
    return checks, timing


def ssd_bwd_bound(x, Bm, chunk) -> dict:
    """Bytes: x, dy and dx; dt and d(dt); A and dA; B, C, dB and dC, each
    once.  Operations, 2 a multiply-add, for each chunk of L positions: the
    causal half of C·Bᵀ once a batch row; per head the causal halves of
    dy·xᵀ, Wᵀ·dy, Mᵀ·C and M·B, and five products of the chunk's L rows
    with the (P, N) state (the states entering the chunks, recomputed; xᵀG;
    B·Gᵀ; dy·h_in; G's update)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    item = x.element_size()
    bytes_moved = (3 * x.numel() * item + 2 * b * s * h * 4 + 2 * h * 4
                   + 4 * b * s * n * item)
    q = min(chunk, s)
    lens = [q] * (s // q) + ([s % q] if s % q else [])
    tri = sum(ln * (ln + 1) // 2 for ln in lens)
    ops = 2 * (b * tri * n + b * h * (tri * (2 * p + 2 * n) + 5 * s * p * n))
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return _bound(bytes_moved, ops, peak)


def rglru_bwd_bound(a) -> dict:
    """Bytes: a, h and dh read, da and db written, once each; three float32
    operations a step and lane (g's multiply-add, da's product)."""
    return _bound(5 * a.numel() * 4, 3 * a.numel(), SIMT_OPS_PER_S)


def _compare_scan_grads(label, dtype, names, got, want, tol) -> dict:
    """Each gradient against the plain version's, within ``tol`` = (atol as
    a share of that gradient's largest magnitude, rtol)."""
    torch.cuda.synchronize()
    share, rtol = tol
    errs = {}
    for name, g, w in zip(names, got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} {dtype} {name}: non-finite kernel gradient")
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        if not torch.allclose(g.float(), w.float(), atol=share * scale, rtol=rtol):
            raise AssertionError(f"{label} {dtype} {name}: kernel vs plain max abs err "
                                 f"{err:.3g} outside {share} x {scale:.3g} + rtol {rtol}")
        errs[name] = {"max_abs_err": err, "max_abs_want": scale}
    return {"label": label, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "grads": errs}


def phase_scan_backward_vs_plain() -> tuple[list, dict]:
    """(a): the SSD scan's backward at `SSD_BWD_CASE` in bf16 and float32 and
    the RG-LRU scan's at `RGLRU_BWD_CASE`, each against its plain version
    on the same inputs (dt and A over mamba2-1.3b's init ranges, a as the
    gates make it), counted on the variant `_variant` picks, repeated bit
    for bit, and timed cold beside its bound and its plain version (the
    SSD's launches, `ssd.BWD_PASSES`, apart).  No PyTorch call
    computes either function."""
    rng = np.random.RandomState(12)
    checks, timing = [], {}
    b, s, h, p, n, chunk = SSD_BWD_CASE
    for dtype in (torch.bfloat16, torch.float32):
        x, dy = _normal(rng, (b, s, h, p), dtype), _normal(rng, (b, s, h, p), dtype)
        dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, s, h)).astype(np.float32)).cuda()
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        bc = (0.5 * _normal(rng, (b, s, 2 * n), torch.float32)).to(dtype)
        Bm, Cm = bc[..., :n], bc[..., n:]
        args = (x, dt, A, Bm, Cm, dy, chunk)
        variant = ssd._variant(dtype)
        before = dict(ssd.BWD_LAUNCHES_BY_VARIANT)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        got = ssd._dispatch_bwd(*args)
        torch.cuda.synchronize()
        call_bytes = torch.cuda.max_memory_allocated() - held
        # The heads' float32 partials of dB and dC would take this alone.
        partial_bytes = 2 * b * h * s * n * 4
        if variant == "mma" and call_bytes >= partial_bytes:
            raise AssertionError(f"ssd backward bf16 took {call_bytes} bytes, as much as the "
                                 f"heads' partials of dB and dC ({partial_bytes})")
        if ssd.BWD_LAUNCHES_BY_VARIANT != {**before, variant: before[variant] + 1}:
            raise AssertionError(f"ssd backward {dtype}: not one {variant} launch: {before} -> "
                                 f"{ssd.BWD_LAUNCHES_BY_VARIANT}")
        want = ssd.ssd_scan_backward_plain(x, dt, A, Bm, Cm, dy, chunk=chunk)
        check = {"kernel": "ssd_scan_backward", "variant": variant, **_compare_scan_grads(
            "ssd backward mamba2-1.3b", dtype, ("dx", "ddt", "dA", "dBm", "dCm"), got, want,
            ssd.BWD_TOLERANCE[dtype])}
        del want
        if not all(torch.equal(g, r) for g, r in zip(got, ssd._dispatch_bwd(*args))):
            raise AssertionError(f"ssd backward {dtype}: a repeat differs")
        del got
        t = {"shape": [b, s, h, p], "state": n, "chunk": chunk, "variant": variant,
             "call_bytes": call_bytes, "partial_bytes": partial_bytes,
             **ssd_bwd_bound(x, Bm, chunk)}
        passes = ssd.BWD_PASSES[variant]
        t["ms"], parts = time_cold_launches_ms(
            lambda marks: ssd._dispatch_bwd(*args, events=marks), len(passes), reps=5)
        t["passes_ms"] = dict(zip(passes, parts))
        t["plain_ms"] = time_cold_ms(lambda: ssd.ssd_scan_backward_plain(
            x, dt, A, Bm, Cm, dy, chunk=chunk), reps=2)
        t["library_ms"] = None
        key = f"ssd_scan_backward {str(dtype).replace('torch.', '')}"
        timing[key] = t
        check["timing"] = key
        checks.append(check)
        log(f"  {key} [{variant}] at {t['shape']} N {n} chunk {chunk}: grads err "
            + ", ".join(f"{k} {e['max_abs_err']:.3g}/{e['max_abs_want']:.3g}"
                        for k, e in check["grads"].items())
            + f"; bit-equal repeat; {t['ms']:.3f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in t["passes_ms"].items())
            + f"), plain {t['plain_ms']:.3f}, bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']})")
        del x, dy, dt, A, bc, Bm, Cm, args
        torch.cuda.empty_cache()
    b, s, w = RGLRU_BWD_CASE
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    a = torch.sigmoid(_normal(rng, (b, s, w), torch.float32) + 2.0)
    bb = _normal(rng, (b, s, w), torch.float32)
    h_ = rglru._dispatch(0.3 * a, bb, None)
    dh = _normal(rng, (b, s, w), torch.float32)
    seg, split_lanes = rglru._split(b, s, w, n_sms)
    variant = rglru._bwd_variant(w, seg)
    want = rglru.rglru_scan_backward_plain(a, h_, dh)
    t = {"shape": [b, s, w], "dtype": "float32", "variant": variant, "seg": seg,
         "segment_steps": rglru.segment_steps(s, seg), "split_lanes": split_lanes,
         "clusters": rglru.split_clusters(seg, rglru.segment_steps(s, seg)),
         "lanes": rglru._lanes(b, w, n_sms), **rglru_bwd_bound(a)}
    # The variant the shape picks, then the walk forced at its own width and
    # at 32 lanes, each against the plain version and repeated bit for bit.
    for key, forced in (("ms", None), ("walk_ms", dict(_bwd_variant=lambda *x: "walk")),
                        ("walk_32_ms", dict(_bwd_variant=lambda *x: "walk",
                                            _lanes=lambda *x: 32))):
        with Patched(rglru, **(forced or {})):
            name = "walk" if forced else variant
            before = dict(rglru.BWD_LAUNCHES_BY_VARIANT)
            got = rglru._dispatch_bwd(a, h_, dh)
            if rglru.BWD_LAUNCHES_BY_VARIANT != {**before, name: before[name] + 1}:
                raise AssertionError(f"rglru backward: not one {name} launch: {before} -> "
                                     f"{rglru.BWD_LAUNCHES_BY_VARIANT}")
            label = (f"rglru backward recurrentgemma-9b [{name}"
                     + (", 32 lanes]" if key == "walk_32_ms" else "]"))
            check = {"kernel": "rglru_scan_backward", "variant": name, **_compare_scan_grads(
                label, torch.float32, ("da", "db"), got, want, rglru.BWD_TOLERANCE)}
            if not all(torch.equal(g, r) for g, r in zip(got, rglru._dispatch_bwd(a, h_, dh))):
                raise AssertionError(f"{label}: a repeat differs")
            del got
            t[key] = time_cold_ms(lambda: rglru._dispatch_bwd(a, h_, dh), reps=20)
        if not forced:
            check["timing"] = "rglru_scan_backward"
        checks.append(check)
        log(f"  {label}: grads err "
            + ", ".join(f"{k} {e['max_abs_err']:.3g}/{e['max_abs_want']:.3g}"
                        for k, e in check["grads"].items())
            + f"; bit-equal repeat; {t[key]:.4f} ms")
    del want
    t["plain_ms"] = time_cold_ms(lambda: rglru.rglru_scan_backward_plain(a, h_, dh), reps=2)
    t["library_ms"] = None
    # The forward at the training shape (a measurement: its ring was tuned
    # at the served B 4), at `_lanes`'s width and at 128 lanes.
    before = (rglru.LAUNCHES, dict(rglru.LAUNCHES_BY_VARIANT))
    fwd = {"variant": rglru._variant(w), "lanes": rglru._lanes(b, w, n_sms),
           **rglru_bound(a, None)}
    fwd["ms"] = time_cold_ms(lambda: rglru._dispatch(a, bb, None), reps=20)
    with forced_rglru(lanes=128):
        fwd["lanes_128_ms"] = time_cold_ms(lambda: rglru._dispatch(a, bb, None), reps=20)
    rglru.LAUNCHES = before[0]
    rglru.LAUNCHES_BY_VARIANT.update(before[1])
    t["forward"] = fwd
    timing["rglru_scan_backward"] = t
    log(f"  rglru_scan_backward at {t['shape']} [{variant}: {seg} segments of "
        f"{t['segment_steps']} steps, {split_lanes} lanes a CTA, {t['clusters']} clusters] "
        f"{t['ms']:.4f} ms; walk "
        f"({t['lanes']} lanes) {t['walk_ms']:.4f} ms, 32 lanes {t['walk_32_ms']:.4f} ms; plain "
        f"{t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} ({t['bound_by']}); forward "
        f"[{fwd['variant']}, {fwd['lanes']} lanes] {fwd['ms']:.4f} ms, 128 lanes "
        f"{fwd['lanes_128_ms']:.4f} ms, bound {fwd['bound_ms']:.4f}")
    del a, bb, h_, dh
    torch.cuda.empty_cache()
    return checks, timing


def gg_training_routing() -> tuple[torch.Tensor, int, int]:
    """(a)'s segments: ``(offsets, pairs, kept pairs)`` of `GG_BWD_ARCH`'s
    routing of `GG_BWD_TOKENS` tokens, the way `moe_lib.moe_ffn` sorts
    them: its router at init (seed 0) on N(0, 1) activations (the scale
    of the normed residual stream), 16 dispatch groups at capacity 20."""
    cfg = get_config(GG_BWD_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    router = init_dense(gen, cfg.d_model, cfg.num_experts, torch.float32)
    x = torch.randn((GG_BWD_TOKENS, cfg.d_model), generator=gen, device="cuda")
    _, _, top_i = moe_lib._route(x @ router, cfg.experts_per_token)
    groups = cfg.moe_dispatch_groups
    capacity = int(max(1, cfg.moe_capacity_factor * cfg.experts_per_token * GG_BWD_TOKENS
                       / (cfg.num_experts * groups)))
    keep, order, offsets = moe_lib._sort_pairs(top_i, cfg.num_experts, capacity, groups)
    if (capacity, order.numel()) != (20, 32_768):
        raise AssertionError(f"(a) routing: capacity {capacity}, {order.numel()} pairs")
    return offsets, order.numel(), int(keep.sum())


def gg_bwd_bound(kernel, x, w, offsets) -> dict:
    """``dx``: dy's kept rows and the weights of every expert that has a
    row read, all of dx written (its zero rows too); ``dw``: x's and dy's
    kept rows read, every expert's dw written.  2·N·K·F operations over
    the kept rows, at the bf16 tensor-core peak in bf16."""
    e, k, f = w.shape
    item = x.element_size()
    bounds = offsets.cpu().numpy()
    n_kept = int(bounds[-1] - bounds[0])
    touched = int((np.diff(bounds) > 0).sum())
    if kernel == "dx":
        bytes_moved = (n_kept * f + touched * k * f + x.shape[0] * k) * item
    else:
        bytes_moved = (n_kept * (k + f) + e * k * f) * item
    peak = BF16_FLOPS_PER_S if x.dtype == torch.bfloat16 else SIMT_OPS_PER_S
    return {**_bound(bytes_moved, 2 * n_kept * k * f, peak), "rows": n_kept,
            "experts_touched": touched}


def gg_bwd_launch(kernel, x, w, offsets, dy, variant=None) -> torch.Tensor:
    """One backward kernel through `gg._dispatch_bwd` (``variant`` forces a
    design; None: the one `gg._bwd_variant` picks), checked to have
    launched once, on that design; dx's rows outside every segment checked
    zero."""
    design = variant or gg._bwd_variant(w.shape[1], w.shape[2], x.dtype)
    before = (dict(gg.BWD_LAUNCHES_BY_VARIANT), dict(gg.BWD_LAUNCHES_BY_DESIGN))
    dx, dw = gg._dispatch_bwd(x, w, offsets, dy, need_dx=kernel == "dx",
                              need_dw=kernel == "dw", variant=variant)
    torch.cuda.synchronize()
    rose = {v: gg.BWD_LAUNCHES_BY_VARIANT[v] - before[0][v] for v in before[0]}
    rose_design = {v: gg.BWD_LAUNCHES_BY_DESIGN[v] - before[1][v] for v in before[1]}
    if rose != {v: int(v == kernel) for v in before[0]} or rose_design != {
            v: int(v == design) for v in before[1]}:
        raise AssertionError(f"grouped_gemm backward: expected one {kernel} launch on "
                             f"{design}, counted {rose}, {rose_design}")
    if kernel == "dw":
        return dw
    lo, hi = int(offsets[0]), int(offsets[-1])
    if bool(dx[:lo].any()) or bool(dx[hi:].any()):
        raise AssertionError("grouped_gemm backward dx: rows outside the segments not zero")
    return dx


def _grouped_mm_bwd_yardstick(kernel, x, w, offsets, dy, want, n_kept) -> dict:
    """``torch._grouped_mm`` for the same product, where this PyTorch has
    it and takes the layout: ``dx`` as ``(dy, wᵀ)`` with the segments'
    ends as offsets, ``dw`` as ``(xᵀ, dy)`` with them on the contraction;
    where it refuses, ``library_ms`` None and its message."""
    out = {"library": "torch._grouped_mm", "library_ms": None}
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        out["library_error"] = "this PyTorch has no torch._grouped_mm"
        return out
    ends = offsets[1:].contiguous()
    if kernel == "dx":
        def call():
            return grouped_mm(dy, w.transpose(-2, -1), offs=ends)
    else:
        def call():
            return grouped_mm(x.t(), dy, offs=ends)
    try:
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as exc:
        out["library_error"] = f"{type(exc).__name__}: {str(exc).strip().splitlines()[0][:300]}"
        log(f"    torch._grouped_mm refused {kernel}: {out['library_error']}")
        return out
    if kernel == "dx":
        got, want = got[:n_kept], want[:n_kept]
    out["library_max_abs_err"] = float((got.float() - want.float()).abs().max())
    del got
    out["library_ms"] = time_cold_ms(call, reps=5)
    return out


def phase_gg_backward_vs_plain() -> tuple[list, dict]:
    """(a): the grouped GEMM's ``dx`` and ``dw`` kernels on (a)'s routing
    (`gg_training_routing`) at each `GG_BWD_SHAPES` product, in bf16 (on
    ``wgmma``, and on ``simt`` forced) and float32 (``simt``), against
    `grouped_gemm_backward_plain` at the forward's limits (`TOLERANCE`),
    each launch counted on its design, repeated bit for bit; each timed
    cold beside its bound, its plain version and ``torch._grouped_mm``, the
    bf16 ``wgmma`` launch in turns with ``simt`` forced on the same inputs
    (wgmma, simt, simt, wgmma); then the same with the experts
    `GG_BWD_EMPTY` left empty (their dw zero).  Both limits are for outputs
    of O(1), so each kernel's dy makes its output O(1): N(0, K/F) for dx (w
    is N(0, 1/K)), N(0, 1/m) for dw (x is N(0, 1)), m the mean rows of a
    non-empty segment."""
    offsets, pairs, kept = gg_training_routing()
    counts = np.diff(offsets.cpu().numpy())
    mean_rows = float(counts[counts > 0].mean())
    cut = counts.copy()
    cut[list(GG_BWD_EMPTY)] = 0
    empty = torch.from_numpy(np.concatenate([[0], np.cumsum(cut)]).astype(np.int32)).cuda()
    log(f"  grouped GEMM backward: {pairs} pairs, {kept} kept over {int((counts > 0).sum())} "
        f"experts ({int(counts.min())}-{int(counts.max())} rows, mean {mean_rows:.1f}); the "
        f"cut case leaves experts {GG_BWD_EMPTY} empty ({int(cut.sum())} kept)")
    gen = torch.Generator(device="cuda").manual_seed(13)
    checks, timing = [], {}
    e_n = len(counts)
    for label, k, f in GG_BWD_SHAPES:
        x32 = torch.randn((pairs, k), generator=gen, device="cuda")
        w32 = torch.randn((e_n, k, f), generator=gen, device="cuda") / np.sqrt(k)
        dy32 = {"dx": torch.randn((pairs, f), generator=gen, device="cuda") * np.sqrt(k / f),
                "dw": torch.randn((pairs, f), generator=gen, device="cuda") / np.sqrt(mean_rows)}
        for dtype in (torch.bfloat16, torch.float32):
            x, w = x32.to(dtype), w32.to(dtype)
            dys = {kernel: dy.to(dtype) for kernel, dy in dy32.items()}
            name = str(dtype).replace("torch.", "")
            design = gg._bwd_variant(k, f, dtype)
            designs = [design] + (["simt"] if design != "simt" else [])
            for case, offs in (("routing", offsets), ("empty experts", empty)):
                for kernel in ("dx", "dw"):
                    dy = dys[kernel]
                    want = gg.grouped_gemm_backward_plain(
                        x, w, offs, dy, need_dx=kernel == "dx",
                        need_dw=kernel == "dw")[0 if kernel == "dx" else 1]
                    errs = {}
                    for variant in designs:
                        got = gg_bwd_launch(kernel, x, w, offs, dy, variant)
                        check = {"kernel": f"grouped_gemm_bwd_{kernel}", "case": case,
                                 "variant": variant, **_compare(
                                     f"grouped_gemm backward {kernel} {label} ({case}) "
                                     f"[{variant}]", dtype, got, want)}
                        if not torch.equal(got, gg_bwd_launch(kernel, x, w, offs, dy, variant)):
                            raise AssertionError(f"{check['label']} {dtype}: a repeat differs")
                        if kernel == "dw":
                            bounds = offs.cpu().numpy()
                            for ex in np.flatnonzero(np.diff(bounds) == 0):
                                if bool(got[ex].any()):
                                    raise AssertionError(f"{check['label']}: empty expert "
                                                         f"{ex}'s dw is not zero")
                        checks.append(check)
                        errs[variant] = check["max_abs_err"]
                        log(f"  {check['label']} {name}: max abs err "
                            f"{check['max_abs_err']:.3g} (largest {check['max_abs_want']:.3g}); "
                            "bit-equal repeat")
                        del got
                    if case != "routing":
                        del want
                        continue
                    t = {"shape": [pairs, k, f], "dtype": name, "mean_rows": mean_rows,
                         "variant": design, **gg_bwd_bound(kernel, x, w, offs)}
                    need = dict(need_dx=kernel == "dx", need_dw=kernel == "dw")

                    def run(variant):
                        return time_cold_ms(lambda: gg._dispatch_bwd(
                            x, w, offs, dy, **need, variant=variant), reps=5)

                    if design == "simt":
                        t["ms"] = run(design)
                    else:  # in turns with simt forced on the same inputs
                        turns = [(v, run(v)) for v in (design, "simt", "simt", design)]
                        t["ms"] = float(np.mean([ms for v, ms in turns if v == design]))
                        t["simt_ms"] = float(np.mean([ms for v, ms in turns if v == "simt"]))
                        t["turns_ms"] = [[v, ms] for v, ms in turns]
                        t["simt_max_abs_err"] = errs["simt"]
                    t["max_abs_err"] = errs[design]
                    t["plain_ms"] = time_cold_ms(lambda: gg.grouped_gemm_backward_plain(
                        x, w, offs, dy, **need), reps=2)
                    t.update(_grouped_mm_bwd_yardstick(kernel, x, w, offs, dy, want, t["rows"]))
                    key = f"{kernel} {label} {name}"
                    timing[key] = t
                    checks[-len(designs)]["timing"] = key
                    lib = ("none" if t["library_ms"] is None else
                           f"{t['library_ms']:.4f} ms")
                    simt = (f", simt forced {t['simt_ms']:.4f} (turns "
                            + ", ".join(f"{v} {ms:.4f}" for v, ms in t["turns_ms"]) + ")"
                            if "simt_ms" in t else "")
                    log(f"  grouped_gemm_bwd {key} [{design}]: {t['ms']:.4f} ms{simt}, plain "
                        f"{t['plain_ms']:.4f}, torch._grouped_mm {lib}, bound "
                        f"{t['bound_ms']:.4f} ({t['bound_by']}, {t['bytes'] / 1e6:.1f} MB, "
                        f"{t['ops'] / 1e9:.1f} GFLOP)")
                    del want
            del x, w, dys
            torch.cuda.empty_cache()
        del x32, w32, dy32
        torch.cuda.empty_cache()
    return checks, timing


def _train_cfg(arch=TRAIN_ARCH, **updates):
    return dataclasses.replace(get_config(arch), **updates)


def _one_step(cfg, model, batch, opt_cfg, device) -> dict:
    """One `train` step of ``model`` (updated in place) on ``device``: its
    history row."""
    state = {"params": model, "opt": init_opt_state(param_leaves(cfg, model))}
    _, history = train(cfg, iter([batch]), steps=1, opt_cfg=opt_cfg, log_fn=lambda line: None,
                       device=device, state=state)
    return history[-1]


def _leaf_grads(cfg, model, batch, device) -> dict:
    """``{reference path: [gradient, ...]}`` of `loss_fn` at ``model`` on
    ``batch``; the model's gradients are cleared after."""
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    total, _ = tfm.loss_fn(model, cfg, batch_to_device(batch, device))
    total.backward()
    grads = {path: [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                    for p in ([leaf] if isinstance(leaf, torch.Tensor) else leaf)]
             for path, leaf in param_leaves(cfg, model).items()}
    model.zero_grad(set_to_none=True)
    return grads


def _card_vs_cpu_step(arch, cfg, card_model, cpu_model, batch, card_then_cpu) -> dict:
    """(b)'s train step: one `train` step on the card, its launches
    counted, then on the CPU; loss, grad norm and every updated weight
    within `TRAIN_ATOL`."""
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    init = [p.detach().clone() for p in cpu_model.parameters()]
    timed = {}

    def step_on(device, model):
        if device == "cuda":
            reset_train_counts()
        t0 = time.perf_counter()
        row = _one_step(cfg, model, batch, opt_cfg, device)
        timed[device] = time.perf_counter() - t0
        if device == "cuda":
            timed["counts"] = train_counts()
        return row

    card, cpu = card_then_cpu(lambda: step_on("cuda", card_model),
                              lambda: step_on("cpu", cpu_model))
    expected = expected_train_counts(cfg, 1, remat=False)
    if timed["counts"] != expected:
        raise AssertionError(f"(b) {arch} step: launches {timed['counts']}, expected {expected}")
    # What the weights check would read had the card left every weight as it was.
    unchanged = max(float((p.detach() - w).abs().max())
                    for p, w in zip(cpu_model.parameters(), init))
    del init
    for key in ("loss", "grad_norm"):
        if abs(card[key] - cpu[key]) > TRAIN_ATOL:
            raise AssertionError(f"(b) {arch} {key}: card {card[key]} vs CPU {cpu[key]}")
    worst, worst_path = 0.0, ""
    cpu_leaves = param_leaves(cfg, cpu_model)
    for path, leaf in param_leaves(cfg, card_model).items():
        pairs = ([(leaf, cpu_leaves[path])] if isinstance(leaf, torch.Tensor)
                 else zip(leaf, cpu_leaves[path]))
        for a, b_ in pairs:
            err = float((a.detach().cpu() - b_.detach()).abs().max())
            if err > worst:
                worst, worst_path = err, path
    if worst > TRAIN_ATOL:
        raise AssertionError(f"(b) {arch} updated weight {worst_path}: card vs CPU {worst:.3g}")
    return {"card": card, "cpu": cpu, "step_launches": timed["counts"],
            "max_weight_err": worst, "max_weight_err_leaf": worst_path,
            "unchanged_weight_reading": unchanged, "card_s": timed["cuda"],
            "cpu_s": timed["cpu"]}


def train_card_vs_cpu(arch: str) -> dict:
    """(b): ``arch`` at full width, cut as `TRAIN_PARITY` says, float32, on
    the card and on the CPU from the same weights and batch: every gradient
    leaf of `loss_fn`, its launches counted on the ``simt`` variants, then
    (unless `TRAIN_PARITY_GRADS_ONLY`) one `train` step's loss, grad norm
    and every updated weight.  A MoE model's CPU runs take the card runs'
    expert choices (`ForcedRouting`), and the rows whose own choices
    differ are counted."""
    cfg = _train_cfg(arch, dtype="float32", **TRAIN_PARITY[arch])
    cpu_model = tfm.init_params(cfg, seed=0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    batch = make_batch(cfg, BatchSpec(1, TRAIN_PARITY_SEQ), seed=0)
    routings = []

    def card_then_cpu(card_fn, cpu_fn):
        if "moe" not in cfg.layer_pattern:
            return card_fn(), cpu_fn()
        routing = ForcedRouting()
        routings.append(routing)
        with routing.recording():
            on_card = card_fn()
            routing.forcing()
            on_cpu = cpu_fn()
        if routing.forced_calls != len(routing.choices) or not routing.choices:
            raise AssertionError(f"(b) {arch}: {len(routing.choices)} routings recorded, "
                                 f"{routing.forced_calls} forced")
        return on_card, on_cpu

    def card_grads():
        reset_train_counts()
        grads = _leaf_grads(cfg, card_model, batch, "cuda")
        launched.update(train_counts())
        return grads

    launched = {}
    card, cpu = card_then_cpu(card_grads, lambda: _leaf_grads(cfg, cpu_model, batch, "cpu"))
    expected = expected_train_counts(cfg, 1, remat=False)
    if launched != expected:  # one forward and backward: a step's launches
        raise AssertionError(f"(b) {arch}: launches {launched}, expected {expected}")
    grad_errs = {}
    for path, wants in cpu.items():
        for got, want in zip(card[path], wants):
            scale = float(want.abs().max())
            err = float((got.cpu() - want).abs().max()) / max(scale, 1e-30)
            if not err <= TRAIN_ATOL:
                raise AssertionError(f"(b) {arch} gradient {path}: card vs CPU {err:.3g} of "
                                     f"its largest |grad| {scale:.3g}")
            grad_errs[path] = max(grad_errs.get(path, 0.0), err)
    del card, cpu
    worst_grad_path = max(grad_errs, key=grad_errs.get)
    out = {"arch": arch, "layers": cfg.num_layers, "pattern": list(cfg.layer_pattern),
           "seq": TRAIN_PARITY_SEQ, "launches": launched, "grad_errs": grad_errs,
           "max_grad_err": grad_errs[worst_grad_path], "max_grad_err_leaf": worst_grad_path,
           "atol": TRAIN_ATOL, "grads_only": arch in TRAIN_PARITY_GRADS_ONLY}
    if out["grads_only"]:
        step = "gradients only (`TRAIN_PARITY_GRADS_ONLY`)"
    else:
        out.update(_card_vs_cpu_step(arch, cfg, card_model, cpu_model, batch, card_then_cpu))
        card, cpu = out["card"], out["cpu"]
        step = (f"loss card {card['loss']:.6f} CPU {cpu['loss']:.6f}, grad norm "
                f"{card['grad_norm']:.6f} / {cpu['grad_norm']:.6f}, largest weight difference "
                f"{out['max_weight_err']:.3g} ({out['max_weight_err_leaf']}; unchanged weights "
                f"would read {out['unchanged_weight_reading']:.3g}); card {out['card_s']:.2f} s, "
                f"CPU {out['cpu_s']:.2f} s")
    if routings:
        out["routing_flips"] = sum(r.flips for r in routings)
        out["routed_rows"] = sum(c.shape[0] for r in routings for c in r.choices)
        step += (f"; the CPU runs took the card's expert choices: {out['routing_flips']} of "
                 f"{out['routed_rows']} rows would have chosen others")
    log(f"  (b) {arch} at full width, {cfg.num_layers} layers {cfg.layer_pattern} float32, B 1 x "
        f"S {TRAIN_PARITY_SEQ}: largest gradient difference {out['max_grad_err']:.3g} of its "
        f"leaf's largest |grad| ({worst_grad_path}, {len(grad_errs)} leaves); {step}")
    del card_model, cpu_model
    torch.cuda.empty_cache()
    return out


def split_trace(trace_path: pathlib.Path, annotation: str) -> dict:
    """`scripts/torch_profile_wave.py`'s host/card split of the annotated
    span of a Chrome trace: the card's busy and idle share (the union of
    its kernel, copy and memset intervals), device ms by kernel group,
    host launches and waits."""
    spec = importlib.util.spec_from_file_location(
        "torch_profile_wave", ROOT / "scripts" / "torch_profile_wave.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.split_trace(json.loads(trace_path.read_text()), annotation)


def train_full_width(arch: str, mesh=None) -> dict:
    """(c): ``arch`` in bf16 with remat, cut as `TRAIN_RUNS` says, AdamW
    steps of `steps.make_train_setup`'s train step on the (1, 1) mesh
    ``mesh`` (without one, on a `local_mesh` of its own, as
    `scripts/torch_ab.py` calls it) on one fixed batch of S `TRAIN_SEQ`,
    every kernel count set to 0 just before and read just after (one
    launch of each layer's forward kernel twice a step, remat recomputing
    it, and one of its backward kernel); each step's wall time split by CUDA events into forward,
    backward and optimizer; the last step traced for the card's busy
    share; peak memory."""
    if mesh is None:
        with local_mesh() as mesh:
            return train_full_width(arch, mesh)
    cut, batch_size, n_steps = TRAIN_RUNS[arch]
    full = get_config(arch)
    cfg = _train_cfg(arch, **cut)
    reduced = ("nothing" if cfg.num_layers == full.num_layers else
               f"depth {full.num_layers} -> {cfg.num_layers} layers ({cfg.num_groups} groups of "
               f"{cfg.layer_pattern}, windows {cfg.window_pattern})")
    log(f"  (c) {arch}: full width (d_model {cfg.d_model}, vocabulary {cfg.vocab_size}), "
        f"cut: {reduced}; bf16, remat, B {batch_size} x S {TRAIN_SEQ}, {n_steps} steps")
    model = tfm.init_params(cfg, seed=0)
    state = {"params": model, "opt": init_opt_state(param_leaves(cfg, model))}
    batch = batch_to_device(make_batch(cfg, BatchSpec(batch_size, TRAIN_SEQ), seed=0), "cuda")
    step_fn, _, _ = steps_lib.make_train_setup(
        cfg, mesh, multi_pod=False, batch=batch_size, seq_len=TRAIN_SEQ,
        opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=n_steps))
    trace = ROOT / "build" / "profile" / f"train-step-trace-{arch}.json"
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    steps = []
    kept = KeptPairs() if "moe" in cfg.layer_pattern else contextlib.nullcontext()
    with kept:
        for i in range(n_steps):
            profiled = i == n_steps - 1
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            if profiled:
                prof.start()
            with torch.profiler.record_function(f"train step {i}"):
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch, events=events)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            if profiled:
                prof.stop()
            row = {"step": i, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "wall_ms": wall_ms, "traced": profiled,
                   "tokens_per_s": batch_size * TRAIN_SEQ / (wall_ms / 1e3),
                   "forward_ms": events[0].elapsed_time(events[1]),
                   "backward_ms": events[1].elapsed_time(events[2]),
                   "optimizer_ms": events[2].elapsed_time(events[3])}
            steps.append(row)
            log(f"  (c) {arch} step {i}: loss {row['loss']:.4f} gnorm {row['grad_norm']:.3f} "
                f"lr {row['lr']:.2e}; wall {wall_ms:.1f} ms = forward {row['forward_ms']:.1f} + "
                f"backward {row['backward_ms']:.1f} + optimizer {row['optimizer_ms']:.1f}; "
                f"{row['tokens_per_s']:.0f} tokens/s" + (" (traced)" if profiled else ""))
    launches = train_counts()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    traced = split_trace(trace, f"train step {n_steps - 1}")
    if not all(np.isfinite(r["loss"]) for r in steps) or steps[-1]["loss"] >= steps[0]["loss"]:
        raise AssertionError(f"(c) {arch} losses {[r['loss'] for r in steps]}: the last is not "
                             "below the first")
    expected = expected_train_counts(cfg, n_steps, remat=True)
    if launches != expected:
        raise AssertionError(f"(c) {arch}: launches {launches}, expected {expected}")
    rglru_bwd = dict(rglru.BWD_LAUNCHES_BY_VARIANT)
    if launches["rglru_scan_backward"]:
        w = cfg.resolved_lru_width
        want = rglru._bwd_variant(w, rglru._split(batch_size, TRAIN_SEQ, w, torch.cuda.
                                                  get_device_properties(0).multi_processor_count)[0])
        if rglru_bwd[want] != launches["rglru_scan_backward"]:
            raise AssertionError(f"(c) {arch}: RG-LRU backward launches {rglru_bwd}, all "
                                 f"expected on {want}")
    busy = ("not measured (the trace holds no device work)" if not traced["device_ops"] else
            f"{1 - traced['device_idle_share']:.4f} of {traced['wave_ms']:.1f} ms, by group "
            + ", ".join(f"{g} {ms:.1f}" for g, ms in traced["device_ms_by_group"].items()))
    kept = kept.summary() if isinstance(kept, KeptPairs) else None
    if kept:
        log(f"  (c) {arch}: {kept['dispatches']} dispatches kept {kept['kept_min']}-"
            f"{kept['kept_max']} (mean {kept['kept_mean']:.0f}) of {kept['pairs']} pairs")
    log(f"  (c) {arch} launches {launches}; peak memory {peak / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f} GiB; traced step: card busy {busy}; "
        f"{traced['host_launch_calls']} host launch calls")
    del state, model, batch
    torch.cuda.empty_cache()
    return {"arch": arch, "reduced": reduced, "layers": cfg.num_layers, "batch": batch_size,
            "seq": TRAIN_SEQ, "remat": True, "dtype": cfg.dtype, "steps": steps,
            "launches": launches, "rglru_bwd_by_variant": rglru_bwd, "moe_kept_pairs": kept,
            "peak_memory_bytes": peak, "card_memory_bytes": total, "traced_step": traced}


def train_accumulation(mesh) -> dict:
    """(e): one step of `TRAIN_ARCH` at full width and depth, bf16, remat,
    B `TRAIN_BATCH` x S `TRAIN_SEQ`, from the seed-0 init on the seed-0
    batch, with `ACCUM_MICROBATCHES` micro-batches and with one
    (`steps.make_train_setup` on the (1, 1) mesh): the loss within
    `ACCUM_LOSS_RTOL` and the grad norm within `ACCUM_GNORM_RTOL`
    relative, each step's launches held to `expected_train_counts` (M
    micro-batches launch M times one step's kernels, at 1/M of its rows)
    and its wall ms printed beside the other's; no limit on the times."""
    cfg = _train_cfg(TRAIN_ARCH)
    batch = batch_to_device(make_batch(cfg, BatchSpec(TRAIN_BATCH, TRAIN_SEQ), seed=0), "cuda")
    runs = {}
    for m in (1, ACCUM_MICROBATCHES):
        model = tfm.init_params(cfg, seed=0)
        state = {"params": model, "opt": init_opt_state(param_leaves(cfg, model))}
        step_fn, _, _ = steps_lib.make_train_setup(
            cfg, mesh, multi_pod=False, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            opt_cfg=AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=1), microbatches=m)
        torch.cuda.synchronize()
        reset_train_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = train_counts()
        expected = expected_train_counts(cfg, m, remat=True)
        if launches != expected:
            raise AssertionError(f"(e) M={m}: launches {launches}, expected {expected}")
        runs[m] = {"microbatches": m, "rows_per_microbatch": TRAIN_BATCH // m,
                   "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "wall_ms": wall_ms, "launches": launches}
        log(f"  (e) {TRAIN_ARCH} M={m} ({TRAIN_BATCH // m} rows a micro-batch): loss "
            f"{runs[m]['loss']:.6f} gnorm {runs[m]['grad_norm']:.6f}; wall {wall_ms:.1f} ms; "
            f"flash launches {launches['flash_attention']} forward, "
            f"{launches['flash_attention_bwd']} backward")
        del state, model, step_fn
        torch.cuda.empty_cache()
    one, acc = runs[1], runs[ACCUM_MICROBATCHES]
    loss_rel = abs(acc["loss"] - one["loss"]) / abs(one["loss"])
    gnorm_rel = abs(acc["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
    if not (np.isfinite(acc["loss"]) and loss_rel <= ACCUM_LOSS_RTOL
            and gnorm_rel <= ACCUM_GNORM_RTOL):
        raise AssertionError(f"(e) M={ACCUM_MICROBATCHES} vs M=1: loss {loss_rel:.3e} "
                             f"(limit {ACCUM_LOSS_RTOL}), grad norm {gnorm_rel:.3e} "
                             f"(limit {ACCUM_GNORM_RTOL}) relative")
    log(f"  (e) M={ACCUM_MICROBATCHES} vs M=1: loss {loss_rel:.3e}, grad norm "
        f"{gnorm_rel:.3e} relative (limits {ACCUM_LOSS_RTOL}, {ACCUM_GNORM_RTOL})")
    return {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "runs": list(runs.values()),
            "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel}


def train_launcher(workdir: pathlib.Path) -> dict:
    """(d): ``python -m repro_torch.launch.train --arch internlm2-1.8b
    --smoke --steps 2 --ckpt ...`` in a process of its own (its step built
    by `steps.make_train_setup` on its (1, 1) mesh), then its checkpoint
    restored into the smoke model."""
    path = workdir / "launch-train"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                            else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
           "--steps", str(LAUNCH_TRAIN_STEPS), "--ckpt", str(path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"(d) launcher exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    if "mesh={'data': 1, 'model': 1}" not in proc.stdout:
        raise AssertionError("(d) the launcher did not train on its (1, 1) mesh")
    cfg = smoke_variant(get_config(TRAIN_ARCH))
    like = tfm.init_params(cfg, seed=0)
    restored = ckpt.restore(str(path), like, cfg=cfg)
    manifest = json.loads(path.with_suffix(".manifest.json").read_text())
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(like.parameters(),
                                                           restored.parameters()))
    if manifest["metadata"] != {"arch": cfg.name} or moved == 0 or not all(
            bool(torch.isfinite(p).all()) for p in restored.parameters()):
        raise AssertionError(f"(d) checkpoint: metadata {manifest['metadata']}, "
                             f"{moved} tensors moved from the seed-0 init")
    log(f"  (d) launcher {wall_s:.1f} s; checkpoint restored: "
        f"{len(list(restored.parameters()))} tensors, {moved} trained away from the init")
    return {"wall_s": wall_s, "tensors": len(list(restored.parameters())), "trained": moved}


def phase_training() -> dict:
    out = {"part_seconds": {}}
    t = time.perf_counter()

    def part(name):
        nonlocal t
        now = time.perf_counter()
        out["part_seconds"][name] = now - t
        log(f"  ({name}: {now - t:.1f} s)")
        t = now

    out["kernel_checks"], out["timing"] = phase_backward_vs_plain()
    scan_checks, out["scan_timing"] = phase_scan_backward_vs_plain()
    out["kernel_checks"] += scan_checks
    gg_checks, out["gg_timing"] = phase_gg_backward_vs_plain()
    out["kernel_checks"] += gg_checks
    part("a")
    out["card_vs_cpu"] = {arch: train_card_vs_cpu(arch) for arch in TRAIN_PARITY}
    part("b")
    with local_mesh() as mesh:
        out["full_width"] = {arch: train_full_width(arch, mesh) for arch in TRAIN_RUNS}
        part("c")
        out["accumulation"] = train_accumulation(mesh)
        part("e")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out["launcher"] = train_launcher(pathlib.Path(tmp))
    part("d")
    return out


def backward_kernel_entry(training: dict) -> dict:
    """The backward kernel's entry of the kernels line: launches in (c) (all
    on ``wgmma``), the largest error of (a), its times at internlm2-1.8b's
    bf16 shape, and under ``variants`` each variant's times at every (a)
    shape of its type, by pass, beside bound, plain and library times."""
    t = training["timing"]["internlm2-1.8b bfloat16"]
    launches = training["full_width"][TRAIN_ARCH]["launches"]
    fields = ("ms", "dot_dkdv_ms", "dq_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "library", "library_error", "library_max_abs_err")
    variants = {}
    for key, row in training["timing"].items():
        variants.setdefault(row["variant"], {})[key] = {f: row[f] for f in fields if f in row}
    for c in training["kernel_checks"]:
        if c["kernel"] == "flash_attention_bwd":
            by = variants[c["variant"]][c["timing"]]
            by["max_abs_err"] = c["max_abs_err"]
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:75",
        "replaces_note": "no Pallas kernel: jax.grad of attention_train, whose loop the "
                         "Pallas flash kernel computes",
        "launches": launches["flash_attention_bwd"],
        "launches_by_variant": launches["flash_attention_bwd_by_variant"],
        "launches_by_run": {arch: run["launches"]["flash_attention_bwd"]
                            for arch, run in training["full_width"].items()},
        "passes": launches["flash_attention_bwd_passes"],
        "variant": t["variant"],
        "max_abs_err": max(c["max_abs_err"] for c in training["kernel_checks"]
                           if c["kernel"] == "flash_attention_bwd"),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "dot_dkdv_ms": t["dot_dkdv_ms"],
        "dq_ms": t["dq_ms"],
        "variants": variants,
    }


def scan_backward_entries(training: dict) -> list[dict]:
    """The scans' backward kernels' entries of the kernels line: launches in
    (c) (mamba2-1.3b's for the SSD scan, recurrentgemma-9b's for the RG-LRU
    scan), the largest error and the times of (a), the SSD's at its bf16
    shape with float32's beside."""
    runs = training["full_width"]
    checks = training["kernel_checks"]
    out = []
    for name, source, replaces, note, run, key in (
        ("ssd_scan_backward", "ssd_bwd.cu", "src/repro/models/ssm.py:34",
         "no Pallas kernel: jax.grad of ssd_chunked, whose forward the Pallas ssd_scan "
         "(src/repro/kernels/ssd.py:72) computes", "mamba2-1.3b", "ssd_scan_backward bfloat16"),
        ("rglru_scan_backward", "rglru_bwd.cu", "src/repro/models/rglru.py:96",
         "no Pallas kernel: jax.grad of rglru_scan's associative_scan, whose forward the Pallas "
         "rglru_scan_kernel (src/repro/kernels/rglru.py:41) computes", "recurrentgemma-9b",
         "rglru_scan_backward"),
    ):
        t = training["scan_timing"][key]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "replaces_note": note,
            "launches": runs[run]["launches"][name],
            "launches_by_run": {arch: r["launches"][name] for arch, r in runs.items()},
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["kernel"] == name and "timing" in c),
            "grads": {c["dtype"]: c["grads"] for c in checks
                      if c["kernel"] == name and "timing" in c},
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        }
        if name == "rglru_scan_backward":
            entry.update({k: t[k] for k in ("variant", "seg", "segment_steps", "split_lanes",
                                            "clusters", "lanes", "walk_ms", "walk_32_ms",
                                            "forward")})
            entry["launches_by_variant"] = runs[run]["rglru_bwd_by_variant"]
            entry["walk_max_abs_err"] = max(c["max_abs_err"] for c in checks
                                            if c["kernel"] == name and "timing" not in c)
        if name == "ssd_scan_backward":
            entry.update(variant=t["variant"], passes_ms=t["passes_ms"],
                         launches_by_variant=runs[run]["launches"]["ssd_scan_backward_by_variant"],
                         float32={k: training["scan_timing"]["ssd_scan_backward float32"][k]
                                  for k in ("variant", "ms", "passes_ms",
                                            "plain_ms", "bound_ms", "bound_by")})
        else:
            entry["lanes"] = t["lanes"]
        out.append(entry)
    return out


def gg_backward_entries(training: dict) -> list[dict]:
    """The grouped GEMM's backward kernels' entries of the kernels line:
    launches in (c) (qwen3-moe-30b-a3b's), by kernel and by design, the
    largest error of (a) on the design the dtype picks, and the times at
    qwen3-moe-30b-a3b's bf16 gate/up product; ``variants`` gives each
    design's times and largest error (``simt`` forced in bf16, and in
    float32), every (a) timing beside under ``shapes``."""
    runs = training["full_width"]
    checks = training["kernel_checks"]
    out = []
    for kernel in ("dx", "dw"):
        name = f"grouped_gemm_bwd_{kernel}"
        t = training["gg_timing"][f"{kernel} gate/up bfloat16"]
        t32 = training["gg_timing"][f"{kernel} gate/up float32"]
        fields = ("variant", "ms", "simt_ms", "turns_ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "library_error", "library_max_abs_err", "rows",
                  "experts_touched")

        def err(variant, dtype):
            return max(c["max_abs_err"] for c in checks if c["kernel"] == name
                       and c["variant"] == variant and c["dtype"] == dtype)

        out.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_gemm_bwd.cu",
            "replaces": "src/repro/models/moe.py:133",
            "replaces_note": "no Pallas kernel: jax.grad of moe_ffn's capacity-buffer "
                             "einsums, whose forward the Pallas grouped_gemm "
                             "(src/repro/kernels/grouped_gemm.py:32) computes",
            "variant": t["variant"],
            "launches": runs[GG_BWD_ARCH]["launches"]["grouped_gemm_bwd_by_variant"][kernel],
            "launches_by_run": {arch: r["launches"]["grouped_gemm_bwd_by_variant"][kernel]
                                for arch, r in runs.items()},
            "launches_by_design": {arch: r["launches"]["grouped_gemm_bwd_by_design"]
                                   for arch, r in runs.items()
                                   if r["launches"]["grouped_gemm_bwd"]},
            "max_abs_err": err(t["variant"], "bfloat16"),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": t["library"],
            "variants": {
                t["variant"]: {"dtype": "bfloat16", "ms": t["ms"],
                               "max_abs_err": err(t["variant"], "bfloat16")},
                "simt": {"bfloat16_ms": t.get("simt_ms"), "float32_ms": t32["ms"],
                         "float32_bound_ms": t32["bound_ms"],
                         "bfloat16_max_abs_err": err("simt", "bfloat16"),
                         "float32_max_abs_err": err("simt", "float32")}},
            "shapes": {key.split(" ", 1)[1]: {f: row[f] for f in fields if f in row}
                       for key, row in training["gg_timing"].items()
                       if key.startswith(kernel + " ")},
        })
    return out


#: Phase 10: one (arch, shape, multi-pod) of each step kind.
DRYRUN_COMBOS = (("qwen3-moe-30b-a3b", "train_4k", False), ("gemma2-2b", "long_500k", True),
                 ("yi-34b", "decode_32k", False))


def phase_dryrun() -> list[dict]:
    """`dryrun.run_one` on `DRYRUN_COMBOS` (nothing saved): each step's
    leaves placed on meta over a fake process group of the production
    mesh's size, every shard even, rank 0's bytes a device by kind.  CPU
    arithmetic: nothing runs on the card."""
    out = []
    for arch, shape, multi_pod in DRYRUN_COMBOS:
        rec = dryrun.run_one(arch, shape, multi_pod, save=False)
        gb = {k: v / 1e9 for k, v in rec["bytes_per_device"].items()}
        log(f"  {rec['arch']} {shape} {rec['mesh']}: GB a device params {gb['params']:.3f}, "
            f"optimizer {gb['opt']:.3f}, batch {gb['batch']:.4f}, caches {gb['caches']:.3f}, "
            f"total {gb['total']:.3f} ({'fits' if rec['fits_device'] else 'does not fit'} "
            f"80 GB); placed in {rec['place_s']:.2f} s")
        out.append({k: rec[k] for k in ("arch", "shape", "mesh", "kind", "n_chips",
                                        "bytes_per_device", "fits_device", "roofline")})
    return out

# ---- phase 11: sharded execution --------------------------------------------------

#: Phase 11's ranks (processes on the one card) and their ("data", "model") mesh.
SHARD_RANKS, SHARD_MESH = 4, (2, 2)
#: The configs at full width, each cut to one layer group (recurrentgemma-9b's
#: group to phase 9's (recurrent, recurrent, attention)).
SHARD_ARCHS = {
    "internlm2-1.8b": dict(num_layers=1),
    "qwen3-moe-30b-a3b": dict(num_layers=1),
    "mamba2-1.3b": dict(num_layers=1),
    "recurrentgemma-9b": dict(RG_TRAIN_CUT, num_layers=3),
}
#: The batch (2 rows a data rank), the decode steps after the prefill, the
#: caches' slots, and the prompt's last positions whose logits are compared
#: (all of a 4 x 1024 prefill's over qwen3's 151,936 words is 2.5 GB).
SHARD_B, SHARD_S, SHARD_DECODE, SHARD_CACHE, SHARD_TAIL = 4, 1024, 4, 1032, 16
#: The configs also run in float32: forward, prefill and decode.
SHARD_F32 = ("internlm2-1.8b", "recurrentgemma-9b")
#: bf16 logits against one rank's: the reference test's 0.15
#: (tests/test_sharding.py:159), or one bf16 ulp of the largest |logit|
#: where that is coarser; the MoE by its mean and large-error share
#: (:150-157).  float32: 1e-3 of the largest |logit|.  The train step's loss
#: and grad norm, relative.
SHARD_BF16_ATOL, SHARD_F32_RTOL = 0.15, 1e-3
SHARD_LOSS_RTOL, SHARD_GNORM_RTOL = 1e-2, 5e-2
SHARD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
#: The kernels every rank must have launched in the phase.
SHARD_KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
                 "ssd_scan_backward", "rglru_scan", "rglru_scan_backward", "grouped_gemm",
                 "grouped_gemm_bwd")


def _shard_cfg(arch: str, dtype: str):
    return dataclasses.replace(get_config(arch), dtype=dtype, **SHARD_ARCHS[arch])


def _shard_counts() -> dict:
    return {**train_counts(), "decode_attention": decode.LAUNCHES,
            "decode_attention_by_variant": dict(decode.LAUNCHES_BY_VARIANT)}


def _tail(dt, n: int) -> torch.Tensor:
    """The last ``n`` positions (dim 1) of a sharded step's logits, whole,
    on the CPU."""
    from repro_torch.sharding import execute as ex

    local = dt.to_local()[:, -n:].contiguous()
    shape = (dt.shape[0], n) + tuple(dt.shape[2:])
    return ex.full(ex._dtensor(local, ex._spec_of(dt), dt.device_mesh, shape)).cpu()


def _in_turn(make):
    """``make()`` on each rank in turn, the card's memory freed after each:
    the four ranks share one card, and each draws the whole model before it
    keeps its shard."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = make()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _serve_setups(cfg, mesh):
    """Phase 11's prefill and decode builders: (prefill, decode, param specs,
    batch specs, cache specs, decode's input specs)."""
    kw = dict(multi_pod=False, batch=SHARD_B)
    pre, _, (pspecs, bspecs, cspecs) = steps_lib.make_prefill_setup(cfg, mesh, seq_len=SHARD_S,
                                                                    **kw)
    dec, _, (_, in_specs, _) = steps_lib.make_decode_setup(cfg, mesh, cache_len=SHARD_CACHE,
                                                           long_context=False, **kw)
    return pre, dec, pspecs, bspecs, cspecs, in_specs


def _shard_serve(cfg, mesh, counted, batch, params) -> dict:
    """A prefill and `SHARD_DECODE` decode steps through the builders on
    ``mesh`` with ``params`` (at the prefill builder's specs): the prompt's
    last logits and each step's."""
    from repro_torch.sharding import execute as ex

    pre, dec, _, bspecs, cspecs, in_specs = _serve_setups(cfg, mesh)
    caches = ex.place_caches(tfm.init_serve_cache(cfg, SHARD_B, SHARD_CACHE), cspecs, cfg, mesh)
    logits, caches = counted(pre, params, ex.place_tree({"tokens": batch["tokens"]}, bspecs,
                                                        mesh), caches)
    out = {"prefill": _tail(logits, SHARD_TAIL), "decode": []}
    tok = out["prefill"][:, -1:].argmax(-1).to(torch.int32).cuda()
    for i in range(SHARD_DECODE):
        logits, caches = counted(dec, params, ex.place(tok, in_specs["tokens"], mesh),
                                 SHARD_S + i, caches)
        out["decode"].append(ex.full(logits).cpu())
        tok = out["decode"][-1].argmax(-1).to(torch.int32).cuda()
    return out


def sharded_rank(rank: int, world: int, run_dir: str) -> None:
    """One of phase 11's ranks: gloo on the card, a (2, 2) mesh, each
    config's sharded steps; its results, launches and collectives to
    ``rank<r>.pt``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import execute as ex
    from repro_torch.sharding.parallel import CollectiveCounter

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(f"{run_dir}/store", world),
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cuda", SHARD_MESH, mesh_dim_names=("data", "model"))
    collectives: dict = {}

    def counted(fn, *args):
        with CollectiveCounter() as counter:
            out = fn(*args)
        for op, v in counter.counts.items():
            if v["count"]:
                c = collectives.setdefault(op, {"count": 0, "bytes": 0.0})
                c["count"] += v["count"]
                c["bytes"] += v["bytes"]
        return out

    out = {"bf16": {}, "float32": {}}
    reset_train_counts()
    decode.LAUNCHES = 0
    for k in decode.LAUNCHES_BY_VARIANT:
        decode.LAUNCHES_BY_VARIANT[k] = 0
    for arch in SHARD_ARCHS:
        cfg = _shard_cfg(arch, "bfloat16")
        batch = batch_to_device(make_batch(cfg, BatchSpec(SHARD_B, SHARD_S), seed=0), "cuda")
        step, _, (state_specs, bspecs) = steps_lib.make_train_setup(
            cfg, mesh, multi_pod=False, batch=SHARD_B, seq_len=SHARD_S,
            opt_cfg=AdamWConfig(**SHARD_OPT))
        serve_specs = _serve_setups(cfg, mesh)[2]

        def place():  # the train state and the serving weights from one draw
            model = tfm.init_params(cfg, seed=0)
            return (ex.place_train_state(cfg, model, state_specs, mesh),
                    ex.place_params(cfg, model, serve_specs, mesh))

        state, params = _in_turn(place)
        res = {"resident_bytes": ex.resident_bytes(state)}
        _, metrics = counted(step, state, ex.place_tree(batch, bspecs, mesh))
        res.update({k: float(metrics[k]) for k in ("loss", "grad_norm")})
        del state
        res.update(_shard_serve(cfg, mesh, counted, batch, params))
        del params
        out["bf16"][arch] = res
        torch.cuda.empty_cache()
    for arch in SHARD_F32:
        cfg = _shard_cfg(arch, "float32")
        batch = batch_to_device(make_batch(cfg, BatchSpec(SHARD_B, SHARD_S), seed=0), "cuda")
        pspecs = _serve_setups(cfg, mesh)[2]  # the forward's plan: no FSDP, as prefill's
        bspecs = {"tokens": ("data", None)}
        fwd = ex.sharded_forward_train(cfg, mesh, pspecs, bspecs)
        params = _in_turn(lambda: ex.place_params(cfg, tfm.init_params(cfg, seed=0), pspecs,
                                                  mesh))
        logits, _ = counted(fwd, params, ex.place_tree({"tokens": batch["tokens"]}, bspecs,
                                                        mesh))
        res = {"forward": _tail(logits, SHARD_TAIL)}
        del logits
        res.update(_shard_serve(cfg, mesh, counted, batch, params))
        del params
        out["float32"][arch] = res
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out["launches"] = _shard_counts()
    out["collectives"] = collectives
    out["seconds"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, f"{run_dir}/rank{rank}.pt")


def _one_rank_serve(cfg, model, sharded: dict, batch) -> dict:
    """`_shard_serve`'s work on one rank: the same prompt, then the sharded
    run's tokens."""
    caches = tfm.init_serve_cache(cfg, SHARD_B, SHARD_CACHE)
    logits, caches = tfm.forward_prefill(model, cfg, {"tokens": batch["tokens"]}, caches)
    out = {"prefill": logits[:, -SHARD_TAIL:].cpu(), "decode": []}
    del logits
    for i in range(SHARD_DECODE):
        src = sharded["prefill"] if i == 0 else sharded["decode"][i - 1]
        tok = src[:, -1:].argmax(-1).to(torch.int32).cuda()
        logits, caches = tfm.forward_decode(model, cfg, tok, SHARD_S + i, caches)
        out["decode"].append(logits.cpu())
    return out


def _shard_compare(label, got, want, moe: bool, dtype: str) -> float:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    if dtype == "float32":
        bound = SHARD_F32_RTOL * float(want.abs().max())
        if err > bound:
            raise AssertionError(f"{label}: sharded vs one rank {err:.3g} > {bound:.3g}")
    elif moe:
        mean, large = float(diff.mean()), float((diff > 0.2).float().mean())
        if mean >= 0.02 or large >= 0.02:
            raise AssertionError(f"{label}: mean err {mean:.3g}, share > 0.2 {large:.3g}")
    else:
        # bf16 logits: the reference's 0.15, or one bf16 ulp of the largest
        # |logit| where that is coarser (recurrentgemma-9b's reach some 40
        # at init, where a product summed in another order may round a
        # whole ulp, 0.25, away).
        largest = float(want.abs().max())
        bound = max(SHARD_BF16_ATOL, 2.0 ** (math.floor(math.log2(largest)) - 7))
        if err > bound:
            raise AssertionError(f"{label}: sharded vs one rank {err:.3g} > {bound:.3g} "
                                 f"(largest |logit| {largest:.3g})")
    return err


def phase_sharded_execution() -> dict:
    """Phase 11: four ranks on a (2, 2) mesh sharing the card over gloo (the
    kernels are built; the ranks load them), each config's train step,
    prefill and decode held against one rank's on the card."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    # Four processes share the card: their caches grow in segments.
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as run_dir:
            mp.start_processes(sharded_rank, args=(SHARD_RANKS, run_dir), nprocs=SHARD_RANKS,
                               start_method="spawn")
            ranks = [torch.load(f"{run_dir}/rank{r}.pt") for r in range(SHARD_RANKS)]
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    t_ranks = time.perf_counter() - t0
    log(f"  the ranks: {t_ranks:.1f} s from the spawn to the last's exit")
    out = {"ranks_s": t_ranks, "rank_s": [r["seconds"] for r in ranks],
           "peak_gb": [r["peak_gb"] for r in ranks], "launches": [], "collectives": [],
           "bf16": {}, "float32": {}}
    for r, res in enumerate(ranks):
        launches = res["launches"]
        missing = [k for k in SHARD_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"phase 11 rank {r}: no launch of {missing}")
        out["launches"].append(launches)
        out["collectives"].append(res["collectives"])
        log(f"  rank {r}: {res['seconds']:.1f} s, peak {res['peak_gb']:.1f} GB; launches "
            + ", ".join(f"{k} {launches[k]} {launches.get(k + '_by_variant', '')}".rstrip()
                        for k in SHARD_KERNELS))
        log(f"  rank {r}: gloo collectives on CUDA tensors "
            + ", ".join(f"{op} x{v['count']} ({v['bytes'] / 1e6:.1f} MB)"
                        for op, v in res["collectives"].items()))
    for dtype, archs in (("bf16", SHARD_ARCHS), ("float32", SHARD_F32)):
        for arch in archs:
            t_arch = time.perf_counter()
            cfg = _shard_cfg(arch, "bfloat16" if dtype == "bf16" else "float32")
            got = ranks[0][dtype][arch]
            moe = cfg.num_experts > 0
            batch = batch_to_device(make_batch(cfg, BatchSpec(SHARD_B, SHARD_S), seed=0),
                                    "cuda")
            row = {}
            if dtype == "bf16":
                model = tfm.init_params(cfg, seed=0)
                with local_mesh() as mesh:
                    step, _, _ = steps_lib.make_train_setup(
                        cfg, mesh, multi_pod=False, batch=SHARD_B, seq_len=SHARD_S,
                        opt_cfg=AdamWConfig(**SHARD_OPT))
                    model.requires_grad_(True)
                    _, metrics = step({"params": model,
                                       "opt": init_opt_state(param_leaves(cfg, model))}, batch)
                for key, rtol in (("loss", SHARD_LOSS_RTOL), ("grad_norm", SHARD_GNORM_RTOL)):
                    want = float(metrics[key])
                    row[key] = (got[key], want)
                    if abs(got[key] - want) > rtol * abs(want):
                        raise AssertionError(f"phase 11 {arch} {key}: {got[key]} vs {want}")
                del model, metrics
                torch.cuda.empty_cache()
            else:
                model = tfm.init_params(cfg, seed=0)
                with torch.no_grad():
                    logits, _ = tfm.forward_train(model, cfg, {"tokens": batch["tokens"]})
                row["forward"] = _shard_compare(f"{arch} float32 forward", got["forward"],
                                                logits[:, -SHARD_TAIL:].cpu(), moe, dtype)
                del model, logits
            model = tfm.init_params(cfg, seed=0)
            with torch.no_grad():
                want = _one_rank_serve(cfg, model, got, batch)
            del model
            torch.cuda.empty_cache()
            row["prefill"] = _shard_compare(f"{arch} {dtype} prefill", got["prefill"],
                                            want["prefill"], moe, dtype)
            row["decode"] = [_shard_compare(f"{arch} {dtype} decode {i}", g, w, moe, dtype)
                             for i, (g, w) in enumerate(zip(got["decode"], want["decode"]))]
            if dtype == "bf16":
                row["resident_gb"] = [r["bf16"][arch]["resident_bytes"] / 1e9 for r in ranks]
            out[dtype][arch] = row
            row["one_rank_s"] = time.perf_counter() - t_arch
            log(f"  {arch} {dtype} ({row['one_rank_s']:.1f} s on one rank): " + ", ".join(
                f"{k} {v[0]:.4f} vs {v[1]:.4f}" if isinstance(v, tuple) else
                f"{k} err {max(v) if isinstance(v, list) else v:.3g}"
                for k, v in row.items() if k not in ("resident_gb", "one_rank_s"))
                + (f"; rank 0 holds {row['resident_gb'][0]:.2f} GB of state"
                   if "resident_gb" in row else ""))
    return out


class PhaseTimer:
    """Prints each phase's title as it begins and its seconds as it ends."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._key, self._t0 = None, time.perf_counter()

    def begin(self, key: str, title: str) -> None:
        self.finish()
        self._key, self._t0 = key, time.perf_counter()
        log(f"{key}: {title}")

    def finish(self) -> dict[str, float]:
        if self._key is not None:
            self.seconds[self._key] = time.perf_counter() - self._t0
            log(f"  ({self._key}: {self.seconds[self._key]:.1f} s)")
            self._key = None
        return self.seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the measurements to this file")
    ap.add_argument("--kernel-only", action="store_true",
                    help="run only phases 1-3 and 6 (build and kernel checks)")
    ap.add_argument("--parity", nargs=2, metavar=("PART", "PATH"),
                    help="run only phase 4c (c)'s replay PART (cells, flat) and write its "
                         "outcome to PATH (the script starts itself so)")
    args = ap.parse_args(argv)
    if args.parity:
        return run_parity(*args.parity)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # The plain versions and the model's products compare in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = PhaseTimer()
    timer.begin("phase 1", "device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {name} x{count}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(smi)

    # Phase 4c (c)'s replays run in processes of their own: the 8-cell one
    # (minutes of host work, one thread) from here, beside the build and
    # phases 3-4b, so that the script keeps to its time; the flat and
    # one-cell ones from the start of phase 4c.  Phases 4, 4b and 4c's
    # timings are taken beside them.
    parity_dir = tempfile.TemporaryDirectory()
    workdir = pathlib.Path(parity_dir.name)
    parity = {} if args.kernel_only else {"cells": start_parity("cells", workdir)}
    try:
        timer.begin("phase 2", "build")
        t0 = time.perf_counter()
        _build.build_all()
        build_wall = time.perf_counter() - t0
        for src, info in _build.BUILD_INFO.items():
            log(f"  {src}.cu built in {info['seconds']:.2f} s -> {info['path']}")
            for line in info["log"].splitlines():
                if "ptxas" in line or "spill" in line:
                    log(f"    {line.strip()}")
        log(f"  all sources built in {build_wall:.2f} s (in parallel)")
        flash_wgmma_ptxas = check_flash_wgmma_spills()
        spill_checks = check_instance_spills()

        result = {"device": name, "nvidia_smi": smi, "build_s": build_wall,
                  "build": {k: v["seconds"] for k, v in _build.BUILD_INFO.items()},
                  "flash_wgmma_ptxas": flash_wgmma_ptxas, "ptxas": spill_checks,
                  "flash_bwd_ptxas": {f: r for f, r in ptxas_report(
                      _build.BUILD_INFO["flash_attention_bwd"]["log"]).items()}}
        timer.begin("phase 3", "knapsack kernel vs plain on the card")
        fleet_problem = ResourceManager(
            paper_ec2_catalog(), paper_profile_table()
        ).formulate(camera_fleet(N_CAMERAS), ST3)
        checks = phase_kernel_vs_plain(fleet_problem)
        log(f"  {len(checks)} comparisons exact")
        result["checks"] = checks

        if not args.kernel_only:
            timer.begin("phase 4", f"manager path ({N_CAMERAS} cameras)")
            result["quickstart_savings"] = phase_quickstart()
            main_path = phase_main_path()
            largest = main_path.pop("_largest")
            managers = main_path.pop("_managers")
            result["main_path"] = main_path
            timer.begin("phase 4b", "live re-planning loop: (a) the 500-camera fleet's churn, "
                        "(b) churn_replan, (c) lifecycle experiment 3")
            result["live_loop"] = phase_live_loop(managers)
            del managers
            timer.begin("phase 4c", f"sharded controller: (a) {SHARD_STREAMS:,} streams over "
                        f"{SHARD_CELLS} cells, (b) the batched repair, (c) cost parity at "
                        f"{PARITY_STREAMS} streams, (d) a sharded churn replay")
            parity["flat"] = start_parity("flat", workdir)
            result["sharded"] = phase_sharded(parity, workdir)
    finally:
        for proc, _ in parity.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        parity_dir.cleanup()
    if not args.kernel_only:
        torch.cuda.empty_cache()
        timer.begin("phase 5", "knapsack timing at the manager path's largest call")
        result["timing"] = phase_timing(largest)
        timer.begin("phase 5b", "analysis programs, calibration and calibrated allocations")
        result["analysis_programs"] = phase_analysis_programs()
        result["calibration"] = phase_calibration()
        result["calibrated_allocations"] = phase_calibrated_allocations()
        result["measured_calibration"] = phase_measured_calibration()
        analysis_programs._initialised.cache_clear()
        torch.cuda.empty_cache()

    timer.begin("phase 6", "attention, SSD, RG-LRU and grouped GEMM kernels vs plain on the card")
    kernel_checks = phase_kernels_vs_plain()
    result["kernel_checks"] = kernel_checks

    if not args.kernel_only:
        timer.begin("phase 7", f"serving path, full-width {', '.join(SERVE_ARCHS)}")
        result["serve_launcher"] = {arch: phase_serve_launcher(arch) for arch in LAUNCHER_ARCHS}
        frames, served = {}, {}
        for arch in SERVE_ARCHS:
            params = tfm.init_params(get_config(arch), seed=0)
            frames[arch] = phase_frame_analysis(arch, params)
            if arch == BUILDER_ARCH:
                result["serve_builders"] = serve_through_builders(arch, params)
            del params
            served[arch] = frames[arch].pop("_args")
            torch.cuda.empty_cache()
        result["frame_analysis"] = frames
        timer.begin("phase 8", "kernel timing; float32 models vs their plain paths")
        gemma, mamba, rg, qwen = (served[arch] for arch in SERVE_ARCHS)
        attn_timing = phase_attention_timing(gemma["flash_attention"], gemma["decode_attention"])
        rep16 = phase_attention_timing_rep16(rg["flash_attention"], rg["decode_attention"])
        qwen_flash = phase_flash_timing_qwen3(qwen["flash_attention"])
        qwen_decode = phase_decode_timing_qwen3(qwen["decode_attention"])
        scan_timing = phase_scan_timing(mamba["ssd_scan"], rg["rglru_scan"])
        gg_timing = phase_gg_timing(qwen["grouped_gemm"])
        del served, gemma, mamba, rg, qwen
        kernel_checks += (attn_timing.pop("served_checks") + rep16.pop("served_checks")
                          + qwen_flash.pop("served_checks") + qwen_decode.pop("served_checks")
                          + scan_timing.pop("served_checks")
                          + gg_timing.pop("served_checks"))
        for kname in ("flash_attention", "decode_attention"):
            attn_timing[kname]["recurrentgemma"] = rep16[kname]
        attn_timing["flash_attention"]["variant"] = flash._variant(torch.bfloat16)
        attn_timing["flash_attention"]["qwen3"] = qwen_flash["flash_attention"]
        attn_timing["decode_attention"]["qwen3"] = qwen_decode["decode_attention"]
        result["attention_timing"] = attn_timing
        result["scan_timing"] = scan_timing
        result["grouped_gemm_timing"] = gg_timing
        result["model_vs_plain"] = {}
        for arch in SERVE_ARCHS:
            result["model_vs_plain"][arch] = phase_model_vs_plain(arch)
            torch.cuda.empty_cache()
        timer.begin("phase 9", "training: the backward kernels (flash attention, SSD scan, "
                    f"RG-LRU scan, grouped GEMM), card vs CPU, full-width "
                    f"{', '.join(TRAIN_RUNS)}, the launcher")
        training = result["training"] = phase_training()
        kernel_checks += [c for c in training["kernel_checks"] if c["kernel"] == "flash_attention"]
        timer.begin("phase 10", "dry-run on meta under fake process groups (CPU arithmetic)")
        result["dryrun"] = phase_dryrun()
        torch.cuda.empty_cache()
        timer.begin("phase 11", "sharded execution: four ranks on a (2, 2) mesh sharing the card")
        result["sharded_execution"] = phase_sharded_execution()

        timing = result["timing"]
        result["kernels"] = [{
            "name": "knapsack_dp",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knapsack.cu",
            "replaces": "src/repro/kernels/knapsack.py:277",
            "launches": main_path["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": timing["ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
            "variant": timing["variant"],
            "launches_by_variant": main_path["launches_by_variant"],
            "calibrated_launches": {name: a["launches"] for name, a in
                                    result["calibrated_allocations"].items()},
            "global_ms": timing["global_ms"],
            "bound_bits_ms": timing["bound_bits_ms"],
            "bound_bits_by": timing["bound_bits_by"],
            "live_loop_launches": result["live_loop"]["launches"]["knapsack_dp"],
            "shard": shard_kernel_entry(result["sharded"], "knapsack_dp"),
        }]
        live = result["live_loop"]
        for kname, src, replaces in (
            ("pack_scan", "pack", "src/repro/core/binpack/heuristics.py:209"),
            ("placement_scores", "placement", "src/repro/core/binpack/heuristics.py:498"),
        ):
            t = live["timing"][kname]
            check = live[f"{src}_check"]
            result["kernels"].append({
                "name": kname,
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                "replaces": replaces,
                "launches": live["launches"][kname],
                "max_abs_err": check["max_abs_err"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": None,
                "launches_by_replay": {part: live[part]["counts"][kname]["launches"]
                                       for part in ("main", "churn_replan", "growth")},
                **({"steps": t["steps"], "variant": t["variant"], "B": t["B"],
                    "fleets_per_cta": t["fleets_per_cta"], "empty_walk_ms": t["empty_walk_ms"]}
                   if kname == "pack_scan" else
                   {"shape": t["shape"], "threshold": heuristics._CUDA_MIN_CANDIDATES,
                    "empty_ms": t["empty_ms"], "fleet_scale": t["fleet_scale"]}),
                "shard": shard_kernel_entry(result["sharded"], kname),
            })
        for kname, replaces in (
            ("flash_attention", "src/repro/kernels/attention.py:75"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:72"),
            ("ssd_scan", "src/repro/kernels/ssd.py:72"),
            ("rglru_scan", "src/repro/kernels/rglru.py:41"),
            ("grouped_gemm", "src/repro/kernels/grouped_gemm.py:32"),
        ):
            t = {**attn_timing, **scan_timing, **gg_timing}[kname]
            by_arch = {arch: f["launches"][kname] for arch, f in frames.items()
                       if f["launches"][kname]}
            entry = {
                "name": kname,
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{SOURCE_FILES[kname]}",
                "replaces": replaces,
                "launches": sum(by_arch.values()),
                "max_abs_err": max(c["max_abs_err"] for c in kernel_checks
                                   if c["kernel"] == kname),
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "launches_by_arch": by_arch,
            }
            if "library" in t:
                entry["library"] = t["library"]
            # The passes of a two-pass kernel, timed apart; RG-LRU's other
            # variant and CTA width, forced.
            parts = ("split_ms", "combine_ms", "cb_ms", "per_head_ms", "passes", "lanes",
                     "cp_async_ms", "lanes_64_ms", "lanes_128_ms", "lse_ms")
            entry.update({k: t[k] for k in parts if k in t})
            for shapes in ("internlm2", "recurrentgemma", "qwen3"):
                if shapes in t:
                    entry[shapes] = {k: t[shapes][k] for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms") + parts if k in t[shapes]}
            if "float32" in t:
                entry["float32"] = {k: t["float32"][k] for k in (
                    "variant", "ms", "bound_ms", "bound_by", "library_ms", "library_error")
                    + parts if k in t["float32"]}
            if kname in VARIANT_KERNELS:
                entry["variant"] = t["variant"]
                entry["launches_by_variant"] = {
                    arch: f["variants"][kname] for arch, f in frames.items()
                    if f["launches"][kname]}
            if kname == "grouped_gemm":
                # The prefill row above is the gate product's; beside it the
                # served down product's and a decode step's gate product's.
                for row in ("down", "decode"):
                    entry[row] = {k: t[row][k] for k in (
                        "variant", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            result["kernels"].append(entry)
        for entry in result["kernels"]:
            if entry["name"] in ("flash_attention", "ssd_scan", "rglru_scan", "grouped_gemm"):
                entry["training_launches"] = {arch: run["launches"][entry["name"]]
                                              for arch, run in training["full_width"].items()}
        result["kernels"].append(backward_kernel_entry(training))
        result["kernels"] += scan_backward_entries(training)
        result["kernels"] += gg_backward_entries(training)
        result["cold_timings"] = COLD_TIMINGS
    result["phase_seconds"] = timer.finish()
    if not args.kernel_only:
        sec, parts = result["phase_seconds"], result["training"]["part_seconds"]
        log(f"  phase 11 took {sec['phase 11']:.1f} s; the phases cut to give it back: "
            f"8 {sec['phase 8']:.1f} s (its float32 models at about half depth), 9 (b) "
            f"{parts['b']:.1f} s (one layer a config, not two), (c) {parts['c']:.1f} s (3 "
            f"steps, not 4), (d) {parts['d']:.1f} s (2 steps, not 3)")
    result["seconds"] = time.perf_counter() - t_start
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(result, indent=1, default=float))
    log(f"done in {result['seconds']:.1f} s")
    if args.kernel_only:
        return 0
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
