#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

1. the card's name and power limit, the torch and CUDA versions;
2. build the CUDA kernels from `src/repro_torch/csrc/` (one nvcc each,
   all at once), print each kernel's ptxas report, and check that the
   flash-attention library's SASS holds tensor-core instructions (HMMA);
3. calibrate the paper fleet and clone it to
   `synthetic_fleet(10_000, hours=48, seed=0)` (and a W = 130 tail fleet);
4. hold each kernel against its plain PyTorch version on the card and
   time both with CUDA events: the fleet kernels at the main path's
   shapes (W = 10,000, T = 48) and at W = 130 (a tail block); rmsnorm at
   stablelm-3b's and mamba2-780m's prefill and decode rows (d 2560; d
   1536 and the gated norm's 3072), qwen3-32b's qk-norm rows (32,768,
   128), whisper's encoder rows (12,000, 1280), the MoE / MLA prefill
   rows (512 tokens at d 2048 and 7168, and MLA's kv latent of 512) and
   jamba's rows at d 4096 and its gated norm's at d_in 8192 (its
   serving, check and long prefills, 512, 2048 and 8192 tokens, and its
   decode, 8), and the rows of phase 8d's train steps bit for bit
   (mamba2's 2 x 4096, qwen3-moe's 1 x 4096 and its qk-norm rows,
   deepseek's 1 x 1024 and its MTP head's 1023 at d 7168, 1536, 512);
   flash attention at its
   prefill, at a 1024-token prefill (16 kv blocks), at whisper's
   non-causal encoder (8 x 1500, 20 heads of 64, a masked tail of 28
   keys) and cross-attention (128 queries over 1500 keys), both timed
   beside SDPA, at whisper's causal decoder, granite-20b's MQA (48:1)
   and qwen3-32b's GQA (8:1) at Dh 128, deepseek-v3's MLA prefill (8 x
   64, 128 heads, Dh 192 and Dv 128) and a 1024-token MLA prefill (both
   timed beside SDPA, with the backend SDPA picks), MLA widths with
   ragged tails, a q_offset and in float32, jamba's three prefills (32
   heads over 8, Dh 128: 8 x 64, 2 x 1024 and 1 x 8192 tokens; timed
   beside SDPA with `enable_gqa`), phase 8d's train shapes (jamba's 1 x
   2048, qwen3-moe's 1 x 4096 at 32 heads over 4, deepseek's MTP layer
   over 1023 positions), and
   at cases for causal/non-causal, GQA, tails, Dv != Dh and q_offset;
   ssd_scan at mamba2-780m's prefill, a long prefill, jamba's 128 heads
   of (64, 64) at its three prefills (1, 4 and 32 chunks; the five
   timed), the JAX package's test dims and two tail cases; the ssd_scan
   backward kernel at phase 8d's train shapes (mamba2's 2 x 4096 and
   jamba's 1 x 2048, both timed) and the forward's cases, with and
   without h0 and a gradient on h_last, against autograd through the
   plain version (dstates and dh0 bitwise, the decay gradient within
   1e-6 relative L2);
5. the fleet path: solve CR1(1.45) and CR2(0.78) at their default steps
   through the kernels (launch counts reset just before and read just
   after), then with `use_kernel=False`, and compare;
5b. the streaming path at the same fleet: a 24-tick rolling-horizon day
   of `ForecastStream.caiso(n_ticks=24, horizon=48, seed=7)` per policy
   (CR1(1.45) cold 600 / warm 150 steps, CR2(0.78, outer 6) cold 400 /
   warm 100 a round): the per-tick loop `run(24)` (eager, through the
   kernels), then `run_scanned(24)` on a fresh solver twice (the first
   captures the day as a CUDA graph, the second replays it and is timed,
   launch counts reset just before and read just after, and counted on
   the device by `torch.profiler` on one more replay), the replay held
   against the same day run eagerly (`api._day_impl`), and a warm second
   day on each solver (the first captures, the second replays); then a
   6-tick day through the kernels against the generic engine at W = 130;
5c. the batched lanes at the same fleet: al_step with 4 lanes (CR1 and
   CR2, f32 and bf16 moments, shared and per-lane fleet constants, rows
   ordered by kind) bitwise against 4 one-lane calls and against its
   plain version, timed beside them, and with 16 lanes of (W, T) carbon
   rows and per-row steps beside shared fleet constants (a multi-region
   ensemble's call) against its plain version and timed; then, each
   batched call with its
   launch counts reset just before and read just after and held
   against its loop of `solve()` calls: `api.sweep` of CR1 over lam in
   {1.0, 1.2, 1.45, 1.6, 2.2} (600 steps), of CR2 over cap_frac in
   {0.70, 0.74, 0.78, 0.82} (6 x 400), the CR1 sweep refined warm from
   `stack_states` of its results (150 steps); `evaluate_ensemble` of
   CR1(1.45) over DuckPerturb(8, seed=0) + CambiumMix(8, seed=1) and of
   CR2(0.78) over DuckPerturb(6, seed=0) + CambiumMix(6, seed=1) +
   FleetJitter(4, seed=2) (S = 16 each), with `report()`; and
   `run_streaming_ensemble` of CR1 over ForecastRegime(4, seed=0), cold
   600 / warm 150, 24 ticks, two streams against solo controllers. The
   CR1 sweep is counted once more by `torch.profiler`; at W = 130 the
   sweeps through the kernels are held against the generic engine;
5d. the policies: CR3 at the same fleet and its default budget (600
   steps x 3 a clearing round) through the kernels (launch counts reset
   just before and read just after: dr_features once an inner step and
   once a round) and then through the plain path (the same rounds and
   balance, rho within 1e-4, 0.05 pp); a CR3 sweep over rho in {0.01,
   0.02, 0.04} at 150 steps, each lane against its `solve()`; B1(F=0.75)
   and B3(depth=0.3) against their closed forms in numpy, one dr_features
   launch each; the paper's four-workload problem (the phase-3 models
   over `caiso_2021(48)`) through the SLSQP reference in float64 on the
   card (`solve_slsqp` of CR1(1.45) and CR2(0.78) at 250 iterations,
   CR1 a second time with its iterates held bitwise equal to the first
   call's, `solve_cr3` at rho 0.02) beside the fleet CR1, CR2 and CR3 on
   `FleetProblem.from_problem`, held within the JAX package's bounds
   (`tests/test_engine.py`), and one line of carbon % and penalty % for
   each of the seven policies;
5e. multi-region: `synthetic_regional_fleet(10_000, ["CA", "TX", "NY"],
   hours=48, seed=0, utc_offsets="auto")` on phase 3's templates (R =
   3, its default topology); CR1(1.45) and CR2(0.78) through the kernels
   (al_step fed a carbon row per fleet row and per-row step multipliers;
   launch counts reset just before and read just after each call, as
   every call below) against the generic engine (0.05 pp), with the
   fused CR1's device idle share from `torch.profiler`; R = 1 of the
   main fleet bitwise equal to its single-region solves; a CR1 sweep over
   lam in {1.0, 1.45, 2.2} against its loop (0.01 pp); CR3 at 150 steps
   (not its default 600: chip_smoke's wall) through dr_features and
   plain (the same rounds, each region's rho within 1e-4); CR1 with
   the migration post-stage (the plan unchanged, the flows within every
   cap) and with coupled migration (no less carbon at equal
   curtailment), and CR1 priced on one region's signal for the whole
   fleet, per region, at equal curtailment;
5f. regions in the streaming and batched lanes, on phase 5e's fleet: the
   per-region sums (index_select over each region's rows) bitwise
   against their mask form; a 24-tick day of CR1 and of CR2 (budgets as
   5b) with one stream per region,
   `ForecastStream.regional(np.tile(mci, (1, 2)), horizon=48,
   revision_sigma=0.03, seed=7)`: the per-tick loop, the day captured
   and replayed (launch counts reset just before the replay and read
   just after, and counted on the device by `torch.profiler` on one more
   replay, with its idle share), the replay against the eager day, a
   warm second day, an R = 1 day of the main fleet bitwise against its
   single-region day; `evaluate_ensemble` of CR1(1.45) and CR2(0.78) over
   RegionalDivergence(16, seed=0) without the topology, and of CR1 over
   RegionalDivergence(4, seed=1) with it (each scenario's migration
   credit in both lanes), each batched against its loop;
   `run_streaming_ensemble` of CR1 over ForecastRegime(4, seed=0)'s
   groups of one stream per region, 24 ticks, two groups against solo
   controllers; the CR1 sweep of 5e refined warm from `stack_states`
   (150 steps), each lane bitwise its warm `solve()`;
5g. fleet row sharding on `torch.distributed`: CR1(1.45), CR2(0.78) and
   CR3 (40 steps, on both sides) on phase 3's fleet and CR1 and CR2 on
   phase 5e's (without its topology) solved unsharded, then through
   `SolveContext(mesh=make_fleet_mesh())` in a world-1 NCCL group in
   this process and on 3 gloo processes on the one card, spawned before
   phase 5e so that their start-up runs beside 5e and 5f (W = 10,000
   pads to 10,002; the regional fleet on a (3, 1) (region, fleet)
   mesh), each rank's launch counts reset just before and read
   just after every solve and held equal to the unsharded solve's, its
   carbon and penalty within 0.01 pp of it, CR3's rounds and balance
   equal and rho within 1e-4 (one round) or 2 %, pad rows of the state
   0, the ranks' plans bitwise equal; then, on the same fleets and
   groups, sweeps, days, ensembles and streaming over the mesh: a CR1
   sweep at lam (1.0, 1.45, 2.2) and a CR2 sweep at cap_frac (0.74,
   0.78), outer 2, each at 40 steps; a 24-tick CR1 day and CR2 day
   (outer 2) at cold 40 / warm 10 steps over `ForecastStream.caiso(
   n_ticks=24, horizon=48, seed=7)` and a 24-tick CR1 day on the
   regional fleet with one stream per region (as 5f), each run twice (a
   capture, then a replay); `evaluate_ensemble` of CR1(1.45) and
   CR2(0.78, outer 2) over DuckPerturb(4), FleetJitter(2) and
   FlexMixShift(2) (S = 8) at 40 steps; `RollingHorizonSolver(mesh=...)`
   of CR1(1.45) over 3 ticks (cold 40 / warm 10) through `run()` and
   through `run_scanned()`; in the NCCL group every lane, scenario, day
   (committed, D, state) and tick bitwise the unsharded call's, on the
   gloo ranks the ranks bitwise to each other, within 0.01 pp in carbon
   and penalty of the unsharded call, a day's committed hours within
   5e-3 NP of it and the replay within 1e-6 NP of the capture day, each
   rank's launches the unsharded call's and its state (W_pad, T); max
   |dD|, bitwise or not, each
   rank's walls and the phase's wall logged;
6. the serving paths, each at full width (random weights from a seeded
   generator on the card), through `serve_requests` at max_batch 8, then
   4 (launch counts reset just before and read just after each path),
   then the prefill logits through the kernels are held against those
   through the plain versions: stablelm-3b serves 8 requests of
   120-token prompts, mamba2-780m 8 requests of 384-token prompts,
   qwen3-32b (qk-norm: 4L + 1 norms a step) and granite-20b (MQA) at
   full depth in bf16 parameters 8 requests of 64-token prompts, each
   with 16 new tokens, one model resident at a time (qwen3-moe-30b-a3b,
   the fifth path, is served in 6d, after phase 8);
6b. whisper-large-v3 at full width and depth (f32 masters and one bf16
   copy): `encode` of 8 seeded frame sets of 1500, `start_cache`, a
   4-token prompt and 124 greedy `decode_step`s to max_len 128, each
   timed, with launches by counter (encode 2L_enc + 1 rmsnorm and L_enc
   flash attention, a step 3L_dec + 1 and none, the teacher-forced
   forward 2L_enc + 3L_dec + 2 and L_enc + 2L_dec); the steps' logits
   against the teacher-forced `forward` over the same tokens, `encode`
   and `forward` through the kernels against the plain versions; the
   idle share of one profiled decode step; peak memory;
6c. the other dense options at full width, 8 layers, bf16 parameters:
   qwen1.5-110b (8 of 80) with seeded qkv biases, and qwen2-vl-72b (8 of
   80) on a vlm prefill (a quarter of the positions vision embeddings,
   M-RoPE positions on a 2-D patch grid then the text), prefill logits
   through the kernels against the plain versions; granite-20b (8 of
   52) over 16 decode steps with the int8 KV cache beside the bf16 one
   (finite logits; their agreement reported);
6d. (after phase 8) mixture of experts and multi-head latent
   attention, bf16 parameters, one model resident at a time, each served
   as phase 6 serves (8 requests of 64-token prompts, 16 new tokens,
   max_batch 8 then 4, launches by counter): qwen3-moe-30b-a3b at full
   width and depth (48 layers, 128 experts top-8, qk-norm) and
   deepseek-v3-671b at full width and 2 of its 61 layers without its MTP
   head (MLA: 4L + 1 norms a step; 256 experts top-8 and a shared one),
   both at the published capacity
   factor 1.25 with the einsum dispatch; the prefill logits through the
   kernels against the plain versions with free routing (and, if that
   misses with some expert set flipped, with the kernel path's expert
   ids replayed into the plain path), the share of (token, layer) expert
   sets that agree and of slots dropped; layer 0's scatter dispatch
   against the einsum one; a profiled decode step's idle share;
   deepseek's greedy decode over the latent cache against the
   teacher-forced forward at capacity factor 8;
6e. (after 6d) the hybrid family: jamba-v0.1-52b at full width and 16 of
   its 32 layers (two 8-layer groups: 14 Mamba-2 and 2 attention layers,
   8 MoE FFNs of 16 experts top-2), bf16 parameters, the published
   capacity factor 1.25 and the einsum dispatch, served as phase 6d
   serves (launches 2L + L_ssm + 1 rmsnorm a pass, one flash attention
   per attention layer and one ssd_scan per Mamba-2 layer of a prefill);
   the prefill logits through the kernels against the plain versions on
   2 x 1024 tokens (4 chunks, so that ssd_scan carries state across
   chunks), free and, if that misses with an expert set flipped,
   replayed; the dispatches on its first MoE layer; a profiled decode
   step's idle share; its greedy decode over the mixed cache (k/v in the
   attention layers, the SSM state and conv tail in the others) against
   the teacher-forced forward at capacity factor 8, reported; one timed
   1 x 8192 prefill beside its analytic FLOPs and bytes
   (`launch/analytics.analytic_record`), its share of the card's bf16
   peak and of its roofline bound; then the same decode check, required,
   in float32 at full width on 8 layers of 16 experts and on 16 layers
   (two groups) of 8 experts;
7. guardrails and observability, on phase 3's W = 10,000 fleet through
   the kernels unless stated (every count reset just before and read just
   after a counted run): CR1(1.45) at 600 steps and CR2(0.78) at 6 x 400
   with `sanitize=True`, bitwise the unsanitized solves at the same
   launches, and a NaN in one hour of `mci` raising `SanitizeError`
   naming its site where the unsanitized solve returns NaNs; a sanitized
   24-tick CR1 day (5b's stream and budgets) captured as a graph of its
   own and replayed, bitwise the unsanitized replay at 512 / 24 launches,
   a NaN in tick 5's forecast raising after the replay and a clean day
   then passing on the same graph; telemetry on the generic engine
   (CR1 at 120 steps, CR2 at 2 x 60) bitwise off, a sample every 10
   steps, refused with the kernels; a CR1 `RollingHorizonSolver` with
   the tick ledger and `guard_recompiles`: a 24-tick loop, then three
   days on a fresh solver, the third (warm: 456 / 24 launches) under
   `recompile_guard(0)` with no capture and no build and bitwise a
   solver's without the ledger, the report CLI exiting 0; `span` around
   a solve no shorter than CUDA events inside it; `profile`'s trace;
8. training stablelm-3b (batch 2 x 4096, the JAX package's train_4k
   sequence; bf16 compute, f32 masters, remat): 8a, the rmsnorm and
   flash-attention autograd Functions at the step's shapes, forwards
   bitwise the buffer-free kernel calls, backwards against autograd
   through the plain versions (1e-5 f32, 2e-2 bf16, relative L2), timed
   forward plus backward beside the plain versions, `F.rms_norm` and
   SDPA, and their bounds; `loss_fn` and its gradient at full width and 2 layers through
   the kernels against the plain versions (loss 1e-3 relative, each leaf
   0.05 relative L2); 8b, the coordinator's paper fleet calibrated
   (after every timed phase before it) and the CR1(1.45) throttle of
   `FleetCoordinator.plan`, then `train()` at full width and depth for 6
   steps (launches 129 / 64 a step, a failure at step 3 before any
   checkpoint retried in place, the final 33.5 GB checkpoint's snapshot
   and write timed, then restored bitwise beside the live state and
   deleted), the 32-layer step through `make_train_step` from that state
   (ms a step, tokens/s, peak memory, launches by counter and by
   `torch.profiler`, the idle share of a profiled step), and `train()`
   under the plan's throttle over 96 steps of the integration tests'
   config (the budgets `hour_budgets` gives, summing to the steps, some
   cut below the base budget), and the runner on that config (40 steps
   with the loss falling, a failure at step 13 restored onto the card);
   8c, training whisper-large-v3 at full width and depth: three
   `make_train_step` steps of batch 8 x 448 decoder tokens over 1500
   frames each (bf16 compute, f32 masters and moments, remat; launches a
   step 4L_enc + 1 + 6L_dec + 1 rmsnorm and 2L_enc + 4L_dec flash
   attention), a profiled step's idle share, and loss and gradients at 2
   + 2 layers through the kernels against the plain versions; no
   checkpoint; every count reset just before and read just after each
   run; 8d, training the SSM, hybrid, MoE and MLA models (no
   checkpoint): mamba2-780m's loss and gradients at full width and 2
   layers through the kernels (rmsnorm, ssd_scan and its backward
   kernel under `SSDScanFn`) against the plain versions, then
   `make_train_step` at full width and depth (48 layers, batch 2 x
   4096, remat) for 6 steps, launches a step 4L + 1 rmsnorm, 2L ssd_scan
   and L backward by counter and by `torch.profiler`, ms a step,
   tokens/s, peak memory and a profiled step's idle share; then at full
   width and their cuts (TRAIN_CUTS), loss and gradients kernels
   against plain (free routing, or on the kernel path's expert ids if
   free routing misses with an expert set flipped) and 2 steps each:
   jamba-v0.1-52b (one 8-layer group, 3 experts), qwen3-moe-30b-a3b (4
   layers) and deepseek-v3-671b (1 layer and its MTP head, 12 experts);
   8e, training on a model mesh: stablelm-3b at full width and 2 layers
   (remat), a global batch of 4 x 1024, unsharded through
   `make_train_step` for 3 steps (the yardstick, run once); then over a
   world-1 NCCL mesh in this process (`elastic.build`, 2 sharded steps,
   `resize` onto another 1 x 1 mesh), the loss and every p, m and v leaf
   bitwise the yardstick's after 2 steps and after the resize, launches
   a step the unsharded counts (4L + 1 rmsnorm, 2L flash attention); and
   on 4 gloo processes sharing the card, spawned at the start of phase 8
   and holding nothing on it until 8e begins (8d peaks at 69 GiB): 2
   steps on a 2 x 2 mesh, each loss within 1e-3 relative of the
   yardstick's, each leaf's update (p after - p before) within relative
   L2 0.05 of the yardstick's, each rank's launches a step the unsharded
   counts and its state bytes the rules' count, the gathered state
   bitwise across ranks; `resize` to a 1 x 2 mesh (ranks 2 and 3 leave),
   the new blocks bitwise the gathered state, a third step within 1e-3
   of the yardstick's third; `compressed_psum_pod` on CUDA tensors over
   the pod axis of a (pod 2, data 1, model 2) mesh of the same ranks on
   the reference test's case (error and residual < 0.05); each rank's
   walls, gather and reduction bytes and peak memory logged;
9. print the kernels' JSON line and, last, the device line.

Imports nothing of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
W_MAIN, T_MAIN, W_TAIL = 10_000, 48, 130
# Reduced calibration of the penalty models (see the printed line): the
# EDD simulations are a pure-Python loop on the host.
CAL_SAMPLES, CAL_JOBS = 32, 1000
H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12  # bfloat16, tensor cores, dense
PP_TOL = 0.05                # fused vs generic, percentage points
PRESERVATION_TOL = 1e-3
# The serving paths, at the two admission limits of the power knob
# (examples/serve_rts.py): (arch, requests, prompt tokens, new tokens,
# max_len, parameter dtype). stablelm-3b's 8 requests make one batch at
# max_batch 8 and two at 4, as every path here, which keeps the script
# inside its time limit. mamba2-780m's prompts of 384 make each prefill's
# ssd_chunked two chunks of 256 with a padded tail of 128.
# qwen3-32b (qk-norm, GQA 8:1), granite-20b (MQA) and qwen3-moe-30b-a3b
# (128 experts top-8) run at full width and depth with the reference's
# `param_dtype="bfloat16"`: 61.02, 52.46 and 56.87 GiB of parameters, where
# f32 masters would not fit on the card. Phase 6 serves the first four;
# qwen3-moe is served in phase 6d, which runs after phase 8.
SERVE_PATHS = (("stablelm-3b", 8, 120, 16, 136, "float32"),
               ("mamba2-780m", 8, 384, 16, 400, "float32"),
               ("qwen3-32b", 8, 64, 16, 96, "bfloat16"),
               ("granite-20b", 8, 64, 16, 96, "bfloat16"),
               ("qwen3-moe-30b-a3b", 8, 64, 16, 96, "bfloat16"))
MOE_SERVE = 4                   # the index in SERVE_PATHS phase 6d serves
SERVE_BATCHES = (8, 4)
# Prefill logits through the kernels vs through the plain versions, in
# bfloat16 over 32 or 48 layers of random weights: relative L2 error and
# the share of positions whose top-1 token agrees.
LOGITS_REL_TOL, TOP1_MIN = 0.05, 0.9
# Phase 6d: deepseek-v3-671b at full width and DEEPSEEK_LAYERS of its 61
# layers, without its MTP head (`mtp_depth=0`; the serving path reads
# none), bf16 parameters (24.9e9, ~46 GiB), served as the SERVE_PATHS
# models are (8 requests of 64 tokens, 16 new); its greedy decode over the
# latent cache held against the teacher-forced forward over
# DEEPSEEK_DECODE tokens at capacity factor DECODE_CF, the reference's
# no-drop setting (`reduced()`): at the published 1.25 a prefill group of
# 256 tokens and a decode group of 8 drop different slots by design.
DEEPSEEK = ("deepseek-v3-671b", 8, 64, 16, 96, "bfloat16")
DEEPSEEK_LAYERS, DEEPSEEK_DECODE, DECODE_CF = 2, 32, 8.0
# Phase 6e: jamba-v0.1-52b (hybrid: Mamba-2, GQA attention and MoE) at full
# width and JAMBA_LAYERS of its 32 layers (two of its four 8-layer block
# groups: 14 Mamba-2 and 2 attention layers, 8 MoE FFNs), bf16 parameters
# (26.0e9, 48.44 GiB; 24 layers would take 72.2 GiB), served as the
# SERVE_PATHS models are at the published capacity factor 1.25 and the
# einsum dispatch. Its prefill logits check runs on JAMBA_PREFILL tokens
# (4 chunks of 256, so that ssd_scan carries state across chunks), and
# one prefill of JAMBA_LONG tokens is timed beside its analytic FLOPs
# (`launch/analytics.py`), the long context the config is marked for.
# Its greedy decode over the mixed cache (k/v in the attention layers,
# SSM state and conv tail in the others), DEEPSEEK_DECODE steps at
# DECODE_CF, is reported for the bf16 model and held against the
# teacher-forced forward in float32 on each JAMBA_F32 model at full
# width: (layers, experts) 8 of 16 (one block group, every layer kind;
# 49.44 GiB) and 16 of 8 (two groups, so that the group loop runs past
# its first group; 54.87 GiB, where 16 layers of 16 experts would take
# 96.87 GiB). In bf16 the random Mamba-2 layers amplify the two paths'
# rounding past the bound (relative L2 0.2465 at 16 layers, 0.1343 at 8;
# float32 at 8: 1.784e-05, on an H100), and the reference's own bf16
# decode misses it as the port's does on the CPU
# (scripts/port_bf16_decode_gap.py; PERF.md).
JAMBA = ("jamba-v0.1-52b", 8, 64, 16, 96, "bfloat16")
JAMBA_LAYERS, JAMBA_F32 = 16, ((8, 16), (16, 8))
JAMBA_PREFILL, JAMBA_LONG = (2, 1024), (1, 8192)
# The MoE layer alone, scatter against einsum dispatch on one bf16 input
# at full width: relative L2 within 2^-6 (the einsum combine sums its k
# weighted slots in f32; scatter rounds each weighted slot to bf16 first).
DISPATCH_REL_TOL = 2.0 ** -6
# Phase 6b: whisper-large-v3 at full width and depth (1,954,032,640
# parameters: f32 masters and one bf16 copy), 8 seeded frame sets of 1500,
# a 4-token prompt and greedy decode steps to max_len 128.
WHISPER_PARAMS = 1_954_032_640
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_LEN = 8, 4, 128
# Phase 6c: the other dense options at full width and OPTION_LAYERS layers
# (qwen1.5-110b and qwen2-vl-72b of 80, granite-20b of 52), bf16
# parameters; prefills of 4 x 64 positions (a quarter of them vision
# embeddings for the vlm), the qkv biases filled with 0.02·N(0, 1) (the
# reference initialises them to zeros), and KV_QUANT_STEPS decode steps of
# the int8 cache beside the bf16 one on the same tokens.
OPTION_LAYERS, OPTION_BATCH, OPTION_SEQ, KV_QUANT_STEPS = 8, 4, 64, 16
# stablelm-3b prefill 8 x 120 and decode 8; mamba2-780m prefill 8 x 384
# at d 1536 (ln1, ln_f) and d_in 3072 (the gated norm), and its decode
# rows at both widths; qwen3-32b's qk-norm over rows of Dh 128 (8 x 64
# tokens x 64 heads), whisper-large-v3's encoder rows (8 x 1500 at d
# 1280), and phase 6d's prefill rows (8 x 64 tokens): qwen3-moe's d 2048,
# deepseek-v3's d 7168 and MLA's kv latent of 512 (its q latent is 1536);
# phase 6e's jamba at d 4096 and its SSM gated norm over d_in 8192: the
# serving prefill (8 x 64), the 2 x 1024 prefill, the 1 x 8192 prefill
# and the decode rows (8); then RMSNORM_TRAIN_ROWS.
# RMSNORM_TRAIN_ROWS are the rows phase 8d's train steps give the kernel
# (jamba's 1 x 2048 rows are above): mamba2-780m's 2 x 4096 at d 1536 and
# its gated norm over d_in 3072; qwen3-moe's 1 x 4096 at d 2048 and its
# qk-norm over rows of Dh 128 (32 query and 4 kv heads); deepseek-v3's 1
# x 1024 at d 7168 and its q and kv latents (1536, 512), and the same
# widths over the MTP head's 1023 positions. Held bit for bit against the
# plain version (both sum the squares in f64 and round once).
RMSNORM_TRAIN_ROWS = ((8192, 1536), (8192, 3072), (4096, 2048),
                      (131_072, 128), (16_384, 128), (1024, 7168),
                      (1024, 1536), (1024, 512), (1023, 7168),
                      (1023, 1536), (1023, 512))
RMSNORM_ROWS = ((960, 2560), (8, 2560), (3072, 1536), (3072, 3072),
                (8, 1536), (8, 3072), (32_768, 128), (12_000, 1280),
                (512, 2048), (512, 7168), (512, 512), (512, 4096),
                (512, 8192), (2048, 4096), (2048, 8192), (8192, 4096),
                (8192, 8192), (8, 4096), (8, 8192)) + RMSNORM_TRAIN_ROWS
# ssd_scan cases (B, NC, H, P, N); the first is mamba2-780m's prefill at
# max_batch 8 (S 384 in chunks of 256), the second a long prefill (1 x
# 8192), then jamba's heads (128 of P 64, state 64) at its three
# prefills: serving (8 x 64 tokens, one chunk), the logits check (2 x
# 1024, four chunks) and the long prefill (1 x 8192, 32 chunks); then the
# JAX package's test dims (tests/test_kernels.py), a P·N of no whole
# float4 (the scalar kernel) and a partial last block. The first
# SSD_TIMED are timed.
SSD_CASES = (
    (8, 2, 48, 64, 128),
    (1, 32, 48, 64, 128),
    (8, 1, 128, 64, 64), (2, 4, 128, 64, 64), (1, 32, 128, 64, 64),
    (2, 6, 4, 16, 32), (1, 12, 2, 8, 16), (3, 3, 8, 32, 64),
    (2, 5, 3, 5, 7),
    (1, 7, 3, 24, 43),
)
SSD_TIMED = 5
# The ssd_scan backward kernel's cases: the shapes of phase 8d's train
# steps first, mamba2-780m's (2 x 4096 tokens, 16 chunks of 256) and
# jamba's (1 x 2048, 8 chunks), both timed, then the forward's cases;
# each with and without an initial state and with and without a
# gradient on h_last. dstates and dh0 are held bitwise against autograd
# through the plain version, the decay gradient (the same f32 products
# summed in another order) at relative L2 SSD_DECAY_REL_L2.
SSD_BWD_CASES = ((2, 16, 48, 64, 128), (1, 8, 128, 64, 64)) + SSD_CASES
SSD_BWD_TIMED, SSD_DECAY_REL_L2 = 2, 1e-6
# Flash-attention cases (B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset,
# bfloat16); the first is stablelm-3b's prefill at max_batch 8.
FA_CASES = (
    (8, 120, 120, 32, 32, 80, 80, True, 0, True),
    (2, 120, 120, 32, 32, 80, 80, False, 0, True),     # non-causal
    (2, 200, 200, 8, 2, 64, 64, True, 0, True),        # GQA, tail
    (1, 64, 256, 8, 1, 128, 128, False, 0, True),      # MQA cross, Dh 128
    (2, 70, 70, 4, 2, 64, 32, True, 0, True),          # Dv != Dh
    (1, 24, 80, 4, 2, 80, 80, True, 56, True),         # q_offset
    (1, 17, 33, 2, 1, 32, 48, True, 16, False),        # float32, Dv > Dh
    (1, 50, 50, 4, 2, 30, 30, True, 0, True),          # Dh = 30: scalar loads
    (1, 1024, 1024, 32, 32, 80, 80, True, 0, True),    # 16 kv blocks
    (8, 1500, 1500, 20, 20, 64, 64, False, 0, True),   # whisper encoder
    (8, 128, 1500, 20, 20, 64, 64, False, 0, True),    # whisper cross
    (8, 128, 128, 20, 20, 64, 64, True, 0, True),      # whisper decoder
    (8, 64, 64, 48, 1, 128, 128, True, 0, True),       # granite-20b, MQA
    (8, 64, 64, 64, 8, 128, 128, True, 0, True),       # qwen3-32b, GQA 8:1
    (8, 64, 64, 128, 128, 192, 128, True, 0, True),    # deepseek MLA prefill
    (1, 1024, 1024, 128, 128, 192, 128, True, 0, True),  # MLA, 16 kv blocks
    (2, 250, 333, 16, 16, 192, 128, False, 0, True),   # MLA, ragged tails
    (1, 70, 326, 16, 16, 192, 128, True, 256, True),   # MLA, q_offset
    (1, 50, 90, 16, 16, 192, 128, True, 40, False),    # MLA, float32
    (8, 64, 64, 32, 8, 128, 128, True, 0, True),       # jamba, GQA 4:1
    (2, 1024, 1024, 32, 8, 128, 128, True, 0, True),   # jamba's check
    (1, 8192, 8192, 32, 8, 128, 128, True, 0, True),   # jamba, long
    (1, 2048, 2048, 32, 8, 128, 128, True, 0, True),   # jamba, train (8d)
    (1, 4096, 4096, 32, 4, 128, 128, True, 0, True),   # qwen3-moe, train
    (1, 1023, 1023, 128, 128, 192, 128, True, 0, True),  # MTP layer, train
)
FA_LONG = 8                     # timed beside the serving shape
FA_WHISPER = (9, 10)            # timed: the encoder and cross-attention
FA_MLA = (14, 15)               # timed: deepseek's prefill, 1024 tokens
FA_JAMBA = (19, 20, 21)         # timed: jamba's three prefills
# The streaming day: 24 ticks of a 48-hour horizon, per policy (name,
# cold steps, warm steps a round, AL rounds): the JAX package's
# controller defaults for CR1, `solve_day`'s cold // 4 for CR2.
DAY_TICKS, TAIL_TICKS, DAY_SEED = 24, 6, 7
DAY_POLICIES = (("cr1", 600, 150, 1), ("cr2", 400, 100, 6))
# The batched lanes (phase 5c): sweep grids (examples/policy_pareto.py's
# lam grid; CR2 caps around the paper's 0.78), the warm refinement's
# budget, the ensembles' and the streaming ensemble's sizes.
LANES_KERNEL_N = 4
CR1_LAMS = (1.0, 1.2, 1.45, 1.6, 2.2)
CR2_CAPS = (0.70, 0.74, 0.78, 0.82)
REFINE_STEPS, STREAM_LANES = 150, 4
LANE_PP = 0.01       # batched lane vs its solve() loop (JAX contract)
SCAN_PP = 0.01       # per-tick loop vs day, realized carbon (JAX contract)
COMMIT_ATOL = 5e-3   # per-tick loop vs day, committed NP (JAX contract)
REPLAY_TOL = 1e-6    # graph replay vs the eager day, NP
TRACE_TRIES = 3      # profiler traces of one replay (`device_launches`)
TRACE_PAD_S = 0.25   # host time in a profiler session around its work
TRACE_FILL = 256     # spin kernels traced before and after the work
TRACE_FILL_CYCLES = 100_000   # clock cycles each spin kernel waits
# CR3 (phase 5d): the kernel path vs the plain path at the default budget,
# rho relative; a sweep over rho (the JAX package's sweep test grid around
# the paper's 0.02) at 150 steps, each lane vs its solve() at the JAX
# package's sweep bounds (tests/test_api.py: rho 1e-3, 0.05 pp).
CR3_RHO_RTOL = 1e-4
CR3_RHOS = (0.01, 0.02, 0.04)
CR3_SWEEP_STEPS = 150
CR3_LANE_RHO_RTOL = 1e-3
# Multi-region (phase 5e): the R = 3 CA/TX/NY fleet on the UTC clock
# (the JAX package's acceptance fleet, tests/test_multiregion.py), a lam
# sweep over its Pareto range, CR3 at a short budget through the kernels
# and its kernel-vs-plain check; per-region rho within CR3_RHO_RTOL there.
REGION_STATES = ("CA", "TX", "NY")
REGION_LAMS = (1.0, 1.45, 2.2)
CR3_REGION_STEPS = 150
# Regions in the streaming and batched lanes (phase 5f): one stream per
# region over the fleet's own traces, the regional-divergence ensembles
# (S = 16 without a topology; S = 4 with it, each post-stage ~2 s).
REGION_STREAM_SIGMA, REGION_STREAM_SEED = 0.03, 7
REGION_ENSEMBLE_S, REGION_CREDIT_S = 16, 4
# Fleet sharding (phase 5g): a world-1 NCCL group in this process and
# SHARD_RANKS gloo processes on the one card (W = 10,000 pads to 10,002),
# each held to the unsharded solve within the JAX package's sharded bound
# (tests/test_fleet_sharding.py:84-97); CR3 at SHARD_CR3_STEPS on both
# sides (its generic engine is host-bound: ~4.5 ms a step at this W).
SHARD_RANKS = 3
SHARD_PP = 0.01
SHARD_CR3_STEPS = 40
SHARD_RHO_MULTI = 0.02          # tests/test_torch_cr3.py: RHO_MULTI
SHARD_WAIT_S = 600              # a rank's wait for each signal
# Sweeps, days, ensembles and streams over the same meshes: 40 steps (a
# day's cold tick; its warm ticks 10), the lam and cap_frac grids, 3
# streaming ticks; a day's committed hours within the JAX package's
# loop-vs-day contract (tests/test_streaming.py:320-323) of the unsharded
# day's, and its replay within SHARD_REPLAY_NP of its capture day.
SHARD_STEPS, SHARD_WARM_STEPS = 40, 10
SHARD_LAMS, SHARD_CAPS = (1.0, 1.45, 2.2), (0.74, 0.78)
SHARD_STREAM_TICKS = 3
SHARD_DAY_NP, SHARD_REPLAY_NP = 5e-3, 1e-6
# Training (phase 8): stablelm-3b at full width, batch 2 x 4096 (the JAX
# package's train_4k sequence), 6 steps under CR1(1.45)'s throttle. 8a
# holds loss_fn and its gradient through the kernels against the plain
# versions at 2 layers (bf16 bounds, as serving's logits), and the two
# autograd Functions' backwards against autograd through the plain
# versions. train() runs all 32 layers for 6 steps with one final 33.5
# GB checkpoint, so that the whole run writes ~31 GiB to disk (its budget
# is 45 GiB): under the throttle each of the 6 one-step hours (6 steps
# over 48 hours make every budget 1) would end with a checkpoint, 201 GB.
# train() runs under the plan's throttle on the integration tests'
# config, at THROTTLE_STEPS = 2 x 48, where the budgets vary.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LAMBDA = 4096, 2, 6, 1.45
TRAIN_FAIL_STEP, THROTTLE_STEPS = 3, 96
GRAD_LAYERS = 2
LOSS_RTOL, GRAD_REL_L2 = 1e-3, 0.05
# Training whisper-large-v3 (phase 8c): batch 8 x 448 decoder tokens
# (Whisper's decoder context) over 1500 frames each, three steps.
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 8, 448, 3
BWD_F32, BWD_BF16 = 1e-5, 2e-2
# Phase 8d: training the SSM, hybrid, MoE and MLA models (bf16 compute,
# f32 masters and moments, remat, the train_4k batch where it fits).
# mamba2-780m at full width and depth (48 layers; 0.78e9 parameters at 18
# bytes each, f32 master, gradient, m and v and the bf16 copy, 13.1 GiB),
# batch 2 x 4096, SSM_TRAIN_STEPS steps, and its loss and gradients at
# GRAD_LAYERS layers through the kernels against the plain versions. The
# others at full width, each at the cut the card's 80 GB forces
# (architecture, config changes, batch (B, S), steps, why), loss and
# gradients of the cut model kernels against plain, then its steps.
# deepseek-v3 keeps its MTP head (a second MLA + MoE layer outside the
# remat checkpoints, and a second f32 logits over its 129,280 tokens).
SSM_TRAIN_STEPS = 6
TRAIN_CUTS = (
    ("jamba-v0.1-52b", {"num_layers": 8, "experts": 3}, (1, 2048), 2,
     "one 8-layer block group of 32 layers (every layer kind; a group is "
     "one remat checkpoint) and 3 of 16 experts, top-2 kept (so routing "
     "still chooses; at 2 every token would meet every expert): one group "
     "holds 13.27e9 parameters with 16 experts (222.5 GiB of training "
     "state), 4.81e9 with 4 (80.7 GiB), 4.11e9 with 3 (68.9 GiB)"),
    ("qwen3-moe-30b-a3b", {"num_layers": 4}, (1, 4096), 2,
     "4 of 48 layers (3.11e9 parameters, 52.2 GiB of training state; 48 "
     "layers hold 30.5e9, 511.8 GiB)"),
    ("deepseek-v3-671b", {"num_layers": 1, "experts": 12}, (1, 1024), 2,
     "1 of 61 layers and the MTP layer, 12 of 256 routed experts, top-8 "
     "and the shared one kept (3.48e9 parameters, 58.3 GiB of training "
     "state; one full layer holds 11.6e9; at 16 experts, 3.83e9 and 64.2 "
     "GiB, the train step ran out of the card's memory, 70.10 GiB held "
     "and 3.45 GiB asked, on an H100 80GB; 8 would route every token to "
     "every expert)"),
)
# Phase 8e: training on a model mesh. stablelm-3b at full width, MESH_LAYERS
# layers and remat, a global batch of MESH_BATCH x MESH_SEQ: a rank of the
# 2 x 2 mesh holds ~1.25 GB of p, m and v (416e6 parameters x 12 bytes /
# 4). MESH_RANKS gloo processes share the card (NCCL refuses two ranks on
# one device); the yardstick is this process's unsharded step. Bounds set
# before any run: bf16 losses within MESH_LOSS_RTOL, each
# leaf's update within MESH_UPDATE_L2 relative L2 (8a/8b's yardstick),
# compression error and residual below MESH_COMPRESS_TOL (the reference
# test's, `tests/test_runtime.py:150-158`).
MESH_LAYERS, MESH_BATCH, MESH_SEQ, MESH_SEED = 2, 4, 1024, 8
MESH_RANKS = 4
MESH_LOSS_RTOL, MESH_UPDATE_L2, MESH_COMPRESS_TOL = 1e-3, 0.05, 0.05
MESH_WAIT_S = 1500             # a rank's wait for each signal


def log(*a):
    print(*a, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded) for the kernel checks
# ---------------------------------------------------------------------------
def feature_inputs(np, W, T, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(0.0, 1.0, (W, T))
    u = np.abs(rng.normal(2.0, 0.3, (W, T))) + 0.5
    j = np.abs(rng.normal(1.0, 0.2, (W, T))) + 0.1
    # Hinge-crossing rows: running sums cross zero mid-horizon, both ways.
    up_down = np.r_[np.full(T // 2, 0.7), np.full(T - T // 2, -0.9)]
    d[0], d[1] = up_down, -up_down
    u[:2], j[:2] = 2.0, 1.5
    return d, u, j


def al_step_inputs(np, p, *, mode, seed, rts_only=True, stable=False,
                   per_row_cvec=False, tiny_v=False, at_bounds=False,
                   step_rows=False):
    """(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal) in the kernel's
    packed layout, from the rows of fleet `p`, drawn as the JAX package's
    kernel tests draw them (`tests/test_al_step.py`): `rts_only` recasts
    batch rows as smooth cubic RTS rows (no hinge); `stable` starts every
    batch hinge clearly on its active side. Two differences: every row
    steps (rowp col 11 = 1, as on the main path), and v >= m², a state
    Adam can reach. `tiny_v` draws v as those tests do, |N(0, 1e-4)|,
    mostly below m²: there the step m/√v is ill-conditioned. `at_bounds`
    spreads x over the whole box, many hours at a bound, and zeroes the
    batch betas so no hinge enters the gradient: the day projection then
    has bounds to fix. `step_rows` draws rowp col 11 per row in [0.5, 2]
    (a multi-region fleet's per-region step scales ride there, beside its
    per-row carbon rows, `per_row_cvec`)."""
    W, T = p.usage.shape
    rng = np.random.default_rng(seed)
    usage = p.usage.astype(np.float32)
    E = p.entitlement.astype(np.float32)[:, None]
    isb = np.zeros(W, bool) if rts_only else p.is_batch.astype(bool)
    rts = np.where(p.is_batch[:, None], [[2e-4, 1.5e-3, 0.04]],
                   p.rts_coeffs) if rts_only else p.rts_coeffs
    hi = np.minimum(np.float32(p.max_curtail_frac) * E, usage)
    lo = np.where(isb[:, None], -(E - usage), np.float32(0.0))
    if at_bounds:
        x = np.clip(rng.normal(0.0, 0.6, (W, T)) * usage, lo, hi)
    elif stable:
        x = np.clip(0.25 * usage + 0.01, lo, hi)
    else:
        x = np.clip(rng.normal(0.0, 0.3, (W, T)), lo, hi)
    m = rng.normal(0.0, 0.01, (W, T))
    v = np.abs(rng.normal(0.0, 1e-4, (W, T)))
    if not tiny_v:
        v = v + m ** 2
    rowp = np.zeros((W, 12))
    rowp[:, 0:3] = rts
    rowp[:, 3:6] = 0.0 if rts_only or at_bounds else p.betas
    rowp[:, 6] = p.k
    rowp[:, 7] = p.x2_kind
    rowp[:, 8] = isb
    if mode == "cr2":
        rowp[:, 9] = np.abs(rng.normal(1.0, 0.2, W))
        rowp[:, 10] = rng.normal(0.0, 0.5, W)
    rowp[:, 11] = rng.uniform(0.5, 2.0, W) if step_rows else 1.0
    cvec = rng.normal(-0.5, 0.2, (W if per_row_cvec else 1, T))
    scal = np.array([[1.45, 10.0, 0.8, 0.02, 3.0, 0.0, 0.0, 0.0]])
    return (x, m, v, usage, p.jobs, lo, hi, rowp, cvec, scal)


def al_step_lane_inputs(np, p, n, *, mode, seed, shared, lane_cvec=False,
                        **kw):
    """`al_step_inputs` for `n` lanes, rows ordered by kind (batch rows
    first, as `make_fused_inner` orders them): each lane its own iterate,
    moments, multipliers, carbon row and scalars (lam, mu and t0 differ);
    usage, jobs and bounds shared ((W, T)), or each lane's from the fleet
    scaled by its own factor ((n, W, T)); the carbon row shared ((1, T))
    or each lane's ((n, 1, T)) alike, or with `lane_cvec` each lane's
    whatever `shared` says (a multi-region ensemble's (n, W, T) carbon
    rows beside shared fleet constants, with `per_row_cvec`). Returns the
    per-lane argument lists and the stacked ones."""
    lanes = []
    for i in range(n):
        f = 1.0 if shared else 1.0 + 0.1 * i
        q = dataclasses.replace(p, usage=p.usage * f, jobs=p.jobs * f,
                                entitlement=p.entitlement * f)
        arrs = list(al_step_inputs(np, q, mode=mode, seed=seed + i, **kw))
        arrs[9] = arrs[9] * np.array([[1.0 + 0.2 * i, 1.0 + i, 1.0,
                                       1.0 + 0.1 * i, 1.0, 1, 1, 1]])
        arrs[9][0, 4] = 3.0 + i
        lanes.append(arrs)
    order = np.argsort(-lanes[0][7][:, 8], kind="stable")
    lanes = [[a[order] if a.shape[0] == p.W else a for a in arrs]
             for arrs in lanes]
    if shared and not lane_cvec:
        for arrs in lanes:
            arrs[8] = lanes[0][8]
    stacked = [np.stack(a) for a in zip(*lanes)]
    stacked[9] = stacked[9][:, 0]
    if shared:
        stacked[3:7] = lanes[0][3:7]
        if not lane_cvec:
            stacked[8] = lanes[0][8]
    return lanes, stacked


def fa_inputs(torch, case, seed, dev):
    B, Sq, Skv, H, KV, Dh, Dv, _, _, bf16 = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                 for shape in ((B, Sq, H, Dh), (B, Skv, KV, Dh),
                               (B, Skv, KV, Dv)))


def fa_live_pairs(Sq, Skv, causal, q_offset):
    """(query, key) pairs the causal mask leaves: the work this call's
    data needs."""
    if not causal:
        return Sq * Skv
    return sum(max(0, min(Skv, q_offset + i + 1)) for i in range(Sq))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _padded_trace(torch, activities):
    """`torch.profiler.profile(activities)` around the block, with
    TRACE_PAD_S of host time inside the session before and after it.
    Kineto keeps only the device records whose span lies inside the
    session's window on the host's clock, and the card's timestamps,
    carried over to that clock, can stand late on it in a long process:
    traces taken there lost whole tails of records (the last dr_features
    of a CR2 day replay, the last ~50 records of a train step, an rmsnorm
    among them) in every retake. The pads keep the block's records
    inside the window."""
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def _fill_device(torch):
    """TRACE_FILL spin kernels of TRACE_FILL_CYCLES each, then a sync."""
    for _ in range(TRACE_FILL):
        torch.cuda._sleep(TRACE_FILL_CYCLES)
    torch.cuda.synchronize()


def _traced_launches(torch, fn, names):
    """(launches of each kernel in `names`, device records of the work) of
    one run of `fn()` under `torch.profiler`, a CUDA graph's kernels
    included, in a padded window (`_padded_trace`). The trace records the
    device only: with the CPU's operators recorded too, traces of the
    32-layer train step lost ~50 device records, an rmsnorm launch among
    them, in four of five tries over two runs, while traces of the device
    alone, taken between them, held every launch. Late in a whole run,
    traces of the device alone lost the head instead: the first 51
    records of the 48-layer mamba2 step (its first ~7.7 ms, the first
    rmsnorm among them) in two of three retakes, and in three of three in
    another run. So TRACE_FILL spin kernels run inside the window before
    `fn` and again after it, and a loss at either end takes them; the
    spin kernels at each end are counted apart from the work's records.
    Logs where the work's records lie in the trace against where the host
    ran `fn`, both from the trace's start (a gap between the two that
    grows over a run is the clock offset that the pads absorb), and how
    many spin kernels each end kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with _padded_trace(torch, [ProfilerActivity.CUDA]) as prof:
        t_in = time.perf_counter()
        _fill_device(torch)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _fill_device(torch)
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    lead = 0
    while lead < len(events) and "spin_kernel" in events[lead].name:
        lead += 1
    tail = len(events)
    while tail > lead and "spin_kernel" in events[tail - 1].name:
        tail -= 1
    work = events[lead:tail]
    if work:
        first = work[0].time_range.start * 1e-3
        last = max(e.time_range.end for e in work) * 1e-3
        start = (TRACE_PAD_S + t0 - t_in) * 1e3
        log(f"[profiler] device records of the work from {first:.3f} to "
            f"{last:.3f} ms of the trace; the host ran it from about "
            f"{start:.3f} to {start + wall * 1e3:.3f} ms; spin kernels kept "
            f"{lead} of {TRACE_FILL} before it, {len(events) - tail} of "
            f"{TRACE_FILL} after it")
    return ({n: sum(f"{n}_kernel" in e.name for e in work) for n in names},
            len(work))


def device_launches(torch, what, fn, want,
                    names=("al_step", "dr_features")):
    """Launches of each kernel that the card ran during `fn()`, counted
    from `torch.profiler`'s CUDA trace, held to `want`. The trace now and
    then loses a device record (a CR2 day replay once read one dr_features
    launch short), so a trace that reads fewer launches is taken again, up
    to TRACE_TRIES times. It is let go only when it holds fewer device
    records than the trace that reads `want`: `fn` runs the same work each
    time, so that trace lost records, not launches. A trace that reads
    more than `want` fails at once."""
    short = []
    for i in range(TRACE_TRIES):
        got, n_records = _traced_launches(torch, fn, names)
        log(f"[profiler] {what}: trace {i + 1} read {got} in {n_records} "
            f"device records")
        require(all(got[n] <= want[n] for n in names),
                f"{what}: the device ran {got}, more than the expected "
                f"{want}")
        if got == want:
            for miss, n in short:
                require(n < n_records, f"{what}: the device ran {miss} "
                        f"with no device record lost, expected {want}")
            return got
        short.append((got, n_records))
    raise AssertionError(f"{what}: the device ran {[g for g, _ in short]} in "
                         f"{TRACE_TRIES} traces, expected {want}")


def sdpa_backend(torch, q, k, v, causal, enable_gqa=False):
    """The backend SDPA's dispatcher picks for these (B, heads, S, D)
    inputs (`torch._fused_sdp_choice`; no profiler session, which could
    change what a later trace records)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=causal, enable_gqa=enable_gqa)).name


def kernel_ms(torch, fn, reps=50, inner=20):
    """Median device time of one call, from CUDA events around `inner`
    calls back to back. A spin kernel queued first keeps the host's launch
    overhead out of the window; a window of one call would add the events'
    own few microseconds to it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def plain_ms(torch, fn, reps=10):
    """Median time of one call of a plain version from an idle stream to
    its end, launch gaps included, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def al_step_ops(np, rowp, T, k_steps, mode):
    """Float operations one call needs, counted from csrc/al_step.cu per
    hour and step: an RTS hour 36 (8 more for CR2's penalty sum), a batch
    hour 46 (cumsums, hinges, gradient, Adam, clip) and 10 for one pass of
    the day projection (held value, three sums, shift, two overshoots,
    final clip). One pass is the least an exact projection needs; the
    passes that fix hours are data-dependent and left out, so the bound
    stays a lower bound."""
    n_batch = int((rowp[:, 8] > 0.5).sum())
    n_rts = rowp.shape[0] - n_batch
    rts = 36 + (8 if mode == "cr2" else 0)
    return k_steps * T * (n_rts * rts + n_batch * (46 + 10))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {', '.join(build.KERNELS)} built in "
        f"{time.perf_counter() - t0:.2f} s into {build.BUILD_DIR}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # The bf16 flash attention's products run on the tensor cores (HMMA),
    # its tiles come by ldmatrix (LDSM) and asynchronous copies (LDGSTS).
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = build.library_path("flash_attention")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HMMA", "LDSM", "LDGSTS")}
    log(f"[build] flash_attention SASS ({lib.name}): {counts}")
    require(counts["HMMA"] > 0, "flash_attention SASS holds no HMMA: its "
            "products do not run on the tensor cores")


def check_close(torch, got, want, rtol, atol, what):
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))
    require(ok, f"{what}: max |kernel - plain| = {err:.3e} beyond "
                f"rtol = atol = {rtol:g}/{atol:g}")
    return err


def phase_dr_features(np, torch):
    from repro_torch.kernels.dr_features.kernel import dr_features_cuda
    from repro_torch.kernels.dr_features.ref import dr_features_ref
    dev = torch.device("cuda")
    errs, rec = [], {}
    for W in (W_MAIN, W_TAIL):
        d, u, j = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in feature_inputs(np, W, T_MAIN, seed=W))
        got = dr_features_cuda(d, u, j)
        torch.cuda.synchronize()
        errs.append(check_close(torch, got, dr_features_ref(d, u, j), 2e-4,
                                2e-4, f"dr_features W={W}"))
        if W == W_MAIN:
            rec["ms"] = kernel_ms(torch, lambda: dr_features_cuda(d, u, j),
                                  reps=100)
            rec["plain_ms"] = plain_ms(torch,
                                       lambda: dr_features_ref(d, u, j))
            nbytes = 3 * d.numel() * 4 + W * 4 * 4
            ops = 20 * d.numel()
    rec["max_abs_err"] = max(errs)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, H100_F32_OPS_PER_S)
    log(f"[check] dr_features: max abs err {rec['max_abs_err']:.3e} "
        f"(rtol = atol = 2e-4) at W = {W_MAIN}, {W_TAIL}; kernel "
        f"{rec['ms'] * 1e3:.2f} us, plain {rec['plain_ms'] * 1e3:.2f} us, "
        f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})")
    return rec


def phase_al_step(np, torch, fleets):
    from repro_torch.kernels.al_step.kernel import al_step_cuda
    from repro_torch.kernels.al_step.ref import al_step_ref
    dev = torch.device("cuda")

    def to_dev(arrs, bf16):
        out = [torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in arrs]
        if bf16:
            out[1], out[2] = out[1].bfloat16(), out[2].bfloat16()
        return out

    def compare(args, mode, k, bf16, what, tol=1e-5, day_hours=24):
        got = al_step_cuda(*args, mode=mode, k_steps=k, day_hours=day_hours)
        want = al_step_ref(*args, mode=mode, k_steps=k, day_hours=day_hours)
        torch.cuda.synchronize()
        # f32: 1e-5 as the JAX package's kernel tests. bf16 moments are
        # rounded once per call in both, so they agree to one bf16 ulp.
        mtol = 2.0 ** -7 if bf16 else tol
        err = check_close(torch, got[0], want[0], tol, tol, f"{what} x")
        merr = max(check_close(torch, got[1], want[1], mtol, tol,
                               f"{what} m"),
                   check_close(torch, got[2], want[2], mtol, tol,
                               f"{what} v"))
        if bf16:
            bf16_errs.append(merr)
            return err
        return max(err, merr)

    errs, bf16_errs, ill_errs, n = [], [], [], 0
    for p in fleets:
        W = p.W
        for mode in ("cr1", "cr2"):
            for k in (1, 8):
                for bf16 in (False, True):
                    for per_row in (False, True):
                        arrs = al_step_inputs(np, p, mode=mode, seed=W + k,
                                              per_row_cvec=per_row)
                        errs.append(compare(
                            to_dev(arrs, bf16), mode, k, bf16,
                            f"al_step RTS W={W} {mode} k={k} "
                            f"bf16={bf16} cvec={'WT' if per_row else '1T'}"))
                        n += 1
            arrs = al_step_inputs(np, p, mode=mode, seed=W, rts_only=False,
                                  stable=True)
            errs.append(compare(to_dev(arrs, False), mode, 1, False,
                                f"al_step mixed W={W} {mode} k=1"))
            # The cold start: x = 0 puts every hinge on an exact tie.
            cold = to_dev(arrs, False)
            for i in (0, 1, 2):
                cold[i] = torch.zeros_like(cold[i])
            cold[9][0, 4] = 0.0
            errs.append(compare(cold, mode, 1, False,
                                f"al_step cold start W={W} {mode} k=1"))
            # Ill-conditioned: v drawn below m² as the JAX package's tests
            # draw it. 1e-4: such inputs put the two float32 orders 1.18e-5
            # apart on one element of 480,000 in an earlier run (W = 10,000,
            # cr2); m/√v magnifies ulp-level gradient differences there.
            arrs = al_step_inputs(np, p, mode=mode, seed=W, rts_only=False,
                                  stable=True, tiny_v=True)
            ill_errs.append(compare(to_dev(arrs, False), mode, 1, False,
                                    f"al_step tiny v W={W} {mode} k=1",
                                    tol=1e-4))
            arrs = al_step_inputs(np, p, mode=mode, seed=W, rts_only=False,
                                  at_bounds=True)
            errs.append(compare(to_dev(arrs, False), mode, 8, False,
                                f"al_step at bounds W={W} {mode} k=8"))
            # 5-hour days straddle the lanes' runs of 6 hours: the general
            # segmented projection, where the main path's 24-hour days
            # take the whole-lane sums.
            errs.append(compare(to_dev(arrs, False), mode, 8, False,
                                f"al_step 5-hour days W={W} {mode} k=8",
                                day_hours=5))
            # Multi-region operands: a carbon row per fleet row and
            # per-row step multipliers (rowp col 11), mixed hinge-stable
            # rows.
            for k in (1, 8):
                arrs = al_step_inputs(np, p, mode=mode, seed=W + 2 * k,
                                      rts_only=k == 8, stable=True,
                                      per_row_cvec=True, step_rows=True)
                errs.append(compare(to_dev(arrs, False), mode, k, False,
                                    f"al_step regions W={W} {mode} k={k}"))
            n += 7
    # Timing at the main path's call: the fleet's rows ordered by kind,
    # batch rows first, as make_fused_inner hands them to the kernel, k =
    # 8, f32 moments.
    arrs = al_step_inputs(np, fleets[0], mode="cr2", seed=1, rts_only=False,
                          stable=True)
    by_kind = np.argsort(-arrs[7][:, 8], kind="stable")
    arrs = [a[by_kind] if a.shape[0] == W_MAIN else a for a in arrs]
    args = to_dev(arrs, False)
    rec = {"max_abs_err": max(errs)}
    for mode in ("cr1", "cr2"):
        rec[f"ms_{mode}"] = kernel_ms(
            torch, lambda: al_step_cuda(*args, mode=mode, k_steps=8))
        rec[f"plain_ms_{mode}"] = plain_ms(
            torch, lambda: al_step_ref(*args, mode=mode, k_steps=8))
    rec["ms"], rec["plain_ms"] = rec["ms_cr2"], rec["plain_ms_cr2"]
    nbytes = 10 * W_MAIN * T_MAIN * 4 + W_MAIN * 12 * 4 + T_MAIN * 4 + 32
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes, al_step_ops(np, arrs[7], T_MAIN, 8, "cr2"), H100_F32_OPS_PER_S)
    # The multi-region call at the same shape: a (W, T) carbon row per
    # fleet row adds W·T·4 bytes read; per-row steps ride rowp.
    regs = al_step_inputs(np, fleets[0], mode="cr2", seed=1, rts_only=False,
                          stable=True, per_row_cvec=True, step_rows=True)
    regs = [a[by_kind] if a.shape[0] == W_MAIN else a for a in regs]
    rargs = to_dev(regs, False)
    for mode in ("cr1", "cr2"):
        rec[f"regions_ms_{mode}"] = kernel_ms(
            torch, lambda: al_step_cuda(*rargs, mode=mode, k_steps=8))
    rec["regions_bound_ms"], rec["regions_bound_by"] = bound(
        11 * W_MAIN * T_MAIN * 4 + W_MAIN * 12 * 4 + 32,
        al_step_ops(np, regs[7], T_MAIN, 8, "cr2"), H100_F32_OPS_PER_S)
    log(f"[check] al_step: {n} cases, max abs err {rec['max_abs_err']:.3e} "
        f"(rtol = atol = 1e-5; bf16 moments {max(bf16_errs):.3e}, to one "
        f"bf16 ulp; tiny v {max(ill_errs):.3e} at 1e-4); k=8 at W = "
        f"{W_MAIN}: kernel "
        f"cr1 {rec['ms_cr1'] * 1e3:.2f} us, cr2 {rec['ms_cr2'] * 1e3:.2f} "
        f"us; plain cr1 {rec['plain_ms_cr1'] * 1e3:.2f} us, cr2 "
        f"{rec['plain_ms_cr2'] * 1e3:.2f} us; bound "
        f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})")
    log(f"[check] al_step multi-region call ((W, T) carbon rows, per-row "
        f"steps), k=8 at W = {W_MAIN}: cr1 "
        f"{rec['regions_ms_cr1'] * 1e3:.2f} us, cr2 "
        f"{rec['regions_ms_cr2'] * 1e3:.2f} us; bound "
        f"{rec['regions_bound_ms'] * 1e3:.2f} us "
        f"({rec['regions_bound_by']})")
    return rec


def phase_al_step_lanes(np, torch, p):
    """al_step with lanes on the main path's fleet: a batched call equals
    its one-lane calls bit for bit and its plain version within the
    one-lane checks' tolerance; timed beside the one-lane calls."""
    from repro_torch.kernels.al_step.kernel import al_step_cuda
    from repro_torch.kernels.al_step.ref import al_step_ref
    dev = torch.device("cuda")
    N = LANES_KERNEL_N

    def to_dev(arrs, bf16):
        out = [torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in arrs]
        if bf16:
            out[1], out[2] = out[1].bfloat16(), out[2].bfloat16()
        return out

    errs, n = [], 0
    for mode in ("cr1", "cr2"):
        for bf16 in (False, True):
            for shared in (True, False):
                # RTS rows over 8 steps; mixed hinge-stable rows over one
                # (the one-lane checks' inputs).
                for k, kw in ((8, {}), (1, dict(rts_only=False,
                                                stable=True))):
                    lanes, stacked = al_step_lane_inputs(
                        np, p, N, mode=mode, seed=n, shared=shared, **kw)
                    args = to_dev(stacked, bf16)
                    opts = dict(mode=mode, k_steps=k)
                    what = (f"al_step lanes {mode} bf16={bf16} "
                            f"shared={shared} k={k}")
                    before = al_step_cuda.launches
                    got = al_step_cuda(*args, **opts)
                    require(al_step_cuda.launches == before + 1,
                            f"{what}: not one launch")
                    want = al_step_ref(*args, **opts)
                    for i, one in enumerate(lanes):
                        solo = al_step_cuda(*to_dev(one, bf16), **opts)
                        for g, o in zip(got, solo):
                            require(torch.equal(g[i], o), f"{what}: lane {i} "
                                    f"differs from its one-lane call")
                    torch.cuda.synchronize()
                    # As the one-lane checks: bf16 moments are rounded
                    # once per call in both, so they agree to one bf16 ulp.
                    mtol = 2.0 ** -7 if bf16 else 1e-5
                    err = check_close(torch, got[0], want[0], 1e-5, 1e-5,
                                      f"{what} x")
                    merr = max(check_close(torch, g, w, mtol, 1e-5,
                                           f"{what} {nm}")
                               for g, w, nm in zip(got[1:], want[1:], "mv"))
                    errs.append(err if bf16 else max(err, merr))
                    n += 1
    # Timing: CR2 at k = 8 on the hinge-stable rows ordered by kind, f32,
    # per-lane constants, against the 4 one-lane calls back to back.
    lanes, stacked = al_step_lane_inputs(np, p, N, mode="cr2", seed=100,
                                         shared=False, rts_only=False,
                                         stable=True)
    args = to_dev(stacked, False)
    ones = [to_dev(one, False) for one in lanes]
    rec = {"max_abs_err": max(errs)}
    for mode in ("cr1", "cr2"):
        rec[f"ms_{mode}"] = kernel_ms(
            torch, lambda: al_step_cuda(*args, mode=mode, k_steps=8))
        rec[f"ones_ms_{mode}"] = kernel_ms(
            torch, lambda: [al_step_cuda(*a, mode=mode, k_steps=8)
                            for a in ones])
    nbytes = N * (10 * W_MAIN * T_MAIN * 4 + W_MAIN * 12 * 4 + T_MAIN * 4
                  + 32)
    ops = sum(al_step_ops(np, one[7], T_MAIN, 8, "cr2") for one in lanes)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, H100_F32_OPS_PER_S)
    # A multi-region ensemble's call (phase 5f): S lanes of (W, T) carbon
    # rows and per-row steps beside shared fleet constants, CR1 and CR2
    # at k = 8, against the plain version and lane 0's one-lane call.
    S = REGION_ENSEMBLE_S
    lanes, stacked = al_step_lane_inputs(
        np, p, S, mode="cr2", seed=200, shared=True, lane_cvec=True,
        rts_only=False, stable=True, per_row_cvec=True, step_rows=True)
    args = to_dev(stacked, False)
    one = to_dev(lanes[0], False)
    for mode in ("cr1", "cr2"):
        opts = dict(mode=mode, k_steps=8)
        got = al_step_cuda(*args, **opts)
        want = al_step_ref(*args, **opts)
        for g, o in zip(got, al_step_cuda(*one, **opts)):
            require(torch.equal(g[0], o), f"al_step {S} lanes of carbon "
                    f"rows {mode}: lane 0 differs from its one-lane call")
        torch.cuda.synchronize()
        rec["max_abs_err"] = max(
            rec["max_abs_err"],
            *(check_close(torch, g, w, 1e-5, 1e-5,
                          f"al_step {S} lanes of carbon rows {mode} {nm}")
              for g, w, nm in zip(got, want, "xmv")))
        rec[f"region_lanes_ms_{mode}"] = kernel_ms(
            torch, lambda: al_step_cuda(*args, **opts))
    wt = W_MAIN * T_MAIN * 4
    rec["region_lanes_bound_ms"], rec["region_lanes_bound_by"] = bound(
        S * (7 * wt + W_MAIN * 12 * 4 + 32) + 4 * wt,
        sum(al_step_ops(np, a[7], T_MAIN, 8, "cr2") for a in lanes),
        H100_F32_OPS_PER_S)
    log(f"[lanes] al_step with {N} lanes: {n} cases bitwise equal to their "
        f"one-lane calls, one launch each; max abs err against the plain "
        f"version {rec['max_abs_err']:.3e} (rtol = atol = 1e-5; bf16 "
        f"moments to one bf16 ulp); k=8 at W = {W_MAIN} x {N} lanes: "
        f"batched cr1 {rec['ms_cr1'] * 1e3:.2f} us, cr2 "
        f"{rec['ms_cr2'] * 1e3:.2f} us; {N} one-lane calls cr1 "
        f"{rec['ones_ms_cr1'] * 1e3:.2f} us, cr2 "
        f"{rec['ones_ms_cr2'] * 1e3:.2f} us; bound "
        f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}, {N} x the "
        f"one-lane bytes)")
    log(f"[lanes] al_step with {S} lanes of (W, T) carbon rows and per-row "
        f"steps, shared fleet constants (a multi-region ensemble's call), "
        f"k=8 at W = {W_MAIN}: lane 0 bitwise its one-lane call; cr1 "
        f"{rec['region_lanes_ms_cr1'] * 1e3:.2f} us, cr2 "
        f"{rec['region_lanes_ms_cr2'] * 1e3:.2f} us; bound "
        f"{rec['region_lanes_bound_ms'] * 1e3:.2f} us "
        f"({rec['region_lanes_bound_by']}: per lane x, m, v read and "
        f"written, its carbon rows, rowp and scal; usage, jobs, lo, hi "
        f"once)")
    return rec


def phase_fleet():
    """The paper fleet (calibrated on this host and card), cloned to the
    main path's W = 10,000 and to the W = 130 tail fleet."""
    from repro_torch.core.fleet_solver import synthetic_fleet
    from repro_torch.core.fleetcache import cached_paper_fleet
    t0 = time.perf_counter()
    fleet = cached_paper_fleet(hours=T_MAIN, num_samples=CAL_SAMPLES,
                               num_jobs=CAL_JOBS, device="cuda")
    log(f"[fleet] paper fleet calibrated in {time.perf_counter() - t0:.2f} s")
    log(f"[fleet] reduced calibration: num_samples={CAL_SAMPLES} "
        f"num_jobs={CAL_JOBS} (the default is 160 and 10000)")
    p = synthetic_fleet(W_MAIN, hours=T_MAIN, seed=0, templates=fleet)
    log(f"[fleet] synthetic_fleet: W = {p.W}, T = {p.T}, "
        f"{int(p.is_batch.sum())} batch rows")
    return p, synthetic_fleet(W_TAIL, hours=T_MAIN, seed=1, templates=fleet)


def phase_main_path(np, torch, p):
    from repro_torch.core.api import CR1, CR2, SolveContext, solve
    from repro_torch.kernels.al_step.kernel import al_step_cuda
    from repro_torch.kernels.dr_features.kernel import dr_features_cuda

    policies = (CR1(lam=1.45), CR2(cap_frac=0.78))
    for pol in policies:                       # warm-up, not timed
        solve(p, pol, ctx=SolveContext(steps=8))
    torch.cuda.synchronize()

    dr_features_cuda.launches = 0
    al_step_cuda.launches = 0
    fused = {}
    for pol in policies:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = solve(p, pol)
        torch.cuda.synchronize()
        fused[pol.name] = (r, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated())
    launches = {"al_step": al_step_cuda.launches,
                "dr_features": dr_features_cuda.launches}
    want = {"al_step": 600 // 8 + CR2.outer * (400 // 8),
            "dr_features": 1 + (1 + CR2.outer + 1)}
    log(f"[main] launches on the main path: {launches} (expected {want})")
    require(launches == want, f"kernel launches {launches} != {want}")

    for pol in policies:
        r, wall, mem = fused[pol.name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = solve(p, pol, ctx=SolveContext(use_kernel=False))
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
        gmem = torch.cuda.max_memory_allocated()
        log(f"[main] {pol.name} fused: carbon {r.carbon_reduction_pct:.4f} %, "
            f"penalty {r.total_penalty_pct:.4f} %, preservation "
            f"{r.preservation_violation:.3e}, wall {wall:.4f} s, peak "
            f"{mem / 2**20:.1f} MiB")
        log(f"[main] {pol.name} generic: carbon {g.carbon_reduction_pct:.4f} "
            f"%, penalty {g.total_penalty_pct:.4f} %, preservation "
            f"{g.preservation_violation:.3e}, wall {gwall:.4f} s, peak "
            f"{gmem / 2**20:.1f} MiB")
        for res in (r, g):
            require(bool(np.isfinite(res.D).all())
                    and res.D.shape == (p.W, p.T),
                    f"{pol.name}: plan not finite or not (W, T)")
        dc = abs(r.carbon_reduction_pct - g.carbon_reduction_pct)
        dp = abs(r.total_penalty_pct - g.total_penalty_pct)
        require(dc < PP_TOL and dp < PP_TOL,
                f"{pol.name}: fused vs generic differ by {dc:.4f} pp carbon,"
                f" {dp:.4f} pp penalty (limit {PP_TOL})")
        require(r.preservation_violation < PRESERVATION_TOL,
                f"{pol.name}: preservation violation "
                f"{r.preservation_violation:.3e} >= {PRESERVATION_TOL}")
    return launches


def expected_day_launches(cold, warm, rounds, n_ticks):
    """Kernel launches of one day at k_steps = 8: each AL round of a tick
    makes ceil(steps / 8) al_step calls; dr_features runs once a tick for
    the final penalties and, for CR2 (rounds > 1), once for the fairness
    targets and once per round for the equality residual."""
    calls = -(-cold // 8) + (n_ticks - 1) * -(-warm // 8)
    per_tick = rounds + 2 if rounds > 1 else 1
    return {"al_step": rounds * calls, "dr_features": n_ticks * per_tick}


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_streaming(np, torch, p, p_tail):
    """The rolling-horizon day at the main path's fleet, per policy; the
    launch counts are reset just before the timed replay and read just
    after. Returns the counts of the two replays."""
    from repro_torch.core import api
    from repro_torch.core.api import SolveContext, configured_policy, solve_day
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.daygraph import COUNTED, DAY_GRAPHS
    from repro_torch.core.streaming import RollingHorizonSolver

    # 48 ticks, so that one solver runs a second day: the first 24 are
    # those of ForecastStream.caiso(n_ticks=24, horizon=48, seed=7).
    stream = ForecastStream.caiso(n_ticks=2 * DAY_TICKS, horizon=T_MAIN,
                                  seed=DAY_SEED)
    stack = np.stack([stream.forecast(t) for t in range(DAY_TICKS)])
    window = dataclasses.replace(p, mci=stack[0])
    totals = {name: 0 for name in COUNTED}
    for name, cold, warm, rounds in DAY_POLICIES:
        pol = configured_policy(name, outer=rounds)
        kw = dict(policy=pol, cold_steps=cold, warm_steps=warm)
        loop, loop_wall = _timed(torch, lambda: RollingHorizonSolver(
            p, stream, **kw).run(DAY_TICKS))
        a, b = (RollingHorizonSolver(p, stream, **kw) for _ in range(2))
        n0 = DAY_GRAPHS.captures
        torch.cuda.reset_peak_memory_stats()
        first, capture_wall = _timed(torch, lambda: a.run_scanned(DAY_TICKS))
        capture_peak = torch.cuda.max_memory_allocated()
        require(DAY_GRAPHS.captures == n0 + 1,
                f"{name}: the first day did not capture one graph")
        torch.cuda.reset_peak_memory_stats()
        for fn in COUNTED.values():
            fn.launches = 0
        scan, replay_wall = _timed(torch, lambda: b.run_scanned(DAY_TICKS))
        launches = {n: fn.launches for n, fn in COUNTED.items()}
        replay_peak = torch.cuda.max_memory_allocated()
        require(DAY_GRAPHS.captures == n0 + 1,
                f"{name}: the second day captured again")
        want = expected_day_launches(cold, warm, rounds, DAY_TICKS)
        log(f"[day] {name}: launches per replay {launches} (expected "
            f"{want}: {rounds} round(s) x (ceil({cold}/8) + "
            f"{DAY_TICKS - 1} x ceil({warm}/8)) al_step; dr_features "
            f"{DAY_TICKS} x {want['dr_features'] // DAY_TICKS})")
        require(launches == want, f"{name}: day launches {launches} != {want}")
        for k in totals:
            totals[k] += launches[k]

        def replay():
            return solve_day(window, pol, stack, ctx=SolveContext(),
                             cold_steps=cold, warm_steps=warm)

        on_device = device_launches(torch, f"day {name}", replay, want)
        log(f"[day] {name}: kernels the card ran in one replay, by "
            f"torch.profiler: {on_device}")
        res = replay()
        _, _, day, inputs = api._day_setup(window, pol, stack, SolveContext(),
                                           cold, warm)
        with torch.no_grad():
            eager, eager_wall = _timed(torch, lambda: api._day_impl(day,
                                                                   inputs))
        st = res.last.state
        got = [res.committed, res.last.D,
               *(t.cpu().numpy() for t in (st.x, st.lam_eq, st.mu))]
        ref = [t.cpu().numpy() for t in eager[:2]] + [
            t.cpu().numpy() for t in (eager[3], eager[4], eager[6])]
        replay_err = max(float(np.abs(g - r).max(initial=0.0))
                         for g, r in zip(got, ref))
        require(np.array_equal(first.committed, scan.committed),
                f"{name}: the captured day differs from its replay")
        d_pp = abs(scan.realized_reduction_pct - loop.realized_reduction_pct)
        d_commit = float(np.abs(scan.committed - loop.committed).max())
        pres = scan.ticks[-1].plan.preservation_violation
        log(f"[day] {name}: realized carbon loop "
            f"{loop.realized_reduction_pct:.4f} %, day "
            f"{scan.realized_reduction_pct:.4f} % ({d_pp:.2e} pp, limit "
            f"{SCAN_PP}); committed max |day - loop| {d_commit:.3e} NP "
            f"(limit {COMMIT_ATOL}); replay vs eager day max |diff| "
            f"{replay_err:.3e} (limit {REPLAY_TOL:g}); last plan "
            f"preservation {pres:.3e}, carbon "
            f"{scan.ticks[-1].plan.carbon_reduction_pct:.4f} %, penalty "
            f"{scan.ticks[-1].plan.total_penalty_pct:.4f} %")
        require(d_pp < SCAN_PP, f"{name}: loop vs day {d_pp:.4f} pp")
        require(d_commit <= COMMIT_ATOL, f"{name}: committed {d_commit:.3e}")
        require(replay_err <= REPLAY_TOL, f"{name}: replay vs eager day "
                f"{replay_err:.3e}")
        require(pres < PRESERVATION_TOL, f"{name}: preservation {pres:.3e}")
        for r in (loop, scan):
            require(bool(np.isfinite(r.committed).all())
                    and r.committed.shape == (p.W, DAY_TICKS),
                    f"{name}: committed hours not finite or not (W, 24)")

        n1 = DAY_GRAPHS.captures
        b2, warm_capture_wall = _timed(torch, lambda: b.run_scanned(DAY_TICKS))
        a2, warm_wall = _timed(torch, lambda: a.run_scanned(DAY_TICKS))
        require(DAY_GRAPHS.captures == n1 + 1,
                f"{name}: the warm days did not share one graph")
        warm_err = float(np.abs(a2.committed - b2.committed).max())
        require(warm_err == 0.0, f"{name}: two replays of one warm day "
                f"differ by {warm_err:.3e}")
        require(bool(np.isfinite(a2.committed).all())
                and a2.ticks[-1].plan.preservation_violation
                < PRESERVATION_TOL, f"{name}: warm day")
        log(f"[day] {name} walls (host clock, synchronized): per-tick loop "
            f"{loop_wall:.4f} s; first day (warm-up day + capture + replay) "
            f"{capture_wall:.4f} s; replay {replay_wall:.4f} s; the eager "
            f"day (_day_impl) {eager_wall:.4f} s; warm second day: capture "
            f"{warm_capture_wall:.4f} s, replay {warm_wall:.4f} s "
            f"(realized {a2.realized_reduction_pct:.4f} % over ticks "
            f"{DAY_TICKS}-{2 * DAY_TICKS - 1})")
        log(f"[day] {name} peak memory: first day {capture_peak / 2**20:.1f} "
            f"MiB, replay {replay_peak / 2**20:.1f} MiB "
            f"(torch.cuda.max_memory_allocated; {len(DAY_GRAPHS)} graphs "
            f"cached)")

    tail_stream = ForecastStream.caiso(n_ticks=TAIL_TICKS, horizon=T_MAIN,
                                       seed=DAY_SEED)
    for name, cold, warm, rounds in DAY_POLICIES:
        kw = dict(policy=configured_policy(name, outer=rounds),
                  cold_steps=cold, warm_steps=warm)
        f, g = (RollingHorizonSolver(p_tail, tail_stream, use_kernel=uk,
                                     **kw).run_scanned(TAIL_TICKS)
                for uk in (True, False))
        fl, gl = f.ticks[-1].plan, g.ticks[-1].plan
        diffs = (abs(f.realized_reduction_pct - g.realized_reduction_pct),
                 abs(fl.carbon_reduction_pct - gl.carbon_reduction_pct),
                 abs(fl.total_penalty_pct - gl.total_penalty_pct))
        log(f"[day] {name} at W = {p_tail.W}, {TAIL_TICKS} ticks, fused - "
            f"generic: realized {diffs[0]:.4f} pp, last plan carbon "
            f"{diffs[1]:.4f} pp, penalty {diffs[2]:.4f} pp (limit {PP_TOL})")
        require(max(diffs) < PP_TOL, f"{name}: fused vs generic day {diffs}")
    return totals


def expected_lane_launches(steps, rounds, n_targets=0):
    """Kernel launches of one batched solve at k_steps = 8, whatever the
    number of lanes: ceil(steps / 8) al_step calls per AL round for all
    lanes; dr_features once for the lanes' final penalties and, for CR2
    (rounds > 1), once per round for the equality residual, beside one
    call per distinct fairness target vector (`n_targets`)."""
    extra = rounds + n_targets if rounds > 1 else 0
    return {"al_step": rounds * -(-steps // 8), "dr_features": 1 + extra}


def day_sum_gap(np, q, D):
    """Largest distance of a batch day's sum from the nearest sum its box
    allows (0 where the box admits a zero-sum day, else the bound side's
    sum), and the count of days whose box does not admit 0. Where every
    day admits 0 this is the preservation violation; a scenario whose
    usage exceeds its entitlement on a batch day (FleetJitter) leaves
    that day no zero-sum plan."""
    isb = np.asarray(q.is_batch, bool)
    E = np.asarray(q.entitlement, float)[isb, None]
    U = np.asarray(q.usage, float)[isb]
    hi = np.minimum(q.max_curtail_frac * E, U)
    lo = np.minimum(U - E, hi)
    dh = min(q.day_hours, q.T)
    span = q.T // dh * dh

    def days(a):
        return a[:, :span].reshape(a.shape[0], -1, dh).sum(-1)

    target = np.clip(0.0, days(lo), days(hi))
    return (float(np.abs(days(D[isb]) - target).max()),
            int((target != 0.0).sum()))


def _lane_gaps(batched, loop):
    """Largest |batched - loop| of carbon % and penalty % over the lanes."""
    dc = max(abs(b.carbon_reduction_pct - l.carbon_reduction_pct)
             for b, l in zip(batched, loop))
    dp = max(abs(b.total_penalty_pct - l.total_penalty_pct)
             for b, l in zip(batched, loop))
    return dc, dp


def phase_lanes(np, torch, p, p_tail):
    """The batched lanes at the main path's fleet: sweeps, a warm
    refinement, two ensembles and a streaming ensemble, each batched call
    with its launch counts reset just before and read just after, held
    against its loop of `solve()` calls. Returns the summed counts."""
    from repro_torch.core import ensemble as ens
    from repro_torch.core import scenario as scen
    from repro_torch.core.api import (CR1, CR2, SolveContext, solve,
                                      stack_states, sweep)
    from repro_torch.core.daygraph import COUNTED
    from repro_torch.core.streaming import RollingHorizonSolver

    totals = {name: 0 for name in COUNTED}

    def batched(what, fn, want):
        """Run `fn` with the counts reset just before and read just after;
        returns (result, wall, peak memory)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in COUNTED.values():
            f.launches = 0
        out, wall = _timed(torch, fn)
        got = {n: f.launches for n, f in COUNTED.items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"[lanes] {what}: launches {got} (expected {want}), wall "
            f"{wall:.4f} s, peak {peak / 2**20:.1f} MiB")
        require(got == want, f"{what}: launches {got} != {want}")
        for k in totals:
            totals[k] += got[k]
        return out, wall, peak

    def held(what, got, loop, loop_wall):
        dc, dp = _lane_gaps(got, loop)
        pres = max(r.preservation_violation for r in got)
        log(f"[lanes] {what}: loop of {len(loop)} solve() {loop_wall:.4f} s; "
            f"batched - loop max {dc:.2e} pp carbon, {dp:.2e} pp penalty "
            f"(limit {LANE_PP}); carbon "
            + ", ".join(f"{r.carbon_reduction_pct:.4f}" for r in got)
            + f" %; preservation max {pres:.3e}")
        for r in got:
            require(bool(np.isfinite(r.D).all()) and r.D.shape == (p.W, p.T),
                    f"{what}: a plan is not finite or not (W, T)")
        require(dc < LANE_PP and dp < LANE_PP,
                f"{what}: batched vs loop {dc:.4f} / {dp:.4f} pp")
        require(pres < PRESERVATION_TOL, f"{what}: preservation {pres:.3e}")

    ctx = SolveContext()
    cr1 = [CR1(lam=lam) for lam in CR1_LAMS]
    cr2 = [CR2(cap_frac=c) for c in CR2_CAPS]
    sweep(p, cr1, ctx=SolveContext(steps=8))            # warm-up, not timed
    # Sweeps: each lane against its solve().
    res1, _, _ = batched(f"CR1 sweep, {len(cr1)} lanes x 600 steps",
                         lambda: sweep(p, cr1, ctx=ctx),
                         expected_lane_launches(600, 1))
    loop1, w1 = _timed(torch, lambda: [solve(p, pl, ctx=ctx) for pl in cr1])
    held("CR1 sweep", res1, loop1, w1)
    res2, _, _ = batched(
        f"CR2 sweep, {len(cr2)} lanes x 6 x 400 steps",
        lambda: sweep(p, cr2, ctx=ctx),
        expected_lane_launches(400, CR2.outer, n_targets=len(cr2)))
    loop2, w2 = _timed(torch, lambda: [solve(p, pl, ctx=ctx) for pl in cr2])
    held("CR2 sweep", res2, loop2, w2)
    warm = SolveContext(steps=REFINE_STEPS,
                        warm=stack_states([r.state for r in res1]))
    ref1, _, _ = batched(
        f"CR1 refinement from stack_states, {REFINE_STEPS} steps",
        lambda: sweep(p, cr1, ctx=warm),
        expected_lane_launches(REFINE_STEPS, 1))
    loopw, ww = _timed(torch, lambda: [solve(p, pl, ctx=SolveContext(
        steps=REFINE_STEPS, warm=r.state)) for pl, r in zip(cr1, loop1)])
    held("CR1 refinement", ref1, loopw, ww)
    on_device = device_launches(torch, "CR1 sweep",
                                lambda: sweep(p, cr1, ctx=ctx),
                                expected_lane_launches(600, 1))
    log(f"[lanes] CR1 sweep: kernels the card ran, by torch.profiler: "
        f"{on_device}")

    # Ensembles: S = 16, batched against batched=False.
    mixes = {
        "cr1": (CR1(lam=1.45), [scen.DuckPerturb(8, seed=0),
                                scen.CambiumMix(8, seed=1)], 0),
        "cr2": (CR2(cap_frac=0.78), [scen.DuckPerturb(6, seed=0),
                                     scen.CambiumMix(6, seed=1),
                                     scen.FleetJitter(4, seed=2)], 16)}
    for name, (pol, gens, n_targets) in mixes.items():
        stack = scen.resolve_scenarios(gens, p)
        rounds = getattr(pol, "outer", 1)
        got, _, _ = batched(
            f"{name} ensemble, S = {stack.S}",
            lambda: ens.evaluate_ensemble(p, pol, stack, ctx=ctx),
            expected_lane_launches(pol.default_steps, rounds, n_targets))
        loop, lw = _timed(torch, lambda: ens.evaluate_ensemble(
            p, pol, stack, ctx=ctx, batched=False))
        dc = float(np.abs(got.carbon_reduction_pct
                          - loop.carbon_reduction_pct).max())
        dp = float(np.abs(got.total_penalty_pct
                          - loop.total_penalty_pct).max())
        gaps = [day_sum_gap(np, stack.problem(p, i), got.D[i])
                for i in range(stack.S)]
        pres = max(g for g, _ in gaps)
        log(f"[lanes] {name} ensemble: loop of {stack.S} solve() {lw:.4f} "
            f"s; batched - loop max {dc:.2e} pp carbon, {dp:.2e} pp penalty "
            f"(limit {LANE_PP}); preservation violation as reported max "
            f"{got.preservation_violation.max():.3e} (loop "
            f"{loop.preservation_violation.max():.3e}); batch days with no "
            f"zero-sum plan in their box per scenario "
            f"{[n for _, n in gaps]}; distance of a day sum from the "
            f"nearest sum its box allows, max {pres:.3e}")
        for line in got.report().lines():
            log(f"[lanes]   {line}")
        require(bool(np.isfinite(got.D).all())
                and got.D.shape == (stack.S, p.W, p.T),
                f"{name} ensemble: plans not finite or not (S, W, T)")
        require(dc < LANE_PP and dp < LANE_PP,
                f"{name} ensemble: batched vs loop {dc:.4f} / {dp:.4f} pp")
        require(pres < PRESERVATION_TOL,
                f"{name} ensemble: preservation {pres:.3e}")

    # The streaming ensemble: S streams, one batched re-solve a tick.
    regime = scen.ForecastRegime(STREAM_LANES, seed=0)
    streams = regime.streams(p, n_ticks=DAY_TICKS)
    kw = dict(cold_steps=600, warm_steps=150)
    rep, _, _ = batched(
        f"CR1 streaming ensemble, {STREAM_LANES} streams x {DAY_TICKS} "
        f"ticks", lambda: ens.run_streaming_ensemble(
            p, CR1(lam=1.45), streams, n_ticks=DAY_TICKS, **kw),
        expected_day_launches(600, 150, 1, DAY_TICKS))
    for s in (0, STREAM_LANES - 1):
        solo, sw = _timed(torch, lambda: RollingHorizonSolver(
            p, streams[s], policy=CR1(lam=1.45), **kw).run(DAY_TICKS))
        d = abs(rep.realized_reduction_pct[s] - solo.realized_reduction_pct)
        dcom = float(np.abs(rep.committed[s] - solo.committed).max())
        pres = solo.ticks[-1].plan.preservation_violation
        log(f"[lanes] stream {s}: realized {rep.realized_reduction_pct[s]:.4f}"
            f" % batched, {solo.realized_reduction_pct:.4f} % solo "
            f"({d:.2e} pp, limit {LANE_PP}); committed max |diff| "
            f"{dcom:.3e} NP; solo controller {sw:.4f} s; its last plan's "
            f"preservation {pres:.3e}")
        require(d < LANE_PP, f"stream {s}: batched vs solo {d:.4f} pp")
        require(bool(np.isfinite(rep.committed).all()),
                "streaming ensemble: committed hours not finite")

    # At W = 130, the lanes through the kernels against the generic engine.
    for pols in (cr1, cr2):
        f, g = (sweep(p_tail, pols, ctx=SolveContext(use_kernel=uk))
                for uk in (True, False))
        dc, dp = _lane_gaps(f, g)
        log(f"[lanes] {pols[0].name} sweep at W = {p_tail.W}, fused - "
            f"generic lanes: max {dc:.4f} pp carbon, {dp:.4f} pp penalty "
            f"(limit {PP_TOL})")
        require(dc < PP_TOL and dp < PP_TOL,
                f"{pols[0].name} sweep fused vs generic {dc}, {dp}")
    return totals


def expected_cr3_launches(steps, outer, rounds):
    """dr_features launches of a CR3 solve: its objective calls
    `fleet_penalties` once an inner step of every round's best response,
    and the round's penalties once more; no al_step (CR3 has no fused
    mode)."""
    return {"al_step": 0, "dr_features": rounds * (steps * outer + 1)}


def _cr3_rounds(r, steps, outer):
    return r.iters // (steps * outer)


def _pp_gaps(a, b):
    return (abs(a.carbon_reduction_pct - b.carbon_reduction_pct),
            abs(a.total_penalty_pct - b.total_penalty_pct))


def phase_policies(np, torch, p):
    """CR3, the baselines and the SLSQP reference: CR3 at the main path's
    fleet through the kernels (launch counts reset just before and read
    just after) and through the plain path, a CR3 sweep against its
    loop, B1/B3 against their closed forms, and the paper's four-workload
    problem through the SLSQP reference (float64 on the card) beside the
    fleet engine's CR1/CR2/CR3, with a line per policy. Returns the
    summed launch counts."""
    from repro_torch.core import baselines, policies, solver
    from repro_torch.core.api import (B1, B3, CR1, CR2, CR3, SolveContext,
                                      solve, sweep)
    from repro_torch.core.carbon import caiso_2021
    from repro_torch.core.daygraph import COUNTED
    from repro_torch.core.fleet_solver import FleetProblem, fleet_penalties
    from repro_torch.core.fleetcache import cached_paper_fleet

    totals = {name: 0 for name in COUNTED}

    counted = functools.partial(count_launches, torch, totals, "policies")

    steps, outer = CR3.default_steps, CR3.outer
    solve(p, CR3(), ctx=SolveContext(steps=2))            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r, wall = counted(
        f"CR3 at W = {p.W}, {steps} x {outer} steps a round",
        lambda: solve(p, CR3()),
        lambda r: expected_cr3_launches(steps, outer,
                                        _cr3_rounds(r, steps, outer)))
    peak = torch.cuda.max_memory_allocated()
    g, gwall = _timed(torch, lambda: solve(
        p, CR3(), ctx=SolveContext(use_kernel=False)))
    for name, res, w in (("kernels", r, wall), ("plain", g, gwall)):
        log(f"[policies] CR3 {name}: wall {w:.4f} s, rounds "
            f"{_cr3_rounds(res, steps, outer)}, rho {res.extras['rho']:.6g},"
            f" balanced {res.balanced}, carbon "
            f"{res.carbon_reduction_pct:.4f} %, penalty "
            f"{res.total_penalty_pct:.4f} %, preservation "
            f"{res.preservation_violation:.3e}")
        require(bool(np.isfinite(res.D).all())
                and res.D.shape == (p.W, p.T),
                f"CR3 {name}: plan not finite or not (W, T)")
    log(f"[policies] CR3 peak memory {peak / 2**20:.1f} MiB")
    dc, dp = _pp_gaps(r, g)
    drho = abs(r.extras["rho"] / g.extras["rho"] - 1.0)
    log(f"[policies] CR3 kernels - plain: {dc:.2e} pp carbon, {dp:.2e} pp "
        f"penalty (limit {PP_TOL}), rho {drho:.2e} relative (limit "
        f"{CR3_RHO_RTOL})")
    require(r.preservation_violation < PRESERVATION_TOL,
            f"CR3 preservation {r.preservation_violation:.3e}")
    require(r.iters == g.iters and r.balanced == g.balanced,
            f"CR3 kernels vs plain: rounds {r.iters} / {g.iters}, "
            f"balanced {r.balanced} / {g.balanced}")
    require(drho < CR3_RHO_RTOL, f"CR3 kernels vs plain: rho {drho:.2e}")
    require(dc < PP_TOL and dp < PP_TOL,
            f"CR3 kernels vs plain: {dc:.4f} / {dp:.4f} pp")

    # A CR3 sweep over rho, each lane against its solve().
    ctx = SolveContext(steps=CR3_SWEEP_STEPS)
    pols = [CR3(rho=rho) for rho in CR3_RHOS]
    lanes, lw = counted(
        f"CR3 sweep over rho {CR3_RHOS}, {CR3_SWEEP_STEPS} steps",
        lambda: sweep(p, pols, ctx=ctx),
        lambda out: expected_cr3_launches(CR3_SWEEP_STEPS, outer, max(
            _cr3_rounds(a, CR3_SWEEP_STEPS, outer) for a in out)))
    loop, loopw = _timed(torch, lambda: [solve(p, pl, ctx=ctx)
                                         for pl in pols])
    for pl, a, b in zip(pols, lanes, loop):
        dc, dp = _pp_gaps(a, b)
        drho = abs(a.extras["rho"] / b.extras["rho"] - 1.0)
        log(f"[policies] CR3(rho={pl.rho}) lane: rounds "
            f"{_cr3_rounds(a, CR3_SWEEP_STEPS, outer)} (loop "
            f"{_cr3_rounds(b, CR3_SWEEP_STEPS, outer)}), rho "
            f"{a.extras['rho']:.6g} ({drho:.2e} rel), balanced {a.balanced},"
            f" lane - loop {dc:.2e} / {dp:.2e} pp")
        require(a.iters == b.iters and a.balanced == b.balanced,
                f"CR3(rho={pl.rho}) lane vs loop: rounds or balanced")
        require(drho < CR3_LANE_RHO_RTOL and dc < PP_TOL and dp < PP_TOL,
                f"CR3(rho={pl.rho}) lane vs loop: rho {drho:.2e}, "
                f"{dc:.4f} / {dp:.4f} pp")
    log(f"[policies] CR3 sweep {lw:.4f} s, its loop {loopw:.4f} s")

    # B1 and B3: a closed form and one dr_features launch each.
    U, E = np.asarray(p.usage), np.asarray(p.entitlement)
    b1 = np.maximum(U - 0.75 * E[:, None], 0.0)
    b3 = np.zeros_like(U)
    left = 0.3
    for i in reversed(np.flatnonzero(~np.asarray(p.is_batch))):
        if left <= 0:
            break
        c = min(left, 0.2)
        b3[i] = np.maximum(U[i] - (1.0 - c) * E[i], 0.0)
        left -= c
    for pol, want_D in ((B1(F=0.75), b1), (B3(depth=0.3), b3)):
        res, _ = counted(f"{pol}", lambda: solve(p, pol),
                         {"al_step": 0, "dr_features": 1})
        plain = fleet_penalties(p, torch.as_tensor(want_D, dtype=torch.float32,
                                                   device="cuda"),
                                use_kernel=False).sum().item()
        pen = 100 * plain / float(E.sum())
        rel = abs(res.total_penalty_pct / pen - 1.0) if pen else abs(
            res.total_penalty_pct)
        log(f"[policies] {pol}: carbon {res.carbon_reduction_pct:.4f} %, "
            f"penalty {res.total_penalty_pct:.6f} % (plain {pen:.6f} %, "
            f"{rel:.2e} rel)")
        require(np.array_equal(res.D, want_D), f"{pol}: D != closed form")
        require(rel < 1e-5, f"{pol}: penalties vs plain {rel:.2e}")

    # The paper's four-workload problem: SLSQP (float64) and the fleet.
    fleet = cached_paper_fleet(hours=T_MAIN, num_samples=CAL_SAMPLES,
                               num_jobs=CAL_JOBS, device="cuda")
    dr = policies.DRProblem(
        models=tuple(fleet[n] for n in ("RTS1", "RTS2", "AITraining",
                                        "DataPipeline")),
        mci=caiso_2021(T_MAIN).mci)
    fp = FleetProblem.from_problem(dr)
    E4 = np.asarray(fp.entitlement)
    rts = ~np.asarray(fp.is_batch)
    # CR1 twice, iterates recorded: the reference must repeat bit for bit
    # in one process (scripts/port_slsqp_repeat.py looks deeper).
    its = ([], [])
    cr1 = policies.cr1_spec(dr, 1.45)

    def slsqp(spec, run=None):
        cb = None if run is None else (lambda xk: its[run].append(
            np.array(xk)))
        return solver.solve_slsqp(spec, maxiter=250, callback=cb)

    (s1, s1w), (s2, s2w) = (_timed(torch, lambda: slsqp(cr1, 0)),
                            _timed(torch, lambda: slsqp(
                                policies.cr2_spec(dr, 0.78))))
    s1b, _ = _timed(torch, lambda: slsqp(cr1, 1))
    same = (len(its[0]) == len(its[1]) > 0
            and all(np.array_equal(a, b) for a, b in zip(*its))
            and np.array_equal(s1.D, s1b.D))
    log(f"[policies] SLSQP CR1 twice in one process: {len(its[0])} / "
        f"{len(its[1])} iterates, bitwise equal: {same}; carbon "
        f"{s1.carbon_reduction_pct!r} / {s1b.carbon_reduction_pct!r} %")
    require(same, "SLSQP CR1's two calls in one process differ")
    (s3, rho3), s3w = _timed(torch, lambda: solver.solve_cr3(dr, rho=0.02))
    fleet_runs = (
        (CR1(lam=1.45), {"al_step": 600 // 8, "dr_features": 1}),
        (CR2(cap_frac=0.78), {"al_step": CR2.outer * (400 // 8),
                              "dr_features": 1 + CR2.outer + 1}),
        (CR3(rho=0.02), lambda r: expected_cr3_launches(
            steps, outer, _cr3_rounds(r, steps, outer))))
    (f1, f1w), (f2, f2w), (f3, f3w) = (
        counted(f"fleet {pol.name} on the four-workload problem",
                lambda pol=pol: solve(fp, pol), want)
        for pol, want in fleet_runs)
    for name, ref, w, got, gw in (("CR1", s1, s1w, f1, f1w),
                                  ("CR2", s2, s2w, f2, f2w),
                                  ("CR3", s3, s3w, f3, f3w)):
        dc, dp = _pp_gaps(got, ref)
        log(f"[policies] {name}: SLSQP carbon {ref.carbon_reduction_pct:.4f}"
            f" %, penalty {ref.total_penalty_pct:.4f} %, nit {ref.nit}, "
            f"{w:.3f} s; fleet carbon {got.carbon_reduction_pct:.4f} %, "
            f"penalty {got.total_penalty_pct:.4f} %, {gw:.3f} s; gap "
            f"{dc:.3f} / {dp:.3f} pp")
    pens = {k: fleet_penalties(fp, torch.as_tensor(
        f.D, dtype=torch.float32, device="cuda")).cpu().numpy()
        for k, f in (("CR1", f1), ("CR2", f2))}
    for name, got, ref in (("CR1", f1, s1), ("CR2", f2, s2)):
        dc, dp = _pp_gaps(got, ref)
        require(dc < 1.5 and dp < 1.5, f"fleet {name} vs SLSQP {dc}, {dp}")
    share1 = np.abs(pens["CR1"] - s1.per_penalty) / E4
    share2 = np.abs(pens["CR2"] - s2.per_penalty)[rts] / E4[rts]
    log(f"[policies] per-workload penalty gaps / E: CR1 {share1.max():.4f} "
        f"(limit 0.03), CR2 RTS {share2.max():.4f} (limit 0.01)")
    require(share1.max() < 0.03, "fleet CR1 per-workload penalties")
    require(share2.max() < 0.01, "fleet CR2 RTS penalties")
    require(bool((pens["CR2"][~rts] <= s2.per_penalty[~rts] + 0.05).all()),
            "fleet CR2 batch penalties above SLSQP's")
    paid, collected = policies.cr3_fiscal_balance(dr, f3.D, f3.extras["rho"])
    dc, dp = _pp_gaps(f3, s3)
    log(f"[policies] CR3: SLSQP rho {rho3:.6g}, fleet rho "
        f"{f3.extras['rho']:.6g}; Eq. 6 paid {paid:.4f} <= collected "
        f"{collected:.4f}; fleet preservation {f3.preservation_violation:.3e}")
    require(dc < 2.0 and dp < 2.0, f"fleet CR3 vs SLSQP {dc}, {dp}")
    require(paid <= collected + 1e-6, "fleet CR3: Eq. 6 unmet")
    require(f3.preservation_violation < PRESERVATION_TOL,
            "fleet CR3 preservation")

    # The seven policies at one setting each (benchmarks/common.py's ways).
    def closed(D, name):
        spec = policies.PolicySpec(name=name, problem=dr,
                                   objective=dr.total_penalty,
                                   use_preservation=False)
        return solver.evaluate(spec, D, solver="closed", nit=0)

    line = {
        "CR1(1.45)": s1, "CR2(0.78)": s2, "CR3(rho 0.02)": f3,
        "B1(F 0.75)": closed(baselines.b1_adjustments(dr, 0.75), "B1"),
        "B2(lam 1.3)": solver.solve_slsqp(baselines.b2_spec(dr, 1.3),
                                          maxiter=150),
        "B3(depth 0.3)": closed(baselines.b3_adjustments(
            dr, 0.3, max_cut=0.3), "B3"),
        "B4(lam 0.1)": solver.solve_slsqp(baselines.b4_spec(dr, 0.1),
                                          maxiter=150)}
    log("[policies] seven policies on the four-workload problem (carbon %, "
        "penalty %): " + "; ".join(
            f"{k} {v.carbon_reduction_pct:.4f} / {v.total_penalty_pct:.4f}"
            for k, v in line.items()))
    for k, v in line.items():
        require(bool(np.isfinite(v.D).all()) and v.D.shape == (4, T_MAIN),
                f"{k}: plan not finite or not (4, T)")
    return totals


def count_launches(torch, totals, tag, what, fn, want=None):
    """Run `fn` with every kernel's launch count set to 0 just before and
    read just after, add the counts to `totals` and, unless `want` is
    None, hold them to it (a callable computes it from the result).
    Returns (result, wall s)."""
    from repro_torch.core.daygraph import COUNTED
    for f in COUNTED.values():
        f.launches = 0
    out, wall = _timed(torch, fn)
    got = {n: f.launches for n, f in COUNTED.items()}
    for k in totals:
        totals[k] += got[k]
    if want is not None:
        want = want(out) if callable(want) else want
        log(f"[{tag}] {what}: launches {got} (expected {want}), wall "
            f"{wall:.4f} s")
        require(got == want, f"{tag} {what}: launches {got} != {want}")
    return out, wall


def device_busy(torch, fn):
    """(wall s, device-busy s) of `fn()` under `torch.profiler`: busy is
    the union of the traced kernel and copy intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with _padded_trace(torch, [ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    require(bool(spans), "the profiler traced no device event")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return wall, busy * 1e-6


def _plan_feasible(np, p, D, plan, what):
    """A migration plan meets its link caps exactly, moves nothing onto a
    region's own diagonal, and stays within supply and headroom."""
    from repro_torch.core.migration import region_aggregates
    y = plan.y
    bw = np.asarray(p.topology.bandwidth)
    movable, headroom = region_aggregates(p, D)
    require(bool((y >= 0.0).all() and (y <= bw[:, :, None]).all()),
            f"{what}: flows outside [0, bandwidth]")
    require(float(np.abs(np.trace(y.sum(axis=2)))) == 0.0,
            f"{what}: flows from a region to itself")
    require(bool((y.sum(axis=1) <= movable * (1 + 1e-9) + 1e-9).all()
                 and (y.sum(axis=0) <= headroom + 1e-9).all()),
            f"{what}: supply or headroom exceeded")


def phase_regions(np, torch, p_single, p):
    """Phase 5e: the multi-region fleet `p` (R = 3) through CR1/CR2 fused
    and generic, a CR1 sweep, CR3 through dr_features and plain, the
    migration post-stage and the coupled migration; R = 1 bitwise at the
    main fleet. Returns the summed launch counts."""
    from repro_torch.core.api import CR1, CR2, CR3, SolveContext, solve, sweep
    from repro_torch.core.fleet_solver import regional_fleet
    t_phase = time.perf_counter()
    bare = dataclasses.replace(p, topology=None)
    region = np.asarray(p.region)
    wmci = np.asarray(p.mci)[region]
    carbon = float((np.asarray(p.usage) * wmci).sum())
    log(f"[regions] synthetic_regional_fleet: W = {p.W}, T = {p.T}, R = "
        f"{p.R} (" + ", ".join(f"{s} {int((region == r).sum())}" for r, s
                              in enumerate(REGION_STATES))
        + f" rows), UTC clock; default topology: bandwidth "
        f"{float(p.topology.bandwidth[0, 1]):.6g} NP a link an hour, toll "
        f"{float(p.topology.cost[0, 1]):g}")
    totals = {"al_step": 0, "dr_features": 0}
    counted = functools.partial(count_launches, torch, totals, "regions")

    def report(what, r):
        require(bool(np.isfinite(r.D).all()) and r.D.shape == (p.W, p.T),
                f"regions {what}: plan not finite or not (W, T)")
        return (f"carbon {r.carbon_reduction_pct:.4f} %, penalty "
                f"{r.total_penalty_pct:.4f} %, preservation "
                f"{r.preservation_violation:.3e}")

    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):     # warm-up
        solve(bare, pol, ctx=SolveContext(steps=8))
    cr1_want = {"al_step": 600 // 8, "dr_features": 1}
    cr2_want = {"al_step": CR2.outer * (400 // 8),
                "dr_features": 1 + CR2.outer + 1}
    fused = {}
    for pol, want in ((CR1(lam=1.45), cr1_want),
                      (CR2(cap_frac=0.78), cr2_want)):
        torch.cuda.reset_peak_memory_stats()
        r, _ = counted(f"{pol.name} fused", lambda pol=pol: solve(bare, pol),
                       want)
        peak = torch.cuda.max_memory_allocated()
        g, gwall = _timed(torch, lambda pol=pol: solve(
            bare, pol, ctx=SolveContext(use_kernel=False)))
        fused[pol.name] = r
        dc, dp = _pp_gaps(r, g)
        log(f"[regions] {pol.name} fused: {report(pol.name, r)}, peak "
            f"{peak / 2**20:.1f} MiB; generic: {report(pol.name, g)}, wall "
            f"{gwall:.4f} s; fused - generic {dc:.2e} / {dp:.2e} pp (limit "
            f"{PP_TOL})")
        require(dc < PP_TOL and dp < PP_TOL,
                f"regions {pol.name}: fused vs generic {dc:.4f} / {dp:.4f}")
        require(r.preservation_violation < PRESERVATION_TOL,
                f"regions {pol.name}: preservation")
    wall, busy = device_busy(torch, lambda: solve(bare, CR1(lam=1.45)))
    log(f"[regions] cr1 fused under torch.profiler: wall {wall * 1e3:.3f} "
        f"ms, device busy {busy * 1e3:.3f} ms, idle share "
        f"{1.0 - busy / wall:.4f}")

    # R = 1 is the single-region path, bit for bit, at W = 10,000.
    one = regional_fleet([p_single], np.asarray(p_single.mci)[None])
    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):
        a, b = solve(p_single, pol), solve(one, pol)
        require(np.array_equal(a.D, b.D)
                and a.carbon_reduction_pct == b.carbon_reduction_pct
                and a.total_penalty_pct == b.total_penalty_pct,
                f"regions: R = 1 {pol.name} is not the single-region solve")
    log(f"[regions] R = 1 at W = {p_single.W}: CR1 and CR2 bitwise equal to "
        f"the single-region solves")

    # A CR1 sweep: the lanes' per-row norms and carbon rows, one launch per
    # 8 steps for all lanes.
    pols = [CR1(lam=lam) for lam in REGION_LAMS]
    lanes, lw = counted(f"CR1 sweep over lam {REGION_LAMS}",
                        lambda: sweep(bare, pols), cr1_want)
    loop, loopw = _timed(torch, lambda: [solve(bare, pl) for pl in pols])
    gaps = [max(_pp_gaps(a, b)) for a, b in zip(lanes, loop)]
    log(f"[regions] sweep {lw:.4f} s, its loop {loopw:.4f} s; lane - loop "
        f"max {max(gaps):.2e} pp (limit {LANE_PP})")
    require(max(gaps) < LANE_PP, f"regions sweep vs loop {max(gaps):.4f}")

    # CR3: a market per region, at CR3_REGION_STEPS (not its default
    # budget: chip_smoke's wall), through the kernels and then plain.
    outer = CR3.outer
    solve(bare, CR3(), ctx=SolveContext(steps=2))         # warm-up
    short = SolveContext(steps=CR3_REGION_STEPS)
    k3, _ = counted(f"CR3 at {CR3_REGION_STEPS} x {outer} steps a round",
                    lambda: solve(bare, CR3(), ctx=short),
                    lambda r: expected_cr3_launches(
                        CR3_REGION_STEPS, outer,
                        _cr3_rounds(r, CR3_REGION_STEPS, outer)))
    log(f"[regions] CR3: rounds "
        f"{_cr3_rounds(k3, CR3_REGION_STEPS, outer)}, rho "
        f"{np.array2string(k3.extras['rho'], precision=6)}, balanced "
        f"{k3.balanced}, {report('CR3', k3)}")
    require(k3.preservation_violation < PRESERVATION_TOL,
            "regions CR3 preservation")
    g3, g3w = _timed(torch, lambda: solve(bare, CR3(), ctx=dataclasses.replace(
        short, use_kernel=False)))
    drho = np.abs(k3.extras["rho"] / g3.extras["rho"] - 1.0)
    log(f"[regions] CR3 {CR3_REGION_STEPS} steps: kernels rounds "
        f"{_cr3_rounds(k3, CR3_REGION_STEPS, outer)}, rho "
        f"{np.array2string(k3.extras['rho'], precision=6)}; plain rounds "
        f"{_cr3_rounds(g3, CR3_REGION_STEPS, outer)}, wall {g3w:.4f} s; rho "
        f"kernels - plain {drho.max():.2e} relative (limit {CR3_RHO_RTOL})")
    require(k3.iters == g3.iters and k3.balanced == g3.balanced,
            "regions CR3 kernels vs plain: rounds or balance")
    require(float(drho.max()) < CR3_RHO_RTOL, "regions CR3 rho")

    # Migration: the post-stage, then the coupled refinement, for CR1.
    post, _ = counted("CR1 with the migration post-stage",
                      lambda: solve(p, CR1(lam=1.45)), cr1_want)
    plan = post.extras["migration"]
    require(np.array_equal(post.D, fused["cr1"].D),
            "regions: the post-stage changed the plan")
    _plan_feasible(np, p, post.D, plan, "post-stage plan")
    coup, _ = counted(
        "CR1 with coupled migration (4 x 600 generic steps)",
        lambda: solve(p, CR1(lam=1.45), ctx=SolveContext(
            coupled_migration=True)),
        {"al_step": 600 // 8, "dr_features": 1 + 4 * 600 + 1})
    tot_post, tot_coup = float(post.D.sum()), float(coup.D.sum())
    log(f"[regions] post-stage: moved {plan.moved_total:.6g} NP·h, net "
        f"credit {100.0 * plan.net_saved / carbon:.4f} % of carbon, CR1 "
        f"{post.carbon_reduction_pct:.4f} %; coupled: kept "
        f"{bool(coup.extras.get('coupled_migration'))}, CR1 "
        f"{coup.carbon_reduction_pct:.4f} %, net credit "
        f"{100.0 * coup.extras['migration'].net_saved / carbon:.4f} %, "
        f"curtailment {tot_coup:.6g} against {tot_post:.6g}")
    require(coup.carbon_reduction_pct >= post.carbon_reduction_pct,
            "regions: coupled migration below the post-stage")
    require(abs(tot_coup - tot_post) <= 2e-3 * max(abs(tot_post), 1.0),
            "regions: coupled migration moved total curtailment")
    if coup.extras.get("coupled_migration"):
        _plan_feasible(np, p, coup.D, coup.extras["migration"],
                       "coupled plan")

    # Each region priced on its own trace against the best single signal,
    # at equal total curtailment (a plan scaled down stays feasible).
    best = []
    for r in range(p.R):
        single = dataclasses.replace(p, mci=np.asarray(p.mci)[r],
                                     region=None, topology=None)
        rs = solve(single, CR1(lam=1.45))
        scale = tot_post / max(float(rs.D.sum()), 1e-12)
        best.append((100.0 * float((rs.D * wmci).sum()) / carbon * scale,
                     scale))
    log(f"[regions] CR1 carbon at equal curtailment: per-region pricing + "
        f"migration {post.carbon_reduction_pct:.4f} %; one signal for the "
        f"fleet, that of " + ", ".join(
            f"{s} {b:.4f} % (plan scaled by {k:.4f})"
            for s, (b, k) in zip(REGION_STATES, best))
        + f"; margin over the best "
        f"{post.carbon_reduction_pct - max(b for b, _ in best):.4f} pp")
    log(f"[regions] phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


def phase_region_fleet():
    """Phase 5e's fleet: `synthetic_regional_fleet(10_000, ["CA", "TX",
    "NY"], hours=48, seed=0, utc_offsets="auto")` on phase 3's templates,
    with its default topology."""
    from repro_torch.core.fleet_solver import synthetic_regional_fleet
    from repro_torch.core.fleetcache import cached_paper_fleet
    templates = cached_paper_fleet(hours=T_MAIN, num_samples=CAL_SAMPLES,
                                   num_jobs=CAL_JOBS, device="cuda")
    return synthetic_regional_fleet(W_MAIN, list(REGION_STATES),
                                    hours=T_MAIN, seed=0, utc_offsets="auto",
                                    templates=templates)


def phase_region_lanes(np, torch, p_single, p):
    """Phase 5f: the multi-region fleet `p` (R = 3) in the streaming and
    batched lanes: the per-region sums against their mask form; a 24-tick
    CR1 and CR2 day with one stream per region (loop, capture, replay,
    eager, warm second day, R = 1 bitwise); RegionalDivergence ensembles
    (with and without the migration credit); a streaming ensemble of
    per-region stream groups; the warm refinement sweep. Each call's
    launch counts are reset just before and read just after. Returns the
    summed counts."""
    from repro_torch.core import api, regional
    from repro_torch.core import ensemble as ens
    from repro_torch.core import scenario as scen
    from repro_torch.core.api import (CR1, CR2, SolveContext,
                                      configured_policy, solve, solve_day,
                                      stack_states, sweep)
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.daygraph import DAY_GRAPHS
    from repro_torch.core.fleet_solver import device_view, regional_fleet
    from repro_torch.core.streaming import RollingHorizonSolver
    t_phase = time.perf_counter()
    bare = dataclasses.replace(p, topology=None)
    totals = {"al_step": 0, "dr_features": 0}
    counted = functools.partial(count_launches, torch, totals, "regions 5f")

    # The per-region sums: index_select over each region's rows (found once
    # on the host) against x[mask].sum(), which reads a count on the host.
    view = device_view(bare, torch.device("cuda"))
    quantities = {"usage row sums": view.usage.sum(1),
                  "entitlements": view.entitlement,
                  "carbon row sums": (view.usage
                                      * view.mci[view.region]).sum(1)}
    for what, x in quantities.items():
        got = regional.region_sum(x, view.region, view.region_index)
        want = torch.zeros_like(x)
        for r in range(p.R):
            mask = view.region == r
            want = torch.where(mask, x[mask].sum(), want)
        require(torch.equal(got, want),
                f"regions 5f: region_sum of {what} differs from the mask sum")
    log(f"[regions 5f] region_sum (index_select over rows "
        f"{view.region_index.counts}) bitwise equal to the mask sums of "
        + ", ".join(quantities))

    # Days: one stream per region over the fleet's own traces.
    streams = ForecastStream.regional(
        np.tile(np.asarray(p.mci), (1, 2)), horizon=T_MAIN,
        revision_sigma=REGION_STREAM_SIGMA, seed=REGION_STREAM_SEED)
    stack = np.stack([np.stack([st.forecast(t) for st in streams])
                      for t in range(DAY_TICKS)])
    window = dataclasses.replace(bare, mci=stack[0])
    one = regional_fleet([p_single], np.asarray(p_single.mci)[None])
    single_stream = ForecastStream.caiso(n_ticks=DAY_TICKS, horizon=T_MAIN,
                                         seed=DAY_SEED)
    for name, cold, warm, rounds in DAY_POLICIES:
        pol = configured_policy(name, outer=rounds)
        kw = dict(policy=pol, cold_steps=cold, warm_steps=warm)
        loop, loop_wall = _timed(torch, lambda: RollingHorizonSolver(
            p, streams, **kw).run(DAY_TICKS))
        a, b = (RollingHorizonSolver(p, streams, **kw) for _ in range(2))
        n0 = DAY_GRAPHS.captures
        torch.cuda.reset_peak_memory_stats()
        first, capture_wall = _timed(torch, lambda: a.run_scanned(DAY_TICKS))
        capture_peak = torch.cuda.max_memory_allocated()
        require(DAY_GRAPHS.captures == n0 + 1,
                f"regions {name}: the first day did not capture one graph")
        want = expected_day_launches(cold, warm, rounds, DAY_TICKS)
        torch.cuda.reset_peak_memory_stats()
        scan, replay_wall = counted(f"{name} day replay",
                                    lambda: b.run_scanned(DAY_TICKS), want)
        replay_peak = torch.cuda.max_memory_allocated()
        require(DAY_GRAPHS.captures == n0 + 1,
                f"regions {name}: the second day captured again")

        def replay():
            return solve_day(window, pol, stack, ctx=SolveContext(),
                             cold_steps=cold, warm_steps=warm)

        on_device = device_launches(torch, f"regions {name} day", replay,
                                    want)
        wall, busy = device_busy(torch, replay)
        res = replay()
        _, _, day, inputs = api._day_setup(window, pol, stack, SolveContext(),
                                           cold, warm)
        require(day.R == p.R and day.region_counts
                == view.region_index.counts, f"regions {name}: day key")
        with torch.no_grad():
            eager, eager_wall = _timed(torch, lambda: api._day_impl(day,
                                                                   inputs))
        st = res.last.state
        got = [res.committed, res.last.D,
               *(t.cpu().numpy() for t in (st.x, st.lam_eq, st.mu))]
        ref = [t.cpu().numpy() for t in eager[:2]] + [
            t.cpu().numpy() for t in (eager[3], eager[4], eager[6])]
        replay_err = max(float(np.abs(g - r).max(initial=0.0))
                         for g, r in zip(got, ref))
        require(np.array_equal(first.committed, scan.committed),
                f"regions {name}: the captured day differs from its replay")
        d_pp = abs(scan.realized_reduction_pct - loop.realized_reduction_pct)
        d_commit = float(np.abs(scan.committed - loop.committed).max())
        pres = scan.ticks[-1].plan.preservation_violation
        by_region = np.sum([t.committed_by_region for t in scan.ticks], 0)
        log(f"[regions 5f] {name} day: kernels the card ran in one replay, "
            f"by torch.profiler: {on_device}; realized carbon loop "
            f"{loop.realized_reduction_pct:.4f} %, day "
            f"{scan.realized_reduction_pct:.4f} % ({d_pp:.2e} pp, limit "
            f"{SCAN_PP}); committed max |day - loop| {d_commit:.3e} NP "
            f"(limit {COMMIT_ATOL}); replay vs eager max |diff| "
            f"{replay_err:.3e} (limit {REPLAY_TOL:g}); committed NP·h by "
            f"region {np.array2string(by_region, precision=2)}; last plan "
            f"preservation {pres:.3e}")
        require(d_pp < SCAN_PP, f"regions {name}: loop vs day {d_pp:.4f} pp")
        require(d_commit <= COMMIT_ATOL,
                f"regions {name}: committed {d_commit:.3e}")
        require(replay_err <= REPLAY_TOL,
                f"regions {name}: replay vs eager {replay_err:.3e}")
        require(pres < PRESERVATION_TOL,
                f"regions {name}: preservation {pres:.3e}")
        for r in (loop, scan):
            require(bool(np.isfinite(r.committed).all())
                    and r.committed.shape == (p.W, DAY_TICKS),
                    f"regions {name}: committed hours not finite or not "
                    f"(W, 24)")
        n1 = DAY_GRAPHS.captures
        b2, warm_capture_wall = _timed(torch, lambda: b.run_scanned(DAY_TICKS))
        a2, warm_wall = _timed(torch, lambda: a.run_scanned(DAY_TICKS))
        require(DAY_GRAPHS.captures == n1 + 1,
                f"regions {name}: the warm days did not share one graph")
        require(np.array_equal(a2.committed, b2.committed),
                f"regions {name}: two replays of one warm day differ")
        require(bool(np.isfinite(a2.committed).all())
                and a2.ticks[-1].plan.preservation_violation
                < PRESERVATION_TOL, f"regions {name}: warm day")
        log(f"[regions 5f] {name} day walls (host clock, synchronized): "
            f"per-tick loop {loop_wall:.4f} s; first day (warm-up + capture "
            f"+ replay) {capture_wall:.4f} s; replay {replay_wall:.4f} s "
            f"(under torch.profiler {wall * 1e3:.3f} ms, device busy "
            f"{busy * 1e3:.3f} ms, idle share {1.0 - busy / wall:.4f}); the "
            f"eager day {eager_wall:.4f} s; warm second day: capture "
            f"{warm_capture_wall:.4f} s, replay {warm_wall:.4f} s (realized "
            f"{a2.realized_reduction_pct:.4f} %); peak memory first day "
            f"{capture_peak / 2**20:.1f} MiB, replay "
            f"{replay_peak / 2**20:.1f} MiB")
        # R = 1 of the main fleet is its single-region day, bit for bit.
        s1, s2 = (RollingHorizonSolver(q, [single_stream], **kw)
                  .run_scanned(DAY_TICKS) for q in (p_single, one))
        require(np.array_equal(s1.committed, s2.committed)
                and s1.realized_carbon == s2.realized_carbon,
                f"regions {name}: the R = 1 day is not the single-region day")
        log(f"[regions 5f] {name}: R = 1 day at W = {p_single.W} bitwise "
            f"equal to the single-region day")

    # Ensembles over RegionalDivergence, batched against their loop.
    def held(what, got, loop, lw):
        dc = float(np.abs(got.carbon_reduction_pct
                          - loop.carbon_reduction_pct).max())
        dp = float(np.abs(got.total_penalty_pct
                          - loop.total_penalty_pct).max())
        pres = float(got.preservation_violation.max())
        log(f"[regions 5f] {what}: loop of {got.S} solve() {lw:.4f} s; "
            f"batched - loop max {dc:.2e} pp carbon, {dp:.2e} pp penalty "
            f"(limit {LANE_PP}); carbon p5/p50/p95 "
            + "/".join(f"{np.percentile(got.carbon_reduction_pct, q):.4f}"
                       for q in (5, 50, 95))
            + f" %; preservation max {pres:.3e}")
        require(bool(np.isfinite(got.D).all())
                and got.D.shape == (got.S, p.W, p.T),
                f"{what}: plans not finite or not (S, W, T)")
        require(got.batched and not loop.batched, f"{what}: lanes")
        require(dc < LANE_PP and dp < LANE_PP,
                f"{what}: batched vs loop {dc:.4f} / {dp:.4f} pp")
        require(pres < PRESERVATION_TOL, f"{what}: preservation {pres:.3e}")

    divergence = scen.RegionalDivergence(REGION_ENSEMBLE_S, seed=0)
    for pol, want in ((CR1(lam=1.45), expected_lane_launches(600, 1)),
                      (CR2(cap_frac=0.78), expected_lane_launches(
                          400, CR2.outer, n_targets=1))):
        what = f"{pol.name} ensemble over RegionalDivergence(" \
               f"{REGION_ENSEMBLE_S})"
        torch.cuda.reset_peak_memory_stats()
        got, _ = counted(what, lambda pol=pol: ens.evaluate_ensemble(
            bare, pol, divergence), want)
        peak = torch.cuda.max_memory_allocated()
        loop, lw = _timed(torch, lambda pol=pol: ens.evaluate_ensemble(
            bare, pol, divergence, batched=False))
        held(what, got, loop, lw)
        log(f"[regions 5f] {what}: peak {peak / 2**20:.1f} MiB")
    credit = scen.RegionalDivergence(REGION_CREDIT_S, seed=1)
    what = (f"cr1 ensemble over RegionalDivergence({REGION_CREDIT_S}) with "
            f"the default topology")
    got, _ = counted(what, lambda: ens.evaluate_ensemble(
        p, CR1(lam=1.45), credit), expected_lane_launches(600, 1))
    loop, lw = _timed(torch, lambda: ens.evaluate_ensemble(
        p, CR1(lam=1.45), credit, batched=False))
    held(what, got, loop, lw)
    require(all("migration" in e for e in got.extras + loop.extras),
            f"{what}: the credit is missing from a lane")
    carbon = [float((np.asarray(q.usage) * np.asarray(q.mci)[
        np.asarray(q.region)]).sum()) for q in credit.generate(p).problems(p)]
    log(f"[regions 5f] {what}: net credit per scenario, batched "
        + ", ".join(f"{100.0 * e['migration'].net_saved / c:.4f}"
                    for e, c in zip(got.extras, carbon))
        + " %, loop "
        + ", ".join(f"{100.0 * e['migration'].net_saved / c:.4f}"
                    for e, c in zip(loop.extras, carbon)) + " % of carbon")

    # The streaming ensemble: S groups of one stream per region.
    groups = scen.ForecastRegime(STREAM_LANES, seed=0).streams(
        p, n_ticks=DAY_TICKS)
    kw = dict(cold_steps=600, warm_steps=150)
    rep, rep_wall = counted(
        f"cr1 streaming ensemble, {STREAM_LANES} groups of {p.R} streams x "
        f"{DAY_TICKS} ticks", lambda: ens.run_streaming_ensemble(
            p, CR1(lam=1.45), groups, n_ticks=DAY_TICKS, **kw),
        expected_day_launches(600, 150, 1, DAY_TICKS))
    require(bool(np.isfinite(rep.committed).all())
            and rep.committed.shape == (STREAM_LANES, p.W, DAY_TICKS),
            "regions streaming ensemble: committed hours")
    for s in (0, STREAM_LANES - 1):
        solo, sw = _timed(torch, lambda: RollingHorizonSolver(
            p, groups[s], policy=CR1(lam=1.45), **kw).run(DAY_TICKS))
        d = abs(rep.realized_reduction_pct[s] - solo.realized_reduction_pct)
        dcom = float(np.abs(rep.committed[s] - solo.committed).max())
        log(f"[regions 5f] stream group {s}: realized "
            f"{rep.realized_reduction_pct[s]:.4f} % batched, "
            f"{solo.realized_reduction_pct:.4f} % solo ({d:.2e} pp, limit "
            f"{LANE_PP}); committed max |diff| {dcom:.3e} NP; solo "
            f"controller {sw:.4f} s")
        require(d < LANE_PP, f"regions stream group {s}: {d:.4f} pp")

    # The warm refinement sweep from stack_states: each lane its warm solve.
    pols = [CR1(lam=lam) for lam in REGION_LAMS]
    cold = sweep(bare, pols)
    warm_ctx = SolveContext(steps=REFINE_STEPS,
                            warm=stack_states([r.state for r in cold]))
    ref, ref_wall = counted(
        f"CR1 refinement over lam {REGION_LAMS} from stack_states, "
        f"{REFINE_STEPS} steps", lambda: sweep(bare, pols, ctx=warm_ctx),
        expected_lane_launches(REFINE_STEPS, 1))
    loopw, ww = _timed(torch, lambda: [solve(bare, pl, ctx=SolveContext(
        steps=REFINE_STEPS, warm=r.state)) for pl, r in zip(pols, cold)])
    for a, b in zip(ref, loopw):
        require(np.array_equal(a.D, b.D)
                and a.carbon_reduction_pct == b.carbon_reduction_pct,
                "regions refinement: a lane differs from its warm solve()")
    log(f"[regions 5f] refinement: lanes bitwise equal to their warm "
        f"solve(); batched {ref_wall:.4f} s, loop {ww:.4f} s")
    log(f"[regions 5f] phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


def _shard_cases(p, p_regions):
    """Phase 5g's solves: (name, fleet, policy class name, policy kwargs,
    SolveContext kwargs, mesh regions). The regional fleet without its
    topology: the migration post-stage is the gathered plan's, the same
    on every rank, and the CPU tests hold it."""
    bare = dataclasses.replace(p_regions, topology=None)
    return (("cr1", p, "CR1", {"lam": 1.45}, {}, None),
            ("cr2", p, "CR2", {"cap_frac": 0.78}, {}, None),
            ("cr3", p, "CR3", {}, {"steps": SHARD_CR3_STEPS}, None),
            ("regions cr1", bare, "CR1", {"lam": 1.45}, {}, 3),
            ("regions cr2", bare, "CR2", {"cap_frac": 0.78}, {}, 3))


def _shard_summary(np, r, W):
    """What a rank reports of a sharded result."""
    import hashlib
    st = r.state
    pads = [float(a[W:].abs().max()) if a.dim() and a.shape[0] > W else 0.0
            for a in (st.x, st.lam_eq, st.lam_in)]
    return {"carbon": r.carbon_reduction_pct,
            "penalty": r.total_penalty_pct, "iters": r.iters,
            "extras": {k: r.extras[k] for k in ("rho", "balanced")
                       if k in r.extras},
            "D_shape": r.D.shape, "x_shape": tuple(st.x.shape),
            "pad_max": max(pads),
            "digest": hashlib.sha256(np.ascontiguousarray(r.D)).hexdigest()}


def _shard_solves(np, torch, cases, mesh, keep_D):
    """Every case through `solve` on `mesh`, each with the launch counts
    reset just before and read just after: name -> summary (`keep_D`:
    the plan too), launches, wall s."""
    from repro_torch.core import api
    from repro_torch.core.daygraph import COUNTED
    out = {}
    for name, fleet, pol, pkw, ckw, regions in cases:
        ctx = api.SolveContext(mesh=mesh[regions], **ckw)
        policy = getattr(api, pol)(**pkw)
        for f in COUNTED.values():
            f.launches = 0
        r, wall = _timed(torch, lambda: api.solve(fleet, policy, ctx=ctx))
        summary = _shard_summary(np, r, fleet.W)
        if keep_D:
            summary["D"] = r.D
        out[name] = (summary, {n: f.launches for n, f in COUNTED.items()},
                     wall)
    return out


def _shard_wait(tmp, name):
    """Wait for the parent's signal file `tmp`/`name`."""
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(tmp, name)):
        if time.perf_counter() - t0 > SHARD_WAIT_S:
            raise TimeoutError(f"phase 5g: no {name} signal")
        time.sleep(0.02)


def _shard_rank(rank, world, tmp):
    """One gloo rank of phase 5g on the card (spawned before phase 5e, so
    that its start-up runs beside 5e and 5f): the cases from
    `tmp`/cases.pkl (a file, so that starting the rank sends no fleet
    through its pipe); once `tmp`/warm exists (phase 5g has begun), a
    warm-up solve; once `tmp`/go exists, every case; its results to
    `tmp`/rank<r>.pkl."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "gloo"), world), rank=rank, world_size=world)
    try:
        from repro_torch.core import api
        from repro_torch.launch.mesh import make_fleet_mesh
        with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
            cases, jobs = pickle.load(f)
        mesh = {None: make_fleet_mesh(), 3: make_fleet_mesh(regions=3)}
        _shard_wait(tmp, "warm")
        for pol in (api.CR1(), api.CR2()):           # warm-up, not counted
            api.solve(cases[0][1], pol, ctx=api.SolveContext(
                steps=8, mesh=mesh[None]))
        torch.cuda.synchronize()
        _shard_wait(tmp, "go")
        dist.barrier()
        res = _shard_solves(np, torch, cases, mesh, keep_D=rank == 0)
        for job in jobs:
            for label, *got in _shard_job(np, torch, job, mesh[job[-1]]):
                res[label] = tuple(got)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _shard_check(np, tag, name, got, solo, solo_launches, W, W_pad):
    """A sharded rank's result against the unsharded solve: carbon and
    penalty within SHARD_PP; CR3's rounds and balance equal and rho
    within A6's bounds; shapes; pad rows 0; launches equal."""
    summary, launches, _ = got
    dc = abs(summary["carbon"] - solo.carbon_reduction_pct)
    dp = abs(summary["penalty"] - solo.total_penalty_pct)
    require(dc < SHARD_PP and dp < SHARD_PP,
            f"{tag} {name}: {dc:.3e} pp carbon, {dp:.3e} pp penalty from "
            f"the unsharded solve (limit {SHARD_PP})")
    require(summary["D_shape"] == (W, solo.D.shape[1])
            and summary["x_shape"] == (W_pad, solo.D.shape[1]),
            f"{tag} {name}: D {summary['D_shape']}, state.x "
            f"{summary['x_shape']}")
    require(summary["pad_max"] == 0.0,
            f"{tag} {name}: pad rows of the state {summary['pad_max']}")
    require(summary["iters"] == solo.iters,
            f"{tag} {name}: {summary['iters']} iterations, unsharded "
            f"{solo.iters}")
    if "rho" in solo.extras:
        rho, want = summary["extras"]["rho"], solo.extras["rho"]
        drho = abs(rho - want) / want
        one = solo.iters == SHARD_CR3_STEPS * 3
        require(summary["extras"]["balanced"] == solo.extras["balanced"]
                and drho < (CR3_RHO_RTOL if one else SHARD_RHO_MULTI),
                f"{tag} {name}: rho {rho} vs {want}, balanced "
                f"{summary['extras']['balanced']}")
    require(launches == solo_launches,
            f"{tag} {name}: launches {launches} != unsharded "
            f"{solo_launches}")


def _shard_jobs(np, p, p_regions):
    """Phase 5g's sweeps, days, ensembles and streams: (name, kind, fleet,
    spec, mesh regions), each run by `_shard_job`."""
    from repro_torch.core import api
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.scenario import (DuckPerturb, FleetJitter,
                                           FlexMixShift)
    bare = dataclasses.replace(p_regions, topology=None)
    stream = ForecastStream.caiso(n_ticks=DAY_TICKS, horizon=T_MAIN,
                                  seed=DAY_SEED)
    stack = np.stack([stream.forecast(t) for t in range(DAY_TICKS)])
    streams = ForecastStream.regional(
        np.tile(np.asarray(bare.mci), (1, 2)), horizon=T_MAIN,
        revision_sigma=REGION_STREAM_SIGMA, seed=REGION_STREAM_SEED)
    rstack = np.stack([np.stack([st.forecast(t) for st in streams])
                       for t in range(DAY_TICKS)])
    cr1, cr2 = api.CR1(lam=1.45), api.CR2(cap_frac=0.78, outer=2)
    scen = (DuckPerturb(4, seed=0), FleetJitter(2, seed=1),
            FlexMixShift(2, seed=2))

    def day(fleet, pol, stack_):
        return (dataclasses.replace(fleet, mci=stack_[0]),
                dict(policy=pol, stack=stack_))

    def ticks(scanned):
        return dict(scanned=scanned, stream=ForecastStream.caiso(
            n_ticks=SHARD_STREAM_TICKS, horizon=T_MAIN, seed=DAY_SEED))

    return (
        ("sweep cr1", "sweep", p, dict(policies=[
            api.CR1(lam=x) for x in SHARD_LAMS]), None),
        ("sweep cr2", "sweep", p, dict(policies=[
            api.CR2(cap_frac=c, outer=2) for c in SHARD_CAPS]), None),
        ("day cr1", "day", *day(p, cr1, stack), None),
        ("day cr2", "day", *day(p, cr2, stack), None),
        ("regions day cr1", "day", *day(bare, cr1, rstack), 3),
        ("ensemble cr1", "ensemble", p, dict(policy=cr1, scenarios=scen),
         None),
        ("ensemble cr2", "ensemble", p, dict(policy=cr2, scenarios=scen),
         None),
        ("stream run", "stream", p, ticks(False), None),
        ("stream scanned", "stream", p, ticks(True), None))


def _digest(np, *arrays):
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def _job_summary(np, kind, r, W):
    """What a process reports of one of `_shard_job`'s results: carbon
    and penalty (per lane or scenario), digests of the plans (and of the
    state's true rows), a day's or a stream's committed hours, the
    state's shape and its pad rows' largest magnitude."""
    if kind == "sweep":
        return {"carbon": np.asarray([x.carbon_reduction_pct for x in r]),
                "penalty": np.asarray([x.total_penalty_pct for x in r]),
                "digest": _digest(np, *(x.D for x in r)),
                "stateless": all(x.state is None for x in r)}
    if kind == "ensemble":
        return {"carbon": r.carbon_reduction_pct,
                "penalty": r.total_penalty_pct,
                "digest": _digest(np, r.D, r.penalties),
                "batched": r.batched}
    if kind == "day":
        carbon, penalty = (r.last.carbon_reduction_pct,
                           r.last.total_penalty_pct)
        committed, D, steps, st = (r.committed, r.last.D, r.inner_steps,
                                   r.last.state)
    else:
        rep, st = r
        plan = rep.ticks[-1].plan
        carbon, penalty = rep.realized_reduction_pct, plan.total_penalty_pct
        committed, D, steps = rep.committed, plan.D, rep.total_inner_steps
    leaves = [t.cpu().numpy() for t in (st.x, st.lam_eq, st.lam_in, st.mu)]
    true = [a[:W] if a.ndim and a.shape[0] > W else a for a in leaves]
    return {"carbon": np.asarray([carbon]), "penalty": np.asarray([penalty]),
            "digest": _digest(np, committed, D, *true),
            "committed": committed, "inner_steps": steps,
            "x_shape": tuple(st.x.shape),
            "pad_max": max(float(np.abs(a[W:]).max()) if a.ndim
                           and a.shape[0] > W else 0.0 for a in leaves[:3])}


def _shard_job(np, torch, job, mesh):
    """One of `_shard_jobs` on `mesh` (None: unsharded), each call with
    the launch counts reset just before and read just after: [(label,
    summary, launches, wall s)], a day twice (its capture, then
    "<name> replay")."""
    from repro_torch.core import api
    from repro_torch.core.daygraph import COUNTED
    from repro_torch.core.ensemble import evaluate_ensemble
    from repro_torch.core.streaming import RollingHorizonSolver
    name, kind, fleet, spec, _ = job
    ctx = api.SolveContext(mesh=mesh, steps=SHARD_STEPS)
    budget = dict(cold_steps=SHARD_STEPS, warm_steps=SHARD_WARM_STEPS)
    if kind == "sweep":
        calls = [(name, lambda: api.sweep(fleet, spec["policies"], ctx=ctx))]
    elif kind == "ensemble":
        calls = [(name, lambda: evaluate_ensemble(
            fleet, spec["policy"], list(spec["scenarios"]), ctx=ctx))]
    elif kind == "day":
        def call():
            return api.solve_day(fleet, spec["policy"], spec["stack"],
                                 ctx=api.SolveContext(mesh=mesh), **budget)
        calls = [(name, call), (name + " replay", call)]
    else:
        def call():
            solver = RollingHorizonSolver(fleet, spec["stream"],
                                          policy=api.CR1(lam=1.45),
                                          mesh=mesh, **budget)
            run = solver.run_scanned if spec["scanned"] else solver.run
            return run(SHARD_STREAM_TICKS), solver._state
        calls = [(name, call)]
    out = []
    for label, call in calls:
        for f in COUNTED.values():
            f.launches = 0
        r, wall = _timed(torch, call)
        out.append((label, _job_summary(np, kind, r, fleet.W),
                    {n: f.launches for n, f in COUNTED.items()}, wall))
    return out


def _job_check(np, tag, label, kind, got, solo, W_pad, bitwise):
    """A sharded job's result against the unsharded call's: launches
    equal; carbon and penalty within SHARD_PP; bitwise in a world-1
    group; sweeps stateless, ensembles batched; a day's or a stream's
    committed hours within SHARD_DAY_NP, the same inner steps, the state
    (W_pad, T) with pad rows 0."""
    (summary, launches, _), (want, want_launches, _) = got, solo
    require(launches == want_launches,
            f"{tag} {label}: launches {launches} != unsharded "
            f"{want_launches}")
    dc = float(np.abs(summary["carbon"] - want["carbon"]).max())
    dp = float(np.abs(summary["penalty"] - want["penalty"]).max())
    require(dc < SHARD_PP and dp < SHARD_PP,
            f"{tag} {label}: {dc:.3e} pp carbon, {dp:.3e} pp penalty from "
            f"the unsharded call (limit {SHARD_PP})")
    require(not bitwise or summary["digest"] == want["digest"],
            f"{tag} {label}: not bitwise the unsharded call")
    if kind == "sweep":
        require(summary["stateless"], f"{tag} {label}: a lane has a state")
    elif kind == "ensemble":
        require(summary["batched"], f"{tag} {label}: not the batched lane")
    else:
        dD = float(np.abs(summary["committed"] - want["committed"]).max())
        require(dD <= SHARD_DAY_NP,
                f"{tag} {label}: committed {dD:.3e} NP from the unsharded "
                f"call (limit {SHARD_DAY_NP})")
        require(summary["inner_steps"] == want["inner_steps"]
                and summary["x_shape"] == (W_pad, T_MAIN)
                and summary["pad_max"] == 0.0,
                f"{tag} {label}: inner steps {summary['inner_steps']}, "
                f"state {summary['x_shape']}, pad rows "
                f"{summary['pad_max']}")


def _job_log(np, tag, label, got, solo):
    summary, launches, wall = got
    dc = float(np.abs(summary["carbon"] - solo[0]["carbon"]).max())
    extra = ""
    if "committed" in summary:
        dD = float(np.abs(summary["committed"] - solo[0]["committed"]).max())
        extra = f", committed max |dD| {dD:.3e} NP"
    log(f"[shard 5g] {label} {tag}: bitwise "
        f"{summary['digest'] == solo[0]['digest']}, max |d carbon| "
        f"{dc:.3e} pp{extra}, wall {wall:.4f} s, launches {launches}")


def _shard_spawn(p, p_regions):
    """Start phase 5g's SHARD_RANKS gloo ranks (`_shard_rank`) on the one
    card, with its cases in a fresh temporary directory. -> (procs, tmp,
    cases, jobs); `_shard_stop` ends them."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    import numpy as np
    cases, jobs = _shard_cases(p, p_regions), _shard_jobs(np, p, p_regions)
    tmp = tempfile.mkdtemp(prefix="fleet_mesh_")
    with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
        pickle.dump((cases, jobs), f)
    procs = mp.start_processes(_shard_rank, args=(SHARD_RANKS, tmp),
                               nprocs=SHARD_RANKS, join=False,
                               start_method="spawn")
    return procs, tmp, cases, jobs


def _shard_stop(ranks):
    """Kill any of phase 5g's ranks still alive (none is left behind on a
    failure) and remove their directory."""
    procs, tmp = ranks[:2]
    for proc in procs.processes:
        if proc.is_alive():
            proc.kill()
    shutil.rmtree(tmp, ignore_errors=True)


def phase_fleet_sharding(np, torch, p, p_regions, shard_ranks):
    """Phase 5g: fleet row sharding on `torch.distributed`. CR1(1.45),
    CR2(0.78) and CR3 (SHARD_CR3_STEPS) on the main fleet, CR1 and CR2 on
    the three-region fleet over a (3, 1) (region, fleet) mesh: unsharded
    in this process, then in a world-1 NCCL group here, and on the
    SHARD_RANKS gloo processes `_shard_spawn` started on the one card (W
    pads to a multiple of 3), each held to the unsharded solve
    (`_shard_check`), the ranks to each other bitwise. Then the same for
    `_shard_jobs`' sweeps, days, ensembles and streams (`_job_check`):
    bitwise in the world-1 group, a rank's replay against its capture
    day. Returns this process's launches."""
    import pickle

    import torch.distributed as dist
    from repro_torch.core import api
    from repro_torch.core.daygraph import DAY_GRAPHS
    from repro_torch.launch.mesh import make_fleet_mesh
    t_phase = time.perf_counter()
    procs, tmp, cases, jobs = shard_ranks
    # The ranks started up beside phases 5e and 5f; they warm up now,
    # beside the unsharded and the NCCL solves.
    pathlib.Path(tmp, "warm").touch()
    totals = {"al_step": 0, "dr_features": 0}
    solo, solo_launches = {}, {}
    for name, fleet, pol, pkw, ckw, _ in cases:
        policy = getattr(api, pol)(**pkw)
        ctx = api.SolveContext(**ckw)
        counts = dict.fromkeys(totals, 0)
        solo[name], wall = count_launches(
            torch, counts, "shard 5g", name,
            lambda: api.solve(fleet, policy, ctx=ctx))
        solo_launches[name] = counts
        for k in totals:
            totals[k] += counts[k]
        r = solo[name]
        rounds = f", rounds {_cr3_rounds(r, SHARD_CR3_STEPS, 3)}, rho " \
            f"{r.extras['rho']:.6g}" if "rho" in r.extras else ""
        log(f"[shard 5g] {name} unsharded: carbon "
            f"{r.carbon_reduction_pct:.4f} %, penalty "
            f"{r.total_penalty_pct:.4f} %, wall {wall:.4f} s, launches "
            f"{counts}{rounds}")
    pair = {k: solo_launches["cr1"][k] + solo_launches["cr2"][k]
            for k in totals}
    want_pair = {"al_step": 600 // 8 + 6 * (400 // 8),
                 "dr_features": 1 + (1 + 6 + 1)}
    require(pair == want_pair,
            f"shard 5g: unsharded CR1 + CR2 launches {pair} != "
            f"{want_pair}")
    solo_jobs = {}
    for job in jobs:
        n0 = DAY_GRAPHS.captures
        for label, *got in _shard_job(np, torch, job, None):
            solo_jobs[label] = tuple(got)
            for k in totals:
                totals[k] += got[1][k]
            log(f"[shard 5g] {label} unsharded: carbon "
                f"{got[0]['carbon'].round(4).tolist()} %, wall "
                f"{got[2]:.4f} s, launches {got[1]}")
        # A day's first call captures, as each rank's does.
        require(job[1] != "day" or DAY_GRAPHS.captures == n0 + 1,
                f"shard 5g {job[0]}: the unsharded day did not capture")

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl"), 1), rank=0, world_size=1)
    try:
        # One rank: the regional cases take the 1-D mesh too.
        mesh = {None: make_fleet_mesh(), 3: make_fleet_mesh()}
        nccl = _shard_solves(np, torch, cases, mesh, keep_D=True)
        nccl_jobs = [(job[1], label, tuple(got)) for job in jobs
                     for label, *got in _shard_job(np, torch, job,
                                                   mesh[job[-1]])]
    finally:
        dist.destroy_process_group()
    for kind, label, got in nccl_jobs:
        for k in totals:
            totals[k] += got[1][k]
        _job_check(np, "shard 5g nccl x1", label, kind, got,
                   solo_jobs[label], W_MAIN, bitwise=True)
        _job_log(np, "NCCL world 1", label, got, solo_jobs[label])
    for name, fleet, *_ in cases:
        got = nccl[name]
        for k in totals:
            totals[k] += got[1][k]
        _shard_check(np, "shard 5g nccl x1", name, got, solo[name],
                     solo_launches[name], fleet.W, fleet.W)
        dD = float(np.abs(got[0]["D"] - solo[name].D).max())
        log(f"[shard 5g] {name} NCCL world 1: max |dD| {dD:.3e} NP, "
            f"bitwise {np.array_equal(got[0]['D'], solo[name].D)}, "
            f"wall {got[2]:.4f} s, launches {got[1]}")

    pathlib.Path(tmp, "go").touch()
    t_gloo = time.perf_counter()
    while not procs.join(timeout=1.0):
        pass
    gloo_wall = time.perf_counter() - t_gloo
    ranks = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for name, fleet, *_ in cases:
        W_pad = -(-fleet.W // SHARD_RANKS) * SHARD_RANKS
        for r, res in enumerate(ranks):
            _shard_check(np, f"shard 5g gloo rank {r}", name, res[name],
                         solo[name], solo_launches[name], fleet.W, W_pad)
            require(res[name][0]["digest"] == ranks[0][name][0]["digest"],
                    f"shard 5g {name}: rank {r}'s plan differs from rank 0's")
        D = ranks[0][name][0]["D"]
        dD = float(np.abs(D - solo[name].D).max())
        log(f"[shard 5g] {name} gloo x{SHARD_RANKS} on one card (W "
            f"{fleet.W} -> {W_pad}): max |dD| {dD:.3e} NP, bitwise "
            f"{np.array_equal(D, solo[name].D)}, carbon "
            f"{ranks[0][name][0]['carbon']:.4f} %, walls "
            + ", ".join(f"{res[name][2]:.4f}" for res in ranks)
            + f" s, launches a rank {ranks[0][name][1]}")
    W_pad = -(-W_MAIN // SHARD_RANKS) * SHARD_RANKS
    for kind, label, _ in nccl_jobs:
        for r, res in enumerate(ranks):
            _job_check(np, f"shard 5g gloo rank {r}", label, kind,
                       res[label], solo_jobs[label], W_pad, bitwise=False)
            require(res[label][0]["digest"] == ranks[0][label][0]["digest"],
                    f"shard 5g {label}: rank {r} differs from rank 0")
            if label.endswith(" replay"):
                capture = res[label.removesuffix(" replay")][0]
                dD = float(np.abs(res[label][0]["committed"]
                                  - capture["committed"]).max())
                require(dD <= SHARD_REPLAY_NP,
                        f"shard 5g {label}: rank {r}'s replay {dD:.3e} NP "
                        f"from its capture day")
        _job_log(np, f"gloo x{SHARD_RANKS} (walls "
                 + ", ".join(f"{res[label][2]:.4f}" for res in ranks)
                 + " s)", label, ranks[0][label], solo_jobs[label])
    log(f"[shard 5g] gloo ranks' solves {gloo_wall:.2f} s after the go "
        f"signal; CR3 at {SHARD_CR3_STEPS} steps; phase wall "
        f"{time.perf_counter() - t_phase:.2f} s")
    return totals


def phase_rmsnorm(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, rec, other = [], {}, []
    for N, d in RMSNORM_ROWS:
        x = (1.5 * torch.randn((N, d), generator=gen, device=dev)).bfloat16()
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        got = rmsnorm_cuda(x, scale)
        torch.cuda.synchronize()
        # One bf16 ulp of the output, as the JAX package's tests hold the
        # oracle (kernel and plain version sum in f64 and round once, so
        # they agree but for rare rows).
        want = rmsnorm_ref(x, scale)
        errs.append(check_close(torch, got, want, 2.0 ** -7, 1e-6,
                                f"rmsnorm ({N}, {d})"))
        if (N, d) in RMSNORM_TRAIN_ROWS:
            require(torch.equal(got, want),
                    f"rmsnorm ({N}, {d}): not bit for bit the plain version")
        if (N, d) != RMSNORM_ROWS[0]:
            ms = kernel_ms(torch, lambda: rmsnorm_cuda(x, scale), reps=100)
            w = scale.bfloat16()
            lib_ms = kernel_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6),
                               reps=100)
            b_ms, _ = bound(2 * x.numel() * 2 + d * 4, 4 * x.numel(),
                            H100_F32_OPS_PER_S)
            other.append(f"({N}, {d}) kernel {ms * 1e3:.2f} us, F.rms_norm "
                         f"{lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us")
        if (N, d) == RMSNORM_ROWS[0]:
            rec["ms"] = kernel_ms(torch, lambda: rmsnorm_cuda(x, scale),
                                  reps=100)
            rec["plain_ms"] = plain_ms(torch, lambda: rmsnorm_ref(x, scale))
            # The fused library call wants the weight in x's dtype.
            w = scale.bfloat16()
            rec["library_ms"] = kernel_ms(
                torch, lambda: F.rms_norm(x, (d,), w, 1e-6), reps=100)
            rec["bound_ms"], rec["bound_by"] = bound(
                2 * x.numel() * 2 + d * 4, 4 * x.numel(), H100_F32_OPS_PER_S)
    rec["max_abs_err"] = max(errs)
    N, d = RMSNORM_ROWS[0]
    log(f"[check] rmsnorm: max abs err {rec['max_abs_err']:.3e} (rtol 2^-7, "
        f"one bf16 ulp; bit for bit at {RMSNORM_TRAIN_ROWS}) at "
        f"{RMSNORM_ROWS} bf16; at ({N}, {d}): kernel "
        f"{rec['ms'] * 1e3:.2f} us, plain {rec['plain_ms'] * 1e3:.2f} us, "
        f"F.rms_norm {rec['library_ms'] * 1e3:.2f} us, bound "
        f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); "
        + "; ".join(other))
    return rec


def phase_flash_attention(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        bf16_blocks_per_sm, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    errs, rec, other = [], {}, {}
    for n, case in enumerate(FA_CASES):
        B, Sq, Skv, H, KV, Dh, Dv, causal, q_offset, bf16 = case
        q, k, v = fa_inputs(torch, case, seed=n, dev=dev)
        got = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        # bf16: 2e-2 as the JAX package's kernel tests; f32: sums in
        # another order.
        tol = 2e-2 if bf16 else 1e-4
        errs.append(check_close(
            torch, got, attention_ref(q, k, v, causal=causal,
                                      q_offset=q_offset),
            tol, tol, f"flash_attention {case}"))
        if n in (0, FA_LONG) + FA_WHISPER + FA_MLA + FA_JAMBA:
            timed = {"ms": kernel_ms(torch, lambda: flash_attention_cuda(
                q, k, v, causal=causal))}
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            gqa = H != KV

            timed["library_ms"] = kernel_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=gqa))
            timed["sdpa"] = sdpa_backend(torch, qt, kt, vt, causal, gqa)
            pairs = B * H * fa_live_pairs(Sq, Skv, causal, q_offset)
            nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) * 2
            timed["bound_ms"], timed["bound_by"] = bound(
                nbytes, pairs * 2 * (Dh + Dv), H100_BF16_OPS_PER_S)
            if n == 0:
                rec.update(timed)
                rec["plain_ms"] = plain_ms(
                    torch, lambda: attention_ref(q, k, v, causal=causal))
            else:
                other[n] = timed
        del q, k, v, got
    rec["max_abs_err"] = max(errs)
    log(f"[check] flash_attention: {len(FA_CASES)} cases, max abs err "
        f"{rec['max_abs_err']:.3e} (rtol = atol = 2e-2 bf16, 1e-4 f32); at "
        f"{FA_CASES[0]}: kernel {rec['ms'] * 1e3:.2f} us, plain "
        f"{rec['plain_ms'] * 1e3:.2f} us, SDPA {rec['library_ms'] * 1e3:.2f} "
        f"us, bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}, bf16 "
        f"peak)")
    for n, t in other.items():
        log(f"[check] flash_attention at {FA_CASES[n]}: kernel "
            f"{t['ms'] * 1e3:.2f} us, SDPA {t['library_ms'] * 1e3:.2f} us "
            f"({t['sdpa']}), bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_by']})")
    log(f"[check] flash_attention: bf16 kernel blocks per SM at Dh 80: "
        f"{bf16_blocks_per_sm(80, 80)}, at Dh 64: {bf16_blocks_per_sm(64, 64)}"
        f", at Dh 128: {bf16_blocks_per_sm(128, 128)}, at Dh 192 / Dv 128: "
        f"{bf16_blocks_per_sm(192, 128)} "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    return rec


def phase_ssd_scan(torch):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, rec, timed = [], {}, []
    for n, dims in enumerate(SSD_CASES):
        states = torch.randn(dims, generator=gen, device=dev)
        dec = torch.rand(dims[:3], generator=gen, device=dev)   # in (0, 1)
        got = ssd_scan_cuda(states, dec)
        torch.cuda.synchronize()
        want = ssd_scan_ref(states, dec)
        # 1e-5 as the JAX package's tests; the kernel rounds the product
        # and the sum as the plain version does, so they agree exactly.
        errs += [check_close(torch, g, w, 1e-5, 1e-5, f"ssd_scan {dims} {o}")
                 for g, w, o in zip(got, want, ("h_prev", "h_last"))]
        if n >= SSD_TIMED:
            continue
        B, NC, H, P, N = dims
        # Read states and decays once, write h_prev and h_last once; one
        # multiply and one add per state element and chunk.
        nbytes = 4 * (2 * states.numel() + dec.numel() + B * H * P * N)
        b_ms, b_by = bound(nbytes, 2 * states.numel(), H100_F32_OPS_PER_S)
        ms = kernel_ms(torch, lambda: ssd_scan_cuda(states, dec), reps=100)
        pms = plain_ms(torch, lambda: ssd_scan_ref(states, dec))
        timed.append(f"{dims}: kernel {ms * 1e3:.2f} us, plain "
                     f"{pms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
                     f"({b_by}, {nbytes / 1e6:.1f} MB)")
        if n == 0:
            rec.update(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)      # no PyTorch call computes it
    rec["max_abs_err"] = max(errs)
    log(f"[check] ssd_scan: {len(SSD_CASES)} cases, max abs err "
        f"{rec['max_abs_err']:.3e} (rtol = atol = 1e-5); " + "; ".join(timed))
    return rec


def plain_scan_grads(torch, states, dec, h0, g_prev, g_last):
    """(h_prev, [dstates, ddecay(, dh0)]) of the plain forward and
    autograd through it, for the gradients g_prev and g_last (None: not
    passed). An output that no input reaches (h_prev of one chunk from
    zeros) passes nothing; an input no gradient reaches gets zeros."""
    inputs = [t.clone().requires_grad_(True) for t in
              ((states, dec) if h0 is None else (states, dec, h0))]
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    outs = [(o, g) for o, g in zip(ssd_scan_ref(*inputs), (g_prev, g_last))
            if g is not None and o.requires_grad]
    want = torch.autograd.grad([o for o, _ in outs], inputs,
                               [g for _, g in outs], allow_unused=True) \
        if outs else [None] * len(inputs)
    h_prev, _ = ssd_scan_ref(states, dec, h0)
    return h_prev, [torch.zeros_like(x) if w is None else w
                    for w, x in zip(want, inputs)]


def phase_ssd_scan_bwd(torch):
    """The backward kernel against autograd through the plain forward, at
    SSD_BWD_CASES; the first SSD_BWD_TIMED timed beside the plain
    backward (`ssd_scan_bwd_ref`) with h0 None and g_last None, as
    `ssm_apply` calls it."""
    from repro_torch.kernels.ssd_scan.kernel import (bwd_blocks,
                                                     ssd_scan_bwd_cuda,
                                                     ssd_scan_cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs, rec, timed, n_checks = [0.0], {}, [], 0
    for n, dims in enumerate(SSD_BWD_CASES):
        B, NC, H, P, N = dims
        states = torch.randn(dims, generator=gen, device=dev)
        dec = torch.rand(dims[:3], generator=gen, device=dev)
        h0 = torch.randn((B, H, P, N), generator=gen, device=dev)
        g_prev = torch.randn(dims, generator=gen, device=dev)
        g_last = torch.randn((B, H, P, N), generator=gen, device=dev)
        for with_h0 in (False, True):
            for last in (False, True):
                h_prev, want = plain_scan_grads(
                    torch, states, dec, h0 if with_h0 else None, g_prev,
                    g_last if last else None)
                hp, _ = ssd_scan_cuda(states, dec, h0 if with_h0 else None)
                require(torch.equal(hp, h_prev),
                        f"ssd_scan {dims}: the forward's h_prev")
                got = ssd_scan_bwd_cuda(g_prev, g_last if last else None,
                                        dec, hp, with_h0)
                torch.cuda.synchronize()
                what = (f"ssd_scan_bwd {dims} h0 {with_h0} g_last "
                        f"{'given' if last else 'None'}")
                require(torch.equal(got[0], want[0]),
                        f"{what}: dstates not bitwise autograd's")
                if with_h0:
                    require(torch.equal(got[2], want[2]),
                            f"{what}: dh0 not bitwise autograd's")
                else:
                    require(got[2] is None, f"{what}: a dh0 without h0")
                rel = _rel_l2(torch, got[1], want[1])
                require(rel < SSD_DECAY_REL_L2,
                        f"{what}: ddecay relative L2 {rel:.3e}")
                errs.append(float((got[1] - want[1]).abs().max()))
                n_checks += 1
        if n >= SSD_BWD_TIMED:
            continue
        hp, _ = ssd_scan_cuda(states, dec)
        # What the function must move: read g_prev, h_prev and the decays
        # once, write dstates and the decay gradient once (the kernel's
        # per-block partial sums are its own design's cost, not counted).
        # A multiply and an add for the carry, a multiply and an add for
        # the decay gradient, per element and chunk.
        nblk = bwd_blocks(P * N, True)
        nbytes = 4 * (3 * states.numel() + 2 * dec.numel())
        b_ms, b_by = bound(nbytes, 4 * states.numel(), H100_F32_OPS_PER_S)
        ms = kernel_ms(torch, lambda: ssd_scan_bwd_cuda(g_prev, None, dec,
                                                        hp, False), reps=100)
        pms = plain_ms(torch, lambda: ssd_scan_bwd_ref(g_prev, None, dec,
                                                       hp, False))
        timed.append(f"{dims}: kernel {ms * 1e3:.2f} us, plain "
                     f"{pms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
                     f"({b_by}, {nbytes / 1e6:.1f} MB, {nblk} blocks "
                     f"along P·N)")
        if n == 0:
            rec.update(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)      # no PyTorch call computes it
    rec["max_abs_err"] = max(errs)
    log(f"[check] ssd_scan_bwd: {n_checks} checks at {len(SSD_BWD_CASES)} "
        f"shapes against autograd through the plain version: dstates and "
        f"dh0 bitwise, ddecay within relative L2 {SSD_DECAY_REL_L2:g} (max "
        f"abs err {rec['max_abs_err']:.3e}); " + "; ".join(timed))
    return rec


def expected_serve_launches(cfg, requests, prompt, new):
    """Launches of each serving kernel at both admission limits: per batch
    one forward and prompt + new - 1 decode steps, each with one RMSNorm
    per layer (ln1), one more for a layer with an FFN (ln2) or a Mamba-2
    mixer (its gated norm), two more for an attention layer with qk-norm
    (q and k) or MLA (its q and kv latents), and ln_f; flash attention
    once per attention layer (GQA or MLA) of the forward and ssd_scan once
    per Mamba-2 layer (`ArchConfig.layer_kind`): 2L + 1 for the dense, moe
    and ssm families, 4L + 1 with qk-norm or MLA, 2L + L_ssm + 1 for the
    hybrid."""
    batches = sum(-(-requests // mb) for mb in SERVE_BATCHES)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    attn = sum(m in ("attn", "mla") for m, _ in kinds)
    ssm = sum(m == "ssm" for m, _ in kinds)
    norms = 1 + sum(1 + (m == "ssm") + (f != "none")
                    + (2 if m in ("attn", "mla") and (cfg.qk_norm or cfg.mla)
                       else 0) for m, f in kinds)
    return {"rmsnorm": norms * (1 + prompt + new - 1) * batches,
            "flash_attention": attn * batches,
            "ssd_scan": ssm * batches}


def phase_serve(np, torch, arch, requests, prompt, new, max_len,
                param_dtype, cut=None, after=None, check=None):
    """One model at full width through `serve_requests`, the path a user
    calls; the kernels' launch counts are reset just before and read just
    after. `cut` replaces config fields (a depth cut, named in the log);
    `after(cfg, params)` runs last, on the bf16 parameters. The prefill
    logits check runs on the first max_batch prompts, or on seeded tokens
    of the shape `check` (B, S). An MoE model's prefill check reports its
    routing (`_moe_prefill_check`) and holds its scatter dispatch against
    the einsum one on its first MoE layer. Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    wall0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, param_dtype=param_dtype, **(cut or {}))
    t0 = time.perf_counter()
    masters = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(masters))
    size = sum(t.numel() * t.element_size() for t in _leaves(masters))
    copy = ("" if param_dtype == cfg.dtype
            else f" + one {cfg.dtype} copy per batch")
    mixer = (f"MLA (ranks {cfg.mla.q_lora_rank} / {cfg.mla.kv_lora_rank}, "
             f"q/k {cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim}, v "
             f"{cfg.mla.v_head_dim})" if cfg.mla else
             f"{cfg.num_kv_heads} kv heads of {cfg.dh}, qk-norm "
             f"{cfg.qk_norm}")
    e = cfg.moe
    ffn = (f"; {e.num_experts} experts top-{e.top_k} of {e.d_expert_ff} + "
           f"{e.num_shared} shared, capacity factor {e.capacity_factor}, "
           f"{e.dispatch} dispatch" if e else "")
    cuts = "".join(f"; cut: {k} {getattr(full, k)} -> {v}"
                   for k, v in (cut or {}).items())
    log(f"[serve] {cfg.name} ({cfg.family}): {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads, {mixer}{ffn}, vocab "
        f"{cfg.vocab_size}; {n_params} parameters, {param_dtype} "
        f"{size / 2**30:.2f} GiB{copy}, drawn in "
        f"{time.perf_counter() - t0:.2f} s{cuts}")
    require(n_params == cfg.param_count(), "parameter count")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt),
                           dtype=np.int64).astype(np.int32)
    serve.greedy_decode(masters, cfg, prompts[:2, :8], 2, 10)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels = {"rmsnorm": rmsnorm_cuda,
               "flash_attention": flash_attention_cuda,
               "ssd_scan": ssd_scan_cuda}
    for fn in kernels.values():
        fn.launches = 0
    runs = {}
    for mb in SERVE_BATCHES:
        reqs = [serve.Request(rid=i, prompt=prompts[i], max_new=new)
                for i in range(requests)]
        stats = serve.serve_requests(masters, cfg, reqs, max_batch=mb,
                                     max_len=max_len)
        runs[mb] = (stats, reqs)
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want = expected_serve_launches(cfg, requests, prompt, new)
    qk = (" + 2L qk-norm" if cfg.qk_norm else
          " + 2L MLA latent norms" if cfg.mla else "")
    if cfg.family == "hybrid":
        qk = " + L_ssm gated norms"
    log(f"[serve] {arch}: launches on the serving path: {launches} "
        f"(expected {want}: rmsnorm (2L+1{qk}) x (1 forward + {prompt} "
        f"replayed + {new - 1} decode steps), flash_attention per attention "
        f"layer and ssd_scan per Mamba-2 layer of each prefill, "
        f"{sum(-(-requests // mb) for mb in SERVE_BATCHES)} batches)")
    require(launches == want, f"{arch} serving launches {launches} != {want}")
    for mb, (stats, reqs) in runs.items():
        for r in reqs:
            require(len(r.tokens) == new
                    and all(0 <= t < cfg.vocab_size for t in r.tokens),
                    f"{arch} request {r.rid} at max_batch {mb}: bad tokens")
        require(bool(np.isfinite(stats.latencies_s).all()),
                "latencies not finite")
        log(f"[serve] {arch} max_batch {mb}: p50 {stats.p(50):.4f} s, p95 "
            f"{stats.p(95):.4f} s, {stats.throughput_tok_s:.2f} tokens/s")
    same = sum(a.tokens == b.tokens for a, b in
               zip(*(runs[mb][1] for mb in SERVE_BATCHES)))
    log(f"[serve] {arch}: {same} of {requests} requests give the same "
        f"tokens at max_batch {SERVE_BATCHES[0]} and {SERVE_BATCHES[1]} "
        f"(bf16 products depend on the batch: reported, not required); "
        f"peak memory {peak / 2**30:.2f} GiB")

    params = tf.compute_params(masters, cfg)
    del masters
    toks = torch.as_tensor(prompts[:SERVE_BATCHES[0]], dtype=torch.long,
                           device="cuda")
    ctoks = toks if check is None else torch.randint(
        0, cfg.vocab_size, check, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(4))
    if cfg.moe is not None:
        _moe_prefill_check(torch, cfg, params, ctoks)
        _dispatch_check(torch, cfg, params, toks)
    else:
        kern = tf.forward(params, cfg, {"tokens": ctoks})
        plain = tf.forward(params, cfg, {"tokens": ctoks}, use_kernel=False)
        require(tuple(kern.shape) == tuple(ctoks.shape) + (cfg.vocab_size,)
                and bool(torch.isfinite(kern).all()),
                f"{arch} prefill logits not finite or of the wrong shape")
        rel, top1 = _agreement(torch, kern, plain)
        log(f"[serve] {arch} prefill logits, kernel vs plain path: relative "
            f"error {rel:.3e} (bound {LOGITS_REL_TOL}), top-1 agreement "
            f"{top1:.4f} (bound {TOP1_MIN})")
        require(rel < LOGITS_REL_TOL and top1 >= TOP1_MIN,
                f"{arch} prefill logits: kernel path too far from the plain "
                f"path")
        del kern, plain

    def wall_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    cache = tf.init_cache(cfg, SERVE_BATCHES[0], max_len)
    step = toks[:, :1]
    pre = wall_ms(lambda: tf.forward(params, cfg, {"tokens": toks}))
    dec = wall_ms(lambda: tf.decode_step(params, cfg, cache, step, prompt))
    idle = ""
    if cfg.moe is not None:
        wall, busy, top = _device_breakdown(
            torch, lambda: tf.decode_step(params, cfg, cache, step, prompt),
            top=3)
        idle = (f"; a profiled decode step: wall {wall * 1e3:.3f} ms, device "
                f"busy {busy * 1e3:.3f} ms, idle share "
                f"{1 - busy / wall:.4f}, top kernels "
                + ", ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, ms, n in top))
    log(f"[serve] {arch}: prefill of {SERVE_BATCHES[0]} x {prompt} tokens "
        f"{pre:.3f} ms; decode step at batch {SERVE_BATCHES[0]}, {prompt} "
        f"cached, {dec:.3f} ms (host clock, median of 5){idle}")
    del cache
    if after is not None:
        after(cfg, params)
    log(f"[serve] {arch}: phase wall {time.perf_counter() - wall0:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 6d: mixture of experts and multi-head latent attention
# ---------------------------------------------------------------------------
def _route(torch, records, replay=None):
    """Wrap the port's `moe._router` so that each call appends its expert
    ids (G, gs, k) to `records`; with `replay` (another run's records),
    call i takes replay[i]'s ids, weighted by its own probabilities at
    them, so that positions and drops follow those ids. Returns the undo.
    The package has no such option: this is the check's own wrapper."""
    from repro_torch.models import moe
    orig, calls = moe._router, None if replay is None else iter(replay)

    def routed(p, x, e):
        if calls is None:
            weights, ids = orig(p, x, e)
        else:
            ids = next(calls)
            probs = torch.softmax(x.float() @ p["router"]["w"].float(), -1)
            weights = probs.gather(-1, ids)
            weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
        records.append(ids)
        return weights, ids

    moe._router = routed
    return lambda: setattr(moe, "_router", orig)


def _moe_layers(cfg):
    return [i for i in range(cfg.num_layers)
            if cfg.layer_kind(i)[1] == "moe"]


def _tag(cfg):
    return "[hybrid 6e]" if cfg.family == "hybrid" else "[moe 6d]"


def _routed_forward(torch, cfg, params, toks, use_kernel, replay=None):
    from repro_torch.models import transformer as tf
    records = []
    undo = _route(torch, records, replay)
    try:
        out = tf.forward(params, cfg, {"tokens": toks}, use_kernel=use_kernel)
    finally:
        undo()
    n_moe = len(_moe_layers(cfg))
    require(len(records) == n_moe,
            f"{cfg.name}: {len(records)} routings, {n_moe} MoE layers")
    return out, records


def _moe_prefill_check(torch, cfg, params, toks):
    """Prefill logits through the kernels against the plain versions, with
    free routing, at LOGITS_REL_TOL and TOP1_MIN. Over many layers of
    random weights a rounding difference can flip a token's k-th expert,
    which moves that token's output far more than rounding does: if the
    free check misses and some (token, layer) expert set differs, the
    plain path runs again with the kernel path's expert ids replayed into
    it (`_route`), and that run must hold at the same bounds. Logs the
    share of (token, layer) expert sets the two paths agree on and the
    share of slots the config's capacity factor drops."""
    from repro_torch.models import moe
    e = cfg.moe
    kern, k_ids = _routed_forward(torch, cfg, params, toks, None)
    plain, p_ids = _routed_forward(torch, cfg, params, toks, False)
    require(tuple(kern.shape) == tuple(toks.shape) + (cfg.vocab_size,)
            and bool(torch.isfinite(kern).all()),
            f"{cfg.name} prefill logits not finite or of the wrong shape")
    sets = sum(ids.numel() // e.top_k for ids in k_ids)
    same = sum(int((a.sort(-1).values == b.sort(-1).values).all(-1).sum())
               for a, b in zip(k_ids, p_ids))
    slots = sum(ids.numel() for ids in k_ids)
    dropped = sum(int((moe._positions(ids, e.num_experts)
                       >= moe._capacity(ids.shape[1], e)).sum())
                  for ids in k_ids)
    rel, top1 = _agreement(torch, kern, plain)
    log(f"{_tag(cfg)} {cfg.name} prefill of {tuple(toks.shape)}, kernel vs "
        f"plain path, free routing: relative L2 {rel:.3e} (bound "
        f"{LOGITS_REL_TOL}), top-1 agreement {top1:.4f} (bound {TOP1_MIN}); "
        f"expert sets that agree {same} of {sets} (token, layer) pairs "
        f"({same / sets:.6f}, flip share {1 - same / sets:.6f}); capacity "
        f"factor {e.capacity_factor} drops {dropped} of {slots} slots "
        f"({dropped / slots:.6f}) on the kernel path")
    free_ok = rel < LOGITS_REL_TOL and top1 >= TOP1_MIN
    require(free_ok or same < sets, f"{cfg.name} prefill logits: kernel "
            f"path too far from the plain path with every expert set "
            f"agreeing")
    del plain
    # Reported always; required only where free routing missed.
    pinned, _ = _routed_forward(torch, cfg, params, toks, False,
                                replay=k_ids)
    rel, top1 = _agreement(torch, kern, pinned)
    log(f"{_tag(cfg)} {cfg.name} prefill, the plain path on the kernel path's "
        f"expert ids: relative L2 {rel:.3e} (bound {LOGITS_REL_TOL}), top-1 "
        f"agreement {top1:.4f} (bound {TOP1_MIN}); "
        f"{'reported' if free_ok else 'required: free routing missed'}")
    require(free_ok or (rel < LOGITS_REL_TOL and top1 >= TOP1_MIN),
            f"{cfg.name} prefill logits: kernel path too far from the plain "
            f"path on the same routing")


def _dispatch_check(torch, cfg, params, toks):
    """The first MoE layer's FFN at full width on one bf16 input of the
    prefill's shape: the scatter dispatch against the einsum one
    (relative L2 within DISPATCH_REL_TOL; the slots the capacity drops
    reported), both timed there and at a decode batch."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    first = _moe_layers(cfg)[0]
    G = cfg.block_group_size()
    p = tf._layer(params["blocks"][f"l{first % G}"], first // G)["moe"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    sc = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          dispatch="scatter"))
    ec = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          dispatch="einsum"))
    times = []
    for shape in (tuple(toks.shape), (toks.shape[0], 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen,
                        device="cuda").bfloat16()
        ein, sca = moe.moe_apply(p, x, ec), moe.moe_apply(p, x, sc)
        rel = _rel_l2(torch, sca, ein)
        require(rel < DISPATCH_REL_TOL,
                f"{cfg.name} layer {first} at {shape}: scatter vs einsum "
                f"dispatch relative L2 {rel:.3e} (bound {DISPATCH_REL_TOL})")
        xg, _, gs = moe._group(x, moe.GROUP_SIZE)
        ids = moe._router(p, xg, cfg.moe)[1]
        drops = int((moe._positions(ids, cfg.moe.num_experts)
                     >= moe._capacity(gs, cfg.moe)).sum())
        times.append(f"{shape}: relative L2 {rel:.3e}, {drops} slots "
                     f"dropped; einsum "
                     f"{plain_ms(torch, lambda: moe.moe_apply(p, x, ec)):.3f}"
                     f" ms, scatter "
                     f"{plain_ms(torch, lambda: moe.moe_apply(p, x, sc)):.3f}"
                     f" ms")
    log(f"{_tag(cfg)} {cfg.name} layer {first}'s MoE FFN, scatter vs einsum "
        f"dispatch (bound {DISPATCH_REL_TOL:.4g}; CUDA events): "
        + "; ".join(times))


def _decode_check(torch, cfg, params, required=True):
    """Greedy decode over the model's cache (a 4-token prompt replayed,
    then greedy tokens, DEEPSEEK_DECODE steps in all) against the
    teacher-forced forward over the same tokens, at capacity factor
    DECODE_CF: relative L2 < LOGITS_REL_TOL and top-1 >= TOP1_MIN, as
    phase 6b holds whisper's decode, where `required`; reported where
    not. The forward is also run on the decode steps' expert ids
    (`_route`: step t's ids of batch row b are the forward's token
    (b, t)) and reported, which tells a routing flip from rounding.
    deepseek's cache is MLA's latent one, jamba's mixed: k/v in its
    attention layers, the SSM state and conv tail in the others."""
    from repro_torch.models import transformer as tf
    c8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DECODE_CF))
    B, T = SERVE_BATCHES[0], DEEPSEEK_DECODE
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = list(torch.randint(0, cfg.vocab_size, (B, 4), generator=gen,
                              device="cuda").unbind(1))
    cache = tf.init_cache(c8, B, T, device="cuda")
    steps, ids = [], []
    undo = _route(torch, ids)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            out, cache = tf.decode_step(params, c8, cache, toks[t][:, None],
                                        t)
            steps.append(out)
            if t + 1 == len(toks):
                toks.append(out[:, -1].argmax(-1))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T
    finally:
        undo()
    seq = torch.stack(toks[:T], dim=1)
    fwd = tf.forward(params, c8, {"tokens": seq})
    got = torch.cat(steps, dim=1)
    require(bool(torch.isfinite(got).all()),
            f"{cfg.name} decode logits not finite")
    rel, top1 = _agreement(torch, got, fwd)
    # Step t's (1, B, k) ids of MoE layer m, as the forward's one group of
    # B·T tokens in (b, t) order.
    M = len(_moe_layers(cfg))
    replay = [torch.stack([ids[t * M + m][0] for t in range(T)], dim=1)
              .reshape(1, B * T, -1) for m in range(M)]
    pinned, _ = _routed_forward(torch, c8, params, seq, None, replay=replay)
    rel_p, top1_p = _agreement(torch, got, pinned)
    kinds = {}
    for pos, leaves in cache.items():
        kinds.setdefault(tuple(leaves), (pos, leaves))
    shapes = "; ".join(f"{pos}: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in leaves.items())
        for pos, leaves in kinds.values())
    log(f"{_tag(cfg)} {cfg.name} ({cfg.num_layers} layers, "
        f"{cfg.moe.num_experts} experts, {cfg.dtype}) "
        f"greedy decode over its cache ({shapes}), {T} steps at batch {B}, "
        f"capacity factor {DECODE_CF}: {ms:.3f} ms a step (host clock); "
        f"against the teacher-forced forward: relative L2 {rel:.3e} (bound "
        f"{LOGITS_REL_TOL}), top-1 agreement {top1:.4f} (bound {TOP1_MIN}); "
        f"against the forward on the decode's expert ids: {rel_p:.3e}, "
        f"{top1_p:.4f}; {'required' if required else 'reported'}")
    require(not required or (rel < LOGITS_REL_TOL and top1 >= TOP1_MIN),
            f"{cfg.name} decode too far from the teacher-forced forward")


def phase_moe_mla(np, torch):
    """6d: qwen3-moe-30b-a3b at full width and depth (SERVE_PATHS
    [MOE_SERVE]) and deepseek-v3-671b at full width and DEEPSEEK_LAYERS
    layers without its MTP head, bf16 parameters, one resident at a time,
    each through `phase_serve` (serving at both admission limits with its
    launches by counter, the prefill with its routing report, the two
    dispatches on layer 0, a profiled decode step); then deepseek's
    decode over the latent cache against its forward. Returns the
    launches."""
    launches = {}
    runs = ((SERVE_PATHS[MOE_SERVE], None, None),
            (DEEPSEEK, {"num_layers": DEEPSEEK_LAYERS, "mtp_depth": 0},
             lambda cfg, params: _decode_check(torch, cfg, params)))
    for path, cut, after in runs:
        for name, n in phase_serve(np, torch, *path, cut=cut,
                                   after=after).items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()        # one model resident at a time
    return launches


def _long_prefill(torch, cfg, params, shape):
    """One timed prefill of `shape` (B, S) tokens through the kernels:
    its wall to a sync (the second of two calls), peak memory, finite
    logits of the right shape, and beside them the cell's analytic FLOPs
    and HBM bytes (`launch/analytics.analytic_record`): its share of the
    card's bf16 peak and of its roofline bound, the larger of the FLOPs
    at that peak and the bytes at the HBM rate."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import analytics
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, shape, device="cuda",
                         generator=gen)
    cell = ShapeCell(f"prefill_{shape[1]}", shape[1], shape[0], "prefill")
    rec = analytics.analytic_record(cfg, cell, chips=1)
    flops, nbytes = rec["flops"], rec["hbm_bytes_per_device"]
    b_ms, b_by = bound(nbytes, flops, H100_BF16_OPS_PER_S)
    tf.forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tf.forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    require(tuple(out.shape) == tuple(shape) + (cfg.vocab_size,)
            and bool(torch.isfinite(out).all()),
            f"{cfg.name} {shape} prefill logits not finite or of the wrong "
            f"shape")
    share = flops / (ms * 1e-3) / H100_BF16_OPS_PER_S
    log(f"{_tag(cfg)} {cfg.name} prefill of {shape} tokens: {ms:.3f} ms "
        f"(host clock to a sync, second call), peak memory "
        f"{peak / 2**30:.2f} GiB; analytic forward {flops:.6e} FLOP and "
        f"{nbytes:.6e} HBM bytes (launch/analytics.py; "
        f"{rec['active_param_count']} of {rec['param_count']} parameters "
        f"active a token), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{share:.4f} of the bf16 peak ({H100_BF16_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s); roofline bound {b_ms:.3f} ms ({b_by}), "
        f"{b_ms / ms:.4f} of it")
    del out


def phase_hybrid(np, torch):
    """6e: jamba-v0.1-52b at full width and JAMBA_LAYERS layers, bf16
    parameters, through `phase_serve` (serving at both admission limits
    with its launches by counter, a profiled decode step; the prefill
    logits through the kernels against the plain versions on
    JAMBA_PREFILL tokens with its routing report; the two dispatches on
    its first MoE layer); its greedy decode over the mixed cache against
    the forward, reported; one timed JAMBA_LONG prefill. Then, with that
    model freed, the decode check the run requires, in float32 at full
    width on each JAMBA_F32 model (layers, experts), one resident at a
    time. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()

    def after(cfg, params):
        _decode_check(torch, cfg, params, required=False)
        _long_prefill(torch, cfg, params, JAMBA_LONG)

    launches = phase_serve(np, torch, *JAMBA,
                           cut={"num_layers": JAMBA_LAYERS}, after=after,
                           check=JAMBA_PREFILL)
    torch.cuda.empty_cache()
    full = get_config(JAMBA[0])
    for layers, experts in JAMBA_F32:
        cfg = dataclasses.replace(
            full, num_layers=layers, param_dtype="float32", dtype="float32",
            moe=dataclasses.replace(full.moe, num_experts=experts))
        params = tf.init_params(cfg, seed=0, device="cuda")
        _decode_check(torch, cfg, params)
        del params
        torch.cuda.empty_cache()
    log(f"[hybrid 6e] phase wall {time.perf_counter() - t0:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# Phases 6b and 6c: the encoder-decoder and the other dense options
# ---------------------------------------------------------------------------
def _agreement(torch, got, want):
    """(relative L2, share of positions whose top-1 token agrees)."""
    return (_rel_l2(torch, got, want),
            float((got.argmax(-1) == want.argmax(-1)).float().mean()))


def _counter(torch, totals, names=("rmsnorm", "flash_attention")):
    """`counted(fn)` -> (fn(), launches of each kernel of `names` in it,
    host ms to a sync): each count reset just before and read just after,
    and added to `totals`."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_bwd_cuda,
                                                     ssd_scan_cuda)
    kernels = {"rmsnorm": rmsnorm_cuda,
               "flash_attention": flash_attention_cuda,
               "ssd_scan": ssd_scan_cuda, "ssd_scan_bwd": ssd_scan_bwd_cuda}
    kernels = {n: kernels[n] for n in names}

    def counted(fn):
        torch.cuda.synchronize()
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {n: f.launches for n, f in kernels.items()}
        for n in got:
            totals[n] = totals.get(n, 0) + got[n]
        return out, got, ms

    return counted


def phase_whisper(np, torch):
    """6b: whisper-large-v3 at full width and depth through `encode`,
    `start_cache` and greedy `decode_step`s, the path of the reference's
    own decode test; each run's launches reset just before and read just
    after. The steps' logits against the teacher-forced `forward` over
    the same tokens, and `encode` and `forward` through the kernels
    against the plain versions. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf

    wall0 = time.perf_counter()
    totals = {}
    counted = _counter(torch, totals)
    cfg = get_config("whisper-large-v3")
    Le, L = cfg.encoder_layers, cfg.num_layers
    B, P, M = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_LEN
    dev = torch.device("cuda")
    masters = encdec.init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in _leaves(masters))
    require(n_params == cfg.param_count() == WHISPER_PARAMS,
            f"whisper parameters {n_params}")
    params = tf.compute_params(masters, cfg)
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    log(f"[whisper 6b] {cfg.name}: {Le} + {L} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.dh}, vocab {cfg.vocab_size}; "
        f"{n_params} parameters, f32 masters "
        f"{n_params * 4 / 2**30:.2f} GiB + one {cfg.dtype} copy; frames "
        f"({B}, {cfg.encoder_seq}, {cfg.d_model}), a {P}-token prompt, "
        f"max_len {M}")
    encdec.encode(params, cfg, frames[:1, :64])              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    enc, got, enc_ms = counted(lambda: encdec.encode(params, cfg, frames))
    want = {"rmsnorm": 2 * Le + 1, "flash_attention": Le}
    require(got == want, f"encode launches {got} != {want}")
    cache, got, start_ms = counted(
        lambda: encdec.start_cache(params, cfg, enc, B, M))
    require(got == {"rmsnorm": 0, "flash_attention": 0},
            f"start_cache launches {got}")
    cross = sum(cache[k].numel() * cache[k].element_size()
                for k in ("enc_k", "enc_v"))

    def generate():
        fed, logits = [prompt[:, t] for t in range(P)], []
        for t in range(M):
            lg, _ = encdec.decode_step(params, cfg, cache, fed[t][:, None],
                                       t)
            logits.append(lg[:, 0])
            if P <= t + 1 < M:
                fed.append(lg[:, 0].argmax(-1))
        return torch.stack(fed, 1), torch.stack(logits, 1)

    (fed, stepped), got, dec_ms = counted(generate)
    want = {"rmsnorm": (3 * L + 1) * M, "flash_attention": 0}
    require(got == want, f"decode_step launches {got} != {want} ({M} "
            f"steps of 3L + 1 norms, decode_attention plain)")
    require(bool(torch.isfinite(stepped).all()), "decode logits not finite")
    full, got, fwd_ms = counted(lambda: encdec.forward(
        params, cfg, {"frames": frames, "tokens": fed}))
    want = {"rmsnorm": 2 * Le + 1 + 3 * L + 1,
            "flash_attention": Le + 2 * L}
    require(got == want, f"forward launches {got} != {want}")
    peak = torch.cuda.max_memory_allocated()
    rel, top1 = _agreement(torch, stepped, full)
    log(f"[whisper 6b] encode {enc_ms:.2f} ms ({B} x {cfg.encoder_seq} "
        f"frames, launches rmsnorm {2 * Le + 1}, flash_attention {Le}); "
        f"start_cache {start_ms:.2f} ms (cross k/v "
        f"{cross / 2**30:.2f} GiB); {M} decode steps ({P} prompt, "
        f"{M - P} greedy) {dec_ms:.1f} ms, {dec_ms / M:.3f} ms a step, "
        f"{B * M / dec_ms * 1e3:.1f} tokens/s, {3 * L + 1} rmsnorm and no "
        f"flash_attention a step; teacher-forced forward {fwd_ms:.2f} ms "
        f"(launches {got}); peak memory {peak / 2**30:.2f} GiB (host "
        f"clock to a sync)")
    log(f"[whisper 6b] decode steps vs the teacher-forced forward: "
        f"relative L2 {rel:.3e} (bound {LOGITS_REL_TOL}), top-1 agreement "
        f"{top1:.4f} (bound {TOP1_MIN})")
    require(rel < LOGITS_REL_TOL and top1 >= TOP1_MIN,
            "whisper decode steps too far from the forward")
    enc_plain = encdec.encode(params, cfg, frames, use_kernel=False)
    enc_rel = _rel_l2(torch, enc, enc_plain)
    del enc_plain
    plain = encdec.forward(params, cfg, {"frames": frames, "tokens": fed},
                           use_kernel=False)
    rel, top1 = _agreement(torch, full, plain)
    log(f"[whisper 6b] kernels vs plain: encoder output relative L2 "
        f"{enc_rel:.3e}; forward logits relative L2 {rel:.3e}, top-1 "
        f"agreement {top1:.4f} (bounds {LOGITS_REL_TOL}, {TOP1_MIN})")
    require(enc_rel < LOGITS_REL_TOL and rel < LOGITS_REL_TOL
            and top1 >= TOP1_MIN, "whisper kernel path too far from plain")
    del plain, full, stepped
    last = fed[:, -1:]
    wall, busy, top = _device_breakdown(
        torch, lambda: encdec.decode_step(params, cfg, cache, last, M - 1))
    log(f"[whisper 6b] profiled decode step at batch {B}: wall "
        f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.4f}; top kernels: "
        + "; ".join(f"{n[:50]} {ms:.3f} ms x {c}" for n, ms, c in top[:5]))
    log(f"[whisper 6b] phase wall {time.perf_counter() - wall0:.2f} s")
    return totals


def _fill_qkv_biases(torch, params, gen):
    """0.02·N(0, 1) in every qkv bias, in place: the reference initialises
    them to zeros, which would leave the bias path unexercised."""
    attn = params["blocks"]["l0"]["attn"]
    for w in ("wq", "wk", "wv"):
        b = attn[w]["b"]
        b.copy_(0.02 * torch.randn(b.shape, generator=gen, device=b.device))


def phase_dense_options(np, torch):
    """6c: the dense options at full width and OPTION_LAYERS layers, bf16
    parameters, one model resident at a time: qwen1.5-110b's qkv biases
    and qwen2-vl-72b's vlm prefill with M-RoPE (prefill logits through the
    kernels against the plain versions), then granite-20b's int8 KV cache
    against its bf16 cache over KV_QUANT_STEPS decode steps (reported, not
    required). Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    wall0 = time.perf_counter()
    totals = {}
    counted = _counter(torch, totals)
    dev = torch.device("cuda")
    Bo, So, Lo = OPTION_BATCH, OPTION_SEQ, OPTION_LAYERS

    def model(arch, **change):
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=Lo,
                                  param_dtype="bfloat16", **change)
        params = tf.init_params(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(len(arch))
        if cfg.qkv_bias:
            _fill_qkv_biases(torch, params, gen)
        n = sum(t.numel() for t in _leaves(params))
        log(f"[options 6c] {arch}: full width (d {cfg.d_model}, {cfg.num_heads}"
            f" heads over {cfg.num_kv_heads} of {cfg.dh}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab_size}), {Lo} of {full.num_layers} layers, "
            f"{n} parameters in bf16 ({n * 2 / 2**30:.2f} GiB), qkv biases "
            f"{'filled' if cfg.qkv_bias else 'none'}")
        return cfg, params, gen

    def prefill_check(arch, cfg, params, batch, S_total):
        kern, got, ms = counted(lambda: tf.forward(params, cfg, batch))
        want = {"rmsnorm": 2 * Lo + 1, "flash_attention": Lo}
        require(got == want, f"{arch} prefill launches {got} != {want}")
        require(tuple(kern.shape) == (Bo, S_total, cfg.vocab_size)
                and bool(torch.isfinite(kern).all()),
                f"{arch} prefill logits not finite or of the wrong shape")
        plain = tf.forward(params, cfg, batch, use_kernel=False)
        rel, top1 = _agreement(torch, kern, plain)
        log(f"[options 6c] {arch} prefill of {Bo} x {S_total}: {ms:.2f} ms, "
            f"launches {got}; kernels vs plain: relative L2 {rel:.3e} "
            f"(bound {LOGITS_REL_TOL}), top-1 agreement {top1:.4f} (bound "
            f"{TOP1_MIN})")
        require(rel < LOGITS_REL_TOL and top1 >= TOP1_MIN,
                f"{arch} prefill logits: kernel path too far from plain")
        return kern

    # qwen1.5-110b: qkv biases.
    cfg, params, gen = model("qwen1.5-110b")
    toks = torch.randint(0, cfg.vocab_size, (Bo, So), generator=gen,
                         device=dev)
    prefill_check(cfg.name, cfg, params, {"tokens": toks}, So)
    del params
    torch.cuda.empty_cache()

    # qwen2-vl-72b: a quarter of the positions vision embeddings on a 2-D
    # patch grid (t 0, h the row, w the column), then the text.
    cfg, params, gen = model("qwen2-vl-72b")
    sv = int(So * cfg.vision_tokens_frac)
    grid = int(round(sv ** 0.5))
    rows = torch.arange(sv, device=dev) // grid
    cols = torch.arange(sv, device=dev) % grid
    text = grid + torch.arange(So - sv, device=dev)
    pos = torch.stack([torch.cat([torch.zeros_like(rows), text]),
                       torch.cat([rows, text]), torch.cat([cols, text])])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bo, So - sv),
                                     generator=gen, device=dev),
             "vision_embeds": torch.randn((Bo, sv, cfg.d_model),
                                          generator=gen, device=dev),
             "mrope_positions": pos[:, None].expand(3, Bo, So)}
    kern = prefill_check(cfg.name, cfg, params, batch, So)
    flat = dict(batch, mrope_positions=torch.arange(
        So, device=dev).expand(3, Bo, So))
    moved = _rel_l2(torch, tf.forward(params, cfg, flat), kern)
    log(f"[options 6c] {cfg.name}: {sv} vision positions on a {grid} x "
        f"{grid} grid, sections {cfg.mrope_sections}; the logits with one "
        f"position for t, h and w (RoPE) differ by relative L2 {moved:.3e}")
    require(moved > 1e-3, "the M-RoPE positions do not reach the logits")
    del params, kern
    torch.cuda.empty_cache()

    # granite-20b: the int8 KV cache beside the bf16 one, same tokens.
    cfg, params, gen = model("granite-20b")
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    T = KV_QUANT_STEPS
    toks = torch.randint(0, cfg.vocab_size, (Bo, T), generator=gen,
                         device=dev)
    out = {}
    for c in (cfg, qcfg):
        cache = tf.init_cache(c, Bo, T, device=dev)

        def steps(c=c, cache=cache):
            return torch.cat([tf.decode_step(params, c, cache,
                                             toks[:, t:t + 1], t)[0]
                              for t in range(T)], dim=1)

        out[c.kv_quant], got, ms = counted(steps)
        want = {"rmsnorm": (2 * Lo + 1) * T, "flash_attention": 0}
        require(got == want, f"granite decode launches {got} != {want}")
        out[c.kv_quant, "ms"] = ms
        if c.kv_quant:
            require(cache["l0"]["k_q"].dtype == torch.int8
                    and int(cache["l0"]["k_q"].abs().max()) == 127,
                    "the int8 cache was not written")
    require(bool(torch.isfinite(out[True]).all()),
            "int8-cache logits not finite")
    rel, top1 = _agreement(torch, out[True], out[False])
    log(f"[options 6c] granite-20b int8 KV cache, {T} decode steps at batch "
        f"{Bo}: {out[True, 'ms'] / T:.3f} ms a step against "
        f"{out[False, 'ms'] / T:.3f} with the bf16 cache; logits finite, "
        f"relative L2 {rel:.3e} and top-1 agreement {top1:.4f} against the "
        f"bf16 cache (reported; the CPU tests hold it to the JAX package)")
    del params
    log(f"[options 6c] phase wall {time.perf_counter() - wall0:.2f} s")
    return totals


# ---------------------------------------------------------------------------
# Phase 7: guardrails and observability
# ---------------------------------------------------------------------------
def _state_equal(torch, a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "lam_eq", "lam_in", "mu"))


def _poisoned_site(fn):
    """The message of the `SanitizeError` that `fn()` raises; fails the run
    when it raises nothing."""
    from repro_torch.analysis import SanitizeError
    try:
        fn()
    except SanitizeError as e:
        return str(e)
    raise AssertionError("a NaN went through the sanitizer unreported")


def phase_observability(np, torch, p):
    """Phase 7: the guardrails and the observability at the main path's
    fleet. Sanitized CR1/CR2 solves and a sanitized 24-tick CR1 day
    through the kernels (bitwise the unsanitized ones, the same launches,
    a NaN raises and a clean day on the same graph passes); telemetry on
    the generic engine (bitwise off, refused with the kernels); the tick
    ledger with the recompile guard over a per-tick loop and three days,
    the third under `recompile_guard(0)` and bitwise a solver's without
    the ledger; the report CLI; `span` against CUDA events and
    `profile`'s trace. Returns the launches of its counted runs."""
    import contextlib
    import io
    import tempfile

    from repro_torch.analysis import recompile_guard
    from repro_torch.core.api import (CR1, CR2, SolveContext,
                                      configured_policy, solve, solve_day)
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.daygraph import DAY_GRAPHS
    from repro_torch.core.streaming import RollingHorizonSolver
    from repro_torch.obs import (EventWriter, TelemetryConfig, profile,
                                 read_events, span)
    from repro_torch.obs.report import main as report_main
    t_phase = time.perf_counter()
    totals = {"al_step": 0, "dr_features": 0}
    counted = functools.partial(count_launches, torch, totals, "obs")
    hour = 17                                   # the NaN's hour
    for pol in (CR1(lam=1.45), CR2(cap_frac=0.78)):   # warm-up, not timed
        solve(p, pol, ctx=SolveContext(steps=8))
        solve(p, pol, ctx=SolveContext(steps=8, use_kernel=False))

    # 1. Sanitized solves through the kernels.
    for pol, rounds in ((CR1(lam=1.45), 1), (CR2(cap_frac=0.78), CR2.outer)):
        steps = pol.default_steps
        want = {"al_step": rounds * -(-steps // 8),
                "dr_features": 1 if rounds == 1 else rounds + 2}
        # In turns (plain, sanitized, sanitized, plain, ...): medians.
        runs = {False: [], True: []}
        for sanitize in (False, True, True, False, False, True):
            runs[sanitize].append(counted(
                f"{pol.name} solve, sanitize={sanitize}", lambda: solve(
                    p, pol, ctx=SolveContext(sanitize=sanitize)), want))
        plain, san = runs[False][0][0], runs[True][0][0]
        plain_wall, san_wall = (statistics.median(w for _, w in runs[k])
                                for k in (False, True))
        require(np.array_equal(plain.D, san.D)
                and _state_equal(torch, plain.state, san.state),
                f"obs {pol.name}: the sanitized solve is not bitwise the "
                f"unsanitized one")
        mci = np.asarray(p.mci, np.float64).copy()
        mci[hour] = np.nan
        bad = dataclasses.replace(p, mci=mci)
        silent = solve(bad, pol)
        require(bool(np.isnan(silent.D).any()),
                f"obs {pol.name}: the unsanitized poisoned solve returned a "
                f"finite plan")
        msg = _poisoned_site(lambda: solve(bad, pol,
                                           ctx=SolveContext(sanitize=True)))
        require(msg.startswith("al-fused-inner: non-finite values in x"),
                f"obs {pol.name}: the sanitizer named {msg!r}")
        log(f"[obs] {pol.name} solve at W = {p.W}: sanitized bitwise the "
            f"unsanitized (launches equal); walls (medians of 3, in turns) "
            f"plain {plain_wall:.4f} s, sanitized {san_wall:.4f} s; NaN at "
            f"hour {hour}: unsanitized "
            f"plan {int(np.isnan(silent.D).sum())} NaN entries, sanitized "
            f"raised {msg.split(' —')[0]!r}")

    # 2. A sanitized 24-tick CR1 day: captured, then replayed.
    stream = ForecastStream.caiso(n_ticks=2 * DAY_TICKS, horizon=T_MAIN,
                                  seed=DAY_SEED)
    stack = np.stack([stream.forecast(t) for t in range(DAY_TICKS)])
    window = dataclasses.replace(p, mci=stack[0])
    name, cold, warm, rounds = DAY_POLICIES[0]
    day_pol = configured_policy(name, outer=rounds)
    want = expected_day_launches(cold, warm, rounds, DAY_TICKS)

    def day(stack_, sanitize):
        return solve_day(window, day_pol, stack_,
                         ctx=SolveContext(sanitize=sanitize),
                         cold_steps=cold, warm_steps=warm)

    day(stack, False)                           # the plain day's graph
    n0 = DAY_GRAPHS.captures
    first, capture_wall = _timed(torch, lambda: day(stack, True))
    require(DAY_GRAPHS.captures == n0 + 1,
            "obs: the sanitized day did not capture a graph of its own")
    runs = {False: [], True: []}                # replays in turns: medians
    for sanitize in (False, True, True, False, False, True):
        runs[sanitize].append(counted(
            f"cr1 day replay, sanitize={sanitize}",
            lambda: day(stack, sanitize), want))
    plain, san = runs[False][0][0], runs[True][0][0]
    plain_wall, san_wall = (statistics.median(w for _, w in runs[k])
                            for k in (False, True))
    require(np.array_equal(san.committed, plain.committed)
            and np.array_equal(first.committed, plain.committed)
            and _state_equal(torch, san.last.state, plain.last.state),
            "obs: the sanitized day is not bitwise the unsanitized replay")
    poisoned = stack.copy()
    poisoned[5, hour] = np.nan
    msg = _poisoned_site(lambda: day(poisoned, True))
    require(msg.startswith("al-fused-inner: non-finite values in x"),
            f"obs: the poisoned day named {msg!r}")
    clean, _ = counted("cr1 sanitized day after the poisoned one",
                       lambda: day(stack, True), want)
    require(DAY_GRAPHS.captures == n0 + 1
            and np.array_equal(clean.committed, plain.committed),
            "obs: the clean day after the poisoned one did not pass on the "
            "same graph")
    log(f"[obs] sanitized cr1 day (24 ticks): bitwise the unsanitized "
        f"replay; capture {capture_wall:.4f} s, replay {san_wall:.4f} s "
        f"(unsanitized replay {plain_wall:.4f} s; medians of 3, in turns); "
        f"NaN in tick 5 raised "
        f"{msg.split(' —')[0]!r} after the replay; the next clean day "
        f"passed on the same graph")

    # 3. Telemetry on the generic engine.
    tel = TelemetryConfig(every=10)
    for pol, steps, rounds in ((CR1(lam=1.45), 120, 1),
                               (CR2(cap_frac=0.78, outer=2), 60, 2)):
        ctx = SolveContext(use_kernel=False, steps=steps)
        off, off_wall = _timed(torch, lambda: solve(p, pol, ctx=ctx))
        on, on_wall = _timed(torch, lambda: solve(
            p, pol, ctx=dataclasses.replace(ctx, telemetry=tel)))
        trace = on.extras["telemetry"]
        require(np.array_equal(off.D, on.D)
                and _state_equal(torch, off.state, on.state),
                f"obs {pol.name}: telemetry moved the generic solve")
        require(np.array_equal(trace.step,
                               np.arange(10, steps * rounds + 1, 10))
                and bool(np.isfinite(trace.objective).all()),
                f"obs {pol.name}: telemetry samples {trace.step}")
        try:
            solve(p, pol, ctx=SolveContext(telemetry=tel))
            require(False, f"obs {pol.name}: telemetry ran with the kernels")
        except NotImplementedError as e:
            require("telemetry" in str(e), str(e))
        log(f"[obs] {pol.name} telemetry (generic, {rounds} x {steps}): "
            f"bitwise off, {trace.n_samples} samples, objective "
            f"{trace.objective[0]:.4f} -> {trace.objective[-1]:.4f}, grad "
            f"norm {trace.grad_norm[-1]:.4e}, violation "
            f"{trace.violation[-1]:.4e}; walls off {off_wall:.4f} s, on "
            f"{on_wall:.4f} s; refused with the kernels")

    # 4. The tick ledger with the recompile guard: five days (days 4 and 5
    # only time the replay, in turns), so a 120-tick stream.
    stream = ForecastStream.caiso(n_ticks=5 * DAY_TICKS, horizon=T_MAIN,
                                  seed=DAY_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "ledger.jsonl"
        kw = dict(policy=day_pol, cold_steps=cold, warm_steps=warm)
        with EventWriter(path, tags={"policy": "cr1"}) as w:
            loop, loop_wall = _timed(torch, lambda: RollingHorizonSolver(
                p, stream, events=w, guard_recompiles=True, **kw).run(
                    DAY_TICKS))
            led = RollingHorizonSolver(p, stream, events=w,
                                       guard_recompiles=True, **kw)
            bare = RollingHorizonSolver(p, stream, **kw)
            led.run_scanned(DAY_TICKS)
            led.run_scanned(DAY_TICKS)
            warm_want = expected_day_launches(warm, warm, 1, DAY_TICKS)
            with recompile_guard(0, label="obs: third ledger day") as stats:
                third, led_wall = counted("cr1 third ledger day",
                                          lambda: led.run_scanned(DAY_TICKS),
                                          warm_want)
            require((stats.captures, stats.builds) == (0, 0),
                    f"obs: the third ledger day compiled {stats}")
            n1 = DAY_GRAPHS.captures
            bare.run_scanned(DAY_TICKS)
            bare.run_scanned(DAY_TICKS)
            ref, bare_wall = counted("cr1 third day without the ledger",
                                     lambda: bare.run_scanned(DAY_TICKS),
                                     warm_want)
            require(DAY_GRAPHS.captures == n1,
                    "obs: the days without the ledger captured again")
            require(np.array_equal(third.committed, ref.committed),
                    "obs: the ledger moved the committed plan")
            walls = {led: [led_wall], bare: [bare_wall]}
            for s in (bare, led, led, bare):
                walls[s].append(counted(
                    "cr1 day 4 or 5", lambda: s.run_scanned(DAY_TICKS),
                    warm_want)[1])
            led_wall, bare_wall = (statistics.median(walls[s])
                                   for s in (led, bare))
        recs = read_events(path)
        ticks = [r for r in recs if r["kind"] == "tick"]
        day = [1] + [0] * (DAY_TICKS - 1)
        require(len(ticks) == 6 * DAY_TICKS
                and [t["dispatches"] for t in ticks] == [1] * DAY_TICKS
                + 5 * day
                and all(t["recompiles"] == 0 for t in ticks[3 * DAY_TICKS:])
                and all(len(t["committed_carbon"]) == 1 for t in ticks),
                "obs: the ledger's ticks")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = report_main([str(path)])
        require(rc == 0, f"obs: the report exited {rc}")
        audit = [line.strip() for line in out.getvalue().splitlines()
                 if "dispatch(es)" in line]
        log(f"[obs] ledger: per-tick loop {loop_wall:.4f} s (24 ticks, "
            f"guarded from the second warm tick); third day under "
            f"recompile_guard(0): 0 captures, 0 builds, launches "
            f"{warm_want}; warm replay wall with the ledger {led_wall:.4f} "
            f"s, without {bare_wall:.4f} s (medians of days 3-5); "
            f"committed bitwise; "
            f"{len(recs)} records; report: {audit[0]}")

    # 5. span against CUDA events, and profile's trace.
    pol = CR1(lam=1.45)
    solve(p, pol)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with span("cr1-solve") as sp:
        start.record()
        sp.bind(solve(p, pol))
        end.record()
    event_ms = start.elapsed_time(end)
    require(sp.elapsed_s * 1e3 >= event_ms,
            f"obs: span {sp.elapsed_s * 1e3:.3f} ms < CUDA events "
            f"{event_ms:.3f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        with profile(tmp) as prof:
            solve(p, pol)
        size = (pathlib.Path(tmp) / "trace.json").stat().st_size
        require(size > 0, "obs: profile wrote an empty trace")
        kernels = sum("al_step_kernel" in e.name for e in prof.events())
    log(f"[obs] span {sp.elapsed_s * 1e3:.3f} ms >= CUDA events "
        f"{event_ms:.3f} ms; profile wrote {size} B of trace "
        f"({kernels} al_step events)")
    log(f"[obs] phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


# ---------------------------------------------------------------------------
# Phase 8: training
# ---------------------------------------------------------------------------
def _rel_l2(torch, got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _fwd_bwd_ms(torch, fwd, inputs, dout, reps=5):
    """Median time of forward plus backward from an idle stream to its
    end, from CUDA events."""
    def run():
        out = fwd(*inputs)
        torch.autograd.grad(out, inputs, dout)
    return plain_ms(torch, run, reps=reps)


def _device_breakdown(torch, fn, top=10):
    """(wall s, device-busy s, [(kernel name, device ms, launches)] of
    the `top` kernels by device time) of `fn()` under `torch.profiler`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with _padded_trace(torch, [ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(bool(events), "the profiler traced no device event")
    by_name = {}
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (b - a) * 1e-3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy * 1e-6, [(k, ms, n) for k, (ms, n) in ranked]


def phase_train_grads(np, torch):
    """8a: the two autograd Functions at the model's shapes, then loss_fn
    and its gradient at full width and 2 layers, kernels against plain."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import RMSNormFn
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.launch.steps import make_loss_fn, value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import tree_items

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    full = get_config("stablelm-3b")
    B, S, H, Dh, d = (TRAIN_BATCH, TRAIN_SEQ, full.num_heads, full.dh,
                      full.d_model)
    rec = {}
    for dt, tol in ((torch.float32, BWD_F32), (torch.bfloat16, BWD_BF16)):
        name = str(dt).removeprefix("torch.")
        # RMSNorm over the step's (B·S, d) rows.
        x = (1.5 * torch.randn((B * S, d), generator=gen, device=dev)).to(dt)
        s = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        dy = torch.randn((B * S, d), generator=gen, device=dev).to(dt)
        x.requires_grad_(True)
        s.requires_grad_(True)
        y = RMSNormFn.apply(x, s, 1e-6)
        require(torch.equal(y, rmsnorm_cuda(x.detach(), s.detach())),
                f"rmsnorm {name}: the autograd forward is not the kernel's")
        got = torch.autograd.grad(y, (x, s), dy)
        want = torch.autograd.grad(rmsnorm_ref(x, s), (x, s), dy)
        errs = [_rel_l2(torch, g, w) for g, w in zip(got, want)]
        log(f"[train 8a] rmsnorm {name} ({B * S}, {d}): forward bitwise the "
            f"kernel's; backward vs autograd through the plain version: "
            f"relative L2 dx {errs[0]:.3e}, dscale {errs[1]:.3e} (bound "
            f"{tol:g})")
        require(max(errs) < tol, f"rmsnorm {name} backward: {errs} >= {tol}")
        if dt == torch.bfloat16:
            w = s.detach().bfloat16().requires_grad_(True)
            rec["rmsnorm"] = {
                "ms": _fwd_bwd_ms(torch, lambda a, b: RMSNormFn.apply(
                    a, b, 1e-6), (x, s), dy),
                "plain_ms": _fwd_bwd_ms(torch, rmsnorm_ref, (x, s), dy),
                "library_ms": _fwd_bwd_ms(torch, lambda a, b: F.rms_norm(
                    a, (d,), b, 1e-6), (x, w), dy)}
        del x, s, dy, y, got, want

        # Flash attention at the step's (B, S, H, Dh), causal.
        q, k, v = (torch.randn((B, S, H, Dh), generator=gen,
                               device=dev).to(dt).requires_grad_(True)
                   for _ in range(3))
        do = torch.randn((B, S, H, Dh), generator=gen, device=dev).to(dt)
        out = FlashAttentionFn.apply(q, k, v, True, 0)
        require(torch.equal(out, flash_attention_cuda(
            q.detach(), k.detach(), v.detach())),
                f"flash_attention {name}: the forward with its log-sum-exp "
                f"buffer is not the buffer-free call's")
        _, lse = flash_attention_cuda(q.detach(), k.detach(), v.detach(),
                                      with_lse=True)
        lse_err = float((lse - attention_lse_ref(q.detach(), k.detach()))
                        .abs().max())
        got = torch.autograd.grad(out, (q, k, v), do)
        want = torch.autograd.grad(attention_ref(q, k, v), (q, k, v), do)
        errs = [_rel_l2(torch, g, w) for g, w in zip(got, want)]
        log(f"[train 8a] flash_attention {name} {(B, S, H, Dh)} causal: "
            f"forward bitwise with and without the log-sum-exp buffer, "
            f"log-sum-exp max abs err {lse_err:.3e} against the plain one; "
            f"backward vs autograd through the plain version: relative L2 "
            f"dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (bound "
            f"{tol:g})")
        require(lse_err < 1e-3, f"flash_attention {name}: log-sum-exp off "
                f"by {lse_err:.3e}")
        require(max(errs) < tol,
                f"flash_attention {name} backward: {errs} >= {tol}")
        if dt == torch.bfloat16:
            qd, kd, vd = (t.detach() for t in (q, k, v))
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            rec["flash_attention"] = {
                "ms": _fwd_bwd_ms(torch, lambda a, b, c: FlashAttentionFn
                                  .apply(a, b, c, True, 0), (q, k, v), do),
                "plain_ms": _fwd_bwd_ms(torch, attention_ref, (q, k, v), do),
                "library_ms": _fwd_bwd_ms(
                    torch, lambda a, b, c: F.scaled_dot_product_attention(
                        a, b, c, is_causal=True), (qt, kt, vt),
                    do.transpose(1, 2)),
                "fwd_ms": kernel_ms(torch, lambda: flash_attention_cuda(
                    qd, kd, vd), reps=20),
                "fwd_lse_ms": kernel_ms(torch, lambda: flash_attention_cuda(
                    qd, kd, vd, with_lse=True), reps=20)}
        del q, k, v, do, out, got, want
        torch.cuda.empty_cache()
    # Bounds of forward + backward by `bound()`'s rule. Attention (FA2):
    # the forward reads q, k, v and writes o and the f32 log-sum-exp; the
    # backward reads q, k, v, o, dO and the log-sum-exp and writes dq, dk,
    # dv; per live (query, key) pair the forward's QK and PV products
    # (2·Dh + 2·Dv) and the backward's recomputed QK, dV, dP, dQ and dK
    # (6·Dh + 4·Dv). RMSNorm: the forward reads x and writes y, the
    # backward reads x and dy and writes dx (bf16), the scale read twice
    # and its gradient written once (f32); 4 f32 operations an element
    # forward, 10 backward.
    n_qkv = B * S * H * Dh
    pairs = B * H * fa_live_pairs(S, S, True, 0)
    rec["flash_attention"]["bound_ms"], rec["flash_attention"]["bound_by"] \
        = bound(12 * n_qkv * 2 + 2 * B * H * S * 4,
                pairs * 2 * (4 * Dh + 3 * Dh), H100_BF16_OPS_PER_S)
    rec["rmsnorm"]["bound_ms"], rec["rmsnorm"]["bound_by"] = bound(
        5 * B * S * d * 2 + 3 * d * 4, 14 * B * S * d, H100_F32_OPS_PER_S)
    fa = rec["flash_attention"]
    log(f"[train 8a] bounds of forward + backward at the step's shapes, "
        f"bf16: rmsnorm ({B * S}, {d}) {rec['rmsnorm']['bound_ms']:.4f} ms "
        f"({rec['rmsnorm']['bound_by']}); flash attention {(B, S, H, Dh)} "
        f"causal {fa['bound_ms']:.4f} ms ({fa['bound_by']})")
    log(f"[train 8a] forward + backward at the step's shapes, bf16: rmsnorm "
        f"autograd Function {rec['rmsnorm']['ms']:.3f} ms, plain "
        f"{rec['rmsnorm']['plain_ms']:.3f} ms, F.rms_norm "
        f"{rec['rmsnorm']['library_ms']:.3f} ms; flash attention autograd "
        f"Function {fa['ms']:.3f} ms, plain {fa['plain_ms']:.3f} ms, SDPA "
        f"{fa['library_ms']:.3f} ms (CUDA events, median of 5); the forward "
        f"kernel alone {fa['fwd_ms'] * 1e3:.2f} us, with its log-sum-exp "
        f"{fa['fwd_lse_ms'] * 1e3:.2f} us")

    # loss_fn and its gradient, full width, 2 layers, kernels vs plain.
    cfg = dataclasses.replace(full, num_layers=GRAD_LAYERS)
    masters = tf.init_params(cfg, seed=0, device=dev)
    batch = synthetic_batch(cfg, ShapeCell("train_4k", S, B, "train"), 0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out = {}
    for kern in (True, False):
        loss, grads = value_and_grad(make_loss_fn(cfg, use_kernel=kern),
                                     masters, batch)
        out[kern] = (float(loss), dict(tree_items(grads)))
        del grads
        torch.cuda.empty_cache()
    lk, gk = out[True]
    lp, gp = out[False]
    rel = abs(lk - lp) / abs(lp)
    errs = {key: _rel_l2(torch, gk[key], gp[key]) for key in gp}
    worst = max(errs, key=errs.get)
    log(f"[train 8a] stablelm-3b at full width, {GRAD_LAYERS} layers, "
        f"batch {B} x {S}: loss through the kernels {lk:.6f}, plain "
        f"{lp:.6f}, relative {rel:.3e} (bound {LOSS_RTOL:g}); {len(errs)} "
        f"gradient leaves, relative L2 worst {errs[worst]:.3e} at {worst} "
        f"(bound {GRAD_REL_L2:g}), median "
        f"{statistics.median(errs.values()):.3e}")
    require(np.isfinite(lk) and rel < LOSS_RTOL,
            f"loss through the kernels {lk} vs plain {lp}")
    require(errs[worst] < GRAD_REL_L2,
            f"gradient {worst}: relative L2 {errs[worst]:.3e}")
    del out, gk, gp, masters
    torch.cuda.empty_cache()
    log(f"[train 8a] phase wall {time.perf_counter() - t_phase:.2f} s")
    return rec


def phase_train(np, torch):
    """8b: the coordinator's plan, `train()` at full width and depth
    with a failure retried in place, its final checkpoint restored
    bitwise, the 32-layer step timed and profiled, `train()` under the
    plan's throttle where its budgets vary, and the runner on the
    integration tests' config. Returns the kernels' launches on these
    paths."""
    import tempfile

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.fleetcache import cached_paper_fleet
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import dr_throttle, hour_budgets, train
    from repro_torch.optim.adamw import AdamWConfig, tree_items
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.ft import FailurePlan

    t_phase = time.perf_counter()
    kernels = {"rmsnorm": rmsnorm_cuda,
               "flash_attention": flash_attention_cuda}
    totals = dict.fromkeys(kernels, 0)
    full = get_config("stablelm-3b")
    L = full.num_layers
    shape = ShapeCell("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens = TRAIN_SEQ * TRAIN_BATCH

    def per_step(layers):
        return {"rmsnorm": 4 * layers + 1, "flash_attention": 2 * layers}

    def counted(fn):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        got = {n: f.launches for n, f in kernels.items()}
        for n in totals:
            totals[n] += got[n]
        return out, got

    def plain_events(report):
        return [(e["step"], e["event"]) for e in report["events"]
                if not e["event"].startswith("straggler")]

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        # 8b: the plan's paper fleet (160 / 10,000), as main() builds it,
        # is calibrated in a thread beside train() and the restore below,
        # after every phase before it, and awaited before the plan and the
        # timed 32-layer step. Its EDD simulations are a host loop: they
        # share the host with train()'s launches and the checkpoint's
        # copies, whose walls are reported, not bounded.
        t_fleet = time.perf_counter()
        calibration = concurrent.futures.ThreadPoolExecutor(1)
        fleet_ready = calibration.submit(cached_paper_fleet, hours=48,
                                         device="cuda")
        calibration.shutdown(wait=False)

        # 8b: train() at full width and depth: one run of 6 steps with
        # one (final) 33.5 GB checkpoint, within the run's 45 GiB of disk
        # writes, and not the throttle's 6 one-step hours, which would
        # write 6 (every budget is 1 at 6 steps over 48 hours). A failure
        # at step TRAIN_FAIL_STEP, before any checkpoint, is retried in
        # place.
        report, got = counted(lambda: train(
            full, shape, TRAIN_STEPS, str(tmp / "train"),
            failure_plan=FailurePlan(fail_steps=(TRAIN_FAIL_STEP,))))
        losses = report["losses"]
        want = {n: c * TRAIN_STEPS for n, c in per_step(L).items()}
        events = plain_events(report)
        on_card = all(t.is_cuda for _, t in tree_items(
            {"p": report["params"], "o": report["opt_state"]}))
        log(f"[train 8b] train() stablelm-3b full width and depth ({L} "
            f"layers), batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat, "
            f"{TRAIN_STEPS} steps, a failure at step {TRAIN_FAIL_STEP}: "
            f"losses {[round(x, 4) for x in losses]}, events {events}, state "
            f"on the card {on_card}, launches {got} (expected {want}), wall "
            f"{report['wall_s']:.2f} s")
        for c in report["checkpoints"]:
            log(f"[train 8b] checkpoint at step {c['step']}: "
                f"{c['bytes'] / 1e9:.2f} GB, host snapshot "
                f"{c['snapshot_s']:.2f} s, write {c['write_s']:.2f} s, "
                f"{c['bytes'] / 1e9 / (c['snapshot_s'] + c['write_s']):.2f} "
                f"GB/s in all")
        require(len(losses) == TRAIN_STEPS
                and all(np.isfinite(x) for x in losses), "train() losses")
        require(events == [(TRAIN_FAIL_STEP, "failure"),
                           (TRAIN_FAIL_STEP, "retry")] and on_card,
                f"train() did not retry on the card: {events}")
        require(got == want, f"train() launches {got} != {want}")
        require([c["step"] for c in report["checkpoints"]] == [TRAIN_STEPS],
                "one checkpoint, the final one")

        # The final checkpoint (params, m, v, step) restored bitwise.
        state = {"params": report["params"], "opt": report["opt_state"]}
        mgr = CheckpointManager(tmp / "train")
        require(mgr.all_steps() == [TRAIN_STEPS],
                f"checkpoints on disk {mgr.all_steps()}")
        t0 = time.perf_counter()
        restored, at = mgr.restore(state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_items(state), tree_items(restored)))
        log(f"[train 8b] final checkpoint (step {at}, "
            f"{report['checkpoints'][-1]['bytes'] / 1e9:.2f} GB) restored "
            f"onto the card beside the live state, as the runner restores, "
            f"in {t_restore:.2f} s, bitwise {same}; free "
            f"space under {tmp.parent}: "
            f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")
        require(same and at == TRAIN_STEPS, "checkpoint restore not bitwise")
        del restored, state, mgr
        t0 = time.perf_counter()
        fleet_ready.result()
        log(f"[train 8b] the coordinator's paper fleet (160 / 10,000) "
            f"calibrated in {time.perf_counter() - t_fleet:.2f} s, beside "
            f"train() and the restore ({time.perf_counter() - t0:.2f} s "
            f"awaited after them)")
        t0 = time.perf_counter()
        throttle = dr_throttle(full.name, TRAIN_LAMBDA, device="cuda")
        log(f"[train 8b] FleetCoordinator([stablelm-3b], caiso_2021(48), "
            f"lam={TRAIN_LAMBDA}).plan() in {time.perf_counter() - t0:.2f} s;"
            f" throttle {np.round(throttle, 3).tolist()}")
        shutil.rmtree(tmp / "train")
        masters, opt = report["params"], report["opt_state"]
        del report
        torch.cuda.empty_cache()

        # 8b: the 32-layer step timed and profiled, from train()'s state.
        step = make_train_step(full,
                               AdamWConfig(total_steps=2 * TRAIN_STEPS))
        batches = [synthetic_batch(full, shape, i)
                   for i in range(TRAIN_STEPS, 2 * TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            (masters, opt, loss), got = counted(
                lambda: step(masters, opt, batch))
            torch.cuda.synchronize()
            losses.append(loss)
            walls.append(time.perf_counter() - t0)
            require(got == per_step(L),
                    f"step {i}: launches {got} != {per_step(L)}")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(walls[-4:]) * 1e3
        log(f"[train 8b] stablelm-3b {L} layers, make_train_step (in "
            f"place): losses {[round(x, 4) for x in losses]}, {ms:.1f} ms a "
            f"step (median of the last 4, host clock, one loss read a "
            f"step, to the end of its update), {tokens / ms * 1e3:.0f} tokens/s, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches a step {got} by counter; "
            f"step walls {[round(w, 3) for w in walls]} s")
        require(all(np.isfinite(x) for x in losses), f"{L}-layer losses")
        prof_batch = batches[0]

        def one_step():
            nonlocal masters, opt
            masters, opt, _ = step(masters, opt, prof_batch)
            torch.cuda.synchronize()

        dl = device_launches(torch, f"{L}-layer train step", one_step,
                             {"rmsnorm": 129, "fa_bf16": 64},
                             names=("rmsnorm", "fa_bf16"))
        wall, busy, top = _device_breakdown(torch, one_step)
        log(f"[train 8b] profiled {L}-layer step: device launches {dl}, "
            f"wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, idle "
            f"share {1 - busy / wall:.4f}; device time by kernel, top "
            f"{len(top)}: " + "; ".join(f"{n[:60]} {ms:.1f} ms x {c}"
                                        for n, ms, c in top))
        del masters, opt, step
        torch.cuda.empty_cache()
        t_runner = time.perf_counter()

        # 8b: train() under the plan's throttle, on the integration tests'
        # config: at 2 steps an hour a throttle below 0.75 cuts an hour to
        # one step.
        small = reduced(full, layers=2, d_model=64)
        sshape = ShapeCell("t", 64, 4, "train")
        base = max(1, THROTTLE_STEPS // len(throttle))
        want_budgets = hour_budgets(THROTTLE_STEPS, throttle)
        rep, got = counted(lambda: train(small, sshape, THROTTLE_STEPS,
                                         str(tmp / "throttle"),
                                         throttle=throttle))
        log(f"[train 8b] reduced stablelm-3b, {THROTTLE_STEPS} steps under "
            f"the same throttle: base budget {base}, budgets "
            f"{rep['budgets']} ({len(rep['budgets'])} hours, "
            f"{sum(b < base for b in rep['budgets'])} cut), "
            f"{rep['steps']} steps; launches {got}")
        require(rep["budgets"] == want_budgets
                and sum(rep["budgets"]) == THROTTLE_STEPS
                and rep["steps"] == THROTTLE_STEPS
                and any(b < base for b in rep["budgets"][:-1]),
                "the throttle changed no budget")
        require(len(rep["checkpoints"]) >= len(rep["budgets"]),
                "a blocking checkpoint at the end of every hour")
        require(all(np.isfinite(x) for x in rep["losses"]),
                "throttled losses")

        # 8b: the runner on the integration tests' config.
        rep, got = counted(lambda: train(small, sshape, 40,
                                         str(tmp / "loss")))
        first, last = np.mean(rep["losses"][:5]), np.mean(rep["losses"][-5:])
        log(f"[train 8b runner] reduced stablelm-3b (2 layers, d 64), 40 steps: "
            f"loss {first:.4f} over the first 5, {last:.4f} over the last 5; "
            f"launches {got}")
        require(len(rep["losses"]) == 40 and last < first,
                "the reduced model's loss did not decrease")
        rep, got = counted(lambda: train(
            small, sshape, 30, str(tmp / "fail"),
            failure_plan=FailurePlan(fail_steps=(13,))))
        events = plain_events(rep)
        on_card = all(t.is_cuda for _, t in tree_items(rep["params"]))
        log(f"[train 8b runner] with a failure at step 13: {rep['steps']} steps, "
            f"events {events}, parameters on the card {on_card}; launches "
            f"{got}")
        require(rep["steps"] >= 30 and (10, "restored") in events
                and on_card, "the runner did not restore onto the card")
        log(f"[train 8b runner] with the budgets: "
            f"{time.perf_counter() - t_runner:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train] phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


def phase_train_whisper(np, torch):
    """8c: whisper-large-v3 training at full width and depth, three
    `make_train_step` steps of batch 8 x 448 decoder tokens (Whisper's
    decoder context) over 1500 frames each, bf16 compute, f32 masters and
    moments, remat, launches a step by counter; one more step profiled;
    then loss and every gradient leaf through the kernels against the
    plain versions at full width and 2 + 2 layers. Writes no checkpoint.
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import (make_loss_fn, make_train_step,
                                          value_and_grad)
    from repro_torch.models import encdec
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_items

    t_phase = time.perf_counter()
    totals = {}
    counted = _counter(torch, totals)
    full = get_config("whisper-large-v3")
    Le, L = full.encoder_layers, full.num_layers
    B, S = WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ
    shape = ShapeCell("whisper_train", S, B, "train")
    dev = torch.device("cuda")
    masters = encdec.init_params(full, seed=0, device=dev)
    opt_cfg = AdamWConfig(total_steps=2 * WHISPER_TRAIN_STEPS)
    opt = adamw_init(masters, opt_cfg)
    state = sum(t.numel() * t.element_size()
                for _, t in tree_items({"p": masters, "o": opt}))
    step = make_train_step(full, opt_cfg)
    batches = [synthetic_batch(full, shape, i)
               for i in range(WHISPER_TRAIN_STEPS + 1)]
    per_step = {"rmsnorm": 4 * Le + 1 + 6 * L + 1,
                "flash_attention": 2 * Le + 4 * L}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for i, batch in enumerate(batches[:-1]):
        (masters, opt, loss), got, ms = counted(
            lambda: step(masters, opt, batch))
        losses.append(loss)
        walls.append(ms)
        require(got == per_step,
                f"whisper step {i}: launches {got} != {per_step}")
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(walls[1:])
    frames, tokens = B * full.encoder_seq, B * S
    log(f"[train 8c] whisper-large-v3 {Le} + {L} layers, batch {B} x {S} "
        f"decoder tokens over {full.encoder_seq} frames, bf16 compute, f32 "
        f"masters and moments ({state / 1e9:.2f} GB of state), remat: "
        f"losses {[round(x, 4) for x in losses]}, {ms:.1f} ms a step "
        f"(median of steps 2-{WHISPER_TRAIN_STEPS}, host clock to the loss "
        f"read and the update), {frames / ms * 1e3:.0f} frames/s and "
        f"{tokens / ms * 1e3:.0f} decoder tokens/s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches a step {got} (expected "
        f"{per_step}: rmsnorm 4L_enc + 1 + 6L_dec + 1, flash attention "
        f"2L_enc + 4L_dec); step walls {[round(w, 1) for w in walls]} ms")
    require(all(np.isfinite(x) for x in losses), "whisper losses")
    prof_batch = batches[-1]

    def one_step():
        nonlocal masters, opt
        masters, opt, _ = step(masters, opt, prof_batch)
        torch.cuda.synchronize()

    wall, busy, top = _device_breakdown(torch, one_step)
    log(f"[train 8c] profiled whisper step: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy * 1e3:.1f} ms, idle share {1 - busy / wall:.4f}; device "
        f"time by kernel, top {len(top)}: "
        + "; ".join(f"{n[:60]} {ms:.1f} ms x {c}" for n, ms, c in top))
    del masters, opt, step, batches
    torch.cuda.empty_cache()

    # Loss and gradients at full width and 2 + 2 layers, kernels vs plain.
    cfg = dataclasses.replace(full, num_layers=GRAD_LAYERS,
                              encoder_layers=GRAD_LAYERS)
    masters = encdec.init_params(cfg, seed=0, device=dev)
    batch = synthetic_batch(cfg, shape, 0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out = {}
    for kern in (True, False):
        loss, grads = value_and_grad(make_loss_fn(cfg, use_kernel=kern),
                                     masters, batch)
        out[kern] = (float(loss), dict(tree_items(grads)))
        del grads
        torch.cuda.empty_cache()
    lk, gk = out[True]
    lp, gp = out[False]
    rel = abs(lk - lp) / abs(lp)
    errs = {key: _rel_l2(torch, gk[key], gp[key]) for key in gp}
    worst = max(errs, key=errs.get)
    log(f"[train 8c] whisper at full width, {GRAD_LAYERS} + {GRAD_LAYERS} "
        f"layers, batch {B} x {S}: loss through the kernels {lk:.6f}, plain "
        f"{lp:.6f}, relative {rel:.3e} (bound {LOSS_RTOL:g}); {len(errs)} "
        f"gradient leaves, relative L2 worst {errs[worst]:.3e} at {worst} "
        f"(bound {GRAD_REL_L2:g}), median "
        f"{statistics.median(errs.values()):.3e}")
    require(np.isfinite(lk) and rel < LOSS_RTOL,
            f"whisper loss through the kernels {lk} vs plain {lp}")
    require(errs[worst] < GRAD_REL_L2,
            f"whisper gradient {worst}: relative L2 {errs[worst]:.3e}")
    del out, gk, gp, masters
    torch.cuda.empty_cache()
    log(f"[train 8c] phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


def expected_train_launches(cfg):
    """Launches of each kernel in one remat train step of a decoder: its
    layers' norms (ln1; ln2 with an FFN; the gated norm of a Mamba-2
    mixer; q- and k-norm, or MLA's q and kv latents' norms) twice, in the
    forward and the recompute, and ln_f; the MTP head's ln_h, ln_e and its
    layer's norms once (it runs outside the checkpoints); flash attention
    per attention layer twice and once in the MTP layer (its backward is
    torch ops); ssd_scan per Mamba-2 layer twice, its backward once."""
    def norms(i):
        mixer, ffn = cfg.layer_kind(i)
        return (1 + (ffn != "none") + (mixer == "ssm")
                + 2 * (mixer == "mla" or (mixer == "attn" and cfg.qk_norm)))

    def attn(i):
        return cfg.layer_kind(i)[0] in ("attn", "mla")

    L = range(cfg.num_layers)
    n_ssm = sum(cfg.layer_kind(i)[0] == "ssm" for i in L)
    mtp = cfg.num_layers - 1 if cfg.mtp_depth else None
    return {"rmsnorm": 2 * sum(norms(i) for i in L) + 1
            + (2 + norms(mtp) if mtp is not None else 0),
            "flash_attention": 2 * sum(attn(i) for i in L)
            + (attn(mtp) if mtp is not None else 0),
            "ssd_scan": 2 * n_ssm, "ssd_scan_bwd": n_ssm}


def _grads_kernel_vs_plain(np, torch, cfg, masters, batch, counted, tag):
    """`loss_fn` and every gradient leaf of `masters` through the kernels
    against the plain versions, at 8a's bounds (loss LOSS_RTOL relative,
    each leaf GRAD_REL_L2 relative L2). An MoE model is held with free
    routing first; if that misses and some (token, layer) expert set
    differs between the paths, the plain path runs again on the kernel
    path's expert ids (`_route`, its forward and its recompute alike),
    and that run is required. Logs the flip share. Returns the kernel
    pass's launches."""
    from repro_torch.launch.steps import make_loss_fn, value_and_grad
    from repro_torch.optim.adamw import tree_items

    def run(kern, replay=None):
        records = []
        undo = (_route(torch, records, replay) if cfg.moe is not None
                else lambda: None)
        try:
            (loss, grads), got, _ = counted(lambda: value_and_grad(
                make_loss_fn(cfg, use_kernel=None if kern else False),
                masters, batch))
        finally:
            undo()
        return float(loss), dict(tree_items(grads)), records, got

    def compare(kern, plain, what):
        rel = abs(kern[0] - plain[0]) / abs(plain[0])
        errs = {k: _rel_l2(torch, kern[1][k], plain[1][k]) for k in plain[1]}
        worst = max(errs, key=errs.get)
        log(f"{tag} {cfg.name} loss and gradients, kernels vs plain ({what})"
            f": loss {kern[0]:.6f} vs {plain[0]:.6f}, relative {rel:.3e} "
            f"(bound {LOSS_RTOL:g}); {len(errs)} gradient leaves, relative "
            f"L2 worst {errs[worst]:.3e} at {worst} (bound {GRAD_REL_L2:g}),"
            f" median {statistics.median(errs.values()):.3e}")
        return (np.isfinite(kern[0]) and rel < LOSS_RTOL
                and errs[worst] < GRAD_REL_L2)

    kern = run(True)
    plain = run(False)
    ok = compare(kern, plain, "free routing")
    if cfg.moe is not None:
        k = cfg.moe.top_k
        sets = sum(ids.numel() // k for ids in kern[2])
        same = sum(int((a.sort(-1).values == b.sort(-1).values).all(-1)
                       .sum()) for a, b in zip(kern[2], plain[2]))
        log(f"{tag} {cfg.name}: expert sets that agree {same} of {sets} "
            f"(token, routing call) pairs, flip share "
            f"{1 - same / sets:.6f} ({len(kern[2])} routing calls: the "
            f"forward's and the recompute's)")
        if not ok:
            require(same < sets, f"{cfg.name}: kernel gradients too far "
                    f"from plain with every expert set agreeing")
            plain = None
            torch.cuda.empty_cache()
            ok = compare(kern, run(False, replay=kern[2]),
                         "the plain path on the kernel path's expert ids, "
                         "required: free routing missed")
    require(ok, f"{cfg.name}: loss or gradients through the kernels too far "
            f"from the plain path")
    launches = kern[3]
    kern = plain = None
    torch.cuda.empty_cache()
    return launches


def phase_train_ssm(np, torch):
    """8d: training mamba2-780m at full width and depth, and jamba,
    qwen3-moe and deepseek-v3 (with its MTP loss) at full width and their
    TRAIN_CUTS; every kernel count reset just before and read just after
    each run. Writes nothing to disk (the steps, not `train()`). Returns
    the launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_items

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    totals = {}
    counted = _counter(torch, totals, names=(
        "rmsnorm", "flash_attention", "ssd_scan", "ssd_scan_bwd"))

    def state_gib(masters):
        return sum(t.numel() for _, t in tree_items(masters)) * 18 / 2**30

    def steps(cfg, masters, shape, n, tag):
        """n `make_train_step` steps, launches held to the design."""
        want = expected_train_launches(cfg)
        opt_cfg = AdamWConfig(total_steps=2 * n)
        opt = adamw_init(masters, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for i in range(n):
            batch = synthetic_batch(cfg, shape, i)
            (masters, opt, loss), got, ms = counted(
                lambda: step(masters, opt, batch))
            losses.append(loss)
            walls.append(ms)
            require(got == want, f"{cfg.name} step {i}: launches {got} != "
                    f"{want}")
        peak = torch.cuda.max_memory_allocated()
        require(all(np.isfinite(x) for x in losses), f"{cfg.name} losses")
        tokens = shape.seq_len * shape.global_batch
        ms = statistics.median(walls[1:] if n > 2 else walls[-1:])
        log(f"{tag} {cfg.name} {cfg.num_layers} layers, batch "
            f"{shape.global_batch} x {shape.seq_len}, remat, {n} steps: "
            f"losses {[round(x, 4) for x in losses]}, {ms:.1f} ms a step "
            f"({'median of steps 2-' + str(n) if n > 2 else 'the last'}, "
            f"host clock to the loss read and the update), "
            f"{tokens / ms * 1e3:.0f} tokens/s, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches a step {got} by counter "
            f"(expected {want}); step walls {[round(w, 1) for w in walls]} "
            f"ms")
        return masters, opt, step

    # mamba2-780m: loss and gradients at GRAD_LAYERS layers, then the full
    # depth for SSM_TRAIN_STEPS steps, one more profiled.
    full = get_config("mamba2-780m")
    shape = ShapeCell("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    cfg = dataclasses.replace(full, num_layers=GRAD_LAYERS)
    masters = tf.init_params(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, shape, 0).items()}
    got = _grads_kernel_vs_plain(np, torch, cfg, masters, batch, counted,
                                 "[train 8d]")
    require(got == expected_train_launches(cfg),
            f"mamba2 {GRAD_LAYERS} layers: launches {got}")
    del masters, batch
    torch.cuda.empty_cache()
    masters = tf.init_params(full, seed=0, device=dev)
    log(f"[train 8d] mamba2-780m at full width and depth: {full.num_layers} "
        f"layers, d {full.d_model}, "
        f"{full.ssm.expand * full.d_model // full.ssm.head_dim}"
        f" SSM heads of ({full.ssm.head_dim}, {full.ssm.d_state}), chunk "
        f"{full.ssm.chunk}; "
        f"{full.param_count()} parameters, {state_gib(masters):.2f} GiB of "
        f"training state at 18 bytes a parameter; no cut")
    masters, opt, step = steps(full, masters, shape, SSM_TRAIN_STEPS,
                               "[train 8d]")
    prof_batch = synthetic_batch(full, shape, SSM_TRAIN_STEPS)

    def one_step():
        nonlocal masters, opt
        masters, opt, _ = step(masters, opt, prof_batch)
        torch.cuda.synchronize()

    want = expected_train_launches(full)
    dl = device_launches(torch, f"{full.num_layers}-layer mamba2 train step",
                         one_step, {n: want[n] for n in
                                    ("rmsnorm", "ssd_scan", "ssd_scan_bwd")},
                         names=("rmsnorm", "ssd_scan", "ssd_scan_bwd"))
    wall, busy, top = _device_breakdown(torch, one_step)
    log(f"[train 8d] profiled {full.num_layers}-layer mamba2 step: device "
        f"launches {dl}, wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.4f}; device time "
        f"by kernel, top {len(top)}: " + "; ".join(
            f"{n[:60]} {ms:.1f} ms x {c}" for n, ms, c in top))
    del masters, opt, step
    torch.cuda.empty_cache()

    # The hybrid, MoE and MLA models at their cuts.
    for arch, cut, (B, S), n, why in TRAIN_CUTS:
        full = get_config(arch)
        change = {k: v for k, v in cut.items() if k != "experts"}
        moe = dataclasses.replace(full.moe, num_experts=cut["experts"]) \
            if "experts" in cut else full.moe
        cfg = dataclasses.replace(full, moe=moe, **change)
        shape = ShapeCell("train", S, B, "train")
        mtp = " + the MTP layer" if cfg.mtp_depth else ""
        shared = f" + {moe.num_shared} shared" if moe.num_shared else ""
        masters = tf.init_params(cfg, seed=0, device=dev)
        log(f"[train 8d] {arch} at full width (d {cfg.d_model}), "
            f"{cfg.num_layers} layers{mtp}, {moe.num_experts} experts "
            f"top-{moe.top_k}{shared}, batch {B} x {S}: "
            f"{cfg.param_count()} parameters, {state_gib(masters):.2f} GiB "
            f"of training state; cut: {why}")
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in synthetic_batch(cfg, shape, 0).items()}
        got = _grads_kernel_vs_plain(np, torch, cfg, masters, batch, counted,
                                     "[train 8d]")
        require(got == expected_train_launches(cfg),
                f"{arch} loss and gradients: launches {got}")
        del batch
        masters, opt, step = steps(cfg, masters, shape, n, "[train 8d]")
        del masters, opt, step
        torch.cuda.empty_cache()
    log(f"[train 8d] phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


def _mesh_cfg():
    import dataclasses as dc

    from repro_torch.configs import get_config
    return dc.replace(get_config("stablelm-3b"), num_layers=MESH_LAYERS,
                      remat=True)


def _mesh_batches():
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synthetic_batch
    shape = ShapeCell("mesh", MESH_SEQ, MESH_BATCH, "train")
    return [synthetic_batch(_mesh_cfg(), shape, step=i) for i in range(3)]


def _mesh_opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(total_steps=10)


def _signal_wait(tmp, name, limit):
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(tmp, name)):
        if time.perf_counter() - t0 > limit:
            raise TimeoutError(f"no {name} signal")
        time.sleep(0.05)


def _host_digest(np, tree):
    import hashlib

    import torch
    from repro_torch.optim.adamw import tree_items
    h = hashlib.sha256()
    for k, t in tree_items(tree):
        h.update(k.encode())
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()


def _mesh_rank(rank, world, tmp):
    """One gloo rank of phase 8e on the card, spawned at the start of phase
    8: it joins the group at once and touches the card only once
    `tmp`/go exists; its results to `tmp`/rank<r>.pkl."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "gloo"), world), rank=rank, world_size=world)
    try:
        _signal_wait(tmp, "go", MESH_WAIT_S)
        torch.cuda.set_device(0)
        res = _mesh_rank_work(np, torch, rank, tmp)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _mesh_rank_work(np, torch, rank, tmp):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init, tree_items
    from repro_torch.runtime import dtensor as dt
    from repro_torch.runtime import elastic
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.compression import (compressed_psum_pod,
                                                 init_error)
    cfg, opt_cfg, batches = _mesh_cfg(), _mesh_opt(), _mesh_batches()
    kernels = {"rmsnorm": rmsnorm_cuda,
               "flash_attention": flash_attention_cuda}
    out = {"steps": []}
    t_all = time.perf_counter()
    mesh = make_test_mesh(2, 2)
    full = tf.init_params(cfg, seed=MESH_SEED, device="cuda")
    p0 = {k: v.cpu() for k, v in tree_items(full)} if rank == 0 else None
    st = elastic.build(cfg, mesh, full, adamw_init(full, opt_cfg), opt_cfg)
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["setup_s"] = time.perf_counter() - t_all

    def step(st, batch):
        torch.cuda.synchronize()
        for f in kernels.values():
            f.launches = 0
        dt.COMM.update(gather_bytes=0, reduce_bytes=0)
        t0 = time.perf_counter()
        st.params, st.opt_state, loss = st.step_fn(st.params, st.opt_state,
                                                   batch)
        torch.cuda.synchronize()
        out["steps"].append({
            "loss": loss, "wall": time.perf_counter() - t0,
            "launches": {n: f.launches for n, f in kernels.items()},
            **dict(dt.COMM)})

    for batch in batches[:2]:
        step(st, batch)
    pspecs = sh.legalize(st.params, sh.param_specs(st.params), mesh)
    out["bytes"] = dt.state_bytes(st.params) + dt.state_bytes(st.opt_state)
    out["rule_bytes"] = sh.rule_bytes(
        {"p": st.params, "m": st.opt_state["m"], "v": st.opt_state["v"],
         "s": st.opt_state["step"]},
        {"p": pspecs, "m": pspecs, "v": pspecs, "s": ()}, mesh)
    t0 = time.perf_counter()
    snapshot = (dt.gather_tree(st.params), dt.gather_tree(st.opt_state))
    out["gather_s"] = time.perf_counter() - t0
    out["digest"] = _host_digest(np, {"p": snapshot[0], "o": snapshot[1]})
    t0 = time.perf_counter()
    if rank == 0:
        # Each leaf's update against the yardstick's, which this process's
        # parent wrote after its 2 unsharded steps.
        _signal_wait(tmp, "yard.done", MESH_WAIT_S)
        want, _ = CheckpointManager(os.path.join(tmp, "yard")).restore(
            {"params": snapshot[0]}, 2, device="cpu")
        want = dict(tree_items(want["params"]))
        out["update_l2"] = {}
        for k, got in tree_items(snapshot[0]):
            du, ds = want[k] - p0[k], got - p0[k]
            out["update_l2"][k] = float(torch.linalg.vector_norm(ds - du)
                                        / torch.linalg.vector_norm(du))
        del want, p0
    out["check_s"] = time.perf_counter() - t0
    small = elastic.mesh_from_devices([0, 1], 1, 2)
    t0 = time.perf_counter()
    st = elastic.resize(st, cfg, small, opt_cfg, snapshot=snapshot)
    out["resize_s"] = time.perf_counter() - t0
    out["member"] = st.member
    if st.member:
        flat = dict(tree_items({"p": snapshot[0], "o": snapshot[1]}))
        out["resized_bitwise"] = all(
            torch.equal(t.to_local().cpu(), dt.local_slice(
                flat[k], tuple(t.placements), small))
            for k, t in tree_items({"p": st.params, "o": st.opt_state}))
        step(st, batches[2])
    del snapshot
    pods = make_test_mesh(data=1, model=2, pod=2)
    g = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    pod = pods.get_coordinate()[0]
    grads = {"w": torch.tensor(g[pod:pod + 1], device="cuda")}
    got, err = compressed_psum_pod(grads, init_error(grads), pods, "pod")
    exact = torch.tensor((g[0] + g[1]) / 2)
    out["compress_err"] = float((got["w"][0].cpu() - exact).abs().max())
    out["compress_resid"] = float(err["w"].float().abs().max())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall"] = time.perf_counter() - t_all
    return out


def _mesh_spawn():
    """Start phase 8e's MESH_RANKS gloo ranks (`_mesh_rank`) with a fresh
    temporary directory. -> (procs, tmp); `_shard_stop` ends them."""
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="model_mesh_")
    procs = mp.start_processes(_mesh_rank, args=(MESH_RANKS, tmp),
                               nprocs=MESH_RANKS, join=False,
                               start_method="spawn")
    return procs, tmp


def mesh_check_ranks(ranks, yard, per_step, tag):
    """Phase 8e's checks of the 2 x 2 -> 1 x 2 ranks' results
    (`_mesh_rank_work`, rank order) against the unsharded losses `yard`
    and launches `per_step`; logs each rank's numbers."""
    for r, res in enumerate(ranks):
        steps = res["steps"]
        require(len(steps) == (3 if r < 2 else 2),
                f"8e {tag} rank {r}: {len(steps)} steps")
        for i, s_ in enumerate(steps):
            rel = abs(s_["loss"] - yard[i]) / abs(yard[i])
            require(rel <= MESH_LOSS_RTOL, f"8e {tag} rank {r} step "
                    f"{i + 1}: loss {s_['loss']:.6f} vs {yard[i]:.6f}, "
                    f"{rel:.3e}")
            require(s_["launches"] == per_step, f"8e {tag} rank {r} step "
                    f"{i + 1}: launches {s_['launches']} != {per_step}")
        require(res["bytes"] == res["rule_bytes"], f"8e {tag} rank {r}: "
                f"{res['bytes']} state bytes, the rules {res['rule_bytes']}")
        require(res["digest"] == ranks[0]["digest"],
                f"8e {tag} rank {r}: gathered state differs from rank 0's")
        require(res["member"] == (r < 2), f"8e {tag} rank {r}: membership")
        if r < 2:
            require(res["resized_bitwise"], f"8e {tag} rank {r}: the 1 x 2 "
                    f"blocks differ from the gathered state")
        require(res["compress_err"] < MESH_COMPRESS_TOL
                and res["compress_resid"] < MESH_COMPRESS_TOL,
                f"8e {tag} rank {r}: compression error "
                f"{res['compress_err']:.3e}, residual "
                f"{res['compress_resid']:.3e}")
        log(f"[train 8e] {tag} rank {r}: losses "
            + ", ".join(f"{s_['loss']:.6f}" for s_ in steps)
            + " (unsharded " + ", ".join(f"{y:.6f}" for y in yard)
            + "), walls " + ", ".join(f"{s_['wall']:.3f}" for s_ in steps)
            + " s, gathered "
            + ", ".join(f"{s_['gather_bytes'] / 1e9:.3f}" for s_ in steps)
            + " GB and reduced "
            + ", ".join(f"{s_['reduce_bytes'] / 1e9:.3f}" for s_ in steps)
            + f" GB a step, state {res['bytes'] / 1e9:.4f} GB (rules "
            f"{res['rule_bytes'] / 1e9:.4f}), set-up {res['setup_s']:.2f} s, "
            f"state gather {res['gather_s']:.2f} s, rank 0's update check "
            f"{res['check_s']:.2f} s, resize {res['resize_s']:.2f} s, "
            f"peak {res['peak_gib']:.2f} GiB, compression error "
            f"{res['compress_err']:.3e} residual "
            f"{res['compress_resid']:.3e}, wall {res['wall']:.2f} s")
    l2 = sorted(ranks[0]["update_l2"].items(), key=lambda kv: -kv[1])
    require(l2[0][1] <= MESH_UPDATE_L2, f"8e {tag}: {l2[0][0]}'s update "
            f"{l2[0][1]:.3e} relative L2 from the unsharded one")
    log(f"[train 8e] {tag} (2 x 2 -> 1 x 2): each leaf's update within "
        f"{l2[0][1]:.3e} relative L2 of the unsharded steps' (worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in l2[:3])
        + f"; median {statistics.median(v for _, v in l2):.3e} over "
        f"{len(l2)} leaves); ranks bitwise")


def phase_train_mesh(np, torch, mesh_ranks):
    """Phase 8e: training stablelm-3b at full width and MESH_LAYERS layers
    on a model mesh, against this process's unsharded step (the
    yardstick, run once): a world-1 NCCL mesh here, MESH_RANKS gloo ranks
    on the one card (`_mesh_rank`). Returns this process's launches."""
    import pickle

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init, tree_items
    from repro_torch.runtime import elastic
    from repro_torch.runtime.checkpoint import CheckpointManager
    t_phase = time.perf_counter()
    procs, tmp = mesh_ranks
    cfg, opt_cfg, batches = _mesh_cfg(), _mesh_opt(), _mesh_batches()
    L = cfg.num_layers
    per_step = {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L}
    # The ranks start now, beside the yardstick and the NCCL steps.
    pathlib.Path(tmp, "go").touch()
    totals = {}
    counted = _counter(torch, totals)

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    p = tf.init_params(cfg, seed=MESH_SEED, device="cuda")
    o = adamw_init(p, opt_cfg)
    p_n, o_n = clone(p), clone(o)
    step = make_train_step(cfg, opt_cfg)
    yard = []
    for batch in batches[:2]:
        (p, o, loss), got, ms = counted(lambda: step(p, o, batch))
        require(got == per_step, f"8e unsharded launches {got} != "
                f"{per_step}")
        yard.append(loss)
        log(f"[train 8e] unsharded step: loss {loss:.6f}, {ms:.1f} ms, "
            f"launches {got}")

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl"), 1), rank=0, world_size=1)
    try:
        st = elastic.build(cfg, make_test_mesh(1, 1), p_n, o_n, opt_cfg)
        del p_n, o_n
        for i, batch in enumerate(batches[:2]):
            (st.params, st.opt_state, loss), got, ms = counted(
                lambda: st.step_fn(st.params, st.opt_state, batch))
            require(got == per_step, f"8e NCCL x1 launches {got} != "
                    f"{per_step}")
            require(loss == yard[i], f"8e NCCL x1 step {i + 1}: loss "
                    f"{loss!r} != unsharded {yard[i]!r}")
            log(f"[train 8e] NCCL world 1 step {i + 1}: loss {loss:.6f} "
                f"(bitwise), {ms:.1f} ms, launches {got}")

        def bitwise(st, what):
            want = dict(tree_items({"p": p, "m": o["m"], "v": o["v"]}))
            got = dict(tree_items({"p": st.params, "m": st.opt_state["m"],
                                   "v": st.opt_state["v"]}))
            bad = [k for k in want if not torch.equal(got[k].to_local(),
                                                      want[k])]
            require(not bad, f"8e NCCL x1 {what}: {len(bad)} leaves differ "
                    f"from the unsharded step's, first {bad[:3]}")
            require(int(st.opt_state["step"].to_local()) == int(o["step"]),
                    f"8e NCCL x1 {what}: the step counter differs")

        bitwise(st, "after 2 steps")
        t0 = time.perf_counter()
        st = elastic.resize(st, cfg, elastic.mesh_from_devices([0], 1, 1),
                            opt_cfg)
        bitwise(st, "after resize")
        log(f"[train 8e] NCCL world 1: p, m, v bitwise the unsharded "
            f"step's after 2 steps and after resize "
            f"({time.perf_counter() - t0:.2f} s)")
        del st
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    ckpt = CheckpointManager(os.path.join(tmp, "yard"), keep=1)
    ckpt.save(2, {"params": p}, blocking=True)
    # The manager makes its directory at once; the signal is a file of
    # its own, written once the checkpoint is complete.
    pathlib.Path(tmp, "yard.done").touch()
    log(f"[train 8e] the yardstick's params after 2 steps written for the "
        f"ranks ({ckpt.timings[-1]['bytes'] / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.2f} s)")
    (p, o, loss), got, ms = counted(lambda: step(p, o, batches[2]))
    require(got == per_step, f"8e unsharded launches {got} != {per_step}")
    yard.append(loss)
    del p, o
    torch.cuda.empty_cache()

    t_gloo = time.perf_counter()
    while not procs.join(timeout=1.0):
        pass
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    mesh_check_ranks(ranks, yard, per_step, f"gloo x{MESH_RANKS}")
    log(f"[train 8e] {time.perf_counter() - t_gloo:.2f} s waited for the "
        f"ranks; phase wall {time.perf_counter() - t_phase:.2f} s")
    return totals


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    wall0 = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    return _run_phases(np, torch, smi, wall0)


def _run_phases(np, torch, smi, wall0):
    fleets = phase_fleet()
    recs = {"dr_features": phase_dr_features(np, torch),
            "al_step": phase_al_step(np, torch, fleets),
            "al_step_lanes": phase_al_step_lanes(np, torch, fleets[0]),
            "rmsnorm": phase_rmsnorm(torch),
            "flash_attention": phase_flash_attention(torch),
            "ssd_scan": phase_ssd_scan(torch),
            "ssd_scan_bwd": phase_ssd_scan_bwd(torch)}
    log("[check] kernels held against their plain versions on the card: "
        + ", ".join(recs))
    del recs["al_step_lanes"]
    launches = phase_main_path(np, torch, fleets[0])
    for name, n in phase_streaming(np, torch, *fleets).items():
        launches[name] += n
    for name, n in phase_lanes(np, torch, *fleets).items():
        launches[name] += n
    for name, n in phase_policies(np, torch, fleets[0]).items():
        launches[name] += n
    p_regions = phase_region_fleet()
    shard_ranks = _shard_spawn(fleets[0], p_regions)
    try:
        for phase in (phase_regions, phase_region_lanes):
            for name, n in phase(np, torch, fleets[0], p_regions).items():
                launches[name] += n
        for name, n in phase_fleet_sharding(np, torch, fleets[0], p_regions,
                                            shard_ranks).items():
            launches[name] += n
    finally:
        _shard_stop(shard_ranks)
    for path in SERVE_PATHS[:MOE_SERVE] + SERVE_PATHS[MOE_SERVE + 1:]:
        for name, n in phase_serve(np, torch, *path).items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()        # one model resident at a time
    for phase in (phase_whisper, phase_dense_options):
        for name, n in phase(np, torch).items():
            launches[name] += n
        torch.cuda.empty_cache()
    for name, n in phase_observability(np, torch, fleets[0]).items():
        launches[name] += n
    mesh_ranks = _mesh_spawn()
    try:
        phase_train_grads(np, torch)
        for name, n in phase_train(np, torch).items():
            launches[name] += n
        for name, n in phase_train_whisper(np, torch).items():
            launches[name] += n
        torch.cuda.empty_cache()
        for name, n in phase_train_ssm(np, torch).items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
        for name, n in phase_train_mesh(np, torch, mesh_ranks).items():
            launches[name] += n
    finally:
        _shard_stop(mesh_ranks)
    torch.cuda.empty_cache()
    # 6d and then 6e run last, so that the phases before them run as
    # they did before 6d was added: in one run with 6d between 6c and 7,
    # all three profiler traces of 8b's 32-layer train step read one
    # rmsnorm launch short (54 device records lost), which 6d alone
    # before that step did not reproduce.
    for phase in (phase_moe_mla, phase_hybrid):
        for name, n in phase(np, torch).items():
            launches[name] += n
    kernels = []
    for name, replaces in (
            ("dr_features", "src/repro/kernels/dr_features/kernel.py:26"),
            ("al_step", "src/repro/kernels/al_step/kernel.py:41"),
            ("rmsnorm", "src/repro/kernels/rmsnorm/kernel.py:20"),
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:28"),
            ("ssd_scan", "src/repro/kernels/ssd_scan/kernel.py:24"),
            # The JAX model differentiates its inline scan.
            ("ssd_scan_bwd", "src/repro/models/ssm.py:129")):
        rec = recs[name]
        require(launches.get(name, 0) > 0,
                f"{name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/"
            f"{name.removesuffix('_bwd')}.cu",
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms")})
    log(f"[done] chip_smoke wall {time.perf_counter() - wall0:.2f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
