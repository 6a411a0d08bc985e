#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   for sm_90a and load them; the compiler's registers and spills of each
   instance of both flash kernels, the selective scan, RMSNorm and the
   token synthesis kernel;
3. kernels — each kernel against its plain PyTorch version on the card (the
   token synthesis kernel bit for bit, and against the numpy host path), at
   the main paths' shapes (the MoE path's, the MLA path's flash at q/k width
   192 and v width 128 and its ``kv_norm``, and hubert-xlarge's non-causal
   flash at head dim 80, too) in bf16 and fp32 and on small cases (window /
   softcap / ragged attention at head dims 16 to 256, fully masked rows in
   both dtypes, the CUDA-core kernel at every v band in its big and its
   split grid; RMSNorm at the serve paths' decode calls, a few rows of one
   lane at d 3072, 4096, 2048 and 512; the synthesis kernel at order_mix 0,
   0.85 and 1;
   for the selective scan the main shape with the chunk states, falcon-mamba's
   initial A and dt over 1,024 steps, N of 4, 12, 16 and 64, ragged L, Dm and
   chunk, unaligned rows, an initial state, per-lane A with 2 and 3 rows a
   lane; TF32 off), with the flash kernel each case went through (bf16: the
   tensor-core kernel, fp32: the CUDA-core kernel); the plain flash backward
   fed the tensor-core kernel's (out, lse) against the same backward fed the
   plain forward's, at the main shape; the scan's chunked backward
   against autograd through its plain version; the RMSNorm backward kernel
   (dx and dgamma) against its closed-form plain version at the four main
   paths' shapes in bf16, in fp32, at d = 100 (the scalar kernels in bf16)
   and in both mixes of x and gain dtypes, and its bits equal lane to lane,
   run to run and whatever the lanes launched beside a lane (K lanes
   against each half);
4. main_path — the HPO population trainer: the port's Experiment
   with the random proposer and the vectorized resource manager, training
   K=4 trials as one lane-batched program, first of starcoder2-3b, then of
   falcon-mamba-7b, each at its published widths with depth cut to 4
   layers; the kernels' launch counters, set to 0 before each path and read
   after it, must show that every population step went through each kernel
   its architecture runs (and through no other: the bf16 starcoder2 step
   through the tensor-core flash kernel, never the CUDA-core one; every
   RMSNorm forward's backward through the backward kernel);
   chunked_path — the same two trainers through the fused chunked engine
   (``--chunk-steps 4``, 8 steps a trial: two chunks, each one replay of a
   captured CUDA graph whose batches the synthesis kernel makes on the
   card), beside a per-step flight of the same trials, and a flight of 9
   steps under the in-flight rung rule (boundaries 1 and 3: chunks of 1, 2,
   4 and 2 steps, graphs of 1 and 2 steps in the same pool) beside its
   per-step flight: per-step losses and per-leaf checksums of the final
   state's raw bits equal, one host dispatch a chunk, the wrapper calls at
   capture and the kernel nodes of the replayed chunk's captured graph
   equal to the launches a step makes times the chunk; capture seconds, the graph
   pool, peak memory, the replayed chunk's step time, idle share and device
   time by group;
   streaming_path — the same two trainers through the streaming engines
   (``--lane-refill``), all flights through the Experiment and the
   vectorized manager: a grid of two waves of K trials (2 steps, then 4)
   under the in-flight rung rule (boundary 3, eta 4), offered at once so
   every lease lands at a fixed step, (a) per step, (b) chunked (chunks of
   up to 4, graph replays), (c) chunked with the rule in the chunks
   (``--device-rules``, rule-chunk graphs in the same pool); streaming PBT
   in 3 synchronized rounds, (d) chunked and (e) per step; the grid as two
   batch flights under the rung rule; (h) the ASHA proposer with its
   in-flight rung rule, chunked, promotions offered mid-flight, held to
   every job finished and streamed only.  No flight may die, restart or
   quarantine a job.  (a), (b) and (c) equal in scores,
   steps, cuts and streamed order, bit for bit, (c) in fewer dispatches;
   every lane leased twice or more; (d) and (e) equal per (member, round)
   with a clone and no host checkpoint, each clone's target lane equal in
   raw bits to its donor; a refilled trial rerun as the first lane of a
   fresh batch flight scores the same; no eager training step in a chunked
   flight (wrapper calls: captures and the warm-up step only; the profiler
   over one replayed rule chunk); lane ops timed against their byte
   bounds with the memory each allocates; active lane share, dispatches
   per step, seconds per result, captures and peak reserved memory
   (falcon-mamba's streaming, crash and ring flights at 2 of 64 layers,
   ``MAMBA_ENGINE_LAYERS``: those engines do not depend on depth);
   then the MoE path, qwen3-moe-30b-a3b at its published widths (1 of 48
   layers, K=2, batch 2, seq 1024), through main_path and chunked_path
   (not the streaming, crash or ring phases: those engines do not depend on
   the model), and between them moe — one population step with its MoE
   layer's input recorded: the step under the profiler, the layer's router
   with top-k, sort and dispatch, expert products and combine (each forward
   and backward) under the profiler, the expert products against their
   bound at the card's dense bf16 peak, the share of assignments dropped at
   capacity, peak memory; and a gate: the layer's forward and backward run
   twice give raw-bit-equal y, aux and gradients, and the same input in
   lane 0 and lane 1 the same bits in each lane;
   then the MLA path, deepseek-v2-lite-16b at its published widths (2 of 27
   layers: the dense MLA prefix layer and one MLA + MoE superblock, K=2,
   batch 2, seq 1024), through main_path (7 RMSNorm, 2 tensor-core flash a
   step) and chunked_path, and between them mla — one population step with
   its first MLA layer's input recorded: the step under the profiler, the
   layer's parts (q and latent projections with kv_norm and RoPE; the
   wk_b / wv_b decompression; the flash forward at q/k width 192, v width
   128; the plain flash backward; wo) each under the profiler, the flash
   forward against its bound, peak memory, and the same determinism gate;
4a. sharded_path — the population mesh (``--shard-population``): at world
   1 over NCCL, made in process, starcoder2-3b as in main_path, three
   flights under the rung rule (boundaries 1 and 3) through the Experiment
   and the sharded resource manager — per step, chunked (``--chunk-steps
   4``) and with the rule in the chunks (the 8-step ladder one dispatch) —
   each beside the unsharded engine's flight: scores, cuts, per-step
   losses and the final state's checksums bit-equal, no degraded or dead
   flight, a step's launches the unsharded path's (the chunked flights' in
   the graphs they captured), the rule chunk's graph holding the
   collective's nodes; s a step against main_path's, the gather's ms; then
   two gloo ranks sharing the card, spawned (starcoder2-3b at its published
   widths, 2 layers, 2 lanes a rank): the streaming ladder with host rules
   and a batch flight with the rule in chunks (eager under gloo: a gloo
   collective cannot sit in a CUDA graph) against the unsharded engine
   within 1e-6 with the same decisions (bit equality reported), a clone
   whose donor is on rank 1 and target on rank 0 and a snapshot of a rank-1
   lane restored into rank 0, each bit-equal to its source, timed against
   the lane's 3.43 GB;
5. card_vs_cpu — the same population step on the starcoder2, falcon-mamba,
   qwen3-moe, jamba, deepseek-v2-lite, hubert-xlarge and pixtral-12b smoke
   configs in fp32, once on the card (kernels) and
   once on the CPU (plain versions): losses and parameters agree within
   1e-4 (the parameter leaf with the largest error named), and the card's
   fp32 attention went through the CUDA-core flash kernel only; for the
   MoE configs, the count of top-k assignments the
   card routed differently (reported, not a gate beyond the 1e-4);
5a. train_path — the one-trial driver (``launch/train.py``'s ``build`` and
   step) on starcoder2-3b at its published widths and full depth (30
   layers), bf16, every superblock recomputed in the backward pass
   (``remat="full"``), batch 4, seq 1024: one warm-up and four timed steps
   with the plain kernel versions refused, then one profiled step: a finite
   loss every step, 121 RMSNorm forwards, 61 backwards and 60 tensor-core
   flash forwards a step; s a step, peak memory, device time by group;
   train_checks — at the same widths and 2 layers: remat "full" and "dots"
   bit-equal to "none" over 3 steps (losses, every state leaf), an fp32
   master copy whose bf16 parameters are its cast bit for bit, and a run
   killed by ``--fail-at 6`` (exit 17) and rerun through the CLI's ``main``
   (``resumed from checkpoint at step 4``) whose final checkpoint and last
   loss equal, bit for bit, the step fed batches 0..4 then 4..7 (the JAX
   driver's resume), with every checkpoint write's and restore's seconds and
   bytes; the ``--smoke`` driver (fp32, the CUDA-core flash kernel) card
   against CPU within 1e-4 over 3 steps; ``--legacy-recompile``'s trial
   (``make_trial``) scoring as the serial driver on the shared stream, bit
   for bit; cnn_path — the paper's CNN (``train/cnn.py``) at
   ``train_cnn``'s defaults, dropout 0, card against CPU from the same
   weights: the forward within 1e-4 (cuDNN without TF32), the accuracy of
   each, s an epoch;
5b. serving — ``launch/serve.py``'s continuous-batching loop (``serve_path``)
   on starcoder2-3b (8 slots, 16 requests, prompts up to 64 tokens, 64 new
   tokens, 256 positions), falcon-mamba-7b and deepseek-v2-lite-16b (4 slots,
   4 requests, 16 and 16, 64 positions), each at its published widths and
   full depth in bf16 with the reference's fp32 cache (a smoke load with no
   published source), starcoder2 served at 0.8 once and at temperature 0
   once, the other two at temperature 0 twice: every request
   emits its tokens, the runs at one temperature give the same tokens, every
   decode step launches the RMSNorm
   forward kernel once a norm (61 / 65 / 82) and no other kernel of ours;
   decode steps and tokens a second, the median host seconds a step beside
   the least time of a step (every parameter byte read once at the card's
   memory rate), one profiled decode step by kernel group (idle share)
   and by part (``record_function`` ranges: the reference attention, the
   absorbed MLA, the SSM step, the FFNs, the unembedding), one decode step
   captured in a CUDA graph and replayed (its device time without host
   dispatch), peak memory and the cache's bytes; on deepseek the bytes of
   only the experts the tokens routed to, and the step's shares of the bound
   they give; on starcoder2 and falcon-mamba the prefill form
   (``forward(last_only=True)``: the tensor-core flash kernel, the scan)
   against decode at the prompt's last position (reported, not gated); on
   falcon-mamba the same weights in fp32 at full depth, decode against
   ``forward`` at every prompt position within 1e-3, and the bf16 prefill's
   and decode's logits each against that fp32 forward's (reported);
   serve_vs_forward — starcoder2-3b's published widths in fp32 (4 of 30
   layers): a 64-token prompt decoded a token a step against ``forward``
   (the CUDA-core flash kernel) at every position within 1e-3;
   card_vs_cpu_decode — 8 decode steps of the starcoder2, gemma2, qwen3-moe,
   deepseek-v2-lite, falcon-mamba and jamba smoke configs in fp32 on the
   card and on the CPU: logits and every cache leaf within 1e-4;
6. timing — each kernel, its plain version and the PyTorch library call
   that computes the same function (none for the selective scan), timed
   with CUDA events at the main paths' shapes (the scan as the main path
   calls it, with the chunk states), beside the least time the card could
   take: bytes or operations, and for the scan also its exponentials on the
   special-function units (``sfu_ms``), the bound that binds it; RMSNorm
   and flash also at the MoE path's shapes (``moe_shape``), RMSNorm at
   falcon-mamba's (``mamba_shape``) and MLA's ``kv_norm``
   (``kv_norm_shape``), flash at the MLA path's and at hubert-xlarge's
   shapes (``mla_shape``, ``hubert_shape``), the CUDA-core flash kernel at
   the main shape in fp32 beside SDPA in fp32 with TF32 off, as called and
   with kv expanded to every q head (``fp32_kernel``, and its small MLA
   case graph-replayed too), the synthesis kernel against the latency of
   its longest independent rule chain (``serial_bound_ms`` beside it) and
   graph-replayed (``device_ms``); the RMSNorm forward and
   backward also as ``device_ms``, launches captured in a CUDA graph over
   rotating inputs larger than the L2 and replayed, and the backward's
   ``per_step`` ms on each main path (its cell's shapes, the calls of
   ``rms_widths``) against the autograd backward's that it replaced, both
   eager and graph-replayed; the RMSNorm forward at a starcoder2 decode
   step's call (``decode_shape``, 8 rows).  Each row's launches count every
   path, the serve paths (``+serve``) too.

The ``total`` line holds the wall seconds of each phase.  Every captured
chunk graph keeps its nodes (``population.KEEP_GRAPH_NODES``): the launch
gates of replayed chunks count our kernels among them, not in a profiler
trace, which can drop kernels.

The line before last repeats the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
Without a GPU, or outside a checkout of the repository, the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

EPS = 1e-6
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # fp32 outside the tensor cores
TOL = {"rmsnorm": {"float32": 1e-5, "bfloat16": 3e-2},
       # dx and dgamma; x/gain dtype pairs at bf16's, which one of them has
       "rmsnorm_bwd": {"float32": 5e-5, "bfloat16": 3e-2, "bfloat16/float32": 3e-2,
                       "float32/bfloat16": 3e-2},
       "flash_attention": {"float32": 3e-5, "bfloat16": 3e-2},
       "ssm_scan": {"float32": 1e-4, "bfloat16": 3e-2}}   # on y; h_last always 1e-4
SSM_STATE_TOL = 1e-4
SSM_BWD_TOL = 5e-4
FLASH_BWD_TOL = 3e-2   # bf16 gradients of the plain backward fed either forward

# the main paths, each at its published widths with depth cut: starcoder2-3b
# to 4 of 30 layers, falcon-mamba-7b to 4 of 64
MAIN = dict(arch="starcoder2-3b", n_layers=4, population=4, batch=4, seq=1024, steps=4)
MAMBA = dict(arch="falcon-mamba-7b", n_layers=4, population=4, batch=2, seq=1024, steps=4)
MAMBA_ENGINE_LAYERS = 2   # falcon-mamba's streaming, crash and ring flights: 2 of 64 layers
# the MoE path: qwen3-moe-30b-a3b at its published widths, 1 of 48 layers and
# two lanes (one lane's parameters and moments are 12.45 GB; the AdamW
# temporaries of the stacked experts about 16 GB)
MOE = dict(arch="qwen3-moe-30b-a3b", n_layers=1, population=2, batch=2, seq=1024, steps=4)
# the MLA path: deepseek-v2-lite-16b at its published widths, 2 of 27 layers
# (the dense MLA prefix layer and one MLA + MoE superblock) and two lanes
# (1.085 G parameters a lane; at 3 layers or K=4 the state, gradients and
# AdamW's temporaries of the stacked experts pass the card's memory)
DEEPSEEK = dict(arch="deepseek-v2-lite-16b", n_layers=2, population=2, batch=2, seq=1024,
                steps=4)
PATHS = (MAIN, MAMBA, MOE, DEEPSEEK)
# the fp32 smoke configs held card against CPU; jamba runs every kernel,
# deepseek MLA (q/k wider than v), hubert non-causal attention
CARD_VS_CPU = ("starcoder2-3b", "falcon-mamba-7b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
               "deepseek-v2-lite-16b", "hubert-xlarge", "pixtral-12b")
# the one-trial driver (launch/train.py's build() and step): starcoder2-3b at
# its published widths and full depth (30 layers), bf16, every superblock
# recomputed in the backward pass; one warm-up step, then the timed ones
TRAIN = dict(arch="starcoder2-3b", batch=4, seq=1024, remat="full", warmup=1, timed=4)
# its checks at full width and 2 layers: remat "full" and "dots" against
# "none" and the fp32 master over `steps`; a run killed by --fail-at and
# resumed through the CLI's main
TRAIN_CHECKS = dict(arch="starcoder2-3b", n_layers=2, batch=4, seq=1024, steps=3)
TRAIN_CRASH = dict(steps=8, ckpt_every=4, fail_at=6)   # the checkpoint after step 4
# the --smoke driver card against CPU (fp32: the CUDA-core flash kernel)
TRAIN_SMOKE = dict(arch="starcoder2-3b", batch=2, seq=128, steps=3)
# --legacy-recompile (make_trial) against the serial driver on the shared
# stream at smoke size; warmup_frac x steps whole, as make_trial rounds it
LEGACY = dict(arch="starcoder2-3b", steps=4, batch=2, seq=128)
LEGACY_CONFIGS = (dict(learning_rate=3e-3, warmup_frac=0.5, weight_decay=0.1, b2=0.95,
                       grad_clip=1.0),
                  dict(learning_rate=1e-2, warmup_frac=0.25, weight_decay=0.0, b2=0.99,
                       grad_clip=0.0, n_iterations=2))
# the paper's CNN (train/cnn.py) at train_cnn's defaults (2,048 training and
# 512 test images of 16 x 16, batch 128, conv 16 / 32, fc 64, 3 epochs), at
# dropout 0 so the card and the CPU start from the same weights and draw
# nothing
CNN_CONFIG = dict(dropout=0.0)
CNN_ARCH = {"conv": [[16, 3], [32, 3]], "fc": 64}
# the serving paths: launch/serve.py's loop at published widths and full
# depth, bf16, one lane, an fp32 cache (the reference's).  The traffic is a
# smoke load with no published source: it drives every part of the loop
# (slot refills, both samplers) and its times rank no optimisation.
# starcoder2-3b with 8 slots (16 requests of prompts up to 64 tokens and 64
# new tokens each over 256 positions: 241 decode steps, no cache flush),
# served once at SERVE_TEMPERATURE (the draws seeded from the seed), then once
# at temperature 0, the run timed (its repeats went to make room for the
# one-trial driver's phases; the CPU tests hold the seeded sampler);
# falcon-mamba-7b and deepseek-v2-lite-16b with 4 (29 steps each), at
# temperature 0 twice, so the repeat gate stays on them (their sampling
# and decode loop are starcoder2's code)
SERVE_TEMPERATURE = 0.8
SERVE = (dict(arch="starcoder2-3b", batch=8, requests=16, prompt_len=64, new_tokens=64,
              max_seq=256, temperatures=(SERVE_TEMPERATURE, 0.0)),
         dict(arch="falcon-mamba-7b", batch=4, requests=4, prompt_len=16, new_tokens=16,
              max_seq=64, temperatures=(0.0, 0.0)),
         dict(arch="deepseek-v2-lite-16b", batch=4, requests=4, prompt_len=16, new_tokens=16,
              max_seq=64, temperatures=(0.0, 0.0)))
PROFILED_DECODE_STEPS = 1
# the bf16 serve paths whose prefill (forward(last_only=True): the tensor-core
# flash kernel, the scan) is held against decode on one prompt a slot,
# reported without a gate
PREFILL_CHECKED = ("starcoder2-3b", "falcon-mamba-7b")
# the bf16 serve paths whose weights are also run in fp32 at full depth: the
# fp32 decode held against the fp32 forward at every prompt position, and
# the bf16 prefill's and decode's logits each against the fp32 forward's
# (falcon-mamba's bf16 decode computes its mixer in the fp32 cache's dtype,
# its prefill in bf16)
DTYPE_WITNESS = ("falcon-mamba-7b",)
# the gated decode-against-forward check: starcoder2-3b's published widths in
# fp32 (the CUDA-core flash kernel in forward), 4 of 30 layers, a 64-token
# prompt, every position within 1e-3 (the smoke gate is 1e-4; this leaves
# room for 3072-wide fp32 sums and a 49,152-way unembedding)
SERVE_VS_FORWARD = dict(arch="starcoder2-3b", n_layers=4, prompt=64, tol=1e-3)
# decode_step card against CPU, fp32 smoke configs: every mixer (GQA, a
# window with softcaps, MLA, Mamba, the hybrid) and dropless MoE
DECODE_CARD_VS_CPU = ("starcoder2-3b", "gemma2-9b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
                      "falcon-mamba-7b", "jamba-1.5-large-398b")
DECODE_STEPS, DECODE_BATCH = 8, 2
RMS_DECODE_SHAPES = {"decode-starcoder2": (1, 8, 3072), "decode-falcon-mamba": (1, 4, 4096),
                     "decode-d2048": (1, 4, 2048), "decode-kv-norm": (1, 4, 512)}
RMS_SHAPE = (4, 4096, 3072)                        # (K, B*S, d), gain (K, d)
RMS_MAMBA_SHAPE = (4, 2048, 4096)
RMS_MOE_SHAPE = (2, 2048, 2048)                    # qwen3-moe's and deepseek's d = 2048
RMS_KV_NORM_SHAPE = (2, 2048, 512)                 # MLA's kv_norm over the latent
L2_BYTES = 50e6                                    # H100 L2
FLASH_Q, FLASH_KV = (16, 1024, 24, 128), (16, 1024, 2, 128)   # (K*B, S, heads, D)
FLASH_MOE_Q, FLASH_MOE_KV = (4, 1024, 32, 128), (4, 1024, 4, 128)   # a group of 8
FLASH_MLA_Q, FLASH_MLA_DV = (4, 1024, 16, 192), 128   # q, k 128 + 64 wide; v 128
FLASH_HUBERT_Q = (8, 1024, 16, 80)                 # hubert-xlarge, non-causal, MHA
SSM_X, SSM_N, SSM_K = (8, 1024, 8192), 16, 4      # x, dt (K*B, L, d_inner); A (K, d_inner, N)
SSM_CHUNK = 128                                    # the chunk states SSMScan.forward keeps
SFU_PER_FP32_FLOPS = 16   # an SM's 128 FP32 lanes (256 flop a clock) against 16 exponentials
CHUNK, CHUNK_FLIGHT_STEPS = 4, 8                   # the chunked paths: two chunks of 4 a flight
RUNG_FLIGHT = dict(steps=9, eta=3, min_iter=1)      # rung boundaries 1, 3: chunks of 1, 2, 4, 2
# crash_path: a grid of K trials of 4 and 8 steps (two each) on K lanes, all
# leased at step 0; the event pass at step 4 retires the short ones and
# snapshots the long ones at their local step 4; ``raise@step=5`` kills the
# flight at step 8, before the long ones retire, and the restarted flight
# restores them at step 4 and trains them 4 more steps.  Every chunk is of 4
# steps: one scan graph and one ring graph beside falcon-mamba's state
CRASH = dict(steps=4, fault="raise@step=5,times=1")
CRASH_SPACE = [
    {"name": "n_iterations", "type": "choice", "range": [1, 2]},
    {"name": "learning_rate", "type": "choice", "range": [3e-3, 1e-3]},
]
RING_WINDOWS = 2
# ring_path's refill flight: 4 trials of 4, 4, 8, 8 steps, then two of 4 steps
# refilling lanes 0 and 1 at step 4; no lane idles, so every loss is a trial's
RING_REFILL_ITERS = (1, 1, 2, 2, 1, 1)
# the streaming paths: a grid of two waves of K trials (2 steps, then 4) under
# the in-flight rung rule at lane-local step 3 (eta 4), and PBT in 3 rounds of
# 2 steps; chunks of up to 4
STREAM = dict(steps=2, eta=4.0, min_iter=3, max_iter=4, chunk=4)
STREAM_SPACE = [
    {"name": "n_iterations", "type": "choice", "range": [1, 2]},
    {"name": "learning_rate", "type": "choice", "range": [3e-3, 2e-3, 1e-3, 5e-4]},
    {"name": "warmup_frac", "type": "choice", "range": [0.25]},
]
PBT_FLIGHT = dict(steps=2, rounds=3, quantile=0.25)
# the CLI's --lane-refill --proposer asha --inflight-stop: 2K configs over
# the CLI's search space, rungs of 2, 4 and 8 steps (eta 2)
ASHA_FLIGHT = dict(steps=2, max_iter=4, min_iter=1, eta=2.0)
PBT_SPACE = [
    {"name": "learning_rate", "type": "float", "range": [1e-4, 3e-3], "scale": "log"},
    {"name": "weight_decay", "type": "float", "range": [0.0, 0.2]},
]
# our kernels by the substring of their device name (the fp32 flash kernel's
# name is not a substring of the tensor-core one's, nor the RMSNorm
# forward's of the backward's; the backward's dgamma sum is a second kernel,
# rmsnorm_dgamma_kernel, of the same launch)
KERNEL_NAMES = {"rmsnorm": "rmsnorm_kernel", "rmsnorm_bwd": "rmsnorm_bwd_kernel",
                "flash_attention_sm90": "flash_fwd_sm90_kernel",
                "flash_attention_fp32": "flash_fwd_kernel", "ssm_scan": "ssm_scan_kernel",
                "synth_tokens": "synth_tokens_kernel"}
INT_OF_SIZE = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------- phase 2
PTXAS_INSTANCES = {  # source: (its kernel's instances in the mangled names, label)
    "flash_attention_sm90.cu": (r"flash_fwd_sm90_kernelILi(\d+)E", lambda m: f"width_{m[1]}"),
    # <RM, NJ>: q rows a thread, v chunks of 4 columns a thread
    "flash_attention.cu": (r"flash_fwd_kernel(?:ILi(\d+)ELi(\d+)ELi\d+E)?",
                           lambda m: f"rows_{m[1]}_vchunks_{m[2]}" if m[1] else m[0]),
    "synth_tokens.cu": (r"(synth_tokens_kernel)", lambda m: m[1]),
    # <G, S>: G states a thread, S threads a channel
    "ssm_scan.cu": (r"ssm_scan_kernelI(13__nv_bfloat16|f)((?:Li\d+E)+)",
                    lambda m: "{}<{}>".format("bf16" if m[1] != "f" else "fp32",
                                              ",".join(re.findall(r"\d+", m[2])))),
    # fwd / bwd <x, gain, P>: P 16-byte packs a thread (the scalar kernels not listed)
    "rmsnorm.cu": (r"rmsnorm(_bwd)?_kernelI(13__nv_bfloat16|f)(13__nv_bfloat16|f|S\d*_)Li(\d+)E",
                   lambda m: "{}<{},{},P{}>".format(
                       "bwd" if m[1] else "fwd", "fp32" if m[2] == "f" else "bf16",
                       {"f": "fp32", "13__nv_bfloat16": "bf16"}.get(
                           m[3], "fp32" if m[2] == "f" else "bf16"), m[4])),
}


def ptxas_summary(report: str, source: str) -> dict:
    """Registers, spills and stack of each instance of ``source``'s kernel
    (the tensor-core flash kernel by head-dim width, the CUDA-core one by
    rows and v chunks a thread, the selective scan by dtype and state split,
    RMSNorm by direction, dtypes and packs a thread, the synthesis kernel),
    from nvcc's ``-Xptxas=-v`` report; empty when the
    library was reused.  The flash kernel's registers are those the block
    launches with: ``setmaxnreg`` then moves them from the producer to the
    consumers."""
    pattern, label = PTXAS_INSTANCES[source]
    out, cur = {}, None
    for line in report.splitlines():
        inst = re.search(pattern, line)
        if "Compiling entry function" in line:
            cur = label(inst) if inst else None
            if cur:
                out.setdefault(cur, {})
            continue
        if inst and "Performance Loss" in line:
            msg = line.split("Performance Loss:", 1)[1].split(" for the function")[0]
            out.setdefault(label(inst), {})["warning"] = msg.strip()
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                            spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


# ------------------------------------------------------------------- phase 3
def ssm_inputs(torch, dev, gen, shape, n, k, dtype, h0=False, init=False):
    """Scan inputs as the mixer makes them: x, dt (R, L, Dm) with dt a
    softplus, B, C (R, L, N) in ``dtype``; per-lane A (K, Dm, N) < 0 and D
    (K, Dm) in fp32; an optional fp32 h0 (R, Dm, N).  ``init``: A and dt as
    falcon-mamba starts training, A_n = -(n + 1) and dt log-uniform in
    [1e-3, 1e-1], decays up to 0.999 carried over the whole sequence."""
    import math

    import torch.nn.functional as F

    R, L, Dm = shape
    x = (0.5 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    dt = F.softplus(torch.randn(shape, generator=gen, device=dev) - 1.0).to(dtype)
    A = -torch.exp(0.3 * torch.randn((k, Dm, n), generator=gen, device=dev))
    if init:
        u = torch.rand(shape, generator=gen, device=dev)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))).to(dtype)
        A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(k, Dm, n)
        A = A.contiguous()
    Bc = (0.5 * torch.randn((R, L, n), generator=gen, device=dev)).to(dtype)
    Cc = (0.5 * torch.randn((R, L, n), generator=gen, device=dev)).to(dtype)
    D = 0.2 * torch.randn((k, Dm), generator=gen, device=dev)
    hh = 0.5 * torch.randn((R, Dm, n), generator=gen, device=dev) if h0 else None
    return x, dt, A, Bc, Cc, D, hh


def ssm_backward_case(torch, dev, gen):
    """The autograd function's chunked backward, fed the kernel's chunk
    states, against autograd through the plain version (fp32, ragged last
    chunk, an initial state, two lanes)."""
    from repro_torch.kernels import ssm_scan as ss

    ins = ssm_inputs(torch, dev, gen, (4, 90, 64), 8, 2, torch.float32, h0=True)
    w = torch.randn(ins[0].shape, generator=gen, device=dev)
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    before = ss.launches
    y, h = ss.ssm_scan(*a, chunk=32)
    ((y * w).sum() + h.square().sum()).backward()
    through = ss.launches - before
    y, h = ss.ssm_scan_plain(*b, chunk=32)
    ((y * w).sum() + h.square().sum()).backward()
    torch.cuda.synchronize()
    err = max(float((g.grad - p.grad).abs().max()) for g, p in zip(a, b))
    ok = through == 1 and all(
        bool(torch.allclose(g.grad, p.grad, atol=SSM_BWD_TOL, rtol=SSM_BWD_TOL))
        for g, p in zip(a, b))
    return dict(kernel="ssm_scan", case="chunked-backward", dtype="float32",
                max_abs_err=err, tol=SSM_BWD_TOL, kernel_launches=through, ok=ok)


def rmsnorm_bwd_bits_cases(torch, dev, gen):
    """The RMSNorm backward on two lanes fed the same x, dy and gain, called
    twice: dx and dgamma raw-bit equal lane to lane and run to run (dgamma
    is summed over rows in a fixed order, without atomics)."""
    from repro_torch.kernels import rmsnorm as rn

    cases = []
    for shape, dtype in ((RMS_SHAPE, torch.bfloat16), (RMS_MOE_SHAPE, torch.float32)):
        one = (1,) + shape[1:]
        x, dy = (torch.randn(one, generator=gen, device=dev).to(dtype).expand(2, *one[1:])
                 .contiguous() for _ in range(2))
        g = (0.1 * torch.randn((1, shape[2]), generator=gen, device=dev)).to(dtype).expand(
            2, -1).contiguous()
        first = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
        again = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
        torch.cuda.synchronize()
        runs = all(torch.equal(a, b) for a, b in zip(first, again))
        lanes = all(torch.equal(a[0], a[1]) for a in first)
        cases.append(dict(kernel="rmsnorm_bwd", case="bits-2-lanes-2-runs",
                          dtype=str(dtype).split(".")[-1], shape=[2, *one[1:]],
                          runs_bit_equal=runs, lanes_bit_equal=lanes, ok=runs and lanes))
        del x, dy, g, first, again
        # a population mesh's rank trains K/N of K lanes and plans them as K
        # (``lanes``): K lanes in one launch against each half planned for K
        # (gated: the same bits), and each half planned as its own launch
        # (reported: how far dgamma's order moves it)
        x, dy = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
        g = (0.1 * torch.randn((shape[0], shape[2]), generator=gen, device=dev)).to(dtype)
        whole = rn.rmsnorm_bwd_cuda(x, g, dy, EPS)
        h = shape[0] // 2

        def halves(lanes):
            parts = [rn.rmsnorm_bwd_cuda(x[a:b].contiguous(), g[a:b].contiguous(),
                                         dy[a:b].contiguous(), EPS, lanes=lanes)
                     for a, b in ((0, h), (h, None))]
            return [torch.cat([p[i] for p in parts]) for i in range(2)]

        mesh_plan, own_plan = halves(shape[0]), halves(None)
        torch.cuda.synchronize()
        equal = all(torch.equal(w, m) for w, m in zip(whole, mesh_plan))
        cases.append(dict(kernel="rmsnorm_bwd", case=f"bits-{shape[0]}-lanes-vs-halves",
                          dtype=str(dtype).split(".")[-1], shape=list(shape),
                          lanes_bit_equal=equal,
                          own_plan_dx_bit_equal=torch.equal(whole[0], own_plan[0]),
                          own_plan_dgamma_max_abs_diff=float(
                              (whole[1].float() - own_plan[1].float()).abs().max()),
                          ok=equal))
        del x, dy, g, whole, mesh_plan, own_plan
    return cases


def flash_masked_rows_case(torch, dev, gen, dtype):
    """Rows whose causal window ends before the last key (ragged Sk: window
    32 < Sq - Sk) see no key: the dtype's kernel (bf16: tensor cores, fp32:
    CUDA cores) must write lse = NEG_INF and out = 0 there, and match the
    plain version everywhere."""
    from repro_torch.kernels import flash_attention as fa

    Sq, Sk, window = 200, 130, 32
    q = torch.randn((2, Sq, 4, 64), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, Sk, 2, 64), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, Sk, 2, 64), generator=gen, device=dev).to(dtype)
    kw = dict(causal=True, window=window, softcap=None, scale=0.125)
    counter = "launches_sm90" if dtype == torch.bfloat16 else "launches_fp32"
    before = getattr(fa, counter)
    o, l = fa.flash_fwd_cuda(q, k, v, **kw)
    through = getattr(fa, counter) - before
    po, pl = fa.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    dead = Sk - 1 + window       # first row that no key reaches
    dname = str(dtype).split(".")[-1]
    tol = TOL["flash_attention"][dname]
    err = max(float((o.float() - po.float()).abs().max()), float((l - pl).abs().max()))
    ok = (through == 1 and bool((l[:, :, dead:] == fa.NEG_INF).all())
          and bool((o[:, dead:] == 0).all()) and bool((l[:, :, :dead] > fa.NEG_INF / 2).all())
          and err <= tol)
    return dict(kernel="flash_attention", case="fully-masked-rows", dtype=dname,
                masked_rows=Sq - dead, max_abs_err=err, tol=tol,
                kernel_launches={counter[len("launches_"):]: through}, ok=ok)


def flash_backward_case(torch, dev, gen):
    """The plain blocked backward (the one training runs) fed the tensor-core
    kernel's (out, lse) against the same backward fed the plain forward's, at
    the main shape; dq, dk, dv compared in bf16."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, D = FLASH_Q
    Hkv = FLASH_KV[2]
    q = torch.randn(FLASH_Q, generator=gen, device=dev).bfloat16()
    k = torch.randn(FLASH_KV, generator=gen, device=dev).bfloat16()
    v = torch.randn(FLASH_KV, generator=gen, device=dev).bfloat16()
    dout = torch.randn(FLASH_Q, generator=gen, device=dev).bfloat16()
    kw = dict(causal=True, window=None, softcap=None, scale=D ** -0.5)
    before = fa.launches_sm90
    grads = []
    for fwd in (fa.flash_fwd_cuda, fa.flash_fwd_plain):
        out, lse = fwd(q, k, v, **kw)
        grads.append(ref._blocked_bwd(q, k, v, out, lse.reshape(B, Hkv, H // Hkv, S), dout,
                                      q_offset=0, block_q=fa.BWD_BLOCK, block_kv=fa.BWD_BLOCK,
                                      causal_skip=True, **kw))
        del out, lse
    torch.cuda.synchronize()
    through = fa.launches_sm90 - before
    errs = {n: float((a.float() - b.float()).abs().max())
            for n, a, b in zip(("dq", "dk", "dv"), *grads)}
    ok = through == 1 and all(
        bool(torch.allclose(a.float(), b.float(), atol=FLASH_BWD_TOL, rtol=FLASH_BWD_TOL))
        for a, b in zip(*grads))
    return dict(kernel="flash_attention", case="main-backward-from-kernel-lse", dtype="bfloat16",
                max_abs_err=max(errs.values()), max_abs_err_by_grad=errs, tol=FLASH_BWD_TOL,
                kernel_launches={"sm90": through}, ok=ok)


def synth_cases(torch, dev):
    """The token synthesis kernel against its plain version on the card and
    against the numpy host path, bit for bit: both main paths' shapes with
    real and sentinel streams and per-lane cursors, one shared stream, a
    row longer than one tile of the kernel, and order_mix 0 (no rule chain)
    and 1 (one chain a tile, carried across tiles)."""
    import numpy as np

    from repro_torch.data.pipeline import SyntheticLM, split_streams
    from repro_torch.kernels import synth as sk

    cases = []
    for case, (k, rows, seq, vocab), streams, steps, mix in (
            ("starcoder2-main", (4, MAIN["batch"], MAIN["seq"], 49152), [0, 1, -1, -3], [0, 3, 1, 7],
             0.85),
            ("falcon-mamba-main", (4, MAMBA["batch"], MAMBA["seq"], 65024), [5, 12345, -2, -4],
             [8, 8, 8, 8], 0.85),
            ("shared-stream", (1, 4, 1024, 49152), [0], [6], 0.85),
            ("seq-5000-three-tiles", (2, 3, 5000, 1000), [2, -1], [1 << 33, 4], 0.85),
            ("order-mix-0", (4, 4, 1024, 49152), [0, 1, 2, 3], [0, 0, 5, 9], 0.0),
            ("order-mix-1-three-tiles", (2, 2, 4100, 49152), [0, -1], [1, 1 << 35], 1.0)):
        data = SyntheticLM(vocab, seq, rows, seed=0, order_mix=mix)
        lo, hi = (torch.from_numpy(w.astype(np.int64)).to(dev) for w in split_streams(streams))
        st = torch.tensor(steps, dtype=torch.int64, device=dev)
        before = sk.launches
        got = sk.synth_tokens_cuda(data, st, lo, hi, offset=3)
        through = sk.launches - before
        want = sk.synth_tokens_plain(data, st, lo, hi, offset=3)
        host = data.make_population_batch([t + 3 for t in steps], streams)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        ok = (through == 1 and bool(torch.equal(got, want))
              and bool(np.array_equal(got[..., :-1].cpu().numpy(), host["tokens"]))
              and bool(np.array_equal(got[..., 1:].cpu().numpy(), host["targets"])))
        cases.append(dict(kernel="synth_tokens", case=case, dtype="int32",
                          shape=[k, rows, seq + 1], order_mix=mix, max_abs_err=err, tol=0,
                          kernel_launches=through, ok=ok))
    return cases


def check_kernels(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, errs = [], {}

    def rms(shape, dtype):
        K, _, d = shape
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = (0.1 * torch.randn((K, d), generator=gen, device=dev)).to(dtype)
        return rn.rmsnorm_cuda(x, g, EPS), rn.rmsnorm_plain(x, g, EPS)

    def rms_bwd(shape, dtype, gain_dtype=None):
        """(dx, dgamma) of the backward kernel and of the closed form, flattened."""
        K, _, d = shape
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = (0.1 * torch.randn((K, d), generator=gen, device=dev)).to(gain_dtype or dtype)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got, want = rn.rmsnorm_bwd_cuda(x, g, dy, EPS), rn.rmsnorm_bwd_plain(x, g, dy, EPS)
        return (torch.cat([t.float().flatten() for t in got]),
                torch.cat([t.float().flatten() for t in want]))

    def flash(qs, kvs, dtype, dv=None, **kw):
        """Kernel and plain (out, lse) flattened, and the launches each flash
        kernel made; the scale is 1/sqrt of the q/k width."""
        q = torch.randn(qs, generator=gen, device=dev).to(dtype)
        k = torch.randn(kvs, generator=gen, device=dev).to(dtype)
        v = torch.randn(kvs[:3] + (dv or kvs[3],), generator=gen, device=dev).to(dtype)
        kw = dict(dict(causal=True, window=None, softcap=None), **kw, scale=qs[-1] ** -0.5)
        before = (fa.launches_sm90, fa.launches_fp32)
        o, l = fa.flash_fwd_cuda(q, k, v, **kw)
        through = {"sm90": fa.launches_sm90 - before[0], "fp32": fa.launches_fp32 - before[1]}
        po, pl = fa.flash_fwd_plain(q, k, v, **kw)
        return torch.cat([o.float().flatten(), l.flatten()]), \
            torch.cat([po.float().flatten(), pl.flatten()]), through

    def ssm(shape, n, k, dtype, h0=False, chunk=None, init=False):
        """y, h_last and (with ``chunk``) the chunk states of the kernel and of
        the plain version, flattened (the first x.numel() entries are y, the
        rest the states), x.numel() and the chunk."""
        x, dt, A, Bc, Cc, D, hh = ssm_inputs(torch, dev, gen, shape, n, k, dtype, h0, init)
        kw = dict(chunk=chunk, chunk_states=True) if chunk else {}
        got = ss.ssm_scan_cuda(x, dt, A, Bc, Cc, D, hh, **kw)
        want = ss.ssm_scan_plain(x, dt, A, Bc, Cc, D, hh, **kw)
        return (torch.cat([got[0].float().flatten()] + [t.flatten() for t in got[1:]]),
                torch.cat([want[0].float().flatten()] + [t.flatten() for t in want[1:]]),
                x.numel(), chunk)

    # the cases at the MoE and MLA paths' and hubert's shapes, by the key of
    # their error in the ``kernels`` line's sub-rows
    other_shapes = {("moe-main", "bfloat16"): "moe", ("mla-main", "bfloat16"): "mla",
                    ("mamba-main", "bfloat16"): "mamba",
                    ("hubert-main", "bfloat16"): "hubert", ("kv-norm", "bfloat16"): "kv_norm",
                    ("mla-d192-dv128-ragged-300", "float32"): "mla_ragged",
                    ("main", "float32"): "fp32_main"}
    runs = [
        ("rmsnorm", "main", "bfloat16", lambda: rms(RMS_SHAPE, torch.bfloat16)),
        ("rmsnorm", "mamba-main", "bfloat16", lambda: rms(RMS_MAMBA_SHAPE, torch.bfloat16)),
        ("rmsnorm", "moe-main", "bfloat16", lambda: rms(RMS_MOE_SHAPE, torch.bfloat16)),
        ("rmsnorm", "kv-norm", "bfloat16", lambda: rms(RMS_KV_NORM_SHAPE, torch.bfloat16)),
        ("rmsnorm", "main", "float32", lambda: rms(RMS_SHAPE, torch.float32)),
        ("rmsnorm", "d=100", "float32", lambda: rms((2, 33, 100), torch.float32)),
        ("rmsnorm", "d=100", "bfloat16", lambda: rms((2, 33, 100), torch.bfloat16)),
        ("rmsnorm_bwd", "main", "bfloat16", lambda: rms_bwd(RMS_SHAPE, torch.bfloat16)),
        ("rmsnorm_bwd", "mamba-main", "bfloat16",
         lambda: rms_bwd(RMS_MAMBA_SHAPE, torch.bfloat16)),
        ("rmsnorm_bwd", "moe-main", "bfloat16", lambda: rms_bwd(RMS_MOE_SHAPE, torch.bfloat16)),
        ("rmsnorm_bwd", "kv-norm", "bfloat16",
         lambda: rms_bwd(RMS_KV_NORM_SHAPE, torch.bfloat16)),
        ("rmsnorm_bwd", "main", "float32", lambda: rms_bwd(RMS_SHAPE, torch.float32)),
        ("rmsnorm_bwd", "d=100", "float32", lambda: rms_bwd((2, 33, 100), torch.float32)),
        ("rmsnorm_bwd", "d=100", "bfloat16", lambda: rms_bwd((2, 33, 100), torch.bfloat16)),
        ("rmsnorm_bwd", "d=384", "bfloat16/float32",
         lambda: rms_bwd((2, 40, 384), torch.bfloat16, torch.float32)),
        ("rmsnorm_bwd", "d=384", "float32/bfloat16",
         lambda: rms_bwd((2, 40, 384), torch.float32, torch.bfloat16)),
        ("flash_attention", "main", "bfloat16",
         lambda: flash(FLASH_Q, FLASH_KV, torch.bfloat16)),
        ("flash_attention", "moe-main", "bfloat16",
         lambda: flash(FLASH_MOE_Q, FLASH_MOE_KV, torch.bfloat16)),
        ("flash_attention", "mla-main", "bfloat16",
         lambda: flash(FLASH_MLA_Q, FLASH_MLA_Q, torch.bfloat16, dv=FLASH_MLA_DV)),
        ("flash_attention", "hubert-main", "bfloat16",
         lambda: flash(FLASH_HUBERT_Q, FLASH_HUBERT_Q, torch.bfloat16, causal=False)),
        ("flash_attention", "mla-d192-dv128-ragged-300", "float32",
         lambda: flash((2, 300, 4, 192), (2, 300, 4, 192), torch.float32, dv=128)),
        ("flash_attention", "main", "float32",
         lambda: flash(FLASH_Q, FLASH_KV, torch.float32)),
        ("flash_attention", "window", "float32",
         lambda: flash((2, 256, 4, 64), (2, 256, 2, 64), torch.float32, window=48)),
        ("flash_attention", "softcap", "float32",
         lambda: flash((2, 192, 4, 32), (2, 192, 1, 32), torch.float32, softcap=30.0)),
        ("flash_attention", "ragged-200", "float32",
         lambda: flash((2, 200, 4, 16), (2, 200, 2, 16), torch.float32, window=64,
                       softcap=50.0)),
        # the CUDA-core kernel at every v band (chunks a thread 1, 2, 4, 8),
        # each in its big and its small grid (half the rows a block)
        ("flash_attention", "fp32-d16-big-grid", "float32",
         lambda: flash((2, 1024, 16, 16), (2, 1024, 16, 16), torch.float32, causal=False)),
        ("flash_attention", "fp32-d64-softcap-big-grid", "float32",
         lambda: flash((4, 512, 8, 64), (4, 512, 2, 64), torch.float32, softcap=30.0)),
        ("flash_attention", "fp32-d80-hubert-big-grid", "float32",
         lambda: flash((8, 300, 16, 80), (8, 300, 16, 80), torch.float32, causal=False)),
        ("flash_attention", "fp32-d256-big-grid", "float32",
         lambda: flash((2, 512, 8, 256), (2, 512, 2, 256), torch.float32)),
        ("flash_attention", "fp32-d256-window-softcap-sk200", "float32",
         lambda: flash((1, 300, 4, 256), (1, 200, 2, 256), torch.float32, window=96,
                       softcap=50.0)),
        ("flash_attention", "fp32-d48-dv240-sq130-sk77", "float32",
         lambda: flash((1, 130, 2, 48), (1, 77, 1, 48), torch.float32, dv=240, causal=False)),
        ("flash_attention", "fp32-sq40-under-a-tile", "float32",
         lambda: flash((2, 40, 4, 64), (2, 40, 2, 64), torch.float32)),
        ("flash_attention", "ragged-200", "bfloat16",
         lambda: flash((2, 200, 4, 16), (2, 200, 2, 16), torch.bfloat16)),
        ("flash_attention", "d96-ragged-200", "bfloat16",
         lambda: flash((2, 200, 32, 96), (2, 200, 32, 96), torch.bfloat16)),
        ("flash_attention", "d256-window-softcap", "bfloat16",
         lambda: flash((2, 300, 8, 256), (2, 300, 4, 256), torch.bfloat16, window=96,
                       softcap=50.0)),
        ("flash_attention", "dv64-d128-sq200-sk130", "bfloat16",
         lambda: flash((1, 200, 4, 128), (1, 130, 2, 128), torch.bfloat16, dv=64,
                       causal=False)),
        ("ssm_scan", "main", "bfloat16",
         lambda: ssm(SSM_X, SSM_N, SSM_K, torch.bfloat16)),
        ("ssm_scan", "main", "float32",
         lambda: ssm(SSM_X, SSM_N, SSM_K, torch.float32)),
        ("ssm_scan", "ragged-100-N4-h0-2lanes", "float32",
         lambda: ssm((4, 100, 200), 4, 2, torch.float32, h0=True)),
        ("ssm_scan", "ragged-100-N4-h0-2lanes", "bfloat16",
         lambda: ssm((4, 100, 200), 4, 2, torch.bfloat16, h0=True)),
        # the redesigned kernel's edges: chunk states, splits of N, ragged tiles
        ("ssm_scan", "main-chunk-states-128", "bfloat16",
         lambda: ssm(SSM_X, SSM_N, SSM_K, torch.bfloat16, chunk=128)),
        ("ssm_scan", "long-horizon-init-L1024-N16", "float32",
         lambda: ssm((4, 1024, 256), 16, 2, torch.float32, chunk=128, init=True)),
        ("ssm_scan", "N64-h0", "float32",
         lambda: ssm((2, 200, 128), 64, 1, torch.float32, h0=True, chunk=64)),
        ("ssm_scan", "N12-split-pads", "float32",
         lambda: ssm((4, 300, 192), 12, 2, torch.float32, chunk=128)),
        ("ssm_scan", "N12-split-pads", "bfloat16",
         lambda: ssm((4, 300, 192), 12, 2, torch.bfloat16, h0=True, chunk=128)),
        ("ssm_scan", "Dm100-unaligned-rows", "bfloat16",
         lambda: ssm((4, 77, 100), 16, 2, torch.bfloat16, chunk=32)),
        ("ssm_scan", "L1000-chunk50", "bfloat16",
         lambda: ssm((2, 1000, 256), 16, 1, torch.bfloat16, chunk=50)),
        ("ssm_scan", "L1000-chunk128", "float32",
         lambda: ssm((2, 1000, 256), 16, 2, torch.float32, chunk=128)),
        ("ssm_scan", "3-rows-a-lane", "float32",
         lambda: ssm((6, 130, 320), 16, 2, torch.float32, h0=True, chunk=64)),
        # RMSNorm at jamba's d 8192, and at d 6144 with an fp32 gain: 2 row
        # groups a block (enough rows), a gain and a fold of 48 KB or more of
        # shared memory (last, so the cases above keep their inputs)
        ("rmsnorm", "d=8192", "bfloat16", lambda: rms((2, 2048, 8192), torch.bfloat16)),
        ("rmsnorm_bwd", "d=8192", "bfloat16", lambda: rms_bwd((2, 2048, 8192), torch.bfloat16)),
        ("rmsnorm_bwd", "d=6144", "bfloat16/float32",
         lambda: rms_bwd((1, 4096, 6144), torch.bfloat16, torch.float32)),
    ]
    # the serve paths' calls: one lane, a few rows (the decode slots) a call
    runs += [("rmsnorm", case, str(dtype).split(".")[-1],
              lambda shape=shape, dtype=dtype: rms(shape, dtype))
             for case, shape in RMS_DECODE_SHAPES.items()
             for dtype in (torch.bfloat16, torch.float32)]
    other_shapes[("decode-starcoder2", "bfloat16")] = "decode"
    for name, case, dtype, run in runs:
        got, want, *split = run()
        torch.cuda.synchronize()
        tol = TOL[name][dtype]
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        row = dict(kernel=name, case=case, dtype=dtype, max_abs_err=err, tol=tol)
        if name == "flash_attention":  # one launch, of the dtype's kernel
            through = split.pop()
            want_through = ({"sm90": 1, "fp32": 0} if dtype == "bfloat16"
                            else {"sm90": 0, "fp32": 1})
            ok = ok and through == want_through
            row["kernel_launches"] = through
        if split:  # the scan: y at the dtype's tolerance, h_last (and hs) at 1e-4
            n_y = split[0]
            err = float(d[:n_y].max())
            ok = bool(torch.allclose(got[:n_y], want[:n_y], atol=tol, rtol=tol)) and bool(
                torch.allclose(got[n_y:], want[n_y:], atol=SSM_STATE_TOL, rtol=SSM_STATE_TOL))
            row.update(max_abs_err=err, h_last_max_abs_err=float(d[n_y:].max()),
                       h_last_tol=SSM_STATE_TOL)
            if split[1]:  # the states compared include those entering each chunk
                row["chunk"] = split[1]
        cases.append(dict(row, ok=ok))
        if dtype == "bfloat16" and (case == "main" and name != "ssm_scan"
                                    or case == "main-chunk-states-128"):
            errs[name] = err   # at the main path's call (the scan's keeps chunk states)
        if (case, dtype) in other_shapes:
            errs[f"{name}@{other_shapes[case, dtype]}"] = err
        del got, want, d
    cases.extend(synth_cases(torch, dev))
    errs["synth_tokens"] = max(c["max_abs_err"] for c in cases if c["kernel"] == "synth_tokens")
    cases.extend(flash_masked_rows_case(torch, dev, gen, dt)
                 for dt in (torch.bfloat16, torch.float32))
    cases.append(flash_backward_case(torch, dev, gen))
    cases.append(ssm_backward_case(torch, dev, gen))
    cases.extend(rmsnorm_bwd_bits_cases(torch, dev, gen))
    emit({"phase": "kernels", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        die(f"kernels disagree with their plain versions: {bad}")
    return errs


# ------------------------------------------------------------------- phase 4
def reset_counters() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import synth as sk

    for mod in (fa, rn, ss, sk):
        mod.reset_launches()


def counters() -> dict:
    """The kernels' launch counters, by kernel; the two flash kernels apart
    (bf16 on the tensor cores, fp32 on the CUDA cores)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import synth as sk

    return {"rmsnorm": rn.launches, "rmsnorm_bwd": rn.launches_bwd,
            "flash_attention_sm90": fa.launches_sm90,
            "flash_attention_fp32": fa.launches_fp32, "ssm_scan": ss.launches,
            "synth_tokens": sk.launches}


def rms_widths(cfg) -> dict:
    """RMSNorm calls one population step of ``cfg`` makes, by row width:
    before the mixer, before the FFN (if the layer has one), after each with
    ``post_norm`` and once at the end, at d_model; on the latent of each MLA
    layer (``kv_norm``), at kv_lora_rank."""
    layers = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
    widths = {cfg.d_model: 1 + sum((1 + (ffn != "none")) * (1 + bool(cfg.post_norm))
                                   for _, ffn in layers)}
    mla = sum(m == "attn_mla" for m, _ in layers)
    if mla:
        widths[cfg.kv_lora_rank] = widths.get(cfg.kv_lora_rank, 0) + mla
    return widths


def launches_per_step(cfg, chunked: bool = False) -> dict:
    """Kernel launches one population step of ``cfg`` makes: the RMSNorms of
    ``rms_widths``, each forward with its backward; one flash launch per
    attention layer (MLA's too), of the tensor-core kernel in bf16 and of
    the CUDA-core kernel in fp32; one scan per Mamba layer; one token
    synthesis in a chunk (the per-step path feeds host batches)."""
    layers = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
    rms = sum(rms_widths(cfg).values())
    attn = sum(m.startswith("attn") for m, _ in layers)
    bf16 = cfg.compute_dtype == "bfloat16"
    return {"rmsnorm": rms, "rmsnorm_bwd": rms,
            "flash_attention_sm90": attn if bf16 else 0,
            "flash_attention_fp32": 0 if bf16 else attn,
            "ssm_scan": sum(m == "mamba" for m, _ in layers),
            "synth_tokens": int(chunked)}


def path_config(arch, n_layers, **_):
    """A main path's model: the published config with its depth cut."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def main_path(torch, dev, arch, n_layers, population, batch, seq, steps, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.job import JobStatus
    from repro_torch.launch.hpo import SPACE, PopulationTrial

    full = get_config(arch)
    overrides = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
                 if f.name != "name"}
    overrides["n_layers"] = n_layers
    trial = PopulationTrial(arch, steps, batch, seq, seed, population=population,
                            model_overrides=overrides, device=dev)
    exp = Experiment({"proposer": "random", "parameter_config": SPACE,
                      "n_samples": population, "n_parallel": population,
                      "target": "max", "random_seed": seed, "resource": "vectorized"},
                     trial)
    jobs = []
    exp.add_result_callback(jobs.append)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    best = exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()

    tc, _ = trial._setup()
    cfg = tc.model
    per_step = launches_per_step(cfg)
    scores = [None if j.result is None else j.result.score for j in jobs]
    widths = ({"d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state, "dt_rank": cfg.dt_rank,
               "ssm_conv": cfg.ssm_conv} if cfg.has_mamba else
              {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
               "head_dim": cfg.head_dim, "d_ff": cfg.d_ff})
    if any(m == "attn_mla" for m, _ in cfg.prefix_pattern + cfg.pattern):
        widths.update(kv_lora_rank=cfg.kv_lora_rank, rope_head_dim=cfg.rope_head_dim)
    if cfg.has_moe:
        widths.update(n_experts=cfg.n_experts, moe_top_k=cfg.moe_top_k,
                      moe_d_ff=cfg.moe_d_ff, capacity_factor=cfg.capacity_factor,
                      n_shared_experts=cfg.n_shared_experts)
    out = {
        "phase": "main_path", "arch": arch, "n_layers": cfg.n_layers,
        "published_n_layers": full.n_layers, "d_model": cfg.d_model, **widths,
        "vocab_size": cfg.vocab_size, "tie_embeddings": cfg.tie_embeddings,
        "param_dtype": cfg.param_dtype,
        "population": population, "batch": batch, "seq": seq, "steps_per_trial": steps,
        "population_steps": trial.n_train_steps, "flight_steps": trial.last_flight_steps,
        "jobs": len(jobs), "statuses": [j.status.name for j in jobs], "scores": scores,
        "best_score": best["score"], "launches": launches,
        "launches_per_step": per_step, "wall_s": wall,
        "flight_s_per_step": trial.per_rung_step_time_s[-1][2]
        if trial.per_rung_step_time_s else None,
    }
    del exp, trial
    gc.collect()
    torch.cuda.empty_cache()
    out.update(steady_state_step(torch, dev, tc, batch, seq, population))
    out["steady_launches"] = out["profile"].pop("launches")
    emit(out)
    problems = []
    if len(jobs) != population or any(j.status != JobStatus.FINISHED for j in jobs):
        problems.append("not every trial finished")
    if out["flight_steps"] != steps or out["population_steps"] != steps:
        problems.append("the flight did not train every lane's budget")
    if not any(s is not None and s == s and abs(s) < 1e8 for s in scores):
        problems.append("no finite score")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            problems.append(f"{name}: {launches[name]} launches, want {n} x {steps}")
        if out["steady_launches"][name] != n:
            problems.append(f"{name}: {out['steady_launches'][name]} launches in the "
                            f"profiled step, want {n}")
    if problems:
        die(f"main path {arch}: " + "; ".join(problems))
    return launches, out


def steady_state_step(torch, dev, tc, batch, seq, population, warmup=1, timed=3):
    """Time population steps of the main-path model after a warm-up step, on
    device-resident batches (host clock around synchronize)."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train.population import (init_population_state,
                                              make_population_train_step)

    data = SyntheticLM(tc.model.vocab_size, seq, batch, seed=0)
    torch.cuda.reset_peak_memory_stats()
    pstate = init_population_state(torch.Generator(device=dev).manual_seed(0), tc,
                                   population, dev)
    n = warmup + timed
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=n), tc)]
                       * population, dev)
    step = make_population_train_step(tc, per_trial_batch=True)
    streams = list(range(population))
    batches = [to_device(data.make_population_batch(t, streams), dev) for t in range(n)]
    for t in range(warmup):
        pstate, _ = step(pstate, batches[t], hp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(warmup, n):
        pstate, m = step(pstate, batches[t], hp)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated()
    tokens = population * batch * seq
    prof = profile_step(torch, lambda: step(pstate, batches[-1], hp))
    del pstate, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"steady_s_per_step": per_step, "steady_tokens_per_s": tokens / per_step,
            "peak_memory_gib": peak / 2 ** 30, "profile": prof}


KERNEL_GROUPS = (  # (group, substrings of the device kernel's name)
    ("flash_attention_fwd (ours)", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("rmsnorm (ours)", ("rmsnorm_kernel",)),
    ("rmsnorm_bwd (ours)", ("rmsnorm_bwd_kernel", "rmsnorm_dgamma_kernel")),
    ("ssm_scan (ours)", ("ssm_scan_kernel",)),
    ("synth_tokens (ours)", ("synth_tokens_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / fill", ("memcpy", "memset", "copy", "fill")),
)


def profile_step(torch, fn, top=12):
    """Device time of one call of ``fn`` (a steady population step, or one
    replayed chunk) by kernel, from ``torch.profiler``; the device's busy and
    idle share of its wall time.  The trace holds two calls of ``fn`` with a
    marker kernel between them, and only the kernels that start after the
    marker are counted: the device trace can miss kernels of the first
    milliseconds after it starts, so the first call takes that loss.
    Reports no split where the trace holds no device time after the
    marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kernels = {}

    def ready(prof):
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               # the schedule's step annotation spans the whole step on the device too
               and not e.name.startswith("ProfilerStep")]
        marks = [e.time_range.start for e in evs if "spin_kernel" in e.name]
        if not marks:
            return
        for e in evs:
            if e.time_range.start > marks[-1] and "spin_kernel" not in e.name:
                ms, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=0, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)   # the marker: counting starts after it
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counters()
        prof.step()
    rows = sorted(((name, ms, c) for name, (ms, c) in kernels.items()), key=lambda r: -r[1])
    seen = {name: sum(c for key, _, c in rows if sub in key)
            for name, sub in KERNEL_NAMES.items()}
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        return {"wall_ms": wall_ms, "device_ms": None, "launches": launches,
                "kernel_launches_seen": seen, "note": "no device time in the trace"}
    groups = {}
    for name, ms, _ in rows:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": max(0.0, 1 - busy / wall_ms),
            "launches": launches, "kernel_launches_seen": seen,
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, ms, c in rows[:top]]}


def graph_kernels(P, kind, chunk, mode=None, shape=None) -> dict:
    """Our kernels' launches in one replay of the captured chunk graph of
    ``kind``, ``chunk`` (and rule ``mode``, rule or ring ``shape``), by
    kernel: the graph's nodes whose text names the kernel (``KERNEL_NAMES``),
    counted in the graph itself (``population.KEEP_GRAPH_NODES``), so a
    profiler trace that drops kernels cannot change the count."""
    found = [g for g in P.graph_stats(nodes=True)
             if g["kind"] == kind and g["chunk"] == chunk and g["mode"] == mode
             and (shape is None or g["shape"] == shape)]
    if len(found) != 1 or not found[0]["nodes"]:
        die(f"no single captured {kind} graph of {chunk} steps with its nodes kept: "
            f"{[(g['kind'], g['mode'], g['chunk'], g['shape']) for g in found]}")
    nodes = found[0]["nodes"]
    return {name: sum(sub in node for node in nodes) for name, sub in KERNEL_NAMES.items()}


# ---------------------------------------------------------- phase 4, chunked
def state_checksums(torch, pstate) -> list:
    """Per leaf of a population state, the sum of its raw bits read as
    integers (int64), in 16M-element pieces: equal sums leaf by leaf stand
    for equal states bit for bit."""
    from repro_torch.interop import tree_leaves

    out = []
    for t in tree_leaves(pstate):
        raw = t.detach().reshape(-1)
        raw = (raw.to(torch.uint8) if raw.dtype == torch.bool
               else raw.view(getattr(torch, INT_OF_SIZE[raw.element_size()])))
        acc = torch.zeros((), dtype=torch.int64, device=raw.device)
        for part in raw.split(1 << 24):
            acc += part.sum(dtype=torch.int64)
        out.append(int(acc))
    return out


def run_flight(torch, dev, arch, n_layers, population, batch, seq, steps, chunk_steps, seed=0,
               rungs=False, data_ring=False, device_rules=False, sharded=False):
    """One flight of the Experiment (random proposer, vectorized resource
    manager) at ``chunk_steps``, recording its per-step losses and the
    checksums of its final state; with ``rungs`` under the in-flight rung
    rule of ``RUNG_FLIGHT`` (with ``device_rules`` carried in the chunks);
    with ``data_ring`` fed from the prefetch ring (``RING_WINDOWS``
    windows); with ``sharded`` through the sharded resource manager on the
    population mesh this process made.  The launch counters are set to 0
    just before it and read just after."""
    from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving
    from repro_torch.configs import get_config
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.job import JobStatus
    from repro_torch.launch.hpo import SPACE, PopulationTrial

    full = get_config(arch)
    overrides = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
                 if f.name != "name"}
    overrides["n_layers"] = n_layers
    trial = PopulationTrial(arch, steps, batch, seq, seed, population=population,
                            model_overrides=overrides, device=dev, chunk_steps=chunk_steps,
                            data_ring=data_ring, ring_windows=RING_WINDOWS,
                            device_rules=device_rules)
    if rungs:
        trial.early_stop = InFlightSuccessiveHalving(
            eta=RUNG_FLIGHT["eta"], min_iter=RUNG_FLIGHT["min_iter"], max_iter=steps)
    record = []
    trial.record_flight = lambda ls, ps: record.append((ls, state_checksums(torch, ps)))
    exp = Experiment({"proposer": "random", "parameter_config": SPACE,
                      "n_samples": population, "n_parallel": population,
                      "target": "max", "random_seed": seed,
                      "resource": "sharded" if sharded else "vectorized"},
                     trial)
    jobs = []
    exp.add_result_callback(jobs.append)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"chunk_steps": chunk_steps, "wall_s": wall, "launches": counters(),
           "degraded_flights": getattr(exp.rm, "n_degraded_flights", 0),
           "flight_deaths": exp.rm.n_flight_deaths,
           "dispatches": trial.n_dispatches, "train_steps": trial.n_train_steps,
           "dispatches_per_step": trial.n_dispatches / max(1, trial.n_train_steps),
           "flight_s_per_step": trial.per_rung_step_time_s[-1][2]
           if trial.per_rung_step_time_s else None,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "finished": len(jobs) == population and all(
               j.status == JobStatus.FINISHED for j in jobs),
           "scores": [None if j.result is None else j.result.score for j in jobs],
           "errors": [j.result.error for j in jobs
                      if j.status != JobStatus.FINISHED and j.result is not None],
           "truncated_lanes": trial.early_stop.n_truncated if rungs else None,
           "ring": ring_stats(trial) if data_ring else None}
    tc, data = trial._setup()
    del exp, trial
    losses, sums = record[0] if record else (None, None)
    return out, losses, sums, tc, data


def chunked_path(torch, dev, arch, n_layers, population, batch, seq, steps=CHUNK_FLIGHT_STEPS,
                 chunk=CHUNK, seed=0, per_step_steady=None):
    """The population trainer through the fused chunked engine beside
    per-step flights of the same trials: two flights of each (the second
    per-step flight without the process's first-call set-up, the second
    chunked flight initialised into the captured state and replaying the
    graph captured by the first), one of each under the rung rule (its
    chunked flight captures graphs of 1 and 2 steps into the same pool),
    then one captured chunk called again for its step time and its profile.
    The per-step flights run first: beside the captured state and its pool
    a second falcon-mamba state does not fit.  Returns the kernels' launches
    on the card in the chunked flights: the kernel nodes of the replayed
    chunk's graph, per step, times the steps replayed, plus the eager warm-up step
    before the first capture."""
    from repro_torch.data.pipeline import split_streams
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train import population as P

    P.clear_population_cache()
    flights, losses, sums, graphs = {}, {}, {}, {}
    plan = (("per_step", 1, steps, False), ("per_step_again", 1, steps, False),
            ("per_step_rungs", 1, RUNG_FLIGHT["steps"], True),
            ("chunked", chunk, steps, False), ("chunked_again", chunk, steps, False),
            ("chunked_rungs", chunk, RUNG_FLIGHT["steps"], True))
    for name, chunk_steps, n_steps, rungs in plan:
        flights[name], losses[name], sums[name], tc, data = run_flight(
            torch, dev, arch, n_layers, population, batch, seq, n_steps, chunk_steps, seed,
            rungs=rungs)
        if chunk_steps > 1:
            graphs[name] = P.graph_stats()
        gc.collect()
        torch.cuda.empty_cache()
    per_step = launches_per_step(tc.model, chunked=True)
    streams = list(range(population))
    t0 = time.perf_counter()
    for t in range(3):
        data.make_population_batch(t, streams)
    host_batch_s = (time.perf_counter() - t0) / 3
    # one more dispatch of the captured chunk, as the driver makes it: every
    # lane active from cursor 0
    prog = P.get_compiled_population_scan_step(tc, population, data, chunk, per_trial_batch=True)
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=10 ** 6), tc)]
                       * population, dev)
    steps0 = torch.zeros(population, dtype=torch.int64, device=dev)
    lo, hi = (torch.tensor(w.astype("int64"), device=dev) for w in split_streams(streams))
    with P.flight_lease(tc, population, data, True, dev) as state:
        def dispatch():
            return prog(state, hp, steps0, lo, hi)

        dispatch()   # warm
        torch.cuda.synchronize()
        n_timed = 3
        t0 = time.perf_counter()
        for _ in range(n_timed):
            dispatch()
        torch.cuda.synchronize()
        replay_s = (time.perf_counter() - t0) / n_timed
        prof = profile_step(torch, dispatch)
    seen = graph_kernels(P, "scan", chunk)
    prof.pop("launches")
    raw = lambda t: t.view(torch.int32)  # noqa: E731  (fp32 losses as raw bits)
    refs = {"per_step_again": "per_step", "chunked": "per_step",
            "chunked_again": "per_step", "chunked_rungs": "per_step_rungs"}
    losses_equal = {n: bool(losses[n] is not None and losses[r] is not None
                            and losses[n].shape == losses[r].shape
                            and torch.equal(raw(losses[n]), raw(losses[r])))
                    for n, r in refs.items()}
    sums_equal = {n: sums[n] is not None and sums[n] == sums[r] for n, r in refs.items()}
    chunked, again, base = flights["chunked"], flights["chunked_again"], flights["per_step"]
    rung, rung_base = flights["chunked_rungs"], flights["per_step_rungs"]
    n_chunks = steps // chunk
    replayed_steps = sum(flights[n]["train_steps"] for n in refs if n.startswith("chunked"))
    # the warm-up step before the first capture runs eagerly; every other
    # step of a chunked flight is replayed
    launches = {name: seen[name] // chunk * replayed_steps + n for name, n in per_step.items()}
    out = {
        "phase": "chunked_path", "arch": arch, "n_layers": tc.model.n_layers,
        "population": population, "batch": batch, "seq": seq, "steps_per_trial": steps,
        "chunk": chunk,
        "dispatches": chunked["dispatches"], "train_steps": chunked["train_steps"],
        "dispatches_per_step": chunked["dispatches_per_step"],
        "per_step_dispatches": base["dispatches"],
        "rung_flight": {"steps_per_trial": RUNG_FLIGHT["steps"],
                        "dispatches": rung["dispatches"], "train_steps": rung["train_steps"],
                        "per_step_dispatches": rung_base["dispatches"],
                        "truncated_lanes": rung["truncated_lanes"],
                        "per_step_truncated_lanes": rung_base["truncated_lanes"]},
        "flight_s_per_step": {n: f["flight_s_per_step"] for n, f in flights.items()},
        "flight_wall_s": {n: f["wall_s"] for n, f in flights.items()},
        "host_batch_s": host_batch_s,
        "replayed_chunk_s": replay_s, "replayed_s_per_step": replay_s / chunk,
        "per_step_steady_s_per_step": per_step_steady,
        "graphs": graphs["chunked_rungs"],
        "capture_s": {n: sum(g["capture_s"] for g in gs) for n, gs in graphs.items()},
        "graph_pool_gib": {n: sum(g["pool_bytes"] for g in gs) / 2 ** 30
                           for n, gs in graphs.items()},
        # a replay allocates nothing, so the pool's use shows in reserved memory
        "peak_memory_gib": {n: f["peak_memory_gib"] for n, f in flights.items()},
        "peak_reserved_gib": {n: f["peak_reserved_gib"] for n, f in flights.items()},
        "wrapper_calls_at_capture": {n: flights[n]["launches"] for n in graphs},
        "launches": launches, "replayed_steps": replayed_steps,
        "launches_per_step": per_step,
        "kernel_launches_per_step_seen": {n: c / chunk for n, c in seen.items()},
        "profile": prof,
        "losses_bit_equal": losses_equal,
        "state_checksums_equal": sums_equal,
        "state_leaves": None if sums["chunked"] is None else len(sums["chunked"]),
        "scores": chunked["scores"], "per_step_scores": base["scores"],
        "rung_scores": rung["scores"], "per_step_rung_scores": rung_base["scores"],
    }
    emit(out)
    problems = []
    if not all(f["finished"] for f in flights.values()):
        problems.append("not every trial finished: " + "; ".join(
            f"{n}: {f['errors']}" for n, f in flights.items() if not f["finished"]))
    for name in ("chunked", "chunked_again"):
        f = flights[name]
        if f["train_steps"] != steps or f["dispatches"] != n_chunks:
            problems.append(f"{name}: {f['dispatches']} dispatches for {f['train_steps']} "
                            f"steps, want {n_chunks} for {steps}")
    if base["dispatches"] != steps:
        problems.append(f"the per-step flight made {base['dispatches']} dispatches")
    # the rung flight: chunks of 1, 2, 4 and 2 steps toward boundaries 1 and 3
    if (rung["train_steps"], rung["dispatches"]) != (RUNG_FLIGHT["steps"], 4):
        problems.append(f"the chunked rung flight made {rung['dispatches']} dispatches for "
                        f"{rung['train_steps']} steps, want 4 for {RUNG_FLIGHT['steps']}")
    if not rung["truncated_lanes"] or rung["truncated_lanes"] != rung_base["truncated_lanes"]:
        problems.append(f"the rung rule cut {rung['truncated_lanes']} lanes chunked and "
                        f"{rung_base['truncated_lanes']} per step; want the same, and some")
    if not all(losses_equal.values()):
        problems.append(f"per-step losses differ from the per-step flight's: {losses_equal}")
    if not all(sums_equal.values()):
        problems.append(f"final states differ from the per-step flight's: {sums_equal}")
    want_graphs = {"chunked": [chunk], "chunked_again": [chunk],
                   "chunked_rungs": sorted({1, 2, chunk})}
    first = {g["chunk"]: g for g in graphs["chunked"]}
    if ({n: [g["chunk"] for g in gs] for n, gs in graphs.items()} != want_graphs
            or any(g["chunk"] in first and g != first[g["chunk"]]
                   for gs in graphs.values() for g in gs)
            or P.graph_stats() != graphs["chunked_rungs"]):
        problems.append(f"captured graphs {graphs}, want {want_graphs}, each captured once")
    if prof.get("device_ms") is None:
        problems.append("the profiled chunk shows no device time")
    for name, n in per_step.items():
        calls = {n_: c[name] for n_, c in out["wrapper_calls_at_capture"].items()}
        # the warm-up step and the chunk of 4; no wrapper call in a replay; the
        # graphs of 1 and 2 steps
        want_calls = {"chunked": n * (chunk + 1), "chunked_again": 0, "chunked_rungs": n * 3}
        if calls != want_calls:
            problems.append(f"{name}: wrapper calls at capture {calls}, want {want_calls}")
        if seen[name] != n * chunk:
            problems.append(f"{name}: {seen[name]} launches in the replayed chunk's graph, "
                            f"want {n} x {chunk}")
    P.clear_population_cache()
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        die(f"chunked path {arch}: " + "; ".join(problems))
    return launches, out


# ----------------------------------------------------- phase 4, sharded_path
# the population mesh (--shard-population): at world 1 over NCCL, the three
# flights of SHARDED_FLIGHTS under the rung rule (RUNG_FLIGHT: boundaries 1
# and 3), each beside the unsharded engine's flight of the same trials;
# then two gloo ranks sharing the card (SHARDED_GLOO: 2 lanes a rank)
SHARDED_FLIGHTS = (("per_step", 1, False, RUNG_FLIGHT["steps"]),
                   ("chunked", CHUNK, False, RUNG_FLIGHT["steps"]),
                   # the whole 8-step ladder in one chunk: one dispatch
                   ("device_rules", 8, True, 8))
SHARDED_GLOO = dict(arch="starcoder2-3b", n_layers=2, population=4, batch=4, seq=1024,
                    world=2, join_s=420.0, collective_s=300.0, chunk=4, device="cuda:0")


def sharded_path(torch, dev, arch, n_layers, population, batch, seq, main_s_per_step=None,
                 seed=0, **_):
    """The sharded engine at world 1 over NCCL, in process, at ``MAIN``'s
    published widths: per step, chunked and chunked with the rule in the
    chunks, each through the Experiment and the sharded resource manager,
    beside the unsharded engine's flight.  Gates: scores, cuts, per-step
    losses and the final state's checksums bit-equal; no degraded or dead
    flight; the launches of a step as the unsharded path's (counters for
    the per-step flight, the nodes of the captured graphs for the chunked
    ones, which run first and capture them); the device-rule ladder one
    dispatch, its graph holding the rule's collective (nodes the unsharded
    rule graph lacks).  Returns the launches of the sharded flights."""
    from repro_torch.distributed.sharding import population_mesh
    from repro_torch.train import population as P

    P.clear_population_cache()
    mesh = population_mesh(dev)
    geo = dict(arch=arch, n_layers=n_layers, population=population, batch=batch, seq=seq)
    flights, problems = {}, []
    for name, chunk, device_rules, steps in SHARDED_FLIGHTS:
        for engine in ("sharded", "unsharded"):
            # the sharded flight first: it captures the graphs its launches
            # are counted in
            got, losses, sums, tc, data = run_flight(
                torch, dev, **geo, steps=steps, chunk_steps=chunk, seed=seed, rungs=True,
                device_rules=device_rules, sharded=engine == "sharded")
            flights[(name, engine)] = (got, losses, sums)
        if chunk > 1:
            flights[(name, "graphs")] = P.graph_stats(nodes=True)
        gc.collect()
        torch.cuda.empty_cache()
    per_step = launches_per_step(tc.model)
    per_step_chunked = launches_per_step(tc.model, chunked=True)
    raw = lambda t: t.view(torch.int32)  # noqa: E731  (fp32 losses as raw bits)
    rows = {}
    for name, chunk, device_rules, steps in SHARDED_FLIGHTS:
        (a, la, sa), (b, lb, sb) = flights[(name, "sharded")], flights[(name, "unsharded")]
        rows[name] = {
            "chunk_steps": chunk, "device_rules": device_rules, "steps": steps,
            "scores_bit_equal": a["scores"] == b["scores"],
            "losses_bit_equal": bool(la is not None and lb is not None and la.shape == lb.shape
                                     and torch.equal(raw(la), raw(lb))),
            "state_checksums_equal": sa is not None and sa == sb,
            "truncated_lanes": [a["truncated_lanes"], b["truncated_lanes"]],
            "train_steps": [a["train_steps"], b["train_steps"]],
            "dispatches": [a["dispatches"], b["dispatches"]],
            "flight_s_per_step": [a["flight_s_per_step"], b["flight_s_per_step"]],
            "wall_s": [a["wall_s"], b["wall_s"]],
            "wrapper_calls": a["launches"],
            "degraded_flights": a["degraded_flights"], "flight_deaths": a["flight_deaths"],
            "finished": a["finished"] and b["finished"], "scores": a["scores"]}
        r = rows[name]
        if not (r["scores_bit_equal"] and r["losses_bit_equal"] and r["state_checksums_equal"]):
            problems.append(f"{name}: the sharded flight is not the unsharded one bit for bit")
        if r["truncated_lanes"][0] != r["truncated_lanes"][1] \
                or r["train_steps"][0] != r["train_steps"][1] \
                or r["dispatches"][0] != r["dispatches"][1]:
            problems.append(f"{name}: cuts, steps or dispatches differ: {r}")
        if not r["truncated_lanes"][0]:
            problems.append(f"{name}: the rung rule cut no lane")
        if r["degraded_flights"] or r["flight_deaths"] or not r["finished"]:
            problems.append(f"{name}: a degraded, dead or unfinished flight")
    # the per-step flight: every step through the kernels, counted
    a = flights[("per_step", "sharded")][0]
    n_steps = a["train_steps"]
    for k, n in per_step.items():
        if a["launches"][k] != n * n_steps:
            problems.append(f"per_step: {k} {a['launches'][k]} launches, want {n} x {n_steps}")
    launches = dict(a["launches"])
    # the chunked flights: the kernels in the graphs they captured, a step's
    # worth per step, times the steps replayed, plus the warm-up step
    graphs = flights[("chunked", "graphs")]
    rule_graphs = [g for g in flights[("device_rules", "graphs")] if g["kind"] == "rulescan"]
    mode = f"cohort@nccl{mesh.world_size}"
    sharded_rule = [g for g in rule_graphs if g["mode"] == mode]
    plain_rule = [g for g in rule_graphs if g["mode"] == "cohort"]
    for g in [g for g in graphs if g["kind"] == "scan"] + sharded_rule:
        seen = {k: sum(sub in node for node in g["nodes"] or ())
                for k, sub in KERNEL_NAMES.items()}
        want = {k: n * g["chunk"] for k, n in per_step_chunked.items()}
        if seen != want:
            problems.append(f"{g['kind']} {g['mode']} graph of {g['chunk']}: kernels {seen}, "
                            f"want {want}")
    replayed = flights[("chunked", "sharded")][0]["train_steps"] + \
        flights[("device_rules", "sharded")][0]["train_steps"]
    for k, n in per_step_chunked.items():
        launches[k] = launches.get(k, 0) + n * (replayed + 1)
    calls = flights[("chunked", "sharded")][0]["launches"]
    want_calls = {k: n * (1 + 1 + 2 + CHUNK) for k, n in per_step_chunked.items()}
    if calls != want_calls:
        problems.append(f"chunked: wrapper calls {calls}, want the warm-up and the captures "
                        f"of 1, 2 and {CHUNK} steps {want_calls}")
    extra_nodes = (len(sharded_rule[0]["nodes"]) - len(plain_rule[0]["nodes"])
                   if len(sharded_rule) == 1 and len(plain_rule) == 1 else None)
    def kinds(gs):   # each node's type (KERNEL, MEMCPY, ...) from its DOT label
        found = {}
        for node in (gs[0]["nodes"] or () if gs else ()):
            m = re.search(r'label="\{(\w+)', node)
            kind = m.group(1) if m else "?"
            found[kind] = found.get(kind, 0) + 1
        return found

    k_sharded, k_plain = kinds(sharded_rule), kinds(plain_rule)
    extra_kinds = {k: n - k_plain.get(k, 0) for k, n in k_sharded.items()
                   if n != k_plain.get(k, 0)}
    if not extra_nodes or extra_nodes <= 0:
        problems.append(f"the sharded rule graph holds no node beyond the unsharded one's "
                        f"({extra_nodes})")
    if rows["device_rules"]["dispatches"][0] != 1:
        problems.append("the device-rule ladder was not one dispatch")
    # the collective alone: the rule chunk's per-step gather of the lanes'
    # vectors (losses, latches, local steps, budgets, bases, cursors)
    vec = {"losses": torch.zeros(population, device=dev),
           "diverged": torch.zeros(population, dtype=torch.bool, device=dev),
           "local": torch.zeros(population, dtype=torch.int32, device=dev),
           "rules": {"budgets": torch.zeros(population, device=dev),
                     "base": torch.zeros(population, device=dev),
                     "local0": torch.zeros(population, dtype=torch.int32, device=dev)}}
    gather_ms = event_ms(torch, lambda: mesh.all_gather_lanes(vec))
    gather_prof = profile_step(torch, lambda: mesh.all_gather_lanes(vec), top=6)
    gather_prof.pop("launches", None)
    P.clear_population_cache()
    mesh.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    s_per_step = rows["per_step"]["flight_s_per_step"][0]
    out = {"phase": "sharded_path", "mesh": "world 1", "backend": mesh.backend,
           "arch": arch, "n_layers": n_layers, "population": population, "batch": batch,
           "seq": seq, "nvidia_smi": nvidia_smi(), "flights": rows,
           "s_per_step": s_per_step, "main_path_s_per_step": main_s_per_step,
           "ratio_to_main_path": (s_per_step / main_s_per_step
                                  if s_per_step and main_s_per_step else None),
           "rule_graph_extra_nodes": extra_nodes, "rule_graph_extra_node_kinds": extra_kinds,
           "gather_ms": gather_ms, "gather_profile": gather_prof,
           "launches_per_step": per_step, "launches": launches}
    emit(out)
    if problems:
        die("sharded path (world 1, NCCL): " + "; ".join(problems))
    return launches, out


def _stream_grid(population):
    """``STREAM_SPACE``'s grid as a fixed queue: 2K trials (2 steps, then 4),
    each its own stream."""
    import itertools

    grid = itertools.product(*(p["range"] for p in STREAM_SPACE))
    return [dict(zip((p["name"] for p in STREAM_SPACE), vals), stream=i)
            for i, vals in enumerate(grid)][: 2 * population]


def _gloo_trial(dev, cfg, chunk_steps=1, device_rules=False, seed=0):
    from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving
    from repro_torch.launch.hpo import PopulationTrial

    trial = PopulationTrial(cfg["arch"], STREAM["steps"], cfg["batch"], cfg["seq"], seed,
                            population=cfg["population"],
                            model_overrides=published_widths(cfg["arch"], cfg["n_layers"]),
                            device=dev, chunk_steps=chunk_steps, device_rules=device_rules,
                            refill_idle_grace_s=0.0)
    trial.early_stop = InFlightSuccessiveHalving(
        eta=STREAM["eta"], min_iter=STREAM["min_iter"], max_iter=STREAM["max_iter"])
    return trial


def _gloo_flights(torch, dev, cfg, mesh=None):
    """The two flights of the gloo phase, on ``mesh`` or unsharded: the
    streaming ladder (the grid, host rules, per step) and a batch flight of
    its first K trials with the rule in chunks of ``cfg["chunk"]``."""
    from repro_torch.core.resource.vectorized import QueueFeedScheduler

    out = {}
    grid = _stream_grid(cfg["population"])
    trial = _gloo_trial(dev, cfg)
    reset_counters()
    t0 = time.perf_counter()
    if mesh is not None and mesh.rank != 0:
        trial.run_population([], mesh=mesh)
    else:
        feed = QueueFeedScheduler(grid)
        trial.run_population([], mesh=mesh, scheduler=feed)
        n = len(grid)
        out["streaming"] = {
            "scores": feed.ordered_scores(n), "order": list(feed.scores),
            "steps": [feed.extras[i]["steps"] for i in range(n)],
            "lanes": [feed.extras[i]["lane"] for i in range(n)],
            "truncated": trial.early_stop.n_truncated, "dispatches": trial.n_dispatches,
            "train_steps": trial.n_train_steps}
    torch.cuda.synchronize()
    out["streaming_s"] = time.perf_counter() - t0
    out["streaming_launches"] = counters()
    trial = _gloo_trial(dev, cfg, chunk_steps=cfg["chunk"], device_rules=True)
    reset_counters()
    t0 = time.perf_counter()
    # K trials of 2 and 4 steps: the rung at step 3 cuts, the ladder is one chunk
    scores = trial.run_population(grid[::2][: cfg["population"]], mesh=mesh)
    torch.cuda.synchronize()
    out["device_rules_s"] = time.perf_counter() - t0
    out["device_rules_launches"] = counters()
    out["device_rules"] = {"scores": scores, "truncated": trial.early_stop.n_truncated,
                           "dispatches": trial.n_dispatches, "train_steps": trial.n_train_steps}
    return out


def _gloo_rank(rank, cfg, store, out_dir):
    """One of ``SHARDED_GLOO``'s ranks on ``cuda:0`` (spawned by
    ``sharded_gloo_path``): its flights, then lanes moved across ranks, each
    held bit for bit against the lane it copies.  Rank 0 saves what it saw
    to ``out_dir/rank0.json``; a rank that raises leaves its traceback in
    ``rank{r}.err``."""
    import os
    import traceback

    sys.path.insert(0, str(SRC))
    try:
        import torch

        from repro_torch.distributed.sharding import population_mesh
        from repro_torch.launch.flight import LaneFlight
        from repro_torch.train import population as P

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = torch.device(cfg["device"])
        mesh = population_mesh(dev, backend="gloo", init_method=f"file://{store}", rank=rank,
                               world_size=cfg["world"], timeout_s=cfg["collective_s"])
        out = _gloo_flights(torch, dev, cfg, mesh)
        P.clear_population_cache()
        torch.cuda.empty_cache()
        # lanes across ranks: every lane its own init; lane 3 lives on rank
        # 1 and lanes 0 and 1 on rank 0
        trial = _gloo_trial(dev, cfg)
        k = cfg["population"]
        moved = {}
        # every rank runs the same calls (SPMD), so no rank broadcasts them
        fl = LaneFlight(trial, k, mesh=mesh)
        try:
            fl._init_state(list(range(100, 100 + k)), True)
            st = fl.state
            nbytes = P._lane_layout(st)[1]

            def lane_bytes(lane):
                """Global lane ``lane``'s bytes on rank 0 (sent by its owner)."""
                owner, local = P._owner_of(mesh, st, lane)
                if owner == 0:
                    return P._pack_lane(st, local) if rank == 0 else None
                buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
                if rank == owner:
                    mesh.exchange([(P._pack_lane(st, local), 0)], [])
                elif rank == 0:
                    mesh.exchange([], [(buf, owner)])
                return buf if rank == 0 else None

            def timed_op(fn):
                torch.cuda.synchronize()
                mesh.barrier()
                t0 = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
                mesh.barrier()
                return got, (time.perf_counter() - t0) * 1e3

            donor = lane_bytes(3)
            mask = [i == 0 for i in range(k)]
            _, moved["clone_ms"] = timed_op(lambda: fl._clone(mask, [3] * k))
            target = lane_bytes(0)
            if rank == 0:
                moved["clone_bit_equal"] = bool(torch.equal(donor, target))
            snap, moved["snapshot_ms"] = timed_op(lambda: fl._snapshot(3))
            _, moved["restore_ms"] = timed_op(lambda: fl._restore(1, snap))
            restored = lane_bytes(1)
            if rank == 0:
                moved["snapshot_restore_bit_equal"] = bool(torch.equal(donor, restored))
                moved["snapshot_pinned"] = bool(snap["last_loss"].is_pinned())
            moved["lane_bytes"] = nbytes
        finally:
            fl._close()
        mesh.destroy()
        if rank == 0:
            out["moved"] = moved
            out["eager_rule_chunk"] = True
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def sharded_gloo_path(torch, dev, seed=0):
    """Two gloo ranks sharing the card (``SHARDED_GLOO``: starcoder2-3b at
    its published widths, 2 layers, 2 lanes a rank), spawned from here: the
    streaming ladder with host rules and a device-rule batch flight (under
    gloo its rule chunk runs eagerly: a gloo collective cannot sit in a CUDA
    graph) against the unsharded engine on the same trials (run first, here),
    then a clone whose donor lives on rank 1 and target on rank 0, and a
    snapshot of a rank-1 lane restored into a rank-0 lane, each bit-equal to
    the lane it copies, timed against the lane's bytes.  Gates: scores within
    1e-6 and the same decisions (bit equality reported), bit-equal lanes."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.train import population as P

    cfg = SHARDED_GLOO
    P.clear_population_cache()
    ref = _gloo_flights(torch, dev, cfg)
    P.clear_population_cache()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, cfg, os.path.join(tmp, "store"), tmp))
                 for r in range(cfg["world"])]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        end = time.monotonic() + cfg["join_s"]
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        wall = time.perf_counter() - t0
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = {r: open(os.path.join(tmp, f"rank{r}.err")).read()[-3000:]
                for r in range(cfg["world"]) if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
        if hung or errs or any(p.exitcode for p in procs):
            die(f"sharded gloo path: ranks hung {hung}, exit codes "
                f"{[p.exitcode for p in procs]}, errors {errs}")
        with open(os.path.join(tmp, "rank0.json")) as f:
            got = json.load(f)
    problems = []
    cmp = {}
    for flight in ("streaming", "device_rules"):
        a, b = got[flight], ref[flight]
        diff = float(max(abs(x - y) for x, y in zip(a["scores"], b["scores"])))
        cmp[flight] = {"max_abs_diff": diff, "bit_equal": a["scores"] == b["scores"],
                       "same_decisions": {n: a[n] == b[n] for n in a if n != "scores"}}
        if diff > 1e-6:
            problems.append(f"{flight}: scores differ from world 1 by {diff}")
        if not all(cmp[flight]["same_decisions"].values()):
            problems.append(f"{flight}: decisions differ from world 1: "
                            f"{cmp[flight]['same_decisions']}")
    moved = got["moved"]
    gb = moved["lane_bytes"] / 1e9
    if not (moved["clone_bit_equal"] and moved["snapshot_restore_bit_equal"]):
        problems.append(f"a lane moved across ranks is not its source bit for bit: {moved}")
    out = {"phase": "sharded_path", "mesh": "world 2", "backend": "gloo",
           "ranks_on": cfg["device"], "nvidia_smi": nvidia_smi(),
           **{k: cfg[k] for k in ("arch", "n_layers", "population", "batch", "seq")},
           "device_rule_chunk": "eager (a gloo collective cannot be captured in a CUDA graph)",
           "vs_world_1": cmp, "world_2": {n: got[n] for n in ("streaming", "device_rules")},
           "world_1": {n: ref[n] for n in ("streaming", "device_rules")},
           "flight_s": {"streaming": [got["streaming_s"], ref["streaming_s"]],
                        "device_rules": [got["device_rules_s"], ref["device_rules_s"]]},
           "rank0_launches": {"streaming": got["streaming_launches"],
                              "device_rules": got["device_rules_launches"]},
           "transfers": dict(moved, **{f"{k[:-3]}_gb_per_s": gb / (moved[k] / 1e3)
                                       for k in ("clone_ms", "snapshot_ms", "restore_ms")}),
           "spawn_wall_s": wall}
    emit(out)
    if problems:
        die("sharded path (world 2, gloo): " + "; ".join(problems))
    # the kernels line counts rank 0's launches (rank 1 makes as many)
    launches = {k: got["streaming_launches"][k] + got["device_rules_launches"][k]
                for k in got["streaming_launches"]}
    return launches, out


# -------------------------------------------------------------- phase 4, MoE
MOE_RECKONED_PEAK_GB = 46.0   # the cell's reckoning from the code: state, gradients,
                              # AdamW's temporaries over the stacked experts, logits


def raw_bits(torch, t):
    """A tensor's raw bits as integers of its element size."""
    t = t.detach()
    return t.view(getattr(torch, INT_OF_SIZE[t.element_size()]))


def moe_layer_bits(torch, params, x, cfg) -> list:
    """One MoE layer's y, aux and the gradients of ``sum(y**2) + aux`` in x
    and every leaf, as raw bits."""
    from repro_torch.interop import tree_leaves, tree_unflatten
    from repro_torch.models import moe as M

    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    xx = x.detach().requires_grad_(True)
    y, aux = M.moe_apply(tree_unflatten(params, leaves), xx, cfg)
    grads = torch.autograd.grad((y.float() ** 2).sum() + aux.sum(), [xx] + leaves)
    return [raw_bits(torch, t) for t in [y, aux] + list(grads)]


def moe_path(torch, dev, arch, n_layers, population, batch, seq, seed=0, **_):
    """The ``moe`` line: one eager population step at the MoE cell, its MoE
    layer's input recorded; the step under the profiler; the layer's four
    parts (router with top-k; sort and dispatch; expert products; combine)
    each forward and backward under the profiler on that input; the expert
    products against their bound at the card's dense bf16 peak; the share
    of assignments dropped; peak memory against the reckoning.  Then the
    determinism gate: the layer's forward and backward run twice on the
    same input give raw-bit-equal y, aux and gradients, and the same input
    and parameters in lane 0 and lane 1 give the same bits in each lane."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.interop import tree_map
    from repro_torch.launch.hpo import PopulationTrial
    from repro_torch.models import moe as M
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train.population import (init_population_state,
                                              make_population_train_step)

    trial = PopulationTrial(arch, 1, batch, seq, seed, population=population,
                            model_overrides=published_widths(arch, n_layers), device=dev)
    tc, _ = trial._setup()
    cfg = tc.model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pstate = init_population_state(torch.Generator(device=dev).manual_seed(seed), tc,
                                   population, dev)
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=10 ** 6), tc)]
                       * population, dev)
    step = make_population_train_step(tc, per_trial_batch=True)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    bt = to_device(data.make_population_batch(0, list(range(population))), dev)
    seen = []
    plain_apply = M.moe_apply

    def recording(p, x, c, **kw):
        if not seen:
            seen.append((tree_map(lambda t: t.detach(), p), x.detach().clone()))
        return plain_apply(p, x, c, **kw)

    M.moe_apply = recording
    try:
        step(pstate, bt, hp)
    finally:
        M.moe_apply = plain_apply
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_prof = profile_step(torch, lambda: step(pstate, bt, hp))
    step_prof.pop("launches")
    params, x = seen[0]
    params = tree_map(lambda t: t.clone(), params)   # outlive the state
    del pstate, seen
    gc.collect()
    torch.cuda.empty_cache()

    K, B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    G = M.dispatch_groups(T, cfg, False)
    Tg = T // G
    C = M.capacity(cfg, Tg)
    xt = x.reshape(K, G, Tg, d)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        probs, top_p, top_e = M.route(params["router"], xt, k)
        slot = M.dispatch_slots(top_e, E, C)
        buf = M.dispatch(xt, slot, E, C)
        out = M.experts(buf, params, cfg)
    dropped = int((slot == E * C).sum())
    g_top_p = torch.randn(top_p.shape, generator=gen, device=dev)
    g_buf = torch.randn(buf.shape, generator=gen, device=dev).to(buf.dtype)
    g_out = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
    g_y = torch.randn(xt.shape, generator=gen, device=dev).to(x.dtype)

    def leaf(t):
        return t.detach().requires_grad_(True)

    def route_fb():
        r, xx = leaf(params["router"]), leaf(xt)
        pr, tp, te = M.route(r, xx, k)
        loss = M.aux_loss(pr, te, E).sum() + (tp * g_top_p).sum()
        return torch.autograd.grad(loss, (r, xx))

    def dispatch_fb():
        xx = leaf(xt)
        s_ = M.dispatch_slots(top_e, E, C)
        return torch.autograd.grad(M.dispatch(xx, s_, E, C), xx, g_buf)

    def experts_fb():
        bb, wi, wo = leaf(buf), leaf(params["wi"]), leaf(params["wo"])
        return torch.autograd.grad(M.experts(bb, {"wi": wi, "wo": wo}, cfg), (bb, wi, wo), g_out)

    def combine_fb():
        oo, tp = leaf(out), leaf(top_p)
        return torch.autograd.grad(M.combine(oo, slot, tp), (oo, tp), g_y)

    parts = timed_parts(torch, (("router_topk", route_fb), ("sort_dispatch", dispatch_fb),
                                ("expert_products", experts_fb), ("combine", combine_fb)))
    n_in, ff = params["wi"].shape[-2:]
    rows = K * E * G * C
    flops = 3 * 2 * rows * d * (n_in * ff + ff)        # forward and its two backward products
    bound = flops / PEAK_OPS["bfloat16"] * 1e3
    expert_ms = parts["expert_products"]["device_ms"] or parts["expert_products"]["event_ms"]
    del probs, top_p, top_e, buf, out, g_top_p, g_buf, g_out, g_y
    gc.collect()
    torch.cuda.empty_cache()

    # the determinism gate: lane 0's parameters and input in both lanes
    one = tree_map(lambda t: t[:1].expand((2,) + tuple(t.shape[1:])).contiguous(), params)
    x2 = x[:1].expand((2,) + tuple(x.shape[1:])).contiguous()
    del params, x, xt
    first = moe_layer_bits(torch, one, x2, cfg)
    again = moe_layer_bits(torch, one, x2, cfg)
    rerun_equal = all(torch.equal(a, b) for a, b in zip(first, again))
    lanes_equal = all(torch.equal(t[0], t[1]) for t in first)
    n_leaves = len(first)
    del first, again, one, x2
    gc.collect()
    torch.cuda.empty_cache()

    out = {
        "phase": "moe", "arch": arch, "n_layers": cfg.n_layers, "population": population,
        "batch": batch, "seq": seq, "d_model": d, "n_experts": E, "moe_top_k": k,
        "moe_d_ff": cfg.moe_d_ff, "groups": G, "capacity": C,
        "capacity_factor": cfg.capacity_factor, "assignments": K * T * k,
        "dropped": dropped, "dropped_share": dropped / (K * T * k),
        "parts_device_ms": {n: p_.get("device_ms") for n, p_ in parts.items()},
        "parts_event_ms": {n: p_["event_ms"] for n, p_ in parts.items()},
        "parts": parts,
        "expert_products": {"flops_fwd_bwd": flops, "bound_ms": bound,
                            "peak_tflops_bf16": PEAK_OPS["bfloat16"] / 1e12,
                            "share_of_bound": None if not expert_ms else bound / expert_ms},
        "step_profile": step_prof,
        "peak_memory_gib": peak / 2 ** 30, "peak_memory_gb": peak / 1e9,
        "reckoned_peak_gb": MOE_RECKONED_PEAK_GB,
        "determinism": {"rerun_bit_equal": rerun_equal, "lanes_bit_equal": lanes_equal,
                        "tensors": n_leaves},
    }
    emit(out)
    problems = []   # the parts' times are observations; the gate is the bits
    if not rerun_equal:
        problems.append("the MoE layer's forward and backward differ run to run")
    if not lanes_equal:
        problems.append("the same input gives different bits in lane 0 and lane 1")
    if problems:
        die(f"moe {arch}: " + "; ".join(problems))
    return out


# -------------------------------------------------------------- phase 4, MLA
DEEPSEEK_RECKONED_PEAK_GB = 48.0   # the cell's reckoning from the code: state 21.7 GB,
                                   # gradients 4.3, AdamW's temporaries over the stacked
                                   # experts ~15, fp32 logits 1.7 and their gradient


def mla_layer_bits(torch, params, x, cfg) -> list:
    """One MLA layer's y and the gradients of ``sum(y**2)`` in x and every
    leaf, as raw bits."""
    from repro_torch.interop import tree_leaves, tree_unflatten
    from repro_torch.models import attention as A

    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    xx = x.detach().requires_grad_(True)
    y = A.mla_apply(tree_unflatten(params, leaves), xx, cfg,
                    torch.arange(x.shape[2], device=x.device))
    grads = torch.autograd.grad((y.float() ** 2).sum(), [xx] + leaves)
    return [raw_bits(torch, t) for t in [y] + list(grads)]


def timed_parts(torch, fns) -> dict:
    """Each part's device time under the profiler (up to three traces: the
    trace of a call of a few ms has come back empty) and its CUDA events'
    time."""
    parts = {}
    for name, fn in fns:
        for attempt in range(1, 4):
            prof = profile_step(torch, fn, top=4)
            if prof.get("device_ms") is not None:
                break
        prof.pop("launches")
        prof.pop("kernel_launches_seen")
        parts[name] = dict(prof, traces=attempt, event_ms=event_ms(torch, fn, n=10))
    return parts


def mla_path(torch, dev, arch, n_layers, population, batch, seq, seed=0, **_):
    """The ``mla`` line: one eager population step at the MLA cell, the input
    of its first MLA layer recorded; the step under the profiler; the
    layer's parts, each forward and backward (the flash forward and the
    plain flash backward apart) under the profiler on that input: the q and
    latent projections with ``kv_norm`` and RoPE, the ``wk_b`` / ``wv_b``
    decompression with the q/k concatenation, the flash forward at q/k
    width 192 and v width 128, the plain flash backward, ``wo``; the flash
    forward against its bound and its padded 256-wide instance's work; peak
    memory against the reckoning.  Then the determinism gate: the layer's
    forward and backward run twice on the same input give raw-bit-equal y
    and gradients, and the same input and parameters in lane 0 and lane 1
    give the same bits in each lane."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.interop import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch.hpo import PopulationTrial
    from repro_torch.models import attention as A
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train.population import (init_population_state,
                                              make_population_train_step)

    trial = PopulationTrial(arch, 1, batch, seq, seed, population=population,
                            model_overrides=published_widths(arch, n_layers), device=dev)
    tc, _ = trial._setup()
    cfg = tc.model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pstate = init_population_state(torch.Generator(device=dev).manual_seed(seed), tc,
                                   population, dev)
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=10 ** 6), tc)]
                       * population, dev)
    step = make_population_train_step(tc, per_trial_batch=True)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    bt = to_device(data.make_population_batch(0, list(range(population))), dev)
    seen = []
    plain_apply = A.mla_apply

    def recording(p, x, c, positions):
        if not seen:
            seen.append((tree_map(lambda t: t.detach(), p), x.detach().clone()))
        return plain_apply(p, x, c, positions)

    A.mla_apply = recording
    try:
        step(pstate, bt, hp)
    finally:
        A.mla_apply = plain_apply
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_prof = profile_step(torch, lambda: step(pstate, bt, hp))
    step_prof.pop("launches")
    params, x = seen[0]
    params = tree_map(lambda t: t.clone(), params)   # outlive the state
    del pstate, seen
    gc.collect()
    torch.cuda.empty_cache()

    K, B, S, d = x.shape
    H, Dh, rr, r = cfg.n_heads, cfg.resolved_head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    D, Dv = Dh + rr, Dh
    scale = 1.0 / (D ** 0.5)
    pos = torch.arange(S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape, dtype=x.dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def leaf(t):
        return t.detach().requires_grad_(True)

    def decompress(c, k_rope, q_nope, q_rope, wk_b, wv_b):
        k_nope = torch.einsum("kbsr,krhe->kbshe", c, wk_b)
        v = torch.einsum("kbsr,krhe->kbshe", c, wv_b)
        k_rope_h = k_rope[:, :, :, None, :].expand(k_nope.shape[:4] + (rr,))
        return (torch.cat([q_nope, q_rope], dim=-1), torch.cat([k_nope, k_rope_h], dim=-1), v)

    with torch.no_grad():
        qkc = A._mla_qkc(params, x, cfg, pos)
        q_full, k_full, v = decompress(*qkc[2:], *qkc[:2], params["wk_b"], params["wv_b"])
        q_full, k_full, v = (t.reshape((K * B,) + t.shape[2:]).contiguous()
                             for t in (q_full, k_full, v))
        out, lse = fa.flash_fwd_cuda(q_full, k_full, v, causal=True, window=None,
                                     softcap=None, scale=scale)
    g_qkc = [rand(t.shape) for t in qkc]
    g_full = [rand(t.shape) for t in (q_full, k_full, v)]
    g_out = rand(out.shape)
    g_y = rand(x.shape)
    attn_out = out.reshape((K, B) + out.shape[1:])
    lse_g = lse.reshape(K * B, H, 1, S)   # kv heads = q heads in MLA

    def q_latent_rope_fb():
        p_ = {n: leaf(params[n]) for n in ("wq", "wkv_a", "kv_norm")}
        xx = leaf(x)
        return torch.autograd.grad(A._mla_qkc(p_, xx, cfg, pos), [xx] + list(p_.values()),
                                   g_qkc)

    def decompress_fb():
        ins = [leaf(t) for t in (qkc[2], qkc[3], qkc[0], qkc[1], params["wk_b"],
                                 params["wv_b"])]
        return torch.autograd.grad(decompress(*ins), ins, [g.reshape((K, B) + g.shape[1:])
                                                           for g in g_full])

    def flash_fwd():
        return fa.flash_fwd_cuda(q_full, k_full, v, causal=True, window=None, softcap=None,
                                 scale=scale)

    def flash_bwd():   # as FlashAttention.backward calls it
        return ref._blocked_bwd(q_full, k_full, v, out, lse_g, g_out, causal=True,
                                window=None, softcap=None, scale=scale, q_offset=0,
                                block_q=fa.BWD_BLOCK, block_kv=fa.BWD_BLOCK, causal_skip=True)

    def wo_fb():
        oo, wo = leaf(attn_out), leaf(params["wo"])
        return torch.autograd.grad(torch.einsum("kbshe,khed->kbsd", oo, wo), (oo, wo), g_y)

    fns = (("q_latent_rope", q_latent_rope_fb), ("decompress", decompress_fb),
           ("flash_fwd", flash_fwd), ("flash_bwd_plain", flash_bwd), ("wo", wo_fb))
    fa_before = (fa.launches_sm90, fa.launches_fp32)   # the profiler resets the counters
    flash_fwd()
    torch.cuda.synchronize()
    flash_through = {"sm90": fa.launches_sm90 - fa_before[0],
                     "fp32": fa.launches_fp32 - fa_before[1]}
    parts = timed_parts(torch, fns)
    pairs = S * (S + 1) // 2
    flops = 2 * K * B * H * pairs * (D + Dv)
    padded = 2 * K * B * H * pairs * (2 * 256)    # the 256-wide instance pads both widths
    nb = ((2 * q_full.numel() + v.numel() + out.numel()) * q_full.element_size()
          + lse.numel() * 4)
    b_ms, b_by = bound_ms(nb, flops, "bfloat16")
    flash_ms = parts["flash_fwd"]["device_ms"] or parts["flash_fwd"]["event_ms"]
    layer_ms = {n: p_.get("device_ms") or p_["event_ms"] for n, p_ in parts.items()}
    del qkc, q_full, k_full, v, out, lse, lse_g, g_qkc, g_full, g_out, g_y, attn_out
    gc.collect()
    torch.cuda.empty_cache()

    # the determinism gate: lane 0's parameters and input in both lanes
    one = tree_map(lambda t: t[:1].expand((2,) + tuple(t.shape[1:])).contiguous(), params)
    x2 = x[:1].expand((2,) + tuple(x.shape[1:])).contiguous()
    del params, x
    first = mla_layer_bits(torch, one, x2, cfg)
    again = mla_layer_bits(torch, one, x2, cfg)
    rerun_equal = all(torch.equal(a, b) for a, b in zip(first, again))
    lanes_equal = all(torch.equal(t[0], t[1]) for t in first)
    differing = [i for i, t in enumerate(first) if not torch.equal(t[0], t[1])]
    n_tensors = len(first)
    del first, again, one, x2
    gc.collect()
    torch.cuda.empty_cache()

    step_ms = step_prof.get("device_ms")
    res = {
        "phase": "mla", "arch": arch, "n_layers": cfg.n_layers, "population": population,
        "batch": batch, "seq": seq, "d_model": d, "n_heads": H, "head_dim": Dh,
        "rope_head_dim": rr, "kv_lora_rank": r, "qk_width": D, "v_width": Dv,
        "parts_device_ms": {n: p_.get("device_ms") for n, p_ in parts.items()},
        "parts_event_ms": {n: p_["event_ms"] for n, p_ in parts.items()},
        "parts": parts,
        "layer_ms": sum(layer_ms.values()),
        "layer_share_of_step": None if not step_ms else sum(layer_ms.values()) / step_ms,
        "flash_fwd": {"flops": flops, "padded_flops_256_instance": padded,
                      "useful_share_of_arithmetic": flops / padded, "bytes": nb,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "share_of_bound": b_ms / flash_ms, "kernel_launches": flash_through},
        "step_profile": step_prof,
        "peak_memory_gib": peak / 2 ** 30, "peak_memory_gb": peak / 1e9,
        "reckoned_peak_gb": DEEPSEEK_RECKONED_PEAK_GB,
        "determinism": {"rerun_bit_equal": rerun_equal, "lanes_bit_equal": lanes_equal,
                        "tensors": n_tensors, "lane_differing_tensors": differing},
    }
    emit(res)
    problems = []   # the parts' times are observations; the gate is the bits
    if flash_through != {"sm90": 1, "fp32": 0}:
        problems.append(f"the bf16 flash forward went through {flash_through}")
    if not rerun_equal:
        problems.append("the MLA layer's forward and backward differ run to run")
    if not lanes_equal:
        problems.append(f"the same input gives different bits in lane 0 and lane 1 "
                        f"(tensors {differing} of y and the gradients)")
    if problems:
        die(f"mla {arch}: " + "; ".join(problems))
    return res


# -------------------------------------------------------- phase 4, streaming
def lane_checksums(torch, pstate, lane: int) -> list:
    """``state_checksums`` of one lane's slice of a population state."""
    from repro_torch.interop import tree_map

    return state_checksums(torch, tree_map(lambda t: t[lane], pstate))


def published_widths(arch, n_layers) -> dict:
    """``model_overrides`` for ``arch`` at its published widths, depth cut to
    ``n_layers``."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    out = {f.name: getattr(full, f.name) for f in dataclasses.fields(full) if f.name != "name"}
    out["n_layers"] = n_layers
    return out


def stream_flight(torch, dev, arch, n_layers, population, batch, seq, *, kind, chunk_steps,
                  device_rules=False, lane_refill=True, seed=0):
    """One flight of the Experiment with the vectorized manager.  ``kind``
    ``asha``: the grid of ``STREAM_SPACE`` (two waves of K trials) under the
    in-flight rung rule of ``STREAM``; ``rungs``: 2K random trials of
    ``RUNG_FLIGHT``'s 9 steps under its rung rule (boundaries 1 and 3); both
    with all 2K trials offered at once (``lane_refill``) or in two batches
    of K.  ``pbt``: streaming PBT with synchronized rounds (``PBT_FLIGHT``).
    ``asha_proposer``: the ASHA proposer of ``ASHA_FLIGHT`` on 2K configs
    with its in-flight rung rule, K offered at a time, promotions offered
    as the results come.  The launch counters are set to 0 just before the
    flight and read just after; the manager's flight deaths, restarts and
    quarantined jobs are read with them."""
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.job import JobStatus
    from repro_torch.core.proposer.early_stop import InFlightSuccessiveHalving
    from repro_torch.launch.hpo import SPACE, PopulationTrial
    from repro_torch.train import population as P

    overrides = published_widths(arch, n_layers)
    spec = {"asha": STREAM, "rungs": RUNG_FLIGHT, "pbt": PBT_FLIGHT,
            "asha_proposer": ASHA_FLIGHT}[kind]
    trial = PopulationTrial(arch, spec["steps"], batch, seq, seed, population=population,
                            model_overrides=overrides, device=dev, chunk_steps=chunk_steps,
                            device_rules=device_rules)
    cfg = {"target": "max", "seed": seed, "resource": "vectorized"}
    if kind == "asha":
        trial.early_stop = InFlightSuccessiveHalving(
            eta=STREAM["eta"], min_iter=STREAM["min_iter"], max_iter=STREAM["max_iter"])
        # a streaming flight is offered every trial at once, so each lease
        # lands at the same step whatever the experiment loop's timing
        cfg.update(proposer="grid", parameter_config=STREAM_SPACE, n_samples=2 * population,
                   n_parallel=2 * population if lane_refill else population)
    elif kind == "rungs":
        trial.early_stop = InFlightSuccessiveHalving(
            eta=RUNG_FLIGHT["eta"], min_iter=RUNG_FLIGHT["min_iter"],
            max_iter=RUNG_FLIGHT["steps"])
        cfg.update(proposer="random", parameter_config=SPACE, n_samples=2 * population,
                   n_parallel=2 * population if lane_refill else population)
    elif kind == "asha_proposer":
        cfg.update(proposer="asha", parameter_config=SPACE, n_samples=2 * population,
                   n_parallel=population, max_iter=ASHA_FLIGHT["max_iter"],
                   min_iter=ASHA_FLIGHT["min_iter"], eta=ASHA_FLIGHT["eta"])
    else:
        cfg.update(proposer="pbt", parameter_config=PBT_SPACE,
                   n_samples=population * PBT_FLIGHT["rounds"], n_parallel=population,
                   population=population, n_generations=PBT_FLIGHT["rounds"],
                   streaming=True, sync_rounds=True, quantile=PBT_FLIGHT["quantile"])
    if lane_refill:
        cfg["lane_refill"] = True
    clones = []

    def on_lane_op(op, pstate, lanes, donors):
        # a clone's target against its donor, raw bits, right after the copy:
        # the donor was pinned since its round ended, so this is its state at
        # the round boundary
        if op == "clone":
            for t, d in zip(lanes, donors):
                clones.append({"target": t, "donor": d,
                               "equal": lane_checksums(torch, pstate, t)
                               == lane_checksums(torch, pstate, d)})

    trial.record_lane_op = on_lane_op
    exp = Experiment(cfg, trial)
    if kind == "asha_proposer":
        trial.early_stop = exp.proposer.inflight_hook(steps_per_unit=ASHA_FLIGHT["steps"])
    jobs = []
    exp.add_result_callback(jobs.append)
    graphs0 = {(g["kind"], g["mode"], g["chunk"], json.dumps(g["shape"]))
               for g in P.graph_stats()}
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    new_graphs = [g for g in P.graph_stats()
                  if (g["kind"], g["mode"], g["chunk"], json.dumps(g["shape"])) not in graphs0]

    def key(j):
        c = j.config
        return (f"m{c['pbt_member']}r{c['pbt_round']}" if kind == "pbt" else f"j{j.job_id}")

    extras = {key(j): (None if j.result is None or j.result.extra is None else
                       {n: j.result.extra[n] for n in ("steps", "total_steps", "diverged",
                                                       "lane")})
              for j in jobs}
    out = {"kind": kind, "chunk_steps": chunk_steps, "device_rules": device_rules,
           "lane_refill": lane_refill, "wall_s": wall, "launches": launches,
           "dispatches": trial.n_dispatches, "train_steps": trial.n_train_steps,
           "dispatches_per_step": trial.n_dispatches / max(1, trial.n_train_steps),
           "active_lane_share": trial.active_lane_share,
           "s_per_result": wall / max(1, len(jobs)),
           "refills": trial.n_refills, "splices": trial.n_splices, "clones": trial.n_clones,
           "ladder_dispatches": trial.ladder_dispatches,
           "host_ckpt_roundtrips": trial.n_host_ckpt_roundtrips,
           "lineage_resets": trial.n_lineage_resets,
           "truncated": trial.early_stop.n_truncated if kind != "pbt" else None,
           "streamed": getattr(exp.rm, "n_streamed", None),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "flight_deaths": exp.rm.n_flight_deaths,
           "flight_restarts": exp.rm.n_flight_restarts,
           "quarantined": exp.rm.n_quarantined,
           # ASHA's job count depends on its promotions: every config ran
           "finished": (len(jobs) >= exp.proposer.n_configs_target
                        if kind == "asha_proposer" else len(jobs) == exp.proposer.n_samples)
                       and all(j.status == JobStatus.FINISHED for j in jobs),
           "errors": [j.result.error for j in jobs
                      if j.status != JobStatus.FINISHED and j.result is not None],
           "order": [key(j) for j in jobs],
           "scores": {key(j): None if j.result is None else j.result.score for j in jobs},
           "extras": extras, "clone_checks": clones, "new_graphs": new_graphs,
           "configs": {key(j): dict(j.config) for j in jobs}}
    del exp, trial
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lane_op_timings(torch, dev, tc, data, population):
    """Splice, masked init (half the lanes) and clone on the geometry's
    captured state, timed with CUDA events at full width, beside their byte
    bounds (one lane's state written; read and written for a clone), with
    the most memory each allocated beside the state."""
    from repro_torch.interop import tree_leaves
    from repro_torch.train import population as P

    gen = torch.Generator(device=dev).manual_seed(5)
    half = [i < population // 2 for i in range(population)]
    with P.flight_lease(tc, population, data, True, dev) as state:
        if state is None:
            die("lane op timings: no captured state to time on")
        lane_bytes = sum(t[0].numel() * t.element_size()
                         for t in tree_leaves(state["inner"]))
        params = tree_leaves(state["inner"]["params"])
        param_bytes = sum(t[0].numel() * t.element_size() for t in params)
        leaf_bytes = max(t[0].numel() * t.element_size() for t in tree_leaves(state))
        # init draws a leaf in fp32, then casts it: one fp32 leaf beside the
        # lane's parameters
        init_allowed = param_bytes + 4 * max(t[0].numel() for t in params)
        ops = {
            "splice": (lambda: P.get_lane_op(tc, population, "splice")(state, 0, gen),
                       lane_bytes, init_allowed),
            "init_half": (lambda: P.get_lane_op(tc, population, "init")(
                state, half, [gen] * population), lane_bytes * sum(half), init_allowed),
            "clone": (lambda: P.get_lane_op(tc, population, "clone")(
                state, [i == 1 for i in range(population)], list(range(population))),
                2 * lane_bytes, leaf_bytes),
        }
        out = {"lane_state_gib": lane_bytes / 2 ** 30, "lane_param_gib": param_bytes / 2 ** 30,
               "largest_leaf_lane_gib": leaf_bytes / 2 ** 30}
        for name, (fn, nbytes, allowed) in ops.items():
            ms = event_ms(torch, fn, n=5, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            out[name] = {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "extra_alloc_gib": extra / 2 ** 30,
                         "allowed_gib": allowed / 2 ** 30}
    return out


def streaming_path(torch, dev, arch, n_layers, population, batch, seq, seed=0):
    """The streaming engines at published widths: (a) refill under the
    rung rule per step, (b) chunked, (c) chunked with the rule in the
    chunks, (d) streaming PBT chunked, (e) per step; beside them the same
    grid as batch flights under the rung rule, one refilled trial rerun as
    the first lane of a fresh batch flight, the lane ops timed, and one
    replayed rule chunk profiled.  The per-step flights run first (beside
    the captured state and its pool a second falcon-mamba state does not
    fit).  Returns the kernels' launches on the card over the phase."""
    import numpy as np

    from repro_torch.data.pipeline import split_streams
    from repro_torch.launch.hpo import PopulationTrial
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train import population as P

    P.clear_population_cache()
    geo = dict(arch=arch, n_layers=n_layers, population=population, batch=batch, seq=seq)
    plan = (("a_refill_per_step", "asha", 1, False, True),
            ("e_pbt_per_step", "pbt", 1, False, True),
            ("b_refill_chunked", "asha", STREAM["chunk"], False, True),
            ("c_refill_device_rules", "asha", STREAM["chunk"], True, True),
            ("d_pbt_chunked", "pbt", STREAM["chunk"], False, True),
            ("batch_inflight", "asha", STREAM["chunk"], False, False),
            # the same rung flight as chunked_path's, streaming and as batches:
            # what refilling cut lanes does to the active lane share
            ("f_refill_rungs", "rungs", STREAM["chunk"], False, True),
            ("g_batch_rungs", "rungs", STREAM["chunk"], False, False),
            # what users send: the ASHA proposer, promotions offered mid-flight
            ("h_asha_proposer", "asha_proposer", STREAM["chunk"], False, True))
    flights = {}
    for name, kind, chunk, device_rules, refill in plan:
        flights[name] = stream_flight(torch, dev, **geo, kind=kind, chunk_steps=chunk,
                                      device_rules=device_rules, lane_refill=refill,
                                      seed=seed)
    a, b, c = (flights[n] for n in ("a_refill_per_step", "b_refill_chunked",
                                    "c_refill_device_rules"))
    d, e = flights["d_pbt_chunked"], flights["e_pbt_per_step"]

    # the refill contract: wave 2's first trial (always kept: it meets an
    # empty rung history) refilled a used lane; as the first lane of a fresh
    # batch flight of the same geometry it must score the same, bit for bit
    rerun_key = f"j{population}"
    fresh = PopulationTrial(arch, STREAM["steps"], batch, seq, seed, population=population,
                            model_overrides=published_widths(arch, n_layers), device=dev,
                            chunk_steps=2)
    rerun = (fresh.run_population([b["configs"][rerun_key]])[0]
             if rerun_key in b["configs"] else None)
    tc, data = fresh._setup()
    del fresh
    gc.collect()
    torch.cuda.empty_cache()

    # one replayed rule chunk (staggered, 4 steps, the history capacity the
    # flights used): its step time and its profile
    per_step = launches_per_step(tc.model, chunked=True)
    chunk = STREAM["chunk"]
    rule_graphs = [g for g in P.graph_stats() if g["kind"] == "rulescan" and g["chunk"] == chunk]
    cap = rule_graphs[0]["shape"]["hist"][1] if rule_graphs else population
    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=10 ** 6), tc)]
                       * population, dev)
    lo, hi = (torch.tensor(w.astype("int64"), device=dev)
              for w in split_streams(list(range(population))))
    steps0 = torch.zeros(population, dtype=torch.int64, device=dev)
    prog = P.get_compiled_population_rule_scan_step(tc, population, data, chunk, "staggered")
    hist = np.full((1, cap), np.inf, np.float32)
    rules = P.staggered_rule_state(np.full(population, 10.0 ** 6), np.zeros(population),
                                   np.zeros(population), [STREAM["min_iter"]], STREAM["eta"],
                                   hist, np.zeros(1, np.int32), dev)
    n_graphs = len(P.graph_stats())
    with P.flight_lease(tc, population, data, True, dev) as state:
        def dispatch():
            return prog(state, hp, steps0, lo, hi, rules)

        dispatch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dispatch()
        torch.cuda.synchronize()
        rule_chunk_s = (time.perf_counter() - t0) / 3
        prof = profile_step(torch, dispatch)
    seen = graph_kernels(P, "rulescan", chunk, mode="staggered",
                         shape={n: list(v.shape) for n, v in rules.items()})
    prof.pop("launches", None)
    recaptured = len(P.graph_stats()) != n_graphs
    ops = lane_op_timings(torch, dev, tc, data, population)
    graphs = P.graph_stats()
    total = torch.cuda.get_device_properties(0).total_memory

    def same(x, y, fields):
        return all(x[f] == y[f] for f in fields)

    fields = ("scores", "extras", "order", "truncated", "train_steps")
    cut = {n: sorted(k for k, x in f["extras"].items() if x and x["steps"] < 2 * STREAM["steps"]
                     and int(k[1:]) >= population)
           for n, f in flights.items() if f["kind"] == "asha" and f["lane_refill"]}
    # (a)-(e): each lane takes a second lease
    lanes_used = {n: sorted({x["lane"] for x in f["extras"].values() if x})
                  for n, f in flights.items()
                  if f["lane_refill"] and f["kind"] in ("asha", "pbt")}
    leases_per_lane = {n: {ln: sum(1 for x in flights[n]["extras"].values()
                                   if x and x["lane"] == ln) for ln in lanes}
                       for n, lanes in lanes_used.items()}
    chunked = [f for f in flights.values() if f["chunk_steps"] > 1]
    # wrapper calls in a chunked flight: the warm-up step before the
    # geometry's first capture, and the calls of each capture (a chunk of t
    # steps: t calls a kernel); an eager training step would add more
    want_calls = {n: {k: v * (int(n == "b_refill_chunked")
                              + sum(g["chunk"] for g in f["new_graphs"]))
                      for k, v in per_step.items()}
                  for n, f in flights.items() if f["chunk_steps"] > 1}
    replayed = sum(f["train_steps"] for f in chunked)
    eager = {k: sum(f["launches"][k] for f in flights.values() if f["chunk_steps"] == 1)
             for k in per_step}
    launches = {k: eager[k] + v * (1 + replayed) for k, v in per_step.items()}
    peak_reserved = max(f["peak_reserved_gib"] for f in flights.values())
    out = {
        "phase": "streaming_path", "arch": arch, "n_layers": tc.model.n_layers,
        "population": population, "batch": batch, "seq": seq,
        "flights": {n: {k: v for k, v in f.items() if k not in ("configs",)}
                    for n, f in flights.items()},
        "cut": cut, "leases_per_lane": leases_per_lane,
        "active_lane_share": {n: f["active_lane_share"] for n, f in flights.items()},
        "dispatches_per_step": {n: f["dispatches_per_step"] for n, f in flights.items()},
        "s_per_result": {n: f["s_per_result"] for n, f in flights.items()},
        "refill_rerun": {"job": rerun_key, "streamed": b["scores"].get(rerun_key),
                         "fresh": rerun},
        "rule_chunk": {"chunk": chunk, "hist_capacity": cap, "replayed_s": rule_chunk_s,
                       "replayed_s_per_step": rule_chunk_s / chunk, "recaptured": recaptured,
                       "kernel_launches_seen": seen, "profile": prof},
        "lane_ops": ops,
        "graphs": graphs,
        "wrapper_calls": {n: f["launches"] for n, f in flights.items() if f["chunk_steps"] > 1},
        "wrapper_calls_want": want_calls,
        "launches": launches, "launches_per_step": per_step,
        "peak_reserved_gib": peak_reserved, "card_total_gib": total / 2 ** 30,
    }
    emit(out)
    problems = []
    for n, f in flights.items():
        if not f["finished"]:
            problems.append(f"{n}: not every trial finished: {f['errors']}")
        if f["flight_deaths"] or f["flight_restarts"] or f["quarantined"]:
            problems.append(f"{n}: {f['flight_deaths']} flight deaths, {f['flight_restarts']} "
                            f"restarts, {f['quarantined']} jobs quarantined")
        if f["lane_refill"] and f["streamed"] != len(f["order"]):
            problems.append(f"{n}: {f['streamed']} of {len(f['order'])} results streamed")
    for n, f in (("b", b), ("c", c)):
        if not same(f, a, fields):
            problems.append(f"({n}) differs from (a): " + ", ".join(
                x for x in fields if f[x] != a[x]))
    if not cut["a_refill_per_step"]:
        problems.append("the rung rule cut no lane")
    if c["dispatches"] >= b["dispatches"]:
        problems.append(f"device rules made {c['dispatches']} dispatches, host rules "
                        f"{b['dispatches']}")
    for n, per_lane in leases_per_lane.items():
        if len(per_lane) != population or min(per_lane.values()) < 2:
            problems.append(f"{n}: not every lane took a second lease: {per_lane}")
    if rerun is None or rerun != b["scores"].get(rerun_key):
        problems.append(f"the refilled trial {rerun_key} scored "
                        f"{b['scores'].get(rerun_key)} streamed and {rerun} in a fresh flight")
    if d["scores"] != e["scores"]:
        problems.append(f"streaming PBT chunked and per step differ: {d['scores']} "
                        f"{e['scores']}")
    for n, f in (("d", d), ("e", e)):
        if f["clones"] < 1 or f["host_ckpt_roundtrips"] != 0:
            problems.append(f"PBT ({n}): {f['clones']} clones, {f['host_ckpt_roundtrips']} "
                            f"host checkpoint round trips")
        if not f["clone_checks"] or not all(x["equal"] for x in f["clone_checks"]):
            problems.append(f"PBT ({n}): clone targets differ from their donors: "
                            f"{f['clone_checks']}")
    for n, want in want_calls.items():
        if flights[n]["launches"] != want:
            problems.append(f"{n}: wrapper calls {flights[n]['launches']}, want {want} "
                            f"(an eager training step in a chunked flight)")
    if recaptured:
        problems.append("the profiled rule chunk was captured anew")
    for k, v in per_step.items():
        if seen.get(k) != v * chunk:
            problems.append(f"{k}: {seen.get(k)} launches in the replayed rule chunk's "
                            f"graph, want {v} x {chunk}")
    if prof.get("device_ms") is None:
        problems.append("the profiled rule chunk shows no device time")
    for name, op in ops.items():
        if not isinstance(op, dict):
            continue
        # 64 MiB for the index tensors and the allocator's rounding
        if op["extra_alloc_gib"] > op["allowed_gib"] + 1 / 16:
            problems.append(f"lane op {name} allocated {op['extra_alloc_gib']:.3f} GiB beside "
                            f"the state, more than {op['allowed_gib']:.3f} GiB (init: one "
                            f"lane's parameters and one fp32 leaf; clone: one leaf's rows)")
    if peak_reserved * 2 ** 30 >= total:
        problems.append(f"peak reserved {peak_reserved} GiB is not below the card's total")
    P.clear_population_cache()
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        die(f"streaming path {arch}: " + "; ".join(problems))
    return launches, out


# ------------------------------------------------------ phase 4, crash safety
def ring_stats(trial) -> dict:
    """A trial's prefetch-ring telemetry, summed over its flights."""
    return {"fills": trial.n_ring_fills, "invalidations": trial.n_ring_invalidations,
            "fill_wait_s": trial.ring_fill_wait_s, "fill_busy_s": trial.ring_fill_busy_s,
            "overlap_frac": trial.ring_overlap_frac}


def graph_keys(P) -> set:
    return {(g["kind"], g["mode"], g["chunk"], json.dumps(g["shape"])) for g in P.graph_stats()}


def calls_for(per_step: dict, graphs, warm_up: bool) -> dict:
    """The wrapper calls a flight of chunk programs makes with no eager
    training step: the warm-up step before the geometry's first capture (a
    scan step of 1, its synthesis included) and each new graph's capture (a
    chunk of t steps: t calls a kernel; a ring chunk makes no synthesis)."""
    out = {}
    for k, v in per_step.items():
        n = v * int(warm_up)
        for g in graphs:
            if not (k == "synth_tokens" and g["kind"] == "ringscan"):
                n += v * g["chunk"]
        out[k] = n
    return out


def flight_launches(seen: dict, in_chunk_steps: int, ring_steps: int, warm_up) -> dict:
    """Kernel launches on the card of chunked flights: the kernel nodes of
    the replayed chunk's graph (``seen["scan"]``: in-chunk synthesis,
    ``seen["ring"]``: ring-fed), per step, times the steps replayed that
    way, plus the eager warm-up step before the geometry's first capture
    (``warm_up``: a step's launches, or None)."""
    return {k: seen["scan"][k] // CHUNK * in_chunk_steps + seen["ring"][k] // CHUNK * ring_steps
            + (warm_up[k] if warm_up else 0) for k in seen["scan"]}


def replayed_chunk_profile(torch, dev, tc, data, population, ring_capacity=None):
    """``profile_step`` over one replay of the geometry's captured chunk of
    ``CHUNK`` steps, every lane active from cursor 0: the in-chunk synthesis
    chunk, or with ``ring_capacity`` the ring-fed chunk reading the
    geometry's ring tensor from slot 0.  Fails if that graph was not
    captured by the flights before it, or if the profile captured one."""
    from repro_torch.data.pipeline import split_streams
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train import population as P

    hp = stack_hparams([hparams_from_dict(dict(learning_rate=1e-3, total_steps=10 ** 6), tc)]
                       * population, dev)
    if ring_capacity is None:
        prog = P.get_compiled_population_scan_step(tc, population, data, CHUNK,
                                                   per_trial_batch=True)
        steps0 = torch.zeros(population, dtype=torch.int64, device=dev)
        lo, hi = (torch.tensor(w.astype("int64"), device=dev)
                  for w in split_streams(list(range(population))))
        key = ("scan", None, CHUNK, "null")
        call = lambda state: prog(state, hp, steps0, lo, hi)  # noqa: E731
    else:
        ring = P.ring_buffer(tc, population, data, ring_capacity, dev)
        prog = P.get_compiled_population_ring_scan_step(tc, population, data, CHUNK,
                                                        ring_capacity)
        key = ("ringscan", None, CHUNK, json.dumps({"ring": list(ring.shape)}))
        call = lambda state: prog(state, hp, ring, 0)  # noqa: E731
    keys = graph_keys(P)
    if key not in keys:
        die(f"no captured {key[0]} chunk of {CHUNK} steps to profile: {sorted(keys)}")
    with P.flight_lease(tc, population, data, True, dev) as state:
        prof = profile_step(torch, lambda: call(state))
    if graph_keys(P) != keys:
        die(f"profiling the replayed {key[0]} chunk captured a graph")
    prof.pop("launches")
    prof["graph_kernel_launches"] = graph_kernels(P, key[0], CHUNK,
                                                  shape=json.loads(key[3]))
    return prof


def card_memory(torch) -> dict:
    """The card's free memory, the allocator's reserved and allocated bytes,
    and its largest segments with the bytes still allocated in each."""
    free, total = torch.cuda.mem_get_info()
    segs = sorted(torch.cuda.memory_snapshot(), key=lambda g: -g["total_size"])
    return {"free_gib": free / 2 ** 30, "total_gib": total / 2 ** 30,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
            "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
            "segments": len(segs),
            "largest_segments_mib": [[g["total_size"] / 2 ** 20, g["allocated_size"] / 2 ** 20]
                                     for g in segs[:8]]}


def release_cublas_workspaces(torch) -> None:
    """Free the cuBLAS workspaces earlier phases' capture streams left: each
    such block keeps its whole segment reserved."""
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear_workspaces is not None:
        clear_workspaces()
    gc.collect()
    torch.cuda.empty_cache()


def crash_flight(torch, dev, arch, n_layers, population, batch, seq, *, data_ring,
                 fault=None, snapshot_every=0, seed=0):
    """A chunked refill flight of ``CRASH_SPACE``'s grid through the
    Experiment and the vectorized manager (whose supervisor restarts a
    flight that dies), with an in-memory snapshot store; ``fault`` is armed
    for the flight only.  The launch counters are set to 0 just before it
    and read just after."""
    from repro_torch.checkpoint import LaneSnapshotStore
    from repro_torch.core import faultinject
    from repro_torch.core.experiment import Experiment
    from repro_torch.core.job import JobStatus
    from repro_torch.launch.hpo import PopulationTrial
    from repro_torch.train import population as P

    trial = PopulationTrial(arch, CRASH["steps"], batch, seq, seed, population=population,
                            model_overrides=published_widths(arch, n_layers), device=dev,
                            chunk_steps=CHUNK, snapshot_every=snapshot_every,
                            snapshots=LaneSnapshotStore(), data_ring=data_ring,
                            ring_windows=RING_WINDOWS)
    exp = Experiment({"proposer": "grid", "parameter_config": CRASH_SPACE, "target": "max",
                      "seed": seed, "resource": "vectorized", "n_parallel": population,
                      "lane_refill": True, "restart_backoff_s": 0.01}, trial)
    jobs = []
    exp.add_result_callback(jobs.append)
    graphs0 = graph_keys(P)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    faultinject.disarm()
    if fault:
        faultinject.arm(fault)
    t0 = time.perf_counter()
    try:
        exp.run()
    finally:
        faultinject.disarm()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"ring": data_ring, "fault": fault, "snapshot_every": snapshot_every, "wall_s": wall,
           "launches": counters(), "train_steps": trial.n_train_steps,
           "dispatches": trial.n_dispatches,
           "new_graphs": [g for g in P.graph_stats()
                          if (g["kind"], g["mode"], g["chunk"], json.dumps(g["shape"]))
                          not in graphs0],
           "finished": len(jobs) == exp.proposer.n_samples
                       and all(j.status == JobStatus.FINISHED for j in jobs),
           "errors": [j.result.error for j in jobs
                      if j.status != JobStatus.FINISHED and j.result is not None],
           "scores": {f"j{j.job_id}": None if j.result is None else j.result.score for j in jobs},
           "flight_deaths": exp.rm.n_flight_deaths, "flight_restarts": exp.rm.n_flight_restarts,
           "quarantined": exp.rm.n_quarantined, "snapshots": trial.n_snapshots,
           "lane_restores": trial.n_lane_restores,
           "resumed_from_steps": list(trial.resumed_from_steps),
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "ring_stats": ring_stats(trial) if data_ring else None}
    tc, data = trial._setup()
    del exp, trial
    gc.collect()
    return out, tc, data


def timed(torch, fn, n=2):
    """Host seconds of each of ``n`` calls of ``fn``, synchronised."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def trees_bit_equal(torch, a, b) -> bool:
    from repro_torch.interop import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    raw = lambda t: t.view(getattr(torch, INT_OF_SIZE[t.element_size()])) \
        if t.dtype != torch.bool else t.to(torch.uint8)  # noqa: E731
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(raw(x), raw(y))
        for x, y in zip(la, lb))


def lane_snapshot_costs(torch, dev, tc, data, population, src=1, dst=2):
    """On the geometry's captured state: copy lane ``src`` into fresh
    pageable host tensors (a plain loop over the lane views), then snapshot
    it twice with the engine's op, into a new page-locked slot (its
    allocation and registration included) and, once released, into the
    same slot again; restore the pageable copy and the snapshot into lane
    ``dst``; each timed beside a plain copy of the same bytes between the
    lane views and the slot (the link's rate, the bound); the state's
    checksums before and after a snapshot; lane ``dst`` against lane
    ``src`` in raw bits; the device memory each op allocated beside the
    state; the host bytes the slots page-lock.  Then the snapshot through a
    ``LaneSnapshotStore`` on disk and back, raw bits compared, write and
    read rates; the free bytes are checked first and the directory is
    removed."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import LaneSnapshotStore
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.train import population as P

    out = {}
    with P.flight_lease(tc, population, data, True, dev) as state:
        if state is None:
            die("crash path: no captured state to snapshot")
        leaves = tree_leaves(state)
        lane_bytes = sum(t[0].numel() * t.element_size() for t in leaves)
        leaf_bytes = max(t[0].numel() * t.element_size() for t in leaves)
        out.update(lane_state_gib=lane_bytes / 2 ** 30, largest_leaf_lane_gib=leaf_bytes / 2 ** 30)
        snapshot_fn = P.get_lane_op(tc, population, "snapshot")
        restore_fn = P.get_lane_op(tc, population, "restore")
        lane_tree = {"inner": state["inner"], "diverged": state["diverged"],
                     "last_loss": state["last_loss"]}
        before = state_checksums(torch, state)
        t0 = time.perf_counter()
        pageable = tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype).copy_(t[src]),
                            lane_tree)
        pageable_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        snap = snapshot_fn(state, src)
        pinned_cold_s = time.perf_counter() - t0
        snap_extra = torch.cuda.max_memory_allocated() - base
        unchanged = state_checksums(torch, state) == before
        first = snap
        P.release_lane_snapshot(snap)
        t0 = time.perf_counter()
        snap = snapshot_fn(state, src)
        pinned_warm_s = time.perf_counter() - t0
        slot_reused = snap is first
        pinned = all(t.is_pinned() for t in tree_leaves(snap))
        pinned_equal = trees_bit_equal(torch, snap, pageable)
        # the bound: the same bytes between the lane views and the slot
        views = list(zip(leaves, tree_leaves(snap)))

        def d2h():
            for t, v in views:
                v.copy_(t[src])

        def h2d():
            for t, v in views:
                t[dst].copy_(v)

        d2h_s = min(timed(torch, d2h))
        h2d_s = min(timed(torch, h2d))          # writes lane dst: restored over below
        del views
        restore_pageable_s = timed(torch, lambda: restore_fn(state, dst, pageable))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        restore_s = timed(torch, lambda: restore_fn(state, dst, snap))
        restore_extra = torch.cuda.max_memory_allocated() - base
        restored_equal = lane_checksums(torch, state, dst) == lane_checksums(torch, state, src)
        del pageable
        gc.collect()
        gb = lane_bytes / 1e9
        out.update({
            "snapshot_pageable_ms": pageable_s * 1e3,
            "snapshot_pinned_cold_ms": pinned_cold_s * 1e3,
            "snapshot_pinned_warm_ms": pinned_warm_s * 1e3,
            "restore_pageable_ms": [x * 1e3 for x in restore_pageable_s],
            "restore_pinned_ms": [x * 1e3 for x in restore_s],
            "bound_d2h_ms": d2h_s * 1e3, "bound_h2d_ms": h2d_s * 1e3, "bound_by": "host link",
            "link_d2h_gb_s": gb / d2h_s, "link_h2d_gb_s": gb / h2d_s,
            "snapshot_pageable_gb_s": gb / pageable_s,
            "snapshot_pinned_cold_gb_s": gb / pinned_cold_s,
            "snapshot_pinned_warm_gb_s": gb / pinned_warm_s,
            "restore_pageable_gb_s": gb / min(restore_pageable_s),
            "restore_pinned_gb_s": gb / min(restore_s),
            "snapshot_slots": P.lane_snapshot_slot_stats(),
            "snapshot_extra_alloc_gib": snap_extra / 2 ** 30,
            "restore_extra_alloc_gib": restore_extra / 2 ** 30,
            "state_unchanged_by_snapshot": unchanged, "pinned_equals_pageable": pinned_equal,
            "snapshot_slot_pinned_and_reused": pinned and slot_reused,
            "restored_lane_equals_source": restored_equal})
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    need = lane_bytes + (1 << 30)
    out.update(disk_free_gib=free / 2 ** 30, disk_need_gib=need / 2 ** 30)
    if free < need:
        die(f"crash path: {free / 2 ** 30:.1f} GiB free under {root}, the disk round trip "
            f"of one lane snapshot needs {need / 2 ** 30:.1f} GiB")
    tmp = tempfile.mkdtemp(prefix="lane_snapshots_", dir=root)
    try:
        meta = {"local": 4, "stream": 0, "applied": 4, "applied0": 0, "budget": 8.0,
                "data_cursor": 4}
        t0 = time.perf_counter()
        LaneSnapshotStore(root=tmp).put(0, snap, meta)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = LaneSnapshotStore(root=tmp).get(0)
        read_s = time.perf_counter() - t0
        disk_equal = trees_bit_equal(torch, back, snap)
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(disk_write_s=write_s, disk_read_s=read_s, disk_write_gb_s=lane_bytes / 1e9 / write_s,
               disk_read_gb_s=lane_bytes / 1e9 / read_s, disk_round_trip_equal=disk_equal,
               disk_dir_removed=not Path(tmp).exists())
    P.release_lane_snapshot(snap)
    del snap
    gc.collect()
    return out


def crash_path(torch, dev, arch, n_layers, population, batch, seq, seed=0):
    """Crash safety at published widths: the unbroken chunked refill flight
    of ``CRASH_SPACE``; then (a) snapshot and restore on its captured state,
    timed against a plain copy of the same bytes, and (d) one snapshot
    through the store's disk copy and back; (b) the flight killed by
    ``raise@step`` under the supervisor, its lanes restored from the
    in-memory store; (c) the same ring-fed; (b) and (c) against the
    unbroken flight; the snapshot slots the flights left.  Then the
    profiler over one replayed in-chunk and one replayed ring-fed chunk,
    and the kernel nodes of their graphs.  Returns the kernels' launches on
    the card over the phase (the graphs' counts a step times the steps
    replayed, plus the warm-up
    step) and the report, whose ``replayed_chunk_launches_seen`` holds the
    two counts."""
    from repro_torch.train import population as P

    P.clear_population_cache()
    memory = {"before": card_memory(torch)}
    # falcon-mamba's flights need that memory beside the captured state and
    # its pool
    release_cublas_workspaces(torch)
    memory["after_release"] = card_memory(torch)
    geo = dict(arch=arch, n_layers=n_layers, population=population, batch=batch, seq=seq)
    flights = {}
    for name, ring, fault, every in (("unbroken", False, None, 0),
                                     ("killed", False, CRASH["fault"], 1),
                                     ("killed_ring", True, CRASH["fault"], 1)):
        flights[name], tc, data = crash_flight(torch, dev, **geo, data_ring=ring, fault=fault,
                                               snapshot_every=every, seed=seed)
        if name == "unbroken":
            # before the killed flights' harvests: its first snapshot makes
            # the geometry's first page-locked slot
            ops = lane_snapshot_costs(torch, dev, tc, data, population)
    slots = P.lane_snapshot_slot_stats()
    # what a replayed chunk launches on the card, in-chunk synthesis and
    # ring-fed, from their graphs; ring_path's flights replay these graphs
    profiles = {"scan": replayed_chunk_profile(torch, dev, tc, data, population),
                "ring": replayed_chunk_profile(torch, dev, tc, data, population,
                                               ring_capacity=RING_WINDOWS * CHUNK)}
    seen = {k: prof.pop("graph_kernel_launches") for k, prof in profiles.items()}
    per_step = launches_per_step(tc.model, chunked=True)
    want_seen = {"scan": {k: v * CHUNK for k, v in per_step.items()},
                 "ring": {k: 0 if k == "synth_tokens" else v * CHUNK
                          for k, v in per_step.items()}}
    want_calls = {n: calls_for(per_step, f["new_graphs"], warm_up=n == "unbroken")
                  for n, f in flights.items()}
    launches = flight_launches(
        seen, sum(f["train_steps"] for f in flights.values() if not f["ring"]),
        sum(f["train_steps"] for f in flights.values() if f["ring"]), per_step)
    out = {"phase": "crash_path", "arch": arch, "n_layers": tc.model.n_layers,
           "population": population, "batch": batch, "seq": seq, "chunk": CHUNK,
           "memory_at_start": memory,
           "flights": flights, "lane_ops": ops, "snapshot_slots_after_flights": slots,
           "host_pinned_gib": sum(g["pinned_bytes"] for g in slots) / 2 ** 30,
           "wrapper_calls_want": want_calls, "replayed_chunk_launches_seen": seen,
           "replayed_chunk_profiles": profiles, "launches": launches,
           "launches_per_step": per_step}
    emit(out)
    problems = []
    for kind, want in want_seen.items():
        if seen[kind] != want:
            problems.append(f"{seen[kind]} launches in the replayed {kind} chunk's graph, "
                            f"want {want}")
        if profiles[kind].get("device_ms") is None:
            problems.append(f"the profiled {kind} chunk shows no device time")
    if len(slots) != 1 or slots[0]["slots"] > population + 1 or slots[0]["held"] \
            or slots[0]["pinned_bytes"] != slots[0]["slots"] * slots[0]["slot_bytes"]:
        problems.append(f"snapshot slots after the flights {slots}: want at most K + 1 = "
                        f"{population + 1} page-locked, none held")
    base = flights["unbroken"]
    for n, f in flights.items():
        if not f["finished"]:
            problems.append(f"{n}: not every trial finished: {f['errors']}")
        if f["launches"] != want_calls[n]:
            problems.append(f"{n}: wrapper calls {f['launches']}, want {want_calls[n]} (an "
                            f"eager training step in a chunked flight)")
        if f["quarantined"]:
            problems.append(f"{n}: {f['quarantined']} jobs quarantined")
    if base["flight_deaths"] or base["flight_restarts"]:
        problems.append(f"the unbroken flight died {base['flight_deaths']} times")
    for n in ("killed", "killed_ring"):
        f = flights[n]
        if f["scores"] != base["scores"]:
            problems.append(f"{n}: scores {f['scores']} differ from the unbroken flight's "
                            f"{base['scores']}")
        if (f["flight_deaths"], f["flight_restarts"]) != (1, 1):
            problems.append(f"{n}: {f['flight_deaths']} deaths and {f['flight_restarts']} "
                            f"restarts, want 1 and 1")
        if f["lane_restores"] < 1 or not all(x > 0 for x in f["resumed_from_steps"]):
            problems.append(f"{n}: {f['lane_restores']} lane restores from steps "
                            f"{f['resumed_from_steps']}, want one or more, each past step 0")
    if not flights["killed_ring"]["new_graphs"] or not all(
            g["kind"] == "ringscan" for g in flights["killed_ring"]["new_graphs"]):
        problems.append(f"the ring-fed flight captured {flights['killed_ring']['new_graphs']}")
    for key in ("state_unchanged_by_snapshot", "pinned_equals_pageable",
                "snapshot_slot_pinned_and_reused", "restored_lane_equals_source",
                "disk_round_trip_equal", "disk_dir_removed"):
        if not ops[key]:
            problems.append(f"lane snapshot: {key} is false")
    # 64 MiB for the allocator's rounding, as the streaming path allows
    allowed = ops["largest_leaf_lane_gib"] + 1 / 16
    for key in ("snapshot_extra_alloc_gib", "restore_extra_alloc_gib"):
        if ops[key] > allowed:
            problems.append(f"lane snapshot: {key} {ops[key]:.3f} GiB beside the state, more "
                            f"than one leaf ({allowed:.3f} GiB)")
    if problems:
        P.clear_population_cache()
        die(f"crash path {arch}: " + "; ".join(problems))
    return launches, out


# ------------------------------------------------------- phase 4, the ring
def queue_flight(torch, dev, arch, n_layers, population, batch, seq, *, data_ring, seed=0):
    """``RING_REFILL_ITERS``'s trials through one refill flight
    (``QueueFeedScheduler``), chunked, in-chunk synthesis or ring-fed;
    per-step losses and the final state's checksums recorded.  The launch
    counters are set to 0 just before it and read just after."""
    from repro_torch.core.resource.vectorized import QueueFeedScheduler
    from repro_torch.launch.hpo import PopulationTrial
    from repro_torch.train import population as P

    trial = PopulationTrial(arch, CRASH["steps"], batch, seq, seed, population=population,
                            model_overrides=published_widths(arch, n_layers), device=dev,
                            chunk_steps=CHUNK, data_ring=data_ring, ring_windows=RING_WINDOWS,
                            refill_idle_grace_s=0.0)
    record = []
    trial.record_flight = lambda ls, ps: record.append((ls, state_checksums(torch, ps)))
    cfgs = [{"learning_rate": 1e-3 * (i + 1), "n_iterations": n, "stream": i}
            for i, n in enumerate(RING_REFILL_ITERS)]
    feed = QueueFeedScheduler(cfgs)
    graphs0 = graph_keys(P)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    trial.run_population([], scheduler=feed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses, sums = record[0] if record else (None, None)
    out = {"ring": data_ring, "wall_s": wall, "launches": counters(),
           "train_steps": trial.n_train_steps, "dispatches": trial.n_dispatches,
           "s_per_step": wall / max(1, trial.n_train_steps), "refills": trial.n_refills,
           "new_graphs": [g for g in P.graph_stats()
                          if (g["kind"], g["mode"], g["chunk"], json.dumps(g["shape"]))
                          not in graphs0],
           "scores": [feed.scores.get(i) for i in range(len(cfgs))],
           "order": list(feed.scores), "ring_stats": ring_stats(trial) if data_ring else None}
    del trial
    gc.collect()
    return out, losses, sums


def ring_path(torch, dev, arch, n_layers, population, batch, seq, seen, seed=0):
    """The prefetch ring at published widths: a batch flight (8 steps, two
    chunks of 4) and a refill flight (``RING_REFILL_ITERS``), each fed by
    in-chunk synthesis and then by a ring of ``RING_WINDOWS`` windows of 4;
    per-step losses and the final state's checksums equal, no eager step,
    the ring's telemetry and bytes.  Runs on the graphs ``crash_path``
    captured, which captures none: no flight here captures a graph.
    Returns the kernels' launches on the card over the phase, from the
    kernel nodes of ``crash_path``'s replayed chunk graphs (``seen``)."""
    from repro_torch.train import population as P

    geo = dict(arch=arch, n_layers=n_layers, population=population, batch=batch, seq=seq)
    flights, losses, sums, graphs = {}, {}, {}, {}
    for name, ring in (("batch", False), ("batch_ring", True)):
        before = graph_keys(P)
        flights[name], losses[name], sums[name], tc, data = run_flight(
            torch, dev, **geo, steps=CHUNK_FLIGHT_STEPS, chunk_steps=CHUNK, seed=seed,
            data_ring=ring)
        graphs[name] = [g for g in P.graph_stats()
                        if (g["kind"], g["mode"], g["chunk"], json.dumps(g["shape"]))
                        not in before]
    for name, ring in (("refill", False), ("refill_ring", True)):
        flights[name], losses[name], sums[name] = queue_flight(torch, dev, **geo,
                                                                data_ring=ring, seed=seed)
        graphs[name] = flights[name].pop("new_graphs")
    per_step = launches_per_step(tc.model, chunked=True)
    want_calls = {n: calls_for(per_step, graphs[n], warm_up=False) for n in flights}
    launches = flight_launches(
        seen, sum(f["train_steps"] for n, f in flights.items() if "ring" not in n),
        sum(f["train_steps"] for n, f in flights.items() if "ring" in n), None)
    raw = lambda t: t.view(torch.int32)  # noqa: E731  (fp32 losses as raw bits)
    pairs = {"batch_ring": "batch", "refill_ring": "refill"}
    losses_equal = {n: bool(losses[n] is not None and losses[r] is not None
                            and losses[n].shape == losses[r].shape
                            and torch.equal(raw(losses[n]), raw(losses[r])))
                    for n, r in pairs.items()}
    sums_equal = {n: sums[n] is not None and sums[n] == sums[r] for n, r in pairs.items()}
    rb = flights["batch_ring"]["ring"]
    ring_bytes = RING_WINDOWS * CHUNK * population * batch * (seq + 1) * 4
    out = {"phase": "ring_path", "arch": arch, "n_layers": tc.model.n_layers,
           "population": population, "batch": batch, "seq": seq, "chunk": CHUNK,
           "ring_windows": RING_WINDOWS, "ring_bytes": ring_bytes,
           "flights": {n: {k: v for k, v in f.items()} for n, f in flights.items()},
           "graphs": graphs, "losses_bit_equal": losses_equal,
           "state_checksums_equal": sums_equal,
           "s_per_step": {"batch": flights["batch"]["flight_s_per_step"],
                          "batch_ring": flights["batch_ring"]["flight_s_per_step"],
                          "refill": flights["refill"]["s_per_step"],
                          "refill_ring": flights["refill_ring"]["s_per_step"]},
           "overlap_frac": {"batch_ring": rb["overlap_frac"],
                            "refill_ring": flights["refill_ring"]["ring_stats"]["overlap_frac"]},
           "wrapper_calls_want": want_calls, "launches": launches,
           "launches_per_step": per_step}
    emit(out)
    problems = []
    if any(graphs.values()):
        problems.append(f"the ring path's flights captured graphs: {graphs}")
    for n, f in flights.items():
        if f.get("finished") is False:
            problems.append(f"{n}: not every trial finished: {f['errors']}")
        if f["launches"] != want_calls[n]:
            problems.append(f"{n}: wrapper calls {f['launches']}, want {want_calls[n]} (an "
                            f"eager training step in a chunked flight)")
    if not all(losses_equal.values()):
        problems.append(f"ring-fed per-step losses differ from in-chunk synthesis: {losses_equal}")
    if not all(sums_equal.values()):
        problems.append(f"ring-fed final states differ from in-chunk synthesis: {sums_equal}")
    if flights["refill_ring"]["scores"] != flights["refill"]["scores"] or \
            flights["refill_ring"]["order"] != flights["refill"]["order"]:
        problems.append("the ring-fed refill flight streamed other scores or another order")
    if flights["refill_ring"]["refills"] < 2:
        problems.append(f"the refill flight refilled {flights['refill_ring']['refills']} lanes")
    for n in pairs:
        st = rb if n == "batch_ring" else flights[n]["ring_stats"]
        if st["fills"] < 2 or not 0.0 <= st["overlap_frac"] <= 1.0:
            problems.append(f"{n}: ring telemetry {st}")
    P.clear_population_cache()
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        die(f"ring path {arch}: " + "; ".join(problems))
    return launches, out


# ------------------------------------------------------------------- phase 5
def leaf_names(tree, prefix="") -> list:
    """Paths of a tree's leaves ("blocks/0/mixer/wq"), in ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def card_vs_cpu_run(torch, dev, arch, steps=3, population=2, batch=2, seq=128):
    """``arch``'s fp32 smoke config, two lanes, ``steps`` population steps on
    the card and on the CPU from the same state and batches: the phase's
    record (loss and parameter max abs errors, the parameter leaf with the
    largest, the card's launches), whether both errors are within 1e-4, and
    the launches the steps should have made."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.optim.hparams import hparams_from_dict, stack_hparams
    from repro_torch.train.population import (init_population_state_from_keys,
                                              make_population_train_step)

    tc = TrainConfig(model=get_smoke_config(arch), parallel=ParallelConfig(remat="none"))
    data = SyntheticLM(tc.model.vocab_size, seq, batch, seed=0)
    cpu = init_population_state_from_keys(
        [torch.Generator().manual_seed(i) for i in range(population)], tc, "cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    cfgs = [dict(learning_rate=3e-3 * (i + 1), warmup_frac=0.34, weight_decay=0.1,
                 b2=0.95, grad_clip=1.0 - 0.5 * i, total_steps=steps)
            for i in range(population)]
    hps = [hparams_from_dict(c, tc) for c in cfgs]
    step = make_population_train_step(tc, per_trial_batch=True)
    # an MoE layer's top-k experts, by device, to count the assignments
    # that the card routes elsewhere than the CPU
    from repro_torch.models import moe as M

    routed = {"cpu": [], "cuda": []}
    plain_route = M.route

    def recording(router, xt, k):
        got = plain_route(router, xt, k)
        routed[xt.device.type].append(got[2].detach().cpu())
        return got

    M.route = recording
    before = counters()
    loss_err = 0.0
    try:
        for t in range(steps):
            b = data.make_population_batch(t, list(range(population)))
            cpu, mc = step(cpu, to_device(b, "cpu"), stack_hparams(hps, "cpu"))
            card, mg = step(card, to_device(b, dev), stack_hparams(hps, dev))
            loss_err = max(loss_err, float((mg["loss"].cpu() - mc["loss"]).abs().max()))
    finally:
        M.route = plain_route
    ok = loss_err <= 1e-4
    param_err, worst = 0.0, None
    for name, a, b in zip(leaf_names(cpu["inner"]["params"]),
                          tree_leaves(card["inner"]["params"]),
                          tree_leaves(cpu["inner"]["params"])):
        a = a.cpu()
        err = float((a - b).abs().max())
        if err > param_err:
            param_err, worst = err, name
        ok = ok and bool(torch.allclose(a, b, atol=1e-4, rtol=1e-4))
    through = {name: n - before[name] for name, n in counters().items()}
    want = {name: n * steps for name, n in launches_per_step(tc.model).items()}
    rec = {"phase": "card_vs_cpu", "config": tc.model.name, "dtype": tc.model.param_dtype,
           "population": population, "seq": seq, "steps": steps, "loss_max_abs_err": loss_err,
           "param_max_abs_err": param_err, "param_worst_leaf": worst, "tol": 1e-4,
           "card_launches": through,
           **({"moe_assignments": sum(t.numel() for t in routed["cpu"]),
               "moe_assignments_routed_differently": sum(
                   int((a != b).sum()) for a, b in zip(routed["cpu"], routed["cuda"]))}
              if tc.model.has_moe else {})}
    return rec, ok, want


def card_vs_cpu(torch, dev, arch):
    rec, ok, want = card_vs_cpu_run(torch, dev, arch)
    emit(rec)
    if not ok:
        die(f"card and CPU disagree on {arch}: loss {rec['loss_max_abs_err']}, "
            f"params {rec['param_max_abs_err']} at {rec['param_worst_leaf']}")
    if rec["card_launches"] != want:
        die(f"the card's population steps on {arch} made launches {rec['card_launches']}, "
            f"want {want}")
    return rec["card_launches"]




# ------------------------------------------------------------------- phase 5a
def train_launches_per_step(cfg, remat: str) -> dict:
    """``launches_per_step`` of a one-trial step: with ``remat`` the
    superblocks' forward runs again in the backward pass, so their RMSNorm
    forwards, flash forwards and scans launch twice (the prefix layers and
    the final norm once); the backwards once."""
    per_step = launches_per_step(cfg)
    if remat == "none":
        return per_step
    blocks = list(cfg.pattern) * cfg.n_superblocks
    again = {"rmsnorm": sum((1 + (ffn != "none")) * (1 + bool(cfg.post_norm))
                            + (m == "attn_mla") for m, ffn in blocks),
             "ssm_scan": sum(m == "mamba" for m, _ in blocks)}
    attn = sum(m.startswith("attn") for m, _ in blocks)
    again["flash_attention_sm90" if cfg.compute_dtype == "bfloat16"
          else "flash_attention_fp32"] = attn
    return {k: v + again.get(k, 0) for k, v in per_step.items()}


def train_args(dev, arch, batch, seq, steps, remat="none", extra=()):
    from repro_torch.launch import train as TR

    return TR.parser().parse_args(["--arch", arch, "--batch", str(batch), "--seq", str(seq),
                                   "--steps", str(steps), "--remat", remat,
                                   "--device", dev.type, *extra])


class plain_versions_raise:
    """While open, the plain versions of the RMSNorm and flash forward
    kernels (and of the RMSNorm backward) raise: a step on the card must run
    the kernels only."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rmsnorm as rn

        def refuse(*_, **__):
            raise RuntimeError("a plain version ran on the card's path")

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (rn, "rmsnorm_plain"), (rn, "rmsnorm_bwd_plain"), (fa, "flash_fwd_plain"))]
        for m, n, _ in self.saved:
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def train_path(torch, dev, arch, batch, seq, remat, warmup, timed, seed=0):
    """The one-trial driver's model and step (``launch/train.py``'s
    ``build``) on ``arch`` at its published widths and full depth: ``warmup``
    steps, then ``timed`` steps on device-resident batches (host clock around
    ``synchronize``), the plain kernel versions refused; then one step under
    the profiler.  Gates: a finite loss every step; the kernels' launches a
    step (``train_launches_per_step``: the recomputed superblocks' too) and
    no plain version.  Returns the launches of the steps."""
    import numpy as np

    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import train as TR
    from repro_torch.train.train_step import init_train_state

    release_cublas_workspaces(torch)
    n = warmup + timed
    tc, data, step, _ = TR.build(train_args(dev, arch, batch, seq, n, remat))
    cfg = tc.model
    per_step = train_launches_per_step(cfg, remat)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device=dev).manual_seed(seed), tc, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = tree_bytes(state)
    batches = [to_device(data.make_batch(t), dev) for t in range(n)]
    losses = []
    with plain_versions_raise():
        before = counters()
        for t in range(warmup):
            state, m = step(state, batches[t])
            losses.append(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(warmup, n):
            state, m = step(state, batches[t])
            losses.append(m["loss"])
        torch.cuda.synchronize()
        s_per_step = (time.perf_counter() - t0) / timed
        launches = {k: v - before[k] for k, v in counters().items()}
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step(torch, lambda: step(state, batches[-1]))
    losses = [float(x) for x in losses]
    out = {"phase": "train_path", "arch": arch, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "param_dtype": cfg.param_dtype, "remat": remat,
           "batch": batch, "seq": seq, "warmup_steps": warmup, "timed_steps": timed,
           "init_s": init_s, "state_bytes": state_bytes,
           "param_bytes": tree_bytes(state["params"]),
           "s_per_step": s_per_step, "tokens_per_s": batch * seq / s_per_step,
           "peak_memory_gib": peak / 2 ** 30, "losses": losses,
           "launches": launches, "launches_per_step": per_step,
           "profile_launches": prof.pop("launches"), "profile": prof,
           "card": card_memory(torch)}
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    problems = []
    if not all(np.isfinite(losses)):
        problems.append(f"a loss is not finite: {losses}")
    want = {k: v * n for k, v in per_step.items()}
    if launches != want:
        problems.append(f"launches {launches} over {n} steps, want {want}")
    if out["profile_launches"] != per_step:
        problems.append(f"the profiled step launched {out['profile_launches']}, want {per_step}")
    if problems:
        die(f"train path {arch}: " + "; ".join(problems))
    return launches


def train_run(torch, dev, tc, batches, seed=0, state=None):
    """``make_train_step(tc)`` over ``batches`` from the seeded init (or from
    ``state``): the final state and the losses (fp32, on the card)."""
    from repro_torch.train.train_step import init_train_state, make_train_step

    if state is None:
        state = init_train_state(torch.Generator(device=dev).manual_seed(seed), tc, dev)
    step = make_train_step(tc)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"])
    return state, torch.stack(losses)


def train_checks(torch, dev, arch, n_layers, batch, seq, steps, seed=0):
    """At ``arch``'s published widths, depth cut to ``n_layers``: ``steps``
    steps with remat ``"full"`` and ``"dots"`` against ``"none"`` (losses and
    every state leaf, raw bits); the same with an fp32 master copy (the
    parameters its cast to their dtype, bit for bit; finite losses); a run killed by
    ``--fail-at`` and resumed through the CLI's ``main`` against the step fed
    the reference's batch order (``resume_check``).  Returns the launches."""
    import numpy as np

    from repro_torch.data.pipeline import to_device
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import train as TR
    from repro_torch.models.layers import dtype_of

    release_cublas_workspaces(torch)
    cfg = path_config(arch, n_layers)
    before = counters()
    tc, data, _, _ = TR.build(train_args(dev, arch, batch, seq, steps), model=cfg)
    batches = [to_device(data.make_batch(t), dev) for t in range(steps)]
    sums, losses = {}, {}
    for remat in ("none", "full", "dots"):
        tc_r = dataclasses.replace(tc, parallel=dataclasses.replace(tc.parallel, remat=remat))
        state, loss = train_run(torch, dev, tc_r, batches, seed)
        sums[remat], losses[remat] = state_checksums(torch, state), raw_bits(torch, loss)
        del state
    remat_equal = {r: sums[r] == sums["none"] and torch.equal(losses[r], losses["none"])
                   for r in ("full", "dots")}
    tc_m = dataclasses.replace(tc, parallel=dataclasses.replace(tc.parallel,
                                                                master_dtype="float32"))
    state, loss = train_run(torch, dev, tc_m, batches, seed)
    pdt = dtype_of(cfg.param_dtype)
    master_cast = all(
        p.dtype == pdt and m.dtype == torch.float32
        and torch.equal(raw_bits(torch, p), raw_bits(torch, m.to(pdt)))
        for p, m in zip(tree_leaves(state["params"]), tree_leaves(state["opt"]["master"])))
    master = {"losses": [float(x) for x in loss], "state_bytes": tree_bytes(state),
              "params_equal_master_cast": master_cast}
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    resume = resume_check(torch, dev, cfg, batch, seq, seed)
    launches = {k: v - before[k] for k, v in counters().items()}
    out = {"phase": "train_checks", "arch": arch, "n_layers": cfg.n_layers, "batch": batch,
           "seq": seq, "steps": steps,
           "losses": {r: [float(x) for x in v.view(torch.float32)] for r, v in losses.items()},
           "remat_bit_equal": remat_equal, "master": master, "resume": resume,
           "launches": launches}
    emit(out)
    problems = []
    if not all(remat_equal.values()):
        problems.append(f"remat differs from no remat: {remat_equal}")
    if not master_cast or not all(np.isfinite(master["losses"])):
        problems.append(f"the fp32 master: {master}")
    problems += resume.pop("problems")
    if problems:
        die(f"train checks {arch}: " + "; ".join(problems))
    return launches


def resume_check(torch, dev, cfg, batch, seq, seed=0):
    """``launch/train.py``'s ``main`` on ``cfg`` with a checkpoint directory
    under ``build/``: killed by ``--fail-at`` (exit 17), then rerun (resumed
    from the checkpoint taken after step ``ckpt_every``, stored as that step,
    the loop starting there as the JAX driver's does); its final checkpoint
    and last loss against the step fed batches 0..ckpt_every and then
    ckpt_every..steps-1 from the same init, raw bit for raw bit.  Reports
    every checkpoint write's and the restores' seconds and bytes."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.interop import tree_map
    from repro_torch.launch import train as TR

    c = TRAIN_CRASH
    argv = ["--batch", str(batch), "--seq", str(seq), "--steps", str(c["steps"]),
            "--ckpt-every", str(c["ckpt_every"]), "--log-every", "1", "--seed", str(seed),
            "--device", dev.type]
    tc, data, _, _ = TR.build(TR.parser().parse_args(argv), model=cfg)
    # the reference first: the same init fed the resumed run's batch order
    resumed_at = c["ckpt_every"]
    order = list(range(resumed_at + 1)) + list(range(resumed_at, c["steps"]))
    state, loss = train_run(torch, dev, tc, [data.make_batch(t) for t in order], seed)
    want, state_bytes = state_checksums(torch, state), tree_bytes(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    need = 3 * state_bytes + (1 << 30)    # two checkpoints kept and one being written
    if free < need:
        return {"problems": [f"{free / 2 ** 30:.1f} GiB free under {root}, the checkpoints "
                             f"need {need / 2 ** 30:.1f} GiB"]}
    writes, restores = [], []
    plain_write, plain_restore = Checkpointer._write, Checkpointer.restore

    def timed_write(self, step_, flat, dtypes, extra):
        t0 = time.perf_counter()
        path = plain_write(self, step_, flat, dtypes, extra)
        writes.append({"step": step_, "s": time.perf_counter() - t0,
                       "bytes": sum(a.nbytes for a in flat.values())})
        return path

    def timed_restore(self, step_=None):
        t0 = time.perf_counter()
        got = plain_restore(self, step_)
        restores.append({"step": got[1]["step"], "s": time.perf_counter() - t0,
                         "bytes": tree_bytes(got[0])})
        return got

    tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    runs = []
    Checkpointer._write, Checkpointer.restore = timed_write, timed_restore
    try:
        for extra in (["--fail-at", str(c["fail_at"])], []):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = TR.main(argv + ["--ckpt-dir", tmp] + extra, model=cfg)
            runs.append({"rc": rc, "wall_s": time.perf_counter() - t0,
                         "stdout": out.getvalue(), "stderr": err.getvalue()})
            gc.collect()
            torch.cuda.empty_cache()
        got, manifest = Checkpointer(tmp).restore()
    finally:
        Checkpointer._write, Checkpointer.restore = plain_write, plain_restore
        shutil.rmtree(tmp, ignore_errors=True)
    got = tree_map(lambda t: t.to(dev), got)
    equal = state_checksums(torch, got) == want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    final = json.loads(runs[1]["stdout"].strip().splitlines()[-1]) if runs[1]["rc"] == 0 else {}
    rec = {"argv": argv, "fail_at": c["fail_at"], "rcs": [r["rc"] for r in runs],
           "wall_s": [r["wall_s"] for r in runs], "state_bytes": state_bytes,
           "disk_free_gib_before": free / 2 ** 30,
           "resumed_line": f"resumed from checkpoint at step {resumed_at}" in runs[1]["stdout"],
           "batch_order": order, "final_step": manifest["step"],
           "final_loss": final.get("final_loss"), "reference_last_loss": float(loss[-1]),
           "state_bit_equal": equal, "writes": writes, "restores": restores,
           "write_gb_s": [w["bytes"] / 1e9 / w["s"] for w in writes],
           "restore_gb_s": [r["bytes"] / 1e9 / r["s"] for r in restores],
           "killed_stderr": runs[0]["stderr"][-200:]}
    problems = []
    if rec["rcs"] != [17, 0]:
        problems.append(f"exit codes {rec['rcs']}, want [17, 0]: {runs[0]['stderr'][-300:]} "
                        f"{runs[1]['stderr'][-300:]}")
    if not rec["resumed_line"]:
        problems.append(f"the rerun did not resume at step {resumed_at}")
    if not equal or rec["final_loss"] != rec["reference_last_loss"]:
        problems.append(f"the resumed run's state (bit-equal: {equal}) or last loss "
                        f"{rec['final_loss']} is not the reference order's "
                        f"({rec['reference_last_loss']})")
    rec["problems"] = problems
    return rec


def train_smoke_card_vs_cpu(torch, dev, arch, batch, seq, steps, seed=0):
    """The ``--smoke`` driver's model and step (fp32) on the card and on the
    CPU from the same weights (the CPU's init copied) and batches: the loss
    curve within 1e-4 (TF32 off), and the card's attention through the
    CUDA-core flash kernel only.  Returns the card's launches."""
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.launch import train as TR
    from repro_torch.train.train_step import init_train_state

    tc, data, step, _ = TR.build(train_args(dev, arch, batch, seq, steps, extra=["--smoke"]))
    cpu = init_train_state(torch.Generator().manual_seed(seed), tc, "cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    lc, lg = [], []
    before = counters()
    for t in range(steps):
        b = data.make_batch(t)
        cpu, mc = step(cpu, b)
        card, mg = step(card, b)
        lc.append(float(mc["loss"]))
        lg.append(float(mg["loss"]))
    launches = {k: v - before[k] for k, v in counters().items()}
    loss_err = max(abs(a - b) for a, b in zip(lc, lg))
    param_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])))
    want = {k: v * steps for k, v in launches_per_step(tc.model).items()}
    rec = {"phase": "train_smoke_card_vs_cpu", "config": tc.model.name,
           "dtype": tc.model.param_dtype, "batch": batch, "seq": seq, "steps": steps,
           "card_losses": lg, "cpu_losses": lc, "loss_max_abs_err": loss_err,
           "param_max_abs_err": param_err, "tol": 1e-4, "card_launches": launches}
    emit(rec)
    if loss_err > 1e-4 or launches != want:
        die(f"the --smoke driver on the card: losses {lg} against the CPU's {lc} "
            f"(tol 1e-4); launches {launches}, want {want}")
    return launches


def legacy_recompile_check(torch, dev, arch, steps, batch, seq, seed=0):
    """``--legacy-recompile``'s trial (``make_trial``: a fresh train step a
    trial) against the serial driver on the shared stream, on the card: the
    same score for every config of ``LEGACY_CONFIGS``, bit for bit."""
    from repro_torch.launch.hpo import PopulationTrial, make_trial

    before = counters()
    legacy = make_trial(arch, steps, batch, seq, seed, device=dev)
    serial = PopulationTrial(arch, steps, batch, seq, seed, per_trial_streams=False, device=dev)
    t0 = time.perf_counter()
    got = [legacy(dict(c)) for c in LEGACY_CONFIGS]
    legacy_s = time.perf_counter() - t0
    want = [serial(dict(c)) for c in LEGACY_CONFIGS]
    launches = {k: v - before[k] for k, v in counters().items()}
    rec = {"phase": "legacy_recompile", "arch": arch, "steps": steps, "batch": batch,
           "seq": seq, "configs": list(LEGACY_CONFIGS), "scores": got, "serial_scores": want,
           "legacy_s": legacy_s, "launches": launches}
    emit(rec)
    if got != want or not all(abs(x) < 1e8 for x in got):
        die(f"--legacy-recompile scored {got}, the serial driver {want}")
    return launches


def cnn_path(torch, dev, seed=0):
    """The paper's CNN (``train/cnn.py``) at ``train_cnn``'s defaults, dropout
    0, on the card and on the CPU from the same weights (the CPU's init
    copied): ``cnn_forward`` of the test split card against CPU within 1e-4
    (cuDNN without TF32), the test accuracy of each and the seconds an
    epoch."""
    from repro_torch.data.pipeline import SyntheticClassification
    from repro_torch.interop import tree_map
    from repro_torch.train import cnn

    init = cnn.init_cnn(torch.Generator().manual_seed(seed), CNN_ARCH)
    card_w = tree_map(lambda t: t.to(dev), init)
    x = torch.from_numpy(SyntheticClassification().make_split(512, seed + 2)["x"])
    with torch.no_grad():
        err = float((cnn.cnn_forward(card_w, x.to(dev)).cpu() - cnn.cnn_forward(init, x))
                    .abs().max())
    epochs = 3   # train_cnn's default n_iterations
    runs = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        acc = cnn.train_cnn(dict(CNN_CONFIG), device=where, init_params=init, seed=seed)
        if where is dev:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs["card" if where is dev else "cpu"] = {"accuracy": acc, "wall_s": wall,
                                                   "s_per_epoch": wall / epochs}
    rec = {"phase": "cnn_path", "arch": CNN_ARCH, "config": CNN_CONFIG, "epochs": epochs,
           "n_train": 2048, "n_test": 512, "batch": 128,
           "forward_max_abs_err": err, "tol": 1e-4, **runs}
    emit(rec)
    if not err <= 1e-4:
        die(f"cnn_forward on the card is {err} from the CPU's (tol 1e-4)")
    if not 0.0 <= runs["card"]["accuracy"] <= 1.0:
        die(f"the card's CNN scored {runs['card']['accuracy']}")


# ------------------------------------------------------------------- phase 5b
def tree_bytes(tree) -> int:
    from repro_torch.interop import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def decode_launches_per_step(cfg) -> dict:
    """Kernel launches of one decode step: the RMSNorm forward once a norm
    (``rms_widths``: the same norms as a population step's forward) and no
    other kernel of ours: decode attention, the absorbed MLA and the SSM step
    run plain, as in the JAX package."""
    return {name: sum(rms_widths(cfg).values()) if name == "rmsnorm" else 0
            for name in counters()}


def decode_parts():
    """(module, attribute, label) of the parts of a decode step whose device
    time ``profile_parts`` reads: the labels nest (the GQA mixer holds its
    reference attention, the MLA mixer its ``kv_norm``, counted under
    RMSNorm too)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import mamba as Mm
    from repro_torch.models import mlp, moe
    from repro_torch.models import transformer as T

    return ((A, "gqa_decode", "gqa_decode"),
            (ops, "attention", "gqa_decode/reference attention"),
            (A, "mla_decode", "mla_decode (absorbed, fp32)"),
            (Mm, "mamba_decode", "mamba_decode"),
            (moe, "moe_apply", "moe_ffn (dropless)"),
            (mlp, "mlp_apply", "dense_ffn"),
            (T, "apply_rmsnorm", "rmsnorm (ours)"),
            (A, "apply_rmsnorm", "rmsnorm (ours)"),
            (T, "unembed", "unembed"))


def profile_parts(torch, fn, parts) -> dict:
    """Device ms of each labelled part over one call of ``fn``, from the
    kernels the profiler ties to a ``record_function`` range around the
    part (the CPU range's; its GPU-side twin of the same name spans the
    idle gaps too).  As in ``profile_step``, only the second of two traced
    calls counts (the trace can miss the first kernels after it starts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrapped(f, label):
        def call(*args, **kwargs):
            with record_function(label):
                return f(*args, **kwargs)
        return call

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in parts]
    for (mod, attr, f), (_, _, label) in zip(saved, parts):
        setattr(mod, attr, wrapped(f, label))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("chip_smoke:mark"):
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    events = prof.events()
    mark = max(e.time_range.end for e in events if e.name == "chip_smoke:mark")
    labels = {label for *_, label in parts}
    ms = {}
    for e in events:
        if e.name in labels and e.device_type == DeviceType.CPU and e.time_range.start > mark:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            ms[e.name] = ms.get(e.name, 0.0) + total / 1e3
    return ms


def decode_vs_forward(torch, dev, cfg, params, tokens, tol=None):
    """Prompts ``tokens`` (1, B, P) decoded a token a step from a fresh fp32
    cache, against ``forward`` on the whole prompts.  With ``tol``: the
    logits at every position, each within ``tol`` (``ok`` says whether they
    are); without: the prefill form, ``forward(last_only=True)``, at the last
    position (reported only).  Either way the launches are held to one
    forward and P decode steps (``launch_problems``).  Returns (the report,
    forward's and decode's logits at the last position)."""
    import numpy as np

    from repro_torch.models import transformer as T

    B, P = tokens.shape[1:]
    before = counters()
    with torch.no_grad():
        want, _ = T.forward(params, tokens, cfg, last_only=tol is None)
    torch.cuda.synchronize()
    mid = counters()
    cache = T.init_cache(cfg, 1, B, P, dtype=torch.float32, device=dev)
    errs = []
    for pos in range(P):
        got, _ = T.decode_step(params, cache, tokens[:, :, pos:pos + 1], pos, cfg)
        if tol is not None:
            errs.append(float((got[:, :, 0] - want[:, :, pos]).abs().max()))
    torch.cuda.synchronize()
    after = counters()
    del cache
    fwd_last, dec_last = want[:, :, -1], got[:, :, 0]
    if tol is None:
        errs = [float((dec_last - fwd_last).abs().max())]
    fwd = {k: mid[k] - before[k] for k in mid}
    dec = {k: after[k] - mid[k] for k in mid}
    want_fwd = dict(launches_per_step(cfg), rmsnorm_bwd=0)
    want_dec = {k: n * P for k, n in decode_launches_per_step(cfg).items()}
    agree = int((fwd_last.argmax(-1) == dec_last.argmax(-1)).sum())
    out = {"prompt": P, "rows": B, "dtype": cfg.param_dtype,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "positions": "last" if tol is None else "every", "max_abs_err": max(errs),
           "top1_agrees": agree == B, "top1_agreeing_rows": agree,
           "logit_abs_max": float(want.abs().max()), "forward_launches": fwd,
           "decode_launches": dec, "launch_problems": []}
    if tol is not None:
        out.update(worst_position=int(np.argmax(errs)), tol=tol, ok=max(errs) <= tol)
    if fwd != want_fwd or dec != want_dec:
        out["launch_problems"].append(f"forward {fwd} (want {want_fwd}), decode {dec} "
                                      f"(want {want_dec})")
    return out, fwd_last, dec_last


def dtype_witness(torch, dev, cfg, params, tokens, last_logits, tol):
    """The bf16 model's weights in fp32 (TF32 off), decoded against
    ``forward`` at every position of ``tokens`` within ``tol`` (a gate:
    decode at full depth is the forward's function), and each of
    ``last_logits`` (name: the bf16 prefill's or a bf16 decode's logits at
    the last position) against the fp32 forward's: which of them the bf16
    gap between prefill and decode comes from."""
    from repro_torch.interop import tree_map

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    out, ref_last, _ = decode_vs_forward(torch, dev, cfg32, params32, tokens, tol=tol)
    del params32
    top1 = ref_last.argmax(-1)
    for name, logits in last_logits.items():
        out[name + "_vs_fp32_forward"] = {
            "max_abs_err": float((logits - ref_last).abs().max()),
            "top1_agreeing_rows": int((logits.argmax(-1) == top1).sum())}
    return out


def serve_path(torch, dev, arch, batch, requests, prompt_len, new_tokens, max_seq,
               temperatures, seed=0):
    """``launch/serve.py``'s loop on ``arch`` at its published widths and full
    depth, bf16, one lane: served once at each of ``temperatures`` (the draws
    seeded from ``seed``).  Gates: every request emits its tokens, the runs
    at one temperature give the same tokens, every decode step launches the
    RMSNorm forward once a norm and no other kernel of ours.  Reports steps
    and tokens a second, the median host seconds a step of the second run
    beside the least time of a step (every parameter byte read once), the
    idle share and device ms by group and by part of profiled decode steps,
    one decode step graph-replayed, peak memory and the cache's bytes; on
    MoE models the bytes of only the experts the tokens routed to and the
    bound they give.  On ``PREFILL_CHECKED`` archs, ``decode_vs_forward`` in
    bf16 (reported), and on ``DTYPE_WITNESS`` archs ``dtype_witness`` (its
    fp32 decode gated).  Returns the launches of the runs and the checks."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.interop import add_lane_axis
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.train import population as P
    from repro_torch.train.serve_step import make_serve_step

    P.clear_population_cache()
    release_cublas_workspaces(torch)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = add_lane_axis(T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = tree_bytes(params)
    bound_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    flags = dict(batch=batch, requests=requests, prompt_len=prompt_len, new_tokens=new_tokens,
                 max_seq=max_seq, seed=seed, device=dev)
    per_step = decode_launches_per_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    routed, plain_route = [], M.route

    def recording(router, xt, k):
        got = plain_route(router, xt, k)
        routed.append(got[2])
        return got

    runs = []
    for i, temperature in enumerate(temperatures):
        before = counters()
        if i == 0:
            M.route = recording   # the first run's routing, for the routed experts' bytes
        try:
            outputs, steps, wall, seconds = serve_requests(cfg, params, temperature=temperature,
                                                           **flags)
        finally:
            M.route = plain_route
        runs.append(dict(temperature=temperature, outputs=outputs, steps=steps, wall_s=wall,
                         seconds=seconds,
                         launches={k: v - before[k] for k, v in counters().items()}))
    peak = torch.cuda.max_memory_allocated()
    cache = T.init_cache(cfg, 1, batch, max_seq, dtype=torch.float32, device=dev)
    cache_bytes = tree_bytes(cache)
    step = make_serve_step(cfg)
    tok = (torch.arange(batch, device=dev) + 1).view(1, batch, 1)

    def decode_steps():
        for j in range(PROFILED_DECODE_STEPS):
            step(params, cache, tok, max_seq // 2 + j)

    prof = profile_step(torch, decode_steps)
    parts = profile_parts(torch, lambda: step(params, cache, tok, max_seq // 2),
                          decode_parts())
    # one decode step captured in a CUDA graph and replayed: its device time
    # without the host's dispatch (the step ROADMAP.md's lever K would give)
    graph_ms = graph_device_ms(torch, lambda: step(params, cache, tok, max_seq // 2), [()],
                               min_launches=2, replays=3)
    del cache
    timed = runs[1]
    steady = np.asarray(timed["seconds"])
    gen_tokens = sum(len(o) for o in timed["outputs"].values())
    out = {
        "phase": "serve_path", "arch": arch, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "vocab_size": cfg.vocab_size, "param_dtype": cfg.param_dtype, "cache_dtype": "float32",
        **{k: v for k, v in flags.items() if k != "device"},
        "init_s": init_s, "param_bytes": param_bytes, "cache_bytes": cache_bytes,
        "peak_memory_gib": peak / 2 ** 30, "card": card_memory(torch),
        "runs": [{"temperature": r["temperature"], "decode_steps": r["steps"],
                  "wall_s": r["wall_s"], "tokens_per_s_batched": r["steps"] * batch / r["wall_s"],
                  "generated_tokens": sum(len(o) for o in r["outputs"].values()),
                  "launches": r["launches"]} for r in runs],
        "median_s_per_step": float(np.median(steady)),
        "p10_p90_s_per_step": [float(np.percentile(steady, 10)),
                               float(np.percentile(steady, 90))],
        "first_step_s": runs[0]["seconds"][0],
        "bound_ms_per_step": bound_ms, "bound_by": "bytes",
        "share_of_bound": bound_ms / 1e3 / float(np.median(steady)),
        "generated_tokens_per_s": gen_tokens / timed["wall_s"],
        "decode_launches_per_step": per_step,
        "profile": dict(prof, steps=PROFILED_DECODE_STEPS),
        "graph_replayed_step_ms": graph_ms, "graph_share_of_bound": bound_ms / graph_ms,
        "parts_device_ms": parts,
        "outputs_head": {str(rid): o[:8] for rid, o in sorted(runs[0]["outputs"].items())[:4]},
    }
    device_ms = prof.get("device_ms")
    if device_ms:   # of the profiled steps' device time, and of their wall time
        step_device, step_wall = (device_ms / PROFILED_DECODE_STEPS,
                                  prof["wall_ms"] / PROFILED_DECODE_STEPS)
        out["parts_share_of_step_device"] = {k: v / step_device for k, v in parts.items()}
        out["parts_share_of_step_wall"] = {k: v / step_wall for k, v in parts.items()}
    if cfg.has_moe and routed:
        wi, wo = params["blocks"]["l0"]["ffn"]["wi"], params["blocks"]["l0"]["ffn"]["wo"]
        per_expert = (wi[0, 0, 0].numel() + wo[0, 0, 0].numel()) * wi.element_size()
        layers = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
        moe_layers = sum(f == "moe" for _, f in layers)
        unique = [int(torch.unique(t).numel()) for t in routed]
        all_experts = moe_layers * cfg.n_experts * per_expert
        routed_step = sum(unique) / len(unique) * moe_layers * per_expert
        # a decode step needs only the routed experts' bytes: the least time
        # of this traffic's step, beside the all-weights bound above
        routed_bound_ms = (param_bytes - all_experts + routed_step) / HBM_BYTES_PER_S * 1e3
        out["moe"] = {"moe_layers": moe_layers, "expert_bytes": per_expert,
                      "all_expert_bytes": all_experts,
                      "routed_experts_per_layer_mean": sum(unique) / len(unique),
                      "routed_experts_per_layer_max": max(unique),
                      "routed_expert_bytes_per_step": routed_step,
                      "bound_ms_routed_only": routed_bound_ms,
                      "share_of_routed_bound": routed_bound_ms / 1e3 / float(np.median(steady)),
                      "graph_share_of_routed_bound": routed_bound_ms / graph_ms}
    launches = {k: sum(r["launches"][k] for r in runs) for k in per_step}
    checks = []
    if arch in PREFILL_CHECKED:
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(
            1, cfg.vocab_size, size=(1, batch, prompt_len))).to(dev)
        res, fwd_last, dec_last = decode_vs_forward(torch, dev, cfg, params, prompt)
        out["serve_vs_forward_bf16"] = res
        checks.append(res)
        if arch in DTYPE_WITNESS:
            res = dtype_witness(torch, dev, cfg, params, prompt,
                                {"bf16_forward": fwd_last, "bf16_decode": dec_last},
                                SERVE_VS_FORWARD["tol"])
            out["fp32_witness"] = res
            checks.append(res)
        for res in checks:
            for k in launches:
                launches[k] += res["forward_launches"][k] + res["decode_launches"][k]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    problems = []
    for r in runs:
        if sorted(r["outputs"]) != list(range(requests)) or any(
                len(o) != new_tokens for o in r["outputs"].values()):
            problems.append(f"a request did not finish at temperature {r['temperature']}")
        if any(not 0 <= t < cfg.vocab_size for o in r["outputs"].values() for t in o):
            problems.append("a token outside the vocabulary")
        want = {k: n * r["steps"] for k, n in per_step.items()}
        if r["launches"] != want:
            problems.append(f"launches {r['launches']}, want {want}")
    for t in set(temperatures):
        if any(r["outputs"] != runs[temperatures.index(t)]["outputs"]
               for r in runs if r["temperature"] == t):
            problems.append(f"the runs at temperature {t} with one seed gave other tokens")
    for res in checks:
        problems += res["launch_problems"]
        if not res.get("ok", True):
            problems.append(f"fp32 decode and forward disagree: {res['max_abs_err']} > "
                            f"{res['tol']}")
    if prof["launches"] != {k: n * PROFILED_DECODE_STEPS for k, n in per_step.items()}:
        problems.append(f"profiled decode steps launched {prof['launches']}")
    if problems:
        die(f"serve path {arch}: " + "; ".join(problems))
    return launches


def serve_vs_forward(torch, dev, arch, n_layers, prompt, tol, seed=0):
    """``arch`` at its published widths in fp32 (TF32 off), depth cut to
    ``n_layers``: ``decode_vs_forward`` gated at ``tol``; the forward goes
    through the CUDA-core flash kernel, decode through none of ours but
    RMSNorm."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.interop import add_lane_axis
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, param_dtype="float32",
                              compute_dtype="float32")
    params = add_lane_axis(T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, dev))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=(1, 1, prompt))).to(dev)
    res, _, _ = decode_vs_forward(torch, dev, cfg, params, tokens, tol=tol)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_vs_forward", "arch": arch, "n_layers": n_layers,
          "published_n_layers": get_config(arch).n_layers, "d_model": cfg.d_model,
          "vocab_size": cfg.vocab_size, **res})
    if not res["ok"]:
        die(f"decode and forward disagree on {arch} in fp32: {res['max_abs_err']} > {tol}")
    if res["launch_problems"]:
        die("serve_vs_forward launches: " + "; ".join(res["launch_problems"]))
    return {k: n + res["decode_launches"][k] for k, n in res["forward_launches"].items()}


def card_vs_cpu_decode(torch, dev, arch, steps=DECODE_STEPS, batch=DECODE_BATCH):
    """``arch``'s fp32 smoke config, one lane: ``steps`` decode steps on the
    card and on the CPU from the same parameters and tokens; the logits and
    every cache leaf within 1e-4, and the card's launches."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import add_lane_axis, tree_leaves, tree_map
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch)
    cpu = add_lane_axis(T.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    cache_cpu = T.init_cache(cfg, 1, batch, steps, dtype=torch.float32, device="cpu")
    cache_card = T.init_cache(cfg, 1, batch, steps, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    before = counters()
    logit_err = 0.0
    for pos in range(steps):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, batch, 1)))
        want, _ = T.decode_step(cpu, cache_cpu, tok, pos, cfg)
        got, _ = T.decode_step(card, cache_card, tok.to(dev), pos, cfg)
        logit_err = max(logit_err, float((got.cpu() - want).abs().max()))
    launches = {k: v - before[k] for k, v in counters().items()}
    cache_err, worst = 0.0, None
    ok = logit_err <= 1e-4
    for name, a, b in zip(leaf_names(cache_cpu), tree_leaves(cache_card), tree_leaves(cache_cpu)):
        a = a.cpu()
        err = float((a - b).abs().max())
        if err > cache_err:
            cache_err, worst = err, name
        ok = ok and bool(torch.allclose(a, b, atol=1e-4, rtol=1e-4))
    want_launches = {k: n * steps for k, n in decode_launches_per_step(cfg).items()}
    emit({"phase": "card_vs_cpu_decode", "config": cfg.name, "dtype": cfg.param_dtype,
          "batch": batch, "steps": steps, "logits_max_abs_err": logit_err,
          "cache_max_abs_err": cache_err, "cache_worst_leaf": worst, "tol": 1e-4,
          "card_launches": launches})
    if not ok:
        die(f"decode on the card and the CPU disagree on {arch}: logits {logit_err}, "
            f"cache {cache_err} at {worst}")
    if launches != want_launches:
        die(f"decode on {arch} launched {launches}, want {want_launches}")
    return launches


# ------------------------------------------------------------------- phase 6
def event_ms(torch, fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_device_ms(torch, fn, sets, min_launches=20, replays=3) -> float:
    """Device ms a call of ``fn(*args)``, host dispatch left out: calls over
    the argument ``sets`` in turn (whose bytes together pass the L2, so a
    call finds its inputs in device memory, as the main path does), at least
    ``min_launches`` of them captured in one CUDA graph, replayed under CUDA
    events."""
    per_set = -(-min_launches // len(sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture stream, as capture wants
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(per_set):
            for args in sets:
                fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_set * len(sets))
    del graph
    return ms


def rmsnorm_bwd_autograd(x, gamma, dy, eps):
    """The RMSNorm backward before the kernel: the plain forward recomputed
    and autograd through it, (dx, dgamma)."""
    import torch

    from repro_torch.kernels import rmsnorm as rn

    with torch.enable_grad():
        xx, gg = x.detach().requires_grad_(True), gamma.detach().requires_grad_(True)
        return torch.autograd.grad(rn.rmsnorm_plain(xx, gg, eps), (xx, gg), dy)


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ssm_fwd_bwd(torch, ss, *inputs):
    """The autograd function at work in training: the kernel forward, then
    the plain chunked backward, with gradients to every input."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    y, h = ss.ssm_scan(*leaves)
    return torch.autograd.grad((y, h), leaves, (torch.ones_like(y), torch.zeros_like(h)))


# csrc/synth_tokens.cu's rule step, its shortest dependent sequence counted
# from the source (not the SASS): the word that carries the previous result
# through mix_word (4: its multiply, the xor, the rotate, the multiply-add;
# the first word's mix_word is formed a step ahead, off the chain), the
# finalizer (8: three shift-xor pairs, two multiplies) and the remainder by
# the vocabulary with its reciprocal hoisted (4: a high multiply, a
# multiply-subtract, a subtract and a min); 16 dependent integer operations
# of 4 cycles, the ALU and FMA pipes' dependent-issue latency since Volta.
# A step after a fixed token (a gap) adds the other word's mix_word (4).
RULE_STEP_CYCLES = 16 * 4


def sm_clock_max_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def time_kernels(torch, dev, errs, by_path, fp32_launches, chunk_launches):
    """One row per kernel for the ``kernels`` line.  ``by_path`` holds each
    main path's launch counts; a row's ``launches`` is their sum (the flash
    row's: the tensor-core kernel's, with both kernels' counts beside it).
    ``fp32_launches``: the CUDA-core flash kernel's launches in the
    card-against-CPU phase; ``chunk_launches``: the synthesis kernel's
    launches in one replayed chunk's graph, by chunked path."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    gen = torch.Generator(device=dev).manual_seed(1)
    dt, dts = torch.bfloat16, "bfloat16"
    rows = []

    def counts(name):
        return {"launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {path: p[name] for path, p in by_path.items()}}

    def rms_inputs(shape, n_sets):
        K, R, d = shape
        return [(torch.randn(shape, generator=gen, device=dev).to(dt),
                 (0.1 * torch.randn((K, d), generator=gen, device=dev)).to(dt),
                 torch.randn(shape, generator=gen, device=dev).to(dt)) for _ in range(n_sets)]

    def n_sets(read_bytes):   # input sets whose reads together pass twice the L2
        return max(2, -(-int(2 * L2_BYTES) // int(read_bytes)))

    def rms_at(shape):
        """The forward at ``shape``: eager ``ms`` (20 calls, host dispatch
        included) and ``device_ms`` (graph-replayed over rotating inputs)."""
        K, R, d = shape
        x_bytes = K * R * d * 2
        sets = rms_inputs(shape, n_sets(x_bytes))
        x, g, _ = sets[0]
        w = (1.0 + g.float()).to(dt)
        nb = 2 * x_bytes + g.numel() * g.element_size()
        b_ms, b_by = bound_ms(nb, 4 * x.numel(), "float32")
        out = {
            "ms": event_ms(torch, lambda: rn.rmsnorm_cuda(x, g, EPS)),
            "device_ms": graph_device_ms(torch, lambda a, b, _: rn.rmsnorm_cuda(a, b, EPS), sets),
            "rotating_input_sets": len(sets),
            "plain_ms": event_ms(torch, lambda: rn.rmsnorm_plain(x, g, EPS)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": event_ms(torch, lambda: [F.rms_norm(x[k], (d,), weight=w[k], eps=EPS)
                                                   for k in range(K)]),
            "shape": {"x": list(shape), "gamma": [K, d], "dtype": dts},
        }
        out["device_share_of_bound"] = b_ms / out["device_ms"]
        return out

    def rms_bwd_at(shape):
        """The backward at ``shape``: the kernel and the autograd backward that
        it replaced (``plain``), each eager (``ms``, ``plain_ms``: host
        dispatch included) and graph-replayed (``device_ms``,
        ``plain_device_ms``); the closed form; and autograd of ``F.rms_norm``,
        a lane at a time, backward only (``library_ms``)."""
        K, R, d = shape
        x_bytes = K * R * d * 2
        sets = rms_inputs(shape, n_sets(2 * x_bytes))
        x, g, dy = sets[0]
        nb = 3 * x_bytes + 2 * g.numel() * g.element_size()   # x, dy, dx; gamma, dgamma
        b_ms, b_by = bound_ms(nb, 10 * x.numel(), "float32")
        xs = [x[k].detach().clone().requires_grad_(True) for k in range(K)]
        ws = [(1.0 + g[k].float()).to(dt).requires_grad_(True) for k in range(K)]
        ys = [F.rms_norm(xs[k], (d,), weight=ws[k], eps=EPS) for k in range(K)]
        out = {
            "ms": event_ms(torch, lambda: rn.rmsnorm_bwd_cuda(x, g, dy, EPS)),
            "device_ms": graph_device_ms(torch, lambda *a: rn.rmsnorm_bwd_cuda(*a, EPS), sets),
            "rotating_input_sets": len(sets),
            "plain_ms": event_ms(torch, lambda: rmsnorm_bwd_autograd(x, g, dy, EPS), n=5,
                                 warmup=1),
            "plain_device_ms": graph_device_ms(
                torch, lambda *a: rmsnorm_bwd_autograd(*a, EPS), sets, min_launches=10,
                replays=2),
            "closed_form_plain_ms": event_ms(torch, lambda: rn.rmsnorm_bwd_plain(x, g, dy, EPS),
                                             n=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": event_ms(torch, lambda: torch.autograd.grad(
                ys, xs + ws, list(dy.unbind(0)), retain_graph=True), n=5, warmup=1),
            "shape": {"x": list(shape), "gamma": [K, d], "dy": list(shape), "dtype": dts},
        }
        out["device_share_of_bound"] = b_ms / out["device_ms"]
        del xs, ws, ys, sets
        torch.cuda.empty_cache()
        return out

    def rms_decode_at(shape):
        """The forward at a decode shape (a few rows): eager ``ms`` and
        ``device_ms`` of graph-replayed launches on one input set, which
        stays in the L2 as a decode step's does between its norms."""
        K, R, d = shape
        x, g, _ = rms_inputs(shape, 1)[0]
        w = (1.0 + g.float()).to(dt)
        b_ms, b_by = bound_ms(2 * x.numel() * 2 + g.numel() * 2, 4 * x.numel(), "float32")
        return {"ms": event_ms(torch, lambda: rn.rmsnorm_cuda(x, g, EPS)),
                "device_ms": graph_device_ms(torch, lambda: rn.rmsnorm_cuda(x, g, EPS), [()]),
                "plain_ms": event_ms(torch, lambda: rn.rmsnorm_plain(x, g, EPS)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": event_ms(torch, lambda: F.rms_norm(x[0], (d,), weight=w[0],
                                                                 eps=EPS)),
                "shape": {"x": list(shape), "gamma": [K, d], "dtype": dts}}

    decode_at = rms_decode_at(RMS_DECODE_SHAPES["decode-starcoder2"])
    fwd_at = {shape: rms_at(shape) for shape in
              (RMS_SHAPE, RMS_MAMBA_SHAPE, RMS_MOE_SHAPE, RMS_KV_NORM_SHAPE)}
    bwd_at = {shape: rms_bwd_at(shape) for shape in fwd_at}
    # each main path's RMSNorm backward a step, at the shapes its cell gives
    # (lanes, batch * seq, each width of rms_widths): the kernel against the
    # autograd backward that it replaced, eager and graph-replayed
    per_step = {}
    for path in PATHS:
        calls = {(path["population"], path["batch"] * path["seq"], d): n
                 for d, n in rms_widths(path_config(**path)).items()}
        for shape in calls:
            if shape not in bwd_at:
                bwd_at[shape] = rms_bwd_at(shape)
        per_step[path["arch"]] = {
            "calls": {str(list(shape)): n for shape, n in calls.items()},
            **{key: sum(n * bwd_at[shape][key] for shape, n in calls.items())
               for key in ("plain_ms", "plain_device_ms", "ms", "device_ms")}}
    rows.append({
        "name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:19", **counts("rmsnorm"),
        "max_abs_err": errs["rmsnorm"], **fwd_at[RMS_SHAPE],
        # falcon-mamba-7b's call at d = 4096
        "mamba_shape": dict(fwd_at[RMS_MAMBA_SHAPE], max_abs_err=errs["rmsnorm@mamba"]),
        # the MoE and MLA paths' call at d = 2048 (qwen3-moe-30b-a3b, deepseek-v2-lite-16b)
        "moe_shape": dict(fwd_at[RMS_MOE_SHAPE], max_abs_err=errs["rmsnorm@moe"]),
        # MLA's kv_norm over the 512-wide latent (deepseek-v2-lite-16b)
        "kv_norm_shape": dict(fwd_at[RMS_KV_NORM_SHAPE], max_abs_err=errs["rmsnorm@kv_norm"]),
        # a starcoder2-3b decode step's call: 8 slots of one lane at d = 3072
        "decode_shape": dict(decode_at, max_abs_err=errs["rmsnorm@decode"]),
    })
    rows.append({
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        # not a TPU kernel: the JAX package's custom VJP of the Pallas norm
        # takes jax.vjp of the reference norm
        "replaces": "src/repro/kernels/ops.py:60", "tpu_kernel": False,
        **counts("rmsnorm_bwd"), "max_abs_err": errs["rmsnorm_bwd"], **bwd_at[RMS_SHAPE],
        "mamba_shape": dict(bwd_at[RMS_MAMBA_SHAPE], max_abs_err=errs["rmsnorm_bwd@mamba"]),
        "moe_shape": dict(bwd_at[RMS_MOE_SHAPE], max_abs_err=errs["rmsnorm_bwd@moe"]),
        "kv_norm_shape": dict(bwd_at[RMS_KV_NORM_SHAPE],
                              max_abs_err=errs["rmsnorm_bwd@kv_norm"]),
        "per_step": per_step,
    })
    del fwd_at, bwd_at

    kw = dict(causal=True, window=None, softcap=None, scale=FLASH_Q[-1] ** -0.5)

    def flash_at(qs, kvs, dv=None, causal=True, dtype=dt):
        """The dtype's flash kernel (bf16: tensor cores), its plain version
        and SDPA at q ``qs``, k ``kvs``, v as k or ``dv`` wide (scale 1/sqrt
        of the q/k width), and the tensors, for the fp32 kernel's row."""
        B, S, H, D = qs
        Dv = dv or D
        q = torch.randn(qs, generator=gen, device=dev).to(dtype)
        k = torch.randn(kvs, generator=gen, device=dev).to(dtype)
        v = torch.randn(kvs[:3] + (Dv,), generator=gen, device=dev).to(dtype)
        pairs = S * (S + 1) // 2 if causal else S * S   # unmasked (q, k) pairs per head
        n_ops = 2 * B * H * pairs * (D + Dv)
        nb = (q.numel() + k.numel() + v.numel() + v.numel() * H // kvs[2]) \
            * q.element_size() + B * H * S * 4         # q, k, v, out (H heads of Dv), lse
        dname = str(dtype).split(".")[-1]
        b_ms, b_by = bound_ms(nb, n_ops, dname)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kw_ = dict(kw, causal=causal, scale=D ** -0.5)
        return {
            "ms": event_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, **kw_)),
            "plain_ms": event_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, **kw_), n=5,
                                 warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": event_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            "shape": {"q": list(qs), "k": list(kvs), "v": list(v.shape), "causal": causal,
                      "dtype": dname},
        }, (q, k, v, nb, n_ops)

    main_shape, (q, k, v, nb, n_ops) = flash_at(FLASH_Q, FLASH_KV)
    by_kernel = {kern: sum(p[f"flash_attention_{kern}"] for p in by_path.values())
                 for kern in ("sm90", "fp32")}
    q32, k32, v32 = q.float(), k.float(), v.float()
    b32_ms, b32_by = bound_ms(2 * nb, n_ops, "float32")
    fp32_ms = event_ms(torch, lambda: fa.flash_fwd_cuda(q32, k32, v32, **kw), n=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q32, k32, v32))
    g = FLASH_Q[2] // FLASH_KV[2]
    ke, ve = (t.repeat_interleave(g, dim=1) for t in (kt, vt))   # kv at every q head
    rows.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:39",
        **counts("flash_attention_sm90"), "launches_by_kernel": by_kernel,
        "max_abs_err": errs["flash_attention"], **main_shape,
        # the fp32 path's CUDA-core kernel (card-against-CPU phase), same shape
        # in fp32; SDPA in fp32 with TF32 off as the main() sets it, as a user
        # calls it (enable_gqa) and with kv expanded to every q head (so
        # every backend may take it)
        "fp32_kernel": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "launches_card_vs_cpu": fp32_launches,
            "max_abs_err": errs["flash_attention@fp32_main"],
            "ms": fp32_ms,
            "plain_ms": event_ms(torch, lambda: fa.flash_fwd_plain(q32, k32, v32, **kw), n=3,
                                 warmup=1),
            "bound_ms": b32_ms, "bound_by": b32_by, "share_of_bound": b32_ms / fp32_ms,
            "library_ms": event_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), n=5, warmup=1),
            "library_expanded_kv_ms": event_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ke, ve, is_causal=True), n=5, warmup=1),
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32},
            "shape": {"q": list(FLASH_Q), "k": list(FLASH_KV), "v": list(FLASH_KV),
                      "causal": True, "dtype": "float32"}},
    })
    del qt, kt, vt, ke, ve
    del q32, k32, v32, q, k, v
    # the MoE path's call: 32 q heads over 4 kv heads
    rows[-1]["moe_shape"] = dict(flash_at(FLASH_MOE_Q, FLASH_MOE_KV)[0],
                                 max_abs_err=errs["flash_attention@moe"])
    # the MLA path's call: q and k 192 wide, v 128 (deepseek-v2-lite-16b)
    rows[-1]["mla_shape"] = dict(flash_at(FLASH_MLA_Q, FLASH_MLA_Q, dv=FLASH_MLA_DV)[0],
                                 max_abs_err=errs["flash_attention@mla"])
    # hubert-xlarge's encoder: non-causal, head dim 80 (padded to 128)
    rows[-1]["hubert_shape"] = dict(flash_at(FLASH_HUBERT_Q, FLASH_HUBERT_Q, causal=False)[0],
                                    max_abs_err=errs["flash_attention@hubert"])
    # the CUDA-core kernel at q/k 192, v 128 over a ragged 300 rows (its check case)
    ragged, (q, k, v, _, _) = flash_at((2, 300, 4, 192), (2, 300, 4, 192), dv=128,
                                       dtype=torch.float32)
    ragged["device_ms"] = graph_device_ms(torch, lambda: fa.flash_fwd_cuda(
        q, k, v, **dict(kw, scale=192 ** -0.5)), [()])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ragged["library_device_ms"] = graph_device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), [()])
    rows[-1]["fp32_kernel"]["mla_ragged_shape"] = dict(
        ragged, share_of_bound=ragged["bound_ms"] / ragged["ms"],
        device_share_of_bound=ragged["bound_ms"] / ragged["device_ms"],
        max_abs_err=errs["flash_attention@mla_ragged"])
    del q, k, v, qt, kt, vt

    x, dtt, A, Bc, Cc, Dk, _ = ssm_inputs(torch, dev, gen, SSM_X, SSM_N, SSM_K, dt)
    R, L, Dm = SSM_X
    updates = R * L * Dm * SSM_N                      # state updates, one exponential each
    hs_bytes = R * -(-L // SSM_CHUNK) * Dm * SSM_N * 4
    nb = (3 * x.numel() * x.element_size() + 2 * Bc.numel() * Bc.element_size()
          + A.numel() * 4 + Dk.numel() * 4 + R * Dm * SSM_N * 4 + hs_bytes)
    # x, dt, y; B, C; A, D; h_last; the chunk states the main path's call writes
    n_ops = 6 * updates   # exp argument, exp, two FMAs, the skip per (row, t, channel, state)
    bounds = {"bytes": nb / HBM_BYTES_PER_S * 1e3, "fp32": n_ops / PEAK_OPS["float32"] * 1e3,
              "sfu": updates / (PEAK_OPS["float32"] / SFU_PER_FP32_FLOPS) * 1e3}
    binding = max(bounds, key=bounds.get)
    main_call = dict(chunk=SSM_CHUNK, chunk_states=True)   # as SSMScan.forward calls it
    rows.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:30",
        **counts("ssm_scan"), "max_abs_err": errs["ssm_scan"],
        "ms": event_ms(torch, lambda: ss.ssm_scan_cuda(x, dtt, A, Bc, Cc, Dk, **main_call)),
        "ms_without_chunk_states": event_ms(
            torch, lambda: ss.ssm_scan_cuda(x, dtt, A, Bc, Cc, Dk, chunk=SSM_CHUNK)),
        "plain_ms": event_ms(torch, lambda: ss.ssm_scan_plain(x, dtt, A, Bc, Cc, Dk, **main_call),
                             n=3, warmup=1),
        "fwd_bwd_ms": event_ms(torch, lambda: ssm_fwd_bwd(torch, ss, x, dtt, A, Bc, Cc, Dk),
                               n=3, warmup=1),
        # the SFU's exponentials are operations: bound_by says "operations" for
        # them and for the FP32 count, and ops_bound_by which of the two
        "bound_ms": bounds[binding], "bound_by": "bytes" if binding == "bytes" else "operations",
        "ops_bound_by": "sfu" if bounds["sfu"] >= bounds["fp32"] else "fp32",
        "bytes_ms": bounds["bytes"], "ops_ms": bounds["fp32"], "sfu_ms": bounds["sfu"],
        "library_ms": None,   # no single PyTorch call computes a selective scan
        "occupancy": ss.kernel_occupancy(SSM_N, dt),
        "shape": {"x": list(SSM_X), "A": [SSM_K, Dm, SSM_N], "D": [SSM_K, Dm],
                  "dtype": dts, "A_D_dtype": "float32", "chunk_states_chunk": SSM_CHUNK},
    })
    del x, dtt, A, Bc, Cc, Dk

    from repro_torch.data.pipeline import SyntheticLM, split_streams
    from repro_torch.kernels import synth as sk

    K, rows_, seq = MAIN["population"], MAIN["batch"], MAIN["seq"]
    data = SyntheticLM(49152, seq, rows_, seed=0)
    lo, hi = (torch.tensor(w.astype("int64"), device=dev)
              for w in split_streams(list(range(K))))
    st = torch.zeros(K, dtype=torch.int64, device=dev)
    nb = K * rows_ * (seq + 1) * 4 + 3 * K * 8      # the tokens written, cursors and words read
    rule = sk.rule_positions(data, st.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy())
    chains = sk.chain_rule_steps(rule)                # the kernel's split, at its tile
    longest, busiest = int(chains.max()), int(rule.sum(-1).max())
    n_chains = (chains > 0).sum(-1)
    clock_mhz = sm_clock_max_mhz()
    synth_ms = event_ms(torch, lambda: sk.synth_tokens_cuda(data, st, lo, hi))
    # as a chunk graph runs it: host dispatch left out
    synth_device_ms = graph_device_ms(torch, lambda: sk.synth_tokens_cuda(data, st, lo, hi), [()])
    bound = longest * RULE_STEP_CYCLES / (clock_mhz * 1e3)
    rows.append({
        "name": "synth_tokens", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/synth_tokens.cu",
        # not a TPU kernel: the device branch (lax.scan over positions) of
        # the JAX package's synthesis, inside its compiled chunk program
        "replaces": "src/repro/data/pipeline.py:147", "tpu_kernel": False,
        **counts("synth_tokens"), "launches_per_chunk": chunk_launches,
        "max_abs_err": errs["synth_tokens"],
        "ms": synth_ms, "device_ms": synth_device_ms,
        "plain_ms": event_ms(torch, lambda: sk.synth_tokens_plain(data, st, lo, hi),
                             n=3, warmup=1),
        # what binds it: a row's independent rule chains run one a thread, each
        # step a chain of dependent integer operations, so the bound is the
        # latency of the longest chain at the top clock; the serial figure is
        # the busiest row's rule steps run one after another (one thread a row)
        "bound_ms": bound, "bound_by": "operations",
        "bound_note": "latency of the longest independent rule chain",
        "share_of_bound": bound / synth_ms, "device_share_of_bound": bound / synth_device_ms,
        "serial_bound_ms": busiest * RULE_STEP_CYCLES / (clock_mhz * 1e3),
        "longest_chain_rule_steps": longest, "rule_steps_busiest_row": busiest,
        "chains_per_row": [int(n_chains.min()), int(n_chains.max())],
        "cycles_per_rule_step": RULE_STEP_CYCLES, "cycles_counted_from": "source",
        "sm_clock_max_mhz": clock_mhz, "byte_bound_ms": nb / HBM_BYTES_PER_S * 1e3,
        "library_ms": None,   # no PyTorch call computes this generator
        "shape": {"tokens": [K, rows_, seq + 1], "dtype": "int32"},
    })
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        die(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import build
    from repro_torch.train import population as P

    # every captured chunk graph keeps its nodes: the launch gates of
    # replayed chunks count them in the graph
    P.KEEP_GRAPH_NODES = True
    seconds = {}   # wall seconds by phase, for the total line
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    lap("build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib.name,
          "sources": [s.name for s in build.sources()], "flags": build.NVCC_FLAGS,
          **{key: ptxas_summary(build.ptxas_report.get(src, ""), src)
             for key, src in (("flash_sm90_ptxas", "flash_attention_sm90.cu"),
                              ("flash_fp32_ptxas", "flash_attention.cu"),
                              ("ssm_scan_ptxas", "ssm_scan.cu"),
                              ("rmsnorm_ptxas", "rmsnorm.cu"),
                              ("synth_tokens_ptxas", "synth_tokens.cu"))}})

    errs = check_kernels(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("kernels")
    by_path, chunk_launches, main_outs = {}, {}, {}
    for path in PATHS:
        release_cublas_workspaces(torch)
        by_path[path["arch"]], out = main_path(torch, dev, **path)
        main_outs[path["arch"]] = out
        gc.collect()
        torch.cuda.empty_cache()
        lap(path["arch"] + ":main_path")
        kw = {k: v for k, v in path.items() if k != "steps"}
        if path is MOE or path is DEEPSEEK:
            (moe_path if path is MOE else mla_path)(torch, dev, **kw)
            gc.collect()
            torch.cuda.empty_cache()
            lap(path["arch"] + (":moe" if path is MOE else ":mla"))
        launches, out = chunked_path(torch, dev, per_step_steady=out["steady_s_per_step"], **kw)
        by_path[path["arch"] + "+chunked"] = launches
        chunk_launches[path["arch"]] = out["kernel_launches_per_step_seen"][
            "synth_tokens"] * out["chunk"]
        gc.collect()
        torch.cuda.empty_cache()
        lap(path["arch"] + ":chunked_path")
        if path is MOE or path is DEEPSEEK:
            # the streaming, crash and ring engines are arch-agnostic and run
            # on the two paths above
            continue
        if path is MAMBA:
            # the streaming, crash and ring engines do not depend on the
            # model's depth: falcon-mamba's run at MAMBA_ENGINE_LAYERS
            kw = dict(kw, n_layers=MAMBA_ENGINE_LAYERS)
        by_path[path["arch"] + "+streaming"], _ = streaming_path(torch, dev, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        lap(path["arch"] + ":streaming_path")
        by_path[path["arch"] + "+crash"], out = crash_path(torch, dev, **kw)
        lap(path["arch"] + ":crash_path")
        by_path[path["arch"] + "+ring"], _ = ring_path(
            torch, dev, seen=out["replayed_chunk_launches_seen"], **kw)
        gc.collect()
        torch.cuda.empty_cache()
        lap(path["arch"] + ":ring_path")
    release_cublas_workspaces(torch)
    by_path[MAIN["arch"] + "+sharded"], _ = sharded_path(
        torch, dev, main_s_per_step=main_outs[MAIN["arch"]]["flight_s_per_step"], **MAIN)
    lap("sharded_path")
    by_path[SHARDED_GLOO["arch"] + "+sharded_gloo"], _ = sharded_gloo_path(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("sharded_gloo_path")
    fp32_launches = sum(card_vs_cpu(torch, dev, arch)["flash_attention_fp32"]
                        for arch in CARD_VS_CPU)
    lap("card_vs_cpu")
    by_path[TRAIN["arch"] + "+train"] = train_path(torch, dev, **TRAIN)
    lap("train_path")
    by_path[TRAIN["arch"] + "+train_checks"] = train_checks(torch, dev, **TRAIN_CHECKS)
    by_path[TRAIN["arch"] + "+train_smoke"] = train_smoke_card_vs_cpu(torch, dev, **TRAIN_SMOKE)
    by_path[TRAIN["arch"] + "+legacy"] = legacy_recompile_check(torch, dev, **LEGACY)
    lap("train_checks")
    cnn_path(torch, dev)
    lap("cnn_path")
    for path in SERVE:
        by_path[path["arch"] + "+serve"] = serve_path(torch, dev, **path)
        lap(path["arch"] + ":serve_path")
    by_path[SERVE_VS_FORWARD["arch"] + "+serve_vs_forward"] = serve_vs_forward(
        torch, dev, **SERVE_VS_FORWARD)
    lap("serve_vs_forward")
    for arch in DECODE_CARD_VS_CPU:
        card_vs_cpu_decode(torch, dev, arch)
    lap("card_vs_cpu_decode")
    emit({"kernels": time_kernels(torch, dev, errs, by_path, fp32_launches, chunk_launches)})
    lap("timing")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
