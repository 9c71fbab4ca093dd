"""Smoke run of the PyTorch/CUDA port (tpu_sandbox_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc
and nvidia-smi. It exits non-zero, printing no result, when there is no
card or when the port is not beside it. Phases, one JSON line each:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of every kernel in tpu_sandbox_torch/csrc/.
2. kernel: each kernel launch kind of the training paths, at the main
   path's shapes (3000x3000 images, batch 5), against its plain PyTorch
   version on the same inputs: fp32 within 1e-4 of max|plain|, bf16
   within 1e-2 (one bf16 rounding on each side); its CUDA-event median
   time over 10 runs after warm-up beside the plain version's, one PyTorch
   library call's where one computes the same function (cuDNN conv / its
   gradients, einsum; timed here only, never called by the port; null for
   the fused BN tail passes and the fused conv1+tail wgrad, which no
   single call computes) and the least time the H100 could take (bytes
   over 3.35 TB/s or operations over the peak rate of their type, 989
   TFLOP/s bf16 or 67 TFLOP/s f32, whichever is larger). The BN tail
   passes and the fc input gradient also give their time a call over 20
   calls launched back to back (ms_back_to_back: the wrapper's host work
   hidden behind the device's). Every reducing
   kernel, and every BN tail pass, runs twice and must be bitwise equal.
   The fused conv1+tail wgrad is also held against the two kernels it
   replaces (the tail's apply pass, then the sparse conv1 wgrad). Then
   the LM's four kinds the
   same way at its shapes (flash attention B16 H8 S2048 D128 causal, the
   CE over [32768, 32768] logits; library calls SDPA, its backward and
   F.cross_entropy); dk/dv and dq run twice, bitwise equal, and with bf16
   inputs also write f32 outputs, which must come within 1e-4 of
   max|plain| of the plain version's f32 outputs (the precision witness
   of their split products). The forward's f32 out of bf16 inputs is held
   to 1e-4 on inputs whose p are exact in bf16 (integer scores at scale
   ln 2; its precision witness) and reported, at the bf16 tolerance, on
   the random inputs. The flash backward's bound counts every
   product as bf16 tensor-core work, its f32-operand products twice (hi
   and lo); the three flash kernel lines carry the registers and local
   memory a thread of their D 128 wgmma instances, as the CUDA runtime
   reports them for the loaded module. The NHWC
   plan's 13 kinds are checked the same way, their plain versions timed
   once each (library calls: cuDNN's F.conv2d on channels-last views for
   the forward, stats and dgrad, aten.convolution_backward for the
   wgrad; null for the tail passes).
3. ragged: each kernel at shapes off every tile edge (W=70, H=5, N*H not
   a multiple of a slab, CO off the channel tile, co=8 blk=2; the sparse
   conv1 at H4=W4=1, where every tap is a halo, at f1 8 and 5, at the odd
   W 75, at W 65 and with more (row, column) units than the card's
   blocks: CONV1_RAGGED), and
   the BN tail on bf16 inputs quantised to quarters, where pool ties
   occur: the pooled output equal, dy within one bf16 ulp of max|plain|.
   The transposed conv's forward, stats, dgrad and wgrad at W 70 and the
   odd W 75 (2-byte-aligned rows) with N*H 10, 21 and 3 (CONV_T_RAGGED),
   the stats y bitwise the forward's and the reducing kernels repeatable.
   lm_ragged: the flash kernels at S 200 and 130, D 40 and 64, causal
   off, non-zero offsets, kv_len short of S, B*H = 1, the backward's f32
   outputs of bf16 inputs among them, and ring hops wholly in the
   queries' future (out 0, lse NEG, zero gradients) and wholly in their
   past; the CE at N = 1 and C = 4097. ring_kernels: flash-ring attention
   at the LM's shapes over 4 shards of 512 tokens simulated in one
   process (flash_attention_with_lse and make_flash_bwd_lse's closure on
   the kernels, 4 hops a rank each way) against the same ring on the
   plain versions and the full-sequence kernels, two passes bitwise
   equal; each hop kind's time (diagonal, past, future) beside its bound
   and aten's flash attention and its backward on the same blocks (none
   for the future hop, which sees no key), and the hops of a pass beside
   the full-sequence kernels. The NHWC conv at CO 48 and 80 and at C 32, its tails at co 8
   blk 2 and co 4 blk 4, and its own bf16 tie case; its bf16 forward's
   runs of rows at W 65 and 130, N*H 134 (more rows than the card's
   blocks, the last run short) and 140 one-row images, for the forward,
   the stats (bitwise repeatable, y the forward's) and the dgrad
   (NHWC_RAGGED_RUNS). The NHWC wgrad's runs and tiles (NHWC_WGRAD_RAGGED:
   W 65 and 1, one-row images, more units than the card's blocks, CO 48
   and 80, C 32 and 128) and the transposed tail's forward, reduce and
   apply at the odd W 75 with N*H 21, at W 70, and at W 70 with y and g
   starting at an odd element, for four (co, blk) kinds
   (TAIL_REDUCE_RAGGED), each two runs bitwise equal; the NHWC tail's
   three passes the same way, at 1575 and 700 pixels (the last slab of
   the forward and the apply partly empty) and at an odd element, in
   fp32 and bf16; the NHWC reduce alone at its slab edges and at 1, 3, 4,
   8 and 32 groups a pixel (NHWC_REDUCE_RAGGED), the fc input gradient at
   N 1, 5, 8 and 9 and K 3 and 10, off and past a wave of blocks
   (FC_RAGGED_NK, FC_RAGGED_SHAPES).
4. main_path: tpu_sandbox_torch.mnist_onegpu's own train function at
   3000x3000, batch 5, bf16, synthetic MNIST, 5 steps, on the card's
   default plan (the sparse conv1, the fused BN tails and the fused
   conv1+tail backward), with every kernel launch counter zeroed just
   before and read just after: each of the path's launches must happen
   once per step, and no other. Step time (median after the first),
   images/s and peak device memory.
5. the other paths, the same way, each with its own launch set: the
   unfused conv1+tail backward (2 steps), the sparse conv1 with unfused
   tails (2), the scattered-3x3 conv1 with fused tails (3) and with
   unfused tails (3); --plan s2d, the NHWC ConvNetS2D, with fused convs
   and tails (3, 11 kinds a step) and with unfused tails (2, the 5 conv
   kinds); --plan plain, the plain NHWC ConvNet (3, no kernel of the port
   launched: cuDNN convs and F.max_pool2d); use_bn=False on the card's
   default plan (2, the sparse conv1's forward without statistics and the
   five other kinds of the unfused tails' path) and on --plan s2d with
   fused convs (2, the 5 conv kinds); --accum-steps 5 --native-loader on
   the default plan (2, the main path's kinds at N = 1, five times a
   step: the reference's out-of-memory workaround, its peak beside the
   main path's); their step times beside the main path's.
6. profile: two more steps of the main path under torch.profiler, device
   time per op or kernel, busy time and idle share of the step;
   profile_s2d: the same for the NHWC path (path_s2d).
7. lm_path: tpu_sandbox_torch.lm_train's own train function at the LM
   bench width (vocab 32768, d 1024, 8 heads, 12 layers, d_ff 4096, S
   2048, batch 16, bf16, --flash), 5 Adam steps, counters zeroed before
   and read after: exactly 12 flash forward, 12 dk/dv, 12 dq and 1 CE
   launch a step and nothing else, and lm_train's own check that the
   loss fell. Step time, tokens/s, peak device memory. lm_profile: two
   more steps under torch.profiler. path_sp_flash_ring and
   path_sp_ulysses: lm_train.fit_sp, SeqParallel over a one-rank
   {"data": 1, "sp": 1} mesh (NCCL), at the same width, 3 steps each,
   counters zeroed before and read after: the LM's launches a step and,
   for flash-ring, 12 forward hops and 12 calls of make_flash_bwd_lse's
   closure a step; losses against lm_path's within 2^-8 relative; step
   time, tokens/s and peak beside lm_path's. The pipelines and remat
   (LM_PATHS), 5 steps each (lm_path's, so that the median of the 4
   after the first is not set by one stalled step), the same way: path_pp (lm_train's own train,
   --parallelism pp --devices 1 --microbatches 2, one NCCL rank in this
   process), path_pp_circular (the same with --circular-chunks 2),
   path_pp_sp_flash_ring (lm_train.fit_pp with pp_sp over a one-rank
   {"data": 1, "pipe": 1, "sp": 1} mesh: the flash-ring in every stage,
   its hops counted) and path_3d (fit_pp with 3d over {"data": 1,
   "model": 1, "pipe": 1}: the Megatron block on flash); every tick is
   recomputed under the engine's remat, so a step launches the flash
   forward 2 x 12 x M times, dk/dv and dq 12 x M and the CE 2 x M (M 2
   microbatches). path_remat_dots and path_remat_full: lm_path's train
   with --remat and each --remat-policy, the flash forward 24 times a
   step (recomputed: no product), the rest as lm_path; whether the losses
   are lm_path's bit for bit. path_tp (lm_train.fit_pjit with tp over a
   one-rank {"data": 1, "model": 1} mesh: PjitEngine with
   megatron_rules(), lm_path's function and launches) and path_ep
   (fit_pjit with ep over {"data": 1, "expert": 1}: the MoE LM with
   EP_EXPERTS = 4 experts, the function of ep --devices 4, lm_path's
   launches; finite losses that fall). Beside each step's time, the
   cudaMalloc calls and allocator retries of that step and the Python
   collections of the oldest generation (sampled after each optimizer
   update).
8. card_vs_cpu: the port on the card against the port on the CPU, 64x64,
   fp32, 3 SGD steps from the same bridged weights on the same batches,
   on each transposed plan of the paths (path_accum's with 2 microbatches
   a step, path_no_bn's without BN), ConvNetS2D's four (fused_conv,
   fused_tail) plans, the plain ConvNet with and without BN and
   ConvNetS2D(fused_conv=True) without BN: losses within rtol 1e-4.
   pool_tie_card_vs_cpu: the plain ConvNet's pool on inputs quantised so
   that windows tie two, three and four ways, fp32 and bf16, output and
   input gradient bitwise the CPU's (the first-maximum rule).
   lm_card_vs_cpu:
   the same for a small LM (vocab 4100, so the CE kernel runs; d 64, 2
   heads, 2 layers, S 256, flash, fp32, 3 Adam steps), and SeqParallel
   with the plain ring attention on it at one rank (NCCL against gloo),
   after checking that the LM built on the card from seed 0 holds the
   CPU-built weights bitwise. moe_card_vs_cpu: the MoE LM at a small
   width (MOE_SMALL) through PjitEngine with the expert rule at one rank,
   NCCL against gloo, from the same seed: the first loss and every
   gradient within 1e-4.
9. profile_flag: mnist_onegpu --profile DIR, 2 steps of the default plan
   at 3000x3000; the trace must name one of the port's kernels.
   curve_card_vs_cpu: parity_run.py's protocol (128x128, batch 5, fp32,
   SGD at 1e-4) for 20 steps from one bridged tree on the plain ConvNet,
   ConvNetS2D (fused) and the default ConvNetS2DT, each card curve
   against its CPU curve within the committed record
   (parity_curves.jsonl:401: max abs 1.173e-3, max rel 0.143 %, mean abs
   4.7e-5).
10. dist_bootstrap: tpu_sandbox_torch.runtime.bootstrap.init at world
   size 1 on the card (NCCL): every CollectiveGroup collective on CUDA
   tensors with its values checked, the all-reduce bandwidth at 64 MiB,
   cleanup. path_dp: tpu_sandbox_torch.mnist_distributed's own train
   function, -g 1 (one NCCL rank in this process), at 3000x3000, batch 5,
   bf16, the card's default plan, 3 steps, counters zeroed before and
   read after: the main path's kinds once a step and no other; step time,
   images/s, peak memory and the rank-0 log line; then DataParallel at one
   rank against the single-device trainer from the same seed on the same
   batches, 2 steps: losses, parameters and BN statistics bitwise equal.
   path_dp_ext: the same run with each of the data-parallel extensions
   (DP_EXT_MODES: --opt adamw, then with --zero; --overlap-grad-sync;
   --grad-compress bf16; --grad-compress int8 with error feedback, and
   with --overlap-grad-sync), 3 steps each, counters zeroed before and
   read after: the main path's kinds once a step and no other, finite
   losses; --zero bitwise --opt adamw's run (losses, parameters, BN
   statistics: at one rank every leaf is its own whole block), and
   --overlap-grad-sync bitwise path_dp's losses; step time, its excess
   over path_dp's in this run, images/s and peak memory. The LM's
   compressed and bucketed sync is path_dp_int8_overlap in LM_PATHS
   (fit_pjit, dp over a one-rank {"data": 1} mesh, --grad-compress int8
   --overlap-grad-sync: the engine's int8 exchange and buckets on the
   card), its losses within 1e-4 relative of lm_path's.
   dist_scripts (after the curve phase): python -m
   tpu_sandbox_torch.test_init and .allreduce_toy at world size 1 on the
   card and as 4 gloo ranks with --force-cpu, at once, each with a time
   limit: exit 0, the reference's lines, the toy's sums.
   entry_refusals: python -m tpu_sandbox_torch.lm_train --parallelism p
   --devices 2 without --force-cpu for dp, tp, ep, sp and pp, and
   mnist_distributed --elastic --agents 2 -g 2, at once: each a non-zero
   exit naming the 2 ranks and the card count, before any agent starts
   (their gloo runs are CPU tests).
11. checkpoints and elastic resume, at the main path's width (after
   path_dp_ext). ckpt_card: the default plan through make_train_step, 2
   steps, the single-device save (the copy of the state to the host, the
   npz write with its SHA-256, the SHA-256 alone over the warm file, each
   timed), restore into a model built anew on the card (timed), the
   restored leaves bitwise the saved ones and 2 more steps from each state
   bitwise equal (losses and every leaf); the same state through
   ShardedCheckpoint(compress=True) and, with --opt adamw, through
   HostCheckpoint, with the bytes on disk of each. path_ckpt: main_path with --ckpt-dir D
   --ckpt-every 2: its launches, its losses bitwise main_path's, its step
   times beside main_path's, the saver's copy and write seconds and the
   last line "saved checkpoint at step 5". path_resumable:
   mnist_distributed's elastic rank body (train_elastic_worker) in this
   process at one NCCL rank against a KV store of this process, 6 steps
   of train_resumable with the non-finite guard and a HostCheckpoint
   every 2 steps: the main path's kinds once a step. path_elastic:
   mnist_distributed -g 1 --elastic under the supervisor of this process,
   one worker process a generation, once with a fault plan that SIGKILLs
   rank 0 at step 3 (two generations, one restart charged) and once with
   --ckpt-sharded and a SIGTERM at step 3 (the worker saves and exits 75,
   not charged): each final checkpoint bitwise path_resumable's; each
   generation's seconds. path_agents: python -m
   tpu_sandbox_torch.mnist_distributed --elastic --agents 1 -g 1 (an
   AgentLauncher process, one HostAgent process, its rank at one NCCL
   rank) with kill_agent on rank 0's agent at step 3: the launcher
   respawns the agent, which wins the lease at term 2 and reports its
   lost rank; one restart charged, exit 0, the final checkpoint bitwise
   path_resumable's; each generation's seconds and the seconds from the
   kill to the new term, as the agents' lines arrive. path_pool:
   ClusterScheduler(1) in this process with two such jobs (lo at priority
   0; hi at priority 1, submitted once lo's step-2 checkpoint is on disk): lo
   saves and exits 75 uncharged, hi runs to done, lo resumes to done,
   both final checkpoints bitwise path_resumable's; each job's queue, run
   and preemption seconds from job_events. The ranks of both phases write
   their launch counts (TPU_SANDBOX_LAUNCH_COUNTS): the main path's kinds
   once a step.
12. serving (after the LM paths), through tpu_sandbox_torch.serve, which
   launches no kernel of the port (JAX leaves prefill and decode attention
   to XLA; the port leaves them to PyTorch). serve_card_vs_cpu: the JAX
   serve tests' small LM (SERVE_SMALL) in fp32 from one seed through both
   engines on the card and on the CPU: the same greedy tokens, each step's
   logits within 1e-4 of max|CPU|, continuous equal to static, and a
   forced preemption replaying on the card to the tokens of the same
   requests without block pressure. path_serve: the LM at its bench width
   (SERVE_WIDTH) in bf16 with a bf16 cache (CacheConfig(1024, 16, 128),
   max_batch 16, buckets 128-1024), a seeded Poisson trace of 64 requests
   (SERVE_TRACE: prompts of 32-1024 tokens, a quarter opening with one
   256-token prefix, 16-128 new tokens, 10 ms mean gap) through
   ContinuousEngine and StaticEngine, open loop on the wall clock, kernel
   counters zeroed before and read after (none may launch): tokens/s,
   p50/p99 time to first token and inter-token latency, the median decode
   step, each bucket's median prefill, preemptions, prefix hits, peak
   memory, one decode step's device time by kind under torch.profiler
   beside its bound (weights, live K/V and logits once);
   continuous must equal static to the token. The 4 requests with the
   longest contexts (over 1000 tokens), served again, must give the same
   tokens, and each served logit row must lie within 2e-2 of max|plain|
   of one plain forward of the same weights over prompt and generated
   tokens, while the control (the context's first block replaced) must
   move every row by more than that. The shared
   prefix's K/V written under buckets 256, 512 and 1024 must agree within
   2^-7 of max|K, V|. path_replica: python -m
   tpu_sandbox_torch.serve.replica on the card at the same width (fp32,
   as the replica builds it) against a KV server of this process, 8
   requests: a SIGTERM once two verdicts are out (drain, exit 75), a
   second replica finishing the requeued ones (exit 0); one verdict a
   request, each "ok" with the tokens of the replica's engine run in this
   process. path_replica_gang: the same replicas and requests served by 2
   host agents under an AgentLauncher of this process, each agent's rank
   a replica on the card; kill_agent on agent 1 once two verdicts are
   out: the launcher replaces it, its successor reports the lost rank,
   the job ends ok with one restart charged, and every request has
   exactly one "ok" verdict with path_replica's in-process tokens.
   path_gateway: the front door at the same width: two replica processes
   and two ``python -m tpu_sandbox_torch.gateway`` processes (gw-a, gw-b),
   a GatewayClient holding both; path_replica's 8 requests through gw-a,
   gw-a SIGKILLed once two verdicts are out (the client fails over), then
   the same 8 prompts again through gw-b once the replicas advertise the
   first round's prefixes: one "ok" verdict a rid with path_replica's
   tokens, gw-b routing by prefix depth, gw-a's heartbeat lease lapsing;
   the client's submit-to-verdict p50 and p99 (host clock) and gw-b's
   stats. path_deploy: a rolling deploy to two replica processes behind
   one gateway: the LM from param_seed 1 published (publish_checkpoint)
   as version 1 over the boot weights (version 0), this process's
   DeployController verifying it, swapping a canary, putting the canary
   shares up while 4 requests go in through the gateway (each on the
   version it pinned, with that version's tokens), passing the canary
   rule and promoting both replicas; the 4 requests again on version 1's
   tokens, one event a decision, a clean registry audit; each replica's
   swap seconds (command to ack), the rollout's (publish to promote) and
   the artifact's bytes. The replicas of both phases write their launch
   counts (none: serving launches no kernel of the port); path_gateway's
   replicas write theirs over each phase's own window, ended by the
   ``launch_counts`` command of the replica's fault mailbox. path_chaos,
   between the two on path_gateway's fleet (its two replica processes and
   three more gateway processes, every process recording into one trace
   directory since the fleet started, this one from the campaign on): a
   seeded chaos campaign
   (tpu_sandbox_torch/runtime/chaos.py) of 24 requests
   replayed from workload.synthesize, the gateway the client holds
   SIGKILLed at 0.4 of the campaign and three seeded shed storms and
   0.5 s replica stalls. Zero lost, one "ok" verdict a rid with the
   tokens of an in-process engine on the same prompts, audit bytes equal
   to those built from the schedule and those tokens, clean alert claims,
   a failover and a prefix-routed probe through a surviving gateway; then
   the port's collector and critical path over the trace (coverage mean
   at least 0.95; each segment's share and median), the workload export
   (the synthesized rids, sizes and chains; a byte-stable round trip),
   the profile published to the tsdb and rendered by fleetop, and the
   fleetop, tracecat and tracediff CLIs, each exiting 0.
13. the {"kernels": [...]} summary, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

fp32 matmuls and convolutions run without TF32 throughout (the plain
versions are references).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F

STEPS = 5
BATCH = 5
IMAGE = 3000
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
#: of max|plain|; "bf16_f32": the flash kernels' bf16 inputs with f32
#: outputs, where only the kernel's arithmetic differs from the plain
#: version's f32 (the backward's split products carry about 2^-17 a term,
#: the forward's p are exact in bf16 on its witness inputs; TF32, one bf16
#: rounding of p or ds in the backward or a bf16-rounded out would not
#: pass)
TOL = {"fp32": 1e-4, "bf16": 1e-2, "bf16_f32": 1e-4}
DTYPES = (("fp32", torch.float32), ("bf16", torch.bfloat16))
CONV_SRC = "tpu_sandbox_torch/csrc/conv_t.cu"
FC_SRC = "tpu_sandbox_torch/csrc/fc_t.cu"
TAIL_SRC = "tpu_sandbox_torch/csrc/bn_tail_t.cu"
CONV5_SRC = "tpu_sandbox_torch/csrc/conv5_t.cu"
CONV1_TAIL_SRC = "tpu_sandbox_torch/csrc/conv1_tail_t.cu"
F1 = 16                      # conv1's output features
#: the main path's BN tails: (C, co, blk)
TAILS = ((256, 16, 4), (128, 32, 2))
#: f32 operations per element of y in each tail pass (rounding and
#: compares counted as one each): only the operations bound uses them
TAIL_OPS = {"fwd": 4, "bwd_reduce": 10, "bwd_apply": 10}
TAIL_REPLACES = {
    "fwd": "tpu_sandbox/ops/pallas_bn_tail_t.py:75",
    "bwd_reduce": "tpu_sandbox/ops/pallas_bn_tail_t.py:97",
    "bwd_apply": "tpu_sandbox/ops/pallas_bn_tail_t.py:123",
}
#: launches of one training step on each path
TAIL_KINDS = [f"bn_tail_t {p} C{c} CO{co}" for p in TAIL_OPS
              for c, co, _ in TAILS]
CONV2_KINDS = ["conv3x3_t dgrad C128 CO64", "conv3x3_t_wgrad C64 CO128",
               "fc_dgrad_t"]
SCATTERED_UNFUSED_KINDS = ["conv3x3_t fwd C16 CO256", "conv3x3_t fwd C64 CO128",
                           "conv3x3_t_wgrad C16 CO256"] + CONV2_KINDS
SCATTERED_FUSED_KINDS = (["conv3x3_t_stats C16 CO256",
                          "conv3x3_t_stats C64 CO128",
                          "conv3x3_t_wgrad C16 CO256"]
                         + CONV2_KINDS + TAIL_KINDS)
MAIN_KINDS = (["conv1_s2d_t_stats CO256", "conv1_tail_t wgrad CO256",
               "conv3x3_t_stats C64 CO128"] + CONV2_KINDS
              + [k for k in TAIL_KINDS if k != "bn_tail_t bwd_apply C256 CO16"])
UNFUSED_BWD_KINDS = (["conv1_s2d_t_stats CO256", "conv1_s2d_t_wgrad CO256",
                      "conv3x3_t_stats C64 CO128"] + CONV2_KINDS + TAIL_KINDS)
SPARSE_UNFUSED_KINDS = ["conv1_s2d_t fwd CO256", "conv1_s2d_t_wgrad CO256",
                        "conv3x3_t fwd C64 CO128"] + CONV2_KINDS
#: the NHWC plan (ConvNetS2D): its conv kinds and its tails' kinds
NHWC_CONV_SRC = "tpu_sandbox_torch/csrc/conv.cu"
NHWC_TAIL_SRC = "tpu_sandbox_torch/csrc/bn_tail.cu"
NHWC_TAIL_REPLACES = {
    "fwd": "tpu_sandbox/ops/pallas_bn_tail.py:114",
    "bwd_reduce": "tpu_sandbox/ops/pallas_bn_tail.py:136",
    "bwd_apply": "tpu_sandbox/ops/pallas_bn_tail.py:162",
}
NHWC_TAIL_KINDS = [f"bn_tail {p} C{c} CO{co}" for p in TAIL_OPS
                   for c, co, _ in TAILS]
NHWC_BWD_KINDS = ["conv3x3 dgrad C128 CO64", "conv3x3_wgrad C16 CO256",
                  "conv3x3_wgrad C64 CO128"]
S2D_KINDS = (["conv3x3_stats C16 CO256", "conv3x3_stats C64 CO128"]
             + NHWC_BWD_KINDS + NHWC_TAIL_KINDS)
S2D_UNFUSED_TAIL_KINDS = ["conv3x3 fwd C16 CO256",
                          "conv3x3 fwd C64 CO128"] + NHWC_BWD_KINDS
#: (phase, --plan, plan options for pick_convnet, steps, launch kinds):
#: the main path first; every kind of the kernel phase is on one of them
PATHS = (
    ("main_path", "auto", {}, STEPS, MAIN_KINDS),
    ("path_unfused_conv1_bwd", "auto", {"fused_conv1_bwd": False}, 2,
     UNFUSED_BWD_KINDS),
    ("path_sparse_unfused_tails", "auto", {"fused_tail": False}, 2,
     SPARSE_UNFUSED_KINDS),
    ("path_scattered_fused_tails", "auto", {"sparse_conv1": False}, 3,
     SCATTERED_FUSED_KINDS),
    ("path_scattered_unfused_tails", "auto",
     {"sparse_conv1": False, "fused_tail": False}, 3,
     SCATTERED_UNFUSED_KINDS),
    ("path_s2d", "s2d", {"fused_conv": True, "fused_tail": True}, 3,
     S2D_KINDS),
    ("path_s2d_unfused_tails", "s2d", {"fused_conv": True,
                                       "fused_tail": False}, 2,
     S2D_UNFUSED_TAIL_KINDS),
    # the plain NHWC ConvNet: cuDNN convs and F.max_pool2d, no kernel of
    # the port
    ("path_plain", "plain", {}, 3, []),
    # without BN the tails are plain and the convs run without statistics
    ("path_no_bn", "auto", {"use_bn": False}, 2, SPARSE_UNFUSED_KINDS),
    ("path_s2d_no_bn", "s2d", {"fused_conv": True, "use_bn": False}, 2,
     S2D_UNFUSED_TAIL_KINDS),
    # the main path's kernels at N = 1, ACCUM_STEPS times a step
    ("path_accum", "auto", {}, 2, MAIN_KINDS),
)
ALL_KINDS = sorted({k for *_, kinds in PATHS for k in kinds})
#: mnist_onegpu flags of a path beyond --plan and the common ones
ACCUM_STEPS = 5
PATH_FLAGS = {"path_accum": ["--accum-steps", str(ACCUM_STEPS),
                             "--native-loader"]}
#: path_dp: mnist_distributed -g 1 (NCCL, one rank) on the card's default
#: plan, and the steps held bitwise against the single-device trainer
DP_STEPS, DP_BITWISE_STEPS = 3, 2
#: path_dp_ext: the mnist_distributed flags of each data-parallel
#: extension over path_dp's, DP_STEPS steps each
DP_EXT_MODES = (
    ("adamw", ["--opt", "adamw"]),
    ("adamw_zero", ["--opt", "adamw", "--zero"]),
    ("overlap", ["--overlap-grad-sync"]),
    ("bf16", ["--grad-compress", "bf16"]),
    ("int8", ["--grad-compress", "int8"]),
    ("int8_overlap", ["--grad-compress", "int8", "--overlap-grad-sync"]),
)
#: the modes that must be another run bit for bit: a mode's whole run, or
#: path_dp's losses (None)
DP_EXT_BITWISE = {"adamw_zero": "adamw", "overlap": None}
#: ckpt_card: steps before the save and after the restore; path_ckpt's
#: --ckpt-every; path_resumable and path_elastic: mnist_distributed -g 1
#: with --ckpt-every ELASTIC_EVERY for ELASTIC_STEPS steps, the faults at
#: ELASTIC_FAULT_STEP
CKPT_STEPS, CKPT_EVERY = 2, 2
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_FAULT_STEP = 6, 2, 3
#: where the checkpoint phases write (inside the checkpoint, gitignored;
#: removed after each phase)
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
#: dist_scripts: (name, argv after python -m, time limit in seconds)
DIST_SCRIPTS = (
    ("test_init_nccl", ["tpu_sandbox_torch.test_init", "--world-size", "1"],
     300),
    ("test_init_gloo4", ["tpu_sandbox_torch.test_init", "--world-size", "4",
                         "--force-cpu"], 300),
    ("allreduce_toy_nccl", ["tpu_sandbox_torch.allreduce_toy", "-s", "1",
                            "--steps", "3"], 300),
    ("allreduce_toy_gloo4", ["tpu_sandbox_torch.allreduce_toy", "-s", "4",
                             "--steps", "3", "--force-cpu"], 300),
)
#: the loss-curve phase: parity_run.py's protocol (128x128, batch 5,
#: fp32, SGD at 1e-4) for CURVE_STEPS steps, card against CPU, held to
#: the committed record (parity_curves.jsonl:401)
CURVE_STEPS, CURVE_IMAGE, CURVE_N = 50, 128, 2000
CURVE_BAR = {"max_abs_dev": 1.173e-3, "max_rel_dev": 1.43e-3,
             "mean_abs_dev": 4.7e-5}
#: the pool tie case's NHWC shapes: one inside the 2x2 grid, one with an
#: odd row and column floored away
TIE_SHAPES = ((5, 300, 300, 16), (2, 301, 299, 32))
#: the NHWC conv's ragged (C, CO)
NHWC_RAGGED = ((16, 48), (16, 80), (32, 48))
#: the NHWC bf16 forward's run edges (N, H, W): W 65 and 130 (one and two
#: pixels past a 64- and 128-pixel W tile), N*H 2*67 in 128-pixel tiles
#: (268 rows: more than the card's blocks, runs crossing columns, the last
#: run short) and 140 one-row images (runs of whole columns, every row
#: between two halo rows); each for the forward and the stats at 64 -> 128
#: and 16 -> 256 channels and the dgrad's 128 -> 64 (64-pixel tiles)
NHWC_RAGGED_RUNS = ((1, 3, 65), (2, 67, 130), (140, 1, 65))
NHWC_RAGGED_RUNS_CH = ((64, 128, "fwd"), (16, 256, "fwd"), (128, 64, "dgrad"))
#: the NHWC bf16 wgrad's run and tile edges (N, H, W, C, CO): W 65 and 1
#: (a partial 128-pixel unit) and 130 (two pixels past one), one-row
#: images (both halo rows outside), 140 x 1 x 65 and 2 x 67 x 130 (more
#: units than the card's blocks, runs crossing columns), CO 48 and 80 (a
#: partial co tile), C 32 (two M tiles a warpgroup, one of them empty) and
#: C 128 (two channel chunks); each in bf16 and fp32, two runs bitwise
#: equal
NHWC_WGRAD_RAGGED = ((1, 3, 65, 16, 256), (140, 1, 65, 64, 128),
                     (2, 67, 130, 64, 128), (2, 5, 70, 16, 48),
                     (2, 5, 70, 16, 80), (2, 5, 70, 32, 48),
                     (1, 3, 65, 128, 64), (1, 4, 1, 16, 32))
#: the tail passes' edges (N, H, W), in both layouts: transposed, the odd
#: W 75 (rows 2-byte aligned: scalar loads) with N*H 21 (not a multiple of
#: a slab) and W 70; NHWC, 1575 and 700 pixels (the last 256-pixel slab of
#: the forward and the apply partly empty, 39 and 188 pixels); and W 70
#: again with y and g starting at an odd element of a larger buffer (one
#: element a word); each at the four (co, blk) kinds TAIL_REDUCE_KINDS
#: (bn1's and bn2's and the ragged co 8 blk 2 and co 4 blk 4; in NHWC co 4
#: takes the general path), for the forward, the reduce and the apply,
#: two runs bitwise equal
TAIL_REDUCE_RAGGED = ((3, 7, 75), (2, 5, 70))
TAIL_REDUCE_KINDS = ((16, 4), (32, 2), (8, 2), (4, 4))
#: the NHWC reduce's slab and walk edges (N, H, W): 69169 pixels (more
#: 256-pixel runs than the card's blocks: slabs of several runs, the last
#: one's last round partly filled, 69169 not a multiple of any round) and
#: 33 (one slab, one round and a pixel); at the main path's kinds (co 16
#: blk 4, co 32 blk 2: 8 and 4 groups a pixel), co 8 blk 2 (1 group: the
#: butterfly over all five lane bits), co 64 blk 4 (C 1024, 32 groups: no
#: butterfly) and co 24 blk 2 (3 groups: the general path); each in bf16
#: and fp32 and with y and g at an odd element (the general path, against
#: the 16-byte path on the same values), two runs bitwise equal
NHWC_REDUCE_RAGGED = ((1, 263, 263), (1, 3, 11))
NHWC_REDUCE_KINDS = ((16, 4), (32, 2), (8, 2), (64, 4), (24, 2))
#: the fc input gradient's ragged cases: batch N and classes K on both
#: sides of its specialised body (K 10, N <= 8), wT [K, H, C, W] of one
#: partial block and of more blocks than the card holds at once (720,000
#: features: 352 blocks of 256 bf16 vectors, the last one part full)
FC_RAGGED_NK = ((1, 3), (1, 10), (5, 3), (5, 10), (8, 3), (8, 10), (9, 3),
                (9, 10))
FC_RAGGED_SHAPES = ((3, 8, 7), (150, 32, 150))
#: the transposed conv's ragged (N, H, W): W 70 and the odd W 75 (rows of
#: 150 bytes, 2-byte aligned), N*H 10, 21 and 3 (off every slab and unit
#: count); each at (C, CO) 64->128 and 16->24 (fwd, stats, wgrad) and the
#: dgrad's 128->64
CONV_T_RAGGED = ((2, 5, 70), (3, 7, 75), (1, 3, 75))
CONV_T_RAGGED_CH = ((64, 128), (16, 24))
#: the sparse conv1's ragged shapes (N, H4, W4, f1): besides W 70 and
#: H4=W4=1, the bf16 bodies' edges: the odd W 75 (2-byte-aligned rows), W
#: 65 (one past a 64-column unit), N*H4 183 x 3 units (more units than the
#: card's blocks, the last block's run short), and f1 8 and 5 (CO 128, 80)
CONV1_RAGGED = ((2, 5, 70, 16), (1, 1, 1, 16), (3, 1, 1, 8), (2, 5, 70, 8),
                (2, 5, 70, 5), (3, 7, 75, 16), (1, 3, 65, 16),
                (3, 61, 130, 16), (3, 7, 75, 5))
FLASH_SRC = "tpu_sandbox_torch/csrc/flash_attention.cu"
CE_SRC = "tpu_sandbox_torch/csrc/ce.cu"
#: the LM's bench width (bench.py:4031-4040) through lm_train's flags
LM_B, LM_S, LM_H, LM_D, LM_V = 16, 2048, 8, 128, 32768
LM_FLAGS = ["--parallelism", "dp", "--devices", "1", "--flash",
            "--vocab", str(LM_V), "--d-model", str(LM_H * LM_D),
            "--n-heads", str(LM_H), "--n-layers", "12", "--d-ff", "4096",
            "--seq-len", str(LM_S), "--batch", str(LM_B), "--dtype", "bf16",
            "--steps", str(STEPS), "--log-every", "1"]
#: launches of one LM step: the flash kernels once per layer, the CE once
LM_KINDS = {"flash_fwd": 12, "flash_bwd_dkv": 12, "flash_bwd_dq": 12,
            "ce_fwd": 1}
#: the flash kernels' ragged cases (B, H, Sq, Sk, D, causal, q_offset,
#: kv_offset, kv_len); D 40 runs zero-padded to the 64 head width. A query
#: that sees no key gets out 0 from the kernel and a p = 1 spread from the
#: plain version (a ring's merge weighs it 0): its out is held to be
#: finite, and 0 where the hop is wholly in its future, not to the plain
#: value; its lse is the mask filler's on both sides
FLASH_RAGGED = ((1, 1, 200, 200, 64, True, 0, 0, 200),
                (1, 2, 200, 200, 32, True, 0, 0, 200),
                (2, 1, 130, 200, 32, False, 70, 5, 190),
                (2, 2, 200, 200, 40, True, 0, 0, 200),
                (1, 2, 200, 200, 64, False, 0, 0, 197),
                (2, 2, 200, 200, 40, False, 0, 0, 200),
                (1, 2, 130, 200, 64, True, 70, 5, 190),
                (2, 1, 72, 100, 40, True, 96, 0, 100),
                (1, 1, 64, 256, 128, False, 7, 300, 256),
                # ring hops: keys wholly in the queries' future (no tile
                # visited, out 0 and zero gradients) and wholly in their
                # past (every pair visible, no diagonal tile), at S 200
                # and at the LM ring's 512-token blocks, one with kv_len
                # short
                (2, 2, 200, 200, 64, True, 0, 256, 200),
                (2, 2, 200, 200, 64, True, 256, 0, 200),
                (1, 2, 512, 512, 128, True, 0, 512, 512),
                (1, 2, 512, 512, 128, True, 1536, 0, 512),
                (1, 1, 130, 200, 32, True, 300, 0, 190))
#: the CE kernel's ragged cases (N, C): one row, a row width off 16 bytes
CE_RAGGED = ((1, 4097), (3, 4097), (5, 4100), (1, 32768))
#: ring_kernels: the LM's sequence in RING_N shards of LM_S / RING_N
RING_N = 4
#: path_sp: SeqParallel at one NCCL rank at the LM's bench width, steps a
#: scheme, and its losses' bar against lm_path's (the same function, the
#: same kernels; one bf16 ulp, 2^-8, relative)
SP_STEPS, SP_SCHEMES, SP_LOSS_RTOL = 3, ("flash_ring", "ulysses"), 2.0 ** -8
#: entry_refusals: lm_train with two GPU ranks of each plan that spawns
#: ranks, and mnist_distributed's two host agents of one GPU rank each, on
#: this one-card machine (module and argv after python -m), and the
#: seconds they may take together
ENTRY_REFUSALS = {p: ["tpu_sandbox_torch.lm_train", "--parallelism", p,
                      "--devices", "2", "--steps", "1"]
                  for p in ("dp", "tp", "ep", "sp", "pp")}
ENTRY_REFUSALS["agents"] = ["tpu_sandbox_torch.mnist_distributed",
                            "--elastic", "--agents", "2", "-g", "2",
                            "--limit-steps", "1"]
ENTRY_LIMIT = 120
#: the pipelines' microbatches on the card, and the launches of one step
#: under the engine's tick remat: every tick's forward runs twice (the
#: recompute stops at the tick's last saved tensor, the CE's logits,
#: which the CE saves after its kernel ran)
PP_M = 2
TICK_REMAT_KINDS = {"flash_fwd": 2 * 12 * PP_M, "flash_bwd_dkv": 12 * PP_M,
                    "flash_bwd_dq": 12 * PP_M, "ce_fwd": 2 * PP_M}
#: --remat on the LM: the flash forward recomputed in every block (no
#: matrix product, so dots recomputes it too), the head outside the blocks
REMAT_KINDS = {**LM_KINDS, "flash_fwd": 2 * LM_KINDS["flash_fwd"]}
#: the experts of path_ep: the function of ep --devices 4
EP_EXPERTS = 4
#: path_dp_int8_overlap's losses' bar against lm_path's: its int8 mean
#: moves the gradient by up to half a step of each block's scale, which
#: moved the 5 losses by up to 1.4e-5 relative on the H100 (PERF.md); a
#: broken exchange (scales, codes, the residual) moves them far more
DP_INT8_LOSS_RTOL = 1e-4
#: (phase, lm_train flags over LM_FLAGS, the one-rank mesh of fit_pp or
#: fit_pjit or None for lm_train.train, launches a step, ring hops a
#: step, the losses' bar against lm_path's: SP_LOSS_RTOL where it computes
#: lm_path's function, None where it does not); LM_PATH_STEPS steps each
LM_PATHS = (
    ("path_pp", ["--parallelism", "pp", "--microbatches", str(PP_M)], None,
     TICK_REMAT_KINDS, {}, SP_LOSS_RTOL),
    ("path_pp_circular", ["--parallelism", "pp", "--microbatches",
                          str(PP_M), "--circular-chunks", "2"], None,
     TICK_REMAT_KINDS, {}, SP_LOSS_RTOL),
    ("path_pp_sp_flash_ring", ["--parallelism", "pp_sp", "--microbatches",
                               str(PP_M)], {"data": 1, "pipe": 1, "sp": 1},
     TICK_REMAT_KINDS, {"flash_fwd_lse": 2 * 12 * PP_M,
                        "flash_bwd_lse": 12 * PP_M}, SP_LOSS_RTOL),
    ("path_3d", ["--parallelism", "3d", "--microbatches", str(PP_M)],
     {"data": 1, "model": 1, "pipe": 1}, TICK_REMAT_KINDS, {},
     SP_LOSS_RTOL),
    ("path_remat_dots", ["--remat", "--remat-policy", "dots"], None,
     REMAT_KINDS, {}, SP_LOSS_RTOL),
    ("path_remat_full", ["--remat", "--remat-policy", "full"], None,
     REMAT_KINDS, {}, SP_LOSS_RTOL),
    ("path_tp", ["--parallelism", "tp"], {"data": 1, "model": 1},
     LM_KINDS, {}, SP_LOSS_RTOL),
    ("path_ep", ["--parallelism", "ep", "--devices", str(EP_EXPERTS)],
     {"data": 1, "expert": 1}, LM_KINDS, {}, None),
    ("path_dp_int8_overlap", ["--grad-compress", "int8",
                              "--overlap-grad-sync"], {"data": 1},
     LM_KINDS, {}, DP_INT8_LOSS_RTOL),
)
#: LM_PATHS' steps: lm_path's, all its losses held; the step time is the
#: median of the 4 after the first
LM_PATH_STEPS = STEPS
#: moe_card_vs_cpu: the MoE LM at a small width (vocab 4100, so that the
#: CE kernel runs), its first loss (rtol) and gradients (of max|CPU|)
MOE_SMALL = ["--parallelism", "ep", "--devices", str(EP_EXPERTS), "--flash",
             "--vocab", "4100", "--d-model", "64", "--n-heads", "2",
             "--n-layers", "2", "--d-ff", "128", "--seq-len", "256",
             "--batch", "2", "--steps", "1", "--dtype", "fp32"]
MOE_RTOL = 1e-4
#: serving (serve_card_vs_cpu, path_serve, path_replica): the LM at its
#: bench width, lm_path's, with the slice's cache, batch and buckets
SERVE_WIDTH = dict(vocab_size=32768, d_model=1024, n_heads=8, n_layers=12,
                   d_ff=4096, max_len=2048)
SERVE_CACHE = dict(num_blocks=1024, block_size=16, max_blocks_per_seq=128)
SERVE_BATCH = 16
SERVE_BUCKETS = (128, 256, 512, 1024)
#: path_serve's trace: Poisson arrivals at this mean gap, prompt and new
#: token counts uniform in these ranges, a quarter of the requests opening
#: with one shared prefix of this many tokens
SERVE_TRACE = dict(requests=64, prompt=(32, 1024), new=(16, 128),
                   prefix=256, interarrival_s=0.010, seed=0)
#: path_serve against a plain forward: the trace's requests with the
#: longest contexts, served again, each served logit row within this share
#: of max|plain| at its position (bf16 weights, activations and cache on
#: both sides, accumulated in another order)
SERVE_REF_REQUESTS = 4
SERVE_REF_TOL = 2e-2
#: path_serve's prefix probe: the shared prefix's K/V pages written under
#: each bucket that holds it, within this share of max|K, V| of the first
SERVE_PREFIX_TOL = 2 ** -7
#: serve_card_vs_cpu: the JAX serve tests' geometry (tests/test_serve.py),
#: fp32; each call's logits on the card within this share of max|CPU|
SERVE_SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                   d_ff=64, max_len=128)
SERVE_SMALL_CACHE = dict(num_blocks=24, block_size=4, max_blocks_per_seq=8)
SERVE_CARD_TOL = 1e-4
#: path_replica: requests, and the seconds a replica process may take
REPLICA_REQUESTS = 8
REPLICA_LIMIT = 300.0
#: path_agents, path_pool and path_replica_gang (the cross-host plane):
#: the seconds each run may take, and the environment of its agents (the
#: supervisor's backoff of path_elastic; the plane's defaults otherwise)
PLANE_LIMIT = 300.0
PLANE_ENV = {"TPU_SANDBOX_BACKOFF": "0.1"}
#: path_agents: a lease shorter than an agent's start (importing torch
#: alone takes longer), so the respawned agent finds it vacant and elects
#: term 2; within a live lease it would resume its predecessor's term (a
#: member id is the agent id, whatever its incarnation)
AGENTS_ENV = {"TPU_SANDBOX_LEASE_TTL": "1"}
#: path_deploy: the requests of each round (the first of
#: ``_replica_load()``'s), the replicas' config over path_replica's (a
#: longer lease, so a replica's load report (its TTL 1.5 leases) outlives
#: the seconds it spends verifying and loading the bench width's weights,
#: and the controller never takes it for dead mid-swap), and the
#: controller's DeployConfig: the defaults (1 s buckets, windows and
#: swap re-sends; 3 clean evaluations; the logprob rule's -0.5) without
#: the p99 TTFT ratio, which over the few requests a replica serves here
#: reads the process's first (warm-up) request, not the weights
DEPLOY_REQUESTS = 4
DEPLOY_REPLICA = {"lease_ttl": 6.0}
DEPLOY_CONFIG = {"ttft_ratio": None}
#: path_gateway and path_chaos share one fleet (``_front_door``): its
#: replica processes, and path_gateway's gateway processes (ended at the
#: end of path_gateway)
FRONT_DOOR_TAGS = ("fd-r0", "fd-r1")
GATEWAY_IDS = ("gw-a", "gw-b")
#: path_chaos (the SIGKILL arm of JAX's bench_chaos on replicas at the
#: bench width): the campaign's seed, its workload (requests over the
#: seconds, prompt and decode tokens uniform in these ranges), its gateway
#: processes (the client holds the first, SIGKILLed at CHAOS_KILL_AT of
#: the seconds), the seeded faults drawn after the kill (shed storms and
#: stalls of CHAOS_STALL_S on the replicas)
CHAOS_SEED = 1
CHAOS_REQUESTS = 24
CHAOS_SECONDS = 4.0
CHAOS_PROMPT = (32, 512)
CHAOS_DECODE = (16, 64)
CHAOS_GATEWAYS = ("gw0", "gw1", "gw2")
CHAOS_KILL_AT = 0.4
CHAOS_FAULTS = 3
CHAOS_STALL_S = 0.5
#: the segments of path_chaos's where-time-goes line, in the order printed
CHAOS_SEGMENTS = ("prefill", "decode", "queue_wait", "engine_queue",
                  "publish_wait", "route", "submit", "unattributed")
#: path_replica_gang: one host agent whose one rank is a serve replica on
#: the card (JAX's tests/test_serve_integration.py:62, with an agent
#: timeout that outlasts a respawned agent's start, so the replacement's
#: report of its lost rank is what tears the generation down), argv:
#: agent id, agents, KV port, replica config
GANG_AGENT = """
import sys
from tpu_sandbox_torch.runtime.host_agent import AgentConfig, HostAgent
aid, agents, kv_port, config = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
cfg = AgentConfig(agent_id=aid, num_agents=agents, world_size=agents,
                  kv_port=kv_port, lease_ttl=2.0, agent_timeout=30.0,
                  term_timeout=10.0, backoff=0.1)
def rank_cmd(gen, rank, coord_port):
    return [sys.executable, "-m", "tpu_sandbox_torch.serve.replica",
            "--config", config, "--tag", f"replica-r{rank}-g{gen}"]
sys.exit(HostAgent(cfg, rank_cmd).run())
"""


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


#: wall seconds of each phase of this run (``timed``), in run order
SECONDS: dict[str, float] = {}


@contextlib.contextmanager
def timed(name: str):
    """Add the wall seconds of the block to SECONDS[name]."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        SECONDS[name] = SECONDS.get(name, 0.0) + time.monotonic() - t0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
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


def back_to_back_ms(fn, calls: int = 20) -> float:
    """Per call, the median of 5 CUDA-event timings of ``calls`` calls of
    ``fn`` launched back to back: the device's time with the wrapper's host
    work hidden behind the device's, which cuda_ms's single calls expose."""
    def run():
        for _ in range(calls):
            fn()
    return cuda_ms(run, reps=5) / calls


def device_times(fn, calls: int = 10) -> list[tuple[float, float, str]]:
    """(ms a call, launches a call, name) of each kernel and copy that
    ``fn`` launches, largest first: its self device time under
    torch.profiler over ``calls`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted(((ev.self_device_time_total / 1e3 / calls,
                    ev.count / calls, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)


def device_ms(fn, calls: int = 10) -> float:
    """Per call, the device time of everything ``fn`` launches (the summed
    ``device_times``): the card's time with the host's excluded, which a
    single timed call of a short pass does not show."""
    return sum(ms for ms, _, _ in device_times(fn, calls))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, bytes_: int, peak: float = PEAK_BF16_FLOPS,
          f32_flops: float = 0.0) -> tuple[float, str]:
    """The least time in ms: bytes over the memory rate, or ``flops`` at
    ``peak`` plus ``f32_flops`` at the f32 rate, whichever is larger."""
    t_ops = flops / peak + f32_flops / PEAK_F32_FLOPS
    t_bytes = bytes_ / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare(got, want, dtype_name: str, what: str) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item() or 1.0
    finite = bool(torch.isfinite(got.float()).all().item())
    rel = err / scale
    require(finite, f"{what} {dtype_name}: non-finite output")
    require(rel <= TOL[dtype_name],
            f"{what} {dtype_name}: max abs err {err} = {rel:.3g} of "
            f"max|plain| {scale}, tolerance {TOL[dtype_name]}")
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_err": rel,
            "tolerance": TOL[dtype_name]}


def require_repeatable(first, fn, what: str) -> None:
    """A kernel's second run must equal its first bitwise."""
    again = fn()
    require(all(torch.equal(a, b) for a, b in zip(again, first)),
            f"{what}: two runs differ (not deterministic)")


def phase_env(build) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = build.build_all()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         build_seconds=info["seconds"], built=info["built"],
         ptxas=info["ptxas"])
    return smi


def _conv_case(gen, n, h, c, w, co, dtype, *, nhwc=False):
    """x [n,h,c,w] (ops.conv_t) or, with ``nhwc``, [n,h,w,c] (ops.conv),
    w [3,3,c,co] and bias [co] in dtype."""
    dev = "cuda"
    x_shape = (n, h, w, c) if nhwc else (n, h, c, w)
    x = torch.randn(x_shape, generator=gen, device=dev).to(dtype)
    wt = (torch.randn((3, 3, c, co), generator=gen, device=dev)
          / math.sqrt(9 * c)).to(dtype)
    b = torch.randn((co,), generator=gen, device=dev).to(dtype)
    return x, wt, b


def _tail_case(mod, gen, n, h, c, co, blk, w, dtype, *, quantised=False,
               nhwc=False):
    """(y, g, gamma, beta, per-channel operands of the three passes): the
    statistics and the backward's columns from the plain versions, so the
    kernel and its plain version see the same inputs. ``mod`` is
    ops.bn_tail_t ([N,H,C,W]) or, with ``nhwc``, ops.bn_tail ([N,H,W,C])."""
    y_shape, g_shape = (((n, h, w, c), (n, h, w, c // 4)) if nhwc
                        else ((n, h, c, w), (n, h, c // 4, w)))
    y = torch.randn(y_shape, generator=gen, device="cuda")
    if quantised:                        # quarters: bf16 pool ties
        y = torch.round(y * 4) / 4
    y = y.to(dtype)
    g = torch.randn(g_shape, generator=gen, device="cuda").to(dtype)
    if quantised:
        gamma = torch.ones(co, device="cuda")
        beta = torch.zeros(co, device="cuda")
    else:
        gamma = 1 + 0.1 * torch.randn(co, generator=gen, device="cuda")
        beta = torch.randn(co, generator=gen, device="cuda")
    reps = blk * blk
    mu, var = (mod.stats if nhwc else mod.stats_t)(y, co)
    inv = torch.rsqrt(var + 1e-5)
    a_co = inv * gamma
    a_col = mod.col_expand(a_co, reps)
    b_col = mod.col_expand(beta - mu * a_co, reps)
    s1, s2 = mod.bwd_reduce_plain(y, g, co, blk, a_col, b_col, mu, inv)
    cols = mod.bwd_scales(s1, s2, gamma, inv, reps, y.numel() // co)
    return y, g, gamma, beta, (a_col, b_col, mu, inv), cols


def _check_tail(bn_tail_t, case, co, blk, dt_name, what) -> dict:
    """Each tail pass against its plain version, each twice, bitwise
    equal. ``bn_tail_t`` is either tail module (ops.bn_tail_t or
    ops.bn_tail)."""
    y, g, _, _, (a_col, b_col, mu, inv), cols = case
    fwd = bn_tail_t.tail_fwd(y, a_col, b_col, co, blk)
    out = {"fwd": compare(fwd, bn_tail_t.tail_fwd_plain(y, a_col, b_col, co,
                                                        blk),
                          dt_name, what + " fwd")}
    require_repeatable((fwd,), lambda: (bn_tail_t.tail_fwd(y, a_col, b_col,
                                                           co, blk),),
                       what + " fwd " + dt_name)
    del fwd
    args = (y, g, co, blk, a_col, b_col, mu, inv)
    s12 = bn_tail_t.bwd_reduce(*args)
    p12 = bn_tail_t.bwd_reduce_plain(*args)
    out["bwd_reduce"] = compare(s12[0], p12[0], dt_name, what + " s1")
    out["bwd_reduce_s2"] = compare(s12[1], p12[1], dt_name, what + " s2")
    require_repeatable(s12, lambda: bn_tail_t.bwd_reduce(*args),
                       what + " bwd_reduce " + dt_name)
    dy = bn_tail_t.bwd_apply(*args, *cols)
    out["bwd_apply"] = compare(dy, bn_tail_t.bwd_apply_plain(*args, *cols),
                               dt_name, what + " dy")
    require_repeatable((dy,), lambda: (bn_tail_t.bwd_apply(*args, *cols),),
                       what + " bwd_apply " + dt_name)
    return out


def _conv1_case(gen, n, h, w, f1, dtype):
    """x [n,h,16,w] in dtype, a k5 [5,5,1,f1] and bias [f1] in f32."""
    x = torch.randn((n, h, 16, w), generator=gen, device="cuda").to(dtype)
    k5 = 0.3 * torch.randn((5, 5, 1, f1), generator=gen, device="cuda")
    b = torch.randn((f1,), generator=gen, device="cuda")
    return x, k5, b


def _check_conv1(conv5_t, x, w1, bias_g, g, dt_name, what) -> dict:
    """The sparse conv1's three kernels against their plain versions: the
    forward, the stats variant (its y bitwise the forward kernel's, two
    runs bitwise equal) and the wgrad (two runs bitwise equal)."""
    y = conv5_t.conv1_s2d_t_forward(x, w1, bias_g)
    out = {"fwd": compare(y, conv5_t.conv1_s2d_t_plain(x, w1, bias_g),
                          dt_name, what + " fwd")}
    got = conv5_t.conv1_s2d_t_stats_forward(x, w1, bias_g)
    want = conv5_t.conv1_s2d_t_stats_plain(x, w1, bias_g)
    for i, part in enumerate(("", "_sum", "_sumsq")):
        out["stats" + part] = compare(got[i], want[i], dt_name,
                                      what + " stats" + part)
    require(torch.equal(got[0], y),
            f"{what} stats {dt_name}: y differs from the forward kernel's")
    require_repeatable(got, lambda: conv5_t.conv1_s2d_t_stats_forward(
        x, w1, bias_g), f"{what} stats {dt_name}")
    del y, got, want
    dw1, db = conv5_t.conv1_s2d_t_wgrad(x, g)
    pdw1, pdb = conv5_t.conv1_s2d_t_wgrad_plain(x, g)
    out["wgrad"] = compare(dw1, pdw1, dt_name, what + " wgrad")
    out["wgrad_db"] = compare(db, pdb, dt_name, what + " wgrad db")
    require_repeatable((dw1, db), lambda: conv5_t.conv1_s2d_t_wgrad(x, g),
                       f"{what} wgrad {dt_name}")
    return out


def _conv1_tail_case(bn_tail_t, gen, n, h, w, f1, dtype):
    """(x, the fused wgrad's other operands in bwd_apply's order: y1, g,
    co, blk, a_col, b_col, mu, inv, gi, c1, c2) for conv1 with f1
    features (bn1: co = f1, blk = 4)."""
    x = torch.randn((n, h, 16, w), generator=gen, device="cuda").to(dtype)
    y, g, _, _, vecs, cols = _tail_case(bn_tail_t, gen, n, h, 16 * f1, f1, 4,
                                        w, dtype)
    return x, (y, g, f1, 4, *vecs, *cols)


def _check_conv1_tail(conv1_tail_t, conv5_t, bn_tail_t, x, args, dt_name,
                      what) -> dict:
    """The fused conv1+tail wgrad against its plain version (two runs
    bitwise equal), and against the two ported kernels it replaces: the
    tail's apply pass, then the sparse conv1 wgrad."""
    got = conv1_tail_t.fused_wgrad(x, *args)
    want = conv1_tail_t.fused_wgrad_plain(x, *args)
    out = {"": compare(got[0], want[0], dt_name, what),
           "_db": compare(got[1], want[1], dt_name, what + " db")}
    require_repeatable(got, lambda: conv1_tail_t.fused_wgrad(x, *args),
                       f"{what} {dt_name}")
    del want
    composed = conv5_t.conv1_s2d_t_wgrad(x, bn_tail_t.bwd_apply(*args))
    out["_vs_composed"] = compare(got[0], composed[0], dt_name,
                                  what + " vs apply+wgrad")
    out["_vs_composed_db"] = compare(got[1], composed[1], dt_name,
                                     what + " db vs apply+wgrad")
    out["_vs_composed_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(got, composed))
    return out


def _full_res(x, g, f1):
    """The s2d image x [N,H4,16,W4] and a conv1 output cotangent g
    [N,H4,16*f1,W4] as full-resolution NCHW tensors [N,1,H,W] and
    [N,f1,H,W], for the library calls."""
    n, h, _, w = x.shape
    img = x.reshape(n, h, 4, 4, w).permute(0, 1, 2, 4, 3).reshape(
        n, 1, 4 * h, 4 * w).contiguous()
    gn = g.reshape(n, h, 4, 4, f1, w).permute(0, 4, 1, 2, 5, 3).reshape(
        n, f1, 4 * h, 4 * w).contiguous()
    return img, gn


def phase_kernels(conv_t, fc_t, bn_tail_t, conv5_t, conv1_tail_t, conv,
                  bn_tail) -> dict:
    """Every launch kind of the paths at its main-path shape; returns the
    summary entries keyed by launch-counter name."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w = BATCH, IMAGE // 4, IMAGE // 4
    entries = {}

    def record(name, source, replaces, rec, ms, plain_ms, library_ms, *,
               flops, bytes_, peak=PEAK_BF16_FLOPS, library_note=None,
               **extra):
        entries[name] = dict(
            _entry(name, source, replaces, rec, ms, plain_ms, library_ms,
                   flops=flops, bytes_=bytes_, peak=peak,
                   library_note=library_note), **extra)
        emit("kernel", **entries[name], checks=rec)

    def conv_library(x, wt, b, kind):
        """One cuDNN call for the same conv on NCHW copies."""
        xn = x.permute(0, 2, 1, 3).contiguous()          # NCHW
        if kind == "dgrad":
            # the input gradient of the conv whose flipped weights these
            # are: cuDNN's dgrad of the forward conv (weights flipped back)
            wf = conv_t.flip_transpose(wt).permute(3, 2, 0, 1).contiguous()
            shape = (n, wt.shape[-1], h, w)
            return cuda_ms(lambda: torch.nn.grad.conv2d_input(
                shape, wf, xn, padding=1), reps=5)
        wo = wt.permute(3, 2, 0, 1).contiguous()         # OIHW
        return cuda_ms(lambda: F.conv2d(xn, wo, b, padding=1), reps=5)

    def conv_fwd(c, co, kind):
        name = f"conv3x3_t {kind} C{c} CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x, wt, b = _conv_case(gen, n, h, c, w, co, dt)
            if kind == "dgrad":
                b = torch.zeros_like(b)
            got = conv_t.conv3x3_t_forward(x, wt, b, kind=kind)
            want = conv_t.conv3x3_t_plain(x, wt, b)
            rec[dt_name] = compare(got, want, dt_name, name)
            del got, want
        # time in the main path's dtype, on the bf16 inputs
        ms = cuda_ms(lambda: conv_t.conv3x3_t_forward(x, wt, b, kind=kind))
        plain_ms = cuda_ms(lambda: conv_t.conv3x3_t_plain(x, wt, b), reps=5)
        y_bytes = n * h * co * w * x.element_size()
        record(name, CONV_SRC, "tpu_sandbox/ops/pallas_conv_t.py:133", rec,
               ms, plain_ms, conv_library(x, wt, b, kind),
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, wt, b) + y_bytes)

    def conv_stats(c, co):
        name = f"conv3x3_t_stats C{c} CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x, wt, b = _conv_case(gen, n, h, c, w, co, dt)
            got = conv_t.conv3x3_t_stats_forward(x, wt, b)
            want = conv_t.conv3x3_t_stats_plain(x, wt, b)
            for i, part in enumerate(("", "_sum", "_sumsq")):
                rec[dt_name + part] = compare(got[i], want[i], dt_name,
                                              name + part)
            require(torch.equal(got[0], conv_t.conv3x3_t_forward(x, wt, b)),
                    f"{name} {dt_name}: y differs from the forward kernel's")
            require_repeatable(
                got, lambda: conv_t.conv3x3_t_stats_forward(x, wt, b),
                f"{name} {dt_name}")
            del got, want
        ms = cuda_ms(lambda: conv_t.conv3x3_t_stats_forward(x, wt, b))
        plain_ms = cuda_ms(lambda: conv_t.conv3x3_t_stats_plain(x, wt, b),
                           reps=5)
        y_bytes = n * h * co * w * x.element_size()
        record(name, CONV_SRC, "tpu_sandbox/ops/pallas_conv_t.py:140", rec,
               ms, plain_ms, conv_library(x, wt, b, "fwd"),
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, wt, b) + y_bytes + 2 * 4 * co,
               library_note="F.conv2d on NCHW copies: the conv without "
                            "the statistics")

    def conv_wgrad(c, co):
        name = f"conv3x3_t_wgrad C{c} CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x = torch.randn((n, h, c, w), generator=gen, device="cuda").to(dt)
            g = torch.randn((n, h, co, w), generator=gen, device="cuda").to(dt)
            dwt, db = conv_t.conv3x3_t_wgrad(x, g)
            pdwt, pdb = conv_t.conv3x3_t_wgrad_plain(x, g)
            rec[dt_name] = compare(dwt, pdwt, dt_name, name)
            rec[dt_name + "_db"] = compare(db, pdb, dt_name, name + " db")
            require_repeatable((dwt, db), lambda: conv_t.conv3x3_t_wgrad(x, g),
                               f"{name} {dt_name}")
        ms = cuda_ms(lambda: conv_t.conv3x3_t_wgrad(x, g))
        plain_ms = cuda_ms(lambda: conv_t.conv3x3_t_wgrad_plain(x, g),
                           reps=5)
        xn = x.permute(0, 2, 1, 3).contiguous()
        gn = g.permute(0, 2, 1, 3).contiguous()
        library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            xn, (co, c, 3, 3), gn, padding=1), reps=5)
        record(name, CONV_SRC, "tpu_sandbox/ops/pallas_conv_t.py:167", rec,
               ms, plain_ms, library_ms,
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, g) + 4 * (co * 9 * c + co))

    def fc_dgrad():
        name = "fc_dgrad_t"
        rec = {}
        for dt_name, dt in DTYPES:
            g = torch.randn((n, 10), generator=gen, device="cuda")
            wt = (0.01 * torch.randn((10, h, 32, w), generator=gen,
                                     device="cuda")).to(dt)
            got = fc_t.fc_dgrad_t(g, wt, dt)
            want = fc_t.fc_dgrad_t_plain(g, wt, dt)
            rec[dt_name] = compare(got, want, dt_name, name)
            del got, want
        ms = cuda_ms(lambda: fc_t.fc_dgrad_t(g, wt, wt.dtype))
        ms_b2b = back_to_back_ms(lambda: fc_t.fc_dgrad_t(g, wt, wt.dtype))
        plain_ms = cuda_ms(lambda: fc_t.fc_dgrad_t_plain(g, wt, wt.dtype),
                           reps=5)
        gb = g.to(wt.dtype)
        library_ms = cuda_ms(
            lambda: torch.einsum("nk,khcw->nhcw", gb, wt), reps=5)
        dy_bytes = n * wt[0].numel() * wt.element_size()
        record(name, FC_SRC, "tpu_sandbox/ops/pallas_fc_t.py:63", rec,
               ms, plain_ms, library_ms,
               flops=2.0 * n * 10 * wt[0].numel(),
               bytes_=nbytes(g, wt) + dy_bytes, ms_back_to_back=ms_b2b)

    def tail(c, co, blk, nhwc=False):
        """One tail's three passes in the transposed layout (ops.bn_tail_t)
        or, with ``nhwc``, in NHWC (ops.bn_tail)."""
        mod, prefix = (bn_tail, "bn_tail") if nhwc else (bn_tail_t, "bn_tail_t")
        fused, unfused = ((mod.fused_bn_relu_pool, mod.unfused_reference)
                          if nhwc else (mod.fused_bn_relu_pool_t,
                                        mod.unfused_reference_t))
        what = f"C{c} CO{co}"
        rec = {p: {} for p in TAIL_OPS}
        for dt_name, dt in DTYPES:
            case = _tail_case(mod, gen, n, h, c, co, blk, w, dt, nhwc=nhwc)
            checks = _check_tail(mod, case, co, blk, dt_name,
                                 f"{prefix} {what}")
            for key, val in checks.items():
                p = key.removesuffix("_s2")
                rec[p][dt_name + key[len(p):]] = val
            # the whole fused function's statistics and output against
            # the unfused chain it replaces
            y, _, gamma, beta, _, _ = case
            fo, fmu, fvar = fused(y, gamma, beta, co, blk)
            ro, rmu, rvar = unfused(y, gamma, beta, co, blk)
            rec["fwd"][dt_name + "_mu"] = compare(fmu, rmu, "fp32", "mu")
            rec["fwd"][dt_name + "_var"] = compare(fvar, rvar, "fp32", "var")
            rec["fwd"][dt_name + "_unfused"] = compare(fo, ro, dt_name,
                                                       "fused vs unfused")
            del fo, ro, case
            torch.cuda.empty_cache()
        y, g, _, _, vecs, cols = _tail_case(mod, gen, n, h, c, co, blk, w,
                                            torch.bfloat16, nhwc=nhwc)
        args = (y, g, co, blk, *vecs)
        out_bytes = y.numel() // 4 * y.element_size()
        runs = {
            "fwd": (lambda: mod.tail_fwd(y, *vecs[:2], co, blk),
                    lambda: mod.tail_fwd_plain(y, *vecs[:2], co, blk),
                    nbytes(y, *vecs[:2]) + out_bytes),
            "bwd_reduce": (lambda: mod.bwd_reduce(*args),
                           lambda: mod.bwd_reduce_plain(*args),
                           nbytes(y, g, *vecs) + 8 * co),
            "bwd_apply": (lambda: mod.bwd_apply(*args, *cols),
                          lambda: mod.bwd_apply_plain(*args, *cols),
                          nbytes(y, g, *vecs, *cols) + nbytes(y)),  # + dy
        }
        src, replaces = ((NHWC_TAIL_SRC, NHWC_TAIL_REPLACES) if nhwc
                         else (TAIL_SRC, TAIL_REPLACES))
        for p, (kernel, plain, bytes_) in runs.items():
            # the NHWC plain versions are timed once, to keep the run short
            plain_ms = (cuda_ms(plain, reps=1, warmup=0) if nhwc
                        else cuda_ms(plain, reps=5))
            record(f"{prefix} {p} {what}", src, replaces[p], rec[p],
                   cuda_ms(kernel), plain_ms, None,
                   flops=TAIL_OPS[p] * y.numel(), bytes_=bytes_,
                   peak=PEAK_F32_FLOPS,
                   library_note="no single PyTorch call computes this "
                                "fused pass",
                   ms_back_to_back=back_to_back_ms(kernel))
        del y, g, args, runs
        torch.cuda.empty_cache()

    def conv1_sparse():
        co = 16 * F1
        rec = {"fwd": {}, "stats": {}, "wgrad": {}}
        for dt_name, dt in DTYPES:
            x, k5, b = _conv1_case(gen, n, h, w, F1, dt)
            w1, bias_g = conv5_t.prep(k5, b, dt)
            g = torch.randn((n, h, co, w), generator=gen, device="cuda").to(dt)
            checks = _check_conv1(conv5_t, x, w1, bias_g, g, dt_name,
                                  f"conv1_s2d_t CO{co}")
            for key, val in checks.items():
                kind = key.split("_")[0]
                rec[kind][dt_name + key[len(kind):]] = val
            del g, checks
            torch.cuda.empty_cache()
        # time in the main path's dtype, on the bf16 inputs
        x, k5, b = _conv1_case(gen, n, h, w, F1, torch.bfloat16)
        w1, bias_g = conv5_t.prep(k5, b, torch.bfloat16)
        g = torch.randn((n, h, co, w), generator=gen,
                        device="cuda").to(torch.bfloat16)
        img, gn = _full_res(x, g, F1)
        kn = k5.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        bn = b.to(torch.bfloat16)
        lib_fwd = cuda_ms(lambda: F.conv2d(img, kn, bn, padding=2), reps=5)
        flops = 2.0 * n * h * w * co * conv5_t.NT
        y_bytes = n * h * co * w * x.element_size()
        conv_note = ("F.conv2d of the full-resolution [5,1,3000,3000] image "
                     "with the [16,1,5,5] kernel, padding 2")
        record(f"conv1_s2d_t fwd CO{co}", CONV5_SRC,
               "tpu_sandbox/ops/pallas_conv5_t.py:123", rec["fwd"],
               cuda_ms(lambda: conv5_t.conv1_s2d_t_forward(x, w1, bias_g)),
               cuda_ms(lambda: conv5_t.conv1_s2d_t_plain(x, w1, bias_g),
                       reps=5), lib_fwd,
               flops=flops, bytes_=nbytes(x, w1, bias_g) + y_bytes,
               library_note=conv_note)
        record(f"conv1_s2d_t_stats CO{co}", CONV5_SRC,
               "tpu_sandbox/ops/pallas_conv5_t.py:130", rec["stats"],
               cuda_ms(lambda: conv5_t.conv1_s2d_t_stats_forward(
                   x, w1, bias_g)),
               cuda_ms(lambda: conv5_t.conv1_s2d_t_stats_plain(
                   x, w1, bias_g), reps=5), lib_fwd,
               flops=flops, bytes_=nbytes(x, w1, bias_g) + y_bytes + 8 * co,
               library_note=conv_note + ": the conv without the statistics")
        record(f"conv1_s2d_t_wgrad CO{co}", CONV5_SRC,
               "tpu_sandbox/ops/pallas_conv5_t.py:154", rec["wgrad"],
               cuda_ms(lambda: conv5_t.conv1_s2d_t_wgrad(x, g)),
               cuda_ms(lambda: conv5_t.conv1_s2d_t_wgrad_plain(x, g), reps=5),
               cuda_ms(lambda: torch.nn.grad.conv2d_weight(
                   img, (F1, 1, 5, 5), gn, padding=2), reps=5),
               flops=flops,
               bytes_=nbytes(x, g) + 4 * (co * conv5_t.NT + co),
               library_note="torch.nn.grad.conv2d_weight of the same conv "
                            "on full-resolution NCHW copies")
        del x, g, img, gn
        torch.cuda.empty_cache()

    def conv1_tail():
        co = 16 * F1
        name = f"conv1_tail_t wgrad CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x, args = _conv1_tail_case(bn_tail_t, gen, n, h, w, F1, dt)
            checks = _check_conv1_tail(conv1_tail_t, conv5_t, bn_tail_t, x,
                                       args, dt_name, name)
            for key, val in checks.items():
                rec[dt_name + key] = val
            del x, args, checks
            torch.cuda.empty_cache()
        x, args = _conv1_tail_case(bn_tail_t, gen, n, h, w, F1,
                                   torch.bfloat16)
        record(name, CONV1_TAIL_SRC,
               "tpu_sandbox/ops/pallas_conv1_tail_t.py:74", rec,
               cuda_ms(lambda: conv1_tail_t.fused_wgrad(x, *args)),
               cuda_ms(lambda: conv1_tail_t.fused_wgrad_plain(x, *args),
                       reps=3), None,
               flops=2.0 * n * h * w * co * conv5_t.NT,
               bytes_=(nbytes(x, args[0], args[1], *args[4:])
                       + 4 * (co * conv5_t.NT + co)),
               library_note="no single PyTorch call computes the BN tail's "
                            "dy and the conv weight gradient together",
               composed_ms=cuda_ms(lambda: conv5_t.conv1_s2d_t_wgrad(
                   x, bn_tail_t.bwd_apply(*args))))
        del x, args
        torch.cuda.empty_cache()

    def nhwc_library(x, wt, b):
        """One cuDNN call for the same conv on channels-last views."""
        xv = x.permute(0, 3, 1, 2)                  # NCHW view, channels last
        wo = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return cuda_ms(lambda: F.conv2d(xv, wo, b, padding=1), reps=5)

    def nhwc_conv_fwd(c, co, kind):
        name = f"conv3x3 {kind} C{c} CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x, wt, b = _conv_case(gen, n, h, c, w, co, dt, nhwc=True)
            if kind == "dgrad":
                b = torch.zeros_like(b)
            got = conv.conv3x3_forward(x, wt, b, kind=kind)
            rec[dt_name] = compare(got, conv.conv3x3_plain(x, wt, b), dt_name,
                                   name)
            del got
        # time in the path's dtype, on the bf16 inputs; the plain version
        # once, to keep the run short
        ms = cuda_ms(lambda: conv.conv3x3_forward(x, wt, b, kind=kind))
        plain_ms = cuda_ms(lambda: conv.conv3x3_plain(x, wt, b), reps=1,
                           warmup=0)
        record(name, NHWC_CONV_SRC, "tpu_sandbox/ops/pallas_conv.py:135", rec,
               ms, plain_ms, nhwc_library(x, wt, b),
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, wt, b) + n * h * w * co * x.element_size(),
               library_note="F.conv2d on channels-last views (cuDNN)"
                            + (", the same conv on the flipped weights"
                               if kind == "dgrad" else ""))
        del x, wt, b
        torch.cuda.empty_cache()

    def nhwc_conv_stats(c, co):
        name = f"conv3x3_stats C{c} CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x, wt, b = _conv_case(gen, n, h, c, w, co, dt, nhwc=True)
            got = conv.conv3x3_stats_forward(x, wt, b)
            want = conv.conv3x3_stats_plain(x, wt, b)
            for i, part in enumerate(("", "_sum", "_sumsq")):
                rec[dt_name + part] = compare(got[i], want[i], dt_name,
                                              name + part)
            require(torch.equal(got[0], conv.conv3x3_forward(x, wt, b)),
                    f"{name} {dt_name}: y differs from the forward kernel's")
            require_repeatable(
                got, lambda: conv.conv3x3_stats_forward(x, wt, b),
                f"{name} {dt_name}")
            del got, want
        ms = cuda_ms(lambda: conv.conv3x3_stats_forward(x, wt, b))
        plain_ms = cuda_ms(lambda: conv.conv3x3_stats_plain(x, wt, b),
                           reps=1, warmup=0)
        record(name, NHWC_CONV_SRC, "tpu_sandbox/ops/pallas_conv.py:142", rec,
               ms, plain_ms, nhwc_library(x, wt, b),
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=(nbytes(x, wt, b) + n * h * w * co * x.element_size()
                       + 2 * 4 * co),
               library_note="F.conv2d on channels-last views (cuDNN): the "
                            "conv without the statistics")
        del x, wt, b
        torch.cuda.empty_cache()

    def nhwc_conv_wgrad(c, co):
        name = f"conv3x3_wgrad C{c} CO{co}"
        rec = {}
        for dt_name, dt in DTYPES:
            x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dt)
            g = torch.randn((n, h, w, co), generator=gen, device="cuda").to(dt)
            dw, db = conv.conv3x3_wgrad(x, g)
            pdw, pdb = conv.conv3x3_wgrad_plain(x, g)
            rec[dt_name] = compare(dw, pdw, dt_name, name)
            rec[dt_name + "_db"] = compare(db, pdb, dt_name, name + " db")
            require_repeatable((dw, db), lambda: conv.conv3x3_wgrad(x, g),
                               f"{name} {dt_name}")
            del dw, db, pdw, pdb
        ms = cuda_ms(lambda: conv.conv3x3_wgrad(x, g))
        plain_ms = cuda_ms(lambda: conv.conv3x3_wgrad_plain(x, g), reps=1,
                           warmup=0)
        wgt = torch.empty((co, c, 3, 3), dtype=x.dtype, device="cuda").contiguous(
            memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wgt, [co], [1, 1],
            [1, 1], [1, 1], False, [0, 0], 1, [False, True, True]), reps=5)
        record(name, NHWC_CONV_SRC, "tpu_sandbox/ops/pallas_conv.py:170", rec,
               ms, plain_ms, library_ms,
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, g) + 4 * (9 * c * co + co),
               library_note="torch.ops.aten.convolution_backward, weight and "
                            "bias, on channels-last views (cuDNN)")
        del x, g
        torch.cuda.empty_cache()

    conv1_sparse()
    conv1_tail()
    conv_fwd(16, 256, "fwd")
    torch.cuda.empty_cache()
    conv_fwd(64, 128, "fwd")
    conv_fwd(128, 64, "dgrad")
    torch.cuda.empty_cache()
    conv_stats(16, 256)
    torch.cuda.empty_cache()
    conv_stats(64, 128)
    torch.cuda.empty_cache()
    conv_wgrad(16, 256)
    torch.cuda.empty_cache()
    conv_wgrad(64, 128)
    fc_dgrad()
    torch.cuda.empty_cache()
    for c, co, blk in TAILS:
        tail(c, co, blk)
    nhwc_conv_fwd(16, 256, "fwd")
    nhwc_conv_fwd(64, 128, "fwd")
    nhwc_conv_fwd(128, 64, "dgrad")
    nhwc_conv_stats(16, 256)
    nhwc_conv_stats(64, 128)
    nhwc_conv_wgrad(16, 256)
    nhwc_conv_wgrad(64, 128)
    for c, co, blk in TAILS:
        tail(c, co, blk, nhwc=True)
    return entries


def phase_ragged(conv_t, fc_t, bn_tail_t, conv5_t, conv1_tail_t, conv,
                 bn_tail) -> None:
    """Shapes off every tile edge: W=70, H=5, N*H=10 rows (not a multiple
    of the wgrad, stats or tail slab), CO=24 and 80 (off the 64- and
    128-channel tiles), C=16; fc with F not a multiple of the block; the
    tails at co=8 blk=2 and co=4 blk=4; the sparse conv1 and the fused
    conv1+tail wgrad at W4=70 with N*H4=10, at H4=W4=1 (every tap a halo)
    and at f1 8 and 5 (CO 128 and 80); and the bf16 tie case. The NHWC
    kernels the same way: the conv's forward, stats and wgrad at W=70,
    N*H=10, (C, CO) = (16, 48), (16, 80) and (32, 48) (CO a multiple of 16,
    as the bf16 kernels take it, off the 64- and 128-channel tiles; two
    16-channel chunks), its tails at co=8 blk=2 and co=4 blk=4, and its
    tie case. The transposed conv's four kinds at each CONV_T_RAGGED
    shape (_conv_t_ragged), and each tail's three passes at the
    TAIL_REDUCE_RAGGED shapes (_tail_passes_ragged)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dt_name, dt in DTYPES:
        for n, h, w, f1 in CONV1_RAGGED:
            what = f"conv1 n{n} h{h} w{w} f1{f1}"
            x, k5, b = _conv1_case(gen, n, h, w, f1, dt)
            w1, bias_g = conv5_t.prep(k5, b, dt)
            g = torch.randn((n, h, 16 * f1, w), generator=gen,
                            device="cuda").to(dt)
            for key, val in _check_conv1(conv5_t, x, w1, bias_g, g, dt_name,
                                         "ragged " + what).items():
                out[f"{what} {key} {dt_name}"] = val
            x, args = _conv1_tail_case(bn_tail_t, gen, n, h, w, f1, dt)
            for key, val in _check_conv1_tail(
                    conv1_tail_t, conv5_t, bn_tail_t, x, args, dt_name,
                    "ragged conv1_tail " + what).items():
                out[f"{what} tail_wgrad{key} {dt_name}"] = val
        x, wt, b = _conv_case(gen, 2, 5, 16, 70, 24, dt)
        out[f"conv fwd {dt_name}"] = compare(
            conv_t.conv3x3_t_forward(x, wt, b),
            conv_t.conv3x3_t_plain(x, wt, b), dt_name, "ragged conv fwd")
        g = torch.randn((2, 5, 24, 70), generator=gen, device="cuda").to(dt)
        dwt, db = conv_t.conv3x3_t_wgrad(x, g)
        pdwt, pdb = conv_t.conv3x3_t_wgrad_plain(x, g)
        out[f"wgrad {dt_name}"] = compare(dwt, pdwt, dt_name,
                                          "ragged wgrad")
        out[f"wgrad db {dt_name}"] = compare(db, pdb, dt_name,
                                             "ragged wgrad db")
        gf = torch.randn((3, 10), generator=gen, device="cuda")
        w4 = torch.randn((10, 3, 8, 7), generator=gen, device="cuda").to(dt)
        out[f"fc dgrad {dt_name}"] = compare(
            fc_t.fc_dgrad_t(gf, w4, dt),
            fc_t.fc_dgrad_t_plain(gf, w4, dt), dt_name, "ragged fc dgrad")
        for (fn_, fk), shape in ((nk, sh) for nk in FC_RAGGED_NK
                                 for sh in FC_RAGGED_SHAPES):
            what = f"fc dgrad n{fn_} k{fk} {'x'.join(map(str, shape))}"
            gf = torch.randn((fn_, fk), generator=gen, device="cuda")
            w4 = torch.randn((fk, *shape), generator=gen,
                             device="cuda").to(dt)
            out[f"{what} {dt_name}"] = compare(
                fc_t.fc_dgrad_t(gf, w4, dt),
                fc_t.fc_dgrad_t_plain(gf, w4, dt), dt_name, f"ragged {what}")
        for co in (24, 80):
            x, wt, b = _conv_case(gen, 2, 5, 16, 70, co, dt)
            got = conv_t.conv3x3_t_stats_forward(x, wt, b)
            want = conv_t.conv3x3_t_stats_plain(x, wt, b)
            for i, part in enumerate(("y", "sum", "sumsq")):
                out[f"stats CO{co} {part} {dt_name}"] = compare(
                    got[i], want[i], dt_name, f"ragged stats CO{co} {part}")
        for n, h, w in CONV_T_RAGGED:
            out.update(_conv_t_ragged(conv_t, gen, n, h, w, dt_name, dt))
        for co, blk in ((8, 2), (4, 4)):
            case = _tail_case(bn_tail_t, gen, 2, 5, blk * blk * co, co, blk,
                              70, dt)
            for key, val in _check_tail(bn_tail_t, case, co, blk, dt_name,
                                        f"ragged tail co{co} blk{blk}").items():
                out[f"tail co{co} blk{blk} {key} {dt_name}"] = val
        for c, co in NHWC_RAGGED:
            what = f"nhwc C{c} CO{co}"
            x, wt, b = _conv_case(gen, 2, 5, c, 70, co, dt, nhwc=True)
            out[f"{what} fwd {dt_name}"] = compare(
                conv.conv3x3_forward(x, wt, b), conv.conv3x3_plain(x, wt, b),
                dt_name, f"ragged {what} fwd")
            got = conv.conv3x3_stats_forward(x, wt, b)
            want = conv.conv3x3_stats_plain(x, wt, b)
            for i, part in enumerate(("y", "sum", "sumsq")):
                out[f"{what} stats {part} {dt_name}"] = compare(
                    got[i], want[i], dt_name, f"ragged {what} stats {part}")
            g = torch.randn((2, 5, 70, co), generator=gen,
                            device="cuda").to(dt)
            dw, db = conv.conv3x3_wgrad(x, g)
            pdw, pdb = conv.conv3x3_wgrad_plain(x, g)
            out[f"{what} wgrad {dt_name}"] = compare(
                dw, pdw, dt_name, f"ragged {what} wgrad")
            out[f"{what} wgrad db {dt_name}"] = compare(
                db, pdb, dt_name, f"ragged {what} wgrad db")
        for n, h, w in NHWC_RAGGED_RUNS:
            out.update(_nhwc_runs(conv, gen, n, h, w, dt_name, dt))
        for shape in NHWC_WGRAD_RAGGED:
            out.update(_nhwc_wgrad_ragged(conv, gen, shape, dt_name, dt))
        for n, h, w in TAIL_REDUCE_RAGGED:
            out.update(_tail_passes_ragged(bn_tail_t, gen, n, h, w, dt_name,
                                           dt))
        out.update(_tail_passes_ragged(bn_tail_t, gen, *TAIL_REDUCE_RAGGED[1],
                                       dt_name, dt, odd=True))
        for co, blk in ((8, 2), (4, 4)):
            case = _tail_case(bn_tail, gen, 2, 5, blk * blk * co, co, blk, 70,
                              dt, nhwc=True)
            for key, val in _check_tail(
                    bn_tail, case, co, blk, dt_name,
                    f"ragged nhwc tail co{co} blk{blk}").items():
                out[f"nhwc tail co{co} blk{blk} {key} {dt_name}"] = val
        for n, h, w in TAIL_REDUCE_RAGGED:
            out.update(_tail_passes_ragged(bn_tail, gen, n, h, w, dt_name,
                                           dt, nhwc=True))
        out.update(_tail_passes_ragged(bn_tail, gen, *TAIL_REDUCE_RAGGED[1],
                                       dt_name, dt, odd=True, nhwc=True))
        for n, h, w in NHWC_REDUCE_RAGGED:
            out.update(_nhwc_reduce_ragged(bn_tail, gen, n, h, w, dt_name,
                                           dt))
    out["tie"] = _tie_case(bn_tail_t, gen)
    out["nhwc tie"] = _tie_case(bn_tail, gen, nhwc=True)
    torch.cuda.synchronize()
    emit("ragged", checks=out)


def _conv_t_ragged(conv_t, gen, n, h, w, dt_name, dt) -> dict:
    """The transposed conv's four kinds at one ragged (N, H, W): the
    forward, the stats (y bitwise the forward's, two runs bitwise equal)
    and the wgrad (two runs bitwise equal) at each CONV_T_RAGGED_CH, and
    the dgrad at 128 -> 64 channels."""
    out = {}
    for c, co in CONV_T_RAGGED_CH:
        what = f"conv_t n{n} h{h} w{w} C{c} CO{co}"
        x, wt, b = _conv_case(gen, n, h, c, w, co, dt)
        y = conv_t.conv3x3_t_forward(x, wt, b)
        out[f"{what} fwd {dt_name}"] = compare(
            y, conv_t.conv3x3_t_plain(x, wt, b), dt_name, f"ragged {what} fwd")
        got = conv_t.conv3x3_t_stats_forward(x, wt, b)
        want = conv_t.conv3x3_t_stats_plain(x, wt, b)
        for i, part in enumerate(("y", "sum", "sumsq")):
            out[f"{what} stats {part} {dt_name}"] = compare(
                got[i], want[i], dt_name, f"ragged {what} stats {part}")
        require(torch.equal(got[0], y),
                f"ragged {what} stats {dt_name}: y differs from the forward's")
        require_repeatable(got, lambda: conv_t.conv3x3_t_stats_forward(
            x, wt, b), f"ragged {what} stats {dt_name}")
        g = torch.randn((n, h, co, w), generator=gen, device="cuda").to(dt)
        dwt, db = conv_t.conv3x3_t_wgrad(x, g)
        pdwt, pdb = conv_t.conv3x3_t_wgrad_plain(x, g)
        out[f"{what} wgrad {dt_name}"] = compare(
            dwt, pdwt, dt_name, f"ragged {what} wgrad")
        out[f"{what} wgrad db {dt_name}"] = compare(
            db, pdb, dt_name, f"ragged {what} wgrad db")
        require_repeatable((dwt, db), lambda: conv_t.conv3x3_t_wgrad(x, g),
                           f"ragged {what} wgrad {dt_name}")
    what = f"conv_t n{n} h{h} w{w} C128 CO64"
    x, wt, b = _conv_case(gen, n, h, 128, w, 64, dt)
    b = torch.zeros_like(b)
    out[f"{what} dgrad {dt_name}"] = compare(
        conv_t.conv3x3_t_forward(x, wt, b, kind="dgrad"),
        conv_t.conv3x3_t_plain(x, wt, b), dt_name, f"ragged {what} dgrad")
    return out


def _nhwc_runs(conv, gen, n, h, w, dt_name, dt) -> dict:
    """The NHWC forward at one NHWC_RAGGED_RUNS shape: for each
    NHWC_RAGGED_RUNS_CH the forward (or dgrad) against its plain version
    and, for the forwards, the stats (y bitwise the forward's, two runs
    bitwise equal)."""
    out = {}
    for c, co, kind in NHWC_RAGGED_RUNS_CH:
        what = f"nhwc n{n} h{h} w{w} C{c} CO{co}"
        x, wt, b = _conv_case(gen, n, h, c, w, co, dt, nhwc=True)
        if kind == "dgrad":
            b = torch.zeros_like(b)
        y = conv.conv3x3_forward(x, wt, b, kind=kind)
        out[f"{what} {kind} {dt_name}"] = compare(
            y, conv.conv3x3_plain(x, wt, b), dt_name, f"ragged {what} {kind}")
        if kind == "dgrad":
            continue
        got = conv.conv3x3_stats_forward(x, wt, b)
        want = conv.conv3x3_stats_plain(x, wt, b)
        for i, part in enumerate(("y", "sum", "sumsq")):
            out[f"{what} stats {part} {dt_name}"] = compare(
                got[i], want[i], dt_name, f"ragged {what} stats {part}")
        require(torch.equal(got[0], y),
                f"ragged {what} stats {dt_name}: y differs from the forward's")
        require_repeatable(got, lambda: conv.conv3x3_stats_forward(x, wt, b),
                           f"ragged {what} stats {dt_name}")
    return out


def _nhwc_wgrad_ragged(conv, gen, shape, dt_name, dt) -> dict:
    """The NHWC wgrad at one NHWC_WGRAD_RAGGED shape against its plain
    version, two runs bitwise equal."""
    n, h, w, c, co = shape
    what = f"nhwc wgrad n{n} h{h} w{w} C{c} CO{co}"
    x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dt)
    g = torch.randn((n, h, w, co), generator=gen, device="cuda").to(dt)
    dw, db = conv.conv3x3_wgrad(x, g)
    pdw, pdb = conv.conv3x3_wgrad_plain(x, g)
    out = {f"{what} {dt_name}": compare(dw, pdw, dt_name, f"ragged {what}"),
           f"{what} db {dt_name}": compare(db, pdb, dt_name,
                                           f"ragged {what} db")}
    require_repeatable((dw, db), lambda: conv.conv3x3_wgrad(x, g),
                       f"ragged {what} {dt_name}")
    return out


def _at_odd_element(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts at element 1 of a larger
    buffer: its rows hold no whole pairs, so the passes take one element
    at a time."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _tail_passes_ragged(bn_tail_t, gen, n, h, w, dt_name, dt, *,
                        odd=False, nhwc=False) -> dict:
    """One tail's three passes at one TAIL_REDUCE_RAGGED shape (or, with
    ``odd``, with y and g starting at an odd element), for each
    TAIL_REDUCE_KINDS, against their plain versions, two runs bitwise
    equal. ``bn_tail_t`` is either tail module, ``nhwc`` says which."""
    out = {}
    layout = "nhwc " if nhwc else ""
    for co, blk in TAIL_REDUCE_KINDS:
        at = " odd" if odd else ""
        y, g, _, _, vecs, cols = _tail_case(bn_tail_t, gen, n, h,
                                            blk * blk * co, co, blk, w, dt,
                                            nhwc=nhwc)
        if odd:
            y, g = _at_odd_element(y), _at_odd_element(g)
        args = (y, g, co, blk, *vecs)
        what = f"{layout}tail reduce n{n} h{h} w{w}{at} co{co} blk{blk}"
        got = bn_tail_t.bwd_reduce(*args)
        want = bn_tail_t.bwd_reduce_plain(*args)
        out[f"{what} s1 {dt_name}"] = compare(got[0], want[0], dt_name,
                                              f"ragged {what} s1")
        out[f"{what} s2 {dt_name}"] = compare(got[1], want[1], dt_name,
                                              f"ragged {what} s2")
        require_repeatable(got, lambda: bn_tail_t.bwd_reduce(*args),
                           f"ragged {what} {dt_name}")
        what = f"{layout}tail fwd n{n} h{h} w{w}{at} co{co} blk{blk}"
        got = (bn_tail_t.tail_fwd(y, *vecs[:2], co, blk),)
        out[f"{what} {dt_name}"] = compare(
            got[0], bn_tail_t.tail_fwd_plain(y, *vecs[:2], co, blk), dt_name,
            f"ragged {what}")
        require_repeatable(got, lambda: (bn_tail_t.tail_fwd(
            y, *vecs[:2], co, blk),), f"ragged {what} {dt_name}")
        what = f"{layout}tail apply n{n} h{h} w{w}{at} co{co} blk{blk}"
        got = (bn_tail_t.bwd_apply(*args, *cols),)
        out[f"{what} {dt_name}"] = compare(
            got[0], bn_tail_t.bwd_apply_plain(*args, *cols), dt_name,
            f"ragged {what}")
        require_repeatable(got, lambda: (bn_tail_t.bwd_apply(*args, *cols),),
                           f"ragged {what} {dt_name}")
    return out


def _nhwc_reduce_ragged(bn_tail, gen, n, h, w, dt_name, dt) -> dict:
    """The NHWC reduce at one NHWC_REDUCE_RAGGED shape, for each
    NHWC_REDUCE_KINDS, as laid out and at an odd element, against its
    plain version, two runs bitwise equal."""
    out = {}
    for co, blk in NHWC_REDUCE_KINDS:
        y, g, _, _, vecs, _ = _tail_case(bn_tail, gen, n, h, blk * blk * co,
                                         co, blk, w, dt, nhwc=True)
        for at in ("", " odd"):
            if at:
                y, g = _at_odd_element(y), _at_odd_element(g)
            args = (y, g, co, blk, *vecs)
            what = f"nhwc reduce n{n} h{h} w{w}{at} co{co} blk{blk}"
            got = bn_tail.bwd_reduce(*args)
            want = bn_tail.bwd_reduce_plain(*args)
            for i, part in enumerate(("s1", "s2")):
                out[f"{what} {part} {dt_name}"] = compare(
                    got[i], want[i], dt_name, f"ragged {what} {part}")
            require_repeatable(got, lambda: bn_tail.bwd_reduce(*args),
                               f"ragged {what} {dt_name}")
    return out


def _tie_case(bn_tail_t, gen, *, nhwc=False) -> dict:
    """bf16 inputs quantised to quarters with gamma 1 and beta 0: the
    rounded z has exact ties inside pool windows, which the kernels must
    route 0.5/0.5 as the plain version does. ``bn_tail_t`` is either tail
    module, ``nhwc`` says which."""
    co, blk = 8, 2
    case = _tail_case(bn_tail_t, gen, 2, 5, blk * blk * co, co, blk, 70,
                      torch.bfloat16, quantised=True, nhwc=nhwc)
    y, g, _, _, (a_col, b_col, mu, inv), cols = case
    z = bn_tail_t._windows(bn_tail_t._rounded_relu(y, a_col, b_col), blk, co)
    # a window's representative and its partner at offset co
    rep, partner = ((z[..., :, 0, :, 0, :], z[..., :, 0, :, 1, :]) if nhwc
                    else (z[:, :, :, 0, :, 0], z[:, :, :, 0, :, 1]))
    ties = int(((rep == partner) & (rep > 0)).sum().item())
    require(ties > 0, "tie case: no pool window holds a tie")
    out = bn_tail_t.tail_fwd(y, a_col, b_col, co, blk)
    require(torch.equal(out, bn_tail_t.tail_fwd_plain(y, a_col, b_col, co,
                                                      blk)),
            "tie case: pooled output differs from the plain version")
    args = (y, g, co, blk, a_col, b_col, mu, inv)
    dy = bn_tail_t.bwd_apply(*args, *cols).float()
    want = bn_tail_t.bwd_apply_plain(*args, *cols).float()
    err = (dy - want).abs().max().item()
    scale = want.abs().max().item()
    require(err <= 2.0 ** -8 * scale,
            f"tie case: dy off by {err}, more than one bf16 ulp of {scale}")
    return {"ties": ties, "dy_max_abs_err": err, "dy_max_abs_ref": scale,
            "tolerance": 2.0 ** -8}


def _flash_case(gen, b, h, sq, sk, d, dtype):
    """q, do [b,h,sq,D] and k, v [b,h,sk,D] in dtype, at the kernels' head
    width D: a head dim d below it is zero-padded, as the model pads it."""
    width = 64 if d == 40 else d

    def make(s):
        x = torch.randn((b, h, s, d), generator=gen, device="cuda")
        return F.pad(x, (0, width - d)).to(dtype).contiguous()

    return make(sq), make(sk), make(sk), make(sq)


def _seen(fa, q, k, kw) -> torch.Tensor:
    """[Sq] bool: the queries that see at least one key."""
    sq, sk = q.shape[2], k.shape[2]
    return fa._valid(sq, sk, kw["causal"], kw["kv_len"],
                     kw.get("q_offset", 0), kw.get("kv_offset", 0),
                     q.device).expand(sq, sk).any(-1)


def _compare_out(out, pout, seen, dt_name, what) -> dict:
    """out against the plain out on the rows that see a key; the others
    finite, and exactly 0 when no row sees one (a hop wholly in the
    future: the kernel visits no tile)."""
    require(bool(torch.isfinite(out.float()).all().item()),
            f"{what}: non-finite output")
    if not bool(seen.any().item()):
        require(not bool(out.any().item()),
                f"{what}: a hop wholly in the future must write out 0")
        return {"rows_compared": 0, "zero_out": True}
    rec = compare(out[:, :, seen], pout[:, :, seen], dt_name, what)
    rec["rows_compared"] = int(seen.sum().item())
    return rec


def _check_flash(fa, q, k, v, g, kw, dt_name, what) -> dict:
    """The three flash kernels against their plain versions on the same
    inputs (the backward ones on the kernel's own out and lse); dk/dv and
    dq run twice and must be bitwise equal. The forward's out is held on
    the rows that see a key (``_compare_out``), its lse on every row; where
    no row sees a key, every backward output must be exactly 0."""
    seen = _seen(fa, q, k, kw)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    pout, plse = fa.flash_fwd_plain(q, k, v, **kw)
    rec = {"flash_fwd": _compare_out(out, pout, seen, dt_name, what + " out"),
           "flash_fwd_lse": compare(lse, plse, "fp32", what + " lse")}
    del pout, plse
    if dt_name == "bf16":
        rec.update(_flash_fwd_witness(fa, q, k, v, kw, what, seen))
    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, g, lse, delta)
    if not bool(seen.any().item()):
        outs = (*fa.flash_bwd_dkv(*args, **kw), fa.flash_bwd_dq(*args, **kw))
        require(not any(bool(t.any().item()) for t in outs),
                f"{what}: a hop wholly in the future must give zero "
                "gradients")
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    pdk, pdv = fa.flash_bwd_dkv_plain(*args, **kw)
    rec["flash_bwd_dkv"] = compare(dk, pdk, dt_name, what + " dk")
    rec["flash_bwd_dkv_dv"] = compare(dv, pdv, dt_name, what + " dv")
    del pdk, pdv
    require_repeatable((dk, dv), lambda: fa.flash_bwd_dkv(*args, **kw),
                       what + " dk/dv")
    dq = fa.flash_bwd_dq(*args, **kw)
    rec["flash_bwd_dq"] = compare(dq, fa.flash_bwd_dq_plain(*args, **kw),
                                  dt_name, what + " dq")
    require_repeatable((dq,), lambda: (fa.flash_bwd_dq(*args, **kw),),
                       what + " dq")
    del dk, dv, dq
    if dt_name == "bf16":                 # the precision witness
        f32 = dict(kw, out_dtype=torch.float32)
        dk, dv = fa.flash_bwd_dkv(*args, **f32)
        pdk, pdv = fa.flash_bwd_dkv_plain(*args, **f32)
        rec["flash_bwd_dkv_f32out"] = compare(dk, pdk, "bf16_f32",
                                              what + " dk f32 out")
        rec["flash_bwd_dkv_dv_f32out"] = compare(dv, pdv, "bf16_f32",
                                                 what + " dv f32 out")
        del dk, dv, pdk, pdv
        rec["flash_bwd_dq_f32out"] = compare(
            fa.flash_bwd_dq(*args, **f32), fa.flash_bwd_dq_plain(*args, **f32),
            "bf16_f32", what + " dq f32 out")
    return rec


def _exact_p(x):
    """x's entries beyond one standard deviation as -1 or 1, the rest 0,
    in x's dtype: q.k^T of two such tensors is a sum of integers."""
    xf = x.float()
    return torch.where(xf.abs() > 1.0, torch.sign(xf),
                       torch.zeros_like(xf)).to(x.dtype)


def _flash_fwd_witness(fa, q, k, v, kw, what, seen) -> dict:
    """The forward's float32 out of bfloat16 inputs against the plain
    version's. Both round p to bf16 once before p.v, but from different
    maxima (the kernel's running max over its key tiles, the plain
    version's max over the row), so on random inputs one rounding of p
    may differ by a bf16 ulp (2^-8 of p/l |v|): that comparison is held
    to the bf16 tolerance and reported. The witness proper takes integer scores
    (entries -1, 0, 1 of q and k) at scale ln 2, so every p is a power of
    two, exact in bf16 from either maximum: only the kernel's f32
    arithmetic can differ, and out must come within TOL["bf16_f32"] of
    max|plain| (a bf16-rounded out would be 2^-9 off). Rows that see no
    key as in ``_compare_out``."""
    f32 = dict(kw, out_dtype=torch.float32)
    out, _ = fa.flash_fwd(q, k, v, **f32)
    require(out.dtype == torch.float32, f"{what}: f32 out is {out.dtype}")
    rec = {"flash_fwd_f32_random": _compare_out(
        out, fa.flash_fwd_plain(q, k, v, **f32)[0], seen, "bf16",
        what + " out f32, random inputs")}
    qi, ki = _exact_p(q), _exact_p(k)
    exact = dict(f32, scale=math.log(2.0))
    out, lse = fa.flash_fwd(qi, ki, v, **exact)
    pout, plse = fa.flash_fwd_plain(qi, ki, v, **exact)
    rec["flash_fwd_f32out"] = _compare_out(out, pout, seen, "bf16_f32",
                                           what + " out f32, exact p")
    rec["flash_fwd_lse_exact_p"] = compare(lse, plse, "fp32",
                                           what + " lse, exact p")
    return rec


def _entry(name, source, replaces, rec, ms, plain_ms, library_ms, *,
           flops, bytes_, f32_flops=0.0, peak=PEAK_BF16_FLOPS,
           library_note=None, attrs=None) -> dict:
    b_ms, b_by = bound(flops, bytes_, peak, f32_flops)
    f32out = [v["rel_err"] for k, v in rec.items() if "f32out" in k]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=rec["bf16"]["max_abs_err"], ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, library_note=library_note,
                fp32_rel_err=rec["fp32"]["rel_err"],
                bf16_rel_err=rec["bf16"]["rel_err"],
                bf16_f32out_rel_err=max(f32out) if f32out else None,
                attrs=attrs)


def _attrs_of(fa, kind: str) -> dict:
    """Registers a thread and local memory bytes of the bf16 wgmma
    instances of a flash kind at D 128, by output type, as the CUDA
    runtime reports them for the loaded module."""
    out = {}
    for label, dt in (("bf16 out", torch.bfloat16),
                      ("f32 out", torch.float32)):
        out[label] = fa.kernel_attrs(kind, dt)
        require(out[label]["registers"] > 0,
                f"{kind} {label}: no register count from the runtime")
    return out


def phase_lm_kernels(ce, fa) -> dict:
    """The LM path's four launch kinds at its shapes (B16 H8 S2048 D128
    causal attention, CE over [32768, 32768] logits) against their plain
    versions in fp32 and bf16, and the flash backward's bf16 inputs with
    f32 outputs against the plain f32 outputs (TOL["bf16_f32"]); timed in
    bf16 beside the plain versions and one PyTorch call (SDPA, its
    backward, F.cross_entropy: timed only). The flash backward's bound
    counts its split products (hi + lo, two bf16 products each) as bf16
    work: dk/dv 6 products of P*D multiply-adds, dq 4. Its kernel lines
    carry the registers and local memory (spills included) a thread of
    its D 128 wgmma instances, from cudaFuncGetAttributes."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, s, d = LM_B, LM_H, LM_S, LM_D
    kw = dict(scale=1.0 / math.sqrt(d), causal=True, kv_len=s)
    rec = {k: {} for k in LM_KINDS}
    n, c = LM_B * LM_S, LM_V
    for dt_name, dt in DTYPES:
        case = _flash_case(gen, b, h, s, s, d, dt)
        for key, val in _check_flash(fa, *case, kw, dt_name,
                                     f"flash {dt_name}").items():
            kind = next(k for k in LM_KINDS if key.startswith(k))
            rec[kind][dt_name + key[len(kind):]] = val
        del case
        logits = (3 * torch.randn((n, c), generator=gen, device="cuda")).to(dt)
        labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
        rec["ce_fwd"][dt_name] = compare(ce.ce_rows(logits, labels),
                                         ce.ce_rows_plain(logits, labels),
                                         dt_name, "ce_fwd")
        del logits
        torch.cuda.empty_cache()

    # time in the LM's dtype, bf16
    q, k, v, g = _flash_case(gen, b, h, s, s, d, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, g, lse, delta)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), g, retain_graph=True), reps=5)
    # visible (query, key) pairs of the causal mask; 2 FLOP a product term
    pairs = b * h * s * (s + 1) / 2
    mac = 2.0 * pairs * d
    t_bytes = nbytes(q, k, v)
    entries = {}
    entries["flash_fwd"] = _entry(
        "flash_fwd", FLASH_SRC, "tpu_sandbox/ops/pallas_attention.py:70",
        rec["flash_fwd"], cuda_ms(lambda: fa.flash_fwd(q, k, v, **kw)),
        cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, **kw), reps=3),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True)),
        flops=2 * mac, bytes_=t_bytes + nbytes(out, lse),
        library_note="F.scaled_dot_product_attention(is_causal=True), "
                     "forward", attrs=_attrs_of(fa, "flash_fwd"))
    bwd_note = ("the backward of F.scaled_dot_product_attention: dq, dk and "
                "dv together")
    entries["flash_bwd_dkv"] = _entry(
        "flash_bwd_dkv", FLASH_SRC, "tpu_sandbox/ops/pallas_attention.py:199",
        rec["flash_bwd_dkv"], cuda_ms(lambda: fa.flash_bwd_dkv(*args, **kw)),
        cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args, **kw), reps=3),
        lib_bwd, flops=6 * mac, bytes_=nbytes(*args) + nbytes(k, v),
        library_note=bwd_note, attrs=_attrs_of(fa, "flash_bwd_dkv"))
    entries["flash_bwd_dq"] = _entry(
        "flash_bwd_dq", FLASH_SRC, "tpu_sandbox/ops/pallas_attention.py:262",
        rec["flash_bwd_dq"], cuda_ms(lambda: fa.flash_bwd_dq(*args, **kw)),
        cuda_ms(lambda: fa.flash_bwd_dq_plain(*args, **kw), reps=3),
        lib_bwd, flops=4 * mac, bytes_=nbytes(*args) + nbytes(q),
        library_note=bwd_note, attrs=_attrs_of(fa, "flash_bwd_dq"))
    del q, k, v, g, out, lse, delta, args, qr, kr, vr, o_lib
    torch.cuda.empty_cache()
    logits = (3 * torch.randn((n, c), generator=gen, device="cuda")).to(
        torch.bfloat16)
    labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
    entries["ce_fwd"] = _entry(
        "ce_fwd", CE_SRC, "tpu_sandbox/ops/pallas_ce.py:36", rec["ce_fwd"],
        cuda_ms(lambda: ce.ce_rows(logits, labels)),
        cuda_ms(lambda: ce.ce_rows_plain(logits, labels), reps=3),
        cuda_ms(lambda: F.cross_entropy(logits, labels)),
        # max, subtract, exp and add per logit, f32
        flops=0.0, f32_flops=4.0 * n * c, bytes_=nbytes(logits, labels) + 4 * n,
        library_note="F.cross_entropy on the same bf16 logits (mean)")
    del logits, labels
    torch.cuda.empty_cache()
    for name, e in entries.items():
        emit("kernel", **e, checks=rec[name])
    return entries


def phase_lm_ragged(ce, fa) -> None:
    """The flash kernels at S 200 and 130 (off the 64-row tile), D 32,
    40 (padded) and 64, causal off, non-zero offsets, kv_len short of S, and
    B*H = 1; the CE kernel at N = 1 and at C = 4097 (rows off 16 bytes)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dt_name, dt in DTYPES:
        for b, h, sq, sk, d, causal, qo, ko, kv_len in FLASH_RAGGED:
            what = (f"flash b{b} h{h} sq{sq} sk{sk} d{d} causal{int(causal)} "
                    f"off{qo},{ko} kv{kv_len}")
            kw = dict(scale=1.0 / math.sqrt(d), causal=causal, kv_len=kv_len,
                      q_offset=qo, kv_offset=ko)
            case = _flash_case(gen, b, h, sq, sk, d, dt)
            for key, val in _check_flash(fa, *case, kw, dt_name,
                                         "ragged " + what).items():
                out[f"{what} {key} {dt_name}"] = val
        for n, c in CE_RAGGED:
            x = (3 * torch.randn((n, c), generator=gen, device="cuda")).to(dt)
            lab = torch.randint(0, c, (n,), generator=gen, device="cuda")
            out[f"ce n{n} c{c} {dt_name}"] = compare(
                ce.ce_rows(x, lab), ce.ce_rows_plain(x, lab), dt_name,
                f"ragged ce n{n} c{c}")
    torch.cuda.synchronize()
    emit("lm_ragged", checks=out)


def phase_lm_path(ops, lm_train):
    """lm_train's train function at the LM's bench width, 5 steps, with
    the launch counters zeroed just before and read just after: per step
    the flash kernels once per layer and the CE once, and nothing else."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = lm_train.build_parser().parse_args(LM_FLAGS)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    run = lm_train.train(args)          # raises if the loss did not fall
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.monotonic() - t0
    require(len(run.losses) == STEPS and run.optimizer.count == STEPS,
            f"lm_path logged {len(run.losses)} losses in "
            f"{run.optimizer.count} steps, not {STEPS}")
    require(all(math.isfinite(v) for v in run.losses),
            f"lm_path non-finite loss: {run.losses}")
    want = {k: per_step * STEPS for k, per_step in LM_KINDS.items()}
    require(counts == want, f"lm_path launched {counts}, expected {want}")
    step_ms = statistics.median(run.step_seconds[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    emit("lm_path", flags=LM_FLAGS, losses=run.losses,
         step_ms_each=[t * 1e3 for t in run.step_seconds],
         step_ms_median_after_first=step_ms,
         tokens_per_s=LM_B * LM_S / (step_ms / 1e3),
         peak_memory_bytes=peak,
         parameters=sum(p.numel() for p in run.model.parameters()),
         wall_s_with_init=wall, launches=counts)
    return run, counts, {"losses": run.losses, "step_ms": step_ms,
                         "peak_memory_bytes": peak}


def hop_kind(sq: int, sk: int, q_offset: int, kv_offset: int) -> str:
    """Which pairs of a causal ring hop are visible: ``future`` (every key
    after every query, kv_offset >= q_offset + sq), ``past`` (every key
    before every query, kv_offset + sk <= q_offset) or ``diagonal`` (the
    mask crosses the block)."""
    if kv_offset >= q_offset + sq:
        return "future"
    if kv_offset + sk <= q_offset:
        return "past"
    return "diagonal"


def _plain_hop_fwd(fa, q, k, v, q_off, kv_off):
    """``flash_attention_with_lse``'s hop on the plain forward (blocks of
    whole 128-row tiles at head width 128: no padding)."""
    d = q.shape[3]
    out, lse = fa.flash_fwd_plain(
        *(fa._to_bhsd(x, x.shape[1], d) for x in (q, k, v)),
        scale=1.0 / math.sqrt(d), causal=True, kv_len=k.shape[1],
        q_offset=q_off, kv_offset=kv_off, out_dtype=torch.float32)
    return fa._from_bhsd(out, q.shape[1], d), lse.movedim(1, 2)


def _plain_bwd_lse(fa, q, out, g, lse, q_off):
    """``make_flash_bwd_lse``'s closure on the plain backward (as
    ``_plain_hop_fwd``)."""
    s, d = q.shape[1], q.shape[3]
    qp, gp = fa._to_bhsd(q, s, d), fa._to_bhsd(g, s, d)
    lse_p = lse.movedim(2, 1).contiguous()
    delta = (gp.float() * fa._to_bhsd(out, s, d).float()).sum(-1)

    def hop(k, v, kv_off):
        kp, vp = fa._to_bhsd(k, k.shape[1], d), fa._to_bhsd(v, v.shape[1], d)
        kw = dict(scale=1.0 / math.sqrt(d), causal=True, kv_len=k.shape[1],
                  q_offset=q_off, kv_offset=kv_off, out_dtype=torch.float32)
        dk, dv = fa.flash_bwd_dkv_plain(qp, kp, vp, gp, lse_p, delta, **kw)
        dq = fa.flash_bwd_dq_plain(qp, kp, vp, gp, lse_p, delta, **kw)
        return (fa._from_bhsd(dq, s, d), fa._from_bhsd(dk, k.shape[1], d),
                fa._from_bhsd(dv, k.shape[1], d))

    return hop


def _ring_pass(q, k, v, g, hop_fwd, make_bwd, merge, neg):
    """Flash-ring attention's forward and backward over RING_N ranks in
    one process on [B, S, H, D] tensors, the rotation of k and v replaced
    by indexing: rank r's queries meet block (r - j) mod n at hop j, each
    block's dk and dv add up in the order the ring carries them (hop j's
    share of block b from rank b + j). Returns the merged f32 out, the
    merged lse and the f32 dq, dk, dv of the whole sequence."""
    n, sl = RING_N, q.shape[1] // RING_N

    def blk(x, r):
        return x[:, r * sl:(r + 1) * sl]

    outs, lses, bwds = [], [], []
    for r in range(n):
        o = torch.zeros(blk(q, r).shape, dtype=torch.float32,
                        device=q.device)
        lse = torch.full(o.shape[:3], neg, dtype=torch.float32,
                         device=q.device)
        for j in range(n):
            src = (r - j) % n
            o, lse = merge(o, lse, *hop_fwd(blk(q, r), blk(k, src),
                                            blk(v, src), r * sl, src * sl))
        outs.append(o)
        lses.append(lse)
        bwds.append(make_bwd(blk(q, r), o.to(q.dtype), blk(g, r), lse,
                             r * sl))
    dq = [torch.zeros_like(o) for o in outs]
    dk = [torch.zeros_like(o) for o in outs]
    dv = [torch.zeros_like(o) for o in outs]
    for j in range(n):
        for r in range(n):
            src = (r - j) % n
            dq_c, dk_c, dv_c = bwds[r](blk(k, src), blk(v, src), src * sl)
            dq[r] += dq_c
            dk[src] += dk_c
            dv[src] += dv_c
    return tuple(torch.cat(x, 1) for x in (outs, lses, dq, dk, dv))


def phase_ring_kernels(ops, fa) -> tuple[dict, dict]:
    """Flash-ring attention at the LM's shapes (B16 H8 S2048 D128, bf16,
    causal) over RING_N = 4 shards of 512 tokens, simulated in one process
    (``_ring_pass``): the forward merges 4 hops of
    ``flash_attention_with_lse`` a rank, the backward adds 4 calls of
    ``make_flash_bwd_lse``'s closure a rank, on the kernels. out, dq, dk
    and dv against the same ring on the plain versions and against the
    single-device flash kernels on the whole sequence (f32 outputs), each
    within 1e-2 of max|ref| (the bf16 rule); a hop wholly in the future
    must give out 0, lse NEG and zero gradients; two passes bitwise equal.
    Each hop kind's CUDA-event ms (rank 2's hops: diagonal, past, future;
    and the whole sequence as one diagonal hop, path_sp's hop at one
    rank), also back to back and as device time (torch.profiler), beside
    its bound from that hop's visible pairs (forward 4 P D, the closure's
    dk/dv and dq 20 P D bf16 FLOP, as rows 11-13); the hops summed over a
    pass beside the full-sequence kernels timed here. The hops of one pass
    are counted (fa.HOPS, by function; each hop's kind follows from the
    offsets the ring gives it, ``hop_kind``). The phase's seconds in its
    three parts: the checks, the hop kinds' timings, the pass and the
    full-sequence kernels' timings."""
    from tpu_sandbox_torch.parallel.flash_ring import merge

    gen = torch.Generator(device="cuda").manual_seed(6)
    b, h, s, d = LM_B, LM_H, LM_S, LM_D
    n, sl = RING_N, LM_S // RING_N
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))

    def kernels():
        return _ring_pass(q, k, v, g, lambda *a: fa.flash_attention_with_lse(
            a[0], a[1], a[2], causal=True, q_offset=a[3], kv_offset=a[4]),
            lambda *a: fa.make_flash_bwd_lse(*a[:4], causal=True,
                                             q_offset=a[4]), merge, fa.NEG)

    t0 = time.monotonic()
    ops.reset_launch_counts()
    fa.HOPS.clear()
    got = kernels()
    torch.cuda.synchronize()
    hops = dict(fa.HOPS)
    want = {f: n * n for f in ("flash_fwd_lse", "flash_bwd_lse")}
    require(hops == want, f"ring_kernels ran hops {hops}, expected {want}")
    # rank r meets block (r - j) mod n at hop j, once each way
    hop_kinds = Counter(hop_kind(sl, sl, r * sl, (r - j) % n * sl)
                        for r in range(n) for j in range(n))
    counts = {**ops.launch_counts(),
              **{f"{f} {kind} S{sl}": c for f in want
                 for kind, c in hop_kinds.items()}}
    plain = _ring_pass(q, k, v, g, lambda *a: _plain_hop_fwd(fa, *a),
                       lambda *a: _plain_bwd_lse(fa, *a), merge, fa.NEG)
    names = ("out", "lse", "dq", "dk", "dv")
    checks = {"vs_plain_ring": {
        x: compare(a, w, "bf16" if x != "lse" else "fp32", f"ring {x} "
                   "vs the plain ring") for x, a, w in zip(names, got, plain)}}
    del plain
    # the single-device kernels on the whole sequence, f32 outputs
    full = [t.movedim(2, 1).contiguous() for t in (q, k, v, g)]
    kw = dict(scale=1.0 / math.sqrt(d), causal=True, kv_len=s)
    f32 = dict(kw, out_dtype=torch.float32)
    out, lse = fa.flash_fwd(*full[:3], **f32)
    delta = (full[3].float() * out.to(torch.bfloat16).float()).sum(-1)
    bargs = (*full, lse, delta)
    ref = (out, lse, fa.flash_bwd_dq(*bargs, **f32),
           *fa.flash_bwd_dkv(*bargs, **f32))
    checks["vs_full_sequence"] = {
        x: compare(a, w.movedim(1, 2), "bf16" if x != "lse" else "fp32",
                   f"ring {x} vs the full-sequence kernels")
        for x, a, w in zip(names, got, ref)}
    again = kernels()
    bitwise = all(torch.equal(a, b_) for a, b_ in zip(got, again))
    require(bitwise, "ring_kernels: two passes differ")
    del ref, again, out, lse, delta, bargs
    seconds = {"checks": time.monotonic() - t0}

    # rank 2's hops on 512-token blocks: its own block (diagonal), block 0
    # (past) and block 3 (future); and the one hop a layer of path_sp at
    # one rank, the whole sequence (diagonal): (q, g, out, lse, q offset,
    # k/v block, kv offset, visible pairs, hops of the kind in a pass)
    def rows(x, r):
        return x[:, r * sl:(r + 1) * sl]

    mine = (rows(q, 2), rows(g, 2), rows(got[0], 2).to(torch.bfloat16),
            rows(got[1], 2), 2 * sl)
    whole = (q, g, got[0].to(torch.bfloat16), got[1], 0)
    kinds = {
        f"diagonal S{sl}": (*mine, 2, b * h * sl * (sl + 1) / 2,
                            hop_kinds["diagonal"]),
        f"past S{sl}": (*mine, 0, b * h * sl * sl, hop_kinds["past"]),
        f"future S{sl}": (*mine, 3, 0.0, hop_kinds["future"]),
        f"diagonal S{s}": (*whole, None, b * h * s * (s + 1) / 2, 0)}
    entries, timing = {}, {}
    for kind, (qr, gr, out_r, lse_r, q_off, src, pairs, per_pass) in (
            kinds.items()):
        kb, vb = (k, v) if src is None else (rows(k, src), rows(v, src))
        kv_off = 0 if src is None else src * sl
        args = (qr, kb, vb, q_off, kv_off)
        library = (_sdpa_hop(qr, kb, vb, gr, kind.startswith("diagonal"))
                   if pairs else None)
        bwd = fa.make_flash_bwd_lse(qr, out_r, gr, lse_r, causal=True,
                                    q_offset=q_off)
        pbwd = _plain_bwd_lse(fa, qr, out_r, gr, lse_r, q_off)
        fwd = lambda: fa.flash_attention_with_lse(  # noqa: E731
            *args[:3], causal=True, q_offset=args[3], kv_offset=args[4])
        o_b, lse_b = fwd()
        po, plse = _plain_hop_fwd(fa, *args)
        grads = bwd(kb, vb, kv_off)
        pgrads = pbwd(kb, vb, kv_off)
        if kind.startswith("future"):
            require(not bool(o_b.any().item()) and bool(
                (lse_b == torch.tensor(fa.NEG, dtype=torch.float32)).all()),
                "ring_kernels: a future hop's out is not 0 or its lse not "
                "NEG")
            require(not any(bool(t.any().item()) for t in grads),
                    "ring_kernels: a future hop's gradients are not 0")
            f_rec = {"max_abs_err": 0.0, "rel_err": 0.0, "zero_out": True}
        else:
            f_rec = compare(o_b, po, "bf16", f"ring {kind} hop out")
        b_recs = [compare(a, w, "bf16", f"ring {kind} hop d{x}")
                  for x, a, w in zip("qkv", grads, pgrads)]
        del po, plse, pgrads
        bwd_fn = lambda: bwd(kb, vb, kv_off)  # noqa: E731
        # a hop with no visible pair needs none of its inputs: its bytes
        # are its outputs alone (out 0 and lse NEG; zero dq, dk, dv)
        fwd_in = nbytes(qr, kb, vb) if pairs else 0
        bwd_in = fwd_in + nbytes(gr, lse_r, lse_r) if pairs else 0
        for fn_name, fn, plain_fn, rec, flops, bytes_, replaces in (
                ("flash_fwd_lse", fwd, lambda: _plain_hop_fwd(fa, *args),
                 [f_rec], 4 * pairs * d, fwd_in + nbytes(o_b, lse_b),
                 "tpu_sandbox/ops/pallas_attention.py:493"),
                ("flash_bwd_lse", bwd_fn, lambda: pbwd(kb, vb, kv_off),
                 b_recs, 20 * pairs * d, bwd_in + nbytes(*grads),
                 "tpu_sandbox/ops/pallas_attention.py:533")):
            ms = cuda_ms(fn)
            b_ms, b_by = bound(flops, bytes_)
            name = f"{fn_name} {kind}"
            lib_fn = library and library[fn_name == "flash_bwd_lse"]
            entries[name] = dict(
                name=name, route="cuda", source=FLASH_SRC, replaces=replaces,
                max_abs_err=max(x["max_abs_err"] for x in rec), ms=ms,
                plain_ms=cuda_ms(plain_fn, reps=3), bound_ms=b_ms,
                bound_by=b_by,
                library_ms=cuda_ms(lib_fn) if lib_fn else None,
                library_note=SDPA_NOTE[fn_name] if lib_fn else
                "no call: the hop is wholly masked (no visible pair)",
                fp32_rel_err=None,
                bf16_rel_err=max(x["rel_err"] for x in rec),
                bf16_f32out_rel_err=None, attrs=None,
                ms_back_to_back=back_to_back_ms(fn), device_ms=device_ms(fn))
            timing[name] = {k: entries[name][k] for k in (
                "ms", "ms_back_to_back", "device_ms", "bound_ms")}
            timing[name].update(pairs=pairs, per_pass=per_pass)
        del o_b, lse_b, grads, bwd, pbwd, library
        torch.cuda.empty_cache()
    seconds["hop_timings"] = time.monotonic() - t0 - seconds["checks"]
    out, lse = fa.flash_fwd(*full[:3], **kw)
    delta = (full[3].float() * out.float()).sum(-1)
    bargs = (*full, lse, delta)
    full_fns = {"flash_fwd": lambda: fa.flash_fwd(*full[:3], **kw),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*bargs, **kw),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bargs, **kw)}
    full_ms = {k: cuda_ms(f) for k, f in full_fns.items()}
    full_dev = {k: device_ms(f) for k, f in full_fns.items()}
    hops_ms = sum(t["ms"] * t["per_pass"] for t in timing.values())
    hops_dev = sum(t["device_ms"] * t["per_pass"] for t in timing.values())
    pass_ms = cuda_ms(kernels, reps=3, warmup=1)
    pass_dev = device_ms(kernels, calls=2)
    seconds["pass_and_full_sequence_timings"] = (
        time.monotonic() - t0 - sum(seconds.values()))
    emit("ring_kernels", shards=n, shard_len=sl, checks=checks,
         bitwise_repeatable=bitwise, hops=timing, launches=counts,
         ring_hops_ms_sum=hops_ms, ring_hops_device_ms_sum=hops_dev,
         ring_pass_ms=pass_ms, ring_pass_device_ms=pass_dev,
         full_sequence_ms=full_ms, full_sequence_device_ms=full_dev,
         hops_over_full=hops_ms / sum(full_ms.values()),
         hops_device_over_full_device=hops_dev / sum(full_dev.values()),
         seconds=seconds)
    for e in entries.values():
        emit("kernel", **e)
    del q, k, v, g, full, got, out, lse, delta, bargs
    torch.cuda.empty_cache()
    return entries, counts


#: what the library times of the ring's hop lines are
SDPA_NOTE = {
    "flash_fwd_lse": "torch.ops.aten._scaled_dot_product_flash_attention "
                     "on the hop's q and k/v block ([B, H, S, D], bf16: out "
                     "and logsumexp), causal on a diagonal hop",
    "flash_bwd_lse": "torch.ops.aten._scaled_dot_product_flash_attention_"
                     "backward against that call's out and logsumexp: dq, "
                     "dk and dv of the hop"}


def _sdpa_hop(q, k, v, g, causal: bool):
    """(forward, backward) closures of aten's flash attention on one hop's
    blocks [B, S, H, D] (moved to [B, H, S, D] first, untimed): the
    library's call computing the hop's out and logsumexp, and its backward
    against them. Timed only, never used by the port."""
    q, k, v, g = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd_op = torch.ops.aten._scaled_dot_product_flash_attention
    bwd_op = torch.ops.aten._scaled_dot_product_flash_attention_backward
    out, lse, cq, ck, mq, mk, seed, offset, _ = fwd_op(
        q, k, v, 0.0, causal, scale=scale)
    return (lambda: fwd_op(q, k, v, 0.0, causal, scale=scale),
            lambda: bwd_op(g, q, k, v, out, lse, cq, ck, mq, mk, 0.0, causal,
                           seed, offset, scale=scale))


def phase_path_sp(ops, fa, lm_train, lm_ref: dict) -> dict:
    """SeqParallel over a one-rank {"data": 1, "sp": 1} mesh (NCCL, in
    this process) at the LM's bench width, SP_STEPS Adam steps through
    lm_train.fit_sp, once per SP_SCHEMES, the counters zeroed just before
    and read just after: LM_KINDS a step and nothing else, and with
    flash_ring 12 forward hops and 12 calls of make_flash_bwd_lse's closure
    a step (fa.HOPS), all diagonal at one rank. Losses against lm_path's first
    SP_STEPS from the same seed and batches within SP_LOSS_RTOL (the same
    function; bf16), step ms, tokens/s and peak memory beside lm_path's."""
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.runtime.mesh import make_mesh

    counts = {}
    bootstrap.init(device="cuda")
    try:
        mesh = make_mesh({"data": 1, "sp": 1})
        for attn in SP_SCHEMES:
            args = lm_train.build_parser().parse_args(
                [*LM_FLAGS, "--parallelism", "sp", "--attn", attn,
                 "--steps", str(SP_STEPS)])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            fa.HOPS.clear()
            t0 = time.monotonic()
            run = lm_train.fit_sp(args, mesh, torch.device("cuda"))
            torch.cuda.synchronize()
            launches, hops = ops.launch_counts(), dict(fa.HOPS)
            wall = time.monotonic() - t0
            phase = f"path_sp_{attn}"
            want = {k: per_step * SP_STEPS for k, per_step in LM_KINDS.items()}
            require(launches == want,
                    f"{phase} launched {launches}, expected {want}")
            want_hops = ({f: LM_KINDS["flash_fwd"] * SP_STEPS
                          for f in ("flash_fwd_lse", "flash_bwd_lse")}
                         if attn == "flash_ring" else {})
            require(hops == want_hops,
                    f"{phase} ran hops {hops}, expected {want_hops}")
            require(len(run.losses) == SP_STEPS
                    and all(math.isfinite(x) for x in run.losses),
                    f"{phase} losses {run.losses}")
            ref = lm_ref["losses"][:SP_STEPS]
            dev = max(abs(a - w) / abs(w) for a, w in zip(run.losses, ref))
            require(dev <= SP_LOSS_RTOL,
                    f"{phase} losses {run.losses} against lm_path's {ref}")
            step_ms = statistics.median(run.step_seconds[1:]) * 1e3
            emit(phase, attn=attn, mesh={"data": 1, "sp": 1},
                 backend=bootstrap.backend_name(), flags=args.__dict__,
                 losses=run.losses, lm_path_losses=ref,
                 max_rel_dev_from_lm_path=dev, loss_rtol=SP_LOSS_RTOL,
                 bitwise_lm_path=run.losses == ref,
                 step_ms_each=[t * 1e3 for t in run.step_seconds],
                 step_ms_median_after_first=step_ms,
                 tokens_per_s=LM_B * LM_S / (step_ms / 1e3),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 lm_path_step_ms_median_after_first=lm_ref["step_ms"],
                 lm_path_peak_memory_bytes=lm_ref["peak_memory_bytes"],
                 wall_s_with_init=wall, launches=launches, hops=hops)
            kind = hop_kind(LM_S, LM_S, 0, 0)   # the whole sequence
            counts[phase] = {**launches, **{f"{f} {kind} S{LM_S}": c
                                            for f, c in hops.items()}}
            del run
    finally:
        bootstrap.cleanup()
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def per_step_allocator(optimizer_cls):
    """Per training step (each ``optimizer_cls.step`` ends one): the
    allocator's cudaMalloc calls and retries and the Python collections
    of the oldest generation in it, the first step's with what ran before
    it in the block (the model's set-up). Yields the list, filled when
    the block ends."""
    import gc

    def sample():
        m = torch.cuda.memory_stats()
        return (m.get("segment.all.allocated", 0),
                m.get("num_alloc_retries", 0),
                gc.get_stats()[2]["collections"])

    marks, per_step, step = [sample()], [], optimizer_cls.step

    def sampled(self):
        step(self)
        marks.append(sample())

    optimizer_cls.step = sampled
    try:
        yield per_step
    finally:
        optimizer_cls.step = step
        per_step.extend([b - a for a, b in zip(prev, cur)]
                        for prev, cur in zip(marks, marks[1:]))


def phase_lm_paths(ops, fa, lm_train, lm_ref: dict) -> dict:
    """Each of LM_PATHS at the LM's bench width, LM_PATH_STEPS Adam steps,
    the counters zeroed just before and read just after: exactly its
    launches and ring hops a step; losses against lm_path's within
    SP_LOSS_RTOL where the path computes its function (with microbatches,
    the mean of their means; tp at one rank), within DP_INT8_LOSS_RTOL
    under the int8 exchange, finite and falling where it computes another
    (ep: the MoE LM); step ms (median, min and max after the
    first), tokens/s and peak memory beside lm_path's, and each step's
    cudaMalloc calls, allocator retries and oldest-generation
    collections. A mesh path runs fit_pp, or fit_pjit for dp, tp and
    ep."""
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.runtime.mesh import make_mesh
    from tpu_sandbox_torch.train.optim import Adam

    counts, n = {}, LM_PATH_STEPS
    for phase, flags, mesh, kinds, hops_a_step, rtol in LM_PATHS:
        with timed(phase):
            args = lm_train.build_parser().parse_args(
                [*LM_FLAGS, *flags, "--steps", str(n)])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            fa.HOPS.clear()
            t0 = time.monotonic()
            with per_step_allocator(Adam) as per_step:
                if mesh is None:
                    run = lm_train.train(args)
                else:
                    fit = (lm_train.fit_pjit
                           if args.parallelism in lm_train.PJIT_RULES
                           else lm_train.fit_pp)
                    bootstrap.init(device="cuda")
                    try:
                        run = fit(args, make_mesh(mesh),
                                  torch.device("cuda"))
                    finally:
                        bootstrap.cleanup()
            torch.cuda.synchronize()
            launches, hops = ops.launch_counts(), dict(fa.HOPS)
            wall = time.monotonic() - t0
            want = {k: c * n for k, c in kinds.items()}
            require(launches == want,
                    f"{phase} launched {launches}, expected {want}")
            want_hops = {k: c * n for k, c in hops_a_step.items()}
            require(hops == want_hops,
                    f"{phase} ran hops {hops}, expected {want_hops}")
            require(len(run.losses) == n and run.optimizer.count == n
                    and len(per_step) == n
                    and all(math.isfinite(x) for x in run.losses),
                    f"{phase} losses {run.losses} in "
                    f"{run.optimizer.count} steps")
            ref = lm_ref["losses"][:n]
            dev = max(abs(a - w) / abs(w) for a, w in zip(run.losses, ref))
            # fit itself exits when the loss did not fall
            require(rtol is None or dev <= rtol,
                    f"{phase} losses {run.losses} against lm_path's {ref}")
            timed_ms = [t * 1e3 for t in run.step_seconds[1:]]
            step_ms = statistics.median(timed_ms)
            emit(phase, flags=flags, mesh=mesh, losses=run.losses,
                 lm_path_losses=ref,
                 lm_path_function=rtol == SP_LOSS_RTOL,
                 max_rel_dev_from_lm_path=dev, loss_rtol=rtol,
                 bitwise_lm_path=run.losses == ref,
                 step_ms_each=[t * 1e3 for t in run.step_seconds],
                 step_ms_median_after_first=step_ms,
                 step_ms_min_after_first=min(timed_ms),
                 step_ms_max_after_first=max(timed_ms),
                 cuda_mallocs_each=[c[0] for c in per_step],
                 alloc_retries_each=[c[1] for c in per_step],
                 gen2_collections_each=[c[2] for c in per_step],
                 tokens_per_s=LM_B * LM_S / (step_ms / 1e3),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 lm_path_step_ms_median_after_first=lm_ref["step_ms"],
                 lm_path_peak_memory_bytes=lm_ref["peak_memory_bytes"],
                 parameters=sum(p.numel() for p in run.model.parameters()),
                 wall_s_with_init=wall, launches=launches, hops=hops)
            kind = hop_kind(LM_S, LM_S, 0, 0)   # the whole sequence
            counts[phase] = {**launches, **{f"{f} {kind} S{LM_S}": c
                                            for f, c in hops.items()}}
            del run
            torch.cuda.empty_cache()
    return counts


def _entry_runs(runs: dict, limit: float, root: Path) -> dict:
    """``python -m`` with each of ``runs``' module and argv at once, under
    one time limit: name -> (exit code, stdout, stderr, seconds)."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv],
        cwd=root, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, argv in runs.items()}
    out, t0 = {}, time.monotonic()
    try:
        for name, p in procs.items():
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, limit - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                require(False, f"{name} ran past {limit} s")
            out[name] = (p.returncode, stdout, stderr,
                         time.monotonic() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _two_gpu_ranks_refused(what: str, res) -> dict:
    """Two GPU ranks without --force-cpu on this machine: a non-zero exit
    naming the 2 GPU ranks and the card count."""
    rc, _, stderr, _ = res
    cards = torch.cuda.device_count()
    named = ("2 GPU ranks" in stderr
             and f"machine with {cards} GPU(s)" in stderr)
    require(rc != 0 and named,
            f"{what}: 2 GPU ranks on {cards} card(s) gave exit {rc}, "
            f"stderr {stderr[-2000:]}")
    return {"exit": rc, "stderr": stderr.strip()[-300:]}


def phase_entry_refusals() -> None:
    """``python -m tpu_sandbox_torch.lm_train --parallelism p --devices 2``
    without --force-cpu for each plan that spawns ranks (ENTRY_REFUSALS:
    dp, tp, ep, sp, pp) and ``mnist_distributed --elastic --agents 2 -g
    2``, all at once under ENTRY_LIMIT: each exits non-zero naming the 2
    GPU ranks and the card count, the agents' before any agent starts (no
    rank falls back to the CPU or to a smaller world). Their gloo runs are
    CPU tests (tests/test_torch_lm_train.py,
    tests/test_torch_agents_entry.py)."""
    out = _entry_runs(ENTRY_REFUSALS, ENTRY_LIMIT,
                      Path(__file__).resolve().parent)
    refused = {name: _two_gpu_ranks_refused(f"entry_refusals {name}", res)
               for name, res in out.items()}
    require("[launcher]" not in out["agents"][1],
            f"entry_refusals agents: an agent started: {out['agents'][1]}")
    emit("entry_refusals", runs=ENTRY_REFUSALS, refused=refused,
         seconds={k: v[3] for k, v in out.items()})


def phase_main_path(ops, mnist_onegpu, expected: list[str], *, phase: str,
                    plan: str, steps: int, model_options: dict | None = None,
                    flags: list[str] | None = None):
    """mnist_onegpu's train function at 3000x3000 with ``--plan plan``
    (and ``flags``) and the launch counters zeroed just before and read
    just after: every expected launch once per step (``--accum-steps k``:
    k times), and no other."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = mnist_onegpu.build_parser().parse_args([
        "--plan", plan, "--image-size", str(IMAGE), "--batch-size", str(BATCH),
        "--dtype", "bf16", "--synthetic-n", str(steps * BATCH),
        "--limit-steps", str(steps), "--epochs", "1", "--log-every", "1",
        *(flags or [])])
    per_step = args.accum_steps
    ops.reset_launch_counts()
    t0 = time.monotonic()
    trainer, state = mnist_onegpu.train(args, model_options=model_options)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.monotonic() - t0
    require(len(trainer.losses) == steps,
            f"{phase} logged {len(trainer.losses)} losses, not {steps}")
    require(all(math.isfinite(v) for v in trainer.losses),
            f"{phase} non-finite loss: {trainer.losses}")
    require(state.step == steps, f"{phase} took {state.step} steps")
    for key in expected:
        require(counts.get(key, 0) == steps * per_step,
                f"{phase} launched {key} {counts.get(key, 0)} times in "
                f"{steps} steps, expected {per_step} per step")
    require(set(counts) == set(expected),
            f"unexpected launches on {phase}: {counts}")
    step_ms = statistics.median(trainer.step_seconds[1:]) * 1e3
    model = state.model
    res = dict(image=IMAGE, batch=BATCH, dtype="bf16", steps=steps,
               plan=plan, model=type(model).__name__,
               plan_options=model_options or {}, flags=flags or [],
               accum_steps=per_step, use_bn=model.use_bn,
               fused_tail=getattr(model, "fused_tail", None),
               fused_conv=getattr(model, "fused_conv", None),
               sparse_conv1=getattr(model, "sparse_conv1", None),
               fused_conv1_bwd=getattr(model, "fused_conv1_bwd", None),
               losses=trainer.losses,
               step_ms_each=[s * 1e3 for s in trainer.step_seconds],
               step_ms_median_after_first=step_ms,
               images_per_s=BATCH / (step_ms / 1e3),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               wall_s_with_init=wall, launches=counts)
    return res, counts, trainer


def phase_dist_bootstrap() -> None:
    """bootstrap.init at world size 1 on the card: the NCCL backend, every
    collective of CollectiveGroup on CUDA tensors with its values checked
    (at one rank each returns its input), the all-reduce bandwidth bench
    at 64 MiB (busbw is 0 at one rank by NCCL-tests' formula), cleanup."""
    from tpu_sandbox_torch.parallel.collectives import world_group
    from tpu_sandbox_torch.runtime import bootstrap

    topo = bootstrap.init(device="cuda")
    try:
        require(bootstrap.backend_name() == "nccl",
                f"dist_bootstrap backend {bootstrap.backend_name()}")
        g = world_group()
        x = torch.tensor([[3.0, -1.5, 2.0, 0.25]], device="cuda")
        n = torch.tensor([[7, -2]], dtype=torch.int32, device="cuda")
        checks = {}
        for op in ("sum", "mean", "max", "min"):
            for name, t in (("f32", x), ("i32", n)):
                y = g.all_reduce(t, op)
                want = t / 1 if op == "mean" else t
                checks[f"all_reduce_{op}_{name}"] = (
                    y.is_cuda and y.dtype == want.dtype
                    and torch.equal(y, want))
        checks["all_gather"] = torch.equal(g.all_gather(x), x)
        checks["broadcast"] = torch.equal(g.broadcast(x, 0), x)
        checks["reduce_scatter"] = torch.equal(g.reduce_scatter(x), x)
        checks["shift"] = torch.equal(g.shift(x, 1), x)
        checks["all_to_all"] = torch.equal(g.all_to_all(x), x)
        g.barrier()
        checks["barrier"] = True
        require(all(checks.values()), f"dist_bootstrap checks {checks}")
        bw = g.allreduce_bandwidth(1 << 26)
        emit("dist_bootstrap", topology=topo.summary(),
             backend=bootstrap.backend_name(), checks=checks, bandwidth=bw)
    finally:
        bootstrap.cleanup()
    require(not bootstrap.is_initialized(), "dist_bootstrap: no cleanup")


def phase_dist_scripts() -> None:
    """The three-script surface beside mnist_distributed: test_init and
    allreduce_toy on the card (NCCL, world size 1) and as four gloo ranks
    on the CPU, all four commands at once, each with a time limit; each
    must exit 0 and print the reference's lines, and the toy's printed
    sums must agree between ranks 0 and 1 (each rank also checks its sum
    against an all-gather of every value)."""
    root = Path(__file__).resolve().parent
    procs = {name: (subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE), limit)
        for name, argv, limit in DIST_SCRIPTS}
    out, seconds = {}, {}
    t0 = time.monotonic()
    try:
        for name, (p, limit) in procs.items():
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, limit - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                require(False, f"dist_scripts: {name} ran past {limit} s")
            require(p.returncode == 0,
                    f"dist_scripts: {name} exit {p.returncode}: "
                    f"{stderr[-2000:]}")
            out[name] = stdout.splitlines()
            seconds[name] = time.monotonic() - t0
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, world, backend in (("test_init_nccl", 1, "nccl"),
                                 ("test_init_gloo4", 4, "gloo")):
        lines = out[name]
        total = world * (world + 1) / 2
        require(lines[-1] == "successful test_setup!"
                and lines.count(f"backend='{backend}'") == world
                and all(f"rank {r}: all_reduce check {total} == {total}"
                        in lines for r in range(world)),
                f"dist_scripts: {name} printed {lines}")
    pat = re.compile(r"^rank: (\d), step: (\d+), value: (\d), "
                     r"reduced sum: (\d+)\.$")
    sums = {}
    for name, world in (("allreduce_toy_nccl", 1), ("allreduce_toy_gloo4", 4)):
        rows = [pat.match(line) for line in out[name]
                if line.startswith("rank: ")]
        require(all(rows) and len(rows) == 3 * min(2, world),
                f"dist_scripts: {name} printed {out[name]}")
        by_step: dict = {}
        for m in rows:
            by_step.setdefault(int(m[2]), {})[int(m[1])] = (int(m[3]),
                                                            int(m[4]))
        for step, seen in by_step.items():
            values = [v for v, _ in seen.values()]
            totals = {t for _, t in seen.values()}
            require(len(totals) == 1, f"{name} step {step}: {seen}")
            total = totals.pop()
            # rank 0 and 1's values are printed; the other ranks' add 0-9
            require(sum(values) <= total <= sum(values) + 9 * (world - 2)
                    if world > 2 else total == sum(values),
                    f"{name} step {step}: {seen}")
        sums[name] = by_step
    emit("dist_scripts", seconds=seconds,
         lines={k: v for k, v in out.items()}, toy_steps=sums)


def _dp_run(ops, mnist_distributed, expected: list[str], phase: str,
            flags: list[str] = ()):
    """mnist_distributed's train at -g 1 with path_dp's arguments and
    ``flags``, the launch counters zeroed just before and read just
    after: the main path's kinds once a step and no other, the rank-0
    log lines, finite losses. Returns (result, counts, trainer, state,
    args)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["-g", "1", "--plan", "auto", "--image-size", str(IMAGE),
            "--batch-size", str(BATCH), "--dtype", "bf16",
            "--synthetic-n", str(DP_STEPS * BATCH), "--limit-steps",
            str(DP_STEPS), "--epochs", "1", "--log-every", "1", *flags]
    args = mnist_distributed.build_parser().parse_args(argv)
    log = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(log):
        trainer, state = mnist_distributed.train(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    lines = log.getvalue().splitlines()
    print(log.getvalue(), end="", flush=True)
    for key in expected:
        require(counts.get(key, 0) == DP_STEPS,
                f"{phase} launched {key} {counts.get(key, 0)} times in "
                f"{DP_STEPS} steps")
    require(set(counts) == set(expected),
            f"unexpected launches on {phase}: {counts}")
    want_lines = [f"Rank [0], Epoch [1/1], Step [{s}/{DP_STEPS}], Loss: "
                  f"{loss:.4f}" for s, loss in zip(range(1, DP_STEPS + 1),
                                                   trainer.losses)]
    require([ln for ln in lines if ln.startswith("Rank [")] == want_lines
            and lines[-1].startswith("Training complete in: "),
            f"{phase} log lines {lines}")
    require(len(trainer.losses) == DP_STEPS
            and all(math.isfinite(v) for v in trainer.losses),
            f"{phase} non-finite loss {trainer.losses}")
    step_ms = statistics.median(trainer.step_seconds[1:]) * 1e3
    model = state.model
    res = dict(image=IMAGE, batch=BATCH, dtype="bf16", steps=DP_STEPS,
               world_size=1, backend="nccl", model=type(model).__name__,
               flags=list(flags),
               fused_tail=getattr(model, "fused_tail", None),
               sparse_conv1=getattr(model, "sparse_conv1", None),
               fused_conv1_bwd=getattr(model, "fused_conv1_bwd", None),
               losses=trainer.losses,
               step_ms_each=[t * 1e3 for t in trainer.step_seconds],
               step_ms_median_after_first=step_ms,
               images_per_s=BATCH / (step_ms / 1e3),
               peak_memory_bytes=peak, wall_s_with_init=wall,
               launches=counts, log_lines=want_lines)
    return res, counts, trainer, state, args


def phase_path_dp(ops, mnist_distributed, expected: list[str]):
    """mnist_distributed -g 1 at 3000x3000, batch 5, bf16, the card's
    default plan, DP_STEPS steps, in this process (NCCL, one rank), the
    launch counters zeroed just before and read just after: the main
    path's kinds once a step and no other; step time, images/s, peak
    memory and the rank-0 log line. Then the same model from the same seed
    through DataParallel and, beside it, through the single-device trainer
    (make_train_step) on the same batches for DP_BITWISE_STEPS steps:
    losses and every parameter and BN statistic bitwise equal."""
    res, counts, trainer, state, args = _dp_run(ops, mnist_distributed,
                                                expected, "path_dp")
    del res["flags"]
    del trainer, state
    torch.cuda.empty_cache()
    res["bitwise_vs_single_device"] = _dp_bitwise(mnist_distributed, args)
    return res, counts


def phase_path_dp_ext(ops, mnist_distributed, expected: list[str],
                      dp_res: dict) -> dict:
    """Each of DP_EXT_MODES through _dp_run: the main path's kinds once a
    step, finite losses, the DP_EXT_BITWISE pairs bit for bit (losses,
    and with a mode's run every parameter and BN statistic); step time
    beside path_dp's of this run. Returns the counts by phase."""
    import gc

    counts, kept = {}, {}
    for mode, flags in DP_EXT_MODES:
        phase = f"path_dp_ext_{mode}"
        with timed(phase):
            res, counts[phase], trainer, state, _ = _dp_run(
                ops, mnist_distributed, expected, phase, flags)
            if mode in DP_EXT_BITWISE.values():     # kept on the host
                kept[mode] = (list(trainer.losses),
                              {k: v.detach().cpu() for k, v in
                               state.model.state_dict().items()})
            if mode in DP_EXT_BITWISE:
                other = DP_EXT_BITWISE[mode]
                if other is None:
                    same = trainer.losses == dp_res["losses"]
                    differ = []
                else:
                    losses, sd = kept.pop(other)
                    differ = [k for k, v in state.model.state_dict().items()
                              if not torch.equal(sd[k], v.cpu())]
                    same = trainer.losses == losses and not differ
                    del sd
                require(same, f"{phase} is not {other or 'path_dp'}'s run "
                        f"bit for bit: losses {trainer.losses}, state "
                        f"entries differing {differ}")
                res["bitwise_vs"] = other or "path_dp"
            dp_ms = dp_res["step_ms_median_after_first"]
            res["path_dp_step_ms_median_after_first"] = dp_ms
            res["extra_ms_over_path_dp"] = (res["step_ms_median_after_first"]
                                            - dp_ms)
            res["residual_leaves"] = (None if state.grad_residual is None
                                      else len(state.grad_residual))
            emit(phase, **res)
            del trainer, state
            gc.collect()
            torch.cuda.empty_cache()
    return counts


def _dp_bitwise(mnist_distributed, args) -> dict:
    """DataParallel at one rank against make_train_step: the same seed,
    the same batches, DP_BITWISE_STEPS steps; everything bitwise."""
    from tpu_sandbox_torch.data import ShardedBatchLoader
    from tpu_sandbox_torch.models import pick_convnet
    from tpu_sandbox_torch.parallel.data_parallel import DataParallel
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.train import TrainState, make_train_step
    from tpu_sandbox_torch.train.trainer import to_device

    shape = (IMAGE, IMAGE)
    images, labels = mnist_distributed.load_training_arrays(args, 1,
                                                            verbose=False)
    batches = list(ShardedBatchLoader(images, labels, BATCH, 1, rank=0))
    batches = batches[:DP_BITWISE_STEPS]
    models = [pick_convnet(shape, plan="auto", num_classes=10,
                           dtype=torch.bfloat16, seed=0, device="cuda")
              for _ in "ab"]
    single = make_train_step(TrainState(models[0], lr=1e-4),
                             image_size=shape)
    losses_single = [single(*to_device(x, y, torch.device("cuda")))
                     for x, y in batches]
    bootstrap.init(device="cuda")
    try:
        state = TrainState(models[1], lr=1e-4)
        dp = DataParallel(models[1], image_size=shape)
        dp.shard_state(state)
        losses_dp = [dp.train_step(state, *to_device(x, y,
                                                     torch.device("cuda")))
                     for x, y in batches]
    finally:
        bootstrap.cleanup()
    sd = [m.state_dict() for m in models]
    differ = [k for k in sd[0] if not torch.equal(sd[0][k], sd[1][k])]
    same_loss = all(torch.equal(a, b)
                    for a, b in zip(losses_single, losses_dp))
    require(same_loss and not differ,
            f"path_dp: DataParallel at one rank is not the single-device "
            f"step bit for bit: losses {losses_single} vs {losses_dp}, "
            f"state entries differing {differ}")
    return {"steps": len(batches), "losses": [float(v) for v in losses_dp],
            "state_entries": len(sd[0]), "bitwise": True}


def _profile(step, batch, *, phase: str, plan: str, steps: int = 2) -> None:
    """Where a step's device time goes: ``steps`` more steps under
    ``torch.profiler``, after the timed run (the profiler's own cost stays
    out of the timed phase). Device time per step by op or kernel (self
    time), the busy total, and the idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
    # a kernel's time appears twice: as a device event, and as the self
    # device time of the op that launched it; sum each view on its own
    ops, kernels = {}, {}
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3 / steps
        if ms > 0:
            view = kernels if ev.device_type == DeviceType.CUDA else ops
            view[ev.key[:80]] = view.get(ev.key[:80], 0.0) + ms
    busy = sum(kernels.values())
    top = lambda d, k: dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])  # noqa: E731
    emit(phase, steps=steps, plan=plan, wall_ms_per_step=wall_ms,
         device_busy_ms_per_step=busy,
         idle_share=(1 - busy / wall_ms) if busy else None,
         ops_ms_per_step=top(ops, 15), kernels_ms_per_step=top(kernels, 12))


def phase_profile(trainer, phase: str = "profile",
                  plan: str = "main_path") -> None:
    """Two more steps of a ConvNet path under the profiler."""
    from tpu_sandbox_torch.data import normalize, synthetic_mnist
    from tpu_sandbox_torch.train.trainer import to_device

    images, labels = synthetic_mnist(n=BATCH, seed=2)
    batch = to_device(normalize(images), labels.astype("int32"),
                      torch.device("cuda"))
    _profile(trainer.train_step, batch, phase=phase, plan=plan)


def phase_lm_profile(lm_train, run) -> None:
    """Two more steps of the LM path under the profiler, on a new batch."""
    from tpu_sandbox_torch.train.trainer import to_device

    tokens, targets = next(lm_train.make_batches(LM_V, LM_B, LM_S, 1, 2))
    batch = to_device(tokens, targets, torch.device("cuda"))
    _profile(run.train_step, batch, phase="lm_profile", plan="lm_path")


def phase_card_vs_cpu() -> None:
    """The port on the card against the port on the CPU on every
    transposed plan of the paths (``path_accum``'s with 2 microbatches a
    step), on ConvNetS2D's four (fused_conv, fused_tail) plans, on the
    plain ConvNet with and without BN and on ConvNetS2D(fused_conv=True)
    without BN: the same bridged weights, batches and 3 SGD steps."""
    import numpy as np

    from tpu_sandbox_torch.data import BatchLoader, normalize, synthetic_mnist
    from tpu_sandbox_torch.models import ConvNet, ConvNetS2D, ConvNetS2DT
    from tpu_sandbox_torch.train import TrainState, make_train_step
    from tpu_sandbox_torch.train.trainer import to_device
    from tpu_sandbox_torch.utils import params_from_flax, params_to_flax

    hw, steps, bs = (64, 64), 3, 2
    # one seed draws the same conv and fc weights with or without BN
    trees = {use_bn: params_to_flax(ConvNetS2DT(hw, seed=0, use_bn=use_bn,
                                                device="cpu"))
             for use_bn in (True, False)}
    images, labels = synthetic_mnist(n=steps * bs, seed=0)
    res = {}
    plans = [(phase, ConvNetS2DT, {"fused_tail": True, **options})
             for phase, plan, options, *_ in PATHS if plan == "auto"]
    plans += [(f"s2d_fused_conv{int(fc)}_fused_tail{int(ft)}", ConvNetS2D,
               {"fused_conv": fc, "fused_tail": ft})
              for fc in (False, True) for ft in (False, True)]
    plans += [("plain", ConvNet, {}), ("plain_no_bn", ConvNet,
                                       {"use_bn": False}),
              ("s2d_fused_conv1_no_bn", ConvNetS2D,
               {"fused_conv": True, "use_bn": False})]
    for phase, cls, plan in plans:
        losses = {}
        accum = 2 if phase == "path_accum" else 1
        for dev in ("cpu", "cuda"):
            model = cls(hw, dtype=torch.float32, seed=1, device=dev, **plan)
            model.load_state_dict(params_from_flax(trees[plan.get("use_bn",
                                                                  True)]))
            step = make_train_step(TrainState(model, lr=1e-4), image_size=hw,
                                   accum_steps=accum)
            loader = BatchLoader(normalize(images), labels.astype("int32"),
                                 bs, shuffle=True, seed=0)
            losses[dev] = [float(step(*to_device(im, lb, torch.device(dev))))
                           for im, lb in loader]
        ok = np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0)
        res[phase] = dict(model=cls.__name__, plan=plan, accum_steps=accum,
                          losses_cpu=losses["cpu"],
                          losses_cuda=losses["cuda"], agree=bool(ok))
    emit("card_vs_cpu", image=64, dtype="fp32", steps=steps, rtol=1e-4,
         **res)
    for phase, r in res.items():
        require(r["agree"], f"card and CPU losses differ ({phase}): {r}")


def phase_pool_tie_card_vs_cpu() -> None:
    """The plain ConvNet's pool (``models/convnet.py::max_pool``, the
    F.max_pool2d call ConvNet makes) on the card against the CPU, on
    inputs quantised to {0, 0.5, 1} so that windows tie two, three and
    four ways, with a random upstream gradient, in fp32 and bf16: the
    output and the input gradient bitwise equal (routing only, no
    arithmetic), which holds the CUDA backward to the first-maximum rule
    the CPU and JAX's nn.max_pool follow. TIE_SHAPES: the second has an
    odd row and column that the floored pool drops."""
    from tpu_sandbox_torch.models.convnet import max_pool

    gen = torch.Generator().manual_seed(5)
    res = {}
    for shape in TIE_SHAPES:
        n, h, w, c = shape
        for dt_name, dt in DTYPES:
            x = (torch.randint(0, 3, shape, generator=gen).float() / 2).to(dt)
            g = torch.randn((n, h // 2, w // 2, c), generator=gen).to(dt)
            out = {}
            for dev in ("cpu", "cuda"):
                t = x.to(dev).detach().requires_grad_()
                y = max_pool(t)
                y.backward(g.to(dev))
                out[dev] = (y.detach().cpu(), t.grad.cpu())
            win = x[:, :h // 2 * 2, :w // 2 * 2].float().reshape(
                n, h // 2, 2, w // 2, 2, c)
            maxima = (win == win.amax(dim=(2, 4), keepdim=True)).sum(dim=(2, 4))
            res[f"{n}x{h}x{w}x{c} {dt_name}"] = dict(
                out_equal=torch.equal(out["cpu"][0], out["cuda"][0]),
                grad_equal=torch.equal(out["cpu"][1], out["cuda"][1]),
                windows_by_maxima={k: int((maxima == k).sum())
                                   for k in (1, 2, 3, 4)})
    emit("pool_tie_card_vs_cpu", **res)
    for case, r in res.items():
        require(r["out_equal"] and r["grad_equal"],
                f"the pool on the card and the CPU differ ({case}): {r}")
        require(all(r["windows_by_maxima"][k] for k in (2, 3, 4)),
                f"the tie case has no two-, three- or four-way tie: {r}")


def phase_curve_card_vs_cpu() -> None:
    """parity_run.py's protocol on the port, card against CPU: synthetic
    MNIST (2000 images, seed 0) resized once on the host to 128x128 with
    jax.image.resize's bilinear weights, the batch order of
    ``default_rng(0).permutation(2000)[:5]`` a step, fp32, SGD at 1e-4 for
    CURVE_STEPS steps from one bridged tree, on the plain ConvNet,
    ConvNetS2D (fused convs and tails) and the card's default
    ConvNetS2DT; each card curve against its CPU curve within the
    committed record (CURVE_BAR: parity_curves.jsonl:401)."""
    import numpy as np

    from tpu_sandbox_torch.data import normalize, synthetic_mnist
    from tpu_sandbox_torch.models import ConvNet, ConvNetS2D, ConvNetS2DT
    from tpu_sandbox_torch.train import TrainState, make_train_step
    from tpu_sandbox_torch.train.trainer import resize_on_device
    from tpu_sandbox_torch.utils import params_from_flax, params_to_flax

    hw = (CURVE_IMAGE, CURVE_IMAGE)
    images, labels = synthetic_mnist(n=CURVE_N, seed=0)
    resized = resize_on_device(torch.from_numpy(normalize(images)), hw)
    labels = torch.from_numpy(labels.astype(np.int64))
    rng = np.random.default_rng(0)
    order = [torch.from_numpy(rng.permutation(CURVE_N)[:BATCH])
             for _ in range(CURVE_STEPS)]
    tree = params_from_flax(params_to_flax(ConvNet(hw, seed=0,
                                                   device="cpu")))
    plans = (("plain", ConvNet, {}),
             ("s2d", ConvNetS2D, {"fused_conv": True, "fused_tail": True}),
             ("s2dt", ConvNetS2DT, {"fused_tail": True, "sparse_conv1": True,
                                    "fused_conv1_bwd": True}))
    res = {}
    for name, cls, options in plans:
        curves = {}
        for dev in ("cpu", "cuda"):
            model = cls(hw, seed=1, device=dev, **options)
            model.load_state_dict(tree)
            step = make_train_step(TrainState(model, lr=1e-4))
            curves[dev] = np.asarray([
                float(step(resized[sel].to(dev), labels[sel].to(dev)))
                for sel in order])
        dev_abs = np.abs(curves["cuda"] - curves["cpu"])
        rel = dev_abs / np.maximum(np.abs(curves["cpu"]), 1e-8)
        res[name] = dict(model=cls.__name__, options=options,
                         max_abs_dev=float(dev_abs.max()),
                         max_rel_dev=float(rel.max()),
                         mean_abs_dev=float(dev_abs.mean()),
                         worst_step=int(dev_abs.argmax()) + 1,
                         final_loss_cpu=float(curves["cpu"][-1]),
                         final_loss_cuda=float(curves["cuda"][-1]),
                         losses_cuda=curves["cuda"].tolist())
    emit("curve_card_vs_cpu", image=CURVE_IMAGE, batch=BATCH, dtype="fp32",
         steps=CURVE_STEPS, bar=CURVE_BAR, **res)
    for name, r in res.items():
        for key, limit in CURVE_BAR.items():
            require(r[key] <= limit, f"curve_card_vs_cpu {name}: {key} "
                    f"{r[key]} over the record's {limit}")


def _kernel_names() -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources."""
    import re
    from pathlib import Path

    names = set()
    for src in (Path(CONV_SRC).parent).glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    return names


def phase_profile_flag(mnist_onegpu) -> None:
    """``mnist_onegpu --profile DIR`` on the card: 2 steps of the default
    plan at 3000x3000; the trace file must exist and name at least one of
    the port's kernels."""
    import tempfile
    from pathlib import Path

    kernels = _kernel_names()
    require(len(kernels) > 10, f"found only {sorted(kernels)} in csrc")
    with tempfile.TemporaryDirectory() as logdir:
        args = mnist_onegpu.build_parser().parse_args([
            "--image-size", str(IMAGE), "--batch-size", str(BATCH),
            "--synthetic-n", str(2 * BATCH), "--limit-steps", "2",
            "--epochs", "1", "--log-every", "1", "--profile", logdir])
        trainer, _ = mnist_onegpu.train(args)
        files = sorted(Path(logdir).glob("*.json"))
        require(len(files) == 1, f"profile_flag wrote {files}")
        text = files[0].read_text()
        named = sorted(k for k in kernels if k in text)
        emit("profile_flag", steps=2, trace_bytes=len(text),
             losses=trainer.losses, port_kernels_named=named)
    require(named, "the --profile trace names none of the port's kernels")


def phase_lm_card_vs_cpu(lm_train) -> None:
    """The LM on the card against the LM on the CPU: vocab 4100 (so the CE
    kernel runs), d 64, 2 heads (head dim 32), 2 layers, S 256, flash,
    fp32, 3 Adam steps from the same bridged weights on make_batches'
    batches: losses within rtol 1e-4. Then the same for SeqParallel with
    the plain ring attention (attn="ring", plain PyTorch: at the bench
    width it would hold [16, 8, 2048, 2048] f32 scores a layer) over a
    one-rank {"data": 1, "sp": 1} mesh, NCCL on the card against gloo on
    the CPU. Before that, the LM built on the card from seed 0 must hold
    the CPU-built weights bitwise."""
    import numpy as np

    from tpu_sandbox_torch.train.trainer import to_device
    from tpu_sandbox_torch.utils import params_from_flax, params_to_flax

    args = lm_train.build_parser().parse_args([
        "--flash", "--vocab", "4100", "--d-model", "64", "--n-heads", "2",
        "--n-layers", "2", "--d-ff", "128", "--seq-len", "256", "--batch",
        "2", "--steps", "3", "--dtype", "fp32"])
    on_cpu = lm_train.build_model(args, torch.device("cpu"))
    tree = params_to_flax(on_cpu)
    # the seeded init itself: the model built on the card from the same
    # seed holds the CPU-built weights, bitwise
    want = on_cpu.state_dict()
    got = lm_train.build_model(args, torch.device("cuda")).state_dict()
    init_equal = sorted(got) == sorted(want) and all(
        torch.equal(got[k].cpu(), want[k]) for k in want)
    del on_cpu, want, got
    losses = {}
    for dev in ("cpu", "cuda"):
        device = torch.device(dev)
        model = lm_train.build_model(args, device, seed=1)
        model.load_state_dict(params_from_flax(tree))
        opt = lm_train.make_optimizer(args, model)
        step = lm_train.make_train_step(model, opt)
        losses[dev] = [float(step(*to_device(t, y, device)))
                       for t, y in lm_train.make_batches(
                           args.vocab, args.batch, args.seq_len, args.steps,
                           0)]
    t0 = time.monotonic()
    ring = {dev: _sp_ring_losses(lm_train, args, tree, dev)
            for dev in ("cpu", "cuda")}
    ring_seconds = time.monotonic() - t0
    ok = bool(np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0))
    ring_ok = bool(np.allclose(ring["cuda"], ring["cpu"], rtol=1e-4, atol=0))
    emit("lm_card_vs_cpu", dtype="fp32", steps=3, rtol=1e-4,
         losses_cpu=losses["cpu"], losses_cuda=losses["cuda"], agree=ok,
         sp_ring_losses_cpu=ring["cpu"], sp_ring_losses_cuda=ring["cuda"],
         sp_ring_agree=ring_ok, sp_ring_seconds=ring_seconds,
         init_bitwise_equal=init_equal)
    require(init_equal, "the LM built on the card from seed 0 does not "
            "hold the CPU-built weights bitwise")
    require(ok, f"LM card and CPU losses differ: {losses}")
    require(ring_ok, f"SeqParallel ring card and CPU losses differ: {ring}")


def _sp_ring_losses(lm_train, args, tree, dev: str) -> list:
    """3 steps of SeqParallel(attn="ring") at one rank on ``dev`` (NCCL
    on the card, gloo on the CPU) from the bridged ``tree``."""
    from tpu_sandbox_torch.models.transformer import TransformerLM
    from tpu_sandbox_torch.parallel import SeqParallel
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.runtime.mesh import make_mesh
    from tpu_sandbox_torch.utils import params_from_flax

    device = torch.device(dev)
    bootstrap.init(device=dev)
    try:
        cfg = lm_train.make_config(args)
        eng = SeqParallel(
            lambda attn: TransformerLM(cfg, attn, seed=1, device=device),
            lambda params: lm_train.make_adam(args, params),
            make_mesh({"data": 1, "sp": 1}), attn="ring")
        state = eng.init_state()
        state.model.load_state_dict(params_from_flax(tree))
        eng.shard_state(state)
        return [float(eng.train_step(state, *eng.shard_batch(t, y)))
                for t, y in lm_train.make_batches(
                    args.vocab, args.batch, args.seq_len, args.steps, 0)]
    finally:
        bootstrap.cleanup()


def phase_moe_card_vs_cpu(lm_train) -> None:
    """The MoE LM (MOE_SMALL: E 4, top-1, vocab 4100, d 64, 2 heads, 2
    layers, S 256, flash, fp32) through PjitEngine with the expert rule at
    one rank, NCCL on the card against gloo on the CPU, from the same seed
    (the weights drawn on the CPU generator on both): the first step's
    loss (the mean CE plus 0.01 times the mean load-balance loss) within
    rtol MOE_RTOL, and every gradient within MOE_RTOL of max|CPU's|."""
    from tpu_sandbox_torch.parallel.pjit_engine import PjitEngine
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.runtime.mesh import make_mesh

    args = lm_train.build_parser().parse_args(MOE_SMALL)
    tokens, targets = next(lm_train.make_batches(
        args.vocab, args.batch, args.seq_len, 1, 0))
    res = {}
    for dev in ("cpu", "cuda"):
        device = torch.device(dev)
        bootstrap.init(device=dev)
        try:
            eng = PjitEngine(
                lm_train.build_model(args, device),
                lambda params: lm_train.make_adam(args, params),
                make_mesh({"data": 1, "expert": 1}), task="lm",
                rules=lm_train.PJIT_RULES["ep"]())
            state = eng.shard_state()
            loss = eng.loss(state.model, *eng.shard_batch(tokens, targets))
            loss.backward()
            res[dev] = (loss.item(), {leaf.name: leaf.param.grad.cpu()
                                      for leaf in eng.leaves})
        finally:
            bootstrap.cleanup()
    (cpu_loss, cpu_g), (card_loss, card_g) = res["cpu"], res["cuda"]
    loss_dev = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad_dev = {k: float((card_g[k] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for k, g in cpu_g.items()}
    worst = max(grad_dev, key=grad_dev.get)
    emit("moe_card_vs_cpu", flags=MOE_SMALL, rtol=MOE_RTOL,
         loss_cpu=cpu_loss, loss_cuda=card_loss, loss_rel_dev=loss_dev,
         grad_max_rel_dev=grad_dev[worst], grad_worst=worst,
         grads=len(grad_dev))
    require(sorted(card_g) == sorted(cpu_g) and loss_dev <= MOE_RTOL
            and grad_dev[worst] <= MOE_RTOL,
            f"MoE card and CPU differ: loss {card_loss} vs {cpu_loss}, "
            f"d{worst} {grad_dev[worst]:.3g} of max|CPU|")


def _leaves_equal(a: dict, b: dict) -> list[str]:
    """Paths whose values differ (a per-replica leaf of a sharded step,
    ``[1, ...]`` at one rank, is held to the single-device one)."""
    import numpy as np

    def arr(x):
        return (x.float().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))

    bad = [p for p in a if p not in b]
    for p in b:
        x, y = arr(a.get(p, np.zeros(0))), arr(b[p])
        if x.shape != y.shape and x.shape[1:] == y.shape and x.shape[0] == 1:
            x = x[0]
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(p)
    return bad


def _dir_bytes(d: Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def _fresh_ckpt_dir(name: str) -> Path:
    import shutil

    d = CKPT_ROOT / name
    for x in (d, d.with_name(d.name + ".quarantine")):
        shutil.rmtree(x, ignore_errors=True)
    d.parent.mkdir(parents=True, exist_ok=True)
    return d


def phase_ckpt_card(ops, expected: list[str]) -> tuple[dict, dict]:
    """The default plan at 3000x3000, batch 5, bf16 through make_train_step:
    CKPT_STEPS steps, the single-device ``save`` (timed: the copy of the
    state to the host, the npz write with its SHA-256, and the SHA-256
    alone over the warm file), ``restore`` into a model built anew on the
    card (timed), the restored leaves bitwise the saved ones, then
    CKPT_STEPS more steps from each state on the same batches: losses and
    every leaf bitwise equal. The same sgd state also through
    ShardedCheckpoint(compress=True), and with --opt adamw through
    HostCheckpoint, their bytes on disk. The launch counters are zeroed before and read after: the main
    path's kinds once a step."""
    import gc
    import shutil

    from tpu_sandbox_torch.data import normalize, synthetic_mnist
    from tpu_sandbox_torch.models import pick_convnet
    from tpu_sandbox_torch.train import AdamW, TrainState, make_train_step
    from tpu_sandbox_torch.train import checkpoint as ck
    from tpu_sandbox_torch.train.optim import constant_schedule
    from tpu_sandbox_torch.train.trainer import to_device
    from tpu_sandbox_torch.utils.bridge import (
        state_from_leaves,
        state_template,
    )

    dev = torch.device("cuda")
    shape = (IMAGE, IMAGE)
    images, labels = synthetic_mnist(n=2 * CKPT_STEPS * BATCH, seed=0)
    images, labels = normalize(images), labels.astype("int32")
    batches = [to_device(images[i:i + BATCH], labels[i:i + BATCH], dev)
               for i in range(0, len(images), BATCH)]

    def build(opt):
        model = pick_convnet(shape, plan="auto", num_classes=10,
                             dtype=torch.bfloat16, seed=0, device="cuda")
        optimizer = (AdamW(model.parameters(), constant_schedule(1e-4))
                     if opt == "adamw" else None)
        state = TrainState(model, lr=1e-4, optimizer=optimizer)
        return state, make_train_step(state, image_size=shape)

    def run(step, bs):
        return [step(*b) for b in bs]

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    res, steps = {}, 0
    ops.reset_launch_counts()
    for opt, formats in (("sgd", ("single", "sharded_compressed")),
                         ("adamw", ("host",))):
        state, step = build(opt)
        run(step, batches[:CKPT_STEPS])
        steps += CKPT_STEPS
        leaves, copy_s = sync_s(state.host_view)
        nbytes_state = sum(v.numel() * v.element_size()
                           if isinstance(v, torch.Tensor) else v.nbytes
                           for v in leaves.values())
        restored = {}
        for fmt in formats:
            d = _fresh_ckpt_dir(f"ckpt_card_{opt}_{fmt}")
            fresh, fresh_step = build(opt)
            template = state_template(fresh)
            t0 = time.perf_counter()
            if fmt == "single":
                ck.save(d, leaves)
                shard = d / f"step-{CKPT_STEPS:08d}" / "shard-00000.npz"
            elif fmt == "host":
                shard = ck.HostCheckpoint(d).save(leaves, CKPT_STEPS,
                                                  epoch=0, offset=CKPT_STEPS)
            else:
                require(ck.ShardedCheckpoint(
                    d, rank=0, world_size=1, verbose=False,
                    compress=True).save(leaves, {p: "rep" for p in leaves},
                                        CKPT_STEPS, epoch=0,
                                        offset=CKPT_STEPS),
                        f"ckpt_card {opt} {fmt}: the step did not seal")
                shard = d / f"step-{CKPT_STEPS:08d}" / "shard-00000.npz"
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ck._sha256_file(shard)
            hash_s = time.perf_counter() - t0

            def restore():
                if fmt == "single":
                    ck.restore(d, fresh)
                    return
                tree, _ = (ck.HostCheckpoint(d) if fmt == "host" else
                           ck.ShardedCheckpoint(d, rank=0, world_size=1,
                                                verbose=False)
                           ).restore(template)
                state_from_leaves(fresh, tree)

            _, restore_s = sync_s(restore)
            differ = _leaves_equal(fresh.host_view(), leaves)
            require(not differ, f"ckpt_card {opt} {fmt}: the restored "
                    f"state differs from the saved one in {differ}")
            restored[fmt] = (fresh, fresh_step)
            res[f"{opt}_{fmt}"] = dict(
                state_bytes=nbytes_state, bytes_on_disk=_dir_bytes(d),
                copy_to_host_s=copy_s, save_s=save_s,
                sha256_warm_s=hash_s, restore_s=restore_s,
                leaves=len(leaves))
            shutil.rmtree(d, ignore_errors=True)
        after = batches[CKPT_STEPS:2 * CKPT_STEPS]
        want = [float(v) for v in run(step, after)]
        steps += CKPT_STEPS
        for fmt, (fresh, fresh_step) in restored.items():
            got = [float(v) for v in run(fresh_step, after)]
            steps += CKPT_STEPS
            differ = _leaves_equal(fresh.host_view(), state.host_view())
            require(got == want and not differ,
                    f"ckpt_card {opt} {fmt}: {CKPT_STEPS} steps from the "
                    f"restored state give losses {got} against {want}, "
                    f"leaves differing {differ}")
            res[f"{opt}_{fmt}"]["losses_after"] = got
        del state, step, restored, leaves
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for key in expected:
        require(counts.get(key, 0) == steps,
                f"ckpt_card launched {key} {counts.get(key, 0)} times in "
                f"{steps} steps")
    require(set(counts) == set(expected),
            f"unexpected launches on ckpt_card: {counts}")
    return dict(image=IMAGE, batch=BATCH, dtype="bf16", steps=steps,
                formats=res, launches=counts), counts


def phase_path_ckpt(ops, mnist_onegpu, expected: list[str],
                    main_res: dict) -> tuple[dict, dict]:
    """main_path with --ckpt-dir D --ckpt-every CKPT_EVERY: the same
    launches, losses bitwise main_path's, its step time beside main_path's
    of this run, the saver's copy and write seconds, and the last line
    "saved checkpoint at step N"."""
    d = _fresh_ckpt_dir("path_ckpt")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res, counts, trainer = phase_main_path(
            ops, mnist_onegpu, expected, phase="path_ckpt", plan="auto",
            steps=STEPS, flags=["--ckpt-dir", str(d), "--ckpt-every",
                                str(CKPT_EVERY)])
    print(log.getvalue(), end="", flush=True)
    lines = log.getvalue().splitlines()
    saves = [ln for ln in lines if ln.startswith("checkpoint saved at")]
    require(lines[-1] == f"saved checkpoint at step {STEPS}"
            and len(saves) == STEPS // CKPT_EVERY,
            f"path_ckpt printed {lines}")
    require(trainer.losses == main_res["losses"],
            f"path_ckpt losses {trainer.losses} are not main_path's "
            f"{main_res['losses']}")
    res["ckpt_timings"] = [dict(step=s, copy_s=c, write_s=w)
                           for s, c, w in trainer.ckpt_timings]
    res["bytes_on_disk"] = _dir_bytes(d)
    res["main_path_step_ms_median_after_first"] = main_res[
        "step_ms_median_after_first"]
    res["main_path_step_ms_each"] = main_res["step_ms_each"]
    import shutil

    shutil.rmtree(d, ignore_errors=True)
    return res, counts


def _elastic_argv(d: Path, *extra: str) -> list[str]:
    return ["-g", "1", "--plan", "auto", "--image-size", str(IMAGE),
            "--batch-size", str(BATCH), "--dtype", "bf16", "--synthetic-n",
            str(ELASTIC_STEPS * BATCH), "--limit-steps", str(ELASTIC_STEPS),
            "--epochs", "1", "--log-every", "1", "--ckpt-dir", str(d),
            "--ckpt-every", str(ELASTIC_EVERY), *extra]


def _final_leaves(d: Path, template: dict, sharded: bool) -> dict:
    from tpu_sandbox_torch.train import checkpoint as ck

    if sharded:
        tree, meta = ck.ShardedCheckpoint(d, rank=0, world_size=1,
                                          verbose=False).restore(template)
    else:
        tree, meta = ck.HostCheckpoint(d).restore(template)
    require(meta["step"] == ELASTIC_STEPS,
            f"the final checkpoint under {d} is step {meta['step']}")
    return tree


def _npz_template(path: Path) -> dict:
    """A restore template of the leaves an npz checkpoint holds, read from
    its members' headers (no payload is read)."""
    import zipfile

    from tpu_sandbox_torch.runtime.staging import read_npy_header
    from tpu_sandbox_torch.train.checkpoint import ShapeDtype

    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.startswith("leaf:"):
                with z.open(name) as f:
                    shape, _, dtype = read_npy_header(f)
                out[name[len("leaf:"):-len(".npy")]] = ShapeDtype(shape,
                                                                   dtype)
    return out


def phase_path_resumable(ops, mnist_distributed,
                         expected: list[str]) -> tuple[dict, dict, dict]:
    """mnist_distributed's elastic rank body (train_elastic_worker) in this
    process at one NCCL rank, against a KV store of this process: the
    default plan at 3000x3000, batch 5, bf16, ELASTIC_STEPS steps of
    train_resumable with the non-finite guard and a HostCheckpoint every
    ELASTIC_EVERY steps; the counters zeroed before and read after: the
    main path's kinds once a step and no other. Its final checkpoint is
    path_elastic's reference."""
    from tpu_sandbox_torch.runtime.kvstore import KVServer
    from tpu_sandbox_torch.runtime.bootstrap import find_free_port

    d = _fresh_ckpt_dir("path_resumable")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with KVServer() as kv:
        args = mnist_distributed.build_parser().parse_args(_elastic_argv(
            d, "--elastic-worker", "--rank", "0", "--port",
            find_free_port(), "--kv-port", str(kv.port)))
        log = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(log):
            mnist_distributed.train_elastic_worker(args, 1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
    print(log.getvalue(), end="", flush=True)
    lines = log.getvalue().splitlines()
    for key in expected:
        require(counts.get(key, 0) == ELASTIC_STEPS,
                f"path_resumable launched {key} {counts.get(key, 0)} times "
                f"in {ELASTIC_STEPS} steps")
    require(set(counts) == set(expected),
            f"unexpected launches on path_resumable: {counts}")
    require(f"[gen 1] fresh start; applied {ELASTIC_STEPS} step(s), final "
            f"step {ELASTIC_STEPS}" in lines, f"path_resumable: {lines}")
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in lines
              if ln.startswith("Rank [0]")]
    require(len(losses) == ELASTIC_STEPS
            and all(math.isfinite(v) for v in losses),
            f"path_resumable losses {losses}")
    template = _npz_template(d / f"step-{ELASTIC_STEPS:08d}.npz")
    ref = _final_leaves(d, template, sharded=False)
    res = dict(image=IMAGE, batch=BATCH, dtype="bf16", steps=ELASTIC_STEPS,
               ckpt_every=ELASTIC_EVERY, losses_printed=losses,
               wall_s_with_init=wall,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               bytes_on_disk=_dir_bytes(d), launches=counts)
    import shutil

    shutil.rmtree(d, ignore_errors=True)
    return res, counts, (template, ref)


def phase_path_elastic(mnist_distributed, template: dict,
                       ref: dict) -> dict:
    """mnist_distributed -g 1 --elastic under the single-host supervisor
    of this process, each generation one worker process (NCCL, one rank),
    twice: a fault plan that SIGKILLs rank 0 at ELASTIC_FAULT_STEP (two
    generations, the first charged, exit 0) and --ckpt-sharded with a
    SIGTERM at the same step (the worker saves and exits 75, which is not
    charged). Each final checkpoint bitwise path_resumable's. Each
    generation's seconds."""
    import os
    import shutil

    out = {}
    for name, flags, plan, sharded in (
            ("kill", [], "kill", False),
            ("sigterm_sharded", ["--ckpt-sharded"], "sigterm", True)):
        d = _fresh_ckpt_dir(f"path_elastic_{name}")
        args = mnist_distributed.build_parser().parse_args(
            _elastic_argv(d, "--elastic", *flags))
        env = {"TPU_SANDBOX_FAULT_PLAN": json.dumps([{
            "rank": 0, "step": ELASTIC_FAULT_STEP, "action": plan,
            "target": None}]), "TPU_SANDBOX_BACKOFF": "0.1"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        log = io.StringIO()
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(log):
                result = mnist_distributed.spawn_elastic(args, 1)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        wall = time.monotonic() - t0
        print(log.getvalue(), end="", flush=True)
        gens = result.generations
        first = "failure" if plan == "kill" else "preemption"
        require([g.outcome for g in gens] == [first, "ok"],
                 f"path_elastic {name}: generations {gens}")
        if plan == "kill":
            require(result.restarts_charged == 1 and result.preemptions == 0,
                    f"path_elastic {name}: {result.summary()}")
        else:
            require(gens[0].exit_codes == [75] and result.restarts_charged == 0
                    and result.preemptions == 1,
                    f"path_elastic {name}: {result.summary()}")
        final = _final_leaves(d, template, sharded)
        differ = _leaves_equal(final, ref)
        require(not differ, f"path_elastic {name}: the final state differs "
                f"from path_resumable's in {differ}")
        out[name] = dict(flags=flags, fault={"rank": 0,
                                             "step": ELASTIC_FAULT_STEP,
                                             "action": plan},
                         generations=[dict(generation=g.generation,
                                           outcome=g.outcome,
                                           exit_codes=g.exit_codes,
                                           seconds=g.elapsed) for g in gens],
                         summary=result.summary(), wall_s=wall,
                         bitwise_vs="path_resumable")
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d.with_name(d.name + ".quarantine"), ignore_errors=True)
    return out


def _stamped_run(argv: list[str], env: dict, limit: float
                 ) -> tuple[int, list[tuple[float, str]]]:
    """Run ``argv`` from the checkout's root, echoing its output and
    stamping each line with the monotonic clock as it arrives: (exit
    code, [(seconds since start, line)])."""
    import threading

    t0 = time.monotonic()
    proc = subprocess.Popen(argv, cwd=Path(__file__).resolve().parent,
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    lines: list[tuple[float, str]] = []

    def pump():
        for line in proc.stdout:
            lines.append((time.monotonic() - t0, line.rstrip("\n")))
            print(line, end="", flush=True)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        require(False, f"{argv[2:4]} ran past {limit} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    return proc.returncode, lines


def _first(lines, needle: str) -> float | None:
    """The stamp of the first line holding ``needle``."""
    return next((t for t, ln in lines if needle in ln), None)


def _rank_launches(d: Path) -> dict:
    """generation -> {steps, launches} of the ranks that finished their
    generation (mnist_distributed's TPU_SANDBOX_LAUNCH_COUNTS files)."""
    out = {}
    for f in sorted(d.glob("launches-g*-r0.json")):
        rec = json.loads(f.read_text())
        out[rec["generation"]] = rec
    return out


def _require_main_kinds(rec: dict, what: str) -> None:
    """A rank's launches: the main path's kinds once a step, no other."""
    steps, counts = rec["steps"], rec["launches"]
    require(steps > 0 and set(counts) == set(MAIN_KINDS)
            and all(counts[k] == steps for k in MAIN_KINDS),
            f"{what}: {steps} step(s) launched {counts}")


def phase_path_agents(template: dict, ref: dict) -> tuple[dict, dict]:
    """``python -m tpu_sandbox_torch.mnist_distributed --elastic --agents 1
    -g 1`` at 3000x3000, batch 5, bf16, the default plan, --ckpt-every 2:
    an AgentLauncher process owning the KV store, one HostAgent process
    and its one rank at one NCCL rank on the card, with a fault plan of
    kill_agent on rank 0's agent at step 3 (AGENTS_ENV's lease). The
    launcher must respawn the agent, the new agent must win the lease at
    term 2 and report its lost rank, exactly one restart is charged, exit 0, the final checkpoint
    bitwise path_resumable's, and the surviving generation's rank launches
    the main path's kinds once a step. Each generation's seconds and the
    seconds from the kill to the new term, on this process's clock as the
    lines arrive."""
    import os

    d = _fresh_ckpt_dir("path_agents")
    launches = _fresh_ckpt_dir("path_agents_launches")
    launches.mkdir()
    env = {**os.environ, **PLANE_ENV, **AGENTS_ENV,
           "TPU_SANDBOX_LAUNCH_COUNTS": str(launches),
           "TPU_SANDBOX_FAULT_PLAN": json.dumps([{
               "rank": 0, "step": ELASTIC_FAULT_STEP,
               "action": "kill_agent", "target": None}])}
    rc, lines = _stamped_run(
        [sys.executable, "-m", "tpu_sandbox_torch.mnist_distributed",
         *_elastic_argv(d, "--elastic", "--agents", "1")], env, PLANE_LIMIT)
    text = "\n".join(ln for _, ln in lines)
    t = {"spawn1": _first(lines, "[agent 0] gen 1: spawned local rank"),
         "kill": _first(lines, "[agent 0] fault: kill_agent"),
         "respawn": _first(lines, "[launcher] agent 0 died (exit -9); "
                                  "respawning [1/16]"),
         "term2": _first(lines, "[agent 0] elected leader (term 2)"),
         "teardown1": _first(lines, "[agent 0] gen 1: teardown"),
         "spawn2": _first(lines, "[agent 0] gen 2: spawned local rank"),
         "ok2": _first(lines, "[agent 0] gen 2: local outcome ok"),
         "done": _first(lines, "[launcher] job ok")}
    resumed = re.search(r"\[gen 2\] resumed from step (\d+); applied (\d+) "
                        r"step\(s\), final step (\d+)", text)
    require(rc == 0 and None not in t.values() and resumed
            and "agent restarted; local ranks lost" in text
            and "2 generation(s); 1 restart(s) charged, 0 preemption(s)"
            in text, f"path_agents: exit {rc}, stamps {t}")
    final = _final_leaves(d, template, sharded=False)
    differ = _leaves_equal(final, ref)
    require(not differ, "path_agents: the final state differs from "
            f"path_resumable's in {differ}")
    gens = _rank_launches(launches)
    require(list(gens) == [2], f"path_agents: launch records {gens}")
    _require_main_kinds(gens[2], "path_agents gen 2")
    out = dict(argv=["--elastic", "--agents", "1", "-g", "1"],
               fault={"rank": 0, "step": ELASTIC_FAULT_STEP,
                      "action": "kill_agent"},
               resumed_from_step=int(resumed[1]),
               steps_applied_gen2=int(resumed[2]),
               generation_s={1: t["kill"] - t["spawn1"],
                             2: t["ok2"] - t["spawn2"]},
               kill_to_respawn_s=t["respawn"] - t["kill"],
               kill_to_new_term_s=t["term2"] - t["kill"],
               kill_to_relaunch_s=t["spawn2"] - t["kill"],
               wall_s=t["done"], restarts_charged=1,
               launches=gens[2]["launches"], bitwise_vs="path_resumable")
    import shutil

    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(launches, ignore_errors=True)
    return out, gens[2]["launches"]


def phase_path_pool(mnist_distributed, template: dict,
                    ref: dict) -> tuple[dict, dict]:
    """ClusterScheduler(1) in this process with two jobs of the same run
    (path_resumable's argv as ``mnist_distributed --elastic --pool 1``
    submits it, ``cluster_job_spec``): ``lo`` at priority 0 is admitted,
    and ``hi`` at priority 1 is submitted once lo's step-2 checkpoint is
    on disk (its steps 3-6 and two more saves, seconds of work, still to
    come). ``lo`` must save and exit 75 with no restart charged, ``hi``
    run to done, then ``lo`` resume to done; both final checkpoints
    bitwise path_resumable's, each finished generation's rank launching
    the main path's kinds once a step. Each job's queue, run and
    preemption seconds from job_events (the scheduler's clock)."""
    import shutil

    from tpu_sandbox_torch.runtime.scheduler import (
        ClusterScheduler,
        job_events,
        k_verdict,
    )

    dirs = {j: _fresh_ckpt_dir(f"path_pool_{j}") for j in ("lo", "hi")}
    launch_dirs = {j: _fresh_ckpt_dir(f"path_pool_{j}_launches")
                   for j in dirs}
    specs = {}
    for prio, job in enumerate(("lo", "hi")):
        launch_dirs[job].mkdir()
        args = mnist_distributed.build_parser().parse_args(_elastic_argv(
            dirs[job], "--elastic", "--pool", "1", "--job-id", job,
            "--priority", str(prio)))
        specs[job] = mnist_distributed.cluster_job_spec(args, 1)
        specs[job].env.update(PLANE_ENV, TPU_SANDBOX_LAUNCH_COUNTS=str(
            launch_dirs[job]))
    step2 = dirs["lo"] / f"step-{ELASTIC_EVERY:08d}.npz"

    def tick_until(pred, what):
        deadline = time.monotonic() + PLANE_LIMIT
        while time.monotonic() < deadline:
            sched._tick()
            got = pred()
            if got:
                return got
            time.sleep(0.005)
        require(False, f"path_pool: no {what} in {PLANE_LIMIT} s")

    t0 = time.monotonic()
    with ClusterScheduler(1, extra_env=mnist_distributed._root_env()
                          ) as sched:
        sched.submit(specs["lo"])
        tick_until(step2.exists, "step-2 checkpoint of lo")
        sched.submit(specs["hi"])
        states = sched.serve(timeout=PLANE_LIMIT)
        events = {j: job_events(sched.kv, j) for j in specs}
        verdicts = {j: json.loads(sched.kv.get(k_verdict(j)))
                    for j in specs}
    wall = time.monotonic() - t0
    require(states == {"lo": "done", "hi": "done"},
            f"path_pool: final states {states}")
    lo, hi = events["lo"], events["hi"]
    require(lo["admitted"] <= lo["preempt_sent"] <= lo["preempted"]
            <= lo["readmitted"] <= lo["done"]
            and hi["admitted"] >= lo["preempt_sent"]
            and hi["done"] <= lo["readmitted"],
            f"path_pool: job events {events}")
    require(verdicts["lo"]["ok"] and verdicts["lo"]["restarts"] == 0
            and verdicts["lo"]["preemptions"] == 1
            and verdicts["hi"]["ok"] and verdicts["hi"]["restarts"] == 0,
            f"path_pool: verdicts {verdicts}")
    gens = {j: _rank_launches(launch_dirs[j]) for j in specs}
    require(list(gens["lo"]) == [2] and list(gens["hi"]) == [1],
            f"path_pool: launch records {gens}")
    _require_main_kinds(gens["lo"][2], "path_pool lo gen 2")
    _require_main_kinds(gens["hi"][1], "path_pool hi")
    for job, d in dirs.items():
        differ = _leaves_equal(_final_leaves(d, template, sharded=False),
                               ref)
        require(not differ, f"path_pool {job}: the final state differs "
                f"from path_resumable's in {differ}")
    out = dict(
        pool=1, jobs={j: dict(priority=s.priority, hosts=s.hosts,
                              world_size=s.world_size)
                      for j, s in specs.items()},
        lo_preempted_after_step=ELASTIC_STEPS - gens["lo"][2]["steps"],
        seconds={
            "lo": dict(queue=lo["admitted"] - lo["submitted"],
                       run_before_preemption=lo["preempted"]
                       - lo["admitted"],
                       preemption=lo["preempted"] - lo["preempt_sent"],
                       requeued=lo["readmitted"] - lo["preempted"],
                       run_after_resume=lo["done"] - lo["readmitted"]),
            "hi": dict(queue=hi["admitted"] - hi["submitted"],
                       run=hi["done"] - hi["admitted"])},
        verdicts={j: {k: v[k] for k in ("ok", "restarts", "preemptions",
                                        "generations")}
                  for j, v in verdicts.items()},
        launches={j: gens[j][max(gens[j])]["launches"] for j in gens},
        wall_s=wall, bitwise_vs="path_resumable")
    for d in (*dirs.values(), *launch_dirs.values()):
        shutil.rmtree(d, ignore_errors=True)
    return out, gens["hi"][1]["launches"]


def serve_trace(vocab: int, *, requests: int, prompt: tuple, new: tuple,
                prefix: int, interarrival_s: float, seed: int) -> list:
    """[(arrival s, rid, prompt tokens, max new tokens)] in arrival order:
    Poisson arrivals, uniform prompt and new-token counts, a quarter of
    the requests (drawn at random) opening with one shared prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(interarrival_s, requests))
    shared = set(rng.permutation(requests)[:requests // 4].tolist())
    head = rng.integers(1, vocab, size=prefix).tolist()
    trace = []
    for i in range(requests):
        if i in shared:
            n = int(rng.integers(prefix + 1, prompt[1] + 1))
            toks = head + rng.integers(1, vocab, size=n - prefix).tolist()
        else:
            n = int(rng.integers(prompt[0], prompt[1] + 1))
            toks = rng.integers(1, vocab, size=n).tolist()
        trace.append((float(arrivals[i]), f"r{i}", toks,
                      int(rng.integers(new[0], new[1] + 1))))
    return trace


def _watched_step(step, record):
    """``step`` (a DecodeStep) with each prefill and decode call passed to
    ``record(kind, seconds, logits)`` after the card finished it (host
    clock around the call, the card synchronised on both sides; the engine
    copies the logits to the host right after anyway). Its steps run on
    the card or the CPU."""
    import dataclasses

    def wrap(fn, kind):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            record(kind, time.perf_counter() - t0, out[0])
            return out
        return run
    return dataclasses.replace(
        step, prefill={b: wrap(f, f"prefill_{b}")
                       for b, f in step.prefill.items()},
        decode=wrap(step.decode, "decode"))


def _serve_open_loop(engine, trace, request_cls) -> float:
    """Submit each request of ``trace`` when the wall clock passes its
    arrival (open loop, JAX's bench_serve), stepping the engine meanwhile,
    until every request has its verdict. Returns the wall seconds."""
    from collections import deque

    pending = deque(trace)
    start = time.monotonic()
    while pending or not engine.idle:
        now = time.monotonic() - start
        while pending and pending[0][0] <= now:
            off, rid, prompt, n = pending.popleft()
            engine.submit(request_cls(rid=rid, prompt=list(prompt),
                                      max_new_tokens=n, arrival=start + off))
        if engine.idle:
            time.sleep(min(1e-3, max(0.0, pending[0][0] - now)))
            continue
        engine.step()
    return time.monotonic() - start


def _pct(values, q) -> float | None:
    import numpy as np

    return float(np.percentile(values, q)) if len(values) else None


def phase_serve_card_vs_cpu() -> None:
    """The port's engines on the card against the port's on the CPU: the
    JAX serve tests' small LM (SERVE_SMALL) in fp32 from one seed, their
    request trace: the same greedy tokens, each step's logits within
    SERVE_CARD_TOL of max|CPU|, continuous equal to static on the card,
    and a forced preemption (three 12-token prompts decoding to the
    32-token context in a 23-block pool) replaying on the card to the
    tokens of the same requests without block pressure."""
    import numpy as np

    from tpu_sandbox_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from tpu_sandbox_torch.serve import (CacheConfig, ContinuousEngine,
                                         Request, ServeConfig, StaticEngine)
    from tpu_sandbox_torch.serve.decode import build_decode_step

    cfg = TransformerConfig(**SERVE_SMALL)
    params = TransformerLM(cfg, seed=0).state_dict()
    ccfg = CacheConfig(**SERVE_SMALL_CACHE)
    step = build_decode_step(cfg, ccfg, max_batch=3, buckets=(8, 16))
    rng = np.random.default_rng(1)
    trace = []
    for i in range(8):
        prompt = rng.integers(1, 64, size=int(rng.integers(3, 13))).tolist()
        trace.append((f"r{i}", prompt, int(rng.integers(4, 10))))
    rng = np.random.default_rng(3)
    pressure = [(f"p{i}", rng.integers(1, 64, size=12).tolist(), 20)
                for i in range(3)]

    def run(cls, dev, reqs, cache=ccfg):
        log = []
        eng = cls(params, ServeConfig(model=cfg, cache=cache, max_batch=3,
                                      buckets=(8, 16)),
                  step=_watched_step(step, lambda kind, seconds, logits:
                                     log.append(logits.float().cpu().numpy())),
                  device=dev)
        for rid, prompt, n in reqs:
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=n))
        eng.run_until_idle()
        return ({rid: r.tokens for rid, r in eng.results.items()}, log,
                sum(r.preemptions for r in eng.results.values()))

    out = {(cls.__name__, dev): run(cls, dev, trace)
           for cls in (ContinuousEngine, StaticEngine)
           for dev in ("cpu", "cuda")}
    worst = 0.0
    for name in ("ContinuousEngine", "StaticEngine"):
        (t_cpu, log_cpu, _), (t_gpu, log_gpu, _) = (out[(name, "cpu")],
                                                    out[(name, "cuda")])
        require(t_gpu == t_cpu, f"serve_card_vs_cpu {name}: card tokens "
                f"{t_gpu} differ from the CPU's {t_cpu}")
        require(len(log_gpu) == len(log_cpu), f"serve_card_vs_cpu {name}: "
                f"{len(log_gpu)} step calls on the card, {len(log_cpu)} on "
                "the CPU")
        for a, b in zip(log_gpu, log_cpu):
            err = float(np.abs(a - b).max()) / float(np.abs(b).max())
            worst = max(worst, err)
    require(worst <= SERVE_CARD_TOL, f"serve_card_vs_cpu: a step's logits "
            f"differ by {worst:.3g} of max|CPU|, tolerance {SERVE_CARD_TOL}")
    cont, stat = (out[("ContinuousEngine", "cuda")][0],
                  out[("StaticEngine", "cuda")][0])
    require(cont == stat, "serve_card_vs_cpu: continuous and static "
            "engines differ on the card")
    pressed, _, preempted = run(ContinuousEngine, "cuda", pressure)
    calm, _, calm_pre = run(ContinuousEngine, "cuda", pressure,
                            CacheConfig(num_blocks=64, block_size=4,
                                        max_blocks_per_seq=8))
    pressed_cpu, _, _ = run(ContinuousEngine, "cpu", pressure)
    emit("serve_card_vs_cpu", model=SERVE_SMALL, cache=SERVE_SMALL_CACHE,
         dtype="fp32", requests=len(trace), max_rel_logit_err=worst,
         tolerance=SERVE_CARD_TOL, tokens_equal=True,
         continuous_equals_static=True, preemptions=preempted,
         preempted_replay_equal=pressed == calm,
         preempted_equal_cpu=pressed == pressed_cpu)
    require(preempted >= 1 and calm_pre == 0,
            f"serve_card_vs_cpu: the pressure trace preempted {preempted} "
            f"times ({calm_pre} without pressure)")
    require(pressed == calm, "serve_card_vs_cpu: preempted requests replayed "
            f"to {pressed}, not {calm}")
    require(pressed == pressed_cpu, "serve_card_vs_cpu: preempted requests "
            "differ between the card and the CPU")


def phase_path_serve(ops) -> dict:
    """The serving slice at the LM's bench width (SERVE_WIDTH) in bf16 with
    a bf16 cache: SERVE_TRACE through ContinuousEngine, then StaticEngine,
    open loop on the wall clock, each on fresh pages from one DecodeStep
    (after a warm-up engine that prefills once at each bucket), kernel
    counters zeroed before the two runs and read after: no kernel of the
    port launches. Per engine: tokens/s, p50/p99 time to first token and
    inter-token latency, the median decode step and each bucket's median
    prefill (the card's time, synchronised), preemptions, prefix hits and
    peak device memory. Continuous must equal static to the token, every
    step's logits must be finite, the served logits must follow a plain
    forward (``_serve_reference``) and the prefix's pages must agree
    across buckets (``_prefix_probe``)."""
    from tpu_sandbox_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from tpu_sandbox_torch.serve import (CacheConfig, ContinuousEngine,
                                         Request, ServeConfig, StaticEngine)
    from tpu_sandbox_torch.serve.decode import build_decode_step

    cfg = TransformerConfig(**SERVE_WIDTH, dtype=torch.bfloat16)
    params = {k: v.to(torch.bfloat16) for k, v in
              TransformerLM(cfg, seed=0, device="cuda").state_dict().items()}
    torch.cuda.empty_cache()
    scfg = ServeConfig(model=cfg, cache=CacheConfig(**SERVE_CACHE),
                       max_batch=SERVE_BATCH, buckets=SERVE_BUCKETS,
                       cache_dtype=torch.bfloat16)
    step = build_decode_step(cfg, scfg.cache, max_batch=SERVE_BATCH,
                             buckets=SERVE_BUCKETS,
                             cache_dtype=torch.bfloat16)
    trace = serve_trace(cfg.vocab_size, **SERVE_TRACE)
    warm = ContinuousEngine(params, scfg, step=step)
    for b in SERVE_BUCKETS:
        warm.submit(Request(rid=f"w{b}", max_new_tokens=2, prompt=[
            1 + i % (cfg.vocab_size - 1) for i in range(b)]))
    warm.run_until_idle()
    del warm
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res, tokens, finite = {}, {}, []
    for name, cls in (("continuous", ContinuousEngine),
                      ("static", StaticEngine)):
        times: dict[str, list] = {}

        def record(kind, seconds, logits):
            times.setdefault(kind, []).append(seconds * 1e3)
            finite.append(bool(torch.isfinite(logits).all().item()))

        torch.cuda.reset_peak_memory_stats()
        eng = cls(params, scfg, step=_watched_step(step, record))
        wall = _serve_open_loop(eng, trace, Request)
        results = eng.results
        ttft = [r.ttft for r in results.values()]
        itl = [g for r in results.values() for g in r.itl]
        generated = sum(len(r.tokens) for r in results.values())
        tokens[name] = {rid: r.tokens for rid, r in results.items()}
        res[name] = {
            "wall_s": wall, "generated_tokens": generated,
            "tokens_per_s": generated / wall,
            "p50_ttft_ms": _pct(ttft, 50) * 1e3,
            "p99_ttft_ms": _pct(ttft, 99) * 1e3,
            "p50_itl_ms": _pct(itl, 50) * 1e3,
            "p99_itl_ms": _pct(itl, 99) * 1e3,
            "decode_steps": len(times["decode"]),
            "decode_step_ms_median": statistics.median(times["decode"]),
            "decode_step_ms_p99": _pct(times["decode"], 99),
            "prefill_ms_median": {k[len("prefill_"):]: statistics.median(v)
                                  for k, v in sorted(times.items())
                                  if k.startswith("prefill_")},
            "prefills": {k[len("prefill_"):]: len(v)
                         for k, v in sorted(times.items())
                         if k.startswith("prefill_")},
            "preemptions": sum(r.preemptions for r in results.values()),
            "prefix_hits": eng.cache.stats["prefix_hits"],
            "prefix_blocks_reused": eng.cache.stats["prefix_blocks_reused"],
            "evicted_cache_blocks": eng.cache.stats["evicted_cache_blocks"],
            "shed": len(eng.shed),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        }
        del eng
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    differ = sorted(rid for rid in tokens["continuous"]
                    if tokens["continuous"][rid] != tokens["static"].get(rid))
    ref = _serve_reference(step, params, scfg, trace, tokens["continuous"])
    probe = _prefix_probe(step, params, scfg)
    out = dict(model=SERVE_WIDTH, dtype="bf16", cache_dtype="bf16",
               cache=SERVE_CACHE, max_batch=SERVE_BATCH,
               buckets=list(SERVE_BUCKETS), trace=SERVE_TRACE,
               parameters=sum(v.numel() for v in params.values()),
               **res, launches=counts, continuous_equals_static=not differ,
               differing_requests=differ, reference=ref, prefix_probe=probe,
               decode_profile=_decode_profile(step, params, scfg))
    emit("path_serve", **out)
    for name, r in res.items():
        require(len(tokens[name]) == len(trace) and r["shed"] == 0,
                f"path_serve {name}: {len(tokens[name])} results and "
                f"{r['shed']} shed of {len(trace)} requests")
    require(all(finite), "path_serve: non-finite logits")
    require(counts == {}, f"path_serve launched port kernels: {counts}")
    require(not differ, f"path_serve: continuous and static tokens differ "
            f"for {differ}")
    require(ref["tokens_equal_trace"], "path_serve: the reference requests "
            "served again gave other tokens than in the trace run")
    require(ref["max_rel_err"] <= SERVE_REF_TOL, f"path_serve: served logits "
            f"differ from the plain forward's by {ref['max_rel_err']:.3g} of "
            f"max|plain|, tolerance {SERVE_REF_TOL}")
    require(ref["control_min_rel_err"] > SERVE_REF_TOL, f"path_serve: a "
            f"replaced first block moves a row by only "
            f"{ref['control_min_rel_err']:.3g} of max|plain|, within the "
            f"tolerance {SERVE_REF_TOL}: the check would not see it")
    require(probe["rel_diff"] <= SERVE_PREFIX_TOL, f"path_serve: prefix K/V "
            f"differ across buckets by {probe['rel_diff']:.3g} of max|K, V|, "
            f"tolerance {SERVE_PREFIX_TOL}")
    return out


def _serve_reference(step, params, scfg, trace, served) -> dict:
    """The served logits against one plain forward of the same bf16 LM on
    the card. The SERVE_REF_REQUESTS requests of ``trace`` with the longest
    contexts are served again together by a ContinuousEngine on fresh
    pages, each step's logit row of each kept; then each prompt and its
    generated tokens go through functional_call of the same weight dict
    with the model's own causal attention and no pages. Each served row is
    held against the plain row at its position, relative to max|plain|
    there. A control does the same against the plain forward with the
    context's first block of tokens replaced (what a block table pointing
    at the wrong block would read): how far such a fault moves the rows.
    Also the share of served tokens that are the plain argmax, and whether
    the requests served again gave the trace run's tokens (``served``)."""
    import dataclasses

    from torch.func import functional_call

    from tpu_sandbox_torch.models.transformer import TransformerLM
    from tpu_sandbox_torch.serve import ContinuousEngine, Request

    sample = sorted(trace, key=lambda r: len(r[2]) + r[3])[
        -SERVE_REF_REQUESTS:]
    by_prompt = {tuple(p): rid for _, rid, p, _ in sample}
    rows: dict[str, list] = {}
    eng = None

    def prefill_of(fn):
        def run(p, k, v, toks, dest, last_pos):
            out = fn(p, k, v, toks, dest, last_pos)
            # a replay after preemption starts the request's rows again
            rid = by_prompt[tuple(toks[0, :last_pos + 1].tolist())]
            rows[rid] = [out[0].float().clone()]
            return out
        return run

    def decode(p, k, v, toks, lengths, tables):
        out = step.decode(p, k, v, toks, lengths, tables)
        for i, s in enumerate(eng.slots):
            if s is not None:
                rows[s.request.rid].append(out[0][i].float().clone())
        return out

    eng = ContinuousEngine(params, scfg, step=dataclasses.replace(
        step, prefill={b: prefill_of(f) for b, f in step.prefill.items()},
        decode=decode))
    for _, rid, prompt, n in sample:
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=n))
    eng.run_until_idle()
    results = {rid: r.tokens for rid, r in eng.results.items()}
    del eng
    torch.cuda.empty_cache()
    with torch.device("meta"):
        model = TransformerLM(scfg.model, device="meta")
    bs = scfg.cache.block_size
    gen = torch.Generator().manual_seed(5)
    errs, ctrl, agree, contexts = [], [], 0, []
    with torch.no_grad():
        for _, rid, prompt, n in sample:
            gen_toks = results[rid]
            seq = torch.tensor([list(prompt) + gen_toks[:-1]])
            other = seq.clone()
            other[0, :bs] = torch.randint(1, scfg.model.vocab_size, (bs,),
                                          generator=gen)
            at = len(prompt) - 1
            plain, wrong = (functional_call(model, params, (t.cuda(),))[0, at:]
                            for t in (seq, other))
            got = torch.stack(rows[rid])                       # [n, vocab]
            scale = plain.abs().amax(-1)
            errs.append(((got - plain).abs().amax(-1) / scale).cpu())
            ctrl.append(((got - wrong).abs().amax(-1) / scale).cpu())
            agree += int((plain.argmax(-1).cpu()
                          == torch.tensor(gen_toks)).sum())
            contexts.append(seq.shape[1] + 1)
    errs, ctrl = torch.cat(errs), torch.cat(ctrl)
    return {"requests": [rid for _, rid, _, _ in sample],
            "contexts": contexts, "rows": int(errs.numel()),
            "max_rel_err": float(errs.max()),
            "median_rel_err": float(errs.median()),
            "tolerance": SERVE_REF_TOL,
            "control_median_rel_err": float(ctrl.median()),
            "control_min_rel_err": float(ctrl.min()),
            "argmax_share": agree / errs.numel(),
            "tokens_equal_trace": all(results[rid] == served[rid]
                                      for _, rid, _, _ in sample)}


def _prefix_probe(step, params, scfg) -> dict:
    """Prefill K/V of one SERVE_TRACE['prefix']-token prefix under each
    bucket that holds it, other tokens behind it, each written to blocks of
    its own in one page pool: how far the prefix's pages differ between
    buckets (a prefix-cache hit reads pages written under another
    bucket's prefill)."""
    from tpu_sandbox_torch.serve.decode import init_pages

    n, bs = SERVE_TRACE["prefix"], scfg.cache.block_size
    vocab = scfg.model.vocab_size
    gen = torch.Generator().manual_seed(4)
    prefix = torch.randint(1, vocab, (n,), generator=gen)
    buckets = [b for b in SERVE_BUCKETS if b >= n]
    k, v = init_pages(scfg.model, scfg.cache, torch.bfloat16, "cuda")
    blocks = []
    for i, b in enumerate(buckets):
        toks = torch.randint(1, vocab, (1, b), generator=gen)
        toks[0, :n] = prefix
        first = 1 + i * (n // bs)
        dest = torch.zeros(b, dtype=torch.long)
        dest[:n] = first * bs + torch.arange(n)
        step.prefill[b](params, k, v, toks.cuda(), dest.cuda(), n - 1)
        blocks.append(slice(first, first + n // bs))
    diff = max(float((pages[:, blk] - pages[:, blocks[0]]).float().abs().max())
               for pages in (k, v) for blk in blocks[1:])
    scale = max(float(pages[:, blocks[0]].float().abs().max())
                for pages in (k, v))
    del k, v
    torch.cuda.empty_cache()
    return {"prefix_tokens": n, "buckets": buckets, "max_abs_diff": diff,
            "rel_diff": diff / scale, "bitwise": diff == 0.0,
            "tolerance": SERVE_PREFIX_TOL}


def _decode_profile(step, params, scfg) -> dict:
    """Where one decode step's device time goes: every slot full, context
    lengths uniform from 3 blocks to a slot's share of the pool (48 to
    1008 at SERVE_CACHE, 63 blocks a slot), under
    torch.profiler over 5 calls. Kernels are grouped by what they do:
    matrix products, the gather of K/V through the block tables
    (``index`` reads), the scatter of the new token's K/V (``index_put``)
    and the rest."""
    from tpu_sandbox_torch.serve.decode import init_pages

    gen = torch.Generator().manual_seed(0)
    b, bs = SERVE_BATCH, scfg.cache.block_size
    own = min(scfg.cache.max_blocks_per_seq, (scfg.cache.num_blocks - 1) // b)
    lengths = torch.randint(3 * bs, own * bs + 1, (b,), generator=gen)
    tables = torch.zeros((b, scfg.cache.max_blocks_per_seq), dtype=torch.long)
    for i in range(b):
        need = -(-int(lengths[i]) // bs)
        tables[i, :need] = 1 + own * i + torch.arange(need)
    tokens = torch.randint(1, scfg.model.vocab_size, (b, 1), generator=gen)
    k, v = init_pages(scfg.model, scfg.cache, torch.bfloat16, "cuda")
    args = [t.to(k.device) for t in (tokens, lengths, tables)]
    rows = device_times(lambda: step.decode(params, k, v, *args), calls=5)
    del k, v
    torch.cuda.empty_cache()

    def kind(name):
        low = name.lower()
        if "index_put" in low or "scatter" in low:
            return "scatter"
        if "index" in low or "gather" in low:
            return "gather"
        if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                  "sm90", "matmul", "splitk")):
            return "matmul"
        return "other"

    groups: Counter = Counter()
    for ms, _, name in rows:
        groups[kind(name)] += ms
    total = sum(groups.values())
    # the bytes the step must move: every weight once, each slot's live
    # context of K and V (bf16) once a layer, the fp32 logits once; the
    # gather of a slot's whole max_context is the design's, not the work's
    weights = sum(t.numel() * t.element_size() for t in params.values())
    kv = 2 * scfg.model.n_layers * int(lengths.sum()) * scfg.model.d_model * 2
    logits = b * scfg.model.vocab_size * 4
    return {"device_ms": total, "by_kind_ms": dict(groups),
            "gather_share": groups["gather"] / total if total else None,
            "top": [{"ms": ms, "calls": n, "name": name[:120]}
                    for ms, n, name in rows[:12]],
            "weight_bytes": weights, "live_kv_bytes": kv,
            "max_context_kv_bytes": (2 * scfg.model.n_layers * b
                                     * scfg.cache.max_context
                                     * scfg.model.d_model * 2),
            "bound_ms": (weights + kv + logits) / PEAK_BYTES * 1e3,
            "context_lengths": lengths.tolist()}


def _replica_load() -> tuple[dict, list]:
    """path_replica's and path_replica_gang's replica config (the LM at
    its bench width, fp32, as the replica builds its engine) and their
    REPLICA_REQUESTS requests, from one seed."""
    import numpy as np

    cfg = {"model": SERVE_WIDTH, "cache": SERVE_CACHE,
           "max_batch": SERVE_BATCH, "buckets": list(SERVE_BUCKETS),
           "param_seed": 0, "lease_ttl": 3.0, "timeout": REPLICA_LIMIT}
    rng = np.random.default_rng(2)
    reqs = [(f"q{i}", rng.integers(1, SERVE_WIDTH["vocab_size"],
                                   size=int(rng.integers(32, 513))).tolist(),
             16 * (i + 1)) for i in range(REPLICA_REQUESTS)]
    return cfg, reqs


def phase_path_replica() -> tuple[dict, dict]:
    """The replica process on the card at the LM's bench width (fp32
    weights and cache, as the replica builds its engine; SERVE_CACHE,
    SERVE_BATCH, SERVE_BUCKETS), against a KV server in this process:
    REPLICA_REQUESTS requests queued, ``python -m
    tpu_sandbox_torch.serve.replica`` started, a SIGTERM once two verdicts
    are out (it must drain, requeue the rest and exit 75), then a second
    replica that finishes the requeued ones and exits 0. Every request
    gets exactly one verdict, "ok", with the tokens of the replica's own
    engine (``_build_engine`` from the same config) run in this process.
    Returns the phase's record and those tokens (rid -> tokens)."""
    import os
    import signal

    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
    from tpu_sandbox_torch.runtime.supervisor import (ENV_KV_PORT,
                                                      PREEMPTED_EXIT_CODE)
    from tpu_sandbox_torch.serve import Request
    from tpu_sandbox_torch.serve import replica as R

    cfg, reqs = _replica_load()
    root = Path(__file__).resolve().parent
    procs = []

    def start(tag):
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_sandbox_torch.serve.replica",
             "--config", json.dumps(cfg), "--tag", tag], cwd=root,
            env={**os.environ, ENV_KV_PORT: str(srv.port)}, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(p)
        return p

    def finish(p, what):
        try:
            stdout, stderr = p.communicate(timeout=REPLICA_LIMIT)
        except subprocess.TimeoutExpired:
            require(False, f"path_replica: {what} ran past {REPLICA_LIMIT} s")
        return p.returncode, stdout, stderr

    t0 = time.monotonic()
    with KVServer() as srv:
        kv = KVClient(port=srv.port)
        try:
            for rid, prompt, n in reqs:
                R.submit_request(kv, rid, prompt, n)
            R.announce_total(kv, len(reqs))
            first = start("replica-1")
            deadline = time.monotonic() + REPLICA_LIMIT
            while (len(kv.keys("serve/result/")) < 2 and first.poll() is None
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            at_term = len(kv.keys("serve/result/"))
            first.send_signal(signal.SIGTERM)
            rc1, out1, err1 = finish(first, "the first replica")
            first_s = time.monotonic() - t0
            require(rc1 == PREEMPTED_EXIT_CODE,
                    f"path_replica: the first replica exited {rc1}, not "
                    f"{PREEMPTED_EXIT_CODE}, after SIGTERM with {at_term} "
                    f"verdicts out: {out1[-2000:]} {err1[-4000:]}")
            after_first = len(kv.keys("serve/result/"))
            second = start("replica-2")
            rc2, out2, err2 = finish(second, "the second replica")
            require(rc2 == 0, f"path_replica: the second replica exited "
                    f"{rc2}: {out2[-2000:]} {err2[-4000:]}")
            verdicts = {rid: json.loads(kv.get(R.k_result(rid)))
                        for rid, _, _ in reqs}
            claims = {rid: int(kv.get(R.k_done(rid))) for rid, _, _ in reqs}
        finally:
            kv.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    replicas_s = time.monotonic() - t0
    requeued = re.search(r"requeued (\d+)", out1)
    engine = R._build_engine(cfg, torch.device("cuda"))
    for rid, prompt, n in reqs:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    engine.run_until_idle()
    want = {rid: r.tokens for rid, r in engine.results.items()}
    del engine
    torch.cuda.empty_cache()
    by = Counter(v.get("replica") for v in verdicts.values())
    out = dict(requests=len(reqs), verdicts_at_sigterm=at_term,
               verdicts_after_first=after_first,
               requeued=int(requeued.group(1)) if requeued else None,
               answered_by=dict(by), first_exit=rc1, second_exit=rc2,
               first_replica_s=first_s, replicas_s=replicas_s,
               tokens_equal={rid: verdicts[rid].get("tokens") == want[rid]
                             for rid, _, _ in reqs},
               verdict_claims=claims)
    emit("path_replica", **out)
    require(all(v["verdict"] == "ok" for v in verdicts.values()),
            f"path_replica: verdicts {verdicts}")
    require(all(c == 1 for c in claims.values()),
            f"path_replica: verdicts claimed more than once: {claims}")
    require(out["requeued"] and by.get("replica-2"),
            f"path_replica: nothing was requeued to the second replica: {out}")
    require(all(out["tokens_equal"].values()),
            "path_replica: a replica's tokens differ from the in-process "
            f"engine's: {out['tokens_equal']}")
    return out, want


def phase_path_replica_gang(want: dict) -> dict:
    """path_replica's replicas and requests (``_replica_load``) served by
    a gang of 2 host agents under an AgentLauncher of this process (its KV
    server), each agent's one rank a ``python -m
    tpu_sandbox_torch.serve.replica`` on the card (the scenario of JAX's
    tests/test_serve_integration.py:128): the requests queued, then
    kill_agent on agent 1 once two verdicts are out. The launcher must replace agent 1, whose successor reports
    its lost rank; the leader tears generation 1 down (the other replica
    drains) and relaunches; the job ends ok with one restart charged, and
    every request has exactly one verdict, "ok", with ``want``'s tokens
    (path_replica's in-process engine on the same config and requests)."""
    import threading

    from tpu_sandbox_torch.mnist_distributed import _root_env
    from tpu_sandbox_torch.runtime.faults import agent_cmd_key
    from tpu_sandbox_torch.runtime.host_agent import (
        K_JOB_DONE,
        AgentLauncher,
        k_report,
    )
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
    from tpu_sandbox_torch.serve import replica as R

    cfg, reqs = _replica_load()
    t0 = time.monotonic()
    with KVServer() as srv:
        kv = KVClient(port=srv.port)
        launcher = AgentLauncher(
            2, lambda aid, port: [sys.executable, "-c", GANG_AGENT,
                                  str(aid), "2", str(port), json.dumps(cfg)],
            kv_server=srv, extra_env=_root_env())
        rc: list[int] = []
        thread = threading.Thread(target=lambda: rc.append(launcher.run()),
                                  name="gang-launcher")
        try:
            for rid, prompt, n in reqs:
                R.submit_request(kv, rid, prompt, n)
            R.announce_total(kv, len(reqs))
            thread.start()
            deadline = time.monotonic() + PLANE_LIMIT
            while (len(kv.keys("serve/result/")) < 2 and thread.is_alive()
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            up = sorted(R.read_load_reports(kv))
            at_kill = len(kv.keys("serve/result/"))
            kill_s = time.monotonic() - t0
            require(0 < at_kill < len(reqs),
                    f"path_replica_gang: {at_kill} verdicts at the kill")
            kv.set(agent_cmd_key(1), json.dumps({"action": "kill_agent"}))
            thread.join(timeout=PLANE_LIMIT)
            require(not thread.is_alive() and rc == [0],
                    f"path_replica_gang: launcher exit {rc}")
            done = json.loads(kv.get(K_JOB_DONE))
            lost = json.loads(kv.try_get(k_report(1, 1)) or b"{}")
            verdicts = {rid: json.loads(kv.get(R.k_result(rid)))
                        for rid, _, _ in reqs}
            claims = {rid: int(kv.get(R.k_done(rid))) for rid, _, _ in reqs}
            tail = int(kv.get(R.K_TAIL))
        finally:
            if thread.is_alive():
                kv.set(K_JOB_DONE, json.dumps(
                    {"ok": False, "reason": "path_replica_gang teardown"}))
                thread.join(timeout=60)
            kv.close()
    gang_s = time.monotonic() - t0
    out = dict(requests=len(reqs), verdicts_at_kill=at_kill,
               replicas_reporting_at_kill=up, kill_at_s=kill_s,
               gang_s=gang_s,
               respawns=launcher.respawns, lost_rank_report=lost,
               job=done, requeued=tail - len(reqs),
               answered_by=dict(Counter(v.get("replica")
                                        for v in verdicts.values())),
               tokens_equal={rid: verdicts[rid].get("tokens") == want[rid]
                             for rid, _, _ in reqs},
               verdict_claims=claims)
    emit("path_replica_gang", **out)
    require(launcher.respawns == 1 and lost.get("outcome") == "failure"
            and lost.get("note") == "agent restarted; local ranks lost",
            f"path_replica_gang: respawns {launcher.respawns}, agent 1's "
            f"gen-1 report {lost}")
    require(done["ok"] and done["restarts"] == 1 and done["generations"] == 2,
            f"path_replica_gang: job verdict {done}")
    require(all(v["verdict"] == "ok" for v in verdicts.values())
            and all(c == 1 for c in claims.values()),
            f"path_replica_gang: verdicts {verdicts}, claims {claims}")
    require(all(out["tokens_equal"].values()),
            "path_replica_gang: a replica's tokens differ from "
            f"path_replica's in-process engine's: {out['tokens_equal']}")
    return out


def _serve_procs(srv_port: int, cfg: dict, tags, gateway_ids,
                 counts_dir: Path, trace_dir: Path | None = None) -> list:
    """Replica processes on the card (``python -m
    tpu_sandbox_torch.serve.replica``, each writing its launch counts into
    ``counts_dir`` when it ends) and gateway processes (``python -m
    tpu_sandbox_torch.gateway``, its one fleet's blocks the replicas' cache
    blocks, so its chains are theirs), all against the KV server on
    ``srv_port``, all started at once. With ``trace_dir`` every process
    records into it, as ``serve-<tag>`` or ``gateway-<id>``."""
    import os

    from tpu_sandbox_torch.obs.record import ENV_PROC_NAME, ENV_TRACE_DIR
    from tpu_sandbox_torch.runtime.supervisor import ENV_KV_PORT
    from tpu_sandbox_torch.serve.replica import ENV_LAUNCH_COUNTS

    root = Path(__file__).resolve().parent
    env = {**os.environ, ENV_KV_PORT: str(srv_port),
           ENV_LAUNCH_COUNTS: str(counts_dir)}

    def env_of(proc):
        if trace_dir is None:
            return env
        return {**env, ENV_TRACE_DIR: str(trace_dir), ENV_PROC_NAME: proc}

    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_sandbox_torch.serve.replica",
         "--config", json.dumps(cfg), "--tag", tag], cwd=root,
        env=env_of(f"serve-{tag}"), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
        for tag in tags]
    procs += [subprocess.Popen(
        [sys.executable, "-m", "tpu_sandbox_torch.gateway",
         "--kv-port", str(srv_port), "--gateway-id", gid, "--fleets",
         json.dumps([{"block_size": cfg["cache"]["block_size"]}])],
        cwd=root, env=env_of(f"gateway-{gid}"), text=True,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
        for gid in gateway_ids]
    return procs


def _wait_fleet(kv, procs, tags, gateway_ids, what: str) -> dict:
    """Until every replica of ``tags`` reports its load and every gateway
    of ``gateway_ids`` holds its heartbeat lease (REPLICA_LIMIT): the
    gateways' endpoints by id."""
    from tpu_sandbox_torch.gateway import live_gateway_endpoints
    from tpu_sandbox_torch.serve import replica as R

    deadline = time.monotonic() + REPLICA_LIMIT
    while True:
        up = {gid: (host, port)
              for gid, host, port in live_gateway_endpoints(kv)}
        if set(tags) <= set(R.read_load_reports(kv)) \
                and set(gateway_ids) <= set(up):
            return up
        for p in procs:
            if p.poll() is not None:
                require(False, f"{what}: a process exited {p.returncode} "
                        f"at start: {p.communicate()[0][-3000:]}")
        require(time.monotonic() < deadline,
                f"{what}: the fleet did not come up in {REPLICA_LIMIT} s")
        time.sleep(0.05)


def _end_fleet(kv, procs, gateways, total: int, what: str,
               killed=()) -> list[str]:
    """Announce ``total`` requests (the replicas then end, exit 0), SIGTERM
    the gateways still running (exit 0), and return each process's
    output; every wait within REPLICA_LIMIT. A process of ``killed`` was
    SIGKILLed (-9)."""
    import signal

    from tpu_sandbox_torch.serve import replica as R

    R.announce_total(kv, total)
    for p in gateways:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=REPLICA_LIMIT)
        except subprocess.TimeoutExpired:
            require(False, f"{what}: a process ran past {REPLICA_LIMIT} s")
        outs.append(out)
        require(p.returncode == (-9 if p in killed else 0),
                f"{what}: a process exited {p.returncode}: {out[-3000:]}")
    return outs


def _fleet_launches(counts_dir: Path, tags, what: str) -> tuple[dict, dict]:
    """The replicas' launch-count files: the launches summed over them,
    and each replica's record."""
    recs = {}
    for tag in tags:
        f = counts_dir / f"launches-{tag}.json"
        require(f.is_file(), f"{what}: replica {tag} wrote no launch counts")
        recs[tag] = json.loads(f.read_text())
    total: Counter = Counter()
    for rec in recs.values():
        total.update(rec["launches"])
    return dict(total), recs


def _replica_window(kv, counts_dir: Path, tags, what: str) -> tuple[dict,
                                                                    dict]:
    """End a launch-count window on the running replicas of ``tags``: the
    ``launch_counts`` command of each one's fault mailbox makes it write
    its launches since the last window and count from 0 again. Returns
    ``_fleet_launches`` of that window (each within REPLICA_LIMIT) and
    removes the files, so that the next window's are its own."""
    from tpu_sandbox_torch.serve import replica as R

    files = [counts_dir / f"launches-{tag}.json" for tag in tags]
    for tag in tags:
        kv.set(R.k_cmd(tag), json.dumps({"action": "launch_counts"}))
    deadline = time.monotonic() + REPLICA_LIMIT
    while not all(f.is_file() for f in files):
        require(time.monotonic() < deadline,
                f"{what}: the replicas wrote no launch counts in "
                f"{REPLICA_LIMIT} s")
        time.sleep(0.01)
    out = _fleet_launches(counts_dir, tags, what)
    for f in files:
        f.unlink()
    return out


def _poll_verdicts(client, rids, submitted: dict, limit: float,
                   what: str, each=None) -> tuple[dict, dict]:
    """Poll the gateway (``try_result``) until every rid of ``rids`` has
    its verdict: the verdicts and each rid's submit-to-verdict seconds on
    the host clock (within one poll round of the landing). ``each`` is
    called once a poll round."""
    verdicts, seconds = {}, {}
    deadline = time.monotonic() + limit
    while len(verdicts) < len(rids):
        if each is not None:
            each()
        require(time.monotonic() < deadline,
                f"{what}: no verdicts for "
                f"{sorted(set(rids) - set(verdicts))} in {limit} s")
        for rid in rids:
            if rid not in verdicts:
                v = client.try_result(rid)
                if v is not None:
                    verdicts[rid] = v
                    seconds[rid] = time.monotonic() - submitted[rid]
        time.sleep(0.002)
    return verdicts, seconds


def _front_door():
    """The fleet path_gateway and path_chaos share, started at once: a KV
    server here, two replica processes on the card on ``_replica_load()``'s
    config (FRONT_DOOR_TAGS), the gateway processes of both phases
    (GATEWAY_IDS, then CHAOS_GATEWAYS), every one recording into one trace
    directory. Close it with ``_close_front_door``."""
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    cfg, _ = _replica_load()
    counts_dir = _fresh_ckpt_dir("front_door_counts")
    counts_dir.mkdir()
    trace_dir = _fresh_ckpt_dir("front_door_trace")
    trace_dir.mkdir()
    srv = KVServer()
    gids = [*GATEWAY_IDS, *CHAOS_GATEWAYS]
    door = SimpleNamespace(
        cfg=cfg, srv=srv, kv=KVClient(port=srv.port),
        tags=list(FRONT_DOOR_TAGS), gids=gids, counts_dir=counts_dir,
        trace_dir=trace_dir, t0=time.monotonic())
    door.procs = dict(zip([*door.tags, *gids], _serve_procs(
        srv.port, cfg, door.tags, gids, counts_dir, trace_dir=trace_dir)))
    return door


def _close_front_door(door) -> None:
    """Kill what is still running of the shared fleet, stop its KV server
    and remove its directories."""
    import shutil

    for p in door.procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
    door.kv.close()
    door.srv.stop()
    for d in (door.counts_dir, door.trace_dir):
        shutil.rmtree(d, ignore_errors=True)


def phase_path_gateway(want: dict, door) -> tuple[dict, dict, dict]:
    """The front door at the LM's bench width (JAX's
    tests/test_gateway.py failover scenario with real replicas) on the
    shared fleet (``_front_door``): the two replicas and a GatewayClient
    here holding gw-a and gw-b. The 8 requests go in through gw-a; once
    two verdicts are in the store, gw-a is SIGKILLed and the client fails
    over to gw-b for the rest. Once every first-round verdict is out and
    both replicas advertise their resident prefixes, the same 8 prompts go
    in again under new rids, through gw-b. Every rid has exactly one
    verdict, "ok", with ``want``'s tokens (path_replica's in-process
    engine; a second-round rid takes its first-round twin's); the client
    counts a failover; gw-b routes second-round requests by prefix depth;
    gw-a's heartbeat lease lapses; gw-b closes on SIGTERM. The replicas'
    launch counts are set to 0 once the fleet is up and read at the end
    (``_replica_window``); the replicas and the other gateways run on into
    path_chaos. Returns the record, the launches (none: serving launches
    no port kernel) and the gateways' endpoints by id."""
    import signal

    from tpu_sandbox_torch.gateway import (GatewayClient,
                                           live_gateway_endpoints)
    from tpu_sandbox_torch.serve import replica as R

    _, reqs = _replica_load()
    kv, t0 = door.kv, door.t0
    eps = _wait_fleet(kv, list(door.procs.values()), door.tags, door.gids,
                      "path_gateway")
    up_s = time.monotonic() - t0
    _replica_window(kv, door.counts_dir, door.tags, "path_gateway")
    client = GatewayClient(endpoints=[eps["gw-a"], eps["gw-b"]],
                           backoff_base=0.05)
    try:
        require(client.endpoint == eps["gw-a"],
                f"path_gateway: the client took {client.endpoint}")
        submitted = {}
        first = [(f"g1-{rid}", prompt, n) for rid, prompt, n in reqs]
        for rid, prompt, n in first:
            submitted[rid] = time.monotonic()
            require(client.submit(rid, prompt, n),
                    f"path_gateway: {rid} shed at the door")
        deadline = time.monotonic() + REPLICA_LIMIT
        while len(kv.keys("serve/result/")) < 2:
            require(time.monotonic() < deadline,
                    "path_gateway: no two verdicts before the kill")
            time.sleep(0.005)
        at_kill = len(kv.keys("serve/result/"))
        killed = door.procs["gw-a"]
        killed.kill()
        killed.wait(timeout=60)
        t_kill = time.monotonic()
        lapsed = []

        def lease_gone():
            if not lapsed and "gw-a" not in [
                    g for g, _, _ in live_gateway_endpoints(kv)]:
                lapsed.append(time.monotonic() - t_kill)

        v1, s1 = _poll_verdicts(client, [r for r, _, _ in first],
                                submitted, REPLICA_LIMIT, "path_gateway",
                                each=lease_gone)
        failovers = client.stats.failovers
        # the replicas' reports carry the first round's prefixes
        while not all(r.get("prefix_digest") and not r.get("active")
                      for r in R.read_load_reports(kv).values()):
            require(time.monotonic() < deadline,
                    "path_gateway: no idle replica reports with resident "
                    "prefixes")
            time.sleep(0.01)
        second = [(f"g2-{rid}", prompt, n) for rid, prompt, n in reqs]
        for rid, prompt, n in second:
            submitted[rid] = time.monotonic()
            require(client.submit(rid, prompt, n),
                    f"path_gateway: {rid} shed at the door")
        v2, s2 = _poll_verdicts(client, [r for r, _, _ in second],
                                submitted, REPLICA_LIMIT, "path_gateway",
                                each=lease_gone)
        stats = client.gateway_stats()
        while not lapsed:
            require(time.monotonic() - t_kill < PLANE_LIMIT,
                    "path_gateway: gw-a's heartbeat lease never lapsed")
            lease_gone()
            time.sleep(0.02)
        lapse_s = lapsed[0]
        claims = {rid: int(kv.get(R.k_done(rid)))
                  for rid in list(v1) + list(v2)}
    finally:
        client.close()
    launches, recs = _replica_window(kv, door.counts_dir, door.tags,
                                     "path_gateway")
    door.procs["gw-b"].send_signal(signal.SIGTERM)
    closed = {}
    for gid, code in (("gw-a", -9), ("gw-b", 0)):
        try:
            closed[gid], _ = door.procs[gid].communicate(
                timeout=REPLICA_LIMIT)
        except subprocess.TimeoutExpired:
            require(False, f"path_gateway: {gid} ran past {REPLICA_LIMIT} s")
        require(door.procs[gid].returncode == code,
                f"path_gateway: {gid} exited "
                f"{door.procs[gid].returncode}: {closed[gid][-3000:]}")
    verdicts = {**v1, **v2}
    lat = list(s1.values()) + list(s2.values())
    out = dict(
        requests=len(verdicts), up_s=up_s, phase_s=time.monotonic() - t0,
        verdicts_at_kill=at_kill, failovers=failovers,
        hb_lapse_after_kill_s=lapse_s,
        submit_to_verdict_s={
            "p50": _pct(lat, 50), "p99": _pct(lat, 99),
            "round1_p50": _pct(list(s1.values()), 50),
            "round1_p99": _pct(list(s1.values()), 99),
            "round2_p50": _pct(list(s2.values()), 50),
            "round2_p99": _pct(list(s2.values()), 99)},
        surviving_gateway=stats["stats"],
        answered_by=dict(Counter(v.get("replica")
                                 for v in verdicts.values())),
        claimed={t: recs[t]["claimed"] for t in door.tags},
        launches=launches,
        gateway_closed=closed["gw-b"].strip().splitlines()[-1:],
        tokens_equal={rid: v.get("tokens") == want[rid.split("-", 1)[1]]
                      for rid, v in verdicts.items()},
        verdict_claims=claims)
    emit("path_gateway", **out)
    require(all(v["verdict"] == "ok" for v in verdicts.values()),
            f"path_gateway: verdicts {verdicts}")
    require(all(c == 1 for c in claims.values()),
            f"path_gateway: verdicts claimed more than once: {claims}")
    require(all(out["tokens_equal"].values()),
            "path_gateway: tokens differ from path_replica's in-process "
            f"engine's: {out['tokens_equal']}")
    require(failovers >= 1, "path_gateway: the client never failed over")
    require(stats["stats"]["routed_prefix"] >= 1,
            f"path_gateway: gw-b routed nothing by prefix: {stats['stats']}")
    require(not launches, f"path_gateway: port kernels launched: {launches}")
    return out, launches, eps


def _deploy_reference(cfg: dict, reqs) -> tuple[dict, dict]:
    """The version-2 LM (``cfg`` at ``param_seed`` 1, as the replica builds
    it) in an engine on the card: its tokens for ``reqs`` and its weights
    (on the card)."""
    from tpu_sandbox_torch.serve import Request
    from tpu_sandbox_torch.serve import replica as R

    engine = R._build_engine({**cfg, "param_seed": 1}, torch.device("cuda"))
    for rid, prompt, n in reqs:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    engine.run_until_idle()
    ref = {rid: r.tokens for rid, r in engine.results.items()}
    params = engine.params
    del engine
    return ref, params


def phase_path_deploy(want: dict) -> tuple[dict, dict]:
    """A rolling deploy at the LM's bench width: a KV server here, two
    replica processes on the card serving the boot weights
    (``_replica_load()``'s config, ``param_seed`` 0: registry version 0,
    the rollback target), one gateway process, and version 1 (the same
    LM from ``param_seed`` 1, built here on the card, run through the
    first DEPLOY_REQUESTS requests for its reference tokens and written
    by ``publish_checkpoint``). A warm-up round through the gateway
    first; then this process's DeployController (DEPLOY_CONFIG) verifies
    the artifact, picks a canary, swaps it and puts the canary shares up;
    the same prompts go in through the gateway under new rids while the
    shares are live, each decoding on the version it pinned (version 0:
    ``want``'s tokens; version 1: the reference's); the canary rule
    passes and the controller promotes both replicas. Both load reports
    ack version 1, the prompts under new rids give the reference's tokens
    exactly, deploy_events holds one event per decision, and
    audit_registry is clean. Each replica's swap seconds (command to
    ack), the rollout's (publish to promote) and the artifact's bytes.
    Returns the record and the replicas' launches (none)."""
    import shutil

    from tpu_sandbox_torch.deploy.controller import (DeployConfig,
                                                     DeployController)
    from tpu_sandbox_torch.deploy.registry import (audit_registry,
                                                   current_target,
                                                   deploy_events,
                                                   read_shares)
    from tpu_sandbox_torch.gateway import GatewayClient
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
    from tpu_sandbox_torch.serve import replica as R
    from tpu_sandbox_torch.train.trainer import publish_checkpoint

    cfg, reqs = _replica_load()
    cfg, reqs = {**cfg, **DEPLOY_REPLICA}, reqs[:DEPLOY_REQUESTS]
    tags, gids = ["dp-r0", "dp-r1"], ["gw-deploy"]
    counts_dir = _fresh_ckpt_dir("path_deploy_counts")
    counts_dir.mkdir()
    export = _fresh_ckpt_dir("path_deploy_export")
    t0 = time.monotonic()
    with KVServer() as srv:
        kv = KVClient(port=srv.port)
        procs = _serve_procs(srv.port, cfg, tags, gids, counts_dir)
        client = ctrl = None
        try:
            ref, params = _deploy_reference(cfg, reqs)
            ref_s = time.monotonic() - t0
            eps = _wait_fleet(kv, procs, tags, gids, "path_deploy")
            up_s = time.monotonic() - t0
            client = GatewayClient(endpoints=[eps["gw-deploy"]])
            submitted = {}

            def round_(name):
                rids = []
                for rid, prompt, n in reqs:
                    rids.append(f"{name}-{rid}")
                    submitted[rids[-1]] = time.monotonic()
                    require(client.submit(rids[-1], prompt, n),
                            f"path_deploy: {rids[-1]} shed at the door")
                return rids

            warm, _ = _poll_verdicts(client, round_("d0"), submitted,
                                     REPLICA_LIMIT, "path_deploy")
            ctrl = DeployController(kv, member_id="smoke",
                                    cfg=DeployConfig(**DEPLOY_CONFIG))
            sent, acked = {}, {}
            send = ctrl._send_swap

            def timed_send(tag, seq, step_dir):
                sent.setdefault(tag, time.monotonic())
                send(tag, seq, step_dir)

            ctrl._send_swap = timed_send
            t_pub = time.monotonic()
            ver = publish_checkpoint(kv, params, export_dir=export, step=1)
            pub_s = time.monotonic() - t_pub
            step_dir = Path(json.loads(kv.get(
                f"deploy/models/default/{ver}"))["step_dir"])
            artifact_bytes = _dir_bytes(step_dir)
            del params
            torch.cuda.empty_cache()
            canary_rids, shares_seen = [], None
            deadline = time.monotonic() + REPLICA_LIMIT
            while current_target(kv) != ver or (
                    canary_rids and not all(
                        kv.try_get(R.k_result(r)) for r in canary_rids)):
                require(time.monotonic() < deadline,
                        f"path_deploy: no promotion in {REPLICA_LIMIT} s: "
                        f"events {deploy_events(kv)}")
                ctrl.tick()
                reports = R.read_load_reports(kv)
                for tag in tags:
                    if reports.get(tag, {}).get("ver") == ver:
                        acked.setdefault(tag, time.monotonic())
                shares = read_shares(kv)
                if shares and not canary_rids:
                    shares_seen = shares
                    canary_rids = round_("d1")
                time.sleep(0.01)
            promote_s = time.monotonic() - t_pub
            canary, _ = _poll_verdicts(client, canary_rids, submitted,
                                       REPLICA_LIMIT, "path_deploy")
            after, _ = _poll_verdicts(client, round_("d2"), submitted,
                                      REPLICA_LIMIT, "path_deploy")
            reports = R.read_load_reports(kv)
            events = deploy_events(kv)
            audit = audit_registry(kv)
            claims = {rid: int(kv.get(R.k_done(rid)))
                      for rid in list(warm) + list(canary) + list(after)}
            client.close()
            client = None
            ctrl.resign()
            ctrl = None
            _end_fleet(kv, procs, procs[2:], 3 * len(reqs), "path_deploy")
        finally:
            if client is not None:
                client.close()
            if ctrl is not None:
                ctrl.resign()
            kv.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    launches, recs = _fleet_launches(counts_dir, tags, "path_deploy")
    shutil.rmtree(counts_dir, ignore_errors=True)
    shutil.rmtree(export, ignore_errors=True)

    def tokens_ok(verdicts):
        return {rid: v.get("tokens") == (ref if v.get("ver") == ver
                                         else want)[rid.split("-", 1)[1]]
                for rid, v in verdicts.items()}

    canary_vers = Counter(v.get("ver") for v in canary.values())
    out = dict(
        requests=len(reqs), version=ver, reference_s=ref_s, up_s=up_s,
        publish_s=pub_s, artifact_bytes=artifact_bytes,
        swap_s={t: acked[t] - sent[t] for t in tags if t in sent
                and t in acked},
        rollout_s=promote_s, shares=shares_seen,
        canary_round_versions=dict(canary_vers),
        events=[e["action"] for e in events],
        report_versions={t: reports.get(t, {}).get("ver") for t in tags},
        swaps={t: recs[t]["swaps"] for t in tags},
        audit=[{k: r[k] for k in ("ver", "status", "sealed", "dangling")}
               for r in audit["versions"]],
        warm_tokens_equal=tokens_ok(warm), canary_tokens_equal=tokens_ok(
            canary), after_tokens_equal=tokens_ok(after),
        verdict_claims=claims, launches=launches,
        phase_s=time.monotonic() - t0)
    emit("path_deploy", **out)
    require(out["events"] == ["published", "promote_begin", "canary_pass",
                              "promoted"],
            f"path_deploy: events {events}")
    require(all(v == ver for v in out["report_versions"].values()),
            f"path_deploy: load reports ack {out['report_versions']}")
    require(all(v["verdict"] == "ok" for d in (warm, canary, after)
                for v in d.values()) and all(
                c == 1 for c in claims.values()),
            f"path_deploy: verdicts {warm} {canary} {after}, {claims}")
    require(all(v.get("ver") == 0 for v in warm.values())
            and all(v.get("ver") == ver for v in after.values())
            and set(canary_vers) <= {0, ver},
            "path_deploy: versions warm "
            f"{[v.get('ver') for v in warm.values()]}, canary "
            f"{dict(canary_vers)}, after "
            f"{[v.get('ver') for v in after.values()]}")
    require(all(out["warm_tokens_equal"].values())
            and all(out["canary_tokens_equal"].values())
            and all(out["after_tokens_equal"].values()),
            "path_deploy: a request's tokens differ from its version's "
            f"reference: {out}")
    require(audit["target"] == ver and not audit["missing_records"]
            and all(r["sealed"] and not r["dangling"]
                    for r in audit["versions"]),
            f"path_deploy: audit {audit}")
    require(len(out["swap_s"]) == 2,
            f"path_deploy: swaps sent {sent}, acked {acked}")
    require(not launches, f"path_deploy: port kernels launched: {launches}")
    return out, launches



@contextlib.contextmanager
def _recording(trace_dir: Path, proc: str):
    """This process's recorder writing into ``trace_dir`` as ``proc`` for
    the block (flushed at its end), and off again after it."""
    import os

    from tpu_sandbox_torch.obs import record

    names = (record.ENV_TRACE_DIR, record.ENV_PROC_NAME)
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(zip(names, (str(trace_dir), proc)))
    record.reset_recorder()
    try:
        yield record.get_recorder()
    finally:
        record.get_recorder().flush()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        record.reset_recorder()


def _watch_verdicts(kv, landed: dict, stop) -> None:
    """Until ``stop`` is set, poll the store every 5 ms and put the host
    clock's time at which each rid's first non-SHED verdict was seen into
    ``landed``; closes ``kv`` (a client of this thread's own) at the end.
    The trace's request walls are not submit to verdict: critpath keys a
    rid on the first trace that names it, so a rid that a shed storm sent
    back to the campaign ends its wall at the SHED verdict, and a rid
    whose spans died with the killed gateway loses the start of its
    path."""
    try:
        while not stop.is_set():
            for key in kv.keys("serve/result/"):
                rid = key[len("serve/result/"):]
                if rid in landed:
                    continue
                raw = kv.try_get(key)
                if raw is not None and json.loads(raw).get(
                        "verdict", "ok") != "SHED":
                    landed[rid] = time.monotonic()
            stop.wait(0.005)
    finally:
        kv.close()


def _port_tools(*cmds: list[str]) -> list[tuple[int, str]]:
    """Each of ``cmds`` run as ``python -m tpu_sandbox_torch.tools.<cmd[0]>
    <cmd[1:]>``, all at once: each one's exit code and output (ENTRY_LIMIT
    seconds each)."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"tpu_sandbox_torch.tools.{cmd[0]}",
         *cmd[1:]], cwd=Path(__file__).resolve().parent, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for cmd in cmds]
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=ENTRY_LIMIT)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    return out


def phase_path_chaos(smi: str, door, eps: dict,
                     up_s: float) -> tuple[dict, dict]:
    """A seeded chaos campaign at the LM's bench width (the SIGKILL arm of
    JAX's bench_chaos, bench.py:2136-2160, on real replicas) on the fleet
    path_gateway leaves running (``_front_door``: two replica processes on
    the card, and CHAOS_GATEWAYS among its gateways, at ``eps``, up after
    ``up_s`` s; every process records into one trace directory, this one
    once its reference is built); a failover GatewayClient holding the
    three endpoints is the campaign's door. The
    workload is ``workload.synthesize`` (CHAOS_SEED, CHAOS_REQUESTS over
    CHAOS_SECONDS); the schedule SIGKILLs the gateway the client holds at
    CHAOS_KILL_AT of the seconds, then ``build_schedule`` draws
    CHAOS_FAULTS shed storms and stalls of the replicas. The checks: zero
    lost and one "ok" verdict a rid, with the tokens of the replica's own
    engine (``_build_engine``, run here) on ``campaign.prompt_for(row)``;
    audit bytes equal to those built from the schedule and those tokens;
    clean alert claims; a failover; a probe through a surviving gateway
    routed by prefix. Then the fleet ends (each process flushes its
    recorder) and the port's collector and critical path read the trace
    of both phases: coverage mean at least COVERAGE_TARGET, each
    segment's share and median; the workload export holds every rid of
    the campaign with its decode tokens, and the prompt tokens and chain
    of every one whose route span landed (the others were routed by a
    killed gateway, whose buffered spans died with it); its canonical
    bytes round-trip; the profile published to the tsdb shows in
    fleetop's where-time-goes panel beside both replicas; fleetop,
    tracecat and tracediff exit 0. Returns the record and the replicas'
    launches since path_gateway read them (none)."""
    import shutil
    import threading

    from tpu_sandbox_torch.gateway import GatewayClient
    from tpu_sandbox_torch.obs import collect, critpath, workload
    from tpu_sandbox_torch.runtime.chaos import (CampaignResult,
                                                 ChaosCampaign, ChaosFault,
                                                 _token_digest,
                                                 build_schedule,
                                                 check_alert_claims,
                                                 prefix_probe)
    from tpu_sandbox_torch.serve import Request
    from tpu_sandbox_torch.serve import replica as R
    from tpu_sandbox_torch.serve.cache import chain_digest
    from tpu_sandbox_torch.tools import fleetop

    cfg, kv, tags = door.cfg, door.kv, door.tags
    block = cfg["cache"]["block_size"]
    gids = list(CHAOS_GATEWAYS)
    profiles = _fresh_ckpt_dir("path_chaos_profiles")
    profiles.mkdir()
    trace = workload.synthesize(CHAOS_SEED, CHAOS_REQUESTS,
                                duration_s=CHAOS_SECONDS,
                                prompt_tokens=CHAOS_PROMPT,
                                decode_tokens=CHAOS_DECODE)
    rows = workload.replay_order(trace)
    schedule = [ChaosFault(at_s=round(CHAOS_SECONDS * CHAOS_KILL_AT, 6),
                           action="kill_gateway", target=gids[0])]
    schedule += build_schedule(CHAOS_SEED, duration_s=CHAOS_SECONDS, targets={
        "shed_storm": tags,
        "stall_replica": [f"{t}:{CHAOS_STALL_S}" for t in tags]},
        n_faults=CHAOS_FAULTS)
    probe_rid = f"probe-{CHAOS_SEED}"
    t0 = time.monotonic()
    client = None
    held, submitted, landed, killed = {}, {}, {}, []
    stop, watcher = threading.Event(), None

    def door_submit(rid, prompt, n):
        submitted.setdefault(rid, time.monotonic())
        return client.submit(rid, prompt, n)

    def sigkill(gid):
        held[gid] = client.endpoint == eps[gid]
        door.procs[gid].kill()
        door.procs[gid].wait(timeout=60)
        killed.append(door.procs[gid])

    campaign = ChaosCampaign(
        kv, trace, door_submit, seed=CHAOS_SEED, schedule=schedule,
        hooks={"kill_gateway": sigkill},
        vocab=cfg["model"]["vocab_size"], block_size=block,
        verdict_timeout=REPLICA_LIMIT)
    try:
        # the reference, here on the card: the replica's engine on the
        # campaign's prompts
        engine = R._build_engine(cfg, torch.device("cuda"))
        for row in rows:
            engine.submit(Request(
                rid=row["rid"], prompt=campaign.prompt_for(row),
                max_new_tokens=int(row["decode_tokens"])))
        engine.run_until_idle()
        want = {rid: r.tokens for rid, r in engine.results.items()}
        del engine
        torch.cuda.empty_cache()
        ref_s = time.monotonic() - t0
        # this process records from here (the reference above would have
        # given each rid a trace of its own)
        with _recording(door.trace_dir, "client"):
            client = GatewayClient(endpoints=[eps[g] for g in gids],
                                   backoff_base=0.05)
            watcher = threading.Thread(
                target=_watch_verdicts, args=(kv.clone(), landed, stop),
                name="chaos-verdicts", daemon=True)
            watcher.start()
            t_run = time.monotonic()
            res = campaign.run()
            campaign_s = time.monotonic() - t_run
            failovers = client.stats.failovers
            alert_failures = check_alert_claims(kv)
            # the probe, through the gateway the client failed over to: the
            # prompt of the latest row whose blocks a replica advertises (a
            # load report carries its newest 24 prefix entries)
            deadline = time.monotonic() + REPLICA_LIMIT
            while True:
                adv = {h for r in R.read_load_reports(kv).values()
                       for h in r.get("prefix_digest", ())}
                probe_row = next(
                    (row for row in reversed(rows) if adv & set(
                        chain_digest(campaign.prompt_for(row), block))), None)
                if probe_row is not None:
                    break
                require(time.monotonic() < deadline,
                        "path_chaos: no replica advertises a prefix of the "
                        "campaign's prompts")
                time.sleep(0.02)
            routed = prefix_probe(client, campaign.prompt_for(probe_row),
                                  probe_rid)
            probe = client.result(probe_rid, timeout=REPLICA_LIMIT)
            survivor = next(g for g in gids if eps[g] == client.endpoint)
            door_stats = client.gateway_stats()["stats"]
            stop.set()
            verdicts = {row["rid"]: json.loads(kv.get(R.k_result(row["rid"])))
                        for row in rows}
            claims = {rid: int(kv.get(R.k_done(rid)))
                      for rid in [*verdicts, probe_rid]}
            stamped = {rid: json.loads(kv.get(R.k_req(rid))).get("gw")
                       for rid in verdicts}
            client.close()
            client = None
            # every request of both phases has its verdict: the replicas end
            fleet = [*(door.procs[t] for t in tags),
                     *(door.procs[g] for g in gids)]
            outs = _end_fleet(kv, fleet, fleet[len(tags):],
                              len(kv.keys("serve/result/")), "path_chaos",
                              killed=killed)
        # the trace, now that every process has flushed its recorder
        t_trace = time.monotonic()
        stats: dict = {}
        merged = collect.load_merged(str(door.trace_dir), stats)
        profile = critpath.analyze(merged)["profile"]
        exported = workload.from_trace(merged, source="path_chaos")
        text = workload.dumps(exported)
        published = critpath.publish_profile(kv, profile)
        console = fleetop.render(kv)
        mine, cat = profiles / "script.json", profiles / "tracecat.json"
        critpath.save_profile(profile, str(mine))
        tools = dict(zip(("fleetop", "tracecat"), _port_tools(
            ["fleetop", "--port", str(door.srv.port)],
            ["tracecat", str(door.trace_dir), "--critpath", str(cat)])))
        tools["tracediff"], = _port_tools(["tracediff", str(mine), str(cat)])
        trace_s = time.monotonic() - t_trace
    finally:
        stop.set()
        if watcher is not None:
            watcher.join(timeout=60)
        if client is not None:
            client.close()
    launches, _ = _fleet_launches(door.counts_dir, tags, "path_chaos")
    tool_profile = critpath.load_profile(str(cat))
    shutil.rmtree(profiles, ignore_errors=True)

    expect = CampaignResult(
        seed=CHAOS_SEED,
        fired=[f.as_dict() for f in sorted(schedule,
                                           key=lambda f: (f.at_s, f.action))],
        verdicts={row["rid"]: {"verdict": "ok", "tokens": _token_digest(
            {"tokens": want[row["rid"]]})} for row in rows})
    lat = [landed[r] - submitted[r] for r in verdicts
           if r in landed and r in submitted]
    segs = profile["segments"]
    exported_rows = {r["rid"]: r for r in exported["requests"]}
    routeless = sorted(r["rid"] for r in rows
                       if exported_rows.get(r["rid"], {}).get(
                           "prompt_tokens") == 0)
    sizes_equal = {
        row["rid"]: (exported_rows.get(row["rid"], {}).get("decode_tokens")
                     == row["decode_tokens"]) and (
            row["rid"] in routeless or (
                exported_rows[row["rid"]]["prompt_tokens"]
                == row["prompt_tokens"] and exported_rows[row["rid"]][
                    "chain"] == str(chain_digest(
                        campaign.prompt_for(row), block)[-1])))
        for row in rows}
    out = dict(
        card=smi, requests=len(rows), seed=CHAOS_SEED,
        fired=[f["action"] for f in res.fired], submitted=res.submitted,
        admitted=res.admitted, door_sheds=res.door_shed,
        retried=res.retried, lost=res.lost, failovers=failovers,
        killed_held_gateway=held.get(gids[0]), survivor=survivor,
        submit_to_verdict_s={"p50": _pct(lat, 50), "p99": _pct(lat, 99),
                             "max": max(lat) if lat else None,
                             "n": len(lat)},
        campaign_s=campaign_s, reference_s=ref_s, trace_s=trace_s,
        fleet_up_s=up_s, surviving_gateway=door_stats,
        gateways_closed=[o.strip().splitlines()[-1:] for o in outs
                         if "[gateway] closed" in o],
        answered_by=dict(Counter(v.get("replica")
                                 for v in verdicts.values())),
        tokens_equal={rid: v.get("tokens") == want[rid]
                      for rid, v in verdicts.items()},
        verdict_claims=claims,
        audit_equal=res.audit_bytes() == expect.audit_bytes(),
        alert_failures=alert_failures, prefix_probe_routed=routed,
        probe_row=probe_row["rid"],
        probe_tokens_equal=probe.get("tokens") == want[probe_row["rid"]][:4],
        trace_files=stats.get("files"),
        dropped_records=stats.get("dropped_records", 0),
        records=len(merged), trace_requests=profile["requests"],
        coverage_mean=profile["coverage_mean"],
        coverage_min=profile["coverage_min"],
        wall_s_median=profile["wall_s_median"],
        segments={s: ({"share": segs[s]["share"],
                       "median_ms": segs[s]["median_s"] * 1e3,
                       "n": segs[s]["n"]} if s in segs else None)
                  for s in CHAOS_SEGMENTS},
        other_segments={s: {"share": v["share"],
                            "median_ms": v["median_s"] * 1e3, "n": v["n"]}
                        for s, v in segs.items()
                        if s not in CHAOS_SEGMENTS},
        blame=profile["blame"],
        workload_rids=len(exported_rows), workload_routeless=routeless,
        routeless_stamped={rid: stamped[rid] for rid in routeless},
        workload_sizes_equal=sizes_equal,
        workload_round_trip=workload.dumps(workload.loads(text)) == text,
        published_series=published,
        fleetop=[ln for ln in console.splitlines() if ln.strip()],
        tools={k: rc for k, (rc, _) in tools.items()},
        tracecat_profile_equal=tool_profile == profile,
        launches=launches, phase_s=time.monotonic() - t0)
    emit("path_chaos", **out)
    require(res.ok and not res.lost, f"path_chaos: campaign {res.failures}, "
            f"lost {res.lost}")
    require(len(res.verdicts) == len(rows)
            and all(v["verdict"] == "ok" for v in res.verdicts.values())
            and all(v["verdict"] == "ok" for v in verdicts.values())
            and all(c == 1 for c in claims.values()),
            f"path_chaos: verdicts {res.verdicts}, claims {claims}")
    require(all(out["tokens_equal"].values()),
            "path_chaos: tokens differ from the in-process engine's: "
            f"{out['tokens_equal']}")
    require(out["audit_equal"], "path_chaos: audit bytes differ from the "
            f"reference's: {res.audit_bytes()} vs {expect.audit_bytes()}")
    require(alert_failures == [], f"path_chaos: alerts {alert_failures}")
    require(failovers >= 1 and held.get(gids[0]),
            f"path_chaos: failovers {failovers}, killed gateway held {held}")
    require(routed and out["probe_tokens_equal"],
            f"path_chaos: probe routed {routed}, verdict {probe}")
    require(profile["coverage_mean"] >= critpath.COVERAGE_TARGET,
            f"path_chaos: coverage mean {profile['coverage_mean']}")
    require({r["rid"] for r in rows} | {probe_rid} <= set(exported_rows)
            and all(sizes_equal.values())
            and all(stamped[r] == gids[0] for r in routeless)
            and out["workload_round_trip"],
            f"path_chaos: workload export {exported_rows}, routeless "
            f"{out['routeless_stamped']}")
    require(published > 0 and "where time goes:" in console
            and all(t in console for t in tags),
            f"path_chaos: fleetop rendered {console}")
    require(all(rc == 0 for rc, _ in tools.values()),
            f"path_chaos: tools {tools}")
    require(out["tracecat_profile_equal"],
            "path_chaos: tracecat's profile differs from the script's")
    require(not launches, f"path_chaos: port kernels launched: {launches}")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from tpu_sandbox_torch import (
            lm_train,
            mnist_distributed,
            mnist_onegpu,
            ops,
        )
        from tpu_sandbox_torch.ops import (
            bn_tail,
            bn_tail_t,
            build,
            ce,
            conv,
            conv1_tail_t,
            conv5_t,
            conv_t,
            fc_t,
        )
        from tpu_sandbox_torch.ops import flash_attention as fa
        from tpu_sandbox_torch.utils import exact_fp32
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run "
              "it from the root of a checkout", file=sys.stderr)
        return 1

    exact_fp32()
    with timed("env"):
        smi = phase_env(build)
    with timed("kernels"):
        entries = phase_kernels(conv_t, fc_t, bn_tail_t, conv5_t,
                                conv1_tail_t, conv, bn_tail)
        require(sorted(entries) == ALL_KINDS,
                f"kernel phase covered {sorted(entries)}")
        entries.update(phase_lm_kernels(ce, fa))
    with timed("ragged"):
        phase_ragged(conv_t, fc_t, bn_tail_t, conv5_t, conv1_tail_t, conv,
                     bn_tail)
        phase_lm_ragged(ce, fa)
    with timed("ring_kernels"):
        ring_entries, ring_counts = phase_ring_kernels(ops, fa)
    entries.update(ring_entries)
    counts, main_ms, main_res = {}, None, None
    for phase, plan, options, steps, kinds in PATHS:
        with timed(phase):
            res, counts[phase], trainer = phase_main_path(
                ops, mnist_onegpu, kinds, phase=phase, plan=plan,
                steps=steps, model_options=options,
                flags=PATH_FLAGS.get(phase))
            if main_ms is None:
                require(res["fused_tail"] and res["sparse_conv1"]
                        and res["fused_conv1_bwd"],
                        "the card's default plan is not the JAX package's "
                        f"whole chip plan: {res}")
                main_ms = res["step_ms_median_after_first"]
                main_res = res
                emit(phase, **res)
                phase_profile(trainer)
            else:
                emit(phase, **res,
                     main_path_step_ms_median_after_first=main_ms)
            if phase == "path_s2d":
                phase_profile(trainer, phase="profile_s2d", plan=phase)
            del trainer
    with timed("dist_bootstrap"):
        phase_dist_bootstrap()
    with timed("path_dp"):
        dp_res, counts["path_dp"] = phase_path_dp(ops, mnist_distributed,
                                                  MAIN_KINDS)
        emit("path_dp", **dp_res,
             main_path_step_ms_median_after_first=main_ms)
    counts.update(phase_path_dp_ext(ops, mnist_distributed, MAIN_KINDS,
                                    dp_res))
    with timed("ckpt_card"):
        res, counts["ckpt_card"] = phase_ckpt_card(ops, MAIN_KINDS)
        emit("ckpt_card", **res)
    with timed("path_ckpt"):
        res, counts["path_ckpt"] = phase_path_ckpt(ops, mnist_onegpu,
                                                   MAIN_KINDS, main_res)
        emit("path_ckpt", **res)
    with timed("path_resumable"):
        res, counts["path_resumable"], ref = phase_path_resumable(
            ops, mnist_distributed, MAIN_KINDS)
        emit("path_resumable", **res)
    with timed("path_elastic"):
        emit("path_elastic", **phase_path_elastic(mnist_distributed, *ref))
    torch.cuda.empty_cache()
    with timed("path_agents"):
        res, counts["path_agents"] = phase_path_agents(*ref)
        emit("path_agents", **res)
    with timed("path_pool"):
        res, counts["path_pool"] = phase_path_pool(mnist_distributed, *ref)
        emit("path_pool", **res)
        del ref
    with timed("lm_path"):
        run, counts["lm_path"], lm_ref = phase_lm_path(ops, lm_train)
        phase_lm_profile(lm_train, run)
        del run
        torch.cuda.empty_cache()
    with timed("path_sp"):
        counts.update(phase_path_sp(ops, fa, lm_train, lm_ref))
    counts.update(phase_lm_paths(ops, fa, lm_train, lm_ref))
    with timed("serve_card_vs_cpu"):
        phase_serve_card_vs_cpu()
    with timed("path_serve"):
        counts["path_serve"] = phase_path_serve(ops)["launches"]
    with timed("path_replica"):
        _, replica_tokens = phase_path_replica()
    with timed("path_replica_gang"):
        phase_path_replica_gang(replica_tokens)
    door = None
    try:
        with timed("path_gateway"):
            door = _front_door()
            gw, counts["path_gateway"], eps = phase_path_gateway(
                replica_tokens, door)
        with timed("path_chaos"):
            _, counts["path_chaos"] = phase_path_chaos(smi, door, eps,
                                                       gw["up_s"])
    finally:
        if door is not None:
            _close_front_door(door)
    with timed("path_deploy"):
        _, counts["path_deploy"] = phase_path_deploy(replica_tokens)
    counts["ring_kernels"] = ring_counts
    for name, phase_fn, *a in (
            ("card_vs_cpu", phase_card_vs_cpu),
            ("pool_tie_card_vs_cpu", phase_pool_tie_card_vs_cpu),
            ("lm_card_vs_cpu", phase_lm_card_vs_cpu, lm_train),
            ("profile_flag", phase_profile_flag, mnist_onegpu),
            ("curve_card_vs_cpu", phase_curve_card_vs_cpu),
            ("moe_card_vs_cpu", phase_moe_card_vs_cpu, lm_train),
            ("dist_scripts", phase_dist_scripts),
            ("entry_refusals", phase_entry_refusals)):
        with timed(name):
            phase_fn(*a)
    emit("seconds", phases=SECONDS, total=sum(SECONDS.values()))
    steps_of = {phase: steps for phase, _, _, steps, _ in PATHS}
    steps_of["lm_path"] = STEPS
    steps_of["path_dp"] = DP_STEPS
    steps_of.update(path_ckpt=STEPS, path_resumable=ELASTIC_STEPS)
    steps_of.update({f"path_dp_ext_{m}": DP_STEPS for m, _ in DP_EXT_MODES})
    steps_of.update({f"path_sp_{a}": SP_STEPS for a in SP_SCHEMES},
                    ring_kernels=1)
    steps_of.update({phase: LM_PATH_STEPS for phase, *_ in LM_PATHS})
    for name, e in entries.items():
        e["launches_by_path"] = {p: c.get(name, 0) for p, c in counts.items()}
        # the count from the run of the first path this launch belongs to
        path = next(p for p, c in counts.items() if name in c)
        e["launches"] = counts[path][name]
        # what orders the work on the kernels: the factor a kernel loses to
        # its library call by, and its time above its bound in one step of
        # its first path
        e["launches_per_step"] = e["launches"] / steps_of[path]
        e["excess_ms_per_step"] = e["launches_per_step"] * (e["ms"]
                                                            - e["bound_ms"])
        e["vs_library"] = (e["ms"] / e["library_ms"] if e["library_ms"]
                           else None)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_note", "fp32_rel_err", "bf16_rel_err",
            "bf16_f32out_rel_err", "attrs", "launches_by_path",
            "launches_per_step", "excess_ms_per_step", "vs_library")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for _, e in sorted(entries.items())]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
