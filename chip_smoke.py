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
   outputs of bf16 inputs among them; the CE at N = 1 and
   C = 4097. The NHWC conv at CO 48 and 80 and at C 32, its tails at co 8
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
   more steps under torch.profiler.
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
   heads, 2 layers, S 256, flash, fp32, 3 Adam steps), after checking
   that the LM built on the card from seed 0 holds the CPU-built weights
   bitwise.
9. profile_flag: mnist_onegpu --profile DIR, 2 steps of the default plan
   at 3000x3000; the trace must name one of the port's kernels.
   curve_card_vs_cpu: parity_run.py's protocol (128x128, batch 5, fp32,
   SGD at 1e-4) for 50 steps from one bridged tree on the plain ConvNet,
   ConvNetS2D (fused) and the default ConvNetS2DT, each card curve
   against its CPU curve within the committed record
   (parity_curves.jsonl:401: max abs 1.173e-3, max rel 0.143 %, mean abs
   4.7e-5).
10. the {"kernels": [...]} summary, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

fp32 matmuls and convolutions run without TF32 throughout (the plain
versions are references).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

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
#: kv_offset, kv_len); D 40 runs zero-padded to the 64 head width
FLASH_RAGGED = ((1, 1, 200, 200, 64, True, 0, 0, 200),
                (1, 2, 200, 200, 32, True, 0, 0, 200),
                (2, 1, 130, 200, 32, False, 70, 5, 190),
                (2, 2, 200, 200, 40, True, 0, 0, 200),
                (1, 2, 200, 200, 64, False, 0, 0, 197),
                (2, 2, 200, 200, 40, False, 0, 0, 200),
                (1, 2, 130, 200, 64, True, 70, 5, 190),
                (2, 1, 72, 100, 40, True, 96, 0, 100),
                (1, 1, 64, 256, 128, False, 7, 300, 256))
#: the CE kernel's ragged cases (N, C): one row, a row width off 16 bytes
CE_RAGGED = ((1, 4097), (3, 4097), (5, 4100), (1, 32768))


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def _check_flash(fa, q, k, v, g, kw, dt_name, what) -> dict:
    """The three flash kernels against their plain versions on the same
    inputs (the backward ones on the kernel's own out and lse); dk/dv and
    dq run twice and must be bitwise equal."""
    out, lse = fa.flash_fwd(q, k, v, **kw)
    pout, plse = fa.flash_fwd_plain(q, k, v, **kw)
    rec = {"flash_fwd": compare(out, pout, dt_name, what + " out"),
           "flash_fwd_lse": compare(lse, plse, "fp32", what + " lse")}
    del pout, plse
    if dt_name == "bf16":
        rec.update(_flash_fwd_witness(fa, q, k, v, kw, what))
    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, g, lse, delta)
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


def _flash_fwd_witness(fa, q, k, v, kw, what) -> dict:
    """The forward's float32 out of bfloat16 inputs against the plain
    version's. Both round p to bf16 once before p.v, but from different
    maxima (the kernel's running max over its key tiles, the plain
    version's max over the row), so on random inputs one rounding of p
    may differ by a bf16 ulp (2^-8 of p/l |v|): that comparison is held
    to the bf16 tolerance and reported. The witness proper takes integer scores
    (entries -1, 0, 1 of q and k) at scale ln 2, so every p is a power of
    two, exact in bf16 from either maximum: only the kernel's f32
    arithmetic can differ, and out must come within TOL["bf16_f32"] of
    max|plain| (a bf16-rounded out would be 2^-9 off)."""
    f32 = dict(kw, out_dtype=torch.float32)
    out, _ = fa.flash_fwd(q, k, v, **f32)
    require(out.dtype == torch.float32, f"{what}: f32 out is {out.dtype}")
    rec = {"flash_fwd_f32_random": compare(
        out, fa.flash_fwd_plain(q, k, v, **f32)[0], "bf16",
        what + " out f32, random inputs")}
    qi, ki = _exact_p(q), _exact_p(k)
    exact = dict(f32, scale=math.log(2.0))
    out, lse = fa.flash_fwd(qi, ki, v, **exact)
    pout, plse = fa.flash_fwd_plain(qi, ki, v, **exact)
    rec["flash_fwd_f32out"] = compare(out, pout, "bf16_f32",
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
    emit("lm_path", flags=LM_FLAGS, losses=run.losses,
         step_ms_each=[t * 1e3 for t in run.step_seconds],
         step_ms_median_after_first=step_ms,
         tokens_per_s=LM_B * LM_S / (step_ms / 1e3),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         parameters=sum(p.numel() for p in run.model.parameters()),
         wall_s_with_init=wall, launches=counts)
    return run, counts


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
    batches: losses within rtol 1e-4. Before that, the LM built on the
    card from seed 0 must hold the CPU-built weights bitwise."""
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
    ok = bool(np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0))
    emit("lm_card_vs_cpu", dtype="fp32", steps=3, rtol=1e-4,
         losses_cpu=losses["cpu"], losses_cuda=losses["cuda"], agree=ok,
         init_bitwise_equal=init_equal)
    require(init_equal, "the LM built on the card from seed 0 does not "
            "hold the CPU-built weights bitwise")
    require(ok, f"LM card and CPU losses differ: {losses}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from tpu_sandbox_torch import lm_train, mnist_onegpu, ops
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
    smi = phase_env(build)
    entries = phase_kernels(conv_t, fc_t, bn_tail_t, conv5_t, conv1_tail_t,
                            conv, bn_tail)
    require(sorted(entries) == ALL_KINDS,
            f"kernel phase covered {sorted(entries)}")
    entries.update(phase_lm_kernels(ce, fa))
    phase_ragged(conv_t, fc_t, bn_tail_t, conv5_t, conv1_tail_t, conv,
                 bn_tail)
    phase_lm_ragged(ce, fa)
    counts, main_ms = {}, None
    for phase, plan, options, steps, kinds in PATHS:
        res, counts[phase], trainer = phase_main_path(
            ops, mnist_onegpu, kinds, phase=phase, plan=plan, steps=steps,
            model_options=options, flags=PATH_FLAGS.get(phase))
        if main_ms is None:
            require(res["fused_tail"] and res["sparse_conv1"]
                    and res["fused_conv1_bwd"],
                    "the card's default plan is not the JAX package's "
                    f"whole chip plan: {res}")
            main_ms = res["step_ms_median_after_first"]
            emit(phase, **res)
            phase_profile(trainer)
        else:
            emit(phase, **res, main_path_step_ms_median_after_first=main_ms)
        if phase == "path_s2d":
            phase_profile(trainer, phase="profile_s2d", plan=phase)
        del trainer
    run, counts["lm_path"] = phase_lm_path(ops, lm_train)
    phase_lm_profile(lm_train, run)
    del run
    torch.cuda.empty_cache()
    phase_card_vs_cpu()
    phase_pool_tie_card_vs_cpu()
    phase_lm_card_vs_cpu(lm_train)
    phase_profile_flag(mnist_onegpu)
    phase_curve_card_vs_cpu()
    steps_of = {phase: steps for phase, _, _, steps, _ in PATHS}
    steps_of["lm_path"] = STEPS
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
